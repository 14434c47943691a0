"""Overlays (host-side, matplotlib): counterpart of
``cova_tpu/utils/visualize.py``. ``visualize_bbox`` renders the attention
CSVs of ``train/extract.py`` as the reference's ``visualize_bbox`` does;
``visualize_predictions`` renders a page's retrieval picks. matplotlib and
PIL are imported by the call, not by the module."""

from __future__ import annotations

import os

import numpy as np

CLASS_NAMES = {0: "BG", 1: "Price", 2: "Title", 3: "Image"}
TARGET_COLOR = "#fa4772"
CONTEXT_COLOR = "#43a047"


def visualize_bbox(img_path: str, attn_wt_file: str, img_save_dir: str):
    """Render one PNG per row of ``attn_wt_file`` (rows = non-BG targets):
    the target box in red, each context box in green with a fill alpha
    proportional to its attention (normalized by the file's largest),
    saved as ``<page>_attn_<class>.png`` at dpi 300.

    Row layout: 4 bbox coords (x, y, w, h), label, 2K*4 context coords,
    2K attention values.
    """
    import matplotlib
    from PIL import Image

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = Image.open(img_path).convert("RGB")
    plt_data = np.loadtxt(attn_wt_file, delimiter=",")
    if plt_data.ndim == 1:
        plt_data = plt_data[None, :]
    context_size = int((plt_data.shape[1] - 5) / 10)
    k2 = 2 * context_size

    attn = plt_data[:, -k2:]
    plt_data[:, -k2:] = attn / max(attn.max(), 1e-12)

    plt.rcParams.update({"font.size": 6})
    stem = os.path.basename(img_path)[:-4]
    for row in plt_data:
        plt.imshow(img)
        cls = CLASS_NAMES[int(row[4])]
        plt.title("Attention Visualization for class: " + cls)
        ax = plt.gca()
        ax.add_patch(
            plt.Rectangle(
                (row[0], row[1]), row[2], row[3],
                fill=False, edgecolor=TARGET_COLOR, linewidth=1.5,
            )
        )
        for c in range(1, k2 + 1):
            cx, cy, cw, ch = row[4 * c + 1 : 4 * c + 5]
            if cx == 0 and cy == 0 and cw == 0 and ch == 0:
                continue  # padded context slot
            alpha = 0.75 * row[4 * (k2 + 1) + c]
            ax.add_patch(
                plt.Rectangle(
                    (cx, cy), cw, ch,
                    fill=True, facecolor=CONTEXT_COLOR, alpha=alpha,
                )
            )
            ax.add_patch(
                plt.Rectangle(
                    (cx, cy), cw, ch,
                    fill=False, edgecolor=CONTEXT_COLOR, linewidth=0.75,
                )
            )
        plt.axis("off")
        plt.tight_layout()
        plt.savefig(
            os.path.join(img_save_dir, f"{stem}_attn_{cls}.png"),
            dpi=300,
            bbox_inches="tight",
            pad_inches=0,
        )
        plt.close()


PRED_COLORS = {"Price": "#fa4772", "Title": "#1e88e5", "Image": "#43a047"}


def visualize_predictions(img_path: str, picks, out_path: str):
    """Render one overlay PNG with a page's retrieval picks.

    picks: iterable of ``(class_name, x, y, w, h, score)`` rows, one per
    non-BG class, as written to ``retrieval.csv``.
    """
    import matplotlib
    from PIL import Image

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = Image.open(img_path).convert("RGB")
    plt.rcParams.update({"font.size": 6})
    plt.imshow(img)
    plt.title("Predicted boxes")
    ax = plt.gca()
    for cls, x, y, w, h, score in picks:
        color = PRED_COLORS.get(cls, "#757575")
        ax.add_patch(
            plt.Rectangle(
                (x, y), w, h, fill=False, edgecolor=color, linewidth=1.5,
            )
        )
        ax.text(
            x, max(y - 2.0, 0.0), f"{cls} {score:.2f}",
            color=color, fontsize=6,
        )
    plt.axis("off")
    plt.tight_layout()
    plt.savefig(out_path, dpi=300, bbox_inches="tight", pad_inches=0)
    plt.close()
