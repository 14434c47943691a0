"""Attention-weight extraction and its overlays.

Counterpart of ``cova_tpu/train/extract.py`` (the reference's
``extract_attn_wts_and_visualize.py``): for every test page, one CSV whose
rows are the page's non-BG boxes with the layout ``[4 bbox coords (x,y,w,h),
label, 2K*4 context bbox coords, 2K attention weights]`` (``%.3f``), then
the overlay PNGs. The forward returns the attention weights
(``CoVAOutput.attn_wts``), so extraction is a plain eval pass. The port runs
in one process, so every call writes (the JAX package writes from process 0
only).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..data.batching import pad_batch
from ..data.device_prefetch import device_prefetch
from .steps import forward_step


def _context_coords(boxes_xywh: np.ndarray, ctx: np.ndarray) -> np.ndarray:
    """[x, y, w, h] of each context slot, zeros where the slot is -1 (the
    reference's zero-row padding).

    boxes_xywh: [P, 4]; ctx: [P, K]. Returns [P, K*4].
    """
    padded = np.concatenate(
        [boxes_xywh, np.zeros((1, 4), boxes_xywh.dtype)], 0
    )
    return padded[ctx.reshape(-1)].reshape(ctx.shape[0], -1)


def extract_attention(
    model,
    pipeline,
    data_dir: Optional[str],
    out_dir: str,
    visualize: bool = True,
    max_pages: Optional[int] = None,
):
    """Run ``model`` (eval mode) over the pipeline's pages, writing one
    attention CSV per page into ``out_dir`` and, with ``visualize``, the
    overlays of ``<data_dir>/imgs/<id>.png``. Batches reach the model's
    device through ``data.device_prefetch``, as ``predict_pages``'s do."""
    os.makedirs(out_dir, exist_ok=True)
    eval_bs = pipeline.batch_size
    n_done = 0

    def done():
        # The reference announces the output dir and the CSV layout, also
        # when the run is capped.
        print(
            "Extracted attention visualizations and weights for "
            f"{n_done} images saved in {out_dir}"
        )
        print(
            "CSV row layout: [4 bbox coords (x,y,w,h), label, "
            "2K*4 context bbox coords, 2K attention weights]"
        )

    def padded_batches():
        for ids, batch in pipeline.epoch(epoch=0):
            yield (ids, batch), pad_batch(batch, eval_bs)[0]

    device = next(model.parameters()).device
    for (ids, batch), _, on_device in device_prefetch(padded_batches(),
                                                      device):
        real_b = batch.batch_size
        attn = forward_step(model, on_device).attn_wts  # [B, P, K]
        attn = attn.cpu().numpy()
        for i in range(real_b):
            if max_pages is not None and n_done >= max_pages:
                return done()
            page_id = ids[i]
            mask = np.asarray(batch.box_mask[i])
            labels = np.asarray(batch.labels[i])
            xywh = np.asarray(batch.boxes[i]).copy()
            xywh[:, 2:] -= xywh[:, :2]
            ctx_coords = _context_coords(
                xywh, np.asarray(batch.context_indices[i]))

            keep = (labels > 0) & mask
            rows = np.concatenate(
                [
                    xywh[keep],
                    labels[keep, None].astype(np.float32),
                    ctx_coords[keep],
                    attn[i][keep],
                ],
                axis=1,
            )
            csv_path = os.path.join(out_dir, f"{page_id}.csv")
            np.savetxt(csv_path, rows, delimiter=",", fmt="%.3f")

            if visualize:
                from ..utils.visualize import visualize_bbox

                visualize_bbox(
                    os.path.join(data_dir, "imgs", f"{page_id}.png"),
                    csv_path,
                    out_dir,
                )
            n_done += 1
    done()
