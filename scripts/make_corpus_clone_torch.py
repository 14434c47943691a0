#!/usr/bin/env python
"""Synthesize the corpus CLONE for the PyTorch port: one hard-mode page per
real page id of ``splits/all_imgs.txt`` (7,740 ids, 408 domains), in the
reference's on-disk layout (``imgs/<id>.png`` + ``bboxes/<id>.csv``), so
``python -m cova_tpu_torch.cli train --data_dir <clone> -cvf k`` runs the
verbatim fold protocol at corpus scale.

Counterpart of ``scripts/make_corpus_clone.py``, built on
``cova_tpu_torch.data.synthetic``: the same flags, and for one seed the same
PNG pixels, CSV text and ``corpus_oracle.csv``, byte for byte. The box count
per page is a clipped normal draw matching ``splits/bbox_stats.txt`` (min 11
/ max 230 / mean 93 / std 37.3). ``corpus_oracle.csv`` records, per page,
whether the generator's own likelihood-ratio rule finds each class from the
assigned colors (latent) and from the rendered pixels (visible):
``scripts/corpus_oracle_summary.py`` averages it over each fold's test list.

Every page is keyed by (seed, page id), so the pages are written by one
process a core and the files do not depend on how many there are.

Usage:
  python scripts/make_corpus_clone_torch.py --out .corpus_clone \\
      --img_height 512 [--seed 123] [--limit N] [--no-oracle]
"""

import argparse
import csv
import multiprocessing
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cova_tpu_torch.data.synthetic import (  # noqa: E402
    _box_colors,
    colors_from_image,
    oracle_scores,
    synth_image,
    synth_record,
)

BBOX_MIN, BBOX_MAX, BBOX_MEAN, BBOX_STD = 11, 230, 93.0, 37.3


def n_boxes_for(rng: np.random.Generator) -> int:
    """Clipped-normal box count matching splits/bbox_stats.txt."""
    return int(np.clip(round(rng.normal(BBOX_MEAN, BBOX_STD)),
                       BBOX_MIN, BBOX_MAX))


def make_page(out: str, pid: str, img_height: int, seed: int,
              oracle: bool):
    """Write page ``pid`` (unless both files exist); returns its oracle row
    (page id, then latent and visible hits for P, T, I) or None."""
    from PIL import Image

    png = os.path.join(out, "imgs", f"{pid}.png")
    csv_path = os.path.join(out, "bboxes", f"{pid}.csv")
    rng = np.random.default_rng((seed, int(pid)))
    n = n_boxes_for(rng)
    rec = synth_record(pid, img_height, rng, min_boxes=n, max_boxes=n,
                       hard=True)
    colors = _box_colors(rec, img_height, rng, hard=True)
    img = synth_image(rec, img_height, rng, hard=True, colors=colors)
    if not (os.path.isfile(png) and os.path.isfile(csv_path)):
        Image.fromarray(img).save(png)
        rows = np.concatenate(
            [rec.boxes_xywh, rec.labels[:, None].astype(np.float32)], axis=1)
        np.savetxt(csv_path, rows, delimiter=",",
                   header="x,y,w,h,label", comments="", fmt="%.2f")
    if not oracle:
        return None
    accs = []
    for visible in (False, True):
        if visible:
            cols, tol = colors_from_image(img, rec.boxes_xywh), 8
        else:
            cols, tol = colors, 0
        s = oracle_scores(rec.boxes_xywh, cols, img_height, color_tol=tol)
        for c in (1, 2, 3):
            true_idx = int(np.argmax(rec.labels == c))
            accs.append(int(np.argmax(s[:, c - 1]) == true_idx))
    return [pid] + accs


def fold_subset(splits: str, out: str, fold: int = 1, n_train: int = 40,
                n_val: int = 10, n_test: int = 10) -> list:
    """Write a small splits tree to ``out``: the first ``n_train`` /
    ``n_val`` / ``n_test`` ids of ``splits/Fold-<fold>``'s lists, that
    fold's ``webpage_info.csv`` rows and domain lists for them, and an
    ``all_imgs.txt`` of their union (the pages to generate). Returns the
    ids."""
    src, dst = (os.path.join(d, f"Fold-{fold}") for d in (splits, out))
    os.makedirs(dst, exist_ok=True)
    info = np.loadtxt(os.path.join(src, "webpage_info.csv"), str,
                      delimiter=",", skiprows=1)
    domain = dict(map(tuple, info))
    ids = []
    for name, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        part = np.loadtxt(os.path.join(src, f"{name}_imgs.txt"), str)[:n]
        ids += part.tolist()
        for kind, rows in (("imgs", part),
                           ("domains", sorted({domain[i] for i in part}))):
            with open(os.path.join(dst, f"{name}_{kind}.txt"), "w") as f:
                f.write("\n".join(rows) + "\n")
    with open(os.path.join(dst, "webpage_info.csv"), "w") as f:
        f.write("webpage_name,domain\n")
        f.writelines(f"{i},{domain[i]}\n" for i in ids)
    with open(os.path.join(out, "all_imgs.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    return ids


def _make_page(job):
    return make_page(*job)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--img_height", type=int, default=512)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--limit", type=int, default=0,
                    help="only the first N ids (smoke runs)")
    ap.add_argument("--no-oracle", action="store_true")
    ap.add_argument("--splits", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "splits"))
    args = ap.parse_args()

    ids = np.loadtxt(os.path.join(args.splits, "all_imgs.txt"), str, ndmin=1)
    if args.limit:
        ids = ids[: args.limit]
    os.makedirs(os.path.join(args.out, "imgs"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "bboxes"), exist_ok=True)

    jobs = [(args.out, str(pid), args.img_height, args.seed,
             not args.no_oracle) for pid in ids]
    oracle_rows = []
    t0 = time.perf_counter()
    workers = max(1, min(os.cpu_count() or 1, len(jobs)))
    with multiprocessing.get_context("fork").Pool(workers) as pool:
        for k, row in enumerate(pool.imap(_make_page, jobs, chunksize=8)):
            if row is not None:
                oracle_rows.append(row)
            if (k + 1) % 250 == 0:
                rate = (k + 1) / (time.perf_counter() - t0)
                print(f"{k + 1}/{len(ids)} pages ({rate:.1f}/s)",
                      flush=True)

    if oracle_rows:
        with open(os.path.join(args.out, "corpus_oracle.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["page_id",
                        "price_latent", "title_latent", "image_latent",
                        "price_visible", "title_visible", "image_visible"])
            w.writerows(oracle_rows)
        arr = np.array([r[1:] for r in oracle_rows], dtype=np.float64)
        m = arr.mean(axis=0) * 100
        print("oracle latent  P %.1f T %.1f I %.1f" % (m[0], m[1], m[2]))
        print("oracle visible P %.1f T %.1f I %.1f" % (m[3], m[4], m[5]))
    dt = time.perf_counter() - t0
    print(f"done: {len(ids)} pages in {dt:.0f}s -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
