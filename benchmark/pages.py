"""The benchmark's traffic: pages made from the seed, grouped into the pool
of batches that a cell cycles over.

A page is a screenshot (uint8 [H, W, 3]) with its DOM element boxes (xywh,
in preorder) and their labels: exactly one Price, Title and Image box, the
rest background. The recipe is a frozen copy of the port's synthetic pages
(``synth_record`` and ``synth_image`` without the hard mode): boxes drawn
uniformly inside the image, a light background, boxes painted as blocks
coloured by class (background boxes first), then up to 7 a channel of
noise taken off. Screenshots are painted on the device from a generator
seeded by the run's seed and then held on the host.

Box counts follow the data's distribution (``splits/bbox_stats.txt``: min
11, median 84, mean 93.0, std 37.3, max 230) as a log-normal shifted to the
minimum, fitted to the mean and std. Every seed gets the same counts, the
quantile midpoints of that law, and the same grouping of counts into
batches (from the mix's ``grouping_seed``), so every seed runs the same
shapes; the seed decides the order of the batches, the order of pages in a
batch, each box's place and size, and the pixels. Training mixes keep every
labelled box and a fixed share of the background boxes (``bg_sampling``),
chosen by the seed, after the screenshot is painted with all of them.
"""

from __future__ import annotations

import math
import statistics
from typing import List, Sequence

import numpy as np
import torch

PALETTE = {0: (200, 200, 200), 1: (220, 40, 40), 2: (40, 40, 220),
           3: (40, 220, 40)}
BACKGROUND = 245
NOISE = 8  # noise values 0..7


def sub_seed(seed: int, k: int) -> int:
    """A 63-bit seed for stream ``k`` of the run seed ``seed`` (any whole
    number)."""
    ss = np.random.SeedSequence([seed % 2**64, k])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def box_counts(spec: dict, n: int) -> List[int]:
    """``n`` box counts, ascending: the quantile midpoints of a log-normal
    shifted to ``spec["min"]`` with the given mean and std, clipped to
    [min, max]."""
    lo, hi = spec["min"], spec["max"]
    mean, std = spec["mean"] - lo, spec["std"]
    sigma = math.sqrt(math.log(1 + (std / mean) ** 2))
    mu = math.log(mean) - sigma ** 2 / 2
    nd = statistics.NormalDist()
    return [min(hi, max(lo, round(lo + math.exp(
        mu + sigma * nd.inv_cdf((k + 0.5) / n))))) for k in range(n)]


def page_geometry(n: int, img_h: int, rng: np.random.Generator):
    """Boxes [n, 4] xywh float32 with w, h >= 2 px inside the image, and
    labels [n] int32 with one box each of classes 1, 2, 3."""
    x = rng.uniform(0, img_h - 4, size=n)
    y = rng.uniform(0, img_h - 4, size=n)
    w = rng.uniform(2, np.maximum(img_h - x, 3))
    h = rng.uniform(2, np.maximum(img_h - y, 3))
    boxes = np.stack([x, y, w, h], axis=1).astype(np.float32)
    labels = np.zeros((n,), np.int32)
    labels[rng.choice(n, size=3, replace=False)] = [1, 2, 3]
    return boxes, labels


def sample_background(boxes, labels, fraction: float,
                      rng: np.random.Generator):
    """Every labelled box and ``floor(fraction * n_background)`` background
    boxes chosen at random, in their preorder."""
    if fraction >= 1.0:
        return boxes, labels
    bg = np.flatnonzero(labels == 0)
    kept = rng.choice(bg, size=int(math.floor(fraction * bg.size)),
                      replace=False)
    keep = np.sort(np.concatenate([np.flatnonzero(labels != 0), kept]))
    return boxes[keep], labels[keep]


def paint(geometry: Sequence, img_h: int, seed: int, device) -> np.ndarray:
    """The screenshots [N, H, W, 3] uint8 of pages ``(boxes, labels)``,
    painted on ``device`` and returned on the host."""
    dev = torch.device(device)
    n = len(geometry)
    imgs = torch.full((n, img_h, img_h, 3), BACKGROUND, dtype=torch.uint8,
                      device=dev)
    colors = {c: torch.tensor(v, dtype=torch.uint8, device=dev)
              for c, v in PALETTE.items()}
    for k, (boxes, labels) in enumerate(geometry):
        order = np.argsort(labels != 0, kind="stable")
        for (bx, by, bw, bh), lab in zip(boxes[order], labels[order]):
            x1, y1 = int(bx), int(by)
            x2, y2 = min(int(bx + bw), img_h), min(int(by + bh), img_h)
            imgs[k, y1:y2, x1:x2] = colors[int(lab)]
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, 4))
    noise = torch.randint(0, NOISE, imgs.shape, generator=gen, device=dev,
                          dtype=torch.uint8)
    imgs -= torch.minimum(imgs, noise)
    return imgs.cpu().numpy()


class Pool:
    """The pages of a cell and its batches. ``pages[i]`` holds ``page_id``,
    ``image``, ``boxes_xywh`` and ``labels``; ``batches[j]`` lists the pages
    of batch j, in the order the window cycles over them."""

    def __init__(self, pages: List[dict], batches: List[List[int]]):
        self.pages = pages
        self.batches = batches

    def batch_pages(self, j: int) -> List[dict]:
        return [self.pages[i] for i in self.batches[j]]


def make_pool(traffic: dict, cfg: dict, seed: int, device) -> Pool:
    """The pool of ``traffic`` (``pool_pages``, ``batch_size``,
    ``box_counts``, ``grouping_seed``, ``bg_sampling``) at the
    configuration's image size, from ``seed``."""
    n, bsz = traffic["pool_pages"], traffic["batch_size"]
    if n % bsz:
        raise ValueError("pool_pages must be a multiple of batch_size")
    img_h = cfg["img_height"]
    counts = box_counts(traffic["box_counts"], n)
    grouping = np.random.default_rng(traffic["grouping_seed"]).permutation(n)
    groups = [grouping[j * bsz:(j + 1) * bsz] for j in range(n // bsz)]
    rng = np.random.default_rng([seed % 2**64, 1])
    order = rng.permutation(len(groups))
    page_counts = [counts[i] for j in order for i in rng.permutation(
        groups[j])]
    geometry = [page_geometry(c, img_h, rng) for c in page_counts]
    images = paint(geometry, img_h, seed, device)
    pages = []
    for k, (boxes, labels) in enumerate(geometry):
        boxes, labels = sample_background(
            boxes, labels, traffic.get("bg_sampling", 1.0), rng)
        pages.append({"page_id": f"p{k}", "image": images[k],
                      "boxes_xywh": boxes, "labels": labels})
    batches = [list(range(j * bsz, (j + 1) * bsz))
               for j in range(len(groups))]
    return Pool(pages, batches)
