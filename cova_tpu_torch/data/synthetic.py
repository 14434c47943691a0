"""Synthetic webpage generator for tests, smoke runs and benchmarks.

Counterpart of ``cova_tpu/data/synthetic.py``: the generator and the
hard-mode Bayes-oracle scorer that ``train --synthetic_hard`` and ``sweep``
report beside the model. For the same seed it draws the same numbers in the
same order, so pages are byte-identical to the JAX package's: 11..230 boxes
per page in preorder, exactly one box each of Price/Title/Image, square
screenshots. Pages can be materialized to disk in the reference layout
(imgs/*.png + bboxes/*.csv) or kept in memory.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from .dataset import WebDataset
from .records import PageRecord

# Hard-mode layout priors: per-class (x, y, w, h) ranges as fractions of the
# image side (Image: (x, y, height, aspect w/h)). True class boxes draw from
# these ranges; ~2 BG "mimics" per class draw from them widened by
# _HARD_WIDEN and take the class palette, so neither colour nor coarse
# layout alone identifies the true box.
_HARD_PRIORS = {
    1: ((0.10, 0.80), (0.25, 0.60), (0.04, 0.12), (0.02, 0.06)),  # Price
    2: ((0.05, 0.30), (0.00, 0.25), (0.30, 0.60), (0.03, 0.08)),  # Title
    3: ((0.05, 0.45), (0.02, 0.32), (0.28, 0.42), (0.90, 1.10)),  # Image
}
_HARD_WIDEN = 2.0


def _hard_prior_ranges(cls: int, ih: float, widen: float = 1.0):
    """Pixel-space [lo, hi] per prior dimension, widened about each range's
    midpoint; size lows are floored at 2 px (aspect is not scaled)."""
    out = []
    for d, (lo, hi) in enumerate(_HARD_PRIORS[cls]):
        mid, half = (lo + hi) / 2.0, (hi - lo) / 2.0 * widen
        scale = 1.0 if (cls == 3 and d == 3) else ih
        plo, phi = max(0.0, mid - half) * scale, (mid + half) * scale
        if d >= 2 and not (cls == 3 and d == 3):
            plo, phi = max(plo, 2.0), max(phi, 2.0)
        out.append((plo, phi))
    return out


def _hard_prior_draw(cls: int, ih: float, rng: np.random.Generator,
                     widen: float = 1.0) -> np.ndarray:
    vals = [rng.uniform(lo, hi)
            for lo, hi in _hard_prior_ranges(cls, ih, widen)]
    if cls == 3:
        x, y, h, aspect = vals
        return np.array([x, y, h * aspect, h], np.float32)
    return np.array(vals, np.float32)


def _hard_mimic_class(bx, by, bw, bh, ih: float) -> int:
    """Class whose widened prior region contains this geometry (0 if none)."""
    for cls in (1, 2, 3):
        rngs = _hard_prior_ranges(cls, ih, _HARD_WIDEN)
        if cls == 3:
            vals = (bx, by, bh, bw / max(bh, 1e-6))
        else:
            vals = (bx, by, bw, bh)
        tol = (0.5, 0.5, 0.5, 0.01 if cls == 3 else 0.5)
        if all(lo - t <= v <= hi + t
               for v, (lo, hi), t in zip(vals, rngs, tol)):
            return cls
    return 0


def synth_record(
    page_id: str,
    img_h: int,
    rng: np.random.Generator,
    min_boxes: int = 11,
    max_boxes: int = 230,
    n_additional_feat: int = 0,
    hard: bool = False,
) -> PageRecord:
    n = int(rng.integers(min_boxes, max_boxes + 1))
    # Random boxes with w,h >= 2 px, inside the image.
    x = rng.uniform(0, img_h - 4, size=n)
    y = rng.uniform(0, img_h - 4, size=n)
    w = rng.uniform(2, np.maximum(img_h - x, 3))
    h = rng.uniform(2, np.maximum(img_h - y, 3))
    boxes = np.stack([x, y, w, h], axis=1).astype(np.float32)
    labels = np.zeros((n,), dtype=np.int32)
    # Exactly one box per non-BG class.
    pos = rng.choice(n, size=3, replace=False)
    labels[pos] = [1, 2, 3]
    if hard:
        ih = float(img_h)
        for cls, p in ((1, pos[0]), (2, pos[1]), (3, pos[2])):
            boxes[p] = _hard_prior_draw(cls, ih, rng, widen=1.0)
        bg = np.setdiff1d(np.arange(n), pos)
        n_mimics = min(6, bg.size)
        mimic_idx = rng.choice(bg, size=n_mimics, replace=False)
        for k, m in enumerate(mimic_idx):
            boxes[m] = _hard_prior_draw(1 + k % 3, ih, rng,
                                        widen=_HARD_WIDEN)
        # Keep w,h >= 2 px and every box inside the image.
        boxes[:, 2:] = np.maximum(boxes[:, 2:], 2.0)
        np.clip(boxes[:, :2], 0, ih - 4, out=boxes[:, :2])
        boxes[:, 2] = np.minimum(boxes[:, 2], ih - boxes[:, 0])
        boxes[:, 3] = np.minimum(boxes[:, 3], ih - boxes[:, 1])
    feats = None
    if n_additional_feat > 0:
        feats = rng.normal(size=(n, n_additional_feat)).astype(np.float32)
        if hard:
            # Feature 0 becomes a noisy true-box indicator (sigma 0.6).
            feats[:, 0] = (labels != 0).astype(np.float32) + 0.6 * feats[:, 0]
    return PageRecord(page_id, boxes, labels, feats)


_PALETTE = {
    0: np.array([200, 200, 200], np.uint8),
    1: np.array([220, 40, 40], np.uint8),  # Price: red-ish
    2: np.array([40, 40, 220], np.uint8),  # Title: blue-ish
    3: np.array([40, 220, 40], np.uint8),  # Image: green-ish
}

# Hard-mode colour jitter: true class boxes jitter +-_TRUE_JITTER around the
# palette; a coloured mimic is, with p=_CONFUSABLE_P, drawn from the same
# cube and otherwise shifted 55..110 per channel away from the clip bound.
_TRUE_JITTER = 30
_CONFUSABLE_P = 0.06


def _box_colors(
    record: PageRecord, img_h: int, rng: np.random.Generator,
    hard: bool = False,
) -> np.ndarray:
    """Per-box fill colours, [n,3] uint8, chosen in record order."""
    n = record.n_boxes
    colors = np.broadcast_to(_PALETTE[0], (n, 3)).copy()
    for j in range(n):
        lab = int(record.labels[j])
        color = _PALETTE[lab]
        if hard:
            if lab == 0:
                bx, by, bw, bh = record.boxes_xywh[j]
                mc = _hard_mimic_class(bx, by, bw, bh, float(img_h))
                if mc and rng.uniform() < 0.9:
                    color = _PALETTE[mc]
                elif rng.uniform() < 0.05:
                    color = _PALETTE[int(rng.integers(1, 4))]
            if not np.array_equal(color, _PALETTE[0]):
                if lab == 0 and rng.uniform() >= _CONFUSABLE_P:
                    mag = rng.integers(55, 111, size=3)
                    sign = np.where(color.astype(np.int32) >= 128, -1, 1)
                    jit = mag * sign
                else:
                    jit = rng.integers(-_TRUE_JITTER, _TRUE_JITTER + 1,
                                       size=3)
                color = np.clip(
                    color.astype(np.int32) + jit, 0, 255
                ).astype(np.uint8)
        colors[j] = color
    return colors


def synth_image(
    record: PageRecord, img_h: int, rng: np.random.Generator,
    hard: bool = False, colors: np.ndarray | None = None,
) -> np.ndarray:
    """Screenshot-like uint8 image: light background, boxes drawn as blocks
    whose fill encodes their class. Plain BG boxes are painted first, then
    the salient boxes (class boxes and colour-matched mimics; in hard mode
    in area-descending order), then <= 7/channel of noise."""
    img = np.full((img_h, img_h, 3), 245, dtype=np.uint8)
    if colors is None:
        colors = _box_colors(record, img_h, rng, hard=hard)
    salient = (record.labels != 0) | (colors != _PALETTE[0]).any(axis=1)
    if hard:
        area = record.boxes_xywh[:, 2] * record.boxes_xywh[:, 3]
        order = np.lexsort((-area * salient, salient))
    else:
        order = np.argsort(salient, kind="stable")
    for (bx, by, bw, bh), color in zip(
        record.boxes_xywh[order], colors[order]
    ):
        x1, y1 = int(bx), int(by)
        x2 = min(int(bx + bw), img_h)
        y2 = min(int(by + bh), img_h)
        img[y1:y2, x1:x2] = color
    noise = rng.integers(0, 8, size=img.shape, dtype=np.uint8)
    return (img - np.minimum(img, noise)).astype(np.uint8)


# --------------------------------------------------------------------------
# Bayes-oracle scorer for the hard-mode generator.
#
# The retrieval metric picks, per class c, the box with the highest class-c
# score; with exactly one true box per class and (near-)independent boxes,
# the Bayes rule is argmax over the likelihood ratio
#     LR_c(i) = P(obs_i | i is the true c box) / P(obs_i | i is BG),
# computed from the generator's own parameters (the priors above). The
# observables are each box's geometry, its pre-noise fill colour, and (with
# additional features) its feature column 0. The oracle reads the assigned
# colours, so occlusion and the <=7/channel render noise do not lower it.
#
# Known approximations, all conservative or measure-small:
#   * post-draw clamping (w,h >= 2 px, image-bounds clipping) is modelled
#     only by the 0.5 px indicator tolerance;
#   * the joint constraint "the 3 true boxes are distinct" is ignored
#     (class regions barely overlap);
#   * the BG geometry mixture uses the expected mimic fraction
#     min(6, n-3)/(n-3) rather than the exact planted count.
# --------------------------------------------------------------------------

_SHIFT_LO, _SHIFT_HI = 55, 110  # _box_colors: rng.integers(55, 111)
_AF_SIGMA = 0.6  # synth_record's feature 0: 1{true} + 0.6*N(0,1)


def _geom_logpdf_class(cls: int, g, ih: float, widen: float) -> float:
    """Log-density of geometry (x, y, w, h) under class ``cls``'s prior at
    the given widening (1.0 = true-box draw, _HARD_WIDEN = mimic draw).
    Image draws (x, y, h, aspect); the aspect->w change of variables adds
    a 1/h Jacobian so Image densities are comparable across boxes."""
    x, y, w, h = (float(v) for v in g)
    rngs = _hard_prior_ranges(cls, ih, widen)
    if cls == 3:
        vals = (x, y, h, w / max(h, 1e-6))
        tols = (0.5, 0.5, 0.5, 0.02)
    else:
        vals = (x, y, w, h)
        tols = (0.5, 0.5, 0.5, 0.5)
    lp = 0.0
    for (lo, hi), v, t in zip(rngs, vals, tols):
        if not (lo - t <= v <= hi + t):
            return -np.inf
        lp -= np.log(max(hi - lo, 1e-9))
    if cls == 3:
        lp -= np.log(max(h, 1e-6))
    return lp


def _geom_logpdf_bg(g, ih: float, n_boxes: int) -> float:
    """Log-density of geometry under the BG mixture: planted mimics
    (widened class priors, 1/3 each) with probability min(6, n-3)/(n-3),
    else the plain random draw of synth_record (x,y ~ U(0, ih-4);
    w|x ~ U(2, max(ih-x, 3)); h|y ~ U(2, max(ih-y, 3)))."""
    x, y, w, h = (float(v) for v in g)
    n_bg = max(n_boxes - 3, 1)
    pi_mimic = min(6, n_bg) / n_bg
    p_mimic = 0.0
    for k in (1, 2, 3):
        lp = _geom_logpdf_class(k, g, ih, _HARD_WIDEN)
        if np.isfinite(lp):
            p_mimic += np.exp(lp) / 3.0
    p_rand = 0.0
    if -0.5 <= x <= ih - 4 + 0.5 and -0.5 <= y <= ih - 4 + 0.5:
        wmax, hmax = max(ih - x, 3.0), max(ih - y, 3.0)
        if 1.5 <= w <= wmax + 0.5 and 1.5 <= h <= hmax + 0.5:
            p_rand = (
                1.0 / (ih - 4) ** 2
                / max(wmax - 2.0, 1e-9)
                / max(hmax - 2.0, 1e-9)
            )
    dens = pi_mimic * p_mimic + (1.0 - pi_mimic) * p_rand
    # Clamped boxes can fall outside both supports; floor instead of -inf
    # so the LLR never becomes +inf off a modelling gap.
    return float(np.log(max(dens, 1e-300)))


def _log_color_true(col, cls: int, tol: int = 0) -> float:
    """Log-pmf of a fill colour under the true-box process: uniform integer
    jitter +-_TRUE_JITTER per channel around the class palette. ``tol``
    widens the support (visible-colour mode: the render noise subtracts up
    to 7/channel, shifting medians off the nominal cube)."""
    d = col.astype(np.int64) - _PALETTE[cls].astype(np.int64)
    if np.all(np.abs(d) <= _TRUE_JITTER + tol):
        return -3.0 * np.log(2 * _TRUE_JITTER + 1)
    return -np.inf


def _color_bg_pmf(col, mc: int, tol: int = 0) -> float:
    """Pmf of a fill colour under the BG process given the box's widened-
    region membership ``mc`` (_hard_mimic_class). Gray (never coloured)
    carries the remaining mass but never competes: the true-colour pmf is
    zero there."""
    base_p = {1: 0.0, 2: 0.0, 3: 0.0}
    if mc:
        base_p[mc] += 0.9
        for k in base_p:
            base_p[k] += 0.1 * 0.05 / 3.0
    else:
        for k in base_p:
            base_p[k] += 0.05 / 3.0
    cube = float(2 * _TRUE_JITTER + 1) ** 3
    shift = float(_SHIFT_HI - _SHIFT_LO + 1) ** 3
    p = 0.0
    c64 = col.astype(np.int64)
    for k, pk in base_p.items():
        if pk <= 0.0:
            continue
        base = _PALETTE[k].astype(np.int64)
        d = c64 - base
        if np.all(np.abs(d) <= _TRUE_JITTER + tol):
            p += pk * _CONFUSABLE_P / cube
        m = d * np.where(base >= 128, -1, 1)
        if np.all((m >= _SHIFT_LO - tol) & (m <= _SHIFT_HI + tol)):
            p += pk * (1.0 - _CONFUSABLE_P) / shift
    return p


def oracle_scores(
    boxes_xywh: np.ndarray,
    colors: np.ndarray,
    img_h: int,
    additional_feats: np.ndarray | None = None,
    color_tol: int = 0,
) -> np.ndarray:
    """Per-box Bayes log-likelihood-ratio scores [n, 3] (classes 1..3)
    for one hard-mode page (see the section comment above)."""
    ih = float(img_h)
    n = len(boxes_xywh)
    use_af = additional_feats is not None and additional_feats.shape[1] > 0
    scores = np.full((n, 3), -np.inf, dtype=np.float64)
    for i in range(n):
        g = boxes_xywh[i]
        col = colors[i]
        mc = _hard_mimic_class(g[0], g[1], g[2], g[3], ih)
        lp_bg = _geom_logpdf_bg(g, ih, n) + np.log(
            max(_color_bg_pmf(col, mc, tol=color_tol), 1e-300)
        )
        af_llr = 0.0
        if use_af:
            # f0 | true ~ N(1, sigma^2); f0 | BG ~ N(0, sigma^2):
            # llr = (2 f0 - 1) / (2 sigma^2).
            f0 = float(additional_feats[i, 0])
            af_llr = (2.0 * f0 - 1.0) / (2.0 * _AF_SIGMA**2)
        for c in (1, 2, 3):
            lp_true = _geom_logpdf_class(c, g, ih, 1.0) + _log_color_true(
                col, c, tol=color_tol
            )
            scores[i, c - 1] = lp_true + af_llr - lp_bg
    return scores


def colors_from_image(
    img: np.ndarray, boxes_xywh: np.ndarray
) -> np.ndarray:
    """Each box's fill colour estimated from the rendered image: the
    per-channel median over the box's interior pixels. Scoring these
    instead of the assigned colours folds occlusion, the render noise and
    integer rasterization into the ceiling."""
    ih = img.shape[0]
    n = len(boxes_xywh)
    out = np.zeros((n, 3), dtype=np.uint8)
    for i, (bx, by, bw, bh) in enumerate(boxes_xywh):
        x1, y1 = int(bx), int(by)
        x2, y2 = min(int(bx + bw), ih), min(int(by + bh), ih)
        if x2 <= x1 or y2 <= y1:
            continue
        patch = img[y1:y2, x1:x2].reshape(-1, 3)
        out[i] = np.median(patch, axis=0).astype(np.uint8)
    return out


def oracle_retrieval_correct(
    ds: "InMemoryWebDataset", visible: bool = False
) -> np.ndarray:
    """Oracle retrieval correctness [n_pages, 3] bool over a hard-mode
    in-memory dataset: per class, the oracle picks the argmax LLR, correct
    iff that is the true class box (the retrieval metric at k=1).

    ``visible=True`` scores colours re-estimated from the rendered image
    (``colors_from_image``, tolerance 8/channel for the noise shift)
    instead of the assigned ones: the ceiling of a rule that sees only
    pixels."""
    if not getattr(ds, "hard", False):
        raise ValueError(
            "oracle scorer models the HARD generator; easy mode is "
            "saturating by design (colors identify classes exactly)"
        )
    out = np.zeros((len(ds.ids), 3), dtype=bool)
    for i in range(len(ds.ids)):
        if visible:
            colors = colors_from_image(ds._images[i], ds.all_boxes[i])
            tol = 8
        else:
            colors, tol = ds._colors[i], 0
        s = oracle_scores(
            ds.all_boxes[i], colors, ds.img_h, ds.all_additional[i],
            color_tol=tol,
        )
        labels = ds.all_labels[i]
        for c in (1, 2, 3):
            true_idx = int(np.argmax(labels == c))
            out[i, c - 1] = int(np.argmax(s[:, c - 1])) == true_idx
    return out


class InMemoryWebDataset(WebDataset):
    """WebDataset-compatible dataset backed by synthesized arrays."""

    def __init__(
        self,
        n_pages: int,
        img_h: int,
        seed: int = 0,
        min_boxes: int = 11,
        max_boxes: int = 230,
        n_additional_feat: int = 0,
        hard: bool = False,
    ):
        # Deliberately skip WebDataset.__init__ (no disk backing).
        self.root = "<memory>"
        self.img_h = img_h
        self.hard = hard
        self.ids = [str(i) for i in range(n_pages)]
        self.all_boxes = []
        self.all_labels = []
        self.all_additional = []
        self._images: List[np.ndarray] = []
        # Each box's pre-noise fill colour, for the oracle scorer.
        self._colors: List[np.ndarray] = []
        for i in range(n_pages):
            rng = np.random.default_rng((seed, i))
            rec = synth_record(
                str(i), img_h, rng, min_boxes, max_boxes,
                n_additional_feat, hard=hard,
            )
            self.all_boxes.append(rec.boxes_xywh)
            self.all_labels.append(rec.labels)
            self.all_additional.append(rec.additional_feats)
            colors = _box_colors(rec, img_h, rng, hard=hard)
            self._colors.append(colors)
            self._images.append(
                synth_image(rec, img_h, rng, hard=hard, colors=colors)
            )
        self.n_additional_feat = n_additional_feat

    def image(self, index: int) -> np.ndarray:
        return self._images[index]

    def subset(self, idxs) -> "InMemoryWebDataset":
        """A dataset over the given page indices (split slicing for the
        synthetic CLI path)."""
        ds = InMemoryWebDataset.__new__(InMemoryWebDataset)
        ds.root = self.root
        ds.img_h = self.img_h
        ds.hard = self.hard
        ds.ids = [self.ids[i] for i in idxs]
        ds.all_boxes = [self.all_boxes[i] for i in idxs]
        ds.all_labels = [self.all_labels[i] for i in idxs]
        ds.all_additional = [self.all_additional[i] for i in idxs]
        ds._images = [self._images[i] for i in idxs]
        ds._colors = [self._colors[i] for i in idxs]
        ds.n_additional_feat = self.n_additional_feat
        return ds


def materialize(
    out_dir: str,
    n_pages: int,
    img_h: int,
    seed: int = 0,
    min_boxes: int = 11,
    max_boxes: int = 230,
    n_additional_feat: int = 0,
    hard: bool = False,
) -> List[str]:
    """Write a synthetic dataset in the reference on-disk layout
    (imgs/<id>.png, bboxes/<id>.csv with header, optional
    additional_features/<id>.csv). Returns the page ids."""
    from PIL import Image

    os.makedirs(os.path.join(out_dir, "imgs"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "bboxes"), exist_ok=True)
    if n_additional_feat > 0:
        os.makedirs(
            os.path.join(out_dir, "additional_features"), exist_ok=True
        )
    ids = []
    for i in range(n_pages):
        rng = np.random.default_rng((seed, i))
        rec = synth_record(
            str(i), img_h, rng, min_boxes, max_boxes,
            n_additional_feat, hard=hard,
        )
        img = synth_image(rec, img_h, rng, hard=hard)
        Image.fromarray(img).save(
            os.path.join(out_dir, "imgs", f"{rec.page_id}.png")
        )
        rows = np.concatenate(
            [rec.boxes_xywh, rec.labels[:, None].astype(np.float32)], axis=1
        )
        np.savetxt(
            os.path.join(out_dir, "bboxes", f"{rec.page_id}.csv"),
            rows,
            delimiter=",",
            header="x,y,w,h,label",
            comments="",
            fmt="%.2f",
        )
        if rec.additional_feats is not None:
            np.savetxt(
                os.path.join(
                    out_dir, "additional_features", f"{rec.page_id}.csv"
                ),
                rec.additional_feats,
                delimiter=",",
                header=",".join(
                    f"f{k}" for k in range(n_additional_feat)
                ),
                comments="",
                fmt="%.4f",
            )
        ids.append(rec.page_id)
    return ids
