"""Padded batch assembly: list of pages -> statically-shaped numpy arrays.

Counterpart of ``cova_tpu/data/batching.py``. A ``Batch`` stays numpy on the
host; ``train.steps.batch_to_device`` moves it to the model's device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from .records import PaddedPage


class Batch(NamedTuple):
    """One statically-shaped eval batch.

    ``images`` are uint8, shipped in space-to-depth(4) form
    [B, H/4, W/4, 48] when H and W divide by 4 (raw [B, H, W, 3] otherwise);
    the model's stem conv consumes the s2d(4) form directly
    (``ops.conv_stem.stem_conv_s2d``). Normalization to [0, 1] happens on
    the device.
    """

    images: np.ndarray  # [B, H/4, W/4, 48] (or [B, H, W, 3]) uint8
    boxes: np.ndarray  # [B, P, 4] float32 x1y1x2y2 (image coords)
    labels: np.ndarray  # [B, P] int32
    box_mask: np.ndarray  # [B, P] bool
    context_indices: np.ndarray  # [B, P, 2K] int32 per-image, -1 = pad
    additional_feats: np.ndarray  # [B, P, F] float32 (F may be 0)

    @property
    def batch_size(self) -> int:
        return int(self.images.shape[0])


def collate(
    images: Sequence[np.ndarray], pages: Sequence[PaddedPage]
) -> Batch:
    assert len(images) == len(pages)
    h, w, c = images[0].shape
    if c == 3 and h % 4 == 0 and w % 4 == 0:
        from ..ops.conv_stem import s2d4_host

        images = [s2d4_host(im) for im in images]
    # The native batch decoder already returns one contiguous [B, ...]
    # array; passing it through as-is avoids a re-stack copy per batch.
    stacked = (
        images if isinstance(images, np.ndarray) else np.stack(images, 0)
    )
    return Batch(
        images=stacked,
        boxes=np.stack([p.boxes_xyxy for p in pages], 0),
        labels=np.stack([p.labels for p in pages], 0),
        box_mask=np.stack([p.box_mask for p in pages], 0),
        context_indices=np.stack([p.context_indices for p in pages], 0),
        additional_feats=np.stack([p.additional_feats for p in pages], 0),
    )


def pad_batch(batch: Batch, target_b: int) -> tuple[Batch, np.ndarray]:
    """Pad the leading batch dim to ``target_b`` by cycling the real pages
    (their boxes fully masked out), as ``cova_tpu``'s ``pad_batch`` does, so
    image-level batch statistics see real pages. Returns (padded batch,
    page validity mask [target_b])."""
    b = batch.batch_size
    if b == target_b:
        return batch, np.ones((b,), dtype=bool)
    assert b < target_b
    fill = np.arange(target_b - b) % b

    def _pad(x: np.ndarray) -> np.ndarray:
        return np.concatenate([x, x[fill]], axis=0)

    page_mask = np.zeros((target_b,), dtype=bool)
    page_mask[:b] = True
    padded = Batch(*[_pad(np.asarray(f)) for f in batch])
    padded = padded._replace(
        box_mask=np.where(page_mask[:, None], padded.box_mask, False)
    )
    return padded, page_mask


def _bucket_target(max_valid: int, p_full: int,
                   buckets: Sequence[int]) -> int:
    for p in sorted(buckets):
        if p >= max_valid:
            return min(p, p_full)
    return p_full


def _max_valid(batch: Batch) -> int:
    return int(batch.box_mask.sum(axis=1).max()) if batch.box_mask.size else 0


def bucket_batch(batch: Batch, buckets: Sequence[int]) -> Batch:
    """Slice the box dim down to the smallest bucket holding every page's
    valid boxes (valid rows are front-packed by ``records.pad_page``), so all
    box-dim work shrinks to the batch's real box count. Every sliced-off row
    is masked padding, and per-image context indices are always below the
    page's valid count, so the result is unchanged."""
    p_full = batch.boxes.shape[1]
    target = (
        _bucket_target(_max_valid(batch), p_full, buckets)
        if buckets
        else p_full
    )
    if target >= p_full:
        return batch
    return slice_boxes(batch, target)


def slice_boxes(batch: Batch, target: int) -> Batch:
    """The first ``target`` box rows of every page."""
    return batch._replace(
        boxes=batch.boxes[:, :target],
        labels=batch.labels[:, :target],
        box_mask=batch.box_mask[:, :target],
        context_indices=batch.context_indices[:, :target],
        additional_feats=batch.additional_feats[:, :target],
    )
