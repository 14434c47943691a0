"""On-disk webpage dataset: screenshots + preorder bbox CSVs.

Counterpart of ``cova_tpu/data/dataset.py``, with its opt-in
decoded-screenshot cache (``data/decode_cache.py``). Layout:
``<root>/imgs/<id>.png``, ``<root>/bboxes/<id>.csv`` with rows
``x,y,w,h,label`` under a header, optional
``<root>/additional_features/<id>.csv``. Images are uint8 HWC; the device
normalizes them.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence

import numpy as np

from . import native_loader
from .records import PageRecord


def _load_csv(path: str) -> np.ndarray:
    arr = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float32)
    if arr.size == 0:  # header-only CSV: zero boxes, not a (1, 0) row
        return arr.reshape(0, 5)
    if arr.ndim == 1:  # single-row CSVs
        arr = arr[None, :]
    return arr


def _pad_crop(arr: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad bottom/right or crop to [size, size, 3], the native
    decoder's convention."""
    h, w = arr.shape[:2]
    if h == size and w == size:
        return arr
    out = np.zeros((size, size, 3), np.uint8)
    out[: min(h, size), : min(w, size)] = arr[:size, :size]
    return out


class WebDataset:
    """Eagerly loads all bbox (and optional additional-feature) CSVs;
    decodes screenshots lazily per access, through libpng when the native
    runtime is built and ``img_size`` is known, else through PIL."""

    def __init__(
        self,
        root: str,
        page_ids: Sequence[str],
        use_additional_feats: bool = False,
        img_size: Optional[int] = None,
        use_native: bool = True,
        decode_cache_dir: Optional[str] = None,
    ):
        self.root = root
        self.ids: List[str] = [str(i) for i in page_ids]
        self.img_size = img_size
        self.use_native = use_native and native_loader.available()
        # Opt-in decoded-screenshot cache: an explicit directory or
        # COVA_DECODE_CACHE. ``image()`` caches the raw layout; the
        # pipeline's batch decode takes its own layout-tagged handle.
        self.decode_cache_dir = decode_cache_dir or os.environ.get(
            "COVA_DECODE_CACHE"
        )
        self._raw_cache = self.decode_cache(
            f"raw-{img_size}" if img_size is not None else "raw-orig"
        )
        self.img_paths = [
            os.path.join(root, "imgs", f"{i}.png") for i in self.ids
        ]
        self.all_boxes: List[np.ndarray] = []
        self.all_labels: List[np.ndarray] = []
        for i in self.ids:
            path = os.path.join(root, "bboxes", f"{i}.csv")
            if self.use_native:
                rows = native_loader.parse_bbox_csv(path)
            else:
                rows = _load_csv(path)
            self.all_boxes.append(rows[:, :4].astype(np.float32))
            self.all_labels.append(rows[:, 4].astype(np.int32))
        self.all_additional: List[Optional[np.ndarray]] = []
        if use_additional_feats:
            for i in self.ids:
                self.all_additional.append(
                    _load_csv(
                        os.path.join(root, "additional_features", f"{i}.csv")
                    )
                )
            self.n_additional_feat = int(self.all_additional[0].shape[1])
        else:
            self.all_additional = [None] * len(self.ids)
            self.n_additional_feat = 0

    def __len__(self) -> int:
        return len(self.ids)

    def record(self, index: int) -> PageRecord:
        """Bbox-side record only (no image decode)."""
        return PageRecord(
            page_id=self.ids[index],
            boxes_xywh=self.all_boxes[index],
            labels=self.all_labels[index],
            additional_feats=self.all_additional[index],
        )

    def decode_cache(self, tag: str):
        """A layout-tagged ``DecodeCache`` over this dataset's cache
        directory, or None when caching is off. Entries live in a
        subdirectory keyed by the resolved dataset root: page ids are
        unique only within a dataset."""
        from .decode_cache import DecodeCache

        if not self.decode_cache_dir:
            return None
        root_key = hashlib.sha1(
            os.path.realpath(self.root).encode()
        ).hexdigest()[:12]
        return DecodeCache(
            os.path.join(self.decode_cache_dir, root_key), tag
        )

    def image(self, index: int) -> np.ndarray:
        """Decode the screenshot to uint8 [H, W, 3] (cached if enabled)."""
        if self._raw_cache is not None:
            hit = self._raw_cache.get(self.ids[index], self.img_paths[index])
            if hit is not None:
                return np.array(hit)  # a writable copy out of the memmap
        if self.use_native and self.img_size is not None:
            arr = native_loader.decode_png(
                self.img_paths[index], self.img_size, self.img_size
            )
        else:
            from PIL import Image

            with Image.open(self.img_paths[index]) as im:
                arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
            if self.img_size is not None:
                # The native path's geometry exactly (zero-pad / crop, no
                # resampling), so inputs do not depend on which path ran.
                arr = _pad_crop(arr, self.img_size)
        if self._raw_cache is not None:
            self._raw_cache.put(self.ids[index], arr, self.img_paths[index])
        return arr


def load_fold_ids(fold_dir: str):
    """Read the split protocol files.

    Returns (train_ids, val_ids, test_ids, webpage_info, test_domains) where
    webpage_info is an [n, 2] str array of (img_id, domain) or None, and
    test_domains a str array or None.
    """
    train, val, test = (
        np.loadtxt(os.path.join(fold_dir, f"{name}_imgs.txt"), str, ndmin=1)
        for name in ("train", "val", "test"))

    info_path = os.path.join(fold_dir, "webpage_info.csv")
    webpage_info = None
    if os.path.isfile(info_path):
        webpage_info = np.atleast_2d(
            np.loadtxt(info_path, str, delimiter=",", skiprows=1)
        )

    dom_path = os.path.join(fold_dir, "test_domains.txt")
    test_domains = None
    if os.path.isfile(dom_path):
        test_domains = np.loadtxt(dom_path, str, ndmin=1)

    for a, b in ((train, val), (val, test), (train, test)):
        if np.intersect1d(a, b).size:
            raise ValueError(f"splits in {fold_dir} are not disjoint")
    return train, val, test, webpage_info, test_domains
