"""Decoded-screenshot disk cache: inflate each PNG once, not once per epoch.

Counterpart of ``cova_tpu/data/decode_cache.py`` with the same file naming
(``<page_id>.<tag>.npy`` under a per-dataset-root subdirectory) and the same
bytes (``np.save`` of the decoded uint8 array), so a cache directory written
by either package serves the other.

Each decoded array is stored the first time a page is touched; later epochs
and later runs read it back with ``np.load(..., mmap_mode="r")``, a copy out
of the OS page cache instead of a libpng inflate. The cost is one decoded
copy on disk (4.9 MB per page at 1280^2), which is why it is opt-in
(``--decode_cache DIR`` or ``COVA_DECODE_CACHE``).

Staleness: an entry is valid iff its mtime is >= the source PNG's
(make-style). Writes are atomic (tmp + ``os.replace``), so pipelines that
share a directory at worst decode a page twice.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np


class DecodeCache:
    """Per-page cache of decoded screenshots under ``cache_dir``.

    ``tag`` encodes everything that changes the decoded array, layout
    (``raw``/``s2d4``) and target size, so one directory serves configs
    with different geometries side by side.
    """

    def __init__(self, cache_dir: str, tag: str):
        self.dir = cache_dir
        self.tag = tag
        os.makedirs(cache_dir, exist_ok=True)

    def _path(self, page_id: str) -> str:
        return os.path.join(self.dir, f"{page_id}.{self.tag}.npy")

    def get(self, page_id: str, src_path: str) -> Optional[np.ndarray]:
        """The cached decode as a read-only memmap, or None on a miss or a
        stale entry. The memmap defers IO to the consumer's copy into the
        batch buffer."""
        path = self._path(page_id)
        try:
            if os.path.getmtime(path) < os.path.getmtime(src_path):
                return None  # source PNG newer than the cache entry
            return np.load(path, mmap_mode="r")
        except (OSError, ValueError, EOFError):
            # Missing, unreadable or truncated entry (np.load raises
            # EOFError on an empty file): decode again; put() replaces it.
            return None

    def put(self, page_id: str, arr: np.ndarray, src_path: str) -> None:
        """Atomically persist one decoded page. The entry's mtime is copied
        from the source, so a source stamped by a host whose clock runs
        ahead cannot leave the entry stale for ever."""
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=f".{self.tag}.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, arr)
            src_ns = os.stat(src_path).st_mtime_ns
            os.utime(tmp, ns=(src_ns, src_ns))
            os.replace(tmp, self._path(page_id))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
