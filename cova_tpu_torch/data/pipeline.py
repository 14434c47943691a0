"""Host input pipeline: threaded decode + background prefetch.

Counterpart of ``cova_tpu/data/pipeline.py`` for one host: a thread pool
builds padded pages (and decodes PNGs: PIL and libpng release the GIL), and
a bounded queue keeps a couple of batches ready. Sampling and shuffling use
numpy Generators keyed by (seed, epoch[, page index]), the same keys as the
JAX package, so both packages yield byte-identical batches for one seed.
With a decode cache (``data/decode_cache.py``) a batch's cache hits are
copied from disk and only its misses are decoded, then stored.

Multi-rank training: each data rank reads a disjoint stripe of every
epoch's page order (``shard_index``, ``shard_count``), equalized so that
every rank runs the same number of steps, and every rank can compute the
global batch's largest box count without communication
(``global_batch_max_counts``), with the JAX package's rules.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

import numpy as np

from .batching import Batch, collate
from .records import pad_page, sample_background


class DataPipeline:
    """Iterable over (page_ids, Batch) tuples for one split.

    Args:
      dataset: a ``WebDataset`` (or the in-memory synthetic one).
      batch_size: pages per batch (the last batch may be smaller).
      pad_boxes: static per-page box capacity.
      context_size: K (neighbours each side).
      shuffle: reshuffle page order each epoch (train only).
      sampling_fraction: BG subsampling (train only; eval uses 1.0).
      seed: base seed; combined with epoch and page index for all draws.
      num_threads: page-building / decode threads.
      prefetch: number of ready batches to keep ahead.
      shard_index / shard_count: this rank's stripe of each epoch's order
        (training on several data ranks).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        pad_boxes: int,
        context_size: int,
        shuffle: bool = False,
        sampling_fraction: float = 1.0,
        seed: int = 123,
        num_threads: int = 5,
        prefetch: int = 2,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.pad_boxes = pad_boxes
        self.context_size = context_size
        self.shuffle = shuffle
        self.sampling_fraction = sampling_fraction
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.shard_count = shard_count

    def _equalize(self, order: np.ndarray) -> np.ndarray:
        """Round the order up to a shard_count multiple by cycling pages
        from the front (the rule ``pad_batch`` applies to the last partial
        batch): every rank must see the same number of batches, or one
        rank's extra step waits forever on its peers' collectives."""
        if self.shard_count == 1:
            return order
        n = len(order)
        m = -(-n // self.shard_count) * self.shard_count
        if m != n:
            order = np.concatenate([order, order[: m - n]])
        return order

    def _shard_order(self, order: np.ndarray) -> np.ndarray:
        if self.shard_count == 1:
            return order
        return self._equalize(order)[self.shard_index :: self.shard_count]

    def _shuffled_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            order = rng.permutation(order)
        return order

    def _epoch_order(self, epoch: int) -> np.ndarray:
        return self._shard_order(self._shuffled_order(epoch))

    def _sampled_record(self, epoch: int, index: int):
        """The page's record after BG subsampling (keyed by (seed, epoch,
        dataset index), so every rank computes the same record)."""
        rec = self.ds.record(index)
        if self.sampling_fraction < 1.0:
            rng = np.random.default_rng((self.seed, epoch, index))
            rec = sample_background(rec, self.sampling_fraction, rng)
        return rec

    def global_batch_max_counts(self, epoch: int) -> np.ndarray:
        """The largest post-sampling box count of each GLOBAL batch of the
        epoch, computed on any rank without communication: the shuffle is
        keyed by (seed, epoch), the stripes are equalized deterministically
        and BG sampling is keyed by (seed, epoch, index). Rank h's batch b
        is ``stripe_h[b*L:(b+1)*L]`` with ``stripe_h = order_eq[h::S]``, so
        global batch b is the block ``order_eq[b*G:(b+1)*G]`` (G = L * S).
        """
        order = self._equalize(self._shuffled_order(epoch))
        counts = np.fromiter(
            (self._sampled_record(epoch, int(i)).n_boxes for i in order),
            dtype=np.int64,
            count=len(order),
        )
        g = self.batch_size * self.shard_count
        n_batches = (len(order) + g - 1) // g
        return np.asarray(
            [counts[b * g : (b + 1) * g].max() for b in range(n_batches)],
            dtype=np.int64,
        )

    def _make_page(self, epoch: int, index: int):
        return pad_page(
            self._sampled_record(epoch, index), self.pad_boxes,
            self.context_size, self.ds.n_additional_feat,
        )

    def _decode_batch(self, idxs, size: int) -> np.ndarray:
        """uint8 images of one batch through the native decoder: cache hits
        copied from disk, misses decoded in one call and then stored."""
        from . import native_loader

        s2d4 = size % 4 == 0
        paths = [self.ds.img_paths[int(i)] for i in idxs]
        cache = self.ds.decode_cache(f"{'s2d4' if s2d4 else 'raw'}-{size}")
        if cache is None:
            return native_loader.decode_png_batch(
                paths, size, size, nthreads=self.num_threads, s2d4=s2d4
            )
        ids = [self.ds.ids[int(i)] for i in idxs]
        hits = [cache.get(page_id, path) for page_id, path in zip(ids, paths)]
        miss = [pos for pos, m in enumerate(hits) if m is None]
        shape = (size // 4, size // 4, 48) if s2d4 else (size, size, 3)
        imgs = np.empty((len(idxs), *shape), dtype=np.uint8)
        if miss:
            dec = native_loader.decode_png_batch(
                [paths[p] for p in miss], size, size,
                nthreads=self.num_threads, s2d4=s2d4,
            )
            for k, pos in enumerate(miss):
                imgs[pos] = dec[k]
                cache.put(ids[pos], dec[k], paths[pos])
        for pos, m in enumerate(hits):
            if m is not None:
                imgs[pos] = m  # the memmap's only read
        return imgs

    def _make_batch(self, epoch: int, idxs, pool) -> Batch:
        # Pages build on the pool while the native decoder (when built and
        # the dataset is disk-backed) decodes the whole batch in one call.
        pages = pool.map(lambda i: self._make_page(epoch, int(i)), idxs)
        size = getattr(self.ds, "img_size", None)
        if getattr(self.ds, "use_native", False) and size is not None:
            imgs = self._decode_batch(idxs, size)
        else:
            imgs = list(pool.map(lambda i: self.ds.image(int(i)), idxs))
        return collate(imgs, list(pages))

    def epoch(self, epoch: int = 0) -> Iterator[Tuple[List[str], Batch]]:
        """Yield batches for one epoch, with background prefetch."""
        order = self._epoch_order(epoch)
        n_batches = (len(order) + self.batch_size - 1) // self.batch_size
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(self.num_threads) as pool:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    idxs = order[
                        b * self.batch_size : (b + 1) * self.batch_size
                    ]
                    try:
                        batch = self._make_batch(epoch, idxs, pool)
                    except BaseException as e:  # re-raised by the consumer
                        q.put(e)
                        return
                    q.put(([self.ds.ids[int(i)] for i in idxs], batch))
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # Drain so the producer can exit.
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)


def make_pipelines(cfg, train_ds, val_ds, test_ds, host_shard=None):
    """The three split pipelines: train shuffles and subsamples BG in
    batches of ``cfg.batch_size``; val and test are
    ``make_eval_pipeline``'s.

    ``host_shard``: optional (shard_index, shard_count) of this rank's
    stripe (``parallel.mesh.Mesh.host_shard``). With shard_count > 1 the
    TRAIN pipeline reads a disjoint stripe of each epoch's order in local
    batches of ``cfg.batch_size // shard_count``, so the global batch stays
    ``cfg.batch_size`` pages and the CE-sum gradient scale is unchanged.
    Val and test are not striped: every rank reads the whole split."""
    shard_index, shard_count = host_shard or (0, 1)
    if cfg.batch_size % shard_count != 0:
        raise ValueError(
            f"batch_size={cfg.batch_size} must be divisible by the host "
            f"count {shard_count} (each host feeds batch_size/hosts pages)"
        )
    train = DataPipeline(
        train_ds,
        batch_size=cfg.batch_size // shard_count,
        pad_boxes=cfg.pad_boxes,
        context_size=cfg.context_size,
        shuffle=True,
        sampling_fraction=cfg.sampling_fraction,
        seed=cfg.seed,
        num_threads=cfg.num_workers,
        shard_index=shard_index,
        shard_count=shard_count,
    )
    return (train, make_eval_pipeline(cfg, val_ds),
            make_eval_pipeline(cfg, test_ds))


def make_eval_pipeline(cfg, dataset) -> DataPipeline:
    """The val/test-style pipeline: ``cfg.eval_batch_size`` pages, no
    shuffle, no BG sampling."""
    return DataPipeline(
        dataset,
        batch_size=cfg.eval_batch_size,
        pad_boxes=cfg.pad_boxes,
        context_size=cfg.context_size,
        shuffle=False,
        sampling_fraction=1.0,
        seed=cfg.seed,
        num_threads=cfg.num_workers,
    )
