"""Settings of the benchmark's tests: the ``cuda`` marker of the tests that
need the card (they decide inside the test, and skip elsewhere), and the
tiny cells that the CPU tests run."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips elsewhere)")


TINY_CONFIG = dict(img_height=64, hidden_dim=16, bbox_hidden_dim=8,
                   context_size=3, max_boxes=24, box_buckets=[8, 16])
TINY_COUNTS = {"min": 4, "mean": 12, "std": 5, "max": 24}


def tiny_cell(workload: str, **config):
    """(cell, config, traffic, limits, metrics) of ``workload`` cut to a
    size the CPU runs in a second: 64² pages, 3 batches in the pool."""
    from benchmark import manifest

    bench = manifest.Benchmark(ROOT)
    cell = bench.cell(workload)
    cfg = dict(bench.config(cell["config"]))
    cfg.update(TINY_CONFIG)
    cfg.update(config)
    tr = dict(bench.traffic(cell["traffic"]))
    tr.update(pool_pages=3 * tr["batch_size"], box_counts=TINY_COUNTS)
    return cell, cfg, tr, bench.limits(workload), bench.metrics()


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)
