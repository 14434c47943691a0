"""The port's host-RSS watchdog (``cova_tpu_torch/utils/rss.py``, the
``on_rss_limit`` hook of ``train/trainer.py:fit`` and ``cli.cmd_train``'s
re-exec with ``--resume``), against the rules of the JAX package's
(``tests/test_rss_watchdog.py``): readings and the environment override,
the callback only after "last" is saved and never after the final epoch,
and a re-exec'd run that equals an uninterrupted one."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from cova_tpu.utils import rss as jax_rss
from cova_tpu_torch import cli
from cova_tpu_torch.config import Config
from cova_tpu_torch.data.synthetic import InMemoryWebDataset
from cova_tpu_torch.train import trainer
from cova_tpu_torch.utils import rss
from cova_tpu_torch.utils.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--synthetic", "12", "--img_height", "64", "-cs", "3", "-hd", "32",
         "-bbhd", "8", "--compute_dtype", "float32", "-nw", "2",
         "--device", "cpu", "-dp", "0.2"]
KEY = Config(context_size=3, hidden_dim=32, bbox_hidden_dim=8,
             drop_prob=0.2).params_key


def test_rss_readings():
    assert rss.rss_gb() > 0.01  # a live CPython is tens of MB at least
    assert rss.mem_total_gb() > rss.rss_gb()
    assert rss.mem_total_gb() == jax_rss.mem_total_gb()


@pytest.mark.parametrize("value, want", [("12.5", 12.5), ("0", None),
                                         ("-3", None), (None, "default")])
def test_limit_env_override(monkeypatch, value, want):
    """``COVA_RSS_LIMIT_GB`` sets the limit, a value <= 0 disables it, and
    unset it is 75% of MemTotal: the JAX package's rule, value for value."""
    if value is None:
        monkeypatch.delenv("COVA_RSS_LIMIT_GB", raising=False)
    else:
        monkeypatch.setenv("COVA_RSS_LIMIT_GB", value)
    got = rss.rss_limit_gb()
    assert got == jax_rss.rss_limit_gb()
    if want is None:
        assert got == float("inf") and not rss.over_limit()
    elif want == "default":
        assert got == pytest.approx(0.75 * rss.mem_total_gb())
    else:
        assert got == want


def test_over_limit_follows_the_limit(monkeypatch):
    monkeypatch.setenv("COVA_RSS_LIMIT_GB", "0.001")
    assert rss.over_limit()
    monkeypatch.setenv("COVA_RSS_LIMIT_GB", str(1000 * rss.mem_total_gb()))
    assert not rss.over_limit()


@pytest.fixture()
def tiny_fit(tmp_path):
    """``fit``'s arguments for a 3-epoch run on 8 in-memory pages."""
    cfg = Config(img_height=32, max_boxes=16, context_size=2, hidden_dim=16,
                 bbox_hidden_dim=8, batch_size=4, eval_batch_size=4,
                 compute_dtype="float32", n_epochs=3, patience=50,
                 output_dir=str(tmp_path))
    ds = InMemoryWebDataset(12, 32, seed=0, min_boxes=4, max_boxes=12)
    train_ds, val_ds, test_ds = (ds.subset(s) for s in (
        list(range(8)), [8, 9], [10, 11]))
    cfg, state, train_p, val_p, _ = cli._build(
        cfg, torch.device("cpu"), train_ds, val_ds, test_ds)
    return cfg, state, train_p, val_p, CheckpointManager(cfg.ckpt_dir())


class _Restart(Exception):
    pass


def test_watchdog_fires_after_last_is_saved(tiny_fit, monkeypatch):
    """Past the limit the callback fires at the first epoch boundary, after
    that epoch's "last" is on disk (so a re-exec'd ``--resume`` starts at
    epoch 2)."""
    cfg, state, train_p, val_p, ckpt = tiny_fit
    monkeypatch.setenv("COVA_RSS_LIMIT_GB", "0.001")
    seen = []

    def restart(epoch):
        seen.append((epoch, ckpt.exists("last")))
        raise _Restart  # a real callback execs and never returns

    with pytest.raises(_Restart):
        trainer.fit(state, cfg, train_p, val_p, ckpt, on_rss_limit=restart)
    assert seen == [(1, True)]
    assert torch.load(ckpt.path("last"), weights_only=False)[
        "extra"]["epoch"] == 1


@pytest.mark.parametrize("limit, want", [("0", []), ("0.001", [1, 2])])
def test_watchdog_never_fires_after_the_final_epoch(tiny_fit, monkeypatch,
                                                    limit, want):
    """A limit <= 0 never fires; a callback that returns lets training go
    on, and it fires at every boundary but the last (a re-exec there would
    only repeat the test report)."""
    cfg, state, train_p, val_p, ckpt = tiny_fit
    monkeypatch.setenv("COVA_RSS_LIMIT_GB", limit)
    fired = []
    _, best = trainer.fit(state, cfg, train_p, val_p, ckpt,
                          on_rss_limit=fired.append)
    assert fired == want and np.isfinite(best)


def test_restart_is_wired_only_for_one_process_train(monkeypatch):
    """``cmd_train`` gets the re-exec callback under ``train`` in one
    process; ``sweep`` (its folds run in one process) and several ranks
    get none. The callback execs ``python -m cova_tpu_torch.cli`` with the
    run's arguments plus ``--resume``, once."""
    import argparse

    from cova_tpu_torch.parallel import distributed

    calls = []
    monkeypatch.setattr(os, "execv", lambda path, argv: calls.append(argv))
    args = argparse.Namespace(command="train", argv=["train", "-e", "3"])
    cli._rss_restart(args)(1)
    assert calls == [[sys.executable, "-m", "cova_tpu_torch.cli", "train",
                      "-e", "3", "--resume"]]
    args.argv = ["train", "--resume"]
    cli._rss_restart(args)(2)
    assert calls[-1].count("--resume") == 1
    assert cli._rss_restart(argparse.Namespace(
        command="sweep", argv=["sweep"])) is None
    monkeypatch.setattr(distributed, "is_multiprocess", lambda: True)
    assert cli._rss_restart(args) is None


def _train(out, epochs, extra_env=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", COVA_RSS_LIMIT_GB="0",
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    env.update(extra_env or {})
    r = subprocess.run(
        [sys.executable, "-m", "cova_tpu_torch.cli", "train", *SMALL,
         "-e", str(epochs), "--output_dir", out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_reexec_resumes_the_exact_run(tmp_path):
    """``train -e 2`` under ``COVA_RSS_LIMIT_GB=0.001`` re-execs once
    after epoch 1 and the new process resumes at epoch 2; its epoch losses
    and test CSVs equal an uninterrupted run's exactly (dropout on: its
    stream is keyed by (seed, epoch))."""
    straight, recycled = str(tmp_path / "straight"), str(tmp_path / "rss")
    _train(straight, 2)
    text = _train(recycled, 2, {"COVA_RSS_LIMIT_GB": "0.001"})
    assert text.count("[rss-watchdog]") == 1
    assert "after epoch 1" in text
    assert text.count("Resuming from epoch 2") == 1
    assert text.count("[TEST]") == 1
    logs = {}
    for out in (straight, recycled):
        res = os.path.join(out, KEY)
        logs[out] = dict(
            losses=re.findall(r"Epoch:\s*(\d+)\s+Loss: ([\d.]+)",
                              open(os.path.join(res, "Fold-1 logs.txt"))
                              .read()),
            csvs=[open(os.path.join(res, f"Fold-1 test_acc_{k}.csv")).read()
                  for k in ("imgwise", "domainwise")])
    assert [e for e, _ in logs[straight]["losses"]] == ["1", "2"]
    assert logs[recycled]["losses"][-1] == logs[straight]["losses"][-1]
    text_losses = re.findall(r"Epoch:\s*(\d+)\s+Loss: ([\d.]+)", text)
    assert text_losses == logs[straight]["losses"]
    assert logs[recycled]["csvs"] == logs[straight]["csvs"]
