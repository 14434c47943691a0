"""The port's ``COVA_PROFILE_DIR`` hook (``train/trainer.py:fit``) on the CPU
at a small size: with the variable set, ``fit`` traces the first epoch that
it runs (also the first after ``--resume``) into one file named for rank 0,
and not the epoch's eval; unset, it builds no profiler and writes nothing;
the per-epoch losses are the same bits either way. On two ranks each rank
writes its own file."""

import glob
import json
import os
import runpy
import signal
import subprocess
import sys
from unittest import mock

import pytest
import torch

from cova_tpu_torch.cli import main as port_main
from cova_tpu_torch.config import Config
from cova_tpu_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--synthetic", "12", "--img_height", "64", "-cs", "3", "-hd", "32",
         "-bbhd", "8", "--compute_dtype", "float32", "-nw", "2",
         "--device", "cpu"]
KEY = Config(context_size=3, hidden_dim=32, bbox_hidden_dim=8).params_key


def _train(out, epochs, profile_dir=None, resume=False):
    """``cli train`` in this process. Returns, in call order, (epoch,
    "train" or "eval", whether a profiler was recording) for every train
    and eval step that ``fit`` ran."""
    seen, epoch = [], [0]
    real_gen = trainer.dropout_generator
    real_train, real_eval = trainer.train_step, trainer.eval_step

    def gen(seed, e, *a, **kw):
        epoch[0] = e
        return real_gen(seed, e, *a, **kw)

    def train_step(*a, **kw):
        seen.append((epoch[0], "train", torch.autograd._profiler_enabled()))
        return real_train(*a, **kw)

    def eval_step(*a, **kw):
        seen.append((epoch[0], "eval", torch.autograd._profiler_enabled()))
        return real_eval(*a, **kw)

    env = dict(os.environ)
    env.pop("COVA_PROFILE_DIR", None)
    if profile_dir:
        env["COVA_PROFILE_DIR"] = profile_dir
    with mock.patch.dict(os.environ, env, clear=True), \
            mock.patch.object(trainer, "dropout_generator", gen), \
            mock.patch.object(trainer, "train_step", train_step), \
            mock.patch.object(trainer, "eval_step", eval_step):
        argv = ["train", *SMALL, "-e", str(epochs), "--output_dir", out]
        assert port_main(argv + (["--resume"] if resume else [])) == 0
    return seen


def _losses(out):
    with open(os.path.join(out, KEY, "metrics.jsonl")) as f:
        return [r["loss"] for r in map(json.loads, f)
                if r["event"] == "train_epoch"]


def _traces(root):
    return sorted(glob.glob(os.path.join(root, "**", "*.pt.trace.json*"),
                            recursive=True))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("profile")
    r = {"root": str(root)}
    # On several intra-op threads two CPU runs of one fold can differ in
    # their last bits whatever the hook does (a reduction whose order
    # follows the threads); on one they are the same bits.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # Unset: no profiler object may be built at all.
        with mock.patch.object(torch.profiler, "profile",
                               side_effect=AssertionError("profiler built")):
            r["plain"] = _train(str(root / "plain"), 2)
        r["traced_dir"] = str(root / "trace")
        r["traced"] = _train(str(root / "traced"), 2, r["traced_dir"])
        r["resumed_dir"] = str(root / "trace_resume")
        _train(str(root / "resumed"), 1)
        r["resumed"] = _train(str(root / "resumed"), 2, r["resumed_dir"],
                              resume=True)
    finally:
        torch.set_num_threads(threads)
    return r


def _traced_steps(seen):
    return {(e, kind) for e, kind, on in seen if on}


def test_the_first_epoch_is_traced_into_one_rank0_file(runs):
    files = os.listdir(runs["traced_dir"])
    assert len(files) == 1, files
    assert files[0].startswith("rank0.")
    assert files[0].endswith(".pt.trace.json.gz")
    seen = runs["traced"]
    assert _traced_steps(seen) == {(1, "train")}
    assert all(on for e, kind, on in seen if (e, kind) == (1, "train"))
    # The file holds the whole epoch: as many Adam steps as it ran.
    read = runpy.run_path(os.path.join(REPO, "scripts",
                                       "read_torch_trace.py"))["read_trace"]
    summary = read(runs["traced_dir"])
    n_steps = sum(1 for e, kind, _ in seen if (e, kind) == (1, "train"))
    assert n_steps > 1 and summary["steps"] == n_steps
    assert summary["device_events"] == 0 and summary["idle_share"] == 1.0
    assert summary["host_ops_self_ms"]


def test_the_trace_names_the_feed_and_holds_the_counters(runs):
    """The device feed's wait on the pipeline's hand-off is a range of the
    trace, one a step and one for the epoch's end, and the trace holds what
    the counters added over the epoch."""
    read = runpy.run_path(os.path.join(REPO, "scripts",
                                       "read_torch_trace.py"))["read_trace"]
    summary = read(runs["traced_dir"])
    n_steps = summary["steps"]
    ranges = summary["port_ranges"]
    assert ranges["cova_tpu_torch.feed.source"]["calls"] == n_steps + 1
    assert ranges["cova_tpu_torch.train_step"]["calls"] == n_steps
    assert summary["counters"]["feed.batches"] == n_steps
    assert "feed.bytes_staged" not in summary["counters"]  # nothing staged
    # The step's range is left out of the gaps, so they name its ops.
    gaps = dict(summary["device_gaps"]["by_top_level_host_op_ms"])
    assert "cova_tpu_torch.train_step" not in gaps


def test_a_resumed_run_traces_its_first_epoch(runs):
    seen = runs["resumed"]
    assert {e for e, _, _ in seen} == {2}
    assert _traced_steps(seen) == {(2, "train")}
    assert all(on for _, kind, on in seen if kind == "train")
    files = os.listdir(runs["resumed_dir"])
    assert len(files) == 1 and files[0].startswith("rank0."), files


def test_unset_writes_no_trace(runs):
    assert not _traced_steps(runs["plain"])
    root = runs["root"]
    assert _traces(root) == sorted(
        glob.glob(os.path.join(runs["traced_dir"], "*"))
        + glob.glob(os.path.join(runs["resumed_dir"], "*")))
    assert not _traces(os.path.join(root, "plain"))


def test_losses_are_the_same_bits_with_and_without_the_hook(runs):
    root = runs["root"]
    plain = _losses(os.path.join(root, "plain"))
    assert len(plain) == 2
    assert _losses(os.path.join(root, "traced")) == plain
    assert _losses(os.path.join(root, "resumed")) == plain


def test_each_rank_writes_its_own_trace(tmp_path):
    """``--num_devices 2`` (two gloo ranks on the CPU): one trace a rank,
    named for it."""
    trace = str(tmp_path / "trace")
    env = dict(os.environ, COVA_PROFILE_DIR=trace,
               COVA_DIST_INIT_TIMEOUT="60",
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    argv = [sys.executable, "-m", "cova_tpu_torch.cli", "train",
            "--synthetic", "20", "-bs", "4", "-dp", "0", *SMALL[2:],
            "-e", "1", "--num_devices", "2",
            "--output_dir", str(tmp_path / "out")]
    p = subprocess.Popen(argv, env=env, cwd=REPO, text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         start_new_session=True)
    try:
        out = p.communicate(timeout=240)[0]
    finally:
        if p.poll() is None:  # a hung launch: stop its ranks too
            os.killpg(p.pid, signal.SIGKILL)
    assert p.returncode == 0, out[-4000:]
    files = sorted(os.listdir(trace))
    assert [f.split(".")[0] for f in files] == ["rank0", "rank1"], files
