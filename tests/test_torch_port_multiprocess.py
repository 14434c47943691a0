"""The port's CLI on several ranks (gloo on ``--device cpu``), end to end.

Mirrors ``tests/test_multiprocess.py`` and ``tests/test_cli_mesh.py`` of
the JAX package: ``train --num_devices 2`` (the CLI starts the ranks) and a
two-process launch through ``COVA_COORDINATOR_ADDRESS`` /
``COVA_NUM_PROCESSES`` / ``COVA_PROCESS_ID`` against the one-process run;
``--model_parallel 2`` through resume, the best restore and the test
report; ``eval`` on four data ranks against one process.

20 synthetic pages give 12 train pages: divisible by -bs 4 and by 2 ranks
x 2 pages, so no partial batch or stripe padding anywhere, and with -dp 0
every quantity of a step (CE sum, BN statistics, gradient sums) is
invariant to the within-batch order the stripes introduce: the runs differ
by float reduction order only (Adam amplifies it over the epochs, hence
the looser second-epoch tolerance, as in the JAX package's tests).

Every launch runs in its own session under a time limit, with
``COVA_DIST_INIT_TIMEOUT`` set, and the whole session is killed when the
limit passes, so a hung rendezvous fails in seconds.
"""

import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

from cova_tpu_torch.cli import main
from cova_tpu_torch.parallel.launch import free_port, rank_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # seconds for one launch, every rank included
INIT_TIMEOUT = "60"

FLAGS = ["--synthetic", "20", "--img_height", "64", "-bs", "4", "-cs", "3",
         "-hd", "32", "-bbhd", "8", "-dp", "0", "--compute_dtype",
         "float32", "-nw", "2", "--device", "cpu"]
ARGS = ["train", *FLAGS, "-e", "2"]


def _env():
    env = dict(os.environ)
    env["COVA_DIST_INIT_TIMEOUT"] = INIT_TIMEOUT
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    for v in ("COVA_COORDINATOR_ADDRESS", "COVA_NUM_PROCESSES",
              "COVA_PROCESS_ID"):
        env.pop(v, None)
    return env


def _run_all(cmds, envs, cwd=REPO):
    """Start every command in its own session, wait for all under TIMEOUT;
    kill every session (ranks a command started included) if one outlasts
    it. Returns [(returncode, output)]."""
    procs = [subprocess.Popen(cmd, env=env, cwd=cwd, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT,
                              start_new_session=True)
             for cmd, env in zip(cmds, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _cli(args, cwd=REPO):
    """``python -m cova_tpu_torch.cli *args`` (which may start ranks)."""
    [(rc, out)] = _run_all(
        [[sys.executable, "-m", "cova_tpu_torch.cli", *args]], [_env()],
        cwd)
    assert rc == 0, out
    return out


def _results(out):
    subdirs = [d for d in os.listdir(out) if d.startswith("lr-")]
    assert len(subdirs) == 1, subdirs
    return os.path.join(out, subdirs[0])


def _epoch_losses(out):
    log = open(os.path.join(_results(out), "Fold-1 logs.txt")).read()
    return ([float(m) for m in
             re.findall(r"Epoch:\s*\d+\s+Loss: ([\d.]+)", log)], log)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The one-process run of the same flags (in this process)."""
    out = str(tmp_path_factory.mktemp("mp_single"))
    assert main(ARGS + ["--output_dir", out]) == 0
    return out, _epoch_losses(out)[0]


def _assert_losses_match(losses, single_losses):
    assert len(losses) == 2
    np.testing.assert_allclose(losses[0], single_losses[0], rtol=5e-3)
    np.testing.assert_allclose(losses[1], single_losses[1], rtol=5e-2)


def _assert_artifacts(out):
    res = _results(out)
    fold_csv = os.path.join(res, "fold_wise_acc.csv")
    assert len(open(fold_csv).read().strip().splitlines()) == 2
    for name in ("Fold-1 test_acc_imgwise.csv",
                 "Fold-1 test_acc_domainwise.csv", "metrics.jsonl",
                 "Fold-1 saved_model.pt/best.pt",
                 "Fold-1 saved_model.pt/last.pt"):
        assert os.path.isfile(os.path.join(res, name)), name


def test_num_devices_train_matches_single(tmp_path, single):
    """``--num_devices 2`` starts two gloo ranks; the epoch losses equal
    the one-process run's (rtol 5e-3, then 5e-2) and the artifacts are
    written once."""
    out = str(tmp_path / "nd2")
    _cli(ARGS + ["--output_dir", out, "--num_devices", "2"])
    losses, log = _epoch_losses(out)
    assert "Mesh: {'data': 2, 'model': 1} backend: gloo" in log
    assert log.count("Epoch:") == 2  # rank 1 wrote no line of its own
    _assert_losses_match(losses, single[1])
    _assert_artifacts(out)


def test_env_launch_matches_single(tmp_path, single):
    """Two processes launched through the COVA_* environment (the JAX
    package's contract): rank 0 prints the epochs and logs the launch,
    rank 1 prints no ``Epoch:``; the losses equal the one-process run's."""
    out = str(tmp_path / "env2")
    port = free_port()
    cmd = [sys.executable, "-m", "cova_tpu_torch.cli", *ARGS,
           "--output_dir", out]
    results = _run_all([cmd, cmd],
                       [rank_env(r, 2, port, _env()) for r in range(2)])
    for r, (rc, text) in enumerate(results):
        assert rc == 0, f"rank {r}:\n{text}"
    (_, out0), (_, out1) = results
    assert "Epoch:" in out0 and "Epoch:" not in out1
    assert "Multi-host launch (2 processes)" in out0
    assert "Mesh: {'data': 2, 'model': 1}" in out0
    losses, _ = _epoch_losses(out)
    _assert_losses_match(losses, single[1])
    _assert_artifacts(out)


def test_model_parallel_resume_restore_and_test(tmp_path):
    """dp = 2 x tp = 2 (tests/test_multiprocess.py:228-254): one epoch,
    then ``--resume`` for a second; the run restores its best checkpoint
    (a whole state on disk, re-sliced on every rank), writes the test
    report, and the checkpoint strict-loads into a one-process ``eval``."""
    out = str(tmp_path / "tp")
    flags = ["--output_dir", out, "--num_devices", "4",
             "--model_parallel", "2"]
    first = _cli(["train", *FLAGS, "-e", "1", *flags])
    assert "Mesh: {'data': 2, 'model': 2}" in first
    text = _cli(["train", *FLAGS, "-e", "2", "--resume", *flags])
    assert "Resuming from epoch 2" in text
    assert "Restoring model to best Eval performance checkpoint" in text
    assert "[TEST] Avg_class_Accuracy:" in text
    losses, _ = _epoch_losses(out)
    assert len(losses) == 1 and np.isfinite(losses).all()  # log rewritten
    cwd = tmp_path / "eval1"
    cwd.mkdir()
    _cli(["eval", *FLAGS, "--output_dir", out], cwd=str(cwd))
    assert (cwd / "Fold-1 test_acc_imgwise.csv").is_file()


def test_eval_on_four_data_ranks_matches_single(tmp_path, single):
    """``eval`` at eval bs 10 on dp = 4: each batch pads to 12 pages (3 a
    rank), and the reports equal the one-process eval's byte for byte
    (60 pages: a 12-page test split, batches of 10 and 2; the classwise
    log differs only in its timings)."""
    out, _ = single
    flags = [*FLAGS, "--synthetic", "60", "--output_dir", out]
    one, four = tmp_path / "one", tmp_path / "four"
    one.mkdir()
    four.mkdir()
    _cli(["eval", *flags], cwd=str(one))
    text = _cli(["eval", *flags, "--num_devices", "4"], cwd=str(four))
    assert "Mesh: {'data': 4, 'model': 1}" in text
    for name in ("Fold-1 test_acc_imgwise.csv",
                 "Fold-1 test_acc_domainwise.csv"):
        got = (four / name).read_bytes()
        assert got == (one / name).read_bytes(), name
    rows = (one / "Fold-1 test_acc_imgwise.csv").read_text().splitlines()
    assert len(rows) == 1 + 12


def test_num_devices_checks_before_starting_ranks(tmp_path):
    """The mesh's checks run in the launching process, before any rank
    starts: the batch must divide over the data axis."""
    with pytest.raises(ValueError, match="divisible by the data"):
        main(["train", *FLAGS, "-bs", "5", "--num_devices", "2",
              "--output_dir", str(tmp_path)])
