"""The port's multi-rank layer against single-process math and the JAX
package's mesh, on the CPU.

Ranks are gloo processes on ``--device cpu``: this file run as a script
(``python tests/test_torch_port_parallel.py OUT``) is one rank of a launch
through the ``COVA_*`` environment, and the tests start them with a free
port, ``COVA_DIST_INIT_TIMEOUT`` and a time limit on every process, so a
hung rendezvous fails in seconds. Held here:

  * the collectives (``parallel/collectives.py``) in f64: forward, and the
    gradient against one process on the concatenated input;
  * masked BatchNorm with a data group, 2 ranks: y, mean, var and the
    running statistics against the JAX ``MaskedBatchNorm`` on the
    concatenated batch, the gradients of x, weight and bias against one
    process (masked, unmasked, group-fold, one rank all padding, every
    rank all padding);
  * one train step at dp = 2 x tp = 2 (4 ranks) and dp = 2 (2 ranks)
    against the JAX package's step on ``make_mesh(2, 2)`` and
    ``make_mesh(2, 1)`` from the same weights (``state_dict_from_jax``),
    drop_prob 0;
  * a checkpoint saved under tp = 2: the gathered state, tensor for tensor;
  * the pipeline's stripes and global bucket counts, ``mesh_from_config``'s
    checks and ``distributed.initialize``'s contract against the JAX
    package's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a rank: the repo root is not on the path
    sys.path.insert(0, REPO)

from cova_tpu_torch.config import Config  # noqa: E402
from cova_tpu_torch.data.batching import Batch  # noqa: E402
from cova_tpu_torch.models.cova import build_model  # noqa: E402
from cova_tpu_torch.models.layers import MaskedBatchNorm  # noqa: E402
from cova_tpu_torch.parallel import collectives, distributed  # noqa: E402
from cova_tpu_torch.parallel.launch import free_port, rank_env  # noqa: E402
from cova_tpu_torch.parallel.mesh import (  # noqa: E402
    full_state_dict,
    gather_optimizer_state,
    make_mesh,
    mesh_from_config,
)
from cova_tpu_torch.train.steps import (  # noqa: E402
    create_train_state,
    reduce_gradients,
    train_step,
)
from cova_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402

# Seconds: the rendezvous and collectives of a rank, and a whole launch.
INIT_TIMEOUT = 60
LAUNCH_TIMEOUT = 150

# The step cases' model: small, f32 (as tests/test_sharding.py's).
STEP = dict(img_height=32, max_boxes=16, context_size=2, hidden_dim=16,
            bbox_hidden_dim=8, batch_size=8, compute_dtype="float32",
            drop_prob=0.0)


def run_ranks(n, args, timeout=LAUNCH_TIMEOUT, extra_env=None):
    """``python *args`` as the n ranks of one launch; returns their
    outputs, and fails (after stopping every rank) if one fails or the
    launch outlasts ``timeout`` seconds."""
    port = free_port()
    procs = []
    for r in range(n):
        env = rank_env(r, n, port)
        env["COVA_DIST_INIT_TIMEOUT"] = str(INIT_TIMEOUT)
        env.update(extra_env or {})
        procs.append(subprocess.Popen(
            [sys.executable, *args], env=env, cwd=REPO, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return outs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One launch of two ranks of this file: the collectives, every masked
    BN case and the tp = 2 checkpoint, each into its own directory."""
    out = tmp_path_factory.mktemp("two_ranks")
    run_ranks(2, [os.path.abspath(__file__), str(out)])
    return out


# ------------------------------------------------------------ collectives


def _collective_inputs(n):
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(n, 3, 4))
    ws = rng.normal(size=(n, 3, 4))
    wg = rng.normal(size=(3, 4 * n))
    return xs, ws, wg


def _collectives_rank(out):
    r, n = distributed.rank(), distributed.world_size()
    g = make_mesh(n, 1).data_group
    xs, ws, wg = _collective_inputs(n)
    x = torch.tensor(xs[r], requires_grad=True)
    y = collectives.all_reduce_sum(x, g)
    (y * torch.tensor(ws[r])).sum().backward()
    xg = torch.tensor(xs[r], requires_grad=True)
    yg = collectives.gather_last(xg, g)
    (yg * torch.tensor(wg)).sum().backward()
    xc = torch.tensor(xs[0], requires_grad=True)  # the same on every rank
    (collectives.copy_to_group(xc, g) * torch.tensor(ws[r])).sum().backward()
    np.savez(os.path.join(out, f"rank{r}.npz"), y=y.detach().numpy(),
             x_grad=x.grad.numpy(), yg=yg.detach().numpy(),
             xg_grad=xg.grad.numpy(), xc_grad=xc.grad.numpy())


def test_collectives_match_single_process(two_ranks):
    """Each Function's forward, and its gradient against one process that
    holds the concatenated input (f64). all_reduce_sum: every rank's loss
    reads the sum, so x_r's gradient sums every rank's; gather_last: the
    objective downstream is replicated (counted once), so x_r's gradient is
    its slice of the whole's; copy_to_group: each rank holds a share of the
    input's gradient."""
    n = 2
    xs, ws, wg = _collective_inputs(n)
    X = torch.tensor(xs, requires_grad=True)
    Y = X.sum(0)
    sum((Y * torch.tensor(ws[r])).sum() for r in range(n)).backward()
    Xg = torch.tensor(xs, requires_grad=True)
    Yg = torch.cat(list(Xg), dim=-1)
    (Yg * torch.tensor(wg)).sum().backward()
    Xc = torch.tensor(xs[0], requires_grad=True)
    sum((Xc * torch.tensor(ws[r])).sum() for r in range(n)).backward()
    for r in range(n):
        got = np.load(two_ranks / "collectives" / f"rank{r}.npz")
        np.testing.assert_allclose(got["y"], Y.detach().numpy(), rtol=1e-12)
        np.testing.assert_allclose(got["x_grad"], X.grad[r].numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(got["yg"], Yg.detach().numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(got["xg_grad"], Xg.grad[r].numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(got["xc_grad"], Xc.grad.numpy(),
                                   rtol=1e-12)


def test_collectives_are_identity_without_group():
    x = torch.randn(3, 4, requires_grad=True)
    for fn in (collectives.all_reduce_sum, collectives.copy_to_group,
               collectives.gather_last):
        assert fn(x, None) is x


# ------------------------------------------------------------- masked BN

BN_F = 6
BN_CASES = ("masked", "unmasked", "fold4", "pad_rank", "pad_all")


def _bn_case(case, n):
    """(x, mask or None, upstream gradient, params, stats, group fold) of
    the global batch: n ranks x 2 rows."""
    rng = np.random.default_rng(21)
    f = BN_F
    params = {"scale": rng.uniform(0.5, 1.5, f).astype(np.float32),
              "bias": rng.normal(size=f).astype(np.float32)}
    stats = {"mean": rng.normal(size=f).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, f).astype(np.float32)}
    g = 4 if case == "fold4" else 1
    shape = (2 * n, 5, 3, g * f) if case == "fold4" else (2 * n, 7, f)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    w = rng.normal(size=shape).astype(np.float32)
    mask = None
    if case in ("masked", "pad_rank", "pad_all"):
        mask = rng.random(shape[:2]) < 0.6
        mask[:, 0] = True
        if case == "pad_rank":
            mask[2:4] = False  # rank 1's rows
        if case == "pad_all":
            mask[:] = False
    return x, mask, w, params, stats, g


def _port_bn(params, stats):
    bn = MaskedBatchNorm(BN_F)
    bn.load_state_dict({
        "weight": torch.tensor(params["scale"]),
        "bias": torch.tensor(params["bias"]),
        "running_mean": torch.tensor(stats["mean"]),
        "running_var": torch.tensor(stats["var"]),
        "num_batches_tracked": torch.tensor(0),
    })
    return bn.train()


def _bn_rank(case, out):
    r, n = distributed.rank(), distributed.world_size()
    x, mask, w, params, stats, g = _bn_case(case, n)
    rows = slice(2 * r, 2 * r + 2)
    bn = _port_bn(params, stats)
    mesh = make_mesh(n, 1)
    bn.group = mesh.data_group
    xr = torch.tensor(x[rows], requires_grad=True)
    mr = None if mask is None else torch.tensor(mask[rows])
    y = bn(xr, mr)
    mean, var, _, _ = bn._batch_stats(xr.detach(), mr, g)
    (y * torch.tensor(w[rows])).sum().backward()
    reduce_gradients(bn, mesh)
    np.savez(os.path.join(out, f"rank{r}.npz"), y=y.detach().numpy(),
             mean=mean.numpy(), var=var.numpy(),
             running_mean=bn.running_mean.numpy(),
             running_var=bn.running_var.numpy(), x_grad=xr.grad.numpy(),
             w_grad=bn.weight.grad.numpy(), b_grad=bn.bias.grad.numpy())


@pytest.mark.parametrize("case", BN_CASES)
def test_global_masked_bn_matches_concatenated_batch(two_ranks, case):
    """Two ranks, each with half the batch, against the JAX module on the
    whole batch: y, the batch mean and variance (read back from the JAX
    module's effective coefficients) and the running statistics within
    1e-5 relative; the gradients of x, weight and bias against one torch
    process on the whole batch within 1e-5 relative (f32)."""
    import jax.numpy as jnp

    from cova_tpu.models.layers import MaskedBatchNorm as JaxBN

    n = 2
    x, mask, w, params, stats, g = _bn_case(case, n)
    mod = JaxBN(features=BN_F, group_fold=g)
    jm = None if mask is None else jnp.asarray(mask)
    variables = {"params": params, "batch_stats": stats}
    y_j, new = mod.apply(variables, jnp.asarray(x), jm,
                         use_running_average=False, mutable=["batch_stats"])
    (sc, sh), _ = mod.apply(variables, jnp.asarray(x), jm,
                            use_running_average=False,
                            return_coefficients=True, mutable=["batch_stats"])
    sc, sh = np.asarray(sc, np.float64), np.asarray(sh, np.float64)
    mean_j = (params["bias"] - sh) / sc
    var_j = (params["scale"] / sc) ** 2 - 1e-5

    one = _port_bn(params, stats)
    X = torch.tensor(x, requires_grad=True)
    (one(X, None if mask is None else torch.tensor(mask))
     * torch.tensor(w)).sum().backward()

    tol = dict(rtol=1e-5, atol=1e-5)
    for r in range(n):
        got = np.load(two_ranks / f"bn_{case}" / f"rank{r}.npz")
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(got["y"], np.asarray(y_j)[rows], **tol)
        np.testing.assert_allclose(got["mean"], mean_j, **tol)
        np.testing.assert_allclose(got["var"], var_j, **tol)
        np.testing.assert_allclose(got["running_mean"],
                                   np.asarray(new["batch_stats"]["mean"]),
                                   **tol)
        np.testing.assert_allclose(got["running_var"],
                                   np.asarray(new["batch_stats"]["var"]),
                                   **tol)
        for key, want in (("x_grad", X.grad[rows]),
                          ("w_grad", one.weight.grad),
                          ("b_grad", one.bias.grad)):
            want = want.numpy()
            np.testing.assert_allclose(
                got[key], want, rtol=1e-5,
                atol=1e-5 * float(np.abs(want).max()) + 1e-6, err_msg=key)
    if case == "pad_all":  # no statistics anywhere: no running update
        np.testing.assert_array_equal(got["running_mean"], stats["mean"])


# ------------------------------------------------- one step against JAX


def _step_batch(cfg, b, seed):
    """A random padded batch of ``b`` RGB pages (tests/test_sharding.py's
    recipe)."""
    rng = np.random.default_rng(seed)
    P, K = cfg.pad_boxes, cfg.n_context
    imgs = rng.integers(0, 255, (b, cfg.img_height, cfg.img_height, 3),
                        dtype=np.uint8)
    boxes = rng.uniform(1, 20, (b, P, 4)).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2]
    mask = np.zeros((b, P), bool)
    mask[:, :10] = True
    mask[-1, 6:] = False
    labels = np.zeros((b, P), np.int32)
    labels[:, :3] = [1, 2, 3]
    ctx = np.full((b, P, K), -1, np.int32)
    ctx[:, :10, :4] = rng.integers(0, 6, (b, 10, 4))
    return Batch(images=imgs, boxes=boxes, labels=labels, box_mask=mask,
                 context_indices=ctx,
                 additional_feats=np.zeros((b, P, 0), np.float32))


def _jax_mesh_step(n_data, n_model, batch):
    """The JAX package's step on make_mesh(n_data, n_model): the initial
    weights, the loss sum, the gradients before the update and the state
    after it."""
    import jax

    from cova_tpu.config import Config as JaxConfig
    from cova_tpu.models.cova import build_model as jax_build_model
    from cova_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from cova_tpu.parallel.mesh import shard_batch, state_shardings
    from cova_tpu.train import steps as jax_steps

    jcfg = JaxConfig(**STEP)
    state = jax_steps.create_train_state(
        jax_build_model(jcfg), jcfg, batch, jax.random.PRNGKey(0))
    init = jax.device_get((state.params, state.batch_stats))
    mesh = jax_make_mesh(n_data=n_data, n_model=n_model)
    state = jax.device_put(state, state_shardings(state, mesh))
    sharded = shard_batch(batch, mesh)

    def loss_fn(params, b):
        out, _ = jax_steps._apply(state, params, b, train=True,
                                  rng=jax.random.PRNGKey(1))
        return jax_steps.masked_ce_sum(out.logits, b.labels, b.box_mask)

    with mesh:
        grads = jax.device_get(jax.jit(jax.grad(loss_fn))(state.params,
                                                          sharded))
        new, m = jax_steps.train_step(state, sharded, jax.random.PRNGKey(1))
    return dict(init=init, grads=grads, loss=float(m["loss_sum"]),
                new=jax.device_get((new.params, new.batch_stats)))


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """Both layouts' JAX steps, then the port's launches of 4 and 2 ranks
    (started together) from the same weights and batch."""
    from cova_tpu_torch.parallel.step_check import save_batch
    from cova_tpu_torch.utils.weights import state_dict_from_jax

    cfg = Config(**STEP)
    batch = _step_batch(cfg, STEP["batch_size"], seed=3)
    runs = {}
    for layout in ((2, 2), (2, 1)):
        jax_run = _jax_mesh_step(*layout, batch)
        root = tmp_path_factory.mktemp(f"step{layout[0]}x{layout[1]}")
        torch.save(state_dict_from_jax(*jax_run["init"], cfg),
                   root / "weights.pt")
        save_batch(str(root / "batch.npz"), batch)
        (root / "spec.json").write_text(json.dumps(dict(
            config=STEP, layouts=[list(layout)], device="cpu", seed=0)))
        runs[layout] = dict(jax=jax_run, root=root)
    port = free_port(), free_port()
    procs = []
    for (layout, run), p in zip(runs.items(), port):
        n = layout[0] * layout[1]
        for r in range(n):
            env = rank_env(r, n, p)
            env["COVA_DIST_INIT_TIMEOUT"] = str(INIT_TIMEOUT)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "cova_tpu_torch.parallel.step_check",
                 str(run["root"])], env=env, cwd=REPO, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=LAUNCH_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    for layout, run in runs.items():
        tag = f"{layout[0]}x{layout[1]}.float32"
        run["port"] = torch.load(run["root"] / f"{tag}.pt",
                                 weights_only=True)
        run["cfg"] = cfg
    return runs


@pytest.mark.parametrize("layout", [(2, 2), (2, 1)],
                         ids=["dp2xtp2", "dp2"])
def test_mesh_step_matches_jax_mesh(step_runs, layout):
    """One step at drop_prob 0: the port's ranks against the JAX package's
    mesh step. The loss sum within rtol 1e-5; every gradient before the
    update within 1e-4 of its tensor's largest (plus 1e-6 for gradients
    that are zero but for rounding, as a Linear bias before a BN); every
    parameter and BN statistic after the update within rtol 1e-3 and the
    Adam bound 2 lr 0.1 / sqrt(1e-3) of tests/test_sharding.py (a
    near-zero gradient whose sign rounds differently moves by up to lr
    b1 / sqrt(b2); a missing gradient sum would move most elements by a
    whole step)."""
    from cova_tpu_torch.utils.weights import state_dict_from_jax

    run = step_runs[layout]
    cfg, jr, port = run["cfg"], run["jax"], run["port"]
    np.testing.assert_allclose(port["loss_sum"], jr["loss"], rtol=1e-5)
    want_g = state_dict_from_jax(jr["grads"], jr["init"][1], cfg)
    assert set(port["grads"]) <= set(want_g) and len(port["grads"]) > 20
    for k, g in port["grads"].items():
        w = want_g[k].numpy()
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=1e-4 * float(np.abs(w).max()) + 1e-6,
            err_msg=k)
    want = state_dict_from_jax(*jr["new"], cfg)
    assert set(port["state"]) == set(want)
    bound = 2 * cfg.learning_rate * 0.1 / np.sqrt(1e-3)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(port["state"][k]) == 1
            continue
        np.testing.assert_allclose(port["state"][k].numpy(), w.numpy(),
                                   rtol=1e-3, atol=bound, err_msg=k)


# ------------------------------------------------------------- checkpoint


def _ckpt_rank(out):
    cfg = Config(**{**STEP, "batch_size": 2})
    mesh = make_mesh(1, distributed.world_size())
    state = create_train_state(build_model(cfg, "cpu"), cfg, mesh)
    train_step(state, _step_batch(cfg, 2, seed=5))
    ckpt = CheckpointManager(out)
    ckpt.save("tp", state, {"epoch": 1})
    model_sd = full_state_dict(state.model, mesh)
    opt_sd = gather_optimizer_state(state.optimizer.state_dict(),
                                    state.model, mesh)
    if distributed.is_primary():
        torch.save({"model": model_sd, "optimizer": opt_sd},
                   os.path.join(out, "gathered.pt"))
    again = create_train_state(build_model(cfg, "cpu"), cfg, mesh)
    ckpt.restore("tp", again)
    mine = state.model.state_dict()
    same = [k for k, v in mine.items()
            if not torch.equal(v, again.model.state_dict()[k])]
    (open(os.path.join(out, f"rank{distributed.rank()}.json"), "w")
     .write(json.dumps({"restored_differ": same,
                        "W_i_rows": int(mine["gat.W_i.weight"].shape[0])})))


def test_tp_checkpoint_is_the_gathered_state(two_ranks):
    """A checkpoint written under tp = 2 holds the gathered state tensor
    for tensor (parameters, BN statistics, Adam moments), strict-loads
    into a one-process model, and restores each rank's own slices."""
    from cova_tpu_torch.utils.checkpoint import load_checkpoint

    tmp_path = two_ranks / "ckpt"
    saved = load_checkpoint(str(tmp_path / "tp.pt"))
    gathered = torch.load(tmp_path / "gathered.pt", weights_only=True)
    assert set(saved["model"]) == set(gathered["model"])
    for k, v in gathered["model"].items():
        assert torch.equal(saved["model"][k], v), k
    for idx, st in gathered["optimizer"]["state"].items():
        for key, v in st.items():
            assert torch.equal(saved["optimizer"]["state"][idx][key], v)
    cfg = Config(**{**STEP, "batch_size": 2})
    one = build_model(cfg, "cpu")
    one.load_state_dict(saved["model"], strict=True)
    assert one.gat.W_i.weight.shape[0] == cfg.hidden_dim
    for r in range(2):
        info = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert info == {"restored_differ": [],
                        "W_i_rows": cfg.hidden_dim // 2}


# ------------------------------------------------- pipeline, config, init


@pytest.mark.parametrize("n_pages", [7, 12])
@pytest.mark.parametrize("count", [2, 3])
def test_stripes_and_global_bucket_counts_match_jax(n_pages, count):
    """Each rank's stripe, the equalized order and the global batches'
    largest box counts equal the JAX package's for 2 and 3 shards, with a
    page count that does not divide (tests/test_multiprocess.py:149)."""
    from cova_tpu.data.pipeline import DataPipeline as JaxPipeline
    from cova_tpu.data.synthetic import InMemoryWebDataset as JaxDataset
    from cova_tpu_torch.data.pipeline import DataPipeline
    from cova_tpu_torch.data.synthetic import InMemoryWebDataset

    kw = dict(batch_size=2, pad_boxes=24, context_size=3, shuffle=True,
              sampling_fraction=0.9, seed=5, num_threads=1)
    port_ds = InMemoryWebDataset(n_pages, 64, seed=0, max_boxes=24)
    jax_ds = JaxDataset(n_pages, 64, seed=0, max_boxes=24)
    seen = set()
    for idx in range(count):
        p = DataPipeline(port_ds, **kw, shard_index=idx, shard_count=count)
        j = JaxPipeline(jax_ds, **kw, shard_index=idx, shard_count=count)
        for epoch in (1, 2):
            np.testing.assert_array_equal(p._epoch_order(epoch),
                                          j._epoch_order(epoch))
            np.testing.assert_array_equal(p.global_batch_max_counts(epoch),
                                          j.global_batch_max_counts(epoch))
        stripe = p._epoch_order(1)
        assert len(stripe) == -(-n_pages // count)
        seen |= set(stripe.tolist())
        ids = [i for batch_ids, _ in p.epoch(1) for i in batch_ids]
        jids = [i for batch_ids, _ in j.epoch(1) for i in batch_ids]
        assert ids == jids
    assert seen == set(range(n_pages))


def test_make_pipelines_stripes_the_train_split_only():
    from cova_tpu_torch.data.pipeline import make_pipelines
    from cova_tpu_torch.data.synthetic import InMemoryWebDataset

    ds = InMemoryWebDataset(6, 64, seed=0, max_boxes=24)
    cfg = Config(img_height=64, max_boxes=24, batch_size=4)
    train, val, test = make_pipelines(cfg, ds, ds, ds, host_shard=(1, 2))
    assert (train.batch_size, train.shard_index, train.shard_count) == (
        2, 1, 2)
    assert val.shard_count == test.shard_count == 1
    with pytest.raises(ValueError, match="divisible by the host"):
        make_pipelines(cfg.replace(batch_size=5), ds, ds, ds,
                       host_shard=(0, 2))


def test_mesh_from_config_validation_matches_jax():
    """The JAX package's checks and messages (tests/test_cli_mesh.py:63),
    with 8 visible devices on both sides."""
    from cova_tpu.config import Config as JaxConfig
    from cova_tpu.parallel.mesh import mesh_from_config as jax_mesh

    assert mesh_from_config(Config(num_devices=1), n_visible=8) is None
    mesh = mesh_from_config(Config(num_devices=8, batch_size=8), n_visible=8)
    assert mesh.shape == {"data": 8, "model": 1}
    mesh = mesh_from_config(Config(num_devices=0, model_parallel=2,
                                   batch_size=4), n_visible=8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.data_group is None and mesh.model_group is None
    for kw in (dict(num_devices=8, batch_size=5),
               dict(num_devices=8, model_parallel=3),
               dict(num_devices=16, batch_size=16)):
        with pytest.raises(ValueError) as jerr:
            jax_mesh(JaxConfig(**kw))
        with pytest.raises(ValueError) as perr:
            mesh_from_config(Config(**kw), n_visible=8)
        assert str(perr.value) == str(jerr.value)


def test_mesh_rank_layout():
    """rank = d * n_model + m, as create_device_mesh orders the grid; the
    ranks of one data row read the same stripe."""
    from cova_tpu_torch.parallel.mesh import Mesh

    coords = [(Mesh(2, 2, rank=r).data_index, Mesh(2, 2, rank=r).model_index)
              for r in range(4)]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert Mesh(2, 2, rank=1).host_shard == (0, 2)
    assert Mesh(2, 2, rank=2).host_shard == (1, 2)


@pytest.fixture
def fake_dist(monkeypatch):
    """``torch.distributed`` with its group creation recorded, not run."""
    calls = []
    state = {"up": False}
    monkeypatch.setattr(distributed.dist, "is_initialized",
                        lambda: state["up"])

    def init(backend, **kw):
        calls.append(dict(backend=backend, **kw))
        state["up"] = True

    monkeypatch.setattr(distributed.dist, "init_process_group", init)
    for v in ("COVA_COORDINATOR_ADDRESS", "COVA_NUM_PROCESSES",
              "COVA_PROCESS_ID", "COVA_DIST_INIT_TIMEOUT", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    return calls


def test_initialize_env_contract(fake_dist, monkeypatch):
    """The COVA_* triple (tests/test_distributed.py) reaches the process
    group as its address, world size and rank; COVA_DIST_INIT_TIMEOUT as
    its timeout; --device cpu picks gloo."""
    import datetime

    monkeypatch.setenv("COVA_COORDINATOR_ADDRESS", "host0:1234")
    monkeypatch.setenv("COVA_NUM_PROCESSES", "2")
    monkeypatch.setenv("COVA_PROCESS_ID", "1")
    monkeypatch.setenv("COVA_DIST_INIT_TIMEOUT", "42")
    distributed.initialize("cpu")
    assert fake_dist == [dict(
        backend="gloo", init_method="tcp://host0:1234", world_size=2,
        rank=1, timeout=datetime.timedelta(seconds=42))]


def test_initialize_explicit_arguments(fake_dist):
    distributed.initialize("cpu", coordinator_address="host0:99",
                           num_processes=4, process_id=3)
    assert fake_dist == [dict(backend="gloo", init_method="tcp://host0:99",
                              world_size=4, rank=3)]


def test_initialize_single_process_is_noop(fake_dist):
    distributed.initialize("cpu")
    distributed.initialize("cuda")
    assert fake_dist == []


def test_initialize_idempotent(fake_dist):
    distributed.initialize("cpu", "host0:1", num_processes=2, process_id=0)
    distributed.initialize("cpu", "host0:1", num_processes=2, process_id=0)
    assert len(fake_dist) == 1


def test_initialize_refuses_an_incomplete_launch(fake_dist, monkeypatch):
    monkeypatch.setenv("COVA_COORDINATOR_ADDRESS", "host0:1234")
    with pytest.raises(ValueError, match="COVA_NUM_PROCESSES"):
        distributed.initialize("cpu")
    monkeypatch.setenv("COVA_NUM_PROCESSES", "2")
    monkeypatch.setenv("COVA_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="outside a world of 2"):
        distributed.initialize("cpu")
    assert fake_dist == []


def test_backend_choice():
    """gloo on the CPU and where ranks share a card; NCCL where each rank
    has one."""
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert distributed.choose_backend(cpu, 4) == "gloo"
    n = torch.cuda.device_count()
    assert distributed.choose_backend(gpu, n + 1) == "gloo"
    assert distributed.choose_backend(torch.device("cuda:0"), 2) == "gloo"
    if n:
        assert distributed.choose_backend(gpu, n) == "nccl"


def _rank_main(out):
    """One rank of ``two_ranks``: every case into its own directory."""
    distributed.initialize("cpu")
    try:
        cases = [("collectives", _collectives_rank), ("ckpt", _ckpt_rank)]
        cases += [(f"bn_{c}", lambda d, c=c: _bn_rank(c, d))
                  for c in BN_CASES]
        for name, fn in cases:
            d = os.path.join(out, name)
            os.makedirs(d, exist_ok=True)
            fn(d)
        distributed.barrier()
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    _rank_main(sys.argv[1])
