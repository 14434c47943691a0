"""The port's step graphs (``cova_tpu_torch/train/graphs.py``) on the CPU.

A CUDA graph exists only on the card, so the runner's schedule runs here
through a stand-in for the graph object: its capture runs the step and then
puts back everything the step changed (a capture runs nothing), and its
replay re-runs the captured closure on the graph's static buffers and
writes the outputs where the capture's outputs lie, so the copy-in and
copy-out protocol is exercised. A two-epoch ``fit`` over two box buckets
through the stand-in must give the eager ``fit``'s losses, checkpoints, BN
buffers and Adam state bit for bit. The keys, the restore rule, the launch
accounting, the dropout generator and the optimizer's device rule are held
here too; the graphs on the card are held by the tests marked ``cuda`` and
by ``python3 chip_smoke.py graphs``.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cova_tpu_torch.benchmarks import _first_boxes
from cova_tpu_torch.config import Config
from cova_tpu_torch.data.batching import Batch, pad_batch
from cova_tpu_torch.data.pipeline import make_pipelines
from cova_tpu_torch.data.synthetic import InMemoryWebDataset
from cova_tpu_torch.models.cova import build_model
from cova_tpu_torch.ops import bn_pool, launches, roi_pool
from cova_tpu_torch.train import graphs, steps, trainer
from cova_tpu_torch.utils import tracing
from cova_tpu_torch.utils.checkpoint import CheckpointManager, load_checkpoint
from cova_tpu_torch.utils.logging import MetricsLogger

CFG = Config(img_height=64, max_boxes=30, context_size=3, hidden_dim=32,
             bbox_hidden_dim=8, batch_size=2, eval_batch_size=4,
             compute_dtype="float32", box_buckets=(8, 16), n_epochs=2,
             num_workers=1)


def _flat(out):
    """The tensors of a step's output, in order."""
    got = []
    graphs._map(got.append, out)
    return got


class StandIn:
    """``graphs.CudaGraph`` on the CPU. ``world()`` lists every tensor that
    a step may change in place (parameters, buffers, optimizer state)."""

    made = []

    def __init__(self, world=lambda: []):
        self.world = world
        self.replays = 0
        StandIn.made.append(self)

    def capture(self, fn, generators):
        saved = [t.detach().clone() for t in self.world()]
        rng = [g.get_state() for g in generators]
        out = fn()
        with torch.no_grad():
            for t, s in zip(self.world(), saved):
                t.copy_(s)
        for g, s in zip(generators, rng):
            g.set_state(s)
        self.fn, self.out = fn, out
        return out

    def replay(self):
        before = launches.counts()
        fresh = self.fn()
        launches.add({k: -n for k, n in launches.since(before).items()})
        with torch.no_grad():
            for t, f in zip(_flat(self.out), _flat(fresh)):
                t.copy_(f)
        self.replays += 1


def _world(state):
    def tensors():
        out = list(state.model.state_dict().values())
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                s = state.optimizer.state.get(p, {})
                out += [s[k] for k in sorted(s) if torch.is_tensor(s[k])]
        return out
    return tensors


@pytest.fixture
def stand_in(monkeypatch):
    """Graphs on for the CPU through ``StandIn``; yields a function that
    sets the world the next graphs snapshot."""
    StandIn.made = []
    world = [lambda: []]
    monkeypatch.setattr(graphs, "enabled",
                        lambda g, device, mesh=None: bool(g) and mesh is None)
    monkeypatch.setattr(graphs, "CudaGraph", lambda: StandIn(world[0]))

    def set_world(fn):
        world[0] = fn
    return set_world


@pytest.fixture
def one_thread():
    # CPU runs on several intra-op threads can differ in their last bits
    # from run to run; on one they are the same bits.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n=16, seed=3):
    ds = InMemoryWebDataset(n, CFG.img_height, seed=seed, min_boxes=4,
                            max_boxes=CFG.max_boxes)
    return make_pipelines(CFG, ds, ds, ds)


def _batch(p=None, seed=0, b=2):
    """A padded batch of ``b`` pages, cut to its first ``p`` boxes."""
    train, _, _ = _data(8, seed)
    batch = pad_batch(next(iter(train.epoch(1)))[1], b)[0]
    return _first_boxes(batch, p) if p else batch


def _inputs(batch):
    out = steps.batch_to_device(batch, "cpu")
    out["labels"] = torch.from_numpy(batch.labels)
    return out


# -- keys ------------------------------------------------------------------

def test_same_shapes_give_the_same_key():
    model = build_model(CFG, device="cpu").train()
    gen = torch.Generator()
    a = graphs.step_key("train", model, _inputs(_batch(16, seed=0)), gen)
    b = graphs.step_key("train", model, _inputs(_batch(16, seed=5)), gen)
    assert a == b
    assert hash(a) == hash(b)


@pytest.mark.parametrize("change", ["p_bucket", "dtype", "training",
                                    "cuda_conv", "remat", "deterministic",
                                    "cudnn_deterministic"])
def test_another_setting_gives_another_key(change, monkeypatch):
    model = build_model(CFG, device="cpu").train()
    inputs = _inputs(_batch(16))
    key = graphs.step_key("train", model, inputs)
    if change == "p_bucket":
        inputs = _inputs(_batch(8))
    elif change == "dtype":
        inputs["boxes"] = inputs["boxes"].double()
    elif change == "training":
        model.eval()
    elif change == "cuda_conv":
        monkeypatch.setenv("COVA_CUDA_CONV", "1")
    elif change == "remat":
        monkeypatch.setenv("COVA_REMAT", "1")
    elif change == "cudnn_deterministic":
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    else:
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            assert graphs.step_key("train", model, inputs) != key
        finally:
            torch.use_deterministic_algorithms(was)
        return
    assert graphs.step_key("train", model, inputs) != key


def test_the_rule_is_cuda_without_a_mesh():
    assert graphs.enabled(True, "cuda")
    assert graphs.enabled(True, torch.device("cuda", 0))
    assert not graphs.enabled(False, "cuda")
    assert not graphs.enabled(True, "cpu")
    assert not graphs.enabled(True, "cuda", mesh=object())


def test_cpu_steps_run_eagerly():
    state = steps.create_train_state(build_model(CFG, device="cpu"), CFG)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        steps.train_step(state, _batch(16), gen)
    model = build_model(CFG, device="cpu")
    steps.forward_step(model, _batch(16))
    steps.forward_step(model, _batch(16))
    assert state.graphs is None and state.step == 3
    assert model not in graphs._MODEL_GRAPHS


def test_a_train_step_after_a_forward_in_inference_mode():
    """The stem's tap index is copied to the device once (a copy in every
    forward would sync, and a graph cannot hold it); made first inside the
    forward's ``inference_mode``, it must still serve a training forward,
    which saves it for the backward."""
    from cova_tpu_torch.ops import conv_stem

    conv_stem._tap_index_on.cache_clear()
    model = build_model(CFG, device="cpu")
    steps.forward_step(model, _batch(16))
    state = steps.create_train_state(model, CFG)
    m = steps.train_step(state, _batch(16), torch.Generator().manual_seed(0))
    assert torch.isfinite(m["loss_sum"])
    assert conv_stem._tap_index_on.cache_info().currsize == 1


# -- the schedule ----------------------------------------------------------

def _fit(tmp, with_graphs):
    """``fit`` for two epochs; returns the state, the best val accuracy,
    every logged metric but the times, and the checkpoints."""
    state = steps.create_train_state(build_model(CFG, device="cpu"), CFG)
    train, val, _ = _data()
    ckpt = CheckpointManager(os.path.join(tmp, "ckpt"))
    log = os.path.join(tmp, "metrics.jsonl")
    with_graphs(_world(state))
    state, best = trainer.fit(state, CFG, train, val, ckpt,
                              metrics=MetricsLogger(log))
    with open(log) as f:
        rows = [{k: v for k, v in json.loads(line).items()
                 if k not in ("ts", "seconds", "pages_per_sec")}
                for line in f]
    return state, best, rows, ckpt


def test_fit_through_graphs_equals_the_eager_fit(tmp_path, stand_in,
                                                  monkeypatch, one_thread):
    keys = []
    real_key = graphs.step_key

    def key(kind, model, inputs, *extra):
        k = real_key(kind, model, inputs, *extra)
        keys.append((kind, tuple(inputs["boxes"].shape)))
        return k

    monkeypatch.setattr(graphs, "step_key", key)
    got = _fit(str(tmp_path / "graphs"), stand_in)
    captured = list(StandIn.made)
    monkeypatch.setattr(graphs, "enabled", lambda *a, **kw: False)
    want = _fit(str(tmp_path / "eager"), lambda world: None)

    # The run went through graphs at two box buckets, train and eval.
    train_p = {shape[1] for kind, shape in keys if kind == "train"}
    assert len(train_p) >= 2, keys
    assert {kind for kind, _ in keys} == {"train", "eval"}
    assert len(captured) >= 3 and sum(g.replays for g in captured) > 4
    assert got[0].step == want[0].step == len(
        [k for k in keys if k[0] == "train"])

    assert got[1] == want[1]
    assert got[2] == want[2]
    assert [r["epoch"] for r in got[2] if r["event"] == "train_epoch"] \
        == [1, 2]
    for tag in ("best", "last"):
        a = load_checkpoint(got[3].path(tag))
        b = load_checkpoint(want[3].path(tag))
        assert a["step"] == b["step"] and a["extra"] == b["extra"]
        for k in b["model"]:
            assert torch.equal(a["model"][k], b["model"][k]), (tag, k)
        for i, s in b["optimizer"]["state"].items():
            for k, v in s.items():
                assert torch.equal(a["optimizer"]["state"][i][k], v), (
                    tag, i, k)
    sa, sb = got[0].model.state_dict(), want[0].model.state_dict()
    for k in sb:  # BN buffers (running stats, counts) and parameters
        assert torch.equal(sa[k], sb[k]), k
    oa = got[0].optimizer.state_dict()["state"]
    for i, s in want[0].optimizer.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(oa[i][k], v), (i, k)


def test_eval_and_forward_graphs_equal_eager(stand_in):
    model = build_model(CFG, device="cpu")
    full = _batch(16, seed=1, b=4)
    part = pad_batch(Batch(*[x[:3] for x in _batch(16, seed=2, b=4)]),
                     4)[0]
    for batch in (full, full, part, full):
        want = steps.eval_step(model, batch, graphs=False)
        got = steps.eval_step(model, batch)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        fw = steps.forward_step(model, batch, graphs=False)
        fg = steps.forward_step(model, batch)
        assert torch.equal(fg.logits, fw.logits)
        assert torch.equal(fg.attn_wts, fw.attn_wts)
    runner = graphs.model_graphs(model)
    assert len(runner.graphs) == 2  # eval and forward at one shape
    # Of four calls of each kind, the first ran eagerly.
    assert sum(g.replays for g in StandIn.made) == 6


def test_outputs_are_copies_taken_before_the_next_replay(stand_in):
    model = build_model(CFG, device="cpu")
    outs = [steps.forward_step(model, _batch(16, seed=s)).logits
            for s in range(4)]
    for s, got in enumerate(outs):
        assert torch.equal(got, steps.forward_step(
            model, _batch(16, seed=s), graphs=False).logits)
    assert not torch.equal(outs[2], outs[3])


# -- restore and in-place loads --------------------------------------------

def test_a_restore_drops_the_train_graphs(tmp_path, stand_in):
    state = steps.create_train_state(build_model(CFG, device="cpu"), CFG)
    stand_in(_world(state))
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        steps.train_step(state, _batch(16), gen)
    assert len(state.graphs.graphs) == 1 and StandIn.made[0].replays == 2
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save("last", state, {"epoch": 1})
    ckpt.restore("last", state)
    assert state.graphs is None and state.step == 3
    # The key runs eagerly again, then captures anew.
    steps.train_step(state, _batch(16), gen)
    assert len(StandIn.made) == 1 and len(state.graphs.graphs) == 0
    steps.train_step(state, _batch(16), gen)
    assert len(StandIn.made) == 2 and StandIn.made[1].replays == 1


def test_load_state_dict_keeps_addresses_and_the_eval_graphs(stand_in):
    model = build_model(CFG, device="cpu")
    batch = _batch(16)
    for _ in range(2):
        steps.forward_step(model, batch)
    ptrs = {k: v.data_ptr() for k, v in model.state_dict().items()}
    other = build_model(CFG.replace(seed=CFG.seed + 1), device="cpu")
    model.load_state_dict(other.state_dict())
    assert {k: v.data_ptr() for k, v in model.state_dict().items()} == ptrs
    got = steps.forward_step(model, batch).logits
    assert len(graphs.model_graphs(model).graphs) == 1
    assert torch.equal(got, steps.forward_step(other, batch,
                                               graphs=False).logits)


# -- launch accounting -----------------------------------------------------

def test_replays_add_the_captures_launch_counts(stand_in):
    def step(x):
        roi_pool.roi_pool.launches += 2
        bn_pool.bn_relu_pool_s2d.launches += 1
        return {"y": x * 2}

    def run(use_graphs, n=5):
        launches.zero()
        runner = graphs.StepGraphs()
        for i in range(n):
            x = torch.full((3,), float(i))
            out = (runner.run(("k",), step, {"x": x}) if use_graphs
                   else step(x))
            assert torch.equal(out["y"], x * 2)
        return launches.counts(), runner

    eager, _ = run(False)
    graphed, runner = run(True)
    assert graphed == eager
    assert eager["roi_pool_fwd"] == 10 and eager["bn_relu_pool_fwd"] == 5
    assert runner.graphs[("k",)].launches == {
        **{k: 0 for k in eager}, "roi_pool_fwd": 2, "bn_relu_pool_fwd": 1}
    launches.zero()


def test_runs_are_counted_and_spanned_by_kind(stand_in):
    """Each call of ``StepGraphs.run`` counts as one eager run, capture or
    replay of its key's kind, inside the span of the same name, and a
    ``forward_step`` runs inside its own span."""
    def step(x):
        return {"y": x + 1}

    runner = graphs.StepGraphs()
    before = tracing.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(4):
            x = torch.full((2,), float(i))
            assert torch.equal(runner.run(("forward",), step, {"x": x})["y"],
                               x + 1)
        runner.run(("eval",), step, {"x": x})
        steps.forward_step(build_model(CFG, device="cpu"), _batch(16))
    moved = tracing.since(before)
    assert {k: n for k, n in moved.items()
            if k.startswith("graph.") and n} == {
        "graph.eager.forward": 2, "graph.captures.forward": 1,
        "graph.replays.forward": 2, "graph.eager.eval": 1}
    names = [e.name for e in prof.events()
             if e.name.startswith("cova_tpu_torch.")]
    run = "cova_tpu_torch.graph."
    assert names == [run + "eager", run + "capture", run + "replay",
                     run + "replay", run + "eager",
                     steps.FORWARD_RANGE, run + "eager"]


# -- the dropout generator -------------------------------------------------

@pytest.mark.parametrize("data_rank", [0, 1])
def test_a_reseeded_generator_gives_dropout_generators_stream(data_rank):
    gen = trainer.dropout_generator(7, 1, "cpu", data_rank)
    first = torch.rand(64, generator=gen)
    for epoch in (2, 3):
        again = trainer.dropout_generator(7, epoch, "cpu", data_rank,
                                          generator=gen)
        assert again is gen
        want = torch.rand(64, generator=trainer.dropout_generator(
            7, epoch, "cpu", data_rank))
        assert torch.equal(torch.rand(64, generator=gen), want)
        assert not torch.equal(want, first)


def test_fit_keeps_one_generator(tmp_path, monkeypatch):
    seen = []
    real = trainer.dropout_generator

    def gen(*a, **kw):
        g = real(*a, **kw)
        seen.append(g)
        return g

    monkeypatch.setattr(trainer, "dropout_generator", gen)
    _fit(str(tmp_path), lambda world: None)
    assert len(seen) == 2 and seen[0] is seen[1]


# -- the optimizer's device rule and its checkpoints -----------------------

def test_make_optimizer_is_not_capturable_on_the_cpu():
    model = build_model(CFG, device="cpu")
    opt = steps.make_optimizer(model.parameters(), 1e-3, 1e-3)
    assert opt.param_groups[0]["capturable"] is False


def test_a_float32_step_checkpoint_resumes_on_the_cpu(tmp_path, one_thread):
    """The capturable path writes Adam's ``step`` as a float32 0-d tensor
    (on the card; ``load_checkpoint`` maps it to the CPU) and its param
    groups with ``capturable`` set. Such a file restores into a CPU state,
    whose Adam stays not capturable (torch refuses that on the CPU), and
    resumes the run exactly."""
    cfg = CFG.replace(n_epochs=1)
    state = steps.create_train_state(build_model(cfg, device="cpu"), cfg)
    train, val, _ = _data()
    ckpt = CheckpointManager(str(tmp_path / "a"))
    trainer.fit(state, cfg, train, val, ckpt)
    raw = torch.load(ckpt.path("last"), weights_only=True)
    for s in raw["optimizer"]["state"].values():
        s["step"] = torch.tensor(float(s["step"]), dtype=torch.float32)
    for g in raw["optimizer"]["param_groups"]:
        g["capturable"] = True
    torch.save(raw, ckpt.path("last"))
    state2 = steps.create_train_state(build_model(cfg, device="cpu"), cfg)
    ckpt.restore("last", state2)
    assert not any(g["capturable"] for g in state2.optimizer.param_groups)
    for s in state2.optimizer.state.values():
        assert s["step"].dtype == torch.float32 and s["step"].dim() == 0
        assert s["step"].device.type == "cpu"
    resumed, _ = trainer.fit(state2, CFG, train, val, ckpt, resume=True)
    whole = steps.create_train_state(build_model(CFG, device="cpu"), CFG)
    trainer.fit(whole, CFG, train, val, CheckpointManager(str(tmp_path / "b")))
    a = load_checkpoint(ckpt.path("last"))
    b = load_checkpoint(os.path.join(str(tmp_path / "b"), "last.pt"))
    assert a["step"] == b["step"]
    for k in b["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k


# -- on the card -----------------------------------------------------------

@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels "
                    "have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_make_optimizer_is_capturable_on_cuda(gpu):
    model = build_model(CFG, device=gpu)
    opt = steps.make_optimizer(model.parameters(), 1e-3, 1e-3)
    assert opt.param_groups[0]["capturable"] is True


@pytest.mark.cuda
def test_graphed_steps_equal_eager_on_the_card(gpu):
    """Four train steps from one state through graphs and eagerly: the
    first loss the same bits, the rest close (the card's scatter-add
    atomics); the forward graph the same bits as the eager forward."""
    cfg = CFG.replace(img_height=256, compute_dtype="bfloat16")
    batch = _batch(16)
    sd = build_model(cfg, device="cpu").state_dict()
    losses = {}
    for use in (False, True):
        model = build_model(cfg, device=gpu)
        model.load_state_dict(sd)
        state = steps.create_train_state(model, cfg)
        gen = torch.Generator(device=gpu).manual_seed(0)
        losses[use] = [float(steps.train_step(state, batch, gen,
                                              graphs=use)["loss_sum"])
                       for _ in range(4)]
        assert (state.graphs is not None) == use
    assert losses[True][0] == losses[False][0]
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-2)
    model = build_model(cfg, device=gpu)
    want = steps.forward_step(model, batch, graphs=False)
    for _ in range(3):
        got = steps.forward_step(model, batch)
        assert torch.equal(got.logits, want.logits)
        assert torch.equal(got.attn_wts, want.attn_wts)


@pytest.mark.cuda
def test_checkpoints_move_between_the_card_and_the_cpu(gpu, tmp_path):
    """A card checkpoint (capturable Adam: ``step`` a float32 tensor on the
    card) restores into a CPU state, and a CPU checkpoint into a card
    state; each then takes a step."""
    batch = _batch(16)
    for src, dst in ((gpu, "cpu"), ("cpu", gpu)):
        state = steps.create_train_state(build_model(CFG, device=src), CFG)
        gen = torch.Generator(device=src).manual_seed(0)
        steps.train_step(state, batch, gen)
        ckpt = CheckpointManager(str(tmp_path / str(src)))
        ckpt.save("last", state, {"epoch": 1})
        other = steps.create_train_state(build_model(CFG, device=dst), CFG)
        ckpt.restore("last", other)
        for g in other.optimizer.param_groups:
            assert g["capturable"] == (torch.device(dst).type == "cuda")
        for p, s in other.optimizer.state.items():
            assert s["step"].dtype == torch.float32 and float(s["step"]) == 1
            assert s["step"].device == p.device
        m = steps.train_step(other, batch,
                             torch.Generator(device=dst).manual_seed(0))
        assert torch.isfinite(m["loss_sum"]) and other.step == 2


@pytest.mark.cuda
def test_host_arrays_serve_then_train_on_the_card(gpu):
    """Host arrays (not a prefetched batch) reach the card through
    ``steps._to_device``, pinned at each call: copied into a graph's static
    inputs under a forward's ``inference_mode`` and outside it in a train
    step; a graphed forward on them equals the eager one."""
    batch = _batch(16)
    model = build_model(CFG, device=gpu)
    want = steps.forward_step(model, batch, graphs=False).logits
    for _ in range(3):
        assert torch.equal(steps.forward_step(model, batch).logits, want)
    state = steps.create_train_state(model, CFG)
    gen = torch.Generator(device=gpu).manual_seed(0)
    for _ in range(3):
        m = steps.train_step(state, batch, gen)
    assert torch.isfinite(m["loss_sum"]) and state.step == 3
