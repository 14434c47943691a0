"""The step graphs: the train, eval and serving steps as CUDA graphs.

Counterpart of the ``jax.jit`` decorators of ``cova_tpu/train/steps.py``
(``train_step``, ``:107``, one XLA program with donated buffers;
``eval_step``, ``:177``; ``forward_step``, ``:212``): one compiled program
per static shape, which pays the host's Python, shape checks, plan choices
and allocations once. Here that program is a ``torch.cuda.CUDAGraph`` of
the eager step, with the hand-written kernels inside it: they launch
through ctypes on the current stream, which a capture records.

* One graph per key (``step_key``): the kind of step, each input's shape,
  dtype and device, ``model.training``, ``COVA_CUDA_CONV`` and
  ``COVA_REMAT`` (both read at call time), the two TF32 switches and the
  two determinism switches (each picks kernels), and what the step takes
  besides its inputs (a train step's dropout generator, an
  eval step's class count and depth).
* Every call is one step, in order. The first call of a key runs the step
  eagerly: a real step, which also warms the lazy state (Adam's moments,
  the cuBLAS and cuDNN handles, the kernel libraries and their
  ``cudaFuncSetAttribute``). The second captures the step and replays the
  capture, and that replay is its step; later calls replay. A capture runs
  nothing, so no step is added, skipped or repeated.
* Each graph owns static input buffers. A call copies its tensors in on the
  current stream (after the prefetcher's event, as any consumer of a
  prefetched batch) and returns copies of the graph's outputs, taken before
  the next replay overwrites them.
* Each graph captures into a private memory pool, with
  ``capture_error_mode="thread_local"``: other threads may allocate pinned
  memory while the main thread captures. A capture that fails raises.
* A train graph registers its dropout generator: each replay draws at the
  generator's position and advances it by what the step draws, so a replay
  draws the masks that the eager step would draw there.
* The kernel wrappers' launch counters (``ops/launches.py``) get the counts
  recorded during the capture at each replay, so they count what an eager
  run of the same steps counts.
* Each call is counted (``utils/tracing.py``) as ``graph.eager.<kind>``,
  ``graph.captures.<kind>`` or ``graph.replays.<kind>``, ``<kind>`` being
  the key's first element, and runs inside the span
  ``cova_tpu_torch.graph.eager``, ``.capture`` (the capture and the replay
  that is its step) or ``.replay`` (the copy into the static inputs, the
  replay, the launch counts and the output copies).

Where graphs run is a rule of the runner, not a fallback (``enabled``):
asked for (the entry points' ``graphs`` keyword, on by default) on a CUDA
device without a mesh. On the CPU, and on a mesh (whose gloo collectives a
capture cannot hold), the steps run eagerly.
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, Optional, Sequence

import torch

from ..ops import launches
from ..utils.tracing import count, span


def enabled(graphs: bool, device, mesh=None) -> bool:
    """Whether a step runs through graphs: ``graphs`` asked for, on a CUDA
    device, without a mesh."""
    return bool(graphs) and torch.device(device).type == "cuda" \
        and mesh is None


def step_key(kind: str, model, inputs: Dict[str, Optional[torch.Tensor]],
             *extra) -> tuple:
    """The key of a step's graph: ``kind``, each input's shape, dtype and
    device, the model's mode, the switches the step reads at call time,
    and ``extra``."""
    from ..models.resnet import use_remat
    from ..ops.conv3x3 import use_cuda_conv

    fields = tuple(
        (name, None if t is None else (tuple(t.shape), t.dtype, t.device))
        for name, t in inputs.items())
    return (kind, fields, model.training, use_cuda_conv(), use_remat(),
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic, *extra)


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` with the capture the runner makes."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn: Callable, generators: Sequence[torch.Generator]):
        """Capture ``fn()`` (which runs nothing on the card) into a private
        pool, with ``generators`` registered; returns its outputs, the
        tensors that each replay writes."""
        for gen in generators:
            self.graph.register_generator_state(gen)
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            return fn()

    def replay(self) -> None:
        self.graph.replay()


def _map(fn, out):
    """``fn`` applied to every tensor of a step's output: a tensor, or a
    dict (train, eval) or named tuple (``CoVAOutput``) of tensors or
    None."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, dict):
        return {k: _map(fn, v) for k, v in out.items()}
    if isinstance(out, tuple):
        return type(out)(*(_map(fn, v) for v in out))
    return out


class _Graph:
    """One captured step: its static inputs, the graph, its outputs and the
    kernel launches its capture recorded."""

    def __init__(self, step: Callable,
                 inputs: Dict[str, Optional[torch.Tensor]],
                 generators: Sequence[torch.Generator]):
        # Filled with this call's inputs: a capture reads nothing, but a
        # stand-in that runs the step (the CPU tests') then sees real data.
        self.static = {
            k: None if t is None
            else t.clone(memory_format=torch.contiguous_format)
            for k, t in inputs.items()}
        before = launches.counts()
        t0 = time.perf_counter()
        self.graph = CudaGraph()
        self.out = self.graph.capture(lambda: step(**self.static),
                                      tuple(generators))
        self.capture_seconds = time.perf_counter() - t0
        # The capture launched nothing: its counts move to the replays.
        self.launches = launches.since(before)
        launches.add({k: -n for k, n in self.launches.items()})

    def __call__(self, inputs: Dict[str, Optional[torch.Tensor]]):
        for k, t in inputs.items():
            if t is not None:
                self.static[k].copy_(t)
        self.graph.replay()
        launches.add(self.launches)
        return _map(torch.clone, self.out)


class StepGraphs:
    """The graphs of one train state (its train steps) or of one model (its
    eval and forward steps), by key."""

    def __init__(self):
        self.graphs: Dict[tuple, _Graph] = {}
        self.seen = set()

    def run(self, key: tuple, step: Callable,
            inputs: Dict[str, Optional[torch.Tensor]],
            generators: Sequence[torch.Generator] = ()):
        """One step ``step(**inputs)`` of ``key``: eager the first time the
        key is seen, captured and replayed the second, replayed after."""
        kind = key[0]
        graph = self.graphs.get(key)
        if graph is None:
            if key not in self.seen:
                self.seen.add(key)
                count(f"graph.eager.{kind}")
                with span("cova_tpu_torch.graph.eager"):
                    return step(**inputs)
            count(f"graph.captures.{kind}")
            with span("cova_tpu_torch.graph.capture"):
                graph = _Graph(step, inputs, generators)
                self.graphs[key] = graph
                return graph(inputs)
        count(f"graph.replays.{kind}")
        with span("cova_tpu_torch.graph.replay"):
            return graph(inputs)

    def capture_seconds(self) -> list:
        """Each graph's capture time, in seconds, in capture order."""
        return [g.capture_seconds for g in self.graphs.values()]


_MODEL_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def model_graphs(model) -> StepGraphs:
    """The eval and forward graphs of ``model`` (kept while it lives). They
    read its parameters and buffers where they lie, so an in-place load
    (``load_state_dict``) keeps them valid."""
    graphs = _MODEL_GRAPHS.get(model)
    if graphs is None:
        graphs = _MODEL_GRAPHS[model] = StepGraphs()
    return graphs


def state_graphs(state) -> StepGraphs:
    """The train graphs of a ``TrainState``. They hold its parameters', its
    gradients' and its optimizer state's addresses; replacing the
    optimizer's state tensors (``CheckpointManager.restore``) drops them
    (``state.graphs = None``)."""
    if state.graphs is None:
        state.graphs = StepGraphs()
    return state.graphs
