"""K train steps a dispatch (the port's counterpart of the lax.scan
supersteps of point_teacher_tpu: build_train_step_scan in train/steps.py,
build_rotated_train_step_scan in train/rsteps.py, build_fcos_train_step_scan
in train/fcos_baseline.py and build_rfla_train_step_scan in
train/rfla_baseline.py, which carry the same names here).

In JAX the K steps run as one lax.scan program, so the host dispatches once
per K steps. On a card the port captures one step of each trainer and
phase as a CUDA graph (`StepGraph`) and replays that graph once a step,
each step's batch, draws and learning rates copied into the graph's static
buffers first: the host enqueues a few copies and one graph launch a step
instead of thousands of kernel launches, syncs nowhere, and reads the
metrics once a dispatch. A group shorter than K replays the same graph
fewer times. On the CPU the K steps are the plain loop of step calls.
Either way the result is that of K sequential steps chained through the
state, with the metrics stacked [K] (float64, each exactly its step's
value).

Capture. The first step of a trainer and phase runs eagerly on a side
stream: a real step of the run, which also warms up cuDNN, cuBLAS, the
kernels' builds and the constant tables. Then, gradients set to None, the
step is captured into a private memory pool. Capturing runs nothing; the
host counters the step moves (state.step, optimizer.count) are put back
after it, and each replay moves them by one. The kernels' launch counters
(ops/roi_align*.py, ops/nms.py) count where a wrapper runs: at the warm-up
step and at the capture, never at a replay. The draws come from the
state's generator on the host, in the order of K eager calls. On a card a
capture either succeeds or raises: nothing falls back to eager steps. gloo
stages CUDA tensors through the host and cannot be captured, so a world
over gloo on cards raises ValueError; NCCL is captured (at world size 1 on
one card; world sizes above 1 have not run).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..parallel import dist
from ..utils.device import copy_from_host, to_device
from .state import Batch, TrainState

Tensor = torch.Tensor
StepFn = Callable[..., Dict[str, Tensor]]
# draw_fn(generator, global batch size, phase1) -> one step's draws on the
# host (a Draws), or None for a step that draws nothing
DrawFn = Optional[Callable]


def _map(fn, *trees):
    """fn over the tensors of equally shaped trees of tuples, NamedTuples and
    None (a Batch, a Draws)."""
    head = trees[0]
    if head is None:
        return None
    if isinstance(head, Tensor):
        return fn(*trees)
    parts = [_map(fn, *xs) for xs in zip(*trees)]
    return type(head)(*parts) if hasattr(head, "_fields") else type(head)(parts)


def _stacked(metrics: Dict[str, Tensor]) -> Tensor:
    """The metrics as one float64 vector, in the dict's order."""
    return torch.stack([v.detach().reshape(()).to(torch.float64) for v in metrics.values()])


def check_capturable(device) -> None:
    """Raise ValueError where a step cannot be captured as a CUDA graph."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph of the step needs a CUDA device, not {device}")
    if dist.active() and torch.distributed.get_backend() == "gloo":
        raise ValueError("gloo's collectives stage CUDA tensors through the host, which a "
                         "CUDA graph cannot hold: run --steps-per-dispatch 1 over gloo, or "
                         "use NCCL")


class StepGraph:
    """One train step of `step_fn` in one phase, captured as a CUDA graph
    and replayed once a step on `state` (see the module docstring)."""

    def __init__(self, step_fn: StepFn, state: TrainState, phase1: bool, device):
        check_capturable(device)
        self.step_fn, self.state, self.phase1 = step_fn, state, phase1
        self.device = torch.device(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.keys = None
        self.batch = self.draws = self.out = None

    def _call(self, batch: Batch, draws):
        kw = {} if draws is None else {"draws": draws}
        return self.step_fn(self.state, batch, phase1=self.phase1, **kw)

    def warm_up(self, batch: Batch, draws) -> Tensor:
        """Run this step eagerly on a side stream (a real step of the run),
        then capture the step. Returns the eager step's metrics stacked."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            metrics = self._call(batch, _map(lambda t: to_device(t, self.device), draws))
            first = _stacked(metrics)
        current.wait_stream(side)
        first.record_stream(current)
        self.keys = list(metrics)
        del metrics

        self.batch = _map(torch.empty_like, batch)
        self.draws = _map(lambda t: torch.empty_like(t, device=self.device), draws)
        state, opt = self.state, self.state.optimizer
        counters = (state.step, opt.count)
        state.student.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        opt.external_lr = True
        # torch.cuda.graph synchronises the card before it captures: the
        # capture's own sync, once a phase, not the step's
        sync_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            with torch.cuda.graph(graph):
                metrics = self._call(self.batch, self.draws)
                self.out = _stacked(metrics)
        finally:
            torch.cuda.set_sync_debug_mode(sync_mode)
            opt.external_lr = False
            state.step, opt.count = counters
        if list(metrics) != self.keys:
            raise RuntimeError(f"the captured step's metrics {list(metrics)} are not the eager "
                               f"step's {self.keys}")
        self.graph = graph
        return first

    def replay(self, batch: Batch, draws, neg_lr: Tensor, out_row: Tensor) -> None:
        """One step: the batch (on the card), the draws and the negated
        learning rates neg_lr [2] (on the host) into the static buffers, the
        graph, its metrics into out_row. No host sync."""
        _map(lambda dst, src: dst.copy_(src), self.batch, batch)
        if draws is not None:
            _map(copy_from_host, self.draws, draws)
        copy_from_host(self.state.optimizer.neg_lr, neg_lr)
        self.graph.replay()
        out_row.copy_(self.out)
        self.state.optimizer.count += 1
        self.state.step += 1


def build_scan(step_fn: StepFn, draw_fn: DrawFn = None):
    """scan(state, batches, phase1=False, draws=None) -> {metric: Tensor [K]}
    running step_fn on each of the K batches in turn: on the CPU as K calls,
    on a card as K replays of its StepGraph for (state, phase1), captured at
    the first call. `draw_fn` makes a step's draws on the host (None: the
    step draws nothing); `draws`, K Draws on the CPU, replaces it (a test
    feeds another package's draws)."""
    graphs: Dict[bool, StepGraph] = {}

    def scan(state: TrainState, batches: Sequence[Batch], phase1: bool = False,
             draws: Optional[Sequence] = None) -> Dict[str, Tensor]:
        dev = batches[0].image.device
        if dev.type == "cpu":
            outs = [step_fn(state, b, phase1=phase1,
                            **({} if draws is None else {"draws": draws[i]}))
                    for i, b in enumerate(batches)]
            return {k: torch.stack([o[k].detach().to(torch.float64) for o in outs])
                    for k in outs[0]}
        g = graphs.get(phase1)
        if g is None or g.state is not state:
            g = graphs[phase1] = StepGraph(step_fn, state, phase1, dev)
        with torch.cuda.device(dev):
            return _run(g, state, batches, phase1, draws)

    def _run(g: StepGraph, state: TrainState, batches: Sequence[Batch], phase1: bool, given):
        dev = g.device
        rows = None
        for i, b in enumerate(batches):
            if given is not None:
                draws = given[i]
            elif draw_fn is not None:
                draws = draw_fn(state.generator, b.image.shape[0] * dist.world(), phase1)
            else:
                draws = None
            first = g.warm_up(b, draws) if g.graph is None else None
            if rows is None:
                rows = torch.empty((len(batches), len(g.keys)), dtype=torch.float64, device=dev)
            if first is not None:
                rows[i].copy_(first)
            else:
                g.replay(b, draws, state.optimizer.neg_lr_values(state.optimizer.count),
                         rows[i])
        return {k: rows[:, j] for j, k in enumerate(g.keys)}

    return scan
