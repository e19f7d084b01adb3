"""Data parallelism over torch.distributed (counterpart of
point_teacher_tpu/parallel/mesh.py).

JAX runs one global-batch program whose batch axis XLA splits over the
chips, so every batch-wide reduction in it (the gradient, the loss
normalisers, the metrics, the phase-1 gate) is global by construction. The
port runs one process a rank, each on its rows of the global batch, and
makes those reductions global by hand with the helpers below:
- a loss is the rank's sum over the GLOBAL count (`global_sum` of the
  count before its clamp), so the ranks' losses add up to the global loss
  and the sum of their gradients (`reduce_grads`, an all-reduce SUM) is the
  global-batch gradient;
- a metric is a global sum over a global count (`global_sum`,
  `global_mean`, `global_max`), a loss metric the sum of the ranks' losses
  (`sum_losses`);
- the point caches stay equal on every rank: each rank's rows are gathered
  (`gather_rows`) and every rank writes every image;
- every rank draws the global batch's random numbers from the same seeded
  generator and takes its rows (`take_rows`), so a world draws what one
  process draws.
The backend is NCCL on the card (one process a GPU, `cuda:LOCAL_RANK`,
under torchrun) and gloo on the CPU (parallel/launch.py spawns the ranks).

Without a process group every helper is the identity, so one process
computes exactly what it computed before. With one, every helper runs its
collective, at any world size (a world of 1 adds nothing); only
ops/losses.py `dn_diou_loss` changes its formula, and only at a world
size above 1. The mesh is 1-D (data parallel only), as the reference's
MMDistributedDataParallel.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

Tensor = torch.Tensor
# a collective's wait: rank 0's host work (the metrics over a real val set,
# a checkpoint) holds the others in a collective for minutes; a world that
# hangs is ended sooner by its launcher (parallel/launch.py, torchrun)
TIMEOUT = datetime.timedelta(minutes=30)


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def env_world() -> Optional[int]:
    """The world size torchrun set (WORLD_SIZE), or None outside torchrun."""
    size = os.environ.get("WORLD_SIZE")
    return int(size) if size else None


def local_device() -> torch.device:
    """The rank's card under torchrun, cuda:LOCAL_RANK."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def init(backend: str, init_method: str, rank_: int, world_size: int,
         device: Optional[torch.device] = None, timeout=TIMEOUT) -> None:
    """Join a world of `world_size` ranks; on a card the rank's device
    becomes the current one (NCCL and broadcast_object_list use it)."""
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world_size, timeout=timeout)


def init_from_env(device: torch.device) -> None:
    """Join the world that torchrun describes (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT): NCCL on a card, gloo on the CPU."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    init(backend, "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), device)


def shutdown() -> None:
    if active():
        dist.destroy_process_group()


def barrier() -> None:
    if active():
        dist.barrier()


def rank_rows(n: int) -> slice:
    """Rank r's rows [r * n / N, (r + 1) * n / N) of a global batch of n
    (the block JAX's P("data") gives device r). A world that does not
    divide n raises ValueError: JAX falls back to one chip there, which N
    processes cannot."""
    n_world = world()
    if n % n_world:
        raise ValueError(f"a global batch of {n} does not split over {n_world} ranks")
    per = n // n_world
    return slice(rank() * per, (rank() + 1) * per)


def take_rows(x):
    """This rank's rows of every tensor of `x` (a tensor, None, or a tuple
    or NamedTuple of them), each of whose leading dimension is the global
    batch."""
    if x is None:
        return None
    if isinstance(x, Tensor):
        return x[rank_rows(x.shape[0])] if active() else x
    parts = [take_rows(v) for v in x]
    return type(x)(*parts) if hasattr(x, "_fields") else type(x)(parts)


def _pack(xs):
    """Tensors of one leading dimension b -> one f64 [b, sum of row sizes]
    (exact for f32, integers below 2^53 and bools) and what unpacks it."""
    rows = xs[0].shape[0]
    flat = torch.cat([x.detach().reshape(rows, -1).to(torch.float64) for x in xs], 1)

    def unpack(buf):
        out, at = [], 0
        for x in xs:
            k = x[0].numel() if rows else 0
            out.append(buf[:, at:at + k].reshape(buf.shape[0], *x.shape[1:]).to(x.dtype))
            at += k
        return out

    return flat, unpack


def global_sum(*xs: Tensor):
    """Each tensor summed over the world (one all-reduce for all of them);
    a tensor stays as given without a process group. Returns one tensor for
    one argument, else a tuple."""
    if active():
        flat, unpack = _pack([x.reshape(1, -1) for x in xs])
        dist.all_reduce(flat)
        xs = tuple(u.reshape(x.shape) for u, x in zip(unpack(flat), xs))
    return xs[0] if len(xs) == 1 else tuple(xs)


def global_ratio(num: Tensor, den: Tensor, least=1) -> Tensor:
    """num / den.clamp(min=least), each summed over the world first."""
    num, den = global_sum(num, den)
    return num / den.clamp(min=least)


def global_mean(x: Tensor) -> Tensor:
    """The mean of x's elements over the world (x.mean() without a group)."""
    if not active():
        return x.mean()
    total, count = global_sum(x.detach().sum(), torch.tensor(float(x.numel()), device=x.device))
    return (total / count).to(x.dtype)


def global_max(x: Tensor) -> Tensor:
    """The largest element of x over the world (x.max() without a group)."""
    m = x.max()
    if active():
        m = m.detach().clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
    return m


def global_all(flag: Tensor) -> Tensor:
    """A 0-d bool tensor, true when it is true on every rank."""
    if not active():
        return flag
    v = flag.detach().to(torch.int32).reshape(1)
    dist.all_reduce(v, op=dist.ReduceOp.MIN)
    return v[0].bool()


def sum_losses(metrics: dict) -> dict:
    """The metrics whose key names a loss (each rank's is its share of the
    global loss) summed over the world; the others, global already, as
    given. One all-reduce."""
    keys = [k for k in metrics if "loss" in k]
    if active() and keys:
        summed = global_sum(*(metrics[k] for k in keys))
        metrics = {**metrics, **dict(zip(keys, summed if len(keys) > 1 else (summed,)))}
    return metrics


def gather_rows(*xs: Tensor):
    """Every rank's rows of each tensor, concatenated in rank order, on
    every rank (one all-gather for all of them); as given without a group.
    Returns a tuple."""
    if not active():
        return xs
    flat, unpack = _pack(xs)
    parts = [torch.empty_like(flat) for _ in range(world())]
    dist.all_gather(parts, flat.contiguous())
    return tuple(unpack(torch.cat(parts, 0)))


@torch.no_grad()
def reduce_grads(model: torch.nn.Module) -> None:
    """After backward: every trainable parameter's gradient summed over the
    world, in one all-reduce of a flat f32 buffer. A gradient that is None
    counts as zeros, so every rank sends the same layout, and stays None
    where it is None on every rank."""
    if not active():
        return
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        return
    dev = params[0].device
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                      .reshape(-1).to(torch.float32) for p in params]
                     + [torch.tensor([float(p.grad is not None) for p in params], device=dev)])
    dist.all_reduce(flat)
    has = flat[-len(params):].tolist()
    at = 0
    for p, h in zip(params, has):
        k = p.numel()
        if h > 0:
            g = flat[at:at + k].view_as(p).to(p.dtype)
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.copy_(g)
        at += k


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` from rank `src`."""
    if not active():
        return
    for t in module.state_dict().values():
        dist.broadcast(t, src)


def broadcast_object(obj, src: int = 0):
    """A picklable object from rank `src` on every rank."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]
