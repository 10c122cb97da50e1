"""Process group set-up and the few collectives the trainer needs.

The JAX package runs one SPMD program over a device mesh
(``rgbnomore_tpu/parallel/mesh.py:29-68``) and lets XLA insert the gradient
all-reduce.  The port runs the reference's way: one process per GPU, each
with its slice of every global batch, joined in a ``torch.distributed``
process group.  ``Trainer`` (``train/loop.py``) uses what is here to keep
the property that the JAX package's sharding tests hold: N processes on one
global batch compute what one process computes on it (gradients averaged,
mixup's roll taken over the global batch, eval sums added up).

Without a process group every helper is the one-process identity, so the
trainer's single-GPU path calls none of ``torch.distributed``.  In a process
group each collective is a span, ``rgbnm.exchange.grads`` (the gradient
all-reduce), ``rgbnm.exchange.mixup`` (mixup's ring) or
``rgbnm.exchange.sums`` (eval sums and losses), and adds the bytes this rank
puts into it to the counter ``rgbnm.exchange.<grads|mixup|sums>.bytes``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from rgbnomore_tpu_torch.utils import profiling

__all__ = ["all_reduce_mean_", "all_reduce_sum_", "barrier", "init_distributed",
           "is_initialized", "is_rank0", "local_rank", "rank", "ring_roll", "world_size"]


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device: str = "cuda") -> None:
    """Join the process group (the reference's rendezvous,
    ``pipeline_utils.py:78-88``; the JAX ``init_distributed``,
    ``mesh.py:52-68``): backend NCCL for ``device="cuda"``, gloo for
    ``"cpu"``.  With ``coordinator`` (``host:port`` of process 0) the rank
    and world are ``process_id`` and ``num_processes``, given by the caller;
    without it they are torchrun's ``RANK`` and ``WORLD_SIZE``.  On the GPU
    this process's device becomes ``cuda:<local_rank()>``.  Does nothing
    when the group exists already."""
    if dist.is_initialized():
        return
    backend = {"cuda": "nccl", "cpu": "gloo"}[torch.device(device).type]
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and --process_id")
        init_method, world, rank_ = f"tcp://{coordinator}", num_processes, process_id
    else:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise ValueError("without a coordinator, init_distributed reads torchrun's "
                             "RANK and WORLD_SIZE, which are not set")
        init_method = "env://"
        world, rank_ = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; the port runs on an NVIDIA GPU. "
                               "Pass --device cpu to train on the CPU (gloo) instead.")
        torch.cuda.set_device(local_rank(rank_))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank_)


def local_rank(global_rank: int | None = None) -> int:
    """This process's GPU on its host: torchrun's ``LOCAL_RANK``, else the
    rank modulo the host's visible GPUs (every process of a
    ``--coordinator`` run on one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    r = rank() if global_rank is None else global_rank
    return r % max(1, torch.cuda.device_count())


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_rank0() -> bool:
    return rank() == 0


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns it."""
    if is_initialized():
        with profiling.span("rgbnm.exchange.sums"):
            profiling.count("rgbnm.exchange.sums.bytes", t.numel() * t.element_size())
            dist.all_reduce(t)
    return t


def all_reduce_mean_(tensors: list[torch.Tensor]) -> None:
    """Average ``tensors`` (one dtype, one device) over the ranks in place,
    in one flat all-reduce: the gradient sync of one train step."""
    if not is_initialized():
        return
    with profiling.span("rgbnm.exchange.grads"):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        profiling.count("rgbnm.exchange.grads.bytes", flat.numel() * flat.element_size())
        dist.all_reduce(flat)
        flat /= world_size()
        torch._foreach_copy_(tensors, [v.view_as(t) for v, t in
                                       zip(flat.split([t.numel() for t in tensors]), tensors)])


def ring_roll(tensors: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
    """Each tensor rolled by one along its first axis over the global batch
    that the ranks' slices make in rank order, as ``jnp.roll(x, 1, axis=0)``
    rolls it in the JAX mixup (``rgbnomore_tpu/train/steps.py:39-51``): row 0
    of rank r takes rank r-1's last row, rank 0 the last rank's.  The last
    rows travel in one all-gather; without a process group it is
    ``torch.roll``.  The tensors share one dtype."""
    if not is_initialized():
        return tuple(torch.roll(t, 1, dims=0) for t in tensors)
    with profiling.span("rgbnm.exchange.mixup"):
        last = torch.cat([t[-1].reshape(-1) for t in tensors])
        profiling.count("rgbnm.exchange.mixup.bytes", last.numel() * last.element_size())
        gathered = [torch.empty_like(last) for _ in range(world_size())]
        dist.all_gather(gathered, last)
        prev = gathered[(rank() - 1) % world_size()]
        out = []
        for t, row in zip(tensors, prev.split([t[-1].numel() for t in tensors])):
            out.append(torch.cat([row.view_as(t[-1])[None], t[:-1]]))
        return tuple(out)
