"""A cell on several cards: one process per card, joined in a process group.

The parent starts one worker per card (``spawn``); each joins the group at
``tcp://localhost:<port>`` with its rank (NCCL on the card with its shared
memory transport off, so the peers talk over NVLink; gloo on the CPU),
runs the cell on its card (``cell.run_cell`` takes its slice of every
global batch) and sends back what it found in ``sys.modules``; rank 0 sends
the result too.  The parent waits for every worker to end.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import sys

__all__ = ["run_ranks"]

WAIT_S = 330


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, args: dict, out) -> None:
    import torch
    import torch.distributed as dist

    from cell import run_cell
    from faults import FAULTS
    from run import forbidden_modules

    try:
        os.environ.setdefault("NCCL_SHM_DISABLE", "1")  # peers over NVLink; no /dev/shm
        device = args["device"]
        if device == "cuda":
            torch.cuda.set_device(rank)
            device = f"cuda:{rank}"
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("nccl" if device != "cpu" else "gloo",
                                init_method=f"tcp://localhost:{port}", world_size=world,
                                rank=rank)
        fault = FAULTS.get(args.get("fault"))
        run = run_cell(args["workload"], args["seed"], args["seconds"], args["trace"],
                       t_start=args["t_start"], device=device, chips=world,
                       manifest=args.get("manifest"), tamper=fault)
        dist.destroy_process_group()
        out.put((rank, forbidden_modules(), run.result() if rank == 0 else None))
    except BaseException as exc:  # noqa: BLE001 - reported to the parent, which fails
        out.put((rank, None, f"{type(exc).__name__}: {exc}"))
        raise


def run_ranks(world: int, **args) -> tuple[dict | None, list[str], str | None]:
    """Run the cell over ``world`` ranks: (rank 0's result, the forbidden
    modules any process loaded, the first error)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, args, out)) for r in range(world)]
    for p in procs:
        p.start()
    result, found, error = None, set(), None
    try:
        for _ in range(world):
            rank, mods, payload = out.get(timeout=WAIT_S)
            if mods is None:
                error = error or f"rank {rank}: {payload}"
                break
            found |= set(mods)
            if rank == 0:
                result = payload
    except queue.Empty:
        error = error or "a rank sent nothing"
    finally:
        for p in procs:
            p.join(timeout=30 if error is None else 5)
            if p.is_alive():
                p.terminate()
                p.join()
    from run import forbidden_modules

    found |= set(forbidden_modules(sys.modules))
    return result, sorted(found), error
