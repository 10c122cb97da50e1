"""Data parallelism over ``torch.distributed``: one process per GPU, the
gradients averaged over NCCL (gloo on the CPU).  The counterpart of
``rgbnomore_tpu/parallel/mesh.py``, whose SPMD mesh the reference's DDP
trainer (``train.py:272-294``) replaced; see ``parallel/dist.py``."""

from rgbnomore_tpu_torch.parallel.dist import (
    all_reduce_mean_,
    all_reduce_sum_,
    barrier,
    init_distributed,
    is_initialized,
    is_rank0,
    local_rank,
    rank,
    ring_roll,
    world_size,
)

__all__ = ["all_reduce_mean_", "all_reduce_sum_", "barrier", "init_distributed",
           "is_initialized", "is_rank0", "local_rank", "rank", "ring_roll", "world_size"]
