"""Data parallelism over torch.distributed (see parallel/mesh.py)."""

from dmm_net_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_gather_rows,
    all_reduce_sum,
    all_reduce_sum_,
    launch,
    make_mesh,
    replicate_,
    shard_batch,
    visible_ranks,
)
