"""Spatial domain decomposition over torch.distributed ranks (dist) and
the launcher of a world of ranks on one host (launch)."""

from sph_tpu_torch.parallel.dist import (  # noqa: F401
    Mesh,
    exchange_halo,
    make_sharded_dense_step,
    shard_dense_state,
    unshard_dense_state,
)
from sph_tpu_torch.parallel.launch import spawn  # noqa: F401
