"""Distributed communication backend: mesh construction + named collectives.

The reference is entirely single-process (SURVEY.md section 2); this package
supplies the scaling dimension: ``jax.sharding.Mesh`` over the devices,
with the collective set (psum / all_gather / ppermute / all_to_all) wrapped
in one module so the choice is swappable and CPU-testable on a virtual
8-device mesh.
"""

from qkan_implementation.parallel.mesh import (
    make_mesh,
    device_count,
    shard_batch,
)
from qkan_implementation.parallel.collectives import (
    psum,
    pmean,
    all_gather,
    ppermute,
    all_to_all,
    pairwise_exchange,
)
from qkan_implementation.parallel.tp import (
    kan_apply_tp,
    make_tp_train_step,
    shard_params,
)
from qkan_implementation.parallel.pp import (
    kan_apply_pp,
    make_pp_train_step,
    place_pipeline_params,
    stack_pipeline_params,
)

__all__ = [
    "kan_apply_tp",
    "make_tp_train_step",
    "shard_params",
    "kan_apply_pp",
    "make_pp_train_step",
    "place_pipeline_params",
    "stack_pipeline_params",
    "make_mesh",
    "device_count",
    "shard_batch",
    "psum",
    "pmean",
    "all_gather",
    "ppermute",
    "all_to_all",
    "pairwise_exchange",
]
