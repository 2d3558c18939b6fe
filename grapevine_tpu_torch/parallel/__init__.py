"""Multi-device parallelism: device mesh, state shardings, sharded engine
step (port of ``grapevine_tpu/parallel/``).

The scale axis shards the two ORAM bucket trees across a device mesh, so
bus capacity grows with the mesh's device memory (SURVEY.md §2c,
BASELINE config 5).
"""

from .mesh import (
    REPLICATED,
    SHARDED,
    TREE_AXIS,
    Mesh,
    engine_state_specs,
    init_sharded_engine,
    make_mesh,
    make_sharded_flush,
    make_sharded_step,
    shard_engine_state,
    unshard_engine_state,
    unshard_oram,
    validate_sharded_geometry,
)

__all__ = [
    "REPLICATED",
    "SHARDED",
    "TREE_AXIS",
    "Mesh",
    "engine_state_specs",
    "init_sharded_engine",
    "make_mesh",
    "make_sharded_flush",
    "make_sharded_step",
    "shard_engine_state",
    "unshard_engine_state",
    "unshard_oram",
    "validate_sharded_geometry",
]
