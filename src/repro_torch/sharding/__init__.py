"""Placement of the port on a device mesh: logical-axis rules resolved to
DTensor placements (``logical``) and the pipeline schedule over a 'pipe'
mesh axis (``pipeline``)."""
from .logical import (AxisRules, TRAIN_RULES, INFER_RULES, TRAIN_RULES_V2,
                      INFER_RULES_V2, SP_TRAIN_RULES, resolve_spec,
                      to_placements, logical_sharding, constrain,
                      MeshSharding, flat_rank, local_slice, place,
                      SUM, on_shards, shard_dims, split_dims)
from .pipeline import pipeline_apply, sequential_reference
