"""The sharding layer: the data axis and the tensor-parallel "model"
axis (port of ``src/repro/distributed``)."""
from repro_torch.distributed.sharding import (
    DEFAULT_RULES, PRIORITY, SERVE_RULES, active_mesh, batch_axes,
    constrain, copy_to_model, gather_from_model, gather_items,
    gather_params, gather_train_state, items_partition, match_shardings,
    param_layout, reduce_from_model, resolve_spec, shard_bounds,
    shard_params, shard_train_state, tree_shardings, use_mesh)

__all__ = [
    "DEFAULT_RULES", "PRIORITY", "SERVE_RULES", "active_mesh", "batch_axes",
    "constrain", "copy_to_model", "gather_from_model", "gather_items",
    "gather_params", "gather_train_state", "items_partition",
    "match_shardings", "param_layout", "reduce_from_model", "resolve_spec",
    "shard_bounds", "shard_params", "shard_train_state", "tree_shardings",
    "use_mesh",
]
