"""The sharding layer's data axis (port of ``src/repro/distributed``)."""
from repro_torch.distributed.sharding import (
    DEFAULT_RULES, PRIORITY, SERVE_RULES, active_mesh, batch_axes,
    constrain, gather_items, items_partition, match_shardings, resolve_spec,
    shard_bounds, tree_shardings, use_mesh)

__all__ = [
    "DEFAULT_RULES", "PRIORITY", "SERVE_RULES", "active_mesh", "batch_axes",
    "constrain", "gather_items", "items_partition", "match_shardings",
    "resolve_spec", "shard_bounds", "tree_shardings", "use_mesh",
]
