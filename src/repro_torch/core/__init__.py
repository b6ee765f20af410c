"""The LC algorithm in PyTorch (port of ``src/repro/core``)."""
from repro_torch.core.algorithm import (
    LCAlgorithm, LCMetrics, exponential_mu_schedule)
from repro_torch.core.tasks import (
    CompressionTask, check_disjoint, flatten_params, get_path, set_path)
from repro_torch.core.views import AsVector, AsIs, AsMatrix, AsStacked
from repro_torch.core.penalty import lc_penalty, lc_penalty_grad_refs
from repro_torch.core.grouping import build_groups, describe_groups
from repro_torch.core import schemes

__all__ = [
    "LCAlgorithm", "LCMetrics", "exponential_mu_schedule",
    "CompressionTask", "check_disjoint", "flatten_params", "get_path",
    "set_path", "AsVector", "AsIs", "AsMatrix", "AsStacked",
    "lc_penalty", "lc_penalty_grad_refs", "schemes",
    "build_groups", "describe_groups",
]
