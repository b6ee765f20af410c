"""Runtime: the LC trainer with its fault-tolerance policies, compressed
weight forms, the batch server, the continuous-batching engine and the
LC-state bridge (port of ``src/repro/runtime``)."""
from repro_torch.runtime.fault_tolerance import (
    FaultInjector, RetryPolicy, StragglerMonitor)
from repro_torch.runtime.trainer import LCTrainer, TrainerConfig
from repro_torch.runtime.compressed import (
    LowRankWeight, QuantizedWeight, SparseWeight, tree_weight_bytes,
    weight_form_bytes)
from repro_torch.runtime.server import (
    FinishedRequest, Request, Server, ServingEngine, densified_for_serving,
    load_compressed_for_serving)

__all__ = [
    "FaultInjector", "RetryPolicy", "StragglerMonitor", "LCTrainer",
    "TrainerConfig",
    "LowRankWeight", "QuantizedWeight", "SparseWeight", "tree_weight_bytes",
    "weight_form_bytes", "FinishedRequest", "Request", "Server",
    "ServingEngine", "densified_for_serving", "load_compressed_for_serving",
]
