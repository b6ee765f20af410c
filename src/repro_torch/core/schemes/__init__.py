from repro_torch.core.schemes.base import (
    CompressionScheme, add_leading_axis, drop_leading_axis, map_items,
    pack_thetas, pack_thetas_padded, slice_theta_like, unpack_thetas)
from repro_torch.core.schemes.quantize import (
    AdaptiveQuantization, Binarize, QuantTheta, Ternarize, kmeans_1d,
    optimal_codebook_dp, quantile_init)
from repro_torch.core.schemes.additive import AdditiveCombination
from repro_torch.core.schemes.lowrank import (
    LowRank, RankSelection, exact_svd, randomized_svd)
from repro_torch.core.schemes.prune import (
    ConstraintL0Pruning, ConstraintL1Pruning, PenaltyL0Pruning,
    PenaltyL1Pruning, project_l1_ball, topk_magnitude_mask)

__all__ = [
    "CompressionScheme", "add_leading_axis", "drop_leading_axis",
    "map_items", "pack_thetas", "pack_thetas_padded", "slice_theta_like",
    "unpack_thetas",
    "AdaptiveQuantization", "Binarize", "QuantTheta", "Ternarize",
    "kmeans_1d", "optimal_codebook_dp", "quantile_init",
    "ConstraintL0Pruning", "ConstraintL1Pruning", "PenaltyL0Pruning",
    "PenaltyL1Pruning", "project_l1_ball", "topk_magnitude_mask",
    "AdditiveCombination", "LowRank", "RankSelection", "exact_svd",
    "randomized_svd",
]
