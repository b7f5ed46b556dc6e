"""Plain PyTorch DTW, envelopes and lower bounds (``repro.core``'s port)."""

from repro_torch.core.distances import (
    delta,
    squared_euclidean,
    squared_euclidean_matrix,
    znorm,
)
from repro_torch.core.dtw import (
    cost_matrix,
    dtw,
    dtw_band_blocked,
    dtw_batch,
    dtw_pairs,
    row_block_policy,
)
from repro_torch.core.envelopes import envelope, envelope_naive, sliding_reduce
from repro_torch.core.lower_bounds import (
    BOUND_NAMES,
    get_bound,
    lb_enhanced,
    lb_enhanced_bands,
    lb_enhanced_env,
    lb_enhanced_matrix,
    lb_improved,
    lb_keogh,
    lb_keogh_env,
    lb_keogh_matrix,
    lb_kim,
    lb_kim_paper,
    lb_new,
    lb_yi,
)

__all__ = [
    "BOUND_NAMES",
    "cost_matrix",
    "delta",
    "dtw",
    "dtw_band_blocked",
    "dtw_batch",
    "dtw_pairs",
    "row_block_policy",
    "envelope",
    "envelope_naive",
    "get_bound",
    "lb_enhanced",
    "lb_enhanced_bands",
    "lb_enhanced_env",
    "lb_enhanced_matrix",
    "lb_improved",
    "lb_keogh",
    "lb_keogh_env",
    "lb_keogh_matrix",
    "lb_kim",
    "lb_kim_paper",
    "lb_new",
    "lb_yi",
    "sliding_reduce",
    "squared_euclidean",
    "squared_euclidean_matrix",
    "znorm",
]
