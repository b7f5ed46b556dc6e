"""Exact NN-DTW search: index, tier pipeline, cascade and engine."""

from repro_torch.search.cascade import (
    CascadeConfig,
    CascadeResult,
    bands_prefilter,
    choose_survivor_budget,
    compute_bounds,
    enhanced_all_pairs,
    lb_kim_tier,
    run_plan,
)
from repro_torch.search.engine import (
    EngineConfig,
    SearchResult,
    brute_force,
    classify,
    nn_search,
)
from repro_torch.search.index import (
    DTWIndex,
    build_index,
    index_from_numpy,
    kim_features,
    validate_series,
)
from repro_torch.search.pipeline import (
    BoundTier,
    Compaction,
    VerificationPlan,
    default_plan,
    dense_plan,
    get_tier,
    register_tier,
)

__all__ = [
    "BoundTier", "CascadeConfig", "CascadeResult", "Compaction",
    "DTWIndex", "EngineConfig", "SearchResult", "VerificationPlan",
    "bands_prefilter", "brute_force", "build_index",
    "choose_survivor_budget", "classify", "compute_bounds", "default_plan",
    "dense_plan", "enhanced_all_pairs", "get_tier", "index_from_numpy",
    "kim_features", "lb_kim_tier", "nn_search", "register_tier",
    "run_plan", "validate_series",
]
