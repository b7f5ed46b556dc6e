"""Exact NN-DTW search: index, tier pipeline, cascade, planner, guards,
engine and distributed search."""

from repro_torch.search.cascade import (
    CascadeConfig,
    CascadeResult,
    bands_prefilter,
    choose_survivor_budget,
    compute_bounds,
    enhanced_all_pairs,
    lb_kim_tier,
    run_plan,
    staged_bounds,
)
from repro_torch.search.distributed import (
    calibrate_distributed_plan,
    gather_tier_stats,
    make_distributed_search,
    shard_index,
)
from repro_torch.search.engine import (
    EngineConfig,
    SearchResult,
    SearchStats,
    brute_force,
    classify,
    nn_search,
)
from repro_torch.search.guards import (
    GuardConfig,
    GuardReport,
    GuardWarning,
    preflight_engine,
    validate_series,
)
from repro_torch.search.index import (
    DTWIndex,
    build_index,
    index_from_numpy,
    kim_features,
    sketch_features,
)
from repro_torch.search.pipeline import (
    BoundTier,
    Compaction,
    TierStats,
    VerificationPlan,
    default_plan,
    dense_plan,
    get_tier,
    list_tiers,
    register_tier,
    registered_tiers,
    tier_cost_weight,
    unregister_tier,
)
from repro_torch.search.planner import (
    PlanDecision,
    PlannerConfig,
    calibrate_plan,
    optimise_plan,
)

__all__ = [
    "BoundTier", "CascadeConfig", "CascadeResult", "Compaction",
    "DTWIndex", "EngineConfig", "GuardConfig", "GuardReport",
    "GuardWarning", "PlanDecision", "PlannerConfig", "SearchResult",
    "SearchStats", "TierStats", "VerificationPlan", "bands_prefilter",
    "brute_force", "build_index", "calibrate_distributed_plan",
    "calibrate_plan",
    "choose_survivor_budget", "classify", "compute_bounds", "default_plan",
    "dense_plan", "enhanced_all_pairs", "gather_tier_stats", "get_tier",
    "index_from_numpy", "kim_features", "lb_kim_tier", "list_tiers",
    "make_distributed_search", "nn_search",
    "optimise_plan", "preflight_engine", "register_tier",
    "registered_tiers", "run_plan", "shard_index", "sketch_features",
    "staged_bounds",
    "tier_cost_weight",
    "unregister_tier", "validate_series",
]
