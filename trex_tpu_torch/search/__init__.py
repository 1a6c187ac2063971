"""Tree search: stepwise addition, distance trees, hill climbing, the
ratchet, supports, likelihood climbs, model selection and the
differentiable search loops."""

from trex_tpu_torch.search.asr import (
    parental_logits,
    reconstruct_ancestors,
    reconstruct_ancestors_landscape_aware,
)
from trex_tpu_torch.search.bootstrap import (
    bootstrap_analysis,
    bootstrap_log_likelihoods,
    bootstrap_scores,
    bootstrap_site_weights,
    ml_bootstrap_analysis,
    split_support,
    subtree_leaf_sets,
)
from trex_tpu_torch.search.bremer import spr_decay_support
from trex_tpu_torch.search.hillclimb import (
    SearchResult,
    constrained_start,
    constraint_mask,
    parsimony_hill_climb,
)
from trex_tpu_torch.search.joint import (
    JointConfig,
    evaluate_solution,
    extract_solution,
    fit_topology,
    init_params,
    joint_optimize,
    joint_search,
)
from trex_tpu_torch.search.ml import (
    ml_hill_climb,
    ml_iterated_search,
    ml_partitioned_scan_climb,
)
from trex_tpu_torch.search.model_select import ModelFit, compare_models, count_parameters
from trex_tpu_torch.search.nj import (
    neighbor_joining,
    nj_bootstrap,
    nj_start_tree,
    upgma,
)
from trex_tpu_torch.search.optimizers import make_optimizer
from trex_tpu_torch.search.ratchet import (
    parsimony_ratchet,
    rf_distance_unrooted,
    robinson_foulds,
    unrooted_splits,
)
from trex_tpu_torch.search.runner import RunnerConfig, run_search
from trex_tpu_torch.search.stepwise import stepwise_addition, stepwise_addition_multi

__all__ = [
    "JointConfig",
    "ModelFit",
    "RunnerConfig",
    "SearchResult",
    "bootstrap_analysis",
    "bootstrap_log_likelihoods",
    "bootstrap_scores",
    "bootstrap_site_weights",
    "compare_models",
    "constrained_start",
    "constraint_mask",
    "count_parameters",
    "evaluate_solution",
    "extract_solution",
    "fit_topology",
    "init_params",
    "joint_optimize",
    "joint_search",
    "make_optimizer",
    "ml_bootstrap_analysis",
    "ml_hill_climb",
    "ml_iterated_search",
    "ml_partitioned_scan_climb",
    "neighbor_joining",
    "nj_bootstrap",
    "nj_start_tree",
    "parental_logits",
    "parsimony_hill_climb",
    "parsimony_ratchet",
    "reconstruct_ancestors",
    "reconstruct_ancestors_landscape_aware",
    "rf_distance_unrooted",
    "robinson_foulds",
    "run_search",
    "spr_decay_support",
    "split_support",
    "stepwise_addition",
    "stepwise_addition_multi",
    "subtree_leaf_sets",
    "unrooted_splits",
    "upgma",
]
