"""Tree search: stepwise addition, distance trees, hill climbing, the
ratchet, supports (bootstrap, aLRT, UFBoot, topology tests, concordance),
likelihood climbs, model selection, consensus and tree distances, the
differentiable search loops, and the Bayesian samplers (MC^3 trees, node
dating, stepping-stone marginal likelihoods)."""

from trex_tpu_torch.search.alrt import BranchSupports, branch_supports

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
from trex_tpu_torch.search.concordance import (
    ConcordanceResult,
    concordance_factors,
    gene_concordance,
    site_concordance,
)
from trex_tpu_torch.search.dating import DatingResult, mcmc_date
from trex_tpu_torch.search.marginal import stepping_stone
from trex_tpu_torch.search.mcmc import McmcResult, mcmc_sample
from trex_tpu_torch.search.consensus import (
    consensus_topology,
    majority_rule_consensus,
    split_frequencies,
)
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
from trex_tpu_torch.search.topotest import TopologyTestResult, topology_tests
from trex_tpu_torch.search.treedist import (
    branch_score_distance,
    path_difference_distance,
    patristic_matrix,
    weighted_rf_distance,
)
from trex_tpu_torch.search.ufboot import UFBootResult, default_candidates, ultrafast_bootstrap

__all__ = [
    "BranchSupports",
    "ConcordanceResult",
    "DatingResult",
    "JointConfig",
    "McmcResult",
    "ModelFit",
    "RunnerConfig",
    "SearchResult",
    "TopologyTestResult",
    "UFBootResult",
    "bootstrap_analysis",
    "bootstrap_log_likelihoods",
    "bootstrap_scores",
    "bootstrap_site_weights",
    "branch_score_distance",
    "branch_supports",
    "compare_models",
    "concordance_factors",
    "consensus_topology",
    "constrained_start",
    "constraint_mask",
    "count_parameters",
    "default_candidates",
    "evaluate_solution",
    "extract_solution",
    "fit_topology",
    "gene_concordance",
    "init_params",
    "joint_optimize",
    "joint_search",
    "majority_rule_consensus",
    "make_optimizer",
    "mcmc_date",
    "mcmc_sample",
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
    "path_difference_distance",
    "patristic_matrix",
    "reconstruct_ancestors",
    "reconstruct_ancestors_landscape_aware",
    "rf_distance_unrooted",
    "robinson_foulds",
    "run_search",
    "site_concordance",
    "split_frequencies",
    "split_support",
    "spr_decay_support",
    "stepping_stone",
    "stepwise_addition",
    "stepwise_addition_multi",
    "subtree_leaf_sets",
    "topology_tests",
    "ultrafast_bootstrap",
    "unrooted_splits",
    "upgma",
    "weighted_rf_distance",
]
