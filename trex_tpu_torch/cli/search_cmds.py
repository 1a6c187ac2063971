"""Search and benchmark commands (counterpart of
``trex_tpu/cli/search_cmds.py``):

- ``search``: the multi-restart joint topology + sequence search on a
  generated balanced mutation tree, against exact Sankoff on the true tree;
- ``search-run``: the same search checkpointed and resumable
  (``search.runner``);
- ``bench``: batched candidate-scoring throughput of
  ``ops.dispatch.batched_scores_fastest`` on random trees — K1 for Hamming
  with at most 32 states, K5 above (``--states 61``, the codon alphabet);
- ``nk-bench``: ancestor accuracy of exact Sankoff against gradient ASR,
  plain and landscape-aware, on trees evolved over NK landscapes;
- ``ml``: the ML climb (JC69, enumerated SPR neighbourhoods ranked by the
  likelihood kernel, then the Newton fit) from a random tree on a
  generated balanced mutation tree's leaves;
- ``bootstrap``: parsimony bootstrap split supports of the balanced tree
  on a generated mutation tree's leaves (``search.bootstrap.
  bootstrap_analysis``: each replicate an NNI climb scored through
  ``ops.dispatch``, K1 for Hamming), and the replicates' majority-rule
  consensus.

Each prints the JAX command's JSON keys. Generated data comes from the
port's own generators (``torch.Generator``s seeded with ``--seed``), so the
numbers follow the reference's regimes, not the JAX package's draws.
"""

from __future__ import annotations

import importlib.util
import json
import sys

import torch

from trex_tpu_torch._device import resolve_device


def bench_inputs(args, device: torch.device):
    """(topologies, cost, leaves) of a ``bench`` run: ``--batch`` random
    trees (``random_topologies(--seed)``, the JAX command's trees), the
    Hamming cost and uniform int32 leaf states drawn from ``--seed + 1``."""
    from trex_tpu_torch.topology import random_topologies
    from trex_tpu_torch.types import CostModel

    topos = random_topologies(args.seed, args.leaves, args.batch, device)
    cost = CostModel.hamming(args.states, device=device).matrix
    generator = torch.Generator().manual_seed(args.seed + 1)
    leaves = torch.randint(
        0, args.states, (args.leaves, args.sites), generator=generator, dtype=torch.int32
    )
    return topos, cost, leaves.to(device)


def run_bench(args) -> tuple[dict, torch.Tensor]:
    """The printed JSON object of ``bench`` and the batch's (B,) scores."""
    from trex_tpu_torch.ops.dispatch import batched_scores_fastest, check_alphabet
    from trex_tpu_torch.utils.profiling import timed

    device = resolve_device(args.device)
    topos, cost, leaves = bench_inputs(args, device)
    check_alphabet(cost, leaves)
    mean_s, scores = timed(
        batched_scores_fastest, topos, cost, leaves, device=device, reps=args.reps
    )
    out = {
        "metric": f"tree evals/s ({args.leaves} taxa, {args.sites} sites)",
        "value": round(args.batch / mean_s, 1),
        "unit": "trees/s",
        "batch": args.batch,
        "ms_per_batch": round(mean_s * 1e3, 3),
    }
    return out, scores


def cmd_bench(args) -> None:
    print(json.dumps(run_bench(args)[0]))


def _generated(args, device: torch.device):
    """(ground truth, (n, L) int32 leaves, one-hot leaf tensor, Hamming
    cost) of the balanced mutation tree the search commands share."""
    from trex_tpu_torch.cli._common import one_hot_leaves
    from trex_tpu_torch.models.mutation_tree import generate_groundtruth
    from trex_tpu_torch.types import CostModel

    gt = generate_groundtruth(
        args.leaves, args.states, args.mutations, args.sites, seed=args.seed, device=device
    )
    leaf = gt.all_sequences[: args.leaves].to(torch.int32)
    cost = CostModel.hamming(args.states, device=device).matrix
    return gt, leaf, one_hot_leaves(leaf, args.states), cost


def run_ml(args) -> tuple[dict, tuple]:
    """The printed JSON object of ``ml``, and (start, (n, L) leaves) it
    climbed from."""
    from trex_tpu_torch.io import sample_topologies, save_newick
    from trex_tpu_torch.search.ml import ml_hill_climb
    from trex_tpu_torch.topology import Topology

    device = resolve_device(args.device)
    _, leaf, _, _ = _generated(args, device)
    sampled = sample_topologies(args.seed, args.leaves, 1, device)
    start = Topology(sampled.children[0], sampled.parents[0])
    result, lengths, losses = ml_hill_climb(start, leaf, args.states, max_rounds=args.rounds)
    return {
        "final_neg_log_likelihood": float(losses[-1]),
        "ranking_score": result.score,
        "evaluations": result.evaluations,
        "tree": save_newick(result.topology),
        "mean_branch_length": float(lengths.mean()),
    }, (start, leaf)


def cmd_ml(args) -> None:
    print(json.dumps(run_ml(args)[0]))


def run_bootstrap(args) -> tuple[dict, list]:
    """The printed JSON object of ``bootstrap`` and the replicates' best
    topologies; the replicates are drawn from a CPU generator seeded
    ``--seed`` (the JAX command's key)."""
    from trex_tpu_torch.search.bootstrap import bootstrap_analysis
    from trex_tpu_torch.search.consensus import majority_rule_consensus
    from trex_tpu_torch.topology import balanced_topology

    device = resolve_device(args.device)
    _, leaf, _, cost = _generated(args, device)
    support, best = bootstrap_analysis(
        balanced_topology(args.leaves, device), cost, leaf,
        n_replicates=args.replicates, search_rounds=args.search_rounds,
        generator=torch.Generator().manual_seed(args.seed), device=device,
    )
    newick, _ = majority_rule_consensus(best)
    return {
        "mean_support": float(support.mean()),
        "per_clade_support": [round(float(x), 3) for x in support],
        "consensus_newick": newick,
    }, best


def cmd_bootstrap(args) -> None:
    print(json.dumps(run_bootstrap(args)[0]))


def run_search(args) -> dict:
    """The printed JSON object of ``search``."""
    from trex_tpu_torch.ops.sankoff import sankoff_score
    from trex_tpu_torch.search.joint import JointConfig, joint_search
    from trex_tpu_torch.topology import balanced_topology
    from trex_tpu_torch.utils.metrics import MetricsLogger

    device = resolve_device(args.device)
    _, leaf, leaf_tensor, cost = _generated(args, device)
    oracle = sankoff_score(balanced_topology(args.leaves, device), cost, leaf)
    cfg = JointConfig(n_iterations=args.iterations, learning_rate=args.lr)
    _, losses, score = joint_search(
        leaf_tensor, cost, cfg, n_restarts=args.restarts,
        generator=torch.Generator(device).manual_seed(args.seed),
    )
    with MetricsLogger(args.metrics_file) as log:
        log.log(args.iterations, loss=float(losses[-1]), best_discrete_score=float(score),
                sankoff_oracle=float(oracle))
    return {
        "best_discrete_score": float(score),
        "sankoff_oracle_on_true_tree": float(oracle),
        "final_loss": float(losses[-1]),
    }


def cmd_search(args) -> None:
    print(json.dumps(run_search(args)))


def run_search_run(args) -> tuple[dict, dict[str, torch.Tensor]]:
    """The printed JSON object of ``search-run`` and the final params."""
    from trex_tpu_torch.search.joint import JointConfig
    from trex_tpu_torch.search.runner import RunnerConfig
    from trex_tpu_torch.search.runner import run_search as run_checkpointed

    device = resolve_device(args.device)
    _, _, leaf_tensor, _ = _generated(args, device)
    cfg = RunnerConfig(
        workdir=args.workdir, n_iterations=args.iterations,
        checkpoint_every=args.checkpoint_every, seed=args.seed,
        joint=JointConfig(n_iterations=args.iterations, learning_rate=args.lr),
    )
    params = run_checkpointed(cfg, leaf_tensor, resume=not args.no_resume)
    return {"workdir": args.workdir, "steps": args.iterations}, params


def cmd_search_run(args) -> None:
    """Checkpointed, resumable joint search (see ``search.runner``)."""
    print(json.dumps(run_search_run(args)[0]))


def run_nk_bench(args) -> dict:
    """The printed JSON object of ``nk-bench``: for each K, the ancestor
    accuracy of exact Sankoff and of gradient ASR at each lambda (a plain
    value, or mean and std over ``--replicates`` landscapes). Each K's raw
    cells go to stderr as they finish; ``--plot`` writes the errorbar
    figure."""
    from trex_tpu_torch.models.nk import evolve_tree, make_landscape
    from trex_tpu_torch.ops.sankoff import sankoff_reconstruct
    from trex_tpu_torch.search.asr import (
        reconstruct_ancestors,
        reconstruct_ancestors_landscape_aware,
    )
    from trex_tpu_torch.topology import balanced_topology, topology_to_adjacency
    from trex_tpu_torch.types import CostModel

    if args.plot and importlib.util.find_spec("matplotlib") is None:
        raise SystemExit("nk-bench --plot needs matplotlib, which is not installed")
    device = resolve_device(args.device)
    generator = torch.Generator(device).manual_seed(args.seed)
    reps = max(1, args.replicates)
    topo = balanced_topology(args.leaves, device)
    adjacency = topology_to_adjacency(topo)
    n_all = 2 * args.leaves - 1
    cost = CostModel.hamming(2, device=device).matrix

    def accuracy(recon, truth) -> float:
        return float((recon == truth).to(torch.float32).mean())

    raw: dict[int, dict[str, list[float]]] = {}
    for k_epi in args.k_values:
        cells: dict[str, list[float]] = {"sankoff": []}
        for lam in args.lambdas:
            cells[f"gradient_asr(lambda={lam})"] = []
        for _ in range(reps):
            landscape = make_landscape(args.sites, k_epi, generator, n_states=2)
            root = torch.randint(0, 2, (args.sites,), generator=generator, device=device)
            seqs = evolve_tree(landscape, topo, root, args.mutation_rate, generator,
                               branch_length=args.branch_length)
            leaf, truth = seqs[: args.leaves], seqs[args.leaves:]
            recon, _, _ = sankoff_reconstruct(topo, cost, leaf)
            cells["sankoff"].append(accuracy(recon[args.leaves:], truth))
            for lam in args.lambdas:
                if lam == 0.0:
                    learned = reconstruct_ancestors(
                        leaf, n_all, 2, adjacency, generator, n_iterations=args.iterations)
                else:
                    learned = reconstruct_ancestors_landscape_aware(
                        leaf, n_all, 2, landscape, lam, adjacency, generator,
                        n_iterations=args.iterations)
                cells[f"gradient_asr(lambda={lam})"].append(accuracy(learned, truth))
        raw[k_epi] = cells
        print(json.dumps({f"K={k_epi}": cells}), file=sys.stderr)

    def summary(vals: list[float]):
        if reps == 1:
            return vals[0]
        mean = sum(vals) / len(vals)
        var = sum((v - mean) ** 2 for v in vals) / len(vals)
        return {"mean": mean, "std": var**0.5}

    if args.plot:
        _nk_bench_plot(args.plot, raw, args.lambdas)
    return {
        f"K={k}": {label: summary(vals) for label, vals in cells.items()}
        for k, cells in raw.items()
    }


def cmd_nk_bench(args) -> None:
    """NK accuracy benchmark: Sankoff vs gradient ASR over lambda values."""
    print(json.dumps(run_nk_bench(args)))


def _nk_bench_plot(path: str, raw, lambdas) -> None:
    """Errorbar figure: accuracy vs lambda per K, Sankoff mean dashed."""
    import matplotlib
    import numpy as np

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.5))
    for k_epi, cells in raw.items():
        accs = np.array([cells[f"gradient_asr(lambda={lam})"] for lam in lambdas])
        line = ax.errorbar(
            lambdas, accs.mean(axis=1),
            yerr=accs.std(axis=1) if accs.shape[1] > 1 else None,
            marker="o", capsize=3, label=f"TREX K={k_epi}",
        )
        ax.axhline(np.mean(cells["sankoff"]), linestyle="--", linewidth=1,
                   color=line.lines[0].get_color(), alpha=0.6)
    ax.set_xlabel("landscape weight λ")
    ax.set_ylabel("ancestor reconstruction accuracy")
    ax.set_title("NK benchmark: gradient ASR vs exact Sankoff (dashed)")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
