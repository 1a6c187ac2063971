"""The ``score`` command's parsimony branches (counterpart of ``cmd_score``
in ``trex_tpu/cli/score.py``).

- Generated data: a balanced mutation tree (``models.mutation_tree``),
  exact Sankoff scoring and reconstruction of its ancestors under the
  Hamming cost (``ops.sankoff.sankoff_reconstruct``), and the share of
  ancestral states that match the truth.
- ``--alignment``: the tree of ``--tree`` (or a stepwise-addition tree),
  its Fitch score and one optimal labeling (``ops.fitch.fitch_reconstruct``),
  optionally written to ``--output-fasta``.

Both print the JAX command's JSON keys. ``--alignment --criterion ml``
fits the branch lengths (Adam, JC69) or, with ``--model``, the whole model
(``ops.likelihood.optimize_model``), then reconstructs the ancestors by
their marginal posteriors or (``--asr joint``) jointly, and with
``--site-rates`` writes each site's posterior mean rate.

``trait`` (counterpart of ``cmd_trait``) fits an Mk rate multiplier of a
given tree's branch lengths by golden-section search and labels its
ancestors with their marginal posteriors.

``asr`` (counterpart of ``cmd_asr``) reconstructs the ancestors of a
generated balanced mutation tree by exact Sankoff and by gradient descent
(``search.asr.reconstruct_ancestors``, initial logits from a generator
seeded with ``--seed``) and prints each one's identity with the truth.

``treedraw`` renders a newick tree in ASCII (``io.format_tree``) and
``stats`` summarises an alignment (site classes, composition, missing
data); both are host numpy, as their JAX counterparts.
"""

from __future__ import annotations

import json

import torch

from trex_tpu_torch._device import resolve_device
from trex_tpu_torch.cli._common import _load_alignment


def _score_alignment(args, device: torch.device) -> dict:
    from trex_tpu_torch.io import DNA, PROTEIN, align_leaf_order, load_newick, write_fasta
    from trex_tpu_torch.ops.fitch import fitch_reconstruct
    from trex_tpu_torch.search.stepwise import stepwise_addition

    names, masks, n_states = _load_alignment(args.fasta, args.alphabet)
    if args.tree:
        with open(args.tree) as fh:
            topo, _, tree_names = load_newick(fh.read(), device)
        if sorted(tree_names) != sorted(names):
            raise SystemExit("tree and alignment taxa differ")
        topo = align_leaf_order(topo, tree_names, names)
    else:
        topo, _ = stepwise_addition(
            masks, n_states, sequences_are_masks=True, seed=args.seed, device=device
        )
    out = {
        "n_taxa": len(names),
        "n_sites": int(masks.shape[1]),
        "tree_source": args.tree or "stepwise addition",
    }
    if args.criterion == "ml":
        recon = _score_ml(args, out, names, topo, torch.as_tensor(masks, device=device),
                          n_states)
    else:
        recon, score = fitch_reconstruct(
            topo, torch.as_tensor(masks, device=device), n_states, sequences_are_masks=True
        )
        out["parsimony_score"] = float(score)
    if args.output_fasta:
        alphabet = {"dna": DNA, "protein": PROTEIN}[args.alphabet]
        anc_names = names + [f"anc{i}" for i in range(len(names) - 1)]
        with open(args.output_fasta, "w") as fh:
            fh.write(write_fasta(anc_names, recon, alphabet))
        out["output_fasta"] = args.output_fasta
    return out


def _score_ml(args, out: dict, names, topo, masks: torch.Tensor, n_states: int):
    """``score --criterion ml``: fit, log-likelihood, ancestors (marginal or
    joint), site rates; records them in ``out`` and returns the (n_all, L)
    reconstructed states."""
    import numpy as np

    from trex_tpu_torch.io import parse_paml_rates
    from trex_tpu_torch.ops.likelihood import (
        optimize_branch_lengths,
        optimize_model,
        posterior_site_rates,
        tree_log_likelihood,
    )
    from trex_tpu_torch.ops.likelihood_asr import (
        joint_ancestral_reconstruction,
        marginal_ancestral_posteriors,
    )

    rates = freqs = None
    params: dict = {}
    if args.model != "jc":
        fixed_rates = fixed_freqs = None
        if args.model_file:
            with open(args.model_file) as fh:
                fixed_rates, fixed_freqs = parse_paml_rates(fh.read(), n_states)
        params, _ = optimize_model(
            topo, masks, n_states, model=args.model, sequences_are_masks=True,
            fixed_rates=fixed_rates, fixed_freqs=fixed_freqs,
        )
        lengths = params["branch_lengths"]
        if "rates" in params:
            rates, freqs = params["rates"], params["freqs"]
        out["model"] = args.model
    else:
        lengths, _ = optimize_branch_lengths(topo, masks, n_states, sequences_are_masks=True)
    posteriors, recon = marginal_ancestral_posteriors(
        topo, lengths, masks, n_states, rates, freqs, sequences_are_masks=True)
    if args.asr == "joint":
        recon, joint_lp = joint_ancestral_reconstruction(
            topo, lengths, masks, n_states, rates, freqs, sequences_are_masks=True)
        out["joint_log_probability"] = float(joint_lp.sum())
    ll = tree_log_likelihood(topo, lengths, masks, n_states, rates=rates, freqs=freqs,
                             sequences_are_masks=True)
    anc_conf = posteriors.amax(dim=1)[len(names):]
    out.update(
        log_likelihood=float(ll),
        mean_branch_length=float(lengths[:-1].mean()),
        mean_ancestor_posterior=float(anc_conf.mean()),
    )
    if args.site_rates:
        if args.model == "jc" or ("gamma_shape" not in params and "category_rates" not in params):
            raise SystemExit(
                "--site-rates needs a rate-mixture model (e.g. --model gtr+g or gtr+r3)"
            )
        mean_rates, _ = posterior_site_rates(
            topo, lengths, masks, n_states, params.get("gamma_shape", 1.0),
            rates=rates, freqs=freqs, category_rates=params.get("category_rates"),
            category_weights=params.get("category_weights"), sequences_are_masks=True,
        )
        with open(args.site_rates, "w") as fh:
            fh.write("site\tmean_rate\n")
            for i, r in enumerate(mean_rates.cpu().numpy()):
                fh.write(f"{i + 1}\t{r:.6f}\n")
        out["site_rates"] = args.site_rates
        out["mean_site_rate"] = float(mean_rates.mean())
    return recon


def run_score(args) -> dict:
    """The printed JSON object of ``score``."""
    from trex_tpu_torch.models.mutation_tree import generate_groundtruth
    from trex_tpu_torch.ops.sankoff import sankoff_reconstruct
    from trex_tpu_torch.topology import balanced_topology
    from trex_tpu_torch.types import CostModel

    device = resolve_device(args.device)
    if args.fasta:
        return _score_alignment(args, device)
    gt = generate_groundtruth(
        args.leaves, args.states, args.mutations, args.sites, seed=args.seed, device=device
    )
    cost = CostModel.hamming(args.states, device=device).matrix
    leaf = gt.all_sequences[: args.leaves].to(torch.int32)
    recon, _, score = sankoff_reconstruct(balanced_topology(args.leaves, device), cost, leaf)
    truth = gt.all_sequences[args.leaves :]
    acc = float((recon[args.leaves :] == truth).to(torch.float32).mean())
    return {"parsimony_score": float(score), "ancestor_identity_vs_truth": acc}


def cmd_score(args) -> None:
    print(json.dumps(run_score(args)))


def run_asr(args) -> dict:
    """The printed JSON object of ``asr``."""
    from trex_tpu_torch.models.mutation_tree import generate_groundtruth
    from trex_tpu_torch.ops.sankoff import sankoff_reconstruct
    from trex_tpu_torch.search.asr import reconstruct_ancestors
    from trex_tpu_torch.topology import balanced_topology
    from trex_tpu_torch.types import CostModel

    device = resolve_device(args.device)
    gt = generate_groundtruth(
        args.leaves, args.states, args.mutations, args.sites, seed=args.seed, device=device
    )
    cost = CostModel.hamming(args.states, device=device).matrix
    leaf = gt.all_sequences[: args.leaves].to(torch.int32)
    sankoff_recon, _, _ = sankoff_reconstruct(balanced_topology(args.leaves, device), cost, leaf)
    learned = reconstruct_ancestors(
        leaf, 2 * args.leaves - 1, args.states, gt.adjacency,
        torch.Generator(device).manual_seed(args.seed),
        n_iterations=args.iterations, learning_rate=args.lr,
    )
    truth = gt.all_sequences[args.leaves:].to(torch.int32)
    return {
        "sankoff_identity": float((sankoff_recon[args.leaves:] == truth).float().mean()),
        "gradient_asr_identity": float((learned == truth).float().mean()),
    }


def cmd_asr(args) -> None:
    print(json.dumps(run_asr(args)))


def run_trait(args) -> dict:
    """The printed JSON object of ``trait``: the Mk rate multiplier of the
    tree's branch lengths (golden-section search on the log rate over [-6,
    4], 40 steps), the log-likelihood at it, and each ancestor's marginal
    posterior and MAP state."""
    import numpy as np

    from trex_tpu_torch.io import load_newick, save_newick
    from trex_tpu_torch.ops.likelihood import tree_log_likelihood
    from trex_tpu_torch.ops.likelihood_asr import marginal_ancestral_posteriors

    device = resolve_device(args.device)
    with open(args.tree) as fh:
        topo, blens, names = load_newick(fh.read(), device)
    blens = np.asarray(blens, dtype=np.float64)
    if not np.isfinite(blens[:-1]).all() or not (blens[:-1] > 0).any():
        raise SystemExit("trait analysis needs branch lengths on the tree")
    blens = np.clip(blens, 1e-6, None)
    blens[-1] = 0.0

    states: dict[str, str] = {}
    with open(args.traits) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.replace(",", "\t").split("\t")]
            if len(parts) < 2:
                raise SystemExit(f"trait line needs 'taxon<sep>state': {line!r}")
            states[parts[0]] = parts[1]
    missing = [n for n in names if n not in states]
    if missing:
        raise SystemExit(f"traits missing for taxa: {missing[:5]}")
    labels = sorted({v for v in states.values() if v not in ("?", "-", "NA", "")})
    if len(labels) < 2:
        raise SystemExit("need at least two observed trait states")
    code = {v: i for i, v in enumerate(labels)}
    q = len(labels)
    trait = torch.as_tensor(
        np.array([code.get(states[n], -1) for n in names], np.int32).reshape(-1, 1),
        device=device)
    lens_dev = torch.as_tensor(blens.astype(np.float32), device=device)

    def lnl_at(log_r):
        return float(tree_log_likelihood(topo, lens_dev * np.exp(log_r), trait, q))

    lo, hi = -6.0, 4.0
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    c = hi - gr * (hi - lo)
    d = lo + gr * (hi - lo)
    fc, fd = lnl_at(c), lnl_at(d)
    for _ in range(40):
        if fc > fd:
            hi, d, fd = d, c, fc
            c = hi - gr * (hi - lo)
            fc = lnl_at(c)
        else:
            lo, c, fc = c, d, fd
            d = lo + gr * (hi - lo)
            fd = lnl_at(d)
    rate = float(np.exp((lo + hi) / 2.0))
    lnl = lnl_at(np.log(rate))

    posteriors, map_states = marginal_ancestral_posteriors(topo, lens_dev * rate, trait, q)
    post = posteriors[:, :, 0].cpu().numpy()  # (n_all, q)
    maps = map_states[:, 0].cpu().numpy()
    n_leaves = len(names)
    node_labels = [
        f"{labels[int(maps[n_leaves + a])]}:"
        f"{post[n_leaves + a, int(maps[n_leaves + a])]:.2f}".replace(":", "=")
        for a in range(n_leaves - 1)
    ]
    out = {
        "n_taxa": n_leaves,
        "states": labels,
        "mk_rate": round(rate, 6),
        "log_likelihood": round(lnl, 4),
        "ancestral_nodes": [
            {
                "ancestor": a,
                "map_state": labels[int(maps[n_leaves + a])],
                "posterior": {
                    labels[s]: round(float(post[n_leaves + a, s]), 4) for s in range(q)
                },
            }
            for a in range(n_leaves - 1)
        ],
        "tree": save_newick(topo, names, branch_lengths=blens, support=node_labels),
    }
    if args.output_tree:
        with open(args.output_tree, "w") as fh:
            fh.write(out["tree"] + "\n")
    return out


def cmd_trait(args) -> None:
    print(json.dumps(run_trait(args)))


def run_treedraw(args) -> str:
    """The ASCII rendering ``treedraw`` prints: lengths as annotations
    when the tree carries positive ones."""
    import numpy as np

    from trex_tpu_torch.io import format_tree, load_newick

    with open(args.tree) as fh:
        topo, blens, names = load_newick(fh.read())
    annotations = None
    blens = np.asarray(blens)
    if np.isfinite(blens[:-1]).all() and (blens[:-1] > 0).any():
        annotations = {i: f":{blens[i]:.4g}" for i in range(topo.n_all - 1)}
    return format_tree(topo, names, annotations)


def cmd_treedraw(args) -> None:
    print(run_treedraw(args))


def run_stats(args) -> dict:
    """The printed JSON object of ``stats``: site classes over unambiguous
    cells (constant, variable, parsimony-informative), pattern count,
    missing and ambiguous shares and the state composition."""
    import numpy as np

    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.io import DNA, PROTEIN

    _, masks, n_states = _load_alignment(args.fasta, args.alphabet)
    alphabet = {"dna": DNA, "protein": PROTEIN}[args.alphabet]
    n, length = masks.shape
    full = (1 << n_states) - 1
    is_single = (masks & (masks - 1)) == 0  # one-bit masks are unambiguous
    is_missing = masks == full
    constant = np.zeros(length, bool)
    informative = np.zeros(length, bool)
    variable = np.zeros(length, bool)
    counts_total = np.zeros(n_states, np.int64)
    for col in range(length):
        cells = masks[:, col][is_single[:, col]]
        if cells.size == 0:
            continue
        states, counts = np.unique(cells, return_counts=True)
        counts_total[np.log2(states).astype(int)] += counts
        if states.size == 1:
            constant[col] = True
        else:
            variable[col] = True
            # Parsimony-informative: at least 2 states each seen twice.
            informative[col] = int((counts >= 2).sum()) >= 2
    patterns, _ = compress_alignment(masks)
    comp = counts_total / max(counts_total.sum(), 1)
    return {
        "n_taxa": n,
        "n_sites": int(length),
        "unique_patterns": int(patterns.shape[1]),
        "constant_sites": int(constant.sum()),
        "variable_sites": int(variable.sum()),
        "parsimony_informative_sites": int(informative.sum()),
        "missing_fraction": round(float(is_missing.mean()), 4),
        "ambiguous_fraction": round(float((~is_single & ~is_missing).mean()), 4),
        "composition": {alphabet[i]: round(float(comp[i]), 4)
                        for i in range(n_states) if comp[i] > 0},
    }


def cmd_stats(args) -> None:
    print(json.dumps(run_stats(args)))
