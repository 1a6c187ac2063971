"""The ``score`` command's parsimony branches (counterpart of ``cmd_score``
in ``trex_tpu/cli/score.py``).

- Generated data: a balanced mutation tree (``models.mutation_tree``),
  exact Sankoff scoring and reconstruction of its ancestors under the
  Hamming cost (``ops.sankoff.sankoff_reconstruct``), and the share of
  ancestral states that match the truth.
- ``--alignment``: the tree of ``--tree`` (or a stepwise-addition tree),
  its Fitch score and one optimal labeling (``ops.fitch.fitch_reconstruct``),
  optionally written to ``--output-fasta``.

Both print the JAX command's JSON keys. ``--criterion ml`` waits for
slice 2b.

``asr`` (counterpart of ``cmd_asr``) reconstructs the ancestors of a
generated balanced mutation tree by exact Sankoff and by gradient descent
(``search.asr.reconstruct_ancestors``, initial logits from a generator
seeded with ``--seed``) and prints each one's identity with the truth.
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

    if args.criterion == "ml":
        raise SystemExit(
            "score --criterion ml is not ported yet: slice 2b of ROADMAP.md "
            "(marginal_ancestral_posteriors and the Adam branch-length fit)"
        )
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
