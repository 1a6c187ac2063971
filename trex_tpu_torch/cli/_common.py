"""Shared helpers for the CLI commands (counterpart of ``trex_tpu/cli/_common.py``)."""

from __future__ import annotations

import argparse
from typing import NamedTuple

import numpy as np
import torch

from trex_tpu_torch.topology import Topology


def _add_common(p: argparse.ArgumentParser) -> None:
    """The generated-data flags the JAX commands share."""
    p.add_argument("--leaves", type=int, default=16)
    p.add_argument("--sites", type=int, default=128)
    p.add_argument("--states", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics-file", type=str, default=None)


def _add_mesh_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--mesh", type=str, default=None, metavar="T,S",
        help="shard work over a ('tree','site') mesh of the world's ranks "
        "(torchrun --nproc-per-node N): T,S axis sizes (product = ranks), "
        "'auto', or '1,1' to force one device. Default: auto when the world "
        "has more than one rank, else one device",
    )


def _make_cli_mesh(spec: str | None, divides: int | None = None):
    """Build a ('tree', 'site') mesh from a ``--mesh T,S`` CLI spec, with
    the JAX CLI's rules.

    ``"T,S"`` = explicit axis sizes (T*S must equal the ranks of the world,
    1 without one); ``"auto"`` = ``make_mesh``'s heuristic over the world;
    ``"1,1"`` = the single-device opt-out (None). No flag means ``auto``
    when the world has more than one rank, else None. ``divides``: with
    ``auto``, the largest tree axis dividing both the world and
    ``divides`` (for samplers that split a fixed batch without padding).
    """
    import torch.distributed as dist

    from trex_tpu_torch.parallel.mesh import make_mesh

    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if spec == "1,1":
        return None
    if spec is None:
        if n <= 1:
            return None
        spec = "auto"
    if spec == "auto":
        if divides is not None:
            t = max(t for t in range(1, n + 1) if n % t == 0 and divides % t == 0)
            return make_mesh(tree_parallelism=t)
        return make_mesh()
    try:
        t_str, s_str = spec.split(",")
        t, s = int(t_str), int(s_str)
    except ValueError:
        raise SystemExit(f"--mesh wants 'T,S' or 'auto', got {spec!r}")
    if t * s != n:
        raise SystemExit(f"--mesh {t},{s}: {t}*{s} != {n} addressable devices")
    return make_mesh(tree_parallelism=t)


def _join_world(args, divides: int | None = None):
    """Join a launcher's world (``torchrun``: every rank runs the command)
    on ``--device``, then build ``--mesh``'s mesh (``_make_cli_mesh``, with
    ``divides``)."""
    from trex_tpu_torch.parallel.distributed import initialize_distributed

    initialize_distributed(device=args.device)
    return _make_cli_mesh(getattr(args, "mesh", None), divides)


def refuse_world(command: str) -> None:
    """Refuse a launcher's world of more than one rank (``torchrun
    --nproc-per-node N``) for a command that runs on one device: each rank
    would run the whole command and write the same files. The commands
    whose JAX counterparts take ``--mesh`` (``infer``, ``topotest``,
    ``mcmc``, ``bayesfactor``) join a world (``_join_world``)."""
    import os

    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    if ranks > 1:
        raise SystemExit(f"{command} runs on one device, not over {ranks} ranks: the JAX "
                         f"CLI's {command} has no --mesh; launch it as one process")


def _add_device(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=f"where {what} runs (default cuda; raises when no "
                        "card is present)")


def _load_alignment(path: str, alphabet_name: str):
    """Read an alignment -> (names, (n, L) int32 state-set masks, n_states).

    Format auto-detected: NEXUS (``#NEXUS`` header), PHYLIP (numeric
    ``ntax nchar`` header), else FASTA. Always encodes through the
    ambiguity-preserving path so gaps and IUPAC codes get standard
    missing-data semantics.
    """
    from trex_tpu_torch.io import (
        DNA,
        PROTEIN,
        encode_alignment_masks,
        parse_fasta_masks,
        parse_nexus,
        parse_phylip,
    )

    alphabet = {"dna": DNA, "protein": PROTEIN}[alphabet_name]
    with open(path) as fh:
        text = fh.read()
    head = text.lstrip()[:40].lower()
    if head.startswith("#nexus"):
        names, rows, _ = parse_nexus(text)
        if rows is None:
            raise SystemExit(f"{path}: NEXUS file has no DATA/CHARACTERS block")
        masks = encode_alignment_masks(rows, alphabet)
    elif head.split()[:2] and head.split()[0].isdigit():
        names, rows = parse_phylip(text)
        masks = encode_alignment_masks(rows, alphabet)
    else:
        names, masks = parse_fasta_masks(text, alphabet)
    return names, np.asarray(masks, dtype=np.int32), len(alphabet)


def _outgroup_indices(names: list[str], outgroup: str) -> list[int]:
    """Resolve a comma-separated outgroup name list to leaf indices."""
    wanted = [s.strip() for s in outgroup.split(",") if s.strip()]
    missing = [w for w in wanted if w not in names]
    if missing:
        raise SystemExit(f"outgroup taxa not in the alignment: {missing}")
    return [names.index(w) for w in wanted]


def _start_tree(
    kind: str, masks, n_states: int, seed: int, weights, orders: int, device
):
    """Build the requested starting topology from (possibly ambiguous) leaves.

    ``random`` is ``topology.random_topologies(seed, n, 1)``, numpy's
    ``default_rng(seed)`` coalescent; ``balanced`` needs a power-of-two
    taxon count; ``nj``/``upgma`` is the distance tree of JC distances
    (``search.nj.nj_start_tree``) between the masks' lowest states.
    """
    from trex_tpu_torch.search.stepwise import stepwise_addition_multi
    from trex_tpu_torch.topology import balanced_topology, random_topologies

    n_leaves = masks.shape[0]
    if kind == "stepwise":
        topo, _ = stepwise_addition_multi(
            masks, n_states, n_orders=orders, seed=seed,
            sequences_are_masks=True, site_weights=weights, device=device,
        )
        return topo
    if kind == "diff":
        return diff_start(masks, n_states, seed, weights, device).topology
    if kind == "random":
        topo = random_topologies(seed, n_leaves, 1, device)
        return Topology(topo.children[0], topo.parents[0])
    if kind == "balanced":
        if n_leaves & (n_leaves - 1):
            raise SystemExit(
                f"--start balanced needs a power-of-two taxon count, got {n_leaves}"
            )
        return balanced_topology(n_leaves, device)
    if kind in ("nj", "upgma"):
        from trex_tpu_torch.search.nj import nj_start_tree

        # Distances want integer states: ambiguity resolves to the lowest
        # allowed state (a heuristic; the search refines from there).
        ints = torch.as_tensor(lowest_states(masks, n_states), device=device)
        return nj_start_tree(ints, n_states, weights, method=kind, device=device)[0]
    raise SystemExit(f"unknown --start {kind!r}")


class DiffStart(NamedTuple):
    """What ``diff_start`` returns: the best projected tree, every
    restart's projected tree and their exact scores."""

    topology: Topology
    trees: Topology
    """(R, ...) restart-stacked."""
    scores: torch.Tensor


DIFF_RESTARTS = 8
DIFF_ITERATIONS = 600


def diff_start(
    masks, n_states: int, seed: int, weights, device, *,
    init: dict | None = None, noise=None, projection_noise=None,
) -> DiffStart:
    """The differentiable start tree (``--start diff``): ``DIFF_RESTARTS``
    joint-relaxation restarts of ``DIFF_ITERATIONS`` annealed steps as one
    batch, each projected to a valid tree at temperature 0.01 with fresh
    Gumbel noise, ranked by exact parsimony on the true masks through the
    dispatch (K1 on the card); the first best wins.

    The relaxation takes one-hot leaves, each mask resolved to its lowest
    allowed state. Its draws come from a generator seeded with ``seed``
    (initial parameters, then each step's noise) and, for the projection,
    one seeded with ``seed + 1``; ``init`` (restart-stacked parameters),
    ``noise`` ((DIFF_ITERATIONS, R, n_all - 1, n_anc)) and
    ``projection_noise`` ((R, n_all - 1, n_anc)) replace them.
    """
    from trex_tpu_torch.ops.dispatch import batched_scores_fastest
    from trex_tpu_torch.ops.relax import project_topology, soft_topology
    from trex_tpu_torch.search.joint import JointConfig, init_params, joint_optimize
    from trex_tpu_torch.types import CostModel

    n_leaves, length = masks.shape
    leaf_tensor = one_hot_leaves(
        torch.as_tensor(lowest_states(masks, n_states), device=device), n_states)
    generator = torch.Generator(device).manual_seed(seed)
    if init is None:
        init = init_params(n_leaves, length, n_states, generator=generator,
                           batch=(DIFF_RESTARTS,))
    params, _ = joint_optimize(init, leaf_tensor, JointConfig(n_iterations=DIFF_ITERATIONS),
                               noise=noise, generator=generator)
    generator.manual_seed(seed + 1)
    trees = project_topology(soft_topology(
        params["tree_params"], 0.01, noise=projection_noise, generator=generator))
    cost = CostModel.hamming(n_states, device=device).matrix
    scores = batched_scores_fastest(
        trees, cost, torch.as_tensor(masks, device=device), site_weights=weights,
        sequences_are_masks=True,
    )
    best = int(torch.argmin(scores))
    return DiffStart(Topology(trees.children[best], trees.parents[best]), trees, scores)


def one_hot_leaves(leaf: torch.Tensor, n_states: int) -> torch.Tensor:
    """(2n - 1, L, Q) float32: one-hot rows of the (n, L) integer leaves,
    zero ancestor rows (the joint search's leaf tensor)."""
    n_leaves, length = leaf.shape
    out = torch.zeros((2 * n_leaves - 1, length, n_states), device=leaf.device)
    out[:n_leaves] = torch.nn.functional.one_hot(leaf.long(), n_states).float()
    return out


def lowest_states(masks: np.ndarray, n_states: int) -> np.ndarray:
    """The lowest allowed state of each (possibly ambiguous) state-set mask
    (0 for a mask with none of the alphabet's bits)."""
    lsb = masks & -masks
    ints = np.zeros_like(masks)
    for b in range(n_states):
        ints[lsb == (1 << b)] = b
    return ints
