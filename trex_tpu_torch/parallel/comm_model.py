"""Collective-volume and scaling-efficiency model for the ('tree','site') mesh
(a copy of ``trex_tpu/parallel/comm_model.py``: plain Python).

Multi-GPU efficiency cannot be measured on a one-card host; what can be
checked is the communication model it rests on:

- exact per-rank shard sizes of every sharded operand, and
- exact collective payloads per step, with ring-algorithm wire volumes
  (``2 (k-1)/k * payload`` for all-reduce, ``(k-1)/k * result`` for
  all-gather), which with a link bandwidth and a measured compute rate give
  an efficiency prediction.

The collectives modeled are those of the JAX package's
``parallel/sharded.py``; the port's ``parallel/sharded.py`` emits the same
ones over ``torch.distributed`` groups (``all_reduce`` for ``psum``, the
list form of ``all_gather``), with two differences. The port's
``sharded_batch_scores`` and ``sharded_log_likelihoods`` gather the (B,)
scores over ``tree`` so that every rank holds them (where JAX's host read
of the tree-sharded output gathers them). And the climbers' best-only scan
reduction, ``sharded_spr_scan_best``, gathers four scalars a rank over
``tree`` where ``spr_scan_collectives`` counts the whole ranking table:
nothing is added to the model for it.

The collectives modeled (JAX's ``parallel/sharded.py``):

- ``sharded_batch_scores`` / ``sharded_log_likelihoods``: one f32 ``psum``
  of the (B_tree_local,) per-site partial scores over ``site``;
- ``sharded_best_tree``: the same psum + two ``all_gather``s of one scalar
  per tree-shard over ``tree``;
- the joint training steps: ``psum`` over ``site`` of the scalar losses and
  of the replicated topology-logit gradients (ancestor grads are site-local
  by construction — no comms; ``parallel/sharded.py:232``);
- ``sharded_spr_scan`` (the mesh-native hill-climb/ML-ranking round): one
  all_gather over ``tree`` of the prune-sharded ranking matrix;
- sharded ``mcmc_sample`` generations: scalar acceptance-counter psums over
  ``tree`` plus the MC^3 swap's worst-case cross-shard state permute.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective in a sharded step, with its modeled wire cost."""

    op: str
    """'psum' or 'all_gather'."""
    axis: str
    """Mesh axis it runs over."""
    participants: int
    """Devices along that axis."""
    payload_bytes: int
    """Logical payload per device (the array being reduced/gathered)."""

    @property
    def wire_bytes_per_device(self) -> int:
        """Ring-algorithm bytes each device sends (= receives).

        All-reduce: reduce-scatter + all-gather, each (k-1)/k of the
        payload. All-gather: each device ships its shard to k-1 peers in a
        ring = (k-1)/k of the gathered result.
        """
        k = self.participants
        if k <= 1:
            return 0
        if self.op == "psum":
            return int(2 * (k - 1) * self.payload_bytes // k)
        if self.op == "all_gather":
            return int((k - 1) * self.payload_bytes // k)
        if self.op == "permute":
            # Point-to-point resharding (collective-permute): each device
            # ships exactly the rows that change owners — the payload IS
            # the wire volume (no ring amplification).
            return int(self.payload_bytes)
        raise ValueError(self.op)


def shard_sizes(
    mesh_shape: dict[str, int],
    batch: int,
    n_leaves: int,
    length: int,
    dtype_bytes: int = 4,
) -> dict[str, tuple[int, ...]]:
    """Per-device shard SHAPES of the batched-scoring operands.

    Matches the PartitionSpecs in ``sharded_batch_scores``: topologies
    ``P('tree')``, leaves ``P(None, 'site')``, scores ``P('tree')``.
    Divisibility is the caller's contract (the production paths pad).
    """
    n_tree = mesh_shape.get("tree", 1)
    n_site = mesh_shape.get("site", 1)
    n_anc = n_leaves - 1
    return {
        "children": (batch // n_tree, n_anc, 2),
        "leaf_sequences": (n_leaves, length // n_site),
        "scores": (batch // n_tree,),
    }


def batch_scoring_collectives(
    mesh_shape: dict[str, int], batch: int, dtype_bytes: int = 4
) -> list[Collective]:
    """Collectives of one ``sharded_batch_scores`` call."""
    n_tree = mesh_shape.get("tree", 1)
    n_site = mesh_shape.get("site", 1)
    local_b = batch // n_tree
    return [
        Collective("psum", "site", n_site, local_b * dtype_bytes),
    ]


def best_tree_collectives(
    mesh_shape: dict[str, int], batch: int, dtype_bytes: int = 4
) -> list[Collective]:
    """Collectives of one ``sharded_best_tree`` call."""
    n_tree = mesh_shape.get("tree", 1)
    out = batch_scoring_collectives(mesh_shape, batch, dtype_bytes)
    # Two all_gathers of one scalar per tree shard (min score, global idx).
    out.append(Collective("all_gather", "tree", n_tree, n_tree * dtype_bytes))
    out.append(Collective("all_gather", "tree", n_tree, n_tree * dtype_bytes))
    return out


def joint_step_collectives(
    mesh_shape: dict[str, int],
    n_restarts: int,
    n_all: int,
    n_anc: int,
    dtype_bytes: int = 4,
) -> list[Collective]:
    """Collectives of one ``make_sharded_restart_joint_step`` step:
    psum over ``site`` of the (n_restarts,) losses and of the replicated
    (n_restarts, n_all-1, n_anc) topology-logit gradients."""
    n_site = mesh_shape.get("site", 1)
    return [
        Collective("psum", "site", n_site, n_restarts * dtype_bytes),
        Collective(
            "psum", "site", n_site,
            n_restarts * (n_all - 1) * n_anc * dtype_bytes,
        ),
    ]


def spr_scan_collectives(
    mesh_shape: dict[str, int], n_all: int, dtype_bytes: int = 4
) -> list[Collective]:
    """Collectives of one ``sharded_spr_scan`` round (the
    path of ``spr_decay_support(mesh=...)``; the climbers reduce to
    ``sharded_spr_scan_best``'s scalars instead).

    The prune axis is sharded over ``tree``; each device scans its prune
    nodes over the FULL site axis (rows computed whole — no site
    collective), and the (n_all-1, n_all) ranking matrix is reassembled by
    one all_gather over ``tree`` when the host reads it for the argmin.
    """
    n_tree = mesh_shape.get("tree", 1)
    payload = (n_all - 1) * n_all * dtype_bytes
    return [Collective("all_gather", "tree", n_tree, payload)]


def per_site_matrix_collectives(
    mesh_shape: dict[str, int],
    n_candidates: int,
    length: int,
    dtype_bytes: int = 4,
) -> list[Collective]:
    """Collectives of one ``sharded_per_site_matrix`` call (the
    path of ``branch_supports``, ``ultrafast_bootstrap`` and
    ``topology_tests`` with ``mesh=``).

    The candidate axis is sharded over ``tree``; each device Newton-fits
    and evaluates its local candidates over the FULL (replicated) site
    axis, so the only collective is the output all_gather of the
    (n_candidates, length) per-site-lnL matrix when the host reads it for
    the RELL matmul.
    """
    n_tree = mesh_shape.get("tree", 1)
    pad = -n_candidates % n_tree
    payload = (n_candidates + pad) * length * dtype_bytes
    return [Collective("all_gather", "tree", n_tree, payload)]


def stepping_stone_collectives(
    mesh_shape: dict[str, int],
    n_rungs: int,
    total_steps: int,
    dtype_bytes: int = 4,
) -> list[Collective]:
    """Collectives of one sharded ``stepping_stone`` run (JAX's
    rung batch over ``tree``; not sharded in the port yet).

    Every rung's chain is device-local; the cross-shard traffic is the
    scalar acceptance-counter psum per step (the
    ``take.sum()`` over the sharded rung axis) and the final trace gather
    of (total_steps, n_rungs) f32 when the host reads it.
    """
    n_tree = mesh_shape.get("tree", 1)
    out: list[Collective] = [
        Collective("psum", "tree", n_tree, dtype_bytes)
    ] * total_steps
    out.append(
        Collective(
            "all_gather", "tree", n_tree,
            total_steps * n_rungs * dtype_bytes,
        )
    )
    return out


def mcmc_generation_collectives(
    mesh_shape: dict[str, int],
    n_runs: int,
    n_chains: int,
    n_anc: int,
    n_all: int,
    branch_moves_per_gen: int = 1,
    sample_model: bool = False,
    dtype_bytes: int = 4,
) -> list[Collective]:
    """Collectives of ONE sharded ``mcmc_sample`` generation (the chain
    axis over ``tree``; JAX's ``mcmc_sample(mesh=...)``, not sharded in
    the port yet).

    Everything per-chain is local. What crosses shards: the integer
    acceptance-counter psums (one scalar per move family) and the MC^3
    swap permutation — worst case every run's swapped pair straddles a
    shard boundary, so 2 chain states (children int32 (n_anc, 2), lengths
    f32 (n_all,), lnl scalar) per run move point-to-point. The per-block
    cold-chain snapshot is one gather of ``n_runs`` chain states.
    """
    n_tree = mesh_shape.get("tree", 1)
    out: list[Collective] = []
    n_families = (
        (1 if branch_moves_per_gen > 0 else 0)
        + 1  # topology move
        + (1 if n_chains > 1 else 0)  # swap
        + (2 if sample_model else 0)
    )
    out += [
        Collective("psum", "tree", n_tree, dtype_bytes)
    ] * n_families
    if n_chains > 1:
        state_row = n_anc * 2 * 4 + n_all * dtype_bytes + dtype_bytes
        out.append(
            Collective("permute", "tree", n_tree, 2 * n_runs * state_row)
        )
    return out


def predicted_efficiency(
    collectives: list[Collective],
    compute_seconds_per_step: float,
    link_bytes_per_second: float,
) -> float:
    """Parallel efficiency = compute / (compute + comm), non-overlapped.

    A deliberately pessimistic (no compute/comm overlap) model; where
    communication overlaps compute the truth lies between this and 1.0.
    """
    comm = sum(c.wire_bytes_per_device for c in collectives) / link_bytes_per_second
    return compute_seconds_per_step / (compute_seconds_per_step + comm)
