"""NK fitness landscapes and Metropolis-Hastings tree evolution (counterpart
of ``trex_tpu/models/nk.py``).

A random epistatic landscape (per-site lookup tables over the site's own
state and K partner states) and a simulator that evolves sequences down a
tree with coupled or random mutation proposals filtered by an MH
acceptance step.

- Fitness is a gather and a power-basis index over all sites at once.
- The walk visits nodes in descending index order, a valid root-down
  schedule under the node contract (children below parents).
- The MH walk of an edge is a function of explicit per-step draws
  (``EdgeDraws``): the rate noise, the coupled-or-random choice, the
  per-site hits, the fresh states, the coupled site and the accept
  uniform. ``draw_edges`` draws them in bulk from a ``torch.Generator``; a
  test can hand in the JAX package's draws instead.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from trex_tpu_torch.topology import Topology, topology_from_adjacency, topology_to_adjacency
from trex_tpu_torch.types import PhyloData


@dataclasses.dataclass(frozen=True)
class NKLandscape:
    """Random NK epistatic fitness landscape: ``interactions[i]`` lists the
    K partner sites of site ``i``; ``tables[i]`` is the flattened q^(K+1)
    fitness lookup over (own state, partner states)."""

    interactions: torch.Tensor  # (L, K) int64
    tables: torch.Tensor  # (L, q**(K+1)) float32
    n_states: int
    k: int


def make_landscape(
    n_sites: int, k: int, generator: torch.Generator, n_states: int = 2
) -> NKLandscape:
    """A random landscape on the generator's device: uniform partner sites,
    then uniform [0, 1) table entries."""
    device = generator.device
    interactions = torch.randint(0, n_sites, (n_sites, k), generator=generator, device=device)
    tables = torch.rand((n_sites, n_states ** (k + 1)), generator=generator, device=device)
    return NKLandscape(interactions=interactions, tables=tables, n_states=n_states, k=k)


def landscape_from_numpy(
    interactions, tables, n_states: int, k: int, device="cpu"
) -> NKLandscape:
    """The port's landscape from host arrays (e.g. a JAX landscape's
    ``np.asarray`` fields)."""
    return NKLandscape(
        interactions=torch.as_tensor(np.array(interactions, dtype=np.int64), device=device),
        tables=torch.as_tensor(np.array(tables, dtype=np.float32), device=device),
        n_states=n_states, k=k,
    )


def sequence_fitness(
    sequence: torch.Tensor,
    landscape: NKLandscape,
    site_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean per-site table fitness of integer sequences (..., L): index_i =
    sum_j s_j * q^j over (own state, partner states); the (masked) mean over
    the valid sites of each sequence."""
    n_sites = sequence.shape[-1]
    device = sequence.device
    own = torch.arange(n_sites, device=device)[:, None]
    gather_idx = torch.cat([own, landscape.interactions.to(torch.int64)], dim=-1)
    states = sequence[..., gather_idx].to(torch.int64)  # (..., L, K+1)
    powers = landscape.n_states ** torch.arange(gather_idx.shape[-1], device=device)
    table_idx = (states * powers).sum(-1)
    values = landscape.tables[torch.arange(n_sites, device=device), table_idx]
    if site_mask is None:
        return values.mean(-1)
    mask = site_mask.to(values.dtype)
    return (values * mask).sum(-1) / mask.sum()


def batched_sequence_fitness(sequences: torch.Tensor, landscape: NKLandscape) -> torch.Tensor:
    """(B,) fitness of (B, L) sequences."""
    return sequence_fitness(sequences, landscape)


class EdgeDraws(NamedTuple):
    """The random draws of the MH walks, one row per node (the root's row
    is not read), ``T = branch_length`` steps an edge."""

    rate_noise: torch.Tensor
    """(n_nodes,) standard normal: the edge's log-rate noise before its std."""
    choose: torch.Tensor
    """(n_nodes, T) uniform: the coupled proposal where below ``coupled_prob``."""
    hit: torch.Tensor
    """(n_nodes, T, L) uniform: site hit by the random proposal where below
    the edge rate."""
    fresh: torch.Tensor
    """(n_nodes, T, L) int: the proposed states."""
    site: torch.Tensor
    """(n_nodes, T) int: the coupled proposal's site."""
    accept: torch.Tensor
    """(n_nodes, T) uniform: accepted where below min(1, exp(dF))."""


def draw_edges(
    n_nodes: int, branch_length: int, seq_length: int, n_states: int,
    generator: torch.Generator,
) -> EdgeDraws:
    """Every node's draws at once from ``generator``, on its device."""
    device = generator.device
    shape = (n_nodes, branch_length)
    return EdgeDraws(
        rate_noise=torch.randn((n_nodes,), generator=generator, device=device),
        choose=torch.rand(shape, generator=generator, device=device),
        hit=torch.rand((*shape, seq_length), generator=generator, device=device),
        fresh=torch.randint(0, n_states, (*shape, seq_length), generator=generator,
                            device=device),
        site=torch.randint(0, seq_length, shape, generator=generator, device=device),
        accept=torch.rand(shape, generator=generator, device=device),
    )


def mh_edge_walk(
    parent_seq: torch.Tensor,
    draws: EdgeDraws,
    node: int,
    landscape: NKLandscape,
    mutation_rate: float,
    coupled_prob: float,
    rate_noise_std: float,
) -> torch.Tensor:
    """Evolve node ``node`` from its parent's sequence: ``T`` MH-filtered
    steps under a log-normal per-edge rate, coupled (a site and its
    epistatic partners) or random (each site at the edge rate) proposals,
    accepted with probability ``min(1, exp(dF))``."""
    seq = parent_seq
    edge_rate = torch.clamp(
        mutation_rate * torch.exp(draws.rate_noise[node] * rate_noise_std), max=1.0)
    partners = landscape.interactions.to(torch.int64)
    for t in range(draws.choose.shape[1]):
        random_hit = draws.hit[node, t] < edge_rate
        site = draws.site[node, t].to(torch.int64)
        coupled = torch.cat([site[None], partners[site]])
        coupled_hit = torch.zeros_like(random_hit).index_fill_(0, coupled, True)
        hit = torch.where(draws.choose[node, t] < coupled_prob, coupled_hit, random_hit)
        proposal = torch.where(hit, draws.fresh[node, t].to(seq.dtype), seq)
        delta = sequence_fitness(proposal, landscape) - sequence_fitness(seq, landscape)
        accept = draws.accept[node, t] < torch.clamp(torch.exp(delta), max=1.0)
        seq = torch.where(accept, proposal, seq)
    return seq


def evolve_tree(
    landscape: NKLandscape,
    topology: Topology,
    root_sequence: torch.Tensor,
    mutation_rate: float,
    generator: torch.Generator | None = None,
    coupled_prob: float = 0.5,
    rate_noise_std: float = 0.0,
    branch_length: int = 1,
    *,
    draws: EdgeDraws | None = None,
) -> torch.Tensor:
    """(n_all, L) int32 sequences evolved down a tree from ``root_sequence``
    on its device, nodes root-down in descending index order. The walks'
    draws are ``draws``, or drawn from ``generator`` when None."""
    n_all = topology.n_all
    seq_length = root_sequence.shape[-1]
    device = root_sequence.device
    if draws is None:
        draws = draw_edges(n_all, branch_length, seq_length, landscape.n_states, generator)
    parents = topology.parents.tolist()
    seqs = torch.zeros((n_all, seq_length), dtype=torch.int32, device=device)
    seqs[n_all - 1] = root_sequence.reshape(seq_length).to(torch.int32)
    for node in range(n_all - 2, -1, -1):
        seqs[node] = mh_edge_walk(
            seqs[parents[node]], draws, node, landscape, mutation_rate, coupled_prob,
            rate_noise_std,
        )
    return seqs


def evolve_tree_on_adjacency(
    landscape: NKLandscape,
    adjacency: torch.Tensor,
    root_sequence: torch.Tensor,
    mutation_rate: float,
    generator: torch.Generator | None = None,
    coupled_prob: float = 0.5,
    rate_noise_std: float = 0.0,
    branch_length: int = 1,
    *,
    draws: EdgeDraws | None = None,
) -> PhyloData:
    """Adjacency-API wrapper: ``PhyloData`` of float32 sequences (the
    masked ones all zero, as the JAX function returns them) and the
    topology's adjacency."""
    n_leaves = (adjacency.shape[-1] + 1) // 2
    topo = topology_from_adjacency(adjacency, n_leaves)
    all_seqs = evolve_tree(
        landscape, topo, root_sequence, mutation_rate, generator, coupled_prob,
        rate_noise_std, branch_length, draws=draws,
    ).to(torch.float32)
    return PhyloData(
        masked_sequences=torch.zeros_like(all_seqs),
        all_sequences=all_seqs,
        adjacency=topology_to_adjacency(topo),
    )
