"""Balanced mutation-tree ground-truth generator (counterpart of
``trex_tpu/models/mutation_tree.py``).

A balanced binary tree whose root is the all-zeros sequence and where every
child differs from its parent at exactly ``n_mutations`` distinct,
uniformly chosen sites, each moved by a non-zero offset (never silent).
Node numbering follows the engine contract: leaves first, root last,
ancestor ``n_leaves + p`` has children ``2p`` and ``2p + 1``.

Random bits come from one ``torch.Generator`` on the CPU seeded from
``seed``, so the data is the same whatever device it is moved to. They
are not the JAX package's threefry bits: the contract above is what both
packages share.
"""

from __future__ import annotations

import torch

from trex_tpu_torch._device import resolve_device
from trex_tpu_torch.topology import balanced_topology, topology_to_adjacency
from trex_tpu_torch.types import PhyloData


def mutate(
    generator: torch.Generator,
    sequence: torch.Tensor,
    n_states: int,
    n_mutations: int,
) -> torch.Tensor:
    """Substitute exactly ``n_mutations`` distinct sites of an int sequence,
    each by a uniform offset in ``1..n_states-1`` (mod Q); int8 result."""
    length = sequence.shape[-1]
    if n_mutations > length:
        raise ValueError(f"{n_mutations} mutations do not fit {length} sites")
    hit = torch.zeros(length, dtype=torch.bool)
    hit[torch.randperm(length, generator=generator)[:n_mutations]] = True
    offsets = torch.randint(1, n_states, sequence.shape, generator=generator)
    moved = (sequence.to(torch.int64) + offsets) % n_states
    return torch.where(hit, moved, sequence.to(torch.int64)).to(torch.int8)


def generate_groundtruth(
    n_leaves: int,
    n_states: int,
    n_mutations: int,
    seq_length: int,
    seed: int = 42,
    device="cuda",
) -> PhyloData:
    """Generate a balanced mutation tree and its alignment.

    Args:
        n_leaves: leaf count, a power of two.
        n_states: alphabet size Q.
        n_mutations: exact substitutions per parent -> child edge.
        seq_length: alignment length L.
        seed: seed of the generator.
        device: where the result lives (``cuda`` by default; raises when
            there is no card).

    Returns:
        ``PhyloData`` on ``device``: float32 leaves-only sequences (ancestor
        rows zero), the full float32 ground truth, and the float32 balanced
        adjacency (A[child, parent] = 1).
    """
    if n_leaves <= 0 or (n_leaves & (n_leaves - 1)) != 0:
        raise ValueError("n_leaves must be a power of 2.")
    device = resolve_device(device)
    n_all = 2 * n_leaves - 1
    topo = balanced_topology(n_leaves)
    generator = torch.Generator().manual_seed(int(seed))
    seqs = torch.zeros((n_all, seq_length), dtype=torch.int8)  # root row = zeros
    # Root first: every parent row is written before its children read it.
    for a in range(n_leaves - 2, -1, -1):
        parent = seqs[n_leaves + a]
        for child in topo.children[a].tolist():
            seqs[child] = mutate(generator, parent, n_states, n_mutations)
    masked = torch.zeros_like(seqs)
    masked[:n_leaves] = seqs[:n_leaves]
    return PhyloData(
        masked_sequences=masked.to(device=device, dtype=torch.float32),
        all_sequences=seqs.to(device=device, dtype=torch.float32),
        adjacency=topology_to_adjacency(topo.to(device)),
    )
