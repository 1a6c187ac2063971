"""Shared inputs for the parity tests between ``trex_tpu`` (JAX, the
reference) and ``trex_tpu_torch`` (the PyTorch port).

Every input is made with numpy from a seed and handed to both packages as
numpy arrays, so both see identical data.
"""

from __future__ import annotations

import numpy as np


def random_children(rng: np.random.Generator, n_leaves: int, batch: int) -> np.ndarray:
    """(batch, n_leaves - 1, 2) int32 children of random coalescent trees
    (ascending pairs, child index < parent index, root last)."""
    children = np.empty((batch, n_leaves - 1, 2), np.int32)
    for b in range(batch):
        active = list(range(n_leaves))
        for a in range(n_leaves - 1):
            x = active.pop(int(rng.integers(len(active))))
            j = int(rng.integers(len(active)))
            y = active[j]
            active[j] = n_leaves + a
            children[b, a] = (min(x, y), max(x, y))
    return children


def parents_of(children: np.ndarray) -> np.ndarray:
    """(..., n_all) int32 parent vectors of (..., n_anc, 2) children."""
    children = np.asarray(children)
    flat = children.reshape(-1, *children.shape[-2:])
    n_anc = flat.shape[1]
    n_all = 2 * n_anc + 1
    out = np.empty((flat.shape[0], n_all), np.int32)
    rows = np.arange(n_anc + 1, n_all, dtype=np.int32)
    for b, ch in enumerate(flat):
        out[b, ch[:, 0]] = rows
        out[b, ch[:, 1]] = rows
        out[b, -1] = n_all - 1
    return out.reshape(*children.shape[:-2], n_all)


def random_masks(
    rng: np.random.Generator, n_leaves: int, length: int, ambiguity: float = 0.1
) -> np.ndarray:
    """(n_leaves, L) int32 DNA state-set masks, some of them ambiguous."""
    masks = (1 << rng.integers(0, 4, (n_leaves, length))).astype(np.int32)
    amb = rng.random((n_leaves, length)) < ambiguity
    masks[amb] = rng.integers(1, 16, int(amb.sum()))
    return masks


def evolved_masks(
    rng: np.random.Generator, children: np.ndarray, length: int, rate: float
) -> np.ndarray:
    """(n_leaves, L) int32 DNA masks of sequences evolved down ``children``
    (each site mutates with probability ``rate`` per edge), so that branch
    lengths fitted to them are well determined."""
    n_leaves = children.shape[0] + 1
    seqs = np.empty((2 * n_leaves - 1, length), np.int64)
    seqs[-1] = rng.integers(0, 4, length)
    for a in range(n_leaves - 2, -1, -1):
        for c in children[a]:
            s = seqs[n_leaves + a].copy()
            hit = rng.random(length) < rate
            s[hit] = rng.integers(0, 4, int(hit.sum()))
            seqs[c] = s
    return (1 << seqs[:n_leaves]).astype(np.int32)


def integer_weights(rng: np.random.Generator, length: int) -> np.ndarray:
    """(L,) f32 integer-valued site weights (compressed-pattern counts)."""
    return rng.integers(1, 5, length).astype(np.float32)


def tree_fasta(rng: np.random.Generator, n_taxa: int, n_sites: int, rate: float) -> str:
    """FASTA text of sequences evolved down a random tree (each site
    mutates with probability ``rate`` per edge), with IUPAC codes, gaps and
    a lower-case letter mixed in."""
    children = random_children(rng, n_taxa, 1)[0]
    n_all = 2 * n_taxa - 1
    seqs = np.empty((n_all, n_sites), np.int64)
    seqs[-1] = rng.integers(0, 4, n_sites)
    for a in range(n_taxa - 2, -1, -1):
        for c in children[a]:
            s = seqs[n_taxa + a].copy()
            hit = rng.random(n_sites) < rate
            s[hit] = rng.integers(0, 4, int(hit.sum()))
            seqs[c] = s
    letters = np.array(list("ACGT"))
    lines = []
    for t in range(n_taxa):
        row = letters[seqs[t]]
        odd = rng.random(n_sites) < 0.04
        row[odd] = rng.choice(list("RYKMSWN-?acgt"), int(odd.sum()))
        lines.append(f">taxon_{t}\n{''.join(row)}")
    return "\n".join(lines) + "\n"
