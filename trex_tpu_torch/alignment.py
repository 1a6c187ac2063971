"""Alignment utilities: site-pattern compression and site classification
(counterpart of ``trex_tpu/alignment.py``, copied as is: host-side numpy).

Every score in this engine is a weighted site sum, so collapsing duplicate
columns into (unique patterns, counts) preserves scores exactly.
First-occurrence pattern order keeps results identical across packages.
"""

from __future__ import annotations

import numpy as np


def compress_alignment(
    leaf_sequences, pad_to: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Collapse duplicate site columns.

    Args:
        leaf_sequences: (n_leaves, L) integer states or state-set masks.
        pad_to: optionally pad the pattern axis to this length (extra
            patterns are all-zero columns with weight 0).

    Returns:
        patterns: (n_leaves, P) unique columns, first-occurrence order.
        weights: (P,) int64 multiplicities; ``sum(weights) == L``.
    """
    seqs = np.asarray(leaf_sequences)
    _, first_idx, inverse = np.unique(
        seqs, axis=1, return_index=True, return_inverse=True
    )
    # np.unique sorts; restore first-occurrence order for determinism.
    order = np.argsort(first_idx)
    patterns = seqs[:, first_idx[order]]
    rank_of_unique = np.empty_like(order)
    rank_of_unique[order] = np.arange(order.size)
    weights = np.bincount(rank_of_unique[inverse], minlength=order.size)

    if pad_to is not None:
        if pad_to < patterns.shape[1]:
            raise ValueError(
                f"pad_to={pad_to} < {patterns.shape[1]} unique patterns"
            )
        extra = pad_to - patterns.shape[1]
        patterns = np.pad(patterns, ((0, 0), (0, extra)))
        weights = np.pad(weights, (0, extra))
    return patterns, weights


def constant_site_mask(leaf_sequences) -> np.ndarray:
    """(L,) bool: True where all leaves share one state (zero-cost sites)."""
    seqs = np.asarray(leaf_sequences)
    return (seqs == seqs[0]).all(axis=0)


def parsimony_informative_mask(leaf_sequences) -> np.ndarray:
    """(L,) bool: sites with >= 2 states each in >= 2 leaves. Only these can
    tell topologies apart; the rest add a topology-independent constant to
    every parsimony score."""
    seqs = np.asarray(leaf_sequences)
    out = np.zeros(seqs.shape[1], dtype=bool)
    for j in range(seqs.shape[1]):
        _, counts = np.unique(seqs[:, j], return_counts=True)
        out[j] = (counts >= 2).sum() >= 2
    return out
