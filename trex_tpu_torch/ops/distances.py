"""Pairwise sequence distances (counterpart of ``trex_tpu/ops/distances.py``).

The (n, n) mismatch count is Q one-hot products, ``matches = sum_q X_q W
X_q^T``, as one float32 matrix product on the device (TF32 off, so integer
counts below 2^24 are exact). A leading axis of site-weight vectors (the
bootstrap's replicates) runs as one batched product.
"""

from __future__ import annotations

import torch

from trex_tpu_torch.ops.likelihood import _f32, highest_matmul_precision

# Replicate weight vectors a batched product takes at once (the JAX
# package maps its replicates in batches of 32 too).
_REPLICATE_BATCH = 32


@highest_matmul_precision
def hamming_distance_matrix(leaf_sequences, n_states: int, site_weights=None) -> torch.Tensor:
    """(n, n) f32 count of mismatching sites between every sequence pair.

    Args:
        leaf_sequences: (n, L) integer states.
        n_states: alphabet size Q.
        site_weights: optional (L,) weights (compressed-pattern counts,
            bootstrap counts): a mismatch at site s counts ``w[s]``; or
            (R, L), R weight vectors, for (R, n, n).

    Computed as ``sum(w) - sum_q X_q W X_q^T`` with X the one-hot
    indicators, one float32 product contracting states and sites together.
    """
    seqs = torch.as_tensor(leaf_sequences).to(torch.int64)
    n, length = seqs.shape
    device = seqs.device
    weights = (
        torch.ones((length,), dtype=torch.float32, device=device)
        if site_weights is None else _f32(site_weights, device=device)
    )
    states = torch.arange(n_states, device=device)
    x = (seqs[:, None, :] == states[None, :, None]).to(torch.float32).reshape(n, -1)  # (n, Q*L)
    if weights.dim() == 1:
        xw = (x.view(n, n_states, length) * weights).reshape(n, -1)
        return weights.sum() - xw @ x.T
    out = []
    for w in weights.split(_REPLICATE_BATCH):
        xw = (x.view(1, n, n_states, length) * w[:, None, None, :]).reshape(w.shape[0], n, -1)
        out.append(w.sum(dim=1)[:, None, None] - torch.matmul(xw, x.T))
    return torch.cat(out)


def p_distance_matrix(leaf_sequences, n_states: int, site_weights=None) -> torch.Tensor:
    """Proportion of differing sites per pair (the Hamming count over the
    total site weight)."""
    counts = hamming_distance_matrix(leaf_sequences, n_states, site_weights)
    if site_weights is None:
        return counts / torch.as_tensor(leaf_sequences).shape[-1]
    total = _f32(site_weights, device=counts.device).sum(dim=-1)
    return counts / (total[:, None, None] if total.dim() else total)


def jc_distance_matrix(leaf_sequences, n_states: int, site_weights=None) -> torch.Tensor:
    """Jukes-Cantor-corrected distances, ``d = -(Q-1)/Q log(1 - Q/(Q-1) p)``
    generalised to Q states; saturated pairs (p >= (Q-1)/Q) are clamped
    just below the pole, so the result stays finite and ordered."""
    p = p_distance_matrix(leaf_sequences, n_states, site_weights)
    a = (n_states - 1) / n_states
    p = torch.clamp(p, max=a * (1.0 - 1e-6))
    return -a * torch.log1p(-p / a)
