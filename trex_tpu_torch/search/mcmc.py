"""Bayesian phylogenetic MCMC: Metropolis-coupled chains as one device batch
(counterpart of ``trex_tpu/search/mcmc.py``).

Every run x chain is a row of one batched state on the device: children
(C, n_anc, 2), branch lengths (C, n_all), log-likelihoods, the model
simplices and the acceptance counters. A generation is ``branch_moves``
single-branch multipliers, one Dirichlet move on each model simplex
(``sample_model``), one NNI Metropolis move (the pointer swap of
``ops.tree_moves``, lengths carried by index) and one MC^3 swap a run,
all as tensor operations on the batch; the host reads the state only at a
block boundary (a sample, a progress line, a checkpoint, the stop). Chain
k of a run targets posterior^beta_k, beta_k = 1 / (1 + heat k); only the
cold chain is sampled, and samples are canonicalized and rerooted on leaf
0 on the host before the split summaries.

Scoring (``_build_eval``): every chain batch's likelihood is one call of
K4, the hand-written pruning kernel with a P a branch and tree
(``ops.likelihood_cuda.batched_log_likelihood_cuda``; its plain version on
CPU tensors); under +G, K4's per-site mode on chains x categories trees.
The informed proposal's neighbourhoods go through the analytic rescoring
scan (``ops.nni_scan``), replayed on the card as one CUDA graph a call
(``GraphedCall``). The JAX sampler scores with lax; this design is the
port's own.

Draws come from a ``draws`` source with one method a kind of draw
(``TorchDraws``: a ``torch.Generator`` on the run's device); the step
calls them in the reference step's order, so a source that replays the
JAX package's key schedule reproduces its trajectories. The start state
comes from ``numpy.random.default_rng(seed)``, as the reference's does for
``PRNGKey(seed)``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from trex_tpu_torch.ops.likelihood import highest_matmul_precision
from trex_tpu_torch.topology import Topology, from_numpy

_GAMMA_ROUNDS = 8  # Marsaglia-Tsang rounds a gamma draw (none accepts: < 1e-10)


@dataclasses.dataclass
class McmcResult:
    """Posterior sample and summaries of ``mcmc_sample``."""

    sample_children: np.ndarray
    """(n_samples, n_anc, 2) canonical cold-chain topologies, all runs
    pooled, after burn-in."""
    sample_lengths: np.ndarray
    """(n_samples, n_all) their branch lengths."""
    sample_lnl: np.ndarray
    """(n_samples,) their log-likelihoods."""
    sample_run: np.ndarray
    """(n_samples,) the run of each sample."""
    split_posterior: dict[frozenset[int], float]
    """Posterior probability of every sampled split."""
    consensus_newick: str
    """Majority-rule consensus with clade posteriors as labels."""
    acceptance: dict[str, float]
    """Acceptance rates by move ('branch', 'topology', 'swap'[, 'model'])."""
    asdsf: float | None
    """Average standard deviation of split frequencies across runs (None
    for one run)."""
    ess_lnl: float
    """Effective sample size of the cold-chain lnL traces, summed over runs."""
    generations: int
    mean_lengths: np.ndarray
    """(n_all,) pooled mean length per canonical node index."""
    sample_rates: np.ndarray | None = None
    """(n_samples, Q(Q-1)/2) sampled exchangeability simplices, or None."""
    sample_freqs: np.ndarray | None = None
    """(n_samples, Q) sampled frequency simplices, or None."""


def _exp_logprior(lengths: torch.Tensor, rate: float) -> torch.Tensor:
    """log p(lengths) under iid Exponential(rate), the root entry excluded
    (log rate in float32, as the reference takes it; a host constant, so
    the call copies nothing to the device)."""
    log_rate = float(np.log(np.float32(rate)))
    return log_rate * (lengths.shape[-1] - 1) - rate * lengths[..., :-1].sum(dim=-1)


def _pairs_to_matrix(vec: torch.Tensor, q: int) -> torch.Tensor:
    """(..., Q(Q-1)/2) upper-triangle exchangeabilities -> (..., Q, Q)
    symmetric, zero diagonal."""
    iu = torch.triu_indices(q, q, 1, device=vec.device)
    m = torch.zeros(vec.shape[:-1] + (q, q), dtype=vec.dtype, device=vec.device)
    m[..., iu[0], iu[1]] = vec
    return m + m.transpose(-1, -2)


def _matrix_to_pairs(m: np.ndarray, q: int) -> np.ndarray:
    iu = np.triu_indices(q, 1)
    vec = np.asarray(m, dtype=np.float64)[iu]
    return (vec / vec.sum()).astype(np.float32)


def _dirichlet_logpdf(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """(...,) log Dirichlet(alpha) densities of simplices x (..., P)."""
    return (torch.lgamma(alpha.sum(dim=-1)) - torch.lgamma(alpha).sum(dim=-1)
            + ((alpha - 1.0) * torch.log(x)).sum(dim=-1))


class TorchDraws:
    """The samplers' draws from one ``torch.Generator``, moved to ``device``
    (default: the generator's). Uniforms in [0, 1), standard normals,
    Gumbels (-log(-log u)), integers in [low, high), and gamma and
    Dirichlet draws (Marsaglia-Tsang on ``_GAMMA_ROUNDS`` rounds of a
    normal and a uniform, boosted by u^(1/a) below shape 1, in log space;
    a Dirichlet normalises the log-gammas by a softmax). The draw count of
    each call is fixed, so no call syncs with the host. ``get_state`` and
    ``set_state`` carry the generator across a checkpoint."""

    def __init__(self, generator: torch.Generator, device=None) -> None:
        self.generator = generator
        self.device = torch.device(device) if device is not None else generator.device

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        return x if x.device == self.device else x.to(self.device)

    def uniform(self, shape) -> torch.Tensor:
        g = self.generator
        return self._out(torch.rand(shape, generator=g, device=g.device))

    def normal(self, shape) -> torch.Tensor:
        g = self.generator
        return self._out(torch.randn(shape, generator=g, device=g.device))

    def randint(self, shape, low: int, high: int) -> torch.Tensor:
        g = self.generator
        return self._out(torch.randint(low, high, shape, generator=g, device=g.device))

    def gumbel(self, shape) -> torch.Tensor:
        u = self.uniform(shape)
        return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))

    def log_gamma(self, concentration: torch.Tensor) -> torch.Tensor:
        """log of Gamma(concentration, 1) draws, one an entry."""
        alpha = concentration.to(torch.float32)
        boost = alpha < 1.0
        a = torch.where(boost, alpha + 1.0, alpha)
        d = a - 1.0 / 3.0
        c = torch.rsqrt(9.0 * d)
        x = self.normal((_GAMMA_ROUNDS,) + tuple(alpha.shape))
        u = self.uniform((_GAMMA_ROUNDS,) + tuple(alpha.shape))
        v = (1.0 + c * x) ** 3
        log_v = torch.log(torch.clamp(v, min=1e-30))
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
        first = ok.to(torch.uint8).argmax(dim=0, keepdim=True)
        out = torch.log(d) + log_v.gather(0, first)[0]
        lift = torch.log(self.uniform(tuple(alpha.shape))) / alpha
        return torch.where(boost, out + lift, out)

    def gamma(self, concentration, shape) -> torch.Tensor:
        alpha = torch.full(tuple(shape), float(concentration), device=self.device)
        return torch.exp(self.log_gamma(alpha))

    def dirichlet(self, alpha: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.log_gamma(alpha), dim=-1)

    def get_state(self) -> np.ndarray:
        return self.generator.get_state().numpy().copy()

    def set_state(self, state: np.ndarray) -> None:
        self.generator.set_state(torch.as_tensor(np.asarray(state, dtype=np.uint8)))


def metropolis_accept(u: torch.Tensor, log_alpha: torch.Tensor) -> torch.Tensor:
    """log u < log alpha: the accept test of every move of the samplers
    (``u`` the move's uniform draw)."""
    return torch.log(u) < log_alpha


def default_draws(seed: int, device) -> TorchDraws:
    """The CLI's draws: a generator on ``device`` seeded with ``seed``."""
    return TorchDraws(torch.Generator(device).manual_seed(int(seed)))


# --- transition matrices --------------------------------------------------


@highest_matmul_precision
def gtr_eigensystem_batched(rates: torch.Tensor, freqs: torch.Tensor):
    """(eigenvalues (B, Q), left (B, Q, Q), right (B, Q, Q)) of B
    normalised GTR generators (``ops.likelihood.gtr_eigensystem``'s
    arithmetic a batch at a time)."""
    q = freqs.shape[-1]
    eye = torch.eye(q, device=freqs.device)
    sym = (rates + rates.transpose(-1, -2)) / 2.0
    gen = sym * freqs[:, None, :] * (1.0 - eye)
    gen = gen - torch.diag_embed(gen.sum(dim=-1))
    scale = -(freqs * torch.diagonal(gen, dim1=-2, dim2=-1)).sum(dim=-1)
    gen = gen / scale[:, None, None]
    sqrt_pi = torch.sqrt(freqs)
    balanced = sqrt_pi[:, :, None] * gen / sqrt_pi[:, None, :]
    eigvals, eigvecs = torch.linalg.eigh((balanced + balanced.transpose(-1, -2)) / 2.0)
    right = eigvecs / sqrt_pi[:, :, None]
    left = eigvecs.transpose(-1, -2) * sqrt_pi[:, None, :]
    return eigvals, left, right


@highest_matmul_precision
def gtr_pmats(lengths: torch.Tensor, eigvals, left, right) -> torch.Tensor:
    """(B, n_all, Q, Q) GTR transition matrices of (B, n_all) lengths from
    one eigensystem ((Q,), (Q, Q), (Q, Q)) or one a row ((B, Q), ...)."""
    if eigvals.dim() == 1:
        eigvals, left, right = eigvals[None], left[None], right[None]
    decay = torch.exp(eigvals[:, None, :] * lengths[:, :, None])
    p = torch.matmul(right[:, None] * decay[:, :, None, :], left[:, None])
    return torch.clamp(p, 0.0, 1.0)


def _build_eval(leaves, n_states, site_weights, sequences_are_masks, rates, freqs,
                gamma_shape, n_categories, sample_model):
    """The sampler's batched data-lnL evaluator on the leaves' device.

    Returns ``(batched_eval, nbr_lnl)``. ``batched_eval(children (B, n_anc,
    2) int32, lengths (B, n_all), rates_v (B, P), freqs_v (B, Q)) -> (B,)``
    is one K4 call with a (B, n_all, Q, Q) P table (JC69, or GTR from the
    eigensystem); with ``sample_model`` each row's own eigensystem, its
    frequencies folded into the root's first child's P (K4 takes one root
    prior: sum_s pi_s A_s B_s = sum_s (diag(pi) A)_s B_s) and a ones prior;
    under +G K4's per-site mode on the B x K trees of the category-scaled
    lengths, a logsumexp over categories less log K, then the weighted
    sum. ``nbr_lnl(children, lengths, rates_v, freqs_v) -> (B, K)`` scores
    every NNI neighbour through ``ops.nni_scan``; None under +G, where the
    caller scores the neighbourhood's trees directly.
    """
    from trex_tpu_torch.ops.likelihood import (
        discrete_gamma_rates,
        gtr_eigensystem,
        jc69_transition,
    )
    from trex_tpu_torch.ops.likelihood_cuda import batched_log_likelihood_cuda
    from trex_tpu_torch.ops.nni_scan import nni_neighborhood_lnl

    q = n_states
    device = leaves.device
    length = leaves.shape[1]
    weights = (torch.ones((length,), device=device) if site_weights is None
               else site_weights.to(device=device, dtype=torch.float32).contiguous())
    ones = torch.ones((q,), device=device)
    cats = None
    if gamma_shape is not None:
        cats = discrete_gamma_rates(torch.tensor(float(gamma_shape), device=device), n_categories)
    fixed = None
    prior = torch.full((q,), 1.0 / q, device=device)
    if not sample_model and (rates is not None or freqs is not None):
        prior = prior if freqs is None else torch.as_tensor(freqs, device=device).float()
        eig_rates = (torch.ones((q, q), device=device) if rates is None
                     else torch.as_tensor(rates, device=device).float())
        fixed = gtr_eigensystem(eig_rates, prior)

    def model(children, lengths, rates_v, freqs_v):
        """(P table (B, n_all, Q, Q), the root prior K4 takes, the
        unfolded P table or None for JC, the nni_scan root prior)."""
        if sample_model:
            eig = gtr_eigensystem_batched(_pairs_to_matrix(rates_v, q), freqs_v)
            pmats = gtr_pmats(lengths, *eig)
            folded = pmats.clone()
            rows = torch.arange(children.shape[0], device=device)
            c1 = children[:, -1, 0].long()
            folded[rows, c1] = folded[rows, c1] * freqs_v[:, :, None]
            return folded, ones, pmats, freqs_v
        if fixed is not None:
            pmats = gtr_pmats(lengths, *fixed)
            return pmats, prior, pmats, prior
        return jc69_transition(lengths, q), prior, None, None

    def batched_eval(children, lengths, rates_v=None, freqs_v=None):
        children = children.to(torch.int32)
        if cats is None:
            pmats, root, _, _ = model(children, lengths, rates_v, freqs_v)
            return batched_log_likelihood_cuda(
                children.contiguous(), leaves, weights, root, pmats.contiguous(),
                sequences_are_masks=sequences_are_masks)
        batch, k = children.shape[0], cats.shape[0]
        scaled = (lengths[:, None, :] * cats[None, :, None]).reshape(batch * k, -1)
        rep = lambda x: None if x is None else x.repeat_interleave(  # noqa: E731
            k, dim=0, output_size=batch * k)
        kids = rep(children)
        pmats, root, _, _ = model(kids, scaled, rep(rates_v), rep(freqs_v))
        _, rows = batched_log_likelihood_cuda(
            kids.contiguous(), leaves, torch.ones_like(weights), root, pmats.contiguous(),
            sequences_are_masks=sequences_are_masks, per_site=True)
        per_site = torch.logsumexp(rows.view(batch, k, -1), dim=1) - math.log(k)
        return (per_site * weights).sum(dim=-1)

    def scan(children, lengths, pmats, root):
        return nni_neighborhood_lnl(
            children, lengths, leaves, q, transition_matrices=pmats, root_prior=root,
            site_weights=weights, sequences_are_masks=sequences_are_masks)

    if device.type == "cuda":
        scan = GraphedCall(scan)

    def nbr_lnl(children, lengths, rates_v=None, freqs_v=None):
        _, _, pmats, root = model(children, lengths, rates_v, freqs_v)
        return scan(children, lengths, pmats, root)

    return batched_eval, (nbr_lnl if cats is None else None)


class GraphedCall:
    """``fn`` of tensors (or None) on the card, captured as one CUDA graph
    on its first call and replayed on every later one, whose tensors must
    have the first call's shapes: each call copies its inputs into the
    graph's static tensors, replays and returns a copy of the output. For
    the informed proposal's neighbourhood scan, about 1,600 small launches
    a call whose host cost dominates a generation. The first call runs
    ``fn`` twice on a side stream, then captures (both sync with the host);
    later calls do not."""

    def __init__(self, fn) -> None:
        self.fn = fn
        self.graph = None

    def __call__(self, *tensors):
        if self.graph is None:
            self.static = [None if t is None else t.clone() for t in tensors]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(2):
                    self.fn(*self.static)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self.fn(*self.static)
        for buf, t in zip(self.static, tensors, strict=True):
            if buf is not None:
                assert t.shape == buf.shape, (t.shape, buf.shape)
                buf.copy_(t)
        self.graph.replay()
        return self.out.clone()


# --- host carries and diagnostics -------------------------------------------


def carry_lengths_nni(old_topology: Topology, old_lengths: np.ndarray,
                      new_topology: Topology) -> np.ndarray:
    """Branch lengths carried across a rearrangement by clade identity:
    persisting clades keep their length, changed clades take the leftover
    ones by sorted clade rank (an involution: carried back it restores the
    old assignment)."""
    from trex_tpu_torch.search.bootstrap import subtree_leaf_sets

    n_leaves = old_topology.n_leaves
    old_sets = subtree_leaf_sets(old_topology)
    new_sets = subtree_leaf_sets(new_topology)
    old_map = {s: float(old_lengths[n_leaves + i]) for i, s in enumerate(old_sets)}
    new_set_set = set(new_sets)
    rank = lambda s: tuple(sorted(s))  # noqa: E731
    leftover = sorted((s for s in old_map if s not in new_set_set), key=rank)
    changed = sorted((s for s in new_sets if s not in old_map), key=rank)
    assert len(leftover) == len(changed)
    inherit = {c: old_map[o] for c, o in zip(changed, leftover)}
    out = np.array(old_lengths, dtype=np.float32, copy=True)
    for i, s in enumerate(new_sets):
        out[n_leaves + i] = old_map.get(s, inherit.get(s, 0.0))
    return out


def _clade_hash_batch(children_batch: np.ndarray, n_leaves: int, salt: np.ndarray) -> np.ndarray:
    """(B, n_all) additive clade hashes: a node's is the sum of its leaves'
    salts (uint64 wraparound)."""
    b, n_anc, _ = children_batch.shape
    h = np.zeros((b, n_leaves + n_anc), np.uint64)
    h[:, :n_leaves] = salt[None, :]
    rows = np.arange(b)
    for a in range(n_anc):
        h[:, n_leaves + a] = h[rows, children_batch[:, a, 0]] + h[rows, children_batch[:, a, 1]]
    return h


def _carry_lengths_nni_batch(old_children: np.ndarray, old_lengths: np.ndarray,
                             nbr_children: np.ndarray, n_leaves: int,
                             salt: np.ndarray) -> np.ndarray:
    """``carry_lengths_nni`` over a whole NNI neighbourhood by clade hashes
    and ``searchsorted``; each neighbour's one changed clade inherits the
    one leftover length."""
    n_anc = n_leaves - 1
    b = nbr_children.shape[0]
    old_h = _clade_hash_batch(old_children[None], n_leaves, salt)[0]
    new_h = _clade_hash_batch(nbr_children, n_leaves, salt)
    anc_old_h = old_h[n_leaves:]
    order = np.argsort(anc_old_h, kind="stable")
    sorted_h = anc_old_h[order]
    anc_len_sorted = old_lengths[n_leaves:][order]
    idx = np.minimum(np.searchsorted(sorted_h, new_h[:, n_leaves:]), n_anc - 1)
    match = sorted_h[idx] == new_h[:, n_leaves:]
    out = np.broadcast_to(old_lengths.astype(np.float32), (b, 2 * n_leaves - 1)).copy()
    out[:, n_leaves:] = np.where(match, anc_len_sorted[idx], 0.0)
    miss_rows, miss_cols = np.where(~match)
    if miss_rows.size:
        assert miss_rows.size == b and np.array_equal(miss_rows, np.arange(b)), \
            "NNI neighbors must each change exactly one clade"
        total = anc_old_h.sum(dtype=np.uint64)
        matched = np.where(match, sorted_h[idx], np.uint64(0)).sum(axis=1, dtype=np.uint64)
        pos = np.minimum(np.searchsorted(sorted_h, total - matched), n_anc - 1)
        out[miss_rows, n_leaves + miss_cols] = anc_len_sorted[pos]
    return out


def effective_sample_size(trace: np.ndarray) -> float:
    """ESS by the initial positive sequence estimator (Geyer 1992)."""
    x = np.asarray(trace, dtype=np.float64)
    n = x.size
    if n < 4:
        return float(n)
    x = x - x.mean()
    var = float(np.dot(x, x) / n)
    if var <= 0:
        return float(n)
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, m)
    rho = np.fft.irfft(f * np.conjugate(f), m)[:n].real / n / var
    s = 0.0
    for k in range(1, n // 2):
        pair = rho[2 * k - 1] + rho[2 * k]
        if pair <= 0:
            break
        s += pair
    return float(min(max(n / (1.0 + 2.0 * s), 1.0), n))


def average_stddev_split_freqs(per_run_samples: list[list[Topology]],
                               min_freq: float = 0.1) -> float | None:
    """ASDSF between independent runs (splits above ``min_freq`` in any)."""
    from trex_tpu_torch.search.consensus import split_frequencies

    if len(per_run_samples) < 2:
        return None
    freqs = [split_frequencies(s) for s in per_run_samples if s]
    if len(freqs) < 2:
        return None
    splits = {s for f in freqs for s, v in f.items() if v >= min_freq}
    if not splits:
        return 0.0
    return float(np.mean([float(np.std([f.get(s, 0.0) for f in freqs])) for s in splits]))


# --- the sampler ----------------------------------------------------------


@dataclasses.dataclass
class McmcState:
    """The chains' state on the device: children (C, n_anc, 2) int32,
    lengths (C, n_all), lnl (C,), rates (C, P or 1), freqs (C, Q or 1) and
    the accepted counts (4,) int64 [branch, topology, swap, model]."""

    children: torch.Tensor
    lengths: torch.Tensor
    lnl: torch.Tensor
    rates: torch.Tensor
    freqs: torch.Tensor
    acc: torch.Tensor

    @classmethod
    def from_numpy(cls, arrays, device) -> "McmcState":
        """The state from host arrays with the reference checkpoint's keys
        (``children``, ``lengths``, ``lnl``, ``rates``, ``freqs``, ``acc``)."""
        def put(key, dtype):
            return torch.as_tensor(np.asarray(arrays[key]), device=device).to(dtype)

        return cls(put("children", torch.int32), put("lengths", torch.float32),
                   put("lnl", torch.float32), put("rates", torch.float32),
                   put("freqs", torch.float32), put("acc", torch.int64))

    def to_numpy(self) -> dict:
        return {"children": self.children.cpu().numpy().astype(np.int32),
                "lengths": self.lengths.cpu().numpy(), "lnl": self.lnl.cpu().numpy(),
                "rates": self.rates.cpu().numpy(), "freqs": self.freqs.cpu().numpy(),
                "acc": self.acc.cpu().numpy().astype(np.int32)}


def mcmc_sample(
    leaf_sequences,
    n_states: int,
    *,
    seed: int = 0,
    draws=None,
    device=None,
    mesh=None,
    n_generations: int = 10_000,
    n_runs: int = 2,
    n_chains: int = 4,
    heat: float = 0.1,
    sample_every: int = 20,
    burnin_frac: float = 0.25,
    branch_moves_per_gen: int = 1,
    topo_moves: bool = True,
    topo_proposal: str = "informed",
    topo_informed_power: float = 0.1,
    brlen_prior_mean: float = 0.1,
    tuning: float = 1.4,
    start: Topology | None = None,
    start_lengths: np.ndarray | None = None,
    site_weights=None,
    sequences_are_masks: bool = False,
    rates=None,
    freqs=None,
    gamma_shape: float | None = None,
    n_categories: int = 4,
    sample_model: bool = False,
    model_tuning: float = 500.0,
    leaf_names: list[str] | None = None,
    prior_only: bool = False,
    progress_every: int = 0,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1000,
    stop_after_generations: int | None = None,
    timings: dict | None = None,
) -> McmcResult:
    """Sample the tree posterior with Metropolis-coupled chains (the
    reference's arguments; ``seed`` and ``draws`` take the place of its
    key; ``device`` is the leaves' device when they are a tensor, else
    ``cuda``).

    ``seed`` seeds the numpy start state (random start trees from
    ``io.sample_topologies``, Exponential start lengths) and, without
    ``draws``, the run's generator (``TorchDraws``). ``topo_proposal``:
    "informed" draws the NNI neighbour by exp(p beta lnL) over the whole
    neighbourhood (``topo_informed_power`` p), with the ratio of the two
    neighbourhoods' normalisers as Hastings term; "nni" a uniform one.
    ``sample_model`` samples GTR exchangeability and frequency simplices
    under flat Dirichlet priors (``rates``/``freqs`` seed them). Resume
    from ``<checkpoint_dir>/mcmc_checkpoint.npz`` is bit-identical to an
    uninterrupted run; keep ``n_generations`` across legs and bound a leg
    with ``stop_after_generations`` (both intervals round up to whole
    ``sample_every`` blocks). ``timings``: a dict that, when given,
    receives the wall seconds of the generations ("sampler": from the
    first block to the samples read on the host, the scan's CUDA graph
    already captured).

    ``mesh``: a ('tree', 'site') ``parallel.mesh.Mesh`` (None: this rank
    alone, ``local_mesh``) whose ``tree`` axis splits the runs x chains
    batch, which it must divide (``parallel.chains``). Every rank draws
    each draw of the whole batch from the same stream and takes its rows
    (a Dirichlet move gathers the batch's concentrations first), so the
    trajectories are the single-device ones: every float operation is per
    chain; the accept counters are summed over ``tree`` and an MC^3 swap
    whose pair of chains straddles two ranks is decided on the gathered
    batch, every rank taking its rows of the swapped state. Cold-chain
    snapshots stay on each rank until a host boundary gathers them; the
    checkpoint holds the whole state, written by the mesh's first rank
    (a checkpoint resumes on any mesh). Every rank returns the same
    result.
    """
    from trex_tpu_torch._device import resolve_device
    from trex_tpu_torch.io import canonicalize_topology, reroot_on_outgroup, sample_topologies
    from trex_tpu_torch.ops.tree_moves import nni_neighbor_device, nni_neighborhood_device
    from trex_tpu_torch.parallel.chains import (
        chain_rows,
        gather_packed,
        gather_rows,
        mesh_barrier,
        psum_counts,
    )
    from trex_tpu_torch.parallel.mesh import is_output_rank, local_mesh
    from trex_tpu_torch.search.consensus import majority_rule_consensus, split_frequencies

    if device is None:
        device = leaf_sequences.device if torch.is_tensor(leaf_sequences) else "cuda"
    device = resolve_device(device)
    leaves = torch.as_tensor(np.asarray(leaf_sequences.cpu() if torch.is_tensor(leaf_sequences)
                                        else leaf_sequences), device=device).to(torch.int32)
    n_leaves = int(leaves.shape[0])
    n_anc = n_leaves - 1
    n_all = 2 * n_leaves - 1
    n_total = n_runs * n_chains
    prior_rate = 1.0 / brlen_prior_mean
    do_topo = topo_moves and n_leaves >= 4
    n_nbr = 2 * (n_leaves - 2)
    n_pairs = n_states * (n_states - 1) // 2
    if topo_proposal not in ("informed", "nni"):
        raise ValueError(f"unknown topo_proposal {topo_proposal!r}")
    mesh = mesh or local_mesh()
    mine = chain_rows(mesh, n_total, "n_runs * n_chains")
    n_local = mine.stop - mine.start
    if draws is None:
        draws = default_draws(seed, device)
    rng = np.random.default_rng(int(seed))

    # --- initial state -------------------------------------------------------
    if start is not None:
        children_host = np.broadcast_to(
            np.asarray(start.children.cpu(), dtype=np.int32)[None], (n_total, n_anc, 2)).copy()
    else:
        starts = sample_topologies(int(rng.integers(2**31)), n_leaves, n_total, device="cpu")
        children_host = starts.children.numpy().astype(np.int32).copy()
    if start_lengths is not None:
        lengths_host = np.broadcast_to(
            np.asarray(start_lengths, dtype=np.float32)[None], (n_total, n_all)).copy()
    else:
        lengths_host = rng.exponential(brlen_prior_mean, size=(n_total, n_all)).astype(np.float32)
    lengths_host[:, -1] = 0.0

    weights = None if site_weights is None else torch.as_tensor(
        np.asarray(site_weights.cpu() if torch.is_tensor(site_weights) else site_weights),
        dtype=torch.float32, device=device)
    if prior_only:
        leaves = torch.zeros((n_leaves, 1), dtype=torch.int32, device=device)
        weights = torch.zeros((1,), device=device)
    batched_eval, nbr_lnl = _build_eval(
        leaves, n_states, weights, sequences_are_masks, rates, freqs, gamma_shape,
        n_categories, sample_model)

    if sample_model:
        rates0 = (_matrix_to_pairs(np.asarray(torch.as_tensor(rates).cpu()), n_states)
                  if rates is not None else np.full((n_pairs,), 1.0 / n_pairs, np.float32))
        if freqs is not None:
            f0 = np.asarray(torch.as_tensor(freqs).cpu(), np.float64)
            freqs0 = (f0 / f0.sum()).astype(np.float32)
        else:
            freqs0 = np.full((n_states,), 1.0 / n_states, np.float32)
        rates_host = np.broadcast_to(rates0, (n_total, n_pairs)).copy()
        freqs_host = np.broadcast_to(freqs0, (n_total, n_states)).copy()
    else:
        rates_host = np.zeros((n_total, 1), np.float32)
        freqs_host = np.zeros((n_total, 1), np.float32)

    beta_all = torch.as_tensor(np.array(
        [1.0 / (1.0 + heat * k) for _ in range(n_runs) for k in range(n_chains)],
        dtype=np.float32), device=device)
    beta = beta_all[mine]
    rows = torch.arange(n_local, device=device)
    power = topo_informed_power
    # The MC^3 swap: a rank whose rows hold whole runs swaps its own runs'
    # chains; where a run straddles two ranks, every rank decides every
    # run's swap on the gathered batch and takes its rows of the result
    # (rank 0 counts the swaps).
    straddles = n_chains > 1 and n_local % n_chains != 0
    if straddles:
        swap_runs, swap_rows, keep = slice(0, n_runs), torch.arange(n_total, device=device), mine
        swap_beta = beta_all
    else:
        swap_runs = slice(mine.start // n_chains, mine.stop // n_chains)
        swap_rows, keep, swap_beta = rows, slice(None), beta
    swap_first = torch.arange(swap_runs.stop - swap_runs.start, device=device) * n_chains
    count_swaps = int(not straddles or mesh.tree_index == 0)
    # Cold-chain snapshots: each rank keeps its rows of the cold chains
    # (padded with row 0 to the most any rank holds); ``cold_order`` picks
    # the runs' rows, in run order, out of the gathered snapshots.
    cold_chains = range(0, n_total, n_chains)
    colds = [[c % n_local for c in cold_chains if c // n_local == t]
             for t in range(n_total // n_local)]
    width = max(map(len, colds))
    cold = torch.as_tensor((colds[mesh.tree_index] + [0] * width)[:width], device=device)
    cold_order = [c // n_local * width + colds[c // n_local].index(c % n_local)
                  for c in cold_chains]

    def ev(ch, ln, rv, fv):
        return batched_eval(ch, ln, rv, fv) if sample_model else batched_eval(ch, ln)

    def neighbourhood_lnl(ch, ln, rv, fv):
        if nbr_lnl is not None:
            return nbr_lnl(ch, ln, rv, fv) if sample_model else nbr_lnl(ch, ln)
        nbr_c, nbr_l = nni_neighborhood_device(ch, ln, n_leaves)
        rep = lambda x: x.repeat_interleave(n_nbr, dim=0, output_size=n_local * n_nbr)  # noqa: E731
        return ev(nbr_c.reshape(-1, n_anc, 2), nbr_l.reshape(-1, n_all), rep(rv),
                  rep(fv)).view(n_local, n_nbr)

    def simplex_move(s: McmcState, x, evaluate):
        alpha = model_tuning * x
        # Each row's concentration shapes its draw: the whole batch's, then ours.
        prop = draws.dirichlet(gather_rows(mesh, alpha))[mine]
        lq_fwd = _dirichlet_logpdf(prop, alpha)
        lq_rev = _dirichlet_logpdf(x, model_tuning * prop)
        inside = prop.amin(dim=-1) >= 1e-5
        # A proposal outside the truncated prior is rejected whatever its lnL; the
        # current simplex stands in for it, so no eigensystem sees a degenerate one.
        prop_lnl = evaluate(torch.where(inside[:, None], prop, x))
        log_alpha = beta * (prop_lnl - s.lnl) + lq_rev - lq_fwd
        take = inside & metropolis_accept(draws.uniform((n_total,))[mine], log_alpha)
        return take, prop, prop_lnl

    def gen_step(s: McmcState) -> None:
        """One generation on ``s`` (its tensors rebound)."""
        if branch_moves_per_gen > 0:
            logprior = _exp_logprior(s.lengths, prior_rate)
            for _ in range(branch_moves_per_gen):
                node = draws.randint((n_total,), 0, n_all - 1)[mine]
                factor = torch.exp(tuning * (draws.uniform((n_total,))[mine] - 0.5))
                old = s.lengths.gather(1, node[:, None])[:, 0]
                new = old * factor
                prop = s.lengths.scatter(1, node[:, None], new[:, None])
                prop_lnl = ev(s.children, prop, s.rates, s.freqs)
                prop_logprior = logprior - prior_rate * (new - old)
                log_alpha = (beta * (prop_lnl - s.lnl + prop_logprior - logprior)
                             + torch.log(factor))
                take = metropolis_accept(draws.uniform((n_total,))[mine], log_alpha)
                s.lengths = torch.where(take[:, None], prop, s.lengths)
                s.lnl = torch.where(take, prop_lnl, s.lnl)
                logprior = torch.where(take, prop_logprior, logprior)
                s.acc[0] += take.sum()
        if sample_model:
            take, prop, prop_lnl = simplex_move(
                s, s.rates, lambda rv: batched_eval(s.children, s.lengths, rv, s.freqs))
            s.rates = torch.where(take[:, None], prop, s.rates)
            s.lnl = torch.where(take, prop_lnl, s.lnl)
            s.acc[3] += take.sum()
            take, prop, prop_lnl = simplex_move(
                s, s.freqs, lambda fv: batched_eval(s.children, s.lengths, s.rates, fv))
            s.freqs = torch.where(take[:, None], prop, s.freqs)
            s.lnl = torch.where(take, prop_lnl, s.lnl)
            s.acc[3] += take.sum()
        if do_topo:
            if topo_proposal == "informed":
                lnl_x_nbr = neighbourhood_lnl(s.children, s.lengths, s.rates, s.freqs)
                logw_x = power * beta[:, None] * lnl_x_nbr
                z_x = torch.logsumexp(logw_x, dim=1)
                pick = torch.argmax(draws.gumbel((n_total, n_nbr))[mine] + logw_x, dim=1)
                prop_lnl = lnl_x_nbr[rows, pick]
                prop_c, prop_l = nni_neighbor_device(
                    s.children, s.lengths, pick // 2, pick % 2, n_leaves)
                lnl_y_nbr = neighbourhood_lnl(prop_c, prop_l, s.rates, s.freqs)
                z_y = torch.logsumexp(power * beta[:, None] * lnl_y_nbr, dim=1)
                log_alpha = (1.0 - power) * beta * (prop_lnl - s.lnl) + z_x - z_y
            else:
                edge = draws.randint((n_total,), 0, n_anc - 1)[mine]
                variant = draws.randint((n_total,), 0, 2)[mine]
                prop_c, prop_l = nni_neighbor_device(s.children, s.lengths, edge, variant,
                                                     n_leaves)
                prop_lnl = ev(prop_c, prop_l, s.rates, s.freqs)
                log_alpha = beta * (prop_lnl - s.lnl)
            take = metropolis_accept(draws.uniform((n_total,))[mine], log_alpha)
            s.children = torch.where(take[:, None, None], prop_c, s.children)
            s.lengths = torch.where(take[:, None], prop_l, s.lengths)
            s.lnl = torch.where(take, prop_lnl, s.lnl)
            s.acc[1] += take.sum()
        if n_chains > 1:
            pick = draws.randint((n_runs,), 0, n_chains - 1)[swap_runs]
            u = draws.uniform((n_runs,))[swap_runs]
            parts = [s.children, s.lengths, s.lnl, s.rates, s.freqs]
            if straddles:
                parts = gather_packed(mesh, parts)
            children, lengths, lnl, rates_v, freqs_v = parts
            i = swap_first + pick
            j = i + 1
            post = lnl + _exp_logprior(lengths, prior_rate)
            log_alpha = (swap_beta[i] - swap_beta[j]) * (post[j] - post[i])
            take = metropolis_accept(u, log_alpha)
            shift = (((swap_rows[None, :] == i[:, None]).long()
                      - (swap_rows[None, :] == j[:, None]).long())
                     * take[:, None].long()).sum(dim=0)
            perm = (swap_rows + shift)[keep]
            s.children, s.lengths, s.lnl = children[perm], lengths[perm], lnl[perm]
            s.rates, s.freqs = rates_v[perm], freqs_v[perm]
            s.acc[2] += take.sum() * count_swaps

    total_blocks = n_generations // sample_every
    trailing = n_generations - total_blocks * sample_every
    n_burnin = int(burnin_frac * n_generations)

    # --- checkpoint / resume ---------------------------------------------------
    samples_children: list[np.ndarray] = []
    samples_lengths: list[np.ndarray] = []
    samples_lnl: list[float] = []
    samples_run: list[int] = []
    samples_rates: list[np.ndarray] = []
    samples_freqs: list[np.ndarray] = []
    gens_done = 0
    host = {"children": children_host, "lengths": lengths_host, "rates": rates_host,
            "freqs": freqs_host, "acc": np.zeros((4,), np.int32)}
    lnl_host = None
    ckpt_path = None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        ckpt_path = os.path.join(checkpoint_dir, "mcmc_checkpoint.npz")
        if os.path.exists(ckpt_path):
            ck = np.load(ckpt_path, allow_pickle=False)
            gens_done = int(ck["gens_done"])
            host = {key: ck[key].copy() for key in host}
            # The chains' lnL is part of the state: rescoring could differ in
            # the last bits and flip a later accept.
            lnl_host = ck["lnl"].copy()
            draws.set_state(ck["draws_state"])
            samples_children = list(ck["s_children"])
            samples_lengths = list(ck["s_lengths"])
            samples_lnl = list(ck["s_lnl"])
            samples_run = list(ck["s_run"])
            if sample_model and "s_rates" in ck:
                samples_rates = list(ck["s_rates"])
                samples_freqs = list(ck["s_freqs"])
    # This rank's rows; the counters' sum over 'tree' is the checkpoint's.
    host = {key: value if key == "acc" else value[mine] for key, value in host.items()}
    if mesh.tree_index:
        host["acc"] = np.zeros_like(host["acc"])
    if lnl_host is None:
        start_state = McmcState.from_numpy(dict(host, lnl=np.zeros(n_local, np.float32)), device)
        lnl_host = ev(start_state.children, start_state.lengths, start_state.rates,
                      start_state.freqs).cpu().numpy()
    else:
        lnl_host = lnl_host[mine]
    state = McmcState.from_numpy(dict(host, lnl=lnl_host), device)
    if do_topo and topo_proposal == "informed" and nbr_lnl is not None:
        # Builds the scan's CUDA graph (on the card) before the first block.
        neighbourhood_lnl(state.children, state.lengths, state.rates, state.freqs)
    clock = time.perf_counter()

    pending: list[tuple[int, list]] = []

    def cold_rows(snaps) -> list[np.ndarray]:
        """The runs' cold-chain rows of snapshots (block, then field) as
        host arrays (n_runs, blocks, ...): one gather over 'tree'."""
        fields = [torch.stack([snap[f] for snap in snaps], dim=1) for f in range(5)]
        return [x[cold_order].cpu().numpy() for x in gather_packed(mesh, fields)]

    def flush_pending() -> None:
        blocks = [(first_blk + i, snap) for first_blk, snaps in pending
                  for i, snap in enumerate(snaps)]
        pending.clear()
        if not blocks:
            return
        s_children, s_lengths, s_lnl, s_rates, s_freqs = cold_rows([snap for _, snap in blocks])
        for b, (blk_no, _) in enumerate(blocks):
            if blk_no * sample_every <= n_burnin:
                continue
            for r in range(n_runs):
                samples_children.append(s_children[r, b].astype(np.int32))
                samples_lengths.append(s_lengths[r, b])
                samples_lnl.append(float(s_lnl[r, b]))
                samples_run.append(r)
                if sample_model:
                    samples_rates.append(s_rates[r, b])
                    samples_freqs.append(s_freqs[r, b])

    def write_checkpoint(s: McmcState, gens_now: int) -> None:
        flush_pending()
        whole = gather_packed(mesh, [s.children, s.lengths, s.lnl, s.rates, s.freqs])
        acc = psum_counts(mesh, s.acc)
        if not is_output_rank(mesh):
            mesh_barrier(mesh, device)
            return
        payload = dict(McmcState(*whole, acc).to_numpy(), gens_done=gens_now,
                       draws_state=draws.get_state(),
                       s_children=np.stack(samples_children) if samples_children
                       else np.zeros((0, n_anc, 2), np.int32),
                       s_lengths=np.stack(samples_lengths) if samples_lengths
                       else np.zeros((0, n_all), np.float32),
                       s_lnl=np.asarray(samples_lnl, np.float64),
                       s_run=np.asarray(samples_run, np.int32))
        if sample_model:
            payload["s_rates"] = (np.stack(samples_rates) if samples_rates
                                  else np.zeros((0, n_pairs), np.float32))
            payload["s_freqs"] = (np.stack(samples_freqs) if samples_freqs
                                  else np.zeros((0, n_states), np.float32))
        tmp = ckpt_path + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, ckpt_path)
        mesh_barrier(mesh, device)

    # --- main loop: sample blocks, the host reading only at boundaries --------
    blocks_done = gens_done // sample_every
    ck_blocks = max(1, -(-checkpoint_every // sample_every))
    prog_blocks = max(1, round(progress_every / sample_every)) if progress_every else 0
    stop_blocks = (None if stop_after_generations is None
                   else -(-stop_after_generations // sample_every))
    executed = 0
    stopped_early = False
    blk = blocks_done
    last_progress = blk // prog_blocks if prog_blocks else 0
    max_dispatch = 64  # blocks between host boundaries, as the reference's
    while blk < total_blocks:
        g = min(max_dispatch, total_blocks - blk)
        if ckpt_path is not None:
            g = min(g, ck_blocks - (blk % ck_blocks))
        if prog_blocks:
            g = min(g, prog_blocks - (blk % prog_blocks))
        if stop_blocks is not None:
            g = max(1, min(g, stop_blocks - executed))
        snaps = run_blocks(state, g, sample_every, gen_step, cold)
        pending.append((blk + 1, snaps))
        executed += g
        blk += g
        gens_done = blk * sample_every
        if prog_blocks and blk // prog_blocks > last_progress:
            last_progress = blk // prog_blocks
            cold_lnl = gather_rows(mesh, snaps[-1][2])[cold_order].cpu().numpy()
            if is_output_rank(mesh):
                cold_str = " ".join(f"{v:.2f}" for v in cold_lnl)
                print(f"[mcmc] gen {gens_done}/{n_generations} cold lnL: {cold_str}")
        at_stop = stop_blocks is not None and executed >= stop_blocks and blk < total_blocks
        if ckpt_path is not None and (blk % ck_blocks == 0 or at_stop):
            write_checkpoint(state, gens_done)
        if at_stop:
            stopped_early = True
            break
    if not stopped_early:
        if trailing and gens_done == total_blocks * sample_every:
            for _ in range(trailing):
                gen_step(state)
            gens_done = n_generations
        if ckpt_path is not None:
            write_checkpoint(state, gens_done)
    flush_pending()
    acc_host = psum_counts(mesh, state.acc).cpu().numpy()
    if timings is not None:
        timings["sampler"] = time.perf_counter() - clock

    # --- summaries (host) --------------------------------------------------------
    canon_children: list[np.ndarray] = []
    canon_lengths: list[np.ndarray] = []
    for c, ln in zip(samples_children, samples_lengths):
        cc, ll = canonicalize_topology(c, ln)
        canon_children.append(cc)
        canon_lengths.append(ll)
    # Summaries on one rooting (every sample rerooted on leaf 0): clades then
    # match unrooted splits, which a reversible model identifies.
    zero_parents = np.zeros((n_all,), dtype=np.int32)
    sample_topos = [reroot_on_outgroup(from_numpy(c, zero_parents), [0])[0]
                    for c in canon_children]
    per_run = [[t for t, r in zip(sample_topos, samples_run) if r == rr] for rr in range(n_runs)]
    per_run_lnl = [np.array([v for v, r in zip(samples_lnl, samples_run) if r == rr])
                   for rr in range(n_runs)]
    branch_n = gens_done * branch_moves_per_gen * n_total
    topo_n = gens_done * n_total if do_topo else 0
    swap_n = gens_done * n_runs if n_chains > 1 else 0
    model_n = 2 * gens_done * n_total if sample_model else 0
    acceptance = {"branch": int(acc_host[0]) / max(branch_n, 1),
                  "topology": int(acc_host[1]) / max(topo_n, 1),
                  "swap": int(acc_host[2]) / max(swap_n, 1)}
    if sample_model:
        acceptance["model"] = int(acc_host[3]) / max(model_n, 1)
    return McmcResult(
        sample_children=(np.stack(canon_children) if canon_children
                         else np.zeros((0, n_anc, 2), np.int32)),
        sample_lengths=(np.stack(canon_lengths) if canon_lengths
                        else np.zeros((0, n_all), np.float32)),
        sample_lnl=np.asarray(samples_lnl, dtype=np.float64),
        sample_run=np.asarray(samples_run, dtype=np.int32),
        split_posterior=split_frequencies(sample_topos) if sample_topos else {},
        consensus_newick=(majority_rule_consensus(sample_topos, leaf_names)[0]
                          if sample_topos else ""),
        acceptance=acceptance,
        asdsf=average_stddev_split_freqs(per_run),
        ess_lnl=float(sum(effective_sample_size(t) for t in per_run_lnl if t.size > 0)),
        generations=n_generations,
        mean_lengths=(np.mean(np.stack(canon_lengths), axis=0) if canon_lengths
                      else np.zeros(n_all, np.float32)).astype(np.float32),
        sample_rates=np.stack(samples_rates) if samples_rates else None,
        sample_freqs=np.stack(samples_freqs) if samples_freqs else None,
    )


def run_blocks(state: McmcState, n_blocks: int, sample_every: int, gen_step,
               cold: torch.Tensor) -> list[tuple[torch.Tensor, ...]]:
    """``n_blocks`` sample blocks of ``sample_every`` generations on the
    device, each block's snapshot of the ``cold`` rows (children, lengths,
    lnl, rates, freqs) kept on the device: no host sync."""
    snaps = []
    for _ in range(n_blocks):
        for _ in range(sample_every):
            gen_step(state)
        snaps.append((state.children[cold], state.lengths[cold], state.lnl[cold],
                      state.rates[cold], state.freqs[cold]))
    return snaps
