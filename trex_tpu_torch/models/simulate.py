"""General CTMC alignment simulator, a seq-gen equivalent (counterpart of
``trex_tpu/models/simulate.py``).

Samples an alignment down a rooted tree under any reversible substitution
model the likelihood layer supports (JC69, GTR, empirical amino-acid
matrices), with optional discrete-Gamma site rates and an invariant-sites
category, mixed as ``ops.likelihood`` mixes them (p_inv invariant plus (1 -
p_inv) mean-1 Gamma categories; lengths in expected substitutions a site).

Two paths behind one API:

- The host walk (numpy and ``scipy.linalg.expm``): root first, an
  ancestor at a time, each category's sites at once. Given the numpy seed
  that the JAX package derives from its key (``jax.random.randint(key, (),
  0, 2**31 - 1)``), it returns the JAX package's states.
- The device path (plain PyTorch on the card): every (node, category) CDF
  from one batched ``torch.linalg.matrix_exp``, then one step per depth
  level from the root, each sampling every child of that level at once,
  drawn from a ``torch.Generator`` on the device. O(depth) steps where the
  JAX package's ``lax.scan`` takes one per ancestor. The same model and
  statistics as the host walk, from another random stream.

``use_device_path`` is the rule between them: the device path on a CUDA
device at ``DEVICE_CELLS`` node x site cells and above, else the host walk
(always on the CPU, where small fixtures keep their bytes).
"""

from __future__ import annotations

import numpy as np
import torch

from trex_tpu_torch._device import resolve_device
from trex_tpu_torch.ops.likelihood import discrete_gamma_rates, gtr_generator
from trex_tpu_torch.topology import Topology, from_numpy

__all__ = ["simulate_ctmc", "simulate_alignment", "simulate_coalescent", "use_device_path"]

# Above this many n_all x n_sites cells the device path is taken on a card:
# the host walk costs about two scipy expm calls an ancestor and category.
DEVICE_CELLS = 1 << 22
# Elements of a level step's gathered CDF rows (children x sites x Q) at once.
_LEVEL_ELEMENTS = 1 << 26


def use_device_path(device, n_all: int, n_sites: int) -> bool:
    """Whether ``simulate_ctmc`` takes the device path by default: on a
    CUDA device with at least ``DEVICE_CELLS`` cells; never on the CPU."""
    return torch.device(device).type == "cuda" and n_all * n_sites >= DEVICE_CELLS


def _sample_markov(rng: np.random.Generator, probs: np.ndarray) -> np.ndarray:
    """One categorical draw per row of ``probs`` ((n, Q) rows summing to 1)."""
    cum = np.cumsum(probs, axis=1)
    u = rng.random(probs.shape[0])[:, None]
    return (u > cum).sum(axis=1).astype(np.int64)


def depth_levels(children: np.ndarray) -> list[np.ndarray]:
    """The (m,) ancestors of each depth from the root, root first: level d
    holds the ancestors whose children are at depth d + 1."""
    n_anc = children.shape[0]
    n_leaves = n_anc + 1
    depth = np.zeros(2 * n_leaves - 1, np.int64)
    for anc in range(n_anc - 1, -1, -1):  # parents before children
        depth[children[anc]] = depth[n_leaves + anc] + 1
    anc_depth = depth[n_leaves:]
    return [np.flatnonzero(anc_depth == d) for d in range(int(anc_depth.max()) + 1)]


def _simulate_ctmc_device(rng: torch.Generator, topology: Topology, blens: np.ndarray,
                          gen: np.ndarray, freqs: np.ndarray, n_sites: int,
                          site_rates: np.ndarray, rate_probs: np.ndarray,
                          device: torch.device) -> torch.Tensor:
    """(n_all, n_sites) int32 states on ``device``: the depth-level walk."""
    q = gen.shape[0]
    children = topology.children.cpu().numpy()
    n_leaves = children.shape[0] + 1
    n_all = 2 * n_leaves - 1
    n_cat = site_rates.size
    f32 = dict(dtype=torch.float32, device=device)
    site_cat = torch.multinomial(torch.as_tensor(rate_probs, **f32), n_sites, replacement=True,
                                 generator=rng)
    root_states = torch.multinomial(torch.as_tensor(freqs, **f32), n_sites, replacement=True,
                                    generator=rng)
    # Every (node, category) CDF: clipped, row-normalised, cumulated. A zero
    # length or rate gives the identity exactly, so such children copy.
    ts = (torch.as_tensor(blens, **f32)[:, None]
          * torch.as_tensor(site_rates, **f32)[None, :]).reshape(-1)
    mats = torch.linalg.matrix_exp(torch.as_tensor(gen, **f32)[None] * ts[:, None, None])
    eye = torch.eye(q, **f32).expand_as(mats)
    mats = torch.where((ts == 0)[:, None, None], eye, mats.clamp(min=0.0))
    mats = mats / mats.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(mats, dim=-1).reshape(n_all, n_cat, q, q)

    states = torch.zeros((n_all, n_sites), dtype=torch.int64, device=device)
    states[-1] = root_states
    tiny = float(np.finfo(np.float32).tiny)
    kids = torch.as_tensor(children, dtype=torch.int64, device=device)
    per_child = max(1, _LEVEL_ELEMENTS // (n_sites * q))
    for level in depth_levels(children):
        ancestors = torch.as_tensor(level, dtype=torch.int64, device=device)
        nodes = kids[ancestors].reshape(-1)  # both children of every ancestor
        parent_rows = states[n_leaves + ancestors].repeat_interleave(2, dim=0)
        for c0 in range(0, nodes.shape[0], per_child):
            node = nodes[c0 : c0 + per_child]
            rows = cum[node[:, None], site_cat[None, :], parent_rows[c0 : c0 + per_child]]
            u = torch.rand((node.shape[0], n_sites, 1), generator=rng, **f32).clamp_(min=tiny)
            states[node] = torch.clamp((u > rows).sum(dim=-1), max=q - 1)
    return states.to(torch.int32)


def simulate_ctmc(
    seed: int,
    topology: Topology,
    branch_lengths: np.ndarray,
    *,
    generator: np.ndarray,
    freqs: np.ndarray,
    n_sites: int,
    site_rates: np.ndarray | None = None,
    rate_probs: np.ndarray | None = None,
    p_invariant: float = 0.0,
    return_ancestors: bool = False,
    device="cuda",
    device_path: bool | None = None,
    rng: torch.Generator | None = None,
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """Simulate an alignment down ``topology`` under a CTMC.

    Args:
        seed: the host walk's numpy seed (``np.random.default_rng(seed)``);
            the device path's generator seed when ``rng`` is None.
        generator: (Q, Q) rate matrix (rows sum to 0), e.g.
            ``ops.likelihood.gtr_generator`` (one expected substitution per
            unit length).
        freqs: (Q,) root/stationary distribution.
        branch_lengths: (n_all,) length ABOVE each node (root entry ignored).
        site_rates / rate_probs: optional discrete rate categories (each
            site draws one; lengths scale by its rate). Default: one rate-1
            category.
        p_invariant: probability a site is invariant (rate 0), mixed in on
            top of the rate categories.
        return_ancestors: also return the (n_ancestors, n_sites) true
            ancestral states (node n_leaves + i at row i).
        device: where the device path runs (``"cuda"`` by default).
        device_path: take the device path (True), the host walk (False),
            or decide by ``use_device_path`` (None).
        rng: the device path's ``torch.Generator`` on ``device``.

    Returns:
        (n_leaves, n_sites) int32 leaf states, and the ancestors' with
        ``return_ancestors``.
    """
    import scipy.linalg

    q = int(np.asarray(generator).shape[0])
    freqs = np.asarray(freqs, dtype=np.float64)
    freqs = freqs / freqs.sum()
    gen = np.asarray(generator, dtype=np.float64)
    blens = np.asarray(branch_lengths, dtype=np.float64)
    children = topology.children.cpu().numpy()
    n_leaves = children.shape[0] + 1
    n_all = 2 * n_leaves - 1

    if site_rates is None:
        site_rates = np.ones((1,), dtype=np.float64)
        rate_probs = np.ones((1,), dtype=np.float64)
    site_rates = np.asarray(site_rates, dtype=np.float64)
    if rate_probs is None:
        rate_probs = np.full(site_rates.shape, 1.0 / site_rates.size)
    rate_probs = np.asarray(rate_probs, dtype=np.float64)
    rate_probs = rate_probs / rate_probs.sum()
    if p_invariant > 0.0:
        site_rates = np.concatenate([site_rates, [0.0]])
        rate_probs = np.concatenate([rate_probs * (1.0 - p_invariant), [p_invariant]])

    if device_path is None:
        device_path = use_device_path(device, n_all, n_sites)
    if device_path:
        dev = resolve_device(device)
        if rng is None:
            rng = torch.Generator(device=dev)
            rng.manual_seed(int(seed))
        states = _simulate_ctmc_device(rng, topology, blens, gen, freqs, n_sites, site_rates,
                                       rate_probs, dev)
        # Split on the device before the copy to the host.
        leaves = states[:n_leaves].cpu().numpy()
        if return_ancestors:
            return leaves, states[n_leaves:].cpu().numpy()
        return leaves

    rng_np = np.random.default_rng(int(seed))
    site_cat = rng_np.choice(site_rates.size, size=n_sites, p=rate_probs)
    states = np.zeros((n_all, n_sites), dtype=np.int64)
    states[-1] = rng_np.choice(q, size=n_sites, p=freqs)
    # Root first: reverse index order keeps parents before children.
    for anc in range(n_leaves - 2, -1, -1):
        parent = n_leaves + anc
        for child in children[anc]:
            child = int(child)
            for cat in range(site_rates.size):
                sel = site_cat == cat
                if not sel.any():
                    continue
                rate = site_rates[cat]
                if rate == 0.0 or blens[child] == 0.0:
                    states[child, sel] = states[parent, sel]
                    continue
                p = scipy.linalg.expm(gen * (blens[child] * rate))
                p = np.clip(p, 0.0, None)
                p = p / p.sum(axis=1, keepdims=True)
                states[child, sel] = _sample_markov(rng_np, p[states[parent, sel]])
    leaves = states[:n_leaves].astype(np.int32)
    if return_ancestors:
        return leaves, states[n_leaves:].astype(np.int32)
    return leaves


def simulate_alignment(
    seed: int,
    topology: Topology,
    branch_lengths: np.ndarray,
    *,
    n_sites: int,
    n_states: int = 4,
    rates: np.ndarray | None = None,
    freqs: np.ndarray | None = None,
    gamma_shape: float | None = None,
    n_categories: int = 4,
    p_invariant: float = 0.0,
    return_ancestors: bool = False,
    device="cuda",
    device_path: bool | None = None,
    rng: torch.Generator | None = None,
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """``simulate_ctmc`` under a GTR model: ``rates`` ((Q, Q) symmetric
    exchangeabilities) and ``freqs`` ((Q,)), both None for JC69;
    ``gamma_shape`` switches on the discrete-Gamma mixture of
    ``ops.likelihood.tree_log_likelihood_gamma`` (equal-probability
    categories), so fitted parameters compare with the truth."""
    q = n_states
    if freqs is None:
        freqs = np.full((q,), 1.0 / q)
    if rates is None:
        rates = np.ones((q, q)) - np.eye(q)
    gen = gtr_generator(torch.as_tensor(np.asarray(rates), dtype=torch.float32),
                        torch.as_tensor(np.asarray(freqs), dtype=torch.float32)).numpy()
    site_rates = rate_probs = None
    if gamma_shape is not None:
        site_rates = discrete_gamma_rates(float(gamma_shape), n_categories).numpy()
        rate_probs = np.full((n_categories,), 1.0 / n_categories)
    return simulate_ctmc(
        seed, topology, branch_lengths, generator=gen, freqs=freqs, n_sites=n_sites,
        site_rates=site_rates, rate_probs=rate_probs, p_invariant=p_invariant,
        return_ancestors=return_ancestors, device=device, device_path=device_path, rng=rng,
    )


def simulate_coalescent(seed: int, n_leaves: int, ne: float,
                        tip_ages: np.ndarray | None = None) -> tuple[Topology, np.ndarray]:
    """Sample a (serial) Kingman coalescent genealogy, on the host.

    Backward in time: lineages activate at their ``tip_ages`` (all 0 when
    None); with k active lineages the next coalescence waits Exp(ne /
    C(k, 2)); a pending tip that activates first pre-empts it.

    Returns:
        (Topology in canonical numbering on the CPU, (n_all,) float32 node ages).
    """
    from trex_tpu_torch.io.fallback import _canonicalize

    rng = np.random.default_rng(seed)
    tips = np.zeros(n_leaves) if tip_ages is None else np.asarray(tip_ages, dtype=np.float64)
    order = np.argsort(tips)
    pending = list(order)  # leaves not yet sampled (ascending age)
    active: list[int] = []
    ages = {i: float(tips[i]) for i in range(n_leaves)}
    kids: dict[int, list[int]] = {}
    t = float(tips[order[0]])
    node = n_leaves
    while len(active) + len(pending) > 1 or len(pending) == 1:
        while pending and tips[pending[0]] <= t + 1e-12:
            active.append(int(pending.pop(0)))
        k = len(active)
        if k < 2:
            if not pending:
                break
            t = float(tips[pending[0]])
            continue
        wait = rng.exponential(ne / (k * (k - 1) / 2.0))
        if pending and t + wait > tips[pending[0]]:
            t = float(tips[pending[0]])
            continue
        t += wait
        i, j = rng.choice(k, 2, replace=False)
        a, b = active[i], active[j]
        active = [x for x in active if x not in (a, b)] + [node]
        kids[node] = [min(a, b), max(a, b)]
        ages[node] = t
        node += 1
        if len(active) == 1 and not pending:
            break
    ch, par, relabel = _canonicalize(n_leaves, kids, 2 * n_leaves - 2)
    ages_arr = np.zeros(2 * n_leaves - 1, np.float32)
    for old, new in relabel.items():
        ages_arr[new] = ages.get(old, 0.0)
    return from_numpy(ch, par), ages_arr
