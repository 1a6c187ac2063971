"""Shared inputs for the parity tests between ``trex_tpu`` (JAX, the
reference) and ``trex_tpu_torch`` (the PyTorch port).

Every input is made with numpy from a seed and handed to both packages as
numpy arrays, so both see identical data.

Importing this module sets PyTorch to one intra-op thread: the parity
tests' tensors are tiny, and pytest-xdist's workers share the machine's
cores, so PyTorch's default of one thread per core in every worker only
oversubscribes them.
"""

from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)


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


def jitted_jax_scores(monkeypatch) -> None:
    """Route the JAX package's candidate scoring through its own CPU path
    for Hamming costs (``jax.vmap`` of ``ops.fitch.fitch_score``, as
    ``ops.dispatch.batched_scores_fastest`` runs it), jitted once per batch
    shape: the same scores, without op-by-op dispatch on every call, so the
    JAX climbs these tests replay fit the suite's time."""
    import functools

    import jax

    import trex_tpu.search.stepwise as jax_stepwise
    from trex_tpu.ops import dispatch
    from trex_tpu.ops.fitch import fitch_score

    @functools.partial(jax.jit, static_argnames=("sequences_are_masks",))
    def fitch(topos, leaves, weights, sequences_are_masks):
        return jax.vmap(lambda t: fitch_score(
            t, leaves, site_mask=weights, sequences_are_masks=sequences_are_masks))(topos)

    original = dispatch.batched_scores_fastest

    def scores(topos, cost, leaves, site_weights=None, *, sequences_are_masks=False):
        if dispatch._is_hamming(cost) and cost.shape[-1] <= 32:
            return fitch(topos, leaves, site_weights, sequences_are_masks=sequences_are_masks)
        return original(topos, cost, leaves, site_weights,
                        sequences_are_masks=sequences_are_masks)

    monkeypatch.setattr(dispatch, "batched_scores_fastest", scores)
    monkeypatch.setattr(jax_stepwise, "batched_scores_fastest", scores)


def jax_replicate_draws(monkeypatch, seed: int) -> None:
    """Make the port's bootstrap draw the JAX package's replicate weights:
    ``search.bootstrap._replicate_weights`` returns
    ``trex_tpu.search.bootstrap._replicate_weights(PRNGKey(seed), ...)``,
    the draws of a JAX CLI that seeds its key with ``seed``."""
    import jax
    import jax.numpy as jnp

    import trex_tpu.search.bootstrap as jax_bootstrap
    import trex_tpu_torch.search.bootstrap as torch_bootstrap

    def draws(length, n_replicates, site_weights, generator):
        base = None if site_weights is None else jnp.asarray(
            torch.as_tensor(site_weights).cpu().numpy(), jnp.float32)
        return torch.as_tensor(np.array(jax_bootstrap._replicate_weights(
            jax.random.PRNGKey(seed), length, n_replicates, base)))

    monkeypatch.setattr(torch_bootstrap, "_replicate_weights", draws)


def lengths_of(newick: str) -> list[float]:
    """The branch lengths of a newick string, in writing order."""
    import re

    return [float(x) for x in re.findall(r":([0-9.eE+-]+)", newick)]


def strip_lengths(newick: str) -> str:
    import re

    return re.sub(r":[0-9.eE+-]+", "", newick)


def jax_draws_by_seed(monkeypatch) -> None:
    """Make the port's replicate draws the JAX package's for the same seed:
    ``search.bootstrap._replicate_weights(length, R, base, generator)``
    returns ``trex_tpu.search.bootstrap._replicate_weights(PRNGKey(s), ...)``
    with ``s = generator.initial_seed()``, so each command's generator
    (``--seed`` + 7 for aLRT, + 11 for UFBoot, ``--seed`` for topotest)
    draws what the JAX CLI's key of that seed draws."""
    import jax
    import jax.numpy as jnp

    import trex_tpu.search.bootstrap as jax_bootstrap
    import trex_tpu_torch.search.bootstrap as torch_bootstrap

    def draws(length, n_replicates, site_weights, generator):
        base = None if site_weights is None else jnp.asarray(
            torch.as_tensor(site_weights).cpu().numpy(), jnp.float32)
        return torch.as_tensor(np.array(jax_bootstrap._replicate_weights(
            jax.random.PRNGKey(generator.initial_seed()), length, n_replicates, base)))

    monkeypatch.setattr(torch_bootstrap, "_replicate_weights", draws)


def jax_au_draws(seed: int, weights, n_replicates: int, scales) -> list[np.ndarray]:
    """The AU test's multiscale counts as ``trex_tpu.search.topotest.
    _au_test`` draws them under ``topology_tests(PRNGKey(seed), ...)``: one
    (R, P) count matrix a scale."""
    import jax
    import jax.numpy as jnp

    base = jnp.asarray(np.asarray(weights), jnp.float32)
    probs = base / jnp.sum(base)
    length = base.shape[0]
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    out = []
    for s_idx, r in enumerate(scales):
        n_r = max(1, int(round(float(jnp.sum(base)) * r)))

        def one(kk, n_r=n_r):
            picks = jax.random.choice(kk, length, (n_r,), p=probs)
            return jnp.zeros((length,), jnp.float32).at[picks].add(1.0)

        keys = jax.random.split(jax.random.fold_in(key, s_idx), n_replicates)
        out.append(np.array(jax.vmap(one)(keys)))
    return out


def near_tie_replicates(totals: np.ndarray, rtol: float = 1e-5) -> int:
    """Replicates (rows of (R, K) RELL totals) whose two highest totals lie
    within ``rtol`` of each other, relative: the votes float32 rounding may
    flip between two implementations."""
    top = np.sort(np.asarray(totals, np.float64), axis=1)[:, -2:]
    return int(np.sum(np.abs(top[:, 1] - top[:, 0]) <= rtol * np.abs(top[:, 1])))


def share_native_library(monkeypatch) -> bool:
    """Load the JAX package's native binding from the port's build of the
    byte-identical source, so both packages' seeded TBR samples are the
    same trees; False when no compiler can build it. The caller clears
    ``trex_tpu.io.native.load_library``'s cache after the test."""
    from trex_tpu.io import native as jax_native
    from trex_tpu_torch.io import native

    try:
        path = str(native.build())
    except RuntimeError:
        return False
    monkeypatch.setattr(jax_native, "_LIB_PATH", path)
    jax_native.load_library.cache_clear()
    return True


class JaxDraws:
    """A draw source for the port's samplers (``search/mcmc.py``'s
    ``TorchDraws`` protocol) that replays a JAX sampler's key schedule:
    ``step(state) -> (state, [(kind, key), ...])`` gives one generation's
    keys in the order the step uses them, and each call draws what the JAX
    step draws with its key (a Dirichlet or gamma at the port's
    concentration). ``get_state``/``set_state`` carry ``state`` as key data
    (the JAX checkpoint's ``jax_key``) between generations."""

    def __init__(self, state, step, device="cpu") -> None:
        self.state, self.step, self.device = state, step, torch.device(device)
        self.queue: list = []

    def _key(self, kind: str):
        if not self.queue:
            self.state, self.queue = self.step(self.state)
            self.queue = list(self.queue)
        got, key = self.queue.pop(0)
        assert got == kind, f"the port drew a {kind} where the JAX step draws a {got}"
        return key

    def _out(self, x, dtype=None):
        return torch.as_tensor(np.array(x), device=self.device, dtype=dtype)

    def uniform(self, shape):
        import jax

        return self._out(jax.random.uniform(self._key("uniform"), tuple(shape)))

    def normal(self, shape):
        import jax

        return self._out(jax.random.normal(self._key("normal"), tuple(shape)))

    def randint(self, shape, low, high):
        import jax

        return self._out(jax.random.randint(self._key("randint"), tuple(shape), low, high),
                         torch.int64)

    def gumbel(self, shape):
        import jax

        return self._out(jax.random.gumbel(self._key("gumbel"), tuple(shape)))

    def dirichlet(self, alpha):
        import jax
        import jax.numpy as jnp

        return self._out(jax.random.dirichlet(
            self._key("dirichlet"), jnp.asarray(alpha.cpu().numpy())))

    def gamma(self, concentration, shape):
        import jax

        return self._out(jax.random.gamma(self._key("gamma"), concentration, tuple(shape)))

    def get_state(self):
        import jax

        assert not self.queue, "state read inside a generation"
        return np.asarray(jax.random.key_data(self.state))

    def set_state(self, state) -> None:
        import jax.numpy as jnp

        self.state, self.queue = jnp.asarray(np.asarray(state, np.uint32)), []


class RecordedDraws:
    """A draw source that hands every call on to ``inner`` (a ``JaxDraws``)
    and records it, so that ranks which import no JAX replay the same
    draws (``_torch_dist.ReplayDraws``): each call's kind and shape, its
    values, a Dirichlet's concentrations, and the key state at each
    ``get_state``/``set_state`` with the number of calls made by then.
    One recorder may serve several legs of a resumed run."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.calls: list = []
        self.values: list = []
        self.alphas: list = []
        self.states: list = []

    def _record(self, kind: str, x):
        self.calls.append([kind, list(x.shape)])
        self.values.append(x.cpu().numpy().astype(np.float64).ravel())
        return x

    def uniform(self, shape):
        return self._record("uniform", self.inner.uniform(shape))

    def normal(self, shape):
        return self._record("normal", self.inner.normal(shape))

    def randint(self, shape, low, high):
        return self._record("randint", self.inner.randint(shape, low, high))

    def gumbel(self, shape):
        return self._record("gumbel", self.inner.gumbel(shape))

    def gamma(self, concentration, shape):
        return self._record("gamma", self.inner.gamma(concentration, shape))

    def dirichlet(self, alpha):
        self.alphas.append(alpha.cpu().numpy().astype(np.float32).ravel())
        return self._record("dirichlet", self.inner.dirichlet(alpha))

    def get_state(self):
        state = self.inner.get_state()
        self.states.append((len(self.calls), np.asarray(state)))
        return state

    def set_state(self, state) -> None:
        self.inner.set_state(state)
        self.states.append((len(self.calls), np.asarray(state)))

    def inputs(self, prefix: str) -> dict:
        """The recording as ``_torch_dist.start_ranks`` inputs under ``prefix``."""
        return {f"{prefix}_calls": self.calls,
                f"{prefix}_values": np.concatenate(self.values),
                f"{prefix}_alphas": (np.concatenate(self.alphas) if self.alphas
                                     else np.zeros(0, np.float32)),
                f"{prefix}_state_at": np.array([at for at, _ in self.states], np.int64),
                f"{prefix}_states": (np.stack([st for _, st in self.states]) if self.states
                                     else np.zeros((0, 2), np.uint32))}


def jax_mcmc_step(branch_moves: int, sample_model: bool, proposal: str | None, swap: bool):
    """``trex_tpu.search.mcmc.mcmc_sample``'s per-generation key schedule
    (its ``gen_step``; ``proposal`` None without topology moves)."""
    import jax

    split = jax.random.split

    def step(k):
        out = []
        if branch_moves > 0:
            k, sub = split(k)
            for kk in split(sub, branch_moves):
                k_node, k_mult, k_acc = split(kk, 3)
                out += [("randint", k_node), ("uniform", k_mult), ("uniform", k_acc)]
        if sample_model:
            k, k_r, k_f = split(k, 3)
            for kk in (k_r, k_f):
                k_prop, k_acc = split(kk)
                out += [("dirichlet", k_prop), ("uniform", k_acc)]
        if proposal == "informed":
            k, k_pick, k_acc = split(k, 3)
            out += [("gumbel", k_pick), ("uniform", k_acc)]
        elif proposal == "nni":
            k, k_edge, k_var, k_acc = split(k, 4)
            out += [("randint", k_edge), ("randint", k_var), ("uniform", k_acc)]
        if swap:
            k, k_pick, k_acc = split(k, 3)
            out += [("randint", k_pick), ("uniform", k_acc)]
        return k, out

    return step


def jax_dating_step(key, n_generations: int, interior: bool, relaxed: bool, calibrated: bool,
                    heterochronous: bool, sample_ne: bool):
    """(state, step) of ``trex_tpu.search.dating.mcmc_date``'s schedule:
    ``split(key, n_generations)``, then 11 keys a generation used in the
    order of its ``gen``."""
    import jax

    keys = jax.random.split(key, n_generations)

    def step(g):
        (k_node, k_u, k_acc1, k_mult, k_acc2, k_rnode, k_rstep, k_acc3, k_cr, k_acc4,
         k_ne) = jax.random.split(keys[g], 11)
        out = []
        if interior:
            out += [("randint", k_node), ("uniform", k_u), ("uniform", k_acc1)]
        if relaxed:
            out += [("randint", k_rnode), ("normal", k_rstep), ("uniform", k_acc3)]
        out += [("uniform", k_mult), ("uniform", k_acc2)]
        if calibrated:
            k_s, k_acc5 = jax.random.split(k_cr)
            out += [("normal", k_cr), ("uniform", k_acc4), ("uniform", k_s), ("uniform", k_acc5)]
        if sample_ne:
            out += [("gamma", k_ne)]
        return g + 1, out

    return 0, step


def jax_marginal_step(key, total_steps: int, sample_model: bool):
    """(state, step) of ``trex_tpu.search.marginal.stepping_stone``'s
    schedule: ``split(key, total_steps)``, 5 keys a step."""
    import jax

    keys = jax.random.split(key, total_steps)

    def step(g):
        k_node, k_mult, k_acc, k_r, k_f = jax.random.split(keys[g], 5)
        out = [("randint", k_node), ("uniform", k_mult), ("uniform", k_acc)]
        if sample_model:
            for kk in (k_r, k_f):
                k_prop, k_acc2 = jax.random.split(kk)
                out += [("dirichlet", k_prop), ("uniform", k_acc2)]
        return g + 1, out

    return 0, step


def record_accepts(monkeypatch) -> list:
    """Record every Metropolis decision of the port's samplers as the
    margin log u - log alpha (a list of arrays, filled as they run)."""
    import trex_tpu_torch.search.mcmc as torch_mcmc

    margins: list = []
    accept = torch_mcmc.metropolis_accept

    def recording(u, log_alpha):
        margins.append((torch.log(u) - log_alpha).detach().cpu().numpy().ravel())
        return accept(u, log_alpha)

    monkeypatch.setattr(torch_mcmc, "metropolis_accept", recording)
    return margins


def near_tie_accepts(margins: list, scale: float, rtol: float = 1e-6) -> int:
    """Decisions whose log u lies within ``rtol`` x ``scale`` (the chains'
    |lnL|) of log alpha: the ones that the two packages' pruning arithmetics
    (K4's power-of-two rescaling against lax, about 1e-7 of lnL apart) may
    decide differently. At |lnL| >= 10 the window holds the absolute 1e-5
    around each threshold."""
    flat = np.concatenate(margins) if margins else np.zeros(0)
    return int(np.sum(np.abs(flat[np.isfinite(flat)]) <= rtol * scale))
