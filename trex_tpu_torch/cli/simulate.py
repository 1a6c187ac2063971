"""Alignment simulation: the ``simulate`` command (counterpart of
``trex_tpu/cli/simulate.py``).

The tree, its lengths and a GTR model's rates and frequencies come from
``np.random.default_rng(--seed)`` in the JAX command's order (a random
tree is ``random_topologies(--seed)``, the JAX command's tree), so they
and the newick equal the JAX command's. The substitutions are drawn from
a seed of their own, ``walk_seed(--seed)``: the host walk's numpy seed,
and on the card's device path the seed of its ``torch.Generator``. The
JAX command derives its walk's seed from a JAX key, which the port does
not compute, so the sequences match the JAX command's in distribution;
given the JAX seed, ``models.simulate`` returns the JAX states exactly.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def walk_seed(seed: int) -> int:
    """The simulation walk's seed for ``--seed``: the first draw of
    ``np.random.default_rng([seed, 1])`` in [0, 2^31 - 1), a generator
    apart from the command's ``default_rng(seed)``."""
    return int(np.random.default_rng([seed, 1]).integers(0, 2**31 - 1))


def _tree(args, rng):
    """(Topology, (n_all,) float64 lengths, names) of ``--coalescent-ne``,
    ``--tree`` or a random tree with exponential lengths."""
    from trex_tpu_torch.io import load_newick
    from trex_tpu_torch.topology import Topology, random_topologies

    if args.coalescent_ne is not None:
        # A Kingman genealogy (serial with --sim-tip-ages); lengths = clock
        # rate x waiting times.
        from trex_tpu_torch.models.simulate import simulate_coalescent

        tip_ages = None
        if args.sim_tip_ages:
            tip_ages = np.array([float(x) for x in args.sim_tip_ages.split(",")], np.float64)
            if tip_ages.size != args.leaves:
                raise SystemExit(f"--sim-tip-ages wants {args.leaves} comma values")
        topo, node_ages = simulate_coalescent(args.seed, args.leaves, args.coalescent_ne,
                                              tip_ages=tip_ages)
        parents = topo.parents.numpy()
        blens = (node_ages[parents] - node_ages).astype(np.float64) * args.clock_rate
        blens[-1] = 0.0
        return topo, blens, [f"t{i}" for i in range(args.leaves)]
    if args.tree:
        with open(args.tree) as fh:
            topo, blens, names = load_newick(fh.read())
        blens = np.asarray(blens, dtype=np.float64)
        blens = np.where(np.isfinite(blens), blens, 0.0)
        if not (blens[:-1] > 0).any():
            # A topology-only newick: zero lengths would copy the root to
            # every leaf, so every branch gets the default length.
            blens = np.full_like(blens, args.default_blen)
        return topo, blens, names
    batch = random_topologies(args.seed, args.leaves, 1)
    topo = Topology(batch.children[0], batch.parents[0])
    blens = rng.exponential(args.default_blen, size=(topo.n_all,))
    return topo, blens, [f"t{i}" for i in range(args.leaves)]


def _write(path: str | None, text: str) -> None:
    if path:
        with open(path, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)


def run_simulate(args, timings: dict | None = None) -> dict:
    """Simulate and write the FASTA (``--output`` or stdout), the tree and
    the ancestors; returns the JSON summary the command prints on stderr.
    ``timings``: a dict that, when given, gets the wall seconds of the
    simulation (``"simulate"``), its path (``"path"``: ``"device"`` or
    ``"host"``) and the device path's depth levels (``"levels"``)."""
    from trex_tpu_torch._device import resolve_device
    from trex_tpu_torch.io import DNA, PROTEIN, parse_paml_rates, save_newick, write_fasta
    from trex_tpu_torch.models import simulate as sim

    device = resolve_device(args.device)
    alphabet = {"dna": DNA, "protein": PROTEIN}[args.alphabet]
    n_states = len(alphabet)
    rng = np.random.default_rng(args.seed)
    topo, blens, names = _tree(args, rng)
    seed = walk_seed(args.seed)
    timings = {} if timings is None else timings
    newick = save_newick(topo, names, branch_lengths=blens) + "\n"

    if args.model.lower() == "gy94":
        # Codon simulation: GY94 over the 61 sense codons, written out as
        # in-frame nucleotide triplets (``dnds`` reads them).
        from trex_tpu_torch.models import codon as cd

        clock = time.perf_counter()
        codons = cd.simulate_gy94(seed, topo, blens, kappa=args.kappa, omega=args.omega,
                                  n_sites=args.sites)
        timings.update(simulate=time.perf_counter() - clock, path="host")
        rows = ["".join(cd.SENSE_CODONS[c] for c in row) for row in codons]
        _write(args.output, "\n".join(f">{n}\n{seq}" for n, seq in zip(names, rows)) + "\n")
        if args.output_tree:
            _write(args.output_tree, newick)
        return {"leaves": int(topo.n_leaves), "codons": args.sites, "model": "gy94",
                "kappa": args.kappa, "omega": args.omega, "output": args.output}

    rates = freqs = gamma_shape = None
    p_inv = 0.0
    base, *extras = args.model.lower().split("+")
    for extra in extras:
        if extra == "g":
            gamma_shape = args.gamma_shape
        elif extra == "i":
            p_inv = args.p_inv
        else:
            raise SystemExit(f"unknown model suffix +{extra}")
    if base == "gtr":
        # Random but reproducible exchangeabilities and frequencies unless given.
        tri = (np.asarray(args.gtr_rates, dtype=np.float64) if args.gtr_rates
               else rng.gamma(2.0, 1.0, size=n_states * (n_states - 1) // 2))
        rates = np.zeros((n_states, n_states))
        rates[np.triu_indices(n_states, 1)] = tri
        rates = rates + rates.T
        freqs = (np.asarray(args.freqs, dtype=np.float64) if args.freqs
                 else rng.dirichlet(np.full(n_states, 10.0)))
    elif base == "empirical":
        if not args.model_file:
            raise SystemExit("--model empirical needs --model-file")
        with open(args.model_file) as fh:
            rates, freqs = parse_paml_rates(fh.read(), n_states)
    elif base != "jc":
        raise SystemExit(f"unknown model {args.model!r}")

    device_path = sim.use_device_path(device, topo.n_all, args.sites)
    clock = time.perf_counter()
    out = sim.simulate_alignment(
        seed, topo, blens, n_sites=args.sites, n_states=n_states, rates=rates, freqs=freqs,
        gamma_shape=gamma_shape, n_categories=args.categories, p_invariant=p_inv,
        return_ancestors=bool(args.output_ancestors), device=device, device_path=device_path,
    )
    timings.update(simulate=time.perf_counter() - clock,
                   path="device" if device_path else "host")
    if device_path:
        timings["levels"] = len(sim.depth_levels(topo.children.numpy()))
    leaves, ancestors = out if args.output_ancestors else (out, None)
    _write(args.output, write_fasta(names, leaves, alphabet))
    if args.output_tree:
        _write(args.output_tree, newick)
    if args.output_ancestors:
        anc_names = [f"node{topo.n_leaves + i}" for i in range(topo.n_ancestors)]
        _write(args.output_ancestors, write_fasta(anc_names, ancestors, alphabet))
    return {"leaves": int(topo.n_leaves), "sites": args.sites, "model": args.model,
            "output": args.output}


def cmd_simulate(args) -> None:
    """Simulate an alignment down a tree (seq-gen-style data generation)."""
    print(json.dumps(run_simulate(args)), file=sys.stderr)
