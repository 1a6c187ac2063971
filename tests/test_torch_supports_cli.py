"""The likelihood supports end to end: ``python -m trex_tpu_torch.cli infer
--criterion ml --alrt R --ufboot R --device cpu`` against the JAX package's
``branch_supports`` and ``ultrafast_bootstrap`` on the port's ML tree under
the JAX CLI's draws (aLRT's key ``--seed`` + 7, UFBoot's ``--seed`` + 11
and its TBR sample from the shared native library): the same keys,
supports and counts, ``alrt`` within 1e-2; and ``topotest --model gtr``
fitting the model on the first tree. The ``topotest`` command against the
JAX CLI: ``test_torch_trees_cli.py``."""

import contextlib
import functools
import io
import json

import numpy as np
import pytest
from _torch_parity import (
    jax_draws_by_seed,
    parents_of,
    random_children,
    share_native_library,
    tree_fasta,
)

import trex_tpu_torch.cli as torch_cli
import trex_tpu_torch.ops.likelihood as torch_likelihood
import trex_tpu_torch.search.topotest as torch_topotest

N_TAXA, N_SITES, FIT_STEPS = 8, 60, 30


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A FASTA and a file of three candidate trees over its taxa."""
    from trex_tpu_torch.io import save_newick
    from trex_tpu_torch.topology import from_numpy

    root = tmp_path_factory.mktemp("supports")
    rng = np.random.default_rng(14)
    fasta = root / "aln.fasta"
    fasta.write_text(tree_fasta(rng, N_TAXA, N_SITES, 0.25))
    names = [f"taxon_{i}" for i in range(N_TAXA)]
    trees = root / "cands.nwk"
    trees.write_text("".join(
        save_newick(from_numpy(c, parents_of(c)), names[::-1] if i % 2 else names) + "\n"
        for i, c in enumerate(random_children(rng, N_TAXA, 3))))
    return dict(fasta=str(fasta), trees=str(trees))


def test_topotest_gtr_fits_on_the_first_tree(files, monkeypatch):
    """``--model gtr``: the model fitted on the first tree (FIT_STEPS Adam
    steps here) and passed to ``topology_tests`` as its exchangeabilities
    and frequencies."""
    import torch

    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment
    from trex_tpu_torch.cli.trees import run_topotest

    fits = []

    def fit(topology, *args, **kwargs):
        fits.append((topology.children.clone(), *torch_likelihood_fit(
            topology, *args, n_iterations=FIT_STEPS, **kwargs)))
        return fits[-1][1:]

    torch_likelihood_fit = torch_likelihood.optimize_model
    monkeypatch.setattr(torch_likelihood, "optimize_model", fit)
    # The AU test off (as in test_torch_trees_cli.py): it is not what this
    # test holds.
    monkeypatch.setitem(torch_topotest.topology_tests.__kwdefaults__, "au_scales", None)
    args = torch_cli.build_parser().parse_args([
        "topotest", "--alignment", files["fasta"], "--trees", files["trees"], "--replicates",
        "100", "--model", "gtr", "--device", "cpu"])
    out, res = run_topotest(args)
    names, masks, _ = _load_alignment(files["fasta"], "dna")
    patterns, counts = compress_alignment(masks)
    batch = _batch(files, names)
    (children, params, _), = fits
    assert torch.equal(children, batch.children[0])
    want = torch_topotest.topology_tests(
        batch, torch.as_tensor(patterns.astype(np.int32)), 4, rates=params["rates"],
        freqs=params["freqs"], site_weights=torch.as_tensor(counts, dtype=torch.float32),
        n_replicates=100, sequences_are_masks=True, au_scales=None,
        generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(res.log_likelihoods, want.log_likelihoods)
    np.testing.assert_array_equal(res.bp, want.bp)
    assert out["model"] == "gtr" and out["best"] == want.best_index


def _batch(files, names):
    """The candidate file's trees on the alignment's leaf numbering."""
    import torch

    from trex_tpu_torch.io import load_newick, renumber_leaves
    from trex_tpu_torch.topology import Topology

    topos = []
    with open(files["trees"]) as fh:
        for line in fh:
            topo, _, tree_names = load_newick(line)
            topos.append(renumber_leaves(topo, [names.index(n) for n in tree_names]))
    return Topology(torch.stack([t.children for t in topos]),
                    torch.stack([t.parents for t in topos]))


def test_infer_alrt_and_ufboot(files, monkeypatch):
    """Both flags on the port's ML tree, against the JAX package's
    ``branch_supports`` and ``ultrafast_bootstrap`` on that tree with the
    JAX CLI's keys and inputs (the ML climb itself is held to the JAX
    CLI's by ``test_torch_ml.py``); UFBoot's values label the newick."""
    import jax
    import jax.numpy as jnp

    from trex_tpu.io import native as jax_native
    from trex_tpu.search.alrt import branch_supports
    from trex_tpu.search.ufboot import ultrafast_bootstrap
    from trex_tpu.topology import Topology as JaxTopology
    from trex_tpu_torch.alignment import compress_alignment
    from trex_tpu_torch.cli._common import _load_alignment
    from trex_tpu_torch.io import align_leaf_order, load_newick

    if not share_native_library(monkeypatch):
        pytest.skip("no C++ compiler: the native move library cannot be built")
    jax_draws_by_seed(monkeypatch)
    seed = 1
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            torch_cli.main(["infer", "--alignment", files["fasta"], "--criterion", "ml",
                            "--neighborhood", "nni", "--alrt", "100", "--ufboot", "100",
                            "--seed", str(seed), "--device", "cpu"])
        ours = json.loads(buf.getvalue())
        names, masks, _ = _load_alignment(files["fasta"], "dna")
        patterns, counts = compress_alignment(masks)
        topo, _, tree_names = load_newick(ours["tree"])
        children, parents = align_leaf_order(topo, tree_names, names).to_numpy()
        tree = JaxTopology(children=jnp.asarray(children), parents=jnp.asarray(parents))
        args = dict(site_weights=jnp.asarray(counts, jnp.float32), n_replicates=100,
                    sequences_are_masks=True)
        sup = branch_supports(jax.random.PRNGKey(seed + 7), tree, jnp.asarray(patterns), 4,
                              **args)
        ub = ultrafast_bootstrap(jax.random.PRNGKey(seed + 11), tree, jnp.asarray(patterns),
                                 4, **args)
    finally:
        jax_native.load_library.cache_clear()
    keys = [k for k in ours if k in ("alrt", "sh_alrt_support", "rell_support",
                                     "ufboot_support", "ufboot_candidates",
                                     "ufboot_reference_wins")]
    assert keys == ["alrt", "sh_alrt_support", "rell_support", "ufboot_support",
                    "ufboot_candidates", "ufboot_reference_wins"]
    assert list(ours).index("ufboot_reference_wins") + 1 == list(ours).index(
        "mean_branch_length")
    for got, want in zip(ours["alrt"], sup.alrt, strict=True):
        assert (got is None) == bool(np.isnan(want))
        assert got is None or abs(got - want) <= 1e-2
    assert ours["sh_alrt_support"] == [round(float(s), 3) for s in sup.sh_alrt]
    assert ours["rell_support"] == [round(float(s), 3) for s in sup.rell]
    assert ours["ufboot_support"] == [round(float(s), 3) for s in ub.support]
    assert ours["ufboot_candidates"] == ub.n_candidates
    assert ours["ufboot_reference_wins"] == int(ub.winner_counts[ub.reference_index])
    labels = [x for x in ours["tree"].replace("(", ",").split(")")[1:]]
    assert labels and all(lab.split(":")[0] for lab in labels[:-1])
