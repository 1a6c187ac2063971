"""``--mesh`` on the port's ``infer`` and ``topotest``, two CPU ranks (gloo)
each running the command: rank 0 prints the JAX CLI's JSON (``--mesh
1,1``) plus ``"mesh": {"tree": T, "site": S}`` for ``infer``, and writes
the output files; rank 1 prints and writes nothing. Parsimony with the SPR
scan on the (2, 1) mesh; ML with ``--start nj --neighborhood nni
--bootstrap 2`` on (1, 2) (the bootstrap's batches ranked across the
site shards), its supports JAX's ``ml_bootstrap_analysis`` under the CLI's
key, as ``test_torch_ml_bootstrap.py`` holds it; ``topotest`` on (1, 2)
under the JAX package's draws with the AU test off, as
``test_torch_trees_cli.py`` holds it."""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_dist import start_ranks
from _torch_parity import (
    jitted_jax_scores,
    lengths_of,
    parents_of,
    random_children,
    strip_lengths,
    tree_fasta,
)

import trex_tpu.cli as jax_cli
import trex_tpu.ops.likelihood as jax_likelihood
import trex_tpu.search.bootstrap as jax_bootstrap
import trex_tpu.search.ml as jax_ml
import trex_tpu.search.topotest as jax_topotest
from trex_tpu.alignment import compress_alignment
from trex_tpu.cli._common import _load_alignment
from trex_tpu.topology import Topology as JaxTopology

N_TAXA, N_SITES = 10, 60
ML_ARGS = ["--criterion", "ml", "--start", "nj", "--neighborhood", "nni", "--rounds", "4"]


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    from trex_tpu_torch.io import save_newick
    from trex_tpu_torch.topology import from_numpy

    root = tmp_path_factory.mktemp("mesh_cli")
    fasta = root / "aln.fasta"
    fasta.write_text(tree_fasta(np.random.default_rng(5), N_TAXA, N_SITES, 0.5))
    names = [f"taxon_{i}" for i in range(N_TAXA)]
    children = random_children(np.random.default_rng(6), N_TAXA, 3)
    trees = root / "cands.nwk"
    trees.write_text("".join(save_newick(from_numpy(c, parents_of(c)), names) + "\n"
                             for c in children))
    _, masks, _ = _load_alignment(str(fasta), "dna")
    patterns, weights = compress_alignment(masks)
    base = jnp.asarray(weights, jnp.float32)
    common = ["--alignment", str(fasta)]
    topotest = ["topotest", "--alignment", str(fasta), "--trees", str(trees), "--replicates",
                "200", "--seed", "2"]
    inputs = dict(
        argvs=[["infer", *common, "--device", "cpu", "--mesh", "2,1", "--output-tree",
                "tree.nwk"],
               ["infer", *common, *ML_ARGS, "--device", "cpu", "--bootstrap", "2", "--mesh",
                "1,2"],
               [*topotest, "--device", "cpu", "--mesh", "1,2", "--site-lnl", "sites.lnl"]],
        files=[["tree.nwk"], [], ["sites.lnl"]],
        au_off=True,
        draws_1=np.array(jax_bootstrap._replicate_weights(jax.random.PRNGKey(1), len(weights),
                                                          2, base)),
        draws_2=np.array(jax_bootstrap._replicate_weights(jax.random.PRNGKey(2), len(weights),
                                                          200, base)),
    )
    ranks = start_ranks(root, "cli", inputs)
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        jitted_jax_scores(mp)
        fast = jax.jit(jax_likelihood.tree_log_likelihood, static_argnums=(3,),
                       static_argnames=("sequences_are_masks",))
        mp.setattr(jax_likelihood, "tree_log_likelihood", fast)
        mp.setattr(jax_ml, "tree_log_likelihood", fast)
        mp.setitem(jax_topotest.topology_tests.__kwdefaults__, "au_scales", None)
        want["parsimony"] = _run(jax_cli, ["infer", *common, "--mesh", "1,1"])
        want["ml"] = _run(jax_cli, ["infer", *common, *ML_ARGS, "--mesh", "1,1"])
        want["topotest"] = _run(jax_cli, [*topotest, "--mesh", "1,1", "--site-lnl",
                                          str(root / "jax.lnl")])
        want["site_lnl"] = (root / "jax.lnl").read_text()
        outs = ranks.wait()
        # The ML bootstrap's supports: JAX's function on the tree the ranks
        # printed, under the CLI's key PRNGKey(--seed + 1).
        from trex_tpu_torch.io import load_newick, renumber_leaves

        topo, _, leaf_names = load_newick(json.loads(outs[0]["stdout_1"].item())["tree"])
        topo = renumber_leaves(topo, [names.index(n) for n in leaf_names])
        support, _ = jax_bootstrap.ml_bootstrap_analysis(
            jax.random.PRNGKey(1), JaxTopology(jnp.asarray(topo.children.numpy()),
                                               jnp.asarray(topo.parents.numpy())),
            jnp.asarray(patterns), 4, n_replicates=2, search_rounds=3, site_weights=base,
            sequences_are_masks=True)
        want["ml_support"] = support
    return want, outs


def _printed(outs, i):
    assert outs[1][f"stdout_{i}"].item() == ""
    return json.loads(outs[0][f"stdout_{i}"].item())


def test_parsimony_infer_prints_jax_json_and_the_mesh(case):
    want, outs = case
    got = _printed(outs, 0)
    assert got.pop("mesh") == {"tree": 2, "site": 1}
    assert list(got) == list(want["parsimony"]) and got == want["parsimony"]
    assert got["search_rounds"] > 0
    assert outs[0]["file_0_tree.nwk"].item() == want["parsimony"]["tree"] + "\n"
    assert outs[1]["file_0_tree.nwk"].item() == ""


def test_ml_infer_with_bootstrap_matches_jax(case):
    want, outs = case
    got, ref = _printed(outs, 1), want["ml"]
    assert got.pop("mesh") == {"tree": 1, "site": 2}
    names = list(ref)
    at = names.index("mean_branch_length") + 1
    assert list(got) == names[:at] + [
        "bootstrap_replicates", "mean_split_support", "split_support"] + names[at:]
    for key in ("criterion", "start", "n_taxa", "n_sites", "unique_patterns", "model",
                "search_rounds", "evaluations"):
        assert got[key] == ref[key], key
    for key in ("neg_log_likelihood", "ranking_score"):
        np.testing.assert_allclose(got[key], ref[key], rtol=2e-5)
    assert strip_lengths(got["tree"]) == strip_lengths(ref["tree"])
    np.testing.assert_allclose(lengths_of(got["tree"]), lengths_of(ref["tree"]), atol=1e-3)
    assert got["split_support"] == [round(float(s), 3) for s in want["ml_support"]]


def test_topotest_prints_jax_json(case):
    want, outs = case
    got, ref = _printed(outs, 2), dict(want["topotest"])
    assert "mesh" not in got and list(got) == list(ref)
    for row_o, row_t in zip(got.pop("table"), ref.pop("table"), strict=True):
        got_ll, want_ll = row_o.pop("log_likelihood"), row_t.pop("log_likelihood")
        assert abs(got_ll - want_ll) <= 2e-5 * abs(want_ll)
        assert abs(row_o.pop("delta") - row_t.pop("delta")) <= 1e-2
        assert row_o == row_t
    assert got == ref
    assert outs[1]["file_2_sites.lnl"].item() == ""
    lnl = [np.loadtxt(io.StringIO(text), skiprows=1, usecols=range(1, N_SITES + 1))
           for text in (outs[0]["file_2_sites.lnl"].item(), want["site_lnl"])]
    np.testing.assert_allclose(lnl[0], lnl[1], rtol=0, atol=1e-4)

