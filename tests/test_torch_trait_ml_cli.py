"""End to end: the ``trait`` and ``ml`` commands of ``trex_tpu_torch.cli``
(``--device cpu``) against ``trex_tpu.cli``.

``trait`` on a tree with branch lengths and a trait that follows it: the
same states, log-likelihood to its printed 4 decimals (within 1e-4) and
MAP states; the Mk rate within rtol 1e-2 and posteriors within 1e-3: at
the flat optimum a float32 log-likelihood resolves the rate only to a few
parts in a thousand, so the golden-section search turns 1-ulp differences
of the likelihood into another last bracket (ROADMAP.md, accepted
differences). ``ml``: the JAX command's keys; its generated data come from
the port's own generators (an accepted difference), so the same start and
leaves are handed to both packages' ``ml_hill_climb`` (enumerated SPR
rounds, the command's defaults otherwise): the same topology, score,
rounds and evaluations, the Newton curve within rtol 2e-5.

The JAX side's unjitted likelihood calls run jitted (the same functions,
compiled whole), to fit the suite's time.
"""

import contextlib
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import parents_of, random_children

import trex_tpu.cli as jax_cli
import trex_tpu.ops.likelihood as jl
import trex_tpu.search.ml as jm
import trex_tpu_torch.cli as torch_cli
from trex_tpu.topology import Topology as JaxTopology
from trex_tpu_torch.cli.search_cmds import run_ml
from trex_tpu_torch.io import save_newick
from trex_tpu_torch.search.ml import ml_hill_climb
from trex_tpu_torch.topology import Topology


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


@pytest.fixture
def jitted_likelihood(monkeypatch):
    jitted = jax.jit(jl.tree_log_likelihood, static_argnums=(3,),
                     static_argnames=("sequences_are_masks",))
    monkeypatch.setattr(jl, "tree_log_likelihood", jitted)
    monkeypatch.setattr(jm, "tree_log_likelihood", jitted)


@pytest.fixture(scope="module")
def trait_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("trait")
    rng = np.random.default_rng(14)
    n = 9
    children = random_children(rng, n, 1)[0]
    topo = Topology(torch.as_tensor(children), torch.as_tensor(parents_of(children)))
    names = [f"taxon_{i}" for i in range(n)]
    lengths = rng.uniform(0.05, 0.8, 2 * n - 1)
    (root / "lengths.nwk").write_text(save_newick(topo, names, lengths) + "\n")
    # A trait that follows the tree: one state per side of the root, one
    # leaf with a third state, one missing.
    side = {children[-1][0]: "fin", children[-1][1]: "wing"}
    for a in range(n - 2, -1, -1):
        for c in children[a]:
            side.setdefault(int(c), side.get(n + a))
    traits = np.array([side[i] for i in range(n)], dtype=object)
    traits[int(np.argmax(traits == "wing"))] = "leg"
    traits[int(np.argmax(traits == "fin"))] = "?"
    (root / "traits.tsv").write_text(
        "# taxon\tstate\n" + "".join(f"{a},{b}\n" for a, b in zip(names, traits)))
    return root


def test_trait_matches_jax(trait_files, tmp_path, jitted_likelihood):
    argv = ["trait", "--tree", str(trait_files / "lengths.nwk"),
            "--traits", str(trait_files / "traits.tsv")]
    ours = _run(torch_cli, argv + ["--device", "cpu", "--output-tree", str(tmp_path / "t.nwk")])
    ref = _run(jax_cli, argv)
    assert list(ours) == list(ref)
    assert ours["states"] == ref["states"] == ["fin", "leg", "wing"]
    np.testing.assert_allclose(ours["mk_rate"], ref["mk_rate"], rtol=1e-2)
    assert abs(ours["log_likelihood"] - ref["log_likelihood"]) <= 1e-4
    for a, b in zip(ours["ancestral_nodes"], ref["ancestral_nodes"]):
        assert (a["ancestor"], a["map_state"], list(a["posterior"])) == (
            b["ancestor"], b["map_state"], list(b["posterior"]))
        np.testing.assert_allclose(list(a["posterior"].values()),
                                   list(b["posterior"].values()), atol=1e-3)
    strip = re.compile(r"=[0-9.]+")  # the posterior in each node label
    assert strip.sub("", ours["tree"]) == strip.sub("", ref["tree"])
    assert (tmp_path / "t.nwk").read_text() == ours["tree"] + "\n"


def test_trait_needs_branch_lengths(trait_files, tmp_path):
    bare = tmp_path / "bare.nwk"
    bare.write_text(re.sub(r":[0-9.eE+-]+", "", (trait_files / "lengths.nwk").read_text()))
    with pytest.raises(SystemExit, match="branch lengths"):
        _run(torch_cli, ["trait", "--tree", str(bare), "--traits",
                         str(trait_files / "traits.tsv"), "--device", "cpu"])


def test_ml_command_matches_jax(jitted_likelihood):
    argv = ["ml", "--leaves", "8", "--sites", "48", "--rounds", "4"]
    ours = _run(torch_cli, argv + ["--device", "cpu"])
    ref = _run(jax_cli, argv)
    assert list(ours) == list(ref)
    assert np.isfinite(ours["final_neg_log_likelihood"]) and ours["evaluations"] > 1
    out, (start, leaf) = run_ml(torch_cli.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert out == ours
    got = ml_hill_climb(start, leaf, 4, max_rounds=4)
    want = jm.ml_hill_climb(JaxTopology(jnp.asarray(start.children.numpy()),
                                        jnp.asarray(start.parents.numpy())),
                            jnp.asarray(leaf.numpy()), 4, max_rounds=4)
    np.testing.assert_array_equal(got[0].topology.children.numpy(),
                                  np.asarray(want[0].topology.children))
    assert (got[0].rounds, got[0].evaluations) == (want[0].rounds, want[0].evaluations)
    np.testing.assert_allclose(got[0].score, want[0].score, rtol=2e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=2e-5)
    assert got[0].score == ours["ranking_score"]
