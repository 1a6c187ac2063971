"""End to end, the slice 1b ``infer`` flags whose draws the port takes
from torch generators (``--ratchet``, ``--bootstrap``: the same keys as
``trex_tpu.cli infer --mesh 1,1`` and a valid tree; the functions
themselves replay the JAX draws in ``test_torch_supports.py``), and
``--outgroup`` under ``--criterion ml`` (the unrooted run's tree and
lengths put through ``io.reroot_on_outgroup``, which
``test_torch_moves.py`` holds to the JAX package's), on the 16-taxon
FASTA of ``test_torch_infer_1b.py``."""

import re

import numpy as np
import pytest
import torch
from _torch_parity import jitted_jax_scores, tree_fasta
from test_torch_infer_1b import _both, _run

import trex_tpu_torch.cli as torch_cli
import trex_tpu_torch.io as tio


@pytest.fixture(autouse=True)
def _jitted(monkeypatch):
    jitted_jax_scores(monkeypatch)


@pytest.fixture(scope="module")
def aln(tmp_path_factory):
    """The FASTA and a cherry of the default run's tree."""
    path = tmp_path_factory.mktemp("aln1b") / "aln.fasta"
    path.write_text(tree_fasta(np.random.default_rng(5), 16, 64, 0.5))
    base = _run(torch_cli, ["infer", "--alignment", str(path), "--device", "cpu", "--orders", "1"])
    cherry = ",".join(re.search(r"\((taxon_\d+),(taxon_\d+)\)", base["tree"]).groups())
    return str(path), cherry


@pytest.mark.parametrize("flags", [["--ratchet", "2", "--rounds", "4", "--neighborhood", "nni"],
                                   ["--bootstrap", "3", "--outgroup", "CHERRY"]],
                         ids=["ratchet", "bootstrap"])
def test_drawn_flags_give_jax_keys_and_a_valid_tree(aln, flags):
    flags = [aln[1] if f == "CHERRY" else f for f in flags]
    ours, _ = _both(aln, flags)
    topo, _, names = tio.load_newick(ours["tree"])
    assert sorted(names) == sorted(f"taxon_{i}" for i in range(16))
    assert topo.n_leaves == 16
    if "--bootstrap" in flags:
        assert ours["bootstrap_replicates"] == 3 and ours["outgroup"] == aln[1]
        assert len(ours["split_support"]) == 15 and ours["split_support"][-1] == 1.0
        assert all(0.0 <= s <= 1.0 for s in ours["split_support"])
    else:
        assert ours["ratchet_iterations"] == 2
        assert ours["parsimony_score"] <= _run(torch_cli, [
            "infer", "--alignment", aln[0], "--device", "cpu", "--rounds", "4", "--orders", "1",
            "--neighborhood", "nni",
        ])["parsimony_score"]


def test_ml_outgroup_reroots_the_ml_tree(aln):
    from trex_tpu_torch.cli import build_parser
    from trex_tpu_torch.cli.infer import run_infer

    argv = ["infer", "--alignment", aln[0], "--device", "cpu", "--criterion", "ml",
            "--neighborhood", "nni", "--rounds", "3", "--orders", "1"]
    plain = run_infer(build_parser().parse_args(argv))
    rooted = run_infer(build_parser().parse_args(argv + ["--outgroup", "taxon_7"]))
    topo, lengths = tio.reroot_on_outgroup(plain.result.topology, [7],
                                           plain.lengths.numpy())
    assert torch.equal(rooted.result.topology.children, topo.children)
    assert torch.equal(rooted.lengths, torch.as_tensor(lengths, dtype=torch.float32))
    assert list(rooted.out) == list(plain.out)[:5] + ["outgroup"] + list(plain.out)[5:]
    assert rooted.out["outgroup"] == "taxon_7"
    assert rooted.out["neg_log_likelihood"] == plain.out["neg_log_likelihood"]
    assert rooted.out["tree"] == tio.save_newick(topo, [f"taxon_{i}" for i in range(16)],
                                                 lengths.astype(np.float32))
