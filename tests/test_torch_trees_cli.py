"""The tree-file commands end to end: ``python -m trex_tpu_torch.cli
<command>`` against ``python -m trex_tpu.cli <command>`` on one small
FASTA/newick set: ``treedist``, ``consensus``, ``treeprune``, ``treedraw``,
``stats``, ``concord`` (the same JSON or text; distances within 1e-12),
``bootstrap`` (on the JAX package's generated data and replicate draws) and
``topotest`` (JC, the JAX package's replicate draws, the AU test off: both
packages' ``au_scales`` default set to None, as ``test_torch_topotest.py``
holds the AU fit; likelihoods within rtol 2e-5, ``delta`` within 1e-2, the
p-values equal, the site-lnL file within 1e-4). ``infer --alrt --ufboot``:
``test_torch_supports_cli.py``."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch
from _torch_parity import (
    jax_draws_by_seed,
    jitted_jax_scores,
    parents_of,
    random_children,
    tree_fasta,
)

import trex_tpu.cli as jax_cli
import trex_tpu_torch.cli as torch_cli

N_TAXA, N_SITES = 8, 60


def _text(cli, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def _both(argv, torch_extra=(), jax_extra=()):
    ours = json.loads(_text(torch_cli, [*argv, *torch_extra]))
    theirs = json.loads(_text(jax_cli, [*argv, *jax_extra]))
    assert list(ours) == list(theirs)
    return ours, theirs


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A FASTA, two trees with lengths over its taxa (leaves in different
    orders) and a multi-newick file of replicates around a third tree."""
    from trex_tpu_torch.io import nni_neighbors_host, save_newick
    from trex_tpu_torch.topology import from_numpy

    root = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(12)
    fasta = root / "aln.fasta"
    fasta.write_text(tree_fasta(rng, N_TAXA, N_SITES, 0.25))
    names = [f"taxon_{i}" for i in range(N_TAXA)]
    children = random_children(rng, N_TAXA, 3)
    lengths = rng.uniform(0.01, 0.4, (3, 2 * N_TAXA - 1))
    tree_a = root / "a.nwk"
    tree_a.write_text(save_newick(from_numpy(children[0], parents_of(children[0])), names,
                                  lengths[0]) + "\n")
    tree_b = root / "b.nwk"
    tree_b.write_text(save_newick(from_numpy(children[1], parents_of(children[1])),
                                  names[::-1], lengths[1]) + "\n")
    ref = from_numpy(children[2], parents_of(children[2]))
    neighbours, _ = nni_neighbors_host(ref)
    reps = [children[2]] * 3 + list(neighbours[:5])
    multi = root / "reps.nwk"
    multi.write_text("\n".join(save_newick(from_numpy(c, parents_of(c)), names)
                               for c in reps) + "\n")
    return dict(root=root, fasta=str(fasta), a=str(tree_a), b=str(tree_b), multi=str(multi),
                names=names)


def test_treedist(files):
    ours, theirs = _both(["treedist", files["a"], files["b"]])
    for key in ("branch_score", "weighted_rf", "path_difference"):
        assert abs(ours.pop(key) - theirs.pop(key)) <= 1e-12
    assert ours == theirs


@pytest.mark.parametrize("threshold", ["0.5", "0.7"])
def test_consensus(files, threshold, tmp_path):
    out = tmp_path / "cons.nwk"
    ours, theirs = _both(["consensus", files["multi"], "--threshold", threshold,
                          "--output-tree", str(out)])
    assert ours == theirs
    assert out.read_text() == theirs["tree"] + "\n"


@pytest.mark.parametrize("invert", [False, True])
def test_treeprune(files, invert, tmp_path):
    taxa = ",".join(files["names"][1:6:2])
    flags = ["--invert"] if invert else []
    outs = {}
    for name, cli in (("ours", torch_cli), ("theirs", jax_cli)):
        aln = tmp_path / f"{name}.fasta"
        outs[name] = json.loads(_text(cli, [
            "treeprune", "--tree", files["a"], "--taxa", taxa, *flags, "--alignment",
            files["fasta"], "--output-alignment", str(aln)]))
        outs[name + "_aln"] = aln.read_text()
    assert outs["ours"] == outs["theirs"]
    assert outs["ours_aln"] == outs["theirs_aln"]


def test_treedraw_and_stats(files):
    for tree in (files["a"], files["multi"]):
        assert _text(torch_cli, ["treedraw", "--tree", tree]) == \
            _text(jax_cli, ["treedraw", "--tree", tree])
    ours, theirs = _both(["stats", "--alignment", files["fasta"]])
    assert ours == theirs


def test_concord(files, tmp_path):
    out = tmp_path / "concord.nwk"
    ours, theirs = _both(["concord", "--tree", files["a"], "--gene-trees", files["multi"],
                          "--fasta", files["fasta"], "--quartets", "30", "--seed", "4",
                          "--output-tree", str(out)])
    assert ours == theirs
    assert out.read_text() == theirs["tree"] + "\n"


def test_bootstrap(monkeypatch):
    """On the JAX package's generated data and replicate draws."""
    from trex_tpu.models.mutation_tree import generate_groundtruth

    import trex_tpu_torch.cli.search_cmds as search_cmds
    from trex_tpu_torch.types import CostModel

    argv = ["bootstrap", "--leaves", "8", "--sites", "32", "--replicates", "4",
            "--search-rounds", "3", "--seed", "3"]
    gt = generate_groundtruth(8, 4, 3, 32, seed=3)
    leaf = torch.as_tensor(np.asarray(gt.all_sequences[:8]).astype(np.int32))
    monkeypatch.setattr(search_cmds, "_generated", lambda args, device: (
        None, leaf.to(device), None, CostModel.hamming(4, device=device).matrix))
    jax_draws_by_seed(monkeypatch)
    jitted_jax_scores(monkeypatch)
    ours, theirs = _both(argv, torch_extra=["--device", "cpu"])
    assert ours == theirs


def test_topotest(files, monkeypatch, tmp_path):
    """Candidates: the trees of a, b and the replicate file's fourth."""
    import trex_tpu.search.topotest as jax_topotest

    import trex_tpu_torch.search.topotest as torch_topotest

    for module in (jax_topotest, torch_topotest):
        monkeypatch.setitem(module.topology_tests.__kwdefaults__, "au_scales", None)
    jax_draws_by_seed(monkeypatch)
    trees = tmp_path / "cands.nwk"
    trees.write_text(open(files["a"]).read() + open(files["b"]).read()
                     + open(files["multi"]).read().splitlines()[3] + "\n")
    lnl = {name: tmp_path / f"{name}.lnl" for name in ("ours", "theirs")}
    argv = ["topotest", "--alignment", files["fasta"], "--trees", str(trees),
            "--replicates", "200", "--seed", "2"]
    ours, theirs = _both(argv, ["--device", "cpu", "--site-lnl", str(lnl["ours"])],
                         ["--mesh", "1,1", "--site-lnl", str(lnl["theirs"])])
    assert ours["n_trees"] == 3
    for row_o, row_t in zip(ours.pop("table"), theirs.pop("table"), strict=True):
        got, want = row_o.pop("log_likelihood"), row_t.pop("log_likelihood")
        assert abs(got - want) <= 2e-5 * abs(want)
        assert abs(row_o.pop("delta") - row_t.pop("delta")) <= 1e-2
        assert row_o == row_t
    assert ours == theirs
    got = np.loadtxt(lnl["ours"], skiprows=1, usecols=range(1, N_SITES + 1))
    want = np.loadtxt(lnl["theirs"], skiprows=1, usecols=range(1, N_SITES + 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
