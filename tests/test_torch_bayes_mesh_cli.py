"""``--mesh`` on the port's ``mcmc`` and ``bayesfactor``, two CPU ranks
(gloo) each running the command: rank 0 prints the JSON that the
single-process command prints for the same seed (the chains' draws come
from one seeded generator on every rank, each rank taking its rows), and
writes ``--output-tree``, ``--samples-out`` and ``--trace-out`` as the
single-process command writes them; rank 1 prints and writes nothing.
``mcmc`` at 1 run x 4 chains on (2, 1) (the MC^3 swap straddles the
ranks), at 2 runs x 4 chains on (1, 2), and with no flag at 1 run x 3
chains (``auto``: the largest tree axis that divides the chains, so
(1, 2)); ``bayesfactor --models jc,gtr`` at 8 rungs on (2, 1).
6 taxa x 300 sites."""

import contextlib
import io
import json

import numpy as np
import pytest
from _torch_dist import start_ranks
from _torch_parity import parents_of, random_children, tree_fasta

import trex_tpu_torch.cli as torch_cli

FILES = ("tree.nwk", "samples.txt", "trace.tsv")
MCMC = ["--generations", "40", "--sample-every", "10", "--seed", "3"]
COMMANDS = {
    # name: (command's arguments, its --mesh)
    "straddle": (["--runs", "1", "--chains", "4"], "2,1"),
    "sites": (["--runs", "2", "--chains", "4"], "1,2"),
    "auto": (["--runs", "1", "--chains", "3"], None),
}


def _json(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        torch_cli.main(argv)
    return json.loads(buf.getvalue())


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    from trex_tpu_torch.io import save_newick
    from trex_tpu_torch.topology import from_numpy

    root = tmp_path_factory.mktemp("bayes_mesh_cli")
    fasta = root / "aln.fasta"
    fasta.write_text(tree_fasta(np.random.default_rng(2), 6, 300, 0.08))
    children = random_children(np.random.default_rng(4), 6, 1)[0]
    tree = root / "tree.nwk"
    tree.write_text(save_newick(from_numpy(children, parents_of(children)),
                                [f"taxon_{i}" for i in range(6)]) + "\n")

    def outputs(prefix: str = "") -> list[str]:
        flags = ("--output-tree", "--samples-out", "--trace-out")
        return [x for flag, f in zip(flags, FILES) for x in (flag, prefix + f)]

    argvs, single = [], {}
    for name, (extra, mesh) in COMMANDS.items():
        argv = ["mcmc", "--fasta", str(fasta), *MCMC, *extra, "--device", "cpu"]
        argvs.append(argv + outputs() + ([] if mesh is None else ["--mesh", mesh]))
        single[name] = argv + outputs(f"{root}/{name}_")
    bayesfactor = ["bayesfactor", "--fasta", str(fasta), "--tree", str(tree), "--models",
                   "jc,gtr", "--rungs", "8", "--generations", "30", "--seed", "1", "--device",
                   "cpu"]
    argvs.append(bayesfactor + ["--mesh", "2,1"])
    ranks = start_ranks(root, "cli", dict(argvs=argvs, files=[list(FILES)] * len(COMMANDS)
                                          + [[]]))
    want = {name: _json(argv) for name, argv in single.items()}
    want["bayesfactor"] = _json(bayesfactor)
    files = {name: [(root / f"{name}_{f}").read_text() for f in FILES] for name in COMMANDS}
    return dict(want=want, files=files, outs=ranks.wait())


def _printed(outs, i):
    assert outs[1][f"stdout_{i}"].item() == ""
    return json.loads(outs[0][f"stdout_{i}"].item())


@pytest.mark.parametrize("i,name", list(enumerate(COMMANDS)))
def test_meshed_mcmc_prints_the_single_process_json(case, i, name):
    got = _printed(case["outs"], i)
    assert list(got) == list(case["want"][name]) and got == case["want"][name]
    assert got["n_samples"] > 0 and got["acceptance"]["swap"] > 0


@pytest.mark.parametrize("i,name", list(enumerate(COMMANDS)))
def test_only_rank_0_writes_the_files(case, i, name):
    for f, want in zip(FILES, case["files"][name]):
        assert case["outs"][0][f"file_{i}_{f}"].item() == want, f
        assert case["outs"][1][f"file_{i}_{f}"].item() == "", f


def test_meshed_bayesfactor_prints_the_single_process_json(case):
    got = _printed(case["outs"], len(COMMANDS))
    assert list(got) == list(case["want"]["bayesfactor"]) and got == case["want"]["bayesfactor"]
    assert set(got["models"]) == {"jc", "gtr"}
