"""End to end, the flags of parsimony ``infer`` that slice 1b ported:
``trex_tpu_torch.cli infer --device cpu`` against ``trex_tpu.cli infer
--mesh 1,1`` on a 16-taxon FASTA. The same JSON for ``--decay``,
``--outgroup``, ``--constraint``, ``--neighborhood spr|tbr`` and
``--start balanced|random``, and the same refusals. ``--ratchet``,
``--bootstrap`` and ML ``--outgroup``: ``test_torch_infer_1b_drawn.py``."""

import contextlib
import io
import json
import re

import numpy as np
import pytest
from _torch_parity import jitted_jax_scores, tree_fasta

import trex_tpu.cli as jax_cli
import trex_tpu.io as jax_io
import trex_tpu_torch.cli as torch_cli
import trex_tpu_torch.io as tio


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


@pytest.fixture(autouse=True)
def _jax_setup(monkeypatch):
    jitted_jax_scores(monkeypatch)
    # The port's generators in the JAX package's mode (native or Python),
    # so a truncated TBR sample draws from the same stream.
    monkeypatch.setattr(tio.native, "available", lambda: jax_io.native.available())


@pytest.fixture(scope="module")
def aln(tmp_path_factory):
    """The FASTA, a cherry of the default run's tree and a constraint
    newick on 6 taxa."""
    path = tmp_path_factory.mktemp("aln1b") / "aln.fasta"
    path.write_text(tree_fasta(np.random.default_rng(5), 16, 64, 0.5))
    base = _run(torch_cli, ["infer", "--alignment", str(path), "--device", "cpu", "--orders", "1"])
    cherry = ",".join(re.search(r"\((taxon_\d+),(taxon_\d+)\)", base["tree"]).groups())
    constraint = path.parent / "clade.nwk"
    constraint.write_text("((taxon_0,taxon_1),(taxon_2,(taxon_3,(taxon_4,taxon_5))));\n")
    return str(path), cherry, str(constraint)


def _both(aln, flags):
    """Both CLIs' JSON (their key order equal); one addition order, as the
    climbs are what these flags change."""
    path = aln[0]
    flags = [*flags, "--orders", "1"]
    ours = _run(torch_cli, ["infer", "--alignment", path, "--device", "cpu", *flags])
    ref = _run(jax_cli, ["infer", "--alignment", path, "--mesh", "1,1", *flags])
    assert list(ours) == list(ref)
    return ours, ref


@pytest.mark.parametrize(
    "flags",
    [
        ["--decay", "--rounds", "2"],
        ["--outgroup", "CHERRY"],
        ["--outgroup", "taxon_7", "--neighborhood", "nni"],
        ["--neighborhood", "nni", "--constraint", "CONSTRAINT"],
        ["--neighborhood", "spr", "--rounds", "2"],
        ["--neighborhood", "tbr", "--rounds", "2"],
        ["--start", "balanced", "--neighborhood", "nni"],
        ["--start", "random", "--restarts", "2"],
    ],
    ids=["decay", "outgroup-cherry", "outgroup-leaf", "constraint", "spr", "tbr", "balanced",
         "random"],
)
def test_infer_json_matches_jax(aln, flags):
    flags = [aln[1] if f == "CHERRY" else aln[2] if f == "CONSTRAINT" else f for f in flags]
    ours, ref = _both(aln, flags)
    assert ours == ref
    if "--decay" in flags:
        assert any(d is not None for d in ours["decay"])
    if "--constraint" in flags:
        assert ours["constraint_splits"] == 4 and ours["constraint_taxa"] == 6


@pytest.mark.parametrize(
    "flags, message",
    [
        (["--constraint", "CONSTRAINT"], "spr-scan cannot filter"),
        (["--neighborhood", "nni", "--constraint", "CONSTRAINT", "--ratchet", "1"],
         "does not combine"),
        (["--outgroup", "nobody"], "not in the alignment"),
    ],
)
def test_jax_refusals(aln, flags, message):
    flags = [aln[2] if f == "CONSTRAINT" else f for f in flags]
    for cli, extra in ((torch_cli, ["--device", "cpu"]), (jax_cli, ["--mesh", "1,1"])):
        with pytest.raises(SystemExit, match=message):
            _run(cli, ["infer", "--alignment", aln[0], *extra, *flags])
