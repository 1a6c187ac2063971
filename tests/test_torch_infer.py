"""End to end: ``trex_tpu_torch.cli infer --device cpu`` prints the same tree
and score as ``trex_tpu.cli infer`` on the same FASTA, plus the port's
guards (no JAX imports, no silent CPU fall back, unported flags refused)."""

import contextlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import tree_fasta

import trex_tpu.cli as jax_cli
import trex_tpu_torch.cli as torch_cli

REPO = Path(__file__).resolve().parents[1]


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    # Divergent enough that both climbs take rounds after the stepwise start.
    path = tmp_path_factory.mktemp("aln") / "aln.fasta"
    path.write_text(tree_fasta(np.random.default_rng(5), 14, 60, 0.5))
    return str(path)


@pytest.mark.parametrize("neighborhood", ["spr-scan", "nni"])
def test_infer_matches_jax(fasta, neighborhood, tmp_path):
    out_tree = tmp_path / "tree.nwk"
    ours = _run(torch_cli, [
        "infer", "--alignment", fasta, "--device", "cpu",
        "--neighborhood", neighborhood, "--output-tree", str(out_tree),
    ])
    ref = _run(jax_cli, [
        "infer", "--alignment", fasta, "--mesh", "1,1",
        "--neighborhood", neighborhood,
    ])
    assert ours["search_rounds"] > 0
    assert list(ours) == list(ref)
    assert ours == ref
    assert out_tree.read_text() == ref["tree"] + "\n"


def _sources():
    return sorted((REPO / "trex_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_nothing_of_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|trex_tpu)(\.|\s|$)", re.M)
    offenders = [str(p) for p in _sources() if pattern.search(p.read_text())]
    assert not offenders
    modules = [
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in _sources()
        if p.name not in ("__main__.py",)
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'trex_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_cli_defaults_to_the_card(fasta):
    if torch.cuda.is_available():
        from trex_tpu_torch import resolve_device

        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli.main(["infer", "--alignment", fasta])


@pytest.mark.parametrize(
    "flags, slice_name",
    [
        (["--criterion", "ml", "--model", "gtr"], "slice 2 item 7"),
        (["--criterion", "ml", "--model-file", "lg.dat"], "slice 2 item 7"),
        (["--criterion", "distance"], "slice 2b"),
        (["--criterion", "ml", "--alrt", "10"], "queue A item 13"),
        (["--criterion", "ml", "--ufboot", "10"], "queue A item 13"),
        (["--ratchet", "2"], "slice 1b"),
        (["--bootstrap", "5"], "slice 1b"),
        (["--decay"], "slice 1b"),
        (["--outgroup", "taxon_0"], "slice 1b"),
        (["--neighborhood", "tbr"], "slice 1b"),
        (["--mesh", "2,1"], "queue A"),
        (["--start", "nj"], "slice 2b"),
        (["--start", "random"], "slice 1b"),
    ],
)
def test_unported_flags_name_their_slice(fasta, flags, slice_name):
    with pytest.raises(SystemExit, match=slice_name):
        torch_cli.main(["infer", "--alignment", fasta, "--device", "cpu", *flags])
