"""Argument parser and entry point (counterpart of ``trex_tpu/cli/parser.py``;
the ``infer`` command only)."""

from __future__ import annotations

import argparse

import torch

import trex_tpu_torch.cli as _cli_pkg
from trex_tpu_torch.cli.infer import cmd_infer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="trex_tpu_torch", description=_cli_pkg.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("infer", help="infer a tree from an alignment file")
    p.add_argument("--alignment", "--fasta", dest="fasta", type=str,
                   required=True,
                   help="FASTA/PHYLIP/NEXUS alignment (auto-detected)")
    p.add_argument("--alphabet", choices=("dna", "protein"), default="dna")
    p.add_argument("--criterion", choices=("parsimony", "ml", "distance"),
                   default="parsimony",
                   help="parsimony or ml (distance: a later slice)")
    p.add_argument("--model", default="jc",
                   help="substitution model for --criterion ml: jc (the "
                        "fitted models: a later slice)")
    p.add_argument("--model-file", type=str, default=None,
                   help="PAML-format rate file (a later slice)")
    p.add_argument("--model-rounds", type=int, default=0,
                   help="ML model <-> tree iterations (a later slice)")
    p.add_argument("--start",
                   choices=("stepwise", "nj", "upgma", "random", "balanced",
                            "diff"),
                   default="stepwise",
                   help="starting tree: stepwise addition (the others: a "
                        "later slice)")
    p.add_argument("--orders", type=int, default=4,
                   help="random addition orders for --start stepwise")
    p.add_argument("--constraint", type=str, default=None,
                   help="constraint newick (a later slice)")
    p.add_argument("--neighborhood",
                   choices=("spr-scan", "spr", "nni", "tbr"),
                   default="spr-scan",
                   help="spr-scan = analytic all-SPR evaluation; nni = "
                        "enumerated NNI batch scored by the Fitch kernel "
                        "(parsimony) or the likelihood kernel (ml) "
                        "(spr/tbr: a later slice)")
    p.add_argument("--rounds", type=int, default=100,
                   help="max hill-climb rounds")
    p.add_argument("--ratchet", type=int, default=0,
                   help="parsimony-ratchet iterations (a later slice)")
    p.add_argument("--decay", action="store_true",
                   help="SPR-decay support (a later slice)")
    p.add_argument("--bootstrap", type=int, default=0,
                   help="bootstrap replicates (a later slice)")
    p.add_argument("--outgroup", type=str, default=None,
                   help="outgroup rooting (a later slice)")
    p.add_argument("--alrt", type=int, default=0,
                   help="SH-aLRT supports (a later slice)")
    p.add_argument("--ufboot", type=int, default=0,
                   help="ultrafast bootstrap supports (a later slice)")
    p.add_argument("--restarts", type=int, default=1,
                   help="independent searches: the --start tree plus N-1 "
                        "more random-addition starts; best final score wins")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-tree", type=str, default=None)
    p.add_argument("--mesh", type=str, default=None, metavar="T,S",
                   help="only '1,1' (one device) is ported")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the search runs (default cuda; raises when "
                        "no card is present)")
    p.set_defaults(fn=cmd_infer)
    return parser


def main(argv: list[str] | None = None) -> None:
    # Float32 products stay full float32 on the card (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
