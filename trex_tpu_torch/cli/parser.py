"""Argument parser and entry point (counterpart of ``trex_tpu/cli/parser.py``;
the ``score``, ``infer`` and ``bench`` commands)."""

from __future__ import annotations

import argparse

import torch

import trex_tpu_torch.cli as _cli_pkg
from trex_tpu_torch.cli._common import _add_common, _add_device
from trex_tpu_torch.cli.infer import cmd_infer
from trex_tpu_torch.cli.score import cmd_score
from trex_tpu_torch.cli.search_cmds import cmd_bench


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="trex_tpu_torch", description=_cli_pkg.__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("score", help="exact Sankoff scoring + reconstruction")
    _add_common(p)
    p.add_argument("--mutations", type=int, default=3)
    p.add_argument("--alignment", "--fasta", dest="fasta", type=str,
                   default=None,
                   help="score a real alignment (FASTA/PHYLIP/NEXUS, "
                        "auto-detected) instead of generated data")
    p.add_argument("--tree", type=str, default=None,
                   help="newick tree to score (default: stepwise addition)")
    p.add_argument("--alphabet", choices=("dna", "protein"), default="dna")
    p.add_argument("--criterion", choices=("parsimony", "ml"),
                   default="parsimony",
                   help="parsimony (ml: a later slice)")
    p.add_argument("--model", type=str, default="jc",
                   help="substitution model for --criterion ml (a later slice)")
    p.add_argument("--model-file", type=str, default=None,
                   help="PAML-format rate file (a later slice)")
    p.add_argument("--site-rates", type=str, default=None,
                   help="posterior per-site rates (a later slice)")
    p.add_argument("--asr", choices=("marginal", "joint"), default="marginal",
                   help="ASR flavor for --criterion ml (a later slice)")
    p.add_argument("--output-fasta", type=str, default=None,
                   help="write leaves + reconstructed ancestors here")
    _add_device(p, "the scoring")
    p.set_defaults(fn=cmd_score)

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
    _add_device(p, "the search")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("bench", help="batched scoring throughput")
    _add_common(p)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--reps", type=int, default=20)
    _add_device(p, "the scoring")
    p.set_defaults(fn=cmd_bench)
    return parser


def main(argv: list[str] | None = None) -> None:
    # Float32 products stay full float32 on the card (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
