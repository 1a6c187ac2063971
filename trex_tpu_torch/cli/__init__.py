"""Command-line interface: ``python -m trex_tpu_torch.cli infer --alignment X``.

infer       File-based parsimony tree inference: FASTA/PHYLIP/NEXUS in,
            stepwise-addition start, SPR-scan (default) or NNI hill climb,
            newick and score out as one JSON line — the same keys and the
            same tree and score as ``python -m trex_tpu.cli infer``. Runs on
            the card (``--device cuda``, default) or the CPU.
"""

from trex_tpu_torch.cli.parser import build_parser, main

__all__ = ["build_parser", "main"]
