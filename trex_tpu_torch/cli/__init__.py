"""Command-line interface: ``python -m trex_tpu_torch.cli <command>``.

score       Exact Sankoff scoring + ancestral reconstruction of a generated
            balanced mutation tree, or (``--alignment``) the Fitch score and
            one optimal labeling of a given or stepwise-addition tree.
infer       File-based parsimony or ML tree inference: FASTA/PHYLIP/NEXUS
            in, stepwise-addition start, SPR-scan (default) or NNI hill
            climb, newick and score out as one JSON line.
bench       Batched candidate-scoring throughput on random trees (the Fitch
            kernel for Hamming with <= 32 states, the Sankoff kernel above).

Each prints the same JSON keys as ``python -m trex_tpu.cli <command>``, and
``score``/``infer`` the same trees and scores. Each runs on the card
(``--device cuda``, default) or the CPU.
"""

from trex_tpu_torch.cli.parser import build_parser, main

__all__ = ["build_parser", "main"]
