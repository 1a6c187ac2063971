"""Shared helpers for the CLI commands (counterpart of ``trex_tpu/cli/_common.py``)."""

from __future__ import annotations

import argparse

import numpy as np


def _add_common(p: argparse.ArgumentParser) -> None:
    """The generated-data flags the JAX commands share."""
    p.add_argument("--leaves", type=int, default=16)
    p.add_argument("--sites", type=int, default=128)
    p.add_argument("--states", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics-file", type=str, default=None)


def _add_device(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=f"where {what} runs (default cuda; raises when no "
                        "card is present)")


def _load_alignment(path: str, alphabet_name: str):
    """Read an alignment -> (names, (n, L) int32 state-set masks, n_states).

    Format auto-detected: NEXUS (``#NEXUS`` header), PHYLIP (numeric
    ``ntax nchar`` header), else FASTA. Always encodes through the
    ambiguity-preserving path so gaps and IUPAC codes get standard
    missing-data semantics.
    """
    from trex_tpu_torch.io import (
        DNA,
        PROTEIN,
        encode_alignment_masks,
        parse_fasta_masks,
        parse_nexus,
        parse_phylip,
    )

    alphabet = {"dna": DNA, "protein": PROTEIN}[alphabet_name]
    with open(path) as fh:
        text = fh.read()
    head = text.lstrip()[:40].lower()
    if head.startswith("#nexus"):
        names, rows, _ = parse_nexus(text)
        if rows is None:
            raise SystemExit(f"{path}: NEXUS file has no DATA/CHARACTERS block")
        masks = encode_alignment_masks(rows, alphabet)
    elif head.split()[:2] and head.split()[0].isdigit():
        names, rows = parse_phylip(text)
        masks = encode_alignment_masks(rows, alphabet)
    else:
        names, masks = parse_fasta_masks(text, alphabet)
    return names, np.asarray(masks, dtype=np.int32), len(alphabet)


def _start_tree(
    kind: str, masks, n_states: int, seed: int, weights, orders: int, device
):
    """Build the requested starting topology from (possibly ambiguous) leaves."""
    from trex_tpu_torch.search.stepwise import stepwise_addition_multi

    if kind != "stepwise":
        later = {"nj": "slice 2b", "upgma": "slice 2b", "diff": "slice 3"}
        raise SystemExit(
            f"--start {kind} is not ported yet: {later.get(kind, 'slice 1b')} "
            "of ROADMAP.md"
        )
    topo, _ = stepwise_addition_multi(
        masks, n_states, n_orders=orders, seed=seed,
        sequences_are_masks=True, site_weights=weights, device=device,
    )
    return topo
