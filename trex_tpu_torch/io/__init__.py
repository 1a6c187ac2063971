"""Data I/O and host-side tree moves (counterpart of the subset of
``trex_tpu/io/__init__.py`` the parsimony and ML paths need).

Alignments come in as FASTA/PHYLIP/NEXUS text and leave as int32
state-set masks (reconstructed states go back out as FASTA); trees come in
and leave as newick, with or without branch lengths.
Move generation (SPR, NNI) and
canonical numbering run on the host in Python (``io.fallback``).
"""

from __future__ import annotations

import numpy as np

from trex_tpu_torch.io.fallback import (
    _canonicalize,
    py_nni_neighbors,
    py_parse_newick,
    py_spr_move,
    py_write_newick,
)
from trex_tpu_torch.io.formats import (
    DNA,
    IUPAC_DNA_MASKS,
    PROTEIN,
    encode_alignment_masks,
    mask_lookup,
    parse_nexus,
    parse_phylip,
)
from trex_tpu_torch.topology import Topology, from_numpy

_NEEDS_QUOTING = set(" ()[]{}:;,'\"")


def _preprocess_newick(text: str) -> tuple[str, dict[str, str]]:
    """Strip ``[...]`` comments and lift quoted labels to placeholder tokens;
    returns the cleaned text and the token -> original-label map (``''``
    escapes a quote inside a label)."""
    out: list[str] = []
    quoted: dict[str, str] = {}
    i, counter = 0, 0
    while i < len(text):
        c = text[i]
        if c == "[":
            end = text.find("]", i)
            if end < 0:
                raise ValueError("unterminated [comment] in newick input")
            i = end + 1
        elif c == "'":
            buf: list[str] = []
            j = i + 1
            while j < len(text):
                if text[j] == "'" and j + 1 < len(text) and text[j + 1] == "'":
                    buf.append("'")
                    j += 2
                elif text[j] == "'":
                    break
                else:
                    buf.append(text[j])
                    j += 1
            else:
                raise ValueError("unterminated quoted label in newick input")
            token = f"__q{counter}__"
            counter += 1
            quoted[token] = "".join(buf)
            out.append(token)
            i = j + 1
        else:
            out.append(c)
            i += 1
    return "".join(out), quoted


def load_newick(text: str, device="cpu") -> tuple[Topology, np.ndarray, list[str]]:
    """Parse newick into (Topology, branch lengths by child node, leaf names).

    Tolerates ``[...]`` comments, single-quoted labels, internal-node
    labels and missing branch lengths. Leaves are numbered in order of
    appearance, ancestors canonically.
    """
    text, quoted = _preprocess_newick(text)
    children, parents, blens, names = py_parse_newick(text)
    if quoted:
        names = [quoted.get(n, n) for n in names]
    return from_numpy(children, parents, device), blens, names


def relabel_leaves(topology: Topology, new_ids: np.ndarray) -> Topology:
    """Permute leaf indices (``new_ids[i]`` = new index of current leaf i)
    and re-canonicalize the ancestor numbering."""
    children, _ = topology.to_numpy()
    n_leaves = topology.n_leaves

    def mapped(node: int) -> int:
        return int(new_ids[node]) if node < n_leaves else node

    kids = {
        n_leaves + a: [mapped(int(children[a, 0])), mapped(int(children[a, 1]))]
        for a in range(n_leaves - 1)
    }
    ch, par, _ = _canonicalize(n_leaves, kids, topology.n_all - 1)
    return from_numpy(ch, par, topology.device)


def align_leaf_order(
    topology: Topology, names: list[str], target_names: list[str]
) -> Topology:
    """Renumber leaves so leaf i carries ``target_names[i]`` (a tree file's
    appearance order to an alignment's row order)."""
    index_of = {name: i for i, name in enumerate(target_names)}
    if set(names) != set(target_names):
        raise ValueError("leaf name sets differ")
    return relabel_leaves(topology, np.asarray([index_of[n] for n in names], dtype=np.int32))


def write_fasta(names: list[str], sequences, alphabet: str = DNA) -> str:
    """Serialize an integer state matrix (numpy or tensor) back to FASTA."""
    table = np.frombuffer(alphabet.encode("ascii"), dtype=np.uint8)
    seqs = np.asarray(sequences.cpu() if hasattr(sequences, "cpu") else sequences)
    rows = []
    for name, row in zip(names, seqs.astype(np.int64)):
        rows.append(f">{name}")
        rows.append(table[row].tobytes().decode("ascii"))
    return "\n".join(rows) + "\n"


def _quote_names(names: list[str] | None) -> list[str] | None:
    """Single-quote labels containing newick metacharacters ('' escape)."""
    if names is None:
        return None
    return [
        "'" + n.replace("'", "''") + "'"
        if any(ch in _NEEDS_QUOTING for ch in n)
        else n
        for n in names
    ]


def save_newick(
    topology: Topology,
    leaf_names: list[str] | None = None,
    branch_lengths=None,
) -> str:
    """Serialize a topology to newick, optionally with branch lengths.

    ``branch_lengths``: (n_all,) lengths indexed by child node, written
    ``:{x:.8g}`` on each child edge; the root entry is ignored. Labels with
    newick metacharacters are single-quoted.
    """
    children, _ = topology.to_numpy()
    names = _quote_names(leaf_names)
    if branch_lengths is None:
        return py_write_newick(children, names)
    blens = np.asarray(
        branch_lengths.cpu() if hasattr(branch_lengths, "cpu") else branch_lengths,
        dtype=np.float64,
    )
    n_leaves = children.shape[0] + 1
    repr_ = list(names or [f"L{i}" for i in range(n_leaves)]) + [""] * (n_leaves - 1)
    for a in range(n_leaves - 1):
        c0, c1 = int(children[a, 0]), int(children[a, 1])
        repr_[n_leaves + a] = (
            f"({repr_[c0]}:{blens[c0]:.8g},{repr_[c1]}:{blens[c1]:.8g})"
        )
    return repr_[2 * n_leaves - 2] + ";"


def _split_fasta(text: str) -> tuple[list[str], np.ndarray]:
    """FASTA text -> (names, (n_seqs, L) uint8 raw character matrix)."""
    names: list[str] = []
    chunks: list[str] = []
    current: list[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if names:
                chunks.append("".join(current))
                current = []
            names.append(line[1:].split()[0] if len(line) > 1 else "")
        else:
            current.append(line)
    if names:
        chunks.append("".join(current))
    if not names:
        raise ValueError("no sequences in FASTA input")
    lengths = {len(c) for c in chunks}
    if len(lengths) != 1:
        raise ValueError(f"unaligned sequences (lengths {sorted(lengths)})")
    data = np.frombuffer(
        "".join(chunks).encode("ascii"), dtype=np.uint8
    ).reshape(len(names), -1)
    return names, data


def parse_fasta_masks(
    text: str, alphabet: str = DNA
) -> tuple[list[str], np.ndarray]:
    """Parse FASTA into (names, (n_seqs, L) int32 state-set bitmasks).

    IUPAC nucleotide codes, gaps, ``?`` and ``N``/``X`` become multi-bit
    masks (for other alphabets only gap/missing characters are ambiguous),
    so parsimony minimizes over every resolution of the ambiguity.
    """
    names, data = _split_fasta(text)
    masks = mask_lookup(alphabet)[data]
    bad = masks == 0
    if bad.any():
        seq_i, col = np.argwhere(bad)[0]
        raise ValueError(
            f"character {chr(data[seq_i, col])!r} at sequence {seq_i} column "
            f"{col} is not in the alphabet or IUPAC table"
        )
    return names, masks


def canonicalize_topology(children: np.ndarray) -> np.ndarray:
    """Structure-determined canonical numbering of one host children array.

    Accepts any valid rooted-binary ``children`` (root = last ancestor) and
    returns the canonical children — the byte identity every host-built
    topology carries.
    """
    children = np.asarray(children)
    n_leaves = children.shape[0] + 1
    kids = {
        n_leaves + a: [int(children[a, 0]), int(children[a, 1])]
        for a in range(n_leaves - 1)
    }
    ch, _, _ = _canonicalize(n_leaves, kids, 2 * n_leaves - 2)
    return ch


def nni_neighbors_host(topology: Topology) -> tuple[np.ndarray, np.ndarray]:
    """NNI neighbors as host numpy (children, parents)."""
    children, _ = topology.to_numpy()
    return py_nni_neighbors(children)


def spr_move(topology: Topology, prune_node: int, regraft_node: int) -> Topology | None:
    """One subtree-prune-regraft move on the topology's device (None if invalid)."""
    children, _ = topology.to_numpy()
    result = py_spr_move(children, prune_node, regraft_node)
    if result is None:
        return None
    return from_numpy(*result, device=topology.device)


__all__ = [
    "DNA",
    "PROTEIN",
    "IUPAC_DNA_MASKS",
    "align_leaf_order",
    "canonicalize_topology",
    "encode_alignment_masks",
    "load_newick",
    "nni_neighbors_host",
    "parse_fasta_masks",
    "parse_nexus",
    "parse_phylip",
    "relabel_leaves",
    "save_newick",
    "spr_move",
    "write_fasta",
]
