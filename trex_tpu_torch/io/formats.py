"""PHYLIP and NEXUS alignment readers and the state-set encoding
(counterpart of ``trex_tpu/io/formats.py``; host-side numpy).

Both loaders return raw character matrices; ``encode_alignment_masks``
turns them into IUPAC state-set bitmasks, the ambiguity-aware encoding
every parsimony scorer takes with ``sequences_are_masks=True``.
"""

from __future__ import annotations

import numpy as np

# Alphabets: index 0.. for states.
DNA = "ACGT"
PROTEIN = "ARNDCQEGHILKMFPSTWYV"

# IUPAC nucleotide ambiguity codes -> state-set bitmasks over DNA (A=1, C=2,
# G=4, T=8). Gaps and '?' are fully missing (any state).
IUPAC_DNA_MASKS = {
    "A": 0b0001, "C": 0b0010, "G": 0b0100, "T": 0b1000, "U": 0b1000,
    "R": 0b0101, "Y": 0b1010, "S": 0b0110, "W": 0b1001,
    "K": 0b1100, "M": 0b0011,
    "B": 0b1110, "D": 0b1101, "H": 0b1011, "V": 0b0111,
    "N": 0b1111, "X": 0b1111, "-": 0b1111, "?": 0b1111, ".": 0b1111,
}


def mask_lookup(alphabet: str) -> np.ndarray:
    """(256,) int32 byte -> state-set mask table (0 = not in the alphabet).

    DNA takes the IUPAC table; other alphabets get one bit per letter and
    treat only gap/missing characters as ambiguous.
    """
    lookup = np.zeros(256, dtype=np.int32)
    if alphabet == DNA:
        for ch, mask in IUPAC_DNA_MASKS.items():
            lookup[ord(ch)] = mask
            lookup[ord(ch.lower())] = mask
    else:
        for i, ch in enumerate(alphabet):
            lookup[ord(ch)] = 1 << i
            lookup[ord(ch.lower())] = 1 << i
        for ch in "-?.Xx":
            lookup[ord(ch)] = (1 << len(alphabet)) - 1
    return lookup


def _strip_nexus_comments(text: str) -> str:
    out: list[str] = []
    depth = 0
    for ch in text:
        if ch == "[":
            depth += 1
        elif ch == "]":
            if depth == 0:
                raise ValueError("unbalanced ']' in NEXUS input")
            depth -= 1
        elif depth == 0:
            out.append(ch)
    if depth:
        raise ValueError("unterminated [comment] in NEXUS input")
    return "".join(out)


def parse_phylip(text: str) -> tuple[list[str], np.ndarray]:
    """Parse PHYLIP (sequential or interleaved) into (names, (n, L) chars).

    Relaxed dialect: names are whitespace-delimited; sequence characters
    may contain spaces. Layout is auto-detected from the first block.
    """
    lines = [ln.rstrip() for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("empty PHYLIP input")
    header = lines[0].split()
    if len(header) < 2:
        raise ValueError(f"bad PHYLIP header: {lines[0]!r}")
    n_taxa, n_chars = int(header[0]), int(header[1])
    body = lines[1:]
    if len(body) < n_taxa:
        raise ValueError(f"expected {n_taxa} sequence lines, got {len(body)}")

    names: list[str] = []
    seqs: list[str] = []
    for ln in body[:n_taxa]:
        parts = ln.split(None, 1)
        if len(parts) < 2:
            raise ValueError(f"PHYLIP line without sequence: {ln!r}")
        names.append(parts[0])
        seqs.append(parts[1].replace(" ", ""))

    # Interleaved continuation blocks: bare sequence chunks, taxa order.
    for idx, ln in enumerate(body[n_taxa:]):
        seqs[idx % n_taxa] += ln.replace(" ", "")

    lengths = {len(s) for s in seqs}
    if lengths != {n_chars}:
        raise ValueError(
            f"sequence lengths {sorted(lengths)} != header nchar {n_chars}"
        )
    data = np.frombuffer(
        "".join(seqs).encode("ascii"), dtype=np.uint8
    ).reshape(n_taxa, n_chars)
    return names, data


def write_phylip(names: list[str], rows: np.ndarray) -> str:
    """Serialize a character matrix to relaxed sequential PHYLIP."""
    rows = np.asarray(rows, dtype=np.uint8)
    out = [f"{rows.shape[0]} {rows.shape[1]}"]
    width = max(len(n) for n in names) + 2
    for name, row in zip(names, rows):
        out.append(f"{name:<{width}}{row.tobytes().decode('ascii')}")
    return "\n".join(out) + "\n"


def parse_nexus(
    text: str,
) -> tuple[list[str] | None, np.ndarray | None, dict[str, str]]:
    """Parse a NEXUS file's DATA/CHARACTERS and TREES blocks.

    Returns (names, (n, L) raw character matrix, trees) — names/matrix are
    None when there is no data block; ``trees`` maps tree names to newick
    strings with TRANSLATE tokens resolved.
    """
    stripped = _strip_nexus_comments(text)
    if "#nexus" not in stripped.lower():
        raise ValueError("not a NEXUS file (missing #NEXUS header)")
    lower = stripped.lower()
    blocks: list[tuple[str, str]] = []
    pos = 0
    while True:
        b = lower.find("begin ", pos)
        if b < 0:
            break
        semi = lower.find(";", b)
        name = lower[b + 6 : semi].strip()
        e = lower.find("end;", semi)
        if e < 0:
            e = lower.find("endblock;", semi)
            if e < 0:
                raise ValueError(f"unterminated NEXUS block {name!r}")
        blocks.append((name, stripped[semi + 1 : e]))
        pos = e + 1

    names: list[str] | None = None
    matrix: np.ndarray | None = None
    trees: dict[str, str] = {}
    for name, content in blocks:
        if name in ("data", "characters"):
            names, matrix = _parse_nexus_matrix(content)
        elif name == "trees":
            trees.update(_parse_nexus_trees(content))
    return names, matrix, trees


def _parse_nexus_matrix(content: str) -> tuple[list[str], np.ndarray]:
    lower = content.lower()
    m = lower.find("matrix")
    if m < 0:
        raise ValueError("NEXUS data block without MATRIX")
    semi = content.find(";", m)
    if semi < 0:
        raise ValueError("unterminated MATRIX (missing ';')")
    rows: dict[str, str] = {}
    order: list[str] = []
    for ln in content[m + len("matrix") : semi].splitlines():
        ln = ln.strip()
        if not ln:
            continue
        if ln.startswith("'"):
            end = ln.index("'", 1)
            name, seq = ln[1:end], ln[end + 1 :]
        else:
            parts = ln.split(None, 1)
            if len(parts) < 2:
                continue
            name, seq = parts
        seq = seq.replace(" ", "")
        if name not in rows:
            rows[name] = ""
            order.append(name)
        rows[name] += seq
    if not order:
        raise ValueError("empty NEXUS MATRIX")
    first = rows[order[0]]
    lengths = {len(rows[n]) for n in order}
    if len(lengths) != 1:
        raise ValueError(f"NEXUS matrix rows differ in length: {sorted(lengths)}")
    # '.' means "same as first row" (match-character convention).
    resolved = [
        "".join(f if c == "." else c for c, f in zip(rows[n], first))
        for n in order
    ]
    data = np.frombuffer(
        "".join(resolved).encode("ascii"), dtype=np.uint8
    ).reshape(len(order), -1)
    return order, data


def _parse_nexus_trees(content: str) -> dict[str, str]:
    translate: dict[str, str] = {}
    trees: dict[str, str] = {}
    statements = [s.strip() for s in content.split(";") if s.strip()]
    for stmt in statements:
        lower = stmt.lower()
        if lower.startswith("translate"):
            for pair in stmt[len("translate") :].split(","):
                parts = pair.split()
                if len(parts) >= 2:
                    translate[parts[0]] = parts[1].strip("'")
        elif lower.startswith("tree"):
            eq = stmt.find("=")
            if eq < 0:
                continue
            name = stmt[4:eq].strip().lstrip("*").strip()
            newick = stmt[eq + 1 :].strip()
            if newick.lower().startswith("[&"):  # rooted/unrooted marker
                newick = newick[newick.index("]") + 1 :].strip()
            if translate:
                newick = _apply_translate(newick, translate)
            trees[name] = newick + ";"
    return trees


def _apply_translate(newick: str, table: dict[str, str]) -> str:
    """Replace TRANSLATE tokens (appearing as labels) with taxon names."""
    out: list[str] = []
    token = ""
    for ch in newick:
        if ch in "(),:;[]":
            if token:
                out.append(table.get(token.strip(), token))
                token = ""
            out.append(ch)
        else:
            token += ch
    if token:
        out.append(table.get(token.strip(), token))
    return "".join(out)


def encode_alignment(rows: np.ndarray, alphabet: str) -> np.ndarray:
    """Raw character matrix -> int8 integer states (unknowns -> state 0)."""
    lookup = np.zeros(256, dtype=np.int8)
    for i, ch in enumerate(alphabet):
        lookup[ord(ch)] = i
        lookup[ord(ch.lower())] = i
    return lookup[np.asarray(rows, dtype=np.uint8)]


def encode_alignment_masks(rows: np.ndarray, alphabet: str) -> np.ndarray:
    """Raw character matrix -> IUPAC state-set bitmasks (ambiguity-aware).

    Raises on characters outside the alphabet/IUPAC set.
    """
    rows = np.asarray(rows, dtype=np.uint8)
    masks = mask_lookup(alphabet)[rows]
    bad = masks == 0
    if bad.any():
        i, j = np.argwhere(bad)[0]
        raise ValueError(
            f"character {chr(rows[i, j])!r} at row {i} column {j} is not in "
            "the alphabet or IUPAC table"
        )
    return masks


def parse_paml_rates(text: str, n_states: int = 20) -> tuple[np.ndarray, np.ndarray]:
    """Parse a PAML-format substitution-rate file (the published LG / WAG /
    JTT amino-acid ``.dat`` layout, or any custom matrix in it).

    Whitespace-separated numbers: the strictly-lower-triangular
    exchangeabilities row by row (row i has i entries, i = 1..Q-1), then Q
    stationary frequencies. Text after those numbers is ignored; ``#`` and
    ``//`` start a comment.

    Returns (rates (Q, Q) symmetric with a zero diagonal, freqs (Q,)
    normalised), both float32: the ``fixed_rates``/``fixed_freqs`` of
    ``ops.likelihood.optimize_model(model="empirical", ...)``.
    """
    values: list[float] = []
    n_tri = n_states * (n_states - 1) // 2
    needed = n_tri + n_states
    for line in text.splitlines():
        stripped = line.split("#")[0].split("//")[0]
        for token in stripped.split():
            try:
                values.append(float(token))
            except ValueError:
                # Trailing text (matrix names, citations) ends the numbers
                # only once every number is read.
                if len(values) >= needed:
                    break
                raise ValueError(f"unexpected token {token!r} in PAML rate file") from None
        if len(values) >= needed:
            break
    if len(values) < needed:
        raise ValueError(
            f"PAML rate file has {len(values)} numbers; "
            f"need {n_tri} exchangeabilities + {n_states} frequencies"
        )
    rates = np.zeros((n_states, n_states))
    k = 0
    for i in range(1, n_states):
        for j in range(i):
            rates[i, j] = rates[j, i] = values[k]
            k += 1
    freqs = np.asarray(values[n_tri:needed], dtype=np.float64)
    if (freqs < 0).any() or freqs.sum() <= 0:
        raise ValueError("invalid frequencies in PAML rate file")
    freqs = freqs / freqs.sum()
    return rates.astype(np.float32), freqs.astype(np.float32)


def parse_partitions(text: str, n_sites: int) -> tuple[np.ndarray, list[str], list[str]]:
    """Parse a RAxML-style partition file into per-site partition ids.

    Lines look like ``DNA, gene1 = 1-500`` with 1-based inclusive ranges;
    several comma-separated segments (``501-800, 900-950``), single sites
    (``77``) and codon-position strides (``1-900\\3``) are taken. Blank
    lines and ``#``/``//`` comments are ignored.

    Returns (ids (n_sites,) int32 partition index per site, names, types):
    ``types`` is each line's leading model/datatype token, verbatim.

    Raises ValueError on a malformed line, a range outside the alignment,
    a site assigned twice or a site no partition covers.
    """
    ids = np.full((n_sites,), -1, dtype=np.int32)
    names: list[str] = []
    types: list[str] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#")[0].split("//")[0].strip()
        if not line:
            continue
        if "=" not in line or "," not in line.split("=")[0]:
            raise ValueError(f"partition line {lineno}: expected 'TYPE, name = ranges'")
        head, ranges = line.split("=", 1)
        ptype, name = (s.strip() for s in head.split(",", 1))
        part = len(names)
        names.append(name)
        types.append(ptype)
        for segment in ranges.split(","):
            segment = segment.strip()
            if not segment:
                continue
            stride = 1
            if "\\" in segment:
                segment, stride_s = segment.split("\\", 1)
                stride = int(stride_s)
                segment = segment.strip()
            if "-" in segment:
                lo_s, hi_s = segment.split("-", 1)
                lo, hi = int(lo_s), int(hi_s)
            else:
                lo = hi = int(segment)
            if not (1 <= lo <= hi <= n_sites):
                raise ValueError(
                    f"partition line {lineno}: range {segment!r} outside 1..{n_sites}")
            sel = np.arange(lo - 1, hi, stride)
            clash = ids[sel] >= 0
            if clash.any():
                raise ValueError(
                    f"partition line {lineno}: site {int(sel[clash][0]) + 1} assigned twice")
            ids[sel] = part
    uncovered = int((ids < 0).sum())
    if uncovered:
        raise ValueError(f"{uncovered} sites not covered by any partition")
    return ids, names, types
