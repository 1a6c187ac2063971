"""Data I/O and host-side tree moves (counterpart of ``trex_tpu/io/__init__.py``).

Alignments come in as FASTA/PHYLIP/NEXUS text and leave as int32
state-set masks (reconstructed states go back out as FASTA); trees come in
and leave as newick, with or without branch lengths and support labels.
Newick parsing and writing, topology sampling and move generation (NNI,
SPR, TBR) run on the host in the port's native library (``io.native``,
built at first use) when it loads, else in Python (``io.fallback``) with
the same outputs; rerooting and pruning are Python.
"""

from __future__ import annotations

import numpy as np

from trex_tpu_torch.io import native
from trex_tpu_torch.io.fallback import (
    _canonicalize,
    py_nni_neighbors,
    py_parse_newick,
    py_sample_topologies,
    py_spr_move,
    py_spr_neighborhood,
    py_tbr_move,
    py_tbr_neighborhood,
    py_write_newick,
)
from trex_tpu_torch.io.formats import (
    DNA,
    IUPAC_DNA_MASKS,
    PROTEIN,
    encode_alignment,
    encode_alignment_masks,
    mask_lookup,
    parse_nexus,
    parse_paml_rates,
    parse_partitions,
    parse_phylip,
    write_phylip,
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
    parse = native.parse_newick if native.available() else py_parse_newick
    children, parents, blens, names = parse(text)
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


def format_tree(
    topology: Topology,
    leaf_names: list[str] | None = None,
    annotations: dict[int, str] | None = None,
) -> str:
    """ASCII rendering of a topology; ``annotations`` maps a node index to
    extra text (branch lengths, supports, states)."""
    children, _ = topology.to_numpy()
    n_leaves = topology.n_leaves
    names = leaf_names or [f"L{i}" for i in range(n_leaves)]
    ann = annotations or {}
    root = topology.n_all - 1
    lines = [f"[{root}]" + (f"  {ann[root]}" if root in ann else "")]
    # An explicit stack: deep (caterpillar) trees stay within Python's
    # recursion limit.
    a, b = children[root - n_leaves]
    stack = [(int(b), "", True), (int(a), "", False)]
    while stack:
        node, prefix, is_last = stack.pop()
        branch = "`-- " if is_last else "|-- "
        label = names[node] if node < n_leaves else f"[{node}]"
        extra = f"  {ann[node]}" if node in ann else ""
        lines.append(prefix + branch + label + extra)
        if node >= n_leaves:
            child_prefix = prefix + ("    " if is_last else "|   ")
            a2, b2 = children[node - n_leaves]
            stack.append((int(b2), child_prefix, True))
            stack.append((int(a2), child_prefix, False))
    return "\n".join(lines)


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
    support=None,
) -> str:
    """Serialize a topology to newick, optionally with lengths and support.

    ``branch_lengths``: (n_all,) lengths indexed by child node, written
    ``:{x:.8g}`` on each child edge; the root entry is ignored.
    ``support``: (n_ancestors,) values indexed like ``topology.children``
    (e.g. ``search.bootstrap.split_support``), written as internal node
    labels in the ``(a,b)0.95:length`` position, the root's omitted;
    numbers are formatted ``%.4g``, strings pass through. Labels with
    newick metacharacters are single-quoted.
    """
    children, _ = topology.to_numpy()
    names = _quote_names(leaf_names)
    if branch_lengths is None and support is None:
        if native.available():
            return native.write_newick(children, names)
        return py_write_newick(children, names)
    blens = None if branch_lengths is None else np.asarray(
        branch_lengths.cpu() if hasattr(branch_lengths, "cpu") else branch_lengths,
        dtype=np.float64,
    )
    if support is not None and not any(isinstance(v, str) for v in support):
        support = np.asarray(support, dtype=np.float64)
    return _write_newick_annotated(children, names, blens, support)


def _write_newick_annotated(children, leaf_names, blens, support) -> str:
    n_leaves = children.shape[0] + 1
    repr_ = list(leaf_names or [f"L{i}" for i in range(n_leaves)]) + [""] * (n_leaves - 1)
    for a in range(n_leaves - 1):
        c0, c1 = int(children[a, 0]), int(children[a, 1])
        left, right = repr_[c0], repr_[c1]
        if blens is not None:
            left += f":{blens[c0]:.8g}"
            right += f":{blens[c1]:.8g}"
        label = "" if support is None else _format_label(support[a])
        repr_[n_leaves + a] = f"({left},{right}){label}"
    # The root's label annotates no split: strip it.
    out = repr_[2 * n_leaves - 2]
    if support is not None:
        root_label = _format_label(support[n_leaves - 2])
        if root_label:
            out = out[: len(out) - len(root_label)]
    return out + ";"


def _format_label(value) -> str:
    """Internal-node label: strings pass through, numbers get ``%.4g``."""
    return value if isinstance(value, str) else f"{value:.4g}"


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


def parse_fasta(text: str, alphabet: str = DNA) -> tuple[list[str], np.ndarray]:
    """Parse FASTA text into (names, (n_seqs, L) int8 states).

    Unknown characters (gaps, ambiguity codes) map to state 0; use
    ``parse_fasta_masks`` to keep them as state-set bitmasks.
    """
    names, data = _split_fasta(text)
    return names, encode_alignment(data, alphabet)


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


def canonicalize_topology(
    children: np.ndarray, lengths: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray | None]:
    """Structure-determined canonical numbering of one host children array.

    Accepts any valid rooted-binary ``children`` (root = last ancestor; the
    numbering need not even be topological, as the samplers' pointer-swap
    moves leave it) and returns the canonical (children, ``lengths``
    permuted to the new node numbers, or None) — the byte identity every
    host-built topology carries.
    """
    children = np.asarray(children)
    n_leaves = children.shape[0] + 1
    kids = {
        n_leaves + a: [int(children[a, 0]), int(children[a, 1])]
        for a in range(n_leaves - 1)
    }
    ch, _, relabel = _canonicalize(n_leaves, kids, 2 * n_leaves - 2)
    if lengths is None:
        return ch, None
    out = np.array(lengths, dtype=np.float32, copy=True)
    for old, new in relabel.items():
        out[new] = lengths[old]
    return ch, out


def sample_topologies(seed: int, n_leaves: int, batch: int, device="cuda") -> Topology:
    """``batch`` random coalescent topologies, canonical (native sampler,
    or ``py_sample_topologies``, whose draws differ)."""
    from trex_tpu_torch._device import resolve_device

    sample = native.sample_topologies if native.available() else py_sample_topologies
    return from_numpy(*sample(seed, n_leaves, batch), resolve_device(device))


def nni_neighbors_host(topology: Topology) -> tuple[np.ndarray, np.ndarray]:
    """NNI neighbors as host numpy (children, parents)."""
    children, _ = topology.to_numpy()
    if native.available():
        return native.nni_neighbors(children)
    return py_nni_neighbors(children)


def nni_neighbors(topology: Topology, device=None) -> Topology:
    """All NNI neighbors of one topology, as a batched Topology on
    ``device`` (default: the topology's)."""
    children, parents = nni_neighbors_host(topology)
    return from_numpy(children, parents, topology.device if device is None else device)


def spr_neighborhood_host(topology: Topology) -> tuple[np.ndarray, np.ndarray]:
    """The deduplicated SPR neighborhood as host numpy (children, parents).

    Native: views into per-shape cached buffers, overwritten by the next
    call of the same shape (copy to keep them); Python otherwise, the same
    trees in the same order.
    """
    children, _ = topology.to_numpy()
    if native.available():
        return native.spr_neighborhood(children)
    return py_spr_neighborhood(children)


def spr_neighborhood(topology: Topology) -> Topology:
    """Every distinct valid SPR move of a topology, batched, on its device
    (copied out of the native library's reused buffers)."""
    children, parents = spr_neighborhood_host(topology)
    return from_numpy(children.copy(), parents.copy(), topology.device)


def tbr_neighborhood_host(
    topology: Topology, max_trees: int = 16384, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """The deduplicated TBR neighborhood (SPR included) as host numpy,
    truncated at ``max_trees`` after a seeded shuffle of the iteration
    order (an unbiased sample). Native: views into cached buffers (copy to
    keep them). The Python fallback has the same move set; its truncated
    sample is another subset (the shuffle streams differ).
    """
    children, _ = topology.to_numpy()
    if native.available():
        return native.tbr_neighborhood(children, max_trees=max_trees, seed=seed)
    return py_tbr_neighborhood(children, max_trees=max_trees, seed=seed)


def tbr_neighborhood(topology: Topology, max_trees: int = 16384, seed: int = 0) -> Topology:
    """The (possibly sampled) TBR neighborhood, batched, on the topology's
    device (copied out of the native library's reused buffers)."""
    children, parents = tbr_neighborhood_host(topology, max_trees=max_trees, seed=seed)
    return from_numpy(children.copy(), parents.copy(), topology.device)


def spr_move_host(children: np.ndarray, prune_node: int, regraft_node: int):
    """One SPR move on a host children array: canonical (children,
    parents), or None if invalid."""
    if native.available():
        return native.spr_move(np.asarray(children), prune_node, regraft_node)
    return py_spr_move(children, prune_node, regraft_node)


def tbr_move_host(children: np.ndarray, prune_node: int, reroot_node: int, regraft_node: int):
    """One TBR move on a host children array (None if invalid)."""
    if native.available():
        return native.tbr_move(np.asarray(children), prune_node, reroot_node, regraft_node)
    return py_tbr_move(children, prune_node, reroot_node, regraft_node)


def spr_move(topology: Topology, prune_node: int, regraft_node: int) -> Topology | None:
    """One subtree-prune-regraft move on the topology's device (None if invalid)."""
    result = spr_move_host(topology.to_numpy()[0], prune_node, regraft_node)
    return None if result is None else from_numpy(*result, device=topology.device)


def tbr_move(
    topology: Topology, prune_node: int, reroot_node: int, regraft_node: int
) -> Topology | None:
    """One tree-bisection-reconnection move (None if invalid): prune the
    subtree above ``prune_node``, re-root it on the edge above
    ``reroot_node`` (inside it; ``prune_node`` for plain SPR), regraft it
    on the edge above ``regraft_node``."""
    result = tbr_move_host(topology.to_numpy()[0], prune_node, reroot_node, regraft_node)
    return None if result is None else from_numpy(*result, device=topology.device)


def renumber_leaves(topology: Topology, new_leaf_ids) -> Topology:
    """Permute leaf indices (``new_leaf_ids[i]`` = new index of leaf ``i``)
    and re-canonicalize the ancestor numbering: puts trees parsed from
    different files on one name -> index mapping."""
    return relabel_leaves(topology, np.asarray(new_leaf_ids))


def prune_to_taxa(topology: Topology, keep: list[int], branch_lengths=None):
    """Induced subtree on a leaf subset, degree-2 nodes suppressed.

    ``keep``: at least two distinct leaf indices; the pruned tree numbers
    them 0..k-1 in the order given. ``branch_lengths``: optional (n_all,)
    lengths by child node; lengths along a suppressed path are summed onto
    the surviving edge. Returns (pruned topology, pruned lengths or None,
    ``keep``).
    """
    n_leaves, n_all = topology.n_leaves, topology.n_all
    if len(keep) < 2:
        raise ValueError("need at least two retained taxa")
    if len(set(keep)) != len(keep) or not all(0 <= x < n_leaves for x in keep):
        raise ValueError("keep must be distinct leaf indices")
    children, _ = topology.to_numpy()
    blens = None if branch_lengths is None else np.asarray(branch_lengths, dtype=np.float64)
    new_id = {old: i for i, old in enumerate(keep)}
    # Bottom-up: each node resolves to (surviving node id, length above it)
    # or None when its subtree holds no kept leaf.
    k = len(keep)
    resolved: list[tuple[int, float] | None] = [None] * n_all
    for leaf, i in new_id.items():
        resolved[leaf] = (i, 0.0 if blens is None else float(blens[leaf]))
    kids: dict[int, list[tuple[int, float]]] = {}
    next_internal = k
    for a in range(n_leaves - 1):
        node = n_leaves + a
        survivors = [resolved[int(c)] for c in children[a] if resolved[int(c)] is not None]
        own_len = 0.0 if blens is None or node == n_all - 1 else float(blens[node])
        if len(survivors) == 1:  # unary: extend the child's edge upward
            child_id, below = survivors[0]
            resolved[node] = (child_id, below + own_len)
        elif survivors:
            kids[next_internal] = survivors
            resolved[node] = (next_internal, own_len)
            next_internal += 1
    new_root = resolved[n_all - 1][0]
    ch, par, relabel = _canonicalize(k, {p: [c for c, _ in cs] for p, cs in kids.items()},
                                     new_root)
    out = from_numpy(ch, par, topology.device)
    if blens is None:
        return out, None, list(keep)
    new_blens = np.zeros((2 * k - 1,), dtype=np.float64)
    for cs in kids.values():
        for c, length in cs:
            new_blens[relabel[c]] = length
    return out, new_blens, list(keep)


def reroot_at_edge(topology: Topology, node: int, branch_lengths=None):
    """Re-root the tree's unrooted structure on the edge above ``node``.

    The old root is smoothed out (its two edges become one, lengths
    summed) and a new root bisects the edge between ``node`` and its
    parent (its length split evenly). Parsimony scores and reversible-model
    likelihoods are unchanged; it serves outgroup rooting. Returns
    (topology, lengths by child node or None).
    """
    children, _ = topology.to_numpy()
    n_leaves, n_all = topology.n_leaves, topology.n_all
    old_root = n_all - 1
    # Parents from children: batched scorers may carry a placeholder parents row.
    parents = np.arange(n_all, dtype=np.int64)
    for a in range(n_leaves - 1):
        parents[children[a]] = n_leaves + a
    blens = None if branch_lengths is None else np.asarray(branch_lengths, dtype=np.float64)
    if node == old_root or int(parents[node]) == old_root:
        return topology, blens  # the root already bisects this edge

    # Undirected adjacency of the unrooted tree: the old root suppressed,
    # its two children joined by one edge.
    adj: dict[int, list[tuple[int, float]]] = {i: [] for i in range(n_all - 1)}

    def add_edge(a: int, b: int, w: float) -> None:
        adj[a].append((b, w))
        adj[b].append((a, w))

    for a in range(n_leaves - 2):
        for c in children[a]:
            add_edge(n_leaves + a, int(c), 0.0 if blens is None else float(blens[c]))
    rc1, rc2 = (int(c) for c in children[old_root - n_leaves])
    add_edge(rc1, rc2, 0.0 if blens is None else float(blens[rc1]) + float(blens[rc2]))

    up = int(parents[node])
    target_w = 0.0 if blens is None else float(blens[node])
    # Orient every edge away from a new root bisecting (node, up).
    kids: dict[int, list[int]] = {old_root: [node, up]}
    new_blens = np.zeros((n_all,), dtype=np.float64)
    new_blens[node] = new_blens[up] = target_w / 2.0
    stack = [(node, up), (up, node)]
    while stack:
        cur, came_from = stack.pop()
        cs = []
        for nxt, w in adj[cur]:
            if nxt == came_from:
                continue
            cs.append(nxt)
            new_blens[nxt] = w
            stack.append((nxt, cur))
        if cs:
            kids[cur] = cs
    ch, par, relabel = _canonicalize(n_leaves, kids, old_root)
    out = from_numpy(ch, par, topology.device)
    if blens is None:
        return out, None
    remapped = np.zeros((n_all,), dtype=np.float64)
    for old, new in relabel.items():
        remapped[new] = new_blens[old]
    remapped[n_all - 1] = 0.0
    return out, remapped


def reroot_on_outgroup(topology: Topology, outgroup: list[int], branch_lengths=None):
    """Root so the ``outgroup`` leaves form one child of the root; raises
    ``ValueError`` unless they are one side of a split of the unrooted
    tree. Returns (topology, lengths or None)."""
    from trex_tpu_torch.search.bootstrap import subtree_leaf_sets

    n_leaves = topology.n_leaves
    want = frozenset(outgroup)
    if not want or not all(0 <= x < n_leaves for x in want):
        raise ValueError("outgroup must be a non-empty set of leaf indices")
    every = frozenset(range(n_leaves))
    if want == every:
        raise ValueError("outgroup cannot contain every taxon")
    if len(want) == 1:
        return reroot_at_edge(topology, next(iter(want)), branch_lengths)
    # The edge above ancestor a splits off its clade; either side may match.
    for a, clade in enumerate(subtree_leaf_sets(topology)[:-1]):
        if clade == want or every - clade == want:
            return reroot_at_edge(topology, n_leaves + a, branch_lengths)
    raise ValueError("outgroup is not monophyletic on this tree (no edge splits it off)")


__all__ = [
    "DNA",
    "PROTEIN",
    "IUPAC_DNA_MASKS",
    "align_leaf_order",
    "canonicalize_topology",
    "format_tree",
    "encode_alignment",
    "encode_alignment_masks",
    "load_newick",
    "nni_neighbors",
    "nni_neighbors_host",
    "parse_fasta",
    "parse_fasta_masks",
    "parse_nexus",
    "parse_paml_rates",
    "parse_partitions",
    "parse_phylip",
    "prune_to_taxa",
    "relabel_leaves",
    "renumber_leaves",
    "reroot_at_edge",
    "reroot_on_outgroup",
    "sample_topologies",
    "save_newick",
    "spr_move",
    "spr_move_host",
    "spr_neighborhood",
    "spr_neighborhood_host",
    "tbr_move",
    "tbr_move_host",
    "tbr_neighborhood",
    "tbr_neighborhood_host",
    "write_fasta",
    "write_phylip",
]
