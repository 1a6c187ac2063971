"""Host-side tree moves, newick parser and writer in pure Python (counterpart
of the subset of ``trex_tpu/io/fallback.py`` the parsimony path needs).

The JAX package calls a native library for these when it is built; these
Python versions share its contracts (canonical numbering, move validity,
enumeration order), which the JAX package's own tests pin.
"""

from __future__ import annotations

import numpy as np


def _canonicalize(n_leaves: int, kids: dict[int, list[int]], root: int):
    """Relabel ancestors post-order so children always precede parents.

    Structure-determined: children are traversed ordered by minimum leaf
    descendant, so identical structures always map to identical arrays
    regardless of child-list order. Iterative throughout, so deep
    (caterpillar-like) trees of thousands of nodes stay within Python's
    recursion limit.
    """
    n_all = 2 * n_leaves - 1
    minleaf: dict[int, int] = {}
    pending: list[tuple[int, bool]] = [(root, False)]
    while pending:
        node, expanded = pending.pop()
        cs = kids.get(node, [])
        if not cs:
            minleaf[node] = node
        elif expanded:
            minleaf[node] = min(minleaf[c] for c in cs)
        elif node not in minleaf:
            pending.append((node, True))
            pending.extend((c, False) for c in cs if c not in minleaf)
    relabel = {i: i for i in range(n_leaves)}
    order: list[int] = []
    stack = [root]
    while stack:
        node = stack.pop()
        order.append(node)
        # Push smaller-minleaf first so the larger-minleaf child pops first;
        # reversed order then numbers smaller-minleaf subtrees first.
        stack.extend(sorted(kids.get(node, []), key=lambda c: minleaf[c]))
    next_id = n_leaves
    for node in reversed(order):
        if kids.get(node) and node not in relabel:
            relabel[node] = next_id
            next_id += 1
    children = np.full((n_leaves - 1, 2), -1, dtype=np.int32)
    parents = np.full(n_all, -1, dtype=np.int32)
    for node, cs in kids.items():
        if not cs:
            continue
        p = relabel[node]
        c0, c1 = sorted(relabel[c] for c in cs)
        children[p - n_leaves] = (c0, c1)
        parents[c0] = p
        parents[c1] = p
    parents[n_all - 1] = n_all - 1
    return children, parents, relabel


def py_parse_newick(text: str):
    """Parse rooted binary newick; returns (children, parents, blens, names)
    with leaves numbered in order of appearance and ancestors canonical."""
    pos = 0
    nodes: list[dict] = []

    def skip_ws():
        nonlocal pos
        while pos < len(text) and text[pos].isspace():
            pos += 1

    def parse_clade() -> int:
        nonlocal pos
        skip_ws()
        if pos >= len(text):
            raise ValueError("unexpected end of newick")
        node = {"kids": [], "label": "", "blen": 0.0, "leaf": False}
        nodes.append(node)
        idx = len(nodes) - 1
        if text[pos] == "(":
            pos += 1
            while True:
                node["kids"].append(parse_clade())
                skip_ws()
                if pos < len(text) and text[pos] == ",":
                    pos += 1
                    continue
                break
            skip_ws()
            if pos >= len(text) or text[pos] != ")":
                raise ValueError("missing ')'")
            pos += 1
        else:
            node["leaf"] = True
        start = pos
        while pos < len(text) and text[pos] not in ":,()' ;\t\n":
            pos += 1
        node["label"] = text[start:pos]
        skip_ws()
        if pos < len(text) and text[pos] == ":":
            pos += 1
            bstart = pos
            while pos < len(text) and (text[pos].isdigit() or text[pos] in ".+-eE"):
                pos += 1
            node["blen"] = float(text[bstart:pos])
        return idx

    root = parse_clade()
    leaves = [i for i, n in enumerate(nodes) if n["leaf"]]
    for n in nodes:
        if not n["leaf"] and len(n["kids"]) != 2:
            raise ValueError("non-binary newick node")
    n_leaves = len(leaves)
    engine_id = {}
    names = []
    for k, i in enumerate(leaves):
        engine_id[i] = k
        names.append(nodes[i]["label"])
    nxt = n_leaves
    for i, n in enumerate(nodes):
        if not n["leaf"]:
            engine_id[i] = nxt
            nxt += 1
    kids = {
        engine_id[i]: [engine_id[c] for c in n["kids"]]
        for i, n in enumerate(nodes)
    }
    children, parents, relabel = _canonicalize(n_leaves, kids, engine_id[root])
    blens = np.zeros(2 * n_leaves - 1)
    for i, n in enumerate(nodes):
        blens[relabel[engine_id[i]]] = n["blen"]
    return children, parents, blens, names


def py_write_newick(children: np.ndarray, leaf_names: list[str] | None = None) -> str:
    n_leaves = children.shape[0] + 1
    names = leaf_names or [f"L{i}" for i in range(n_leaves)]
    repr_ = list(names) + [""] * (n_leaves - 1)
    for a in range(n_leaves - 1):
        c0, c1 = int(children[a, 0]), int(children[a, 1])
        repr_[n_leaves + a] = f"({repr_[c0]},{repr_[c1]})"
    return repr_[2 * n_leaves - 2] + ";"


def _tree_maps(children: np.ndarray):
    """(kids dict, parent dict, n_leaves, n_all) from a children array."""
    children = np.asarray(children, dtype=np.int32)
    n_leaves = children.shape[0] + 1
    n_all = 2 * n_leaves - 1
    kids = {
        n_leaves + a: [int(children[a, 0]), int(children[a, 1])]
        for a in range(n_leaves - 1)
    }
    parent = {n_all - 1: n_all - 1}
    for p, cs in kids.items():
        for c in cs:
            parent[c] = p
    return kids, parent, n_leaves, n_all


def _tbr_apply(
    kids: dict[int, list[int]],
    parent: dict[int, int],
    n_leaves: int,
    prune: int,
    reroot: int,
    regraft: int,
):
    """Apply a validated TBR move; returns canonical (children, parents) or
    None on a degenerate result. ``reroot == prune`` is plain SPR. Mutates
    its dict arguments — pass copies."""
    n_all = 2 * n_leaves - 1
    p = parent[prune]
    sibling = kids[p][1] if kids[p][0] == prune else kids[p][0]

    # Splice p out of the remainder (sibling takes its place).
    gp = parent[p]
    if gp != p:
        kids[gp] = [sibling if k == p else k for k in kids[gp]]
        parent[sibling] = gp
    else:
        parent[sibling] = sibling  # sibling becomes the remainder's root

    # Re-root the pruned subtree at the edge above reroot.
    if reroot != prune:
        path = []  # reroot ... prune, via (pre-splice) parent pointers
        n = reroot
        while True:
            path.append(n)
            if n == prune:
                break
            n = parent[n]
        reversed_ = -1
        for i in range(len(path) - 1, 0, -1):
            node = path[i]
            path_child = path[i - 1]
            if node == prune:
                reversed_ = (
                    kids[node][1] if kids[node][0] == path_child else kids[node][0]
                )
                kids[node] = []  # smoothed out of the tree
            else:
                keep = (
                    kids[node][1] if kids[node][0] == path_child else kids[node][0]
                )
                kids[node] = [keep, reversed_]
                reversed_ = node
        kids[prune] = [reroot, reversed_]
    sub_root = prune

    # Regraft sub_root onto the edge above regraft, reusing p as junction.
    rp = parent[regraft]
    if rp == regraft:
        kids[p] = [sub_root, regraft]
        parent[p] = p
    else:
        kids[rp] = [p if k == regraft else k for k in kids[rp]]
        kids[p] = [sub_root, regraft]
        parent[p] = rp
    parent[sub_root] = p
    parent[regraft] = p

    # Validate binary shape and find the unique root before canonicalizing.
    internal = {n for n, cs in kids.items() if cs}
    if any(len(kids[n]) != 2 for n in internal):
        return None
    if len(internal) != n_leaves - 1:
        return None
    is_child = {c for n in internal for c in kids[n]}
    roots = [n for n in internal if n not in is_child]
    if len(roots) != 1:
        return None
    clean = {n: kids[n] for n in internal}
    ch, par, _ = _canonicalize(n_leaves, clean, roots[0])
    if (ch < 0).any() or (par[: n_all - 1] < 0).any():
        return None
    return ch, par


def py_spr_move(children: np.ndarray, prune: int, regraft: int):
    """One SPR move; canonical (children, parents) or None if invalid.

    Invalid when the regraft edge is inside the pruned subtree, at the
    pruned node's sibling or parent (no-ops), or either node is the root.
    """
    kids, parent, n_leaves, n_all = _tree_maps(children)
    if not (0 <= prune < n_all - 1 and 0 <= regraft < n_all - 1):
        return None
    x = regraft
    while True:  # reject regrafting inside the pruned subtree
        if x == prune:
            return None
        if parent[x] == x:
            break
        x = parent[x]
    p = parent[prune]
    sibling = kids[p][1] if kids[p][0] == prune else kids[p][0]
    if regraft in (sibling, p):
        return None
    return _tbr_apply(kids, parent, n_leaves, prune, prune, regraft)


def py_nni_neighbors(children: np.ndarray):
    """All NNI neighbors, canonical: (B, n_anc, 2) children, (B, n_all) parents.

    Order: ancestors ascending, then the internal child, then which of its
    children swaps with the sibling.
    """
    children = np.asarray(children, dtype=np.int32)
    n_leaves = children.shape[0] + 1
    n_all = 2 * n_leaves - 1
    base = {
        n_leaves + a: [int(children[a, 0]), int(children[a, 1])]
        for a in range(n_leaves - 1)
    }
    out_c, out_p = [], []
    for a in range(n_leaves - 1):
        p = n_leaves + a
        for ci in range(2):
            c = base[p][ci]
            if c < n_leaves:
                continue
            sibling = base[p][1 - ci]
            for gi in range(2):
                kids = {k: list(v) for k, v in base.items()}
                grand = kids[c][gi]
                kids[p][1 - ci] = grand
                kids[c][gi] = sibling
                ch, par, _ = _canonicalize(n_leaves, kids, n_all - 1)
                out_c.append(ch)
                out_p.append(par)
    return np.stack(out_c), np.stack(out_p)
