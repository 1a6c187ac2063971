"""Host-side tree moves, topology sampling, newick parser and writer in pure
Python (counterpart of ``trex_tpu/io/fallback.py``).

``trex_tpu_torch.io`` calls the port's native library (``io.native``) for
these when it is built; these Python versions share its contracts
(canonical numbering, move validity, enumeration order) and are the parity
oracle of ``tests/test_torch_native.py``.
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


def py_sample_topologies(seed: int, n_leaves: int, batch: int):
    """``batch`` coalescent topologies from ``default_rng(seed)``,
    canonicalized like the native sampler's (the raw coalescent numbering
    is valid but not structure-determined). The native sampler draws from
    another stream, so the two give different trees for one seed."""
    rng = np.random.default_rng(seed)
    n_anc, n_all = n_leaves - 1, 2 * n_leaves - 1
    children = np.empty((batch, n_anc, 2), dtype=np.int32)
    parents = np.empty((batch, n_all), dtype=np.int32)
    for b in range(batch):
        active = list(range(n_leaves))
        kids: dict[int, list[int]] = {}
        for a in range(n_anc):
            i, j = rng.choice(len(active), size=2, replace=False)
            c1, c2 = active[i], active[j]
            node = n_leaves + a
            kids[node] = [min(c1, c2), max(c1, c2)]
            active = [x for x in active if x not in (c1, c2)] + [node]
        ch, par, _ = _canonicalize(n_leaves, kids, n_all - 1)
        children[b] = ch
        parents[b] = par
    return children, parents


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


def _subtree_nodes(kids: dict[int, list[int]], node: int) -> list[int]:
    """``node`` and every node below it (pre-order, last child first)."""
    out, stack = [], [node]
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(kids.get(n, []))
    return out


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


def py_tbr_move(children: np.ndarray, prune: int, reroot: int, regraft: int):
    """One TBR move; canonical (children, parents) or None if invalid.

    ``reroot`` must lie inside the pruned subtree (== ``prune`` is plain
    SPR), ``regraft`` outside it and never at the junction parent; plain
    SPR also rejects the sibling no-op.
    """
    kids, parent, n_leaves, n_all = _tree_maps(children)
    if not (
        0 <= prune < n_all - 1 and 0 <= regraft < n_all - 1 and 0 <= reroot < n_all
    ):
        return None
    in_sub = set(_subtree_nodes(kids, prune))
    if reroot not in in_sub or regraft in in_sub:
        return None
    p = parent[prune]
    sibling = kids[p][1] if kids[p][0] == prune else kids[p][0]
    if regraft == p:
        return None
    if reroot == prune and regraft == sibling:
        return None
    return _tbr_apply(kids, parent, n_leaves, prune, reroot, regraft)


def _empty(n_leaves: int):
    return (
        np.zeros((0, n_leaves - 1, 2), np.int32),
        np.zeros((0, 2 * n_leaves - 1), np.int32),
    )


def py_spr_neighborhood(children: np.ndarray, max_trees: int | None = None):
    """The deduplicated SPR neighborhood, in the native enumeration order
    (prune-major, regraft-minor, ascending), deduplicated by canonical
    bytes with the identity excluded, capped at ``max_trees`` (default
    200,000): native and Python agree tree for tree."""
    children = np.asarray(children, dtype=np.int32)
    kids, parent, n_leaves, n_all = _tree_maps(children)
    cap = min((n_all - 1) * (n_all - 1), max_trees if max_trees is not None else 200_000)
    seen = {children.tobytes()}
    out_c: list[np.ndarray] = []
    out_p: list[np.ndarray] = []
    for prune in range(n_all - 1):
        in_sub = set(_subtree_nodes(kids, prune))
        p = parent[prune]
        sibling = kids[p][1] if kids[p][0] == prune else kids[p][0]
        for regraft in range(n_all - 1):
            if regraft in in_sub or regraft in (sibling, p):
                continue
            res = _tbr_apply(
                {k: list(v) for k, v in kids.items()}, dict(parent),
                n_leaves, prune, prune, regraft,
            )
            if res is None or res[0].tobytes() in seen:
                continue
            if len(out_c) >= cap:
                return np.stack(out_c), np.stack(out_p)
            seen.add(res[0].tobytes())
            out_c.append(res[0])
            out_p.append(res[1])
    return (np.stack(out_c), np.stack(out_p)) if out_c else _empty(n_leaves)


def py_tbr_neighborhood(children: np.ndarray, max_trees: int = 16384, seed: int = 0):
    """The deduplicated TBR neighborhood (SPR included), truncated at
    ``max_trees``.

    The native move set and validity rules; the prune and regraft orders
    are shuffled by ``seed`` so a truncated set is an unbiased sample. The
    shuffle is numpy's PCG64, not the native ``mt19937_64``, so a truncated
    Python sample is another subset; untruncated, the two sets are equal.
    """
    children = np.asarray(children, dtype=np.int32)
    kids, parent, n_leaves, n_all = _tree_maps(children)
    cap = min(max_trees, 200_000)
    rng = np.random.default_rng(seed)
    prune_order = rng.permutation(n_all - 1)
    node_order = rng.permutation(n_all - 1)
    seen = {children.tobytes()}
    out_c: list[np.ndarray] = []
    out_p: list[np.ndarray] = []
    for prune in prune_order.tolist():
        sub_nodes = _subtree_nodes(kids, prune)
        in_sub = set(sub_nodes)
        p = parent[prune]
        sibling = kids[p][1] if kids[p][0] == prune else kids[p][0]
        for reroot in sub_nodes:
            for regraft in node_order.tolist():
                if regraft in in_sub or regraft == p:
                    continue
                if reroot == prune and regraft == sibling:
                    continue
                res = _tbr_apply(
                    {k: list(v) for k, v in kids.items()}, dict(parent),
                    n_leaves, prune, reroot, regraft,
                )
                if res is None or res[0].tobytes() in seen:
                    continue
                if len(out_c) >= cap:
                    return np.stack(out_c), np.stack(out_p)
                seen.add(res[0].tobytes())
                out_c.append(res[0])
                out_p.append(res[1])
    return (np.stack(out_c), np.stack(out_p)) if out_c else _empty(n_leaves)


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
