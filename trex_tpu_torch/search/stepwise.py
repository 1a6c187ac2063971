"""Greedy stepwise-addition starting trees (counterpart of
``trex_tpu/search/stepwise.py``).

Two paths. The batched path (``use_scan=False``, and the default above 30
states) grows the induced tree on the host and scores every insertion edge
of a step as one batch of full-size trees through K1
(``ops.fitch.batched_fitch_score``). The scan path (the default up to 30
states) is described below.

Every intermediate tree is full-size over all n taxa: not-yet-added taxa
hang on a "parked chain" above the induced tree and are fully ambiguous
until inserted, which leaves every score unchanged. One insertion step:

1. dissolve the chain node holding the next taxon t into a pass-through
   row (the single-prune variant of ``ops.spr_scan``);
2. score every insertion edge with the SPR identity from the maintained,
   flagged Fitch up sets: L(T minus t) is the weighted sum of the event
   flags, and the per-edge join penalties come from K2
   (``ops.insertion_cuda``) — the CUDA kernel on the card;
3. take the first minimum over the valid edges (added leaves and induced
   internals);
4. the slot-shift insert: the new internal node w takes the parent slot
   u of the chosen edge, internals [u, root] shift up one, and only w's
   ancestor path gets its up sets recomputed.

The tree's children array and the index arithmetic of the insert live on
the host (they are a few KB); the (n_all, L) up table lives on the device.
Each step reads back one (n_all,) score row — the only synchronisation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from trex_tpu_torch._device import resolve_device
from trex_tpu_torch.io import canonicalize_topology
from trex_tpu_torch.ops.fitch import batched_fitch_score, fitch_score
from trex_tpu_torch.ops.insertion_cuda import insertion_delta_cuda
from trex_tpu_torch.topology import Topology, from_numpy, parents_from_children

_SITE_CHUNKS = 16  # sites are padded to a multiple of this (score-neutral)
_FLAG_SHIFT = 30  # event-flag bit in internal up-set rows (needs Q <= 30)
_SMASK = (1 << _FLAG_SHIFT) - 1
_FLAG = 1 << _FLAG_SHIFT


@dataclasses.dataclass
class _StepwiseState:
    """The growing tree under the slot-shift numbering.

    Before step k: induced internals occupy n..n+k-2 (root n+k-2), parked
    chain internals n+k-1..2n-2 bottom-up, chain bottom n+k-1 holding
    (induced root, order[k]).
    """

    children: np.ndarray  # (n_anc, 2) int32, host
    added: np.ndarray  # (n_leaves,) bool, host
    up: torch.Tensor  # (n_all, L) int32 flagged up sets, device
    masks: torch.Tensor  # (n_leaves, L) int32 padded leaf masks, device
    weights: torch.Tensor  # (L,) f32 padded site weights, device
    order: list[int]

    @property
    def n_leaves(self) -> int:
        return self.masks.shape[0]


def _merge_flagged(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fitch merge of two up rows, with the event flag in bit 30."""
    a = a & _SMASK
    b = b & _SMASK
    inter = a & b
    return torch.where(inter == 0, (a | b) | _FLAG, inter)


def _initial_up(children: np.ndarray, scored: torch.Tensor) -> torch.Tensor:
    """(n_all, L) flagged Fitch up sets of the full padded seed tree.

    Internal rows carry ``merged_set | (event << 30)``; leaf rows the raw
    masks. Run once per construction; every insertion then updates it.
    """
    n_leaves, length = scored.shape
    up = torch.zeros(
        (2 * n_leaves - 1, length), dtype=torch.int32, device=scored.device
    )
    up[:n_leaves] = scored
    for a, (c0, c1) in enumerate(children.tolist()):
        up[n_leaves + a] = _merge_flagged(up[c0], up[c1])
    return up


def _seed_state(
    masks: np.ndarray,
    order: list[int],
    full_mask: int,
    site_weights,
    device: torch.device,
) -> _StepwiseState:
    """Seed tree (slot-shift scheme): internal n = (t0, t1), induced root
    n+1 = (n, t2), then the parked chain n+2..2n-2 in addition order."""
    n_leaves, length = masks.shape
    weights = (
        np.ones((length,), np.float32)
        if site_weights is None
        else np.asarray(site_weights, np.float32)
    )
    # Pad sites to a _SITE_CHUNKS multiple: full-mask columns (zero Fitch
    # events under any tree) with weight 0.
    pad = -length % _SITE_CHUNKS
    if pad:
        masks = np.concatenate(
            [masks, np.full((n_leaves, pad), full_mask, masks.dtype)], axis=1
        )
        weights = np.concatenate([weights, np.zeros(pad, np.float32)])
    t0, t1, t2 = order[:3]
    children = np.empty((n_leaves - 1, 2), np.int32)
    children[0] = sorted((t0, t1))
    children[1] = sorted((n_leaves, t2))
    prev = n_leaves + 1
    for j, t in enumerate(order[3:]):
        children[2 + j] = sorted((prev, t))
        prev = n_leaves + 2 + j
    scored = np.full_like(masks, full_mask)
    scored[order[:3]] = masks[order[:3]]
    added = np.zeros((n_leaves,), bool)
    added[order[:3]] = True
    return _StepwiseState(
        children=children,
        added=added,
        up=_initial_up(children, torch.as_tensor(scored, device=device)),
        masks=torch.as_tensor(masks, device=device),
        weights=torch.as_tensor(weights, device=device),
        order=order,
    )


def _insertion_inputs(st: _StepwiseState, k: int):
    """K2's inputs at step k: (pruned variant children, the flagged up
    sets themselves — K2 masks the flag — and t). Marks t's leaf row with
    its real mask."""
    t = st.order[k]
    st.up[t] = st.masks[t]
    r = st.n_leaves + k - 2  # induced root; the chain bottom n+k-1 is t's parent
    var = st.children.copy()
    var[k - 1] = (r, r)
    var_dev = torch.as_tensor(var, device=st.up.device)
    return var_dev, st.up, t


def _insert(st: _StepwiseState, k: int) -> None:
    """One insertion step (order[k]) on ``st``, in place."""
    n = st.n_leaves
    n_all = 2 * n - 1
    n_anc = n - 1
    var, up_states, t = _insertion_inputs(st, k)
    c_node = n + k - 1  # chain bottom (t's parent)
    r = c_node - 1  # induced root
    delta = insertion_delta_cuda(var, up_states, t, st.weights)
    # L(T minus t) = flag-bit weighted sum (chain and dissolved rows carry
    # flag 0 by construction).
    flags = (st.up[n:] >> _FLAG_SHIFT).to(torch.float32)
    total = (flags * st.weights).sum()
    row = (total + delta).cpu().numpy()

    children = st.children
    node_idx = np.arange(n_all)
    added_full = np.concatenate([st.added, np.zeros((n_anc,), bool)])
    valid = np.where(node_idx < n, added_full, node_idx <= r)
    v = int(np.argmin(np.where(valid, row, np.inf)))
    row_node = n + np.arange(n_anc, dtype=np.int32)
    parents = np.zeros((n_all,), np.int32)
    parents[children[:, 0]] = row_node
    parents[children[:, 1]] = row_node
    u_old = int(parents[v])
    # Relabel shifted nodes, shift their rows up by one, drop w in.
    ch2 = children + ((children >= u_old) & (children <= r)).astype(np.int32)
    rows = np.arange(n_anc)
    src = np.where((row_node > u_old) & (row_node <= c_node), rows - 1, rows)
    new_children = ch2[src]
    new_children[row_node == u_old] = (min(v, t), max(v, t))
    # The (shifted) old parent still lists v as a child; w replaced it.
    fix_row = (row_node == u_old + 1) & (u_old <= r)
    new_children = np.where(
        fix_row[:, None] & (new_children == v), u_old, new_children
    )
    new_children = np.sort(new_children, axis=1).astype(np.int32)

    # Shift the internal up rows identically and drop w's set in (v's row
    # is below the shift range, so read it pre-shift).
    wset = _merge_flagged(st.up[v], st.masks[t])
    anc = st.up[n:]
    lo, hi = u_old - n, c_node - n
    if hi > lo:
        anc[lo + 1 : hi + 1] = anc[lo:hi].clone()
    anc[lo] = wset
    # Recompute w's ancestor path (the only stale sets), bottom-up, up to
    # the new induced root c_node.
    new_parents = np.zeros((n_all,), np.int32)
    new_parents[new_children[:, 0]] = row_node
    new_parents[new_children[:, 1]] = row_node
    new_parents[n_all - 1] = n_all  # sentinel above every index
    x = int(new_parents[u_old])
    while x <= c_node:
        a, b = new_children[x - n]
        st.up[x] = _merge_flagged(st.up[a], st.up[b])
        x = int(new_parents[x])
    st.children = new_children
    st.added[t] = True


@dataclasses.dataclass
class _GrowingTree:
    """Host-side induced tree over the added taxa: leaves are taxon ids,
    internal nodes negative labels; ``parent`` maps every node but the
    root, ``kids`` each internal label to its two children."""

    root: int
    parent: dict[int, int]
    kids: dict[int, list[int]]
    next_label: int = -1

    def edges(self) -> list[int]:
        """Child endpoints of every edge (the edge above each non-root node)."""
        return list(self.parent)

    def attach(self, taxon: int, edge_child: int | None) -> None:
        """Insert ``taxon`` on the edge above ``edge_child`` (None = above the root)."""
        w = self.next_label
        self.next_label -= 1
        if edge_child is None:
            self.kids[w] = [self.root, taxon]
            self.parent[self.root] = w
            self.parent[taxon] = w
            self.root = w
            return
        up = self.parent[edge_child]
        self.kids[up][self.kids[up].index(edge_child)] = w
        self.parent[w] = up
        self.kids[w] = [edge_child, taxon]
        self.parent[edge_child] = w
        self.parent[taxon] = w

    def copy(self) -> "_GrowingTree":
        return _GrowingTree(
            root=self.root,
            parent=dict(self.parent),
            kids={k: list(v) for k, v in self.kids.items()},
            next_label=self.next_label,
        )


def _insertion_candidates(
    tree: _GrowingTree, taxon: int, parked: list[int], n_leaves: int
) -> np.ndarray:
    """(P, n_anc, 2) children of ``tree`` with ``taxon`` on each edge
    (``tree.edges()`` order) and then above the induced root, the parked
    taxa chained above. Ancestors are numbered in post-order, children
    visited by minimum leaf descendant, so every child index is below its
    parent's. All insertions share one copy with each insertion laid over
    it (only the new node's ancestors change their minimum leaf)."""
    work = tree.copy()
    for t in parked:
        work.attach(t, None)
    kids, parent = work.kids, work.parent
    order, stack = [], [work.root]
    while stack:
        x = stack.pop()
        order.append(x)
        if x < 0:
            stack.extend(kids[x])
    min_leaf: dict[int, int] = {}
    for x in reversed(order):
        min_leaf[x] = x if x >= 0 else min(min_leaf[c] for c in kids[x])
    w = work.next_label
    points = tree.edges() + [tree.root]
    out = np.empty((len(points), n_leaves - 1, 2), dtype=np.int32)
    for i, point in enumerate(points):
        up = parent.get(point)
        on_path = set()
        y = up
        while y is not None:
            on_path.add(y)
            y = parent.get(y)
        w_min = min(min_leaf[point], taxon)

        def rank(c: int) -> int:
            if c >= 0:
                return c
            if c == w:
                return w_min
            return min(min_leaf[c], taxon) if c in on_path else min_leaf[c]

        def kids_of(node: int) -> list[int]:
            if node == w:
                return [point, taxon]
            if node == up:
                return [w if c == point else c for c in kids[node]]
            return kids[node]

        number: dict[int, int] = {}
        counter = n_leaves
        rows = out[i]
        pending: list[tuple[int, bool]] = [(w if up is None else work.root, False)]
        while pending:
            node, expanded = pending.pop()
            if node >= 0:
                continue
            if expanded:
                a, b = (c if c >= 0 else number[c] for c in kids_of(node))
                rows[counter - n_leaves] = (a, b) if a < b else (b, a)
                number[node] = counter
                counter += 1
            else:
                pending.append((node, True))
                pending.extend((k, False) for k in sorted(kids_of(node), key=rank, reverse=True))
    return out


def _stepwise_batched(
    masks: np.ndarray,
    n_states: int,
    order: list[int],
    site_weights,
    device: torch.device,
) -> tuple[Topology, float]:
    """The batched path: each step materializes the tree with the next
    taxon on every edge of the induced tree (and above its root) and
    scores the batch in one K1 call; the first minimum wins. Not-yet-added
    taxa are fully ambiguous leaves."""
    n_leaves = masks.shape[0]
    full_mask = np.int64((1 << n_states) - 1).astype(np.int32)
    alphabet = mask_alphabet(masks, n_states)
    weights = None if site_weights is None else torch.as_tensor(
        site_weights, dtype=torch.float32, device=device)
    all_masks = torch.as_tensor(masks, device=device)
    scored = torch.full_like(all_masks, int(full_mask))
    t0, t1, t2 = order[:3]
    tree = _GrowingTree(root=-1, parent={t0: -1, t1: -1}, kids={-1: [t0, t1]}, next_label=-2)
    tree.attach(t2, None)
    scored[order[:3]] = all_masks[order[:3]]
    # Three taxa: the cherry (t0, t1), numbered n, below the root n + 1.
    final = np.array([sorted((t0, t1)), [t2, n_leaves]], dtype=np.int32)
    for step in range(3, n_leaves):
        taxon = order[step]
        parked = order[step + 1:]
        scored[taxon] = all_masks[taxon]
        points: list[int | None] = tree.edges() + [None]
        candidates = _insertion_candidates(tree, taxon, parked, n_leaves)
        children = torch.as_tensor(candidates, device=device)
        scores = batched_fitch_score(
            Topology(children, children.new_zeros((len(points), 2 * n_leaves - 1))),
            scored, weights, sequences_are_masks=True, n_states=alphabet,
        )
        best = int(torch.argmin(scores))
        tree.attach(taxon, points[best])
        # The last step's winner is the grown tree (no taxon is parked).
        final = candidates[best].copy()
    topo = from_numpy(final, parents_from_children(final), device)
    score = float(fitch_score(topo, all_masks, weights, sequences_are_masks=True,
                              n_states=alphabet))
    return topo, score


def _stepwise_scan(
    masks: np.ndarray,
    order: list[int],
    full_mask: int,
    site_weights,
    device: torch.device,
) -> tuple[Topology, float]:
    """The insertion loop (one K2 launch per taxon after the first three);
    the result is canonicalized once at the end and rescored exactly."""
    st = _seed_state(masks, order, full_mask, site_weights, device)
    for k in range(3, st.n_leaves):
        _insert(st, k)
    canon, _ = canonicalize_topology(st.children)
    topo = from_numpy(canon, parents_from_children(canon), device)
    final = float(
        fitch_score(topo, st.masks, st.weights, sequences_are_masks=True,
                    n_states=mask_alphabet(masks, full_mask.bit_length()))
    )
    return topo, final


def mask_alphabet(masks: np.ndarray, n_states: int) -> int:
    """The alphabet K1 is handed for host ``masks``: ``n_states``, or one
    past the masks' highest set bit where that is higher (bit 31, the int32
    sign bit, gives 32), so the card reads every bit the CPU and the JAX
    package read."""
    used = int(np.bitwise_or.reduce(np.asarray(masks).astype(np.uint32), axis=None))
    return max(n_states, used.bit_length())


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def stepwise_addition(
    leaf_sequences,
    n_states: int,
    *,
    sequences_are_masks: bool = False,
    order: np.ndarray | None = None,
    seed: int | None = None,
    site_weights=None,
    use_scan: bool | None = None,
    device="cuda",
) -> tuple[Topology, float]:
    """Build a tree by greedy stepwise addition.

    Args:
        leaf_sequences: (n_leaves, L) integer states, or state-set bitmasks
            with ``sequences_are_masks=True``.
        n_states: alphabet size Q (<= 32; the scan path needs Q <= 30,
            since its event flag rides bit 30).
        order: explicit addition order (permutation of taxa); default is a
            random order from ``seed`` (or 0), numpy's
            ``default_rng(seed).permutation``.
        site_weights: optional (L,) weights (compressed patterns).
        use_scan: the scan path (K2 a step) or the batched path (K1 a
            step); default the scan path up to 30 states. Both are exact
            and their trees score alike, but equal-score insertions may
            break ties differently.
        device: where the kernels run (``cuda`` by default).

    Returns:
        (topology, score): the grown tree over all taxa, on ``device``,
        and its exact unit-cost parsimony score.
    """
    seqs = _host(leaf_sequences)
    n_leaves = seqs.shape[0]
    if n_leaves < 3:
        raise ValueError("stepwise addition needs at least 3 taxa")
    if n_states > 32:
        raise ValueError("stepwise addition scores unit-cost Fitch sets: at most 32 states")
    if use_scan is None:
        use_scan = n_states <= _FLAG_SHIFT
    if use_scan and n_states > _FLAG_SHIFT:
        raise ValueError("the scan path needs n_states <= 30 (its event flag rides bit 30)")
    masks = (
        seqs.astype(np.int32)
        if sequences_are_masks
        else (1 << seqs.astype(np.int32)).astype(np.int32)
    )
    if order is None:
        rng = np.random.default_rng(0 if seed is None else seed)
        order = rng.permutation(n_leaves)
    order = [int(t) for t in np.asarray(order)]
    if sorted(order) != list(range(n_leaves)):
        raise ValueError("order must be a permutation of all taxa")
    weights = None if site_weights is None else _host(site_weights)
    if not use_scan:
        return _stepwise_batched(masks, n_states, order, weights, resolve_device(device))
    return _stepwise_scan(masks, order, (1 << n_states) - 1, weights, resolve_device(device))


def stepwise_addition_multi(
    leaf_sequences,
    n_states: int,
    *,
    n_orders: int = 8,
    seed: int = 0,
    sequences_are_masks: bool = False,
    site_weights=None,
    device="cuda",
) -> tuple[Topology, float]:
    """Best of ``n_orders`` random-addition-sequence stepwise trees (the
    first order wins ties)."""
    rng = np.random.default_rng(seed)
    n_leaves = _host(leaf_sequences).shape[0]
    best_topo, best_score = None, np.inf
    for _ in range(n_orders):
        topo, score = stepwise_addition(
            leaf_sequences, n_states,
            sequences_are_masks=sequences_are_masks,
            order=rng.permutation(n_leaves), site_weights=site_weights,
            device=device,
        )
        if score < best_score:
            best_topo, best_score = topo, score
    return best_topo, float(best_score)
