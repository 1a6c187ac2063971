// trex_tpu native runtime: tree I/O and host-side search-move generation.
//
// The TPU owns the numerics (Sankoff DP, gradients); this library owns the
// irregular, pointer-chasing host work that XLA is bad at:
//   - Newick parsing/serialization into the engine's node-order contract
//     (leaves 0..n_leaves-1, ancestors above, root last, children always
//     below their parent — see trex_tpu/topology.py),
//   - batched coalescent sampling of random rooted binary topologies,
//   - NNI / SPR neighborhood enumeration with canonical relabeling, feeding
//     candidate-tree batches to the vmapped/Pallas scoring path.
//
// Exposed as a C ABI consumed via ctypes (trex_tpu/io/native.py). All
// topology buffers are int32: children has shape (n_anc, 2) flattened
// row-major, parents has shape (n_all,).

#include <algorithm>
#include <cctype>
#include <climits>
#include <cstdint>
#include <cstring>
#include <random>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

struct Tree {
  int n_leaves = 0;
  std::vector<int32_t> children;  // (n_anc, 2)
  std::vector<int32_t> parents;   // (n_all)
  int n_anc() const { return n_leaves - 1; }
  int n_all() const { return 2 * n_leaves - 1; }
};

// Renumber ancestors so every parent index exceeds its children's
// (post-order), keeping leaf indices fixed. Input: per-node child lists in
// *any* ancestor numbering; output: canonical children/parents arrays.
//
// The numbering is STRUCTURE-DETERMINED (independent of child-list order):
// the traversal visits each node's children ordered by their minimum leaf
// descendant, so two structurally identical trees always canonicalize to
// identical arrays — required for neighborhood dedup and tree equality.
Tree canonicalize(int n_leaves, const std::vector<std::vector<int32_t>>& kids,
                  int root, std::vector<int32_t>* relabel_out = nullptr) {
  const int n_all = 2 * n_leaves - 1;
  // Min leaf descendant per node (iterative post-order).
  std::vector<int32_t> minleaf(kids.size(), -1);
  {
    std::vector<std::pair<int32_t, bool>> st = {{root, false}};
    while (!st.empty()) {
      auto [node, processed] = st.back();
      st.pop_back();
      if (kids[node].empty()) {
        minleaf[node] = node;  // leaf
      } else if (!processed) {
        st.push_back({node, true});
        for (int32_t c : kids[node]) st.push_back({c, false});
      } else {
        int32_t m = INT32_MAX;
        for (int32_t c : kids[node]) m = std::min(m, minleaf[c]);
        minleaf[node] = m;
      }
    }
  }
  std::vector<int32_t> relabel(n_all, -1);
  for (int i = 0; i < n_leaves; ++i) relabel[i] = i;
  int next_id = n_leaves;
  // Preorder visiting the larger-minleaf child first, so in the reversed
  // order the smaller-minleaf subtree is numbered first (DFS order; leaf
  // print order is preserved on newick round trips). Note this canonical
  // numbering is deterministic but generally differs from the balanced
  // constructor's breadth-style numbering for >= 8 leaves.
  std::vector<int32_t> stack = {root};
  std::vector<int32_t> order;
  order.reserve(n_all);
  while (!stack.empty()) {
    int32_t node = stack.back();
    stack.pop_back();
    order.push_back(node);
    std::vector<int32_t> cs = kids[node];
    std::sort(cs.begin(), cs.end(), [&](int32_t a, int32_t b) {
      return minleaf[a] < minleaf[b];  // smaller pushed first -> popped last
    });
    for (int32_t c : cs) stack.push_back(c);
  }
  // Reverse of a preorder (parent-before-child) visits children first.
  for (auto it = order.rbegin(); it != order.rend(); ++it) {
    if (!kids[*it].empty()) {
      if (relabel[*it] == -1) relabel[*it] = next_id++;
    }
  }
  Tree out;
  out.n_leaves = n_leaves;
  out.children.assign(2 * (n_leaves - 1), -1);
  out.parents.assign(n_all, -1);
  for (int node = 0; node < n_all; ++node) {
    if (kids[node].empty()) continue;
    int32_t p = relabel[node];
    int32_t a = p - n_leaves;
    int32_t c0 = relabel[kids[node][0]];
    int32_t c1 = relabel[kids[node][1]];
    if (c0 > c1) std::swap(c0, c1);
    out.children[2 * a] = c0;
    out.children[2 * a + 1] = c1;
    out.parents[c0] = p;
    out.parents[c1] = p;
  }
  out.parents[n_all - 1] = n_all - 1;
  if (relabel_out) *relabel_out = relabel;
  return out;
}

// Child lists (indexed by node id) from canonical children array.
std::vector<std::vector<int32_t>> child_lists(const int32_t* children,
                                              int n_leaves) {
  const int n_all = 2 * n_leaves - 1;
  std::vector<std::vector<int32_t>> kids(n_all);
  for (int a = 0; a < n_leaves - 1; ++a) {
    kids[n_leaves + a] = {children[2 * a], children[2 * a + 1]};
  }
  return kids;
}

// Allocation-free canonicalization over flat parent arrays (hot path for
// neighborhood enumeration). Same numbering as canonicalize(): ancestors in
// reversed min-leaf-ordered preorder. All scratch buffers are caller-owned
// and n_all-sized; kids_flat is (n_all, 2) with -1 for leaves.
struct CanonScratch {
  std::vector<int32_t> kids;      // (n_all * 2)
  std::vector<int32_t> minleaf;   // (n_all)
  std::vector<int32_t> stack;     // (n_all)
  std::vector<int32_t> order;     // (n_all)
  std::vector<int32_t> relabel;   // (n_all)
  void resize(int n_all) {
    kids.assign(n_all * 2, -1);
    minleaf.resize(n_all);
    stack.resize(2 * n_all + 4);  // post-order pass stores revisit markers
    order.resize(n_all);
    relabel.resize(n_all);
  }
};

inline void canonicalize_flat(int n_leaves, const int32_t* parent, int root,
                              CanonScratch& s, int32_t* children_out,
                              int32_t* parents_out) {
  const int n_all = 2 * n_leaves - 1;
  std::fill(s.kids.begin(), s.kids.end(), -1);
  for (int node = 0; node < n_all; ++node) {
    int32_t p = parent[node];
    if (p == node) continue;
    if (s.kids[2 * p] < 0)
      s.kids[2 * p] = node;
    else
      s.kids[2 * p + 1] = node;
  }
  // Preorder (children pushed smaller-minleaf first after minleaf pass).
  // First pass: compute minleaf with an explicit post-order stack encoded
  // by sign bit (second visit = node + n_all).
  {
    int top = 0;
    s.stack[top++] = root;
    while (top > 0) {
      int32_t node = s.stack[--top];
      if (node >= n_all) {  // second visit
        node -= n_all;
        s.minleaf[node] =
            std::min(s.minleaf[s.kids[2 * node]], s.minleaf[s.kids[2 * node + 1]]);
        continue;
      }
      if (s.kids[2 * node] < 0) {
        s.minleaf[node] = node;
        continue;
      }
      s.stack[top++] = node + n_all;
      s.stack[top++] = s.kids[2 * node];
      s.stack[top++] = s.kids[2 * node + 1];
    }
  }
  // NOTE: post-order stack depth can reach ~2*n_all; size generously.
  {
    int top = 0;
    int n_order = 0;
    s.stack[top++] = root;
    while (top > 0) {
      int32_t node = s.stack[--top];
      s.order[n_order++] = node;
      int32_t a = s.kids[2 * node];
      if (a < 0) continue;
      int32_t b = s.kids[2 * node + 1];
      // Push smaller-minleaf first so larger pops first (visited earlier);
      // reversed order then numbers smaller-minleaf subtrees first.
      if (s.minleaf[a] > s.minleaf[b]) std::swap(a, b);
      s.stack[top++] = a;
      s.stack[top++] = b;
    }
    int next_id = n_leaves;
    for (int i = 0; i < n_leaves; ++i) s.relabel[i] = i;
    for (int i = n_order - 1; i >= 0; --i) {
      int32_t node = s.order[i];
      if (s.kids[2 * node] >= 0) s.relabel[node] = next_id++;
    }
  }
  for (int node = 0; node < n_all; ++node) {
    if (s.kids[2 * node] < 0) continue;
    int32_t p = s.relabel[node];
    int32_t a = p - n_leaves;
    int32_t c0 = s.relabel[s.kids[2 * node]];
    int32_t c1 = s.relabel[s.kids[2 * node + 1]];
    if (c0 > c1) std::swap(c0, c1);
    children_out[2 * a] = c0;
    children_out[2 * a + 1] = c1;
    parents_out[c0] = p;
    parents_out[c1] = p;
  }
  parents_out[n_all - 1] = n_all - 1;
}

// Post-validation TBR body shared by trex_tbr and trex_tbr_neighborhood:
// applies the move on value copies of (kids, parent) and canonicalizes into
// `out`. Caller guarantees prune != root, reroot inside the pruned subtree,
// regraft outside it, and (when reroot == prune, the SPR degenerate) regraft
// not at the no-op positions {sibling, parent(prune)}.
int tbr_apply(int n_leaves, std::vector<std::vector<int32_t>> kids,
              std::vector<int32_t> parent, int32_t prune_node,
              int32_t reroot_node, int32_t regraft_node, Tree* out) {
  const int n_all = 2 * n_leaves - 1;
  int32_t p = parent[prune_node];
  int32_t sibling = kids[p][0] == prune_node ? kids[p][1] : kids[p][0];
  bool plain_spr = (reroot_node == prune_node);

  // Splice p out of the remainder (sibling takes its place).
  int32_t gp = parent[p];
  if (gp != p) {
    for (auto& k : kids[gp])
      if (k == p) k = sibling;
    parent[sibling] = gp;
  } else {
    parent[sibling] = sibling;  // sibling becomes the remainder's root
  }

  // Re-root the pruned subtree at the edge above reroot_node (see trex_tbr).
  int32_t sub_root;
  if (plain_spr) {
    sub_root = prune_node;
  } else {
    std::vector<int32_t> path;  // reroot_node ... prune_node
    for (int32_t n = reroot_node;; n = parent[n]) {
      path.push_back(n);
      if (n == prune_node) break;
    }
    int32_t reversed = -1;
    for (size_t i = path.size(); i-- > 1;) {
      int32_t node = path[i];
      int32_t path_child = path[i - 1];
      if (node == prune_node) {
        reversed = kids[node][0] == path_child ? kids[node][1] : kids[node][0];
        kids[node].clear();  // smoothed out of the tree
      } else {
        int32_t keep =
            kids[node][0] == path_child ? kids[node][1] : kids[node][0];
        kids[node] = {keep, reversed};
        reversed = node;
      }
    }
    kids[prune_node] = {reroot_node, reversed};
    sub_root = prune_node;
  }

  // Regraft sub_root onto the edge above regraft_node, reusing p.
  int32_t rp = parent[regraft_node];
  if (rp == regraft_node) {
    kids[p] = {sub_root, regraft_node};
    parent[p] = p;
  } else {
    for (auto& k : kids[rp])
      if (k == regraft_node) k = p;
    kids[p] = {sub_root, regraft_node};
    parent[p] = rp;
  }
  parent[sub_root] = p;
  parent[regraft_node] = p;

  // Find root and validate binary shape before canonicalizing.
  int32_t root = -1;
  int internal = 0;
  for (int node = 0; node < n_all; ++node) {
    if (!kids[node].empty() && kids[node].size() != 2) return -1;
    if (!kids[node].empty()) ++internal;
  }
  {
    std::vector<bool> is_child(n_all, false);
    for (int node = 0; node < n_all; ++node)
      for (int32_t c : kids[node]) is_child[c] = true;
    for (int node = 0; node < n_all; ++node)
      if (!kids[node].empty() && !is_child[node]) {
        if (root != -1) return -1;
        root = node;
      }
  }
  if (root < 0 || internal != n_leaves - 1) return -1;
  *out = canonicalize(n_leaves, kids, root);
  return 0;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Newick parsing.
//
// Supports rooted binary newick with optional labels and branch lengths,
// e.g. "((A:0.1,B:0.2):0.3,(C,D));". Leaves are numbered in order of
// appearance. Returns 0 on success, negative error codes otherwise:
//   -1 malformed input, -2 non-binary node, -3 buffer too small.
// names_out receives the leaf labels joined by '\n' (may be empty labels).
int trex_parse_newick(const char* s, int32_t* children_out,
                      int32_t* parents_out, double* branch_lengths_out,
                      char* names_out, int names_cap, int32_t* n_leaves_out) {
  if (!s) return -1;
  const std::string str(s);
  size_t pos = 0;
  struct Node {
    std::vector<int> kids;
    std::string label;
    double blen = 0.0;
    bool is_leaf = false;
  };
  std::vector<Node> nodes;

  // Recursive-descent parse.
  struct Parser {
    const std::string& str;
    size_t& pos;
    std::vector<Node>& nodes;
    bool failed = false;

    void skip_ws() {
      while (pos < str.size() && isspace((unsigned char)str[pos])) ++pos;
    }

    int parse_clade() {  // returns node index or -1
      skip_ws();
      if (failed || pos >= str.size()) return fail();
      int idx;
      if (str[pos] == '(') {
        ++pos;
        nodes.push_back(Node{});
        idx = (int)nodes.size() - 1;
        while (true) {
          int child = parse_clade();
          if (child < 0) return -1;
          nodes[idx].kids.push_back(child);
          skip_ws();
          if (pos < str.size() && str[pos] == ',') {
            ++pos;
            continue;
          }
          break;
        }
        skip_ws();
        if (pos >= str.size() || str[pos] != ')') return fail();
        ++pos;
      } else {
        nodes.push_back(Node{});
        idx = (int)nodes.size() - 1;
        nodes[idx].is_leaf = true;
      }
      // Optional label.
      size_t start = pos;
      while (pos < str.size() && str[pos] != ':' && str[pos] != ',' &&
             str[pos] != ')' && str[pos] != ';' && str[pos] != '(' &&
             !isspace((unsigned char)str[pos]))
        ++pos;
      nodes[idx].label = str.substr(start, pos - start);
      // Optional branch length.
      skip_ws();
      if (pos < str.size() && str[pos] == ':') {
        ++pos;
        size_t bstart = pos;
        while (pos < str.size() &&
               (isdigit((unsigned char)str[pos]) || str[pos] == '.' ||
                str[pos] == '-' || str[pos] == '+' || str[pos] == 'e' ||
                str[pos] == 'E'))
          ++pos;
        try {
          nodes[idx].blen = std::stod(str.substr(bstart, pos - bstart));
        } catch (...) {
          return fail();
        }
      }
      return idx;
    }
    int fail() {
      failed = true;
      return -1;
    }
  } parser{str, pos, nodes};

  int root = parser.parse_clade();
  if (root < 0 || parser.failed) return -1;

  // Count leaves; check binary internals.
  int n_leaves = 0;
  for (auto& n : nodes) {
    if (n.is_leaf)
      ++n_leaves;
    else if (n.kids.size() != 2)
      return -2;
  }
  if (n_leaves < 2) return -1;
  const int n_all = 2 * n_leaves - 1;
  if ((int)nodes.size() != n_all) return -2;

  // Engine ids: leaves in order of appearance; internals canonicalized.
  std::vector<int32_t> engine_id(nodes.size(), -1);
  std::vector<std::string> leaf_names;
  int leaf_ctr = 0;
  for (size_t i = 0; i < nodes.size(); ++i) {
    if (nodes[i].is_leaf) {
      engine_id[i] = leaf_ctr++;
      leaf_names.push_back(nodes[i].label);
    }
  }
  // Temporary (non-canonical) internal numbering.
  int tmp = n_leaves;
  for (size_t i = 0; i < nodes.size(); ++i)
    if (!nodes[i].is_leaf) engine_id[i] = tmp++;

  std::vector<std::vector<int32_t>> kids(n_all);
  std::vector<double> blen_by_parse(nodes.size());
  for (size_t i = 0; i < nodes.size(); ++i) {
    blen_by_parse[i] = nodes[i].blen;
    for (int c : nodes[i].kids) kids[engine_id[i]].push_back(engine_id[c]);
  }
  std::vector<int32_t> canon_of_tmp;
  Tree t = canonicalize(n_leaves, kids, engine_id[root], &canon_of_tmp);
  std::memcpy(children_out, t.children.data(),
              t.children.size() * sizeof(int32_t));
  std::memcpy(parents_out, t.parents.data(),
              t.parents.size() * sizeof(int32_t));

  if (branch_lengths_out) {
    // Branch lengths indexed by canonical child node id; canonicalize()
    // returned the tmp->canonical relabeling.
    for (int i = 0; i < n_all; ++i) branch_lengths_out[i] = 0.0;
    for (size_t i = 0; i < nodes.size(); ++i)
      branch_lengths_out[canon_of_tmp[engine_id[i]]] = blen_by_parse[i];
  }

  if (names_out && names_cap > 0) {
    std::string joined;
    for (size_t i = 0; i < leaf_names.size(); ++i) {
      if (i) joined += '\n';
      joined += leaf_names[i];
    }
    if ((int)joined.size() + 1 > names_cap) return -3;
    std::memcpy(names_out, joined.c_str(), joined.size() + 1);
  }
  *n_leaves_out = n_leaves;
  return 0;
}

// Serialize a canonical topology to newick. Leaf i is named names[i] (a
// '\n'-joined buffer; nullptr -> "L<i>"). Returns bytes written (excluding
// NUL) or -3 if the buffer is too small.
int trex_write_newick(const int32_t* children, int n_leaves, const char* names,
                      char* out, int out_cap) {
  std::vector<std::string> labels;
  if (names) {
    std::string buf(names);
    size_t start = 0;
    while (true) {
      size_t nl = buf.find('\n', start);
      labels.push_back(buf.substr(start, nl - start));
      if (nl == std::string::npos) break;
      start = nl + 1;
    }
  }
  auto name_of = [&](int i) {
    if (i < (int)labels.size()) return labels[i];
    return std::string("L") + std::to_string(i);
  };
  const int n_all = 2 * n_leaves - 1;
  // Build strings bottom-up: ancestors in index order see children done.
  std::vector<std::string> repr(n_all);
  for (int i = 0; i < n_leaves; ++i) repr[i] = name_of(i);
  for (int a = 0; a < n_leaves - 1; ++a) {
    repr[n_leaves + a] = "(" + repr[children[2 * a]] + "," +
                         repr[children[2 * a + 1]] + ")";
  }
  std::string result = repr[n_all - 1] + ";";
  if ((int)result.size() + 1 > out_cap) return -3;
  std::memcpy(out, result.c_str(), result.size() + 1);
  return (int)result.size();
}

// Batched coalescent sampling of random rooted binary topologies.
// Output is CANONICAL: the coalescent numbering is structurally valid
// (children < parent) but not the structure-determined canonical numbering
// the move generators emit, so without re-canonicalizing the same topology
// could carry two byte identities (breaking dedup/equality by children
// bytes — e.g. closure counts, vote splitting in candidate dedup).
void trex_sample_topologies(uint64_t seed, int n_leaves, int batch,
                            int32_t* children_out, int32_t* parents_out) {
  std::mt19937_64 rng(seed);
  const int n_anc = n_leaves - 1;
  const int n_all = 2 * n_leaves - 1;
  std::vector<int32_t> active;
  std::vector<int32_t> raw_parents(n_all);
  CanonScratch scratch;
  scratch.resize(n_all);
  for (int b = 0; b < batch; ++b) {
    int32_t* children = children_out + (size_t)b * n_anc * 2;
    int32_t* parents = parents_out + (size_t)b * n_all;
    active.resize(n_leaves);
    for (int i = 0; i < n_leaves; ++i) active[i] = i;
    for (int a = 0; a < n_anc; ++a) {
      std::uniform_int_distribution<int> d1(0, (int)active.size() - 1);
      int i = d1(rng);
      std::swap(active[i], active.back());
      int32_t c1 = active.back();
      active.pop_back();
      std::uniform_int_distribution<int> d2(0, (int)active.size() - 1);
      int j = d2(rng);
      std::swap(active[j], active.back());
      int32_t c2 = active.back();
      active.pop_back();
      int32_t node = n_leaves + a;
      raw_parents[c1] = node;
      raw_parents[c2] = node;
      active.push_back(node);
    }
    raw_parents[n_all - 1] = n_all - 1;
    canonicalize_flat(n_leaves, raw_parents.data(), n_all - 1, scratch,
                      children, parents);
  }
}

// Number of NNI neighbors of a canonical topology: 2 per internal edge
// (edge from an ancestor to an ancestor child, root excluded as child).
int trex_nni_count(const int32_t* children, int n_leaves) {
  int count = 0;
  for (int a = 0; a < n_leaves - 1; ++a) {
    if (children[2 * a] >= n_leaves) count += 2;
    if (children[2 * a + 1] >= n_leaves) count += 2;
  }
  return count;
}

// Enumerate all NNI neighbors; children_out has shape (count, n_anc, 2) and
// parents_out (count, n_all), canonical numbering. Returns the count.
int trex_nni_neighbors(const int32_t* children, int n_leaves,
                       int32_t* children_out, int32_t* parents_out) {
  const int n_anc = n_leaves - 1;
  const int n_all = 2 * n_leaves - 1;
  auto kids0 = child_lists(children, n_leaves);
  int written = 0;
  for (int a = 0; a < n_anc; ++a) {
    int32_t p = n_leaves + a;
    for (int ci = 0; ci < 2; ++ci) {
      int32_t c = kids0[p][ci];
      if (c < n_leaves) continue;  // need an internal child
      int32_t sibling = kids0[p][1 - ci];
      for (int gi = 0; gi < 2; ++gi) {
        // Swap sibling with grandchild gi of c.
        auto kids = kids0;
        int32_t grand = kids[c][gi];
        kids[p][1 - ci] = grand;
        kids[c][gi] = sibling;
        Tree t = canonicalize(n_leaves, kids, n_all - 1);
        std::memcpy(children_out + (size_t)written * n_anc * 2,
                    t.children.data(), t.children.size() * sizeof(int32_t));
        std::memcpy(parents_out + (size_t)written * n_all, t.parents.data(),
                    t.parents.size() * sizeof(int32_t));
        ++written;
      }
    }
  }
  return written;
}

// SPR: prune the subtree rooted at `prune_node` (any non-root node) and
// regraft onto the edge above `regraft_node`. Returns 0 on success, -1 if
// the move is invalid (regraft inside the pruned subtree, regraft at the
// pruned node's sibling edge = no-op, or prune at root).
int trex_spr(const int32_t* children, int n_leaves, int32_t prune_node,
             int32_t regraft_node, int32_t* children_out,
             int32_t* parents_out) {
  const int n_all = 2 * n_leaves - 1;
  if (prune_node >= n_all - 1 || regraft_node >= n_all - 1) return -1;
  auto kids = child_lists(children, n_leaves);
  std::vector<int32_t> parent(n_all, -1);
  for (int node = 0; node < n_all; ++node)
    for (int32_t c : kids[node]) parent[c] = node;
  parent[n_all - 1] = n_all - 1;

  // Reject regrafting inside the pruned subtree (would disconnect).
  for (int32_t x = regraft_node;; x = parent[x]) {
    if (x == prune_node) return -1;
    if (x == parent[x]) break;
  }
  int32_t p = parent[prune_node];
  int32_t sibling = kids[p][0] == prune_node ? kids[p][1] : kids[p][0];
  if (regraft_node == sibling || regraft_node == p) return -1;  // no-op
  int32_t gp = parent[p];
  if (gp == p) {
    // p is the root: pruning one of the root's children makes the sibling
    // the new root; p is reused as the regraft junction below.
    // Handled uniformly by splicing p out, then re-rooting at sibling.
  }
  // Splice p out: sibling takes p's place under gp.
  if (gp != p) {
    for (auto& k : kids[gp])
      if (k == p) k = sibling;
    parent[sibling] = gp;
  } else {
    parent[sibling] = sibling;  // sibling becomes root
  }
  // Re-insert p on the edge above regraft_node.
  int32_t rp = parent[regraft_node];
  if (rp == regraft_node) {
    // Regrafting above the (possibly new) root: p becomes the new root.
    kids[p] = {prune_node, regraft_node};
    parent[regraft_node] = p;
    parent[p] = p;
  } else {
    for (auto& k : kids[rp])
      if (k == regraft_node) k = p;
    kids[p] = {prune_node, regraft_node};
    parent[regraft_node] = p;
    parent[p] = rp;
  }
  // Find root.
  int32_t root = -1;
  for (int node = 0; node < n_all; ++node)
    if (parent[node] == node) root = node;
  if (root < 0) return -1;
  Tree t = canonicalize(n_leaves, kids, root);
  std::memcpy(children_out, t.children.data(),
              t.children.size() * sizeof(int32_t));
  std::memcpy(parents_out, t.parents.data(),
              t.parents.size() * sizeof(int32_t));
  return 0;
}

// Enumerate the full SPR neighborhood in one call: every valid
// (prune, regraft) pair, canonicalized and deduplicated (and excluding the
// identity tree). Writes at most `max_out` trees and returns the count
// (truncating once full — callers wanting the complete neighborhood of an
// n-leaf tree should pass ~4*n^2). Allocation-free per move (flat parent
// arrays + shared scratch) — one native call replaces O(n^2) per-move FFI
// roundtrips, the host-side bottleneck of large searches.
int trex_spr_neighborhood(const int32_t* children, int n_leaves,
                          int32_t* children_out, int32_t* parents_out,
                          int max_out) {
  const int n_anc = n_leaves - 1;
  const int n_all = 2 * n_leaves - 1;
  // Base parent array and child lists (flat).
  std::vector<int32_t> parent(n_all);
  std::vector<int32_t> kids(n_all * 2, -1);
  for (int a = 0; a < n_anc; ++a) {
    int32_t node = n_leaves + a;
    kids[2 * node] = children[2 * a];
    kids[2 * node + 1] = children[2 * a + 1];
    parent[children[2 * a]] = node;
    parent[children[2 * a + 1]] = node;
  }
  parent[n_all - 1] = n_all - 1;

  struct VecHash {
    size_t operator()(const std::vector<int32_t>& v) const {
      size_t h = 1469598103934665603ull;
      for (int32_t x : v) {
        h ^= (size_t)(uint32_t)x;
        h *= 1099511628211ull;
      }
      return h;
    }
  };
  std::unordered_set<std::vector<int32_t>, VecHash> seen;
  seen.insert(std::vector<int32_t>(children, children + n_anc * 2));

  CanonScratch scratch;
  scratch.resize(n_all);
  std::vector<int32_t> parent2(n_all);
  std::vector<bool> in_sub(n_all);
  std::vector<int32_t> dfs(n_all);
  std::vector<int32_t> key(n_anc * 2);
  std::vector<int32_t> par_buf(n_all);
  int written = 0;

  for (int prune = 0; prune < n_all - 1; ++prune) {
    // Mark the pruned subtree.
    std::fill(in_sub.begin(), in_sub.end(), false);
    int top = 0;
    dfs[top++] = prune;
    while (top > 0) {
      int32_t n = dfs[--top];
      in_sub[n] = true;
      if (kids[2 * n] >= 0) {
        dfs[top++] = kids[2 * n];
        dfs[top++] = kids[2 * n + 1];
      }
    }
    int32_t p = parent[prune];
    int32_t sibling =
        kids[2 * p] == prune ? kids[2 * p + 1] : kids[2 * p];
    for (int regraft = 0; regraft < n_all - 1; ++regraft) {
      if (in_sub[regraft] || regraft == sibling || regraft == p) continue;
      std::memcpy(parent2.data(), parent.data(), n_all * sizeof(int32_t));
      int32_t root;
      if (p == n_all - 1) {
        parent2[sibling] = sibling;
        root = sibling;
      } else {
        parent2[sibling] = parent[p];
        root = n_all - 1;
      }
      parent2[p] = parent[regraft] == p ? p : parent[regraft];
      if (parent[regraft] == regraft) {  // cannot happen (regraft != root)
        continue;
      }
      parent2[regraft] = p;
      parent2[prune] = p;
      if (root == sibling) {
        // p re-inserted below the new root; fix p's parent if it pointed at
        // the old (removed) position of itself.
        if (parent2[p] == p) parent2[p] = parent[regraft];
      }
      canonicalize_flat(n_leaves, parent2.data(), root, scratch,
                        key.data(), par_buf.data());
      std::vector<int32_t> k(key);
      if (!seen.insert(std::move(k)).second) continue;
      if (written >= max_out) return written;
      std::memcpy(children_out + (size_t)written * n_anc * 2, key.data(),
                  key.size() * sizeof(int32_t));
      std::memcpy(parents_out + (size_t)written * n_all, par_buf.data(),
                  n_all * sizeof(int32_t));
      ++written;
    }
  }
  return written;
}

// TBR: prune the subtree above `prune_node`, re-root it on the edge above
// `reroot_node` (a node strictly inside the pruned subtree), and regraft the
// re-rooted subtree onto the edge above `regraft_node` in the remainder.
// With reroot_node == prune_node the move degenerates to SPR. Returns 0 on
// success, -1 if invalid (nodes out of range, reroot outside the subtree,
// regraft inside it, or a no-op).
int trex_tbr(const int32_t* children, int n_leaves, int32_t prune_node,
             int32_t reroot_node, int32_t regraft_node, int32_t* children_out,
             int32_t* parents_out) {
  const int n_all = 2 * n_leaves - 1;
  if (prune_node >= n_all - 1 || regraft_node >= n_all - 1 ||
      reroot_node >= n_all)
    return -1;
  auto kids = child_lists(children, n_leaves);
  std::vector<int32_t> parent(n_all, -1);
  for (int node = 0; node < n_all; ++node)
    for (int32_t c : kids[node]) parent[c] = node;
  parent[n_all - 1] = n_all - 1;

  // Membership of the pruned subtree.
  std::vector<bool> in_sub(n_all, false);
  {
    std::vector<int32_t> st = {prune_node};
    while (!st.empty()) {
      int32_t n = st.back();
      st.pop_back();
      in_sub[n] = true;
      for (int32_t c : kids[n]) st.push_back(c);
    }
  }
  if (!in_sub[reroot_node]) return -1;
  if (in_sub[regraft_node]) return -1;

  int32_t p = parent[prune_node];
  int32_t sibling = kids[p][0] == prune_node ? kids[p][1] : kids[p][0];
  bool plain_spr = (reroot_node == prune_node);
  // The junction p is spliced out of the remainder before regrafting, so
  // the "edge above p" never exists as a target — for ANY reroot choice
  // (regrafting there used to corrupt the child lists: p became its own
  // child and canonicalize indexed unvisited nodes).
  if (regraft_node == p) return -1;
  if (plain_spr && regraft_node == sibling) return -1;

  Tree t;
  if (tbr_apply(n_leaves, std::move(kids), std::move(parent), prune_node,
                reroot_node, regraft_node, &t) != 0)
    return -1;
  std::memcpy(children_out, t.children.data(),
              t.children.size() * sizeof(int32_t));
  std::memcpy(parents_out, t.parents.data(),
              t.parents.size() * sizeof(int32_t));
  return 0;
}

// Enumerate the TBR neighborhood: every valid (prune, reroot, regraft)
// triple, canonicalized and deduplicated (identity excluded). SPR moves are
// included as the reroot == prune degenerate, so this is the full TBR set.
// The iteration order of prune and regraft nodes is shuffled by `seed`, so
// truncation at `max_out` yields an unbiased sample of the neighborhood
// rather than a low-index-biased prefix. Returns the number written.
int trex_tbr_neighborhood(const int32_t* children, int n_leaves,
                          uint64_t seed, int32_t* children_out,
                          int32_t* parents_out, int max_out) {
  const int n_anc = n_leaves - 1;
  const int n_all = 2 * n_leaves - 1;
  auto base_kids = child_lists(children, n_leaves);
  std::vector<int32_t> base_parent(n_all, -1);
  for (int node = 0; node < n_all; ++node)
    for (int32_t c : base_kids[node]) base_parent[c] = node;
  base_parent[n_all - 1] = n_all - 1;

  struct VecHash {
    size_t operator()(const std::vector<int32_t>& v) const {
      size_t h = 1469598103934665603ull;
      for (int32_t x : v) {
        h ^= (size_t)(uint32_t)x;
        h *= 1099511628211ull;
      }
      return h;
    }
  };
  std::unordered_set<std::vector<int32_t>, VecHash> seen;
  seen.insert(std::vector<int32_t>(children, children + n_anc * 2));

  std::mt19937_64 rng(seed);
  std::vector<int32_t> prune_order(n_all - 1);
  for (int i = 0; i < n_all - 1; ++i) prune_order[i] = i;
  std::shuffle(prune_order.begin(), prune_order.end(), rng);
  std::vector<int32_t> node_order(n_all - 1);
  for (int i = 0; i < n_all - 1; ++i) node_order[i] = i;
  std::shuffle(node_order.begin(), node_order.end(), rng);

  std::vector<bool> in_sub(n_all);
  std::vector<int32_t> dfs(n_all);
  std::vector<int32_t> sub_nodes;
  int written = 0;
  for (int32_t prune : prune_order) {
    // Mark the pruned subtree and collect reroot candidates.
    std::fill(in_sub.begin(), in_sub.end(), false);
    sub_nodes.clear();
    int top = 0;
    dfs[top++] = prune;
    while (top > 0) {
      int32_t n = dfs[--top];
      in_sub[n] = true;
      sub_nodes.push_back(n);
      for (int32_t c : base_kids[n]) dfs[top++] = c;
    }
    int32_t p = base_parent[prune];
    int32_t sibling =
        base_kids[p][0] == prune ? base_kids[p][1] : base_kids[p][0];
    for (int32_t reroot : sub_nodes) {
      bool plain_spr = (reroot == prune);
      for (int32_t regraft : node_order) {
        if (in_sub[regraft] || regraft == p) continue;
        if (plain_spr && regraft == sibling) continue;
        Tree t;
        if (tbr_apply(n_leaves, base_kids, base_parent, prune, reroot,
                      regraft, &t) != 0)
          continue;
        if (!seen.insert(t.children).second) continue;
        if (written >= max_out) return written;
        std::memcpy(children_out + (size_t)written * n_anc * 2,
                    t.children.data(), t.children.size() * sizeof(int32_t));
        std::memcpy(parents_out + (size_t)written * n_all, t.parents.data(),
                    t.parents.size() * sizeof(int32_t));
        ++written;
      }
    }
  }
  return written;
}

}  // extern "C"
