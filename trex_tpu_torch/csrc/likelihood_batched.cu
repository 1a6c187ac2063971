// K3/K4 — Felsenstein pruning log-likelihood of B trees on one alignment,
// with exact power-of-two rescaling. For each tree, each ancestor a
// (children before parents) gets
//   combined = (P_c1 d_c1) * (P_c2 d_c2),
// then, per site, m = max over states, e = biased exponent of m, the
// partial is multiplied by the exact power of two 2^(127 - e) and e - 127 is
// added to an int32 exponent sum. The score is
//   sum over sites of w * (log(max(sum_i prior_i root_i, 1e-30)) + exp_sum * ln 2).
// P is one shared (Q, Q) matrix or one (Q, Q) matrix per branch
// ((B, n_all, Q, Q), the matrix of the branch above each node).
//
// Replaces: trex_tpu/ops/likelihood_pallas.py `_likelihood_kernel_lanes`
// (K3: shared P, trees in lanes, rescale every <= 4 steps) and
// `_likelihood_kernel_slots` (K4: shared or per-branch P, rescale every
// step), reached through `batched_log_likelihood_pallas` from the ML NNI
// climb's candidate ranking (trex_tpu/search/ml.py `ml_hill_climb`). Both
// compute this one function; power-of-two rescaling is exact away from
// underflow, so they differ only in the rounding of the final log. Their
// other layouts (nodes, mxu) are TPU scheduling variants of it. They kept
// every ancestor's partial in VMEM; this kernel keeps a few.
//
// What bounds it on this card: its inputs are small (the plan, the leaf
// table, P), so the floor is the arithmetic: about 2 * 2Q^2 multiply-adds
// for the two messages plus ~3Q for the combine, max and scale, per tree,
// ancestor and site. Its predecessor walked ancestors in index order and
// kept every ancestor's (Q, site) partial in a global scratch, written
// once and read once by the parent: bound by its own scratch traffic in
// DRAM (2 x B x n_anc x Q x L x 4 bytes, 34 GB at 512 taxa x 2048 sites, B
// = 1020: about 10 ms at 3.35 TB/s).
//
// What the design does about it: the walk follows the tree plan
// (csrc/tree_plan.cu), a post-order in which the live partials form a
// stack of at most floor(log2 n_leaves) slots, kept in shared memory. One
// thread per (tree, site) walks its tree's plan with no block
// synchronisation; all threads of a block share one tree, so each step
// (and, per branch, the step's child node ids and their P rows) is a
// uniform broadcast load, the step fetched two steps ahead and its leaf
// states one. Each thread keeps its slots in its own column of dynamic
// shared memory, float4s of four states laid out (slot, Q / 4, site),
// conflict free; a block owns 128 sites (the wrapper's launch plan sizes
// its shared memory). Under a shared P a leaf child's message is a
// row of a small table each block computes first with the same code as an
// ancestor child's (a leaf's partial depends only on its state), so about
// half of the messages cost Q loads instead of 2 Q^2 operations; under a
// per-branch P tip partials are computed from the leaf table. The root
// partial never leaves registers. P's rows are read 16 bytes at a time (a
// shared P from shared memory, a per-branch P from global memory). The
// per-step arithmetic and its order are the plain version's: messages as
// acc += p * d over j = 0..Q-1, the product, the max, the exact scale and
// the int32 exponent sum. The site sum is deterministic: each thread
// writes its weighted site value, and a second kernel adds a tree's sites
// in 128-site pairwise blocks, the blocks in index order — no float
// atomics, so a run reproduces itself bit for bit.
// - Q = 4 and Q = 20 (fixed kernels): Q is a template parameter, so the
//   state loops unroll into registers; one thread per site walks its
//   tree's plan with no block synchronisation.
// - Any other Q >= 2 (runtime-Q kernel, as K5's in sankoff_batched.cu):
//   one thread per (site, tile of 16 parent states), the tiles of a site
//   sharing its slot column, (slot, state, site). Each thread streams the
//   two child rows once for its tile (a shared P sits transposed in shared
//   memory, Pt[j][s], so one 16-byte load gives four parent states' entries
//   for one child state; a per-branch P is read a row entry at a time from
//   global memory, a uniform load for the warp). The site's maximum is the
//   maximum of its tiles' maxima, posted in shared memory, so the block
//   synchronises twice a step: every tile has read the children and posted
//   its maximum before any writes the new row (which may take a child's
//   slot), and the row is in place before the next step reads it. The
//   root's row goes to its slot like any other, and the site's first tile
//   adds prior_i root_i over i = 0..Q-1 in order. Under a shared P in state
//   mode a leaf child's message is a row of a table each block computes
//   first (a row per state, one for a missing state, one for a state >= Q).
//   Where even 32 sites' slot columns do not fit a block's shared memory
//   the same slot stack sits in a global buffer of slots x Q x L floats a
//   tree (the global-slot mode).

#include <cuda_runtime.h>

namespace {

constexpr int kSumThreads = 128;  // sites per pairwise block of the site sum
constexpr int kSites = 128;       // sites (threads) per block of the fixed kernels
constexpr int kTile = 16;         // parent states per thread of the runtime-Q kernel
constexpr int kMaxAnyThreads = 512;
constexpr float kLn2 = 0.6931471805599453f;

// Four entries of a row of P: a shared P from shared memory, a per-branch
// P from global memory. (Volatile 16-byte shared loads, as K5 takes for its
// cost matrix, made ptxas stage a whole 20 x 20 P in registers and spill.)
template <bool kShared>
__device__ __forceinline__ float4 p4(const float* p) {
  if (!kShared) return __ldg(reinterpret_cast<const float4*>(p));
  return *reinterpret_cast<const float4*>(p);
}

// Tip partial of a leaf whose state (or mask) at this site is `obs`: 1 at
// every allowed state.
template <int Q, bool kMasks>
__device__ __forceinline__ void tip_partial(int obs, float (&d)[Q]) {
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const bool allowed = kMasks ? ((obs >> i) & 1) != 0 : (obs == i || obs < 0);
    d[i] = allowed ? 1.0f : 0.0f;
  }
}

// Message P d of a child whose partial is d, through the (Q, Q) matrix at p.
template <int Q, bool kShared>
__device__ __forceinline__ void message(const float (&d)[Q], const float* p, float (&m)[Q]) {
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    float4 pv = p4<kShared>(p + i * Q);
    float acc = pv.x * d[0];
    acc += pv.y * d[1];
    acc += pv.z * d[2];
    acc += pv.w * d[3];
#pragma unroll
    for (int j = 4; j < Q; j += 4) {
      pv = p4<kShared>(p + i * Q + j);
      acc += pv.x * d[j];
      acc += pv.y * d[j + 1];
      acc += pv.z * d[j + 2];
      acc += pv.w * d[j + 3];
    }
    m[i] = acc;
  }
}

// A leaf's partial depends only on its state (or mask), so under a shared
// P its message is one of a few rows, tabulated per block by the same code
// that computes an ancestor child's: a code per state, one for a missing
// (negative) state and one for any state >= Q, or one per mask of Q bits
// (up to 8 states; no table above, nor for a per-branch P).
template <int Q, bool kShared, bool kMasks>
__host__ __device__ constexpr int leaf_codes() {
  return !kShared ? 0 : kMasks ? (Q <= 8 ? 1 << Q : 0) : Q + 2;
}

template <int Q, bool kMasks>
__device__ __forceinline__ int leaf_code(int obs) {
  if (kMasks) return obs & ((1 << Q) - 1);
  return obs < 0 ? Q : obs < Q ? obs : Q + 1;
}

// Messages P1 d1 and P2 d2 of two children, computed together (a shared P
// is loaded once for both).
template <int Q, bool kShared>
__device__ __forceinline__ void messages(const float (&d1)[Q], const float* p1,
                                         const float (&d2)[Q], const float* p2,
                                         float (&m1)[Q], float (&m2)[Q]) {
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    float4 a = p4<kShared>(p1 + i * Q);
    float4 b = p4<kShared>(p2 + i * Q);
    float acc1 = a.x * d1[0], acc2 = b.x * d2[0];
    acc1 += a.y * d1[1];
    acc2 += b.y * d2[1];
    acc1 += a.z * d1[2];
    acc2 += b.z * d2[2];
    acc1 += a.w * d1[3];
    acc2 += b.w * d2[3];
#pragma unroll
    for (int j = 4; j < Q; j += 4) {
      a = p4<kShared>(p1 + i * Q + j);
      b = p4<kShared>(p2 + i * Q + j);
      acc1 += a.x * d1[j];
      acc2 += b.x * d2[j];
      acc1 += a.y * d1[j + 1];
      acc2 += b.y * d2[j + 1];
      acc1 += a.z * d1[j + 2];
      acc2 += b.z * d2[j + 2];
      acc1 += a.w * d1[j + 3];
      acc2 += b.w * d2[j + 3];
    }
    m1[i] = acc1;
    m2[i] = acc2;
  }
}

// Partial d of plan source `src` at this thread's site: a leaf's tip
// partial from its state `obs`, an ancestor's from its slot in the column
// `col` (four states a float4, float4s kSites apart, slots Q / 4 * kSites).
template <int Q, bool kMasks>
__device__ __forceinline__ void partial(int src, int obs, const float* col, float (&d)[Q]) {
  if (src >= 0) {
    tip_partial<Q, kMasks>(obs, d);
  } else {
    const float4* row = reinterpret_cast<const float4*>(col) + ~src * (Q / 4 * kSites);
#pragma unroll
    for (int c = 0; c < Q / 4; ++c) {
      const float4 v = row[c * kSites];
      d[4 * c] = v.x;
      d[4 * c + 1] = v.y;
      d[4 * c + 2] = v.z;
      d[4 * c + 3] = v.w;
    }
  }
}

template <int Q>
__device__ __forceinline__ void table_row(const float* table, int code, float (&m)[Q]) {
  const float* row = table + code * Q;
#pragma unroll
  for (int i = 0; i < Q; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + i);
    m[i] = v.x;
    m[i + 1] = v.y;
    m[i + 2] = v.z;
    m[i + 3] = v.w;
  }
}

struct Step {
  int4 step;      // (v, src1, src2, dst)
  int2 nodes;     // v's children (per-branch P only)
  int obs1, obs2; // leaf states named by the step
};

// The children and leaf states of a step whose (v, src1, src2, dst) is
// loaded, the states from this site's column of the leaf table (n_leaves x
// L < 2^31, so 32-bit offsets).
template <bool kShared>
__device__ __forceinline__ Step with_leaves(int4 step, const int2* tree_children,
                                            const int* __restrict__ leaf_col, int length) {
  Step s;
  s.step = step;
  s.nodes = kShared ? make_int2(0, 0) : __ldg(tree_children + step.x);
  s.obs1 = step.y >= 0 ? __ldg(leaf_col + step.y * length) : 0;
  s.obs2 = step.z >= 0 ? __ldg(leaf_col + step.z * length) : 0;
  return s;
}

// Dynamic shared memory: a shared P (Q * Q floats, kShared only), the
// leaf-message table (leaf_codes x Q floats), then the slot columns, float4s
// of four states laid out (slot, Q / 4, kSites). One thread per site,
// kSites a block (a constant, so every slot access is an immediate offset
// from the thread's column).
// Steps are loaded two ahead and their leaf states one ahead.
template <int Q, bool kShared, bool kMasks>
__global__ void __launch_bounds__(kSites)
pruning_kernel(const int4* __restrict__ plan,      // (B, n_anc)
               const int2* __restrict__ children,  // (B, n_anc)
               const int* __restrict__ leaves,     // (n_leaves, L)
               const float* __restrict__ pmats,    // (Q, Q) or (B, n_all, Q, Q)
               const float* __restrict__ prior,    // (Q,)
               const float* __restrict__ weights,  // (L,)
               float* __restrict__ per_site,       // (B, L)
               int tree0, int n_leaves, int length) {
  extern __shared__ __align__(16) float smem[];
  const int tree = tree0 + blockIdx.y;
  const int site = blockIdx.x * kSites + threadIdx.x;
  const int n_anc = n_leaves - 1;
  const int n_all = 2 * n_leaves - 1;
  constexpr int kCodes = leaf_codes<Q, kShared, kMasks>();
  float* p_shared = smem;
  float* table = smem + (kShared ? Q * Q : 0);
  if (kShared) {
    for (int k = threadIdx.x; k < Q * Q; k += kSites) p_shared[k] = pmats[k];
    __syncthreads();
    for (int code = threadIdx.x; code < kCodes; code += kSites) {
      float d[Q], m[Q];
      tip_partial<Q, kMasks>(kMasks || code < Q ? code : code == Q ? -1 : Q, d);
      message<Q, kShared>(d, p_shared, m);
#pragma unroll
      for (int i = 0; i < Q; ++i) table[code * Q + i] = m[i];
    }
    __syncthreads();
  }
  if (site >= length) return;

  const int4* steps = plan + static_cast<size_t>(tree) * n_anc;
  const int2* tree_children = children + static_cast<size_t>(tree) * n_anc;
  const float* tree_p = pmats + static_cast<size_t>(tree) * n_all * Q * Q;
  float* col = table + kCodes * Q + 4 * threadIdx.x;
  const int* leaf_col = leaves + site;
  Step next = with_leaves<kShared>(__ldg(steps), tree_children, leaf_col, length);
  int4 after = n_anc > 1 ? __ldg(steps + 1) : next.step;
  int exp_sum = 0;
  float root[Q];
  for (int k = 0; k < n_anc; ++k) {
    const Step cur = next;
    if (k + 1 < n_anc) next = with_leaves<kShared>(after, tree_children, leaf_col, length);
    if (k + 2 < n_anc) after = __ldg(steps + k + 2);
    const int4 step = cur.step;
    const float* p1 = kShared ? p_shared : tree_p + cur.nodes.x * (Q * Q);
    const float* p2 = kShared ? p_shared : tree_p + cur.nodes.y * (Q * Q);
    const bool tab1 = kCodes > 0 && step.y >= 0, tab2 = kCodes > 0 && step.z >= 0;
    float m1[Q], m2[Q];
    if (Q <= 8) {
      // Each child's message on its own: a table row or a message, fewest
      // instructions where P sits in registers.
      float d[Q];
      if (tab1) {
        table_row<Q>(table, leaf_code<Q, kMasks>(cur.obs1), m1);
      } else {
        partial<Q, kMasks>(step.y, cur.obs1, col, d);
        message<Q, kShared>(d, p1, m1);
      }
      if (tab2) {
        table_row<Q>(table, leaf_code<Q, kMasks>(cur.obs2), m2);
      } else {
        partial<Q, kMasks>(step.z, cur.obs2, col, d);
        message<Q, kShared>(d, p2, m2);
      }
    } else if (tab1 || tab2) {
      // A leaf child's message from the table; two other children together
      // (a shared P loaded once for both).
      table_row<Q>(table, leaf_code<Q, kMasks>(tab1 ? cur.obs1 : cur.obs2), m1);
      if (tab1 && tab2) {
        table_row<Q>(table, leaf_code<Q, kMasks>(cur.obs2), m2);
      } else {
        float d[Q];
        partial<Q, kMasks>(tab1 ? step.z : step.y, tab1 ? cur.obs2 : cur.obs1, col, d);
        message<Q, kShared>(d, tab1 ? p2 : p1, m2);
      }
    } else {
      float d1[Q], d2[Q];
      partial<Q, kMasks>(step.y, cur.obs1, col, d1);
      partial<Q, kMasks>(step.z, cur.obs2, col, d2);
      messages<Q, kShared>(d1, p1, d2, p2, m1, m2);
    }
    float mx = 0.0f;
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      m1[i] *= m2[i];
      mx = fmaxf(mx, m1[i]);
    }
    // Biased exponent of the max (0 when it is 0 or denormal, as in the
    // reference); 2^(127 - e) built from its bits is exact.
    const unsigned e = __float_as_uint(mx) >> 23;
    const float inv = __uint_as_float((254u - e) << 23);
    exp_sum += static_cast<int>(e) - 127;
#pragma unroll
    for (int i = 0; i < Q; ++i) root[i] = m1[i] * inv;
    if (k + 1 < n_anc) {  // the root partial stays in registers
      float4* row = reinterpret_cast<float4*>(col) + step.w * (Q / 4 * kSites);
#pragma unroll
      for (int c = 0; c < Q / 4; ++c) {
        row[c * kSites] = make_float4(root[4 * c], root[4 * c + 1], root[4 * c + 2],
                                      root[4 * c + 3]);
      }
    }
  }
  float site_lik = __ldg(prior) * root[0];
#pragma unroll
  for (int i = 1; i < Q; ++i) site_lik += __ldg(prior + i) * root[i];
  const float per = logf(fmaxf(site_lik, 1e-30f)) + static_cast<float>(exp_sum) * kLn2;
  per_site[static_cast<size_t>(tree) * length + site] = per * __ldg(weights + site);
}

// One child of a runtime-Q step: a leaf (its state or mask `obs`) or an
// ancestor row (`row`, states `stride` floats apart), and, under a
// per-branch P, the (Q, Q) matrix of the branch above it (`p`).
struct AnyChild {
  bool leaf;
  int obs;
  const float* row;
  const float* p;
};

template <bool kMasks>
__device__ __forceinline__ float tip_value(int obs, int j) {
  const bool allowed = kMasks ? ((obs >> j) & 1) != 0 : (obs == j || obs < 0);
  return allowed ? 1.0f : 0.0f;
}

template <bool kMasks>
__device__ __forceinline__ float child_at(const AnyChild& c, int j, size_t stride) {
  return c.leaf ? tip_value<kMasks>(c.obs, j) : c.row[j * stride];
}

// This thread's tile of a message under a shared P: t[v] = sum_j P[s0 + v,
// j] d[j], j = 0..Q-1 in order, from Pt (Q x pitch floats, zero past Q).
template <bool kMasks>
__device__ __forceinline__ void tile_message_shared(const AnyChild& c, int q, int pitch,
                                                    const float* pt, int s0, size_t stride,
                                                    float (&t)[kTile]) {
  {
    const float a = child_at<kMasks>(c, 0, stride);
#pragma unroll
    for (int v = 0; v < kTile; v += 4) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + s0 + v);
      t[v] = pv.x * a;
      t[v + 1] = pv.y * a;
      t[v + 2] = pv.z * a;
      t[v + 3] = pv.w * a;
    }
  }
  for (int j = 1; j < q; ++j) {
    const float a = child_at<kMasks>(c, j, stride);
    const float* pj = pt + j * pitch + s0;
#pragma unroll
    for (int v = 0; v < kTile; v += 4) {
      const float4 pv = *reinterpret_cast<const float4*>(pj + v);
      t[v] += pv.x * a;
      t[v + 1] += pv.y * a;
      t[v + 2] += pv.z * a;
      t[v + 3] += pv.w * a;
    }
  }
}

// The same under the child's own P (row-major (Q, Q) in global memory);
// states past Q are 0.
template <bool kMasks>
__device__ __forceinline__ void tile_message_branch(const AnyChild& c, int q, int s0,
                                                    size_t stride, float (&t)[kTile]) {
  const int rows = q - s0 < kTile ? q - s0 : kTile;
  const float* p = c.p + static_cast<size_t>(s0) * q;
  {
    const float a = child_at<kMasks>(c, 0, stride);
#pragma unroll
    for (int v = 0; v < kTile; ++v) t[v] = v < rows ? __ldg(p + v * q) * a : 0.0f;
  }
  for (int j = 1; j < q; ++j) {
    const float a = child_at<kMasks>(c, j, stride);
#pragma unroll
    for (int v = 0; v < kTile; ++v) {
      if (v < rows) t[v] += __ldg(p + v * q + j) * a;
    }
  }
}

// Any Q >= 2: blocks of `sites` x tiles threads, thread (tile, site) =
// threadIdx.x / sites, % sites, computing parent states 16 * tile .. + 15
// of its site. Dynamic shared memory: Pt (q x pitch floats, pitch = q
// rounded up to 16; shared P only), the leaf-message table ((q + 2) x pitch
// floats, `use_table` != 0: shared P, state mode), the tiles' maxima
// (tiles x sites floats), then, in the shared mode, the slot columns
// (slots, q, sites); the global mode's slots are (chunk, slots, q, L)
// floats in `slots_g`.
template <bool kShared, bool kMasks, bool kGlobal>
__global__ void __launch_bounds__(kMaxAnyThreads)
pruning_any_kernel(const int4* __restrict__ plan, const int2* __restrict__ children,
                   const int* __restrict__ leaves, const float* __restrict__ pmats,
                   const float* __restrict__ prior, const float* __restrict__ weights,
                   float* __restrict__ slots_g, float* __restrict__ per_site, int tree0,
                   int n_leaves, int length, int q, int n_slots, int sites, int use_table) {
  extern __shared__ __align__(16) float smem[];
  const int pitch = (q + kTile - 1) / kTile * kTile;
  const int tiles = pitch / kTile;
  const int lane = threadIdx.x % sites;
  const int tile = threadIdx.x / sites;
  const int s0 = tile * kTile;
  const int tree = tree0 + blockIdx.y;
  const int site = blockIdx.x * sites + lane;
  const bool active = site < length;
  const int n_anc = n_leaves - 1;
  const int n_all = 2 * n_leaves - 1;
  const size_t len = static_cast<size_t>(length);
  float* pt = smem;
  float* table = pt + (kShared ? q * pitch : 0);
  float* maxes = table + (use_table ? (q + 2) * pitch : 0);
  float* cols = maxes + tiles * sites;
  if (kShared) {
    for (int k = threadIdx.x; k < q * pitch; k += blockDim.x) {
      const int j = k / pitch, s = k % pitch;
      pt[k] = s < q ? __ldg(pmats + s * q + j) : 0.0f;
    }
    __syncthreads();
    // table[code][s] = sum_j P[s, j] tip(code, j); code q: a missing state,
    // code q + 1: any state >= q.
    for (int e = threadIdx.x; use_table && e < (q + 2) * pitch; e += blockDim.x) {
      const int code = e / pitch, s = e % pitch;
      const int obs = code < q ? code : code == q ? -1 : q;
      float t = pt[s] * tip_value<false>(obs, 0);
      for (int j = 1; j < q; ++j) t += pt[j * pitch + s] * tip_value<false>(obs, j);
      table[e] = t;
    }
    __syncthreads();
  }

  float* base;
  size_t stride;
  if (kGlobal) {
    base = slots_g + static_cast<size_t>(blockIdx.y) * n_slots * q * len + site;
    stride = len;
  } else {
    base = cols + lane;
    stride = static_cast<size_t>(sites);
  }
  const size_t slot_stride = static_cast<size_t>(q) * stride;
  const int4* steps = plan + static_cast<size_t>(tree) * n_anc;
  const int2* tree_children = children + static_cast<size_t>(tree) * n_anc;
  const float* tree_p = pmats + static_cast<size_t>(tree) * n_all * q * q;
  const int* leaf_col = leaves + site;
  int exp_sum = 0;
  int root_slot = 0;
  for (int k = 0; k < n_anc; ++k) {
    const int4 st = __ldg(steps + k);
    float m1[kTile], m2[kTile];
    float mx = 0.0f;
    if (active) {
      const int obs1 = st.y >= 0 ? __ldg(leaf_col + st.y * length) : 0;
      const int obs2 = st.z >= 0 ? __ldg(leaf_col + st.z * length) : 0;
      const int2 nodes = kShared ? make_int2(0, 0) : __ldg(tree_children + st.x);
      const AnyChild c1{st.y >= 0, obs1, st.y >= 0 ? nullptr : base + ~st.y * slot_stride,
                        kShared ? nullptr : tree_p + static_cast<size_t>(nodes.x) * q * q};
      const AnyChild c2{st.z >= 0, obs2, st.z >= 0 ? nullptr : base + ~st.z * slot_stride,
                        kShared ? nullptr : tree_p + static_cast<size_t>(nodes.y) * q * q};
      if (kShared) {
        const bool table1 = use_table && c1.leaf, table2 = use_table && c2.leaf;
        if (!table1) tile_message_shared<kMasks>(c1, q, pitch, pt, s0, stride, m1);
        if (!table2) tile_message_shared<kMasks>(c2, q, pitch, pt, s0, stride, m2);
        const int code1 = c1.obs < 0 ? q : c1.obs < q ? c1.obs : q + 1;
        const int code2 = c2.obs < 0 ? q : c2.obs < q ? c2.obs : q + 1;
#pragma unroll
        for (int v = 0; v < kTile; ++v) {
          if (table1) m1[v] = table[code1 * pitch + s0 + v];
          if (table2) m2[v] = table[code2 * pitch + s0 + v];
        }
      } else {
        tile_message_branch<kMasks>(c1, q, s0, stride, m1);
        tile_message_branch<kMasks>(c2, q, s0, stride, m2);
      }
#pragma unroll
      for (int v = 0; v < kTile; ++v) {
        m1[v] *= m2[v];
        mx = fmaxf(mx, m1[v]);
      }
    }
    maxes[tile * sites + lane] = mx;
    __syncthreads();  // every tile has read the children and posted its maximum
    for (int t = 0; t < tiles; ++t) mx = fmaxf(mx, maxes[t * sites + lane]);
    // Biased exponent of the site's max (0 when it is 0 or denormal);
    // 2^(127 - e) built from its bits is exact.
    const unsigned e = __float_as_uint(mx) >> 23;
    const float inv = __uint_as_float((254u - e) << 23);
    exp_sum += static_cast<int>(e) - 127;
    root_slot = st.w;
    if (active) {
      float* dst = base + st.w * slot_stride;
#pragma unroll
      for (int v = 0; v < kTile; ++v) {
        if (s0 + v < q) dst[(s0 + v) * stride] = m1[v] * inv;
      }
    }
    __syncthreads();  // the new row is in place (and the maxima read)
  }
  if (tile == 0 && active) {
    const float* root = base + root_slot * slot_stride;
    float site_lik = __ldg(prior) * root[0];
    for (int i = 1; i < q; ++i) site_lik += __ldg(prior + i) * root[i * stride];
    const float per = logf(fmaxf(site_lik, 1e-30f)) + static_cast<float>(exp_sum) * kLn2;
    per_site[static_cast<size_t>(tree) * len + site] = per * __ldg(weights + site);
  }
}

// out[b] = sum of tree b's weighted site values: a pairwise tree over each
// 128-site block (zero past L), then the blocks in index order.
__global__ void __launch_bounds__(kSumThreads)
sum_sites_kernel(const float* __restrict__ per_site, float* __restrict__ out, int length) {
  __shared__ float part[kSumThreads];
  const float* row = per_site + static_cast<size_t>(blockIdx.x) * length;
  float total = 0.0f;
  for (int base = 0; base < length; base += kSumThreads) {
    const int site = base + threadIdx.x;
    part[threadIdx.x] = site < length ? row[site] : 0.0f;
    __syncthreads();
    for (int stride = kSumThreads / 2; stride > 0; stride >>= 1) {
      if (threadIdx.x < stride) {
        part[threadIdx.x] = __fadd_rn(part[threadIdx.x], part[threadIdx.x + stride]);
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) total = __fadd_rn(total, part[0]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

struct Args {
  const int4* plan;
  const int2* children;
  const int* leaves;
  const float* pmats;
  const float* prior;
  const float* weights;
  float* slots_g;
  float* per_site;
  int batch, n_leaves, length, q, n_slots, sites, use_table, chunk, smem;
  cudaStream_t stream;
};

template <int Q, bool kShared, bool kMasks>
int launch_chunks(const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(pruning_kernel<Q, kShared, kMasks>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (a.length + kSites - 1) / kSites;
  for (int tree0 = 0; tree0 < a.batch; tree0 += a.chunk) {
    const int trees = a.batch - tree0 < a.chunk ? a.batch - tree0 : a.chunk;
    pruning_kernel<Q, kShared, kMasks><<<dim3(n_blocks, trees), kSites, a.smem, a.stream>>>(
        a.plan, a.children, a.leaves, a.pmats, a.prior, a.weights, a.per_site, tree0,
        a.n_leaves, a.length);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <bool kShared, bool kMasks, bool kGlobal>
int launch_any(const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(pruning_any_kernel<kShared, kMasks, kGlobal>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.q + kTile - 1) / kTile;
  const int n_blocks = (a.length + a.sites - 1) / a.sites;
  for (int tree0 = 0; tree0 < a.batch; tree0 += a.chunk) {
    const int trees = a.batch - tree0 < a.chunk ? a.batch - tree0 : a.chunk;
    pruning_any_kernel<kShared, kMasks, kGlobal>
        <<<dim3(n_blocks, trees), a.sites * tiles, a.smem, a.stream>>>(
            a.plan, a.children, a.leaves, a.pmats, a.prior, a.weights, a.slots_g, a.per_site,
            tree0, a.n_leaves, a.length, a.q, a.n_slots, a.sites, a.use_table);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int Q>
int dispatch(const Args& a, bool shared, bool masks) {
  if (shared) return masks ? launch_chunks<Q, true, true>(a) : launch_chunks<Q, true, false>(a);
  return masks ? launch_chunks<Q, false, true>(a) : launch_chunks<Q, false, false>(a);
}

template <bool kGlobal>
int dispatch_any(const Args& a, bool shared, bool masks) {
  if (shared) {
    return masks ? launch_any<true, true, kGlobal>(a) : launch_any<true, false, kGlobal>(a);
  }
  return masks ? launch_any<false, true, kGlobal>(a) : launch_any<false, false, kGlobal>(a);
}

}  // namespace

// plan (B, n_anc, 4) int32 from csrc/tree_plan.cu, 16-byte aligned;
// children (B, n_anc, 2) int32, 8-byte aligned (read for per-branch P);
// leaves (n_leaves, L) int32 states (negative = missing) or state-set
// masks (`masks` != 0, Q <= 31), n_leaves x L < 2^31; pmats (Q, Q) f32 when
// `shared` != 0, else (B, n_all, Q, Q) f32, 16-byte aligned; prior (Q,)
// f32; weights (L,) f32; per_site (B, L) f32, each site's log-likelihood
// times its weight; out (B,) f32 their sums, or null to launch no site sum
// (the rows alone). Q = 4 and 20: blocks of 128 threads, one a site. Any
// other Q >= 2: blocks of `sites` sites, ceil(Q / 16) threads each (at
// most 512 a block), `n_slots` slot rows a site; `global_slots` != 0 keeps
// the slots in slots_g, (chunk, n_slots, Q, L) f32; `use_table` != 0
// (shared P, state mode) keeps the leaf-message table. Each with `smem`
// bytes of dynamic shared memory, laid out as the kernels above say (the
// wrapper's launch plan). Trees are walked `chunk` at a time (chunk <=
// 65535). Launches on `stream`, does not synchronise, allocates nothing.
// Returns the CUDA error code (0 = launched; -1 = Q < 2).
extern "C" int trex_likelihood_batched(const void* plan, const void* children,
                                       const void* leaves, const void* pmats,
                                       const void* prior, const void* weights, void* slots_g,
                                       void* per_site, void* out, int batch, int n_leaves,
                                       int length, int n_states, int shared, int masks,
                                       int n_slots, int sites, int global_slots, int use_table,
                                       int chunk, int smem, void* stream) {
  const Args a{static_cast<const int4*>(plan),    static_cast<const int2*>(children),
               static_cast<const int*>(leaves),   static_cast<const float*>(pmats),
               static_cast<const float*>(prior),  static_cast<const float*>(weights),
               static_cast<float*>(slots_g),      static_cast<float*>(per_site),
               batch, n_leaves, length, n_states, n_slots, sites, use_table, chunk, smem,
               static_cast<cudaStream_t>(stream)};
  int rc;
  if (n_states == 4) {
    rc = dispatch<4>(a, shared != 0, masks != 0);
  } else if (n_states == 20) {
    rc = dispatch<20>(a, shared != 0, masks != 0);
  } else if (n_states >= 2) {
    rc = global_slots != 0 ? dispatch_any<true>(a, shared != 0, masks != 0)
                           : dispatch_any<false>(a, shared != 0, masks != 0);
  } else {
    return -1;
  }
  if (rc != 0 || out == nullptr) return rc;
  sum_sites_kernel<<<batch, kSumThreads, 0, a.stream>>>(
      static_cast<const float*>(per_site), static_cast<float*>(out), length);
  return static_cast<int>(cudaGetLastError());
}
