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
// the int32 exponent sum. Every sum is written in explicit round-to-nearest
// intrinsics (a product, then one FMA a term; the log and the exponent
// term added unfused), so its rounding does not depend on how the compiler
// contracts it, and every width and both kernels round alike. The site sum
// is deterministic: each thread writes its weighted site value, and a
// second kernel adds a tree's sites in 128-site pairwise blocks, the blocks
// in index order — no float atomics, so a run reproduces itself bit for
// bit.
// - Up to 20 states (fixed kernels): Q is a template parameter W = 4, 8, 12,
//   16 or 20, the least that holds Q, so the state loops unroll into
//   registers; one thread per site walks its tree's plan with no block
//   synchronisation. A Q below W runs on zero-padded states (the kernel pads
//   a shared P and the prior, the wrapper a per-branch P): a padded state
//   meets a zero row and column of P and a zero prior, so every padded term
//   adds +0 and the result is Q's bit for bit (a state or mask bit >= Q
//   meets a zero column, as it met no column before).
// - Above 20 states (runtime-Q kernel): a site's ceil(Q / 16) tiles of 16
//   parent states are lanes of one warp, and each thread computes its tile
//   for two adjacent sites, so a 16-byte load of P feeds 8 FMAs. P sits in
//   shared memory row-major, each tile's rows shifted 4 floats on so the
//   tiles of a warp read different banks; a per-branch P's two child
//   matrices are copied there by 4-byte cp.async a step ahead (its rows of
//   Q floats are not 16-byte aligned at Q = 61), into the second of two
//   buffers, behind one block barrier a step. The site's maximum is taken
//   over its tiles by warp shuffles, and __syncwarp orders a step's reads
//   of the children before the new row (which may take a child's slot) is
//   written, and the row before the next step reads it: no other barrier.
//   A child message is one FMA chain from 0 over j = 0..Q-1 (rounded up to
//   4: P's padded columns add +0), a mul-then-FMA chain's value. The root's
//   row goes to its slot like any other, and the site's first tile adds
//   prior_i root_i over i = 0..Q-1 in order. Under a shared P in state mode
//   a leaf child's message is a row of a table each block computes first (a
//   row per state, one for a missing state, one for a state >= Q). Where
//   the slot columns do not fit a block's shared memory the same slot stack
//   sits in a global buffer (the global-slot mode).

#include <cuda_runtime.h>

namespace {

constexpr int kSumThreads = 128;  // sites per pairwise block of the site sum
constexpr int kSites = 128;       // sites (threads) per block of the fixed kernels
constexpr int kTile = 16;         // parent states per thread of the runtime-Q kernel
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
    float acc = __fmul_rn(pv.x, d[0]);
    acc = __fmaf_rn(pv.y, d[1], acc);
    acc = __fmaf_rn(pv.z, d[2], acc);
    acc = __fmaf_rn(pv.w, d[3], acc);
#pragma unroll
    for (int j = 4; j < Q; j += 4) {
      pv = p4<kShared>(p + i * Q + j);
      acc = __fmaf_rn(pv.x, d[j], acc);
      acc = __fmaf_rn(pv.y, d[j + 1], acc);
      acc = __fmaf_rn(pv.z, d[j + 2], acc);
      acc = __fmaf_rn(pv.w, d[j + 3], acc);
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
    float acc1 = __fmul_rn(a.x, d1[0]), acc2 = __fmul_rn(b.x, d2[0]);
    acc1 = __fmaf_rn(a.y, d1[1], acc1);
    acc2 = __fmaf_rn(b.y, d2[1], acc2);
    acc1 = __fmaf_rn(a.z, d1[2], acc1);
    acc2 = __fmaf_rn(b.z, d2[2], acc2);
    acc1 = __fmaf_rn(a.w, d1[3], acc1);
    acc2 = __fmaf_rn(b.w, d2[3], acc2);
#pragma unroll
    for (int j = 4; j < Q; j += 4) {
      a = p4<kShared>(p1 + i * Q + j);
      b = p4<kShared>(p2 + i * Q + j);
      acc1 = __fmaf_rn(a.x, d1[j], acc1);
      acc2 = __fmaf_rn(b.x, d2[j], acc2);
      acc1 = __fmaf_rn(a.y, d1[j + 1], acc1);
      acc2 = __fmaf_rn(b.y, d2[j + 1], acc2);
      acc1 = __fmaf_rn(a.z, d1[j + 2], acc1);
      acc2 = __fmaf_rn(b.z, d2[j + 2], acc2);
      acc1 = __fmaf_rn(a.w, d1[j + 3], acc1);
      acc2 = __fmaf_rn(b.w, d2[j + 3], acc2);
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
               int tree0, int n_leaves, int length, int q) {
  extern __shared__ __align__(16) float smem[];
  const int tree = tree0 + blockIdx.y;
  const int site = blockIdx.x * kSites + threadIdx.x;
  const int n_anc = n_leaves - 1;
  const int n_all = 2 * n_leaves - 1;
  constexpr int kCodes = leaf_codes<Q, kShared, kMasks>();
  float* p_shared = smem;
  float* table = smem + (kShared ? Q * Q : 0);
  if (kShared) {
    // A shared P of q <= Q states is zero-padded to (Q, Q) here.
    for (int k = threadIdx.x; k < Q * Q; k += kSites) {
      const int s = k / Q, j = k % Q;
      p_shared[k] = s < q && j < q ? pmats[s * q + j] : 0.0f;
    }
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
  // A padded state's prior is 0: its term adds +0 to the chain.
  float site_lik = __fmul_rn(__ldg(prior), root[0]);
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    site_lik = __fmaf_rn(i < q ? __ldg(prior + i) : 0.0f, root[i], site_lik);
  }
  const float per =
      __fadd_rn(logf(fmaxf(site_lik, 1e-30f)), __fmul_rn(static_cast<float>(exp_sum), kLn2));
  per_site[static_cast<size_t>(tree) * length + site] = per * __ldg(weights + site);
}

// Runtime-Q kernel (Q > 20). A site's partial rows hold h = 16 ceil(Q / 16)
// states (zero past Q); P sits in shared memory row-major, h rows of pitch =
// kPitch (32 or 64, a compile-time class) or h (kPitch 0) floats laid out by
// `p_row`, zero past Q in both dimensions. A site's ceil(Q / 16) tiles are
// `lanes` (that count rounded up to a power of two) lanes of one warp, lane
// = tile * (32 / lanes) + group; each thread computes its tile for kSpt
// adjacent sites.
constexpr int kSpt = 2;  // sites per thread of the runtime-Q kernel
constexpr int kMaxAnyThreads = 256;

__host__ __device__ __forceinline__ int any_rows(int q) { return (q + kTile - 1) / kTile * kTile; }

// Float offset of P's row s in shared memory: rows `pitch` floats apart,
// each tile's 16 rows shifted by 4 floats more than the tile before, so the
// four (or more) tiles of a warp read P in different banks.
__host__ __device__ __forceinline__ int p_row(int s, int pitch) {
  return s * pitch + (s / kTile) * 4;
}

// Floats of one P matrix in shared memory (h rows).
__host__ __device__ __forceinline__ int p_floats_for(int h, int pitch) { return p_row(h, pitch); }

__host__ __device__ __forceinline__ int any_lanes(int q) {
  int lanes = 1;
  while (lanes * kTile < q) lanes <<= 1;
  return lanes;
}

template <bool kMasks>
__device__ __forceinline__ float tip_value(int obs, int j) {
  const bool allowed = kMasks ? ((obs >> j) & 1) != 0 : (obs == j || obs < 0);
  return allowed ? 1.0f : 0.0f;
}

static_assert(kSpt == 2, "a thread's sites are read and written as one float2");

__device__ __forceinline__ void load_sites(const float* p, float (&d)[kSpt]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  d[0] = v.x;
  d[1] = v.y;
}

__device__ __forceinline__ void store_sites(float* p, const float (&d)[kSpt]) {
  *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
}

// 4-byte asynchronous copy global -> shared (the per-branch P's staging).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One child's message for this thread's tile and sites: t[v][k] = sum_j
// P[s0 + v, j] d_k[j] over j = 0..Q-1 in order, as one FMA chain from 0 (P's
// columns past Q are 0, so the chain's padded terms add +0; j runs to Q
// rounded up to 4). `p` is P's row s0; d comes from the child's slot row
// (`row`: this thread's first site, states `stride` floats apart) or, for a
// leaf child, from its tip values at `obs`.
template <int kPitch, bool kMasks>
__device__ __forceinline__ void tile_message(bool leaf, const int (&obs)[kSpt], const float* row,
                                             size_t stride, const float* p, int pitch, int q4,
                                             float (&t)[kTile][kSpt]) {
  const int ld = kPitch ? kPitch : pitch;
#pragma unroll
  for (int v = 0; v < kTile; ++v) {
#pragma unroll
    for (int k = 0; k < kSpt; ++k) t[v][k] = 0.0f;
  }
  for (int j = 0; j < q4; j += 4) {
    float d[4][kSpt];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (leaf) {
#pragma unroll
        for (int k = 0; k < kSpt; ++k) d[i][k] = tip_value<kMasks>(obs[k], j + i);
      } else {
        load_sites(row + (j + i) * stride, d[i]);
      }
    }
#pragma unroll
    for (int v = 0; v < kTile; ++v) {
      const float4 pv = *reinterpret_cast<const float4*>(p + v * ld + j);
#pragma unroll
      for (int k = 0; k < kSpt; ++k) {
        t[v][k] = __fmaf_rn(pv.x, d[0][k], t[v][k]);
        t[v][k] = __fmaf_rn(pv.y, d[1][k], t[v][k]);
        t[v][k] = __fmaf_rn(pv.z, d[2][k], t[v][k]);
        t[v][k] = __fmaf_rn(pv.w, d[3][k], t[v][k]);
      }
    }
  }
}

// Site k's 16 entries of a leaf-message table row (16-byte aligned).
__device__ __forceinline__ void table_tile(const float* row, float (&t)[kTile][kSpt], int k) {
#pragma unroll
  for (int v = 0; v < kTile; v += 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + v);
    t[v][k] = x.x;
    t[v + 1][k] = x.y;
    t[v + 2][k] = x.z;
    t[v + 3][k] = x.w;
  }
}

// Copy two (q, q) row-major matrices from global memory into shared rows
// (`p_row`), a 4-byte cp.async an entry, this thread's entries k =
// threadIdx.x + i * blockDim.x at (s, j) = (k / q, k % q) stepped by (ds, dj).
__device__ __forceinline__ void stage_pair(float* dst1, float* dst2, const float* src1,
                                           const float* src2, int q, int pitch, int s, int j,
                                           int ds, int dj) {
  for (int k = threadIdx.x; k < q * q; k += blockDim.x) {
    cp_async4(dst1 + p_row(s, pitch) + j, src1 + k);
    cp_async4(dst2 + p_row(s, pitch) + j, src2 + k);
    j += dj;
    s += ds;
    if (j >= q) {
      j -= q;
      ++s;
    }
  }
  cp_async_commit();
}

// Blocks of `sites` sites, sites * lanes / kSpt threads. Dynamic shared
// memory: P (shared P: one (h, pitch) matrix; per-branch P: two buffers of
// the step's two child matrices, the next step's copied while this one
// computes), the leaf-message table ((q + 2) x h floats, `use_table` != 0:
// shared P, state mode), then, in the shared mode, the slot columns (slots,
// h, sites). The global mode's slots are (chunk, slots, h, L rounded up to
// 4) floats in `slots_g`. A step synchronises only the warp (a site's tiles
// post their maxima by shuffles; __syncwarp before the new row is written,
// since it may take a child's slot, and after); a per-branch P adds one
// block barrier a step, for its staging.
template <int kPitch, bool kShared, bool kMasks, bool kGlobal>
__global__ void __launch_bounds__(kMaxAnyThreads, 1)
pruning_any_kernel(const int4* __restrict__ plan, const int2* __restrict__ children,
                   const int* __restrict__ leaves, const float* __restrict__ pmats,
                   const float* __restrict__ prior, const float* __restrict__ weights,
                   float* __restrict__ slots_g, float* __restrict__ per_site, int tree0,
                   int n_leaves, int length, int q, int n_slots, int sites, int use_table) {
  extern __shared__ __align__(16) float smem[];
  const int h = any_rows(q);
  const int pitch = kPitch ? kPitch : h;
  const int q4 = (q + 3) & ~3;
  const int groups = 32 / any_lanes(q);
  const int lane = threadIdx.x % 32;
  const int tile = lane / groups;
  const bool idle = tile * kTile >= h;  // a lane past the site's last tile
  const int s0 = idle ? 0 : tile * kTile;
  const int local = ((threadIdx.x / 32) * groups + lane % groups) * kSpt;
  const int site0 = blockIdx.x * sites + local;
  const int tree = tree0 + blockIdx.y;
  const int n_anc = n_leaves - 1;
  const int n_all = 2 * n_leaves - 1;
  const int p_floats = p_floats_for(h, pitch);
  float* pbuf = smem;
  float* table = pbuf + (kShared ? 1 : 4) * p_floats;
  float* cols = table + (use_table ? (q + 2) * h : 0);
  const int4* steps = plan + static_cast<size_t>(tree) * n_anc;
  const int2* tree_children = children + static_cast<size_t>(tree) * n_anc;
  const float* tree_p = pmats + static_cast<size_t>(tree) * n_all * q * q;
  const int s_first = threadIdx.x / q, j_first = threadIdx.x % q;
  const int ds = blockDim.x / q, dj = blockDim.x % q;

  int4 st = __ldg(steps);
  int4 nx = n_anc > 1 ? __ldg(steps + 1) : st;
  int2 nodes_nx = make_int2(0, 0);
  if (kShared) {
    for (int k = threadIdx.x; k < h * pitch; k += blockDim.x) {
      const int s = k / pitch, j = k % pitch;
      pbuf[p_row(s, pitch) + j] = s < q && j < q ? __ldg(pmats + s * q + j) : 0.0f;
    }
    __syncthreads();
    // table[code][s] = sum_j P[s, j] tip(code, j); code q: a missing state,
    // code q + 1: any state >= q.
    for (int e = threadIdx.x; use_table && e < (q + 2) * h; e += blockDim.x) {
      const int code = e / h, s = e % h;
      const int obs = code < q ? code : code == q ? -1 : q;
      const float* ps = pbuf + p_row(s, pitch);
      float t = ps[0] * tip_value<false>(obs, 0);
      for (int j = 1; j < q; ++j) t += ps[j] * tip_value<false>(obs, j);
      table[e] = t;
    }
    __syncthreads();
  } else {
    // Zero both buffers (their padding stays 0), then copy step 0's pair.
    for (int k = threadIdx.x; k < 4 * p_floats; k += blockDim.x) pbuf[k] = 0.0f;
    __syncthreads();
    const int2 nodes = __ldg(tree_children + st.x);
    stage_pair(pbuf, pbuf + p_floats, tree_p + static_cast<size_t>(nodes.x) * q * q,
               tree_p + static_cast<size_t>(nodes.y) * q * q, q, pitch, s_first, j_first, ds,
               dj);
    if (n_anc > 1) nodes_nx = __ldg(tree_children + nx.x);
  }

  // This thread's slot rows: its first site's column, states `stride`
  // floats apart. Global mode: a thread whose sites all lie past L touches
  // no memory (L is padded to 4, so a thread's kSpt sites lie in the row).
  const bool touch = !kGlobal || site0 < length;
  size_t stride;
  float* base;
  if (kGlobal) {
    stride = static_cast<size_t>((length + 3) & ~3);
    base = slots_g + static_cast<size_t>(blockIdx.y) * n_slots * h * stride + site0;
  } else {
    stride = static_cast<size_t>(sites);
    base = cols + local;
  }
  const size_t slot_stride = static_cast<size_t>(h) * stride;
  const int* leaf_col = leaves + site0;
  int obs1[kSpt], obs2[kSpt];
#pragma unroll
  for (int k = 0; k < kSpt; ++k) {
    const bool in = site0 + k < length;
    obs1[k] = in && st.y >= 0 ? __ldg(leaf_col + st.y * length + k) : 0;
    obs2[k] = in && st.z >= 0 ? __ldg(leaf_col + st.z * length + k) : 0;
  }
  int exp_sum[kSpt];
#pragma unroll
  for (int k = 0; k < kSpt; ++k) exp_sum[k] = 0;
  int root_slot = 0;
  for (int step = 0; step < n_anc; ++step) {
    const float* p1 = pbuf;
    if (!kShared) {
      cp_async_wait_all();
      __syncthreads();  // this step's pair is in place; the other buffer is free
      if (step + 1 < n_anc) {
        float* next = pbuf + ((step + 1) & 1) * 2 * p_floats;
        stage_pair(next, next + p_floats, tree_p + static_cast<size_t>(nodes_nx.x) * q * q,
                   tree_p + static_cast<size_t>(nodes_nx.y) * q * q, q, pitch, s_first,
                   j_first, ds, dj);
      }
      p1 = pbuf + (step & 1) * 2 * p_floats;
    }
    const float* p2 = kShared ? p1 : p1 + p_floats;
    // The next step's leaf states, and the step after it (its P's nodes).
    int4 after = nx;
    int2 nodes_after = nodes_nx;
    int next1[kSpt], next2[kSpt];
    if (step + 1 < n_anc) {
      if (step + 2 < n_anc) {
        after = __ldg(steps + step + 2);
        if (!kShared) nodes_after = __ldg(tree_children + after.x);
      }
#pragma unroll
      for (int k = 0; k < kSpt; ++k) {
        const bool in = site0 + k < length;
        next1[k] = in && nx.y >= 0 ? __ldg(leaf_col + nx.y * length + k) : 0;
        next2[k] = in && nx.z >= 0 ? __ldg(leaf_col + nx.z * length + k) : 0;
      }
    }
    float m1[kTile][kSpt], m2[kTile][kSpt];
    float mx[kSpt];
#pragma unroll
    for (int k = 0; k < kSpt; ++k) mx[k] = 0.0f;
    if (!idle && touch) {
      const bool leaf1 = st.y >= 0, leaf2 = st.z >= 0;
      const float* row1 = leaf1 ? nullptr : base + ~st.y * slot_stride;
      const float* row2 = leaf2 ? nullptr : base + ~st.z * slot_stride;
      if (use_table && leaf1) {
#pragma unroll
        for (int k = 0; k < kSpt; ++k) {
          const int code = obs1[k] < 0 ? q : obs1[k] < q ? obs1[k] : q + 1;
          table_tile(table + code * h + s0, m1, k);
        }
      } else {
        tile_message<kPitch, kMasks>(leaf1, obs1, row1, stride, p1 + p_row(s0, pitch), pitch,
                                      q4, m1);
      }
      if (use_table && leaf2) {
#pragma unroll
        for (int k = 0; k < kSpt; ++k) {
          const int code = obs2[k] < 0 ? q : obs2[k] < q ? obs2[k] : q + 1;
          table_tile(table + code * h + s0, m2, k);
        }
      } else {
        tile_message<kPitch, kMasks>(leaf2, obs2, row2, stride, p2 + p_row(s0, pitch), pitch,
                                      q4, m2);
      }
#pragma unroll
      for (int v = 0; v < kTile; ++v) {
#pragma unroll
        for (int k = 0; k < kSpt; ++k) {
          m1[v][k] *= m2[v][k];
          mx[k] = fmaxf(mx[k], m1[v][k]);
        }
      }
    }
    // The site's maximum over its tiles (lanes `groups` apart).
#pragma unroll
    for (int k = 0; k < kSpt; ++k) {
      for (int o = groups; o < 32; o <<= 1) {
        mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], o));
      }
    }
    // Biased exponent of the site's max (0 when it is 0 or denormal);
    // 2^(127 - e) built from its bits is exact.
    float inv[kSpt];
#pragma unroll
    for (int k = 0; k < kSpt; ++k) {
      const unsigned e = __float_as_uint(mx[k]) >> 23;
      inv[k] = __uint_as_float((254u - e) << 23);
      exp_sum[k] += static_cast<int>(e) - 127;
    }
    root_slot = st.w;
    __syncwarp();  // every tile of the warp's sites has read the children
    if (!idle && touch) {
      float* dst = base + st.w * slot_stride + s0 * stride;
#pragma unroll
      for (int v = 0; v < kTile; ++v) {
        float out[kSpt];
#pragma unroll
        for (int k = 0; k < kSpt; ++k) out[k] = m1[v][k] * inv[k];
        store_sites(dst + v * stride, out);
      }
    }
    __syncwarp();  // the new rows are in place
    st = nx;
    nx = after;
#pragma unroll
    for (int k = 0; k < kSpt; ++k) {
      obs1[k] = next1[k];
      obs2[k] = next2[k];
    }
    nodes_nx = nodes_after;
  }
  if (tile == 0 && touch) {
    const float* root = base + root_slot * slot_stride;
#pragma unroll
    for (int k = 0; k < kSpt; ++k) {
      const int site = site0 + k;
      if (site >= length) continue;
      float site_lik = __fmul_rn(__ldg(prior), root[k]);
      for (int i = 1; i < q; ++i) {
        site_lik = __fmaf_rn(__ldg(prior + i), root[i * stride + k], site_lik);
      }
      const float per = __fadd_rn(logf(fmaxf(site_lik, 1e-30f)),
                                  __fmul_rn(static_cast<float>(exp_sum[k]), kLn2));
      per_site[static_cast<size_t>(tree) * length + site] = per * __ldg(weights + site);
    }
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
    pruning_kernel<Q, kShared, kMasks>
        <<<dim3(n_blocks, trees), kSites, a.smem, a.stream>>>(
        a.plan, a.children, a.leaves, a.pmats, a.prior, a.weights, a.per_site, tree0,
        a.n_leaves, a.length, a.q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int kPitch, bool kShared, bool kMasks, bool kGlobal>
int launch_any(const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(pruning_any_kernel<kPitch, kShared, kMasks, kGlobal>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = a.sites * any_lanes(a.q) / kSpt;
  const int n_blocks = (a.length + a.sites - 1) / a.sites;
  for (int tree0 = 0; tree0 < a.batch; tree0 += a.chunk) {
    const int trees = a.batch - tree0 < a.chunk ? a.batch - tree0 : a.chunk;
    pruning_any_kernel<kPitch, kShared, kMasks, kGlobal>
        <<<dim3(n_blocks, trees), threads, a.smem, a.stream>>>(
            a.plan, a.children, a.leaves, a.pmats, a.prior, a.weights, a.slots_g, a.per_site,
            tree0, a.n_leaves, a.length, a.q, a.n_slots, a.sites, a.use_table);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int Q>
int dispatch(const Args& a, bool shared, bool masks) {
  if (shared) {
    return masks ? launch_chunks<Q, true, true>(a)
                 : launch_chunks<Q, true, false>(a);
  }
  return masks ? launch_chunks<Q, false, true>(a)
               : launch_chunks<Q, false, false>(a);
}

// State-set masks hold at most 31 states: the 32-pitch class alone takes them.
template <int kPitch, bool kGlobal>
int dispatch_any(const Args& a, bool shared, bool masks) {
  if (masks) {
    if constexpr (kPitch == 32) {
      return shared ? launch_any<32, true, true, kGlobal>(a)
                    : launch_any<32, false, true, kGlobal>(a);
    }
    return -1;
  }
  return shared ? launch_any<kPitch, true, false, kGlobal>(a)
                : launch_any<kPitch, false, false, kGlobal>(a);
}

template <int kPitch>
int dispatch_pitch(const Args& a, bool shared, bool masks, bool global_slots) {
  return global_slots ? dispatch_any<kPitch, true>(a, shared, masks)
                      : dispatch_any<kPitch, false>(a, shared, masks);
}

}  // namespace

// plan (B, n_anc, 4) int32 from csrc/tree_plan.cu, 16-byte aligned;
// children (B, n_anc, 2) int32, 8-byte aligned (read for per-branch P);
// leaves (n_leaves, L) int32 states (negative = missing) or state-set
// masks (`masks` != 0, Q <= 31), n_leaves x L < 2^31; pmats (Q, Q) f32 when
// `shared` != 0, else (B, n_all, W, W) f32 for a fixed width W, (B, n_all,
// Q, Q) for the runtime-Q kernel, 16-byte aligned; prior (Q,) f32; weights
// (L,) f32; per_site (B, L) f32, each site's log-likelihood times its
// weight; out (B,) f32 their sums, or null to launch no site sum (the rows
// alone). `width` 4, 8, 12, 16 or 20 (>= Q): the fixed kernel of that
// width, the states zero-padded (a shared P and the prior here, a
// per-branch P by the caller), blocks of 128 threads, one a site. `width`
// 0 and Q > 20: the runtime-Q kernel, blocks of `sites` sites, lanes / 2
// threads each (lanes = ceil(Q / 16) rounded up to a power of two; at most
// 256 a block), `n_slots` slot rows a site; `global_slots` != 0 keeps the
// slots in slots_g, (chunk, n_slots, 16 ceil(Q / 16), L rounded up to 4)
// f32; `use_table` != 0 (shared P, state mode) keeps the leaf-message
// table. Each with `smem` bytes of dynamic shared memory, laid out as the
// kernels above say (the wrapper's launch plan). Trees are walked `chunk`
// at a time (chunk <= 65535). Launches on `stream`, does not synchronise,
// allocates nothing. Returns the CUDA error code (0 = launched; -1 = a
// width or Q it does not take).
extern "C" int trex_likelihood_batched(const void* plan, const void* children,
                                       const void* leaves, const void* pmats,
                                       const void* prior, const void* weights, void* slots_g,
                                       void* per_site, void* out, int batch, int n_leaves,
                                       int length, int n_states, int width, int shared,
                                       int masks, int n_slots, int sites, int global_slots,
                                       int use_table, int chunk, int smem, void* stream) {
  const Args a{static_cast<const int4*>(plan),    static_cast<const int2*>(children),
               static_cast<const int*>(leaves),   static_cast<const float*>(pmats),
               static_cast<const float*>(prior),  static_cast<const float*>(weights),
               static_cast<float*>(slots_g),      static_cast<float*>(per_site),
               batch, n_leaves, length, n_states, n_slots, sites, use_table, chunk, smem,
               static_cast<cudaStream_t>(stream)};
  const bool sh = shared != 0, mk = masks != 0, gl = global_slots != 0;
  if (n_states < 2 || (width != 0 && width < n_states)) return -1;
  int rc;
  switch (width) {
    case 4: rc = dispatch<4>(a, sh, mk); break;
    case 8: rc = dispatch<8>(a, sh, mk); break;
    case 12: rc = dispatch<12>(a, sh, mk); break;
    case 16: rc = dispatch<16>(a, sh, mk); break;
    case 20: rc = dispatch<20>(a, sh, mk); break;
    case 0:
      if (n_states <= 20) return -1;
      rc = n_states <= 32   ? dispatch_pitch<32>(a, sh, mk, gl)
           : n_states <= 64 ? dispatch_pitch<64>(a, sh, mk, gl)
                            : dispatch_pitch<0>(a, sh, mk, gl);
      break;
    default: return -1;
  }
  if (rc != 0 || out == nullptr) return rc;
  sum_sites_kernel<<<batch, kSumThreads, 0, a.stream>>>(
      static_cast<const float*>(per_site), static_cast<float*>(out), length);
  return static_cast<int>(cudaGetLastError());
}
