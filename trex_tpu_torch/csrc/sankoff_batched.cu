// K5 — exact Sankoff (min-plus) parsimony scores of B trees on one
// alignment under a general (Q, Q) cost matrix C[parent_state, child_state].
// Each leaf row is 0 at the observed state (or at every allowed state of a
// state-set bitmask) and 1e5 elsewhere; each ancestor (children before
// parents) gets
//   dp[s] = sum over its two children of min_{s'} (C[s, s'] + d_child[s']),
// or, in the Hamming mode (C = ones - eye), the closed form
//   min(d_child[s], 1 + min_{s'} d_child[s']).
// The score of a tree is sum over sites of w * min_s root[s].
//
// Replaces: trex_tpu/ops/sankoff_pallas.py `_sankoff_kernel`, reached
// through `batched_sankoff_score_pallas` from the candidate dispatch
// (trex_tpu/ops/dispatch.py `batched_scores_fastest`) for every cost that
// is not Hamming with at most 32 states. Its padding of Q to 8 rows with
// BIG costs, its zero-state site padding and its (8, 128) output tiles are
// TPU scheduling and are not carried over. It kept all n_all rows of a
// tree in VMEM; this kernel keeps a few.
//
// What bounds it on this card: the inputs are small (the plan, the leaf
// table, C, the weights), so the floor is the arithmetic: per tree,
// ancestor and site, 2 children x Q^2 x (add + min) for the general
// messages (2 x ~3Q in the Hamming mode) plus Q adds to combine them, at
// the FP32 instruction rate (no instruction fuses an add with a min). Its
// predecessor walked ancestors in index order and kept every ancestor's
// (Q, site) row in a global scratch, written once and read once by the
// parent: bound by its own scratch traffic in DRAM (2 x B x n_anc x Q x L x
// 4 bytes, 34 GB at 512 taxa x 2048 sites, B = 1020: about 10 ms at 3.35
// TB/s, where the arithmetic takes about 2.2 ms).
//
// What the design does about it: the walk follows the tree plan
// (csrc/tree_plan.cu), a post-order in which the live rows form a stack
// of at most floor(log2 n_leaves) slots, so the rows stay on chip. All
// threads of a block share one tree, so each step's (v, src1, src2, dst)
// is a uniform broadcast load, fetched two steps ahead and the leaf states
// it names one step ahead. A block owns `sites` sites (from the wrapper's
// launch plan); each site keeps its slot rows in its own column of
// dynamic shared memory (fixed kernels: float4s of four states, laid out
// (slot, Q / 4, site); runtime-Q kernel: (slot, state, site)), conflict
// free. A leaf's row
// depends only on its state (or mask), so a leaf child's message is a
// row of a small table that each block computes first, with the same code
// as an ancestor child's; so about half of the messages cost Q loads
// instead of 2 Q^2 operations. The root row never leaves registers. C
// sits in shared memory transposed, Ct[j][s], so one 16-byte load gives
// four parent states' costs for one child state.
// - Q = 4 and Q = 20 (fixed kernels): one thread per site walks its tree's
//   plan with no block synchronisation; child rows and messages in
//   registers, C in registers at Q = 4.
// - Any other Q (runtime-Q kernel): one thread per (site, tile of 16
//   parent states), the tiles of a site sharing its slot column. Each
//   thread streams the two child rows once for its tile; the block
//   synchronises twice a step (all tiles have read the children before
//   any writes the new row, which may take a child's slot). Where even 32
//   sites' slot columns do not fit a block's shared memory (large Q on
//   deep trees) the same slot stack sits in a global buffer of slots x Q x
//   L floats a tree, small enough for the L2.
// Bit-exact: every add and min is a single rounded operation, `min * w` a
// separate rounded multiply; each site writes its weighted value, and a
// second kernel adds a tree's sites in 128-site pairwise blocks, the
// blocks in index order — no float atomics, so any cost gives the same low
// bits on every run as the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kSumThreads = 128;  // sites per pairwise block of the site sum
constexpr int kSites = 128;       // sites (threads) per block of the fixed kernels
constexpr int kTile = 16;         // parent states per thread of the runtime-Q kernel
constexpr int kMaxAnyThreads = 512;
constexpr float kBig = 1e5f;

template <bool kMasks>
__device__ __forceinline__ float leaf_cost(int obs, int state) {
  const bool allowed = kMasks ? ((obs >> state) & 1) != 0 : obs == state;
  return allowed ? 0.0f : kBig;
}

// A 16-byte load from shared memory that is re-issued at each use: hoisting
// a large cost matrix out of the walk's loop spills it to local memory.
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

template <int Q>
__device__ __forceinline__ float4 cost4(const float* ct, int k) {
  if (Q <= 8) return *reinterpret_cast<const float4*>(ct + k);
  return lds4(ct + k);
}

// Stage C transposed: ct[j * pitch + s] = C[s][j]; pad columns s >= q are 0.
__device__ __forceinline__ void stage_cost(const float* __restrict__ cost, float* ct, int q,
                                           int pitch) {
  for (int k = threadIdx.x; k < q * pitch; k += blockDim.x) {
    const int j = k / pitch, s = k % pitch;
    ct[k] = s < q ? __ldg(cost + s * q + j) : 0.0f;
  }
}

// A plan step and the states of the leaves it names.
struct Fetched {
  int4 step;
  int obs1, obs2;
};

// The leaf states of a step whose (v, src1, src2, dst) is loaded, from
// this site's column of the leaf table (n_leaves x L < 2^31, so 32-bit
// offsets).
__device__ __forceinline__ Fetched with_leaves(int4 step, const int* __restrict__ leaf_col,
                                               int length) {
  return {step, step.y >= 0 ? __ldg(leaf_col + step.y * length) : 0,
          step.z >= 0 ? __ldg(leaf_col + step.z * length) : 0};
}

// Leaf codes of the fixed kernels' message table: a code per state and one
// for any other value, or one per mask of Q bits (up to 8 states; no table
// above).
template <int Q, bool kMasks>
__host__ __device__ constexpr int leaf_codes() {
  return kMasks ? (Q <= 8 ? 1 << Q : 0) : Q + 1;
}

template <int Q, bool kMasks>
__device__ __forceinline__ int leaf_code(int obs) {
  if (kMasks) return obs & ((1 << Q) - 1);
  return obs >= 0 && obs < Q ? obs : Q;
}

template <int Q, bool kMasks>
__device__ __forceinline__ void leaf_row(int obs, float (&d)[Q]) {
#pragma unroll
  for (int i = 0; i < Q; ++i) d[i] = leaf_cost<kMasks>(obs, i);
}

// msg[s] = min_{s'} (C[s, s'] + d[s']), or the Hamming closed form
// min(d[s], 1 + min d), for one child row d.
template <int Q, bool kHamming>
__device__ __forceinline__ void message(const float (&d)[Q], const float* ct, float (&msg)[Q]) {
  if (kHamming) {
    float m = d[0];
#pragma unroll
    for (int i = 1; i < Q; ++i) m = fminf(m, d[i]);
    const float up = __fadd_rn(1.0f, m);
#pragma unroll
    for (int s = 0; s < Q; ++s) msg[s] = fminf(d[s], up);
  } else {
#pragma unroll
    for (int s0 = 0; s0 < Q; s0 += 4) {
      const float4 c = cost4<Q>(ct, s0);
      float t[4] = {__fadd_rn(c.x, d[0]), __fadd_rn(c.y, d[0]), __fadd_rn(c.z, d[0]),
                    __fadd_rn(c.w, d[0])};
#pragma unroll
      for (int j = 1; j < Q; ++j) {
        const float4 cj = cost4<Q>(ct, j * Q + s0);
        const float cs[4] = {cj.x, cj.y, cj.z, cj.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) t[k] = fminf(t[k], __fadd_rn(cs[k], d[j]));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) msg[s0 + k] = t[k];
    }
  }
}

// total[s] = msg_1[s] + msg_2[s] for two child rows d1, d2, the two
// messages computed together so that each cost is loaded once for both.
template <int Q, bool kHamming>
__device__ __forceinline__ void combine(const float (&d1)[Q], const float (&d2)[Q],
                                        const float* ct, float (&total)[Q]) {
  if (kHamming) {
    float m1[Q], m2[Q];
    message<Q, true>(d1, ct, m1);
    message<Q, true>(d2, ct, m2);
#pragma unroll
    for (int s = 0; s < Q; ++s) total[s] = __fadd_rn(m1[s], m2[s]);
    return;
  }
#pragma unroll
  for (int s0 = 0; s0 < Q; s0 += 4) {
    const float4 c = cost4<Q>(ct, s0);
    const float c0[4] = {c.x, c.y, c.z, c.w};
    float t1[4], t2[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      t1[k] = __fadd_rn(c0[k], d1[0]);
      t2[k] = __fadd_rn(c0[k], d2[0]);
    }
#pragma unroll
    for (int j = 1; j < Q; ++j) {
      const float4 cj = cost4<Q>(ct, j * Q + s0);
      const float cs[4] = {cj.x, cj.y, cj.z, cj.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        t1[k] = fminf(t1[k], __fadd_rn(cs[k], d1[j]));
        t2[k] = fminf(t2[k], __fadd_rn(cs[k], d2[j]));
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) total[s0 + k] = __fadd_rn(t1[k], t2[k]);
  }
}

// Row d of plan source `src` at this thread's site: a leaf's from its state
// `obs`, an ancestor's from its slot in the column `col` (states kSites
// floats apart, slots Q * kSites).
template <int Q, bool kMasks>
__device__ __forceinline__ void child_row(int src, int obs, const float* col, float (&d)[Q]) {
  if (src >= 0) {
    leaf_row<Q, kMasks>(obs, d);
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
__device__ __forceinline__ void table_row(const float* table, int code, float (&msg)[Q]) {
  const float* row = table + code * Q;
#pragma unroll
  for (int s = 0; s < Q; s += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + s);
    msg[s] = v.x;
    msg[s + 1] = v.y;
    msg[s + 2] = v.z;
    msg[s + 3] = v.w;
  }
}

// Q = 4 or 20. Dynamic shared memory: Ct (Q * Q floats), the leaf-message
// table (leaf_codes x Q floats), then the slot columns, float4s of four
// states laid out (slot, Q / 4, kSites). One thread per site, kSites a block
// (a constant, so every slot access is an immediate offset from the
// thread's column).
template <int Q, bool kMasks, bool kHamming>
__global__ void __launch_bounds__(kSites)
sankoff_fixed_kernel(const int4* __restrict__ plan,       // (B, n_anc)
                     const int* __restrict__ leaves,      // (n_leaves, L)
                     const float* __restrict__ cost,      // (Q, Q)
                     const float* __restrict__ weights,   // (L,)
                     float* __restrict__ per_site,        // (B, L)
                     int tree0, int n_leaves, int length) {
  constexpr int kCodes = leaf_codes<Q, kMasks>();
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;
  float* table = smem + Q * Q;
  const int tree = tree0 + blockIdx.y;
  const int site = blockIdx.x * kSites + threadIdx.x;
  const int n_anc = n_leaves - 1;
  stage_cost(cost, ct, Q, Q);
  __syncthreads();
  for (int code = threadIdx.x; code < kCodes; code += kSites) {
    float d[Q], msg[Q];
    leaf_row<Q, kMasks>(kMasks || code < Q ? code : -1, d);
    message<Q, kHamming>(d, ct, msg);
#pragma unroll
    for (int s = 0; s < Q; ++s) table[code * Q + s] = msg[s];
  }
  __syncthreads();
  if (site >= length) return;

  const int4* steps = plan + static_cast<size_t>(tree) * n_anc;
  float* col = table + kCodes * Q + 4 * threadIdx.x;
  const int* leaf_col = leaves + site;
  Fetched next = with_leaves(__ldg(steps), leaf_col, length);
  int4 after = n_anc > 1 ? __ldg(steps + 1) : next.step;
  float total[Q];
  for (int k = 0; k < n_anc; ++k) {
    const Fetched cur = next;
    if (k + 1 < n_anc) next = with_leaves(after, leaf_col, length);
    if (k + 2 < n_anc) after = __ldg(steps + k + 2);
    const int4 st = cur.step;
    const bool tab1 = kCodes > 0 && st.y >= 0, tab2 = kCodes > 0 && st.z >= 0;
    if (Q <= 8) {
      // Each child's message on its own: a table row or a message, fewest
      // instructions where C sits in registers.
      float m1[Q], m2[Q];
      if (tab1) {
        table_row<Q>(table, leaf_code<Q, kMasks>(cur.obs1), m1);
      } else {
        float d[Q];
        child_row<Q, kMasks>(st.y, cur.obs1, col, d);
        message<Q, kHamming>(d, ct, m1);
      }
      if (tab2) {
        table_row<Q>(table, leaf_code<Q, kMasks>(cur.obs2), m2);
      } else {
        float d[Q];
        child_row<Q, kMasks>(st.z, cur.obs2, col, d);
        message<Q, kHamming>(d, ct, m2);
      }
#pragma unroll
      for (int s = 0; s < Q; ++s) total[s] = __fadd_rn(m1[s], m2[s]);
    } else if (tab1 || tab2) {
      // A leaf child's message from the table; two other children together
      // (each cost loaded once for both).
      float ma[Q], mb[Q];
      table_row<Q>(table, leaf_code<Q, kMasks>(tab1 ? cur.obs1 : cur.obs2), ma);
      if (tab1 && tab2) {
        table_row<Q>(table, leaf_code<Q, kMasks>(cur.obs2), mb);
      } else {
        float d[Q];
        child_row<Q, kMasks>(tab1 ? st.z : st.y, tab1 ? cur.obs2 : cur.obs1, col, d);
        message<Q, kHamming>(d, ct, mb);
      }
#pragma unroll
      for (int s = 0; s < Q; ++s) total[s] = __fadd_rn(ma[s], mb[s]);
    } else {
      float d1[Q], d2[Q];
      child_row<Q, kMasks>(st.y, cur.obs1, col, d1);
      child_row<Q, kMasks>(st.z, cur.obs2, col, d2);
      combine<Q, kHamming>(d1, d2, ct, total);
    }
    if (k + 1 < n_anc) {  // the root row stays in registers
      float4* row = reinterpret_cast<float4*>(col) + cur.step.w * (Q / 4 * kSites);
#pragma unroll
      for (int c = 0; c < Q / 4; ++c) {
        row[c * kSites] = make_float4(total[4 * c], total[4 * c + 1], total[4 * c + 2],
                                      total[4 * c + 3]);
      }
    }
  }
  float best = total[0];
#pragma unroll
  for (int s = 1; s < Q; ++s) best = fminf(best, total[s]);
  per_site[static_cast<size_t>(tree) * length + site] = __fmul_rn(best, __ldg(weights + site));
}

// One child of a runtime-Q step: a leaf (its state `obs`) or an ancestor
// row (`row`, states `stride` apart).
struct Child {
  bool leaf;
  int obs;
  const float* row;
  __device__ __forceinline__ float at(int j, size_t stride, bool masks) const {
    return leaf ? (masks ? leaf_cost<true>(obs, j) : leaf_cost<false>(obs, j)) : row[j * stride];
  }
};

// This thread's tile of a general min-plus message: t[k] = min_j (C[s0 + k,
// j] + d[j]), each child value loaded once for the tile.
template <bool kMasks>
__device__ __forceinline__ void tile_message(const Child& c, int q, int pitch, const float* ct,
                                             int s0, size_t stride, float (&t)[kTile]) {
  {
    const float a = c.at(0, stride, kMasks);
#pragma unroll
    for (int v = 0; v < kTile; v += 4) {
      const float4 cv = lds4(ct + s0 + v);
      t[v] = __fadd_rn(cv.x, a);
      t[v + 1] = __fadd_rn(cv.y, a);
      t[v + 2] = __fadd_rn(cv.z, a);
      t[v + 3] = __fadd_rn(cv.w, a);
    }
  }
  for (int j = 1; j < q; ++j) {
    const float a = c.at(j, stride, kMasks);
    const float* cj = ct + j * pitch + s0;
#pragma unroll
    for (int v = 0; v < kTile; v += 4) {
      const float4 cv = lds4(cj + v);
      t[v] = fminf(t[v], __fadd_rn(cv.x, a));
      t[v + 1] = fminf(t[v + 1], __fadd_rn(cv.y, a));
      t[v + 2] = fminf(t[v + 2], __fadd_rn(cv.z, a));
      t[v + 3] = fminf(t[v + 3], __fadd_rn(cv.w, a));
    }
  }
}

// This thread's tile of a Hamming message: min(d[s], 1 + min d).
template <bool kMasks>
__device__ __forceinline__ void tile_hamming(const Child& c, int q, int s0, size_t stride,
                                             float (&t)[kTile]) {
  float m = c.at(0, stride, kMasks);
  for (int i = 1; i < q; ++i) m = fminf(m, c.at(i, stride, kMasks));
  const float up = __fadd_rn(1.0f, m);
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    t[k] = s0 + k < q ? fminf(c.at(s0 + k, stride, kMasks), up) : 0.0f;
  }
}

// Any Q: blocks of `sites` x tiles threads, thread (tile, site) =
// threadIdx.x / sites, % sites, computing parent states 16 * tile .. + 15
// of its site. Dynamic shared memory: Ct (q x pitch floats, pitch = q
// rounded up to 16; none in the Hamming mode), the leaf-message table
// ((q + 1) x pitch floats, `use_table` != 0: state mode, general costs),
// the root's per-tile minima (tiles x sites floats), then, in the shared
// mode, the slot columns (slots, q, sites); the global mode's slots are
// (chunk, slots, q, L) floats in `slots_g`.
template <bool kMasks, bool kHamming, bool kGlobal>
__global__ void __launch_bounds__(kMaxAnyThreads)
sankoff_any_kernel(const int4* __restrict__ plan, const int* __restrict__ leaves,
                   const float* __restrict__ cost, const float* __restrict__ weights,
                   float* __restrict__ slots_g, float* __restrict__ per_site,
                   int tree0, int n_leaves, int length, int q, int n_slots, int sites,
                   int use_table) {
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
  const size_t len = static_cast<size_t>(length);
  float* ct = smem;
  float* table = ct + (kHamming ? 0 : q * pitch);
  float* mins = table + (use_table ? (q + 1) * pitch : 0);
  float* cols = mins + tiles * sites;
  if (!kHamming) {
    stage_cost(cost, ct, q, pitch);
    __syncthreads();
    // table[code][s] = min_j (C[s, j] + leaf_cost(code, j)), code q: any other state.
    for (int e = threadIdx.x; use_table && e < (q + 1) * pitch; e += blockDim.x) {
      const int code = e / pitch, s = e % pitch;
      const int obs = code < q ? code : -1;
      float t = __fadd_rn(ct[s], leaf_cost<false>(obs, 0));
      for (int j = 1; j < q; ++j) {
        t = fminf(t, __fadd_rn(ct[j * pitch + s], leaf_cost<false>(obs, j)));
      }
      table[e] = t;
    }
    __syncthreads();
  }

  size_t stride, slot_stride;
  float* base;
  if (kGlobal) {
    base = slots_g + static_cast<size_t>(blockIdx.y) * n_slots * q * len + site;
    stride = len;
  } else {
    base = cols + lane;
    stride = static_cast<size_t>(sites);
  }
  slot_stride = static_cast<size_t>(q) * stride;
  const int4* steps = plan + static_cast<size_t>(tree) * n_anc;
  const int* leaf_col = leaves + site;
  const int4 first = __ldg(steps);
  Fetched next = active ? with_leaves(first, leaf_col, length) : Fetched{first, 0, 0};
  int4 after = n_anc > 1 ? __ldg(steps + 1) : first;
  float total[kTile];
  for (int k = 0; k < n_anc; ++k) {
    const Fetched cur = next;
    if (k + 1 < n_anc) next = active ? with_leaves(after, leaf_col, length) : Fetched{after, 0, 0};
    if (k + 2 < n_anc) after = __ldg(steps + k + 2);
    const Child c1{cur.step.y >= 0, cur.obs1,
                   cur.step.y >= 0 ? nullptr : base + ~cur.step.y * slot_stride};
    const Child c2{cur.step.z >= 0, cur.obs2,
                   cur.step.z >= 0 ? nullptr : base + ~cur.step.z * slot_stride};
    if (active) {
      float m1[kTile], m2[kTile];
      if (kHamming) {
        tile_hamming<kMasks>(c1, q, s0, stride, m1);
        tile_hamming<kMasks>(c2, q, s0, stride, m2);
      } else {
        const bool table1 = use_table && c1.leaf, table2 = use_table && c2.leaf;
        if (!table1) tile_message<kMasks>(c1, q, pitch, ct, s0, stride, m1);
        if (!table2) tile_message<kMasks>(c2, q, pitch, ct, s0, stride, m2);
        const int code1 = c1.obs >= 0 && c1.obs < q ? c1.obs : q;
        const int code2 = c2.obs >= 0 && c2.obs < q ? c2.obs : q;
#pragma unroll
        for (int v = 0; v < kTile; ++v) {
          if (table1) m1[v] = table[code1 * pitch + s0 + v];
          if (table2) m2[v] = table[code2 * pitch + s0 + v];
        }
      }
#pragma unroll
      for (int v = 0; v < kTile; ++v) total[v] = __fadd_rn(m1[v], m2[v]);
    }
    if (k + 1 == n_anc) break;  // the root row stays in registers
    __syncthreads();  // every tile has read the children
    if (active) {
      float* dst = base + cur.step.w * slot_stride;
#pragma unroll
      for (int v = 0; v < kTile; ++v) {
        if (s0 + v < q) dst[(s0 + v) * stride] = total[v];
      }
    }
    __syncthreads();  // the new row is in place
  }
  float best = total[0];
#pragma unroll
  for (int v = 1; v < kTile; ++v) {
    if (s0 + v < q) best = fminf(best, total[v]);
  }
  mins[tile * sites + lane] = best;
  __syncthreads();
  if (tile == 0 && active) {
    for (int t = 1; t < tiles; ++t) best = fminf(best, mins[t * sites + lane]);
    per_site[static_cast<size_t>(tree) * len + site] = __fmul_rn(best, __ldg(weights + site));
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
  const int* leaves;
  const float* cost;
  const float* weights;
  float* slots_g;
  float* per_site;
  int batch, n_leaves, length, q, n_slots, sites, chunk, smem, use_table;
  cudaStream_t stream;
};

template <int Q, bool kMasks, bool kHamming>
int launch_fixed(const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(sankoff_fixed_kernel<Q, kMasks, kHamming>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (a.length + kSites - 1) / kSites;
  for (int tree0 = 0; tree0 < a.batch; tree0 += a.chunk) {
    const int trees = a.batch - tree0 < a.chunk ? a.batch - tree0 : a.chunk;
    sankoff_fixed_kernel<Q, kMasks, kHamming>
        <<<dim3(n_blocks, trees), kSites, a.smem, a.stream>>>(
            a.plan, a.leaves, a.cost, a.weights, a.per_site, tree0, a.n_leaves, a.length);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <bool kMasks, bool kHamming, bool kGlobal>
int launch_any(const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(sankoff_any_kernel<kMasks, kHamming, kGlobal>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.q + kTile - 1) / kTile;
  const int n_blocks = (a.length + a.sites - 1) / a.sites;
  for (int tree0 = 0; tree0 < a.batch; tree0 += a.chunk) {
    const int trees = a.batch - tree0 < a.chunk ? a.batch - tree0 : a.chunk;
    sankoff_any_kernel<kMasks, kHamming, kGlobal>
        <<<dim3(n_blocks, trees), a.sites * tiles, a.smem, a.stream>>>(
            a.plan, a.leaves, a.cost, a.weights, a.slots_g, a.per_site, tree0, a.n_leaves,
            a.length, a.q, a.n_slots, a.sites, a.use_table);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <bool kMasks, bool kHamming>
int dispatch_q(const Args& a, bool global) {
  if (a.q == 4) return launch_fixed<4, kMasks, kHamming>(a);
  if (a.q == 20) return launch_fixed<20, kMasks, kHamming>(a);
  return global ? launch_any<kMasks, kHamming, true>(a) : launch_any<kMasks, kHamming, false>(a);
}

}  // namespace

// plan (B, n_anc, 4) int32 from csrc/tree_plan.cu, 16-byte aligned; leaves
// (n_leaves, L) int32 states, or state-set bitmasks when `masks` != 0 (q <=
// 32); cost (q, q) f32 [parent, child]; weights (L,) f32; per_site (B, L)
// f32 scratch; out (B,) f32; n_leaves x L < 2^31. `hamming` != 0 takes the
// closed-form messages (cost must be ones - eye). Blocks of `sites` sites
// (q = 4, 20: 128, a thread each; any other q: ceil(q / 16) threads each,
// at most 512 a block) with
// `smem` bytes of dynamic shared memory, laid out as the kernels above
// say, `n_slots` slot rows a site; `global_slots` != 0 (runtime-Q kernel
// only) keeps the slots in slots_g, (chunk, n_slots, q, L) f32;
// `use_table` != 0 (runtime-Q kernel, state mode, general costs) keeps the
// leaf-message table. Trees are walked `chunk` at a time (chunk <= 65535).
// Launches on `stream`, does not synchronise, allocates nothing. Returns
// the CUDA error code (0 = launched).
extern "C" int trex_sankoff_batched(const void* plan, const void* leaves, const void* cost,
                                    const void* weights, void* slots_g, void* per_site,
                                    void* out, int batch, int n_leaves, int length,
                                    int n_states, int masks, int hamming, int n_slots,
                                    int sites, int global_slots, int use_table, int chunk,
                                    int smem, void* stream) {
  const Args a{static_cast<const int4*>(plan), static_cast<const int*>(leaves),
               static_cast<const float*>(cost), static_cast<const float*>(weights),
               static_cast<float*>(slots_g), static_cast<float*>(per_site),
               batch, n_leaves, length, n_states, n_slots, sites, chunk, smem, use_table,
               static_cast<cudaStream_t>(stream)};
  const bool global = global_slots != 0;
  int rc;
  if (masks != 0) {
    rc = hamming != 0 ? dispatch_q<true, true>(a, global) : dispatch_q<true, false>(a, global);
  } else {
    rc = hamming != 0 ? dispatch_q<false, true>(a, global) : dispatch_q<false, false>(a, global);
  }
  if (rc != 0) return rc;
  sum_sites_kernel<<<batch, kSumThreads, 0, a.stream>>>(
      static_cast<const float*>(per_site), static_cast<float*>(out), length);
  return static_cast<int>(cudaGetLastError());
}
