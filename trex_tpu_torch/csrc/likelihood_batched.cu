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
// atomics, so a run reproduces itself bit for bit. Q is a template
// parameter (4 and 20), so the state loops unroll into registers.

#include <cuda_runtime.h>

namespace {

constexpr int kSumThreads = 128;  // sites per pairwise block of the site sum
constexpr int kSites = 128;       // sites (threads) per block of the pruning kernel
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
  float* per_site;
  int batch, n_leaves, length, chunk, smem;
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

template <int Q>
int dispatch(const Args& a, bool shared, bool masks) {
  if (shared) return masks ? launch_chunks<Q, true, true>(a) : launch_chunks<Q, true, false>(a);
  return masks ? launch_chunks<Q, false, true>(a) : launch_chunks<Q, false, false>(a);
}

}  // namespace

// plan (B, n_anc, 4) int32 from csrc/tree_plan.cu, 16-byte aligned;
// children (B, n_anc, 2) int32, 8-byte aligned (read for per-branch P);
// leaves (n_leaves, L) int32 states (negative = missing) or state-set
// masks (`masks` != 0), n_leaves x L < 2^31; pmats (Q, Q) f32 when
// `shared` != 0, else (B, n_all, Q, Q) f32, 16-byte aligned; prior (Q,)
// f32; weights (L,) f32; per_site (B, L) f32 scratch; out (B,) f32. Blocks
// of 128 threads, one a site, with `smem` bytes of dynamic shared memory (a
// shared P, the leaf-message table, then the slot columns: the wrapper's
// launch plan). Trees are walked
// `chunk` at a time (chunk <= 65535). Q must be 4 or 20. Launches on
// `stream`, does not synchronise, allocates nothing. Returns the CUDA error
// code (0 = launched; -1 = unsupported Q).
extern "C" int trex_likelihood_batched(const void* plan, const void* children,
                                       const void* leaves, const void* pmats,
                                       const void* prior, const void* weights,
                                       void* per_site, void* out, int batch, int n_leaves,
                                       int length, int n_states, int shared, int masks,
                                       int chunk, int smem, void* stream) {
  const Args a{static_cast<const int4*>(plan),    static_cast<const int2*>(children),
               static_cast<const int*>(leaves),   static_cast<const float*>(pmats),
               static_cast<const float*>(prior),  static_cast<const float*>(weights),
               static_cast<float*>(per_site),     batch, n_leaves, length, chunk, smem,
               static_cast<cudaStream_t>(stream)};
  int rc;
  if (n_states == 4) {
    rc = dispatch<4>(a, shared != 0, masks != 0);
  } else if (n_states == 20) {
    rc = dispatch<20>(a, shared != 0, masks != 0);
  } else {
    return -1;
  }
  if (rc != 0) return rc;
  sum_sites_kernel<<<batch, kSumThreads, 0, a.stream>>>(
      static_cast<const float*>(per_site), static_cast<float*>(out), length);
  return static_cast<int>(cudaGetLastError());
}
