// K5 — exact Sankoff (min-plus) parsimony scores of B trees on one
// alignment under a general (Q, Q) cost matrix C[parent_state, child_state].
// Each leaf row is 0 at the observed state (or at every allowed state of a
// state-set bitmask) and 1e5 elsewhere; each ancestor, in index order
// (children before parents), gets
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
// TPU scheduling and are not carried over.
//
// What bounds it on this card: the inputs are small (children, the leaf
// table, C, the weights), so the byte floor is tiny and the floor is the
// arithmetic: per tree, ancestor and site, 2 children x Q^2 x (add + min)
// for the general messages (2 x ~3Q in the Hamming mode) plus Q adds to
// combine them. Its own traffic is larger: every ancestor's (Q, site) row
// is written once to global scratch and read once by its parent.
//
// What the design does about it: one thread per (tree, site) walks the
// tree's whole ancestor chain for its site with no block synchronisation;
// all threads of a block share one tree, so child indices are uniform
// broadcasts and C sits in shared memory. Leaf rows are computed from the
// leaf table on the fly, never stored; ancestor rows live in global scratch
// laid out (tree, ancestor, state, site), sites contiguous, so every access
// of a warp is one coalesced transaction; the root row never leaves the
// thread. Trees are walked in chunks over a scratch buffer the wrapper
// bounds. Q = 4 and Q = 20 are template parameters, so the child rows and
// the messages stay in registers; every other Q takes one runtime-Q kernel
// that stages each thread's two child rows in its own column of dynamic
// shared memory (2 x Q x 128 floats) beside C (Q^2 floats), opting in above
// 48 KB. The site sum is deterministic: `min * w` is a separate rounded
// multiply (no FMA contraction), a fixed-shape shared-memory tree in each
// block writes one partial per (tree, 128-site block), and a second kernel
// adds a tree's partials in block order — no float atomics, so non-integer
// costs give the same low bits on every run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kBig = 1e5f;

template <bool kMasks>
__device__ __forceinline__ float leaf_cost(int obs, int state) {
  const bool allowed = kMasks ? ((obs >> state) & 1) != 0 : obs == state;
  return allowed ? 0.0f : kBig;
}

// Child row d of node `c` at `site`: computed from the leaf table for a
// leaf, read from scratch (written earlier by this thread) for an ancestor.
template <int Q, bool kMasks>
__device__ __forceinline__ void child_row(int c, int n_leaves, size_t len, int site,
                                          const int* __restrict__ leaves,
                                          const float* part, float (&d)[Q]) {
  if (c < n_leaves) {
    const int obs = __ldg(leaves + static_cast<size_t>(c) * len + site);
#pragma unroll
    for (int i = 0; i < Q; ++i) d[i] = leaf_cost<kMasks>(obs, i);
  } else {
    const float* row = part + static_cast<size_t>(c - n_leaves) * Q * len + site;
#pragma unroll
    for (int i = 0; i < Q; ++i) d[i] = row[i * len];
  }
}

// C[k] from shared memory. A small matrix may stay in registers across the
// ancestor loop; a large one is re-read at each use (volatile), since
// hoisting all Q^2 values out of the loop spills them to local memory.
template <int Q>
__device__ __forceinline__ float cost_at(const float* c_sh, int k) {
  if (Q <= 8) return c_sh[k];
  return *static_cast<const volatile float*>(c_sh + k);
}

// total[s] = msg_1[s] + msg_2[s] for the two child rows d1, d2, where
// msg[s] = min_{s'} (C[s, s'] + d[s']) or the Hamming closed form
// min(d[s], 1 + min d).
template <int Q, bool kHamming>
__device__ __forceinline__ void combine(const float (&d1)[Q], const float (&d2)[Q],
                                        const float* c_sh, float (&total)[Q]) {
  if (kHamming) {
    float m1 = d1[0], m2 = d2[0];
#pragma unroll
    for (int i = 1; i < Q; ++i) {
      m1 = fminf(m1, d1[i]);
      m2 = fminf(m2, d2[i]);
    }
    const float up1 = __fadd_rn(1.0f, m1);
    const float up2 = __fadd_rn(1.0f, m2);
#pragma unroll
    for (int s = 0; s < Q; ++s) total[s] = __fadd_rn(fminf(d1[s], up1), fminf(d2[s], up2));
  } else {
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      const float c0 = cost_at<Q>(c_sh, s * Q);
      float t1 = __fadd_rn(c0, d1[0]);
      float t2 = __fadd_rn(c0, d2[0]);
#pragma unroll
      for (int j = 1; j < Q; ++j) {
        const float c = cost_at<Q>(c_sh, s * Q + j);
        t1 = fminf(t1, __fadd_rn(c, d1[j]));
        t2 = fminf(t2, __fadd_rn(c, d2[j]));
      }
      total[s] = __fadd_rn(t1, t2);
    }
  }
}

// One block: 128 sites of one tree. Writes the block's weighted partial.
__device__ __forceinline__ void block_partial(float value, float* partial_sums,
                                              float* block_sums, int tree) {
  partial_sums[threadIdx.x] = value;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      partial_sums[threadIdx.x] =
          __fadd_rn(partial_sums[threadIdx.x], partial_sums[threadIdx.x + stride]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    block_sums[static_cast<size_t>(tree) * gridDim.x + blockIdx.x] = partial_sums[0];
  }
}

template <int Q, bool kMasks, bool kHamming>
__global__ void __launch_bounds__(kThreads)
sankoff_fixed_kernel(const int* __restrict__ children,  // (B, n_anc, 2)
                     const int* __restrict__ leaves,    // (n_leaves, L)
                     const float* __restrict__ cost,    // (Q, Q)
                     const float* __restrict__ weights, // (L,)
                     float* __restrict__ scratch,       // (chunk, n_anc, Q, L)
                     float* __restrict__ block_sums,    // (B, gridDim.x)
                     int tree0, int n_leaves, int length) {
  __shared__ float c_sh[Q * Q];
  __shared__ float partial_sums[kThreads];
  const int tree = tree0 + blockIdx.y;
  const int site = blockIdx.x * kThreads + threadIdx.x;
  const int n_anc = n_leaves - 1;
  const size_t len = static_cast<size_t>(length);
  for (int k = threadIdx.x; k < Q * Q; k += kThreads) c_sh[k] = cost[k];
  __syncthreads();

  float value = 0.0f;
  if (site < length) {
    const int* ch = children + static_cast<size_t>(tree) * n_anc * 2;
    float* part = scratch + static_cast<size_t>(blockIdx.y) * n_anc * Q * len;
    float total[Q];
    for (int a = 0; a < n_anc; ++a) {
      const int c1 = __ldg(ch + 2 * a);
      const int c2 = __ldg(ch + 2 * a + 1);
      float d1[Q], d2[Q];
      child_row<Q, kMasks>(c1, n_leaves, len, site, leaves, part, d1);
      child_row<Q, kMasks>(c2, n_leaves, len, site, leaves, part, d2);
      combine<Q, kHamming>(d1, d2, c_sh, total);
      if (a + 1 < n_anc) {  // the root row stays in registers
        float* row = part + static_cast<size_t>(a) * Q * len + site;
#pragma unroll
        for (int s = 0; s < Q; ++s) row[s * len] = total[s];
      }
    }
    float best = total[0];
#pragma unroll
    for (int s = 1; s < Q; ++s) best = fminf(best, total[s]);
    value = __fmul_rn(best, __ldg(weights + site));
  }
  block_partial(value, partial_sums, block_sums, tree);
}

// Any Q: each thread stages its two child rows in its own column of
// dynamic shared memory, (2, q, kThreads) floats after C's q * q.
template <bool kMasks, bool kHamming>
__global__ void __launch_bounds__(kThreads)
sankoff_any_kernel(const int* __restrict__ children, const int* __restrict__ leaves,
                   const float* __restrict__ cost, const float* __restrict__ weights,
                   float* __restrict__ scratch, float* __restrict__ block_sums,
                   int tree0, int n_leaves, int length, int q) {
  extern __shared__ float smem[];
  float* c_sh = smem;
  float* d1 = smem + q * q + threadIdx.x;  // d1[i * kThreads]: state i
  float* d2 = d1 + q * kThreads;
  __shared__ float partial_sums[kThreads];
  const int tree = tree0 + blockIdx.y;
  const int site = blockIdx.x * kThreads + threadIdx.x;
  const int n_anc = n_leaves - 1;
  const size_t len = static_cast<size_t>(length);
  for (int k = threadIdx.x; k < q * q; k += kThreads) c_sh[k] = cost[k];
  __syncthreads();

  float value = 0.0f;
  if (site < length) {
    const int* ch = children + static_cast<size_t>(tree) * n_anc * 2;
    float* part = scratch + static_cast<size_t>(blockIdx.y) * n_anc * q * len;
    float best = 0.0f;
    for (int a = 0; a < n_anc; ++a) {
      const int cs[2] = {__ldg(ch + 2 * a), __ldg(ch + 2 * a + 1)};
      float ups[2] = {0.0f, 0.0f};  // Hamming mode: 1 + min of each child row
      for (int k = 0; k < 2; ++k) {
        float* d = k == 0 ? d1 : d2;
        const int c = cs[k];
        if (c < n_leaves) {
          const int obs = __ldg(leaves + static_cast<size_t>(c) * len + site);
          for (int i = 0; i < q; ++i) d[i * kThreads] = leaf_cost<kMasks>(obs, i);
        } else {
          const float* row = part + static_cast<size_t>(c - n_leaves) * q * len + site;
          for (int i = 0; i < q; ++i) d[i * kThreads] = row[i * len];
        }
        if (kHamming) {
          float m = d[0];
          for (int i = 1; i < q; ++i) m = fminf(m, d[i * kThreads]);
          ups[k] = __fadd_rn(1.0f, m);
        }
      }
      float* row = part + static_cast<size_t>(a) * q * len + site;
      const bool is_root = a + 1 == n_anc;
      for (int s = 0; s < q; ++s) {
        float t1, t2;
        if (kHamming) {
          t1 = fminf(d1[s * kThreads], ups[0]);
          t2 = fminf(d2[s * kThreads], ups[1]);
        } else {
          const float* cs_row = c_sh + s * q;
          t1 = __fadd_rn(cs_row[0], d1[0]);
          t2 = __fadd_rn(cs_row[0], d2[0]);
          for (int j = 1; j < q; ++j) {
            const float c = cs_row[j];
            t1 = fminf(t1, __fadd_rn(c, d1[j * kThreads]));
            t2 = fminf(t2, __fadd_rn(c, d2[j * kThreads]));
          }
        }
        const float total = __fadd_rn(t1, t2);
        if (is_root) {
          best = s == 0 ? total : fminf(best, total);
        } else {
          row[s * len] = total;
        }
      }
    }
    value = __fmul_rn(best, __ldg(weights + site));
  }
  block_partial(value, partial_sums, block_sums, tree);
}

// out[b] = sum of tree b's site-block partials, in block order.
__global__ void __launch_bounds__(kThreads)
sum_blocks_kernel(const float* __restrict__ block_sums, float* __restrict__ out,
                  int batch, int n_blocks) {
  const int tree = blockIdx.x * kThreads + threadIdx.x;
  if (tree >= batch) return;
  const float* row = block_sums + static_cast<size_t>(tree) * n_blocks;
  float total = 0.0f;
  for (int k = 0; k < n_blocks; ++k) total = __fadd_rn(total, row[k]);
  out[tree] = total;
}

struct Args {
  const int* children;
  const int* leaves;
  const float* cost;
  const float* weights;
  float* scratch;
  float* block_sums;
  int batch, n_leaves, length, q, chunk;
  cudaStream_t stream;
};

template <int Q, bool kMasks, bool kHamming>
int launch_fixed(const Args& a) {
  const int n_blocks = (a.length + kThreads - 1) / kThreads;
  for (int tree0 = 0; tree0 < a.batch; tree0 += a.chunk) {
    const int trees = a.batch - tree0 < a.chunk ? a.batch - tree0 : a.chunk;
    sankoff_fixed_kernel<Q, kMasks, kHamming>
        <<<dim3(n_blocks, trees), kThreads, 0, a.stream>>>(
            a.children, a.leaves, a.cost, a.weights, a.scratch, a.block_sums,
            tree0, a.n_leaves, a.length);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <bool kMasks, bool kHamming>
int launch_any(const Args& a) {
  const size_t smem = (static_cast<size_t>(a.q) * a.q + 2 * a.q * kThreads) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sankoff_any_kernel<kMasks, kHamming>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (a.length + kThreads - 1) / kThreads;
  for (int tree0 = 0; tree0 < a.batch; tree0 += a.chunk) {
    const int trees = a.batch - tree0 < a.chunk ? a.batch - tree0 : a.chunk;
    sankoff_any_kernel<kMasks, kHamming>
        <<<dim3(n_blocks, trees), kThreads, smem, a.stream>>>(
            a.children, a.leaves, a.cost, a.weights, a.scratch, a.block_sums,
            tree0, a.n_leaves, a.length, a.q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <bool kMasks, bool kHamming>
int dispatch_q(const Args& a) {
  if (a.q == 4) return launch_fixed<4, kMasks, kHamming>(a);
  if (a.q == 20) return launch_fixed<20, kMasks, kHamming>(a);
  return launch_any<kMasks, kHamming>(a);
}

}  // namespace

// children (B, n_anc, 2) int32; leaves (n_leaves, L) int32 states, or
// state-set bitmasks when `masks` != 0 (q <= 32); cost (q, q) f32
// [parent, child]; weights (L,) f32; scratch (chunk, n_anc, q, L) f32;
// block_sums (B, ceil(L / 128)) f32; out (B,) f32. `hamming` != 0 takes the
// closed-form messages (cost must be ones - eye). Trees are walked `chunk`
// at a time (chunk <= 65535). A q other than 4 and 20 needs
// (q * q + 256 * q) * 4 bytes of shared memory per block. Launches on
// `stream`, does not synchronise, allocates nothing. Returns the CUDA error
// code (0 = launched).
extern "C" int trex_sankoff_batched(const void* children, const void* leaves,
                                    const void* cost, const void* weights,
                                    void* scratch, void* block_sums, void* out,
                                    int batch, int n_leaves, int length, int n_states,
                                    int masks, int hamming, int chunk, void* stream) {
  const Args a{static_cast<const int*>(children), static_cast<const int*>(leaves),
               static_cast<const float*>(cost),   static_cast<const float*>(weights),
               static_cast<float*>(scratch),      static_cast<float*>(block_sums),
               batch, n_leaves, length, n_states, chunk,
               static_cast<cudaStream_t>(stream)};
  int rc;
  if (masks != 0) {
    rc = hamming != 0 ? dispatch_q<true, true>(a) : dispatch_q<true, false>(a);
  } else {
    rc = hamming != 0 ? dispatch_q<false, true>(a) : dispatch_q<false, false>(a);
  }
  if (rc != 0) return rc;
  const int n_blocks = (length + kThreads - 1) / kThreads;
  sum_blocks_kernel<<<(batch + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
      static_cast<const float*>(block_sums), static_cast<float*>(out), batch, n_blocks);
  return static_cast<int>(cudaGetLastError());
}
