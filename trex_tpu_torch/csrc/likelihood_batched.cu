// K3/K4 — Felsenstein pruning log-likelihood of B trees on one alignment,
// with exact power-of-two rescaling. For each tree, each ancestor a (in
// index order, children before parents) gets
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
// other layouts (nodes, mxu) are TPU scheduling variants of it.
//
// What bounds it on this card: its inputs are small (children, the leaf
// table, P), so the byte floor is tiny and the floor is the arithmetic:
// about 2 * 2Q^2 multiply-adds for the two messages plus ~3Q for the
// combine, max and scale, per tree, ancestor and site. Its own traffic is
// larger: every ancestor's (Q, site) partial is written once to global
// scratch and read once by its parent, 3Q floats per tree, ancestor and
// site, most of it from HBM once a chunk of trees outgrows the 50 MB L2.
//
// What the design does about it: one thread per (tree, site). A thread
// walks the tree's whole ancestor chain for its site with no block
// synchronisation; all threads of a block share one tree, so the child
// indices and (per-branch) P loads are uniform broadcasts, and a shared P
// sits in shared memory. Tip partials are computed from the leaf table on
// the fly, so scratch holds ancestors only, laid out (tree, ancestor,
// state, site) with sites contiguous: every partial access of a warp is
// one coalesced 128-byte transaction. The root partial never leaves
// registers. Trees are walked in chunks over a scratch buffer the wrapper
// bounds. The site sum is deterministic: a fixed-shape shared-memory tree
// in each block writes one partial per (tree, site block), and a second
// kernel adds a tree's block partials in index order — no float atomics,
// so a run reproduces itself bit for bit. Q is a template parameter (4 and
// 20), so the state loops unroll into registers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kLn2 = 0.6931471805599453f;

// Tip partial of leaf `leaf` at `site`: 1 at every allowed state.
template <int Q, bool kMasks>
__device__ __forceinline__ void tip_partial(const int* __restrict__ leaves,
                                            int leaf, size_t length, int site,
                                            float (&d)[Q]) {
  const int obs = __ldg(leaves + leaf * length + site);
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const bool allowed = kMasks ? ((obs >> i) & 1) != 0 : (obs == i || obs < 0);
    d[i] = allowed ? 1.0f : 0.0f;
  }
}

// Message P_c d_c of child `c` into its parent, at `site`.
template <int Q, bool kShared, bool kMasks>
__device__ __forceinline__ void message(int c, int tree, int n_leaves,
                                        int n_all, size_t length, int site,
                                        const int* __restrict__ leaves,
                                        const float* part,
                                        const float* __restrict__ pmats,
                                        const float* p_shared, float (&m)[Q]) {
  float d[Q];
  if (c < n_leaves) {
    tip_partial<Q, kMasks>(leaves, c, length, site, d);
  } else {
    // Written earlier by this thread (same tree, same site): plain loads.
    const float* row = part + static_cast<size_t>(c - n_leaves) * Q * length + site;
#pragma unroll
    for (int i = 0; i < Q; ++i) d[i] = row[i * length];
  }
  const float* p = kShared
      ? p_shared
      : pmats + (static_cast<size_t>(tree) * n_all + c) * Q * Q;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    float acc = (kShared ? p[i * Q] : __ldg(p + i * Q)) * d[0];
#pragma unroll
    for (int j = 1; j < Q; ++j) {
      acc += (kShared ? p[i * Q + j] : __ldg(p + i * Q + j)) * d[j];
    }
    m[i] = acc;
  }
}

template <int Q, bool kShared, bool kMasks>
__global__ void __launch_bounds__(kThreads)
pruning_kernel(const int* __restrict__ children,  // (B, n_anc, 2)
               const int* __restrict__ leaves,    // (n_leaves, L)
               const float* __restrict__ pmats,   // (Q, Q) or (B, n_all, Q, Q)
               const float* __restrict__ prior,   // (Q,)
               const float* __restrict__ weights, // (L,)
               float* __restrict__ scratch,       // (chunk, n_anc, Q, L)
               float* __restrict__ block_sums,    // (B, gridDim.x)
               int tree0, int n_leaves, int length) {
  __shared__ float p_shared[kShared ? Q * Q : 1];
  __shared__ float partial_sums[kThreads];
  const int tree = tree0 + blockIdx.y;
  const int site = blockIdx.x * kThreads + threadIdx.x;
  const int n_anc = n_leaves - 1;
  const int n_all = 2 * n_leaves - 1;
  const size_t len = static_cast<size_t>(length);
  if (kShared) {
    for (int k = threadIdx.x; k < Q * Q; k += kThreads) p_shared[k] = pmats[k];
    __syncthreads();
  }

  float value = 0.0f;
  if (site < length) {
    const int* ch = children + static_cast<size_t>(tree) * n_anc * 2;
    float* part = scratch + static_cast<size_t>(blockIdx.y) * n_anc * Q * len;
    int exp_sum = 0;
    float root[Q];
    for (int a = 0; a < n_anc; ++a) {
      const int c1 = __ldg(ch + 2 * a);
      const int c2 = __ldg(ch + 2 * a + 1);
      float m1[Q], m2[Q];
      message<Q, kShared, kMasks>(c1, tree, n_leaves, n_all, len, site, leaves,
                                  part, pmats, p_shared, m1);
      message<Q, kShared, kMasks>(c2, tree, n_leaves, n_all, len, site, leaves,
                                  part, pmats, p_shared, m2);
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
      float* row = part + static_cast<size_t>(a) * Q * len + site;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        root[i] = m1[i] * inv;
        row[i * len] = root[i];
      }
    }
    float site_lik = __ldg(prior) * root[0];
#pragma unroll
    for (int i = 1; i < Q; ++i) site_lik += __ldg(prior + i) * root[i];
    const float per_site =
        logf(fmaxf(site_lik, 1e-30f)) + static_cast<float>(exp_sum) * kLn2;
    value = per_site * __ldg(weights + site);
  }

  partial_sums[threadIdx.x] = value;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      partial_sums[threadIdx.x] += partial_sums[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    block_sums[static_cast<size_t>(tree) * gridDim.x + blockIdx.x] = partial_sums[0];
  }
}

// out[b] = sum of tree b's site-block partials, in block order.
__global__ void __launch_bounds__(kThreads)
sum_blocks_kernel(const float* __restrict__ block_sums, float* __restrict__ out,
                  int batch, int n_blocks) {
  const int tree = blockIdx.x * kThreads + threadIdx.x;
  if (tree >= batch) return;
  const float* row = block_sums + static_cast<size_t>(tree) * n_blocks;
  float total = 0.0f;
  for (int k = 0; k < n_blocks; ++k) total += row[k];
  out[tree] = total;
}

template <int Q, bool kShared, bool kMasks>
int launch_chunks(const int* children, const int* leaves, const float* pmats,
                  const float* prior, const float* weights, float* scratch,
                  float* block_sums, int batch, int n_leaves, int length,
                  int chunk, cudaStream_t stream) {
  const int n_blocks = (length + kThreads - 1) / kThreads;
  for (int tree0 = 0; tree0 < batch; tree0 += chunk) {
    const int trees = batch - tree0 < chunk ? batch - tree0 : chunk;
    pruning_kernel<Q, kShared, kMasks>
        <<<dim3(n_blocks, trees), kThreads, 0, stream>>>(
            children, leaves, pmats, prior, weights, scratch, block_sums,
            tree0, n_leaves, length);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int Q>
int dispatch(bool shared, bool masks, const int* children, const int* leaves,
             const float* pmats, const float* prior, const float* weights,
             float* scratch, float* block_sums, int batch, int n_leaves,
             int length, int chunk, cudaStream_t stream) {
  if (shared) {
    return masks ? launch_chunks<Q, true, true>(children, leaves, pmats, prior,
                                                weights, scratch, block_sums,
                                                batch, n_leaves, length, chunk, stream)
                 : launch_chunks<Q, true, false>(children, leaves, pmats, prior,
                                                 weights, scratch, block_sums,
                                                 batch, n_leaves, length, chunk, stream);
  }
  return masks ? launch_chunks<Q, false, true>(children, leaves, pmats, prior,
                                               weights, scratch, block_sums,
                                               batch, n_leaves, length, chunk, stream)
               : launch_chunks<Q, false, false>(children, leaves, pmats, prior,
                                                weights, scratch, block_sums,
                                                batch, n_leaves, length, chunk, stream);
}

}  // namespace

// children (B, n_anc, 2) int32; leaves (n_leaves, L) int32 states (negative
// = missing) or state-set masks (`masks` != 0); pmats (Q, Q) f32 when
// `shared` != 0, else (B, n_all, Q, Q) f32; prior (Q,) f32; weights (L,)
// f32; scratch (chunk, n_anc, Q, L) f32; block_sums (B, ceil(L / 128)) f32;
// out (B,) f32. Trees are walked `chunk` at a time (chunk <= 65535). Q must
// be 4 or 20. Launches on `stream`, does not synchronise, allocates
// nothing. Returns the CUDA error code (0 = launched; -1 = unsupported Q).
extern "C" int trex_likelihood_batched(const void* children, const void* leaves,
                                       const void* pmats, const void* prior,
                                       const void* weights, void* scratch,
                                       void* block_sums, void* out, int batch,
                                       int n_leaves, int length, int n_states,
                                       int shared, int masks, int chunk,
                                       void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ch = static_cast<const int*>(children);
  const auto* lv = static_cast<const int*>(leaves);
  const auto* pm = static_cast<const float*>(pmats);
  const auto* pr = static_cast<const float*>(prior);
  const auto* w = static_cast<const float*>(weights);
  auto* sc = static_cast<float*>(scratch);
  auto* bs = static_cast<float*>(block_sums);
  int rc;
  if (n_states == 4) {
    rc = dispatch<4>(shared != 0, masks != 0, ch, lv, pm, pr, w, sc, bs, batch,
                     n_leaves, length, chunk, s);
  } else if (n_states == 20) {
    rc = dispatch<20>(shared != 0, masks != 0, ch, lv, pm, pr, w, sc, bs, batch,
                      n_leaves, length, chunk, s);
  } else {
    return -1;
  }
  if (rc != 0) return rc;
  const int n_blocks = (length + kThreads - 1) / kThreads;
  sum_blocks_kernel<<<(batch + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      bs, static_cast<float*>(out), batch, n_blocks);
  return static_cast<int>(cudaGetLastError());
}
