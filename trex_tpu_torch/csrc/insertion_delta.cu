// K2 — the join penalties of one stepwise insertion: for the inserted leaf
// t, delta[v] = sum over sites of w * [(up[t] & ctx[v]) == 0], where ctx is
// the Fitch-combined up/down context of the edge above v in the pruned
// variant tree.
//
// Replaces: trex_tpu/ops/insertion_pallas.py `_insertion_kernel`, reached
// through `insertion_delta_pallas` from every step of the stepwise-addition
// loop (trex_tpu/search/stepwise.py `_stepwise_block`).
//
// What bounds it on this card: the inputs it must read are the (n_all, L)
// up table and the children, so its floor is about 4 * n_all * L bytes of
// device memory. Its own traffic is larger: the down pass makes about five
// int32 row accesses per ancestor per site (read down[node], read the two
// up rows, write the two child rows), and the delta pass reads up and down
// once more. At 512 taxa x 2048 sites the (n_all, L) down table is 8 MB and
// sits in the 50 MB L2, so the kernel is L2-bandwidth and -latency bound:
// each ancestor step waits on the row its parent step wrote.
//
// What the design does about it: one thread per site. Sites are
// independent all the way through the down pass, so a thread walks the
// ancestors root -> leaves on its own column with no block
// synchronisation; the down table is global scratch with sites
// contiguous, so every row access of a warp is one coalesced 128-byte
// transaction. Pass-through rows (c1 == c2, the pruned node's parent) write
// the forwarded context to both slots. After the walk each warp (= block)
// computes its 32 sites' terms for every v, reduces them with shuffles and
// adds one float per node into delta[v] with atomicAdd: exact for integer
// weights whose totals stay below 2^24, so the result is bit-equal to the
// plain version whatever the order of the atomics. Blocks are one warp
// wide so that a 2048-site alignment still spreads over 64 SMs.

#include <cuda_runtime.h>

namespace {

// Fitch combine with 0 = "no information" (ops/spr_scan.py `_combine0`).
__device__ __forceinline__ int combine0(int a, int b) {
  const int inter = a & b;
  int merged = inter == 0 ? (a | b) : inter;
  merged = a == 0 ? b : merged;
  return b == 0 ? a : merged;
}

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
insertion_delta_kernel(const int* __restrict__ var_children,
                       const int* __restrict__ up,
                       const float* __restrict__ weights,
                       int* __restrict__ down, float* __restrict__ delta,
                       int n_leaves, int length, int t_node) {
  const int site = blockIdx.x * kThreads + threadIdx.x;
  const int n_all = 2 * n_leaves - 1;
  const bool active = site < length;
  const size_t stride = static_cast<size_t>(length);

  if (active) {
    // Rows never written by the walk (the root, the pruned node) read as 0.
    for (int v = 0; v < n_all; ++v) down[v * stride + site] = 0;
    for (int a = n_leaves - 2; a >= 0; --a) {
      const int c1 = __ldg(var_children + 2 * a);
      const int c2 = __ldg(var_children + 2 * a + 1);
      const int d = down[(n_leaves + a) * stride + site];
      if (c1 == c2) {
        down[c1 * stride + site] = d;
      } else {
        const int u1 = __ldg(up + c1 * stride + site);
        const int u2 = __ldg(up + c2 * stride + site);
        down[c1 * stride + site] = combine0(d, u2);
        down[c2 * stride + site] = combine0(d, u1);
      }
    }
  }
  const int tset = active ? __ldg(up + t_node * stride + site) : 0;
  const float w = active ? __ldg(weights + site) : 0.0f;
  for (int v = 0; v < n_all; ++v) {
    float term = 0.0f;
    if (active) {
      const int ctx = combine0(__ldg(up + v * stride + site), down[v * stride + site]);
      term = (tset & ctx) == 0 ? w : 0.0f;
    }
    for (int offset = 16; offset > 0; offset >>= 1) {
      term += __shfl_down_sync(0xffffffffu, term, offset);
    }
    if (threadIdx.x == 0 && term != 0.0f) atomicAdd(delta + v, term);
  }
}

}  // namespace

// var_children (n_anc, 2) int32, up (n_all, L) int32 flagless up sets,
// weights (L,) f32, down (n_all, L) int32 scratch, delta (n_all,) f32
// zero-filled by the caller. Launches on `stream`, does not synchronise,
// allocates nothing. Returns the CUDA error code (0 = launched).
extern "C" int trex_insertion_delta(const void* var_children, const void* up,
                                    const void* weights, void* down, void* delta,
                                    int n_leaves, int length, int t_node,
                                    void* stream) {
  const int blocks = (length + kThreads - 1) / kThreads;
  insertion_delta_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(var_children), static_cast<const int*>(up),
      static_cast<const float*>(weights), static_cast<int*>(down),
      static_cast<float*>(delta), n_leaves, length, t_node);
  return static_cast<int>(cudaGetLastError());
}
