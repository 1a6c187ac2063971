// K1 — batched unit-cost Fitch parsimony: the scores of B trees on one
// alignment of state-set bitmasks.
//
// Replaces: trex_tpu/ops/sankoff_pallas.py `_fitch_kernel_multi_carry`
// (layout "nodes2", the default of `batched_fitch_score_pallas`), and with
// it the sibling layouts `_fitch_kernel_multi`, `_fitch_kernel_slots` and
// `_fitch_kernel_swar`, which compute the same function.
//
// What bounds it on this card: per (tree, ancestor, site) the update is an
// AND, a compare, an OR, a select and a counter add on int32, with two
// reads and one write of the state-set table. The inputs are small (the
// children of B trees and one leaf matrix), so it is integer-op and
// shared-memory bound at about B * n_anc * L set updates, never bound by
// device-memory bytes.
//
// What the design does about it: one thread per site and one block per
// (tree, site chunk). Sites are independent and the ancestor loop is a
// serial chain, so a thread walks the whole chain with no block
// synchronisation. Its state-set column lives in dynamic shared memory
// (n_all rows x blockDim.x sites, node-major, so a warp's accesses fall on
// 32 consecutive banks); the table is refilled for every tree, since trees
// differ. Children are read as plain (B, n_anc, 2) int32 through the
// read-only cache (every thread of a block reads the same pair: a
// broadcast). Events are counted per site in an int32 register and
// multiplied by the site weight once at the end; the block reduces within
// each warp and adds one float per warp into scores[tree] with atomicAdd.
// That sum is exact, whatever the order, for integer weights whose totals
// stay below 2^24 (compressed-pattern counts), so scores are bit-equal to
// the plain version.

#include <cuda_runtime.h>

namespace {

__global__ void fitch_batched_kernel(const int* __restrict__ children,
                                     const int* __restrict__ leaf_masks,
                                     const float* __restrict__ weights,
                                     float* __restrict__ scores,
                                     int n_leaves, int length) {
  extern __shared__ int sets[];  // (n_all, blockDim.x), node-major
  const int spb = blockDim.x;
  const int tree = blockIdx.x;
  const int site = blockIdx.y * spb + threadIdx.x;
  const int n_anc = n_leaves - 1;
  const int* tree_children = children + static_cast<size_t>(tree) * n_anc * 2;

  float contrib = 0.0f;
  if (site < length) {
    int* col = sets + threadIdx.x;
    for (int leaf = 0; leaf < n_leaves; ++leaf) {
      col[leaf * spb] = __ldg(leaf_masks + static_cast<size_t>(leaf) * length + site);
    }
    int events = 0;
    for (int a = 0; a < n_anc; ++a) {
      const int c1 = __ldg(tree_children + 2 * a);
      const int c2 = __ldg(tree_children + 2 * a + 1);
      const int s1 = col[c1 * spb];
      const int s2 = col[c2 * spb];
      const int inter = s1 & s2;
      const bool empty = inter == 0;
      col[(n_leaves + a) * spb] = empty ? (s1 | s2) : inter;
      events += empty;
    }
    contrib = static_cast<float>(events) * __ldg(weights + site);
  }
  if (spb >= 32) {
    // blockDim.x is a multiple of 32 here: every lane of the warp exists.
    for (int offset = 16; offset > 0; offset >>= 1) {
      contrib += __shfl_down_sync(0xffffffffu, contrib, offset);
    }
    if ((threadIdx.x & 31) == 0 && contrib != 0.0f) {
      atomicAdd(scores + tree, contrib);
    }
  } else if (contrib != 0.0f) {
    atomicAdd(scores + tree, contrib);
  }
}

}  // namespace

// children (B, n_anc, 2) int32, leaf_masks (n_leaves, L) int32,
// weights (L,) f32, scores (B,) f32 zero-filled by the caller. Launches on
// `stream`, does not synchronise, allocates nothing. Returns the CUDA
// error code (0 = launched).
extern "C" int trex_fitch_batched(const void* children, const void* leaf_masks,
                                  const void* weights, void* scores, int batch,
                                  int n_leaves, int length, int sites_per_block,
                                  void* stream) {
  const int n_all = 2 * n_leaves - 1;
  const size_t smem = static_cast<size_t>(n_all) * sites_per_block * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      fitch_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch, (length + sites_per_block - 1) / sites_per_block);
  fitch_batched_kernel<<<grid, sites_per_block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(children), static_cast<const int*>(leaf_masks),
      static_cast<const float*>(weights), static_cast<float*>(scores), n_leaves,
      length);
  return static_cast<int>(cudaGetLastError());
}
