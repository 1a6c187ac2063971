// Tree plan — the evaluation order and row slots that the tree-DP kernels
// K5 (csrc/sankoff_batched.cu) and K3/K4 (csrc/likelihood_batched.cu) walk.
//
// For each tree of a (B, n_anc, 2) children batch (child index < parent
// index, root last) it writes n_anc steps (v, src1, src2, dst), int4 each:
// ancestor v is evaluated from its children c1 = children[v][0] and c2 =
// children[v][1] (in that stored order), src_k is c_k for a leaf and ~slot
// (negative) for an ancestor whose row sits in that slot, and v's row goes
// to slot dst. The order is a post-order that evaluates first the child
// that needs more slots (c1 on a tie: Sethi-Ullman); a node's row takes the
// slot of its first-evaluated ancestor child, or the next free one. So the
// live rows form a stack, and a tree of n leaves needs at most floor(log2
// n) slots (its Strahler number, with leaves at 0), where index order keeps
// O(n) rows live. Every row depends only on its two children's rows, taken
// in stored order, so any valid order gives the DP the same rows bit for
// bit.
//
// Two sequential passes per tree, no stack: bottom-up in index order, each
// ancestor's slot need and ancestor count; top-down from the root, each
// ancestor's post-order offset and slot depth (written over its need and
// count, which no later step reads), its position offset + count - 1, and
// its step. An ancestor's two numbers share one int32: the need or depth
// in the low 5 bits (at most 31), the count or offset above.
//
// New to the port: the Pallas kernels it serves kept every ancestor row in
// VMEM (trex_tpu/ops/sankoff_pallas.py `_sankoff_kernel`,
// trex_tpu/ops/likelihood_pallas.py `_likelihood_kernel_lanes` and
// `_likelihood_kernel_slots`) and needed no order but the index order.
//
// What bounds it: each tree is two dependent chains of n_anc steps, each
// step a few shared-memory loads and a store (tens of cycles); the bytes
// (children in, 16 bytes a step out) are small. One warp a tree: its 32
// lanes stage the tree's children in shared memory with coalesced loads,
// then lane 0 runs both passes on the staged copy. Where one tree's 12
// bytes an ancestor do not fit a block's shared memory (about 19,000 taxa
// on an H100), the lane reads the children from global memory and keeps
// its words in a global scratch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBits = 5;  // need or depth bits of a word
constexpr int kLow = (1 << kBits) - 1;

// Bytes of one staged tree: children (int2) and words (int32), rounded up
// to 16.
__host__ __device__ inline size_t tree_bytes(int n_anc) {
  return (static_cast<size_t>(n_anc) * 12 + 15) / 16 * 16;
}

template <bool kStaged>
__global__ void plan_kernel(const int2* __restrict__ children,  // (B, n_anc)
                            int4* __restrict__ plan,            // (B, n_anc)
                            int* __restrict__ g_words,          // (B, n_anc), global mode
                            int batch, int n_leaves) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int tree = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (tree >= batch) return;
  const int n_anc = n_leaves - 1;
  const int2* tree_children = children + static_cast<size_t>(tree) * n_anc;
  const int2* ch;
  int* word;
  if (kStaged) {
    unsigned char* base = smem + warp * tree_bytes(n_anc);
    int2* ch_sh = reinterpret_cast<int2*>(base);
    for (int a = lane; a < n_anc; a += kWarp) ch_sh[a] = __ldg(tree_children + a);
    __syncwarp();
    ch = ch_sh;
    word = reinterpret_cast<int*>(base + 8 * static_cast<size_t>(n_anc));
  } else {
    ch = tree_children;
    word = g_words + static_cast<size_t>(tree) * n_anc;
  }
  if (lane != 0) return;

  // Bottom-up: need (slots to evaluate the subtree) and ancestor count.
  // Each step's children are loaded a step ahead: the loads cannot pass the
  // previous step's word store by themselves (one shared array).
  int2 c_next = ch[0];
  for (int a = 0; a < n_anc; ++a) {
    const int2 c = c_next;
    if (a + 1 < n_anc) c_next = ch[a + 1];
    const int w1 = c.x >= n_leaves ? word[c.x - n_leaves] : 0;
    const int w2 = c.y >= n_leaves ? word[c.y - n_leaves] : 0;
    const int n1 = w1 & kLow, n2 = w2 & kLow;
    const int need = n1 == n2 ? n1 + 1 : max(n1, n2);
    word[a] = ((w1 >> kBits) + (w2 >> kBits) + 1) << kBits | need;
  }
  // Top-down: each word becomes the post-order offset and the slot depth.
  int4* out = plan + static_cast<size_t>(tree) * n_anc;
  word[n_anc - 1] = 0;
  c_next = ch[n_anc - 1];
  for (int v = n_anc - 1; v >= 0; --v) {
    const int2 c = c_next;
    if (v > 0) c_next = ch[v - 1];
    const bool i1 = c.x >= n_leaves, i2 = c.y >= n_leaves;
    const int w1 = i1 ? word[c.x - n_leaves] : 0;
    const int w2 = i2 ? word[c.y - n_leaves] : 0;
    const int n1 = w1 & kLow, n2 = w2 & kLow;
    const int s1 = w1 >> kBits, s2 = w2 >> kBits;
    const int offset = word[v] >> kBits;
    const int depth = word[v] & kLow;
    int off1, off2, d1, d2;
    if (n2 > n1) {  // c2 first
      off2 = offset;
      off1 = offset + s2;
      d2 = depth;
      d1 = depth + (i2 ? 1 : 0);
    } else {
      off1 = offset;
      off2 = offset + s1;
      d1 = depth;
      d2 = depth + (i1 ? 1 : 0);
    }
    const int pos = offset + s1 + s2;
    if (pos >= 0 && pos < n_anc) {
      out[pos] = make_int4(v, i1 ? ~d1 : c.x, i2 ? ~d2 : c.y, depth);
    }
    if (i1) word[c.x - n_leaves] = off1 << kBits | d1;
    if (i2) word[c.y - n_leaves] = off2 << kBits | d2;
  }
}

}  // namespace

// children (B, n_anc, 2) int32, 8-byte aligned; plan (B, n_anc, 4) int32,
// 16-byte aligned. `trees_per_block` warps a block, one tree each; staged
// != 0 stages each tree in `smem_bytes` of dynamic shared memory
// (trees_per_block x tree_bytes(n_anc)); else g_words (B, n_anc) int32 is
// the scratch. Launches on `stream`, does not synchronise, allocates
// nothing. Returns the CUDA error code (0 = launched).
extern "C" int trex_tree_plan(const void* children, void* plan, void* g_words, int batch,
                              int n_leaves, int trees_per_block, int staged, int smem_bytes,
                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (batch + trees_per_block - 1) / trees_per_block;
  const auto* ch = static_cast<const int2*>(children);
  auto* out = static_cast<int4*>(plan);
  if (staged) {
    const cudaError_t err = cudaFuncSetAttribute(
        plan_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    plan_kernel<true><<<blocks, trees_per_block * kWarp, smem_bytes, s>>>(
        ch, out, nullptr, batch, n_leaves);
  } else {
    plan_kernel<false><<<blocks, trees_per_block * kWarp, 0, s>>>(
        ch, out, static_cast<int*>(g_words), batch, n_leaves);
  }
  return static_cast<int>(cudaGetLastError());
}
