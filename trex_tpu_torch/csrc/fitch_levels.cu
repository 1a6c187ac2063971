// K6 — level-synchronous Fitch parsimony: the unit-cost scores of `batch`
// instances of the balanced level-order tree (children[a] = (2a, 2a + 1),
// a power-of-two number of leaves), each instance doing its own full work.
//
// Replaces: benchmarks/fitch_levels.py `_fitch_kernel_levels`, the TPU's
// A/B of level scheduling against the production kernel's serial ancestor
// chain (K1 here, csrc/fitch_batched.cu).
//
// What bounds it on this card. The input is one (n, L) leaf matrix, so
// device-memory bytes bound it only at B = 1; otherwise the integer logic
// of the merges does (inter = a & b; where that is empty, the union and one
// event). This kernel keeps one site per 32-bit word, about 4 operations a
// merge, where K1's bit-sliced rows take 2Q + 4 for 32 sites.
//
// What the design does about it. The topology is static, so the kernel
// needs no children table and no index loads: node q of a level reads rows
// 2q and 2q + 1 of the level below.
// - A block owns `width` sites (one per lane) of the tree and 256 / width
//   node lanes. Each node lane evaluates subtrees of 2^depth leaves in
//   registers: a recursion fully unrolled at compile time, so the loads of
//   a subtree's leaves all issue at once and its merges are one static
//   schedule, depth-first, with at most depth + 1 rows live. It writes each
//   subtree's root row to a level region in shared memory.
// - The log2(n / 2^depth) levels above are level-synchronous: each level's
//   nodes spread over the node lanes, a barrier between levels. With many
//   trees (width 256, one node lane) the whole tree is one lane's register
//   recursion; with one tree (width 32, 8 node lanes) the 8 subtrees run in
//   parallel and the top 3 levels in shared memory.
// - The block's leaf rows are staged once in shared memory by 16-byte
//   cp.async and read by every tree it walks (`rounds` trees, one after
//   another, each from the leaves up), or read from global memory where
//   they do not fit.
// - Scores: each lane's event count is summed over its warp and added to
//   its tree's score with atomicAdd. Each partial sum is an integer below
//   2^24, exact as a float in any order, so the scores are bit-equal to the
//   plain version and reproduce bit for bit.
// - Masks are unsigned: bit 31 (the int32 sign bit) is a state like any
//   other.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDepth = 6;  // subtrees of up to 64 leaves in registers
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ uint32_t merge(uint32_t a, uint32_t b, int& events) {
  const uint32_t inter = a & b;
  events += inter == 0u;
  return inter != 0u ? inter : (a | b);
}

template <bool STAGED>
__device__ __forceinline__ uint32_t leaf_row(const uint32_t* p) {
  if constexpr (STAGED) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// The Fitch set of the subtree over the 2^D leaf rows at leaf, leaf +
// stride, ...: both halves, then their merge.
template <int D, bool STAGED>
struct Subtree {
  static __device__ __forceinline__ uint32_t eval(const uint32_t* leaf, int stride, int& events) {
    const uint32_t a = Subtree<D - 1, STAGED>::eval(leaf, stride, events);
    const uint32_t b = Subtree<D - 1, STAGED>::eval(leaf + (stride << (D - 1)), stride, events);
    return merge(a, b, events);
  }
};

template <bool STAGED>
struct Subtree<0, STAGED> {
  static __device__ __forceinline__ uint32_t eval(const uint32_t* leaf, int, int&) {
    return leaf_row<STAGED>(leaf);
  }
};

// Block (chunk, group) scores the trees group, group + groups, ... on the
// chunk's `width` sites. Shared memory: the staged leaf rows (n x width
// words, when STAGED), then the level regions (2 * (n >> D) - 1 rows).
template <int D, bool STAGED>
__global__ void __launch_bounds__(kThreads)
    levels_kernel(const uint32_t* __restrict__ leaves, float* __restrict__ scores,
                  long long* __restrict__ phase_cycles, int n, int length, int width, int batch,
                  int rounds) {
  extern __shared__ __align__(16) uint32_t smem[];
  const long long t_start = clock64();
  const int W = width;
  const int lanes = kThreads / W;
  const int tid = threadIdx.x;
  const int p = tid / W;  // node lane
  const int s = tid - p * W;  // site of the chunk
  const int site0 = blockIdx.x * W;
  const int regions = n >> D;
  uint32_t* levels = STAGED ? smem + n * W : smem;
  const uint32_t* base;
  int stride;
  if constexpr (STAGED) {
    const int quads = W >> 2;
    for (int i = tid; i < n * quads; i += kThreads) {
      const int leaf = i / quads;
      const int q = i - leaf * quads;
      cp_async16(smem + leaf * W + 4 * q, leaves + static_cast<size_t>(leaf) * length + site0 + 4 * q);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    base = smem + s;
    stride = W;
  } else {
    base = leaves + site0 + s;
    stride = length;
  }
  const long long t_staged = clock64();
  long long level_cycles = 0, reduce_cycles = 0;
  for (int r = 0; r < rounds; ++r) {
    const int tree = blockIdx.y + r * gridDim.y;
    if (tree >= batch) break;  // the same for the whole block
    const long long t0 = clock64();
    int events = 0;
    // The bottom D levels, one subtree per (node lane, region) in registers.
    for (int q = p; q < regions; q += lanes) {
      levels[q * W + s] = Subtree<D, STAGED>::eval(base + q * (stride << D), stride, events);
    }
    __syncthreads();
    // The levels above, level-synchronous: level k's w nodes read the 2w
    // rows level k - 1 wrote, contiguous and in pairs.
    int off = 0;
    for (int w = regions >> 1; w >= 1; w >>= 1) {
      for (int q = p; q < w; q += lanes) {
        levels[(off + 2 * w + q) * W + s] =
            merge(levels[(off + 2 * q) * W + s], levels[(off + 2 * q + 1) * W + s], events);
      }
      off += 2 * w;
      __syncthreads();
    }
    const long long t1 = clock64();
    events = __reduce_add_sync(0xffffffffu, events);
    if ((tid & 31) == 0 && events != 0) atomicAdd(scores + tree, static_cast<float>(events));
    level_cycles += t1 - t0;
    reduce_cycles += clock64() - t1;
  }
  if (phase_cycles != nullptr && tid == 0) {
    long long* out = phase_cycles + 3 * (blockIdx.y * gridDim.x + blockIdx.x);
    out[0] = t_staged - t_start;
    out[1] = level_cycles;
    out[2] = reduce_cycles;
  }
}

cudaError_t device_optin(int device, int* optin_bytes) {
  static int cached[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &cached[device], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
  }
  *optin_bytes = cached[device];
  return cudaSuccess;
}

// Opts the instantiation in to the device's full dynamic shared memory
// (once per device and process) and launches it.
template <int D, bool STAGED>
cudaError_t launch(int device, int optin, dim3 grid, int shared_bytes, cudaStream_t stream,
                   const uint32_t* leaves, float* scores, long long* phase_cycles, int n,
                   int length, int width, int batch, int rounds) {
  static bool opted_in[kMaxDevices] = {};
  if (!opted_in[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        levels_kernel<D, STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  levels_kernel<D, STAGED><<<grid, kThreads, shared_bytes, stream>>>(
      leaves, scores, phase_cycles, n, length, width, batch, rounds);
  return cudaGetLastError();
}

template <bool STAGED>
cudaError_t launch_depth(int depth, int device, int optin, dim3 grid, int shared_bytes,
                         cudaStream_t stream, const uint32_t* leaves, float* scores,
                         long long* phase_cycles, int n, int length, int width, int batch,
                         int rounds) {
#define TREX_LEVELS_CASE(D)                                                                     \
  case D:                                                                                     \
    return launch<D, STAGED>(device, optin, grid, shared_bytes, stream, leaves, scores,      \
                             phase_cycles, n, length, width, batch, rounds);
  switch (depth) {
    TREX_LEVELS_CASE(0)
    TREX_LEVELS_CASE(1)
    TREX_LEVELS_CASE(2)
    TREX_LEVELS_CASE(3)
    TREX_LEVELS_CASE(4)
    TREX_LEVELS_CASE(5)
    TREX_LEVELS_CASE(6)
    default:
      return cudaErrorInvalidValue;
  }
#undef TREX_LEVELS_CASE
}

}  // namespace

// leaves (n_leaves, L) int32 state-set masks (16-byte aligned), scores
// (batch,) f32 (zeroed here, on the stream), phase_cycles null or
// (tree_groups * chunks, 3) int64 that receives each block's clock64
// cycles of staging, levels and reduction. width (32, 64, 128 or 256 sites
// a block, dividing L), depth (the levels each node lane merges in
// registers, 0..6), staged, chunks (L / width), tree_groups, rounds and
// shared_bytes come from the launch plan (ops/fitch_levels.py). Launches on
// `stream`, does not synchronise, allocates nothing. Returns the CUDA error
// code (0 = launched).
extern "C" int trex_fitch_levels(const void* leaves, void* scores, void* phase_cycles, int batch,
                                 int n_leaves, int length, int width, int depth, int staged,
                                 int chunks, int tree_groups, int rounds, int shared_bytes,
                                 void* stream) {
  int device = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = device_optin(device, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool width_ok = width == 32 || width == 64 || width == 128 || width == 256;
  const bool pow2 = n_leaves >= 2 && (n_leaves & (n_leaves - 1)) == 0;
  if (!width_ok || !pow2 || depth < 0 || depth > kMaxDepth || (n_leaves >> depth) < 1 ||
      length % width != 0 || chunks * width != length || batch < 1 || tree_groups < 1 ||
      tree_groups > 65535 || rounds < 1 || static_cast<long long>(tree_groups) * rounds < batch ||
      shared_bytes > optin || (reinterpret_cast<size_t>(leaves) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(scores);
  err = cudaMemsetAsync(out, 0, sizeof(float) * batch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(chunks, tree_groups);
  const auto* in = static_cast<const uint32_t*>(leaves);
  auto* clocks = static_cast<long long*>(phase_cycles);
  err = staged ? launch_depth<true>(depth, device, optin, grid, shared_bytes, s, in, out, clocks,
                                    n_leaves, length, width, batch, rounds)
               : launch_depth<false>(depth, device, optin, grid, shared_bytes, s, in, out, clocks,
                                     n_leaves, length, width, batch, rounds);
  return static_cast<int>(err);
}
