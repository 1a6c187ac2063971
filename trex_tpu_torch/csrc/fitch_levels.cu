// K6 — level-synchronous Fitch parsimony: the unit-cost scores of `batch`
// instances of the balanced level-order tree (children[a] = (2a, 2a + 1),
// a power-of-two number of leaves), each instance doing its own full work.
//
// Replaces: benchmarks/fitch_levels.py `_fitch_kernel_levels`, the TPU's
// A/B of level scheduling against the production kernel's serial ancestor
// chain (K1 here, csrc/fitch_batched.cu).
//
// What bounds it on this card. The input is one (n, L) leaf matrix, so
// device-memory bytes bound it only with one or a few trees; otherwise the
// integer logic of the merges does: about 2Q + 4 operations per (tree,
// ancestor, 32 sites) in K1's bit-sliced rows.
//
// What the design does about it. The topology is static, so the kernel
// needs no children table and no index loads: node q of a level reads rows
// 2q and 2q + 1 of the level below. Two modes, by the alphabet.
//
// Bit-sliced (sliced_kernel, up to 8 states: NQ = 4 or 8 planes, K1's
// `planes_for`). One 32-bit word holds one state's bit for 32 sites, so a
// node's set over 32 sites is NQ words and one merge of 32 sites is
//   o = OR_q (a_q & b_q),  new_q = (a_q & b_q) | (~o & (a_q | b_q)),
//   events += popc(~o)
// (one LOP3 a plane for each of o and new_q). Site weights are all 1, so a
// popcount replaces K1's vertical counters and the order of the sites
// inside a word does not matter.
// - A block of up to 512 threads owns 128 sites (4 words, kWords) of
//   `slots` trees, and each tree `lanes` node lanes of 4 threads, one a
//   word; every tree of the block reads the leaf rows it staged. The block
//   packs its leaf rows into planes while it stages them: 64 leaves' masks
//   at a time by 16-byte cp.async, then one thread a (leaf, word) gathers
//   its 32 sites' bits (K1's word layout: bit i of word k is site 4i + k).
//   A warp's 4 x NQ ballots a leaf measured slower (PERF.md).
// - Each node lane merges subtrees of 2^D leaves in registers (D <= 5 at 8
//   planes, whose 6 levels would not fit in 128 registers): a recursion
//   unrolled at compile time, so its leaf loads have immediate offsets and
//   issue at once, and nothing is stored below the subtree's root. The
//   levels above are level-synchronous in shared memory, a barrier each.
// - With many trees the plan takes the fewest node lanes a tree that give
//   nearly every SM a block, so the fewest blocks stage the same leaves.
//   With few (batch x chunks below two blocks an SM) it splits each
//   chunk's tree over `parts` blocks by subtree: each stages only its
//   part's leaves and merges them to the part's root, which it writes to
//   the call's buffer; the last block of the chunk (an acquire-release
//   atomic ticket, zeroed with the scores before the launch) merges the
//   log2(parts) levels above. The split also keeps the staged rows of
//   large trees inside shared memory. Where one site per word was measured
//   faster at few trees (a few hundred leaves staged in each of up to two
//   blocks an SM), the plan takes that mode instead, at any alphabet.
//
// One site per word (levels_kernel, above 8 states, bit 31 included): a
// block owns `width` sites (one per lane) and 256 / width node lanes, the
// same register recursion and shared levels on 32-bit sets (inter = a & b;
// where that is empty, the union and one event); leaf rows staged by
// 16-byte cp.async where they fit, else read from global memory.
//
// Scores: each lane's event count is summed over its tree's lanes of a
// warp and added to its tree's score with atomicAdd. Each partial sum is
// an integer below 2^24, exact as a float in any order, so the scores are
// bit-equal to the plain version and reproduce bit for bit. Masks are
// unsigned: bit 31 (the int32 sign bit) is a state like any other.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // one site per word
constexpr int kMaxDepth = 6;  // subtrees of up to 64 leaves in registers
constexpr int kMaxDevices = 64;
constexpr int kSlicedThreads = 512;  // threads of a bit-sliced block
constexpr int kSplitThreads = 256;  // the same in the split
constexpr int kWords = 4;  // 32-site words a block in the bit-sliced mode
constexpr int kMaxDepth8 = 5;  // 8 planes: 6 levels need more than 128 registers
constexpr int kRawLeaves = 64;  // leaves of masks a bit-sliced block copies at a time
constexpr int kRawStride = 132;  // words of a leaf's 128 raw masks, padded

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ int warp_events(int events, int group) {
  for (int offset = group >> 1; offset > 0; offset >>= 1) {
    events += __shfl_down_sync(0xffffffffu, events, offset, group);
  }
  return events;
}

// ---------------------------------------------------------------------------
// Bit-sliced mode.

// One node's set over a thread's 32 sites: NG groups of 4 planes.
template <int NG>
struct Planes {
  uint4 g[NG];
};

// A row of the leaf table or of a level region: 4 x NQ words, plane group
// g at 16 g, word w at 4 w, plane q % 4 as its component. A thread's
// pointer is the row plus 4 x its word.
template <int NG>
__device__ __forceinline__ Planes<NG> load_planes(const uint32_t* row) {
  Planes<NG> r;
#pragma unroll
  for (int g = 0; g < NG; ++g) r.g[g] = *reinterpret_cast<const uint4*>(row + 16 * g);
  return r;
}

template <int NG>
__device__ __forceinline__ void store_planes(uint32_t* row, const Planes<NG>& r) {
#pragma unroll
  for (int g = 0; g < NG; ++g) *reinterpret_cast<uint4*>(row + 16 * g) = r.g[g];
}

__device__ __forceinline__ uint32_t fitch_plane(uint32_t a, uint32_t b, uint32_t e) {
  return (a & b) | (e & (a | b));
}

template <int NG>
__device__ __forceinline__ Planes<NG> merge_planes(const Planes<NG>& a, const Planes<NG>& b,
                                                   int& events) {
  uint32_t o = 0;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    o |= (a.g[g].x & b.g[g].x) | (a.g[g].y & b.g[g].y) | (a.g[g].z & b.g[g].z) |
         (a.g[g].w & b.g[g].w);
  }
  const uint32_t e = ~o;
  Planes<NG> r;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    r.g[g] = make_uint4(fitch_plane(a.g[g].x, b.g[g].x, e), fitch_plane(a.g[g].y, b.g[g].y, e),
                        fitch_plane(a.g[g].z, b.g[g].z, e), fitch_plane(a.g[g].w, b.g[g].w, e));
  }
  events += __popc(e);
  return r;
}

// The planes of the subtree over the 2^D consecutive leaf rows at `leaf`.
template <int D, int NG>
struct SlicedSubtree {
  static __device__ __forceinline__ Planes<NG> eval(const uint32_t* leaf, int& events) {
    const Planes<NG> a = SlicedSubtree<D - 1, NG>::eval(leaf, events);
    const Planes<NG> b = SlicedSubtree<D - 1, NG>::eval(leaf + ((16 * NG) << (D - 1)), events);
    return merge_planes(a, b, events);
  }
};

template <int NG>
struct SlicedSubtree<0, NG> {
  static __device__ __forceinline__ Planes<NG> eval(const uint32_t* leaf, int&) {
    return load_planes<NG>(leaf);
  }
};

// Packs sites site0..site0 + 127 of leaves leaf0..leaf0 + count - 1 into
// the table's planes, kRawLeaves leaves at a time: their masks copied to
// `raw` by 16-byte cp.async (all in flight at once; a leaf's row padded to
// kRawStride words, so the packing reads no bank twice), then one thread a
// (leaf, word k): bit i of plane q of word k is bit q of site 4i + k.
template <int NQ>
__device__ void stage_planes(const int* __restrict__ masks, uint32_t* table, uint32_t* raw,
                             int leaf0, int count, int length, int site0) {
  const int tid = threadIdx.x;
  for (int b0 = 0; b0 < count; b0 += kRawLeaves) {
    const int nb = min(kRawLeaves, count - b0);
    for (int i = tid; i < 32 * nb; i += blockDim.x) {
      cp_async16(raw + (i >> 5) * kRawStride + 4 * (i & 31),
                 masks + static_cast<size_t>(leaf0 + b0 + (i >> 5)) * length + site0 +
                     4 * (i & 31));
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int it = tid; it < 4 * nb; it += blockDim.x) {
      const int leaf = it >> 2;
      const int k = it & 3;
      const uint32_t* src = raw + leaf * kRawStride + k;
      uint32_t plane[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) plane[q] = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const uint32_t m = src[4 * i];
#pragma unroll
        for (int q = 0; q < NQ; ++q) plane[q] |= ((m >> q) & 1u) << i;
      }
      uint32_t* dst = table + (b0 + leaf) * (4 * NQ) + 4 * k;
#pragma unroll
      for (int g = 0; g < NQ / 4; ++g) {
        *reinterpret_cast<uint4*>(dst + 16 * g) =
            make_uint4(plane[4 * g], plane[4 * g + 1], plane[4 * g + 2], plane[4 * g + 3]);
      }
    }
    __syncthreads();
  }
}

struct SlicedParams {
  const int* masks;         // (n_leaves, L)
  float* scores;            // (B,), zeroed before the launch
  unsigned* tickets;        // split: (tree_groups * chunks), zeroed before the launch
  uint32_t* roots;          // split: (tree_groups * chunks, parts, 4 * NQ) part roots
  long long* phase_cycles;  // null, or (blocks, 4)
  int batch, n_leaves, length, slots, lanes_log2, parts, rounds;
  int raw_offset;  // words of shared memory before the raw masks
};

// One part's arrival at its chunk's ticket: an acquire-release atomic at
// device scope. Its release orders the block's root stores before it (they
// precede it through the block's barrier); its acquire orders the last
// block's loads of the other parts' roots after it.
__device__ __forceinline__ unsigned ticket_acq_rel(unsigned* ticket) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;" : "=r"(old) : "l"(ticket) : "memory");
  return old;
}

// The split's top: the last block of a chunk merges its parts' roots
// (parts rows, then the log2(parts) levels above, in shared memory) and
// adds their events to the tree's score. One tree a block (slots == 1).
template <int NQ>
__device__ void merge_parts(const SlicedParams& p, uint32_t* smem, const uint32_t* roots,
                            int tree) {
  constexpr int NG = NQ / 4;
  constexpr int kRow = 4 * NQ;
  const int tid = threadIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(roots);
  for (int i = tid; i < p.parts * (kRow / 4); i += blockDim.x) {
    reinterpret_cast<uint4*>(smem)[i] = __ldcg(src + i);
  }
  __syncthreads();
  int events = 0;
  int off = 0;
  for (int w = p.parts >> 1; w >= 1; w >>= 1) {
    for (int it = tid; it < w * kWords; it += blockDim.x) {
      const int q = it >> 2;
      uint32_t* base = smem + 4 * (it & 3);
      store_planes<NG>(base + (off + 2 * w + q) * kRow,
                       merge_planes<NG>(load_planes<NG>(base + (off + 2 * q) * kRow),
                                        load_planes<NG>(base + (off + 2 * q + 1) * kRow),
                                        events));
    }
    off += 2 * w;
    __syncthreads();
  }
  events = warp_events(events, 32);
  if ((tid & 31) == 0 && events != 0) atomicAdd(p.scores + tree, static_cast<float>(events));
}

// Block (chunk, group, part) scores the trees (group * rounds + r) * slots
// + j, r < rounds, j < slots, on the chunk's 128 sites over the part's
// leaves. Thread (j, node lane, word): tid = (j * lanes + node) * 4 + word.
// Shared memory: the part's leaf rows (n_part x 4 NQ words), then each
// slot's level regions (2 * (n_part >> D) - 1 rows); in the split, the
// last block reuses it for the parts' roots and the levels above; then
// the raw masks of up to kRawLeaves leaves (kRawStride words each) in
// staging.
template <int NQ, int D>
__global__ void __launch_bounds__(kSlicedThreads) sliced_kernel(SlicedParams p) {
  constexpr int NG = NQ / 4;
  constexpr int kRow = 4 * NQ;
  extern __shared__ __align__(16) uint32_t smem[];
  const unsigned t_start = clock();
  const int tid = threadIdx.x;
  const int word = tid & (kWords - 1);
  const int lanes = 1 << p.lanes_log2;
  const int node = (tid >> 2) & (lanes - 1);
  const int j = (tid >> 2) >> p.lanes_log2;
  const int n_part = p.n_leaves / p.parts;
  const int regions = n_part >> D;
  const int region_rows = 2 * regions - 1;
  const int part = blockIdx.z;
  uint32_t* levels = smem + (n_part + j * region_rows) * kRow + 4 * word;
  uint32_t* raw = smem + p.raw_offset;
  stage_planes<NQ>(p.masks, smem, raw, part * n_part, n_part, p.length, 32 * kWords * blockIdx.x);
  const unsigned t_staged = clock();
  const int group = min(32, kWords * lanes);
  unsigned level_cycles = 0, reduce_cycles = 0, top_cycles = 0;
  for (int r = 0; r < p.rounds; ++r) {
    const int tree = (blockIdx.y * p.rounds + r) * p.slots + j;
    const bool on = j < p.slots && tree < p.batch;
    const unsigned t0 = clock();
    int events = 0;
    // The bottom D levels, one subtree per (node lane, region) in registers.
    if (on) {
      for (int q = node; q < regions; q += lanes) {
        store_planes<NG>(levels + q * kRow,
                         SlicedSubtree<D, NG>::eval(smem + (q << D) * kRow + 4 * word, events));
      }
    }
    __syncthreads();
    // The levels above, level-synchronous: level k's w nodes read the 2w
    // rows level k - 1 wrote, contiguous and in pairs.
    int off = 0;
    for (int w = regions >> 1; w >= 1; w >>= 1) {
      if (on) {
        for (int q = node; q < w; q += lanes) {
          store_planes<NG>(levels + (off + 2 * w + q) * kRow,
                           merge_planes<NG>(load_planes<NG>(levels + (off + 2 * q) * kRow),
                                            load_planes<NG>(levels + (off + 2 * q + 1) * kRow),
                                            events));
        }
      }
      off += 2 * w;
      __syncthreads();
    }
    const unsigned t1 = clock();
    events = warp_events(events, group);
    if (on && (tid & (group - 1)) == 0 && events != 0) {
      atomicAdd(p.scores + tree, static_cast<float>(events));
    }
    const unsigned t2 = clock();
    level_cycles += t1 - t0;
    reduce_cycles += t2 - t1;
    if (p.parts > 1) {
      // The split (rounds == 1, slots == 1): this part's root to the
      // chunk's buffer, then a ticket (one thread's fence after the
      // barrier orders the block's stores before it); the last part's
      // block merges above.
      const int ticket = blockIdx.y * gridDim.x + blockIdx.x;
      uint32_t* roots = p.roots + static_cast<size_t>(ticket) * p.parts * kRow;
      if (on && node == 0) {
        store_planes<NG>(roots + part * kRow + 4 * word,
                         load_planes<NG>(levels + (region_rows - 1) * kRow));
      }
      __syncthreads();
      bool last = false;
      if (tid == 0) last = ticket_acq_rel(p.tickets + ticket) == p.parts - 1u;
      if (__syncthreads_or(last) && static_cast<int>(blockIdx.y) < p.batch) {
        merge_parts<NQ>(p, smem, roots, blockIdx.y);
      }
      top_cycles += clock() - t2;
    }
  }
  if (p.phase_cycles != nullptr && tid == 0) {
    long long* out =
        p.phase_cycles + 4 * ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
    out[0] = static_cast<unsigned>(t_staged - t_start);
    out[1] = level_cycles;
    out[2] = top_cycles;
    out[3] = reduce_cycles;
  }
}

// ---------------------------------------------------------------------------
// One site per word.

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
    long long* out = phase_cycles + 4 * (blockIdx.y * gridDim.x + blockIdx.x);
    out[0] = t_staged - t_start;
    out[1] = level_cycles;
    out[2] = 0;
    out[3] = reduce_cycles;
  }
}

// ---------------------------------------------------------------------------
// Launch.

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

// Opts `kernel` in to the device's full dynamic shared memory, once per
// device and process (one flag array per instantiation of the caller).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, bool (&opted_in)[kMaxDevices], int device, int optin) {
  if (opted_in[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) opted_in[device] = true;
  return err;
}

template <int NQ, int D>
cudaError_t launch_sliced(int device, int optin, dim3 grid, int threads, int shared_bytes,
                          cudaStream_t stream, const SlicedParams& p) {
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t err = opt_in(sliced_kernel<NQ, D>, opted_in, device, optin);
  if (err != cudaSuccess) return err;
  sliced_kernel<NQ, D><<<grid, threads, shared_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int NQ>
cudaError_t launch_sliced_depth(int depth, int device, int optin, dim3 grid, int threads,
                                int shared_bytes, cudaStream_t stream, const SlicedParams& p) {
#define TREX_SLICED_CASE(D) \
  case D:                   \
    return launch_sliced<NQ, D>(device, optin, grid, threads, shared_bytes, stream, p);
  switch (depth) {
    TREX_SLICED_CASE(0)
    TREX_SLICED_CASE(1)
    TREX_SLICED_CASE(2)
    TREX_SLICED_CASE(3)
    TREX_SLICED_CASE(4)
    TREX_SLICED_CASE(5)
    default:
      if constexpr (NQ == 4) {
        if (depth == 6) {
          return launch_sliced<NQ, 6>(device, optin, grid, threads, shared_bytes, stream, p);
        }
      }
      return cudaErrorInvalidValue;
  }
#undef TREX_SLICED_CASE
}

template <int D, bool STAGED>
cudaError_t launch(int device, int optin, dim3 grid, int shared_bytes, cudaStream_t stream,
                   const uint32_t* leaves, float* scores, long long* phase_cycles, int n,
                   int length, int width, int batch, int rounds) {
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t err = opt_in(levels_kernel<D, STAGED>, opted_in, device, optin);
  if (err != cudaSuccess) return err;
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

bool pow2(int x) { return x >= 1 && (x & (x - 1)) == 0; }

int log2i(int x) {
  int k = 0;
  while ((1 << k) < x) ++k;
  return k;
}

}  // namespace

// leaves (n_leaves, L) int32 state-set masks (16-byte aligned); out the
// call's output and scratch, 16-byte aligned: the (batch,) f32 scores,
// then in the split, from word pad4(batch), (tree_groups * chunks)
// uint32 tickets, and from the next multiple of 4 words (tree_groups *
// chunks * parts * 4 * planes) words of part roots. One memset on the
// stream zeroes the scores and the tickets, so no ticket outlives its
// call. phase_cycles is null or (blocks, 4) int64 that receives each
// block's clock cycles of staging, levels, the split's top (its root,
// ticket and, in the last block, the merge of the parts' roots; 0
// elsewhere) and reduction. The rest comes from the launch plan
// (ops/fitch_levels.py):
// - planes 4 or 8, the bit-sliced mode: width 4 (words, 128 sites),
//   depth 0..6 (0..5 at 8 planes), staged 1, slots x lanes x 4 <= the
//   block's threads (lanes a power of two), parts a power of two dividing
//   n_leaves, slots 1 and rounds 1 where parts > 1;
// - planes 0, one site per word: width 32, 64, 128 or 256 sites, depth
//   0..6, staged or not, slots 1, lanes 256 / width, parts 1.
// The grid is chunks x tree_groups x parts blocks (bit-sliced 512 threads,
// 256 in the split; one site per word 256), each scoring `rounds` tree
// groups in turn. Launches on `stream`, does not synchronise, allocates
// nothing. Returns the CUDA error code (0 = launched).
extern "C" int trex_fitch_levels(const void* leaves, void* out, void* phase_cycles, int batch,
                                 int n_leaves, int length, int planes, int width, int depth,
                                 int staged, int slots, int lanes, int parts, int chunks,
                                 int tree_groups, int rounds, int shared_bytes, void* stream) {
  int device = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = device_optin(device, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool common_ok = pow2(n_leaves) && n_leaves >= 2 && depth >= 0 && depth <= kMaxDepth &&
                         batch >= 1 && tree_groups >= 1 && tree_groups <= 65535 && rounds >= 1 &&
                         shared_bytes <= optin && length > 0 &&
                         (reinterpret_cast<size_t>(leaves) & 15) == 0 &&
                         (reinterpret_cast<size_t>(out) & 15) == 0;
  if (!common_ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* scores = static_cast<float*>(out);
  auto* clocks = static_cast<long long*>(phase_cycles);
  if (planes == 0) {
    const bool ok = (width == 32 || width == 64 || width == 128 || width == 256) &&
                    (n_leaves >> depth) >= 1 && length % width == 0 &&
                    chunks * width == length && slots == 1 && lanes == kThreads / width &&
                    parts == 1 && static_cast<long long>(tree_groups) * rounds >= batch;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaMemsetAsync(scores, 0, sizeof(float) * batch, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(chunks, tree_groups);
    const auto* in = static_cast<const uint32_t*>(leaves);
    err = staged ? launch_depth<true>(depth, device, optin, grid, shared_bytes, s, in, scores,
                                      clocks, n_leaves, length, width, batch, rounds)
                 : launch_depth<false>(depth, device, optin, grid, shared_bytes, s, in, scores,
                                       clocks, n_leaves, length, width, batch, rounds);
    return static_cast<int>(err);
  }
  const bool split = parts > 1;
  const int threads = split ? kSplitThreads : kSlicedThreads;
  const int raw_leaves = parts >= 1 && n_leaves / parts < kRawLeaves ? n_leaves / parts : kRawLeaves;
  const int raw_bytes = 4 * kRawStride * raw_leaves;
  const bool ok =
      (planes == 4 || planes == 8) && width == kWords && staged == 1 && pow2(lanes) &&
      slots >= 1 && shared_bytes % 16 == 0 && shared_bytes >= raw_bytes &&
      slots * lanes * kWords <= threads && pow2(parts) && parts <= n_leaves &&
      parts <= 65535 && ((n_leaves / parts) >> depth) >= 1 && chunks * 32 * kWords == length &&
      depth <= (planes == 8 ? kMaxDepth8 : kMaxDepth) &&
      static_cast<long long>(tree_groups) * slots * rounds >= batch &&
      (!split || (slots == 1 && rounds == 1));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tickets = tree_groups * chunks;
  const int head = (batch + 3) & ~3;
  err = cudaMemsetAsync(out, 0, sizeof(float) * (split ? head + n_tickets : batch), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* tickets = reinterpret_cast<unsigned*>(scores + head);
  const SlicedParams p{static_cast<const int*>(leaves), scores, split ? tickets : nullptr,
                       split ? reinterpret_cast<uint32_t*>(tickets + ((n_tickets + 3) & ~3))
                             : nullptr,
                       clocks, batch, n_leaves, length, slots, log2i(lanes), parts, rounds,
                       (shared_bytes - raw_bytes) / 4};
  const dim3 grid(chunks, tree_groups, parts);
  err = planes == 4
            ? launch_sliced_depth<4>(depth, device, optin, grid, threads, shared_bytes, s, p)
            : launch_sliced_depth<8>(depth, device, optin, grid, threads, shared_bytes, s, p);
  return static_cast<int>(err);
}
