// K1 — batched unit-cost Fitch parsimony: the scores of B trees on one
// alignment of state-set bitmasks.
//
// Replaces: trex_tpu/ops/sankoff_pallas.py `_fitch_kernel_multi_carry`
// (layout "nodes2", the default of `batched_fitch_score_pallas`), and with
// it the sibling layouts `_fitch_kernel_multi`, `_fitch_kernel_slots` and
// `_fitch_kernel_swar` (4 sites per word, the TPU's choice for long
// alignments), which compute the same function.
//
// What bounds it on this card. The inputs are small (the children of B
// trees, one leaf matrix, the weights), so device-memory bytes never bound
// it: the least work is the bit-sliced update below, about 2Q + 4 integer
// logic ops per (tree, ancestor, 32 sites). This design is held back by
// the walk's shared-memory traffic (two 16-byte row loads and one store
// per lane and step) and, with few trees (B = 1), by each tree's chain of
// n_anc dependent steps.
//
// What the design does about it.
// - Bit-sliced state sets (planes > 0). One 32-bit word holds one state's
//   presence bit for 32 sites, so a node's set over 32 sites is `planes`
//   words, and one thread's step updates 32 sites:
//     inter_q = a_q & b_q,  o = OR_q inter_q,
//     new_q = inter_q | (~o & (a_q | b_q))   (one 3-input LOP3 per plane),
//   about 2Q + 4 logic ops per 32 sites. Events (~o) go into a 3-plane
//   vertical counter (4 ops a step) that is added into a 13-plane one every
//   6 steps; after the walk the planes are expanded to per-site int32
//   counts and multiplied by the f32 site weights once. Word gw holds sites
//   128 * (gw / 4) + 4 * i + gw % 4 (bit i), so a warp packs 4 words of a
//   leaf from one 16-byte load per lane with 4 * planes ballots.
// - Leaves packed once per call, staged once per block, shared by its
//   trees. A pre-pass packs the leaf masks into planes in a global scratch.
//   A block owns a chunk of `width` words (or sites) and walks `slots`
//   trees at a time over it, `rounds` times; lane (j, w) walks word w of
//   slot j's tree. The chunk's leaf rows enter shared memory once, by
//   16-byte cp.async, and every tree of the block reads them. Each slot
//   keeps its own ancestor rows beside them.
// - Children in shared memory, with prefetch. The next round's children
//   arrive by cp.async while this round walks. Staging turns each child
//   index into its row's shared-memory offset and puts the previous
//   ancestor, where it is a child, first. The walk reads children two
//   steps ahead and issues a step's row loads before the previous step's
//   store, two steps per iteration in ping-pong registers; the one row that
//   can be stale, the previous step's, is forwarded from registers.
// - A second mode (planes == 0) keeps one site per 32-bit word, for
//   alphabets above 8 states (measured faster there) and trees whose
//   bit-sliced rows do not fit; the launch plan (ops/fitch_cuda.py::launch_plan) picks the mode, the
//   chunk width and the slots from the shape.
// - A global mode (fitch_global_kernel) for trees whose rows do not fit in
//   shared memory even one tree and 4 sites at a time (above 5811 taxa on
//   an H100): one thread per (tree, site) reads the leaves from the masks
//   and each ancestor's row from a per-(tree group, ancestor) scratch in
//   global memory, the children from global memory one step ahead. Its
//   limit is the card's memory.
// - Scores: each lane's weighted sum is reduced across the lanes of its
//   tree and added with atomicAdd. Every partial sum is an integer-valued
//   float, exact in any order for integer weights whose totals stay below
//   2^24 (compressed-pattern counts), so scores are bit-equal to the plain
//   version and reproduce bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCounterPlanes = 13;  // counts up to 8191 ancestors
constexpr int kMaxDevices = 64;

struct Params {
  const int* children;      // (B, n_anc, 2)
  const int* masks;         // (n_leaves, L)
  const uint32_t* planes;   // packed leaf planes (bit-sliced mode)
  const float* weights;     // (L,)
  float* scores;            // (B,), zeroed before the launch
  long long* phase_cycles;  // null, or (blocks, 4)
  int batch, n_leaves, length, n_words, width, slots, rounds;
};

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t{15}; }

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of round `round`'s children (slots x n_anc int2) into dst.
__device__ void issue_children(const Params& p, int2* dst, int round) {
  const int n_anc = p.n_leaves - 1;
  const int tree0 = (blockIdx.y * p.rounds + round) * p.slots;
  const int count = p.slots * n_anc;
  const int2* src = reinterpret_cast<const int2*>(p.children) + static_cast<size_t>(tree0) * n_anc;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    if (tree0 + i / n_anc < p.batch) cp_async8(dst + i, src + i);
  }
  cp_async_commit();
}

// Round `round`'s child node indices -> word offsets of their rows in the
// table (leaves first, then slot j's ancestors), the previous ancestor put
// first; zero pairs for slots past the batch and two after the last entry,
// for the walk's look-ahead. In place when src == dst.
__device__ void place_children(const Params& p, const int2* src, int2* dst, int row, int round) {
  const int n = p.n_leaves;
  const int n_anc = n - 1;
  const int count = p.slots * n_anc;
  const int tree0 = (blockIdx.y * p.rounds + round) * p.slots;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int j = i / n_anc;
    const int a = i - j * n_anc;
    int2 c = src[i];
    if (c.y == n + a - 1) c = make_int2(c.y, c.x);
    const int shift = j * n_anc;
    dst[i] = tree0 + j < p.batch
                 ? make_int2((c.x + (c.x >= n ? shift : 0)) * row,
                             (c.y + (c.y >= n ? shift : 0)) * row)
                 : make_int2(0, 0);
  }
  if (threadIdx.x < 2) dst[count + threadIdx.x] = make_int2(0, 0);
}

__device__ __forceinline__ int component(const int4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The pre-pass: packs the leaf masks into planes, once per call, and zeroes
// the scores. One warp per (leaf, 128-site group); lane i loads sites
// 4i..4i+3 of the group. Plane q of word gw of a leaf lands at ((leaf *
// NQ/4 + q/4) * n_words + gw) * 4 + q % 4, so a block stages its chunk's
// rows with 16-byte copies.
template <int NQ>
__global__ void __launch_bounds__(kThreads) pack_kernel(const int* __restrict__ masks,
                                                        uint32_t* __restrict__ planes,
                                                        float* __restrict__ scores, int batch,
                                                        int n_leaves, int length, int n_words) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < batch; i += gridDim.x * kThreads) {
    scores[i] = 0.0f;
  }
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int groups = n_words >> 2;
  if (task >= n_leaves * groups) return;  // whole warps
  const int leaf = task / groups;
  const int group = task - leaf * groups;
  const int site = 128 * group + 4 * lane;
  const int* src = masks + static_cast<size_t>(leaf) * length + site;
  int4 v = make_int4(0, 0, 0, 0);
  if ((length & 3) == 0 && (reinterpret_cast<size_t>(masks) & 15) == 0) {
    if (site < length) v = __ldg(reinterpret_cast<const int4*>(src));
  } else {
    v.x = site < length ? __ldg(src) : 0;
    v.y = site + 1 < length ? __ldg(src + 1) : 0;
    v.z = site + 2 < length ? __ldg(src + 2) : 0;
    v.w = site + 3 < length ? __ldg(src + 3) : 0;
  }
  uint32_t* dst = planes + (static_cast<size_t>(leaf) * (NQ / 4) + (lane >> 2)) * n_words * 4 +
                  (lane & 3);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t comp = static_cast<uint32_t>(component(v, k));
    uint32_t mine = 0;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const uint32_t plane = __ballot_sync(0xffffffffu, (comp >> q) & 1u);
      if (lane == q) mine = plane;
    }
    if (lane < NQ) dst[(4 * group + k) * 4] = mine;
  }
}

// Stages the chunk's leaf rows from the packed planes: word wl of the
// chunk, plane q at row + (q / 4) * 4W + 4 wl + q % 4; and its weights,
// site bit b of word wl at b * W + wl.
template <int NQ>
__device__ void stage_sliced(const Params& p, uint32_t* table, float* wsm, int gw0) {
  const int W = p.width;
  const int row = NQ * W;
  for (int i = threadIdx.x; i < 32 * W; i += blockDim.x) {
    const int bit = i / W;
    const int gw = gw0 + i - bit * W;
    const int site = 128 * (gw >> 2) + 4 * bit + (gw & 3);
    wsm[i] = site < p.length ? __ldg(p.weights + site) : 0.0f;
  }
  const int per_leaf = W * (NQ / 4);
  for (int i = threadIdx.x; i < p.n_leaves * per_leaf; i += blockDim.x) {
    const int leaf = i / per_leaf;
    const int r = i - leaf * per_leaf;
    const int g = r / W;
    const int wl = r - g * W;
    uint32_t* dst = table + leaf * row + 4 * (g * W + wl);
    if (gw0 + wl < p.n_words) {
      cp_async16(dst, p.planes + ((static_cast<size_t>(leaf) * (NQ / 4) + g) * p.n_words + gw0 + wl) * 4);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();
}

// One site per word: the chunk's leaf columns as they are.
__device__ void stage_sites(const Params& p, uint32_t* table, float* wsm, int site0) {
  const int S = p.width;
  const int L = p.length;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    wsm[s] = site0 + s < L ? __ldg(p.weights + site0 + s) : 0.0f;
  }
  const bool quads = (S & 3) == 0 && (L & 3) == 0 && site0 + S <= L &&
                     (reinterpret_cast<size_t>(p.masks) & 15) == 0;
  if (quads) {
    const int per_row = S >> 2;
    for (int i = threadIdx.x; i < p.n_leaves * per_row; i += blockDim.x) {
      const int leaf = i / per_row;
      const int s = (i - leaf * per_row) << 2;
      *reinterpret_cast<int4*>(table + leaf * S + s) = __ldg(
          reinterpret_cast<const int4*>(p.masks + static_cast<size_t>(leaf) * L + site0 + s));
    }
  } else {
    for (int i = threadIdx.x; i < p.n_leaves * S; i += blockDim.x) {
      const int leaf = i / S;
      const int s = i - leaf * S;
      table[i] = site0 + s < L ? __ldg(p.masks + static_cast<size_t>(leaf) * L + site0 + s) : 0u;
    }
  }
}

// Adds the 3-plane low counter into the high counter h (planes past the
// count's width stay 0, so the carry needs no bound).
__device__ __forceinline__ void flush(uint32_t (&h)[kCounterPlanes], uint32_t l0, uint32_t l1,
                                      uint32_t l2) {
  uint32_t c = h[0] & l0;
  h[0] ^= l0;
  uint32_t s = h[1] ^ l1 ^ c;
  c = (h[1] & l1) | (c & (h[1] ^ l1));
  h[1] = s;
  s = h[2] ^ l2 ^ c;
  c = (h[2] & l2) | (c & (h[2] ^ l2));
  h[2] = s;
#pragma unroll
  for (int i = 3; i < kCounterPlanes; ++i) {
    const uint32_t t = h[i] & c;
    h[i] ^= c;
    c = t;
  }
}

// The two child rows of one step, NG groups of 4 planes each.
template <int NG>
struct Pair {
  uint4 a[NG], b[NG];
};

// The state one lane carries along its walk: the last row it wrote (for
// forwarding), that row's offset, the next row's pointer, the counters.
template <int NG>
struct Walker {
  uint4 last[NG];
  int prev;
  int here;
  uint32_t* out;
  int row;
  int gstride;
  uint32_t l0, l1, l2;

  __device__ __forceinline__ void load(Pair<NG>& dst, const uint32_t* rows, int2 k) const {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      dst.a[g] = *reinterpret_cast<const uint4*>(rows + k.x + g * gstride);
      dst.b[g] = *reinterpret_cast<const uint4*>(rows + k.y + g * gstride);
    }
  }

  // One ancestor: rows loaded before the previous step's store, so the
  // first child, where it is that step's row, comes from registers.
  __device__ __forceinline__ void step(int2 k, const Pair<NG>& r) {
    const bool forward = k.x == prev;
    uint4 A[NG];
    uint32_t o = 0;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      A[g].x = forward ? last[g].x : r.a[g].x;
      A[g].y = forward ? last[g].y : r.a[g].y;
      A[g].z = forward ? last[g].z : r.a[g].z;
      A[g].w = forward ? last[g].w : r.a[g].w;
      o |= (A[g].x & r.b[g].x) | (A[g].y & r.b[g].y) | (A[g].z & r.b[g].z) |
           (A[g].w & r.b[g].w);
    }
    const uint32_t e = ~o;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      last[g].x = (A[g].x & r.b[g].x) | (e & (A[g].x | r.b[g].x));
      last[g].y = (A[g].y & r.b[g].y) | (e & (A[g].y | r.b[g].y));
      last[g].z = (A[g].z & r.b[g].z) | (e & (A[g].z | r.b[g].z));
      last[g].w = (A[g].w & r.b[g].w) | (e & (A[g].w | r.b[g].w));
      *reinterpret_cast<uint4*>(out + g * gstride) = last[g];
    }
    const uint32_t t = l0 & e;
    l2 ^= l1 & t;
    l1 ^= t;
    l0 ^= e;
    prev = here;
    here += row;
    out += row;
  }
};

// One lane's walk over its tree's ancestors, bit-sliced: NG groups of 4
// planes per node. Two steps per iteration with the rows of the next step
// in flight (ping-pong registers), the children two steps ahead; the low
// counter is added into h every 6 steps. Leaves the per-site event counts
// in h.
template <int NG>
__device__ __forceinline__ void walk_sliced(const int2* kids, const uint32_t* rows,
                                            uint32_t* out_row, int gstride, int row, int n_anc,
                                            uint32_t (&h)[kCounterPlanes]) {
  Walker<NG> w;
#pragma unroll
  for (int g = 0; g < NG; ++g) w.last[g] = make_uint4(0, 0, 0, 0);
  w.prev = -1;
  w.here = static_cast<int>(out_row - rows);
  w.out = out_row;
  w.row = row;
  w.gstride = gstride;
  w.l0 = w.l1 = w.l2 = 0;
  Pair<NG> r0, r1;
  int2 k0 = kids[0];
  int2 k1 = kids[1];
  w.load(r0, rows, k0);
  int a = 0;
  int pairs = 0;
  for (; a + 1 < n_anc; a += 2) {
    const int2 k2 = kids[a + 2];
    w.load(r1, rows, k1);
    w.step(k0, r0);
    const int2 k3 = kids[a + 3];
    w.load(r0, rows, k2);
    w.step(k1, r1);
    k0 = k2;
    k1 = k3;
    if (++pairs == 3) {
      flush(h, w.l0, w.l1, w.l2);
      w.l0 = w.l1 = w.l2 = 0;
      pairs = 0;
    }
  }
  if (a < n_anc) w.step(k0, r0);
  flush(h, w.l0, w.l1, w.l2);
}

// sum over the lane's 32 sites of count * weight; site bit b's weight at
// wlane[b * W].
__device__ __forceinline__ float expand(const uint32_t (&h)[kCounterPlanes], int kplanes,
                                        const float* wlane, int W) {
  int cnt[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) cnt[b] = 0;
#pragma unroll
  for (int i = 0; i < kCounterPlanes; ++i) {
    if (i >= kplanes) break;
    const uint32_t hp = h[i];
#pragma unroll
    for (int b = 0; b < 32; ++b) cnt[b] |= static_cast<int>((hp >> b) & 1u) << i;
  }
  float acc = 0.0f;
#pragma unroll
  for (int b = 0; b < 32; ++b) acc = fmaf(static_cast<float>(cnt[b]), wlane[b * W], acc);
  return acc;
}

// One lane's walk, one site per word (rows and out point at the lane's
// column), two steps per iteration as walk_sliced; returns its events
// times its weight.
__device__ __forceinline__ float walk_sites(const int2* kids, const uint32_t* rows,
                                            uint32_t* out_row, int row, int n_anc, float w) {
  uint32_t last = 0;
  int prev = -1;
  int here = static_cast<int>(out_row - rows);
  int events = 0;
  auto step = [&](int2 k, uint32_t a, uint32_t b) {
    const uint32_t x = k.x == prev ? last : a;
    const uint32_t inter = x & b;
    const bool empty = inter == 0;
    last = empty ? (x | b) : inter;
    events += empty;
    *out_row = last;
    prev = here;
    here += row;
    out_row += row;
  };
  int2 k0 = kids[0];
  int2 k1 = kids[1];
  uint32_t a0 = rows[k0.x], b0 = rows[k0.y];
  int a = 0;
  for (; a + 1 < n_anc; a += 2) {
    const int2 k2 = kids[a + 2];
    const uint32_t a1 = rows[k1.x], b1 = rows[k1.y];
    step(k0, a0, b0);
    const int2 k3 = kids[a + 3];
    a0 = rows[k2.x];
    b0 = rows[k2.y];
    step(k1, a1, b1);
    k0 = k2;
    k1 = k3;
  }
  if (a < n_anc) step(k0, a0, b0);
  return static_cast<float>(events) * w;
}

// NQ = 4 or 8 planes per 32 sites, or NQ == 0: one site per word.
template <int NQ>
__global__ void __launch_bounds__(kThreads) fitch_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long t_start = clock64();
  const int n = p.n_leaves;
  const int n_anc = n - 1;
  const int W = p.width;
  const int T = p.slots;
  const int row = NQ ? NQ * W : W;
  const int n_kids = T * n_anc;
  // Layout: staged children (n_kids + 2 int2) | raw children of the next
  // round (n_kids int2, when rounds > 1) | table: leaves, then each slot's
  // ancestors (row words a node) | weights.
  const size_t kids_bytes = align16(8 * static_cast<size_t>(n_kids + 2));
  const size_t raw_bytes = p.rounds > 1 ? align16(8 * static_cast<size_t>(n_kids)) : 0;
  int2* kids = reinterpret_cast<int2*>(smem);
  int2* raw = p.rounds > 1 ? reinterpret_cast<int2*>(smem + kids_bytes) : kids;
  uint32_t* table = reinterpret_cast<uint32_t*>(smem + kids_bytes + raw_bytes);
  float* wsm = reinterpret_cast<float*>(table + (n + n_kids) * row);

  issue_children(p, raw, 0);
  if constexpr (NQ > 0) {
    stage_sliced<NQ>(p, table, wsm, blockIdx.x * W);
  } else {
    stage_sites(p, table, wsm, blockIdx.x * W);
  }
  cp_async_wait_all();
  __syncthreads();
  place_children(p, raw, kids, row, 0);
  __syncthreads();
  const long long t_staged = clock64();
  long long walk_cycles = 0, expand_cycles = 0, children_cycles = 0;

  const int tid = threadIdx.x;
  const int j = tid / W;
  const int wl = tid - j * W;
  const int group = W < 32 ? W : 32;  // lanes of one tree within a warp
  const int kplanes = max(3, 32 - __clz(max(n_anc, 1)));
  for (int r = 0; r < p.rounds; ++r) {
    if (r + 1 < p.rounds) issue_children(p, raw, r + 1);
    const int tree = (blockIdx.y * p.rounds + r) * T + j;
    const bool on = j < T && tree < p.batch;
    const long long t0 = clock64();
    float acc = 0.0f;
    long long t1 = t0;
    if (on) {
      const int out = (n + j * n_anc) * row;
      if constexpr (NQ > 0) {
        uint32_t h[kCounterPlanes];
#pragma unroll
        for (int i = 0; i < kCounterPlanes; ++i) h[i] = 0;
        walk_sliced<NQ / 4>(kids + j * n_anc, table + 4 * wl, table + out + 4 * wl, 4 * W, row,
                            n_anc, h);
        t1 = clock64();
        acc = expand(h, kplanes, wsm + wl, W);
      } else {
        acc = walk_sites(kids + j * n_anc, table + wl, table + out + wl, row, n_anc, wsm[wl]);
        t1 = clock64();
      }
    }
    for (int offset = group >> 1; offset > 0; offset >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, offset, group);
    }
    if (on && (tid & (group - 1)) == 0 && acc != 0.0f) atomicAdd(p.scores + tree, acc);
    const long long t2 = clock64();
    walk_cycles += t1 - t0;
    expand_cycles += t2 - t1;
    if (r + 1 < p.rounds) {
      cp_async_wait_all();
      __syncthreads();
      place_children(p, raw, kids, row, r + 1);
      __syncthreads();
      children_cycles += clock64() - t2;
    }
  }
  if (p.phase_cycles != nullptr && tid == 0) {
    long long* out = p.phase_cycles + 4 * (blockIdx.y * gridDim.x + blockIdx.x);
    out[0] = t_staged - t_start;
    out[1] = walk_cycles;
    out[2] = expand_cycles;
    out[3] = children_cycles;
  }
}

// The global mode: thread `site` of block (chunk, group) walks the trees
// group, group + groups, ... in turn; each ancestor's row goes to the
// group's (n_anc, L) scratch. The children are read one step ahead (two
// measured slower) and the rows of the next step loaded before this step's
// store, the one that can be stale (this step's own) forwarded from
// registers.
__global__ void __launch_bounds__(kThreads) fitch_global_kernel(Params p,
                                                                uint32_t* __restrict__ rows) {
  const int n = p.n_leaves;
  const int n_anc = n - 1;
  const size_t L = p.length;
  const int site = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = site < p.length;
  const float w = live ? __ldg(p.weights + site) : 0.0f;
  const int* leaves = p.masks + site;
  uint32_t* anc = rows + static_cast<size_t>(blockIdx.y) * n_anc * L + site;
  auto load = [&](int c) -> uint32_t {
    return c < n ? static_cast<uint32_t>(__ldg(leaves + c * L))
                 : anc[static_cast<size_t>(c - n) * L];
  };
  for (int r = 0; r < p.rounds; ++r) {
    const int tree = blockIdx.y + r * gridDim.y;
    if (tree >= p.batch) break;  // the same for the whole block
    const int2* kids = reinterpret_cast<const int2*>(p.children) + static_cast<size_t>(tree) * n_anc;
    int events = 0;
    if (live) {
      const int2 k = __ldg(kids);
      uint32_t a = load(k.x), b = load(k.y);
      for (int i = 0; i < n_anc; ++i) {
        const int2 next = i + 1 < n_anc ? __ldg(kids + i + 1) : make_int2(0, 0);
        const uint32_t na = load(next.x), nb = load(next.y);
        const uint32_t inter = a & b;
        const bool empty = inter == 0;
        const uint32_t set = empty ? (a | b) : inter;
        events += empty;
        anc[static_cast<size_t>(i) * L] = set;
        a = next.x == n + i ? set : na;
        b = next.y == n + i ? set : nb;
      }
    }
    float acc = static_cast<float>(events) * w;
    for (int offset = 16; offset > 0; offset >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, offset);
    }
    if ((threadIdx.x & 31) == 0 && acc != 0.0f) atomicAdd(p.scores + tree, acc);
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
// (once per device and process), then zeroes the scores (in the pre-pass,
// for the bit-sliced modes) and launches the kernel.
template <int NQ>
cudaError_t launch(int device, int optin, dim3 grid, int shared_bytes, cudaStream_t stream,
                   const Params& p, uint32_t* planes) {
  static bool opted_in[kMaxDevices] = {};
  if (!opted_in[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        fitch_kernel<NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  if constexpr (NQ == 0) {
    const cudaError_t err = cudaMemsetAsync(p.scores, 0, sizeof(float) * p.batch, stream);
    if (err != cudaSuccess) return err;
  } else {
    const int tasks = p.n_leaves * (p.n_words / 4);
    const int warps = kThreads / 32;
    pack_kernel<NQ><<<(tasks + warps - 1) / warps, kThreads, 0, stream>>>(
        p.masks, planes, p.scores, p.batch, p.n_leaves, p.length, p.n_words);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  fitch_kernel<NQ><<<grid, kThreads, shared_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// children (B, n_anc, 2) int32 (8-byte aligned), masks (n_leaves, L)
// int32, weights (L,) f32, scores (B,) f32 (zeroed here, on the stream);
// planes: for the bit-sliced modes an (n_leaves, planes / 4, n_words, 4)
// int32 scratch (n_words = 4 * ceil(L / 128)) that the pre-pass fills,
// else null; phase_cycles null, or (tree_groups * chunks, 4) int64 that
// receives each block's clock64 cycles of staging, walks, expansion and
// children restaging. planes (0, 4 or 8), width, slots,
// rounds, chunks, tree_groups, shared_bytes and staged come from the launch
// plan; staged == 0 is the global mode, whose (tree_groups, n_leaves - 1,
// L) int32 scratch of ancestor rows is planes_scratch, and which leaves
// phase_cycles as it is.
// Launches on `stream`, does not synchronise, allocates nothing. Returns
// the CUDA error code (0 = launched).
extern "C" int trex_fitch_batched(const void* children, const void* masks, const void* weights,
                                  void* planes_scratch, void* scores, void* phase_cycles,
                                  int batch, int n_leaves, int length, int planes, int width,
                                  int slots, int rounds, int chunks, int tree_groups,
                                  int shared_bytes, int staged, void* stream) {
  int device = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = device_optin(device, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool pow2 = width > 0 && (width & (width - 1)) == 0;
  if (!pow2 || (planes > 0 && (width > 32 || planes_scratch == nullptr)) || slots < 1 ||
      rounds < 1 || slots * width > kThreads || shared_bytes > optin || n_leaves < 2 ||
      chunks < 1 || tree_groups < 1 || tree_groups > 65535 ||
      (reinterpret_cast<size_t>(children) & 7) != 0 ||
      (reinterpret_cast<size_t>(planes_scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* scratch = static_cast<uint32_t*>(planes_scratch);
  const Params p{static_cast<const int*>(children), static_cast<const int*>(masks), scratch,
                 static_cast<const float*>(weights), static_cast<float*>(scores),
                 static_cast<long long*>(phase_cycles), batch, n_leaves, length,
                 4 * ((length + 127) / 128), width, slots, rounds};
  const dim3 grid(chunks, tree_groups);
  const auto s = static_cast<cudaStream_t>(stream);
  if (!staged) {
    if (planes != 0 || slots != 1 || width < 32 || scratch == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    err = cudaMemsetAsync(p.scores, 0, sizeof(float) * batch, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    fitch_global_kernel<<<grid, width, 0, s>>>(p, scratch);
    return static_cast<int>(cudaGetLastError());
  }
  switch (planes) {
    case 0: err = launch<0>(device, optin, grid, shared_bytes, s, p, scratch); break;
    case 4: err = launch<4>(device, optin, grid, shared_bytes, s, p, scratch); break;
    case 8: err = launch<8>(device, optin, grid, shared_bytes, s, p, scratch); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
