// K2 — the join penalties of one stepwise insertion: for the inserted leaf
// t, delta[v] = sum over sites of w * [(up[t] & ctx[v]) == 0], where ctx is
// the Fitch-combined up/down context of the edge above v in the pruned
// variant tree.
//
// Replaces: trex_tpu/ops/insertion_pallas.py `_insertion_kernel`, reached
// through `insertion_delta_pallas` from every step of the stepwise-addition
// loop (trex_tpu/search/stepwise.py `_stepwise_block`). The TPU kernel keeps
// its (n_all, site block) down table in VMEM; here it lives in shared
// memory.
//
// What bounds it on this card. Bytes: the (n_all, L) up table, the
// children, the weights in and delta out, about 4 * n_all * L bytes (2.5 us
// of HBM at 512 taxa x 2048 sites). That bound cannot be reached: the down
// pass is a chain of n_anc dependent steps per site (each ancestor's
// context comes from its parent's step), so the kernel's floor is n_anc
// times the latency of one step, whatever the number of sites, and one
// walking warp per SM cannot hide that latency behind other warps.
//
// What the design does about it.
// - Each block takes S sites (`ops/insertion_cuda.py::launch_plan` picks S
//   so that about one block lands on each SM) and keeps the whole (n_all,
//   S) down table in dynamic shared memory, rows padded to an odd pitch:
//   at every step the walking threads touch one row at consecutive words,
//   and the delta pass's per-thread rows hit distinct banks.
// - When they fit beside the table (kStaged), the block stages the
//   children and, in walk order, the pair of up rows each ancestor step
//   reads, so a step's three shared-memory loads (children, up pair,
//   down) depend on nothing the walk writes. They are issued one step
//   ahead, before the previous step's stores; the one value that can be
//   stale, a down row the previous step wrote, is forwarded from
//   registers. What is left per step is a few dependent integer ops and
//   two stores. Otherwise (trees of about 9.7k taxa and more on an H100) the
//   children and up rows are read from global memory in the same order.
// - Up rows may carry the stepwise event flag in bit 30: every up read is
//   masked, so the caller hands its flagged table over without a copy.
// - Delta pass: after a barrier every thread takes whole rows v, sums the
//   row's S sites in registers (up rows from global, 16-byte loads) and
//   adds one partial per (row, block) to delta[v] with atomicAdd:
//   integer-valued floats, exact in any order while totals stay below
//   2^24, so the result is bit-equal to the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFlagless = 0x3fffffff;  // drops the event flag (bits 30, 31)
constexpr int kMaxDevices = 64;

// Fitch combine with 0 = "no information" (ops/spr_scan.py `_combine0`): an
// empty intersection of a and b also covers a == 0 (gives b) and b == 0
// (gives a), so one select suffices.
__device__ __forceinline__ int combine0(int a, int b) {
  const int inter = a & b;
  return inter == 0 ? (a | b) : inter;
}

// One site's down pass, root -> leaves, by the calling thread: step a reads
// the children k of ancestor n_leaves + a, the up pair u = (up[k.x],
// up[k.y]) (0 for a pass-through row, since combine0(d, 0) = d forwards
// the context) and d = down[n_leaves + a], and writes down[k.x] =
// combine0(d, u.y), down[k.y] = combine0(d, u.x). Each step's loads are
// issued before the previous step's stores; d is then stale only where the
// previous step wrote it, and that context is forwarded from registers.
template <bool kStaged>
__device__ __forceinline__ void walk(const int2* kids, const int2* upair,
                                     const int* up_col, size_t stride, int* dcol,
                                     int n_leaves, int pitch) {
  const int n_anc = n_leaves - 1;
  auto up_pair = [&](int2 k, const int2* staged) -> int2 {
    if constexpr (kStaged) {
      return *staged;
    } else {
      if (k.x == k.y) return make_int2(0, 0);
      return make_int2(__ldg(up_col + k.x * stride) & kFlagless,
                       __ldg(up_col + k.y * stride) & kFlagless);
    }
  };
  const int2* kptr = kids + (n_anc - 1);
  const int2* uptr = upair + (n_anc - 1) * pitch;
  int* dptr = dcol + (n_leaves + n_anc - 1) * pitch;
  int2 k = *kptr;
  int2 u = up_pair(k, uptr);
  int d = *dptr;
  int p1 = -1, p2 = -1, x1 = 0, x2 = 0;  // the previous step's writes
  int node = n_leaves + n_anc - 1;
#pragma unroll 4
  for (int a = n_anc - 1; a > 0; --a) {
    kptr -= 1;
    uptr -= pitch;
    dptr -= pitch;
    const int2 kn = *kptr;
    const int2 un = up_pair(kn, uptr);
    const int dn = *dptr;
    d = p1 == node ? x1 : d;
    d = p2 == node ? x2 : d;
    x1 = combine0(d, u.y);
    x2 = combine0(d, u.x);
    dcol[k.x * pitch] = x1;
    dcol[k.y * pitch] = x2;
    p1 = k.x;
    p2 = k.y;
    k = kn;
    u = un;
    d = dn;
    --node;
  }
  d = p1 == node ? x1 : d;
  d = p2 == node ? x2 : d;
  dcol[k.x * pitch] = combine0(d, u.y);
  dcol[k.y * pitch] = combine0(d, u.x);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
insertion_delta_kernel(const int* __restrict__ var_children,
                       const int* __restrict__ up,
                       const float* __restrict__ weights,
                       float* __restrict__ delta, long long* __restrict__ phase_cycles,
                       int n_leaves, int length, int t_node, int sites_per_block) {
  extern __shared__ __align__(16) int smem[];
  const long long t_start = clock64();
  const int n_anc = n_leaves - 1;
  const int n_all = 2 * n_leaves - 1;
  const int s_count = sites_per_block;
  const int pitch = s_count | 1;
  const int site0 = blockIdx.x * s_count;
  const int tid = threadIdx.x;
  const size_t stride = static_cast<size_t>(length);
  const int live = min(s_count, length - site0);
  // 16-byte loads of up rows when the block's sites are whole aligned quads.
  const bool quads = (s_count & 3) == 0 && (length & 3) == 0 && live == s_count &&
                     (reinterpret_cast<size_t>(up) & 15) == 0;
  const int2* kids_in = reinterpret_cast<const int2*>(var_children);

  // Layout: [staged: up pairs in walk order (n_anc x pitch int2) | children
  // (n_anc int2)] | down (n_all x pitch) | tset (S) | weights (S).
  int2* upair = reinterpret_cast<int2*>(smem);
  int2* kids = upair + (kStaged ? n_anc * pitch : 0);
  int* down = reinterpret_cast<int*>(kids + (kStaged ? n_anc : 0));
  int* tset = down + n_all * pitch;
  float* w = reinterpret_cast<float*>(tset + s_count);

  // Rows the walk never writes (the root, the pruned leaf) read as 0.
  for (int i = tid; i < n_all * pitch; i += kThreads) down[i] = 0;
  for (int s = tid; s < s_count; s += kThreads) {
    const bool on = s < live;
    tset[s] = on ? (__ldg(up + t_node * stride + site0 + s) & kFlagless) : 0;
    w[s] = on ? __ldg(weights + site0 + s) : 0.0f;
  }
  if constexpr (kStaged) {
    for (int i = tid; i < n_anc; i += kThreads) kids[i] = __ldg(kids_in + i);
    __syncthreads();
    // Row 2a + j of the walk-order table is up[children[a][j]], stored as
    // the j half of the pair at (a, site).
    int* pairs = reinterpret_cast<int*>(upair);
    if (quads) {
      const int per_row = s_count >> 2;
#pragma unroll 8
      for (int i = tid; i < 2 * n_anc * per_row; i += kThreads) {
        const int r = i / per_row;
        const int s = (i - r * per_row) << 2;
        const int a = r >> 1;
        const int j = r & 1;
        const int2 k = kids[a];
        int4 v = make_int4(0, 0, 0, 0);
        if (k.x != k.y)
          v = __ldg(reinterpret_cast<const int4*>(up + (j ? k.y : k.x) * stride + site0 + s));
        int* dst = pairs + 2 * (a * pitch + s) + j;
        dst[0] = v.x & kFlagless;
        dst[2] = v.y & kFlagless;
        dst[4] = v.z & kFlagless;
        dst[6] = v.w & kFlagless;
      }
    } else {
#pragma unroll 8
      for (int i = tid; i < 2 * n_anc * s_count; i += kThreads) {
        const int r = i / s_count;
        const int s = i - r * s_count;
        const int a = r >> 1;
        const int j = r & 1;
        const int2 k = kids[a];
        pairs[2 * (a * pitch + s) + j] =
            (k.x == k.y || s >= live)
                ? 0 : (__ldg(up + (j ? k.y : k.x) * stride + site0 + s) & kFlagless);
      }
    }
  }
  __syncthreads();
  const long long t_staged = clock64();

  if (n_anc > 0 && tid < live) {
    walk<kStaged>(kStaged ? kids : kids_in, upair + tid, up + site0 + tid, stride,
                  down + tid, n_leaves, pitch);
  }
  __syncthreads();
  const long long t_walked = clock64();

  // Delta pass: one row per thread at a time, its S sites summed in order.
  for (int v = tid; v < n_all; v += kThreads) {
    const int* up_row = up + v * stride + site0;
    const int* down_row = down + v * pitch;
    float term = 0.0f;
    if (quads) {
      for (int s = 0; s < s_count; s += 4) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(up_row + s));
        term += (tset[s] & combine0(q.x & kFlagless, down_row[s])) == 0 ? w[s] : 0.0f;
        term += (tset[s + 1] & combine0(q.y & kFlagless, down_row[s + 1])) == 0 ? w[s + 1] : 0.0f;
        term += (tset[s + 2] & combine0(q.z & kFlagless, down_row[s + 2])) == 0 ? w[s + 2] : 0.0f;
        term += (tset[s + 3] & combine0(q.w & kFlagless, down_row[s + 3])) == 0 ? w[s + 3] : 0.0f;
      }
    } else {
      for (int s = 0; s < live; ++s) {
        const int ctx = combine0(__ldg(up_row + s) & kFlagless, down_row[s]);
        term += (tset[s] & ctx) == 0 ? w[s] : 0.0f;
      }
    }
    if (term != 0.0f) atomicAdd(delta + v, term);
  }
  if (phase_cycles != nullptr) {
    __syncthreads();
    if (tid == 0) {
      long long* out = phase_cycles + 3 * blockIdx.x;
      out[0] = t_staged - t_start;
      out[1] = t_walked - t_staged;
      out[2] = clock64() - t_walked;
    }
  }
}

// The device's opt-in shared memory per block, cached per device.
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

// Opts the kernel in to the device's full dynamic shared memory (once per
// device and process), then launches it.
template <bool kStaged>
cudaError_t launch(int device, int optin_bytes, int blocks, int shared_bytes,
                   cudaStream_t stream, const int* var_children, const int* up,
                   const float* weights, float* delta, long long* phase_cycles,
                   int n_leaves, int length, int t_node, int sites_per_block) {
  static bool opted_in[kMaxDevices] = {};
  if (!opted_in[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        insertion_delta_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin_bytes);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  insertion_delta_kernel<kStaged><<<blocks, kThreads, shared_bytes, stream>>>(
      var_children, up, weights, delta, phase_cycles, n_leaves, length, t_node,
      sites_per_block);
  return cudaGetLastError();
}

}  // namespace

// The current device's opt-in shared memory per block (bytes) and SM count.
// Returns the CUDA error code (0 = success).
extern "C" int trex_insertion_device_limits(int* optin_bytes, int* n_sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = device_optin(device, optin_bytes);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, device);
  return static_cast<int>(err);
}

// var_children (n_anc, 2) int32, up (n_all, L) int32 up sets (bit 30 may
// carry a flag; it is masked), weights (L,) f32, delta (n_all,) f32
// zero-filled by the caller; phase_cycles null, or (blocks, 3) int64 that
// receives each block's clock64 cycles of staging, walk and delta pass.
// sites_per_block, staged and shared_bytes come from the launch plan.
// Launches on `stream`, does not synchronise, allocates nothing. Returns
// the CUDA error code (0 = launched).
extern "C" int trex_insertion_delta(const void* var_children, const void* up,
                                    const void* weights, void* delta, void* phase_cycles,
                                    int n_leaves, int length, int t_node,
                                    int sites_per_block, int staged, int shared_bytes,
                                    void* stream) {
  int device = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = device_optin(device, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sites_per_block < 1 || sites_per_block > kThreads || shared_bytes > optin)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (length + sites_per_block - 1) / sites_per_block;
  const auto* kids = static_cast<const int*>(var_children);
  const auto* up_sets = static_cast<const int*>(up);
  const auto* w = static_cast<const float*>(weights);
  auto* out = static_cast<float*>(delta);
  auto* clocks = static_cast<long long*>(phase_cycles);
  const auto s = static_cast<cudaStream_t>(stream);
  err = staged ? launch<true>(device, optin, blocks, shared_bytes, s, kids, up_sets, w, out,
                              clocks, n_leaves, length, t_node, sites_per_block)
               : launch<false>(device, optin, blocks, shared_bytes, s, kids, up_sets, w, out,
                               clocks, n_leaves, length, t_node, sites_per_block);
  return static_cast<int>(err);
}
