// B1 stream_scan: the per-connection EWMA + Welford detector step over
// a group of [T, U] slot tiles (one per shard of a fused step), with
// the state gather and scatter fused in, in one launch.
//
// Replaces the TPU kernel theia_tpu/ops/fused_detector.py::
// _scan_tile_pallas together with the gather and scatter around it in
// _stream_half: for each tile this kernel computes what the port's
// _stream_half_plain does.
//
// What bounds it on an H100: memory, and at the main path's shapes the
// launch. Per live slot column a tile reads 16 B of state and 4 B of
// slot id, writes 16 B of state, and per tick cell reads 4 B of x and
// 1 B of active and writes 1 B of anom: 36 + 6*T B. About a dozen
// float operations per cell and no tensor-core work, so the bytes over
// 3.35 TB/s are the bound. A fused step's tiles are small (T = 1,
// U = 8,192 is typical: ~80 ns of bytes), so one launch per tile was
// all launch; the group makes it one launch per step.
//
// Design:
// - One launch for every tile of a step. The per-tile pointers and
//   sizes travel by value in a __grid_constant__ parameter struct of at
//   most kMaxTiles tiles (about 1.3 KB of the 4 KB of kernel
//   parameters), so no descriptor is copied to the device. The grid is
//   the sum over tiles of ceil(U / kThreads) blocks; a block finds its
//   tile in the table of first blocks, which the caller computes.
// - One thread per slot column u of its tile. A thread whose slot is
//   live (slots[u] < capacity) loads its four state words from the full
//   state arrays, walks the T ticks in registers (x[t,u], active[t,u]
//   and anom[t,u] are read and written at neighbouring addresses by
//   neighbouring threads, so the tile traffic is coalesced), and writes
//   the state back through slots[u].
// - For T in {1, 2, 4, 8} (the buckets StreamingDetector.build_plan
//   pads to on the main path) the tick loop is a template unrolled at
//   compile time: every tick's x and active loads are issued before the
//   dependent scan, so they are in flight together. Other T take a
//   loop.
// - Padding columns (slots[u] == capacity) start from a zero state,
//   read and write no state row, and their anom is whatever their
//   (inactive) ticks give: false. The live slots of one tile are
//   distinct (build_plan takes them from np.unique), and the caller
//   refuses two tiles whose state arrays overlap, so no two threads
//   write the same row.
//
// Rounding: explicit round-to-nearest intrinsics (__fadd_rn, __fsub_rn,
// __fmul_rn, __fdiv_rn, __fsqrt_rn) for every float operation, so nvcc
// cannot contract a multiply and an add into an FMA whatever the build
// flags or the unrolling. The result is bit-exact with the plain
// PyTorch version (theia_tpu_torch/ops/fused_detector.py::
// _stream_half_plain), whose every tensor op rounds once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTiles = 16;

struct Tile {
  float* ewma;
  int32_t* count;
  float* mean;
  float* m2;
  const int32_t* slots;
  const float* x;
  const uint8_t* active;
  uint8_t* anom;
  int T, U, capacity, first_block;
};

struct Group {
  Tile tile[kMaxTiles];
  int n;
  float alpha, one_minus;
};

struct Carry {
  float e, mu, q;
  int c;
};

// One tick of the recurrence; returns the anomaly flag.
__device__ __forceinline__ bool tick(Carry& s, bool act, float xv,
                                     float alpha, float one_minus) {
  const float xa = act ? xv : 0.0f;
  s.c += act ? 1 : 0;
  const float delta = __fsub_rn(xa, s.mu);
  if (act) {
    s.mu = __fadd_rn(s.mu, __fdiv_rn(delta, static_cast<float>(max(s.c, 1))));
    s.q = __fadd_rn(s.q, __fmul_rn(delta, __fsub_rn(xa, s.mu)));
    s.e = __fadd_rn(__fmul_rn(one_minus, s.e), __fmul_rn(alpha, xa));
  }
  const float sd =
      __fsqrt_rn(__fdiv_rn(s.q, static_cast<float>(max(s.c - 1, 1))));
  return act && s.c >= 2 && fabsf(__fsub_rn(xa, s.e)) > sd;
}

// kT ticks, unrolled: all loads first, then the scan.
template <int kT>
__device__ __forceinline__ void scan_fixed(const Tile& tl, int u, Carry& s,
                                           float alpha, float one_minus) {
  float xv[kT];
  uint8_t av[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    const size_t i = static_cast<size_t>(t) * tl.U + u;
    av[t] = tl.active[i];
    xv[t] = tl.x[i];
  }
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    const size_t i = static_cast<size_t>(t) * tl.U + u;
    tl.anom[i] = tick(s, av[t] != 0, xv[t], alpha, one_minus) ? 1 : 0;
  }
}

__device__ __forceinline__ void scan_any(const Tile& tl, int u, Carry& s,
                                         float alpha, float one_minus) {
  for (int t = 0; t < tl.T; ++t) {
    const size_t i = static_cast<size_t>(t) * tl.U + u;
    const bool act = tl.active[i] != 0;
    tl.anom[i] = tick(s, act, act ? tl.x[i] : 0.0f, alpha, one_minus)
                     ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    stream_scan_kernel(const __grid_constant__ Group g) {
  // the block's tile: the last one whose first block is <= blockIdx.x
  // (uniform over the block)
  int k = 0;
  while (k + 1 < g.n && static_cast<int>(blockIdx.x) >=
                            g.tile[k + 1].first_block) {
    ++k;
  }
  const Tile& tl = g.tile[k];
  const int u = (static_cast<int>(blockIdx.x) - tl.first_block) * kThreads +
                static_cast<int>(threadIdx.x);
  if (u >= tl.U) return;
  const int slot = tl.slots[u];
  const bool live = slot >= 0 && slot < tl.capacity;
  Carry s{0.0f, 0.0f, 0.0f, 0};
  if (live) {
    s.e = tl.ewma[slot];
    s.c = tl.count[slot];
    s.mu = tl.mean[slot];
    s.q = tl.m2[slot];
  }
  switch (tl.T) {
    case 1: scan_fixed<1>(tl, u, s, g.alpha, g.one_minus); break;
    case 2: scan_fixed<2>(tl, u, s, g.alpha, g.one_minus); break;
    case 4: scan_fixed<4>(tl, u, s, g.alpha, g.one_minus); break;
    case 8: scan_fixed<8>(tl, u, s, g.alpha, g.one_minus); break;
    default: scan_any(tl, u, s, g.alpha, g.one_minus); break;
  }
  if (live) {
    tl.ewma[slot] = s.e;
    tl.count[slot] = s.c;
    tl.mean[slot] = s.mu;
    tl.m2[slot] = s.q;
  }
}

}  // namespace

// The limits the Python wrapper plans its launches with; it checks them
// against its own constants when it loads the library.
extern "C" int stream_scan_max_tiles() { return kMaxTiles; }
extern "C" int stream_scan_threads() { return kThreads; }

// Plain C entry point (loaded with ctypes). One launch over n tiles
// (1 <= n <= kMaxTiles). Tile k's pointers are ptrs[8k .. 8k+7]: ewma,
// count, mean, m2, slots, x, active, anom; its sizes T[k], U[k],
// capacity[k]; first[k] is its first block and first[n] the grid size
// (first[0] == 0, each tile ceil(U / kThreads) blocks). Launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan it refuses.
extern "C" int stream_scan_grouped_launch(const int64_t* ptrs,
                                          const int32_t* T,
                                          const int32_t* U,
                                          const int32_t* capacity,
                                          const int32_t* first, int n,
                                          float alpha, float one_minus,
                                          void* stream) {
  if (n < 1 || n > kMaxTiles || first[0] != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Group g;
  g.n = n;
  g.alpha = alpha;
  g.one_minus = one_minus;
  for (int k = 0; k < n; ++k) {
    const int64_t* p = ptrs + 8 * k;
    Tile& tl = g.tile[k];
    tl.ewma = reinterpret_cast<float*>(p[0]);
    tl.count = reinterpret_cast<int32_t*>(p[1]);
    tl.mean = reinterpret_cast<float*>(p[2]);
    tl.m2 = reinterpret_cast<float*>(p[3]);
    tl.slots = reinterpret_cast<const int32_t*>(p[4]);
    tl.x = reinterpret_cast<const float*>(p[5]);
    tl.active = reinterpret_cast<const uint8_t*>(p[6]);
    tl.anom = reinterpret_cast<uint8_t*>(p[7]);
    tl.T = T[k];
    tl.U = U[k];
    tl.capacity = capacity[k];
    tl.first_block = first[k];
    if (T[k] < 1 || U[k] < 1 ||
        first[k + 1] - first[k] != (U[k] + kThreads - 1) / kThreads) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  stream_scan_kernel<<<first[n], kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
