// B1 stream_scan: the per-connection EWMA + Welford detector step over
// one shard's [T, U] slot tile, with the state gather and scatter fused
// in.
//
// Replaces the TPU kernel theia_tpu/ops/fused_detector.py::
// _scan_tile_pallas together with the gather and scatter around it in
// _stream_half: this kernel computes what the port's _stream_half does.
//
// What bounds it on an H100: memory. Per live slot column it reads 16 B
// of state and 4 B of slot id, writes 16 B of state, and per tick cell
// reads 4 B of x and 1 B of active and writes 1 B of anom: 36 + 6*T B.
// About a dozen float operations per cell and no tensor-core work, so
// the bytes over 3.35 TB/s are the bound (at the main path's shapes the
// launch itself, a few microseconds, is larger still).
//
// Design: one thread per slot column u. A thread whose slot is live
// (slots[u] < capacity) loads its four state words from the full state
// arrays, walks the T ticks in registers (x[t,u], active[t,u] and
// anom[t,u] are read and written at neighbouring addresses by
// neighbouring threads, so the tile traffic is coalesced), and writes
// the state back through slots[u]. Padding columns (slots[u] ==
// capacity) start from a zero state, read and write no state row, and
// their anom is whatever their (inactive) ticks give: false. The live
// slots of one tile are distinct (StreamingDetector.build_plan takes
// them from np.unique), so no two threads write the same row.
//
// Rounding: explicit round-to-nearest intrinsics (__fadd_rn, __fsub_rn,
// __fmul_rn, __fdiv_rn, __fsqrt_rn) for every float operation, so nvcc
// cannot contract a multiply and an add into an FMA whatever the build
// flags. The result is bit-exact with the plain PyTorch version
// (theia_tpu_torch/ops/fused_detector.py::_stream_half_plain), whose
// every tensor op rounds once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void stream_scan_kernel(float* __restrict__ ewma,
                                   int32_t* __restrict__ count,
                                   float* __restrict__ mean,
                                   float* __restrict__ m2,
                                   const int32_t* __restrict__ slots,
                                   const float* __restrict__ x,
                                   const uint8_t* __restrict__ active,
                                   uint8_t* __restrict__ anom,
                                   int T, int U, int capacity,
                                   float alpha, float one_minus) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= U) return;
  const int s = slots[u];
  const bool live = s >= 0 && s < capacity;
  float e = 0.0f, mu = 0.0f, q = 0.0f;
  int c = 0;
  if (live) {
    e = ewma[s];
    c = count[s];
    mu = mean[s];
    q = m2[s];
  }
  for (int t = 0; t < T; ++t) {
    const size_t i = static_cast<size_t>(t) * U + u;
    const bool act = active[i] != 0;
    const float xa = act ? x[i] : 0.0f;
    c += act ? 1 : 0;
    const float delta = __fsub_rn(xa, mu);
    if (act) {
      mu = __fadd_rn(mu, __fdiv_rn(delta, static_cast<float>(max(c, 1))));
      q = __fadd_rn(q, __fmul_rn(delta, __fsub_rn(xa, mu)));
      e = __fadd_rn(__fmul_rn(one_minus, e), __fmul_rn(alpha, xa));
    }
    const float sd =
        __fsqrt_rn(__fdiv_rn(q, static_cast<float>(max(c - 1, 1))));
    anom[i] = (act && c >= 2 && fabsf(__fsub_rn(xa, e)) > sd) ? 1 : 0;
  }
  if (live) {
    ewma[s] = e;
    count[s] = c;
    mean[s] = mu;
    m2[s] = q;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does
// not synchronise, allocates nothing; returns cudaGetLastError() so the
// caller can raise on a refused launch.
extern "C" int stream_scan_launch(float* ewma, int32_t* count, float* mean,
                                  float* m2, const int32_t* slots,
                                  const float* x, const uint8_t* active,
                                  uint8_t* anom, int T, int U, int capacity,
                                  float alpha, float one_minus,
                                  void* stream) {
  if (U > 0 && T > 0) {
    const int blocks = (U + kThreads - 1) / kThreads;
    stream_scan_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        ewma, count, mean, m2, slots, x, active, anom, T, U, capacity,
        alpha, one_minus);
  }
  return static_cast<int>(cudaGetLastError());
}
