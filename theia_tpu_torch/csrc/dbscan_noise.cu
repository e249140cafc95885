// B2 dbscan_noise: DBSCAN noise flags for a padded [S, T] batch of 1-D
// throughput series, each series clustered on its own.
//
// Replaces the TPU kernel theia_tpu/ops/dbscan_pallas.py::
// dbscan_noise_pallas (kernel _dbscan_kernel). Per series, over its
// valid points (mask):
//
//   within_ij = |x_i - x_j| <= eps  and m_i and m_j
//   count_i   = sum_j within_ij            (self included)
//   core_i    = count_i >= min_samples and m_i
//   reach_i   = exists j: core_j and within_ij
//   noise_i   = m_i and not core_i and not reach_i
//
// What bounds it on an H100: operations, in the pair tests; but only the
// tests a point needs. Pass 1 only asks whether count_i reaches
// min_samples, so a point is decided at its min_samples-th neighbour;
// pass 2 only asks about valid non-core points, and only until their
// first core neighbour. The bytes are x (4 or 8 B), the mask and the
// flag (1 B each) per point.
//
// Design, shared by both routes:
// - The mask is folded into x on the j side: a staged j holds
//   m_j ? x_j : NaN, and |x_i - NaN| <= eps is false, exactly as m_j = 0
//   makes within_ij false (a valid NaN or +-inf x_j was within no one
//   already). Pass 2 stages core_j ? x_j : NaN the same way. So a pair
//   test is one subtraction, an absolute value and one comparison
//   against one shared load. The i side keeps m_i for its own flag: a
//   valid NaN x_i is noise.
// - Register tiling: a thread owns R points i, and each shared load (a
//   float4 of four j's) serves all of them. A warp's points are
//   consecutive in the series (owned_point), so where the data has runs
//   of similar values a warp's early exit is not held up by a point far
//   away in the series.
// - Warp-uniform early exit, voted every kCheck j's: pass 1 stops for a
//   warp once each of its points is invalid or has count >= min_samples;
//   pass 2 once each is invalid, core or reached. Both are exact: the
//   count only grows, and reach only turns true.
// - x is read as it comes: float32, or float64 rounded in the kernel by
//   __double2float_rn (round to nearest even, what .to(torch.float32)
//   does; the build has no --use_fast_math, so no flush to zero).
//
// Two routes, picked by the caller (theia_tpu_torch/ops/dbscan.py::
// _plan) from (S, T):
// - one launch (dbscan_one_launch_kernel): a block stages whole series
//   in shared memory, runs pass 1, then pass 2, and writes each flag
//   once; no workspace. A series is P threads of R points (R = 2, or 4
//   above T = 2,048); at small T several series share a block (a block
//   has at least 128 threads). Up to T = 4,096 (1,024 threads, 32 KB of
//   shared memory, under the 48 KB that needs no opt-in).
// - two passes (dbscan_core_kernel, dbscan_reach_kernel) for long series
//   when there are too few of them to give every SM a block: a grid of
//   (series, 256-point i-tile) blocks walks the series in staged j-tiles;
//   pass 1 writes core to an [S, T] byte workspace that pass 2 reads. A
//   block leaves the j loop once none of its warps has an open point
//   (__syncthreads_and/_or, a barrier every thread reaches).
//
// Rounding: the subtraction is __fsub_rn, one rounding to nearest, as
// XLA's; fabsf and the comparison are exact. The count is an exact
// integer. So the flags are bit-exact with the plain PyTorch version on
// float32 inputs (theia_tpu_torch/ops/dbscan.py::dbscan_noise).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCheck = 16;       // j's between two early-exit votes
constexpr int kOneMaxThreads = 1024;
constexpr int kPassR = 2;        // points per thread, two-pass route
constexpr int kPassThreads = 128;
constexpr int kPassI = kPassThreads * kPassR;   // i-tile of a block
constexpr int kJTile = 2048;     // staged j's, two-pass route
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(double v) {
  return __double2float_rn(v);
}

__device__ __forceinline__ bool near(float xi, float xj, float eps) {
  return fabsf(__fsub_rn(xi, xj)) <= eps;
}

// Pass 1 over xs[0, n) (n a multiple of kCheck, xs 16-byte aligned):
// count[r] += within(xi[r], xs[j]) until the warp has decided every
// point. Every lane of the warp calls it with the same n.
template <int R>
__device__ __forceinline__ void count_pass(const float* xs, int n,
                                           const float (&xi)[R],
                                           const bool (&valid)[R],
                                           float eps, int min_samples,
                                           int (&count)[R]) {
  for (int j0 = 0; j0 < n; j0 += kCheck) {
    bool done = true;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      done &= !valid[r] || count[r] >= min_samples;
    }
    if (__all_sync(kFull, done)) break;
#pragma unroll
    for (int q = 0; q < kCheck; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(xs + j0 + q);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        count[r] += near(xi[r], v.x, eps);
        count[r] += near(xi[r], v.y, eps);
        count[r] += near(xi[r], v.z, eps);
        count[r] += near(xi[r], v.w, eps);
      }
    }
  }
}

// Pass 2 over xs[0, n) (core-folded): open[r] turns false once xi[r]
// is within eps of a staged j, until no lane of the warp is open.
template <int R>
__device__ __forceinline__ void reach_pass(const float* xs, int n,
                                           const float (&xi)[R],
                                           float eps, bool (&open)[R]) {
  for (int j0 = 0; j0 < n; j0 += kCheck) {
    bool any = false;
#pragma unroll
    for (int r = 0; r < R; ++r) any |= open[r];
    if (!__any_sync(kFull, any)) break;
#pragma unroll
    for (int q = 0; q < kCheck; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(xs + j0 + q);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool hit = near(xi[r], v.x, eps) | near(xi[r], v.y, eps) |
                         near(xi[r], v.z, eps) | near(xi[r], v.w, eps);
        open[r] = open[r] && !hit;
      }
    }
  }
}

// The point a thread owns: in a block of series of P threads, thread
// p holds R points. L = min(P, 32) threads of a warp share a series;
// each group of L threads holds L*R consecutive points, so a warp's
// points are close in the series (its early exit sees only them) and
// its loads and stores are coalesced (i = base + lane + L*r).
template <int R>
__device__ __forceinline__ int owned_point(int p, int P, int r) {
  const int L = min(P, 32);
  return (p / L) * (L * R) + p % L + L * r;
}

// One launch: block = B series of T points (rows s0 .. s0+B-1), P
// threads a series, R points a thread. Shared memory: [2][B][Tp]
// floats, Tp = T rounded up to kCheck (P*R >= Tp, so the owners'
// writes also fill the padding with NaN).
template <typename In, int R>
__global__ void __launch_bounds__(kOneMaxThreads)
    dbscan_one_launch_kernel(const In* __restrict__ x,
                             const uint8_t* __restrict__ mask,
                             uint8_t* __restrict__ noise, int S, int T,
                             int Tp, int P, int B, float eps,
                             int min_samples) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = threadIdx.x / P;
  const int p = threadIdx.x % P;
  const int s = blockIdx.x * B + b;
  float* xm = smem + b * Tp;            // pass 1: m_j ? x_j : NaN
  float* xc = smem + (B + b) * Tp;      // pass 2: core_j ? x_j : NaN
  const size_t row = static_cast<size_t>(s) * T;
  float xi[R];
  bool valid[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = owned_point<R>(p, P, r);
    const bool in = s < S && i < T;
    xi[r] = in ? to_float(x[row + i]) : 0.0f;
    valid[r] = in && mask[row + i] != 0;
    if (i < Tp) xm[i] = valid[r] ? xi[r] : __int_as_float(0x7fc00000);
  }
  __syncthreads();
  int count[R] = {};
  count_pass<R>(xm, Tp, xi, valid, eps, min_samples, count);
  bool open[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = owned_point<R>(p, P, r);
    const bool core = valid[r] && count[r] >= min_samples;
    open[r] = valid[r] && !core;
    if (i < Tp) xc[i] = core ? xi[r] : __int_as_float(0x7fc00000);
  }
  __syncthreads();
  reach_pass<R>(xc, Tp, xi, eps, open);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = owned_point<R>(p, P, r);
    if (s < S && i < T) noise[row + i] = open[r] ? 1 : 0;
  }
}

// Two passes, pass 1: grid (S, ceil(T / kPassI)); writes core [S, T].
template <typename In>
__global__ void __launch_bounds__(kPassThreads)
    dbscan_core_kernel(const In* __restrict__ x,
                       const uint8_t* __restrict__ mask,
                       uint8_t* __restrict__ core, int T, float eps,
                       int min_samples) {
  __shared__ float4 xs4[kJTile / 4];
  float* xs = reinterpret_cast<float*>(xs4);
  const size_t row = static_cast<size_t>(blockIdx.x) * T;
  float xi[kPassR];
  bool valid[kPassR];
#pragma unroll
  for (int r = 0; r < kPassR; ++r) {
    const int i = blockIdx.y * kPassI +
                  owned_point<kPassR>(threadIdx.x, kPassThreads, r);
    xi[r] = i < T ? to_float(x[row + i]) : 0.0f;
    valid[r] = i < T && mask[row + i] != 0;
  }
  int count[kPassR] = {};
  for (int j0 = 0; j0 < T; j0 += kJTile) {
    for (int k = threadIdx.x; k < kJTile; k += kPassThreads) {
      const int j = j0 + k;
      xs[k] = (j < T && mask[row + j] != 0) ? to_float(x[row + j])
                                            : __int_as_float(0x7fc00000);
    }
    __syncthreads();
    const int n = min(kJTile, (T - j0 + kCheck - 1) / kCheck * kCheck);
    count_pass<kPassR>(xs, n, xi, valid, eps, min_samples, count);
    bool done = true;
#pragma unroll
    for (int r = 0; r < kPassR; ++r) {
      done &= !valid[r] || count[r] >= min_samples;
    }
    if (__syncthreads_and(done)) break;   // also guards the next staging
  }
#pragma unroll
  for (int r = 0; r < kPassR; ++r) {
    const int i = blockIdx.y * kPassI +
                  owned_point<kPassR>(threadIdx.x, kPassThreads, r);
    if (i < T) {
      core[row + i] = (valid[r] && count[r] >= min_samples) ? 1 : 0;
    }
  }
}

// Two passes, pass 2: stages core_j ? x_j : NaN; writes noise [S, T].
template <typename In>
__global__ void __launch_bounds__(kPassThreads)
    dbscan_reach_kernel(const In* __restrict__ x,
                        const uint8_t* __restrict__ mask,
                        const uint8_t* __restrict__ core,
                        uint8_t* __restrict__ noise, int T, float eps) {
  __shared__ float4 xs4[kJTile / 4];
  float* xs = reinterpret_cast<float*>(xs4);
  const size_t row = static_cast<size_t>(blockIdx.x) * T;
  float xi[kPassR];
  bool open[kPassR];
#pragma unroll
  for (int r = 0; r < kPassR; ++r) {
    const int i = blockIdx.y * kPassI +
                  owned_point<kPassR>(threadIdx.x, kPassThreads, r);
    xi[r] = i < T ? to_float(x[row + i]) : 0.0f;
    open[r] = i < T && mask[row + i] != 0 && core[row + i] == 0;
  }
  bool any = false;
#pragma unroll
  for (int r = 0; r < kPassR; ++r) any |= open[r];
  // core_j implies m_j: the core byte alone selects the staged j's
  for (int j0 = 0; __syncthreads_or(any) && j0 < T; j0 += kJTile) {
    for (int k = threadIdx.x; k < kJTile; k += kPassThreads) {
      const int j = j0 + k;
      xs[k] = (j < T && core[row + j] != 0) ? to_float(x[row + j])
                                            : __int_as_float(0x7fc00000);
    }
    __syncthreads();
    const int n = min(kJTile, (T - j0 + kCheck - 1) / kCheck * kCheck);
    reach_pass<kPassR>(xs, n, xi, eps, open);
    any = false;
#pragma unroll
    for (int r = 0; r < kPassR; ++r) any |= open[r];
  }
#pragma unroll
  for (int r = 0; r < kPassR; ++r) {
    const int i = blockIdx.y * kPassI +
                  owned_point<kPassR>(threadIdx.x, kPassThreads, r);
    if (i < T) noise[row + i] = open[r] ? 1 : 0;
  }
}

template <typename In, int R>
int one_launch(const void* x, const uint8_t* mask, uint8_t* noise, int S,
               int T, int P, int B, float eps, int min_samples,
               cudaStream_t stream) {
  const int Tp = (T + kCheck - 1) / kCheck * kCheck;
  const int threads = P * B;
  const bool lanes_ok = P % 32 == 0 || (32 % P == 0 && threads % 32 == 0);
  if (P < 1 || B < 1 || threads > kOneMaxThreads || !lanes_ok ||
      P * R < Tp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (S + B - 1) / B;
  const size_t smem = 2 * static_cast<size_t>(B) * Tp * sizeof(float);
  dbscan_one_launch_kernel<In, R><<<blocks, threads, smem, stream>>>(
      static_cast<const In*>(x), mask, noise, S, T, Tp, P, B, eps,
      min_samples);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int one_launch_r(const void* x, const uint8_t* mask, uint8_t* noise, int S,
                 int T, int P, int B, int R, float eps, int min_samples,
                 cudaStream_t stream) {
  switch (R) {
    case 2: return one_launch<In, 2>(x, mask, noise, S, T, P, B, eps,
                                     min_samples, stream);
    case 4: return one_launch<In, 4>(x, mask, noise, S, T, P, B, eps,
                                     min_samples, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename In>
int two_pass(const void* x, const uint8_t* mask, uint8_t* core,
             uint8_t* noise, int S, int T, float eps, int min_samples,
             cudaStream_t stream) {
  const dim3 grid(S, (T + kPassI - 1) / kPassI);
  dbscan_core_kernel<In><<<grid, kPassThreads, 0, stream>>>(
      static_cast<const In*>(x), mask, core, T, eps, min_samples);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dbscan_reach_kernel<In><<<grid, kPassThreads, 0, stream>>>(
      static_cast<const In*>(x), mask, core, noise, T, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The constants the Python wrapper plans with; it checks them when it
// loads the library.
extern "C" int dbscan_check() { return kCheck; }
extern "C" int dbscan_pass_i_tile() { return kPassI; }

// Plain C entry points (loaded with ctypes). x is float32
// (x_is_double == 0) or float64, mask and noise one byte per point,
// [S, T] contiguous. Each launches on `stream`, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a plan it refuses). The caller checks that
// S, T > 0, that S*T fits in int32 and that the grid fits.
//
// One launch; P threads a series, B series a block, R (2 or 4) points
// a thread (the caller's plan).
extern "C" int dbscan_noise_one_launch(const void* x, int x_is_double,
                                       const uint8_t* mask, uint8_t* noise,
                                       int S, int T, int P, int B, int R,
                                       float eps, int min_samples,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_double
             ? one_launch_r<double>(x, mask, noise, S, T, P, B, R, eps,
                                    min_samples, s)
             : one_launch_r<float>(x, mask, noise, S, T, P, B, R, eps,
                                   min_samples, s);
}

// Two passes; `core` is the caller's [S, T] byte workspace.
extern "C" int dbscan_noise_two_pass(const void* x, int x_is_double,
                                     const uint8_t* mask, uint8_t* core,
                                     uint8_t* noise, int S, int T,
                                     float eps, int min_samples,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_double
             ? two_pass<double>(x, mask, core, noise, S, T, eps,
                                min_samples, s)
             : two_pass<float>(x, mask, core, noise, S, T, eps,
                               min_samples, s);
}
