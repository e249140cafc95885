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
// Design: two passes, each a launch over the grid (series, i-tile)
// with one thread per point i of a kTile-point tile. A block walks its
// series in j-tiles: it stages x, mask (and, in pass 2, core) of the
// j-tile in shared memory, and every thread tests its point against
// the kTile staged points, which all threads read at the same address
// (a broadcast, no bank conflicts). Pass 1 counts neighbours in an
// int32 and writes core as a byte into an [S, T] workspace; pass 2 ORs
// core_j & within_ij and writes noise. Shared memory holds one j-tile,
// whatever T is: a day of points at one a second is a long loop, not a
// larger block.
//
// What bounds it on an H100: operations. Each pass tests S*T*T pairs
// at about five 32-bit operations each; the bytes are ~6 per point.
//
// Rounding: the subtraction is __fsub_rn, one rounding to nearest, as
// XLA's; fabsf and the comparison are exact. The count is an exact
// integer (the TPU's float32 sum is exact for T < 2^24). So the flags
// are bit-exact with the plain PyTorch version on float32 inputs
// (theia_tpu_torch/ops/dbscan.py::dbscan_noise).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;

__global__ void dbscan_core_kernel(const float* __restrict__ x,
                                   const uint8_t* __restrict__ mask,
                                   uint8_t* __restrict__ core, int T,
                                   float eps, int min_samples) {
  __shared__ float xs[kTile];
  __shared__ uint8_t ms[kTile];
  const size_t row = static_cast<size_t>(blockIdx.x) * T;
  const int i = blockIdx.y * kTile + threadIdx.x;
  const bool in = i < T;
  const float xi = in ? x[row + i] : 0.0f;
  const bool mi = in && mask[row + i] != 0;
  int count = 0;
  for (int j0 = 0; j0 < T; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    xs[threadIdx.x] = j < T ? x[row + j] : 0.0f;
    ms[threadIdx.x] = j < T ? mask[row + j] : 0;
    __syncthreads();
    const int n = min(kTile, T - j0);
    for (int jj = 0; jj < n; ++jj) {
      count += (ms[jj] != 0 && fabsf(__fsub_rn(xi, xs[jj])) <= eps) ? 1 : 0;
    }
    __syncthreads();
  }
  if (in) core[row + i] = (mi && count >= min_samples) ? 1 : 0;
}

__global__ void dbscan_reach_kernel(const float* __restrict__ x,
                                    const uint8_t* __restrict__ mask,
                                    const uint8_t* __restrict__ core,
                                    uint8_t* __restrict__ noise, int T,
                                    float eps) {
  __shared__ float xs[kTile];
  __shared__ uint8_t cs[kTile];
  const size_t row = static_cast<size_t>(blockIdx.x) * T;
  const int i = blockIdx.y * kTile + threadIdx.x;
  const bool in = i < T;
  const float xi = in ? x[row + i] : 0.0f;
  const bool mi = in && mask[row + i] != 0;
  bool reach = false;
  for (int j0 = 0; j0 < T; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    xs[threadIdx.x] = j < T ? x[row + j] : 0.0f;
    // core_j implies m_j: the core byte alone selects valid j
    cs[threadIdx.x] = j < T ? core[row + j] : 0;
    __syncthreads();
    const int n = min(kTile, T - j0);
    for (int jj = 0; jj < n; ++jj) {
      reach |= cs[jj] != 0 && fabsf(__fsub_rn(xi, xs[jj])) <= eps;
    }
    __syncthreads();
  }
  if (in) noise[row + i] = (mi && core[row + i] == 0 && !reach) ? 1 : 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches both passes on
// `stream`, does not synchronise, allocates nothing (`core` is the
// caller's [S, T] byte workspace); returns cudaGetLastError() so the
// caller can raise on a refused launch. The caller checks that S*T
// fits in int32 and that S, T > 0.
extern "C" int dbscan_noise_launch(const float* x, const uint8_t* mask,
                                   uint8_t* core, uint8_t* noise, int S,
                                   int T, float eps, int min_samples,
                                   void* stream) {
  if (S > 0 && T > 0) {
    const dim3 grid(S, (T + kTile - 1) / kTile);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    dbscan_core_kernel<<<grid, kTile, 0, s>>>(x, mask, core, T, eps,
                                              min_samples);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dbscan_reach_kernel<<<grid, kTile, 0, s>>>(x, mask, core, noise, T,
                                               eps);
  }
  return static_cast<int>(cudaGetLastError());
}
