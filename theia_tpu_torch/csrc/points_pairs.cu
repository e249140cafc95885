// points_pairs: the two pairwise passes of the spatial DBSCAN over [N, F]
// point embeddings, F <= 7 (ops/dbscan.py::points_neighbour_counts and
// points_reachable, the SAD job's device work).
//
// Replaces no Pallas kernel: the reference leaves this function to XLA
// (theia_tpu/ops/dbscan.py:126, a lax.scan over row blocks with a
// matmul at :139), and the port's plain version is the same [block, N]
// tiles in torch ops. Those tiles write and read three [block, N]
// temporaries a tile (the product, the sum, the mask) and spend ~9 of
// every 10 device seconds in elementwise and reduction kernels. This
// kernel keeps every pair's d² in registers and writes one result a row.
//
//   count mode: count_i = |{j : d²(t_i, x_j) <= eps² and valid_j}|  (int64)
//   reach mode: reach_i = exists j: core_j and d²(t_i, x_j) <= eps²  (byte)
//
// What bounds it on an H100: float32 instruction issue. Count mode
// evaluates every ordered pair (the benchmark's roofline counts n² pairs,
// so no pair may be skipped: no i < j half, no grid, no exit at
// min_samples); reach mode evaluates the rows it is given, which the
// wrapper compacts to the non-core points. The bytes are the packed
// points, 32 B each: the columns, 8 MB at N = 262,144, stay in the 50 MB
// L2 for the blocks that read them again.
//
// Packed points (built by the wrapper, one float4 pair each):
//   a row    (t_0 .. t_{F-1}, 0 .., lim)  lim = fl((eps² - |t|²) / 2)
//   a column (-x_0 .. -x_{F-1}, 0 .., h)  h   = fl(|x|² / 2)
// with |.|² summed in float64 and rounded once. h is NaN for an excluded
// column (invalid in count mode, not core in reach mode) and for a
// column whose norm is not finite; lim is NaN for such a row. A pair is
//   acc = fma(t_6, -x_6, ... fma(t_0, -x_0, h))   (7 FFMAs)
//   within = acc <= lim
// i.e. |x|²/2 - t·x <= (eps² - |t|²)/2, d² <= eps², so a pair costs 7
// FFMAs, a compare and a predicated add: 9 instructions, against the 17
// float32 operations a pair the roofline counts at F = 7 (so it can reach
// at most 17/18 of that peak). A narrower point is zero past F on both
// sides, and those FFMAs add an exact 0, so one kernel serves every
// F <= 7 with the F-term chain's result. A NaN anywhere compares false,
// as torch's does. No tensor cores, no TF32, no fast math.
//
// Rounding. With u = 2^-24 and S = |t|² + |x|², the chain's partial sums
// are at most |x|²/2 + |t||x| each, so (first order, in units of d²)
//   |computed - exact| <= u (8|x|² + |t|² + 14|t||x| + eps²)
//                      <= u (12.33 S + eps²).
// A pair whose d² lies further than 2^-20 S (16 u S) from eps² is decided
// as exact arithmetic decides it: for eps² <= 3.6 S the error is under
// 15.93 u S; for eps² > 3.6 S, d² <= 2S lies at least 0.44 eps² below
// eps², and the error is under 5 u eps². That is the band outside which
// chip_smoke.points_recount and the SAD reference hold the flags exact.
// A pair's arithmetic reads only its row's and its column's packed
// values, in a fixed order, so a shard's pass (a block of the rows) and
// the one-device pass give bit-equal results; the count is an integer
// sum, the same in any order.
//
// Design:
// - Register tiling: each of a block's 256 threads holds R rows (8 in
//   count mode, 2 in reach mode) in registers; every column read from
//   shared memory (two float4 broadcasts, all lanes the same address)
//   serves R pairs, so the loads are 2 instructions in 9R + 2 (the
//   unrolled loop, two columns, is 153 instructions for 16 pairs).
// - Column tiles of 256 points (8 KB) stream through shared memory,
//   double-buffered with cp.async: the next tile's copy is in flight
//   while the current one is evaluated.
// - Persistent blocks: the (row block, column tile) units are cut into
//   one contiguous run for each block the card holds at once (SMs x
//   occupancy), so every block does the same work to within one tile. A
//   run crosses row blocks where it must; each segment adds its counts
//   with one 64-bit atomicAdd a row (integer: exact in any order).
// - Reach mode: a warp whose rows have all found a core neighbour skips
//   the tile (a warp vote), and the block leaves a segment once all its
//   rows have (a block vote). Rows past the last are found from the
//   start.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWidth = 8;                    // floats a packed point
constexpr int kMaxF = 7;
constexpr int kThreads = 256;
constexpr int kCountR = 8;                   // rows a thread, count mode
constexpr int kReachR = 2;                   // rows a thread, reach mode
constexpr int kTile = 256;                   // columns a stage
constexpr int kChunks = kTile * kWidth / 4;  // float4s a stage

__device__ __forceinline__ void cp_async16(float4* smem, const float4* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void stage_tile(float4* dst, const float4* cols,
                                           int tile) {
  const float4* src = cols + static_cast<size_t>(tile) * kChunks;
#pragma unroll
  for (int k = 0; k < kChunks / kThreads; ++k) {
    const int c = k * kThreads + threadIdx.x;
    cp_async16(dst + c, src + c);
  }
  cp_async_commit();
}

// One staged tile against a thread's R rows.
template <int R>
__device__ __forceinline__ void pairs_tile(const float4* s,
                                           const float (&t)[R][kMaxF],
                                           const float (&lim)[R],
                                           int (&cnt)[R]) {
#pragma unroll 2
  for (int j = 0; j < kTile; ++j) {
    const float4 lo = s[2 * j];
    const float4 hi = s[2 * j + 1];
    const float x[kWidth] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc = __fmaf_rn(t[r][0], x[0], x[kWidth - 1]);
#pragma unroll
      for (int k = 1; k < kMaxF; ++k) acc = __fmaf_rn(t[r][k], x[k], acc);
      // a compare and a predicated add (FSETP, IADD3): written in PTX,
      // as nvcc otherwise adds 1 and selects, three instructions
      asm("{\n\t.reg .pred p;\n\tsetp.le.f32 p, %1, %2;\n\t"
          "@p add.s32 %0, %0, 1;\n\t}"
          : "+r"(cnt[r])
          : "f"(acc), "f"(lim[r]));
    }
  }
}

// rows: [row_blocks * R * kThreads, 8]; cols: [n_tiles * kTile, 8], both
// as float4 pairs. Writes counts[i] (count mode, zeroed by the caller)
// or reached[i] (reach mode, zeroed) for i < m.
template <int R, bool kReach>
__global__ void __launch_bounds__(kThreads, R >= kCountR ? 2 : 4)
    points_pairs_kernel(const float4* __restrict__ rows, int m,
                        int row_blocks, const float4* __restrict__ cols,
                        int n_tiles, unsigned long long* __restrict__ counts,
                        uint8_t* __restrict__ reached) {
  __shared__ float4 stage[2][kChunks];
  const long long units = static_cast<long long>(row_blocks) * n_tiles;
  const long long per = units / gridDim.x;
  const long long extra = units % gridDim.x;
  long long u = blockIdx.x * per + min(static_cast<long long>(blockIdx.x),
                                       extra);
  const long long u_end = u + per + (blockIdx.x < extra ? 1 : 0);
  while (u < u_end) {
    const int rb = static_cast<int>(u / n_tiles);
    const int t0 = static_cast<int>(u % n_tiles);
    const int t1 = static_cast<int>(
        min(static_cast<long long>(n_tiles), t0 + (u_end - u)));
    u += t1 - t0;

    float t[R][kMaxF];
    float lim[R];
    int cnt[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long i =
          (static_cast<long long>(rb) * R + r) * kThreads + threadIdx.x;
      const float4 lo = rows[2 * i];
      const float4 hi = rows[2 * i + 1];
      const float v[kWidth] = {lo.x, lo.y, lo.z, lo.w,
                               hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int k = 0; k < kMaxF; ++k) t[r][k] = v[k];
      lim[r] = hi.w;
      cnt[r] = (kReach && i >= m) ? 1 : 0;
    }

    stage_tile(stage[0], cols, t0);
    for (int tile = t0; tile < t1; ++tile) {
      const int buf = (tile - t0) & 1;
      if (tile + 1 < t1) {
        stage_tile(stage[buf ^ 1], cols, tile + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (kReach) {
        bool done = true;
#pragma unroll
        for (int r = 0; r < R; ++r) done &= cnt[r] != 0;
        if (!__all_sync(0xffffffffu, done)) {
          pairs_tile<R>(stage[buf], t, lim, cnt);
        }
        done = true;
#pragma unroll
        for (int r = 0; r < R; ++r) done &= cnt[r] != 0;
        if (__syncthreads_and(done)) break;  // also guards the next stage
      } else {
        pairs_tile<R>(stage[buf], t, lim, cnt);
        __syncthreads();
      }
    }
    // a reach segment left early may still have a copy in flight
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long i =
          (static_cast<long long>(rb) * R + r) * kThreads + threadIdx.x;
      if (i < m && cnt[r] != 0) {
        if (kReach) {
          reached[i] = 1;
        } else {
          atomicAdd(counts + i, static_cast<unsigned long long>(cnt[r]));
        }
      }
    }
  }
}

template <bool kReach>
int launch(const float* rows, int rows_padded, int m, const float* cols,
           int cols_padded, void* out, cudaStream_t stream) {
  constexpr int R = kReach ? kReachR : kCountR;
  const int row_blocks = rows_padded / (R * kThreads);
  const int n_tiles = cols_padded / kTile;
  const long long units = static_cast<long long>(row_blocks) * n_tiles;
  if (m == 0 || units == 0) return 0;
  auto kernel = points_pairs_kernel<R, kReach>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(units < slots ? units : slots);
  kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(rows), m, row_blocks,
      reinterpret_cast<const float4*>(cols), n_tiles,
      static_cast<unsigned long long*>(out), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The constants the Python wrapper packs with; it checks them when it
// loads the library.
extern "C" int points_width() { return kWidth; }
extern "C" int points_max_f() { return kMaxF; }
extern "C" int points_tile() { return kTile; }
extern "C" int points_block_rows(int reach) {
  return (reach ? kReachR : kCountR) * kThreads;
}

// Plain C entry point (loaded with ctypes). rows: [rows_padded, 8]
// packed rows, rows_padded a multiple of points_block_rows(reach), of
// which the first m are real; cols: [cols_padded, 8] packed columns,
// cols_padded a multiple of points_tile().
// out: int64 [m] counts (reach == 0) or one byte a row (reach != 0),
// zeroed here. Launches on `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (or cudaErrorInvalidValue for
// arguments it refuses). The caller checks that the padded sizes fit in
// int32.
extern "C" int points_pairs(const float* rows, int rows_padded, int m,
                            const float* cols, int cols_padded, int reach,
                            void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int block_rows = points_block_rows(reach);
  if (m < 0 || m > rows_padded || rows_padded < 0 ||
      cols_padded < 0 || rows_padded % block_rows != 0 ||
      cols_padded % kTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t out_bytes =
      static_cast<size_t>(m) * (reach ? sizeof(uint8_t) : sizeof(int64_t));
  if (out_bytes > 0) {
    const cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return reach ? launch<true>(rows, rows_padded, m, cols, cols_padded, out, s)
               : launch<false>(rows, rows_padded, m, cols, cols_padded, out,
                               s);
}
