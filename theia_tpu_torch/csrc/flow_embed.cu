// flow_embed: the spatial anomaly job's [n, 7] float32 flow embedding from
// the four store columns it reads (ops/embed.py::flow_embedding, the SAD
// job's embed stage).
//
// Replaces no Pallas kernel: the reference embeds on the host in numpy
// (theia_tpu/analytics/spatial.py::flow_embeddings), and the port kept that
// code verbatim. On the host it is six uint32 hash passes over int64-widened
// codes, a float64 log1p and a [n, 7] stack, tens of milliseconds a job at
// 262,144 flows, and then a 7.3 MB copy of the result to the card. Here the
// card reads the columns in their stored dtypes (20 B a flow) and writes the
// embedding (28 B a flow) in one pass.
//
//   out[i] = (H(src_i, s0), H(src_i, s1), H(dst_i, s0), H(dst_i, s1),
//             H(port_i, s0), H(port_i, s1), log1p(octets_i))
//   H(c, s) = fl32(fl64(h(uint32(c) ^ s) / 2^32) * 100)
//   s0 = 0x1234ABCD, s1 = 0x9E3779B9
//
// with h the numpy code's shift-xor / multiply finalizer in uint32. Every
// step is the numpy code's: an int32 code read as uint32 by its bit pattern
// is what numpy's int64 -> uint32 cast gives; the hash is exact uint32
// arithmetic; the division by 2^32 is exact; the product by 100, the int64 ->
// float64 conversion and both float64 -> float32 roundings are correctly
// rounded (round to nearest even), written as intrinsics so that nothing is
// contracted. The one step that is not correctly rounded on either side is
// float64 log1p: CUDA's is within 1 ulp, as the host's libm is, so the two may
// differ in the last bit of the float64 value, and the float32 result only
// where that bit straddles a float32 rounding boundary (about 2^-29 of the
// values that differ at all). The card tests hold the kernel bit-equal to the
// plain version on every octet count up to 2^24 and on a seeded sample up to
// 2^63 - 1.
//
// What bounds it on an H100: bytes, 48 a flow (20 read, 28 written), 12.6 MB
// at 262,144 flows, about 3.8 us at 3.35 TB/s; the arithmetic is a few dozen
// integer operations and one float64 log1p a flow. Design: one thread a flow,
// ceil(n / 256) blocks; the column loads are coalesced (neighbouring threads,
// neighbouring flows) and a warp's 32 rows of 28 bytes are one contiguous
// 896-byte run. Nothing to tune: at this size the launch costs more than the
// pass.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDim = 7;          // 2 src + 2 dst + 2 port + volume
constexpr int kScale = 100;      // the categorical axes' range [0, 100)
constexpr uint32_t kSeed0 = 0x1234ABCDu;  // each identity's two hash axes
constexpr uint32_t kSeed1 = 0x9E3779B9u;
constexpr int kThreads = 256;

__device__ __forceinline__ float hash_axis(int32_t code, uint32_t seed) {
  uint32_t h = static_cast<uint32_t>(code) ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  const double unit = __ddiv_rn(static_cast<double>(h), 4294967296.0);
  return __double2float_rn(__dmul_rn(unit, static_cast<double>(kScale)));
}

__global__ void __launch_bounds__(kThreads)
flow_embed_kernel(const int32_t* __restrict__ src,
                  const int32_t* __restrict__ dst,
                  const int32_t* __restrict__ port,
                  const long long* __restrict__ octets, long long n,
                  float* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t codes[3] = {src[i], dst[i], port[i]};
  float* row = out + i * kDim;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    row[2 * c] = hash_axis(codes[c], kSeed0);
    row[2 * c + 1] = hash_axis(codes[c], kSeed1);
  }
  row[kDim - 1] = __double2float_rn(log1p(__ll2double_rn(octets[i])));
}

}  // namespace

// The constants the Python wrapper assumes; it checks them when it loads
// the library. A seed is returned as the int of its bit pattern.
extern "C" int flow_embed_dim() { return kDim; }
extern "C" int flow_embed_scale() { return kScale; }
extern "C" int flow_embed_seed(int i) {
  return static_cast<int>(i == 0 ? kSeed0 : kSeed1);
}

// Plain C entry point (loaded with ctypes). src, dst, port: int32 [n];
// octets: int64 [n]; out: float32 [n, 7], row-major; all contiguous on the
// current device. Launches on `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (or cudaErrorInvalidValue for an n
// below 0 or beyond what one grid of kThreads-thread blocks covers).
extern "C" int flow_embed(const int32_t* src, const int32_t* dst,
                          const int32_t* port, const long long* octets,
                          long long n, float* out, void* stream) {
  constexpr long long kMaxBlocks = 0x7FFFFFFF;  // gridDim.x's limit
  if (n < 0 || n > kMaxBlocks * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  flow_embed_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(src, dst, port,
                                                           octets, n, out);
  return static_cast<int>(cudaGetLastError());
}
