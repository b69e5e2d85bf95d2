// The int8 chunk codec of the compressed bucket syncs: per chunk of `chunk`
// float32 values, a symmetric scale and int8 codes, packed as one uint8 row
// [int8 payload | float32 scales]; and its inverse, which dequantizes k packed
// rows and either adds them or lays them side by side.
//
// Replaces `_quantize_chunks` and `_dequantize_chunks` of the JAX package
// (torchmetrics_tpu/parallel/compress.py:222-239), called per destination
// block by `psum_int8` and `psum_scatter_int8` (:264, :266-271, :310-314), and
// `host_quantize_int8` / `host_dequantize_int8` (:405-439) with the host sum
// of `coalesced_host_sync` (torchmetrics_tpu/parallel/coalesce.py:663-670).
// For each chunk c of row r:
//
//   amax  = max |x|            (NaN if any x is NaN)
//   scale = amax > 0 ? amax * float(1/127) : 1    (the host path: amax / 127)
//   q     = rint(x / scale) clipped to [-127, 127]; a NaN quotient is 0
//
// The scale is what JAX computes: inside a jitted sync XLA turns the division
// by the constant 127 into a multiply by its float32 reciprocal, and the host
// path (numpy) divides. rintf rounds half to even, as jnp.round does; the
// quotient x / scale is an IEEE division, never a reciprocal multiply, in
// both. Subnormals are kept (XLA on the CPU flushes them to zero: a kept
// divergence only a chunk of subnormals shows). int8_codec_dequant_sum reads k packed
// rows: in sum mode it adds their values q * scale in JAX's order, and when
// asked requantizes the chunk's sums in the same launch (the int8 all-reduce's
// phase 2); in concat mode it writes each row's values to their slot. JAX's
// order is what XLA compiles on the CPU from the jitted stack(...).sum(0):
// fma(q0, s0, q1 * s1), then fma(qj, sj, acc) for j = 2 .. k-1 (LLVM
// contracts each add with its product; one row is its product); the host
// path's (numpy's sum of the dequantized rows) adds the rounded products into
// 0.0f, one after the other.
//
// Layout. A warp a chunk, 8 warps a block; a lane takes the chunk's elements
// lane, lane + 32, ... The warp's maximum is a butterfly of fmaxf beside an
// __any_sync vote of the NaN flag (fmaxf drops a NaN). Both passes over a
// chunk read it from memory; the second finds it in L1 or L2. The packed rows
// are written and read byte by byte: a row of an odd chunk is not 4-byte
// aligned.
//
// Device work of one call, on the caller's stream: one kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLevels = 127.0f;
constexpr float kRcpLevels = 1.0f / 127.0f;  // float32(1/127), rounded to nearest

// the warp's chunk scale from each lane's max |x| and NaN flag
__device__ __forceinline__ float chunk_scale(float m, bool nan, bool host_scale) {
  for (int offset = 16; offset > 0; offset >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, offset));
  nan = __any_sync(0xffffffffu, nan);
  if (nan || !(m > 0.0f)) return 1.0f;
  return host_scale ? __fdiv_rn(m, kLevels) : __fmul_rn(m, kRcpLevels);
}

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  if (r != r) return 0;
  return static_cast<int8_t>(fminf(fmaxf(r, -kLevels), kLevels));
}

__device__ __forceinline__ void store_scale(uint8_t* p, float scale) {
  const uint32_t bits = __float_as_uint(scale);
  p[0] = bits & 0xffu;
  p[1] = (bits >> 8) & 0xffu;
  p[2] = (bits >> 16) & 0xffu;
  p[3] = bits >> 24;
}

__device__ __forceinline__ float load_scale(const uint8_t* p) {
  return __uint_as_float(uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24));
}

// x: (rows, n_chunks * chunk) float32; out: (rows, n_chunks * (chunk + 4)) uint8
__global__ void __launch_bounds__(kThreads) quantize_kernel(const float* __restrict__ x, uint8_t* __restrict__ out,
                                                            long long rows, long long n_chunks, int chunk,
                                                            int host_scale) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= rows * n_chunks) return;  // warp-uniform: a whole warp leaves
  const int lane = threadIdx.x & 31;
  const long long r = w / n_chunks, c = w - r * n_chunks;
  const long long width = n_chunks * chunk;
  const float* src = x + r * width + c * chunk;
  uint8_t* row = out + r * n_chunks * (chunk + 4);
  float m = 0.0f;
  bool nan = false;
  for (int i = lane; i < chunk; i += 32) {
    const float v = src[i];
    nan |= v != v;
    m = fmaxf(m, fabsf(v));
  }
  const float scale = chunk_scale(m, nan, host_scale != 0);
  int8_t* q = reinterpret_cast<int8_t*>(row + c * chunk);
  for (int i = lane; i < chunk; i += 32) q[i] = quantize(src[i], scale);
  if (lane == 0) store_scale(row + width + 4 * c, scale);
}

// the value of element i of chunk c of a packed row
__device__ __forceinline__ float dequantized(const uint8_t* row, long long width, long long c, int chunk, int i) {
  const int8_t q = reinterpret_cast<const int8_t*>(row)[c * chunk + i];
  return __fmul_rn(static_cast<float>(q), load_scale(row + width + 4 * c));
}

// code and scale of element i of chunk c of a packed row
__device__ __forceinline__ float code(const uint8_t* row, long long c, int chunk, int i) {
  return static_cast<float>(reinterpret_cast<const int8_t*>(row)[c * chunk + i]);
}

// the sum over the k rows of element i of chunk c, in JAX's order (see above)
__device__ __forceinline__ float row_sum(const uint8_t* packed, long long stride, long long width, int k, long long c,
                                         int chunk, int i, bool host) {
  if (host) {
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, dequantized(packed + j * stride, width, c, chunk, i));
    return acc;
  }
  float acc = dequantized(packed + (k > 1 ? stride : 0), width, c, chunk, i);
  if (k == 1) return acc;
  acc = __fmaf_rn(code(packed, c, chunk, i), load_scale(packed + width + 4 * c), acc);
  for (int j = 2; j < k; ++j) {
    const uint8_t* row = packed + j * stride;
    acc = __fmaf_rn(code(row, c, chunk, i), load_scale(row + width + 4 * c), acc);
  }
  return acc;
}

// packed: (k, n_chunks * (chunk + 4)) uint8. Sum mode: out (n_chunks * chunk,) float32, or with requantize
// (n_chunks * (chunk + 4),) uint8. Concat mode: out (k * n_chunks * chunk,) float32.
__global__ void __launch_bounds__(kThreads) dequant_sum_kernel(const uint8_t* __restrict__ packed,
                                                               void* __restrict__ out, int k, long long n_chunks,
                                                               int chunk, int concat, int requantize, int host) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long rows = concat ? k : 1;
  if (w >= rows * n_chunks) return;  // warp-uniform: a whole warp leaves
  const int lane = threadIdx.x & 31;
  const long long width = n_chunks * chunk;
  const long long stride = n_chunks * (chunk + 4);
  if (concat) {
    const long long j = w / n_chunks, c = w - j * n_chunks;
    float* dst = static_cast<float*>(out) + j * width + c * chunk;
    for (int i = lane; i < chunk; i += 32) dst[i] = dequantized(packed + j * stride, width, c, chunk, i);
    return;
  }
  const long long c = w;
  if (!requantize) {
    float* dst = static_cast<float*>(out) + c * chunk;
    for (int i = lane; i < chunk; i += 32) dst[i] = row_sum(packed, stride, width, k, c, chunk, i, host != 0);
    return;
  }
  float m = 0.0f;
  bool nan = false;
  for (int i = lane; i < chunk; i += 32) {
    const float acc = row_sum(packed, stride, width, k, c, chunk, i, host != 0);
    nan |= acc != acc;
    m = fmaxf(m, fabsf(acc));
  }
  const float scale = chunk_scale(m, nan, false);  // the in-graph requantize of psum_int8
  uint8_t* row = static_cast<uint8_t*>(out);
  int8_t* q = reinterpret_cast<int8_t*>(row + c * chunk);
  for (int i = lane; i < chunk; i += 32) {  // the same sums again, in the same order
    q[i] = quantize(row_sum(packed, stride, width, k, c, chunk, i, host != 0), scale);
  }
  if (lane == 0) store_scale(row + width + 4 * c, scale);
}

unsigned int blocks_for(long long warps) { return static_cast<unsigned int>((warps + kWarps - 1) / kWarps); }

}  // namespace

extern "C" int int8_codec_quantize(const void* x, void* out, long long rows, long long n_chunks, int chunk,
                                   int host_scale, void* stream_ptr) {
  if (rows < 1 || n_chunks < 1 || chunk < 8 || (rows * n_chunks + kWarps - 1) / kWarps > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  quantize_kernel<<<blocks_for(rows * n_chunks), kThreads, 0, stream>>>(static_cast<const float*>(x),
                                                                          static_cast<uint8_t*>(out), rows, n_chunks,
                                                                          chunk, host_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int int8_codec_dequant_sum(const void* packed, void* out, int k, long long n_chunks, int chunk, int concat,
                                      int requantize, int host, void* stream_ptr) {
  const long long rows = concat ? k : 1;
  if (k < 1 || n_chunks < 1 || chunk < 8 || (concat && requantize) ||
      (rows * n_chunks + kWarps - 1) / kWarps > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  dequant_sum_kernel<<<blocks_for(rows * n_chunks), kThreads, 0, stream>>>(static_cast<const uint8_t*>(packed), out,
                                                                             k, n_chunks, chunk, concat, requantize,
                                                                             host);
  return static_cast<int>(cudaGetLastError());
}
