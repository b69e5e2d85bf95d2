// DistinctNGrams' HyperLogLog insert: the n-gram windows of a batch of token
// ids hashed and folded into the HyperLogLog registers, in place, and the count
// of valid windows added into the float32 total.
//
// Replaces `DistinctNGrams._windows`, `_keys` and `HyperLogLog.insert_batch`
// of the JAX package (torchmetrics_tpu/text/distinct.py:83-113,
// torchmetrics_tpu/sketches/cardinality.py:94-109): a (rows, n) stack of the
// windows, a chain of murmur3 finalizers a window, the register index and rank
// of the hashed key, and a scatter-max. Here, for every window s of every row b
// of the (B, T) int32 tokens (s < T - n + 1):
//
//   h = 0; for k < n: h = mix32(uint32(tok[b, s + k]) + h, 0x9E3779B9 (k + 1))
//   x = mix32(h, seed)
//   idx = x >> (32 - p); rest = x << p; rank = rest ? clz(rest) + 1 : 33 - p
//   registers[idx] = max(registers[idx], rank)     unless a token == ignore_index
//   total_out = total_in + (windows without ignore_index)
//
// all in uint32 arithmetic, so the registers are JAX's bit for bit; integer
// maxima do not depend on the order of the atomics.
//
// Layout. A thread a window, grid-strided. Up to p = 14 (64 KB) a block keeps
// its own copy of the 2^p registers in shared memory and flushes the non-zero
// ones into the state with one atomicMax each; above it, the atomics go to the
// state. Each block adds its count of valid windows into a 64-bit accumulator;
// the last block (a ticket) writes the new total and sets the accumulator and
// the ticket back to zero for the next launch on the stream (the launcher
// zeroes them once).
//
// Device work of one call, on the caller's stream: one kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedPrecision = 14;  // 2^14 int32 registers = 64 KB of shared memory

struct Args {
  const int* tokens;  // (B, T) row-major
  long long n_windows;
  int length;
  int span;
  int ngram;
  int has_ignore;
  long long ignore;
  int precision;
  uint32_t seed;
  int* registers;  // (2^p,), maxed into in place
  const float* total_in;
  float* total_out;
  unsigned long long* acc;
  unsigned int* ticket;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t salt) {
  x ^= salt;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

template <bool Shared>
__global__ void __launch_bounds__(kThreads) hll_insert_kernel(Args a) {
  extern __shared__ int regs[];  // (2^p,) when Shared
  __shared__ unsigned int warp_valid[kThreads / 32];
  __shared__ bool last;
  const int m = 1 << a.precision;
  if (Shared) {
    for (int i = threadIdx.x; i < m; i += kThreads) regs[i] = 0;
    __syncthreads();
  }
  unsigned int valid = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long w = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; w < a.n_windows; w += stride) {
    const long long b = w / a.span;
    const int s = static_cast<int>(w - b * a.span);
    const int* tok = a.tokens + b * a.length + s;
    uint32_t h = 0;
    bool keep = true;
    for (int k = 0; k < a.ngram; ++k) {
      const int t = tok[k];
      keep = keep && !(a.has_ignore && static_cast<long long>(t) == a.ignore);
      h = mix32(static_cast<uint32_t>(t) + h, 0x9E3779B9u * static_cast<uint32_t>(k + 1));
    }
    if (!keep) continue;
    ++valid;
    const uint32_t x = mix32(h, a.seed);
    const int idx = static_cast<int>(x >> (32 - a.precision));
    const uint32_t rest = x << a.precision;
    const int rank = rest == 0 ? 33 - a.precision : __clz(rest) + 1;
    atomicMax((Shared ? regs : a.registers) + idx, rank);
  }
  valid = __reduce_add_sync(0xffffffffu, valid);
  if ((threadIdx.x & 31) == 0) warp_valid[threadIdx.x >> 5] = valid;
  __syncthreads();
  if (Shared) {
    for (int i = threadIdx.x; i < m; i += kThreads) {
      const int r = regs[i];
      if (r > 0) atomicMax(a.registers + i, r);
    }
  }
  if (threadIdx.x == 0) {
    unsigned long long block_valid = 0;
    for (int i = 0; i < kThreads / 32; ++i) block_valid += warp_valid[i];
    atomicAdd(a.acc, block_valid);
    __threadfence();
    last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    const unsigned long long count = atomicAdd(a.acc, 0ull);
    a.total_out[0] = __fadd_rn(a.total_in[0], __ull2float_rn(count));
    *a.acc = 0;
    *a.ticket = 0;
  }
}

}  // namespace

extern "C" int hll_insert_launch(const void* tokens, long long n_seqs, int length, int ngram, int has_ignore,
                                 long long ignore, int precision, unsigned int seed, void* registers,
                                 const void* total_in, void* total_out, void* acc, void* ticket, int blocks,
                                 void* stream_ptr) {
  const int span = length - ngram + 1;
  if (n_seqs < 1 || ngram < 1 || span < 1 || precision < 4 || precision > 18 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.tokens = static_cast<const int*>(tokens);
  a.n_windows = n_seqs * span;
  a.length = length;
  a.span = span;
  a.ngram = ngram;
  a.has_ignore = has_ignore;
  a.ignore = ignore;
  a.precision = precision;
  a.seed = seed;
  a.registers = static_cast<int*>(registers);
  a.total_in = static_cast<const float*>(total_in);
  a.total_out = static_cast<float*>(total_out);
  a.acc = static_cast<unsigned long long*>(acc);
  a.ticket = static_cast<unsigned int*>(ticket);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (precision <= kSharedPrecision) {
    const int bytes = (1 << precision) * static_cast<int>(sizeof(int));
    // past 48 KB a kernel must opt in, on the current device (a call each launch: it is cheap and per device)
    const cudaError_t err = cudaFuncSetAttribute(hll_insert_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (1 << kSharedPrecision) * static_cast<int>(sizeof(int)));
    if (err != cudaSuccess) return static_cast<int>(err);
    hll_insert_kernel<true><<<blocks, kThreads, bytes, stream>>>(a);
  } else {
    hll_insert_kernel<false><<<blocks, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
