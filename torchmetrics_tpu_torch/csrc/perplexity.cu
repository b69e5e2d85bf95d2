// Perplexity's update: for (N, V) logits and (N,) targets, the summed negative
// log-likelihood of the targets under the row's softmax and the count of rows
// not ignored, in one launch, with each row's log-sum-exp kept for the
// gradient.
//
// Replaces torchmetrics_tpu/functional/text/perplexity.py:46-57: a float32
// log_softmax over (N, V) (XLA's max, exp-sum and subtract: the row is read
// more than once and the (N, V) log-probabilities written once), the gather of
// the targets, -(picked * mask).sum() and mask.sum(). There is no TPU kernel.
// At GPT-2's vocabulary (V = 50,257) and a batch of 8 x 1,024 tokens the
// float32 logits are 1.65 GB.
//
// Bound on the card: the logits read once, N V itemsize bytes, at 3.35 TB/s
// (H100 SXM data sheet, 700 W): 0.49 ms for that batch. The arithmetic (one
// exponential and a few adds an element) is far below the memory's rate.
//
// What the design does about it:
// - one pass over each row with an online maximum and sum of exponentials in
//   float32 (m, s; a larger value rescales s by exp(m_old - m_new)), so the
//   row is read once and nothing of size V is written;
// - 16-byte loads: a scalar head up to the row's first 16-byte boundary (a
//   row of V = 50,257 float32 values starts anywhere), then vectors of 4
//   float32 or 8 bfloat16 or float16 values, 4 vectors in flight a thread,
//   then a scalar tail;
// - a block of kBlockThreads a row when V is large (kWarpRowMax < V), else one
//   warp a row and kBlockThreads / 32 rows a block;
// - the target's logit is one load by the row's first lane; an ignored row is
//   not read at all;
// - each row's NLL and log-sum-exp go to (N,) float32 arrays; the last block
//   (a ticket, set back to zero by that block) sums the NLLs and counts the
//   kept rows in a fixed order, so two launches give the same bits.
//
// The semantics held are JAX's: picked = (x_t - m) - log(s), the total is
// -sum(picked) over the kept rows; an ignored row adds nothing, whatever its
// logits; a target in [-V, 0) wraps once, and one outside [-V, V) makes the
// total NaN (take_along_axis's fill); a NaN logit in a kept row makes it NaN,
// and so does +inf (inf - inf), as log_softmax's shift by the maximum does.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cstdint>

namespace {

constexpr int kBlockThreads = 256;
constexpr int kWarpRowMax = 4096;  // a warp a row up to this V, a block a row above it
constexpr int kUnroll = 4;         // 16-byte vectors in flight a thread

__device__ __forceinline__ float bf16_bits(unsigned short u) { return __uint_as_float(static_cast<unsigned int>(u) << 16); }
__device__ __forceinline__ float f16_bits(unsigned short u) { return __half2float(__ushort_as_half(u)); }

// the running (m, s) of a lane: s is the sum of exp(x - m) over the values seen. (-inf, 0) is "nothing seen";
// a NaN, or a +inf (JAX's shift by the maximum gives inf - inf there), makes s NaN for good: NaN * 0 is NaN.
struct Online {
  float m = -INFINITY;
  float s = 0.0f;
  __device__ __forceinline__ bool empty() const { return m == -INFINITY && s == 0.0f; }
  __device__ __forceinline__ void add(float x) {
    if (x == -INFINITY) return;  // exp(-inf - m) = 0, and m = -inf would give -inf + inf
    if (x > m) {
      s = x == INFINITY ? NAN : s * expf(m - x) + 1.0f;  // m = -inf: expf(-inf) = 0
      m = x;
    } else {
      s += expf(x - m);  // a NaN x (x > m is false) makes s NaN
    }
  }
  __device__ __forceinline__ void merge(float om, float os) {
    if (om == -INFINITY && os == 0.0f) return;
    if (empty()) {
      m = om;
      s = os;
      return;
    }
    const float nm = fmaxf(m, om);
    s = s * expf(m - nm) + os * expf(om - nm);
    m = nm;
  }
};

template <int Kind>
struct Vec;  // 16 bytes of logits as floats

template <>
struct Vec<0> {  // float32
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const void* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ __forceinline__ static float one(const void* row, long long i) {
    return __ldg(reinterpret_cast<const float*>(row) + i);
  }
};

template <int Kind>
struct Vec16 {  // bfloat16 (1) or float16 (2)
  static constexpr int kN = 8;
  __device__ __forceinline__ static float conv(unsigned short u) { return Kind == 1 ? bf16_bits(u) : f16_bits(u); }
  __device__ __forceinline__ static void load(const void* p, float* out) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = conv(static_cast<unsigned short>(w[i] & 0xffffu));
      out[2 * i + 1] = conv(static_cast<unsigned short>(w[i] >> 16));
    }
  }
  __device__ __forceinline__ static float one(const void* row, long long i) {
    return conv(__ldg(reinterpret_cast<const unsigned short*>(row) + i));
  }
};

template <>
struct Vec<1> : Vec16<1> {};
template <>
struct Vec<2> : Vec16<2> {};

__device__ __forceinline__ long long load_target(const void* target, int target_kind, long long r) {
  return target_kind == 0 ? static_cast<long long>(reinterpret_cast<const int*>(target)[r])
                          : reinterpret_cast<const long long*>(target)[r];
}

// (m, s) over the row's values [lane, ...) by `lanes` threads: head, 16-byte body, tail
template <int Kind>
__device__ __forceinline__ Online scan_row(const char* row, long long v, int lane, int lanes) {
  using V = Vec<Kind>;
  constexpr int kItem = Kind == 0 ? 4 : 2;
  Online acc;
  const long long misalign = (reinterpret_cast<uintptr_t>(row) & 15) / kItem;
  long long head = misalign ? (V::kN - misalign) : 0;
  if (head > v) head = v;
  for (long long i = lane; i < head; i += lanes) acc.add(V::one(row, i));
  const long long n_vec = (v - head) / V::kN;
  const char* body = row + head * kItem;
  long long j = lane;
  for (; j + (kUnroll - 1) * lanes < n_vec; j += kUnroll * lanes) {
    float x[kUnroll][V::kN];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) V::load(body + (j + u * lanes) * 16, x[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int e = 0; e < V::kN; ++e) acc.add(x[u][e]);
  }
  for (; j < n_vec; j += lanes) {
    float x[V::kN];
    V::load(body + j * 16, x);
#pragma unroll
    for (int e = 0; e < V::kN; ++e) acc.add(x[e]);
  }
  for (long long i = head + n_vec * V::kN + lane; i < v; i += lanes) acc.add(V::one(row, i));
  return acc;
}

__device__ __forceinline__ Online warp_merge(Online acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, acc.m, off);
    const float os = __shfl_xor_sync(0xffffffffu, acc.s, off);
    acc.merge(om, os);
  }
  return acc;
}

// the row's NLL (-picked) and log-sum-exp from its (m, s) and the target's logit
__device__ __forceinline__ void finish_row(Online acc, float x_t, bool in_range, float* nll, float* lse) {
  const float log_s = logf(acc.s);
  const float picked = (x_t - acc.m) - log_s;
  *nll = in_range ? -picked : NAN;
  *lse = acc.m + log_s;
}

// the last block: the NLLs summed and the kept rows counted in a fixed order
__device__ void last_block_sum(const float* row_nll, const void* target, int target_kind, long long n_rows,
                               int has_ignore, long long ignore_index, float* total, float* count,
                               int* ticket) {
  __shared__ bool last;
  __shared__ float sums[kBlockThreads / 32];
  __shared__ float counts[kBlockThreads / 32];
  __threadfence();  // each writer's row results are visible before its block takes a ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.0f, c = 0.0f;
  for (long long r = threadIdx.x; r < n_rows; r += kBlockThreads) {
    s += __ldcg(row_nll + r);
    c += (!has_ignore || load_target(target, target_kind, r) != ignore_index) ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
  if ((threadIdx.x & 31) == 0) {
    sums[threadIdx.x >> 5] = s;
    counts[threadIdx.x >> 5] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.0f, tc = 0.0f;
    for (int w = 0; w < kBlockThreads / 32; ++w) {
      ts += sums[w];
      tc += counts[w];
    }
    // JAX's -(sum of picked) is the NLLs' sum, but for the sign of a zero: -(+0.0), as all-ignored rows give
    *total = ts == 0.0f ? -0.0f : ts;
    *count = tc;
    *ticket = 0;
  }
}

// RowThreads = kBlockThreads: a block a row; 32: a warp a row, kBlockThreads / 32 rows a block
template <int Kind, int RowThreads>
__global__ void __launch_bounds__(kBlockThreads) perplexity_nll_kernel(
    const char* __restrict__ logits, long long n_rows, long long v, const void* __restrict__ target,
    int target_kind, int has_ignore, long long ignore_index, float* __restrict__ row_nll,
    float* __restrict__ row_lse, float* __restrict__ total, float* __restrict__ count, int* __restrict__ ticket) {
  constexpr int kItem = Kind == 0 ? 4 : 2;
  constexpr int kRowsPerBlock = kBlockThreads / RowThreads;
  const long long r = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / RowThreads;
  const int lane = threadIdx.x % RowThreads;
  __shared__ float part_m[kBlockThreads / 32];
  __shared__ float part_s[kBlockThreads / 32];
  bool kept = false;
  long long t = 0;
  if (r < n_rows) {
    t = load_target(target, target_kind, r);
    kept = !has_ignore || t != ignore_index;
  }
  const char* row = logits + r * v * kItem;
  Online acc;
  if (kept) acc = scan_row<Kind>(row, v, lane, RowThreads);
  acc = warp_merge(acc);  // every lane of the warp takes part: a row's lanes agree on kept
  if (RowThreads > 32) {
    if ((threadIdx.x & 31) == 0) {
      part_m[threadIdx.x >> 5] = acc.m;
      part_s[threadIdx.x >> 5] = acc.s;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kBlockThreads / 32; ++w) acc.merge(part_m[w], part_s[w]);
    }
  }
  if (r < n_rows && lane == 0) {
    if (!kept) {
      row_nll[r] = 0.0f;
      row_lse[r] = 0.0f;
    } else {
      const long long wrapped = t < 0 ? t + v : t;
      const bool in_range = wrapped >= 0 && wrapped < v;
      const float x_t = in_range ? Vec<Kind>::one(row, wrapped) : 0.0f;
      finish_row(acc, x_t, in_range, row_nll + r, row_lse + r);
    }
  }
  last_block_sum(row_nll, target, target_kind, n_rows, has_ignore, ignore_index, total, count, ticket);
}

template <int Kind>
cudaError_t launch(const void* logits, long long n_rows, long long v, const void* target, int target_kind,
                   int has_ignore, long long ignore_index, float* row_nll, float* row_lse, float* total,
                   float* count, int* ticket, cudaStream_t stream) {
  const char* p = static_cast<const char*>(logits);
  if (v > kWarpRowMax) {
    const unsigned int blocks = static_cast<unsigned int>(n_rows);
    perplexity_nll_kernel<Kind, kBlockThreads><<<blocks, kBlockThreads, 0, stream>>>(
        p, n_rows, v, target, target_kind, has_ignore, ignore_index, row_nll, row_lse, total, count, ticket);
  } else {
    constexpr int kRows = kBlockThreads / 32;
    const unsigned int blocks = static_cast<unsigned int>((n_rows + kRows - 1) / kRows);
    perplexity_nll_kernel<Kind, 32><<<blocks, kBlockThreads, 0, stream>>>(
        p, n_rows, v, target, target_kind, has_ignore, ignore_index, row_nll, row_lse, total, count, ticket);
  }
  return cudaGetLastError();
}

}  // namespace

// logits (N, V) contiguous: kind 0 float32, 1 bfloat16, 2 float16; target (N,) int32 (target_kind 0) or
// int64 (1); has_ignore and ignore_index; row_nll and row_lse (N,) float32; total and count one float32
// each; ticket one int32, zero on entry (the last block sets it back). N >= 1.
extern "C" int perplexity_nll_launch(const void* logits, int kind, long long n_rows, long long v,
                                     const void* target, int target_kind, int has_ignore, long long ignore_index,
                                     float* row_nll, float* row_lse, float* total, float* count, int* ticket,
                                     void* stream) {
  if (n_rows < 1 || v < 1 || (v > kWarpRowMax ? n_rows : (n_rows + 7) / 8) > 2147483647LL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return launch<0>(logits, n_rows, v, target, target_kind, has_ignore, ignore_index, row_nll, row_lse, total, count, ticket, s);
    case 1: return launch<1>(logits, n_rows, v, target, target_kind, has_ignore, ignore_index, row_nll, row_lse, total, count, ticket, s);
    case 2: return launch<2>(logits, n_rows, v, target, target_kind, has_ignore, ignore_index, row_nll, row_lse, total, count, ticket, s);
    default: return cudaErrorInvalidValue;
  }
}
