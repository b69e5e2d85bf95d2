// Multilabel ranking measures, one value a sample: coverage error, label
// ranking average precision (LRAP) and ranking loss, without the (N, L, L)
// comparison tensors.
//
// Replaces the XLA-lowered bodies of the JAX functions
// `multilabel_coverage_error` (torchmetrics_tpu/functional/classification/
// ranking.py:33-41), `multilabel_ranking_average_precision` (:44-63) and
// `multilabel_ranking_loss` (:66-80), up to their final mean over the samples.
// For a row of scores s, relevance rel = t * valid, irrelevance
// irr = (1 - t) * valid (t the target with ignored labels set to 0, as float32)
// and valid 0 where the target is ignore_index:
//
//   coverage: m = min_{rel_j > 0} s_j (NaN if one of them is NaN, +inf if none);
//             sum_j valid_j [s_j >= m], or 0 where m is +-inf
//   LRAP:     rank_all_i = sum_j valid_j [s_i <= s_j], rank_rel_i = sum_j rel_j [s_i <= s_j];
//             sum_{rel_i > 0} rank_rel_i / rank_all_i / max(n_rel, 1), 1 where
//             n_rel = 0 or n_rel == sum valid
//   loss:     sum_i rel_i sum_j irr_j [s_j >= s_i] / max(n_rel n_irr, 1), 0 where
//             n_rel n_irr <= 0
//
// in the JAX comparison forms, so a NaN score compares false, and with JAX's
// float32 arithmetic: the ranks are sums of the same 0/1 (or integer) terms,
// exact below 2**24; the LRAP fractions are summed in another order than
// XLA's (a few ulps).
//
// Bound on the card: the bytes are the scores and targets read once, the
// values written once (N * L * 8 + N * 4 bytes at int32 targets); the work is
// the L * L pair compares of LRAP and the loss (1.07 G at N=64, L=4,096:
// 16 us at 67 TFLOP/s counting one operation a pair), L of the coverage.
// Large L binds on operations, small L on launch latency.
//
// What the design does about it:
// - a block holds the whole row in shared memory as float4 (score, rel, irr,
//   valid), 16 bytes a label: every thread reads the same j at once (a
//   broadcast, no bank conflict); rows of more than ~3,000 labels take
//   dynamic shared memory above 48 KB, up to the launcher's stated limit;
// - each thread owns labels i and keeps four of them in registers at a time,
//   so one shared load of j serves four compares; a pair costs a compare and
//   one or two predicated adds;
// - rows too few to fill the card are split over several blocks (grid.y) by
//   their labels i; each block writes its partial sum, and the last block of
//   the row (a per-row ticket, reset after use) adds the partials in block
//   order and writes the value: deterministic;
// - the block sums go through fixed warp trees: deterministic.
//
// Device work of one call, on the caller's stream: one kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kOwn = 4;  // labels i a thread compares against each j at once

enum Measure { kCoverage = 0, kLrap = 1, kLoss = 2 };

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

// Fixed-order block sum (every thread gets the result).
__device__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(kFull, v, offset);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  __syncthreads();  // scratch may still be read from a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < warps; ++w) total += scratch[w];
  return total;
}

// Block min with NaN propagating (jnp.min), +inf for none.
__device__ float block_min_nan(float v, float* scratch) {
  const bool nan = __any_sync(kFull, v != v);  // fminf drops a NaN, so vote on it first
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, offset));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = nan ? quiet_nan() : v;
  __syncthreads();
  float m = pos_inf();
  bool any_nan = false;
  for (int w = 0; w < warps; ++w) {
    any_nan |= scratch[w] != scratch[w];
    m = fminf(m, scratch[w]);
  }
  return any_nan ? quiet_nan() : m;
}

struct Args {
  const float* preds;
  const void* target;
  float* out;        // (N,)
  float* partial;    // (N, splits) when splits > 1
  unsigned int* tickets;  // (N,), zero before and after
  int n_rows, n_labels, chunk;
  bool has_ignore;
  long long ignore;
};

template <typename U, int MEASURE>
__global__ void __launch_bounds__(512) ranking_kernel(Args a) {
  extern __shared__ __align__(16) float4 row[];  // [n_labels] (score, rel, irr, valid), then 32 floats
  float* scratch = reinterpret_cast<float*>(row + a.n_labels);
  const int r = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const float* scores = a.preds + static_cast<long long>(r) * a.n_labels;
  const U* target = static_cast<const U*>(a.target) + static_cast<long long>(r) * a.n_labels;

  float n_rel = 0.0f, n_irr = 0.0f, n_valid = 0.0f, min_rel = pos_inf();
  for (int j = threadIdx.x; j < a.n_labels; j += blockDim.x) {
    const int t32 = static_cast<int>(target[j]);  // an int64 label counts as its low 32 bits
    const bool ignored = a.has_ignore && static_cast<long long>(t32) == a.ignore;
    const float valid = ignored ? 0.0f : 1.0f;
    const float t = __int2float_rn(ignored ? 0 : t32);
    const float s = scores[j];
    const float rel = t * valid, irr = (1.0f - t) * valid;
    row[j] = make_float4(s, rel, irr, valid);
    n_rel += rel;
    n_irr += irr;
    n_valid += valid;
    if (rel > 0.0f) min_rel = (s != s || min_rel != min_rel) ? quiet_nan() : fminf(min_rel, s);
  }
  __syncthreads();

  if (MEASURE == kCoverage) {  // O(L): one block a row
    const float m = block_min_nan(min_rel, scratch);
    float covered = 0.0f;
    for (int j = threadIdx.x; j < a.n_labels; j += blockDim.x) {
      const float4 x = row[j];
      covered += (x.x >= m) ? x.w : 0.0f;
    }
    covered = block_sum(covered, scratch);
    if (threadIdx.x == 0) a.out[r] = (m == pos_inf() || m == -pos_inf()) ? 0.0f : covered;
    return;
  }

  // the labels i of this block: [lo, hi)
  const int lo = split * a.chunk, hi = min(a.n_labels, lo + a.chunk);
  float mine = 0.0f;
  for (int base = lo + threadIdx.x; base < hi; base += kOwn * blockDim.x) {
    float si[kOwn], acc_a[kOwn], acc_b[kOwn];
#pragma unroll
    for (int q = 0; q < kOwn; ++q) {
      const int i = base + q * blockDim.x;
      si[q] = i < hi ? row[i].x : quiet_nan();  // a NaN score compares false: it adds nothing
      acc_a[q] = 0.0f;
      acc_b[q] = 0.0f;
    }
#pragma unroll 4
    for (int j = 0; j < a.n_labels; ++j) {
      const float4 x = row[j];  // a broadcast: every thread reads the same j
#pragma unroll
      for (int q = 0; q < kOwn; ++q) {
        const bool ge = si[q] <= x.x;
        if (MEASURE == kLrap) {
          acc_a[q] += ge ? x.w : 0.0f;  // rank_all
          acc_b[q] += ge ? x.y : 0.0f;  // rank_rel
        } else {
          acc_a[q] += ge ? x.z : 0.0f;  // irrelevant labels scored at or above i
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kOwn; ++q) {
      const int i = base + q * blockDim.x;
      if (i < hi) {
        const float rel_i = row[i].y;
        if (MEASURE == kLrap) {
          if (rel_i > 0.0f) mine += acc_b[q] / acc_a[q];
        } else if (rel_i != 0.0f) {
          mine += rel_i * acc_a[q];
        }
      }
    }
  }
  const float part = block_sum(mine, scratch);
  n_rel = block_sum(n_rel, scratch);
  n_irr = block_sum(n_irr, scratch);
  n_valid = block_sum(n_valid, scratch);
  if (threadIdx.x != 0) return;

  float total = part;
  if (splits > 1) {
    a.partial[static_cast<long long>(r) * splits + split] = part;
    __threadfence();
    if (atomicAdd(a.tickets + r, 1u) != static_cast<unsigned>(splits - 1)) return;
    __threadfence();
    total = 0.0f;
    for (int b = 0; b < splits; ++b) total += __ldcg(a.partial + static_cast<long long>(r) * splits + b);
    a.tickets[r] = 0u;  // every block of the row has taken its ticket
  }
  float value;
  if (MEASURE == kLrap) {
    value = n_rel > 0.0f ? total / fmaxf(n_rel, 1.0f) : 1.0f;
    if (n_rel == n_valid) value = 1.0f;
  } else {
    const float denom = n_rel * n_irr;
    value = denom > 0.0f ? total / fmaxf(denom, 1.0f) : 0.0f;
  }
  a.out[r] = value;
}

template <typename U, int MEASURE>
cudaError_t launch_measure(const Args& a, int splits, int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(ranking_kernel<U, MEASURE>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ranking_kernel<U, MEASURE><<<dim3(a.n_rows, splits), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_target(int measure, const Args& a, int splits, int threads, size_t smem, cudaStream_t stream) {
  switch (measure) {
    case kCoverage: return launch_measure<U, kCoverage>(a, splits, threads, smem, stream);
    case kLrap: return launch_measure<U, kLrap>(a, splits, threads, smem, stream);
    case kLoss: return launch_measure<U, kLoss>(a, splits, threads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// measure: 0 coverage, 1 LRAP, 2 ranking loss. target_kind: 0 int32, 1 int64.
// preds (N, L) float32 and target (N, L) contiguous; out (N,) float32;
// partial (N, splits) float32 scratch; tickets (N,) zero before and after.
extern "C" int ranking_pairs_launch(const void* preds, const void* target, int target_kind, int n_rows,
                                    int n_labels, int has_ignore, long long ignore_index, int measure, void* out,
                                    void* partial, void* tickets, int splits, int chunk, int threads,
                                    void* stream_ptr) {
  Args a;
  a.preds = static_cast<const float*>(preds);
  a.target = target;
  a.out = static_cast<float*>(out);
  a.partial = static_cast<float*>(partial);
  a.tickets = static_cast<unsigned int*>(tickets);
  a.n_rows = n_rows;
  a.n_labels = n_labels;
  a.chunk = chunk;
  a.has_ignore = has_ignore != 0;
  a.ignore = ignore_index;
  const size_t smem = static_cast<size_t>(n_labels) * sizeof(float4) + 32 * sizeof(float);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = target_kind == 0 ? launch_target<int>(measure, a, splits, threads, smem, stream)
                                           : launch_target<long long>(measure, a, splits, threads, smem, stream);
  return static_cast<int>(err);
}
