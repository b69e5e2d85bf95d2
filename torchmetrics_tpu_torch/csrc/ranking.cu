// Multilabel ranking measures, one value a sample: coverage error, label
// ranking average precision (LRAP) and ranking loss, without the (N, L, L)
// comparison tensors.
//
// Replaces the XLA-lowered bodies of the JAX functions
// `multilabel_coverage_error` (torchmetrics_tpu/functional/classification/
// ranking.py:33-41), `multilabel_ranking_average_precision` (:44-63) and
// `multilabel_ranking_loss` (:66-80), up to their final mean over the samples.
// For a row of scores s, relevance rel = t * valid, irrelevance
// irr = (1 - t) * valid (t the target with ignored labels set to 0) and
// valid 0 where the target is ignore_index:
//
//   coverage: m = min_{rel_j > 0} s_j (NaN if one of them is NaN, +inf if none);
//             sum_j valid_j [s_j >= m], or 0 where m is +-inf
//   LRAP:     rank_all_i = sum_j valid_j [s_i <= s_j], rank_rel_i = sum_j rel_j [s_i <= s_j];
//             sum_{rel_i > 0} rank_rel_i / rank_all_i / max(n_rel, 1), 1 where
//             n_rel = 0 or n_rel == sum valid
//   loss:     sum_i rel_i sum_j irr_j [s_j >= s_i] / max(n_rel n_irr, 1), 0 where
//             n_rel n_irr <= 0
//
// in the JAX comparison forms, so a NaN score compares false: a relevant
// NaN label makes its row's LRAP NaN (0 / 0) and adds 0 to the loss.
//
// Bound on the card: the bytes are the scores and targets read once and a
// value a row written once (N * L * 8 + N * 4 bytes at int32 targets); LRAP
// and the loss need each label's counts of valid and of relevant labels
// scored at or above it, which a sort of the row (L log2 L compares) and a
// scan give. So bytes bind at every shape, and small batches bind on the
// launch.
//
// What the design does about it (LRAP and the loss; coverage stays O(L): a
// block a row keeps the row's scores in shared memory, takes a NaN-voting
// block min and counts):
// - a group of threads owns a row: one warp up to 256 labels (a warp's
//   lanes hold 1, 2, 4 or 8 labels each and the whole row stays in
//   registers: no shared memory, no block barrier, and several rows share a
//   block), one block above (4 labels a thread up to 2,048, 8 up to 8,192,
//   16 at 16,384);
// - each label becomes one 64-bit word, an order-preserving key of its score
//   above its relevance: -0.0 is folded into +0.0 so the two tie as in JAX,
//   and NaN scores and ignored labels get key 0, below -inf, so they fall at
//   the end and count in no prefix; the row pads to a power of two with
//   zero words, which weigh nothing;
// - a bitonic sort, descending, with the words blocked E to a thread: the
//   stages whose partner is in the same thread run in registers, those
//   whose partner is in the same warp through shuffles, and only the stages
//   whose partner is in another warp through shared memory (a padded
//   layout, no bank conflicts): at (64, 4096) 10 of 78 stages;
// - one segmented scan over the sorted order, in a fixed order, gives at the
//   end of every run of equal keys the run's relevant count (LRAP) or
//   relevance sum (the loss) and the prefix of relevance up to the run's
//   end; the prefix of valid labels is the position itself, since every
//   word with a non-zero key is valid. Reading at the end of the run is
//   JAX's `>=`. The sums are integers (a target of 2 gives rel = 2 and
//   irr = -1), exact for any int32 target while they fit 64 bits;
// - LRAP adds runs * (float32 rank_rel / rank_all, JAX's division) in
//   double and rounds once; the loss sums int64; both reduce in a fixed
//   order, so a row's value is the same bit for bit in every launch.
//
// Device work of one call, on the caller's stream: one kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;

enum Measure { kCoverage = 0, kLrap = 1, kLoss = 2 };

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

struct Args {
  const float* preds;
  const void* target;
  float* out;  // (N,)
  int n_rows, n_labels;
  int width;  // the sort's width: a power of two >= n_labels, = group * E
  int group;  // threads a row: 32 (a warp), or width / E in a block of its own
  bool target64;
  bool has_ignore;
  long long ignore;
};

// The target of label `idx` (an int64 target counts as its low 32 bits) and whether it is valid.
__device__ __forceinline__ int target_at(const Args& a, long long idx, bool& valid) {
  const int t32 = a.target64 ? static_cast<int>(static_cast<const long long*>(a.target)[idx])
                             : static_cast<const int*>(a.target)[idx];
  valid = !(a.has_ignore && static_cast<long long>(t32) == a.ignore);
  return valid ? t32 : 0;
}

// ------------------------------------------------------------------ coverage

// Fixed-order block sum (every thread gets the result).
__device__ int block_sum(int v, int* scratch) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(kFull, v, offset);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  __syncthreads();  // scratch may still be read from a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
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

// One block a row: the row's scores in shared memory (NaN for an ignored label, which
// then counts nowhere), the min over relevant labels, and the valid labels at or above it.
__global__ void __launch_bounds__(512) coverage_kernel(Args a) {
  extern __shared__ float s_row[];  // n_labels, then 32 floats of scratch
  float* scratch = s_row + a.n_labels;
  const long long base = static_cast<long long>(blockIdx.x) * a.n_labels;
  float min_rel = pos_inf();
  for (int j = threadIdx.x; j < a.n_labels; j += blockDim.x) {
    bool valid;
    const int rel = target_at(a, base + j, valid);
    const float s = a.preds[base + j];
    s_row[j] = valid ? s : quiet_nan();
    if (rel > 0) min_rel = (s != s || min_rel != min_rel) ? quiet_nan() : fminf(min_rel, s);
  }
  const float m = block_min_nan(min_rel, scratch);  // its barriers also publish s_row
  int covered = 0;
  for (int j = threadIdx.x; j < a.n_labels; j += blockDim.x) covered += s_row[j] >= m;
  covered = block_sum(covered, reinterpret_cast<int*>(scratch));
  if (threadIdx.x == 0) a.out[blockIdx.x] = (m == pos_inf() || m == -pos_inf()) ? 0.0f : static_cast<float>(covered);
}

// ------------------------------------------------------------ LRAP and loss

// Order-preserving key of a finite or infinite score: larger score, larger key; -0.0 as +0.0.
// Every such key is at least that of -inf (0x007fffff), so key 0 is free for what counts nowhere.
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned b = s == 0.0f ? 0u : __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned key_of(unsigned long long word) { return static_cast<unsigned>(word >> 32); }
__device__ __forceinline__ int rel_of(unsigned long long word) { return static_cast<int>(static_cast<unsigned>(word)); }

// Shared slot of sorted position i: one pad word every 16, so a warp's blocked stores fall on all banks.
__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

// A segment of the scan: whether it holds a run start, the sum since its last run start
// (or all of it), and its plain relevance sum.
struct Seg {
  int starts;
  long long run;
  long long prefix;
};

__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {  // a, then b
  return {a.starts | b.starts, b.starts ? b.run : a.run + b.run, a.prefix + b.prefix};
}

__device__ __forceinline__ Seg shfl_up(const Seg& s, int d) {
  return {__shfl_up_sync(kFull, s.starts, d), __shfl_up_sync(kFull, s.run, d), __shfl_up_sync(kFull, s.prefix, d)};
}

// The row's per-label words, sorted descending and blocked: thread t of the group ends
// with sorted positions [E t, E t + E). The pair of position i in a stage (k, j) is
// i ^ j; the pair ends descending where (i & k) == 0, ascending elsewhere, so the last
// merge (k = width) leaves the whole row descending.
template <int E>
__device__ __forceinline__ void bitonic_sort(unsigned long long (&v)[E], unsigned long long* s_sort, int width,
                                             int group, int t, int lane) {
  for (int k = 2; k <= width; k <<= 1) {
    int j = k >> 1;
    if (j >= 32 * E) {  // the partner is in another warp: through shared memory (group > 32 only)
      __syncthreads();  // the last reads of s_sort are done
#pragma unroll
      for (int e = 0; e < E; ++e) s_sort[padded(E * t + e)] = v[e];
      __syncthreads();
      for (; j >= 32 * E; j >>= 1) {
        for (int q = t; q < (width >> 1); q += group) {
          const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          const unsigned long long x = s_sort[padded(i)], y = s_sort[padded(i + j)];
          if ((x < y) == ((i & k) == 0)) {
            s_sort[padded(i)] = y;
            s_sort[padded(i + j)] = x;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = s_sort[padded(E * t + e)];
    }
    // the partner is in lane ^ (j / E); (E t + e) & k == (E t) & k, as k > j >= E > e
    const bool descending = ((E * t) & k) == 0;
    for (; j >= E; j >>= 1) {
      const int m = j / E;
      const bool take_max = ((lane & m) == 0) == descending;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const unsigned long long o = __shfl_xor_sync(kFull, v[e], m);
        v[e] = (take_max == (v[e] < o)) ? o : v[e];
      }
    }
    // the partner is in this thread: stages j = min(k / 2, E / 2) .. 1, unrolled
#pragma unroll
    for (int jj = E / 2; jj > 0; jj >>= 1) {
      if (jj < k) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & jj) == 0) {
            const unsigned long long x = v[e], y = v[e | jj];
            const bool swap = (x < y) == (((E * t + e) & k) == 0);
            v[e] = swap ? y : x;
            v[e | jj] = swap ? x : y;
          }
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(kFull, v, offset);
  return v;
}

// LRAP or the loss of one row a group. Warp groups (group == 32) share a block and
// never touch shared memory or a block barrier; a larger group is the whole block.
template <int MEASURE, int E>
__global__ void __launch_bounds__(kMaxThreads) ranking_sort_kernel(Args a) {
  extern __shared__ unsigned long long s_sort[];  // padded(width) words, group > 32 only
  __shared__ unsigned s_edge[2][32];              // each warp's first and last sorted key
  __shared__ Seg s_seg[32];                       // each warp's scan aggregate
  __shared__ double s_acc[32];
  __shared__ long long s_big[2][32];
  __shared__ int s_small[2][32];

  const int group = a.group;
  const int t = threadIdx.x % group;
  const int row = blockIdx.x * (blockDim.x / group) + threadIdx.x / group;
  const int lane = threadIdx.x & 31, warp = t >> 5, warps = group >> 5;
  if (row >= a.n_rows) return;  // whole warps only: a group of more than 32 is the block's one row

  // load, striped for coalescing (the sort does not care where a word starts)
  const long long base = static_cast<long long>(row) * a.n_labels;
  unsigned long long v[E];
  int n_valid = 0, nan_relevant = 0;
  long long n_rel = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = t + group * e;
    unsigned long long word = 0ull;  // padding: key 0, no weight
    if (i < a.n_labels) {
      bool valid;
      const int rel = target_at(a, base + i, valid);
      const float s = a.preds[base + i];
      n_valid += valid;
      n_rel += rel;
      nan_relevant |= s != s && rel > 0;
      const unsigned key = (valid && s == s) ? order_key(s) : 0u;
      word = (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(rel);
    }
    v[e] = word;
  }

  bitonic_sort<E>(v, s_sort, a.width, group, t, lane);

  // the keys beside this thread's positions: E t - 1 and E t + E
  unsigned before = __shfl_up_sync(kFull, key_of(v[E - 1]), 1);
  unsigned after = __shfl_down_sync(kFull, key_of(v[0]), 1);
  if (warps > 1) {
    if (lane == 0) s_edge[0][warp] = key_of(v[0]);
    if (lane == 31) s_edge[1][warp] = key_of(v[E - 1]);
    __syncthreads();
    if (lane == 0 && warp > 0) before = s_edge[1][warp - 1];
    if (lane == 31 && warp + 1 < warps) after = s_edge[0][warp + 1];
  }
  const bool first_thread = t == 0, last_thread = t == group - 1;

  // the scan's term of a position: its run's count (LRAP: relevant labels, the loss: relevance)
  auto term = [](unsigned long long word) -> long long {
    const int rel = rel_of(word);
    return MEASURE == kLrap ? (rel > 0) : rel;
  };
  auto starts_run = [&](int e) -> bool {
    return e == 0 ? (first_thread || before != key_of(v[0])) : key_of(v[e]) != key_of(v[e - 1]);
  };

  // pass 1: this thread's aggregate
  Seg mine = {0, 0, 0};
#pragma unroll
  for (int e = 0; e < E; ++e) mine = combine(mine, Seg{starts_run(e), term(v[e]), rel_of(v[e])});

  // exclusive prefix of the threads before this one, in a fixed order
  Seg inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg o = shfl_up(inc, d);
    if (lane >= d) inc = combine(o, inc);
  }
  Seg ex = shfl_up(inc, 1);
  if (lane == 0) ex = Seg{0, 0, 0};
  if (warps > 1) {
    if (lane == 31) s_seg[warp] = inc;
    __syncthreads();
    Seg w_ex = {0, 0, 0};
    for (int w = 0; w < warp; ++w) w_ex = combine(w_ex, s_seg[w]);
    ex = combine(w_ex, ex);
  }

  // pass 2: at the end of each run of a non-zero key, its labels' ranks
  double acc_lrap = 0.0;
  long long acc_loss = 0;
  Seg run = ex;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run = combine(run, Seg{starts_run(e), term(v[e]), rel_of(v[e])});
    const unsigned key = key_of(v[e]);
    const bool ends = e == E - 1 ? (last_thread || after != key) : key != key_of(v[e + 1]);
    if (ends && key != 0u) {
      const long long rank_all = static_cast<long long>(E) * t + e + 1;  // valid labels at or above
      if (MEASURE == kLrap) {
        if (run.run != 0) {
          const float ratio = static_cast<float>(run.prefix) / static_cast<float>(rank_all);
          acc_lrap += static_cast<double>(run.run) * static_cast<double>(ratio);
        }
      } else {
        acc_loss += run.run * (rank_all - run.prefix);  // relevance of the run x irrelevance at or above
      }
    }
  }

  // the row's sums, in a fixed order
  acc_lrap = warp_sum(acc_lrap);
  acc_loss = warp_sum(acc_loss);
  n_rel = warp_sum(n_rel);
  n_valid = warp_sum(n_valid);
  nan_relevant = __any_sync(kFull, nan_relevant);
  if (warps > 1) {
    if (lane == 0) {
      s_acc[warp] = acc_lrap;
      s_big[0][warp] = acc_loss;
      s_big[1][warp] = n_rel;
      s_small[0][warp] = n_valid;
      s_small[1][warp] = nan_relevant;
    }
    __syncthreads();
    if (t != 0) return;
    acc_lrap = 0.0;
    acc_loss = n_rel = 0;
    n_valid = nan_relevant = 0;
    for (int w = 0; w < warps; ++w) {
      acc_lrap += s_acc[w];
      acc_loss += s_big[0][w];
      n_rel += s_big[1][w];
      n_valid += s_small[0][w];
      nan_relevant |= s_small[1][w];
    }
  }
  if (t != 0) return;

  // JAX's float32 tail
  const float rel_sum = static_cast<float>(n_rel);
  float value;
  if (MEASURE == kLrap) {
    const float total = nan_relevant ? quiet_nan() : static_cast<float>(acc_lrap);
    value = rel_sum > 0.0f ? total / fmaxf(rel_sum, 1.0f) : 1.0f;
    if (rel_sum == static_cast<float>(n_valid)) value = 1.0f;
  } else {
    const float denom = rel_sum * static_cast<float>(n_valid - n_rel);
    value = denom > 0.0f ? static_cast<float>(acc_loss) / fmaxf(denom, 1.0f) : 0.0f;
  }
  a.out[row] = value;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory: above 48 KB of static and
// dynamic shared memory together only after opting in (the kernels here hold at most
// kStaticShared bytes of static arrays); a refused launch never runs.
constexpr size_t kStaticShared = 4096;

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem + kStaticShared <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

template <int MEASURE, int E>
cudaError_t launch_sort(const Args& a, int blocks, int threads, size_t smem, cudaStream_t stream) {
  const cudaError_t err = allow_shared(ranking_sort_kernel<MEASURE, E>, smem);
  if (err != cudaSuccess) return err;
  ranking_sort_kernel<MEASURE, E><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MEASURE>
cudaError_t launch_items(int items, const Args& a, int blocks, int threads, size_t smem, cudaStream_t stream) {
  switch (items) {
    case 1: return launch_sort<MEASURE, 1>(a, blocks, threads, smem, stream);
    case 2: return launch_sort<MEASURE, 2>(a, blocks, threads, smem, stream);
    case 4: return launch_sort<MEASURE, 4>(a, blocks, threads, smem, stream);
    case 8: return launch_sort<MEASURE, 8>(a, blocks, threads, smem, stream);
    case 16: return launch_sort<MEASURE, 16>(a, blocks, threads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// measure: 0 coverage, 1 LRAP, 2 ranking loss. target_kind: 0 int32, 1 int64.
// preds (N, L) float32 and target (N, L) contiguous; out (N,) float32.
// Coverage: `blocks` = N blocks of `threads`, one a row, with `shared_bytes` =
// (L + 32) * 4 of dynamic shared memory. LRAP and the loss: `group` threads a
// row sort `width` = group * items words; a block holds threads / group rows
// (group 32) or one row (group = threads), and `shared_bytes` of dynamic shared
// memory (the padded sort buffer, 0 for warp groups).
extern "C" int ranking_pairs_launch(const void* preds, const void* target, int target_kind, int n_rows,
                                    int n_labels, int has_ignore, long long ignore_index, int measure, void* out,
                                    int width, int items, int group, int threads, int blocks, int shared_bytes,
                                    void* stream_ptr) {
  Args a;
  a.preds = static_cast<const float*>(preds);
  a.target = target;
  a.out = static_cast<float*>(out);
  a.n_rows = n_rows;
  a.n_labels = n_labels;
  a.width = width;
  a.group = group;
  a.target64 = target_kind != 0;
  a.has_ignore = has_ignore != 0;
  a.ignore = ignore_index;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  switch (measure) {
    case kCoverage:
      err = allow_shared(coverage_kernel, shared_bytes);
      if (err == cudaSuccess) {
        coverage_kernel<<<blocks, threads, shared_bytes, stream>>>(a);
        err = cudaGetLastError();
      }
      break;
    case kLrap: err = launch_items<kLrap>(items, a, blocks, threads, shared_bytes, stream); break;
    case kLoss: err = launch_items<kLoss>(items, a, blocks, threads, shared_bytes, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
