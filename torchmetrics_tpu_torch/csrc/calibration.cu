// Calibration-error state update, fused: old (n_bins + 1,) state + one batch
// -> new state, out of place: conf_sum float32, acc_sum and count int32.
//
// Replaces the XLA-lowered JAX functions `_multiclass_ce_confidences`
// (torchmetrics_tpu/functional/classification/calibration_error.py:96-109)
// and `_bin_update` (:30-46), and the state add of the metric classes
// (classification/calibration_error.py:72-78); in binary mode
// `_binary_ce_confidences` (:63-79) in place of the first. For every row r of
// the scores viewed as (M, C) (the JAX `reshape(-1, C)`, which does not move a
// class axis) with target t = target[r]:
//
//   x      = scores[r, :] as float32, softmaxed iff ANY score of the whole
//            batch lies outside [0, 1] (the JAX whole-tensor predicate);
//            softmax = exp(x - max) / sum
//   conf   = max_k x[k];  pred = argmax_k x[k] (lowest index among ties,
//            the first NaN above every number: jnp's rules)
//   w      = 0 if t == ignore_index else 1;  t = 0 if ignored
//   acc    = [pred == t]                     (binary: acc = t, conf = x or sigmoid(x))
//   bin    = clip(floor(conf * n_bins), 0, n_bins), NaN -> 0, +inf -> n_bins
//   new_conf[bin] = old + sum conf * w, new_acc[bin] = old + sum acc * w,
//   new_count[bin] = old + sum w
//
// What the kernel keeps exactly as JAX has it: the bin of every row (JAX
// casts floor(NaN) to 0 and floor(+inf) to INT32_MAX before the clip), the
// argmax rules, the integer counts, and conf * w for an ignored row, which is
// NaN for a NaN confidence and so makes conf_sum[0] NaN. The confidence of
// the chosen form is always in [0, 1] or NaN: the raw scores are kept only when
// none lies outside [0, 1], and softmax and sigmoid give [0, 1] or NaN.
//
// Determinism. The confidences of a batch are summed as 32.32 fixed-point
// integers (conf * 2^32, rounded to nearest; exact to 2^-33 a row, whereas
// JAX sums float32), so every sum, shared or global, is an integer sum and
// the result is identical bit for bit from run to run. No float atomics.
// The batch sum is rounded once to float32 and added to the old conf_sum.
// Counts are int32; JAX sums float32 0/1 weights a batch, exact below 2**24.
//
// The whole-tensor predicate needs every score before any row can choose
// its form. Instead of a separate reduction launch, each row is binned both
// ways (raw and normalized) into two histograms, and each block ORs whether
// any of its scores lies outside [0, 1]. One launch a batch, no host read.
//
// Bound on the card: the update must read the scores once and the targets
// once, and read and write the 3 (n_bins + 1) state values. At ImageNet-1k's
// batch (1,024 x 1,000 float32, int64 targets, n_bins = 15) that is 4.1 MB:
// 1.23 us at 3.35 TB/s (H100 SXM data sheet, 700 W). The softmax takes about
// 4 float operations a score (4.1 M): 0.06 us at 67 TFLOP/s; bytes bind. At
// that size the launch and one cold read of the rows are most of the time, so
// the design keeps the chain after the read short:
//
// - no divide a score: the probabilities' maximum is 1 / sum, since the
//   largest e_k = expf(x_k - max) is expf(0) = 1 and a correctly rounded
//   divide is monotone, so their argmax is the lowest k with
//   e_k / sum == 1 / sum (one index reduction, no (value, index) shuffles).
//   For e_k < 1 - 2^-22 the exact quotients differ by more than an ulp, so
//   the register path divides only the few e_k at or above it: the argmax
//   of the divided row, bit for bit. Of those, only 1 - 2^-24 can tie 1 / sum
//   (a sum of 6.25, say), and CUDA 12.8's expf returns no such value: it steps
//   from 1 to 1 - 2^-23 (chip_smoke.py scans every float32 x in the filter's
//   range and holds rows built on that step against a divided reference).
//   The divide stays so that the result never rests on one libm. The test
//   stays written out in the loop's condition: put in a helper function, it
//   compiled no faster than a divide a score. The long-row and thread-a-row
//   paths divide every score;
// - W warps a row (W = 4, 2 or 1, the launcher's pick by the rows against
//   the SMs, each where it measured fastest): up to 1,024 scores a row stay
//   in registers, 32 / W a lane, read in 16-byte loads where the row is
//   16-byte aligned; the W parts meet in shared memory (max and argmax,
//   sum, candidate index: three barriers a round). Longer rows take a warp and are read again from L2 in each pass.
//   Rows of fewer than 32 scores take a thread a row; binary scores a thread
//   each, 4 loaded before any is binned;
// - histograms in shared memory (2 x (n_bins + 1) x (8 + 4 + 4) bytes:
//   n_bins <= 1023 fits in 32,784 bytes), added with 32-bit atomics only (a 64-bit
//   shared atomic is a compare-and-swap loop that contended lanes repeat);
// - the merge tail reads words, not partials: every block adds its non-zero
//   bins to one per-stream accumulator in global memory with integer atomics,
//   and the last block (a ticket in the accumulator, one acquire-release
//   atomic a block in place of two fences) reads the chosen variant's
//   3 (n_bins + 1) + 2 words, writes the new state and zeroes the accumulator
//   for the next launch on the stream (the launcher zeroes it once);
// - one block for a batch of one round of a block: it writes the new state
//   from shared memory, with no atomics in global memory, no fence and no
//   ticket; a binary batch picks its variant before it bins.
//
// Device work of one update, on the caller's stream: one kernel.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowScores = 1024;  // a row of up to this many scores stays in registers
constexpr int kItems = 4;         // binary scores a thread loads before it bins any
constexpr float kFixedScale = 4294967296.0f;  // 2^32
constexpr double kFixedUnit = 1.0 / 4294967296.0;
// For e = expf(x - max) below this, e / sum < 1 / sum after rounding (the exact
// quotients differ by more than an ulp): the register path divides only the e above.
constexpr float kTieFloor = 1.0f - 1.0f / 4194304.0f;  // 1 - 2^-22

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// Scanning indices upward: take v at index k if it beats the running (best, arg).
// A strictly larger value or the first NaN wins; an unset arg (INT_MAX) takes any value.
__device__ __forceinline__ void take(float v, int k, float& best, int& arg) {
  if (best != best) return;  // a NaN is kept: the first one wins
  if (v != v || v > best || arg == INT_MAX) {
    best = v;
    arg = k;
  }
}

// Does (a, ia) beat (b, ib)? NaN over numbers, then the larger value, then the lower index.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_argmax(float& best, int& arg) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, offset);
    const int oa = __shfl_xor_sync(kFull, arg, offset);
    if (beats(ob, oa, best, arg)) {
      best = ob;
      arg = oa;
    }
  }
}

// Butterfly sum: addition commutes, so every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(kFull, v, offset);
  return v;
}

// JAX's clip(floor(conf * n_bins).astype(int32), 0, n_bins): NaN -> 0, +inf -> n_bins.
__device__ __forceinline__ int bin_of(float conf, int n_bins) {
  const float f = floorf(conf * static_cast<float>(n_bins));
  if (!(f >= 0.0f)) return 0;
  if (f >= static_cast<float>(n_bins)) return n_bins;
  return static_cast<int>(f);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// conf in [0, 1] (only a discarded variant lies outside) as 32.32 fixed point.
__device__ __forceinline__ unsigned long long fixed_of(float conf) {
  return __float2ull_rn(fminf(fmaxf(conf, 0.0f), 1.0f) * kFixedScale);
}

// *p += v for a 64-bit sum in shared memory by two 32-bit atomics (a 64-bit
// shared atomic is a compare-and-swap loop, which contended lanes repeat):
// the low word's wrap, seen in the value it returns, carries into the high word.
__device__ __forceinline__ void add_fixed(unsigned long long* p, unsigned long long v) {
  unsigned* word = reinterpret_cast<unsigned*>(p);  // little-endian: the low word first
  const unsigned lo = static_cast<unsigned>(v);
  const unsigned carry = atomicAdd(word, lo) > 0xffffffffu - lo ? 1u : 0u;
  const unsigned hi = static_cast<unsigned>(v >> 32) + carry;
  if (hi) atomicAdd(word + 1, hi);
}

// The integer words of a histogram pair after its 2 x nb fixed-point confidence
// sums: acc[2][nb], count[2][nb], nan[2], outside, ticket (used in global memory only).
__host__ __device__ constexpr int int_words(int nb) { return 4 * nb + 4; }

struct Args {
  const void* preds;
  const void* target;
  const float* old_conf;
  const int* old_acc;
  const int* old_count;
  float* new_conf;
  int* new_acc;
  int* new_count;
  unsigned long long* sum_conf;  // the stream's accumulator, [2][nb]; zero when a launch starts and ends
  int* sum_int;                  // [int_words(nb)]; the same
  long long n_rows;  // rows of C scores, or scores in binary mode
  int n_scores, n_bins, nb;
  bool has_ignore, vec;
  long long ignore;
};

// A histogram pair: variant 0 bins the raw scores, variant 1 the normalized ones.
struct Hist {
  unsigned long long* conf;  // [2][nb]
  int* acc;                  // [2][nb], then count [2][nb], nan [2], outside, ticket
  int* count;
  int* nan;
  int* outside;
  int* ticket;
};

__device__ __forceinline__ Hist hist_at(unsigned long long* conf, int* ints, int nb) {
  Hist h;
  h.conf = conf;
  h.acc = ints;
  h.count = ints + 2 * nb;
  h.nan = ints + 4 * nb;
  h.outside = h.nan + 2;
  h.ticket = h.outside + 1;
  return h;
}

__device__ __forceinline__ Hist open_hist(const Args& a, unsigned char* smem) {
  unsigned long long* conf = reinterpret_cast<unsigned long long*>(smem);
  int* ints = reinterpret_cast<int*>(conf + 2 * a.nb);
  for (int i = threadIdx.x; i < 2 * a.nb; i += blockDim.x) conf[i] = 0ull;
  for (int i = threadIdx.x; i < int_words(a.nb); i += blockDim.x) ints[i] = 0;
  __syncthreads();
  return hist_at(conf, ints, a.nb);
}

// One row's (or score's) contribution to one variant: conf * w into conf_sum
// (a NaN confidence adds NaN to bin 0 even when w == 0, as conf * 0 does in
// JAX), acc * w into acc_sum, w into count.
__device__ __forceinline__ void add_row(const Hist& h, int variant, int nb, int n_bins, float conf, int acc, bool w) {
  const int bin = bin_of(conf, n_bins);
  if (conf != conf) {
    atomicAdd(h.nan + variant, 1);
  } else if (w) {
    add_fixed(h.conf + variant * nb + bin, fixed_of(conf));
  }
  if (w) {
    atomicAdd(h.count + variant * nb + bin, 1);
    if (acc != 0) atomicAdd(h.acc + variant * nb + bin, acc);
  }
}

template <typename U>
__device__ __forceinline__ void target_of(const Args& a, long long r, int& t, bool& w) {
  const int t32 = static_cast<int>(static_cast<const U*>(a.target)[r]);  // an int64 label counts as its low 32 bits
  w = !(a.has_ignore && static_cast<long long>(t32) == a.ignore);
  t = w ? t32 : 0;
}

// new = old + the chosen variant's batch sums of one bin; a NaN confidence lies in bin 0.
__device__ __forceinline__ void write_bin(const Args& a, int bin, unsigned long long conf, int acc, int count, int nan) {
  const float batch = nan > 0 ? quiet_nan() : static_cast<float>(static_cast<double>(conf) * kFixedUnit);
  a.new_conf[bin] = a.old_conf[bin] + batch;
  a.new_acc[bin] = static_cast<int>(static_cast<unsigned>(a.old_acc[bin]) + static_cast<unsigned>(acc));
  a.new_count[bin] = static_cast<int>(static_cast<unsigned>(a.old_count[bin]) + static_cast<unsigned>(count));
}

// atomicAdd(p, 1) at device scope with acquire-release order: the adds a barrier
// ordered before it are released with it (release is cumulative), and the block
// that takes the last ticket acquires every earlier block's adds.
__device__ __forceinline__ int ticket_acq_rel(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// The block's histograms into the new state: directly when the grid is one
// block; else added to the stream's accumulator, whose last block writes the
// state and zeroes the accumulator.
__device__ void finish(const Args& a, const Hist& h, bool outside) {
  const int any_out = __syncthreads_or(outside);  // also orders every shared add before the reads
  const int nb = a.nb;
  if (gridDim.x == 1) {
    const int v = any_out ? 1 : 0;  // the whole batch's predicate picks the variant
    for (int bin = threadIdx.x; bin < nb; bin += blockDim.x) {
      write_bin(a, bin, h.conf[v * nb + bin], h.acc[v * nb + bin], h.count[v * nb + bin], bin == 0 ? h.nan[v] : 0);
    }
    return;
  }
  const Hist g = hist_at(a.sum_conf, a.sum_int, nb);
  for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) {
    if (h.conf[i]) atomicAdd(g.conf + i, h.conf[i]);
  }
  for (int i = threadIdx.x; i < 4 * nb + 2; i += blockDim.x) {  // acc, count, nan
    if (h.acc[i]) atomicAdd(g.acc + i, h.acc[i]);
  }
  if (threadIdx.x == 0 && any_out) atomicAdd(g.outside, 1);
  __syncthreads();
  int last = 0;
  if (threadIdx.x == 0) last = ticket_acq_rel(g.ticket) == static_cast<int>(gridDim.x) - 1;
  if (!__syncthreads_or(last)) return;
  const int v = __ldcg(g.outside) > 0 ? 1 : 0;
  for (int bin = threadIdx.x; bin < nb; bin += blockDim.x) {
    write_bin(a, bin, __ldcg(g.conf + v * nb + bin), __ldcg(g.acc + v * nb + bin), __ldcg(g.count + v * nb + bin),
              bin == 0 ? __ldcg(g.nan + v) : 0);
  }
  __syncthreads();  // every read of the accumulator is done: zero it (the ticket too) for the next launch
  for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) g.conf[i] = 0ull;
  for (int i = threadIdx.x; i < int_words(nb); i += blockDim.x) g.acc[i] = 0;
}

// The score index of slot u of a lane at place `at` among a row's 32 W lanes, or -1 past the row.
template <int V, int W>
__device__ __forceinline__ int slot_index(int u, int at, int n_scores, bool vec) {
  const int k = vec ? V * (at + 32 * W * (u / V)) + u % V : at + 32 * W * u;
  return k < n_scores ? k : -1;
}

// W warps a row, the row in registers (32 <= C <= 1,024). A block takes kWarps / W
// rows a round; the round's bounds are block-uniform, since the parts meet at barriers.
template <typename T, typename U, int W>
__global__ void __launch_bounds__(kThreads) calib_rows_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_best[kWarps], s_sum[kWarps];
  __shared__ int s_arg[kWarps], s_cand[kWarps];
  const Hist h = open_hist(a, smem);
  constexpr int K = kRowScores / (32 * W);  // scores a lane keeps
  constexpr int V = 16 / sizeof(T);          // scores a 16-byte load
  constexpr int kRows = kWarps / W;
  const T* preds = static_cast<const T*>(a.preds);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = (warp / W) * W;           // the first warp of this warp's row
  const int at = (warp - first) * 32 + lane;  // this lane's place among the row's 32 W lanes
  bool outside = false;
  for (long long r0 = static_cast<long long>(blockIdx.x) * kRows; r0 < a.n_rows;
       r0 += static_cast<long long>(gridDim.x) * kRows) {
    const long long r = r0 + warp / W;
    const int n = r < a.n_rows ? a.n_scores : 0;  // a slot past the last row holds nothing
    const T* row = preds + (r < a.n_rows ? r : 0) * a.n_scores;
    float x[K];
    if (a.vec) {
      const int n_vec = n / V;
#pragma unroll
      for (int j = 0; j < K / V; ++j) {
        if (at + 32 * W * j < n_vec) {
          const float4 raw = reinterpret_cast<const float4*>(row)[at + 32 * W * j];
          const T* chunk = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int q = 0; q < V; ++q) x[j * V + q] = widen(chunk[q]);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < K; ++u) {
        if (at + 32 * W * u < n) x[u] = widen(row[at + 32 * W * u]);
      }
    }
    // pass 1: the raw max and argmax, and the predicate
    float best = neg_inf();
    int arg = INT_MAX;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int k = slot_index<V, W>(u, at, n, a.vec);
      if (k >= 0) {
        outside |= x[u] < 0.0f || x[u] > 1.0f;
        take(x[u], k, best, arg);
      }
    }
    warp_argmax(best, arg);
    if constexpr (W > 1) {
      if (lane == 0) {
        s_best[warp] = best;
        s_arg[warp] = arg;
      }
      __syncthreads();
      best = s_best[first];
      arg = s_arg[first];
#pragma unroll
      for (int p = 1; p < W; ++p) {
        if (beats(s_best[first + p], s_arg[first + p], best, arg)) {
          best = s_best[first + p];
          arg = s_arg[first + p];
        }
      }
    }
    // pass 2: exp(x - max) and its sum, in a fixed order
    float sum = 0.0f;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      if (slot_index<V, W>(u, at, n, a.vec) >= 0) {
        x[u] = expf(x[u] - best);
        sum += x[u];
      }
    }
    sum = warp_sum(sum);
    if constexpr (W > 1) {
      if (lane == 0) s_sum[warp] = sum;
      __syncthreads();
      sum = s_sum[first];
#pragma unroll
      for (int p = 1; p < W; ++p) sum += s_sum[first + p];
    }
    // pass 3: the probabilities' max is 1 / sum; its argmax the lowest index that rounds to it.
    // A NaN sum (a NaN, +inf or all -inf row) makes every probability NaN: argmax 0.
    const float pbest = 1.0f / sum;
    int cand = INT_MAX;
    if (sum == sum) {
#pragma unroll
      for (int u = 0; u < K; ++u) {
        const int k = slot_index<V, W>(u, at, n, a.vec);
        if (k >= 0 && cand == INT_MAX && x[u] >= kTieFloor && (x[u] == 1.0f || x[u] / sum == pbest)) cand = k;
      }
    }
    cand = __reduce_min_sync(kFull, cand);
    if constexpr (W > 1) {
      if (lane == 0) s_cand[warp] = cand;
      __syncthreads();
      cand = s_cand[first];
#pragma unroll
      for (int p = 1; p < W; ++p) cand = min(cand, s_cand[first + p]);
    }
    if (n > 0 && at == 0) {
      int t;
      bool w;
      target_of<U>(a, r, t, w);
      add_row(h, 0, a.nb, a.n_bins, best, arg == t, w);
      add_row(h, 1, a.nb, a.n_bins, pbest, (sum == sum ? cand : 0) == t, w);
    }
  }
  finish(a, h, outside);
}

// A warp a row of more than 1,024 scores: each pass reads the row again (from L2).
template <typename T, typename U>
__global__ void __launch_bounds__(kThreads) calib_rows_long_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Hist h = open_hist(a, smem);
  const T* preds = static_cast<const T*>(a.preds);
  const int lane = threadIdx.x & 31;
  bool outside = false;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); r < a.n_rows;
       r += static_cast<long long>(gridDim.x) * kWarps) {  // warp-uniform
    const T* row = preds + r * a.n_scores;
    float best = neg_inf();
    int arg = INT_MAX;
    for (int k = lane; k < a.n_scores; k += 32) {
      const float v = widen(row[k]);
      outside |= v < 0.0f || v > 1.0f;
      take(v, k, best, arg);
    }
    warp_argmax(best, arg);
    float sum = 0.0f;
    for (int k = lane; k < a.n_scores; k += 32) sum += expf(widen(row[k]) - best);
    sum = warp_sum(sum);
    const float pbest = 1.0f / sum;
    int cand = INT_MAX;
    if (sum == sum) {
      for (int k = lane; k < a.n_scores && cand == INT_MAX; k += 32) {
        if (expf(widen(row[k]) - best) / sum == pbest) cand = k;
      }
    }
    cand = __reduce_min_sync(kFull, cand);
    if (lane == 0) {
      int t;
      bool w;
      target_of<U>(a, r, t, w);
      add_row(h, 0, a.nb, a.n_bins, best, arg == t, w);
      add_row(h, 1, a.nb, a.n_bins, pbest, (sum == sum ? cand : 0) == t, w);
    }
  }
  finish(a, h, outside);
}

// A thread a row of fewer than 32 scores.
template <typename T, typename U>
__global__ void __launch_bounds__(kThreads) calib_rows_short_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Hist h = open_hist(a, smem);
  const T* preds = static_cast<const T*>(a.preds);
  bool outside = false;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; r < a.n_rows;
       r += static_cast<long long>(gridDim.x) * blockDim.x) {
    const T* row = preds + r * a.n_scores;
    float best = neg_inf();
    int arg = INT_MAX;
    for (int k = 0; k < a.n_scores; ++k) {
      const float v = widen(row[k]);
      outside |= v < 0.0f || v > 1.0f;
      take(v, k, best, arg);
    }
    float sum = 0.0f;
    for (int k = 0; k < a.n_scores; ++k) sum += expf(widen(row[k]) - best);
    const float pbest = 1.0f / sum;
    int parg = 0;  // a NaN sum makes every probability NaN: argmax 0; else arg ties, so the scan ends
    if (sum == sum) {
      while (expf(widen(row[parg]) - best) / sum != pbest) ++parg;
    }
    int t;
    bool w;
    target_of<U>(a, r, t, w);
    add_row(h, 0, a.nb, a.n_bins, best, arg == t, w);
    add_row(h, 1, a.nb, a.n_bins, pbest, parg == t, w);
  }
  finish(a, h, outside);
}

// Binary: a thread a score, kItems loaded before any is binned; the confidence is the
// score or its sigmoid, the accuracy the target. The bounds are block-uniform. A single
// block that holds the whole batch in one round knows the batch's predicate before it
// bins, and bins the chosen variant only.
template <typename T, typename U>
__global__ void __launch_bounds__(kThreads) calib_binary_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Hist h = open_hist(a, smem);
  const T* preds = static_cast<const T*>(a.preds);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const bool whole = gridDim.x == 1 && a.n_rows <= kItems * static_cast<long long>(blockDim.x);
  bool outside = false;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x; base < a.n_rows; base += kItems * stride) {
    float x[kItems];
    int t[kItems];
    bool w[kItems];
    bool live[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long e = base + j * stride + threadIdx.x;
      live[j] = e < a.n_rows;
      x[j] = 0.0f;
      t[j] = 0;
      w[j] = false;
      if (live[j]) {
        x[j] = widen(preds[e]);
        target_of<U>(a, e, t[j], w[j]);
        outside |= x[j] < 0.0f || x[j] > 1.0f;
      }
    }
    const int pick = whole ? (__syncthreads_or(outside) ? 1 : 0) : -1;  // -1: bin both
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (live[j]) {
        if (pick != 1) add_row(h, 0, a.nb, a.n_bins, x[j], t[j], w[j]);
        if (pick != 0) add_row(h, 1, a.nb, a.n_bins, sigmoid(x[j]), t[j], w[j]);
      }
    }
  }
  finish(a, h, outside);
}

template <typename T, typename U>
cudaError_t launch_typed(int mode, int warps_per_row, const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.nb) * 2 * sizeof(unsigned long long) +
                      static_cast<size_t>(int_words(a.nb)) * sizeof(int);
  switch (mode * 8 + (mode == 0 ? warps_per_row : 1)) {
    case 1: calib_rows_kernel<T, U, 1><<<blocks, kThreads, smem, stream>>>(a); break;
    case 2: calib_rows_kernel<T, U, 2><<<blocks, kThreads, smem, stream>>>(a); break;
    case 4: calib_rows_kernel<T, U, 4><<<blocks, kThreads, smem, stream>>>(a); break;
    case 9: calib_rows_long_kernel<T, U><<<blocks, kThreads, smem, stream>>>(a); break;
    case 17: calib_rows_short_kernel<T, U><<<blocks, kThreads, smem, stream>>>(a); break;
    case 25: calib_binary_kernel<T, U><<<blocks, kThreads, smem, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_target(int pred_kind, int mode, int warps_per_row, const Args& a, int blocks, cudaStream_t stream) {
  switch (pred_kind) {
    case 0: return launch_typed<float, U>(mode, warps_per_row, a, blocks, stream);
    case 1: return launch_typed<__half, U>(mode, warps_per_row, a, blocks, stream);
    case 2: return launch_typed<__nv_bfloat16, U>(mode, warps_per_row, a, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// pred_kind: 0 float32, 1 float16, 2 bfloat16; target_kind: 0 int32, 1 int64.
// mode: 0 warps_per_row (1, 2 or 4) warps a row in registers (32 <= C <= 1024),
// 1 a warp a longer row, 2 a thread a row (C < 32), 3 binary (a thread a score).
// sum_conf holds 2 x (n_bins + 1) uint64 and sum_int 4 x (n_bins + 1) + 4 int32,
// all zero before a launch of more than one block and zero again after it.
extern "C" int calibration_bins_launch(const void* preds, int pred_kind, const void* target, int target_kind,
                                       long long n_rows, int n_scores, int n_bins, int has_ignore,
                                       long long ignore_index, const void* old_conf, const void* old_acc,
                                       const void* old_count, void* new_conf, void* new_acc, void* new_count,
                                       void* sum_conf, void* sum_int, int mode, int warps_per_row, int blocks,
                                       void* stream_ptr) {
  Args a;
  a.preds = preds;
  a.target = target;
  a.old_conf = static_cast<const float*>(old_conf);
  a.old_acc = static_cast<const int*>(old_acc);
  a.old_count = static_cast<const int*>(old_count);
  a.new_conf = static_cast<float*>(new_conf);
  a.new_acc = static_cast<int*>(new_acc);
  a.new_count = static_cast<int*>(new_count);
  a.sum_conf = static_cast<unsigned long long*>(sum_conf);
  a.sum_int = static_cast<int*>(sum_int);
  a.n_rows = n_rows;
  a.n_scores = n_scores;
  a.n_bins = n_bins;
  a.nb = n_bins + 1;
  a.has_ignore = has_ignore != 0;
  a.ignore = ignore_index;
  const int elem_bytes = pred_kind == 0 ? 4 : 2;
  a.vec = mode == 0 && reinterpret_cast<uintptr_t>(preds) % 16 == 0 &&
          (static_cast<long long>(n_scores) * elem_bytes) % 16 == 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = target_kind == 0 ? launch_target<int>(pred_kind, mode, warps_per_row, a, blocks, stream)
                                           : launch_target<long long>(pred_kind, mode, warps_per_row, a, blocks, stream);
  return static_cast<int>(err);
}
