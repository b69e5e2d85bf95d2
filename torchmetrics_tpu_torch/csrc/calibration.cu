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
// ways (raw and normalized) into two histograms; each block ORs whether any
// of its scores lies outside [0, 1]; the last block to finish (a ticket) ORs
// the blocks' flags, sums the chosen histogram over the blocks and writes the
// new state. One launch a batch, no host read.
//
// Bound on the card: the update must read the scores once and the targets
// once, and read and write the 3 (n_bins + 1) state values. At ImageNet-1k's
// batch (1,024 x 1,000 float32, int64 targets, n_bins = 15) that is 4.1 MB:
// 1.23 us at 3.35 TB/s (H100 SXM data sheet, 700 W). The softmax takes about
// 4 float operations a score (4.1 M): 0.06 us at 67 TFLOP/s; bytes bind.
//
// What the design does about it:
// - a warp a row for C >= 32: up to 1,024 scores a row stay in registers (32
//   a lane, read in 16-byte loads where the row is 16-byte aligned), so the
//   max, the sum of exponentials and the argmax of the probabilities are three
//   passes over registers and one read of device memory; longer rows are read
//   again from L2 in each pass. Rows of fewer than 32 scores take a thread a
//   row; binary scores a thread each;
// - histograms in shared memory with integer atomics (2 x (n_bins + 1) x
//   (8 + 4 + 4) bytes: n_bins <= 1023 fits in 32 KB);
// - the last block merges the blocks' partial histograms, a warp a bin, the
//   lanes striding the blocks, and resets the ticket for the next launch on
//   the stream (one ticket a stream, made zero by the launcher once).
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
constexpr int kCached = 32;  // scores a lane keeps in registers: rows of up to 1,024 scores
constexpr float kFixedScale = 4294967296.0f;  // 2^32
constexpr double kFixedUnit = 1.0 / 4294967296.0;

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

struct Args {
  const void* preds;
  const void* target;
  const float* old_conf;
  const int* old_acc;
  const int* old_count;
  float* new_conf;
  int* new_acc;
  int* new_count;
  unsigned long long* conf_part;  // [blocks][2][nb]
  int* int_part;                  // [blocks][int_words]: acc[2][nb], count[2][nb], nan[2], outside
  unsigned int* ticket;
  long long n_rows;  // rows of C scores, or scores in binary mode
  int n_scores, n_bins, nb, int_words;
  bool has_ignore, vec;
  long long ignore;
};

// The block's two histograms in shared memory: variant 0 the raw scores, 1 the normalized ones.
struct Hist {
  unsigned long long* conf;  // [2][nb]
  int* acc;                  // [2][nb]
  int* count;                // [2][nb]
  int* nan;                  // [2]
};

__device__ __forceinline__ Hist open_hist(const Args& a, unsigned char* smem) {
  Hist h;
  h.conf = reinterpret_cast<unsigned long long*>(smem);
  h.acc = reinterpret_cast<int*>(h.conf + 2 * a.nb);
  h.count = h.acc + 2 * a.nb;
  h.nan = h.count + 2 * a.nb;
  for (int i = threadIdx.x; i < 2 * a.nb; i += blockDim.x) h.conf[i] = 0ull;
  for (int i = threadIdx.x; i < a.int_words - 1; i += blockDim.x) h.acc[i] = 0;
  __syncthreads();
  return h;
}

// One row's (or score's) contribution to one variant: conf * w into conf_sum
// (a NaN confidence adds NaN to bin 0 even when w == 0, as conf * 0 does in
// JAX), acc * w into acc_sum, w into count.
__device__ __forceinline__ void add_row(const Hist& h, int variant, int nb, int n_bins, float conf, int acc, bool w) {
  const int bin = bin_of(conf, n_bins);
  if (conf != conf) {
    atomicAdd(h.nan + variant, 1);
  } else if (w) {
    const float clamped = fminf(fmaxf(conf, 0.0f), 1.0f);  // only a discarded variant lies outside
    atomicAdd(h.conf + variant * nb + bin, __float2ull_rn(clamped * kFixedScale));
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

// Write the block's histograms, take a ticket, and let the last block merge.
__device__ void close_and_merge(const Args& a, const Hist& h, bool outside) {
  const int any_out = __syncthreads_or(outside);  // also orders every shared add before the copy
  unsigned long long* cp = a.conf_part + static_cast<long long>(blockIdx.x) * 2 * a.nb;
  int* ip = a.int_part + static_cast<long long>(blockIdx.x) * a.int_words;
  for (int i = threadIdx.x; i < 2 * a.nb; i += blockDim.x) cp[i] = h.conf[i];
  for (int i = threadIdx.x; i < a.int_words - 1; i += blockDim.x) ip[i] = h.acc[i];
  if (threadIdx.x == 0) ip[a.int_words - 1] = any_out;
  __threadfence();
  __syncthreads();
  int last = 0;
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  if (!__syncthreads_or(last)) return;
  __threadfence();

  int out = 0;
  for (int b = threadIdx.x; b < gridDim.x; b += blockDim.x) out |= __ldcg(a.int_part + static_cast<long long>(b) * a.int_words + a.int_words - 1);
  const int v = __syncthreads_or(out) ? 1 : 0;  // the whole batch's predicate picks the variant

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int bin = warp; bin < a.nb; bin += warps) {  // warp-uniform
    unsigned long long conf = 0;
    int acc = 0, count = 0, nan = 0;
    for (int b = lane; b < gridDim.x; b += 32) {
      const long long ib = static_cast<long long>(b) * a.int_words;
      conf += __ldcg(a.conf_part + static_cast<long long>(b) * 2 * a.nb + v * a.nb + bin);
      acc += __ldcg(a.int_part + ib + v * a.nb + bin);
      count += __ldcg(a.int_part + ib + 2 * a.nb + v * a.nb + bin);
      if (bin == 0) nan += __ldcg(a.int_part + ib + 4 * a.nb + v);
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      conf += __shfl_xor_sync(kFull, conf, offset);
      acc += __shfl_xor_sync(kFull, acc, offset);
      count += __shfl_xor_sync(kFull, count, offset);
      nan += __shfl_xor_sync(kFull, nan, offset);
    }
    if (lane == 0) {
      const float batch = nan > 0 ? quiet_nan() : static_cast<float>(static_cast<double>(conf) * kFixedUnit);
      a.new_conf[bin] = a.old_conf[bin] + batch;
      a.new_acc[bin] = static_cast<int>(static_cast<unsigned>(a.old_acc[bin]) + static_cast<unsigned>(acc));
      a.new_count[bin] = static_cast<int>(static_cast<unsigned>(a.old_count[bin]) + static_cast<unsigned>(count));
    }
  }
  if (threadIdx.x == 0) *a.ticket = 0u;  // every block has taken its ticket
}

// The slot u of a lane's cached share of a row: the score index, or -1 past the row.
template <int V>
__device__ __forceinline__ int slot_index(int u, int lane, int n_scores, bool vec) {
  const int k = vec ? V * (lane + 32 * (u / V)) + u % V : lane + 32 * u;
  return k < n_scores ? k : -1;
}

// A warp a row, the row in registers (C <= 1,024).
template <typename T, typename U>
__global__ void __launch_bounds__(kThreads) calib_rows_cached_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Hist h = open_hist(a, smem);
  constexpr int V = 16 / sizeof(T);  // scores a 16-byte load
  const T* preds = static_cast<const T*>(a.preds);
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  bool outside = false;
  for (long long r = static_cast<long long>(blockIdx.x) * warps + (threadIdx.x >> 5); r < a.n_rows;
       r += static_cast<long long>(gridDim.x) * warps) {  // warp-uniform
    const T* row = preds + r * a.n_scores;
    float x[kCached];
    if (a.vec) {
      const int n_vec = a.n_scores / V;
#pragma unroll
      for (int j = 0; j < kCached / V; ++j) {
        if (lane + 32 * j < n_vec) {
          const float4 raw = reinterpret_cast<const float4*>(row)[lane + 32 * j];
          const T* chunk = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int q = 0; q < V; ++q) x[j * V + q] = widen(chunk[q]);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kCached; ++u) {
        if (lane + 32 * u < a.n_scores) x[u] = widen(row[lane + 32 * u]);
      }
    }
    // pass 1: the raw max and argmax, and the predicate
    float best = neg_inf();
    int arg = INT_MAX;
#pragma unroll
    for (int u = 0; u < kCached; ++u) {
      const int k = slot_index<V>(u, lane, a.n_scores, a.vec);
      if (k >= 0) {
        outside |= x[u] < 0.0f || x[u] > 1.0f;
        take(x[u], k, best, arg);
      }
    }
    warp_argmax(best, arg);
    // pass 2: exp(x - max) and its sum
    float sum = 0.0f;
#pragma unroll
    for (int u = 0; u < kCached; ++u) {
      if (slot_index<V>(u, lane, a.n_scores, a.vec) >= 0) {
        x[u] = expf(x[u] - best);
        sum += x[u];
      }
    }
    sum = warp_sum(sum);
    // pass 3: the probabilities' max and argmax
    float pbest = neg_inf();
    int parg = INT_MAX;
#pragma unroll
    for (int u = 0; u < kCached; ++u) {
      const int k = slot_index<V>(u, lane, a.n_scores, a.vec);
      if (k >= 0) take(x[u] / sum, k, pbest, parg);
    }
    warp_argmax(pbest, parg);
    if (lane == 0) {
      int t;
      bool w;
      target_of<U>(a, r, t, w);
      add_row(h, 0, a.nb, a.n_bins, best, arg == t, w);
      add_row(h, 1, a.nb, a.n_bins, pbest, parg == t, w);
    }
  }
  close_and_merge(a, h, outside);
}

// A warp a row of more than 1,024 scores: each pass reads the row again (from L2).
template <typename T, typename U>
__global__ void __launch_bounds__(kThreads) calib_rows_long_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Hist h = open_hist(a, smem);
  const T* preds = static_cast<const T*>(a.preds);
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  bool outside = false;
  for (long long r = static_cast<long long>(blockIdx.x) * warps + (threadIdx.x >> 5); r < a.n_rows;
       r += static_cast<long long>(gridDim.x) * warps) {  // warp-uniform
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
    float pbest = neg_inf();
    int parg = INT_MAX;
    for (int k = lane; k < a.n_scores; k += 32) take(expf(widen(row[k]) - best) / sum, k, pbest, parg);
    warp_argmax(pbest, parg);
    if (lane == 0) {
      int t;
      bool w;
      target_of<U>(a, r, t, w);
      add_row(h, 0, a.nb, a.n_bins, best, arg == t, w);
      add_row(h, 1, a.nb, a.n_bins, pbest, parg == t, w);
    }
  }
  close_and_merge(a, h, outside);
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
    float pbest = neg_inf();
    int parg = INT_MAX;
    for (int k = 0; k < a.n_scores; ++k) take(expf(widen(row[k]) - best) / sum, k, pbest, parg);
    int t;
    bool w;
    target_of<U>(a, r, t, w);
    add_row(h, 0, a.nb, a.n_bins, best, arg == t, w);
    add_row(h, 1, a.nb, a.n_bins, pbest, parg == t, w);
  }
  close_and_merge(a, h, outside);
}

// Binary: a thread a score; the confidence is the score or its sigmoid, the accuracy the target.
template <typename T, typename U>
__global__ void __launch_bounds__(kThreads) calib_binary_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Hist h = open_hist(a, smem);
  const T* preds = static_cast<const T*>(a.preds);
  bool outside = false;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < a.n_rows;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float x = widen(preds[e]);
    outside |= x < 0.0f || x > 1.0f;
    int t;
    bool w;
    target_of<U>(a, e, t, w);
    add_row(h, 0, a.nb, a.n_bins, x, t, w);
    add_row(h, 1, a.nb, a.n_bins, sigmoid(x), t, w);
  }
  close_and_merge(a, h, outside);
}

template <typename T, typename U>
cudaError_t launch_typed(int mode, const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.nb) * 2 * sizeof(unsigned long long) + static_cast<size_t>(a.int_words - 1) * sizeof(int);
  switch (mode) {
    case 0: calib_rows_cached_kernel<T, U><<<blocks, kThreads, smem, stream>>>(a); break;
    case 1: calib_rows_long_kernel<T, U><<<blocks, kThreads, smem, stream>>>(a); break;
    case 2: calib_rows_short_kernel<T, U><<<blocks, kThreads, smem, stream>>>(a); break;
    case 3: calib_binary_kernel<T, U><<<blocks, kThreads, smem, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_target(int pred_kind, int mode, const Args& a, int blocks, cudaStream_t stream) {
  switch (pred_kind) {
    case 0: return launch_typed<float, U>(mode, a, blocks, stream);
    case 1: return launch_typed<__half, U>(mode, a, blocks, stream);
    case 2: return launch_typed<__nv_bfloat16, U>(mode, a, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// pred_kind: 0 float32, 1 float16, 2 bfloat16; target_kind: 0 int32, 1 int64.
// mode: 0 a warp a row in registers (32 <= C <= 1024), 1 a warp a longer row,
// 2 a thread a row (C < 32), 3 binary (a thread a score). conf_part holds
// blocks * 2 * (n_bins + 1) uint64, int_part blocks * (4 * (n_bins + 1) + 3)
// int32; ticket is zero before the launch and is zero again after it.
extern "C" int calibration_bins_launch(const void* preds, int pred_kind, const void* target, int target_kind,
                                       long long n_rows, int n_scores, int n_bins, int has_ignore,
                                       long long ignore_index, const void* old_conf, const void* old_acc,
                                       const void* old_count, void* new_conf, void* new_acc, void* new_count,
                                       void* conf_part, void* int_part, void* ticket, int mode, int blocks,
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
  a.conf_part = static_cast<unsigned long long*>(conf_part);
  a.int_part = static_cast<int*>(int_part);
  a.ticket = static_cast<unsigned int*>(ticket);
  a.n_rows = n_rows;
  a.n_scores = n_scores;
  a.n_bins = n_bins;
  a.nb = n_bins + 1;
  a.int_words = 4 * a.nb + 3;
  a.has_ignore = has_ignore != 0;
  a.ignore = ignore_index;
  const int elem_bytes = pred_kind == 0 ? 4 : 2;
  a.vec = mode == 0 && reinterpret_cast<uintptr_t>(preds) % 16 == 0 &&
          (static_cast<long long>(n_scores) * elem_bytes) % 16 == 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = target_kind == 0 ? launch_target<int>(pred_kind, mode, a, blocks, stream)
                                           : launch_target<long long>(pred_kind, mode, a, blocks, stream);
  return static_cast<int>(err);
}
