// Curve-sketch insert: one batch of scores folded into the (negative, positive)
// histogram pair of the curve family's approx="sketch" state, in place.
//
// Replaces `_CurveBase._sketch_insert` and `QuantileSketch.insert_batch` of the
// JAX package (torchmetrics_tpu/classification/precision_recall_curve.py:110-119,
// torchmetrics_tpu/sketches/quantile.py:117-132): a one-hot of the targets, a
// broadcast of the scores to (N, K, 2), a stack of the (neg, pos) weights and a
// float scatter-add over N x K x 2 entries. Here, for scores viewed as (N, K)
// (K = 1 for the binary task), with 0/1 weights w:
//
//   cell(v) = clip(floor((v - lo) * scale), 0, bins) in float32, NaN -> 0
//   multiclass (int targets t (N,), weights (N,)):
//     hist[k, t == k, cell(scores[n, k])] += 1       where w[n] != 0
//   binary / multilabel (targets and weights (N, K)):
//     hist[k, 0, cell] += 1 - t, hist[k, 1, cell] += t  where w[n, k] != 0
//     (JAX's neg = w - t w, pos = t w at w = 1; a 0/1 target is one add)
//
// Exactness. Each block counts its entries in int32 in shared memory, then adds
// every non-zero count into the float32 state with one atomicAdd. All these
// values are integers: a float32 sum of integers is exact while every partial
// sum stays below 2^24 in magnitude, so the order of the atomics cannot change
// the result, which is the same from launch to launch and equal to the plain
// version's (JAX's float32 scatter-add of 0/1 weights has the same 2^24 bound
// a cell). The caller passes 0/1 weights only: the curve formats make them so,
// and any other weight takes the plain version (the dispatch in
// `classification/precision_recall_curve.py`).
//
// Layout. Blocks over (class slices, row chunks): a block counts `slice`
// consecutive classes of `rows_per_chunk` rows in a (slice, 2, cells) int32
// histogram of shared memory (cells = bins + 1; 48 KB holds 6,144 cells a
// class). Its threads walk the (row, class) entries of the chunk in order, so a
// warp reads consecutive scores, and each thread loads kUnroll entries before it
// counts any: the atomics would otherwise hold every load back, one DRAM latency
// an entry (`tools/kernel_ablation.py --sections quantile_hist` times kUnroll 1
// to 16). Warp-aggregated atomics (__match_any_sync, __reduce_add_sync) were
// slower than one atomic a lane at every case tried.
// Past 6,144 cells the counts go straight to the state with float atomics
// (exact for the same reason).
//
// Device work of one call, on the caller's stream: one kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // entries a thread loads before it counts any
constexpr int kSharedBytes = 48 * 1024;  // the default dynamic shared memory

struct Args {
  const float* scores;   // (N, K) row-major
  const int* target;     // multiclass (N,), else (N, K)
  const float* weights;  // multiclass (N,), else (N, K)
  float* hist;           // (K, 2, cells), added into in place
  long long n_rows;
  int k;
  int cells;
  int bins;
  float lo;
  float scale;
  int multiclass;
  int slice;
  long long rows_per_chunk;
};

// JAX's cell_index: floor((v - lo) * scale) in float32 (no fused multiply-add), clipped to [0, bins]; NaN fails
// both comparisons and lands in cell 0, +inf in cell bins.
__device__ __forceinline__ int cell_of(float v, float lo, float scale, int bins) {
  const float f = floorf(__fmul_rn(__fsub_rn(v, lo), scale));
  if (f >= static_cast<float>(bins)) return bins;
  return f > 0.0f ? static_cast<int>(f) : 0;
}

template <bool Shared>
__global__ void __launch_bounds__(kThreads) quantile_hist_kernel(Args a) {
  extern __shared__ int counts[];  // (slice, 2, cells) when Shared
  const int c0 = blockIdx.x * a.slice;
  const int kc = min(a.slice, a.k - c0);
  const int n_counts = kc * 2 * a.cells;
  if (Shared) {
    for (int i = threadIdx.x; i < n_counts; i += kThreads) counts[i] = 0;
    __syncthreads();
  }
  const long long r0 = static_cast<long long>(blockIdx.y) * a.rows_per_chunk;
  const long long r1 = min(a.n_rows, r0 + a.rows_per_chunk);
  const int n_entries = static_cast<int>((r1 - r0) * kc);  // the plan keeps a block's entries within int32
  for (int base = threadIdx.x; base < n_entries; base += kThreads * kUnroll) {
    float sc[kUnroll], ww[kUnroll];
    int tt[kUnroll], jj[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load of the group first, so that their latencies overlap
      const int e = base + u * kThreads;
      ww[u] = 0.0f;
      if (e < n_entries) {
        const int rr = e / kc;
        const long long r = r0 + rr;
        const int j = e - rr * kc;
        const long long at = r * a.k + c0 + j;
        ww[u] = a.multiclass ? a.weights[r] : a.weights[at];
        sc[u] = a.scores[at];
        tt[u] = a.multiclass ? a.target[r] : a.target[at];
        jj[u] = j;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (ww[u] == 0.0f) continue;
      const int cell = cell_of(sc[u], a.lo, a.scale, a.bins);
      const int j = jj[u];
      const long long slot = static_cast<long long>(j) * 2 * a.cells + cell;  // the negative side's cell
      int add_neg, add_pos;
      if (a.multiclass) {
        const bool pos = tt[u] == c0 + j;
        add_neg = pos ? 0 : 1;
        add_pos = pos ? 1 : 0;
      } else {
        add_neg = 1 - tt[u];
        add_pos = tt[u];
      }
      if (Shared) {
        if (add_neg) atomicAdd(counts + slot, add_neg);
        if (add_pos) atomicAdd(counts + slot + a.cells, add_pos);
      } else {
        float* out = a.hist + static_cast<long long>(c0) * 2 * a.cells + slot;
        if (add_neg) atomicAdd(out, static_cast<float>(add_neg));
        if (add_pos) atomicAdd(out + a.cells, static_cast<float>(add_pos));
      }
    }
  }
  if (Shared) {
    __syncthreads();
    float* out = a.hist + static_cast<long long>(c0) * 2 * a.cells;
    for (int i = threadIdx.x; i < n_counts; i += kThreads) {
      const int v = counts[i];
      if (v != 0) atomicAdd(out + i, static_cast<float>(v));
    }
  }
}

}  // namespace

extern "C" int quantile_hist_launch(const void* scores, const void* target, const void* weights, void* hist,
                                    long long n_rows, int k, int bins, float lo, float scale, int multiclass,
                                    int slice, long long rows_per_chunk, int chunks, int shared, void* stream_ptr) {
  if (n_rows < 1 || k < 1 || bins < 1 || slice < 1 || chunks < 1 || chunks > 65535 || rows_per_chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.scores = static_cast<const float*>(scores);
  a.target = static_cast<const int*>(target);
  a.weights = static_cast<const float*>(weights);
  a.hist = static_cast<float*>(hist);
  a.n_rows = n_rows;
  a.k = k;
  a.cells = bins + 1;
  a.bins = bins;
  a.lo = lo;
  a.scale = scale;
  a.multiclass = multiclass;
  a.slice = slice;
  a.rows_per_chunk = rows_per_chunk;
  const dim3 grid((k + slice - 1) / slice, chunks);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (shared) {
    const size_t bytes = static_cast<size_t>(slice) * 2 * a.cells * sizeof(int);
    if (bytes > static_cast<size_t>(kSharedBytes)) return static_cast<int>(cudaErrorInvalidValue);
    quantile_hist_kernel<true><<<grid, kThreads, bytes, stream>>>(a);
  } else {
    quantile_hist_kernel<false><<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
