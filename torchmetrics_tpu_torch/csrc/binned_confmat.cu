// Binned one-vs-rest threshold counts for multiclass curves (AUROC, PR curve,
// ROC), fused with the state update: old (T, C, 2, 2) int32 state + one
// formatted batch -> new state.
//
// Replaces the XLA-lowered JAX function `_binned_confmat_multiclass`
// (torchmetrics_tpu/functional/classification/precision_recall_curve.py:128-149)
// and the int32 accumulation after it
// (torchmetrics_tpu/classification/precision_recall_curve.py:130). For every
// threshold t and class c:
//
//   pospred[t, c] = sum_n w[n] * [p[n, c] >= thr[t]]
//   tp[t, c]      = sum_n w[n] * [target[n] == c] * [p[n, c] >= thr[t]]
//   actpos[c]     = sum_n w[n] * [target[n] == c],   total = sum_n w[n]
//   new[t, c]     = old[t, c] + [[total - pospred - fn, pospred - tp], [fn, tp]],  fn = actpos - tp
//
// Bin once, then suffix-sum. Whether p >= thr[t] depends only on where p
// falls among the sorted thresholds: with k = #{j : sorted[j] <= p}, p passes
// the threshold at sorted position r iff k > r. So each score is binned once
// (a binary search over the sorted thresholds in shared memory, ceil(log2(T+1))
// compares) into a per-class histogram hpos[k][c]; only the true-class score
// of a row also goes into htp[k][c] (N entries, not N*C). Then
// pospred(r) = sum_{k > r} hpos[k] and tp(r) = sum_{k > r} htp[k], and the
// epilogue writes old + counts at each threshold's original index. The work
// per score is nearly independent of T. Exact for thresholds in any order,
// with duplicates, +-inf and NaN: NaN thresholds sort last, `sorted[j] <= p`
// is false for them, so they pass nothing; a NaN score lands in bin 0 and
// passes nothing; a -inf score passes only -inf thresholds.
//
// Bound on the card: the update must read probs once (N*C*4 bytes) plus
// target, weights, thresholds and their order, read the old state and write
// the new one (T*C*16 bytes each). At N=1024, C=1000, T=20 that is 4.7 MB:
// 1.4 us at 3.35 TB/s (H100 SXM data sheet, 700 W). The N*C*ceil(log2(T+1))
// compares (5.1 M at T=20) take 0.08 us at 67 TFLOP/s, so bytes bind, and at
// T=200 too (10.5 MB, 3.1 us), where the state is larger than probs.
//
// What the design does about it:
// - probs are read in 16-byte loads (float4) along a row when C % 4 == 0 and
//   the base is 16-byte aligned, else in 4-byte loads with neighbouring lanes
//   on neighbouring columns; each thread starts the loads of 4 rows before it
//   uses any of them, so every SM keeps many loads in flight;
// - the 16 binary searches of a thread (4 rows x 4 columns) advance together,
//   so their shared-memory loads overlap;
// - counts are int32 histograms in shared memory (shared atomics; the slot of
//   lane l, column j sits at (j * lanes + l) * odd_stride, so a warp's adds
//   fall on 32 banks); a block flushes its non-zero bins to the global
//   histogram with int32 atomics. Integer sums are exact in any order, so the
//   result is deterministic;
// - the bins of a class tile take (T+1) * tile_c * 4 bytes; the launcher
//   picks tile_c from T (128, 64 or 32 classes) and, where even 32 classes
//   cannot hold T+1 bins, splits the bins into ranges over grid.z: a block
//   keeps only the bins of its range and the global histogram holds them all;
// - the grid is sized to at least 2 blocks per SM by cutting rows into chunks;
// - the histogram kernel also sums its bins by epilogue segment, so an
//   epilogue block reads one sum per segment above its own, not every bin;
// - the epilogue gives 32 classes to a block, one per lane, and splits the
//   bins among its 8 warps: each warp sums its bins, the block exchanges the
//   sums in shared memory, and each warp walks its bins downward writing
//   old + counts with 16-byte loads and stores, coalesced along C. It is
//   launched with programmatic dependent launch: it loads the old state while
//   the histogram kernel still runs, and waits for it only before the counts.
//
// Device work of one update, all on the caller's stream: a memset of the
// scratch, the histogram kernel and the epilogue kernel.
//
// The per-label update (multilabel and binary curves) is a design of its own,
// one kernel a call: csrc/binned_multilabel.cu.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;   // histogram kernel: 8 warps
constexpr int kRowsUnroll = 4;  // rows whose loads a thread starts before using any
constexpr int kEpiWarps = 8;    // epilogue: warps sharing the bins of 32 classes
constexpr int kEpiGroup = 4;    // old state cells an epilogue thread loads together

// Programmatic dependent launch: a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// kernel before it still runs; it waits here before it touches what that
// kernel writes. After the wait, all of that kernel's memory operations are
// visible. Without the attribute both are no-ops.
__device__ __forceinline__ void wait_for_previous_kernel() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void let_next_kernel_start() { asm volatile("griddepcontrol.launch_dependents;"); }

// the column of a thread's j-th value: 4 neighbouring columns a lane with 16-byte
// loads, else neighbouring lanes on neighbouring columns
template <bool kVec>
__device__ __forceinline__ int column_of(int c0, int lane, int lanes, int j) {
  return c0 + (kVec ? 4 * lane + j : lane + lanes * j);
}

struct Rows {  // the values of kRowsUnroll rows x 4 columns held by one thread, and each row's weight and target
  float v[kRowsUnroll][4];
  int wt[kRowsUnroll];
  int tg[kRowsUnroll];
};

template <bool kVec>
__device__ __forceinline__ void load_rows(Rows& r, const float* __restrict__ probs,
                                          const int* __restrict__ target, const float* __restrict__ weights,
                                          long long base, long long row_end, int rows_per_pass, int n_classes, int c0,
                                          int lane, int lanes) {
#pragma unroll
  for (int u = 0; u < kRowsUnroll; ++u) {
    const long long n = base + u * rows_per_pass;
    const bool row_ok = n < row_end;
    r.wt[u] = row_ok ? static_cast<int>(weights[n]) : 0;
    r.tg[u] = row_ok ? target[n] : -1;
    const float* row = probs + static_cast<size_t>(row_ok ? n : 0) * n_classes + c0;
    if (kVec) {
      const float4 x = row_ok && c0 + 4 * lane < n_classes ? __ldg(reinterpret_cast<const float4*>(row) + lane)
                                                           : make_float4(0.f, 0.f, 0.f, 0.f);
      r.v[u][0] = x.x;
      r.v[u][1] = x.y;
      r.v[u][2] = x.z;
      r.v[u][3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = lane + lanes * j;
        r.v[u][j] = row_ok && c0 + cl < n_classes ? __ldg(row + cl) : 0.f;
      }
    }
  }
}

// Block (x, y, z): classes [x*tile_c, +tile_c), rows [y*rows_per_block, +rows_per_block),
// bins [z*bins_per_range, +bins_per_range). tile_c / 4 lanes cover a row, 4 columns each.
// Adds each kept score's weight to hpos[k][c] and to its segment's sum
// seg_pos[k / seg_bins][c]; blocks of range 0 also add the true-class score to
// htp[k][c] and seg_tp, the row to actpos[c] and, in class tile 0, the row's
// weight to *total.
//
// k = #{j : sorted_thr[j] <= p} by binary lifting over the sorted thresholds
// in shared memory, a NaN after the last: ceil(log2(T+1)) steps.
//
// Launched in stream order, after the memset that zeroes the scratch.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
binned_hist_kernel(const float* __restrict__ probs, const int* __restrict__ target,
                   const float* __restrict__ weights, const float* __restrict__ sorted_thr,
                   int* __restrict__ hpos, int* __restrict__ htp, int* __restrict__ seg_pos,
                   int* __restrict__ seg_tp, int* __restrict__ actpos, int* __restrict__ total,
                   int n_rows, int n_classes, int n_thr, int tile_c, int bins_per_range, int rows_per_block,
                   int seg_bins) {
  extern __shared__ int smem[];
  __shared__ int s_total;
  const int lanes = tile_c / 4;
  const int rows_per_pass = kThreads / lanes;
  const int lane = threadIdx.x % lanes;
  const int c0 = blockIdx.x * tile_c;
  const int bin_lo = blockIdx.z * bins_per_range;
  const int bin_hi = min(bin_lo + bins_per_range, n_thr + 1);
  const int nb = bin_hi - bin_lo;
  const int nb_pad = nb | 1;  // odd: slot rows of neighbouring lanes start on other banks
  int* s_hist = smem;         // (tile_c slots, nb_pad)
  float* s_thr = reinterpret_cast<float*>(s_hist + tile_c * (bins_per_range | 1));  // n_thr + 1, NaN last
  // 64-bit row indices: a chunk may end near 2**31 rows
  const long long row_begin = static_cast<long long>(blockIdx.y) * rows_per_block;
  const long long row_end = min(row_begin + rows_per_block, static_cast<long long>(n_rows));
  const long long stride = static_cast<long long>(rows_per_pass) * kRowsUnroll;
  const bool first_range = blockIdx.z == 0;
  const bool counts_rows = first_range && blockIdx.x == 0 && lane == 0;  // one thread a row adds to *total

  let_next_kernel_start();
  // the first rows' loads go out before the block fills its shared memory, so their latency overlaps it
  long long base = row_begin + threadIdx.x / lanes;
  Rows r;
  load_rows<kVec>(r, probs, target, weights, base, row_end, rows_per_pass, n_classes, c0, lane, lanes);
  for (int i = threadIdx.x; i <= n_thr; i += kThreads) {
    s_thr[i] = i < n_thr ? sorted_thr[i] : __int_as_float(0x7fc00000);  // NaN: never <= a score
  }
  for (int i = threadIdx.x; i < tile_c * nb_pad; i += kThreads) s_hist[i] = 0;
  if (threadIdx.x == 0) s_total = 0;
  __syncthreads();
  int top = 1;  // largest power of two <= T: the steps then cover k = 0 .. T
  while (top * 2 <= n_thr) top *= 2;

  int my_total = 0;
  while (base < row_end) {
    int k[kRowsUnroll][4] = {};
    for (int step = top; step > 0; step >>= 1) {  // the 16 searches advance together
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          k[u][j] += s_thr[min(k[u][j] + step - 1, n_thr)] <= r.v[u][j] ? step : 0;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsUnroll; ++u) {
      if (r.wt[u] == 0) continue;  // ignored rows (and rows past the end) count nowhere
      if (counts_rows) my_total += r.wt[u];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = column_of<kVec>(c0, lane, lanes, j);
        const int wt = r.wt[u];
        if (col >= n_classes) continue;
        const int kk = k[u][j];
        if (kk >= bin_lo && kk < bin_hi) atomicAdd(&s_hist[(j * lanes + lane) * nb_pad + kk - bin_lo], wt);
        if (first_range && col == r.tg[u]) {
          // a target outside [0, C) matches no column: the row is a negative for every class
          atomicAdd(&htp[static_cast<size_t>(kk) * n_classes + col], wt);
          atomicAdd(&seg_tp[static_cast<size_t>(kk / seg_bins) * n_classes + col], wt);
          atomicAdd(&actpos[col], wt);
        }
      }
    }
    base += stride;
    if (base < row_end) {
      load_rows<kVec>(r, probs, target, weights, base, row_end, rows_per_pass, n_classes, c0, lane, lanes);
    }
  }
  if (counts_rows && my_total != 0) atomicAdd(&s_total, my_total);
  __syncthreads();
  if (threadIdx.x == 0 && s_total != 0) atomicAdd(total, s_total);

  // consecutive threads read consecutive slots (stride nb_pad, odd: no bank conflicts);
  // a thread keeps one slot (kThreads is a multiple of tile_c) and walks its bins
  // upward, so it also sums them by epilogue segment and adds each sum once
  const int slot = threadIdx.x % tile_c;
  const int col = column_of<kVec>(c0, slot % lanes, lanes, slot / lanes);
  int seg = -1, seg_sum = 0;
#pragma unroll 4
  for (int kk = threadIdx.x / tile_c; kk < nb; kk += kThreads / tile_c) {
    const int count = s_hist[slot * nb_pad + kk];
    if (count != 0) {
      const int bin = bin_lo + kk;
      atomicAdd(&hpos[static_cast<size_t>(bin) * n_classes + col], count);
      if (bin / seg_bins != seg) {
        if (seg_sum != 0) atomicAdd(&seg_pos[static_cast<size_t>(seg) * n_classes + col], seg_sum);
        seg = bin / seg_bins;
        seg_sum = 0;
      }
      seg_sum += count;
    }
  }
  if (seg_sum != 0) atomicAdd(&seg_pos[static_cast<size_t>(seg) * n_classes + col], seg_sum);
}

__device__ __forceinline__ int wrap_add(int a, int b) {  // int32 wraparound, as torch and XLA add
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// Block (x, y): classes [32x, 32x + 32), one per lane, and segment y of the
// bins [0, T]: kEpiWarps * bins_per_warp bins, bins_per_warp to a warp. The
// threshold at sorted position r takes the bins above r: the block adds the
// sums of the segments above its own (seg_pos, seg_tp, from the histogram
// kernel), each warp the bins of the warps above it, and then walks its own
// bins downward, writing old + counts at the threshold's original index.
// Bin 0 (scores below every threshold) is read by no one: total and actpos
// come from the histogram kernel.
__global__ void __launch_bounds__(32 * kEpiWarps)
binned_epilogue_kernel(const int* __restrict__ hpos, const int* __restrict__ htp, const int* __restrict__ seg_pos,
                       const int* __restrict__ seg_tp, const int* __restrict__ actpos, const int* __restrict__ total,
                       const int* __restrict__ order, const int4* __restrict__ old_state, int4* __restrict__ new_state,
                       int n_classes, int n_thr, int bins_per_warp) {
  __shared__ int s_pos[2][kEpiWarps][32];  // [0]: a warp's share of the segments above, [1]: its own bins
  __shared__ int s_tp[2][kEpiWarps][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  const bool live = c < n_classes;
  const int n_bins = n_thr + 1;
  const int seg_bins = kEpiWarps * bins_per_warp;
  const int n_segs = (n_bins + seg_bins - 1) / seg_bins;
  const int seg_lo = min(static_cast<int>(blockIdx.y) * seg_bins, n_bins);
  const int seg_hi = min(seg_lo + seg_bins, n_bins);
  const int k_lo = min(seg_lo + warp * bins_per_warp, seg_hi);
  const int k_hi = min(k_lo + bins_per_warp, seg_hi);
  const int k_stop = max(k_lo, 1);

  // a group of kEpiGroup bins, top down: the old cells of their thresholds
  // (inputs of the update, loaded while the histogram kernel still runs) and
  // their counts (loaded after it); the next group is loaded before this one is used
  struct Group {
    int4 cell[kEpiGroup];
    size_t at[kEpiGroup];
    int pos[kEpiGroup], tp[kEpiGroup];
  };
  auto load_cells = [&](Group& g, int k_top) {
#pragma unroll
    for (int i = 0; i < kEpiGroup; ++i) {
      const int k = k_top - i;
      if (k >= k_stop) {
        g.at[i] = static_cast<size_t>(order[k - 1]) * n_classes + c;
        g.cell[i] = old_state[g.at[i]];
      }
    }
  };
  auto load_counts = [&](Group& g, int k_top) {
#pragma unroll
    for (int i = 0; i < kEpiGroup; ++i) {
      const int k = k_top - i;
      if (k >= k_stop) {
        g.pos[i] = hpos[static_cast<size_t>(k) * n_classes + c];
        g.tp[i] = htp[static_cast<size_t>(k) * n_classes + c];
      }
    }
  };
  Group cur, next;
  int k_top = k_hi - 1;
  if (live) load_cells(cur, k_top);
  let_next_kernel_start();
  wait_for_previous_kernel();

  int n_total = 0, n_actpos = 0, tail_pos = 0, tail_tp = 0, own_pos = 0, own_tp = 0;
  if (live) {
    load_counts(cur, k_top);
    n_total = *total;
    n_actpos = actpos[c];
    for (int sg = static_cast<int>(blockIdx.y) + 1 + warp; sg < n_segs; sg += kEpiWarps) {
      tail_pos += seg_pos[static_cast<size_t>(sg) * n_classes + c];
      tail_tp += seg_tp[static_cast<size_t>(sg) * n_classes + c];
    }
    if (k_hi - k_stop <= kEpiGroup) {
#pragma unroll
      for (int i = 0; i < kEpiGroup; ++i) {
        if (k_top - i >= k_stop) {
          own_pos += cur.pos[i];
          own_tp += cur.tp[i];
        }
      }
    } else {
#pragma unroll 4
      for (int k = k_stop; k < k_hi; ++k) {
        own_pos += hpos[static_cast<size_t>(k) * n_classes + c];
        own_tp += htp[static_cast<size_t>(k) * n_classes + c];
      }
    }
  }
  s_pos[0][warp][lane] = tail_pos;
  s_tp[0][warp][lane] = tail_tp;
  s_pos[1][warp][lane] = own_pos;
  s_tp[1][warp][lane] = own_tp;
  __syncthreads();
  if (!live) return;

  int above_pos = 0, above_tp = 0;
#pragma unroll
  for (int w = 0; w < kEpiWarps; ++w) {
    above_pos += s_pos[0][w][lane] + (w > warp ? s_pos[1][w][lane] : 0);
    above_tp += s_tp[0][w][lane] + (w > warp ? s_tp[1][w][lane] : 0);
  }
  // after adding bin k, above_* = sum over bins >= k: the counts of the
  // threshold at sorted position k - 1
  while (k_top >= k_stop) {
    load_cells(next, k_top - kEpiGroup);
    load_counts(next, k_top - kEpiGroup);
#pragma unroll
    for (int i = 0; i < kEpiGroup; ++i) {
      if (k_top - i >= k_stop) {
        above_pos += cur.pos[i];
        above_tp += cur.tp[i];
        const int fn = n_actpos - above_tp;
        int4 s = cur.cell[i];
        s.x = wrap_add(s.x, n_total - above_pos - fn);  // tn
        s.y = wrap_add(s.y, above_pos - above_tp);      // fp
        s.z = wrap_add(s.z, fn);                        // fn
        s.w = wrap_add(s.w, above_tp);                  // tp
        new_state[cur.at[i]] = s;
      }
    }
    cur = next;
    k_top -= kEpiGroup;
  }
}

// Launches `kernel` so that it may start while the kernel before it on the
// stream still runs (it waits with griddepcontrol.wait where it must).
template <typename... Params, typename... Args>
cudaError_t launch_overlapped(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                              Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kVec>
cudaError_t launch_hist(dim3 grid, size_t smem, cudaStream_t stream, const float* probs, const int* target,
                        const float* weights, const float* sorted_thr, int* hpos, int* htp, int* seg_pos,
                        int* seg_tp, int* actpos, int* total, int n_rows, int n_classes, int n_thr, int tile_c,
                        int bins_per_range, int rows_per_block, int seg_bins) {
  if (smem > 48 * 1024) {  // above 48 KB only after opting in; a refused launch never runs
    const cudaError_t err = cudaFuncSetAttribute(binned_hist_kernel<kVec>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // in stream order: the memset before it has finished when it starts
  binned_hist_kernel<kVec><<<grid, kThreads, smem, stream>>>(
      probs, target, weights, sorted_thr, hpos, htp, seg_pos, seg_tp, actpos, total, n_rows, n_classes, n_thr, tile_c,
      bins_per_range, rows_per_block, seg_bins);
  return cudaGetLastError();
}

// One fused update on `stream`: new_state = old_state + the batch's counts.
// `scratch` holds 2 * (T+1) * C + 2 * S * C + C + 1 int32, with
// S = ceil((T+1) / (kEpiWarps * bins_per_warp)) epilogue segments: the two
// histograms, their segment sums, actpos and total; its contents on entry do
// not matter. `new_state` is written in full and may not alias `old_state`.
// tile_c (128, 64 or 32), bins_per_range, rows_per_block and the epilogue's
// bins_per_warp come from the launcher's plan. Three device operations: a
// memset of the scratch and the histogram kernel, in stream order, and the
// epilogue, which may start while the histogram kernel runs. Returns the
// first CUDA error (0 on success), checked after each.
int launch_update(const void* probs, const void* target, const void* weights, const void* sorted_thr,
                  const void* order, const void* old_state, void* new_state, void* scratch, int n_rows, int n_classes,
                  int n_thr, int tile_c, int bins_per_range, int rows_per_block, int bins_per_warp, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t bin_cells = static_cast<size_t>(n_thr + 1) * n_classes;
  const int seg_bins = kEpiWarps * bins_per_warp;
  const int segments = (n_thr + 1 + seg_bins - 1) / seg_bins;
  const size_t seg_cells = static_cast<size_t>(segments) * n_classes;
  int* hpos = static_cast<int*>(scratch);
  int* htp = hpos + bin_cells;
  int* seg_pos = htp + bin_cells;
  int* seg_tp = seg_pos + seg_cells;
  int* actpos = seg_tp + seg_cells;
  int* total = actpos + n_classes;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (2 * bin_cells + 2 * seg_cells + n_classes + 1) * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int ranges = (n_thr + 1 + bins_per_range - 1) / bins_per_range;
  const int chunks = n_rows > 0 ? (n_rows + rows_per_block - 1) / rows_per_block : 1;
  const dim3 grid((n_classes + tile_c - 1) / tile_c, chunks, ranges);
  const size_t smem = (static_cast<size_t>(tile_c) * (bins_per_range | 1) + n_thr + 1) * sizeof(int);
  const bool vec = n_classes % 4 == 0 && reinterpret_cast<uintptr_t>(probs) % 16 == 0;
  const auto launch = vec ? &launch_hist<true> : &launch_hist<false>;
  err = launch(grid, smem, stream, static_cast<const float*>(probs), static_cast<const int*>(target),
               static_cast<const float*>(weights), static_cast<const float*>(sorted_thr), hpos, htp, seg_pos, seg_tp,
               actpos, total, n_rows, n_classes, n_thr, tile_c, bins_per_range, rows_per_block, seg_bins);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = launch_overlapped(binned_epilogue_kernel, dim3((n_classes + 31) / 32, segments),
                          dim3(32 * kEpiWarps), 0, stream, hpos, htp, seg_pos, seg_tp, actpos, total,
                          static_cast<const int*>(order), static_cast<const int4*>(old_state),
                          static_cast<int4*>(new_state), n_classes, n_thr, bins_per_warp);
  return static_cast<int>(err);
}

}  // namespace

// The multiclass update: probs (N, C), target (N,) class ids, weights (N,).
extern "C" int binned_confmat_multiclass_launch(const void* probs, const void* target, const void* weights,
                                                const void* sorted_thr, const void* order, const void* old_state,
                                                void* new_state, void* scratch, int n_rows, int n_classes, int n_thr,
                                                int tile_c, int bins_per_range, int rows_per_block, int bins_per_warp,
                                                void* stream_ptr) {
  return launch_update(probs, target, weights, sorted_thr, order, old_state, new_state, scratch, n_rows, n_classes,
                       n_thr, tile_c, bins_per_range, rows_per_block, bins_per_warp, stream_ptr);
}
