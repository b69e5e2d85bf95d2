// Binned per-label threshold counts for multilabel and binary curves (AUROC,
// AP, PR curve, ROC, the fixed operating points), fused with the state
// update: old (T, L, 2, 2) int32 state + one formatted batch -> new state.
//
// Replaces the XLA-lowered JAX functions `_binned_confmat_multilabel`
// (torchmetrics_tpu/functional/classification/precision_recall_curve.py:152-164)
// and, at one label, the binary `_binned_curve_update` (:108-125), each
// followed by the int32 add at classification/precision_recall_curve.py:130.
// For every threshold t and label l, over the rows n of an (N, L) batch with
// per-element target and 0/1 weight:
//
//   pospred[t, l] = sum_n w[n, l] * [p[n, l] >= thr[t]]
//   tp[t, l]      = sum_n w[n, l] * target[n, l] * [p[n, l] >= thr[t]]
//   actpos[l]     = sum_n w[n, l] * target[n, l],   total[l] = sum_n w[n, l]
//   new[t, l]     = old[t, l] + [[total - pospred - fn, pospred - tp], [fn, tp]],  fn = actpos - tp
//
// Bin once, then suffix-sum: with k = #{j : sorted[j] <= p}, p passes the
// threshold at sorted position r iff k > r, so each score is binned once (a
// binary search over the sorted thresholds in shared memory) into hpos[l][k]
// and, with its weight times its target, htp[l][k]; pospred(r) and tp(r) are
// the sums over bins k > r, total and actpos the sums over all bins. Exact
// for thresholds in any order, with duplicates, +-inf and NaN: NaN thresholds
// sort last and pass nothing; a NaN score lands in bin 0 and passes nothing.
//
// Bound on the card: read probs, target and weights once (12 bytes an
// element), the sorted thresholds and their order, the old state, and write
// the new one (16 bytes a cell each way): at the COCO batch (256, 80) and
// T = 100, 502,560 bytes, 0.15 us at 3.35 TB/s (H100 SXM data sheet,
// 700 W). Every batch of the curve paths is that small, so a call binds on
// launch latency and on the chain of dependent memory reads inside it.
//
// What the design does about it:
// - one kernel launch, and nothing else on the stream: no memset, no second
//   kernel. A block owns a group of labels over a chunk of rows, keeps the
//   group's histograms in shared memory, suffix-sums its own bins and writes
//   old + counts into every cell of its labels;
// - lanes on rows: a block's elements are its rows x its labels, label
//   fastest, dealt to consecutive threads, so at one label a warp's lanes
//   take 32 consecutive rows and every lane works. A small batch (at most
//   32,768 elements a group) takes one label a block, or as many as keep the
//   grid at about one block an SM: more blocks, each with one pass over its
//   rows (at the COCO batch, 80 blocks of 256 rows measured faster than 10 of
//   8 labels x 256 rows, whose rows are read a 32-byte sector at a time). A
//   large batch takes up to 8 labels a block, a sector of each row;
// - where a label group's batch is small, its rows are one chunk: no merge,
//   no scratch, no atomics to device memory (every batch of the curve
//   paths). Larger batches cut the rows into chunks that write their partial
//   histograms to scratch; the last block of the label group, found by a
//   ticket that it sets back to zero, adds them in chunk order and writes the
//   state. Integer sums: exact and deterministic;
// - at T up to 16,384 one label's bins and the thresholds fit one block's
//   shared memory (196,620 bytes): no bin ranges;
// - no load waits on another: a thread starts the loads of 4 elements before
//   it bins any and of the next 4 before it counts these, and loads its first
//   old cells and entries of `order` at the start. The cells are taken in the
//   caller's threshold order, label fastest; each threshold's sorted position
//   comes from a table that `order` fills in shared memory, where the
//   thresholds were, and the counts from the bins' suffix sums, made in place.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;      // elements whose loads a thread starts before binning any
constexpr int kCellGroup = 4;   // old state cells (and entries of `order`) a thread loads first

struct Args {
  const float* probs;
  const int* target;
  const float* weights;
  const float* sorted_thr;
  const int* order;
  const int4* old_state;
  int4* new_state;
  int* partial;           // (groups, chunks, 2, lg, T + 1) when chunks > 1
  unsigned int* tickets;  // (groups,), zero before and after the launch
  int n_rows, n_labels, n_thr;
  int lg;           // labels a group; the last group may hold fewer
  int label_lanes;  // lg rounded up to a power of two: the epilogue's lanes a bin segment
  int rows_per_chunk, chunks;
};

__device__ __forceinline__ int wrap_add(int a, int b) {  // int32 wraparound, as torch and XLA add
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

struct Elements {  // kUnroll elements of one thread
  float p[kUnroll];
  int w[kUnroll], tg[kUnroll], label[kUnroll];
};

__device__ __forceinline__ void load_elements(Elements& x, const Args& a, int q0, int n_elems, int lgc, long long r0,
                                              int l0) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int q = q0 + u * kThreads;
    const bool ok = q < n_elems;
    const int r = ok ? q / lgc : 0;
    const int l = ok ? q - r * lgc : 0;
    const size_t at = static_cast<size_t>(r0 + r) * a.n_labels + l0 + l;
    x.p[u] = ok ? __ldg(a.probs + at) : 0.0f;
    x.w[u] = ok ? static_cast<int>(__ldg(a.weights + at)) : 0;
    x.tg[u] = ok ? __ldg(a.target + at) : 0;
    x.label[u] = l;
  }
}

// The global index of this block's state cell q: threshold q / lgc (the caller's order), label l0 + q % lgc.
__device__ __forceinline__ size_t cell_index(const Args& a, int q, int lgc, int l0) {
  return static_cast<size_t>(q / lgc) * a.n_labels + l0 + q % lgc;
}

// Block (g, c): labels [g lg, g lg + lg) over rows [c rows_per_chunk, + rows_per_chunk).
__global__ void __launch_bounds__(kThreads) binned_multilabel_kernel(Args a) {
  extern __shared__ int smem[];
  __shared__ int s_warp[2][kWarps][32];  // each warp's suffix sums of a label's bin segments
  const int bins = a.n_thr + 1, nbp = bins | 1;  // odd: histogram rows of neighbouring labels start on other banks
  const int l0 = blockIdx.x * a.lg;
  const int lgc = min(a.lg, a.n_labels - l0);
  int* s_pos = smem;              // (lg, nbp): bin counts, then their suffix sums
  int* s_tp = smem + a.lg * nbp;  // (lg, nbp)
  float* s_thr = reinterpret_cast<float*>(smem + 2 * a.lg * nbp);  // T + 1, NaN last
  int* s_rank = reinterpret_cast<int*>(s_thr);  // after the histogram: each threshold's sorted position
  const long long r0 = static_cast<long long>(blockIdx.y) * a.rows_per_chunk;
  const int n_elems = static_cast<int>(min(static_cast<long long>(a.rows_per_chunk), a.n_rows - r0)) * lgc;
  const int n_cells = a.n_thr * lgc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // loads that go out before the block fills its shared memory, none waiting on another:
  // the first elements, and this thread's first old cells and entries of `order`
  Elements cur;
  load_elements(cur, a, threadIdx.x, n_elems, lgc, r0, l0);
  int4 old[kCellGroup];
  int ord[kCellGroup];
#pragma unroll
  for (int i = 0; i < kCellGroup; ++i) {
    const int q = threadIdx.x + i * kThreads;
    if (q < n_cells) old[i] = a.old_state[cell_index(a, q, lgc, l0)];
    if (q < a.n_thr) ord[i] = __ldg(a.order + q);
  }
  for (int i = threadIdx.x; i <= a.n_thr; i += kThreads) {
    s_thr[i] = i < a.n_thr ? a.sorted_thr[i] : __int_as_float(0x7fc00000);  // NaN: never <= a score
  }
  for (int i = threadIdx.x; i < 2 * a.lg * nbp; i += kThreads) smem[i] = 0;
  __syncthreads();
  int top = 1;  // the largest power of two <= T: the steps then cover k = 0 .. T
  while (top * 2 <= a.n_thr) top *= 2;

  for (int q0 = threadIdx.x; q0 < n_elems; q0 += kUnroll * kThreads) {
    int k[kUnroll] = {};
    for (int step = top; step > 0; step >>= 1) {  // the kUnroll searches advance together
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) k[u] += s_thr[min(k[u] + step - 1, a.n_thr)] <= cur.p[u] ? step : 0;
    }
    Elements next;
    if (q0 + kUnroll * kThreads < n_elems) load_elements(next, a, q0 + kUnroll * kThreads, n_elems, lgc, r0, l0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (cur.w[u] == 0) continue;  // ignored elements (and those past the end) count nowhere
      const int at = cur.label[u] * nbp + k[u];
      atomicAdd(&s_pos[at], cur.w[u]);
      const int tw = cur.w[u] * cur.tg[u];
      if (tw != 0) atomicAdd(&s_tp[at], tw);
    }
    cur = next;
  }

  if (a.chunks > 1) {  // write this chunk's histograms; the group's last block adds them all
    const size_t words = static_cast<size_t>(2) * a.lg * bins;
    int* mine = a.partial + (static_cast<size_t>(blockIdx.x) * a.chunks + blockIdx.y) * words;
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * lgc * bins; i += kThreads) {
      const int h = i / (lgc * bins), l = (i / bins) % lgc, b = i % bins;
      mine[(static_cast<size_t>(h) * a.lg + l) * bins + b] = smem[(h * a.lg + l) * nbp + b];
    }
    __threadfence();
    __syncthreads();
    int last = 0;
    if (threadIdx.x == 0) last = atomicAdd(a.tickets + blockIdx.x, 1u) == static_cast<unsigned>(a.chunks - 1);
    if (!__syncthreads_or(last)) return;
    __threadfence();
    const int* group = a.partial + static_cast<size_t>(blockIdx.x) * a.chunks * words;
    for (int i = threadIdx.x; i < 2 * lgc * bins; i += kThreads) {
      const int h = i / (lgc * bins), l = (i / bins) % lgc, b = i % bins;
      const size_t off = (static_cast<size_t>(h) * a.lg + l) * bins + b;
      int sum = 0;
      for (int c = 0; c < a.chunks; ++c) sum += __ldcg(group + c * words + off);  // in chunk order
      smem[(h * a.lg + l) * nbp + b] = sum;
    }
    if (threadIdx.x == 0) a.tickets[blockIdx.x] = 0u;  // every block of the group has taken its ticket
  }
  __syncthreads();  // the histograms are whole, and the thresholds read for the last time

  // each threshold's sorted position, where the thresholds were
#pragma unroll
  for (int i = 0; i < kCellGroup; ++i) {
    const int r = threadIdx.x + i * kThreads;
    if (r < a.n_thr) s_rank[ord[i]] = r;
  }
  for (int r = threadIdx.x + kCellGroup * kThreads; r < a.n_thr; r += kThreads) s_rank[__ldg(a.order + r)] = r;

  // suffix sums over the bins of each label, in place: a thread sums a segment of one
  // label's bins (label fastest), the segments are suffix-scanned in the warp by shuffles
  // (lanes of one label are `ll` apart) and across warps through shared memory
  const int ll = a.label_lanes;
  const int le = threadIdx.x % ll, sub = threadIdx.x / ll;
  const int seg = (bins + kThreads / ll - 1) / (kThreads / ll);
  const int k_lo = min(sub * seg, bins), k_hi = min(k_lo + seg, bins);
  const bool e_live = le < lgc;
  int seg_pos = 0, seg_tp = 0;
  if (e_live) {
    for (int kk = k_lo; kk < k_hi; ++kk) {
      seg_pos += s_pos[le * nbp + kk];
      seg_tp += s_tp[le * nbp + kk];
    }
  }
  int suf_pos = seg_pos, suf_tp = seg_tp;
  for (int d = ll; d < 32; d <<= 1) {
    const int op = __shfl_down_sync(kFull, suf_pos, d), ot = __shfl_down_sync(kFull, suf_tp, d);
    if (lane + d < 32) {
      suf_pos += op;
      suf_tp += ot;
    }
  }
  if (lane < ll) {
    s_warp[0][warp][lane] = suf_pos;
    s_warp[1][warp][lane] = suf_tp;
  }
  __syncthreads();
  if (e_live) {
    int run_pos = suf_pos - seg_pos, run_tp = suf_tp - seg_tp;  // the bins above this segment
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w > warp) {
        run_pos += s_warp[0][w][le];
        run_tp += s_warp[1][w][le];
      }
    }
    for (int kk = k_hi - 1; kk >= k_lo; --kk) {
      run_pos += s_pos[le * nbp + kk];
      run_tp += s_tp[le * nbp + kk];
      s_pos[le * nbp + kk] = run_pos;
      s_tp[le * nbp + kk] = run_tp;
    }
  }
  __syncthreads();

  // every cell: the threshold at sorted position r passes the bins above r, whose sums
  // are at bin r + 1; bin 0's sums are the label's total and actual positives
  auto write_cell = [&](int q, int4 s) {
    const int l = q % lgc;
    const int at = l * nbp + s_rank[q / lgc] + 1;
    const int pos = s_pos[at], tp = s_tp[at];
    const int fn = s_tp[l * nbp] - tp;
    s.x = wrap_add(s.x, s_pos[l * nbp] - pos - fn);  // tn
    s.y = wrap_add(s.y, pos - tp);                   // fp
    s.z = wrap_add(s.z, fn);                         // fn
    s.w = wrap_add(s.w, tp);                         // tp
    a.new_state[cell_index(a, q, lgc, l0)] = s;
  };
#pragma unroll
  for (int i = 0; i < kCellGroup; ++i) {
    const int q = threadIdx.x + i * kThreads;
    if (q < n_cells) write_cell(q, old[i]);
  }
  for (int q = threadIdx.x + kCellGroup * kThreads; q < n_cells; q += kThreads) {
    write_cell(q, a.old_state[cell_index(a, q, lgc, l0)]);
  }
}

}  // namespace

// One fused update on `stream`: new_state = old_state + the batch's counts.
// probs, target and weights (N, L); sorted_thr and order (T,); the states
// (T, L, 2, 2), `new_state` written in full and not aliasing `old_state`.
// The grid is (groups of `lg` labels, `chunks` row chunks of `rows_per_chunk`);
// `partial` holds groups * chunks * 2 * lg * (T + 1) int32 when chunks > 1
// (its contents on entry do not matter), `tickets` groups zeros, zero again
// after. `shared_bytes` = (2 lg ((T + 1) | 1) + T + 1) * 4. One kernel, no
// other device operation. Returns the CUDA error of the launch (0 on success).
extern "C" int binned_multilabel_launch(const void* probs, const void* target, const void* weights,
                                        const void* sorted_thr, const void* order, const void* old_state,
                                        void* new_state, void* partial, void* tickets, int n_rows, int n_labels,
                                        int n_thr, int lg, int label_lanes, int rows_per_chunk, int chunks,
                                        int shared_bytes, void* stream_ptr) {
  Args a;
  a.probs = static_cast<const float*>(probs);
  a.target = static_cast<const int*>(target);
  a.weights = static_cast<const float*>(weights);
  a.sorted_thr = static_cast<const float*>(sorted_thr);
  a.order = static_cast<const int*>(order);
  a.old_state = static_cast<const int4*>(old_state);
  a.new_state = static_cast<int4*>(new_state);
  a.partial = static_cast<int*>(partial);
  a.tickets = static_cast<unsigned int*>(tickets);
  a.n_rows = n_rows;
  a.n_labels = n_labels;
  a.n_thr = n_thr;
  a.lg = lg;
  a.label_lanes = label_lanes;
  a.rows_per_chunk = rows_per_chunk;
  a.chunks = chunks;
  // above 48 KB of static and dynamic shared memory only after opting in; a refused launch never runs
  if (shared_bytes + sizeof(int) * 2 * kWarps * 32 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(binned_multilabel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n_labels + lg - 1) / lg, chunks);
  binned_multilabel_kernel<<<grid, kThreads, shared_bytes, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
