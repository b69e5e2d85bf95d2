// Multiclass confusion-matrix state update, fused: (C, C) int32 state += the
// batch's (target, prediction) pair counts, in place.
//
// Replaces the XLA-lowered JAX function `_weighted_pair_count`
// (torchmetrics_tpu/functional/classification/confusion_matrix.py:65-69) as
// `_multiclass_confusion_matrix_update` (:100-111) calls it, and the int32 add
// of the metric classes after it (classification/confusion_matrix.py:73-75).
// For every element e of the batch:
//
//   p = argmax_k preds[n, k, s]   (or the integer label preds[n, s])
//   i = int32(t) * C + int32(p)   in int32, wrapping, t = target[n, s]
//   i += C*C if i < 0;  drop i if i < 0 or i >= C*C;  drop e if t == ignore_index
//   state[i] += 1
//
// These are JAX's rules, checked against jax 0.9.0 on the CPU: the argmax is
// the lowest index among the maxima, a NaN beats every number and the first
// NaN wins, -0.0 and +0.0 tie, an all -inf row gives 0; `.at[i].add` wraps an
// index in [-C*C, 0) once and drops what is still out of range. Scores in
// float16 and bfloat16 are compared after widening to float32 (exact). The
// counts are int32 and exact, where JAX sums float32 weights a batch (exact
// below 2**24 a cell).
//
// Bound on the card: the update must read the scores once (N*K*S elements)
// and the targets once; the state cells it touches are at most N*S and sit in
// L2. At ImageNet-1k's batch (N=1024, K=C=1000, float32) that is 4.1 MB:
// 1.23 us at 3.35 TB/s (H100 SXM data sheet, 700 W). At a Cityscapes-shaped
// batch (2, 19, 1024, 2048) float32 with int64 targets it is 352.3 MB: 105 us.
// The N*K*S compares (79.7 M there) take 1.2 us at 67 TFLOP/s, so bytes bind.
// At ImageNet-1k's batch the bytes stream in one round, and what is left is
// latency: measured on an H100 (tools/kernel_ablation.py --sections confmat),
// 256 blocks that load nothing take 5.6 us after an L2 flush, the scores'
// stream 2.6 us more, the target 0.2 and the atomic on a cold state cell 0.3.
//
// What the design does about it:
// - rows of many scores (S == 1, K >= 32) take a warp a row: the lanes read
//   the row in 16-byte loads where the row is 16-byte aligned (else a score a
//   lane, neighbouring lanes on neighbouring scores), all of a lane's loads of
//   a round issued before its compares (a 1,000-score row is one round), each
//   lane keeps its own (max, index), and five shuffles merge the lanes under
//   the rules above. Lane 0 then reads the row's target: its line is in L2 by
//   then, brought in by the warps of the neighbouring rows. Read by every lane
//   before the scores it made the kernel slower, and neither a prefetch of the
//   state row or of each lane's candidate cell to L2, nor the row by one TMA
//   bulk copy, nor a 256-byte L2 fetch made it faster;
// - scores of few classes or with a spatial size (segmentation's (N, C, H, W))
//   take a thread an element: a thread walks the K scores of its pixel at
//   stride S, so a warp's loads of one class are 32 neighbouring pixels,
//   coalesced. Where S % 4 == 0 and the scores and targets are 16-byte
//   aligned, a thread takes four neighbouring pixels, one vector load a class,
//   so each load moves 4x the bytes and four argmax chains overlap;
// - integer labels take a thread a label;
// - contention. Where 4*C*C bytes fit in 32 KB (C <= 90) and the batch has at
//   least as many elements as the histogram has cells, each block counts into
//   a (C, C) histogram of its own in shared memory and flushes its non-zero
//   cells to the state with one int32 atomic each. Otherwise (C > 90, or a
//   batch smaller than its histogram, whose zeroing and flush outweigh it)
//   elements add to the state directly. The lanes of a warp that hit the same
//   cell are merged first (`__match_any_sync`), so one atomic adds their
//   count: in segmentation most pixels of a warp fall on the few diagonal
//   cells. Labels on the state skip the merge and add one atomic an element
//   whose result nothing waits for (a RED): at C = 1,000 their lanes rarely
//   share a cell, and the match cost more than it saved;
// - int32 index arithmetic in unsigned form (defined wrap), the sign test and
//   one wrap, as above.
//
// Device work of one update, on the caller's stream: one kernel.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSharedCells = 8192;  // a block's (C, C) histogram in shared memory up to 32 KB
constexpr int kRowThreads = 128;
constexpr int kElementThreads = 256;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

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

// The flat cell of a (target, prediction) pair, or -1 where JAX adds nothing.
__device__ __forceinline__ int pair_cell(long long t, int p, int n_classes, int cells, bool has_ignore,
                                         long long ignore) {
  const int t32 = static_cast<int>(t);  // an int64 label counts as its low 32 bits
  if (has_ignore && static_cast<long long>(t32) == ignore) return -1;
  int i = static_cast<int>(static_cast<unsigned>(t32) * static_cast<unsigned>(n_classes) + static_cast<unsigned>(p));
  if (i < 0) i += cells;  // cells <= INT_MAX, so this cannot overflow
  return (i >= 0 && i < cells) ? i : -1;
}

struct Args {
  const void* preds;
  const void* target;
  int* state;
  int n_rows, n_scores, inner, n_classes, cells;
  bool has_ignore, shared, vec;
  long long ignore;
};

// Add one to hist[cell] where cell >= 0. With `merge`, all 32 lanes of the warp must call it, and lanes on
// the same cell share one atomic; without, one atomic an element, whose result nothing waits for.
__device__ __forceinline__ void add_cell(int* hist, int cell, bool merge) {
  if (merge) {
    const unsigned peers = __match_any_sync(kFull, cell);
    if (cell >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(hist + cell, __popc(peers));
  } else if (cell >= 0) {
    atomicAdd(hist + cell, 1);
  }
}

// A lane's share of a row: all the loads of a round are issued before any
// compare, so a round costs one memory latency; a row of 1,000 float32 scores
// is one round of 8 16-byte loads a lane.
constexpr int kRoundLoads = 8;

template <typename T>
__device__ __forceinline__ void scan_row(const T* __restrict__ row, int n_scores, bool vec, float& best, int& arg) {
  const int lane = threadIdx.x & 31;
  if (vec) {  // 16-byte loads; n_scores is a multiple of the vector width
    constexpr int kV = 16 / sizeof(T);
    const float4* v16 = reinterpret_cast<const float4*>(row);
    const int n_vec = n_scores / kV;
    for (int j0 = lane; j0 < n_vec; j0 += 32 * kRoundLoads) {
      float4 raw[kRoundLoads];
#pragma unroll
      for (int u = 0; u < kRoundLoads; ++u) {
        if (j0 + 32 * u < n_vec) raw[u] = v16[j0 + 32 * u];
      }
#pragma unroll
      for (int u = 0; u < kRoundLoads; ++u) {
        const int j = j0 + 32 * u;
        const T* chunk = reinterpret_cast<const T*>(&raw[u]);
        if (j < n_vec) {
#pragma unroll
          for (int q = 0; q < kV; ++q) take(widen(chunk[q]), j * kV + q, best, arg);
        }
      }
    }
  } else {
    for (int k0 = lane; k0 < n_scores; k0 += 32 * 4 * kRoundLoads) {
      float v[4 * kRoundLoads];
#pragma unroll
      for (int u = 0; u < 4 * kRoundLoads; ++u) {
        if (k0 + 32 * u < n_scores) v[u] = widen(row[k0 + 32 * u]);
      }
#pragma unroll
      for (int u = 0; u < 4 * kRoundLoads; ++u) {
        if (k0 + 32 * u < n_scores) take(v[u], k0 + 32 * u, best, arg);
      }
    }
  }
}

// Zero the block's shared histogram, or point at the state.
__device__ __forceinline__ int* open_hist(const Args& a, int* smem) {
  if (!a.shared) return a.state;
  for (int i = threadIdx.x; i < a.cells; i += blockDim.x) smem[i] = 0;
  __syncthreads();
  return smem;
}

// Flush the block's non-zero cells to the state, one atomic a cell.
__device__ __forceinline__ void close_hist(const Args& a, const int* smem) {
  if (!a.shared) return;
  __syncthreads();
  for (int i = threadIdx.x; i < a.cells; i += blockDim.x) {
    const int v = smem[i];
    if (v != 0) atomicAdd(a.state + i, v);
  }
}

// A warp a row of scores (inner == 1).
template <typename T, typename U>
__global__ void __launch_bounds__(kRowThreads) confmat_rows_kernel(Args a) {
  extern __shared__ int smem[];
  int* hist = open_hist(a, smem);
  const T* preds = static_cast<const T*>(a.preds);
  const U* target = static_cast<const U*>(a.target);
  const int warps = blockDim.x / 32;
  const int stride = gridDim.x * warps;
  for (int r = blockIdx.x * warps + threadIdx.x / 32; r < a.n_rows; r += stride) {  // warp-uniform
    float best = neg_inf();
    int arg = INT_MAX;
    scan_row(preds + static_cast<long long>(r) * a.n_scores, a.n_scores, a.vec, best, arg);
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, offset);
      const int oa = __shfl_xor_sync(kFull, arg, offset);
      if (beats(ob, oa, best, arg)) {
        best = ob;
        arg = oa;
      }
    }
    if ((threadIdx.x & 31) == 0) {  // the target's line is in L2 by now: its neighbours' warps read it
      const int cell = pair_cell(static_cast<long long>(target[r]), arg, a.n_classes, a.cells, a.has_ignore, a.ignore);
      if (cell >= 0) atomicAdd(hist + cell, 1);
    }
  }
  close_hist(a, smem);
}

// A thread an element: scores at stride `inner` (LABELS: an integer label of type T).
template <typename T, typename U, bool LABELS>
__global__ void __launch_bounds__(kElementThreads) confmat_elements_kernel(Args a) {
  extern __shared__ int smem[];
  int* hist = open_hist(a, smem);
  const T* preds = static_cast<const T*>(a.preds);
  const U* target = static_cast<const U*>(a.target);
  const bool merge = !LABELS || a.shared;
  const long long n = static_cast<long long>(a.n_rows) * a.inner;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  // warp-uniform bounds: every lane reaches add_cell on every pass
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x + (threadIdx.x - lane); base < n;
       base += stride) {
    const long long e = base + lane;
    int cell = -1;
    if (e < n) {
      int p;
      if constexpr (LABELS) {
        p = static_cast<int>(preds[e]);
      } else {
        const long long row = e / a.inner, s = e - row * a.inner;
        const T* x = preds + row * a.n_scores * a.inner + s;
        float best = neg_inf();
        int arg = INT_MAX;
#pragma unroll 4
        for (int k = 0; k < a.n_scores; ++k) take(widen(x[static_cast<long long>(k) * a.inner]), k, best, arg);
        p = arg;
      }
      cell = pair_cell(static_cast<long long>(target[e]), p, a.n_classes, a.cells, a.has_ignore, a.ignore);
    }
    add_cell(hist, cell, merge);
  }
  close_hist(a, smem);
}

// Four neighbouring scores in one load: 16 bytes of float32, 8 of float16 or bfloat16.
template <typename T>
struct Quad {
  using V = uint2;
};
template <>
struct Quad<float> {
  using V = float4;
};

template <typename T>
__device__ __forceinline__ void load_quad(const T* p, float (&v)[4]) {
  const typename Quad<T>::V raw = *reinterpret_cast<const typename Quad<T>::V*>(p);
  const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = widen(x[q]);
}

__device__ __forceinline__ void load_targets(const int* p, long long (&t)[4]) {
  const int4 r = *reinterpret_cast<const int4*>(p);
  t[0] = r.x, t[1] = r.y, t[2] = r.z, t[3] = r.w;
}

__device__ __forceinline__ void load_targets(const long long* p, long long (&t)[4]) {
  const longlong2 lo = reinterpret_cast<const longlong2*>(p)[0], hi = reinterpret_cast<const longlong2*>(p)[1];
  t[0] = lo.x, t[1] = lo.y, t[2] = hi.x, t[3] = hi.y;
}

// A thread four neighbouring elements (inner % 4 == 0, scores and targets 16-byte
// aligned): one vector load a class, four argmax chains side by side.
template <typename T, typename U>
__global__ void __launch_bounds__(kElementThreads) confmat_quads_kernel(Args a) {
  extern __shared__ int smem[];
  int* hist = open_hist(a, smem);
  const T* preds = static_cast<const T*>(a.preds);
  const U* target = static_cast<const U*>(a.target);
  const long long n_quads = static_cast<long long>(a.n_rows) * a.inner / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x + (threadIdx.x - lane); base < n_quads;
       base += stride) {  // warp-uniform, as in the elements kernel
    const long long g = base + lane;
    int cells[4] = {-1, -1, -1, -1};
    if (g < n_quads) {
      const long long e = 4 * g, row = e / a.inner, s = e - row * a.inner;
      const T* x = preds + row * a.n_scores * a.inner + s;
      float best[4], v[4];
      int arg[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) best[q] = neg_inf(), arg[q] = INT_MAX;
#pragma unroll 2
      for (int k = 0; k < a.n_scores; ++k) {
        load_quad(x + static_cast<long long>(k) * a.inner, v);
#pragma unroll
        for (int q = 0; q < 4; ++q) take(v[q], k, best[q], arg[q]);
      }
      long long t[4];
      load_targets(target + e, t);
#pragma unroll
      for (int q = 0; q < 4; ++q) cells[q] = pair_cell(t[q], arg[q], a.n_classes, a.cells, a.has_ignore, a.ignore);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) add_cell(hist, cells[q], true);
  }
  close_hist(a, smem);
}

template <typename T, typename U>
cudaError_t launch_typed(int mode, const Args& a, int blocks, int threads, cudaStream_t stream) {
  const size_t smem = a.shared ? static_cast<size_t>(a.cells) * sizeof(int) : 0;
  if (mode == 0) {
    confmat_rows_kernel<T, U><<<blocks, threads, smem, stream>>>(a);
  } else if (a.vec) {
    confmat_quads_kernel<T, U><<<blocks, threads, smem, stream>>>(a);
  } else {
    confmat_elements_kernel<T, U, false><<<blocks, threads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename L, typename U>
cudaError_t launch_labels(const Args& a, int blocks, int threads, cudaStream_t stream) {
  const size_t smem = a.shared ? static_cast<size_t>(a.cells) * sizeof(int) : 0;
  confmat_elements_kernel<L, U, true><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_target(int pred_kind, int mode, const Args& a, int blocks, int threads, cudaStream_t stream) {
  switch (pred_kind) {
    case 0: return launch_typed<float, U>(mode, a, blocks, threads, stream);
    case 1: return launch_typed<__half, U>(mode, a, blocks, threads, stream);
    case 2: return launch_typed<__nv_bfloat16, U>(mode, a, blocks, threads, stream);
    case 3: return launch_labels<int, U>(a, blocks, threads, stream);
    case 4: return launch_labels<long long, U>(a, blocks, threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// pred_kind: 0 float32, 1 float16, 2 bfloat16 scores (N, K, S); 3 int32, 4 int64 labels (N, S).
// target_kind: 0 int32, 1 int64. mode: 0 a warp a row (S == 1), 1 a thread an element, 2 labels.
extern "C" int confmat_multiclass_launch(const void* preds, int pred_kind, const void* target, int target_kind,
                                         void* state, int n_rows, int n_scores, int inner, int n_classes,
                                         int has_ignore, long long ignore_index, int mode, int shared, int blocks,
                                         int threads, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args a;
  a.preds = preds;
  a.target = target;
  a.state = static_cast<int*>(state);
  a.n_rows = n_rows;
  a.n_scores = n_scores;
  a.inner = inner;
  a.n_classes = n_classes;
  a.cells = n_classes * n_classes;
  a.has_ignore = has_ignore != 0;
  a.shared = shared != 0;
  a.ignore = ignore_index;
  if (a.shared && a.cells > kSharedCells) return static_cast<int>(cudaErrorInvalidValue);
  // vector loads: along a row of scores (mode 0), or across four neighbouring elements (mode 1)
  const int elem_bytes = pred_kind == 0 ? 4 : 2;
  const bool aligned = reinterpret_cast<uintptr_t>(preds) % 16 == 0;
  a.vec = mode == 0 ? aligned && (static_cast<long long>(n_scores) * elem_bytes) % 16 == 0
                    : mode == 1 && aligned && inner % 4 == 0 && reinterpret_cast<uintptr_t>(target) % 16 == 0;
  if ((mode == 2) != (pred_kind >= 3)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = target_kind == 0 ? launch_target<int>(pred_kind, mode, a, blocks, threads, stream)
                                           : launch_target<long long>(pred_kind, mode, a, blocks, threads, stream);
  return static_cast<int>(err);
}
