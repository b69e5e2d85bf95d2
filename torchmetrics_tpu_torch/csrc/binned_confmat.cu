// Binned one-vs-rest threshold counts for multiclass curves (AUROC, PR curve, ROC).
//
// Replaces the XLA-lowered JAX function `_binned_confmat_multiclass`
// (torchmetrics_tpu/functional/classification/precision_recall_curve.py:128-149).
// One pass over the scores gives, for every threshold t and class c,
//
//   tp[t, c]      = sum_n w[n] * [target[n] == c] * [probs[n, c] >= thr[t]]
//   pospred[t, c] = sum_n w[n] * [probs[n, c] >= thr[t]]
//   actpos[c]     = sum_n w[n] * [target[n] == c]
//
// and the caller derives fp, fn and tn from them. The JAX version builds an
// (N, C, T) comparison tensor and contracts it; this kernel never stores it.
//
// Bound on the card: the kernel must read probs once, N*C*4 bytes, plus N*8
// bytes of target and weights, and write T*C*8 bytes of counts. At N=1024,
// C=1000 that is 4.1 MB of probs: about 1.2 us at 3.35 TB/s, the H100 SXM
// data sheet's memory rate at the card's full 700 W power limit. The N*C*T
// comparisons are cheap next to that: 41 M float operations at T=20, 0.6 us
// at the same data sheet's 67 TFLOP/s float32 rate.
// So the design keeps every count in registers and touches device memory
// only to read probs (coalesced: one thread per class, neighbouring threads
// on neighbouring columns of a row) and to add each non-zero partial count
// to the output with one atomic per cell and block.
//
// Layout: block (x, y, z) covers 128 classes, 32 thresholds and a chunk of
// rows. The block stages its thresholds in shared memory; each thread keeps
// 2 x 32 partial counts in registers. Any threshold vector works, sorted or
// not. Counts are float32 sums of the weights: with 0/1 weights they are
// integers below 2**24 per batch, so the sums are exact whatever order the
// atomics land in, and equal to the plain version's.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kClassTile = 128;  // threads per block, one class column each
constexpr int kThrTile = 32;     // thresholds per block, counted in registers

__global__ void __launch_bounds__(kClassTile)
binned_confmat_multiclass_kernel(const float* __restrict__ probs, const int* __restrict__ target,
                                 const float* __restrict__ weights, const float* __restrict__ thresholds,
                                 float* __restrict__ out, int n_rows, int n_classes, int n_thr,
                                 int rows_per_block) {
  __shared__ float s_thr[kThrTile];
  const int c = blockIdx.x * kClassTile + threadIdx.x;
  const int t0 = blockIdx.y * kThrTile;
  const int row_begin = blockIdx.z * rows_per_block;
  const int row_end = min(row_begin + rows_per_block, n_rows);

  if (threadIdx.x < kThrTile) {
    const int t = t0 + threadIdx.x;
    s_thr[threadIdx.x] = t < n_thr ? thresholds[t] : 0.f;  // padding is never written out
  }
  __syncthreads();
  if (c >= n_classes) return;

  float thr[kThrTile];
  float tp[kThrTile];
  float pos[kThrTile];
#pragma unroll
  for (int i = 0; i < kThrTile; ++i) {
    thr[i] = s_thr[i];
    tp[i] = 0.f;
    pos[i] = 0.f;
  }
  float actpos = 0.f;

  for (int n = row_begin; n < row_end; ++n) {
    const float w = weights[n];
    const float wt = target[n] == c ? w : 0.f;
    const float p = probs[static_cast<size_t>(n) * n_classes + c];
    actpos += wt;
#pragma unroll
    for (int i = 0; i < kThrTile; ++i) {
      const float ge = p >= thr[i] ? 1.f : 0.f;
      pos[i] += ge * w;
      tp[i] += ge * wt;
    }
  }

  // output rows: [0, T) tp, [T, 2T) pospred, 2T actpos; each (C,)
  float* out_tp = out;
  float* out_pos = out + static_cast<size_t>(n_thr) * n_classes;
  float* out_act = out + 2 * static_cast<size_t>(n_thr) * n_classes;
#pragma unroll
  for (int i = 0; i < kThrTile; ++i) {
    const int t = t0 + i;
    if (t < n_thr) {
      const size_t cell = static_cast<size_t>(t) * n_classes + c;
      if (tp[i] != 0.f) atomicAdd(out_tp + cell, tp[i]);
      if (pos[i] != 0.f) atomicAdd(out_pos + cell, pos[i]);
    }
  }
  if (blockIdx.y == 0 && actpos != 0.f) atomicAdd(out_act + c, actpos);
}

}  // namespace

// Launches on `stream`; `out` is (2*T + 1, C) float32 and must hold zeros.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int binned_confmat_multiclass_launch(const void* probs, const void* target, const void* weights,
                                                const void* thresholds, void* out, int n_rows, int n_classes,
                                                int n_thr, int rows_per_block, void* stream) {
  const int chunks = n_rows > 0 ? (n_rows + rows_per_block - 1) / rows_per_block : 1;
  const dim3 grid((n_classes + kClassTile - 1) / kClassTile, (n_thr + kThrTile - 1) / kThrTile, chunks);
  binned_confmat_multiclass_kernel<<<grid, kClassTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(probs), static_cast<const int*>(target), static_cast<const float*>(weights),
      static_cast<const float*>(thresholds), static_cast<float*>(out), n_rows, n_classes, n_thr,
      rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
