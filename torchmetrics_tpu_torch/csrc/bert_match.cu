// BERTScore's greedy matching: for each pair b of prediction and target
// embeddings (Tp, H) and (Tt, H), with their 0/1 masks and optional idf
// weights, the cosine similarity of every token pair, each prediction token's
// best match (the maximum over its row) and each target token's (over its
// column), and precision, recall and F1 as their weighted means, in one
// launch. The (B, Tp, Tt) similarity is never written.
//
// Replaces torchmetrics_tpu/functional/text/bert.py:234-265
// (_bert_score_from_embeddings): the row normalisation with its 1e-12 clamp,
// the bph,bth->bpt einsum, the validity mask (an invalid entry is 0), both
// maxima over the whole padded axis, the weighted sums and P, R and F1 with
// their 1e-12 clamps. There is no TPU kernel.
//
// Bound on the card: 2 B Tp Tt H float32 operations (one fused multiply-add
// a term) at 67 TFLOP/s outside the tensor cores, or the embeddings read
// once at 3.35 TB/s (H100 SXM data sheet, 700 W), whichever is larger: at
// WMT16's 2,999 pairs padded to 128 tokens of roberta-large's 1,024 the
// operations, 1.5 ms against 0.94 ms for the bytes.
//
// What the design does about it:
// - a block a pair: the rows' inverse norms first (a warp a row), kept in
//   shared memory; then (Tp, Tt) tiles of 64 x 64, each thread summing 4 x 4
//   dot products in registers over H-chunks of 32 staged in shared memory for
//   both sides (rows and columns interleaved by 16, so that the chunk's reads
//   are free of bank conflicts); the similarity is the dot product times both
//   inverse norms;
// - a tile with no valid (row, column) pair skips its dot products: its
//   entries are all invalid, 0 whatever they would be (padding past the
//   lengths fills most tiles beyond the first);
// - each tile folds into running row maxima (Tp floats) and column maxima (Tt
//   floats) in shared memory through a 64 x 64 staging of the tile (the
//   chunks' space again), one thread a row or column: an invalid entry counts
//   as 0 and an entry past Tp or Tt not at all, as JAX's max over the padded
//   axis does;
// - P, R and F1 by fixed-order block reductions: two launches give the same
//   bits.
// The multiply-adds are float32 FMA; tensor cores come later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // tokens a tile side
constexpr int kChunk = 32;  // H a staged chunk
constexpr int kMicro = 4;   // rows (and columns) a thread's register tile
constexpr int kSpread = kTile / kMicro;  // 16: a thread's rows (columns) are kSpread apart
constexpr int kStageFloats = 2 * kTile * (kChunk + 1);  // both chunks; the tile's staging reuses them
static_assert(kTile * (kTile + 1) <= kStageFloats, "the tile's staging fits the chunks' space");
static_assert(kSpread * kSpread == kThreads, "a thread a (row, column) pair of the 16 x 16 grid");

__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];  // every thread, in one order
  return total;
}

// each row's 1 / max(||x||, 1e-12), a warp a row
__device__ void inverse_norms(const float* __restrict__ x, int rows, int h, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const float* row = x + static_cast<long long>(r) * h;
    float s = 0.0f;
    for (int k = lane; k < h; k += 32) s = fmaf(row[k], row[k], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[r] = 1.0f / fmaxf(sqrtf(s), 1e-12f);
  }
}

__global__ void __launch_bounds__(kThreads) bert_greedy_match_kernel(
    const float* __restrict__ pred, const float* __restrict__ tgt, const float* __restrict__ pred_mask,
    const float* __restrict__ tgt_mask, const float* __restrict__ pred_w, const float* __restrict__ tgt_w,
    int tp, int tt, int h, float* __restrict__ precision, float* __restrict__ recall, float* __restrict__ f1) {
  extern __shared__ float dyn[];
  float* inv_p = dyn;            // tp
  float* inv_t = inv_p + tp;     // tt
  float* row_max = inv_t + tt;   // tp
  float* col_max = row_max + tp; // tt
  __shared__ float stage[kStageFloats];
  __shared__ float scratch[kThreads / 32];
  float* a_chunk = stage;                          // [kTile][kChunk + 1] prediction rows
  float* b_chunk = stage + kTile * (kChunk + 1);   // [kTile][kChunk + 1] target rows
  float* tile = stage;                             // [kTile][kTile + 1] after the chunks

  const long long b = blockIdx.x;
  const float* p = pred + b * tp * h;
  const float* t = tgt + b * tt * h;
  const float* pm = pred_mask + b * tp;
  const float* tm = tgt_mask + b * tt;

  inverse_norms(p, tp, h, inv_p);
  inverse_norms(t, tt, h, inv_t);
  for (int i = threadIdx.x; i < tp; i += kThreads) row_max[i] = -INFINITY;
  for (int j = threadIdx.x; j < tt; j += kThreads) col_max[j] = -INFINITY;
  __syncthreads();

  const int ty = threadIdx.x / kSpread, tx = threadIdx.x % kSpread;
  for (int i0 = 0; i0 < tp; i0 += kTile) {
    for (int j0 = 0; j0 < tt; j0 += kTile) {
      float acc[kMicro][kMicro] = {};
      // a tile with no valid (row, column) pair holds only invalid entries, 0 whatever the dot products: skip them
      const bool rows_valid = __syncthreads_or(threadIdx.x < kTile && i0 + threadIdx.x < tp && pm[i0 + threadIdx.x] > 0.0f);
      const bool cols_valid = __syncthreads_or(threadIdx.x < kTile && j0 + threadIdx.x < tt && tm[j0 + threadIdx.x] > 0.0f);
      const int k_end = rows_valid && cols_valid ? h : 0;
      for (int k0 = 0; k0 < k_end; k0 += kChunk) {
        // stage the chunk: a warp reads kChunk consecutive floats of a row
        for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
          const int r = e / kChunk, k = e % kChunk;
          const bool in_k = k0 + k < h;
          a_chunk[r * (kChunk + 1) + k] = (i0 + r < tp && in_k) ? p[static_cast<long long>(i0 + r) * h + k0 + k] : 0.0f;
          b_chunk[r * (kChunk + 1) + k] = (j0 + r < tt && in_k) ? t[static_cast<long long>(j0 + r) * h + k0 + k] : 0.0f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kChunk; ++k) {
          float av[kMicro], bv[kMicro];
#pragma unroll
          for (int u = 0; u < kMicro; ++u) {
            av[u] = a_chunk[(ty + kSpread * u) * (kChunk + 1) + k];
            bv[u] = b_chunk[(tx + kSpread * u) * (kChunk + 1) + k];
          }
#pragma unroll
          for (int u = 0; u < kMicro; ++u)
#pragma unroll
            for (int w = 0; w < kMicro; ++w) acc[u][w] = fmaf(av[u], bv[w], acc[u][w]);
        }
        __syncthreads();
      }
      // the tile's values: the similarity where valid, 0 where not, -inf past the edges
#pragma unroll
      for (int u = 0; u < kMicro; ++u) {
        const int r = ty + kSpread * u, i = i0 + r;
#pragma unroll
        for (int w = 0; w < kMicro; ++w) {
          const int c = tx + kSpread * w, j = j0 + c;
          float value = -INFINITY;
          if (i < tp && j < tt) value = pm[i] * tm[j] > 0.0f ? acc[u][w] * inv_p[i] * inv_t[j] : 0.0f;
          tile[r * (kTile + 1) + c] = value;
        }
      }
      __syncthreads();
      if (threadIdx.x < kTile) {  // a row's maximum over the tile's columns
        const int i = i0 + threadIdx.x;
        if (i < tp) {
          float m = row_max[i];
          for (int c = 0; c < kTile; ++c) m = fmaxf(m, tile[threadIdx.x * (kTile + 1) + c]);
          row_max[i] = m;
        }
      } else if (threadIdx.x < 2 * kTile) {  // a column's over the tile's rows
        const int c = threadIdx.x - kTile, j = j0 + c;
        if (j < tt) {
          float m = col_max[j];
          for (int r = 0; r < kTile; ++r) m = fmaxf(m, tile[r * (kTile + 1) + c]);
          col_max[j] = m;
        }
      }
      __syncthreads();
    }
  }

  // P and R: the weighted means of the best matches of the valid tokens
  float sp = 0.0f, wp = 0.0f, sr = 0.0f, wr = 0.0f;
  for (int i = threadIdx.x; i < tp; i += kThreads) {
    const float mask = pm[i];
    const float weight = pred_w ? pred_w[b * tp + i] * mask : mask;
    sp += (mask > 0.0f ? row_max[i] : 0.0f) * weight;
    wp += weight;
  }
  for (int j = threadIdx.x; j < tt; j += kThreads) {
    const float mask = tm[j];
    const float weight = tgt_w ? tgt_w[b * tt + j] * mask : mask;
    sr += (mask > 0.0f ? col_max[j] : 0.0f) * weight;
    wr += weight;
  }
  sp = block_sum(sp, scratch);
  wp = block_sum(wp, scratch);
  sr = block_sum(sr, scratch);
  wr = block_sum(wr, scratch);
  if (threadIdx.x == 0) {
    const float prec = sp / fmaxf(wp, 1e-12f);
    const float rec = sr / fmaxf(wr, 1e-12f);
    precision[b] = prec;
    recall[b] = rec;
    f1[b] = 2.0f * prec * rec / fmaxf(prec + rec, 1e-12f);
  }
}

}  // namespace

// pred (B, Tp, H), tgt (B, Tt, H), pred_mask (B, Tp), tgt_mask (B, Tt) float32 and contiguous; pred_w and
// tgt_w the same shapes as the masks, or null (the masks weigh); precision, recall, f1 (B,) float32.
extern "C" int bert_match_launch(const float* pred, const float* tgt, const float* pred_mask,
                                        const float* tgt_mask, const float* pred_w, const float* tgt_w,
                                        long long batch, int tp, int tt, int h, float* precision, float* recall,
                                        float* f1, void* stream) {
  if (batch < 1 || batch > 2147483647LL || tp < 1 || tt < 1 || h < 1) return cudaErrorInvalidValue;
  // the rows' inverse norms and maxima: past the default 48 KB (with the static staging) only after the opt-in,
  // which holds for the current device
  const size_t dynamic = static_cast<size_t>(2 * (tp + tt)) * sizeof(float);
  if (dynamic + (kStageFloats + kThreads / 32) * sizeof(float) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(bert_greedy_match_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dynamic));
    if (err != cudaSuccess) return err;
  }
  bert_greedy_match_kernel<<<static_cast<unsigned int>(batch), kThreads, dynamic, static_cast<cudaStream_t>(stream)>>>(
      pred, tgt, pred_mask, tgt_mask, pred_w, tgt_w, tp, tt, h, precision, recall, f1);
  return cudaGetLastError();
}
