// Greedy COCO detection <-> ground-truth matching, one warp per
// (item, area range, IoU threshold).
//
// Replaces the XLA-lowered JAX matcher
// (torchmetrics_tpu/functional/detection/matcher.py:29-78: the lax.scan of
// `_match_one_threshold`, vmapped over thresholds, area ranges and items in
// `match_batch`). For each item b, area range a and threshold t the scan
// walks the detections d = 0..D-1 in score order with a per-gt "already
// matched" carry:
//
//   thr   = min(iou_thrs[t], 1.0f)         (JAX: jnp.minimum(thr, 1 - 1e-10) in float32)
//   elig  = iou[b, d, g] >= thr && (!gt_matched[g] || crowd[b, g]) && valid_g[b, g]
//   pool  = elig && !ignored[b, a, g]   if any such g,   else   elig && ignored[b, a, g]
//   m     = the last g of largest value among  (pool ? iou[b, d, g] : -inf),  g in [0, G)
//   has   = any(pool) && valid_d[b, d]
//   gt_matched[m] |= has;   matched[b, a, t, d] = has;   det_ignored[b, a, t, d] = has && ignored[b, a, m]
//
// The last index wins ties, as `(G - 1) - argmax(vals[::-1])` does; every g
// of the padded row takes part in the argmax, as in the JAX function. An
// invalid detection (valid_d = 0) changes no carry.
//
// Bound on the card: the call must read the IoUs (B*D*G*4 bytes) and the
// masks and write two (B, A, T, D) byte maps: 27.6 MB at the COCO chunk
// B=1024, D=128, G=32, A=4, T=10, 8.2 us at 3.35 TB/s (H100 SXM data sheet,
// 700 W); a compare and an argmax step per (b, a, t, d, g) of a valid
// detection, at most 336 M operations, take at most 5.0 us at 67 TFLOP/s.
// Each warp's D steps form a dependent chain: a step cannot start before the
// previous one has set its match.
//
// What the design does about it:
// - a block takes one (b, a) and T warps, one per threshold; it stages the
//   item's (D, G) IoU tile and its valid_d bytes in shared memory once for
//   its T warps (the tile when it fits kStageBytes), so the IoUs are read
//   from device memory A times, not A*T times, and a step waits on no
//   device-memory load;
// - lane l of a warp holds ground truths l, l + 32, ... (KPL of them, in
//   registers: crowd, ignored, valid and matched bits), so a step is a few
//   compares a lane, two warp votes and an argmax of two single-instruction
//   warp reductions (`__reduce_max_sync` of an order-keeping integer key of
//   the IoU, then of the index among the lanes that hold the maximum; a
//   ballot in place of the second when a lane holds one gt). A first form
//   reduced (value, index) pairs in 5 rounds of two shuffles: 0.4286 ms at
//   the COCO chunk after an L2 flush (NVIDIA H100 80GB HBM3, 700 W; this
//   form's time is in PERF.md);
// - a padded detection, or one with no eligible ground truth, skips the
//   argmax: the test is the same on every lane, so the warp does not diverge;
// - the outputs of 32 consecutive detections are held one a lane and
//   written together, 32 bytes a store.
//
// Inputs are bytes (torch.bool is one byte, 0 or 1); outputs are uint8 maps
// that the wrapper views as bool.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStageBytes = 96 * 1024;  // shared memory a block may use for the IoU tile
constexpr unsigned kFull = 0xffffffffu;

// A key that orders as the float does, for any float but NaN; -0.0 and +0.0,
// equal as floats, get one key (adding +0.0f turns -0.0 into +0.0).
__device__ __forceinline__ unsigned ordered_key(float f) {
  const unsigned u = __float_as_uint(f + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int KPL>
__global__ void coco_match_kernel(const float* __restrict__ ious, const uint8_t* __restrict__ crowd,
                                  const uint8_t* __restrict__ ignored, const uint8_t* __restrict__ valid_d,
                                  const uint8_t* __restrict__ valid_g, const float* __restrict__ thrs,
                                  uint8_t* __restrict__ matched, uint8_t* __restrict__ det_ignored, int D, int G,
                                  int A, int T, int staged) {
  extern __shared__ float tile[];
  const int b = blockIdx.x / A;
  const int a = blockIdx.x % A;
  const int t = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* item = ious + static_cast<size_t>(b) * D * G;
  // shared memory: the (D, G) IoU tile when staged, then the item's D valid_d bytes
  uint8_t* vd = reinterpret_cast<uint8_t*>(tile + (staged ? D * G : 0));
  for (int i = threadIdx.x; i < D; i += blockDim.x) vd[i] = valid_d[static_cast<size_t>(b) * D + i];
  if (staged) {
    for (int i = threadIdx.x; i < D * G; i += blockDim.x) tile[i] = item[i];
    item = tile;
  }
  __syncthreads();

  // min(thr, 1.0f) that keeps a NaN threshold, as jnp.minimum does
  const float thr = thrs[t] > 1.0f ? 1.0f : thrs[t];
  // this lane's ground truths g = lane + 32 * k
  bool cr[KPL], ig[KPL], vg[KPL], done[KPL];
  unsigned ig_bits[KPL];  // the warp's ignored flags of gts 32k .. 32k + 31
#pragma unroll
  for (int k = 0; k < KPL; ++k) {
    const int g = lane + 32 * k;
    const bool in = g < G;
    cr[k] = in && crowd[static_cast<size_t>(b) * G + g];
    ig[k] = in && ignored[(static_cast<size_t>(b) * A + a) * G + g];
    vg[k] = in && valid_g[static_cast<size_t>(b) * G + g];
    done[k] = false;
    ig_bits[k] = __ballot_sync(kFull, ig[k]);
  }
  const size_t out_row = ((static_cast<size_t>(b) * A + a) * T + t) * D;
  uint8_t my_m = 0, my_i = 0;

  for (int d = 0; d < D; ++d) {
    // `has` is false for an invalid detection or an empty pool: then the
    // argmax is not needed and no carry changes (both tests are warp-uniform)
    bool has = vd[d];
    bool m_ignored = false;
    if (has) {
      const float* row = item + static_cast<size_t>(d) * G;
      float v[KPL];
      bool non_ig[KPL], ig_elig[KPL];
      bool any_non = false, any_ig = false;
#pragma unroll
      for (int k = 0; k < KPL; ++k) {
        const int g = lane + 32 * k;
        v[k] = g < G ? row[g] : 0.0f;
        const bool elig = g < G && v[k] >= thr && (!done[k] || cr[k]) && vg[k];
        non_ig[k] = elig && !ig[k];
        ig_elig[k] = elig && ig[k];
        any_non |= non_ig[k];
        any_ig |= ig_elig[k];
      }
      any_non = __any_sync(kFull, any_non);
      has = any_non || __any_sync(kFull, any_ig);
      if (has) {
        float best = -INFINITY;
        int best_g = -1;
#pragma unroll
        for (int k = 0; k < KPL; ++k) {
          const int g = lane + 32 * k;
          const float val = (any_non ? non_ig[k] : ig_elig[k]) ? v[k] : -INFINITY;
          if (g < G && val >= best) {  // g rises with k: a later equal value wins
            best = val;
            best_g = g;
          }
        }
        // (value, index) argmax over the warp, the larger index winning a tie:
        // the largest value by one reduction of order-keeping keys, then the
        // largest index among the lanes that hold it (a lane with no gt: key 0)
        const unsigned key = best_g < 0 ? 0u : ordered_key(best);
        const unsigned top = __reduce_max_sync(kFull, key);
        int m;
        if (KPL == 1) {  // g == lane: the highest lane holding the top value
          m = 31 - __clz(__ballot_sync(kFull, key == top));
        } else {
          m = static_cast<int>(__reduce_max_sync(kFull, key == top ? static_cast<unsigned>(best_g + 1) : 0u)) - 1;
        }
#pragma unroll
        for (int k = 0; k < KPL; ++k) {
          if (m == lane + 32 * k) done[k] = true;
          if ((m >> 5) == k) m_ignored = (ig_bits[k] >> (m & 31)) & 1u;
        }
      }
    }
    if (lane == (d & 31)) {
      my_m = has;
      my_i = has && m_ignored;
    }
    if ((d & 31) == 31 || d == D - 1) {
      const int d0 = d & ~31;
      if (d0 + lane <= d) {
        matched[out_row + d0 + lane] = my_m;
        det_ignored[out_row + d0 + lane] = my_i;
      }
    }
  }
}

template <int KPL>
int launch(const void* ious, const void* crowd, const void* ignored, const void* valid_d, const void* valid_g,
           const void* thrs, void* matched, void* det_ignored, int B, int D, int G, int A, int T, int staged,
           cudaStream_t stream) {
  const size_t smem = (staged ? static_cast<size_t>(D) * G * sizeof(float) : 0) + D;
  auto kernel = coco_match_kernel<KPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B * A, 32 * T, smem, stream>>>(
      static_cast<const float*>(ious), static_cast<const uint8_t*>(crowd), static_cast<const uint8_t*>(ignored),
      static_cast<const uint8_t*>(valid_d), static_cast<const uint8_t*>(valid_g), static_cast<const float*>(thrs),
      static_cast<uint8_t*>(matched), static_cast<uint8_t*>(det_ignored), D, G, A, T, staged);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of the matcher on `stream`. The wrapper (kernels/coco_match.py)
// has checked every shape and type; `kpl` is ceil(G / 32) rounded up to 1, 2,
// 4 or 8, `staged` whether the (D, G) tile fits kStageBytes. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int coco_match_launch(const void* ious, const void* crowd, const void* ignored, const void* valid_d,
                                 const void* valid_g, const void* thrs, void* matched, void* det_ignored, int B,
                                 int D, int G, int A, int T, int kpl, int staged, void* stream) {
  if (staged && static_cast<size_t>(D) * G * sizeof(float) > static_cast<size_t>(kStageBytes)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kpl) {
    case 1: return launch<1>(ious, crowd, ignored, valid_d, valid_g, thrs, matched, det_ignored, B, D, G, A, T, staged, s);
    case 2: return launch<2>(ious, crowd, ignored, valid_d, valid_g, thrs, matched, det_ignored, B, D, G, A, T, staged, s);
    case 4: return launch<4>(ious, crowd, ignored, valid_d, valid_g, thrs, matched, det_ignored, B, D, G, A, T, staged, s);
    case 8: return launch<8>(ious, crowd, ignored, valid_d, valid_g, thrs, matched, det_ignored, B, D, G, A, T, staged, s);
    default: return -2;
  }
}
