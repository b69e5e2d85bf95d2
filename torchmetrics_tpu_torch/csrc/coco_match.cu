// Greedy COCO detection <-> ground-truth matching: a block per item (or a
// share of its scans), a group of lanes per (area range, IoU threshold).
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
// invalid detection (valid_d = 0) changes no carry, so past the item's last
// valid detection every output is 0.
//
// What bounds it on the card: the least work reads the IoU rows of the valid
// detections, valid_d and the gt masks, and writes the two (B, A, T, D) byte
// maps: at mAP's chunk (B, D, G, A, T) = (1024, 64, 8, 4, 10), 2,474 valid
// rows, 5.44 MB, 1.6 us at 3.35 TB/s (H100 SXM data sheet, 700 W), the maps
// 96 % of it. The kernel does not reach that: each scan is a chain of
// dependent steps, and the time goes to the instructions each step issues
// (a vote, an argmax across lanes, the carry) and to the blocks' set-up.
//
// What the design does about it (each part ablated on an H100; PERF.md has
// the times and names the script):
// - the block finds its item's live extent d_live = 1 + the last valid
//   detection once, and scans and stages only d < d_live (valid_d need not
//   be a prefix, so the scan still tests it). mAP pads every item to the
//   chunk's largest D, so 96 % of its rows are padding;
// - a block stages its item's live IoU rows, valid_d bytes and gt flags
//   (as bit masks) in shared memory once for all of its scans: all A*T of
//   them where they fit 256 threads, else an even share. Blocks of 256
//   threads at most keep more blocks on an SM than one block an item does;
// - a scan runs on a group of P = max(8, next_pow2(G)) lanes for G <= 32
//   (32/P scans a warp), one ground truth a lane, the lanes past G idle (mAP
//   pads G to a multiple of 8, so it sends no G < 8); for G > 32, on a whole
//   warp with KPL ground truths a lane. A step is a few compares a lane,
//   two warp votes masked to the group and an argmax: log2(P) xor-shuffle
//   rounds (one `__reduce_max_sync` for P = 32) of an order-keeping integer
//   key of the IoU, then the highest lane of the group that holds the top
//   key (a second reduction of the index for KPL > 1). A lane a scan walking
//   the ground truths itself (P = 1) was slower at every G from 8 to 32;
// - a valid detection with no eligible ground truth in any group of a warp
//   skips the argmax: the test is warp-uniform, so the warp does not diverge;
// - the block stores the zeros past the live extent as 16-byte stores before
//   the scans start, and one lane of a group stores each step's two bytes as
//   it goes. Gathering a scan's bits into 16-byte stores (by a shared slab
//   after the scans, or by each group as it goes) was slower on mAP's chunk
//   and from G = 16, and won only where mAP sends nothing (G <= 8 at D = 128).
//
// Inputs are bytes (torch.bool is one byte, 0 or 1); outputs are uint8 maps
// that the wrapper views as bool. The launch plan (P, KPL, scans a block,
// shared memory) is chosen by the wrapper, kernels/coco_match.py.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStageBytes = 96 * 1024;  // shared memory a block may use for the IoU tile
constexpr int kMaxThreads = 256;  // threads of a block
constexpr unsigned kFull = 0xffffffffu;

// A key that orders as the float does, for any float but NaN; -0.0 and +0.0,
// equal as floats, get one key (adding +0.0f turns -0.0 into +0.0).
__device__ __forceinline__ unsigned ordered_key(float f) {
  const unsigned u = __float_as_uint(f + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ bool bit(const unsigned* words, int i) { return (words[i >> 5] >> (i & 31)) & 1u; }

// the largest value over each aligned group of P lanes
template <int P>
__device__ __forceinline__ unsigned group_max(unsigned x) {
  if constexpr (P == 32) {
    return __reduce_max_sync(kFull, x);
  } else {
#pragma unroll
    for (int off = P / 2; off > 0; off >>= 1) x = max(x, __shfl_xor_sync(kFull, x, off));
    return x;
  }
}

// At 8 ground truths a lane the scan would take 92 registers; held to 64, four
// blocks (32 warps) fit an SM, which hides the loads of a tile read from
// device memory (G = 256, D = 128: 1.20 -> 0.77 ms on an NVIDIA H100 80GB
// HBM3 at 700 W).
template <int P, int KPL>
__global__ void __launch_bounds__(kMaxThreads, KPL >= 8 ? 4 : 1)
    coco_match_kernel(const float* __restrict__ ious, const uint8_t* __restrict__ crowd,
                      const uint8_t* __restrict__ ignored, const uint8_t* __restrict__ valid_d,
                      const uint8_t* __restrict__ valid_g, const float* __restrict__ thrs,
                      uint8_t* __restrict__ matched, uint8_t* __restrict__ det_ignored, int D, int G, int A, int T,
                      int spb, int staged) {
  // shared memory, in this order: the (D, G) IoU tile (when staged), the gt
  // masks crowd, valid_g and ignored[A] of ceil(G/32) words each, the valid_d
  // bytes; its size is the launcher's `shared_bytes`
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_live;
  const int S = A * T;
  const int blocks_per_item = (S + spb - 1) / spb;
  const int b = blockIdx.x / blocks_per_item;
  const int s0 = (blockIdx.x % blocks_per_item) * spb;  // this block's scans: s0 .. s0 + n_scans - 1
  const int n_scans = min(spb, S - s0);
  const int W = (G + 31) >> 5;
  const int lane = threadIdx.x & 31;

  float* tile = reinterpret_cast<float*>(smem);
  unsigned* gt_bits = reinterpret_cast<unsigned*>(smem + (staged ? static_cast<size_t>(D) * G * sizeof(float) : 0));
  uint8_t* vd = reinterpret_cast<uint8_t*>(gt_bits + (2 + A) * W);

  if (threadIdx.x == 0) s_live = 0;
  __syncthreads();
  int live = 0;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const uint8_t v = valid_d[static_cast<size_t>(b) * D + i];
    vd[i] = v;
    if (v) live = i + 1;
  }
  live = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(live)));
  if (lane == 0 && live > 0) atomicMax(&s_live, live);
  // the gt flags as bit masks, a word a warp: crowd, valid_g, then ignored of each area
  for (int w = threadIdx.x >> 5; w < (2 + A) * W; w += blockDim.x >> 5) {
    const int row = w / W;
    const int g = (w % W) * 32 + lane;
    bool f = false;
    if (g < G) {
      f = row == 0   ? crowd[static_cast<size_t>(b) * G + g]
          : row == 1 ? valid_g[static_cast<size_t>(b) * G + g]
                     : ignored[(static_cast<size_t>(b) * A + (row - 2)) * G + g];
    }
    const unsigned word = __ballot_sync(kFull, f);
    if (lane == 0) gt_bits[w] = word;
  }
  __syncthreads();
  const int d_live = s_live;
  // The scans store the bytes before z, a byte a step from one lane of each
  // group. Every output from z on is 0: stored now by the block, 16 bytes a
  // store when D % 16 == 0 (rows 16-byte aligned).
  const int z = (D & 15) == 0 ? min(D, 16 * ((d_live + 15) >> 4)) : d_live;
  for (int o = 0; o < 2; ++o) {
    uint8_t* dst = (o == 0 ? matched : det_ignored) + (static_cast<size_t>(b) * S + s0) * D + z;
    if ((D & 15) == 0) {
      const int per_row = (D - z) >> 4;
      for (int c = threadIdx.x; c < n_scans * per_row; c += blockDim.x)
        reinterpret_cast<uint4*>(dst + static_cast<size_t>(c / per_row) * D)[c % per_row] = make_uint4(0, 0, 0, 0);
    } else {
      const int per_row = D - z;
      for (int e = threadIdx.x; e < n_scans * per_row; e += blockDim.x) dst[(e / per_row) * D + e % per_row] = 0;
    }
  }
  const float* item = ious + static_cast<size_t>(b) * D * G;
  if (staged) {
    for (int i = threadIdx.x; i < d_live * G; i += blockDim.x) tile[i] = item[i];
    item = tile;
  }
  __syncthreads();

  // this group's scan s = (a, t); a group past the block's scans runs with
  // no valid gt, so it votes nothing but keeps the warp's collectives whole
  const int grp = threadIdx.x / P;
  const int li = threadIdx.x & (P - 1);
  const int gbase = lane & ~(P - 1);
  unsigned gmask;
  if constexpr (P == 32) {
    gmask = kFull;
  } else {
    gmask = ((1u << P) - 1u) << gbase;
  }
  const bool active = grp < n_scans;
  const int s = s0 + (active ? grp : 0);
  const int a = s / T;
  const float thr_in = thrs[s % T];
  const float thr = thr_in > 1.0f ? 1.0f : thr_in;  // min(thr, 1.0f) that keeps a NaN threshold
  const unsigned* ign_w = gt_bits + (2 + a) * W;
  bool cr[KPL], ig[KPL], vg[KPL], done[KPL];
#pragma unroll
  for (int k = 0; k < KPL; ++k) {
    const int g = li + P * k;
    const bool in = g < G;
    cr[k] = in && bit(gt_bits, g);
    vg[k] = active && in && bit(gt_bits + W, g);
    ig[k] = in && bit(ign_w, g);
    done[k] = false;
  }

  const size_t out = (static_cast<size_t>(b) * S + s) * D;  // this scan's outputs
  for (int d = 0; d < d_live; ++d) {
    bool has = false, m_ign = false;
    if (vd[d]) {  // the same test in the whole block
      const float* row = item + static_cast<size_t>(d) * G;
      float v[KPL];
      bool non_ig[KPL], ig_elig[KPL];
      bool any_non = false, any_ig = false;
#pragma unroll
      for (int k = 0; k < KPL; ++k) {
        const int g = li + P * k;
        v[k] = g < G ? row[g] : 0.0f;
        const bool elig = g < G && v[k] >= thr && (!done[k] || cr[k]) && vg[k];
        non_ig[k] = elig && !ig[k];
        ig_elig[k] = elig && ig[k];
        any_non |= non_ig[k];
        any_ig |= ig_elig[k];
      }
      // both votes on every lane: the groups of a warp differ in `use_non`
      const unsigned non_votes = __ballot_sync(kFull, any_non) & gmask;
      const unsigned ig_votes = __ballot_sync(kFull, any_ig) & gmask;
      const bool use_non = non_votes != 0;
      has = (non_votes | ig_votes) != 0;
      if (__any_sync(kFull, has)) {
        float best = -INFINITY;
        int best_g = -1;
#pragma unroll
        for (int k = 0; k < KPL; ++k) {
          const int g = li + P * k;
          const float val = (use_non ? non_ig[k] : ig_elig[k]) ? v[k] : -INFINITY;
          if (g < G && val >= best) {  // g rises with k: a later equal value wins
            best = val;
            best_g = g;
          }
        }
        // (value, index) argmax over the group, the larger index winning a
        // tie: the largest order-keeping key, then the largest index among
        // the lanes that hold it (a lane with no gt: key 0, below any gt's)
        const unsigned key = best_g < 0 ? 0u : ordered_key(best);
        const unsigned top = group_max<P>(key);
        int m;
        if constexpr (KPL == 1) {  // g == li: the highest lane of the group holding the top key
          m = 31 - __clz(__ballot_sync(kFull, key == top) & gmask) - gbase;
        } else {
          m = static_cast<int>(group_max<P>(key == top ? static_cast<unsigned>(best_g + 1) : 0u)) - 1;
        }
        if (has) {
#pragma unroll
          for (int k = 0; k < KPL; ++k) {
            if (m == li + P * k) done[k] = true;
          }
          m_ign = bit(ign_w, m);
        }
      }
    }
    if (li == 0 && active) {  // the step's two bytes, stored as it goes
      matched[out + d] = has;
      det_ignored[out + d] = has && m_ign;
    }
  }
  if (active) {  // zeros from d_live up to z
    for (int d = d_live + li; d < z; d += P) {
      matched[out + d] = 0;
      det_ignored[out + d] = 0;
    }
  }
}

template <int P, int KPL>
int launch(const void* ious, const void* crowd, const void* ignored, const void* valid_d, const void* valid_g,
           const void* thrs, void* matched, void* det_ignored, int B, int D, int G, int A, int T, int spb, int staged,
           int smem, cudaStream_t stream) {
  auto kernel = coco_match_kernel<P, KPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = (spb * P + 31) / 32 * 32;
  const int blocks = B * ((A * T + spb - 1) / spb);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const float*>(ious), static_cast<const uint8_t*>(crowd), static_cast<const uint8_t*>(ignored),
      static_cast<const uint8_t*>(valid_d), static_cast<const uint8_t*>(valid_g), static_cast<const float*>(thrs),
      static_cast<uint8_t*>(matched), static_cast<uint8_t*>(det_ignored), D, G, A, T, spb, staged);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of the matcher on `stream`. The wrapper (kernels/coco_match.py)
// has checked every shape and type and chosen the plan: `p` lanes a scan
// (8, 16 or 32), `kpl` ground truths a lane, `spb` scans a block, `staged`
// whether the (D, G) tile fits kStageBytes, `smem` the block's dynamic shared
// memory in bytes (the launcher's `shared_bytes`). Returns the CUDA error
// code of the launch (0 on success), or -1 / -2 for a plan the source does
// not take.
extern "C" int coco_match_launch(const void* ious, const void* crowd, const void* ignored, const void* valid_d,
                                 const void* valid_g, const void* thrs, void* matched, void* det_ignored, int B,
                                 int D, int G, int A, int T, int p, int kpl, int spb, int staged, int smem,
                                 void* stream) {
  if (staged && static_cast<size_t>(D) * G * sizeof(float) > static_cast<size_t>(kStageBytes)) return -1;
  if (spb < 1 || spb * p > kMaxThreads || p * kpl < G) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define COCO_MATCH_CASE(P_, K_)                                                                                    \
  if (p == P_ && kpl == K_)                                                                                        \
    return launch<P_, K_>(ious, crowd, ignored, valid_d, valid_g, thrs, matched, det_ignored, B, D, G, A, T, spb, \
                          staged, smem, s);
  COCO_MATCH_CASE(8, 1)
  COCO_MATCH_CASE(16, 1)
  COCO_MATCH_CASE(32, 1)
  COCO_MATCH_CASE(32, 2)
  COCO_MATCH_CASE(32, 4)
  COCO_MATCH_CASE(32, 8)
#undef COCO_MATCH_CASE
  return -2;
}
