// The exact pairwise intersections and areas of segmentation masks: for each
// image, inter[d, g] = #pixels set in detection mask d and ground-truth mask g,
// det_area[d] and gt_area[g] = #pixels set in each mask, int32, from bool
// (one byte a pixel) masks (D, H, W) and (G, H, W), several images a launch.
//
// Replaces the float64 product of torchmetrics_tpu/detection/mean_ap.py:65-76
// (`_mask_iou_crowd`: `d @ g.T` over (D, H*W) float64 copies of the masks and
// the two row sums), which segm mAP runs for every (class, image) item
// (:526-527). The counts are exact integers, so the IoU the caller takes from
// them in float64 is that product's bit for bit.
//
// Bound on the card: bytes. Every mask byte is read once, (D + G) H W bytes an
// image: 32.9 MB at a COCO image of 100 detections and 7 ground truths of
// 480 x 640, 9.8 us at 3.35 TB/s. The pairs' work, D G H W / 32 AND-popcounts,
// is 6.7e6 words at that image.
//
// What the design does about it:
// - the launch is a list of entries (a block of an image's detections against
//   a block of its ground truths, at most kMaxMasks masks together) and a grid
//   of chunks of pixels: a block owns one chunk of one entry, found by a binary
//   search over the entries' first blocks. The launcher cuts the chunks finer
//   (down to 512 pixels) while the grid has fewer than two blocks an SM;
// - a block packs its chunk of every mask of the entry into bits in shared
//   memory, a warp a mask at a time: each lane reads 16 bytes of a group of
//   512 pixels (one 16-byte load where the mask is 16-byte aligned, 16 byte
//   loads otherwise), kInFlight groups before their ballots, and 16
//   `__ballot_sync` make the group's 16 words: bit `lane` of word k is pixel
//   16 lane + k. Every mask takes the same order, so the AND of two masks'
//   words pairs the same pixels. Pixels past the mask's end are zero bits, so
//   H W need not be a multiple of 32 (PASCAL's 375 x 500);
// - the warp counts its mask's bits in the chunk and writes the area once (no
//   shared atomics: one writer a mask); after the block's barrier one global
//   atomic a mask and chunk adds it
//   (entries of the first ground-truth block write the detections' areas,
//   those of the first detection block the ground truths');
// - a thread a pair then sums `__popc(det & gt)` over the chunk's words from
//   shared memory (rows of an odd stride: the lanes of a warp, one ground
//   truth each, read different banks) and adds a non-zero sum into the
//   pair's global int32 count. The counts are integers, so their order of
//   addition does not change them: the result is deterministic.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;           // words of a group: 512 pixels, 16 a lane
constexpr int kInFlight = 4;         // groups a warp loads before it ballots them
constexpr int kSharedWords = 12032;  // a block's packed bits: 47 KB, with the areas under the 48 KB static limit
constexpr int kMaxMasks = 256;       // detections and ground truths of an entry together
constexpr int kMaxWords = 1024;      // words of a mask in a chunk: 32,768 pixels

struct Entry {
  long long det;          // const uint8_t*: the entry's first detection mask
  long long gt;           // const uint8_t*: its first ground-truth mask
  long long inter;        // int*: the count of (its first detection, its first ground truth)
  long long det_area;     // int*: its first detection's area, or 0 where another entry writes it
  long long gt_area;      // int*: its first ground truth's area, or 0
  long long n_det;
  long long n_gt;
  long long hw;           // pixels a mask
  long long row_stride;   // counts between two detections' rows: the image's ground truths
  long long words;        // words of a mask a chunk
  long long first_block;  // the entry's first block of the grid
  long long pad;
};

__global__ void __launch_bounds__(kThreads) mask_iou_kernel(const Entry* __restrict__ entries, int n_entries) {
  __shared__ unsigned int bits[kSharedWords];
  __shared__ int areas[kMaxMasks];

  int lo = 0, hi = n_entries - 1;
  const long long block = blockIdx.x;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (entries[mid].first_block <= block) lo = mid; else hi = mid - 1;
  }
  const Entry e = entries[lo];
  const int n_det = static_cast<int>(e.n_det);
  const int n_gt = static_cast<int>(e.n_gt);
  const int n_masks = n_det + n_gt;
  const int words = static_cast<int>(e.words);
  const int stride = words | 1;
  const long long px0 = (block - e.first_block) * words * 32;
  const long long px_end = px0 + static_cast<long long>(words) * 32 < e.hw ? px0 + static_cast<long long>(words) * 32
                                                                             : e.hw;
  const uint8_t* det = reinterpret_cast<const uint8_t*>(e.det);
  const uint8_t* gt = reinterpret_cast<const uint8_t*>(e.gt);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = words / kGroup;

  // pack: a warp a mask; lane l's 16 bytes of a group are pixels 16 l .. 16 l + 15 of its 512
  for (int m = warp; m < n_masks; m += kWarps) {
    const uint8_t* row = m < n_det ? det + static_cast<long long>(m) * e.hw
                                   : gt + static_cast<long long>(m - n_det) * e.hw;
    const bool aligned = (reinterpret_cast<std::uintptr_t>(row) & 15) == 0;
    int area = 0;
    for (int g0 = 0; g0 < groups; g0 += kInFlight) {
      uint4 q[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        q[u] = make_uint4(0u, 0u, 0u, 0u);
        const long long px = px0 + static_cast<long long>(g0 + u) * (kGroup * 32) + 16 * lane;
        if (g0 + u < groups && px < px_end) {
          if (aligned && px + 16 <= px_end) {
            q[u] = __ldg(reinterpret_cast<const uint4*>(row + px));
          } else {  // a mask off the 16-byte grid, or its last group: byte loads, zeros past its end
            unsigned int w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int k = 0; k < 16; ++k) {
              if (px + k < px_end) w[k / 4] |= static_cast<unsigned int>(__ldg(row + px + k)) << (8 * (k % 4));
            }
            q[u] = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (g0 + u >= groups) break;  // warp-uniform
        const unsigned int part[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
        unsigned int mine = 0u;
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const unsigned int word = __ballot_sync(0xffffffffu, ((part[k / 4] >> (8 * (k % 4))) & 0xffu) != 0u);
          area += __popc(word);
          if (lane == k) mine = word;
        }
        if (lane < kGroup) bits[m * stride + (g0 + u) * kGroup + lane] = mine;
      }
    }
    if (lane == 0) areas[m] = area;
  }
  __syncthreads();

  int* det_area = reinterpret_cast<int*>(e.det_area);
  int* gt_area = reinterpret_cast<int*>(e.gt_area);
  for (int m = threadIdx.x; m < n_masks; m += kThreads) {
    const int a = areas[m];
    if (a == 0) continue;
    if (m < n_det) {
      if (det_area) atomicAdd(det_area + m, a);
    } else if (gt_area) {
      atomicAdd(gt_area + (m - n_det), a);
    }
  }

  int* inter = reinterpret_cast<int*>(e.inter);
  const int pairs = n_det * n_gt;
  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    const int d = p / n_gt;
    const int g = p - d * n_gt;
    const unsigned int* a = bits + d * stride;
    const unsigned int* b = bits + (n_det + g) * stride;
    int acc = 0;
    for (int j = 0; j < words; ++j) acc += __popc(a[j] & b[j]);
    if (acc) atomicAdd(inter + static_cast<long long>(d) * e.row_stride + g, acc);
  }
}

}  // namespace

// entries: a device array of n_entries Entry records (12 int64 each), in order
// of first_block; blocks: the grid's size. The counts and areas must be zero.
extern "C" int mask_iou_launch(const void* entries, int n_entries, long long blocks, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_entries < 1 || blocks < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  mask_iou_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(static_cast<const Entry*>(entries),
                                                                             n_entries);
  return static_cast<int>(cudaGetLastError());
}
