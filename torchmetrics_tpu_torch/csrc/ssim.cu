// Per-image SSIM (and the contrast-sensitivity mean MS-SSIM needs) of a
// (B, C, H, W) float32 batch in one launch, optionally with the full map.
//
// Replaces the XLA-lowered body of the JAX package's `_ssim_update` for 4-D
// inputs (torchmetrics_tpu/functional/image/ssim.py:111-165): reflect-pad
// both inputs by pad = (win - 1) / 2, stack (p, t, p*p, t*t, p*t), one
// depthwise convolution with the 2-D window, the SSIM map, a crop of pad on
// every side, and the per-image mean. For a window w (the outer product of
// a row window w_h of kh taps and a column window w_w of kw taps):
//
//   mu_p = sum w p,  mu_t = sum w t,  s_pp = sum w p^2 - mu_p^2,  s_tt likewise,
//   s_pt = sum w p t - mu_p mu_t   (s_pp, s_tt clamped at 0)
//   upper = 2 s_pt + c2,  lower = s_pp + s_tt + c2
//   ssim  = (2 mu_p mu_t + c1) upper / ((mu_p^2 + mu_t^2 + c1) lower),  cs = upper / lower
//
// per image the mean over the channels and the positions i in [ph, H - ph),
// j in [pw, W - pw) (none when a pad is 0, as the JAX crop x[0:-0] keeps
// nothing: the mean is then NaN).
//
// The simplification, checked: the JAX package pads by `pad`, convolves
// VALID and crops `pad` again, so every position that enters the mean reads
// only pixels of the unpadded input (its window spans [i - ph, i + ph] within
// [0, H)). The kernel reads the inputs unpadded, once, and makes no padded
// copy; only the full map (`return_full_image`) needs the reflected border,
// which its tiles at the edges read by reflecting the index.
//
// Bound on the card: both inputs read once (8 bytes a pixel), a mean an image
// written (and 4 bytes a pixel for the full map); about 7 operations a tap of
// the row pass and 5 of the column pass a pixel, with 20 for the map: fp32
// arithmetic binds at an 11-tap window (5.84 G operations at DIV2K's batch,
// 87 us at 67 TFLOP/s). This design runs the row pass in fp32 (9 operations a
// tap with its shift, 33.2 M x 11 x 9 x 74 / 64 = 3.80 G at DIV2K's batch, 57 us
// at 67 TFLOP/s) and the column pass and the map in fp64 (5 fused
// multiply-adds a tap, 8 operations a row of the column pass to rebase it and
// about 20 for the map, each counted twice: 2 x 33.2 M x (55 + 8 x 18 / 8 +
// 20) = 6.17 G, 181 us at the data sheet's 34 TFLOP/s fp64 outside the tensor
// cores); its own bound is the sum, 238 us (chip_smoke.py's mixed_bound_ms).
//
// What the design does about it:
// - the window applied separably: a row pass (kw taps) over the tile and its
//   halo of ph rows, into shared memory, then a column pass (kh taps): 7 kw +
//   5 kh operations a pixel instead of the 2-D window's 5 kh kw;
// - the row pass in float32 about a shift: each row window's moments are
//   taken of x - s with s its own centre pixel, so the float32 sums see only
//   the window's spread (float32 sums about no shift put the map 2e-5 to 9e-5
//   from a float64 evaluation, and about the tile's mean 7e-5 on a step next
//   to a flat region); the column pass rebases each row window's moments in
//   double (sum w x = A + s W, sum w x^2 = B + s (2 A + s W), with W the
//   float32 row taps' sum) and sums them with the column taps divided by W, so
//   the window's weights sum to 1 in double and E[x^2] - mu^2 cancels in
//   double (a numpy model of this arithmetic lies within 5.3e-7 of a float64
//   evaluation on every image of tests/test_torch_image.py);
// - register blocking: a row-pass thread slides the window over 4 outputs of
//   its row (each input read once a thread; 8 ran 0.76 against 0.72 ms at
//   DIV2K's batch), a column-pass thread sums 8 consecutive output rows of
//   its column (each row of the row pass read once for the 8, kh + 7 reads; 4
//   a thread, tiles of 32 x 32, ran 0.87-0.98 ms); at 11 taps both passes are
//   unrolled in full;
// - one block of 256 threads a tile of 32 x 64 outputs of one (image,
//   channel) plane: the input tile and its halo (float32, the row stride odd)
//   and the five row moments (float32, a row of 33) in shared memory,
//   74,432 bytes at 11 taps, every shared access free of bank conflicts;
// - the tile loaded by rows, a warp a row, with no divide, by asynchronous
//   copies (cp.async), every copy of a thread in flight at once (loads and
//   stores, a row at a time, ran 1.03 against 0.76 ms at DIV2K's batch; a
//   block walking over tiles with the next tile's copies in flight ran no
//   faster, 0.705 against 0.701 ms with one buffer);
// - a thread's outputs summed in float32 before the block's double sum, and
//   the contrast sensitivity's quotient taken only where it is asked for
//   (0.693 ms at DIV2K's batch with them, 0.721 before them, two calls);
//   only tiles whose window crosses the border (those of the full map at the
//   edges, and the last of each row and column) reflect the index; the inputs
//   are clamped to the data range when one is given as a tuple;
// - c1 and c2 read from the device where the data range is None (max - min
//   of the data: the host never waits for it), else passed by value (a copy
//   to the device would wait for the stream);
// - each block's sums of ssim and cs in double into a partial of its image,
//   the last block (an acquire-release ticket) adds the partials of each
//   image in a fixed order: the result is the same bit for bit every launch.
//
// Device work of one call, on the caller's stream: one kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileW = 32;                 // output columns a block: a warp's lanes
constexpr int kWarps = 8;
constexpr int kThreads = kTileW * kWarps;  // 256
constexpr int kColRows = 8;                // consecutive output rows a column-pass thread
constexpr int kTileH = kWarps * kColRows;  // output rows a block: kernels/ssim.py's TILE_H
constexpr int kRowOuts = 4;                // consecutive outputs a row-pass thread
constexpr int kMinBlocks = 2;              // blocks an SM the registers are sized for: 128 a thread
constexpr int kSegments = kTileW / kRowOuts;  // row-pass threads a row
constexpr int kRowStride = kTileW + 1;        // the row moments' row: conflict-free row-pass stores

struct Args {
  const float* preds;   // (B, C, H, W)
  const float* target;
  const double* taps_h;  // kh taps along H
  const double* taps_w;  // kw taps along W
  const float* consts;  // c1, c2 on the device, or null: then c1, c2 below
  float c1, c2;
  float* out_ssim;      // (B,)
  float* out_cs;        // (B,) or null
  float* full;          // (B, C, H, W) or null
  double* partials;     // (B, blocks an image, 2)
  int* ticket;
  int channels, height, width;
  int kh, kw, ph, pw;
  int row0, col0;       // the first output position the grid covers
  int rows, cols;       // outputs the grid covers: the valid interior, or all of it for the full map
  int has_clamp;
  float lo, hi;
  double count;         // positions an image enters the mean (channels x interior), 0 for none
};

__shared__ double s_red[2][kThreads / 32];

// numpy's "reflect" index (no edge repeat) for |i| within one period, then clamped: positions past
// the reflected border feed only outputs the grid does not write.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ float clamp_to(const Args& a, float v) {
  return v == v ? fminf(fmaxf(v, a.lo), a.hi) : v;  // jnp.clip keeps NaN
}

// An asynchronous 4-byte copy from global to shared memory: every copy of a thread is in flight at
// once, and the thread waits for its own with cp.async.wait_all.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(to), "l"(src) : "memory");
}

// atomicAdd(p, 1) at device scope with acquire-release order: the partials a barrier ordered
// before it are released with it, and the block that takes the last ticket acquires them all.
__device__ __forceinline__ int ticket_acq_rel(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// Fixed-order block sums of two doubles; thread 0 gets them.
__device__ void block_sum2(double& x, double& y) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    x += __shfl_xor_sync(kFull, x, offset);
    y += __shfl_xor_sync(kFull, y, offset);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // s_red may still be read from a previous call
  if (lane == 0) {
    s_red[0][warp] = x;
    s_red[1][warp] = y;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    x = y = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) {
      x += s_red[0][w];
      y += s_red[1][w];
    }
  }
}

// The row pass of one row: kRowOuts consecutive outputs, each the kw-tap window of x - s and its
// products, s the window's centre pixel, in float32; the window slides in registers.
template <int K>
__device__ __forceinline__ void row_pass(const float* rp, const float* rt, const float* taps, int kw_dyn, int pw,
                                         float* out, int plane) {
  const int kw = K ? K : kw_dyn;
  float sp[kRowOuts], st[kRowOuts], xp[kRowOuts], xt[kRowOuts], m[kRowOuts][5];
#pragma unroll
  for (int r = 0; r < kRowOuts; ++r) {
    sp[r] = rp[r + pw];
    st[r] = rt[r + pw];
    xp[r] = rp[r];
    xt[r] = rt[r];
#pragma unroll
    for (int k = 0; k < 5; ++k) m[r][k] = 0.0f;
  }
#pragma unroll(K ? K : 1)
  for (int b = 0; b < kw; ++b) {
    const float w = taps[b];
#pragma unroll
    for (int r = 0; r < kRowOuts; ++r) {
      const float dp = xp[r] - sp[r], dt = xt[r] - st[r];
      const float wp = w * dp, wt = w * dt;
      m[r][0] += wp;
      m[r][1] += wt;
      m[r][2] = fmaf(wp, dp, m[r][2]);
      m[r][3] = fmaf(wt, dt, m[r][3]);
      m[r][4] = fmaf(wp, dt, m[r][4]);
    }
    if (b + 1 < kw) {
#pragma unroll
      for (int r = 0; r + 1 < kRowOuts; ++r) {
        xp[r] = xp[r + 1];
        xt[r] = xt[r + 1];
      }
      xp[kRowOuts - 1] = rp[b + kRowOuts];
      xt[kRowOuts - 1] = rt[b + kRowOuts];
    }
  }
#pragma unroll
  for (int r = 0; r < kRowOuts; ++r) {
#pragma unroll
    for (int k = 0; k < 5; ++k) out[k * plane + r] = m[r][k];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks) ssim_window_kernel(Args a) {
  extern __shared__ double smem[];
  const int kh = K ? K : a.kh, kw = K ? K : a.kw, ph = (kh - 1) / 2, pw = (kw - 1) / 2;
  const int in_h = kTileH + 2 * ph, in_w = kTileW + 2 * pw, in_s = in_w | 1;  // odd stride: no bank conflicts
  const int plane = in_h * kRowStride;
  double* s_taps_h = smem;                                   // kh: the column taps over W
  float* s_taps_w = reinterpret_cast<float*>(s_taps_h + kh);  // kw, float32
  float* s_p = s_taps_w + ((kw + 1) & ~1);                    // in_h x in_s
  float* s_t = s_p + in_h * in_s;                            // in_h x in_s
  float* s_row = s_t + in_h * in_s;                          // 5 x in_h x kRowStride

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int plane_index = blockIdx.z;      // image * channels + channel
  const int image = plane_index / a.channels;
  const long long plane_size = static_cast<long long>(a.height) * a.width;
  const float* p_plane = a.preds + plane_index * plane_size;
  const float* t_plane = a.target + plane_index * plane_size;
  const int oy = a.row0 + blockIdx.y * kTileH, ox = a.col0 + blockIdx.x * kTileW;

  for (int i = t; i < kw; i += kThreads) s_taps_w[i] = static_cast<float>(a.taps_w[i]);
  // the tile by rows, a warp a row; only a window that crosses the border reflects its index
  const int y_first = oy - ph, x_first = ox - pw;
  const bool inside = y_first >= 0 && x_first >= 0 && y_first + in_h <= a.height && x_first + in_w <= a.width;
  for (int y = warp; y < in_h; y += kWarps) {
    const int gy = inside ? y_first + y : reflect(y_first + y, a.height);
    const float* prow = p_plane + static_cast<long long>(gy) * a.width;
    const float* trow = t_plane + static_cast<long long>(gy) * a.width;
    for (int x = lane; x < in_w; x += 32) {
      const int gx = inside ? x_first + x : reflect(x_first + x, a.width);
      copy_async(s_p + y * in_s + x, prow + gx);
      copy_async(s_t + y * in_s + x, trow + gx);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  if (a.has_clamp) {  // each thread its own copies
    for (int y = warp; y < in_h; y += kWarps) {
      for (int x = lane; x < in_w; x += 32) {
        s_p[y * in_s + x] = clamp_to(a, s_p[y * in_s + x]);
        s_t[y * in_s + x] = clamp_to(a, s_t[y * in_s + x]);
      }
    }
  }
  __syncthreads();
  // the float32 row taps' sum, in double: the column taps are divided by it
  double w_sum = 0.0;
  for (int b = 0; b < kw; ++b) w_sum += s_taps_w[b];
  for (int i = t; i < kh; i += kThreads) s_taps_h[i] = a.taps_h[i] / w_sum;

  // row pass: kRowOuts outputs of one row of the tile and its halo a task
  for (int task = t; task < in_h * kSegments; task += kThreads) {
    const int y = task / kSegments, c = (task % kSegments) * kRowOuts;
    row_pass<K>(s_p + y * in_s + c, s_t + y * in_s + c, s_taps_w, kw, pw, s_row + y * kRowStride + c, plane);
  }
  __syncthreads();

  // column pass and the map: kColRows consecutive outputs a thread, each row of the row pass read
  // once for all of them and rebased in double to moments about 0
  const double c1 = a.consts ? a.consts[0] : a.c1, c2 = a.consts ? a.consts[1] : a.c2;
  const int y0 = warp * kColRows, gx = ox + lane;
  double m[kColRows][5];
#pragma unroll
  for (int j = 0; j < kColRows; ++j) {
#pragma unroll
    for (int k = 0; k < 5; ++k) m[j][k] = 0.0;
  }
#pragma unroll(K ? K + kColRows - 1 : 1)
  for (int r = 0; r < kh + kColRows - 1; ++r) {
    const int y = y0 + r, o = y * kRowStride + lane;
    const double ap = s_row[o], at = s_row[plane + o], bpp = s_row[2 * plane + o], btt = s_row[3 * plane + o],
                 bpt = s_row[4 * plane + o];
    const double sp = s_p[y * in_s + lane + pw], st = s_t[y * in_s + lane + pw];
    const double r1p = fma(sp, w_sum, ap), r1t = fma(st, w_sum, at);
    const double v[5] = {r1p, r1t, fma(sp, ap + r1p, bpp), fma(st, at + r1t, btt), fma(sp, at, fma(st, r1p, bpt))};
#pragma unroll
    for (int j = 0; j < kColRows; ++j) {
      const int tap = r - j;
      if (tap >= 0 && tap < kh) {
        const double w = s_taps_h[tap];
#pragma unroll
        for (int k = 0; k < 5; ++k) m[j][k] = fma(w, v[k], m[j][k]);
      }
    }
  }
  // the thread's few outputs summed in float32, then in double over the block
  const bool need_cs = a.out_cs != nullptr;
  float acc_ssim = 0.0f, acc_cs = 0.0f;
#pragma unroll
  for (int j = 0; j < kColRows; ++j) {
    const int gy = oy + y0 + j;
    if (gy >= a.row0 + a.rows || gx >= a.col0 + a.cols) continue;
    const double mu_p = m[j][0], mu_t = m[j][1], e_pp = m[j][2], e_tt = m[j][3], e_pt = m[j][4];
    const double mu_p_sq = mu_p * mu_p, mu_t_sq = mu_t * mu_t, mu_pt = mu_p * mu_t;
    const double upper = 2.0 * (e_pt - mu_pt) + c2;
    const double lower = fmax(e_pp - mu_p_sq, 0.0) + fmax(e_tt - mu_t_sq, 0.0) + c2;
    // the quotients in float32: the cancelling differences are taken, and a float32 divide is a few
    // instructions where a double one is a subroutine
    const float ssim = static_cast<float>((2.0 * mu_pt + c1) * upper) / static_cast<float>((mu_p_sq + mu_t_sq + c1) * lower);
    if (a.full) a.full[plane_index * plane_size + static_cast<long long>(gy) * a.width + gx] = ssim;
    if (gy >= ph && gy < a.height - ph && gx >= pw && gx < a.width - pw && ph > 0 && pw > 0) {
      acc_ssim += ssim;
      if (need_cs) acc_cs += static_cast<float>(upper) / static_cast<float>(lower);
    }
  }

  // the block's sums into its image's partials; the last block adds them up
  double sum_ssim = acc_ssim, sum_cs = acc_cs;
  block_sum2(sum_ssim, sum_cs);
  const int blocks_an_image = a.channels * gridDim.x * gridDim.y;
  const int in_image = ((plane_index % a.channels) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (t == 0) {
    double* part = a.partials + 2 * (static_cast<long long>(image) * blocks_an_image + in_image);
    part[0] = sum_ssim;
    part[1] = sum_cs;
  }
  __syncthreads();
  int last = 0;
  const int total_blocks = gridDim.x * gridDim.y * gridDim.z;
  if (t == 0) last = ticket_acq_rel(a.ticket) == total_blocks - 1;
  if (!__syncthreads_or(last)) return;
  const int images = gridDim.z / a.channels;
  for (int b = 0; b < images; ++b) {
    double s = 0.0, c = 0.0;
    const double* part = a.partials + 2 * static_cast<long long>(b) * blocks_an_image;
    for (int i = t; i < blocks_an_image; i += kThreads) {
      s += __ldcg(part + 2 * i);
      c += __ldcg(part + 2 * i + 1);
    }
    block_sum2(s, c);
    if (t == 0) {
      a.out_ssim[b] = static_cast<float>(s / a.count);
      if (a.out_cs) a.out_cs[b] = static_cast<float>(c / a.count);
    }
  }
  if (t == 0) *a.ticket = 0;  // for the next launch on this stream
}

// Dynamic shared memory of a block: the column taps (double), the row taps (float32, to an
// even count), the input tile and its halo (two planes), the five row moments.
int shared_bytes_for(int kh, int kw) {
  const int in_h = kTileH + kh - 1, in_s = (kTileW + kw - 1) | 1;
  return 8 * kh + 4 * ((kw + 1) & ~1) + 4 * 2 * in_h * in_s + 4 * 5 * in_h * kRowStride;
}

template <int K>
int launch(const Args& a, dim3 grid, int shared_bytes, cudaStream_t stream) {
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(ssim_window_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssim_window_kernel<K><<<grid, kThreads, shared_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// preds, target (B, C, H, W) float32 contiguous; taps_h (kh,), taps_w (kw,) float64;
// consts (2,) float32 c1, c2 on the device (a data range reduced there), or null and c1,
// c2 by value; out_ssim (B,), out_cs (B,) or null, full (B, C, H, W) or
// null; partials (B x blocks an image x 2) doubles; ticket one int, zero. The grid
// covers rows [row0, row0 + rows) x cols [col0, col0 + cols) of every plane in tiles of
// 32 x 64: (cdiv(cols, 32), cdiv(rows, 64), B * C) blocks of 256
// threads and `shared_bytes` of dynamic shared memory, which must equal shared_bytes_for.
extern "C" int ssim_window_launch(const void* preds, const void* target, const void* taps_h, const void* taps_w,
                                  const void* consts, float c1, float c2, void* out_ssim, void* out_cs, void* full,
                                  void* partials,
                                  void* ticket, int batch, int channels, int height, int width, int kh, int kw,
                                  int row0, int col0, int rows, int cols, int has_clamp, float lo, float hi,
                                  double count, int shared_bytes, void* stream_ptr) {
  Args a;
  a.preds = static_cast<const float*>(preds);
  a.target = static_cast<const float*>(target);
  a.taps_h = static_cast<const double*>(taps_h);
  a.taps_w = static_cast<const double*>(taps_w);
  a.consts = static_cast<const float*>(consts);
  a.c1 = c1;
  a.c2 = c2;
  a.out_ssim = static_cast<float*>(out_ssim);
  a.out_cs = static_cast<float*>(out_cs);
  a.full = static_cast<float*>(full);
  a.partials = static_cast<double*>(partials);
  a.ticket = static_cast<int*>(ticket);
  a.channels = channels;
  a.height = height;
  a.width = width;
  a.kh = kh;
  a.kw = kw;
  a.ph = (kh - 1) / 2;
  a.pw = (kw - 1) / 2;
  a.row0 = row0;
  a.col0 = col0;
  a.rows = rows;
  a.cols = cols;
  a.has_clamp = has_clamp;
  a.lo = lo;
  a.hi = hi;
  a.count = count;
  if (rows <= 0 || cols <= 0 || batch <= 0 || channels <= 0 || shared_bytes != shared_bytes_for(kh, kw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((cols + kTileW - 1) / kTileW, (rows + kTileH - 1) / kTileH, batch * channels);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return kh == 11 && kw == 11 ? launch<11>(a, grid, shared_bytes, stream) : launch<0>(a, grid, shared_bytes, stream);
}
