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
// arithmetic binds at an 11-tap window (this kernel runs them in fp64).
//
// What the design does about it:
// - the window applied separably: a row pass (kw taps) over the tile and its
//   halo of ph rows, into shared memory, then a column pass (kh taps): 7 kw +
//   5 kh operations a pixel instead of the 2-D window's 5 kh kw; a thread
//   takes 4 consecutive outputs of a column, so each row of the row pass is
//   read from shared memory once for the 4 (kh + 3 reads, not 4 kh);
// - one block of 32 x 8 threads a 32 x 32 tile of outputs of one (image,
//   channel) plane; the input tile and its halo (float32), clamped to the
//   data range when one is given as a tuple, in shared memory (a double
//   tile, converted once, cost a block an SM and ran 1.46 ms against 1.18
//   at DIV2K's batch);
// - the window's taps and sums in double (the row pass's in shared memory
//   too), the differences in double and only the map's quotients in float32: sum w p^2 - mu^2 cancels
//   most of a float32 sum's digits where the local variance is small
//   beside c2 (float32 sums, cuDNN's or XLA's, put the map 2e-5 to 9e-5
//   from a float64 evaluation on smooth images with light noise), and the
//   double sums keep the map within 1e-5 of it; fp64 runs at half fp32's
//   rate on the card, the price of those digits;
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
constexpr int kTileW = 32;   // output columns a block: a warp's lanes
constexpr int kTileH = 32;   // output rows a block
constexpr int kRowsAThread = 8;  // thread rows: a block is kTileW x kRowsAThread threads
constexpr int kThreads = kTileW * kRowsAThread;
constexpr int kOutRows = kTileH / kRowsAThread;  // consecutive output rows a thread

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

__device__ __forceinline__ float load(const Args& a, const float* plane, int y, int x) {
  float v = plane[static_cast<long long>(reflect(y, a.height)) * a.width + reflect(x, a.width)];
  if (a.has_clamp && v == v) v = fminf(fmaxf(v, a.lo), a.hi);  // jnp.clip keeps NaN
  return v;
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

__global__ void __launch_bounds__(kThreads) ssim_window_kernel(Args a) {
  extern __shared__ double smem[];
  const int in_h = kTileH + 2 * a.ph, in_w = kTileW + 2 * a.pw;
  double* s_taps_h = smem;
  double* s_taps_w = s_taps_h + a.kh;
  double* s_row = s_taps_w + a.kw;                                   // 5 x in_h x kTileW
  float* s_p = reinterpret_cast<float*>(s_row + 5 * in_h * kTileW);  // in_h x in_w
  float* s_t = s_p + in_h * in_w;                                    // in_h x in_w

  const int t = threadIdx.x, tx = t % kTileW, ty = t / kTileW;
  const int plane_index = blockIdx.z;      // image * channels + channel
  const int image = plane_index / a.channels;
  const long long plane_size = static_cast<long long>(a.height) * a.width;
  const float* p_plane = a.preds + plane_index * plane_size;
  const float* t_plane = a.target + plane_index * plane_size;
  const int oy = a.row0 + blockIdx.y * kTileH, ox = a.col0 + blockIdx.x * kTileW;

  for (int i = t; i < a.kh; i += kThreads) s_taps_h[i] = a.taps_h[i];
  for (int i = t; i < a.kw; i += kThreads) s_taps_w[i] = a.taps_w[i];
  for (int i = t; i < in_h * in_w; i += kThreads) {
    const int y = i / in_w, x = i % in_w;
    s_p[i] = load(a, p_plane, oy - a.ph + y, ox - a.pw + x);
    s_t[i] = load(a, t_plane, oy - a.ph + y, ox - a.pw + x);
  }
  __syncthreads();

  // row pass: the kw-tap window along W of every input row of the tile and its halo, in double
  const int plane_rows = in_h * kTileW;
  for (int y = ty; y < in_h; y += kRowsAThread) {
    const float* rp = s_p + y * in_w + tx;
    const float* rt = s_t + y * in_w + tx;
    double m_p = 0.0, m_t = 0.0, m_pp = 0.0, m_tt = 0.0, m_pt = 0.0;
    for (int b = 0; b < a.kw; ++b) {
      const double w = s_taps_w[b], x = rp[b], z = rt[b];
      const double wx = w * x, wz = w * z;
      m_p += wx;
      m_t += wz;
      m_pp = fma(wx, x, m_pp);
      m_tt = fma(wz, z, m_tt);
      m_pt = fma(wx, z, m_pt);
    }
    const int o = y * kTileW + tx;
    s_row[o] = m_p;
    s_row[plane_rows + o] = m_t;
    s_row[2 * plane_rows + o] = m_pp;
    s_row[3 * plane_rows + o] = m_tt;
    s_row[4 * plane_rows + o] = m_pt;
  }
  __syncthreads();

  // column pass and the map: kOutRows consecutive outputs a thread, each row of the row pass
  // read once for all of them
  const double c1 = a.consts ? a.consts[0] : a.c1, c2 = a.consts ? a.consts[1] : a.c2;
  const int y0 = ty * kOutRows, gx = ox + tx;
  double m[kOutRows][5] = {};
  for (int r = 0; r < a.kh + kOutRows - 1; ++r) {
    const int o = (y0 + r) * kTileW + tx;
    const double v[5] = {s_row[o], s_row[plane_rows + o], s_row[2 * plane_rows + o], s_row[3 * plane_rows + o],
                         s_row[4 * plane_rows + o]};
#pragma unroll
    for (int j = 0; j < kOutRows; ++j) {
      const int tap = r - j;
      if (tap >= 0 && tap < a.kh) {
        const double w = s_taps_h[tap];
#pragma unroll
        for (int k = 0; k < 5; ++k) m[j][k] = fma(w, v[k], m[j][k]);
      }
    }
  }
  double acc_ssim = 0.0, acc_cs = 0.0;
#pragma unroll
  for (int j = 0; j < kOutRows; ++j) {
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
    if (gy >= a.ph && gy < a.height - a.ph && gx >= a.pw && gx < a.width - a.pw && a.ph > 0 && a.pw > 0) {
      acc_ssim += ssim;
      acc_cs += static_cast<float>(upper) / static_cast<float>(lower);
    }
  }

  // the block's sums into its image's partials; the last block adds them up
  block_sum2(acc_ssim, acc_cs);
  const int blocks_an_image = a.channels * gridDim.x * gridDim.y;
  const int in_image = ((plane_index % a.channels) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (t == 0) {
    double* part = a.partials + 2 * (static_cast<long long>(image) * blocks_an_image + in_image);
    part[0] = acc_ssim;
    part[1] = acc_cs;
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

}  // namespace

// preds, target (B, C, H, W) float32 contiguous; taps_h (kh,), taps_w (kw,) float64;
// consts (2,) float32 c1, c2 on the device (a data range reduced there), or null and c1,
// c2 by value; out_ssim (B,), out_cs (B,) or null, full (B, C, H, W) or
// null; partials (B x blocks an image x 2) doubles; ticket one int, zero. The grid
// covers rows [row0, row0 + rows) x cols [col0, col0 + cols) of every plane in tiles of
// 32 x 32: (cdiv(cols, 32), cdiv(rows, 32), B * C) blocks of 256 threads and
// `shared_bytes` of dynamic shared memory.
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
  if (rows <= 0 || cols <= 0 || batch <= 0 || channels <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cols + kTileW - 1) / kTileW, (rows + kTileH - 1) / kTileH, batch * channels);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(ssim_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssim_window_kernel<<<grid, kThreads, shared_bytes, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
