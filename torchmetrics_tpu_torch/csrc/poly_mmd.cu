// KID's polynomial-kernel MMD over random subsets, every subset in one launch:
// for subset s with row indices ir[s, :] of the real features x (N_r, d) and
// if[s, :] of the fake features y (N_f, d), float32,
//   k(a, b) = (gamma * <a, b> + coef) ^ degree,
//   kt_xx = sum_{i != j} k(x_i, x_j), kt_yy likewise, k_xy = sum_{i, j} k(x_i, y_j),
//   out[s] = (kt_xx + kt_yy) / (m (m - 1)) - 2 k_xy / m^2   (the unbiased MMD^2).
//
// Replaces the vmapped subsets of torchmetrics_tpu/functional/image/generative.py:60-115
// (`poly_kernel` three times and `maximum_mean_discrepancy`), which gather each
// subset's rows into copies and write three m x m kernel matrices a subset.
//
// Arithmetic: each dot product is float32, a fused multiply-add a column in
// order of k (XLA's product sums in another order: the comparison is within the
// float32 bound of the terms); then (dot * gamma) + coef rounded twice, as JAX's
// `f1 @ f2.T * gamma + coef`, and the power by binary exponentiation, as
// `lax.integer_pow` (x^3 = x * (x * x)); the sums are float64.
//
// Bound on the card: fp32 operations. At KID's defaults (100 subsets of
// m = 1,000 rows, d = 2,048) the symmetric xx and yy halves counted once,
// 2 m^2 d FMAs a subset: 8.2e11 flop, 12.2 ms at 67 TFLOP/s.
//
// What the design does about it:
// - a block owns a tile of 16 R x 16 R entries of one of a subset's three
//   matrices (grid.x the tiles of a subset: the m x m tiles of xy, then the
//   upper triangles of xx and yy; grid.y the subsets), a thread an R x R
//   register tile, R = 8 (rows 4 ty + 64 p + r and columns 4 tx + 64 q + c:
//   128 x 128 tiles);
// - the tile's rows of x and y are read by index straight from the feature
//   matrices (each row's address taken from the index once), kChunk columns
//   at a time, into shared memory, column-major (rows of 16 R + 4 floats,
//   16-byte aligned), with 16-byte loads where d % 4 == 0 and the base is
//   aligned, 4-byte loads otherwise; the next chunk's loads are issued into
//   registers before this chunk's FMAs and stored after them; each step a
//   thread reads its R rows of x and R of y as 16-byte shared loads (a
//   quarter-warp's 16 contiguous bytes apart: no bank conflict) for R^2 FMAs;
// - the epilogue raises each entry to `degree` in registers and adds it in
//   float64: a tile off the diagonal of xx or yy counts twice (its mirror is the
//   same dot product), a diagonal tile skips i == j, rows past m are skipped;
//   a block's sum goes to its subset's scratch sum by one float64 atomic, and
//   the subset's last block (a ticket) takes the three sums with atomic
//   exchanges (leaving them zero for the next launch), writes out[s] and sets
//   its ticket back to zero.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // columns of the features staged a step
constexpr int R = 8;        // a thread's register tile, R x R

__device__ __forceinline__ float integer_pow(float x, int n) {
  float acc = 1.0f;
  bool first = true;
  while (n > 0) {
    if (n & 1) {
      acc = first ? x : __fmul_rn(acc, x);
      first = false;
    }
    n >>= 1;
    if (n > 0) x = __fmul_rn(x, x);
  }
  return acc;
}

// A thread's share of staging 16 R rows x kChunk columns: 4 consecutive columns of one row a pass, R / 2
// passes; the rows' addresses are read from the index once, at the start.
struct Stage {
  const float* row[R / 2];  // nullptr past m
  float v[R / 2][4];

  __device__ __forceinline__ void rows(const float* __restrict__ feats, const long long* __restrict__ idx, int row0,
                                       int m, int d) {
#pragma unroll
    for (int pass = 0; pass < R / 2; ++pass) {
      const int i = row0 + (threadIdx.x + pass * kThreads) / (kChunk / 4);
      row[pass] = i < m ? feats + idx[i] * static_cast<long long>(d) : nullptr;
    }
  }

  __device__ __forceinline__ void load(int d, int k0, bool aligned) {
    const int k = k0 + 4 * (threadIdx.x % (kChunk / 4));
#pragma unroll
    for (int pass = 0; pass < R / 2; ++pass) {
      v[pass][0] = v[pass][1] = v[pass][2] = v[pass][3] = 0.0f;
      if (row[pass] == nullptr) continue;
      const float* src = row[pass] + k;
      if (aligned && k + 3 < d) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(src));
        v[pass][0] = q.x; v[pass][1] = q.y; v[pass][2] = q.z; v[pass][3] = q.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) if (k + c < d) v[pass][c] = __ldg(src + c);
      }
    }
  }

  __device__ __forceinline__ void store(float (*dst)[16 * R + 4]) const {
    const int kq = threadIdx.x % (kChunk / 4);
#pragma unroll
    for (int pass = 0; pass < R / 2; ++pass) {
      const int r = (threadIdx.x + pass * kThreads) / (kChunk / 4);
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[4 * kq + c][r] = v[pass][c];
    }
  }
};

__global__ void __launch_bounds__(kThreads) poly_mmd_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const long long* __restrict__ ix,
    const long long* __restrict__ iy, float* __restrict__ out, double* __restrict__ sums,
    unsigned int* __restrict__ tickets, int m, int d, int degree, float gamma, float coef, int tiles,
    int aligned_x, int aligned_y) {
  constexpr int kTile = 16 * R;
  constexpr int kStride = kTile + 4;  // a staged column's floats: 16-byte aligned, stores spread over banks
  constexpr int P = R / 4;            // 16-byte groups a thread's rows and columns take, 64 apart
  __shared__ __align__(16) float a_s[kChunk][kStride];
  __shared__ __align__(16) float b_s[kChunk][kStride];
  __shared__ double warp_sums[kThreads / 32];
  __shared__ bool last;

  const int s = blockIdx.y;
  int tile = blockIdx.x;
  int which;  // 0: xy, 1: xx, 2: yy
  int ti, tj;
  if (tile < tiles * tiles) {
    which = 0;
    ti = tile / tiles;
    tj = tile % tiles;
  } else {
    tile -= tiles * tiles;
    const int tri = tiles * (tiles + 1) / 2;
    which = tile < tri ? 1 : 2;
    if (which == 2) tile -= tri;
    ti = 0;
    while (tile >= tiles - ti) {
      tile -= tiles - ti;
      ++ti;
    }
    tj = ti + tile;
  }
  const float* fa = which == 2 ? y : x;
  const float* fb = which == 1 ? x : y;
  const long long* ia = (which == 2 ? iy : ix) + static_cast<long long>(s) * m;
  const long long* ib = (which == 1 ? ix : iy) + static_cast<long long>(s) * m;
  const bool al_a = which == 2 ? aligned_y : aligned_x;
  const bool al_b = which == 1 ? aligned_x : aligned_y;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[R][R] = {};
  Stage sa, sb;
  sa.rows(fa, ia, ti * kTile, m, d);
  sb.rows(fb, ib, tj * kTile, m, d);
  sa.load(d, 0, al_a);
  sb.load(d, 0, al_b);
  sa.store(a_s);
  sb.store(b_s);
  __syncthreads();
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const bool more = k0 + kChunk < d;
    if (more) {  // the next columns' loads in flight while this chunk's FMAs run
      sa.load(d, k0 + kChunk, al_a);
      sb.load(d, k0 + kChunk, al_b);
    }
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      float av[R], bv[R];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float4 a = *reinterpret_cast<const float4*>(&a_s[k][4 * ty + 64 * p]);
        const float4 b = *reinterpret_cast<const float4*>(&b_s[k][4 * tx + 64 * p]);
        av[4 * p] = a.x; av[4 * p + 1] = a.y; av[4 * p + 2] = a.z; av[4 * p + 3] = a.w;
        bv[4 * p] = b.x; bv[4 * p + 1] = b.y; bv[4 * p + 2] = b.z; bv[4 * p + 3] = b.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] = __fmaf_rn(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
    if (more) {
      sa.store(a_s);
      sb.store(b_s);
    }
    __syncthreads();
  }

  const bool symmetric = which != 0;
  const double weight = symmetric && ti != tj ? 2.0 : 1.0;
  double local = 0.0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int i = ti * kTile + 4 * ty + 64 * (r / 4) + r % 4;
      const int j = tj * kTile + 4 * tx + 64 * (c / 4) + c % 4;
      if (i >= m || j >= m || (symmetric && i == j)) continue;
      const float v = __fadd_rn(__fmul_rn(acc[r][c], gamma), coef);
      local += static_cast<double>(integer_pow(v, degree));
    }
  }
  local *= weight;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) local += __shfl_xor_sync(0xffffffffu, local, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    atomicAdd(sums + 3 * s + which, total);
    __threadfence();
    const unsigned int blocks = static_cast<unsigned int>(gridDim.x);
    last = atomicAdd(tickets + s, 1u) == blocks - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    double v[3];
    for (int w = 0; w < 3; ++w) {
      const unsigned long long bits =
          atomicExch(reinterpret_cast<unsigned long long*>(sums + 3 * s + w), 0ull);
      v[w] = __longlong_as_double(static_cast<long long>(bits));
    }
    const double mm = static_cast<double>(m);
    out[s] = static_cast<float>((v[1] + v[2]) / (mm * (mm - 1.0)) - 2.0 * v[0] / (mm * mm));
    tickets[s] = 0u;
  }
}

}  // namespace

// x (n_x, d), y (n_y, d) float32; ix, iy (subsets, m) int64 row indices; out (subsets,) float32;
// sums (3 subsets) float64 and tickets (subsets) uint32 of scratch, zero at entry and left zero.
extern "C" int poly_mmd_launch(const void* x, const void* y, const void* ix, const void* iy, void* out, void* sums,
                               void* tickets, int subsets, int m, int d, int degree, float gamma, float coef,
                               void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (subsets < 1 || subsets > 65535 || m < 1 || d < 1 || degree < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (m + 16 * R - 1) / (16 * R);
  const long long blocks = static_cast<long long>(tiles) * tiles + static_cast<long long>(tiles) * (tiles + 1);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int aligned_x = d % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  const int aligned_y = d % 4 == 0 && reinterpret_cast<std::uintptr_t>(y) % 16 == 0;
  const dim3 grid(static_cast<unsigned int>(blocks), static_cast<unsigned int>(subsets));
  poly_mmd_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const long long*>(ix),
      static_cast<const long long*>(iy), static_cast<float*>(out), static_cast<double*>(sums),
      static_cast<unsigned int*>(tickets), m, d, degree, gamma, coef, tiles, aligned_x, aligned_y);
  return static_cast<int>(cudaGetLastError());
}
