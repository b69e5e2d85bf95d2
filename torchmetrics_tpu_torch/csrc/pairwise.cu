// The L_p distance matrix of two row sets: out[i, j] = (sum_k |x[i, k] - y[j, k]|^p)^(1/p),
// x (N, d) and y (M, d) float32, out (N, M) float32, with no root for the Manhattan
// distance and a square root for the Euclidean norm of the cluster scores.
//
// Replaces the XLA-lowered JAX broadcasts that build an (N, M, d) float32
// temporary: torchmetrics_tpu/functional/pairwise/pairwise.py:118
// (`pairwise_manhattan_distance`) and :133 (`pairwise_minkowski_distance`), and
// the centroid distances of torchmetrics_tpu/functional/clustering/intrinsic.py:58
// (`davies_bouldin_score`, a norm) and :75-76 (`dunn_index`). At a Market-1501
// re-identification evaluation (3,368 x 19,732 features of width 2,048) that
// temporary is 544 GB.
//
// It follows JAX's arithmetic (jax 0.9.0, `make_jaxpr`): a Python int exponent
// lowers to `lax.integer_pow`, which multiplies by binary exponentiation
// (x^3 = x * (x * x)); a float exponent, 2.0 too, to `lax.pow` (powf here);
// the root is `pow(s, 1/p)` with 1/p rounded to float32 by the caller, the
// norm's a sqrt. NaN and +-inf propagate as IEEE arithmetic has them. Built
// without fast math; the sums are float32 in order of k, a fused multiply-add
// a term for p = 2 and a separately rounded add otherwise (JAX's order of
// summation is XLA's: the comparison is within the float32 summation bound of
// d terms).
//
// Bound on the card: the fp32 pipe. p = 1 takes two instructions an element
// pair (the difference, an add of its absolute value), integer p = 2 two (the
// difference, a fused multiply-add): at Market-1501's 1.361e11 pairs and 33.5 T
// fp32 instructions/s (132 SMs x 128 lanes x 1.98 GHz, 700 W) that is 8.1 ms.
// A float p takes powf: two special-function operations (lg2, ex2) at one
// eighth of that rate, and some twenty fp32 instructions about them.
//
// What the design does about it:
// - a block (kThreads threads) owns a kTile x kTile tile of the output; each
//   thread a 4 x 4 register tile of sums, so 8 shared loads (two 16-byte ones)
//   feed 16 pairs;
// - the block stages kChunk columns of its x and y rows at a time in shared
//   memory, d-major (a thread's 4 rows are one 16-byte read), zero-padded
//   past N, M and d (a zero pair adds |0|^p = 0 to a sum, p > 0);
// - the exponent's kind is a template parameter: the inner loop holds no
//   branch but an integer power's loop over the bits of p, which runs once a
//   column for the thread's 16 values together (unrolled at p = 3, which
//   has an instance of its own: on an H100 at 700 W, Market-1501's p = 3
//   took 79.3 ms through the loop and 22.9 ms unrolled).
//
// Device work of one call, on the caller's stream: one kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;      // output rows and columns a block
constexpr int kChunk = 32;     // columns of x and y a stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kStride = kTile + 4;  // a staged column: 16-byte aligned rows of the tile

enum Kind { kAbs = 0, kSquare = 1, kIntPow = 2, kPow = 3 };
enum Root { kNone = 0, kPowRoot = 1, kSqrt = 2 };

// lax.integer_pow's binary exponentiation, n >= 1, of a thread's 4 x 4 values at once: the loop over the
// bits of n (the same in every thread) stays outside the 16 values, so their products overlap.
__device__ __forceinline__ void integer_pow_tile(float (&v)[4][4], float (&r)[4][4], int n) {
  bool have = false;
  while (n > 0) {
    if (n & 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) r[i][j] = have ? r[i][j] * v[i][j] : v[i][j];
      }
      have = true;
    }
    n >>= 1;
    if (n > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = v[i][j] * v[i][j];
      }
    }
  }
}

template <int KIND>
__device__ __forceinline__ float term_add(float acc, float a, float b, float p) {
  const float d = a - b;
  if constexpr (KIND == kAbs) {
    return acc + fabsf(d);
  } else if constexpr (KIND == kSquare) {
    return fmaf(d, d, acc);
  } else {
    return __fadd_rn(acc, powf(fabsf(d), p));
  }
}

// Stage columns [k0, k0 + kChunk) of rows [row0, row0 + kTile) of a (rows, d) matrix, d-major, zero past the edges.
__device__ __forceinline__ void stage(float (*dst)[kStride], const float* __restrict__ src, int rows, int d,
                                      int row0, int k0) {
  for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
    const int r = e / kChunk, c = e % kChunk;  // neighbouring lanes on neighbouring columns: coalesced reads
    const int row = row0 + r, k = k0 + c;
    dst[c][r] = (row < rows && k < d) ? src[static_cast<long long>(row) * d + k] : 0.0f;
  }
}

// NPOW: a compile-time integer exponent (the loop over its bits unrolls), 0 for int_p at run time.
template <int KIND, int NPOW = 0>
__global__ void __launch_bounds__(kThreads) pairwise_lp_kernel(const float* __restrict__ x,
                                                                const float* __restrict__ y, float* __restrict__ out,
                                                                int n, int m, int d, int int_p, float p, int root,
                                                                float inv_p) {
  __shared__ __align__(16) float xs[kChunk][kStride];
  __shared__ __align__(16) float ys[kChunk][kStride];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    stage(xs, x, n, d, row0, k0);
    stage(ys, y, m, d, col0, k0);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&ys[k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
      if constexpr (KIND == kIntPow) {
        float v[4][4], r[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[i][j] = fabsf(av[i] - bv[j]);
        }
        integer_pow_tile(v, r, NPOW > 0 ? NPOW : int_p);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], r[i][j]);  // never contracted: JAX's rounding
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = term_add<KIND>(acc[i][j], av[i], bv[j], p);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    if (row >= n) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + 4 * tx + j;
      if (col < m) {
        float s = acc[i][j];
        if (root == kPowRoot) s = powf(s, inv_p);
        else if (root == kSqrt) s = sqrtf(s);
        out[static_cast<long long>(row) * m + col] = s;
      }
    }
  }
}

}  // namespace

// kind: 0 |d| (p = 1), 1 d * d (integer p = 2), 2 integer_pow(|d|, int_p), 3 powf(|d|, p).
// root: 0 none, 1 powf(s, inv_p), 2 sqrtf(s). Grid (cdiv(m, kTile), cdiv(n, kTile)), kThreads threads.
extern "C" int pairwise_lp_launch(const void* x, const void* y, void* out, int n, int m, int d, int kind, int int_p,
                                  float p, int root, float inv_p, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || m < 1 || d < 0 || (n + kTile - 1) / kTile > 65535 || root < 0 || root > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* o = static_cast<float*>(out);
  switch (kind) {
    case kAbs: pairwise_lp_kernel<kAbs><<<grid, kThreads, 0, stream>>>(xf, yf, o, n, m, d, int_p, p, root, inv_p);
      break;
    case kSquare:
      pairwise_lp_kernel<kSquare><<<grid, kThreads, 0, stream>>>(xf, yf, o, n, m, d, int_p, p, root, inv_p);
      break;
    case kIntPow:
      if (int_p == 3) {
        pairwise_lp_kernel<kIntPow, 3><<<grid, kThreads, 0, stream>>>(xf, yf, o, n, m, d, int_p, p, root, inv_p);
      } else {
        pairwise_lp_kernel<kIntPow><<<grid, kThreads, 0, stream>>>(xf, yf, o, n, m, d, int_p, p, root, inv_p);
      }
      break;
    case kPow: pairwise_lp_kernel<kPow><<<grid, kThreads, 0, stream>>>(xf, yf, o, n, m, d, int_p, p, root, inv_p);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
