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
// (x^3 = x * (x * x)); a float exponent, 2.0 too, to `lax.pow`; the root is
// `pow(s, 1/p)` with 1/p rounded to float32 by the caller, the norm's a sqrt.
// NaN and +-inf propagate as IEEE arithmetic has them. Built without fast math;
// the sums are float32 in order of k, a fused multiply-add a term for p = 2 and
// for a float p's fast form (below), a separately rounded add otherwise (JAX's
// order of summation is XLA's: the comparison is within the float32 summation
// bound of d terms).
//
// Bound on the card. p = 1 takes two fp32 instructions an element pair (the
// difference, an add of its absolute value), integer p = 2 two (the difference,
// a fused multiply-add), p = 3 four: at Market-1501's 1.361e11 pairs and 33.5 T
// fp32 instructions/s (132 SMs x 128 lanes x 1.98 GHz, 700 W) p = 1 is 8.1 ms.
// A float p takes two special-function operations a pair (lg2, ex2) at 16 an SM
// and clock, one eighth of the fp32 rate: 65.0 ms at Market-1501.
//
// What the design does about it:
// - a block of kThreads threads owns a (16 RM) x (16 RC) tile of the output,
//   a thread an RM x RC register tile of sums (rows ty + 16 i, columns
//   tx + 16 j). The launcher's `tile` picks 8 x 8 (128 x 128 tiles) for an
//   integer p where those give every SM two blocks, else 4 x 4 (64 x 64
//   tiles): a 1,024 x 1,024 matrix takes 256 blocks and not 64, and a float
//   p's batches of terms keep their registers. Each 16-byte shared load holds
//   four columns k of one row: at 8 x 8 sixteen of them feed 256 pairs, and
//   the next column's four are read while this column's sums run;
// - kStages buffers of kChunk columns of the block's x and y rows in dynamic
//   shared memory, row-major with rows of kStride floats, filled by 16-byte
//   cp.async copies (4-byte ones when d % 4 != 0 or a base is not 16-byte
//   aligned), zero past N, M and d: the next chunk loads while this one is
//   summed. A quarter warp's 16-byte reads of y touch 8 consecutive rows, an
//   odd number of 16 bytes apart: 8 distinct bank groups; its reads of x are
//   one row (a broadcast);
// - the exponent's kind is a template parameter: no branch in the inner loop
//   but an integer power's loop over the bits of p (unrolled at p = 3, which
//   has an instance of its own);
// - a float p: |d| = mant 2^(E - 127) with mant in [1, 2) taken from the bits of
//   d, so |d|^p = 2^(p lg2(mant)) 2^(p (E - 127)): ex2 and lg2 of the special-
//   function unit (the .ftz forms: mant in [1, 2) and p lg2(mant) in [0, p) are
//   never subnormal) give the first factor, a table of 256 float32 powers
//   2^(p (E - 127)), rounded once from double by the launcher and held in
//   shared memory, the second. The float32 product p lg2(mant) stays below p,
//   so its rounding costs 2^-24 p of the exponent: the rounding of a float32
//   p lg2|d| of size up to 149 p would cost up to 2^-17 p (2.6e-6 relative at
//   |d| = 1e20, p = 1.5, past phase 3's tolerance at d = 1). Each pair is one
//   lg2, one ex2, one shared load and a fused multiply-add. The table holds -1
//   for every E whose power leaves [2^-126, 2^127] (subnormal or overflowing
//   terms), for E = 0 (zero and subnormal d) and E = 255 (inf, NaN): a batch of
//   4 RM terms holding one takes the accurate path for those pairs, powf as
//   torch.pow computes it, so subnormal, zero, overflowing and non-finite terms
//   are the plain version's own.
//
// Device work of one call, on the caller's stream: one kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;                          // 16 x 16 threads
constexpr int kColThreads = 16;                        // threads across a block's columns
constexpr int kRowThreads = kThreads / kColThreads;    // threads across its rows
constexpr int kChunk = 32;                             // columns of x and y a stage
constexpr int kStages = 2;                             // staged chunks in flight
constexpr int kStride = kChunk + 4;                    // floats a staged row: 144 bytes
constexpr int kTable = 256;                            // powers by binary exponent
constexpr int kMinBlocks = 2;                          // blocks an SM the integer kinds are built for

enum Kind { kAbs = 0, kSquare = 1, kIntPow = 2, kPow = 3 };
enum Root { kNone = 0, kPowRoot = 1, kSqrt = 2 };

struct PowTable {
  float v[kTable];  // 2^(p (E - 127)) rounded to float32, or -1 outside the fast range
};

__device__ __forceinline__ float lg2_approx(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void copy_async(float* dst, const float* src, int bytes, int src_bytes) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(to), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(to), "l"(src), "r"(src_bytes) : "memory");
  }
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory"); }

// Stage columns [k0, k0 + kChunk) of rows [row0, row0 + ROWS) of a (rows, d) matrix, zero past the edges.
template <int ROWS>
__device__ __forceinline__ void stage(float (*dst)[kStride], const float* __restrict__ src, int rows, int d,
                                      int row0, int k0, bool aligned) {
  if (aligned) {  // d % 4 == 0: a 16-byte piece lies wholly inside or outside the matrix
    for (int e = threadIdx.x; e < ROWS * (kChunk / 4); e += kThreads) {
      const int r = e / (kChunk / 4), q = e % (kChunk / 4);
      const int row = row0 + r, k = k0 + 4 * q;
      const bool in = row < rows && k < d;
      copy_async(&dst[r][4 * q], in ? src + static_cast<long long>(row) * d + k : src, 16, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * kChunk; e += kThreads) {
      const int r = e / kChunk, c = e % kChunk;
      const int row = row0 + r, k = k0 + c;
      const bool in = row < rows && k < d;
      copy_async(&dst[r][c], in ? src + static_cast<long long>(row) * d + k : src, 4, in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// lax.integer_pow's binary exponentiation, n >= 1, of RM values at once: the loop over the bits of n (the same in
// every thread) stays outside the values, so their products overlap.
template <int RM>
__device__ __forceinline__ void integer_pow_batch(float (&v)[RM], float (&r)[RM], int n) {
  bool have = false;
  while (n > 0) {
    if (n & 1) {
#pragma unroll
      for (int i = 0; i < RM; ++i) r[i] = have ? __fmul_rn(r[i], v[i]) : v[i];
      have = true;
    }
    n >>= 1;
    if (n > 0) {
#pragma unroll
      for (int i = 0; i < RM; ++i) v[i] = __fmul_rn(v[i], v[i]);
    }
  }
}

// mant^p for |d| = mant 2^(E - 127), mant in [1, 2) taken from the bits of d: ex2(p lg2(mant)), p lg2(mant) in [0, p).
__device__ __forceinline__ float mantissa_pow(unsigned bits, float p) {
  return ex2_approx(p * lg2_approx(__uint_as_float((bits & 0x007fffffu) | 0x3f800000u)));
}

__device__ __noinline__ float accurate_pow(float ad, float p) { return powf(ad, p); }

template <int RM>
struct Column {
  float v[RM];
};

template <int RM>
struct Rows {
  float4 v[RM];
};

// A float p's batch that holds a difference outside the fast range, out of line (one copy for the kernel): each
// pair in order of k, the fast form where the table has its power, else the accurate path (torch.pow's powf; zero
// adds nothing).
template <int RM>
__device__ __noinline__ Column<RM> sum_mixed(Column<RM> col, const Rows<RM> xa, const float4 yb, float p,
                                             const float* __restrict__ table) {
#pragma unroll 1
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float dd = lane(xa.v[i], kk) - lane(yb, kk);
      const unsigned bits = __float_as_uint(dd);
      const float scale = table[bits >> 23 & 0xffu];
      if (scale >= 0.0f) {
        col.v[i] = fmaf(mantissa_pow(bits, p), scale, col.v[i]);
      } else if (fabsf(dd) != 0.0f) {
        col.v[i] = __fadd_rn(col.v[i], accurate_pow(fabsf(dd), p));
      }
    }
  }
  return col;
}

// The sums of one thread over four columns k of the staged chunk: xa[i] holds row i's four, yb column j's.
template <int KIND, int RM, int RC, int NPOW>
__device__ __forceinline__ void sum_group(float (&acc)[RM][RC], const float4 (&xa)[RM], const float4& yb, int j,
                                          int int_p, float p, const float* __restrict__ table) {
  if constexpr (KIND == kPow) {
    // 4 RM terms by the fast form; a batch with a difference outside its range takes the mixed path
    float r[4][RM], s[4][RM];
    float lowest = 1.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const unsigned bits = __float_as_uint(lane(xa[i], kk) - lane(yb, kk));
        s[kk][i] = table[bits >> 23 & 0xffu];
        r[kk][i] = mantissa_pow(bits, p);
        lowest = fminf(lowest, s[kk][i]);
      }
    }
    if (lowest >= 0.0f) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(r[kk][i], s[kk][i], acc[i][j]);
      }
    } else {
      Column<RM> col;
      Rows<RM> rows;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        col.v[i] = acc[i][j];
        rows.v[i] = xa[i];
      }
      col = sum_mixed<RM>(col, rows, yb, p, table);
#pragma unroll
      for (int i = 0; i < RM; ++i) acc[i][j] = col.v[i];
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (KIND == kIntPow) {
        float v[RM], r[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) v[i] = fabsf(lane(xa[i], kk) - lane(yb, kk));
        integer_pow_batch<RM>(v, r, NPOW > 0 ? NPOW : int_p);
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][j] = __fadd_rn(acc[i][j], r[i]);  // never contracted: JAX's rounding
      } else {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float dd = lane(xa[i], kk) - lane(yb, kk);
          acc[i][j] = KIND == kAbs ? acc[i][j] + fabsf(dd) : fmaf(dd, dd, acc[i][j]);
        }
      }
    }
  }
}

// NPOW: a compile-time integer exponent (the loop over its bits unrolls), 0 for int_p at run time. RM x RC: a
// thread's register tile, so the block's tile is (kRowThreads RM) x (kColThreads RC).
template <int KIND, int RM, int RC, int NPOW>
__device__ __forceinline__ void pairwise_lp_body(const float* __restrict__ x, const float* __restrict__ y,
                                                 float* __restrict__ out, int n, int m, int d, int int_p, float p,
                                                 int root, float inv_p, bool aligned, const float* table_in) {
  constexpr int kTileM = kRowThreads * RM, kTileN = kColThreads * RC;
  extern __shared__ __align__(16) float smem[];  // shared_bytes<RM, RC>(): the staged chunks, then the table
  float(*xs)[kTileM][kStride] = reinterpret_cast<float(*)[kTileM][kStride]>(smem);
  float(*ys)[kTileN][kStride] = reinterpret_cast<float(*)[kTileN][kStride]>(smem + kStages * kTileM * kStride);
  float* s_table = smem + kStages * (kTileM + kTileN) * kStride;  // a float p's
  const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
  const int row0 = blockIdx.x * kTileM, col0 = blockIdx.y * kTileN;
  if constexpr (KIND == kPow) {
    for (int e = threadIdx.x; e < kTable; e += kThreads) s_table[e] = table_in[e];  // read after the first barrier
  }
  float acc[RM][RC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < RC; ++j) acc[i][j] = 0.0f;
  }
  const int n_chunks = (d + kChunk - 1) / kChunk;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) {
      stage<kTileM>(xs[c], x, n, d, row0, c * kChunk, aligned);
      stage<kTileN>(ys[c], y, m, d, col0, c * kChunk, aligned);
    }
    copy_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int next = c + kStages - 1, buf = c % kStages;
    if (next < n_chunks) {  // the buffer of chunk c - 1, free since the barrier that ended its sums
      stage<kTileM>(xs[next % kStages], x, n, d, row0, next * kChunk, aligned);
      stage<kTileN>(ys[next % kStages], y, m, d, col0, next * kChunk, aligned);
    }
    copy_commit();
    copy_wait<kStages - 1>();  // chunk c's copies of this thread have landed
    __syncthreads();           // and every thread's
    const int groups = min(kChunk, d - c * kChunk + 3) / 4;  // groups of four columns holding one below d
    for (int q = 0; q < groups; ++q) {
      float4 xa[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) xa[i] = *reinterpret_cast<const float4*>(&xs[buf][ty + kRowThreads * i][4 * q]);
      float4 yb = *reinterpret_cast<const float4*>(&ys[buf][tx][4 * q]);
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        const float4 yn = *reinterpret_cast<const float4*>(&ys[buf][tx + kColThreads * ((j + 1) % RC)][4 * q]);
        sum_group<KIND, RM, RC, NPOW>(acc, xa, yb, j, int_p, p, s_table);
        yb = yn;  // the next column's four, read before this column's sums
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is staged again
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + ty + kRowThreads * i;
    if (row >= n) break;
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int col = col0 + tx + kColThreads * j;
      if (col < m) {
        float s = acc[i][j];
        if (root == kPowRoot) s = powf(s, inv_p);
        else if (root == kSqrt) s = sqrtf(s);
        out[static_cast<long long>(row) * m + col] = s;
      }
    }
  }
}

// Dynamic shared memory of a block: kStages chunks of its x and y rows, and a float p's table.
template <int RM, int RC>
constexpr int shared_bytes() {
  return 4 * (kStages * (kRowThreads * RM + kColThreads * RC) * kStride + kTable);
}

// The integer kinds: two blocks an SM at 8 x 8 (128 registers); one for the loop over a run-time p's bits, and
// at 4 x 4, which the launcher takes where an SM gets two blocks at most.
template <int KIND, int RM, int RC, int NPOW = 0>
__global__ void __launch_bounds__(kThreads, (KIND == kIntPow && NPOW == 0) || RC == 4 ? 1 : kMinBlocks)
    pairwise_lp_kernel(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ out, int n, int m,
                       int d, int int_p, int root, float inv_p, int aligned) {
  pairwise_lp_body<KIND, RM, RC, NPOW>(x, y, out, n, m, d, int_p, 0.0f, root, inv_p, aligned != 0, nullptr);
}

// A float p: the table rides in the kernel's parameters (1 KB), read once a block. The 4 RM terms of a batch are in
// registers beside the sums (at RM = 8, one block an SM).
template <int RM, int RC>
__global__ void __launch_bounds__(kThreads, RM == 8 ? 1 : kMinBlocks)
    pairwise_pow_kernel(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ out, int n, int m,
                        int d, float p, int root, float inv_p, int aligned, const __grid_constant__ PowTable table) {
  pairwise_lp_body<kPow, RM, RC, 0>(x, y, out, n, m, d, 0, p, root, inv_p, aligned != 0, table.v);
}

// The powers of the fast range: E whose terms mant^p 2^(p (E - 127)), mant in [1, 2), lie in [2^-126, 2^127].
PowTable pow_table(float p) {
  PowTable t;
  const double pd = p;
  for (int e = 0; e < kTable; ++e) {
    const double lo = pd * (e - 127), hi = pd * (e - 126);  // exact in double
    const bool fast = e >= 1 && e <= 254 && lo >= -126.0 && hi <= 127.0;
    t.v[e] = fast ? static_cast<float>(exp2(lo)) : -1.0f;  // the host's, from the CUDA headers
  }
  return t;
}

template <int RM, int RC>
int launch(const float* x, const float* y, float* out, int n, int m, int d, int kind, int int_p, float p, int root,
           float inv_p, int aligned, cudaStream_t stream) {
  constexpr int kTileM = kRowThreads * RM, kTileN = kColThreads * RC, kBytes = shared_bytes<RM, RC>();
  if ((m + kTileN - 1) / kTileN > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kTileM - 1) / kTileM, (m + kTileN - 1) / kTileN);
  const auto run = [&](auto kernel, auto... args) {
    if (kBytes > 48 * 1024) {  // past the default, on the current device
      const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<grid, kThreads, kBytes, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
  };
  switch (kind) {
    case kAbs: return run(pairwise_lp_kernel<kAbs, RM, RC>, x, y, out, n, m, d, int_p, root, inv_p, aligned);
    case kSquare: return run(pairwise_lp_kernel<kSquare, RM, RC>, x, y, out, n, m, d, int_p, root, inv_p, aligned);
    case kIntPow:
      return int_p == 3 ? run(pairwise_lp_kernel<kIntPow, RM, RC, 3>, x, y, out, n, m, d, int_p, root, inv_p, aligned)
                        : run(pairwise_lp_kernel<kIntPow, RM, RC>, x, y, out, n, m, d, int_p, root, inv_p, aligned);
    case kPow: return run(pairwise_pow_kernel<RM, RC>, x, y, out, n, m, d, p, root, inv_p, aligned, pow_table(p));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kind: 0 |d| (p = 1), 1 d * d (integer p = 2), 2 integer_pow(|d|, int_p), 3 |d|^p for a float p.
// root: 0 none, 1 powf(s, inv_p), 2 sqrtf(s). A thread's tile of sums: rows x cols, 8 x 8 or 4 x 4.
// Grid (cdiv(n, 16 rows), cdiv(m, 16 cols)) of at most 65,535 column tiles, kThreads threads.
extern "C" int pairwise_lp_launch(const void* x, const void* y, void* out, int n, int m, int d, int kind, int int_p,
                                  float p, int root, float inv_p, int rows, int cols, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || m < 1 || d < 0 || root < 0 || root > 2) return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const int aligned = d % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<std::uintptr_t>(y) % 16 == 0;
  float* o = static_cast<float*>(out);
  if (rows == 8 && cols == 8) return launch<8, 8>(xf, yf, o, n, m, d, kind, int_p, p, root, inv_p, aligned, stream);
  if (rows == 4 && cols == 4) return launch<4, 4>(xf, yf, o, n, m, d, kind, int_p, p, root, inv_p, aligned, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
