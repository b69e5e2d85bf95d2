// SDR's projection: for each row, the solution x of the symmetric Toeplitz
// system R x = b whose first row is the target's autocorrelation r_0, the
// coherence coh = b . x, and SDR = 10 log10(coh / (1 - coh)), by a Schur-type
// (generator) recursion with a general right-hand side, in float64.
//
// Replaces torchmetrics_tpu/functional/audio/sdr.py:30-34 and :69-73: the
// (R, L, L) float32 Toeplitz matrix built by a gather (1 MB a row at the
// default filter_length 512), jnp.linalg.solve's general LU (about 2/3 L^3 =
// 89 MFLOP a row), the coherence and the log ratio. There is no TPU kernel.
// The recursion solves the same system in 3 L^2 fused multiply-adds with no
// matrix.
//
// The recursion (Golub and Van Loan 4.7 on the Levinson side, Kailath's
// generalized Schur algorithm on the generator side), on T = R / r_0[0] (unit
// diagonal, first row t) and c = b / r_0[0], with F_0 = G_0 = t, R_0 = c,
// f_0 = g_0 = [1], x_0 empty; step k = 0 .. L - 1:
//   beta = G_k[k], mu = R_k[k] / beta;
//   x_{k+1} = [x_k; 0] + mu g_k, R_{k+1} = R_k - mu G_k;
//   if k + 1 < L: gamma = -F_k[k+1] / beta,
//     F_{k+1}[j] = F_k[j] + gamma G_k[j-1], G_{k+1}[j] = G_k[j-1] + gamma F_k[j],
//     f_{k+1}[i] = f_k[i] + gamma g_k[i-1], g_{k+1}[i] = g_k[i-1] + gamma f_k[i].
// F_k = T [f_k; 0] and G_k = T [g_k; 0] are the correlations of the forward
// predictor f_k and the backward one g_k = reverse(f_k) (kept as a vector of
// its own: the same operations on the same operands keep it reverse(f_k) bit
// for bit), R_k the residual of [x_k; 0]: a step reads three scalars of them
// where Levinson takes two dot products. beta = G_k[k] follows beta_{k+1} =
// beta_k (1 - gamma^2), so its reciprocal is computed a step ahead (and G_k[k]
// itself is never needed): the loop-carried chain of a step is the broadcast
// read, gamma, beta and its reciprocal.
//
// Bound on the card: 3 L^2 fp64 fused multiply-adds a system (0.79 M at
// L = 512), 34 TFLOP/s outside the tensor cores (H100 SXM data sheet, 700 W);
// but the L steps are a dependent chain (each reads three values the one
// before wrote), so a system's latency, not the card's rate, bounds a batch of
// a few dozen rows: at least L - 1 block barriers, fp64 reciprocals and fused
// multiply-adds.
//
// What the design does about it:
// - no dot product and no shuffle tree: every update is elementwise, so one
//   system takes a whole block (up to 1,024 threads) with one barrier a step;
// - slot j holds three doubles in registers: the predictors (f, g, x)[j] once
//   k >= j, the generators (F, G, -R)[j] before (their known zeros); a step
//   makes the same three fused multiply-adds in either, with no branch, and
//   slot k + 1 turns from one into the other (g_k[k] = f_k[0] = 1). E
//   consecutive slots a thread (the launcher's smallest E of 1, 2, 4, 8, 16,
//   at least kMinEntries, that fits the block); the shift by one slot reads the
//   left neighbour's old g or G from a shuffle within the warp and a
//   double-buffered word a warp in shared memory across warps;
// - the step's scalars R_k[k] and -F_k[k+1] written by their owners into a
//   double-buffered broadcast word, so no second barrier is needed; a step is
//   few instructions a warp (a warp issues one a cycle at most, and the
//   owners' warp is the barrier's last);
// - the coherence b . x one fixed-order block reduction at the end, x written
//   once: two launches give the same bits.
//
// A reflection coefficient |gamma| >= 1 (a singular or indefinite system, as a
// pure tone gives without load_diag) is not caught: the value is what the
// arithmetic gives, as JAX's LU gives what its arithmetic gives; the loop's
// length does not depend on it.
//
// Device work of one call, on the caller's stream: one kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLength = 8192;
constexpr int kMaxThreads = 1024;  // a block's threads, where a thread's registers allow it
constexpr int kMinEntries = 4;     // slots a thread, at least

// Threads a block at most at E slots a thread: 3 E doubles of registers a thread, within the register file.
template <int E>
constexpr int kBlockThreads = E <= 2 ? kMaxThreads : kMaxThreads / 2;

__device__ __forceinline__ double reciprocal(double v) { return 1.0 / v; }

// Block s solves system s: R = toeplitz(r0[s, :]), R x = b[s, :]; writes sdr[s] and x[s, :]. Thread i holds the
// slots [i E, (i + 1) E).
template <int E>
__global__ void __launch_bounds__(kBlockThreads<E>) sdr_toeplitz_kernel(const float* __restrict__ r0,
                                                                       const float* __restrict__ b,
                                                                       float* __restrict__ sdr,
                                                                       float* __restrict__ x_out, int length) {
  __shared__ double scalars[2][2];                     // R_k[k] and -F_k[k + 1], by the parity of k
  __shared__ double edge[2][kBlockThreads<E> / 32];    // each warp's last g or G, by the parity of k
  __shared__ double warp_sums[kMaxThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = tid * E;
  const long long row = static_cast<long long>(blockIdx.x) * length;
  const double inv_diag = 1.0 / static_cast<double>(r0[row]);

  // slot j: (A, B, C) = (f, g, x)[j] once k >= j, else (F, G, -R)[j]; slot 0 starts as f_0 = g_0 = [1]
  double A[E], B[E], C[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = j0 + e;
    const double t = j == 0 ? 1.0 : j < length ? static_cast<double>(r0[row + j]) * inv_diag : 0.0;
    A[e] = B[e] = t;
    C[e] = j > 0 && j < length ? -static_cast<double>(b[row + j]) * inv_diag : 0.0;
  }
  if (lane == 31) edge[0][warp] = B[E - 1];
  if (tid == 0) {
    scalars[0][0] = static_cast<double>(b[row]) * inv_diag;
    scalars[0][1] = length > 1 ? -static_cast<double>(r0[row + 1]) * inv_diag : 0.0;
  }
  double beta = 1.0, inv_beta = 1.0;
  for (int k = 0; k < length; ++k) {
    __syncthreads();
    const double* now = scalars[k & 1];
    double* next = scalars[(k & 1) ^ 1];
    const bool more = k + 1 < length;
    const double mu = now[0] * inv_beta;
    const double gamma = more ? now[1] * inv_beta : 0.0;
    // the next step's reciprocal: beta_{k+1} = beta_k (1 - gamma^2), two dependent operations
    beta = fma(-beta * gamma, gamma, beta);
    const double next_inv_beta = reciprocal(beta);
    // the old g or G one slot left of this thread's first slot
    double left = __shfl_up_sync(0xffffffffu, B[E - 1], 1);
    if (lane == 0) left = warp > 0 ? edge[k & 1][warp - 1] : 0.0;
    // every slot, last first (each reads its left neighbour's old g or G): x += mu g and f, g by the shift, or
    // -R += mu G and F, G by the shift: the same three multiply-adds, no branch. Slots past the system's length
    // take them too and are never read.
#pragma unroll
    for (int e = E - 1; e >= 0; --e) {
      const double b_left = e > 0 ? B[e - 1] : left;
      const double a = A[e];
      C[e] = fma(mu, B[e], C[e]);
      A[e] = fma(gamma, b_left, a);
      B[e] = fma(gamma, a, b_left);
    }
    // the next step's scalars R_{k+1}[k+1] and -F_{k+1}[k+2], then slot k + 1 turns into predictors:
    // f_{k+1}[k+1] = gamma g_k[k], g_{k+1}[k+1] = g_k[k], x = 0, where g_k[k] = f_k[0] = 1 (one or two threads)
    const int turn = k + 1 - j0;
    if (turn >= -1 && turn < E) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e == turn) {
          next[0] = -C[e];
          A[e] = gamma;
          B[e] = 1.0;
          C[e] = 0.0;
        }
        if (e == turn + 1) next[1] = -A[e];
      }
    }
    if (lane == 31) edge[(k & 1) ^ 1][warp] = B[E - 1];
    inv_beta = next_inv_beta;
  }
  // coh = b . x in float64, in a fixed order; SDR = 10 log10(coh / (1 - coh))
  double coh = 0.0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = j0 + e;
    if (j < length) {
      coh = fma(static_cast<double>(b[row + j]), C[e], coh);
      x_out[row + j] = static_cast<float>(C[e]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) coh += __shfl_xor_sync(0xffffffffu, coh, off);
  if (lane == 0) warp_sums[warp] = coh;
  __syncthreads();
  if (tid == 0) {
    double total = 0.0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += warp_sums[w];
    sdr[blockIdx.x] = static_cast<float>(10.0 * log10(total / (1.0 - total)));
  }
}

// The smallest E of 1, 2, 4, 8, 16 (at least kMinEntries) whose block holds the system; its threads, a multiple of
// 32.
template <int E>
cudaError_t launch_entries(const float* r0, const float* b, float* sdr, float* x, long long rows, int length,
                           cudaStream_t stream) {
  if constexpr (E < 16) {
    if (E < kMinEntries || (length + E - 1) / E > kBlockThreads<E>) {
      return launch_entries<2 * E>(r0, b, sdr, x, rows, length, stream);
    }
  }
  const int threads = ((length + E - 1) / E + 31) / 32 * 32;
  sdr_toeplitz_kernel<E><<<static_cast<unsigned int>(rows), threads, 0, stream>>>(r0, b, sdr, x, length);
  return cudaGetLastError();
}

}  // namespace

// `r0`, `b`: (rows, length) float32; `sdr`: (rows,) float32; `x`: (rows, length) float32.
extern "C" int sdr_toeplitz_launch(const void* r0, const void* b, void* sdr, void* x, long long rows, int length,
                                   void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (rows < 1 || rows > 2147483647LL || length < 1 || length > kMaxLength) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_entries<1>(static_cast<const float*>(r0), static_cast<const float*>(b),
                                            static_cast<float*>(sdr), static_cast<float*>(x), rows, length, stream));
}
