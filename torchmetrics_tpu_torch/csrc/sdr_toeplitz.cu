// SDR's projection: for each row, the solution x of the symmetric Toeplitz
// system R x = b whose first row is the target's autocorrelation r_0, the
// coherence coh = b . x, and SDR = 10 log10(coh / (1 - coh)), by the Levinson
// recursion with a general right-hand side, in float64.
//
// Replaces torchmetrics_tpu/functional/audio/sdr.py:30-34 and :69-73: the
// (R, L, L) float32 Toeplitz matrix built by a gather (1 MB a row at the
// default filter_length 512), jnp.linalg.solve's general LU (about 2/3 L^3 =
// 89 MFLOP a row), the coherence and the log ratio. There is no TPU kernel.
// Levinson solves the same system in about 4 L^2 operations with no matrix.
//
// Bound on the card: 4 L^2 fp64 operations a system (1.05 M at L = 512),
// 34 TFLOP/s outside the tensor cores (H100 SXM data sheet, 700 W), so 0.03
// us a system; but the L steps are a dependent chain (each needs the two dot
// products of the one before), so a system's latency, not the card's rate, is
// what bounds a batch of a few dozen rows.
//
// What the design does about it:
// - one warp a system (a block of 32 threads), no block barrier: the
//   normalized off-diagonals t, the solution x and the backward vector y in
//   float64, and the right-hand side in float32, in dynamic shared memory
//   (28 L bytes: up to kMaxLength = 8,192, 224 KB of the 227 KB a block may
//   take);
// - a step's two dot products (t . reversed x, t . reversed y) in one pass and
//   one butterfly shuffle reduction of both, which every lane ends with (bit
//   for bit), so no lane waits on another for mu and alpha; one reciprocal of
//   beta a step;
// - the x and y updates in one pass over the pairs (i, k - 1 - i), each pair
//   owned by one lane, so y is updated in place with no copy and no hazard.
//
// A reflection coefficient |alpha| >= 1 (a singular or indefinite system, as a
// pure tone gives without load_diag) is not caught: the value is what the
// arithmetic gives, as JAX's LU gives what its arithmetic gives.
//
// Device work of one call, on the caller's stream: one kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLength = 8192;
constexpr int kBytesPerTap = 3 * sizeof(double) + sizeof(float);  // t, x, y in float64; b in float32

__device__ __forceinline__ void warp_sum2(double& a, double& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

// Block s (one warp) solves system s: R = toeplitz(r0[s, :]), R x = b[s, :]; writes sdr[s] and x[s, :].
__global__ void __launch_bounds__(32) sdr_toeplitz_kernel(const float* __restrict__ r0, const float* __restrict__ b,
                                                          float* __restrict__ sdr, float* __restrict__ x_out,
                                                          int length) {
  extern __shared__ double smem[];
  double* t = smem;               // t[m] = r0[m] / r0[0]; t[0] = 1 is not read
  double* x = smem + length;      // the solution of the normalized system, which is the solution of R x = b
  double* y = smem + 2 * length;  // the backward vector of Durbin's recursion
  float* rhs = reinterpret_cast<float*>(smem + 3 * length);
  const int lane = threadIdx.x;
  const long long row = static_cast<long long>(blockIdx.x) * length;
  const double diag = r0[row];
  const double inv_diag = 1.0 / diag;
  for (int m = lane; m < length; m += 32) {
    t[m] = static_cast<double>(r0[row + m]) * inv_diag;
    rhs[m] = b[row + m];
  }
  __syncwarp();
  // Golub and Van Loan, Algorithm 4.7.3, on T = R / r0[0] (unit diagonal) and c = b / r0[0]
  if (lane == 0) x[0] = static_cast<double>(rhs[0]) * inv_diag;
  double alpha = 0.0, beta = 1.0;
  if (length > 1) {
    alpha = -t[1];
    if (lane == 0) y[0] = alpha;
  }
  __syncwarp();
  for (int k = 1; k < length; ++k) {
    // dot1 = sum_{i=1..k} t[i] x[k - i], dot2 = sum_{i=1..k} t[i] y[k - i]
    double dot1 = 0.0, dot2 = 0.0;
    for (int m = lane; m < k; m += 32) {
      const double tm = t[m + 1];
      dot1 = fma(tm, x[k - 1 - m], dot1);
      dot2 = fma(tm, y[k - 1 - m], dot2);
    }
    warp_sum2(dot1, dot2);
    beta *= (1.0 - alpha) * (1.0 + alpha);
    const double inv_beta = 1.0 / beta;
    const double mu = (static_cast<double>(rhs[k]) * inv_diag - dot1) * inv_beta;
    const double next_alpha = k + 1 < length ? (-t[k + 1] - dot2) * inv_beta : 0.0;
    // x[i] += mu y[k-1-i]; y[i] += alpha y[k-1-i], both from the old y: lane by lane over the pairs (i, k-1-i)
    for (int i = lane; 2 * i < k; i += 32) {
      const int j = k - 1 - i;
      const double yi = y[i], yj = y[j];
      x[i] = fma(mu, yj, x[i]);
      y[i] = fma(next_alpha, yj, yi);
      if (j != i) {
        x[j] = fma(mu, yi, x[j]);
        y[j] = fma(next_alpha, yi, yj);
      }
    }
    if (lane == 0) {
      x[k] = mu;
      y[k] = next_alpha;
    }
    alpha = next_alpha;
    __syncwarp();
  }
  // coh = b . x in float64; SDR = 10 log10(coh / (1 - coh))
  double coh = 0.0, unused = 0.0;
  for (int m = lane; m < length; m += 32) {
    coh = fma(static_cast<double>(rhs[m]), x[m], coh);
    x_out[row + m] = static_cast<float>(x[m]);
  }
  warp_sum2(coh, unused);
  if (lane == 0) sdr[blockIdx.x] = static_cast<float>(10.0 * log10(coh / (1.0 - coh)));
}

}  // namespace

// `r0`, `b`: (rows, length) float32; `sdr`: (rows,) float32; `x`: (rows, length) float32.
extern "C" int sdr_toeplitz_launch(const void* r0, const void* b, void* sdr, void* x, long long rows, int length,
                                   void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (rows < 1 || rows > 2147483647LL || length < 1 || length > kMaxLength) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(length) * kBytesPerTap;
  cudaError_t err = cudaFuncSetAttribute(sdr_toeplitz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxLength * kBytesPerTap);
  if (err != cudaSuccess) return static_cast<int>(err);
  sdr_toeplitz_kernel<<<static_cast<unsigned int>(rows), 32, smem, stream>>>(
      static_cast<const float*>(r0), static_cast<const float*>(b), static_cast<float*>(sdr), static_cast<float*>(x),
      length);
  return static_cast<int>(cudaGetLastError());
}
