// The SNR family's moments and values: for float32 signals, the sums
// sum(p), sum(t), sum(p^2), sum(t^2) and sum(p t) of each row (or, in pairs
// mode, of every (target j, estimate i) pair of an item's S speakers) in
// float64, then the float32 value in dB, in one launch.
//
// Replaces the XLA-lowered JAX forms of
// torchmetrics_tpu/functional/audio/snr.py:27-33 (SNR: the noise t - p and two
// squared sums), torchmetrics_tpu/functional/audio/sdr.py:83-93 (SI-SDR: the
// scale alpha, the scaled target and the noise, three sums) and :108-121
// (SA-SDR: the same summed over the speakers before the ratio), and the tile of
// torchmetrics_tpu/functional/audio/pit.py:122-127, which copies both signals
// S times to build speaker-wise PIT's (B, S, S) matrix. Those are about ten
// elementwise and reduction passes over the signals; there is no TPU kernel.
//
// Values, with JAX's eps (float32's, 2^-23) and its (x + eps) / (y + eps):
//   SNR:    (Stt + eps) / (Stt - 2 Spt + Spp + eps)
//   SI-SDR: a = (Spt + eps) / (Stt + eps); (a^2 Stt + eps) / (a^2 Stt - 2 a Spt + Spp + eps)
// with zero_mean the centred sums (Spt - Sp St / T, ...), and SA-SDR the same
// over the sums of a group of rows. The noise energy of this expanded form is
// clamped at 0. A product of two float32 values is exact in float64, so equal
// preds and target give equal sums, summed in one order, and a noise of exactly 0.
//
// Bound on the card: each input is read once, 8 bytes a sample (pairs mode:
// 8 S bytes a position); a Libri2Mix-shaped batch (32 rows of 32,000) is
// 8.2 MB, 2.4 us at 3.35 TB/s (H100 SXM data sheet, 700 W). The double
// multiply-adds, 5 (rows) or S^2 + 4 S (pairs) a position, stay under a
// quarter of the fp64 rate at that byte rate.
//
// What the design does about it:
// - blocks over (unit, chunk): a unit is a row (rows mode) or an item's 2 S
//   rows (pairs mode), a chunk a run of positions, about 8 blocks an SM in all
//   (the launcher's plan), so a single 10-minute clip fills the card;
// - 16-byte loads (4 samples) of every row of the unit where the rows start
//   aligned and T % 4 == 0, else scalar loads; each thread sums its positions
//   in registers in float64, the block reduces by warp shuffles and then in a
//   fixed warp order, and writes its chunk's partial sums;
// - the last block of a group (a ticket counts them) sums the partials in
//   chunk order, so the result does not depend on which block came last: two
//   launches give the same bits; it writes the values and sets its ticket back
//   to zero for the next launch on the stream.
//
// Device work of one call, on the caller's stream: one kernel (the partials
// are the launcher's torch.empty, the tickets its zero-on-entry scratch).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSpeakers = 6;
constexpr double kEps = 1.1920928955078125e-07;  // float32's machine epsilon, 2^-23

// A unit's sums: cross[j * S + i] = sum(p_i t_j), then sum(p_i), sum(t_j), sum(p_i^2), sum(t_j^2).
template <int S>
struct Layout {
  static constexpr int kSums = S * S + 4 * S;
  static constexpr int kP = S * S;
  static constexpr int kT = kP + S;
  static constexpr int kPP = kT + S;
  static constexpr int kTT = kPP + S;
};

// Fixed-order block sum of N doubles a thread: shuffles within each warp, then warp 0's lanes in warp order.
// Thread k < N gets sum k; every thread must call it.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N], double* smem, double* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) smem[warp * N + k] = v[k];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < N; k += kThreads) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += smem[w * N + k];
    out[k] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ double ratio_db(double stt, double spt, double spp, bool scale_invariant) {
  double sig, noise;
  if (scale_invariant) {
    const double alpha = (spt + kEps) / (stt + kEps);
    sig = alpha * alpha * stt;
    noise = sig - 2.0 * alpha * spt + spp;
  } else {
    sig = stt;
    noise = stt - 2.0 * spt + spp;
  }
  noise = noise < 0.0 ? 0.0 : noise;  // not fmax: a NaN stays NaN
  return 10.0 * log10((sig + kEps) / (noise + kEps));
}

template <int S, bool kVec>
__device__ __forceinline__ void accumulate(const float* __restrict__ preds, const float* __restrict__ target,
                                           long long length, long long begin, long long end,
                                           double (&acc)[Layout<S>::kSums]) {
  using L = Layout<S>;
  auto add = [&](const float (&p)[S], const float (&t)[S]) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const double tj = t[j];
#pragma unroll
      for (int i = 0; i < S; ++i) acc[j * S + i] = fma(static_cast<double>(p[i]), tj, acc[j * S + i]);
      acc[L::kT + j] += tj;
      acc[L::kTT + j] = fma(tj, tj, acc[L::kTT + j]);
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const double pi = p[i];
      acc[L::kP + i] += pi;
      acc[L::kPP + i] = fma(pi, pi, acc[L::kPP + i]);
    }
  };
  if constexpr (kVec) {
    for (long long q = begin / 4 + threadIdx.x; q < end / 4; q += kThreads) {
      float4 pv[S], tv[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        pv[s] = reinterpret_cast<const float4*>(preds + s * length)[q];
        tv[s] = reinterpret_cast<const float4*>(target + s * length)[q];
      }
      float p[S], t[S];
#pragma unroll
      for (int s = 0; s < S; ++s) { p[s] = pv[s].x; t[s] = tv[s].x; }
      add(p, t);
#pragma unroll
      for (int s = 0; s < S; ++s) { p[s] = pv[s].y; t[s] = tv[s].y; }
      add(p, t);
#pragma unroll
      for (int s = 0; s < S; ++s) { p[s] = pv[s].z; t[s] = tv[s].z; }
      add(p, t);
#pragma unroll
      for (int s = 0; s < S; ++s) { p[s] = pv[s].w; t[s] = tv[s].w; }
      add(p, t);
    }
  } else {
    for (long long q = begin + threadIdx.x; q < end; q += kThreads) {
      float p[S], t[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        p[s] = preds[s * length + q];
        t[s] = target[s * length + q];
      }
      add(p, t);
    }
  }
}

// Block (unit u, chunk c) sums positions [c * chunk, min((c + 1) * chunk, length)) of unit u's rows into
// partials[(u * chunks + c) * kSums ...]. Units are rows (S == 1, `group` rows a value: SA-SDR's speakers)
// or items of S speakers (pairs mode, group == 1). The last block of a group writes its value(s).
template <int S, bool kVec>
__global__ void __launch_bounds__(kThreads) snr_moments_kernel(const float* __restrict__ preds,
                                                                const float* __restrict__ target,
                                                                float* __restrict__ out, double* partials,
                                                                unsigned int* tickets, long long length,
                                                                long long chunk, int chunks, int group,
                                                                int scale_invariant, int zero_mean) {
  using L = Layout<S>;
  constexpr int N = L::kSums;
  __shared__ double smem[kWarps * N];
  __shared__ double sums[N];
  __shared__ bool last;
  const long long unit = blockIdx.x;
  const int c = blockIdx.y;
  const long long row0 = unit * S;
  double acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0.0;
  const long long begin = c * chunk;
  const long long end = min(begin + chunk, length);
  accumulate<S, kVec>(preds + row0 * length, target + row0 * length, length, begin, end, acc);
  block_sum<N>(acc, smem, partials + (unit * chunks + c) * N);

  __threadfence();  // this block's partials before its ticket
  __syncthreads();
  const long long g = unit / group;
  if (threadIdx.x == 0) {
    const unsigned int expected = static_cast<unsigned int>(group) * static_cast<unsigned int>(chunks);
    last = atomicAdd(tickets + g, 1u) == expected - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // the other blocks' partials after their tickets

  // The group's sums: each unit's partials in chunk order (a fixed split over the threads), centred if asked,
  // summed over the group's units in order. Only thread 0 reads `sums` between the barriers of block_sum.
  double stt = 0.0, spt = 0.0, spp = 0.0;
  const double n = static_cast<double>(length);
  for (long long u = g * group; u < (g + 1) * group; ++u) {
    double part[N];
#pragma unroll
    for (int k = 0; k < N; ++k) part[k] = 0.0;
    const volatile double* base = partials + u * chunks * N;
    for (int cc = threadIdx.x; cc < chunks; cc += kThreads) {
#pragma unroll
      for (int k = 0; k < N; ++k) part[k] += base[cc * N + k];
    }
    block_sum<N>(part, smem, sums);
    if (threadIdx.x == 0 && S == 1) {
      double tt = sums[L::kTT], pt = sums[0], pp = sums[L::kPP];
      if (zero_mean) {
        tt -= sums[L::kT] * sums[L::kT] / n;
        pt -= sums[L::kP] * sums[L::kT] / n;
        pp -= sums[L::kP] * sums[L::kP] / n;
      }
      stt += tt;
      spt += pt;
      spp += pp;
    }
  }
  if constexpr (S == 1) {
    if (threadIdx.x == 0) out[g] = static_cast<float>(ratio_db(stt, spt, spp, scale_invariant != 0));
  } else {  // pairs mode: out[g, j, i] = value(estimate i, target j)
    for (int k = threadIdx.x; k < S * S; k += kThreads) {
      const int j = k / S, i = k % S;
      double tt = sums[L::kTT + j], pt = sums[k], pp = sums[L::kPP + i];
      if (zero_mean) {
        tt -= sums[L::kT + j] * sums[L::kT + j] / n;
        pt -= sums[L::kP + i] * sums[L::kT + j] / n;
        pp -= sums[L::kP + i] * sums[L::kP + i] / n;
      }
      out[g * S * S + k] = static_cast<float>(ratio_db(tt, pt, pp, scale_invariant != 0));
    }
  }
  if (threadIdx.x == 0) tickets[g] = 0u;  // zero again for the next launch on the stream
}

template <int S>
cudaError_t launch_speakers(const float* preds, const float* target, float* out, double* partials,
                            unsigned int* tickets, long long units, long long length, long long chunk, int chunks,
                            int group, int scale_invariant, int zero_mean, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(units), chunks);
  const bool vec = length % 4 == 0 && chunk % 4 == 0 && reinterpret_cast<uintptr_t>(preds) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(target) % 16 == 0;
  if (vec) {
    snr_moments_kernel<S, true><<<grid, kThreads, 0, stream>>>(preds, target, out, partials, tickets, length, chunk,
                                                              chunks, group, scale_invariant, zero_mean);
  } else {
    snr_moments_kernel<S, false><<<grid, kThreads, 0, stream>>>(preds, target, out, partials, tickets, length, chunk,
                                                               chunks, group, scale_invariant, zero_mean);
  }
  return cudaGetLastError();
}

}  // namespace

// `preds`, `target`: (units * speakers, length) float32. `out`: (units / group) values (speakers == 1) or
// (units, speakers, speakers) (pairs). `partials`: units * chunks * (S^2 + 4 S) doubles. `tickets`: units /
// group zeros. Block (u, c) sums positions [c * chunk, (c + 1) * chunk) of unit u.
extern "C" int snr_moments_launch(const void* preds, const void* target, void* out, void* partials, void* tickets,
                                  long long units, long long length, long long chunk, int chunks, int speakers,
                                  int group, int scale_invariant, int zero_mean, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (units < 1 || units > 2147483647LL || length < 0 || chunk < 1 || chunks < 1 || chunks > 65535 || group < 1 ||
      units % group != 0 || (speakers > 1 && group != 1) || (length > 0 && (chunks - 1) * chunk >= length)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* p = static_cast<const float*>(preds);
  const float* t = static_cast<const float*>(target);
  float* o = static_cast<float*>(out);
  double* part = static_cast<double*>(partials);
  unsigned int* tick = static_cast<unsigned int*>(tickets);
  switch (speakers) {
    case 1: return launch_speakers<1>(p, t, o, part, tick, units, length, chunk, chunks, group, scale_invariant,
                                      zero_mean, stream);
    case 2: return launch_speakers<2>(p, t, o, part, tick, units, length, chunk, chunks, group, scale_invariant,
                                      zero_mean, stream);
    case 3: return launch_speakers<3>(p, t, o, part, tick, units, length, chunk, chunks, group, scale_invariant,
                                      zero_mean, stream);
    case 4: return launch_speakers<4>(p, t, o, part, tick, units, length, chunk, chunks, group, scale_invariant,
                                      zero_mean, stream);
    case 5: return launch_speakers<5>(p, t, o, part, tick, units, length, chunk, chunks, group, scale_invariant,
                                      zero_mean, stream);
    case kMaxSpeakers: return launch_speakers<kMaxSpeakers>(p, t, o, part, tick, units, length, chunk, chunks, group,
                                                            scale_invariant, zero_mean, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
