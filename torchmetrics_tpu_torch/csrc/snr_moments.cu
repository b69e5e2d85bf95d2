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
//   rows (pairs mode); the launcher's plan sizes a chunk so that a thread's
//   16-byte loads of it (kLoads / S a row, each row aligned and T % 4 == 0;
//   else scalar loads) are all issued before its first multiply-add, and cuts
//   a long row into more chunks until the card is full;
// - each thread sums in registers in float64, the block reduces by warp
//   shuffles and then in a fixed warp order into its shared memory;
// - a group's chunks (a row, an item, or SA-SDR's `group` rows) form one
//   thread-block cluster where they fit one (up to kCluster blocks): each block
//   writes its sums into the first block's shared memory (distributed shared
//   memory), and after one cluster barrier the first block sums them in rank
//   order and writes the value(s), with no global partials, ticket or fence;
// - a group with more chunks than a cluster holds (a 10-minute clip) merges at
//   a second level, a block a cluster: each block writes its chunk's sums, and
//   the group's last block (a ticket counts them) sums them in chunk order and
//   sets its ticket back to zero for the next launch on the stream.
// Both merges run in a fixed order, so two launches give the same bits.
//
// Device work of one call, on the caller's stream: one kernel (the partials
// of the second level are the launcher's torch.empty, the tickets its
// zero-on-entry scratch).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSpeakers = 6;
constexpr int kLoads = 8;    // 16-byte loads of each row a thread issues at once, at one speaker (kLoads / S at S)
constexpr int kCluster = 8;  // blocks a cluster at most (the portable size)
constexpr double kEps = 1.1920928955078125e-07;  // float32's machine epsilon, 2^-23

// A unit's sums: cross[j * S + i] = sum(p_i t_j), then sum(p_i), sum(t_j), sum(p_i^2), sum(t_j^2).
template <int S>
struct Layout {
  static constexpr int kSums = S * S + 4 * S;
  static constexpr int kP = S * S;
  static constexpr int kT = kP + S;
  static constexpr int kPP = kT + S;
  static constexpr int kTT = kPP + S;
  static constexpr int kRowLoads = kLoads / S > 0 ? kLoads / S : 1;
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
    // a batch: kRowLoads 16-byte loads of each of the 2 S rows, all issued before the first multiply-add; a load
    // past the chunk reads nothing and adds zeros
    constexpr int RL = L::kRowLoads;
    const long long q_end = end / 4;
    for (long long q = begin / 4 + threadIdx.x; q < q_end; q += static_cast<long long>(kThreads) * RL) {
      float4 pv[RL][S], tv[RL][S];
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const long long idx = q + r * kThreads;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (idx < q_end) {
            pv[r][s] = reinterpret_cast<const float4*>(preds + s * length)[idx];
            tv[r][s] = reinterpret_cast<const float4*>(target + s * length)[idx];
          } else {
            pv[r][s] = tv[r][s] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        float p[S], t[S];
#pragma unroll
        for (int s = 0; s < S; ++s) { p[s] = pv[r][s].x; t[s] = tv[r][s].x; }
        add(p, t);
#pragma unroll
        for (int s = 0; s < S; ++s) { p[s] = pv[r][s].y; t[s] = tv[r][s].y; }
        add(p, t);
#pragma unroll
        for (int s = 0; s < S; ++s) { p[s] = pv[r][s].z; t[s] = tv[r][s].z; }
        add(p, t);
#pragma unroll
        for (int s = 0; s < S; ++s) { p[s] = pv[r][s].w; t[s] = tv[r][s].w; }
        add(p, t);
      }
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

// A unit's centred (if asked) Stt, Spt, Spp for the pair (target j, estimate i).
template <int S>
__device__ __forceinline__ void pair_sums(const double* sums, int j, int i, double n, bool zero_mean, double& tt,
                                          double& pt, double& pp) {
  using L = Layout<S>;
  tt = sums[L::kTT + j];
  pt = sums[j * S + i];
  pp = sums[L::kPP + i];
  if (zero_mean) {
    tt -= sums[L::kT + j] * sums[L::kT + j] / n;
    pt -= sums[L::kP + i] * sums[L::kT + j] / n;
    pp -= sums[L::kP + i] * sums[L::kP + i] / n;
  }
}

// The values of `units` consecutive units' sums (kSums each), which form group g: one value of the group's summed
// moments (S == 1), or a unit's S x S pair values (pairs mode, one unit a group). Thread 0 (S == 1) or the block.
template <int S>
__device__ __forceinline__ void write_values(const double* sums, int units, long long g, float* out, double n,
                                             bool scale_invariant, bool zero_mean) {
  if constexpr (S == 1) {
    if (threadIdx.x != 0) return;
    double stt = 0.0, spt = 0.0, spp = 0.0;
    for (int u = 0; u < units; ++u) {
      double tt, pt, pp;
      pair_sums<1>(sums + u * Layout<1>::kSums, 0, 0, n, zero_mean, tt, pt, pp);
      stt += tt;
      spt += pt;
      spp += pp;
    }
    out[g] = static_cast<float>(ratio_db(stt, spt, spp, scale_invariant));
  } else {  // pairs mode: out[g, j, i] = value(estimate i, target j)
    for (int k = threadIdx.x; k < S * S; k += kThreads) {
      double tt, pt, pp;
      pair_sums<S>(sums, k / S, k % S, n, zero_mean, tt, pt, pp);
      out[g * S * S + k] = static_cast<float>(ratio_db(tt, pt, pp, scale_invariant));
    }
  }
}

// Block (unit u, chunk c) sums positions [c * chunk, min((c + 1) * chunk, length)) of unit u's rows. Units are
// rows (S == 1, `group` rows a value: SA-SDR's speakers) or items of S speakers (pairs mode, group == 1). A cluster
// is (group units) x (all chunks), or one block whose sums the second level merges by `partials` and a ticket.
template <int S, bool kVec>
__global__ void __launch_bounds__(kThreads) snr_moments_kernel(const float* __restrict__ preds,
                                                                const float* __restrict__ target,
                                                                float* __restrict__ out, double* partials,
                                                                unsigned int* tickets, long long length,
                                                                long long chunk, int chunks, int group,
                                                                int scale_invariant, int zero_mean) {
  using L = Layout<S>;
  constexpr int N = L::kSums;
  __shared__ double warp_part[kWarps * N];
  __shared__ double block_sums[N];           // this block's sums, read by its cluster's first block
  __shared__ double merged[kCluster * N];    // the first block: the cluster's sums of each of its units
  __shared__ double gathered[kCluster * N];  // the first block: every block's sums, by cluster rank
  __shared__ bool last;
  cg::cluster_group cluster = cg::this_cluster();
  const long long unit = blockIdx.x;
  const int c = blockIdx.y;
  const long long row0 = unit * S;
  double acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0.0;
  const long long begin = min(c * chunk, length);
  const long long end = min(begin + chunk, length);
  accumulate<S, kVec>(preds + row0 * length, target + row0 * length, length, begin, end, acc);
  block_sum<N>(acc, warp_part, block_sums);

  // each block writes its sums into the first block's shared memory at its cluster rank; after one cluster barrier
  // the first block sums each unit's chunks in rank order, and the others are done
  const dim3 shape = cluster.dim_blocks();  // (units, chunks) of the cluster
  const int units_in = static_cast<int>(shape.x), chunks_in = static_cast<int>(shape.y);
  const int rank = static_cast<int>(cluster.block_rank());
  if (threadIdx.x < N) cluster.map_shared_rank(gathered, 0)[rank * N + threadIdx.x] = block_sums[threadIdx.x];
  cluster.sync();
  const bool first = rank == 0;
  if (!first) return;
  for (int k = threadIdx.x; k < units_in * N; k += kThreads) {
    const int ux = k / N, s = k % N;
    double v = 0.0;
    for (int cy = 0; cy < chunks_in; ++cy) v += gathered[(ux + cy * units_in) * N + s];
    merged[k] = v;
  }
  __syncthreads();
  const double n = static_cast<double>(length);
  if (units_in == group && chunks_in == chunks) {  // the cluster is the group
    write_values<S>(merged, group, unit / group, out, n, scale_invariant != 0, zero_mean != 0);
    return;
  }

  // second level: one unit a cluster; the group's last cluster sums the partials in (unit, cluster) order
  const int clusters = chunks / chunks_in;
  const int cl = c / chunks_in;
  for (int k = threadIdx.x; k < N; k += kThreads) partials[(unit * clusters + cl) * N + k] = merged[k];
  __threadfence();  // this cluster's partials before its ticket
  __syncthreads();
  const long long g = unit / group;
  if (threadIdx.x == 0) {
    const unsigned int expected = static_cast<unsigned int>(group) * static_cast<unsigned int>(clusters);
    last = atomicAdd(tickets + g, 1u) == expected - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // the other clusters' partials after their tickets
  // each unit's partials in cluster order (a fixed split over the threads), centred if asked, summed over the
  // group's units in order. Only thread 0 reads `block_sums` between the barriers of block_sum.
  double stt = 0.0, spt = 0.0, spp = 0.0;
  for (long long u = g * group; u < (g + 1) * group; ++u) {
    double part[N];
#pragma unroll
    for (int k = 0; k < N; ++k) part[k] = 0.0;
    const volatile double* base = partials + u * clusters * N;
    for (int cc = threadIdx.x; cc < clusters; cc += kThreads) {
#pragma unroll
      for (int k = 0; k < N; ++k) part[k] += base[cc * N + k];
    }
    block_sum<N>(part, warp_part, block_sums);
    if (threadIdx.x == 0 && S == 1) {
      double tt, pt, pp;
      pair_sums<S>(block_sums, 0, 0, n, zero_mean != 0, tt, pt, pp);
      stt += tt;
      spt += pt;
      spp += pp;
    }
  }
  if constexpr (S == 1) {
    if (threadIdx.x == 0) out[g] = static_cast<float>(ratio_db(stt, spt, spp, scale_invariant != 0));
  } else {
    write_values<S>(block_sums, 1, g, out, n, scale_invariant != 0, zero_mean != 0);
  }
  if (threadIdx.x == 0) tickets[g] = 0u;  // zero again for the next launch on the stream
}

// The cluster of a launch: a group's units x its chunks where they fit kCluster blocks, else one block (the
// second level merges them).
inline dim3 cluster_shape(int chunks, int group) {
  if (static_cast<long long>(group) * chunks <= kCluster) return dim3(group, chunks, 1);
  return dim3(1, 1, 1);
}

template <int S>
cudaError_t launch_speakers(const float* preds, const float* target, float* out, double* partials,
                            unsigned int* tickets, long long units, long long length, long long chunk, int chunks,
                            int group, int scale_invariant, int zero_mean, cudaStream_t stream) {
  const bool vec = length % 4 == 0 && chunk % 4 == 0 && reinterpret_cast<uintptr_t>(preds) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(target) % 16 == 0;
  auto kernel = snr_moments_kernel<S, false>;
  if (vec) kernel = snr_moments_kernel<S, true>;
  if constexpr (kCluster > 8) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  const dim3 shape = cluster_shape(chunks, group);
  attr[0].val.clusterDim.x = shape.x;
  attr[0].val.clusterDim.y = shape.y;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>(units), chunks, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, preds, target, out, partials, tickets, length, chunk, chunks, group,
                            scale_invariant, zero_mean);
}

}  // namespace

// `preds`, `target`: (units * speakers, length) float32. `out`: (units / group) values (speakers == 1) or
// (units, speakers, speakers) (pairs). `partials`: units * (chunks / the cluster's chunks) * (S^2 + 4 S) doubles where
// a group's chunks outnumber a cluster's blocks, else unused. `tickets`: units / group zeros. Block (u, c) sums
// positions [c * chunk, (c + 1) * chunk) of unit u.
extern "C" int snr_moments_launch(const void* preds, const void* target, void* out, void* partials, void* tickets,
                                  long long units, long long length, long long chunk, int chunks, int speakers,
                                  int group, int scale_invariant, int zero_mean, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (units < 1 || units > 2147483647LL || length < 0 || chunk < 1 || chunks < 1 || chunks > 65535 || group < 1 ||
      units % group != 0 || (speakers > 1 && group != 1) || chunks * chunk < length) {
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
