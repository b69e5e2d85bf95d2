// Per-query retrieval scores: every query's documents put in order of score
// and reduced to one value a query, one launch a measure.
//
// Replaces the XLA-lowered body of the JAX package's `rank_groups`
// (torchmetrics_tpu/functional/retrieval/kernels.py:57-98: a global lexsort
// by (query, -score), then cummax / cumsum / segment_sum passes) and its
// `grouped_*` measures (:121-231), given the rows already in order of query
// id (a stable sort of the ids, the lexsort's outer key: torch glue) and the
// offsets of each query's run. For a query of n documents, ranked by score
// descending with ties in their order in the input, NaN last and -0.0 tied
// with +0.0 (as `jnp.lexsort` has them), rank r = 0..n-1, target t_r and
// in_k = !top_k || r < top_k:
//
//   precision  sum_{in_k} t / k_eff (k_eff: n, top_k, or min(top_k, n) with adaptive_k)
//   recall     sum_{in_k} t / n_rel;   hit rate  [sum_{in_k} t > 0]
//   fall-out   sum_{in_k} (1 - t) / (n - n_rel)
//   AP         sum_{in_k} t * (float(wcum_r) / float(r + 1)) / sum_{in_k} t, wcum_r = sum_{q<=r} t_q
//   RR         1 / (first r with t > 0 and in_k, + 1), or 0
//   R-prec     sum_{r < n_rel} t / n_rel
//   NDCG       sum_{in_k} max(t, 0) / log2(r + 2), over the same sum in the order of t (a second sort)
//   AUROC      pairs / (n_pos n_neg) over the top k, each positive credited with the negatives
//              below it and half those tied with it (runs of equal scores; NaN != NaN)
//
// with n_rel = sum t over the query, every quotient JAX's float32 division
// and 0 where its denominator is 0. A further mode writes the ranked layout:
// for each query's rank r, the row at that rank and its target.
//
// Bound on the card: the scores and targets are read once and a value a
// query written (8 n + 8 G bytes; the offsets besides). Ordering each query
// is a sort of its documents (n log2 n compares, about log2^2 n / 2 stages
// for the bitonic network used here); every measure is one scan after it.
//
// What the design does about it:
// - one block a query, of `threads` (uniform in a launch: a quarter of the
//   longest query's padded width, at least a warp, at most 1,024);
// - each document becomes one 64-bit word, an order-preserving key of its
//   score above the complement of its position: -0.0 is folded into +0.0,
//   NaN gets key 0, below -inf, and the position makes every word unique,
//   so a plain descending sort gives the stable order exactly; the query
//   pads to a power of two with zero words, which fall last;
// - a query of up to 16 x threads documents (16,384 at 1,024 threads) sorts
//   in registers, E = width / threads words a thread (1, 2, 4, 8 or 16),
//   blocked: the stages whose partner is in the same thread run in
//   registers, those in the same warp through shuffles, the rest through a
//   padded shared buffer (the network of `ranking_pairs`, csrc/ranking.cu);
// - a longer query (the long path) sorts tiles of 16,384 words that way,
//   each into a global scratch of 2 words a row, then runs the merges
//   between tiles as passes over that scratch (a barrier a pass), and scans
//   it a tile at a time, carrying the scan across tiles;
// - the targets are read back by position after the sort; the per-query
//   sums are exact in double (counts, the wcum prefix, the AUROC pair count)
//   and the float32 terms (AP's quotients, NDCG's discounted gains) are
//   summed in double and rounded once; every reduction runs in a fixed
//   order, so a launch's result is the same bit for bit every time.
//
// Device work of one call, on the caller's stream: one kernel.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
constexpr int kMaxItems = 16;  // words a thread sorts in registers

enum Measure {
  kPrecision = 0,
  kRecall = 1,
  kHitRate = 2,
  kFallOut = 3,
  kAveragePrecision = 4,
  kReciprocalRank = 5,
  kRPrecision = 6,
  kNdcg = 7,
  kAuroc = 8,
  kRanked = 9,
};

struct Args {
  const float* preds;        // (n,) rows in order of query id
  const float* target;       // (n,)
  const long long* offsets;  // (G + 1,)
  float* out;                // (G,) scores, or kRanked: (n,) the target in ranked order
  float* n_rel;              // (G,) the sum of each query's targets (not kRanked)
  int* ranked;               // kRanked: (n,) the row at each rank
  unsigned long long* scratch;  // the long path: query g's words at 2 * offsets[g]
  int measure;
  int has_k;       // top_k given
  int k_mask;      // min(top_k, INT_MAX)
  float k_value;   // float32(top_k)
  int adaptive;    // precision's adaptive_k
};

// Order-preserving key of a non-NaN score: larger score, larger key; -0.0 as +0.0.
// Every such key is at least that of -inf (0x007fffff), so key 0 is free for NaN.
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned b = s == 0.0f ? 0u : __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long make_word(float s, int i) {
  const unsigned key = s == s ? order_key(s) : 0u;
  return (static_cast<unsigned long long>(key) << 32) | (0xffffffffu - static_cast<unsigned>(i));
}

__device__ __forceinline__ unsigned key_of(unsigned long long word) { return static_cast<unsigned>(word >> 32); }
__device__ __forceinline__ int doc_of(unsigned long long word) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(word));
}

// Shared slot of sorted position i: one pad word every 16, so a warp's blocked stores fall on all banks.
__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

__device__ __forceinline__ float safe_div(float num, float den) { return den == 0.0f ? 0.0f : num / den; }

// The words of `width` sorted positions (base, base + width) of a bitonic network over a
// larger power of two, descending there: thread t of the group ends with positions
// [E t, E t + E) of the tile, blocked. The pair of position i in a stage (k, j) is i ^ j;
// the pair ends descending where ((base + i) & k) == 0, ascending elsewhere, so a tile at
// base 0 ends descending and its neighbour ascending, ready to merge.
template <int E>
__device__ __forceinline__ void bitonic_sort(unsigned long long (&v)[E], unsigned long long* s_sort, int width,
                                             int group, int t, int lane, long long base) {
  for (int k = 2; k <= width; k <<= 1) {
    int j = k >> 1;
    if (j >= 32 * E) {  // the partner is in another warp: through shared memory
      __syncthreads();  // the last reads of s_sort are done
#pragma unroll
      for (int e = 0; e < E; ++e) s_sort[padded(E * t + e)] = v[e];
      __syncthreads();
      for (; j >= 32 * E; j >>= 1) {
        for (int q = t; q < (width >> 1); q += group) {
          const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          const unsigned long long x = s_sort[padded(i)], y = s_sort[padded(i + j)];
          if ((x < y) == (((base + i) & k) == 0)) {
            s_sort[padded(i)] = y;
            s_sort[padded(i + j)] = x;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = s_sort[padded(E * t + e)];
    }
    // the partner is in lane ^ (j / E); (E t + e) & k == (E t) & k, as k > j >= E > e
    const bool descending = ((base + E * t) & k) == 0;
    for (; j >= E; j >>= 1) {
      const int m = j / E;
      const bool take_max = ((lane & m) == 0) == descending;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const unsigned long long o = __shfl_xor_sync(kFull, v[e], m);
        v[e] = (take_max == (v[e] < o)) ? o : v[e];
      }
    }
    // the partner is in this thread: stages j = min(k / 2, E / 2) .. 1, unrolled
#pragma unroll
    for (int jj = E / 2; jj > 0; jj >>= 1) {
      if (jj < k) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & jj) == 0) {
            const unsigned long long x = v[e], y = v[e | jj];
            const bool swap = (x < y) == (((base + E * t + e) & k) == 0);
            v[e] = swap ? y : x;
            v[e | jj] = swap ? x : y;
          }
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(kFull, v, offset);
  return v;
}

// A segment of the scan over ranked positions: whether it holds a run start, the
// positive and negative weight since its last run start (or all of it), and its plain
// sums of the target and of the negative weight.
struct Seg {
  int starts;
  double rp, rn, pt, pn;
};

// The block's static shared memory, at namespace scope so that every instantiation of the
// query functions shares one allocation (kStaticShared bytes at most).
__shared__ double s_red[32];
__shared__ int s_min[32];
__shared__ unsigned s_edge[2][32];
__shared__ Seg s_seg[32];

// Fixed-order block sum; every thread gets it.
__device__ double block_sum(double v) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  __syncthreads();  // s_red may still be read from a previous call
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  double total = 0.0;
  for (int w = 0; w < warps; ++w) total += s_red[w];
  return total;
}

__device__ int block_min(int v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v = min(v, __shfl_xor_sync(kFull, v, offset));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) s_min[warp] = v;
  __syncthreads();
  int m = INT_MAX;
  for (int w = 0; w < warps; ++w) m = min(m, s_min[w]);
  return m;
}

__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {  // a, then b
  return {a.starts | b.starts, b.starts ? b.rp : a.rp + b.rp, b.starts ? b.rn : a.rn + b.rn, a.pt + b.pt,
          a.pn + b.pn};
}

__device__ __forceinline__ Seg shfl_up(const Seg& s, int d) {
  return {__shfl_up_sync(kFull, s.starts, d), __shfl_up_sync(kFull, s.rp, d), __shfl_up_sync(kFull, s.rn, d),
          __shfl_up_sync(kFull, s.pt, d), __shfl_up_sync(kFull, s.pn, d)};
}

// A thread's sums over the positions it scans.
struct Acc {
  double a0 = 0.0, a1 = 0.0, a2 = 0.0;
  int first = INT_MAX;
};

__device__ __forceinline__ bool starts_run(bool has_prev, unsigned prev, unsigned key) {
  return !has_prev || key == 0u || key != prev;  // NaN (key 0) is a run of its own
}

// One chunk of a query's ranked words in registers: positions base + E t + e, blocked.
// `prev_key` is the key at base - 1 (base > 0) and `next_key` the key at base + E * threads
// (when that is a document); `carry` is the scan of the positions before the chunk, the same in
// every thread, and leaves with this chunk's added. The target of each position is read back by
// its row.
template <int E>
__device__ void scan_chunk(const Args& a, const unsigned long long (&v)[E], long long start, int n, int base,
                           unsigned prev_key, unsigned next_key, float n_rel_f, bool ideal, Seg& carry, Acc& acc) {
  const int threads = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5, warps = threads >> 5;
  const int m = a.measure;

  // the keys beside this thread's positions: E t - 1 and E t + E
  unsigned before = __shfl_up_sync(kFull, key_of(v[E - 1]), 1);
  unsigned after = __shfl_down_sync(kFull, key_of(v[0]), 1);
  if (warps > 1) {
    __syncthreads();  // the last reads of s_edge are done
    if (lane == 0) s_edge[0][warp] = key_of(v[0]);
    if (lane == 31) s_edge[1][warp] = key_of(v[E - 1]);
    __syncthreads();
    if (lane == 0 && warp > 0) before = s_edge[1][warp - 1];
    if (lane == 31 && warp + 1 < warps) after = s_edge[0][warp + 1];
  }
  if (t == 0) before = prev_key;
  if (t == threads - 1) after = next_key;

  float tt[E];
  bool st[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = base + E * t + e;
    tt[e] = r < n ? a.target[start + doc_of(v[e])] : 0.0f;
    const unsigned prev = e == 0 ? before : key_of(v[e - 1]);
    st[e] = starts_run(e > 0 || t > 0 || base > 0, prev, key_of(v[e]));
  }
  auto in_k = [&](int r) { return r < n && (!a.has_k || r < a.k_mask); };
  auto item = [&](int e) -> Seg {
    const int r = base + E * t + e;
    const bool k = in_k(r);
    const float pm = k ? tt[e] : 0.0f, nm = k ? 1.0f - tt[e] : 0.0f;
    return {st[e] ? 1 : 0, pm, nm, tt[e], nm};
  };

  // the scan: the exclusive prefix of the positions before this thread's, in a fixed order
  Seg run = carry;
  const bool scan = m == kAveragePrecision || m == kAuroc;
  if (scan) {
    Seg mine = {0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int e = 0; e < E; ++e) mine = combine(mine, item(e));
    Seg inc = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Seg o = shfl_up(inc, d);
      if (lane >= d) inc = combine(o, inc);
    }
    Seg ex = shfl_up(inc, 1);
    if (lane == 0) ex = Seg{0, 0.0, 0.0, 0.0, 0.0};
    Seg total = {0, 0.0, 0.0, 0.0, 0.0};
    if (warps > 1) {
      __syncthreads();  // the last reads of s_seg are done
      if (lane == 31) s_seg[warp] = inc;
      __syncthreads();
      Seg w_ex = {0, 0.0, 0.0, 0.0, 0.0};
      for (int w = 0; w < warps; ++w) {
        if (w == warp) w_ex = total;
        total = combine(total, s_seg[w]);
      }
      ex = combine(w_ex, ex);
    } else {
      const Seg last = {__shfl_sync(kFull, inc.starts, 31), __shfl_sync(kFull, inc.rp, 31),
                        __shfl_sync(kFull, inc.rn, 31), __shfl_sync(kFull, inc.pt, 31), __shfl_sync(kFull, inc.pn, 31)};
      total = last;
    }
    run = combine(carry, ex);
    carry = combine(carry, total);
  }

#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = base + E * t + e;
    if (r >= n) continue;
    const float x = tt[e];
    const bool k = in_k(r);
    if (scan) run = combine(run, item(e));
    switch (m) {
      case kPrecision:
      case kRecall:
      case kHitRate:
      case kFallOut:
        if (k) {
          acc.a0 += x;
          acc.a1 += 1.0f - x;
        }
        break;
      case kAveragePrecision:
        if (k) {
          acc.a0 += x * (static_cast<float>(run.pt) / static_cast<float>(r + 1));
          acc.a1 += x;
        }
        break;
      case kReciprocalRank:
        if (k && x > 0.0f) acc.first = min(acc.first, r);
        break;
      case kRPrecision:
        if (static_cast<float>(r) < n_rel_f) acc.a0 += x;
        break;
      case kNdcg:
        if (k) (ideal ? acc.a1 : acc.a0) += fmaxf(x, 0.0f) * (1.0f / log2f(static_cast<float>(r) + 2.0f));
        break;
      case kAuroc: {
        acc.a1 += k ? x : 0.0f;
        acc.a2 += k ? 1.0f - x : 0.0f;
        const unsigned key = key_of(v[e]);
        const unsigned next = e + 1 < E ? key_of(v[e + 1]) : after;
        if (r + 1 >= n || starts_run(true, key, next)) acc.a0 += run.rp * (run.pn - 0.5 * run.rn);
        break;
      }
      case kRanked:
        a.out[start + r] = x;
        a.ranked[start + r] = static_cast<int>(start) + doc_of(v[e]);
        break;
      default:
        break;
    }
  }
}

// The query's value from its sums, by thread 0 (all threads call it).
__device__ void finish(const Args& a, int g, int n, double n_rel, Acc acc) {
  const double a0 = block_sum(acc.a0), a1 = block_sum(acc.a1), a2 = block_sum(acc.a2);
  const int first = a.measure == kReciprocalRank ? block_min(acc.first) : INT_MAX;
  if (threadIdx.x != 0 || a.measure == kRanked) return;
  const float rel = static_cast<float>(n_rel), size = static_cast<float>(n);
  float value = 0.0f;
  switch (a.measure) {
    case kPrecision: {
      const float k_eff = !a.has_k ? size : a.adaptive ? fminf(a.k_value, size) : a.k_value;
      value = safe_div(static_cast<float>(a0), k_eff);
      break;
    }
    case kRecall: value = safe_div(static_cast<float>(a0), rel); break;
    case kHitRate: value = static_cast<float>(a0) > 0.0f ? 1.0f : 0.0f; break;
    case kFallOut: value = safe_div(static_cast<float>(a1), size - rel); break;
    case kAveragePrecision: value = safe_div(static_cast<float>(a0), static_cast<float>(a1)); break;
    case kReciprocalRank: value = first < n ? 1.0f / (static_cast<float>(first) + 1.0f) : 0.0f; break;
    case kRPrecision: value = safe_div(static_cast<float>(a0), rel); break;
    case kNdcg: value = safe_div(static_cast<float>(a0), static_cast<float>(a1)); break;
    case kAuroc: {
      const float pairs = static_cast<float>(a1 * a2 - a0);
      value = safe_div(pairs, static_cast<float>(a1) * static_cast<float>(a2));
      break;
    }
    default: break;
  }
  a.out[g] = value;
  a.n_rel[g] = rel;
}

// A query of up to E x threads documents: sorted in registers, one chunk.
template <int E>
__device__ void short_query(const Args& a, int g, long long start, int n, int width, unsigned long long* s_sort) {
  const int t = threadIdx.x, lane = t & 31, threads = blockDim.x;
  unsigned long long v[E];
  double rel = 0.0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = t + threads * e;  // striped for coalescing: the sort does not care where a word starts
    unsigned long long word = 0ull;
    if (i < n) {
      word = make_word(a.preds[start + i], i);
      rel += a.target[start + i];
    }
    v[e] = word;
  }
  const double n_rel = block_sum(rel);
  const float n_rel_f = static_cast<float>(n_rel);
  bitonic_sort<E>(v, s_sort, width, threads, t, lane, 0);
  Seg carry = {0, 0.0, 0.0, 0.0, 0.0};
  Acc acc;
  scan_chunk<E>(a, v, start, n, 0, 0u, 0u, n_rel_f, false, carry, acc);
  if (a.measure == kNdcg) {  // the ideal order: the same positions sorted by target
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = t + threads * e;
      v[e] = i < n ? make_word(a.target[start + i], i) : 0ull;
    }
    bitonic_sort<E>(v, s_sort, width, threads, t, lane, 0);
    carry = Seg{0, 0.0, 0.0, 0.0, 0.0};
    scan_chunk<E>(a, v, start, n, 0, 0u, 0u, n_rel_f, true, carry, acc);
  }
  finish(a, g, n, n_rel, acc);
}

// A query longer than kMaxItems x threads: tiles of that many words sorted in registers
// into the query's global scratch, the merges between tiles as passes over the scratch,
// then the scan a tile at a time.
__device__ void long_query(const Args& a, int g, long long start, int n, int width, unsigned long long* s_sort) {
  constexpr int E = kMaxItems;
  const int t = threadIdx.x, lane = t & 31, threads = blockDim.x, tile = E * threads;
  unsigned long long* buf = a.scratch + 2 * start;
  double rel = 0.0;
  double n_rel = 0.0;
  Acc acc;
  for (int pass = 0; pass < (a.measure == kNdcg ? 2 : 1); ++pass) {
    const float* key_src = pass == 0 ? a.preds : a.target;
    for (int base = 0; base < width; base += tile) {
      unsigned long long v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = base + t + threads * e;
        unsigned long long word = 0ull;
        if (i < n) {
          word = make_word(key_src[start + i], i);
          if (pass == 0) rel += a.target[start + i];
        }
        v[e] = word;
      }
      bitonic_sort<E>(v, s_sort, tile, threads, t, lane, base);
#pragma unroll
      for (int e = 0; e < E; ++e) buf[base + E * t + e] = v[e];
    }
    for (int k = 2 * tile; k <= width; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        __syncthreads();  // the last pass's (or the tiles') stores are visible to the block
        for (int q = t; q < (width >> 1); q += threads) {
          const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          const unsigned long long x = buf[i], y = buf[i + j];
          if ((x < y) == ((i & k) == 0)) {
            buf[i] = y;
            buf[i + j] = x;
          }
        }
      }
    }
    __syncthreads();
    if (pass == 0) n_rel = block_sum(rel);
    const float n_rel_f = static_cast<float>(n_rel);
    Seg carry = {0, 0.0, 0.0, 0.0, 0.0};  // the scan of the tiles before
    for (int base = 0; base < n; base += tile) {
      unsigned long long v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = buf[base + E * t + e];
      const unsigned prev_key = base > 0 ? key_of(buf[base - 1]) : 0u;
      const unsigned next_key = base + tile < n ? key_of(buf[base + tile]) : 0u;
      scan_chunk<E>(a, v, start, n, base, prev_key, next_key, n_rel_f, pass == 1, carry, acc);
    }
    __syncthreads();  // every read of the scratch is done before the next pass writes it
  }
  finish(a, g, n, n_rel, acc);
}

__device__ __forceinline__ int next_pow2(int n) { return n <= 1 ? 1 : 1 << (32 - __clz(n - 1)); }

// One block a query.
__global__ void __launch_bounds__(kMaxThreads) retrieval_kernel(Args a) {
  extern __shared__ unsigned long long s_sort[];  // padded(width) words of the widest register sort
  const int g = blockIdx.x;
  const long long start = a.offsets[g];
  const int n = static_cast<int>(a.offsets[g + 1] - start);
  const int threads = blockDim.x;
  const int width = max(threads, next_pow2(n));
  switch (width / threads) {
    case 1: short_query<1>(a, g, start, n, width, s_sort); break;
    case 2: short_query<2>(a, g, start, n, width, s_sort); break;
    case 4: short_query<4>(a, g, start, n, width, s_sort); break;
    case 8: short_query<8>(a, g, start, n, width, s_sort); break;
    case 16: short_query<16>(a, g, start, n, width, s_sort); break;
    default: long_query(a, g, start, n, width, s_sort); break;
  }
}

constexpr size_t kStaticShared = 4096;  // the block sums' and the scan's static arrays, at most

}  // namespace

// measure: 0 precision, 1 recall, 2 hit rate, 3 fall-out, 4 AP, 5 reciprocal rank,
// 6 R-precision, 7 NDCG, 8 AUROC, 9 the ranked layout. preds, target (n,) float32 in
// order of query id; offsets (G + 1,) int64. Scalar measures write out (G,) and n_rel
// (G,); the ranked layout writes out (n,) (the target at each rank) and ranked (n,)
// int32 (the row at each rank). scratch: 2 n words when a query is longer than 16 x
// threads, else unused. One block of `threads` a query, `shared_bytes` of dynamic
// shared memory (the padded sort buffer of the widest register sort).
extern "C" int retrieval_groups_launch(const void* preds, const void* target, const void* offsets, int n_groups,
                                       int measure, int has_k, int k_mask, float k_value, int adaptive, void* out,
                                       void* n_rel, void* ranked, void* scratch, int threads, int shared_bytes,
                                       void* stream_ptr) {
  Args a;
  a.preds = static_cast<const float*>(preds);
  a.target = static_cast<const float*>(target);
  a.offsets = static_cast<const long long*>(offsets);
  a.out = static_cast<float*>(out);
  a.n_rel = static_cast<float*>(n_rel);
  a.ranked = static_cast<int*>(ranked);
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.measure = measure;
  a.has_k = has_k;
  a.k_mask = k_mask;
  a.k_value = k_value;
  a.adaptive = adaptive;
  if (measure < kPrecision || measure > kRanked || threads < 32 || threads > kMaxThreads || threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(shared_bytes);
  if (smem + kStaticShared > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(retrieval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  retrieval_kernel<<<n_groups, threads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
