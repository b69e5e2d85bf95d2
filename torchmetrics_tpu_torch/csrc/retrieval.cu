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
// query written (8 n + 8 G bytes; the offsets besides). A query's measure
// needs only the ranks of its relevant documents (the count of words above
// each); a dense one, and the ranked layout, need its order.
//
// What the design does about it:
// - one block a query, of `threads` (uniform in a launch: an eighth of the
//   longest query's padded width, at least a warp, at most 1,024);
// - each document's word: an order-preserving key of its score above the
//   complement of its position, -0.0 folded into +0.0 and NaN given key 0,
//   below -inf: every word is unique and the descending order of the words
//   is exactly `jnp.lexsort`'s;
// - the block reads its query's scores and targets once (warp by warp, E
//   consecutive runs of 32 a warp) and counts the relevant documents;
// - the counting path (a query with few positive targets: binary targets,
//   or any for NDCG): the positives' words gathered in shared memory in
//   position order, each positive's rank the block's count of greater words
//   (n x n_pos compares, a warp reduction and a shared atomic a positive),
//   and every measure from those ranks (RR the smallest, AP each rank and
//   the positives above it, DCG the ranks, the ideal DCG the positives'
//   targets ranked among themselves, AUROC the negatives above each positive
//   and those tied with it inside the top k, from the counts of greater and
//   equal keys);
// - the sort path (dense queries, graded NDCG with many positives, the
//   ranked layout): a stable LSD radix sort of the 32-bit keys, the position
//   carried as the value, 4 passes of 8 bits in shared memory (a warp's
//   equal digits found by a match, the digit-major histogram of warps
//   scanned by the block, one scatter; two histograms, the next zeroed
//   during the scan of this one), then the scan of the ranked words;
//   past 16,384 documents (the long path) the same passes a tile of 8,192 at
//   a time through a global scratch of 16 bytes a row, the four digits'
//   histograms counted in one sweep first and a pass whose digit is the same
//   for every document skipped;
// - the ranked layout: a kernel of its own (the template's Layout), which
//   reads the scores alone, sorts them as above and writes each rank's row
//   and target from the sorted order, consecutive ranks a warp, so that the
//   writes coalesce; the measures' kernel then holds no code of it;
// - which path: kCountShort and kCountLong (at most 64 positives counted in
//   a short query, 192 in a long one) lie between tools/kernel_ablation.py's
//   crossovers of AUROC (38 positives at 256 documents to 125 at 16,384, 165
//   at 100,000) and AP (63 to 195, 230); the registers are sized for 1,024
//   threads an SM (64 a thread): sized for 2,048 the counting path ran 0.062
//   against 0.077 ms at MS MARCO's shape, the sort path 0.44 against 0.27 ms;
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
constexpr int kMaxItems = 16;      // words a thread of the short path: a query of up to 16 x threads documents
constexpr int kLongItems = 8;      // keys a thread a tile of the long path
constexpr int kLongTile = kLongItems * kMaxThreads;  // 8,192
constexpr int kDigits = 256;       // 8 bits a radix pass, 4 passes
constexpr int kMaxPositives = 256;  // the counting path's list of positives in shared memory
// a query of the short path with at most kCountShort positives takes the counting path, one past
// 16 x threads documents with at most kCountLong (see "which path" above)
constexpr int kCountShort = 64;
constexpr int kCountLong = 192;
constexpr int kThreadsAnSm = 1024;  // threads an SM the registers are sized for: 64 a thread

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
  unsigned* scratch;         // the long path: query g's keys and values at 4 * offsets[g] (two buffers)
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

__device__ __forceinline__ unsigned key_for(float s) { return s == s ? order_key(s) : 0u; }

__device__ __forceinline__ unsigned long long word_of(unsigned key, unsigned position) {
  return (static_cast<unsigned long long>(key) << 32) | (0xffffffffu - position);
}

__device__ __forceinline__ unsigned long long make_word(float s, int i) { return word_of(key_for(s), i); }

__device__ __forceinline__ unsigned key_of(unsigned long long word) { return static_cast<unsigned>(word >> 32); }
__device__ __forceinline__ int doc_of(unsigned long long word) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(word));
}

__device__ __forceinline__ float safe_div(float num, float den) { return den == 0.0f ? 0.0f : num / den; }

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
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
__shared__ int s_npos[32];
__shared__ int s_flag[32];
__shared__ unsigned s_scan[32];
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
      default:
        break;
    }
  }
}

// The query's value from its sums, by one thread.
__device__ void write_value(const Args& a, int g, int n, double n_rel, double a0, double a1, double a2, int first) {
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

// The query's value from the scan's sums, by thread 0 (all threads call it).
__device__ void finish(const Args& a, int g, int n, double n_rel, Acc acc) {
  const double a0 = block_sum(acc.a0), a1 = block_sum(acc.a1), a2 = block_sum(acc.a2);
  const int first = a.measure == kReciprocalRank ? block_min(acc.first) : INT_MAX;
  if (threadIdx.x == 0) write_value(a, g, n, n_rel, a0, a1, a2, first);
}

// ---------------------------------------------------------------- what a query's read gives
struct Stats {
  double n_rel;  // the sum of the targets
  int n_pos;     // targets > 0
  int nonbinary;  // some target is neither 0 nor 1
  int before;    // this warp's positives before it (the block's warps in order)
};

// A thread's partial sums, reduced over the block in a fixed order; `carry_pos` is added to each
// warp's prefix (the positives of earlier chunks).
__device__ Stats block_stats(double rel, int pos, bool nonbinary, int carry_pos = 0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  rel = warp_sum(rel);
  pos = __reduce_add_sync(kFull, pos);
  const int flag = __any_sync(kFull, nonbinary);
  __syncthreads();  // the static arrays may still be read from a previous call
  if (lane == 0) {
    s_red[warp] = rel;
    s_npos[warp] = pos;
    s_flag[warp] = flag;
  }
  __syncthreads();
  Stats st = {0.0, 0, 0, carry_pos};
  for (int w = 0; w < warps; ++w) {
    st.n_rel += s_red[w];
    if (w < warp) st.before += s_npos[w];
    st.n_pos += s_npos[w];
    st.nonbinary |= s_flag[w];
  }
  return st;
}

// ---------------------------------------------------------------- the counting path
// Dynamic shared memory of the counting path: the positives' words and targets in position order,
// and three counts each (greater words, greater keys, equal keys), all of the block.
struct Positives {
  unsigned long long* word;
  float* target;
  int* count;
};

__device__ __forceinline__ Positives positives_in(unsigned char* smem) {
  Positives p;
  p.word = reinterpret_cast<unsigned long long*>(smem);
  p.target = reinterpret_cast<float*>(p.word + kMaxPositives);
  p.count = reinterpret_cast<int*>(p.target + kMaxPositives);
  return p;
}

// The positives among E items a thread (item e of warp w at position w 32 E + e 32 + lane of the
// chunk) into the list, in position order: `st.before` positives precede this warp's.
template <int E>
__device__ void gather_positives(const unsigned long long (&v)[E], const float (&x)[E], const bool (&valid)[E],
                                 int before, const Positives& pos) {
  int at = before;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool is_pos = valid[e] && x[e] > 0.0f;
    const unsigned ballot = __ballot_sync(kFull, is_pos);
    if (is_pos) {
      const int i = at + __popc(ballot & lanemask_lt());
      pos.word[i] = v[e];
      pos.target[i] = x[e];
    }
    at += __popc(ballot);
  }
}

// Each positive's counts over this thread's E items, summed a warp, then added into the block's.
// The warp sums are shuffles: with __reduce_add_sync here, CUDA 12.9's ptxas at -O2 and -O3 built a
// kernel whose AUROC was wrong on queries of 33-64 documents while the same kernel also wrote the ranked
// layout from the long path, and right at -O1. The fault is not diagnosed (PERF.md section 6);
// tools/kernel_ablation.py's retrieval-fault section checks the __reduce_add_sync form of this code.
template <int E>
__device__ void count_against(const unsigned long long (&v)[E], const bool (&valid)[E], int n_pos, bool keys,
                              const Positives& pos) {
  const int lane = threadIdx.x & 31;
  for (int p = 0; p < n_pos; ++p) {
    const unsigned long long w = pos.word[p];
    const unsigned k = key_of(w);
    unsigned greater = 0, above = 0, equal = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      greater += valid[e] && v[e] > w;
      if (keys) {
        above += valid[e] && key_of(v[e]) > k;
        equal += valid[e] && key_of(v[e]) == k;
      }
    }
    greater = warp_sum(greater);
    if (keys) {
      above = warp_sum(above);
      equal = warp_sum(equal);
    }
    if (lane == 0) {
      atomicAdd(pos.count + 3 * p, static_cast<int>(greater));
      if (keys) {
        atomicAdd(pos.count + 3 * p + 1, static_cast<int>(above));
        atomicAdd(pos.count + 3 * p + 2, static_cast<int>(equal));
      }
    }
  }
}

// The measure from the positives' ranks, by warp 0 (lanes over the positives, a fixed-order sum).
__device__ void finish_counted(const Args& a, int g, int n, const Stats& st, const Positives& pos) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, n_pos = st.n_pos, m = a.measure;
  const int k_eff = a.has_k ? min(a.k_mask, n) : n;  // the top k's size
  const float n_rel_f = static_cast<float>(st.n_rel);
  double a0 = 0.0, a1 = 0.0;
  int first = INT_MAX;
  for (int j = lane; j < n_pos; j += 32) {
    const unsigned long long wj = pos.word[j];
    const int r = pos.count[3 * j];
    const bool in_k = r < k_eff;
    const float x = pos.target[j];
    switch (m) {
      case kPrecision:
      case kRecall:
      case kHitRate:
      case kFallOut:
        if (in_k) a0 += x;
        break;
      case kAveragePrecision:
        if (in_k) {
          int above = 0;  // positives ranked above: the within-query prefix of the targets is above + 1
          for (int i = 0; i < n_pos; ++i) above += pos.word[i] > wj;
          a0 += x * (static_cast<float>(above + 1) / static_cast<float>(r + 1));
          a1 += x;
        }
        break;
      case kReciprocalRank:
        if (in_k) first = min(first, r);
        break;
      case kRPrecision:
        if (static_cast<float>(r) < n_rel_f) a0 += x;
        break;
      case kNdcg: {
        if (in_k) a0 += fmaxf(x, 0.0f) * (1.0f / log2f(static_cast<float>(r) + 2.0f));
        const unsigned long long tj = make_word(x, doc_of(wj));
        int q = 0;  // the rank in the ideal order: the positives' targets, ties by position
        for (int i = 0; i < n_pos; ++i) q += make_word(pos.target[i], doc_of(pos.word[i])) > tj;
        if (q < k_eff) a1 += fmaxf(x, 0.0f) * (1.0f / log2f(static_cast<float>(q) + 2.0f));
        break;
      }
      case kAuroc:
        if (in_k) {
          const unsigned kj = key_of(wj);
          int pos_greater = 0, pos_above = 0, pos_tied_after = 0;
          for (int i = 0; i < n_pos; ++i) {
            const unsigned long long wi = pos.word[i];
            pos_greater += wi > wj;
            pos_above += key_of(wi) > kj;
            pos_tied_after += key_of(wi) == kj && wi < wj && pos.count[3 * i] < k_eff;
          }
          double credit;
          if (kj == 0u) {  // NaN: a run of its own, every word above it in earlier runs
            credit = r - pos_greater;
          } else {  // the negatives above its run, and half those of its run inside the top k
            const int above = pos.count[3 * j + 1], equal = pos.count[3 * j + 2];
            const int tied_before = (r - above) - (pos_greater - pos_above);
            const int tied_after = min(equal - 1 - (r - above), k_eff - 1 - r) - pos_tied_after;
            credit = (above - pos_above) + 0.5 * (tied_before + tied_after);
          }
          a0 += credit;
          a1 += x;
        }
        break;
      default:
        break;
    }
  }
  a0 = warp_sum(a0);
  a1 = warp_sum(a1);
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) first = min(first, __shfl_xor_sync(kFull, first, offset));
  if (lane != 0) return;
  double a2 = 0.0;
  if (m == kFallOut) a1 = k_eff - a0;  // the top k's negatives: binary targets
  if (m == kAuroc) a2 = k_eff - a1;
  write_value(a, g, n, st.n_rel, a0, a1, a2, first);
}

__device__ __forceinline__ bool counts(const Args& a, const Stats& st, bool long_query) {
  return (a.measure == kNdcg || !st.nonbinary) && st.n_pos <= kMaxPositives &&
         st.n_pos <= (long_query ? kCountLong : kCountShort);
}

// ---------------------------------------------------------------- the radix sort
// One stable pass of 8 bits over E keys a thread of a tile (item e of warp w at tile position
// w 32 E + e 32 + lane): on return hist[d * warps + w] is the tile position where warp w's items
// of digit d start, and dst[e] each item's tile position. `hist` must hold zeros; `next`, the
// histogram of the next pass, is zeroed here once the last pass's reads of it are done.
template <int E>
__device__ void rank_tile(const unsigned (&dk)[E], int shift, unsigned* hist, unsigned* next, unsigned (&dst)[E]) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, warps = blockDim.x >> 5;
  unsigned local[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const unsigned d = (dk[e] >> shift) & (kDigits - 1);
    const unsigned peers = __match_any_sync(kFull, d);
    unsigned* slot = hist + d * warps + warp;
    const unsigned base = *slot;
    __syncwarp();
    if (lane == __ffs(peers) - 1) *slot = base + __popc(peers);
    __syncwarp();
    local[e] = base + __popc(peers & lanemask_lt());
  }
  __syncthreads();
  // the exclusive scan of the digit-major histogram, 8 entries a thread (kDigits * warps = 8 threads),
  // read and written 16 bytes at a time (no bank conflicts)
  uint4* mine = reinterpret_cast<uint4*>(hist) + 2 * t;
  const uint4 lo = mine[0], hi = mine[1];
  const unsigned h[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  unsigned sum = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) sum += h[i];
  reinterpret_cast<uint4*>(next)[2 * t] = make_uint4(0u, 0u, 0u, 0u);
  reinterpret_cast<uint4*>(next)[2 * t + 1] = make_uint4(0u, 0u, 0u, 0u);
  unsigned inc = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned o = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) s_scan[warp] = inc;
  __syncthreads();
  unsigned run = inc - sum;
  for (int w = 0; w < warp; ++w) run += s_scan[w];
  unsigned out[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[i] = run;
    run += h[i];
  }
  mine[0] = make_uint4(out[0], out[1], out[2], out[3]);
  mine[1] = make_uint4(out[4], out[5], out[6], out[7]);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = hist[((dk[e] >> shift) & (kDigits - 1)) * warps + warp] + local[e];
}

// Both histograms of a sort zeroed, before its first pass.
__device__ __forceinline__ void zero_histograms(unsigned* hist) {
  for (int i = threadIdx.x; i < 2 * kDigits * (blockDim.x >> 5); i += blockDim.x) hist[i] = 0u;
  __syncthreads();
}

// The words of positions [E t, E t + E) of a sorted tile in shared memory; past `n` zero words.
template <int E>
__device__ __forceinline__ void blocked_words(const unsigned* s_key, const unsigned* s_val, int base, int n,
                                              unsigned long long (&v)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = E * threadIdx.x + e;
    v[e] = base + i < n ? word_of(~s_key[i], s_val[i]) : 0ull;
  }
}

// A query of up to E x threads documents, sorted in shared memory: 4 passes of rank_tile, each
// scattering the keys (descending order as ascending complements) and positions.
template <int E>
__device__ void sort_tile(unsigned (&dk)[E], unsigned (&val)[E], unsigned* s_key, unsigned* s_val,
                          unsigned* s_hist) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, entries = kDigits * (blockDim.x >> 5);
  zero_histograms(s_hist);
  for (int pass = 0; pass < 4; ++pass) {
    if (pass > 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = warp * 32 * E + e * 32 + lane;
        dk[e] = s_key[i];
        val[e] = s_val[i];
      }
    }
    unsigned dst[E];
    rank_tile<E>(dk, 8 * pass, s_hist + (pass & 1) * entries, s_hist + (~pass & 1) * entries, dst);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      s_key[dst[e]] = dk[e];
      s_val[dst[e]] = val[e];
    }
    __syncthreads();
  }
}

// The ranked layout of a sorted query, rank r's row given by doc_at(r): consecutive ranks a warp,
// so that the writes coalesce.
template <typename DocAt>
__device__ __forceinline__ void write_ranked(const Args& a, long long start, int n, DocAt doc_at) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const int doc = doc_at(r);
    a.out[start + r] = a.target[start + doc];
    a.ranked[start + r] = static_cast<int>(start) + doc;
  }
}

// ---------------------------------------------------------------- the short path
// A query of up to E x threads documents: one read into registers, then the counting path or a
// sort in shared memory and one scan.
template <int E>
__device__ void short_query(const Args& a, int g, long long start, int n, unsigned char* smem) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, threads = blockDim.x;
  unsigned long long v[E];
  float x[E];
  bool valid[E];
  double rel = 0.0;
  int pos = 0;
  bool nonbinary = false;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = warp * 32 * E + e * 32 + lane;
    valid[e] = i < n;
    x[e] = valid[e] ? a.target[start + i] : 0.0f;
    v[e] = valid[e] ? make_word(a.preds[start + i], i) : 0ull;
    rel += x[e];
    pos += x[e] > 0.0f;
    nonbinary |= x[e] != 0.0f && x[e] != 1.0f;
  }
  const Stats st = block_stats(rel, pos, nonbinary);
  if (counts(a, st, false)) {
    const Positives p = positives_in(smem);
    gather_positives<E>(v, x, valid, st.before, p);
    for (int i = t; i < 3 * st.n_pos; i += threads) p.count[i] = 0;
    __syncthreads();
    count_against<E>(v, valid, st.n_pos, a.measure == kAuroc, p);
    __syncthreads();
    finish_counted(a, g, n, st, p);
    return;
  }
  const int width = E * threads;
  unsigned* s_key = reinterpret_cast<unsigned*>(smem);
  unsigned* s_val = s_key + width;
  unsigned* s_hist = s_val + width;
  const float n_rel_f = static_cast<float>(st.n_rel);
  Acc acc;
  for (int pass = 0; pass < (a.measure == kNdcg ? 2 : 1); ++pass) {
    unsigned dk[E], val[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {  // pass 1: the ideal order, the same positions by target
      const int i = warp * 32 * E + e * 32 + lane;
      dk[e] = ~(pass == 0 ? key_of(v[e]) : i < n ? key_for(a.target[start + i]) : 0u);
      val[e] = i;
    }
    sort_tile<E>(dk, val, s_key, s_val, s_hist);
    unsigned long long w[E];
    blocked_words<E>(s_key, s_val, 0, n, w);
    Seg carry = {0, 0.0, 0.0, 0.0, 0.0};
    scan_chunk<E>(a, w, start, n, 0, 0u, 0u, n_rel_f, pass == 1, carry, acc);
  }
  finish(a, g, n, st.n_rel, acc);
}

// The ranked layout of a query of up to E x threads documents: its keys sorted in shared memory, then
// each rank's row and target written.
template <int E>
__device__ void short_layout(const Args& a, long long start, int n, unsigned char* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, width = E * blockDim.x;
  unsigned dk[E], val[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = warp * 32 * E + e * 32 + lane;
    dk[e] = ~(i < n ? key_for(a.preds[start + i]) : 0u);
    val[e] = i;
  }
  unsigned* s_key = reinterpret_cast<unsigned*>(smem);
  unsigned* s_val = s_key + width;
  sort_tile<E>(dk, val, s_key, s_val, s_val + width);
  write_ranked(a, start, n, [&](int r) { return static_cast<int>(s_val[r]); });
}

// ---------------------------------------------------------------- the long path
// A query longer than kMaxItems x threads (threads = 1,024): read a chunk of kLongTile at a time.
// The counting path reads it three times (the sums, the positives, the counts); the sort path
// counts the four digits' histograms in one sweep, then runs each pass whose digit is not the
// same for every document a tile at a time through the scratch (keys A, values A, keys B, values
// B at 4 * start), and scans the sorted scratch a tile at a time.
struct LongShared {
  unsigned* key;    // kLongTile
  unsigned* val;    // kLongTile
  unsigned* hist;   // 2 x kDigits x 32 warps: a tile's and the next tile's
  unsigned* count;  // 4 x kDigits: the digits' histograms over the query
  unsigned* base;   // kDigits: where each digit's next keys go
};

__device__ __forceinline__ LongShared long_shared(unsigned char* smem) {
  LongShared s;
  s.key = reinterpret_cast<unsigned*>(smem);
  s.val = s.key + kLongTile;
  s.hist = s.val + kLongTile;
  s.count = s.hist + 2 * kDigits * (kMaxThreads / 32);
  s.base = s.count + 4 * kDigits;
  return s;
}

template <int E>
__device__ __forceinline__ void load_chunk(const Args& a, long long start, int n, int base, unsigned long long (&v)[E],
                                           float (&x)[E], bool (&valid)[E]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = base + warp * 32 * E + e * 32 + lane;
    valid[e] = i < n;
    x[e] = valid[e] ? a.target[start + i] : 0.0f;
    v[e] = valid[e] ? make_word(a.preds[start + i], i) : 0ull;
  }
}

// Layout: the ranked layout (the sort, then each rank's row and target), no sums.
template <bool Layout>
__device__ void long_query(const Args& a, int g, long long start, int n, unsigned char* smem) {
  constexpr int E = kLongItems;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, threads = blockDim.x;
  unsigned long long v[E];
  float x[E];
  bool valid[E];
  double rel = 0.0;
  int pos = 0;
  bool nonbinary = false;
  for (int base = 0; !Layout && base < n; base += kLongTile) {
    load_chunk<E>(a, start, n, base, v, x, valid);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      rel += x[e];
      pos += x[e] > 0.0f;
      nonbinary |= x[e] != 0.0f && x[e] != 1.0f;
    }
  }
  const Stats st = Layout ? Stats{0.0, 0, 0, 0} : block_stats(rel, pos, nonbinary);
  if (!Layout && counts(a, st, true)) {
    const Positives p = positives_in(smem);
    int carry = 0;
    for (int base = 0; base < n; base += kLongTile) {
      load_chunk<E>(a, start, n, base, v, x, valid);
      int mine = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) mine += valid[e] && x[e] > 0.0f;
      const Stats chunk = block_stats(0.0, mine, false, carry);
      gather_positives<E>(v, x, valid, chunk.before, p);
      carry += chunk.n_pos;
    }
    for (int i = t; i < 3 * st.n_pos; i += threads) p.count[i] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += kLongTile) {
      load_chunk<E>(a, start, n, base, v, x, valid);
      count_against<E>(v, valid, st.n_pos, a.measure == kAuroc, p);
    }
    __syncthreads();
    finish_counted(a, g, n, st, p);
    return;
  }
  const LongShared s = long_shared(smem);
  unsigned* buf[2][2] = {{a.scratch + 4 * start, a.scratch + 4 * start + n},
                         {a.scratch + 4 * start + 2 * n, a.scratch + 4 * start + 3 * n}};
  const float n_rel_f = static_cast<float>(st.n_rel);
  Acc acc;
  for (int order = 0; order < (!Layout && a.measure == kNdcg ? 2 : 1); ++order) {
    const float* src = order == 0 ? a.preds : a.target;  // order 1: the ideal order, by target
    // the four digits' histograms, in one sweep
    for (int i = t; i < 4 * kDigits; i += threads) s.count[i] = 0u;
    __syncthreads();
    for (int base = 0; base < n; base += threads) {
      const int i = base + t;
      const unsigned dk = i < n ? ~key_for(src[start + i]) : 0u;
#pragma unroll
      for (int pass = 0; pass < 4; ++pass) {
        const unsigned d = i < n ? (dk >> (8 * pass)) & (kDigits - 1) : kDigits;
        const unsigned peers = __match_any_sync(kFull, d);
        if (i < n && lane == __ffs(peers) - 1) atomicAdd(s.count + pass * kDigits + d, __popc(peers));
      }
    }
    __syncthreads();
    int cur = -1;  // the buffer holding the keys in the order so far; -1: still the input's, by position
    const int entries = kDigits * (threads >> 5);
    int tiles = 0;  // tiles ranked so far: tile k ranks in histogram k & 1
    zero_histograms(s.hist);
    for (int pass = 0; pass < 4; ++pass) {
      bool all_one = false;  // every document has the same digit: the pass keeps the order
      for (int d = 0; d < kDigits; ++d) all_one |= s.count[pass * kDigits + d] == static_cast<unsigned>(n);
      if (all_one) continue;
      if (t < 32) {  // the digits' starts: warp 0, 8 digits a lane
        unsigned h[8], sum = 0u;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          h[i] = s.count[pass * kDigits + 8 * lane + i];
          sum += h[i];
        }
        unsigned inc = sum;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned o = __shfl_up_sync(kFull, inc, d);
          if (lane >= d) inc += o;
        }
        unsigned run = inc - sum;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s.base[8 * lane + i] = run;
          run += h[i];
        }
      }
      const int next = cur == 0 ? 1 : 0;
      for (int base = 0; base < n; base += kLongTile) {
        unsigned dk[E], val[E], dst[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = base + warp * 32 * E + e * 32 + lane;
          if (i >= n) {
            dk[e] = 0xffffffffu;  // after every document of the tile
            val[e] = i;
          } else if (cur < 0) {
            dk[e] = ~key_for(src[start + i]);
            val[e] = i;
          } else {
            dk[e] = buf[cur][0][i];
            val[e] = buf[cur][1][i];
          }
        }
        unsigned* hist = s.hist + (tiles & 1) * entries;
        rank_tile<E>(dk, 8 * pass, hist, s.hist + (~tiles & 1) * entries, dst);
        ++tiles;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          s.key[dst[e]] = dk[e];
          s.val[dst[e]] = val[e];
        }
        __syncthreads();
        const int len = min(kLongTile, n - base);
        for (int i = t; i < len; i += threads) {  // the tile's runs of each digit, to their places
          const unsigned key = s.key[i], d = (key >> (8 * pass)) & (kDigits - 1);
          const unsigned at = s.base[d] + i - hist[d * (threads >> 5)];
          buf[next][0][at] = key;
          buf[next][1][at] = s.val[i];
        }
        __syncthreads();
        if (t < kDigits) {
          const unsigned end = t + 1 < kDigits ? hist[(t + 1) * (threads >> 5)] : static_cast<unsigned>(len);
          s.base[t] += min(end, static_cast<unsigned>(len)) - min(hist[t * (threads >> 5)], static_cast<unsigned>(len));
        }
        __syncthreads();
      }
      cur = next;
    }
    if (Layout) {
      write_ranked(a, start, n, [&](int r) { return cur < 0 ? r : static_cast<int>(buf[cur][1][r]); });
      return;
    }
    // the scan, a chunk of kLongItems x threads words at a time
    Seg carry = {0, 0.0, 0.0, 0.0, 0.0};
    auto key_at = [&](int r) -> unsigned { return cur < 0 ? key_for(src[start + r]) : ~buf[cur][0][r]; };
    for (int base = 0; base < n; base += kLongTile) {
      unsigned long long w[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int r = base + E * t + e;
        w[e] = r >= n ? 0ull : cur < 0 ? word_of(key_for(src[start + r]), r) : word_of(~buf[cur][0][r], buf[cur][1][r]);
      }
      const unsigned prev_key = base > 0 ? key_at(base - 1) : 0u;
      const unsigned next_key = base + kLongTile < n ? key_at(base + kLongTile) : 0u;
      scan_chunk<E>(a, w, start, n, base, prev_key, next_key, n_rel_f, order == 1, carry, acc);
    }
    __syncthreads();  // every read of the scratch is done before the next order writes it
  }
  finish(a, g, n, st.n_rel, acc);
}

__device__ __forceinline__ int next_pow2(int n) { return n <= 1 ? 1 : 1 << (32 - __clz(n - 1)); }

template <int E, bool Layout>
__device__ __forceinline__ void short_path(const Args& a, int g, long long start, int n, unsigned char* smem) {
  if constexpr (Layout) {
    short_layout<E>(a, start, n, smem);
  } else {
    short_query<E>(a, g, start, n, smem);
  }
}

// One block a query, the registers sized for kThreadsAnSm threads an SM (bounded by blocks of 256
// alone they took 255 and left one block an SM). Layout: the ranked layout's kernel, apart from the
// measures' so that neither's registers are allocated with the other's code.
template <bool Layout>
__global__ void __launch_bounds__(kMaxThreads, kThreadsAnSm / kMaxThreads) retrieval_kernel(Args a) {
  extern __shared__ unsigned long long smem_words[];  // 8-byte aligned
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_words);
  const int g = blockIdx.x;
  const long long start = a.offsets[g];
  const int n = static_cast<int>(a.offsets[g + 1] - start);
  const int threads = blockDim.x;
  if (n > kMaxItems * threads) {
    long_query<Layout>(a, g, start, n, smem);
    return;
  }
  switch (max(threads, next_pow2(n)) / threads) {
    case 1: short_path<1, Layout>(a, g, start, n, smem); break;
    case 2: short_path<2, Layout>(a, g, start, n, smem); break;
    case 4: short_path<4, Layout>(a, g, start, n, smem); break;
    case 8: short_path<8, Layout>(a, g, start, n, smem); break;
    default: short_path<16, Layout>(a, g, start, n, smem); break;
  }
}

constexpr size_t kStaticShared = 4096;  // the block sums' and the scan's static arrays, at most

}  // namespace

// measure: 0 precision, 1 recall, 2 hit rate, 3 fall-out, 4 AP, 5 reciprocal rank,
// 6 R-precision, 7 NDCG, 8 AUROC, 9 the ranked layout. preds, target (n,) float32 in
// order of query id; offsets (G + 1,) int64. Scalar measures write out (G,) and n_rel
// (G,); the ranked layout writes out (n,) (the target at each rank) and ranked (n,)
// int32 (the row at each rank). scratch: 4 n 32-bit words when a query is longer than
// 16 x threads, else unused. One block of `threads` a query,
// `shared_bytes` of dynamic shared memory (the widest sort's keys, values and histogram of
// warps, or the long path's tile; at least the counting path's list).
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
  a.scratch = static_cast<unsigned*>(scratch);
  a.measure = measure;
  a.has_k = has_k;
  a.k_mask = k_mask;
  a.k_value = k_value;
  a.adaptive = adaptive;
  if (measure < kPrecision || measure > kRanked || threads < 32 || threads > kMaxThreads || threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kernel)(Args) = measure == kRanked ? retrieval_kernel<true> : retrieval_kernel<false>;
  if (static_cast<size_t>(shared_bytes) + kStaticShared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_groups, threads, shared_bytes, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
