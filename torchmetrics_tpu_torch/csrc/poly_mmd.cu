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
// Arithmetic: each dot product on the tensor cores in three TF32 passes, each
// operand split into hi = tf32(x) (cvt.rna's rounding: to nearest, ties away)
// and lo = tf32(x - hi), the float32 accumulators gaining lo.hi, hi.lo and
// hi.hi a step of 8 (one TF32 pass errs by 1e-6 of the terms' scale on
// features with outlier dimensions; three stay within float32's own noise).
// The tensor cores' float32 sums do not round each add to nearest: over a
// whole row of 2,048 they lose 1e-6 of the terms' scale where a few large
// products come first, so every kPromote chunks (64 features, 8 steps) a
// warpgroup moves its accumulators into float32 sums of its own (CUDA-core
// adds, rounded to nearest) and starts them again from zero. A dot product that comes out inf or NaN is taken again as
// float32 fused multiply-adds in order of k from the rows in device memory, so
// the non-finite values are the plain version's (a NaN stays a NaN through the
// split, a hi past float32's range is inf and its lo 0). Then (dot * gamma) +
// coef rounded twice, as JAX's `f1 @ f2.T * gamma + coef`, and the power by
// binary exponentiation, as `lax.integer_pow` (x^3 = x * (x * x)); the sums are
// float64.
//
// Bound on the card: the products. At KID's defaults (100 subsets of m = 1,000
// rows, d = 2,048) the symmetric xx and yy halves counted once, 2 m^2 d
// multiply-adds a subset: 8.2e11 flop, 12.2 ms as float32 at 67 TFLOP/s, 4.96
// ms as three TF32 passes at 495 TFLOP/s (H100 SXM data sheet, 700 W).
//
// What the design does about it:
// - a block owns a tile of kRows x kCols entries of one of a subset's three
//   matrices (grid.x the tiles of a subset: the tiles of xy, then those of the
//   upper triangles of xx and yy; grid.y the subsets, so a subset's tiles run
//   together and its 16 MB of rows stay in L2);
// - the products are wgmma m64nNk8, N = kCols: the tile's columns (B) from
//   shared memory in the 128-byte swizzle, its rows (A) from registers. Shared
//   memory is what bounds a split on this card (wgmma's operand reads, the
//   split's stores and the copies share its 128 bytes a clock), so each
//   operand goes through it at most once, already split;
// - warp-specialised, the producers' registers handed to the consumers by
//   setmaxnreg: two producer warpgroups read the tile's columns by index from
//   the feature matrices in chunks of 32 features (a row's 128-byte line) by
//   16-byte loads into registers, two chunks ahead, split them there and store
//   hi and lo into a ring of kStages slots; two consumer warpgroups of 64 rows
//   each read their wgmma A fragments of the tile's rows straight from the
//   feature matrices (8-byte loads, a chunk ahead: the slots hold each step's
//   features in an order that makes a fragment's two of a row adjacent) and
//   split them in registers. They meet at named barriers, one pair a slot
//   (full, empty);
// - rows are read by index (each row's address taken from the index once, into
//   shared memory), zero past d and past m; 4-byte loads where d % 4 != 0 or a
//   base is not 16-byte aligned; the split by integer adds and masks (the
//   conversion pipe is slower);
// - the epilogue raises each entry to `degree` in registers and adds it in
//   float64: an entry of xy weighs 1, one of xx or yy with i < j weighs 2 (its
//   mirror is the same product), the rest of xx and yy and entries past m are
//   skipped; a block's sum goes to its subset's scratch sum by one float64
//   atomic, and the subset's last block (a ticket) takes the three sums with
//   atomic exchanges (leaving them zero for the next launch), writes out[s] and
//   sets its ticket back to zero.
// PERF.md (section 6) records what the card showed of the designs beside this
// one: tools/kernel_ablation.py --sections poly_mmd.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kConsumers = 256;  // two warpgroups of products
constexpr int kProducers = 256;  // two warpgroups of loads and splits
constexpr int kThreads = kConsumers + kProducers;
constexpr int kConsumerRegs = 192, kProducerRegs = 64;  // each thread's registers once the roles are taken
constexpr int kRows = 128;     // a tile's rows: 64 a consumer warpgroup, wgmma's M
constexpr int kCols = 128;     // a tile's columns: wgmma's N
constexpr int kChunk = 32;     // features a slot: a 128-byte row, the swizzle's width
constexpr int kSteps = kChunk / 8;  // wgmma's steps of 8 a chunk
constexpr int kStages = 4;     // the ring's slots, each a chunk's columns split: hi, then lo
constexpr int kPromote = 2;    // chunks between moves of the accumulators into float32 sums
constexpr int kSlotHalf = kCols * kChunk;  // floats of a slot's hi (or lo) half
constexpr int kGroups = kChunk / 4;        // 16-byte pieces a row
constexpr int kPieces = kCols * kGroups / kProducers;  // a producer's pieces of a chunk
constexpr int kWarpRows = kCols / (kProducers / 32);   // the columns a producer warp loads and splits
constexpr int kAlign = 8 * kChunk * 4;                 // the swizzle's atom: 8 rows
constexpr int kAcc = kCols / 2;                        // a consumer's accumulators
constexpr int kFull = 1, kEmpty = 1 + kStages;         // named barriers (0 is __syncthreads'): a pair a slot,
constexpr int kEpilogue = 1 + 2 * kStages;             // and the consumers' own
static_assert(kChunk == 32, "128-byte rows: wgmma's 128-byte swizzle");
static_assert(kRows == 128 && kConsumers == 256, "two consumer warpgroups of 64 rows");
static_assert(kCols * kGroups % kProducers == 0 && kWarpRows % (32 / kGroups) == 0, "whole rounds a warp");
static_assert(kStages >= 2 && kEpilogue < 16, "16 named barriers");
static_assert(kPromote >= 1, "a promotion every kPromote chunks");
static_assert(kConsumers * kConsumerRegs + kProducers * kProducerRegs <= 65536, "an SM's registers");

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

// a slot's float k of column row `row`: rows of kChunk floats, each 16-byte group's index XORed with row % 8:
// wgmma's 128-byte swizzle
__device__ __forceinline__ int staged(int row, int k) {
  const int at = row * kChunk + k;
  return at ^ (((at >> 5) & (kGroups - 1)) << 2);
}

// named barriers of N threads (the producers and the consumers, or the consumers alone): arrive without waiting,
// or wait for all N
template <int N>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

// x = hi + lo: hi = tf32(x) rounded to nearest, ties away (cvt.rna.tf32.f32's rounding: 0x1000 added to the
// bits, the low 13 cleared), lo = tf32(x - hi). A NaN's hi is the canonical NaN (the add would carry some NaNs into
// the sign bit: -0); where hi is inf or NaN (x non-finite, or past the largest TF32) lo is 0
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = x != x ? 0x7fffffffu : (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const uint32_t rest = __float_as_uint(x - __uint_as_float(hi));
  lo = (hi & 0x7f800000u) == 0x7f800000u ? 0u : (rest + 0x1000u) & 0xffffe000u;
}

// a K-major operand of 8-row groups of 128-byte rows, swizzled as staged, for wgmma
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint64_t d = (addr & 0x3ffffu) >> 4;  // start address
  d |= uint64_t(1) << 16;                // leading byte offset: unused by a swizzled K-major operand
  d |= uint64_t(kAlign >> 4) << 32;      // stride byte offset: from one 8-row group to the next
  d |= uint64_t(1) << 62;                // the 128-byte swizzle
  return d;
}

// D (64 x N, float32, in registers) += A (64 x 8 TF32, in registers: a warp's 16 rows, a0 (g, q), a1 (g + 8, q),
// a2 (g, q + 4), a3 (g + 8, q + 4) for lane 4 g + q) B (N x 8 TF32, K-major in shared memory by descriptor)
template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// the registers are read or written again only after the wait that covers their products
template <int R>
__device__ __forceinline__ void hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&a)[2][kSteps][4]) {
#pragma unroll
  for (int i = 0; i < 2 * kSteps * 4; ++i)
    asm volatile("" : "+r"(a[i / (4 * kSteps)][(i / 4) % kSteps][i % 4])::"memory");
}

// the first column tile of row tile I that holds an entry i < j of xx or yy
__host__ __device__ __forceinline__ int first_col_tile(int I) { return (I * kRows + 1) / kCols; }

// the tile of block b of a subset: xy's tr x tc tiles, then the upper triangles of xx and yy, each row tile I with
// the column tiles from first_col_tile(I) on
__device__ __forceinline__ void tile_of(int b, int tr, int tc, int& which, int& ti, int& tj) {
  if (b < tr * tc) {
    which = 0;
    ti = b / tc;
    tj = b % tc;
    return;
  }
  b -= tr * tc;
  which = 1;
  ti = 0;
  while (b >= tc - first_col_tile(ti)) {
    b -= tc - first_col_tile(ti);
    if (++ti == tr) {
      ti = 0;
      which = 2;
    }
  }
  tj = first_col_tile(ti) + b;
}

struct Tile {
  const float* const* rows;  // the tile's rows, then its columns, in device memory (null past m)
  float* slots;              // kStages x 2 kSlotHalf, kAlign-aligned
  int d, chunks, vec;
};

// the first n of 4 floats at src, zero past them: one 16-byte load where vec (then n is 0 or 4), else 4-byte ones
__device__ __forceinline__ float4 load4(const float* src, int n, int vec) {
  if (vec) return n > 0 ? __ldg(reinterpret_cast<const float4*>(src)) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return make_float4(n > 0 ? __ldg(src) : 0.0f, n > 1 ? __ldg(src + 1) : 0.0f, n > 2 ? __ldg(src + 2) : 0.0f,
                     n > 3 ? __ldg(src + 3) : 0.0f);
}

// the slots' order of a step's 8 features: places j and j + 4 hold features 2 j and 2 j + 1 (j < 4), so that a
// consumer's A fragment of a step (places q and q + 4 of rows r0 and r0 + 8) is two 8-byte loads. A dot product does
// not see the order. pair_at: the first place of the 16-byte piece q of a chunk's row (features 4 q .. 4 q + 3)
__device__ __forceinline__ int pair_at(int q) { return 8 * (q >> 1) + 2 * (q & 1); }

// floats k and k + 1 of a row (null: zero), zero past d: one 8-byte load where vec, else 4-byte ones
__device__ __forceinline__ float2 load2(const float* row, int k, int d, int vec) {
  if (row == nullptr || k >= d) return make_float2(0.0f, 0.0f);
  if (vec) return __ldg(reinterpret_cast<const float2*>(row + k));
  return make_float2(__ldg(row + k), k + 1 < d ? __ldg(row + k + 1) : 0.0f);
}

struct Producer {
  const Tile& t;
  int p, q;                 // the producer and its 16-byte group of a row
  const float* col[kPieces];  // its columns' rows in device memory

  // piece i: the tile's column kWarpRows (p / 32) + (32 / kGroups) i + (p % 32) / kGroups
  __device__ __forceinline__ int column(int i) const {
    return kWarpRows * (p >> 5) + 32 / kGroups * i + (p & 31) / kGroups;
  }

  // chunk c's pieces into registers
  __device__ __forceinline__ void fetch(int c, float4 (&v)[kPieces]) const {
    if (c >= t.chunks) return;
    const int k = c * kChunk + 4 * q;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int n = col[i] == nullptr ? 0 : min(4, t.d - k);
      v[i] = load4(col[i] + k, n, t.vec);
    }
  }

  // chunk c's pieces from registers into its slot, split: hi, then lo, each step's features in the slots' order
  // (`pair_at`); then the slot's full barrier. The slot's last chunk's products are done first (its empty barrier)
  __device__ __forceinline__ void put(int c, const float4 (&v)[kPieces]) const {
    if (c >= kStages) bar_sync<kThreads>(kEmpty + c % kStages);
    float* hi = t.slots + (c % kStages) * 2 * kSlotHalf;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      uint4 h, l;
      split(v[i].x, h.x, l.x);
      split(v[i].y, h.y, l.y);
      split(v[i].z, h.z, l.z);
      split(v[i].w, h.w, l.w);
      // features 4 q + {0, 2} to places pair_at(q) + {0, 1} of the row, 4 q + {1, 3} to pair_at(q) + {4, 5}
      const int p0 = staged(column(i), pair_at(q)), p1 = staged(column(i), pair_at(q) + 4);
      *reinterpret_cast<uint2*>(hi + p0) = make_uint2(h.x, h.z);
      *reinterpret_cast<uint2*>(hi + p1) = make_uint2(h.y, h.w);
      *reinterpret_cast<uint2*>(hi + kSlotHalf + p0) = make_uint2(l.x, l.z);
      *reinterpret_cast<uint2*>(hi + kSlotHalf + p1) = make_uint2(l.y, l.w);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stores, to the tensor cores
    bar_arrive<kThreads>(kFull + c % kStages);
  }

  // chunk c's pieces are loaded two chunks before they are split and stored: two sets of registers, in turn
  __device__ __forceinline__ void run() {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) col[i] = t.rows[kRows + column(i)];
    float4 a[kPieces], b[kPieces];
    fetch(0, a);
    fetch(1, b);
    for (int c = 0; c < t.chunks; c += 2) {
      put(c, a);
      fetch(c + 2, a);
      if (c + 1 < t.chunks) {
        put(c + 1, b);
        fetch(c + 3, b);
      }
    }
  }
};

struct Consumer {
  const Tile& t;
  int wg, q;                 // the warpgroup, and the consumer's column of a step's A fragment
  const float* row[2];       // its two rows of the fragment in device memory: r0 and r0 + 8 of the tile
  bool rows_here;            // the warpgroup holds an entry to add
  float (&acc)[kAcc];
  float (&sum)[kAcc];

  // chunk c's A fragment, as loaded: [step of 8][register], a0 (r0, q), a1 (r0 + 8, q), a2 (r0, q + 4), a3 (r0 + 8,
  // q + 4): in the slots' order features 2 q and 2 q + 1 of the step, an 8-byte load a row
  __device__ __forceinline__ void fetch(int c, float (&v)[kSteps][4]) const {
    if (c >= t.chunks) return;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int k = c * kChunk + 8 * ks + 2 * q;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 x = load2(row[r], k, t.d, t.vec);
        v[ks][r] = x.x;
        v[ks][r + 2] = x.y;
      }
    }
  }

  // chunk by chunk: the A fragment split in registers, lo.hi, hi.lo and hi.hi a step of 8 against the slot's
  // columns, the next chunk's fragment loaded while the products run; every kPromote chunks the accumulators go
  // into float32 sums and start again from zero
  __device__ __forceinline__ void run() {
    float v[kSteps][4];
    uint32_t a[2][kSteps][4];  // [hi, lo][step][register]
    fetch(0, v);
    for (int c = 0; c < t.chunks; ++c) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
        for (int e = 0; e < 4; ++e) split(v[ks][e], a[0][ks][e], a[1][ks][e]);
      }
      bar_sync<kThreads>(kFull + c % kStages);
      if (rows_here) {
        const float* b = t.slots + (c % kStages) * 2 * kSlotHalf;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          const uint64_t bh = smem_desc(b + 8 * ks), bl = smem_desc(b + kSlotHalf + 8 * ks);
          Wgmma<kCols>::run(acc, a[1][ks], bh);
          Wgmma<kCols>::run(acc, a[0][ks], bl);
          Wgmma<kCols>::run(acc, a[0][ks], bh);
        }
      }
      wgmma_commit();
      fetch(c + 1, v);  // while the products run
      wgmma_wait_all();  // on every path: chunk c's products are done, its slot and fragment free
      hold(a);
      hold(acc);
      if (c + kStages < t.chunks) bar_arrive<kThreads>(kEmpty + c % kStages);
      if ((c + 1) % kPromote == 0) {  // the accumulators into the float32 sums
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          sum[i] += acc[i];
          acc[i] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += sum[i];
  }
};

__global__ void __launch_bounds__(kThreads, 1) poly_mmd_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const long long* __restrict__ ix,
    const long long* __restrict__ iy, float* __restrict__ out, double* __restrict__ sums,
    unsigned int* __restrict__ tickets, int m, int d, int degree, float gamma, float coef, int tr, int tc, int vec) {
  extern __shared__ float4 dyn4[];
  __shared__ const float* rows[kRows + kCols];
  __shared__ double warp_sums[kConsumers / 32];
  __shared__ int n_redo;  // the tile's entries whose product came out inf or NaN
  __shared__ bool last;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dyn4));
  float* slots = reinterpret_cast<float*>(dyn4) + ((kAlign - base % kAlign) % kAlign) / sizeof(float);

  const int s = blockIdx.y;
  int which, ti, tj;  // which: 0 xy, 1 xx, 2 yy
  tile_of(static_cast<int>(blockIdx.x), tr, tc, which, ti, tj);
  const float* fa = which == 2 ? y : x;
  const float* fb = which == 1 ? x : y;
  const long long* ia = (which == 2 ? iy : ix) + static_cast<long long>(s) * m;
  const long long* ib = (which == 1 ? ix : iy) + static_cast<long long>(s) * m;
  const int row0 = ti * kRows, col0 = tj * kCols;
  for (int r = threadIdx.x; r < kRows + kCols; r += kThreads) {
    const int i = r < kRows ? row0 + r : col0 + r - kRows;
    rows[r] = i >= m ? nullptr : r < kRows ? fa + ia[i] * d : fb + ib[i] * d;
  }
  if (threadIdx.x == 0) n_redo = 0;
  __syncthreads();

  const bool symmetric = which != 0;
  const Tile t{rows, slots, d, (d + kChunk - 1) / kChunk, vec};
  // the warpgroup, warp-uniform as the compiler sees it (a shuffle): a wgmma on a path it cannot prove uniform is
  // serialized (ptxas C7520). The producers hand registers to the consumers and leave once their last chunk is in
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  const int lane = static_cast<int>(threadIdx.x & 31), warp = static_cast<int>(threadIdx.x >> 5);
  if (wg >= kConsumers / 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    Producer{t, static_cast<int>(threadIdx.x) - kConsumers, lane % kGroups, {}}.run();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // consumer warpgroups 0 and 1 take the tile's rows 64 wg .. 64 wg + 63, a warp 16 of them; the warpgroup holds an
  // entry to add (uniform over it): a row below m and, in xx and yy, below a column
  const int r_first = 64 * wg + 16 * (warp & 3) + (lane >> 2);
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  {
    float sum[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) sum[i] = 0.0f;
    const int cols_here = min(col0 + kCols, m);
    Consumer{t, wg, lane & 3, {rows[r_first], rows[r_first + 8]}, row0 + 64 * wg < (symmetric ? cols_here - 1 : m),
             acc, sum}.run();
  }
  bar_sync<kConsumers>(kEpilogue);  // every product is done: the slots hold the list of non-finite entries
  int* redo = reinterpret_cast<int*>(slots);

  // the accumulators: rows r and r + 8 of the warp's 16, columns 8 j + 2 (lane % 4) and the next
  double local = 0.0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_first + 8 * half;
    const int i = row0 + r;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
      for (int odd = 0; odd < 2; ++odd) {
        const int c = 8 * j + 2 * (lane & 3) + odd;
        const int jj = col0 + c;
        if (i >= m || jj >= m || (symmetric && i >= jj)) continue;
        const float dot = acc[4 * j + 2 * half + odd];
        if (!isfinite(dot)) {  // taken again below
          redo[atomicAdd(&n_redo, 1)] = (r << 16) | c;
          continue;
        }
        local += static_cast<double>(integer_pow(__fadd_rn(__fmul_rn(dot, gamma), coef), degree));
      }
    }
  }
  bar_sync<kConsumers>(kEpilogue);
  // an inf or NaN product again as float32 fused multiply-adds in order of k from the rows in device memory: the
  // plain version's non-finite values
  for (int e = threadIdx.x; e < n_redo; e += kConsumers) {
    const float* a = rows[redo[e] >> 16];
    const float* b = rows[kRows + (redo[e] & 0xffff)];
    float dot = 0.0f;
    for (int k = 0; k < d; ++k) dot = __fmaf_rn(a[k], b[k], dot);
    local += static_cast<double>(integer_pow(__fadd_rn(__fmul_rn(dot, gamma), coef), degree));
  }
  local *= symmetric ? 2.0 : 1.0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) local += __shfl_xor_sync(0xffffffffu, local, off);
  if (lane == 0) warp_sums[warp] = local;
  bar_sync<kConsumers>(kEpilogue);
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < kConsumers / 32; ++w) total += warp_sums[w];
    atomicAdd(sums + 3 * s + which, total);
    __threadfence();
    const unsigned int blocks = static_cast<unsigned int>(gridDim.x);
    last = atomicAdd(tickets + s, 1u) == blocks - 1;
  }
  bar_sync<kConsumers>(kEpilogue);
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
  const int tr = (m + kRows - 1) / kRows, tc = (m + kCols - 1) / kCols;
  long long blocks = static_cast<long long>(tr) * tc;
  for (int i = 0; i < tr; ++i) blocks += 2LL * (tc - first_col_tile(i));
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  // the alignment's slack and the ring: past the default 48 KB, opted in
  const int dynamic = kAlign + kStages * 2 * kSlotHalf * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(poly_mmd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = d % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<std::uintptr_t>(y) % 16 == 0;
  const dim3 grid(static_cast<unsigned int>(blocks), static_cast<unsigned int>(subsets));
  poly_mmd_kernel<<<grid, kThreads, dynamic, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const long long*>(ix),
      static_cast<const long long*>(iy), static_cast<float*>(out), static_cast<double*>(sums),
      static_cast<unsigned int*>(tickets), m, d, degree, gamma, coef, tr, tc, vec);
  return static_cast<int>(cudaGetLastError());
}
