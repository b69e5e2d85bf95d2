// BERTScore's greedy matching: for each pair b of prediction and target
// embeddings (Tp, H) and (Tt, H), with their 0/1 masks and optional idf
// weights, the cosine similarity of every token pair, each prediction token's
// best match (the maximum over its row) and each target token's (over its
// column), and precision, recall and F1 as their weighted means, in one
// launch. The (B, Tp, Tt) similarity is never written.
//
// Replaces torchmetrics_tpu/functional/text/bert.py:234-265
// (_bert_score_from_embeddings): the row normalisation with its 1e-12 clamp,
// the bph,bth->bpt einsum, the validity mask (an invalid entry is 0), both
// maxima over the whole padded axis (a NaN among them wins, as JAX's max),
// the weighted sums and P, R and F1 with their 1e-12 clamps. There is no TPU
// kernel.
//
// Bound on the card: the valid tokens' rows read once at 3.35 TB/s (H100 SXM
// data sheet, 700 W). At WMT16's 2,999 pairs of lengths 10-128 and
// roberta-large's H = 1,024 that is 509 us; the valid pairs' products, three
// TF32 passes of 2 Lp Lt H operations at 495 TFLOP/s, take 179 us.
//
// What the design does about it:
// - a block a pair, two blocks an SM; the rows with a mask above 0 on each
//   side are listed by warp ballots and a prefix (BERTScore's masks have
//   holes where the special tokens were), and only those are read and
//   multiplied, in passes over blocks of up to 128 x 128 listed rows (one pass
//   below 129 valid tokens a side: each valid row is read once);
// - an axis with an entry outside the list (within Tp or Tt) floors the other
//   side's maxima at 0, as JAX's where(valid, sim, 0) over the padded axis
//   does; a listed pair keeps JAX's rule pm * tm > 0;
// - chunks of 16 of H of the pass's rows go by cp.async into a ring of four
//   stages, three chunks ahead: a warp copies its 32 rows, 64 bytes of 8 rows
//   a copy (16 bytes a lane, or 4 where H % 4 != 0 or a base is not 16-byte
//   aligned; past H zero-filled), and asks L2 for the 256 bytes around each
//   miss, so a row's later chunks hit L2; a row's 64 bytes are swizzled in
//   16-byte groups as wgmma's 64-byte swizzle reads them, free of bank
//   conflicts for the copies, the split and the tensor cores;
// - a thread a row splits each chunk: the row's sum of squares in order of k
//   (the norms cost no second read of device memory), the row rewritten in
//   place as hi = tf32(x) and its lo = tf32(x - hi) written to one of two lo
//   buffers (cvt.rna's rounding, to nearest and ties away, by integer adds
//   and masks: the conversion pipe is slower);
// - the products run on the tensor cores as wgmma m64nNk8 with TF32 operands
//   from shared memory, in three passes: the float32 accumulators gain lo.hi,
//   hi.lo and hi.hi (one TF32 pass errs by 1e-4 on embeddings with outlier
//   dimensions; three stay within float32's noise). Each of the two
//   warpgroups owns 64 rows of the pass and skips them past the list; the
//   side whose rows waste less as 64s (wgmma's rows) against the other as 32s
//   (N) takes the rows;
// - one barrier a chunk: chunk c's products run beside the split of chunk
//   c + 1, whose copies each warp waits for itself, and the copies of chunks
//   c + 2 and c + 3 stay in flight;
// - the similarity is the dot product times both inverse norms, 1 / max(
//   sqrt(ss), 1e-12); the maxima are folded in registers and warp shuffles
//   (a row within one warp), the columns across warps through shared memory
//   in a fixed order, NaN winning;
// - P, R and F1 by fixed-order block reductions: two launches give the same
//   bits.
// PERF.md (section 6) records what the card showed of the designs beside this
// one: tools/kernel_ablation.py --sections bert.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 128;  // listed rows a side a pass
constexpr int kChunk = 16;   // H a stage: 64 bytes a row, the swizzle's width
constexpr int kStages = 4;
constexpr int kSideFloats = kBlock * kChunk;
constexpr int kStageFloats = 2 * kSideFloats;  // prediction rows, then target rows
constexpr int kGroups = kChunk / 4;            // 16-byte groups a row
constexpr int kAlign = 8 * kChunk * 4;         // the swizzle's atom: 8 rows
static_assert(kChunk == 16, "64-byte rows: wgmma's 64-byte swizzle");
static_assert(kThreads == 2 * kBlock, "a thread a staged row for the norms");
static_assert(kWarps * kBlock <= kSideFloats, "the columns' partials fit the lo rows");
// a warp copies its 32 rows' chunks together, a lane a 16-byte piece, 8 rows a round
constexpr int kPieces = kChunk / 4;
constexpr int kRowsARound = 32 / kPieces;
constexpr int kRounds = 32 / kRowsARound;

// JAX's max: a NaN on either side wins (fmaxf returns the other operand)
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

// a row's staged float k: rows of kChunk floats, each 16-byte group's index XORed with the address's 128-byte line
// modulo 4, (row / 2) % 4: wgmma's 64-byte swizzle
__device__ __forceinline__ int staged(int row, int k) {
  const int at = row * kChunk + k;
  return at ^ (((at >> 5) & (kGroups - 1)) << 2);
}

__device__ __forceinline__ void copy16(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// all but this thread's last N groups of copies have landed
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo: hi = tf32(x) rounded to nearest, ties away (cvt.rna.tf32.f32's rounding: 0x1000 added to the
// bits, the low 13 cleared), lo = tf32(x - hi). On the integer pipe: cvt's conversion pipe held the split back
// (tools/kernel_ablation.py --sections bert builds the cvt.rna form, which gives the same bits)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// a K-major operand of 8-row groups of 64-byte rows, swizzled as staged, for wgmma
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint64_t d = (addr & 0x3ffffu) >> 4;  // start address
  d |= uint64_t(1) << 16;                // leading byte offset: unused by a swizzled K-major operand
  d |= uint64_t(kAlign >> 4) << 32;      // stride byte offset: from one 8-row group to the next
  d |= uint64_t(2) << 62;                // the 64-byte swizzle
  return d;
}

// D (64 x N, float32, in registers) += A (64 x 8 TF32) B (N x 8 TF32), both K-major in shared memory by descriptor
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void run(float (&d)[48], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// the accumulators are read only after wgmma_wait
template <int R>
__device__ __forceinline__ void hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the block's sums of four values, each by a warp's shuffle tree and then the warps in order, on thread 0
__device__ __forceinline__ float4 block_sum4(float4 v, float4* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
    v.z += __shfl_xor_sync(0xffffffffu, v.z, off);
    v.w += __shfl_xor_sync(0xffffffffu, v.w, off);
  }
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float4 total = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) {
      total.x += scratch[w].x;
      total.y += scratch[w].y;
      total.z += scratch[w].z;
      total.w += scratch[w].w;
    }
  }
  return total;
}

struct Shared {  // the block's shared memory beside the dynamic arrays
  float inv_p[kBlock], inv_t[kBlock], mask_p[kBlock], mask_t[kBlock];
  int counts[2][kWarps];
  float4 scratch[kWarps];
};

// the positions i < n of each side with mask[i] > 0, in order, into its list, and the masks of the first kBlock of
// them into sh (a pass's masks); counts[side] their count. The thread's masks of i = threadIdx.x are m0[side].
__device__ void list_valid(const float* const* mask, const int* n, const float* m0, unsigned short* const* list,
                           float* const* first, int* count, int (*counts)[kWarps]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  count[0] = count[1] = 0;
  for (int i0 = 0; i0 < max(n[0], n[1]); i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    float m[2];
    unsigned vote[2];
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      m[side] = i >= n[side] ? 0.0f : i0 == 0 ? m0[side] : mask[side][i];
      vote[side] = __ballot_sync(0xffffffffu, m[side] > 0.0f);
      if (lane == 0) counts[side][warp] = __popc(vote[side]);
    }
    __syncthreads();
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      int before = count[side], total = 0;
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? counts[side][w] : 0;
        total += counts[side][w];
      }
      if (m[side] > 0.0f) {
        const int at = before + __popc(vote[side] & ((1u << lane) - 1u));
        list[side][at] = static_cast<unsigned short>(i);
        if (at < kBlock) first[side][at] = m[side];
      }
      count[side] += total;
    }
    __syncthreads();  // counts is written again
  }
}

struct Pass {
  const float* p;  // the pair's (Tp, H) rows
  const float* t;  // (Tt, H)
  const float* pm;  // the pair's masks
  const float* tm;
  const unsigned short* p_list;  // the pass's first listed rows
  const unsigned short* t_list;
  int nr, nc, h, vec;
  bool gather;  // the pass's masks from device memory (a pair of several passes), else the lists' first
  float* mask_a;  // the pass's masks in shared memory: its rows' and its columns'
  float* mask_b;
  float* stages;  // kStages x kStageFloats, kAlign-aligned
  float* lo;      // 2 x kStageFloats: the rows' lo parts as a stage holds their hi parts; then the columns' partials
  float* row_max;
  float* col_max;
};

// chunk c of H of the warp's 32 rows (each lane's src: its own row in device memory, or null past the pass's
// lists; first the row of the warp's first lane) into the chunk's stage, a copy of the warp taking 16-byte pieces
// of 8 rows, 64 bytes a row; and a group of copies either way
__device__ __forceinline__ void load_chunk(const Pass& s, const float* src, int first_row, int c, int chunks) {
  if (c < chunks) {
    float* stage = s.stages + (c % kStages) * kStageFloats;
    const int lane = threadIdx.x & 31, q = lane % kPieces;
    const int k = c * kChunk + 4 * q;
#pragma unroll
    for (int i = 0; i < kRounds; ++i) {
      const int owner = i * kRowsARound + lane / kPieces;
      const float* row = reinterpret_cast<const float*>(
          __shfl_sync(0xffffffffu, reinterpret_cast<unsigned long long>(src), owner));
      if (!row) continue;
      float* dst = stage + staged(first_row + owner, 4 * q);
      if (s.vec) {  // H % 4 == 0: a piece is all in or all out
        copy16(dst, k < s.h ? row + k : row, k < s.h);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) copy4(dst + e, k + e < s.h ? row + k + e : row, k + e < s.h);
      }
    }
  }
  commit();
}

// the thread's staged row of chunk c: its sum of squares in order of k; the row becomes hi in place, its lo goes
// to the same place of the chunk's lo buffer (two, in turn)
__device__ __forceinline__ void split_rows(const Pass& s, int c, bool on_target, int row, float& ss) {
  float* stage = s.stages + (c % kStages) * kStageFloats;
  float* lo = s.lo + (c % 2) * kStageFloats;
  const int side = on_target ? kSideFloats : 0;
#pragma unroll
  for (int v = 0; v < kChunk / 4; ++v) {
    const int at = side + staged(row, 4 * v);
    const float4 x = *reinterpret_cast<const float4*>(stage + at);
    ss = fmaf(x.x, x.x, ss);
    ss = fmaf(x.y, x.y, ss);
    ss = fmaf(x.z, x.z, ss);
    ss = fmaf(x.w, x.w, ss);
    uint4 hi, l;
    split(x.x, hi.x, l.x);
    split(x.y, hi.y, l.y);
    split(x.z, hi.z, l.z);
    split(x.w, hi.w, l.w);
    *reinterpret_cast<uint4*>(stage + at) = hi;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

// one pass: the listed rows [i0, i0 + nr) x [j0, j0 + nc), N >= nc columns of wgmma
template <int N>
__device__ __forceinline__ void pass(const Pass& s, Shared& sh) {
  const int wg = threadIdx.x >> 7;                      // warpgroup: rows 64 wg .. 64 wg + 63
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3;               // the fragments' row group and column pair
  const int r_frag = 64 * wg + 16 * (warp & 3) + g;     // the thread's first accumulator row
  const bool rows_here = 64 * wg < s.nr;                // uniform over the warpgroup
  // a thread a staged row for the norms, the masks and the split: prediction rows, then target rows
  const bool on_target = threadIdx.x >= kBlock;
  const int my_row = on_target ? threadIdx.x - kBlock : threadIdx.x;
  const bool has_row = my_row < (on_target ? s.nc : s.nr);
  if (has_row && s.gather) {
    if (on_target) s.mask_b[my_row] = s.tm[s.t_list[my_row]];
    else s.mask_a[my_row] = s.pm[s.p_list[my_row]];
  }
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  float ss = 0.0f;

  // one barrier a chunk: chunk c's products run on the tensor cores while each thread waits for its copies of
  // chunk c + 1 and splits them, and the copies of chunks c + 2 .. c + kStages - 1 are in flight
  const int chunks = (s.h + kChunk - 1) / kChunk;
  const float* src = !has_row ? nullptr
                     : on_target ? s.t + static_cast<long long>(s.t_list[my_row]) * s.h
                                 : s.p + static_cast<long long>(s.p_list[my_row]) * s.h;
  const int first_row = threadIdx.x & ~31;  // the warp's first row of a stage: [side][row][k]
  for (int c = 0; c < kStages - 1; ++c) load_chunk(s, src, first_row, c, chunks);
  wait_copies<kStages - 2>();  // the lane's copies of chunk 0 have landed
  __syncwarp();                // and the warp's
  if (has_row) split_rows(s, 0, on_target, my_row, ss);
  for (int c = 0; c < chunks; ++c) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the split's stores, to the tensor cores
    __syncthreads();  // chunk c is split, and chunk c - 1's products are done: its stage and lo buffer are free
    load_chunk(s, src, first_row, c + kStages - 1, chunks);
    if (rows_here) {  // the warpgroup's 64 prediction rows against the pass's target rows, hi and lo of chunk c
      const float* a = s.stages + (c % kStages) * kStageFloats + 64 * wg * kChunk;
      const float* a_lo = s.lo + (c % 2) * kStageFloats + 64 * wg * kChunk;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        const uint64_t ah = smem_desc(a + 8 * ks), al = smem_desc(a_lo + 8 * ks);
        const uint64_t bh = smem_desc(a - 64 * wg * kChunk + kSideFloats + 8 * ks);
        const uint64_t bl = smem_desc(a_lo - 64 * wg * kChunk + kSideFloats + 8 * ks);
        Wgmma<N>::run(acc, al, bh);
        Wgmma<N>::run(acc, ah, bl);
        Wgmma<N>::run(acc, ah, bh);
      }
      wgmma_commit();
    }
    wait_copies<kStages - 2>();  // the lane's copies of chunk c + 1 have landed
    __syncwarp();                // and the warp's
    if (has_row && c + 1 < chunks) split_rows(s, c + 1, on_target, my_row, ss);
    wgmma_wait();  // on every path: a wait only where products were issued lets them run beside the split
    hold(acc);
  }
  if (has_row) {
    const float inv = 1.0f / fmaxf(sqrtf(ss), 1e-12f);
    if (on_target) sh.inv_t[my_row] = inv;
    else sh.inv_p[my_row] = inv;
  }
  __syncthreads();  // the norms and masks are in; the lo rows are free for the columns' partials

  // the similarities (0 where a listed pair is invalid, -inf past the lists): a row's maximum within its warp
  // straight into the running maximum, a column's over the warp's 16 rows into the partials; a warp (and a column
  // tile) past the lists skips its part
  float* part_cols = s.lo;  // [warp][kBlock]
  const bool warp_here = 64 * wg + 16 * (warp & 3) < s.nr;  // uniform over the warp
  if (warp_here) {
    const int r0 = r_frag, r1 = r_frag + 8;  // the thread's rows: g and g + 8 of the warp's 16
    const bool in0 = r0 < s.nr, in1 = r1 < s.nr;
    const float mp0 = in0 ? s.mask_a[r0] : 0.0f, ip0 = in0 ? sh.inv_p[r0] : 0.0f;
    const float mp1 = in1 ? s.mask_a[r1] : 0.0f, ip1 = in1 ? sh.inv_p[r1] : 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      if (8 * j >= s.nc) break;  // uniform
#pragma unroll
      for (int odd = 0; odd < 2; ++odd) {  // columns 8 j + 2 q4 and 8 j + 2 q4 + 1
        const int c = 8 * j + 2 * q4 + odd;
        const bool inc = c < s.nc;
        const float mt = inc ? s.mask_b[c] : 0.0f, it = inc ? sh.inv_t[c] : 0.0f;
        const float v0 = in0 && inc ? (mp0 * mt > 0.0f ? acc[4 * j + odd] * ip0 * it : 0.0f) : -INFINITY;
        const float v1 = in1 && inc ? (mp1 * mt > 0.0f ? acc[4 * j + 2 + odd] * ip1 * it : 0.0f) : -INFINITY;
        m0 = nan_max(m0, v0);
        m1 = nan_max(m1, v1);
        float m = nan_max(v0, v1);
        m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, 4));
        m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, 8));
        m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, 16));
        if (g == 0) part_cols[warp * kBlock + c] = m;
      }
    }
    m0 = nan_max(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = nan_max(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = nan_max(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = nan_max(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    if (q4 == 0 && in0) s.row_max[s.p_list[r0]] = nan_max(s.row_max[s.p_list[r0]], m0);
    if (q4 == 0 && in1) s.row_max[s.p_list[r1]] = nan_max(s.row_max[s.p_list[r1]], m1);
  }
  __syncthreads();
  if (on_target && has_row) {  // a listed column's maximum over the warps that hold rows, in order
    float m = s.col_max[s.t_list[my_row]];
    for (int w = 0; w < kWarps; ++w)
      if (64 * (w / 4) + 16 * (w % 4) < s.nr) m = nan_max(m, part_cols[w * kBlock + my_row]);
    s.col_max[s.t_list[my_row]] = m;
  }
  __syncthreads();  // the partials, masks and norms are written again by the next pass
}

__global__ void __launch_bounds__(kThreads, 2) bert_greedy_match_kernel(
    const float* __restrict__ pred, const float* __restrict__ tgt, const float* __restrict__ pred_mask,
    const float* __restrict__ tgt_mask, const float* __restrict__ pred_w, const float* __restrict__ tgt_w,
    int tp, int tt, int h, int vec, float* __restrict__ precision, float* __restrict__ recall,
    float* __restrict__ f1) {
  extern __shared__ float4 dyn4[];
  __shared__ Shared sh;
  // the stages and the lo rows on a kAlign boundary (the launch adds kAlign bytes), then the running maxima and
  // the lists
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dyn4));
  float* stages = reinterpret_cast<float*>(dyn4) + ((kAlign - base % kAlign) % kAlign) / sizeof(float);
  float* lo = stages + kStages * kStageFloats;
  float* row_max = lo + 2 * kStageFloats;  // tp: a listed row's running maximum
  float* col_max = row_max + tp;      // tt
  unsigned short* p_list = reinterpret_cast<unsigned short*>(col_max + tt);  // tp
  unsigned short* t_list = p_list + tp;                                     // tt

  const long long b = blockIdx.x;
  const float* pm = pred_mask + b * tp;
  const float* tm = tgt_mask + b * tt;
  // the thread's first masks and weights, read at once: the lists and the sums take them from registers
  const int i = threadIdx.x;
  const float pm0 = i < tp ? pm[i] : 0.0f, tm0 = i < tt ? tm[i] : 0.0f;
  const float pw0 = i < tp && pred_w ? pred_w[b * tp + i] : 1.0f, tw0 = i < tt && tgt_w ? tgt_w[b * tt + i] : 1.0f;
  const float* masks[2] = {pm, tm};
  const int lengths[2] = {tp, tt};
  const float m0[2] = {pm0, tm0};
  unsigned short* const lists[2] = {p_list, t_list};
  float* const first[2] = {sh.mask_p, sh.mask_t};
  int count[2];
  list_valid(masks, lengths, m0, lists, first, count, sh.counts);
  const int np = count[0], nt = count[1];
  // an entry outside the other side's list is invalid, 0: it floors this side's maxima
  const float row_start = nt < tt ? 0.0f : -INFINITY;
  const float col_start = np < tp ? 0.0f : -INFINITY;
  for (int i = threadIdx.x; i < tp; i += kThreads) row_max[i] = row_start;
  for (int j = threadIdx.x; j < tt; j += kThreads) col_max[j] = col_start;
  __syncthreads();

  for (int i0 = 0; i0 < np; i0 += kBlock) {
    for (int j0 = 0; j0 < nt; j0 += kBlock) {
      const int nr = min(kBlock, np - i0), nc = min(kBlock, nt - j0);
      const float* p = pred + b * tp * h;
      const float* t = tgt + b * tt * h;
      // wgmma's rows (A) come in 64s and its columns (B) in 32s: the side whose rounding wastes less is A. The
      // target as A swaps the roles: its maxima are then the rows'
      const bool swap = (nc + 63) / 64 * ((nr + 31) / 32) < (nr + 63) / 64 * ((nc + 31) / 32);
      const bool gather = np > kBlock || nt > kBlock;
      const Pass s = swap ? Pass{t, p, tm, pm, t_list + j0, p_list + i0, nc, nr, h, vec, gather, sh.mask_t, sh.mask_p,
                                 stages, lo, col_max, row_max}
                          : Pass{p, t, pm, tm, p_list + i0, t_list + j0, nr, nc, h, vec, gather, sh.mask_p, sh.mask_t,
                                 stages, lo, row_max, col_max};
      switch ((s.nc + 31) / 32) {  // N: the pass's columns rounded up to 32
        case 1: pass<32>(s, sh); break;
        case 2: pass<64>(s, sh); break;
        case 3: pass<96>(s, sh); break;
        default: pass<128>(s, sh); break;
      }
    }
  }

  // P and R: the weighted means of the best matches of the valid tokens
  float sp = 0.0f, wp = 0.0f, sr = 0.0f, wr = 0.0f;
  for (int k = i; k < tp; k += kThreads) {
    const float mask = k == i ? pm0 : pm[k];
    const float weight = pred_w ? (k == i ? pw0 : pred_w[b * tp + k]) * mask : mask;
    sp += (mask > 0.0f ? row_max[k] : 0.0f) * weight;
    wp += weight;
  }
  for (int k = i; k < tt; k += kThreads) {
    const float mask = k == i ? tm0 : tm[k];
    const float weight = tgt_w ? (k == i ? tw0 : tgt_w[b * tt + k]) * mask : mask;
    sr += (mask > 0.0f ? col_max[k] : 0.0f) * weight;
    wr += weight;
  }
  const float4 sums = block_sum4(make_float4(sp, wp, sr, wr), sh.scratch);
  if (threadIdx.x == 0) {
    const float prec = sums.x / fmaxf(sums.y, 1e-12f);
    const float rec = sums.z / fmaxf(sums.w, 1e-12f);
    precision[b] = prec;
    recall[b] = rec;
    f1[b] = 2.0f * prec * rec / fmaxf(prec + rec, 1e-12f);
  }
}

}  // namespace

// pred (B, Tp, H), tgt (B, Tt, H), pred_mask (B, Tp), tgt_mask (B, Tt) float32 and contiguous; pred_w and
// tgt_w the same shapes as the masks, or null (the masks weigh); precision, recall, f1 (B,) float32.
extern "C" int bert_match_launch(const float* pred, const float* tgt, const float* pred_mask,
                                 const float* tgt_mask, const float* pred_w, const float* tgt_w, long long batch,
                                 int tp, int tt, int h, float* precision, float* recall, float* f1, void* stream) {
  if (batch < 1 || batch > 2147483647LL || tp < 1 || tt < 1 || h < 1 || tp + tt > 65536) return cudaErrorInvalidValue;
  // the alignment's slack, the stages and the lo parts, then the running maxima (4 bytes a token) and the lists
  // (2 bytes a token): past the default 48 KB, opted in for the current device
  const size_t dynamic = kAlign + static_cast<size_t>((kStages + 2) * kStageFloats) * sizeof(float) +
                         (static_cast<size_t>(6) * (tp + tt) + 15) / 16 * 16;
  cudaError_t err = cudaFuncSetAttribute(bert_greedy_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dynamic));
  if (err != cudaSuccess) return err;
  // two blocks an SM: their shared memory wants the largest carveout
  err = cudaFuncSetAttribute(bert_greedy_match_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int vec = h % 4 == 0 && reinterpret_cast<uintptr_t>(pred) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(tgt) % 16 == 0;
  bert_greedy_match_kernel<<<static_cast<unsigned int>(batch), kThreads, dynamic, static_cast<cudaStream_t>(stream)>>>(
      pred, tgt, pred_mask, tgt_mask, pred_w, tgt_w, tp, tt, h, vec, precision, recall, f1);
  return cudaGetLastError();
}
