// The tensor-core body of the int4 kernels A (int4_matvec.cu), E
// (int4_matvec2d.cu) and F/G (int4_mlp.cu) at 1-16 activation rows: the
// counterpart of the TPU's nibble_matvec_acc (dynam3d_tpu/ops/pallas_int4.py),
// two matrix-unit dots per scale group.  A and E are one kernel here
// (matvec_kernel) launched with two plans: A cuts K into slices that fill
// the card, E takes one slice per scale group.  Kernels I and J
// (int4_stream.cu) run the same ring and fragments in a loop of their own
// over stages of several boxes.
//
// Operand roles.  mma.sync m16n8k16 (bf16 in, f32 accumulate) with the
// weight's output columns on the M side and the activation rows on N: a
// warp owns 32 packed columns, i.e. four M tiles (lo and hi nibbles of two
// 16-column tiles), against one n8 tile of x rows (rows <= 8) or two (9-16).
// Rows are never padded to 16 and there is one A fragment per output.
//
// M row -> packed column.  Lane (g = lane / 4, t = lane % 4) reads the
// 32-bit words of columns 4g..4g+3 at K rows 2t, 2t+1, 2t+8, 2t+9 of a
// k16 step.  M tile j (0, 1) maps row g to column 4g + 2j and row g + 8 to
// column 4g + 2j + 1, so a 4x4 byte transpose of those four words (the
// first half of transpose4 below) leaves in each register the two K
// neighbours of one column that the A fragment wants (PTX ISA, m16n8k16 A
// layout: a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 =
// (g+8, 2t+8..)).  The C fragment then holds, per lane, lo and hi of the
// same four columns for rows 2t, 2t+1 (+8); finish() moves the sums through
// shared memory to one packed column per consumer thread, so the split-K
// partials, the ordered sum and the epilogues read and write whole rows of
// consecutive columns.
//
// Nibble -> bf16, exactly.  A byte b holds lo + 8 in its low nibble and hi
// (signed) in its high nibble (pack_int4).  OR-ing a nibble n under the
// bf16 exponent of 128.0 (0x4300) gives 128 + n exactly; one bf16x2 FMA
// subtracts 136 (0xC308): lo = (128 + (b & 15)) - 136, hi = (128 + ((b >> 4)
// ^ 8)) - 136.  Products of a bf16 activation with these small integers are
// exact, and they sum in the f32 accumulators.
//
// Weight stream.  A ring of kStages slots of [kKc, 128] bytes per block,
// each filled by one TMA copy of a [kKc, 128] box of the weight (a tensor
// map made on the host per launch, 128-byte swizzle: 16-byte chunk j of
// row r lands at chunk j ^ (r % 8), so the lanes' 32-bit loads fall on 32
// distinct banks) that completes on the slot's full mbarrier; one producer
// lane issues the copies and the consumer warps release a slot through its
// empty mbarrier.  A stage never straddles a scale group (kKc divides the K
// slice, which divides dblk).  Two fills measured slower (kernel A, lm_head
// at 8 rows, chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md,
// PR 5): one cp.async.bulk per 128-byte weight row, 0.048 ms, and 16-byte
// cp.async from the producer warp, 0.037 ms, against 0.034-0.035 ms for the
// box copies.
//
// Activations.  The block's K slice of x, bf16 [8*NT][ks + 8] (pitch padded
// so that ldmatrix's eight rows fall on distinct banks), staged once per
// work item by the consumer warps with 16-byte loads, several in flight per
// thread, while the producer's first copies fly; B fragments come from
// ldmatrix.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace d3mma {

using namespace d3sm90;

constexpr int kCols = 128;                  // packed columns per block tile
constexpr int kConsumerWarps = kCols / 32;  // a warp per 32 packed columns
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kStages = 4;                  // ring slots
constexpr int kKc = 64;                     // weight rows per slot
constexpr int kSlotBytes = kKc * kCols;     // one TMA box
constexpr int kMaxSlice = 1024;             // K rows of x a block stages
constexpr int kXsPitch = kMaxSlice + 8;     // bf16 elements per staged x row
constexpr int kRingBytes = kStages * kSlotBytes;
constexpr int kAlign = 1024;                // the 128-byte swizzle's slot alignment

// dynamic shared memory of a block at NT n8 tiles: alignment slack, ring,
// x slice, barriers
__host__ __device__ constexpr int smem_bytes(int nt) {
  return kAlign + kRingBytes + 8 * nt * kXsPitch * 2 + 2 * kStages * 8;
}

// Tensor map of a packed weight q4 [dp, n2] in [kKc, kCols] boxes with the
// 128-byte swizzle (columns past n2 read as zero); 0 or a CUDA error code
inline int weight_map(CUtensorMap* map, const int8_t* q4, int dp, int n2) {
  return tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q4, dp, n2, kKc, kCols);
}

// barrier of the consumer warps only (the producer warp runs ahead)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The block's ring: slots, and a full and an empty mbarrier per slot.
struct Ring {
  unsigned char* buf;
  uint64_t* full;
  uint64_t* empty;
};

// The ring at the 1024-byte aligned start of the dynamic shared memory,
// the staged x slice after it, the barriers last
__device__ __forceinline__ unsigned char* aligned_base(unsigned char* smem) {
  const uint32_t a = smem_u32(smem);
  return smem + (((a + kAlign - 1) & ~(uint32_t)(kAlign - 1)) - a);
}

__device__ __forceinline__ Ring ring_at(unsigned char* smem, int nt) {
  unsigned char* base = aligned_base(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + kRingBytes + 8 * nt * kXsPitch * 2);
  return Ring{base, bars, bars + kStages};
}

__device__ __forceinline__ __nv_bfloat16* xs_at(unsigned char* smem) {
  return reinterpret_cast<__nv_bfloat16*>(aligned_base(smem) + kRingBytes);
}

// thread 0; the block syncs after it
__device__ __forceinline__ void ring_init(const Ring& r) {
  for (int s = 0; s < kStages; ++s) {
    mbar_init(&r.full[s], 1);
    mbar_init(&r.empty[s], kConsumerWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Producer warp: ring stage `it` (a running count over the block's life)
// <- the boxes of weight rows k .. k + kKc, columns col0 + b * kCols ..
// + kCols for b < boxes, in a ring of `stages` slots of boxes * kSlotBytes
// (kernels I and J: S slots of nblk / 128 boxes; A, E, F, G: the defaults).
__device__ __forceinline__ void produce(const Ring& r, int it, const CUtensorMap* map, int k,
                                        int col0, int stages = kStages, int boxes = 1) {
  const int slot = it % stages;
  if (it >= stages) mbar_wait(&r.empty[slot], (uint32_t)((it / stages - 1) & 1));
  if ((threadIdx.x & 31) == 0) {
    mbar_expect_tx(&r.full[slot], (uint32_t)(boxes * kSlotBytes));
    // order the consumers' generic reads of the slot before the async write
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int b = 0; b < boxes; ++b)
      tma_box(r.buf + (slot * boxes + b) * kSlotBytes, map, col0 + b * kCols, k, &r.full[slot]);
  }
  __syncwarp();
}

// The producer warp's walk over a matvec phase of a persistent grid (the
// cooperative kernels F, G and H): the stages of this block's work items
// (item = blockIdx.x + i * gridDim.x, nst = ks / kKc stages each), from
// stage j0 up to j1; returns the ring's running count.
__device__ __forceinline__ int produce_phase(const Ring& ring, int it, const CUtensorMap* map,
                                             int dp, int ks, int j0, int j1) {
  const int ns = dp / ks, nst = ks / kKc;
  for (int j = j0; j < j1; ++j) {
    const int item = blockIdx.x + (j / nst) * gridDim.x, s = j - (j / nst) * nst;
    const int tile = item / ns, split = item - tile * ns;
    produce(ring, it++, map, split * ks + s * kKc, tile * kCols);
  }
  return it;
}

// stages of this block in a phase of `items` work items of nst stages
__device__ __forceinline__ int block_stages(int items, int nst) {
  const int b = (int)blockIdx.x, n = (int)gridDim.x;
  const int mine = items > b ? (items - 1 - b) / n + 1 : 0;
  return mine * nst;
}

template <int NT>
struct Acc {
  float c[NT][4][4];   // [n8 tile][M tile: lo0, lo1, hi0, hi1][C register]
};

template <int NT>
__device__ __forceinline__ void acc_zero(Acc<NT>& a) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) a.c[n][m][e] = 0.f;
}

// 128 + n -> n - 8 in both bf16 halves
__device__ __forceinline__ uint32_t minus136(uint32_t v) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// bytes (sel picks two bytes of p into the halves' low bytes) -> bf16x2 lo
// and hi nibbles of those two bytes.  kSignedLo: the low nibble holds lo
// itself (lo & 15, kernel J's signed-lo bytes, q4 ^ 8), so it takes the
// ^ 8 the signed hi nibble takes.
template <bool kSignedLo = false>
__device__ __forceinline__ void nibbles(uint32_t p, uint32_t sel, uint32_t& lo, uint32_t& hi) {
  const uint32_t s = __byte_perm(p, 0u, sel);
  if constexpr (kSignedLo) lo = minus136((s & 0x000F000Fu) ^ 0x43084308u);
  else lo = minus136((s & 0x000F000Fu) | 0x43004300u);
  hi = minus136(((s >> 4) & 0x000F000Fu) ^ 0x43084308u);
}

// A fragments of one k16 step for the warp's four M tiles, from the words
// at K rows 2t, 2t+1 (w0, w1) and 2t+8, 2t+9 (w2, w3), columns 4g..4g+3
template <bool kSignedLo = false>
__device__ __forceinline__ void a_frags(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                        uint32_t a[4][4]) {
  // p01: columns 4g, 4g+1 (bytes: c0k0 c0k1 c1k0 c1k1); p23: columns 4g+2, 4g+3
  const uint32_t p01 = __byte_perm(w0, w1, 0x5140), p23 = __byte_perm(w0, w1, 0x7362);
  const uint32_t q01 = __byte_perm(w2, w3, 0x5140), q23 = __byte_perm(w2, w3, 0x7362);
  // M tile j (lo: j, hi: 2 + j): a0 = column 4g+2j rows 2t.., a1 = 4g+2j+1,
  // a2 / a3 the same at rows 2t+8..
  nibbles<kSignedLo>(p01, 0x4140, a[0][0], a[2][0]);
  nibbles<kSignedLo>(p01, 0x4342, a[0][1], a[2][1]);
  nibbles<kSignedLo>(q01, 0x4140, a[0][2], a[2][2]);
  nibbles<kSignedLo>(q01, 0x4342, a[0][3], a[2][3]);
  nibbles<kSignedLo>(p23, 0x4140, a[1][0], a[3][0]);
  nibbles<kSignedLo>(p23, 0x4342, a[1][1], a[3][1]);
  nibbles<kSignedLo>(q23, 0x4140, a[1][2], a[3][2]);
  nibbles<kSignedLo>(q23, 0x4342, a[1][3], a[3][3]);
}

// 4x4 byte transpose: w[i] holds byte j of K row i at bits 8j; col[j] holds
// rows 0..3 of column j at bits 0, 8, 16, 24 (K along the word, as the s8
// A fragment of m16n8k32 wants it)
__device__ __forceinline__ void transpose4(const uint32_t w[4], uint32_t col[4]) {
  const uint32_t a = __byte_perm(w[0], w[1], 0x5140);   // r0b0 r1b0 r0b1 r1b1
  const uint32_t b = __byte_perm(w[2], w[3], 0x5140);   // r2b0 r3b0 r2b1 r3b1
  const uint32_t c = __byte_perm(w[0], w[1], 0x7362);   // r0b2 r1b2 r0b3 r1b3
  const uint32_t d = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(a, b, 0x5410);
  col[1] = __byte_perm(a, b, 0x7632);
  col[2] = __byte_perm(c, d, 0x5410);
  col[3] = __byte_perm(c, d, 0x7632);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of x rows 0..8*NT-1 at K columns k..k+15 of the staged slice
template <int NT>
__device__ __forceinline__ void b_frags(const __nv_bfloat16* xs, int k, uint32_t b[NT][2]) {
  const int lane = threadIdx.x & 31;
  if constexpr (NT == 1) {
    const int l = lane & 15;
    const uint32_t addr = smem_u32(xs + (l & 7) * kXsPitch + k + (l >> 3) * 8);
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(b[0][0]), "=r"(b[0][1])
                 : "r"(addr));
  } else {
    const uint32_t addr =
        smem_u32(xs + ((lane >> 4) * 8 + (lane & 7)) * kXsPitch + k + ((lane >> 3) & 1) * 8);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
                 : "r"(addr));
  }
}

// The swizzled byte offsets of the lane's words (columns 4g..4g+3 of the
// warp's 32) in rows 2t and 2t + 1 of a box; rows 8m + 2t (+1) repeat them,
// since the swizzle depends on the row mod 8
struct BoxOffsets {
  int off0, off1;
};

__device__ __forceinline__ BoxOffsets box_offsets() {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int chunk = 2 * warp + (g >> 2), in_chunk = 4 * (g & 3);
  return BoxOffsets{2 * t * kCols + ((chunk ^ (2 * t)) << 4) + in_chunk,
                    (2 * t + 1) * kCols + ((chunk ^ (2 * t + 1)) << 4) + in_chunk};
}

// The lane's words at K rows 2t, 2t+1, 2t+8, 2t+9 of the 16 box rows at p
__device__ __forceinline__ void step_words(const unsigned char* p, const BoxOffsets& o,
                                           uint32_t w[4]) {
  w[0] = *reinterpret_cast<const uint32_t*>(p + o.off0);
  w[1] = *reinterpret_cast<const uint32_t*>(p + o.off1);
  w[2] = *reinterpret_cast<const uint32_t*>(p + 8 * kCols + o.off0);
  w[3] = *reinterpret_cast<const uint32_t*>(p + 8 * kCols + o.off1);
}

// Consumer warp: wait for ring stage `it`, multiply its kKc rows (x columns
// kx .. kx + kKc of the staged slice) into the accumulators, release it.
template <int NT>
__device__ __forceinline__ void consume(const Ring& r, int it, const __nv_bfloat16* xs, int kx,
                                        Acc<NT>& acc) {
  const int lane = threadIdx.x & 31, slot = it % kStages;
  mbar_wait(&r.full[slot], (uint32_t)((it / kStages) & 1));
  const BoxOffsets o = box_offsets();
  const unsigned char* base = r.buf + slot * kSlotBytes;
#pragma unroll
  for (int q = 0; q < kKc / 16; ++q) {
    const unsigned char* p = base + q * 16 * kCols;
    uint32_t w[4];
    step_words(p, o, w);
    uint32_t b[NT][2];
    b_frags<NT>(xs, kx + q * 16, b);
    uint32_t a[4][4];
    a_frags(w[0], w[1], w[2], w[3], a);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int m = 0; m < 4; ++m) mma_bf16(acc.c[n][m], a[m], b[n][0], b[n][1]);
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(&r.empty[slot]);
}

// What a lane holds after the loop: lo and hi of packed columns col + jj
// (jj < 4) for the x rows row(rs), rs < 2 * NT.
struct LaneCols {
  int col;       // first of the lane's four packed columns
  int row0;      // x row of rs = 0 (2t); rs adds 8 * (rs / 2) + rs % 2
};

__device__ __forceinline__ LaneCols lane_cols(int col0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return LaneCols{col0 + warp * 32 + 4 * (lane >> 2), 2 * (lane & 3)};
}

__device__ __forceinline__ int lane_row(const LaneCols& lc, int rs) {
  return lc.row0 + 8 * (rs >> 1) + (rs & 1);
}

// lo (half 0) or hi (half 1) of column col + jj at row slot rs
template <int NT>
__device__ __forceinline__ float& acc_at(Acc<NT>& a, int half, int rs, int jj) {
  return a.c[rs >> 1][2 * half + (jj >> 1)][2 * (jj & 1) + (rs & 1)];
}

// The group scales of the lane's four columns (read before the stages
// land, so their latency hides behind the stream)
struct Scales {
  float lo[4], hi[4];
};

__device__ __forceinline__ Scales load_scales(int col0, const float* s_lo, const float* s_hi,
                                              int grp, int n2) {
  const LaneCols lc = lane_cols(col0);
  Scales sc;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int c = lc.col + jj;
    sc.lo[jj] = c < n2 ? __ldg(s_lo + (long)grp * n2 + c) : 0.f;
    sc.hi[jj] = c < n2 ? __ldg(s_hi + (long)grp * n2 + c) : 0.f;
  }
  return sc;
}

// Scale the slice's sums by its group's scales (one group per K slice)
template <int NT>
__device__ __forceinline__ void scale(Acc<NT>& a, const Scales& sc) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int rs = 0; rs < 2 * NT; ++rs) {
      acc_at(a, 0, rs, jj) *= sc.lo[jj];
      acc_at(a, 1, rs, jj) *= sc.hi[jj];
    }
}

// 8 consecutive values of x (bf16 or f32) at element i, i % 8 == 0, through
// L2 (x may have been written earlier in the same launch by another block)
__device__ __forceinline__ void load8(const void* x, int x_f32, long i, float v[8]) {
  if (x_f32) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(x) + i / 4);
    const float4 b = __ldcg(reinterpret_cast<const float4*>(x) + i / 4 + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
    const uint4 u = __ldcg(reinterpret_cast<const uint4*>(x) + i / 8);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
}

__device__ __forceinline__ float load1(const void* x, int x_f32, long i) {
  return x_f32 ? __ldcg(reinterpret_cast<const float*>(x) + i)
               : __uint_as_float((uint32_t)__ldcg(reinterpret_cast<const unsigned short*>(x) + i)
                                 << 16);
}

// 8-wide loads need rows of a multiple of 8 elements on a 16-byte boundary
__device__ __forceinline__ bool vec8(const void* x, int ld) {
  return ld % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

// 1 / rms of each row of x [rows, d] into inv_rms; consumer warps, a warp
// per row, 8 values a lane per load
__device__ __forceinline__ void row_inv_rms(const void* x, int x_f32, int rows, int d, float eps,
                                            float* inv_rms) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = vec8(x, d);
  for (int r = warp; r < rows; r += kConsumerWarps) {
    float ss = 0.f;
    if (vec) {
      // twelve loads in flight: a 3072-wide row in one round
#pragma unroll 12
      for (int i = 8 * lane; i < d; i += 256) {
        float v[8];
        load8(x, x_f32, (long)r * d + i, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) ss += v[j] * v[j];
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float v = load1(x, x_f32, (long)r * d + i);
        ss += v * v;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) inv_rms[r] = rsqrtf(ss / (float)d + eps);
  }
  consumer_sync();
}

// Stage x[:, k0:k0+ks] of x [rows, ld] (bf16 or f32) into xs as bf16
// [8*NT][kXsPitch], zero past d or rows; with ln_w, x * inv_rms * ln_w
// first.  Consumer threads, 8 values each per step, four steps' loads in
// flight; the caller syncs the consumers before and after.
template <int NT>
__device__ __forceinline__ void stage_x(__nv_bfloat16* xs, const void* x, int x_f32, int rows,
                                        int ld, int d, int k0, int ks, const float* inv_rms,
                                        const float* ln_w) {
  const int cpr = ks / 8, n = 8 * NT * cpr;
  const bool vec = vec8(x, ld);
  constexpr int kBatch = 4;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * kConsumers) {
    float v[kBatch][8];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kConsumers, r = i / cpr, k = k0 + (i - r * cpr) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) v[b][j] = 0.f;
      if (i >= n || r >= rows) continue;
      if (vec && k + 8 <= d) {
        load8(x, x_f32, (long)r * ld + k, v[b]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (k + j < d) v[b][j] = load1(x, x_f32, (long)r * ld + k + j);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kConsumers, r = i / cpr, kk = (i - r * cpr) * 8;
      if (i >= n) break;
      if (ln_w != nullptr && r < rows) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (k0 + kk + j < d) v[b][j] *= inv_rms[r] * ln_w[k0 + kk + j];
      }
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[b][2 * j], v[b][2 * j + 1]);
        w[j] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(xs + r * kXsPitch + kk) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// After the slice's sums are scaled: move them from the fragments to one
// column per consumer thread (thread t: packed column col0 + t, tot[r][0]
// lo and tot[r][1] hi), through red (shared, [8*NT][256] f32; it may alias
// the staged x slice: the caller syncs the consumers first).  A, E, F and
// G take it with split_sum() of one tile through finish(); I and J gather
// each 128-column tile of an item and take one split_sum() for them all.
template <int NT>
__device__ __forceinline__ void gather(Acc<NT>& a, float* red, int col0, float tot[8 * NT][2]) {
  constexpr int NR = 8 * NT;
  const LaneCols lc = lane_cols(col0);
#pragma unroll
  for (int rs = 0; rs < 2 * NT; ++rs)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        red[lane_row(lc, rs) * 2 * kCols + half * kCols + (lc.col - col0) + jj] =
            acc_at(a, half, rs, jj);
  consumer_sync();
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int half = 0; half < 2; ++half) tot[r][half] = red[r * 2 * kCols + half * kCols + t];
}

// With K split across blocks (nsplit > 1), the slice's sums of a work item
// of NC 128-column tiles (thread t: columns col0 + b * kCols + t, b < NC,
// in tot[b]; where NC > 1, n2 is a multiple of the item's width) go to ws
// [nsplit][rows][2*n2], and the block that takes the item's last ticket
// sums the slices in order 0..nsplit-1 into tot (at one tile and one n8
// tile two slices' loads in flight at a time, else one, to keep three
// blocks' registers on an SM), rearms the ticket and returns true; the
// others return false.  One fence and one ticket per item, however many
// tiles it has.
template <int NR, int NC>
__device__ __forceinline__ bool split_sum(float tot[NC][NR][2], int col0, int rows, int split,
                                          int nsplit, int n2, float* ws, unsigned int* ticket,
                                          int* is_last) {
  if (nsplit == 1) return true;
  const int t = threadIdx.x;
  const bool ok = col0 + t < n2;
  const long n_pack = 2L * n2;
  if (ok) {
#pragma unroll
    for (int b = 0; b < NC; ++b) {
      const int c = col0 + b * kCols + t;
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (r < rows)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            ws[((long)split * rows + r) * n_pack + half * n2 + c] = tot[b][r][half];
    }
  }
  __threadfence();
  consumer_sync();
  if (t == 0) *is_last = (atomicAdd(ticket, 1u) == (unsigned)(nsplit - 1));
  consumer_sync();
  if (!*is_last) return false;
  __threadfence();
  if (ok) {
#pragma unroll
    for (int b = 0; b < NC; ++b)
#pragma unroll
      for (int r = 0; r < NR; ++r) tot[b][r][0] = tot[b][r][1] = 0.f;
    constexpr int kPer = NR == 8 && NC == 1 ? 2 : 1;   // slices per round
    for (int sp0 = 0; sp0 < nsplit; sp0 += kPer) {
      float p[kPer][NC][NR][2];
#pragma unroll
      for (int q = 0; q < kPer; ++q)
#pragma unroll
        for (int b = 0; b < NC; ++b)
#pragma unroll
          for (int r = 0; r < NR; ++r)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int c = col0 + b * kCols + t;
              const long o = ((long)(sp0 + q) * rows + r) * n_pack + half * n2 + c;
              p[q][b][r][half] = r < rows && sp0 + q < nsplit ? __ldcg(ws + o) : 0.f;
            }
#pragma unroll
      for (int q = 0; q < kPer; ++q)
#pragma unroll
        for (int b = 0; b < NC; ++b)
#pragma unroll
          for (int r = 0; r < NR; ++r)
#pragma unroll
            for (int half = 0; half < 2; ++half) tot[b][r][half] += p[q][b][r][half];
    }
  }
  if (t == 0) *ticket = 0u;   // ready for the next launch on this stream
  return true;
}

// gather() then, with K split across blocks (nsplit > 1), split_sum() of
// the one 128-column tile: true in the block that holds the tile's ordered
// sum in tot, false in the others.
template <int NT>
__device__ __forceinline__ bool finish(Acc<NT>& a, float* red, int col0, int rows, int split,
                                       int nsplit, int n2, float* ws, unsigned int* ticket,
                                       int* is_last, float tot[8 * NT][2]) {
  gather<NT>(a, red, col0, tot);
  return split_sum<8 * NT, 1>(reinterpret_cast<float(*)[8 * NT][2]>(tot), col0, rows, split,
                              nsplit, n2, ws, ticket, is_last);
}

// K rows per slice: the largest power-of-two divisor of dblk up to
// kMaxSlice that still gives `blocks` work items, halving down to 128 rows
// but to no more than max_splits slices; -1 if none fits.  Every further
// split adds rows x 256 f32 partials per column tile to the workspace and a
// round of loads to the last block's ordered sum.
inline int pick_slice(int dblk, int dp, int tiles, int blocks, int max_splits) {
  int ks = dblk;
  while (ks > kMaxSlice && ks % 2 == 0) ks /= 2;
  while ((long)tiles * (dp / ks) < blocks && ks % 2 == 0 && ks > 128 &&
         dp / (ks / 2) <= max_splits)
    ks /= 2;
  return (dblk % ks == 0 && ks <= kMaxSlice && ks % kKc == 0) ? ks : -1;
}

// The shapes the mma body takes: 16-byte aligned rows for the tensor map
inline bool takes(const void* q4, int n2, int ks) {
  return n2 % 16 == 0 && (reinterpret_cast<uintptr_t>(q4) & 15) == 0 && ks % kKc == 0 &&
         ks <= kMaxSlice;
}

// ---- the matvec kernel of A and E ----
// (internal linkage: each library that includes this header keeps its own
// kernel and its own opt-in flag, even when two are loaded in one process)
namespace {

enum Epilogue { kStore = 0, kResidual = 1, kSwiglu = 2 };

__device__ __forceinline__ float load_val(const void* p, int is_f32, long i) {
  return is_f32 ? reinterpret_cast<const float*>(p)[i]
                : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_val(void* p, int is_f32, long i, float v) {
  if (is_f32) reinterpret_cast<float*>(p)[i] = v;
  else reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
}

// y = epilogue(prologue(x) @ dequant(q4)) over a grid of (column tile, K
// slice): block (tile, split) streams weight rows split*ks .. +ks (inside
// scale group split*ks / dblk) of packed columns tile*128 .. +128 and scales
// its sums by that group's scales; finish() sums the slices in order.  NT
// n8 tiles of x rows: 1-8 rows (NT = 1) or 9-16 (NT = 2); three blocks per
// SM.
template <int NT>
__global__ void __launch_bounds__(kThreads, 3) int4_matvec_kernel(
    const __grid_constant__ CUtensorMap q4_map, const void* __restrict__ x, int x_f32, int rows,
    int d,
    const float* __restrict__ ln_w, float eps,
    const float* __restrict__ s_lo, const float* __restrict__ s_hi, int n2, int dblk, int ks,
    const void* __restrict__ resid, int resid_f32, int epilogue,
    void* __restrict__ out, int out_f32, int n_out,
    float* __restrict__ ws, unsigned int* __restrict__ tickets) {
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  __shared__ float inv_rms[16];
  __shared__ int is_last;
  const Ring ring = ring_at(smem_dyn, NT);
  __nv_bfloat16* xs = xs_at(smem_dyn);

  const int tile = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int k0 = split * ks, col0 = tile * kCols, nst = ks / kKc;
  if (threadIdx.x == 0) ring_init(ring);
  __syncthreads();
  if (threadIdx.x >= kConsumers) {   // the producer warp: stream the slice
    for (int s = 0; s < nst; ++s) produce(ring, s, &q4_map, k0 + s * kKc, col0);
    return;
  }

  // ---- prologue, while the first stages fly: rmsnorm, then x -> bf16 slice ----
  if (ln_w != nullptr) row_inv_rms(x, x_f32, rows, d, eps, inv_rms);
  stage_x<NT>(xs, x, x_f32, rows, d, d, k0, ks, inv_rms, ln_w);
  consumer_sync();

  const Scales sc = load_scales(col0, s_lo, s_hi, k0 / dblk, n2);
  Acc<NT> acc;
  acc_zero(acc);
  for (int s = 0; s < nst; ++s) consume<NT>(ring, s, xs, s * kKc, acc);
  scale(acc, sc);
  consumer_sync();   // every warp is done with xs: its room takes the sums
  float tot[8 * NT][2];
  if (!finish<NT>(acc, reinterpret_cast<float*>(xs), col0, rows, split, nsplit, n2, ws,
                  &tickets[tile], &is_last, tot))
    return;

  // ---- epilogue: thread t holds lo and hi of packed column col0 + t ----
  const int c = col0 + (int)threadIdx.x;
  if (c >= n2) return;
  if (epilogue == kResidual) {   // every residual load before the first store
#pragma unroll
    for (int r = 0; r < 8 * NT; ++r)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long po = (long)half * n2 + c;
        if (r < rows && po < n_out) tot[r][half] += load_val(resid, resid_f32, (long)r * n_out + po);
      }
  }
#pragma unroll
  for (int r = 0; r < 8 * NT; ++r) {
    if (r >= rows) break;
    const float lo = tot[r][0], hi = tot[r][1];
    if (epilogue == kSwiglu) {   // gate = lo half, up = hi half of column c
      store_val(out, out_f32, (long)r * n_out + c, lo * (1.f / (1.f + expf(-lo))) * hi);
      continue;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long po = (long)half * n2 + c;
      if (po < n_out) store_val(out, out_f32, (long)r * n_out + po, half ? hi : lo);
    }
  }
}

// The shared memory opt-in of int4_matvec_kernel<NT>, raised once per
// process (not per launch, so a CUDA graph can capture launches)
template <int NT>
int matvec_smem_optin() {
  static int rc = -1;
  if (rc < 0)
    rc = (int)cudaFuncSetAttribute(int4_matvec_kernel<NT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(NT));
  return rc;
}

// Launches int4_matvec_kernel over (tiles of n2, dp / ks) for 1-16 rows;
// 1 (cudaErrorInvalidValue) for a shape the body does not take, else
// cudaGetLastError().  Arguments as int4_matvec() in int4_matvec.cu.  (A
// template, so that only the sources that launch the kernel compile it.)
template <int kMaxRows = 16>
int launch_matvec(cudaStream_t st, const void* x, int x_f32, int rows, int d,
                         const float* ln_w, float eps, const int8_t* q4, const float* s_lo,
                         const float* s_hi, int dp, int n2, int dblk, int ks, const void* resid,
                         int resid_f32, int epilogue, void* out, int out_f32, int n_out,
                         float* ws, unsigned int* tickets) {
  if (rows < 1 || rows > kMaxRows || !takes(q4, n2, ks) || dblk % ks != 0 || dp % ks != 0)
    return 1;
  const dim3 grid((n2 + kCols - 1) / kCols, dp / ks);
  CUtensorMap map;
  int rc = weight_map(&map, q4, dp, n2);
  if (rc != 0) return rc;
  if (rows <= 8) {
    if ((rc = matvec_smem_optin<1>()) != 0) return rc;
    int4_matvec_kernel<1><<<grid, kThreads, smem_bytes(1), st>>>(
        map, x, x_f32, rows, d, ln_w, eps, s_lo, s_hi, n2, dblk, ks, resid, resid_f32, epilogue,
        out, out_f32, n_out, ws, tickets);
  } else {
    if ((rc = matvec_smem_optin<2>()) != 0) return rc;
    int4_matvec_kernel<2><<<grid, kThreads, smem_bytes(2), st>>>(
        map, x, x_f32, rows, d, ln_w, eps, s_lo, s_hi, n2, dblk, ks, resid, resid_f32, epilogue,
        out, out_f32, n_out, ws, tickets);
  }
  return (int)cudaGetLastError();
}

// Blocks of int4_matvec_kernel one SM holds at `rows` activation rows
template <int kMaxRows = 16>
int matvec_blocks_per_sm(int rows, int* count) {
  if (rows < 1 || rows > kMaxRows) return 1;
  const int rc = rows <= 8 ? matvec_smem_optin<1>() : matvec_smem_optin<2>();
  if (rc != 0) return rc;
  return rows <= 8 ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         count, int4_matvec_kernel<1>, kThreads, smem_bytes(1))
                   : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         count, int4_matvec_kernel<2>, kThreads, smem_bytes(2));
}

}  // namespace

}  // namespace d3mma
