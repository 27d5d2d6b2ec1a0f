// Kernels I and J: the streamed int4 matvec of the int4 microbenchmarks, for
// Hopper (sm_90a), on the tensor-core body of kernels A, E, F and G
// (int4_mma.cuh).  For each of NW stacked packed weights,
//     y[w] = x[8, D] @ dequant(q4[w] [D, N2]),   y[w] = [lo half | hi half],
// streaming q4 through a ring of S shared-memory slots.
//
// Replaces the two Pallas kernels of the TPU tools:
//   I  tools/bench_int4_stream.py::matvec (kernel_idx): a program per weight
//      walks its [D, nblk] column tiles through an S-slot DMA ring and runs
//      nibble_matvec_acc (ops/pallas_int4.py) on each: the biased-lo AND
//      form, x.lo = x.(b & 15) - 8 sum(x), x.hi = (x.b - x.(b & 15)) / 16;
//   J  tools/bench_int4_unpack.py::matvec (kernel): the same ring at S = 2,
//      nblk = 512 with one of four bodies (a template parameter here).
//
// Work items.  A block per (column tile of nblk packed columns, K slice of
// ks rows, weight w): grid (N2 / nblk, D / ks, NW).  ks divides dblk, so a
// slice never straddles a scale group; the caller halves it until the work
// items fill SMs x resident blocks per SM (the card's occupancy query).  The
// stack is one [NW * D, N2] tensor map, and D % 64 == 0, so a box never
// straddles two weights.  The scales, y, the workspace and the tickets of
// weight w are offsets from w.  Each slice's scaled sums go through
// gather() and split_sum() (int4_mma.cuh, the two halves of A's finish(),
// here over nblk / 128 tiles) with one ticket per (weight, column tile): the
// block that takes its last ticket sums the slices in order 0..D/ks-1, so
// y does not depend on block scheduling.  (The TPU grid runs the weights
// in order and leaves the last weight's y in one [8, N] output; here y has
// a row block per weight.)
//
// Weight stream.  int4_mma.cuh's producer warp and ring: a slot is one
// stage of nblk / 128 boxes of [64, 128] bytes (the body's box, 128-byte
// swizzle: 16-byte chunk j of row r lands at chunk j ^ (r % 8)), issued by
// one lane as TMA copies that complete on the slot's full mbarrier; the
// four consumer warps release it through its empty mbarrier.  S is the
// ring's depth, nblk the stage's and the work item's width, 64 the rows of
// a slot (the tools' kc).  x's K slice is staged once per work item while
// the first boxes fly: for the bf16 bodies by the producer's bulk copies of
// its 8 rows, which complete on stage 0's barrier; for w4a8 by the
// consumers, which reorder its bytes and sum its rows.
//
// Bodies, as ways of building the A fragments of mma.sync with the output
// columns on M and the 8 activation rows on N (a warp owns 32 columns of
// each 128-column sub-tile, so nblk / 128 sub-tiles of accumulators):
//   andtrick (I; J body 0): the exact nibbles of biased-lo bytes (a_frags),
//      bf16 m16n8k16 with f32 sums: x.lo and x.hi directly, which in exact
//      arithmetic are the TPU's x.lo_u - 8 sum(x) and (x.b - x.lo_u) / 16;
//   current (J body 2): the same on signed-lo bytes (q4 ^ 8): the low nibble
//      takes the ^ 8 of the high one;
//   w4a8 (J body 3): m16n8k32 with s8 operands and exact int32 sums: the A
//      fragments are the raw bytes b and b & 0x0F0F0F0F after transpose4, the
//      B fragments words of the int8 x rows; lo = (p_lo - 8 sum(x)) s_lo, hi =
//      (p_b - p_lo) s_hi / 16 (the TPU's AND trick, literally);
//   dma-floor (J body 1): the consumers wait on every stage and release it;
//      split 0's first stage writes the first 8 weight rows of its column
//      tile into the lo half of y, de-swizzled, and zero into the hi half.
//      The ring's streaming ceiling, which the other bodies are read against.
//
// Bound.  At 8 rows the matvec does 4 operations per packed byte (2 per
// nibble), far below the card's ~295 per byte: the weight's bytes bound it
// (7.5 us per 3072 x 8192 packed weight at 3.35 TB/s).  The first design
// ran one f32 FMA per nibble and row on the CUDA cores (16 per packed byte,
// bound there by operations) with a per-row cp.async.bulk fill: 0.1958 ms
// for kernel I's 4 weights at S = 2, nblk = 512, against 0.056-0.061 ms
// for this one and 0.031 ms for the bytes (chip_smoke.py and
// decompose_int4_mma on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md).  Its
// time is the stream, the fragment math on the integer pipes, which
// overlap, and a fixed cost per work item (the slices' ordered sum, the
// 1.45 waves of 384 items at two blocks per SM).

#include "int4_mma.cuh"

namespace {

// (declarations, not a using-directive: that would also pull in the
// header's anonymous namespace, which the kernel registration then finds
// ambiguous)
using d3mma::Acc;
using d3mma::BoxOffsets;
using d3mma::Ring;
using d3mma::Scales;
using d3mma::kAlign;
using d3mma::kCols;
using d3mma::kConsumerWarps;
using d3mma::kConsumers;
using d3mma::kKc;
using d3mma::kMaxSlice;
using d3mma::kSlotBytes;
using d3mma::kThreads;
using d3mma::kXsPitch;
using d3mma::a_frags;
using d3mma::acc_zero;
using d3mma::aligned_base;
using d3mma::b_frags;
using d3mma::box_offsets;
using d3mma::bulk_copy;
using d3mma::consumer_sync;
using d3mma::gather;
using d3mma::load_scales;
using d3mma::mbar_add_tx;
using d3mma::mbar_arrive;
using d3mma::mbar_init;
using d3mma::mbar_wait;
using d3mma::mma_bf16;
using d3mma::produce;
using d3mma::scale;
using d3mma::split_sum;
using d3mma::step_words;
using d3mma::takes;
using d3mma::transpose4;
using d3mma::weight_map;

constexpr int kRows = 8;                    // activation rows (the tools' BP): one n8 tile
constexpr int kMaxSlots = 8;
constexpr int kMaxSmem = 232448;            // dynamic shared memory a block may take
constexpr int kXBytes = 8 * kXsPitch * 2;   // the staged x slice; gather()'s sums alias it
constexpr int kX8Pitch = kMaxSlice + 16;    // bytes per staged int8 x row (w4a8): 260 words,
                                            // so the 32 lanes' B loads hit 32 banks

enum Body { kAndTrick = 0, kFloor = 1, kCurrent = 2, kW4A8 = 3 };

// dynamic shared memory of a block: alignment slack, S slots of nsub boxes,
// the x slice, a full and an empty mbarrier per slot
__host__ __device__ constexpr int stream_smem(int S, int nsub) {
  return kAlign + S * nsub * kSlotBytes + kXBytes + 2 * S * 8;
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w4a8: stage x[:, k0:k0+ks] of int8 x [8, D] into xq [8][kX8Pitch] with
// each 16 K values reordered so that word t holds K 2t, 2t+1, 2t+8, 2t+9:
// the weight rows whose bytes transpose4 puts in one A register, so a B
// register is one 32-bit load.  Row sums into sumx (zeroed before).
// Consumer threads; the caller syncs the consumers after.
__device__ __forceinline__ void stage_x8(unsigned char* xq, const int8_t* x, int D, int k0,
                                         int ks, int* sumx) {
  const int cpr = ks / 16, n = kRows * cpr;
  for (int i = threadIdx.x; i < n; i += kConsumers) {
    const int r = i / cpr, k = (i - r * cpr) * 16;
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(x + (long)r * D + k0 + k));
    *reinterpret_cast<uint4*>(xq + r * kX8Pitch + k) =
        make_uint4(__byte_perm(u.x, u.z, 0x5410), __byte_perm(u.x, u.z, 0x7632),
                   __byte_perm(u.y, u.w, 0x5410), __byte_perm(u.y, u.w, 0x7632));
    int s = __dp4a((int)u.x, 0x01010101, 0);
    s = __dp4a((int)u.y, 0x01010101, s);
    s = __dp4a((int)u.z, 0x01010101, s);
    s = __dp4a((int)u.w, 0x01010101, s);
    atomicAdd(&sumx[r], s);
  }
}

// y[w] (+ the workspace and tickets of w) for one work item; NSUB = nblk /
// 128 sub-tiles, S ring slots.  (The default ring depth and one box per
// slot are A's; here the slot holds NSUB boxes.)
template <int BODY, int NSUB>
__global__ void __launch_bounds__(kThreads, 2) int4_stream_kernel(
    const __grid_constant__ CUtensorMap q4_map, const void* __restrict__ x,
    const float* __restrict__ s_lo, const float* __restrict__ s_hi, float* __restrict__ y,
    float* __restrict__ ws, unsigned int* __restrict__ tickets, int D, int n2, int dblk, int S,
    int ks) {
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  __shared__ int sumx[kRows];
  __shared__ int is_last;
  constexpr int kStageBytes = NSUB * kSlotBytes;
  unsigned char* base = aligned_base(smem_dyn);
  unsigned char* xsb = base + S * kStageBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(xsb + kXBytes);
  const Ring ring{base, bars, bars + S};

  const int tile = blockIdx.x, split = blockIdx.y, w = blockIdx.z, nsplit = gridDim.y;
  const int col0 = tile * NSUB * kCols, k0 = split * ks, nst = ks / kKc;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int r = 0; r < kRows; ++r) sumx[r] = 0;
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {   // the producer warp: stream the work item's slice
    if (BODY != kFloor && BODY != kW4A8 && (threadIdx.x & 31) == 0) {
      // bf16 bodies: x's K slice rides on stage 0's barrier, by bulk copies
      // of its rows into the staged layout (nothing read the buffer before:
      // no proxy fence)
      mbar_add_tx(&ring.full[0], (uint32_t)(kRows * ks * 2));
      for (int r = 0; r < kRows; ++r)
        bulk_copy(xsb + r * kXsPitch * 2, static_cast<const __nv_bfloat16*>(x) + (long)r * D + k0,
                  (uint32_t)(ks * 2), &ring.full[0]);
    }
    for (int s = 0; s < nst; ++s)
      produce(ring, s, &q4_map, w * D + k0 + s * kKc, col0, S, NSUB);
    return;
  }

  const int lane = threadIdx.x & 31;
  float* yw = y + (long)w * kRows * 2 * n2;
  if constexpr (BODY == kFloor) {
    for (int s = 0; s < nst; ++s) {
      const int slot = s % S;
      mbar_wait(&ring.full[slot], (uint32_t)((s / S) & 1));
      if (split == 0 && s == 0) {   // weight rows 0..7, chunk j of row r at j ^ r
        const unsigned char* st = ring.buf + slot * kStageBytes;
        for (int i = threadIdx.x; i < kRows * NSUB * kCols; i += kConsumers) {
          const int r = i / (NSUB * kCols), c = i - r * NSUB * kCols;
          const int b = c / kCols, cc = c - b * kCols;
          const unsigned char v = st[b * kSlotBytes + r * kCols + (((cc >> 4) ^ r) << 4) + (cc & 15)];
          yw[(long)r * 2 * n2 + col0 + c] = (float)(int8_t)v;
          yw[(long)r * 2 * n2 + n2 + col0 + c] = 0.f;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&ring.empty[slot]);
    }
    return;
  }

  // ---- w4a8: x's K slice, permuted, while the first stages fly ----
  if constexpr (BODY == kW4A8) {
    stage_x8(xsb, static_cast<const int8_t*>(x), D, k0, ks, sumx);
    consumer_sync();
  }

  const long g0 = (long)w * (D / dblk);   // weight w's first scale group
  Scales sc[NSUB];
#pragma unroll
  for (int b = 0; b < NSUB; ++b)
    sc[b] = load_scales(col0 + b * kCols, s_lo + g0 * n2, s_hi + g0 * n2, k0 / dblk, n2);
  Acc<1> acc[NSUB];
  const BoxOffsets o = box_offsets();

  if constexpr (BODY == kW4A8) {
    // M tiles as Acc's: lo0, lo1 (p_lo), then b0, b1 (p_b); exact int32 sums
    int ci[NSUB][4][4];
#pragma unroll
    for (int b = 0; b < NSUB; ++b)
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) ci[b][m][e] = 0;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(xsb + g * kX8Pitch) + t;
    for (int s = 0; s < nst; ++s) {
      const int slot = s % S;
      mbar_wait(&ring.full[slot], (uint32_t)((s / S) & 1));
      const unsigned char* st = ring.buf + slot * kStageBytes;
#pragma unroll
      for (int q = 0; q < kKc / 32; ++q) {
        // B: x row g at K 32q + 4t.. (rows 2t, 2t+1, 2t+8, 2t+9) and 16 + that
        const int kw = (s * kKc + 32 * q) / 4;
        const uint32_t b0 = xw[kw], b1 = xw[kw + 4];
#pragma unroll
        for (int b = 0; b < NSUB; ++b) {
          const unsigned char* p = st + b * kSlotBytes + q * 32 * kCols;
          uint32_t wa[4], wb[4], ca[4], cb[4];
          step_words(p, o, wa);
          step_words(p + 16 * kCols, o, wb);
          transpose4(wa, ca);
          transpose4(wb, cb);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            // M row g: column 4g + 2j; row g + 8: column 4g + 2j + 1
            const uint32_t ab[4] = {ca[2 * j], ca[2 * j + 1], cb[2 * j], cb[2 * j + 1]};
            const uint32_t al[4] = {ab[0] & 0x0F0F0F0Fu, ab[1] & 0x0F0F0F0Fu,
                                    ab[2] & 0x0F0F0F0Fu, ab[3] & 0x0F0F0F0Fu};
            mma_s8(ci[b][j], al, b0, b1);
            mma_s8(ci[b][2 + j], ab, b0, b1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&ring.empty[slot]);
    }
    // lo = p_lo - 8 sum(x), hi = (p_b - p_lo) / 16, both exact in f32; C
    // register e holds x row 2t + (e & 1)
#pragma unroll
    for (int b = 0; b < NSUB; ++b)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[b].c[0][2 + j][e] = (float)(ci[b][2 + j][e] - ci[b][j][e]) * 0.0625f;
          acc[b].c[0][j][e] = (float)(ci[b][j][e] - 8 * sumx[2 * t + (e & 1)]);
        }
  } else {
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(xsb);
#pragma unroll
    for (int b = 0; b < NSUB; ++b) acc_zero(acc[b]);
    for (int s = 0; s < nst; ++s) {
      const int slot = s % S;
      mbar_wait(&ring.full[slot], (uint32_t)((s / S) & 1));
      const unsigned char* st = ring.buf + slot * kStageBytes;
#pragma unroll
      for (int q = 0; q < kKc / 16; ++q) {
        uint32_t bf[1][2];
        b_frags<1>(xs, s * kKc + q * 16, bf);
#pragma unroll
        for (int b = 0; b < NSUB; ++b) {
          uint32_t wv[4], a[4][4];
          step_words(st + b * kSlotBytes + q * 16 * kCols, o, wv);
          a_frags<BODY == kCurrent>(wv[0], wv[1], wv[2], wv[3], a);
#pragma unroll
          for (int m = 0; m < 4; ++m) mma_bf16(acc[b].c[0][m], a[m], bf[0][0], bf[0][1]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&ring.empty[slot]);
    }
  }
#pragma unroll
  for (int b = 0; b < NSUB; ++b) scale(acc[b], sc[b]);

  // ---- the slices' ordered sum of the work item, then y ----
  float* red = reinterpret_cast<float*>(xsb);
  float tot[NSUB][kRows][2];
#pragma unroll
  for (int b = 0; b < NSUB; ++b) {
    consumer_sync();   // every warp is done with xs (or with the last sub-tile's sums)
    gather<1>(acc[b], red, col0 + b * kCols, tot[b]);
  }
  float* wsw = nsplit > 1 ? ws + (long)w * nsplit * kRows * 2 * n2 : nullptr;
  if (!split_sum<kRows, NSUB>(tot, col0, kRows, split, nsplit, n2, wsw,
                              tickets + (long)w * gridDim.x + tile, &is_last))
    return;
#pragma unroll
  for (int b = 0; b < NSUB; ++b) {
    const int c = col0 + b * kCols + (int)threadIdx.x;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      yw[(long)r * 2 * n2 + c] = tot[b][r][0];
      yw[(long)r * 2 * n2 + n2 + c] = tot[b][r][1];
    }
  }
}

// The opt-in of the instantiation's dynamic shared memory, raised to the
// largest size asked so far (once per size, not per launch, so that a CUDA
// graph can capture launches; one flag per instantiation, under internal
// linkage)
template <int BODY, int NSUB>
int smem_optin(int smem) {
  static int raised = 0;
  if (smem > raised) {
    const cudaError_t e = cudaFuncSetAttribute(int4_stream_kernel<BODY, NSUB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    raised = smem;
  }
  return 0;
}

struct Args {
  const void* x;
  const int8_t* q4;
  const float *s_lo, *s_hi;
  float *y, *ws;
  unsigned int* tickets;
  int nw, D, n2, dblk, nblk, S, ks;
};

template <int BODY, int NSUB>
int launch(const Args& a, cudaStream_t st) {
  const int smem = stream_smem(a.S, NSUB);
  if (smem > kMaxSmem) return 1;
  int rc = smem_optin<BODY, NSUB>(smem);
  if (rc != 0) return rc;
  CUtensorMap map;
  if ((rc = weight_map(&map, a.q4, a.nw * a.D, a.n2)) != 0) return rc;
  const dim3 grid(a.n2 / a.nblk, a.D / a.ks, a.nw);
  int4_stream_kernel<BODY, NSUB><<<grid, kThreads, smem, st>>>(
      map, a.x, a.s_lo, a.s_hi, a.y, a.ws, a.tickets, a.D, a.n2, a.dblk, a.S, a.ks);
  return (int)cudaGetLastError();
}

template <int BODY, int NSUB>
int blocks_per_sm(int S, int* count) {
  const int smem = stream_smem(S, NSUB);
  if (smem > kMaxSmem) {   // no block of this size fits
    *count = 0;
    return 0;
  }
  const int rc = smem_optin<BODY, NSUB>(smem);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(count, int4_stream_kernel<BODY, NSUB>,
                                                            kThreads, smem);
}

// I runs andtrick at every nblk; J runs its four bodies at nblk = 512
template <template <int, int> class F, typename... T>
int dispatch(int body, int nblk, T... args) {
  if (nblk == 512) {
    switch (body) {
      case kAndTrick: return F<kAndTrick, 4>::run(args...);
      case kFloor: return F<kFloor, 4>::run(args...);
      case kCurrent: return F<kCurrent, 4>::run(args...);
      case kW4A8: return F<kW4A8, 4>::run(args...);
      default: return 1;
    }
  }
  if (body != kAndTrick) return 1;
  if (nblk == 256) return F<kAndTrick, 2>::run(args...);
  if (nblk == 128) return F<kAndTrick, 1>::run(args...);
  return 1;
}

template <int BODY, int NSUB>
struct Launch {
  static int run(const Args& a, cudaStream_t st) { return launch<BODY, NSUB>(a, st); }
};

template <int BODY, int NSUB>
struct Occupancy {
  static int run(int S, int* count) { return blocks_per_sm<BODY, NSUB>(S, count); }
};

int run(int body, const Args& a, void* stream) {
  const bool ok = a.nw >= 1 && a.S >= 1 && a.S <= kMaxSlots && a.D % kKc == 0 &&
                  a.ks % kKc == 0 && a.ks <= kMaxSlice && a.dblk % a.ks == 0 &&
                  a.D % a.dblk == 0 && a.n2 % a.nblk == 0 && takes(a.q4, a.n2, a.ks) &&
                  (reinterpret_cast<uintptr_t>(a.x) & 15) == 0 &&
                  (a.D / a.ks == 1 || a.ws != nullptr || body == kFloor);
  if (!ok) return 1;
  return dispatch<Launch>(body, a.nblk, a, reinterpret_cast<cudaStream_t>(stream));
}

}  // namespace

// The dynamic shared memory of a block at S slots of nblk packed columns
extern "C" int int4_stream_smem(int S, int nblk) { return stream_smem(S, nblk / kCols); }

// Blocks of body `body` at (S, nblk) one SM holds, into *count (0 where a
// block's shared memory exceeds what a block may take); returns the CUDA
// error code (1 for a (body, S, nblk) the kernels do not take)
extern "C" int int4_stream_blocks_per_sm(int body, int S, int nblk, int* count) {
  if (S < 1 || S > kMaxSlots) return 1;
  return dispatch<Occupancy>(body, nblk, S, count);
}

// Kernel I.  y[w] = x @ dequant(q4[w]) for w < nw through an S-slot ring of
// stages of nblk packed columns (128, 256 or 512), D split into slices of ks
// rows.  Returns cudaGetLastError(); 1 (cudaErrorInvalidValue) for
// arguments it does not take.
//   x: [8, D] bf16, 16-byte aligned;  q4: [nw, D, n2] int8 (biased-lo),
//   16-byte aligned, D % 64 == 0;  s_lo/s_hi: [nw, D/dblk, n2] f32;
//   ks: a multiple of 64 dividing dblk, at most 1024;  y: [nw, 8, 2*n2] f32;
//   ws: f32 [nw, D/ks, 8, 2*n2] (unused when D == ks);
//   tickets: zeroed uint32 [nw * n2/nblk], zero again after the launch
extern "C" int int4_stream_matvec(const void* x, const int8_t* q4, const float* s_lo,
                                  const float* s_hi, float* y, float* ws, unsigned int* tickets,
                                  int nw, int D, int n2, int dblk, int nblk, int S, int ks,
                                  void* stream) {
  return run(kAndTrick, Args{x, q4, s_lo, s_hi, y, ws, tickets, nw, D, n2, dblk, nblk, S, ks},
             stream);
}

// Kernel J: the same at nblk = 512 with body 0 andtrick, 1 dma-floor, 2
// current (q4 in the signed-lo format), 3 w4a8 (x int8 [8, D]).
extern "C" int int4_unpack_matvec(int body, const void* x, const int8_t* q4, const float* s_lo,
                                  const float* s_hi, float* y, float* ws, unsigned int* tickets,
                                  int nw, int D, int n2, int dblk, int nblk, int S, int ks,
                                  void* stream) {
  if (nblk != 512) return 1;
  return run(body, Args{x, q4, s_lo, s_hi, y, ws, tickets, nw, D, n2, dblk, nblk, S, ks}, stream);
}
