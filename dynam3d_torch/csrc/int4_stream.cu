// Kernels I and J: the streamed int4 matvec of the int4 microbenchmarks, for
// Hopper (sm_90a).  For each of NW stacked packed weights,
//     y[w] = x[8, D] @ dequant(q4[w] [D, N2]),   y[w] = [lo half | hi half],
// streaming q4 through a ring of S shared-memory slots.
//
// Replaces the two Pallas kernels of the TPU tools:
//   I  tools/bench_int4_stream.py::matvec (kernel_idx): a program per weight
//      walks its [D, nblk] column tiles through an S-slot DMA ring and runs
//      nibble_matvec_acc (ops/pallas_int4.py) on each: the biased-lo AND
//      form, x.lo = x.(b & 15) - 8 sum(x), x.hi = (x.b - x.(b & 15)) / 16;
//   J  tools/bench_int4_unpack.py::matvec (kernel): the same ring at S = 2,
//      nblk = 512 with one of four bodies, chosen here by a template
//      parameter: dma-floor (wait on every stage, write float(q4[w, r, c])
//      for rows r < 8 into the lo half; the hi half is written zero), current
//      (signed-lo bytes, sign-extending shifts, two FMAs per byte and row),
//      andtrick (the body of I), w4a8 (int8 activations and int8 bytes,
//      int32 sums through __dp4a after a 4x4 byte transpose, then f32 scales).
//
// What differs from the TPU.  Its grid runs the weights in order and leaves
// the last weight's y in one [8, N] output; here the blocks run at once, so
// y has a row block per weight.  A [D, nblk] int8 tile (1.5 MB at the tools'
// shapes) does not fit in shared memory, so a ring slot holds a [kc, nblk]
// slice, kc dividing the scale group dblk, and S * kc * nblk <= 64 KB so that
// two blocks fit on an SM.  A slot is filled by cp.async.bulk, one copy per
// weight row of nblk bytes, completing on the slot's mbarrier (the
// counterpart of make_async_copy and its DMA semaphore); the block's threads
// share the copies.  While the block reads one slot, the other S - 1 are in
// flight; after a __syncthreads the slot just read is refilled with the stage
// S ahead.
//
// Grid: a block per (weight, column tile, K slice).  (weight, tile) alone is
// 64 blocks at nblk = 512, so the caller splits D into slices of kslice rows
// (kslice divides dblk: a slice never straddles a scale group) until the
// grid has about two blocks per SM.  Each slice's scaled partials go to a
// workspace; the block that takes the tile's last ticket sums them in slice
// order, so y does not depend on block scheduling.
//
// Bound.  At 8 rows the float bodies issue 2 FMAs per byte and row, 16 per
// packed byte: 403 M FMAs per 3072 x 8192 weight, ~12 us at the CUDA cores'
// ~33.5 T FMA/s, above the ~7.7 us it takes to read the weight's 25 MB at
// 3.35 TB/s.  So current and andtrick are bound by operations on this card;
// w4a8 (two dp4a per 4 bytes and row) and dma-floor can reach the bytes.
//
// Thread layout: 256 threads; a thread owns 4 packed columns (one 32-bit word
// of a slice row) for all 8 activation rows, so nblk / 4 column groups x
// 256 / (nblk / 4) row groups; row group g reads slice rows g, g + groups, ...
// (w4a8: groups of 4 rows).  The row groups' sums meet in shared memory, in
// order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;            // activation rows (the tools' BP); one warp per row
constexpr int kMaxSlots = 8;
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may take

enum Body { kAndTrick = 0, kFloor = 1, kCurrent = 2, kW4A8 = 3 };

struct Params {
  const void* x;          // [8, D] bf16 (int8 for w4a8)
  const int8_t* q4;       // [NW, D, n2] packed bytes
  const float* s_lo;      // [NW, D / dblk, n2]
  const float* s_hi;
  float* y;               // [NW, 8, 2 * n2]
  float* ws;              // [NW, nsplit, 8, 2 * n2] when nsplit > 1
  unsigned int* tickets;  // [NW * n2 / nblk], zero between launches
  int D, n2, dblk, nblk, S, kc, kslice;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Issue stage t's copies into ring slot t % S (weight rows k0 + t*kc .. +kc,
// columns jb*nblk .. +nblk), one weight row per thread; all threads call it.
// The slot's mbarrier already expects the stage's bytes, and the block has
// synchronised since the slot was last read.
__device__ __forceinline__ void issue_stage(const Params& p, unsigned char* ring, uint64_t* bars,
                                            int w, int jb, int k0, int t) {
  const int slot = t % p.S;
  unsigned char* dst = ring + (size_t)slot * p.kc * p.nblk;
  const int8_t* src = p.q4 + ((size_t)w * p.D + k0 + (size_t)t * p.kc) * p.n2 + (size_t)jb * p.nblk;
  // order this block's generic reads of the slot before the async writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (int r = threadIdx.x; r < p.kc; r += kThreads)
    bulk_copy(dst + (size_t)r * p.nblk, src + (size_t)r * p.n2, (uint32_t)p.nblk, &bars[slot]);
}

// 4x4 byte transpose: w[i] holds byte j of row i at bits 8j; col[j] holds
// rows 0..3 of column j at bits 0, 8, 16, 24 (K along the word, as dp4a wants)
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

template <int BODY>
__global__ void __launch_bounds__(kThreads, 2) int4_stream_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float sumx_f[kRows];
  __shared__ int sumx_i[kRows];
  __shared__ int is_last;
  constexpr bool kInt = BODY == kW4A8;
  const int ring_bytes = p.S * p.kc * p.nblk;
  const int xs_bytes = BODY == kFloor ? 0 : kInt ? p.kslice * kRows : p.kslice * kRows * 4;
  unsigned char* ring = smem;
  float* xs = reinterpret_cast<float*>(smem + ring_bytes);          // [kslice][8] f32
  int* xq = reinterpret_cast<int*>(smem + ring_bytes);              // [kslice/4][8] 4 x int8
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + ring_bytes + xs_bytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = p.n2 / p.nblk, nsplit = p.D / p.kslice;
  const int split = blockIdx.x % nsplit;
  const int jb = (blockIdx.x / nsplit) % nb;
  const int w = blockIdx.x / (nsplit * nb);
  const int k0 = split * p.kslice;
  const int nstages = p.kslice / p.kc;

  const uint32_t stage_bytes = (uint32_t)(p.kc * p.nblk);
  if (tid == 0) {
    for (int s = 0; s < p.S; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < p.S && t < nstages; ++t) mbar_expect_tx(&bars[t], stage_bytes);
  }
  __syncthreads();
  for (int t = 0; t < p.S && t < nstages; ++t) issue_stage(p, ring, bars, w, jb, k0, t);

  // stage this block's x slice while the first copies fly; warp r sums row r
  if (kInt) {
    const int8_t* x8 = static_cast<const int8_t*>(p.x);
    for (int i = tid; i < (p.kslice / 4) * kRows; i += kThreads) {
      const int k4 = i / kRows, r = i - k4 * kRows;
      xq[i] = *reinterpret_cast<const int*>(x8 + (size_t)r * p.D + k0 + 4 * k4);
    }
    __syncthreads();
    int s = 0;
    for (int k4 = lane; k4 < p.kslice / 4; k4 += 32) s = __dp4a(xq[k4 * kRows + warp], 0x01010101, s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) sumx_i[warp] = s;
  } else if (BODY != kFloor) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(p.x);
    for (int i = tid; i < p.kslice * kRows; i += kThreads) {
      const int k = i / kRows, r = i - k * kRows;
      xs[i] = __bfloat162float(xb[(size_t)r * p.D + k0 + k]);
    }
    __syncthreads();
    float s = 0.f;
    for (int k = lane; k < p.kslice; k += 32) s += xs[k * kRows + warp];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) sumx_f[warp] = s;
  }
  __syncthreads();

  const int ncg = p.nblk / 4, nrg = kThreads / ncg;
  const int cg = tid % ncg, rg = tid / ncg;
  // float bodies: a0 = x.b (andtrick) or x.lo (current), a1 = x.(b & 15) or x.hi;
  // w4a8: the same sums in int32
  float a0[kRows][4], a1[kRows][4];
  int i0[kRows][4], i1[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) a0[r][j] = a1[r][j] = 0.f, i0[r][j] = i1[r][j] = 0;

  for (int t = 0; t < nstages; ++t) {
    const int slot = t % p.S;
    mbar_wait(&bars[slot], (uint32_t)((t / p.S) & 1));
    // the slot's next phase expects stage t + S; it cannot complete before
    // the copies, issued after every thread has passed this wait
    if (tid == 0 && t + p.S < nstages) mbar_expect_tx(&bars[slot], stage_bytes);
    const unsigned char* tile = ring + (size_t)slot * p.kc * p.nblk;
    const int kbase = t * p.kc;
    if constexpr (BODY == kFloor) {
      if (split == 0 && t == 0) {
        for (int i = tid; i < kRows * p.nblk; i += kThreads) {
          const int r = i / p.nblk, c = i - r * p.nblk;
          float* yr = p.y + ((size_t)w * kRows + r) * 2 * p.n2 + (size_t)jb * p.nblk + c;
          yr[0] = (float)(int8_t)tile[(size_t)r * p.nblk + c];
          yr[p.n2] = 0.f;
        }
      }
    } else if constexpr (BODY == kW4A8) {
      for (int k4 = rg; k4 < p.kc / 4; k4 += nrg) {
        const uint32_t* row = reinterpret_cast<const uint32_t*>(tile + (size_t)(4 * k4) * p.nblk) + cg;
        const uint32_t wv[4] = {row[0], row[ncg], row[2 * ncg], row[3 * ncg]};
        uint32_t col[4];
        transpose4(wv, col);
        const int* xk = xq + (kbase / 4 + k4) * kRows;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int xv = xk[r];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            i0[r][j] = __dp4a((int)col[j], xv, i0[r][j]);
            i1[r][j] = __dp4a((int)(col[j] & 0x0f0f0f0fu), xv, i1[r][j]);
          }
        }
      }
    } else {
      for (int k = rg; k < p.kc; k += nrg) {
        const uint32_t wv = reinterpret_cast<const uint32_t*>(tile + (size_t)k * p.nblk)[cg];
        const float4 xa = *reinterpret_cast<const float4*>(xs + (kbase + k) * kRows);
        const float4 xb = *reinterpret_cast<const float4*>(xs + (kbase + k) * kRows + 4);
        const float xv[kRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        float f0[4], f1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (BODY == kAndTrick) {
            const int b = (int)(int8_t)(wv >> (8 * j));       // 16*hi + (lo+8)
            f0[j] = (float)b;
            f1[j] = (float)(b & 15);
          } else {                                             // signed-lo byte
            f0[j] = (float)(((int)(wv << (28 - 8 * j))) >> 28);
            f1[j] = (float)(((int)(wv << (24 - 8 * j))) >> 28);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a0[r][j] = fmaf(xv[r], f0[j], a0[r][j]);
            a1[r][j] = fmaf(xv[r], f1[j], a1[r][j]);
          }
      }
    }
    __syncthreads();
    if (t + p.S < nstages) issue_stage(p, ring, bars, w, jb, k0, t + p.S);
  }
  if constexpr (BODY == kFloor) return;

  // the row groups' sums meet in the ring (every copy has landed and been
  // read): groups 1.. write, group 0 adds them in order
  uint32_t* red = reinterpret_cast<uint32_t*>(ring);
  const int ng = nrg - 1;
  if (rg > 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = (r * 4 + j) * 2;
        red[((e + 0) * ng + rg - 1) * ncg + cg] = kInt ? (uint32_t)i0[r][j] : __float_as_uint(a0[r][j]);
        red[((e + 1) * ng + rg - 1) * ncg + cg] = kInt ? (uint32_t)i1[r][j] : __float_as_uint(a1[r][j]);
      }
  }
  __syncthreads();
  if (rg == 0) {
    for (int g = 0; g < ng; ++g) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = (r * 4 + j) * 2;
          const uint32_t u0 = red[((e + 0) * ng + g) * ncg + cg];
          const uint32_t u1 = red[((e + 1) * ng + g) * ncg + cg];
          if (kInt) i0[r][j] += (int)u0, i1[r][j] += (int)u1;
          else a0[r][j] += __uint_as_float(u0), a1[r][j] += __uint_as_float(u1);
        }
    }
    const int col0 = jb * p.nblk + cg * 4;
    const size_t so = ((size_t)w * (p.D / p.dblk) + k0 / p.dblk) * p.n2 + col0;
    float* dst = nsplit > 1 ? p.ws + (size_t)(w * nsplit + split) * kRows * 2 * p.n2
                            : p.y + (size_t)w * kRows * 2 * p.n2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float sl = p.s_lo[so + j], sh = p.s_hi[so + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float lo, hi;
        if constexpr (BODY == kAndTrick) {
          lo = (a1[r][j] - 8.f * sumx_f[r]) * sl;
          hi = (a0[r][j] - a1[r][j]) * (0.0625f * sh);
        } else if constexpr (BODY == kCurrent) {
          lo = a0[r][j] * sl;
          hi = a1[r][j] * sh;
        } else {
          lo = (float)(i1[r][j] - 8 * sumx_i[r]) * sl;
          hi = (float)(i0[r][j] - i1[r][j]) * (0.0625f * sh);
        }
        dst[(size_t)r * 2 * p.n2 + col0 + j] = lo;
        dst[(size_t)r * 2 * p.n2 + p.n2 + col0 + j] = hi;
      }
    }
  }
  if (nsplit == 1) return;

  // the tile's last block sums the slices in order 0..nsplit-1
  __threadfence();
  __syncthreads();
  unsigned int* ticket = p.tickets + w * nb + jb;
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == (unsigned)(nsplit - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < kRows * 2 * p.nblk; i += kThreads) {
    const int r = i / (2 * p.nblk), c = i - r * 2 * p.nblk;
    const int half = c / p.nblk;
    const size_t off = (size_t)r * 2 * p.n2 + (size_t)half * p.n2 + (size_t)jb * p.nblk + (c - half * p.nblk);
    float s = 0.f;
    for (int sp = 0; sp < nsplit; ++sp)
      s += __ldcg(p.ws + (size_t)(w * nsplit + sp) * kRows * 2 * p.n2 + off);
    p.y[(size_t)w * kRows * 2 * p.n2 + off] = s;
  }
  if (tid == 0) *ticket = 0u;   // ready for the next launch on this stream
}

template <int BODY>
int launch(const Params& p, int nw, cudaStream_t st) {
  const int xs_bytes = BODY == kFloor ? 0 : BODY == kW4A8 ? p.kslice * kRows : p.kslice * kRows * 4;
  const int smem = p.S * p.kc * p.nblk + xs_bytes + 8 * p.S;
  if (smem > kMaxSmem) return 1;
  // raised once per size (not per launch, so a CUDA graph can capture launches)
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(int4_stream_kernel<BODY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int blocks = nw * (p.n2 / p.nblk) * (p.D / p.kslice);
  int4_stream_kernel<BODY><<<blocks, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

int run(int body, const void* x, const int8_t* q4, const float* s_lo, const float* s_hi, float* y,
        float* ws, unsigned int* tickets, int nw, int D, int n2, int dblk, int nblk, int S, int kc,
        int kslice, void* stream) {
  const int ncg = nblk / 4;
  const bool ok = nw >= 1 && (nblk == 128 || nblk == 256 || nblk == 512 || nblk == 1024) &&
                  S >= 1 && S <= kMaxSlots && kc >= kRows && kc % kRows == 0 && kslice % kc == 0 &&
                  dblk % kslice == 0 && D % dblk == 0 && n2 % nblk == 0 &&
                  // the row groups' sums fit in the ring
                  (kThreads / ncg - 1) * ncg * kRows * 4 * 2 * 4 <= S * kc * nblk &&
                  (D / kslice == 1 || ws != nullptr || body == kFloor);
  if (!ok) return 1;
  Params p{x, q4, s_lo, s_hi, y, ws, tickets, D, n2, dblk, nblk, S, kc, kslice};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (body) {
    case kAndTrick: return launch<kAndTrick>(p, nw, st);
    case kFloor: return launch<kFloor>(p, nw, st);
    case kCurrent: return launch<kCurrent>(p, nw, st);
    case kW4A8: return launch<kW4A8>(p, nw, st);
    default: return 1;
  }
}

}  // namespace

// Kernel I.  y[w] = x @ dequant(q4[w]) for w < nw through an S-slot ring of
// [kc, nblk] slices, D split into slices of kslice rows.  Returns
// cudaGetLastError(); 1 (cudaErrorInvalidValue) for arguments it does not take.
//   x: [8, D] bf16;  q4: [nw, D, n2] int8 (biased-lo);  s_lo/s_hi: [nw, D/dblk, n2] f32;
//   y: [nw, 8, 2*n2] f32;  ws: f32 [nw, D/kslice, 8, 2*n2] (unused when D == kslice);
//   tickets: zeroed uint32 [nw * n2/nblk]
extern "C" int int4_stream_matvec(const void* x, const int8_t* q4, const float* s_lo,
                                  const float* s_hi, float* y, float* ws, unsigned int* tickets,
                                  int nw, int D, int n2, int dblk, int nblk, int S, int kc,
                                  int kslice, void* stream) {
  return run(kAndTrick, x, q4, s_lo, s_hi, y, ws, tickets, nw, D, n2, dblk, nblk, S, kc, kslice,
             stream);
}

// Kernel J: the same streaming with body 0 andtrick, 1 dma-floor, 2 current
// (q4 in the signed-lo format), 3 w4a8 (x int8 [8, D]).
extern "C" int int4_unpack_matvec(int body, const void* x, const int8_t* q4, const float* s_lo,
                                  const float* s_hi, float* y, float* ws, unsigned int* tickets,
                                  int nw, int D, int n2, int dblk, int nblk, int S, int kc,
                                  int kslice, void* stream) {
  return run(body, x, q4, s_lo, s_hi, y, ws, tickets, nw, D, n2, dblk, nblk, S, kc, kslice,
             stream);
}
