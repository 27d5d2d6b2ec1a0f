// Shared pieces of the CUDA-core int4 kernels E (int4_matvec2d.cu) and H
// (decode_attn_layer.cu); kernels A, F and G run on int4_mma.cuh.
//
// Weight layout (flat, biased-lo): byte q4[k][c] of a [Dp, N2] int8 array
// holds column c of the first output half in its low nibble, stored +8, and
// column c of the second half in its signed high nibble; scales s_lo/s_hi
// are f32 [Dp/dblk, N2].  The nibbles are unpacked with shifts, as the TPU
// kernel's _unpack_i32 does: lo = (b & 15) - 8, hi = (b << 24) >> 28.
//
// The work unit is a tile of 128 packed columns (256 outputs: lo and hi)
// over a K slice of one scale group.  256 threads: a warp reads one 128-byte
// row segment per step (4 bytes a lane), eight warps take eight rows; a
// lane keeps 8 accumulators per activation row.  The eight warps' partials
// are summed in shared memory, scaled by the group scale, and written to a
// workspace; the block that takes a tile's last ticket sums the slices in
// slice order, so the result does not depend on block scheduling.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace d3 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBytesPerLane = 4;
constexpr int kTile = 32 * kBytesPerLane;   // packed columns per tile
constexpr int kOut = 2 * kTile;             // outputs per tile (lo + hi)
constexpr int kSmemFloats = 8192;           // staged x slice / reduction scratch
constexpr int kRedRows = kSmemFloats / (kWarps * kOut);   // rows per reduction pass
constexpr int kMaxRows = 16;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// bf16 load through L2 only: the data may have been written earlier in the
// same launch by another block (L1 is not coherent across blocks)
__device__ __forceinline__ float ldcg_bf16(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ void unpack_shift(uint32_t w, float lo[kBytesPerLane],
                                             float hi[kBytesPerLane]) {
#pragma unroll
  for (int j = 0; j < kBytesPerLane; ++j) {
    const uint32_t b = (w >> (8 * j)) & 0xffu;
    lo[j] = (float)((int)(b & 15u) - 8);
    hi[j] = (float)(((int)(b << 24)) >> 28);
  }
}

// 1 / rms of each row of x [rows, d] bf16 into inv_rms (shared), all threads
__device__ __forceinline__ void row_inv_rms(const __nv_bfloat16* x, int rows, int d,
                                            float eps, float* inv_rms) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps) {
    float ss = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float v = ldcg_bf16(x + (long)r * d + i);
      ss += v * v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) inv_rms[r] = rsqrtf(ss / (float)d + eps);
  }
  __syncthreads();
}

// Stage x[:, k0:k0+ks] of bf16 x [rows, ld] into xs [RB][ks] as bf16-rounded
// f32, zero past d or rows; with ln_w, the rmsnorm prologue
// bf16(x * inv_rms * ln_w) first.  The caller syncs before and after.
template <int RB>
__device__ __forceinline__ void stage(float* xs, const __nv_bfloat16* x, int rows, int ld,
                                      int d, int k0, int ks, const float* inv_rms,
                                      const float* ln_w) {
  for (int i = threadIdx.x; i < RB * ks; i += kThreads) {
    const int r = i / ks, k = k0 + (i - r * ks);
    float v = 0.f;
    if (r < rows && k < d) {
      v = ldcg_bf16(x + (long)r * ld + k);
      if (ln_w != nullptr) v = bf16_round(v * inv_rms[r] * ln_w[k]);
    }
    xs[i] = v;
  }
}

template <int RB>
struct Acc {
  float lo[RB][kBytesPerLane];
  float hi[RB][kBytesPerLane];
};

template <int RB>
__device__ __forceinline__ void acc_zero(Acc<RB>& a) {
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < kBytesPerLane; ++j) a.lo[r][j] = a.hi[r][j] = 0.f;
}

// Accumulate the staged slice xs [RB][ks] (weight rows k0..k0+ks) against
// the tile's packed columns: warp w takes rows w, w + 8, ...
template <int RB>
__device__ __forceinline__ void acc_slice(Acc<RB>& a, const float* xs, int ks,
                                          const int8_t* __restrict__ q4, int n2, int k0,
                                          int tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = tile * kTile + lane * kBytesPerLane;
  const bool col_ok = c0 < n2;   // n2 % 4 == 0: all 4 columns of the lane in range
  constexpr int kUnroll = 4;
  for (int kk = warp; kk < ks; kk += kUnroll * kWarps) {
    uint32_t wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kq = kk + u * kWarps;
      wv[u] = 0x08080808u;   // decodes to zero weights
      if (col_ok && kq < ks)
        wv[u] = __ldg(reinterpret_cast<const uint32_t*>(q4 + (long)(k0 + kq) * n2 + c0));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kq = kk + u * kWarps;
      if (kq >= ks) break;
      float lo[kBytesPerLane], hi[kBytesPerLane];
      unpack_shift(wv[u], lo, hi);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float xv = xs[r * ks + kq];
#pragma unroll
        for (int j = 0; j < kBytesPerLane; ++j) {
          a.lo[r][j] = fmaf(xv, lo[j], a.lo[r][j]);
          a.hi[r][j] = fmaf(xv, hi[j], a.hi[r][j]);
        }
      }
    }
  }
}

// Sum the eight warps' accumulators: thread t gets output t of the tile
// (t < 128: lo column tile*128 + t; else hi column tile*128 + t - 128).
// Uses red (kSmemFloats, shared) and syncs before and after.
template <int RB>
__device__ __forceinline__ void acc_reduce(const Acc<RB>& a, float* red, float tot[RB]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();
#pragma unroll
  for (int r0 = 0; r0 < RB; r0 += kRedRows) {
#pragma unroll
    for (int rr = 0; rr < kRedRows; ++rr) {
      if (r0 + rr < RB) {
        float* dst = red + (warp * kRedRows + rr) * kOut;
#pragma unroll
        for (int j = 0; j < kBytesPerLane; ++j) {
          dst[lane * kBytesPerLane + j] = a.lo[r0 + rr][j];
          dst[kTile + lane * kBytesPerLane + j] = a.hi[r0 + rr][j];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRedRows; ++rr) {
      if (r0 + rr < RB) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[(w * kRedRows + rr) * kOut + tid];
        tot[r0 + rr] = s;
      }
    }
    __syncthreads();
  }
}

// This thread's column in the packed array, its half (0 lo, 1 hi) and its
// index in the [lo | hi] output
struct OutCol {
  int half, col;
  long po;
  bool ok;
};

__device__ __forceinline__ OutCol out_col(int tile, int n2) {
  OutCol c;
  c.half = threadIdx.x / kTile;
  c.col = tile * kTile + (threadIdx.x - c.half * kTile);
  c.ok = c.col < n2;
  c.po = (long)c.half * n2 + c.col;
  return c;
}

template <int RB>
__device__ __forceinline__ void apply_scale(float tot[RB], const OutCol& c,
                                            const float* s_lo, const float* s_hi, int g,
                                            int n2) {
  if (!c.ok) return;
  const float sc = (c.half ? s_hi : s_lo)[(long)g * n2 + c.col];
#pragma unroll
  for (int r = 0; r < RB; ++r) tot[r] *= sc;
}

// Write this slice's scaled partials to ws [nsplit][rows][2*n2] and take a
// ticket of the tile; the block with the last ticket sums the slices in
// order 0..nsplit-1 into tot, rearms the ticket and returns true.
template <int RB>
__device__ __forceinline__ bool combine(float tot[RB], const OutCol& c, int rows, int split,
                                        int nsplit, int n2, float* ws,
                                        unsigned int* ticket, int* is_last) {
  if (nsplit == 1) return true;
  const long n_pack = 2L * n2;
  if (c.ok) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < rows) ws[((long)split * rows + r) * n_pack + c.po] = tot[r];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *is_last = (atomicAdd(ticket, 1u) == (unsigned)(nsplit - 1));
  __syncthreads();
  if (!*is_last) return false;
  __threadfence();
  if (c.ok) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < rows) {
        float s = 0.f;
        for (int sp = 0; sp < nsplit; ++sp) s += __ldcg(ws + ((long)sp * rows + r) * n_pack + c.po);
        tot[r] = s;
      }
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;   // ready for the next launch on this stream
  return true;
}

// K rows per slice: the largest power-of-two divisor of dblk that fits the
// staged slice at rb rows and, down to 128 rows, still gives every block of
// a grid of `grid` blocks two work items; -1 if none fits.
inline int pick_slice(int dblk, int dp, int tiles, int grid, int rb) {
  const int cap = kSmemFloats / rb;
  int ks = dblk;
  while (ks > cap && ks % 2 == 0) ks /= 2;
  while ((long)tiles * (dp / ks) < 2L * grid && ks % 2 == 0 && ks > 128) ks /= 2;
  return (dblk % ks == 0 && ks <= cap) ? ks : -1;
}

inline int row_bucket(int rows) {
  return rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : rows <= 8 ? 8 : 16;
}

// Blocks of `kernel` the card holds at once (occupancy x SMs), for a
// cooperative launch; 0 if the card cannot launch cooperatively.
template <typename Kernel>
inline int coop_grid(Kernel kernel, int* grid) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  *grid = (e == cudaSuccess && coop) ? per_sm * sms : 0;
  return (int)e;
}

}  // namespace d3
