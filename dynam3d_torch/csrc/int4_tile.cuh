// The CUDA-core int4 matvec of kernel H (decode_attn_layer.cu), at its one
// activation row; kernels A, E, F and G run on the tensor-core body of
// int4_mma.cuh.
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
// lane keeps 8 accumulators (lo and hi of its four columns).  The eight
// warps' partials are summed in shared memory, scaled by the group scale,
// and written to a workspace; the block that takes a tile's last ticket sums
// the slices in slice order, so the result does not depend on block
// scheduling.

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

// 1 / rms of the bf16 row x [d] into *inv_rms (shared): warp 0 sums it;
// all threads sync after it
__device__ __forceinline__ void row_inv_rms(const __nv_bfloat16* x, int d, float eps,
                                            float* inv_rms) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    float ss = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float v = ldcg_bf16(x + i);
      ss += v * v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) *inv_rms = rsqrtf(ss / (float)d + eps);
  }
  __syncthreads();
}

// Stage x[k0:k0+ks] of the bf16 row x [d] into xs [ks] as bf16-rounded f32,
// zero past d; with ln_w, the rmsnorm prologue bf16(x * inv_rms * ln_w)
// first.  The caller syncs before and after.
__device__ __forceinline__ void stage(float* xs, const __nv_bfloat16* x, int d, int k0, int ks,
                                      float inv_rms, const float* ln_w) {
  for (int i = threadIdx.x; i < ks; i += kThreads) {
    const int k = k0 + i;
    float v = 0.f;
    if (k < d) {
      v = ldcg_bf16(x + k);
      if (ln_w != nullptr) v = bf16_round(v * inv_rms * ln_w[k]);
    }
    xs[i] = v;
  }
}

// A lane's sums of its four packed columns, lo and hi nibbles
struct Acc {
  float lo[kBytesPerLane];
  float hi[kBytesPerLane];
};

__device__ __forceinline__ void acc_zero(Acc& a) {
#pragma unroll
  for (int j = 0; j < kBytesPerLane; ++j) a.lo[j] = a.hi[j] = 0.f;
}

// Accumulate the staged slice xs [ks] (weight rows k0..k0+ks) against the
// tile's packed columns: warp w takes rows w, w + 8, ...
__device__ __forceinline__ void acc_slice(Acc& a, const float* xs, int ks,
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
      const float xv = xs[kq];
#pragma unroll
      for (int j = 0; j < kBytesPerLane; ++j) {
        a.lo[j] = fmaf(xv, lo[j], a.lo[j]);
        a.hi[j] = fmaf(xv, hi[j], a.hi[j]);
      }
    }
  }
}

// Sum the eight warps' accumulators: thread t gets output t of the tile
// (t < 128: lo column tile*128 + t; else hi column tile*128 + t - 128).
// Uses red (kWarps * kOut floats, shared) and syncs before and after.
__device__ __forceinline__ float acc_reduce(const Acc& a, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();
  float* dst = red + warp * kOut;
#pragma unroll
  for (int j = 0; j < kBytesPerLane; ++j) {
    dst[lane * kBytesPerLane + j] = a.lo[j];
    dst[kTile + lane * kBytesPerLane + j] = a.hi[j];
  }
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w * kOut + tid];
  __syncthreads();
  return s;
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

__device__ __forceinline__ float apply_scale(float v, const OutCol& c, const float* s_lo,
                                             const float* s_hi, int g, int n2) {
  return c.ok ? v * (c.half ? s_hi : s_lo)[(long)g * n2 + c.col] : v;
}

// Write this slice's scaled partial to ws [nsplit][2*n2] and take a ticket
// of the tile; the block with the last ticket sums the slices in order
// 0..nsplit-1 into v, rearms the ticket and returns true.
__device__ __forceinline__ bool combine(float& v, const OutCol& c, int split, int nsplit, int n2,
                                        float* ws, unsigned int* ticket, int* is_last) {
  if (nsplit == 1) return true;
  const long n_pack = 2L * n2;
  if (c.ok) ws[(long)split * n_pack + c.po] = v;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *is_last = (atomicAdd(ticket, 1u) == (unsigned)(nsplit - 1));
  __syncthreads();
  if (!*is_last) return false;
  __threadfence();
  if (c.ok) {
    float s = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) s += __ldcg(ws + (long)sp * n_pack + c.po);
    v = s;
  }
  if (threadIdx.x == 0) *ticket = 0u;   // ready for the next launch on this stream
  return true;
}

// K rows per slice: the largest power-of-two divisor of dblk that fits the
// staged slice and, down to 128 rows, still gives every block of a grid of
// `grid` blocks two work items; -1 if none fits.
inline int pick_slice(int dblk, int dp, int tiles, int grid) {
  int ks = dblk;
  while (ks > kSmemFloats && ks % 2 == 0) ks /= 2;
  while ((long)tiles * (dp / ks) < 2L * grid && ks % 2 == 0 && ks > 128) ks /= 2;
  return (dblk % ks == 0 && ks <= kSmemFloats) ? ks : -1;
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
