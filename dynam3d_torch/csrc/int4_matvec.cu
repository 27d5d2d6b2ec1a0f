// int4 weight-only matvec for Hopper (sm_90a): y[R<=16, N] = x @ dequant(W).
//
// Replaces the TPU kernel dynam3d_tpu/ops/pallas_int4.py::_pallas_int4_matmul
// (body nibble_matvec_acc); its prologue and epilogues also carry the four
// matvecs of the decode-layer ring (decode_attn.cu).  The 2-D-grid twin and
// the fused MLP kernels are int4_matvec2d.cu and int4_mlp.cu.
//
// Weight layout (flat, biased-lo): byte q4[k][c] of a [Dp, N2] int8 array
// holds column c of the first output half in its low nibble, stored +8
// (lo = (b & 15) - 8), and column c of the second half in its signed high
// nibble (hi = (int8)b >> 4).  Scales s_lo/s_hi are f32 [Dp/dblk, N2], one
// per (dblk-row group, packed column).
//
// Bound: at R <= 16 rows the matvec does 4*R operations per packed byte, far
// below the card's ~295 operations per byte, so it is bound by the bytes of
// the packed weight (Dp * N2) read once from device memory.  The design
// keeps the weight stream coalesced and spread over every SM:
//   * a block owns a tile of 128 packed columns; a warp reads one 128-byte
//     row segment per step (4 bytes a lane), eight warps take eight rows;
//     a lane keeps 8 accumulators per row (2 nibbles x 4 bytes), so the
//     16-row bucket stays in registers, where 16-byte loads would need 32
//     per row (512 at 16 rows, over the 255-register cap);
//   * the K dimension is split across blocks (grid.y) in slices inside one
//     scale group, so narrow outputs (o, down: 1536 packed columns) still
//     launch hundreds of blocks; each slice's partial is scaled by its group
//     scale, written to a workspace, and the last block of a column tile
//     (an atomic ticket) sums the slices in a fixed order and applies the
//     epilogue, so the result does not depend on block scheduling;
//   * the activation slice is staged once per block in shared memory, after
//     the optional rmsnorm prologue and the bf16 rounding the TPU kernel
//     applies to x.
// Products of the integer nibble with the bf16 activation are exact in f32
// and are accumulated in f32 over the slice before the group scale applies.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBytesPerLane = 4;
constexpr int kTile = 32 * kBytesPerLane;   // packed columns per block
constexpr int kOut = 2 * kTile;             // outputs per block (lo + hi)
constexpr int kSmemFloats = 8192;           // staged x slice / reduction scratch
constexpr int kRedRows = kSmemFloats / (kWarps * kOut);   // rows per reduction pass

enum Epilogue { kStore = 0, kResidual = 1, kSwiglu = 2 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float load_val(const void* p, int is_f32, long i) {
  return is_f32 ? reinterpret_cast<const float*>(p)[i]
                : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_val(void* p, int is_f32, long i, float v) {
  if (is_f32) reinterpret_cast<float*>(p)[i] = v;
  else reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
}

template <int RB>
__global__ void __launch_bounds__(kThreads) int4_matvec_kernel(
    const void* __restrict__ x, int x_f32, int rows, int d,
    const float* __restrict__ ln_w, float eps,
    const int8_t* __restrict__ q4, const float* __restrict__ s_lo,
    const float* __restrict__ s_hi, int n2, int dblk, int ks,
    const void* __restrict__ resid, int resid_f32, int epilogue,
    void* __restrict__ out, int out_f32, int n_out,
    float* __restrict__ ws, unsigned int* __restrict__ tickets) {
  __shared__ float smem[kSmemFloats];
  __shared__ float inv_rms[16];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int k0 = split * ks;
  const int g = k0 / dblk;
  const int c0 = tile * kTile + lane * kBytesPerLane;
  const bool col_ok = c0 < n2;   // n2 % 4 == 0: the lane's 4 columns are all in range

  // ---- prologue: each block reduces the rows itself (rmsnorm) ----
  if (ln_w != nullptr) {
    for (int r = warp; r < rows; r += kWarps) {
      float ss = 0.f;
      for (int i = lane; i < d; i += 32) {
        float v = load_val(x, x_f32, (long)r * d + i);
        ss += v * v;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) inv_rms[r] = rsqrtf(ss / (float)d + eps);
    }
    __syncthreads();
  }
  // ---- stage the K slice of x: [RB][ks], bf16-rounded, zero past d / rows ----
  for (int i = tid; i < RB * ks; i += kThreads) {
    const int r = i / ks, kk = i - r * ks, k = k0 + kk;
    float v = 0.f;
    if (r < rows && k < d) {
      v = load_val(x, x_f32, (long)r * d + k);
      if (ln_w != nullptr) v = v * inv_rms[r] * ln_w[k];
      v = bf16_round(v);
    }
    smem[i] = v;
  }
  __syncthreads();

  // ---- stream the packed slice: warp w takes rows w, w+8, ... ----
  float acc_lo[RB][kBytesPerLane], acc_hi[RB][kBytesPerLane];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < kBytesPerLane; ++j) acc_lo[r][j] = acc_hi[r][j] = 0.f;

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
#pragma unroll
      for (int j = 0; j < kBytesPerLane; ++j) {
        const int b = (int)((wv[u] >> (8 * j)) & 0xffu);
        lo[j] = (float)((b & 15) - 8);
        hi[j] = (float)(((int)(int8_t)b) >> 4);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float xv = smem[r * ks + kq];
#pragma unroll
        for (int j = 0; j < kBytesPerLane; ++j) {
          acc_lo[r][j] = fmaf(xv, lo[j], acc_lo[r][j]);
          acc_hi[r][j] = fmaf(xv, hi[j], acc_hi[r][j]);
        }
      }
    }
  }

  // ---- reduce over the 8 warps: thread tid owns output o = tid ----
  // (o < 128: lo column tile*128 + o; o >= 128: hi column tile*128 + o - 128)
  float tot[RB];
  __syncthreads();   // smem now reused as reduction scratch
#pragma unroll
  for (int r0 = 0; r0 < RB; r0 += kRedRows) {
#pragma unroll
    for (int rr = 0; rr < kRedRows; ++rr) {
      if (r0 + rr < RB) {
        float* dst = smem + (warp * kRedRows + rr) * kOut;
#pragma unroll
        for (int j = 0; j < kBytesPerLane; ++j) {
          dst[lane * kBytesPerLane + j] = acc_lo[r0 + rr][j];
          dst[kTile + lane * kBytesPerLane + j] = acc_hi[r0 + rr][j];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRedRows; ++rr) {
      if (r0 + rr < RB) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += smem[(w * kRedRows + rr) * kOut + tid];
        tot[r0 + rr] = s;
      }
    }
    __syncthreads();
  }

  const int half = tid / kTile;
  const int col = tile * kTile + (tid - half * kTile);
  const bool out_ok = col < n2;
  const long po = (long)half * n2 + col;     // index in the [lo | hi] output
  const long n_pack = 2L * n2;
  if (out_ok) {
    const float sc = (half ? s_hi : s_lo)[(long)g * n2 + col];
#pragma unroll
    for (int r = 0; r < RB; ++r) tot[r] *= sc;
  }

  if (nsplit > 1) {
    if (out_ok) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < rows) ws[((long)split * rows + r) * n_pack + po] = tot[r];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = (atomicAdd(&tickets[tile], 1u) == (unsigned)(nsplit - 1));
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    if (out_ok) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < rows) {
          float s = 0.f;
          for (int sp = 0; sp < nsplit; ++sp) s += __ldcg(ws + ((long)sp * rows + r) * n_pack + po);
          tot[r] = s;
        }
      }
    }
    if (tid == 0) tickets[tile] = 0u;   // ready for the next launch on this stream
  }

  // ---- epilogue ----
  if (epilogue == kSwiglu) {
    // gate = lo half, up = hi half of the same packed column
    __syncthreads();
    if (half == 1 && out_ok) {
#pragma unroll
      for (int r = 0; r < RB; ++r) smem[r * kTile + (tid - kTile)] = tot[r];
    }
    __syncthreads();
    if (half == 0 && out_ok) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < rows) {
          const float gt = tot[r], up = smem[r * kTile + tid];
          const float h = gt * (1.f / (1.f + expf(-gt))) * up;
          store_val(out, out_f32, (long)r * n_out + col, h);
        }
      }
    }
    return;
  }
  if (out_ok && po < n_out) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < rows) {
        float v = tot[r];
        if (epilogue == kResidual) v += load_val(resid, resid_f32, (long)r * n_out + po);
        store_val(out, out_f32, (long)r * n_out + po, v);
      }
    }
  }
}

template <int RB>
void launch(dim3 grid, cudaStream_t st, const void* x, int x_f32, int rows, int d,
            const float* ln_w, float eps, const int8_t* q4, const float* s_lo,
            const float* s_hi, int n2, int dblk, int ks, const void* resid,
            int resid_f32, int epilogue, void* out, int out_f32, int n_out,
            float* ws, unsigned int* tickets) {
  int4_matvec_kernel<RB><<<grid, kThreads, 0, st>>>(
      x, x_f32, rows, d, ln_w, eps, q4, s_lo, s_hi, n2, dblk, ks, resid,
      resid_f32, epilogue, out, out_f32, n_out, ws, tickets);
}

}  // namespace

extern "C" int int4_matvec_tile() { return kTile; }

extern "C" int int4_matvec_max_slice(int rows) {
  const int rb = rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : rows <= 8 ? 8 : 16;
  return kSmemFloats / rb;
}

// Launches y = epilogue(prologue(x) @ dequant(q4)).  Returns cudaGetLastError().
//   x: [rows, d] bf16 (x_f32 = 0) or f32;  ln_w: [d] f32 or NULL (no rmsnorm)
//   q4: [dp, n2] int8;  s_lo/s_hi: [dp/dblk, n2] f32;  ks divides dblk
//   epilogue 0: out[rows, n_out] = y[:, :n_out]
//   epilogue 1: out = y[:, :n_out] + resid[rows, n_out]
//   epilogue 2: out[rows, n2] = silu(y_lo) * y_hi   (n_out = n2)
//   ws: f32 [dp/ks, rows, 2*n2] when dp/ks > 1;  tickets: zeroed uint32 [n2/128]
extern "C" int int4_matvec(const void* x, int x_f32, int rows, int d,
                           const float* ln_w, float eps, const int8_t* q4,
                           const float* s_lo, const float* s_hi, int dp, int n2,
                           int dblk, int ks, const void* resid, int resid_f32,
                           int epilogue, void* out, int out_f32, int n_out,
                           float* ws, unsigned int* tickets, void* stream) {
  dim3 grid((n2 + kTile - 1) / kTile, dp / ks);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define D3_LAUNCH(RB)                                                          \
  launch<RB>(grid, st, x, x_f32, rows, d, ln_w, eps, q4, s_lo, s_hi, n2, dblk, \
             ks, resid, resid_f32, epilogue, out, out_f32, n_out, ws, tickets)
  if (rows <= 1) D3_LAUNCH(1);
  else if (rows <= 2) D3_LAUNCH(2);
  else if (rows <= 4) D3_LAUNCH(4);
  else if (rows <= 8) D3_LAUNCH(8);
  else D3_LAUNCH(16);
#undef D3_LAUNCH
  return (int)cudaGetLastError();
}
