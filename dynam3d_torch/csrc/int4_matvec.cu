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
// the packed weight (Dp * N2) read once from device memory.
//
// Body: the tensor-core body of int4_mma.cuh at every row count.  A block
// owns a tile of 128 packed columns and a K slice inside one scale group; a
// producer warp streams the [ks, 128] weight slice through a 4-slot
// shared-memory ring of TMA box copies, and four consumer warps
// turn the packed bytes into bf16 A fragments and run mma.sync m16n8k16
// against the staged x slice (one n8 tile up to 8 rows, two above).  The
// first design ran one f32 FMA per nibble and row on the CUDA cores, with
// 40-183 registers by row bucket and one block per SM at 16 rows; at 1, 2
// and 4 rows the tensor-core body measured faster on the lm_head, qkv and
// gate_up shapes and within 7% on o and down (chip_smoke.py on an NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md, PR 5), so it runs everywhere.
//
// The K dimension is split across blocks (grid.y) until the grid has a
// block per SM or kMaxSplits slices, so narrow outputs (o, down: 1536
// packed columns) still spread over the card; each slice's partial is scaled by its group scale,
// written to a workspace, and the last block of a column tile (an atomic
// ticket) sums the slices in a fixed order and applies the epilogue, so
// the result does not depend on block scheduling.  The activation slice is
// staged once per block in shared memory, after the optional rmsnorm
// prologue and the bf16 rounding the TPU kernel applies to x.  Products of
// the integer nibble with the bf16 activation are exact and are accumulated
// in f32 over the slice before the group scale applies.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int4_mma.cuh"

namespace {

// K split into at most this many slices: o and down (12 column tiles)
// measured faster at 8 than at 12 and 16 (PERF.md, PR 5)
constexpr int kMaxSplits = 8;

enum Epilogue { kStore = 0, kResidual = 1, kSwiglu = 2 };

__device__ __forceinline__ float load_val(const void* p, int is_f32, long i) {
  return is_f32 ? reinterpret_cast<const float*>(p)[i]
                : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_val(void* p, int is_f32, long i, float v) {
  if (is_f32) reinterpret_cast<float*>(p)[i] = v;
  else reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
}

// NT n8 tiles of x rows: 1-8 rows (NT = 1) or 9-16 (NT = 2); three blocks
// per SM
template <int NT>
__global__ void __launch_bounds__(d3mma::kThreads, 3) int4_matvec_kernel(
    const __grid_constant__ CUtensorMap q4_map, const void* __restrict__ x, int x_f32, int rows,
    int d,
    const float* __restrict__ ln_w, float eps,
    const float* __restrict__ s_lo, const float* __restrict__ s_hi, int n2, int dblk, int ks,
    const void* __restrict__ resid, int resid_f32, int epilogue,
    void* __restrict__ out, int out_f32, int n_out,
    float* __restrict__ ws, unsigned int* __restrict__ tickets) {
  using namespace d3mma;
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

template <int NT>
int launch(dim3 grid, cudaStream_t st, const void* x, int x_f32, int rows, int d,
           const float* ln_w, float eps, const int8_t* q4, const float* s_lo,
           const float* s_hi, int dp, int n2, int dblk, int ks, const void* resid,
           int resid_f32, int epilogue, void* out, int out_f32, int n_out,
           float* ws, unsigned int* tickets) {
  constexpr int smem = d3mma::smem_bytes(NT);
  // raised once (not per launch, so a CUDA graph can capture launches)
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_matvec_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  CUtensorMap map;
  const int rc = d3mma::weight_map(&map, q4, dp, n2);
  if (rc != 0) return rc;
  int4_matvec_kernel<NT><<<grid, d3mma::kThreads, smem, st>>>(
      map, x, x_f32, rows, d, ln_w, eps, s_lo, s_hi, n2, dblk, ks, resid,
      resid_f32, epilogue, out, out_f32, n_out, ws, tickets);
  return 0;
}

}  // namespace

extern "C" int int4_matvec_tile() { return d3mma::kCols; }

// The largest K slice a launch takes, and the most slices K is split into
extern "C" int int4_matvec_max_slice() { return d3mma::kMaxSlice; }
extern "C" int int4_matvec_max_splits() { return kMaxSplits; }

// Launches y = epilogue(prologue(x) @ dequant(q4)).  Returns cudaGetLastError(),
// or 1 (cudaErrorInvalidValue) for a shape the kernel does not take.
//   x: [rows, d] bf16 (x_f32 = 0) or f32;  ln_w: [d] f32 or NULL (no rmsnorm)
//   q4: [dp, n2] int8, 16-byte aligned, n2 % 16 == 0;  s_lo/s_hi: [dp/dblk, n2] f32
//   ks divides dblk, a multiple of 64 and at most int4_matvec_max_slice()
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
  if (rows < 1 || rows > 16 || !d3mma::takes(q4, n2, ks)) return 1;
  dim3 grid((n2 + d3mma::kCols - 1) / d3mma::kCols, dp / ks);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define D3_LAUNCH(NT)                                                                   \
  launch<NT>(grid, st, x, x_f32, rows, d, ln_w, eps, q4, s_lo, s_hi, dp, n2, dblk, ks, resid, \
             resid_f32, epilogue, out, out_f32, n_out, ws, tickets)
  const int rc = rows <= 8 ? D3_LAUNCH(1) : D3_LAUNCH(2);
#undef D3_LAUNCH
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
