// Kernel E: int4 weight-only matvec over a 2-D grid for Hopper (sm_90a),
// y[R<=16, 2*N2] = x @ dequant(W), halves lo | hi.
//
// Replaces the TPU kernel dynam3d_tpu/ops/pallas_int4.py::_pallas_int4_matmul2d
// (_kernel2d): a program per (column block j, scale group i), the nibbles
// unpacked with shifts, each group's product scaled by its group scale and
// the groups summed in order i = 0..g-1.
//
// Here a block per (tile of 128 packed columns, scale group): the block
// streams the group's dblk weight rows in sub-slices that fit its staged
// activations, sums them in registers, scales the total by the group scale
// and writes it to a workspace; the block that takes the tile's last ticket
// sums the groups in order 0..g-1 and stores.  The result is deterministic;
// it differs from kernel A (int4_matvec.cu, K slices inside a group) only in
// the order of the f32 sums.
//
// Bound: 4*R operations per packed byte at R <= 16 rows, far below the
// card's ~295 per byte, so the packed weight's bytes (Dp * N2, read once)
// bound it.  The grid has (N2/128) x g blocks: 36 x 3 = 108 at the Phi-3
// qkv shape, fewer than the 132 SMs, which is the 2-D grid's cost on this
// card (kernel A splits inside a group to fill it).

#include "int4_tile.cuh"

namespace {

using namespace d3;

struct Params {
  const __nv_bfloat16* x;
  int rows, d;
  const int8_t* q4;
  const float* s_lo;
  const float* s_hi;
  int n2, dblk, ks;
  void* out;
  int out_f32, n_out;
  float* ws;
  unsigned int* tickets;
};

template <int RB>
__global__ void __launch_bounds__(kThreads) int4_matvec2d_kernel(Params p) {
  __shared__ float smem[kSmemFloats];
  __shared__ int is_last;
  const int tile = blockIdx.x, grp = blockIdx.y, ng = gridDim.y;

  Acc<RB> a;
  acc_zero(a);
  for (int k0 = grp * p.dblk; k0 < (grp + 1) * p.dblk; k0 += p.ks) {
    __syncthreads();
    stage<RB>(smem, p.x, p.rows, p.d, p.d, k0, p.ks, nullptr, nullptr);
    __syncthreads();
    acc_slice(a, smem, p.ks, p.q4, p.n2, k0, tile);
  }
  float tot[RB];
  acc_reduce(a, smem, tot);
  const OutCol c = out_col(tile, p.n2);
  apply_scale<RB>(tot, c, p.s_lo, p.s_hi, grp, p.n2);
  if (!combine<RB>(tot, c, p.rows, grp, ng, p.n2, p.ws, p.tickets + tile, &is_last)) return;
  if (c.ok && c.po < p.n_out) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < p.rows) {
        const long i = (long)r * p.n_out + c.po;
        if (p.out_f32) reinterpret_cast<float*>(p.out)[i] = tot[r];
        else reinterpret_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16(tot[r]);
      }
    }
  }
}

}  // namespace

// Launches out[rows, n_out] = (x @ dequant(q4))[:, :n_out].  Returns
// cudaGetLastError(); 1 (cudaErrorInvalidValue) for arguments it does not take.
//   x: [rows, d] bf16, rows <= 16;  q4: [dp, n2] int8, n2 % 4 == 0;
//   s_lo/s_hi: [dp/dblk, n2] f32;  ws: f32 [dp/dblk, rows, 2*n2];
//   tickets: zeroed uint32 [ceil(n2/128)]
extern "C" int int4_matvec2d(const void* x, int rows, int d, const int8_t* q4,
                             const float* s_lo, const float* s_hi, int dp, int n2, int dblk,
                             void* out, int out_f32, int n_out, float* ws,
                             unsigned int* tickets, void* stream) {
  const int rb = row_bucket(rows);
  // the sub-slice: the largest power-of-two divisor of dblk the stage holds
  int ks = dblk;
  while (ks > kSmemFloats / rb && ks % 2 == 0) ks /= 2;
  if (rows < 1 || rows > kMaxRows || n2 % 4 != 0 || dblk % ks != 0 || ks > kSmemFloats / rb ||
      dp % dblk != 0 || d > dp)
    return 1;
  Params p{reinterpret_cast<const __nv_bfloat16*>(x), rows, d, q4, s_lo, s_hi, n2, dblk, ks,
           out, out_f32, n_out, ws, tickets};
  dim3 grid((n2 + kTile - 1) / kTile, dp / dblk);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (rb) {
    case 1: int4_matvec2d_kernel<1><<<grid, kThreads, 0, st>>>(p); break;
    case 2: int4_matvec2d_kernel<2><<<grid, kThreads, 0, st>>>(p); break;
    case 4: int4_matvec2d_kernel<4><<<grid, kThreads, 0, st>>>(p); break;
    case 8: int4_matvec2d_kernel<8><<<grid, kThreads, 0, st>>>(p); break;
    default: int4_matvec2d_kernel<16><<<grid, kThreads, 0, st>>>(p); break;
  }
  return (int)cudaGetLastError();
}
