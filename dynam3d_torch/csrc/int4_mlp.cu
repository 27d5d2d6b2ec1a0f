// Kernels F and G: the fused int4 SwiGLU MLP for Hopper (sm_90a), one
// cooperative launch each.
//
//   F  int4_mlp:        out = down(silu(gate(x)) * up(x))
//   G  int4_mlp_block:  out = x + down(silu(gate(xn)) * up(xn)),
//                       xn = bf16(rmsnorm(x) * ln_w)
//
// Replace the TPU kernels dynam3d_tpu/ops/pallas_int4.py::_pallas_int4_mlp
// (_mlp_kernel) and ::_pallas_int4_mlp_block (_mlp_block_kernel): a
// sequential grid whose first programs fill a bf16 scratch h = silu(gate) *
// up column block by column block, then stream the down projection over the
// completed scratch.  gate | up are the lo | hi nibble halves of one packed
// gate_up array, so a packed column yields its SwiGLU output alone.
//
// Here the blocks of one cooperative launch walk two phases:
//   1. work items (tile of 128 packed gate_up columns, K slice): partial
//      products to a workspace; the block with a tile's last ticket sums the
//      slices in order, applies silu(gate) * up in f32 and stores h in bf16
//      to a global scratch [rows, I] (16 x 8192 bf16 = 256 KB: more than one
//      SM's shared memory, held in L2);
//   2. after a grid barrier (cooperative_groups), the same over the down
//      projection with h as the activations; G adds the residual x in f32.
// The grid is the blocks the card holds at once (occupancy x SMs); a launch
// the card cannot hold at once is refused and the wrapper raises.
//
// Bound: 4*R operations per packed byte at R <= 16 rows, so the bytes of the
// two packed weights (3072 x 8192 + 8192 x 1536 bytes, ~37.8 MB with scales
// at Phi-3-mini widths), read once, bound it.

#include <cooperative_groups.h>

#include "int4_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace d3;

struct Params {
  const __nv_bfloat16* x;   // [rows, d]
  int rows, d;
  const float* ln_w;        // [d] (G) or NULL (F)
  float eps;
  const int8_t* gu_q4;      // [gu_dp, I] gate | up
  const float* gu_slo;
  const float* gu_shi;
  int gu_dp, gu_n2;
  const int8_t* dn_q4;      // [dn_dp, dn_n2]
  const float* dn_slo;
  const float* dn_shi;
  int dn_dp, dn_n2, n_out;
  int dblk, ks1, ks2;
  int residual;             // G: out += x
  __nv_bfloat16* h;         // scratch [rows, I]
  void* out;                // [rows, n_out]
  int out_f32;
  float* ws1;
  float* ws2;
  unsigned int* tickets;    // [tiles1 + tiles2], zeroed
};

template <int RB>
__global__ void __launch_bounds__(kThreads) int4_mlp_kernel(Params p) {
  __shared__ float smem[kSmemFloats];
  __shared__ float inv_rms[kMaxRows];
  __shared__ int is_last;
  cg::grid_group grid = cg::this_grid();

  if (p.ln_w != nullptr) row_inv_rms(p.x, p.rows, p.d, p.eps, inv_rms);

  // ---- phase 1: h = silu(gate) * up, rounded to bf16 ----
  const int tiles1 = (p.gu_n2 + kTile - 1) / kTile, ns1 = p.gu_dp / p.ks1;
  for (int item = blockIdx.x; item < tiles1 * ns1; item += gridDim.x) {
    const int tile = item / ns1, split = item - tile * ns1, k0 = split * p.ks1;
    Acc<RB> a;
    acc_zero(a);
    __syncthreads();
    stage<RB>(smem, p.x, p.rows, p.d, p.d, k0, p.ks1, inv_rms, p.ln_w);
    __syncthreads();
    acc_slice(a, smem, p.ks1, p.gu_q4, p.gu_n2, k0, tile);
    float tot[RB];
    acc_reduce(a, smem, tot);
    const OutCol c = out_col(tile, p.gu_n2);
    apply_scale<RB>(tot, c, p.gu_slo, p.gu_shi, k0 / p.dblk, p.gu_n2);
    if (!combine<RB>(tot, c, p.rows, split, ns1, p.gu_n2, p.ws1, p.tickets + tile, &is_last))
      continue;
    // gate = lo half, up = hi half of the same packed column
    if (c.half == 1 && c.ok) {
#pragma unroll
      for (int r = 0; r < RB; ++r) smem[r * kTile + (threadIdx.x - kTile)] = tot[r];
    }
    __syncthreads();
    if (c.half == 0 && c.ok) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < p.rows) {
          const float gt = tot[r], up = smem[r * kTile + threadIdx.x];
          p.h[(long)r * p.gu_n2 + c.col] = __float2bfloat16(gt * (1.f / (1.f + expf(-gt))) * up);
        }
      }
    }
  }

  grid.sync();

  // ---- phase 2: out = h @ down (+ x) ----
  const int tiles2 = (p.dn_n2 + kTile - 1) / kTile, ns2 = p.dn_dp / p.ks2;
  for (int item = blockIdx.x; item < tiles2 * ns2; item += gridDim.x) {
    const int tile = item / ns2, split = item - tile * ns2, k0 = split * p.ks2;
    Acc<RB> a;
    acc_zero(a);
    __syncthreads();
    // rows I..dn_dp-1 of down are padding: their activations stage as zero
    stage<RB>(smem, p.h, p.rows, p.gu_n2, p.gu_n2, k0, p.ks2, nullptr, nullptr);
    __syncthreads();
    acc_slice(a, smem, p.ks2, p.dn_q4, p.dn_n2, k0, tile);
    float tot[RB];
    acc_reduce(a, smem, tot);
    const OutCol c = out_col(tile, p.dn_n2);
    apply_scale<RB>(tot, c, p.dn_slo, p.dn_shi, k0 / p.dblk, p.dn_n2);
    if (!combine<RB>(tot, c, p.rows, split, ns2, p.dn_n2, p.ws2, p.tickets + tiles1 + tile,
                     &is_last))
      continue;
    if (c.ok && c.po < p.n_out) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < p.rows) {
          float v = tot[r];
          if (p.residual) v += __bfloat162float(p.x[(long)r * p.d + c.po]);
          const long i = (long)r * p.n_out + c.po;
          if (p.out_f32) reinterpret_cast<float*>(p.out)[i] = v;
          else reinterpret_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16(v);
        }
      }
    }
  }
}

template <int RB>
void* kernel_for() {
  return reinterpret_cast<void*>(int4_mlp_kernel<RB>);
}

void* kernel_for_rows(int rows) {
  switch (row_bucket(rows)) {
    case 1: return kernel_for<1>();
    case 2: return kernel_for<2>();
    case 4: return kernel_for<4>();
    case 8: return kernel_for<8>();
    default: return kernel_for<16>();
  }
}

int plan(int rows, int gu_dp, int gu_n2, int dn_dp, int dn_n2, int dblk, int* out3) {
  if (rows < 1 || rows > kMaxRows || gu_n2 % 4 != 0 || dn_n2 % 4 != 0) return 1;
  int grid = 0;
  const int rc = coop_grid(kernel_for_rows(rows), &grid);
  if (rc != 0) return rc;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int rb = row_bucket(rows);
  const int ks1 = pick_slice(dblk, gu_dp, (gu_n2 + kTile - 1) / kTile, grid, rb);
  const int ks2 = pick_slice(dblk, dn_dp, (dn_n2 + kTile - 1) / kTile, grid, rb);
  if (ks1 < 1 || ks2 < 1 || gu_dp % dblk != 0 || dn_dp % dblk != 0) return 1;
  out3[0] = grid;
  out3[1] = ks1;
  out3[2] = ks2;
  return 0;
}

int launch(const void* x, int rows, int d, const float* ln_w, float eps, const int8_t* gu_q4,
           const float* gu_slo, const float* gu_shi, int gu_dp, int gu_n2,
           const int8_t* dn_q4, const float* dn_slo, const float* dn_shi, int dn_dp,
           int dn_n2, int n_out, int dblk, int grid, int ks1, int ks2, int residual,
           void* h, void* out, int out_f32, float* ws1, float* ws2, unsigned int* tickets,
           void* stream) {
  Params p{reinterpret_cast<const __nv_bfloat16*>(x), rows, d, ln_w, eps, gu_q4, gu_slo,
           gu_shi, gu_dp, gu_n2, dn_q4, dn_slo, dn_shi, dn_dp, dn_n2, n_out, dblk, ks1,
           ks2, residual, reinterpret_cast<__nv_bfloat16*>(h), out, out_f32, ws1, ws2,
           tickets};
  void* args[] = {&p};
  cudaLaunchCooperativeKernel(kernel_for_rows(rows), dim3(grid), dim3(kThreads), args, 0,
                              reinterpret_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

}  // namespace

// Launch plan for rows activation rows: out3 = {grid, ks1, ks2}, the
// cooperative grid (blocks the card holds at once) and the K slices of the
// two phases.  Returns 0, a CUDA error code, or 1 for shapes it does not take.
extern "C" int int4_mlp_plan(int rows, int gu_dp, int gu_n2, int dn_dp, int dn_n2, int dblk,
                             int* out3) {
  return plan(rows, gu_dp, gu_n2, dn_dp, dn_n2, dblk, out3);
}

// Kernel F: out[rows, n_out] = (bf16(silu(x @ gate) * (x @ up)) @ down)[:, :n_out].
//   x: [rows, d] bf16, d <= gu_dp;  gate_up: q4 [gu_dp, I] (lo = gate, hi = up)
//   down: q4 [dn_dp, dn_n2], dn_dp >= I;  h: bf16 scratch [rows, I]
//   ws1: f32 [gu_dp/ks1, rows, 2*I];  ws2: f32 [dn_dp/ks2, rows, 2*dn_n2]
//   tickets: zeroed uint32 [ceil(I/128) + ceil(dn_n2/128)]
// Returns cudaGetLastError() after the cooperative launch.
extern "C" int int4_mlp(const void* x, int rows, int d, const int8_t* gu_q4, const float* gu_slo,
                        const float* gu_shi, int gu_dp, int gu_n2, const int8_t* dn_q4,
                        const float* dn_slo, const float* dn_shi, int dn_dp, int dn_n2,
                        int n_out, int dblk, int grid, int ks1, int ks2, void* h, void* out,
                        int out_f32, float* ws1, float* ws2, unsigned int* tickets,
                        void* stream) {
  return launch(x, rows, d, nullptr, 0.f, gu_q4, gu_slo, gu_shi, gu_dp, gu_n2, dn_q4, dn_slo,
                dn_shi, dn_dp, dn_n2, n_out, dblk, grid, ks1, ks2, 0, h, out, out_f32, ws1,
                ws2, tickets, stream);
}

// Kernel G: out[rows, d] = x + F(bf16(x * rsqrt(mean(x^2) + eps) * ln_w)), with
// d == gu_dp == dn_n2 * 2 (unpadded widths); arguments as int4_mlp.
extern "C" int int4_mlp_block(const void* x, int rows, int d, const float* ln_w, float eps,
                              const int8_t* gu_q4, const float* gu_slo, const float* gu_shi,
                              int gu_dp, int gu_n2, const int8_t* dn_q4, const float* dn_slo,
                              const float* dn_shi, int dn_dp, int dn_n2, int dblk, int grid,
                              int ks1, int ks2, void* h, void* out, int out_f32, float* ws1,
                              float* ws2, unsigned int* tickets, void* stream) {
  if (d != gu_dp || d != 2 * dn_n2 || ln_w == nullptr) return 1;
  return launch(x, rows, d, ln_w, eps, gu_q4, gu_slo, gu_shi, gu_dp, gu_n2, dn_q4, dn_slo,
                dn_shi, dn_dp, dn_n2, d, dblk, grid, ks1, ks2, 1, h, out, out_f32, ws1, ws2,
                tickets, stream);
}
