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
//
// Body: the tensor-core body of int4_mma.cuh (shared with kernel A) at every
// row count.  Per block a producer warp streams each work item's [ks, 128]
// weight slice through a 4-slot ring of TMA box copies, four consumer warps
// run mma.sync on bf16 fragments of the packed bytes; the ring runs on
// across work items, and before the grid barrier the producer already
// fetches the first down-projection stages (they do not depend on h).  The
// first design ran one f32 FMA per nibble and row on the CUDA cores (254
// registers, one block per SM at 16 rows); at 1 row, where it held out
// longest, the tensor-core body measured 0.0385 against 0.0425 ms for F and
// 0.0442 against 0.0479 ms for G (chip_smoke.py on an NVIDIA H100 80GB HBM3
// at 700 W; PERF.md, PR 5).

#include <cooperative_groups.h>

#include "int4_mma.cuh"

namespace cg = cooperative_groups;
namespace mm = d3mma;

namespace {

constexpr int kMaxRows = 16;

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
  CUtensorMap gu_map;       // TMA views of gu_q4 and dn_q4
  CUtensorMap dn_map;
};

// NT n8 tiles of x rows: 1-8 rows (NT = 1) or 9-16 (NT = 2); three blocks
// per SM
template <int NT>
__global__ void __launch_bounds__(mm::kThreads, 3) int4_mlp_kernel(
    const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  __shared__ float inv_rms[kMaxRows];
  __shared__ int is_last;
  cg::grid_group grid = cg::this_grid();
  const mm::Ring ring = mm::ring_at(smem_dyn, NT);
  __nv_bfloat16* xs = mm::xs_at(smem_dyn);

  const int tiles1 = (p.gu_n2 + mm::kCols - 1) / mm::kCols, ns1 = p.gu_dp / p.ks1;
  const int tiles2 = (p.dn_n2 + mm::kCols - 1) / mm::kCols, ns2 = p.dn_dp / p.ks2;
  const int nst1 = p.ks1 / mm::kKc, nst2 = p.ks2 / mm::kKc;
  if (threadIdx.x == 0) mm::ring_init(ring);
  __syncthreads();

  if (threadIdx.x >= mm::kConsumers) {   // the producer warp
    const int total1 = mm::block_stages(tiles1 * ns1, nst1);
    const int total2 = mm::block_stages(tiles2 * ns2, nst2);
    int it = mm::produce_phase(ring, 0, &p.gu_map, p.gu_dp, p.ks1, 0, total1);
    // the first down stages do not depend on h: fetch them before the barrier
    const int pre = min(mm::kStages, total2);
    it = mm::produce_phase(ring, it, &p.dn_map, p.dn_dp, p.ks2, 0, pre);
    grid.sync();
    mm::produce_phase(ring, it, &p.dn_map, p.dn_dp, p.ks2, pre, total2);
    return;
  }

  if (p.ln_w != nullptr) mm::row_inv_rms(p.x, 0, p.rows, p.d, p.eps, inv_rms);
  float* red = reinterpret_cast<float*>(xs);   // the sums' room, once xs is read
  int it = 0;

  // ---- phase 1: h = silu(gate) * up, rounded to bf16 ----
  for (int item = blockIdx.x; item < tiles1 * ns1; item += gridDim.x) {
    const int tile = item / ns1, split = item - tile * ns1, k0 = split * p.ks1;
    const int col0 = tile * mm::kCols;
    mm::consumer_sync();   // the previous item's reads of xs / red are done
    mm::stage_x<NT>(xs, p.x, 0, p.rows, p.d, p.d, k0, p.ks1, inv_rms, p.ln_w);
    mm::consumer_sync();
    const mm::Scales sc = mm::load_scales(col0, p.gu_slo, p.gu_shi, k0 / p.dblk, p.gu_n2);
    mm::Acc<NT> acc;
    mm::acc_zero(acc);
    for (int s = 0; s < nst1; ++s) mm::consume<NT>(ring, it++, xs, s * mm::kKc, acc);
    mm::scale(acc, sc);
    mm::consumer_sync();
    float tot[8 * NT][2];
    if (!mm::finish<NT>(acc, red, col0, p.rows, split, ns1, p.gu_n2, p.ws1, p.tickets + tile,
                        &is_last, tot))
      continue;
    // gate = lo half, up = hi half of the same packed column
    const int c = col0 + (int)threadIdx.x;
    if (c >= p.gu_n2) continue;
#pragma unroll
    for (int r = 0; r < 8 * NT; ++r) {
      if (r >= p.rows) break;
      const float gt = tot[r][0], up = tot[r][1];
      p.h[(long)r * p.gu_n2 + c] = __float2bfloat16(gt * (1.f / (1.f + expf(-gt))) * up);
    }
  }

  grid.sync();

  // ---- phase 2: out = h @ down (+ x) ----
  for (int item = blockIdx.x; item < tiles2 * ns2; item += gridDim.x) {
    const int tile = item / ns2, split = item - tile * ns2, k0 = split * p.ks2;
    const int col0 = tile * mm::kCols;
    mm::consumer_sync();
    // rows I..dn_dp-1 of down are padding: their activations stage as zero
    mm::stage_x<NT>(xs, p.h, 0, p.rows, p.gu_n2, p.gu_n2, k0, p.ks2, nullptr, nullptr);
    mm::consumer_sync();
    const mm::Scales sc = mm::load_scales(col0, p.dn_slo, p.dn_shi, k0 / p.dblk, p.dn_n2);
    mm::Acc<NT> acc;
    mm::acc_zero(acc);
    for (int s = 0; s < nst2; ++s) mm::consume<NT>(ring, it++, xs, s * mm::kKc, acc);
    mm::scale(acc, sc);
    mm::consumer_sync();
    float tot[8 * NT][2];
    if (!mm::finish<NT>(acc, red, col0, p.rows, split, ns2, p.dn_n2, p.ws2,
                        p.tickets + tiles1 + tile, &is_last, tot))
      continue;
    const int c = col0 + (int)threadIdx.x;
    if (c >= p.dn_n2) continue;
    if (p.residual) {   // every residual load before the first store
#pragma unroll
      for (int r = 0; r < 8 * NT; ++r)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long po = (long)half * p.dn_n2 + c;
          if (r < p.rows && po < p.n_out) tot[r][half] += __bfloat162float(p.x[(long)r * p.d + po]);
        }
    }
#pragma unroll
    for (int r = 0; r < 8 * NT; ++r) {
      if (r >= p.rows) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long po = (long)half * p.dn_n2 + c;
        if (po >= p.n_out) continue;
        const long i = (long)r * p.n_out + po;
        if (p.out_f32) reinterpret_cast<float*>(p.out)[i] = tot[r][half];
        else reinterpret_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16(tot[r][half]);
      }
    }
  }
}

template <int NT>
int prepare(void** fn) {
  static bool raised = false;   // the shared-memory limit, raised once
  *fn = reinterpret_cast<void*>(int4_mlp_kernel<NT>);
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_mlp_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, mm::smem_bytes(NT));
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  return 0;
}

int kernel_for_rows(int rows, void** fn) { return rows <= 8 ? prepare<1>(fn) : prepare<2>(fn); }

int smem_for_rows(int rows) { return mm::smem_bytes(rows <= 8 ? 1 : 2); }

int plan(int rows, int gu_dp, int gu_n2, int dn_dp, int dn_n2, int dblk, int* out3) {
  if (rows < 1 || rows > kMaxRows || gu_n2 % 16 != 0 || dn_n2 % 16 != 0) return 1;
  void* fn = nullptr;
  int rc = kernel_for_rows(rows, &fn);
  if (rc != 0) return rc;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, mm::kThreads,
                                                      smem_for_rows(rows));
  if (e != cudaSuccess) return (int)e;
  const int grid = coop ? per_sm * sms : 0;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // a work item per SM in at most 16 slices: aiming at the whole grid
  // split gate_up 12 ways, and 8 slices left down 96 items for the 396
  // blocks; both measured slower at 12 rows (PERF.md, PR 5)
  const int ks1 = mm::pick_slice(dblk, gu_dp, (gu_n2 + mm::kCols - 1) / mm::kCols, sms, 16);
  const int ks2 = mm::pick_slice(dblk, dn_dp, (dn_n2 + mm::kCols - 1) / mm::kCols, sms, 16);
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
  if (rows < 1 || rows > kMaxRows || !mm::takes(gu_q4, gu_n2, ks1) ||
      !mm::takes(dn_q4, dn_n2, ks2))
    return 1;
  void* fn = nullptr;
  int rc = kernel_for_rows(rows, &fn);
  if (rc != 0) return rc;
  Params p{reinterpret_cast<const __nv_bfloat16*>(x), rows, d, ln_w, eps, gu_q4, gu_slo,
           gu_shi, gu_dp, gu_n2, dn_q4, dn_slo, dn_shi, dn_dp, dn_n2, n_out, dblk, ks1,
           ks2, residual, reinterpret_cast<__nv_bfloat16*>(h), out, out_f32, ws1, ws2,
           tickets, {}, {}};
  rc = mm::weight_map(&p.gu_map, gu_q4, gu_dp, gu_n2);
  if (rc == 0) rc = mm::weight_map(&p.dn_map, dn_q4, dn_dp, dn_n2);
  if (rc != 0) return rc;
  void* args[] = {&p};
  cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(mm::kThreads), args, smem_for_rows(rows),
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
