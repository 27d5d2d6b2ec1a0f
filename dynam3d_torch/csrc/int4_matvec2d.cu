// Kernel E: int4 weight-only matvec over a 2-D grid for Hopper (sm_90a),
// y[R<=16, 2*N2] = x @ dequant(W), halves lo | hi.
//
// Replaces the TPU kernel dynam3d_tpu/ops/pallas_int4.py::_pallas_int4_matmul2d
// (_kernel2d): a program per (column block j, scale group i), the nibbles
// unpacked with shifts, each group's product scaled by its group scale and
// the groups summed in order i = 0..g-1.
//
// Here the plan of that grid on the tensor-core body of int4_mma.cuh (the
// int4_matvec_kernel of kernel A): a block per (tile of 128 packed columns,
// scale group), whose K slice is the whole group (ks = dblk, dblk <= 1024);
// a producer warp streams the group's [dblk, 128] weight slice through the
// 4-slot TMA ring, four consumer warps run mma.sync m16n8k16 on bf16
// fragments of the packed bytes against the staged x slice, scale() applies
// the group's scales, and the block that takes the tile's last ticket sums
// the groups in order 0..g-1 (finish()) and stores.  The result is
// deterministic; it differs from kernel A only where A's plan cuts a group
// into several slices.  The nibbles are the integers the TPU's shift unpack
// gives (test_torch_int4_fragments.py holds the conversion).
//
// Bound: 4*R operations per packed byte at R <= 16 rows, far below the
// card's ~295 per byte, so the packed weight's bytes (Dp * N2, read once)
// bound it.  The grid has (N2/128) x g blocks: 36 x 3 = 108 at the Phi-3
// qkv shape, fewer than the 132 SMs (kernel A splits inside a group to fill
// the card); even so it took 0.0191 ms at qkv, 8 rows, against 0.0222 ms
// for bf16 torch.matmul on the dequantized weight, and 0.0256 ms at the
// lm_head, 1 row (384 items, A's own plan there), so no finer grid is kept.
// The first design ran one f32 FMA per nibble and row on the CUDA cores
// (a shared tile loop, since removed): 0.0601 and 0.0502 ms (chip_smoke.py
// on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6).

#include "int4_mma.cuh"

// Launches out[rows, n_out] = (x @ dequant(q4))[:, :n_out].  Returns
// cudaGetLastError(); 1 (cudaErrorInvalidValue) for arguments it does not take.
//   x: [rows, d] bf16, rows <= 16;  q4: [dp, n2] int8, 16-byte aligned,
//   n2 % 16 == 0;  dblk: a multiple of 64, at most 1024, dividing dp;
//   s_lo/s_hi: [dp/dblk, n2] f32;  ws: f32 [dp/dblk, rows, 2*n2];
//   tickets: zeroed uint32 [ceil(n2/128)]
extern "C" int int4_matvec2d(const void* x, int rows, int d, const int8_t* q4,
                             const float* s_lo, const float* s_hi, int dp, int n2, int dblk,
                             void* out, int out_f32, int n_out, float* ws,
                             unsigned int* tickets, void* stream) {
  if (d > dp) return 1;
  return d3mma::launch_matvec(reinterpret_cast<cudaStream_t>(stream), x, 0, rows, d, nullptr,
                              0.f, q4, s_lo, s_hi, dp, n2, dblk, dblk, nullptr, 0, d3mma::kStore,
                              out, out_f32, n_out, ws, tickets);
}

// Work items of a launch: column tiles x scale groups
extern "C" int int4_matvec2d_items(int n2, int dp, int dblk) {
  return (n2 + d3mma::kCols - 1) / d3mma::kCols * (dp / dblk);
}

// Blocks of the kernel one SM holds at `rows` activation rows, into *count;
// returns the CUDA error code
extern "C" int int4_matvec2d_blocks_per_sm(int rows, int* count) {
  return d3mma::matvec_blocks_per_sm(rows, count);
}
