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
// Body: the tensor-core body of int4_mma.cuh at every row count (its
// int4_matvec_kernel, which kernel E launches with another plan).  A block
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

#include "int4_mma.cuh"

namespace {

// K split into at most this many slices: o and down (12 column tiles)
// measured faster at 8 than at 12 and 16 (PERF.md, PR 5)
constexpr int kMaxSplits = 8;

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
  return d3mma::launch_matvec(reinterpret_cast<cudaStream_t>(stream), x, x_f32, rows, d, ln_w,
                              eps, q4, s_lo, s_hi, dp, n2, dblk, ks, resid, resid_f32, epilogue,
                              out, out_f32, n_out, ws, tickets);
}
