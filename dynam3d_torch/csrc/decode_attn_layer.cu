// Kernel H: the attention half of a Phi-3 decode layer at B=1 for Hopper
// (sm_90a), one cooperative launch:
//   rmsnorm -> int4 qkv -> RoPE -> online-softmax attention over the cache
//   rows of the live prefix plus the current token -> int4 o + residual.
//
// Replaces the TPU kernel dynam3d_tpu/ops/pallas_decode.py::decode_attn_layer
// (_decode_attn_kernel), the attention program of the split decode route
// (the MLP half is kernel G, int4_mlp.cu).  Inputs: x [D] bf16, the packed
// qkv [D -> 3D] and o [D -> D] weights, the flat bf16 caches
// [L, Bc, Tmax, D] (cache row 0), a byte mask [Tmax] that excludes the write
// slot, the scan length and the RoPE cos/sin [hd/2].  Outputs: x_out =
// bf16(x + o(ctx)) and the roped k_new / v_new [D] bf16 for the caller's
// cache write.
//
// Three phases over the blocks of one cooperative launch, a grid barrier
// (cooperative_groups) between them:
//   1. rmsnorm (each block reduces x itself) and the qkv matvec on the
//      tensor-core body of int4_mma.cuh (kernel G's): work items (tile of 128
//      packed columns, K slice) over all blocks, slices summed in order by
//      each tile's last block into y [3D] f32 (global scratch);
//   2. the attention body of decode_attn.cuh (kernel B's) for the one row:
//      work items (head, sequence split) over all blocks, each head's splits
//      merged in order by its last block, the current token folded last;
//      ctx [D] bf16 to global scratch;
//   3. the o matvec over ctx as in phase 1, plus the residual, to bf16.
// A producer warp feeds both bodies' rings: phase 1's weight stages, then,
// before the first barrier, the first cache tiles of its phase-2 items and
// the first o stages (neither depends on y or ctx).
//
// Numerics: attention arithmetic is f32 with P split hi/lo on the tensor
// cores (the TPU kernel rounds the k*q products and the probabilities to
// bf16), as in kernel B.
//
// Bound: the packed qkv and o weights (14.2 + 4.7 MB at Phi-3-mini widths)
// and the live cache rows (2 * valid rows * D * 2 bytes) are each read once,
// a few operations per byte: bytes bound it.  The first design ran phase 2
// on one block per head (32 of 132 SMs), each thread owning whole cache rows,
// and the matvecs on a CUDA-core loop: 0.0882 ms at 869 live rows
// (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6).

#include <cooperative_groups.h>

#include "decode_attn.cuh"
#include "int4_mma.cuh"

namespace cg = cooperative_groups;
namespace mm = d3mma;
namespace da = d3attn;

namespace {

struct Params {
  const __nv_bfloat16* x;   // [D]
  int D;
  const float* ln_w;
  float eps;
  const float* qkv_slo;     // qkv: [qkv_dp, 3D/2] packed
  const float* qkv_shi;
  int qkv_dp, qkv_n2;
  const float* o_slo;       // o: [o_dp, D/2] packed
  const float* o_shi;
  int o_dp, o_n2;
  int dblk, ks1, ks3;
  da::Args a;               // phase 2: the one row over y; ctx, k_new, v_new
  float* y;                 // scratch [3D]
  __nv_bfloat16* out;       // [D]
  float* ws1;
  float* ws3;
  unsigned int* tickets;    // [tiles1 + tiles3] (phase 2's follow in a), zeroed
  CUtensorMap qkv_map;      // TMA views of the packed weights and of the caches
  CUtensorMap o_map;
  CUtensorMap k_map;
  CUtensorMap v_map;
};

// One B=1 matvec work item on the consumer warps: the ordered sum of its
// tile in tot[0] (lo, hi of packed column col0 + thread) in the block that
// completes the tile, false in the others.
__device__ __forceinline__ bool matvec_item(const mm::Ring& ring, int& it, __nv_bfloat16* xs,
                                            const __nv_bfloat16* src, int d, const float* inv_rms,
                                            const float* ln_w, const float* s_lo,
                                            const float* s_hi, int n2, int dblk, int ks,
                                            int tile, int split, int nsplit, float* ws,
                                            unsigned int* ticket, int* is_last,
                                            float tot[8][2]) {
  const int k0 = split * ks, col0 = tile * mm::kCols;
  mm::consumer_sync();   // the previous item's reads of xs / its sums are done
  mm::stage_x<1>(xs, src, 0, 1, d, d, k0, ks, inv_rms, ln_w);
  mm::consumer_sync();
  const mm::Scales sc = mm::load_scales(col0, s_lo, s_hi, k0 / dblk, n2);
  mm::Acc<1> acc;
  mm::acc_zero(acc);
  for (int s = 0; s < ks / mm::kKc; ++s) mm::consume<1>(ring, it++, xs, s * mm::kKc, acc);
  mm::scale(acc, sc);
  mm::consumer_sync();   // every warp is done with xs: its room takes the sums
  return mm::finish<1>(acc, reinterpret_cast<float*>(xs), col0, 1, split, nsplit, n2, ws, ticket,
                       is_last, tot);
}

// The attention region after the int4 body's ring, x slice and barriers
constexpr int kAttnOffset = (mm::smem_bytes(1) - mm::kAlign + da::kAlign - 1) / da::kAlign *
                            da::kAlign;

template <int HD>
constexpr int smem_bytes() {
  return mm::kAlign + kAttnOffset + da::Layout<HD, 1>::kBytes;
}

template <int HD>
__global__ void __launch_bounds__(mm::kThreads, 2) decode_attn_layer_kernel(
    const __grid_constant__ Params p) {
  static_assert(mm::kThreads == da::kThreads && mm::kConsumers == da::kConsumers,
                "the two bodies share the block's warps");
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  __shared__ float inv_rms[1];
  __shared__ int is_last;
  cg::grid_group grid = cg::this_grid();
  const mm::Ring ring = mm::ring_at(smem_dyn, 1);
  __nv_bfloat16* xs = mm::xs_at(smem_dyn);
  const da::Smem as = da::smem_at<HD, 1>(mm::aligned_base(smem_dyn) + kAttnOffset);
  const int D = p.D;

  const int tiles1 = (p.qkv_n2 + mm::kCols - 1) / mm::kCols, ns1 = p.qkv_dp / p.ks1;
  const int tiles3 = (p.o_n2 + mm::kCols - 1) / mm::kCols, ns3 = p.o_dp / p.ks3;
  const int nst1 = p.ks1 / mm::kKc, nst3 = p.ks3 / mm::kKc;
  const int items1 = tiles1 * ns1;
  const int items2 = p.a.heads * p.a.nsplit;
  const int items3 = tiles3 * ns3;
  if (threadIdx.x == 0) {
    mm::ring_init(ring);
    da::ring_init(as);
  }
  __syncthreads();

  if (threadIdx.x >= mm::kConsumers) {   // the producer warp
    int it = mm::produce_phase(ring, 0, &p.qkv_map, p.qkv_dp, p.ks1, 0,
                               mm::block_stages(items1, nst1));
    // neither the cache tiles nor o depend on y: fetch the first before the barrier
    const int tiles2 = da::block_tiles(p.a, items2), pre2 = min(da::kStages, tiles2);
    da::produce_tiles<HD>(as, p.a, &p.k_map, &p.v_map, items2, 0, pre2);
    const int total3 = mm::block_stages(items3, nst3), pre3 = min(mm::kStages, total3);
    it = mm::produce_phase(ring, it, &p.o_map, p.o_dp, p.ks3, 0, pre3);
    grid.sync();
    da::produce_tiles<HD>(as, p.a, &p.k_map, &p.v_map, items2, pre2, tiles2);
    grid.sync();
    mm::produce_phase(ring, it, &p.o_map, p.o_dp, p.ks3, pre3, total3);
    return;
  }

  // ---- phase 1: y = bf16(rmsnorm(x) * ln_w) @ qkv ----
  mm::row_inv_rms(p.x, 0, 1, D, p.eps, inv_rms);
  int it = 0;
  for (int item = blockIdx.x; item < items1; item += gridDim.x) {
    const int tile = item / ns1, split = item - tile * ns1;
    float tot[8][2];
    if (!matvec_item(ring, it, xs, p.x, D, inv_rms, p.ln_w, p.qkv_slo, p.qkv_shi, p.qkv_n2,
                     p.dblk, p.ks1, tile, split, ns1, p.ws1, p.tickets + tile, &is_last, tot))
      continue;
    const int c = tile * mm::kCols + (int)threadIdx.x;
    if (c < p.qkv_n2) {
      p.y[c] = tot[0][0];
      p.y[p.qkv_n2 + c] = tot[0][1];
    }
  }

  grid.sync();

  // ---- phase 2: attention of the one row, (head, split) items over the grid ----
  int it2 = 0;
  for (int item = blockIdx.x; item < items2; item += gridDim.x)
    da::consume_item<HD, 1>(as, p.a, item, it2);

  grid.sync();

  // ---- phase 3: out = bf16(x + ctx @ o) ----
  for (int item = blockIdx.x; item < items3; item += gridDim.x) {
    const int tile = item / ns3, split = item - tile * ns3;
    float tot[8][2];
    if (!matvec_item(ring, it, xs, p.a.ctx, D, nullptr, nullptr, p.o_slo, p.o_shi, p.o_n2,
                     p.dblk, p.ks3, tile, split, ns3, p.ws3, p.tickets + tiles1 + tile, &is_last,
                     tot))
      continue;
    const int c = tile * mm::kCols + (int)threadIdx.x;
    if (c < p.o_n2) {
      const float lo = __bfloat162float(p.x[c]) + tot[0][0];
      const float hi = __bfloat162float(p.x[p.o_n2 + c]) + tot[0][1];
      p.out[c] = __float2bfloat16(lo);
      p.out[p.o_n2 + c] = __float2bfloat16(hi);
    }
  }
}

// The kernel at head dim HD with its shared-memory opt-in raised (once per
// process)
template <int HD>
void* prepared() {
  static const cudaError_t e = cudaFuncSetAttribute(
      decode_attn_layer_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<HD>());
  return e == cudaSuccess ? reinterpret_cast<void*>(decode_attn_layer_kernel<HD>) : nullptr;
}

void* kernel_for_hd(int hd, int* smem) {
  switch (hd) {
    case 32: *smem = smem_bytes<32>(); return prepared<32>();
    case 64: *smem = smem_bytes<64>(); return prepared<64>();
    case 96: *smem = smem_bytes<96>(); return prepared<96>();
    case 128: *smem = smem_bytes<128>(); return prepared<128>();
    default: return nullptr;
  }
}

}  // namespace

// Launch plan: out3 = {grid, ks1, ks3}, the cooperative grid (blocks the
// card holds at once) and the K slices of the qkv and o matvecs.  Returns 0,
// a CUDA error code, or 1 for shapes it does not take.
extern "C" int decode_attn_layer_plan(int hd, int qkv_dp, int qkv_n2, int o_dp, int o_n2,
                                      int dblk, int* out3) {
  int smem = 0;
  void* k = kernel_for_hd(hd, &smem);
  if (k == nullptr || qkv_n2 % 16 != 0 || o_n2 % 16 != 0 || qkv_dp % dblk != 0 ||
      o_dp % dblk != 0)
    return 1;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, mm::kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = coop ? per_sm * sms : 0;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // as kernel G: a work item per SM in at most 16 slices
  const int ks1 = mm::pick_slice(dblk, qkv_dp, (qkv_n2 + mm::kCols - 1) / mm::kCols, sms, 16);
  const int ks3 = mm::pick_slice(dblk, o_dp, (o_n2 + mm::kCols - 1) / mm::kCols, sms, 16);
  if (ks1 < 1 || ks3 < 1) return 1;
  out3[0] = grid;
  out3[1] = ks1;
  out3[2] = ks3;
  return 0;
}

// Kernel H; see the header comment.  cache_k/v: [L, n_cache, tmax, D] bf16
// (row 0 read); mask: [tmax] bytes, 0 past t_scan's live rows and at the
// write slot; the attention runs heads * nsplit work items of tps tiles of
// 64 cache rows; y: f32 scratch [3D]; ctx: bf16 scratch [D]; ws1: f32
// [qkv_dp/ks1, 1, 2*qkv_n2]; ws2: f32 [heads * nsplit, 2 + hd]; ws3: f32
// [o_dp/ks3, 1, 2*o_n2]; tickets: zeroed uint32 [ceil(qkv_n2/128) +
// ceil(o_n2/128) + heads], left zeroed.  Returns cudaGetLastError().
extern "C" int decode_attn_layer(const void* x, int D, const float* ln_w, float eps,
                                 const int8_t* qkv_q4, const float* qkv_slo,
                                 const float* qkv_shi, int qkv_dp, int qkv_n2,
                                 const int8_t* o_q4, const float* o_slo, const float* o_shi,
                                 int o_dp, int o_n2, int dblk, int grid, int ks1, int ks3,
                                 const float* cos_t, const float* sin_t, const void* cache_k,
                                 const void* cache_v, int n_cache, int tmax, int li,
                                 const uint8_t* mask, int t_scan, int heads, int hd,
                                 float scale, int nsplit, int tps, float* y, void* ctx,
                                 void* out, void* k_new, void* v_new, float* ws1, float* ws2,
                                 float* ws3, unsigned int* tickets, void* stream) {
  int smem = 0;
  void* k = kernel_for_hd(hd, &smem);
  const int ntiles = (t_scan + da::kTile - 1) / da::kTile;
  if (k == nullptr || heads * hd != D || 2 * qkv_n2 != 3 * D || 2 * o_n2 != D ||
      !mm::takes(qkv_q4, qkv_n2, ks1) || !mm::takes(o_q4, o_n2, ks3) || nsplit < 1 ||
      nsplit > da::kMaxSplits || (long)nsplit * tps < ntiles || t_scan < 0 || t_scan > tmax)
    return 1;
  const int tiles = (qkv_n2 + mm::kCols - 1) / mm::kCols + (o_n2 + mm::kCols - 1) / mm::kCols;
  Params p{reinterpret_cast<const __nv_bfloat16*>(x), D, ln_w, eps, qkv_slo, qkv_shi, qkv_dp,
           qkv_n2, o_slo, o_shi, o_dp, o_n2, dblk, ks1, ks3,
           da::Args{y, D, cos_t, sin_t, 0, mask, 0, t_scan, 1, 1, heads, nsplit, tps, scale,
                    reinterpret_cast<__nv_bfloat16*>(ctx),
                    reinterpret_cast<__nv_bfloat16*>(k_new),
                    reinterpret_cast<__nv_bfloat16*>(v_new), ws2, tickets + tiles},
           y, reinterpret_cast<__nv_bfloat16*>(out), ws1, ws3, tickets, {}, {}, {}, {}};
  const long layer = (long)li * n_cache * tmax * D * 2;
  int rc = mm::weight_map(&p.qkv_map, qkv_q4, qkv_dp, qkv_n2);
  if (rc == 0) rc = mm::weight_map(&p.o_map, o_q4, o_dp, o_n2);
  if (rc == 0)
    rc = da::cache_map(&p.k_map, static_cast<const char*>(cache_k) + layer, D, tmax, n_cache,
                       t_scan);
  if (rc == 0)
    rc = da::cache_map(&p.v_map, static_cast<const char*>(cache_v) + layer, D, tmax, n_cache,
                       t_scan);
  if (rc != 0) return rc;
  void* args[] = {&p};
  cudaLaunchCooperativeKernel(k, dim3(grid), dim3(mm::kThreads), args, smem,
                              reinterpret_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
