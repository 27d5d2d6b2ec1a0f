// Kernel B: decode-step attention for Hopper (sm_90a): RoPE + attention
// over the cache rows of the live prefix with the in-flight rows of a group
// folded in, on the tensor cores, split along the sequence.
//
// Together with int4_matvec.cu this replaces the TPU kernel
// dynam3d_tpu/ops/pallas_decode.py::decode_layer_ring (_decode_ring_kernel):
// the layer runs as int4_matvec (rmsnorm + qkv) -> decode_attn -> int4_matvec
// (o + residual) -> int4_matvec (rmsnorm + gate_up + SwiGLU) -> int4_matvec
// (down + residual).
//
// Inputs: qkv [rows, 3D] f32 (the qkv matvec output, q | k | v), cos/sin
// [rows, hd/2] f32, the flat bf16 caches [L, Bc, Tmax, D], a per-row byte mask
// [rows, Tmax] (row stride 0 broadcasts one mask), the scan length t_scan and
// the group size.  Row r belongs to group r / group, attends cache row
// r / group and folds the new k/v of rows g0..r (g0 = first row of its group)
// after the cache: group = 1 is the plain mode (each row folds only itself),
// group = rows is the shared-cache verify mode (k drafts of one sequence),
// anything between is the grouped mode.  Outputs: ctx [rows, D] bf16 and the
// roped k_new / v_new [rows, D] bf16 for the caller's cache write.
//
// Bound: the live cache rows of each (head, group) are read once (2 *
// t_scan * hd * 2 bytes per head and group), about 4 * group operations per
// cache byte, so bytes bound it.  Design (decode_attn.cuh): a block per work
// item (head, cache group, sequence split), a producer warp streaming [64,
// hd] K and V tiles by TMA into a two-slot ring, four consumer warps scoring
// all rows of the group at once on mma.sync with P split hi/lo, and the
// (head, group)'s last block merging the splits in order.  One block per SM
// (the plan keeps the items to one per SM): the body then holds its state
// in registers without spilling at hd 96, which two blocks per SM did not
// allow (168 registers, 68 B of spills, 13% slower at k = 8).  The first
// design ran a block per (row, head) on the CUDA cores, each thread owning
// whole cache rows, so the 8 rows of shared-cache verify each streamed the
// same slice: 0.0444 ms at k = 8 (chip_smoke.py on an NVIDIA H100 80GB HBM3
// at 700 W; PERF.md section 6).

#include "decode_attn.cuh"

namespace da = d3attn;

namespace {

struct Params {
  da::Args a;
  CUtensorMap k_map;   // the layer's caches [Bc, t_scan, D]
  CUtensorMap v_map;
};

template <int HD>
__global__ void __launch_bounds__(da::kThreads, 1) decode_attn_kernel(
    const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  const uint32_t a0 = d3sm90::smem_u32(smem_dyn);
  unsigned char* base = smem_dyn + (((a0 + da::kAlign - 1) & ~(uint32_t)(da::kAlign - 1)) - a0);
  const da::Smem s = da::smem_at<HD, da::kMaxRows>(base);
  const int items = p.a.heads * p.a.groups * p.a.nsplit;
  if (threadIdx.x == 0) da::ring_init(s);
  __syncthreads();
  if (threadIdx.x >= da::kConsumers) {   // the producer warp
    da::produce_tiles<HD>(s, p.a, &p.k_map, &p.v_map, items, 0, da::block_tiles(p.a, items));
    return;
  }
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x)
    da::consume_item<HD, da::kMaxRows>(s, p.a, item, it);
}

template <int HD>
constexpr int smem_bytes() {
  return da::kAlign + da::Layout<HD, da::kMaxRows>::kBytes;
}

// The kernel at head dim hd with its shared-memory opt-in raised (once per
// process), or nullptr for a head dim it does not take
template <int HD>
void* prepared() {
  static const cudaError_t e = cudaFuncSetAttribute(
      decode_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<HD>());
  return e == cudaSuccess ? reinterpret_cast<void*>(decode_attn_kernel<HD>) : nullptr;
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

// out2 = {SMs, blocks of the kernel an SM holds} at head dim hd, from which
// the caller splits the sequence (ops/decode.py: attn_plan).  Returns 0, a
// CUDA error code, or 1 for a head dim it does not take.
extern "C" int decode_attn_occupancy(int hd, int* out2) {
  int smem = 0;
  void* k = kernel_for_hd(hd, &smem);
  if (k == nullptr) return 1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&out2[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out2[1], k, da::kThreads, smem);
  return (int)e;
}

// Kernel B over heads * (rows / group) * nsplit work items, tps tiles of 64
// cache rows each (the last split may have fewer).  ws: f32 [items][16 +
// 8 * hd]; tickets: zeroed uint32 [heads * rows / group], left zeroed.
// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue)
// for arguments it does not take.
extern "C" int decode_attn(const float* qkv, int rows, int D, int heads, int hd,
                           const float* cos_t, const float* sin_t, int cs_stride,
                           const void* cache_k, const void* cache_v, int n_cache,
                           int tmax, int li, const uint8_t* mask, int mask_stride,
                           int t_scan, int group, float scale, void* ctx,
                           void* k_new, void* v_new, int nsplit, int tps, float* ws,
                           unsigned int* tickets, void* stream) {
  const int ntiles = (t_scan + da::kTile - 1) / da::kTile;
  if (rows < 1 || rows > da::kMaxRows || group < 1 || rows % group != 0 ||
      rows / group > n_cache || heads * hd != D || nsplit < 1 || nsplit > da::kMaxSplits ||
      t_scan < 0 || t_scan > tmax || (long)nsplit * tps < ntiles || D % 8 != 0)
    return 1;
  int smem = 0;
  void* k = kernel_for_hd(hd, &smem);
  if (k == nullptr) return 1;
  Params p{da::Args{qkv, D, cos_t, sin_t, cs_stride, mask, mask_stride, t_scan, group,
                    rows / group, heads, nsplit, tps, scale,
                    reinterpret_cast<__nv_bfloat16*>(ctx), reinterpret_cast<__nv_bfloat16*>(k_new),
                    reinterpret_cast<__nv_bfloat16*>(v_new), ws, tickets},
           {}, {}};
  const long layer = (long)li * n_cache * tmax * D * 2;
  int rc = da::cache_map(&p.k_map, static_cast<const char*>(cache_k) + layer, D, tmax, n_cache,
                         t_scan);
  if (rc == 0)
    rc = da::cache_map(&p.v_map, static_cast<const char*>(cache_v) + layer, D, tmax, n_cache,
                       t_scan);
  if (rc != 0) return rc;
  void* args[] = {&p};
  cudaLaunchKernel(k, dim3(heads * (rows / group) * nsplit), dim3(da::kThreads), args, smem,
                   reinterpret_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
