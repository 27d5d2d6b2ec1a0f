// Fused NeRF MLP of the feature-field renderer for Hopper (sm_90a).
//
// Replaces the TPU kernel dynam3d_tpu/ops/pallas_mlp.py::fused_nerf_mlp
// (body _kernel): for a tile of rows,
//   h = bf16(x)
//   h = bf16(leaky(h @ E1)); h = bf16(leaky(h @ E2))            encoder hidden
//   eo = leaky(h @ EO)  (EO is [D, D+1]; its last column is the density)
//   h = bf16(eo[:, :D] + f32(bf16(x)))                             residual
//   h = bf16(leaky(h @ D1)); h = bf16(leaky(h @ D2))            decoder hidden
//   out = bf16(h @ DO); density = bf16(eo[:, D])
// with bf16 weights, f32 sums and LeakyReLU(0.01) in f32 -- the rounding
// points of the TPU kernel.
//
// Bound: 2*N*D*(6D+1) operations against ~7 MB of weights and 4*N*D bytes of
// activations; at the renderer's N = 1152 rows of one novel view the six
// products are ~8 GFLOP, so the tensor cores bound it (~8 us at the bf16
// peak).  What stands in the way is the weight stream: every row tile needs
// all six weights, and one SM alone cannot pull 7 MB from L2 fast enough.
// Design:
//   * a cluster of D/128 blocks owns 80 rows and runs the whole chain; each
//     block of the cluster computes 128 output columns of every layer, so
//     it streams only its 128-column slice of each weight (1/6 of the set
//     at D = 768) and the cluster shares one read of the weights among its
//     80 rows (N/80 reads of the set in all);
//   * every block keeps the whole [80, D] bf16 activation tile in shared
//     memory; after a layer each block writes its 128 columns into the
//     tile of every block of the cluster (distributed shared memory) between
//     two cluster barriers, so activations never touch device memory;
//   * weight K-tiles of [64, 128] bf16 stream through a 3-stage cp.async
//     ring (the most that fits beside an [80, 1024] tile) in one flat
//     sequence over the six layers, so the next layer's first tiles load
//     during an epilogue;
//   * eight warps split a block's [80, 128] output into 1 x 8 warp tiles of
//     [80, 16]: bf16 WMMA 16x16x16 with f32 accumulators;
//   * the density column is not a tensor-core tile: each row's dot with EO's
//     last column (passed separately, contiguous) is a warp reduction in f32
//     over the same bf16 h, rows dealt round-robin over the cluster;
//   * the residual reads bf16(x) back from device memory in its epilogue
//     instead of keeping a second tile in shared memory.
// Why 80 rows: a block needs ~185 KB of shared memory, so an SM holds one
// and the card only some 17 clusters of 6 at once (nerf_mlp_max_clusters);
// at N = 1152, 64-row clusters would need 18 and run a second wave for the
// last one, while 80-row ones need 15.  What bounds it now is the time one
// cluster takes for its six layers: WMMA products whose fragments all pass
// through registers from shared memory, then each layer's exchange and
// barriers.  wgmma (B read from shared memory by the tensor cores) is the
// next step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;
using namespace nvcuda;

constexpr int kRowTiles = 5;             // 16-row tiles of a cluster
constexpr int kRows = 16 * kRowTiles;    // rows of a cluster (every block holds all of them)
constexpr int kCols = 128;               // output columns of one block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// warps over a block's [kRows, kCols] output: kWR x kWC warp tiles of kFM x kFN fragments
constexpr int kWR = kRowTiles % 2 == 0 ? 2 : 1;
constexpr int kWC = kWarps / kWR;
constexpr int kFM = kRowTiles / kWR;
constexpr int kFN = kCols / kWC / 16;
constexpr int kBK = 64;                  // K rows of a weight tile
constexpr int kPad = 8;                  // bf16 elements of row padding in shared memory
constexpr int kLdb = kCols + kPad;
constexpr int kLayers = 6;
constexpr int kMaxSmem = 232448;         // bytes of shared memory a block may use

constexpr int kStages = 3;               // weight tiles in the cp.async ring

constexpr size_t smem_bytes(int D) {
  return (size_t)kRows * (D + kPad) * 2 + (size_t)kStages * kBK * kLdb * 2 + kWarps * 256 * 4;
}

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.01f * v; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

struct Weights {
  const __nv_bfloat16* w[kLayers];       // E1, E2, EO[:, :D], D1, D2, DO; each [D, D]
};

template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* stage, const Weights& ws, int t, int c0) {
  constexpr int KT = D / kBK;
  const __nv_bfloat16* src = ws.w[t / KT] + (long)(t % KT) * kBK * D + c0;
  constexpr int kChunks = kBK * kCols / 8;          // 16-byte chunks
#pragma unroll
  for (int e = threadIdx.x; e < kChunks; e += kThreads) {
    const int r = e / (kCols / 8), c = (e % (kCols / 8)) * 8;
    cp_async16(stage + r * kLdb + c, src + (long)r * D + c);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
nerf_mlp_kernel(const __nv_bfloat16* __restrict__ x, int n, Weights ws,
                const __nv_bfloat16* __restrict__ eo_col, __nv_bfloat16* __restrict__ out,
                __nv_bfloat16* __restrict__ density) {
  constexpr int CL = D / kCols;
  constexpr int lda = D + kPad;
  constexpr int KT = D / kBK;
  constexpr int T = kLayers * KT;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / CL) * kRows;
  const int c0 = rank * kCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = 16 * kFM * (warp / kWC), wn = 16 * kFN * (warp % kWC);  // warp tile origin

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wst = h + kRows * lda;
  float* scratch = reinterpret_cast<float*>(wst + kStages * kBK * kLdb) + warp * 256;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) load_tile<D>(wst + s * kBK * kLdb, ws, s, c0);
    cp_async_commit();
  }
  // stage the bf16 input tile (zero rows past n), 16 bytes a thread
  constexpr int kVec = D / 8;
  for (int e = threadIdx.x; e < kRows * kVec; e += kThreads) {
    const int r = e / kVec, c = (e % kVec) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < n) v = *reinterpret_cast<const uint4*>(x + (long)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(h + r * lda + c) = v;
  }

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[kFM];
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[kFN];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];

  for (int t = 0; t < T; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                     // tile t landed; every warp is done with tile t-1's stage
    if (t + kStages - 1 < T) load_tile<D>(wst + ((t + kStages - 1) % kStages) * kBK * kLdb, ws,
                                          t + kStages - 1, c0);
    cp_async_commit();
    const int layer = t / KT, kt = t % KT;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    }
    const __nv_bfloat16* B = wst + (t % kStages) * kBK * kLdb;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        wmma::load_matrix_sync(a[i], h + (wm + 16 * i) * lda + kt * kBK + kk, lda);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(b[j], B + kk * kLdb + wn + 16 * j, kLdb);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (kt != KT - 1) continue;

    // ---- epilogue of `layer`: accumulators complete for this block's columns
    if (layer == 2) {
      // density from the EO layer's input, still in h: rows dealt over the cluster
      for (int r = rank + CL * warp; r < kRows; r += CL * kWarps) {
        float s = 0.f;
        for (int k = lane; k < D; k += 32)
          s += __bfloat162float(h[r * lda + k]) * __bfloat162float(eo_col[k]);
#pragma unroll
        for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0 && row0 + r < n) density[row0 + r] = __float2bfloat16(leaky(s));
      }
    }
    if (layer < kLayers - 1) cluster.sync();   // every block of the cluster is done reading h
    const int er = lane / 2, ec = (lane % 2) * 8;  // a lane's 8 values of a 16x16 fragment
#pragma unroll
    for (int i = 0; i < kFM; ++i) {
#pragma unroll
      for (int j = 0; j < kFN; ++j) {
        wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int r = wm + 16 * i + er;
        const int col = c0 + wn + 16 * j + ec;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = scratch[er * 16 + ec + e];
        __syncwarp();
        if (layer == 2) {
          uint4 xv = make_uint4(0, 0, 0, 0);
          if (row0 + r < n) xv = *reinterpret_cast<const uint4*>(x + (long)(row0 + r) * D + col);
          const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(&xv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = leaky(v[e]) + __bfloat162float(xb[e]);
        } else if (layer < kLayers - 1) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = leaky(v[e]);
        }
        uint4 packed;
        __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e) pk[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        if (layer == kLayers - 1) {
          if (row0 + r < n) *reinterpret_cast<uint4*>(out + (long)(row0 + r) * D + col) = packed;
        } else {
#pragma unroll
          for (int q = 0; q < CL; ++q) {
            __nv_bfloat16* dst = cluster.map_shared_rank(h, q);
            *reinterpret_cast<uint4*>(dst + r * lda + col) = packed;
          }
        }
      }
    }
    if (layer < kLayers - 1) cluster.sync();   // the next layer's input is complete everywhere
  }
}

// Shared-memory opt-in and the launch configuration: one cluster of D/128
// blocks per kRows rows.
template <int D>
cudaError_t configure(int n, cudaStream_t stream, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  constexpr size_t smem = smem_bytes(D);
  static_assert(smem <= kMaxSmem, "activation tile and weight stages exceed shared memory");
  *cfg = {};
  cfg->gridDim = dim3(D / kCols * ((n + kRows - 1) / kRows));
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = D / kCols;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaFuncSetAttribute(nerf_mlp_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D>
int launch(const __nv_bfloat16* x, int n, const Weights& ws, const __nv_bfloat16* eo_col,
           __nv_bfloat16* out, __nv_bfloat16* density, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<D>(n, stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, nerf_mlp_kernel<D>, x, n, ws, eo_col, out, density);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int D>
int max_clusters(int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<D>(kRows, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(count, nerf_mlp_kernel<D>, &cfg);
}

// Calls f(std::integral_constant<int, D>) for a supported width D; 1
// (cudaErrorInvalidValue) otherwise.
template <typename F>
int dispatch(int D, F&& f) {
  switch (D) {
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 384: return f(std::integral_constant<int, 384>{});
    case 512: return f(std::integral_constant<int, 512>{});
    case 640: return f(std::integral_constant<int, 640>{});
    case 768: return f(std::integral_constant<int, 768>{});
    case 896: return f(std::integral_constant<int, 896>{});
    case 1024: return f(std::integral_constant<int, 1024>{});
    default: return 1;
  }
}

}  // namespace

// Launches the fused MLP.  Returns cudaGetLastError(); 1
// (cudaErrorInvalidValue) for a width D that is not 128..1024 in steps of 128.
//   x: [n, D] bf16;  w: six [D, D] bf16 (E1, E2, EO[:, :D], D1, D2, DO),
//   each 16-byte aligned;  eo_col: [D] bf16 (EO[:, D])
//   out: [n, D] bf16;  density: [n] bf16
extern "C" int nerf_mlp(const void* x, int n, int D, const void* e1, const void* e2,
                        const void* eo, const void* eo_col, const void* d1, const void* d2,
                        const void* dout, void* out, void* density, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return (int)cudaGetLastError();
  using B = const __nv_bfloat16*;
  const Weights ws = {{B(e1), B(e2), B(eo), B(d1), B(d2), B(dout)}};
  return dispatch(D, [&](auto d) {
    return launch<decltype(d)::value>(B(x), n, ws, B(eo_col), reinterpret_cast<__nv_bfloat16*>(out),
                                      reinterpret_cast<__nv_bfloat16*>(density), stream);
  });
}

// Rows one cluster of D/128 blocks owns.
extern "C" int nerf_mlp_rows() { return kRows; }

// How many clusters of the width-D kernel the card runs at once, into
// *count.  Returns the CUDA error code.
extern "C" int nerf_mlp_max_clusters(int D, int* count) {
  return dispatch(D, [&](auto d) { return max_clusters<decltype(d)::value>(count); });
}
