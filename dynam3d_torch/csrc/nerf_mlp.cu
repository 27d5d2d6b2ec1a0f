// Kernel C: the fused NeRF MLP of the feature-field renderer for Hopper
// (sm_90a), on wgmma fed by a TMA weight ring.
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
// Bound: 2*N*D*(6D+1) operations against ~7 MB of bf16 weights and 6*N*D
// bytes of activations (f32 in, bf16 out); at the renderer's N = 1152 rows
// of one novel view, D = 768, the six products are 8.16 GFLOP: 8.2 us at the
// bf16 tensor-core peak, so operations bound it.
//
// Design (the shape of a fast Hopper kernel: a TMA ring, a producer
// warpgroup, consumer warpgroups on wgmma with both operands in shared
// memory; setmaxnreg moves registers from the producer to the consumers):
//   * a cluster of CL = D / BN blocks owns kRows = 64 rows (one m64 wgmma
//     tile) and runs the whole chain; block `rank` computes output columns
//     rank*BN .. +BN of every layer, so it streams only that slice of each
//     weight (BN = 192 where D % 192 == 0, else 128: D = 768 runs clusters of
//     four);
//   * the weights come pre-transposed, [6D, D] bf16 (row o*D + j = column j
//     of layer o: K-major, as wgmma reads B), made by nerf_mlp_weights_kernel
//     once per weight version and cached by the wrapper; one lane of the
//     producer warpgroup copies [BN, 64] K-tiles of the block's rows with one
//     TMA box each (128-byte swizzle) into a ring of kStages slots with a
//     full and an empty mbarrier each, in one flat sequence over the six
//     layers, so the next layer's first tiles land during an epilogue and
//     its exchange;
//   * every block keeps the whole [64, D] bf16 activation tile in shared
//     memory as D/64 K-blocks of [64, 64] in the canonical K-major layout of
//     the 128-byte swizzle (16-byte chunk j of row r at j ^ (r % 8)), so
//     both wgmma operands are matrix descriptors (start address, stride
//     byte offset 1024 between 8-row atoms, swizzle mode): no fragment
//     passes through registers on the way in;
//   * two consumer warpgroups share the A tile and split the block's
//     columns (m64n96k16 at BN = 192: 48 accumulator registers a thread);
//     per K-tile each issues four wgmma, commits them as one group and keeps
//     it in flight (wgmma.wait_group 1) while the next tile lands, releasing
//     the slot of the group before;
//   * after a layer each block writes its bf16 epilogue (LeakyReLU; the
//     residual bf16(x), which each thread reads from the staged input tile
//     at its accumulator positions and keeps in registers until the EO
//     layer) straight into the swizzled activation tile of every block of
//     the cluster (distributed shared memory), one 16-byte chunk a lane
//     after a 4 x 4 transpose of the accumulator words over each quad of
//     lanes, between two cluster-wide mbarrier phases: act_free (every block
//     is done reading its tile; arrived on remotely as soon as its last
//     wgmma retires) and act_full (every block has written its columns).
//     One tile only: two [64, 768] tiles and four [192, 64] slots would need
//     288 KB of the 227 KB a block may use, so both phases stay;
//   * the density column is a warp reduction in f32 of the EO layer's bf16
//     input against EO's last column, rows dealt over the cluster.
// At D = 768 a block holds 96 KB of activations and 96 KB of ring: one
// block per SM, and N = 1152 needs 18 clusters of four (72 SMs) where the
// card runs 30 at once (nerf_mlp_max_clusters): one wave.  Clusters of six
// 128-column blocks would need 108 SMs in groups of six inside the GPCs;
// the first design's 185 KB blocks fit only 17 such clusters at once.
//
// Measured (chip_smoke.py and tools/decompose_nerf_mlp.py on an NVIDIA H100
// 80GB HBM3 at 700 W; PERF.md section 6): N = 1152 in 0.067 ms with cached
// weights and 0.088 ms on a new weight version, against 0.094 ms for the
// same chain as six bf16 torch.matmul calls; 168 registers at entry, no
// spills.  Without its wgmma, without the exchange or without the weight
// stream it takes 6-13% less each: what remains is each block's serial
// chain of six layers (staging, a cluster exchange per layer), 8x the
// operations bound.  The first design (WMMA fragments loaded from shared
// memory into registers for every 16-deep step by each of eight warps, a
// 3-stage cp.async ring behind a __syncthreads per K-tile, 80-row clusters
// of six) took 0.1683 ms; one consumer warpgroup on m64n192k16 spilled at
// 254 registers (0.135 ms).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace d3sm90;

constexpr int kRows = 64;                     // rows of a cluster: one m64 wgmma tile
constexpr int kBK = 64;                       // K of a weight tile and of an activation K-block
constexpr int kKStep = 16;                    // K of one wgmma
constexpr int kConsumerGroups = 2;            // consumer warpgroups, each on half the columns
constexpr int kConsumers = 128 * kConsumerGroups;
constexpr int kThreads = kConsumers + 128;    // + a producer warpgroup (one lane issues)
constexpr int kProducerRegs = 40;             // setmaxnreg: the producer gives registers up
constexpr int kConsumerRegs = 232;            // and the consumers take them
constexpr int kStages = 4;                    // weight ring slots
constexpr int kLayers = 6;
constexpr int kRowBytes = 128;                // a swizzled row: kBK bf16
constexpr int kAtomBytes = 1024;              // 8 rows of the 128-byte swizzle
constexpr int kKBlockBytes = kRows * kRowBytes;   // one [64, 64] K-block of the activation tile
constexpr int kSbo = 1024;                    // descriptor: stride byte offset (8-row atom to the next)
constexpr int kLbo = 16;                      // descriptor: leading byte offset (unused when swizzled)
constexpr int kSwizzle128 = 1;                // descriptor layout type: 128-byte swizzle
constexpr int kMaxSmem = 232448;              // bytes of shared memory a block may use

// output columns of one block at width D
__host__ __device__ constexpr int cols_of(int D) { return D % 192 == 0 ? 192 : 128; }

// dynamic shared memory: alignment slack, activation tile, ring, barriers
__host__ __device__ constexpr int smem_bytes(int D) {
  return kAtomBytes + kRows * D * 2 + kStages * cols_of(D) * kRowBytes + (2 * kStages + 2) * 8;
}

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.01f * v; }

// Byte offset of element (r, k) in a K-major tile of K-blocks of
// `block_bytes`, each [rows, kBK] bf16 with the 128-byte swizzle
__device__ __forceinline__ uint32_t sw128(int r, int k, int block_bytes) {
  return (uint32_t)((k / kBK) * block_bytes + r * kRowBytes +
                    ((((k % kBK) >> 3) ^ (r & 7)) << 4) + (k & 7) * 2);
}

// wgmma matrix descriptor of a K-major operand at shared address saddr
// (a 1024-byte aligned atom plus a K offset of 32-byte steps inside it)
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(kLbo >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32) | ((uint64_t)kSwizzle128 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// order generic-proxy shared memory writes with the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// wgmma m64n64k16, bf16 A and B from shared memory (K-major), f32 D in
// 32 registers a thread; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// wgmma m64n96k16, bf16 A and B from shared memory (K-major), f32 D in
// 48 registers a thread; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Pins the accumulators at this point of the instruction stream: reads of
// them cannot move above a preceding wgmma.wait_group
template <int R>
__device__ __forceinline__ void acc_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int WN>
__device__ __forceinline__ void wgmma_tile(float (&d)[WN / 2], uint64_t a, uint64_t b,
                                           int scale_d) {
  if constexpr (WN == 96) wgmma_n96(d, a, b, scale_d);
  else wgmma_n64(d, a, b, scale_d);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// 4 x 4 transpose of 32-bit words over the four lanes of a quad (q = lane
// % 4): lane q holds a[i], its two columns of n8 block i; it gets back the
// 16-byte chunk of n8 block q, word i from lane i.  Lane s sends a[s ^ r] to
// lane s ^ r in round r.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&a)[4], int q) {
  uint32_t b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = a[i];   // b[q] = a[q]; the rest is replaced
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    const uint32_t got = __shfl_xor_sync(0xffffffffu, pick4(a, q ^ r), r);
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = i == (q ^ r) ? got : b[i];
  }
  return make_uint4(b[0], b[1], b[2], b[3]);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 8 elements of x at i (i % 8 == 0) as bf16
__device__ __forceinline__ uint4 load8(const void* x, int x_f32, long i) {
  if (!x_f32) return __ldg(reinterpret_cast<const uint4*>(x) + i / 8);
  const float4 a = __ldg(reinterpret_cast<const float4*>(x) + i / 4);
  const float4 b = __ldg(reinterpret_cast<const float4*>(x) + i / 4 + 1);
  return make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                    pack_bf16x2(b.z, b.w));
}

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t ua[4] = {a.x, a.y, a.z, a.w}, ub[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s += __uint_as_float(ua[j] << 16) * __uint_as_float(ub[j] << 16);
    s += __uint_as_float(ua[j] & 0xFFFF0000u) * __uint_as_float(ub[j] & 0xFFFF0000u);
  }
  return s;
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Params {
  const void* x;                    // [n, D] f32 (x_f32) or bf16
  int n, x_f32;
  const __nv_bfloat16* eo_col;      // [D]: EO's density column
  __nv_bfloat16* out;               // [n, D]
  __nv_bfloat16* density;           // [n]
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
nerf_mlp_kernel(const __grid_constant__ CUtensorMap wmap, Params p) {
  constexpr int BN = cols_of(D), CL = D / BN, KB = D / kBK, T = kLayers * KB;
  constexpr int WN = BN / kConsumerGroups;        // columns of one consumer warpgroup
  constexpr int NJ = WN / 8;                      // its n8 column groups
  constexpr int kSlotBytes = BN * kRowBytes;
  static_assert(NJ % 4 == 0, "the exchange moves 16-byte chunks of four n8 groups");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / CL) * kRows;
  const int c0 = rank * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* act = smem_raw + (((raw + kAtomBytes - 1) & ~(uint32_t)(kAtomBytes - 1)) - raw);
  unsigned char* ring = act + KB * kKBlockBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kSlotBytes);
  uint64_t* empty = full + kStages;
  uint64_t* act_free = empty + kStages;   // CL arrivals: every block is done reading its tile
  uint64_t* act_full = act_free + 1;      // CL arrivals: every block wrote its columns here

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(act_free, CL);
    mbar_init(act_full, CL);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync_all();   // every block's barriers exist before any remote arrive

  if (tid >= kConsumers) {
    // ---- producer warpgroup: one lane streams the block's weight K-tiles
    // of all six layers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      for (int t = 0; t < T; ++t) {
        const int slot = t % kStages;
        if (t >= kStages) mbar_wait(&empty[slot], (uint32_t)((t / kStages - 1) & 1));
        mbar_expect_tx(&full[slot], (uint32_t)kSlotBytes);
        tma_box(ring + slot * kSlotBytes, &wmap, (t % KB) * kBK, (t / KB) * D + c0, &full[slot]);
      }
    }
    __syncwarp();
    cluster_sync_all();
    return;
  }

  // ---- two consumer warpgroups: warpgroup g owns columns g*WN .. +WN ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // the bf16 input rows into the swizzled tile (zero past n), 16 bytes a
  // chunk, kBatch chunks' loads in flight a thread
  constexpr int kChunks = kRows * (D / 8) / kConsumers, kBatch = 12;
#pragma unroll 1
  for (int b0 = 0; b0 < kChunks; b0 += kBatch) {
    uint4 v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = tid + (b0 + i) * kConsumers, r = e / (D / 8), k = (e % (D / 8)) * 8;
      v[i] = make_uint4(0, 0, 0, 0);
      if (b0 + i < kChunks && row0 + r < p.n) v[i] = load8(p.x, p.x_f32, (long)(row0 + r) * D + k);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = tid + (b0 + i) * kConsumers, r = e / (D / 8), k = (e % (D / 8)) * 8;
      if (b0 + i < kChunks) *reinterpret_cast<uint4*>(act + sw128(r, k, kKBlockBytes)) = v[i];
    }
  }
  fence_proxy_async();
  consumer_sync();

  // accumulator register i of a thread: row rA + 8 * ((i / 2) % 2), column
  // cw + 8 * (i / 4) + 2 * q + i % 2 of the block's BN
  const int cw = (tid / 128) * WN;
  const int rA = 16 * (warp % 4) + lane / 4, q = lane % 4;
  // the residual bf16(x) at the thread's accumulator positions, from the
  // staged tile, kept for the EO layer's epilogue: [2j + h] = row rA + 8h,
  // columns cw + 8j + 2q, +1
  uint32_t res[2 * NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      res[2 * j + h] = *reinterpret_cast<const uint32_t*>(
          act + sw128(rA + 8 * h, c0 + cw + 8 * j + 2 * q, kKBlockBytes));
  const uint32_t act_s = smem_u32(act), b_s = smem_u32(ring) + cw * kRowBytes;
  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;

  int t = 0;
#pragma unroll 1
  for (int layer = 0; layer < kLayers; ++layer) {
    if (layer > 0) {   // every block's columns of this layer's input have landed
      mbar_wait_cluster(act_full, (uint32_t)((layer - 1) & 1));
      fence_proxy_async();
    }
#pragma unroll 1
    for (int kt = 0; kt < KB; ++kt, ++t) {
      const int slot = t % kStages;
      mbar_wait(&full[slot], (uint32_t)((t / kStages) & 1));
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / kKStep; ++k)
        wgmma_tile<WN>(acc, desc(act_s + kt * kKBlockBytes + k * 2 * kKStep),
                       desc(b_s + slot * kSlotBytes + k * 2 * kKStep), kt > 0 || k > 0);
      wgmma_commit();
      wgmma_wait<1>();   // the previous tile's group is done: release its slot
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % kStages]);
    }
    wgmma_wait<0>();
    acc_fence(acc);
    if (lane == 0) mbar_arrive(&empty[(t - 1) % kStages]);

    if (layer == kLayers - 1) {   // the output rows, straight to device memory
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + rA + 8 * h;
          if (r < p.n)
            *reinterpret_cast<uint32_t*>(p.out + (long)r * D + c0 + cw + 8 * j + 2 * q) =
                pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      break;
    }
    if (layer == 2) {   // density: the EO layer's input, still in the tile
      for (int r = rank + CL * warp; r < kRows; r += CL * (kConsumers / 32)) {
        float s = 0.f;
        for (int c = lane; c < D / 8; c += 32)
          s += dot8(*reinterpret_cast<const uint4*>(act + sw128(r, 8 * c, kKBlockBytes)),
                    __ldg(reinterpret_cast<const uint4*>(p.eo_col) + c));
#pragma unroll
        for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0 && row0 + r < p.n) p.density[row0 + r] = __float2bfloat16(leaky(s));
      }
    }
    consumer_sync();   // every read of this block's tile is done
    if (tid < CL) mbar_arrive_remote(act_free, (uint32_t)tid);
    unsigned char* tiles[CL];
#pragma unroll
    for (int dst = 0; dst < CL; ++dst) tiles[dst] = cluster.map_shared_rank(act, dst);
    mbar_wait_cluster(act_free, (uint32_t)(layer & 1));

    // the epilogue into every block's tile: bf16x2 words of four n8 groups,
    // transposed over the quad so that each lane stores one 16-byte chunk
    // (row rA + 8h, columns cw + 8 (4g + q) .. +8)
#pragma unroll
    for (int g = 0; g < NJ / 4; ++g) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * g + i;
          float v0 = leaky(acc[4 * j + 2 * h]), v1 = leaky(acc[4 * j + 2 * h + 1]);
          if (layer == 2) {   // residual: leaky(eo) + f32(bf16(x))
            v0 += __uint_as_float(res[2 * j + h] << 16);
            v1 += __uint_as_float(res[2 * j + h] & 0xFFFF0000u);
          }
          w4[i] = pack_bf16x2(v0, v1);
        }
        const uint4 chunk = quad_transpose(w4, q);
        const uint32_t off = sw128(rA + 8 * h, c0 + cw + 8 * (4 * g + q), kKBlockBytes);
#pragma unroll
        for (int dst = 0; dst < CL; ++dst) *reinterpret_cast<uint4*>(tiles[dst] + off) = chunk;
      }
    }
    fence_proxy_async();
    consumer_sync();   // every thread's writes are issued
    if (tid < CL) {
      asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
      mbar_arrive_remote(act_full, (uint32_t)tid);
    }
  }
  cluster_sync_all();   // no block leaves while another may still address it
}

// The kernel's weights from the six source weights (row-major [D, ld], f32
// or bf16; ld = D + 1 for EO): wt[o*D + j][k] = bf16(w_o[k][j]) for j, k <
// D, and eo_col[k] = bf16(EO[k][D]).  A block moves a 64 x 64 tile of layer
// blockIdx.z through shared memory: 128-byte row reads, then bf16x2 writes
// along the rows of wt.
struct Sources {
  const void* w[kLayers];
  int ld[kLayers];
};

__device__ __forceinline__ float load_weight(const void* w, int is_f32, long i) {
  return is_f32 ? reinterpret_cast<const float*>(w)[i]
                : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(w)[i]);
}

__global__ void __launch_bounds__(256) nerf_mlp_weights_kernel(Sources src, int D, int is_f32,
                                                               __nv_bfloat16* __restrict__ wt,
                                                               __nv_bfloat16* __restrict__ eo_col) {
  __shared__ float tile[64][65];
  const int o = blockIdx.z, k0 = blockIdx.y * 64, j0 = blockIdx.x * 64;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const void* w = src.w[o];
  const int ld = src.ld[o];
#pragma unroll
  for (int r = ty; r < 64; r += 8)     // source rows k0 + r, columns j0 .. j0 + 63
#pragma unroll
    for (int c = tx; c < 64; c += 32) tile[r][c] = load_weight(w, is_f32, (long)(k0 + r) * ld + j0 + c);
  __syncthreads();
#pragma unroll
  for (int j = ty; j < 64; j += 8) {   // wt row o*D + j0 + j, columns k0 + 2tx, +1
    const __nv_bfloat162 v = __floats2bfloat162_rn(tile[2 * tx][j], tile[2 * tx + 1][j]);
    *reinterpret_cast<__nv_bfloat162*>(wt + ((long)o * D + j0 + j) * D + k0 + 2 * tx) = v;
  }
  if (o == 2 && blockIdx.x == 0 && ty == 0)   // EO's density column
#pragma unroll
    for (int c = tx; c < 64; c += 32)
      eo_col[k0 + c] = __float2bfloat16(load_weight(w, is_f32, (long)(k0 + c) * ld + D));
}

template <int D>
int smem_optin() {
  static int rc = -1;
  if (rc < 0)
    rc = (int)cudaFuncSetAttribute(nerf_mlp_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes(D));
  return rc;
}

// The launch configuration: one cluster of D / BN blocks per kRows rows.
template <int D>
int configure(int n, cudaStream_t stream, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  static_assert(smem_bytes(D) <= kMaxSmem, "activation tile and weight ring exceed shared memory");
  static_assert(D / cols_of(D) <= 8, "a portable cluster holds at most 8 blocks");
  *cfg = {};
  cfg->gridDim = dim3(D / cols_of(D) * ((n + kRows - 1) / kRows));
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem_bytes(D);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = D / cols_of(D);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return smem_optin<D>();
}

template <int D>
int launch(const void* w, const Params& p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int rc = configure<D>(p.n, stream, &cfg, &attr);
  if (rc != 0) return rc;
  CUtensorMap map;
  rc = tensor_map_2d(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, (long)kLayers * D, D,
                     cols_of(D), kBK);
  if (rc != 0) return rc;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, nerf_mlp_kernel<D>, map, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int D>
int max_clusters(int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int rc = configure<D>(kRows, nullptr, &cfg, &attr);
  if (rc != 0) return rc;
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
//   x: [n, D] f32 (x_f32 = 1) or bf16, 16-byte aligned;
//   w: [6D, D] bf16, 16-byte aligned: the transposes of E1, E2, EO[:, :D],
//      D1, D2, DO stacked (row o*D + j holds column j of layer o);
//   eo_col: [D] bf16 (EO[:, D]), 16-byte aligned;
//   out: [n, D] bf16;  density: [n] bf16
extern "C" int nerf_mlp(const void* x, int x_f32, int n, int D, const void* w, const void* eo_col,
                        void* out, void* density, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return (int)cudaGetLastError();
  const Params p{x, n, x_f32, reinterpret_cast<const __nv_bfloat16*>(eo_col),
                 reinterpret_cast<__nv_bfloat16*>(out), reinterpret_cast<__nv_bfloat16*>(density)};
  return dispatch(D, [&](auto d) { return launch<decltype(d)::value>(w, p, stream); });
}

// Makes the kernel's weights (w and eo_col of nerf_mlp()) from E1, E2, EO,
// D1, D2, DO: row-major [D, D] ([D, D + 1] for EO), f32 (is_f32 = 1) or
// bf16.  Returns cudaGetLastError(); 1 for a D the kernel does not take.
extern "C" int nerf_mlp_weights(const void* e1, const void* e2, const void* eo, const void* d1,
                                const void* d2, const void* dout, int D, int is_f32, void* wt,
                                void* eo_col, void* stream_ptr) {
  if (D < 128 || D > 1024 || D % 128 != 0) return 1;
  const Sources src{{e1, e2, eo, d1, d2, dout}, {D, D, D + 1, D, D, D}};
  nerf_mlp_weights_kernel<<<dim3(D / 64, D / 64, kLayers), 256, 0,
                            reinterpret_cast<cudaStream_t>(stream_ptr)>>>(
      src, D, is_f32, reinterpret_cast<__nv_bfloat16*>(wt),
      reinterpret_cast<__nv_bfloat16*>(eo_col));
  return (int)cudaGetLastError();
}

// Rows one cluster owns.
extern "C" int nerf_mlp_rows() { return kRows; }

// Blocks of a cluster at width D (0 for a width the kernel does not take).
extern "C" int nerf_mlp_cluster_blocks(int D) {
  return D >= 128 && D <= 1024 && D % 128 == 0 ? D / cols_of(D) : 0;
}

// How many clusters of the width-D kernel the card runs at once, into
// *count.  Returns the CUDA error code.
extern "C" int nerf_mlp_max_clusters(int D, int* count) {
  return dispatch(D, [&](auto d) { return max_clusters<decltype(d)::value>(count); });
}
