// The attention body of kernels B (decode_attn.cu) and H (decode_attn_layer.cu)
// for Hopper (sm_90a): the counterpart of the TPU's one attention body,
// _attn_block_update / _attn_block_update_shared
// (dynam3d_tpu/ops/pallas_decode.py), which scores every verify row of a
// group against one pass over the cache.
//
// Work item.  An item is (head h, cache group c, sequence split s): the
// cache rows of split s (tps tiles of kTile = 64 rows) of head h's slice of
// cache row c, for every query row of group c at once (1 in plain mode,
// `group` in grouped mode, all rows in shared-cache verify).  So each live
// cache row of a (head, group) is read from memory once per launch.  The
// caller picks the splits per (head, group) so that the items fill the card
// (ops/decode.py: attn_splits).
//
// Load path.  A producer warp (one lane) streams each tile's K and V
// [64, hd] bf16 into a ring of kStages slots by TMA: hd / 32 boxes of [64
// rows, 32 columns] per operand from a 3-D tensor map of the layer's cache
// [Bc, t_scan, D] (made per launch; rows past t_scan lie outside it and land
// as zeros).  A box row is 64 bytes under the 64-byte swizzle (16-byte
// chunk j of row r at chunk j ^ ((r / 2) % 4)), so the eight rows of an
// ldmatrix fall on distinct banks; hd * 2 = 192 bytes would not fit the
// 128-byte swizzle span.  Four consumer warps take 16 cache rows of each
// tile apiece and release the slot through its empty mbarrier.
//
// Math on mma.sync.m16n8k16 (bf16 in, f32 accumulate).  S = Q K^T puts the
// group's query rows on M (rows g < group real, rows 8..15 zero) and a
// warp's 16 cache rows on N (two n8 tiles); K in shared memory is the
// column-major B operand, read by plain ldmatrix.  q is rounded to bf16
// after RoPE and the cache is bf16, so the products are exact in f32: the
// scores kernel B formed on the CUDA cores.  Masked rows and rows past
// t_scan score -inf (p = 0) without a branch per row.  The online softmax
// runs in f32 on S's C fragment; a lane keeps a partial row sum.  ctx += P V
// reuses the C fragment as P's A fragment (registers (c0, c1) of n-tiles 0
// and 1 are a0 and a2), with V's B fragment from ldmatrix.trans.  P is split
// into bf16 hi and lo parts, P = P_hi + P_lo to about 2^-17 relative, and
// both are multiplied (two mma), which keeps the f32 numerics of the plain
// version (the TPU rounds P to bf16 once).
//
// Merge.  The four warps' states are merged in warp order; the item's
// partial (m, l, acc[rows][hd]) f32 goes to a workspace, and the block that
// takes the (head, group)'s last ticket merges the partials in split order
// (results do not depend on scheduling), folds the in-flight rows g0..r of
// each query row r in order after the cache, normalises, and writes ctx,
// k_new and v_new.  A split whose rows are all masked has m = -inf, l = 0
// and merges as a zero (every exp is taken against a finite maximum).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace d3attn {

using namespace d3sm90;

constexpr int kTile = 64;                       // cache rows per stage
constexpr int kBoxCols = 32;                    // bf16 columns per TMA box: 64 bytes
constexpr int kBoxBytes = kTile * kBoxCols * 2;
constexpr int kStages = 2;                      // ring slots (a tile of K and V each)
constexpr int kWarps = 4;                       // consumer warps: 16 cache rows of a tile each
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;       // + one producer warp
constexpr int kMaxRows = 8;                     // query rows of a group
constexpr int kMaxSplits = 32;
constexpr int kAlign = 1024;
// the decompose tool's switches (dynam3d_torch/tools/decompose_decode_attn.py)
constexpr bool kStream = true;
constexpr bool kMath = true;

// Shared memory of the body at head dim HD and R query rows, from a
// 1024-byte aligned base: the ring, its barriers, then the consumers' q and
// in-flight k / v, per-warp states, merge factors and fold coefficients.
template <int HD, int R>
struct Layout {
  static constexpr int kBoxes = HD / kBoxCols;              // boxes per operand
  static constexpr int kOperand = kBoxes * kBoxBytes;       // [64, HD] bf16
  static constexpr int kStage = 2 * kOperand;               // K, then V
  static constexpr int kBars = kStages * kStage;
  static constexpr int kQ = kBars + 2 * kStages * 8;        // bf16 [R][HD]
  static constexpr int kKv = kQ + R * HD * 2;               // f32 [R][HD] k, then v
  static constexpr int kWm = kKv + 2 * R * HD * 4;          // f32 [kWarps][R] m, l, factor
  static constexpr int kWacc = kWm + 3 * kWarps * R * 4;    // f32 [kWarps][R][HD]
  static constexpr int kFs = kWacc + kWarps * R * HD * 4;   // f32 [kMaxSplits][R]
  static constexpr int kFold = kFs + kMaxSplits * R * 4;    // f32 [R][R] score, alpha, p
  static constexpr int kRowL = kFold + 3 * R * R * 4;       // f32 [R]
  static constexpr int kFlag = kRowL + R * 4;               // int
  static constexpr int kBytes = kFlag + 16;
};

// The body's arguments.  Query row j (of rows = groups * group) belongs to
// group c = j / group and reads cache row c; qkv [rows, 3D] f32 is q | k | v.
struct Args {
  const float* qkv;
  int D;
  const float* cos_t;          // [rows, hd/2] (row stride cs_stride, 0 broadcasts)
  const float* sin_t;
  int cs_stride;
  const uint8_t* mask;         // [rows, >= t_scan] (row stride mask_stride, 0 broadcasts)
  int mask_stride;
  int t_scan, group, groups, heads, nsplit, tps;
  float scale;
  __nv_bfloat16* ctx;          // [rows, D]
  __nv_bfloat16* k_new;        // [rows, D]
  __nv_bfloat16* v_new;
  float* ws;                   // partials [heads * groups * nsplit][2R + R*HD]
  unsigned int* tickets;       // [heads * groups], zeroed; left zeroed
};

struct Smem {
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  __nv_bfloat16* q;    // the group's q, roped, bf16 [R][HD]
  float* kf;           // its k (roped) and v, rounded to bf16, f32 [R][HD]
  float* vf;
  float* wm;           // per warp and row: m, l, merge factor
  float* wl;
  float* wf;
  float* wacc;         // per warp: acc [R][HD]
  float* fs;           // per split and row: merge factor
  float* fold;         // per row r and in-flight row j <= r: score, alpha, p
  float* fal;
  float* fpf;
  float* row_l;        // per row: the sum after the fold
  int* flag;
};

template <int HD, int R>
__device__ __forceinline__ Smem smem_at(unsigned char* base) {
  using L = Layout<HD, R>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBars);
  float* kv = reinterpret_cast<float*>(base + L::kKv);
  float* wm = reinterpret_cast<float*>(base + L::kWm);
  float* fold = reinterpret_cast<float*>(base + L::kFold);
  return Smem{base, bars, bars + kStages, reinterpret_cast<__nv_bfloat16*>(base + L::kQ), kv,
              kv + R * HD, wm, wm + kWarps * R, wm + 2 * kWarps * R,
              reinterpret_cast<float*>(base + L::kWacc), reinterpret_cast<float*>(base + L::kFs),
              fold, fold + R * R, fold + 2 * R * R, reinterpret_cast<float*>(base + L::kRowL),
              reinterpret_cast<int*>(base + L::kFlag)};
}

// Tensor map of one layer's cache [planes, t_scan, D] bf16 (row pitch D,
// plane pitch tmax * D) in [kTile, kBoxCols] boxes, 64-byte swizzle; rows
// past t_scan read as zero.  0 or a CUDA error code.
inline int cache_map(CUtensorMap* map, const void* layer, int D, int tmax, int planes,
                     int t_scan) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)(t_scan > 0 ? t_scan : 1),
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)tmax * D * 2};
  const cuuint32_t box[3] = {kBoxCols, kTile, 1};
  const cuuint32_t estrides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(layer), dims,
                        strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ void tma_box3(void* dst, const CUtensorMap* map, int x, int y, int z,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
        "r"(smem_u32(bar))
      : "memory");
}

// barrier of the consumer warps only (the producer warp runs ahead)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// thread 0; the block syncs after it
__device__ __forceinline__ void ring_init(const Smem& s) {
  for (int i = 0; i < kStages; ++i) {
    mbar_init(&s.full[i], 1);
    mbar_init(&s.empty[i], kWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Byte offset of element (row r, column c), c % 8 == 0, in an operand tile:
// box c / 32, 64-byte rows, chunk (c / 8) % 4 swizzled by (r / 2) % 4
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 5) * kBoxBytes + r * 64 + ((((c >> 3) & 3) ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t d[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t d[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p0, p1 (k columns 2t, 2t+1) -> the bf16x2 hi part and the bf16x2 rest
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = bf16x2(p0 - __low2float(h), p1 - __high2float(h));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The mask bytes of the lane's four scores in `tile` (row g of the group,
// cache rows tile * 64 + 16 * warp + 2 * tq + {0, 1, 8, 9}); 0 for rows
// past t_scan and for padding rows g >= nrows.  Kept as loaded bytes, so a
// load issued a tile ahead stays in flight until the tile is scored.
__device__ __forceinline__ void mask_bytes(const uint8_t* mrow, bool on, int tile, int t_scan,
                                           uint32_t mb[4]) {
  const int tt0 = tile * kTile + 16 * ((int)threadIdx.x >> 5) + 2 * ((int)threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tt = tt0 + 8 * (i >> 1) + (i & 1);
    mb[i] = on && tt < t_scan ? (uint32_t)mrow[tt] : 0u;
  }
}

struct Item {
  int h, c, hc, t0, t1;   // head, cache group, head * groups + c, tiles [t0, t1)
};

__device__ __forceinline__ Item item_at(const Args& a, int item) {
  const int hc = item / a.nsplit, split = item - hc * a.nsplit;
  const int ntiles = (a.t_scan + kTile - 1) / kTile;
  const int t0 = min(split * a.tps, ntiles);
  return Item{hc / a.groups, hc % a.groups, hc, t0, min(t0 + a.tps, ntiles)};
}

// Producer warp: ring stage `it` <- the K and V tiles of cache rows
// row .. row + 63, columns col .. col + HD of cache plane `plane`
template <int HD>
__device__ __forceinline__ void produce(const Smem& s, int it, const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, int col, int row, int plane) {
  using L = Layout<HD, 1>;
  const int slot = it % kStages;
  if (it >= kStages) mbar_wait(&s.empty[slot], (uint32_t)((it / kStages - 1) & 1));
  if ((threadIdx.x & 31) == 0) {
    if constexpr (kStream) {
      mbar_expect_tx(&s.full[slot], (uint32_t)L::kStage);
      // order the consumers' generic reads of the slot before the async write
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      unsigned char* st = s.ring + slot * L::kStage;
      for (int b = 0; b < L::kBoxes; ++b) {
        tma_box3(st + b * kBoxBytes, kmap, col + b * kBoxCols, row, plane, &s.full[slot]);
        tma_box3(st + L::kOperand + b * kBoxBytes, vmap, col + b * kBoxCols, row, plane,
                 &s.full[slot]);
      }
    } else {
      mbar_arrive(&s.full[slot]);
    }
  }
  __syncwarp();
}

// The tiles of this block's items (item = blockIdx.x + i * gridDim.x <
// items), numbered in order from 0: the producer warp streams those
// numbered j0 .. j1 - 1.  block_tiles() counts them.
template <int HD>
__device__ __forceinline__ void produce_tiles(const Smem& s, const Args& a,
                                              const CUtensorMap* kmap, const CUtensorMap* vmap,
                                              int items, int j0, int j1) {
  int j = 0;
  for (int item = blockIdx.x; item < items && j < j1; item += gridDim.x) {
    const Item t = item_at(a, item);
    for (int tile = t.t0; tile < t.t1 && j < j1; ++tile, ++j)
      if (j >= j0) produce<HD>(s, j, kmap, vmap, t.h * HD, tile * kTile, t.c);
  }
}

__device__ __forceinline__ int block_tiles(const Args& a, int items) {
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item t = item_at(a, item);
    n += t.t1 - t.t0;
  }
  return n;
}

// Consumer warps: one work item, its tiles taken from ring stages it, it +
// 1, ...; the block that completes a (head, group) writes its ctx, k_new
// and v_new.  Loads that do not depend on each other are issued together
// (the RoPE inputs, the partials of up to kBatch splits), so each step of
// the item's critical path costs one memory round trip.
template <int HD, int R>
__device__ __forceinline__ void consume_item(const Smem& s, const Args& a, int item, int& it) {
  using L = Layout<HD, R>;
  constexpr int PS = 2 * R + R * HD;                          // floats per partial
  constexpr int KE = (R * HD + kConsumers - 1) / kConsumers;  // (row, column) elements a thread
  constexpr int kBatch = 4;                                   // splits whose loads fly at once
  constexpr int half = HD / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tq = lane & 3;
  const Item t = item_at(a, item);
  const int nrows = a.group, row0 = t.c * a.group, D = a.D, h = t.h, n = nrows * HD;

  consumer_sync();   // the previous item's reads of the scratch are done
  const uint8_t* mrow = a.mask + (long)(row0 + min(g, nrows - 1)) * a.mask_stride;
  uint32_t mb[4];
  mask_bytes(mrow, g < nrows, t.t0, t.t1 > t.t0 ? a.t_scan : 0, mb);
  {
    // q and k roped (rotate-half) and v, of the group's rows: q to bf16, k
    // and v rounded to bf16 as the cache stores them (qkv is read through
    // L2: H writes it earlier in the same launch)
    float x[KE][5], cs[KE], sn[KE];
#pragma unroll
    for (int k = 0; k < KE; ++k) {
      const int i = tid + k * kConsumers, r = i / HD, e = i - r * HD, j = row0 + r;
      const int f = e < half ? e : e - half, ep = e < half ? e + half : e - half;
      if (i >= n) continue;
      const float* row = a.qkv + (long)j * 3 * D + h * HD;
      x[k][0] = __ldcg(row + e);
      x[k][1] = __ldcg(row + ep);
      x[k][2] = __ldcg(row + D + e);
      x[k][3] = __ldcg(row + D + ep);
      x[k][4] = __ldcg(row + 2 * D + e);
      cs[k] = a.cos_t[(long)j * a.cs_stride + f];
      sn[k] = a.sin_t[(long)j * a.cs_stride + f];
    }
#pragma unroll
    for (int k = 0; k < KE; ++k) {
      const int i = tid + k * kConsumers, e = i % HD;
      if (i >= n) continue;
      const float sg = e < half ? -sn[k] : sn[k];
      const float qr = x[k][0] * cs[k] + x[k][1] * sg, kr = x[k][2] * cs[k] + x[k][3] * sg;
      s.q[i] = __float2bfloat16(qr);
      s.kf[i] = bf16_round(kr);
      s.vf[i] = bf16_round(x[k][4]);
    }
  }
  consumer_sync();
  // A fragments of q (rows g < nrows; rows 8..15 are zero): a0, a2 per k16 step
  uint32_t qa[HD / 16][2];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const bool on = g < nrows;
    qa[kk][0] = on ? *reinterpret_cast<const uint32_t*>(s.q + g * HD + 16 * kk + 2 * tq) : 0u;
    qa[kk][1] = on ? *reinterpret_cast<const uint32_t*>(s.q + g * HD + 16 * kk + 8 + 2 * tq) : 0u;
  }

  float m = -INFINITY, l = 0.f;
  float acc[HD / 8][4];   // ctx rows g (c0, c1) and g + 8 (c2, c3: padding) x hd columns
#pragma unroll
  for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;

  for (int tile = t.t0; tile < t.t1; ++tile, ++it) {
    const int slot = it % kStages;
    // the lane's scores: row g x cache rows tile * 64 + 16 * warp + 2 * tq +
    // {0, 1, 8, 9}; the next tile's mask bytes load while this one is scored
    uint32_t nb[4];
    mask_bytes(mrow, g < nrows, tile + 1, tile + 1 < t.t1 ? a.t_scan : 0, nb);
    bool live[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) live[i] = mb[i] != 0u;
    mbar_wait(&s.full[slot], (uint32_t)((it / kStages) & 1));
    const unsigned char* kt = s.ring + slot * L::kStage;
    const unsigned char* vt = kt + L::kOperand;
    if constexpr (kMath) {
      // two accumulators per n-tile (even and odd k16 steps) halve the chain
      float sc[2][2][4] = {};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        // matrices: (n-tile 0, k lo), (0, k hi), (1, lo), (1, hi)
        uint32_t kb[4];
        ldsm_x4(kb, kt + swz(16 * warp + 8 * (lane >> 4) + (lane & 7),
                             16 * kk + 8 * ((lane >> 3) & 1)));
        const uint32_t qf[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
        mma(sc[kk & 1][0], qf, kb[0], kb[1]);
        mma(sc[kk & 1][1], qf, kb[2], kb[3]);
      }
      float x[4] = {sc[0][0][0] + sc[1][0][0], sc[0][0][1] + sc[1][0][1],
                    sc[0][1][0] + sc[1][1][0], sc[0][1][1] + sc[1][1][1]};
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = live[i] ? x[i] * a.scale : -INFINITY;
        mx = fmaxf(mx, x[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m, mx), mu = mn == -INFINITY ? 0.f : mn;
      const float alpha = expf(m - mu);
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = expf(x[i] - mu);
      l = l * alpha + ((p[0] + p[1]) + (p[2] + p[3]));
      m = mn;
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn) {
        acc[nn][0] *= alpha;
        acc[nn][1] *= alpha;
      }
      // S's C fragment as P's A fragment: a0 = n-tile 0 (c0, c1), a2 = n-tile 1
      uint32_t ph[4] = {0u, 0u, 0u, 0u}, pl[4] = {0u, 0u, 0u, 0u};
      split_p(p[0], p[1], ph[0], pl[0]);
      split_p(p[2], p[3], ph[2], pl[2]);
#pragma unroll
      for (int n2 = 0; n2 < HD / 16; ++n2) {
        // matrices: (k lo, n-tile 2 n2), (k hi, 2 n2), (k lo, 2 n2 + 1), (k hi, 2 n2 + 1)
        uint32_t vb[4];
        ldsm_x4_trans(vb, vt + swz(16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7),
                                   16 * n2 + 8 * (lane >> 4)));
        mma(acc[2 * n2], ph, vb[0], vb[1]);
        mma(acc[2 * n2], pl, vb[0], vb[1]);
        mma(acc[2 * n2 + 1], ph, vb[2], vb[3]);
        mma(acc[2 * n2 + 1], pl, vb[2], vb[3]);
      }
    } else {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(kt + 4 * tid) ^
                         *reinterpret_cast<const uint32_t*>(vt + 4 * tid);
      acc[0][0] += __uint_as_float(w & 0x3f800000u) * (live[0] ? 1.f : 0.f);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[slot]);
#pragma unroll
    for (int i = 0; i < 4; ++i) mb[i] = nb[i];
  }

  // ---- the four warps' states, merged in warp order: the item's partial ----
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (g < nrows) {
    if (tq == 0) {
      s.wm[warp * R + g] = m;
      s.wl[warp * R + g] = l;
    }
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn) {
      s.wacc[(warp * R + g) * HD + 8 * nn + 2 * tq] = acc[nn][0];
      s.wacc[(warp * R + g) * HD + 8 * nn + 2 * tq + 1] = acc[nn][1];
    }
  }
  consumer_sync();
  float* part = a.ws + (long)item * PS;
  if (tid < nrows) {
    const int r = tid;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s.wm[w * R + r]);
    const float mu = M == -INFINITY ? 0.f : M;
    float Ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(s.wm[w * R + r] - mu);
      s.wf[w * R + r] = f;
      Ls += f * s.wl[w * R + r];
    }
    part[r] = M;
    part[R + r] = Ls;
  }
  consumer_sync();
#pragma unroll
  for (int k = 0; k < KE; ++k) {
    const int i = tid + k * kConsumers, r = i / HD;
    if (i >= n) continue;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) A += s.wf[w * R + r] * s.wacc[w * R * HD + i];
    part[2 * R + i] = A;
  }

  // ---- the (head, group)'s last block merges the partials in split order ----
  __threadfence();
  consumer_sync();
  if (a.nsplit > 1) {
    if (tid == 0) *s.flag = atomicAdd(a.tickets + t.hc, 1u) == (unsigned)(a.nsplit - 1);
    consumer_sync();
    if (!*s.flag) return;
    __threadfence();
    if (tid == 0) a.tickets[t.hc] = 0u;   // ready for the next launch on this stream
  }
  const float* p0 = a.ws + (long)t.hc * a.nsplit * PS;
  // the first kBatch splits' partials load at once (every thread: its
  // elements' acc; threads r < nrows: row r's m and l) while the warps
  // score the in-flight rows
  float v[kBatch][KE], mv[kBatch], lv[kBatch];
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    const bool on = q < a.nsplit;
#pragma unroll
    for (int k = 0; k < KE; ++k) {
      const int i = tid + k * kConsumers;
      v[q][k] = on && i < n ? __ldcg(p0 + (long)q * PS + 2 * R + i) : 0.f;
    }
    mv[q] = on && tid < nrows ? __ldcg(p0 + (long)q * PS + tid) : -INFINITY;
    lv[q] = on && tid < nrows ? __ldcg(p0 + (long)q * PS + R + tid) : 0.f;
  }
  // fold scores q_r . k_j for j <= r: 8 lanes per (r, j) pair, 16 pairs a round
  for (int pr0 = 0; pr0 < nrows * nrows; pr0 += 4 * kWarps) {
    const int pr = pr0 + 4 * warp + (lane >> 3), sl = lane & 7, r = pr / nrows, j = pr % nrows;
    const bool on = pr < nrows * nrows && j <= r;
    float sdot = 0.f;
    if (on)
      for (int e = sl; e < HD; e += 8)
        sdot = fmaf(__bfloat162float(s.q[r * HD + e]), s.kf[j * HD + e], sdot);
    sdot += __shfl_xor_sync(0xffffffffu, sdot, 4);
    sdot += __shfl_xor_sync(0xffffffffu, sdot, 2);
    sdot += __shfl_xor_sync(0xffffffffu, sdot, 1);
    if (on && sl == 0) s.fold[r * R + j] = sdot * a.scale;
  }
  consumer_sync();
  if (tid < nrows) {
    // row r: the splits' maximum, factors and sum, then the fold of the
    // in-flight rows 0..r in order after the cache
    const int r = tid;
    float M = -INFINITY;
#pragma unroll
    for (int q = 0; q < kBatch; ++q) M = fmaxf(M, mv[q]);
    for (int sp0 = kBatch; sp0 < a.nsplit; sp0 += kBatch) {
      float mm[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        mm[q] = sp0 + q < a.nsplit ? __ldcg(p0 + (long)(sp0 + q) * PS + r) : -INFINITY;
#pragma unroll
      for (int q = 0; q < kBatch; ++q) M = fmaxf(M, mm[q]);
    }
    const float mu = M == -INFINITY ? 0.f : M;
    float Lr = 0.f;
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (q >= a.nsplit) break;
      const float f = expf(mv[q] - mu);
      s.fs[q * R + r] = f;
      Lr += f * lv[q];
    }
    for (int sp0 = kBatch; sp0 < a.nsplit; sp0 += kBatch) {
      float mm[kBatch], ll[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const bool on = sp0 + q < a.nsplit;
        mm[q] = on ? __ldcg(p0 + (long)(sp0 + q) * PS + r) : -INFINITY;
        ll[q] = on ? __ldcg(p0 + (long)(sp0 + q) * PS + R + r) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (sp0 + q >= a.nsplit) break;
        const float f = expf(mm[q] - mu);
        s.fs[(sp0 + q) * R + r] = f;
        Lr += f * ll[q];
      }
    }
    float Mr = M;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j > r) break;
      const float sf = s.fold[r * R + j];
      const float mn = fmaxf(Mr, sf);
      const float al = expf(Mr - mn), pf = expf(sf - mn);
      Lr = Lr * al + pf;
      s.fal[r * R + j] = al;
      s.fpf[r * R + j] = pf;
      Mr = mn;
    }
    s.row_l[r] = Lr;
  }
  consumer_sync();
  float A[KE];
#pragma unroll
  for (int k = 0; k < KE; ++k) {
    const int i = tid + k * kConsumers, r = i < n ? i / HD : 0;
    A[k] = 0.f;
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (q < a.nsplit) A[k] += s.fs[q * R + r] * v[q][k];
  }
  for (int sp0 = kBatch; sp0 < a.nsplit; sp0 += kBatch) {
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
#pragma unroll
      for (int k = 0; k < KE; ++k) {
        const int i = tid + k * kConsumers;
        v[q][k] = sp0 + q < a.nsplit && i < n ? __ldcg(p0 + (long)(sp0 + q) * PS + 2 * R + i)
                                              : 0.f;
      }
#pragma unroll
    for (int k = 0; k < KE; ++k) {
      const int i = tid + k * kConsumers, r = i < n ? i / HD : 0;
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        if (sp0 + q < a.nsplit) A[k] += s.fs[(sp0 + q) * R + r] * v[q][k];
    }
  }
#pragma unroll
  for (int k = 0; k < KE; ++k) {
    const int i = tid + k * kConsumers, r = i / HD, e = i - r * HD, j = row0 + r;
    if (i >= n) continue;
    float acc_k = A[k];
#pragma unroll
    for (int jj = 0; jj < R; ++jj) {
      if (jj > r) break;
      acc_k = acc_k * s.fal[r * R + jj] + s.fpf[r * R + jj] * s.vf[jj * HD + e];
    }
    a.ctx[(long)j * D + h * HD + e] = __float2bfloat16(acc_k / fmaxf(s.row_l[r], 1e-30f));
    a.k_new[(long)j * D + h * HD + e] = __float2bfloat16(s.kf[i]);
    a.v_new[(long)j * D + h * HD + e] = __float2bfloat16(s.vf[i]);
  }
}

}  // namespace d3attn
