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
//   1. rmsnorm (each block reduces x itself) and the qkv matvec, work items
//      (tile of 128 packed columns, K slice) over all blocks, slices summed in
//      order by each tile's last block into y [3D] f32 (global scratch);
//   2. a block per head: RoPE on q and k, both rounded to bf16 as the cache
//      stores them; each thread streams whole cache rows (16-byte loads) with
//      its own online-softmax state, the block merges the states and folds
//      the current token last; ctx [D] bf16 to global scratch;
//   3. the o matvec over ctx as in phase 1, plus the residual, to bf16.
//
// Numerics: attention arithmetic is f32 (the TPU kernel rounds the k*q
// products and the probabilities to bf16), as in kernel B (decode_attn.cu).
//
// Bound: the packed qkv and o weights (14.2 + 4.7 MB at Phi-3-mini widths)
// and the live cache rows (2 * valid rows * D * 2 bytes) are each read once,
// a few operations per byte: bytes bound it.  Phase 2 runs on one block per
// head (32 of 132 SMs at Phi-3-mini), which is the design's cost.

#include <cooperative_groups.h>

#include "int4_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace d3;

struct Params {
  const __nv_bfloat16* x;   // [D]
  int D;
  const float* ln_w;
  float eps;
  const int8_t* qkv_q4;     // [qkv_dp, 3D/2]
  const float* qkv_slo;
  const float* qkv_shi;
  int qkv_dp, qkv_n2;
  const int8_t* o_q4;       // [o_dp, D/2]
  const float* o_slo;
  const float* o_shi;
  int o_dp, o_n2;
  int dblk, ks1, ks3;
  const float* cos_t;       // [hd/2]
  const float* sin_t;
  const __nv_bfloat16* cache_k;
  const __nv_bfloat16* cache_v;
  int n_cache, tmax, li;
  const uint8_t* mask;      // [Tmax]
  int t_scan, heads;
  float scale;
  float* y;                 // scratch [3D]
  __nv_bfloat16* ctx;       // scratch [D]
  __nv_bfloat16* out;       // [D]
  __nv_bfloat16* k_new;
  __nv_bfloat16* v_new;
  float* ws1;
  float* ws3;
  unsigned int* tickets;    // [tiles1 + tiles3], zeroed
};

// One work item of a B=1 matvec: tile x K slice of q4 over the staged
// activations; returns true in the block that holds the tile's sum.
__device__ __forceinline__ bool matvec_item(float* smem, const __nv_bfloat16* src, int d,
                                            float inv_rms, const float* ln_w,
                                            const int8_t* q4, const float* s_lo,
                                            const float* s_hi, int n2, int dblk, int ks,
                                            int tile, int split, int nsplit, float* ws,
                                            unsigned int* ticket, int* is_last, float& v,
                                            OutCol& c) {
  const int k0 = split * ks;
  Acc a;
  acc_zero(a);
  __syncthreads();
  stage(smem, src, d, k0, ks, inv_rms, ln_w);
  __syncthreads();
  acc_slice(a, smem, ks, q4, n2, k0, tile);
  c = out_col(tile, n2);
  v = apply_scale(acc_reduce(a, smem), c, s_lo, s_hi, k0 / dblk, n2);
  return combine(v, c, split, nsplit, n2, ws, ticket, is_last);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) decode_attn_layer_kernel(Params p) {
  constexpr int half = HD / 2;
  __shared__ float smem[kSmemFloats];
  __shared__ float inv_rms[1];
  __shared__ int is_last;
  __shared__ float q_s[HD], kf_s[HD], vf_s[HD];
  __shared__ float red_m[kWarps], red_l[kWarps], s_cur;
  __shared__ float red_acc[kWarps][HD];
  cg::grid_group grid = cg::this_grid();
  const int D = p.D, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // ---- phase 1: y = bf16(rmsnorm(x) * ln_w) @ qkv ----
  row_inv_rms(p.x, D, p.eps, inv_rms);
  const int tiles1 = (p.qkv_n2 + kTile - 1) / kTile, ns1 = p.qkv_dp / p.ks1;
  for (int item = blockIdx.x; item < tiles1 * ns1; item += gridDim.x) {
    const int tile = item / ns1, split = item - tile * ns1;
    float v;
    OutCol c;
    if (!matvec_item(smem, p.x, D, inv_rms[0], p.ln_w, p.qkv_q4, p.qkv_slo, p.qkv_shi, p.qkv_n2,
                     p.dblk, p.ks1, tile, split, ns1, p.ws1, p.tickets + tile, &is_last, v, c))
      continue;
    if (c.ok && c.po < 3L * D) p.y[c.po] = v;
  }

  grid.sync();

  // ---- phase 2: a block per head ----
  const long base = (long)p.li * p.n_cache * p.tmax * D;
  for (int h = blockIdx.x; h < p.heads; h += gridDim.x) {
    __syncthreads();
    for (int e = tid; e < HD; e += kThreads) {
      const int f = e < half ? e : e - half, ep = e < half ? e + half : e - half;
      const float cs = p.cos_t[f], sn = p.sin_t[f];
      const float qx = __ldcg(p.y + h * HD + e), qp = __ldcg(p.y + h * HD + ep);
      const float kx = __ldcg(p.y + D + h * HD + e), kp = __ldcg(p.y + D + h * HD + ep);
      const float qr = e < half ? qx * cs - qp * sn : qx * cs + qp * sn;
      const float kr = e < half ? kx * cs - kp * sn : kx * cs + kp * sn;
      const float vv = __ldcg(p.y + 2 * D + h * HD + e);
      q_s[e] = bf16_round(qr);
      kf_s[e] = bf16_round(kr);
      vf_s[e] = bf16_round(vv);
      p.k_new[h * HD + e] = __float2bfloat16(kr);
      p.v_new[h * HD + e] = __float2bfloat16(vv);
    }
    __syncthreads();

    // stream the cache: thread owns rows t = tid, tid + 256, ...
    float m = -1e30f, l = 0.f;
    float acc[HD];
#pragma unroll
    for (int e = 0; e < HD; ++e) acc[e] = 0.f;
    const long hb = base + (long)h * HD;
    for (int t = tid; t < p.t_scan; t += kThreads) {
      if (!p.mask[t]) continue;
      const uint4* kp = reinterpret_cast<const uint4*>(p.cache_k + hb + (long)t * D);
      float s = 0.f;
#pragma unroll
      for (int v8 = 0; v8 < HD / 8; ++v8) {
        const uint4 w = __ldg(kp + v8);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 f2 = __bfloat1622float2(p2[u]);
          s = fmaf(q_s[v8 * 8 + 2 * u], f2.x, s);
          s = fmaf(q_s[v8 * 8 + 2 * u + 1], f2.y, s);
        }
      }
      s *= p.scale;
      float alpha = 1.f, pr;
      if (s > m) { alpha = expf(m - s); m = s; pr = 1.f; }
      else { pr = expf(s - m); }
      l = l * alpha + pr;
      const uint4* vp = reinterpret_cast<const uint4*>(p.cache_v + hb + (long)t * D);
#pragma unroll
      for (int v8 = 0; v8 < HD / 8; ++v8) {
        const uint4 w = __ldg(vp + v8);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 f2 = __bfloat1622float2(p2[u]);
          acc[v8 * 8 + 2 * u] = fmaf(acc[v8 * 8 + 2 * u], alpha, pr * f2.x);
          acc[v8 * 8 + 2 * u + 1] = fmaf(acc[v8 * 8 + 2 * u + 1], alpha, pr * f2.y);
        }
      }
    }

    // merge the per-thread states: block max, then rescaled sums
    float mw = m;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
    if (lane == 0) red_m[warp] = mw;
    __syncthreads();
    float M = red_m[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, red_m[w]);
    const float f = expf(m - M);
    float lw = l * f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lw += __shfl_xor_sync(0xffffffffu, lw, o);
    if (lane == 0) red_l[warp] = lw;
#pragma unroll
    for (int e = 0; e < HD; ++e) {
      float a = acc[e] * f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == 0) red_acc[warp][e] = a;
    }
    // the current token's score (warp 0)
    if (warp == 0) {
      float s = 0.f;
      for (int e = lane; e < HD; e += 32) s = fmaf(q_s[e], kf_s[e], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) s_cur = s * p.scale;
    }
    __syncthreads();

    // fold the current token after the cache, normalize, store ctx
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) L += red_l[w];
    for (int e = tid; e < HD; e += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += red_acc[w][e];
      const float mn = fmaxf(M, s_cur);
      const float al = expf(M - mn), pc = expf(s_cur - mn);
      const float Lr = L * al + pc;
      a = a * al + pc * vf_s[e];
      p.ctx[h * HD + e] = __float2bfloat16(a / fmaxf(Lr, 1e-30f));
    }
  }

  grid.sync();

  // ---- phase 3: out = bf16(x + ctx @ o) ----
  const int tiles3 = (p.o_n2 + kTile - 1) / kTile, ns3 = p.o_dp / p.ks3;
  for (int item = blockIdx.x; item < tiles3 * ns3; item += gridDim.x) {
    const int tile = item / ns3, split = item - tile * ns3;
    float v;
    OutCol c;
    if (!matvec_item(smem, p.ctx, D, 1.f, nullptr, p.o_q4, p.o_slo, p.o_shi, p.o_n2,
                     p.dblk, p.ks3, tile, split, ns3, p.ws3, p.tickets + tiles1 + tile,
                     &is_last, v, c))
      continue;
    if (c.ok && c.po < D) p.out[c.po] = __float2bfloat16(__bfloat162float(p.x[c.po]) + v);
  }
}

void* kernel_for_hd(int hd) {
  switch (hd) {
    case 32: return reinterpret_cast<void*>(decode_attn_layer_kernel<32>);
    case 64: return reinterpret_cast<void*>(decode_attn_layer_kernel<64>);
    case 96: return reinterpret_cast<void*>(decode_attn_layer_kernel<96>);
    case 128: return reinterpret_cast<void*>(decode_attn_layer_kernel<128>);
    default: return nullptr;
  }
}

}  // namespace

// Launch plan: out3 = {grid, ks1, ks3}, the cooperative grid and the K slices
// of the qkv and o matvecs.  Returns 0, a CUDA error code, or 1 for shapes it
// does not take.
extern "C" int decode_attn_layer_plan(int hd, int qkv_dp, int qkv_n2, int o_dp, int o_n2,
                                      int dblk, int* out3) {
  void* k = kernel_for_hd(hd);
  if (k == nullptr || qkv_n2 % 4 != 0 || o_n2 % 4 != 0 || qkv_dp % dblk != 0 ||
      o_dp % dblk != 0)
    return 1;
  int grid = 0;
  const int rc = coop_grid(k, &grid);
  if (rc != 0) return rc;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int ks1 = pick_slice(dblk, qkv_dp, (qkv_n2 + kTile - 1) / kTile, grid);
  const int ks3 = pick_slice(dblk, o_dp, (o_n2 + kTile - 1) / kTile, grid);
  if (ks1 < 1 || ks3 < 1) return 1;
  out3[0] = grid;
  out3[1] = ks1;
  out3[2] = ks3;
  return 0;
}

// Kernel H; see the header comment.  cache_k/v: [L, n_cache, tmax, D] bf16
// (row 0 read); mask: [tmax] bytes, 0 past t_scan's live rows and at the write
// slot; y: f32 scratch [3D]; ctx: bf16 scratch [D]; ws1: f32
// [qkv_dp/ks1, 1, 2*qkv_n2]; ws3: f32 [o_dp/ks3, 1, 2*o_n2]; tickets: zeroed
// uint32 [ceil(qkv_n2/128) + ceil(o_n2/128)].  Returns cudaGetLastError().
extern "C" int decode_attn_layer(const void* x, int D, const float* ln_w, float eps,
                                 const int8_t* qkv_q4, const float* qkv_slo,
                                 const float* qkv_shi, int qkv_dp, int qkv_n2,
                                 const int8_t* o_q4, const float* o_slo, const float* o_shi,
                                 int o_dp, int o_n2, int dblk, int grid, int ks1, int ks3,
                                 const float* cos_t, const float* sin_t, const void* cache_k,
                                 const void* cache_v, int n_cache, int tmax, int li,
                                 const uint8_t* mask, int t_scan, int heads, int hd,
                                 float scale, float* y, void* ctx, void* out, void* k_new,
                                 void* v_new, float* ws1, float* ws3, unsigned int* tickets,
                                 void* stream) {
  void* k = kernel_for_hd(hd);
  if (k == nullptr || heads * hd != D || 2 * qkv_n2 != 3 * D || 2 * o_n2 != D) return 1;
  Params p{reinterpret_cast<const __nv_bfloat16*>(x), D, ln_w, eps, qkv_q4, qkv_slo, qkv_shi,
           qkv_dp, qkv_n2, o_q4, o_slo, o_shi, o_dp, o_n2, dblk, ks1, ks3, cos_t, sin_t,
           reinterpret_cast<const __nv_bfloat16*>(cache_k),
           reinterpret_cast<const __nv_bfloat16*>(cache_v), n_cache, tmax, li, mask, t_scan,
           heads, scale, y, reinterpret_cast<__nv_bfloat16*>(ctx),
           reinterpret_cast<__nv_bfloat16*>(out), reinterpret_cast<__nv_bfloat16*>(k_new),
           reinterpret_cast<__nv_bfloat16*>(v_new), ws1, ws3, tickets};
  void* args[] = {&p};
  cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kThreads), args, 0,
                              reinterpret_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
