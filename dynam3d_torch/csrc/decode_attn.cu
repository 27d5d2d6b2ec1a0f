// Decode-step attention for Hopper (sm_90a): RoPE + cached attention with
// the in-flight rows of a group folded in, one block per (row, head).
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
// the group size.  Row r belongs to group r / group, streams cache row
// r / group and folds the new k/v of rows g0..r (g0 = first row of its group)
// after the cache: group = 1 is the plain mode (each row folds only itself),
// group = rows is the shared-cache verify mode (k drafts of one sequence),
// anything between is the grouped mode.  Outputs: ctx [rows, D] bf16 and the
// roped k_new / v_new [rows, D] bf16 for the caller's cache write.
//
// Bound: the cache rows of the live prefix are read once per (row, head)
// block (2 * t_scan * hd * 2 bytes), a handful of operations per byte, so
// the kernel is bound by bytes.  Each thread owns whole cache rows (16-byte
// loads along the head slice, many rows in flight per warp) and keeps its own
// f32 online-softmax state; the block merges the per-thread states once at
// the end.  All softmax and context arithmetic is f32; q and k are rounded to
// bf16 after RoPE as the cache stores them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int HD>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(
    const float* __restrict__ qkv, int rows, int D,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t, int cs_stride,
    const __nv_bfloat16* __restrict__ cache_k, const __nv_bfloat16* __restrict__ cache_v,
    int n_cache, int tmax, int li, const uint8_t* __restrict__ mask, int mask_stride,
    int t_scan, int group, float scale,
    __nv_bfloat16* __restrict__ ctx, __nv_bfloat16* __restrict__ k_new,
    __nv_bfloat16* __restrict__ v_new) {
  constexpr int half = HD / 2;
  __shared__ float q_s[HD];
  __shared__ float kf_s[kMaxRows][HD];
  __shared__ float vf_s[kMaxRows][HD];
  __shared__ float red_m[kWarps], red_l[kWarps];
  __shared__ float red_acc[kWarps][HD];
  __shared__ float s_fold[kMaxRows];

  const int h = blockIdx.x, r = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g0 = (r / group) * group;
  const int c = r / group;
  const int nf = r - g0 + 1;   // in-flight rows folded after the cache

  // ---- prologue: RoPE (rotate-half inside the head) for q_r and k_j, j in g0..r ----
  for (int i = tid; i < nf * HD; i += kThreads) {
    const int jr = i / HD, e = i - jr * HD, j = g0 + jr;
    const float* row = qkv + (long)j * 3 * D;
    const float* cs = cos_t + (long)j * cs_stride;
    const float* sn = sin_t + (long)j * cs_stride;
    const int f = e < half ? e : e - half;
    const float kx = row[D + h * HD + e];
    const float kp = row[D + h * HD + (e < half ? e + half : e - half)];
    const float kr = e < half ? kx * cs[f] - kp * sn[f] : kx * cs[f] + kp * sn[f];
    kf_s[jr][e] = bf16_round(kr);
    vf_s[jr][e] = bf16_round(row[2 * D + h * HD + e]);
    if (j == r) {
      const float qx = row[h * HD + e];
      const float qp = row[h * HD + (e < half ? e + half : e - half)];
      const float qr = e < half ? qx * cs[f] - qp * sn[f] : qx * cs[f] + qp * sn[f];
      q_s[e] = bf16_round(qr);
      k_new[(long)r * D + h * HD + e] = __float2bfloat16(kr);
      v_new[(long)r * D + h * HD + e] = __float2bfloat16(row[2 * D + h * HD + e]);
    }
  }
  __syncthreads();

  // ---- stream the cache: thread owns rows t = tid, tid + 128, ... ----
  float m = -1e30f, l = 0.f;
  float acc[HD];
#pragma unroll
  for (int e = 0; e < HD; ++e) acc[e] = 0.f;
  const long base = ((long)li * n_cache + c) * tmax * D + (long)h * HD;
  const uint8_t* mrow = mask + (long)r * mask_stride;
  for (int t = tid; t < t_scan; t += kThreads) {
    if (!mrow[t]) continue;
    const uint4* kp = reinterpret_cast<const uint4*>(cache_k + base + (long)t * D);
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
    s *= scale;
    float alpha = 1.f, p;
    if (s > m) { alpha = expf(m - s); m = s; p = 1.f; }
    else { p = expf(s - m); }
    l = l * alpha + p;
    const uint4* vp = reinterpret_cast<const uint4*>(cache_v + base + (long)t * D);
#pragma unroll
    for (int v8 = 0; v8 < HD / 8; ++v8) {
      const uint4 w = __ldg(vp + v8);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f2 = __bfloat1622float2(p2[u]);
        acc[v8 * 8 + 2 * u] = fmaf(acc[v8 * 8 + 2 * u], alpha, p * f2.x);
        acc[v8 * 8 + 2 * u + 1] = fmaf(acc[v8 * 8 + 2 * u + 1], alpha, p * f2.y);
      }
    }
  }

  // ---- merge the per-thread states: block max, then rescaled sums ----
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
  // fold scores of the in-flight rows: warp w takes rows w, w+4, ...
  for (int jr = warp; jr < nf; jr += kWarps) {
    float s = 0.f;
    for (int e = lane; e < HD; e += 32) s = fmaf(q_s[e], kf_s[jr][e], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) s_fold[jr] = s * scale;
  }
  __syncthreads();

  // ---- fold rows g0..r in order after the cache, normalize, write ctx ----
  float L = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) L += red_l[w];
  for (int e = tid; e < HD; e += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red_acc[w][e];
    float Mr = M, Lr = L;
    for (int jr = 0; jr < nf; ++jr) {
      const float s = s_fold[jr];
      const float mn = fmaxf(Mr, s);
      const float al = expf(Mr - mn), p = expf(s - mn);
      Lr = Lr * al + p;
      a = a * al + p * vf_s[jr][e];
      Mr = mn;
    }
    ctx[(long)r * D + h * HD + e] = __float2bfloat16(a / fmaxf(Lr, 1e-30f));
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch; 1 (cudaErrorInvalidValue) for
// an unsupported head size or row count.
extern "C" int decode_attn(const float* qkv, int rows, int D, int heads, int hd,
                           const float* cos_t, const float* sin_t, int cs_stride,
                           const void* cache_k, const void* cache_v, int n_cache,
                           int tmax, int li, const uint8_t* mask, int mask_stride,
                           int t_scan, int group, float scale, void* ctx,
                           void* k_new, void* v_new, void* stream) {
  if (rows < 1 || rows > kMaxRows || group < 1 || group > kMaxRows) return 1;
  dim3 grid(heads, rows);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* ck = reinterpret_cast<const __nv_bfloat16*>(cache_k);
  const auto* cv = reinterpret_cast<const __nv_bfloat16*>(cache_v);
  auto* co = reinterpret_cast<__nv_bfloat16*>(ctx);
  auto* kn = reinterpret_cast<__nv_bfloat16*>(k_new);
  auto* vn = reinterpret_cast<__nv_bfloat16*>(v_new);
#define D3_LAUNCH(HD)                                                           \
  decode_attn_kernel<HD><<<grid, kThreads, 0, st>>>(                            \
      qkv, rows, D, cos_t, sin_t, cs_stride, ck, cv, n_cache, tmax, li, mask,   \
      mask_stride, t_scan, group, scale, co, kn, vn)
  switch (hd) {
    case 32: D3_LAUNCH(32); break;
    case 64: D3_LAUNCH(64); break;
    case 96: D3_LAUNCH(96); break;
    case 128: D3_LAUNCH(128); break;
    default: return 1;
  }
#undef D3_LAUNCH
  return (int)cudaGetLastError();
}
