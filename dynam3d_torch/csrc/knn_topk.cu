// Masked squared-distance k-NN, k <= 8, for Hopper (sm_90a).
//
// Replaces the TPU kernel dynam3d_tpu/ops/pallas_knn.py::pallas_knn (body
// _kernel): for every query the k smallest d = max(|q|^2 + |p|^2 - 2 q.p, 0)
// over the live points, ascending, ties to the smaller point id; dead points
// never enter; while fewer than k live points are found the tail stays
// (1e10, -1).  The renderer's stage-1 query is Q = 144 rays x 501 samples
// against a P = 32768-slot patch table at k = 4.
//
// Bound: about 8 float operations per (query, point) pair on the CUDA cores
// (no tensor cores: a 3-deep product does not fill an MMA, and TF32 would
// break the distance cancellation), against 12 bytes per point and query of
// input, so operations bound it.  Design:
//   * one thread per query, its running best list (k distances and ids) in
//     registers, templated on k;
//   * the table streams through shared memory in chunks of 2048 points,
//     staged once per block as (-2x, -2y, -2z, |p|^2), with |p|^2 = +inf for
//     a dead slot, so the inner loop is one broadcast 16-byte shared load,
//     three products, three sums and a compare per pair;
//   * a point enters only when strictly closer than the current k-th entry,
//     and lands after every entry with an equal distance: as ids are scanned
//     upward, ties keep the smaller id (the TPU kernel's tie rule).
// Products and sums are rounded one by one (__fmul_rn / __fadd_rn, never
// contracted to FMA) in the order the expansion is written; -2*(q.p) is
// formed as q.(-2p), which is the same number since scaling by 2 is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 2048;
constexpr float kBig = 1e10f;

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_topk_kernel(const float* __restrict__ q, int nq, const float* __restrict__ pts,
                const uint8_t* __restrict__ valid, int np, float* __restrict__ out_d,
                long long* __restrict__ out_i) {
  __shared__ float4 sp[kChunk];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * qi];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
  }
  const float q2 = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), __fmul_rn(qz, qz));
  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = kBig;
    bi[j] = -1;
  }

  for (int base = 0; base < np; base += kChunk) {
    const int n = min(kChunk, np - base);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const long p = base + t;
      const float x = pts[3 * p], y = pts[3 * p + 1], z = pts[3 * p + 2];
      const float p2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
      sp[t] = make_float4(-2.f * x, -2.f * y, -2.f * z,
                          valid[p] ? p2 : __int_as_float(0x7f800000));
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < n; ++t) {
      const float4 v = sp[t];
      const float c = __fadd_rn(__fadd_rn(__fmul_rn(qx, v.x), __fmul_rn(qy, v.y)),
                                __fmul_rn(qz, v.z));
      const float d = fmaxf(__fadd_rn(__fadd_rn(q2, v.w), c), 0.f);
      if (d < bd[K - 1]) {
        // insert after every entry <= d; the displaced entries shift down
        float cd = d;
        int ci = base + t;
        bool moved = false;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (moved || cd < bd[j]) {
            const float td = bd[j];
            const int ti = bi[j];
            bd[j] = cd;
            bi[j] = ci;
            cd = td;
            ci = ti;
            moved = true;
          }
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      out_d[(long)qi * K + j] = bd[j];
      out_i[(long)qi * K + j] = bi[j];
    }
  }
}

template <int K>
void launch(const float* q, int nq, const float* pts, const uint8_t* valid, int np,
            float* out_d, long long* out_i, cudaStream_t stream) {
  const int blocks = (nq + kThreads - 1) / kThreads;
  knn_topk_kernel<K><<<blocks, kThreads, 0, stream>>>(q, nq, pts, valid, np, out_d, out_i);
}

}  // namespace

// Launches the k-NN.  Returns cudaGetLastError(); 1 (cudaErrorInvalidValue)
// for k outside 1..8.
//   q: [nq, 3] f32;  pts: [np, 3] f32;  valid: [np] bool (one byte each)
//   out_d: [nq, k] f32 squared distances;  out_i: [nq, k] int64 ids
extern "C" int knn_topk(const float* q, int nq, const float* pts, const uint8_t* valid,
                        int np, int k, float* out_d, long long* out_i, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (nq <= 0) return (int)cudaGetLastError();
  switch (k) {
    case 1: launch<1>(q, nq, pts, valid, np, out_d, out_i, stream); break;
    case 2: launch<2>(q, nq, pts, valid, np, out_d, out_i, stream); break;
    case 3: launch<3>(q, nq, pts, valid, np, out_d, out_i, stream); break;
    case 4: launch<4>(q, nq, pts, valid, np, out_d, out_i, stream); break;
    case 5: launch<5>(q, nq, pts, valid, np, out_d, out_i, stream); break;
    case 6: launch<6>(q, nq, pts, valid, np, out_d, out_i, stream); break;
    case 7: launch<7>(q, nq, pts, valid, np, out_d, out_i, stream); break;
    case 8: launch<8>(q, nq, pts, valid, np, out_d, out_i, stream); break;
    default: return 1;
  }
  return (int)cudaGetLastError();
}
