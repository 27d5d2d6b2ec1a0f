// Masked squared-distance k-NN, k <= 8, for Hopper (sm_90a): kernel D.
//
// Replaces the TPU kernel dynam3d_tpu/ops/pallas_knn.py::pallas_knn (body
// _kernel): for every query the k smallest d = max(|q|^2 + |p|^2 - 2 q.p, 0)
// over the live points, ascending, ties to the smaller point id; dead points
// never enter; while fewer than k live points are found the tail stays
// (1e10, -1).  The renderer's stage-1 query is Q = 144 rays x 501 samples
// against a P = 32768-slot patch table at k = 4.
//
// Bound: 8 float operations per (query, live point) pair on the CUDA cores,
// against 12 bytes per query and 13 per slot of input, so operations bound
// it; dead slots need no distance, so the bound counts live points only.
// Design:
//   * knn_stage_kernel compacts the live slots, in table order, into a
//     staged table of (-2x, -2y, -2z, |p|^2) and an int32 slot id per
//     point, and writes the live count L.  Each block counts the live
//     slots before its own chunk itself, so no block waits for another; the
//     compaction is stable, so the staged table still rises with the id.  L
//     stays on the card: the launch is fixed from P, the work is cut from L
//     on the card;
//   * knn_topk_kernel runs one wave of blocks, as many as the SMs hold.
//     The work, query tiles x the staged table (tiles * L tile-points, a
//     tile 128 r queries), is cut into equal contiguous ranges, one a block,
//     tile-major: a block scans the end of one tile's table and the start of
//     the next, so every SM gets the same work, whatever the shapes (a
//     range within one tile is a "piece": the tile's split of the table).
//     A producer warp brings the pieces' staged points and ids into a
//     4-slot shared ring by bulk copies (cp.async.bulk on mbarriers); four
//     consumer warps hold r queries a thread with their running lists in
//     registers, templated on k.  Per point one broadcast 16-byte shared
//     load feeds r chains d' = fma(qx, -2px, fma(qy, -2py, fma(qz, -2pz,
//     |p|^2))), the distance less |q|^2 (ranks are unchanged; |q|^2 is
//     added, and the sum clamped at 0, only when a list is written out).
//     Each query compares the min of a group of eight points with its k-th
//     entry, the warp branches once per group, and only on a hit are the
//     group's closer points inserted one by one in id order;
//   * a point enters only when strictly closer than the k-th entry and
//     lands after every entry with an equal distance: as ids rise through
//     a piece, ties keep the smaller id.  A tile cut into several pieces
//     has each piece's lists written to a scratch partial, and the tile's
//     last block (a self-resetting ticket) merges them in piece order by
//     the same strict-less insertion, so ties keep the smaller id across a
//     piece boundary too, and the result does not depend on the blocks'
//     order.
// Rounding: |p|^2 and |q|^2 are two FMAs and a product each; d' is three
// FMAs; the written distance is one add and a clamp.  The plain version
// (and the TPU kernel) forms q.p in a matmul and adds |q|^2 + |p|^2 first:
// the two differ by a few float32 steps of |q|^2 + |p|^2, and only points
// whose distances lie that close can swap ranks.
// No tensor cores: a one-pass TF32 product [q, |q|^2, 1].[-2p, 1, |p|^2]
// rounds each coordinate to 10 bits, an error of ~2^-11 |q||p| (0.02-0.08
// m^2 at room coordinates) as large as the distances it ranks; 3xTF32 would
// spend ~0.14 ms of tensor-core time on the stage-1 shape and still leave a
// compare per pair on the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace d3sm90;

constexpr int kConsumers = 128;              // four consumer warps
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kChunk = 512;                  // points a ring slot
constexpr int kSlots = 4;
constexpr int kGroup = 8;                    // points a compare covers (a power of 2)
constexpr int kStageThreads = 1024;          // slots a prologue block
constexpr float kBig = 1e10f;
constexpr bool kCompare = true;              // false: chains and group minima only
                                             // (tools/decompose_knn)

// ---------------------------------------------------------------------------
// prologue: stable compaction of the live slots, and their count

__device__ __forceinline__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0;
  v = __reduce_add_sync(0xffffffffu, v);
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kStageThreads)
knn_stage_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid, int np,
                 float4* __restrict__ staged, int* __restrict__ sid, int* __restrict__ n_live) {
  __shared__ int red[32];
  __shared__ int wpre[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * kStageThreads, p = p0 + tid;
  // live slots before this block's chunk (one byte each, read through L2)
  int before = 0;
#pragma unroll 8
  for (int i = tid; i < p0; i += kStageThreads) before += valid[i] != 0;
  before = block_sum(before, red);

  const bool live = p < np && valid[p] != 0;
  const bool keep = live;   // (tools/decompose_knn's dense variant keeps every slot)
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) red[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int c = red[lane];
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    wpre[lane] = incl - c;
    if (lane == 31) red[0] = incl;   // the chunk's live count (read after the sync)
  }
  __syncthreads();
  if (keep) {
    const int pos = before + wpre[warp] + __popc(ballot & ((1u << lane) - 1u));
    const float x = pts[3L * p], y = pts[3L * p + 1], z = pts[3L * p + 2];
    staged[pos] = make_float4(-2.f * x, -2.f * y, -2.f * z,
                              live ? fmaf(x, x, fmaf(y, y, z * z)) : __int_as_float(0x7f800000));
    sid[pos] = p;
  }
  if (blockIdx.x == gridDim.x - 1 && tid == 0) *n_live = before + red[0];
}

// ---------------------------------------------------------------------------
// main kernel

struct Args {
  const float* q;
  int nq;
  int tiles;             // query tiles of kConsumers * R queries
  const float4* staged;
  const int* sid;
  const int* n_live;
  float* part_d;         // [2 * gridDim.x][kConsumers * R][K]: a block's first and last piece
  int* part_i;
  unsigned* tickets;     // [tiles], zero, left zero
  float* out_d;
  long long* out_i;
};

// The cut of the work W = tiles * L: blocks b < G (G = min(grid, W)) take
// [b W / G, (b + 1) W / G), none empty
struct Cut {
  long L, W, G;
  __device__ __forceinline__ long start(long b) const { return b * W / G; }
  __device__ __forceinline__ long block_of(long u) const { return ((u + 1) * G - 1) / W; }
};

struct Smem {
  float4 pts[kSlots][kChunk];
  int ids[kSlots][kChunk + 4];   // a copy starts at the 16-byte word holding its first id
  uint64_t full[kSlots];
  uint64_t empty[kSlots];
  int last;
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// (d, id) into the ascending list (bd, bi): after every entry <= d, the
// entries behind it shift down, the last drops; nothing when d >= bd[K-1]
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d, int id) {
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    if (d < bd[j]) {
      const bool shift = j > 0 && d < bd[j > 0 ? j - 1 : 0];
      bd[j] = shift ? bd[j > 0 ? j - 1 : 0] : d;
      bi[j] = shift ? bi[j > 0 ? j - 1 : 0] : id;
    }
  }
}

// The n points of one ring slot (ids[j] is point j's slot id) against the
// thread's R queries
template <int K, int R>
__device__ __forceinline__ void scan(const float4* __restrict__ sp, const int* __restrict__ ids,
                                     int n, const float (&qx)[R], const float (&qy)[R],
                                     const float (&qz)[R], float (&bd)[R][K], int (&bi)[R][K],
                                     float (&near)[R]) {
  int j = 0;
#pragma unroll 2
  for (; j + kGroup <= n; j += kGroup) {
    float d[kGroup][R];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float4 p = sp[j + g];
#pragma unroll
      for (int r = 0; r < R; ++r) d[g][r] = fmaf(qx[r], p.x, fmaf(qy[r], p.y, fmaf(qz[r], p.z, p.w)));
    }
    float m[R];   // each query's group min, by a tree
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float t[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) t[g] = d[g][r];
#pragma unroll
      for (int w = kGroup / 2; w > 0; w /= 2)
#pragma unroll
        for (int g = 0; g < w; ++g) t[g] = fminf(t[g], t[g + w]);
      m[r] = t[0];
    }
    if constexpr (kCompare) {
      bool hit = false;
#pragma unroll
      for (int r = 0; r < R; ++r) hit |= m[r] < bd[r][K - 1];
      if (hit) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (m[r] < bd[r][K - 1]) {
#pragma unroll
            for (int g = 0; g < kGroup; ++g)
              if (d[g][r] < bd[r][K - 1]) insert<K>(bd[r], bi[r], d[g][r], ids[j + g]);
          }
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) near[r] = fminf(near[r], m[r]);
    }
  }
  for (; j < n; ++j) {
    const float4 p = sp[j];
#pragma unroll
    for (int r = 0; r < R; ++r)
      insert<K>(bd[r], bi[r], fmaf(qx[r], p.x, fmaf(qy[r], p.y, fmaf(qz[r], p.z, p.w))), ids[j]);
  }
}

template <int K, int R>
__device__ __forceinline__ void write_out(const Args& a, int q0, const float (&q2)[R],
                                          const float (&bd)[R][K], const int (&bi)[R][K]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (q0 + r >= a.nq) continue;
    const long o = (long)(q0 + r) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      a.out_d[o + j] = bi[r][j] >= 0 ? fmaxf(bd[r][j] + q2[r], 0.f) : kBig;
      a.out_i[o + j] = bi[r][j];
    }
  }
}

// The thread's queries of tile t, and lists that start at (1e10 - |q|^2, -1):
// d' < 1e10 - |q|^2 is d < 1e10, the plain version's hit
template <int K, int R>
__device__ __forceinline__ int load_queries(const Args& a, int t, float (&qx)[R], float (&qy)[R],
                                            float (&qz)[R], float (&q2)[R], float (&bd)[R][K],
                                            int (&bi)[R][K]) {
  const int q0 = t * (kConsumers * R) + (int)threadIdx.x * R;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool on = q0 + r < a.nq;
    qx[r] = on ? a.q[3L * (q0 + r)] : 0.f;
    qy[r] = on ? a.q[3L * (q0 + r) + 1] : 0.f;
    qz[r] = on ? a.q[3L * (q0 + r) + 2] : 0.f;
    q2[r] = fmaf(qx[r], qx[r], fmaf(qy[r], qy[r], qz[r] * qz[r]));
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bd[r][j] = kBig - q2[r];
      bi[r][j] = -1;
    }
  }
  return q0;
}

// The partial slot of block b's piece of tile t: its first piece or its last
__device__ __forceinline__ long part_slot(const Cut& c, long b, int t) {
  return 2 * b + (c.start(b) / c.L == t ? 0 : 1);
}

// Blocks an SM must hold, for ptxas's register budget: five of r = 2 up to
// k = 4 (shared memory allows five), three above (its lists need more than
// the 96 registers ptxas otherwise settles on, and spill there)
constexpr int min_blocks(int K, int R) { return R == 2 ? (K <= 4 ? 5 : 3) : 1; }

template <int K, int R>
__global__ void __launch_bounds__(kThreads, min_blocks(K, R)) knn_topk_kernel(const Args a) {
  __shared__ __align__(128) Smem s;
  const int tid = threadIdx.x;
  const long L = *a.n_live, W = (long)a.tiles * L;
  const Cut cut{L, W, W < (long)gridDim.x ? W : (long)gridDim.x};
  const long b = blockIdx.x;

  if (L == 0) {   // nothing live: every tile's rows are (1e10, -1)
    if (tid >= kConsumers) return;
    float qx[R], qy[R], qz[R], q2[R], bd[R][K];
    int bi[R][K];
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const int q0 = load_queries<K, R>(a, t, qx, qy, qz, q2, bd, bi);
      write_out<K, R>(a, q0, q2, bd, bi);
    }
    return;
  }
  if (b >= cut.G) return;
  const long u0 = cut.start(b), u1 = cut.start(b + 1);

  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {   // the producer warp: one lane issues the copies
    if (tid == kConsumers) {
      int c = 0;
      for (long u = u0; u < u1;) {
        const long t = u / L, p1 = min(L, u - t * L + (u1 - u));
        for (long p = u - t * L; p < p1; p += kChunk, ++c) {
          const int slot = c % kSlots;
          if (c >= kSlots) mbar_wait(&s.empty[slot], (uint32_t)((c / kSlots - 1) & 1));
          const int n = (int)min((long)kChunk, p1 - p), off = (int)(p & 3);
          const int id_bytes = ((off + n + 3) & ~3) * 4;
          mbar_expect_tx(&s.full[slot], (uint32_t)(n * 16 + id_bytes));
          // order the consumers' generic reads of the slot before the async write
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          bulk_copy(s.pts[slot], a.staged + p, (uint32_t)(n * 16), &s.full[slot]);
          bulk_copy(s.ids[slot], a.sid + (p - off), (uint32_t)id_bytes, &s.full[slot]);
        }
        u = t * L + p1;
      }
    }
    return;
  }

  float qx[R], qy[R], qz[R], q2[R], bd[R][K], near[R];
  int bi[R][K];
  int c = 0;
  for (long u = u0; u < u1;) {   // the pieces: tile t, staged points [p0, p1)
    const int t = (int)(u / L);
    const long p1 = min(L, u - (long)t * L + (u1 - u));
    const int q0 = load_queries<K, R>(a, t, qx, qy, qz, q2, bd, bi);
#pragma unroll
    for (int r = 0; r < R; ++r) near[r] = INFINITY;
    for (long p = u - (long)t * L; p < p1; p += kChunk, ++c) {
      const int slot = c % kSlots;
      mbar_wait(&s.full[slot], (uint32_t)((c / kSlots) & 1));
      scan<K, R>(s.pts[slot], s.ids[slot] + (p & 3), (int)min((long)kChunk, p1 - p), qx, qy, qz,
                 bd, bi, near);
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&s.empty[slot]);
    }
    u = (long)t * L + p1;
    if constexpr (!kCompare)   // keeps the chains and their group minima
#pragma unroll
      for (int r = 0; r < R; ++r) bd[r][0] = fminf(bd[r][0], near[r]);

    const long bf = cut.block_of((long)t * L), bl = cut.block_of((long)(t + 1) * L - 1);
    if (bf == bl) {   // the whole tile in this block
      write_out<K, R>(a, q0, q2, bd, bi);
      continue;
    }
    // this piece's lists to the scratch; the tile's last block merges
    constexpr int kPart = kConsumers * R * K;   // entries of one partial
    {
      const long o = part_slot(cut, b, t) * kPart + tid * R * K;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < K; ++j) {
          a.part_d[o + r * K + j] = bd[r][j];
          a.part_i[o + r * K + j] = bi[r][j];
        }
    }
    __threadfence();
    consumer_sync();
    if (tid == 0) s.last = atomicAdd(a.tickets + t, 1u) == (unsigned)(bl - bf);
    consumer_sync();
    if (!s.last) continue;
    __threadfence();
    if (tid == 0) a.tickets[t] = 0u;   // ready for the next launch on this stream
    // the first piece's lists, then each later piece's entries in order:
    // strict-less insertion keeps an earlier piece's entry ahead of an
    // equal later one
    for (long pb = bf; pb <= bl; ++pb) {
      const long o = part_slot(cut, pb, t) * kPart + tid * R * K;
      if (pb == bf) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < K; ++j) {
            bd[r][j] = __ldcg(a.part_d + o + r * K + j);
            bi[r][j] = __ldcg(a.part_i + o + r * K + j);
          }
        continue;
      }
      // loads of RB queries' entries fly together (at most 32 pairs of registers)
      constexpr int RB = R * K <= 32 ? R : R / 2;
#pragma unroll
      for (int r0 = 0; r0 < R; r0 += RB) {
        float pd[RB][K];
        int pi[RB][K];
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int j = 0; j < K; ++j) {
            pd[r][j] = __ldcg(a.part_d + o + (r0 + r) * K + j);
            pi[r][j] = __ldcg(a.part_i + o + (r0 + r) * K + j);
          }
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int j = 0; j < K; ++j) insert<K>(bd[r0 + r], bi[r0 + r], pd[r][j], pi[r][j]);
      }
    }
    write_out<K, R>(a, q0, q2, bd, bi);
  }
}

// r = 2 for every k; r = 4 and 8 at k = 4 only (the stage-1 k, where
// tools/decompose_knn sweeps r)
template <int K>
const void* kernel_for_r(int r) {
  if (r == 2) return (const void*)knn_topk_kernel<K, 2>;
  if constexpr (K == 4) {
    if (r == 4) return (const void*)knn_topk_kernel<K, 4>;
    if (r == 8) return (const void*)knn_topk_kernel<K, 8>;
  }
  return nullptr;
}

const void* kernel_for(int k, int r) {
  switch (k) {
    case 1: return kernel_for_r<1>(r);
    case 2: return kernel_for_r<2>(r);
    case 3: return kernel_for_r<3>(r);
    case 4: return kernel_for_r<4>(r);
    case 5: return kernel_for_r<5>(r);
    case 6: return kernel_for_r<6>(r);
    case 7: return kernel_for_r<7>(r);
    case 8: return kernel_for_r<8>(r);
    default: return nullptr;
  }
}

}  // namespace

// The SMs and the blocks of the (k, r) kernel an SM holds, into out2[0..1];
// 0 or a CUDA error code (1 for a (k, r) it was not built for)
extern "C" int knn_topk_occupancy(int k, int r, int* out2) {
  const void* fn = kernel_for(k, r);
  if (fn == nullptr) return 1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&out2[0], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out2[1], fn, kThreads, 0);
  return (int)e;
}

// Launches the prologue and the k-NN over `grid` blocks (the SMs x the
// blocks an SM holds: one wave).  Returns cudaGetLastError() after each
// launch; 1 (cudaErrorInvalidValue) for arguments it does not take.
//   q: [nq, 3] f32;  pts: [np, 3] f32;  valid: [np] bool (one byte each)
//   staged: float4 [np + 4], 16-byte aligned;  sid: int32 [np + 8], 16-byte
//   aligned;  n_live: int32 [1];  part_d / part_i: f32 / int32
//   [2 grid * 128 r * k];  tickets: zeroed uint32 [ceil(nq / (128 r))],
//   left zeroed
//   out_d: [nq, k] f32 squared distances;  out_i: [nq, k] int64 ids
extern "C" int knn_topk(const float* q, int nq, const float* pts, const uint8_t* valid, int np,
                        int k, int r, int grid, float* staged, int* sid, int* n_live,
                        float* part_d, int* part_i, unsigned* tickets, float* out_d,
                        long long* out_i, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const void* fn = kernel_for(k, r);
  if (fn == nullptr || nq < 0 || np < 0 || grid < 1 ||
      (reinterpret_cast<uintptr_t>(staged) & 15) || (reinterpret_cast<uintptr_t>(sid) & 15))
    return 1;
  if (nq == 0) return (int)cudaGetLastError();
  const int stage_blocks = np > 0 ? (np + kStageThreads - 1) / kStageThreads : 1;
  knn_stage_kernel<<<stage_blocks, kStageThreads, 0, stream>>>(
      pts, valid, np, reinterpret_cast<float4*>(staged), sid, n_live);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = (nq + kConsumers * r - 1) / (kConsumers * r);
  Args a{q, nq, tiles, reinterpret_cast<const float4*>(staged), sid, n_live, part_d, part_i,
         tickets, out_d, out_i};
  void* args[] = {&a};
  cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, 0, stream);
  return (int)cudaGetLastError();
}
