// Single-token GQA decode attention against the model-layout KV cache, each
// sample's positions split across the blocks of one thread-block cluster.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py,
//   function `decode_attention` (Pallas TPU kernel, grid (B, Hkv, nK), online
//   softmax carried in VMEM scratch across the sequential k-tile axis).
//
// What bounds it on the H100: bytes. A decode step reads every valid K and V
//   row once (2 * B * len * Hkv * D * 2 bytes) and does 4 * G flops per
//   element read, far below the ~295 flops/byte the tensor cores need. At the
//   serving shapes (B * Hkv = 40, a few hundred positions) that is well under
//   a microsecond of bytes, so what a launch waits for is latency: the
//   longest chain of dependent loads and reductions in any one block. One
//   block per (kv head, sample) would put 40 blocks on 132 SMs, each walking
//   a whole sample, and the longest sample would set the time.
//
// Design: one launch, grid (C, Hkv, B) with cluster dims (C, 1, 1). The C
//   blocks of a cluster share one (kv head, sample) and each takes an even
//   slice of that sample's own valid range [max(0, len - window),
//   min(len, Smax)), so the work balances per sample whatever Smax is;
//   masked positions are never read. A block is two warps, four where its
//   slice is longer than 64 positions (chosen by the caller). D / 8 lanes
//   own one K/V row and read it with 16-byte loads (at D = 64, 8 lanes a
//   row and 4 rows per warp per load; the dot product reduces over 3 shuffle
//   steps), and each lane group keeps 4 rows in flight (2 where G > 4,
//   whose per-head registers are twice as many); D not a multiple of 8, or
//   an address not 16-byte aligned, takes 4-byte loads with up to a whole
//   warp a row in the same kernel. Each lane group applies its rows
//   to all G query heads of the kv head at once, so each K/V row leaves
//   device memory once per step however many heads share it (the GQA saving
//   the TPU kernel gets from its [G, D] block). Every lane group keeps an
//   fp32 online-softmax state (m, l, acc) per head; the groups of a warp
//   merge by shuffles, the warps of a block through shared memory into the
//   block's partial (m, l, acc[G][D]). After cluster.sync() the blocks read
//   each other's partials through distributed shared memory
//   (cluster.map_shared_rank): each rank merges an even share of the G * D
//   outputs and writes it, so the remote loads spread over the cluster and
//   none waits on another; a second cluster.sync()
//   keeps every block's shared memory alive until all have read it. No
//   workspace, no atomics, no second launch; the caller picks C
//   (<= 8, the portable cluster size; C = 1 launches without the cluster
//   attribute). Any Smax, G <= 16, even D <= 128. A row
//   with no valid key (lengths == 0) outputs exactly 0.
//   Above 8 query heads a kv head (hymba at model = 2: 26 / 2 heads, G = 13)
//   the q heads of a kv head are cut into NG = ceil(G / 8) even groups
//   (13 -> 7 + 6), one grid row each (grid (C, Hkv * NG, B)): each block
//   keeps the registers of at most 8 heads, as every block did before, at
//   the price of reading the kv head's K/V rows once per group. Where
//   G <= 8, NG = 1 and the launch is the one it always was.
//   Rounding: q * scale is rounded to bf16 before the dot products, as the
//   jnp path (`models/common.py::attention_decode`) does; scores, m, l and
//   acc are fp32 and p stays fp32 (the jnp path rounds p to bf16 before PV;
//   the difference is inside the stated tolerance).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 4;  // a block is 1, 2 or 4 warps, chosen by the caller
constexpr int kMaxG = 16;
constexpr int kBlockG = 8;  // the most query heads one block takes
constexpr int kMaxCluster = 8;

// VW bf16 at p as floats (VW = 8: one 16-byte load; VW = 2: one 4-byte load)
template <int VW>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  if constexpr (VW == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  } else {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    f[0] = x.x;
    f[1] = x.y;
  }
}

// Merge factor of a partial with running max m into one with max m_new.
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m_new == -INFINITY ? 0.f : __expf(m - m_new);
}

// VW: bf16 a vector load; NV: vectors a lane holds; MG: the most query heads
// a block may take (4 or 8: the registers per head are fixed at compile
// time). Gall: query heads a kv head; NG: the groups they are cut into. lpr lanes (a power of two, <= 32) own one K/V row: lane r of a row
// group holds columns (v * lpr + r) * VW .. + VW for v < NV.
template <int VW, int NV, int MG>
__global__ void __launch_bounds__(kMaxWarps * 32)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out,
                        int Smax, int Hkv, int Gall, int NG, int D, int window,
                        int lpr, float scale) {
  constexpr int E = VW * NV;        // columns a lane holds
  constexpr int U = MG <= 4 ? 4 : 2;  // rows in flight per lane group
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int h = blockIdx.y / NG;      // the kv head
  const int Gb = (Gall + NG - 1) / NG;  // q heads a group
  const int g0 = (blockIdx.y % NG) * Gb;  // this block's first q head of h
  const int G = min(Gb, Gall - g0);     // and its count
  const int b = blockIdx.z;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rpw = 32 / lpr;           // rows a warp reads at once
  const int lr = lane & (lpr - 1);
  const int ngrp = nwarps * rpw;      // row groups in the block
  const int Hq = Hkv * Gall;

  // this block's slice of the sample's valid positions
  const int len = lengths[b];
  const int hi = min(len, Smax);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int n = max(0, hi - lo);
  const int per = (n + C - 1) / C;
  const int s0 = lo + rank * per;
  const int s1 = min(s0 + per, hi);

  int col[NV];
#pragma unroll
  for (int u = 0; u < NV; ++u) col[u] = (u * lpr + lr) * VW;

  float qf[MG][E];
  float acc[MG][E];
  float m[MG], l[MG];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) qf[g][e] = acc[g][e] = 0.f;
    if (g < G) {
      const __nv_bfloat16* qr = q + ((size_t)b * Hq + (size_t)h * Gall + g0 + g) * D;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        if (col[u] < D) {
          load_vec<VW>(qr + col[u], &qf[g][u * VW]);
#pragma unroll
          for (int i = 0; i < VW; ++i)
            qf[g][u * VW + i] = __bfloat162float(__float2bfloat16(qf[g][u * VW + i] * scale));
        }
      }
    }
  }

  // U rows in flight per lane group: rows j0 + grp + t * ngrp; the loop
  // bound is uniform across the warp, so the shuffles see every lane
  const int grp_in_warp = lane / lpr;
  for (int j0 = s0 + warp * rpw; j0 < s1; j0 += U * ngrp) {
    float kf[U][E], vf[U][E];
    bool ok[U];
#pragma unroll
    for (int t = 0; t < U; ++t) {
      const int j = j0 + grp_in_warp + t * ngrp;
      ok[t] = j < s1;
      const size_t row = (((size_t)b * Smax + j) * Hkv + h) * D;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        if (ok[t] && col[u] < D) {
          load_vec<VW>(k + row + col[u], &kf[t][u * VW]);
          load_vec<VW>(v + row + col[u], &vf[t][u * VW]);
        } else {
#pragma unroll
          for (int i = 0; i < VW; ++i) kf[t][u * VW + i] = vf[t][u * VW + i] = 0.f;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g < G) {
        float s[U];
#pragma unroll
        for (int t = 0; t < U; ++t) {
          s[t] = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) s[t] = fmaf(qf[g][e], kf[t][e], s[t]);
        }
        for (int o = lpr >> 1; o > 0; o >>= 1) {
#pragma unroll
          for (int t = 0; t < U; ++t) s[t] += __shfl_xor_sync(0xffffffffu, s[t], o);
        }
        float m_new = m[g];
#pragma unroll
        for (int t = 0; t < U; ++t) {
          if (!ok[t]) s[t] = -INFINITY;
          m_new = fmaxf(m_new, s[t]);
        }
        if (m_new == -INFINITY) continue;  // no row valid, none before
        const float corr = __expf(m[g] - m_new);
        float p[U];
        float psum = 0.f;
#pragma unroll
        for (int t = 0; t < U; ++t) {
          p[t] = __expf(s[t] - m_new);
          psum += p[t];
        }
        l[g] = l[g] * corr + psum;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float a = acc[g][e] * corr;
#pragma unroll
          for (int t = 0; t < U; ++t) a = fmaf(p[t], vf[t][e], a);
          acc[g][e] = a;
        }
        m[g] = m_new;
      }
    }
  }

  // merge the row groups of the warp (lanes lpr, 2 lpr, ... apart)
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g < G) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lother = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float m_new = fmaxf(m[g], mo);
        const float fa = rescale(m[g], m_new), fb = rescale(mo, m_new);
        l[g] = l[g] * fa + lother * fb;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] = acc[g][e] * fa +
                      __shfl_xor_sync(0xffffffffu, acc[g][e], o) * fb;
        m[g] = m_new;
      }
    }
  }

  // shared memory: the warps' states [nwarps][G][D] + m, l [nwarps][G]; the
  // block's partial [G][D] + m, l [G], which the whole cluster reads; the
  // cluster's merge weights [kMaxCluster][G]
  extern __shared__ float smem[];
  float* wacc = smem;
  float* wm = wacc + nwarps * G * D;
  float* wl = wm + nwarps * G;
  float* pacc = wl + nwarps * G;
  float* pm = pacc + G * D;
  float* pl = pm + G;
  float* wts = pl + G;
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (g < G) {
      if (lane < lpr) {
#pragma unroll
        for (int u = 0; u < NV; ++u)
          if (col[u] < D)
#pragma unroll
            for (int i = 0; i < VW; ++i)
              wacc[(warp * G + g) * D + col[u] + i] = acc[g][u * VW + i];
      }
      if (lane == 0) {
        wm[warp * G + g] = m[g];
        wl[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    float mx = -INFINITY;
    for (int w = 0; w < nwarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      const float f = rescale(wm[w * G + g], mx);
      den += wl[w * G + g] * f;
      num += wacc[w * G * D + idx] * f;
    }
    pacc[idx] = num;
    if (idx - g * D == 0) {
      pm[g] = mx;
      pl[g] = den;
    }
  }

  cluster.sync();  // every block's partial is written
  // Each rank merges and writes an even share of the G * D outputs, so the
  // remote reads spread over the cluster: first every block's (m, l) per
  // head, as the weights exp(m_r - max) / den, then the share's partial
  // sums, all remote loads of a thread independent of each other.
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mr[kMaxCluster], lsum[kMaxCluster];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      mr[r] = -INFINITY;
      lsum[r] = 0.f;
      if (r < C) {
        mr[r] = cluster.map_shared_rank(pm, r)[g];
        lsum[r] = cluster.map_shared_rank(pl, r)[g];
      }
      mx = fmaxf(mx, mr[r]);
    }
    float den = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) den += lsum[r] * rescale(mr[r], mx);
    // no valid key in the sample: every weight 0, so the output is 0
    const float inv = den > 0.f ? 1.f / den : 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) wts[r * G + g] = rescale(mr[r], mx) * inv;
  }
  __syncthreads();
  const int share = (G * D + C - 1) / C;
  const int end = min(G * D, (rank + 1) * share);
  for (int idx = rank * share + threadIdx.x; idx < end; idx += blockDim.x) {
    const int g = idx / D;
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) o += cluster.map_shared_rank(pacc, r)[idx] * wts[r * G + g];
    out[((size_t)b * Hq + (size_t)h * Gall + g0) * D + idx] = __float2bfloat16(o);
  }
  cluster.sync();  // no block leaves while another still reads its memory
}

template <int VW, int NV, int MG>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int Smax, int Hkv, int G, int D, int window,
           int lpr, float scale, int cluster, int warps, cudaStream_t s) {
  const int NG = (G + kBlockG - 1) / kBlockG;
  const int Gb = (G + NG - 1) / NG;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, Hkv * NG, B);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes =
      (size_t)((warps + 1) * Gb * (D + 2) + kMaxCluster * Gb) * sizeof(float);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // a cluster of one costs ~1 us more
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_attention_kernel<VW, NV, MG>,
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), Smax, Hkv, G, NG, D, window, lpr, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Hq, D], k/v [B, Smax, Hkv, D] bf16 contiguous, lengths [B] int32,
// out [B, Hq, D] bf16, G = Hq / Hkv <= 16. Launch geometry from the caller:
// cluster, the blocks per (kv head, head group, sample), 1..8, and warps,
// the warps per block, 1, 2 or 4.
// Returns the cudaError_t of the launch.
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* out, int B, int Smax, int Hkv,
                                     int G, int D, int window, float scale,
                                     int cluster, int warps, void* stream) {
  if (G < 1 || G > kMaxG || D < 2 || D > 128 || (D & 1) || cluster < 1 ||
      cluster > kMaxCluster || (warps != 1 && warps != 2 && warps != kMaxWarps))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hkv == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool a16 = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  const int NG = (G + kBlockG - 1) / kBlockG;
  const bool g4 = (G + NG - 1) / NG <= 4;
  if (D % 8 == 0 && a16) {
    int lpr = 1;
    while (lpr * 8 < D) lpr <<= 1;
    return g4 ? launch<8, 1, 4>(q, k, v, lengths, out, B, Smax, Hkv, G, D, window, lpr, scale, cluster, warps, s)
              : launch<8, 1, 8>(q, k, v, lengths, out, B, Smax, Hkv, G, D, window, lpr, scale, cluster, warps, s);
  }
  if (D <= 64) {
    int lpr = 1;
    while (lpr * 2 < D) lpr <<= 1;
    return g4 ? launch<2, 1, 4>(q, k, v, lengths, out, B, Smax, Hkv, G, D, window, lpr, scale, cluster, warps, s)
              : launch<2, 1, 8>(q, k, v, lengths, out, B, Smax, Hkv, G, D, window, lpr, scale, cluster, warps, s);
  }
  return g4 ? launch<2, 2, 4>(q, k, v, lengths, out, B, Smax, Hkv, G, D, window, 32, scale, cluster, warps, s)
            : launch<2, 2, 8>(q, k, v, lengths, out, B, Smax, Hkv, G, D, window, 32, scale, cluster, warps, s);
}
