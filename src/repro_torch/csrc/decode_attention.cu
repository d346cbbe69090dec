// Single-token GQA decode attention against the model-layout KV cache: each
// (kv head, sample) split over a number of blocks that grows with the cache,
// K/V tiles staged by asynchronous copies, both products on the tensor cores.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py,
//   function `decode_attention` (Pallas TPU kernel, grid (B, Hkv, nK), online
//   softmax carried in VMEM scratch across the sequential k-tile axis, the G
//   query heads of a kv head as one [G, D] block).
//
// What bounds it on the H100: bytes. A call reads every valid K and V row
//   once, 2 * len * Hkv * D * 2 bytes a sample, and does 4 * G flops per
//   element read, far below the ~295 flops a byte where the tensor cores
//   would be the limit. hymba's long_500k global cache (B 1, Hkv 5, 524,288
//   positions) is 671 MB, 0.200 ms at 3.35 TB/s; smollm's decode_32k (B 32)
//   0.296 ms. At the serving shapes (a few hundred positions) the bytes take
//   well under a microsecond and a launch waits on latency: the longest chain
//   of dependent loads in any one block, and the merge.
//
// What held the earlier design (one cluster of at most 8 blocks a (kv head,
//   sample), lanes loading K/V rows into registers for fp32 FMAs on the CUDA
//   cores) back at the long shapes:
//   1. The split was capped at 8 blocks a (kv head, sample): long_500k ran
//      40 blocks on 132 SMs, each walking 16.8 MB, at 0.15 TB/s.
//   2. Few bytes in flight: each lane group held 4 K/V rows (2 where G > 4),
//      nothing was staged, so a block waited a memory latency every few rows.
//   3. Work grew with G: per-row shuffle reductions per head on the CUDA
//      cores, and above 8 heads a kv head the heads were cut into groups
//      that each read the kv head's K/V again.
//
// Design:
//   1. The split grows with the work. The caller picks P blocks per (kv
//      head, sample) from static shapes alone (B, Hkv, D, Smax, window;
//      never the lengths, so a CUDA graph stays valid as lengths change;
//      kernels/decode_attention/decode_attention.py::splits). Up to 32,768
//      positions P <= 8 cuts the cache into slices of at most 128 positions
//      (two tiles, both in flight at once), fewer where the grid would pass
//      one wave of resident blocks (a second wave of short blocks costs
//      more than longer slices), and never more than 4,096 positions a
//      block. Past that P grows to fill the card twice over with blocks of
//      at most 8,192 positions: long_500k takes 64 blocks a (kv head,
//      sample), 320 in all. Block r takes the r-th even slice of its
//      sample's own valid range [max(0, len - window), min(len, Smax)), so
//      work balances per sample whatever Smax is, and masked positions are
//      never read.
//      Where P <= 8 the P blocks are one thread-block cluster and merge
//      their partials (m, l, acc) through distributed shared memory in the
//      same launch: after cluster.sync() each rank merges an even share of
//      the G * D outputs from every block's partial; a second cluster.sync()
//      keeps the partials alive until all have read them. Above 8 each block
//      writes its partial to an fp32 workspace the wrapper allocates, and a
//      second, small launch merges the P partials of each (kv head, sample).
//      That split's grid puts the kv heads along x, so the blocks that start
//      together read the same positions of every head (one row of Hkv * D
//      bf16 a position): 0.6-2.5 % faster at long_500k's P = 64-256 than
//      slices along x (scripts/decode_checkouts.py, PERF.md).
//      Both merges run in a fixed order: two launches on the same inputs give
//      the same bits.
//   2. K/V tiles of 64 keys go into a ring of 4 stages in shared memory (3
//      at D = 128) by cp.async, 16 bytes a copy (4 bytes where D % 8 != 0 or
//      a K/V pointer is not 16-byte aligned: a template instance of the same
//      kernel). Three tiles are in flight while one is used, 48 KB a block
//      at D = 64, and two or three blocks share an SM, so the SM keeps about
//      100 KB in flight where the card needs ~32 KB an SM to cover its
//      memory latency. Positions past the slice are zero-filled by the copy
//      (no bytes read), so every shared row a product reads is finite. Rows
//      are padded to D + 8 bf16 so ldmatrix reads them without bank
//      conflicts; D not a multiple of 16 is zero-padded to the next
//      instance's width (16, 32, 64 or 128). cp.async rather than TMA: a
//      kv head's row is D * 2 contiguous bytes, one bulk copy each, and
//      cp.async gives the same depth of copies in flight with the zero fill
//      and the 4-byte path in one mechanism.
//      The 16-byte copies carry the L2::128B prefetch hint: 1.1-1.6 % off
//      the long caches, the serving shapes within 1 %
//      (scripts/decode_checkouts.py, PERF.md); L2::256B measured slower.
//   3. Both products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//      sums). The G <= 16 query heads of the kv head are the 16 M rows
//      (zero past G), so one block holds all of them and reads each K/V row
//      once; there are no head groups and no per-head register limit. A
//      64-key tile is four warps' 16 keys: the N of Q K^T (K through
//      ldmatrix) and the K of P V (V through ldmatrix.trans), as
//      flash_attention.cu does. Each warp keeps an online-softmax state per
//      head in registers; the warps merge through shared memory at the end.
//      mma.sync and not wgmma: a decode block has at most 16 query rows and
//      wgmma's A tile has 64, so three quarters of every wgmma would be
//      padding, and the kernel is bound by bytes, not by the mma rate.
//   Rounding: q * scale is rounded to bf16 before the products, as the jnp
//   path (`models/common.py::attention_decode`) does; scores, m, l and acc
//   are fp32 and l sums the unrounded p; p is rounded to bf16 only as the A
//   operand of P V (the jnp path rounds the normalised p to bf16; the
//   difference is inside the stated tolerance). A row with no valid key
//   (lengths == 0) outputs exactly 0. Any Smax, G <= 16, even D <= 128.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileKeys = 16 * kWarps;  // keys a ring stage holds, 16 a warp
constexpr int kRows = 16;               // M rows of the products: query heads
constexpr int kPad = 8;                 // bf16 of padding a shared-memory row
constexpr int kMaxG = 16;
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kMaxSplits = 256;         // blocks a (kv head, sample), workspace merge
constexpr int kMergeThreads = 256;

template <int DP>
__host__ __device__ constexpr int stages() { return DP <= 64 ? 4 : 3; }

// dynamic shared memory: the q tile, then the ring's K and V stages
template <int DP>
__host__ __device__ constexpr int smem_bytes() {
  return (kRows + 2 * stages<DP>() * kTileKeys) * (DP + kPad) * 2;
}

// the merge's fp32 scratch, aliased on the ring once the loop is done:
// the warps' states [kWarps][G][D] + m, l [kWarps][G]; the block's partial
// [G][D] + m, l [G]; the cluster's merge weights [kMaxCluster][G]
template <int DP>
__host__ __device__ constexpr int scratch_bytes() {
  return ((kWarps + 1) * kMaxG * DP + (2 * kWarps + 2 + kMaxCluster) * kMaxG) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// VW bf16 global -> shared, asynchronously; zero-filled (nothing read) where
// !ok; the 16-byte copies with the L2::128B prefetch hint (header, item 2)
template <int VW>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  if constexpr (VW == 8) {
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lane l addresses row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Merge factor of a partial with running max m into one with max m_new.
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m_new == -INFINITY ? 0.f : __expf(m - m_new);
}

// DP: D padded to the instance's width (a multiple of 16); VW: bf16 a copy
// (8: 16 bytes; 2: 4 bytes). Block r of (kv head h, sample b) takes the
// r-th of P even slices of the sample's valid range. ws null: grid (P, Hkv,
// B), the P blocks are one cluster (P <= 8; P = 1 launches without the
// cluster attribute) and merge through distributed shared memory; else grid
// (Hkv, P, B), and each writes its partial to ws for decode_merge_kernel.
template <int DP, int VW>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 3 : 2)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ ws,
                        int Smax, int Hkv, int G, int D, int window, float scale) {
  constexpr int NS = stages<DP>();
  constexpr int LD = DP + kPad;        // shared-memory row, bf16
  constexpr int KS = DP / 16;          // k steps of Q K^T, pairs of P V's n tiles
  constexpr int DN = DP / 8;           // n tiles of P V
  constexpr int CH = DP / VW;          // copies a padded row
  static_assert(scratch_bytes<DP>() <= 2 * NS * kTileKeys * LD * 2,
                "the merge scratch must fit in the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][LD]
  __nv_bfloat16* Ks = Qs + kRows * LD;                              // [NS][kTileKeys][LD]
  __nv_bfloat16* Vs = Ks + NS * kTileKeys * LD;                     // [NS][kTileKeys][LD]

  // a cluster's blocks are consecutive in x; the workspace split puts the
  // kv heads there instead, so the blocks that start together read the
  // same positions of adjacent heads (one row of Hkv * D bf16)
  const int rank = ws != nullptr ? blockIdx.y : blockIdx.x;
  const int P = ws != nullptr ? gridDim.y : gridDim.x;
  const int h = ws != nullptr ? blockIdx.x : blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int Hq = Hkv * G;

  // this block's slice of the sample's valid positions
  const int len = lengths[b];
  const int hi = min(len, Smax);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int n = max(0, hi - lo);
  const int per = (n + P - 1) / P;
  const int s0 = lo + rank * per;
  const int s1 = min(s0 + per, hi);
  const int ntiles = s1 > s0 ? (s1 - s0 + kTileKeys - 1) / kTileKeys : 0;

  const size_t kv_row = (size_t)Hkv * D;  // bf16 between two positions
  const __nv_bfloat16* kh = k + ((size_t)b * Smax * Hkv + h) * D;
  const __nv_bfloat16* vh = v + ((size_t)b * Smax * Hkv + h) * D;
  auto load_tile = [&](int t) {
    const int t0 = s0 + t * kTileKeys;
    __nv_bfloat16* kd = Ks + (t % NS) * kTileKeys * LD;
    __nv_bfloat16* vd = Vs + (t % NS) * kTileKeys * LD;
    for (int c = tid; c < kTileKeys * CH; c += kThreads) {
      const int j = c / CH;
      const int col = (c - j * CH) * VW;
      if (col >= D) continue;                 // the zero padding past D
      const bool ok = t0 + j < s1;
      const size_t off = (size_t)(ok ? t0 + j : s0) * kv_row + col;
      cp_async<VW>(kd + j * LD + col, kh + off, ok);
      cp_async<VW>(vd + j * LD + col, vh + off, ok);
    }
  };

  const int gq = lane >> 2;   // fragment rows gq and gq + 8: query heads
  const int tq = lane & 3;
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  if (ntiles > 0) {  // uniform across the block
#pragma unroll
    for (int t = 0; t < NS - 1; ++t) {
      if (t < ntiles) load_tile(t);
      cp_async_commit();
    }
    // while the first tiles are in flight: q * scale rounded to bf16, rows
    // past G and columns past D zero; the ring's columns past D zero once
    for (int e = tid; e < kRows * DP; e += kThreads) {
      const int r = e / DP;
      const int c = e - r * DP;
      float x = 0.f;
      if (r < G && c < D)
        x = __bfloat162float(q[((size_t)b * Hq + (size_t)h * G + r) * D + c]) * scale;
      Qs[r * LD + c] = __float2bfloat16(x);
    }
    if (D < DP) {
      const int pc = DP - D;
      for (int e = tid; e < 2 * NS * kTileKeys * pc; e += kThreads) {
        const int row = e / pc;
        Ks[row * LD + D + (e - row * pc)] = __float2bfloat16(0.f);
      }
    }
    __syncthreads();

    // ldmatrix addressing: lane l gives row (l & 7) of matrix (l >> 3)
    const int mi = lane >> 3;
    const int mr = lane & 7;
    uint32_t qf[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldmatrix_x4(qf[ks], Qs + ((mi & 1) * 8 + mr) * LD + ks * 16 + (mi >> 1) * 8);

    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<NS - 2>();   // this thread's copies of tile t landed
      __syncthreads();           // everyone's; and everyone is done with t - 1
      if (t + NS - 1 < ntiles) load_tile(t + NS - 1);  // into t - 1's stage
      cp_async_commit();

      const int buf = t % NS;
      const __nv_bfloat16* kb = Ks + (buf * kTileKeys + warp * 16) * LD;
      const __nv_bfloat16* vb = Vs + (buf * kTileKeys + warp * 16) * LD;

      // S = (q * scale) K^T: 16 heads x the warp's 16 keys
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kf[4];   // b0, b1 of the keys' two n tiles
        ldmatrix_x4(kf, kb + ((mi >> 1) * 8 + mr) * LD + ks * 16 + (mi & 1) * 8);
        mma_bf16(s[0], qf[ks], kf[0], kf[1]);
        mma_bf16(s[1], qf[ks], kf[2], kf[3]);
      }

      // positions past the slice are masked; online softmax per head
      const int key0 = s0 + t * kTileKeys + warp * 16 + 2 * tq;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (key0 + nn * 8 + (e & 1) >= s1) s[nn][e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nn][e]);
        }
      }
      float base[2], corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m_run[hh], mx[hh]);
        // no valid key yet: every exponent exp(-inf) = 0, never -inf - -inf
        base[hh] = m_new == -INFINITY ? 0.f : m_new;
        corr[hh] = __expf(m_run[hh] - base[hh]);
        m_run[hh] = m_new;
      }
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(s[nn][e] - base[e >> 1]);
          rsum[e >> 1] += p;
          s[nn][e] = p;
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * corr[hh] + rsum[hh];
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        o[dn][0] *= corr[0];
        o[dn][1] *= corr[0];
        o[dn][2] *= corr[1];
        o[dn][3] *= corr[1];
      }

      // O += P V, P packed to bf16 as the A operand (16 heads x 16 keys)
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t vf[4];   // b0, b1 of d tiles 2 dp and 2 dp + 1
        ldmatrix_x4_trans(vf, vb + ((mi & 1) * 8 + mr) * LD + dp * 16 + (mi >> 1) * 8);
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    cp_async_wait<0>();  // only empty groups remain; the ring is free
  }
  __syncthreads();       // every warp is done with the ring

  // the warps' states into shared memory, aliased on the ring
  float* wacc = reinterpret_cast<float*>(Ks);
  float* wm = wacc + kWarps * G * D;
  float* wl = wm + kWarps * G;
  float* pacc = wl + kWarps * G;
  float* pm = pacc + G * D;
  float* pl = pm + G;
  float* wts = pl + G;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = gq + hh * 8;
    if (r < G) {
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const int c = dn * 8 + 2 * tq;   // D is even: c < D holds c + 1 too
        if (c < D) {
          wacc[(warp * G + r) * D + c] = o[dn][2 * hh];
          wacc[(warp * G + r) * D + c + 1] = o[dn][2 * hh + 1];
        }
      }
      if (tq == 0) {
        wm[warp * G + r] = m_run[hh];
        wl[warp * G + r] = l;
      }
    }
  }
  __syncthreads();

  // the block's partial: the warps merged in a fixed order
  const size_t pair = (size_t)b * Hkv + h;
  const size_t nws = (size_t)gridDim.z * Hkv * P;  // partials in the workspace
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = rescale(wm[w * G + g], mx);
      den += wl[w * G + g] * f;
      num += wacc[w * G * D + idx] * f;
    }
    if (ws != nullptr) {
      // workspace: acc [B][Hkv][P][G][D], then m and l [B][Hkv][P][G]
      const size_t part = pair * P + rank;
      ws[part * G * D + idx] = num;
      if (idx - g * D == 0) {
        ws[nws * G * D + part * G + g] = mx;
        ws[nws * G * (D + 1) + part * G + g] = den;
      }
    } else {
      pacc[idx] = num;
      if (idx - g * D == 0) {
        pm[g] = mx;
        pl[g] = den;
      }
    }
  }
  if (ws != nullptr) return;

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partial is written
  // Each rank merges and writes an even share of the G * D outputs, so the
  // remote reads spread over the cluster: first every block's (m, l) per
  // head, as the weights exp(m_r - max) / den, then the share's partial
  // sums, all remote loads of a thread independent of each other.
  if (tid < G) {
    const int g = tid;
    float mr[kMaxCluster], lsum[kMaxCluster];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      mr[r] = -INFINITY;
      lsum[r] = 0.f;
      if (r < P) {
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
  const int share = (G * D + P - 1) / P;
  const int end = min(G * D, (rank + 1) * share);
  for (int idx = rank * share + tid; idx < end; idx += kThreads) {
    const int g = idx / D;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < P) acc += cluster.map_shared_rank(pacc, r)[idx] * wts[r * G + g];
    out[((size_t)b * Hq + (size_t)h * G) * D + idx] = __float2bfloat16(acc);
  }
  cluster.sync();  // no block leaves while another still reads its memory
}

// The workspace merge: grid (ceil(G * D / kMergeThreads), Hkv, B). Each block
// turns the P partials' (m, l) of its (kv head, sample) into weights
// exp(m_p - max) / den (one warp a head; lanes stride the partials, then a
// butterfly of shuffles: a fixed order), then sums its share of the G * D
// outputs over the partials in order.
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                    int B, int Hkv, int G, int D, int P) {
  __shared__ float wts[kMaxSplits * kMaxG];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t pair = (size_t)b * Hkv + h;
  const size_t nws = (size_t)B * Hkv * P;
  const float* acc = ws + pair * P * G * D;
  const float* m = ws + nws * G * D + pair * P * G;
  const float* l = ws + nws * G * (D + 1) + pair * P * G;
  for (int g = warp; g < G; g += kMergeThreads / 32) {
    float mx = -INFINITY;
    for (int p = lane; p < P; p += 32) mx = fmaxf(mx, m[p * G + g]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float den = 0.f;
    for (int p = lane; p < P; p += 32) den += l[p * G + g] * rescale(m[p * G + g], mx);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
    // no valid key in the sample: every weight 0, so the output is 0
    const float inv = den > 0.f ? 1.f / den : 0.f;
    for (int p = lane; p < P; p += 32) wts[p * G + g] = rescale(m[p * G + g], mx) * inv;
  }
  __syncthreads();
  const int idx = blockIdx.x * kMergeThreads + threadIdx.x;
  if (idx >= G * D) return;
  const int g = idx / D;
  float o = 0.f;
#pragma unroll 8
  for (int p = 0; p < P; ++p) o += acc[(size_t)p * G * D + idx] * wts[p * G + g];
  out[(pair * G) * D + idx] = __float2bfloat16(o);
}

template <int DP, int VW>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, float* ws, int B, int Smax, int Hkv, int G, int D,
           int window, float scale, int splits, int smem, cudaStream_t s) {
  if (smem != smem_bytes<DP>()) return (int)cudaErrorInvalidValue;
  // above 48 KB the kernel must be allowed the memory, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<DP, VW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<DP>());
  if (attr != cudaSuccess) return (int)attr;
  const bool cluster = splits <= kMaxCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = cluster ? dim3(splits, Hkv, B) : dim3(Hkv, splits, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = splits;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = cluster && splits > 1 ? 1 : 0;  // a cluster of one costs ~1 us more
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_attention_kernel<DP, VW>,
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), cluster ? nullptr : ws, Smax, Hkv, G, D,
      window, scale);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess || cluster) return (int)err;
  decode_merge_kernel<<<dim3((G * D + kMergeThreads - 1) / kMergeThreads, Hkv, B),
                        kMergeThreads, 0, s>>>(
      ws, static_cast<__nv_bfloat16*>(out), B, Hkv, G, D, splits);
  return (int)cudaGetLastError();
}

template <int VW>
int launch_width(const void* q, const void* k, const void* v, const void* lengths,
                 void* out, float* ws, int B, int Smax, int Hkv, int G, int D,
                 int window, float scale, int splits, int smem,
                 cudaStream_t s) {
  if (D <= 16) return launch<16, VW>(q, k, v, lengths, out, ws, B, Smax, Hkv, G, D, window, scale, splits, smem, s);
  if (D <= 32) return launch<32, VW>(q, k, v, lengths, out, ws, B, Smax, Hkv, G, D, window, scale, splits, smem, s);
  if (D <= 64) return launch<64, VW>(q, k, v, lengths, out, ws, B, Smax, Hkv, G, D, window, scale, splits, smem, s);
  return launch<128, VW>(q, k, v, lengths, out, ws, B, Smax, Hkv, G, D, window, scale, splits, smem, s);
}

}  // namespace

// q [B, Hq, D], k/v [B, Smax, Hkv, D] bf16 contiguous, k and v 4-byte
// aligned, lengths [B] int32, out [B, Hq, D] bf16, G = Hq / Hkv <= 16, even
// D <= 128. Launch geometry from the caller: splits, the blocks per (kv head,
// sample), 1..256 (<= 8: one cluster, one launch; above: a second launch
// merges through ws, which then holds B * Hkv * splits * G * (D + 2) floats),
// and smem, the dynamic shared memory of D's instance
// ((16 + 2 * stages * 64) * (DP + 8) * 2 bytes); anything else is refused.
// Returns the cudaError_t of the launches.
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* out, void* ws, int B, int Smax,
                                     int Hkv, int G, int D, int window,
                                     float scale, int splits, int smem,
                                     void* stream) {
  if (G < 1 || G > kMaxG || D < 2 || D > 128 || (D & 1) || splits < 1 ||
      splits > kMaxSplits || (splits > kMaxCluster && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const uintptr_t kv = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  if (kv % 4) return (int)cudaErrorMisalignedAddress;
  if (B == 0 || Hkv == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (D % 8 == 0 && kv % 16 == 0)
    return launch_width<8>(q, k, v, lengths, out, w, B, Smax, Hkv, G, D, window, scale, splits, smem, s);
  return launch_width<2>(q, k, v, lengths, out, w, B, Smax, Hkv, G, D, window, scale, splits, smem, s);
}
