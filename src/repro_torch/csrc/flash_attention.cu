// Causal / windowed / non-causal GQA prefill attention with per-sample key
// lengths, on the tensor cores, in two instances that the binding picks from
// static shapes (kernels/flash_attention/flash_attention.py::pick).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py, function
//   `flash_attention` (Pallas TPU kernel, grid (B, Hq, nQ, nK), online softmax
//   carried in VMEM scratch across the sequential k-block axis, blocks above
//   the diagonal skipped). Both instances also take what the model path needs
//   and the Pallas kernel lacks: `kv_valid` (per-sample key length of a
//   ladder-padded prompt batch), `q_offset` (absolute position of query row
//   0, so Sq != Sk) and non-causal calls.
//
// What bounds it on the H100. A (row, key) pair costs 4 D tensor-core
//   operations (Q K^T and P V) and one exponent. At D = 64 that is 256
//   operations: an SM does 4,096 dense bf16 operations and 16 ex2 a clock,
//   so the exponents take as long as the products. At B 1, S 32,768, 15 / 5
//   heads the 8.05e9 pairs take 2.08 ms at 989 TFLOP/s and 2.08 ms of ex2
//   on 132 SMs at 1.83 GHz, against 42 MB of K and V: both bounds are
//   compute, and reaching past half of either needs the softmax of one warp
//   group to run beside another's products. Short rungs (S <= 256) are bound
//   by bytes and by the latency of a block's short walk.
//
// What held the earlier design (the mma instance below, then the only one)
//   back at long prompts, measured on the H100 (PERF.md §6): at S 32,768 it
//   took 9.77 ms (SDPA 4.42). Taking one part out at a time saved 9 % (no
//   per-score mask where a tile needs none), 15 % (a constant p for the
//   ex2), 19 % (no P V) and 0-6 % (blocks longest first): no single part,
//   so the rest, 8.1-9.1 ms, is its core: 64-row blocks (a K/V tile serves 64 (row, head) pairs, so
//   ~32 GB cross L2 for 42 MB of K and V), mma.sync fed by ldmatrix at 211
//   TFLOP/s, two buffers and a block-wide barrier twice a tile.
//
// The wgmma instance (namespace ws), wherever Sk > 128:
//   - Products on wgmma, m64nNk16, bf16 in, fp32 sums: S = Q K^T with q in
//     registers (the register-A form; q * scale rounded to bf16 first, as
//     before) and K from shared memory, K-major; O += P V with P from
//     registers (the S accumulator's layout is the A fragment's) and V from
//     shared memory through an MN-major (transposed) descriptor. Two consumer
//     warp groups of 64 M-rows: a work item is 128 (row, head in group)
//     pairs, twice the mma instance's, so each K/V tile serves twice the
//     rows.
//   - K and V by TMA from one producer thread into a 4-stage ring with full
//     and empty mbarriers: a 4-D tensor map over [B, Sk, Hkv, D], boxes of
//     (D, or 64-column pieces at D = 128; 1 head; the key tile; 1 sample),
//     swizzled as the descriptors read them (128 bytes at D >= 64, 64 at 32,
//     32 at 16). Keys past Sk arrive as zeros; keys past kv_valid are masked,
//     so every row a product reads is finite. setmaxnreg moves registers
//     from the producer (24) to the consumers (240). Key tiles of 128 (64 at
//     D = 128, whose O takes 64 registers a thread).
//   - Softmax beside the products (FA3's ping-pong): named barriers let the
//     two consumers issue their products in turn, so one's softmax runs
//     while the other's wgmma do; within a consumer the next tile's Q K^T is
//     issued before this tile's P V and both run behind the softmax. Scores
//     go to base 2 with one FFMA each (p = 2^(s log2 e - m log2 e)).
//   - Masks only where a tile needs one: per tile and consumer, from the
//     group's first and last row, a tile inside every row's [klo, khi) is
//     not masked; a diagonal, window-start or kv_valid-edge tile is, score by
//     score; a tile outside every row of the item is not loaded.
//   - Longest first: the work items are listed in groups of samples whose
//     K and V fit half of L2, in each group the causal M tiles descending,
//     every (kv head, sample) of a tile before the next (the blocks running
//     together then read K and V that L2 holds; 32 prompts of 32,768 tokens
//     listed tile-major read theirs from memory); a persistent grid of one block an SM (fewer where there are fewer items)
//     takes them in rounds, forwards and backwards in turn, so the blocks'
//     shares stay even, and the producer loads the next item's tiles, and
//     each consumer copies the next item's q rows (cp.async), while an item
//     ends. There is no split over keys: each output row is summed by one
//     block in one order, so launches and graph replays give the same bits.
//
// The mma instance (namespace mma, the earlier design), where every key fits
//   one wgmma key tile (Sk <= 128), so that the wgmma instance has nothing
//   to pipeline: one block per (64-row M tile, kv head, sample), four
//   warps, 64-key K/V tiles double-buffered by cp.async into rows padded to
//   D + 8 bf16 (so ldmatrix reads them without bank conflicts), both
//   products on mma.sync m16n8k16 with q and P in registers, every score
//   masked. There its twice as many blocks spread the work over more SMs.
//
// Rounding as in the jnp path in both instances: q * scale in bf16, scores,
//   m and l in fp32 (l sums the unrounded p), p rounded to bf16 only as the A
//   operand of P V, O summed in fp32 across key tiles and rounded to bf16
//   once. Rows with no valid key reproduce the jnp path's mean of V over the
//   key blocks it visits (store_row). Ragged edges (Sq * G off the M tile,
//   the last key tile) are masked on load and on store, so any ladder rung
//   works; D in {16, 32, 64, 128}.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNoWindow = 1 << 30;
constexpr int kPad = 8;       // bf16 of padding per shared-memory q row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lane l addresses row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 16 bytes global -> shared, asynchronously; zero-filled where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// M-rows [m0, m0 + rows) of q, as they are, into a padded shared-memory
// tile (row pitch D + kPad) by asynchronous copies, one commit group;
// rows past M are 0. Threads [tid0, tid0 + nthreads) share the copy.
template <int D>
__device__ __forceinline__ void copy_q(__nv_bfloat16* Qs, const __nv_bfloat16* q,
                                       int rows, int m0, int M, int b, int kh,
                                       int Sq, int Hq, int G, int tid,
                                       int nthreads) {
  constexpr int CH = D / 8;
  for (int c = tid; c < rows * CH; c += nthreads) {
    const int r = c / CH;
    const int cc = c - r * CH;
    const int m = m0 + r;
    const int row = m < M ? m / G : 0;
    const int head = m < M ? m - row * G : 0;
    cp_async16(Qs + r * (D + kPad) + cc * 8,
               q + (((size_t)b * Sq + row) * Hq + (size_t)kh * G + head) * D +
                   cc * 8,
               m < M);
  }
  cp_async_commit();
}

// q fragments as copied, times scale, each rounded to bf16
template <int D>
__device__ __forceinline__ void scale_q_frags(uint32_t (&qf)[D / 16][4],
                                              float scale) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qf[ks][i]));
      qf[ks][i] = pack_bf16(f.x * scale, f.y * scale);
    }
}

// A warp's q fragments (its 16 M-rows of the staged tile, every k step of
// 16), the A layout of mma.m16n8k16 and of a register-A wgmma
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4],
                                             const __nv_bfloat16* Qs, int row0,
                                             int lane) {
  const int mi = lane >> 3;
  const int mr = lane & 7;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldmatrix_x4(qf[ks], Qs + (row0 + (mi & 1) * 8 + mr) * (D + kPad) + ks * 16 +
                            (mi >> 1) * 8);
}

// The key limits [klo, khi) of M-row m (klo = 1 > khi = 0 past M)
__device__ __forceinline__ void row_limits(int m, int M, int G, int q_offset,
                                           int w, int causal, int kvv, int& klo,
                                           int& khi) {
  if (m < M) {
    const int qpos = q_offset + m / G;
    klo = qpos - w + 1;
    khi = causal ? min(kvv, qpos + 1) : kvv;
  } else {
    klo = 1;
    khi = 0;
  }
}

// One M-row's output from a thread of its quad: the thread holds columns
// 8 n + 2 tq + {0, 1} in o[4 n + 2 hh + {0, 1}] (the mma / wgmma
// accumulator layout). O / l rounded to bf16 once; where no key was valid
// (l == 0), the jnp path's mean of V over the key blocks that path visits
// for the row's q block: there its -1e30 floor makes every visited key
// weigh exp(0) = 1 and max(l, 1e-30) divides (`models/common.py::
// attention_prefill`); `q_block_ref` / `k_block_ref` are its block sizes.
template <int D>
__device__ __forceinline__ void store_row(const float (&o)[D / 2], int hh,
                                          float l, int m, int G, int b, int kh,
                                          int Sq, int Sk, int Hq, int Hkv,
                                          int causal, int w, int q_offset,
                                          int q_block_ref, int k_block_ref,
                                          int tq, const __nv_bfloat16* v,
                                          __nv_bfloat16* out) {
  constexpr int DN = D / 8;
  const int row = m / G;
  __nv_bfloat16* orow =
      out + (((size_t)b * Sq + row) * Hq + (size_t)kh * G + (m - row * G)) * D;
  if (l > 0.f) {
    const float inv = 1.f / l;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + 2 * tq) =
          __floats2bfloat162_rn(o[4 * dn + 2 * hh] * inv,
                                o[4 * dn + 2 * hh + 1] * inv);
    return;
  }
  const int qb = min(q_block_ref, Sq);
  const int kb = min(k_block_ref, Sk);
  const int nk = Sk / kb;
  const int q_lo = (row / qb) * qb + q_offset;
  const int q_hi = q_lo + qb - 1;
  const int ks = max(0, floordiv(q_lo - w + 1, kb)) * kb;
  const int ke = (causal ? min(floordiv(q_hi, kb) + 1, nk) : nk) * kb;
  float acc[DN][2];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) acc[dn][0] = acc[dn][1] = 0.f;
  for (int key = ks; key < ke; ++key) {
    const __nv_bfloat16* vr = v + (((size_t)b * Sk + key) * Hkv + kh) * D;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const float2 vv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vr + dn * 8 + 2 * tq));
      acc[dn][0] += vv.x;
      acc[dn][1] += vv.y;
    }
  }
  const float inv = ke > ks ? 1.f / (float)(ke - ks) : 0.f;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
    *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + 2 * tq) =
        __floats2bfloat162_rn(acc[dn][0] * inv, acc[dn][1] * inv);
}

// ===========================================================================
// The short-prompt instance (mma.sync, cp.async double buffer)
// ===========================================================================

namespace mma {

constexpr int kMTile = 64;    // (query row, head in group) pairs per block
constexpr int kWarps = 4;     // 16 M-rows each
constexpr int kThreads = kWarps * 32;
constexpr int kKTile = 64;    // keys per shared-memory tile

// dynamic shared memory: the q tile, then K and V, two buffers each
constexpr int smem_bytes(int D) { return (kMTile + 4 * kKTile) * (D + kPad) * 2; }

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D <= 64: at most 128 registers, so four blocks share an SM and the 480
// blocks of a B=8 rung-256 prefill run in one wave on 132 SMs
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 4 : 2)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ kv_valid,
                       __nv_bfloat16* __restrict__ out, int Sq, int Sk, int Hq,
                       int Hkv, int causal, int window, int q_offset,
                       int q_block_ref, int k_block_ref, float scale) {
  constexpr int LD = D + kPad;   // shared-memory row, bf16
  constexpr int KS = D / 16;     // k steps of Q K^T, and pairs of O's n tiles
  constexpr int CH = D / 8;      // 16-byte chunks of a row
  constexpr int NT = kKTile / 8; // n tiles of S, the key tile's 8-key columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kMTile][LD]
  __nv_bfloat16* Ks = Qs + kMTile * LD;                             // [2][kKTile][LD]
  __nv_bfloat16* Vs = Ks + 2 * kKTile * LD;                         // [2][kKTile][LD]

  const int tile = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int M = Sq * G;
  const int m0 = tile * kMTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int w = window > 0 ? window : kNoWindow;
  const int kvv = kv_valid ? max(0, min(kv_valid[b], Sk)) : Sk;

  // the keys any M-row of the tile can see
  const int row_lo = m0 / G;
  const int row_hi = (min(m0 + kMTile, M) - 1) / G;
  const int kstart = max(0, q_offset + row_lo - w + 1);
  int kend = kvv;
  if (causal) kend = min(kend, q_offset + row_hi + 1);
  const int ntiles = kend > kstart ? (kend - kstart + kKTile - 1) / kKTile : 0;

  auto load_tile = [&](int t, int buf) {
    const int t0 = kstart + t * kKTile;
    const int n = min(kKTile, kend - t0);
    __nv_bfloat16* kd = Ks + buf * kKTile * LD;
    __nv_bfloat16* vd = Vs + buf * kKTile * LD;
    for (int c = tid; c < kKTile * CH; c += kThreads) {
      const int j = c / CH;
      const int cc = c - j * CH;
      const bool ok = j < n;
      const size_t off =
          (((size_t)b * Sk + (ok ? t0 + j : 0)) * Hkv + kh) * D + cc * 8;
      cp_async16(kd + j * LD + cc * 8, k + off, ok);
      cp_async16(vd + j * LD + cc * 8, v + off, ok);
    }
    cp_async_commit();
  };
  copy_q<D>(Qs, q, kMTile, m0, M, b, kh, Sq, Hq, G, tid, kThreads);
  if (ntiles > 0) {
    load_tile(0, 0);
    cp_async_wait<1>();   // q's copies, the older group
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // ldmatrix addressing: lane l gives row (l & 7) of matrix (l >> 3)
  const int mi = lane >> 3;
  const int mr = lane & 7;
  uint32_t qf[KS][4];
  load_q_frags<D>(qf, Qs, warp * 16, lane);
  scale_q_frags<D>(qf, scale);

  // this thread's two M-rows (fragment rows g and g + 8) and their key limits
  const int gq = lane >> 2;
  const int tq = lane & 3;
  int mrow[2], klo[2], khi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mrow[hh] = m0 + warp * 16 + gq + hh * 8;
    row_limits(mrow[hh], M, G, q_offset, w, causal, kvv, klo[hh], khi[hh]);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_tile(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = kstart + t * kKTile;
    const __nv_bfloat16* kb = Ks + buf * kKTile * LD;
    const __nv_bfloat16* vb = Vs + buf * kKTile * LD;

    // S = (q * scale) K^T: the warp's 16 M-rows x kKTile keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];   // b0, b1 of key tiles 2 np and 2 np + 1
        ldmatrix_x4(kf, kb + (np * 16 + (mi >> 1) * 8 + mr) * LD + ks * 16 +
                            (mi & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // mask each M-row by its own limits; online softmax once per tile
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + n * 8 + 2 * tq + (e & 1);
        const int hh = e >> 1;
        if (key < klo[hh] || key >= khi[hh]) s[n][e] = -INFINITY;
        mx[hh] = fmaxf(mx[hh], s[n][e]);
      }
    }
    float base[2], corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_run[hh], mx[hh]);
      // no valid key yet: keep every exponent at exp(-inf) = 0, never -inf - -inf
      base[hh] = m_new == -INFINITY ? 0.f : m_new;
      corr[hh] = __expf(m_run[hh] - base[hh]);
      m_run[hh] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] - base[e >> 1]);
        rsum[e >> 1] += p;
        s[n][e] = p;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * corr[hh] + rsum[hh];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P V, P packed to bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t vf[4];   // b0, b1 of d tiles 2 dp and 2 dp + 1
        ldmatrix_x4_trans(vf, vb + (kk * 16 + (mi & 1) * 8 + mr) * LD + dp * 16 +
                                  (mi >> 1) * 8);
        mma_bf16(o + 8 * dp, pa, vf[0], vf[1]);
        mma_bf16(o + 8 * dp + 4, pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this buffer is free for tile t + 2
  }

  // epilogue: each quad holds an M-row's D columns, 2 per n tile per thread
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (mrow[hh] >= M) continue;
    store_row<D>(o, hh, l, mrow[hh], G, b, kh, Sq, Sk, Hq, Hkv, causal, w,
                 q_offset, q_block_ref, k_block_ref, tq, v, out);
  }
}

}  // namespace mma

// ===========================================================================
// The long-prompt instance (wgmma, TMA ring, warp-specialised, ping-pong)
// ===========================================================================

namespace ws {

constexpr int kWgThreads = 128;
constexpr int kConsumers = 2;                            // warpgroups of 64 M-rows
constexpr int kThreads = kWgThreads * (kConsumers + 1);  // and one producer
constexpr int kMTile = 64 * kConsumers;
constexpr int kStages = 4;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct Shape {
  static constexpr int KT = D == 128 ? 64 : 128;    // keys per tile
  static constexpr int COLS = D < 64 ? D : 64;       // columns of a swizzled piece
  static constexpr int RB = COLS * 2;                // its row, bytes
  static constexpr int PIECES = D / COLS;
  static constexpr int TILE = KT * D * 2;            // a K (or V) tile, bytes
  static constexpr int STAGE = 2 * TILE;
  // the descriptors' swizzle code, the TMA map's swizzle of RB-byte rows
  static constexpr int LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  // each consumer's q tile, twice: the next item's copy lands while this
  // item runs
  static constexpr int Q_BYTES = 2 * kMTile * (D + kPad) * 2;
  // 1024 bytes to align the ring to the 128-byte swizzle's period
  static constexpr int SMEM = 1024 + kStages * STAGE + Q_BYTES + 2 * kStages * 8;
};

constexpr int smem_bytes(int D) {
  return D == 16 ? Shape<16>::SMEM : D == 32 ? Shape<32>::SMEM
       : D == 64 ? Shape<64>::SMEM : Shape<128>::SMEM;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, its bytes counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// named barriers 1 and 2 order the two consumers' products (ping-pong)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from touching registers an asynchronous product owns
// across its issue and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// shared-memory matrix descriptor: start, leading and stride byte offsets
// (16-byte units), swizzle code in bits 62-63
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// d (m64 x n16, fp32) += a (m64 x k16, bf16 registers) * B (k16 x n16,
// bf16, shared memory through `desc`); TRANS_B: B is MN-major
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %12, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %13, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate), "l"(desc),
        "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %21, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate), "l"(desc),
        "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %37, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate), "l"(desc),
        "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %69, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate), "l"(desc),
        "n"(TRANS_B));
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                                      uint64_t desc, int accumulate) {
  if constexpr (N == 16) wgmma_n16<TRANS_B>(d, a, desc, accumulate);
  else if constexpr (N == 32) wgmma_n32<TRANS_B>(d, a, desc, accumulate);
  else if constexpr (N == 64) wgmma_n64<TRANS_B>(d, a, desc, accumulate);
  else wgmma_n128<TRANS_B>(d, a, desc, accumulate);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The work item `item` of the list: in groups of `group` samples whose K
// and V fit half of L2 together (so that the blocks running together read
// them from L2), in each group the causal M tiles longest first, every (kv
// head, sample) of a tile before the next tile; and the key tiles [kstart,
// kstart + ntiles * KT) its rows can see: from the window start of its first
// row to the causal diagonal of its last row and to kv_valid.
struct Item {
  int m0, kh, b, kvv, kstart, ntiles;
};

template <int KT>
__device__ __forceinline__ Item work_item(int item, int m_tiles, int B, int Hkv,
                                          int group, int M, int G, int Sk,
                                          int causal, int w, int q_offset,
                                          const int* kv_valid) {
  Item it;
  const int g = item / (group * m_tiles * Hkv);
  const int rem = item - g * group * m_tiles * Hkv;
  const int samples = min(group, B - g * group);   // the last group's fewer
  int tile = rem / (samples * Hkv);
  const int pair = rem - tile * samples * Hkv;
  it.kh = pair % Hkv;
  it.b = g * group + pair / Hkv;
  if (causal) tile = m_tiles - 1 - tile;
  it.m0 = tile * kMTile;
  it.kvv = kv_valid ? max(0, min(kv_valid[it.b], Sk)) : Sk;
  const int row_lo = it.m0 / G;
  const int row_hi = (min(it.m0 + kMTile, M) - 1) / G;
  it.kstart = max(0, q_offset + row_lo - w + 1);
  int kend = it.kvv;
  if (causal) kend = min(kend, q_offset + row_hi + 1);
  it.ntiles = kend > it.kstart ? (kend - it.kstart + KT - 1) / KT : 0;
  return it;
}

// The r-th work item of block j of a grid of g blocks: rounds of g items,
// taken in turn forwards and backwards, so that the blocks' shares of a
// longest-first list stay even. With one block an item (g = items) block j
// takes item j alone.
__device__ __forceinline__ int nth_item(int r, int j, int g) {
  return r * g + ((r & 1) ? g - 1 - j : j);
}

// A grid of blocks over the work items (persistent where it has fewer
// blocks than items: at most one an SM): a producer warpgroup (one thread
// issues the TMA copies, running ahead into the next item's tiles while the
// consumers finish an item) and two consumer warpgroups of 64 M-rows each.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ kv_valid,
                       __nv_bfloat16* __restrict__ out, int B, int Sq, int Sk,
                       int Hq, int Hkv, int causal, int window, int q_offset,
                       int q_block_ref, int k_block_ref, float scale,
                       int m_tiles, int group) {
  using S = Shape<D>;
  constexpr int KT = S::KT;
  constexpr int KS = D / 16;       // k steps of Q K^T
  constexpr int PK = KT / 16;      // k steps of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(ring + kStages * S::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * S::STAGE + S::Q_BYTES);
  uint64_t* empty = full + kStages;

  const int G = Hq / Hkv;
  const int M = Sq * G;
  const int w = window > 0 ? window : kNoWindow;
  const int items = m_tiles * Hkv * B;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    // producer: K and V tiles into the ring, item after item; keys past
    // Sk are zero-filled
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int n = 0;   // tiles loaded so far: the ring's position and phase
      for (int r = 0; r * gridDim.x < items; ++r) {
        const int item = nth_item(r, blockIdx.x, gridDim.x);
        if (item >= items) continue;
        const Item it = work_item<KT>(item, m_tiles, B, Hkv, group, M, G, Sk,
                                      causal, w, q_offset, kv_valid);
        for (int t = 0; t < it.ntiles; ++t, ++n) {
          const int st = n % kStages;
          mbar_wait(&empty[st], ((n / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[st], S::STAGE);
          const int t0 = it.kstart + t * KT;
          unsigned char* kd = ring + st * S::STAGE;
#pragma unroll
          for (int p = 0; p < S::PIECES; ++p) {
            tma_load(kd + p * KT * S::RB, &kmap, &full[st], p * S::COLS, it.kh,
                     t0, it.b);
            tma_load(kd + S::TILE + p * KT * S::RB, &vmap, &full[st],
                     p * S::COLS, it.kh, t0, it.b);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));

  const int c = wg - 1;                    // consumer 0 or 1
  const int ctid = threadIdx.x - wg * kWgThreads;
  const int warp = ctid >> 5;
  const int lane = ctid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  __nv_bfloat16* Qw = Qs + c * 2 * 64 * (D + kPad);   // two buffers
  const uint32_t ring_u32 = smem_u32(ring);

  float o[D / 2];
  float m_run[2], l_run[2], corr[2];
  float s[KT / 2];
  uint32_t pa[PK][4];
  uint32_t qf[KS][4];

  // Q K^T's B: the K tile, K-major, k step ks = 16 columns, 32 bytes into
  // its piece's 128-byte (or narrower) swizzled rows; 8-row groups RB * 8 apart
  auto k_desc = [&](int st, int ks) {
    const int col = ks * 16;
    return make_desc(ring_u32 + st * S::STAGE + (col / S::COLS) * KT * S::RB +
                         (col % S::COLS) * 2,
                     16, 8 * S::RB, S::LAYOUT);
  };
  // P V's B: the V tile, MN-major (D contiguous), k step kk = 16 keys; the
  // 64-column pieces of D = 128 lie KT * 128 bytes apart
  auto v_desc = [&](int st, int kk) {
    return make_desc(ring_u32 + st * S::STAGE + S::TILE + kk * 16 * S::RB,
                     KT * S::RB, 8 * S::RB, S::LAYOUT);
  };
  // O = O * corr + P V, over the ring's stage st
  auto pv = [&](int st) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) wgmma<D, 1>(o, pa[kk], v_desc(st, kk), 1);
    wgmma_commit();
    fence_regs(o);
    fence_regs(pa);
  };
  // Q K^T of the n-th tile of the ring into s, in this consumer's turn
  auto qk = [&](int n) {
    const int st = n % kStages;
    mbar_wait(&full[st], (n / kStages) & 1);
    bar_sync(1 + c, 2 * kWgThreads);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) wgmma<KT, 0>(s, qf[ks], k_desc(st, ks), ks > 0);
    wgmma_commit();
    fence_regs(s);
  };
  // p rounded to bf16, the A operand of the next P V
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // the q rows of the work item of round r into buffer r & 1
  auto fetch_q = [&](int r) {
    const Item f = work_item<KT>(nth_item(r, blockIdx.x, gridDim.x), m_tiles, B,
                                 Hkv, group, M, G, Sk, causal, w, q_offset,
                                 kv_valid);
    copy_q<D>(Qw + (r & 1) * 64 * (D + kPad), q, 64, f.m0 + c * 64, M, f.b,
              f.kh, Sq, Hq, G, ctid, kWgThreads);
  };
  auto last_round = [&](int r) {
    return (r + 1) * gridDim.x >= items ||
           nth_item(r + 1, blockIdx.x, gridDim.x) >= items;
  };

  int n = 0;   // tiles consumed so far
  fetch_q(0);
  for (int r = 0;; ++r) {
    const Item it = work_item<KT>(nth_item(r, blockIdx.x, gridDim.x), m_tiles, B,
                                  Hkv, group, M, G, Sk, causal, w, q_offset,
                                  kv_valid);
    const int mc0 = it.m0 + c * 64;        // the warpgroup's first M-row
    cp_async_wait<0>();
    bar_sync(3 + c, kWgThreads);           // every thread's q copies landed
    load_q_frags<D>(qf, Qw + (r & 1) * 64 * (D + kPad), warp * 16, lane);
    scale_q_frags<D>(qf, scale);
    // the other buffer was read at the last item's start, before the sync
    if (!last_round(r)) fetch_q(r + 1);

    int mrow[2], klo[2], khi[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mrow[hh] = mc0 + warp * 16 + gq + hh * 8;
      row_limits(mrow[hh], M, G, q_offset, w, causal, it.kvv, klo[hh], khi[hh]);
    }
    // a tile [t0, t0 + KT) needs no mask where it lies inside every valid
    // row's [klo, khi) of the warpgroup: klo rises and khi does not fall
    // with the row, so its last row's klo and its first row's khi decide
    const bool has_rows = mc0 < M;
    const int wr_lo = mc0 / G;
    const int wr_hi = (min(mc0 + 64, M) - 1) / G;
    const int free_from = q_offset + wr_hi - w + 1;
    const int free_to = causal ? min(it.kvv, q_offset + wr_lo + 1) : it.kvv;

#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m_run[hh] = -INFINITY;
      l_run[hh] = 0.f;
      corr[hh] = 0.f;
    }

    // the item's tile t's scores (masked where the tile needs it) into p,
    // in s; the running max, the correction of the sums so far, and l
    auto softmax = [&](int t) {
      const int t0 = it.kstart + t * KT;
      if (!(has_rows && t0 >= free_from && t0 + KT <= free_to)) {
#pragma unroll
        for (int i = 0; i < KT / 2; ++i) {
          const int key = t0 + (i >> 2) * 8 + 2 * tq + (i & 1);
          const int hh = (i >> 1) & 1;
          if (key < klo[hh] || key >= khi[hh]) s[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float nb[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m_run[hh], mx[hh]);
        // no valid key yet: keep every exponent at 2^-inf = 0, never -inf - -inf
        const float base = m_new == -INFINITY ? 0.f : m_new;
        corr[hh] = ex2((m_run[hh] - base) * kLog2e);
        nb[hh] = -base * kLog2e;
        m_run[hh] = m_new;
      }
      // p = e^(s - base) = 2^(s log2 e - base log2 e): one FFMA and one ex2
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        const int hh = (i >> 1) & 1;
        const float p = ex2(fmaf(s[i], kLog2e, nb[hh]));
        rsum[hh] += p;
        s[i] = p;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * corr[hh] + rsum[hh];
    };
    // the other consumer's turn (its last one of an item needs no hand-over)
    auto hand_over = [&](int t) {
      if (!(c == 1 && t == it.ntiles - 1)) bar_arrive(2 - c, 2 * kWgThreads);
    };

    if (it.ntiles > 0) {
      if (c == 1) bar_arrive(1, 2 * kWgThreads);  // consumer 0 goes first
      qk(n);
      hand_over(0);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(0);
      pack();
      for (int t = 1; t < it.ntiles; ++t) {
        qk(n + t);
        // the previous tile's P V runs behind this tile's Q K^T, and this
        // tile's softmax behind both
        pv((n + t - 1) % kStages);
        hand_over(t);
        wgmma_wait<1>();
        fence_regs(s);
        softmax(t);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        if (ctid == 0) mbar_arrive(&empty[(n + t - 1) % kStages]);
        pack();
      }
      pv((n + it.ntiles - 1) % kStages);
      wgmma_wait<0>();
      fence_regs(o);
      if (ctid == 0) mbar_arrive(&empty[(n + it.ntiles - 1) % kStages]);
      n += it.ntiles;
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_run[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (mrow[hh] >= M) continue;
      store_row<D>(o, hh, l, mrow[hh], G, it.b, it.kh, Sq, Sk, Hq, Hkv, causal,
                   w, q_offset, q_block_ref, k_block_ref, tq, v, out);
    }
    if (last_round(r)) break;
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (nothing new to link)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// [B, Sk, Hkv, D] bf16 as a 4-D map (D, Hkv, Sk, B), boxes of (COLS, 1, KT,
// 1) swizzled as the descriptors read them; keys past Sk read as zeros
template <int D>
int encode(CUtensorMap* map, const void* base, int B, int Sk, int Hkv) {
  using S = Shape<D>;
  const EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)Sk,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2,
                                 (cuuint64_t)Sk * Hkv * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)S::COLS, 1u, (cuuint32_t)S::KT, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  const CUtensorMapSwizzle swz = S::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : S::RB == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace ws

struct Args {
  const void *q, *k, *v, *kv_valid;
  void* out;
  int B, Sq, Sk, Hq, Hkv, causal, window, q_offset, q_block_ref, k_block_ref;
  float scale;
  int m_tiles, smem, grid, group;
  cudaStream_t s;
};

template <int D>
int launch_mma(const Args& a) {
  if (a.smem != mma::smem_bytes(D)) return (int)cudaErrorInvalidValue;
  // above 48 KB (D = 128) the kernel must be allowed the memory, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      mma::flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      mma::smem_bytes(D));
  if (attr != cudaSuccess) return (int)attr;
  mma::flash_attention_kernel<D><<<dim3(a.m_tiles, a.Hkv, a.B), mma::kThreads, a.smem, a.s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const int*>(a.kv_valid),
      static_cast<__nv_bfloat16*>(a.out), a.Sq, a.Sk, a.Hq, a.Hkv, a.causal,
      a.window, a.q_offset, a.q_block_ref, a.k_block_ref, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_ws(const Args& a) {
  if (a.smem != ws::smem_bytes(D)) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ws::flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ws::smem_bytes(D));
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap kmap, vmap;
  int err = ws::encode<D>(&kmap, a.k, a.B, a.Sk, a.Hkv);
  if (!err) err = ws::encode<D>(&vmap, a.v, a.B, a.Sk, a.Hkv);
  if (err) return err;
  const long long items = (long long)a.m_tiles * a.Hkv * a.B;
  if (items > 0x7fffffffll || a.grid < 1 || a.grid > items || a.group < 1 ||
      a.group > a.B)
    return (int)cudaErrorInvalidValue;
  ws::flash_attention_kernel<D><<<a.grid, ws::kThreads, a.smem, a.s>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const int*>(a.kv_valid),
      static_cast<__nv_bfloat16*>(a.out), a.B, a.Sq, a.Sk, a.Hq, a.Hkv, a.causal,
      a.window, a.q_offset, a.q_block_ref, a.k_block_ref, a.scale, a.m_tiles,
      a.group);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Args& a, int instance) {
  return instance == 1 ? launch_ws<D>(a) : launch_mma<D>(a);
}

}  // namespace

// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] bf16 contiguous (model layout), each
// 16-byte aligned; kv_valid [B] int32 or null; out [B, Sq, Hq, D] bf16. D in
// {16, 32, 64, 128}. Launch geometry from the caller, refused unless it is
// the instance's: instance 0 (mma.sync) takes m_tiles = ceil(Sq * G / 64),
// a grid of every (M tile, kv head, sample) and smem = (64 + 4 * 64) *
// (D + 8) * 2; instance 1 (wgmma) m_tiles = ceil(Sq * G / 128), a
// persistent grid of 1 to m_tiles * Hkv * B blocks, work items in groups of
// 1 to B samples and smem = ws::smem_bytes(D), and needs Sk > 0. Returns
// the cudaError_t of the launch.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* kv_valid, void* out, int B,
                                    int Sq, int Sk, int Hq, int Hkv, int D,
                                    int causal, int window, int q_offset,
                                    int q_block_ref, int k_block_ref,
                                    float scale, int instance, int m_tiles,
                                    int grid, int group, int smem,
                                    void* stream) {
  if (Hkv < 1 || Hq % Hkv || q_block_ref < 1 || k_block_ref < 1) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if (instance != 0 && (instance != 1 || Sk < 1)) return (int)cudaErrorInvalidValue;
  const int m_tile = instance == 1 ? ws::kMTile : mma::kMTile;
  if (m_tiles != (Sq * (Hq / Hkv) + m_tile - 1) / m_tile) return (int)cudaErrorInvalidValue;
  if (instance == 0 && (long long)grid != (long long)m_tiles * Hkv * B)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, kv_valid, out, B, Sq, Sk, Hq, Hkv, causal, window,
               q_offset, q_block_ref, k_block_ref, scale, m_tiles, smem, grid,
               group, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return launch<16>(a, instance);
    case 32: return launch<32>(a, instance);
    case 64: return launch<64>(a, instance);
    case 128: return launch<128>(a, instance);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Encode the two tensor maps of a [B, Sk, Hkv, D] K and V `reps` times (no
// launch): the host's cost of the wgmma instance's per-call encode.
extern "C" int flash_attention_encode(const void* k, const void* v, int B,
                                      int Sk, int Hkv, int D, int reps) {
  CUtensorMap kmap, vmap;
  for (int i = 0; i < reps; ++i) {
    int err = 0;
    switch (D) {
      case 16: err = ws::encode<16>(&kmap, k, B, Sk, Hkv); if (!err) err = ws::encode<16>(&vmap, v, B, Sk, Hkv); break;
      case 32: err = ws::encode<32>(&kmap, k, B, Sk, Hkv); if (!err) err = ws::encode<32>(&vmap, v, B, Sk, Hkv); break;
      case 64: err = ws::encode<64>(&kmap, k, B, Sk, Hkv); if (!err) err = ws::encode<64>(&vmap, v, B, Sk, Hkv); break;
      case 128: err = ws::encode<128>(&kmap, k, B, Sk, Hkv); if (!err) err = ws::encode<128>(&vmap, v, B, Sk, Hkv); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (err) return err;
  }
  return 0;
}
