// Causal / windowed GQA prefill attention with per-sample key lengths, on
// the tensor cores.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py, function
//   `flash_attention` (Pallas TPU kernel, grid (B, Hq, nQ, nK), online softmax
//   carried in VMEM scratch across the sequential k-block axis, blocks above
//   the diagonal skipped). This kernel also takes what the model path needs and
//   the Pallas kernel lacks: `kv_valid` (per-sample key length of a ladder-padded
//   prompt batch) and `q_offset` (absolute position of query row 0).
//
// What bounds it on the H100: at the serving shapes (Sq = Sk <= 256, D = 64)
//   the causal work is 2 * B * Hq * D * Sq * (Sq + 1) flops against
//   (B * (Hq + 2 * Hkv) * S * D + B * Hq * S * D) * 2 bytes, about 100 flops a
//   byte at S = 256 and fewer on shorter rungs: below the tensor-core ridge
//   (~295), so bytes are the bound, and at these sizes the latency of a
//   block's short walk over its key tiles is what a launch waits for. Both
//   products therefore run on the tensor cores and every K/V tile is read
//   once for all the query heads that share it.
//
// Design (FA2-style forward): one block per (M tile, kv head, sample), four
//   warps. The model layout [B, S, Hq, D] keeps the G = Hq / Hkv query heads
//   of one kv head side by side, so the block's M dimension is the flattened
//   (query row, head in group) pair: M-row m is row m / G, head m % G. An M
//   tile holds 64 such pairs, 16 per warp, and every K/V tile the block
//   loads serves all G heads (what the Pallas kernel gets from its [G, D]
//   block). The block walks the keys from the window start of its first row
//   to the causal diagonal of its last row and to kv_valid[b], in tiles of
//   64 keys held in shared memory as bf16, double-buffered: the next tile's
//   cp.async copies (16 bytes a thread, keys past the range zero-filled) are
//   in flight while the current tile is used. Rows are padded to D + 8 bf16
//   so ldmatrix reads them without bank conflicts. Each warp computes its
//   16 x 64 scores with mma.sync m16n8k16 (bf16 in, fp32 sums): A is the
//   warp's q fragment, loaded once per block with ldmatrix; B is K through
//   ldmatrix. Each M-row is masked with its own row's causal and window
//   limits and kv_valid[b]; the online softmax rescale runs once per key
//   tile in registers, with quad shuffles for the row max. P, packed to
//   bf16 in registers, is the A operand of O += P V, whose B operand comes
//   from V through ldmatrix.trans. Ragged edges (Sq * G not a multiple of 64,
//   the last key tile) are masked on load and on store, so any ladder rung
//   works. Rows with no valid key reproduce the jnp path
//   (`models/common.py::attention_prefill`): there the -1e30 floor makes
//   every visited key weigh exp(0) = 1 and max(l, 1e-30) divides, so such a
//   row is the mean of V over the key blocks that path visits for the row's
//   q block; `q_block_ref` / `k_block_ref` give that path's block sizes.
//   Rounding as in the jnp path: q * scale in bf16, scores and l in fp32 (l
//   sums the unrounded p), p rounded to bf16 only as the A operand of PV, O
//   summed in fp32 and rounded to bf16 once.
//
// Head dims: D = 16 (the reduced scenario model) is one m16n8k16 k-step of
//   Q K^T and two n tiles of O; its 48-byte shared-memory rows keep every
//   cp.async destination and ldmatrix row 16-byte aligned, and the eight
//   rows an ldmatrix reads fall in distinct banks.
//
// mma.sync, not wgmma: wgmma wants 64-row warpgroup tiles fed from
//   shared-memory descriptors (and TMA to keep them full) for the card's full
//   tensor-core rate, but at S <= 256 and D = 64 this kernel is bound by bytes
//   and latency, not by the mma rate; mma.sync keeps q and p in registers
//   with no descriptor layout to get right. wgmma + TMA for long prompts is
//   later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMTile = 64;    // (query row, head in group) pairs per block
constexpr int kWarps = 4;     // 16 M-rows each
constexpr int kThreads = kWarps * 32;
constexpr int kKTile = 64;    // keys per shared-memory tile
constexpr int kPad = 8;       // bf16 of padding per shared-memory row
constexpr int kNoWindow = 1 << 30;

// dynamic shared memory: the q tile, then K and V, two buffers each
constexpr int smem_bytes(int D) { return (kMTile + 4 * kKTile) * (D + kPad) * 2; }

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// D <= 64: at most 128 registers, so four blocks share an SM and the 480
// blocks of a B=8 rung-256 prefill run in one wave on 132 SMs
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 4 : 2)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ kv_valid,
                       __nv_bfloat16* __restrict__ out,
                       int Sq, int Sk, int Hq, int Hkv, int causal, int window,
                       int q_offset, int q_block_ref, int k_block_ref,
                       float scale) {
  constexpr int LD = D + kPad;   // shared-memory row, bf16
  constexpr int KS = D / 16;     // k steps of Q K^T, and pairs of O's n tiles
  constexpr int DN = D / 8;      // n tiles of O
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
  if (ntiles > 0) load_tile(0, 0);

  // q * scale, rounded to bf16, staged once; rows past M are 0
  for (int c = tid; c < kMTile * CH; c += kThreads) {
    const int r = c / CH;
    const int cc = c - r * CH;
    const int m = m0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (m < M) {
      const int row = m / G;
      raw = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * Sq + row) * Hq + (size_t)kh * G + (m - row * G)) * D +
          cc * 8);
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        h2[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(Qs + r * LD + cc * 8) = raw;
  }
  __syncthreads();

  // ldmatrix addressing: lane l gives row (l & 7) of matrix (l >> 3)
  const int mi = lane >> 3;
  const int mr = lane & 7;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qf[ks], Qs + (warp * 16 + (mi & 1) * 8 + mr) * LD + ks * 16 +
                            (mi >> 1) * 8);

  // this thread's two M-rows (fragment rows g and g + 8) and their key limits
  const int gq = lane >> 2;
  const int tq = lane & 3;
  int mrow[2], klo[2], khi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mrow[hh] = m0 + warp * 16 + gq + hh * 8;
    if (mrow[hh] < M) {
      const int qpos = q_offset + mrow[hh] / G;
      klo[hh] = qpos - w + 1;
      khi[hh] = causal ? min(kvv, qpos + 1) : kvv;
    } else {
      klo[hh] = 1;
      khi[hh] = 0;
    }
  }

  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
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
    for (int dn = 0; dn < DN; ++dn) {
      o[dn][0] *= corr[0];
      o[dn][1] *= corr[0];
      o[dn][2] *= corr[1];
      o[dn][3] *= corr[1];
    }

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
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
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
    const int m = mrow[hh];
    if (m >= M) continue;
    const int row = m / G;
    __nv_bfloat16* orow =
        out + (((size_t)b * Sq + row) * Hq + (size_t)kh * G + (m - row * G)) * D;
    if (l > 0.f) {
      const float inv = 1.f / l;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
        *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + 2 * tq) =
            __floats2bfloat162_rn(o[dn][2 * hh] * inv, o[dn][2 * hh + 1] * inv);
      continue;
    }
    // No valid key: the jnp path's mean of V over the key blocks it visits.
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
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_valid,
           void* out, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
           int window, int q_offset, int q_block_ref, int k_block_ref,
           float scale, int m_tiles, int smem, cudaStream_t s) {
  if (smem != smem_bytes(D)) return (int)cudaErrorInvalidValue;
  // above 48 KB (D = 128) the kernel must be allowed the memory, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(D));
  if (attr != cudaSuccess) return (int)attr;
  flash_attention_kernel<D><<<dim3(m_tiles, Hkv, B), kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_valid),
      static_cast<__nv_bfloat16*>(out), Sq, Sk, Hq, Hkv, causal, window,
      q_offset, q_block_ref, k_block_ref, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] bf16 contiguous (model layout), each
// 16-byte aligned; kv_valid [B] int32 or null; out [B, Sq, Hq, D] bf16. D in
// {16, 32, 64, 128}. Launch geometry from the caller: m_tiles = ceil(Sq * G / 64)
// blocks per (kv head, sample) and smem = (64 + 4 * 64) * (D + 8) * 2 bytes
// of dynamic shared memory; anything else is refused. Returns the
// cudaError_t of the launch.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* kv_valid, void* out, int B,
                                    int Sq, int Sk, int Hq, int Hkv, int D,
                                    int causal, int window, int q_offset,
                                    int q_block_ref, int k_block_ref,
                                    float scale, int m_tiles, int smem,
                                    void* stream) {
  if (Hkv < 1 || Hq % Hkv || q_block_ref < 1 || k_block_ref < 1) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if (m_tiles != (Sq * (Hq / Hkv) + kMTile - 1) / kMTile) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, kv_valid, out, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, q_block_ref, k_block_ref, scale, m_tiles, smem, s);
    case 32: return launch<32>(q, k, v, kv_valid, out, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, q_block_ref, k_block_ref, scale, m_tiles, smem, s);
    case 64: return launch<64>(q, k, v, kv_valid, out, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, q_block_ref, k_block_ref, scale, m_tiles, smem, s);
    case 128: return launch<128>(q, k, v, kv_valid, out, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, q_block_ref, k_block_ref, scale, m_tiles, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
