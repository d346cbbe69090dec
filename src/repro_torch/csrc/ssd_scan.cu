// Chunked linear-attention scan (the mLSTM / mamba-SSD hot path) in the
// model layout, with a carried initial state.
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py:58, function `ssd_scan`
//   (Pallas TPU kernel, grid (B, H, n_chunks), the whole [dk, dv] fp32 state
//   in VMEM scratch across the sequential chunk axis, starting from zero).
//   It computes `repro.models.linear_core.chunked_linear_attention`, the
//   function the JAX model path calls, and follows that function's order of
//   operations: per chunk of W steps, with cum the inclusive cumulative sum
//   of log_f inside the chunk and tot = cum[W-1],
//     y[w]  = exp(cum[w]) * (q[w] . S)
//             + sum_{u <= w} (q[w] . k[u]) * exp(cum[w] - cum[u] + log_i[u]) * v[u]
//     S    <- S * exp(tot) + sum_u (k[u] * exp(tot - cum[u] + log_i[u]))^T v[u]
//   y is read from the state as it stood before the chunk, then the state
//   is updated; k_scaled is rounded to fp32 before its product; y is rounded
//   to bf16 once, at the end.
//
// What bounds it on the H100: operations. The mLSTM makes one launch per
//   layer with v augmented by the normalizer's ones column, so at the
//   serving path's headline shape (B=8, S=256, H=4, dk=384, dv=385, one
//   chunk) the function needs 0.81 GFLOP of q k^T (causal half; bf16 inputs,
//   fp32 sums: the tensor cores, mma.sync m16n8k16, exact products) and 5.65
//   GFLOP of fp32 work (the state read q.S, the intra-chunk P.V and the
//   state update k_scaled^T v) against 63 MB of bytes: 0.0008 ms at 989
//   TFLOP/s bf16 plus 0.084 ms at 67 TFLOP/s fp32, against 0.019 ms at 3.35
//   TB/s. The fp32 products are fp32 in the reference, so they stay fp32
//   FMAs on the CUDA cores (no TF32, no split operands) and are nearly all
//   of the bound. What a straightforward version loses its time on is
//   staging, not FMAs (PERF.md §6, timed with one phase compiled out at a
//   time): one that re-staged every key tile up to the diagonal for each
//   32-row tile with plain synchronous copies took 0.41 ms at dv = 1, with
//   almost no fp32 work, and each of its FMAs came with its own shared
//   loads and, in the state update, a multiply rebuilding k_scaled.
//
// Design: the state is 576 KB per (b, h) at dk = dv = 384, more than a
//   block's shared memory, so the grid splits the state columns: grid
//   (ceil(dv / CW), H, B), each block holding a [dk, CW] fp32 state tile in
//   shared memory and walking the chunks in order. CW (16, 32 or 64) and the
//   shared memory come from the Python side (`ssd_scan.py::geometry`) and are
//   checked here: CW = 64 halves the blocks that recompute a chunk's q k^T
//   and stage its keys, against 32; CW = 16 keeps dv = 1 from idling 63 of
//   64 columns. The state tile arrives by cp.async while the gates load.
//   Per chunk, 64 rows at a time (a row tile):
//   - the q row tile comes by cp.async in four commit groups, and the state
//     read y = q.S starts on the first group while the rest land;
//   - key tiles of 32 keys up to the diagonal follow, double-buffered: k by
//     cp.async, v by register prefetch (converted to fp32 once, at any dv
//     and alignment), the next tile in flight while the current one is used;
//   - each warp computes a 16 x 16 tile of q k^T as two mma.sync tiles
//     sharing their q fragments (two independent chains), masked and
//     decayed into a shared score tile; P.V accumulates onto the state
//     read's scaled sums.
//   Then the state update streams the chunk's key tiles once more: k_scaled
//   = fp32(k * exp(tot - cum + log_i)) is computed once per staged key tile
//   into shared memory (in the q tile's room, rows padded with zeros), and
//   every thread accumulates an MI x 8 share of k_scaled^T v in registers,
//   MI a template parameter (12 at CW = 64, 8 at 32; 4 where that covers
//   dk), so the inner loop has no bounds checks.
//   All three fp32 products are register micro-tiles read with 16-byte
//   shared loads: y as 4 columns of 4 rows a thread (at CW = 64; q as 8 bf16
//   a load, S, P and v as 4 fp32), the update as 8 columns of 12 rows (12
//   k_scaled and 8 v values feed 96 FMAs). Rows padded to dk + 8 bf16 keep
//   the mma fragment loads and the q reads free of bank conflicts.
//
// What still holds it back (PERF.md §6): at the headline shape a block
//   needs 226 KB of shared memory, so one block of 8 warps runs on an SM and
//   the 224 blocks take 1.70 waves (two rounds). Inside a block the three
//   fp32 phases issue their FMAs at a little over half the card's fp32 rate,
//   and about half of the block's time lies outside them: the mma chains,
//   the staging and two barriers per key tile, and the per-block setup
//   (state tile, gates, q tiles). A version with 8 x 8 tiles and the state
//   read split four ways over dk (less shared traffic per FMA) was slower,
//   so shared-memory bandwidth is not the limit; latency is.
//
// Generality: any W <= 1024 dividing S, 1 <= dk <= 512 and any dv; ragged
//   row, key, column and dk tiles are masked (zero-filled copies); dk % 8 !=
//   0 or unaligned q, k stage with plain copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;        // chunk rows per row tile
constexpr int kKeys = 32;        // chunk keys per key tile
constexpr int kPLd = kKeys + 4;  // row stride of the score tile (floats)
constexpr int kQPieces = 4;      // commit groups of a q row tile
constexpr int kMaxDk = 512;
constexpr int kMaxChunk = 1024;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90

// The per-thread tiling at CW state columns per block. y: 4 columns of MR
// rows a thread. State update: 8 columns (two runs of 4, CW / 2 apart) of
// MI consecutive state rows a thread, so k_scaled rows hold kUpdRows values
// (dk padded with zeros).
template <int CW, int MI>
struct Tile {
  static constexpr int kYColGroups = CW / 4;
  static constexpr int kYRowGroups = kThreads / kYColGroups;
  static constexpr int kMR = kRows / kYRowGroups;
  static constexpr int kUColGroups = CW / 8;
  static constexpr int kURowGroups = kThreads / kUColGroups;
  static constexpr int kUpdRows = kURowGroups * MI;
  static constexpr int kVals = kKeys * CW / kThreads;  // v values a thread stages
};

// dk padded to the mma's k step (16); q and k tile rows hold 8 more bf16
__host__ __device__ __forceinline__ int padded_dk(int dk) { return (dk + 15) & ~15; }
__host__ __device__ __forceinline__ int tile_ld(int dk) { return padded_dk(dk) + 8; }

// state columns per block, as ssd_scan.py::cols_per_block chooses them
int cols_per_block(int dk, int dv) {
  return dv <= 16 ? 16 : (dv <= 32 || dk > 384) ? 32 : 64;
}

// state rows a thread updates, as ssd_scan.py::update_rows chooses them: the
// small instance where it covers dk, else the full one (dk <= 384 at 64
// columns, dk <= 512 below)
int update_rows(int dk, int cw) {
  const int groups = kThreads / (cw / 8);
  return 4 * groups >= padded_dk(dk) ? 4 : (cw == 64 ? 12 : 8);
}

// bytes of dynamic shared memory, as ssd_scan.py::smem_bytes counts them
size_t smem_bytes(int dk, int W, int cw) {
  const size_t dkp = padded_dk(dk), ld = tile_ld(dk);
  const size_t q_tile = (size_t)kRows * ld * 2;
  const size_t ks = (size_t)kKeys * (kThreads / (cw / 8)) * update_rows(dk, cw) * 4;
  return dkp * cw * 4                       // state tile
         + (q_tile > ks ? q_tile : ks)      // q row tile (bf16), then k_scaled
         + 2 * (size_t)kKeys * ld * 2       // two k key tiles (bf16)
         + 2 * (size_t)kKeys * cw * 4       // two v key tiles (fp32)
         + (size_t)kRows * kPLd * 4         // decay-masked scores
         + 2 * (size_t)W * 4;               // cum, log_i
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
// 4 bytes global -> shared, asynchronously; zero-filled where !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [0, nrows) of dst (bf16, row stride ld), 16-byte chunks [c0, c1) of
// each (8 bf16 apiece), from rows [0, n) of src (row r at src + r * stride,
// dk values); zero past n rows and dk columns. vec (dk % 8 == 0, 16-byte
// aligned rows): cp.async, in the caller's commit group; else plain copies.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld, int nrows,
                                           const __nv_bfloat16* __restrict__ src,
                                           size_t stride, int n, int dk,
                                           int c0, int c1, bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (vec) {
    const int nv = dk >> 3;
    for (int r = warp; r < nrows; r += kThreads / 32)
      for (int c = c0 + lane; c < c1; c += 32) {
        const bool ok = r < n && c < nv;
        cp_async16(dst + r * ld + 8 * c, ok ? src + r * stride + 8 * c : src, ok);
      }
  } else {
    for (int r = warp; r < nrows; r += kThreads / 32)
      for (int i = 8 * c0 + lane; i < 8 * c1; i += 32)
        dst[r * ld + i] = (r < n && i < dk) ? src[r * stride + i]
                                            : __float2bfloat16(0.f);
  }
}

// v rows [0, n) (row r at src + r * stride), columns [col0, col0 + CW) below
// dv, into registers: the thread's N values of a kKeys x CW tile (row-major)
template <int CW, int N>
__device__ __forceinline__ void load_v(float (&vr)[N],
                                       const __nv_bfloat16* __restrict__ src,
                                       size_t stride, int n, int col0, int dv) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    const int u = idx / CW, c = col0 + idx % CW;
    vr[j] = (u < n && c < dv) ? __bfloat162float(src[u * stride + c]) : 0.f;
  }
}

template <int N>
__device__ __forceinline__ void store_v(float* v_s, const float (&vr)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) v_s[threadIdx.x + j * kThreads] = vr[j];
}

// eight bf16 (a uint4) as floats
__device__ __forceinline__ void unpack8(const uint4 raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

template <int CW, int MI>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ log_f,
                const float* __restrict__ log_i,
                const float* __restrict__ state_in,
                __nv_bfloat16* __restrict__ y,
                float* __restrict__ state_out,
                int S, int H, int dk, int dv, int W, int vec) {
  using T = Tile<CW, MI>;
  constexpr int MR = T::kMR;
  constexpr int KSLD = T::kUpdRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int col0 = blockIdx.x * CW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int dkp = padded_dk(dk);
  const int ld = tile_ld(dk);
  const int nchunks = dkp >> 3;  // 16-byte chunks of a tile row
  const int region = max(kRows * ld * 2, kKeys * KSLD * 4);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* S_s = reinterpret_cast<float*>(smem_raw);                       // [dkp][CW]
  unsigned char* r0p = smem_raw + (size_t)dkp * CW * 4;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(r0p);           // [kRows][ld]
  float* ks_s = reinterpret_cast<float*>(r0p);               // [kKeys][KSLD], the update
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(r0p + region);  // [2][kKeys][ld]
  float* v_s = reinterpret_cast<float*>(k_s + 2 * kKeys * ld);          // [2][kKeys][CW]
  float* p_s = v_s + 2 * kKeys * CW;                  // [kRows][kPLd]; k scale, the update
  float* cum_s = p_s + kRows * kPLd;                  // [W]
  float* li_s = cum_s + W;                            // [W]

  // y: the thread's 4 columns of MR rows
  const int yc0 = 4 * (tid % T::kYColGroups);
  const int yr0 = (tid / T::kYColGroups) * MR;
  // state update: columns uc0 .. uc0 + 3 and CW / 2 + uc0 .., rows i0 .. i0 + MI
  const int uc0 = 4 * (tid % T::kUColGroups);
  const int i0 = (tid / T::kUColGroups) * MI;
  // the warp's 16 x 16 score tile (two 16 x 8 mma tiles) and its fragments
  const int srow = (warp >> 1) * 16, skey = (warp & 1) * 16;
  const int g = lane >> 2, tq = lane & 3;

  // the state tile, asynchronously (its own commit group, waited for with
  // the first q piece): 16-byte copies where the rows allow, else 4-byte
  const size_t st_base = (size_t)(b * H + h) * dk * dv;
  if (state_in == nullptr) {
    for (int idx = tid; idx < dkp * CW; idx += kThreads) S_s[idx] = 0.f;
  } else if (dv % 4 == 0 && reinterpret_cast<uintptr_t>(state_in) % 16 == 0) {
    for (int idx = tid; idx < dkp * CW / 4; idx += kThreads) {
      const int i = idx / (CW / 4), c = 4 * (idx % (CW / 4));
      const bool ok = i < dk && col0 + c < dv;
      cp_async16(S_s + 4 * idx, ok ? state_in + st_base + (size_t)i * dv + col0 + c
                                   : state_in, ok);
    }
  } else {
    for (int idx = tid; idx < dkp * CW; idx += kThreads) {
      const int i = idx / CW, c = idx % CW;
      const bool ok = i < dk && col0 + c < dv;
      cp_async4(S_s + idx, ok ? state_in + st_base + (size_t)i * dv + col0 + c
                              : state_in, ok);
    }
  }
  cp_async_commit();

  const size_t qk_stride = (size_t)H * dk;
  const size_t v_stride = (size_t)H * dv;
  const int nc = S / W;
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * W;
    __syncthreads();  // the previous chunk is done with the gate arrays
    for (int w = tid; w < W; w += kThreads) {
      const size_t gi = (size_t)(b * S + t0 + w) * H + h;
      cum_s[w] = log_f[gi];
      li_s[w] = log_i[gi];
    }
    __syncthreads();
    if (warp == 0) {  // inclusive cumulative sum: each lane a run, then lanes
      const int per = (W + 31) >> 5;
      const int beg = min(W, lane * per), end = min(W, beg + per);
      float run = 0.f;
      for (int w = beg; w < end; ++w) {
        run += cum_s[w];
        cum_s[w] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) before = 0.f;
      for (int w = beg; w < end; ++w) cum_s[w] += before;
    }
    __syncthreads();
    const float tot = cum_s[W - 1];

    const __nv_bfloat16* q_chunk = q + ((size_t)(b * S + t0) * H + h) * dk;
    const __nv_bfloat16* k_chunk = k + ((size_t)(b * S + t0) * H + h) * dk;
    const __nv_bfloat16* v_chunk = v + ((size_t)(b * S + t0) * H + h) * dv;
    float vr[T::kVals];

    // ---- y for the chunk, 64 rows at a time, from the state before it
    for (int r0 = 0; r0 < W; r0 += kRows) {
      const int nr = min(kRows, W - r0);
      const int kend = r0 + nr;  // keys u <= the tile's last row
      const int nkt = (kend + kKeys - 1) / kKeys;
      __syncthreads();  // q_s, k_s, v_s and p_s are free
#pragma unroll
      for (int j = 0; j < kQPieces; ++j) {
        stage_rows(q_s, ld, kRows, q_chunk + r0 * qk_stride, qk_stride, nr, dk,
                   j * nchunks / kQPieces, (j + 1) * nchunks / kQPieces, vec);
        cp_async_commit();
      }
      stage_rows(k_s, ld, kKeys, k_chunk, qk_stride, min(kKeys, kend), dk, 0,
                 nchunks, vec);
      cp_async_commit();
      load_v<CW>(vr, v_chunk, v_stride, min(kKeys, kend), col0, dv);

      // state read: acc[m][c] = q[yr0 + m] . S[:, yc0 + c], piece by piece
      float acc[MR][4];
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
#pragma unroll
      for (int j = 0; j < kQPieces; ++j) {
        if (j == 0) cp_async_wait<kQPieces>();
        else if (j == 1) cp_async_wait<kQPieces - 1>();
        else if (j == 2) cp_async_wait<kQPieces - 2>();
        else cp_async_wait<kQPieces - 3>();
        __syncthreads();
        const int kb = 8 * (j * nchunks / kQPieces);
        const int ke = 8 * ((j + 1) * nchunks / kQPieces);
#pragma unroll 2
        for (int i = kb; i < ke; i += 8) {
          float qf[MR][8];
#pragma unroll
          for (int m = 0; m < MR; ++m)
            unpack8(*reinterpret_cast<const uint4*>(q_s + (yr0 + m) * ld + i), qf[m]);
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            const float4 s = *reinterpret_cast<const float4*>(S_s + (i + kk) * CW + yc0);
#pragma unroll
            for (int m = 0; m < MR; ++m) fma4(acc[m], qf[m][kk], s);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int w = r0 + yr0 + m;
        const float e = w < W ? expf(cum_s[w]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] *= e;
      }

      // intra-chunk: key tiles up to the diagonal, the next one in flight
      const uint32_t* qa = reinterpret_cast<const uint32_t*>(q_s + (srow + g) * ld);
      const uint32_t* qb = reinterpret_cast<const uint32_t*>(q_s + (srow + g + 8) * ld);
      for (int t = 0; t < nkt; ++t) {
        const int buf = t & 1;
        const int u0 = t * kKeys;
        const int nu = min(kKeys, kend - u0);
        float* vb = v_s + buf * kKeys * CW;
        store_v(vb, vr);
        if (t + 1 < nkt) {
          const int u1 = u0 + kKeys;
          stage_rows(k_s + (buf ^ 1) * kKeys * ld, ld, kKeys,
                     k_chunk + u1 * qk_stride, qk_stride, min(kKeys, kend - u1),
                     dk, 0, nchunks, vec);
          cp_async_commit();
          load_v<CW>(vr, v_chunk + u1 * v_stride, v_stride,
                     min(kKeys, kend - u1), col0, dv);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // key tile t and its v are in shared memory
        const __nv_bfloat16* kt = k_s + buf * kKeys * ld;
        const uint32_t* kf0 = reinterpret_cast<const uint32_t*>(kt + (skey + g) * ld);
        const uint32_t* kf1 = reinterpret_cast<const uint32_t*>(kt + (skey + 8 + g) * ld);
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
        for (int k0 = 0; k0 < dkp; k0 += 16) {
          const int c = (k0 >> 1) + tq;
          const uint32_t a0 = qa[c], a1 = qb[c], a2 = qa[c + 4], a3 = qb[c + 4];
          mma_bf16(sc[0], a0, a1, a2, a3, kf0[c], kf0[c + 4]);
          mma_bf16(sc[1], a0, a1, a2, a3, kf1[c], kf1[c + 4]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = srow + g + (e >> 1) * 8;
            const int key = skey + 8 * n + 2 * tq + (e & 1);
            const int w = r0 + row;
            const int u = u0 + key;
            float p = 0.f;
            if (key < nu && u <= w && w < W)
              p = sc[n][e] * expf(cum_s[w] - cum_s[u] + li_s[u]);
            p_s[row * kPLd + key] = p;
          }
        __syncthreads();  // the score tile is complete
#pragma unroll
        for (int uu = 0; uu < kKeys; uu += 4) {
          float4 p[MR];
#pragma unroll
          for (int m = 0; m < MR; ++m)
            p[m] = *reinterpret_cast<const float4*>(p_s + (yr0 + m) * kPLd + uu);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float4 vv = *reinterpret_cast<const float4*>(vb + (uu + x) * CW + yc0);
#pragma unroll
            for (int m = 0; m < MR; ++m)
              fma4(acc[m], x == 0 ? p[m].x : x == 1 ? p[m].y : x == 2 ? p[m].z : p[m].w, vv);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int w = r0 + yr0 + m;
        if (w >= W) continue;
        __nv_bfloat16* yrow = y + ((size_t)(b * S + t0 + w) * H + h) * dv;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col0 + yc0 + c < dv) yrow[col0 + yc0 + c] = __float2bfloat16(acc[m][c]);
      }
    }

    // ---- state update: S <- S * exp(tot) + k_scaled^T v over the chunk
    float dacc[MI][8];
#pragma unroll
    for (int j = 0; j < MI; ++j)
#pragma unroll
      for (int c = 0; c < 8; ++c) dacc[j][c] = 0.f;
    const int nkt = (W + kKeys - 1) / kKeys;
    __syncthreads();  // every read of q_s, k_s, v_s, p_s and of the old state is done
    float* ksc_s = p_s;  // exp(tot - cum + log_i) per key of the chunk
    for (int w = tid; w < W; w += kThreads)
      ksc_s[w] = expf(tot - cum_s[w] + li_s[w]);
    stage_rows(k_s, ld, kKeys, k_chunk, qk_stride, min(kKeys, W), dk, 0, nchunks, vec);
    cp_async_commit();
    load_v<CW>(vr, v_chunk, v_stride, min(kKeys, W), col0, dv);
    for (int t = 0; t < nkt; ++t) {
      const int buf = t & 1;
      const int u0 = t * kKeys;
      float* vb = v_s + buf * kKeys * CW;
      store_v(vb, vr);
      if (t + 1 < nkt) {
        const int u1 = u0 + kKeys;
        stage_rows(k_s + (buf ^ 1) * kKeys * ld, ld, kKeys,
                   k_chunk + u1 * qk_stride, qk_stride, min(kKeys, W - u1), dk,
                   0, nchunks, vec);
        cp_async_commit();
        load_v<CW>(vr, v_chunk + u1 * v_stride, v_stride, min(kKeys, W - u1),
                   col0, dv);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // key tile t, its v and the k scales are in shared memory
      // k_scaled = fp32(k * exp(tot - cum + log_i)), once per key tile; rows
      // past dk are zeros
      const __nv_bfloat16* kt = k_s + buf * kKeys * ld;
      for (int idx = tid; idx < kKeys * (KSLD / 4); idx += kThreads) {
        const int u = idx / (KSLD / 4), i = 4 * (idx % (KSLD / 4));
        const float sc = u0 + u < W ? ksc_s[u0 + u] : 0.f;
        uint2 raw = make_uint2(0u, 0u);
        if (i < dkp) raw = *reinterpret_cast<const uint2*>(kt + u * ld + i);
        float4 o;
        o.x = __uint_as_float(raw.x << 16) * sc;
        o.y = __uint_as_float(raw.x & 0xffff0000u) * sc;
        o.z = __uint_as_float(raw.y << 16) * sc;
        o.w = __uint_as_float(raw.y & 0xffff0000u) * sc;
        *reinterpret_cast<float4*>(ks_s + u * KSLD + i) = o;
      }
      __syncthreads();  // k_scaled is complete
#pragma unroll 2
      for (int u = 0; u < kKeys; ++u) {
        const float4 v0 = *reinterpret_cast<const float4*>(vb + u * CW + uc0);
        const float4 v1 = *reinterpret_cast<const float4*>(vb + u * CW + CW / 2 + uc0);
        const float* kr = ks_s + u * KSLD + i0;
#pragma unroll
        for (int j = 0; j < MI; j += 4) {
          const float4 a = *reinterpret_cast<const float4*>(kr + j);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            float (&d)[8] = dacc[j + x];
            d[0] = fmaf(av[x], v0.x, d[0]);
            d[1] = fmaf(av[x], v0.y, d[1]);
            d[2] = fmaf(av[x], v0.z, d[2]);
            d[3] = fmaf(av[x], v0.w, d[3]);
            d[4] = fmaf(av[x], v1.x, d[4]);
            d[5] = fmaf(av[x], v1.y, d[5]);
            d[6] = fmaf(av[x], v1.z, d[6]);
            d[7] = fmaf(av[x], v1.w, d[7]);
          }
        }
      }
    }
    const float decay = expf(tot);
#pragma unroll
    for (int j = 0; j < MI; ++j) {
      const int i = i0 + j;
      if (i < dkp) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float4* sp = reinterpret_cast<float4*>(S_s + i * CW + half * (CW / 2) + uc0);
          float4 s = *sp;
          s.x = s.x * decay + dacc[j][4 * half + 0];
          s.y = s.y * decay + dacc[j][4 * half + 1];
          s.z = s.z * decay + dacc[j][4 * half + 2];
          s.w = s.w * decay + dacc[j][4 * half + 3];
          *sp = s;
        }
      }
    }
  }

  __syncthreads();
  for (int idx = tid; idx < dk * CW; idx += kThreads) {
    const int i = idx / CW, c = col0 + idx % CW;
    if (c < dv) state_out[st_base + (size_t)i * dv + c] = S_s[idx];
  }
}

template <int CW, int MI>
int launch(const void* q, const void* k, const void* v, const void* log_f,
           const void* log_i, const void* state_in, void* y, void* state_out,
           int B, int S, int H, int dk, int dv, int W, int vec, size_t smem,
           cudaStream_t s) {
  // above 48 KB the kernel must be allowed the memory, once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel<CW, MI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((dv + CW - 1) / CW, H, B);
  ssd_scan_kernel<CW, MI><<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(log_f),
      static_cast<const float*>(log_i), static_cast<const float*>(state_in),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(state_out), S, H, dk,
      dv, W, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k [B, S, H, dk], v [B, S, H, dv] bf16; log_f, log_i [B, S, H] fp32;
// state_in [B, H, dk, dv] fp32 or null (zeros); y [B, S, H, dv] bf16;
// state_out [B, H, dk, dv] fp32; all contiguous; W divides S. Launch
// geometry from the caller (ssd_scan.py::geometry): cols state columns per
// block and smem bytes of dynamic shared memory; anything else is refused.
// Returns the cudaError_t of the launch.
extern "C" int ssd_scan_bf16(const void* q, const void* k, const void* v,
                             const void* log_f, const void* log_i,
                             const void* state_in, void* y, void* state_out,
                             int B, int S, int H, int dk, int dv, int W,
                             int cols, int smem, void* stream) {
  if (B < 1 || H < 1 || dk < 1 || dk > kMaxDk || dv < 1 || W < 1 ||
      W > kMaxChunk || S % W != 0)
    return (int)cudaErrorInvalidValue;
  if (cols != cols_per_block(dk, dv) || smem < 0 ||
      (size_t)smem != smem_bytes(dk, W, cols) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  // 16-byte row copies need dk % 8 == 0 and 16-byte aligned q and k
  const int vec = (dk % 8 == 0) && ((reinterpret_cast<uintptr_t>(q) |
                                     reinterpret_cast<uintptr_t>(k)) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mi = update_rows(dk, cols);
#define SSD_LAUNCH(CW, MI)                                                     \
  if (cols == CW && mi == MI)                                                  \
    return launch<CW, MI>(q, k, v, log_f, log_i, state_in, y, state_out, B, S, \
                          H, dk, dv, W, vec, smem, s);
  SSD_LAUNCH(64, 12)
  SSD_LAUNCH(64, 4)
  SSD_LAUNCH(32, 8)
  SSD_LAUNCH(32, 4)
  SSD_LAUNCH(16, 4)
#undef SSD_LAUNCH
  return (int)cudaErrorInvalidValue;
}
