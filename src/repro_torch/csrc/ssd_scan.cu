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
// Two instances compute that function; ssd_scan.py::pick chooses one from
// static shapes, and the Python side passes each launch's geometry, which
// the entry points check.
//
// What bounds it on the H100: operations. The mLSTM makes one launch per
//   layer with v augmented by the normalizer's ones column, so at the
//   serving path's headline shape (B=8, S=256, H=4, dk=384, dv=385, one
//   chunk) the function needs 0.81 GFLOP of q k^T (causal half; bf16 inputs,
//   fp32 sums: the tensor cores, mma.sync m16n8k16, exact products) and 5.65
//   GFLOP of fp32 work (the state read q.S, the intra-chunk P.V and the
//   state update k_scaled^T v) against 63 MB of bytes: 0.0008 ms at 989
//   TFLOP/s bf16 plus 0.084 ms at 67 TFLOP/s fp32, against 0.019 ms at 3.35
//   TB/s. hymba's SSD (dk = 16, dv = 64, chunks of 256) at its rung-2048
//   prefill (B=8, H=25, 8 chunks) needs 8.5 GFLOP of fp32 work, P.V nearly
//   all of it: 0.127 ms. The fp32 products are fp32 in the reference, so
//   they stay fp32 FMAs on the CUDA cores (no TF32, no split operands) and
//   are nearly all of the bound. What a straightforward version loses its
//   time on is staging and latency, not FMAs (PERF.md §6, timed with one
//   phase compiled out at a time): one that re-staged every key tile up to
//   the diagonal for each 32-row tile with plain synchronous copies took
//   0.41 ms at dv = 1, with almost no fp32 work, and each of its FMAs came
//   with its own shared loads and, in the state update, a multiply
//   rebuilding k_scaled; the serial instance below spends ~0.1 ms of one
//   block's latency on each chunk of 256 at dk = 16, whichever of its
//   products is compiled out.
//
// The serial instance (the mLSTM's dk = 384, and chunks over 256).
//   The state is 576 KB per (b, h) at dk = dv = 384, more than a
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
//   What still holds it back (PERF.md §6): at the headline shape a block
//   needs 226 KB of shared memory, so one block of 8 warps runs on an SM and
//   the 224 blocks take 1.70 waves (two rounds). Inside a block the three
//   fp32 phases issue their FMAs at a little over half the card's fp32 rate,
//   and about half of the block's time lies outside them: the mma chains,
//   the staging and two barriers per key tile, and the per-block setup
//   (state tile, gates, q tiles). A version with 8 x 8 tiles and the state
//   read split four ways over dk (less shared traffic per FMA) was slower,
//   so shared-memory bandwidth is not the limit; latency is.
//
// The chunked instance (dk <= 32, W <= 256: hymba's SSD). One block per
//   (b, h) walking 8 or 12 chunks in order leaves the card idle (25 blocks
//   at the exact 3,072-token prompt), so the work is cut across chunks:
//   - ssd_local_kernel, a block of 4 warps per (state column tile of 64,
//     chunk, b, h): the chunk's cum and tot and its local state L_c =
//     k_scaled^T v (dk x 64, 4 KB at dk = 16) into an fp32 workspace
//     (with one chunk: the final state S0 * exp(tot) + L_0 directly);
//     64-key bf16 tiles by cp.async, converted once to fp32 in shared
//     memory, four warps' partial sums added in warp order;
//   - ssd_carry_kernel, a thread per state element: S <- S * exp(tot_c) +
//     L_c over the chunks in order from the initial state, the same fp32
//     operations in the same order as the serial walk, writing the state
//     before each chunk over its L_c, and the final state;
//   - ssd_y_kernel, a block of 8 warps per (state column tile, chunk, b, h),
//     two an SM: the chunk's q, k (bf16), v (fp32), gates and the state
//     before it staged once, then every warp alone, with no barrier, over
//     two 16-row groups (15 - w, then w: 9 key tiles each at W = 256): the
//     state read, then per 32-key tile q k^T on mma.sync, the decay-masked
//     scores through a per-warp tile in shared memory, and P.V as a 4 x 8
//     register micro-tile a lane (12 16-byte shared loads per 128 FMAs).
//   The scan and y launch with programmatic dependent launch: their blocks
//   become resident while the kernel before them ends, and wait on it only
//   where they read its output.
//   What holds it back (PERF.md §6, scripts/scan_ablation.py --chunked): at
//   rung 2048 P.V is about half of the y launch's time, at some 0.6 of the
//   fp32 rate; staging the chunk, the state reads and the stores take a
//   quarter, the decay (an expf a score) a sixth; the local states' launch
//   is latency-bound; at the exact prompt 300 y blocks take two rounds of
//   264 slots.
//
// Generality: any W <= 1024 dividing S, 1 <= dk <= 512 and any dv; ragged
//   row, key, column and dk tiles are masked (zero-filled copies); dk % 8 !=
//   0 or unaligned q, k stage with plain copies, dv % 8 != 0 or unaligned v
//   with plain loads.

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

// rows [0, nrows) of dst (bf16, row stride ld), NCH 16-byte chunks (8 bf16)
// a row, from rows [0, n) of src (row r at src + r * stride, dk values);
// zero past n rows and dk columns. One flat loop over (row, chunk), so a
// thread copies at most ceil(nrows * NCH / NT) chunks. vec (dk % 8 == 0,
// 16-byte aligned rows): cp.async, in the caller's commit group; else plain
// copies.
template <int NT, int NCH>
__device__ __forceinline__ void stage_rows_flat(__nv_bfloat16* dst, int ld, int nrows,
                                                const __nv_bfloat16* __restrict__ src,
                                                size_t stride, int n, int dk, bool vec) {
  if (vec) {
    const int nv = dk >> 3;
    for (int idx = threadIdx.x; idx < nrows * NCH; idx += NT) {
      const int r = idx / NCH, c = idx % NCH;
      const bool ok = r < n && c < nv;
      cp_async16(dst + r * ld + 8 * c, ok ? src + r * stride + 8 * c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < nrows * NCH * 8; idx += NT) {
      const int r = idx / (NCH * 8), i = idx % (NCH * 8);
      dst[r * ld + i] = (r < n && i < dk) ? src[r * stride + i] : __float2bfloat16(0.f);
    }
  }
}

// log_f and log_i of a chunk's W steps (step w at w * H past the pointers)
// into lf_s and li_s by 4-byte cp.async, in the caller's commit group
template <int NT>
__device__ __forceinline__ void stage_gates(float* lf_s, float* li_s,
                                            const float* __restrict__ lf,
                                            const float* __restrict__ li, int W, int H) {
  for (int w = threadIdx.x; w < W; w += NT) {
    cp_async4(lf_s + w, lf + (size_t)w * H, true);
    cp_async4(li_s + w, li + (size_t)w * H, true);
  }
}

// a [DKP][64] fp32 state tile (64: the chunked instance's state columns a
// block): columns [col0, col0 + 64) of sp's dk x dv rows, zero past dk, dv,
// or everywhere where sp is null; by cp.async (16 bytes where dv % 4 == 0
// and sp is 16-byte aligned, else 4), in the caller's commit group
template <int NT, int DKP>
__device__ __forceinline__ void stage_state(float* dst, const float* __restrict__ sp, int dk,
                                            int dv, int col0) {
  if (sp == nullptr) {
    for (int idx = threadIdx.x; idx < DKP * 64; idx += NT) dst[idx] = 0.f;
  } else if (dv % 4 == 0 && reinterpret_cast<uintptr_t>(sp) % 16 == 0) {
    for (int idx = threadIdx.x; idx < DKP * 16; idx += NT) {
      const int i = idx >> 4, c = col0 + 4 * (idx & 15);
      const bool ok = i < dk && c < dv;
      cp_async16(dst + 4 * idx, ok ? sp + (size_t)i * dv + c : sp, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < DKP * 64; idx += NT) {
      const int i = idx >> 6, c = col0 + (idx & 63);
      const bool ok = i < dk && c < dv;
      cp_async4(dst + idx, ok ? sp + (size_t)i * dv + c : sp, ok);
    }
  }
}

// rows [0, nrows) of dst (bf16, row stride ld), columns [col0, col0 + 64)
// of rows [0, n) of src (row r at src + r * stride, dv values); zero past n
// rows and dv columns. vec (dv % 8 == 0, 16-byte aligned rows): cp.async,
// in the caller's commit group; else plain copies.
template <int NT>
__device__ __forceinline__ void stage_cols(__nv_bfloat16* dst, int ld, int nrows,
                                           const __nv_bfloat16* __restrict__ src,
                                           size_t stride, int n, int col0, int dv, bool vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < nrows * 8; idx += NT) {
      const int r = idx >> 3, c = col0 + 8 * (idx & 7);
      const bool ok = r < n && c < dv;
      cp_async16(dst + r * ld + 8 * (idx & 7), ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < nrows * 64; idx += NT) {
      const int r = idx >> 6, c = idx & 63;
      dst[r * ld + c] = (r < n && col0 + c < dv) ? src[r * stride + col0 + c]
                                                 : __float2bfloat16(0.f);
    }
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

// acc[0..3] += a * lo, acc[4..7] += a * hi
__device__ __forceinline__ void fma8(float (&acc)[8], float a, const float4 lo, const float4 hi) {
  acc[0] = fmaf(a, lo.x, acc[0]);
  acc[1] = fmaf(a, lo.y, acc[1]);
  acc[2] = fmaf(a, lo.z, acc[2]);
  acc[3] = fmaf(a, lo.w, acc[3]);
  acc[4] = fmaf(a, hi.x, acc[4]);
  acc[5] = fmaf(a, hi.y, acc[5]);
  acc[6] = fmaf(a, hi.z, acc[6]);
  acc[7] = fmaf(a, hi.w, acc[7]);
}

// programmatic dependent launch: wait until the kernel before this one in
// the stream has finished and its writes are visible (returns at once in
// a kernel launched without the attribute); let the kernel after this one
// start its blocks
__device__ __forceinline__ void wait_on_predecessor() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// a[0, n) <- its inclusive cumulative sum, by one warp: each lane a run of
// consecutive values, then the lanes' totals by shuffles
__device__ __forceinline__ void warp_cumsum(float* a, int n, int lane) {
  const int per = (n + 31) >> 5;
  const int beg = min(n, lane * per), end = min(n, beg + per);
  float run = 0.f;
  for (int w = beg; w < end; ++w) {
    run += a[w];
    a[w] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
  for (int w = beg; w < end; ++w) a[w] += before;
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
    if (warp == 0) warp_cumsum(cum_s, W, lane);
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

// ---------------------------------------------------------------------------
// The chunked instance (dk <= 32, W <= 256): chunks in parallel, a scan over
// the chunk states. Three launches on the caller's stream:
//   1. ssd_local_kernel, a block per (state column tile, chunk, b * H + h):
//      the chunk's cum and tot and its local state L_c = k_scaled^T v; with
//      one chunk it writes the final state S0 * exp(tot) + L_0 itself, else
//      L_c and tot_c into the workspace;
//   2. ssd_carry_kernel (two or more chunks), a thread per state element:
//      S <- S * exp(tot_c) + L_c over the chunks in order, from the initial
//      state or zeros, writing the state before each chunk c >= 1 over L_c
//      and the final state;
//   3. ssd_y_kernel, a block per (state column tile, chunk, b * H + h):
//      y = exp(cum) * (q . S_before) plus the decay-masked intra-chunk
//      scores times v, rounded once.
// ---------------------------------------------------------------------------

constexpr int kCThreads = 128;      // a local-state block: 4 warps
constexpr int kCCols = 64;          // state columns a block
constexpr int kCKeys = 32;          // keys a y key tile (q k^T, P v)
constexpr int kCPLd = kCKeys + 4;   // row stride of a warp's score tile
constexpr int kCMaxDk = 32;
constexpr int kCarryThreads = 256;
constexpr int kCarryBatch = 8;      // chunks the scan reads ahead
constexpr int kLKeys = 64;          // keys a staged tile of the local-state kernel
constexpr int kLStages = 2;         // its bf16 tiles: one used, the next in flight
constexpr int kVLd = kCCols + 8;    // bf16 row stride of a staged v tile
constexpr int kYWarps = 8;          // a y block: 8 warps, two 16-row groups each
constexpr int kYThreads = 32 * kYWarps;
constexpr int kYBlocksPerSm = 2;    // y blocks an SM, by the launch bounds
constexpr int kYMaxW = 2 * kYWarps * 16;  // the chunk a y block takes: 256

__host__ __device__ __forceinline__ int chunked_dkp(int dk) { return dk <= 16 ? 16 : 32; }

// the local-state kernel's staged bf16 k and v tiles and their fp32 copy,
// whose room the four warps' partial states take at the end
__host__ __device__ __forceinline__ size_t local_tile_bytes(int dkp) {
  const size_t tiles = (size_t)kLStages * kLKeys * (dkp + 8 + kVLd) * 2 +
                       (size_t)kLKeys * (dkp + kCCols) * 4;
  const size_t red = 4 * (size_t)dkp * kCCols * 4;
  return tiles > red ? tiles : red;
}

// bytes of dynamic shared memory, as ssd_scan.py::chunked_smem counts them
size_t local_smem_bytes(int dkp, int W) {
  return local_tile_bytes(dkp)  // k and v tiles, then the partial states
         + 2 * (size_t)W * 4;   // cum, the k scales
}
size_t y_smem_bytes(int dkp, int W) {
  const size_t ld = dkp + 8, wp = (W + kCKeys - 1) / kCKeys * kCKeys;
  return (size_t)dkp * kCCols * 4                 // the state before the chunk
         + (size_t)kYWarps * 16 * kCPLd * 4       // each warp's score tile
         + wp * kCCols * 4                        // v (fp32)
         + 2 * wp * ld * 2                        // q and k rows (bf16)
         + 2 * (size_t)W * 4;                     // cum, log_i
}

// four y values to columns c .. c + 3 of a y row, those below dv
__device__ __forceinline__ void store_y4(__nv_bfloat16* __restrict__ row, int c, int dv,
                                         const float* a, bool vec) {
  if (vec && c + 4 <= dv) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&lo);
    raw.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(row + c) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < dv) row[c + j] = __float2bfloat16(a[j]);
  }
}

// The local state of one chunk over one tile of state columns. The chunk's
// k and v rows arrive in 64-key bf16 tiles by cp.async, the next one in
// flight while a tile is converted once to fp32 (k_scaled = fp32(k *
// exp(tot - cum + log_i)), and v) and used: each warp sums 16 keys of a
// tile, a lane holding MI state rows of 8 columns (cg * 4 .. + 3 and 32 +
// cg * 4 .. + 3); the warps' sums add in warp order.
template <int DKP>
__global__ void __launch_bounds__(kCThreads)
ssd_local_kernel(const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ log_f,
                 const float* __restrict__ log_i,
                 const float* __restrict__ state_in,
                 float* __restrict__ local,
                 float* __restrict__ tot_out,
                 float* __restrict__ state_out,
                 int S, int H, int dk, int dv, int W, int nc, int ncol,
                 int vec_k, int vec_v) {
  constexpr int MI = DKP / 4;
  constexpr int LD = DKP + 8;
  constexpr int KT = kLKeys * LD, VT = kLKeys * kVLd;  // bf16 of a k, v tile
  const int blk = blockIdx.x;
  const int ct = blk % ncol;
  const int ci = (blk / ncol) % nc;
  const int bh = blk / (ncol * nc);
  const int b = bh / H, h = bh % H;
  const int col0 = ct * kCCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kLStages][KT + VT]
  float* ks_f = reinterpret_cast<float*>(tiles + kLStages * (KT + VT));  // [kLKeys][DKP]
  float* v_f = ks_f + kLKeys * DKP;                                      // [kLKeys][kCCols]
  float* red = reinterpret_cast<float*>(smem_raw);  // [4][DKP][kCCols], after the tiles
  float* cum_s = reinterpret_cast<float*>(smem_raw + local_tile_bytes(DKP));  // [W]
  float* sc_s = cum_s + W;  // [W]: log_i, then the k scales

  const int t0 = ci * W;
  const size_t k_stride = (size_t)H * dk, v_stride = (size_t)H * dv;
  const __nv_bfloat16* kp = k + ((size_t)(b * S + t0) * H + h) * dk;
  const __nv_bfloat16* vp = v + ((size_t)(b * S + t0) * H + h) * dv;
  const int nt = (W + kLKeys - 1) / kLKeys;
  auto stage = [&](int t) {
    if (t < nt) {
      const int u0 = t * kLKeys, n = min(kLKeys, W - u0);
      __nv_bfloat16* kt = tiles + (t % kLStages) * (KT + VT);
      stage_rows_flat<kCThreads, DKP / 8>(kt, LD, kLKeys, kp + u0 * k_stride, k_stride, n,
                                          dk, vec_k);
      stage_cols<kCThreads>(kt + KT, kVLd, kLKeys, vp + u0 * v_stride, v_stride, n, col0, dv,
                            vec_v);
    }
    cp_async_commit();
  };
  const size_t g0 = (size_t)(b * S + t0) * H + h;
  stage_gates<kCThreads>(cum_s, sc_s, log_f + g0, log_i + g0, W, H);
  cp_async_commit();
  stage(0);
  cp_async_wait<1>();
  __syncthreads();
  if (warp == 0) warp_cumsum(cum_s, W, lane);
  __syncthreads();
  const float tot = cum_s[W - 1];
  for (int w = tid; w < W; w += kCThreads) sc_s[w] = expf(tot - cum_s[w] + sc_s[w]);

  const int rg = lane >> 3, cg = lane & 7;
  const int i0 = rg * MI;
  float acc[MI][8];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; the last tile's fp32 copy is used up
    stage(t + 1);
    const __nv_bfloat16* kt = tiles + (t % kLStages) * (KT + VT);
    const __nv_bfloat16* vt = kt + KT;
    const int u0 = t * kLKeys;
    // k_scaled, rounded to fp32 before its product, and v, in fp32
    for (int idx = tid; idx < kLKeys * DKP; idx += kCThreads) {
      const int uu = idx / DKP;
      const float s = u0 + uu < W ? sc_s[u0 + uu] : 0.f;
      ks_f[idx] = __bfloat162float(kt[uu * LD + idx % DKP]) * s;
    }
    for (int idx = tid; idx < kLKeys * kCCols / 8; idx += kCThreads) {
      const int uu = idx >> 3, c = 8 * (idx & 7);
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(vt + uu * kVLd + c), f);
      *reinterpret_cast<float4*>(v_f + uu * kCCols + c) = make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(v_f + uu * kCCols + c + 4) = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kLKeys / 4; ++j) {
      const int uu = warp * (kLKeys / 4) + j;
      const float4 va = *reinterpret_cast<const float4*>(v_f + uu * kCCols + cg * 4);
      const float4 vb = *reinterpret_cast<const float4*>(v_f + uu * kCCols + 32 + cg * 4);
#pragma unroll
      for (int i = 0; i < MI; i += 4) {
        const float4 kq = *reinterpret_cast<const float4*>(ks_f + uu * DKP + i0 + i);
        fma8(acc[i], kq.x, va, vb);
        fma8(acc[i + 1], kq.y, va, vb);
        fma8(acc[i + 2], kq.z, va, vb);
        fma8(acc[i + 3], kq.w, va, vb);
      }
    }
  }
  release_dependents();  // the scan's or y's blocks may start their own loads
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the tiles, whose room red takes
  float* mine = red + warp * DKP * kCCols;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    *reinterpret_cast<float4*>(mine + (i0 + i) * kCCols + cg * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(mine + (i0 + i) * kCCols + 32 + cg * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  const size_t st = (size_t)dk * dv;
  const float decay = expf(tot);
  for (int idx = tid; idx < DKP * kCCols; idx += kCThreads) {
    const int i = idx / kCCols, c = col0 + idx % kCCols;
    if (i >= dk || c >= dv) continue;
    float sum = red[idx] + red[DKP * kCCols + idx];
    sum += red[2 * DKP * kCCols + idx];
    sum += red[3 * DKP * kCCols + idx];
    const size_t e = (size_t)i * dv + c;
    if (nc == 1) {
      const float s0 = state_in == nullptr ? 0.f : state_in[bh * st + e];
      state_out[bh * st + e] = s0 * decay + sum;
    } else {
      local[((size_t)bh * nc + ci) * st + e] = sum;
    }
  }
  if (nc > 1 && ct == 0 && tid == 0) tot_out[bh * nc + ci] = tot;
}

// The scan over chunks: a thread per state element of a (b, h), reading
// the local states and tots of kCarryBatch chunks before it writes any.
__global__ void __launch_bounds__(kCarryThreads)
ssd_carry_kernel(float* __restrict__ local, const float* __restrict__ tot,
                 const float* __restrict__ state_in, float* __restrict__ state_out,
                 int n, int per, int nc) {
  wait_on_predecessor();  // the local states and tots are written
  release_dependents();
  const int idx = blockIdx.x * kCarryThreads + threadIdx.x;
  if (idx >= n) return;
  const int bh = idx / per, e = idx % per;
  float s = state_in == nullptr ? 0.f : state_in[idx];
  float* lp = local + (size_t)bh * nc * per + e;
  const float* tp = tot + (size_t)bh * nc;
  for (int c0 = 0; c0 < nc; c0 += kCarryBatch) {
    float l[kCarryBatch], d[kCarryBatch];
#pragma unroll
    for (int j = 0; j < kCarryBatch; ++j) {
      const int c = c0 + j;
      l[j] = c < nc ? lp[(size_t)c * per] : 0.f;
      d[j] = c < nc ? expf(tp[c]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kCarryBatch; ++j) {
      const int c = c0 + j;
      if (c < nc) {
        if (c > 0) lp[(size_t)c * per] = s;  // the state before chunk c
        s = s * d[j] + l[j];
      }
    }
  }
  state_out[idx] = s;
}

// y of one chunk over one tile of state columns, a block of kYWarps warps.
// The chunk's q and k rows (bf16), its v (converted once to fp32), its
// gates and the state before it are staged once; then each warp works
// alone, with no barrier. Warp w owns the chunk's 16-row groups 15 - w and
// w (the longer first; at W = 256 every warp then has 9 key tiles of work):
// for each, the state read exp(cum) * (q . S), then per 32-key tile up to
// the group's last row q k^T by mma.sync (16 x 32), decay-masked into the
// warp's score tile, and P v onto the state read as a register micro-tile,
// a lane holding rows rg + 4 m (m < 4) of 8 columns (cg * 4 .. + 3 and 32 +
// cg * 4 .. + 3).
template <int DKP>
__global__ void __launch_bounds__(kYThreads, kYBlocksPerSm)
ssd_y_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const float* __restrict__ log_f,
             const float* __restrict__ log_i,
             const float* __restrict__ state_in,
             const float* __restrict__ carry,
             __nv_bfloat16* __restrict__ y,
             int S, int H, int dk, int dv, int W, int nc, int ncol,
             int vec_qk, int vec_v8, int vec_y4) {
  constexpr int LD = DKP + 8;
  constexpr int KS = DKP / 16;  // mma k steps
  const int blk = blockIdx.x;
  const int ct = blk % ncol;
  const int ci = (blk / ncol) % nc;
  const int bh = blk / (ncol * nc);
  const int b = bh / H, h = bh % H;
  const int col0 = ct * kCCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Wp = (W + kCKeys - 1) / kCKeys * kCKeys;  // rows staged, zero past W

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* S_s = reinterpret_cast<float*>(smem_raw);                              // [DKP][kCCols]
  float* p_s = S_s + DKP * kCCols;                                             // [kYWarps][16][kCPLd]
  float* v_f = p_s + kYWarps * 16 * kCPLd;                                     // [Wp][kCCols]
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(v_f + Wp * kCCols);    // [Wp][LD]
  __nv_bfloat16* k_s = q_s + Wp * LD;                                          // [Wp][LD]
  float* cum_s = reinterpret_cast<float*>(k_s + Wp * LD);                      // [W]
  float* li_s = cum_s + W;                                                     // [W]

  const int t0 = ci * W;
  const size_t qk_stride = (size_t)H * dk, v_stride = (size_t)H * dv;
  const __nv_bfloat16* q_chunk = q + ((size_t)(b * S + t0) * H + h) * dk;
  const __nv_bfloat16* k_chunk = k + ((size_t)(b * S + t0) * H + h) * dk;
  const __nv_bfloat16* v_chunk = v + ((size_t)(b * S + t0) * H + h) * dv;

  // q, k and the gates by cp.async; v through registers to fp32, four
  // 8-column runs a thread in flight at once
  stage_rows_flat<kYThreads, DKP / 8>(q_s, LD, Wp, q_chunk, qk_stride, W, dk, vec_qk);
  stage_rows_flat<kYThreads, DKP / 8>(k_s, LD, Wp, k_chunk, qk_stride, W, dk, vec_qk);
  const size_t g0 = (size_t)(b * S + t0) * H + h;
  stage_gates<kYThreads>(cum_s, li_s, log_f + g0, log_i + g0, W, H);
  cp_async_commit();
  if (vec_v8) {
    for (int base = tid; base < Wp * 8; base += 4 * kYThreads) {
      uint4 raw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = base + j * kYThreads;
        const int r = idx >> 3, c = col0 + 8 * (idx & 7);
        raw[j] = make_uint4(0u, 0u, 0u, 0u);
        if (idx < Wp * 8 && r < W && c < dv)
          raw[j] = *reinterpret_cast<const uint4*>(v_chunk + r * v_stride + c);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = base + j * kYThreads;
        if (idx < Wp * 8) {
          float f[8];
          unpack8(raw[j], f);
          float* d = v_f + (idx >> 3) * kCCols + 8 * (idx & 7);
          *reinterpret_cast<float4*>(d) = make_float4(f[0], f[1], f[2], f[3]);
          *reinterpret_cast<float4*>(d + 4) = make_float4(f[4], f[5], f[6], f[7]);
        }
      }
    }
  } else {
    for (int idx = tid; idx < Wp * kCCols; idx += kYThreads) {
      const int r = idx >> 6, c = col0 + (idx & 63);
      v_f[idx] = (r < W && c < dv) ? __bfloat162float(v_chunk[r * v_stride + c]) : 0.f;
    }
  }
  // once the kernel before has finished (the scan, or the local states with
  // one chunk; so that this grid's end implies that one's), the state before
  // the chunk: the initial state or zeros at chunk 0, else the carry
  wait_on_predecessor();
  const size_t st = (size_t)dk * dv;
  stage_state<kYThreads, DKP>(
      S_s,
      ci == 0 ? (state_in == nullptr ? nullptr : state_in + bh * st)
              : carry + ((size_t)bh * nc + ci) * st,
      dk, dv, col0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) warp_cumsum(cum_s, W, lane);
  __syncthreads();

  const int rg = lane >> 3, cg = lane & 7;
  const int g = lane >> 2, tq = lane & 3;
  const int ngroups = (W + 15) >> 4;
  float* pw = p_s + warp * 16 * kCPLd;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const int grp = pass == 0 ? 2 * kYWarps - 1 - warp : warp;
    if (grp >= ngroups) continue;
    const int r0 = grp * 16;  // the group's first row in the chunk

    // state read: acc[m][c] = q[row m] . S[:, column c], then * exp(cum[row])
    float acc[4][8];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[m][c] = 0.f;
#pragma unroll
    for (int i = 0; i < DKP; i += 8) {
      float qf[4][8];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        unpack8(*reinterpret_cast<const uint4*>(q_s + (r0 + rg + 4 * m) * LD + i), qf[m]);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float4 s0 = *reinterpret_cast<const float4*>(S_s + (i + kk) * kCCols + cg * 4);
        const float4 s1 = *reinterpret_cast<const float4*>(S_s + (i + kk) * kCCols + 32 + cg * 4);
#pragma unroll
        for (int m = 0; m < 4; ++m) fma8(acc[m], qf[m][kk], s0, s1);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int w = r0 + rg + 4 * m;
      const float e = w < W ? expf(cum_s[w]) : 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[m][c] *= e;
    }

    // the group's q fragments (rows r0 + g and r0 + g + 8) and their cum
    uint32_t qa[KS][4];
    {
      const uint32_t* ra = reinterpret_cast<const uint32_t*>(q_s + (r0 + g) * LD);
      const uint32_t* rb = reinterpret_cast<const uint32_t*>(q_s + (r0 + g + 8) * LD);
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int c = s * 8 + tq;
        qa[s][0] = ra[c];
        qa[s][1] = rb[c];
        qa[s][2] = ra[c + 4];
        qa[s][3] = rb[c + 4];
      }
    }
    const int wa = r0 + g, wb = wa + 8;
    const float cum_a = wa < W ? cum_s[wa] : 0.f, cum_b = wb < W ? cum_s[wb] : 0.f;
    const int nkt = (r0 + 15) / kCKeys + 1;  // key tiles up to the group's last row
    for (int t = 0; t < nkt; ++t) {
      const int u0 = t * kCKeys;
      float sc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        const uint32_t* kf = reinterpret_cast<const uint32_t*>(k_s + (u0 + 8 * n + g) * LD);
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const int c = s * 8 + tq;
          mma_bf16(sc[n], qa[s][0], qa[s][1], qa[s][2], qa[s][3], kf[c], kf[c + 4]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int key = 8 * n + 2 * tq;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = u0 + key + (e & 1);
          const int w = (e >> 1) ? wb : wa;
          const float cw = (e >> 1) ? cum_b : cum_a;
          p[e] = (u <= w && w < W) ? sc[n][e] * expf(cw - cum_s[u] + li_s[u]) : 0.f;
        }
        *reinterpret_cast<float2*>(pw + g * kCPLd + key) = make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(pw + (g + 8) * kCPLd + key) = make_float2(p[2], p[3]);
      }
      __syncwarp();
      const float* vb = v_f + u0 * kCCols;
#pragma unroll 2
      for (int uu = 0; uu < kCKeys; uu += 4) {
        float4 pr[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          pr[m] = *reinterpret_cast<const float4*>(pw + (rg + 4 * m) * kCPLd + uu);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float4 v0 = *reinterpret_cast<const float4*>(vb + (uu + x) * kCCols + cg * 4);
          const float4 v1 = *reinterpret_cast<const float4*>(vb + (uu + x) * kCCols + 32 + cg * 4);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float pv = x == 0 ? pr[m].x : x == 1 ? pr[m].y : x == 2 ? pr[m].z : pr[m].w;
            fma8(acc[m], pv, v0, v1);
          }
        }
      }
      __syncwarp();  // the score tile is read; the next one may overwrite it
    }

#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int w = r0 + rg + 4 * m;
      if (w >= W) continue;
      __nv_bfloat16* yrow = y + ((size_t)(b * S + t0 + w) * H + h) * dv;
      store_y4(yrow, col0 + cg * 4, dv, &acc[m][0], vec_y4);
      store_y4(yrow, col0 + 32 + cg * 4, dv, &acc[m][4], vec_y4);
    }
  }
}

template <int DKP>
int launch_chunked(const void* q, const void* k, const void* v, const void* log_f,
                   const void* log_i, const void* state_in, void* y, void* state_out,
                   void* ws, int B, int S, int H, int dk, int dv, int W, int vec_qk,
                   int vec_v8, int vec_y4, size_t smem_local, size_t smem_y,
                   cudaStream_t s) {
  static const cudaError_t smem_attr = [] {
    cudaError_t e = cudaFuncSetAttribute(ssd_local_kernel<DKP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ssd_y_kernel<DKP>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  }();
  if (smem_attr != cudaSuccess) return (int)smem_attr;
  const int nc = S / W, ncol = (dv + kCCols - 1) / kCCols;
  const int bhs = B * H;
  float* local = static_cast<float*>(ws);
  float* tot = local == nullptr ? nullptr : local + (size_t)bhs * nc * dk * dv;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
  const float* lf = static_cast<const float*>(log_f);
  const float* li = static_cast<const float*>(log_i);
  const float* s0 = static_cast<const float*>(state_in);
  float* so = static_cast<float*>(state_out);
  ssd_local_kernel<DKP><<<ncol * nc * bhs, kCThreads, smem_local, s>>>(
      kb, vb, lf, li, s0, local, tot, so, S, H, dk, dv, W, nc, ncol, vec_qk, vec_v8);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the scan and y with programmatic dependent launch: their blocks start
  // while the kernel before them ends, and wait on it where they need it
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (nc > 1) {
    const int n = bhs * dk * dv;
    cfg.gridDim = dim3((n + kCarryThreads - 1) / kCarryThreads);
    cfg.blockDim = dim3(kCarryThreads);
    cfg.dynamicSmemBytes = 0;
    e = cudaLaunchKernelEx(&cfg, ssd_carry_kernel, local, static_cast<const float*>(tot), s0,
                           so, n, dk * dv, nc);
    if (e != cudaSuccess) return (int)e;
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  cfg.gridDim = dim3(ncol * nc * bhs);
  cfg.blockDim = dim3(kYThreads);
  cfg.dynamicSmemBytes = smem_y;
  e = cudaLaunchKernelEx(&cfg, ssd_y_kernel<DKP>, qb, kb, vb, lf, li, s0,
                         static_cast<const float*>(local), static_cast<__nv_bfloat16*>(y), S, H,
                         dk, dv, W, nc, ncol, vec_qk, vec_v8, vec_y4);
  if (e != cudaSuccess) return (int)e;
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

// The chunked instance (dk <= 32, W <= 256): the same function and arguments, plus an
// fp32 workspace of B * H * nc * (dk * dv + 1) floats (null with one
// chunk: the local-state launch writes the final state itself); the blocks
// of the local-state and y launches (one a state column tile, chunk and
// (b, h) each) and their shared memory from the caller
// (ssd_scan.py::geometry), anything else refused. Three launches (two with
// one chunk) on the stream; returns the first failing one's cudaError_t.
extern "C" int ssd_scan_chunked_bf16(const void* q, const void* k, const void* v,
                                     const void* log_f, const void* log_i,
                                     const void* state_in, void* y, void* state_out,
                                     void* ws, int B, int S, int H, int dk, int dv,
                                     int W, int blocks, int smem_local, int smem_y,
                                     void* stream) {
  if (B < 1 || H < 1 || dk < 1 || dk > kCMaxDk || dv < 1 || W < 1 || W > kYMaxW ||
      S % W != 0)
    return (int)cudaErrorInvalidValue;
  const int nc = S / W, ncol = (dv + kCCols - 1) / kCCols;
  const int dkp = chunked_dkp(dk);
  if (blocks != ncol * nc * B * H ||
      smem_local < 0 || (size_t)smem_local != local_smem_bytes(dkp, W) || smem_y < 0 ||
      (size_t)smem_y != y_smem_bytes(dkp, W) || (nc > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const uintptr_t qk = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k);
  const int vec_qk = dk % 8 == 0 && qk % 16 == 0;
  const int vec_v8 = dv % 8 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int vec_y4 = dv % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dkp == 16)
    return launch_chunked<16>(q, k, v, log_f, log_i, state_in, y, state_out, ws, B, S, H, dk,
                              dv, W, vec_qk, vec_v8, vec_y4, smem_local, smem_y, s);
  return launch_chunked<32>(q, k, v, log_f, log_i, state_in, y, state_out, ws, B, S, H, dk,
                            dv, W, vec_qk, vec_v8, vec_y4, smem_local, smem_y, s);
}
