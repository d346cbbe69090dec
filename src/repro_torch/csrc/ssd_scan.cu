// Chunked linear-attention scan (the mLSTM / mamba-SSD hot path) in the
// model layout, with a carried initial state.
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py, function `ssd_scan`
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
//   is updated; y is rounded to bf16 once, at the end.
//
// What bounds it on the H100: operations. The mLSTM makes one launch per
//   layer with v augmented by the normalizer's ones column, so at the
//   serving path's headline shape (B=8, S=256, H=4, dk=384, dv=385, one
//   chunk) the function needs 2*B*H*W(W+1)/2*dk = 0.81 GFLOP of q k^T
//   (causal half; bf16 inputs, fp32 sums) and 2*B*H*(W(W+1)/2*dv +
//   2*S*dk*dv) = 5.65 GFLOP of fp32 work (the intra-chunk product, the
//   state read and the state update) against 63 MB of bytes (q, k, v, y in
//   bf16, the fp32 state in and out): 0.0008 ms at 989 TFLOP/s bf16 plus
//   0.084 ms at 67 TFLOP/s fp32, against 0.019 ms at 3.35 TB/s. The state
//   products are fp32 in the reference, so they run as fp32 FMAs on the
//   CUDA cores (never TF32) and are nearly all of the bound; q k^T has
//   bf16 inputs and fp32 sums in the reference, so it runs on the tensor
//   cores (mma.sync m16n8k16 bf16 -> fp32: exact products, fp32 sums).
//
// Design: at dk = dv = 384 the state is 576 KB per (b, h), more than one
//   block's shared memory, so the Pallas design (one program holds the whole
//   state) does not carry over. State columns are independent, so the grid
//   is (dv / 32, H, B): each block owns a [dk, 32] fp32 state tile in shared
//   memory (48 KB at dk = 384), one column per lane, and walks the chunks in
//   order. Per chunk it stages the gates and their cumulative sum, then
//   takes the chunk's rows 32 at a time: the row tile of q goes to shared
//   memory (bf16, 16-byte copies), each warp owns 4 of its rows for y, and
//   y_state is the q tile times the state tile. The decay-masked scores are
//   recomputed for the block's own tile from 32-key tiles of k, skipping
//   every key tile above the diagonal: each warp computes one 16 x 8 score
//   tile with mma.sync, masks and decays it into shared memory, and the
//   block multiplies the 32 x 32 tile by the key tile's v. After the last
//   row tile (a barrier: y read the old state), the state update streams the
//   chunk's keys once more, each warp accumulating its rows of the state
//   tile in registers (k * exp(tot - cum + log_i) rounded in fp32 first, as
//   the reference rounds k_scaled). q and k tiles are padded rows (stride
//   dk + 8 bf16) so the fragment loads do not collide in banks. The block
//   uses ~108 KB of shared memory and at most 128 registers a thread, so two
//   blocks share an SM. The price of the column split is that every block
//   recomputes its chunk's q k^T (dv / 32 times per (b, h)); on the tensor
//   cores that is a small part of the work. Any W, S multiple of W,
//   1 <= dk <= 512 and any dv work (the mLSTM's dv = hd + 1 ends in a
//   one-column tile); ragged tiles are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;                     // state columns per block
constexpr int kRows = 32;                     // chunk rows per row tile
constexpr int kKeys = 32;                     // chunk keys per key tile
constexpr int kRowsPerWarp = kRows / kWarps;  // 4
constexpr int kMaxDk = 512;
constexpr int kMaxStateRowsPerWarp = kMaxDk / kWarps;  // 64
constexpr int kMaxChunk = 1024;

// dk padded to the mma's k step (16); tile rows hold 8 more bf16
__host__ __device__ __forceinline__ int padded_dk(int dk) { return (dk + 15) & ~15; }
__host__ __device__ __forceinline__ int tile_ld(int dk) { return padded_dk(dk) + 8; }

// bytes of dynamic shared memory for (dk, W)
__host__ __device__ __forceinline__ size_t smem_bytes(int dk, int W) {
  return (size_t)padded_dk(dk) * kCols * 4        // state tile
         + 2 * (size_t)kRows * tile_ld(dk) * 2    // q row tile, k key tile (bf16)
         + (size_t)kKeys * kCols * 4              // v key tile
         + (size_t)kRows * (kKeys + 1) * 4        // decay-masked scores
         + 3 * (size_t)W * 4;                     // cum, log_i, k scale
}

// rows [t, t + n) of a [B, S, H, dk] bf16 array at (b, h) -> dst[r][i]
// (bf16, row stride ld), zero past n rows and dk columns, kRows rows in all.
// vec: dk % 8 == 0 and 16-byte aligned rows, copied 8 values at a time.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* __restrict__ src,
                                           int b, int t, int n, int S, int H,
                                           int h, int dk, int dkp, bool vec) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (vec) {
    const int nv = dk >> 3, nvp = dkp >> 3;
#pragma unroll
    for (int rr = 0; rr < kRows / kWarps; ++rr) {
      const int r = warp + rr * kWarps;
      const uint4* row = reinterpret_cast<const uint4*>(
          src + ((size_t)(b * S + t + r) * H + h) * dk);
      for (int c = lane; c < nvp; c += 32) {
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < n && c < nv) val = row[c];
        *reinterpret_cast<uint4*>(dst + r * ld + 8 * c) = val;
      }
    }
  } else {
    for (int r = warp; r < kRows; r += kWarps)
      for (int i = lane; i < dkp; i += 32)
        dst[r * ld + i] = (r < n && i < dk)
                              ? src[((size_t)(b * S + t + r) * H + h) * dk + i]
                              : __float2bfloat16(0.f);
  }
}

// v[t .. t + n)[col] of a [B, S, H, dv] bf16 array -> v_s[u][lane] (fp32)
__device__ __forceinline__ void stage_v(float* v_s,
                                        const __nv_bfloat16* __restrict__ v,
                                        int b, int t, int n, int S, int H,
                                        int h, int dv, int col, bool col_ok) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int u = warp; u < kKeys; u += kWarps)
    v_s[u * kCols + lane] =
        (u < n && col_ok)
            ? __bfloat162float(v[((size_t)(b * S + t + u) * H + h) * dv + col])
            : 0.f;
}

// four consecutive bf16 (8-byte aligned) as floats
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
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

__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ log_f,
                const float* __restrict__ log_i,
                const float* __restrict__ state_in,
                __nv_bfloat16* __restrict__ y,
                float* __restrict__ state_out,
                int S, int H, int dk, int dv, int W, int vec) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kCols + lane;
  const bool col_ok = col < dv;
  const int dkp = padded_dk(dk);
  const int ld = tile_ld(dk);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* S_s = reinterpret_cast<float*>(smem_raw);            // [dkp][kCols]
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(S_s + dkp * kCols);  // [kRows][ld]
  __nv_bfloat16* k_s = q_s + kRows * ld;                      // [kKeys][ld]
  float* v_s = reinterpret_cast<float*>(k_s + kKeys * ld);    // [kKeys][kCols]
  float* p_s = v_s + kKeys * kCols;                           // [kRows][kKeys + 1]
  float* cum_s = p_s + kRows * (kKeys + 1);                   // [W]
  float* li_s = cum_s + W;                                    // [W]
  float* ks_s = li_s + W;                                     // [W] exp(tot - cum + log_i)

  const size_t st_base = (size_t)(b * H + h) * dk * dv;
  for (int i = warp; i < dkp; i += kWarps)
    S_s[i * kCols + lane] = (state_in != nullptr && i < dk && col_ok)
                                ? state_in[st_base + (size_t)i * dv + col]
                                : 0.f;

  // the warp's state rows in the update: [rbase, rbase + rpw)
  const int rpw = ((dkp + kWarps - 1) / kWarps + 3) & ~3;
  const int rbase = warp * rpw;
  const int my_row0 = warp * kRowsPerWarp;  // the warp's rows of y
  // the warp's 16 x 8 score tile and its mma fragment coordinates
  const int srow = (warp >> 2) * 16, skey = (warp & 3) * 8;
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t* qa = reinterpret_cast<const uint32_t*>(q_s + (srow + g) * ld);
  const uint32_t* qb = reinterpret_cast<const uint32_t*>(q_s + (srow + g + 8) * ld);
  const uint32_t* kf = reinterpret_cast<const uint32_t*>(k_s + (skey + g) * ld);

  const int nc = S / W;
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * W;
    __syncthreads();  // the previous chunk is done with cum_s, li_s, ks_s
    for (int w = threadIdx.x; w < W; w += kThreads) {
      const size_t gi = (size_t)(b * S + t0 + w) * H + h;
      cum_s[w] = log_f[gi];
      li_s[w] = log_i[gi];
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // inclusive cumulative sum, in order
      float acc = 0.f;
      for (int w = 0; w < W; ++w) {
        acc += cum_s[w];
        cum_s[w] = acc;
      }
    }
    __syncthreads();
    const float tot = cum_s[W - 1];
    for (int w = threadIdx.x; w < W; w += kThreads)
      ks_s[w] = expf(tot - cum_s[w] + li_s[w]);

    // ---- y for the chunk, 32 rows at a time, from the state before it
    for (int r0 = 0; r0 < W; r0 += kRows) {
      const int nr = min(kRows, W - r0);
      __syncthreads();  // q_s, k_s, v_s, p_s free
      stage_rows(q_s, ld, q, b, t0 + r0, nr, S, H, h, dk, dkp, vec);
      __syncthreads();

      float ys[kRowsPerWarp], yi[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) ys[r] = yi[r] = 0.f;
      for (int i = 0; i < dkp; i += 4) {
        const float s0 = S_s[(i + 0) * kCols + lane];
        const float s1 = S_s[(i + 1) * kCols + lane];
        const float s2 = S_s[(i + 2) * kCols + lane];
        const float s3 = S_s[(i + 3) * kCols + lane];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 qq = load4(q_s + (my_row0 + r) * ld + i);
          ys[r] = fmaf(qq.x, s0, ys[r]);
          ys[r] = fmaf(qq.y, s1, ys[r]);
          ys[r] = fmaf(qq.z, s2, ys[r]);
          ys[r] = fmaf(qq.w, s3, ys[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int w = r0 + my_row0 + r;
        ys[r] = w < W ? ys[r] * expf(cum_s[w]) : 0.f;
      }

      const int kend = r0 + nr;  // keys u <= the tile's last row
      for (int u0 = 0; u0 < kend; u0 += kKeys) {
        const int nu = min(kKeys, kend - u0);
        __syncthreads();  // k_s, v_s, p_s free
        stage_rows(k_s, ld, k, b, t0 + u0, nu, S, H, h, dk, dkp, vec);
        stage_v(v_s, v, b, t0 + u0, nu, S, H, h, dv, col, col_ok);
        __syncthreads();
        // the warp's 16 x 8 tile of q k^T on the tensor cores
        float sc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = 0; k0 < dkp; k0 += 16) {
          const int c = (k0 >> 1) + tq;
          mma_bf16(sc, qa[c], qb[c], qa[c + 4], qb[c + 4], kf[c], kf[c + 4]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = srow + g + (e >> 1) * 8;
          const int key = skey + 2 * tq + (e & 1);
          const int w = r0 + row;
          const int u = u0 + key;
          float p = 0.f;
          if (key < nu && u <= w && w < W)
            p = sc[e] * expf(cum_s[w] - cum_s[u] + li_s[u]);
          p_s[row * (kKeys + 1) + key] = p;
        }
        __syncthreads();
        for (int uu = 0; uu < nu; ++uu) {
          const float vv = v_s[uu * kCols + lane];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            yi[r] = fmaf(p_s[(my_row0 + r) * (kKeys + 1) + uu], vv, yi[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int w = r0 + my_row0 + r;
        if (w < W && col_ok)
          y[((size_t)(b * S + t0 + w) * H + h) * dv + col] =
              __float2bfloat16(ys[r] + yi[r]);
      }
    }

    // ---- state update: S <- S * exp(tot) + (k * ks)^T v over the chunk
    float acc[kMaxStateRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kMaxStateRowsPerWarp; ++j) acc[j] = 0.f;
    for (int u0 = 0; u0 < W; u0 += kKeys) {
      const int nu = min(kKeys, W - u0);
      __syncthreads();  // every read of k_s, v_s and of the old S_s is done
      stage_rows(k_s, ld, k, b, t0 + u0, nu, S, H, h, dk, dkp, vec);
      stage_v(v_s, v, b, t0 + u0, nu, S, H, h, dv, col, col_ok);
      __syncthreads();
      for (int uu = 0; uu < nu; ++uu) {
        const float vv = v_s[uu * kCols + lane];
        const float ksu = ks_s[u0 + uu];
        const __nv_bfloat16* kr = k_s + uu * ld + rbase;
#pragma unroll
        for (int j = 0; j < kMaxStateRowsPerWarp; j += 4) {
          if (j < rpw && rbase + j < dkp) {
            const float4 kk = load4(kr + j);
            acc[j + 0] = fmaf(kk.x * ksu, vv, acc[j + 0]);
            acc[j + 1] = fmaf(kk.y * ksu, vv, acc[j + 1]);
            acc[j + 2] = fmaf(kk.z * ksu, vv, acc[j + 2]);
            acc[j + 3] = fmaf(kk.w * ksu, vv, acc[j + 3]);
          }
        }
      }
    }
    const float decay = expf(tot);
#pragma unroll
    for (int j = 0; j < kMaxStateRowsPerWarp; ++j) {
      const int i = rbase + j;
      if (j < rpw && i < dkp)
        S_s[i * kCols + lane] = S_s[i * kCols + lane] * decay + acc[j];
    }
  }

  __syncthreads();
  if (col_ok)
    for (int i = warp; i < dk; i += kWarps)
      state_out[st_base + (size_t)i * dv + col] = S_s[i * kCols + lane];
}

}  // namespace

// q, k [B, S, H, dk], v [B, S, H, dv] bf16; log_f, log_i [B, S, H] fp32;
// state_in [B, H, dk, dv] fp32 or null (zeros); y [B, S, H, dv] bf16;
// state_out [B, H, dk, dv] fp32; all contiguous; W divides S. Returns the
// cudaError_t of the launch.
extern "C" int ssd_scan_bf16(const void* q, const void* k, const void* v,
                             const void* log_f, const void* log_i,
                             const void* state_in, void* y, void* state_out,
                             int B, int S, int H, int dk, int dv, int W,
                             void* stream) {
  if (B < 1 || H < 1 || dk < 1 || dk > kMaxDk || dv < 1 || W < 1 ||
      W > kMaxChunk || S % W != 0)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = smem_bytes(dk, W);
  static size_t opted_in = 48 * 1024;
  if (shmem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = shmem;
  }
  // 16-byte row copies need dk % 8 == 0 and 16-byte aligned q and k
  const int vec = (dk % 8 == 0) && ((reinterpret_cast<uintptr_t>(q) |
                                     reinterpret_cast<uintptr_t>(k)) % 16 == 0);
  const dim3 grid((dv + kCols - 1) / kCols, H, B);
  ssd_scan_kernel<<<grid, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(log_f),
      static_cast<const float*>(log_i), static_cast<const float*>(state_in),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(state_out), S, H, dk,
      dv, W, vec);
  return (int)cudaGetLastError();
}
