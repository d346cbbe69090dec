// Causal / windowed GQA prefill attention with per-sample key lengths.
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
//   (~295), so bytes are the bound. This first
//   version computes on the CUDA cores in fp32 and is limited by them, well
//   above that bound; moving QK^T and PV onto mma/wgmma is the next step.
//
// Design: one block per (q tile of 64 rows, q head, sample); the kv head is
//   h / G. One thread owns one query row: its bf16-rounded q * scale and its
//   fp32 accumulator live in registers. The block walks the keys in tiles of
//   4096 / D rows, staged once in shared memory as fp32 and read by every
//   thread as broadcasts. The walk starts at the window's first key and stops
//   at the causal diagonal of the tile's last row and at kv_valid[b], so dead
//   tiles are never loaded; inside a tile each key is masked per row. Keys are
//   taken 16 at a time with one online-softmax rescale per 16. Ragged edges
//   (Sq not a multiple of 64, the last key tile) are masked, so any ladder
//   rung works. Rows with no valid key reproduce the jnp path
//   (`models/common.py::attention_prefill`): there the -1e30 floor makes every
//   visited key weigh exp(0) = 1 and max(l, 1e-30) divides, so such a row is
//   the mean of V over the key blocks that path visits for the row's q block;
//   `q_block_ref` / `k_block_ref` give that path's block sizes.
//   Rounding as in the jnp path: q * scale in bf16, scores and l in fp32, p
//   rounded to bf16 before the PV product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;     // query rows per block, one per thread
constexpr int kChunk = 16;    // keys per online-softmax rescale
constexpr int kNoWindow = 1 << 30;

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

template <int D>
__global__ void __launch_bounds__(kRows)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ kv_valid,
                       __nv_bfloat16* __restrict__ out,
                       int Sq, int Sk, int Hq, int Hkv, int causal, int window,
                       int q_offset, int q_block_ref, int k_block_ref,
                       float scale) {
  constexpr int BK = 4096 / D;  // keys per shared-memory tile (32 KB for K and V)
  __shared__ __align__(16) float Ks[BK * D];
  __shared__ __align__(16) float Vs[BK * D];

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int kh = h / G;
  const int tid = threadIdx.x;
  const int r = qt * kRows + tid;           // query row of this thread
  const bool row_ok = r < Sq;
  const int w = window > 0 ? window : kNoWindow;
  const int kvv = kv_valid ? min(kv_valid[b], Sk) : Sk;
  const int qpos = q_offset + r;

  // key range the whole tile can see
  const int first_row = q_offset + qt * kRows;
  const int last_row = q_offset + min(qt * kRows + kRows, Sq) - 1;
  const int kstart = max(0, first_row - w + 1);
  int kend = kvv;
  if (causal) kend = min(kend, last_row + 1);

  float qf[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  if (row_ok) {
    const __nv_bfloat162* qr = reinterpret_cast<const __nv_bfloat162*>(
        q + (((size_t)b * Sq + r) * Hq + h) * D);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const __nv_bfloat162 qq = qr[i];
      qf[2 * i] = __bfloat162float(__float2bfloat16(__low2float(qq) * scale));
      qf[2 * i + 1] = __bfloat162float(__float2bfloat16(__high2float(qq) * scale));
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qf[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int t0 = kstart; t0 < kend; t0 += BK) {
    const int nkeys = min(BK, kend - t0);
    __syncthreads();
    for (int idx = tid; idx < BK * (D / 2); idx += kRows) {
      const int j = idx / (D / 2);
      const int i = idx - j * (D / 2);
      float2 kk = make_float2(0.f, 0.f), vv = make_float2(0.f, 0.f);
      if (j < nkeys) {
        const size_t off = (((size_t)b * Sk + t0 + j) * Hkv + kh) * D;
        kk = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(k + off)[i]);
        vv = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(v + off)[i]);
      }
      reinterpret_cast<float2*>(Ks)[idx] = kk;
      reinterpret_cast<float2*>(Vs)[idx] = vv;
    }
    __syncthreads();
    if (!row_ok) continue;

    for (int c = 0; c < nkeys; c += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c + jj;
        const int key = t0 + j;
        bool ok = j < nkeys && key > qpos - w && key < kvv;
        if (causal) ok = ok && key <= qpos;
        float dot = -INFINITY;
        if (ok) {
          // four partial sums: four independent FMA chains, not one
          const float4* kr = reinterpret_cast<const float4*>(Ks + j * D);
          float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 kk = kr[d4];
            d0 += qf[4 * d4] * kk.x;
            d1 += qf[4 * d4 + 1] * kk.y;
            d2 += qf[4 * d4 + 2] * kk.z;
            d3 += qf[4 * d4 + 3] * kk.w;
          }
          dot = (d0 + d1) + (d2 + d3);
        }
        s[jj] = dot;
        cmax = fmaxf(cmax, dot);
      }
      if (cmax == -INFINITY) continue;
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        if (s[jj] == -INFINITY) continue;
        const float p = expf(s[jj] - m_new);
        l += p;
        const float pb = __bfloat162float(__float2bfloat16(p));
        const float4* vr = reinterpret_cast<const float4*>(Vs + (c + jj) * D);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] += pb * vv.x;
          acc[4 * d4 + 1] += pb * vv.y;
          acc[4 * d4 + 2] += pb * vv.z;
          acc[4 * d4 + 3] += pb * vv.w;
        }
      }
      m = m_new;
    }
  }
  if (!row_ok) return;

  __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(
      out + (((size_t)b * Sq + r) * Hq + h) * D);
  if (l > 0.f) {
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      orow[i] = __floats2bfloat162_rn(acc[2 * i] * inv, acc[2 * i + 1] * inv);
    return;
  }
  // No valid key: the jnp path's mean of V over the key blocks it visits.
  const int qb = min(q_block_ref, Sq);
  const int kb = min(k_block_ref, Sk);
  const int nk = Sk / kb;
  const int q_lo = (r / qb) * qb + q_offset;
  const int q_hi = q_lo + qb - 1;
  const int ks = max(0, floordiv(q_lo - w + 1, kb)) * kb;
  const int ke = (causal ? min(floordiv(q_hi, kb) + 1, nk) : nk) * kb;
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int key = ks; key < ke; ++key) {
    const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(
        v + (((size_t)b * Sk + key) * Hkv + kh) * D);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const float2 vv = __bfloat1622float2(vr[i]);
      acc[2 * i] += vv.x;
      acc[2 * i + 1] += vv.y;
    }
  }
  const float inv = ke > ks ? 1.f / (float)(ke - ks) : 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i)
    orow[i] = __floats2bfloat162_rn(acc[2 * i] * inv, acc[2 * i + 1] * inv);
}

template <int D>
void launch(const void* q, const void* k, const void* v, const void* kv_valid,
            void* out, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
            int window, int q_offset, int q_block_ref, int k_block_ref,
            float scale, cudaStream_t s) {
  const dim3 grid((Sq + kRows - 1) / kRows, Hq, B);
  flash_attention_kernel<D><<<grid, kRows, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(kv_valid),
      static_cast<__nv_bfloat16*>(out), Sq, Sk, Hq, Hkv, causal, window,
      q_offset, q_block_ref, k_block_ref, scale);
}

}  // namespace

// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] bf16 contiguous (model layout),
// kv_valid [B] int32 or null, out [B, Sq, Hq, D] bf16. D in {32, 64, 128}.
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* kv_valid, void* out, int B,
                                    int Sq, int Sk, int Hq, int Hkv, int D,
                                    int causal, int window, int q_offset,
                                    int q_block_ref, int k_block_ref,
                                    float scale, void* stream) {
  if (Hkv < 1 || Hq % Hkv || q_block_ref < 1 || k_block_ref < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: launch<32>(q, k, v, kv_valid, out, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, q_block_ref, k_block_ref, scale, s); break;
    case 64: launch<64>(q, k, v, kv_valid, out, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, q_block_ref, k_block_ref, scale, s); break;
    case 128: launch<128>(q, k, v, kv_valid, out, B, Sq, Sk, Hq, Hkv, causal, window, q_offset, q_block_ref, k_block_ref, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
