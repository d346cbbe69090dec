// Single-token GQA decode attention against the model-layout KV cache.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py,
//   function `decode_attention` (Pallas TPU kernel, grid (B, Hkv, nK), online
//   softmax carried in VMEM scratch across the sequential k-tile axis).
//
// What bounds it on the H100: bytes. A decode step reads every valid K and V
//   row once (2 * B * len * Hkv * D * 2 bytes) and does 4 * G flops per
//   element read, far below the ~295 flops/byte the tensor cores need. So the
//   kernel's only job is to stream the cache once, coalesced.
//
// Design: one block per (kv head, sample). Its 8 warps stride over the valid
//   positions [max(0, len - window), len), 4 positions per warp step (their
//   loads and shuffle reductions in flight together); a warp reads each
//   2*D-byte K row and V row once (one bf16 pair per lane, neighbouring
//   lanes on neighbouring addresses) and applies it to all G query heads of the
//   kv head at once, so each K/V row leaves device memory once per step
//   however many query heads share it (the GQA saving the TPU kernel gets
//   from its [G, D] block). Masked positions are never read. Each warp keeps
//   its own fp32 online-softmax state; the warps are merged through shared
//   memory at the end. No power-of-two tiling: any Smax and any G <= 8 work.
//   A row with no valid key (lengths == 0) outputs 0.
//   Rounding: q * scale is rounded to bf16 before the dot products, as the
//   jnp path (`models/common.py::attention_decode`) does; p stays fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxG = 8;
constexpr int kUnroll = 4;  // positions per warp step

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// P: bf16 pairs per lane (D <= 64 * P).
template <int P>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out,
                        int Smax, int Hkv, int G, int D, int window,
                        float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int npairs = D >> 1;
  const int Hq = Hkv * G;

  const int len = lengths[b];
  const int hi = min(len, Smax);
  const int lo = window > 0 ? max(0, len - window) : 0;

  float qf[kMaxG][P][2];
  float acc[kMaxG][P][2];
  float m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      qf[g][p][0] = qf[g][p][1] = 0.f;
      acc[g][p][0] = acc[g][p][1] = 0.f;
      const int i = lane + 32 * p;
      if (g < G && i < npairs) {
        const __nv_bfloat162 qq = reinterpret_cast<const __nv_bfloat162*>(
            q + ((size_t)b * Hq + (size_t)h * G + g) * D)[i];
        qf[g][p][0] = __bfloat162float(__float2bfloat16(__low2float(qq) * scale));
        qf[g][p][1] = __bfloat162float(__float2bfloat16(__high2float(qq) * scale));
      }
    }
  }

  // each warp takes kUnroll consecutive positions per step: their K and V
  // rows are loaded together and their dot products reduced together, so
  // kUnroll memory and shuffle chains are in flight instead of one
  for (int j0 = lo + warp * kUnroll; j0 < hi; j0 += kWarps * kUnroll) {
    float kf[kUnroll][P][2], vf[kUnroll][P][2];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
      const size_t row = (((size_t)b * Smax + j) * Hkv + h) * D;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int i = lane + 32 * p;
        kf[u][p][0] = kf[u][p][1] = vf[u][p][0] = vf[u][p][1] = 0.f;
        if (j < hi && i < npairs) {
          const __nv_bfloat162 kk = reinterpret_cast<const __nv_bfloat162*>(k + row)[i];
          const __nv_bfloat162 vv = reinterpret_cast<const __nv_bfloat162*>(v + row)[i];
          kf[u][p][0] = __low2float(kk);
          kf[u][p][1] = __high2float(kk);
          vf[u][p][0] = __low2float(vv);
          vf[u][p][1] = __high2float(vv);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float s[kUnroll];
        float smax = -INFINITY;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float part = 0.f;
#pragma unroll
          for (int p = 0; p < P; ++p)
            part += qf[g][p][0] * kf[u][p][0] + qf[g][p][1] * kf[u][p][1];
          s[u] = part;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          s[u] = warp_sum(s[u]);
          if (j0 + u >= hi) s[u] = -INFINITY;
          smax = fmaxf(smax, s[u]);
        }
        const float m_new = fmaxf(m[g], smax);
        const float corr = expf(m[g] - m_new);
        l[g] *= corr;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          acc[g][p][0] *= corr;
          acc[g][p][1] *= corr;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float pr = expf(s[u] - m_new);   // 0 past hi
          l[g] += pr;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            acc[g][p][0] += pr * vf[u][p][0];
            acc[g][p][1] += pr * vf[u][p][1];
          }
        }
        m[g] = m_new;
      }
    }
  }

  // merge the warps: shared layout acc [kWarps][G][D], m [kWarps][G], l [kWarps][G]
  extern __shared__ float smem[];
  float* acc_s = smem;
  float* m_s = acc_s + kWarps * G * D;
  float* l_s = m_s + kWarps * G;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int i = lane + 32 * p;
        if (i < npairs) {
          acc_s[(warp * G + g) * D + 2 * i] = acc[g][p][0];
          acc_s[(warp * G + g) * D + 2 * i + 1] = acc[g][p][1];
        }
      }
      if (lane == 0) {
        m_s[warp * G + g] = m[g];
        l_s[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * G + g]);
    float o = 0.f;
    if (mx > -INFINITY) {
      float den = 0.f, num = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(m_s[w * G + g] - mx);
        den += l_s[w * G + g] * f;
        num += acc_s[(w * G + g) * D + d] * f;
      }
      o = num / den;
    }
    out[((size_t)b * Hq + (size_t)h * G + g) * D + d] = __float2bfloat16(o);
  }
}

}  // namespace

// q [B, Hq, D], k/v [B, Smax, Hkv, D] bf16 contiguous, lengths [B] int32,
// out [B, Hq, D] bf16. Returns the cudaError_t of the launch.
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* out, int B, int Smax, int Hkv,
                                     int G, int D, int window, float scale,
                                     void* stream) {
  if (G < 1 || G > kMaxG || D < 2 || D > 128 || (D & 1)) return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
  const dim3 block(kWarps * 32);
  const size_t shmem = (size_t)kWarps * G * (D + 2) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D <= 64)
    decode_attention_kernel<1><<<grid, block, shmem, s>>>(qp, kp, vp, lp, op, Smax, Hkv, G, D, window, scale);
  else
    decode_attention_kernel<2><<<grid, block, shmem, s>>>(qp, kp, vp, lp, op, Smax, Hkv, G, D, window, scale);
  return (int)cudaGetLastError();
}
