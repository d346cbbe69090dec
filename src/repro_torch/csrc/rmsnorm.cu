// RMSNorm over the rows of [N, d] bf16, optionally with the residual add in
// front: y = x * rsqrt(mean(x^2) + eps) * w in fp32, rounded to bf16 once;
// with a residual, the rounded sum x + r is written too and the norm reads
// the fp32 sum before that rounding (the reference's compiled add-then-norm,
// repro_torch/kernels/rmsnorm/ref.py::rmsnorm_ref).
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py:24, function `rmsnorm`
//   (Pallas TPU kernel, [row_blk, d] tiles, fp32 statistics in one VMEM
//   pass), and the Triton kernel that stood in its place on the H100.
//
// Why CUDA C++: the two Hopper mechanisms this kernel is built on have no
//   Triton spelling. Programmatic dependent launch (PDL) needs the launch
//   attribute cudaLaunchAttributeProgrammaticStreamSerialization and the
//   griddepcontrol instructions inside the kernel; and a row kept in one
//   warp's registers and reduced by shuffles alone, with its loads issued in
//   a chosen order around the wait on the predecessor, is below the block
//   level Triton programs at. Triton's Python launcher also cost ~0.03-0.06
//   ms a call on the host (PERF.md §6, PR 22); a ctypes call into
//   cudaLaunchKernelEx costs a few microseconds.
//
// What bounds it on the H100, in two regimes:
//   - decode rows (N = 8 at d = 768-6144): the bytes are 15-100 KB, 0.00001
//     ms at 3.35 TB/s, so what a call waits for is latency: launching and
//     retiring a kernel, then one round trip to L2 or memory for the row
//     and one shuffle reduction. The floor is the launch itself, which
//     chip_smoke.py times on an empty kernel of one block (rmsnorm_empty),
//     with and without PDL.
//   - prefill rows (N in the thousands): bytes, 2 N d x 2 bytes (4 N d x 2
//     with the residual) for ~4 flops an element. The design keeps 16-byte
//     loads, every load of a row in flight before the first use, and enough
//     rows in flight per SM to cover memory latency.
//
// Design: a row is held by 1, 2, 4 or 8 warps, in registers (16-byte
//   vectors: d = 960 is 120 of them), and a block holds 1 or 2 rows; the
//   geometry is chosen in Python (kernels/rmsnorm/rmsnorm.py::geometry,
//   tested on the CPU, from chip_smoke.py's sweep of every geometry) and
//   checked here. Decode rows (N <= 132, at most one a SM) get at most two
//   vectors a thread, because a row's latency is its threads' serial work
//   (at N = 8, d = 1600, seven vectors a lane on one warp take ~10 % longer
//   than two a lane on four warps: PERF.md §6).
//   Prefill rows get up to four, one warp a row and two rows a block up to
//   d = 1024. Lane t of a row's T threads holds vectors t, t + T, t + 2T,
//   ... (neighbouring lanes on neighbouring addresses). The sum of squares
//   is taken per thread in that order (fp32 FMAs), then by a butterfly of
//   __shfl_xor_sync (no shared memory, no barrier), and where a row has
//   several warps their sums meet once in shared memory, added in warp
//   order after one __syncthreads.
//   Order of work in a thread, for latency: the address arithmetic, and one
//   bulk prefetch of the weight into L2 by the grid's first thread
//   (cp.async.bulk.prefetch: the TMA unit fetches it, no registers, no
//   wait); then griddepcontrol.wait, the wait on the kernel before it in
//   the stream; then every load of x (and the residual) and of the weight,
//   in one branch-free run (a lane past the row's end reads the last vector
//   again and drops it), so a row costs one round trip, not one a load;
//   then griddepcontrol.launch_dependents, once the inputs are in
//   registers, so a kernel launched after it with PDL can start; then the
//   reduction and the stores. (Branching around each load instead, `if (u
//   < units)`, let ptxas put each load's first use inside its branch, and
//   the loads then waited on each other.)
//   The weight is prefetched, not loaded into registers, before the wait: a
//   weight written by the kernel just before the norm (a test's
//   `randn(...) + 1`, an optimizer step) would be read stale from
//   registers, while L2 is the point of coherence and takes the
//   predecessor's writes. Its real load (ld.global.nc) follows the wait and
//   finds it in L2. A model's norm weights are written long before, so the
//   prefetch hides their trip to memory behind the wait. (A prefetch per
//   128-byte line from every warp instead, prefetch.global.L2, slowed
//   prefill rows severalfold.)
//   PDL: every launch sets programmatic stream serialization, so the norm's
//   blocks can become resident before the kernel ahead of it has finished,
//   and the wait sits where the norm first needs that kernel's output. A
//   norm after a norm (hymba's pair, the 20-call timing graph) starts once
//   the first has read its inputs: 0.00120 ms a call at N = 8, d = 960,
//   against 0.00198 without PDL. After a cuBLAS GEMM, which does not
//   release its dependents early, it gains nothing measurable. The attribute
//   holds under stream capture on the CUDA the card runs (12.8): a captured
//   launch becomes a graph node with a programmatic edge from the kernel
//   node before it (rmsnorm_programmatic_edges counts them;
//   tests/test_torch_cuda.py and chip_smoke.py check 20 launches after a
//   matmul replay bit for bit). Launched without the attribute,
//   griddepcontrol.wait returns at once and the kernel is an ordinary one.
//   Tails and odd shapes take a scalar variant of the same kernel: d not a
//   multiple of 8, or a row or weight pointer not 16-byte aligned, reads one
//   bf16 a load (up to 32 a thread, a power of two). N = 0 launches nothing.
//   One (x, w) dtype pair is compiled, bf16 and bf16: the only pair that
//   reaches the wrapper on the serving paths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int kMaxThreads = 256;   // threads a block
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ void wait_on_predecessor() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Hopper's bulk prefetch: the TMA unit brings `bytes` (a multiple of 16,
// from a 16-byte aligned address) into L2, with no registers and no wait.
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p), "r"(bytes)
               : "memory");
}

// VEC bf16 values as loaded: one 16-byte vector (VEC = 8) or one value.
template <int VEC>
struct Unit;

template <>
struct Unit<8> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(raw.x), "=r"(raw.y), "=r"(raw.z), "=r"(raw.w)
                 : "l"(p));
  }
  __device__ __forceinline__ void load_nc(const __nv_bfloat16* p) {
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(raw.x), "=r"(raw.y), "=r"(raw.z), "=r"(raw.w)
                 : "l"(p));
  }
  __device__ __forceinline__ void to_float(float* f) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* f) {
    uint4 out;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = out;
  }
};

template <>
struct Unit<1> {
  unsigned short raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    asm volatile("ld.global.u16 %0, [%1];" : "=h"(raw) : "l"(p));
  }
  __device__ __forceinline__ void load_nc(const __nv_bfloat16* p) {
    asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(raw) : "l"(p));
  }
  __device__ __forceinline__ void to_float(float* f) const {
    f[0] = __uint_as_float(static_cast<unsigned>(raw) << 16);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* f) {
    *p = __float2bfloat16_rn(f[0]);
  }
};

// VEC: bf16 values a load (8 or 1); K: loads a thread keeps of its row;
// RES: the residual add in front. 2**row_shift threads (32 x warps a row)
// share a row; blockDim.x >> row_shift rows a block.
template <int VEC, int K, bool RES>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const __nv_bfloat16* x, const __nv_bfloat16* r,
               const __nv_bfloat16* w, __nv_bfloat16* y, __nv_bfloat16* s,
               long long n, int d, int row_shift, float eps) {
  __shared__ float partial[kMaxWarps];
  const int row_threads = 1 << row_shift;
  const int units = d / VEC;
  const int t = threadIdx.x & (row_threads - 1);
  const long long row = (long long)blockIdx.x * (blockDim.x >> row_shift) +
                        (threadIdx.x >> row_shift);
  const bool live = row < n;
  const size_t base = (size_t)(live ? row : 0) * (size_t)d;

  // before the wait: the addresses, and the weight into L2 by one bulk
  // (TMA) prefetch from the grid's first thread
  if (VEC == 8 && blockIdx.x == 0 && threadIdx.x == 0) prefetch_l2(w, 2 * d);
  wait_on_predecessor();

  // every load of the row and of the weight, in flight together and with
  // no branch between them: a lane past the row's end reads the row's last
  // load again, and its values are dropped below
  Unit<VEC> xu[K], ru[K], wu[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int u = min(t + j * row_threads, units - 1) * VEC;
    wu[j].load_nc(w + u);
    xu[j].load(x + base + u);
    if (RES) ru[j].load(r + base + u);
  }

  float v[K][VEC];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool in = live && t + j * row_threads < units;
    xu[j].to_float(v[j]);
    if (RES) {
      float rv[VEC];
      ru[j].to_float(rv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[j][e] += rv[e];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      v[j][e] = in ? v[j][e] : 0.f;
      ss = fmaf(v[j][e], v[j][e], ss);
    }
  }
  release_dependents();  // the inputs are in registers

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (row_threads > 32) {  // several warps a row (uniform in the block)
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
    __syncthreads();
    const int first = (threadIdx.x >> row_shift) << (row_shift - 5);
    ss = 0.f;
    for (int i = 0; i < (row_threads >> 5); ++i) ss += partial[first + i];
  }
  const float inv = rsqrtf(ss / (float)d + eps);
  if (!live) return;

#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int u = t + j * row_threads;
    if (u < units) {
      if (RES) Unit<VEC>::store(s + base + u * VEC, v[j]);
      float wf[VEC], out[VEC];
      wu[j].to_float(wf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[e] = v[j][e] * inv * wf[e];
      Unit<VEC>::store(y + base + u * VEC, out);
    }
  }
}

// The launch floor: one block that waits on its predecessor and releases
// its dependents, and does nothing else.
__global__ void empty_kernel() {
  wait_on_predecessor();
  release_dependents();
}

cudaLaunchConfig_t config(unsigned blocks, unsigned threads, int pdl,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cfg;
}

template <int VEC, int K, bool RES>
int launch(const void* x, const void* r, const void* w, void* y, void* s,
           long long n, int d, float eps, int row_shift, int rows_per_block,
           int pdl, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  cudaLaunchConfig_t cfg = config((unsigned)blocks,
                                  (unsigned)(rows_per_block << row_shift),
                                  pdl, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, rmsnorm_kernel<VEC, K, RES>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(s), n, d,
      row_shift, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int VEC, int K>
int launch_res(bool res, const void* x, const void* r, const void* w, void* y,
               void* s, long long n, int d, float eps, int row_shift,
               int rows_per_block, int pdl, cudaStream_t stream) {
  return res ? launch<VEC, K, true>(x, r, w, y, s, n, d, eps, row_shift,
                                    rows_per_block, pdl, stream)
             : launch<VEC, K, false>(x, r, w, y, s, n, d, eps, row_shift,
                                     rows_per_block, pdl, stream);
}

}  // namespace

// x, r (or null), y, s (or null): [n, d] bf16 contiguous; w: [d] bf16. Writes
// y = rmsnorm(x (+ r)) and, with r, s = x + r. Launch geometry from the
// caller: vec, bf16 values a load (8: 16-byte loads, every pointer 16-byte
// aligned and d % 8 == 0; 1: one value a load); per_thread, loads a thread
// keeps (1-8 for vec 8; 1, 2, 4, 8, 16 or 32 for vec 1); row_warps, warps a
// row (1, 2, 4 or 8); rows_per_block (1-8, a block at most 256 threads);
// pdl, launch with programmatic stream serialization. Returns the
// cudaError_t of the launch.
extern "C" int rmsnorm_bf16(const void* x, const void* r, const void* w,
                            void* y, void* s, long long n, int d, float eps,
                            int vec, int per_thread, int row_warps,
                            int rows_per_block, int pdl, void* stream) {
  const int row_threads = 32 * row_warps;
  if ((vec != 8 && vec != 1) || d < 1 || d % vec || n < 0 ||
      (row_warps != 1 && row_warps != 2 && row_warps != 4 && row_warps != 8) ||
      rows_per_block < 1 || row_threads * rows_per_block > kMaxThreads ||
      (long long)row_threads * per_thread < d / vec || (r == nullptr) != (s == nullptr))
    return (int)cudaErrorInvalidValue;
  if (vec == 8 && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
                    reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(y) |
                    reinterpret_cast<uintptr_t>(s)) % 16))
    return (int)cudaErrorMisalignedAddress;
  if (n == 0) return (int)cudaSuccess;
  if ((n + rows_per_block - 1) / rows_per_block > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool res = r != nullptr;
  const int row_shift = 5 + (row_warps == 2) + 2 * (row_warps == 4) + 3 * (row_warps == 8);
#define RMSNORM_CASE(V, K_)                                                   \
  case K_:                                                                    \
    return launch_res<V, K_>(res, x, r, w, y, s, n, d, eps, row_shift,        \
                             rows_per_block, pdl, st);
  if (vec == 8) {
    switch (per_thread) {
      RMSNORM_CASE(8, 1) RMSNORM_CASE(8, 2) RMSNORM_CASE(8, 3)
      RMSNORM_CASE(8, 4) RMSNORM_CASE(8, 5) RMSNORM_CASE(8, 6)
      RMSNORM_CASE(8, 7) RMSNORM_CASE(8, 8)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (per_thread) {
    RMSNORM_CASE(1, 1) RMSNORM_CASE(1, 2) RMSNORM_CASE(1, 4)
    RMSNORM_CASE(1, 8) RMSNORM_CASE(1, 16) RMSNORM_CASE(1, 32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RMSNORM_CASE
}

// One block of 32 threads of the empty kernel, with PDL (pdl != 0) or
// without. Returns the cudaError_t of the launch.
extern "C" int rmsnorm_empty(int pdl, void* stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      config(1, 32, pdl, static_cast<cudaStream_t>(stream), attr);
  const cudaError_t err =
      cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(empty_kernel), nullptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The programmatic edges of a captured graph (a cudaGraph_t), or -1 where
// the graph cannot be read.
extern "C" int rmsnorm_programmatic_edges(void* graph) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t count = 0;
#if CUDART_VERSION >= 13000
  if (cudaGraphGetEdges(g, nullptr, nullptr, nullptr, &count) != cudaSuccess) return -1;
#else
  if (cudaGraphGetEdges_v2(g, nullptr, nullptr, nullptr, &count) != cudaSuccess) return -1;
#endif
  std::vector<cudaGraphNode_t> from(count), to(count);
  std::vector<cudaGraphEdgeData> data(count);
#if CUDART_VERSION >= 13000
  if (cudaGraphGetEdges(g, from.data(), to.data(), data.data(), &count) != cudaSuccess)
    return -1;
#else
  if (cudaGraphGetEdges_v2(g, from.data(), to.data(), data.data(), &count) != cudaSuccess)
    return -1;
#endif
  int programmatic = 0;
  for (size_t i = 0; i < count; ++i)
    programmatic += data[i].type == cudaGraphDependencyTypeProgrammatic;
  return programmatic;
}
