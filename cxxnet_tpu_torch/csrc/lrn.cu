// Fused cross-channel LRN forward for Hopper (sm_90a).
//
// Replaces cxxnet_tpu/ops/lrn.py:_fwd_only_kernel (the primal of _lrn):
//
//     s   = knorm + (alpha/nsize) * sum_{d=c-lo..c+hi} x[d]^2   (zero pad)
//     out = x * s^-beta,     lo = nsize/2, hi = nsize-1-lo
//
// over an (N, C, S = H*W) activation, f32 or bf16 in and out, f32 math.
//
// What bounds it on the H100: memory. Each element costs ~2*nsize+6
// flops against 2*itemsize bytes (one read, one write), far below the
// card's ~20 flop/byte balance point for f32 CUDA-core math, so the
// least time is 2*N*C*S*itemsize / 3.35 TB/s.
//
// What the design does about it: every element is read from device
// memory once and written once, and nothing else touches device memory;
// and enough loads are in flight to cover the memory latency. A thread
// owns one spatial position of one sample and a chunk of kChunk
// channels: it first issues the loads of all the rows its chunk's
// windows touch (the chunk plus its nsize-1 halo rows, which neighbouring
// chunks also read, from L2) into its own column of shared memory — up to
// kChunk+nsize-1 independent loads at once, no barrier since no other
// thread reads the column — then computes its outputs from there, adding
// each window in the Pallas kernel's exact order (centre, rows above,
// rows below) rather than by a rolling add/subtract that would cancel.
// Threads of a warp own neighbouring spatial positions, so every load and
// store of a channel row is coalesced; the chunks (grid.z) multiply the
// threads in flight at AlexNet's small maps. The TPU kernel's VMEM
// residency of one whole (C, S) sample has no counterpart here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kChunk = 16;   // channels per thread (grid.z chunks)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// s^-beta with the forms of lrn.py:_neg_pow for the betas that occur
__device__ __forceinline__ float neg_pow(float s, float beta) {
  if (beta == 0.75f) return rsqrtf(__fmul_rn(s, sqrtf(s)));
  if (beta == 0.5f) return rsqrtf(s);
  if (beta == 1.0f) return __fdiv_rn(1.0f, s);
  if (beta == 1.75f) return __fdiv_rn(rsqrtf(__fmul_rn(s, sqrtf(s))), s);
  if (beta == 1.5f) return __fdiv_rn(rsqrtf(s), s);
  if (beta == 2.0f) return __fdiv_rn(1.0f, __fmul_rn(s, s));
  return powf(s, -beta);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, int C, int S,
               int lo, int hi, float salpha, float beta, float knorm) {
  extern __shared__ float rows[];   // [kChunk + nsize - 1][kThreads]
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const long long base = (long long)blockIdx.y * C * S + s;
  const int c0 = blockIdx.z * kChunk;
  const int c1 = min(c0 + kChunk, C);
  // column slot of channel ch is (ch - first) * kThreads
  const int first = c0 - lo;
  float* col = rows + threadIdx.x;
  const int r1 = min(c1 + hi, C);
#pragma unroll 4
  for (int ch = max(first, 0); ch < r1; ++ch)
    col[(ch - first) * kThreads] = to_f32(x[base + (long long)ch * S]);
  for (int c = c0; c < c1; ++c) {
    const float xc = col[(c - first) * kThreads];
    float acc = __fmul_rn(xc, xc);
    for (int d = 1; d <= hi && c + d < C; ++d) {
      const float v = col[(c + d - first) * kThreads];
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    }
    for (int d = 1; d <= lo && c - d >= 0; ++d) {
      const float v = col[(c - d - first) * kThreads];
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    }
    const float sc = __fadd_rn(knorm, __fmul_rn(salpha, acc));
    store(out + base + (long long)c * S, __fmul_rn(xc, neg_pow(sc, beta)));
  }
}

template <typename T>
int launch(const void* x, void* out, int n, int c, int s, int nsize,
           float salpha, float beta, float knorm, cudaStream_t stream) {
  const int lo = nsize / 2, hi = nsize - 1 - lo;
  dim3 grid((s + kThreads - 1) / kThreads, n, (c + kChunk - 1) / kChunk);
  size_t smem = (size_t)(kChunk + nsize - 1) * kThreads * sizeof(float);
  lrn_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), c, s, lo, hi, salpha,
      beta, knorm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x and out are contiguous (n, c, s).
int cxx_lrn_fwd(const void* x, void* out, int n, int c, int s, int nsize,
                float salpha, float beta, float knorm, int dtype,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, out, n, c, s, nsize, salpha, beta, knorm, st);
  return launch<__nv_bfloat16>(x, out, n, c, s, nsize, salpha, beta, knorm,
                               st);
}

const char* cxx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
