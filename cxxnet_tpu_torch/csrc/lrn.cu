// Fused cross-channel LRN, forward and backward, for Hopper (sm_90a).
//
// Replaces three Pallas kernels of cxxnet_tpu/ops/lrn.py:
//   _fwd_only_kernel (the primal of _lrn)       -> lrn_fwd_kernel<T, false>
//   _fwd_kernel      (_lrn_fwd_impl, the VJP's   -> lrn_fwd_kernel<T, true>
//                     forward: also writes the f32 normalizer as residual)
//   _bwd_kernel      (_lrn_bwd)                  -> lrn_bwd_kernel<T>
//
//     s   = knorm + (alpha/nsize) * sum_{d=c-lo..c+hi} x[d]^2   (zero pad)
//     out = x * s^-beta,     lo = nsize/2, hi = nsize-1-lo
//     gx  = g * s^-beta - 2*(alpha/nsize)*beta * x * W'(g * x * s^(-beta-1))
//
// over an (N, C, S = H*W) activation, f32 or bf16 in and out, f32 math; W'
// is the adjoint window, rows [c-hi, c+lo] (the forward one mirrored, which
// differs from it when nsize is even).
//
// What bounds it on the H100: memory. Each element costs ~2*nsize+6 flops
// (forward) or ~2*nsize+12 (backward) against 2-5 element reads and writes,
// far below the card's ~20 flop/byte balance point for f32 CUDA-core math,
// so the least time is the bytes moved / 3.35 TB/s.
//
// What the design does about it: every element is read from device memory
// once and written once, and nothing else touches device memory; and
// enough loads are in flight to cover the memory latency. A thread owns
// one spatial position of one sample and a chunk of kChunk channels: it
// first issues the loads of all the rows its chunk's windows touch (the
// chunk plus its nsize-1 halo rows, which neighbouring chunks also read,
// from L2) into its own column of shared memory — up to kChunk+nsize-1
// independent loads at once, no barrier since no other thread reads the
// column — then computes its outputs from there, adding each window in the
// Pallas kernel's exact order (centre, rows above, rows below) rather than
// by a rolling add/subtract that would cancel. The backward stores the
// window term g*x*s^(-beta-1) of each row in that column, and its own rows'
// x, g and s in three more, so each input is read once. Threads of a warp
// own neighbouring spatial positions, so every load and store of a channel
// row is coalesced; the chunks (grid.z) multiply the threads in flight at
// AlexNet's small maps. The TPU kernels' VMEM residency of one whole
// (C, S) sample has no counterpart here. Products and sums use the _rn
// intrinsics so that nvcc contracts nothing into an FMA the plain version
// does not do.
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

template <typename T, bool kScale>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
               float* __restrict__ scale, int C, int S, int lo, int hi,
               float salpha, float beta, float knorm) {
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
    if (kScale) scale[base + (long long)c * S] = sc;
    store(out + base + (long long)c * S, __fmul_rn(xc, neg_pow(sc, beta)));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const T* __restrict__ g, T* __restrict__ gx, int C, int S,
               int lo, int hi, float beta, float coef) {
  // [kChunk + nsize - 1][kThreads] window terms, then the chunk's own
  // x, g and s: three [kChunk][kThreads] blocks
  extern __shared__ float rows[];
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const long long base = (long long)blockIdx.y * C * S + s;
  const int c0 = blockIdx.z * kChunk;
  const int c1 = min(c0 + kChunk, C);
  const int nrows = kChunk + lo + hi;
  // adjoint window rows [c-hi, c+lo]: slot of channel ch is ch - first
  const int first = c0 - hi;
  float* inner = rows + threadIdx.x;
  float* own_x = rows + nrows * kThreads + threadIdx.x;
  float* own_g = own_x + kChunk * kThreads;
  float* own_s = own_g + kChunk * kThreads;
  const float beta1 = beta + 1.0f;
  const int r1 = min(c1 + lo, C);
#pragma unroll 2
  for (int ch = max(first, 0); ch < r1; ++ch) {
    const long long at = base + (long long)ch * S;
    const float xv = to_f32(x[at]);
    const float gv = to_f32(g[at]);
    const float sv = scale[at];
    inner[(ch - first) * kThreads] =
        __fmul_rn(__fmul_rn(gv, xv), neg_pow(sv, beta1));
    if (ch >= c0 && ch < c1) {
      own_x[(ch - c0) * kThreads] = xv;
      own_g[(ch - c0) * kThreads] = gv;
      own_s[(ch - c0) * kThreads] = sv;
    }
  }
  for (int c = c0; c < c1; ++c) {
    float acc = inner[(c - first) * kThreads];
    for (int d = 1; d <= lo && c + d < C; ++d)
      acc = __fadd_rn(acc, inner[(c + d - first) * kThreads]);
    for (int d = 1; d <= hi && c - d >= 0; ++d)
      acc = __fadd_rn(acc, inner[(c - d - first) * kThreads]);
    const float xv = own_x[(c - c0) * kThreads];
    const float gv = own_g[(c - c0) * kThreads];
    const float sv = own_s[(c - c0) * kThreads];
    const float v = __fsub_rn(__fmul_rn(gv, neg_pow(sv, beta)),
                              __fmul_rn(__fmul_rn(coef, xv), acc));
    store(gx + base + (long long)c * S, v);
  }
}

dim3 grid_of(int n, int c, int s) {
  return dim3((s + kThreads - 1) / kThreads, n, (c + kChunk - 1) / kChunk);
}

template <typename T>
int launch_fwd(const void* x, void* out, float* scale, int n, int c, int s,
               int nsize, float salpha, float beta, float knorm,
               cudaStream_t stream) {
  const int lo = nsize / 2, hi = nsize - 1 - lo;
  size_t smem = (size_t)(kChunk + nsize - 1) * kThreads * sizeof(float);
  if (scale != nullptr)
    lrn_fwd_kernel<T, true><<<grid_of(n, c, s), kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), scale, c, s, lo, hi,
        salpha, beta, knorm);
  else
    lrn_fwd_kernel<T, false><<<grid_of(n, c, s), kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), nullptr, c, s, lo,
        hi, salpha, beta, knorm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const float* scale, const void* g, void* gx,
               int n, int c, int s, int nsize, float beta, float coef,
               cudaStream_t stream) {
  const int lo = nsize / 2, hi = nsize - 1 - lo;
  size_t smem =
      (size_t)(kChunk + nsize - 1 + 3 * kChunk) * kThreads * sizeof(float);
  lrn_bwd_kernel<T><<<grid_of(n, c, s), kThreads, smem, stream>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(g),
      static_cast<T*>(gx), c, s, lo, hi, beta, coef);
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
    return launch_fwd<float>(x, out, nullptr, n, c, s, nsize, salpha, beta,
                             knorm, st);
  return launch_fwd<__nv_bfloat16>(x, out, nullptr, n, c, s, nsize, salpha,
                                   beta, knorm, st);
}

// As cxx_lrn_fwd, and also writes the f32 normalizer s to scale (n, c, s).
int cxx_lrn_fwd_scale(const void* x, void* out, void* scale, int n, int c,
                      int s, int nsize, float salpha, float beta,
                      float knorm, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scale);
  if (dtype == 0)
    return launch_fwd<float>(x, out, sc, n, c, s, nsize, salpha, beta, knorm,
                             st);
  return launch_fwd<__nv_bfloat16>(x, out, sc, n, c, s, nsize, salpha, beta,
                                   knorm, st);
}

// gx from x, the f32 normalizer scale and the cotangent g, all contiguous
// (n, c, s); x, g and gx of one dtype. coef = 2*(alpha/nsize)*beta.
int cxx_lrn_bwd(const void* x, const void* scale, const void* g, void* gx,
                int n, int c, int s, int nsize, float beta, float coef,
                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0)
    return launch_bwd<float>(x, sc, g, gx, n, c, s, nsize, beta, coef, st);
  return launch_bwd<__nv_bfloat16>(x, sc, g, gx, n, c, s, nsize, beta, coef,
                                   st);
}

const char* cxx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
