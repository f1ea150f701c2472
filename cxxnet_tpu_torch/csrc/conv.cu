// Stride-1 grouped convolution forward as an implicit GEMM, for Hopper
// (sm_90a).
//
// Replaces cxxnet_tpu/ops/conv_pallas.py:_fwd_kernel (via _fwd_single /
// _run_fwd / conv_pallas), the row-im2col GEMM
//     out += xf[:, dy:dy+OH] . w[dy]      (bf16 operands, f32 accumulate)
// with the output rounded once to bf16, as conv_pallas.py:143 rounds it.
//
// Per group g the product is  out[m, co] = sum_k A[m, k] * B[k, co]  with
//     m = (n, oy, ox)          M = N*OH*OW
//     k = (dy, dx, ci)         K = kh*kw*Ci/g   (Ci/g padded to a multiple of 8)
//     A[m, k] = xp[n, oy+dy, ox+dx, g*Ci/g + ci]   (xp: padded NHWC input)
//     B[k, co] = w[g*Co/g + co, ci, dy, dx]
// A is never materialised: each block gathers its A tile straight from
// the padded NHWC input (the "implicit" in implicit GEMM), so none of the
// TPU kernel's artifacts survive — no W-unfold copy (_unfold, which
// exists because Mosaic cannot concatenate lanes), no LANE/SUBLANE
// padding, no VMEM batch-block budget (_pick_bn). All groups run in one
// launch, the group index on blockIdx.z, where JAX looped and
// concatenated.
//
// What bounds it on the H100: at AlexNet's serving shapes the tensor
// cores (2*M*K*Co/g flops per group against a few MB), so the least time
// is flops / 989 TFLOP/s (bf16 dense).
//
// What this design does about it: 128x64x32 block tiles in shared
// memory, four warps each issuing 2x4 bf16 m16n16k16 WMMA products into
// f32 register accumulators, fed by a 3-stage cp.async ring: 16-byte
// asynchronous copies (8 channels of one tap; zero-filled past the edges)
// for the next two K slices are in flight while the tensor cores work on
// the current one. It does not use TMA or wgmma, so it reaches a fraction
// of the tensor-core peak; those are the next steps. The output tile is
// staged through shared memory column-major so each warp writes runs of
// consecutive ox, i.e. coalesced NCHW stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 128;   // output rows (n, oy, ox) per block
constexpr int BN = 64;    // output channels per block
constexpr int BK = 32;    // reduction slice per stage
constexpr int kThreads = 128;   // 4 warps, each 32 rows x 64 channels
constexpr int LDA = BK + 8;     // bf16 elements; +8 staggers the banks
constexpr int LDB = BN + 8;
constexpr int LDC = BM + 4;     // f32, column-major staging [co][m]
constexpr int kStages = 3;      // cp.async ring depth
constexpr int kStageBytes = BM * LDA * 2 + BK * LDB * 2;   // A + B slice
constexpr int kABytes = kStages * kStageBytes;
constexpr int kCBytes = BN * LDC * 4;
constexpr int kSmemBytes = kABytes > kCBytes ? kABytes : kCBytes;

// 16-byte global -> shared copy, asynchronous; zero-fills when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const __nv_bfloat16* __restrict__ xp,
                const __nv_bfloat16* __restrict__ wb,
                __nv_bfloat16* __restrict__ out, int nb, int hp, int wp,
                int ctot, int cigp, int oh, int ow, int kh, int kw, int cog,
                int cogp) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  float* Cs = reinterpret_cast<float*>(smem);   // reused after the K loop

  const int g = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ohw = oh * ow;
  const int M = nb * ohw;
  const int K = kh * kw * cigp;
  const int KT = (K + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  // A loader: this thread fills rows (tid/4 + 32*i), i < 4, at the
  // 8-channel chunk (tid%4)*8 of the BK slice
  const int a_row = tid >> 2;
  const int a_col = (tid & 3) * 8;
  long long a_base[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + a_row + 32 * i;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    const int n = mm / ohw;
    const int rem = mm - n * ohw;
    const int y = rem / ow;
    const int x = rem - y * ow;
    a_base[i] = ((long long)(n * hp + y) * wp + x) * ctot + (long long)g * cigp;
  }
  const __nv_bfloat16* wg = wb + (long long)g * K * cogp;

  // issue the copies of K slice kt into ring stage st (edges zero-fill;
  // a masked copy still needs a valid address, so it points at the base)
  auto load_slice = [&](int st, int kt) {
    __nv_bfloat16* As =
        reinterpret_cast<__nv_bfloat16*>(smem + st * kStageBytes);
    __nv_bfloat16* Bs = As + BM * LDA;
    const int k0 = kt * BK;
    // A: the chunk's 8 channels lie in one tap (cigp % 8 == 0)
    const int kk = k0 + a_col;
    const bool k_ok = kk < K;
    const int tap = kk / cigp;
    const int ci = kk - tap * cigp;
    const int dy = tap / kw;
    const int dx = tap - dy * kw;
    const long long koff = ((long long)dy * wp + dx) * ctot + ci;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = a_ok[i] && k_ok;
      cp_async16(As + (a_row + 32 * i) * LDA + a_col,
                 ok ? xp + a_base[i] + koff : xp, ok);
    }
    // B: BK rows x BN channels, 8 channels per copy
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + kThreads * j;
      const int kr = idx >> 3;
      const int nc = (idx & 7) * 8;
      const int k = k0 + kr;
      const int co = n0 + nc;
      const bool ok = k < K && co < cogp;
      cp_async16(Bs + kr * LDB + nc, ok ? wg + (long long)k * cogp + co : wg,
                 ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // prologue: slices 0 .. kStages-2 in flight (one commit group each,
  // empty past the end, so the group count stays uniform)
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_slice(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    // slice kt has landed once at most kStages-2 newer groups are pending
    cp_async_wait<kStages - 2>();
    __syncthreads();   // ... for every thread; and slice kt-1 is consumed
    const int pre = kt + kStages - 1;
    if (pre < KT) load_slice(pre % kStages, pre);
    cp_async_commit();
    const __nv_bfloat16* As =
        reinterpret_cast<const __nv_bfloat16*>(smem + (kt % kStages) *
                                               kStageBytes);
    const __nv_bfloat16* Bs = As + BM * LDA;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (warp * 32 + i * 16) * LDA + ks,
                               LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], Bs + ks * LDB + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is dead; Cs reuses its bytes

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (j * 16) * LDC + warp * 32 + i * 16,
                              acc[i][j], LDC, wmma::mem_col_major);
  __syncthreads();
  const long long co_tot = (long long)gridDim.z * cog;
  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int col = idx / BM;
    const int row = idx - col * BM;
    const int m = m0 + row;
    const int co = n0 + col;
    if (m < M && co < cog) {
      const int n = m / ohw;
      const int rem = m - n * ohw;
      out[((long long)n * co_tot + (long long)g * cog + co) * ohw + rem] =
          __float2bfloat16_rn(Cs[col * LDC + row]);
    }
  }
}

}  // namespace

extern "C" {

// xp: (n, hp, wp, ctot) bf16, the zero-padded NHWC input, ctot =
//     groups * cigp, each group's channels padded to cigp (% 8 == 0);
// wb: (groups, kh*kw*cigp, cogp) bf16 with k ordered (dy, dx, ci) and
//     zero rows/columns in the padding, cogp = cog rounded up to 8;
// out: (n, groups*cog, oh, ow) bf16, oh = hp-kh+1, ow = wp-kw+1.
int cxx_conv_fwd(const void* xp, const void* wb, void* out, int n, int hp,
                 int wp, int ctot, int cigp, int oh, int ow, int kh, int kw,
                 int cog, int cogp, int groups, void* stream) {
  const long long M = (long long)n * oh * ow;
  dim3 grid((unsigned)((M + BM - 1) / BM), (cog + BN - 1) / BN, groups);
  conv_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xp),
      static_cast<const __nv_bfloat16*>(wb),
      static_cast<__nv_bfloat16*>(out), n, hp, wp, ctot, cigp, oh, ow, kh,
      kw, cog, cogp);
  return (int)cudaGetLastError();
}

const char* cxx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
