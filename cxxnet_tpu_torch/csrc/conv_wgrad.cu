// Stride-1 grouped convolution weight gradient as an implicit GEMM, for
// Hopper (sm_90a).
//
// Replaces cxxnet_tpu/ops/conv_pallas.py:_wgrad_kernel (via _wgrad_single
// / _conv_bwd), the row-im2col accumulation
//     dw[dy] += patch(dy)^T . dout      (bf16 operands, f32 accumulate)
// over the batch grid, rounded once to bf16 (dw.astype(w.dtype),
// conv_pallas.py:257).
//
// Per group g the product is  dw[k, co] = sum_m A[m, k] * G[m, co]  with
//     m = (n, oy, ox)          M = N*OH*OW          (the reduction)
//     k = (dy, dx, ci)         K = kh*kw*Ci/g   (Ci/g padded to a multiple of 8)
//     A[m, k] = xp[n, oy+dy, ox+dx, g*Ci/g + ci]   (xp: padded NHWC input,
//               the layout csrc/conv.cu's forward reads)
//     G[m, co] = gp[m, g*Co/g + co]                (gp: the cotangent, NHWC,
//               each group's channels padded to a multiple of 8)
// so the output is laid out as the forward's packed weights,
// (groups, K, Co/g padded), which the wrapper unpacks to OIHW.
//
// What bounds it on the H100: the tensor cores. At AlexNet's batch-256
// shapes each group's product is a few hundred by a few thousand outputs
// reduced over M = 43k..774k rows: 2*M*K*Co/g flops (38-115 GFLOP a conv)
// against tens of MB, so the least time is flops / 989 TFLOP/s.
//
// What this design does about it: the output is small (conv1: 432 x 96)
// and the reduction long, so one block per output tile would leave most of
// the 132 SMs idle. The reduction is split over blockIdx.z into `splits`
// contiguous ranges of M; each block writes its f32 partial tile to a
// scratch buffer, and a second kernel sums the partials in split order and
// rounds once to bf16 — deterministic, unlike atomics. Inside a block the
// tile is 128 (k) x 64 (co) over 32-row slices of M: four warps, each 2x4
// bf16 m16n16k16 WMMA products into f32 register accumulators, fed by a
// 3-stage cp.async ring of 16-byte copies (8 channels of one tap of A,
// 8 channels of G; zero-filled past the edges). A is read from shared
// memory as a column-major fragment, i.e. transposed for free. No TMA or
// wgmma yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 128;   // k (dy, dx, ci) rows of dw per block
constexpr int BN = 64;    // co columns per block
constexpr int BK = 32;    // m (n, oy, ox) rows per stage
constexpr int kThreads = 128;   // 4 warps, each 32 k x 64 co
constexpr int LDA = BM + 8;     // bf16 elements; +8 staggers the banks
constexpr int LDB = BN + 8;
constexpr int kStages = 3;
constexpr int kStageBytes = BK * LDA * 2 + BK * LDB * 2;   // A + G slice
constexpr int kSmemBytes = kStages * kStageBytes;

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

// grid (ceil(K/BM), ceil(cogp/BN), groups*splits); part: (splits, groups,
// Kp, COp) f32 with Kp, COp the tile-rounded K and cogp
__global__ void __launch_bounds__(kThreads)
conv_wgrad_kernel(const __nv_bfloat16* __restrict__ xp,
                  const __nv_bfloat16* __restrict__ gp,
                  float* __restrict__ part, int nb, int hp, int wp,
                  int ctot, int cigp, int oh, int ow, int kw, int K,
                  int cogp, int groups, int splits, int m_per_split,
                  int Kp, int COp) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];

  const int g = blockIdx.z % groups;
  const int split = blockIdx.z / groups;
  const int k0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ohw = oh * ow;
  const long long M = (long long)nb * ohw;
  const long long m_begin = (long long)split * m_per_split;
  const long long m_end = min(M, m_begin + m_per_split);
  const int MT = (int)((m_end - m_begin + BK - 1) / BK);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int gtot = groups * cogp;

  // A loader: this thread fills m rows (tid/16 + 8*i), i < 4, at the
  // 8-channel chunk (tid%16)*8 of the block's k tile — one tap, fixed for
  // the whole reduction, so its offset is computed once
  const int a_row = tid >> 4;
  const int a_col = (tid & 15) * 8;
  const int kk = k0 + a_col;
  const bool k_ok = kk < K;
  long long koff = 0;
  {
    const int tap = kk / cigp;
    const int ci = kk - tap * cigp;
    const int dy = tap / kw;
    const int dx = tap - dy * kw;
    koff = ((long long)dy * wp + dx) * ctot + (long long)g * cigp + ci;
  }
  // G loader: m rows idx/8 at the 8-channel chunk (idx%8)*8, idx < 256
  const __nv_bfloat16* gg = gp + (long long)g * cogp;

  auto load_slice = [&](int st, int mt) {
    __nv_bfloat16* As =
        reinterpret_cast<__nv_bfloat16*>(smem + st * kStageBytes);
    __nv_bfloat16* Bs = As + BK * LDA;
    const long long mbase = m_begin + (long long)mt * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = a_row + 8 * i;
      const long long m = mbase + r;
      const bool ok = k_ok && m < m_end;
      const __nv_bfloat16* src = xp;
      if (ok) {
        const int n = (int)(m / ohw);
        const int rem = (int)(m - (long long)n * ohw);
        const int y = rem / ow;
        const int x = rem - y * ow;
        src = xp + ((long long)(n * hp + y) * wp + x) * ctot + koff;
      }
      cp_async16(As + r * LDA + a_col, src, ok);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + kThreads * j;
      const int r = idx >> 3;
      const int nc = (idx & 7) * 8;
      const long long m = mbase + r;
      const int co = n0 + nc;
      const bool ok = m < m_end && co < cogp;
      cp_async16(Bs + r * LDB + nc, ok ? gg + m * gtot + co : gp, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < MT) load_slice(st, st);
    cp_async_commit();
  }
  for (int mt = 0; mt < MT; ++mt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int pre = mt + kStages - 1;
    if (pre < MT) load_slice(pre % kStages, pre);
    cp_async_commit();
    const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(
        smem + (mt % kStages) * kStageBytes);
    const __nv_bfloat16* Bs = As + BK * LDA;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      // A^T tile (k x m): element (k, m) sits at As[m * LDA + k]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + ks * LDA + warp * 32 + i * 16,
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

  // the partial buffer is tile-rounded, so every fragment stores whole
  float* dst = part + ((long long)split * groups + g) * Kp * COp;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(
          dst + (long long)(k0 + warp * 32 + i * 16) * COp + n0 + j * 16,
          acc[i][j], COp, wmma::mem_row_major);
}

// dw[g, k, co] = bf16(sum over splits, in split order, of part[s, g, k, co])
__global__ void conv_wgrad_reduce(const float* __restrict__ part,
                                  __nv_bfloat16* __restrict__ dw, int groups,
                                  int K, int cogp, int splits, int Kp,
                                  int COp) {
  const long long total = (long long)groups * K * cogp;
  const long long stride = (long long)groups * Kp * COp;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int co = (int)(i % cogp);
    const long long gk = i / cogp;
    const int k = (int)(gk % K);
    const int g = (int)(gk / K);
    const float* p = part + ((long long)g * Kp + k) * COp + co;
    float s = p[0];
    for (int t = 1; t < splits; ++t) s = __fadd_rn(s, p[t * stride]);
    dw[i] = __float2bfloat16_rn(s);
  }
}

}  // namespace

extern "C" {

// Tile sizes the wrapper rounds the partial buffer to.
int cxx_conv_wgrad_tile_k() { return BM; }
int cxx_conv_wgrad_tile_co() { return BN; }

// xp: (n, hp, wp, ctot) bf16, the zero-padded NHWC input (as the forward
//     packs it), ctot = groups * cigp;
// gp: (n*oh*ow, groups*cogp) bf16, the cotangent NHWC with each group's
//     channels zero-padded to cogp (% 8 == 0);
// part: (splits, groups, Kp, COp) f32 scratch, Kp = K rounded up to the k
//     tile, COp = cogp rounded up to the co tile, K = kh*kw*cigp;
// dw: (groups, K, cogp) bf16, k ordered (dy, dx, ci).
int cxx_conv_wgrad(const void* xp, const void* gp, void* part, void* dw,
                   int n, int hp, int wp, int ctot, int cigp, int oh, int ow,
                   int kh, int kw, int cogp, int groups, int splits,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K = kh * kw * cigp;
  const int Kp = (K + BM - 1) / BM * BM;
  const int COp = (cogp + BN - 1) / BN * BN;
  const long long M = (long long)n * oh * ow;
  const long long per = (M + splits - 1) / splits;
  const int m_per_split = (int)((per + BK - 1) / BK * BK);
  dim3 grid(Kp / BM, COp / BN, groups * splits);
  conv_wgrad_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(xp),
      static_cast<const __nv_bfloat16*>(gp), static_cast<float*>(part), n,
      hp, wp, ctot, cigp, oh, ow, kw, K, cogp, groups, splits, m_per_split,
      Kp, COp);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long total = (long long)groups * K * cogp;
  const int threads = 256;
  const int blocks = (int)min((total + threads - 1) / threads, 4096LL);
  conv_wgrad_reduce<<<blocks, threads, 0, st>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dw),
      groups, K, cogp, splits, Kp, COp);
  return (int)cudaGetLastError();
}

const char* cxx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
