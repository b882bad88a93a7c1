// The float32 tile GEMM of factor_fused.cu (kernels 4 and 5): C = A B or
// C -= A B on strided views, for any M, N, K.  (Kernels 7 and 9 run the
// multistage mainloop of tile_gemm_sm90.cuh.)
//
// Each 128 x 128 output tile belongs to one block of 256 threads (8 x 8
// outputs a thread), which walks K in slices of 8: a slice is staged
// through shared memory, and the next slice's loads are issued into
// registers before the current slice is multiplied (two shared buffers, one
// barrier a slice).  The products run in full float32 with float32
// accumulation, summed in a fixed order: no TF32, no tensor cores, no
// atomics, so reruns are bitwise equal.  The kernel can sum a range of K
// a blockIdx.z (kc deep, C at c + z * zs); the panel updates launch one.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tile {

constexpr int kBM = 128;           // output tile rows
constexpr int kBN = 128;           // output tile columns
constexpr int kBK = 8;             // depth of one staged slice
constexpr int kThreads = 256;      // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLoads = kBM * kBK / kThreads;   // staged values a thread

static_assert(kBM == kBN, "one load pattern serves both operands");

// A strided matrix view: element (i, q) at p[i * rs + q * cs].
struct View {
  const float* p;
  int64_t rs, cs;
  __device__ __forceinline__ float at(int i, int q) const {
    return p[static_cast<int64_t>(i) * rs + static_cast<int64_t>(q) * cs];
  }
};

// The slice element that load index `idx` of a (kBK x kB) slice stages:
// along whichever index is contiguous in memory, so the loads coalesce.
__device__ __forceinline__ void slot(int idx, bool q_fast, int& qq, int& ii) {
  qq = q_fast ? idx % kBK : idx / kBM;
  ii = q_fast ? idx / kBK : idx % kBM;
}

// C[i, j] (kSub false: =, true: -=) sum over q in [z kc, min(K, (z+1) kc))
// of A(i, q) B(q, j), for i < M, j < N, with z = blockIdx.z and C at
// c + z * zs (row stride ldc).
template <bool kSub>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(View A, View B, float* __restrict__ c, int64_t ldc, int64_t zs,
            int M, int N, int K, int kc) {
  // padded rows: the staging stores are free of bank conflicts
  __shared__ float As[2][kBK][kBM + 4];
  __shared__ float Bs[2][kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  const int q_lo = blockIdx.z * kc;
  const int q_hi = min(K, q_lo + kc);
  c += blockIdx.z * zs;
  // A(i, q) is contiguous along q when cs == 1; B(q, j) along j when cs == 1
  const bool a_q_fast = A.cs == 1;
  const bool b_q_fast = B.cs != 1;

  float ra[kLoads], rb[kLoads];
  auto load = [&](int q0) {
#pragma unroll
    for (int s = 0; s < kLoads; ++s) {
      int qq, ii;
      slot(tid + s * kThreads, a_q_fast, qq, ii);
      const int i = i0 + ii, q = q0 + qq;
      ra[s] = (i < M && q < q_hi) ? A.at(i, q) : 0.f;
      slot(tid + s * kThreads, b_q_fast, qq, ii);
      const int j = j0 + ii;
      rb[s] = (j < N && q0 + qq < q_hi) ? B.at(q0 + qq, j) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int s = 0; s < kLoads; ++s) {
      int qq, ii;
      slot(tid + s * kThreads, a_q_fast, qq, ii);
      As[buf][qq][ii] = ra[s];
      slot(tid + s * kThreads, b_q_fast, qq, ii);
      Bs[buf][qq][ii] = rb[s];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;

  load(q_lo);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int q0 = q_lo; q0 < q_hi; q0 += kBK) {
    const bool more = q0 + kBK < q_hi;
    if (more) load(q0 + kBK);          // in flight while this slice runs
#pragma unroll
    for (int qq = 0; qq < kBK; ++qq) {
      float av[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) av[r] = As[buf][qq][ty + 16 * r];
#pragma unroll
      for (int s = 0; s < 8; ++s) bv[s] = Bs[buf][qq][tx + 16 * s];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int s = 0; s < 8; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
    }
    // the other buffer was last read before the previous barrier
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= M) continue;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int j = j0 + tx + 16 * s;
      if (j >= N) continue;
      float* o = c + static_cast<int64_t>(i) * ldc + j;
      *o = kSub ? *o - acc[r][s] : acc[r][s];
    }
  }
}

// Launch C (= or -=) A B.  Returns the CUDA error of the launch (0 on
// success).
template <bool kSub>
int gemm(View A, View B, float* c, int64_t ldc, int M, int N, int K,
         cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, 1);
  gemm_kernel<kSub><<<grid, kThreads, 0, s>>>(A, B, c, ldc, 0, M, N, K, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile
