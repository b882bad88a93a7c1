// The float32 tile GEMM shared by gemm.cu (kernel 7), qr_fused.cu (kernel 9)
// and factor_fused.cu (kernels 4 and 5): C = A B or C -= A B on strided
// views, for any M, N, K, with an optional split of K that stays
// deterministic.
//
// Each 128 x 128 output tile belongs to one block of 256 threads (8 x 8
// outputs a thread), which walks its range of K in slices of 8: a slice is
// staged through shared memory, and the next slice's loads are issued into
// registers before the current slice is multiplied (two shared buffers, one
// barrier a slice).  The products run in full float32 with float32
// accumulation, summed in a fixed order: no TF32, no tensor cores, no
// atomics, so reruns are bitwise equal.
//
// Few output tiles with a long K (QR's (nb x m) V^T times (m x n) A has 63
// tiles at n = 8192, nb = 128, on 132 SMs) would leave most of the card idle,
// so K is split: split z sums its own range of K into a partial tile of a
// scratch buffer, and a second launch adds the partials in the order
// z = 0, 1, ... into C.  The number of splits depends on the shapes alone.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tile {

constexpr int kBM = 128;           // output tile rows
constexpr int kBN = 128;           // output tile columns
constexpr int kBK = 8;             // depth of one staged slice
constexpr int kThreads = 256;      // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLoads = kBM * kBK / kThreads;   // staged values a thread
constexpr int kTargetBlocks = 264;             // two waves on 132 SMs
constexpr int kMinSplitDepth = 512;            // least K a split keeps
constexpr int kSumThreads = 256;

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

// C[i, j] (= or -=) the sum over z = 0, 1, ..., nz - 1, in that order, of
// the partial tiles part[z * M * N + i * N + j].
template <bool kSub>
__global__ void __launch_bounds__(kSumThreads)
split_sum_kernel(const float* __restrict__ part, int nz, float* c,
                 int64_t ldc, int M, int N) {
  const int64_t total = static_cast<int64_t>(M) * N;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < total; e += step) {
    float sum = part[e];
    for (int z = 1; z < nz; ++z) sum += part[z * total + e];
    float* o = c + (e / N) * ldc + e % N;
    *o = kSub ? *o - sum : sum;
  }
}

// How many parts K is split into for an (M x K)(K x N) product: one when
// the output tiles alone fill two waves, else enough parts for two waves,
// each at least kMinSplitDepth deep.  The wrapper sizes the scratch by it.
inline int splits_for(int64_t M, int64_t N, int64_t K) {
  const int64_t tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tiles <= 0 || tiles >= kTargetBlocks / 2) return 1;
  int64_t s = (kTargetBlocks + tiles - 1) / tiles;
  if (s > K / kMinSplitDepth) s = K / kMinSplitDepth;
  return s < 1 ? 1 : static_cast<int>(s);
}

// Launch C (= or -=) A B; `scratch` holds splits * M * N floats when
// splits > 1.  Returns the CUDA error of the launches (0 on success).
template <bool kSub>
int gemm(View A, View B, float* c, int64_t ldc, int M, int N, int K,
         float* scratch, int splits, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 ||
      (M + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int kc = (K + splits - 1) / splits;
  kc = (kc + kBK - 1) / kBK * kBK;
  const int nz = (K + kc - 1) / kc;       // every split non-empty
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, nz);
  if (nz == 1) {
    gemm_kernel<kSub><<<grid, kThreads, 0, s>>>(A, B, c, ldc, 0, M, N, K,
                                                kc);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(M) * N;
  gemm_kernel<false><<<grid, kThreads, 0, s>>>(A, B, scratch, N, total, M,
                                               N, K, kc);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  int64_t blocks = (total + kSumThreads - 1) / kSumThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  split_sum_kernel<kSub><<<static_cast<int>(blocks), kSumThreads, 0, s>>>(
      scratch, nz, c, ldc, M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile
