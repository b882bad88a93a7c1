// Block-CSR sparse matrix times dense matrix, Y = A X, for Hopper (sm_90a),
// with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/spmv.py:
//   * bsr_spmm / bsr_matvec (Y = A X over nb x nb bricks, X of k columns)
//
// A is BSR: data (nnzb, nb, nb) row-major bricks, indices (nnzb,) block
// columns, indptr (nbr + 1,) block-row offsets.  X is (nbc * nb, k) and Y is
// (nbr * nb, k), both row-major.  float32 accumulates in float32, float64 in
// float64.
//
// Bound: memory.  Every brick entry is read once and used for k multiply-adds
// (2k flops per 4 or 8 bytes), far below the H100's ~20 float32 flops per
// byte, so the least time is the bytes (bricks, structure, X read once and Y
// written once) over 3.35 TB/s (H100 SXM).  At the smoke's 128^3 Poisson
// system (nnzb = 423,936, nb = 32) the bricks alone are 1.74 GB (float32).
//
// The TPU kernel runs a fixed (nbr, max_blk) grid over the padded
// blocked-ELL tables and masks the pad slots, because Mosaic needs static
// index maps.  Here one CTA owns one block row and walks its own
// indptr[r]:indptr[r+1] entries, so uneven rows cost no pad reads.
//
// Two paths, one function:
//   * nb = 32, k = 1 (the Krylov solvers' matvec at the from_dense default
//     brick size): the bricks of a block row are one contiguous run of
//     memory.  The CTA streams it with 16-byte vector loads, fully
//     coalesced, four bricks in flight per thread; each thread keeps the
//     partial sums of the brick rows it touches in registers, and the
//     threads that share a row reduce them with a fixed shuffle tree.
//   * any other nb or k: one warp per output row (and group of up to four
//     columns); the lanes stride the brick row (coalesced for nb >= 32),
//     the sums stay in registers across the row's bricks, then one fixed
//     shuffle tree.
//
// Determinism: no atomics.  Each output element is summed by one warp in a
// fixed order (bricks in indptr order, then a fixed-shape tree), so reruns
// give bitwise-identical results.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;           // threads per CTA (4 warps)
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Vec;                             // one 16-byte load
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ void unpack(const float4& v,
                                                float (&o)[4]) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ void unpack(const double2& v,
                                                double (&o)[2]) {
    o[0] = v.x; o[1] = v.y;
  }
};

// a * b + c, rounded once
__device__ __forceinline__ float madd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// Sum over aligned groups of `width` lanes (a power of two <= 32) with a
// fixed butterfly; every lane of a group ends with the group's sum.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// nb = 32, k = 1.  Thread t reads 16-byte vector t + s * kThreads of each
// brick (s < kAcc): brick row t / kG + s * kRowsPerStep, columns
// (t % kG) * kV .. + kV.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_nb32_kernel(const T* __restrict__ data, const int* __restrict__ indices,
                     const int* __restrict__ indptr, const T* __restrict__ x,
                     T* __restrict__ y) {
  using V = typename Vec<T>::type;
  constexpr int kNb = 32;
  constexpr int kV = Vec<T>::n;                    // elements per load
  constexpr int kG = kNb / kV;                     // threads per brick row
  constexpr int kRowsPerStep = kThreads / kG;      // brick rows per load step
  constexpr int kAcc = kNb / kRowsPerStep;         // rows (loads) per thread
  constexpr int kUnroll = 4;                       // bricks in flight
  const int r = blockIdx.x;
  const int lo = indptr[r], hi = indptr[r + 1];
  const int t = threadIdx.x;
  const int j0 = (t % kG) * kV;
  const V* d = reinterpret_cast<const V*>(data + static_cast<int64_t>(lo) *
                                          kNb * kNb) + t;
  constexpr int kBrickVecs = kNb * kNb / kV;
  T acc[kAcc];
#pragma unroll
  for (int s = 0; s < kAcc; ++s) acc[s] = T(0);
  int e = lo;
  for (; e + kUnroll <= hi; e += kUnroll) {
    V a[kUnroll][kAcc];
    T xv[kUnroll][kV];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* xb = x + static_cast<int64_t>(indices[e + u]) * kNb + j0;
#pragma unroll
      for (int v = 0; v < kV; ++v) xv[u][v] = xb[v];
#pragma unroll
      for (int s = 0; s < kAcc; ++s) a[u][s] = d[u * kBrickVecs + s * kThreads];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int s = 0; s < kAcc; ++s) {
        T av[kV];
        Vec<T>::unpack(a[u][s], av);
#pragma unroll
        for (int v = 0; v < kV; ++v) acc[s] = madd(av[v], xv[u][v], acc[s]);
      }
    }
    d += kUnroll * kBrickVecs;
  }
  for (; e < hi; ++e) {
    const T* xb = x + static_cast<int64_t>(indices[e]) * kNb + j0;
    T xv[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) xv[v] = xb[v];
#pragma unroll
    for (int s = 0; s < kAcc; ++s) {
      T av[kV];
      Vec<T>::unpack(d[s * kThreads], av);
#pragma unroll
      for (int v = 0; v < kV; ++v) acc[s] = madd(av[v], xv[v], acc[s]);
    }
    d += kBrickVecs;
  }
#pragma unroll
  for (int s = 0; s < kAcc; ++s) {
    const T sum = group_sum(acc[s], kG);
    if (t % kG == 0)
      y[static_cast<int64_t>(r) * kNb + t / kG + s * kRowsPerStep] = sum;
  }
}

// Any nb and k.  Warp w of block row r computes outputs o = w, w + kWarps,
// ...: brick row i = o / kchunks and columns c0 .. c0 + KT (c0 =
// (o % kchunks) * KT) of Y.
template <typename T, int KT>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const T* __restrict__ data, const int* __restrict__ indices,
                const int* __restrict__ indptr, const T* __restrict__ x,
                T* __restrict__ y, int nb, int k) {
  const int r = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = indptr[r], hi = indptr[r + 1];
  const int64_t brick = static_cast<int64_t>(nb) * nb;
  const int kchunks = (k + KT - 1) / KT;
  for (int o = warp; o < nb * kchunks; o += kWarps) {
    const int i = o / kchunks, c0 = (o % kchunks) * KT;
    T acc[KT];
#pragma unroll
    for (int c = 0; c < KT; ++c) acc[c] = T(0);
    for (int e = lo; e < hi; ++e) {
      const T* row = data + e * brick + static_cast<int64_t>(i) * nb;
      const T* xb = x + static_cast<int64_t>(indices[e]) * nb * k + c0;
      for (int j = lane; j < nb; j += 32) {
        const T a = row[j];
#pragma unroll
        for (int c = 0; c < KT; ++c)
          if (c0 + c < k)
            acc[c] = madd(a, xb[static_cast<int64_t>(j) * k + c], acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      const T sum = group_sum(acc[c], 32);
      if (lane == 0 && c0 + c < k)
        y[(static_cast<int64_t>(r) * nb + i) * k + c0 + c] = sum;
    }
  }
}

template <typename T>
int launch(const void* data, const int* indices, const int* indptr,
           const void* x, void* y, int nbr, int nb, int k, cudaStream_t s) {
  const T* d = static_cast<const T*>(data);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  const bool aligned = reinterpret_cast<uintptr_t>(data) % 16 == 0;
  if (nb == 32 && k == 1 && aligned)
    bsr_spmv_nb32_kernel<T><<<nbr, kThreads, 0, s>>>(d, indices, indptr, xv,
                                                     yv);
  else if (k == 1)
    bsr_spmm_kernel<T, 1><<<nbr, kThreads, 0, s>>>(d, indices, indptr, xv,
                                                   yv, nb, k);
  else
    bsr_spmm_kernel<T, 4><<<nbr, kThreads, 0, s>>>(d, indices, indptr, xv,
                                                   yv, nb, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Y = A X for a BSR A of nbr block rows and nb x nb bricks; X is
// (nbc * nb, k) and Y (nbr * nb, k), row-major.  `is_double` selects
// float64 (1) or float32 (0) for data, X and Y.  Returns the CUDA error of
// the launch (0 on success).
int spmv_bsr(const void* data, const int* indices, const int* indptr,
             const void* x, void* y, int nbr, int nb, int k, int is_double,
             int device, void* stream) {
  if (nbr <= 0 || nb <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch<double>(data, indices, indptr, x, y, nbr, nb, k, s)
             : launch<float>(data, indices, indptr, x, y, nbr, nb, k, s);
}

}  // extern "C"
