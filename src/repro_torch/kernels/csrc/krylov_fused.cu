// Fused Krylov vector kernels for Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/krylov_fused.py:
//   * fused_cg_update      (x + a p, r - a Ap, <r', r'> in one pass)
//   * fused_pipelined_dots (<r,u>, <w,u>, <r,r> in one read)
//
// Bound: both kernels are memory-bound.  Every element costs 4 bytes per
// stream and at most two flops per stream, far below the H100's ~20 flops
// per byte, so the least time is the bytes moved over 3.35 TB/s (H100 SXM):
//   fused_cg_update:      4 streams read + 2 written = 24 n bytes
//   fused_pipelined_dots: 3 streams read             = 12 n bytes
// The design meets the bound with a single pass and no intermediate
// vectors: each element is read once and each output written once, and the
// reductions ride along in registers.  Vectorised loads, grid tuning and
// CUDA graphs are left for later work.
//
// Determinism: the reductions use no atomics.  Pass 1 writes one partial
// sum per block (a shared-memory tree with a fixed shape) into a partials
// buffer; pass 2 is one block that sums the partials in a fixed order.  The
// grid depends only on n, so reruns give bitwise-identical results.
//
// The TPU kernels' zero pad to a multiple of 8x128 was a tiling need; here a
// grid-stride loop with an `i < n` bound covers any n.
//
// The step length alpha is read from device memory, so the host never has
// to read it back (no synchronisation per iteration).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // threads per block, a power of two
constexpr int kMaxBlocks = 1024; // size of the partials buffer per sum

// Sums K values per thread across the block with a fixed-shape tree; the
// block's sums end in sh[k][0].
template <int K>
__device__ __forceinline__ void block_tree_sum(float (&sh)[K][kThreads],
                                               const float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) sh[k][threadIdx.x] = v[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
#pragma unroll
      for (int k = 0; k < K; ++k) sh[k][threadIdx.x] += sh[k][threadIdx.x + s];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
cg_update_kernel(const float* __restrict__ x, const float* __restrict__ r,
                 const float* __restrict__ p, const float* __restrict__ ap,
                 const float* __restrict__ alpha, float* __restrict__ xo,
                 float* __restrict__ ro, float* __restrict__ partials,
                 int64_t n) {
  __shared__ float sh[1][kThreads];
  const float a = *alpha;
  float acc[1] = {0.f};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    // rounded product then rounded sum, as the plain version computes them
    const float xn = __fadd_rn(x[i], __fmul_rn(a, p[i]));
    const float rn = __fsub_rn(r[i], __fmul_rn(a, ap[i]));
    xo[i] = xn;
    ro[i] = rn;
    acc[0] = fmaf(rn, rn, acc[0]);
  }
  block_tree_sum<1>(sh, acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = sh[0][0];
}

__global__ void __launch_bounds__(kThreads)
pipelined_dots_kernel(const float* __restrict__ r, const float* __restrict__ u,
                      const float* __restrict__ w, float* __restrict__ partials,
                      int64_t n) {
  __shared__ float sh[3][kThreads];
  float acc[3] = {0.f, 0.f, 0.f};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float ri = r[i], ui = u[i], wi = w[i];
    acc[0] = fmaf(ri, ui, acc[0]);
    acc[1] = fmaf(wi, ui, acc[1]);
    acc[2] = fmaf(ri, ri, acc[2]);
  }
  block_tree_sum<3>(sh, acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) partials[k * gridDim.x + blockIdx.x] = sh[k][0];
  }
}

// One block: out[k] = sum of partials[k * nparts .. (k + 1) * nparts), each
// thread striding over the partials in index order, then the fixed tree.
template <int K>
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, int nparts,
                    float* __restrict__ out) {
  __shared__ float sh[K][kThreads];
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    acc[k] = 0.f;
    for (int j = threadIdx.x; j < nparts; j += kThreads)
      acc[k] += partials[k * nparts + j];
  }
  block_tree_sum<K>(sh, acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = sh[k][0];
  }
}

int check_args(int device, int64_t n, int blocks) {
  if (n <= 0 || blocks <= 0 || blocks > kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace

extern "C" {

int krylov_threads() { return kThreads; }
int krylov_max_blocks() { return kMaxBlocks; }

const char* krylov_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xo = x + alpha p, ro = r - alpha ap, rr = <ro, ro>.  partials holds
// `blocks` floats.  Returns the CUDA error of the launches (0 on success).
int krylov_fused_cg_update(const float* x, const float* r, const float* p,
                           const float* ap, const float* alpha, float* xo,
                           float* ro, float* partials, float* rr, int64_t n,
                           int blocks, int device, void* stream) {
  int err = check_args(device, n, blocks);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cg_update_kernel<<<blocks, kThreads, 0, s>>>(x, r, p, ap, alpha, xo, ro,
                                               partials, n);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  sum_partials_kernel<1><<<1, kThreads, 0, s>>>(partials, blocks, rr);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3) = <r,u>, <w,u>, <r,r>.  partials holds 3 * `blocks` floats.
int krylov_fused_pipelined_dots(const float* r, const float* u, const float* w,
                                float* partials, float* out, int64_t n,
                                int blocks, int device, void* stream) {
  int err = check_args(device, n, blocks);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pipelined_dots_kernel<<<blocks, kThreads, 0, s>>>(r, u, w, partials, n);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  sum_partials_kernel<3><<<1, kThreads, 0, s>>>(partials, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
