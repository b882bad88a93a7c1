// Blocked triangular solve for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/trsm.py (trsm_lower,
// and trsm_upper / the _auto forms built on it): X with L X = B, where the
// diagonal sub-blocks of L come pre-inverted (Linv), so that
//   X_i = Linv_ii (B_i - sum_{j<i} L_ij X_j).
//
// Bound: the triangle is read once, n^2 / 2 floats, against n^2 m flops; for
// the direct path's few right-hand sides that is well under the H100's 20
// flops per byte, so the memory rate bounds it (0.16 ms for the triangle at
// n = 16384 over 3.35 TB/s).
//
// Design.  The TPU kernel runs one program per 256-column tile of B, each
// doing the whole substitution with full-height products: for one
// right-hand side that is one block on 132 SMs, doing twice the flops.
// Here the substitution is right-looking, one launch per block row i of 128
// rows: each block of the launch owns one block row j > i (and 32 columns
// of B), subtracts L_ji X_i from its rows of the working copy W of B, and
// the block that owns row i + 1 then forms X_{i+1} = Linv W_{i+1}, so the
// next launch finds it ready.  Every block reads a disjoint block of L, so
// the triangle is read once per 32 columns of B; each output belongs to one
// block and sums in a fixed order, so reruns are bitwise equal.
//
// Upper and transposed triangles are solved by index arithmetic, not by a
// flipped or transposed copy: logical row p is physical row n - 1 - p when
// `rev` is set (U x = b is (J U J)(J x) = J b with J the reversal), and
// `trans` reads the stored matrix transposed (Cholesky's L^T x = y).  The
// loads follow whichever index is contiguous in memory, so they coalesce in
// every mode.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSB = 128;       // block rows of the substitution
constexpr int kKC = 32;        // depth of one staged chunk of L
constexpr int kThreads = 256;
constexpr int kWide = 32;      // columns of B per block when m > 1

// The logical lower triangle L'(p, q) of a stored row-major matrix.
struct Tri {
  const float* t;
  int64_t ld;
  int n, rev, trans;
  __device__ __forceinline__ int64_t phys(int p) const {
    return rev ? static_cast<int64_t>(n) - 1 - p : p;
  }
  __device__ __forceinline__ float at(int p, int q) const {
    const int64_t r = phys(p), c = phys(q);
    return trans ? t[c * ld + r] : t[r * ld + c];
  }
  // contiguous in memory along q (the column index of L')
  __device__ __forceinline__ bool q_fast() const { return !trans; }
};

// One inverted (kSB, kSB) diagonal block of L', row-major.
struct Inv {
  const float* t;
  int base;  // first logical row and column of the block
  __device__ __forceinline__ float at(int p, int q) const {
    return t[(p - base) * kSB + (q - base)];
  }
  __device__ __forceinline__ bool q_fast() const { return true; }
};

// Ls[qq][pr] = src(p0 + pr, q0 + qq), zero outside [0, n).
template <class Src>
__device__ __forceinline__ void stage(float (&Ls)[kKC][kSB + 1],
                                      const Src& src, int p0, int q0, int n) {
  const bool q_fast = src.q_fast();
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kKC * kSB; idx += kThreads) {
    const int qq = q_fast ? idx % kKC : idx / kSB;
    const int pr = q_fast ? idx / kKC : idx % kSB;
    const int p = p0 + pr, q = q0 + qq;
    Ls[qq][pr] = (p < n && q < n) ? src.at(p, q) : 0.f;
  }
}

// acc += src(rows of the block at p0, columns qb .. qb + kSB) @ Xs.
// kMC = kWide: thread (g = warp, lane) owns rows g * 16 + r, column lane.
// kMC = 1: thread (h, pr) owns half h of each chunk's depth for row pr; the
// two halves are added by the caller (reduce1).
template <int kMC, class Src>
__device__ __forceinline__ void product(const Src& src, int p0, int qb, int n,
                                        const float (&Xs)[kSB][kMC],
                                        float (&Ls)[kKC][kSB + 1],
                                        float* acc) {
  for (int q0 = 0; q0 < kSB; q0 += kKC) {
    __syncthreads();                    // Ls free, Xs written
    stage(Ls, src, p0, qb + q0, n);
    __syncthreads();
    if constexpr (kMC == kWide) {
      const int lane = threadIdx.x % 32, g = threadIdx.x / 32;
#pragma unroll 8
      for (int qq = 0; qq < kKC; ++qq) {
        const float xv = Xs[q0 + qq][lane];
#pragma unroll
        for (int r = 0; r < 16; ++r)
          acc[r] = fmaf(Ls[qq][g * 16 + r], xv, acc[r]);
      }
    } else {
      const int pr = threadIdx.x % kSB, h = threadIdx.x / kSB;
#pragma unroll
      for (int qq = h * (kKC / 2); qq < (h + 1) * (kKC / 2); ++qq)
        acc[0] = fmaf(Ls[qq][pr], Xs[q0 + qq][0], acc[0]);
    }
  }
}

// kMC = 1: the row sum of thread pr < kSB (the two depth halves, in order).
__device__ __forceinline__ float reduce1(float (&red)[2][kSB], float part) {
  const int pr = threadIdx.x % kSB, h = threadIdx.x / kSB;
  __syncthreads();                      // red free
  red[h][pr] = part;
  __syncthreads();
  return red[0][pr] + red[1][pr];
}

// One step of the substitution.  step = -1 forms X_0 only; step i >= 0
// updates block rows j > i with X_i and forms X_{i+1}.  w (n, m) is the
// working copy of B and x (n, m) the solution, both in physical row order.
template <int kMC>
__global__ void __launch_bounds__(kThreads)
trsm_step_kernel(Tri tri, const float* __restrict__ linv, float* w, float* x,
                 int m, int step) {
  __shared__ float Xs[kSB][kMC];
  __shared__ float Ls[kKC][kSB + 1];
  __shared__ float red[2][kSB];
  constexpr int kR = kMC == kWide ? 16 : 1;
  const int n = tri.n;
  const int j = step + 1 + blockIdx.x;  // this block's block row
  const int p0 = j * kSB;
  const int c0 = blockIdx.y * kMC;
  const int lane = threadIdx.x % 32, g = threadIdx.x / 32;

  float acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = 0.f;
  if (step >= 0) {
    // X_step into Xs (product's first barrier publishes it)
    for (int idx = threadIdx.x; idx < kSB * kMC; idx += kThreads) {
      const int q = idx / kMC, c = idx % kMC;
      const int row = step * kSB + q;
      Xs[q][c] = (row < n && c0 + c < m)
                     ? x[tri.phys(row) * m + c0 + c] : 0.f;
    }
    product<kMC>(tri, p0, step * kSB, n, Xs, Ls, acc);
  }

  // val = W - L_j,step X_step for this thread's outputs
  float val[kR];
  bool ok[kR];
  int64_t pos[kR];
  if constexpr (kMC == kWide) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int p = p0 + g * 16 + r, c = c0 + lane;
      ok[r] = p < n && c < m;
      pos[r] = ok[r] ? tri.phys(p) * m + c : 0;
      val[r] = ok[r] ? w[pos[r]] - acc[r] : 0.f;
    }
  } else {
    const float sum = reduce1(red, acc[0]);
    const int p = p0 + threadIdx.x % kSB;
    ok[0] = threadIdx.x < kSB && p < n;
    pos[0] = ok[0] ? tri.phys(p) * m : 0;
    val[0] = ok[0] ? w[pos[0]] - sum : 0.f;
  }

  if (j != step + 1) {                  // not next: keep the update
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (ok[r]) w[pos[r]] = val[r];
    return;
  }
  // next block row: X_j = Linv_jj W_j
  __syncthreads();                      // everyone is done with Xs
  if constexpr (kMC == kWide) {
#pragma unroll
    for (int r = 0; r < kR; ++r) Xs[g * 16 + r][lane] = val[r];
  } else {
    if (threadIdx.x < kSB) Xs[threadIdx.x][0] = val[0];
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = 0.f;
  product<kMC>(Inv{linv + static_cast<int64_t>(j) * kSB * kSB, p0}, p0, p0,
               n, Xs, Ls, acc);
  if constexpr (kMC == kWide) {
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (ok[r]) x[pos[r]] = acc[r];
  } else {
    const float sum = reduce1(red, acc[0]);
    if (ok[0]) x[pos[0]] = sum;
  }
}

template <int kMC>
int run(const Tri& tri, const float* linv, float* w, float* x, int m,
        cudaStream_t s) {
  const int nblk = (tri.n + kSB - 1) / kSB;
  const int ycols = (m + kMC - 1) / kMC;
  for (int step = -1; step < nblk - 1; ++step) {
    const dim3 grid(step < 0 ? 1 : nblk - 1 - step, ycols);
    trsm_step_kernel<kMC><<<grid, kThreads, 0, s>>>(tri, linv, w, x, m, step);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

int trsm_block_rows() { return kSB; }

const char* trsm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Solve L' X = B for the logical lower triangle L' of the stored (n, n)
// row-major matrix t (row stride ld), flags rev / trans as above.  linv
// holds ceil(n / 128) inverted (128, 128) diagonal blocks of L' (the last
// one identity-padded); w holds B (n, m) and is overwritten; x receives X.
// Returns the CUDA error (0 on success).
int trsm_solve(const float* t, int64_t ld, int n, int rev, int trans,
               const float* linv, float* w, float* x, int m, int device,
               void* stream) {
  if (n <= 0 || m <= 0 || ld < n || m > 65535 * kWide)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  const Tri tri{t, ld, n, rev, trans};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m == 1 ? run<1>(tri, linv, w, x, m, s)
                : run<kWide>(tri, linv, w, x, m, s);
}

}  // extern "C"
