// Fused LU / Cholesky panel-update kernels for Hopper (sm_90a), with a plain
// C interface for ctypes.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/factor_fused.py:
//   * lu_panel_update       (U12 = L11^-1 A12 into the panel row block,
//                            A22 -= L21 U12)
//   * cholesky_panel_update (L21 = C Lkk^-T into the panel column block,
//                            A22 -= L21 L21^T, both triangles)
//
// Bound: with m = n - k - nb trailing rows, one step does 2 m^2 nb + 2 m nb^2
// flops over about (2 m^2 + 3 m nb) * 4 bytes, ~32 flops per byte at nb = 128:
// above the H100's 20 flops per byte (67 TFLOP/s float32 outside the tensor
// cores over 3.35 TB/s), so the float32 pipes bound it.  The products run in
// full float32 with float32 accumulation: no TF32, no tensor cores, since
// the reference holds float32 factorizations to float32 products.
//
// Design.  The TPU kernel runs a fixed (n/nb) x (n/nb) grid over the whole
// matrix with the step offset k as a scalar, and masks the tiles outside the
// active window; every tile recomputes its slice of U12.  Here k is a host
// integer, so each launch covers only the active window, and each step is
// two launches of one tiled kernel:
//   1. the panel solve (U12 = Linv R, or L21 = C Linv^T) into a scratch
//      buffer;
//   2. the rank-nb update of the trailing block, reading the panel solve
//      from the scratch buffer;
// then one strided device copy puts the panel solve in its place in the
// matrix.  The scratch keeps every block from reading values that another
// block is writing, so the step works in place on the working matrix.
// Each 128 x 128 output tile belongs to one block, which sums its products
// in a fixed order: no atomics, and reruns are bitwise equal.  The tile is
// the SIMT GEMM of tile_gemm.cuh (8 x 8 outputs a thread, the next
// slice's loads in flight while the current one multiplies), unsplit: the
// trailing block's tiles fill the card.  TMA and wgmma are left for later
// work.

#include "tile_gemm.cuh"

namespace {

using tile::View;

int check_args(int device, int64_t n, int64_t k, int nb) {
  if (n <= 0 || nb <= 0 || k < 0 || k + nb > n || n > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace

extern "C" {

const char* factor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One LU step on the row-major (n, n) matrix `a`, in place.  `linv` is the
// (nb, nb) inverse of the unit-lower diagonal block at (k, k); `u` is
// scratch of nb * (n - k - nb) floats.  Launches nothing when k + nb = n.
// Returns the CUDA error (0 on success).
int factor_lu_panel_update(float* a, int64_t n, const float* linv, int64_t k,
                           int nb, float* u, int device, void* stream) {
  int err = check_args(device, n, k, nb);
  if (err) return err;
  const int m = static_cast<int>(n - k - nb);
  if (m == 0) return 0;                 // last step: nothing right of it
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* row = a + k * n + k + nb;      // panel row block, trailing columns
  // U12 = Linv R into the scratch
  err = tile::gemm<false>(View{linv, nb, 1}, View{row, n, 1}, u, m, nb, m,
                          nb, s);
  if (err) return err;
  // A22 -= L21 U12
  float* l21 = a + (k + nb) * n + k;
  err = tile::gemm<true>(View{l21, n, 1}, View{u, m, 1}, l21 + nb, n, m, m,
                         nb, s);
  if (err) return err;
  // U12 into the panel row block (after the solve has read all of R)
  return static_cast<int>(cudaMemcpy2DAsync(
      row, n * sizeof(float), u, m * sizeof(float), m * sizeof(float), nb,
      cudaMemcpyDeviceToDevice, s));
}

// One Cholesky step on the row-major (n, n) matrix `a`, in place.  `linv` is
// the (nb, nb) inverse of the lower Cholesky factor of the diagonal block at
// (k, k); `l` is scratch of (n - k - nb) * nb floats.
int factor_cholesky_panel_update(float* a, int64_t n, const float* linv,
                                 int64_t k, int nb, float* l, int device,
                                 void* stream) {
  int err = check_args(device, n, k, nb);
  if (err) return err;
  const int m = static_cast<int>(n - k - nb);
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* col = a + (k + nb) * n + k;    // panel column block, rows below
  // L21 = C Linv^T into the scratch: B(q, j) = linv[j, q]
  err = tile::gemm<false>(View{col, n, 1}, View{linv, 1, nb}, l, nb, m, nb,
                          nb, s);
  if (err) return err;
  // A22 -= L21 L21^T over the whole trailing block (both triangles, as the
  // TPU kernel does): B(q, j) = l[j, q]
  err = tile::gemm<true>(View{l, nb, 1}, View{l, 1, nb}, col + nb, n, m, m,
                         nb, s);
  if (err) return err;
  // L21 into the panel column block
  return static_cast<int>(cudaMemcpy2DAsync(
      col, n * sizeof(float), l, nb * sizeof(float), nb * sizeof(float), m,
      cudaMemcpyDeviceToDevice, s));
}

}  // extern "C"
