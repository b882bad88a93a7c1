// Fused LU / Cholesky panel-update kernels for Hopper (sm_90a), with a plain
// C interface for ctypes.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/factor_fused.py:
//   * lu_panel_update       (U12 = L11^-1 A12 into the panel row block,
//                            A22 -= L21 U12)
//   * cholesky_panel_update (L21 = C Lkk^-T into the panel column block,
//                            A22 -= L21 L21^T, both triangles)
//
// Bound, with m = n - k - nb trailing rows:
//   * LU: 2 m^2 nb + 2 m nb^2 flops over (nb^2 + 3 m nb + 2 m^2) * 4 bytes,
//     ~32 flops a byte at nb = 128: above the H100's 20 (67 TFLOP/s float32
//     outside the tensor cores over 3.35 TB/s), so the float32 pipes bound
//     it (1.02 ms at k = 0, n = 16384);
//   * Cholesky: the update's product is symmetric, so its least work is the
//     tiles on and below the diagonal, m (m + 1) nb + 2 m nb^2 flops, over
//     (nb^2 + 2 m nb + 2 m^2) * 4 bytes (both triangles of A22 read and
//     written): ~16 flops a byte, so the bytes bound it (0.64 ms at k = 0).
// The products run in full float32 with float32 accumulation: no TF32, no
// tensor cores, since the reference holds float32 factorizations to float32
// products.
//
// Design.  The TPU kernel runs a fixed (n/nb) x (n/nb) grid over the whole
// matrix with the step offset k as a scalar, masks the tiles outside the
// active window, recomputes its slice of the panel solve in every tile, and
// computes both triangles of Cholesky's update.  Here k is a host integer,
// so each launch covers only the active window, and each step is two
// launches of the multistage float32 mainloop of tile_gemm_sm90.cuh (the
// layouts are known, so its products are called with them):
//   1. the panel solve (U12 = Linv R, or L21 = C Linv^T) into a scratch
//      buffer: C K-major, R MN-major (row stride n), Linv read in the
//      column-major layout the factorizations' triangular solve gives it
//      (MN-major as LU's A, as Cholesky's B^T), so no step copies it;
//   2. the rank-nb update of the trailing block, in place, reading the
//      panel solve from the scratch: LU's A22 -= L21 U12 on the subtracting
//      epilogue (L21 K-major in the matrix, U12 MN-major), one block a
//      128 x 128 tile; Cholesky's A22 -= L21 L21^T on the symmetric
//      variant, one block a tile on or below the diagonal, which subtracts
//      its product P from its tile and P^T from the mirrored tile (staged
//      transposed through shared memory, 16-byte accesses along rows):
//      half the flops, and both triangles bitwise as the full product
//      writes them, since element (j, i) of L21 L21^T sums fmaf(L[j, q],
//      L[i, q]) in the same ascending q as P's element (i, j) sums
//      fmaf(L[i, q], L[j, q]).  Each mirror reads its own tile of A, so A
//      need not be symmetric; diagonal tiles are computed whole;
// then one strided device copy puts the panel solve in its place in the
// matrix.  The scratch keeps every block from reading values that another
// block is writing, so the step works in place on the working matrix.
// K = nb is not split (nb < 512): each output tile belongs to one block,
// which sums its products in a fixed order, with no atomics, so reruns are
// bitwise equal.  At nb = 128 every operand and the window take 16-byte
// copies and accesses (k a multiple of nb, n of nb); other nb take the
// mainloop's 4-byte path where they must.

#include "tile_gemm_sm90.cuh"

namespace {

// C -= A A^T for the K-major (M x K) operand A and C(i, j) at c[i * ldc +
// j], i, j < M: one block a tile on and below the diagonal, each tile
// below it also subtracted, transposed, from its mirror, so both triangles
// are written as the full product would write them, in about half its
// flops.
// Returns the CUDA error (0 on success).
int syrk_sub(const sm90::Operand& A, float* c, int64_t ldc, int K,
             cudaStream_t s) {
  const int64_t t = (static_cast<int64_t>(A.rows) + sm90::kBM - 1) /
                    sm90::kBM;
  if (A.rows <= 0 || K <= 0 || ldc < A.rows || t * (t + 1) / 2 > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  return sm90::launch<true, true, true, true>(A, A, c, ldc, 0, K, K, 1,
                                              sm90::vec_out(c, ldc), s);
}

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

// The lower tile (*ti, *tj) that block b of the symmetric update owns.
void factor_lower_tile(int64_t b, int* ti, int* tj) {
  sm90::lower_tile(b, *ti, *tj);
}

// One LU step on the row-major (n, n) matrix `a`, in place.  `linv` is the
// (nb, nb) inverse of the unit-lower diagonal block at (k, k), column-major
// (Linv(i, q) at linv[i + q nb], as torch.linalg.solve_triangular returns
// it); `u` is scratch of nb * (n - k - nb) floats.  Launches nothing when k + nb = n.
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
  err = sm90::product<false, false>(sm90::mn_operand(linv, nb, nb),
                                    sm90::mn_operand(row, n, m), u, m, nb,
                                    nullptr, 1, s);
  if (err) return err;
  // A22 -= L21 U12, in place
  float* l21 = a + (k + nb) * n + k;
  err = sm90::product<true, false, true>(sm90::k_operand(l21, n, m),
                                         sm90::mn_operand(u, m, m), l21 + nb,
                                         n, nb, nullptr, 1, s);
  if (err) return err;
  // U12 into the panel row block (after the solve has read all of R)
  return static_cast<int>(cudaMemcpy2DAsync(
      row, n * sizeof(float), u, m * sizeof(float), m * sizeof(float), nb,
      cudaMemcpyDeviceToDevice, s));
}

// One Cholesky step on the row-major (n, n) matrix `a`, in place.  `linv` is
// the (nb, nb) inverse of the lower Cholesky factor of the diagonal block at
// (k, k), column-major; `l` is scratch of (n - k - nb) * nb floats.
int factor_cholesky_panel_update(float* a, int64_t n, const float* linv,
                                 int64_t k, int nb, float* l, int device,
                                 void* stream) {
  int err = check_args(device, n, k, nb);
  if (err) return err;
  const int m = static_cast<int>(n - k - nb);
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* col = a + (k + nb) * n + k;    // panel column block, rows below
  // L21 = C Linv^T into the scratch: B^T(j, q) = Linv(j, q)
  err = sm90::product<true, false>(sm90::k_operand(col, n, m),
                                   sm90::mn_operand(linv, nb, nb), l, nb, nb,
                                   nullptr, 1, s);
  if (err) return err;
  // A22 -= L21 L21^T: the lower tiles, each mirrored
  err = syrk_sub(sm90::k_operand(l, nb, m), col + nb, n, nb, s);
  if (err) return err;
  // L21 into the panel column block
  return static_cast<int>(cudaMemcpy2DAsync(
      col, n * sizeof(float), l, nb * sizeof(float), nb * sizeof(float), m,
      cudaMemcpyDeviceToDevice, s));
}

}  // extern "C"
