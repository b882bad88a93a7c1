// Blocked Householder QR trailing update for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/qr_fused.py
// (qr_panel_update): after the panel at column k is factored, A <- (I - V T^T
// V^T) A on the columns >= k + nb, with V the (m, nb) Householder vectors
// (unit diagonal at row k + j, zero above row k) and T the compact-WY
// triangle.
//
// Bound: with R = m - k active rows and N = n - k - nb trailing columns,
// W = V^T A, Y = T^T W and A -= V Y do 4 R nb N + 2 nb^2 N flops over about
// (2 R N + R nb) * 4 bytes: ~64 flops a byte at nb = 128, above the H100's
// 20, so the float32 pipes bound it (2.02 ms at k = 0 for m = 32768,
// n = 8192).
//
// Design.  The TPU kernel gives each program one full-height (m, bn) column
// strip, held in VMEM with V, and forms W and the update there.  At
// m = 32768 such a strip is 16 MB against 228 KB of shared memory a
// Hopper SM, and column strips alone give 63 blocks at k = 0 on 132 SMs.
// So the update is three products of the tile GEMM (tile_gemm.cuh), each
// over the active window only (k is a host integer, V is zero above row k):
//   1. W = V^T A, (nb x R)(R x N): K = R is split into parts, each block
//      summing its (part, column tile); a second launch adds the parts in
//      a fixed order;
//   2. Y = T^T W, (nb x nb)(nb x N), into scratch;
//   3. A -= V Y, (R x nb)(nb x N), in place: one block per 128 x 128 tile
//      of the window (16,128 tiles at k = 0).
// W and Y round-trip through device memory (nb N floats each, 4 MB at
// k = 0, against the 1 GiB the window moves).  No atomics, no TF32, and
// every sum in a fixed order, so reruns are bitwise equal.

#include "tile_gemm.cuh"

extern "C" {

const char* qr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Parts the K = m - k of W = V^T A is split into at step k; `w_part` holds
// that many (nb, n - k - nb) partial products when it is more than one.
int qr_splits(int64_t m, int64_t n, int64_t k, int nb) {
  return tile::splits_for(nb, n - k - nb, m - k);
}

// One QR trailing update on the row-major (m, n) matrix `a`, in place.  `v`
// is the row-major (m - k, nb) active block of V (the full V is zero above
// row k), `t` the (nb, nb) T; `w` and
// `y` are scratch of nb * (n - k - nb) floats each, `w_part` of `splits`
// times that (unused when splits is 1).  Launches nothing when
// k + nb = n.  Returns the CUDA error (0 on success).
int qr_panel_update(float* a, int64_t m, int64_t n, const float* v,
                    const float* t, int64_t k, int nb, float* w_part,
                    float* w, float* y, int splits, int device,
                    void* stream) {
  if (nb <= 0 || k < 0 || k + nb > n || n > m || m > (1LL << 30) ||
      splits != qr_splits(m, n, k, nb))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = static_cast<int>(m - k);
  const int cols = static_cast<int>(n - k - nb);
  if (cols == 0) return 0;               // last panel: nothing right of it
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* win = a + k * n + k + nb;        // the trailing window
  // W = V^T A: V^T(i, q) = vk[q * nb + i]
  err = tile::gemm<false>(tile::View{v, 1, nb}, tile::View{win, n, 1}, w,
                          cols, nb, cols, rows, w_part, splits, s);
  if (err) return err;
  // Y = T^T W: T^T(i, q) = t[q * nb + i]
  err = tile::gemm<false>(tile::View{t, 1, nb}, tile::View{w, cols, 1}, y,
                          cols, nb, cols, nb, nullptr, 1, s);
  if (err) return err;
  // A -= V Y over the window
  return tile::gemm<true>(tile::View{v, nb, 1}, tile::View{y, cols, 1}, win,
                          n, rows, cols, nb, nullptr, 1, s);
}

}  // extern "C"
