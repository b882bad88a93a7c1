// Tiled float32 matrix product for Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/gemm.py (matmul): C =
// A B with float32 accumulation.  The TPU kernel runs an (M/bm, N/bn, K/bk)
// grid whose last axis is sequential, carrying the sum in a VMEM scratch
// tile, and needs shapes that tile evenly.  Here a block loops over K itself
// (tile_gemm_sm90.cuh), any M, N, K is taken with the ragged edges masked,
// and the operands are strided views: the unfused QR's V^T and the
// factorizations' trailing blocks are read in place, without a copy.
//
// Bound: 2 M N K flops over (M K + K N + M N) * 4 bytes.  At the unfused LU's
// trailing update (M = N = n - k - 128, K = 128) that is ~60 flops a byte,
// and at the unfused QR's V^T A (M = 128, K = m - k) ~64: above the H100's 20
// flops a byte (67 TFLOP/s float32 outside the tensor cores over 3.35 TB/s),
// so the float32 pipes bound both.  The reference's products are float32,
// so the kernel stays on those pipes: no TF32, no tensor cores.  Design: a
// 128 x 128 tile a block of 256 threads, 8 x 8 outputs a thread read as
// 16-byte fragments, a 3-stage cp.async ring of 32-deep slices staged in
// each operand's own memory layout (tile_gemm_sm90.cuh), and K split across
// the resident blocks when the output has few tiles.

#include "tile_gemm_sm90.cuh"

extern "C" {

const char* gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Parts K is split into for these shapes on the device; the scratch holds
// that many (M, N) partial products when it is more than one.  Returns 0 on
// a CUDA error.
int gemm_splits(int64_t M, int64_t N, int64_t K, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))
    return 0;
  return sm90::splits_for(M, N, K, sms);
}

// C = A B for A(i, q) = a[i * a_rs + q * a_cs], B(q, j) = b[q * b_rs + j *
// b_cs] and the row-major (M, N) c; M, N, K >= 1.  Returns the CUDA error
// (0 on success).
int gemm_matmul(const float* a, int64_t a_rs, int64_t a_cs, const float* b,
                int64_t b_rs, int64_t b_cs, float* c, int64_t M, int64_t N,
                int64_t K, float* scratch, int splits, int device,
                void* stream) {
  const int64_t lim = 1LL << 30;
  if (M > lim || N > lim || K > lim)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  return sm90::gemm(a, a_rs, a_cs, b, b_rs, b_cs, c, N, static_cast<int>(M),
                    static_cast<int>(N), static_cast<int>(K), scratch, splits,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
