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
// So the update is two products on the multistage float32 mainloop of
// tile_gemm_sm90.cuh, each over the active window only (k is a host
// integer, V is zero above row k), with Y = T^T W folded between them:
//   1. W = V^T A, (nb x R)(R x N): few output tiles and a long K, so K is
//      split into as many parts as the card's resident blocks allow (from
//      its SM count), each block summing its (part, column tile) into a
//      partial W in the workspace;
//   2. the fold: one block a (128 x 16) tile of Y sums its 16 columns of W
//      over the parts in the order 0, 1, ... into shared memory (eight
//      parts in flight a thread), and applies T^T, staged 32 depths at a
//      time, in ascending depth: W never exists whole, and no launch sums
//      it alone;
//   3. A -= V Y, (R x nb)(nb x N), in place: the mainloop's subtracting
//      epilogue on the window (row stride n; 16-byte read-modify-write
//      where n and the window's base allow, 4-byte accesses otherwise), one
//      block per 128 x 128 tile (16,128 tiles at k = 0).  Its K = nb is not
//      split at nb = 128; where the tiles are few and nb deep (nb >= 1024),
//      it is, and the parts are subtracted in order by a second launch.
// No atomics, no TF32, no tensor cores, and every sum in a fixed order, so
// reruns are bitwise equal.

#include "tile_gemm_sm90.cuh"

namespace {

constexpr int kFoldRows = 128;    // rows of Y a fold block, 2 a thread
constexpr int kFoldCols = 16;     // columns of Y a fold block, 4 a thread
constexpr int kFoldDepth = 128;   // depths of W summed at a time
constexpr int kFoldTDepth = 32;   // depths of T staged at a time
constexpr int kFoldThreads = 256;
constexpr int kFoldBatch = 8;     // parts of W a thread loads at once

// Four columns j .. j + 3 of a row of W's part (zeros past N): one 16-byte
// load where N is a multiple of 4 and the workspace 16-byte aligned.
__device__ __forceinline__ float4 load_cols(const float* p, int left,
                                            int vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  float4 x = make_float4(p[0], 0.f, 0.f, 0.f);
  if (left > 1) x.y = p[1];
  if (left > 2) x.z = p[2];
  if (left > 3) x.w = p[3];
  return x;
}

__device__ __forceinline__ void add4(float4& w, const float4& x) {
  w.x += x.x;
  w.y += x.y;
  w.z += x.z;
  w.w += x.w;
}

// Y[i, j] = the sum over q = 0, 1, ..., nb - 1, in that order, of
// T[q, i] W[q, j], with W[q, j] = the sum over z = 0, 1, ..., nz - 1, in
// that order, of part[z * zs + q * N + j].  A block sums 128 depths of its
// 16 columns of W into shared memory (each thread two groups of four
// columns, its loads of kFoldBatch parts issued before it adds them), then
// stages T 32 depths at a time and multiplies: each thread 2 rows x 4
// columns of Y.
__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const float* __restrict__ part, int nz, int64_t zs,
            const float* __restrict__ t, int nb, int N, int vec,
            float* __restrict__ y) {
  __shared__ __align__(16) float ws[kFoldDepth][kFoldCols];
  __shared__ float ts[kFoldTDepth][kFoldRows];
  const int tid = threadIdx.x;
  const int tx = tid & 3, ty = tid >> 2;
  const int i0 = blockIdx.y * kFoldRows, j0 = blockIdx.x * kFoldCols;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int q0 = 0; q0 < nb; q0 += kFoldDepth) {
    // W's 128 x 16 block: thread elements e = tid, tid + 256 of 512
    const float* p[2];
    bool ok[2];
    float4 w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = tid + h * kFoldThreads;
      const int q = q0 + (e >> 2), j = j0 + 4 * (e & 3);
      ok[h] = q < nb && j < N;
      p[h] = part + static_cast<int64_t>(q) * N + j;
      w[h] = ok[h] ? load_cols(p[h], N - j, vec)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int z0 = 1; z0 < nz; z0 += kFoldBatch) {
      float4 x[kFoldBatch][2];
#pragma unroll
      for (int u = 0; u < kFoldBatch; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (ok[h] && z0 + u < nz)
            x[u][h] = load_cols(p[h] + (z0 + u) * zs,
                                N - j0 - 4 * ((tid + h * kFoldThreads) & 3),
                                vec);
#pragma unroll
      for (int u = 0; u < kFoldBatch; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (ok[h] && z0 + u < nz) add4(w[h], x[u][h]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = tid + h * kFoldThreads;
      *reinterpret_cast<float4*>(&ws[e >> 2][4 * (e & 3)]) = w[h];
    }
    const int depth = min(kFoldDepth, nb - q0);
    for (int c0 = 0; c0 < depth; c0 += kFoldTDepth) {
      __syncthreads();   // ws written; the last chunk of T read
#pragma unroll
      for (int u = 0; u < kFoldTDepth * kFoldRows / kFoldThreads; ++u) {
        const int e = tid + u * kFoldThreads;
        const int q = q0 + c0 + e / kFoldRows, i = i0 + e % kFoldRows;
        ts[e / kFoldRows][e % kFoldRows] =
            q < nb && i < nb ? t[static_cast<int64_t>(q) * nb + i] : 0.f;
      }
      __syncthreads();
      const int steps = min(kFoldTDepth, depth - c0);
#pragma unroll 8
      for (int dq = 0; dq < steps; ++dq) {
        const float a0 = ts[dq][ty], a1 = ts[dq][ty + 64];
        const float4 b =
            *reinterpret_cast<const float4*>(&ws[c0 + dq][4 * tx]);
        acc[0][0] = fmaf(a0, b.x, acc[0][0]);
        acc[0][1] = fmaf(a0, b.y, acc[0][1]);
        acc[0][2] = fmaf(a0, b.z, acc[0][2]);
        acc[0][3] = fmaf(a0, b.w, acc[0][3]);
        acc[1][0] = fmaf(a1, b.x, acc[1][0]);
        acc[1][1] = fmaf(a1, b.y, acc[1][1]);
        acc[1][2] = fmaf(a1, b.z, acc[1][2]);
        acc[1][3] = fmaf(a1, b.w, acc[1][3]);
      }
    }
    __syncthreads();     // ws and ts read before the next depths
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + ty + 64 * r;
    if (i >= nb) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + 4 * tx + e;
      if (j < N) y[static_cast<int64_t>(i) * N + j] = acc[r][e];
    }
  }
}

int64_t round4(int64_t x) { return (x + 3) / 4 * 4; }

// The launches of one update at step k on `device`: the splits of W's and
// the update's K, and where Y and the update's parts sit in the workspace.
struct Plan {
  int rows, cols;          // R = m - k, N = n - k - nb
  int w_nz, w_kc;          // W's parts and their depth
  int u_splits;
  int64_t y_at, u_at, floats;
};

int make_plan(int64_t m, int64_t n, int64_t k, int nb, int device,
              Plan& p) {
  if (nb <= 0 || k < 0 || k + nb > n || n > m || m > (1LL << 30) ||
      (m - k + sm90::kBM - 1) / sm90::kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  int err = static_cast<int>(cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device));
  if (err) return err;
  p.rows = static_cast<int>(m - k);
  p.cols = static_cast<int>(n - k - nb);
  p.floats = 0;
  if (p.cols == 0) return 0;             // last panel: nothing right of it
  p.w_kc = sm90::split_depth(
      p.rows, sm90::splits_for(nb, p.cols, p.rows, sms), p.w_nz);
  p.u_splits = sm90::splits_for(p.rows, p.cols, nb, sms);
  int u_nz;
  sm90::split_depth(nb, p.u_splits, u_nz);
  const int64_t wn = static_cast<int64_t>(nb) * p.cols;
  p.y_at = round4(p.w_nz * wn);
  p.u_at = round4(p.y_at + wn);
  p.floats = p.u_at +
             (u_nz > 1 ? u_nz * static_cast<int64_t>(p.rows) * p.cols : 0);
  return 0;
}

}  // namespace

extern "C" {

const char* qr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Floats of workspace one update at step k needs on `device` (0 at the last
// step), or -1 for arguments the kernel does not take or a CUDA error.
int64_t qr_workspace_floats(int64_t m, int64_t n, int64_t k, int nb,
                            int device) {
  Plan p;
  return make_plan(m, n, k, nb, device, p) ? -1 : p.floats;
}

// The parts of one update at step k on `device` that hold any sum: W's
// (split over R = m - k) into `w_parts`, the update's (split over nb) into
// `u_parts`; both 0 at the last step.  Returns the CUDA error (0 on
// success).
int qr_plan_parts(int64_t m, int64_t n, int64_t k, int nb, int device,
                  int* w_parts, int* u_parts) {
  Plan p;
  const int err = make_plan(m, n, k, nb, device, p);
  if (err) return err;
  *w_parts = *u_parts = 0;
  if (p.cols == 0) return 0;
  *w_parts = p.w_nz;
  sm90::split_depth(nb, p.u_splits, *u_parts);
  return 0;
}

// One QR trailing update on the row-major (m, n) matrix `a`, in place.  `v`
// is the row-major (m - k, nb) active block of V (the full V is zero above
// row k), `t` the (nb, nb) T; `ws` is a workspace of `ws_floats` floats,
// 16-byte aligned, as qr_workspace_floats gives them.  Launches nothing
// when k + nb = n.  Returns the CUDA error (0 on success).
int qr_panel_update(float* a, int64_t m, int64_t n, const float* v,
                    const float* t, int64_t k, int nb, float* ws,
                    int64_t ws_floats, int device, void* stream) {
  Plan p;
  int err = make_plan(m, n, k, nb, device, p);
  if (err) return err;
  if (ws_floats != p.floats || (p.floats && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.cols == 0) return 0;
  err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* win = a + k * n + k + nb;        // the trailing window
  float* y = ws + p.y_at;
  const int64_t wn = static_cast<int64_t>(nb) * p.cols;
  // 1. W's parts: V^T(i, q) = v[q * nb + i], A^T(j, q) = win[q * n + j]
  err = sm90::launch<false, false>(
      sm90::mn_operand(v, nb, nb), sm90::mn_operand(win, n, p.cols), ws,
      p.cols, wn, p.rows, p.w_kc, p.w_nz, sm90::vec_out(ws, p.cols), s);
  if (err) return err;
  // 2. Y = T^T (the ordered sum of W's parts)
  const dim3 grid((p.cols + kFoldCols - 1) / kFoldCols,
                  (nb + kFoldRows - 1) / kFoldRows);
  fold_kernel<<<grid, kFoldThreads, 0, s>>>(ws, p.w_nz, wn, t, nb, p.cols,
                                            sm90::vec_out(ws, p.cols), y);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  // 3. A -= V Y over the window: V(i, q) = v[i * nb + q], Y^T(j, q) =
  // y[q * N + j]
  return sm90::product<true, false, true>(
      sm90::k_operand(v, nb, p.rows), sm90::mn_operand(y, p.cols, p.cols),
      win, n, nb, ws + p.u_at, p.u_splits, s);
}

}  // extern "C"
