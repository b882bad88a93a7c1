// Blocked triangular solve for Hopper (sm_90a) in one persistent launch,
// with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/trsm.py (trsm_lower,
// and trsm_upper / the _auto forms built on it): X with L X = B, where the
// diagonal sub-blocks of L come pre-inverted (Linv), so that
//   X_j = Linv_jj (B_j - sum_{i<j} L_ji X_i).
//
// Bound: the triangle is read once, n^2 / 2 floats, against n^2 m flops; for
// the direct path's few right-hand sides that is well under the H100's 20
// flops per byte, so the memory rate bounds it (0.16 ms for the triangle at
// n = 16384 over 3.35 TB/s).  What stands between a solve and that bound is
// the chain of dependences: X_j needs X_{j-1}, which needs X_{j-2}, ...
//
// Design.  One launch runs the whole substitution left-looking.  Its work
// unit is a block row j of 128 rows (times a slice of 32 columns of B when
// m > 1).  A unit walks i = 0, 1, ..., j - 1 in that order; for each i it
// waits on X_i's ready flag and adds L_ji X_i into float32 registers, then
// forms X_j = Linv_jj (B_j - sum), writes X_j and publishes flag j.  The
// tiles of L and Linv_jj do not depend on the flags, so they stream through
// an 8-chunk cp.async ring in shared memory ahead of the waits: when X_{j-1}
// arrives, L_{j,j-1} and Linv_jj are already on chip, and only the flag's
// round trip, one 128 x 128 product with L_{j,j-1} and one with Linv_jj
// stay on the chain.  Each output sums in a fixed order (ascending i, a
// fixed order inside a tile), so reruns are bitwise equal.
//
// Units are handed out in increasing j (then column slice) by an atomic
// ticket, and a CTA takes a ticket only while it runs, so a unit waits only
// on units that running CTAs hold: no deadlock, however many units there
// are beyond the resident CTAs.  The flags and the ticket live in a
// per-call workspace (zeroed by the wrapper); there is no static state.
// Memory order: each writer stores its part of X_j and __threadfence()s,
// the block synchronizes, and one thread stores the flag with release
// semantics; the reader's spin is an acquire load, and X is read through
// L2 (ld.global.cg), never through the non-coherent path.
//
// Upper and transposed triangles are solved by index arithmetic, not by a
// flipped or transposed copy: logical row p is physical row n - 1 - p when
// `rev` is set (U x = b is (J U J)(J x) = J b with J the reversal), and
// `trans` reads the stored matrix transposed (Cholesky's L^T x = y).  The
// products with L run in the physical frame (a tile and the X rows it meets
// keep their memory order), the product with Linv in the logical one.  Each
// tile is staged in the layout of its memory, so the copies are 16 bytes
// wide in every mode (4 bytes where n is not a multiple of 4 or the matrix
// not 16-byte aligned).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSB = 128;            // block rows (the diagonal blocks' size)
constexpr int kKC = 32;             // depth of one staged chunk of a tile
constexpr int kChunks = kSB / kKC;  // chunks a tile
constexpr int kStages = 8;          // ring depth: a whole tile plus Linv
constexpr int kThreads = 256;
constexpr int kWide = 32;           // columns of B a unit owns when m > 1
// A chunk contiguous along its depth (row-major L, and Linv) is held as 128
// rows of 32 floats padded to 40; one contiguous along its rows (L read
// transposed) as 32 rows of 128 padded to 144.  The pads keep the products'
// shared reads free of bank conflicts and the rows 16-byte aligned.
constexpr int kRowPitch = 40;
constexpr int kColPitch = 144;
constexpr int kSlot = kSB * kRowPitch;  // floats a ring slot
static_assert(kKC * kColPitch <= kSlot, "a transposed chunk fits a slot");

// The stored (n, n) row-major matrix (row stride ld) and how it is read.
struct Tri {
  const float* t;
  int64_t ld;
  int n, rev, trans, vec;
  // first physical row (and column) of logical block k; the 128 rows of
  // the block are base .. base + 127, those outside [0, n) absent
  __device__ __forceinline__ int base(int k) const {
    return rev ? n - kSB * (k + 1) : kSB * k;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared, the bytes past `bytes` zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void wait_flag(const int* f) {
  int v;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(v) : "l"(f) : "memory");
  } while (v == 0);
}

__device__ __forceinline__ void publish_flag(int* f) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n"
               :: "l"(f), "r"(1) : "memory");
}

// Stage chunk kq (depth 32 kq .. 32 kq + 31) of L's tile (block row j,
// block column i < j), physical frame, into the slot s.
template <bool kTrans>
__device__ __forceinline__ void stage_l(float* s, const Tri& tri, int j,
                                        int i, int kq) {
  const int n = tri.n, tid = threadIdx.x;
  const int rb = tri.base(j), cb = tri.base(i) + kq * kKC;
  if (tri.vec) {
#pragma unroll
    for (int u = 0; u < kSB * kKC / 4 / kThreads; ++u) {
      const int e = tid + u * kThreads;
      if constexpr (!kTrans) {        // row rb + r, columns cb + 4f ..
        const int r = e >> 3, f = e & 7;
        const bool ok = rb + r >= 0 && rb + r < n;
        const float* src = ok ? tri.t + (rb + r) * tri.ld + cb + 4 * f
                              : tri.t;
        cp_async16(smem_addr(s + r * kRowPitch + 4 * f), src, ok ? 16 : 0);
      } else {                        // stored row cb + q, columns rb + 4f ..
        const int q = e >> 5, f = e & 31;
        const bool ok = rb + 4 * f >= 0 && rb + 4 * f < n;
        const float* src = ok ? tri.t + (cb + q) * tri.ld + rb + 4 * f
                              : tri.t;
        cp_async16(smem_addr(s + q * kColPitch + 4 * f), src, ok ? 16 : 0);
      }
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < kSB * kKC / kThreads; ++u) {
      const int e = tid + u * kThreads;
      if constexpr (!kTrans) {
        const int r = e >> 5, q = e & 31;
        const bool ok = rb + r >= 0 && rb + r < n;
        const float* src = ok ? tri.t + (rb + r) * tri.ld + cb + q : tri.t;
        cp_async4(smem_addr(s + r * kRowPitch + q), src, ok ? 4 : 0);
      } else {
        const int q = e >> 7, r = e & 127;
        const bool ok = rb + r >= 0 && rb + r < n;
        const float* src = ok ? tri.t + (cb + q) * tri.ld + rb + r : tri.t;
        cp_async4(smem_addr(s + q * kColPitch + r), src, ok ? 4 : 0);
      }
    }
  }
}

// Stage chunk kq of the (128, 128) row-major block `inv` into slot s.
__device__ __forceinline__ void stage_inv(float* s, const float* inv,
                                          int kq) {
#pragma unroll
  for (int u = 0; u < kSB * kKC / 4 / kThreads; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int r = e >> 3, f = e & 7;
    cp_async16(smem_addr(s + r * kRowPitch + 4 * f),
               inv + r * kSB + kq * kKC + 4 * f, 16);
  }
}

// acc += (one staged chunk) x (its 32 rows of v).
//
// kMC = 1: thread (r, h) = (tid / 2, tid % 2) owns output row r and half h
// of the chunk's depth (float4 steps h, h + 2, ... of a row-major chunk;
// depths h, h + 2, ... of a transposed one); the two halves, neighbouring
// lanes, are added by fold1.  v is a vector.
// kMC = kWide: thread (g, c) owns rows 4g .. 4g + 3 and columns 4c .. 4c + 3
// over the whole depth; v is (32, kWide) row-major.
template <int kMC, bool kTrans>
__device__ __forceinline__ void chunk_product(const float* s, const float* v,
                                              float (&acc)[kMC == 1 ? 1 : 16]) {
  const int tid = threadIdx.x;
  if constexpr (kMC == 1) {
    const int r = tid >> 1, h = tid & 1;
    if constexpr (!kTrans) {
#pragma unroll
      for (int u = 0; u < kKC / 8; ++u) {
        const int q = 4 * (2 * u + h);
        const float4 a = *reinterpret_cast<const float4*>(s + r * kRowPitch +
                                                          q);
        const float4 x = *reinterpret_cast<const float4*>(v + q);
        acc[0] = fmaf(a.x, x.x, acc[0]);
        acc[0] = fmaf(a.y, x.y, acc[0]);
        acc[0] = fmaf(a.z, x.z, acc[0]);
        acc[0] = fmaf(a.w, x.w, acc[0]);
      }
    } else {
#pragma unroll
      for (int q = h; q < kKC; q += 2)
        acc[0] = fmaf(s[q * kColPitch + r], v[q], acc[0]);
    }
  } else {
    const int g = tid >> 3, c = tid & 7;
#pragma unroll
    for (int q4 = 0; q4 < kKC / 4; ++q4) {
      float a[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 t4 = *reinterpret_cast<const float4*>(
            kTrans ? s + (4 * q4 + r) * kColPitch + 4 * g
                   : s + (4 * g + r) * kRowPitch + 4 * q4);
        // a[row][depth]: row-major chunks give a row's 4 depths, transposed
        // ones a depth's 4 rows
        a[kTrans ? 0 : r][kTrans ? r : 0] = t4.x;
        a[kTrans ? 1 : r][kTrans ? r : 1] = t4.y;
        a[kTrans ? 2 : r][kTrans ? r : 2] = t4.z;
        a[kTrans ? 3 : r][kTrans ? r : 3] = t4.w;
      }
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const float4 x = *reinterpret_cast<const float4*>(
            v + (4 * q4 + d) * kWide + 4 * c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[4 * r + 0] = fmaf(a[r][d], x.x, acc[4 * r + 0]);
          acc[4 * r + 1] = fmaf(a[r][d], x.y, acc[4 * r + 1]);
          acc[4 * r + 2] = fmaf(a[r][d], x.z, acc[4 * r + 2]);
          acc[4 * r + 3] = fmaf(a[r][d], x.w, acc[4 * r + 3]);
        }
      }
    }
  }
}

// kMC = 1: the sum of the two halves of row tid / 2 (in both lanes; the
// addition is commutative, so they agree bitwise).
__device__ __forceinline__ float fold1(float part) {
  return part + __shfl_xor_sync(0xffffffffu, part, 1);
}

template <int kMC, bool kTrans>
__global__ void __launch_bounds__(kThreads, 1)
blocked_substitution_kernel(Tri tri, const float* __restrict__ linv,
                            const float* __restrict__ b, float* x, int m,
                            int* work) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* xs = ring + kStages * kSlot;        // X_i, two buffers
  float* ws = xs + 2 * kSB * kMC;            // B_j - sum, logical order
  int* ticket = reinterpret_cast<int*>(ws + kSB * kMC);
  constexpr int kAcc = kMC == 1 ? 1 : 16;
  const int tid = threadIdx.x, n = tri.n;
  const int nblk = (n + kSB - 1) / kSB;
  const int ns = (m + kMC - 1) / kMC;
  int* flags = work + 1;                     // work[0] is the ticket
  // this thread's output rows (of the block, physical frame for L's
  // products, logical for Linv's): kMC = 1, row tid / 2 (its half tid % 2);
  // kMC = kWide, rows 4g .. 4g + 3 and columns 4c .. 4c + 3
  const int r1 = tid >> 1;
  const int g = tid >> 3, c4 = 4 * (tid & 7);

  for (;;) {
    if (tid == 0) *ticket = atomicAdd(work, 1);
    __syncthreads();
    const int u = *ticket;
    if (u >= nblk * ns) break;
    const int j = u / ns, col0 = (u % ns) * kMC;
    const int* ready = flags + col0 / kMC;   // flag of block row i: i * ns
    const int rb = tri.base(j);
    const int nl = kChunks * j;              // chunks of L; Linv's follow

    // this thread's entries of B_j (physical rows), read ahead of the chain
    float bv[kAcc];
    if constexpr (kMC == 1) {
      const bool ok = rb + r1 >= 0 && rb + r1 < n;
      bv[0] = ok ? b[rb + r1] : 0.f;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int row = rb + 4 * g + r, col = col0 + c4 + cc;
          const bool ok = row >= 0 && row < n && col < m;
          bv[4 * r + cc] = ok ? b[static_cast<int64_t>(row) * m + col] : 0.f;
        }
    }

    auto stage = [&](int ch) {
      float* s = ring + (ch % kStages) * kSlot;
      if (ch < nl) stage_l<kTrans>(s, tri, j, ch / kChunks, ch % kChunks);
      else stage_inv(s, linv + static_cast<int64_t>(j) * kSB * kSB, ch - nl);
    };
#pragma unroll 1
    for (int ch = 0; ch < kStages - 1; ++ch) {
      if (ch < nl + kChunks) stage(ch);
      cp_async_commit();
    }

    float acc[kAcc];
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;
    // sum_{i<j} L_ji X_i, one chunk a step
#pragma unroll 1
    for (int ch = 0; ch < nl; ++ch) {
      const int i = ch / kChunks, kq = ch % kChunks;
      float* xi = xs + (i & 1) * kSB * kMC;
      cp_async_wait<kStages - 2>();
      if (kq == 0) {                         // X_i: wait for it, then fetch
        const int xb = tri.base(i);
        if constexpr (kMC == 1) {            // one warp spins and fetches
          if (tid < 32) {
            if (tid == 0) wait_flag(ready + i * ns);
            __syncwarp();
#pragma unroll
            for (int e = tid; e < kSB; e += 32) xi[e] = __ldcg(x + xb + e);
          }
        } else {
          if (tid == 0) wait_flag(ready + i * ns);
          __syncthreads();
#pragma unroll
          for (int e = tid; e < kSB * kWide; e += kThreads) {
            const int row = e / kWide, col = col0 + e % kWide;
            xi[e] = col < m
                ? __ldcg(x + static_cast<int64_t>(xb + row) * m + col)
                : 0.f;
          }
        }
      }
      __syncthreads();       // chunk ch and X_i visible; a slot free
      if (ch + kStages - 1 < nl + kChunks) stage(ch + kStages - 1);
      cp_async_commit();
      chunk_product<kMC, kTrans>(ring + (ch % kStages) * kSlot,
                                 xi + kq * kKC * kMC, acc);
    }

    // ws = B_j - sum in logical order (block row l is physical index
    // 127 - l when rev), then X_j = Linv_jj ws from the landed chunks
    cp_async_wait<0>();
    if constexpr (kMC == 1) {
      const float sum = fold1(acc[0]);
      if ((tid & 1) == 0) ws[tri.rev ? kSB - 1 - r1 : r1] = bv[0] - sum;
      acc[0] = 0.f;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = tri.rev ? kSB - 1 - (4 * g + r) : 4 * g + r;
        *reinterpret_cast<float4*>(ws + row * kWide + c4) = float4{
            bv[4 * r] - acc[4 * r], bv[4 * r + 1] - acc[4 * r + 1],
            bv[4 * r + 2] - acc[4 * r + 2], bv[4 * r + 3] - acc[4 * r + 3]};
      }
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int kq = 0; kq < kChunks; ++kq)
      chunk_product<kMC, false>(ring + ((nl + kq) % kStages) * kSlot,
                                ws + kq * kKC * kMC, acc);

    if constexpr (kMC == 1) {
      const float sum = fold1(acc[0]);
      const int row = rb + (tri.rev ? kSB - 1 - r1 : r1);
      if ((tid & 1) == 0 && row >= 0 && row < n) x[row] = sum;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = 4 * g + r;
        const int row = rb + (tri.rev ? kSB - 1 - l : l);
        if (row < 0 || row >= n) continue;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          if (col0 + c4 + cc < m)
            x[static_cast<int64_t>(row) * m + col0 + c4 + cc] =
                acc[4 * r + cc];
      }
    }
    __threadfence();
    __syncthreads();         // also: every read of the ring and ws is done
    if (tid == 0) publish_flag(flags + j * ns + col0 / kMC);
  }
}

template <int kMC>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kStages * kSlot + 3 * kSB * kMC) + 16;
}

template <int kMC, bool kTrans>
int launch(const Tri& tri, const float* linv, const float* b, float* x,
           int m, int* work, cudaStream_t s) {
  auto kernel = blocked_substitution_kernel<kMC, kTrans>;
  constexpr size_t smem = smem_bytes<kMC>();
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = static_cast<int>(cudaGetDevice(&device));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device));
  if (!err) err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem));
  if (err) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t units = static_cast<int64_t>((tri.n + kSB - 1) / kSB) *
                        ((m + kMC - 1) / kMC);
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const int grid = static_cast<int>(units < resident ? units : resident);
  kernel<<<grid, kThreads, smem, s>>>(tri, linv, b, x, m, work);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int trsm_block_rows() { return kSB; }

// ints of the workspace a solve of n rows and m columns needs: the ticket
// and one ready flag a unit; the caller zeroes it
int64_t trsm_workspace_ints(int n, int m) {
  const int mc = m == 1 ? 1 : kWide;
  return 1 + static_cast<int64_t>((n + kSB - 1) / kSB) * ((m + mc - 1) / mc);
}

const char* trsm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Solve L' X = B for the logical lower triangle L' of the stored (n, n)
// row-major matrix t (row stride ld), flags rev / trans as above.  linv
// holds ceil(n / 128) inverted (128, 128) diagonal blocks of L' (the last
// one identity-padded); b holds B (n, m) row-major and is only read; x
// receives X; work holds trsm_workspace_ints(n, m) zeroed ints.  Returns
// the CUDA error (0 on success).
int trsm_solve(const float* t, int64_t ld, int n, int rev, int trans,
               const float* linv, const float* b, float* x, int m, int* work,
               int device, void* stream) {
  if (n <= 0 || m <= 0 || ld < n || trsm_workspace_ints(n, m) > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);   // tickets are ints
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  const int vec = reinterpret_cast<uintptr_t>(t) % 16 == 0 && ld % 4 == 0 &&
                  n % 4 == 0;
  const Tri tri{t, ld, n, rev, trans, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 1)
    return trans ? launch<1, true>(tri, linv, b, x, m, work, s)
                 : launch<1, false>(tri, linv, b, x, m, work, s);
  return trans ? launch<kWide, true>(tri, linv, b, x, m, work, s)
               : launch<kWide, false>(tri, linv, b, x, m, work, s);
}

}  // extern "C"
