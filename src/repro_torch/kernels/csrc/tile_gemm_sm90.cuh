// The float32 GEMM mainloop of the port's dense products on Hopper: gemm.cu
// (kernel 7, src/repro/kernels/gemm.py matmul), qr_fused.cu (kernel 9,
// qr_fused.py qr_panel_update) and factor_fused.cu (kernels 4 and 5,
// factor_fused.py lu_panel_update and cholesky_panel_update).  C = A B, or
// C -= A B in place, on strided views, for any M, N, K, in full float32 on
// the float32 pipes (no TF32, no tensor cores), with a split of K that stays
// deterministic; and C -= A A^T on the lower tiles only, mirrored.
//
// Bound: a product of depth K does 2 K flops an output; with K = 128 (the
// panel updates, kernel 9's A -= V Y) and the output read and written once
// that is ~32 flops a byte, above the H100's 20 (67 TFLOP/s float32 outside
// the tensor cores over 3.35 TB/s): the float32 pipes bound it, and the
// design keeps them fed.  The symmetric update does half the flops over the
// same bytes (~16 a byte): there the bytes bound it.
//
// A block of 256 threads owns a 128 x 128 tile of C; each thread 8 x 8 of
// it, as 2 x 2 fragments of 4 x 4 (rows 4ty .. 4ty + 3 and 64 + the same,
// columns 4tx .. and 64 + ..), so that a step of depth reads its operands
// with 16-byte shared loads: 4 LDS.128 for 64 FFMA.  The block walks its
// range of K in slices of 32 through a 3-stage cp.async ring (32 KB a
// stage, two blocks an SM), one barrier a slice.
//
// Both operands are held as an (MN x K) matrix: A(i, q), and B read as
// B^T(j, q).  Each is staged in the layout of its memory, chosen per launch
// by which of its indices is contiguous (a template argument):
//   MN-major (contiguous along i or j: QR's V^T read in place, B row-major)
//     S[q][i], rows of 128 floats; a step loads its 4 values as float4;
//   K-major (contiguous along q: a row-major block of A, a transposed B)
//     S[i][q], rows of 32 floats whose 16-byte chunks are XOR-swizzled by
//     (i / 4) mod 8, so that the 8 threads of a quarter-warp reading 8
//     different rows at one depth hit 8 different bank groups; a thread
//     loads 4 depths of one row as a float4.
// Either way the global copies are 16 bytes wide.  An operand whose base
// is not 16-byte aligned, whose other stride is not a multiple of 4, or
// which has no unit stride, is copied 4 bytes at a time by the same kernel;
// ragged edges are zero-filled by the copies' source size.
//
// The epilogue writes C = acc into a new matrix, or (kSub) C -= acc into a
// window of a larger one: a row stride ldc, read and written in place.  A
// thread's four columns of a fragment row move as one 16-byte access where
// ldc is a multiple of 4 and C's base is 16-byte aligned, else (and at a
// ragged right edge) 4 bytes at a time; the subtracting epilogue loads a
// half of its rows (4 x 2 float4) before it stores any.
//
// The symmetric update (kSym, Cholesky's A22 -= L21 L21^T) launches one
// block for each of the T (T + 1) / 2 tiles on and below the diagonal of
// T x T tiles, each block finding its tile (i, j), i >= j, from its index.
// It runs the same mainloop with A = B = the K-major L21, subtracts its
// product P from tile (i, j) and, for i > j, P^T from tile (j, i), staged
// transposed through the (then idle) ring so that the mirror's reads and
// writes stay 16 bytes wide along rows; a diagonal tile is computed whole.
// Tile (j, i)'s own C is read, so C need not be symmetric.  The mirror is
// bitwise what the full product would write there: element (j, i) of
// L21 L21^T is the sum over ascending q of fmaf(L[j, q], L[i, q], acc), and
// fmaf(a, b, c) = fmaf(b, a, c), so it equals P^T's element; a symmetric C
// stays bitwise symmetric.  Only factor_fused.cu instantiates it (its
// launcher lives there): a kernel that code in this header instantiated
// would be emitted by gemm.cu and qr_fused.cu too, and their own kernels
// then compile to other code.
//
// The sums run in a fixed order (ascending q within a split), without
// atomics, so reruns are bitwise equal.  Few output tiles with a long K
// (QR's V^T A: 63 tiles at n = 8192) would leave the card idle, so K is
// split into as many parts as the resident blocks allow: split z writes a
// partial tile to a scratch buffer, and a second launch adds the partials
// in the order z = 0, 1, ... into C (=, or -= for kSub).
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace sm90 {

constexpr int kBM = 128;            // output tile rows (and columns)
constexpr int kBK = 32;             // depth of one staged slice
constexpr int kStages = 3;
constexpr int kThreads = 256;       // 16 x 16 threads, 8 x 8 outputs each
constexpr int kBlocksPerSM = 2;
constexpr int kOperand = kBM * kBK; // floats of one operand's slice
constexpr int kMinSplitDepth = 512; // least K a split keeps
constexpr int kSumThreads = 256;
constexpr size_t kSmemBytes = sizeof(float) * kStages * 2 * kOperand;
static_assert(kBM * kBM <= kStages * 2 * kOperand,
              "the symmetric update stages a whole tile in the ring");

// One operand as an (MN x K) matrix: element (r, q) at p[r * ms + q * ks];
// vec: copyable 16 bytes at a time in its layout.
struct Operand {
  const float* p;
  int64_t ms, ks;
  int rows, vec;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// The swizzled float offset of (row r, depth q) in a K-major slice.
__device__ __forceinline__ int kmajor_at(int r, int q) {
  return r * kBK + 4 * ((q >> 2) ^ ((r >> 2) & 7)) + (q & 3);
}

// Starts the copies of one operand's slices.  It keeps only the thread's
// first source (slice 0); the shared offsets, the thread's place in the
// slice and the strides are recomputed from threadIdx and the kernel's
// parameters at each slice, which leaves the mainloop's registers to the
// fragments.  A copy then costs one pointer add.
//   16-byte copies (4 a thread): K-major, rows tid / 8 + 32u at depths
//   4 (tid % 8); MN-major, depths tid / 32 + 8u at rows 4 (tid % 32).
//   4-byte copies (16 a thread): K-major, rows tid / 32 + 8u at depth
//   tid % 32; MN-major, depths tid / 128 + 2u at row tid % 128.
template <bool kKMajor>
struct Loader {
  const float* src;   // this thread's first copy of slice 0

  __device__ __forceinline__ static int lane_r(int vec) {
    const int tid = threadIdx.x;
    return vec ? (kKMajor ? tid >> 3 : 4 * (tid & 31))
               : (kKMajor ? tid >> 5 : tid & 127);
  }
  __device__ __forceinline__ static int lane_q(int vec) {
    const int tid = threadIdx.x;
    return vec ? (kKMajor ? 4 * (tid & 7) : tid >> 5)
               : (kKMajor ? tid & 31 : tid >> 7);
  }

  __device__ __forceinline__ Loader(const Operand& op, int r0, int q_lo)
      : src(op.p + static_cast<int64_t>(r0 + lane_r(op.vec)) * op.ms +
            static_cast<int64_t>(q_lo + lane_q(op.vec)) * op.ks) {}

  // Copy slice `sl` (depths q0 .. q0 + 31 of a split ending at q_hi) of
  // the operand's rows r0 .. r0 + 127 into s; what lies past the operand's
  // rows or the split is zero-filled.
  __device__ __forceinline__ void copy(const Operand& op, float* s, int r0,
                                       int sl, int q0, int q_hi) const {
    const float* p = src + sl * (kBK * op.ks);
    const uint32_t base = smem_addr(s);
    const int lr = lane_r(op.vec), lq = lane_q(op.vec);
    const int rows_rem = op.rows - r0 - lr;  // rows from this copy's on
    const int q_left = q_hi - q0 - lq;       // depths from this copy's on
    if (op.vec) {
      const int dst = kKMajor ? kmajor_at(lr, lq) : 4 * threadIdx.x;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int bytes;
        uint32_t d;
        const float* from;
        if (kKMajor) {   // +32 rows keeps the swizzle
          bytes = 32 * u < rows_rem ? 4 * max(0, min(4, q_left)) : 0;
          d = base + 4 * (dst + 32 * u * kBK);
          from = p + u * (32 * op.ms);
        } else {
          bytes = 8 * u < q_left ? 4 * max(0, min(4, rows_rem)) : 0;
          d = base + 4 * (dst + 8 * u * kBM);
          from = p + u * (8 * op.ks);
        }
        cp_async16(d, bytes ? from : op.p, bytes);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        bool ok;
        uint32_t d;
        const float* from;
        if (kKMajor) {
          ok = 8 * u < rows_rem && q_left > 0;
          d = base + 4 * kmajor_at(lr + 8 * u, lq);
          from = p + u * (8 * op.ms);
        } else {
          ok = 2 * u < q_left && rows_rem > 0;
          d = base + 4 * (threadIdx.x + 2 * u * kBM);
          from = p + u * (2 * op.ks);
        }
        cp_async4(d, ok ? from : op.p, ok ? 4 : 0);
      }
    }
  }
};

// The 8 values (rows 4t .. 4t + 3, 64 + 4t .. 64 + 4t + 3 of the tile) of
// an MN-major slice at depth q.
__device__ __forceinline__ void mn_frag(const float* s, int q, int t,
                                        float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(s + q * kBM + 4 * t);
  const float4 hi = *reinterpret_cast<const float4*>(s + q * kBM + 64 +
                                                     4 * t);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// Depths 4 qc .. 4 qc + 3 of row i (i = 4t + e or 64 + 4t + e) of a K-major
// slice; the swizzle of those rows is t mod 8.
__device__ __forceinline__ float4 k_frag(const float* s, int i, int qc,
                                         int t) {
  return *reinterpret_cast<const float4*>(s + i * kBK +
                                          4 * (qc ^ (t & 7)));
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ int frag_row(int t, int e) {
  return e < 4 ? 4 * t + e : 64 + 4 * t + (e - 4);
}

// acc[r][c] += sum over the slice's 32 depths of A(r) B(c), in depth order.
// A K-major operand gives 4 depths of a row a load, so its fragment is
// loaded 4 depths at a time.
template <bool kAK, bool kBKm>
__device__ __forceinline__ void slice_product(const float* as,
                                              const float* bs,
                                              float (&acc)[8][8], int tx,
                                              int ty) {
#pragma unroll
  for (int qc = 0; qc < kBK / 4; ++qc) {
    float4 ak[8];
    if constexpr (kAK) {
#pragma unroll
      for (int e = 0; e < 8; ++e) ak[e] = k_frag(as, frag_row(ty, e), qc, ty);
    }
    if constexpr (kAK && kBKm) {
      // both K-major: B a half (4 columns) at a time keeps 48 values live
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float4 bk[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bk[e] = k_frag(bs, frag_row(tx, 4 * half + e), qc, tx);
#pragma unroll
        for (int d = 0; d < 4; ++d)
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][4 * half + c] = fmaf(comp(ak[r], d), comp(bk[c], d),
                                          acc[r][4 * half + c]);
      }
    } else {
      float4 bk[8];
      if constexpr (kBKm) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          bk[e] = k_frag(bs, frag_row(tx, e), qc, tx);
      }
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        float a[8], b[8];
        if constexpr (kAK) {
#pragma unroll
          for (int e = 0; e < 8; ++e) a[e] = comp(ak[e], d);
        } else {
          mn_frag(as, 4 * qc + d, ty, a);
        }
        if constexpr (kBKm) {
#pragma unroll
          for (int e = 0; e < 8; ++e) b[e] = comp(bk[e], d);
        } else {
          mn_frag(bs, 4 * qc + d, tx, b);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
  }
}

// C -= acc on the four rows i .. i + 3 of a thread's fragment (acc rows
// r0 .. r0 + 3), columns 4tx .. and 64 + 4tx ..: every load is issued
// before the first store, so the read of C costs one round trip, not four.
__device__ __forceinline__ void sub_rows(float* c, int64_t ldc,
                                         const float (&acc)[8][8], int i,
                                         int j0, int tx, int M, int N,
                                         int vec_c, int r0) {
  float4 old[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* o = c + static_cast<int64_t>(i + r) * ldc;
      const int j = j0 + frag_row(tx, 4 * h);
      old[r][h] = float4{0.f, 0.f, 0.f, 0.f};
      if (i + r >= M) continue;
      if (vec_c && j + 3 < N) {
        old[r][h] = *reinterpret_cast<const float4*>(o + j);
      } else {
        if (j < N) old[r][h].x = o[j];
        if (j + 1 < N) old[r][h].y = o[j + 1];
        if (j + 2 < N) old[r][h].z = o[j + 2];
        if (j + 3 < N) old[r][h].w = o[j + 3];
      }
    }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (i + r >= M) continue;
      float* o = c + static_cast<int64_t>(i + r) * ldc;
      const int j = j0 + frag_row(tx, 4 * h);
      const float* a = acc[r0 + r] + 4 * h;
      const float4 v{old[r][h].x - a[0], old[r][h].y - a[1],
                     old[r][h].z - a[2], old[r][h].w - a[3]};
      if (vec_c && j + 3 < N) {
        *reinterpret_cast<float4*>(o + j) = v;
      } else {
        if (j < N) o[j] = v.x;
        if (j + 1 < N) o[j + 1] = v.y;
        if (j + 2 < N) o[j + 2] = v.z;
        if (j + 3 < N) o[j + 3] = v.w;
      }
    }
}

// Tile (ti, tj), ti >= tj, of the lower triangle of a grid of tiles that
// block b of the symmetric update owns: b = ti (ti + 1) / 2 + tj, the
// tiles row by row.
__host__ __device__ inline void lower_tile(int64_t b, int& ti, int& tj) {
  int64_t i = static_cast<int64_t>((sqrt(8.0 * b + 1.0) - 1.0) / 2.0);
  while (i * (i + 1) / 2 > b) --i;
  while ((i + 1) * (i + 2) / 2 <= b) ++i;
  ti = static_cast<int>(i);
  tj = static_cast<int>(b - i * (i + 1) / 2);
}

// The float offset of (row r, column q) of a 128 x 128 tile staged in
// shared memory, its 16-byte chunks XOR-swizzled by (r / 4) mod 8: a
// quarter-warp storing a float4 to each of 8 rows 4 apart, or loading 8
// consecutive float4 of one row, hits 8 different bank groups.
__device__ __forceinline__ int tile_at(int r, int q) {
  return r * kBM + 4 * ((q >> 2) ^ ((r >> 2) & 7)) + (q & 3);
}

// Replaces a thread's acc (its fragment of the tile P) by its fragment of
// P^T, through the shared tile s: acc[r][c] = P(frag_row(tx, c),
// frag_row(ty, r)) after.  Every thread must be done with s before.
__device__ __forceinline__ void transpose_acc(float* s, float (&acc)[8][8],
                                              int tx, int ty) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(s + tile_at(frag_row(tx, c),
                                             frag_row(ty, 4 * h))) =
          float4{acc[4 * h][c], acc[4 * h + 1][c], acc[4 * h + 2][c],
                 acc[4 * h + 3][c]};
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(
          s + tile_at(frag_row(ty, r), frag_row(tx, 4 * h)));
      acc[r][4 * h] = v.x;
      acc[r][4 * h + 1] = v.y;
      acc[r][4 * h + 2] = v.z;
      acc[r][4 * h + 3] = v.w;
    }
}

// C[i, j] (= or, kSub, -=) the sum over q in [z kc, min(K, (z+1) kc)) of
// A(i, q) B^T(j, q), for i < M, j < N, with z = blockIdx.z and C at
// c + z * zs (row stride ldc).  kSym (with kSub, A = B K-major, one split):
// the block owns lower tile blockIdx.x (lower_tile) and also subtracts its
// transpose from the mirrored tile.
template <bool kAK, bool kBKm, bool kSub = false, bool kSym = false>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
sgemm_kernel(Operand A, Operand B, float* __restrict__ c, int64_t ldc,
             int64_t zs, int K, int kc, int vec_c) {
  static_assert(!kSym || (kSub && kAK && kBKm),
                "the symmetric update subtracts A A^T, A K-major");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBM;
  if constexpr (kSym) {
    int ti, tj;
    lower_tile(blockIdx.x, ti, tj);
    i0 = ti * kBM;
    j0 = tj * kBM;
  }
  const int q_lo = blockIdx.z * kc;
  const int q_hi = min(K, q_lo + kc);
  const int nsl = (q_hi - q_lo + kBK - 1) / kBK;
  c += blockIdx.z * zs;

  const Loader<kAK> la(A, i0, q_lo);
  const Loader<kBKm> lb(B, j0, q_lo);
  auto stage = [&](int sl) {
    float* s = smem + (sl % kStages) * 2 * kOperand;
    const int q0 = q_lo + sl * kBK;
    la.copy(A, s, i0, sl, q0, q_hi);
    lb.copy(B, s + kOperand, j0, sl, q0, q_hi);
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;

#pragma unroll
  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < nsl) stage(sl);
    cp_async_commit();
  }
#pragma unroll 1
  for (int sl = 0; sl < nsl; ++sl) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // slice sl visible to all; slice sl - 1's slot free
    if (sl + kStages - 1 < nsl) stage(sl + kStages - 1);
    cp_async_commit();
    const float* s = smem + (sl % kStages) * 2 * kOperand;
    slice_product<kAK, kBKm>(s, s + kOperand, acc, tx, ty);
  }
  cp_async_wait<0>();

  const int M = A.rows, N = B.rows;
  if constexpr (kSub) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
      sub_rows(c, ldc, acc, i0 + 64 * half + 4 * ty, j0, tx, M, N, vec_c,
               4 * half);
    if constexpr (kSym) {
      if (i0 != j0) {          // the mirror (j, i) -= P^T; uniform a block
        __syncthreads();       // every thread done with the ring
        transpose_acc(smem, acc, tx, ty);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          sub_rows(c, ldc, acc, j0 + 64 * half + 4 * ty, i0, tx, N, M,
                   vec_c, 4 * half);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + frag_row(ty, r);
      if (i >= M) continue;
      float* o = c + static_cast<int64_t>(i) * ldc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + frag_row(tx, 4 * h);
        if (vec_c && j + 3 < N) {
          *reinterpret_cast<float4*>(o + j) =
              float4{acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                     acc[r][4 * h + 3]};
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j + e < N) o[j + e] = acc[r][4 * h + e];
        }
      }
    }
  }
}

// C[i, j] (= or, kSub, -=) the sum over z = 0, 1, ..., nz - 1, in that
// order, of the partial tiles part[z * M * N + i * N + j].
template <bool kSub = false>
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

// How many parts K is split into for an (M x K)(K x N) product on `sms`
// SMs: one when the output tiles fill the resident blocks, else as many as
// the resident blocks hold whole (one wave), each at least kMinSplitDepth
// deep.  The wrapper sizes the scratch by it.
inline int splits_for(int64_t M, int64_t N, int64_t K, int sms) {
  const int64_t tiles = ((M + kBM - 1) / kBM) * ((N + kBM - 1) / kBM);
  const int64_t resident = static_cast<int64_t>(sms) * kBlocksPerSM;
  if (tiles <= 0 || tiles >= resident) return 1;
  int64_t s = resident / tiles;
  if (s > K / kMinSplitDepth) s = K / kMinSplitDepth;
  return s < 1 ? 1 : static_cast<int>(s);
}

// The operand (r, q) at p[r * ms + q * ks] with `rows` rows: K-major when q
// is its unit stride (or, with none, the smaller one), 16-byte copies when
// the base is 16-byte aligned and the other stride a multiple of 4.
inline Operand make_operand(const float* p, int64_t ms, int64_t ks, int rows,
                            bool& k_major) {
  const int64_t ams = ms < 0 ? -ms : ms, aks = ks < 0 ? -ks : ks;
  k_major = ks == 1 || (ms != 1 && aks < ams);
  const int64_t other = k_major ? ms : ks;
  const int vec = (k_major ? ks == 1 : ms == 1) && other % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return Operand{p, ms, ks, rows, vec};
}

// The depth of each part when K is split into `splits` parts (a multiple of
// kBK); nz is set to the number of parts that are not empty.
inline int split_depth(int K, int splits, int& nz) {
  int kc = (K + splits - 1) / splits;
  kc = (kc + kBK - 1) / kBK * kBK;
  nz = (K + kc - 1) / kc;
  return kc;
}

// Whether C (row stride ldc) takes 16-byte accesses.
inline int vec_out(const float* c, int64_t ldc) {
  return ldc % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

// The (rows x K) operand (r, q) at p[r + q ld] (MN-major) or p[r ld + q]
// (K-major), as a caller that knows its layout builds it.
inline Operand mn_operand(const float* p, int64_t ld, int rows) {
  return Operand{p, 1, ld, rows,
                 ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0};
}
inline Operand k_operand(const float* p, int64_t ld, int rows) {
  return Operand{p, ld, 1, rows,
                 ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0};
}

// Launches sgemm_kernel: one block a tile of C and part of K (kSym: one
// block a tile on or below the diagonal).
template <bool kAK, bool kBKm, bool kSub = false, bool kSym = false>
int launch(const Operand& A, const Operand& B, float* c, int64_t ldc,
           int64_t zs, int K, int kc, int nz, int vec_c, cudaStream_t s) {
  auto kernel = sgemm_kernel<kAK, kBKm, kSub, kSym>;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes)));
  if (err) return err;
  const unsigned t = (A.rows + kBM - 1) / kBM;
  const dim3 grid = kSym ? dim3(t * (t + 1) / 2)
                         : dim3((B.rows + kBM - 1) / kBM, t, nz);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(A, B, c, ldc, zs, K, kc, vec_c);
  return static_cast<int>(cudaGetLastError());
}

// C (= or, kSub, -=) A B for operands of a known layout and C(i, j) at
// c[i * ldc + j]; K split into `splits` parts, whose partial products go
// to `scratch` (splits * M * N floats) and are summed in order into C.
template <bool kAK, bool kBKm, bool kSub = false>
int product(const Operand& A, const Operand& B, float* c, int64_t ldc, int K,
            float* scratch, int splits, cudaStream_t s) {
  const int M = A.rows, N = B.rows;
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || ldc < N ||
      (M + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int nz;
  const int kc = split_depth(K, splits, nz);
  if (nz == 1)
    return launch<kAK, kBKm, kSub>(A, B, c, ldc, 0, K, kc, 1,
                                   vec_out(c, ldc), s);
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(M) * N;
  const int err = launch<kAK, kBKm>(A, B, scratch, N, total, K, kc, nz,
                                    vec_out(scratch, N), s);
  if (err) return err;
  int64_t blocks = (total + kSumThreads - 1) / kSumThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  split_sum_kernel<kSub><<<static_cast<int>(blocks), kSumThreads, 0, s>>>(
      scratch, nz, c, ldc, M, N);
  return static_cast<int>(cudaGetLastError());
}

// C (= or, kSub, -=) A B for A(i, q) = a[i * a_rs + q * a_cs] (M x K),
// B(q, j) = b[q * b_rs + j * b_cs] (K x N) and C(i, j) = c[i * ldc + j]: a
// new matrix, or a window of a larger one; each operand staged in the
// layout its strides give.  `scratch` holds splits * M * N floats when
// splits > 1.  Returns the CUDA error (0 on success).
template <bool kSub = false>
int gemm(const float* a, int64_t a_rs, int64_t a_cs, const float* b,
         int64_t b_rs, int64_t b_cs, float* c, int64_t ldc, int M, int N,
         int K, float* scratch, int splits, cudaStream_t s) {
  bool a_k, b_k;
  const Operand A = make_operand(a, a_rs, a_cs, M, a_k);
  const Operand B = make_operand(b, b_cs, b_rs, N, b_k);   // B^T(j, q)
  if (a_k)
    return b_k ? product<true, true, kSub>(A, B, c, ldc, K, scratch, splits,
                                           s)
               : product<true, false, kSub>(A, B, c, ldc, K, scratch, splits,
                                            s);
  return b_k ? product<false, true, kSub>(A, B, c, ldc, K, scratch, splits, s)
             : product<false, false, kSub>(A, B, c, ldc, K, scratch, splits,
                                           s);
}

}  // namespace sm90
