// Flash-attention forward pass in float32 for Hopper (sm_90a), with a plain
// C interface for ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/attention.py
// (flash_attention) for float32 inputs: softmax attention with an online
// softmax (running max m, running sum l and accumulator acc over the kv
// axis), grouped-query heads, causal masking with the query ends aligned to
// the key ends (q_offset = Tk - Tq), an optional sliding window, fully
// masked tiles skipped and a zero denominator guarded.  q is (B, Hq, Tq,
// D), k and v (B, Hkv, Tk, D), any strides; o is a new contiguous (B, Hq,
// Tq, D) float32 tensor; D <= 256.  bf16 and fp16 inputs go to the
// tensor-core kernel of attention_wgmma.cu.
//
// Bound: at the serving shapes, operations.  4 D flops per visible (query,
// key) pair and head against 4 D (Tq + 2 Tk) bytes a head: about T / 3
// flops per byte, far above the H100's ~20 float32 flops a byte (67 TFLOP/s
// outside the tensor cores over 3.35 TB/s) for T >= 128.  The Pallas kernel
// computes both products in float32, and so does this one: FFMA on the
// float32 pipes, no TF32, no tensor cores.
//
// The TPU kernel walks a (B, Hq, Tq/bq, Tk/bk) grid whose last axis is
// sequential, carrying (m, l, acc) in VMEM scratch.  Here, for D <= 128
// (flash_f32_kernel), one CTA of 256 threads owns 128 query rows of one
// (batch, head) (the reference's row tile, or all of Tq below 128) and walks
// the reference's live key tiles of 128 itself, with the structure of the
// float32 GEMM mainloop of tile_gemm_sm90.cuh, whose cp.async copies and
// swizzled fragment reads it uses:
//   * both products are register-tiled outer products: thread (ty, tx) of
//     a 16 x 16 grid owns an 8 x 8 tile of S = Q K^T (rows 4ty .. 4ty + 3
//     and 64 + the same, keys 4tx .. and 64 + ..) and the same rows of O
//     (columns 4tx .. and 64 + ..), so that a step of depth 4 reads 16
//     LDS.128 for 256 FFMA;
//   * Q is staged once, transposed through registers into D / 32 MN-major
//     slices (32 depths x 128 rows), while the first K slices are in
//     flight; a step reads its rows as float4s of one depth;
//   * each live key tile streams through one ring of kStages slices of 16
//     KB, filled by cp.async: first the tile's K in D / 32 K-major slices
//     (keys x 32 depths), then its V in 4 MN-major slices (32 keys x 128
//     columns), each slice's copies issued kStages - 1 slices ahead, so the
//     next slices are in flight while one is computed (one barrier a
//     slice).  Copies are 16 bytes wide where D's stride is 1 and the base
//     and other strides are 16-byte aligned, else 4 bytes, in the same
//     kernel; ragged edges are zero-filled;
//   * after a tile's last K slice the scores are scaled, masked and turned
//     into P by the online softmax: a row's 16 threads share its max by
//     shuffles, all of a thread's rows at once; each thread keeps its own
//     part of the row's sum l (its keys), rescaled with the row, and the 16
//     parts are added once, at the end.  P goes through shared memory, in
//     K-major slices (rows x 32 keys), as the A operand of P V; the ring's
//     barriers order its writes and reads;
//   * the accumulators of S and O stay in registers (1 CTA of 8 warps an
//     SM: 128 a thread); m and the parts of l, touched once a tile, in each
//     thread's own words of shared memory (208 KB in all);
//   * the grid's first axis is (batch, head), its second the row tiles,
//     heaviest first (the last row tile of a causal mask sees the most key
//     tiles), so the last wave holds the shortest rows;
//   * where (batch, head, 128-row tile) would give fewer CTAs than the card
//     has SMs, a CTA owns 64 rows (4 a thread, rows 4ty .. 4ty + 3) with the
//     same tiles, copies, order of sums and skips (the reference's tile of
//     its rows), so twice as many SMs work;
//   * the kv head is h / (Hq / Hkv): nothing is repeated.
// For 128 < D <= 256 the earlier kernel (flash_wide_kernel) runs: 64 query
// rows a CTA, 64 keys a tile staged by 4-byte loads between barriers, 4 x 4
// scores a thread; its register tile would not hold the new design's 8 x
// (D / 16) columns of O beside S.
// The reference's semantics are kept where they are visible: masked scores
// are the finite -1e30 (not -inf), so a row that is fully masked inside a
// live tile gets p = 1 for its masked keys and, if it never meets a visible
// key, returns the mean of those values; the tile skip uses the reference's
// tiles (bq = min(128, Tq), bk = min(128, Tk)), so which keys such a row
// averages, and which rows return 0 (every tile skipped), is the reference's;
// p = expf(s - m); the output is acc / (l == 0 ? 1 : l).
//
// Determinism: no atomics; each CTA owns its output rows and sums in a fixed
// order, so reruns are bitwise equal.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_gemm_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's _NEG_INF

struct Strides {
  int64_t b, h, t, d;
};

// ---- D <= 128: register-tiled products, a cp.async ring ------------------

constexpr int kTile = sm90::kBM;            // keys of a tile; rows of a CTA
constexpr int kDepth = sm90::kBK;           // depth of one staged slice
constexpr int kSlice = sm90::kOperand;      // floats of one 128 x 32 slice
constexpr int kMaxDim = 128;
constexpr int kMaxSlices = kMaxDim / kDepth;  // of Q, and of P (keys / 32)
constexpr int kStages = 4;                  // slices of the K / V ring
constexpr int kThreads = sm90::kThreads;    // 16 x 16
// Q, P, the ring, and each thread's copy of m and of its part of l
constexpr size_t kSmemBytes =
    sizeof(float) * ((2 * kMaxSlices + kStages) * kSlice + 2 * 8 * kThreads);

// One tensor: its (batch, head) strides, and whether its rows take 16-byte
// copies (feature stride 1, base and other strides 16-byte aligned).
struct Head {
  const float* p;
  Strides s;
  int vec;
};

// The (rows x depth) operand of one (batch, head) for the ring's copies: K
// as (position x feature), K-major; V as (feature x position), MN-major.
__device__ __forceinline__ sm90::Operand slab(const Head& x, int b, int h,
                                              int positions, int dim,
                                              bool by_position) {
  const float* p = x.p + b * x.s.b + h * x.s.h;
  return by_position ? sm90::Operand{p, x.s.t, x.s.d, positions, x.vec}
                     : sm90::Operand{p, x.s.d, x.s.t, dim, x.vec};
}

// Row r of a thread's RM rows in the CTA's tile: RM = 8, rows 4ty .. 4ty + 3
// and 64 + 4ty ..; RM = 4, rows 4ty .. 4ty + 3.  Either way (row / 4) mod 8
// is ty mod 8, the swizzle of the row's slices.
template <int RM>
__device__ __forceinline__ int row_of(int ty, int r) {
  return RM == 8 ? sm90::frag_row(ty, r) : 4 * ty + r;
}

// The thread's RM rows of an MN-major slice (32 depths x 128 rows) at
// depth q: rows 4ty .. 4ty + 3 (and 64 + the same where RM = 8).
template <int RM>
__device__ __forceinline__ void rows_at(const float* s, int q, int ty,
                                        float (&v)[RM]) {
  if constexpr (RM == 8) {
    sm90::mn_frag(s, q, ty, v);
  } else {
    const float4 x = *reinterpret_cast<const float4*>(s + q * kTile + 4 * ty);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
}

// S += Q K^T over one 32-deep slice, Q MN-major, K K-major: for each step
// of depth 4 the thread's 8 keys, then at each depth its RM rows of Q; each
// sum over ascending depth.
template <int RM>
__device__ __forceinline__ void s_product(const float* qs, const float* ks,
                                          float (&acc)[RM][8], int tx,
                                          int ty) {
#pragma unroll
  for (int qc = 0; qc < kDepth / 4; ++qc) {
    float4 b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      b[e] = sm90::k_frag(ks, sm90::frag_row(tx, e), qc, tx);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      float a[RM];
      rows_at<RM>(qs, 4 * qc + d, ty, a);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[r][c] = fmaf(a[r], sm90::comp(b[c], d), acc[r][c]);
    }
  }
}

// O += P V over one slice of 32 keys: P K-major, V MN-major (columns 4tx ..
// and 64 + 4tx ..); each sum over ascending keys.
template <int RM>
__device__ __forceinline__ void pv_product(const float* ps, const float* vs,
                                           float (&acc)[RM][8], int tx,
                                           int ty) {
#pragma unroll
  for (int qc = 0; qc < kDepth / 4; ++qc) {
    float4 a[RM];
#pragma unroll
    for (int e = 0; e < RM; ++e)
      a[e] = sm90::k_frag(ps, row_of<RM>(ty, e), qc, ty);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      float b[8];
      sm90::mn_frag(vs, 4 * qc + d, tx, b);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[r][c] = fmaf(sm90::comp(a[r], d), b[c], acc[r][c]);
    }
  }
}

// The online softmax of one key tile (keys key0 ..), with the thread's m
// and part of l at m[r * kThreads], l[r * kThreads] (its own copies in
// shared memory, which leaves the registers to the products): the scores s
// scaled and masked (-1e30), the row's max over the keys that exist taken
// by its 16 threads, all of a thread's rows at once; s becomes
// P = expf(s - m) (0 past Tk), O and the thread's part of l are rescaled by
// alpha = expf(m_old - m) and the thread's p added to its part of l, in
// key order.
template <int RM>
__device__ __forceinline__ void online_softmax(
    float (&s)[RM][8], float (&o)[RM][8], float* m, float* l, int tx,
    int ty, int row0, int key0, int q_offset, int tk, float scale,
    int causal, int has_window, int window) {
  float mx[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int qpos = row0 + row_of<RM>(ty, r) + q_offset;
    mx[r] = kNegInf;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int kpos = key0 + sm90::frag_row(tx, c);
      float x = s[r][c] * scale;
      bool visible = true;
      if (causal) visible = visible && kpos <= qpos;
      if (has_window) visible = visible && kpos > qpos - window;
      x = visible ? x : kNegInf;
      s[r][c] = x;
      if (kpos < tk) mx[r] = fmaxf(mx[r], x);
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < RM; ++r)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const float m_old = m[r * kThreads];
    const float m_new = fmaxf(m_old, mx[r]);
    const float alpha = expf(m_old - m_new);
    m[r * kThreads] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      // keys past Tk do not exist: p = 0 (the reference tiles Tk exactly)
      const float e = expf(s[r][c] - m_new);
      s[r][c] = key0 + sm90::frag_row(tx, c) < tk ? e : 0.f;
      sum += s[r][c];
    }
    l[r * kThreads] = alpha * l[r * kThreads] + sum;
#pragma unroll
    for (int c = 0; c < 8; ++c) o[r][c] *= alpha;
  }
}

// P (the thread's rows, keys 4tx .. and 64 + 4tx ..) into its K-major
// slices: key k to slice k / 32 at depth k mod 32.
template <int RM>
__device__ __forceinline__ void write_p(float* ps, const float (&p)[RM][8],
                                        int tx, int ty) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = 64 * half + 4 * tx;
      *reinterpret_cast<float4*>(ps + (key / kDepth) * kSlice +
                                 sm90::kmajor_at(row_of<RM>(ty, r),
                                                 key % kDepth)) =
          float4{p[r][4 * half], p[r][4 * half + 1], p[r][4 * half + 2],
                 p[r][4 * half + 3]};
    }
}

// RM rows a thread: 16 RM query rows a CTA
template <int RM>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32_kernel(Head qh, Head kh, Head vh, float* __restrict__ o, int vec_o,
                 int hq, int group, int tq, int tk, int dim, int bq, int bk,
                 float scale, int causal, int has_window, int window) {
  constexpr int kRows = 16 * RM;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // Q, kMaxSlices slices
  float* p_s = q_s + kMaxSlices * kSlice;        // P, one slice a 32 keys
  float* ring = p_s + kMaxSlices * kSlice;       // kStages slices of K / V
  float* m_s = ring + kStages * kSlice + threadIdx.x;   // m[r] at r kThreads
  float* l_s = m_s + 8 * kThreads;                      // l[r] likewise

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / hq, h = blockIdx.x % hq, hk = h / group;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  const int q_offset = tk - tq;
  // the reference's tile of these rows, for its skip test
  const int first_q = (row0 / bq) * bq + q_offset;
  const int last_q = first_q + bq - 1;

  // the live key tiles t_lo .. t_hi, by the reference's skips: the causal
  // break ends them, the window skips a prefix
  const int ntiles = (tk + kTile - 1) / kTile;
  int t_lo = ntiles, t_hi = -1;
  for (int t = 0; t < ntiles; ++t) {
    const int first_k = (t * kTile / bk) * bk;
    if (causal && first_k > last_q) break;
    if (has_window && first_k + bk - 1 <= first_q - window) continue;
    t_lo = min(t_lo, t);
    t_hi = t;
  }
  const int ns = (dim + kDepth - 1) / kDepth;                // K slices
  const int nv = (min(tk, kTile) + kDepth - 1) / kDepth;     // V slices
  const int per_tile = ns + nv;
  const int total = t_hi >= t_lo ? (t_hi - t_lo + 1) * per_tile : 0;

  // slice i of the walk: K slice j < ns of its tile, else V slice j - ns;
  // the operands are rebuilt from the parameters at each slice, which
  // leaves the registers to the accumulators
  auto stage = [&](int i) {
    float* s = ring + (i % kStages) * kSlice;
    const int j = i % per_tile;
    const int key0 = (t_lo + i / per_tile) * kTile;
    if (j < ns) {
      const sm90::Operand kop = slab(kh, b, hk, tk, dim, true);
      const sm90::Loader<true> ld(kop, key0, 0);
      ld.copy(kop, s, key0, j, j * kDepth, dim);
    } else {
      const sm90::Operand vop = slab(vh, b, hk, tk, dim, false);
      const sm90::Loader<false> ld(vop, 0, key0);
      ld.copy(vop, s, 0, j - ns, key0 + (j - ns) * kDepth, tk);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) stage(i);
    sm90::cp_async_commit();
  }
  // while the first slices are in flight: Q's rows row0 .. row0 + kRows - 1
  // transposed into ns MN-major slices (32 depths x 128 rows), 16 bytes a
  // load where the rows allow it, 4 loads in flight a thread; zero past Tq
  // and D.  The loop's first barrier publishes them.
  if (total > 0) {
    const float* qp = qh.p + b * qh.s.b + h * qh.s.h;
    const int quads = ns * kRows * (kDepth / 4);
    for (int base = tid; base < quads; base += 4 * kThreads) {
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * kThreads;
        const int row = row0 + idx % kRows, d0 = 4 * (idx / kRows);
        x[u] = float4{0.f, 0.f, 0.f, 0.f};
        if (idx >= quads || row >= tq) continue;
        const float* src = qp + row * qh.s.t + d0 * qh.s.d;
        if (qh.vec && d0 + 3 < dim) {
          x[u] = *reinterpret_cast<const float4*>(src);
        } else {
          if (d0 < dim) x[u].x = src[0];
          if (d0 + 1 < dim) x[u].y = src[qh.s.d];
          if (d0 + 2 < dim) x[u].z = src[2 * qh.s.d];
          if (d0 + 3 < dim) x[u].w = src[3 * qh.s.d];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * kThreads;
        if (idx >= quads) continue;
        const int d0 = 4 * (idx / kRows);
        float* dst = q_s + (d0 / kDepth) * kSlice + (d0 % kDepth) * kTile +
                     idx % kRows;
        dst[0] = x[u].x;
        dst[kTile] = x[u].y;
        dst[2 * kTile] = x[u].z;
        dst[3 * kTile] = x[u].w;
      }
    }
  }

  float s_acc[RM][8], o_acc[RM][8];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m_s[r * kThreads] = kNegInf;
    l_s[r * kThreads] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) o_acc[r][c] = 0.f;
  }

#pragma unroll 1
  for (int i = 0; i < total; ++i) {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();   // slice i visible to all; slice i - 1's slot free
    if (i + kStages - 1 < total) stage(i + kStages - 1);
    sm90::cp_async_commit();
    const float* s = ring + (i % kStages) * kSlice;
    const int j = i % per_tile;
    if (j >= ns) {     // O += P V over 32 keys
      pv_product<RM>(p_s + (j - ns) * kSlice, s, o_acc, tx, ty);
      continue;
    }
    if (j == 0) {
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) s_acc[r][c] = 0.f;
    }
    s_product<RM>(q_s + j * kSlice, s, s_acc, tx, ty);
    if (j < ns - 1) continue;
    // the tile's scores are whole: P into p_s (the last tile's P V reads
    // ended before this slice's barrier)
    online_softmax<RM>(s_acc, o_acc, m_s, l_s, tx, ty, row0,
                       (t_lo + i / per_tile) * kTile, q_offset, tk, scale,
                       causal, has_window, window);
    write_p<RM>(p_s, s_acc, tx, ty);
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    float sum = l_s[r * kThreads];  // the row's 16 parts
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int row = row0 + row_of<RM>(ty, r);
    if (row >= tq) continue;
    const float denom = sum == 0.f ? 1.f : sum;
    float* out = o + ((static_cast<int64_t>(b) * hq + h) * tq + row) * dim;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = sm90::frag_row(tx, 4 * half);
      const float* a = o_acc[r] + 4 * half;
      if (vec_o && col + 3 < dim) {
        *reinterpret_cast<float4*>(out + col) =
            float4{a[0] / denom, a[1] / denom, a[2] / denom, a[3] / denom};
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < dim) out[col + e] = a[e] / denom;
      }
    }
  }
}

// Whether a (B, H, T, D) tensor's rows take 16-byte copies.
int vec_rows(const void* p, const int64_t* s) {
  return s[3] == 1 && s[2] % 4 == 0 && s[1] % 4 == 0 && s[0] % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int RM>
int launch_f32(const float* q, const int64_t* qs, const float* k,
               const int64_t* ks, const float* v, const int64_t* vs, float* o,
               int batch, int hq, int hkv, int tq, int tk, int dim, int bq,
               int bk, float scale, int causal, int has_window, int window,
               cudaStream_t stream) {
  auto kernel = flash_f32_kernel<RM>;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes)));
  if (err) return err;
  const dim3 grid(batch * hq, (tq + 16 * RM - 1) / (16 * RM));
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      Head{q, Strides{qs[0], qs[1], qs[2], qs[3]}, vec_rows(q, qs)},
      Head{k, Strides{ks[0], ks[1], ks[2], ks[3]}, vec_rows(k, ks)},
      Head{v, Strides{vs[0], vs[1], vs[2], vs[3]}, vec_rows(v, vs)}, o,
      dim % 4 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0, hq,
      hq / hkv, tq, tk, dim, bq, bk, scale, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

// ---- 128 < D <= 256: 64 rows a CTA, 4 x 4 scores a thread ----------------

constexpr int kWideRows = 64;         // query rows of a CTA
constexpr int kWideKeys = 64;         // keys of a shared-memory tile
constexpr int kPLd = kWideKeys + 4;   // row stride of the probability tile

// rows [row0, row0 + 64) of one (batch, head) slab into a tile of row
// stride ld; rows >= limit and columns >= dim are zero
template <int LD>
__device__ __forceinline__ void stage_rows(float* tile, const float* slab,
                                           Strides s, int row0, int limit,
                                           int dim) {
  constexpr int kCols = LD - 4;
  for (int e = threadIdx.x; e < kWideRows * kCols; e += kThreads) {
    const int r = e / kCols, c = e % kCols;
    float x = 0.f;
    if (row0 + r < limit && c < dim)
      x = slab[(int64_t)(row0 + r) * s.t + (int64_t)c * s.d];
    tile[r * LD + c] = x;
  }
}

// NC: float4 column groups of 64 a thread owns, D <= 64 NC
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
flash_wide_kernel(const float* __restrict__ q, Strides qs,
                  const float* __restrict__ k, Strides ks,
                  const float* __restrict__ v, Strides vs,
                  float* __restrict__ o, int hq, int group, int tq, int tk,
                  int dim, int bq, int bk, float scale, int causal,
                  int has_window, int window) {
  constexpr int LD = 64 * NC + 4;  // float4-aligned; LD % 32 == 4: no bank
                                   // conflicts on the key-row reads
  extern __shared__ __align__(16) float smem[];
  float* q_tile = smem;                       // [kWideRows][LD]
  float* kv_tile = q_tile + kWideRows * LD;   // [kWideKeys][LD], K then V
  float* p_tile = kv_tile + kWideKeys * LD;   // [kWideRows][kPLd]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int row0 = blockIdx.x * kWideRows;
  const int q_offset = tk - tq;
  const int dim4 = (dim + 3) & ~3;

  const float* q_slab = q + b * qs.b + h * qs.h;
  const float* k_slab = k + b * ks.b + hk * ks.h;
  const float* v_slab = v + b * vs.b + hk * vs.h;
  stage_rows<LD>(q_tile, q_slab, qs, row0, tq, dim);

  // the reference's tile of these rows, for its skip test
  const int first_q = (row0 / bq) * bq + q_offset;
  const int last_q = first_q + bq - 1;

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int key0 = 0; key0 < tk; key0 += kWideKeys) {
    const int first_k = (key0 / bk) * bk;
    if (causal && first_k > last_q) break;  // every later tile is dead too
    if (has_window && first_k + bk - 1 <= first_q - window) continue;

    __syncthreads();  // the previous tile's values are consumed
    stage_rows<LD>(kv_tile, k_slab, ks, key0, tk, dim);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dim4; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            &q_tile[(4 * ty + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            &kv_tile[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = row0 + 4 * ty + i + q_offset;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = key0 + tx + 16 * j;
        float x = s[i][j] * scale;
        bool visible = true;
        if (causal) visible = visible && kpos <= qpos;
        if (has_window) visible = visible && kpos > qpos - window;
        x = visible ? x : kNegInf;
        s[i][j] = x;
        if (kpos < tk) row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = key0 + tx + 16 * j < tk ? expf(s[i][j] - m_new) : 0.f;
        p_tile[(4 * ty + i) * kPLd + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every score read of the keys is done
    stage_rows<LD>(kv_tile, v_slab, vs, key0, tk, dim);
    __syncthreads();  // values and probabilities are in place

    for (int kk = 0; kk < kWideKeys; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            &p_tile[(4 * ty + i) * kPLd + kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &kv_tile[(kk + e) * LD + 4 * tx + 64 * c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y
                          : e == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * c + 0] = fmaf(p, vv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(p, vv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(p, vv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(p, vv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    if (r >= tq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    float* out = o + (((int64_t)b * hq + h) * tq + r) * dim;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * c + e;
        if (col < dim) out[col] = acc[i][4 * c + e] / denom;
      }
  }
}

template <int NC>
int launch_wide(const float* q, const int64_t* qs, const float* k,
                const int64_t* ks, const float* v, const int64_t* vs,
                float* o, int batch, int hq, int hkv, int tq, int tk, int dim,
                int bq, int bk, float scale, int causal, int has_window,
                int window, cudaStream_t stream) {
  constexpr int LD = 64 * NC + 4;
  const size_t smem = sizeof(float) * (2 * kWideRows * LD + kWideRows * kPLd);
  auto kernel = flash_wide_kernel<NC>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  const dim3 grid((tq + kWideRows - 1) / kWideRows, hq, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, Strides{qs[0], qs[1], qs[2], qs[3]}, k,
      Strides{ks[0], ks[1], ks[2], ks[3]}, v,
      Strides{vs[0], vs[1], vs[2], vs[3]}, o, hq, hq / hkv, tq, tk, dim, bq,
      bk, scale, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// o = attention(q, k, v) for dtype 0 = float32 (the only one taken here);
// each stride array is (batch, head, position, feature) in elements; o is
// contiguous.  bq, bk: the reference's tiles (min(128, T)); the window
// applies when has_window is nonzero.  Returns the CUDA error (0 on success).
int attention_forward(int dtype, const void* q, const int64_t* q_strides,
                      const void* k, const int64_t* k_strides, const void* v,
                      const int64_t* v_strides, void* o, int batch, int hq,
                      int hkv, int tq, int tk, int dim, int bq, int bk,
                      float scale, int causal, int has_window, int window,
                      int device, void* stream) {
  if (dtype != 0 || batch < 1 || hq < 1 || hkv < 1 || hq % hkv || tq < 1 ||
      tk < 1 || dim < 1 || dim > 256 || batch > 65535 || hq > 65535 ||
      static_cast<int64_t>(batch) * hq > INT32_MAX ||
      (tq + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto kf = static_cast<const float*>(k);
  auto vf = static_cast<const float*>(v);
  auto of = static_cast<float*>(o);
  if (dim <= kMaxDim) {
    // 64-row CTAs where 128-row ones would leave SMs idle
    int sms = 0;
    err = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device));
    if (err) return err;
    const int64_t tiles = static_cast<int64_t>(batch) * hq *
                          ((tq + kTile - 1) / kTile);
    auto launch = tiles < sms ? launch_f32<4> : launch_f32<8>;
    return launch(qf, q_strides, kf, k_strides, vf, v_strides, of, batch, hq,
                  hkv, tq, tk, dim, bq, bk, scale, causal, has_window, window,
                  s);
  }
  if (dim <= 192)
    return launch_wide<3>(qf, q_strides, kf, k_strides, vf, v_strides, of,
                          batch, hq, hkv, tq, tk, dim, bq, bk, scale, causal,
                          has_window, window, s);
  return launch_wide<4>(qf, q_strides, kf, k_strides, vf, v_strides, of,
                        batch, hq, hkv, tq, tk, dim, bq, bk, scale, causal,
                        has_window, window, s);
}

}  // extern "C"
