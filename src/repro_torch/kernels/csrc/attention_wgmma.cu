// Flash-attention forward pass on Hopper's tensor cores (sm_90a), for
// bfloat16 and float16 inputs, with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/attention.py
// (flash_attention) for 16-bit inputs; float32 inputs go to attention.cu.
// It computes the same function as attention.cu: softmax attention with an
// online softmax (running max m, running sum l and accumulator acc over the
// kv axis), grouped-query heads, causal masking with the query ends aligned
// to the key ends (q_offset = Tk - Tq), an optional sliding window, dead
// tiles skipped and a zero denominator guarded.  q is (B, Hq, Tq, D), k and
// v (B, Hkv, Tk, D), any strides; o is a new contiguous (B, Hq, Tq, D)
// tensor in q's dtype; D <= 256.
//
// Work.  One CTA, one warpgroup (128 threads), owns 64 query rows of one
// (batch, query head); the kv head is h / (Hq / Hkv): nothing is repeated.
// At D <= 128 two CTAs share an SM (under 200 registers a thread, 80 KB of
// shared memory), so one's softmax runs under the other's products.  CTAs
// walk the query tiles from the last (the longest under a causal mask) to
// the first.
//
// Shared memory holds the operands in their own 16-bit type, laid out as
// wgmma reads them (rows of 64 columns, 128 bytes, in 1024-byte atoms of 8
// rows with the 128-byte swizzle): the Q tile and two slots each of 64 keys
// and of their values, filled by cp.async a whole step before they are
// read (K two tiles ahead, V one).  Columns from D up to the next multiple
// of 64, and keys past Tk, are zero, which is exact.
//
// Products.  S = Q K^T is wgmma m64n64k16 with Q and K from shared memory
// (both K-major, as stored) and float32 accumulators; a bf16 x bf16 or fp16
// x fp16 product is exact in float32, so S differs from a float32 product
// of the same inputs only in the order of the sums.  O += P V is wgmma
// m64nNk16 (N = D rounded up to 64) with P from registers: the S
// accumulator fragment is, after conversion, the A fragment of the next
// product (as in FlashAttention-3); V comes from shared memory with the
// transpose bit.  The reference computes p @ v in float32 and never rounds
// p, and one rounding of p to bf16 (as SDPA does) would miss the gate of
// one output rounding plus 1e-5 by a factor of ~70 at T = 2048.  So P goes
// in as terms that sum to it, the A fragments of all four 16-key steps (48
// registers in bf16) held until P V is issued beside the next tile's S:
//   * bf16: P = P1 + P2 + P3, each term the bf16 rounding of what the
//     earlier ones leave (24 bits, float32's precision): three wgmmas into
//     the same accumulator against the same V tile;
//   * fp16: P 2^15 = P1 + P2 (22 bits); the power-of-two scale keeps small
//     p out of fp16's subnormals and is undone exactly on the output.
//
// Overlap, as FlashAttention-3 does within a warpgroup: the S product of
// tile t and the P V product of tile t - 1 are issued together, and P V
// runs on the tensor cores while the softmax of tile t runs on the other
// pipes; the sums are those of a kernel without the overlap, in its order.
// No wgmma, commit or wait sits in a branch or stays in flight across the
// loop's back edge: where one does, ptxas serializes every wgmma.
//
// Softmax in registers, as in attention.cu: running m, l and acc, the
// scores scaled by scale log2(e) in float32 and exponentiated by exp2, masked
// scores the reference's finite -1e30 (not -inf), keys past Tk p = 0.
//
// Skips.  A 64-key tile is computed when the reference's 128-tile that
// holds it is live (bq = min(128, Tq), bk = min(128, Tk)), so a row with no
// visible key returns what the reference returns: 0 where every tile is
// skipped, the mean of the values of a live tile where it meets no visible
// key.  A CTA also drops the scores of a tile that masks every one of its
// rows (it feeds P = 0 to P V) when each of its rows sees some key: such a
// tile adds p = 0, or its sums are scaled by alpha = 0 when the first
// visible key comes, so dropping it changes no bit.
//
// Bound: operations.  QK^T and a one-term P V are 4 D flops a visible
// (query, key) pair and head; the three-term P V makes it 8 D on the tensor
// cores (6 D for fp16's two terms), against 2 D (Tq + 2 Tk) bytes a head:
// far above the H100's ~295 bf16 flops a byte at the serving shapes.
//
// Determinism: no atomics; each CTA owns its output rows and sums in a fixed
// order, so reruns are bitwise equal.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;           // query rows of a CTA, one warpgroup
constexpr int kKeys = 64;           // keys of a K / V tile
constexpr int kThreads = 128;
constexpr uint32_t kAtom = 1024;    // an 8-row, 128-byte swizzle atom
constexpr float kNegInf = -1e30f;   // the reference's _NEG_INF
constexpr float kHalfScale = 32768.f;   // fp16: P is fed as P 2^15
#define kMinusInf __int_as_float(0xff800000)

struct Strides {
  int64_t b, h, t, d;
};

// ---- PTX wrappers -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, the bytes past `bytes` zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// order this thread's shared-memory writes before wgmma's reads of them
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// 2^x on the special-function unit; subnormal results flush to 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// keeps the compiler from moving accesses of wgmma's registers across the
// (operand-less) commit and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

// The asm operand lists: accumulators %0 .. %(N-1), then the operands.
#define R8_0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define R8_1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define R8_2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define R8_3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define R8_4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define R8_5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define R8_6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define R8_7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define R8_8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define R8_9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define R8_10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define R8_11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define R8_12 "%96, %97, %98, %99, %100, %101, %102, %103"
#define R8_13 "%104, %105, %106, %107, %108, %109, %110, %111"
#define R8_14 "%112, %113, %114, %115, %116, %117, %118, %119"
#define R8_15 "%120, %121, %122, %123, %124, %125, %126, %127"
#define ACC32 R8_0 ", " R8_1 ", " R8_2 ", " R8_3
#define ACC64 ACC32 ", " R8_4 ", " R8_5 ", " R8_6 ", " R8_7
#define ACC96 ACC64 ", " R8_8 ", " R8_9 ", " R8_10 ", " R8_11
#define ACC128 ACC96 ", " R8_12 ", " R8_13 ", " R8_14 ", " R8_15
#define F8(i)                                                              \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),      \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define F32(i) F8(i), F8((i) + 8), F8((i) + 16), F8((i) + 24)

// d (+)= A B^T, m64n64k16: A (64 x 16) and B (64 x 16) from shared memory,
// both K-major; scale_d = 0 overwrites d
#define WGMMA_SS(TY)                                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY      \
               " {" ACC32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                 \
               : F32(0)                                                     \
               : "l"(da), "l"(db), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    WGMMA_SS("f16");
  else
    WGMMA_SS("bf16");
}

// d += A B, m64nNk16: A (64 x 16) from registers, B (16 x N) from shared
// memory with N contiguous (the transpose bit)
#define WGMMA_RS(SHAPE, TY, ACC, OPS, SCALE, ...)                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"          \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY      \
               " {" ACC "}, " OPS ", p, 1, 1, 1;\n}\n"                       \
               : __VA_ARGS__                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(1))

#define WGMMA_RS_N(N, SHAPE, ACC, OPS, SCALE, ...)                         \
  if constexpr (std::is_same<T, __half>::value)                            \
    WGMMA_RS(SHAPE, "f16", ACC, OPS, SCALE, __VA_ARGS__);                  \
  else                                                                     \
    WGMMA_RS(SHAPE, "bf16", ACC, OPS, SCALE, __VA_ARGS__)

template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256, "wgmma N");
  if constexpr (N == 64) {
    WGMMA_RS_N(64, "m64n64k16", ACC32, "{%32, %33, %34, %35}, %36", "%37",
               F32(0));
  } else if constexpr (N == 128) {
    WGMMA_RS_N(128, "m64n128k16", ACC64, "{%64, %65, %66, %67}, %68", "%69",
               F32(0), F32(32));
  } else if constexpr (N == 192) {
    WGMMA_RS_N(192, "m64n192k16", ACC96, "{%96, %97, %98, %99}, %100",
               "%101", F32(0), F32(32), F32(64));
  } else {
    WGMMA_RS_N(256, "m64n256k16", ACC128, "{%128, %129, %130, %131}, %132",
               "%133", F32(0), F32(32), F32(64), F32(96));
  }
}

// ---- tiles ---------------------------------------------------------------

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of `rows`
// rows: 64-column blocks of rows x 128 bytes, chunk index XOR row % 8
__device__ __forceinline__ uint32_t swizzled(int row, int chunk, int rows) {
  return static_cast<uint32_t>((chunk >> 3) * rows * 128 + row * 128 +
                               (((chunk & 7) ^ (row & 7)) << 4));
}

// rows [row0, row0 + R) of a (T, D) slab of 16-bit values into the tile at
// shared address `tile` (`gtile` as a generic pointer), columns [0, C);
// rows >= limit and columns >= dim are 0.  With `vec` (unit column stride,
// dim and the other strides multiples of 8, 16-byte aligned) by 16-byte
// cp.async, else by 2-byte loads and stores.
template <int R, int C>
__device__ __forceinline__ void load_tile(uint32_t tile, unsigned char* gtile,
                                          const uint16_t* slab, Strides s,
                                          int row0, int limit, int dim,
                                          int vec) {
  constexpr int kChunks = C / 8;   // 16-byte chunks a row
  if (vec && kThreads % kChunks == 0) {
    // a thread keeps one chunk column and steps down the rows: one pointer
    // add and one shared offset a copy
    constexpr int kStep = kThreads / kChunks;
    const int c = threadIdx.x % kChunks, r0 = threadIdx.x / kChunks;
    const bool col_ok = 8 * c < dim;
    const uint16_t* src = slab + (row0 + r0) * s.t + 8 * c;
#pragma unroll
    for (int j = 0; j < R / kStep; ++j) {
      const int r = r0 + kStep * j;
      const bool ok = col_ok && row0 + r < limit;
      cp_async16(tile + swizzled(r, c, R), ok ? src : slab, ok ? 16 : 0);
      src += kStep * s.t;
    }
  } else if (vec) {
    for (int e = threadIdx.x; e < R * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e - r * kChunks;
      const bool ok = row0 + r < limit && 8 * c < dim;
      const uint16_t* src = ok ? slab + (row0 + r) * s.t + 8 * c : slab;
      cp_async16(tile + swizzled(r, c, R), src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < R * C; e += kThreads) {
      const int r = e / C, c = e - r * C;
      uint16_t x = 0;
      if (row0 + r < limit && c < dim) x = slab[(row0 + r) * s.t + c * s.d];
      *reinterpret_cast<uint16_t*>(gtile + swizzled(r, c >> 3, R) +
                                   2 * (c & 7)) = x;
    }
  }
}

// ---- P as a sum of 16-bit terms ------------------------------------------

// the terms of (x0, x1), packed as wgmma's A registers; x is left holding
// what the terms do not carry
template <typename T>
__device__ __forceinline__ uint32_t take_term(float& x0, float& x1) {
  uint32_t bits;
  float2 back;
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 h = __floats2half2_rn(x0, x1);
    back = __half22float2(h);
    bits = *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    back = __bfloat1622float2(h);
    bits = *reinterpret_cast<const uint32_t*>(&h);
  }
  x0 -= back.x;   // exact: the rounding error of a 16-bit rounding
  x1 -= back.y;
  return bits;
}

template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float x0, float x1) {
  if constexpr (std::is_same<T, __half>::value)
    *reinterpret_cast<__half2*>(dst) = __floats2half2_rn(x0, x1);
  else
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
}

// ---- the kernel ------------------------------------------------------------

// acc += P V for one key tile: P as the A fragments pa[term][step] of its
// 16-key steps, V at shared address v (64 keys x DP, 128-byte swizzled
// blocks of 64 columns) read with the transpose bit; one wgmma a term a
// step, all into acc, committed as one group (after a wgmma_fence)
template <typename T, int DP, int kTerms>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 2],
                                         uint32_t (&pa)[kTerms][kKeys / 16][4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint64_t dv = descriptor(v + kk * 16 * 128, kKeys * 128, kAtom);
#pragma unroll
    for (int term = 0; term < kTerms; ++term)
      wgmma_rs<T, DP>(acc, pa[term][kk], dv);
  }
  wgmma_commit();
}

// DP: D rounded up to 64, the width of the P V product
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const uint16_t* __restrict__ q, Strides qs,
                       const uint16_t* __restrict__ k, Strides ks,
                       const uint16_t* __restrict__ v, Strides vs,
                       T* __restrict__ o, int hq, int group, int tq, int tk,
                       int dim, int bq, int bk, float scale_log2, int causal,
                       int has_window, int window, int vec) {
  constexpr bool kHalf = std::is_same<T, __half>::value;
  constexpr int kTerms = kHalf ? 2 : 3;
  constexpr int kQBytes = kRows * DP * 2;
  constexpr int kTileBytes = kKeys * DP * 2;
  constexpr int kNO = DP / 2;        // output accumulators a thread
  constexpr int kLdo = DP + 8;       // row stride of the staged output

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = ((raw + kAtom - 1) & ~(kAtom - 1)) - raw;
  unsigned char* smem = smem_raw + pad;   // Q, K slots 0-1, V slots 0-1
  const uint32_t sbase = raw + pad;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q_offset = tk - tq;
  const uint16_t* q_slab = q + b * qs.b + h * qs.h;
  const uint16_t* k_slab = k + b * ks.b + hk * ks.h;
  const uint16_t* v_slab = v + b * vs.b + hk * vs.h;

  // the reference's query tile that holds these rows and the range of
  // 64-key tiles in its live 128-tiles: the window kills a prefix, the
  // causal mask a suffix
  const int first_q = row0 / bq * bq + q_offset, last_q = first_q + bq - 1;
  const int n_tiles = (tk + kKeys - 1) / kKeys;
  int t_begin = 0, t_end = n_tiles;
  if (causal)
    t_end = last_q < 0 ? 0
                       : min(n_tiles, ((last_q / bk + 1) * bk + kKeys - 1) /
                                          kKeys);
  if (has_window) {
    const int lo = first_q - window - bk + 2;   // live 128-tiles start here
    const int ik = lo <= 0 ? 0 : (lo + bk - 1) / bk;
    t_begin = min(n_tiles, (ik * bk + kKeys - 1) / kKeys);
  }

  // this CTA's positions; thread rows qpos0 and qpos0 + 8, columns
  // 8 j + kcol + {0, 1} of each 8-column group j of an accumulator
  const int wg_first = row0 + q_offset, wg_last = wg_first + kRows - 1;
  const int qpos0 = wg_first + 16 * warp + (lane >> 2);
  const int kcol = 2 * (lane & 3);
  // the tiles whose scores this CTA keeps, [w_begin, w_end): it drops a
  // tile of a live 128-tile that masks all its rows when every one of its
  // rows sees a key
  int w_begin = t_begin, w_end = t_end;
  if (!causal || wg_first >= 0) {
    if (causal) w_end = min(w_end, wg_last / kKeys + 1);
    const int lo = wg_first - window;    // keys <= lo are out of every window
    if (has_window && lo >= 0)
      w_begin = max(w_begin, lo >= tk - 1 ? n_tiles : (lo + 1) / kKeys);
  }

  float acc[kNO], s[32];
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // P of the last tile, as the A fragments of P V (16-key step kk of the S
  // accumulator is s[8 kk .. 8 kk + 7], A's register order; 0 where this
  // CTA drops the tile)
  uint32_t pa[kTerms][kKeys / 16][4];
#pragma unroll
  for (int term = 0; term < kTerms; ++term)
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[term][kk][r] = 0u;

  // the ring: K(t) and V(t) in slot (t - t_begin) % 2 of their own pair.
  // The end of step t loads K(t + 2), into the slot S(t) has just read,
  // and V(t + 1), into the one P V(t - 1) has; so each lands a whole step
  // before it is read.  One commit group a step (empty past t_end).
  const bool any = t_begin < t_end;
  const auto load_k = [=](int t) {
    const uint32_t off = kQBytes + ((t - t_begin) & 1) * kTileBytes;
    load_tile<kKeys, DP>(sbase + off, smem + off, k_slab, ks, t * kKeys, tk,
                         dim, vec);
  };
  const auto load_v = [=](int t) {
    const uint32_t off = kQBytes + (2 + ((t - t_begin) & 1)) * kTileBytes;
    load_tile<kKeys, DP>(sbase + off, smem + off, v_slab, vs, t * kKeys, tk,
                         dim, vec);
  };
  if (any) {
    load_tile<kRows, DP>(sbase, smem, q_slab, qs, row0, tq, dim, vec);
    load_k(t_begin);
  }
  cp_async_commit();
  if (t_begin + 1 < t_end) load_k(t_begin + 1);
  if (any) load_v(t_begin);
  cp_async_commit();
  // P V of the first step reads K(t_begin) in place of a V: P = 0 there
  uint32_t pa_v = sbase + kQBytes;

  // Step t issues S of tile t and P V of tile t - 1 together, so P V runs
  // on the tensor cores under tile t's softmax; step t_end only drains the
  // last P V.  No wgmma, commit or wait sits in a branch: a CTA that drops
  // tile t discards its S and feeds P = 0 to the next P V.
  for (int t = t_begin; any && t <= t_end; ++t) {
    const uint32_t k_off = kQBytes + ((t - t_begin) & 1) * kTileBytes;
    cp_async_wait<1>();   // K(t) and V(t - 1) have landed
    fence_async_shared();
    __syncthreads();

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {   // S = Q K^T, zero past D
      const uint32_t blk = kk >> 2, off = (kk & 3) * 32;
      const uint64_t da = descriptor(
          sbase + blk * kRows * 128 + off, 16, kAtom);
      const uint64_t db = descriptor(
          sbase + k_off + blk * kKeys * 128 + off, 16, kAtom);
      wgmma_ss<T>(s, da, db, kk > 0);
    }
    wgmma_commit();
    issue_pv<T, DP, kTerms>(acc, pa, pa_v);
    wgmma_wait<1>();   // S is done; P V may still run
    fence_regs(s);

    const bool active = w_begin <= t && t < w_end;
    float alpha[2] = {1.f, 1.f};
    if (active) {
      // online softmax; s[4 j + 2 i + c] is row qpos0 + 8 i, key
      // key0 + 8 j + kcol + c
      const int key0 = t * kKeys;
      const bool edge = (causal && key0 + kKeys - 1 > wg_first) ||
                        (has_window && key0 <= wg_last - window) ||
                        key0 + kKeys > tk;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qpos = qpos0 + 8 * i;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = s[4 * j + 2 * i + c] * scale_log2;
            if (edge) {
              const int kpos = key0 + 8 * j + kcol + c;
              bool visible = true;
              if (causal) visible = kpos <= qpos;
              if (has_window) visible = visible && kpos > qpos - window;
              // a key past Tk does not exist: -inf gives p = 0 and no max
              x = kpos >= tk ? kMinusInf : visible ? x : kNegInf;
            }
            s[4 * j + 2 * i + c] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        alpha[i] = fast_exp2(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = fast_exp2(s[4 * j + 2 * i + c] - m_new);
            s[4 * j + 2 * i + c] = kHalf ? p * kHalfScale : p;
            sum += p;
          }
        l[i] = l[i] * alpha[i] + sum;   // this thread's keys; summed at the end
      }
    }
    wgmma_wait<0>();   // P V is done: acc and pa are free
    fence_regs(acc);
    fence_regs(s);     // the new terms are made after P V read the old
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * j + 2 * i] *= alpha[i];
        acc[4 * j + 2 * i + 1] *= alpha[i];
      }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x0 = active ? s[8 * kk + 2 * r] : 0.f;
        float x1 = active ? s[8 * kk + 2 * r + 1] : 0.f;
#pragma unroll
        for (int term = 0; term < kTerms; ++term)
          pa[term][kk][r] = take_term<T>(x0, x1);
      }
    pa_v = sbase + kQBytes + (2 + ((t - t_begin) & 1)) * kTileBytes;
    __syncthreads();   // K(t) and V(t - 1) are consumed: refill their slots
    if (t + 2 < t_end) load_k(t + 2);
    if (t + 1 < t_end) load_v(t + 1);
    cp_async_commit();
  }

  // epilogue: acc / (l == 0 ? 1 : l), rounded once, staged in shared memory
  // (every product is done) and stored 16 bytes at a time
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  T* stage = reinterpret_cast<T*>(smem);
  const float unscale = kHalf ? 1.f / kHalfScale : 1.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + (lane >> 2) + 8 * i;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      store_pair(stage + r * kLdo + 8 * j + kcol,
                 acc[4 * j + 2 * i] * unscale / denom,
                 acc[4 * j + 2 * i + 1] * unscale / denom);
  }
  __syncthreads();
  T* out = o + ((static_cast<int64_t>(b) * hq + h) * tq + row0) * dim;
  const int rows = min(kRows, tq - row0);
  if ((dim & 7) == 0) {
    const int chunks = dim >> 3;
    for (int e = tid; e < rows * chunks; e += kThreads) {
      const int r = e / chunks, c = e - r * chunks;
      *reinterpret_cast<uint4*>(out + static_cast<int64_t>(r) * dim + 8 * c) =
          *reinterpret_cast<const uint4*>(stage + r * kLdo + 8 * c);
    }
  } else {
    for (int e = tid; e < rows * dim; e += kThreads) {
      const int r = e / dim, c = e - r * dim;
      out[static_cast<int64_t>(r) * dim + c] = stage[r * kLdo + c];
    }
  }
}

// 16-byte copies are possible: unit column stride, D and the other strides
// multiples of 8 elements, a 16-byte aligned base
bool vectorizable(const void* p, const int64_t* s, int dim) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s[3] == 1 &&
         dim % 8 == 0 && s[0] % 8 == 0 && s[1] % 8 == 0 && s[2] % 8 == 0;
}

template <typename T, int DP>
int launch(const void* q, const int64_t* qs, const void* k, const int64_t* ks,
           const void* v, const int64_t* vs, void* o, int batch, int hq,
           int hkv, int tq, int tk, int dim, int bq, int bk, float scale,
           int causal, int has_window, int window, cudaStream_t stream) {
  constexpr size_t smem =
      kAtom + kRows * DP * 2 + 4 * kKeys * DP * 2;
  auto kernel = flash_fwd_wgmma_kernel<T, DP>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  const int vec = vectorizable(q, qs, dim) && vectorizable(k, ks, dim) &&
                  vectorizable(v, vs, dim);
  const float scale_log2 =
      static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  const dim3 grid((tq + kRows - 1) / kRows, hq, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), Strides{qs[0], qs[1], qs[2], qs[3]},
      static_cast<const uint16_t*>(k), Strides{ks[0], ks[1], ks[2], ks[3]},
      static_cast<const uint16_t*>(v), Strides{vs[0], vs[1], vs[2], vs[3]},
      static_cast<T*>(o), hq, hq / hkv, tq, tk, dim, bq, bk, scale_log2,
      causal, has_window, window, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const void* q, const int64_t* qs, const void* k,
               const int64_t* ks, const void* v, const int64_t* vs, void* o,
               int batch, int hq, int hkv, int tq, int tk, int dim, int bq,
               int bk, float scale, int causal, int has_window, int window,
               cudaStream_t stream) {
  if (dim <= 64)
    return launch<T, 64>(q, qs, k, ks, v, vs, o, batch, hq, hkv, tq, tk, dim,
                         bq, bk, scale, causal, has_window, window, stream);
  if (dim <= 128)
    return launch<T, 128>(q, qs, k, ks, v, vs, o, batch, hq, hkv, tq, tk,
                          dim, bq, bk, scale, causal, has_window, window,
                          stream);
  if (dim <= 192)
    return launch<T, 192>(q, qs, k, ks, v, vs, o, batch, hq, hkv, tq, tk,
                          dim, bq, bk, scale, causal, has_window, window,
                          stream);
  return launch<T, 256>(q, qs, k, ks, v, vs, o, batch, hq, hkv, tq, tk, dim,
                        bq, bk, scale, causal, has_window, window, stream);
}

}  // namespace

extern "C" {

const char* attention_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// o = attention(q, k, v) for dtype 1 = float16, 2 = bfloat16; each stride
// array is (batch, head, position, feature) in elements; o is contiguous.
// bq, bk: the reference's tiles (min(128, T)); the window applies when
// has_window is nonzero.  Returns the CUDA error (0 on success).
int attention_wgmma_forward(int dtype, const void* q,
                            const int64_t* q_strides, const void* k,
                            const int64_t* k_strides, const void* v,
                            const int64_t* v_strides, void* o, int batch,
                            int hq, int hkv, int tq, int tk, int dim, int bq,
                            int bk, float scale, int causal, int has_window,
                            int window, int device, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || tq < 1 || tk < 1 ||
      dim < 1 || dim > 256 || batch > 65535 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_dim<__half>(q, q_strides, k, k_strides, v, v_strides, o,
                                batch, hq, hkv, tq, tk, dim, bq, bk, scale,
                                causal, has_window, window, s);
    case 2:
      return launch_dim<__nv_bfloat16>(q, q_strides, k, k_strides, v,
                                       v_strides, o, batch, hq, hkv, tq, tk,
                                       dim, bq, bk, scale, causal, has_window,
                                       window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
