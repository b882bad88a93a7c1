// Fused Krylov vector kernels for Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/krylov_fused.py:
//   * fused_cg_update      (x + a p, r - a Ap, <r', r'> in one pass)
//   * fused_pipelined_dots (<r,u>, <w,u>, <r,r> in one read)
//   * fused_gram           (G = V V^T of a (k, n) row-stack in one read)
//
// Bound: the three kernels are memory-bound at the Krylov paths' shapes.
// Every vector element costs 4 bytes per stream and at most two flops per
// stream, far below the H100's ~20 flops per byte, so the least time is the
// bytes moved over 3.35 TB/s (H100 SXM):
//   fused_cg_update:      4 streams read + 2 written = 24 n bytes
//   fused_pipelined_dots: 3 streams read             = 12 n bytes
//   fused_gram:           k rows read                = 4 k n bytes, against
//                         2 k^2 n flops: k / 2 flops a byte, so bytes bound
//                         it up to k ~ 40 (k = 2s + 1 or s + 1 on the path)
// The design meets the bound with a single pass and no intermediate
// vectors: each element is read once and each output written once, and the
// reductions ride along in registers.
//
// Determinism: no sum uses atomics.  Each block writes its partial sums (a
// shared-memory tree with a fixed shape) into a partials buffer.
// fused_pipelined_dots then sums the partials in a second launch, in a
// fixed order.  fused_cg_update and fused_gram (k <= 16) do both in one
// launch: each block takes a ticket after its partials (release / acquire),
// and the block that takes the last one sums every block's partials in a
// fixed order and sets the ticket back to 0.  The ticket picks that block,
// never the order of a sum.  The ticket and the partials live in a
// workspace the wrapper keeps for each stream.  The grids depend only on
// the shape, so reruns give bitwise-identical results.
//
// fused_cg_update at the dense main path's n = 16384 is 64 blocks of one
// element a thread, a few microseconds of device work: the host's work a
// call sets its time, so it is one launch (the last block sums the
// partials exactly as the second launch sum_partials_kernel<1> did: thread
// t adds partials t, t + 256, ... in index order, then the same tree), and
// its wrapper allocates only what it returns.
//
// The TPU kernels' zero pad to a multiple of 8x128 was a tiling need; here a
// grid-stride loop with an `i < n` bound covers any n (and any k for the
// Gram matrix).
//
// The step length alpha is read from device memory, so the host never has
// to read it back (no synchronisation per iteration).
//
// fused_gram: the TPU kernel carried a (k, k) sum in VMEM over a sequential
// grid of column chunks.  For the s-step path's k (5 and 9; any k <= 16)
// one launch streams V from device memory straight into registers: a
// thread takes 4 columns (a quad) of every row as 16-byte loads, one to
// four quads in flight, and accumulates the upper triangle of G over its
// quads t, t + P, ... (P threads in the grid); the grid has one block per
// 256 quads up to two blocks an SM (one above k = 10, where k(k + 1) / 2
// sums and k float4 fill the registers), so an SM keeps 40-70 KB of V in
// flight.  A block sums its threads by a fixed shuffle tree in each warp
// and its warps in order, writes its partial triangle, and takes a ticket
// (release / acquire); the block with the last ticket sums the partials
// in block order through shared memory, mirrors G (exactly symmetric) and
// sets the ticket back to 0.  The ticket lives in a workspace the wrapper
// keeps for each stream.  A larger k keeps the staged kernel: a block
// stages a chunk of up to 1024 columns of V into shared memory (coalesced
// 16-byte loads, four in flight per thread) and its threads accumulate
// 4 x 4 register micro-tiles of G's upper triangle over the chunk's
// columns: for k <= 32 one tile of G covers all of it and V is read once;
// a larger k is cut into 32-row tiles, one blockIdx.y per pair of tiles
// (I <= J), and V is read ceil(k / 32) times (there the kernel is bound by
// its flops).  The block's threads split the chunk's columns into `lanes`
// and sum the lanes of each micro-tile in a fixed order; each block writes
// its upper triangle to its own slot of the partials buffer, and a second
// launch sums the slots (a warp per entry, lanes in a fixed order, then a
// fixed shuffle tree) and mirrors the sum into G's lower triangle.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // threads per block, a power of two
constexpr int kMaxBlocks = 1024; // size of the partials buffer per sum

// Sums K values per thread across the block with a fixed-shape tree; the
// block's sums end in sh[k][0].
template <int K>
__device__ __forceinline__ void block_tree_sum(float (&sh)[K][kThreads],
                                               const float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) sh[k][threadIdx.x] = v[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
#pragma unroll
      for (int k = 0; k < K; ++k) sh[k][threadIdx.x] += sh[k][threadIdx.x + s];
    }
    __syncthreads();
  }
}

// Takes a ticket (acq_rel, GPU scope) after the block's writes are fenced;
// true in every thread of the block that took the last one.
__device__ __forceinline__ bool last_block(unsigned* ticket) {
  __shared__ int last;
  if (threadIdx.x == 0) {
    __threadfence();
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
                 : "=r"(prev) : "l"(ticket), "r"(1u) : "memory");
    last = prev == gridDim.x - 1;
  }
  __syncthreads();
  return last;
}

// One launch: xo, ro and the block's partial of <ro, ro> into
// partials[blockIdx.x]; the block with the last ticket sums the partials
// into rr as sum_partials_kernel<1> does (thread t: partials t, t + 256,
// ... in index order; then block_tree_sum) and sets the ticket back to 0.
__global__ void __launch_bounds__(kThreads)
cg_update_kernel(const float* __restrict__ x, const float* __restrict__ r,
                 const float* __restrict__ p, const float* __restrict__ ap,
                 const float* __restrict__ alpha, float* __restrict__ xo,
                 float* __restrict__ ro, float* __restrict__ partials,
                 unsigned* ticket, float* __restrict__ rr, int64_t n) {
  __shared__ float sh[1][kThreads];
  const float a = *alpha;
  float acc[1] = {0.f};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    // rounded product then rounded sum, as the plain version computes them
    const float xn = __fadd_rn(x[i], __fmul_rn(a, p[i]));
    const float rn = __fsub_rn(r[i], __fmul_rn(a, ap[i]));
    xo[i] = xn;
    ro[i] = rn;
    acc[0] = fmaf(rn, rn, acc[0]);
  }
  block_tree_sum<1>(sh, acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = sh[0][0];
  if (!last_block(ticket)) return;

  __threadfence();
  if (threadIdx.x == 0) *ticket = 0;
  float sum[1] = {0.f};
  for (int j = threadIdx.x; j < static_cast<int>(gridDim.x); j += kThreads)
    sum[0] += __ldcg(partials + j);
  block_tree_sum<1>(sh, sum);
  if (threadIdx.x == 0) *rr = sh[0][0];
}

__global__ void __launch_bounds__(kThreads)
pipelined_dots_kernel(const float* __restrict__ r, const float* __restrict__ u,
                      const float* __restrict__ w, float* __restrict__ partials,
                      int64_t n) {
  __shared__ float sh[3][kThreads];
  float acc[3] = {0.f, 0.f, 0.f};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float ri = r[i], ui = u[i], wi = w[i];
    acc[0] = fmaf(ri, ui, acc[0]);
    acc[1] = fmaf(wi, ui, acc[1]);
    acc[2] = fmaf(ri, ri, acc[2]);
  }
  block_tree_sum<3>(sh, acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) partials[k * gridDim.x + blockIdx.x] = sh[k][0];
  }
}

// One block: out[k] = sum of partials[k * nparts .. (k + 1) * nparts), each
// thread striding over the partials in index order, then the fixed tree.
template <int K>
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, int nparts,
                    float* __restrict__ out) {
  __shared__ float sh[K][kThreads];
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    acc[k] = 0.f;
    for (int j = threadIdx.x; j < nparts; j += kThreads)
      acc[k] += partials[k * nparts + j];
  }
  block_tree_sum<K>(sh, acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = sh[k][0];
  }
}

// ---- fused_gram ----------------------------------------------------------

constexpr int kTileRows = 32;        // rows of V in one tile of G
constexpr int kMicro = 4;            // register micro-tile: 4 x 4 entries of G
constexpr int kStage = 11264;        // floats of shared memory (44 KB)
constexpr int kMaxChunk = 1024;      // columns of V staged per step, at most
constexpr int kGramMaxBlocks = 264;  // column blocks: 2 per SM on an H100
constexpr int64_t kGramMaxPartials = int64_t(1) << 24;  // floats (64 MB)
constexpr int kLoadBatch = 4;        // 16-byte loads in flight per thread

__host__ __device__ inline int gram_ntiles(int k) {
  return (k + kTileRows - 1) / kTileRows;
}

// Rows of V a block stages: the micro-tile rows of its one tile (k <= 32)
// or of its two tiles (k > 32; the off-diagonal pairs hold the most).
__host__ __device__ inline int gram_staged_rows(int k) {
  return k <= kTileRows ? (k + kMicro - 1) / kMicro * kMicro : 2 * kTileRows;
}

// Columns of a staged chunk: a multiple of 32 whose rows, each padded by
// one float against bank conflicts, fit kStage floats.
__host__ __device__ inline int gram_chunk(int k) {
  const int w = (kStage / gram_staged_rows(k) - 1) / 32 * 32;
  return w < kMaxChunk ? w : kMaxChunk;
}

// The block's pair of 32-row tiles (ti <= tj): blockIdx.y counts the upper
// triangle of the ntiles x ntiles tile grid row by row.
__device__ __forceinline__ void tile_pair(int y, int ntiles, int& ti,
                                          int& tj) {
  ti = 0;
  while (y >= ntiles - ti) {
    y -= ntiles - ti;
    ++ti;
  }
  tj = ti + y;
}

// Micro-tile m of a tile pair as (p, q): row by row over p <= q on a
// diagonal tile (ga groups of 4 rows), p-major over ga x gb otherwise.
__device__ __forceinline__ void micro_tile(int m, bool diag, int ga, int gb,
                                           int& p, int& q) {
  if (diag) {
    p = 0;
    while (p < ga && m >= ga - p) {
      m -= ga - p;
      ++p;
    }
    q = p + m;
  } else {
    p = m / gb;
    q = m % gb;
  }
}

// Global row of staged row r, or -1 for a zero pad row.
__device__ __forceinline__ int staged_row(int r, int rows_a, int r0a, int ra,
                                          int r0b, int rb) {
  if (r < rows_a) return r < ra ? r0a + r : -1;
  r -= rows_a;
  return r < rb ? r0b + r : -1;
}

__global__ void __launch_bounds__(kThreads)
gram_partials_kernel(const float* __restrict__ v, int k, int64_t n,
                     int ntiles, int vec4, float* __restrict__ partials) {
  __shared__ float buf[kStage];
  const int w = gram_chunk(k), stride = w + 1;
  int ti, tj;
  tile_pair(blockIdx.y, ntiles, ti, tj);
  const bool diag = ti == tj;
  const int r0a = ti * kTileRows, r0b = tj * kTileRows;
  const int ra = min(kTileRows, k - r0a), rb = min(kTileRows, k - r0b);
  const int ga = (ra + kMicro - 1) / kMicro, gb = (rb + kMicro - 1) / kMicro;
  const int rows_a = ga * kMicro, rows = rows_a + (diag ? 0 : gb * kMicro);
  const int b_off = diag ? 0 : rows_a;           // tile J's first staged row
  const int nmicro = diag ? ga * (ga + 1) / 2 : ga * gb;
  const int lanes = kThreads / nmicro;           // >= 4: nmicro <= 64
  const int m = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const bool active = m < nmicro;
  int p = 0, q = 0;
  if (active) micro_tile(m, diag, ga, gb, p, q);

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  for (int64_t chunk = blockIdx.x; chunk * w < n; chunk += gridDim.x) {
    const int64_t col0 = chunk * w;
    const int cols = n - col0 < w ? static_cast<int>(n - col0) : w;
    __syncthreads();                             // the last chunk is used
    if (vec4) {
      // 16-byte loads (n % 4 == 0 and V 16-byte aligned), kLoadBatch of
      // them in flight before their values are stored
      const int wq = w / 4, total = rows * wq;
      for (int base = threadIdx.x; base < total;
           base += kThreads * kLoadBatch) {
        float4 x[kLoadBatch];
#pragma unroll
        for (int t = 0; t < kLoadBatch; ++t) {
          const int idx = base + t * kThreads;
          x[t] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (idx < total) {
            const int r = idx / wq, c = (idx % wq) * 4;
            const int g = staged_row(r, rows_a, r0a, ra, r0b, rb);
            if (g >= 0 && c < cols)
              x[t] = *reinterpret_cast<const float4*>(
                  v + static_cast<int64_t>(g) * n + col0 + c);
          }
        }
#pragma unroll
        for (int t = 0; t < kLoadBatch; ++t) {
          const int idx = base + t * kThreads;
          if (idx < total) {
            float* dst = buf + (idx / wq) * stride + (idx % wq) * 4;
            dst[0] = x[t].x;
            dst[1] = x[t].y;
            dst[2] = x[t].z;
            dst[3] = x[t].w;
          }
        }
      }
    } else {
      for (int idx = threadIdx.x; idx < rows * w; idx += kThreads) {
        const int r = idx / w, c = idx % w;
        const int g = staged_row(r, rows_a, r0a, ra, r0b, rb);
        buf[r * stride + c] = (g >= 0 && c < cols)
            ? v[static_cast<int64_t>(g) * n + col0 + c] : 0.f;
      }
    }
    __syncthreads();
    if (active) {
      const float* pa = buf + p * kMicro * stride;
      const float* pb = buf + (b_off + q * kMicro) * stride;
      for (int c = lane; c < cols; c += lanes) {
        float a[kMicro], b[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) {
          a[i] = pa[i * stride + c];
          b[i] = pb[i * stride + c];
        }
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  // sum each micro-tile's lanes in lane order, through shared memory
  __syncthreads();
  if (active) {
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j)
        buf[threadIdx.x * kMicro * kMicro + i * kMicro + j] = acc[i][j];
  }
  __syncthreads();
  float* out = partials + static_cast<int64_t>(blockIdx.x) * k * k;
  for (int e = threadIdx.x; e < nmicro * kMicro * kMicro; e += kThreads) {
    const int mt = e / (kMicro * kMicro), ij = e % (kMicro * kMicro);
    int pp, qq;
    micro_tile(mt, diag, ga, gb, pp, qq);
    const int row = r0a + pp * kMicro + ij / kMicro;
    const int col = r0b + qq * kMicro + ij % kMicro;
    if (row >= k || col >= k || row > col) continue;
    float s = 0.f;
    for (int l = 0; l < lanes; ++l)
      s += buf[(mt * lanes + l) * kMicro * kMicro + ij];
    out[static_cast<int64_t>(row) * k + col] = s;
  }
}

// One warp per entry i <= j of G (row by row): lane l sums the blocks'
// partials l, l + 32, ... in order, a fixed shuffle tree sums the lanes,
// and the sum goes to G[i][j] and G[j][i].
__global__ void __launch_bounds__(kThreads)
gram_sum_kernel(const float* __restrict__ partials, int k, int nparts,
                float* __restrict__ g) {
  const int64_t kk = static_cast<int64_t>(k) * k;
  int64_t e = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (e >= static_cast<int64_t>(k) * (k + 1) / 2) return;  // whole warps
  int i = 0;
  while (e >= k - i) {
    e -= k - i;
    ++i;
  }
  const int64_t at = static_cast<int64_t>(i) * k + i + e;
  float s = 0.f;
  for (int x = lane; x < nparts; x += 32) s += partials[x * kk + at];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) {
    g[at] = s;
    g[(i + e) * static_cast<int64_t>(k) + i] = s;
  }
}

// ---- fused_gram for k <= kStreamMaxK: one streaming launch ---------------

constexpr int kStreamMaxK = 16;      // above it, the staged tiles above
constexpr int kStreamSMs = 132;      // an H100's SMs: the grid's unit
constexpr int kSmemOptIn = 32 * 1024;  // above it, ask for more shared memory

// Resident blocks an SM the register budget allows (k(k + 1) / 2 sums and
// k float4 a thread).
__host__ __device__ constexpr int stream_blocks_per_sm(int k) {
  return k <= 10 ? 2 : 1;
}

// Quads (4 columns) a thread loads before it multiplies: enough that a
// thread keeps 8 float4 of V in flight where k is small.
__host__ __device__ constexpr int stream_unroll(int k) {
  return k <= 2 ? 4 : k <= 5 ? 2 : 1;
}

// Blocks of the streaming Gram launch for a (k, n) V: one per 256 quads,
// at most stream_blocks_per_sm(k) an SM of an H100.  A function of (k, n)
// alone, so reruns sum in the same order.
int gram_stream_blocks(int k, int64_t n) {
  const int64_t quads = (n + 3) / 4;
  const int64_t cap = static_cast<int64_t>(stream_blocks_per_sm(k)) *
                      kStreamSMs;
  const int64_t b = (quads + kThreads - 1) / kThreads;
  return static_cast<int>(b < cap ? b : cap);
}

// Floats of a stream's Gram workspace: a 16-byte header whose first int
// is the ticket, then the largest blocks x k(k + 1) / 2 partials.
constexpr int64_t gram_work_floats() {
  int64_t most = 0;
  for (int k = 1; k <= kStreamMaxK; ++k) {
    const int64_t p = static_cast<int64_t>(stream_blocks_per_sm(k)) *
                      kStreamSMs * k * (k + 1) / 2;
    if (p > most) most = p;
  }
  return 4 + most;
}
static_assert(gram_work_floats() >= 4 + kMaxBlocks,
              "fused_cg_update's partials share the Gram workspace");

// Columns 4q .. 4q + 3 of row i (zeros past n, or for q past the last quad).
__device__ __forceinline__ float4 load_quad(const float* __restrict__ v,
                                            int i, int64_t q, int64_t n,
                                            int64_t quads, int vec4) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (q >= quads) return x;
  const float* p = v + i * n + 4 * q;
  if (vec4) return *reinterpret_cast<const float4*>(p);
  const int64_t left = n - 4 * q;
  x.x = p[0];
  if (left > 1) x.y = p[1];
  if (left > 2) x.z = p[2];
  if (left > 3) x.w = p[3];
  return x;
}

__device__ __forceinline__ float comp4(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// acc[(i, j)] += V[i, c] V[j, c] for i <= j (the upper triangle row by
// row), for the quad's columns c in order.
template <int K>
__device__ __forceinline__ void gram_quad(const float4 (&x)[K],
                                          float (&acc)[K * (K + 1) / 2]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int e = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float vi = comp4(x[i], c);
#pragma unroll
      for (int j = i; j < K; ++j, ++e)
        acc[e] = fmaf(vi, comp4(x[j], c), acc[e]);
    }
  }
}

// G = V V^T in one launch.  Thread t of the grid's P threads sums the
// quads t, t + P, t + 2P, ... of V in that order, reading each row's
// four columns as one 16-byte load (4-byte loads when n % 4 != 0 or V is
// not 16-byte aligned) with stream_unroll(K) quads in flight; a block sums
// its threads by a shuffle tree in each warp (offsets 16, 8, 4, 2, 1) and
// its warps in order 0 .. 7, and writes its k(k + 1) / 2 partials.  The
// block that takes the last ticket (release / acquire) sums the blocks'
// partials in block order, mirrors G and sets the ticket back to 0; the
// ticket picks that block, never the order of a sum.
template <int K>
__global__ void __launch_bounds__(kThreads, stream_blocks_per_sm(K))
gram_stream_kernel(const float* __restrict__ v, int64_t n, int vec4,
                   float* __restrict__ partials, unsigned* ticket,
                   float* __restrict__ g) {
  constexpr int T = K * (K + 1) / 2;
  constexpr int U = stream_unroll(K);
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float acc[T];
#pragma unroll
  for (int e = 0; e < T; ++e) acc[e] = 0.f;
  const int64_t quads = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
       q < quads; q += U * stride) {
    float4 x[U][K];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < K; ++i)
        x[u][i] = load_quad(v, i, q + u * stride, n, quads, vec4);
#pragma unroll
    for (int u = 0; u < U; ++u) gram_quad<K>(x[u], acc);
  }

  // the block's sums: a shuffle tree a warp, then the warps in order
#pragma unroll
  for (int e = 0; e < T; ++e) {
    float s = acc[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) sh[warp * T + e] = s;
  }
  __syncthreads();
  if (tid < T) {
    float s = sh[tid];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) s += sh[w * T + tid];
    partials[static_cast<int64_t>(blockIdx.x) * T + tid] = s;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) {
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
                 : "=r"(prev) : "l"(ticket), "r"(1u) : "memory");
    last = prev == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: every block's partials through shared memory (L2
  // reads), then each entry summed in block order
  __threadfence();
  if (tid == 0) *ticket = 0;
  const int total = gridDim.x * T;
  for (int e = tid; e < total; e += kThreads) sh[e] = __ldcg(partials + e);
  __syncthreads();
  if (tid < T) {
    float s = sh[tid];
    for (int b = 1; b < static_cast<int>(gridDim.x); ++b) s += sh[b * T + tid];
    int i = 0, e = tid;
    while (e >= K - i) {
      e -= K - i;
      ++i;
    }
    g[i * K + i + e] = s;
    g[(i + e) * K + i] = s;
  }
}

template <int K>
int launch_stream(const float* v, int64_t n, float* work, float* g,
                  cudaStream_t s) {
  constexpr int T = K * (K + 1) / 2;
  const int blocks = gram_stream_blocks(K, n);
  const int rows = blocks > kThreads / 32 ? blocks : kThreads / 32;
  const size_t smem = sizeof(float) * rows * T;
  auto kernel = gram_stream_kernel<K>;
  if (smem > kSmemOptIn) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
  }
  const int vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  kernel<<<blocks, kThreads, smem, s>>>(
      v, n, vec4, work + 4, reinterpret_cast<unsigned*>(work), g);
  return static_cast<int>(cudaGetLastError());
}

template <int K = 1>
int gram_stream(int k, const float* v, int64_t n, float* work, float* g,
                cudaStream_t s) {
  if constexpr (K > kStreamMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return k == K ? launch_stream<K>(v, n, work, g, s)
                  : gram_stream<K + 1>(k, v, n, work, g, s);
  }
}

int check_args(int device, int64_t n, int blocks) {
  if (n <= 0 || blocks <= 0 || blocks > kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

}  // namespace

extern "C" {

int krylov_threads() { return kThreads; }
int krylov_max_blocks() { return kMaxBlocks; }

const char* krylov_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xo = x + alpha p, ro = r - alpha ap, rr = <ro, ro> in one launch.  work
// is the stream's workspace (krylov_gram_work_floats floats, 16-byte
// aligned, ticket 0 between calls): its first int the ticket, `blocks`
// partials from float 4 on.  Returns the CUDA error of the launch (0 on
// success).
int krylov_fused_cg_update(const float* x, const float* r, const float* p,
                           const float* ap, const float* alpha, float* xo,
                           float* ro, float* work, float* rr, int64_t n,
                           int blocks, int device, void* stream) {
  int err = check_args(device, n, blocks);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cg_update_kernel<<<blocks, kThreads, 0, s>>>(
      x, r, p, ap, alpha, xo, ro, work + 4, reinterpret_cast<unsigned*>(work),
      rr, n);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3) = <r,u>, <w,u>, <r,r>.  partials holds 3 * `blocks` floats.
int krylov_fused_pipelined_dots(const float* r, const float* u, const float* w,
                                float* partials, float* out, int64_t n,
                                int blocks, int device, void* stream) {
  int err = check_args(device, n, blocks);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pipelined_dots_kernel<<<blocks, kThreads, 0, s>>>(r, u, w, partials, n);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  sum_partials_kernel<3><<<1, kThreads, 0, s>>>(partials, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

int krylov_gram_stream_max_k() { return kStreamMaxK; }

// Floats of a stream's Gram workspace (the ticket and the streaming
// launch's partials); the caller zeroes it once.
int64_t krylov_gram_work_floats() { return gram_work_floats(); }

// Blocks of the one-launch Gram kernel (k <= kStreamMaxK) for a (k, n) V,
// or 0 for a shape it does not take.
int krylov_gram_stream_blocks(int k, int64_t n) {
  return k <= 0 || k > kStreamMaxK || n <= 0 ? 0 : gram_stream_blocks(k, n);
}

// Column blocks of the staged Gram kernel's pass 1 (k > kStreamMaxK) for a
// (k, n) V: one per staged chunk of columns, at most kGramMaxBlocks, and
// few enough that the partials (blocks x k x k floats) stay within
// kGramMaxPartials.  A function of the shape alone, so reruns sum in the
// same order.
int krylov_gram_blocks(int k, int64_t n) {
  if (k <= 0 || n <= 0) return 0;
  const int64_t w = gram_chunk(k);
  const int64_t chunks = (n + w - 1) / w;
  const int64_t by_memory = kGramMaxPartials / (static_cast<int64_t>(k) * k);
  int64_t blocks = chunks < kGramMaxBlocks ? chunks : kGramMaxBlocks;
  if (by_memory < blocks) blocks = by_memory > 1 ? by_memory : 1;
  return static_cast<int>(blocks);
}

// g = v v^T for a contiguous (k, n) row-major v; g is (k, k), exactly
// symmetric.  For k <= kStreamMaxK one launch, on the stream's workspace
// `work` (krylov_gram_work_floats floats, 16-byte aligned, ticket 0
// between calls); above it the staged kernel and its sum, on `partials`
// (krylov_gram_blocks(k, n) * k * k floats).
int krylov_fused_gram(const float* v, float* work, float* partials, float* g,
                      int k, int64_t n, int device, void* stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= kStreamMaxK) {
    if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return gram_stream(k, v, n, work, g, s);
  }
  const int blocks = krylov_gram_blocks(k, n);
  const int ntiles = gram_ntiles(k);
  const int64_t pairs = static_cast<int64_t>(ntiles) * (ntiles + 1) / 2;
  if (partials == nullptr || pairs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  gram_partials_kernel<<<dim3(blocks, static_cast<unsigned>(pairs)), kThreads,
                         0, s>>>(v, k, n, ntiles, vec4, partials);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int64_t warps = static_cast<int64_t>(k) * (k + 1) / 2;
  gram_sum_kernel<<<static_cast<unsigned>((warps * 32 + kThreads - 1)
                                          / kThreads),
                    kThreads, 0, s>>>(partials, k, blocks, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
