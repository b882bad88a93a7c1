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
// reductions ride along in registers.  Vectorised loads, grid tuning and
// CUDA graphs are left for later work.
//
// Determinism: the reductions use no atomics.  Pass 1 writes one partial
// sum per block (a shared-memory tree with a fixed shape) into a partials
// buffer; pass 2 sums the partials in a fixed order.  The grid depends only
// on the shape, so reruns give bitwise-identical results.
//
// The TPU kernels' zero pad to a multiple of 8x128 was a tiling need; here a
// grid-stride loop with an `i < n` bound covers any n (and any k for the
// Gram matrix).
//
// The step length alpha is read from device memory, so the host never has
// to read it back (no synchronisation per iteration).
//
// fused_gram: the TPU kernel carried a (k, k) sum in VMEM over a sequential
// grid of column chunks.  Here a block stages a chunk of up to 1024 columns
// of V into shared memory (coalesced 16-byte loads, four in flight per
// thread, each element read from device memory once) and its threads
// accumulate 4 x 4 register micro-tiles of G's upper triangle over the
// chunk's columns: for k <= 32 one tile of G covers all of it and V is read
// once; a larger k is cut into 32-row tiles, one blockIdx.y per pair of
// tiles (I <= J), and V is read ceil(k / 32) times (there the kernel is
// bound by its flops).  The block's threads split the chunk's columns into
// `lanes` and sum the lanes of each micro-tile in a fixed order; each block
// writes its upper triangle to its own slot of the partials buffer, and
// pass 2 sums the slots (a warp per entry, lanes in a fixed order, then a
// fixed shuffle tree) and mirrors the sum into G's lower triangle, so G is
// exactly symmetric.

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

__global__ void __launch_bounds__(kThreads)
cg_update_kernel(const float* __restrict__ x, const float* __restrict__ r,
                 const float* __restrict__ p, const float* __restrict__ ap,
                 const float* __restrict__ alpha, float* __restrict__ xo,
                 float* __restrict__ ro, float* __restrict__ partials,
                 int64_t n) {
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

// xo = x + alpha p, ro = r - alpha ap, rr = <ro, ro>.  partials holds
// `blocks` floats.  Returns the CUDA error of the launches (0 on success).
int krylov_fused_cg_update(const float* x, const float* r, const float* p,
                           const float* ap, const float* alpha, float* xo,
                           float* ro, float* partials, float* rr, int64_t n,
                           int blocks, int device, void* stream) {
  int err = check_args(device, n, blocks);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cg_update_kernel<<<blocks, kThreads, 0, s>>>(x, r, p, ap, alpha, xo, ro,
                                               partials, n);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  sum_partials_kernel<1><<<1, kThreads, 0, s>>>(partials, blocks, rr);
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

// Column blocks of the Gram matrix's pass 1 for a (k, n) V: one per staged
// chunk of columns, at most kGramMaxBlocks, and few enough that the
// partials (blocks x k x k floats) stay within kGramMaxPartials.  A
// function of the shape alone, so reruns sum in the same order.
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
// symmetric.  partials holds blocks * k * k floats.
int krylov_fused_gram(const float* v, float* partials, float* g, int k,
                      int64_t n, int blocks, int device, void* stream) {
  const int ntiles = gram_ntiles(k);
  const int64_t pairs = static_cast<int64_t>(ntiles) * (ntiles + 1) / 2;
  if (k <= 0 || n <= 0 || blocks <= 0 || blocks > kGramMaxBlocks
      || pairs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  const int vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
