// Flash-attention forward pass for Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/attention.py
// (flash_attention): softmax attention with an online softmax (running max
// m, running sum l and accumulator acc over the kv axis), grouped-query heads,
// causal masking with the query ends aligned to the key ends (q_offset =
// Tk - Tq), an optional sliding window, fully masked tiles skipped and a zero
// denominator guarded.  q is (B, Hq, Tq, D), k and v (B, Hkv, Tk, D), any
// strides; o is a new contiguous (B, Hq, Tq, D) tensor in q's dtype.  The
// kernel is a template over the input type, computed in float32, D <= 256;
// only its float32 instantiation is launched: bf16 and fp16 inputs go to the
// tensor-core kernel of attention_wgmma.cu.
//
// The TPU kernel walks a (B, Hq, Tq/bq, Tk/bk) grid whose last axis is
// sequential, carrying (m, l, acc) in VMEM scratch.  Here one CTA of 256
// threads owns 64 query rows of one (batch, head) and loops over the keys
// itself, 64 at a time:
//   * the query tile is staged once in shared memory as float32, and each
//     key tile, then the same tile's values, in one shared buffer (85 KB of
//     shared memory at D = 128, so two CTAs fit on an SM);
//   * thread (ty, tx) of a 16 x 16 grid owns query rows 4ty..4ty+3: the
//     scores of keys tx + 16j (j < 4), and output columns 4tx + 64c .. + 3;
//     a row's 16 threads share its max and sum by shuffles;
//   * m, l and acc stay in registers across the key loop; every product is
//     a float32 FMA (the Pallas kernel computes both products in float32,
//     so no TF32 and no rounding of p to bf16);
//   * the kv head is h / (Hq / Hkv): nothing is repeated.
// The reference's semantics are kept where they are visible: masked scores
// are the finite -1e30 (not -inf), so a row that is fully masked inside a
// live tile gets p = 1 for its masked keys and, if it never meets a visible
// key, returns the mean of those values; the tile skip uses the reference's
// tiles (bq = min(128, Tq), bk = min(128, Tk)), so which keys such a row
// averages, and which rows return 0 (every tile skipped), is the reference's;
// the output is acc / (l == 0 ? 1 : l).
//
// Bound: at the serving shapes, operations.  4 D flops per visible (query,
// key) pair and head against 2 D (Tq + 2 Tk) bytes a head in bf16: about T
// flops per byte, far above the H100's ~295 (bf16 tensor cores) or 20
// (float32 outside them) flops a byte for T >= 2048.  This kernel runs on the
// float32 pipes (67 TFLOP/s), not the tensor cores (989 TFLOP/s bf16), which
// attention_wgmma.cu uses for 16-bit inputs.
//
// Determinism: no atomics; each CTA owns its output rows and sums in a fixed
// order, so reruns are bitwise equal.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;        // query rows of a CTA
constexpr int kKeys = 64;        // keys of a shared-memory tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPLd = kKeys + 4;  // row stride of the probability tile
constexpr float kNegInf = -1e30f;  // the reference's _NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  int64_t b, h, t, d;
};

// rows [row0, row0 + 64) of one (batch, head) slab into a float32 tile of
// row stride ld; rows >= limit and columns >= dim are zero
template <typename T, int LD>
__device__ __forceinline__ void stage(float* tile, const T* slab, Strides s,
                                      int row0, int limit, int dim) {
  constexpr int kCols = LD - 4;
  for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
    const int r = e / kCols, c = e % kCols;
    float x = 0.f;
    if (row0 + r < limit && c < dim)
      x = to_float(slab[(int64_t)(row0 + r) * s.t + (int64_t)c * s.d]);
    tile[r * LD + c] = x;
  }
}

// NC: float4 column groups of 64 a thread owns, D <= 64 NC
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, NC <= 2 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, Strides qs, const T* __restrict__ k,
                 Strides ks, const T* __restrict__ v, Strides vs,
                 T* __restrict__ o, int hq, int group, int tq, int tk, int dim,
                 int bq, int bk, float scale, int causal, int has_window,
                 int window) {
  constexpr int LD = 64 * NC + 4;  // float4-aligned; LD % 32 == 4: no bank
                                   // conflicts on the key-row reads
  extern __shared__ __align__(16) float smem[];
  float* q_tile = smem;                   // [kRows][LD]
  float* kv_tile = q_tile + kRows * LD;   // [kKeys][LD], keys then values
  float* p_tile = kv_tile + kKeys * LD;   // [kRows][kPLd]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int row0 = blockIdx.x * kRows;
  const int q_offset = tk - tq;
  const int dim4 = (dim + 3) & ~3;

  const T* q_slab = q + b * qs.b + h * qs.h;
  const T* k_slab = k + b * ks.b + hk * ks.h;
  const T* v_slab = v + b * vs.b + hk * vs.h;
  stage<T, LD>(q_tile, q_slab, qs, row0, tq, dim);

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

  for (int key0 = 0; key0 < tk; key0 += kKeys) {
    const int first_k = (key0 / bk) * bk;
    if (causal && first_k > last_q) break;  // every later tile is dead too
    if (has_window && first_k + bk - 1 <= first_q - window) continue;

    __syncthreads();  // the previous tile's values are consumed
    stage<T, LD>(kv_tile, k_slab, ks, key0, tk, dim);
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
        // keys past Tk do not exist: p = 0 (the reference tiles Tk exactly)
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
    stage<T, LD>(kv_tile, v_slab, vs, key0, tk, dim);
    __syncthreads();  // values and probabilities are in place

    for (int kk = 0; kk < kKeys; kk += 4) {
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
    T* out = o + (((int64_t)b * hq + h) * tq + r) * dim;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * c + e;
        if (col < dim) out[col] = from_float<T>(acc[i][4 * c + e] / denom);
      }
  }
}

template <typename T, int NC>
int launch(const void* q, const int64_t* qs, const void* k, const int64_t* ks,
           const void* v, const int64_t* vs, void* o, int batch, int hq,
           int hkv, int tq, int tk, int dim, int bq, int bk, float scale,
           int causal, int has_window, int window, cudaStream_t stream) {
  constexpr int LD = 64 * NC + 4;
  const size_t smem = sizeof(float) * (2 * kRows * LD + kRows * kPLd);
  auto kernel = flash_fwd_kernel<T, NC>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  const dim3 grid((tq + kRows - 1) / kRows, hq, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), Strides{qs[0], qs[1], qs[2], qs[3]},
      static_cast<const T*>(k), Strides{ks[0], ks[1], ks[2], ks[3]},
      static_cast<const T*>(v), Strides{vs[0], vs[1], vs[2], vs[3]},
      static_cast<T*>(o), hq, hq / hkv, tq, tk, dim, bq, bk, scale, causal,
      has_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const void* q, const int64_t* qs, const void* k,
               const int64_t* ks, const void* v, const int64_t* vs, void* o,
               int batch, int hq, int hkv, int tq, int tk, int dim, int bq,
               int bk, float scale, int causal, int has_window, int window,
               cudaStream_t stream) {
  if (dim <= 64)
    return launch<T, 1>(q, qs, k, ks, v, vs, o, batch, hq, hkv, tq, tk, dim,
                        bq, bk, scale, causal, has_window, window, stream);
  if (dim <= 128)
    return launch<T, 2>(q, qs, k, ks, v, vs, o, batch, hq, hkv, tq, tk, dim,
                        bq, bk, scale, causal, has_window, window, stream);
  if (dim <= 192)
    return launch<T, 3>(q, qs, k, ks, v, vs, o, batch, hq, hkv, tq, tk, dim,
                        bq, bk, scale, causal, has_window, window, stream);
  return launch<T, 4>(q, qs, k, ks, v, vs, o, batch, hq, hkv, tq, tk, dim, bq,
                      bk, scale, causal, has_window, window, stream);
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
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || tq < 1 || tk < 1 ||
      dim < 1 || dim > 256 || batch > 65535 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dim<float>(q, q_strides, k, k_strides, v, v_strides, o,
                               batch, hq, hkv, tq, tk, dim, bq, bk, scale,
                               causal, has_window, window, s);
    default:   // bfloat16 and float16 go to attention_wgmma.cu
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
