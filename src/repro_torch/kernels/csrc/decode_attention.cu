// Flash-decode: one query token per batch row against a static KV cache,
// valid below the per-row length.
//
// Replaces: repro/kernels/decode_attention.py::decode_attention_pallas
// (_decode_kernel).
// Computes: out[b, hq] = softmax(q[b, hq] . K[b, :len, hq // G] * scale) V
// with an f32 online softmax (finite -1e30 sentinel, l clamped at 1e-30, so
// len = 0 gives exact zeros).
// Bound on the H100: bytes. Every valid cache row is read once (2 * len *
// Hkv * D * sizeof(T) bytes per batch row) for 4 * G * D flops per row,
// about G = 4 flops per byte in bf16 at llama3.2-1b's shapes: far below the
// card's ~295 flop/byte ridge.
// Design: one block per (batch row, KV head). The block holds the whole
// q-head group of its KV head (GQA) and walks the cache in tiles of kTileK
// rows up to lengths[b]: tiles past the length are never read, and each
// K/V tile is loaded once, coalesced, into shared memory and applied to all
// G query heads. Scores and the P.V update are plain f32 FMA loops; the
// per-head max/sum run one warp per head with shuffles. B * Hkv blocks
// (64 at 8 slots x 8 KV heads) fill under half of the 132 SMs; a split of
// the sequence with an LSE combine is the next step when decode attention
// shows up in the step time.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 64;
constexpr int kMaxAcc = 8;  // per-thread outputs: G * D <= kThreads * kMaxAcc

template <int D>
constexpr size_t smem_floats(int g) {
  return static_cast<size_t>(g) * D        // q (scaled, f32)
         + kTileK * (D + 1)                 // K tile, rows padded against bank conflicts
         + kTileK * D                       // V tile
         + static_cast<size_t>(g) * kTileK  // scores / probabilities
         + 3 * static_cast<size_t>(g);      // m, l, alpha
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lengths,
                        T* __restrict__ out, int S, int Hq, int Hkv, float scale) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  float* qs = smem;
  float* ks = qs + G * D;
  float* vs = ks + kTileK * (D + 1);
  float* ss = vs + kTileK * D;
  float* m_s = ss + G * kTileK;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, n_warps = kThreads / 32;
  // q[b, h*G + g, :] for g < G is one contiguous run of G * D elements
  const T* qb = q + (static_cast<long long>(b) * Hq + h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f32(qb[i]) * scale;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = REPRO_NEG_INF;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  const int len = min(max(lengths[b], 0), S);
  const long long row_stride = static_cast<long long>(Hkv) * D;  // between cache rows
  const T* kb = k + static_cast<long long>(b) * S * row_stride + h * D;
  const T* vb = v + static_cast<long long>(b) * S * row_stride + h * D;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTileK) {
    const int n = min(kTileK, len - t0);
    for (int i = tid; i < kTileK * D; i += kThreads) {
      const int j = i / D, dd = i % D;
      float kv = 0.f, vv = 0.f;
      if (j < n) {
        const long long off = (t0 + j) * row_stride + dd;
        kv = to_f32(kb[off]);
        vv = to_f32(vb[off]);
      }
      ks[j * (D + 1) + dd] = kv;
      vs[j * D + dd] = vv;
    }
    __syncthreads();
    for (int i = tid; i < G * kTileK; i += kThreads) {
      const int g = i / kTileK, j = i % kTileK;
      float s = REPRO_NEG_INF;
      if (j < n) {
        s = 0.f;
        const float* qr = qs + g * D;
        const float* kr = ks + j * (D + 1);
#pragma unroll 16
        for (int dd = 0; dd < D; ++dd) s = fmaf(qr[dd], kr[dd], s);
      }
      ss[i] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += n_warps) {
      float* row = ss + g * kTileK;
      float mx = REPRO_NEG_INF;
      for (int j = lane; j < kTileK; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kTileK; j += 32) {
        const float p = j < n ? expf(row[j] - m_new) : 0.f;
        row[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        a_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < G * D) {
        const int g = idx / D, dd = idx % D;
        const float* p = ss + g * kTileK;
        float pv = 0.f;
        for (int j = 0; j < n; ++j) pv = fmaf(p[j], vs[j * D + dd], pv);
        acc[i] = acc[i] * a_s[g] + pv;
      }
    }
    __syncthreads();
  }

  T* ob = out + (static_cast<long long>(b) * Hq + h * G) * D;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < G * D) {
      const int g = idx / D;
      ob[idx] = from_f32<T>(acc[i] / fmaxf(l_s[g], REPRO_L_MIN));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
           int B, int S, int Hq, int Hkv, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G * D > kThreads * kMaxAcc) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t bytes = smem_floats<D>(G) * sizeof(float);
  auto kern = decode_attention_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(B * Hkv), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, static_cast<T*>(out), S, Hq, Hkv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int* lengths, void* out,
               int B, int S, int Hq, int Hkv, int D, float scale, cudaStream_t s) {
  if (D == 64) return launch<T, 64>(q, k, v, lengths, out, B, S, Hq, Hkv, scale, s);
  if (D == 128) return launch<T, 128>(q, k, v, lengths, out, B, S, Hq, Hkv, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int decode_attention_launch(int dtype, const void* q, const void* k,
                                       const void* v, const void* lengths, void* out,
                                       int B, int S, int Hq, int Hkv, int D, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == REPRO_DTYPE_F32)
    return dispatch_d<float>(q, k, v, len, out, B, S, Hq, Hkv, D, scale, s);
  if (dtype == REPRO_DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, len, out, B, S, Hq, Hkv, D, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
