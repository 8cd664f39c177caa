// FlashAttention-2 forward with explicit position masks, GQA-native.
//
// Replaces: repro/kernels/flash_attention.py::flash_attention_pallas
// (_flash_kernel).
// Computes: out[b, t, hq] = softmax_j(q[b, t, hq] . k[b, j, hq // G] * scale
// where ok(t, j)) v[b, j, hq // G], with ok = k_valid[b, j] and, when asked,
// k_pos[b, j] <= q_pos[b, t] (causal) and k_pos[b, j] > q_pos[b, t] - window.
// The online softmax runs in f32 with the finite -1e30 sentinel and the
// max(l, 1e-30) clamp, so a fully masked query row gives exact zeros.
// Bound on the H100: at the served prefill shapes (B = 1, T = prompt pad
// <= 256, Hq = 32, Hkv = 8, D = 64, causal) the work is ~T^2/2 * Hq * 4D
// flops over ~T * (Hq + 2 Hkv) * D * 2 bytes: about 30 flop/byte, below the
// bf16 ridge, so bytes bound it in principle; in practice a kernel this
// small is bound by its own f32 FMA loops and launch latency.
// Design: one 256-thread block per (query tile, batch row x KV head). The
// block holds the G query heads of its KV head for kMaxRows / G positions
// (64 query rows), and walks the keys in tiles of kTileK: it first loads
// the tile's positions and validity and skips the tile when no (query, key)
// pair of it is unmasked (causal tile skipping, as the Pallas kernel's
// pl.when), else loads K and V once into shared memory, computes scores and
// the P.V update with f32 FMA loops, and keeps the running max/sum per row.
// mma.sync / wgmma, TMA and warp specialisation are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 64;
constexpr int kMaxRows = 64;  // query rows per block: (positions per tile) x G

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kMaxRows) * D  // q (scaled)
                          + kTileK * (D + 1)                  // K tile (padded rows)
                          + kTileK * D                        // V tile
                          + kMaxRows * kTileK                 // scores / probabilities
                          + 3 * kMaxRows)                     // m, l, alpha
         + sizeof(int) * (kMaxRows + 2 * kTileK);             // q_pos, k_pos, k_valid
}

__device__ __forceinline__ bool allowed(int qp, int kp, int kv, int causal, int window) {
  return kv && (!causal || kp <= qp) && (window < 0 || kp > qp - window);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos,
                       const unsigned char* __restrict__ k_valid, T* __restrict__ out,
                       int Tq, int Tk, int Hq, int Hkv, int causal, int window,
                       float scale) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int bq = kMaxRows / G;        // query positions per block
  const int rows = bq * G;            // query rows per block (<= kMaxRows)
  const int b = blockIdx.y / Hkv;
  const int h = blockIdx.y % Hkv;
  const int t_lo = blockIdx.x * bq;
  const int nq = min(bq, Tq - t_lo);  // live query positions in this tile

  float* qs = smem;
  float* ks = qs + kMaxRows * D;
  float* vs = ks + kTileK * (D + 1);
  float* ss = vs + kTileK * D;
  float* m_s = ss + kMaxRows * kTileK;
  float* l_s = m_s + kMaxRows;
  float* a_s = l_s + kMaxRows;
  int* qp_s = reinterpret_cast<int*>(a_s + kMaxRows);
  int* kp_s = qp_s + kMaxRows;
  int* kv_s = kp_s + kTileK;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, n_warps = kThreads / 32;
  const long long q_row = static_cast<long long>(Hq) * D;   // between positions
  const long long kv_row = static_cast<long long>(Hkv) * D;
  // row r of the block is (position t_lo + r / G, q head h * G + r % G); the
  // G heads of one position are one contiguous run of G * D elements
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, dd = i % D;
    const int t = r / G, g = r % G;
    float x = 0.f;
    if (t < nq)
      x = to_f32(q[(static_cast<long long>(b) * Tq + t_lo + t) * q_row +
                   (h * G + g) * D + dd]) * scale;
    qs[i] = x;
  }
  for (int t = tid; t < bq; t += kThreads)
    qp_s[t] = t < nq ? q_pos[static_cast<long long>(b) * Tq + t_lo + t] : 0;
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = REPRO_NEG_INF;
    l_s[r] = 0.f;
  }
  constexpr int kAcc = kMaxRows * D / kThreads;  // outputs per thread
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const T* kb = k + static_cast<long long>(b) * Tk * kv_row + h * D;
  const T* vb = v + static_cast<long long>(b) * Tk * kv_row + h * D;
  __syncthreads();

  for (int k0 = 0; k0 < Tk; k0 += kTileK) {
    const int nk = min(kTileK, Tk - k0);
    for (int j = tid; j < kTileK; j += kThreads) {
      const long long gj = static_cast<long long>(b) * Tk + k0 + j;
      kp_s[j] = j < nk ? k_pos[gj] : 0;
      kv_s[j] = j < nk ? (k_valid == nullptr ? 1 : static_cast<int>(k_valid[gj])) : 0;
    }
    __syncthreads();
    // tile skip: is any (query, key) pair of this tile unmasked?
    int any = 0;
    for (int i = tid; i < bq * kTileK; i += kThreads) {
      const int t = i / kTileK, j = i % kTileK;
      if (t < nq && allowed(qp_s[t], kp_s[j], kv_s[j], causal, window)) any = 1;
    }
    if (!__syncthreads_or(any)) continue;  // block-uniform

    for (int i = tid; i < kTileK * D; i += kThreads) {
      const int j = i / D, dd = i % D;
      float kx = 0.f, vx = 0.f;
      if (j < nk) {
        const long long off = (k0 + j) * kv_row + dd;
        kx = to_f32(kb[off]);
        vx = to_f32(vb[off]);
      }
      ks[j * (D + 1) + dd] = kx;
      vs[j * D + dd] = vx;
    }
    __syncthreads();
    for (int i = tid; i < rows * kTileK; i += kThreads) {
      const int r = i / kTileK, j = i % kTileK;
      const int t = r / G;
      float s = REPRO_NEG_INF;
      if (t < nq && allowed(qp_s[t], kp_s[j], kv_s[j], causal, window)) {
        s = 0.f;
        const float* qr = qs + r * D;
        const float* kr = ks + j * (D + 1);
#pragma unroll 16
        for (int dd = 0; dd < D; ++dd) s = fmaf(qr[dd], kr[dd], s);
      }
      ss[i] = s;
    }
    __syncthreads();
    for (int r = warp; r < rows; r += n_warps) {
      const int t = r / G;
      float* row = ss + r * kTileK;
      float mx = REPRO_NEG_INF;
      for (int j = lane; j < kTileK; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kTileK; j += 32) {
        const bool ok = t < nq && allowed(qp_s[t], kp_s[j], kv_s[j], causal, window);
        const float p = ok ? expf(row[j] - m_new) : 0.f;
        row[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        a_s[r] = a;
        l_s[r] = l_s[r] * a + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / D, dd = idx % D;
      if (r < rows) {
        const float* p = ss + r * kTileK;
        float pv = 0.f;
        for (int j = 0; j < nk; ++j) pv = fmaf(p[j], vs[j * D + dd], pv);
        acc[i] = acc[i] * a_s[r] + pv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / D, dd = idx % D;
    const int t = r / G, g = r % G;
    if (r < rows && t < nq) {
      out[(static_cast<long long>(b) * Tq + t_lo + t) * q_row + (h * G + g) * D + dd] =
          from_f32<T>(acc[i] / fmaxf(l_s[r], REPRO_L_MIN));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* q_pos, const int* k_pos,
           const unsigned char* k_valid, void* out, int B, int Tq, int Tk, int Hq,
           int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G < 1 || G > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Tq == 0) return 0;
  const int bq = kMaxRows / G;
  const size_t bytes = smem_bytes<D>();
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Tq + bq - 1) / bq, B * Hkv);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
      k_pos, k_valid, static_cast<T*>(out), Tq, Tk, Hq, Hkv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int* qp, const int* kp,
               const unsigned char* kv, void* out, int B, int Tq, int Tk, int Hq, int Hkv,
               int D, int causal, int window, float scale, cudaStream_t s) {
  if (D == 64)
    return launch<T, 64>(q, k, v, qp, kp, kv, out, B, Tq, Tk, Hq, Hkv, causal, window,
                         scale, s);
  if (D == 128)
    return launch<T, 128>(q, k, v, qp, kp, kv, out, B, Tq, Tk, Hq, Hkv, causal, window,
                          scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      const void* q_pos, const void* k_pos,
                                      const void* k_valid, void* out, int B, int Tq, int Tk,
                                      int Hq, int Hkv, int D, int causal, int window,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  const unsigned char* kv = static_cast<const unsigned char*>(k_valid);
  if (dtype == REPRO_DTYPE_F32)
    return dispatch_d<float>(q, k, v, qp, kp, kv, out, B, Tq, Tk, Hq, Hkv, D, causal,
                             window, scale, s);
  if (dtype == REPRO_DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, qp, kp, kv, out, B, Tq, Tk, Hq, Hkv, D,
                                     causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
