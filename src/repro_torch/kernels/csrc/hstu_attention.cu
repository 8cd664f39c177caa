// HSTU pointwise attention forward (no softmax), with the relative bias
// table resident in shared memory.
//
// Replaces: repro/kernels/hstu_attention.py::hstu_attention_pallas
// (_hstu_kernel).
// Computes: out[b, i, h] = sum_j a(i, j) v[b, j, h], with
//   a(i, j) = SiLU(q[b, i, h] . k[b, j, h] * scale
//                  + rel_bias[clip(i - j, -(R - 1), R - 1) + R - 1]) / T
// where j <= i, i - j < max_attn_len (when given) and j < lengths[b], else 0.
// T is the batch's static sequence length (not lengths[b]); query rows at or
// past lengths[b] still get values, as in the reference. R = max_rel.
// Bound on the H100: at the served shapes (T = 4507..5121, H = 8, D = 64,
// bf16) operations: ~4 D flops per in-band (i, j) pair over ~8 D bytes per
// row, far above the ~295 flop/byte ridge. This first version runs the two
// products with f32 FMAs on the CUDA cores (register-tiled 4 x 4 per thread);
// mma.sync / wgmma, TMA and warp specialisation are later work.
// Design: one 256-thread block per (query tile of 64 rows, head, batch row).
// There is no softmax state, so each block accumulates additively in
// registers and nothing carries across blocks; the key loop runs inside the
// block, from the first key tile the band reaches to the last key tile that
// is causal and below lengths[b] (out-of-band and past-length tiles are never
// loaded: the paper's §4.1.1 lever at the 1024 band). The whole bias table
// (2 R - 1 floats, 16 KB at R = 2048) is loaded into shared memory once per
// block: the TPU kernel's VMEM-resident table. Q is held transposed (d-major)
// for float4 row reads, K transposed with an odd row stride (conflict-free
// column reads and stores), the masked SiLU tile transposed (key-major) for
// the P.V product. Ragged edges (T not a multiple of 64) are predicated;
// nothing is padded. Heavy (late) query tiles are scheduled first.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kQStride = kBQ + 4;  // Qs / Ps rows: float4-aligned, padded
constexpr int kKStride = kBK + 1;  // Kt rows: odd stride

template <int D>
constexpr size_t fixed_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(D) * kQStride  // Qs [D][BQ+4]
                          + static_cast<size_t>(D) * kKStride  // Kt [D][BK+1]
                          + static_cast<size_t>(kBK) * D       // Vs [BK][D]
                          + static_cast<size_t>(kBK) * kQStride);  // Ps [BK][BQ+4]
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
hstu_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ rel_bias,
                      const int* __restrict__ lengths, T* __restrict__ out, int Tlen,
                      int H, int n_bias, int max_attn_len, float scale) {
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                          // [D][kQStride]
  float* Kt = Qs + D * kQStride;             // [D][kKStride]
  float* Vs = Kt + D * kKStride;             // [kBK][D]
  float* Ps = Vs + kBK * D;                  // [kBK][kQStride]
  float* bias = Ps + kBK * kQStride;         // [n_bias]

  const int n_qt = (Tlen + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;  // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int max_rel = (n_bias + 1) / 2;
  const long long row = static_cast<long long>(H) * D;  // elements between positions
  const long long base = static_cast<long long>(b) * Tlen * row + static_cast<long long>(h) * D;
  const float inv_t = 1.0f / static_cast<float>(Tlen);

  for (int i = tid; i < n_bias; i += kThreads) bias[i] = rel_bias[i];
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    Qs[d * kQStride + r] = t < Tlen ? to_f32(q[base + t * row + d]) : 0.f;
  }

  float o[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) o[a][c] = 0.f;

  const int len = min(lengths[b], Tlen);
  const int k_end = min(q0 + kBQ, len);  // exclusive: causal and below the length
  int k_start = 0;
  if (max_attn_len >= 0) k_start = max(0, q0 - max_attn_len + 1);
  k_start = (k_start / kBK) * kBK;

  for (int k0 = k_start; k0 < k_end; k0 += kBK) {
    __syncthreads();  // previous tile's Kt / Vs / Ps reads are done (and Qs, bias loaded)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int t = k0 + r;
      const bool ok = t < Tlen;
      Kt[d * kKStride + r] = ok ? to_f32(k[base + t * row + d]) : 0.f;
      Vs[r * D + d] = ok ? to_f32(v[base + t * row + d]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty*4 + a against keys tx + 16 bb
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qs[d * kQStride + ty * 4]);
      float kb[4];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) kb[bb] = Kt[d * kKStride + tx + 16 * bb];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        s[0][bb] = fmaf(qa.x, kb[bb], s[0][bb]);
        s[1][bb] = fmaf(qa.y, kb[bb], s[1][bb]);
        s[2][bb] = fmaf(qa.z, kb[bb], s[2][bb]);
        s[3][bb] = fmaf(qa.w, kb[bb], s[3][bb]);
      }
    }
    // bias, SiLU / T and the masks; the tile is stored key-major
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int kp = k0 + tx + 16 * bb;
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int qp = q0 + ty * 4 + a;
        const int delta = qp - kp;
        bool ok = delta >= 0 && kp < len;
        if (max_attn_len >= 0) ok = ok && delta < max_attn_len;
        float val = 0.f;
        if (ok) {
          const int idx = min(max(delta, -(max_rel - 1)), max_rel - 1) + max_rel - 1;
          const float x = s[a][bb] * scale + bias[idx];
          val = (x / (1.0f + expf(-x))) * inv_t;
        }
        pa[a] = val;
      }
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * bb) * kQStride + ty * 4]) =
          make_float4(pa[0], pa[1], pa[2], pa[3]);
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kBK; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(&Ps[j * kQStride + ty * 4]);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * D + tx + 16 * c];
        o[0][c] = fmaf(pj.x, vv, o[0][c]);
        o[1][c] = fmaf(pj.y, vv, o[1][c]);
        o[2][c] = fmaf(pj.z, vv, o[2][c]);
        o[3][c] = fmaf(pj.w, vv, o[3][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = q0 + ty * 4 + a;
    if (t >= Tlen) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) out[base + t * row + tx + 16 * c] = from_f32<T>(o[a][c]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* rel_bias,
           const int* lengths, void* out, int B, int Tlen, int H, int n_bias,
           int max_attn_len, float scale, cudaStream_t stream) {
  if (B == 0 || Tlen == 0 || H == 0) return 0;
  const size_t smem = fixed_smem_bytes<D>() + sizeof(float) * static_cast<size_t>(n_bias);
  cudaError_t err = cudaFuncSetAttribute(hstu_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tlen + kBQ - 1) / kBQ, H, B);
  hstu_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), rel_bias,
      lengths, static_cast<T*>(out), Tlen, H, n_bias, max_attn_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const float* rel_bias,
               const int* lengths, void* out, int B, int Tlen, int H, int n_bias,
               int max_attn_len, float scale, cudaStream_t s) {
  if (D == 32)
    return launch<T, 32>(q, k, v, rel_bias, lengths, out, B, Tlen, H, n_bias, max_attn_len,
                         scale, s);
  if (D == 64)
    return launch<T, 64>(q, k, v, rel_bias, lengths, out, B, Tlen, H, n_bias, max_attn_len,
                         scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// max_attn_len < 0: no band. n_bias = 2 * max_rel - 1 table entries (f32).
extern "C" int hstu_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                     const void* rel_bias, const void* lengths, void* out,
                                     int B, int Tlen, int H, int D, int n_bias,
                                     int max_attn_len, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rb = static_cast<const float*>(rel_bias);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == REPRO_DTYPE_F32)
    return dispatch_d<float>(D, q, k, v, rb, ln, out, B, Tlen, H, n_bias, max_attn_len,
                             scale, s);
  if (dtype == REPRO_DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, rb, ln, out, B, Tlen, H, n_bias,
                                     max_attn_len, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
