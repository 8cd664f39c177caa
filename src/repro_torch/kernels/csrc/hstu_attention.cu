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
// row, far above the ~295 flop/byte ridge. With the products on the tensor
// cores the SiLU sets the floor: each pair costs 2 D bf16 FMAs there (~2048
// per clock per SM) but at least one special-function op (~16 per clock
// per SM).
//
// Both types share the block's walk: one block per (query tile of 64 rows,
// head, batch row), heavy (late) query tiles first. There is no softmax
// state, so each block accumulates additively in registers and nothing
// carries across blocks; the key loop runs inside the block, from the first
// key tile the band reaches to the last key tile that is causal and below
// lengths[b] (out-of-band and past-length tiles are never loaded: the
// paper's §4.1.1 lever at the 1024 band), so a row of length 0 gives exact
// zeros. The whole bias table (2 R - 1 floats, 16 KB at R = 2048) is loaded
// into shared memory once per block: the TPU kernel's VMEM-resident table.
// Ragged edges (T not a multiple of 64) are predicated; nothing is padded.
//
// Dispatch by type, not a fallback: bf16 runs the tensor-core kernel, f32
// the CUDA-core kernel, whose exact expf and f32 P the f32 tolerance (atol
// 2e-5, rtol 2e-4) needs.
//
// bf16 (hstu_attention_mma_kernel): 4 warps of 16 query rows. S = Q.K^T on
// mma.sync m16n8k16 with Q's fragments in registers for the block's life and
// K's by ldmatrix; `scale` is applied to the f32 accumulator. The bias is
// gathered from the shared table in the accumulator's fragment layout. The
// masks are evaluated only on key tiles that straddle the diagonal, the
// band's lower edge or lengths[b] (an interior tile, every pair valid, is
// the classification hstu_attention.py::key_tiles states and a CPU test
// holds against the masks). SiLU(x) = x (0.5 + 0.5 tanh(x / 2)) with
// tanh.approx.f32, one special-function op (its relative error, about
// 2^-11, lies below the bf16 rounding of P that follows; a CPU test
// emulates both against the JAX reference). SiLU(x) is packed to bf16 and
// reused from S's registers as the A fragment of P.V (FlashAttention-2's
// register reuse), V by ldmatrix.trans, O in f32 registers; 1 / T scales O
// once at the end. K/V tiles are double-buffered by cp.async, zero-filled
// past T; rows are padded to D + 8 elements (conflict-free ldmatrix). The
// output is staged through the warp's own Q rows for 16-byte stores.
//
// f32 (hstu_attention_kernel, 256 threads, the first design): f32 FMAs
// register-tiled 4 x 4 per thread; Q held transposed (d-major) for float4
// row reads, K transposed with an odd row stride (conflict-free column
// reads and stores), the masked SiLU tile transposed (key-major) for the
// P.V product.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;   // query rows per block, 16 per warp
constexpr int kTileK = 64;  // keys per tile

template <int D>
constexpr int kStride = D + 8;  // bf16 row stride: conflict-free ldmatrix

template <int D>
constexpr size_t fixed_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(kStride<D>) * (kRows + 4 * kTileK);
}

// SiLU(x) = x sigmoid(x), sigmoid(x) = 0.5 + 0.5 tanh(x / 2): one
// special-function op (tanh.approx.f32, relative error about 2^-11)
__device__ __forceinline__ float silu_approx(float x) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(0.5f * x));
  return x * fmaf(0.5f, t, 0.5f);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
hstu_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ rel_bias,
                          const int* __restrict__ lengths, bf16* __restrict__ out, int Tlen,
                          int H, int n_bias, int max_attn_len, float scale) {
  constexpr int S = kStride<D>;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][S]
  bf16* ks = qs + kRows * S;                      // [2][kTileK][S]
  bf16* vs = ks + 2 * kTileK * S;                 // [2][kTileK][S]
  float* bias = reinterpret_cast<float*>(vs + 2 * kTileK * S);  // [n_bias]

  const int q0 = (static_cast<int>(gridDim.x) - 1 - static_cast<int>(blockIdx.x)) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int max_rel = (n_bias + 1) / 2;
  const long long row = static_cast<long long>(H) * D;  // elements between positions
  const long long base = static_cast<long long>(b) * Tlen * row + static_cast<long long>(h) * D;

  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int t = q0 + r;
    cp_async16(qs + r * S + c * 8, t < Tlen ? q + base + t * row + c * 8 : q,
               t < Tlen ? 16 : 0);
  }
  cp_async_commit();
  for (int i = tid; i < n_bias; i += kThreads) bias[i] = rel_bias[i];

  const int len = min(lengths[b], Tlen);
  const int k_end = min(q0 + kRows, len);  // exclusive: causal and below the length
  int k_start = 0;
  if (max_attn_len >= 0) k_start = max(0, q0 - max_attn_len + 1);
  k_start = (k_start / kTileK) * kTileK;

  auto load_kv = [&](int k0, int sb) {
    for (int i = tid; i < kTileK * kChunks; i += kThreads) {
      const int j = i / kChunks, c = i % kChunks;
      const int t = k0 + j;
      const bool ok = t < Tlen;
      const long long off = base + static_cast<long long>(t) * row + c * 8;
      cp_async16(ks + (sb * kTileK + j) * S + c * 8, ok ? k + off : k, ok ? 16 : 0);
      cp_async16(vs + (sb * kTileK + j) * S + c * 8, ok ? v + off : v, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  if (k_start < k_end) load_kv(k_start, 0);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];  // this warp's 16 x D Q fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], qs + (warp * 16 + lane % 16) * S + kk * 16 + (lane / 16) * 8);
  const int ir[2] = {q0 + warp * 16 + gid, q0 + warp * 16 + gid + 8};  // this thread's rows

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  int sb = 0;
  for (int k0 = k_start; k0 < k_end; k0 += kTileK) {
    if (k0 + kTileK < k_end) {
      load_kv(k0 + kTileK, sb ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt_s = ks + sb * kTileK * S;
    const bf16* vt_s = vs + sb * kTileK * S;

    // each step's fragments first, then the products in an order where
    // consecutive mma write different accumulators
    float s[kTileK / 8][4];  // S: 8 key columns per n-tile
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t bf[kTileK / 8][4];  // keys n*8.., d in [kk*16, kk*16 + 32)
#pragma unroll
      for (int n = 0; n < kTileK / 8; ++n)
        ldmatrix_x4(bf[n], kt_s + (n * 8 + lane % 8) * S + kk * 16 + (lane / 8) * 8);
#pragma unroll
      for (int n = 0; n < kTileK / 8; ++n) mma_bf16_16816(s[n], qf[kk], bf[n][0], bf[n][1]);
#pragma unroll
      for (int n = 0; n < kTileK / 8; ++n) mma_bf16_16816(s[n], qf[kk + 1], bf[n][2], bf[n][3]);
    }
    // interior: every (i, j) of the block's tile is causal, in the band and
    // below the length (hstu_attention.py::key_tiles); uniform over the block
    const bool interior = k0 + kTileK <= len && k0 + kTileK - 1 <= q0 &&
                          (max_attn_len < 0 || q0 + kRows - 1 - k0 < max_attn_len);
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ir[e / 2], j = k0 + n * 8 + 2 * tig + (e & 1);
        const int delta = i - j;
        const float x =
            s[n][e] * scale + bias[min(max(delta, -(max_rel - 1)), max_rel - 1) + max_rel - 1];
        const bool ok = interior || (delta >= 0 && j < len &&
                                     (max_attn_len < 0 || delta < max_attn_len));
        s[n][e] = ok ? silu_approx(x) : 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {  // keys kk*16 .. kk*16 + 15
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      uint32_t bv[D / 16][4];  // V rows kk*16.., d columns 16n .. 16n + 15
#pragma unroll
      for (int n = 0; n < D / 16; ++n)
        ldmatrix_x4_trans(bv[n], vt_s + (kk * 16 + lane % 16) * S + n * 16 + (lane / 16) * 8);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        mma_bf16_16816(o[n], pa, bv[n / 2][2 * (n % 2)], bv[n / 2][2 * (n % 2) + 1]);
    }
    __syncthreads();  // buffer sb is free for the tile after next
    sb ^= 1;
  }

  // 1 / T once, then stage the warp's 16 output rows in its own Q rows for
  // 16-byte stores
  const float inv_t = 1.0f / static_cast<float>(Tlen);
  bf16* os = qs + warp * 16 * S;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(os + gid * S + n * 8 + 2 * tig) =
        pack_bf16(o[n][0] * inv_t, o[n][1] * inv_t);
    *reinterpret_cast<uint32_t*>(os + (gid + 8) * S + n * 8 + 2 * tig) =
        pack_bf16(o[n][2] * inv_t, o[n][3] * inv_t);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int rr = i / kChunks, c = i % kChunks;
    const int t = q0 + warp * 16 + rr;
    if (t < Tlen) {
      *reinterpret_cast<uint4*>(out + base + t * row + c * 8) =
          *reinterpret_cast<const uint4*>(os + rr * S + c * 8);
    }
  }
}

}  // namespace mma

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* rel_bias,
           const int* lengths, void* out, int B, int Tlen, int H, int n_bias,
           int max_attn_len, float scale, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  if (B == 0 || Tlen == 0 || H == 0) return 0;
  const size_t smem = (kMma ? mma::fixed_smem_bytes<D>() : fixed_smem_bytes<D>())
                      + sizeof(float) * static_cast<size_t>(n_bias);
  const dim3 grid((Tlen + kBQ - 1) / kBQ, H, B);  // both kernels: 64 query rows per block
  if constexpr (kMma) {
    auto kern = mma::hstu_attention_mma_kernel<D>;
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, mma::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), rel_bias,
        lengths, static_cast<T*>(out), Tlen, H, n_bias, max_attn_len, scale);
  } else {
    auto kern = hstu_attention_kernel<T, D>;
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), rel_bias,
        lengths, static_cast<T*>(out), Tlen, H, n_bias, max_attn_len, scale);
  }
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
