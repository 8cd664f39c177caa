// Int8 GEMMs of AutoQuant over a contiguous [M, K] x [K, N] product.
//
// Replaces: repro/kernels/int8_matmul.py
//   int8_matmul_pallas (_wo_kernel):          y = (f32(x) @ f32(w_q)) * w_scale[n],
//                                             x bf16/f32, out x's type;
//   int8_matmul_dynamic_pallas (_dyn_kernel): y = f32(i32(x_q) @ i32(w_q)) * x_scale[m]
//                                                 * w_scale[n], out f32.
// Bound on the H100: at decode (M = 8 rows) both are bound by bytes, the
// int8 weights being nearly all of them: one [8, 2048] x [2048, 8192] call
// moves ~17 MB (>= 5.1 us at 3.35 TB/s) for 0.27 GFLOP. At prefill
// (M = 256) the [256, 2048] x [2048, 8192] call moves ~26 MB (>= 7.7 us)
// for 8.6 G int8 ops (>= 4.3 us at 1979 TOP/s): still bytes, by a little.
// Design (no tensor cores yet): a 256-thread block owns an 8-row by
// 128-column output tile and one chunk of K. Sixteen column-threads each
// own 8 adjacent columns and read them as one 64-bit load (w_q is
// N-contiguous, so a warp reads two 128-byte row segments); sixteen
// k-groups take every 16th K row, and each thread keeps 8 weight rows in
// flight before it multiplies: a decode GEMM is bound by the bytes the
// card has in flight, not by arithmetic. The x tile is staged k-major in
// shared memory (the 8 rows of one k are two 16-byte broadcast reads).
// Weight bytes become f32 by a magic-number trick (byte into the mantissa
// of 2^23, one permute and one add, exact) instead of the slow int-to-float
// conversion; the dynamic path sign-extends them to int32. Accumulators are
// f32 (weight-only) or exact int32 (dynamic), 8 x 8 per thread. The two
// k-groups of a warp are summed by a shuffle, the eight warps' partials in
// a fixed order through shared memory. When the M x N tiles alone cannot
// fill the card (decode), K is split over blockIdx.z: each split writes
// its partial tile to a workspace and a second kernel sums the splits in a
// fixed order and applies the epilogue (deterministic; exact for int32).
// Otherwise the epilogue runs in place. Edges are predicated (rows past M
// and K-tail elements stage as 0, columns past N load as 0 and are not
// written): nothing is padded, where the Pallas kernels pad M, N and K.
// The dynamic epilogue is (float)acc * x_scale[m] * w_scale[n] in that
// order, so it matches its plain version bit for bit.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 8;                          // one 64-bit load of int8
constexpr int kColThreads = 16;                            // threads across N
constexpr int kBN = kColThreads * kColsPerThread;          // 128 columns per block
constexpr int kKGroups = kThreads / kColThreads;           // 16 k-groups, 2 per warp
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 8;                                     // rows per block
constexpr int kUnroll = 8;                                 // weight rows in flight per thread
constexpr int kBK = kKGroups * kUnroll;                    // 128 K rows per x tile

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int to_acc(int8_t v) { return static_cast<int>(v); }

__device__ __forceinline__ float from_bits(uint32_t u, float) { return __uint_as_float(u); }
__device__ __forceinline__ int from_bits(uint32_t u, int) { return static_cast<int>(u); }

// Eight int8 weights (two little-endian words) as f32: each byte, biased
// to unsigned, is placed in the mantissa of 2^23; subtracting 2^23 + 128
// gives the signed value exactly.
__device__ __forceinline__ void unpack8(uint2 w, float (&out)[kColsPerThread]) {
  const uint32_t lo = w.x ^ 0x80808080u, hi = w.y ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[j] = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7650u | j)) - 8388736.f;
    out[j + 4] = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7650u | j)) - 8388736.f;
  }
}

__device__ __forceinline__ void unpack8(uint2 w, int (&out)[kColsPerThread]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[j] = static_cast<int>(static_cast<signed char>(w.x >> (8 * j)));
    out[j + 4] = static_cast<int>(static_cast<signed char>(w.y >> (8 * j)));
  }
}

// Eight weights of one K row at columns n..n+7, zero bytes past N. `vec`
// (N a multiple of 8 and w_q 8-byte aligned) allows the single 64-bit load.
__device__ __forceinline__ uint2 load_w8(const int8_t* __restrict__ row, int n, int N,
                                         bool vec) {
  if (vec) return n < N ? __ldg(reinterpret_cast<const uint2*>(row + n)) : make_uint2(0, 0);
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (n + j < N) lo |= static_cast<uint32_t>(static_cast<uint8_t>(row[n + j])) << (8 * j);
    if (n + 4 + j < N) hi |= static_cast<uint32_t>(static_cast<uint8_t>(row[n + 4 + j])) << (8 * j);
  }
  return make_uint2(lo, hi);
}

template <typename Acc, typename Out, bool kDyn>
__device__ __forceinline__ Out epilogue(Acc s, const float* __restrict__ w_scale,
                                        const float* __restrict__ x_scale, int row, int col) {
  if constexpr (kDyn) {
    return static_cast<float>(s) * x_scale[row] * w_scale[col];
  } else {
    return from_f32<Out>(s * w_scale[col]);
  }
}

template <typename XIn, typename Acc, typename Out, bool kDyn>
__global__ void __launch_bounds__(kThreads, 2)
int8_gemm_kernel(const XIn* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ w_scale, const float* __restrict__ x_scale,
                 Out* __restrict__ y, Acc* __restrict__ partial, int M, int N, int K,
                 int k_chunk, bool vec) {
  __shared__ __align__(16) Acc xs[kBK][kBM];
  __shared__ __align__(16) Acc red[kWarps][kBM][kBN];
  const int tid = threadIdx.x;
  const int ct = tid % kColThreads;
  const int kg = tid / kColThreads;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int n = n0 + ct * kColsPerThread;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  Acc acc[kBM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kBM; ++m) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = Acc(0);
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const int kt = min(kBK, k_end - k0);
    __syncthreads();  // every reader of the previous x tile is done
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int m = i / kBK, k = i % kBK;  // neighbouring threads read neighbouring k
      Acc v = Acc(0);
      if (m0 + m < M && k < kt) v = to_acc(x[static_cast<long long>(m0 + m) * K + k0 + k]);
      xs[k][m] = v;
    }
    __syncthreads();
    uint2 wr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // all loads first: 8 rows in flight
      const int k = kg + u * kKGroups;
      wr[u] = k < kt ? load_w8(w + static_cast<long long>(k0 + k) * N, n, N, vec)
                     : make_uint2(0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = kg + u * kKGroups;
      Acc wv[kColsPerThread];
      unpack8(wr[u], wv);
      const uint4 a = reinterpret_cast<const uint4*>(xs[k])[0];
      const uint4 b = reinterpret_cast<const uint4*>(xs[k])[1];
      const Acc xv[kBM] = {from_bits(a.x, Acc()), from_bits(a.y, Acc()),
                           from_bits(a.z, Acc()), from_bits(a.w, Acc()),
                           from_bits(b.x, Acc()), from_bits(b.y, Acc()),
                           from_bits(b.z, Acc()), from_bits(b.w, Acc())};
#pragma unroll
      for (int m = 0; m < kBM; ++m) {
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[m][j] += xv[m] * wv[j];
      }
    }
  }

  // lanes l and l + 16 hold k-groups 2w and 2w + 1 of the same columns
#pragma unroll
  for (int m = 0; m < kBM; ++m) {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
    }
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane < 16) {
#pragma unroll
    for (int m = 0; m < kBM; ++m) {
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) red[warp][m][ct * kColsPerThread + j] = acc[m][j];
    }
  }
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int m = i / kBN, c = i % kBN;
    const int row = m0 + m, col = n0 + c;
    if (row >= M || col >= N) continue;
    Acc s = Acc(0);
#pragma unroll
    for (int g = 0; g < kWarps; ++g) s += red[g][m][c];
    const long long o = static_cast<long long>(row) * N + col;
    if (partial != nullptr) {
      partial[static_cast<long long>(blockIdx.z) * M * N + o] = s;
    } else {
      y[o] = epilogue<Acc, Out, kDyn>(s, w_scale, x_scale, row, col);
    }
  }
}

// Sums the K splits' partial tiles in split order, then the epilogue.
template <typename Acc, typename Out, bool kDyn>
__global__ void __launch_bounds__(kThreads)
int8_splitk_reduce(const Acc* __restrict__ partial, const float* __restrict__ w_scale,
                   const float* __restrict__ x_scale, Out* __restrict__ y, int M, int N,
                   int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long mn = static_cast<long long>(M) * N;
  if (i >= mn) return;
  Acc s = Acc(0);
  for (int z = 0; z < splits; ++z) s += partial[z * mn + i];
  y[i] = epilogue<Acc, Out, kDyn>(s, w_scale, x_scale, static_cast<int>(i / N),
                                  static_cast<int>(i % N));
}

template <typename XIn, typename Acc, typename Out, bool kDyn>
int launch(const void* x, const void* w, const void* w_scale, const void* x_scale, void* y,
           void* partial, int M, int N, int K, int splits, int k_chunk, cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  if (grid.y > 65535u || splits < 1 || splits > 65535 || (splits > 1 && partial == nullptr) ||
      (K > 0 && (k_chunk < 1 || static_cast<long long>(k_chunk) * splits < K))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = N % kColsPerThread == 0 &&
                   reinterpret_cast<std::uintptr_t>(w) % kColsPerThread == 0;
  Acc* part = splits > 1 ? static_cast<Acc*>(partial) : nullptr;
  int8_gemm_kernel<XIn, Acc, Out, kDyn><<<grid, kThreads, 0, stream>>>(
      static_cast<const XIn*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(x_scale),
      static_cast<Out*>(y), part, M, N, K, k_chunk, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  const long long mn = static_cast<long long>(M) * N;
  int8_splitk_reduce<Acc, Out, kDyn><<<static_cast<unsigned>((mn + kThreads - 1) / kThreads),
                                       kThreads, 0, stream>>>(
      part, static_cast<const float*>(w_scale), static_cast<const float*>(x_scale),
      static_cast<Out*>(y), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int int8_matmul_wo_launch(int dtype, const void* x, const void* w_q,
                                     const void* w_scale, void* y, void* partial, int m,
                                     int n, int k, int splits, int k_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32) {
    return launch<float, float, float, false>(x, w_q, w_scale, nullptr, y, partial, m, n, k,
                                              splits, k_chunk, s);
  }
  if (dtype == REPRO_DTYPE_BF16) {
    return launch<__nv_bfloat16, float, __nv_bfloat16, false>(
        x, w_q, w_scale, nullptr, y, partial, m, n, k, splits, k_chunk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int int8_matmul_dyn_launch(const void* x_q, const void* w_q, const void* w_scale,
                                      const void* x_scale, void* y, void* partial, int m,
                                      int n, int k, int splits, int k_chunk, void* stream) {
  return launch<int8_t, int, float, true>(x_q, w_q, w_scale, x_scale, y, partial, m, n, k,
                                          splits, k_chunk, static_cast<cudaStream_t>(stream));
}
