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
// (M = 256) the dynamic [256, 2048] x [2048, 8192] call moves ~26 MB
// (>= 7.7 us) for 8.6 G int8 ops (>= 4.3 us at 1979 TOP/s): still bytes, by
// a little; the weight-only one moves ~22 MB (>= 6.6 us) for 8.6 GFLOP of
// bf16 (>= 8.7 us at 989 TFLOP/s): operations, by a little.
//
// Weight-only, bf16 x (int8_wo_mma_kernel, tensor cores): mma.sync m16n8k16
// bf16 x bf16 -> f32. Above 16 rows a 256-thread block owns a 64 x 128
// output tile, 2 x 4 warps of 32 rows x 32 columns; at or below 16 rows a
// 128-thread block owns 16 x 128, 4 warps of 16 x 32. It walks its chunk of
// K in stages of 64: x [64 or 16, 64] bf16 and w_q [64, 128] int8 are
// double-buffered in shared memory by cp.async (48 KB with 64-row tiles).
// Once a stage has landed, the block dequantizes its int8 tile into one
// bf16 tile [64, 128] (the magic-number trick below, then
// cvt.rn.bf16x2.f32: every int8 value is a bf16, so this is exact, a bf16 x
// bf16 product is exact in f32, and the result differs from the f32 dot of
// _wo_kernel only in the order of the sum). Then ldmatrix gives x's A
// fragments (K-contiguous) and ldmatrix.trans the weights' B fragments
// (N-contiguous), as V in the flash kernel: once the operand is 16-bit, the
// dynamic kernel's byte transpose is not needed. The 16-byte chunks of the
// bf16 rows are XOR-swizzled by the row so ldmatrix is free of bank
// conflicts; each thread alternates which half of its dequantized chunk it
// stores first, so the stores are too. The scale is applied in the f32
// epilogue, then the cast to bf16. Rows past M, columns past N and K past
// the chunk stage as zeros; when K is not a multiple of 8, N not a multiple
// of 16 or a pointer is not 16-byte aligned, stages are copied element by
// element. The K split is kernels/int8_matmul.py split_k_weight_only.
// A ring of four stages, a second bf16 tile (converting stage s + 1 while
// multiplying stage s, one barrier per stage) and 128-row tiles each moved
// the M = 256 times by under 10 % (PERF.md), so the simplest design stays.
// The small-M rule (kWoSmallM): at M <= 16 bf16 x runs the 16-row tile,
// which splits K down to two stages per block until the tiles reach two
// blocks per SM (bound by the weight bytes in flight). At the four decode
// shapes (M = 8) it measured faster than the CUDA-core template at all four,
// and the 64-row tile slower than both (PERF.md), so the CUDA-core template
// serves f32 x alone: TF32 would miss the f32 tolerance. The C entry takes
// the route from x's type and M; kernels/int8_matmul.py wo_tile_m plans the
// K split for the same route.
//
// Weight-only, f32 x (int8_gemm_kernel, CUDA cores): a 256-thread block owns an
// 8-row by 128-column output tile and one chunk of K. Sixteen
// column-threads each own 8 adjacent columns and read them as one 64-bit
// load (w_q is N-contiguous, so a warp reads two 128-byte row segments);
// sixteen k-groups take every 16th K row, and each thread keeps 8 weight
// rows in flight before it multiplies: a decode GEMM is bound by the bytes
// the card has in flight, not by arithmetic. The x tile is staged k-major
// in shared memory (the 8 rows of one k are two 16-byte broadcast reads).
// Weight bytes become f32 by a magic-number trick (byte into the mantissa
// of 2^23, one permute and one add, exact) instead of the slow int-to-float
// conversion; f32 accumulators, 8 x 8 per thread. The two k-groups of a
// warp are summed by a shuffle, the eight warps' partials in a fixed order
// through shared memory. Columns past N load as 0 and are not written.
//
// Dynamic (int8_mma_kernel, tensor cores, every M): mma.sync m16n8k32
// s8 x s8 -> s32. A 128-thread block owns a 64 x 128 output tile, each
// warp 64 rows x 32 columns (4 x 4 fragments of exact int32 sums), and
// walks its chunk of K in 64-byte stages, double-buffered in shared memory
// by cp.async. x_q [M, K] is K-contiguous, so ldmatrix gives the A
// fragments directly. The B operand must be K-packed (four k of one column
// in a register) but w_q [K, N] is N-contiguous, and ldmatrix.trans moves
// 16-bit elements, not bytes: a lane reads four 32-bit words (four K rows,
// four adjacent columns) and transposes them with byte permutes. Mma
// column g of n-tile t stands for the warp's column 4 g + t, so those four
// words are exactly the lane's B fragments of all four n-tiles, and each
// lane's accumulators cover 8 adjacent output columns (two 16-byte
// stores). The 16-byte chunks of every shared-memory row are XOR-swizzled
// so that the ldmatrix reads and the 32-bit reads are free of bank
// conflicts. The epilogue runs in registers. Rows past M, columns past N
// and K past the chunk stage as zeros; when K or N is not a multiple of 16
// or a pointer is not 16-byte aligned, stages are copied byte by byte.
// The small-M rule: none. At the four decode shapes (M = 8) the
// tensor-core kernel measured faster than the CUDA-core template at three
// and 5 % slower at one, 18 % less over a decode step (PERF.md), so every
// M runs here and the CUDA-core template serves weight-only f32 x alone.
//
// Both: when the M x N tiles alone cannot fill the card, K is split over
// blockIdx.z: each split writes its partial tile to a workspace and a
// second kernel sums the splits in a fixed order and applies the epilogue
// (deterministic; exact for int32). Otherwise the epilogue runs in place.
// Nothing is padded, where the Pallas kernels pad M, N and K. The dynamic
// epilogue is (float)acc * x_scale[m] * w_scale[n] in that order, so it
// matches its plain version bit for bit.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

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

__device__ __forceinline__ float from_bits(uint32_t u, float) { return __uint_as_float(u); }

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

template <typename Acc, typename Out, bool kDyn>
__global__ void __launch_bounds__(kThreads, 2)
int8_gemm_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
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
      if (m0 + m < M && k < kt) v = x[static_cast<long long>(m0 + m) * K + k0 + k];
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

}  // namespace

namespace mma {

constexpr int kThreads = 128;  // 4 warps side by side along N
constexpr int kBM = 64;        // rows per block (all 4 warps)
constexpr int kBN = 128;       // columns per block, 32 per warp
constexpr int kBK = 64;        // K bytes per pipeline stage

// 4 x 4 byte transpose: w[i] holds the bytes of K row k + i at columns
// n .. n + 3; on return w[t] holds K rows k .. k + 3 of column n + t, the
// K-packed word an s8 mma B fragment takes.
__device__ __forceinline__ void transpose4x4(uint32_t (&w)[4]) {
  const uint32_t a0 = __byte_perm(w[0], w[1], 0x5140), a1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t a2 = __byte_perm(w[2], w[3], 0x5140), a3 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(a0, a2, 0x5410);
  w[1] = __byte_perm(a0, a2, 0x7632);
  w[2] = __byte_perm(a1, a3, 0x5410);
  w[3] = __byte_perm(a1, a3, 0x7632);
}

// XOR swizzles of the 16-byte chunks of a shared-memory row, chosen so that
// every ldmatrix of x and every 32-bit read of w is free of bank conflicts
__device__ __forceinline__ int x_chunk(int r, int c) { return c ^ ((r >> 1) & 3); }
__device__ __forceinline__ int w_chunk(int r, int c) { return c ^ (((r >> 2) & 3) << 1); }

__global__ void __launch_bounds__(kThreads)
int8_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ w_scale, const float* __restrict__ x_scale,
                float* __restrict__ y, int* __restrict__ partial, int M, int N, int K,
                int k_chunk, bool vec) {
  __shared__ __align__(128) int8_t xs[2][kBM][kBK];
  __shared__ __align__(128) int8_t ws[2][kBK][kBN];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  // x rows m0.. and w rows k0.. of one stage into buffer `buf`, zero past
  // M, N and k_end: cp.async when every chunk is whole and aligned (vec),
  // else byte by byte
  auto stage = [&](int k0, int buf) {
    const int kt = min(kBK, k_end - k0);
    for (int i = tid; i < kBM * kBK / 16; i += kThreads) {
      const int r = i / (kBK / 16), c = i % (kBK / 16);
      int8_t* dst = &xs[buf][r][x_chunk(r, c) * 16];
      const int row = m0 + r, kc = c * 16;
      const int8_t* src = x + static_cast<long long>(row) * K + k0 + kc;
      if (vec) {
        const bool live = row < M && kc < kt;
        cp_async16(dst, live ? src : x, live ? 16 : 0);
      } else {
        for (int e = 0; e < 16; ++e) dst[e] = row < M && kc + e < kt ? src[e] : 0;
      }
    }
    for (int i = tid; i < kBK * kBN / 16; i += kThreads) {
      const int r = i / (kBN / 16), c = i % (kBN / 16);
      int8_t* dst = &ws[buf][r][w_chunk(r, c) * 16];
      const int col = n0 + c * 16;
      const int8_t* src = w + static_cast<long long>(k0 + r) * N + col;
      if (vec) {
        const bool live = r < kt && col < N;
        cp_async16(dst, live ? src : w, live ? 16 : 0);
      } else {
        for (int e = 0; e < 16; ++e) dst[e] = r < kt && col + e < N ? src[e] : 0;
      }
    }
    cp_async_commit();
  };

  int acc[4][4][4];  // [m-tile][n-tile][fragment]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0;
  }
  const int n_steps = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  if (n_steps > 0) stage(k_begin, 0);
  for (int s = 0; s < n_steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_steps) {
      stage(k_begin + (s + 1) * kBK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kh = 0; kh < kBK / 32; ++kh) {
      uint32_t a[4][4];  // 64 rows x 32 k: ldmatrix gives the s8 A fragments directly
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = mt * 16 + lane % 16, c = kh * 2 + lane / 16;
        ldmatrix_x4(a[mt], &xs[buf][r][x_chunk(r, c) * 16]);
      }
      // B: mma column gid of n-tile t is the warp's column 4 * gid + t, so
      // the four words a lane reads (K rows k..k+3, 4 adjacent columns)
      // transpose into its K-packed words of all four n-tiles
      uint32_t b[2][4];  // [k half][n-tile]
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = kh * 32 + hh * 16 + 4 * tig + i;
          b[hh][i] = *reinterpret_cast<const uint32_t*>(
              &ws[buf][r][w_chunk(r, 2 * warp + gid / 4) * 16 + 4 * (gid % 4)]);
        }
        transpose4x4(b[hh]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int t = 0; t < 4; ++t) mma_s8_16832(acc[mt][t], a[mt], b[0][t], b[1][t]);
      }
    }
    __syncthreads();  // buffer `buf` is free for the stage after next
  }

  // fragment (mt, t, e) is row m0 + mt*16 + gid + 8 (e / 2) and column
  // 32 warp + 8 tig + 4 (e % 2) + t: each thread owns 8 adjacent columns
  const int col = n0 + 32 * warp + 8 * tig;
  const bool whole = vec && col + 8 <= N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + mt * 16 + gid + 8 * hr;
      if (row >= M) continue;
      int v[8];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        v[t] = acc[mt][t][2 * hr];
        v[4 + t] = acc[mt][t][2 * hr + 1];
      }
      const long long o = static_cast<long long>(row) * N + col;
      if (partial != nullptr) {
        int* dst = partial + static_cast<long long>(blockIdx.z) * M * N + o;
        if (whole) {
          reinterpret_cast<int4*>(dst)[0] = make_int4(v[0], v[1], v[2], v[3]);
          reinterpret_cast<int4*>(dst)[1] = make_int4(v[4], v[5], v[6], v[7]);
        } else {
          for (int j = 0; j < 8; ++j)
            if (col + j < N) dst[j] = v[j];
        }
      } else {
        float f[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          f[j] = col + j < N ? epilogue<int, float, true>(v[j], w_scale, x_scale, row, col + j)
                             : 0.f;
        }
        if (whole) {
          reinterpret_cast<float4*>(y + o)[0] = make_float4(f[0], f[1], f[2], f[3]);
          reinterpret_cast<float4*>(y + o)[1] = make_float4(f[4], f[5], f[6], f[7]);
        } else {
          for (int j = 0; j < 8; ++j)
            if (col + j < N) y[o + j] = f[j];
        }
      }
    }
  }
}

}  // namespace mma

namespace wo {

constexpr int kWarpsN = 4;  // warps side by side along N
constexpr int kBN = 128;    // columns per block, 32 per warp
constexpr int kBK = 64;     // K elements per pipeline stage

// XOR swizzle of the 16-byte chunks of a bf16 shared-memory row (8 of x's,
// 16 of the dequantized weights'): the 8 rows an ldmatrix phase reads at
// one logical chunk land in 8 different bank groups
__device__ __forceinline__ int swz(int r, int c) { return c ^ (r & 7); }

// Bytes j and j + 1 of a sign-flipped word (u = w ^ 0x80808080) as two
// bf16 in one register: the byte in the mantissa of 2^23, minus 2^23 + 128,
// is the signed value exactly in f32, and every int8 value is a bf16.
__device__ __forceinline__ uint32_t dequant2(uint32_t u, int j) {
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | j)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | (j + 1))) - 8388736.f;
  return pack_bf16(lo, hi);
}

// Sixteen int8 weights as sixteen bf16: half h of the result (8 values).
__device__ __forceinline__ uint4 dequant8(uint4 w, int h) {
  const uint32_t a = (h ? w.z : w.x) ^ 0x80808080u, b = (h ? w.w : w.y) ^ 0x80808080u;
  return make_uint4(dequant2(a, 0), dequant2(a, 2), dequant2(b, 0), dequant2(b, 2));
}

// y = (x @ w_q) * w_scale for bf16 x on the tensor cores: mma.sync m16n8k16
// bf16 -> f32 over (16 MT WM) x 128 output tiles, WM x 4 warps; warp (wm,
// wn) owns rows 16 MT wm .. + 16 MT - 1 and columns 32 wn .. 32 wn + 31.
// Each K stage of 64 stages x [16 MT WM, 64] bf16 and w_q [64, 128] int8 by
// cp.async (double-buffered); after it lands the int8 tile is dequantized
// once into a bf16 tile [64, 128], and ldmatrix (x, K-contiguous) and
// ldmatrix.trans (the bf16 weights, N-contiguous) give the A and B fragments
// directly.
template <int MT, int WM>
__global__ void __launch_bounds__(32 * kWarpsN * WM)
int8_wo_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ w_scale, __nv_bfloat16* __restrict__ y,
                   float* __restrict__ partial, int M, int N, int K, int k_chunk, bool vec) {
  constexpr int kThreads = 32 * kWarpsN * WM;
  constexpr int kBM = 16 * MT * WM;
  __shared__ __align__(128) __nv_bfloat16 xs[2][kBM][kBK];
  __shared__ __align__(128) int8_t w8[2][kBK][kBN];
  __shared__ __align__(128) __nv_bfloat16 wb[kBK][kBN];
  const int tid = threadIdx.x, lane = tid % 32;
  const int wm = tid / 32 / kWarpsN, wn = tid / 32 % kWarpsN;
  const int gid = lane / 4, tig = lane % 4;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // x rows m0.. and w rows k0.. of one stage into buffer `buf`, zero past
  // M, N and k_end: cp.async when every chunk is whole and aligned (vec),
  // else element by element
  auto stage = [&](int k0, int buf) {
    const int kt = min(kBK, k_end - k0);
    for (int i = tid; i < kBM * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), c = i % (kBK / 8);
      __nv_bfloat16* dst = &xs[buf][r][swz(r, c) * 8];
      const int row = m0 + r, kc = c * 8;
      const __nv_bfloat16* src = x + static_cast<long long>(row) * K + k0 + kc;
      if (vec) {
        const bool live = row < M && kc < kt;
        cp_async16(dst, live ? src : x, live ? 16 : 0);
      } else {
        for (int e = 0; e < 8; ++e) dst[e] = row < M && kc + e < kt ? src[e] : zero;
      }
    }
    for (int i = tid; i < kBK * kBN / 16; i += kThreads) {
      const int r = i / (kBN / 16), c = i % (kBN / 16);
      int8_t* dst = &w8[buf][r][c * 16];
      const int col = n0 + c * 16;
      const int8_t* src = w + static_cast<long long>(k0 + r) * N + col;
      if (vec) {
        const bool live = r < kt && col < N;
        cp_async16(dst, live ? src : w, live ? 16 : 0);
      } else {
        for (int e = 0; e < 16; ++e) dst[e] = r < kt && col + e < N ? src[e] : 0;
      }
    }
    cp_async_commit();
  };

  float acc[MT][4][4];  // [m-tile][n-tile][fragment]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.f;
  }
  const int n_steps = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  if (n_steps > 0) stage(k_begin, 0);
  for (int s = 0; s < n_steps; ++s) {
    const int buf = s & 1;
    cp_async_wait<0>();
    __syncthreads();  // stage s has landed; every read of step s - 1 is done
    if (s + 1 < n_steps) stage(k_begin + (s + 1) * kBK, buf ^ 1);  // overlaps what follows
    // dequantize: thread i turns 16 bytes of row i / 8 into two bf16 chunks;
    // the half it stores first alternates so a store phase is conflict-free
    for (int i = tid; i < kBK * kBN / 16; i += kThreads) {
      const int r = i / (kBN / 16), c8 = i % (kBN / 16);
      const uint4 v = *reinterpret_cast<const uint4*>(&w8[buf][r][c8 * 16]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int h = hh ^ ((c8 >> 2) & 1);
        *reinterpret_cast<uint4*>(&wb[r][swz(r, 2 * c8 + h) * 8]) = dequant8(v, h);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = (wm * MT + mt) * 16 + lane % 16, c = kk * 2 + lane / 16;
        ldmatrix_x4(a[mt], &xs[buf][r][swz(r, c) * 8]);
      }
      uint32_t b[2][4];  // n-tiles 2p and 2p + 1: {b0, b1} of each
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int r = kk * 16 + lane % 16, c = wn * 4 + 2 * p + lane / 16;
        ldmatrix_x4_trans(b[p], &wb[r][swz(r, c) * 8]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          mma_bf16_16816(acc[mt][t], a[mt], b[t / 2][2 * (t % 2)], b[t / 2][2 * (t % 2) + 1]);
      }
    }
  }

  // fragment (mt, t, e) is row m0 + 16 (MT wm + mt) + gid + 8 (e / 2) and
  // column n0 + 32 wn + 8 t + 2 tig + (e % 2)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + (wm * MT + mt) * 16 + gid + 8 * hr;
      if (row >= M) continue;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = n0 + 32 * wn + 8 * t + 2 * tig;
        if (col >= N) continue;
        const float v0 = acc[mt][t][2 * hr], v1 = acc[mt][t][2 * hr + 1];
        const long long o = static_cast<long long>(row) * N + col;
        if (partial != nullptr) {
          float* dst = partial + static_cast<long long>(blockIdx.z) * M * N + o;
          if (vec) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (col + 1 < N) dst[1] = v1;
          }
        } else if (vec) {
          *reinterpret_cast<uint32_t*>(y + o) = pack_bf16(v0 * w_scale[col], v1 * w_scale[col + 1]);
        } else {
          y[o] = __float2bfloat16(v0 * w_scale[col]);
          if (col + 1 < N) y[o + 1] = __float2bfloat16(v1 * w_scale[col + 1]);
        }
      }
    }
  }
}

}  // namespace wo

namespace {

// The K splits' partial tiles summed in split order, then the epilogue.
template <typename Acc, typename Out, bool kDyn>
int reduce_splits(const Acc* part, const void* w_scale, const void* x_scale, void* y, int M,
                  int N, int splits, cudaStream_t stream) {
  const long long mn = static_cast<long long>(M) * N;
  int8_splitk_reduce<Acc, Out, kDyn><<<static_cast<unsigned>((mn + kThreads - 1) / kThreads),
                                       kThreads, 0, stream>>>(
      part, static_cast<const float*>(w_scale), static_cast<const float*>(x_scale),
      static_cast<Out*>(y), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

bool bad_split(int K, int splits, int k_chunk, const void* partial) {
  return splits < 1 || splits > 65535 || (splits > 1 && partial == nullptr) ||
         (K > 0 && (k_chunk < 1 || static_cast<long long>(k_chunk) * splits < K));
}

template <typename Acc, typename Out, bool kDyn>
int launch(const void* x, const void* w, const void* w_scale, const void* x_scale, void* y,
           void* partial, int M, int N, int K, int splits, int k_chunk, cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  if (grid.y > 65535u || bad_split(K, splits, k_chunk, partial)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = N % kColsPerThread == 0 &&
                   reinterpret_cast<std::uintptr_t>(w) % kColsPerThread == 0;
  Acc* part = splits > 1 ? static_cast<Acc*>(partial) : nullptr;
  int8_gemm_kernel<Acc, Out, kDyn><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(x_scale),
      static_cast<Out*>(y), part, M, N, K, k_chunk, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  return reduce_splits<Acc, Out, kDyn>(part, w_scale, x_scale, y, M, N, splits, stream);
}

// The dynamic GEMM on the tensor cores; the K chunk is a whole number of
// stages, so only the last split can end inside one.
int launch_mma(const void* x_q, const void* w_q, const void* w_scale, const void* x_scale,
               void* y, void* partial, int M, int N, int K, int splits, int k_chunk,
               cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + mma::kBN - 1) / mma::kBN, (M + mma::kBM - 1) / mma::kBM, splits);
  if (grid.y > 65535u || bad_split(K, splits, k_chunk, partial) || k_chunk % mma::kBK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(x_q) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(w_q) % 16 == 0;
  int* part = splits > 1 ? static_cast<int*>(partial) : nullptr;
  mma::int8_mma_kernel<<<grid, mma::kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x_q), static_cast<const int8_t*>(w_q),
      static_cast<const float*>(w_scale), static_cast<const float*>(x_scale),
      static_cast<float*>(y), part, M, N, K, k_chunk, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  return reduce_splits<int, float, true>(part, w_scale, x_scale, y, M, N, splits, stream);
}

// The weight-only GEMM of bf16 x on the tensor cores, 16 MT WM-row tiles;
// the K chunk is a whole number of stages, so only the last split can end
// inside one.
template <int MT, int WM>
int launch_wo_mma(const void* x, const void* w_q, const void* w_scale, void* y, void* partial,
                  int M, int N, int K, int splits, int k_chunk, cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  constexpr int kBM = 16 * MT * WM;
  const dim3 grid((N + wo::kBN - 1) / wo::kBN, (M + kBM - 1) / kBM, splits);
  if (grid.y > 65535u || bad_split(K, splits, k_chunk, partial) || k_chunk % wo::kBK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = K % 8 == 0 && N % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(w_q) % 16 == 0;
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  wo::int8_wo_mma_kernel<MT, WM><<<grid, 32 * wo::kWarpsN * WM, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w_q),
      static_cast<const float*>(w_scale), static_cast<__nv_bfloat16*>(y), part, M, N, K,
      k_chunk, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  return reduce_splits<float, __nv_bfloat16, false>(part, w_scale, nullptr, y, M, N, splits,
                                                     stream);
}

}  // namespace

// The weight-only route from x's type and M: f32 x on the CUDA-core template,
// bf16 x on the tensor cores, 16-row tiles up to kWoSmallM rows and 64-row
// tiles above (kernels/int8_matmul.py wo_tile_m and WO_SMALL_M, whose K
// split the caller passes).
constexpr int kWoSmallM = 16;

extern "C" int int8_matmul_wo_launch(int dtype, const void* x, const void* w_q,
                                     const void* w_scale, void* y, void* partial, int m,
                                     int n, int k, int splits, int k_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32) {
    return launch<float, float, false>(x, w_q, w_scale, nullptr, y, partial, m, n, k, splits,
                                       k_chunk, s);
  }
  if (dtype != REPRO_DTYPE_BF16) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= kWoSmallM) {
    return launch_wo_mma<1, 1>(x, w_q, w_scale, y, partial, m, n, k, splits, k_chunk, s);
  }
  return launch_wo_mma<2, 2>(x, w_q, w_scale, y, partial, m, n, k, splits, k_chunk, s);
}

extern "C" int int8_matmul_dyn_launch(const void* x_q, const void* w_q, const void* w_scale,
                                      const void* x_scale, void* y, void* partial, int m,
                                      int n, int k, int splits, int k_chunk, void* stream) {
  return launch_mma(x_q, w_q, w_scale, x_scale, y, partial, m, n, k, splits, k_chunk,
                    static_cast<cudaStream_t>(stream));
}
