// Mamba-2 chunked SSD scan (state-space duality) with the state in shared
// memory.
//
// Replaces: repro/kernels/ssd_scan.py::ssd_scan_pallas (_ssd_kernel).
// Computes, per (batch row b, head h) and per chunk of Q positions, with
// cum the inclusive cumulative sum of dt * A inside the chunk, g = h / (H/G):
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//        + exp(cum_i) C_i h_prev^T                                 (inter)
//        + D x_i
//   h    = exp(cum_last) h_prev + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// and returns y and the state after the last chunk (f32 [P, N]).
// Bound on the H100: at the served prefill (B = 1, T = 256, H = 24, P = 64,
// G = 1, N = 128, one chunk of 256) it moves ~2.5 MB for ~0.5 GFLOP, a
// microsecond either way; this first version is bound by its own f32 FMA
// loops on the CUDA cores and by using only B x H = 24 blocks.
// Design: the state cannot cross a grid axis on a GPU (blocks run in no
// order), so one 256-thread block owns one (b, h) and walks the chunks in
// order, the f32 state held transposed ([N][P + 1]) in shared memory (33 KB
// at full width). At Q = 256 the [Q, Q] score tile would take 256 KB, more
// than an SM has, so the intra-chunk term is tiled 64 x 64 over (i, j),
// causal tiles only, with exp(cum_i - cum_j) evaluated only where j <= i
// (the masked triangle overflows). The cumulative sum is a warp scan (8
// positions per lane, then a shuffle scan): another summation order than
// the reference's, so results agree to a tolerance, not bit for bit.
// Ragged chunks (T not a multiple of Q, or T < Q) are predicated: positions
// past the end contribute nothing, exactly as the reference's zero padding.
// B and C are read from group g, so G > 1 works unchanged.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // rows (i) and columns (j) of one score tile
constexpr int kS4 = kTile + 4;  // float4-aligned padded row stride
constexpr int kS1 = kTile + 1;  // odd row stride (conflict-free columns)
constexpr int kMaxQ = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

size_t smem_floats(int P, int N, int Q) {
  return static_cast<size_t>(kTile) * kS4  // St [64][68]
         + static_cast<size_t>(N) * kS4    // Ct [N][68]
         + static_cast<size_t>(N) * (P + 1)  // ht [N][P+1]
         + static_cast<size_t>(N) * kS1    // Bt [N][65]
         + static_cast<size_t>(kTile) * P  // xs [64][P]
         + kTile                           // ws [64]
         + 2 * static_cast<size_t>(Q);     // cum, dts
}

template <typename T>
__device__ __forceinline__ void load_bx(float* Bt, float* xs, const T* Bb, const T* xb,
                                        long long brow, long long xrow, int t0, int j0,
                                        int L, int P, int N) {
  for (int idx = threadIdx.x; idx < kTile * N; idx += kThreads) {
    const int r = idx / N, n = idx % N;
    const int j = j0 + r;
    Bt[n * kS1 + r] = j < L ? to_f32(Bb[(t0 + j) * brow + n]) : 0.f;
  }
  for (int idx = threadIdx.x; idx < kTile * P; idx += kThreads) {
    const int r = idx / P, p = idx % P;
    const int j = j0 + r;
    xs[r * P + p] = j < L ? to_f32(xb[(t0 + j) * xrow + p]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dp,
                const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hT,
                int Tlen, int H, int P, int G, int N, int Q) {
  extern __shared__ float smem[];
  float* St = smem;               // [64][68]  masked, decayed scores (key-major)
  float* Ct = St + kTile * kS4;   // [N][68]   C of the row tile (n-major)
  float* ht = Ct + N * kS4;       // [N][P+1]  the running state, transposed
  float* Bt = ht + N * (P + 1);   // [N][65]   B of the column tile (n-major)
  float* xs = Bt + N * kS1;       // [64][P]   x of the column tile
  float* ws = xs + kTile * P;     // [64]      state-update weights
  float* cum = ws + kTile;        // [Q]
  float* dts = cum + Q;           // [Q]

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int hp = P + 1;
  const long long xrow = static_cast<long long>(H) * P;
  const long long brow = static_cast<long long>(G) * N;
  const T* xb = x + static_cast<long long>(b) * Tlen * xrow + static_cast<long long>(h) * P;
  T* yb = y + static_cast<long long>(b) * Tlen * xrow + static_cast<long long>(h) * P;
  const float* dtb = dt + static_cast<long long>(b) * Tlen * H + h;
  const T* Bb = Bm + static_cast<long long>(b) * Tlen * brow + static_cast<long long>(g) * N;
  const T* Cb = Cm + static_cast<long long>(b) * Tlen * brow + static_cast<long long>(g) * N;
  const long long sbase = (static_cast<long long>(b) * H + h) * P * N;
  const float a_h = A[h], d_h = Dp[h];

  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    ht[n * hp + p] = h0 != nullptr ? h0[sbase + idx] : 0.f;
  }

  const int n_chunks = (Tlen + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int L = min(Q, Tlen - t0);
    __syncthreads();  // the previous chunk's state update is complete
    for (int i = tid; i < Q; i += kThreads) dts[i] = i < L ? dtb[(t0 + i) * static_cast<long long>(H)] : 0.f;
    __syncthreads();
    if (tid < 32) {  // inclusive cumsum of dt * A: 8 positions per lane, then a warp scan
      const int per = (Q + 31) / 32;
      const int lo = tid * per;
      float local[kMaxQ / 32];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxQ / 32; ++e) {
        const int i = lo + e;
        if (e < per && i < L) run += dts[i] * a_h;
        local[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
#pragma unroll
      for (int e = 0; e < kMaxQ / 32; ++e) {
        const int i = lo + e;
        if (e < per && i < Q) cum[i] = excl + local[e];
      }
    }
    __syncthreads();
    const float total = cum[L - 1];

    // ---- outputs, one 64-row tile at a time
    for (int i0 = 0; i0 < L; i0 += kTile) {
      __syncthreads();  // Ct is free
      for (int idx = tid; idx < kTile * N; idx += kThreads) {
        const int r = idx / N, n = idx % N;
        const int i = i0 + r;
        Ct[n * kS4 + r] = i < L ? to_f32(Cb[(t0 + i) * brow + n]) : 0.f;
      }
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[a][cc] = 0.f;
      // inter-chunk: C_i h_prev^T, then * exp(cum_i)
      for (int n = 0; n < N; ++n) {
        const float4 c4 = *reinterpret_cast<const float4*>(&Ct[n * kS4 + ty * 4]);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float hv = ht[n * hp + min(tx + 16 * cc, P - 1)];
          acc[0][cc] = fmaf(c4.x, hv, acc[0][cc]);
          acc[1][cc] = fmaf(c4.y, hv, acc[1][cc]);
          acc[2][cc] = fmaf(c4.z, hv, acc[2][cc]);
          acc[3][cc] = fmaf(c4.w, hv, acc[3][cc]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float e = expf(cum[min(i0 + ty * 4 + a, Q - 1)]);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[a][cc] *= e;
      }
      // intra-chunk: causal column tiles j0 <= i0
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        __syncthreads();  // St, Bt, xs are free
        load_bx(Bt, xs, Bb, xb, brow, xrow, t0, j0, L, P, N);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.f;
        for (int n = 0; n < N; ++n) {
          const float4 c4 = *reinterpret_cast<const float4*>(&Ct[n * kS4 + ty * 4]);
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const float bv = Bt[n * kS1 + tx + 16 * bb];
            s[0][bb] = fmaf(c4.x, bv, s[0][bb]);
            s[1][bb] = fmaf(c4.y, bv, s[1][bb]);
            s[2][bb] = fmaf(c4.z, bv, s[2][bb]);
            s[3][bb] = fmaf(c4.w, bv, s[3][bb]);
          }
        }
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int j = j0 + tx + 16 * bb;
          float w[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = i0 + ty * 4 + a;
            // exp only where j <= i: the masked triangle overflows (i < L keeps
            // both indices inside the chunk)
            w[a] = (j <= i && i < L) ? s[a][bb] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
          }
          *reinterpret_cast<float4*>(&St[(tx + 16 * bb) * kS4 + ty * 4]) =
              make_float4(w[0], w[1], w[2], w[3]);
        }
        __syncthreads();
#pragma unroll 4
        for (int jj = 0; jj < kTile; ++jj) {
          const float4 s4 = *reinterpret_cast<const float4*>(&St[jj * kS4 + ty * 4]);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float xv = xs[jj * P + min(tx + 16 * cc, P - 1)];
            acc[0][cc] = fmaf(s4.x, xv, acc[0][cc]);
            acc[1][cc] = fmaf(s4.y, xv, acc[1][cc]);
            acc[2][cc] = fmaf(s4.z, xv, acc[2][cc]);
            acc[3][cc] = fmaf(s4.w, xv, acc[3][cc]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty * 4 + a;
        if (i >= L) continue;
        const long long off = (t0 + i) * xrow;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int p = tx + 16 * cc;
          if (p < P) yb[off + p] = from_f32<T>(acc[a][cc] + d_h * to_f32(xb[off + p]));
        }
      }
    }

    // ---- state update: h = exp(total) h_prev + sum_j exp(total - cum_j) dt_j x_j B_j^T
    float u[kMaxN / 16][4];
#pragma unroll
    for (int a = 0; a < kMaxN / 16; ++a)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) u[a][cc] = 0.f;
    for (int j0 = 0; j0 < L; j0 += kTile) {
      __syncthreads();  // Bt, xs, ws are free
      load_bx(Bt, xs, Bb, xb, brow, xrow, t0, j0, L, P, N);
      if (tid < kTile) {
        const int j = j0 + tid;
        ws[tid] = j < L ? expf(total - cum[j]) * dts[j] : 0.f;
      }
      __syncthreads();
      const int nj = min(kTile, L - j0);
      for (int jj = 0; jj < nj; ++jj) {
        const float w = ws[jj];
        float xv[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) xv[cc] = xs[jj * P + min(tx + 16 * cc, P - 1)];
#pragma unroll
        for (int a = 0; a < kMaxN / 16; ++a) {
          const float bv = Bt[min(ty + 16 * a, N - 1) * kS1 + jj] * w;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) u[a][cc] = fmaf(bv, xv[cc], u[a][cc]);
        }
      }
    }
    __syncthreads();  // every read of h_prev is done
    const float decay = expf(total);
#pragma unroll
    for (int a = 0; a < kMaxN / 16; ++a) {
      const int n = ty + 16 * a;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = tx + 16 * cc;
        if (n < N && p < P) ht[n * hp + p] = decay * ht[n * hp + p] + u[a][cc];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx % N;
    hT[sbase + idx] = ht[n * hp + p];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* Dp, const float* h0, void* y, float* hT, int B, int Tlen, int H,
           int P, int G, int N, int Q, cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || Q > kMaxQ || G < 1 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_floats(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      Dp, h0, static_cast<T*>(y), hT, Tlen, H, P, G, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h0 may be null (zero initial state). dt, A, D, h0 and hT are f32; x, B, C
// and y are of the element type ``dtype``.
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* Dp,
                               const void* h0, void* y, void* hT, int B, int Tlen, int H,
                               int P, int G, int N, int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(Dp);
  const float* h0f = static_cast<const float*>(h0);
  float* hTf = static_cast<float*>(hT);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float>(x, dtf, Af, Bm, Cm, Df, h0f, y, hTf, B, Tlen, H, P, G, N, Q, s);
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, Df, h0f, y, hTf, B, Tlen, H, P, G, N,
                                 Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
