// Mamba-2 chunked SSD scan (state-space duality).
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
// microsecond either way; what sets its time is latency and parallelism.
//
// Dispatch by type, not a fallback: bf16 runs the chunk-parallel
// tensor-core route below, f32 the single-block walk (exact f32 FMAs, which
// the f32 tolerance needs; f32 on the tensor cores would be TF32).
//
// bf16 (namespace tc; the GPU form of mamba_ssm's Triton kernels: chunk
// state, state passing, chunk scan). The state cannot cross a grid axis on
// a GPU, so the recurrence is taken out of the chunks' work:
//   1. ssd_chunk_state_kernel, grid (chunk x N slice of 32, head, row): the
//      chunk's cumulative decay (a warp scan, written to an f32 workspace
//      [B, H, n_chunks, Q] so that stage 3 reads the very same values) and
//      its own state S_c = sum_j exp(total - cum_j) dt_j x_j B_j^T on
//      mma.sync m16n8k16. With one chunk it writes the final state itself
//      (exp(total) h0 + S_0) and stage 2 is not launched.
//   2. ssd_state_passing_kernel, one thread per (b, h, p, n), sequential
//      over chunks: h_c = exp(total_c) h_{c-1} + S_c, from initial_state
//      or 0; the state before each chunk overwrites S_c in the workspace,
//      the last state goes to hT.
//   3. ssd_chunk_scan_kernel, grid (64-row tile x chunk, head, row), heavy
//      (late) row tiles first: C.B^T per causal 64-column tile on mma.sync
//      (bf16 operands, so the products are exact), the decay weights
//      w_ij = s_ij exp(cum_i - cum_j) dt_j formed in f32 in the
//      accumulator's fragment layout, then W.x, + exp(cum_i) C.h_prev^T
//      and + D x in the epilogue. On the diagonal tile exp is taken per
//      pair and only where j <= i (the masked triangle overflows); below it
//      every j < i, and exp(cum_i - cum_j) = exp(cum_i - cum_r)
//      exp(cum_r - cum_j), r the tile's last column, both factors <= 1:
//      one exp per row and tile, one per column and block.
// What sets the time at the served prefill (one chunk, 24 heads, 96 blocks
// of stage 3 on 132 SMs) is latency, not bytes or operations: each warp's
// chain per column tile of loads, exp, operand splits and mma, with few
// warps per SM to hide it. So stages 1 and 3 run two warps per 16-row
// slab, each taking half of every step (alternate 16-position steps of j
// in stage 1; half of each column tile, and of N in C.h_prev^T, in stage
// 3), and add the second warp's sums to the first's once, through shared
// memory, in a fixed order; and the per-pair exp is factored as above.
// Precision sets the design: the final state is held at atol 2e-4 / rtol
// 2e-3 in both types. An f32 operand rounded once to bf16 (x * sw of the
// state update) puts thousands of state elements outside that (a CPU test
// pins it), so every f32 operand (x * sw, h_prev, and W) goes to the tensor
// cores as hi = bf16(v) and lo = bf16(v - hi), two mma against the exact
// bf16 operand: ~2^-17 relative, f32-like. No atomics: a repeat call is
// bit-identical. Tiles are padded to P = 64, N = 128 with zeros (rows past
// the chunk's end too, so no garbage meets a zero weight), loaded by
// cp.async where a 16-byte chunk is whole and aligned.
//
// f32 (ssd_scan_kernel, the first design): one 256-thread block owns one
// (b, h) and walks the chunks in order, the f32 state held transposed
// ([N][P + 1]) in shared memory (33 KB at full width). At Q = 256 the
// [Q, Q] score tile would take 256 KB, more than an SM has, so the
// intra-chunk term is tiled 64 x 64 over (i, j), causal tiles only. The
// cumulative sum is a warp scan (8 positions per lane, then a shuffle
// scan): another summation order than the reference's, so results agree to
// a tolerance, not bit for bit. Ragged chunks (T not a multiple of Q, or
// T < Q) are predicated in both routes: positions past the end contribute
// nothing, exactly as the reference's zero padding. B and C are read from
// group g, so G > 1 works unchanged.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

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

// Inclusive cumulative sum of dt * A over the chunk's first L positions,
// into cum[0, Q) (positions past L hold the last sum), by one warp: 8
// positions per lane, then a shuffle scan. Both routes call it, so their
// decays are summed in one order.
__device__ __forceinline__ void chunk_cumsum(float* cum, const float* dts, float a_h, int L,
                                             int Q) {
  const int lane = threadIdx.x % 32;
  const int per = (Q + 31) / 32;
  const int lo = lane * per;
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
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int e = 0; e < kMaxQ / 32; ++e) {
    const int i = lo + e;
    if (e < per && i < Q) cum[i] = excl + local[e];
  }
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
    if (tid < 32) chunk_cumsum(cum, dts, a_h, L, Q);
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

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kSlabs = 4;      // 16-row slabs per block
constexpr int kNS = 32;        // state columns (N) per chunk-state block
constexpr int kRows = 64;      // rows (i) per chunk-scan block, 16 per slab
constexpr int kTileJ = 64;     // columns (j) per chunk-scan tile
constexpr int kHalfJ = kTileJ / 2;       // columns of a tile per chunk-scan warp
constexpr int kWideThreads = 2 * kSlabs * 32;  // stages 1 and 3: two warps per slab
constexpr int kSP = kMaxP + 8;  // bf16 row strides: 16 bytes of padding keep
constexpr int kSN = kMaxN + 8;  // the 8 rows of every ldmatrix in 8 bank groups
constexpr int kSNs = kNS + 8;
constexpr int kPassThreads = 256;

constexpr size_t state_smem_bytes() {
  return sizeof(bf16) * (2 * static_cast<size_t>(kMaxQ) * kSP  // xhi, xlo [Q][72]
                         + static_cast<size_t>(kMaxQ) * kSNs)  // bs [Q][40]
         + sizeof(float) * 2 * kMaxQ;                          // cum, w
}

constexpr size_t scan_smem_bytes() {
  return sizeof(bf16) * (static_cast<size_t>(kRows) * kSN          // cs [64][136]
                         + 2 * static_cast<size_t>(kTileJ) * kSN   // bs [2][64][136]
                         + 2 * static_cast<size_t>(kTileJ) * kSP   // xs [2][64][72]
                         + 2 * static_cast<size_t>(kMaxP) * kSN)   // hhi, hlo [64][136]
         + sizeof(float) * 3 * kMaxQ;                              // cum, dts, ebs
}

// v = hi + lo with hi = bf16(v), lo = bf16(v - hi): ~2^-17 relative
__device__ __forceinline__ void split_bf16(float v, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16(v));
  lo = v - hi;
}

// rows [0, rows) x columns [0, width) of a bf16 tile into shared memory
// (row stride `stride`), from `src` with row stride `ld` elements; row r is
// real when r < valid and column c when c < cols, the rest is zero. A whole,
// 16-byte-aligned chunk of 8 goes by cp.async, anything else element-wise.
__device__ __forceinline__ void load_tile(bf16* dst, int stride, const bf16* src, long long ld,
                                          int rows, int valid, int width, int cols) {
  const int chunks = width / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i % chunks;
    bf16* d = dst + r * stride + c * 8;
    const int n_el = r < valid ? max(0, min(8, cols - c * 8)) : 0;
    if (n_el == 0) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const bf16* g = src + r * ld + c * 8;
    if (n_el == 8 && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      cp_async16(d, g, 16);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = e < n_el ? g[e] : __float2bfloat16(0.f);
    }
  }
}

// Stage 1: per (chunk c, 32-column slice of N, head h, row b), the chunk's
// cumulative decay (into cum_ws by the slice-0 block) and its own state
// S_c[p, n] = sum_j (x_j[p] sw_j) B_j[n], sw_j = exp(total - cum_j) dt_j, as
// (x sw)^T B on mma.sync: x sw split hi + lo, B exact. With one chunk it
// writes hT = exp(total) h0 + S_0; else S_c into states. Two warps share
// each 16-row slab of P, taking alternate 16-position steps of j; the
// second's sums are added to the first's once, in a fixed order.
__global__ void __launch_bounds__(kWideThreads)
ssd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const bf16* __restrict__ Bm,
                       const float* __restrict__ h0, float* __restrict__ hT,
                       float* __restrict__ cum_ws, float* __restrict__ states, int Tlen,
                       int H, int P, int G, int N, int Q, int n_slices) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xhi = reinterpret_cast<bf16*>(smem_raw);  // [Q][kSP]  (x sw) hi, j-major
  bf16* xlo = xhi + kMaxQ * kSP;                   // [Q][kSP]  (x sw) lo
  bf16* bs = xlo + kMaxQ * kSP;                    // [Q][kSNs] B's slice
  float* cum = reinterpret_cast<float*>(bs + kMaxQ * kSNs);  // [Q]
  float* ws = cum + kMaxQ;                                   // [Q] dt, then sw

  const int n_chunks = (Tlen + Q - 1) / Q;
  const int c = blockIdx.x / n_slices, n0 = (blockIdx.x % n_slices) * kNS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int slab = warp % kSlabs, half = warp / kSlabs;  // rows of P slab*16.., j steps
  const int t0 = c * Q, L = min(Q, Tlen - t0);
  const int Lk = (L + 15) / 16 * 16;  // rows the mma k-steps read
  const long long xrow = static_cast<long long>(H) * P;
  const long long brow = static_cast<long long>(G) * N;
  const bf16* xb = x + (static_cast<long long>(b) * Tlen + t0) * xrow + static_cast<long long>(h) * P;
  const bf16* Bb = Bm + (static_cast<long long>(b) * Tlen + t0) * brow + static_cast<long long>(g) * N;
  const long long bh = static_cast<long long>(b) * H + h;

  load_tile(bs, kSNs, Bb + n0, brow, Lk, L, kNS, N - n0);
  load_tile(xhi, kSP, xb, xrow, Lk, L, kMaxP, P);  // x itself, split in place below
  cp_async_commit();
  for (int i = tid; i < Q; i += kWideThreads)
    ws[i] = i < L ? dt[(static_cast<long long>(b) * Tlen + t0 + i) * H + h] : 0.f;
  __syncthreads();
  if (warp == 0) chunk_cumsum(cum, ws, A[h], L, Q);
  __syncthreads();
  const float total = cum[L - 1];
  if (blockIdx.x % n_slices == 0)
    for (int i = tid; i < Q; i += kWideThreads) cum_ws[(bh * n_chunks + c) * Q + i] = cum[i];
  for (int i = tid; i < Q; i += kWideThreads) ws[i] = i < L ? expf(total - cum[i]) * ws[i] : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  // x * sw, split in place, j-major: each item owns one 16-byte chunk
  for (int i = tid; i < Lk * (kMaxP / 8); i += kWideThreads) {
    const int j = i / (kMaxP / 8), p0 = (i % (kMaxP / 8)) * 8;
    uint4* hi8 = reinterpret_cast<uint4*>(xhi + j * kSP + p0);
    const uint4 raw = *hi8;
    const bf16* e8 = reinterpret_cast<const bf16*>(&raw);
    const float w = ws[j];
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float h0v, l0v, h1v, l1v;
      split_bf16(__bfloat162float(e8[e]) * w, h0v, l0v);
      split_bf16(__bfloat162float(e8[e + 1]) * w, h1v, l1v);
      hi[e / 2] = pack_bf16(h0v, h1v);
      lo[e / 2] = pack_bf16(l0v, l1v);
    }
    *hi8 = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(xlo + j * kSP + p0) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  __syncthreads();

  const int p0 = slab * 16;  // this slab's 16 rows of P
  const bool live = p0 < P;
  float acc[kNS / 8][4];
#pragma unroll
  for (int n = 0; n < kNS / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // A = (x sw)^T [p][j] from the j-major tiles by ldmatrix.trans: matrix i
  // of lane l is rows j = k0 + 8 (i / 2) + l % 8, columns p0 + 8 (i % 2)
  const int a_row = 8 * ((lane / 8) / 2) + lane % 8, a_col = p0 + 8 * ((lane / 8) % 2);
  for (int k0 = 16 * half; live && k0 < Lk; k0 += 32) {
    // every fragment of the step first, then the products in an order where
    // consecutive mma write different accumulators
    uint32_t ahi[4], alo[4], bf[kNS / 16][4];
    ldmatrix_x4_trans(ahi, xhi + (k0 + a_row) * kSP + a_col);
    ldmatrix_x4_trans(alo, xlo + (k0 + a_row) * kSP + a_col);
#pragma unroll
    for (int n = 0; n < kNS / 16; ++n)  // B[j][n]: rows k0.., columns 16n .. 16n + 15
      ldmatrix_x4_trans(bf[n], bs + (k0 + lane % 16) * kSNs + n * 16 + (lane / 16) * 8);
#pragma unroll
    for (int n = 0; n < kNS / 8; ++n)
      mma_bf16_16816(acc[n], ahi, bf[n / 2][2 * (n % 2)], bf[n / 2][2 * (n % 2) + 1]);
#pragma unroll
    for (int n = 0; n < kNS / 8; ++n)
      mma_bf16_16816(acc[n], alo, bf[n / 2][2 * (n % 2)], bf[n / 2][2 * (n % 2) + 1]);
  }
  __syncthreads();  // every read of the tiles is done: xlo holds the sums now
  float* red = reinterpret_cast<float*>(xlo);  // [slab][n][e][lane]
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < kNS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[((slab * (kNS / 8) + n) * 4 + e) * 32 + lane] = acc[n][e];
  }
  __syncthreads();
  if (half == 1 || !live) return;
#pragma unroll
  for (int n = 0; n < kNS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += red[((slab * (kNS / 8) + n) * 4 + e) * 32 + lane];
  const float decay = expf(total);
#pragma unroll
  for (int n = 0; n < kNS / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + gid + 8 * (e / 2), col = n0 + n * 8 + 2 * tig + (e & 1);
      if (p >= P || col >= N) continue;
      const long long at = static_cast<long long>(p) * N + col;
      if (n_chunks == 1) {
        hT[bh * P * N + at] = (h0 != nullptr ? decay * h0[bh * P * N + at] : 0.f) + acc[n][e];
      } else {
        states[(bh * n_chunks + c) * P * N + at] = acc[n][e];
      }
    }
  }
}

// Stage 2 (more than one chunk, or none): one thread per (b, h, p, n), in
// chunk order, h_c = exp(total_c) h_{c-1} + S_c from h0 or 0. The state
// before chunk c overwrites S_c; the last state goes to hT.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_passing_kernel(const float* __restrict__ h0, const float* __restrict__ cum_ws,
                         float* __restrict__ states, float* __restrict__ hT, long long n_elem,
                         int Tlen, int P, int N, int Q) {
  const long long idx = static_cast<long long>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (idx >= n_elem) return;
  const long long pn = static_cast<long long>(P) * N;
  const long long bh = idx / pn, e = idx % pn;
  const int n_chunks = (Tlen + Q - 1) / Q;
  float s = h0 != nullptr ? h0[idx] : 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const long long at = (bh * n_chunks + c) * pn + e;
    const float upd = states[at];
    states[at] = s;
    const int L = min(Q, Tlen - c * Q);
    s = expf(cum_ws[(bh * n_chunks + c) * Q + L - 1]) * s + upd;
  }
  hT[idx] = s;
}

// Stage 3: per (64-row tile, chunk, head, row), y for the tile's rows:
// exp(cum_i) C_i h_prev^T (h_prev split hi + lo), then per causal
// 64-column tile S = C B^T, W = S exp(cum_i - cum_j) dt_j for j <= i (f32,
// fragment layout), y += W x (W split hi + lo); + D x in the epilogue.
// Two warps share each 16-row slab, one per half of every column tile (and
// of N in C h_prev^T): a warp's chain of exp, split and mma per tile is
// what sets the time, so halving it and doubling the warps that hide each
// other's latency is the lever. The second half's partial sums are added
// to the first's once, through shared memory, in a fixed order.
__global__ void __launch_bounds__(kWideThreads)
ssd_chunk_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                      const float* __restrict__ Dp, const float* __restrict__ h0,
                      const float* __restrict__ cum_ws, const float* __restrict__ states,
                      bf16* __restrict__ y, int Tlen, int H, int P, int G, int N, int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);  // [64][kSN]     C of the row tile
  bf16* bs = cs + kRows * kSN;                    // [2][64][kSN]  B of a column tile
  bf16* xs = bs + 2 * kTileJ * kSN;               // [2][64][kSP]  x of a column tile
  bf16* hhi = xs + 2 * kTileJ * kSP;              // [64][kSN]     h_prev hi, [p][n]
  bf16* hlo = hhi + kMaxP * kSN;                  // [64][kSN]     h_prev lo
  float* cum = reinterpret_cast<float*>(hlo + kMaxP * kSN);  // [Q]
  float* dts = cum + kMaxQ;                                  // [Q]
  float* ebs = dts + kMaxQ;  // [Q] exp(cum_r - cum_j) dt_j, r the last column of j's tile

  const int n_chunks = (Tlen + Q - 1) / Q;
  const int n_rt = (Q + kRows - 1) / kRows;
  const int rt = n_rt - 1 - static_cast<int>(blockIdx.x) / n_chunks;  // heavy tiles first
  const int c = blockIdx.x % n_chunks;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * Q, L = min(Q, Tlen - t0), i0 = rt * kRows;
  if (i0 >= L) return;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int slab = warp % kSlabs, half = warp / kSlabs;  // rows slab*16.., column half
  const int jh = half * kHalfJ;
  const long long xrow = static_cast<long long>(H) * P;
  const long long brow = static_cast<long long>(G) * N;
  const bf16* xb = x + (static_cast<long long>(b) * Tlen + t0) * xrow + static_cast<long long>(h) * P;
  bf16* yb = y + (static_cast<long long>(b) * Tlen + t0) * xrow + static_cast<long long>(h) * P;
  const bf16* Bb = Bm + (static_cast<long long>(b) * Tlen + t0) * brow + static_cast<long long>(g) * N;
  const bf16* Cb = Cm + (static_cast<long long>(b) * Tlen + t0) * brow + static_cast<long long>(g) * N;
  const long long bh = static_cast<long long>(b) * H + h;
  const long long pn = static_cast<long long>(P) * N;
  // the state before this chunk: h0 (one chunk) or stage 2's; none is zero
  const float* hp = n_chunks == 1 ? (h0 != nullptr ? h0 + bh * pn : nullptr)
                                  : (c > 0 || h0 != nullptr ? states + (bh * n_chunks + c) * pn
                                                            : nullptr);

  auto load_bx = [&](int j0, int sb) {
    load_tile(bs + sb * kTileJ * kSN, kSN, Bb + j0 * brow, brow, kTileJ, L - j0, kMaxN, N);
    load_tile(xs + sb * kTileJ * kSP, kSP, xb + j0 * xrow, xrow, kTileJ, L - j0, kMaxP, P);
  };
  load_tile(cs, kSN, Cb + i0 * brow, brow, kRows, L - i0, kMaxN, N);
  load_bx(0, 0);
  cp_async_commit();
  for (int i = tid; i < Q; i += kWideThreads) {
    cum[i] = cum_ws[(bh * n_chunks + c) * Q + i];
    dts[i] = i < L ? dt[(static_cast<long long>(b) * Tlen + t0 + i) * H + h] : 0.f;
  }
  if (hp != nullptr) {  // h_prev [p][n], split, 4 columns per item
#pragma unroll 4
    for (int i = tid; i < kMaxP * (kMaxN / 4); i += kWideThreads) {
      const int p = i / (kMaxN / 4), n = (i % (kMaxN / 4)) * 4;
      float v[4];
      if (p < P && n + 4 <= N && (reinterpret_cast<uintptr_t>(hp + p * N + n) & 15) == 0) {
        const float4 f = *reinterpret_cast<const float4*>(hp + p * N + n);
        v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = p < P && n + e < N ? hp[p * N + n + e] : 0.f;
      }
      float hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_bf16(v[e], hi[e], lo[e]);
      *reinterpret_cast<uint2*>(hhi + p * kSN + n) =
          make_uint2(pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3]));
      *reinterpret_cast<uint2*>(hlo + p * kSN + n) =
          make_uint2(pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]));
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < Q; i += kWideThreads)  // <= 1: cum falls along the chunk
    ebs[i] = expf(cum[min(i / kTileJ * kTileJ + kTileJ - 1, Q - 1)] - cum[i]) * dts[i];
  __syncthreads();

  uint32_t cf[kMaxN / 16][4];  // the slab's 16 x N C fragments
#pragma unroll
  for (int kk = 0; kk < kMaxN / 16; ++kk)
    ldmatrix_x4(cf[kk], cs + (slab * 16 + lane % 16) * kSN + kk * 16 + (lane / 16) * 8);
  const int ir[2] = {i0 + slab * 16 + gid, i0 + slab * 16 + gid + 8};  // this thread's rows
  float cum_i[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) cum_i[r] = cum[min(ir[r], Q - 1)];

  float acc[kMaxP / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  if (hp != nullptr) {  // inter-chunk: C h_prev^T, B operand h_prev [p][n] (k = n, this half)
#pragma unroll
    for (int kk = 0; kk < kMaxN / 16; kk += 2) {
      if (kk / (kMaxN / 32) != half) continue;  // constant indices keep cf in registers
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // h_prev hi, then lo
        uint32_t bh[kMaxP / 8][4];  // p rows n*8.., n in [kk*16, kk*16 + 32)
#pragma unroll
        for (int n = 0; n < kMaxP / 8; ++n)
          ldmatrix_x4(bh[n], (half ? hlo : hhi) + (n * 8 + lane % 8) * kSN + kk * 16 +
                                 (lane / 8) * 8);
#pragma unroll
        for (int n = 0; n < kMaxP / 8; ++n) mma_bf16_16816(acc[n], cf[kk], bh[n][0], bh[n][1]);
#pragma unroll
        for (int n = 0; n < kMaxP / 8; ++n)
          mma_bf16_16816(acc[n], cf[kk + 1], bh[n][2], bh[n][3]);
      }
    }
    const float e0 = expf(cum_i[0]), e1 = expf(cum_i[1]);
#pragma unroll
    for (int n = 0; n < kMaxP / 8; ++n) {
      acc[n][0] *= e0;
      acc[n][1] *= e0;
      acc[n][2] *= e1;
      acc[n][3] *= e1;
    }
  }

  int sb = 0;
  for (int j0 = 0; j0 <= i0; j0 += kTileJ) {
    if (j0 + kTileJ <= i0) {
      load_bx(j0 + kTileJ, sb ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* bt = bs + sb * kTileJ * kSN;
    const bf16* xt = xs + sb * kTileJ * kSP;
    float s[kHalfJ / 8][4];  // S = C B^T: 8 columns (j) per n-tile, this half's
#pragma unroll
    for (int n = 0; n < kHalfJ / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxN / 16; kk += 2) {
      uint32_t bf[kHalfJ / 8][4];  // columns jh + n*8.., n in [kk*16, kk*16 + 32)
#pragma unroll
      for (int n = 0; n < kHalfJ / 8; ++n)
        ldmatrix_x4(bf[n], bt + (jh + n * 8 + lane % 8) * kSN + kk * 16 + (lane / 8) * 8);
#pragma unroll
      for (int n = 0; n < kHalfJ / 8; ++n) mma_bf16_16816(s[n], cf[kk], bf[n][0], bf[n][1]);
#pragma unroll
      for (int n = 0; n < kHalfJ / 8; ++n) mma_bf16_16816(s[n], cf[kk + 1], bf[n][2], bf[n][3]);
    }
    // the decay: below the diagonal tile every j < i, and exp(cum_i - cum_j)
    // = exp(cum_i - cum_r) exp(cum_r - cum_j) with r = j0 + 63, both factors
    // <= 1; on the diagonal tile one exp per pair, taken only where j <= i
    // (the masked triangle overflows; i < L keeps both inside the chunk)
    const bool diag = j0 == i0;
    float ea[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) ea[r] = diag ? 0.f : expf(cum_i[r] - cum[j0 + kTileJ - 1]);
#pragma unroll
    for (int n = 0; n < kHalfJ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ir[e / 2], j = j0 + jh + n * 8 + 2 * tig + (e & 1);
        if (diag) {
          s[n][e] = (j <= i && i < L) ? s[n][e] * expf(cum_i[e / 2] - cum[j]) * dts[j] : 0.f;
        } else {
          s[n][e] = i < L ? s[n][e] * ea[e / 2] * ebs[j] : 0.f;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kHalfJ / 16; ++kk) {  // columns jh + kk*16 .. jh + kk*16 + 15
      float hi[8], lo[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split_bf16(s[2 * kk][e], hi[e], lo[e]);
        split_bf16(s[2 * kk + 1][e], hi[4 + e], lo[4 + e]);
      }
      const uint32_t whi[4] = {pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3]),
                               pack_bf16(hi[4], hi[5]), pack_bf16(hi[6], hi[7])};
      const uint32_t wlo[4] = {pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]),
                               pack_bf16(lo[4], lo[5]), pack_bf16(lo[6], lo[7])};
      uint32_t bx[kMaxP / 16][4];  // x rows kk*16.., columns 16n .. 16n + 15
#pragma unroll
      for (int n = 0; n < kMaxP / 16; ++n)
        ldmatrix_x4_trans(bx[n], xt + (jh + kk * 16 + lane % 16) * kSP + n * 16 +
                                     (lane / 16) * 8);
#pragma unroll
      for (int n = 0; n < kMaxP / 8; ++n)
        mma_bf16_16816(acc[n], whi, bx[n / 2][2 * (n % 2)], bx[n / 2][2 * (n % 2) + 1]);
#pragma unroll
      for (int n = 0; n < kMaxP / 8; ++n)
        mma_bf16_16816(acc[n], wlo, bx[n / 2][2 * (n % 2)], bx[n / 2][2 * (n % 2) + 1]);
    }
    __syncthreads();  // buffer sb is free for the tile after next
    sb ^= 1;
  }

  // the second half's sums onto the first's (the B buffers are free now)
  float* red = reinterpret_cast<float*>(bs);  // [slab][n][e][lane], 16 KB
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < kMaxP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[((slab * (kMaxP / 8) + n) * 4 + e) * 32 + lane] = acc[n][e];
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += red[((slab * (kMaxP / 8) + n) * 4 + e) * 32 + lane];

  // + D x, x from the diagonal's tile (rows i0 .. i0 + 63, still resident);
  // pairs of columns as one 4-byte store where P is even
  const float d_h = Dp[h];
  const bf16* xd = xs + ((i0 / kTileJ) & 1) * kTileJ * kSP;
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = ir[r], p = n * 8 + 2 * tig;
      if (i >= L || p >= P) continue;
      const bf16* xv = xd + (i - i0) * kSP + p;
      const float y0 = acc[n][2 * r] + d_h * __bfloat162float(xv[0]);
      const float y1 = acc[n][2 * r + 1] + d_h * __bfloat162float(xv[1]);
      bf16* out = yb + i * xrow + p;
      if (P % 2 == 0) {
        *reinterpret_cast<uint32_t*>(out) = pack_bf16(y0, y1);
      } else {
        out[0] = __float2bfloat16(y0);
        if (p + 1 < P) out[1] = __float2bfloat16(y1);
      }
    }
  }
}

}  // namespace tc

template <typename T>
int launch_f32(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
               const float* Dp, const float* h0, void* y, float* hT, int B, int Tlen, int H,
               int P, int G, int N, int Q, cudaStream_t stream) {
  static bool smem_allowed[kMaxDevices] = {};
  const size_t smem = sizeof(float) * smem_floats(kMaxP, kMaxN, kMaxQ);
  const cudaError_t err = allow_smem(ssd_scan_kernel<T>, smem, smem_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<dim3(H, B), kThreads, sizeof(float) * smem_floats(P, N, Q), stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      Dp, h0, static_cast<T*>(y), hT, Tlen, H, P, G, N, Q);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
              const float* Dp, const float* h0, void* y, float* hT, float* cum_ws,
              float* states, int B, int Tlen, int H, int P, int G, int N, int Q,
              cudaStream_t stream) {
  using tc::bf16;
  static bool state_allowed[kMaxDevices] = {}, scan_allowed[kMaxDevices] = {};
  const int n_chunks = (Tlen + Q - 1) / Q;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  if (n_chunks >= 1) {
    const cudaError_t e =
        allow_smem(tc::ssd_chunk_state_kernel, tc::state_smem_bytes(), state_allowed);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int n_slices = (N + tc::kNS - 1) / tc::kNS;
    tc::ssd_chunk_state_kernel<<<dim3(n_chunks * n_slices, H, B), tc::kWideThreads,
                                 tc::state_smem_bytes(), stream>>>(
        xb, dt, A, Bb, h0, hT, cum_ws, states, Tlen, H, P, G, N, Q, n_slices);
    const cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess) return static_cast<int>(le);
  }
  if (n_chunks != 1) {
    const long long n_elem = static_cast<long long>(B) * H * P * N;
    const long long blocks = (n_elem + tc::kPassThreads - 1) / tc::kPassThreads;
    tc::ssd_state_passing_kernel<<<static_cast<unsigned>(blocks), tc::kPassThreads, 0,
                                   stream>>>(h0, cum_ws, states, hT, n_elem, Tlen, P, N, Q);
    const cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess) return static_cast<int>(le);
  }
  if (n_chunks >= 1) {
    const cudaError_t e =
        allow_smem(tc::ssd_chunk_scan_kernel, tc::scan_smem_bytes(), scan_allowed);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int n_rt = (Q + tc::kRows - 1) / tc::kRows;
    tc::ssd_chunk_scan_kernel<<<dim3(n_rt * n_chunks, H, B), tc::kWideThreads,
                                tc::scan_smem_bytes(), stream>>>(
        xb, dt, Bb, static_cast<const bf16*>(Cm), Dp, h0, cum_ws, states,
        static_cast<bf16*>(y), Tlen, H, P, G, N, Q);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h0 may be null (zero initial state). dt, A, D, h0 and hT are f32; x, B, C
// and y are of the element type ``dtype``. The bf16 route's f32 workspaces:
// cum_ws [B, H, n_chunks, Q] and, with more than one chunk, states
// [B, H, n_chunks, P, N] (null otherwise); the f32 route takes none.
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* Dp,
                               const void* h0, void* y, void* hT, void* cum_ws, void* states,
                               int B, int Tlen, int H, int P, int G, int N, int Q,
                               void* stream) {
  if (B == 0 || H == 0) return 0;
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || Q > kMaxQ || G < 1 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(Dp);
  const float* h0f = static_cast<const float*>(h0);
  float* hTf = static_cast<float*>(hT);
  if (dtype == REPRO_DTYPE_F32)
    return launch_f32<float>(x, dtf, Af, Bm, Cm, Df, h0f, y, hTf, B, Tlen, H, P, G, N, Q, s);
  if (dtype == REPRO_DTYPE_BF16)
    return launch_tc(x, dtf, Af, Bm, Cm, Df, h0f, y, hTf, static_cast<float*>(cum_ws),
                     static_cast<float*>(states), B, Tlen, H, P, G, N, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
