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
// flops (0.54 GFLOP at T = 256) over ~T * (Hq + 2 Hkv) * D * 2 bytes:
// about 30 flop/byte, below the bf16 ridge, so bytes bound it in principle
// (0.8 us); in practice a call this small is bound by latency: the chain of
// loads, products and softmax steps of one block over its few key tiles.
//
// Both types share the block shape: one block per (query tile, batch row x
// KV head) holds the G query heads of its KV head for 64 / G positions (64
// query rows; row r is position t_lo + r / G, q head h * G + r % G), walks
// the keys in tiles of 64, first loads a tile's positions and validity and
// skips the tile when no (query, key) pair of it is unmasked (causal tile
// skipping, as the Pallas kernel's pl.when), and keeps a running max and sum
// per row.
//
// Dispatch by type, not a fallback: a bf16 call runs the tensor-core kernel
// and an f32 call the CUDA-core kernel, each held against the plain version.
// f32 on the tensor cores would be TF32 (~1e-3 relative), which cannot meet
// the f32 tolerance (atol 2e-5, rtol 2e-4), so f32 keeps exact f32 FMAs.
//
// bf16 (flash_attention_mma_kernel): 4 warps of 16 query rows each; heavy
// (late) query tiles are launched first.
// S = Q.K^T runs as mma.sync m16n8k16 bf16 -> f32 with Q's fragments held in
// registers for the block's life and K's read by ldmatrix; `scale` (times
// log2 e, for exp2) is applied to the f32 S accumulator, never to a bf16 Q,
// as the reference scales in f32. Mask, row max and row sum stay in the
// accumulator's fragment layout (row max by two quad shuffles; the sum is
// kept per thread and reduced once at the end). P is rounded to bf16 and
// reused from S's registers as the A fragment of P.V (FlashAttention-2's
// register reuse); V's fragments come by ldmatrix.trans. That bf16 P is the
// one rounding the f32 reference does not have: it stays inside the bf16
// tolerance (a CPU test emulates it against the JAX reference). K/V tiles
// are double-buffered in shared memory by cp.async (zero-filled past Tk),
// so the next live tile loads while this one computes; rows are padded to
// D + 8 elements, which keeps every ldmatrix free of bank conflicts. No
// score tile goes through shared memory. The output is staged through the
// warp's own Q rows for 16-byte stores. A masked score is -inf, so its p is
// exactly 0 while the running max starts at the -1e30 sentinel: a fully
// masked row keeps l = 0 and gives exact zeros through the clamp.
//
// f32 (flash_attention_kernel, 256 threads, the first design): Q scaled in
// f32, K and V tiles in shared memory, scores and the P.V update by f32 FMA
// loops. A block takes 64 consecutive (position, q head) rows of one KV
// head's group, whatever G (32 rows and 32-key tiles at D = 576, where a
// 64-row Q tile alone would be 147 KB). wgmma, TMA and warp specialisation
// are later work.
//
// Widths: both kernels are templated on (D, Dv): D == Dv in {16, 32, 64,
// 128, 256} and MLA's prefill (96, 64) (the smoke config) and (192, 128),
// where q/k rows are nope + rope and v rows v_head (V tiles at their own
// stride; the output staged in the warp's Q rows). At D = 16 the bf16
// kernel's one k-step of 16 reads K by ldmatrix.x2; the rows (D + 8
// elements: 48 bytes at 16, 80 at 32) stay an odd count of 16-byte units,
// so every ldmatrix is free of bank conflicts at every width. At (256, 256)
// (recurrentgemma: G = 10 over one KV head, 6 positions a 64-row block,
// window 2048) a warp's output tile alone is 128 f32 registers a thread, so
// Q's fragments are not held in registers but reloaded from shared memory
// (where the Q tile stays) two k-steps at a time; shared memory is 2 x 264 x
// (64 + 128 + 128) bytes (~170 KB: one block an SM). The f32 kernel at D =
// 256 takes ~215 KB of its 227, at (576, 512) ~213 KB. MLA's absorbed
// latent (one shared KV head whose V is the leading Dv columns of K: (576,
// 512), and (96, 64) for the smoke config) runs flash_latent_kernel in bf16
// (latent_attention.cuh): a block holds 64 (token, head) rows of a batch
// row, min(128, Dv) of the output columns (at 512, 4 blocks share a row
// tile), Q and two key tiles in shared memory, V read from the key tile.
// Bound at the served mixed step (8 slots x 64 lanes x 128 heads over 336
// keys): bytes in principle (~0.03 ms); the 4 blocks recompute the scores,
// so operations come closer (2.6x the least flops). The f32 latent runs the
// f32 kernel above with Hkv = 1 and V read at K's row stride.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "latent_attention.cuh"
#include "mma.cuh"

namespace {

__device__ __forceinline__ bool allowed(int qp, int kp, int kv, int causal, int window) {
  return kv && (!causal || kp <= qp) && (window < 0 || kp > qp - window);
}

}  // namespace

namespace f32 {

constexpr int kThreads = 256;

// query rows and keys a block holds: 64 of each up to D = 256; at the
// latent's D = 576 a 64-row Q tile alone would be 147 KB, so 32 and 32
template <int D>
constexpr int kRows = D > 256 ? 32 : 64;
template <int D>
constexpr int kTileK = D > 256 ? 32 : 64;

template <int D, int DV>
constexpr size_t smem_bytes() {
  constexpr size_t R = kRows<D>, TK = kTileK<D>;
  return sizeof(float) * (R * D           // q (scaled)
                          + TK * (D + 1)  // K tile (padded rows)
                          + TK * DV       // V tile
                          + R * TK        // scores / probabilities
                          + 3 * R)        // m, l, alpha
         + sizeof(int) * (R + 2 * TK);    // q_pos, k_pos, k_valid
}

// A block holds kRows<D> consecutive rows of one (batch row, KV head)'s Tq x
// G (position, q head) rows: row i is position i / G, q head h * G + i % G,
// for any G (the latent's 128 heads over one KV head too). V rows are
// v_row elements apart: Hkv * DV for a V tensor of its own, D for the
// latent's V, the leading DV columns of K's rows.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos,
                       const unsigned char* __restrict__ k_valid, T* __restrict__ out,
                       int Tq, int Tk, int Hq, int Hkv, long long v_row, int causal,
                       int window, float scale) {
  constexpr int R = kRows<D>, TK = kTileK<D>;
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int b = blockIdx.y / Hkv;
  const int h = blockIdx.y % Hkv;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int rows = static_cast<int>(min(static_cast<long long>(R),
                                        static_cast<long long>(Tq) * G - row0));

  float* qs = smem;
  float* ks = qs + R * D;
  float* vs = ks + TK * (D + 1);
  float* ss = vs + TK * DV;
  float* m_s = ss + R * TK;
  float* l_s = m_s + R;
  float* a_s = l_s + R;
  int* qp_s = reinterpret_cast<int*>(a_s + R);
  int* kp_s = qp_s + R;
  int* kv_s = kp_s + TK;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, n_warps = kThreads / 32;
  const long long q_row = static_cast<long long>(Hq) * D;   // between positions
  const long long o_row = static_cast<long long>(Hq) * DV;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  // the q row (position t, head h * G + g) of block row r
  auto q_off = [&](int r) {
    const long long i = row0 + r;
    const long long t = i / G;
    return (static_cast<long long>(b) * Tq + t) * q_row + (h * G + i % G) * D;
  };
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, dd = i % D;
    qs[i] = r < rows ? to_f32(q[q_off(r) + dd]) * scale : 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    qp_s[r] = r < rows ? q_pos[static_cast<long long>(b) * Tq + (row0 + r) / G] : 0;
    m_s[r] = REPRO_NEG_INF;
    l_s[r] = 0.f;
  }
  constexpr int kAcc = R * DV / kThreads;  // outputs per thread
  static_assert(R * DV % kThreads == 0, "whole outputs a thread");
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const T* kb = k + static_cast<long long>(b) * Tk * kv_row + h * D;
  const T* vb = v + static_cast<long long>(b) * Tk * v_row + h * DV;
  __syncthreads();

  for (int k0 = 0; k0 < Tk; k0 += TK) {
    const int nk = min(TK, Tk - k0);
    for (int j = tid; j < TK; j += kThreads) {
      const long long gj = static_cast<long long>(b) * Tk + k0 + j;
      kp_s[j] = j < nk ? k_pos[gj] : 0;
      kv_s[j] = j < nk ? (k_valid == nullptr ? 1 : static_cast<int>(k_valid[gj])) : 0;
    }
    __syncthreads();
    // tile skip: is any (query, key) pair of this tile unmasked?
    int any = 0;
    for (int i = tid; i < rows * TK; i += kThreads) {
      const int r = i / TK, j = i % TK;
      if (allowed(qp_s[r], kp_s[j], kv_s[j], causal, window)) any = 1;
    }
    if (!__syncthreads_or(any)) continue;  // block-uniform

    for (int i = tid; i < TK * D; i += kThreads) {
      const int j = i / D, dd = i % D;
      ks[j * (D + 1) + dd] = j < nk ? to_f32(kb[(k0 + j) * kv_row + dd]) : 0.f;
    }
    for (int i = tid; i < TK * DV; i += kThreads) {
      const int j = i / DV, dd = i % DV;
      vs[i] = j < nk ? to_f32(vb[(k0 + j) * v_row + dd]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < rows * TK; i += kThreads) {
      const int r = i / TK, j = i % TK;
      float s = REPRO_NEG_INF;
      if (allowed(qp_s[r], kp_s[j], kv_s[j], causal, window)) {
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
      float* row = ss + r * TK;
      float mx = REPRO_NEG_INF;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const bool ok = allowed(qp_s[r], kp_s[j], kv_s[j], causal, window);
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
      const int r = idx / DV, dd = idx % DV;
      if (r < rows) {
        const float* p = ss + r * TK;
        float pv = 0.f;
        for (int j = 0; j < nk; ++j) pv = fmaf(p[j], vs[j * DV + dd], pv);
        acc[i] = acc[i] * a_s[r] + pv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / DV, dd = idx % DV;
    if (r < rows) {
      const long long o = q_off(r) / D * DV;  // the same (position, head) of out
      out[o + dd] = from_f32<T>(acc[i] / fmaxf(l_s[r], REPRO_L_MIN));
    }
  }
}

}  // namespace f32

namespace mma {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;   // query rows per block, 16 per warp
constexpr int kTileK = 64;  // keys per tile

// shared memory row stride in elements: 16 bytes of padding make the 8 rows
// of every ldmatrix land in 8 different 16-byte bank groups
template <int D>
constexpr int kStride = D + 8;

template <int D, int DV>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) *
             (static_cast<size_t>(kStride<D>) * (kRows + 2 * kTileK) +
              static_cast<size_t>(kStride<DV>) * 2 * kTileK)
         + sizeof(int) * (kRows + 4 * kTileK);  // q_pos, 2 x (k_pos, k_valid)
}

// D: the q/k width; DV: the v/out width (MLA's prefill: 192 / 128)
template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                           const unsigned char* __restrict__ k_valid,
                           __nv_bfloat16* __restrict__ out, int Tq, int Tk, int Hq, int Hkv,
                           int causal, int window, float scale_log2) {
  constexpr int S = kStride<D>, SV = kStride<DV>;
  constexpr int kChunks = D / 8, kVChunks = DV / 8;  // 16-byte chunks per row
  static_assert(DV <= D, "the output is staged in the warp's Q rows");
  static_assert(D % 16 == 0 && DV % 16 == 0 && (D <= 192 || D % 32 == 0), "mma widths");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][S]
  __nv_bfloat16* ks = qs + kRows * S;                                // [2][kTileK][S]
  __nv_bfloat16* vs = ks + 2 * kTileK * S;                           // [2][kTileK][SV]
  int* qp_s = reinterpret_cast<int*>(vs + 2 * kTileK * SV);          // [kRows]
  int* kp_s = qp_s + kRows;                                          // [2][kTileK]
  int* kv_s = kp_s + 2 * kTileK;                                     // [2][kTileK]

  const int G = Hq / Hkv;
  const int bq = kRows / G;  // query positions per block
  const int rows = bq * G;   // live rows per block (<= kRows)
  const int b = blockIdx.y / Hkv;
  const int h = blockIdx.y % Hkv;
  const int t_lo = (gridDim.x - 1 - blockIdx.x) * bq;  // heavy tiles first
  const int nq = min(bq, Tq - t_lo);
  const int n_tiles = (Tk + kTileK - 1) / kTileK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const long long q_row = static_cast<long long>(Hq) * D;
  const long long o_row = static_cast<long long>(Hq) * DV;
  const long long kv_row = static_cast<long long>(Hkv) * D;
  const long long v_row = static_cast<long long>(Hkv) * DV;
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * Tk * kv_row + h * D;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * Tk * v_row + h * DV;

  // Q tile: the G heads of one position are G * D contiguous elements
  const __nv_bfloat16* qb =
      q + (static_cast<long long>(b) * Tq + t_lo) * q_row + static_cast<long long>(h) * G * D;
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int t = r / G;
    const bool live = r < rows && t < nq;
    cp_async16(qs + r * S + c * 8, live ? qb + t * q_row + (r % G) * D + c * 8 : q,
               live ? 16 : 0);
  }
  cp_async_commit();
  for (int t = tid; t < bq; t += kThreads)
    qp_s[t] = t < nq ? q_pos[static_cast<long long>(b) * Tq + t_lo + t] : 0;

  // the two fragment rows of this thread: gid and gid + 8 of its warp's 16
  int qp[2];
  bool qlive[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i, t = r / G;
    qlive[i] = r < rows && t < nq;
    qp[i] = qlive[i] ? q_pos[static_cast<long long>(b) * Tq + t_lo + t] : 0;
  }

  // positions and validity of key tile kt into buffer sb; true (uniform over
  // the block) when some (query, key) pair of the tile is unmasked
  auto stage = [&](int kt, int sb) {
    const int k0 = kt * kTileK, nk = min(kTileK, Tk - k0);
    for (int j = tid; j < kTileK; j += kThreads) {
      const long long gj = static_cast<long long>(b) * Tk + k0 + j;
      kp_s[sb * kTileK + j] = j < nk ? k_pos[gj] : 0;
      kv_s[sb * kTileK + j] = j < nk && (k_valid == nullptr || k_valid[gj]);
    }
    __syncthreads();
    int any = 0;
    for (int i = tid; i < bq * kTileK; i += kThreads) {
      const int t = i / kTileK, j = sb * kTileK + i % kTileK;
      if (t < nq && allowed(qp_s[t], kp_s[j], kv_s[j], causal, window)) any = 1;
    }
    return __syncthreads_or(any) != 0;
  };
  auto next_live = [&](int kt, int sb) {
    while (kt < n_tiles && !stage(kt, sb)) ++kt;
    return kt;
  };
  auto load_kv = [&](int kt, int sb) {
    const int k0 = kt * kTileK, nk = min(kTileK, Tk - k0);
    for (int i = tid; i < kTileK * kChunks; i += kThreads) {
      const int j = i / kChunks, c = i % kChunks;
      const long long off = static_cast<long long>(k0 + j) * kv_row + c * 8;
      cp_async16(ks + (sb * kTileK + j) * S + c * 8, j < nk ? kb + off : k, j < nk ? 16 : 0);
    }
    for (int i = tid; i < kTileK * kVChunks; i += kThreads) {
      const int j = i / kVChunks, c = i % kVChunks;
      const long long off = static_cast<long long>(k0 + j) * v_row + c * 8;
      cp_async16(vs + (sb * kTileK + j) * SV + c * 8, j < nk ? vb + off : v, j < nk ? 16 : 0);
    }
    cp_async_commit();
  };

  int kt = next_live(0, 0);
  if (kt < n_tiles) load_kv(kt, 0);
  cp_async_wait<0>();
  __syncthreads();
  // this warp's 16 x D Q fragments: in registers for the block's life up to
  // D = 192; at D = 256 they and the 16 x 256 f32 output tile (128 registers
  // a thread) would not fit together, so Q stays in shared memory and two
  // k-steps' fragments are reloaded at a time (kQRegs false)
  constexpr bool kQRegs = D <= 192;
  const __nv_bfloat16* qw = qs + (warp * 16 + lane % 16) * S + (lane / 16) * 8;
  uint32_t qf[kQRegs ? D / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], qw + kk * 16);
  }

  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF};  // running max, in log2 units
  float l[2] = {0.f, 0.f};                      // this thread's part of the row sum
  int sb = 0;
  while (kt < n_tiles) {
    const int nxt = next_live(kt + 1, sb ^ 1);
    if (nxt < n_tiles) {
      load_kv(nxt, sb ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt_s = ks + sb * kTileK * S;
    const __nv_bfloat16* vt_s = vs + sb * kTileK * SV;
    const int* kp = kp_s + sb * kTileK;
    const int* kv = kv_s + sb * kTileK;

    float s[kTileK / 8][4];  // S: 8 key columns per n-tile
    if constexpr (kQRegs) {
#pragma unroll
      for (int n = 0; n < kTileK / 8; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk + 1 < D / 16; kk += 2) {
          uint32_t bf[4];  // keys n*8.., d in [kk*16, kk*16 + 32)
          ldmatrix_x4(bf, kt_s + (n * 8 + lane % 8) * S + kk * 16 + (lane / 8) * 8);
          mma_bf16_16816(s[n], qf[kk], bf[0], bf[1]);
          mma_bf16_16816(s[n], qf[kk + 1], bf[2], bf[3]);
        }
        if constexpr (D % 32 == 16) {  // D = 16: one k-step of 16, the last
          uint32_t bf[2];  // keys n*8.., d in [D - 16, D)
          ldmatrix_x2(bf, kt_s + (n * 8 + lane % 8) * S + (D - 16) + ((lane / 8) % 2) * 8);
          mma_bf16_16816(s[n], qf[D / 16 - 1], bf[0], bf[1]);
        }
      }
    } else {  // the same sums, each s[n] over kk in the same order
#pragma unroll
      for (int n = 0; n < kTileK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t qa[4], qb[4];
        ldmatrix_x4(qa, qw + kk * 16);
        ldmatrix_x4(qb, qw + (kk + 1) * 16);
#pragma unroll
        for (int n = 0; n < kTileK / 8; ++n) {
          uint32_t bf[4];
          ldmatrix_x4(bf, kt_s + (n * 8 + lane % 8) * S + kk * 16 + (lane / 8) * 8);
          mma_bf16_16816(s[n], qa, bf[0], bf[1]);
          mma_bf16_16816(s[n], qb, bf[2], bf[3]);
        }
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, j = n * 8 + 2 * tig + (e & 1);
        const bool ok = qlive[i] && allowed(qp[i], kp[j], kv[j], causal, window);
        s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
        mx[i] = fmaxf(mx[i], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the 4 lanes of a quad hold one row
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e / 2]);  // a masked -inf gives exactly 0
        l[e / 2] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {  // keys kk*16 .. kk*16 + 15
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < DV / 8; n += 2) {
        uint32_t bf[4];  // V rows kk*16.., d columns n*8 .. n*8 + 15
        ldmatrix_x4_trans(bf, vt_s + (kk * 16 + lane % 16) * SV + n * 8 + (lane / 16) * 8);
        mma_bf16_16816(o[n], pa, bf[0], bf[1]);
        mma_bf16_16816(o[n + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // buffer sb is free for the tile after next
    kt = nxt;
    sb ^= 1;
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], REPRO_L_MIN);
  }
  // stage the warp's 16 output rows in its own Q rows, then 16-byte stores
  __nv_bfloat16* os = qs + warp * 16 * S;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    *reinterpret_cast<uint32_t*>(os + gid * S + n * 8 + 2 * tig) =
        pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(os + (gid + 8) * S + n * 8 + 2 * tig) =
        pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* ob =
      out + (static_cast<long long>(b) * Tq + t_lo) * o_row + static_cast<long long>(h) * G * DV;
  for (int i = lane; i < 16 * kVChunks; i += 32) {
    const int rr = i / kVChunks, c = i % kVChunks;
    const int r = warp * 16 + rr, t = r / G;
    if (r < rows && t < nq) {
      *reinterpret_cast<uint4*>(ob + t * o_row + (r % G) * DV + c * 8) =
          *reinterpret_cast<const uint4*>(os + rr * S + c * 8);
    }
  }
}

}  // namespace mma


namespace latent {

// Flash attention over MLA's absorbed latent (the paged mixed and the
// verify steps): q [B, Tq, Hq, kD] against the latent kv [B, Tk, kD] (Hkv =
// 1), V = kv[..., :kDV] read from the key tile; out [B, Tq, Hq, kDV]. The
// grid is x: tiles of 64 of a batch row's Tq * Hq (token, head) rows (row i
// is token i / Hq, head i % Hq: at Hq = 128 a tile is 64 heads of one
// token), y: the batch row, z: the block's kDVS output columns. Masks and
// tile skipping as the GQA kernel's.
template <typename W>
__global__ void __launch_bounds__(kThreads)
flash_latent_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kv,
                    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                    const unsigned char* __restrict__ k_valid, __nv_bfloat16* __restrict__ out,
                    int Tq, int Tk, int Hq, int causal, int window, float scale_log2) {
  constexpr int kD = W::kD, kDV = W::kDV, kDVS = W::kDVS;
  constexpr int kStride = W::kStride, kChunks = W::kChunks;
  constexpr size_t kTileBytes = W::kTileBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][kStride]
  __nv_bfloat16* ks = qs + kRows * kStride;                          // [2][kTileK][kStride]
  int* qp_s = reinterpret_cast<int*>(smem_raw + kTileBytes);         // [kRows]
  int* kp_s = qp_s + kRows;                                          // [2][kTileK]
  int* kv_s = kp_s + 2 * kTileK;                                     // [2][kTileK]

  const int b = blockIdx.y, dv0 = blockIdx.z * kDVS;
  const long long n_rows = static_cast<long long>(Tq) * Hq;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), n_rows - row0));
  const int n_tiles = (Tk + kTileK - 1) / kTileK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gid = lane / 4;
  const __nv_bfloat16* qb = q + (static_cast<long long>(b) * n_rows + row0) * kD;
  const __nv_bfloat16* kb = kv + static_cast<long long>(b) * Tk * kD;

  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    cp_async16(qs + r * kStride + c * 8, r < rows ? qb + r * kD + c * 8 : q, r < rows ? 16 : 0);
  }
  cp_async_commit();
  for (int r = tid; r < kRows; r += kThreads)
    qp_s[r] = r < rows ? q_pos[static_cast<long long>(b) * Tq + (row0 + r) / Hq] : 0;
  int qp[2];
  bool qlive[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    qlive[i] = r < rows;
    qp[i] = qlive[i] ? q_pos[static_cast<long long>(b) * Tq + (row0 + r) / Hq] : 0;
  }

  auto stage = [&](int kt, int sb) {  // as the GQA kernel's: true when the tile is live
    const int k0 = kt * kTileK, nk = min(kTileK, Tk - k0);
    for (int j = tid; j < kTileK; j += kThreads) {
      const long long gj = static_cast<long long>(b) * Tk + k0 + j;
      kp_s[sb * kTileK + j] = j < nk ? k_pos[gj] : 0;
      kv_s[sb * kTileK + j] = j < nk && (k_valid == nullptr || k_valid[gj]);
    }
    __syncthreads();
    int any = 0;
    for (int i = tid; i < rows * kTileK; i += kThreads) {
      const int j = sb * kTileK + i % kTileK;
      if (allowed(qp_s[i / kTileK], kp_s[j], kv_s[j], causal, window)) any = 1;
    }
    return __syncthreads_or(any) != 0;
  };
  auto next_live = [&](int kt, int sb) {
    while (kt < n_tiles && !stage(kt, sb)) ++kt;
    return kt;
  };
  auto load_k = [&](int kt, int sb) {  // rows past Tk zero-filled
    const int k0 = kt * kTileK, nk = min(kTileK, Tk - k0);
    for (int i = tid; i < kTileK * kChunks; i += kThreads) {
      const int j = i / kChunks, c = i % kChunks;
      cp_async16(ks + (sb * kTileK + j) * kStride + c * 8,
                 j < nk ? kb + static_cast<long long>(k0 + j) * kD + c * 8 : kv,
                 j < nk ? 16 : 0);
    }
    cp_async_commit();
  };

  int kt = next_live(0, 0);
  if (kt < n_tiles) load_k(kt, 0);
  float o[kDVS / 8][4];
#pragma unroll
  for (int n = 0; n < kDVS / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
  const __nv_bfloat16* qw = qs + warp * 16 * kStride;
  int sb = 0;
  while (kt < n_tiles) {
    const int nxt = next_live(kt + 1, sb ^ 1);
    if (nxt < n_tiles) {
      load_k(nxt, sb ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int* kp = kp_s + sb * kTileK;
    const int* kvl = kv_s + sb * kTileK;
    auto ok = [&](int i, int j) {
      return qlive[i] && allowed(qp[i], kp[j], kvl[j], causal, window);
    };
    tile_step<W>(qw, ks + sb * kTileK * kStride, dv0, scale_log2, ok, o, m, l);
    __syncthreads();  // buffer sb is free for the tile after next
    kt = nxt;
    sb ^= 1;
  }
  cp_async_wait<0>();  // no tile was live: the Q tile's copy is still pending
  __syncthreads();

  float inv[2];
  row_inverse(l, inv);
  __nv_bfloat16* qwo = qs + warp * 16 * kStride;
  stage_out<W>(qwo, o, inv);
  __nv_bfloat16* ob = out + (static_cast<long long>(b) * n_rows + row0) * kDV + dv0;
  for (int i = lane; i < 16 * (kDVS / 8); i += 32) {
    const int rr = i / (kDVS / 8), c = i % (kDVS / 8), r = warp * 16 + rr;
    if (r < rows)
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(r) * kDV + c * 8) =
          *reinterpret_cast<const uint4*>(qwo + rr * kStride + c * 8);
  }
}

template <typename W>
constexpr size_t flash_smem_bytes() {
  return W::kTileBytes + sizeof(int) * (kRows + 4 * kTileK);
}

}  // namespace latent

namespace {

// The GQA kernels (bf16: the tensor-core kernel; f32: the CUDA-core
// kernel); v_row is V's row stride in elements (Hkv * DV, or D for the f32
// latent, whose V is K's leading columns).
template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, const int* q_pos, const int* k_pos,
           const unsigned char* k_valid, void* out, int B, int Tq, int Tk, int Hq,
           int Hkv, long long v_row, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  if (Hkv < 1 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  if (B == 0 || Tq == 0) return 0;
  static bool smem_allowed[kMaxDevices] = {};  // this launch<T, D, DV>'s kernel only
  if constexpr (kMma) {
    if (G > mma::kRows) return static_cast<int>(cudaErrorInvalidValue);
    const int bq = mma::kRows / G;
    const dim3 grid((Tq + bq - 1) / bq, B * Hkv);
    const size_t bytes = mma::smem_bytes<D, DV>();
    auto kern = mma::flash_attention_mma_kernel<D, DV>;
    const cudaError_t e = allow_smem(kern, bytes, smem_allowed);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, mma::kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
        k_pos, k_valid, static_cast<T*>(out), Tq, Tk, Hq, Hkv, causal, window,
        scale * 1.4426950408889634f);  // log2(e): the kernel exponentiates with exp2
  } else {
    const long long tiles =
        (static_cast<long long>(Tq) * G + f32::kRows<D> - 1) / f32::kRows<D>;
    if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(tiles), B * Hkv);
    const size_t bytes = f32::smem_bytes<D, DV>();
    auto kern = f32::flash_attention_kernel<T, D, DV>;
    const cudaError_t e = allow_smem(kern, bytes, smem_allowed);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, f32::kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
        k_pos, k_valid, static_cast<T*>(out), Tq, Tk, Hq, Hkv, v_row, causal, window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// (D, Dv) of the GQA kernels: D == Dv in {16, 32, 64, 128, 256}, and MLA's
// prefill (nope + rope against v_head) at (96, 64) (smoke) and (192, 128).
#define REPRO_FLASH_WIDTHS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(128, 128) X(256, 256) X(96, 64) X(192, 128)

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int* qp, const int* kp,
               const unsigned char* kv, void* out, int B, int Tq, int Tk, int Hq, int Hkv,
               int D, int DV, long long v_row, int causal, int window, float scale,
               cudaStream_t s) {
#define REPRO_CASE(d, dv)                                                                  \
  if (D == d && DV == dv)                                                                  \
    return launch<T, d, dv>(q, k, v, qp, kp, kv, out, B, Tq, Tk, Hq, Hkv, v_row, causal, \
                            window, scale, s);
  REPRO_FLASH_WIDTHS(REPRO_CASE)
#undef REPRO_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The latent's tensor-core kernel at widths W.
template <typename W>
int launch_latent(const void* q, const void* kv, const int* q_pos, const int* k_pos,
                  const unsigned char* k_valid, void* out, int B, int Tq, int Tk, int Hq,
                  int causal, int window, float scale, cudaStream_t stream) {
  const long long tiles = (static_cast<long long>(Tq) * Hq + latent::kRows - 1) / latent::kRows;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_allowed[kMaxDevices] = {};
  const size_t bytes = latent::flash_smem_bytes<W>();
  auto kern = latent::flash_latent_kernel<W>;
  const cudaError_t e = allow_smem(kern, bytes, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(tiles), B, W::kSplitsV);
  kern<<<grid, latent::kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kv), q_pos, k_pos,
      k_valid, static_cast<__nv_bfloat16*>(out), Tq, Tk, Hq, causal, window,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      const void* q_pos, const void* k_pos,
                                      const void* k_valid, void* out, int B, int Tq, int Tk,
                                      int Hq, int Hkv, int D, int DV, int causal, int window,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  const unsigned char* kv = static_cast<const unsigned char*>(k_valid);
  const long long v_row = static_cast<long long>(Hkv) * DV;
  if (dtype == REPRO_DTYPE_F32)
    return dispatch_d<float>(q, k, v, qp, kp, kv, out, B, Tq, Tk, Hq, Hkv, D, DV, v_row,
                             causal, window, scale, s);
  if (dtype == REPRO_DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, qp, kp, kv, out, B, Tq, Tk, Hq, Hkv, D, DV,
                                     v_row, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// MLA's absorbed latent: q [B, Tq, Hq, D], kv [B, Tk, D] (V its leading DV
// columns), out [B, Tq, Hq, DV], at (D, DV) = (576, 512) or (96, 64). bf16
// runs the latent's tensor-core kernel, f32 the CUDA-core GQA kernel with
// Hkv = 1 and V read at K's row stride.
extern "C" int flash_attention_latent_launch(int dtype, const void* q, const void* kv,
                                             const void* q_pos, const void* k_pos,
                                             const void* k_valid, void* out, int B, int Tq,
                                             int Tk, int Hq, int D, int DV, int causal,
                                             int window, float scale, void* stream) {
  if (B < 0 || B > 65535 || Tq < 0 || Hq < 1 || Tk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Tq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  const unsigned char* kvl = static_cast<const unsigned char*>(k_valid);
  if (dtype == REPRO_DTYPE_BF16) {
    if (D == latent::Mla::kD && DV == latent::Mla::kDV)
      return launch_latent<latent::Mla>(q, kv, qp, kp, kvl, out, B, Tq, Tk, Hq, causal, window,
                                        scale, s);
    if (D == latent::MlaSmoke::kD && DV == latent::MlaSmoke::kDV)
      return launch_latent<latent::MlaSmoke>(q, kv, qp, kp, kvl, out, B, Tq, Tk, Hq, causal,
                                             window, scale, s);
  } else if (dtype == REPRO_DTYPE_F32) {
    if (D == 576 && DV == 512)
      return launch<float, 576, 512>(q, kv, kv, qp, kp, kvl, out, B, Tq, Tk, Hq, 1, D, causal,
                                     window, scale, s);
    if (D == 96 && DV == 64)
      return launch<float, 96, 64>(q, kv, kv, qp, kp, kvl, out, B, Tq, Tk, Hq, 1, D, causal,
                                   window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
