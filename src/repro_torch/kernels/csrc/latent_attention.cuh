// The tile step shared by the two absorbed-latent kernels of DeepSeek-V2's
// Multi-head Latent Attention: flash attention over the latent
// (flash_attention.cu, the paged mixed and the verify steps) and the latent
// flash-decode (decode_attention.cu, contiguous and paged).
//
// The latent is one shared KV head (Hkv = 1) of width kD = kv_lora_rank +
// qk_rope_dim whose V is its leading kDV = kv_lora_rank columns. The widths
// are a template (Widths<kD, kDV>): (576, 512) for deepseek-v2-236b and
// (96, 64) for its smoke config. A block holds kRows = 64 query rows (4
// warps of 16; at G = 128 heads of one token these are the rows of the
// mma.sync tile) and kDVS = min(128, kDV) output columns: at kDV = 512 a
// 16-row warp tile's accumulator over all 512 would be 256 f32 registers a
// lane, so the output columns are split over kSplitsV = 4 blocks (grid z),
// each computing the same scores (the scores are 1152 flops a (row, key)
// against 256 for its P.V share: the split costs about 2.6x the least
// flops, on a step bound by bytes and latency); at kDV = 64 one block holds
// them all.
// Shared memory holds the 64 x kD Q tile (73 KB at 576) and two 64 x kD key
// tiles (146 KB); V is read from the key tile already there, never loaded
// twice. Q's fragments are read from shared memory at every tile (holding
// 36 of them a lane would take 144 registers). Rows are padded by 8
// elements (584 at 576: 73 16-byte units; 104 at 96: 13 units): an odd
// count of 16-byte units puts the 8 rows of an ldmatrix in 8 different bank
// groups. Key rows past the valid ones are zero-filled, so P = 0 never
// meets a stale non-finite value. f32 has no tensor-core path here: the
// f32 latent runs the CUDA-core GQA kernels with Hkv = 1 and V read at K's
// row stride (flash_attention.cu, decode_attention.cu).
#pragma once

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace latent {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;   // query rows a block, 16 a warp
constexpr int kTileK = 64;  // keys a tile

template <int D, int DV>
struct Widths {
  static_assert(D % 32 == 0 && DV % 16 == 0 && DV <= D, "latent widths");
  static constexpr int kD = D;    // latent width (kv_lora_rank + qk_rope_dim)
  static constexpr int kDV = DV;  // V width (kv_lora_rank): V = K[:, :kDV]
  static constexpr int kDVS = DV < 128 ? DV : 128;  // output columns a block
  static constexpr int kSplitsV = DV / kDVS;
  static constexpr int kStride = D + 8;
  static constexpr int kChunks = D / 8;  // 16-byte chunks a row
  // Q tile + two key tiles, then the ints the caller keeps behind them
  static constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * static_cast<size_t>(kStride) *
                                       (kRows + 2 * kTileK);
  static_assert(DV % kDVS == 0 && (kStride / 8) % 2 == 1, "latent tiling");
};

using Mla = Widths<576, 512>;       // deepseek-v2-236b
using MlaSmoke = Widths<96, 64>;    // its smoke config

// One key tile kt (64 x kD in shared memory) against this warp's 16 query
// rows qw (16 x kD in shared memory): S = Q K^T in f32, masked where
// !ok(i, j) (i in {0, 1}: the thread's rows gid and gid + 8; j the tile's
// key), scaled by scale_log2, the online softmax in log2 units (m the
// running max, l this thread's part of the row sum), then o = o * alpha +
// P V over V = kt's columns [dv0, dv0 + kDVS), P rounded to bf16.
template <typename W, typename Ok>
__device__ __forceinline__ void tile_step(const __nv_bfloat16* qw, const __nv_bfloat16* kt,
                                          int dv0, float scale_log2, const Ok& ok,
                                          float (&o)[W::kDVS / 8][4], float (&m)[2],
                                          float (&l)[2]) {
  constexpr int kD = W::kD, kDVS = W::kDVS, kStride = W::kStride;
  const int lane = threadIdx.x % 32, tig = lane % 4;
  float s[kTileK / 8][4];
#pragma unroll
  for (int n = 0; n < kTileK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < kD / 16; kk += 2) {
    uint32_t qa[4], qb[4];
    ldmatrix_x4(qa, qw + (lane % 16) * kStride + kk * 16 + (lane / 16) * 8);
    ldmatrix_x4(qb, qw + (lane % 16) * kStride + (kk + 1) * 16 + (lane / 16) * 8);
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n) {
      uint32_t bf[4];  // keys n*8.., d in [kk*16, kk*16 + 32)
      ldmatrix_x4(bf, kt + (n * 8 + lane % 8) * kStride + kk * 16 + (lane / 8) * 8);
      mma_bf16_16816(s[n], qa, bf[0], bf[1]);
      mma_bf16_16816(s[n], qb, bf[2], bf[3]);
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < kTileK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e / 2, j = n * 8 + 2 * tig + (e & 1);
      s[n][e] = ok(i, j) ? s[n][e] * scale_log2 : -INFINITY;
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
  for (int n = 0; n < kDVS / 8; ++n) {
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
    for (int n = 0; n < kDVS / 8; n += 2) {
      uint32_t bf[4];  // V rows kk*16.., columns dv0 + n*8 .. + 15
      ldmatrix_x4_trans(bf, kt + (kk * 16 + lane % 16) * kStride + dv0 + n * 8 +
                                (lane / 16) * 8);
      mma_bf16_16816(o[n], pa, bf[0], bf[1]);
      mma_bf16_16816(o[n + 1], pa, bf[2], bf[3]);
    }
  }
}

// The row sums reduced over each quad, as 1 / max(l, 1e-30).
__device__ __forceinline__ void row_inverse(float (&l)[2], float (&inv)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], REPRO_L_MIN);
  }
}

// Stage the warp's 16 x kDVS outputs, each times inv of its row, as bf16 in
// the warp's own Q rows (qw, free once the last tile_step is done); row rr
// then sits at qw + rr * kStride.
template <typename W>
__device__ __forceinline__ void stage_out(__nv_bfloat16* qw, const float (&o)[W::kDVS / 8][4],
                                          const float (&inv)[2]) {
  constexpr int kDVS = W::kDVS, kStride = W::kStride;
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int n = 0; n < kDVS / 8; ++n) {
    *reinterpret_cast<uint32_t*>(qw + gid * kStride + n * 8 + 2 * tig) =
        pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(qw + (gid + 8) * kStride + n * 8 + 2 * tig) =
        pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
}

}  // namespace latent
