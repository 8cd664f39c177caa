// Flash-decode: one query token per batch row against a static KV cache,
// valid below the per-row length, the sequence split over blocks and the
// splits' partials combined by their log-sum-exp.
//
// Replaces: repro/kernels/decode_attention.py::decode_attention_pallas
// (_decode_kernel); the paged kernel below, repro/models/attention.py::
// paged_decode_attention.
// Computes: out[b, hq] = softmax(q[b, hq] . K[b, :len, hq // G] * scale) V
// with an f32 online softmax (finite -1e30 sentinel, l clamped at 1e-30, so
// len = 0 gives exact zeros).
// Bound on the H100: bytes. Every valid cache row is read once (2 * len *
// Hkv * D * sizeof(T) bytes per batch row) for 4 * G * D flops per row,
// about G = 4 flops per byte in bf16 at llama3.2-1b's shapes: far below the
// card's ~295 flop/byte ridge. A served call reads ~2.5 MB, under a
// microsecond of HBM time, so what bounds it in practice is latency: how
// many blocks are in flight and how long each waits on its loads.
//
// Design (decode_attention_kernel): the grid is (split, batch row x KV
// head). Each (row, KV head) cuts the static S into `splits` runs of
// `split_len` keys (whole 64-key tiles; kernels/decode_attention.py
// split_plan sizes them from S, B and Hkv alone, so no host ever reads
// `lengths`), enough for two blocks per SM at the served shape (8 rows x 8
// KV heads x 6 splits of one tile = 384 blocks on 132 SMs, where one block
// per (row, KV head) gave 64). A block whose run starts at or past
// lengths[b] exits at once and writes nothing. The others hold the whole
// q-head group of their KV head (GQA): q scaled in f32, then the run's K/V
// tiles in the cache's own type in shared memory, double-buffered by 16-byte
// cp.async (K rows padded by 16 bytes so the score loop's 16-byte reads are
// free of bank conflicts), each tile applied to all G heads: scores by f32
// FMAs, the per-head max and sum by one warp per head with shuffles, P.V by
// f32 FMAs into registers. With one split the block writes the normalised
// output itself; with more, it writes its unnormalised f32 partial (acc,
// m, l) to a workspace, and decode_attention_combine_kernel merges the
// ceil(len / split_len) splits that hold keys, in split order (so repeat
// calls are bit-identical), with the maths of the JAX package's
// combine_partial_attention: m = max m_s, alpha_s = exp(m_s - m), out =
// sum alpha_s acc_s / max(sum alpha_s l_s, 1e-30). A row of length 0 has no
// live split and gets exact zeros.
//
// Widths: D == Dv in {16, 32, 64, 128} with G * D <= 2048, and D = 256 with
// G * D <= 2560 (recurrentgemma-2b: 10 q heads over one KV head, over the
// ring of its local attention): each thread holds kMaxAcc<D> of the group's
// outputs (8, or 10 at D = 256; thread i holds outputs i, i + 256, ..., so
// the mapping needs no D of its own and at D = 16 or 32 most threads of a
// small group hold none), and f32 at D = 256 walks its split in 32-key
// tiles (two 64-key K/V tiles of 1 KB rows would take 264 KB of shared
// memory). The paged kernel is not instantiated at D = 256: the paged pool
// refuses the hybrid's rings. The combine kernel gives each lane
// ceil(Dv / 32) columns, the last partly idle at Dv = 16.
//
// Paged flash-decode (decode_attention_paged_kernel) replaces the JAX
// package's XLA paged_decode_attention (repro/models/attention.py, which has
// no Pallas kernel): the same split decode over a block pool K/V [NB, bs,
// Hkv, D] addressed through a per-row block table bt [B, MB]. Logical key t
// of batch row b lives at physical row bt[b, t / bs] * bs + t % bs; the
// cp.async tile loader resolves that per row, so no gathered copy of the
// row's keys ever exists. The splits are planned from the static MB * bs
// (whole 64-key tiles: whole blocks wherever bs divides 64), never from the
// table or n_valid, so repeat calls are bit-identical; the combine kernel is
// shared.
// A freed slot's row has an all-zero table (the sink block 0) and a
// drifting n_valid: it reads block 0 and its output is discarded. Table
// entries outside [0, NB) are clamped, as the reference's gather clamps.
// Bound: bytes, as the contiguous kernel (the live rows read once, and
// the table).
//
// The partial form (decode_attention_partial_launch) replaces the JAX
// package's decode_attention_partial (repro/kernels/ops.py, XLA, no Pallas
// kernel): the same split decode over one shard of a cache's rows, valid
// below a per-row count, that writes the shard's unnormalised f32 triple
// instead of its output: acc [B][Hq][Dv], then (m, l) [B][Hq][2], m in
// natural-log units. At one split the block writes its triple itself (a row
// with no valid key writes acc 0, m = -1e30, l 0); at more, the combine
// kernel's raw form merges the splits that hold keys into the triple
// without dividing. The merge (decode_attention_merge_launch) replaces
// combine_partial_attention (ops.py, XLA): P stacked triples, strided as
// the caller holds them (the ranks' partials of a sequence-parallel decode
// after their exchange), merged by the same maths, m = max_p m_p, alpha_p =
// exp(m_p - m), out = sum_p alpha_p acc_p / max(sum_p alpha_p l_p, 1e-30),
// in part order, one warp a (row, head); a part with no valid key (m =
// -1e30, l = 0) weighs exp(-1e30 - m) = 0. Bound: bytes (the partials read
// once, the output written once).
//
// MLA's absorbed latent decode (decode_latent_kernel, bf16): q [B, Hq, D]
// against the latent [B, S, D] or its block pool through the table, one
// shared KV head, V the leading Dv columns, at (D, Dv) = (576, 512) and
// (96, 64) (the smoke config; latent_attention.cuh's Widths). G * D = 128 *
// 576 cannot sit in one block's registers as the GQA kernel's group does,
// so the heads become the rows of an mma.sync tile (64-row tiles) against
// each 64-key latent tile, the output columns are split over min(128, Dv)
// column blocks (grid z; 4 at 512), and split_plan's sequence split and the
// combine kernel (at Dv) are kept: 8 rows x 2 row tiles x 4 column blocks x
// 6 splits = 384 blocks at the served S = 321. The tile loader resolves
// each key's row, contiguous or through the table (LatentContig /
// LatentPaged), so the two give the same bits on the same rows. Bound:
// bytes (the live latent rows once, ~1 us at the served shape); in practice
// latency. The f32 latent runs decode_split (the GQA kernels, contiguous or
// paged) with Hkv = 1, V read at K's row stride, 16 heads and min(128, Dv)
// output columns a block (grid z tiles both): f32 K tiles of 32 keys at D =
// 576 (~213 KB of shared memory with the V slice and Q).
#include <cstdint>

#include "common.cuh"
#include "latent_attention.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 64;  // the split plan's granularity (decode_attention.py TILE_K)
constexpr int kCombineWarps = 4;
// q heads a block of the f32 latent holds (grid z tiles the rest)
constexpr int kLatentHeads = 16;

// Per-thread outputs: a block's heads x output columns <= kThreads *
// kMaxAcc<D>: G * D <= 2048 up to D = 128 and 2560 at D = 256
// (recurrentgemma's 10 heads over one KV head).
template <int D>
constexpr int kMaxAcc = D == 256 ? 10 : 8;

// D: the K row's width; DVS: the V columns (and outputs) a block holds
template <typename T, int D, int DVS>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte chunk
  static constexpr int kChunks = D / kVec;      // chunks per K row
  static constexpr int kVChunks = DVS / kVec;   // chunks per V row slice
  static constexpr int kKStride = D + kVec;     // K rows padded by 16 bytes
  // keys per shared-memory tile: 64, or 32 where a row is over 512 bytes
  // (f32 at D = 256 and 576: two 64-key K/V tiles would not fit); a divisor
  // of the split's 64-key granularity either way
  static constexpr int kTile = sizeof(T) * D > 512 ? 32 : 64;
  static_assert(D % kVec == 0 && DVS % kVec == 0, "whole 16-byte chunks");
  static size_t smem_bytes(int g) {
    return sizeof(T) * 2 * kTile * static_cast<size_t>(kKStride + DVS)  // K, V (x2)
           + sizeof(float) * static_cast<size_t>(g) * (D + kTile + 3);  // q, p, m/l/alpha
  }
};

// Sixteen bytes of cache row as f32.
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its f32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Element offset of logical cache row t from a (row, KV head)'s base:
// contiguous rows t * row_stride apart, or paged rows through the batch
// row's block table.
struct ContigRows {
  long long row_stride;
  __device__ __forceinline__ long long operator()(int t) const { return t * row_stride; }
};
struct PagedRows {
  const int* bt;  // this batch row's table [MB]
  int bs, nb;
  long long row_stride;
  __device__ __forceinline__ long long operator()(int t) const {
    const int phys = min(max(bt[t / bs], 0), nb - 1);
    return (static_cast<long long>(phys) * bs + t % bs) * row_stride;
  }
};

// K/V cache rows t0 .. t0 + n - 1 into one buffer of the tile ring by
// 16-byte cp.async (rows past n are never read): K's D columns, V's DVS
// columns from dv0 (V rows at K's offsets: V = K[..., :Dv] for the latent).
template <typename T, int D, int DVS, typename Rows>
__device__ __forceinline__ void load_tile(const T* kb, const T* vb, const Rows& rows, int t0,
                                          int n, int dv0, T* ks, T* vs) {
  using L = Tile<T, D, DVS>;
  for (int i = threadIdx.x; i < n * L::kChunks; i += kThreads) {
    const int j = i / L::kChunks, c = i % L::kChunks;
    cp_async16(ks + j * L::kKStride + c * L::kVec, kb + rows(t0 + j) + c * L::kVec, 16);
  }
  for (int i = threadIdx.x; i < n * L::kVChunks; i += kThreads) {
    const int j = i / L::kVChunks, c = i % L::kVChunks;
    cp_async16(vs + j * DVS + c * L::kVec, vb + rows(t0 + j) + dv0 + c * L::kVec, 16);
  }
  cp_async_commit();
}

// One block's split of one (batch row b, KV head h): kb / vb point at the
// row's key 0 of head h, `rows` maps a logical key to its offset from there,
// and `len` is the row's clamped count of valid keys. The block holds the
// group's heads g0 .. g0 + gh - 1 and output columns dv0 .. dv0 + DVS - 1 of
// the DV (the whole group and all columns but for the f32 latent).
template <typename T, int D, int DV, int DVS, typename Rows>
__device__ __forceinline__ void decode_split(unsigned char* smem_raw, const T* __restrict__ q,
                                             const T* kb, const T* vb, const Rows& rows,
                                             int len, T* __restrict__ out,
                                             float* __restrict__ partial, int B, int Hq,
                                             int Hkv, int split_len, float scale, int b,
                                             int h, int g0, int gh, int dv0) {
  using L = Tile<T, D, DVS>;
  constexpr int kVec = L::kVec, kChunks = L::kChunks, kKStride = L::kKStride;
  constexpr int kTileK = L::kTile;  // shadows the split granularity
  constexpr int kAcc = kMaxAcc<D>;
  const int G = Hq / Hkv;
  const int t_begin = blockIdx.x * split_len;
  const int t_end = min(len, t_begin + split_len);
  // a split with no key writes nothing: the combine never reads it (the
  // partial form's one split writes its empty triple: there is no combine)
  if (partial != nullptr && t_begin >= len && gridDim.x > 1) return;

  T* ks = reinterpret_cast<T*>(smem_raw);          // [2][kTileK][kKStride]
  T* vs = ks + 2 * kTileK * kKStride;              // [2][kTileK][DVS]
  float* qs = reinterpret_cast<float*>(vs + 2 * kTileK * DVS);  // [gh][D]
  float* ss = qs + gh * D;                         // [gh][kTileK]
  float* m_s = ss + gh * kTileK;
  float* l_s = m_s + gh;
  float* a_s = l_s + gh;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, n_warps = kThreads / 32;

  if (t_begin < t_end)
    load_tile<T, D, DVS>(kb, vb, rows, t_begin, min(kTileK, t_end - t_begin), dv0, ks, vs);

  // q[b, h*G + g0 + g, :] for g < gh is one contiguous run of gh * D elements
  const long long head0 = static_cast<long long>(b) * Hq + h * G + g0;  // [B, Hq] row
  const T* qb = q + head0 * D;
  for (int i = tid; i < gh * D; i += kThreads) qs[i] = to_f32(qb[i]) * scale;
  for (int g = tid; g < gh; g += kThreads) {
    m_s[g] = REPRO_NEG_INF;
    l_s[g] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  int buf = 0;
  for (int t0 = t_begin; t0 < t_end; t0 += kTileK, buf ^= 1) {
    const int n = min(kTileK, t_end - t0);
    if (t0 + kTileK < t_end) {  // the next tile loads while this one computes
      const int t1 = t0 + kTileK, nb = buf ^ 1;
      load_tile<T, D, DVS>(kb, vb, rows, t1, min(kTileK, t_end - t1), dv0,
                           ks + nb * kTileK * kKStride, vs + nb * kTileK * DVS);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + buf * kTileK * kKStride;
    const T* vt = vs + buf * kTileK * DVS;
    for (int i = tid; i < gh * kTileK; i += kThreads) {
      const int g = i / kTileK, j = i % kTileK;
      float s = REPRO_NEG_INF;
      if (j < n) {
        s = 0.f;
        const float* qr = qs + g * D;
        const T* kr = kt + j * kKStride;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          float kf[kVec];
          load16(kr + c * kVec, kf);
#pragma unroll
          for (int e = 0; e < kVec; ++e) s = fmaf(qr[c * kVec + e], kf[e], s);
        }
      }
      ss[i] = s;
    }
    __syncthreads();
    for (int g = warp; g < gh; g += n_warps) {
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
    for (int i = 0; i < kAcc; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < gh * DVS) {
        const int g = idx / DVS, dd = idx % DVS;
        const float* p = ss + g * kTileK;
        float pv = 0.f;
        for (int j = 0; j < n; ++j) pv = fmaf(p[j], to_f32(vt[j * DVS + dd]), pv);
        acc[i] = acc[i] * a_s[g] + pv;
      }
    }
    __syncthreads();  // buffer `buf` and the scores are free for the next tile
  }

  if (partial == nullptr) {
    T* ob = out + head0 * DV + dv0;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < gh * DVS) {
        const int g = idx / DVS, dd = idx % DVS;
        ob[g * DV + dd] = from_f32<T>(acc[i] / fmaxf(l_s[g], REPRO_L_MIN));
      }
    }
    return;
  }
  // partial: acc [splits][B][Hq][DV], then (m, l) [splits][B][Hq][2]
  const long long split_rows = static_cast<long long>(blockIdx.x) * B * Hq + head0;
  float* pa = partial + split_rows * DV + dv0;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < gh * DVS) pa[(idx / DVS) * DV + idx % DVS] = acc[i];
  }
  if (dv0 != 0) return;  // one column block writes (m, l)
  float* pml = partial + static_cast<long long>(gridDim.x) * B * Hq * DV + split_rows * 2;
  for (int g = tid; g < gh; g += kThreads) {
    pml[2 * g] = m_s[g];
    pml[2 * g + 1] = l_s[g];
  }
}

// The block's heads and output columns: grid z walks (head tile of `heads`
// q heads) x (DV / DVS column blocks); the GQA launches have one z block
// holding the whole group (heads = G, DVS = DV).
template <int DV, int DVS>
struct BlockCols {
  int g0, gh, dv0;
  __device__ __forceinline__ BlockCols(int G, int heads) {
    constexpr int nsv = DV / DVS;
    g0 = (blockIdx.z / nsv) * heads;
    gh = min(heads, G - g0);
    dv0 = (blockIdx.z % nsv) * DVS;
  }
};

template <typename T, int D, int DV, int DVS>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lengths,
                        T* __restrict__ out, float* __restrict__ partial, int B, int S,
                        int Hq, int Hkv, int heads, int split_len, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y / Hkv;
  const int h = blockIdx.y % Hkv;
  const BlockCols<DV, DVS> bc(Hq / Hkv, heads);
  const long long row_stride = static_cast<long long>(Hkv) * D;  // between cache rows
  const long long base = static_cast<long long>(b) * S * row_stride + h * D;
  decode_split<T, D, DV, DVS>(smem_raw, q, k + base, v + base, ContigRows{row_stride},
                              min(max(lengths[b], 0), S), out, partial, B, Hq, Hkv, split_len,
                              scale, b, h, bc.g0, bc.gh, bc.dv0);
}

// The same split decode over a block pool kbuf/vbuf [NB, bs, Hkv, D] through
// the block table bt [B, MB]; n_valid [B] counts each row's valid keys.
template <typename T, int D, int DV, int DVS>
__global__ void __launch_bounds__(kThreads)
decode_attention_paged_kernel(const T* __restrict__ q, const T* __restrict__ kbuf,
                              const T* __restrict__ vbuf, const int* __restrict__ bt,
                              const int* __restrict__ n_valid, T* __restrict__ out,
                              float* __restrict__ partial, int B, int NB, int bs, int MB,
                              int Hq, int Hkv, int heads, int split_len, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y / Hkv;
  const int h = blockIdx.y % Hkv;
  const BlockCols<DV, DVS> bc(Hq / Hkv, heads);
  const PagedRows rows{bt + static_cast<long long>(b) * MB, bs, NB,
                       static_cast<long long>(Hkv) * D};
  decode_split<T, D, DV, DVS>(smem_raw, q, kbuf + h * D, vbuf + h * D, rows,
                              min(max(n_valid[b], 0), MB * bs), out, partial, B, Hq, Hkv,
                              split_len, scale, b, h, bc.g0, bc.gh, bc.dv0);
}

// One warp per (row, q head): the live splits' partials merged in split
// order (the JAX package's combine_partial_attention). D here is the
// partial's and the output's width (Dv). kRaw (the partial form, T = float):
// the merged triple unnormalised, acc [B][Hq][D] then (m, l) [B][Hq][2].
template <typename T, int D, bool kRaw = false>
__global__ void __launch_bounds__(kCombineWarps * 32)
decode_attention_combine_kernel(const float* __restrict__ partial,
                                const int* __restrict__ lengths, T* __restrict__ out, int B,
                                int S, int Hq, int splits, int split_len) {
  constexpr int kPer = (D + 31) / 32;  // columns a lane (the last partly idle at D = 16)
  const int row = blockIdx.x * kCombineWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long rows = static_cast<long long>(B) * Hq;
  if (row >= rows) return;
  const int len = min(max(lengths[row / Hq], 0), S);
  const int live = (len + split_len - 1) / split_len;
  const float* pml = partial + static_cast<long long>(splits) * rows * D;
  float m = REPRO_NEG_INF;
  for (int s = 0; s < live; ++s) m = fmaxf(m, pml[(s * rows + row) * 2]);
  float l = 0.f, acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = 0.f;
  for (int s = 0; s < live; ++s) {
    const float alpha = expf(pml[(s * rows + row) * 2] - m);
    l += pml[(s * rows + row) * 2 + 1] * alpha;
    const float* pa = partial + (s * rows + row) * D;
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (lane + 32 * e < D) acc[e] += pa[lane + 32 * e] * alpha;
  }
  T* ob = out + static_cast<long long>(row) * D;
  if constexpr (kRaw) {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (lane + 32 * e < D) ob[lane + 32 * e] = acc[e];
    if (lane == 0) {
      float* ml = out + rows * D + static_cast<long long>(row) * 2;
      ml[0] = m;
      ml[1] = l;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (lane + 32 * e < D) ob[lane + 32 * e] = from_f32<T>(acc[e] / fmaxf(l, REPRO_L_MIN));
  }
}

// The cross-shard merge: P unnormalised triples (acc [P][B][H][D], m and l
// [P][B][H], each read at its own strides, D's columns contiguous) into the
// normalised f32 output [B][H][D]; one warp a (row, head), parts in order.
__global__ void __launch_bounds__(kCombineWarps * 32)
decode_attention_merge_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                              const float* __restrict__ l, float* __restrict__ out, int P,
                              int B, int H, int D, long long sa_p, long long sa_b,
                              long long sa_h, long long sm_p, long long sm_b, long long sm_h,
                              long long sl_p, long long sl_b, long long sl_h) {
  const long long row = static_cast<long long>(blockIdx.x) * kCombineWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(B) * H) return;
  const int b = static_cast<int>(row / H), h = static_cast<int>(row % H);
  const float* mr = m + b * sm_b + h * sm_h;
  const float* lr = l + b * sl_b + h * sl_h;
  float mx = mr[0];
  for (int p = 1; p < P; ++p) mx = fmaxf(mx, mr[p * sm_p]);
  float lsum = 0.f;
  for (int p = 0; p < P; ++p) lsum += lr[p * sl_p] * expf(mr[p * sm_p] - mx);
  const float den = fmaxf(lsum, REPRO_L_MIN);
  const float* ar = acc + b * sa_b + h * sa_h;
  float* ob = out + row * D;
  for (int c = lane; c < D; c += 32) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += ar[p * sa_p + c] * expf(mr[p * sm_p] - mx);
    ob[c] = s / den;
  }
}

// MLA's absorbed latent decode (bf16): q [B, Hq, kD] against the latent
// [B, S, kD] (contiguous) or its block pool [NB, bs, kD] through bt (paged),
// Hkv = 1, V the latent's leading kDV columns read from the key tile. The
// grid is x: the split (decode_attention.py split_plan, as the GQA
// kernel's), y: the batch row, z: (64-head row tile) x (kDVS output
// columns). A block's rows are 64 heads of the row's one query token, the
// rows of the mma.sync tile against each 64-key latent tile
// (latent_attention.cuh); a split past the row's length exits. With one
// split the block writes its normalised output columns; with more, its
// unnormalised f32 partial (acc [splits][B][Hq][kDV], then (m, l)
// [splits][B][Hq][2], m in natural-log units, written by the z blocks of
// output columns 0) for the shared combine kernel.
template <typename W, typename Rows>
__global__ void __launch_bounds__(latent::kThreads)
decode_latent_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kv,
                     const int* __restrict__ lengths, Rows rows_of, long long row_stride_b,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int B,
                     int S, int Hq, int split_len, float scale_log2) {
  // the latent tile's shape (these shadow the GQA kernels' constants)
  constexpr int kThreads = latent::kThreads, kRows = latent::kRows, kTileK = latent::kTileK;
  constexpr int kStride = W::kStride, kChunks = W::kChunks, kD = W::kD;
  constexpr int kDV = W::kDV, kDVS = W::kDVS, kSplitsV = W::kSplitsV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][kStride]
  __nv_bfloat16* ks = qs + kRows * kStride;                          // [2][kTileK][kStride]
  const int b = blockIdx.y;
  const int h0 = (blockIdx.z / kSplitsV) * kRows, dv0 = (blockIdx.z % kSplitsV) * kDVS;
  const int heads = min(kRows, Hq - h0);
  const int len = min(max(lengths[b], 0), S);
  const int t_begin = blockIdx.x * split_len;
  const int t_end = min(len, t_begin + split_len);
  if (partial != nullptr && t_begin >= len) return;  // the combine never reads it
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gid = lane / 4;
  const Rows rows = rows_of.at(b);
  const __nv_bfloat16* kb = kv + static_cast<long long>(b) * row_stride_b;

  const __nv_bfloat16* qb = q + (static_cast<long long>(b) * Hq + h0) * kD;
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    cp_async16(qs + r * kStride + c * 8, r < heads ? qb + r * kD + c * 8 : q,
               r < heads ? 16 : 0);
  }
  cp_async_commit();
  // each key's row resolved once a tile (paged: one block-table read a key,
  // not one per 16-byte chunk), -1 past t_end; only load_k reads it, between
  // its two barriers
  __shared__ int krow[kTileK];
  auto load_k = [&](int t0, int sb) {  // keys t0 .. t0 + 63, those past t_end zero-filled
    __syncthreads();  // the last tile's rows are read
    if (tid < kTileK) krow[tid] = t0 + tid < t_end ? static_cast<int>(rows(t0 + tid)) : -1;
    __syncthreads();
    for (int i = tid; i < kTileK * kChunks; i += kThreads) {
      const int j = i / kChunks, c = i % kChunks, r = krow[j];
      cp_async16(ks + (sb * kTileK + j) * kStride + c * 8,
                 r >= 0 ? kb + static_cast<long long>(r) * kD + c * 8 : kv, r >= 0 ? 16 : 0);
    }
    cp_async_commit();
  };
  bool qlive[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qlive[i] = warp * 16 + gid + 8 * i < heads;
  float o[kDVS / 8][4];
#pragma unroll
  for (int n = 0; n < kDVS / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
  const __nv_bfloat16* qw = qs + warp * 16 * kStride;
  if (t_begin < t_end) load_k(t_begin, 0);
  int sb = 0;
  for (int t0 = t_begin; t0 < t_end; t0 += kTileK, sb ^= 1) {
    if (t0 + kTileK < t_end) {  // the next tile loads while this one computes
      load_k(t0 + kTileK, sb ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n = t_end - t0;
    auto ok = [&](int i, int j) { return qlive[i] && j < n; };
    latent::tile_step<W>(qw, ks + sb * kTileK * kStride, dv0, scale_log2, ok, o, m, l);
    __syncthreads();  // buffer sb is free for the tile after next
  }
  cp_async_wait<0>();  // an empty row: the Q tile's copy is still pending
  __syncthreads();

  const long long head0 = static_cast<long long>(b) * Hq + h0;  // [B, Hq] row of head h0
  if (partial == nullptr) {
    float inv[2];
    latent::row_inverse(l, inv);
    __nv_bfloat16* qwo = qs + warp * 16 * kStride;
    latent::stage_out<W>(qwo, o, inv);
    __nv_bfloat16* ob = out + head0 * kDV + dv0;
    for (int i = lane; i < 16 * (kDVS / 8); i += 32) {
      const int rr = i / (kDVS / 8), c = i % (kDVS / 8), r = warp * 16 + rr;
      if (r < heads)
        *reinterpret_cast<uint4*>(ob + static_cast<long long>(r) * kDV + c * 8) =
            *reinterpret_cast<const uint4*>(qwo + rr * kStride + c * 8);
    }
    return;
  }
  // partial: this thread's accumulator entries as they are, and (m, l) of
  // its two rows from the first output-column block
  const int tig = lane % 4;
  const long long split_rows = static_cast<long long>(blockIdx.x) * B * Hq + head0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    if (r >= heads) continue;
    float* pa = partial + (split_rows + r) * kDV + dv0;
#pragma unroll
    for (int n = 0; n < kDVS / 8; ++n)
      *reinterpret_cast<float2*>(pa + n * 8 + 2 * tig) = make_float2(o[n][2 * i], o[n][2 * i + 1]);
  }
  float lsum[2] = {l[0], l[1]};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 1);
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 2);
  }
  if (dv0 == 0 && tig == 0) {
    float* pml = partial + static_cast<long long>(gridDim.x) * B * Hq * kDV + split_rows * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + gid + 8 * i;
      if (r < heads) {
        pml[2 * r] = m[i] * 0.6931471805599453f;  // log2 units to the combine's natural log
        pml[2 * r + 1] = lsum[i];
      }
    }
  }
}

// Latent row offsets (in rows of kD): contiguous t, or paged through the
// batch row's table. at(b) gives the batch row's own functor.
struct LatentContig {
  __device__ __forceinline__ LatentContig at(int) const { return *this; }
  __device__ __forceinline__ long long operator()(int t) const { return t; }
};
struct LatentPaged {
  const int* bt;
  int bs, nb, mb;
  __device__ __forceinline__ LatentPaged at(int b) const {
    return {bt + static_cast<long long>(b) * mb, bs, nb, mb};
  }
  __device__ __forceinline__ long long operator()(int t) const {
    const int phys = min(max(bt[t / bs], 0), nb - 1);
    return static_cast<long long>(phys) * bs + t % bs;
  }
};

bool bad_plan(int S, int splits, int split_len, const void* partial, const int* bt, int NB,
              int bs) {
  return splits < 1 || splits > 65535 || split_len < kTileK || split_len % kTileK ||
         static_cast<long long>(splits) * split_len < S || (splits > 1 && partial == nullptr) ||
         (bt != nullptr && (bs < 1 || NB < 1 || S % bs));
}

template <typename T, int D, bool kRaw = false>
void combine(float* part, const int* lengths, void* out, int B, int S, int Hq, int splits,
             int split_len, cudaStream_t stream) {
  const int rows = B * Hq;
  decode_attention_combine_kernel<T, D, kRaw>
      <<<(rows + kCombineWarps - 1) / kCombineWarps, kCombineWarps * 32, 0, stream>>>(
          part, lengths, static_cast<T*>(out), B, S, Hq, splits, split_len);
}

// The contiguous kernel when bt is null; else the paged one, over S = MB * bs
// logical keys of an NB-block pool. `heads` is the q heads a block holds (0:
// the whole group of its KV head); a block holds DVS of the DV output
// columns. `raw` (the partial form, contiguous, whole group): `out` is the
// f32 triple, written by the one split's block or by the raw combine.
template <typename T, int D, int DV, int DVS>
int launch(const void* q, const void* k, const void* v, const int* lengths, const int* bt,
           int NB, int bs, void* out, void* partial, int B, int S, int Hq, int Hkv,
           int heads, int splits, int split_len, float scale, cudaStream_t stream,
           bool raw = false) {
  if (Hkv < 1 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  if (heads == 0) heads = G;
  constexpr int kWidest = kThreads * kMaxAcc<D> / DVS;  // most heads a block can hold
  if (heads < 1 || heads > kWidest || bad_plan(S, splits, split_len, partial, bt, NB, bs) ||
      reinterpret_cast<std::uintptr_t>(k) % 16 || reinterpret_cast<std::uintptr_t>(v) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const size_t bytes = Tile<T, D, DVS>::smem_bytes(heads);
  // the attribute once per device for each kernel of this launch, at its
  // widest block, so every G of the instantiation fits under it
  const size_t widest = Tile<T, D, DVS>::smem_bytes(kWidest);
  if (raw && (bt != nullptr || heads != G || DVS != DV || out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = splits > 1 ? static_cast<float*>(partial)
                           : (raw ? static_cast<float*>(out) : nullptr);
  const dim3 grid(splits, B * Hkv, ((G + heads - 1) / heads) * (DV / DVS));
  cudaError_t e;
  if (bt == nullptr) {
    auto kern = decode_attention_kernel<T, D, DV, DVS>;
    static bool smem_allowed[kMaxDevices] = {};
    e = allow_smem(kern, widest, smem_allowed);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
        raw ? nullptr : static_cast<T*>(out), part, B, S, Hq, Hkv, heads, split_len, scale);
  } else if constexpr (D == 256) {
    // D = 256 serves only the hybrid's rings, which the paged pool refuses:
    // the paged kernel is not instantiated at this width
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    auto kern = decode_attention_paged_kernel<T, D, DV, DVS>;
    static bool smem_allowed[kMaxDevices] = {};
    e = allow_smem(kern, widest, smem_allowed);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bt,
        lengths, static_cast<T*>(out), part, B, NB, bs, S / bs, Hq, Hkv, heads, split_len,
        scale);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  if (raw)
    combine<float, DV, true>(part, lengths, out, B, S, Hq, splits, split_len, stream);
  else
    combine<T, DV>(part, lengths, out, B, S, Hq, splits, split_len, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int* lengths, const int* bt,
               int NB, int bs, void* out, void* partial, int B, int S, int Hq, int Hkv, int D,
               int splits, int split_len, float scale, cudaStream_t s, bool raw) {
#define REPRO_CASE(d)                                                                  \
  if (D == d)                                                                          \
    return launch<T, d, d, d>(q, k, v, lengths, bt, NB, bs, out, partial, B, S, Hq, Hkv, \
                              0, splits, split_len, scale, s, raw);
  REPRO_CASE(16) REPRO_CASE(32) REPRO_CASE(64) REPRO_CASE(128)
  REPRO_CASE(256)  // contiguous only (launch refuses a table at this width)
#undef REPRO_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(int dtype, const void* q, const void* k, const void* v, const void* lengths,
             const void* bt, int NB, int bs, void* out, void* partial, int B, int S, int Hq,
             int Hkv, int D, int splits, int split_len, float scale, void* stream,
             bool raw = false) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(bt);
  if (dtype == REPRO_DTYPE_F32)
    return dispatch_d<float>(q, k, v, len, tab, NB, bs, out, partial, B, S, Hq, Hkv, D,
                             splits, split_len, scale, s, raw);
  if (dtype == REPRO_DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, len, tab, NB, bs, out, partial, B, S, Hq, Hkv,
                                     D, splits, split_len, scale, s, raw);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The latent's tensor-core decode at widths W (bf16).
template <typename W>
int launch_latent(const void* q, const void* kv, const int* len, const int* bt, int NB, int bs,
                  void* out, void* partial, int B, int S, int Hq, int splits, int split_len,
                  float scale, cudaStream_t s) {
  const size_t bytes = W::kTileBytes;
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const dim3 grid(splits, B, ((Hq + latent::kRows - 1) / latent::kRows) * W::kSplitsV);
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(kv);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t e;
  if (bt == nullptr) {
    auto kern = decode_latent_kernel<W, LatentContig>;
    static bool smem_allowed[kMaxDevices] = {};
    e = allow_smem(kern, bytes, smem_allowed);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, latent::kThreads, bytes, s>>>(qb, kb, len, LatentContig{},
                                                static_cast<long long>(S) * W::kD, ob, part, B,
                                                S, Hq, split_len, scale_log2);
  } else {
    auto kern = decode_latent_kernel<W, LatentPaged>;
    static bool smem_allowed[kMaxDevices] = {};
    e = allow_smem(kern, bytes, smem_allowed);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, latent::kThreads, bytes, s>>>(qb, kb, len, LatentPaged{bt, bs, NB, S / bs}, 0,
                                                ob, part, B, S, Hq, split_len, scale_log2);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || part == nullptr) return static_cast<int>(e);
  combine<__nv_bfloat16, W::kDV>(part, len, out, B, S, Hq, splits, split_len, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_launch(int dtype, const void* q, const void* k,
                                       const void* v, const void* lengths, void* out,
                                       void* partial, int B, int S, int Hq, int Hkv, int D,
                                       int splits, int split_len, float scale, void* stream) {
  return dispatch(dtype, q, k, v, lengths, nullptr, 0, 0, out, partial, B, S, Hq, Hkv, D,
                  splits, split_len, scale, stream);
}

// The partial form over a contiguous shard k, v [B, S, Hkv, D] (D == Dv), valid
// below lengths[b] (clamped to [0, S]): out the f32 triple [B*Hq*D] (acc) then
// [B*Hq*2] (m, l); partial the split workspace (splits > 1).
extern "C" int decode_attention_partial_launch(int dtype, const void* q, const void* k,
                                               const void* v, const void* lengths, void* out,
                                               void* partial, int B, int S, int Hq, int Hkv,
                                               int D, int splits, int split_len, float scale,
                                               void* stream) {
  return dispatch(dtype, q, k, v, lengths, nullptr, 0, 0, out, partial, B, S, Hq, Hkv, D,
                  splits, split_len, scale, stream, true);
}

// The merge of P f32 triples into out [B, H, D] f32: acc, m and l each at
// their strides (elements) over (part, row, head); acc's D columns
// contiguous.
extern "C" int decode_attention_merge_launch(const void* acc, const void* m, const void* l,
                                             void* out, int P, int B, int H, int D,
                                             long long sa_p, long long sa_b, long long sa_h,
                                             long long sm_p, long long sm_b, long long sm_h,
                                             long long sl_p, long long sl_b, long long sl_h,
                                             void* stream) {
  if (P < 1 || B < 0 || H < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * H;
  if (rows == 0) return 0;
  const long long blocks = (rows + kCombineWarps - 1) / kCombineWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  decode_attention_merge_kernel<<<static_cast<unsigned>(blocks), kCombineWarps * 32, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<float*>(out), P, B, H, D, sa_p, sa_b, sa_h,
      sm_p, sm_b, sm_h, sl_p, sl_b, sl_h);
  return static_cast<int>(cudaGetLastError());
}

// q [B, Hq, D]; kbuf, vbuf [NB, bs, Hkv, D]; bt [B, MB] and n_valid [B] int32.
extern "C" int paged_decode_attention_launch(int dtype, const void* q, const void* kbuf,
                                             const void* vbuf, const void* bt,
                                             const void* n_valid, void* out, void* partial,
                                             int B, int NB, int bs, int MB, int Hq, int Hkv,
                                             int D, int splits, int split_len, float scale,
                                             void* stream) {
  if (bt == nullptr || MB < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, q, kbuf, vbuf, n_valid, bt, NB, bs, out, partial, B, MB * bs, Hq,
                  Hkv, D, splits, split_len, scale, stream);
}

// MLA's absorbed latent at (D, DV) = (576, 512) or (96, 64): q [B, Hq, D]; kv
// the latent [B, S, D] when bt is null, else its block pool [NB, bs, D] read
// through bt [B, MB] (S = MB * bs); lengths [B] the valid keys; out [B, Hq,
// DV]; partial the split workspace (splits > 1). bf16 runs the latent's
// tensor-core kernel; f32 the CUDA-core split decode with Hkv = 1, V read at
// K's row stride, kLatentHeads heads and min(128, DV) columns a block.
extern "C" int decode_attention_latent_launch(int dtype, const void* q, const void* kv,
                                              const void* lengths, const void* bt, int NB,
                                              int bs, void* out, void* partial, int B, int S,
                                              int Hq, int D, int DV, int splits, int split_len,
                                              float scale, void* stream) {
  const int* len = static_cast<const int*>(lengths);
  const int* tab = static_cast<const int*>(bt);
  if (bad_plan(S, splits, split_len, partial, tab, NB, bs) || B > 65535 || Hq < 1 ||
      reinterpret_cast<std::uintptr_t>(kv) % 16 || reinterpret_cast<std::uintptr_t>(q) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_BF16) {
    if (D == latent::Mla::kD && DV == latent::Mla::kDV)
      return launch_latent<latent::Mla>(q, kv, len, tab, NB, bs, out, partial, B, S, Hq,
                                        splits, split_len, scale, s);
    if (D == latent::MlaSmoke::kD && DV == latent::MlaSmoke::kDV)
      return launch_latent<latent::MlaSmoke>(q, kv, len, tab, NB, bs, out, partial, B, S, Hq,
                                             splits, split_len, scale, s);
  } else if (dtype == REPRO_DTYPE_F32) {
    const int heads = Hq < kLatentHeads ? Hq : kLatentHeads;
    if (D == 576 && DV == 512)
      return launch<float, 576, 512, 128>(q, kv, kv, len, tab, NB, bs, out, partial, B, S, Hq,
                                          1, heads, splits, split_len, scale, s);
    if (D == 96 && DV == 64)
      return launch<float, 96, 64, 64>(q, kv, kv, len, tab, NB, bs, out, partial, B, S, Hq, 1,
                                       heads, splits, split_len, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
