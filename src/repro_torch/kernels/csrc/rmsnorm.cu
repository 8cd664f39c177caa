// RMSNorm over the rows of an [N, d] view, with a fused prologue that makes
// the normalised row out of the elementwise op before it.
//
// Replaces: repro/kernels/rmsnorm.py::rmsnorm_pallas (_rmsnorm_kernel), the
// paper's "fuse the operations around the norm" lever (§4.1.2).
// Computes: y = (p * rsqrt(mean(p^2) + eps)) * w in f32, cast to T, where p
// is the row the prologue makes from x and a second operand r:
//   none      p = x
//   add       p = T(x + r), also written out as s (the residual stream)
//   mul       p = T(x * r)
//   mul_silu  p = T(x * T(silu(r))), silu(z) = z / (1 + expf(-z))
// Every T(.) rounds an f32 result to T where the unfused PyTorch op rounds
// it (bf16: round to nearest even), before it is squared: the fused result
// equals the unfused ops', and s equals x + r bit for bit. r is a
// row-strided view (r_stride elements between rows, unit last stride), so
// the models pass a slice of a wider projection without a copy.
// Bound on the H100: bytes (each input read once, each output written
// once; ~5 flops per element against the card's ~295 flop/byte ridge).
// Design: W warps per row (W = 1 on wide grids: one warp per row, four rows
// a block). The row is held in registers, E elements a lane, as 16-byte
// vectors (8 bf16 or 4 f32): the row's lane g (of 32 W) takes vectors g,
// g + 32 W, ..., so a warp's loads are 512 contiguous bytes each. Every load
// of the row (x, r and w) is issued before any arithmetic, the sum of
// squares is reduced with warp shuffles (and, for W > 1, the W warps' sums
// through shared memory and one __syncthreads), and the row is read once.
// W and E are the wrapper's plan (kernels/rmsnorm.py route()): the fewest
// warps that hold the row within kMaxLaneBytes a lane, more (up to 8) on a
// grid of few rows, where the time is latency (a decode step, a short
// prefill) and W splits each row's chain of loads and arithmetic. A row
// whose addresses are not all 16-byte aligned, and the ragged last vector
// of a row, load and store element by element (the branch is uniform over
// the warp). Rows longer than 8 warps hold go to a block-per-row kernel
// that reads the row twice.
#include <cstdint>

#include "common.cuh"

namespace {

// prologue codes of the C interface (kernels/rmsnorm.py PROLOGUES)
constexpr int kNone = 0, kAdd = 1, kMul = 2, kMulSilu = 3;

constexpr int kMaxLaneBytes = 128;  // of each operand a lane holds: 32 W lanes hold 4096 W bytes
constexpr int kBlockThreads = 256;  // the block-per-row path

// rows a block of the warp path holds: four warps a block at W <= 4
__host__ __device__ constexpr int rows_per_block(int w) { return w >= 4 ? 1 : 4 / w; }

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The prologue on one element, rounded as the unfused ops round it.
template <typename T, int P>
__device__ __forceinline__ float prologue(float a, float b) {
  if constexpr (P == kAdd) {
    return round_to<T>(a + b);
  } else if constexpr (P == kMul) {
    return round_to<T>(a * b);
  } else if constexpr (P == kMulSilu) {
    return round_to<T>(a * round_to<T>(b / (1.f + expf(-b))));
  } else {
    return a;
  }
}

// ---- 16-byte vectors of T held as raw bits --------------------------------

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// element e of a vector as f32
template <typename T>
__device__ __forceinline__ float elt(const uint4& v, int e);
template <>
__device__ __forceinline__ float elt<float>(const uint4& v, int e) {
  return __uint_as_float(word(v, e));
}
template <>
__device__ __forceinline__ float elt<__nv_bfloat16>(const uint4& v, int e) {
  const uint32_t w = word(v, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// V f32 values (exact in T) packed as one vector of T
template <typename T>
__device__ __forceinline__ uint4 pack(const float (&v)[kVec<T>]) {
  uint32_t w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = bits_of(__float2bfloat16(v[2 * i])) | (bits_of(__float2bfloat16(v[2 * i + 1])) << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The elements of T at p as one vector, of which the first n (any int) lie
// inside the row, zeros past them: one 16-byte load when the vector is whole
// and aligned, else per element.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* p, int n, bool vec) {
  constexpr int V = kVec<T>;
  if (vec && n >= V) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (e < n) {
      if constexpr (sizeof(T) == 4) {
        w[e] = bits_of(p[e]);
      } else {
        w[e >> 1] |= bits_of(p[e]) << ((e & 1) * 16);
      }
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Store a vector at p, of which the first n (any int) lie inside the row.
template <typename T>
__device__ __forceinline__ void store_vec(T* p, int n, bool vec, const uint4& v) {
  constexpr int V = kVec<T>;
  if (vec && n >= V) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (e < n) p[e] = from_f32<T>(elt<T>(v, e));
  }
}

// ---- the warp path: W warps per row, the row in registers ----------------

template <typename T, int P, int E, int W>
__global__ void __launch_bounds__(32 * W * rows_per_block(W))
rmsnorm_warp_kernel(const T* __restrict__ x, const T* __restrict__ r, long long r_stride,
                    const T* __restrict__ w, T* __restrict__ s, T* __restrict__ y,
                    long long n_rows, int d, float eps) {
  constexpr int V = kVec<T>;
  constexpr int K = E / V;  // vectors a lane holds
  constexpr int R = rows_per_block(W);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = (warp % W) * 32 + lane;  // the lane's place among its row's 32 W
  long long row = static_cast<long long>(blockIdx.x) * R + warp / W;
  if constexpr (W == 1) {
    if (row >= n_rows) return;  // the whole warp: nothing below syncs the block
  }
  // a row past the end (W > 1: its warps still reach the __syncthreads)
  // loads and stores nothing
  const int dd = row < n_rows ? d : 0;
  row = row < n_rows ? row : 0;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const T* rr = nullptr;
  T* sr = nullptr;
  bool vec = aligned16(xr) && aligned16(w) && aligned16(yr);
  if constexpr (P != kNone) {
    rr = r + row * r_stride;
    vec = vec && aligned16(rr);
  }
  if constexpr (P == kAdd) {
    sr = s + row * d;
    vec = vec && aligned16(sr);
  }

  // every load of the row first: x, r and w
  uint4 xa[K], ra[K], wa[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e0 = (g + 32 * W * k) * V;
    const int n = dd - e0;  // elements of this vector inside the row (all of it when >= V)
    xa[k] = load_vec(xr + e0, n, vec);
    if constexpr (P != kNone) ra[k] = load_vec(rr + e0, n, vec);
    wa[k] = load_vec(w + e0, n, vec);
  }

  // the prologue's row (kept in xa, exact in T) and its sum of squares;
  // the zeros past d stay zero through every prologue
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if constexpr (P == kNone) {
        v[e] = elt<T>(xa[k], e);
      } else {
        v[e] = prologue<T, P>(elt<T>(xa[k], e), elt<T>(ra[k], e));
      }
      ss = fmaf(v[e], v[e], ss);
    }
    if constexpr (P != kNone) xa[k] = pack<T>(v);
  }
  if constexpr (P == kAdd) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e0 = (g + 32 * W * k) * V;
      store_vec(sr + e0, dd - e0, vec, xa[k]);
    }
  }
  ss = warp_sum(ss);
  if constexpr (W > 1) {  // the row's W warp sums, added in one order by all
    __shared__ float partial[R][W];
    if (lane == 0) partial[warp / W][warp % W] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) ss += partial[warp / W][i];
  }
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e0 = (g + 32 * W * k) * V;
    float o[V];
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = (elt<T>(xa[k], e) * inv) * elt<T>(wa[k], e);
    store_vec(yr + e0, dd - e0, vec, pack<T>(o));
  }
}

// ---- the block path: one block per row, rows past the register budget -----

template <typename T, int P>
__device__ __forceinline__ float prologue_at(const T* xr, const T* rr, int i) {
  if constexpr (P == kNone) {
    return to_f32(xr[i]);
  } else {
    return prologue<T, P>(to_f32(xr[i]), to_f32(rr[i]));
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kBlockThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const T* __restrict__ r, long long r_stride,
                     const T* __restrict__ w, T* __restrict__ s, T* __restrict__ y, int d,
                     float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  const T* rr = P == kNone ? nullptr : r + row * r_stride;
  T* yr = y + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kBlockThreads) {
    const float v = prologue_at<T, P>(xr, rr, i);
    if constexpr (P == kAdd) s[row * d + i] = from_f32<T>(v);
    ss = fmaf(v, v, ss);
  }
  __shared__ float partial[kBlockThreads / 32];
  __shared__ float inv_rms;
  ss = warp_sum(ss);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kBlockThreads / 32 ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) inv_rms = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float inv = inv_rms;
  // the second pass makes the prologue's row again (the same rounding) from
  // the inputs, which come back from L1/L2
  for (int i = threadIdx.x; i < d; i += kBlockThreads) {
    yr[i] = from_f32<T>((prologue_at<T, P>(xr, rr, i) * inv) * to_f32(w[i]));
  }
}

// ---- dispatch -------------------------------------------------------------

struct Args {
  const void* x;
  const void* r;
  long long r_stride;
  const void* w;
  void* s;
  void* y;
  long long n_rows;
  int d;
  float eps;
};

template <typename T, int P, int E, int W>
int launch_warp(const Args& a, cudaStream_t stream) {
  constexpr int R = rows_per_block(W);
  const long long blocks = (a.n_rows + R - 1) / R;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_warp_kernel<T, P, E, W><<<dim3(static_cast<unsigned>(blocks)), 32 * W * R, 0,
                                    stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.r), a.r_stride,
      static_cast<const T*>(a.w), static_cast<T*>(a.s), static_cast<T*>(a.y), a.n_rows, a.d,
      a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
constexpr int kMaxE = kMaxLaneBytes / static_cast<int>(sizeof(T));

// The warp kernel with E = per_lane elements a lane (a multiple of 8, so of V
// in both types, within kMaxE; 24 and 48 at W = 1 only).
template <typename T, int P, int W>
int launch_w(const Args& a, int per_lane, cudaStream_t stream) {
  switch (per_lane) {
    case 8: return launch_warp<T, P, 8, W>(a, stream);
    case 16: return launch_warp<T, P, 16, W>(a, stream);
    case 24:
      if constexpr (W == 1) return launch_warp<T, P, 24, W>(a, stream);
      break;
    case 32: return launch_warp<T, P, 32, W>(a, stream);
    case 48:
      if constexpr (W == 1 && kMaxE<T> >= 48) return launch_warp<T, P, 48, W>(a, stream);
      break;
    case 64:
      if constexpr (kMaxE<T> >= 64) return launch_warp<T, P, 64, W>(a, stream);
      break;
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// warps > 0: the warp path with that many warps a row, which must hold the
// row; warps == 0: the block path.
template <typename T, int P>
int launch(const Args& a, int warps, int per_lane, cudaStream_t stream) {
  if (warps > 0) {
    if (32LL * warps * per_lane < a.d) return static_cast<int>(cudaErrorInvalidValue);
    switch (warps) {
      case 1: return launch_w<T, P, 1>(a, per_lane, stream);
      case 2: return launch_w<T, P, 2>(a, per_lane, stream);
      case 4: return launch_w<T, P, 4>(a, per_lane, stream);
      case 8: return launch_w<T, P, 8>(a, per_lane, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (a.n_rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_block_kernel<T, P><<<dim3(static_cast<unsigned>(a.n_rows)), kBlockThreads, 0,
                               stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.r), a.r_stride,
      static_cast<const T*>(a.w), static_cast<T*>(a.s), static_cast<T*>(a.y), a.d, a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_type(int prologue, const Args& a, int warps, int per_lane, cudaStream_t stream) {
  switch (prologue) {
    case kNone: return launch<T, kNone>(a, warps, per_lane, stream);
    case kAdd: return launch<T, kAdd>(a, warps, per_lane, stream);
    case kMul: return launch<T, kMul>(a, warps, per_lane, stream);
    case kMulSilu: return launch<T, kMulSilu>(a, warps, per_lane, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the split-row form: a row whose channels lie on several ranks --------
//
// A tensor-parallel rank holds d of a row's d_total channels (Mamba-2's gate
// norm over d_inner at TP > 1). Pass 1 makes the prologue's row p (rounded
// to T as above) and writes it with the row's f32 partial sum of squares;
// the caller sums the partials over the ranks; pass 2 scales p by
// rsqrt(sum / d_total + eps) and the weight, in the whole-row kernel's
// order. One warp per row, four rows a block, element by element: simple
// first (each pass reads and writes the row once; bound by bytes).

constexpr int kSplitRows = 4;

template <typename T, int P>
__global__ void __launch_bounds__(32 * kSplitRows)
rmsnorm_partial_kernel(const T* __restrict__ x, const T* __restrict__ r, long long r_stride,
                       T* __restrict__ p, float* __restrict__ sumsq, long long n_rows,
                       int d) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kSplitRows + threadIdx.x / 32;
  if (row >= n_rows) return;
  const T* xr = x + row * d;
  const T* rr = r + row * r_stride;
  T* pr = p + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = prologue<T, P>(to_f32(xr[i]), to_f32(rr[i]));
    pr[i] = from_f32<T>(v);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) sumsq[row] = ss;
}

template <typename T>
__global__ void __launch_bounds__(32 * kSplitRows)
rmsnorm_scale_kernel(const T* __restrict__ p, const float* __restrict__ sumsq,
                     const T* __restrict__ w, T* __restrict__ y, long long n_rows, int d,
                     float d_total, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kSplitRows + threadIdx.x / 32;
  if (row >= n_rows) return;
  const float inv = rsqrtf(sumsq[row] / d_total + eps);
  const T* pr = p + row * d;
  T* yr = y + row * d;
  for (int i = lane; i < d; i += 32) yr[i] = from_f32<T>((to_f32(pr[i]) * inv) * to_f32(w[i]));
}

template <typename T>
int launch_partial(int prologue, const void* x, const void* r, long long r_stride, void* p,
                   float* sumsq, long long n_rows, int d, cudaStream_t stream) {
  const long long blocks = (n_rows + kSplitRows - 1) / kSplitRows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const auto* xt = static_cast<const T*>(x);
  const auto* rt = static_cast<const T*>(r);
  auto* pt = static_cast<T*>(p);
  switch (prologue) {
    case kMul:
      rmsnorm_partial_kernel<T, kMul><<<grid, 32 * kSplitRows, 0, stream>>>(
          xt, rt, r_stride, pt, sumsq, n_rows, d);
      break;
    case kMulSilu:
      rmsnorm_partial_kernel<T, kMulSilu><<<grid, 32 * kSplitRows, 0, stream>>>(
          xt, rt, r_stride, pt, sumsq, n_rows, d);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scale(const void* p, const float* sumsq, const void* w, void* y, long long n_rows,
                 int d, float d_total, float eps, cudaStream_t stream) {
  const long long blocks = (n_rows + kSplitRows - 1) / kSplitRows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_scale_kernel<T><<<dim3(static_cast<unsigned>(blocks)), 32 * kSplitRows, 0, stream>>>(
      static_cast<const T*>(p), sumsq, static_cast<const T*>(w), static_cast<T*>(y), n_rows, d,
      d_total, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pass 1 of the split-row form: p = the prologue's row of x and r (mul or
// mul_silu; r row-strided), sumsq [n_rows] f32 its partial sums of squares.
extern "C" int rmsnorm_partial_launch(int dtype, int prologue, const void* x, const void* r,
                                      long long r_stride, void* p, float* sumsq,
                                      long long n_rows, int d, void* stream) {
  if (n_rows == 0 || d == 0) return 0;
  if (n_rows < 0 || d < 0 || x == nullptr || r == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32) {
    return launch_partial<float>(prologue, x, r, r_stride, p, sumsq, n_rows, d, st);
  }
  if (dtype == REPRO_DTYPE_BF16) {
    return launch_partial<__nv_bfloat16>(prologue, x, r, r_stride, p, sumsq, n_rows, d, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Pass 2: y = (p * rsqrt(sumsq / d_total + eps)) * w, sumsq summed over the
// ranks.
extern "C" int rmsnorm_scale_launch(int dtype, const void* p, const float* sumsq,
                                    const void* w, void* y, long long n_rows, int d,
                                    float d_total, float eps, void* stream) {
  if (n_rows == 0 || d == 0) return 0;
  if (n_rows < 0 || d < 0 || !(d_total >= static_cast<float>(d))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32) {
    return launch_scale<float>(p, sumsq, w, y, n_rows, d, d_total, eps, st);
  }
  if (dtype == REPRO_DTYPE_BF16) {
    return launch_scale<__nv_bfloat16>(p, sumsq, w, y, n_rows, d, d_total, eps, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// r (row stride r_stride elements) is read for every prologue but none; s is
// written by add only; (warps, per_lane) is the plan (warps 0: the block
// path). Nothing is launched for n_rows == 0.
extern "C" int rmsnorm_launch(int dtype, int prologue, int warps, int per_lane, const void* x,
                              const void* r, long long r_stride, const void* w, void* s,
                              void* y, long long n_rows, int d, float eps, void* stream) {
  if (n_rows == 0 || d == 0) return 0;
  if (n_rows < 0 || d < 0 || (prologue != kNone && r == nullptr) ||
      (prologue == kAdd && s == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, r, r_stride, w, s, y, n_rows, d, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32) return launch_type<float>(prologue, a, warps, per_lane, st);
  if (dtype == REPRO_DTYPE_BF16) {
    return launch_type<__nv_bfloat16>(prologue, a, warps, per_lane, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
