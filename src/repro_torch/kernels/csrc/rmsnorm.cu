// Fused RMSNorm over the rows of a contiguous [N, d] view.
//
// Replaces: repro/kernels/rmsnorm.py::rmsnorm_pallas (_rmsnorm_kernel).
// Computes: y = (x * rsqrt(mean(x^2) + eps)) * w, in f32, cast back to T.
// Bound on the H100: bytes. It reads each x once and writes each y once
// (2 * N * d * sizeof(T) bytes) for ~4 flops per element, far below the
// card's ~295 flop/byte ridge; at the served shapes (N = 8 decode rows or
// N = prompt rows, d = 2048) it is a few microseconds, below launch cost.
// Design: one 256-thread block per row. Pass 1 accumulates sum(x^2) in f32
// with strided loads (neighbouring threads on neighbouring elements) and
// a warp-shuffle + shared-memory block reduction; pass 2 re-reads the row,
// which is 4 KB at d = 2048 in bf16 and comes back from L1/L2, not HBM.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
               int d, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  __shared__ float partial[kThreads / 32];
  __shared__ float inv_rms;
  ss = warp_sum(ss);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) inv_rms = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    yr[i] = from_f32<T>((to_f32(xr[i]) * r) * to_f32(w[i]));
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, long long n_rows, int d, float eps,
           cudaStream_t stream) {
  if (n_rows == 0) return 0;
  rmsnorm_kernel<T><<<dim3(static_cast<unsigned>(n_rows)), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rmsnorm_launch(int dtype, const void* x, const void* w, void* y,
                              long long n_rows, int d, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32) return launch<float>(x, w, y, n_rows, d, eps, s);
  if (dtype == REPRO_DTYPE_BF16) return launch<__nv_bfloat16>(x, w, y, n_rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
