// Fused base + LoRA matmul for Hopper (sm_90a):
//
//   y = x @ W + scale * ((x @ A) rounded to x's dtype) @ B
//   x [M, K], W [K, N], A [K, r], B [r, N], scale a device scalar (f32)
//
// Replaces the Pallas TPU kernel src/repro/kernels/lora_matmul.py:26
// `_lora_kernel` (wrapper `lora_matmul`, :51), which the shared head of the
// heterogeneous model zoo (src/repro/models/zoo.py `head_forward`) runs on
// every forward. Like it, the kernel keeps both low-rank intermediates on
// chip: x@A never goes to device memory, and the output tile is written
// once, in x's dtype, from f32 accumulators.
//
// Bound. 2*M*N*K + 2*M*K*r + 2*M*r*N f32 operations against
// (M*K + K*N + K*r + r*N + M*N) * sizeof(T) bytes. At the zoo head's shapes
// (M 8-160, K = N = 16, r = 4) that is at most 0.2 MFLOP and 13 kB: the
// bound is a few nanoseconds and the launch latency is the whole time. At
// the reference's sweep shape (M, K, N, r) = (128, 1024, 256, 64) f32 it is
// 88.1 MFLOP (1.31 us at 67 TFLOP/s) against 2.03 MB (0.61 us at 3.35 TB/s):
// bound by the operations.
//
// Design: simple and right. A 2-D grid of BM x BN output tiles; the K loop
// runs inside the block and takes the place of the TPU grid's sequential
// third axis. Each K step stages the x, W and A tiles in shared memory (as
// f32, bf16 widened on load, the ragged edges zero-filled), adds the tile's
// products into the block's acc [BM, BN] (registers, 2 x 2 outputs per
// thread) and into xa [BM, r] (shared memory, each entry owned by one
// thread). After the loop xa is rounded to x's dtype, as the TPU kernel
// rounds it before its last dot, and every output adds scale * xa @ B[:, col]
// with B read through the read-only cache. All products are full f32 FMAs
// (no TF32, no tensor cores). Every block recomputes xa for its rows, so
// xa's share of the work grows with the number of column tiles; removing
// that, and a wgmma/TMA pipeline, is work for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;
constexpr int kBN = 32;
constexpr int kBK = 32;
constexpr int kRMax = 128;
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lora_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const T* __restrict__ a, const T* __restrict__ b,
            const float* __restrict__ scale, T* __restrict__ y, int m, int k,
            int n, int r) {
  __shared__ float sx[kBM][kBK + 1];   // +1: rows of xa read down a column
  __shared__ float sw[kBK][kBN];
  __shared__ float sa[kBK][kRMax];
  __shared__ float sxa[kBM][kRMax];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  for (int e = tid; e < kBM * r; e += kThreads) sxa[e / r][e % r] = 0.f;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int i = e / kBK, kk = e % kBK;
      const int gi = row0 + i, gk = k0 + kk;
      sx[i][kk] = (gi < m && gk < k)
                      ? to_f32(x[static_cast<int64_t>(gi) * k + gk]) : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN, j = e % kBN;
      const int gk = k0 + kk, gj = col0 + j;
      sw[kk][j] = (gk < k && gj < n)
                      ? to_f32(w[static_cast<int64_t>(gk) * n + gj]) : 0.f;
    }
    for (int e = tid; e < kBK * r; e += kThreads) {
      const int kk = e / r, c = e % r;
      const int gk = k0 + kk;
      sa[kk][c] = gk < k ? to_f32(a[static_cast<int64_t>(gk) * r + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float x0 = sx[ty][kk], x1 = sx[ty + kTY][kk];
      const float w0 = sw[kk][tx], w1 = sw[kk][tx + kTX];
      acc[0][0] = fmaf(x0, w0, acc[0][0]);
      acc[0][1] = fmaf(x0, w1, acc[0][1]);
      acc[1][0] = fmaf(x1, w0, acc[1][0]);
      acc[1][1] = fmaf(x1, w1, acc[1][1]);
    }
    for (int e = tid; e < kBM * r; e += kThreads) {
      const int i = e / r, c = e % r;
      float s = sxa[i][c];
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) s = fmaf(sx[i][kk], sa[kk][c], s);
      sxa[i][c] = s;
    }
    __syncthreads();
  }

  // the TPU kernel rounds xa to the input dtype before its last dot
  for (int e = tid; e < kBM * r; e += kThreads)
    sxa[e / r][e % r] = round_to(sxa[e / r][e % r], T());
  __syncthreads();

  const float s = *scale;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int i = ty + ii * kTY;
    const int gi = row0 + i;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int gj = col0 + tx + jj * kTX;
      if (gi >= m || gj >= n) continue;
      float low = 0.f;
      for (int q = 0; q < r; ++q)
        low = fmaf(sxa[i][q], to_f32(__ldg(b + static_cast<int64_t>(q) * n + gj)),
                   low);
      store(y + static_cast<int64_t>(gi) * n + gj,
            __fadd_rn(acc[ii][jj], __fmul_rn(s, low)));
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). x [m, k], w [k, n], a [k, r],
// b [r, n], y [m, n], all row-major in one dtype (0 f32, 1 bf16); scale one
// f32 on the device. Launches on `stream`, does not synchronize, and
// returns cudaGetLastError() (0 on success).
extern "C" int lora_matmul_launch(const void* x, const void* w, const void* a,
                                  const void* b, const void* scale, void* y,
                                  int m, int k, int n, int r, int dtype,
                                  void* stream) {
  if (m < 1 || k < 1 || n < 1 || r < 1 || r > kRMax ||
      (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const dim3 block(kTX, kTY);
  const float* sp = static_cast<const float*>(scale);
  if (dtype == 0) {
    lora_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(a), static_cast<const float*>(b), sp,
        static_cast<float*>(y), m, k, n, r);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    lora_kernel<bf><<<grid, block, 0, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(w),
        static_cast<const bf*>(a), static_cast<const bf*>(b), sp,
        static_cast<bf*>(y), m, k, n, r);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
