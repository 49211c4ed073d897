// Fused gated swarm commits for Hopper (sm_90a): the whole swarm's commit
// over the flat [N, P] state in one launch, and one node's commit.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_merge.py
// `fused_merge_all` — body `_merge_all_kernel` (W-row form, mean/fedavg
// commit) and `_merge_all_imp_kernel` (importance-weighted form,
// fisher/gradmatch/topology-restricted commit):
//
//   out[i] = gate[i] ? sum_j W[i,j] * x[j]                          : x[i]
//   out[i] = gate[i] ? sum_j (W[i,j]*f[j]) * x[j] / max(sum_j W[i,j]*f[j], 1e-30)
//                                                                    : x[i]
//
// Bound: memory. Each column does at most 2*N*N flops (3*N*N with imp) for
// N*4 bytes in (2*N*4 with imp) and N*4 bytes out, far below the card's
// flop/byte ratio at the swarm sizes this serves (N <= 64). The least
// traffic is reading x (and imp) once and writing out once: 2*N*P*4 bytes
// (3*N*P*4 with imp).
//
// Design: one thread owns one column of [N, P] at a time (grid-stride).
// Neighbouring threads own neighbouring columns, so every row load and store
// of a warp is one coalesced 128-byte transaction. W [N, N] and the gates
// are staged once per block in shared memory. The column's N inputs (and N
// importances) are loaded once into registers, and all N output rows are
// produced from them; the accumulation is f32, in j order, with separately
// rounded multiplies and adds (the same arithmetic as the plain version in
// kernels/ref.py, so the two agree bit for bit). The ragged edge is masked
// by the column bound, not padded. A rejected row stores the loaded input
// value itself, so it is bit-exact. bf16 inputs are widened to f32 and the
// result rounds to nearest even. N is a template bound (4..64) so the
// per-column arrays stay in registers.
//
// The one-node form replaces `fused_merge` (body `_merge_kernel`), the
// commit of a single node from one weight row, its own row index and a
// scalar gate, [N, D] -> [D]:
//
//   out = gate ? sum_j w[j] * x[j] : x[self_idx]
//
// Bound: memory, (N + 1)*D*4 bytes for f32. Same design, one output row:
// a thread per column, the weights in shared memory, the gate and self_idx
// taken by value when the caller has them on the host, else read on the
// device (a 0-d device tensor: no host synchronization), the sum f32 in j
// order
// with separately rounded multiplies and adds (bit-equal to
// kernels/ref.py::fused_merge_plain), a rejected gate storing row self_idx
// itself.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float from_f32(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

template <typename T, int NMAX, bool HAS_IMP>
__global__ void __launch_bounds__(kThreads)
merge_all_kernel(const T* __restrict__ x, const float* __restrict__ imp,
                 const float* __restrict__ W,
                 const int32_t* __restrict__ gates, T* __restrict__ out,
                 int n, int64_t d) {
  extern __shared__ float smem[];
  float* sW = smem;                                          // [n, n]
  int32_t* sg = reinterpret_cast<int32_t*>(smem + n * n);    // [n]
  for (int k = threadIdx.x; k < n * n; k += blockDim.x) sW[k] = W[k];
  for (int k = threadIdx.x; k < n; k += blockDim.x) sg[k] = gates[k];
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       col < d; col += stride) {
    T xr[NMAX];
    float fv[HAS_IMP ? NMAX : 1];
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j < n) {
        xr[j] = x[static_cast<int64_t>(j) * d + col];
        if constexpr (HAS_IMP) fv[j] = imp[static_cast<int64_t>(j) * d + col];
      }
    }
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      T res = xr[0];
      if (sg[i] != 0) {
        const float* wi = sW + i * n;
        float num = 0.f;
        float den = 0.f;
#pragma unroll
        for (int j = 0; j < NMAX; ++j) {
          if (j < n) {
            if constexpr (HAS_IMP) {
              const float wf = __fmul_rn(wi[j], fv[j]);
              num = __fadd_rn(num, __fmul_rn(wf, to_f32(xr[j])));
              den = __fadd_rn(den, wf);
            } else {
              num = __fadd_rn(num, __fmul_rn(wi[j], to_f32(xr[j])));
            }
          }
        }
        float merged = num;
        if constexpr (HAS_IMP) merged = __fdiv_rn(num, fmaxf(den, 1e-30f));
        res = from_f32(merged, T());
      } else {
        // the row's own input, picked without indexing the register array
#pragma unroll
        for (int j = 1; j < NMAX; ++j) {
          if (j == i) res = xr[j];
        }
      }
      out[static_cast<int64_t>(i) * d + col] = res;
    }
  }
}

template <typename T, int NMAX>
void launch(const void* x, const void* imp, const void* W, const void* gates,
            void* out, int n, int64_t d, cudaStream_t stream) {
  const int64_t want = (d + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 2147483647 ? want
                                                                  : 2147483647);
  const size_t smem = static_cast<size_t>(n) * n * sizeof(float) +
                      static_cast<size_t>(n) * sizeof(int32_t);
  const T* xp = static_cast<const T*>(x);
  const float* Wp = static_cast<const float*>(W);
  const int32_t* gp = static_cast<const int32_t*>(gates);
  T* op = static_cast<T*>(out);
  if (imp != nullptr) {
    merge_all_kernel<T, NMAX, true><<<blocks, kThreads, smem, stream>>>(
        xp, static_cast<const float*>(imp), Wp, gp, op, n, d);
  } else {
    merge_all_kernel<T, NMAX, false><<<blocks, kThreads, smem, stream>>>(
        xp, nullptr, Wp, gp, op, n, d);
  }
}

template <typename T>
int dispatch(const void* x, const void* imp, const void* W, const void* gates,
             void* out, int n, int64_t d, cudaStream_t stream) {
  if (n <= 4) {
    launch<T, 4>(x, imp, W, gates, out, n, d, stream);
  } else if (n <= 8) {
    launch<T, 8>(x, imp, W, gates, out, n, d, stream);
  } else if (n <= 16) {
    launch<T, 16>(x, imp, W, gates, out, n, d, stream);
  } else if (n <= 32) {
    launch<T, 32>(x, imp, W, gates, out, n, d, stream);
  } else {
    launch<T, 64>(x, imp, W, gates, out, n, d, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_one_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const int32_t* __restrict__ gate_self, int gate_value,
                 int self_value, T* __restrict__ out, int n, int64_t d) {
  __shared__ float sw[64];
  for (int k = threadIdx.x; k < n; k += blockDim.x) sw[k] = w[k];
  __syncthreads();
  const bool gate = (gate_self != nullptr ? gate_self[0] : gate_value) != 0;
  const int64_t self_row = gate_self != nullptr ? gate_self[1] : self_value;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       col < d; col += stride) {
    if (gate) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j)
        acc = __fadd_rn(acc, __fmul_rn(sw[j],
                                       to_f32(x[static_cast<int64_t>(j) * d +
                                                col])));
      out[col] = from_f32(acc, T());
    } else {
      out[col] = x[self_row * d + col];
    }
  }
}

template <typename T>
int launch_one(const void* x, const void* w, const void* gate_self,
               int gate, int self_idx, void* out, int n, int64_t d,
               cudaStream_t stream) {
  const int64_t want = (d + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 2147483647 ? want
                                                                  : 2147483647);
  merge_one_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const int32_t*>(gate_self), gate, self_idx,
      static_cast<T*>(out), n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes) of the one-node commit. x: [n, d]
// row-major, f32 (dtype 0) or bf16 (dtype 1); w: [n] f32; gate_self: [2]
// int32 on the device, (gate, self_idx), read by the kernel, or null, and
// then `gate` and `self_idx` are taken by value; out: [d]. Launches on
// `stream`, does not synchronize, and returns cudaGetLastError() (0 on
// success).
extern "C" int fused_merge_launch(const void* x, const void* w,
                                  const void* gate_self, int gate,
                                  int self_idx, void* out, int n,
                                  long long d, int dtype, void* stream) {
  if (n < 1 || n > 64 || d < 1 ||
      (gate_self == nullptr && (self_idx < 0 || self_idx >= n)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_one<float>(x, w, gate_self, gate, self_idx, out, n, d, s);
  if (dtype == 1)
    return launch_one<__nv_bfloat16>(x, w, gate_self, gate, self_idx, out, n,
                                     d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Plain C entry point (bound with ctypes). x/out: [n, d] row-major, f32
// (dtype 0) or bf16 (dtype 1); imp: [n, d] f32 or null; W: [n, n] f32;
// gates: [n] int32. Launches on `stream`, does not synchronize, and returns
// cudaGetLastError() (0 on success).
extern "C" int fused_merge_all_launch(const void* x, const void* imp,
                                      const void* W, const void* gates,
                                      void* out, int n, long long d,
                                      int dtype, void* stream) {
  if (n < 1 || n > 64 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, imp, W, gates, out, n, d, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, imp, W, gates, out, n, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
