// Fused quantized-wire swarm commit for Hopper (sm_90a): the error-feedback
// wire advance, the merge and the gate over the flat [N, P] state in one
// launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_merge.py
// `fused_quant_merge_all` — body `_quant_merge_kernel` (W-row form,
// mean/fedavg commit) and `_quant_merge_imp_kernel` (importance-weighted
// form, fisher/gradmatch/topology-restricted commit):
//
//   v      = x - r                                    (per node row)
//   r'     = r + deq(q(v))   int8: per block of the wire grid,
//                              scale = max|v|/127, q = clip(rint(v/scale), ±127)
//                            bf16: v rounded to bf16 and back
//                            f32:  v itself
//   out[i] = gate[i] ? sum_j W[i,j] * r'[j]                          : x[i]
//   out[i] = gate[i] ? sum_j (W[i,j]*f[j]) * r'[j] / max(sum_j W[i,j]*f[j], 1e-30)
//                                                                     : x[i]
//
// Bound: memory. Per column it does O(N*N) flops for 2*N*4 bytes in (3*N*4
// with imp) and 2*N*4 bytes out; the least traffic is 4*N*P*4 bytes
// (5*N*P*4 with imp), far above the flops at N <= 64.
//
// Design: one thread block per segment of the wire grid (a block of the
// reference's per-leaf quantization grid, <= wire_block elements). The
// segment's stored indices are perm[start .. start+len) (or the contiguous
// range start .. start+len when perm is null: leaves stored in the
// reference's element order). For int8 a first pass reduces every row's
// max |x - r| over the segment (per-thread maxima in registers, then warp
// shuffles and shared memory) into per-row scales in shared memory. The
// second pass gives each thread columns of the segment: it computes the N
// rows of r' into registers, stores them, and produces the N committed rows
// from them. W and the gates are staged in shared memory. Every rounding is
// explicit (__fsub_rn, __fdiv_rn, rintf, __fmul_rn, __fadd_rn) so nvcc
// contracts nothing into an FMA: r' equals the plain version
// (core/comms.py::wire_effective) bit for bit, and the merge accumulates in
// j order as kernels/ref.py does. A rejected row stores x itself, loaded
// again from memory. N is a template bound (4..64) so the per-column arrays
// stay in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kF32 = 0, kBF16 = 1, kInt8 = 2;

template <int NMAX, int WIRE, bool HAS_IMP>
__global__ void __launch_bounds__(kThreads)
quant_merge_kernel(const float* __restrict__ x, const float* __restrict__ r,
                   const float* __restrict__ imp, const float* __restrict__ W,
                   const int32_t* __restrict__ gates,
                   const int64_t* __restrict__ segments,
                   const int64_t* __restrict__ perm, float* __restrict__ out,
                   float* __restrict__ rout, int n, int64_t d) {
  extern __shared__ float smem[];
  float* sW = smem;                                   // [n, n]
  float* sscale = sW + n * n;                         // [n]
  float* sred = sscale + n;                           // [kWarps, n]
  int32_t* sg = reinterpret_cast<int32_t*>(sred + kWarps * n);  // [n]
  for (int k = threadIdx.x; k < n * n; k += kThreads) sW[k] = W[k];
  for (int k = threadIdx.x; k < n; k += kThreads) sg[k] = gates[k];
  const int64_t start = segments[2 * static_cast<int64_t>(blockIdx.x)];
  const int len = static_cast<int>(
      segments[2 * static_cast<int64_t>(blockIdx.x) + 1]);

  if constexpr (WIRE == kInt8) {
    float m[NMAX];
#pragma unroll
    for (int j = 0; j < NMAX; ++j) m[j] = 0.f;
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const int64_t c = perm != nullptr ? perm[start + t] : start + t;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          const int64_t at = static_cast<int64_t>(j) * d + c;
          m[j] = fmaxf(m[j], fabsf(__fsub_rn(x[at], r[at])));
        }
      }
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j < n) {
        float v = m[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
        if (lane == 0) sred[warp * n + j] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < n) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v = fmaxf(v, sred[w * n + threadIdx.x]);
      sscale[threadIdx.x] = __fdiv_rn(v, 127.0f);
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < len; t += kThreads) {
    const int64_t c = perm != nullptr ? perm[start + t] : start + t;
    float rp[NMAX];
    float fv[HAS_IMP ? NMAX : 1];
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j < n) {
        const int64_t at = static_cast<int64_t>(j) * d + c;
        const float rv = r[at];
        const float v = __fsub_rn(x[at], rv);
        float deq;
        if constexpr (WIRE == kInt8) {
          const float s = sscale[j];
          const float q = fminf(
              fmaxf(rintf(__fdiv_rn(v, s > 0.f ? s : 1.0f)), -127.f), 127.f);
          deq = __fmul_rn(q, s);
        } else if constexpr (WIRE == kBF16) {
          deq = __bfloat162float(__float2bfloat16_rn(v));
        } else {
          deq = v;
        }
        rp[j] = __fadd_rn(rv, deq);
        rout[at] = rp[j];
        if constexpr (HAS_IMP) fv[j] = imp[at];
      }
    }
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int64_t at = static_cast<int64_t>(i) * d + c;
      if (sg[i] == 0) {
        out[at] = x[at];
        continue;
      }
      const float* wi = sW + i * n;
      float num = 0.f;
      float den = 0.f;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          if constexpr (HAS_IMP) {
            const float wf = __fmul_rn(wi[j], fv[j]);
            num = __fadd_rn(num, __fmul_rn(wf, rp[j]));
            den = __fadd_rn(den, wf);
          } else {
            num = __fadd_rn(num, __fmul_rn(wi[j], rp[j]));
          }
        }
      }
      if constexpr (HAS_IMP) num = __fdiv_rn(num, fmaxf(den, 1e-30f));
      out[at] = num;
    }
  }
}

template <int NMAX, int WIRE>
void launch(const float* x, const float* r, const float* imp, const float* W,
            const int32_t* gates, const int64_t* segments,
            const int64_t* perm, float* out, float* rout, unsigned blocks,
            int n, int64_t d, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n) * n * sizeof(float) +
                      static_cast<size_t>(n) * sizeof(float) +
                      static_cast<size_t>(kWarps) * n * sizeof(float) +
                      static_cast<size_t>(n) * sizeof(int32_t);
  if (imp != nullptr) {
    quant_merge_kernel<NMAX, WIRE, true><<<blocks, kThreads, smem, stream>>>(
        x, r, imp, W, gates, segments, perm, out, rout, n, d);
  } else {
    quant_merge_kernel<NMAX, WIRE, false><<<blocks, kThreads, smem, stream>>>(
        x, r, nullptr, W, gates, segments, perm, out, rout, n, d);
  }
}

template <int WIRE>
void dispatch(const float* x, const float* r, const float* imp,
              const float* W, const int32_t* gates, const int64_t* segments,
              const int64_t* perm, float* out, float* rout, unsigned blocks,
              int n, int64_t d, cudaStream_t s) {
  if (n <= 4) {
    launch<4, WIRE>(x, r, imp, W, gates, segments, perm, out, rout, blocks, n, d, s);
  } else if (n <= 8) {
    launch<8, WIRE>(x, r, imp, W, gates, segments, perm, out, rout, blocks, n, d, s);
  } else if (n <= 16) {
    launch<16, WIRE>(x, r, imp, W, gates, segments, perm, out, rout, blocks, n, d, s);
  } else if (n <= 32) {
    launch<32, WIRE>(x, r, imp, W, gates, segments, perm, out, rout, blocks, n, d, s);
  } else {
    launch<64, WIRE>(x, r, imp, W, gates, segments, perm, out, rout, blocks, n, d, s);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). x, r, out, new_ref: [n, d] f32
// row-major; imp: [n, d] f32 or null; W: [n, n] f32; gates: [n] int32;
// segments: [n_segments, 2] int64 (start, length) into perm, or into the
// buffer when perm is null; perm: [d] int64 or null; wire: 0 f32, 1 bf16,
// 2 int8. Launches on `stream`, does not synchronize, and returns
// cudaGetLastError() (0 on success).
extern "C" int fused_quant_merge_all_launch(
    const void* x, const void* r, const void* imp, const void* W,
    const void* gates, const void* segments, const void* perm, void* out,
    void* new_ref, long long n_segments, int n, long long d, int wire,
    void* stream) {
  if (n < 1 || n > 64 || d < 1 || n_segments < 1 ||
      n_segments > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(n_segments);
  const float* xp = static_cast<const float*>(x);
  const float* rp = static_cast<const float*>(r);
  const float* fp = static_cast<const float*>(imp);
  const float* Wp = static_cast<const float*>(W);
  const int32_t* gp = static_cast<const int32_t*>(gates);
  const int64_t* sp = static_cast<const int64_t*>(segments);
  const int64_t* pp = static_cast<const int64_t*>(perm);
  float* op = static_cast<float*>(out);
  float* rop = static_cast<float*>(new_ref);
  if (wire == kF32) {
    dispatch<kF32>(xp, rp, fp, Wp, gp, sp, pp, op, rop, blocks, n, d, s);
  } else if (wire == kBF16) {
    dispatch<kBF16>(xp, rp, fp, Wp, gp, sp, pp, op, rop, blocks, n, d, s);
  } else if (wire == kInt8) {
    dispatch<kInt8>(xp, rp, fp, Wp, gp, sp, pp, op, rop, blocks, n, d, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
