// Flash attention (GQA, causal, sliding window) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// `flash_attention` (body `_flash_kernel`): q [B,H,S,D], k/v [B,Hkv,T,D],
// query head h reads KV head h / (H/Hkv);
//
//   out = softmax(q k^T / sqrt(D) masked) v,
//   mask = kpos <= qpos  and, where window > 0, kpos > qpos - window
//
// (no mask without `causal`; the wrapper refuses a window without it), with
// the online softmax state m, l and acc in f32 and the output
// acc / max(l, 1e-30) in q's dtype. Masked scores are -1e30, as in the TPU
// kernel; keys past T (the ragged edge) weigh exactly 0.
//
// Bound: the operations. One causal S x S prefill does about
// 4*H*D*S*S/2 flops against (2*H + 2*Hkv)*S*D elements moved, hundreds of
// flops per byte, so the tensor cores' rate is the bound; a sliding window
// cuts the flops to about 4*H*D*S*window. The TPU kernel gets there by
// skipping fully masked tiles, and so does this one: a key tile is skipped
// wherever the TPU kernel's `live` predicate is false (kv tile wholly in the
// future of the q tile, or wholly older than the window), so the work is
// the mask's, not T's. This first kernel runs the products on the f32 CUDA
// cores, not the tensor cores: it is simple and right, not fast.
//
// Design: one block of 256 threads per (q tile of 64 rows, query head,
// batch). The TPU tile [G, bq, D] in f32 (all G heads of a KV group, bq =
// 128) would be 160 KB at Hymba's G = 5, D = 64, over the static shared
// memory limit, so each block serves one query head and streams K/V tiles
// of 64 keys through shared memory (sharing a K/V tile across the group's
// heads is later work). Each thread owns a 4 x 4 micro-tile of the 64 x 64
// score tile (rows 4*ty.., columns tx + 16*j) and the same 4 rows of the
// output (columns tx + 16*j); the 16 threads that share a row reduce its
// max and sum with warp shuffles. Shared rows are padded to D + 1 floats so
// that the column reads of K are free of bank conflicts. Inputs are read
// through (batch, head, seq) strides with a contiguous D, so a K/V cache in
// [B, T, Hkv, D] layout and a q in [B, S, H, D] layout pass as views, and
// the output is written through strides too. Ragged edges in S and T are
// masked, not padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Hkv, S, T;
  long long qs[3], ks[3], vs[3], os[3];  // batch, head, seq strides
  int causal, window;
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(BQ + 2 * BK) * (D + 1) +
          static_cast<size_t>(BQ) * (BK + 1)) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(FlashArgs a) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;  // output columns per thread
  constexpr int PP = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;            // [BQ][DP]
  float* sK = sQ + BQ * DP;    // [BK][DP]
  float* sV = sK + BK * DP;    // [BK][DP]
  float* sP = sV + BK * DP;    // [BQ][PP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  T* o = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int qp = q0 + r;
    sQ[r * DP + d] = qp < a.S ? to_f32(q[qp * a.qs[2] + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (a.T + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    // the TPU kernel's tile-level skip (block-uniform)
    bool live = true;
    if (a.causal) live = k0 <= q0 + BQ - 1;
    if (a.window > 0) live = live && (k0 + BK - 1 > q0 - a.window);
    if (!live) continue;

    __syncthreads();  // the previous tile's sK/sV/sP are consumed
    for (int e = tid; e < BK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const int kp = k0 + c;
      const bool in = kp < a.T;
      sK[c * DP + d] = in ? to_f32(k[kp * a.ks[2] + d]) : 0.f;
      sV[c * DP + d] = in ? to_f32(v[kp * a.vs[2] + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float val = s[i][j] * a.scale;
        if (a.causal) {
          bool keep = kp <= qp;
          if (a.window > 0) keep = keep && (kp > qp - a.window);
          if (!keep) val = kNegInf;
        }
        if (kp >= a.T) val = -INFINITY;  // past the ragged edge: weight 0
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(s[i][j] - m_new);
        sP[(ty * 4 + i) * PP + tx + 16 * j] = pj;
        rs += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();  // sP complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) vv[jj] = sV[c * DP + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DC; ++jj)
          acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= a.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      store(o + qp * a.os[2] + tx + 16 * jj, acc[i][jj] / den);
  }
}

template <typename T, int D>
int launch(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const FlashArgs& a, int B, int D, cudaStream_t stream) {
  if (D == 32) return launch<T, 32>(a, B, stream);
  if (D == 64) return launch<T, 64>(a, B, stream);
  if (D == 128) return launch<T, 128>(a, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (bound with ctypes). q/k/v/o in f32 (dtype 0) or bf16
// (dtype 1); strides[12] = q, k, v, o strides in elements, each as (batch,
// head, seq), the last dim contiguous. D in {32, 64, 128}; H % Hkv == 0.
// Launches on `stream`, does not synchronize, and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int S, int T, int D,
                                      const long long* strides, int causal,
                                      int window, float scale, int dtype,
                                      void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || S < 1 || T < 1 ||
      B > 65535 || H > 65535 || (!causal && window > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.H = H;
  a.Hkv = Hkv;
  a.S = S;
  a.T = T;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
