// Mamba-2 chunked SSD scan (state-space duality) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py `ssd_scan`
// (body `_ssd_kernel`). Inputs: x [B,S,H,P], dt [B,S,H] f32 (softplus'd),
// a_log [H] f32, B/C [B,S,G,N] with H % G == 0 (head h reads group
// h / (H/G); G = H is the reference's pre-broadcast form). Per chunk of L
// steps, in f32, with a = -exp(a_log[h]):
//
//   cum   = cumsum(dt * a)
//   y     = (C B^T (.) Lmat)(x dt) + (C (.) e^cum) state,
//           Lmat[i,j] = e^(cum_i - cum_j) for i >= j, else 0
//   state <- e^(cum_L) state + (B (.) e^(cum_L - cum))^T (x dt)
//
// y is written in x's dtype, the final state [B,H,P,N] in f32.
//
// Bound: the operations. Per head and chunk the quadratic part does about
// L*L*(N + P) multiply-adds (half of them masked away) and the state parts
// 2*L*N*P, against L*(P + 2N) input values: tens of flops per byte at
// Hymba's N = 16, P = 64, L = 256 and more at Mamba2's N = 128, so the
// f32 rate bounds it; this kernel runs them on the CUDA cores.
//
// Design: one block of 1024 threads per (head, batch). The TPU's sequential
// chunk axis becomes a loop inside the block, and the [N, P] state stays in
// f32 shared memory across chunks (4 KB at Hymba, 32 KB at Mamba2's
// N = 128). The [L, L] decay-masked tile would be 256 KB in f32 at L = 256,
// more than a block's 227 KB, so it is computed in strips of 32 query rows
// against tiles of 32 key rows, only up to the diagonal; exp(cum_i - cum_j)
// is taken only where i >= j, where it is <= 1 (above the diagonal it
// would overflow). Each thread keeps its share of a strip's y in registers.
// The chunk's cumsum is a warp-shuffle scan. B/C are read per group, by
// index, so a broadcast from one group to H heads costs no copy. Rows of B
// and C in shared memory are padded to N + 1 floats (conflict-free column
// reads). Parallelism is one block per (batch, head): 50 blocks on 132 SMs
// at Hymba's shape, accepted here; each block has 32 warps, so that one
// block per SM still hides the latency of its shared-memory and global
// loads. Splitting a chunk's strips across blocks (the chunk-end states
// first, then every strip in parallel) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // 32 warps: one block per SM hides latency
constexpr int RS = 32;    // query rows per strip
constexpr int TJ = 32;    // key rows per tile
constexpr int MAXP = 128;
constexpr int MAXN = 256;
constexpr int MAXL = 256;
constexpr int YREG = RS * MAXP / kThreads;  // y values a thread keeps

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* bm;
  const void* cm;
  void* y;
  float* state;
  int S, H, P, G, N, L;
  long long xb, xs;  // x strides (batch, seq); (head, p) contiguous
  long long bb, bs;  // B strides (batch, seq); (group, n) contiguous
  long long cb, cs;  // C strides (batch, seq); (group, n) contiguous
};

size_t smem_floats(int N, int P, int L) {
  return static_cast<size_t>(N) * P + 2 * L + (RS + TJ) * (N + 1) +
         TJ * P + RS * (TJ + 1) + kThreads / 32;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(SsdArgs a) {
  extern __shared__ float sm[];
  const int P = a.P, N = a.N, L = a.L, NP1 = a.N + 1;
  float* st = sm;                     // [N][P] state
  float* cum = st + N * P;            // [L]
  float* dtv = cum + L;               // [L]
  float* sC = dtv + L;                // [RS][NP1]
  float* sB = sC + RS * NP1;          // [TJ][NP1]
  float* sX = sB + TJ * NP1;          // [TJ][P]  x * dt
  float* sS = sX + TJ * P;            // [RS][TJ + 1] masked scores
  float* wsum = sS + RS * (TJ + 1);   // [kThreads / 32] scan partials

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const float A = -expf(a.a_log[h]);
  const T* x = static_cast<const T*>(a.x) + b * a.xb +
               static_cast<long long>(h) * P;
  const T* bm = static_cast<const T*>(a.bm) + b * a.bb +
                static_cast<long long>(g) * N;
  const T* cm = static_cast<const T*>(a.cm) + b * a.cb +
                static_cast<long long>(g) * N;
  const float* dt = a.dt + static_cast<long long>(b) * a.S * a.H + h;
  const long long yrow = static_cast<long long>(a.H) * P;
  T* y = static_cast<T*>(a.y) + static_cast<long long>(b) * a.S * yrow +
         static_cast<long long>(h) * P;

  for (int e = tid; e < N * P; e += kThreads) st[e] = 0.f;

  const int n_chunks = a.S / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    __syncthreads();  // the previous chunk's readers of cum/dtv/st are done

    // cum = inclusive cumsum of dt * a over the chunk (warp scans + partials)
    float val = 0.f;
    if (tid < L) {
      const float d = dt[static_cast<long long>(t0 + tid) * a.H];
      dtv[tid] = d;
      val = d * A;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, val, off);
      if (lane >= off) val += u;
    }
    if (lane == 31) wsum[warp] = val;
    __syncthreads();
    if (tid < L) {
      float pre = 0.f;
      for (int w = 0; w < warp; ++w) pre += wsum[w];
      cum[tid] = val + pre;
    }
    __syncthreads();
    const float cum_last = cum[L - 1];

    // y, in strips of RS query rows
    for (int i0 = 0; i0 < L; i0 += RS) {
      const int rows = min(RS, L - i0);
      for (int e = tid; e < RS * N; e += kThreads) {
        const int r = e / N, n = e % N;
        sC[r * NP1 + n] =
            r < rows ? to_f32(cm[static_cast<long long>(t0 + i0 + r) * a.cs +
                                 n])
                     : 0.f;
      }
      __syncthreads();
      // inter-chunk part: e^cum_i * sum_n C[i,n] state[n,p]
      float yacc[YREG];
#pragma unroll
      for (int k = 0; k < YREG; ++k) {
        const int e = tid + k * kThreads;
        yacc[k] = 0.f;
        if (e < RS * P) {
          const int r = e / P, p = e % P;
          if (r < rows) {
            float s = 0.f;
            for (int n = 0; n < N; ++n) s += sC[r * NP1 + n] * st[n * P + p];
            yacc[k] = s * expf(cum[i0 + r]);
          }
        }
      }
      // intra-chunk part over key tiles up to the diagonal
      const int j_end = i0 + rows;
      for (int j0 = 0; j0 < j_end; j0 += TJ) {
        const int cols = min(TJ, j_end - j0);
        __syncthreads();  // the previous tile's sB/sX/sS are consumed
        for (int e = tid; e < TJ * N; e += kThreads) {
          const int cc = e / N, n = e % N;
          sB[cc * NP1 + n] =
              cc < cols
                  ? to_f32(bm[static_cast<long long>(t0 + j0 + cc) * a.bs + n])
                  : 0.f;
        }
        for (int e = tid; e < TJ * P; e += kThreads) {
          const int cc = e / P, p = e % P;
          sX[cc * P + p] =
              cc < cols
                  ? to_f32(x[static_cast<long long>(t0 + j0 + cc) * a.xs + p]) *
                        dtv[j0 + cc]
                  : 0.f;
        }
        __syncthreads();
        for (int e = tid; e < RS * TJ; e += kThreads) {
          const int r = e / TJ, cc = e % TJ;
          const int i = i0 + r, j = j0 + cc;
          float sc = 0.f;
          if (r < rows && cc < cols && j <= i) {
            float dot = 0.f;
            for (int n = 0; n < N; ++n) dot += sC[r * NP1 + n] * sB[cc * NP1 + n];
            sc = dot * expf(cum[i] - cum[j]);  // i >= j: the exponent is <= 0
          }
          sS[r * (TJ + 1) + cc] = sc;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < YREG; ++k) {
          const int e = tid + k * kThreads;
          if (e < RS * P) {
            const int r = e / P, p = e % P;
            float s = 0.f;
            for (int cc = 0; cc < cols; ++cc)
              s += sS[r * (TJ + 1) + cc] * sX[cc * P + p];
            yacc[k] += s;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < YREG; ++k) {
        const int e = tid + k * kThreads;
        if (e < RS * P) {
          const int r = e / P, p = e % P;
          if (r < rows)
            store(y + static_cast<long long>(t0 + i0 + r) * yrow + p, yacc[k]);
        }
      }
      __syncthreads();  // sC is rewritten by the next strip
    }

    // state <- e^cum_L state + sum_j B_j e^(cum_L - cum_j) (x dt)_j
    const float e_last = expf(cum_last);
    for (int e = tid; e < N * P; e += kThreads) st[e] *= e_last;
    for (int j0 = 0; j0 < L; j0 += TJ) {
      const int cols = min(TJ, L - j0);
      __syncthreads();
      for (int e = tid; e < TJ * N; e += kThreads) {
        const int cc = e / N, n = e % N;
        sB[cc * NP1 + n] =
            cc < cols
                ? to_f32(bm[static_cast<long long>(t0 + j0 + cc) * a.bs + n]) *
                      expf(cum_last - cum[j0 + cc])
                : 0.f;
      }
      for (int e = tid; e < TJ * P; e += kThreads) {
        const int cc = e / P, p = e % P;
        sX[cc * P + p] =
            cc < cols
                ? to_f32(x[static_cast<long long>(t0 + j0 + cc) * a.xs + p]) *
                      dtv[j0 + cc]
                : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < N * P; e += kThreads) {
        const int n = e / P, p = e % P;
        float s = 0.f;
        for (int cc = 0; cc < cols; ++cc) s += sB[cc * NP1 + n] * sX[cc * P + p];
        st[e] += s;
      }
    }
  }
  __syncthreads();
  // final state, [P, N] per (batch, head)
  float* out = a.state + (static_cast<long long>(b) * a.H + h) * P * N;
  for (int e = tid; e < N * P; e += kThreads) {
    const int p = e / N, n = e % N;
    out[e] = st[n * P + p];
  }
}

template <typename T>
int launch(const SsdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = smem_floats(a.N, a.P, a.L) * sizeof(float);
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const dim3 grid(a.H, B);
  ssd_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). x, B, C and y in f32 (dtype 0) or
// bf16 (dtype 1); dt [B,S,H] and a_log [H] f32, contiguous; y [B,S,H,P] and
// state [B,H,P,N] contiguous outputs; strides[6] = (batch, seq) strides of
// x, B and C in elements, their last two dims contiguous. S % L == 0,
// H % G == 0, P <= 128, N <= 256, L <= 256. Launches on `stream`, does not
// synchronize, and returns cudaGetLastError() (0 on success).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a_log,
                               const void* bm, const void* cm, void* y,
                               void* state, int B, int S, int H, int P, int G,
                               int N, int L, const long long* strides,
                               int dtype, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 ||
      P > MAXP || N < 1 || N > MAXN || L < 1 || L > MAXL || S % L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SsdArgs a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.a_log = static_cast<const float*>(a_log);
  a.bm = bm;
  a.cm = cm;
  a.y = y;
  a.state = static_cast<float*>(state);
  a.S = S;
  a.H = H;
  a.P = P;
  a.G = G;
  a.N = N;
  a.L = L;
  a.xb = strides[0];
  a.xs = strides[1];
  a.bb = strides[2];
  a.bs = strides[3];
  a.cb = strides[4];
  a.cs = strides[5];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
