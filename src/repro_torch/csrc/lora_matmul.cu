// Fused base + LoRA matmul for Hopper (sm_90a):
//
//   y = x @ W + scale * ((x @ A) rounded to x's dtype) @ B
//   x [M, K], W [K, N], A [K, r], B [r, N], scale a device scalar (f32)
//
// Replaces the Pallas TPU kernel src/repro/kernels/lora_matmul.py:26
// `_lora_kernel` (wrapper `lora_matmul`, :51), which the shared head of the
// heterogeneous model zoo (src/repro/models/zoo.py `head_forward`) runs on
// every forward. Like it, the kernel keeps both low-rank intermediates on
// chip: x@A never goes to device memory, and the output is written once, in
// x's dtype, from f32 accumulators.
//
// Bound. 2*M*N*K + 2*M*K*r + 2*M*r*N f32 operations against
// (M*K + K*N + K*r + r*N + M*N) * sizeof(T) bytes. At the zoo head's shapes
// (M 8-160, K = N = 16, r = 4) that is at most 0.2 MFLOP and 13 kB: the
// bound is a few nanoseconds, and the launch and one round trip to memory
// are the whole time. At the reference's sweep shape (M, K, N, r) =
// (128, 1024, 256, 64) f32 it is 88.1 MFLOP (1.31 us at 67 TFLOP/s) against
// 2.03 MB (0.61 us at 3.35 TB/s): bound by the operations.
//
// The entry point picks one of two bodies by shape.
//
// Small body (K <= 16, r <= 4, N <= 32: the zoo head). Latency first: one
// block of 128 threads per 128/N * 4 rows; a thread owns one column and up to
// four rows. It issues every load it needs (scale, its column of W and B, all
// of A, its rows of x) before the first multiply, so the kernel makes one
// round trip to memory, and then forms x@W, x@A (in registers, no shared
// memory, no barrier), rounds x@A to x's dtype and stores once.
//
// Large body (any other shape). A cluster of C <= 8 thread blocks owns one
// tile of 32 rows; block c computes the 32 x 64 output tiles c, c + C, ... of
// those rows (2 x 4 outputs a thread, f32 FFMA; TF32 would miss the
// reference's 2e-5) while its K loop stages x, W and A tiles in shared
// memory (loaded into registers one K step ahead of the products that read
// them). x@A is computed once per row tile: block c computes the columns
// [c*rc, (c+1)*rc) of it (rc = ceil(r / C)) over all of K during its first
// output tile, the blocks exchange their columns through distributed shared
// memory, and every block rounds the whole x@A to x's dtype and adds
// scale * xa @ B to each of its tiles. For bf16 inputs the base product runs
// on the tensor cores (mma.sync m16n8k16, bf16 operands from shared memory,
// f32 accumulators: each warp a 16 x 16 piece of the tile); x@A and the
// low-rank product stay f32 FFMA.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kRMax = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float from_f32(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------- small body
constexpr int kSThreads = 128;
constexpr int kSK = 16;     // K bound
constexpr int kSR = 4;      // r bound
constexpr int kSN = 32;     // N bound
constexpr int kSRows = 4;   // rows a thread

template <typename T>
__global__ void __launch_bounds__(kSThreads, 2)   // 2: measured faster
lora_small_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ scale, T* __restrict__ y, int m,
                  int k, int n, int r) {
  const int groups = kSThreads / n;
  const int j = threadIdx.x % n;
  const int g = threadIdx.x / n;
  if (g >= groups) return;
  const int row0 = blockIdx.x * groups * kSRows + g;
  // every load first: one round trip to memory
  const float s = *scale;
  float wc[kSK], ac[kSK][kSR], bc[kSR], xr[kSRows][kSK];
#pragma unroll
  for (int kk = 0; kk < kSK; ++kk) {
    wc[kk] = kk < k ? to_f32(w[kk * n + j]) : 0.f;
#pragma unroll
    for (int q = 0; q < kSR; ++q)
      ac[kk][q] = (kk < k && q < r) ? to_f32(a[kk * r + q]) : 0.f;
  }
#pragma unroll
  for (int q = 0; q < kSR; ++q) bc[q] = q < r ? to_f32(b[q * n + j]) : 0.f;
#pragma unroll
  for (int u = 0; u < kSRows; ++u) {
    const int i = row0 + u * groups;
#pragma unroll
    for (int kk = 0; kk < kSK; ++kk)
      xr[u][kk] = (i < m && kk < k)
                      ? to_f32(x[static_cast<int64_t>(i) * k + kk]) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kSRows; ++u) {
    const int i = row0 + u * groups;
    if (i >= m) break;
    float acc = 0.f;
    float xa[kSR];
#pragma unroll
    for (int q = 0; q < kSR; ++q) xa[q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSK; ++kk) {
      acc = fmaf(xr[u][kk], wc[kk], acc);
#pragma unroll
      for (int q = 0; q < kSR; ++q) xa[q] = fmaf(xr[u][kk], ac[kk][q], xa[q]);
    }
    // the TPU kernel rounds xa to the input dtype before its last dot
    float low = 0.f;
#pragma unroll
    for (int q = 0; q < kSR; ++q) low = fmaf(round_to(xa[q], T()), bc[q], low);
    store(y + static_cast<int64_t>(i) * n + j,
          __fadd_rn(acc, __fmul_rn(s, low)));
  }
}

// ---------------------------------------------------------------- large body
constexpr int kLThreads = 256;
constexpr int kBM = 32;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kMaxCluster = 8;
constexpr int kPadB = 8;    // bf16 row padding: fragment loads conflict-free

template <typename T>
constexpr bool kIsBF16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2,
                                         float& d3, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kXL = kBM * kBK / kLThreads;   // x tile values a thread loads
constexpr int kWL = kBK * kBN / kLThreads;   // W tile values
constexpr int kAL = kBK * kRMax / kLThreads; // A tile (and B) values

// The K step at k0: this thread's values of the x [32, 32] and W [32, 64]
// tiles and, for qn > 0, of A's columns q0 .. q0 + qn, into registers, every
// load issued before any is used (zero outside the matrices).
template <typename T>
__device__ __forceinline__ void load_tiles(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ a,
    T (&xreg)[kXL], T (&wreg)[kWL], float (&areg)[kAL], int tid, int row0,
    int col0, int k0, int m, int k, int n, int r, int q0, int qn) {
  const T zero = from_f32(0.f, T());
#pragma unroll
  for (int u = 0; u < kXL; ++u) {
    const int e = tid + u * kLThreads;
    const int gi = row0 + e / kBK, gk = k0 + e % kBK;
    xreg[u] = (gi < m && gk < k) ? x[static_cast<int64_t>(gi) * k + gk] : zero;
  }
#pragma unroll
  for (int u = 0; u < kWL; ++u) {
    const int e = tid + u * kLThreads;
    const int gk = k0 + e / kBN, gj = col0 + e % kBN;
    wreg[u] = (gk < k && gj < n) ? w[static_cast<int64_t>(gk) * n + gj] : zero;
  }
#pragma unroll
  for (int u = 0; u < kAL; ++u) {
    const int e = tid + u * kLThreads;
    if (e < kBK * qn) {
      const int gk = k0 + e / qn;
      areg[u] = gk < k ? to_f32(a[static_cast<int64_t>(gk) * r + q0 + e % qn])
                       : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kLThreads)
lora_large_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ scale, T* __restrict__ y, int m,
                  int k, int n, int r) {
  // f32: x [row][k] and W [k][col] tiles as f32, products on FFMA (TF32
  // would miss the reference's 2e-5). bf16: x [row][k] and W transposed
  // [col][k] as bf16, the base product on mma.sync with f32 accumulators.
  constexpr bool kMma = kIsBF16<T>;
  __shared__ float sx[kMma ? 1 : kBM][kBK + 1];
  __shared__ __align__(16) float sw[kMma ? 1 : kBK][kBN];
  __shared__ __align__(16) __nv_bfloat16 sxb[kMma ? kBM : 1][kBK + kPadB];
  __shared__ __align__(16) __nv_bfloat16 swb[kMma ? kBN : 1][kBK + kPadB];
  __shared__ float sa[kBK * kRMax];  // A tile [k][rc]; then xa part [row][rc]
  __shared__ float sxa[kBM][kRMax];           // the whole xa, rounded

  cg::cluster_group cl = cg::this_cluster();
  const int nc = static_cast<int>(cl.num_blocks());
  const int c = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kBM;
  const int ctiles = (n + kBN - 1) / kBN;
  // this block's columns of xa
  const int rc = (r + nc - 1) / nc;
  const int q0 = c * rc;
  const int qn = max(0, min(r, q0 + rc) - q0);
  // FFMA outputs: rows 2*ty + (t / 4), columns 4*tx + (t % 4) of the tile
  const int ty = tid / 16, tx = tid % 16;
  // mma outputs: warp (wr, wc) owns rows 16*wr.., columns 16*wc..; a lane
  // holds rows gid, gid + 8 and columns 2*tig, 2*tig + 1 of two n8 tiles
  const int lane = tid & 31, warp = tid >> 5;
  const int wr = warp / 4, wc = warp % 4, gid = lane >> 2, tig = lane & 3;
  // xa part: row tid % 32, columns tid / 32 + 8 * u
  const int xrow = tid % kBM, xcol = tid / kBM;
  constexpr int kXaPer = kRMax / (kLThreads / kBM);   // 16
  const float s = *scale;

  // each thread's share of a K step's x, W and A tiles, loaded into
  // registers one step ahead of the products that read them
  T xreg[kXL], wreg[kWL];
  float areg[kAL];

  for (int ct = c; ct < ctiles; ct += nc) {
    const bool first = ct == c;
    const int col0 = ct * kBN;
    float acc[8] = {};
    float xa[kXaPer] = {};
    load_tiles(x, w, a, xreg, wreg, areg, tid, row0, col0, 0, m, k, n, r, q0,
               first ? qn : 0);
    for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
      for (int u = 0; u < kXL; ++u) {
        const int e = tid + u * kLThreads;
        if constexpr (kMma) sxb[e / kBK][e % kBK] = xreg[u];
        else sx[e / kBK][e % kBK] = to_f32(xreg[u]);
      }
#pragma unroll
      for (int u = 0; u < kWL; ++u) {
        const int e = tid + u * kLThreads;
        if constexpr (kMma) swb[e % kBN][e / kBN] = wreg[u];
        else sw[e / kBN][e % kBN] = to_f32(wreg[u]);
      }
      if (first) {
#pragma unroll
        for (int u = 0; u < kAL; ++u) {
          const int e = tid + u * kLThreads;
          if (e < kBK * qn) sa[e] = areg[u];
        }
      }
      __syncthreads();
      if (k0 + kBK < k)                      // in flight during the products
        load_tiles(x, w, a, xreg, wreg, areg, tid, row0, col0, k0 + kBK, m,
                   k, n, r, q0, first ? qn : 0);
      if constexpr (kMma) {
#pragma unroll
        for (int ks = 0; ks < kBK; ks += 16) {
          const int ra = 16 * wr + gid;
          const uint32_t af[4] = {pair(&sxb[ra][ks + 2 * tig]),
                                  pair(&sxb[ra + 8][ks + 2 * tig]),
                                  pair(&sxb[ra][ks + 8 + 2 * tig]),
                                  pair(&sxb[ra + 8][ks + 8 + 2 * tig])};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int cb = 16 * wc + 8 * nt + gid;
            mma_bf16(acc[4 * nt], acc[4 * nt + 1], acc[4 * nt + 2],
                     acc[4 * nt + 3], af, pair(&swb[cb][ks + 2 * tig]),
                     pair(&swb[cb][ks + 8 + 2 * tig]));
          }
        }
      } else {
#pragma unroll 8
        for (int kk = 0; kk < kBK; ++kk) {
          const float x0 = sx[2 * ty][kk], x1 = sx[2 * ty + 1][kk];
          const float4 wv = *reinterpret_cast<const float4*>(&sw[kk][4 * tx]);
          acc[0] = fmaf(x0, wv.x, acc[0]);
          acc[1] = fmaf(x0, wv.y, acc[1]);
          acc[2] = fmaf(x0, wv.z, acc[2]);
          acc[3] = fmaf(x0, wv.w, acc[3]);
          acc[4] = fmaf(x1, wv.x, acc[4]);
          acc[5] = fmaf(x1, wv.y, acc[5]);
          acc[6] = fmaf(x1, wv.z, acc[6]);
          acc[7] = fmaf(x1, wv.w, acc[7]);
        }
      }
      if (first) {
#pragma unroll 4
        for (int kk = 0; kk < kBK; ++kk) {
          float xv;
          if constexpr (kMma) xv = __bfloat162float(sxb[xrow][kk]);
          else xv = sx[xrow][kk];
#pragma unroll
          for (int u = 0; u < kXaPer; ++u) {
            const int q = xcol + 8 * u;
            if (q < qn) xa[u] = fmaf(xv, sa[kk * qn + q], xa[u]);
          }
        }
      }
      __syncthreads();
    }
    if (first) {
      // publish this block's columns of xa, gather the others'
#pragma unroll
      for (int u = 0; u < kXaPer; ++u) {
        const int q = xcol + 8 * u;
        if (q < qn) sa[xrow * qn + q] = xa[u];
      }
      cl.sync();
      for (int e = tid; e < kBM * r; e += kLThreads) {
        const int i = e / r, q = e % r;
        const int owner = q / rc, qq = q - owner * rc;
        const int on = min(r, owner * rc + rc) - owner * rc;
        const float* part = cl.map_shared_rank(sa, owner);
        // the TPU kernel rounds xa to the input dtype before its last dot
        sxa[i][q] = round_to(part[i * on + qq], T());
      }
      cl.sync();
    }
    // scale * xa @ B, B staged in shared memory (the A tile's space) 64
    // rows at a time
    float low[8] = {};
    for (int qb = 0; qb < r; qb += kBK * kRMax / kBN) {
      const int qs = min(kBK * kRMax / kBN, r - qb);
      float breg[kAL];
#pragma unroll
      for (int u = 0; u < kAL; ++u) {
        const int e = tid + u * kLThreads;
        const int q = e / kBN, gj = col0 + e % kBN;
        breg[u] = (q < qs && gj < n)
                      ? to_f32(b[static_cast<int64_t>(qb + q) * n + gj]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kAL; ++u) sa[tid + u * kLThreads] = breg[u];
      __syncthreads();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int i = kMma ? 16 * wr + gid + 8 * ((t >> 1) & 1)
                           : 2 * ty + t / 4;
        const int j = kMma ? 16 * wc + 8 * (t >> 2) + 2 * tig + (t & 1)
                           : 4 * tx + t % 4;
#pragma unroll 8
        for (int q = 0; q < qs; ++q)
          low[t] = fmaf(sxa[i][qb + q], sa[q * kBN + j], low[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int i = kMma ? 16 * wr + gid + 8 * ((t >> 1) & 1) : 2 * ty + t / 4;
      const int j = kMma ? 16 * wc + 8 * (t >> 2) + 2 * tig + (t & 1)
                         : 4 * tx + t % 4;
      const int gi = row0 + i, gj = col0 + j;
      if (gi < m && gj < n)
        store(y + static_cast<int64_t>(gi) * n + gj,
              __fadd_rn(acc[t], __fmul_rn(s, low[t])));
    }
    __syncthreads();             // sa is the next tile's A and B space
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* a, const void* b,
           const float* scale, void* y, int m, int k, int n, int r,
           cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  if (k <= kSK && r <= kSR && n <= kSN) {
    const int rows = (kSThreads / n) * kSRows;
    lora_small_kernel<T><<<(m + rows - 1) / rows, kSThreads, 0, stream>>>(
        xp, wp, ap, bp, scale, yp, m, k, n, r);
    return static_cast<int>(cudaGetLastError());
  }
  const int ctiles = (n + kBN - 1) / kBN;
  const int cluster = ctiles < kMaxCluster ? ctiles : kMaxCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (m + kBM - 1) / kBM);
  cfg.blockDim = dim3(kLThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, lora_large_kernel<T>, xp, wp, ap, bp, scale, yp, m, k, n, r);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). x [m, k], w [k, n], a [k, r],
// b [r, n], y [m, n], all row-major in one dtype (0 f32, 1 bf16); scale one
// f32 on the device. Launches on `stream`, does not synchronize, and
// returns the launch's CUDA error (0 on success).
extern "C" int lora_matmul_launch(const void* x, const void* w, const void* a,
                                  const void* b, const void* scale, void* y,
                                  int m, int k, int n, int r, int dtype,
                                  void* stream) {
  if (m < 1 || k < 1 || n < 1 || r < 1 || r > kRMax ||
      (m + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  if (dtype == 0) return launch<float>(x, w, a, b, sp, y, m, k, n, r, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, a, b, sp, y, m, k, n, r, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
