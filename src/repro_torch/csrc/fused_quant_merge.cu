// Fused quantized-wire swarm commit for Hopper (sm_90a): the error-feedback
// wire advance, the merge and the gate over the flat [N, P] state.
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
// Design. The int8 grid follows the reference's per-leaf HWIO element order,
// while the port stores conv leaves OIHW, so a wire block (segment) of a conv
// is scattered over storage, and its scale needs the whole segment before
// any of it can be committed. Two passes, which read x and r twice (6*N*P*4
// bytes of traffic against the least 4*N*P*4); a single pass that keeps a
// tile in the shared memory of a cluster of blocks measured slower, paced by
// the largest tile, which eight blocks cannot split finely (PERF.md):
//
// 1. maxima (int8 only): walks the tile table of core/comms.py::WireGrid. A
//    tile is a set of at most 128 whole segments whose stored positions form
//    contiguous runs, cut into chunks of at most 128 values; one thread block
//    takes a piece (a few chunks) of a tile, one warp a chunk, lanes on
//    consecutive values, so every load is coalesced. It reads x and r once
//    and takes each row's max |x - r| per segment by atomicMax on the bits in
//    shared memory (non-negative floats order as their bits, so the max is
//    exact and order-free; a warp whose lanes share a segment reduces
//    first), then merges its maxima into the [S, N] device array with one
//    atomicMax per segment and row. A tile of any size thus spreads over
//    as many blocks as it has pieces: a conv leaf that cannot be cut (its
//    segments straddle every channel boundary, as in four of the paper
//    CNN's 3x3 convs) is one tile of up to 62,208 values.
// 2. commit (every wire): one thread per stored column, neighbouring threads
//    on neighbouring columns (coalesced). Per column: the N rows of r' into
//    registers, stored, and the N committed rows from them; a rejected row
//    stores x itself.
//
// A grid whose every segment is a contiguous range of the buffer (no conv
// leaf, as the model zoo's 180-value adapter payload) needs neither: one
// block a segment takes its maxima and commits it, in one launch.
//
// Every rounding is explicit (__fsub_rn, __fdiv_rn, rintf, __fmul_rn,
// __fadd_rn) so nvcc contracts nothing into an FMA: r' equals the plain
// version (core/comms.py::wire_effective) bit for bit, and the merge
// accumulates in j order as kernels/ref.py does. N is a template bound
// (4..64) so the per-column arrays stay in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kF32 = 0, kBF16 = 1, kInt8 = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPieceChunks = 16;   // core/comms.py PIECE_CHUNKS

template <int NMAX>
__global__ void __launch_bounds__(kThreads)
quant_merge_kernel_max(const float* __restrict__ x, const float* __restrict__ r,
                       const int64_t* __restrict__ pieces,
                       const int64_t* __restrict__ chunks,
                       const int32_t* __restrict__ tile_segs,
                       const uint8_t* __restrict__ lseg,
                       unsigned* __restrict__ gmax, int n, int64_t d) {
  extern __shared__ unsigned smax[];                  // [segs, n]
  __shared__ int64_t sc0[kPieceChunks + 1], soff[kPieceChunks + 1];
  const int64_t* pc = pieces + 4 * static_cast<int64_t>(blockIdx.x);
  const int64_t kb = pc[0];
  const int nchunks = static_cast<int>(pc[1] - kb);
  const int64_t seg0 = pc[2];
  const int nsegs = static_cast<int>(pc[3]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (nchunks > kPieceChunks) __trap();     // not a table comms.py builds
  if (threadIdx.x <= nchunks) {
    sc0[threadIdx.x] = chunks[2 * (kb + threadIdx.x)];
    soff[threadIdx.x] = chunks[2 * (kb + threadIdx.x) + 1];
  }
  for (int k = threadIdx.x; k < nsegs * n; k += kThreads) smax[k] = 0u;
  __syncthreads();

  constexpr int U = NMAX <= 8 ? 2 : 1;
  for (int k = warp; k < nchunks; k += kWarps) {
    const int64_t c0 = sc0[k];
    const int len = static_cast<int>(soff[k + 1] - soff[k]);
    for (int e0 = 0; e0 < len; e0 += 32 * U) {
      float xv[U][NMAX], rv[U][NMAX];
      unsigned ls[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * 32 + lane;
        const bool valid = e < len;
        ls[u] = valid ? lseg[c0 + e] : 0xffffffffu;
#pragma unroll
        for (int j = 0; j < NMAX; ++j) {
          if (j < n) {
            const int64_t at = static_cast<int64_t>(j) * d + c0 + e;
            xv[u][j] = valid ? x[at] : 0.f;
            rv[u][j] = valid ? r[at] : 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (e0 + u * 32 >= len) break;              // warp-uniform
        const bool valid = e0 + u * 32 + lane < len;
        const unsigned ls0 = __shfl_sync(kFull, ls[u], 0);
        const bool uniform = __all_sync(kFull, !valid || ls[u] == ls0);
#pragma unroll
        for (int j = 0; j < NMAX; ++j) {
          if (j < n) {
            unsigned bits =
                valid ? __float_as_uint(fabsf(__fsub_rn(xv[u][j], rv[u][j])))
                      : 0u;
            if (uniform) {
              bits = __reduce_max_sync(kFull, bits);
              if (lane == 0) atomicMax(&smax[ls0 * n + j], bits);
            } else if (valid) {
              atomicMax(&smax[ls[u] * n + j], bits);
            }
          }
        }
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nsegs * n; k += kThreads) {
    const unsigned m = smax[k];
    if (m != 0u)
      atomicMax(&gmax[static_cast<int64_t>(tile_segs[seg0 + k / n]) * n +
                      k % n],
                m);
  }
}

// One column c: r' of the N rows (stored) and the N committed rows; `sc`
// holds the int8 scales of the column's segment, one per row; W and the
// gates are read from shared memory or, in the commit pass, from L1.
template <int NMAX, int WIRE, bool HAS_IMP>
__device__ __forceinline__ void commit_column(
    int64_t c, const float* __restrict__ x, const float* __restrict__ r,
    const float* __restrict__ imp, const float* sW, const int32_t* sg,
    const float (&sc)[NMAX], float* __restrict__ out,
    float* __restrict__ rout, int n, int64_t d) {
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
        const float s = sc[j];
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

// The commit pass: one thread per column; int8 scales from the maxima pass's
// [S, N] array.
template <int NMAX, int WIRE, bool HAS_IMP>
__global__ void __launch_bounds__(kThreads)
quant_merge_kernel_commit(const float* __restrict__ x,
                          const float* __restrict__ r,
                          const float* __restrict__ imp,
                          const float* __restrict__ W,
                          const int32_t* __restrict__ gates,
                          const int32_t* __restrict__ seg32,
                          const unsigned* __restrict__ gmax,
                          float* __restrict__ out, float* __restrict__ rout,
                          int n, int64_t d) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= d) return;
  float sc[NMAX];
  if constexpr (WIRE == kInt8) {
    const unsigned* m = gmax + static_cast<int64_t>(seg32[c]) * n;
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < n) sc[j] = __fdiv_rn(__uint_as_float(m[j]), 127.0f);
  }
  // W and the gates straight from L1: no barrier ahead of the column's loads
  commit_column<NMAX, WIRE, HAS_IMP>(c, x, r, imp, W, gates, sc, out, rout, n,
                                     d);
}

// int8 on a grid whose every segment is a contiguous range of the buffer
// (no conv leaf stored out of the reference's order, as the model zoo's
// adapter payload): one block a segment takes the segment's maxima in
// registers and shared memory, then commits it; one launch.
template <int NMAX, bool HAS_IMP>
__global__ void __launch_bounds__(kThreads, 2)   // 2: measured faster
quant_merge_kernel_segment(const float* __restrict__ x,
                           const float* __restrict__ r,
                           const float* __restrict__ imp,
                           const float* __restrict__ W,
                           const int32_t* __restrict__ gates,
                           const int64_t* __restrict__ segments,
                           float* __restrict__ out, float* __restrict__ rout,
                           int n, int64_t d) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);                 // [n, n]
  int32_t* sg = reinterpret_cast<int32_t*>(sW + n * n);         // [n]
  unsigned* sscale = reinterpret_cast<unsigned*>(sg + n);       // [n]
  unsigned* sred = sscale + n;                                  // [warps, n]
  // W and the gates into registers, their loads issued ahead of the
  // segment's, into shared memory at the first barrier
  constexpr int kW = 64 * 64 / kThreads;
  float wv[kW];
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    const int k = threadIdx.x + u * kThreads;
    if (k < n * n) wv[u] = W[k];
  }
  const int32_t gv = threadIdx.x < n ? gates[threadIdx.x] : 0;
  const int64_t start = segments[2 * static_cast<int64_t>(blockIdx.x)];
  const int len = static_cast<int>(
      segments[2 * static_cast<int64_t>(blockIdx.x) + 1]);
  float mx[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) mx[j] = 0.f;
  for (int t = threadIdx.x; t < len; t += kThreads) {
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j < n) {
        const int64_t at = static_cast<int64_t>(j) * d + start + t;
        mx[j] = fmaxf(mx[j], fabsf(__fsub_rn(x[at], r[at])));
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j < n) {
      float v = mx[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
      if (lane == 0) sred[warp * n + j] = __float_as_uint(v);
    }
  }
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    const int k = threadIdx.x + u * kThreads;
    if (k < n * n) sW[k] = wv[u];
  }
  if (threadIdx.x < n) sg[threadIdx.x] = gv;
  __syncthreads();
  if (threadIdx.x < n) {
    unsigned v = 0u;
    for (int w = 0; w < kWarps; ++w) v = max(v, sred[w * n + threadIdx.x]);
    sscale[threadIdx.x] =
        __float_as_uint(__fdiv_rn(__uint_as_float(v), 127.0f));
  }
  __syncthreads();
  float sc[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j)
    if (j < n) sc[j] = __uint_as_float(sscale[j]);
  for (int t = threadIdx.x; t < len; t += kThreads)
    commit_column<NMAX, kInt8, HAS_IMP>(start + t, x, r, imp, sW, sg, sc,
                                        out, rout, n, d);
}

struct Args {
  const float *x, *r, *imp, *W;
  const int32_t* gates;
  const int64_t *segments, *pieces, *chunks;
  const int32_t *tile_segs, *seg32;
  const uint8_t* lseg;
  unsigned* gmax;
  float *out, *rout;
  int64_t n_pieces;
  int n;
  int64_t d;
  int n_segs, max_segs;
  bool contiguous;
  cudaStream_t stream;
};

template <int NMAX, int WIRE, bool HAS_IMP>
int launch(const Args& a) {
  if constexpr (WIRE == kInt8) {
    if (a.contiguous) {
      const size_t base =
          (static_cast<size_t>(a.n) * a.n + a.n) * sizeof(float);
      quant_merge_kernel_segment<NMAX, HAS_IMP>
          <<<static_cast<unsigned>(a.n_segs), kThreads,
             base + (1 + kWarps) * a.n * sizeof(unsigned), a.stream>>>(
              a.x, a.r, a.imp, a.W, a.gates, a.segments, a.out, a.rout, a.n,
              a.d);
      return static_cast<int>(cudaGetLastError());
    }
    cudaError_t err = cudaMemsetAsync(
        a.gmax, 0, static_cast<size_t>(a.n_segs) * a.n * sizeof(unsigned),
        a.stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    // at most 128 segments x 64 rows: 32 KB, inside the default 48 KB
    quant_merge_kernel_max<NMAX>
        <<<static_cast<unsigned>(a.n_pieces), kThreads,
           static_cast<size_t>(a.max_segs) * a.n * sizeof(unsigned),
           a.stream>>>(a.x, a.r, a.pieces, a.chunks, a.tile_segs, a.lseg,
                       a.gmax, a.n, a.d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t want = (a.d + kThreads - 1) / kThreads;
  quant_merge_kernel_commit<NMAX, WIRE, HAS_IMP>
      <<<static_cast<unsigned>(want), kThreads, 0, a.stream>>>(
          a.x, a.r, a.imp, a.W, a.gates, a.seg32, a.gmax, a.out, a.rout, a.n,
          a.d);
  return static_cast<int>(cudaGetLastError());
}

template <int NMAX, int WIRE>
int by_imp(const Args& a) {
  return a.imp != nullptr ? launch<NMAX, WIRE, true>(a)
                          : launch<NMAX, WIRE, false>(a);
}

template <int WIRE>
int by_nodes(const Args& a) {
  if (a.n <= 4) return by_imp<4, WIRE>(a);
  if (a.n <= 8) return by_imp<8, WIRE>(a);
  if (a.n <= 16) return by_imp<16, WIRE>(a);
  if (a.n <= 32) return by_imp<32, WIRE>(a);
  return by_imp<64, WIRE>(a);
}

}  // namespace

// Plain C entry point (bound with ctypes). x, r, out, new_ref: [n, d] f32
// row-major; imp: [n, d] f32 or null; W: [n, n] f32; gates: [n] int32;
// wire: 0 f32, 1 bf16, 2 int8. For int8, segments: [n_segs, 2] int64
// (start, length) and, when `contiguous` is 0, the grid's tile table
// (core/comms.py::WireGrid): pieces [n_pieces, 4] int64, chunks [C + 1, 2]
// int64, tile_segs [n_segs] int32, lseg [d] uint8, seg32 [d] int32, the
// most segments in a tile (<= 128), and gmax, [n_segs, n] uint32 scratch on
// the device (zeroed here); when `contiguous` is 1 every segment is the
// range [start, start + length) of the buffer and the tables may be null.
// All null / 0 for bf16 and f32. Launches on `stream`, does not
// synchronize, and returns the first CUDA error (0 on success).
extern "C" int fused_quant_merge_all_launch(
    const void* x, const void* r, const void* imp, const void* W,
    const void* gates, const void* segments, const void* pieces,
    const void* chunks, const void* tile_segs, const void* lseg,
    const void* seg32, void* gmax, void* out, void* new_ref,
    long long n_pieces, int n, long long d, int wire, int n_segs,
    int max_segs, int contiguous, void* stream) {
  const bool tables = pieces != nullptr && chunks != nullptr &&
                      tile_segs != nullptr && lseg != nullptr &&
                      seg32 != nullptr && gmax != nullptr && n_pieces >= 1 &&
                      n_pieces <= 2147483647LL && max_segs >= 1 &&
                      max_segs <= 128;
  if (n < 1 || n > 64 || d < 1 || d > 2147483647LL * kThreads ||
      (wire == kInt8 &&
       (segments == nullptr || n_segs < 1 || (contiguous == 0 && !tables))))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const float*>(x);
  a.r = static_cast<const float*>(r);
  a.imp = static_cast<const float*>(imp);
  a.W = static_cast<const float*>(W);
  a.gates = static_cast<const int32_t*>(gates);
  a.segments = static_cast<const int64_t*>(segments);
  a.pieces = static_cast<const int64_t*>(pieces);
  a.chunks = static_cast<const int64_t*>(chunks);
  a.tile_segs = static_cast<const int32_t*>(tile_segs);
  a.seg32 = static_cast<const int32_t*>(seg32);
  a.lseg = static_cast<const uint8_t*>(lseg);
  a.gmax = static_cast<unsigned*>(gmax);
  a.out = static_cast<float*>(out);
  a.rout = static_cast<float*>(new_ref);
  a.n_pieces = n_pieces;
  a.n = n;
  a.d = d;
  a.n_segs = n_segs;
  a.max_segs = max_segs;
  a.contiguous = contiguous != 0;
  a.stream = static_cast<cudaStream_t>(stream);
  if (wire == kF32) return by_nodes<kF32>(a);
  if (wire == kBF16) return by_nodes<kBF16>(a);
  if (wire == kInt8) return by_nodes<kInt8>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
