// Flash attention (GQA, causal, sliding window) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// `flash_attention` (body `_flash_kernel`): q [B,H,S,D], k/v [B,Hkv,T,D],
// query head h reads KV head h / (H/Hkv);
//
//   out = softmax(q k^T / sqrt(D) masked) v,
//   mask = kpos <= qpos  and, where window > 0, kpos > qpos - window
//
// with qpos = q_off + r for query row r (0 for a prefill; a sequence-
// parallel rank's first position for its rows of a longer sequence) and
// kpos = t for key t; the tile skips below read the same positions.
// (no mask without `causal`; the wrapper refuses a window without it), with
// the online softmax state m, l and acc in f32 and the output
// acc / max(l, 1e-30) in q's dtype. Masked scores are -1e30, as in the TPU
// kernel; keys past T (the ragged edge) weigh exactly 0.
//
// Bound: the operations. One causal S x S prefill does about
// 4*H*D*S*S/2 flops against (2*H + 2*Hkv)*S*D elements moved, hundreds of
// flops per byte, so the tensor cores' bf16 rate is the bound; a sliding
// window cuts the flops to about 4*H*D*S*window. As in the TPU kernel, a
// key tile is skipped wherever its `live` predicate is false (the tile
// wholly in the future of the q tile, or wholly older than the window),
// so the work is the mask's, not T's.
//
// The bf16 form (the serving path) runs both products on the tensor cores
// with wgmma. A block holds 192 query rows of one head: three consumer
// warpgroups of 64 rows each (two at D = 128, where three would not fit
// their registers), and one producer warp. The grid runs every head's
// longest q tiles first, so the short ones fill the tail. The producer streams
// the 64-key K/V tiles into a two-stage ring in shared memory with
// cp.async (16-byte copies, zero-filled past T) and signals each stage on
// an mbarrier (cp.async.mbarrier.arrive.noinc); the consumers release a
// stage on a second mbarrier once their products have read it, so the
// next tile's copy overlaps this tile's products. cp.async and not TMA:
// the tensor maps of TMA come from libcuda (cuTensorMapEncodeTiled),
// which this plain-C library does not link, and the tiles are small
// enough that 16-byte copies from one warp keep up. Tiles sit in shared
// memory in the 128-byte swizzled layout (64-byte at D = 32, 32-byte at
// D = 16), which a wgmma descriptor reads in either operand order without
// bank conflicts: S = Q K^T takes Q and K K-major from shared memory
// (m64n64k16, D/16 steps); O += P V takes P from registers and V in its
// natural [keys, D] layout as an MN-major B operand (the descriptor's
// transpose bit; m64nDk16, 4 steps), so no tile is transposed.
//
// Precision. Q K^T needs no care: products of bf16 values are exact in
// f32, and the tensor cores sum them in f32. P is not a bf16 value. The
// TPU kernel multiplies P by V in f32; rounding P to bf16 (as
// FlashAttention-2 does) errs by up to 2^-9 of each weight, which is a
// large share of an output that averages few keys (the first rows of a
// causal prefill: row 1 averages two keys, an error near 2e-3 |v|) and of
// outputs near 0 after cancellation, beyond one bf16 ulp of the result.
// So P is split as P = P_hi + P_lo, both bf16, P_lo = bf16(P - P_hi), and
// P V is two wgmmas per step: P is held to about 2^-17, at 1.5 times the
// tensor-core work of the single-bf16 form. The row sum l adds the f32 P.
//
// GQA: each block serves one query head and fetches its K/V tiles itself.
// Sharing a tile across the G heads of a group would take G consumer
// warpgroups (5 x 128 threads at Hymba's G = 5) with their 64-128
// accumulator and fragment registers each, past the 65,536 registers of an
// SM at one block per SM; the whole K/V of a Hymba layer (2.6 MB) stays in
// the 50 MB L2, and 192-row q tiles cut the L2-to-SM traffic of 64-row
// ones to about a third (80 MB a call at S = 2048), so the tiles are
// re-read from L2.
//
// The f32 form keeps the first kernel's body: f32 products on the CUDA
// cores (4 x 4 register micro-tiles, one head and 64 query rows per block),
// which the f32 sweeps hold to 2e-5; it is not on the serving path. Both
// forms take D in {16, 32, 64, 128}, every head dim of the reference's
// configs and test models.
//
// Both forms read inputs through (batch, head, seq) strides with a
// contiguous D, so a K/V cache in [B, T, Hkv, D] layout and a q in
// [B, S, H, D] layout pass as views, and write the output through strides.
// The bf16 form needs 16-byte-aligned rows and strides (the wrapper checks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Hkv, S, T;
  long long qs[3], ks[3], vs[3], os[3];  // batch, head, seq strides
  int causal, window;
  int q_off;  // query row r sits at position q_off + r (keys at 0..T-1)
  float scale;
};

// ---------------------------------------------------------------------------
// f32 form: f32 products on the CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kThreads = 256;
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile

template <int D>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(BQ + 2 * BK) * (D + 1) +
          static_cast<size_t>(BQ) * (BK + 1)) * sizeof(float);
}

// One block of 256 threads per (q tile of 64 rows, query head, batch),
// streaming K/V tiles of 64 keys through shared memory. Each thread owns a
// 4 x 4 micro-tile of the 64 x 64 score tile (rows 4*ty.., columns
// tx + 16*j) and the same 4 rows of the output (columns tx + 16*j, D / 16
// of them: one at D = 16); the 16 threads that share a row reduce its max
// and sum with warp shuffles (the score tile is 64 x 64 at every D).
// Shared rows are padded to D + 1 floats (conflict-free column reads of K).
template <int D>
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
  const float* q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* k = static_cast<const float*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const float* v = static_cast<const float*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  float* o = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[1];

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int qp = q0 + r;
    sQ[r * DP + d] = qp < a.S ? q[qp * a.qs[2] + d] : 0.f;
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
    if (a.causal) live = k0 <= a.q_off + q0 + BQ - 1;
    if (a.window > 0)
      live = live && (k0 + BK - 1 > a.q_off + q0 - a.window);
    if (!live) continue;

    __syncthreads();  // the previous tile's sK/sV/sP are consumed
    for (int e = tid; e < BK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const int kp = k0 + c;
      const bool in = kp < a.T;
      sK[c * DP + d] = in ? k[kp * a.ks[2] + d] : 0.f;
      sV[c * DP + d] = in ? v[kp * a.vs[2] + d] : 0.f;
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
      const int qp = a.q_off + q0 + ty * 4 + i;  // the row's position
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
      o[qp * a.os[2] + tx + 16 * jj] = acc[i][jj] / den;
  }
}

template <int D>
int launch(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  flash_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 form: wgmma on the tensor cores, a cp.async ring fed by a producer warp
// ---------------------------------------------------------------------------
namespace hop {

using bf16 = __nv_bfloat16;

// consumer warpgroups per block: three (192 query rows) where their
// registers fit one block on an SM, two at D = 128
template <int D>
constexpr int kWG = D == 128 ? 2 : 3;
template <int D>
constexpr int BQ = 64 * kWG<D>;              // query rows per block
template <int D>
constexpr int kThreads = 128 * kWG<D> + 32;  // + one producer warp
constexpr int BK = 64;                       // keys per tile
constexpr int kStages = 2;                   // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {                    // at a 1024-byte-aligned base
  bf16 q[BQ<D> * D];             // kWG slabs of 64 rows
  bf16 k[kStages][BK * D];
  bf16 v[kStages][BK * D];
  uint64_t full[kStages];        // the stage's copies have landed
  uint64_t empty[kStages];       // every consumer warp is done with it
};

// The swizzled shared-memory layout that wgmma reads. A tile row holds kW
// values (64; 32 at D = 32, 16 at D = 16) in 16-byte chunks whose order is
// XORed with address bits 7.. (the row's place in an 8-row atom): the
// 128-byte swizzle XORs chunk bits 0-2 with r & 7, the 64-byte one bits
// 0-1 with (r >> 1) & 3 (D = 32), the 32-byte one bit 0 with (r >> 2) & 1
// (D = 16: two chunks a row), so that the 8 rows an operand fetch reads
// lie in distinct banks. At D = 128 each 64-column half of the tile is its
// own [R rows x 128 B] region. The XOR acts on address bits, so tiles
// start on 1024 bytes.
template <int D>
struct Sw {
  static constexpr int kW = D < 64 ? D : 64;
  static constexpr int kRowBytes = 2 * kW;
  static constexpr uint32_t kAtom = 8 * kRowBytes;        // 8 rows
  // the descriptor's swizzle mode: 1 = 128B, 2 = 64B, 3 = 32B
  static constexpr uint64_t kMode = D == 16 ? 3 : D == 32 ? 2 : 1;
  // byte offset of 16-byte chunk c (of D / 8) of row r in an R-row tile
  template <int R>
  __device__ static __forceinline__ uint32_t off(int r, int c) {
    const int half = c / (kW / 8), cc = c % (kW / 8);
    const int x = kRowBytes == 128  ? (r & 7)
                  : kRowBytes == 64 ? ((r >> 1) & 3)
                                    : ((r >> 2) & 1);
    return half * R * kRowBytes + r * kRowBytes + ((cc ^ x) << 4);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 16-byte copy, zero-filled when `in` is false (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// Rows [r0, r0 + R) of a [rows, D] bf16 matrix (row stride `ld`, rows past
// `rows` zero) into the swizzled layout at `dst`. Consecutive lanes copy
// consecutive chunks of a row, which land in one 128-byte (64-, 32-byte)
// row of shared memory: no bank conflicts, and coalesced reads.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long ld, int r0, int rows,
                                          int t, int nt) {
#pragma unroll 4
  for (int e = t; e < R * D / 8; e += nt) {
    const int r = e / (D / 8), c = e % (D / 8);
    const bool in = r0 + r < rows;
    cp_async16(dst + Sw<D>::template off<R>(r, c),
               src + (in ? r0 + r : 0) * ld + 8 * c, in);
  }
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (in 16-byte units) and the swizzle mode (bits 62-63).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (mode << 62);
}

// Q K^T operands, K-major (a row of a tile is a row of Q or K): k-step kk
// (16 values, 32 bytes) sits in 64-column half kk / (kW/16) at byte
// 32 * (kk % (kW/16)) of each row; 8-row atoms lie kAtom bytes apart. At
// D = 16 the one k-step is the whole 32-byte row.
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using L = Sw<D>;
  constexpr int steps = L::kW / 16;
  return make_desc(tile + (kk / steps) * R * L::kRowBytes + 32 * (kk % steps),
                   16, L::kAtom, L::kMode);
}

// P V's B operand, V [keys, D] MN-major: k-step kk is keys 16kk.. (two
// 8-row atoms, kAtom apart, the stride offset); the 64-column halves of
// D = 128 lie R rows apart (the leading offset; unread at D <= 64, where
// N is one swizzle atom wide).
template <int D, int R>
__device__ __forceinline__ uint64_t desc_v(uint32_t tile, int kk) {
  using L = Sw<D>;
  return make_desc(tile + 2 * kk * L::kAtom, R * L::kRowBytes, L::kAtom,
                   L::kMode);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrives on `bar` once every cp.async this thread started has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Waits for the phase of `bar` with this parity to complete. A protocol
// fault that would deadlock traps after about 2^26 polls (seconds) instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// Makes shared-memory data written through the generic proxy (cp.async)
// visible to the async proxy that wgmma reads it through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Orders the compiler's uses of registers that an asynchronous wgmma
// writes or reads after the wait that completes it.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma wrappers. ss: A and B from shared memory, both K-major, d = A B^T
// (+ d where scale_d). rs_tb: A from registers, B MN-major in shared memory
// (the transpose bit), d += A B.
__device__ __forceinline__ void wgmma_ss_m64n64(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n16_tb(float* d,
                                                   const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n32_tb(float* d,
                                                   const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n64_tb(float* d,
                                                   const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128_tb(float* d,
                                                   const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void pv_mma(float* o, const uint32_t* p,
                                       uint64_t dv) {
  if constexpr (D == 16) wgmma_rs_m64n16_tb(o, p, dv);
  if constexpr (D == 32) wgmma_rs_m64n32_tb(o, p, dv);
  if constexpr (D == 64) wgmma_rs_m64n64_tb(o, p, dv);
  if constexpr (D == 128) wgmma_rs_m64n128_tb(o, p, dv);
}

// (x, y) -> bf16x2 hi = round(x, y) and lo = round((x, y) - hi)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Grid (H, q tiles, B), the last q tiles (the most keys) first. Thread
// layout of a consumer warpgroup's accumulators (m64nN): warp w of the
// group holds rows 16w + lane/4 ("lo") and 16w + lane/4 + 8 ("hi"); the
// four registers 4j..4j+3 hold columns 8j + 2*(lane%4) + {0, 1} of lo,
// then of hi. The same layout, read as pairs, is the A fragment of P V.
template <int D>
__global__ void __launch_bounds__(kThreads<D>, 1) flash_kernel(FlashArgs a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  constexpr int kW = kWG<D>;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ<D>;
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);

  // the block's live key tiles, the TPU kernel's skip for BQ x BK tiles
  const int n_tiles = (a.T + BK - 1) / BK;
  int kt_lo = 0, kt_hi = n_tiles;
  const int p0 = a.q_off + q0;  // the block's first query position
  if (a.causal) kt_hi = min(n_tiles, (p0 + BQ<D> - 1) / BK + 1);
  if (a.window > 0 && p0 - a.window - BK + 1 >= 0)
    kt_lo = (p0 - a.window - BK + 1) / BK + 1;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&sm.full[s]), 32);
      mbar_init(smem_u32(&sm.empty[s]), 4 * kW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kW) {
    // producer: K/V tiles into the ring
    const bf16* k = static_cast<const bf16*>(a.k) + b * a.ks[0] +
                    hk * a.ks[1];
    const bf16* v = static_cast<const bf16*>(a.v) + b * a.vs[0] +
                    hk * a.vs[1];
    for (int kt = kt_lo, it = 0; kt < kt_hi; ++kt, ++it) {
      const int s = it % kStages;
      if (it >= kStages)
        mbar_wait(smem_u32(&sm.empty[s]), ((it / kStages) - 1) & 1);
      load_tile<D, BK>(smem_u32(sm.k[s]), k, a.ks[2], kt * BK, a.T, lane,
                       32);
      load_tile<D, BK>(smem_u32(sm.v[s]), v, a.vs[2], kt * BK, a.T, lane,
                       32);
      cp_async_arrive(smem_u32(&sm.full[s]));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumers: warpgroup wg owns query rows wq0 .. wq0 + 63
  const int wg = warp >> 2;
  const int wq0 = q0 + wg * 64;
  bf16* sq = sm.q + wg * 64 * D;
  load_tile<D, 64>(smem_u32(sq),
                   static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[1],
                   a.qs[2], wq0, a.S, tid & 127, 128);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fence_proxy_async();
  bar_sync(1 + wg, 128);

  const int qlo = wq0 + 16 * (warp & 3) + (lane >> 2);
  const int qhi = qlo + 8;
  const int wp0 = a.q_off + wq0;  // positions: the warpgroup's first row,
  const int plo = a.q_off + qlo;  // and this thread's two rows
  const int phi = a.q_off + qhi;
  const int c2 = 2 * (lane & 3);
  const uint32_t q_tile = smem_u32(sq);
  const float sl2 = a.scale * kLog2e;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  for (int kt = kt_lo, it = 0; kt < kt_hi; ++kt, ++it) {
    const int s = it % kStages;
    mbar_wait(smem_u32(&sm.full[s]), (it / kStages) & 1);
    const int k0 = kt * BK;
    bool live = wq0 < a.S;  // the same skip for this warpgroup's 64 rows
    if (a.causal) live = live && k0 <= wp0 + 63;
    if (a.window > 0) live = live && (k0 + BK - 1 > wp0 - a.window);
    if (live) {
      fence_proxy_async();
      // S = Q K^T
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      const uint32_t k_tile = smem_u32(sm.k[s]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64(sc, desc_k<D, 64>(q_tile, kk),
                        desc_k<D, BK>(k_tile, kk), kk > 0);
      wg_commit();
      wg_wait0();
      keep(sc);

      // scale (to base 2), mask, online softmax
      bool full = k0 + BK <= a.T;
      if (a.causal) full = full && k0 + BK - 1 <= wp0;
      if (a.window > 0) full = full && k0 > wp0 + 63 - a.window;
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float vl = sc[4 * j + e] * sl2;
          float vh = sc[4 * j + 2 + e] * sl2;
          if (!full) {
            const int kp = k0 + 8 * j + c2 + e;
            if (a.causal) {
              if (kp > plo || (a.window > 0 && kp <= plo - a.window))
                vl = kNegInf;
              if (kp > phi || (a.window > 0 && kp <= phi - a.window))
                vh = kNegInf;
            }
            if (kp >= a.T) vl = vh = -INFINITY;  // past the ragged edge
          }
          sc[4 * j + e] = vl;
          sc[4 * j + 2 + e] = vh;
          mx_lo = fmaxf(mx_lo, vl);
          mx_hi = fmaxf(mx_hi, vh);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo);
      const float mn_hi = fmaxf(m_hi, mx_hi);
      const float al_lo = exp2f(m_lo - mn_lo);
      const float al_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      uint32_t ph[4][4], pl[4][4];  // P's A fragments per 16-key step
      float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* t = sc + 8 * kk + 4 * half;
          const float p0 = exp2f(t[0] - mn_lo), p1 = exp2f(t[1] - mn_lo);
          const float p2 = exp2f(t[2] - mn_hi), p3 = exp2f(t[3] - mn_hi);
          rs_lo += p0 + p1;
          rs_hi += p2 + p3;
          split2(p0, p1, ph[kk][2 * half], pl[kk][2 * half]);
          split2(p2, p3, ph[kk][2 * half + 1], pl[kk][2 * half + 1]);
        }
      }
      l_lo = l_lo * al_lo + rs_lo;
      l_hi = l_hi * al_hi + rs_hi;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= al_lo;
        o[4 * j + 1] *= al_lo;
        o[4 * j + 2] *= al_hi;
        o[4 * j + 3] *= al_hi;
      }

      // O += P_hi V + P_lo V; V [keys, D] is the MN-major B operand
      const uint32_t v_tile = smem_u32(sm.v[s]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        pv_mma<D>(o, ph[kk], desc_v<D, BK>(v_tile, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        pv_mma<D>(o, pl[kk], desc_v<D, BK>(v_tile, kk));
      wg_commit();
      wg_wait0();
      keep(o);
      keep(ph);
      keep(pl);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&sm.empty[s]));
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
  bf16* o_ptr = static_cast<bf16*>(a.o) + b * a.os[0] + h * a.os[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + c2;
    if (qlo < a.S)
      *reinterpret_cast<__nv_bfloat162*>(o_ptr + qlo * a.os[2] + col) =
          __floats2bfloat162_rn(o[4 * j] / den_lo, o[4 * j + 1] / den_lo);
    if (qhi < a.S)
      *reinterpret_cast<__nv_bfloat162*>(o_ptr + qhi * a.os[2] + col) =
          __floats2bfloat162_rn(o[4 * j + 2] / den_hi,
                                o[4 * j + 3] / den_hi);
  }
}

template <int D>
int launch(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = sizeof(Smem<D>) + 1024;  // + alignment slack
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  // heads fastest: every head's last (longest) q tile starts first
  const dim3 grid(a.H, (a.S + BQ<D> - 1) / BQ<D>, B);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel<D><<<grid, kThreads<D>, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hop

template <typename T>
int dispatch(const FlashArgs& a, int B, int D, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    if (D == 16) return f32::launch<16>(a, B, stream);
    if (D == 32) return f32::launch<32>(a, B, stream);
    if (D == 64) return f32::launch<64>(a, B, stream);
    if (D == 128) return f32::launch<128>(a, B, stream);
  } else {
    if (D == 16) return hop::launch<16>(a, B, stream);
    if (D == 32) return hop::launch<32>(a, B, stream);
    if (D == 64) return hop::launch<64>(a, B, stream);
    if (D == 128) return hop::launch<128>(a, B, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (bound with ctypes). q/k/v/o in f32 (dtype 0) or bf16
// (dtype 1); strides[12] = q, k, v, o strides in elements, each as (batch,
// head, seq), the last dim contiguous (for bf16, every row 16-byte
// aligned). D in {16, 32, 64, 128} (any other D returns
// cudaErrorInvalidValue); H % Hkv == 0. Query row r sits at position
// q_off + r (q_off >= 0; q_off > 0 needs a causal call with q_off + S
// <= T: every row keeps its own key), the keys at 0..T-1. Launches on `stream`, does not
// synchronize, and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int S, int T, int D,
                                      const long long* strides, int causal,
                                      int window, int q_off, float scale,
                                      int dtype, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || S < 1 || T < 1 ||
      B > 65535 || H > 65535 || (!causal && window > 0) || q_off < 0 ||
      (!causal && q_off > 0) || (q_off > 0 && q_off + S > T))
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
  a.q_off = q_off;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
