// Mamba-2 chunked SSD scan (state-space duality) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py `ssd_scan`
// (body `_ssd_kernel`). Inputs: x [B,S,H,P], dt [B,S,H] f32 (softplus'd),
// a_log f32 ([H] shared by every batch row, or one [H] row per batch row:
// a swarm's nodes folded into the batch each bring their own), B/C
// [B,S,G,N] with H % G == 0 (head h reads group h / (H/G); G = H is the
// reference's pre-broadcast form). Per chunk of L steps, in f32, with
// a = -exp(a_log[b, h]):
//
//   cum   = cumsum(dt * a)
//   y     = (C B^T (.) Lmat)(x dt) + (C (.) e^cum) state,
//           Lmat[i,j] = e^(cum_i - cum_j) for i >= j, else 0
//   state <- e^(cum_L) state + (B (.) e^(cum_L - cum))^T (x dt)
//
// y is written in x's dtype, the final state [B,H,P,N] in f32.
//
// Bound: the operations. Per head and chunk the decayed scores times x
// take about L*L/2*P multiply-adds and the state parts 2*L*N*P, all with
// an f32 operand, against L*(P + 2N) input values: tens of flops per byte
// at Hymba's N = 16, P = 64, L = 256 and more at Mamba2's N = 128, so the
// f32 rate bounds these. C B^T (L*L/2*N multiply-adds of bf16 operands) is
// the same for every head of a group and is priced once per group at the
// bf16 tensor-core rate; the bound is the sum of the two times (about
// 31 us at Hymba's 2048-token shape, 48 us at Mamba2's, on an H100 SXM).
//
// Design: the TPU's sequential chunk axis becomes three launches that are
// parallel over chunks, and the in-chunk work is split into strips of 32
// query rows:
//
//   1. chunk_state  grid (chunk, head, batch x 32-row slab of N): the
//      chunk's own end state from zero, sum_j (B_j e^(cum_L - cum_j) dt_j)
//      x_j, into an f32 scratch [B, H, chunks, N, P], and its total decay
//      e^(cum_L) into [B, H, chunks];
//   2. state_pass   one thread per (batch, head, n, p): walks the chunks in
//      order, state <- e^(cum_L) state + local, the plain recurrence's
//      order, overwriting each chunk's scratch with the state it starts
//      from, and writes the final state;
//   3. chunk_out    grid (batch x head, chunk, strip), the last (longest)
//      strips first: the strip's y, the inter-chunk part (C (.) e^cum)
//      state_in, then the causal tiles of 32 keys up to the diagonal.
//
// At Hymba's 2048-token prefill that is 400, 200 and 3,200 blocks (the
// first kernel had 50); at a 256-token prompt (one chunk) the strips still
// give 400 blocks of the last launch. No atomics, and every sum runs in a
// fixed order, so two runs agree bit for bit.
//
// Units. C B^T takes bf16 operands in the bf16 form, so it runs on the
// tensor cores (mma.sync m16n8k16, f32 accumulators: the products of bf16
// values are exact in f32), one k-step per 16 state dims (one at Hymba's
// N = 16). Every product with an f32 operand stays in f32 on the CUDA
// cores, in register micro-tiles of 4 rows x P/16 columns: the decayed
// scores times x, the chunk state (B e^.. dt)^T x, and (C e^cum) state.
// Single TF32 (unit roundoff 2^-11) would put the f32 state about 5 times
// over its 1e-4 limit, so none of them uses it. dt is folded into the
// scores (and into B for the state), so x * dt is never formed: each x
// value is read once per tile in its own dtype and widened in registers.
// The f32 form computes C B^T with f32 FMAs too.
//
// Copies. x, B and C tiles are staged with cp.async (16-byte copies,
// double-buffered: the next key tile lands while this one is used) where
// the rows and strides are 16-byte aligned, as the model's views are; for
// other layouts the same tiles are loaded element by element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // chunk_state and chunk_out blocks
constexpr int RS = 32;         // rows per strip, keys per tile, n per slab
constexpr int MAXP = 128;
constexpr int MAXN = 256;
constexpr int MAXL = 256;

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* bm;
  const void* cm;
  void* y;
  float* state;        // [B, H, P, N]
  float* chunk_state;  // [B, H, chunks, N, P] scratch
  float* chunk_decay;  // [B, H, chunks] scratch
  int S, H, P, G, N, L, nc;
  int als;           // a_log row stride: batch row b reads a_log[b * als + h]
  long long xb, xs;  // x strides (batch, seq); (head, p) contiguous
  long long bb, bs;  // B strides (batch, seq); (group, n) contiguous
  long long cb, cs;  // C strides (batch, seq); (group, n) contiguous
  int vx, vb, vc;    // 16-byte copies allowed for x, B, C
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, R) of a matrix with row stride `ld` and `width` elements a row
// into shared memory at row pitch `pitch`; rows from `valid` on are zero.
// With `vec`, 16-byte cp.async copies (width, ld and src 16-byte aligned);
// else element by element.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int pitch, const T* src,
                                          long long ld, int R, int valid,
                                          int width, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int cpr = width / E;
    for (int e = threadIdx.x; e < R * cpr; e += kThreads) {
      const int r = e / cpr, c = (e % cpr) * E;
      const bool in = r < valid;
      cp_async16(dst + r * pitch + c, src + (in ? r : 0) * ld + c, in);
    }
  } else {
    for (int e = threadIdx.x; e < R * width; e += kThreads) {
      const int r = e / width, c = e % width;
      dst[r * pitch + c] = r < valid ? src[r * ld + c] : zero<T>();
    }
  }
}

// CW consecutive values from shared memory, widened to f32.
template <int CW>
__device__ __forceinline__ void load_cw(const float* p, float* v) {
  if constexpr (CW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < CW / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else if constexpr (CW == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}
__device__ __forceinline__ void unpack(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
template <int CW>
__device__ __forceinline__ void load_cw(const bf16* p, float* v) {
  if constexpr (CW % 8 == 0) {
#pragma unroll
    for (int i = 0; i < CW / 8; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      unpack(u.x, v + 8 * i);
      unpack(u.y, v + 8 * i + 2);
      unpack(u.z, v + 8 * i + 4);
      unpack(u.w, v + 8 * i + 6);
    }
  } else if constexpr (CW == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack(u.x, v);
    unpack(u.y, v + 2);
  } else if constexpr (CW == 2) {
    unpack(*reinterpret_cast<const uint32_t*>(p), v);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

// acc[i][c] += sum_k aT[k][4*ty + i] * bm[k][CW*tx + c]: a 32-row x 16*CW
// column tile over 128 threads (ty = tid / 16, tx = tid % 16), f32 FMAs in
// the order k = 0..K-1. aT is [K][32] f32, bm [K][16*CW] in T.
template <typename T, int CW>
__device__ __forceinline__ void mt_accum(float (&acc)[4][CW], const float* aT,
                                         const T* bm, int K) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(aT + k * 32 + 4 * ty);
    float bv[CW];
    load_cw<CW>(bm + k * 16 * CW + CW * tx, bv);
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      acc[0][c] = fmaf(av.x, bv[c], acc[0][c]);
      acc[1][c] = fmaf(av.y, bv[c], acc[1][c]);
      acc[2][c] = fmaf(av.z, bv[c], acc[2][c]);
      acc[3][c] = fmaf(av.w, bv[c], acc[3][c]);
    }
  }
}

// cum[0..L) = inclusive cumsum of dt * a over the chunk starting at `dt`
// (step `ld`), dtv = dt; 128 threads, two steps each (a warp scan of the
// pairs, then the warps' totals in order). Ends with a barrier.
__device__ __forceinline__ void chunk_cumsum(const float* dt, long long ld,
                                             int L, float A, float* cum,
                                             float* dtv, float* wsum) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float d0 = 2 * t < L ? dt[2 * t * ld] : 0.f;
  const float d1 = 2 * t + 1 < L ? dt[(2 * t + 1) * ld] : 0.f;
  const float v0 = d0 * A, v1 = d1 * A;
  float s = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) wsum[warp] = s;
  __syncthreads();
  for (int w = 0; w < warp; ++w) excl += wsum[w];
  if (2 * t < L) {
    cum[2 * t] = excl + v0;
    dtv[2 * t] = d0;
  }
  if (2 * t + 1 < L) {
    cum[2 * t + 1] = (excl + v0) + v1;
    dtv[2 * t + 1] = d1;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// 1. each chunk's own end state
// ---------------------------------------------------------------------------
template <typename T, int CW>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(SsdArgs a) {
  constexpr int PW = 16 * CW;
  __shared__ float cum[MAXL], dtv[MAXL], wv[MAXL], wsum[kThreads / 32];
  __shared__ __align__(16) float sA[RS * 32];     // [key][n] B e^.. dt
  __shared__ __align__(16) T sX[2][RS * PW];      // raw x tiles
  __shared__ __align__(16) T sB[2][RS * RS];      // raw B tiles
  const int c = blockIdx.x, h = blockIdx.y;
  const int n_slabs = (a.N + RS - 1) / RS;
  const int b = blockIdx.z / n_slabs, n0 = (blockIdx.z % n_slabs) * RS;
  const int nw = min(RS, a.N - n0);
  const int L = a.L, t0 = c * L;
  const int g = h / (a.H / a.G);
  const float A = -expf(a.a_log[b * a.als + h]);
  const T* x = static_cast<const T*>(a.x) + b * a.xb + t0 * a.xs +
               static_cast<long long>(h) * a.P;
  const T* bm = static_cast<const T*>(a.bm) + b * a.bb + t0 * a.bs +
                static_cast<long long>(g) * a.N + n0;

  for (int e = threadIdx.x; e < 2 * RS * PW; e += kThreads)
    (&sX[0][0])[e] = zero<T>();  // the padding columns P..PW stay zero
  for (int e = threadIdx.x; e < 2 * RS * RS; e += kThreads)
    (&sB[0][0])[e] = zero<T>();
  chunk_cumsum(a.dt + (static_cast<long long>(b) * a.S + t0) * a.H + h, a.H,
               L, A, cum, dtv, wsum);
  const float cum_l = cum[L - 1];
  for (int j = threadIdx.x; j < L; j += kThreads)
    wv[j] = expf(cum_l - cum[j]) * dtv[j];

  const int n_tiles = (L + RS - 1) / RS;
  load_rows(sX[0], PW, x, a.xs, RS, min(RS, L), a.P, a.vx);
  load_rows(sB[0], RS, bm, a.bs, RS, min(RS, L), nw, a.vb);
  cp_commit();
  float acc[4][CW] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * RS, kv = min(RS, L - j0);
    if (t + 1 < n_tiles) {
      const int j1 = j0 + RS;
      load_rows(sX[(t + 1) & 1], PW, x + j1 * a.xs, a.xs, RS,
                min(RS, L - j1), a.P, a.vx);
      load_rows(sB[(t + 1) & 1], RS, bm + j1 * a.bs, a.bs, RS,
                min(RS, L - j1), nw, a.vb);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* sb = sB[t & 1];
    for (int e = threadIdx.x; e < RS * 32; e += kThreads) {
      const int k = e >> 5, n = e & 31;
      sA[e] = (k < kv && n < nw) ? to_f32(sb[k * RS + n]) * wv[j0 + k] : 0.f;
    }
    __syncthreads();
    mt_accum<T, CW>(acc, sA, sX[t & 1], RS);
    __syncthreads();
  }

  const long long bh = static_cast<long long>(b) * a.H + h;
  float* out = a.chunk_state + (bh * a.nc + c) * a.N * a.P;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + 4 * ty + i;
    if (n >= a.N) continue;
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) {
      const int p = CW * tx + cc;
      if (p < a.P) out[n * a.P + p] = acc[i][cc];
    }
  }
  if (n0 == 0 && threadIdx.x == 0) a.chunk_decay[bh * a.nc + c] = expf(cum_l);
}

// ---------------------------------------------------------------------------
// 2. the carried state, chunk by chunk
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256) state_pass_kernel(SsdArgs a) {
  const int np = a.N * a.P;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= np) return;
  const long long bh = blockIdx.y;
  float* cs = a.chunk_state + bh * a.nc * np + e;
  const float* dec = a.chunk_decay + bh * a.nc;
  float st = 0.f;
  for (int c0 = 0; c0 < a.nc; c0 += 8) {
    // the loads of 8 chunks first (they do not depend on the state)
    const int m = min(8, a.nc - c0);
    float local[8], d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < m) {
        local[i] = cs[static_cast<long long>(c0 + i) * np];
        d[i] = dec[c0 + i];
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < m) {
        cs[static_cast<long long>(c0 + i) * np] = st;  // chunk's start state
        st = __fadd_rn(__fmul_rn(d[i], st), local[i]);
      }
    }
  }
  const int n = e / a.P, p = e % a.P;
  a.state[bh * np + p * a.N + n] = st;
}

// ---------------------------------------------------------------------------
// 3. y, strip by strip
// ---------------------------------------------------------------------------
// C B^T for one 32 x 32 tile: bf16 on the tensor cores, f32 on the CUDA
// cores. Calls put(r, j, value) for each (row, key) of the tile once.
template <typename T>
struct Scores;

template <>
struct Scores<bf16> {
  // mma.sync m16n8k16: warp w takes rows 16*(w & 1).. and keys
  // 16*(w >> 1).. (two n8 tiles), over k-steps of 16 state dims (the
  // padding up to a multiple of 16 is zero).
  template <typename F>
  __device__ __forceinline__ static void run(const bf16* sC, const bf16* sB,
                                             int pitch, int N, F put) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int rb = 16 * (warp & 1), jb = 16 * (warp >> 1);
    float d[2][4] = {};
    for (int kb = 0; kb < N; kb += 16) {
      const bf16* c0 = sC + (rb + g) * pitch + kb + 2 * q;
      const bf16* c1 = c0 + 8 * pitch;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(c0);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(c1);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(c0 + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(c1 + 8);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const bf16* bp = sB + (jb + 8 * nt + g) * pitch + kb + 2 * q;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[nt][0]), "+f"(d[nt][1]), "+f"(d[nt][2]), "+f"(d[nt][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int j = jb + 8 * nt + 2 * q;
      put(rb + g, j, d[nt][0]);
      put(rb + g, j + 1, d[nt][1]);
      put(rb + g + 8, j, d[nt][2]);
      put(rb + g + 8, j + 1, d[nt][3]);
    }
  }
};

template <>
struct Scores<float> {
  // thread t: row t / 4, keys t % 4 + 4m
  template <typename F>
  __device__ __forceinline__ static void run(const float* sC, const float* sB,
                                             int pitch, int N, F put) {
    const int r = threadIdx.x >> 2, j0 = threadIdx.x & 3;
    float d[8] = {};
    for (int n = 0; n < N; ++n) {
      const float cv = sC[r * pitch + n];
#pragma unroll
      for (int m = 0; m < 8; ++m)
        d[m] = fmaf(cv, sB[(j0 + 4 * m) * pitch + n], d[m]);
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) put(r, j0 + 4 * m, d[m]);
  }
};

// Shared-memory pitch (elements) of the B and C rows: bf16 rows padded to a
// multiple of 16 (the mma k-step) plus 8, which also spreads the fragment
// loads over all banks; f32 rows to a multiple of 4 plus 4.
template <typename T>
__host__ __device__ constexpr int bc_pitch(int N) {
  return sizeof(T) == 2 ? (N + 15) / 16 * 16 + 8 : (N + 3) / 4 * 4 + 4;
}

template <typename T, int CW>
size_t out_smem_bytes(int N) {
  const int pn = bc_pitch<T>(N);
  return (2 * MAXL + kThreads / 32 + 2 * RS * 32 + RS * 16 * CW) *
             sizeof(float) +
         (3 * RS * pn + 2 * RS * 16 * CW) * sizeof(T);
}

template <typename T, int CW>
__global__ void __launch_bounds__(kThreads) chunk_out_kernel(SsdArgs a) {
  constexpr int PW = 16 * CW;
  extern __shared__ __align__(16) float smo[];
  const int pn = bc_pitch<T>(a.N);
  float* sS = smo;                  // [key][row] decayed scores, [RS][32]
  float* sA = sS + RS * 32;         // [n][row] C e^cum, [RS][32]
  float* sSt = sA + RS * 32;        // [n][p] incoming state tile, [RS][PW]
  float* cum = sSt + RS * PW;       // [MAXL]
  float* dtv = cum + MAXL;          // [MAXL]
  float* wsum = dtv + MAXL;         // [kThreads / 32]
  T* sC = reinterpret_cast<T*>(wsum + kThreads / 32);  // [RS][pn]
  T* sB = sC + RS * pn;             // [2][RS][pn]
  T* sX = sB + 2 * RS * pn;         // [2][RS][PW]

  const int strip = gridDim.z - 1 - blockIdx.z, c = blockIdx.y;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int L = a.L, t0 = c * L, i0 = strip * RS;
  const int rows = min(RS, L - i0);
  const int g = h / (a.H / a.G);
  const float A = -expf(a.a_log[b * a.als + h]);
  const T* x = static_cast<const T*>(a.x) + b * a.xb + t0 * a.xs +
               static_cast<long long>(h) * a.P;
  const T* bm = static_cast<const T*>(a.bm) + b * a.bb + t0 * a.bs +
                static_cast<long long>(g) * a.N;
  const T* cm = static_cast<const T*>(a.cm) + b * a.cb +
                (t0 + i0) * a.cs + static_cast<long long>(g) * a.N;

  // zero the padding (columns past N and P) before any copy lands
  for (int e = threadIdx.x; e < 3 * RS * pn + 2 * RS * PW; e += kThreads)
    sC[e] = zero<T>();
  chunk_cumsum(a.dt + (static_cast<long long>(b) * a.S + t0) * a.H + h, a.H,
               L, A, cum, dtv, wsum);

  load_rows(sC, pn, cm, a.cs, RS, rows, a.N, a.vc);
  cp_commit();
  load_rows(sB, pn, bm, a.bs, RS, min(RS, L), a.N, a.vb);
  load_rows(sX, PW, x, a.xs, RS, min(RS, L), a.P, a.vx);
  cp_commit();
  cp_wait<1>();  // the C strip
  __syncthreads();

  float acc[4][CW] = {};
  if (c > 0) {
    // (C (.) e^cum) state_in, in slabs of 32 state dims
    const long long bh = static_cast<long long>(b) * a.H + h;
    const float* st = a.chunk_state + (bh * a.nc + c) * a.N * a.P;
    for (int n0 = 0; n0 < a.N; n0 += RS) {
      for (int e = threadIdx.x; e < RS * 32; e += kThreads) {
        const int n = e >> 5, r = e & 31;
        sA[e] = (n0 + n < a.N && r < rows)
                    ? to_f32(sC[r * pn + n0 + n]) * expf(cum[i0 + r])
                    : 0.f;
      }
      for (int e = threadIdx.x; e < RS * PW; e += kThreads) {
        const int n = e / PW, p = e % PW;
        sSt[e] = (n0 + n < a.N && p < a.P) ? st[(n0 + n) * a.P + p] : 0.f;
      }
      __syncthreads();
      mt_accum<float, CW>(acc, sA, sSt, RS);
      __syncthreads();
    }
  }

  // the causal part: key tiles j0 = 0, 32, .., i0 (the last one diagonal)
  const int n_tiles = strip + 1;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * RS;
    if (t + 1 < n_tiles) {
      const int j1 = j0 + RS, kv1 = min(RS, L - j1);
      load_rows(sB + ((t + 1) & 1) * RS * pn, pn, bm + j1 * a.bs, a.bs, RS,
                kv1, a.N, a.vb);
      load_rows(sX + ((t + 1) & 1) * RS * PW, PW, x + j1 * a.xs, a.xs, RS,
                kv1, a.P, a.vx);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    Scores<T>::run(sC, sB + (t & 1) * RS * pn, pn, a.N,
                   [&](int r, int jl, float v) {
                     const int i = i0 + r, j = j0 + jl;
                     sS[jl * 32 + r] =
                         (r < rows && j <= i)
                             ? v * expf(cum[i] - cum[j]) * dtv[j]
                             : 0.f;
                   });
    __syncthreads();
    mt_accum<T, CW>(acc, sS, sX + (t & 1) * RS * PW, RS);
    __syncthreads();
  }

  T* y = static_cast<T*>(a.y) +
         ((static_cast<long long>(b) * a.S + t0 + i0) * a.H + h) * a.P;
  const long long yrow = static_cast<long long>(a.H) * a.P;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) {
      const int p = CW * tx + cc;
      if (p < a.P) store(y + r * yrow + p, acc[i][cc]);
    }
  }
}

template <typename T, int CW>
int launch(const SsdArgs& a, int B, cudaStream_t stream) {
  const dim3 g1(a.nc, a.H, B * ((a.N + RS - 1) / RS));
  chunk_state_kernel<T, CW><<<g1, kThreads, 0, stream>>>(a);
  const dim3 g2((a.N * a.P + 255) / 256, B * a.H);
  state_pass_kernel<<<g2, 256, 0, stream>>>(a);
  const size_t smem = out_smem_bytes<T, CW>(a.N);
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        chunk_out_kernel<T, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const dim3 g3(B * a.H, a.nc, (a.L + RS - 1) / RS);
  chunk_out_kernel<T, CW><<<g3, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const SsdArgs& a, int B, cudaStream_t stream) {
  if (a.P <= 16) return launch<T, 1>(a, B, stream);
  if (a.P <= 32) return launch<T, 2>(a, B, stream);
  if (a.P <= 64) return launch<T, 4>(a, B, stream);
  return launch<T, 8>(a, B, stream);
}

bool aligned16(const void* p, long long s0, long long s1, int width,
               int itemsize) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (s0 * itemsize) % 16 == 0 && (s1 * itemsize) % 16 == 0 &&
         (static_cast<long long>(width) * itemsize) % 16 == 0;
}

}  // namespace

// Plain C entry point (bound with ctypes). x, B, C and y in f32 (dtype 0) or
// bf16 (dtype 1); dt [B,S,H] f32, contiguous; a_log f32, batch row b's
// head h at a_log[b * a_log_stride + h] (stride 0: one [H] for every row,
// H: a contiguous [B,H], one per row); y [B,S,H,P] and
// state [B,H,P,N] contiguous outputs; chunk_state [B,H,S/L,N,P] and
// chunk_decay [B,H,S/L] f32 scratch; strides[6] = (batch, seq) strides of
// x, B and C in elements, their last two dims contiguous. S % L == 0,
// H % G == 0, P <= 128, N <= 256, L <= 256, B*H <= 65535. Three launches
// on `stream`; does not synchronize, and returns cudaGetLastError() (0 on
// success).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a_log,
                               const void* bm, const void* cm, void* y,
                               void* state, void* chunk_state,
                               void* chunk_decay, int B, int S, int H, int P,
                               int G, int N, int L, const long long* strides,
                               int a_log_stride, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 ||
      P > MAXP || N < 1 || N > MAXN || L < 1 || L > MAXL || S % L != 0 ||
      a_log_stride < 0 ||
      static_cast<long long>(B) * H > 65535 || S / L > 65535 ||
      static_cast<long long>(B) * ((N + RS - 1) / RS) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  SsdArgs a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.a_log = static_cast<const float*>(a_log);
  a.bm = bm;
  a.cm = cm;
  a.y = y;
  a.state = static_cast<float*>(state);
  a.chunk_state = static_cast<float*>(chunk_state);
  a.chunk_decay = static_cast<float*>(chunk_decay);
  a.S = S;
  a.H = H;
  a.P = P;
  a.G = G;
  a.N = N;
  a.L = L;
  a.nc = S / L;
  a.als = a_log_stride;
  a.xb = strides[0];
  a.xs = strides[1];
  a.bb = strides[2];
  a.bs = strides[3];
  a.cb = strides[4];
  a.cs = strides[5];
  const int is = dtype == 0 ? 4 : 2;
  a.vx = aligned16(x, a.xb, a.xs, P, is);
  a.vb = aligned16(bm, a.bb, a.bs, N, is);
  a.vc = aligned16(cm, a.cb, a.cs, N, is);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, s);
  if (dtype == 1) return dispatch<bf16>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
