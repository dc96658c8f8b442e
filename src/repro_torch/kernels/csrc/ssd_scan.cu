// Mamba-2 SSD chunked scan for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_scan_pallas / _ssd_kernel). Per chunk c of Q rows, with
// cum = in-chunk prefix sum of dt*A and L[i,j] = exp(cum_i - cum_j) for j <= i:
//
//   S_c     = x^T (B ⊙ exp(cum_{Q-1} - cum_j) dt_j)                 (P, N)
//   h_c     = exp(cum_{Q-1}) h_{c-1} + S_c,   h_{-1} = initial state
//   y       = (C B^T ⊙ L ⊙ dt_j) x  +  (C ⊙ exp(cum_i)) h_{c-1}^T
//
// Head h reads B/C group h / (H/G), by index. S is zero-padded to a
// multiple of Q: rows past S read x = B = C = 0 and dt = 0 (no decay, no
// update), so the final state is the unpadded one. Layout as the JAX
// package's: x (B,S,H,P) and y (B,S,H,P) in x's dtype (f32 or bf16), dt
// (B,S,H) f32, A (H,) f32, B/C (B,S,G,N) in x's dtype, h0/h_out (B,H,P,N)
// f32. x, dt and B/C are read through their batch and sequence strides (the
// model hands in views of one projection), so no transposed copy is made.
//
// What bounds it on this card: at the serving path's shapes (bf16, Q=256,
// S=2048, B=4; hymba H=50, P=64, N=16 and mamba2 H=24, P=64, N=128) the
// products need 10-16 GFLOP against 58-107 MB. On the CUDA cores (67
// TFLOP/s fp32) that is far above the bytes' time; on the tensor cores it
// is near it. The sequential part, the state carried from chunk to chunk,
// is only n x P x N multiply-adds per head. So the scan runs in the
// chunk-parallel form of the SSD paper (Dao & Gu 2024, "Transformers are
// SSMs"), as models/ssd.py's ssd_chunked_reference spells it out, in three
// launches on the stream (four for N >= 64):
//
//  1. chunk_state_kernel, one block per (b, chunk, h, 64 rows of P, a tile of
//     N): the prefix sum cum (warp 0: per-lane runs of dt*A joined by a warp
//     scan, as the sequential kernel of the first port did), written to a
//     scratch for the later launches, then S_c as a Q-deep product
//     x^T (B ⊙ w) on the tensor cores (mma.sync m16n8k8, tf32), in 64-row
//     slices of the chunk staged through shared memory; the next slice's
//     loads are in flight (in registers) while this one's products run.
//  2. state_pass_kernel, one thread per (b, h, p, n): walks the n chunks in
//     order, overwriting S_c with h_{c-1} (the state entering chunk c) and
//     writing the final state. fp32 FMAs; it moves 2 x n x P x N floats.
//  3a. for N >= 64 only, chunk_cb_kernel, one block per (b, chunk, group,
//     64 x 64 tile at or below the diagonal): C B^T once per group into a
//     scratch, which every head of the group then reads (H/G = 24 heads at
//     mamba2's shape); at smaller N the output kernel forms it itself, as
//     the (Q, Q) scratch would cost more bytes than the product.
//  3. chunk_output_kernel, one block per (b, chunk, h, 64 rows i, 64 columns
//     of P), the heaviest row tiles first: C's 64 rows stay in shared memory;
//     the inter-chunk term C h_{c-1}^T is a tensor-core product scaled by
//     exp(cum_i) (skipped for the first chunk without an initial state); for
//     each 64-row tile j at or below the diagonal, S = C B_j^T on the tensor
//     cores (or read from 3a's scratch), the weights W = S ⊙ L ⊙ dt_j
//     formed in the accumulator registers with the mask applied BEFORE the
//     exp (above the diagonal cum_i - cum_j > 0 can overflow to inf, and
//     inf * 0 would be NaN), then y += W x_j with W fed from those
//     registers as the A operand: the (Q, Q) weight tile is never written
//     to memory. A permutation of the
//     k index (keys 2t, 2t+1 of the accumulator stand for k = t, t+4 of the
//     tf32 A fragment, and x's rows are read in the same order) lets the
//     accumulator layout serve as the A fragment without a shuffle. x_j
//     and B_j stream through registers one slice ahead of the products, in
//     16-byte loads where the layout allows (checked on the host).
// The wrapper allocates the scratches (cum: n x Q floats per (b, h); chunk
// states: n x P x N floats per (b, h); for N >= 64, C B^T: n x Q x Q floats
// per (b, group)); the kernels allocate nothing.
//
// Precision of each product, bf16 inputs (the serving path): C B^T
// multiplies two bf16 operands, mma.sync m16n8k16 bf16 -> fp32 (exact
// products, fp32 sums). The products with an fp32 operand (W x, C h^T and
// x^T (B ⊙ w)) run as one tf32 product: the fp32 operand is rounded to tf32
// (10-bit mantissa, finer than the bf16 inputs' 7), the bf16 operand is
// exact in tf32, and sums are fp32. fp32 inputs run every product as 3xTF32
// (a = a_hi + a_lo, a b ≈ a_lo b_hi + a_hi b_lo + a_hi b_hi), which keeps
// fp32-grade accuracy. cum, L, the state pass and every sum are fp32.
//
// Entry: ssd_scan_fwd(...) launches the three (four) kernels on the given
// stream, does not synchronise or allocate, and returns the first launch
// error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // 4 warps; warp w owns rows 16w..16w+15 of a 64-row tile
constexpr int kT = 64;         // rows of a tile: chunk rows i or j, state rows p
constexpr int kPassThreads = 256;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* h0;  // may be null: start from zeros
  void* y;
  float* hout;
  float* cum;     // scratch (B, H, n, Q): in-chunk prefix sums of dt*A
  float* states;  // scratch (B, H, n, P, N): S_c, then h_{c-1}
  float* cb;      // scratch (B, n, G, Q, Q): C B^T once per chunk and group, or null
  int B, S, H, P, G, N, Q, n_chunks;
  int64_t sxb, sxs, sdb, sds, sbb, sbs;  // batch / sequence strides (elements)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b (16x8x8) from fp32 fragments: TERMS = 1 rounds both to tf32
// (an operand widened from bf16 is exact in tf32: A_EXACT / B_EXACT skip
// its rounding); TERMS = 3 splits each into hi + lo tf32 parts (3xTF32,
// fp32-grade).
template <int TERMS, bool A_EXACT = false, bool B_EXACT = false>
__device__ __forceinline__ void mma_f32(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  uint32_t ah[4], bh[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) ah[i] = (TERMS == 1 && A_EXACT) ? __float_as_uint(a[i]) : tf32(a[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) bh[i] = (TERMS == 1 && B_EXACT) ? __float_as_uint(b[i]) : tf32(b[i]);
  if (TERMS == 3) {
    uint32_t al[4], bl[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) al[i] = tf32(a[i] - __uint_as_float(ah[i]));
#pragma unroll
    for (int i = 0; i < 2; ++i) bl[i] = tf32(b[i] - __uint_as_float(bh[i]));
    mma_tf32(d, al, bh);
    mma_tf32(d, ah, bl);
  }
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats of a shared row (8-byte aligned) as a bf16 pair; exact when
// they were widened from bf16.
__device__ __forceinline__ uint32_t pack_bf16(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  __nv_bfloat162 t = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<uint32_t*>(&t);
}

// ROWS x COLS of a global slab (row r at src + r * row_stride elements),
// held in registers on its way to a shared fp32 tile with row stride ld (a
// multiple of 4 floats): fetch issues every load of a thread at once, so
// their latencies overlap (and overlap whatever runs before put); rows at or
// past valid_rows and columns at or past width read zero. VEC: src,
// row_stride and width are multiples of 16 bytes' worth of elements, and
// each load moves 16 bytes; otherwise one element a load.
template <int ROWS, int COLS, bool VEC, typename T>
struct Staged {
  static constexpr int kV = VEC ? 16 / sizeof(T) : 1;  // elements a load
  static constexpr int kPer = COLS / kV;               // loads per row
  static constexpr int kIters = ROWS * kPer / kThreads;
  static_assert(COLS % kV == 0 && ROWS * kPer % kThreads == 0, "whole loads per thread");
  using Piece = typename std::conditional<VEC, uint4, float>::type;
  Piece v[kIters];

  __device__ __forceinline__ void fetch(const T* src, int64_t row_stride, int valid_rows,
                                        int width) {
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int e = k * kThreads + threadIdx.x, r = e / kPer, c = (e % kPer) * kV;
      const bool in = r < valid_rows && c < width;
      if constexpr (VEC)
        v[k] = in ? *reinterpret_cast<const uint4*>(src + (int64_t)r * row_stride + c)
                  : make_uint4(0u, 0u, 0u, 0u);
      else
        v[k] = in ? to_f(src[(int64_t)r * row_stride + c]) : 0.f;
    }
  }

  // With row_scale, row r is multiplied by row_scale[r] (rows at or past
  // scale_rows by zero) on its way into shared memory.
  __device__ __forceinline__ void put(float* dst, int ld, const float* row_scale = nullptr,
                                      int scale_rows = 0) const {
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int e = k * kThreads + threadIdx.x, r = e / kPer, c = (e % kPer) * kV;
      const float m = row_scale == nullptr ? 1.f : (r < scale_rows ? row_scale[r] : 0.f);
      float* d = dst + r * ld + c;
      if constexpr (!VEC) {
        *d = v[k] * m;
      } else if constexpr (sizeof(T) == 2) {
        const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&v[k]);
        const float2 f0 = __bfloat1622float2(hv[0]), f1 = __bfloat1622float2(hv[1]);
        const float2 f2 = __bfloat1622float2(hv[2]), f3 = __bfloat1622float2(hv[3]);
        *reinterpret_cast<float4*>(d) = make_float4(f0.x * m, f0.y * m, f1.x * m, f1.y * m);
        *reinterpret_cast<float4*>(d + 4) = make_float4(f2.x * m, f2.y * m, f3.x * m, f3.y * m);
      } else {
        const float4 f = *reinterpret_cast<const float4*>(&v[k]);
        *reinterpret_cast<float4*>(d) = make_float4(f.x * m, f.y * m, f.z * m, f.w * m);
      }
    }
  }
};

// Fetch and put at once, for a tile nothing can overlap.
template <int ROWS, int COLS, bool VEC, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int64_t row_stride,
                                          int valid_rows, int width) {
  Staged<ROWS, COLS, VEC, T> tile;
  tile.fetch(src, row_stride, valid_rows, width);
  tile.put(dst, ld);
}

// Rows of chunk c that exist: min(Q, S - c*Q).
__device__ __forceinline__ int chunk_rows(const Params& p, int c) {
  return min(p.Q, p.S - c * p.Q);
}

// ---------------------------------------------------------------------------
// 1. chunk states: S_c = x^T (B ⊙ w), w_j = exp(cum_{Q-1} - cum_j) dt_j
// ---------------------------------------------------------------------------

// NT = columns of N per block (16 or 64); TERMS as in mma_f32; VEC as in
// load_tile for x and B
template <typename T, int NT, int TERMS, bool VEC>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLdx = kT + 8;   // x tile [j][p]: A fragments read 8t + g, no conflict
  constexpr int kLdb = NT + 8;   // B tile [j][n]
  const int Q = p.Q, q4 = (p.Q + 3) & ~3;
  float* cum_s = smem;            // [Q]
  float* w_s = cum_s + q4;        // [Q] dt, then w
  float* xs = w_s + q4;           // [kT][kLdx]
  float* bs = xs + kT * kLdx;     // [kT][kLdb]

  const int c = blockIdx.x, b = blockIdx.z;
  const int n_nt = (p.N + NT - 1) / NT, n_pt = (p.P + kT - 1) / kT;
  const int h = blockIdx.y / (n_pt * n_nt);
  const int pt = (blockIdx.y / n_nt) % n_pt, nt = blockIdx.y % n_nt;
  const int grp = h / (p.H / p.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rows = chunk_rows(p, c);
  const int64_t c0 = (int64_t)c * Q;
  const float a_h = p.A[h];

  for (int r = tid; r < Q; r += kThreads)
    w_s[r] = r < rows ? p.dt[b * p.sdb + (c0 + r) * p.sds + h] : 0.f;
  __syncthreads();
  if (tid < 32) {  // warp 0: inclusive prefix sum of dt*A, a run per lane
    const int per = (Q + 31) / 32;
    const int lo = min(Q, tid * per), hi = min(Q, lo + per);
    float run = 0.f;
    for (int r = lo; r < hi; ++r) {
      run += w_s[r] * a_h;
      cum_s[r] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    const float base = incl - run;
    for (int r = lo; r < hi; ++r) cum_s[r] += base;
  }
  __syncthreads();
  const float total = cum_s[Q - 1];
  float* cum_g = p.cum + (((int64_t)b * p.H + h) * p.n_chunks + c) * Q;
  for (int r = tid; r < Q; r += kThreads) {
    w_s[r] = expf(total - cum_s[r]) * w_s[r];
    if (pt == 0 && nt == 0) cum_g[r] = cum_s[r];
  }

  const T* xg = static_cast<const T*>(p.x) + b * p.sxb + c0 * p.sxs + (int64_t)h * p.P + pt * kT;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.sbb + c0 * p.sbs + (int64_t)grp * p.N + nt * NT;
  float acc[NT / 8][4];
#pragma unroll
  for (int i = 0; i < NT / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int prow = warp * 16 + g;  // this thread's state rows: prow, prow + 8
  // the next 64-row slice of x and B streams through registers while this
  // one's products run; B is scaled by w on its way into shared memory
  Staged<kT, kT, VEC, T> x_next;
  Staged<kT, NT, VEC, T> b_next;
  x_next.fetch(xg, p.sxs, rows, p.P - pt * kT);
  b_next.fetch(bg, p.sbs, rows, p.N - nt * NT);
  for (int j0 = 0; j0 < rows; j0 += kT) {
    __syncthreads();  // the previous slice's readers are done (and w_s is written)
    x_next.put(xs, kLdx);
    b_next.put(bs, kLdb, w_s + j0, Q - j0);
    __syncthreads();
    if (j0 + kT < rows) {
      x_next.fetch(xg + (j0 + kT) * p.sxs, p.sxs, rows - j0 - kT, p.P - pt * kT);
      b_next.fetch(bg + (j0 + kT) * p.sbs, p.sbs, rows - j0 - kT, p.N - nt * NT);
    }
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk) {
      const float* x0 = xs + (kk * 8 + t) * kLdx + prow;
      const float* x4 = x0 + 4 * kLdx;
      const float a[4] = {x0[0], x0[8], x4[0], x4[8]};
#pragma unroll
      for (int i = 0; i < NT / 8; ++i) {
        const float* b0 = bs + (kk * 8 + t) * kLdb + i * 8 + g;
        const float bb[2] = {b0[0], b0[4 * kLdb]};
        mma_f32<TERMS, sizeof(T) == 2, false>(acc[i], a, bb);
      }
    }
  }

  float* sg = p.states + (((int64_t)b * p.H + h) * p.n_chunks + c) * p.P * p.N;
  const int p0 = pt * kT + prow;
#pragma unroll
  for (int i = 0; i < NT / 8; ++i) {
    const int n = nt * NT + i * 8 + 2 * t;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pp = p0 + (q >> 1) * 8, nn = n + (q & 1);
      if (pp < p.P && nn < p.N) sg[(int64_t)pp * p.N + nn] = acc[i][q];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. state passing: h_c = exp(cum_{Q-1}) h_{c-1} + S_c, in chunk order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPassThreads) state_pass_kernel(const Params p) {
  constexpr int kBatch = 8;  // chunks whose loads are issued together
  const int64_t pn = (int64_t)p.P * p.N;
  const int64_t e = (int64_t)blockIdx.x * kPassThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= pn) return;
  const int64_t bh = (int64_t)b * p.H + h;
  float state = p.h0 != nullptr ? p.h0[bh * pn + e] : 0.f;
  const float* cum_end = p.cum + bh * p.n_chunks * p.Q + p.Q - 1;  // chunk c: [c * Q]
  float* sp = p.states + bh * p.n_chunks * pn + e;
  for (int c0 = 0; c0 < p.n_chunks; c0 += kBatch) {
    float s_c[kBatch], decay[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c0 + k < p.n_chunks) {
        s_c[k] = sp[(c0 + k) * pn];
        decay[k] = cum_end[(int64_t)(c0 + k) * p.Q];
      }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c0 + k < p.n_chunks) {
        sp[(c0 + k) * pn] = state;  // the state entering chunk c0 + k
        state = state * expf(decay[k]) + s_c[k];
      }
  }
  p.hout[bh * pn + e] = state;
}

// ---------------------------------------------------------------------------
// 3. chunk output: y = (C B^T ⊙ L ⊙ dt) x + (C ⊙ exp(cum)) h_{c-1}^T
// ---------------------------------------------------------------------------

// s (16 rows i of this warp x 64 columns j) += C_i B_j^T over one NS-wide
// slice of N: c_row is this thread's first C row at the slice (row stride
// ldc), bs the staged B slice [j][n] (row stride NS + 4). bf16 inputs: bf16
// mma (exact products); fp32: 3xTF32.
template <typename T, int NS>
__device__ __forceinline__ void cb_slice(float (&s)[8][4], const float* c_row, int ldc,
                                         const float* bs, int g, int t) {
  constexpr int kLds = NS + 4;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk) {
      const float* c_0 = c_row + kk * 16 + 2 * t;
      const uint32_t a[4] = {pack_bf16(c_0), pack_bf16(c_0 + 8 * ldc), pack_bf16(c_0 + 8),
                             pack_bf16(c_0 + 8 * ldc + 8)};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float* b_0 = bs + (i * 8 + g) * kLds + kk * 16 + 2 * t;
        const uint32_t bb[2] = {pack_bf16(b_0), pack_bf16(b_0 + 8)};
        mma_bf16(s[i], a, bb);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < NS / 8; ++kk) {
      const float* c_0 = c_row + kk * 8 + t;
      const float a[4] = {c_0[0], c_0[8 * ldc], c_0[4], c_0[8 * ldc + 4]};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float* b_0 = bs + (i * 8 + g) * kLds + kk * 8 + t;
        const float bb[2] = {b_0[0], b_0[4]};
        mma_f32<3>(s[i], a, bb);
      }
    }
  }
}

// Where C B^T of chunk c and group grp keeps row i, column j in the scratch.
__device__ __forceinline__ float* cb_at(const Params& p, int b, int c, int grp, int i, int j) {
  return p.cb + ((((int64_t)b * p.n_chunks + c) * p.G + grp) * p.Q + i) * p.Q + j;
}

// This thread's accumulator-layout share of the C B^T tile at column j0
// (rows row0 and row0 + 8): zero above the diagonal and past the chunk.
__device__ __forceinline__ void fetch_cb(float (&s)[8][4], const Params& p, int b, int c,
                                         int grp, int row0, int j0, int t) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ii = row0 + (q >> 1) * 8, jj = j0 + i * 8 + 2 * t + (q & 1);
      s[i][q] = (ii < p.Q && jj <= ii) ? *cb_at(p, b, c, grp, ii, jj) : 0.f;
    }
}

// C B^T once per (batch, chunk, group), for the output kernel of every head
// of the group: one block per 64 x 64 tile (i, j) at or below the diagonal.
// Used for large N, where the product is most of the output kernel's work.
template <typename T, int NS, bool VEC>
__global__ void __launch_bounds__(kThreads) chunk_cb_kernel(const Params p) {
  constexpr int kLds = NS + 4;
  extern __shared__ __align__(16) float smem[];
  const int n_pad = (p.N + NS - 1) / NS * NS;
  const int ldc = n_pad + 4;
  float* cs = smem;           // [kT][ldc]   C rows of tile i
  float* bs = cs + kT * ldc;  // [kT][kLds]  a slice of B rows of tile j
  int it = 0;                 // blockIdx.x counts the pairs (it, jt <= it) row by row
  while ((it + 1) * (it + 2) / 2 <= (int)blockIdx.x) ++it;
  const int jt = blockIdx.x - it * (it + 1) / 2;
  const int c = blockIdx.y % p.n_chunks, grp = blockIdx.y / p.n_chunks, b = blockIdx.z;
  const int i0 = it * kT, j0 = jt * kT, rows = chunk_rows(p, c);
  if (i0 >= rows) return;  // a tile wholly past S (whole block: no barrier is skipped)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t c0 = (int64_t)c * p.Q;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.sbb + (c0 + i0) * p.sbs + (int64_t)grp * p.N;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.sbb + (c0 + j0) * p.sbs + (int64_t)grp * p.N;
  for (int n0 = 0; n0 < n_pad; n0 += NS)
    load_tile<kT, NS, VEC>(cs + n0, ldc, cg + n0, p.sbs, rows - i0, p.N - n0);
  const int irow = warp * 16 + g;
  float s[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
  for (int n0 = 0; n0 < n_pad; n0 += NS) {
    __syncthreads();  // the C tile is in; readers of bs are done
    load_tile<kT, NS, VEC>(bs, kLds, bg + n0, p.sbs, rows - j0, p.N - n0);
    __syncthreads();
    cb_slice<T, NS>(s, cs + irow * ldc + n0, ldc, bs, g, t);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ii = i0 + irow + (q >> 1) * 8, jj = j0 + i * 8 + 2 * t + (q & 1);
      if (ii < p.Q && jj < p.Q) *cb_at(p, b, c, grp, ii, jj) = s[i][q];
    }
}


// NS = columns of N per staged slice of C, B or h (16, 32 or 64); VEC as in
// load_tile for x, B, C and h. CB: C B^T comes from chunk_cb_kernel's
// scratch (one step ahead in registers) instead of being formed here.
template <typename T, int NS, bool VEC, bool CB>
__global__ void __launch_bounds__(kThreads, NS == 16 ? 4 : 1) chunk_output_kernel(const Params p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int TERMS = kBf16 ? 1 : 3;
  constexpr int kLds = NS + 4;   // B slice [j][n] and h slice [p][n]
  constexpr int kLdx = kT + 4;   // x tile [j][p]: B fragments read 8t + g, no conflict
  extern __shared__ __align__(16) float smem[];
  const int Q = p.Q, q4 = (p.Q + 3) & ~3;
  const int n_pad = (p.N + NS - 1) / NS * NS;
  const int ldc = n_pad + 4;     // C tile [i][n]
  float* cum_s = smem;           // [Q]
  float* dt_s = cum_s + q4;      // [Q]
  float* cs = dt_s + q4;         // [kT][ldc]
  float* ss = cs + kT * ldc;     // [kT][kLds]
  float* xs = ss + kT * kLds;    // [kT][kLdx]

  const int n_pt = (p.P + kT - 1) / kT;
  const int h = blockIdx.x / n_pt, pt = blockIdx.x % n_pt;
  const int c = blockIdx.y % p.n_chunks, b = blockIdx.y / p.n_chunks;
  const int it = gridDim.z - 1 - blockIdx.z;  // the heaviest row tiles first
  const int i0 = it * kT;
  const int rows = chunk_rows(p, c);
  if (i0 >= rows) return;  // a tile wholly past S (whole block: no barrier is skipped)
  const int grp = h / (p.H / p.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t c0 = (int64_t)c * Q;
  const int64_t bh = (int64_t)b * p.H + h;
  const int i_end = min(Q, i0 + kT);

  const float* cum_g = p.cum + (bh * p.n_chunks + c) * Q;
  for (int r = tid; r < i_end; r += kThreads) {
    cum_s[r] = cum_g[r];
    dt_s[r] = r < rows ? p.dt[b * p.sdb + (c0 + r) * p.sds + h] : 0.f;
  }
  const T* cg = static_cast<const T*>(p.Cm) + b * p.sbb + c0 * p.sbs + (int64_t)grp * p.N;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.sbb + c0 * p.sbs + (int64_t)grp * p.N;
  const T* xg = static_cast<const T*>(p.x) + b * p.sxb + c0 * p.sxs + (int64_t)h * p.P + pt * kT;
  const bool inter = c > 0 || p.h0 != nullptr;  // h_{c-1} is not zero
  if (!CB || inter)
    for (int n0 = 0; n0 < n_pad; n0 += NS)
      load_tile<kT, NS, VEC>(cs + n0, ldc, cg + i0 * p.sbs + n0, p.sbs, rows - i0, p.N - n0);

  const int irow = warp * 16 + g;  // this thread's rows in the tile: irow, irow + 8
  // x_j and the B slices (or the C B^T tile) stream through registers one
  // step ahead: the next step's loads are in flight while this one's
  // products run (the first ones while the inter-chunk term runs)
  Staged<kT, kT, VEC, T> x_next;
  Staged<kT, NS, VEC, T> b_next;
  float s_next[8][4];
  x_next.fetch(xg, p.sxs, rows, p.P - pt * kT);
  if constexpr (CB)
    fetch_cb(s_next, p, b, c, grp, i0 + irow, 0, t);
  else
    b_next.fetch(bg, p.sbs, rows, p.N);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // inter-chunk term: (C h_{c-1}^T) scaled by exp(cum_i); h_{-1} = 0 without h0
  if (inter) {
    const float* hg = p.states + (bh * p.n_chunks + c) * p.P * p.N + (int64_t)pt * kT * p.N;
    for (int n0 = 0; n0 < n_pad; n0 += NS) {
      __syncthreads();
      load_tile<kT, NS, VEC>(ss, kLds, hg + n0, p.N, p.P - pt * kT, p.N - n0);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < NS / 8; ++kk) {
        const float* c_0 = cs + irow * ldc + n0 + kk * 8 + t;
        const float a[4] = {c_0[0], c_0[8 * ldc], c_0[4], c_0[8 * ldc + 4]};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float* h_0 = ss + (i * 8 + g) * kLds + kk * 8 + t;
          const float bb[2] = {h_0[0], h_0[4]};
          mma_f32<TERMS, kBf16, false>(acc[i], a, bb);
        }
      }
    }
    __syncthreads();  // cum_s is visible (also when the loop above is empty)
    const float e0 = i0 + irow < Q ? expf(cum_s[i0 + irow]) : 0.f;
    const float e1 = i0 + irow + 8 < Q ? expf(cum_s[i0 + irow + 8]) : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][0] *= e0;
      acc[i][1] *= e0;
      acc[i][2] *= e1;
      acc[i][3] *= e1;
    }
  }

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT;
    float s[8][4];  // C B_j^T, then the weights W
    if constexpr (CB) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[i][q] = s_next[i][q];
      __syncthreads();  // readers of xs (and of cum_s, dt_s) are done
      x_next.put(xs, kLdx);
      __syncthreads();
      if (jt < it) {
        x_next.fetch(xg + (j0 + kT) * p.sxs, p.sxs, rows - j0 - kT, p.P - pt * kT);
        fetch_cb(s_next, p, b, c, grp, i0 + irow, j0 + kT, t);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      for (int n0 = 0; n0 < n_pad; n0 += NS) {
        __syncthreads();  // readers of ss (and of xs, cum_s, dt_s) are done
        if (n0 == 0) x_next.put(xs, kLdx);
        b_next.put(ss, kLds);
        __syncthreads();
        if (n0 + NS < n_pad) {
          b_next.fetch(bg + j0 * p.sbs + n0 + NS, p.sbs, rows - j0, p.N - n0 - NS);
        } else if (jt < it) {
          x_next.fetch(xg + (j0 + kT) * p.sxs, p.sxs, rows - j0 - kT, p.P - pt * kT);
          b_next.fetch(bg + (j0 + kT) * p.sbs, p.sbs, rows - j0 - kT, p.N);
        }
        cb_slice<T, NS>(s, cs + irow * ldc + n0, ldc, ss, g, t);
      }
    }

    // W = S ⊙ exp(cum_i - cum_j) ⊙ dt_j for j <= i: the mask comes first
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ii = i0 + irow + (q >> 1) * 8;
        const int jj = j0 + i * 8 + 2 * t + (q & 1);
        s[i][q] = (jj <= ii && ii < Q) ? s[i][q] * expf(cum_s[ii] - cum_s[jj]) * dt_s[jj] : 0.f;
      }

    // y += W x_j: accumulator keys 2t, 2t+1 of block kk are the fragment's k = t, t+4
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float* x_0 = xs + (kk * 8 + 2 * t) * kLdx + i * 8 + g;
        const float bb[2] = {x_0[0], x_0[kLdx]};
        mma_f32<TERMS, false, kBf16>(acc[i], a, bb);
      }
    }
  }

  T* yg = static_cast<T*>(p.y) + ((int64_t)b * p.S + c0) * p.H * p.P + (int64_t)h * p.P;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ii = i0 + irow + (q >> 1) * 8;
      const int pp = pt * kT + i * 8 + 2 * t + (q & 1);
      if (ii < rows && pp < p.P) store(yg + (int64_t)ii * p.H * p.P + pp, acc[i][q]);
    }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_all(const Params& p, cudaStream_t stream) {
  constexpr int kTerms = sizeof(T) == 2 ? 1 : 3;
  const int n_pt = (p.P + kT - 1) / kT;
  const size_t q_floats = 2 * (size_t)((p.Q + 3) & ~3);
  cudaError_t err;
  if (p.N <= 16) {
    const size_t smem = (q_floats + kT * (kT + 8) + kT * (16 + 8)) * sizeof(float);
    err = launch(chunk_state_kernel<T, 16, kTerms, VEC>,
                 dim3(p.n_chunks, p.H * n_pt * ((p.N + 15) / 16), p.B), kThreads, smem, p,
                 stream);
  } else {
    const size_t smem = (q_floats + kT * (kT + 8) + kT * (64 + 8)) * sizeof(float);
    err = launch(chunk_state_kernel<T, 64, kTerms, VEC>,
                 dim3(p.n_chunks, p.H * n_pt * ((p.N + 63) / 64), p.B), kThreads, smem, p,
                 stream);
  }
  if (err != cudaSuccess) return err;

  const int64_t pn = (int64_t)p.P * p.N;
  state_pass_kernel<<<dim3((unsigned)((pn + kPassThreads - 1) / kPassThreads), p.H, p.B),
                      kPassThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_it = (p.Q + kT - 1) / kT;
  const dim3 grid(p.H * n_pt, p.n_chunks * p.B, n_it);
  if (p.N <= 16) {
    const size_t smem =
        (q_floats + kT * (16 + 4) + kT * (16 + 4) + kT * (kT + 4)) * sizeof(float);
    return launch(chunk_output_kernel<T, 16, VEC, false>, grid, kThreads, smem, p, stream);
  }
  if (p.N <= 32) {
    const size_t smem =
        (q_floats + kT * (32 + 4) + kT * (32 + 4) + kT * (kT + 4)) * sizeof(float);
    return launch(chunk_output_kernel<T, 32, VEC, false>, grid, kThreads, smem, p, stream);
  }
  const int n_pad = (p.N + 63) / 64 * 64;
  const size_t smem =
      (q_floats + kT * (n_pad + 4) + kT * (64 + 4) + kT * (kT + 4)) * sizeof(float);
  if (p.cb == nullptr)
    return launch(chunk_output_kernel<T, 64, VEC, false>, grid, kThreads, smem, p, stream);
  err = launch(chunk_cb_kernel<T, 64, VEC>, dim3(n_it * (n_it + 1) / 2, p.n_chunks * p.G, p.B),
               kThreads, (kT * (n_pad + 4) + kT * (64 + 4)) * sizeof(float), p, stream);
  if (err != cudaSuccess) return err;
  return launch(chunk_output_kernel<T, 64, VEC, true>, grid, kThreads, smem, p, stream);
}

// Whether every 16-byte piece load_tile would read is aligned: the bases of
// x, B and C, their strides and head/group offsets, P and N all whole
// pieces (the chunk-state scratch then is too: its rows are N floats).
template <typename T>
bool vector_loads(const Params& p) {
  constexpr int kV = 16 / sizeof(T);
  const bool bases = reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(p.Bm) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(p.Cm) % 16 == 0;
  return bases && p.sxb % kV == 0 && p.sxs % kV == 0 && p.sbb % kV == 0 && p.sbs % kV == 0 &&
         p.P % kV == 0 && p.N % kV == 0;
}

template <typename T>
cudaError_t launch_typed(const Params& p, cudaStream_t stream) {
  return vector_loads<T>(p) ? launch_all<T, true>(p, stream) : launch_all<T, false>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y). 1 <= Q <= 2048,
// N <= 256, H a multiple of G, the inner dims packed, and the scratches
// cum (B, H, n, Q) and states (B, H, n, P, N) f32 with n = ceil(S / Q), and
// cb (B, n, G, Q, Q) f32 where the wrapper computes C B^T once per group
// (N >= 64; null otherwise, and then the output kernel forms it); the
// Python wrapper checks and allocates all of it before the call. h0 may be
// null.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                            const void* Bm, const void* Cm, const float* h0,
                            void* y, float* hout, float* cum, float* states, float* cb,
                            int dtype,
                            int B, int S, int H, int P, int G, int N, int Q, int64_t sxb,
                            int64_t sxs, int64_t sdb, int64_t sds, int64_t sbb, int64_t sbs,
                            void* stream) {
  if (Q < 1 || Q > 2048 || N < 1 || N > 256 || G < 1 || H % G || S < 1 ||
      (cb != nullptr && N <= 32))
    return (int)cudaErrorInvalidValue;
  const Params p{x, dt, A, Bm, Cm, h0, y, hout, cum, states, cb,
                 B, S, H, P, G, N, Q, (S + Q - 1) / Q,
                 sxb, sxs, sdb, sds, sbb, sbs};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch_typed<__nv_bfloat16>(p, st);
  if (dtype == 0) return (int)launch_typed<float>(p, st);
  return (int)cudaErrorInvalidValue;
}
