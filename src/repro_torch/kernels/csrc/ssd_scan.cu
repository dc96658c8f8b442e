// Mamba-2 SSD chunked scan for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_scan_pallas / _ssd_kernel). Per chunk of Q rows, with
// cum = in-chunk prefix sum of dt*A and L[i,j] = exp(cum_i - cum_j) for j <= i:
//
//   y       = (C B^T ⊙ L ⊙ dt_j) x  +  (C ⊙ exp(cum_i)) h^T
//   h      <- exp(cum_{Q-1}) h  +  x^T (B ⊙ exp(cum_{Q-1} - cum_j) dt_j)
//
// carried across the chunks in order. Head h reads B/C group h / (H/G), by
// index. S is zero-padded to a multiple of Q: rows past S read x = B = C = 0
// and dt = 0 (no decay, no update), so the final state is the unpadded one.
// Layout as the JAX package's: x (B,S,H,P) and y (B,S,H,P) in x's dtype
// (f32 or bf16), dt (B,S,H) f32, A (H,) f32, B/C (B,S,G,N) in x's dtype,
// h0/h_out (B,H,P,N) f32. x, dt and B/C are read through their batch and
// sequence strides (the model hands in views of one projection), so no
// transposed copy is made.
//
// What bounds it on this card: at the serving path's shapes (bf16, Q=256,
// S=2048; hymba H=50, P=64, N=16 and mamba2 H=24, P=64, N=128, B=4) the
// needed work is 10-16 GFLOP against 58-107 MB, ~100-280 FLOP per byte. All
// arithmetic is fp32 on the CUDA cores, so the fp32 rate (67 TFLOP/s)
// bounds it, not the bytes. The design, simple first:
//  * one block of 128 threads per (batch, head, 32 columns of P), walking
//    its chunks in order; the (32, N) slice of the state stays in shared
//    memory across chunks (rows of the state are independent, so splitting
//    P costs only a recomputation of C B^T per slice);
//  * the (Q, Q) score/decay tile is never materialised: a chunk is walked
//    in 64-row tiles of i and j, with 64 rows of C, 64 rows of B and x and
//    one 64x64 weight tile in shared memory, and L computed on the fly
//    from cum (Q floats in shared memory); tiles above the diagonal are
//    skipped, and inside the diagonal tile the mask is applied BEFORE the
//    exp (above the diagonal cum_i - cum_j > 0 can overflow to inf, and
//    inf * 0 would be NaN);
//  * register tiles: 4x8 scores, 4x4 outputs and 4 x ceil(N/16) state
//    entries a thread, fed from padded shared rows without bank conflicts;
//  * the state update rides on the last row tile's sweep over the chunk,
//    so B and x are not read again for it.
// No tensor cores (every product is fp32, as in the reference), no
// cp.async/TMA, and the chunks of one (b, h) run in sequence: those are
// the next steps towards the bound.
//
// Entry: ssd_scan_fwd(...) launches on the given stream, does not
// synchronise or allocate, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // tx = tid % 8 (columns), ty = tid / 8 (rows)
constexpr int kT = 64;         // rows of a chunk tile, for i and for j
constexpr int kPB = 32;        // columns of P per block
constexpr int kLdw = kT + 1;   // padded row of the weight tile

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* h0;  // may be null: start from zeros
  void* y;
  float* hout;
  int B, S, H, P, G, N, Q;
  int64_t sxb, sxs, sdb, sds, sbb, sbs;  // batch / sequence strides (elements)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// rows [0, kT) of a (rows, N) slab starting at sequence row s0, into a
// padded shared tile; rows at or past `live` (end of chunk) or S read zero
template <typename T>
__device__ __forceinline__ void load_bc(float* dst, const T* src, int64_t row_stride,
                                        int s0, int live, int S, int N) {
  const int ld = N + 1;
  for (int e = threadIdx.x; e < kT * N; e += kThreads) {
    const int r = e / N, n = e - r * N;
    float v = 0.f;
    if (r < live && s0 + r < S) v = to_f(src[(int64_t)(s0 + r) * row_stride + n]);
    dst[r * ld + n] = v;
  }
}

template <typename T>
__device__ __forceinline__ void load_x(float* dst, const T* src, int64_t row_stride,
                                       int s0, int live, int S, int pw) {
  for (int e = threadIdx.x; e < kT * kPB; e += kThreads) {
    const int r = e / kPB, c = e % kPB;
    float v = 0.f;
    if (r < live && s0 + r < S && c < pw) v = to_f(src[(int64_t)(s0 + r) * row_stride + c]);
    dst[e] = v;
  }
}

// NC = slots of 16 state rows (n) a thread updates: N <= 16 * NC
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, Q = p.Q, ldn = p.N + 1;
  float* Xs = smem;                  // [kT][kPB]   x rows of the j tile
  float* Hs = Xs + kT * kPB;         // [N][kPB]    the state slice, n-major
  float* Ws = Hs + N * kPB;          // [kT][kLdw]  weights of the (i, j) tile
  float* Cs = Ws + kT * kLdw;        // [kT][N+1]   C rows of the i tile
  float* Bs = Cs + kT * ldn;         // [kT][N+1]   B rows of the j tile
  float* cum_s = Bs + kT * ldn;      // [Q]         in-chunk prefix sums of dt*A
  float* dt_s = cum_s + Q;           // [Q]

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int p0 = blockIdx.x * kPB, h = blockIdx.y, b = blockIdx.z;
  const int pw = min(kPB, p.P - p0);  // live columns of this block
  const int g = h / (p.H / p.G);
  const float a_h = p.A[h];
  const T* xg = static_cast<const T*>(p.x) + b * p.sxb + (int64_t)h * p.P + p0;
  const float* dtg = p.dt + b * p.sdb + h;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.sbb + (int64_t)g * N;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.sbb + (int64_t)g * N;
  const int64_t hbase = ((int64_t)b * p.H + h) * p.P + p0;  // (b, h, p0) row of h0/h_out

  for (int e = tid; e < N * kPB; e += kThreads) {
    const int n = e / kPB, c = e % kPB;
    Hs[e] = (p.h0 != nullptr && c < pw) ? p.h0[(hbase + c) * N + n] : 0.f;
  }

  const int n_chunks = (p.S + Q - 1) / Q;
  const int n_tiles = (Q + kT - 1) / kT;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * Q;
    __syncthreads();  // the previous chunk is done with dt_s, cum_s and Hs
    for (int r = tid; r < Q; r += kThreads)
      dt_s[r] = (c0 + r < p.S) ? dtg[(int64_t)(c0 + r) * p.sds] : 0.f;
    __syncthreads();
    if (tid < 32) {  // warp 0: inclusive prefix sum of dt*A, a run per lane
      const int per = (Q + 31) / 32;
      const int lo = min(Q, tid * per), hi = min(Q, lo + per);
      float run = 0.f;
      for (int r = lo; r < hi; ++r) {
        run += dt_s[r] * a_h;
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

    float st[NC][4];  // state update of rows n = ty + 16k, columns 4tx..4tx+3
#pragma unroll
    for (int k = 0; k < NC; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) st[k][q] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kT;
      const bool last = it == n_tiles - 1;
      load_bc(Cs, cg, p.sbs, c0 + i0, Q - i0, p.S, N);
      __syncthreads();

      // inter-chunk term: exp(cum_i) * sum_n C[i][n] h[n][c]
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float4 hv = *reinterpret_cast<const float4*>(&Hs[n * kPB + 4 * tx]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float cv = Cs[(ty + 16 * a) * ldn + n];
          acc[a][0] = fmaf(cv, hv.x, acc[a][0]);
          acc[a][1] = fmaf(cv, hv.y, acc[a][1]);
          acc[a][2] = fmaf(cv, hv.z, acc[a][2]);
          acc[a][3] = fmaf(cv, hv.w, acc[a][3]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        const float d = i < Q ? expf(cum_s[i]) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] *= d;
      }

      // intra-chunk term over the j tiles at or below the diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT, jn = min(kT, Q - j0);
        __syncthreads();  // readers of Bs, Xs and Ws are done
        load_bc(Bs, bg, p.sbs, c0 + j0, jn, p.S, N);
        load_x(Xs, xg, p.sxs, c0 + j0, jn, p.S, pw);
        __syncthreads();

        float s[4][8];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 8; ++k) s[a][k] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[8];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * ldn + n];
#pragma unroll
          for (int k = 0; k < 8; ++k) bv[k] = Bs[(tx + 8 * k) * ldn + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < 8; ++k) s[a][k] = fmaf(cv[a], bv[k], s[a][k]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int il = ty + 16 * a, i = i0 + il;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int jl = tx + 8 * k, j = j0 + jl;
            float w = 0.f;
            if (j <= i && i < Q)  // mask first: no exp above the diagonal
              w = s[a][k] * expf(cum_s[i] - cum_s[j]) * dt_s[j];
            Ws[il * kLdw + jl] = w;
          }
        }
        __syncthreads();

        for (int jl = 0; jl < jn; ++jl) {
          const float4 xv = *reinterpret_cast<const float4*>(&Xs[jl * kPB + 4 * tx]);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float w = Ws[(ty + 16 * a) * kLdw + jl];
            acc[a][0] = fmaf(w, xv.x, acc[a][0]);
            acc[a][1] = fmaf(w, xv.y, acc[a][1]);
            acc[a][2] = fmaf(w, xv.z, acc[a][2]);
            acc[a][3] = fmaf(w, xv.w, acc[a][3]);
          }
        }

        if (last) {  // the last row tile sweeps every j: fold in the state update
          for (int jl = 0; jl < jn; ++jl) {
            const int j = j0 + jl;
            const float wj = expf(total - cum_s[j]) * dt_s[j];
            const float4 xv = *reinterpret_cast<const float4*>(&Xs[jl * kPB + 4 * tx]);
#pragma unroll
            for (int k = 0; k < NC; ++k) {
              const int n = ty + 16 * k;
              if (n < N) {
                const float bd = Bs[jl * ldn + n] * wj;
                st[k][0] = fmaf(xv.x, bd, st[k][0]);
                st[k][1] = fmaf(xv.y, bd, st[k][1]);
                st[k][2] = fmaf(xv.z, bd, st[k][2]);
                st[k][3] = fmaf(xv.w, bd, st[k][3]);
              }
            }
          }
        }
      }

      T* yg = static_cast<T*>(p.y);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i < Q && c0 + i < p.S) {
          T* row = yg + (((int64_t)b * p.S + c0 + i) * p.H + h) * p.P + p0;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (4 * tx + q < pw) store(row + 4 * tx + q, acc[a][q]);
        }
      }
    }

    __syncthreads();  // every inter-chunk term has read the old state
    const float dec = expf(total);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int n = ty + 16 * k;
      if (n < N) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float* hp = &Hs[n * kPB + 4 * tx + q];
          *hp = *hp * dec + st[k][q];
        }
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < N * kPB; e += kThreads) {
    const int n = e / kPB, c = e % kPB;
    if (c < pw) p.hout[(hbase + c) * N + n] = Hs[e];
  }
}

template <typename T, int NC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      ((size_t)kT * kPB + (size_t)p.N * kPB + (size_t)kT * kLdw +
       2 * (size_t)kT * (p.N + 1) + 2 * (size_t)p.Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.P + kPB - 1) / kPB, p.H, p.B);
  ssd_scan_kernel<T, NC><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const Params& p, cudaStream_t stream) {
  if (p.N <= 16) return launch<T, 1>(p, stream);
  if (p.N <= 64) return launch<T, 4>(p, stream);
  if (p.N <= 128) return launch<T, 8>(p, stream);
  return launch<T, 16>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y). 1 <= Q <= 2048,
// N <= 256, H a multiple of G, and the inner dims packed; the Python
// wrapper checks all of it before the call. h0 may be null.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                            const void* Bm, const void* Cm, const float* h0,
                            void* y, float* hout, int dtype, int B, int S, int H,
                            int P, int G, int N, int Q, int64_t sxb, int64_t sxs,
                            int64_t sdb, int64_t sds, int64_t sbb, int64_t sbs,
                            void* stream) {
  const Params p{x, dt, A, Bm, Cm, h0, y, hout, B, S, H, P, G, N, Q,
                 sxb, sxs, sdb, sds, sbb, sbs};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > 2048 || N < 1 || N > 256 || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return (int)launch_n<__nv_bfloat16>(p, st);
  if (dtype == 0) return (int)launch_n<float>(p, st);
  return (int)cudaErrorInvalidValue;
}
