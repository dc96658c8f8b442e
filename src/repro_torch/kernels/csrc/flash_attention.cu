// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas / _attn_kernel): forward attention with an online
// softmax in fp32, GQA (query head h reads KV head h / (H/K)), causal and
// sliding-window masks with a query offset, an optional logit softcap
// s -> c*tanh(s/c), fully masked KV tiles skipped, and out = acc / max(l, 1e-37)
// in the input dtype. Layout as there: q (B,Sq,H,hd), k/v (B,Sk,K,hd),
// o (B,Sq,H,hd), all contiguous. Unlike the Pallas kernel, any Sq/Sk is
// accepted: ragged tails are zero-filled in shared memory and masked per
// element.
//
// What bounds it on this card: at the serving path's prefill shape (bf16,
// hd=128, causal, S=1024) the work is ~26 GFLOP against ~67 MB, about 380
// FLOP per byte, above the H100's ~295 bf16 ridge, so the tensor cores bound
// it (26 us at the 989 TFLOP/s peak). The design:
//  * tensor-core products: mma.sync m16n8k16 (bf16 x bf16 -> fp32), one
//    64-row query tile per block of 4 warps (16 rows each), KV tiles of 32
//    rows shared by the 4 warps; fragments come from shared memory through
//    ldmatrix (.trans for V), and the S accumulators are reused in registers
//    as the A operand of P.V;
//  * cp.async streams V_j in while S = Q K_j^T is computed and K_{j+1} in
//    during the softmax and P.V, with no register round trip;
//  * shared tiles are padded to the instantiation's MAXHD with zeros, so the
//    unrolled product loops carry no guard; softcap and masking are template
//    flags, so a tile inside the causal triangle runs no mask code;
//  * at most 128 registers a thread: 4 blocks (16 warps) per SM hide latency;
//  * only live KV tiles are visited (halving causal work), the heaviest
//    query tiles are launched first, and GQA is index arithmetic, so K/V are
//    never repeated in memory.
// Scores, running max/sum and the accumulator stay in fp32; only P is
// rounded to bf16 for the P.V product. No TMA, wgmma or warp specialisation
// yet: those are the next step towards the bound.
//
// Reference semantics kept, in the reference's order: scale by 1/sqrt(hd)
// in fp32, softcap, then the mask with the finite NEG_INF = -1e30 (so a row
// with no visible key yet in a live tile accumulates p = 1 terms that the
// next visible key's correction exp(-1e30 - m) = 0 wipes, as there). For
// bf16 the scale multiplies the fp32 sum of exact bf16 products rather than
// q before the product, and exponentials are taken as exp2 of log2-scaled
// scores; both differ from the reference by fp32 rounding only.
//
// fp32 inputs take a second, scalar kernel (FMA on CUDA cores, q scaled in
// fp32 before the product as in the reference), which keeps fp32 accuracy;
// it serves the fp32 configurations and tests and is not on the bf16
// serving path.
//
// Entry: flash_attention_fwd(...) launches on the given stream, does not
// synchronise or allocate, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;   // 4 warps
constexpr int kBQ = 64;         // query rows per block: 16 per warp

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, KH, hd;
  int causal, window, q_offset;
  float softcap, scale;
};

// Live KV tile range [lo, hi) for the query rows of this block; the same
// rule as models/attention.py::kv_block_range with tile bk.
__device__ __forceinline__ void live_range(const Params& p, int q_start, int bk,
                                           int* lo, int* hi) {
  const int n_tiles = (p.Sk + bk - 1) / bk;
  const int q_len = min(kBQ, p.Sq - q_start);
  const int q_first = p.q_offset + q_start;
  const int q_last = q_first + q_len - 1;
  int h = p.causal ? min(n_tiles, q_last / bk + 1) : n_tiles;
  int l = 0;
  if (p.window > 0) {
    const int t = q_first - p.window + 1;
    l = t > 0 ? t / bk : 0;
  }
  *lo = l;
  *hi = max(h, l + 1);
}

// Softcap, then the mask (causal, window, ragged KV tail) with NEG_INF.
__device__ __forceinline__ float cap_and_mask(const Params& p, float s, int qpos,
                                              int kpos) {
  if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
  bool ok = kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok ? s : kNegInf;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l%8 of matrix l/8, and receives row l/4, columns 2(l%4)..+1 of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, transposed: lane receives rows 2(l%4)..+1 of column l/4.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// 16 bytes global -> shared without a register round trip; src_bytes = 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Row stride of a shared tile MAXHD wide; the +8 bf16 put the 8 rows that
// one ldmatrix reads in distinct banks.
template <int MAXHD>
constexpr int kLd = MAXHD + 8;

// Start copying ROWS rows of hd bf16 (global row stride `stride` elements)
// into a shared tile MAXHD wide. Rows past `valid` and columns hd..MAXHD
// arrive as zeros; `base` is any valid address, used when nothing is read.
// 16-byte pieces: hd is a multiple of 8 and rows are 16-byte aligned. The
// trip count is a constant and there is no branch, so it unrolls fully.
template <int ROWS, int MAXHD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                const __nv_bfloat16* base,
                                                int64_t stride, int valid, int hd) {
  constexpr int NV = MAXHD / 8;
  static_assert(ROWS * NV % kThreads == 0, "a tile splits evenly over the block");
#pragma unroll
  for (int it = 0; it < ROWS * NV / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / NV;
    const int c = (i % NV) * 8;
    const bool in = r < valid && c < hd;
    cp_async16(smem_addr(dst + r * kLd<MAXHD> + c), in ? src + r * stride + c : base,
               in ? 16 : 0);
  }
}

// Scores to log2 units: scale, softcap, then the mask (causal, window,
// ragged KV tail) with NEG_INF. Masking is skipped for tiles that need none.
template <bool SOFTCAP>
__device__ __forceinline__ float logit2(const Params& p, float s, int qpos, int kpos,
                                        bool need_mask) {
  float x = s * p.scale;
  if (SOFTCAP) x = p.softcap * tanhf(x / p.softcap);
  if (need_mask) {
    bool ok = kpos < p.Sk;
    if (p.causal) ok = ok && kpos <= qpos;
    if (p.window > 0) ok = ok && kpos > qpos - p.window;
    if (!ok) return kNegInf;
  }
  return x * kLog2e;
}

// One thread's 2 x BK/4 scores of a tile to log2 units; qpos0 is its first
// row's position (the second is 8 later) and kpos0 its first column's.
// MASK is a template flag so that tiles needing no mask carry no mask code.
template <bool SOFTCAP, bool MASK, int BK>
__device__ __forceinline__ void to_logits(float (&s)[BK / 8][4], const Params& p,
                                          int qpos0, int kpos0) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    const int kpos = kpos0 + n * 8;
    s[n][0] = logit2<SOFTCAP>(p, s[n][0], qpos0, kpos, MASK);
    s[n][1] = logit2<SOFTCAP>(p, s[n][1], qpos0, kpos + 1, MASK);
    s[n][2] = logit2<SOFTCAP>(p, s[n][2], qpos0 + 8, kpos, MASK);
    s[n][3] = logit2<SOFTCAP>(p, s[n][3], qpos0 + 8, kpos + 1, MASK);
  }
}

// Shared tiles are MAXHD wide whatever hd is, zero past hd, so the unrolled
// product loops run over all of MAXHD without a guard: a guard would split
// them into basic blocks whose loads and products cannot be interleaved.
// At most 128 registers a thread, so that 4 blocks (16 warps) share an SM.
template <int MAXHD, int BK, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads, 4)
attn_fwd_bf16(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = p.hd;
  constexpr int ld = kLd<MAXHD>;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * ld;
  __nv_bfloat16* Vs = Ks + BK * ld;

  // causal blocks late in the sequence carry the most tiles: start them first
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int64_t q_stride = (int64_t)p.H * hd;
  const int64_t kv_stride = (int64_t)p.KH * hd;
  const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(p.q) +
                            ((int64_t)b * p.Sq + q_start) * q_stride + (int64_t)h * hd;
  const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(p.k) +
                            (int64_t)b * p.Sk * kv_stride + (int64_t)kh * hd;
  const __nv_bfloat16* vg = reinterpret_cast<const __nv_bfloat16*>(p.v) +
                            (int64_t)b * p.Sk * kv_stride + (int64_t)kh * hd;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in group
  const int r0 = warp * 16 + g;
  const int qpos0 = p.q_offset + q_start + r0;
  const int q_first = p.q_offset + q_start;
  const int q_last = p.q_offset + min(q_start + kBQ, p.Sq) - 1;
  // per-lane ldmatrix row addresses (bytes), see ldmatrix_x4
  const uint32_t q_lane = smem_addr(
      Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8);
  const uint32_t k_lane = smem_addr(
      Ks + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8);
  const uint32_t v_lane = smem_addr(
      Vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8);

  float acc[MAXHD / 8][4];
#pragma unroll
  for (int i = 0; i < MAXHD / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  int lo, hi;
  live_range(p, q_start, BK, &lo, &hi);
  load_tile_async<kBQ, MAXHD>(Qs, qg, qg, q_stride, p.Sq - q_start, hd);
  load_tile_async<BK, MAXHD>(Ks, kg + lo * BK * kv_stride, kg, kv_stride,
                             p.Sk - lo * BK, hd);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int j = lo; j < hi; ++j) {
    const int k_start = j * BK;
    // V_j streams in while S = Q K_j^T is computed
    load_tile_async<BK, MAXHD>(Vs, vg + k_start * kv_stride, vg, kv_stride,
                               p.Sk - k_start, hd);
    cp_async_commit();

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < MAXHD; kc += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, q_lane + kc * 2);
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_lane + (n * 8 * ld + kc) * 2);
        mma_bf16(s[n], a, bk[0], bk[1]);
        mma_bf16(s[n + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with K_j
    // K_{j+1} streams in during the softmax and P V
    if (j + 1 < hi)
      load_tile_async<BK, MAXHD>(Ks, kg + (k_start + BK) * kv_stride, kg, kv_stride,
                                 p.Sk - k_start - BK, hd);
    cp_async_commit();

    const bool need_mask = k_start + BK > p.Sk ||
                           (p.causal && k_start + BK - 1 > q_first) ||
                           (p.window > 0 && k_start <= q_last - p.window);
    if (need_mask)
      to_logits<SOFTCAP, true, BK>(s, p, qpos0, k_start + 2 * t);
    else
      to_logits<SOFTCAP, false, BK>(s, p, qpos0, k_start + 2 * t);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // the four threads of a group hold one row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0);
    const float corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int i = 0; i < MAXHD / 8; ++i) {
      acc[i][0] *= corr0;
      acc[i][1] *= corr0;
      acc[i][2] *= corr1;
      acc[i][3] *= corr1;
    }

    cp_async_wait<1>();  // V_j has landed (K_{j+1} may still be in flight)
    __syncthreads();
    // acc += P V: the S accumulators are already laid out as A fragments
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t a[4] = {pack_f32(s[2 * kc][0], s[2 * kc][1]),
                             pack_f32(s[2 * kc][2], s[2 * kc][3]),
                             pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int i = 0; i < MAXHD / 8; i += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_lane + (kc * 16 * ld + i * 8) * 2);
        mma_bf16(acc[i], a, bv[0], bv[1]);
        mma_bf16(acc[i + 1], a, bv[2], bv[3]);
      }
    }
    cp_async_wait<0>();  // K_{j+1} has landed
    __syncthreads();     // ... for every warp, and V_j is free again
  }

  const float d0 = fmaxf(l0, 1e-37f);
  const float d1 = fmaxf(l1, 1e-37f);
  __nv_bfloat16* og = reinterpret_cast<__nv_bfloat16*>(p.o) +
                      ((int64_t)b * p.Sq + q_start) * q_stride + (int64_t)h * hd;
#pragma unroll
  for (int i = 0; i < MAXHD / 8; ++i) {
    if (i * 8 < hd) {
      const int c = i * 8 + 2 * t;
      if (q_start + r0 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(og + r0 * q_stride + c) =
            __floats2bfloat162_rn(acc[i][0] / d0, acc[i][1] / d0);
      if (q_start + r0 + 8 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(og + (r0 + 8) * q_stride + c) =
            __floats2bfloat162_rn(acc[i][2] / d1, acc[i][3] / d1);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: scalar FMA, two threads per query row
// ---------------------------------------------------------------------------

template <int MAXHD>
__global__ void __launch_bounds__(kThreads)
attn_fwd_f32(const Params p) {
  constexpr int BK = 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = p.hd;
  const int ld = hd + 1;            // odd stride: rows fall in different banks
  float* Qs = reinterpret_cast<float*>(smem_raw);  // kBQ x ld, pre-scaled
  float* Ks = Qs + kBQ * ld;                        // BK x ld
  float* Vs = Ks + BK * ld;                         // BK x hd
  float* Ps = Vs + BK * hd;                         // kBQ x (BK + 1)

  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int64_t q_stride = (int64_t)p.H * hd;
  const int64_t kv_stride = (int64_t)p.KH * hd;
  const float* qg = reinterpret_cast<const float*>(p.q) +
                    ((int64_t)b * p.Sq + q_start) * q_stride + (int64_t)h * hd;
  const float* kg = reinterpret_cast<const float*>(p.k) +
                    (int64_t)b * p.Sk * kv_stride + (int64_t)kh * hd;
  const float* vg = reinterpret_cast<const float*>(p.v) +
                    (int64_t)b * p.Sk * kv_stride + (int64_t)kh * hd;

  for (int i = threadIdx.x; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, c = i - (i / hd) * hd;
    Qs[r * ld + c] = q_start + r < p.Sq ? qg[r * q_stride + c] * p.scale : 0.f;
  }

  const int row = threadIdx.x >> 1;   // query row of this thread pair
  const int half = threadIdx.x & 1;   // columns half*BK/2.. of S; d = 2i+half of O
  const int qpos = p.q_offset + q_start + row;
  float acc[MAXHD / 2];
#pragma unroll
  for (int i = 0; i < MAXHD / 2; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  int lo, hi;
  live_range(p, q_start, BK, &lo, &hi);
  for (int j = lo; j < hi; ++j) {
    const int k_start = j * BK;
    __syncthreads();
    for (int i = threadIdx.x; i < BK * hd; i += kThreads) {
      const int r = i / hd, c = i - (i / hd) * hd;
      const bool in = k_start + r < p.Sk;
      Ks[r * ld + c] = in ? kg[(int64_t)(k_start + r) * kv_stride + c] : 0.f;
      Vs[r * hd + c] = in ? vg[(int64_t)(k_start + r) * kv_stride + c] : 0.f;
    }
    __syncthreads();

    float s[BK / 2];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) {
      const int col = half * (BK / 2) + c;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(Qs[row * ld + d], Ks[col * ld + d], dot);
      s[c] = cap_and_mask(p, dot, qpos, k_start + col);
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float mn = fmaxf(m, mx);
    const float corr = expf(m - mn);
    m = mn;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) {
      const float e = expf(s[c] - mn);
      Ps[row * (BK + 1) + half * (BK / 2) + c] = e;
      sum += e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    __syncwarp();  // the partner thread's half of the P row is visible

#pragma unroll
    for (int i = 0; i < MAXHD / 2; ++i) acc[i] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float pc = Ps[row * (BK + 1) + c];
#pragma unroll
      for (int i = 0; i < MAXHD / 2; ++i)
        if (2 * i + half < hd) acc[i] = fmaf(pc, Vs[c * hd + 2 * i + half], acc[i]);
    }
  }

  if (q_start + row < p.Sq) {
    const float den = fmaxf(l, 1e-37f);
    float* og = reinterpret_cast<float*>(p.o) +
                ((int64_t)b * p.Sq + q_start + row) * q_stride + (int64_t)h * hd;
#pragma unroll
    for (int i = 0; i < MAXHD / 2; ++i)
      if (2 * i + half < hd) og[2 * i + half] = acc[i] / den;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int MAXHD, int BK>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)(kBQ + 2 * BK) * kLd<MAXHD> * sizeof(__nv_bfloat16);
  // softcap is a template flag: the common path carries no tanhf code
  if (p.softcap > 0.f) return launch(attn_fwd_bf16<MAXHD, BK, true>, p, smem, stream);
  return launch(attn_fwd_bf16<MAXHD, BK, false>, p, smem, stream);
}

template <int MAXHD>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int BK = 32;
  const size_t smem =
      ((size_t)(kBQ + BK) * (p.hd + 1) + (size_t)BK * p.hd + kBQ * (BK + 1)) * sizeof(float);
  return launch(attn_fwd_f32<MAXHD>, p, smem, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hd must be a multiple of 8 in [8, 256],
// H a multiple of K; the Python wrapper checks all of it before the call.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int Sq, int Sk,
                                   int H, int KH, int hd, int causal, int window,
                                   float softcap, int q_offset, float scale,
                                   void* stream) {
  const Params p{q, k, v, o, B, Sq, Sk, H, KH, hd,
                 causal, window, q_offset, softcap, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    if (hd <= 64)
      err = launch_bf16<64, 32>(p, st);
    else if (hd <= 128)
      err = launch_bf16<128, 32>(p, st);
    else
      err = launch_bf16<256, 32>(p, st);
  } else if (dtype == 0) {
    if (hd <= 64)
      err = launch_f32<64>(p, st);
    else if (hd <= 128)
      err = launch_f32<128>(p, st);
    else
      err = launch_f32<256>(p, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
