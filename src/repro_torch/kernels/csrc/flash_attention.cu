// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas / _attn_kernel): forward attention with an online
// softmax in fp32, GQA (query head h reads KV head h / (H/K)), causal and
// sliding-window masks with a query offset, an optional logit softcap
// s -> c*tanh(s/c), fully masked KV tiles skipped, and out = acc / max(l, 1e-37)
// in the input dtype. Layout as there: q (B,Sq,H,hd), k/v (B,Sk,K,hd),
// o (B,Sq,H,hd), all contiguous. Unlike the Pallas kernel, any Sq/Sk is
// accepted: ragged tails read zeros and are masked per element.
//
// What bounds it on this card: at the serving path's prefill shapes (bf16,
// causal; llama3.2-3b hd=128, S=1024; hymba-1.5b hd=64, S=2048, window
// 1024) the work is some 380 FLOP per byte moved, above the H100's bf16
// ridge (~295), so the tensor cores bound it. Only wgmma reaches their full
// rate, and it needs its operands in shared memory in the swizzled layout
// that TMA writes. Three kernels, chosen by the Python wrapper's rule on
// (dtype, hd), never one standing in for another:
//
// 1. bf16 with hd 64 or 128 (the serving paths): attn_fwd_wgmma.
//  * Persistent: one block per SM walks work tiles of 128 query rows of one
//    (batch, head), heaviest first, in a snake order over the blocks that
//    evens out their sums of live KV tiles; the next tile's Q and first K/V
//    land while the consumers finish the last one.
//  * Warpgroups 0 and 1 each own 64 of the 128 rows and run
//    wgmma.mma_async: S = Q K^T (m64n128k16, Q and K from shared memory,
//    K-major) and O += P V (m64n{hd}k16, P from the S accumulators in
//    registers as bf16, V read MN-major from shared memory with the
//    transpose flag; its 64-column atoms are the descriptor's leading byte
//    offset apart). Each waits for its own products; the two warpgroups
//    share the SM, so one's softmax can run beside the other's products.
//  * Warpgroup 2 is the producer: one thread issues TMA copies of Q and of
//    128-key K and V tiles into a ring of 2 slots, each slot with full and
//    empty mbarriers for K and for V (and one pair for Q), so a K tile is
//    refilled as soon as both consumers have formed S and the copies
//    overlap the products and the softmax. setmaxnreg gives the consumers
//    232 registers a thread and the producer 40.
//  * Tensor maps are 4-D over (hd, heads, S, B) with 64-column boxes and the
//    128-byte swizzle the wgmma descriptors declare (hd=128 is two atoms);
//    rows past S read zeros within their own batch. GQA is the head
//    coordinate of the K/V map, so K/V are never repeated. Encoded maps are
//    cached by pointer and shape.
//  * The softmax is the consumers' bottleneck, so it is kept lean: a tile
//    that needs no mask takes its maxima on the raw scores and forms
//    s * scale * log2(e) - m with one fma before ex2.approx; the output is
//    scaled by one reciprocal of each row's sum. Only live KV tiles are
//    visited, and masks run only on tiles that cross the diagonal, the
//    window's edge or the end of the keys.
// 2. bf16, other hd: attn_fwd_bf16, mma.sync m16n8k16 with 64 query rows by
//    32 keys, ldmatrix and cp.async, at most 128 registers a thread.
// 3. fp32: attn_fwd_f32, scalar FMA on the CUDA cores, q scaled in fp32 before
//    the product as in the reference; it serves the fp32 configurations and
//    tests, not the bf16 serving path.
//
// Precision of each product: Q K^T multiplies bf16 by bf16 into fp32 (exact
// products, fp32 sums); P is rounded to bf16 for P V, which accumulates in
// fp32; the scale, softcap, running max/sum and the output division stay in
// fp32. The fp32 kernel keeps fp32 throughout.
//
// Reference semantics kept, in the reference's order: scale by 1/sqrt(hd)
// in fp32, softcap, then the mask with the finite NEG_INF = -1e30 (so a row
// with no visible key yet in a live tile accumulates p = 1 terms that the
// next visible key's correction exp(-1e30 - m) = 0 wipes, as there; the
// plain version walks the same tiles as the kernel it stands for). For
// bf16 the scale multiplies the fp32 sum of exact bf16 products rather than
// q before the product, exponentials are taken as exp2 of log2-scaled
// scores, and the wgmma kernel multiplies by 1 / max(l, 1e-37) rather than
// dividing; these differ from the reference by fp32 rounding only.
//
// Entry: flash_attention_fwd(...) launches on the given stream, does not
// synchronise or allocate, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for an input the chosen kernel does not take).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;   // 4 warps
constexpr int kBQ = 64;         // mma.sync and fp32 kernels: query rows per block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, KH, hd;
  int causal, window, q_offset;
  float softcap, scale;
};

// Live KV tile range [lo, hi) for the bq query rows of a block from
// q_start; the same rule as models/attention.py::kv_block_range with tile bk.
__device__ __forceinline__ void live_range(const Params& p, int q_start, int bq, int bk,
                                           int* lo, int* hi) {
  const int n_tiles = (p.Sk + bk - 1) / bk;
  const int q_len = min(bq, p.Sq - q_start);
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
  live_range(p, q_start, kBQ, BK, &lo, &hi);
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
// bf16, hd 64 or 128: wgmma + TMA, one producer warpgroup, two consumers
// ---------------------------------------------------------------------------

constexpr int kWgBQ = 128;       // query rows per block: 64 per consumer warpgroup
constexpr int kWgBK = 128;       // keys per KV tile
constexpr int kStages = 2;       // depth of the K/V ring
constexpr int kWgThreads = 384;  // warpgroups 0 and 1 compute, warpgroup 2 loads
constexpr int kAtomCols = 64;    // bf16 columns in one 128-byte swizzle atom
constexpr int kRowBytes = 128;   // one row of an atom
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 x 40 + 256 x 232 = 384 x 168, the launch's share

// Shared layout (byte offsets from a 1024-aligned base). A tile of R rows
// is hd/64 atoms, each R rows x 128 B with the 128-byte swizzle that TMA
// writes and the wgmma descriptors declare.
template <int HD>
struct WgSmem {
  static constexpr int kQBytes = kWgBQ * HD * 2;
  static constexpr int kKVBytes = kWgBK * HD * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;               // kStages K tiles
  static constexpr int kV = kK + kStages * kKVBytes;    // kStages V tiles
  static constexpr int kBar = kV + kStages * kKVBytes;  // mbarriers, 8 B each
  static constexpr int kBytes = kBar + 8 * (2 + 4 * kStages);
  static_assert(kQBytes % 1024 == 0 && kKVBytes % 1024 == 0, "atoms stay 1024-aligned");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of the 4-D map (hd, heads, S, B) into shared memory; completion
// is reported to `bar` in bytes. Coordinates past the tensor read zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// Shared-memory matrix descriptor of an operand in 128-byte swizzled atoms:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 = 128-byte swizzle. A K-major operand (Q, K) reads 16 columns of
// 8-row groups 1024 B apart (SBO) and ignores LBO. An MN-major operand (V)
// of 64 columns is one atom across; its 16 rows are two 8-row groups 1024 B
// apart, so LBO and SBO are both 1024 B and the reading does not depend on
// which of the two the hardware takes for the group stride.
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr, uint32_t lbo_bytes) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until every committed group of this warpgroup has landed.
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across a
// wgmma's issue and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}


// D (64 x 128, f32) = [D +] A (64 x 16, shared, K-major) * B (128 x 16, shared,
// K-major)^T; accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, shared,
// MN-major: the transpose flag is set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, shared,
// MN-major: the transpose flag is set).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

static_assert(kWgBQ == kWgBK, "Q and K atoms share one stride");

// Issue S = Q K^T for one warpgroup's 64 rows (q_wg: its rows of the Q tile)
// and the K tile at k_tile: hd/16 steps of 16 columns, 32 B apart inside an
// atom; committed as one group, not waited for.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_wg, uint32_t k_tile) {
  wg_fence();
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    const uint32_t off = (kc / 4) * kWgBK * kRowBytes + (kc % 4) * 32;
    wgmma_m64n128k16_ss(sc, wg_desc(q_wg + off, 16), wg_desc(k_tile + off, 16), kc > 0);
  }
  wg_commit();
}

// Issue O += P V for the V tile at v_tile: 8 steps of 16 keys (2048 B of V
// rows apart), one wgmma over all of hd: its 64-column atoms lie
// kWgBK x 128 B apart (the descriptor's leading byte offset for an
// MN-major operand), its 8-row groups 1024 B apart. Committed, not waited for.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&pa)[8][4],
                                         uint32_t v_tile) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t db = wg_desc(v_tile + kk * 16 * kRowBytes, kWgBK * kRowBytes);
    if constexpr (HD == 128)
      wgmma_m64n128k16_rs(o, pa[kk], db);
    else
      wgmma_m64n64k16_rs(o, pa[kk], db);
  }
  wg_commit();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one thread's 2 rows x 32 keys of a 128-key tile, in
// log2 units (t = s * scale * log2 e): the new row maxima m, p = 2^(t - m)
// in place, the correction 2^(m_old - m) of the old sums and the new row
// sums over the four threads that share a row. A tile that needs no mask
// and no softcap takes the maxima of the raw scores and forms t - m with one
// fma; otherwise scores go through logit2 (scale, softcap, the mask with
// NEG_INF in log2 units) first.
template <bool SOFTCAP, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], const Params& p, int qpos0,
                                             int kpos0, float scale_log2, float& m0, float& m1,
                                             float& corr0, float& corr1, float& sum0,
                                             float& sum1) {
  constexpr bool kRaw = !SOFTCAP && !MASK;
  if (!kRaw) {
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int kpos = kpos0 + n * 8;
      sc[4 * n + 0] = logit2<SOFTCAP>(p, sc[4 * n + 0], qpos0, kpos, MASK);
      sc[4 * n + 1] = logit2<SOFTCAP>(p, sc[4 * n + 1], qpos0, kpos + 1, MASK);
      sc[4 * n + 2] = logit2<SOFTCAP>(p, sc[4 * n + 2], qpos0 + 8, kpos, MASK);
      sc[4 * n + 3] = logit2<SOFTCAP>(p, sc[4 * n + 3], qpos0 + 8, kpos + 1, MASK);
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  if (kRaw) {  // every score is live: raw maxima scale to finite log2 maxima
    mx0 *= scale_log2;
    mx1 *= scale_log2;
  }
  const float mn0 = fmaxf(m0, mx0);
  const float mn1 = fmaxf(m1, mx1);
  corr0 = ex2(m0 - mn0);
  corr1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  sum0 = 0.f;
  sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    if (kRaw) {
      sc[4 * n + 0] = ex2(fmaf(sc[4 * n + 0], scale_log2, -mn0));
      sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], scale_log2, -mn0));
      sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], scale_log2, -mn1));
      sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], scale_log2, -mn1));
    } else {
      sc[4 * n + 0] = ex2(sc[4 * n + 0] - mn0);
      sc[4 * n + 1] = ex2(sc[4 * n + 1] - mn0);
      sc[4 * n + 2] = ex2(sc[4 * n + 2] - mn1);
      sc[4 * n + 3] = ex2(sc[4 * n + 3] - mn1);
    }
    sum0 += sc[4 * n + 0] + sc[4 * n + 1];
    sum1 += sc[4 * n + 2] + sc[4 * n + 3];
  }
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
}

// The work tile of round r of block i: the grid walks the (query tile, head,
// batch) tiles heaviest first, in a snake over the blocks (left to right in
// even rounds, right to left in odd ones) so that every block's sum of
// live KV tiles comes out nearly even. Returns false past the last tile.
__device__ __forceinline__ bool work_tile(const Params& p, int round, int* q_start, int* h,
                                          int* b) {
  const int n_q = (p.Sq + kWgBQ - 1) / kWgBQ;
  const int hb = p.H * p.B;
  const int slot = round % 2 == 0 ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
  const int w = round * gridDim.x + slot;
  if (w >= n_q * hb) return false;
  *q_start = (n_q - 1 - w / hb) * kWgBQ;
  *h = w % p.H;
  *b = (w % hb) / p.H;
  return true;
}

// Persistent: one block per SM walks work tiles of 128 query rows of one
// (batch, head). Warpgroup 2 loads: one thread issues TMA copies of each
// tile's Q and of its K_j, V_j into a ring of kStages slots, each with a
// full and an empty mbarrier; the ring runs on across tiles, and the next
// tile's Q and first K/V land while the consumers finish the last one.
// Warpgroups 0 and 1 each own 64 query rows: S = Q K_j^T (wgmma, both
// operands in shared memory), the online softmax on the S registers, then
// O += P V_j (wgmma with P in registers as bf16, V read transposed from
// shared memory). A consumer releases K_j as soon as S is done, Q after the
// tile's last S, and V_j after P V_j.
template <int HD, bool SOFTCAP>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = WgSmem<HD>;
  constexpr int kAtoms = HD / kAtomCols;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ;
  const uint32_t k_s = base + L::kK;
  const uint32_t v_s = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t q_empty = q_full + 8;
  // per slot s: K full, V full, K empty, V empty
  const uint32_t k_full = q_empty + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);  // every consumer thread arrives
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 256);
      mbar_init(v_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == 256) {
      int q_start, h, b, it = 0;  // it: K/V tiles loaded so far, over all work tiles
      for (int round = 0; work_tile(p, round, &q_start, &h, &b); ++round) {
        const int kh = h / (p.H / p.KH);
        int lo, hi;
        live_range(p, q_start, kWgBQ, kWgBK, &lo, &hi);
        mbar_wait(q_empty, (round & 1) ^ 1);  // the previous tile's last S is done
        mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          tma_load(q_s + a * kWgBQ * kRowBytes, &tm_q, q_full, a * kAtomCols, h, q_start, b);
        for (int j = lo; j < hi; ++j, ++it) {
          const int s = it % kStages;
          const uint32_t parity = ((it / kStages) & 1) ^ 1;  // the first round finds slots free
          mbar_wait(k_empty + 8 * s, parity);
          mbar_expect_tx(k_full + 8 * s, L::kKVBytes);
#pragma unroll
          for (int a = 0; a < kAtoms; ++a)
            tma_load(k_s + s * L::kKVBytes + a * kWgBK * kRowBytes, &tm_k, k_full + 8 * s,
                     a * kAtomCols, kh, j * kWgBK, b);
          mbar_wait(v_empty + 8 * s, parity);
          mbar_expect_tx(v_full + 8 * s, L::kKVBytes);
#pragma unroll
          for (int a = 0; a < kAtoms; ++a)
            tma_load(v_s + s * L::kKVBytes + a * kWgBK * kRowBytes, &tm_v, v_full + 8 * s,
                     a * kAtomCols, kh, j * kWgBK, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int warp = (threadIdx.x >> 5) & 3;  // warp in the warpgroup: rows 16 warp..
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = wg * 64 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
    const float scale_log2 = p.scale * kLog2e;
    const uint32_t q_wg = q_s + wg * 64 * kRowBytes;
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    uint32_t pa[8][4];  // P as bf16 pairs
    int q_start, h, b, it = 0;  // it: K/V tiles consumed so far, over all work tiles
    for (int round = 0; work_tile(p, round, &q_start, &h, &b); ++round) {
      int lo, hi;
      live_range(p, q_start, kWgBQ, kWgBK, &lo, &hi);
      const int qpos0 = p.q_offset + q_start + r0;
      const int wg_first = p.q_offset + q_start + wg * 64;
      const int wg_last = p.q_offset + min(q_start + wg * 64 + 64, p.Sq) - 1;

      float o[HD / 2];  // O: rows r0, r0 + 8; columns 8i + 2t, +1 for i < hd/8
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

      mbar_wait(q_full, round & 1);
      for (int j = lo; j < hi; ++j, ++it) {
        const int s = it % kStages;
        const uint32_t parity = (it / kStages) & 1;
        const int k_start = j * kWgBK;

        mbar_wait(k_full + 8 * s, parity);
        issue_qk<HD>(sc, q_wg, k_s + s * L::kKVBytes);
        wg_wait_all();
        fence_regs(sc);
        mbar_arrive(k_empty + 8 * s);
        if (j == hi - 1) mbar_arrive(q_empty);  // the next tile's Q may land

        const bool need_mask = k_start + kWgBK > p.Sk ||
                               (p.causal && k_start + kWgBK - 1 > wg_first) ||
                               (p.window > 0 && k_start <= wg_last - p.window);
        float corr0, corr1, sum0, sum1;
        if (need_mask)
          softmax_tile<SOFTCAP, true>(sc, p, qpos0, k_start + 2 * t, scale_log2, m0, m1, corr0,
                                      corr1, sum0, sum1);
        else
          softmax_tile<SOFTCAP, false>(sc, p, qpos0, k_start + 2 * t, scale_log2, m0, m1, corr0,
                                       corr1, sum0, sum1);
        l0 = l0 * corr0 + sum0;
        l1 = l1 * corr1 + sum1;
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
          o[4 * i + 0] *= corr0;
          o[4 * i + 1] *= corr0;
          o[4 * i + 2] *= corr1;
          o[4 * i + 3] *= corr1;
        }
        // P as bf16 A fragments: the S accumulator of keys 16kk.. is already
        // the register-A layout of one k16 step
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          pa[kk][0] = pack_f32(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
        }

        mbar_wait(v_full + 8 * s, parity);
        issue_pv<HD>(o, pa, v_s + s * L::kKVBytes);
        wg_wait_all();
        fence_regs(o);
        mbar_arrive(v_empty + 8 * s);
      }

      // out = acc / max(l, 1e-37), as one reciprocal per row (fp32 rounding)
      const float d0 = 1.f / fmaxf(l0, 1e-37f);
      const float d1 = 1.f / fmaxf(l1, 1e-37f);
      const int64_t q_stride = (int64_t)p.H * HD;
      __nv_bfloat16* og = reinterpret_cast<__nv_bfloat16*>(p.o) +
                          ((int64_t)b * p.Sq + q_start) * q_stride + (int64_t)h * HD;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const int c = i * 8 + 2 * t;
        if (q_start + r0 < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(og + r0 * q_stride + c) =
              __floats2bfloat162_rn(o[4 * i + 0] * d0, o[4 * i + 1] * d0);
        if (q_start + r0 + 8 < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(og + (r0 + 8) * q_stride + c) =
              __floats2bfloat162_rn(o[4 * i + 2] * d1, o[4 * i + 3] * d1);
      }
    }
  }
}

// ---- host side: tensor maps -------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

struct MapKey {
  const void* ptr;
  int hd, heads, S, B, rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && hd == o.hd && heads == o.heads && S == o.S && B == o.B &&
           rows == o.rows;
  }
};

// The encoded maps of the last kMapCache (pointer, shape) pairs: encoding is
// host work that a prefill would otherwise repeat in every layer's launch.
constexpr int kMapCache = 64;
std::mutex g_map_mutex;
EncodeTiledFn g_encode = nullptr;
MapKey g_map_keys[kMapCache];
CUtensorMap g_maps[kMapCache];
int g_map_count = 0;
int g_map_next = 0;

// cuTensorMapEncodeTiled, fetched as an entry point through the runtime, so
// the library needs no link against libcuda.
EncodeTiledFn encoder() {
  if (g_encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &status) ==
            cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      g_encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  return g_encode;
}

// A 4-D map over a contiguous (B, S, heads, hd) bf16 tensor, innermost first,
// with boxes of 64 columns x 1 head x `rows` rows x 1 batch, 128-byte
// swizzle, zeros past every edge (so a ragged tail never reads the next
// batch). Returns false if the encoding is refused.
bool tensor_map(CUtensorMap* out, const void* ptr, int hd, int heads, int S, int B, int rows) {
  const MapKey key{ptr, hd, heads, S, B, rows};
  std::lock_guard<std::mutex> lock(g_map_mutex);
  for (int i = 0; i < g_map_count; ++i)
    if (g_map_keys[i] == key) {
      *out = g_maps[i];
      return true;
    }
  EncodeTiledFn encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kAtomCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  const int slot = g_map_next;
  g_map_next = (g_map_next + 1) % kMapCache;
  g_map_count = g_map_count < kMapCache ? g_map_count + 1 : kMapCache;
  g_map_keys[slot] = key;
  g_maps[slot] = map;
  *out = map;
  return true;
}

template <int HD>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, p.q, HD, p.H, p.Sq, p.B, kWgBQ) ||
      !tensor_map(&mk, p.k, HD, p.KH, p.Sk, p.B, kWgBK) ||
      !tensor_map(&mv, p.v, HD, p.KH, p.Sk, p.B, kWgBK))
    return cudaErrorInvalidValue;
  const size_t smem = WgSmem<HD>::kBytes + 1024;  // + room to align the base to 1024
  // softcap is a template flag: the common path carries no tanhf code
  auto kernel = p.softcap > 0.f ? attn_fwd_wgmma<HD, true> : attn_fwd_wgmma<HD, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, n_sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (int64_t)((p.Sq + kWgBQ - 1) / kWgBQ) * p.H * p.B;
  const int grid = (int)(tiles < n_sms ? tiles : n_sms);  // one block per SM
  kernel<<<grid, kWgThreads, smem, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
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
  live_range(p, q_start, kBQ, BK, &lo, &hi);
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

// kernel: 0 = the fp32 kernel (float32 inputs), 1 = the mma.sync kernel
// (bfloat16, any hd), 2 = the wgmma kernel (bfloat16, hd 64 or 128); the
// Python wrapper chooses by its rule on (dtype, hd) and checks the inputs
// (hd a multiple of 8 in [8, 256], H a multiple of K, contiguous, 16-byte
// aligned) before the call. An input the chosen kernel does not take is
// refused, never passed to another kernel.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int kernel, int B, int Sq, int Sk,
                                   int H, int KH, int hd, int causal, int window,
                                   float softcap, int q_offset, float scale,
                                   void* stream) {
  const Params p{q, k, v, o, B, Sq, Sk, H, KH, hd,
                 causal, window, q_offset, softcap, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kernel == 2) {
    if (hd == 64)
      err = launch_wgmma<64>(p, st);
    else if (hd == 128)
      err = launch_wgmma<128>(p, st);
    else
      err = cudaErrorInvalidValue;
  } else if (kernel == 1) {
    if (hd <= 64)
      err = launch_bf16<64, 32>(p, st);
    else if (hd <= 128)
      err = launch_bf16<128, 32>(p, st);
    else
      err = launch_bf16<256, 32>(p, st);
  } else if (kernel == 0) {
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
