// The optimizer's elementwise passes for NVIDIA Hopper (sm_90a), plain C
// interface: global-norm clipping and AdamW over every leaf of a parameter
// tree, each in one pass.
//
// Replaces no TPU kernel: the JAX package leaves its optimizer
// (src/repro/optim/adamw.py) to XLA, which fuses each leaf's update into one
// loop. The port's eager update (src/repro_torch/optim/adamw.py,
// clip_by_global_norm_ and adamw_update_) ran about twenty full passes over
// each leaf, each reading or writing a float32 copy of it. These kernels
// keep the same arithmetic and move each operand once.
//
// What bounds them: bytes. Per parameter (bf16 weights and gradients, fp32
// moments) the norm reads g (2 B), the clip reads and writes g (4 B), AdamW
// reads g, p, m, v and writes m, v, p (22 B): 28 B, a few floating-point
// operations each, far below the card's 295 operations a byte. The design:
//  * multi-tensor: one launch walks every leaf of the tree. A table of the
//    leaves (pointers, lengths, dtypes and the first chunk of each) is passed
//    by value in the kernel's arguments (LeafTable, under the 4 KB limit,
//    so at most kMaxLeaves leaves; the port's largest tree has 24). Each leaf is
//    cut into chunks of `chunk` elements; one block streams one chunk, and
//    finds its leaf by a binary search of the table's chunk starts;
//  * 16-byte loads and stores: a thread moves 8 elements a step (one uint4
//    of bf16, two float4 of fp32). A leaf with any pointer off the 16-byte
//    grid takes a scalar loop, and so does a leaf's last n % 8 elements;
//  * the norm without float atomics, deterministic: each block writes the
//    sum of squares of its chunk, accumulated in double, to its own slot;
//    one block then sums the slots in a fixed order and writes the norm and
//    the clip scale to device memory (no host synchronisation);
//  * the clip reads the scale first and leaves g untouched where it is 1
//    (g * 1 is g, bit for bit);
//  * AdamW reads lr and the two bias corrections from device memory and does
//    the eager update's operations in its order, each its own IEEE rounding
//    (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: never contracted into a
//    fused multiply-add; never build this file with --use_fast_math), so it
//    is bit-equal to the eager update on the same inputs. New moments kept in
//    bf16 are rounded once, as the eager m.copy_(mf) rounds them, and the
//    update uses their fp32 values.
//
// Entries: adamw_sumsq, adamw_norm_finish, adamw_clip and adamw_step launch on
// the given stream, do not synchronise or allocate, launch nothing for an
// empty table, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kVec = 8;               // elements a thread moves a step
constexpr int kFinishThreads = 1024;

// kind bits of a leaf: its gradient, moments and parameter in bf16 (else fp32)
constexpr int kGradBf16 = 1, kMomentBf16 = 2, kParamBf16 = 4;

}  // namespace

// Mirrored by kernels/adamw.py's ctypes structure, field for field.
struct LeafTable {
  int64_t n[kMaxLeaves];               // elements of each leaf (none empty)
  int64_t chunk0[kMaxLeaves + 1];      // first chunk of each leaf; [count] = chunks
  void* g[kMaxLeaves];
  void* m[kMaxLeaves];
  void* v[kMaxLeaves];
  void* p[kMaxLeaves];
  int32_t kind[kMaxLeaves];
  int32_t count;
};

namespace {

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

// ---- element access: fp32 or bf16 in memory, fp32 in registers -------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: what storing it in a T leaf keeps
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ void load8(const float* src, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

// ---- the chunk a block streams ----------------------------------------------

struct Chunk {
  int leaf;
  int64_t begin, end;   // element range in the leaf
};

// the last leaf whose first chunk is at or before chunk c (no leaf is empty,
// so each leaf's chunks are [chunk0[l], chunk0[l + 1]))
__device__ __forceinline__ Chunk chunk_of(const LeafTable& t, int64_t c, int64_t chunk) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.chunk0[mid] <= c) lo = mid; else hi = mid - 1;
  }
  const int64_t begin = (c - t.chunk0[lo]) * chunk;
  const int64_t end = begin + chunk < t.n[lo] ? begin + chunk : t.n[lo];
  return {lo, begin, end};
}

// ---- sum of squares ---------------------------------------------------------

template <typename TG>
__device__ __forceinline__ double sumsq_chunk(const TG* __restrict__ g, int64_t begin,
                                              int64_t end) {
  double acc = 0.0;
  int64_t tail = begin;
  if (aligned16(g)) {
    for (int64_t i = begin + (int64_t)threadIdx.x * kVec; i + kVec <= end;
         i += (int64_t)kThreads * kVec) {
      float x[kVec];
      load8(g + i, x);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const double d = x[k];
        acc += d * d;
      }
    }
    tail = begin + (end - begin) / kVec * kVec;
  }
  for (int64_t i = tail + threadIdx.x; i < end; i += kThreads) {
    const double d = to_f32(g[i]);
    acc += d * d;
  }
  return acc;
}

// the block's sum of v, in a fixed order; valid in thread 0
template <int Threads>
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sum[Threads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < Threads / 32 ? warp_sum[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const LeafTable t, int64_t chunk, double* __restrict__ partials) {
  const Chunk c = chunk_of(t, blockIdx.x, chunk);
  const double acc = (t.kind[c.leaf] & kGradBf16)
      ? sumsq_chunk(static_cast<const __nv_bfloat16*>(t.g[c.leaf]), c.begin, c.end)
      : sumsq_chunk(static_cast<const float*>(t.g[c.leaf]), c.begin, c.end);
  const double total = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// norm = sqrt(sum of the partials); scale = clamp(max_norm / clamp(norm,
// 1e-9), max=1) as the eager code computes it: clamp keeps a NaN, and
// ``max_norm / t`` is t.reciprocal() * max_norm in torch
__global__ void __launch_bounds__(kFinishThreads)
norm_finish_kernel(const double* __restrict__ partials, int64_t count, float max_norm,
                   float* __restrict__ norm, float* __restrict__ scale) {
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < count; i += kFinishThreads) acc += partials[i];
  const double total = block_sum<kFinishThreads>(acc);
  if (threadIdx.x == 0) {
    const float nf = __double2float_rn(sqrt(total));
    const float clamped = isnan(nf) ? nf : fmaxf(nf, 1e-9f);
    float s = __fmul_rn(__fdiv_rn(1.0f, clamped), max_norm);
    s = isnan(s) ? s : fminf(s, 1.0f);
    *norm = nf;
    *scale = s;
  }
}

// ---- clip ---------------------------------------------------------------------

template <typename TG>
__device__ __forceinline__ void clip_chunk(TG* __restrict__ g, int64_t begin, int64_t end, float s) {
  int64_t tail = begin;
  if (aligned16(g)) {
    for (int64_t i = begin + (int64_t)threadIdx.x * kVec; i + kVec <= end;
         i += (int64_t)kThreads * kVec) {
      float x[kVec];
      load8(g + i, x);
#pragma unroll
      for (int k = 0; k < kVec; ++k) x[k] = __fmul_rn(x[k], s);
      store8(g + i, x);
    }
    tail = begin + (end - begin) / kVec * kVec;
  }
  for (int64_t i = tail + threadIdx.x; i < end; i += kThreads)
    g[i] = from_f32<TG>(__fmul_rn(to_f32(g[i]), s));
}

__global__ void __launch_bounds__(kThreads)
clip_kernel(const LeafTable t, int64_t chunk, const float* __restrict__ scale) {
  const float s = *scale;
  if (s == 1.0f) return;
  const Chunk c = chunk_of(t, blockIdx.x, chunk);
  if (t.kind[c.leaf] & kGradBf16)
    clip_chunk(static_cast<__nv_bfloat16*>(t.g[c.leaf]), c.begin, c.end, s);
  else
    clip_chunk(static_cast<float*>(t.g[c.leaf]), c.begin, c.end, s);
}

// ---- AdamW --------------------------------------------------------------------

// One element, the eager _leaf_update then p.add_: m and v come back as
// their fp32 values, p as its new value in its own dtype (held in a float).
template <typename TP>
__device__ __forceinline__ void adamw_one(float g, float& m, float& v, float& p,
                                          const Hyper& h, float neg_lr, float bc1,
                                          float bc2) {
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.omb2));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps);
  float u = __fdiv_rn(__fdiv_rn(m, bc1), denom);
  u = __fadd_rn(u, __fmul_rn(p, h.wd));
  u = round_to<TP>(__fmul_rn(u, neg_lr));
  p = round_to<TP>(__fadd_rn(p, u));
}

template <typename TG, typename TM, typename TP>
__device__ __forceinline__ void adamw_chunk(const LeafTable& t, const Chunk& c, const Hyper& h, float neg_lr,
                            float bc1, float bc2) {
  const TG* __restrict__ g = static_cast<const TG*>(t.g[c.leaf]);
  TM* __restrict__ m = static_cast<TM*>(t.m[c.leaf]);
  TM* __restrict__ v = static_cast<TM*>(t.v[c.leaf]);
  TP* __restrict__ p = static_cast<TP*>(t.p[c.leaf]);
  int64_t tail = c.begin;
  if (aligned16(g) && aligned16(m) && aligned16(v) && aligned16(p)) {
    for (int64_t i = c.begin + (int64_t)threadIdx.x * kVec; i + kVec <= c.end;
         i += (int64_t)kThreads * kVec) {
      float gx[kVec], mx[kVec], vx[kVec], px[kVec];
      load8(g + i, gx);
      load8(m + i, mx);
      load8(v + i, vx);
      load8(p + i, px);
#pragma unroll
      for (int k = 0; k < kVec; ++k) adamw_one<TP>(gx[k], mx[k], vx[k], px[k], h, neg_lr, bc1, bc2);
      store8(m + i, mx);
      store8(v + i, vx);
      store8(p + i, px);
    }
    tail = c.begin + (c.end - c.begin) / kVec * kVec;
  }
  for (int64_t i = tail + threadIdx.x; i < c.end; i += kThreads) {
    float mi = to_f32(m[i]), vi = to_f32(v[i]), pi = to_f32(p[i]);
    adamw_one<TP>(to_f32(g[i]), mi, vi, pi, h, neg_lr, bc1, bc2);
    m[i] = from_f32<TM>(mi);
    v[i] = from_f32<TM>(vi);
    p[i] = from_f32<TP>(pi);
  }
}

__global__ void __launch_bounds__(kThreads)
adamw_kernel(const LeafTable t, int64_t chunk, const float* __restrict__ lr,
             const float* __restrict__ bc1, const float* __restrict__ bc2, const Hyper h) {
  const Chunk c = chunk_of(t, blockIdx.x, chunk);
  const float neg_lr = -*lr, b1 = *bc1, b2 = *bc2;
  using bf = __nv_bfloat16;
  switch (t.kind[c.leaf]) {
    case 0: adamw_chunk<float, float, float>(t, c, h, neg_lr, b1, b2); break;
    case kGradBf16: adamw_chunk<bf, float, float>(t, c, h, neg_lr, b1, b2); break;
    case kMomentBf16: adamw_chunk<float, bf, float>(t, c, h, neg_lr, b1, b2); break;
    case kGradBf16 | kMomentBf16: adamw_chunk<bf, bf, float>(t, c, h, neg_lr, b1, b2); break;
    case kParamBf16: adamw_chunk<float, float, bf>(t, c, h, neg_lr, b1, b2); break;
    case kGradBf16 | kParamBf16: adamw_chunk<bf, float, bf>(t, c, h, neg_lr, b1, b2); break;
    case kMomentBf16 | kParamBf16: adamw_chunk<float, bf, bf>(t, c, h, neg_lr, b1, b2); break;
    default: adamw_chunk<bf, bf, bf>(t, c, h, neg_lr, b1, b2); break;
  }
}

int check_table(const LeafTable* t, int64_t chunk) {
  if (t == nullptr || t->count < 0 || t->count > kMaxLeaves || chunk <= 0 || chunk % kVec != 0)
    return (int)cudaErrorInvalidValue;
  if (t->chunk0[t->count] > 0x7fffffff) return (int)cudaErrorInvalidValue;   // grid.x
  return (int)cudaSuccess;
}

}  // namespace

extern "C" int adamw_table_bytes() { return (int)sizeof(LeafTable); }

extern "C" int adamw_sumsq(const LeafTable* t, int64_t chunk, double* partials, void* stream) {
  if (int rc = check_table(t, chunk)) return rc;
  const int64_t blocks = t->chunk0[t->count];
  if (t->count == 0 || blocks == 0) return (int)cudaSuccess;
  sumsq_kernel<<<(unsigned)blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      *t, chunk, partials);
  return (int)cudaGetLastError();
}

extern "C" int adamw_norm_finish(const double* partials, int64_t count, float max_norm,
                                 float* norm, float* scale, void* stream) {
  if (count < 0) return (int)cudaErrorInvalidValue;
  norm_finish_kernel<<<1, kFinishThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      partials, count, max_norm, norm, scale);
  return (int)cudaGetLastError();
}

extern "C" int adamw_clip(const LeafTable* t, int64_t chunk, const float* scale, void* stream) {
  if (int rc = check_table(t, chunk)) return rc;
  const int64_t blocks = t->chunk0[t->count];
  if (t->count == 0 || blocks == 0) return (int)cudaSuccess;
  clip_kernel<<<(unsigned)blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      *t, chunk, scale);
  return (int)cudaGetLastError();
}

extern "C" int adamw_step(const LeafTable* t, int64_t chunk, const float* lr, const float* bc1,
                          const float* bc2, float b1, float omb1, float b2, float omb2,
                          float eps, float wd, void* stream) {
  if (int rc = check_table(t, chunk)) return rc;
  const int64_t blocks = t->chunk0[t->count];
  if (t->count == 0 || blocks == 0) return (int)cudaSuccess;
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  adamw_kernel<<<(unsigned)blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      *t, chunk, lr, bc1, bc2, h);
  return (int)cudaGetLastError();
}
