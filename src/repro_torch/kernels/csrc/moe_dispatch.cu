// The served MoE layer's dispatch and combine for NVIDIA Hopper (sm_90a),
// plain C interface: the expert buffer built expert-major in one pass, and
// each token's gate-weighted sum of its experts' outputs read straight from
// that buffer.
//
// Replaces no TPU kernel: the JAX package leaves its MoE dispatch and
// combine (src/repro/models/moe.py, _dispatch and _combine) to XLA, which
// fuses the scatter into the expert buffer and the gather out of it. The
// port's eager path (src/repro_torch/models/moe.py::_dispatch_combine, kept
// for training, where autograd needs it) zero-fills a group-major buffer,
// copies it once more in an out-of-place index_copy, and permutes it to the
// expert-major layout of the expert GEMMs and back: about sixteen
// buffer-sized passes a layer where these kernels make one.
//
// What bounds them: bytes. Neither does arithmetic worth counting (the
// combine two flops an element read). Per layer of the served granite cell
// (8 groups of 4,096 tokens, 72 experts, capacity 711, d 4,096, bf16) the
// gather writes the 3.35 GB buffer and reads 2.7 GB of token rows; the
// combine reads those 2.7 GB back and writes 0.27 GB. The design:
//  * moe_gather writes every row of the (rows, D) buffer exactly once: the
//    token that holds the row's slot (slot_token[row] >= 0) or zeros. No
//    separate zero fill, no sink row, no expanded copy of the tokens. A
//    block writes kRows consecutive rows; a thread keeps kUnroll 16-byte
//    loads in flight before it stores them. It copies bytes, so any dtype
//    takes the same code; rows whose size or base is off the 16-byte grid
//    take 4- or 2-byte words;
//  * moe_combine: one block a token, a thread 8 consecutive elements of it
//    a step. out[t] = sum over j of w[t, j] * ye[rows[t, j]], products and
//    sum in fp32 in choice order (__fmul_rn, __fadd_rn: never contracted
//    into a fused multiply-add, so the result is the plain fp32 sum's), then
//    rounded once to the output dtype. A dropped choice (rows[t, j] < 0) is
//    not read. A thread loads kChoices choices' vectors before it adds them,
//    so several loads are in flight.
//
// The callers build the maps (kernels/moe_dispatch.py::expert_major_rows):
// every index is a row of the tensor it points into; the kernels do not
// check them.
//
// Entries: moe_gather and moe_combine launch on the given stream, do not
// synchronise or allocate, launch nothing for an empty output, and return
// cudaGetLastError() (cudaErrorInvalidValue for arguments they refuse).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;       // rows a gather block writes
constexpr int kUnroll = 4;     // gather loads a thread keeps in flight
constexpr int kVec = 8;        // combine elements a thread sums a step
constexpr int kChoices = 4;    // combine choices a thread loads before adding them

// ---- gather ---------------------------------------------------------------------

template <typename W>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const W* __restrict__ src, const int32_t* __restrict__ slot_token,
              W* __restrict__ out, int64_t rows, int words) {
  __shared__ int32_t token[kRows];
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int nrows = rows - row0 < kRows ? (int)(rows - row0) : kRows;
  if (threadIdx.x < nrows) token[threadIdx.x] = slot_token[row0 + threadIdx.x];
  __syncthreads();
  const int items = nrows * words;
  for (int base = threadIdx.x; base < items; base += kThreads * kUnroll) {
    W v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      v[u] = W{};
      if (i < items) {
        const int r = i / words;
        const int32_t t = token[r];
        if (t >= 0) v[u] = src[(int64_t)t * words + (i - r * words)];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i < items) {
        const int r = i / words;
        out[(row0 + r) * words + (i - r * words)] = v[u];
      }
    }
  }
}

// ---- combine ------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ ye, const int32_t* __restrict__ rows,
               const T* __restrict__ w, T* __restrict__ out, int k, int64_t d, bool vec) {
  const int64_t t = blockIdx.x;
  const int32_t* __restrict__ r = rows + t * k;
  const T* __restrict__ wt = w + t * k;
  T* __restrict__ o = out + t * d;
  if (vec) {                       // d % kVec == 0, ye and out on the 16-byte grid
    for (int64_t i = (int64_t)threadIdx.x * kVec; i < d; i += (int64_t)kThreads * kVec) {
      float acc[kVec] = {};
      for (int j0 = 0; j0 < k; j0 += kChoices) {
        float x[kChoices][kVec], wj[kChoices];
        bool live[kChoices];
#pragma unroll
        for (int u = 0; u < kChoices; ++u) {
          const int32_t row = j0 + u < k ? r[j0 + u] : -1;
          live[u] = row >= 0;
          if (live[u]) {
            wj[u] = to_f32(wt[j0 + u]);
            load8(ye + (int64_t)row * d + i, x[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kChoices; ++u) {
          if (!live[u]) continue;
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(wj[u], x[u][e]));
        }
      }
      store8(o + i, acc);
    }
    return;
  }
  for (int64_t i = threadIdx.x; i < d; i += kThreads) {
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) {
      const int32_t row = r[j];
      if (row < 0) continue;
      acc = __fadd_rn(acc, __fmul_rn(to_f32(wt[j]), to_f32(ye[(int64_t)row * d + i])));
    }
    o[i] = from_f32<T>(acc);
  }
}

__host__ __forceinline__ bool aligned(const void* a, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(a) % bytes == 0;
}

}  // namespace

// out (rows, row_bytes) = src's row slot_token[row], or zeros where it is < 0
extern "C" int moe_gather(const void* src, const int32_t* slot_token, void* out, int64_t rows,
                          int64_t row_bytes, void* stream) {
  if (rows < 0 || row_bytes <= 0 || row_bytes % 2 != 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const int64_t blocks = (rows + kRows - 1) / kRows;
  if (blocks > 0x7fffffff || row_bytes / 2 > 0x7fffffff / kRows) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0 && aligned(src, 16) && aligned(out, 16)) {
    gather_kernel<uint4><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const uint4*>(src), slot_token, static_cast<uint4*>(out), rows,
        (int)(row_bytes / 16));
  } else if (row_bytes % 4 == 0 && aligned(src, 4) && aligned(out, 4)) {
    gather_kernel<uint32_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(src), slot_token, static_cast<uint32_t*>(out), rows,
        (int)(row_bytes / 4));
  } else {
    gather_kernel<uint16_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(src), slot_token, static_cast<uint16_t*>(out), rows,
        (int)(row_bytes / 2));
  }
  return (int)cudaGetLastError();
}

// out (tokens, d) = sum over j < k of w[t, j] * ye[rows[t, j]] (rows[t, j] >= 0);
// bf16 != 0: ye, w and out are bfloat16, else float32
extern "C" int moe_combine(const void* ye, const int32_t* rows, const void* w, void* out,
                           int64_t tokens, int64_t k, int64_t d, int bf16, void* stream) {
  if (tokens < 0 || k <= 0 || k > 0x7fffffff || d <= 0) return (int)cudaErrorInvalidValue;
  if (tokens == 0) return (int)cudaSuccess;
  if (tokens > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = d % kVec == 0 && aligned(ye, 16) && aligned(out, 16);
  if (bf16) {
    combine_kernel<__nv_bfloat16><<<(unsigned)tokens, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(ye), rows, static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), (int)k, d, vec);
  } else {
    combine_kernel<float><<<(unsigned)tokens, kThreads, 0, s>>>(
        static_cast<const float*>(ye), rows, static_cast<const float*>(w),
        static_cast<float*>(out), (int)k, d, vec);
  }
  return (int)cudaGetLastError();
}
