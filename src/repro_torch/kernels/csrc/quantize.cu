// Int8 absmax quantization (the compression hop) for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/quantize.py:
//   absmax_pallas / _absmax_kernel            max|x| over the flattened tensor
//   quantize_int8_with_scale / _quantize_kernel
//                                             clip(rint(x / s), -127, 127) -> int8
// with the scale s read from device memory at run time (it is data, never a
// constant baked into the launch: the data plane computes
// s = max(absmax, 1e-12) / 127 as an f32 division on the device, which is
// what keeps the result bit-equal to the JAX package's numpy twin).
//
// Both passes are elementwise streams: absmax reads 4 bytes an element,
// quantize reads 4 and writes 1, and neither does more than a few operations
// an element, so the card's memory rate (3.35 TB/s) bounds both. The design:
//  * no padded copy: the TPU kernels zero-pad the input into a
//    (rows, 128) grid; here both kernels read the tensor in place as float4
//    (16 bytes a thread per load) and finish the last n % 4 elements with a
//    scalar loop, so a length that is not a multiple of 4 or 128 reads no
//    padding. A pointer that is not 16-byte aligned (a view with an odd
//    offset) takes the scalar loop throughout;
//  * a grid-stride loop over a grid sized to fill every SM, so the card
//    keeps enough loads in flight to stream at its memory rate;
//  * absmax in one launch: each thread keeps a running max, the block
//    reduces it with warp shuffles, and one thread a block folds the block's
//    max into the output with atomicMax on its int bit pattern. Non-negative
//    IEEE floats order like their bit patterns as signed ints, so the
//    integer max is the float max. The output must be zeroed before the
//    launch (the wrapper allocates it with torch.zeros);
//  * quantize divides with __fdiv_rn (correctly rounded: never build this
//    file with --use_fast_math) and rounds half to even with rintf, as
//    numpy's np.round does; it writes char4.
//
// Entries: absmax_f32(...) and quantize_int8_f32(...) launch on the given
// stream, do not synchronise or allocate, launch nothing for n == 0, and
// return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;   // 8 x 256 threads = the SM's 2048

int grid_for(int64_t work) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int64_t want = (work + kThreads - 1) / kThreads;
  int64_t cap = (int64_t)sms * kBlocksPerSm;
  return (int)(want < 1 ? 1 : (want < cap ? want : cap));
}

__device__ __forceinline__ float abs_max4(float m, float4 v) {
  return fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
}

// n4: float4 loads in the vector part (0 when x is not 16-byte aligned);
// the scalar loop covers [4 * n4, n).
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ x, int64_t n, int64_t n4, int* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float m = 0.f;
  for (int64_t i = tid; i < n4; i += stride) m = abs_max4(m, x4[i]);
  for (int64_t i = 4 * n4 + tid; i < n; i += stride) m = fmaxf(m, fabsf(x[i]));

  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(out, __float_as_int(m));
  }
}

__device__ __forceinline__ signed char quantize_one(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return (signed char)__float2int_rn(r);
}

// n4 as above; q must then be 4-byte aligned (the wrapper's fresh output is).
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                signed char* __restrict__ q, int64_t n, int64_t n4) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const float s = *scale;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  char4* q4 = reinterpret_cast<char4*>(q);
  for (int64_t i = tid; i < n4; i += stride) {
    const float4 v = x4[i];
    q4[i] = make_char4(quantize_one(v.x, s), quantize_one(v.y, s),
                       quantize_one(v.z, s), quantize_one(v.w, s));
  }
  for (int64_t i = 4 * n4 + tid; i < n; i += stride) q[i] = quantize_one(x[i], s);
}

int64_t vector_loads(const void* x, const void* q, int64_t n) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (q == nullptr || reinterpret_cast<uintptr_t>(q) % 4 == 0);
  return aligned ? n / 4 : 0;
}

}  // namespace

extern "C" int absmax_f32(const float* x, int64_t n, float* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int64_t n4 = vector_loads(x, nullptr, n);
  absmax_kernel<<<grid_for(n4 > 0 ? n4 : n), kThreads, 0,
                  reinterpret_cast<cudaStream_t>(stream)>>>(x, n, n4,
                                                            reinterpret_cast<int*>(out));
  return (int)cudaGetLastError();
}

extern "C" int quantize_int8_f32(const float* x, const float* scale, int8_t* q, int64_t n,
                                 void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int64_t n4 = vector_loads(x, q, n);
  quantize_kernel<<<grid_for(n4 > 0 ? n4 : n), kThreads, 0,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
      x, scale, reinterpret_cast<signed char*>(q), n, n4);
  return (int)cudaGetLastError();
}
