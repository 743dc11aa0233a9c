// Blockwise int8 quantize and dequantize for Hopper (sm_90a), with a plain C
// interface that Python loads through ctypes (repro_torch/kernels/quantize.py).
//
// Replaces the TPU kernels repro/kernels/quantize.py::_quant_kernel and
// ::_dequant_kernel (the pl.pallas_calls in quantize_int8 and
// dequantize_int8).  They compute the same functions:
//   scale_i = max(max_j |x_ij|, 1e-12) / 127
//   q_ij    = clip(round_half_even(x_ij / scale_i), -127, 127)  as int8
//   x'_ij   = (float) q_ij * scale_i
// over scale blocks of `block` consecutive fp32 elements.  The codes are
// bit-equal to numpy's and torch's: the kernel divides by the scale (never
// multiplies by its reciprocal, which moves a code by one at .5
// boundaries), rintf rounds half to even, and the library is built without
// --use_fast_math, so the division is IEEE round-to-nearest.
//
// What bounds them on this card.  For one 4096 x 12288 fp32 matrix (N =
// 50,331,648, block 256) each function moves 252.4 MB (fp32 in or out,
// int8 codes, fp32 scales): 0.075 ms at 3.35 TB/s, against a few
// operations an element, so bytes bound both.  Each reads and writes every
// byte once, in 16-byte (fp32) and 4-byte (int8) vectors that neighbouring
// threads take from neighbouring addresses.
//
// Design, translated from the TPU kernels rather than copied block by block:
//  * quantize: the TPU takes (rows, block) tiles into VMEM and reduces each
//    row on the VPU.  Here one warp owns one scale block: each lane loads
//    block / 128 float4s into registers, a warp-shuffle max gives the
//    block's max |x|, and the lane codes its own values from the registers,
//    so x is read once.  8 warps to a CUDA block.
//  * dequantize: elementwise; one thread turns 4 codes (one char4) into a
//    float4, with a grid-stride loop.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ signed char code(float x, float scale) {
  const float r = rintf(x / scale);
  return static_cast<signed char>(fminf(fmaxf(r, -127.f), 127.f));
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// V float4s a lane: block = 128 * V elements.
template <int V>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, char4* __restrict__ q,
                float* __restrict__ scales, long long nb) {
  constexpr int kVecs = V * 32;  // float4s in one scale block
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= nb) return;  // the whole warp leaves together
  const float4* xr = reinterpret_cast<const float4*>(x) + row * kVecs;
  float4 v[V];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i] = xr[i * 32 + lane];
    amax = fmaxf(amax, abs_max4(v[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(kFullMask, amax, off));
  const float scale = fmaxf(amax, 1e-12f) / 127.0f;
  char4* qr = q + row * kVecs;
#pragma unroll
  for (int i = 0; i < V; ++i)
    qr[i * 32 + lane] = make_char4(code(v[i].x, scale), code(v[i].y, scale),
                                   code(v[i].z, scale), code(v[i].w, scale));
  if (lane == 0) scales[row] = scale;
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const char4* __restrict__ q, const float* __restrict__ scales,
                  float4* __restrict__ out, long long n4, int block4) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const char4 c = q[i];
    const float s = scales[i / block4];
    out[i] = make_float4((float)c.x * s, (float)c.y * s, (float)c.z * s,
                         (float)c.w * s);
  }
}

template <int V>
cudaError_t launch_quantize(const void* x, void* q, void* scales,
                            long long nb, cudaStream_t stream) {
  const long long blocks = (nb + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  quantize_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<char4*>(q),
      static_cast<float*>(scales), nb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (nb * block,) fp32 -> q (nb, block) int8, scales (nb,) fp32.
// block is 128, 256, 512 or 1024.  Returns a cudaError_t (0 = launched).
int quantize_int8(const void* x, void* q, void* scales, long long nb,
                  int block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 128: return launch_quantize<1>(x, q, scales, nb, st);
    case 256: return launch_quantize<2>(x, q, scales, nb, st);
    case 512: return launch_quantize<4>(x, q, scales, nb, st);
    case 1024: return launch_quantize<8>(x, q, scales, nb, st);
    default: return cudaErrorInvalidValue;
  }
}

// q (nb, block) int8, scales (nb,) fp32 -> out (nb * block,) fp32.
// block is a multiple of 4.  Returns a cudaError_t (0 = launched).
int dequantize_int8(const void* q, const void* scales, void* out,
                    long long nb, int block, void* stream) {
  if (block % 4) return cudaErrorInvalidValue;
  const long long n4 = nb * (block / 4);
  long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  dequantize_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char4*>(q), static_cast<const float*>(scales),
      static_cast<float4*>(out), n4, block / 4);
  return cudaGetLastError();
}

const char* quantize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
