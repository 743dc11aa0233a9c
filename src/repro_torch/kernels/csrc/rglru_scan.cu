// RG-LRU linear recurrence for Hopper (sm_90a), with a plain C interface
// that Python loads through ctypes (repro_torch/kernels/rglru.py).
//
// Replaces the TPU kernel repro/kernels/rglru.py::_rglru_kernel (the
// pl.pallas_call in rglru_scan).  It computes the same function:
//   h_t = a_t * h_{t-1} + x_t  over t = 0 .. S-1, from h_{-1} = h0,
// with the carry in fp32.  a and x are (B, S, D), fp32 or bf16, read as
// fp32; h0 is (B, D) fp32; h_seq (B, S, D) and h_last (B, D) are fp32.
// All contiguous.  Any S and any D: the TPU's chunk and lane-block asserts
// do not carry over.
//
// What bounds it on this card.  At the serving prefill shape (2, 2560,
// 4096) in fp32 the function reads a and x and writes h_seq: 251.7 MB, or
// 0.075 ms at 3.35 TB/s, against 2 flops an element (0.0006 ms at 67
// TFLOP/s), so bytes bound it.  This version does not reach that bound:
// time is sequential within a lane, so the card holds only B * D = 8,192
// independent chains, 128 blocks of 64 threads on 132 SMs, and each step's
// loads wait on device-memory latency rather than bandwidth.  A chunked
// two-pass scan (per-chunk products and local scans, then a carry fix-up)
// puts S-fold more work in flight and is the redesign for a later change.
//
// Design, translated from the TPU kernel rather than copied block by block:
//  * The TPU walks time inside VMEM chunks with the carry in scratch across
//    a sequential grid axis.  Here one thread owns one (b, d) lane and walks
//    all of time with the carry in a register; nothing crosses blocks.
//  * Neighbouring threads own neighbouring d, so every load and store of a
//    time step is coalesced across the warp.
//  * Time is unrolled by kUnroll steps, and the next kUnroll steps' a and x
//    are loaded before the current ones are consumed, so 2 * kUnroll loads
//    per thread are in flight while the dependent chain of FMAs runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                  const float* __restrict__ h0, float* __restrict__ h_seq,
                  float* __restrict__ h_last, int b, int s, int d) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= (long long)b * d) return;
  const size_t bi = lane / d;
  const size_t di = lane % d;
  const size_t base = bi * s * d + di;
  const size_t step = d;
  const T* ap = a + base;
  const T* xp = x + base;
  float* hp = h_seq + base;

  float h = h0[lane];
  const int s_main = s - s % kUnroll;
  float ra[kUnroll], rx[kUnroll];
  if (s_main > 0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ra[u] = to_f32(ap[u * step]);
      rx[u] = to_f32(xp[u * step]);
    }
  }
  for (int t0 = 0; t0 < s_main; t0 += kUnroll) {
    const bool more = t0 + kUnroll < s_main;
    float na[kUnroll], nx[kUnroll];
    if (more) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        na[u] = to_f32(ap[(t0 + kUnroll + u) * step]);
        nx[u] = to_f32(xp[(t0 + kUnroll + u) * step]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = fmaf(ra[u], h, rx[u]);
      hp[(t0 + u) * step] = h;
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        ra[u] = na[u];
        rx[u] = nx[u];
      }
    }
  }
  for (int t = s_main; t < s; ++t) {
    h = fmaf(to_f32(ap[t * step]), h, to_f32(xp[t * step]));
    hp[t * step] = h;
  }
  h_last[lane] = h;
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const void* h0, void* h_seq,
                   void* h_last, int b, int s, int d, cudaStream_t stream) {
  const long long lanes = (long long)b * d;
  const unsigned blocks = (unsigned)((lanes + kThreads - 1) / kThreads);
  rglru_scan_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<const float*>(h0), static_cast<float*>(h_seq),
      static_cast<float*>(h_last), b, s, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of a and x: 0 = float32, 1 = bfloat16.  Returns a cudaError_t
// (0 = launched).
int rglru_scan(const void* a, const void* x, const void* h0, void* h_seq,
               void* h_last, int dtype, int b, int s, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, x, h0, h_seq, h_last, b, s, d, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, x, h0, h_seq, h_last, b, s, d, st);
  return cudaErrorInvalidValue;
}

const char* rglru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
