// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// that Python loads through ctypes (repro_torch/kernels/flash_attention.py).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fa_kernel
// (the pl.pallas_call in flash_attention_fwd).  It computes the same
// function: blocked online-softmax attention, causal with an optional
// local window (the window only applies when causal), GQA with kv head
// bh / g, fp32 scores, running max, sum and accumulator, mask value -1e30,
// sum clamped at 1e-30, output in the input dtype (fp32 or bf16).
// Layout: q (BH, Sq, hd); k, v (BKV, Sk, hd); o (BH, Sq, hd), contiguous.
//
// What bounds it on this card.  At the serving prefill shape (q 36x128x64,
// k/v 12x128x64, bf16, causal) the function moves 1.57 MB and does 76 MFLOP:
// 0.47 us of memory traffic at 3.35 TB/s against 0.08 us of bf16 tensor-core
// work, so it is memory-bound and a launch costs more than either.  The
// design keeps every score out of device memory: a block reads its q tile
// once and each K/V tile once into shared memory, so device traffic is
// q + o plus one pass over K/V per q tile.  The arithmetic runs in fp32 on
// the CUDA cores (67 TFLOP/s), not the tensor cores: at long prompts, where
// the S^2 work dominates, this version is bound by those operations, and
// wgmma/TMA are the next step.
//
// Design, translated from the TPU kernel rather than copied block by block:
//  * One CUDA block per (64-row q tile, bh).  The TPU's sequential k grid
//    axis becomes a loop inside the block that carries the running max, sum
//    and accumulator in registers.
//  * pl.when(relevant) becomes loop bounds: a causal q tile stops at the
//    tile holding its last row, and tiles wholly before every row's window
//    are skipped.
//  * 8 warps, 8 q rows each.  Scores: lane j takes keys j and j + 32 of the
//    tile; a K row is padded to hd + 1 floats so the 32 lanes read 32
//    different banks.  The row max and sum are warp shuffles.  P.V: a lane
//    owns output dims lane + 32 t, and each p_j is broadcast by a shuffle.
//  * Tiles are converted to fp32 once, on their way into shared memory, so
//    all mask arithmetic is fp32: -1e30 stays finite (in half precision it
//    is -inf, and -inf - -inf is NaN).
//  * Shared memory is (64 hd + BK (hd + 1) + BK hd) floats: 49,408 B for
//    hd 64 and 98,560 B for hd 128 (BK 64), 131,200 B for hd 256 (BK 32).
//    All are above the 48 KB static limit, so the kernel takes dynamic
//    shared memory after cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlockQ = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

template <int HD>
__host__ __device__ constexpr int block_k() { return HD >= 256 ? 32 : 64; }

template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * HD + block_k<HD>() * (HD + 1) +
                          block_k<HD>() * HD);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
              int g, float scale, int causal, int window) {
  constexpr int BK = block_k<HD>();
  constexpr int KPL = BK / 32;  // keys per lane in the score step
  constexpr int DPL = HD / 32;  // output dims per lane
  constexpr int KS = HD + 1;    // padded K row stride
  extern __shared__ float smem[];
  float* qs = smem;             // kBlockQ x HD
  float* ks = qs + kBlockQ * HD;  // BK x KS
  float* vs = ks + BK * KS;     // BK x HD

  const int q0 = blockIdx.x * kBlockQ;
  const int bh = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* qb = q + ((size_t)bh * sq + q0) * HD;
  const T* kb = k + (size_t)(bh / g) * sk * HD;
  const T* vb = v + (size_t)(bh / g) * sk * HD;

  for (int i = threadIdx.x; i < kBlockQ * HD; i += kThreads)
    qs[i] = to_f32(qb[i]);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] = 0.f;
  }

  const int n_k = sk / BK;
  const int kt_end = causal ? min(n_k, (q0 + kBlockQ - 1) / BK + 1) : n_k;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    if (causal && window > 0 && k0 + BK - 1 <= q0 - window) continue;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < BK * HD; i += kThreads) {
      const int row = i / HD;
      const int col = i % HD;
      ks[row * KS + col] = to_f32(kb[(size_t)(k0 + row) * HD + col]);
      vs[i] = to_f32(vb[(size_t)k0 * HD + i]);
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qpos = q0 + row;
      const float* qr = qs + row * HD;
      float s[KPL];
      float m_cur = kNegInf;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int kj = lane + 32 * j;
        const float* kr = ks + kj * KS;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        dot *= scale;
        if (causal) {
          const int kpos = k0 + kj;
          bool ok = kpos <= qpos;
          if (window > 0) ok = ok && (kpos > qpos - window);
          if (!ok) dot = kNegInf;
        }
        s[j] = dot;
        m_cur = fmaxf(m_cur, dot);
      }
      m_cur = warp_max(m_cur);
      const float m_new = fmaxf(m[r], m_cur);
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        s[j] = expf(s[j] - m_new);
        p_sum += s[j];
      }
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p_sum);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[r][t] *= alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(kFullMask, s[j / 32], j % 32);
        const float* vr = vs + j * HD + lane;
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[r][t] = fmaf(pj, vr[32 * t], acc[r][t]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + ((size_t)bh * sq + q0 + row) * HD + lane;
#pragma unroll
    for (int t = 0; t < DPL; ++t) orow[32 * t] = from_f32<T>(acc[r][t] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int sq, int sk, int g, float scale, int causal,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(sq / kBlockQ, bh);
  fa_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, g, scale, causal,
      window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int bh, int sq, int sk, int hd, int g, float scale,
                        int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, bh, sq, sk, g, scale, causal, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, sq, sk, g, scale, causal, window,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, o, bh, sq, sk, g, scale, causal, window,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Tile sizes, so the Python wrapper checks shapes against the kernel's own.
int fa_block_q() { return kBlockQ; }
int fa_block_k(int hd) { return hd >= 256 ? 32 : 64; }

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
int fa_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
           int bh, int bkv, int sq, int sk, int hd, float scale, int causal,
           int window, void* stream) {
  const int g = bh / bkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, bh, sq, sk, hd, g, scale, causal,
                              window, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, bh, sq, sk, hd, g, scale,
                                      causal, window, s);
  return cudaErrorInvalidValue;
}

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
