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
// Two kernels sit behind fa_fwd, chosen by dtype:
//
// bf16: fa_fwd_tc_kernel, on the tensor cores.
//  What bounds it.  At recurrentgemma-9b's prefill shape (q 32x2560x256,
//  k/v 2x2560x256, causal, window 2048) the function moves 89 MB (27 us
//  at 3.35 TB/s) and does 1.03e11 FLOP over the pairs the window keeps
//  (104 us at 989 TFLOP/s): it is bound by tensor-core operations.  At
//  smollm-135m's (q 36x128x64, k/v 12x128x64, causal) it moves 1.57 MB
//  and does 76 MFLOP: bound by bytes (0.47 us), and in practice by the
//  launch and one tile's latency.
//  What the design does about it.
//  * S = Q K^T and O += P V run as wgmma (m64nNk16, bf16 in, fp32
//    accumulators in registers).  Q, K and V stay bf16 in shared memory,
//    in the 128-byte swizzled layout wgmma reads: 64-column blocks, each
//    rows x 128 B, 16-byte chunk c of row r stored at c ^ (r % 8).  Q and K
//    are K-major operands; V is read as an MN-major operand (transposed
//    B), so it is never transposed in memory.  P goes to the PV product
//    from registers: the S accumulator fragment, rounded to bf16 pairs, is
//    already the A-operand fragment of wgmma's register form.
//  * One consumer warpgroup per 64 q rows: a block has 2 (128 q rows) for
//    hd 128 and 256, 1 (64 rows) for hd 64, so that smollm's 36 heads x
//    128 rows make 72 blocks rather than 36.  K/V tiles are 64 keys.  Every
//    tile divides 128, so every shape that models/attention.py::_flash_ok
//    sends here is taken.
//  * K and V stream through a 2-stage ring in shared memory by cp.async:
//    tile j+1 is in flight while tile j's two products run.  Q is loaded
//    once per block.  Blocks start with the heaviest q tiles (those with
//    the most k tiles) so that the last wave is short.
//  * The online softmax runs on the accumulator fragments in fp32: a row
//    lives in the 4 threads of a quad (two shuffles for its max), exp2
//    with scale * log2(e) folded into the scores, the row sum kept per
//    thread and reduced once at the end.  P is rounded to bf16 only as
//    the A operand of PV, and the sum adds the rounded values, so the
//    output is a weighted mean of V's rows.  The mask value stays -1e30:
//    a wholly masked first tile (a window's edge) then gives p = 1 and is
//    wiped by the next rescale exp2(-1e30 - m) = 0, as in the reference;
//    with -inf it would be NaN.
//  * Tiles wholly above the diagonal or before every row's window are cut
//    by the loop bounds (per block) and skipped per warpgroup; only tiles
//    on the diagonal or the window's edge compute the mask.
//  * O is staged through Q's shared-memory tile and written with 16-byte
//    stores.
//  Budget (bytes of shared memory, 1 KB for alignment included):
//    hd 256: Q 128x256 (64 KB) + 2 stages x (K + V) 64x256 (128 KB) =
//            197,632 of the 232,448 a block may take; 256 threads, up to
//            255 registers each: O is 128 fp32 registers a thread, S 32,
//            P 16 (bf16 pairs).
//    hd 128: 99,328 (Q 32 KB + 64 KB ring); O 64 registers, S 32.
//    hd  64:  41,984 (Q 8 KB + 32 KB ring); 128 threads; O 32, S 32.
//
// fp32: fa_fwd_kernel, on the CUDA cores, exact fp32 arithmetic (the fp32
// serving-parity checks rely on it; neither bf16 nor TF32 tensor cores can
// meet their 2e-5 tolerance).
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
//  * Shared memory is (64 hd + BK (hd + 1) + BK hd) floats: 49,408 B for
//    hd 64 and 98,560 B for hd 128 (BK 64), 131,200 B for hd 256 (BK 32),
//    taken as dynamic shared memory after cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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


// ----------------------------------------------------------------------
// bf16 on the tensor cores
// ----------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kStages = 2;   // K/V ring depth
constexpr int kBlockK = 64;  // keys per tile

// Consumer warpgroups (64 q rows each) per block, by head dim.
template <int HD>
__host__ __device__ constexpr int warpgroups() { return HD == 64 ? 1 : 2; }

template <int HD>
__host__ __device__ constexpr int block_q() { return 64 * warpgroups<HD>(); }

template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + sizeof(bf16) * static_cast<size_t>(HD) *
                    (block_q<HD>() + 2 * kStages * kBlockK);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, col) in a bf16 tile of `rows` rows, laid out
// as wgmma's 128-byte swizzle wants it: 64-column blocks one after another,
// each rows x 128 B; 16-byte chunk c of row r sits at c ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int row, int col, int rows) {
  return (col >> 6) * rows * 128 + row * 128 +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// ROWS x HD from global memory (row stride HD) into the swizzled layout at
// `dst`, 16 bytes a thread per step, by cp.async.
template <int ROWS, int HD, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int tid) {
  constexpr int kChunksPerRow = HD / 8;
  static_assert(ROWS * kChunksPerRow % NT == 0, "tile does not split evenly");
#pragma unroll
  for (int j = 0; j < ROWS * kChunksPerRow / NT; ++j) {
    const int i = tid + j * NT;
    const int row = i / kChunksPerRow;
    const int col = (i % kChunksPerRow) * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     dst + swz(row, col, ROWS)),
                 "l"(src + static_cast<size_t>(row) * HD + col)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Makes this thread's generic-proxy writes to shared memory visible to
// wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a
// wgmma that is in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.  K-major
// operands (Q, K) take lbo 16 (unused) and sbo 1024, the stride between
// groups of 8 rows; the MN-major V takes lbo = the stride between 64-column
// blocks and sbo 1024, the stride between groups of 8 keys.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 64 fp32 fragment) = A B (+ d if scale_d), A and B from shared
// memory, both K-major: m64n64k16.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x N fp32 fragment) += A B, A (bf16 pairs) from registers, B from
// shared memory, MN-major (transposed): m64nNk16 for N = 64, 128, 256.
__device__ __forceinline__ void wgmma_rs_tnspb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tnspb(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tnspb(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Scores of one tile in log2 units, masked to -1e30 where a key lies after
// the row or before its window.  Fragment element i of thread `lane` is
// row row_a + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + 2 (lane & 3) + (i & 1).
template <bool kMask, int N>
__device__ __forceinline__ void scale_and_mask(float (&s)[N], float scale_log2,
                                               int row_a, int k0, int lane,
                                               int window) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] *= scale_log2;
    if (kMask) {
      const int qpos = row_a + 8 * ((i >> 1) & 1);
      const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (kpos > qpos || (window > 0 && kpos <= qpos - window)) s[i] = kNegInf;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(128 * warpgroups<HD>(), 1)
fa_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int sq,
                 int sk, int g, float scale_log2, int causal, int window) {
  constexpr int BQ = block_q<HD>();
  constexpr int BK = kBlockK;
  constexpr int NT = 128 * warpgroups<HD>();
  constexpr int kTileBytes = BK * HD * 2;
  extern __shared__ unsigned char tc_smem[];
  const uint32_t base = (smem_u32(tc_smem) + 1023) & ~1023u;
  const uint32_t q_s = base;                         // BQ x HD
  const uint32_t k_s = q_s + BQ * HD * 2;            // kStages x (BK x HD)
  const uint32_t v_s = k_s + kStages * kTileBytes;   // kStages x (BK x HD)

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int r0 = q0 + 64 * wg;                       // this warpgroup's rows
  const int row_a = r0 + 16 * warp + (lane >> 2);    // and this thread's: +0, +8
  const bf16* kb = k + static_cast<size_t>(bh / g) * sk * HD;
  const bf16* vb = v + static_cast<size_t>(bh / g) * sk * HD;

  const int n_k = sk / BK;
  const int kt_end = causal ? min(n_k, (q0 + BQ - 1) / BK + 1) : n_k;
  const int kt_begin =
      (causal && window > 0) ? max(0, (q0 - window + 1) / BK) : 0;

  load_tile<BQ, HD, NT>(q_s, q + (static_cast<size_t>(bh) * sq + q0) * HD,
                        tid);
  load_tile<BK, HD, NT>(k_s, kb + static_cast<size_t>(kt_begin) * BK * HD, tid);
  load_tile<BK, HD, NT>(v_s, vb + static_cast<size_t>(kt_begin) * BK * HD, tid);
  cp_async_commit();

  float acc[HD / 2];  // O, 64 x HD per warpgroup
  float s[BK / 2];    // S, 64 x BK per warpgroup
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      const size_t next = static_cast<size_t>(kt + 1) * BK * HD;
      load_tile<BK, HD, NT>(k_s + (stage ^ 1) * kTileBytes, kb + next, tid);
      load_tile<BK, HD, NT>(v_s + (stage ^ 1) * kTileBytes, vb + next, tid);
    }
    cp_async_commit();
    cp_async_wait_1();  // tile kt (and Q) landed; tile kt + 1 may be in flight
    fence_async_proxy();
    __syncthreads();

    const int k0 = kt * BK;
    const bool relevant =
        !causal || (k0 <= r0 + 63 && (window == 0 || k0 + BK - 1 > r0 - window));
    if (relevant) {  // uniform across the warpgroup
      const uint32_t ks = k_s + stage * kTileBytes;
      const uint32_t vs = v_s + stage * kTileBytes;
      // S = Q K^T: HD / 16 steps of k16
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk >> 2), off = (kk & 3) * 32;
        wgmma_ss(s, desc(q_s + col * BQ * 128 + wg * 64 * 128 + off, 16, 1024),
                 desc(ks + col * BK * 128 + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      const bool need_mask =
          causal && (k0 + BK - 1 > r0 || (window > 0 && k0 <= r0 + 63 - window));
      if (need_mask)
        scale_and_mask<true>(s, scale_log2, row_a, k0, lane, window);
      else
        scale_and_mask<false>(s, scale_log2, row_a, k0, lane, window);

      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // a row lives in the 4 threads of a quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 2));
        alpha[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
      }
      // P as bf16 pairs; p[4 kk .. 4 kk + 3] is PV's A fragment for step kk
      uint32_t p[BK / 4];
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int r = (i >> 1) & 1;
        p[i >> 1] = pack_bf16(ex2(s[i] - m[r]), ex2(s[i + 1] - m[r]));
        const float2 rounded = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&p[i >> 1]));
        psum[r] += rounded.x + rounded.y;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V: BK / 16 steps of k16, V read MN-major
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        wgmma_rs_tnspb(acc, a, desc(vs + kk * 16 * 128, BK * 128, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncthreads();  // every warpgroup is done with this stage
  }
  cp_async_wait_all();

  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = l[r] + __shfl_xor_sync(kFullMask, l[r], 1);
    t += __shfl_xor_sync(kFullMask, t, 2);
    denom[r] = fmaxf(t, 1e-30f);
  }
  // O through Q's shared-memory tile (free now), then 16-byte stores
  unsigned char* tile = tc_smem + (base - smem_u32(tc_smem));
  const int row_l = row_a - q0;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(tile + swz(row_l + 8 * r, col, BQ)) =
        pack_bf16(acc[i] / denom[r], acc[i + 1] / denom[r]);
  }
  __syncthreads();
  constexpr int kChunksPerRow = HD / 8;
  bf16* ob = o + (static_cast<size_t>(bh) * sq + q0) * HD;
#pragma unroll
  for (int j = 0; j < BQ * kChunksPerRow / NT; ++j) {
    const int i = tid + j * NT;
    const int row = i / kChunksPerRow;
    const int col = (i % kChunksPerRow) * 8;
    *reinterpret_cast<uint4*>(ob + static_cast<size_t>(row) * HD + col) =
        *reinterpret_cast<const uint4*>(tile + swz(row, col, BQ));
  }
}

}  // namespace tc

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

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int bh, int sq, int sk, int g, float scale, int causal,
                      int window, cudaStream_t stream) {
  constexpr size_t smem = tc::smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      tc::fa_fwd_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, sq / tc::block_q<HD>());
  const float log2e = 1.4426950408889634f;
  tc::fa_fwd_tc_kernel<HD><<<grid, 128 * tc::warpgroups<HD>(), smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), sq, sk, g,
      scale * log2e, causal, window);
  return cudaGetLastError();
}

// dtype 0 (fp32) takes the CUDA-core kernel, 1 (bf16) the tensor-core one.
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int dtype, int bh, int sq, int sk, int hd, int g,
                     float scale, int causal, int window, cudaStream_t s) {
#define FA_CASE(HD)                                                          \
  case HD:                                                                   \
    return dtype == 0 ? launch<float, HD>(q, k, v, o, bh, sq, sk, g, scale,  \
                                          causal, window, s)                 \
                      : launch_tc<HD>(q, k, v, o, bh, sq, sk, g, scale,      \
                                      causal, window, s);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (hd) {
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

extern "C" {

// Tile sizes by dtype (0 fp32, 1 bf16) and head dim, so the Python wrapper
// checks shapes against the kernel's own; 0 for what no kernel takes.
int fa_block_q(int dtype, int hd) {
  if (hd != 64 && hd != 128 && hd != 256) return 0;
  if (dtype == 0) return kBlockQ;
  if (dtype == 1) return hd == 64 ? tc::block_q<64>() : tc::block_q<128>();
  return 0;
}

int fa_block_k(int dtype, int hd) {
  if (hd != 64 && hd != 128 && hd != 256) return 0;
  if (dtype == 0) return hd >= 256 ? block_k<256>() : block_k<64>();
  if (dtype == 1) return tc::kBlockK;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
int fa_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
           int bh, int bkv, int sq, int sk, int hd, float scale, int causal,
           int window, void* stream) {
  return dispatch(q, k, v, o, dtype, bh, sq, sk, hd, bh / bkv, scale, causal,
                  window, static_cast<cudaStream_t>(stream));
}

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
