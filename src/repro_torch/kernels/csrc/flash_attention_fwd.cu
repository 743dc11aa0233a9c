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
// fp32: fa_fwd_kernel, on the CUDA cores in exact fp32 FMA arithmetic: no
// mma, wgmma or TF32 (the fp32 serving-parity checks rely on it; neither
// bf16 nor TF32 tensor cores can meet their 2e-5 tolerance).
//  What bounds it.  At recurrentgemma-9b's serve-parity shape (q
//  16x2560x256, k/v 1x2560x256, fp32, causal, window 2048) the function
//  moves 89 MB (27 us at 3.35 TB/s) and does 5.16e10 FLOP over the pairs
//  the window keeps (0.77 ms at 67 TFLOP/s): it is bound by fp32
//  operations.  At smollm-135m's (q 18x128x64, k/v 6x128x64, causal) it
//  moves 1.57 MB and does 38 MFLOP (0.57 us): bound by operations on
//  paper, in practice by the launch and one tile's latency.  On the CUDA
//  cores the rate is set by what feeds the FMAs: an SM issues one warp
//  instruction a clock per scheduler and its shared memory delivers 128
//  bytes a clock against 128 FMA lanes, so every shared-memory load has
//  to feed many FMAs.
//  What the design does about it.
//  * Both products are SIMT GEMMs tiled in registers.  A block takes 64 q
//    rows and 8 warps and walks 64-key tiles.  S = Q K^T: a warp computes
//    8 rows x 64 keys, a thread 4 rows x 4 keys as an outer product over
//    hd, reading float4s along hd: 8 LDS.128 feed 64 FMAs.  O += P V: O
//    (64 x hd) stays in registers across all key tiles, a thread 8 rows x
//    hd/32 columns, 8 P values and hd/32 V values (float4s) feeding
//    8 x hd/32 FMAs a key.  P goes from the S layout to the PV layout
//    through a 64 x 64 tile in shared memory, stored transposed (keys x
//    rows) so that a thread's 8 rows are two float4s.  Q and K rows are
//    padded by 16 bytes, so the float4 reads of a warp fall in distinct
//    banks or broadcast; V and P^T reads are conflict free without padding.
//  * K and V stream through shared memory by 16-byte cp.async, each in its
//    own buffer: K(j+1) is copied while tile j's softmax and PV run, V(j+1)
//    while tile j+1's QK^T runs.  At hd 256 two stages of both would not
//    fit beside Q at 64-key tiles; this split keeps one copy in flight
//    behind every product.  Q is loaded once per block.
//  * Online softmax in fp32 on the S fragments: a row lives in the 16
//    lanes of a half-warp (four xor shuffles for its max); the row sum is
//    kept per thread and reduced once at the end.  Scores stay in raw
//    units and exp2 takes (s - m) * scale * log2(e): folding the scale
//    into the scores instead would round each score apart, an error that
//    grows with the logits and not with their distance from the row's
//    max.  The mask value stays -1e30: a wholly
//    masked first tile (a window's edge) gives p = 1 and is wiped by the
//    next rescale, as in the reference; with -inf it would be NaN.
//  * Tiles wholly above the diagonal or before every row's window are cut
//    by the loop bounds; only tiles on the diagonal or the window's edge
//    compute the mask.  Blocks start with the heaviest q tiles (those with
//    the most k tiles) so that the last wave is short.
//  Budget (bytes of shared memory; rows of Q and K padded to hd + 4
//  floats, P^T to 68; 256 threads, one block an SM: at hd 256 for its
//  shared memory, at every hd for its registers):
//    hd 256: Q 64x260 (66,560) + K 64x260 (66,560) + V 64x256 (65,536) +
//            P^T 64x68 (17,408) + row scales and sums (512) = 216,576 of
//            the 232,448 a block may take; O is 64 registers a thread,
//            S 16, the Q and K operands 32.
//    hd 128: 118,272; O 32 registers.
//    hd  64:  69,120; O 16 registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

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

// ----------------------------------------------------------------------
// fp32 on the CUDA cores
// ----------------------------------------------------------------------

namespace simt {

constexpr int kBlockQ = 64;   // q rows a block
constexpr int kBlockK = 64;   // keys a tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kPStride = kBlockQ + 4;  // a row of P^T: 64 q rows + 16 B

// Offsets (in floats) of the block's shared-memory tiles.
template <int HD>
struct Layout {
  static constexpr int kQKStride = HD + 4;  // a Q or K row + 16 B
  static constexpr int q = 0;                                  // 64 x (HD+4)
  static constexpr int k = q + kBlockQ * kQKStride;            // 64 x (HD+4)
  static constexpr int v = k + kBlockK * kQKStride;            // 64 x HD
  static constexpr int p = v + kBlockK * HD;                   // 64 keys x 68
  static constexpr int alpha = p + kBlockK * kPStride;         // 64 rescales
  static constexpr int l = alpha + kBlockQ;                    // 64 row sums
  static constexpr int floats = l + kBlockQ;
};

template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * Layout<HD>::floats;
}

// ROWS x HD floats from global memory (row stride HD) into shared memory
// (row stride STRIDE), 16 bytes a thread per step, by cp.async.
template <int ROWS, int HD, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int tid) {
  constexpr int kChunksPerRow = HD / 4;
  static_assert(ROWS * kChunksPerRow % kThreads == 0,
                "tile does not split evenly");
#pragma unroll
  for (int j = 0; j < ROWS * kChunksPerRow / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int row = i / kChunksPerRow;
    const int col = (i % kChunksPerRow) * 4;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     tc::smem_u32(dst + row * STRIDE + col)),
                 "l"(src + static_cast<size_t>(row) * HD + col)
                 : "memory");
  }
}

// VW consecutive floats (VW = 2 or 4) from shared or global memory.
template <int VW>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x;
    dst[1] = t.y;
    dst[2] = t.z;
    dst[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x;
    dst[1] = t.y;
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                  src[3]);
  else
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int sq,
              int sk, int g, float scale_log2, int causal, int window) {
  using L = Layout<HD>;
  constexpr int BQ = kBlockQ, BK = kBlockK, QKS = L::kQKStride;
  constexpr int VW = HD >= 128 ? 4 : 2;  // floats a V vector
  constexpr int NV = HD / 32 / VW;       // V vectors a thread, per row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::q;
  float* ks = smem + L::k;
  float* vs = smem + L::v;
  float* ps = smem + L::p;  // P^T: [key][q row]
  float* alpha_s = smem + L::alpha;
  float* l_s = smem + L::l;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const float* kb = k + static_cast<size_t>(bh / g) * sk * HD;
  const float* vb = v + static_cast<size_t>(bh / g) * sk * HD;

  // S layout: warp w has rows 8w..8w+7 of the tile; lane 16 rg + kg has
  // rows s_row + 2i (i < 4) and keys kg + 16c (c < 4).  A row's 64 keys
  // are the 16 lanes of one half-warp.
  const int kg = lane & 15;
  const int s_row = 8 * warp + (lane >> 4);
  // O layout: warp w has rows 32 (w & 1) .. +31 and columns (w >> 1) HD/4
  // .. +HD/4-1; lane 8 rg + cg has rows o_row + r (r < 8) and the NV
  // vectors of VW columns at o_col + 8 VW t.
  const int o_row = 32 * (warp & 1) + 8 * (lane >> 3);
  const int o_col = (warp >> 1) * (HD / 4) + (lane & 7) * VW;

  const int n_k = sk / BK;
  const int kt_end = causal ? min(n_k, (q0 + BQ - 1) / BK + 1) : n_k;
  const int kt_begin =
      (causal && window > 0) ? max(0, (q0 - window + 1) / BK) : 0;

  // Groups of copies, in order: Q + K(begin), V(begin), then each tile
  // one K group and one V group (empty past the last tile).
  load_tile<BQ, HD, QKS>(qs, q + (static_cast<size_t>(bh) * sq + q0) * HD,
                         tid);
  load_tile<BK, HD, QKS>(ks, kb + static_cast<size_t>(kt_begin) * BK * HD,
                         tid);
  tc::cp_async_commit();
  load_tile<BK, HD, HD>(vs, vb + static_cast<size_t>(kt_begin) * BK * HD,
                        tid);
  tc::cp_async_commit();

  float m[4], l[4];       // running max (raw score units), this lane's sum
  float acc[8][NV * VW];  // O rows o_row + r
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < NV * VW; ++c) acc[r][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const bool more = kt + 1 < kt_end;
    tc::cp_async_wait_1();  // Q and K(kt) landed; V(kt) may be in flight
    __syncthreads();

    // S = Q K^T, 4 x 4 a thread, float4 steps along hd
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (s_row + 2 * i) * QKS +
                                                 d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(ks + (kg + 16 * c) * QKS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qv[i].x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv[c].w, s[i][c]);
        }
    }
    __syncthreads();  // every warp is done with K(kt)
    if (more)
      load_tile<BK, HD, QKS>(
          ks, kb + static_cast<size_t>(kt + 1) * BK * HD, tid);
    tc::cp_async_commit();

    // online softmax; only tiles on the diagonal or a window's edge mask
    const bool need_mask =
        causal &&
        (k0 + BK - 1 > q0 || (window > 0 && k0 <= q0 + BQ - 1 - window));
    if (need_mask) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qpos = q0 + s_row + 2 * i;
          const int kpos = k0 + kg + 16 * c;
          if (kpos > qpos || (window > 0 && kpos <= qpos - window))
            s[i][c] = kNegInf;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f((m[i] - m_new) * scale_log2);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f((s[i][c] - m_new) * scale_log2);
        sum += p;
        ps[(kg + 16 * c) * kPStride + s_row + 2 * i] = p;
      }
      l[i] = l[i] * alpha + sum;
      if (kg == 0) alpha_s[s_row + 2 * i] = alpha;
    }
    tc::cp_async_wait_1();  // V(kt) landed; K(kt + 1) may be in flight
    __syncthreads();        // P, the rescales and V(kt) are visible

    // O = O alpha + P V, 8 rows x NV VW columns a thread, one key a step
    float rescale[8];
    load_vec<4>(rescale, alpha_s + o_row);
    load_vec<4>(rescale + 4, alpha_s + o_row + 4);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < NV * VW; ++c) acc[r][c] *= rescale[r];
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      float p[8], vv[NV * VW];
      load_vec<4>(p, ps + j * kPStride + o_row);
      load_vec<4>(p + 4, ps + j * kPStride + o_row + 4);
#pragma unroll
      for (int t = 0; t < NV; ++t)
        load_vec<VW>(vv + t * VW, vs + j * HD + o_col + 8 * VW * t);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < NV * VW; ++c)
          acc[r][c] = fmaf(p[r], vv[c], acc[r][c]);
    }
    __syncthreads();  // every warp is done with V(kt), P and the rescales
    if (more)
      load_tile<BK, HD, HD>(vs, vb + static_cast<size_t>(kt + 1) * BK * HD,
                            tid);
    tc::cp_async_commit();
  }
  tc::cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float t = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      t += __shfl_xor_sync(kFullMask, t, off);
    if (kg == 0) l_s[s_row + 2 * i] = fmaxf(t, 1e-30f);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float denom = l_s[o_row + r];
    float* orow = o + (static_cast<size_t>(bh) * sq + q0 + o_row + r) * HD;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      float out[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) out[e] = acc[r][t * VW + e] / denom;
      store_vec<VW>(orow + o_col + 8 * VW * t, out);
    }
  }
}

}  // namespace simt

template <int HD>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        int bh, int sq, int sk, int g, float scale,
                        int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = simt::smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      simt::fa_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, sq / simt::kBlockQ);
  const float scale_log2 =
      static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  simt::fa_fwd_kernel<HD><<<grid, simt::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, g,
      scale_log2, causal, window);
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
    return dtype == 0 ? launch_fp32<HD>(q, k, v, o, bh, sq, sk, g, scale,   \
                                        causal, window, s)                   \
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
  if (dtype == 0) return simt::kBlockQ;
  if (dtype == 1) return hd == 64 ? tc::block_q<64>() : tc::block_q<128>();
  return 0;
}

int fa_block_k(int dtype, int hd) {
  if (hd != 64 && hd != 128 && hd != 256) return 0;
  if (dtype == 0) return simt::kBlockK;
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
