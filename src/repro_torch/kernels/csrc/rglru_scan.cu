// RG-LRU linear recurrence for Hopper (sm_90a), with a plain C interface
// that Python loads through ctypes (repro_torch/kernels/rglru.py).
//
// Replaces the TPU kernel repro/kernels/rglru.py::_rglru_kernel (the
// pl.pallas_call in rglru_scan).  It computes the same function:
//   h_t = a_t * h_{t-1} + x_t  over t = 0 .. S-1, from h_{-1} = h0,
// with the carry in fp32.  a and x are (B, S, D), fp32 or bf16, read as
// fp32; h0 is (B, D) fp32; h_seq (B, S, D) and h_last (B, D) are fp32.
// All contiguous.  Any S >= 1 and any D: the TPU's chunk and lane-block
// asserts do not carry over.
//
// What bounds it on this card.  At the serving prefill shape (2, 2560,
// 4096) in fp32 the function reads a and x and writes h_seq: 251.7 MB, or
// 0.075 ms at 3.35 TB/s, against 2 flops an element (0.0006 ms at 67
// TFLOP/s), so bytes bound it.  Reaching that rate takes several MB of
// loads in flight at once (bandwidth times device-memory latency under
// load).  One thread per (b, d) lane walking all of time has only B * D
// chains, too few to put that much in flight, and at B = 1 fills half the
// SMs.
//
// Design: a single-pass, time-chunked scan with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016), applied lane by lane.  The recurrence composes:
// a chunk maps h_in to A * h_in + X, with A the product of its a_t and X
// its scan from h = 0, and (A2, X2) o (A1, X1) = (A2 A1, A2 X1 + X2).
//  * A tile is kChunk steps x kLanes lanes of one batch row; a thread owns
//    one lane of it.  (2, 2560, 4096) is 40 chunks x 64 columns (batch
//    row, lane tile) = 2,560 tiles, 1,280 at B = 1.
//  * Persistent blocks, as many as fit on the card (three an SM in fp32,
//    where a tile takes 64 KB of shared memory), take tiles from an atomic
//    ticket in chunk-major order.  A block copies its tile's a and x into
//    shared memory with cp.async, so the whole tile is in flight at once
//    and costs no registers; a warp's copies are contiguous rows of it.
//    While one block waits on its loads, the others on its SM scan,
//    look back or store.
//  * Local pass: each thread computes its lane's (A, X) from the tile.
//  * Look-back: warp 0 reads the flags of the 32 chunks before this one
//    in the same column at once, and is done when every chunk before the
//    nearest INCLUSIVE one has published its AGGREGATE (sliding back 32
//    chunks when none of them is INCLUSIVE).  If the first read does not
//    settle it, the block publishes its own (A, X) and flag AGGREGATE, so
//    that later chunks need not wait for it, and reads until settled.
//    Every thread then folds the inclusive carry-out and the aggregates
//    after it into its lane's carry-in; the first chunk starts from h0.
//  * The block publishes its carry-out A * h_in + X (flag INCLUSIVE), then
//    recomputes h_t from the carry-in over the tile and writes h_seq; the
//    last chunk writes h_last.
//  So a and x are read once and h_seq is written once.  The carry into a
//  chunk is the same chain of fmas (the chunks' (A, X) applied in order to
//  h0) whatever depth the look-back stops at.  Scratch (flags, carry-outs,
//  the aggregates that were needed) is L2-resident and a few percent of
//  those bytes.  Where the caller passes a counts array, the kernel adds
//  the lanes it folded, the flag reads and the lanes it published to it,
//  from which kernels/rglru.py::scratch_traffic says how much.
//
// Traps it handles:
//  * CUDA does not schedule blocks in blockIdx order.  Tickets are taken in
//    order, and a block takes its next ticket only while it works on the
//    one before, so the smallest unfinished ticket always has every earlier
//    chunk of its column finished: no block waits on one that cannot run.
//  * Flags are written with st.release.gpu after a block barrier (which
//    orders every thread's scratch stores before it) and read with
//    ld.acquire.gpu by warp 0 before a block barrier; the values behind
//    them are read from L2 (ld.global.cg), never from a stale L1 line.
//  * The caller allocates the scratch for each call on its stream and
//    passes its layout, kernels/rglru.py::rglru_plan, which is the only
//    copy of it; the launch zeroes its first flag_bytes (ticket and flags)
//    on that stream first, and the rest needs no zeroing.
//  * Ragged edges: steps past S in the last chunk act as a = 1, x = 0
//    (they leave h unchanged and are not stored); lanes past D load and
//    store nothing.  cp.async copies 4 bytes a lane (two lanes in bf16);
//    bf16 rows that are not 4-byte aligned (odd D, or a view that starts
//    at an odd element) are copied through registers instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kChunk = 64;    // time steps of a tile
constexpr int kLanes = 128;   // lanes of a tile = threads a block
constexpr unsigned kAggregate = 1;
constexpr unsigned kInclusive = 2;

template <typename T>
constexpr int tile_bytes() {
  return 2 * kChunk * kLanes * (int)sizeof(T);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(s), "l"(src) : "memory");
}

// The tile plan and scratch layout that kernels/rglru.py::rglru_plan
// computes and passes down, field for field (ten 64-bit integers).  In
// scratch, in bytes from its start: a u32 ticket, from flags_offset one u32
// flag per tile at [column * n_chunks + chunk], and from agg_offset and
// incl_offset the (A, X) pairs and the carry-outs, (n_chunks - 1) x B x D
// of each, at [chunk * B * D + b * D + d].
struct Plan {
  long long chunk, lanes, n_chunks, lane_tiles, tiles;
  long long flags_offset, flag_bytes, agg_offset, incl_offset, scratch_bytes;
};

struct Tile {
  int chunk, bi, d0, lanes, t0, steps;
  long long column;
};

// Tickets run chunk-major: all columns of chunk 0, then of chunk 1, ...
__device__ __forceinline__ Tile tile_of(long long ticket, const Plan& p,
                                        int b, int s, int d) {
  const long long columns = b * p.lane_tiles;
  Tile t;
  t.chunk = (int)(ticket / columns);
  t.column = ticket % columns;
  t.bi = (int)(t.column / p.lane_tiles);
  t.d0 = (int)(t.column % p.lane_tiles) * kLanes;
  t.lanes = min(kLanes, d - t.d0);
  t.t0 = t.chunk * kChunk;
  t.steps = min(kChunk, s - t.t0);
  return t;
}

// Starts the copies of a tile's a and x into shared memory ([step][lane]);
// by 4-byte cp.async where every row of a and x is 4-byte aligned (`vec`).
template <typename T>
__device__ __forceinline__ void load_tile(T* sa, T* sx, const T* a,
                                          const T* x, const Tile& t, int s,
                                          int d, bool vec) {
  constexpr int per = 4 / (int)sizeof(T);  // elements a 4-byte copy
  constexpr int units = kLanes / per;      // copies a row
  constexpr int rows_per_pass = kLanes / units;
  const size_t row0 = ((size_t)t.bi * s + t.t0) * d + t.d0;
  const int lane = (threadIdx.x % units) * per;
  if (lane >= t.lanes) return;
  if (vec) {
#pragma unroll 8
    for (int r = threadIdx.x / units; r < t.steps; r += rows_per_pass) {
      const size_t g = row0 + (size_t)r * d + lane;
      cp_async4(sa + r * kLanes + lane, a + g);
      cp_async4(sx + r * kLanes + lane, x + g);
    }
  } else {
    for (int r = threadIdx.x / units; r < t.steps; r += rows_per_pass) {
      for (int e = lane; e < min(lane + per, t.lanes); ++e) {
        const size_t g = row0 + (size_t)r * d + e;
        sa[r * kLanes + e] = a[g];
        sx[r * kLanes + e] = x[g];
      }
    }
  }
}

// Warp 0: the number of aggregates between this chunk and the nearest
// INCLUSIVE one before it; -1 if `once` and a chunk before that one has
// published nothing yet.
__device__ __forceinline__ int look_back(const unsigned* column_flags,
                                         int chunk, bool once,
                                         unsigned* polls) {
  int depth = 0;
  while (true) {
    const int p = chunk - 1 - depth - (int)threadIdx.x;
    const unsigned f = p >= 0 ? ld_acquire(&column_flags[p]) : kInclusive;
    ++*polls;
    const unsigned inc = __ballot_sync(0xffffffffu, f == kInclusive);
    const unsigned none = __ballot_sync(0xffffffffu, f == 0);
    const int first = inc ? __ffs(inc) - 1 : 32;
    const unsigned before = first == 32 ? 0xffffffffu : (1u << first) - 1;
    if (none & before) {
      if (once) return -1;
      continue;
    }
    if (inc) return depth + first;
    depth += 32;
  }
}

template <typename T>
__global__ void __launch_bounds__(kLanes)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                  const float* __restrict__ h0, float* __restrict__ h_seq,
                  float* __restrict__ h_last, unsigned char* scratch,
                  unsigned long long* counts, const Plan p, int b, int s,
                  int d, bool vec) {
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  unsigned* flags = reinterpret_cast<unsigned*>(scratch + p.flags_offset);
  float2* agg = reinterpret_cast<float2*>(scratch + p.agg_offset);
  float* incl = reinterpret_cast<float*>(scratch + p.incl_offset);
  const long long bd = (long long)b * d;

  extern __shared__ __align__(16) unsigned char smem[];
  T* const tile_a = reinterpret_cast<T*>(smem);
  T* const tile_x = tile_a + kChunk * kLanes;
  __shared__ long long s_first, s_next;
  __shared__ int s_depth;

  if (threadIdx.x == 0) s_first = atomicAdd(ticket, 1u);
  __syncthreads();
  long long tk = s_first;
  if (tk < p.tiles)
    load_tile(tile_a, tile_x, a, x, tile_of(tk, p, b, s, d), s, d, vec);

  while (tk < p.tiles) {
    const Tile t = tile_of(tk, p, b, s, d);
    // the next ticket, taken now so that its round trip overlaps the loads
    unsigned next = 0;
    if (threadIdx.x == 0) next = atomicAdd(ticket, 1u);
    asm volatile("cp.async.wait_all;" ::: "memory");
    if (threadIdx.x == 0) s_next = next;
    __syncthreads();
    const long long following = s_next;

    const T* sa = tile_a + threadIdx.x;
    const T* sx = tile_x + threadIdx.x;
    const bool valid = (int)threadIdx.x < t.lanes;
    const long long lane = (long long)t.bi * d + t.d0 + threadIdx.x;
    const bool last = t.chunk == p.n_chunks - 1;
    unsigned* column_flags = flags + t.column * p.n_chunks;

    float A = 1.0f, X = 0.0f;
#pragma unroll 16
    for (int u = 0; u < kChunk; ++u) {
      const bool in = valid && u < t.steps;
      const float av = in ? to_f32(sa[u * kLanes]) : 1.0f;
      X = fmaf(av, X, in ? to_f32(sx[u * kLanes]) : 0.0f);
      A *= av;
    }

    float carry = 0.0f;
    if (t.chunk == 0) {
      if (valid) carry = h0[lane];
    } else {
      unsigned polls = 0;
      if (threadIdx.x < 32) {
        const int depth = look_back(column_flags, t.chunk, true, &polls);
        if (threadIdx.x == 0) s_depth = depth;
      }
      __syncthreads();
      const bool published = s_depth < 0;
      if (published) {
        // not settled at once: publish this chunk's aggregate, then wait
        if (!last && valid) agg[t.chunk * bd + lane] = make_float2(A, X);
        __syncthreads();
        if (threadIdx.x < 32) {
          if (!last && threadIdx.x == 0)
            st_release(&column_flags[t.chunk], kAggregate);
          const int depth = look_back(column_flags, t.chunk, false, &polls);
          if (threadIdx.x == 0) s_depth = depth;
        }
        __syncthreads();
      }
      const int depth = s_depth;
      if (counts != nullptr && threadIdx.x == 0) {
        atomicAdd(&counts[0], (unsigned long long)depth * t.lanes);
        atomicAdd(&counts[1], (unsigned long long)polls);
        if (published && !last)
          atomicAdd(&counts[2], (unsigned long long)t.lanes);
      }
      const int q0 = t.chunk - 1 - depth;  // the nearest inclusive chunk
      if (valid) {
        carry = __ldcg(&incl[q0 * bd + lane]);
#pragma unroll 4
        for (int q = q0 + 1; q < t.chunk; ++q) {
          const float2 ax = __ldcg(&agg[q * bd + lane]);
          carry = fmaf(ax.x, carry, ax.y);
        }
      }
    }
    if (!last) {
      if (valid) incl[t.chunk * bd + lane] = fmaf(A, carry, X);
      __syncthreads();
      if (threadIdx.x == 0) st_release(&column_flags[t.chunk], kInclusive);
    }

    float h = carry;
    float* hp = h_seq + ((size_t)t.bi * s + t.t0) * d + t.d0 + threadIdx.x;
#pragma unroll 16
    for (int u = 0; u < kChunk; ++u) {
      const bool in = valid && u < t.steps;
      h = fmaf(in ? to_f32(sa[u * kLanes]) : 1.0f, h,
               in ? to_f32(sx[u * kLanes]) : 0.0f);
      if (in) hp[(size_t)u * d] = h;
    }
    if (last && valid) h_last[lane] = h;

    __syncthreads();  // every thread is done with the tile in shared memory
    tk = following;
    if (tk < p.tiles)
      load_tile(tile_a, tile_x, a, x, tile_of(tk, p, b, s, d), s, d, vec);
  }
}

// Blocks that fit on the card at once, for each device; 0 if unknown.
template <typename T>
int resident_blocks(int device) {
  static int cache[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (cache[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(rglru_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tile_bytes<T>()) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, rglru_scan_kernel<T>, kLanes, tile_bytes<T>()) !=
            cudaSuccess)
      return 0;
    cache[device] = sms * per_sm;
  }
  return cache[device];
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const void* h0, void* h_seq,
                   void* h_last, void* scratch, unsigned long long* counts,
                   const Plan& p, int b, int s, int d, cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int resident = resident_blocks<T>(device);
  if (resident < 1) {
    err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
  }
  const bool vec = sizeof(T) == 4 ||
                   (d % 2 == 0 && (reinterpret_cast<size_t>(a) |
                                   reinterpret_cast<size_t>(x)) % 4 == 0);
  err = cudaMemsetAsync(scratch, 0, p.flag_bytes, stream);
  if (err != cudaSuccess) return err;
  const long long grid = p.tiles < resident ? p.tiles : resident;
  rglru_scan_kernel<T><<<(unsigned)grid, kLanes, tile_bytes<T>(), stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<const float*>(h0), static_cast<float*>(h_seq),
      static_cast<float*>(h_last), static_cast<unsigned char*>(scratch),
      counts, p, b, s, d, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of a and x: 0 = float32, 1 = bfloat16.  plan is rglru_plan(b, s, d)
// (see Plan) and scratch holds its scratch_bytes; the launch zeroes the
// first flag_bytes of them on the stream.  counts is null, or three u64
// that the kernel adds the lanes folded, flag reads and lanes published to.
// Returns a cudaError_t (0 = launched).
int rglru_scan(const void* a, const void* x, const void* h0, void* h_seq,
               void* h_last, void* scratch, void* counts, const void* plan,
               int dtype, int b, int s, int d, void* stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (b < 1 || s < 1 || d < 1 || p.chunk != kChunk || p.lanes != kLanes)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<unsigned long long*>(counts);
  if (dtype == 0)
    return launch<float>(a, x, h0, h_seq, h_last, scratch, c, p, b, s, d, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, x, h0, h_seq, h_last, scratch, c, p, b, s,
                                 d, st);
  return cudaErrorInvalidValue;
}

const char* rglru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
