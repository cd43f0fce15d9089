// K1: the sparse apply, buf[ids[i]] += scale * delta[i], written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel distributed_embeddings_tpu/ops/pallas_apply.py:
// apply_rows_cached. Over a [rows, width] f32 buffer (width a multiple of
// 128) and n occurrences:
//
//     for i in [0, n): if 0 <= ids[i] < rows:
//         buf[ids[i], :] += fl(scale * delta[i, :])
//
// in place. Ids outside [0, rows) are dropped. Duplicate ids accumulate
// with per-occurrence semantics; the sum is exact up to the f32 summation
// order, which is the TPU kernel's own contract. The scale is rounded into
// each delta value before any add (the plain version's `delta * scale`
// followed by index_add_), so a stream of unique ids gives the plain
// version's bits.
//
// The TPU kernel's write-back row cache exists because the TPU's scalar
// core starts one row DMA at a time; it is not carried over. What bounds
// this card is different: duplicates. Power-law streams put up to ~200,000
// occurrences on one row, and atomics to one address serialize in the L2
// (about 8.6 ns each), so one float4 atomic per occurrence makes the
// kernel's time the chain of its hottest row, not its bytes.
//
// So each block pre-reduces a tile of T consecutive occurrences on chip
// before any global atomic (T, the hash's slot count and the dynamic shared
// memory: plan_of below, which ops/cuda_apply.py: plan_apply repeats in
// Python for the tests):
//
//   1. its threads load the tile's ids and insert the valid ones into an
//      open-addressing hash in shared memory (atomicCAS on the key), each
//      occurrence taking a rank in its id's slot (atomicAdd on the count);
//   2. an exclusive scan of the counts and a scatter sort the tile's
//      occurrences by slot (a counting sort): equal ids become runs;
//   3. the sorted list is cut into one range per warp; a warp walks its
//      range with each lane owning one float4 of a 128-lane chunk, loads
//      kUnroll delta rows ahead, sums each run of one id in registers from
//      the run's first rounded product on (__fmul_rn, __fadd_rn: nothing
//      fuses into an FMA, and no +0.0 start alters a -0.0), and adds the
//      run's sum into the row with one float4 atomicAdd per lane.
//
// An id seen once in its warp's range takes exactly the old path, one
// atomic of fl(scale * d); the hottest row gets at most a few atomics per
// tile instead of one per occurrence. No accumulator lives in shared
// memory, so nothing overflows.
//
// Bound on this card: per occurrence it must read the id (8 B) and the
// delta row (4 * width B), and per distinct row read and write the row
// once: 1,544 B per occurrence at width 128 for unique ids (60 us for
// 131,072 against 3.35 TB/s), much less for a duplicate-heavy stream. One
// multiply and one add per element are far below any compute rate, so the
// kernel is memory-bound; the design reads each delta byte once, with
// kUnroll 512-byte rows in flight per warp.
//
// The bf16 form (apply_rows_bf16_launch; narrow storage) takes a bf16
// buffer and bf16 deltas and keeps the tile sort. The JAX package applies
// bf16 buffers with XLA's scatter (ops/packed_table.py: scatter_add_fused):
// the delta cast to bf16, the scale cast to bf16 and multiplied in bf16,
// then each occurrence added in bf16. So here the scale is rounded to bf16,
// each product (exact in f32: two 8-bit significands) is rounded to bf16
// once, a run of one id sums those in f32 in registers, and the run's sum,
// rounded to bf16, goes into the row with two bf16x2 atomics per lane
// (Hopper's native atom.add.noftz.bf16x2, round to nearest even). An id
// seen once in its warp's range therefore gives
// bf16(buf + bf16(bf16(scale) * d)), the plain version's and XLA's bits; a
// run of duplicates rounds once where XLA rounds once per occurrence. Each
// lane owns 4 bf16 values (8 bytes) of a 128-lane chunk, so a warp still
// covers 128 lanes and the plan is the f32 form's: per occurrence the
// bound reads 8 B of id and 2 * width B of delta, per distinct row 4 *
// width B (the row read and written).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;  // f32 lanes one warp covers (32 x float4)
constexpr int kUnroll = 16;  // delta rows a warp loads ahead
// the tile: a power of two in [kTileMin, kTileMax] (ops/cuda_apply.py)
constexpr int kTileMinLog2 = 8;
constexpr int kTileMaxLog2 = 11;
constexpr int kTilesPerSm = 4;
constexpr int kPerThread = (1 << kTileMaxLog2) / kThreads;
constexpr unsigned kFull = 0xffffffffu;

struct Plan {
  int tile_log2;
  int slots;
  int smem;
};

// ops/cuda_apply.py: plan_apply. The largest tile (at most 2,048
// occurrences) that still gives every SM kTilesPerSm tiles, at least 256;
// a hash of twice the tile's slots; shared memory for the sorted keys and
// occurrences (T each), the hash's keys and counts (2T each) and the
// warps' scan totals.
Plan plan_of(int64_t n, int sms) {
  int lg = kTileMaxLog2;
  while (lg > kTileMinLog2 &&
         (n + (int64_t{1} << lg) - 1) >> lg <
             static_cast<int64_t>(kTilesPerSm) * sms) {
    --lg;
  }
  const int tile = 1 << lg;
  const int slots = 2 * tile;
  const int smem = static_cast<int>(sizeof(int)) *
                   (2 * tile + 2 * slots + kWarps + 1);
  return {lg, slots, smem};
}

// Fibonacci hashing: the top slots_log2 bits of key * 2^32 / phi
__device__ __forceinline__ unsigned slot_hash(int key, int slots_log2) {
  return (static_cast<unsigned>(key) * 0x9E3779B1u) >> (32 - slots_log2);
}

// Element access of the two forms: 4 consecutive values of a row as a
// float4 (f32: one 16-byte load; bf16: one 8-byte load, widened exactly),
// the rounded product of one occurrence, and the run's atomic add.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static float scale_of(float s) { return s; }
  __device__ static float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static float4 scaled(float s, float4 d) {
    return make_float4(__fmul_rn(s, d.x), __fmul_rn(s, d.y),
                       __fmul_rn(s, d.z), __fmul_rn(s, d.w));
  }
  __device__ static void add_row4(float* p, float4 v) {
    atomicAdd(reinterpret_cast<float4*>(p), v);
  }
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <>
struct Elem<__nv_bfloat16> {
  __device__ static float scale_of(float s) { return bf16_round(s); }
  __device__ static float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  __device__ static float4 scaled(float s, float4 d) {
    return make_float4(bf16_round(__fmul_rn(s, d.x)),
                       bf16_round(__fmul_rn(s, d.y)),
                       bf16_round(__fmul_rn(s, d.z)),
                       bf16_round(__fmul_rn(s, d.w)));
  }
  __device__ static void add_row4(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
    atomicAdd(q, __floats2bfloat162_rn(v.x, v.y));
    atomicAdd(q + 1, __floats2bfloat162_rn(v.z, v.w));
  }
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_tiles_kernel(T* __restrict__ buf, int rows, int width,
                   const int64_t* __restrict__ ids,
                   const T* __restrict__ delta, int64_t n,
                   const float* __restrict__ scale_ptr, float scale_val,
                   int tile_log2) {
  extern __shared__ int smem[];
  const int tile = 1 << tile_log2;
  const int slots = 2 * tile;
  int* skey = smem;              // [tile] sorted keys
  int* socc = skey + tile;       // [tile] sorted occurrences (in the tile)
  int* hkey = socc + tile;       // [slots] hash keys, -1 empty
  int* hcnt = hkey + slots;      // [slots] counts, then run starts
  int* wsum = hcnt + slots;      // [kWarps + 1] scan totals
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) << tile_log2;
  const int tn = static_cast<int>(n - t0 < tile ? n - t0 : tile);
  const int per = tile / kThreads;

  // 1. the tile's ids (thread tid holds occurrences tid + e * kThreads),
  //    then the hash
  int key[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    key[e] = -1;
    const int j = tid + e * kThreads;
    if (e < per && j < tn) {
      const int64_t r = ids[t0 + j];
      if (r >= 0 && r < rows) {
        key[e] = static_cast<int>(r);
      }
    }
  }
  for (int s = tid; s < slots; s += kThreads) {
    hkey[s] = -1;
    hcnt[s] = 0;
  }
  __syncthreads();
  int slot[kPerThread], rank[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    slot[e] = 0;
    rank[e] = 0;
    if (key[e] >= 0) {
      unsigned h = slot_hash(key[e], tile_log2 + 1);
      for (;;) {
        const int prev = atomicCAS(hkey + h, -1, key[e]);
        if (prev == -1 || prev == key[e]) {
          break;
        }
        h = (h + 1) & (slots - 1);
      }
      slot[e] = static_cast<int>(h);
      rank[e] = atomicAdd(hcnt + h, 1);
    }
  }
  __syncthreads();

  // 2. exclusive scan of the counts (thread tid owns slots_per_thread
  //    consecutive slots), then the scatter into slot order
  const int sp = slots / kThreads;
  const int s0 = tid * sp;
  int local = 0;
  for (int k = 0; k < sp; ++k) {
    local += hcnt[s0 + k];
  }
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) {
      incl += y;
    }
  }
  if (lane == 31) {
    wsum[warp] = incl;
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int k = 0; k < kWarps; ++k) {
      const int v = wsum[k];
      wsum[k] = acc;
      acc += v;
    }
    wsum[kWarps] = acc;
  }
  __syncthreads();
  int run = wsum[warp] + incl - local;
  for (int k = 0; k < sp; ++k) {
    const int c = hcnt[s0 + k];
    hcnt[s0 + k] = run;
    run += c;
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    if (key[e] >= 0) {
      const int pos = hcnt[slot[e]] + rank[e];
      skey[pos] = key[e];
      socc[pos] = tid + e * kThreads;
    }
  }
  __syncthreads();

  // 3. each warp walks its range of the sorted list, chunk by chunk
  const int nv = wsum[kWarps];
  const int lo = nv * warp / kWarps;
  const int hi = nv * (warp + 1) / kWarps;
  if (lo >= hi) {
    return;
  }
  const float s =
      Elem<T>::scale_of((scale_ptr != nullptr) ? *scale_ptr : scale_val);
  const T* dbase = delta + t0 * width + 4 * lane;
  T* bbase = buf + 4 * lane;
  for (int c = 0; c < width; c += kLanes) {
    int cur = -1;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = lo; b < hi; b += kUnroll) {
      int k[kUnroll];
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        k[u] = -1;
        if (b + u < hi) {
          k[u] = skey[b + u];
          v[u] = Elem<T>::load4(dbase +
                                static_cast<int64_t>(socc[b + u]) * width + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k[u] < 0) {
          break;
        }
        const float4 p = Elem<T>::scaled(s, v[u]);
        if (k[u] == cur) {
          acc = add4(acc, p);
        } else {
          if (cur >= 0) {
            Elem<T>::add_row4(bbase + static_cast<int64_t>(cur) * width + c,
                              acc);
          }
          cur = k[u];
          acc = p;
        }
      }
    }
    Elem<T>::add_row4(bbase + static_cast<int64_t>(cur) * width + c, acc);
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return static_cast<int>(e);
}

}  // namespace

// The tile plan the launcher uses for n occurrences on the current device:
// out[0] = tile, out[1] = hash slots, out[2] = dynamic shared memory bytes
// (ops/cuda_apply.py: plan_apply computes the same from the SM count).
extern "C" int apply_rows_plan(int64_t n, int* out) {
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) {
    return e;
  }
  const Plan p = plan_of(n, sms);
  out[0] = 1 << p.tile_log2;
  out[1] = p.slots;
  out[2] = p.smem;
  return 0;
}

namespace {

template <typename T>
int launch(void* buf, int64_t rows, int width, const void* ids,
           const void* delta, int64_t n, const void* scale_ptr,
           float scale_val, void* stream) {
  if (rows < 0 || rows > 0x7fffffffLL || width <= 0 || width % kLanes != 0 ||
      n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || rows == 0) {
    return static_cast<int>(cudaSuccess);
  }
  int sms = 0;
  int e = sm_count(&sms);
  if (e != 0) {
    return e;
  }
  const Plan p = plan_of(n, sms);
  const int64_t blocks = (n + (int64_t{1} << p.tile_log2) - 1) >> p.tile_log2;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.smem > 48 * 1024) {
    e = static_cast<int>(cudaFuncSetAttribute(
        apply_tiles_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.smem));
    if (e != 0) {
      return e;
    }
  }
  apply_tiles_kernel<T><<<static_cast<unsigned>(blocks), kThreads, p.smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(buf), static_cast<int>(rows), width,
      static_cast<const int64_t*>(ids), static_cast<const T*>(delta), n,
      static_cast<const float*>(scale_ptr), scale_val, p.tile_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// buf: [rows, width] f32, contiguous, 16-byte aligned, width % 128 == 0,
// rows < 2^31; ids: [n] int64; delta: [n, width] f32, contiguous, 16-byte
// aligned. scale_ptr: a device pointer to one f32 multiplier, or null to
// use scale_val. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int apply_rows_launch(void* buf, int64_t rows, int width,
                                 const void* ids, const void* delta, int64_t n,
                                 const void* scale_ptr, float scale_val,
                                 void* stream) {
  return launch<float>(buf, rows, width, ids, delta, n, scale_ptr, scale_val,
                       stream);
}

// The bf16 form: buf [rows, width] and delta [n, width] bf16, contiguous,
// 8-byte aligned; the rest as apply_rows_launch (the f32 scale is rounded
// to bf16 in the kernel).
extern "C" int apply_rows_bf16_launch(void* buf, int64_t rows, int width,
                                      const void* ids, const void* delta,
                                      int64_t n, const void* scale_ptr,
                                      float scale_val, void* stream) {
  return launch<__nv_bfloat16>(buf, rows, width, ids, delta, n, scale_ptr,
                               scale_val, stream);
}
