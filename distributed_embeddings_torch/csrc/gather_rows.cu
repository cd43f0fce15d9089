// K4: the fused exchange's per-round row gather, out[j] = buf[ids[j], :stride],
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_embeddings_tpu/ops/pallas_exchange.py:
// gather_rows (its local-transport form). Over a [rows, pitch] f32 buffer
// (pitch a multiple of 128: a packed table's physical rows) and n int32
// ids:
//
//     for j in [0, n): out[j, :] = buf[ids[j], :stride]  if 0 <= ids[j] < rows
//                      out[j, :] = 0                      otherwise
//
// with stride <= pitch the fused row's lanes (table row and optimizer
// state); the lanes of the physical row past the stride are padding and
// are not read. Ids outside [0, rows) are the routing's sentinels (padding,
// and ids of other row slices) and give all-zero rows. Pure data movement,
// so the result is bit-exact against the plain version. `out` is one
// (round, chunk) send block of the fused exchange, contiguous, so the wire
// reads it as it is.
//
// The TPU kernel double-buffers the rows through VMEM with one DMA
// semaphore per row because the TPU's scalar core issues one row DMA at a
// time; nothing of that is carried over. Here one warp takes one
// (id, 128-lane chunk): each lane moves 16 bytes of the row (one float4,
// coalesced across the warp) when the stride is a multiple of 4 lanes, so
// that every output row is 16-byte aligned, and four single floats
// otherwise. The id is read once per warp and broadcast.
//
// Bound on this card: per id it must read the id (4 B) and the row
// (4 * stride B) and write the row (4 * stride B): 1,028 B at stride 128,
// so 2.5 us for one 8,192-row block against 3.35 TB/s -- below a launch's
// own latency, which is what this kernel's time sits near at the main
// path's block size. There the time is the dispatch of the grid and one
// dependent round trip (the id, then its row), not the bytes: a warp a
// row at full occupancy puts every row of the block in flight at once
// with the fewest instructions between the id and the row. On the card,
// warps that each hold several rows (one coalesced id load shared by
// shuffles), grids of one wave, cache hints on the loads and stores, and
// blocks of 128 or 512 threads took as long or longer; rows within the
// TLB's reach or in sorted order change nothing, and a contiguous copy of
// the same bytes takes nearly as long (chip_smoke.py's K4 yardsticks).

// The bf16 form (gather_rows_bf16_launch; narrow storage) moves 2-byte
// lanes with the same geometry: a warp still covers 128 lanes, each lane 4
// of them (8 bytes, one uint2) when the stride is a multiple of 4, so its
// bound is half the f32 form's bytes a row plus the id. The JAX package
// gathers non-f32 buffers with XLA (its Pallas gather takes f32); a gather
// is the same bits whichever route it takes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;  // lanes one warp covers (32 x 4)

// four consecutive lanes of a row as one load: 16 bytes of f32, 8 of bf16
// (moved as raw 16-bit words)
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<uint16_t> {
  using type = uint2;
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ buf, int64_t rows, int pitch,
                   int stride, const int32_t* __restrict__ ids, int64_t n,
                   T* __restrict__ out) {
  const int chunks = (stride + kLanes - 1) / kLanes;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= n * chunks) {
    return;
  }
  const int64_t j = warp / chunks;
  const int c = static_cast<int>(warp - j * chunks);
  const int col = c * kLanes + 4 * lane;  // this lane's first column
  if (col >= stride) {
    return;
  }
  const int64_t r = __ldg(ids + j);
  const bool valid = r >= 0 && r < rows;
  T* dst = out + j * stride + col;
  const T* src = buf + (valid ? r : 0) * pitch + col;
  if (kVec) {  // stride % 4 == 0: the four lanes lie inside the row
    using V = typename Vec4<T>::type;
    *reinterpret_cast<V*>(dst) =
        valid ? __ldg(reinterpret_cast<const V*>(src)) : V{};
    return;
  }
  const int m = min(4, stride - col);
  for (int e = 0; e < m; ++e) {
    dst[e] = valid ? __ldg(src + e) : T(0);
  }
}

__global__ void empty_kernel() {}

// the grid: one warp per (id, 128-lane chunk)
int64_t blocks_of(int64_t n, int stride) {
  const int64_t warps = n * ((stride + kLanes - 1) / kLanes);
  return (warps * 32 + kThreads - 1) / kThreads;
}

template <typename T>
int launch(const void* buf, int64_t rows, int pitch, int stride,
           const void* ids, int64_t n, void* out, void* stream) {
  if (rows < 0 || pitch <= 0 || pitch % kLanes != 0 || stride <= 0 ||
      stride > pitch || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int64_t blocks = blocks_of(n, stride);
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* b = static_cast<const T*>(buf);
  const auto* i = static_cast<const int32_t*>(ids);
  auto* o = static_cast<T*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (stride % 4 == 0) {
    gather_rows_kernel<T, true>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(b, rows, pitch,
                                                           stride, i, n, o);
  } else {
    gather_rows_kernel<T, false>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(b, rows, pitch,
                                                           stride, i, n, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// buf: [rows, pitch] f32, contiguous, 16-byte aligned, pitch % 128 == 0;
// ids: [n] int32, contiguous; out: [n, stride] f32, contiguous, 16-byte
// aligned, 0 < stride <= pitch. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int gather_rows_launch(const void* buf, int64_t rows, int pitch,
                                  int stride, const void* ids, int64_t n,
                                  void* out, void* stream) {
  return launch<float>(buf, rows, pitch, stride, ids, n, out, stream);
}

// The bf16 form: buf and out bf16 (2-byte lanes), 8-byte aligned; the rest
// as gather_rows_launch.
extern "C" int gather_rows_bf16_launch(const void* buf, int64_t rows,
                                       int pitch, int stride, const void* ids,
                                       int64_t n, void* out, void* stream) {
  return launch<uint16_t>(buf, rows, pitch, stride, ids, n, out, stream);
}

// A yardstick, not part of the gather: an empty kernel on `stream` with the
// grid the gather of n ids of `stride` lanes takes -- the card's floor for
// dispatching it. Returns cudaGetLastError() (0 on success).
extern "C" int gather_rows_empty_launch(int64_t n, int stride, void* stream) {
  if (n <= 0 || stride <= 0 || blocks_of(n, stride) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  empty_kernel<<<static_cast<unsigned>(blocks_of(n, stride)), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
