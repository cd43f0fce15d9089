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
// path's block size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;  // f32 lanes one warp covers (32 x 4)

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ buf, int64_t rows, int pitch,
                   int stride, const int32_t* __restrict__ ids, int64_t n,
                   float* __restrict__ out) {
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
  float* dst = out + j * stride + col;
  const float* src = buf + (valid ? r : 0) * pitch + col;
  if (kVec) {  // stride % 4 == 0: the four lanes lie inside the row
    *reinterpret_cast<float4*>(dst) =
        valid ? __ldg(reinterpret_cast<const float4*>(src))
              : make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int m = min(4, stride - col);
  for (int e = 0; e < m; ++e) {
    dst[e] = valid ? __ldg(src + e) : 0.f;
  }
}

}  // namespace

// buf: [rows, pitch] f32, contiguous, 16-byte aligned, pitch % 128 == 0;
// ids: [n] int32, contiguous; out: [n, stride] f32, contiguous, 16-byte
// aligned, 0 < stride <= pitch. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int gather_rows_launch(const void* buf, int64_t rows, int pitch,
                                  int stride, const void* ids, int64_t n,
                                  void* out, void* stream) {
  if (rows < 0 || pitch <= 0 || pitch % kLanes != 0 || stride <= 0 ||
      stride > pitch || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int64_t warps = n * ((stride + kLanes - 1) / kLanes);
  const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* b = static_cast<const float*>(buf);
  const auto* i = static_cast<const int32_t*>(ids);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (stride % 4 == 0) {
    gather_rows_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        b, rows, pitch, stride, i, n, o);
  } else {
    gather_rows_kernel<false>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            b, rows, pitch, stride, i, n, o);
  }
  return static_cast<int>(cudaGetLastError());
}
