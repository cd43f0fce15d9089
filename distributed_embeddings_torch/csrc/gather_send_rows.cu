// K5: one round of the fused exchange's gather-and-push, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel distributed_embeddings_tpu/ops/pallas_exchange.py:
// gather_send_rows (_exchange_kernel with remote=True). Over a [rows, 128]
// f32 buffer on this card and n int32 ids:
//
//     for j in [0, n): dst[j, :] = buf[ids[j], :]  if 0 <= ids[j] < rows
//                      dst[j, :] = 0               otherwise
//
// where `dst` is the [n, 128] receive buffer of the round's destination
// rank: this card's own memory on a loopback round, another card's memory
// (a peer pointer, with peer access enabled) on a rotate-by-k round. It is
// K4's gather (gather_rows.cu) with the payload pushed over NVLink instead
// of written locally. Ids outside [0, rows) are the routing's sentinels and
// give all-zero rows; pure data movement, so the result is bit-exact
// against the plain version.
//
// The TPU kernel stages each chunk of rows through double-buffered VMEM and
// ships it with a remote DMA, after a "ready to receive" barrier with its
// neighbours; its receive semaphores tell the destination when the payload
// has landed. None of that is carried over: one warp takes one id, each
// lane loads 16 bytes of the row and stores them straight into the
// destination (coalesced 512-byte rows, over NVLink when it is remote). The
// ordering the TPU kernel gets from its barrier and semaphores comes from
// two CUDA events in the wrapper: the sender's stream waits for the
// receiver's stream before the push, and the receiver's stream waits for
// the push before it reads.
//
// Bound on this card: per id it must read the id (4 B) and the row (512 B)
// and write the row (512 B): 8,192 ids move 8.4 MB, 2.5 us against
// 3.35 TB/s on a loopback round; on a remote round the 4.2 MB of rows cross
// one peer link, whose rate bounds it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;  // f32 lanes of a row: 32 lanes x 4

__global__ void __launch_bounds__(kThreads)
gather_send_kernel(const float* __restrict__ buf, int64_t rows,
                   const int32_t* __restrict__ ids, int64_t n,
                   float* __restrict__ dst) {
  const int64_t j =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (j >= n) {
    return;
  }
  const int64_t r = __ldg(ids + j);
  const bool valid = r >= 0 && r < rows;
  const float4 v =
      valid ? __ldg(reinterpret_cast<const float4*>(buf + r * kLanes) + lane)
            : make_float4(0.f, 0.f, 0.f, 0.f);
  reinterpret_cast<float4*>(dst + j * kLanes)[lane] = v;
}

}  // namespace

// Lets `device` write into `peer`'s memory (cudaDeviceEnablePeerAccess from
// `device`); access that is already enabled counts as success. The calling
// thread's current device is the same on return as on entry. Returns 0 on
// success, -1 when the hardware offers no peer access between the two, or
// the CUDA error.
extern "C" int gather_send_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  if (!can) {
    return -1;
  }
  int previous = 0;
  e = cudaGetDevice(&previous);
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  e = cudaSetDevice(device);
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the sticky report of the repeat
    e = cudaSuccess;
  }
  const cudaError_t restored = cudaSetDevice(previous);
  return static_cast<int>(e != cudaSuccess ? e : restored);
}

// buf: [rows, 128] f32 on `device`, contiguous, 16-byte aligned; ids: [n]
// int32 on `device`, contiguous; dst: [n, 128] f32, contiguous, 16-byte
// aligned, on `device` or on a peer that `device` may write. Launches on
// `stream` (a stream of `device`) and returns cudaGetLastError() (0 on
// success).
extern "C" int gather_send_rows_launch(int device, const void* buf,
                                       int64_t rows, const void* ids,
                                       int64_t n, void* dst, void* stream) {
  if (rows < 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int64_t blocks = (n * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  gather_send_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(buf), rows, static_cast<const int32_t*>(ids),
      n, static_cast<float*>(dst));
  return static_cast<int>(cudaGetLastError());
}
