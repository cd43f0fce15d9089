// K7: the layout pin, a strided-to-contiguous copy, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel distributed_embeddings_tpu/ops/pallas_layout.py:
// row_major, an identity copy whose only effect on the TPU is to force its
// output into XLA's default row-major layout. The function is the identity;
// on this card the copy's output is a fresh contiguous (row-major) tensor:
//
//     out[i0, i1, i2, i3] = x[i0, i1, i2, i3]
//
// for any tensor of up to four dimensions given by its sizes and element
// strides (a transposed view, a slice, an expanded broadcast), of 4-byte or
// 2-byte elements (f32, bf16), moved as raw bits. Bit-exact by
// construction.
//
// The TPU kernel blocks over the second-minor axis to fit VMEM tiles; none
// of that is carried over. Here a grid-stride loop walks the output in
// order, one element per thread per iteration, so the stores are coalesced;
// each thread decomposes its linear index into coordinates and reads the
// source element at their strided offset (coalesced too when the source's
// innermost stride is 1).
//
// Bound on this card: it must read and write every element once, 2 * 4 B
// per f32 element: 0.025 ms for a 65,536 x 16 f32 cotangent against
// 3.35 TB/s, near a launch's own cost.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDims = 4;

struct Shape {
  int64_t size[kDims];
  int64_t stride[kDims];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_major_kernel(const T* __restrict__ x, Shape shape, int64_t n,
                 T* __restrict__ out) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    int64_t rest = i;
    int64_t off = 0;
#pragma unroll
    for (int d = kDims - 1; d >= 0; --d) {
      const int64_t c = rest % shape.size[d];
      rest /= shape.size[d];
      off += c * shape.stride[d];
    }
    out[i] = x[off];
  }
}

}  // namespace

// x: the source's first element; elem_bytes 4 or 2; sizes and strides (in
// elements) of 4 dimensions, leading ones padded with size 1; out: n
// contiguous elements. Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int row_major_launch(const void* x, int elem_bytes,
                                const int64_t* sizes, const int64_t* strides,
                                void* out, void* stream) {
  Shape shape;
  int64_t n = 1;
  for (int d = 0; d < kDims; ++d) {
    if (sizes[d] < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    shape.size[d] = sizes[d];
    shape.stride[d] = strides[d];
    n *= sizes[d];
  }
  if (elem_bytes != 4 && elem_bytes != 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) {
    return static_cast<int>(cudaSuccess);
  }
  // enough blocks to fill the card several times over; the loop covers the
  // rest
  const int64_t want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  const auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    row_major_kernel<uint32_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(x), shape, n, static_cast<uint32_t*>(out));
  } else {
    row_major_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(x), shape, n, static_cast<uint16_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
