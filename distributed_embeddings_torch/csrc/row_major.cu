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
// Bound on this card: it must read and write every element once, 2 * 4 B
// per f32 element: 0.030 ms for the [12, 65536, 16] f32 cotangent of the
// synthetic zoo's Tiny step against 3.35 TB/s. A copy does no arithmetic,
// so what costs is the instructions per byte moved and whole sectors on
// both sides. The host (ops/cuda_layout.py: plan_copy) first drops size-1
// dimensions and merges dimensions that are contiguous with each other,
// then picks one of three paths:
//
//   0 vector rows: the innermost stride is 1 and runs, base and outer
//     strides are 16-byte aligned. One thread moves one 16-byte vector
//     (four per thread, loads issued before stores). The threads walk the
//     outer dimensions in the source's memory order (largest stride
//     outermost), so a warp's loads are contiguous, and each vector's
//     run index is split into coordinates once, with 32-bit
//     multiply-shift division (divisors prepared on the host), giving
//     both its source and its output offset. The Tiny cotangent,
//     [65536, 12, 16].transpose(0, 1), is this path: the source is read
//     straight through, and the stores are 64-byte runs, four threads
//     each, whole sectors.
//   1 tile transpose: the innermost stride is not 1 but another
//     dimension's is. A tile of 1,024 elements goes through shared
//     memory (32-bit cells, padded against bank conflicts): reads run
//     along the source's unit-stride dimension, writes along the
//     output's last. The tile is 32 wide along the last dimension, or 16
//     or 8 where that dimension is that short (so no lane idles on a
//     [.., 16] output), and 1,024 / width along the other.
//   2 general: one element per thread per step, its coordinates taken
//     with the same multiply-shift division.
//
// Index arithmetic is 32-bit unless the element count or an offset
// reaches 2^31; then every path runs on 64-bit indices and plain
// division.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDims = 4;
constexpr int kVecPerThread = 4;

// n / d for 0 <= n < 2^31 by a multiply and a shift (the divisor's magic
// number prepared on the host); Idx = int64_t divides plainly
struct FastDiv {
  uint32_t d, m, s;
};

FastDiv make_div(uint32_t d) {
  uint32_t s = 0;
  while ((uint64_t{1} << s) < d) {
    ++s;
  }
  const uint64_t m = ((uint64_t{1} << 32) * ((uint64_t{1} << s) - d)) / d + 1;
  return {d, static_cast<uint32_t>(m), s};
}

template <typename Idx>
__device__ __forceinline__ Idx div_of(Idx n, const FastDiv& f);

template <>
__device__ __forceinline__ int32_t div_of<int32_t>(int32_t n,
                                                    const FastDiv& f) {
  const uint32_t u = static_cast<uint32_t>(n);
  return static_cast<int32_t>((__umulhi(u, f.m) + u) >> f.s);
}

template <>
__device__ __forceinline__ int64_t div_of<int64_t>(int64_t n,
                                                    const FastDiv& f) {
  return n / static_cast<int64_t>(f.d);
}

struct Shape {
  int nd;
  FastDiv size[kDims];
  int64_t stride[kDims];  // source strides, in elements
};

// the source offset of row-major position `pos` over dims [0, nd)
template <typename Idx>
__device__ __forceinline__ Idx offset_of(Idx pos, const Shape& sh, int nd) {
  Idx off = 0;
#pragma unroll
  for (int d = kDims - 1; d >= 1; --d) {
    if (d < nd) {
      const Idx q = div_of<Idx>(pos, sh.size[d]);
      off += (pos - q * static_cast<Idx>(sh.size[d].d)) *
             static_cast<Idx>(sh.stride[d]);
      pos = q;
    }
  }
  return off + pos * static_cast<Idx>(sh.stride[0]);
}

// path 0's outer dimensions (all but the innermost), in the order the
// threads walk them, with source and output strides in 16-byte vectors
struct Walk {
  int nd;
  FastDiv size[kDims];
  int64_t src[kDims];
  int64_t dst[kDims];
};

// path 0: `run` divides a vector index into (run index, vector within the
// run); the run index is split over `walk`'s dimensions
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
vector_kernel(const uint4* __restrict__ x, Walk walk, FastDiv run, Idx nvec,
              uint4* __restrict__ out) {
  const Idx base = static_cast<Idx>(blockIdx.x) * (kThreads * kVecPerThread) +
                   threadIdx.x;
  uint4 v[kVecPerThread];
  Idx to[kVecPerThread];
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const Idx pos = base + i * kThreads;
    if (pos < nvec) {
      Idx r = div_of<Idx>(pos, run);
      const Idx j = pos - r * static_cast<Idx>(run.d);
      Idx from = j;
      to[i] = j;
#pragma unroll
      for (int d = kDims - 1; d >= 0; --d) {
        if (d < walk.nd) {
          const Idx q = d ? div_of<Idx>(r, walk.size[d]) : Idx{0};
          const Idx c = r - q * static_cast<Idx>(walk.size[d].d);
          from += c * static_cast<Idx>(walk.src[d]);
          to[i] += c * static_cast<Idx>(walk.dst[d]);
          r = q;
        }
      }
      v[i] = __ldg(x + from);
    }
  }
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    if (base + i * kThreads < nvec) {
      out[to[i]] = v[i];
    }
  }
}

// path 1: dims u (source stride 1) and last (size `sh.size[nd-1]`); the
// other dims are the batch (`batch`, with source and output strides)
struct Transpose {
  Shape batch;               // the other dims' sizes and source strides
  int64_t out_stride[kDims]; // ... and their output strides
  int64_t n_u, n_last, src_last, out_u;
  FastDiv tiles_u, tiles_last;
  int64_t n_tiles;
};

// a transpose tile holds kTileCells elements: kTj along the output's last
// dimension (32, or 16 or 8 when that dimension is that short) by
// kTileCells / kTj along the source's unit-stride one; a row of kTj + pad
// 32-bit cells keeps both phases free of bank conflicts
constexpr int kTileCells = 1024;

template <typename T, typename Idx, int kTj>
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const T* __restrict__ x, Transpose tp, T* __restrict__ out) {
  constexpr int kTu = kTileCells / kTj;
  __shared__ uint32_t tile[kTj][kTu + 32 / kTj];
  // loads: lanes along u; stores: lanes along the last dimension
  const int lu = threadIdx.x % kTu;
  const int lj = threadIdx.x / kTu;
  const int sj = threadIdx.x % kTj;
  const int si = threadIdx.x / kTj;
  for (Idx t = blockIdx.x; t < static_cast<Idx>(tp.n_tiles); t += gridDim.x) {
    const Idx tq = div_of<Idx>(t, tp.tiles_last);
    const Idx j0 = (t - tq * static_cast<Idx>(tp.tiles_last.d)) * kTj;
    const Idx b = div_of<Idx>(tq, tp.tiles_u);
    const Idx i0 = (tq - b * static_cast<Idx>(tp.tiles_u.d)) * kTu;
    // the batch coordinates' source and output offsets
    Idx src = 0, dst = 0, rest = b;
#pragma unroll
    for (int d = kDims - 1; d >= 0; --d) {
      if (d < tp.batch.nd) {
        const Idx q = d ? div_of<Idx>(rest, tp.batch.size[d]) : Idx{0};
        const Idx c = rest - q * static_cast<Idx>(tp.batch.size[d].d);
        src += c * static_cast<Idx>(tp.batch.stride[d]);
        dst += c * static_cast<Idx>(tp.out_stride[d]);
        rest = q;
      }
    }
    const Idx i = i0 + lu;
#pragma unroll
    for (int k = 0; k < kTj; k += kThreads / kTu) {
      const Idx j = j0 + lj + k;
      if (i < static_cast<Idx>(tp.n_u) && j < static_cast<Idx>(tp.n_last)) {
        tile[lj + k][lu] = static_cast<uint32_t>(
            __ldg(x + src + i + j * static_cast<Idx>(tp.src_last)));
      }
    }
    __syncthreads();
    const Idx j = j0 + sj;
#pragma unroll
    for (int k = 0; k < kTu; k += kThreads / kTj) {
      const Idx ii = i0 + si + k;
      if (ii < static_cast<Idx>(tp.n_u) && j < static_cast<Idx>(tp.n_last)) {
        out[dst + ii * static_cast<Idx>(tp.out_u) + j] =
            static_cast<T>(tile[sj][si + k]);
      }
    }
    __syncthreads();
  }
}

// path 2: one element per thread per step
template <typename T, typename Idx>
__global__ void __launch_bounds__(kThreads)
general_kernel(const T* __restrict__ x, Shape sh, Idx n, T* __restrict__ out) {
  const Idx step = static_cast<Idx>(gridDim.x) * blockDim.x;
  for (Idx i = static_cast<Idx>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    out[i] = x[offset_of<Idx>(i, sh, sh.nd)];
  }
}

unsigned blocks_for(int64_t work, int64_t per_block, int64_t cap) {
  const int64_t want = (work + per_block - 1) / per_block;
  return static_cast<unsigned>(want < cap ? want : cap);
}

template <typename T, typename Idx>
int launch_path(const void* x, int path, int nd, const int64_t* sizes,
                const int64_t* strides, int unit_dim, int64_t n, void* out,
                cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  int64_t out_stride[kDims];
  int64_t acc = 1;
  for (int d = nd - 1; d >= 0; --d) {
    out_stride[d] = acc;
    acc *= sizes[d];
  }
  if (path == 0) {
    // walk the outer dimensions in the source's memory order (largest
    // stride outermost): a warp's loads are then contiguous runs
    int order[kDims];
    const int nw = nd - 1;
    for (int d = 0; d < nw; ++d) {
      int at = d;
      while (at > 0 && strides[order[at - 1]] < strides[d]) {
        order[at] = order[at - 1];
        --at;
      }
      order[at] = d;
    }
    Walk walk = {};
    walk.nd = nw > 0 ? nw : 1;
    walk.size[0] = make_div(1);
    for (int i = 0; i < nw; ++i) {
      walk.size[i] = make_div(static_cast<uint32_t>(sizes[order[i]]));
      walk.src[i] = strides[order[i]] / kVec;
      walk.dst[i] = out_stride[order[i]] / kVec;
    }
    const int64_t nvec = n / kVec;
    const FastDiv run = make_div(static_cast<uint32_t>(sizes[nd - 1] / kVec));
    const int64_t per_block = int64_t{kThreads} * kVecPerThread;
    vector_kernel<Idx><<<blocks_for(nvec, per_block, INT32_MAX), kThreads, 0,
                         s>>>(static_cast<const uint4*>(x), walk, run,
                              static_cast<Idx>(nvec),
                              static_cast<uint4*>(out));
  } else if (path == 1) {
    Transpose tp = {};
    int nb = 0;
    int64_t batches = 1;
    for (int d = 0; d + 1 < nd; ++d) {
      if (d == unit_dim) {
        continue;
      }
      tp.batch.size[nb] = make_div(static_cast<uint32_t>(sizes[d]));
      tp.batch.stride[nb] = strides[d];
      tp.out_stride[nb] = out_stride[d];
      batches *= sizes[d];
      ++nb;
    }
    if (nb == 0) {
      tp.batch.size[0] = make_div(1);
      nb = 1;
    }
    tp.batch.nd = nb;
    tp.n_u = sizes[unit_dim];
    tp.n_last = sizes[nd - 1];
    tp.src_last = strides[nd - 1];
    tp.out_u = out_stride[unit_dim];
    const int tj = tp.n_last > 16 ? 32 : tp.n_last > 8 ? 16 : 8;
    const int64_t tu = (tp.n_u + kTileCells / tj - 1) / (kTileCells / tj);
    const int64_t tl = (tp.n_last + tj - 1) / tj;
    tp.tiles_u = make_div(static_cast<uint32_t>(tu));
    tp.tiles_last = make_div(static_cast<uint32_t>(tl));
    tp.n_tiles = batches * tu * tl;
    const unsigned grid = blocks_for(tp.n_tiles, 1, 132 * 16);
    const auto* xt = static_cast<const T*>(x);
    auto* ot = static_cast<T*>(out);
    if (tj == 32) {
      transpose_kernel<T, Idx, 32><<<grid, kThreads, 0, s>>>(xt, tp, ot);
    } else if (tj == 16) {
      transpose_kernel<T, Idx, 16><<<grid, kThreads, 0, s>>>(xt, tp, ot);
    } else {
      transpose_kernel<T, Idx, 8><<<grid, kThreads, 0, s>>>(xt, tp, ot);
    }
  } else {
    Shape sh = {};
    sh.nd = nd;
    for (int d = 0; d < nd; ++d) {
      sh.size[d] = make_div(static_cast<uint32_t>(sizes[d]));
      sh.stride[d] = strides[d];
    }
    general_kernel<T, Idx><<<blocks_for(n, kThreads, 132 * 32), kThreads, 0,
                             s>>>(static_cast<const T*>(x), sh,
                                  static_cast<Idx>(n), static_cast<T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: the source's first element; elem_bytes 4 or 2; path 0 (vector rows),
// 1 (tile transpose) or 2 (general), as ops/cuda_layout.py: plan_copy
// chose it; nd (1-4) coalesced sizes and element strides, outermost first;
// unit_dim: path 1's dimension of stride 1; out: the contiguous output.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a plan whose path does not fit the view.
extern "C" int row_major_launch(const void* x, int elem_bytes, int path,
                                int nd, const int64_t* sizes,
                                const int64_t* strides, int unit_dim,
                                void* out, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if ((elem_bytes != 4 && elem_bytes != 2) || nd < 1 || nd > kDims ||
      path < 0 || path > 2) {
    return bad;
  }
  int64_t n = 1;
  int64_t reach = 0;  // the largest source offset, in elements
  for (int d = 0; d < nd; ++d) {
    if (sizes[d] < 1 || strides[d] < 0 || sizes[d] > UINT32_MAX) {
      return bad;
    }
    n *= sizes[d];
    reach += (sizes[d] - 1) * strides[d];
  }
  const int vec = 16 / elem_bytes;
  if (path == 0) {
    if (strides[nd - 1] != 1 || sizes[nd - 1] % vec != 0 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0) {
      return bad;
    }
    for (int d = 0; d + 1 < nd; ++d) {
      if (strides[d] % vec != 0) {
        return bad;
      }
    }
  }
  if (path == 1 && (nd < 2 || unit_dim < 0 || unit_dim >= nd - 1 ||
                    strides[unit_dim] != 1)) {
    return bad;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const bool wide = n >= (int64_t{1} << 31) || reach >= (int64_t{1} << 31);
  if (elem_bytes == 4) {
    return wide ? launch_path<uint32_t, int64_t>(x, path, nd, sizes, strides,
                                                 unit_dim, n, out, s)
                : launch_path<uint32_t, int32_t>(x, path, nd, sizes, strides,
                                                 unit_dim, n, out, s);
  }
  return wide ? launch_path<uint16_t, int64_t>(x, path, nd, sizes, strides,
                                               unit_dim, n, out, s)
              : launch_path<uint16_t, int32_t>(x, path, nd, sizes, strides,
                                               unit_dim, n, out, s);
}
