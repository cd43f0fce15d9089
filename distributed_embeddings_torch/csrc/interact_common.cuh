// The DLRM pairwise interaction's maths, written once for K2 and K3.
//
// K2 (interact_fwd.cu, interact_bwd.cu) reads the F features of a sample
// from F separate [B, D] bf16 parts; K3 (interact_flat_fwd.cu,
// interact_flat_bwd.cu) reads them from one flat [B, F, D] bf16 tensor.
// Both compute the same two functions, so the kernels below are templates
// over a row-address functor: `rows.row(p, s)` is the address of feature
// p of sample s, and the backward's `outs.row(p, s)` the address its
// cotangent row is written to. Everything else (the shared-memory
// staging, the pair table, the f32 sums and the bf16 roundings) is one
// body per direction.
//
// Forward, for each sample b and each pair n = (p, q) in
// np.tril_indices(F, k) order (k = -1, or 0 with self-interaction):
//
//     acts[b, n] = float(bf16_rn(sum_d x_p[b, d] * x_q[b, d]))
//
// with the sum accumulated in f32: the TPU kernels' function (they round
// the F x F pair products to bf16 and select the lower triangle with a
// half-weight matrix M, and 0.5*a + 0.5*a == a).
//
// Backward, given the [B, P] f32 cotangent of the pair activations:
//
//     da = bf16_rn(d_acts[b, :])
//     d_x_p[b, :] = bf16_rn( sum_q c_pq * x_q[b, :] )   (f32 sums)
//
// with c_pq = da[pair(p, q)] for p != q and, on the diagonal,
// c_pp = 2 * da[pair(p, p)] when k = 0 and 0 when k = -1: the TPU kernels'
// 2 * bf16(d_acts . M^T) @ F exactly (M's halves are exact in bf16 and 2 is
// a power of two). Products of bf16 values are exact in f32, so only the
// order of the f32 sums over q can differ from another implementation.
//
// Bound on this card, per sample: the forward reads F*D*2 bytes and writes
// P*4; the backward reads P*4 + F*D*2 and writes F*D*2. Their FLOPs are far
// below the bf16 tensor-core rate, so both are memory-bound. Each feature
// row is read from device memory once (16-byte loads into shared memory),
// every pair product stays on chip, and each output is written once. These
// first versions compute on the CUDA cores from shared memory; a wgmma/TMA
// tiling of the F x F product is later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace interact {

constexpr int kMaxParts = 32;
constexpr int kThreads = 256;
// bf16 padding per staged row: a 16-byte skew so that threads reading
// different rows at the same column hit different shared-memory banks
constexpr int kRowPad = 8;

// K2's inputs: f separate contiguous [b, d] parts
struct PartRows {
  const __nv_bfloat16* p[kMaxParts];
  int d;
  __device__ const __nv_bfloat16* row(int part, size_t sample) const {
    return p[part] + sample * d;
  }
};

// K2-bwd's outputs: f separate contiguous [b, d] parts
struct PartOuts {
  __nv_bfloat16* p[kMaxParts];
  int d;
  __device__ __nv_bfloat16* row(int part, size_t sample) const {
    return p[part] + sample * d;
  }
};

// K3's input: one contiguous [b, f, d] tensor
struct FlatRows {
  const __nv_bfloat16* base;
  int f;
  int d;
  __device__ const __nv_bfloat16* row(int part, size_t sample) const {
    return base + (sample * f + part) * d;
  }
};

// K3-bwd's output: one contiguous [b, f, d] tensor
struct FlatOuts {
  __nv_bfloat16* base;
  int f;
  int d;
  __device__ __nv_bfloat16* row(int part, size_t sample) const {
    return base + (sample * f + part) * d;
  }
};

inline int npair_of(int f, int k) {
  return (k == 0) ? f * (f + 1) / 2 : f * (f - 1) / 2;
}

inline bool args_ok(int f, int b, int d, int k, int samples_per_block) {
  return f >= 1 && f <= kMaxParts && b >= 0 && d > 0 && d % 8 == 0 &&
         (k == 0 || k == -1) && samples_per_block >= 1;
}

// the pair table in tril order: row p holds pairs (p, 0) .. (p, p + k)
__device__ inline void fill_pair_table(unsigned char* pair_pq, int f, int k) {
  for (int p = threadIdx.x; p < f; p += blockDim.x) {
    const int start = (k == 0) ? p * (p + 1) / 2 : p * (p - 1) / 2;
    for (int q = 0; q <= p + k; ++q) {
      pair_pq[2 * (start + q)] = static_cast<unsigned char>(p);
      pair_pq[2 * (start + q) + 1] = static_cast<unsigned char>(q);
    }
  }
}

// stage the tile's [ns, f, d] rows, 16 bytes per thread per step;
// consecutive threads read consecutive 16-byte pieces of one row
template <typename Rows>
__device__ inline void stage_rows(const Rows& in, __nv_bfloat16* rows, int f,
                                  int d, int s0, int ns) {
  const int row_elems = d + kRowPad;
  const int vec_per_row = d / 8;
  const int total_vec = f * ns * vec_per_row;
  for (int i = threadIdx.x; i < total_vec; i += blockDim.x) {
    const int c = i % vec_per_row;
    const int rest = i / vec_per_row;
    const int s = rest % ns;
    const int p = rest / ns;
    const uint4* src =
        reinterpret_cast<const uint4*>(in.row(p, static_cast<size_t>(s0 + s))) +
        c;
    *reinterpret_cast<uint4*>(
        rows + (static_cast<size_t>(s) * f + p) * row_elems + c * 8) =
        __ldg(src);
  }
}

template <typename Rows>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(Rows in, int f, int b, int d, int k, int npair,
           int samples_per_block, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row_elems = d + kRowPad;
  __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* pair_pq =
      smem_raw + static_cast<size_t>(samples_per_block) * f * row_elems *
                     sizeof(__nv_bfloat16);

  const int s0 = blockIdx.x * samples_per_block;
  const int ns = min(samples_per_block, b - s0);

  fill_pair_table(pair_pq, f, k);
  stage_rows(in, rows, f, d, s0, ns);
  __syncthreads();

  // one (sample, pair) item per thread step: consecutive threads take
  // consecutive pairs, so the [B, P] output is written coalesced
  const int vec_per_row = d / 8;
  const int items = ns * npair;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int s = it / npair;
    const int n = it - s * npair;
    const int p = pair_pq[2 * n];
    const int q = pair_pq[2 * n + 1];
    const __nv_bfloat16* rp =
        rows + (static_cast<size_t>(s) * f + p) * row_elems;
    const __nv_bfloat16* rq =
        rows + (static_cast<size_t>(s) * f + q) * row_elems;
    float acc = 0.f;
#pragma unroll 4
    for (int c = 0; c < vec_per_row; ++c) {
      const uint4 va = *reinterpret_cast<const uint4*>(rp + c * 8);
      const uint4 vb = *reinterpret_cast<const uint4*>(rq + c * 8);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&va);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&vb);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fa = __bfloat1622float2(a2[j]);
        const float2 fb = __bfloat1622float2(b2[j]);
        acc = fmaf(fa.x, fb.x, acc);
        acc = fmaf(fa.y, fb.y, acc);
      }
    }
    out[static_cast<size_t>(s0 + s) * npair + n] =
        __bfloat162float(__float2bfloat16_rn(acc));
  }
}

template <typename Rows, typename Outs>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(Rows in, Outs outs, const float* __restrict__ d_acts, int f, int b,
           int d, int k, int npair, int samples_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row_elems = d + kRowPad;
  __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* coef = reinterpret_cast<float*>(
      smem_raw + static_cast<size_t>(samples_per_block) * f * row_elems *
                     sizeof(__nv_bfloat16));
  unsigned char* pair_pq = reinterpret_cast<unsigned char*>(
      coef + static_cast<size_t>(samples_per_block) * f * f);

  const int s0 = blockIdx.x * samples_per_block;
  const int ns = min(samples_per_block, b - s0);

  fill_pair_table(pair_pq, f, k);
  // without self-interaction no pair writes the diagonal
  if (k == -1) {
    for (int i = threadIdx.x; i < ns * f; i += blockDim.x) {
      const int s = i / f;
      const int p = i - s * f;
      coef[(static_cast<size_t>(s) * f + p) * f + p] = 0.f;
    }
  }
  stage_rows(in, rows, f, d, s0, ns);
  __syncthreads();

  // symmetric coefficients from the bf16-rounded cotangent; the tile's
  // [ns, npair] cotangent block is contiguous, read coalesced
  for (int it = threadIdx.x; it < ns * npair; it += blockDim.x) {
    const int s = it / npair;
    const int n = it - s * npair;
    const int p = pair_pq[2 * n];
    const int q = pair_pq[2 * n + 1];
    const float c = __bfloat162float(__float2bfloat16_rn(
        __ldg(d_acts + static_cast<size_t>(s0) * npair + it)));
    float* cs = coef + static_cast<size_t>(s) * f * f;
    if (p == q) {
      cs[p * f + p] = 2.f * c;
    } else {
      cs[p * f + q] = c;
      cs[q * f + p] = c;
    }
  }
  __syncthreads();

  // one (sample, feature, 8-lane group) per thread step: consecutive
  // threads take consecutive 16-byte groups of one output row (coalesced
  // stores)
  const int vec_per_row = d / 8;
  const int items = ns * f * vec_per_row;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int c8 = it % vec_per_row;
    const int rest = it / vec_per_row;
    const int p = rest % f;
    const int s = rest / f;
    const float* cp = coef + (static_cast<size_t>(s) * f + p) * f;
    const __nv_bfloat16* xs = rows + static_cast<size_t>(s) * f * row_elems;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < f; ++q) {
      const float cq = cp[q];
      const uint4 v =
          *reinterpret_cast<const uint4*>(xs + q * row_elems + c8 * 8);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fx = __bfloat1622float2(x2[j]);
        acc[2 * j] = fmaf(cq, fx.x, acc[2 * j]);
        acc[2 * j + 1] = fmaf(cq, fx.y, acc[2 * j + 1]);
      }
    }
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o2[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
    }
    *reinterpret_cast<uint4*>(outs.row(p, static_cast<size_t>(s0 + s)) +
                              c8 * 8) = o;
  }
}

// Launch the forward on `stream`; returns cudaGetLastError() (0 on success).
template <typename Rows>
int launch_fwd(const Rows& in, int f, int b, int d, int k,
               int samples_per_block, float* out, cudaStream_t stream) {
  const int npair = npair_of(f, k);
  if (b == 0 || npair == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const size_t smem = static_cast<size_t>(samples_per_block) * f *
                          (d + kRowPad) * sizeof(__nv_bfloat16) +
                      2 * static_cast<size_t>(npair);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwd_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      return static_cast<int>(e);
    }
  }
  const int grid = (b + samples_per_block - 1) / samples_per_block;
  fwd_kernel<Rows><<<grid, kThreads, smem, stream>>>(
      in, f, b, d, k, npair, samples_per_block, out);
  return static_cast<int>(cudaGetLastError());
}

// Launch the backward on `stream`; returns cudaGetLastError() (0 on
// success).
template <typename Rows, typename Outs>
int launch_bwd(const Rows& in, const Outs& outs, const float* d_acts, int f,
               int b, int d, int k, int samples_per_block,
               cudaStream_t stream) {
  const int npair = npair_of(f, k);
  if (b == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const size_t smem = static_cast<size_t>(samples_per_block) * f *
                          ((d + kRowPad) * sizeof(__nv_bfloat16) +
                           f * sizeof(float)) +
                      2 * static_cast<size_t>(npair);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwd_kernel<Rows, Outs>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      return static_cast<int>(e);
    }
  }
  const int grid = (b + samples_per_block - 1) / samples_per_block;
  bwd_kernel<Rows, Outs><<<grid, kThreads, smem, stream>>>(
      in, outs, d_acts, f, b, d, k, npair, samples_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace interact
