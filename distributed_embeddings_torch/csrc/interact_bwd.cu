// K2-bwd: the DLRM pairwise-interaction backward, written for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_embeddings_tpu/ops/pallas_interact.py:
// interact_parts_bwd. Given the [B, P] f32 cotangent of the pair
// activations and the f bf16 [B, D] parts of the forward, it writes the f
// bf16 [B, D] part cotangents:
//
//     da = bf16_rn(d_acts[b, :])
//     d_part_p[b, :] = bf16_rn( sum_q c_pq * part_q[b, :] )   (f32 sums)
//
// with c_pq = da[pair(p, q)] for p != q (pairs in np.tril_indices(F, k)
// order, each pair feeding both of its cells), and on the diagonal
// c_pp = 2 * da[pair(p, p)] when k = 0 and 0 when k = -1. That is the TPU
// kernel's 2 * bf16(d_acts . M^T) @ F exactly: M's halves are exact in
// bf16 and 2 is a power of two, so the kernel builds the symmetric
// coefficients per sample and needs no M. The products of bf16 values are
// exact in f32, so only the order of the f32 sums over q can differ from
// another implementation.
//
// Inputs and outputs are the f parts as separate tensors (the TPU kernel's
// per-part I/O: no concat or split exists in device memory). The launcher
// takes host arrays of the f input and f output pointers and passes them
// as by-value structs.
//
// Bound on this card: per sample it must read P * 4 bytes of cotangent and
// F * D * 2 bytes of parts, and write F * D * 2 bytes (15,228 B at F=27,
// D=128, P=351): 18.6 us at B=4096 and 298 us at B=65536 against
// 3.35 TB/s. Its 2 * F * F * D * B FLOPs are far below the card's rates,
// so the kernel is memory-bound. The design reads each part row and each
// cotangent once (16-byte and coalesced 4-byte loads into shared memory),
// keeps the F x F coefficients of a sample in shared memory, and writes
// each output row once with 16-byte stores. This first version
// accumulates on the CUDA cores; a tensor-core product of the F x F tile
// and a staged pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxParts = 32;
constexpr int kThreads = 256;
// bf16 padding per staged row (16 bytes), as in interact_fwd.cu
constexpr int kRowPad = 8;

struct PartPtrs {
  const __nv_bfloat16* p[kMaxParts];
};

struct OutPtrs {
  __nv_bfloat16* p[kMaxParts];
};

__global__ void __launch_bounds__(kThreads)
interact_bwd_kernel(PartPtrs parts, OutPtrs outs,
                    const float* __restrict__ d_acts, int f, int b, int d,
                    int k, int npair, int samples_per_block) {
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

  // pair table in tril order: row p holds pairs (p, 0) .. (p, p + k)
  for (int p = threadIdx.x; p < f; p += blockDim.x) {
    const int start = (k == 0) ? p * (p + 1) / 2 : p * (p - 1) / 2;
    for (int q = 0; q <= p + k; ++q) {
      pair_pq[2 * (start + q)] = static_cast<unsigned char>(p);
      pair_pq[2 * (start + q) + 1] = static_cast<unsigned char>(q);
    }
  }
  // without self-interaction no pair writes the diagonal
  if (k == -1) {
    for (int i = threadIdx.x; i < ns * f; i += blockDim.x) {
      const int s = i / f;
      const int p = i - s * f;
      coef[(static_cast<size_t>(s) * f + p) * f + p] = 0.f;
    }
  }

  // stage the tile's [ns, f, d] part rows, 16 bytes per thread per step
  const int vec_per_row = d / 8;
  const int total_vec = f * ns * vec_per_row;
  for (int i = threadIdx.x; i < total_vec; i += blockDim.x) {
    const int c = i % vec_per_row;
    const int rest = i / vec_per_row;
    const int s = rest % ns;
    const int p = rest / ns;
    const uint4* src = reinterpret_cast<const uint4*>(
                           parts.p[p] + static_cast<size_t>(s0 + s) * d) + c;
    *reinterpret_cast<uint4*>(
        rows + (static_cast<size_t>(s) * f + p) * row_elems + c * 8) =
        __ldg(src);
  }
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

  // one (sample, part, 8-lane group) per thread step: consecutive threads
  // take consecutive 16-byte groups of one output row (coalesced stores)
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
    *reinterpret_cast<uint4*>(outs.p[p] + static_cast<size_t>(s0 + s) * d +
                              c8 * 8) = o;
  }
}

}  // namespace

// d_acts: [b, npair] f32, contiguous; part_ptrs / out_ptrs: host arrays of
// f device pointers, each a contiguous, 16-byte aligned [b, d] bf16 buffer
// (inputs, then the outputs the kernel writes). Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int interact_bwd_launch(const void* d_acts,
                                   const void* const* part_ptrs,
                                   void* const* out_ptrs, int f, int b, int d,
                                   int k, int samples_per_block,
                                   void* stream) {
  if (f < 1 || f > kMaxParts || b < 0 || d <= 0 || d % 8 != 0 ||
      (k != 0 && k != -1) || samples_per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PartPtrs parts = {};
  OutPtrs outs = {};
  for (int i = 0; i < f; ++i) {
    parts.p[i] = static_cast<const __nv_bfloat16*>(part_ptrs[i]);
    outs.p[i] = static_cast<__nv_bfloat16*>(out_ptrs[i]);
  }
  const int npair = (k == 0) ? f * (f + 1) / 2 : f * (f - 1) / 2;
  if (b == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const size_t smem = static_cast<size_t>(samples_per_block) * f *
                          ((d + kRowPad) * sizeof(__nv_bfloat16) +
                           f * sizeof(float)) +
                      2 * static_cast<size_t>(npair);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        interact_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      return static_cast<int>(e);
    }
  }
  const int grid = (b + samples_per_block - 1) / samples_per_block;
  interact_bwd_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      parts, outs, static_cast<const float*>(d_acts), f, b, d, k, npair,
      samples_per_block);
  return static_cast<int>(cudaGetLastError());
}
