// K2-fwd: the DLRM pairwise-interaction forward, written for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_embeddings_tpu/ops/pallas_interact.py:
// interact_parts_fwd. For each sample b and each pair n = (p, q) in
// np.tril_indices(F, k) order (k = -1, or 0 with self-interaction):
//
//     acts[b, n] = float(bf16_rn(sum_d part_p[b, d] * part_q[b, d]))
//
// with the sum accumulated in f32. That is the TPU kernel's function: it
// rounds the F x F pair products to bf16 and selects the lower triangle
// with a half-weight matrix M, and 0.5*a + 0.5*a == a, so the selection
// product changes nothing and this kernel computes the pairs directly.
//
// Inputs are the f parts as separate [B, D] bf16 tensors (the per-part I/O
// of the TPU kernel: no concat exists in device memory). The launcher takes
// a host array of the f pointers and passes it as a by-value struct.
//
// Bound on this card: per sample it must read F*D*2 bytes and write P*4
// bytes (8,316 B at F=27, D=128, P=351): 10.2 us at B=4096 and 163 us at
// B=65536 against 3.35 TB/s. Its 2*P*D*B FLOPs are far below the bf16
// tensor-core rate, so the kernel is memory-bound. The design reads each
// part row from device memory exactly once (16-byte loads into shared
// memory) and keeps every pair product on chip; only the [B, P] result is
// written. This first version computes the dots on the CUDA cores from
// shared memory; wgmma/TMA tiling of the F x F product is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxParts = 32;
constexpr int kThreads = 256;
// bf16 padding per staged row: a 16-byte skew so that threads reading
// different rows at the same column hit different shared-memory banks
constexpr int kRowPad = 8;

struct PartPtrs {
  const __nv_bfloat16* p[kMaxParts];
};

__global__ void __launch_bounds__(kThreads)
interact_fwd_kernel(PartPtrs parts, int f, int b, int d, int k, int npair,
                    int samples_per_block, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row_elems = d + kRowPad;
  __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* pair_pq =
      smem_raw + static_cast<size_t>(samples_per_block) * f * row_elems *
                     sizeof(__nv_bfloat16);

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

  // stage the tile's [ns, f, d] rows, 16 bytes per thread per step;
  // consecutive threads read consecutive 16-byte pieces of one part's rows
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

  // one (sample, pair) item per thread step: consecutive threads take
  // consecutive pairs, so the [B, P] output is written coalesced
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

}  // namespace

// part_ptrs: host array of f device pointers, each a contiguous, 16-byte
// aligned [b, d] bf16 buffer; out: [b, npair] f32. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int interact_fwd_launch(const void* const* part_ptrs, int f, int b,
                                   int d, int k, int samples_per_block,
                                   void* out, void* stream) {
  if (f < 1 || f > kMaxParts || b < 0 || d <= 0 || d % 8 != 0 ||
      (k != 0 && k != -1) || samples_per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PartPtrs parts = {};
  for (int i = 0; i < f; ++i) {
    parts.p[i] = static_cast<const __nv_bfloat16*>(part_ptrs[i]);
  }
  const int npair = (k == 0) ? f * (f + 1) / 2 : f * (f - 1) / 2;
  if (b == 0 || npair == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const size_t smem = static_cast<size_t>(samples_per_block) * f *
                          (d + kRowPad) * sizeof(__nv_bfloat16) +
                      2 * static_cast<size_t>(npair);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        interact_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      return static_cast<int>(e);
    }
  }
  const int grid = (b + samples_per_block - 1) / samples_per_block;
  interact_fwd_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      parts, f, b, d, k, npair, samples_per_block, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
