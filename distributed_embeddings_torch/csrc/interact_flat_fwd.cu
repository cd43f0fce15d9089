// K3-fwd: the DLRM pairwise-interaction forward on one flat input, written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_embeddings_tpu/ops/pallas_interact.py:
// interact_fwd (_fwd_kernel through _acts_of). Input: the [B, F, D] bf16
// features as one contiguous tensor (the [B, F*D] concat); output: the
// [B, P] f32 pair activations
//
//     acts[b, n] = float(bf16_rn(sum_d x[b, p, d] * x[b, q, d]))
//
// for each pair n = (p, q) of np.tril_indices(F, k), the sum in f32: K2-fwd's
// function, with one flat input in place of F part pointers. The body is
// K2-fwd's (interact_common.cuh, where the maths, the bound and the design,
// a per-sample X X^T on the tensor cores, are written once); only the
// row-address functor differs. The TPU kernel's 256-sample batch blocks,
// its [S, F, F] VMEM product and its selection matmul are Mosaic's way to
// the same function and are not carried over.
//
// Bound on this card: it must read F*D*2 bytes and write P*4 bytes per
// sample (8,316 B at F=27, D=128, P=351): 10.2 us at B=4096 and 163 us at
// B=65536 against 3.35 TB/s; memory-bound.

#include "interact_common.cuh"

// feats: [b, f, d] bf16, contiguous and 16-byte aligned; samples_per_block:
// the kernel's unit, 1 to 8 samples (ops/cuda_interact.py: fwd_geometry);
// out: [b, npair] f32. Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int interact_flat_fwd_launch(const void* feats, int f, int b,
                                        int d, int k, int samples_per_block,
                                        void* out, void* stream) {
  if (!interact::args_ok(f, b, d, k, samples_per_block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  interact::FlatRows rows = {static_cast<const __nv_bfloat16*>(feats), f, d};
  return interact::launch_fwd(rows, f, b, d, k, samples_per_block,
                              static_cast<float*>(out),
                              static_cast<cudaStream_t>(stream));
}
