// K3-bwd: the DLRM pairwise-interaction backward on one flat input, written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_embeddings_tpu/ops/pallas_interact.py:
// interact_bwd (_bwd_kernel through _dfeats_of). Inputs: the [B, P] f32
// cotangent of the pair activations and the [B, F, D] bf16 features of the
// forward; output: the [B, F, D] bf16 feature cotangent
//
//     d_x[b, p, :] = bf16_rn( sum_q c_pq * x[b, q, :] )   (f32 sums)
//
// with c the symmetric coefficients of bf16(d_acts), doubled on the
// diagonal: the TPU kernel's bf16(2 * bf16(d_acts . M^T) @ F). K2-bwd's
// function, writing one flat output in place of F part outputs; the body is
// K2-bwd's (interact_common.cuh), only the row-address functors differ. The
// TPU kernel's f32 dsym scratch (a work-around for a Mosaic shape cast) and
// its 128-sample blocks are not carried over: the coefficients are built
// per sample in shared memory.
//
// Bound on this card: it must read P*4 + F*D*2 bytes and write F*D*2 bytes
// per sample (15,228 B at F=27, D=128, P=351): 18.6 us at B=4096 and 298 us
// at B=65536 against 3.35 TB/s; memory-bound.

#include "interact_common.cuh"

// d_acts: [b, npair] f32, contiguous; feats and d_feats: [b, f, d] bf16,
// contiguous and 16-byte aligned (input, then the output the kernel
// writes); samples_per_unit and d_tile: the kernel's unit
// (ops/cuda_interact.py: bwd_geometry). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int interact_flat_bwd_launch(const void* d_acts, const void* feats,
                                        void* d_feats, int f, int b, int d,
                                        int k, int samples_per_unit,
                                        int d_tile, void* stream) {
  if (!interact::bwd_args_ok(f, b, d, k, samples_per_unit, d_tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  interact::FlatRows rows = {static_cast<const __nv_bfloat16*>(feats), f, d};
  interact::FlatOuts outs = {static_cast<__nv_bfloat16*>(d_feats), f, d};
  return interact::launch_bwd(rows, outs, static_cast<const float*>(d_acts),
                              f, b, d, k, samples_per_unit, d_tile,
                              static_cast<cudaStream_t>(stream));
}
