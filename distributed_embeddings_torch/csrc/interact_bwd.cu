// K2-bwd: the DLRM pairwise-interaction backward, written for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_embeddings_tpu/ops/pallas_interact.py:
// interact_parts_bwd. Given the [B, P] f32 cotangent of the pair
// activations and the f bf16 [B, D] parts of the forward, it writes the f
// bf16 [B, D] part cotangents
//
//     d_part_p[b, :] = bf16_rn( sum_q c_pq * part_q[b, :] )   (f32 sums)
//
// with c the symmetric coefficients of bf16(d_acts) (the maths, its bound
// and its design are in interact_common.cuh, shared with K3's flat form).
//
// Inputs and outputs are the f parts as separate tensors (the TPU kernel's
// per-part I/O: no concat or split exists in device memory). The launcher
// takes host arrays of the f input and f output pointers and passes them
// as by-value structs.
//
// Bound on this card: 15,228 B per sample at F=27, D=128, P=351: 18.6 us
// at B=4096 and 298 us at B=65536 against 3.35 TB/s.

#include "interact_common.cuh"

// d_acts: [b, npair] f32, contiguous; part_ptrs / out_ptrs: host arrays of
// f device pointers, each a contiguous, 16-byte aligned [b, d] bf16 buffer
// (inputs, then the outputs the kernel writes); samples_per_unit and
// d_tile: the kernel's unit (ops/cuda_interact.py: bwd_geometry).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int interact_bwd_launch(const void* d_acts,
                                   const void* const* part_ptrs,
                                   void* const* out_ptrs, int f, int b, int d,
                                   int k, int samples_per_unit,
                                   int d_tile, void* stream) {
  if (!interact::bwd_args_ok(f, b, d, k, samples_per_unit, d_tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  interact::PartRows parts = {};
  interact::PartOuts outs = {};
  parts.d = outs.d = d;
  for (int i = 0; i < f; ++i) {
    parts.p[i] = static_cast<const __nv_bfloat16*>(part_ptrs[i]);
    outs.p[i] = static_cast<__nv_bfloat16*>(out_ptrs[i]);
  }
  return interact::launch_bwd(parts, outs, static_cast<const float*>(d_acts),
                              f, b, d, k, samples_per_unit, d_tile,
                              static_cast<cudaStream_t>(stream));
}
