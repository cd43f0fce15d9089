// K2-fwd: the DLRM pairwise-interaction forward, written for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_embeddings_tpu/ops/pallas_interact.py:
// interact_parts_fwd. For each sample b and each pair n = (p, q) in
// np.tril_indices(F, k) order (k = -1, or 0 with self-interaction):
//
//     acts[b, n] = float(bf16_rn(sum_d part_p[b, d] * part_q[b, d]))
//
// with the sum accumulated in f32 (the maths, its bound and its design, a
// per-sample X X^T on the tensor cores, are in interact_common.cuh, shared
// with K3's flat-input form).
//
// Inputs are the f parts as separate [B, D] bf16 tensors (the per-part I/O
// of the TPU kernel: no concat exists in device memory). The launcher takes
// a host array of the f pointers and passes them as a by-value struct.
//
// Bound on this card: 8,316 B per sample at F=27, D=128, P=351: 10.2 us at
// B=4096 and 163 us at B=65536 against 3.35 TB/s.

#include "interact_common.cuh"

// part_ptrs: host array of f device pointers, each a contiguous, 16-byte
// aligned [b, d] bf16 buffer; samples_per_block: the kernel's unit, 1 to 8
// samples (ops/cuda_interact.py: fwd_geometry); out: [b, npair] f32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int interact_fwd_launch(const void* const* part_ptrs, int f, int b,
                                   int d, int k, int samples_per_block,
                                   void* out, void* stream) {
  if (!interact::args_ok(f, b, d, k, samples_per_block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  interact::PartRows parts = {};
  parts.d = d;
  for (int i = 0; i < f; ++i) {
    parts.p[i] = static_cast<const __nv_bfloat16*>(part_ptrs[i]);
  }
  return interact::launch_fwd(parts, f, b, d, k, samples_per_block,
                              static_cast<float*>(out),
                              static_cast<cudaStream_t>(stream));
}

// The geometry the launcher lays out for (f, d, k, samples_per_block), for
// checking against ops/cuda_interact.py: fwd_geometry. out[0..7] = xr, kt,
// nkt, re, the tile mask (bit m * 4 + n), x_stage, o_stage and smem bytes.
// Returns 0, or cudaErrorInvalidValue for arguments the launcher refuses.
extern "C" int interact_fwd_geometry(int f, int d, int k,
                                     int samples_per_block, int64_t* out) {
  if (!interact::args_ok(f, 0, d, k, samples_per_block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const interact::FwdGeo g = interact::fwd_geo(f, d, k, samples_per_block);
  const int64_t v[8] = {g.xr, g.kt, g.nkt, g.re, g.tiles,
                        static_cast<int64_t>(g.x_stage),
                        static_cast<int64_t>(g.o_stage),
                        static_cast<int64_t>(g.smem)};
  for (int i = 0; i < 8; ++i) {
    out[i] = v[i];
  }
  return 0;
}
