"""The README Quick start at world 4 alone on the card: ``chip_smoke.py``'s
world-4 dense-autodiff phase (``world4_dense_golden``,
``train_dense_world4``) without the phases that precede it there.

  python3 tools/torch_dense_world4.py

Run from the repository root. Four ranks are spawned as ``chip_smoke.py``
spawns them: over NCCL, one rank a card, on a machine with four cards (the
full Criteo-1TB vocabulary); over gloo, the four sharing the card, on one
(vocabulary x 1/16). Each replays the world-4 dense golden, then trains a
``DLRM(mesh=)`` with ``make_train_step(mesh=)`` at f32 and bf16 compute
with the phase's checks (losses finite and equal on every rank, K2-fwd and
K2-bwd once per step and no other kernel, untouched rows unchanged, the
replicated parameters bit-equal across the ranks). Prints the card, the
phase's JSON lines and, last, the launches summed over the ranks.
"""

import json
import os
import socket
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def dense_rank(rank: int, port: int, backend: str, outdir: str) -> None:
  import torch

  from distributed_embeddings_torch.parallel.mesh import create_mesh

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  mesh = create_mesh(chip_smoke.WORLD, rank, f"tcp://127.0.0.1:{port}",
                     device="cuda")
  chip_smoke.check(mesh.backend == backend,
                   f"rank {rank}: backend {mesh.backend}, not {backend}")
  try:
    vocab, _ = chip_smoke.world4_plan(backend)
    out = chip_smoke._w4_dense(torch, mesh, backend,
                               chip_smoke.w4_batch(torch, vocab, mesh))
  finally:
    mesh.close()
  with open(os.path.join(outdir, f"dense{rank}.json"), "w") as f:
    json.dump(out, f)


def main() -> int:
  import torch
  import torch.multiprocessing as mp

  if not torch.cuda.is_available():
    print("torch_dense_world4: no CUDA card", file=sys.stderr)
    return 2
  from distributed_embeddings_torch.ops import _build

  smi = chip_smoke.nvidia_smi()
  print(smi, flush=True)
  _build.build_all(_build.KERNELS)
  backend = "nccl" if torch.cuda.device_count() >= chip_smoke.WORLD \
      else "gloo"
  with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
  outdir = tempfile.mkdtemp(prefix="torch_dense_world4_")
  mp.spawn(dense_rank, args=(port, backend, outdir), nprocs=chip_smoke.WORLD,
           join=True)
  dense = []
  for rank in range(chip_smoke.WORLD):
    with open(os.path.join(outdir, f"dense{rank}.json")) as f:
      dense.append(json.load(f))
  totals = chip_smoke.emit_dense_world4(backend, smi, dense)
  chip_smoke.emit({"launches": totals, "cards": torch.cuda.device_count()})
  return 0


if __name__ == "__main__":
  try:
    sys.exit(main())
  except chip_smoke.SmokeFailure as exc:
    print(f"torch_dense_world4: FAILED: {exc}", file=sys.stderr)
    sys.exit(1)
