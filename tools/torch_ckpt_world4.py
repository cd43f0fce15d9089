"""World-4 checkpoints alone on the card: ``chip_smoke.py``'s
``world4_ckpt`` phase without the world-4 train runs that precede it
there.

  python3 tools/torch_ckpt_world4.py

Run from the repository root. Four ranks are spawned as ``chip_smoke.py``
spawns them: over NCCL, one rank a card, on a machine with four cards;
over gloo, the four sharing the card, on one. Each builds a state of the
world-4 Criteo plan at x 1/16 with the scheduled SGD, takes one step,
saves its blocks into one shared directory (rank 0 gathers the
dense-class tables and publishes), restores it with its mesh, and checks
the phase's points: the restored state bit-equal to the saved one, the
step after the restore giving the saved state's loss, K4, K1, K2-fwd and
K2-bwd launched as a world-4 step launches them. Prints the card, the
phase's JSON line and, last, the launches summed over the ranks.
"""

import json
import os
import socket
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def ckpt_rank(rank: int, port: int, backend: str, outdir: str) -> None:
  import torch

  from distributed_embeddings_torch.parallel.mesh import create_mesh

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  mesh = create_mesh(chip_smoke.WORLD, rank, f"tcp://127.0.0.1:{port}",
                     device="cuda")
  chip_smoke.check(mesh.backend == backend,
                   f"rank {rank}: backend {mesh.backend}, not {backend}")
  try:
    out = chip_smoke._w4_ckpt(torch, mesh, backend, outdir)
  finally:
    mesh.close()
  with open(os.path.join(outdir, f"ckpt{rank}.json"), "w") as f:
    json.dump(out, f)


def main() -> int:
  import torch
  import torch.multiprocessing as mp

  if not torch.cuda.is_available():
    print("torch_ckpt_world4: no CUDA card", file=sys.stderr)
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
  outdir = tempfile.mkdtemp(prefix="torch_ckpt_world4_")
  mp.spawn(ckpt_rank, args=(port, backend, outdir), nprocs=chip_smoke.WORLD,
           join=True)
  ckpt = []
  for rank in range(chip_smoke.WORLD):
    with open(os.path.join(outdir, f"ckpt{rank}.json")) as f:
      ckpt.append(json.load(f))
  totals = chip_smoke.emit_ckpt_world4(backend, smi, ckpt)
  chip_smoke.emit({"launches": totals, "cards": torch.cuda.device_count()})
  return 0


if __name__ == "__main__":
  try:
    sys.exit(main())
  except chip_smoke.SmokeFailure as exc:
    print(f"torch_ckpt_world4: FAILED: {exc}", file=sys.stderr)
    sys.exit(1)
