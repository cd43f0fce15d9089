"""World-4 serving alone on the card: ``chip_smoke.py``'s ``serve_world4``
phase without the world-4 train runs that precede it there.

  python3 tools/torch_serve_world4.py

Run from the repository root. Four ranks are spawned as ``chip_smoke.py``
spawns them: over NCCL, one rank a card, on a machine with four cards;
over gloo, the four sharing the card, on one. Each builds a state of the
Criteo x 1/16 plan, exports its blocks into one shared directory, loads
the artifact with its mesh and answers the phase's global requests in
lockstep, with the phase's checks (every rank's predictions equal,
bit-equal to the in-memory engine's and to the world-4 eval step's,
K2-fwd once per rank and request). Prints the card, the phase's JSON
line and, last, the launches summed over the ranks.
"""

import json
import os
import socket
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def serve_rank(rank: int, port: int, backend: str, outdir: str) -> None:
  import torch

  from distributed_embeddings_torch.parallel.mesh import create_mesh

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  mesh = create_mesh(chip_smoke.WORLD, rank, f"tcp://127.0.0.1:{port}",
                     device="cuda")
  chip_smoke.check(mesh.backend == backend,
                   f"rank {rank}: backend {mesh.backend}, not {backend}")
  try:
    out = chip_smoke._w4_serve(torch, mesh, outdir)
  finally:
    mesh.close()
  with open(os.path.join(outdir, f"serve{rank}.json"), "w") as f:
    json.dump(out, f)


def main() -> int:
  import torch
  import torch.multiprocessing as mp

  if not torch.cuda.is_available():
    print("torch_serve_world4: no CUDA card", file=sys.stderr)
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
  outdir = tempfile.mkdtemp(prefix="torch_serve_world4_")
  mp.spawn(serve_rank, args=(port, backend, outdir), nprocs=chip_smoke.WORLD,
           join=True)
  serve = []
  for rank in range(chip_smoke.WORLD):
    with open(os.path.join(outdir, f"serve{rank}.json")) as f:
      serve.append(json.load(f))
  totals = chip_smoke.emit_serve_world4(backend, smi, serve)
  chip_smoke.emit({"launches": totals, "cards": torch.cuda.device_count()})
  return 0


if __name__ == "__main__":
  try:
    sys.exit(main())
  except chip_smoke.SmokeFailure as exc:
    print(f"torch_serve_world4: FAILED: {exc}", file=sys.stderr)
    sys.exit(1)
