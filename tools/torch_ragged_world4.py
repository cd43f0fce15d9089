"""The ragged value streams at world 4 alone on the card:
``chip_smoke.py``'s ``world4_ragged`` phase without the rest of the
smoke.

  python3 tools/torch_ragged_world4.py

Run from the repository root. Four ranks are spawned as ``chip_smoke.py``
spawns them: over NCCL, one rank a card, at the full Criteo-1TB
vocabulary on a machine with four cards; over gloo, the four sharing the
card, at x 1/16 on one. Each runs the phase with its checks (the ragged
activations bit-equal under ``overlap='none'``, ``'pipelined'`` and
``'fused'``, the padded twin within 1e-5, ``dedup_exchange`` beside raw
ragged buckets bit-equal, ragged serving bit-equal to the eval step, the
guarded step's OOV counts equal to numpy's, model-parallel inputs
bit-equal to the dp-input forward, the launches as predicted) and times
its forwards. Prints the card, the phase's JSON line and, last, the
launches summed over the ranks.
"""

import json
import os
import socket
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def ragged_rank(rank: int, port: int, backend: str, outdir: str) -> None:
  import torch

  from distributed_embeddings_torch.parallel.mesh import create_mesh

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  mesh = create_mesh(chip_smoke.WORLD, rank, f"tcp://127.0.0.1:{port}",
                     device="cuda")
  chip_smoke.check(mesh.backend == backend,
                   f"rank {rank}: backend {mesh.backend}, not {backend}")
  try:
    out = chip_smoke._w4_ragged(torch, mesh, backend)
  finally:
    mesh.close()
  with open(os.path.join(outdir, f"ragged{rank}.json"), "w") as f:
    json.dump(out, f)


def main() -> int:
  import torch
  import torch.multiprocessing as mp

  if not torch.cuda.is_available():
    print("torch_ragged_world4: no CUDA card", file=sys.stderr)
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
  outdir = tempfile.mkdtemp(prefix="torch_ragged_world4_")
  mp.spawn(ragged_rank, args=(port, backend, outdir),
           nprocs=chip_smoke.WORLD, join=True)
  res = []
  for rank in range(chip_smoke.WORLD):
    with open(os.path.join(outdir, f"ragged{rank}.json")) as f:
      res.append(json.load(f))
  totals = chip_smoke.emit_ragged_world4(backend, smi, res)
  chip_smoke.emit({"launches": totals, "cards": torch.cuda.device_count()})
  return 0


if __name__ == "__main__":
  try:
    sys.exit(main())
  except chip_smoke.SmokeFailure as exc:
    print(f"torch_ragged_world4: FAILED: {exc}", file=sys.stderr)
    sys.exit(1)
