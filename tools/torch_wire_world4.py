"""The wire compression alone on the card: ``chip_smoke.py``'s
``fp8_codec``, ``unique_map`` and ``world4_wire`` phases without the rest
of the smoke.

  python3 tools/torch_wire_world4.py

Run from the repository root. The codec and unique-map phases run on the
first card; then four ranks are spawned as ``chip_smoke.py`` spawns them:
over NCCL, one rank a card, at the full Criteo-1TB vocabulary on a
machine with four cards; over gloo, the four sharing the card, at
x 1/16 on one. Each runs the phase's variants with its checks (the dedup
activations bit-equal to the raw exchange's under every schedule, three
steps in the f32 class of the raw steps, the bf16 and fp8 activations
within their bounds, the capped step's ``dedup_overflow`` equal to the
numpy count, dedup serving bit-equal to raw serving, the launches as
predicted). Prints the card, the phases' JSON lines and, last, the
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


def wire_rank(rank: int, port: int, backend: str, outdir: str) -> None:
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
    batch = chip_smoke.w4_batch(torch, vocab, mesh)
    out = chip_smoke._w4_wire(torch, mesh, backend, batch)
  finally:
    mesh.close()
  with open(os.path.join(outdir, f"wire{rank}.json"), "w") as f:
    json.dump(out, f)


def main() -> int:
  import torch
  import torch.multiprocessing as mp

  if not torch.cuda.is_available():
    print("torch_wire_world4: no CUDA card", file=sys.stderr)
    return 2
  from distributed_embeddings_torch.ops import _build

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = chip_smoke.nvidia_smi()
  print(smi, flush=True)
  _build.build_all(_build.KERNELS)
  flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
  chip_smoke.warm_up(torch)
  chip_smoke.phase_fp8_codec(torch, flush)
  chip_smoke.phase_unique_map(torch, flush)
  del flush
  torch.cuda.empty_cache()
  backend = "nccl" if torch.cuda.device_count() >= chip_smoke.WORLD \
      else "gloo"
  with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
  outdir = tempfile.mkdtemp(prefix="torch_wire_world4_")
  mp.spawn(wire_rank, args=(port, backend, outdir), nprocs=chip_smoke.WORLD,
           join=True)
  wire = []
  for rank in range(chip_smoke.WORLD):
    with open(os.path.join(outdir, f"wire{rank}.json")) as f:
      wire.append(json.load(f))
  totals = chip_smoke.emit_wire_world4(backend, smi, wire)
  chip_smoke.emit({"launches": totals, "cards": torch.cuda.device_count()})
  return 0


if __name__ == "__main__":
  try:
    sys.exit(main())
  except chip_smoke.SmokeFailure as exc:
    print(f"torch_wire_world4: FAILED: {exc}", file=sys.stderr)
    sys.exit(1)
