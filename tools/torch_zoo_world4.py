"""Column-sliced tables and the zoo harness alone on the card:
``chip_smoke.py``'s sliced kernel cases, ``zoo_main``, ``lookup_bench``,
``world4_colslice`` and ``zoo_world4`` without the rest of the smoke.

  python3 tools/torch_zoo_world4.py

Run from the repository root. The kernel cases (K6 and K1 on the 2- and
4-lane slices), the zoo twin at full vocabulary (f32 and ``--amp``) and
the lookup microbenchmark run on the first card; then four ranks are
spawned as ``chip_smoke.py`` spawns them: over NCCL, one rank a card, at
the full vocabularies (Criteo-1TB, Tiny; B = 65,536) on a machine with
four cards; over gloo, the four sharing the card, at the cuts
``chip_smoke.py`` lists on one. Each runs the phases with their checks.
Prints the card, the phases' JSON lines and, last, the launches summed
over the ranks.
"""

import json
import os
import socket
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def zoo_rank(rank: int, port: int, backend: str, outdir: str) -> None:
  import torch

  from distributed_embeddings_torch.parallel.mesh import create_mesh

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  mesh = create_mesh(chip_smoke.WORLD, rank, f"tcp://127.0.0.1:{port}",
                     device="cuda")
  chip_smoke.check(mesh.backend == backend,
                   f"rank {rank}: backend {mesh.backend}, not {backend}")
  out = {}
  try:
    for name, fn in (("colslice", chip_smoke._w4_colslice),
                     ("zoo", chip_smoke._w4_zoo)):
      t0 = time.perf_counter()
      out[name] = fn(torch, mesh, backend)
      out[name]["wall_s"] = time.perf_counter() - t0
  finally:
    mesh.close()
  with open(os.path.join(outdir, f"zoo{rank}.json"), "w") as f:
    json.dump(out, f)


def main() -> int:
  import torch
  import torch.multiprocessing as mp

  if not torch.cuda.is_available():
    print("torch_zoo_world4: no CUDA card", file=sys.stderr)
    return 2
  from distributed_embeddings_torch.ops import _build
  from distributed_embeddings_torch.ops import cuda_apply as ca
  from distributed_embeddings_torch.ops import cuda_delta as cd

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = chip_smoke.nvidia_smi()
  print(smi, flush=True)
  _build.build_all(_build.KERNELS)
  flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
  chip_smoke.warm_up(torch)
  chip_smoke.phase_kernel_sliced(torch, ca, cd, flush)
  del flush
  torch.cuda.empty_cache()
  chip_smoke.phase_zoo_main(torch, smi)
  chip_smoke.phase_lookup_bench(torch, smi)
  torch.cuda.empty_cache()
  backend = "nccl" if torch.cuda.device_count() >= chip_smoke.WORLD \
      else "gloo"
  with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
  outdir = tempfile.mkdtemp(prefix="torch_zoo_world4_")
  t0 = time.perf_counter()
  mp.spawn(zoo_rank, args=(port, backend, outdir), nprocs=chip_smoke.WORLD,
           join=True)
  wall_s = time.perf_counter() - t0
  ranks = []
  for rank in range(chip_smoke.WORLD):
    with open(os.path.join(outdir, f"zoo{rank}.json")) as f:
      ranks.append(json.load(f))
  totals = chip_smoke.emit_colslice_world4(
      backend, smi, [r["colslice"] for r in ranks])
  plan, dense = chip_smoke.emit_zoo_world4(backend, smi,
                                           [r["zoo"] for r in ranks])
  chip_smoke.emit({"phase": "world4", "wall_s": wall_s,
                   "launches": {"world4_colslice": totals,
                                "zoo_world4_plan": plan,
                                "zoo_world4_dense": dense}})
  return 0


if __name__ == "__main__":
  try:
    sys.exit(main())
  except chip_smoke.SmokeFailure as exc:
    print(f"torch_zoo_world4: FAILED: {exc}", file=sys.stderr)
    sys.exit(1)
