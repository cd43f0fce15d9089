"""Time two source trees' versions of the port's K1 and K6 in one run on
the card.

  python3 tools/torch_kernel_ab.py PARENT_DIR [apply_rows] [build_delta_rows]

PARENT_DIR holds another checkout of the repository (e.g. ``git archive``
of the parent commit unpacked under ``build/``). Each named kernel (by
default both) is built from ``PARENT_DIR/distributed_embeddings_torch/
csrc`` and from this checkout's sources; then ``chip_smoke.py``'s kernel
phases of those kernels run four times, with the parent's, this
checkout's, this checkout's and the parent's libraries (each run holds
the kernel against its plain version, as ``chip_smoke.py`` does). Every
row is printed; the last line is one JSON object: per stream, the kernel
times in that order beside the bound and the library time. Needs one
card; the phases' checks fail the run as they fail ``chip_smoke.py``.
"""

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KERNELS = ("apply_rows", "build_delta_rows")
ORDER = ("parent", "change", "change", "parent")


def build_parent(parent: str, names, build, out_dir: str) -> dict:
  """Build each kernel of the parent tree in parallel; name -> CDLL."""
  os.makedirs(out_dir, exist_ok=True)
  nvcc = build.nvcc_path()
  procs = {}
  for name in names:
    lib = os.path.join(out_dir, f"lib{name}_parent.so")
    src = os.path.join(parent, "distributed_embeddings_torch", "csrc",
                       f"{name}.cu")
    procs[name] = (lib, subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-I", os.path.dirname(src), "-o", lib,
         src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
  libs = {}
  for name, (lib, proc) in procs.items():
    log, _ = proc.communicate()
    if proc.returncode != 0:
      raise RuntimeError(f"parent {name}: nvcc exit {proc.returncode}\n{log}")
    libs[name] = ctypes.CDLL(lib)
  return libs


def main(argv) -> int:
  if not argv or argv[0].startswith("-"):
    print(__doc__, file=sys.stderr)
    return 2
  parent, names = argv[0], tuple(argv[1:]) or KERNELS
  unknown = set(names) - set(KERNELS)
  if unknown:
    print(f"no kernel phase for {sorted(unknown)}", file=sys.stderr)
    return 2
  import torch
  if not torch.cuda.is_available():
    print("torch_kernel_ab: no CUDA card", file=sys.stderr)
    return 2
  import chip_smoke as cs
  from distributed_embeddings_torch.ops import _build
  from distributed_embeddings_torch.ops import cuda_apply as ca
  from distributed_embeddings_torch.ops import cuda_delta as cd

  smi = cs.nvidia_smi()
  print(smi, flush=True)
  libs = {"change": _build.build_all(names),
          "parent": build_parent(parent, names, _build,
                                 os.path.join(REPO, "build", "kernel_ab"))}
  rows, plan_check, emit = [], cs.k1_plan_check, cs.emit

  def collect(obj):
    rows.append(obj)
    emit(obj)

  cs.emit = collect
  flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
  cs.warm_up(torch)
  k1_rows = cs.first_sparse_class(cs.train_plan())[2]
  times = {}
  for tree in ORDER:
    _build._LIBS.update(libs[tree])
    # an older launcher may not export its tile plan
    has_plan = hasattr(_build._LIBS.get("apply_rows", _build), "apply_rows_plan")
    cs.k1_plan_check = plan_check if has_plan else (lambda *_: None)
    rows.clear()
    if "apply_rows" in names:
      cs.phase_kernel_apply(torch, ca, flush, k1_rows)
      torch.cuda.empty_cache()
      cs.phase_kernel_apply_zoo(torch, ca, flush)
    if "build_delta_rows" in names:
      cs.phase_kernel_delta(torch, cd, flush)
    torch.cuda.empty_cache()
    for r in rows:
      if "kernel_ms" not in r:
        continue
      key = r["name"] + ":" + (r.get("stream")
                               or f"{r['class']}_h{r['h']}")
      t = times.setdefault(key, {"bound_ms": r["bound_ms"],
                                 "library_ms": r.get("library_ms"),
                                 "kernel_ms": []})
      t["kernel_ms"].append(r["kernel_ms"])
  emit({"card": smi, "order": list(ORDER), "streams": times})
  return 0


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))
