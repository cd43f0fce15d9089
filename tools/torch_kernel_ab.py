"""Time two source trees' versions of the port's K1, K6, K2-fwd and K4 in
one run on the card.

  python3 tools/torch_kernel_ab.py PARENT_DIR [apply_rows]
      [build_delta_rows] [interact_fwd] [gather_rows]

PARENT_DIR holds another checkout of the repository (e.g. ``git archive``
of the parent commit unpacked under ``build/``). Each named kernel (by
default all four) is built from ``PARENT_DIR/distributed_embeddings_torch/
csrc`` and from this checkout's sources; then ``chip_smoke.py``'s kernel
phases of those kernels run four times, with the parent's, this
checkout's, this checkout's and the parent's libraries (each run holds
the kernel against its plain version, as ``chip_smoke.py`` does). A
parent's K2-fwd runs at the unit its own wrapper chose (``samples_per_block``
before the forward's ``fwd_geometry``), and checks that read a plan or a
geometry back from a library are skipped for a library that does not
export it. Every row is printed; the last line is one JSON object: per
row (``name:stream``, or ``name:B<b>_k<k>`` for K2-fwd), the kernel times
in that order beside the bound and the library time, and K4's
yardsticks in the same order. Needs one card; the phases' checks fail
the run as they fail ``chip_smoke.py``.
"""

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KERNELS = ("apply_rows", "build_delta_rows", "interact_fwd", "gather_rows")
# K4's yardsticks, timed in the same calls as the kernel
K4_YARDSTICKS = ("tlb_reach_ms", "sorted_ms", "empty_grid_ms",
                 "stream_copy_ms")


def parent_samples_per_block(f: int, d: int) -> int:
  """The K2-fwd unit of the wrapper before ``fwd_geometry``: as many
  samples as fit 48 KB of bf16 rows (8 lanes of padding), 1 to 8."""
  return max(1, min(8, 48 * 1024 // (f * (d + 8) * 2)))
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
  from distributed_embeddings_torch.ops import cuda_exchange as cx
  from distributed_embeddings_torch.ops import cuda_interact as ci

  smi = cs.nvidia_smi()
  print(smi, flush=True)
  libs = {"change": _build.build_all(names),
          "parent": build_parent(parent, names, _build,
                                 os.path.join(REPO, "build", "kernel_ab"))}
  rows, emit = [], cs.emit
  checks = {"k1_plan_check": ("apply_rows", "apply_rows_plan"),
            "k2_geometry_check": ("interact_fwd", "interact_fwd_geometry")}
  own = {name: getattr(cs, name) for name in checks}
  fwd_geometry = ci.fwd_geometry
  empty_kernel = cs.k4_empty_kernel
  if "gather_rows" in names:
    # the dispatch yardstick's empty kernel, from this checkout's library
    change_k4 = libs["change"]["gather_rows"]

    def k4_empty_kernel(torch_, n, stride):
      parent_k4 = _build._LIBS["gather_rows"]
      _build._LIBS["gather_rows"] = change_k4
      try:
        return empty_kernel(torch_, n, stride)
      finally:
        _build._LIBS["gather_rows"] = parent_k4
    cs.k4_empty_kernel = k4_empty_kernel

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
    # an older launcher may not export its plan or geometry
    for name, (kernel, symbol) in checks.items():
      lib = _build._LIBS.get(kernel)
      setattr(cs, name, own[name] if lib is not None and hasattr(lib, symbol)
              else (lambda *_: None))
    ci.fwd_geometry = fwd_geometry
    if tree == "parent" and "interact_fwd" in names:
      ci.fwd_geometry = lambda f, d, k: fwd_geometry(f, d, k)._replace(
          ns=parent_samples_per_block(f, d))
    rows.clear()
    if "apply_rows" in names:
      cs.phase_kernel_apply(torch, ca, flush, k1_rows)
      torch.cuda.empty_cache()
      cs.phase_kernel_apply_zoo(torch, ca, flush)
    if "build_delta_rows" in names:
      cs.phase_kernel_delta(torch, cd, flush)
    if "interact_fwd" in names:
      cs.phase_kernel_fwd(torch, ci, flush)
    torch.cuda.empty_cache()
    if "gather_rows" in names:
      cs.phase_kernel_gather(torch, cx, flush)
    torch.cuda.empty_cache()
    for r in rows:
      if "kernel_ms" not in r:
        continue
      if "stream" in r:
        key = f"{r['name']}:{r['stream']}"
      elif "B" in r:
        key = f"{r['name']}:B{r['B']}_k{r['k']}"
      else:
        key = f"{r['name']}:{r['class']}_h{r['h']}"
      t = times.setdefault(key, {"bound_ms": r["bound_ms"],
                                 "library_ms": r.get("library_ms"),
                                 "kernel_ms": []})
      t["kernel_ms"].append(r["kernel_ms"])
      for y in K4_YARDSTICKS:
        if y in r:
          t.setdefault(y, []).append(r[y])
  ci.fwd_geometry = fwd_geometry
  cs.k4_empty_kernel = empty_kernel
  for name, fn in own.items():
    setattr(cs, name, fn)
  emit({"card": smi, "order": list(ORDER), "streams": times})
  return 0


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))
