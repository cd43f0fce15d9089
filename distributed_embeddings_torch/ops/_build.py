"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain ``extern "C"``
launcher. It is compiled by ``nvcc`` into a shared library under
``build/torch_kernels/`` at the repository root and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The library's
file name carries a hash of its source, so an edited source is never
served a stale build. Builds happen at first use, from the checkout's
sources only; :func:`build_all` starts every ``nvcc`` at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> ctypes library, and name -> nvcc/ptxas report of its build
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
  found = shutil.which("nvcc")
  if found:
    return found
  cand = Path("/usr/local/cuda/bin/nvcc")
  if cand.exists():
    return str(cand)
  raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                     "port's CUDA kernels are built from source at first use")


def _lib_path(name: str) -> Path:
  src = CSRC / f"{name}.cu"
  digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
  return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str, nvcc: str):
  """Start one nvcc into a temporary file; returns (process, tmp, final)."""
  out = _lib_path(name)
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
  cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
  proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
  return proc, tmp, out


def build_all(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
  """Build (in parallel) and load every named kernel not loaded yet."""
  names = list(names)
  with _LOCK:
    pending = {}
    nvcc: Optional[str] = None
    for name in names:
      if name in _LIBS:
        continue
      if _lib_path(name).exists():
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        BUILD_LOG.setdefault(name, "cached build")
        continue
      nvcc = nvcc or nvcc_path()
      pending[name] = _start(name, nvcc)
    failed = []
    for name, (proc, tmp, out) in pending.items():
      log, _ = proc.communicate()
      BUILD_LOG[name] = log
      if proc.returncode != 0:
        failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        continue
      os.replace(tmp, out)
      _LIBS[name] = ctypes.CDLL(str(out))
    if failed:
      raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
  return {n: _LIBS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
  """The loaded library of one kernel, built on first use."""
  lib = _LIBS.get(name)
  if lib is None:
    lib = build_all([name])[name]
  return lib


KERNELS = ("interact_fwd", "interact_bwd", "apply_rows", "gather_rows",
           "build_delta_rows", "row_major")
