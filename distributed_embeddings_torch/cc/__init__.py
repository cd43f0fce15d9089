"""The port's native (C++) host code: the Criteo data loader.

``data_loader.cc`` (the port's copy of the JAX package's loader) is
compiled at first use with the host C++ compiler (``c++ -O3 -shared
-fPIC -pthread``) into ``build/torch_native/`` at the repository root,
beside the CUDA kernels of ``ops/_build.py``; the library's file name
carries a hash of its source, so an edited source is never served a
stale build. :func:`load_data_loader` returns the ctypes library and
raises, with the compiler's output, when the build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "data_loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
  lib.de_loader_open.restype = ctypes.c_void_p
  lib.de_loader_open.argtypes = [
      ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
      ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
      ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
      ctypes.c_int, ctypes.c_int, ctypes.c_int,
  ]
  lib.de_loader_error.restype = ctypes.c_char_p
  lib.de_loader_error.argtypes = [ctypes.c_void_p]
  lib.de_loader_num_samples.restype = ctypes.c_int64
  lib.de_loader_num_samples.argtypes = [ctypes.c_void_p]
  lib.de_loader_num_batches.restype = ctypes.c_int64
  lib.de_loader_num_batches.argtypes = [ctypes.c_void_p]
  lib.de_loader_start.restype = None
  lib.de_loader_start.argtypes = [ctypes.c_void_p]
  lib.de_loader_next.restype = ctypes.c_int64
  lib.de_loader_next.argtypes = [
      ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
      ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
  ]
  lib.de_loader_close.restype = None
  lib.de_loader_close.argtypes = [ctypes.c_void_p]
  return lib


def library_path() -> Path:
  digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
  return BUILD_DIR / f"libdata_loader_{digest}.so"


def build() -> Path:
  """Compile the loader (once per source); returns the library's path.
  Raises ``RuntimeError`` with the compiler's output on failure."""
  out = library_path()
  if out.exists():
    return out
  cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
  if cxx is None:
    raise RuntimeError("no host C++ compiler (c++ or g++ on PATH, or CXX) "
                       "to build the native data loader")
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
  try:
    r = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       capture_output=True, text=True, timeout=300)
  except subprocess.SubprocessError as e:
    raise RuntimeError(f"native data loader build failed: {e}") from e
  if r.returncode != 0:
    raise RuntimeError(f"native data loader build failed ({cxx} exit "
                       f"{r.returncode}):\n{r.stdout}{r.stderr}")
  os.replace(tmp, out)
  return out


def load_data_loader() -> ctypes.CDLL:
  """The ctypes handle to the native loader, built on first use."""
  global _lib
  with _lock:
    if _lib is None:
      _lib = _configure(ctypes.CDLL(str(build())))
    return _lib
