"""Host arrays of the narrow float types, without ``ml_dtypes``.

The JAX package keeps bf16 tables (narrow storage) and fp8 serve images
as numpy arrays of ``ml_dtypes``' types, which numpy itself does not
know: ``np.save`` writes a bf16 array with the descr ``'<V2'`` and
``np.load`` returns it as a 2-byte void array. The port imports no
``ml_dtypes``, so it moves these arrays as raw bytes:

- :func:`tensor_of`: a numpy leaf (an ``ml_dtypes.bfloat16`` or
  ``float8_e4m3fn`` array, recognised by its dtype name, or the 2-byte
  void array ``np.load`` returns for a bf16 block) -> a torch tensor of
  the same bits (``torch.bfloat16`` / ``torch.float8_e4m3fn``); any other
  array -> ``torch.tensor`` of it;
- :func:`numpy_of`: a tensor -> numpy on the host; bf16 comes back as
  ``uint16`` bits (``.view(ml_dtypes.bfloat16)`` on the JAX side);
- :func:`save_npy` / :func:`savez`: ``np.save`` / ``np.savez`` that
  write a bf16 tensor's bits under the JAX package's ``'<V2'`` descr, so
  the files are byte-for-byte the JAX package's.
"""

from __future__ import annotations

import zipfile
from typing import Dict, Union

import numpy as np
import torch

# the npy descr numpy writes for an ml_dtypes.bfloat16 array
BF16_DESCR = "<V2"

Leaf = Union[torch.Tensor, np.ndarray]


def is_bf16_array(arr: np.ndarray) -> bool:
  """An ``ml_dtypes.bfloat16`` array, or the 2-byte void array that
  ``np.load`` makes of one."""
  dt = arr.dtype
  return dt.name == "bfloat16" or (dt.kind == "V" and dt.itemsize == 2
                                   and dt.names is None)


def tensor_of(x) -> torch.Tensor:
  """A numpy leaf (or anything ``np.asarray`` takes) as a new torch
  tensor of the same bits."""
  arr = np.asarray(x)
  if is_bf16_array(arr):
    return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
  if arr.dtype.name == "float8_e4m3fn":
    return torch.from_numpy(arr.view(np.uint8).copy()).view(
        torch.float8_e4m3fn)
  return torch.tensor(arr)


def numpy_of(t: Leaf) -> np.ndarray:
  """A tensor (any device) or array as a host numpy array; bf16 tensors
  as their ``uint16`` bits."""
  if not isinstance(t, torch.Tensor):
    return np.asarray(t)
  t = t.detach().cpu()
  if t.dtype == torch.bfloat16:
    return t.view(torch.int16).numpy().view(np.uint16)
  return t.numpy()


def _header(arr: np.ndarray, descr: str) -> dict:
  return {"descr": descr, "fortran_order": False,
          "shape": tuple(int(s) for s in arr.shape)}


def write_npy(f, t: Leaf) -> None:
  """One array in npy form to the open binary file ``f``: numpy's own
  writer, except that a bf16 tensor is written as its bits under the
  ``'<V2'`` descr."""
  if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
    bits = numpy_of(t)
    np.lib.format.write_array_header_1_0(
        f, _header(bits, BF16_DESCR))
    f.write(np.ascontiguousarray(bits).tobytes())
    return
  np.lib.format.write_array(f, numpy_of(t), allow_pickle=False)


def save_npy(path: str, t: Leaf) -> None:
  """``np.save(path, t)`` with bf16 tensors in the JAX package's form."""
  with open(path, "wb") as f:
    write_npy(f, t)


def savez(path: str, arrays: Dict[str, Leaf]) -> None:
  """``np.savez(path, **arrays)`` (stored, zip64 entries, as numpy
  writes them) with bf16 tensors in the JAX package's form."""
  with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                       allowZip64=True) as z:
    for key, val in arrays.items():
      with z.open(key + ".npy", "w", force_zip64=True) as f:
        write_npy(f, val)
