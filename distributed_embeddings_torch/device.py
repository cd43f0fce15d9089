"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``: the port is
written for the GPU, and the CPU is used only when a caller asks for it
(the CPU tests do). Asking for CUDA on a machine without it raises here,
so nothing ever runs on the CPU without the caller having said so.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
  """``str | torch.device`` -> ``torch.device``; raises when CUDA is asked
  for and not available."""
  dev = torch.device(device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        f"device {str(dev)!r} requested but CUDA is not available; pass "
        "device='cpu' to run on the CPU explicitly")
  return dev
