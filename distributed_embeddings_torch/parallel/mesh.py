"""Process-group setup for hybrid-parallel training (PyTorch port of
``parallel/mesh.py``).

The JAX package runs its world-N step as one program over a 1-D device
mesh. The port runs one process per rank over ``torch.distributed``: the
same rank is a data-parallel worker (its slice of the batch, replicated
dense parameters) and a model-parallel worker (its shard of every
embedding class). :class:`Mesh` carries what the lookup engine and the
train step need of that: the process group, this process's rank, the
world size and the rank's device.

The backend follows the topology and nothing else:

- **NCCL** when every rank owns a card (``torch.cuda.device_count() >=
  world``): rank ``r`` runs on ``cuda:r``;
- **gloo** on the CPU (the tests), or when the ranks share the cards
  (rank ``r`` on ``cuda:r % count``): NCCL refuses two ranks on one
  device, and gloo stages CUDA tensors through the host.

A backend that fails to start raises; there is no second choice.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
  """One rank's view of a 1-D hybrid-parallel process group."""

  rank: int
  world: int
  device: torch.device
  backend: str

  def close(self) -> None:
    """Tear the default process group down (the end of a run)."""
    if dist.is_initialized():
      dist.destroy_process_group()


def choose_backend(device, world: int) -> str:
  """``'nccl'`` when the ranks each own a CUDA card, else ``'gloo'``."""
  dev = torch.device(device)
  if dev.type == "cpu":
    return "gloo"
  if dev.type != "cuda":
    raise ValueError(f"no process-group backend for device {dev}")
  return "nccl" if torch.cuda.device_count() >= world else "gloo"


def rank_device(device, rank: int, world: int) -> torch.device:
  """The device rank ``rank`` runs on: ``cuda:rank`` when the ranks own
  their cards, ``cuda:rank % count`` when they share them, the CPU as
  asked."""
  dev = torch.device(device)
  if dev.type != "cuda":
    return dev
  count = torch.cuda.device_count()
  return torch.device("cuda", rank if count >= world else rank % count)


def create_mesh(world_size: Optional[int] = None, rank: Optional[int] = None,
                init_method: Optional[str] = None, device="cuda") -> Mesh:
  """Start the default process group and return this rank's :class:`Mesh`.

  ``world_size`` and ``rank`` default to the ``WORLD_SIZE`` and ``RANK``
  environment variables, ``init_method`` to ``env://`` (``MASTER_ADDR``,
  ``MASTER_PORT``); pass ``tcp://localhost:<port>`` to give the address
  yourself. ``device`` is ``"cuda"`` unless the caller asks for the CPU."""
  base = resolve_device(device)
  world = int(world_size if world_size is not None
              else os.environ["WORLD_SIZE"])
  me = int(rank if rank is not None else os.environ["RANK"])
  backend = choose_backend(base, world)
  dev = rank_device(base, me, world)
  if dev.type == "cuda":
    torch.cuda.set_device(dev)
  dist.init_process_group(backend, init_method=init_method or "env://",
                          world_size=world, rank=me)
  return Mesh(rank=me, world=world, device=dev, backend=backend)
