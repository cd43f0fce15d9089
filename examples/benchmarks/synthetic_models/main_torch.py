"""Synthetic model zoo step-time benchmark, with the PyTorch port.

The twin of ``examples/benchmarks/synthetic_models/main.py`` for
``distributed_embeddings_torch``, with the same flags and output lines:
it trains one synthetic config (tiny ... colossal) with Adagrad
(``training.Adagrad``, optax's rule) on power-law inputs through the
dense-autodiff step (``SyntheticModel`` owns its ``DistributedEmbedding``;
``training.make_train_step``) and reports the mean step time. It runs on
the card unless ``--device cpu``; ``main.py``'s ``--platform`` (a JAX
backend) is ``--device`` here.

  python examples/benchmarks/synthetic_models/main_torch.py --model tiny \
      --batch_size 65536 [--device cpu] [--shrink 0.01]
  torchrun --nproc_per_node=4 \
      examples/benchmarks/synthetic_models/main_torch.py --model tiny

World 1 is the plain ``python`` command; world N is one process per rank
under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` come from its environment), NCCL when every rank has a
card of its own, else gloo. ``--batch_size`` is the global batch: every
rank draws it and keeps its slice. Rank 0 prints. The step time is the
host clock over ``--steps`` steps after ``--warmup_steps``, each end
taken after ``torch.cuda.synchronize()``.
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))

import numpy as np
import torch

from distributed_embeddings_torch.convert import synthetic_state_dict_from_flax
from distributed_embeddings_torch.device import resolve_device
from distributed_embeddings_torch.layers import broadcast_variables
from distributed_embeddings_torch.models import (
    SYNTHETIC_MODELS,
    SyntheticModel,
    bce_loss,
    expand_tables,
    generate_batch,
    model_size_gib,
)
from distributed_embeddings_torch.parallel.mesh import create_mesh
from distributed_embeddings_torch.training import (
    Adagrad,
    make_train_step,
    shard_batch,
)


def parse_args(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--model", default="tiny",
                 choices=["criteo", "tiny", "small", "medium", "large",
                          "jumbo", "colossal"])
  p.add_argument("--batch_size", type=int, default=65536)
  p.add_argument("--steps", type=int, default=20)
  p.add_argument("--warmup_steps", type=int, default=3)
  p.add_argument("--alpha", type=float, default=1.05,
                 help="power-law exponent for ids (0 = uniform)")
  p.add_argument("--lr", type=float, default=0.01)
  p.add_argument("--strategy", default="memory_balanced")
  p.add_argument("--column_slice_threshold", type=int, default=None)
  p.add_argument("--world_size", type=int, default=None,
                 help="number of ranks; default = WORLD_SIZE (torchrun) or 1")
  p.add_argument("--num_batches", type=int, default=4,
                 help="distinct input batches to rotate through")
  p.add_argument("--shrink", type=float, default=1.0,
                 help="scale table rows (to fit small test machines)")
  p.add_argument("--amp", action="store_true", help="bf16 compute")
  p.add_argument("--device", default="cuda",
                 help="'cuda' (default) or 'cpu'")
  return p.parse_args(argv)


def shrunk_config(name: str, shrink: float):
  """Zoo config ``name`` with every table's rows scaled by ``shrink`` (at
  least 4 rows each), as ``main.py`` scales them."""
  cfg = SYNTHETIC_MODELS[name]
  if shrink != 1.0:
    groups = tuple(
        dataclasses.replace(g, num_rows=max(4, int(g.num_rows * shrink)))
        for g in cfg.embedding_groups)
    cfg = dataclasses.replace(cfg, embedding_groups=groups)
  return cfg


def host_batches(cfg, args):
  """``--num_batches`` global batches as numpy: ``generate_batch(seed=i)``
  with the ids clamped to the (shrunken) tables, every input ``[B, h]``
  as ``main.py`` feeds them."""
  tables, tmap, _ = expand_tables(cfg)
  out = []
  for i in range(args.num_batches):
    numerical, cats, labels = generate_batch(cfg, args.batch_size,
                                             alpha=args.alpha, seed=i)
    cats = [np.minimum(c, tables[t].input_dim - 1).astype(np.int32)
            for c, t in zip(cats, tmap)]
    out.append((numerical, cats, labels))
  return out


def main(argv=None, init=None):
  """Run the benchmark; returns ``{'step_ms', 'samples_per_s', 'losses',
  'world'}`` (``losses``: every step's, warm-up included). ``init``: a
  flax ``SyntheticModel`` param tree (numpy leaves, global class buffers)
  to start from instead of the seeded draw, e.g. ``main.py``'s
  ``model.init(PRNGKey(0), ...)``."""
  args = parse_args(argv)
  world = args.world_size or int(os.environ.get("WORLD_SIZE", "1"))
  if world > 1 and int(os.environ.get("WORLD_SIZE", "1")) != world:
    raise SystemExit(f"--world_size {world}: launch one process per rank "
                     f"(torchrun --nproc_per_node={world})")
  mesh = create_mesh(world, device=args.device) if world > 1 else None
  rank = 0 if mesh is None else mesh.rank
  dev = resolve_device(args.device) if mesh is None else mesh.device

  def say(*a, **kw):
    if rank == 0:
      print(*a, **kw)

  def sync():
    if dev.type == "cuda":
      torch.cuda.synchronize(dev)

  try:
    cfg = shrunk_config(args.model, args.shrink)
    tables, tmap, _ = expand_tables(cfg)
    say(f"model={cfg.name} tables={len(tables)} inputs={len(tmap)} "
        f"size={model_size_gib(cfg):.1f} GiB world={world} "
        f"batch={args.batch_size} "
        f"platform={'gpu' if dev.type == 'cuda' else dev.type}")
    model = SyntheticModel(
        cfg, world_size=world, strategy=args.strategy,
        column_slice_threshold=args.column_slice_threshold,
        # the planner's scatter-regime cost model needs the expected batch
        batch_hint=args.batch_size,
        compute_dtype=torch.bfloat16 if args.amp else torch.float32,
        mesh=mesh, device=dev, generator=torch.Generator().manual_seed(0),
        table_generator=torch.Generator(device=dev).manual_seed(1 + rank))
    if init is not None:
      model.load_state_dict(synthetic_state_dict_from_flax(init, mesh=mesh))
    # every rank drew its own shards; the replicated MLP is rank 0's
    broadcast_variables(model, 0, mesh)
    optimizer = Adagrad(model.parameters(), lr=args.lr)

    def loss_fn(model, numerical, cats, labels):
      return bce_loss(model(numerical, cats), labels)

    step = make_train_step(loss_fn, optimizer, model, mesh=mesh, device=dev)
    sharded = [shard_batch(b, mesh, dev) for b in host_batches(cfg, args)]

    losses = []
    for i in range(args.warmup_steps):
      losses.append(step(*sharded[i % len(sharded)]))
    sync()
    t0 = time.perf_counter()
    for i in range(args.steps):
      losses.append(step(*sharded[i % len(sharded)]))
    sync()
    ms = (time.perf_counter() - t0) / max(args.steps, 1) * 1000
    losses = [float(v) for v in losses]
    say(f"step time: {ms:.3f} ms  "
        f"({args.batch_size / ms * 1000:,.0f} samples/sec)  "
        f"loss {losses[-1]:.5f}")
    return {"step_ms": ms, "samples_per_s": args.batch_size / ms * 1000,
            "losses": losses, "world": world}
  finally:
    if mesh is not None:
      mesh.close()


if __name__ == "__main__":
  main()
