"""DLRM training on dummy Criteo-shaped data, with the PyTorch port.

The twin of ``examples/dlrm/main.py`` for ``distributed_embeddings_torch``:
the dense-autodiff path (the default, without ``--sparse``) with the same
flags and defaults, hybrid model/data-parallel embeddings at any world
size, warmup + poly-decay SGD, the AUC eval and a final global-view numpy
checkpoint of the tables. It runs on the card unless ``--device cpu``.

Usage:
  python examples/dlrm/main_torch.py --dataset dummy --steps 100 --batch_size 4096
  torchrun --nproc_per_node=4 examples/dlrm/main_torch.py --dataset dummy

World 1 is the plain ``python`` command; world N is one process per rank
under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` come from its environment), NCCL when every rank has a
card of its own, else gloo. ``--batch_size`` is the global batch: every
rank draws it and keeps its slice. Rank 0 prints.

Not ported yet, and refused by name: ``--sparse`` (the fused sparse path
with its full-state checkpoints) and ``--dataset criteo`` (ROADMAP.md open
items, item 5), ``--micro_batches > 1`` (item 6). ``main.py``'s
``--platform`` (a JAX backend) is ``--device`` here.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch
import torch.distributed as dist

from distributed_embeddings_torch.device import resolve_device
from distributed_embeddings_torch.layers import broadcast_variables, get_weights
from distributed_embeddings_torch.models import DLRM, bce_loss
from distributed_embeddings_torch.parallel.mesh import create_mesh
from distributed_embeddings_torch.training import (
    make_eval_step,
    make_train_step,
    shard_batch,
)
from distributed_embeddings_torch.utils import DummyDataset, dlrm_lr_schedule

CRITEO_1TB_VOCAB = [
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36
]


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("--dataset", choices=["dummy", "criteo"], default="dummy")
  p.add_argument("--eval_every", type=int, default=0,
                 help="run the AUC eval every N train steps (0 = only at "
                      "the end, reference cadence is per-epoch)")
  p.add_argument("--dataset_path", default=None,
                 help="split-binary Criteo dir (model_size.json supported)")
  p.add_argument("--batch_size", type=int, default=8192,
                 help="global batch size")
  p.add_argument("--steps", type=int, default=100)
  p.add_argument("--epochs", type=int, default=1)
  p.add_argument("--lr", type=float, default=24.0)
  p.add_argument("--warmup_steps", type=int, default=2750)
  p.add_argument("--decay_start_step", type=int, default=49315)
  p.add_argument("--decay_steps", type=int, default=27772)
  p.add_argument("--embedding_dim", type=int, default=128)
  p.add_argument("--strategy", default="memory_balanced",
                 choices=["basic", "memory_balanced", "memory_optimized"])
  p.add_argument("--column_slice_threshold", type=int, default=None)
  p.add_argument("--amp", action="store_true", help="bf16 compute")
  p.add_argument("--world_size", type=int, default=None,
                 help="number of ranks; default = WORLD_SIZE (torchrun) or 1")
  p.add_argument("--eval", action="store_true")
  p.add_argument("--save_checkpoint", default=None,
                 help="path for final np.savez global checkpoint")
  p.add_argument("--sparse", action="store_true",
                 help="fused sparse training path (not ported yet)")
  p.add_argument("--micro_batches", type=int, default=1,
                 help="bounded-memory accumulation (not ported yet)")
  p.add_argument("--checkpoint_dir", default=None,
                 help="full train-state checkpoint dir (sparse path only; "
                      "not ported yet)")
  p.add_argument("--checkpoint_every", type=int, default=0,
                 help="save the full state every N steps (0 = end only)")
  p.add_argument("--row_slice", type=int, default=None,
                 help="row (vocab) slice threshold in elements")
  p.add_argument("--vocab_scale", type=float, default=1.0,
                 help="scale Criteo vocab sizes (for memory-limited runs)")
  p.add_argument("--device", default="cuda",
                 help="'cuda' (rank r on its card) or 'cpu'")
  return p.parse_args(argv)


def refuse_unported(args) -> None:
  """The flags of the paths this script does not run yet, each naming
  its ROADMAP item."""
  if args.sparse:
    raise SystemExit(
        "--sparse (the fused sparse path, with --checkpoint_dir / "
        "--checkpoint_every full-state checkpoints) is not ported to this "
        "script yet: ROADMAP.md open items, item 5")
  if args.checkpoint_dir:
    raise SystemExit("--checkpoint_dir (full-state checkpoint and resume "
                     "of the sparse path) is not ported yet: ROADMAP.md "
                     "open items, item 5")
  if args.dataset == "criteo":
    raise SystemExit("--dataset criteo (the split-binary Criteo reader) is "
                     "not ported yet: ROADMAP.md open items, item 5")
  if args.micro_batches != 1:
    raise SystemExit(f"--micro_batches {args.micro_batches} (the "
                     "micro-batch step) is not ported yet: ROADMAP.md open "
                     "items, item 6")


def load_vocab(args):
  if args.dataset_path:
    meta = os.path.join(args.dataset_path, "model_size.json")
    if os.path.exists(meta):
      # reference reads table sizes from the dataset's model_size.json
      # (`examples/dlrm/main.py:68-73`)
      with open(meta) as f:
        sizes = list(json.load(f).values())
      return [s + 1 for s in sizes]
  return [max(4, int(v * args.vocab_scale)) for v in CRITEO_1TB_VOCAB]


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
  """Rank-based AUC (Mann-Whitney), no sklearn dependency."""
  order = np.argsort(scores, kind="mergesort")
  ranks = np.empty_like(order, dtype=np.float64)
  ranks[order] = np.arange(1, len(scores) + 1)
  # average ties
  sorted_scores = scores[order]
  i = 0
  while i < len(sorted_scores):
    j = i
    while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
      j += 1
    if j > i:
      ranks[order[i:j + 1]] = ranks[order[i:j + 1]].mean()
    i = j + 1
  pos = labels > 0.5
  n_pos, n_neg = pos.sum(), (~pos).sum()
  if n_pos == 0 or n_neg == 0:
    return float("nan")
  return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def blocks_on_root(block: torch.Tensor, mesh):
  """Every rank's ``block`` stacked by rank in rank 0's host memory
  (numpy), None on the other ranks; each block crosses the wire alone, so
  no card ever holds more than its own block and one more."""
  if mesh is None:
    return block.cpu().numpy()
  # gloo sends and receives host tensors only
  block = block.cpu() if mesh.backend == "gloo" else block.contiguous()
  if mesh.rank != 0:
    dist.send(block, dst=0)
    return None
  parts = [block.cpu().numpy()]
  buf = torch.empty_like(block)
  for src in range(1, mesh.world):
    dist.recv(buf, src=src)
    parts.append(buf.cpu().numpy())
  return np.concatenate(parts)


def main(argv=None):
  args = parse_args(argv)
  refuse_unported(args)
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

  try:
    vocab = load_vocab(args)
    say(f"device={dev} world={world} tables={len(vocab)} "
        f"total_rows={sum(vocab):,}")
    model = DLRM(vocab, args.embedding_dim, world_size=world,
                 strategy=args.strategy,
                 column_slice_threshold=args.column_slice_threshold,
                 row_slice=args.row_slice, batch_hint=args.batch_size,
                 compute_dtype=torch.bfloat16 if args.amp else torch.float32,
                 mesh=mesh, device=dev,
                 generator=torch.Generator().manual_seed(0),
                 table_generator=torch.Generator(device=dev)
                 .manual_seed(1 + rank))
    # every rank drew its own shards; the replicated MLPs are rank 0's
    broadcast_variables(model, 0, mesh)
    plan = model.embeddings.plan

    train_data = DummyDataset(args.batch_size, 13, vocab,
                              num_batches=args.steps)
    eval_data = DummyDataset(args.batch_size, 13, vocab, num_batches=4,
                             seed=777)
    schedule = dlrm_lr_schedule(args.lr, args.warmup_steps,
                                args.decay_start_step, args.decay_steps)
    optimizer = torch.optim.SGD(model.parameters(), lr=float(schedule(0)))

    def loss_fn(model, numerical, cats, labels):
      return bce_loss(model(numerical, cats), labels)

    step = make_train_step(loss_fn, optimizer, model, mesh=mesh, device=dev)

    def pred_fn(model, numerical, cats):
      return torch.sigmoid(model(numerical, cats))

    eval_fn = make_eval_step(pred_fn, model, mesh)

    def run_eval():
      """AUC over the eval split's global predictions (reference
      main.py:222-243)."""
      all_scores, all_labels = [], []
      for numerical, cats, labels in eval_data:
        scores = eval_fn(*shard_batch((numerical, cats), mesh, dev))
        all_scores.append(scores.float().cpu().numpy())
        all_labels.append(labels)
      return auc(np.concatenate(all_labels), np.concatenate(all_scores))

    t_start, losses = time.time(), []
    steps_done = 0
    for _ in range(args.epochs):
      for numerical, cats, labels in train_data:
        # optax's schedule reads its count before the step: 0 first
        for group in optimizer.param_groups:
          group["lr"] = float(schedule(steps_done))
        loss = step(*shard_batch((numerical, cats, labels), mesh, dev))
        losses.append(loss)
        steps_done += 1
        if steps_done % 100 == 0:
          losses = losses[-100:]
          window = torch.stack(losses).float().cpu().numpy()
          rate = steps_done * args.batch_size / (time.time() - t_start)
          say(f"step {steps_done} loss {window.mean():.5f} "
              f"{rate:,.0f} samples/sec")
        if args.eval_every and steps_done % args.eval_every == 0:
          score = run_eval()
          say(f"step {steps_done} eval AUC: {score:.5f}")
        if steps_done >= args.steps:
          break
      if steps_done >= args.steps:
        break
    # the steps queue work on the card: wait for the last before the clock
    last = (torch.stack(losses[-10:]).float().cpu().numpy() if losses
            else np.zeros(0))
    elapsed = time.time() - t_start
    say(f"trained {steps_done} steps in {elapsed:.1f}s "
        f"({steps_done * args.batch_size / max(elapsed, 1e-9):,.0f} "
        f"samples/sec) final loss {np.mean(last):.5f}")

    if args.eval:
      say(f"eval AUC: {run_eval():.5f}")

    if args.save_checkpoint:
      # global-view numpy table checkpoint (reference
      # `examples/dlrm/main.py:245-248`): the class blocks gathered to
      # rank 0's host, one block at a time, and rank 0 writes
      blocks = {name: blocks_on_root(p.detach(), mesh)
                for name, p in model.embeddings.class_params().items()}
      if rank == 0:
        tables = get_weights(plan, blocks)
        np.savez(args.save_checkpoint, *tables)
        say(f"saved {len(tables)} tables to {args.save_checkpoint}")
  finally:
    if mesh is not None:
      mesh.close()


if __name__ == "__main__":
  main()
