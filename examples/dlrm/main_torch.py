"""DLRM training on Criteo (or dummy data), with the PyTorch port.

The twin of ``examples/dlrm/main.py`` for ``distributed_embeddings_torch``,
with the same flags and defaults: the dense-autodiff path (the default)
and the fused sparse path (``--sparse``: packed tables with row-sparse
SGD, the scheduled dense SGD, full-state checkpoints with
``--checkpoint_dir`` / ``--checkpoint_every`` and auto-resume), hybrid
model/data-parallel embeddings at any world size, warmup + poly-decay
SGD, the AUC eval and a final global-view numpy checkpoint of the tables.
It reads the split-binary Criteo dataset (``--dataset criteo
--dataset_path DIR``) or draws dummy batches. It runs on the card unless
``--device cpu``.

Usage:
  python examples/dlrm/main_torch.py --dataset dummy --steps 100 --batch_size 4096
  python examples/dlrm/main_torch.py --dataset dummy --sparse --checkpoint_dir /tmp/ckpt --checkpoint_every 1000
  python examples/dlrm/main_torch.py --dataset dummy --sparse --micro_batches 4
  python examples/dlrm/main_torch.py --dataset criteo --dataset_path /data/criteo --sparse
  torchrun --nproc_per_node=4 examples/dlrm/main_torch.py --dataset dummy --sparse

World 1 is the plain ``python`` command; world N is one process per rank
under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` come from its environment), NCCL when every rank has a
card of its own, else gloo. ``--batch_size`` is the global batch: with
dummy data every rank draws it and keeps its slice; with ``--dataset
criteo`` every rank reads its own slice of ``--batch_size /
world`` samples (so a step sees ``--batch_size`` samples; ``main.py``
reads rank 0's slice on every rank, ROADMAP.md §3). Rank 0 prints.

With ``--checkpoint_dir`` an existing directory is restored first
(``resumed from <dir> at step <n>``); the data restarts at batch 0 and the
run takes ``--steps`` more steps, as in ``main.py``. A save lands every
``--checkpoint_every`` steps and at the end.

``--micro_batches N`` runs the sparse step over N slices of each rank's
batch with one apply per step (the dense path reads no such flag, as in
``main.py``). ``main.py``'s ``--platform`` (a JAX backend) is
``--device`` here.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from distributed_embeddings_torch import checkpoint as ckpt
from distributed_embeddings_torch.device import resolve_device
from distributed_embeddings_torch.layers import broadcast_variables, get_weights
from distributed_embeddings_torch.models import (
    DLRM,
    bce_loss,
    dlrm_embedding_plan,
)
from distributed_embeddings_torch.ops.packed_table import sgd_rule
from distributed_embeddings_torch.parallel import wire
from distributed_embeddings_torch.parallel.mesh import create_mesh
from distributed_embeddings_torch.training import (
    ScheduledSGD,
    init_sparse_state_direct,
    make_eval_step,
    make_sparse_eval_step,
    make_sparse_train_step,
    make_train_step,
    shard_batch,
    unpack_sparse_state,
)
from distributed_embeddings_torch.utils import (
    DummyDataset,
    RawBinaryCriteoDataset,
    dlrm_lr_schedule,
)

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
                 help="fused sparse training path (packed tables, "
                      "row-sparse SGD; the bench.py path)")
  p.add_argument("--micro_batches", type=int, default=1,
                 help="sparse path: route, gather and backward over N "
                      "slices of each rank's batch, one apply per step "
                      "(bounded-memory accumulation)")
  p.add_argument("--checkpoint_dir", default=None,
                 help="full train-state checkpoint dir (sparse path only); "
                      "auto-resumes when it exists")
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
  """A Criteo run without its data. (As in ``main.py``,
  ``--checkpoint_dir`` and ``--micro_batches`` are read by the sparse
  path only.)"""
  if args.dataset == "criteo" and not args.dataset_path:
    raise SystemExit("--dataset criteo reads --dataset_path")


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


def make_datasets(args, vocab, rank: int, world: int):
  """``(train, eval)`` datasets. Dummy data: the global batch of
  ``--batch_size`` on every rank (``shard_batch`` keeps the rank's
  slice). Criteo: this rank's slice of each global batch, ``--batch_size
  / world`` samples."""
  if args.dataset == "dummy":
    return (DummyDataset(args.batch_size, 13, vocab, num_batches=args.steps),
            DummyDataset(args.batch_size, 13, vocab, num_batches=4,
                         seed=777))
  if args.batch_size % world:
    raise SystemExit(f"--batch_size {args.batch_size} is not divisible by "
                     f"the world size {world}")
  kw = dict(numerical_features=13,
            categorical_features=list(range(len(vocab))),
            categorical_feature_sizes=vocab, rank=rank, world_size=world)
  return (RawBinaryCriteoDataset(args.dataset_path, args.batch_size // world,
                                 **kw),
          RawBinaryCriteoDataset(args.dataset_path, args.batch_size // world,
                                 valid=True, **kw))


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
    train_data, eval_data = make_datasets(args, vocab, rank, world)
    schedule = dlrm_lr_schedule(args.lr, args.warmup_steps,
                                args.decay_start_step, args.decay_steps)

    def on_card(batch):
      """This rank's part of a batch, on its device: a dummy batch is
      global (``shard_batch`` cuts the rank's slice), a Criteo batch is
      already the rank's own."""
      return shard_batch(batch, mesh if args.dataset == "dummy" else None,
                         dev)

    def eval_labels(labels):
      """The eval batch's global labels, in the predictions' order."""
      if args.dataset == "dummy" or mesh is None:
        return labels
      return wire.gather_blocks(torch.as_tensor(labels).to(dev),
                                mesh).cpu().numpy()

    model = DLRM(vocab, args.embedding_dim, world_size=world,
                 strategy=args.strategy,
                 column_slice_threshold=args.column_slice_threshold,
                 row_slice=args.row_slice, batch_hint=args.batch_size,
                 compute_dtype=torch.bfloat16 if args.amp else torch.float32,
                 mesh=mesh, device=dev, tables=not args.sparse,
                 generator=torch.Generator().manual_seed(0),
                 table_generator=torch.Generator(device=dev)
                 .manual_seed(1 + rank))
    if args.sparse:
      # fused sparse path: packed tables with row-sparse SGD and the
      # scheduled dense SGD, full-state checkpoint and resume
      plan = dlrm_embedding_plan(vocab, args.embedding_dim, world,
                                 args.strategy, args.column_slice_threshold,
                                 row_slice=args.row_slice,
                                 batch_hint=args.batch_size)
      rule = sgd_rule(schedule)

      def dense_opt(params):
        return ScheduledSGD(params, schedule)

      # every rank draws its own blocks; the dense params are the same
      # on every rank (one seeded generator)
      state = init_sparse_state_direct(
          plan, rule, model.state_dict(), dense_opt,
          torch.Generator(device=dev).manual_seed(1 + rank), device=dev,
          mesh=mesh)
      if args.checkpoint_dir and os.path.isdir(args.checkpoint_dir):
        state = ckpt.restore(args.checkpoint_dir, plan, rule, state,
                             mesh=mesh, device=dev)
        say(f"resumed from {args.checkpoint_dir} at step {state['step']}")
      sparse_step = make_sparse_train_step(model, plan, bce_loss, dense_opt,
                                           rule, mesh=mesh,
                                           micro_batches=args.micro_batches)
      carry = {"state": state}

      def step(numerical, cats, labels):
        carry["state"], loss = sparse_step(carry["state"], numerical, cats,
                                           labels)
        return loss

      raw_eval = make_sparse_eval_step(model, plan, rule, mesh=mesh)

      def eval_fn(numerical, cats):
        preds = torch.sigmoid(raw_eval(carry["state"], numerical, cats))
        return preds if mesh is None else wire.gather_blocks(preds, mesh)
    else:
      # every rank drew its own shards; the replicated MLPs are rank 0's
      broadcast_variables(model, 0, mesh)
      plan = model.embeddings.plan
      optimizer = torch.optim.SGD(model.parameters(), lr=float(schedule(0)))

      def loss_fn(model, numerical, cats, labels):
        return bce_loss(model(numerical, cats), labels)

      dense_step = make_train_step(loss_fn, optimizer, model, mesh=mesh,
                                   device=dev)
      steps_taken = [0]

      def step(numerical, cats, labels):
        # optax's schedule reads its count before the step: 0 first
        for group in optimizer.param_groups:
          group["lr"] = float(schedule(steps_taken[0]))
        steps_taken[0] += 1
        return dense_step(numerical, cats, labels)

      def pred_fn(model, numerical, cats):
        return torch.sigmoid(model(numerical, cats))

      eval_fn = make_eval_step(pred_fn, model, mesh)

    def run_eval():
      """AUC over the eval split's global predictions (reference
      main.py:222-243)."""
      all_scores, all_labels = [], []
      for numerical, cats, labels in eval_data:
        scores = eval_fn(*on_card((numerical, cats)))
        all_scores.append(scores.float().cpu().numpy())
        all_labels.append(eval_labels(labels))
      return auc(np.concatenate(all_labels), np.concatenate(all_scores))

    def save_state(done: int, final: bool):
      ckpt.save(args.checkpoint_dir, plan, rule, carry["state"], mesh=mesh)
      say(f"saved full train state -> {args.checkpoint_dir}" if final else
          f"checkpointed step {done} -> {args.checkpoint_dir}")

    t_start, losses = time.time(), []
    t_first = None
    steps_done = 0
    for _ in range(args.epochs):
      for numerical, cats, labels in train_data:
        loss = step(*on_card((numerical, cats, labels)))
        losses.append(loss)
        steps_done += 1
        if steps_done == 1:
          loss.float().cpu()  # the first step's end, on the host clock
          t_first = time.time()
          say(f"first step {t_first - t_start:.3f}s", flush=True)
        if steps_done % 100 == 0:
          losses = losses[-100:]
          window = torch.stack(losses).float().cpu().numpy()
          rate = steps_done * args.batch_size / (time.time() - t_start)
          say(f"step {steps_done} loss {window.mean():.5f} "
              f"{rate:,.0f} samples/sec")
        if args.eval_every and steps_done % args.eval_every == 0:
          score = run_eval()
          say(f"step {steps_done} eval AUC: {score:.5f}")
        if args.sparse and args.checkpoint_dir and args.checkpoint_every \
            and steps_done % args.checkpoint_every == 0:
          save_state(steps_done, final=False)
        if steps_done >= args.steps:
          break
      if steps_done >= args.steps:
        break
    # the steps queue work on the card: wait for the last before the clock
    last = (torch.stack(losses[-10:]).float().cpu().numpy() if losses
            else np.zeros(0))
    t_end = time.time()
    elapsed = t_end - t_start
    say(f"trained {steps_done} steps in {elapsed:.1f}s "
        f"({steps_done * args.batch_size / max(elapsed, 1e-9):,.0f} "
        f"samples/sec) final loss {np.mean(last):.5f}")
    if steps_done > 1:
      say(f"steady steps {steps_done - 1} in {t_end - t_first:.3f}s "
          f"({(steps_done - 1) * args.batch_size / max(t_end - t_first, 1e-9):,.0f}"
          " samples/sec)")

    if args.sparse and args.checkpoint_dir:
      save_state(steps_done, final=True)

    if args.eval:
      say(f"eval AUC: {run_eval():.5f}")

    if args.save_checkpoint:
      # global-view numpy table checkpoint (reference
      # `examples/dlrm/main.py:245-248`): the class blocks gathered to
      # rank 0's host, one block at a time, and rank 0 writes
      if args.sparse:
        params, _ = unpack_sparse_state(plan, rule, carry["state"],
                                        mesh=mesh)
        blocks = {k: v.cpu().numpy() for k, v in params["embeddings"].items()}
      else:
        blocks = {name: ckpt.blocks_on_root(p.detach(), mesh)
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
