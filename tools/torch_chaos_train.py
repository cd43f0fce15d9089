"""Chaos training run of the PyTorch port: injected faults, must
skip/resume/converge.

The port's twin of ``tools/chaos_train.py``, at world 1: one short DLRM
training run through ``resilience.trainer.ResilientTrainer`` over the
guarded fused step is hit with — in one process, deterministically —

1. **NaN batches** every ``nan_every`` steps (an upstream
   feature-pipeline failure): the guarded step must skip each one
   bit-exactly and count it;
2. **a transient checkpoint-write error**: the durable save must retry
   and still publish a valid checkpoint;
3. **a crash mid-checkpoint-save** (preemption): the run dies with a
   manifest-less ``.tmp``; a fresh trainer must auto-resume from the
   last durable checkpoint;
4. after the resume, the completed run's loss trajectory must equal an
   uninterrupted reference run's over the same stream (bit for bit on
   the CPU; on the card within 1e-5 of each loss, the sparse apply adding
   duplicate rows with atomics in the card's order), the skipped-step
   count must match the injected NaN count, and the loss must have
   fallen (the run learns despite the chaos).

Run it from the repository root::

    python tools/torch_chaos_train.py                 # on the card
    python tools/torch_chaos_train.py --device cpu

It prints the verdict as one JSON line and exits 0 when it holds, 1
otherwise. ``run_chaos`` takes its model, data and initial state from a
``setup`` dict, so a caller may run the story on another configuration.
"""

import argparse
import functools
import json
import math
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from distributed_embeddings_torch.device import resolve_device  # noqa: E402
from distributed_embeddings_torch.layers.embedding import (  # noqa: E402
    TableConfig,
)
from distributed_embeddings_torch.layers.planner import (  # noqa: E402
    DistEmbeddingStrategy,
)
from distributed_embeddings_torch.models import DLRM, bce_loss  # noqa: E402
from distributed_embeddings_torch.ops.packed_table import (  # noqa: E402
    sparse_rule,
)
from distributed_embeddings_torch.resilience import (  # noqa: E402
    FaultInjector,
    InjectedCrash,
    durable,
    faultinject,
)
from distributed_embeddings_torch.resilience.trainer import (  # noqa: E402
    ResilientTrainer,
)
from distributed_embeddings_torch.telemetry import (  # noqa: E402
    MetricsRegistry,
)
from distributed_embeddings_torch.training import (  # noqa: E402
    Adagrad,
    init_sparse_state_direct,
    make_sparse_train_step,
    shard_batch,
)

VOCAB = [500, 300, 150, 20]
DIM = 16
NUM = 13
BATCH = 32
LR = 0.05
THRESHOLD = 32  # the 20-row table rides a dense class


def chaos_plan():
  return DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=DIM) for v in VOCAB], 1, "basic",
      dense_row_threshold=THRESHOLD)


def chaos_model(device):
  return DLRM(VOCAB, DIM, bottom_mlp=(32, DIM), top_mlp=(32, 1),
              num_numerical=NUM, tables=False, device=device,
              generator=torch.Generator().manual_seed(0))


def chaos_batches(n, seed=7, n_unique=6):
  """A cycled set of ``n_unique`` labeled batches: repetition makes the
  loss drop reliably within a short chaos run (the check is "training
  still learns through the chaos", not generalization)."""
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(n_unique):
    numerical = rng.standard_normal((BATCH, NUM)).astype(np.float32)
    cats = [rng.integers(0, v, BATCH).astype(np.int32) for v in VOCAB]
    labels = (numerical[:, 0] > 0).astype(np.float32)
    out.append((numerical, cats, labels))
  return [out[i % n_unique] for i in range(n)]


def _traj_equal(a, b, rtol=0.0):
  """Loss trajectories equal (within ``rtol`` of each loss); skipped
  steps' NaN losses compare equal to each other."""
  return len(a) == len(b) and all(
      (math.isnan(x) and math.isnan(y)) or
      abs(x - y) <= rtol * max(1.0, abs(y)) for x, y in zip(a, b))


def chaos_setup(device, steps: int) -> dict:
  """The run this tool trains by default: a small DLRM (four tables of
  width 16, one a dense class), Adagrad 0.05 on the tables and the dense
  tensors, ``steps`` cycled batches of 32, the state drawn from fixed
  seeds on ``device``."""
  plan = chaos_plan()
  rule = sparse_rule("adagrad", LR)
  opt = functools.partial(Adagrad, lr=LR)

  def fresh_state():
    return init_sparse_state_direct(
        plan, rule, chaos_model(device).state_dict(), opt,
        torch.Generator(device=device).manual_seed(1), device=device)

  return {"plan": plan, "rule": rule, "opt": opt,
          "model": chaos_model(device), "batches": chaos_batches(steps),
          "fresh_state": fresh_state}


def run_chaos(steps: int = 24, nan_every: int = 7, snapshot_every: int = 4,
              crash_at_write_event=None, device="cuda", setup=None,
              verbose: bool = False) -> dict:
  """Run the chaos scenario; returns a result dict with ``ok``.

  ``setup`` (default :func:`chaos_setup`) holds the ``plan``, ``rule``,
  dense optimizer factory ``opt``, ``model``, the host ``batches`` (at
  least ``steps``) and ``fresh_state()``, the initial state: every
  trainer starts from its own fresh state, as a restarted process would.
  ``crash_at_write_event`` (default: the third file of the third save) is
  the ``ckpt_write`` event the crash fires at."""
  dev = resolve_device(device)
  setup = setup or chaos_setup(dev, steps)
  plan, rule, opt, model = (setup[k] for k in ("plan", "rule", "opt",
                                               "model"))
  batches = setup["batches"][:steps]
  nan_steps = set(range(nan_every - 1, steps, nan_every))
  stream = list(faultinject.nan_batches(batches, at_steps=nan_steps))

  fresh_state = setup["fresh_state"]
  step = make_sparse_train_step(model, plan, bce_loss, opt, rule,
                                guard=True)
  if crash_at_write_event is None:
    # one file per sparse class and four npz parts per save; the first
    # event is the transient fault, retried
    n_sparse = sum(cp.kind == "sparse" for cp in plan.classes.values())
    crash_at_write_event = 1 + 2 * (n_sparse + 4) + 2
  root_ref = tempfile.mkdtemp(prefix="torch_chaos_ref_")
  root = tempfile.mkdtemp(prefix="torch_chaos_")
  try:
    # ---- uninterrupted reference -----------------------------------------
    ref = ResilientTrainer(step, fresh_state(), plan, rule, root_ref,
                           snapshot_every=snapshot_every,
                           telemetry=MetricsRegistry())
    losses_ref = ref.run(stream)

    # ---- chaos run: transient write fault + crash mid-save ---------------
    inj = (FaultInjector()
           .fail_first("ckpt_write", 1)            # retried by save_rotating
           .crash_after("ckpt_write", crash_at_write_event))
    t = ResilientTrainer(step, fresh_state(), plan, rule, root,
                         snapshot_every=snapshot_every,
                         telemetry=MetricsRegistry())
    losses = []
    crashed = False
    calls = 0
    try:
      with faultinject.injected(inj):
        for batch in stream:
          calls += 1  # the step that crashes in its snapshot ran too
          losses.append(t.step(*shard_batch(batch, device=dev)))
    except InjectedCrash:
      crashed = True
    committed_at_crash = t.step_count
    torn = sorted(d for d in os.listdir(root) if d.endswith(".tmp"))

    # ---- restart: a fresh trainer, auto-resume ---------------------------
    t2 = ResilientTrainer(step, fresh_state(), plan, rule, root,
                          snapshot_every=snapshot_every,
                          telemetry=MetricsRegistry())
    resumed_at = t2.consumed  # the checkpointed STREAM position
    losses_resumed = t2.run(stream[resumed_at:]) if crashed else []
    trajectory = losses[:resumed_at] + losses_resumed

    finite_ref = [x for x in losses_ref if math.isfinite(x)]
    k = max(1, len(finite_ref) // 4)
    loss_head = float(np.mean(finite_ref[:k]))
    loss_tail = float(np.mean(finite_ref[-k:]))
    diffs = [abs(x - y) for x, y in zip(trajectory, losses_ref)
             if math.isfinite(x) and math.isfinite(y)]
    on_card = dev.type == "cuda"
    result = {
        "device": str(dev),
        "steps": steps,
        "crashed": crashed,
        "crash_at_write_event": crash_at_write_event,
        "torn_tmp_dirs": torn,
        "committed_at_crash": committed_at_crash,
        "resumed_at_batch": resumed_at,
        "resumed_from": os.path.basename(t2.resumed_from or ""),
        # the resumed trainer adopts the checkpoint's persisted skip count
        # and re-skips the replayed poison, so its total covers the whole
        # logical run — every injected NaN batch, counted exactly once
        "skipped_total": t2.skipped_steps,
        "expected_skips": len(nan_steps),
        "final_step": t2.step_count if crashed else t.step_count,
        "trajectory_bit_exact": _traj_equal(trajectory, losses_ref),
        "trajectory_max_abs_diff": max(diffs) if diffs else 0.0,
        "loss_head_mean": loss_head,
        "loss_tail_mean": loss_tail,
        "checkpoints": [s for s, _ in durable.list_checkpoints(root)],
        "metrics_summary": {**t2.metrics_summary(),
                            "resumed_from": os.path.basename(
                                t2.resumed_from or "")},
        "reference_summary": {**ref.metrics_summary(),
                              "resumed_from": None},
        # injection CONFIG: the first ckpt write raises a TransientIOError
        # that save_rotating must retry through
        "ckpt_write_faults_injected": 1,
        "trajectory_tolerance": ("within 1e-5 of each loss (the card's "
                                 "atomics)" if on_card else "bit-equal"),
        # guarded step calls over the three runs (each launches the step's
        # kernels, skipped or not)
        "step_calls": len(losses_ref) + calls + len(losses_resumed),
        "losses_reference": losses_ref,
        "losses_resumed_run": trajectory,
    }
    expected_committed = steps - len(nan_steps)
    result["ok"] = bool(
        crashed and bool(torn)
        and _traj_equal(trajectory, losses_ref, 1e-5 if on_card else 0.0)
        and t2.skipped_steps == result["expected_skips"]
        and result["final_step"] == expected_committed
        and loss_tail < loss_head)
    result["_states"] = (ref.state, t2.state)
    if verbose:
      print(json.dumps({k: v for k, v in result.items()
                        if not k.startswith("_")}, indent=1))
    return result
  finally:
    shutil.rmtree(root_ref, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
  p.add_argument("--steps", type=int, default=24)
  p.add_argument("--nan_every", type=int, default=7)
  p.add_argument("--snapshot_every", type=int, default=4)
  args = p.parse_args(argv)
  res = run_chaos(args.steps, args.nan_every, args.snapshot_every,
                  device=args.device)
  print(json.dumps({"chaos": "torch", **{k: v for k, v in res.items()
                                         if not k.startswith("_")}}))
  return 0 if res["ok"] else 1


if __name__ == "__main__":
  sys.exit(main())
