#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``distributed_embeddings_torch``) on one
NVIDIA H100.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``distributed_embeddings_torch/
csrc/`` and drives the port's four paths on the card: DLRM serving on
frozen tables, the world-1 sparse train step of ``bench.py``, the
synthetic zoo's Tiny train step of ``tools/bench_synthetic.py tiny
65536``, and the world-4 hybrid-parallel train step of
``examples/dlrm/main.py --sparse`` under ``overlap='fused'``. One JSON
line per phase:

1. ``device``: the card (``nvidia-smi`` name and power limit), which
   must have compute capability (9, 0);
2. ``build``: every kernel compiled with ``nvcc`` for ``sm_90a``;
3. ``kernel``: each kernel against its plain PyTorch version at the
   main paths' shapes. K2-fwd (``interact_fwd``) and K2-bwd
   (``interact_bwd``) at F=27, D=128, k in {-1, 0}, B in {4096, 65536,
   4000}: at least 99.9% of the cells bit-equal, every cell within one
   bf16 ulp (K2-bwd: or, where its F terms cancel, within the f32
   summation bound ``F * 2^-24 * sum_q |c_pq x_q|``). K1 (``apply_rows``)
   on the buffer of the train plan's first sparse class (4,991,510 x 128
   f32) with 131,072 ids per stream, scale -0.1 (SGD's -lr): uniform,
   power-law and 17% out-of-range streams within 1e-5 of each cell's
   absolute sum (duplicates add in another order), a stream of unique ids
   bit-equal. K4 (``gather_rows``) on the first sparse class's rank
   buffer of the four-card world-4 plan (9,994,943 x 128 f32), one
   (round, chunk) block of 8,192 int32 ids, uniform and with 30% of the
   ids out of range or sentinels: bit-equal; so are fused strides of 96,
   65 and 256 lanes on a small buffer. K6 (``build_delta_rows``, Adagrad
   0.01) at the two buckets of Tiny's largest class: 786,432 one-hot
   samples with 32-lane state rows, and 65,536 ten-hot samples with
   window-masked 128-lane state rows; then momentum, Adam and a width-8
   class on 4,096-sample streams: within rtol 1e-6, atol 2e-7. K7
   (``row_major``) on a transposed and a sliced [12, 65536, 16] f32
   cotangent and a transposed bf16 one: bit-equal. Times are medians of
   CUDA-event timings of single calls, kernel, plain and library in
   turns, with the 50 MB L2 flushed and the card held busy while the
   host queues each call, after two seconds of warm-up;
4. ``golden``: the JAX package's serve golden
   (``tests/data/torch_serve_golden.npz``) replayed through the port's
   ``ServeEngine``: activations bit-equal, predictions within
   ``serving.golden.PRED_TOL``;
5. ``train_golden``: the JAX package's train golden
   (``tests/data/torch_train_golden.npz``, three SGD steps of a small
   bf16 DLRM) replayed through the port's train step: losses within
   ``train_golden.LOSS_TOL``, each final tensor within
   ``train_golden.UPDATE_TOL`` of its largest update. ``zoo_golden``:
   the same for the zoo golden (``tests/data/torch_train_zoo_golden.npz``,
   three Adagrad steps of Tiny with its vocabularies cut to 2,000 rows,
   f32);
6. ``serve``: the full-width DLRM of ``bench.py`` (26 Criteo-1TB tables
   x 1/16, width 128, dense_row_threshold=4096, bf16 compute, one-hot
   ids, world 1), its packed tables drawn on the card by
   ``training.init_sparse_state_direct``, frozen to f32 and to int8; per
   image a ``ServeEngine`` answers 3 requests of batch 4096. The
   predictions are finite, agree with a recomputation through the plain
   interaction, and K2-fwd ran once per request. A fourth request per
   image runs under ``torch.profiler`` (``serve_trace``): the device's
   busy time and idle share, and the costliest device operations;
7. ``train``: ``bench.py``'s train step at full width (the same tables,
   ``batch_hint=65536``: 4 sparse classes and one dense class; SGD 0.1
   on the tables and the dense params; one batch of 65,536 uniform ids
   from seed 0, reused every step as ``bench.py`` does), once with f32
   compute and once with bf16: 3 warm-up and 10 timed steps, each timed
   alone on the host clock up to a synchronize. Every step: the loss is
   finite, K2-fwd and K2-bwd launched once and K1 once per sparse class,
   sampled rows of the first sparse class that the batch does not touch
   are bit-unchanged and sampled touched rows changed. A 14th step runs
   under ``torch.profiler`` (``train_trace``);
8. ``train_zoo``: Tiny at its published widths and full vocabulary (55
   tables, 58 inputs; 8.99 GB of fused buffers in two width-16
   generations and a width-8 class, Adagrad's accumulator interleaved),
   global batch 65,536 of power-law ids (``generate_batch(alpha=1.05,
   seed=i)`` for two batches used in turns), Adagrad 0.01 on the sparse
   classes, ``training.Adagrad`` 0.01 on the dense parameters, f32. First
   one step with ``DE_TORCH_COTANGENT_PIN`` off and one with it on from
   the same state: the losses, K6's update rows and the dense parameters
   bit-equal, the buffers bit-equal on every row fewer than two ids hit;
   K7 launched once per sparse bucket in the pinned step only. Then 3
   warm-up and 10 timed steps as in phase 7, each checked: the loss
   finite, K6 launched once per sparse bucket and K1 once per sparse
   class, sampled logical rows that neither batch touches bit-unchanged
   and most sampled touched ones changed. A further step under
   ``torch.profiler`` (``train_zoo_trace``);
9. ``world4_golden``, ``train_world4``: four ranks spawned with
   ``torch.multiprocessing``, over NCCL when each owns a card, else over
   gloo with the four sharing the card (the backend is printed). Each
   first replays the JAX world-4 golden
   (``tests/data/torch_train_world4_golden.npz``, its bf16 run) within
   the train-golden tolerances, then trains the DLRM of ``examples/dlrm/
   main.py`` at world 4: 26 Criteo-1TB tables of width 128,
   ``memory_balanced``, ``dense_row_threshold=4096``, global batch 65,536
   (16,384 per rank) of one-hot ids from seed 0, SGD 0.1,
   ``overlap='fused'`` with 2 chunks, f32 wire; four cards: the full
   vocabulary, ``row_slice=2**30``; one card: vocabulary x 1/16,
   ``row_slice=2**26``. At f32 and bf16 compute: 3 warm-up and 10 timed
   steps, with the train phase's checks on each rank, K4 launched once
   per (sparse bucket, round, chunk), every rank's losses equal, and a
   traced step on rank 0. Then one f32 step under ``overlap='fused'``
   and one under ``'none'`` from the same state: the losses bit-equal,
   the fused buffers bit-equal on every row fewer than two ids hit
   (elsewhere K1's atomics order the duplicates' adds).

then the ``kernels`` line, the ``nvidia-smi`` line and, last, the
contract line ``{"ok": true, "device": {...}}``. The launch counts of
the ``kernels`` line come from the serve, train, zoo and world-4 phases
alone (each sets the counts to 0 before it and reads them after; the
world-4 counts are summed over the ranks; K7's come from the pinned zoo
step). Any failed check exits non-zero
before the last line; so does a machine without CUDA.

On a machine with four cards the same command runs every phase; phases
1-8 use the first card, and phase 9 runs over NCCL at the full
vocabulary, one rank per card.
"""

import functools
import json
import statistics
import subprocess
import sys
import time

SEED = 0
F, D = 27, 128
KERNEL_BATCHES = (4096, 65536, 4000)
SERVE_BATCH = 4096
SERVE_REQUESTS = 3
TRAIN_BATCH = 65536
# bench.py's 24.0 sends this random-label batch's loss to NaN by the
# fourth step; 0.1 is what MLPerf DLRM's warm-up from 0 to 24 over 2,750
# steps reaches by step 13. The step's work is the same at any rate.
TRAIN_LR = 0.1
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
ROWS_SAMPLED = 4096
K1_IDS = 131072
K1_SCALE = -TRAIN_LR
TIMING_REPS = 50
SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's clocks
# published H100 SXM peaks (NVIDIA data sheet): HBM3 rate, dense bf16,
# f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
CRITEO_1TB_VOCAB = [
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36
]
REPLACES = {
    "interact_fwd": "distributed_embeddings_tpu/ops/pallas_interact.py:139",
    "interact_bwd": "distributed_embeddings_tpu/ops/pallas_interact.py:162",
    "apply_rows": "distributed_embeddings_tpu/ops/pallas_apply.py:211",
    "gather_rows": "distributed_embeddings_tpu/ops/pallas_exchange.py:212",
    "build_delta_rows": "distributed_embeddings_tpu/ops/pallas_delta.py:78",
    "row_major": "distributed_embeddings_tpu/ops/pallas_layout.py:32",
}
# the kernels of the world-4 path (every one must launch there)
W4_KERNELS = ("interact_fwd", "interact_bwd", "apply_rows", "gather_rows")
# the synthetic zoo's train step (tools/bench_synthetic.py tiny 65536):
# Tiny at its full vocabulary, power-law ids, Adagrad 0.01 on the sparse
# classes and the dense parameters, f32
ZOO_MODEL = "tiny"
ZOO_BATCH = 65536
ZOO_ALPHA = 1.05
ZOO_LR = 0.01
ZOO_DENSE_ROW_THRESHOLD = 2048
# K6 against its plain version (the JAX test's tolerance: the rsqrt chains
# round a few ulps apart)
K6_TOL = {"rtol": 1e-6, "atol": 2e-7}
# pin-on vs pin-off steps: cells of rows that two or more of the step's
# ids hit may differ by K1's (and the dense-class index_add_'s) atomic
# order, by at most this share of the cell's magnitude
ZOO_DUP_RTOL = 1e-5
# the world-4 hybrid-parallel step (examples/dlrm/main.py --sparse at
# world 4, under the plan's overlap='fused' wire)
WORLD = 4
W4_BATCH = 65536  # global: 16,384 per rank
W4_CHUNKS = 2
# four cards: full Criteo-1TB vocabulary, five tables row-sliced 4 ways
# (25.3 GB of fused buffers per card); one card shared by the four ranks:
# vocabulary x 1/16, the same five tables row-sliced (2.1 GB per rank)
W4_ROW_SLICE = {"nccl": 2**30, "gloo": 2**26}
W4_VOCAB_SCALE = {"nccl": 1, "gloo": 16}
K4_BAD_SHARE = 0.3  # ids out of range or sentinels in K4's second stream
# cells of a fused-vs-none comparison that may differ: only rows that two
# or more of the step's ids hit (K1 adds duplicates with atomics, in an
# order of the card's choosing), and there by at most this much
W4_DUP_ATOL = 1e-6
CSRC = "distributed_embeddings_torch/csrc"


class SmokeFailure(Exception):
  pass


def emit(obj) -> None:
  print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
  if not cond:
    raise SmokeFailure(what)


def nvidia_smi() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
      check=True).stdout
  return out.strip().splitlines()[0]


def event_ms(torch, fns, flush, reps: int = TIMING_REPS) -> dict:
  """Median device time of one call of each of ``fns`` (name -> fn),
  timed in turns so that drift reaches every version alike, the L2
  flushed before each call (the train and serve steps find these inputs
  cold at large B). A spin of about a millisecond on the card precedes
  each start event, so the host has queued the whole call before the
  card reaches it: the time is the card's, not the host's launch
  latency."""
  for fn in fns.values():
    fn()
  times = {name: [] for name in fns}
  for _ in range(reps):
    for name, fn in fns.items():
      flush.zero_()
      torch.cuda._sleep(SPIN_CYCLES)
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      fn()
      end.record()
      end.synchronize()
      times[name].append(start.elapsed_time(end))
  return {name: statistics.median(t) for name, t in times.items()}


def bound(bytes_moved: float, ops: float, peak_ops: float) -> dict:
  """The least time of the work on this card: bytes over the HBM rate or
  operations over the peak rate of their type, whichever is larger."""
  by_bytes = bytes_moved / HBM_BYTES_PER_S
  by_ops = ops / peak_ops
  return {"bound_ms": max(by_bytes, by_ops) * 1e3,
          "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def warm_up(torch, seconds: float = 2.0) -> None:
  """Keep the card busy with bf16 matrix products for ``seconds``, so the
  timings that follow do not start from idle clocks."""
  a = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
  t0 = time.perf_counter()
  while time.perf_counter() - t0 < seconds:
    for _ in range(50):
      a @ a
    torch.cuda.synchronize()


def within_one_bf16_ulp(torch, got, want, slack=None) -> tuple:
  """(cells that differ, max |got - want| / max(one bf16 ulp, slack))."""
  differ = int((got != want).sum().item())
  _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
  ulp = torch.ldexp(torch.ones_like(got), e - 8)
  if slack is not None:
    ulp = torch.maximum(ulp, slack)
  return differ, ((got - want).abs() / ulp).max().item()


def bf16_parts(torch, b: int, seed: int) -> list:
  gen = torch.Generator(device="cuda").manual_seed(seed)
  return [(torch.randn((b, D), generator=gen, device="cuda") * 0.3)
          .to(torch.bfloat16) for _ in range(F)]


def phase_kernel_fwd(torch, ci, flush) -> dict:
  """K2-fwd against its plain version; returns the serve-shape row."""
  main = None
  for b in KERNEL_BATCHES:
    for k in (-1, 0):
      parts = bf16_parts(torch, b, SEED + b - k)
      got = ci.interact_parts_fwd(parts, k)
      torch.cuda.synchronize()
      want = ci.interact_parts_fwd_plain(parts, k)
      rows, cols = ci.tril_pairs(F, k)
      check(tuple(got.shape) == (b, len(rows)), f"shape {tuple(got.shape)}")
      differ, ulps = within_one_bf16_ulp(torch, got, want)
      check(differ <= 0.001 * got.numel() and ulps <= 1.0,
            f"interact_fwd B={b} k={k}: {differ} of {got.numel()} cells "
            f"differ, worst by {ulps} bf16 ulp")
      idx = torch.as_tensor(rows * F + cols, device="cuda")

      def library(parts=parts, idx=idx):
        feats = torch.stack(parts, dim=1)
        inter = torch.bmm(feats, feats.transpose(1, 2))
        return inter.flatten(1).index_select(1, idx).float()

      npair = len(rows)
      timed = event_ms(torch, {
          "kernel_ms": lambda: ci.interact_parts_fwd(parts, k),
          "plain_ms": lambda: ci.interact_parts_fwd_plain(parts, k),
          "library_ms": library}, flush)
      row = {
          "phase": "kernel", "name": "interact_fwd", "B": b, "F": F, "D": D,
          "k": k, "cells": got.numel(), "cells_differ": differ,
          "max_ulp": ulps, "max_abs_err": (got - want).abs().max().item(),
          **timed, **bound(b * (F * D * 2 + npair * 4), 2 * npair * D * b,
                           BF16_FLOPS)}
      emit(row)
      if b == SERVE_BATCH and k == -1:
        main = row
  return main


def phase_kernel_bwd(torch, ci, flush) -> dict:
  """K2-bwd against its plain version; returns the train-shape row."""
  main = None
  for b in KERNEL_BATCHES:
    for k in (-1, 0):
      parts = bf16_parts(torch, b, SEED + 7 * b - k)
      npair = len(ci.tril_pairs(F, k)[0])
      gen = torch.Generator(device="cuda").manual_seed(SEED + b + k)
      d_acts = torch.randn((b, npair), generator=gen, device="cuda")
      got = torch.stack(ci.interact_parts_bwd(d_acts, parts, k), 1).float()
      torch.cuda.synchronize()
      want = torch.stack(ci.interact_parts_bwd_plain(d_acts, parts, k),
                         1).float()
      coef = ci.pair_coefficients(d_acts, F, k)
      feats = torch.stack(parts, dim=1)
      abs_sum = torch.bmm(coef.abs(), feats.float().abs())
      differ, worst = within_one_bf16_ulp(torch, got, want,
                                          slack=F * 2.0**-24 * abs_sum)
      del abs_sum
      check(tuple(got.shape) == (b, F, D), f"shape {tuple(got.shape)}")
      check(differ <= 0.001 * got.numel() and worst <= 1.0,
            f"interact_bwd B={b} k={k}: {differ} of {got.numel()} cells "
            f"differ, worst by {worst} of its allowance")
      coef_bf16 = coef.to(torch.bfloat16)
      timed = event_ms(torch, {
          "kernel_ms": lambda: ci.interact_parts_bwd(d_acts, parts, k),
          "plain_ms": lambda: ci.interact_parts_bwd_plain(d_acts, parts, k),
          "library_ms": lambda: torch.bmm(coef_bf16, feats)}, flush)
      row = {
          "phase": "kernel", "name": "interact_bwd", "B": b, "F": F, "D": D,
          "k": k, "cells": got.numel(), "cells_differ": differ,
          "max_allowance_share": worst,
          "max_abs_err": (got - want).abs().max().item(), **timed,
          **bound(b * (npair * 4 + 2 * F * D * 2), 2 * F * F * D * b,
                  BF16_FLOPS)}
      emit(row)
      if b == TRAIN_BATCH and k == -1:
        main = row
  return main


def k1_streams(torch, rows: int) -> dict:
  """The K1 id streams: name -> int64 ids on the card (seed 0)."""
  gen = torch.Generator(device="cuda").manual_seed(SEED)
  n = K1_IDS
  r = torch.rand((n,), generator=gen, device="cuda", dtype=torch.float64)
  gamma = -0.05  # the power law of tests/pallas_goldens.py
  power = ((r * ((rows + 1.0) ** gamma - 1.0) + 1.0) ** (1.0 / gamma))
  margin = rows // 10
  return {
      "uniform": torch.randint(0, rows, (n,), generator=gen, device="cuda"),
      "power_law": (power.long() - 1).clamp(0, rows - 1),
      "out_of_range": torch.randint(-margin, rows + margin, (n,),
                                    generator=gen, device="cuda"),
      "unique": torch.randperm(rows, generator=gen, device="cuda")[:n],
  }


def phase_kernel_apply(torch, ca, flush, rows: int) -> dict:
  """K1 against its plain version on the first sparse class's buffer of
  the train plan; returns the uniform stream's row."""
  gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
  base = torch.rand((rows, D), generator=gen, device="cuda")
  work = torch.empty_like(base)
  main = None
  for name, ids in k1_streams(torch, rows).items():
    delta = torch.randn((ids.shape[0], D), generator=gen, device="cuda")
    work.copy_(base)
    got = ca.apply_rows(work, ids, delta, K1_SCALE)
    torch.cuda.synchronize()
    want = ca.apply_rows_plain(base.clone(), ids, delta, K1_SCALE)
    valid = (ids >= 0) & (ids < rows)
    ids_v, delta_v = ids[valid], delta[valid]
    if name == "unique":
      check(torch.equal(got, want),
            "apply_rows: a stream of unique ids is not bit-equal to the "
            "plain version")
      share = 0.0
    else:
      abs_sum = base.abs().index_add_(0, ids_v, (K1_SCALE * delta_v).abs())
      share = ((got - want).abs() / (1e-5 * abs_sum).clamp(min=1e-30)) \
          .max().item()
      del abs_sum
      check(share <= 1.0, f"apply_rows {name}: off by {share} x 1e-5 of "
            "the cells' absolute sums")
    max_err = (got - want).abs().max().item()
    del want
    n_valid = int(valid.sum().item())
    unique = int(torch.unique(ids_v).numel())
    lib = base.clone()
    timed = event_ms(torch, {
        "kernel_ms": lambda: ca.apply_rows(work, ids, delta, K1_SCALE),
        "plain_ms": lambda: ca.apply_rows_plain(work, ids, delta, K1_SCALE),
        "library_ms": lambda: lib.index_add_(0, ids_v, delta_v,
                                             alpha=K1_SCALE)}, flush)
    del lib
    row = {"phase": "kernel", "name": "apply_rows", "stream": name,
           "rows": rows, "width": D, "ids": int(ids.shape[0]),
           "valid_ids": n_valid, "unique_rows": unique,
           "max_abs_err": max_err, "max_abs_sum_share": share, **timed,
           **bound(ids.shape[0] * 8 + n_valid * D * 4 + unique * D * 4 * 2,
                   2 * n_valid * D, F32_FLOPS)}
    emit(row)
    if name == "uniform":
      main = row
  return main


def phase_golden(torch, golden) -> None:
  data = golden.load()
  for q in golden.QUANTIZE:
    acts, preds = golden.replay(data, q, device="cuda")
    want_acts = data[f"acts/{q}"]
    check(acts.shape == want_acts.shape, f"golden {q} acts shape")
    check((acts.view("int32") == want_acts.view("int32")).all(),
          f"golden {q}: activations differ from the JAX serve step")
    want = data[f"preds/{q}"]
    err = abs(preds - want)
    tol = golden.PRED_TOL["atol"] + golden.PRED_TOL["rtol"] * abs(want)
    check(preds.shape == want.shape and bool((err <= tol).all()),
          f"golden {q}: predictions off by up to {err.max()}")
    emit({"phase": "golden", "quantize": q, "acts_bit_equal": True,
          "pred_max_abs_err": float(err.max()), "tol": golden.PRED_TOL})


def phase_train_golden(torch) -> None:
  from distributed_embeddings_torch import train_golden
  data = train_golden.load()
  losses, got = train_golden.replay(data, device="cuda")
  try:
    worst = train_golden.compare(data, losses, got)
  except AssertionError as exc:
    raise SmokeFailure(f"train golden: {exc}") from exc
  emit({"phase": "train_golden", "losses": losses,
        "want_losses": [float(v) for v in data["losses"]], **worst,
        "loss_tol": train_golden.LOSS_TOL,
        "update_tol": train_golden.UPDATE_TOL})


def plain_forward(torch, ci, model, numerical, acts):
  """The DLRM forward with the plain interaction in place of K2-fwd."""
  cd = model.compute_dtype
  bottom = model.bottom_mlp(numerical.to(cd))
  parts = [bottom.to(torch.bfloat16)] + [a.to(torch.bfloat16) for a in acts]
  x = torch.cat([ci.interact_parts_fwd_plain(parts, -1), bottom.float()], 1)
  return model.top_mlp(x.to(cd)).squeeze(-1).float()


def trace_call(torch, fn) -> dict:
  """One call of ``fn`` under ``torch.profiler``: its host wall time, the
  device's busy time (kernels, copies and fills on the card) and idle
  share, the device operations it ran and the costliest of them."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  spans, by_name = [], {}
  for e in prof.events():
    if e.device_type == DeviceType.CUDA:
      spans.append((e.time_range.start, e.time_range.end))
      by_name[e.name] = (by_name.get(e.name, 0.0)
                         + (e.time_range.end - e.time_range.start) / 1e3)
  busy_us, end = 0.0, float("-inf")
  for s, e in sorted(spans):  # union of the device intervals
    busy_us += max(0.0, e - max(s, end))
    end = max(end, e)
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
  # NCCL's own kernels (the profiler also lists each collective under an
  # annotation of the same span, which is not counted twice)
  nccl_ms = sum(ms for name, ms in by_name.items()
                if name.startswith(("ncclDevKernel", "ncclKernel")))
  # the device time each PyTorch operator launched itself (its kernels,
  # copies and fills), by operator name
  by_op = []
  for avg in prof.key_averages():
    ms = getattr(avg, "self_device_time_total", 0.0) / 1e3
    if ms > 0 and avg.device_type != DeviceType.CUDA:
      by_op.append((avg.key, ms, avg.count))
  by_op.sort(key=lambda t: -t[1])
  return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
          "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
          "device_ops": len(spans), "nccl_ms": nccl_ms,
          "top_ms": [[name[:72], ms] for name, ms in top],
          "top_ops_ms": [[name[:48], ms, n] for name, ms, n in by_op[:12]]}


def criteo_vocab() -> list:
  return [max(4, int(v / 16)) for v in CRITEO_1TB_VOCAB]


def sgd_factory(torch):
  return functools.partial(torch.optim.SGD, lr=TRAIN_LR)


def phase_serve(torch, ci, smi: str) -> int:
  """The full-width serve path; returns K2-fwd's launches in it."""
  import numpy as np

  from distributed_embeddings_torch.models import DLRM, dlrm_embedding_plan
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.serving import (
      ServeEngine,
      freeze,
      make_serve_step,
      shard_batch,
  )
  from distributed_embeddings_torch.serving.golden import PRED_TOL, EmbActs
  from distributed_embeddings_torch.training import init_sparse_state_direct

  vocab = criteo_vocab()
  plan = dlrm_embedding_plan(vocab, D, dense_row_threshold=4096)
  rule = sgd_rule(TRAIN_LR)
  dense_tables = sum(len(cp.shards_per_rank[0])
                     for cp in plan.classes.values() if cp.kind == "dense")
  model = DLRM(vocab, D, compute_dtype=torch.bfloat16, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  rng = np.random.default_rng(SEED)
  requests = [(rng.standard_normal((SERVE_BATCH, 13)).astype(np.float32),
               [rng.integers(0, v, SERVE_BATCH).astype(np.int32)
                for v in vocab]) for _ in range(SERVE_REQUESTS)]
  launches = 0
  for q in ("f32", "int8"):
    t0 = time.perf_counter()
    frozen = freeze(plan, rule, state, quantize=q)
    torch.cuda.synchronize()
    freeze_s = time.perf_counter() - t0
    image_bytes = sum(b.numel() * b.element_size()
                      for blocks in frozen.device_blocks.values()
                      for b in blocks)
    eng = ServeEngine(model, plan, frozen, device="cuda")
    ci.launches = 0
    preds, ms = [], []
    for numerical, cats in requests:
      t0 = time.perf_counter()
      preds.append(eng.predict(numerical, cats))
      ms.append((time.perf_counter() - t0) * 1e3)
    got = ci.launches
    check(got == SERVE_REQUESTS,
          f"serve {q}: interact_fwd launched {got} times for "
          f"{SERVE_REQUESTS} requests")
    launches += got
    acts_step = make_serve_step(EmbActs(), plan, eng.meta)
    worst = 0.0
    for (numerical, cats), p in zip(requests, preds):
      check(p.shape == (SERVE_BATCH,) and np.isfinite(p).all(),
            f"serve {q}: predictions not finite [{SERVE_BATCH}]")
      num_d, cats_d = shard_batch((numerical, tuple(cats)), None, "cuda")
      with torch.inference_mode():
        acts = acts_step(eng.state, num_d, cats_d)
        ref = plain_forward(torch, ci, model, num_d, acts).cpu().numpy()
      err = np.abs(p - ref)
      check(bool((err <= PRED_TOL["atol"]
                  + PRED_TOL["rtol"] * np.abs(ref)).all()),
            f"serve {q}: kernel path vs plain interaction off by "
            f"{err.max()}")
      worst = max(worst, float(err.max()))
    emit({"phase": "serve", "quantize": q, "card": smi,
          "tables": len(vocab), "dense_class_tables": dense_tables,
          "rows": int(sum(vocab)),
          "image_bytes": image_bytes, "batch": SERVE_BATCH,
          "requests": SERVE_REQUESTS, "request_ms": ms,
          "p50_ms": statistics.median(ms), "launches": got,
          "max_abs_err_vs_plain": worst, "init_s": init_s,
          "freeze_s": freeze_s,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    emit({"phase": "serve_trace", "quantize": q, "card": smi,
          **trace_call(torch, lambda: eng.predict(*requests[0]))})
    del eng, frozen
    torch.cuda.empty_cache()
  return launches


def train_plan():
  from distributed_embeddings_torch.models import dlrm_embedding_plan
  return dlrm_embedding_plan(criteo_vocab(), D, dense_row_threshold=4096,
                             batch_hint=TRAIN_BATCH)


def first_sparse_class(plan):
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_param_name,
      padded_rows,
  )
  key = next(k for k in plan.class_keys if plan.classes[k].kind == "sparse")
  return key, class_param_name(*key), padded_rows(plan, key)


def phase_train(torch, ci, ca, cx, smi: str, compute: str) -> dict:
  """``bench.py``'s train step at full width; returns each kernel's
  launches in the run."""
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
  )
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_train_step,
  )

  vocab = criteo_vocab()
  plan = train_plan()
  n_sparse = sum(cp.kind == "sparse" for cp in plan.classes.values())
  check(n_sparse == 4, f"the train plan has {n_sparse} sparse classes, "
        "expected 4")
  dtype = torch.float32 if compute == "f32" else torch.bfloat16
  model = DLRM(vocab, D, compute_dtype=dtype, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  rule = sgd_rule(TRAIN_LR)
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), sgd_factory(torch),
      torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  gen = torch.Generator(device="cuda").manual_seed(SEED)
  b = TRAIN_BATCH
  numerical = torch.randn((b, 13), generator=gen, device="cuda")
  cats = [torch.randint(0, v, (b,), generator=gen, device="cuda",
                        dtype=torch.int32) for v in vocab]
  labels = torch.randint(0, 2, (b,), generator=gen, device="cuda").float()

  # sampled rows of the first sparse class: touched and not by the batch
  key, name, rows = first_sparse_class(plan)
  ids = [v for bk, v in DistributedLookup(plan).route_ids(cats).items()
         if bk.class_key == key]
  touched = torch.zeros((rows,), dtype=torch.bool, device="cuda")
  for v in ids:
    touched[v.reshape(-1)] = True
  pick = torch.Generator(device="cuda").manual_seed(SEED + 2)
  hit = torch.nonzero(touched).squeeze(1)
  miss = torch.nonzero(~touched).squeeze(1)
  hit = hit[torch.randperm(hit.numel(), generator=pick,
                           device="cuda")[:ROWS_SAMPLED]]
  miss = miss[torch.randperm(miss.numel(), generator=pick,
                             device="cuda")[:ROWS_SAMPLED]]
  buf = state["fused"][name]
  miss_rows = buf[miss].clone()

  step = make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                rule)
  ms, losses, changed = [], [], []
  totals = {"interact_fwd": 0, "interact_bwd": 0, "apply_rows": 0,
            "gather_rows": 0}
  for i in range(TRAIN_WARMUP + TRAIN_TIMED):
    hit_rows = buf[hit].clone()
    ci.launches = ci.bwd_launches = ca.launches = cx.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, numerical, cats, labels)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = {"interact_fwd": ci.launches, "interact_bwd": ci.bwd_launches,
           "apply_rows": ca.launches, "gather_rows": cx.launches}
    check(got == {"interact_fwd": 1, "interact_bwd": 1,
                  "apply_rows": n_sparse, "gather_rows": 0},
          f"train {compute} step {i}: launches {got}")
    for kname, n in got.items():
      totals[kname] += n
    if i >= TRAIN_WARMUP:
      ms.append((t1 - t0) * 1e3)
    losses.append(float(loss))
    check(losses[-1] == losses[-1] and abs(losses[-1]) < float("inf"),
          f"train {compute} step {i}: loss {losses[-1]}")
    check(torch.equal(buf[miss], miss_rows),
          f"train {compute} step {i}: rows the batch does not touch changed")
    changed.append((buf[hit] != hit_rows).any(dim=1).float().mean().item())
    check(changed[-1] > 0.5,
          f"train {compute} step {i}: only {changed[-1]:.1%} of the "
          "sampled touched rows changed")
  peak = torch.cuda.max_memory_allocated() / 2**30
  med = statistics.median(ms)
  emit({"phase": "train", "compute": compute, "card": smi,
        "batch": b, "sparse_classes": n_sparse,
        "dense_class_tables": sum(len(cp.shards_per_rank[0])
                                  for cp in plan.classes.values()
                                  if cp.kind == "dense"),
        "fused_bytes": sum(t.numel() * 4 for t in state["fused"].values()),
        "init_s": init_s, "step_ms": ms, "step_ms_median": med,
        "samples_per_s": b / (med / 1e3), "peak_gib": peak,
        "launches_per_step": {k: v // (TRAIN_WARMUP + TRAIN_TIMED)
                              for k, v in totals.items()},
        "losses": losses, "touched_rows_changed_share": changed,
        "untouched_rows_bit_equal": True})
  emit({"phase": "train_trace", "compute": compute, "card": smi,
        **trace_call(torch, lambda: step(state, numerical, cats, labels))})
  del state, buf, step
  torch.cuda.empty_cache()
  return totals


def world4_plan(backend: str, overlap: str = "fused"):
  """The world-4 plan of ``examples/dlrm/main.py --sparse``: 26 Criteo-1TB
  tables of width 128, ``memory_balanced``, ``dense_row_threshold=4096``,
  row-sliced as ``backend``'s configuration says, under ``overlap``."""
  from distributed_embeddings_torch.layers.embedding import TableConfig
  from distributed_embeddings_torch.layers.planner import (
      DistEmbeddingStrategy,
  )
  scale = W4_VOCAB_SCALE[backend]
  vocab = [max(4, int(v / scale)) for v in CRITEO_1TB_VOCAB]
  plan = DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=D) for v in vocab], WORLD,
      "memory_balanced", dense_row_threshold=4096,
      row_slice_threshold=W4_ROW_SLICE[backend], batch_hint=W4_BATCH,
      overlap=overlap, exchange_chunks=1 if overlap == "none" else W4_CHUNKS)
  return vocab, plan


def k4_launches_per_step(plan) -> int:
  """K4 launches the fused schedule makes per rank and step: one per
  (sparse bucket, round, chunk); every input is one-hot."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_buckets,
  )
  buckets = sum(len(class_buckets(plan, key, lambda i: 1))
                for key in plan.class_keys
                if plan.classes[key].kind == "sparse")
  return buckets * WORLD * min(W4_CHUNKS, W4_BATCH // WORLD)


def phase_kernel_gather(torch, cx, flush) -> dict:
  """K4 against its plain version at the four-card world-4 path's block
  shape: the first sparse class's rank buffer, one (round, chunk) block of
  its first bucket's ids. A uniform stream and one with 30% of its ids out
  of range or sentinels (what row slicing sends); returns the uniform
  stream's row."""
  from distributed_embeddings_torch.ops.packed_table import PackedLayout
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_buckets,
  )
  _, plan = world4_plan("nccl")
  key, _, rows = first_sparse_class(plan)
  n_b = class_buckets(plan, key, lambda i: 1)[0].n_b
  n = n_b * (W4_BATCH // WORLD // W4_CHUNKS)
  layout = PackedLayout(rows=rows, width=D)
  gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
  buf = torch.rand((rows, D), generator=gen, device="cuda")
  main = None
  for stream in ("uniform", "out_of_range"):
    # int32, as the wire carries the routed ids
    ids = torch.randint(0, rows, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    if stream == "out_of_range":
      bad = torch.rand((n,), generator=gen, device="cuda") < K4_BAD_SHARE
      junk = torch.tensor([rows, -1, rows + 7, 2**31 - 1, -2**31],
                          dtype=torch.int32, device="cuda")[
          torch.randint(0, 5, (n,), generator=gen, device="cuda")]
      ids = torch.where(bad, junk, ids)
    got = cx.gather_rows(layout, buf, ids)
    torch.cuda.synchronize()
    want = cx.gather_rows_plain(buf, ids)
    check(torch.equal(got, want),
          f"gather_rows {stream}: not bit-equal to the plain version")
    n_valid = int(((ids >= 0) & (ids < rows)).sum().item())
    timed = event_ms(torch, {
        "kernel_ms": lambda: cx.gather_rows(layout, buf, ids),
        "plain_ms": lambda: cx.gather_rows_plain(buf, ids),
        # moves the same bytes, but reads row rows-1 for the out-of-range
        # ids instead of writing zeros
        "library_ms": lambda: buf.index_select(0, ids.clamp(0, rows - 1))},
        flush)
    row = {"phase": "kernel", "name": "gather_rows", "stream": stream,
           "rows": rows, "width": D, "ids": n, "valid_ids": n_valid,
           "bit_equal": True, "max_abs_err": 0.0, **timed,
           "library_note": "index_select of clamped ids: no zero rows",
           **bound(n * 4 + n_valid * D * 4 + n * D * 4, 0, F32_FLOPS)}
    emit(row)
    if stream == "uniform":
      main = row
  del buf
  # fused rows short of their physical row (the kernel reads the stride's
  # lanes; 65 takes its 4-byte path) and a two-row pitch (one optimizer
  # slot): bit-equal on a small buffer, not timed
  strides = []
  for width, n_aux in ((96, 0), (65, 0), (128, 1)):
    layout = PackedLayout(rows=100_000, width=width, n_aux=n_aux)
    buf = torch.rand(tuple(layout.shape), generator=gen, device="cuda")
    ids = torch.randint(-100, layout.rows + 100, (n,), generator=gen,
                        device="cuda", dtype=torch.int32)
    got = cx.gather_rows(layout, buf, ids)
    check(torch.equal(got, cx.gather_rows_plain(buf, ids, layout.stride)),
          f"gather_rows stride {layout.stride}: not bit-equal to the plain "
          "version")
    strides.append([layout.stride, layout.phys_width])
  emit({"phase": "kernel", "name": "gather_rows", "stream": "strides",
        "stride_pitch": strides, "ids": n, "bit_equal": True})
  del buf
  torch.cuda.empty_cache()
  return main


def _w4_counts(cx, ca, ci) -> dict:
  return {"gather_rows": cx.launches, "apply_rows": ca.launches,
          "interact_fwd": ci.launches, "interact_bwd": ci.bwd_launches}


def _w4_reset(cx, ca, ci) -> None:
  cx.launches = ca.launches = ci.launches = ci.bwd_launches = 0


def _w4_touch_counts(torch, plan, mesh, cats, state) -> dict:
  """Per sparse class of this rank: how many of the step's ids hit each
  of its rows (the routed ids are the same every step)."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      class_param_name,
  )
  counts = {name: torch.zeros((buf.shape[0],), dtype=torch.int32,
                              device=buf.device)
            for name, buf in state["fused"].items()}
  for bk, ids in DistributedLookup(plan, mesh=mesh).route_ids(cats).items():
    name = class_param_name(*bk.class_key)
    if name not in counts:
      continue
    flat = ids.reshape(-1)
    flat = flat[(flat >= 0) & (flat < counts[name].shape[0])]
    counts[name].index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
  return counts


def _w4_compare_none(torch, mesh, model, vocab, backend, state, batch,
                     touch) -> dict:
  """One ``overlap='fused'`` step and one ``overlap='none'`` step from the
  same state: the losses bit-equal, and the fused buffers bit-equal on
  every row fewer than two of the step's ids hit (within
  ``W4_DUP_ATOL`` on the others, where K1's atomics pick the order of the
  duplicates' adds). Then ``TRAIN_TIMED`` more ``'none'`` steps, timed as
  the fused ones are, for the schedules' comparison."""
  from distributed_embeddings_torch.models import bce_loss
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.training import make_sparse_train_step

  snap = {"fused": {k: v.clone() for k, v in state["fused"].items()},
          "emb_dense": {k: v.detach().clone()
                        for k, v in state["emb_dense"].items()},
          "dense": {k: v.detach().clone() for k, v in state["dense"].items()},
          "step": state["step"]}
  losses = {}
  for overlap, st in (("fused", state), ("none", snap)):
    _, plan = world4_plan(backend, overlap)
    step = make_sparse_train_step(model, plan, bce_loss, sgd_factory(torch),
                                  sgd_rule(TRAIN_LR), mesh=mesh)
    _, loss = step(st, *batch)
    losses[overlap] = float(loss)
  check(losses["fused"] == losses["none"],
        f"world 4: fused loss {losses['fused']} != none {losses['none']}")
  differ, dup_rows, worst = 0, 0, 0.0
  for name, buf in state["fused"].items():
    other = snap["fused"][name]
    dup = touch[name] >= 2
    dup_rows += int(dup.sum().item())
    bad = (buf != other).any(dim=1)
    differ += int((buf != other).sum().item())
    check(not bool((bad & ~dup).any().item()),
          f"world 4 {name}: fused and none differ on a row fewer than two "
          "ids hit")
    if bool(bad.any().item()):
      worst = max(worst, (buf[bad] - other[bad]).abs().max().item())
  check(worst <= W4_DUP_ATOL,
        f"world 4: fused and none differ by {worst} on duplicate rows")
  none_ms = []
  for _ in range(TRAIN_TIMED):
    torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    step(snap, *batch)
    torch.cuda.synchronize(mesh.device)
    none_ms.append((time.perf_counter() - t0) * 1e3)
  del snap
  return {"loss_bit_equal": True, "cells_differ": differ,
          "dup_rows": dup_rows, "dup_rows_max_abs_err": worst,
          "none_step_ms": none_ms,
          "none_step_ms_median": statistics.median(none_ms)}


def world4_rank(rank: int, port: int, backend: str, outdir: str) -> None:
  """One rank of the world-4 phase (a spawned process): the world-4
  golden, then the path at f32 and bf16 compute. Writes its result to
  ``outdir/rank<rank>.json``."""
  import os

  import numpy as np
  import torch

  from distributed_embeddings_torch import train_golden
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops import cuda_apply as ca
  from distributed_embeddings_torch.ops import cuda_exchange as cx
  from distributed_embeddings_torch.ops import cuda_interact as ci
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel.mesh import create_mesh
  from distributed_embeddings_torch.parallel.wire import gather_blocks
  from distributed_embeddings_torch.training import (
      init_sparse_state_direct,
      make_sparse_train_step,
      shard_batch,
  )

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  mesh = create_mesh(WORLD, rank, f"tcp://127.0.0.1:{port}", device="cuda")
  check(mesh.backend == backend,
        f"rank {rank}: backend {mesh.backend}, expected {backend}")
  dev = mesh.device
  out = {"rank": rank, "backend": mesh.backend, "device": str(dev)}
  try:
    # the committed world-4 golden's bf16 run, under the fused schedule
    golden = train_golden.load(train_golden.WORLD4_PATH)
    losses, got, preds = train_golden.replay_world4(golden, mesh,
                                                    compute="bf16")
    if rank == 0:
      try:
        worst = train_golden.compare_world4(golden, losses, got, preds)
      except AssertionError as exc:
        raise SmokeFailure(f"world-4 golden: {exc}") from exc
      out["golden"] = {"compute": "bf16", "losses": losses,
                       "want_losses": [float(v)
                                       for v in golden["bf16_losses"]],
                       **worst, "loss_tol": train_golden.LOSS_TOL,
                       "update_tol": train_golden.UPDATE_TOL}

    vocab, plan = world4_plan(backend)
    k4_per_step = k4_launches_per_step(plan)
    gen = torch.Generator().manual_seed(SEED)
    numerical = torch.randn((W4_BATCH, 13), generator=gen)
    cats = [torch.randint(0, v, (W4_BATCH,), generator=gen,
                          dtype=torch.int32) for v in vocab]
    labels = torch.randint(0, 2, (W4_BATCH,), generator=gen).float()
    batch = shard_batch((numerical, cats, labels), mesh)
    out["runs"] = {}
    for compute in ("f32", "bf16"):
      dtype = torch.float32 if compute == "f32" else torch.bfloat16
      model = DLRM(vocab, D, compute_dtype=dtype, device=dev,
                   generator=torch.Generator().manual_seed(SEED))
      rule = sgd_rule(TRAIN_LR)
      torch.cuda.reset_peak_memory_stats(dev)
      t0 = time.perf_counter()
      state = init_sparse_state_direct(
          plan, rule, model.state_dict(), sgd_factory(torch),
          torch.Generator(device=dev).manual_seed(SEED + 1 + rank),
          mesh=mesh)
      torch.cuda.synchronize(dev)
      init_s = time.perf_counter() - t0
      touch = _w4_touch_counts(torch, plan, mesh, batch[1], state)
      # sampled rows of the first sparse class, touched and not
      name = next(iter(state["fused"]))
      buf = state["fused"][name]
      pick = torch.Generator(device=dev).manual_seed(SEED + 2)
      hit = torch.nonzero(touch[name] > 0).squeeze(1)
      miss = torch.nonzero(touch[name] == 0).squeeze(1)
      hit = hit[torch.randperm(hit.numel(), generator=pick,
                               device=dev)[:ROWS_SAMPLED]]
      miss = miss[torch.randperm(miss.numel(), generator=pick,
                                 device=dev)[:ROWS_SAMPLED]]
      miss_rows = buf[miss].clone()
      step = make_sparse_train_step(model, plan, bce_loss,
                                    sgd_factory(torch), rule, mesh=mesh)
      want = {"gather_rows": k4_per_step, "apply_rows": len(state["fused"]),
              "interact_fwd": 1, "interact_bwd": 1}
      totals = dict.fromkeys(want, 0)
      ms, losses, changed = [], [], []
      for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        hit_rows = buf[hit].clone()
        _w4_reset(cx, ca, ci)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, loss = step(state, *batch)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        got = _w4_counts(cx, ca, ci)
        check(got == want, f"world 4 {compute} rank {rank} step {i}: "
              f"launches {got}, expected {want}")
        for k, n in got.items():
          totals[k] += n
        if i >= TRAIN_WARMUP:
          ms.append((t1 - t0) * 1e3)
        losses.append(float(loss))
        check(np.isfinite(losses[-1]),
              f"world 4 {compute} rank {rank} step {i}: loss {losses[-1]}")
        check(torch.equal(buf[miss], miss_rows),
              f"world 4 {compute} rank {rank} step {i}: rows the batch "
              "does not touch changed")
        changed.append((buf[hit] != hit_rows).any(dim=1).float().mean()
                       .item())
        check(changed[-1] > 0.5,
              f"world 4 {compute} rank {rank} step {i}: only "
              f"{changed[-1]:.1%} of the sampled touched rows changed")
      run = {"step_ms": ms, "step_ms_median": statistics.median(ms),
             "losses": losses, "touched_rows_changed_share": changed,
             "launches": totals, "launches_per_step": want,
             "init_s": init_s,
             "fused_bytes": sum(t.numel() * 4
                                for t in state["fused"].values()),
             "sparse_buckets_k4": k4_per_step // (WORLD * W4_CHUNKS)}
      torch.cuda.synchronize(dev)
      run["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
      # every rank's losses, to check they agree
      all_losses = gather_blocks(torch.tensor(losses, device=dev), mesh)
      run["losses_agree"] = bool(torch.equal(
          all_losses.reshape(WORLD, -1),
          all_losses[:len(losses)].expand(WORLD, -1)))
      check(run["losses_agree"], f"world 4 {compute}: ranks' losses differ")
      if rank == 0:
        run["trace"] = trace_call(torch, lambda: step(state, *batch))
      else:
        step(state, *batch)
      if compute == "f32":
        run["fused_vs_none"] = _w4_compare_none(
            torch, mesh, model, vocab, backend, state, batch, touch)
      out["runs"][compute] = run
      del state, buf, step, touch
      torch.cuda.empty_cache()
  finally:
    mesh.close()
  with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)


def phase_world4(torch, smi: str) -> dict:
  """The world-4 hybrid-parallel train step: four ranks spawned with
  ``torch.multiprocessing``, NCCL when each owns a card, else gloo with
  the four sharing the card. Returns each kernel's launches in the run
  (summed over the ranks)."""
  import os
  import socket
  import tempfile

  import torch.multiprocessing as mp

  backend = "nccl" if torch.cuda.device_count() >= WORLD else "gloo"
  with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
  outdir = tempfile.mkdtemp(prefix="chip_smoke_world4_")
  t0 = time.perf_counter()
  mp.spawn(world4_rank, args=(port, backend, outdir), nprocs=WORLD,
           join=True)
  wall_s = time.perf_counter() - t0
  ranks = []
  for rank in range(WORLD):
    with open(os.path.join(outdir, f"rank{rank}.json")) as f:
      ranks.append(json.load(f))
  _, plan = world4_plan(backend)
  emit({"phase": "world4_golden", "backend": backend, **ranks[0]["golden"]})
  totals = dict.fromkeys(("interact_fwd", "interact_bwd", "apply_rows",
                          "gather_rows"), 0)
  for compute in ("f32", "bf16"):
    runs = [r["runs"][compute] for r in ranks]
    med = max(r["step_ms_median"] for r in runs)
    for r in runs:
      for k, n in r["launches"].items():
        totals[k] += n
    emit({"phase": "train_world4", "compute": compute, "backend": backend,
          "mode": ("four cards, one rank each" if backend == "nccl" else
                   "one card shared by the four ranks"),
          "cards": torch.cuda.device_count(), "card": smi,
          "vocab_scale": f"1/{W4_VOCAB_SCALE[backend]}",
          "row_slice": W4_ROW_SLICE[backend], "global_batch": W4_BATCH,
          "exchange_chunks": W4_CHUNKS,
          "sparse_buckets": runs[0]["sparse_buckets_k4"],
          "fused_bytes_per_rank": [r["fused_bytes"] for r in runs],
          "init_s": [r["init_s"] for r in runs],
          "step_ms": runs[0]["step_ms"],
          "step_ms_median_by_rank": [r["step_ms_median"] for r in runs],
          "step_ms_median": med, "samples_per_s": W4_BATCH / (med / 1e3),
          "peak_gib_by_rank": [r["peak_gib"] for r in runs],
          "launches_per_step_per_rank": runs[0]["launches_per_step"],
          "losses": runs[0]["losses"], "losses_agree": True,
          "touched_rows_changed_share": runs[0]["touched_rows_changed_share"],
          "untouched_rows_bit_equal": True,
          **({"fused_vs_none": [r["fused_vs_none"] for r in runs],
              "none_step_ms_median": max(
                  r["fused_vs_none"]["none_step_ms_median"] for r in runs)}
             if compute == "f32" else {})})
    emit({"phase": "train_world4_trace", "compute": compute,
          "backend": backend, "rank": 0, "card": smi,
          **runs[0]["trace"]})
  emit({"phase": "world4", "wall_s": wall_s})
  return totals


def zoo_plan():
  """The plan of ``tools/bench_synthetic.py tiny 65536`` at world 1: Tiny's
  55 tables at their published vocabularies, ``"basic"``,
  ``dense_row_threshold=2048``, ``batch_hint=65536``."""
  from distributed_embeddings_torch.models import (
      SYNTHETIC_MODELS,
      synthetic_plan,
  )
  return synthetic_plan(SYNTHETIC_MODELS[ZOO_MODEL],
                        dense_row_threshold=ZOO_DENSE_ROW_THRESHOLD,
                        batch_hint=ZOO_BATCH)


def zoo_hotness():
  from distributed_embeddings_torch.models import (
      SYNTHETIC_MODELS,
      expand_tables,
  )
  return expand_tables(SYNTHETIC_MODELS[ZOO_MODEL])[2]


def zoo_classes(plan, rule) -> list:
  """The largest sparse class of each width of the plan, widest first:
  ``(name, layout)``."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      class_param_name,
  )
  layouts = DistributedLookup(plan).fused_layouts(rule)
  best = {}
  for key in plan.class_keys:
    if plan.classes[key].kind != "sparse":
      continue
    name = class_param_name(*key)
    lay = layouts[name]
    if (lay.width not in best
        or lay.phys_rows > layouts[best[lay.width]].phys_rows):
      best[lay.width] = name
  return [(best[w], layouts[best[w]]) for w in sorted(best, reverse=True)]


def zoo_routed(torch, plan) -> dict:
  """The routed ids of ``generate_batch(seed=0)`` per sparse class and
  bucket, as the train step's lookup gets them: ``name -> [(h, ids)]``,
  ids on the card, ``[n_b, B]`` or ``[n_b, B, h]``."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      class_param_name,
  )
  out = {}
  routed = DistributedLookup(plan).route_ids(zoo_batches(torch, 1)[0][1])
  for bk, ids in routed.items():
    if plan.classes[bk.class_key].kind == "sparse":
      out.setdefault(class_param_name(*bk.class_key), []).append((bk.h, ids))
  return out


def k6_inputs(torch, layout, sub, h: int, aux_last: int, seed: int):
  """K6's other inputs on the card for the windows ``sub`` ([K*h]):
  per-sample cotangents and state rows (an Adagrad accumulator of at
  least 0.1; masked rows nonzero in their occurrence's window only)."""
  gen = torch.Generator(device="cuda").manual_seed(seed)
  n = sub.shape[0]
  dz = torch.randn((n // h, layout.width), generator=gen, device="cuda") * 1e-2
  aux = torch.rand((n, aux_last), generator=gen, device="cuda") + 0.1
  if aux_last != layout.stride:
    win = torch.arange(aux_last, device="cuda") // layout.stride
    aux = torch.where(win[None, :] == sub[:, None], aux,
                      torch.zeros_like(aux))
  return dz, aux


def k6_bytes(layout, rule, k: int, n: int, aux_last: int) -> int:
  """The bytes K6 must move: each sample's cotangent row, each
  occurrence's int64 window index and the state lanes the function reads
  (``n_aux * w`` lanes of a stride-wide row; of each of the ``rpp``
  windows of a masked physical row, which it sums), and the 128-lane
  update rows written once."""
  windows = 1 if aux_last == layout.stride else layout.rows_per_phys
  state = n * windows * rule.n_aux * layout.width * 4
  return k * layout.width * 4 + n * 8 + state + n * 128 * 4


def k6_within_tol(torch, got, want) -> float:
  """max |got - want| over its allowance ``atol + rtol * |want|``."""
  allow = K6_TOL["atol"] + K6_TOL["rtol"] * want.abs()
  return ((got - want).abs() / allow).max().item()


def phase_kernel_delta(torch, cd, flush) -> dict:
  """K6 against its plain version at Tiny's shapes: every bucket of the
  largest w16 class and of the w8 class (one-hot with stride-wide state
  rows, ten-hot with window-masked physical rows), the windows those of
  the routed ids of ``generate_batch(seed=0)``; then momentum and Adam on
  small streams. Returns the ten-hot w16 bucket's row."""
  from distributed_embeddings_torch.ops.packed_table import (
      PackedLayout,
      _grp_sub,
      adagrad_rule,
      adam_rule,
      momentum_rule,
  )
  rule = adagrad_rule(ZOO_LR)
  step = 5
  plan = zoo_plan()
  routed = zoo_routed(torch, plan)
  main = None
  for c, (name, layout) in enumerate(zoo_classes(plan, rule)):
    for i, (h, ids) in enumerate(routed.pop(name)):
      n = ids.numel()
      k = n // h
      _, sub, _ = _grp_sub(layout, ids.reshape(-1))
      del ids
      aux_last = (layout.stride if h == 1
                  else layout.rows_per_phys * layout.stride)
      dz, aux = k6_inputs(torch, layout, sub, h, aux_last,
                          SEED + 10 + 2 * c + i)
      got = cd.build_delta_rows(layout, rule, dz, sub, aux, h, step)
      torch.cuda.synchronize()
      want = cd.build_delta_rows_plain(layout, rule, dz, sub, aux, h, step)
      share = k6_within_tol(torch, got, want)
      check(share <= 1.0, f"build_delta_rows {name} h={h}: off by {share} "
            f"of rtol {K6_TOL['rtol']}, atol {K6_TOL['atol']}")
      max_err = (got - want).abs().max().item()
      del want
      timed = event_ms(torch, {
          "kernel_ms": lambda: cd.build_delta_rows(layout, rule, dz, sub,
                                                   aux, h, step),
          "plain_ms": lambda: cd.build_delta_rows_plain(layout, rule, dz,
                                                        sub, aux, h, step)},
                       flush)
      row = {"phase": "kernel", "name": "build_delta_rows", "class": name,
             "rule": rule.name, "width": layout.width,
             "stride": layout.stride, "rows_per_phys": layout.rows_per_phys,
             "samples": k, "h": h, "occurrences": n, "aux_last": aux_last,
             "aux": "stride" if aux_last == layout.stride else "masked_phys",
             "max_abs_err": max_err, "max_tol_share": share, "tol": K6_TOL,
             **timed, "library_ms": None,
             "library_note": "no single PyTorch call computes this function",
             # about ten flops per logical lane
             **bound(k6_bytes(layout, rule, k, n, aux_last),
                     10 * n * layout.stride, F32_FLOPS)}
      emit(row)
      if c == 0 and h > 1:
        main = row
      del dz, sub, aux, got
  del routed
  # the other rules' templates, bit-for-bit within the tolerance, small
  others = []
  gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
  for rule2, w in ((momentum_rule(ZOO_LR), 16), (adam_rule(ZOO_LR), 16),
                   (adagrad_rule(ZOO_LR), 8)):
    layout = PackedLayout(rows=100_000, width=w, n_aux=rule2.n_aux)
    auxes = [layout.stride]
    if layout.rows_per_phys * layout.stride == layout.phys_width:
      auxes.append(layout.phys_width)
    for h, aux_last in [(h, a) for h in (1, 10) for a in auxes]:
      sub = torch.randint(0, layout.rows_per_phys, (4096 * h,),
                          generator=gen, device="cuda")
      dz, aux = k6_inputs(torch, layout, sub, h, aux_last, SEED + 20)
      got = cd.build_delta_rows(layout, rule2, dz, sub, aux, h, step)
      share = k6_within_tol(
          torch, got, cd.build_delta_rows_plain(layout, rule2, dz, sub, aux,
                                                h, step))
      check(share <= 1.0, f"build_delta_rows {rule2.name} w={w} h={h} "
            f"aux_last={aux_last}: off by {share} of the tolerance")
      others.append([rule2.name, w, h, aux_last, share])
  emit({"phase": "kernel", "name": "build_delta_rows", "stream": "rules",
        "rule_width_h_auxlast_tolshare": others})
  torch.cuda.empty_cache()
  return main


def phase_kernel_apply_zoo(torch, ca, flush) -> None:
  """K1 against its plain version at the Tiny step's streams: for the
  largest w16 class and the w8 class, the class's buffer (random rows),
  every routed occurrence of ``generate_batch(seed=0)`` (power-law ids,
  its buckets in turn) sent to its physical row, and K6-shaped update
  rows (nonzero in the occurrence's window only, no scale), as the train
  step hands them to K1. Held to the duplicate tolerance of
  :func:`phase_kernel_apply` on the rows the stream touches, and
  bit-equal elsewhere."""
  from distributed_embeddings_torch.ops.packed_table import (
      _grp_sub,
      adagrad_rule,
  )
  plan = zoo_plan()
  routed = zoo_routed(torch, plan)
  gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
  for name, layout in zoo_classes(plan, adagrad_rule(ZOO_LR)):
    ids = torch.cat([ids.reshape(-1).long() for _, ids in routed.pop(name)])
    grp, sub, valid = _grp_sub(layout, ids)
    del ids
    n = grp.shape[0]
    win = torch.arange(D, device="cuda") // layout.stride
    rows = torch.randn((n, D), generator=gen, device="cuda") * 1e-2
    rows = torch.where(win[None, :] == sub[:, None], rows,
                       torch.zeros_like(rows))
    base = torch.rand((layout.phys_rows, D), generator=gen, device="cuda")
    work = base.clone()
    got = ca.apply_rows(work, grp, rows)
    torch.cuda.synchronize()
    want = ca.apply_rows_plain(base.clone(), grp, rows)
    grp_v, rows_v = grp[valid], rows[valid]
    touched, inv = torch.unique(grp_v, return_inverse=True)
    differ = (got != want).any(dim=1)
    differ[touched] = False
    check(not bool(differ.any().item()), f"apply_rows tiny {name}: a row "
          "no id touches differs from the plain version")
    del differ
    abs_sum = base[touched].abs().index_add_(0, inv, rows_v.abs())
    err = (got[touched] - want[touched]).abs()
    share = (err / (1e-5 * abs_sum).clamp(min=1e-30)).max().item()
    max_err = err.max().item()
    del want, abs_sum, err
    check(share <= 1.0, f"apply_rows tiny {name}: off by {share} x 1e-5 "
          "of the cells' absolute sums")
    hits = torch.bincount(inv)
    timed = event_ms(torch, {
        "kernel_ms": lambda: ca.apply_rows(work, grp, rows),
        "plain_ms": lambda: ca.apply_rows_plain(work, grp, rows),
        "library_ms": lambda: work.index_add_(0, grp_v, rows_v)}, flush)
    n_valid, unique = grp_v.shape[0], touched.shape[0]
    emit({"phase": "kernel", "name": "apply_rows", "stream": f"tiny_{name}",
          "rows": layout.phys_rows, "width": D, "ids": n,
          "valid_ids": n_valid, "unique_rows": unique,
          "most_hits_on_a_row": int(hits.max().item()),
          "max_abs_err": max_err, "max_abs_sum_share": share, **timed,
          **bound(n * 8 + n_valid * D * 4 + unique * D * 4 * 2,
                  2 * n_valid * D, F32_FLOPS)})
    del base, work, got, rows, grp, sub, valid, grp_v, rows_v, touched, inv
    torch.cuda.empty_cache()


def phase_kernel_layout(torch, cl, flush) -> dict:
  """K7 against its plain version: bit-equal on a transposed and a sliced
  f32 tensor of the shape of Tiny's largest one-hot cotangent ([12, 65536,
  16]) and on a transposed bf16 one; returns the transposed f32 row."""
  gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
  n_b, g, w = 12, ZOO_BATCH, 16
  views = {
      "transposed": torch.randn((g, n_b, w), generator=gen,
                                device="cuda").transpose(0, 1),
      "sliced": torch.randn((n_b, g, 2 * w), generator=gen,
                            device="cuda")[:, :, :w],
      "transposed_bf16": torch.randn((g, n_b, w), generator=gen,
                                     device="cuda").to(torch.bfloat16)
                         .transpose(0, 1),
  }
  main = None
  for name, x in views.items():
    check(not x.is_contiguous(), f"row_major {name}: input is contiguous")
    got = cl.row_major(x)
    torch.cuda.synchronize()
    want = cl.row_major_plain(x)
    bits = torch.int32 if x.dtype == torch.float32 else torch.int16
    check(got.is_contiguous() and torch.equal(got.view(bits),
                                              want.view(bits)),
          f"row_major {name}: not bit-equal to the plain version")
    row = {"phase": "kernel", "name": "row_major", "stream": name,
           "shape": list(x.shape), "strides": list(x.stride()),
           "dtype": str(x.dtype), "bit_equal": True, "max_abs_err": 0.0}
    if name == "transposed":
      row.update(event_ms(torch, {
          "kernel_ms": lambda: cl.row_major(x),
          "plain_ms": lambda: cl.row_major_plain(x),
          "library_ms": lambda: x.contiguous()}, flush))
      row.update(bound(2 * x.numel() * x.element_size(), 0, F32_FLOPS))
      main = row
    emit(row)
  del views
  torch.cuda.empty_cache()
  return main


def phase_zoo_golden(torch) -> None:
  from distributed_embeddings_torch import train_golden
  data = train_golden.load(train_golden.ZOO_PATH)
  losses, got = train_golden.replay_zoo(data, device="cuda")
  try:
    worst = train_golden.compare_zoo(data, losses, got)
  except AssertionError as exc:
    raise SmokeFailure(f"zoo golden: {exc}") from exc
  emit({"phase": "zoo_golden", "losses": losses,
        "want_losses": [float(v) for v in data["losses"]], **worst,
        "loss_tol": train_golden.LOSS_TOL,
        "update_tol": train_golden.UPDATE_TOL})


def zoo_batches(torch, n: int = 2) -> list:
  """``tools/bench_synthetic.py``'s batches: ``generate_batch(tiny, 65536,
  alpha=1.05, seed=i)``, ids clamped to each table, one-hot inputs as
  ``[B]``, on the card."""
  import numpy as np

  from distributed_embeddings_torch.models import (
      SYNTHETIC_MODELS,
      expand_tables,
      generate_batch,
  )
  cfg = SYNTHETIC_MODELS[ZOO_MODEL]
  tables, tmap, hot = expand_tables(cfg)
  out = []
  for i in range(n):
    numerical, cats, labels = generate_batch(cfg, ZOO_BATCH, alpha=ZOO_ALPHA,
                                             seed=i)
    cats = [np.minimum(c, tables[t].input_dim - 1).astype(np.int32)
            for c, t in zip(cats, tmap)]
    cats = [torch.as_tensor(c if h > 1 else c[:, 0], device="cuda")
            for c, h in zip(cats, hot)]
    out.append((torch.as_tensor(numerical, device="cuda"), cats,
                torch.as_tensor(labels, device="cuda")))
  return out


def zoo_hits(torch, plan, batch) -> dict:
  """Per class buffer, how many ids of ``batch`` hit each of its logical
  rows."""
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      class_param_name,
      padded_rows,
  )
  out = {}
  for bk, ids in DistributedLookup(plan).route_ids(batch[1]).items():
    name = class_param_name(*bk.class_key)
    rows = padded_rows(plan, bk.class_key)
    flat = ids.reshape(-1).long()
    flat = flat[(flat >= 0) & (flat < rows)]
    cnt = out.setdefault(name, torch.zeros((rows,), dtype=torch.int32,
                                           device="cuda"))
    cnt.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
  return out


def zoo_phys_hits(layout, cnt):
  """Logical-row hit counts -> the most of them in each physical row."""
  full = cnt.new_zeros(layout.phys_rows * layout.rows_per_phys)
  full[:cnt.shape[0]] = cnt
  return full.view(layout.phys_rows, layout.rows_per_phys).amax(dim=1)


def zoo_counts(mods) -> dict:
  cd, ca, cl, cx, ci = mods
  return {"build_delta_rows": cd.launches, "apply_rows": ca.launches,
          "row_major": cl.launches, "gather_rows": cx.launches,
          "interact_fwd": ci.launches, "interact_bwd": ci.bwd_launches}


def zoo_reset(mods) -> None:
  cd, ca, cl, cx, ci = mods
  cd.launches = ca.launches = cl.launches = cx.launches = 0
  ci.launches = ci.bwd_launches = 0


def zoo_rel_diff(torch, a, b) -> float:
  """max |a - b| / max(|a|, |b|) over the cells that differ (0 if none)."""
  bad = a != b
  if not bool(bad.any().item()):
    return 0.0
  return ((a[bad] - b[bad]).abs()
          / torch.maximum(a[bad].abs(), b[bad].abs())).max().item()


def zoo_compare_pin(torch, step, state, batch, hits, layouts, mods,
                    want) -> tuple:
  """One step with ``DE_TORCH_COTANGENT_PIN`` off (on ``state``) and one
  with it on (on a copy), from the same state before either has stepped.
  The losses, the K6 update rows of every bucket and the dense parameters
  are bit-equal; every class buffer is bit-equal on the rows that fewer
  than two of the step's ids hit, and within ``ZOO_DUP_RTOL`` of each cell
  on the others, where the atomics of K1 and of the dense-class
  ``index_add_`` add the duplicates in an order of the card's choosing.
  The unpinned step launches no K7, the pinned one one per sparse bucket.
  Returns ``(result, the pinned step's launches)``."""
  import os

  from distributed_embeddings_torch.parallel import lookup_engine
  snap = {"fused": {k: v.clone() for k, v in state["fused"].items()},
          "emb_dense": {k: v.detach().clone()
                        for k, v in state["emb_dense"].items()},
          "dense": {k: v.detach().clone() for k, v in state["dense"].items()},
          "step": state["step"]}  # fresh optimizers bind at its first step
  kernel = lookup_engine.build_delta_rows
  built = {"0": [], "1": []}
  runs = {}
  for pin, st in (("0", state), ("1", snap)):
    def recording(*args, _pin=pin, **kwargs):
      rows = kernel(*args, **kwargs)
      if _pin == "0":
        built["0"].append(rows)
      else:
        i = len(built["1"])
        built["1"].append(i < len(built["0"])
                          and torch.equal(rows, built["0"][i]))
      return rows
    os.environ["DE_TORCH_COTANGENT_PIN"] = pin
    lookup_engine.build_delta_rows = recording
    try:
      zoo_reset(mods)
      torch.cuda.synchronize()
      _, loss = step(st, *batch)
      torch.cuda.synchronize()
      runs[pin] = (float(loss), zoo_counts(mods))
    finally:
      os.environ.pop("DE_TORCH_COTANGENT_PIN", None)
      lookup_engine.build_delta_rows = kernel
  want_pin = dict(want, row_major=want["build_delta_rows"])
  check(runs["0"][1] == want, f"zoo pin off: launches {runs['0'][1]}, "
        f"expected {want}")
  check(runs["1"][1] == want_pin, f"zoo pin on: launches {runs['1'][1]}, "
        f"expected {want_pin}")
  check(runs["0"][0] == runs["1"][0],
        f"zoo pin: loss {runs['1'][0]} pinned, {runs['0'][0]} unpinned")
  check(len(built["1"]) == len(built["0"]) and all(built["1"]),
        "zoo pin: the K6 update rows differ between the pinned and the "
        "unpinned step")
  for k, v in state["dense"].items():
    check(torch.equal(v, snap["dense"][k]),
          f"zoo pin: dense parameter {k} differs")
  dup_worst, dup_rows = 0.0, 0
  for part in ("fused", "emb_dense"):
    for name, buf in state[part].items():
      other = snap[part][name]
      dup = (zoo_phys_hits(layouts[name], hits[name]) if part == "fused"
             else hits[name]) >= 2
      dup_rows += int(dup.sum().item())
      bad = (buf != other).any(dim=1)
      check(not bool((bad & ~dup).any().item()),
            f"zoo pin {name}: a row fewer than two ids hit differs")
      dup_worst = max(dup_worst, zoo_rel_diff(torch, buf.detach(),
                                              other.detach()))
  check(dup_worst <= ZOO_DUP_RTOL, f"zoo pin: duplicate rows differ by "
        f"{dup_worst} of their magnitude")
  del snap, built
  torch.cuda.empty_cache()
  return ({"loss_bit_equal": True, "update_rows_bit_equal": True,
           "dense_bit_equal": True, "dup_rows": dup_rows,
           "dup_rows_max_rel_diff": dup_worst,
           "launches_unpinned": runs["0"][1],
           "launches_pinned": runs["1"][1]}, runs["1"][1])


def phase_train_zoo(torch, mods, smi: str) -> dict:
  """``tools/bench_synthetic.py tiny 65536`` in the port at world 1; returns
  each kernel's launches in its unpinned run (``train_zoo``) and in the
  pinned step (``train_zoo_pin``)."""
  from distributed_embeddings_torch.models import (
      SYNTHETIC_MODELS,
      SyntheticModel,
      bce_loss,
  )
  from distributed_embeddings_torch.ops.packed_table import (
      adagrad_rule,
      gather_fused,
  )
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      class_buckets,
      class_param_name,
  )
  from distributed_embeddings_torch.training import (
      Adagrad,
      init_sparse_state_direct,
      make_sparse_train_step,
  )
  cfg = SYNTHETIC_MODELS[ZOO_MODEL]
  plan = zoo_plan()
  rule = adagrad_rule(ZOO_LR)
  hot = zoo_hotness()
  layouts = DistributedLookup(plan).fused_layouts(rule)
  sparse = [k for k in plan.class_keys if plan.classes[k].kind == "sparse"]
  buckets = [b for k in sparse for b in class_buckets(plan, k,
                                                     lambda i: hot[i])]
  # K6 once per sparse bucket (every class is Adagrad on 128-lane rows),
  # K1 once per sparse class, no K7 unpinned; the model has no
  # interaction and the plan no exchange
  want = {"build_delta_rows": len(buckets), "apply_rows": len(sparse),
          "row_major": 0, "gather_rows": 0, "interact_fwd": 0,
          "interact_bwd": 0}
  occurrences = sum(b.n_b * b.h for b in buckets) * ZOO_BATCH
  model = SyntheticModel(cfg, device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
  adagrad = functools.partial(Adagrad, lr=ZOO_LR)
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state = init_sparse_state_direct(
      plan, rule, model.state_dict(), adagrad,
      torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
  torch.cuda.synchronize()
  init_s = time.perf_counter() - t0
  batches = zoo_batches(torch)
  hits = [zoo_hits(torch, plan, b) for b in batches]
  step = make_sparse_train_step(model, plan, bce_loss, adagrad, rule)
  pin, pin_counts = zoo_compare_pin(torch, step, state, batches[0], hits[0],
                                    layouts, mods, want)
  # sampled logical rows of every sparse class (their fused rows: table
  # and accumulator lanes): untouched by both batches, and touched by each
  pick = torch.Generator(device="cuda").manual_seed(SEED + 2)

  def sample(mask):
    idx = torch.nonzero(mask).squeeze(1)
    return idx[torch.randperm(idx.numel(), generator=pick,
                              device="cuda")[:ROWS_SAMPLED]]

  def fused_rows(name, ids):
    return gather_fused(layouts[name], state["fused"][name], ids)

  miss, hit = {}, {}
  for name in layouts:
    miss[name] = sample((hits[0][name] == 0) & (hits[1][name] == 0))
    hit[name] = [sample(h[name] > 0) for h in hits]
    check(miss[name].numel() > 0 and min(h.numel() for h in hit[name]) > 0,
          f"zoo {name}: no untouched or no touched rows to sample")
  miss_rows = {n: fused_rows(n, m) for n, m in miss.items()}
  totals = dict.fromkeys(want, 0)
  ms, losses, changed = [], [], []
  for i in range(TRAIN_WARMUP + TRAIN_TIMED):
    batch = batches[i % 2]
    before = {n: fused_rows(n, h[i % 2]) for n, h in hit.items()}
    zoo_reset(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, *batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = zoo_counts(mods)
    check(got == want, f"train_zoo step {i}: launches {got}, expected {want}")
    for k, n in got.items():
      totals[k] += n
    if i >= TRAIN_WARMUP:
      ms.append((t1 - t0) * 1e3)
    losses.append(float(loss))
    check(losses[-1] == losses[-1] and abs(losses[-1]) < float("inf"),
          f"train_zoo step {i}: loss {losses[-1]}")
    share = []
    for n, h in hit.items():
      check(torch.equal(fused_rows(n, miss[n]), miss_rows[n]),
            f"train_zoo step {i}: rows of {n} no id touches changed")
      share.append((fused_rows(n, h[i % 2]) != before[n]).any(dim=1).float()
                   .mean().item())
    changed.append(min(share))
    check(changed[-1] > 0.5, f"train_zoo step {i}: only {changed[-1]:.1%} "
          "of the sampled touched rows of a class changed")
  peak = torch.cuda.max_memory_allocated() / 2**30
  med = statistics.median(ms)
  emit({"phase": "train_zoo", "model": ZOO_MODEL, "card": smi,
        "batch": ZOO_BATCH, "alpha": ZOO_ALPHA, "rule": "adagrad",
        "lr": ZOO_LR, "compute": "f32",
        "tables": len(plan.global_configs), "inputs": len(hot),
        "sparse_classes": [class_param_name(*k) for k in sparse],
        "sparse_buckets": [[b.h, b.n_b] for b in buckets],
        "sparse_occurrences_per_step": occurrences,
        "dense_class_tables": sum(len(cp.shards_per_rank[0])
                                  for cp in plan.classes.values()
                                  if cp.kind == "dense"),
        "fused_bytes": sum(t.numel() * 4 for t in state["fused"].values()),
        "init_s": init_s, "step_ms": ms, "step_ms_median": med,
        "samples_per_s": ZOO_BATCH / (med / 1e3), "peak_gib": peak,
        "launches_per_step": want, "losses": losses,
        "untouched_logical_rows": {n: int(((hits[0][n] == 0)
                                           & (hits[1][n] == 0)).sum().item())
                                   for n in layouts},
        "touched_rows_changed_share": changed,
        "untouched_rows_bit_equal": True, "pin": pin})
  emit({"phase": "train_zoo_trace", "card": smi,
        **trace_call(torch, lambda: step(state, *batches[0]))})
  del state, step, hits, miss_rows
  torch.cuda.empty_cache()
  return {"train_zoo": totals, "train_zoo_pin": pin_counts}


def kernel_entry(name, row, launches, by_path) -> dict:
  return {"name": name, "route": "cuda", "source": f"{CSRC}/{name}.cu",
          "replaces": REPLACES[name], "launches": launches,
          "launches_by_path": by_path, "max_abs_err": row["max_abs_err"],
          "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
          "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
          "library_ms": row["library_ms"]}


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; this smoke "
          "runs on an NVIDIA H100 only", file=sys.stderr)
    return 2
  from distributed_embeddings_torch.ops import _build
  from distributed_embeddings_torch.ops import cuda_apply as ca
  from distributed_embeddings_torch.ops import cuda_delta as cd
  from distributed_embeddings_torch.ops import cuda_exchange as cx
  from distributed_embeddings_torch.ops import cuda_interact as ci
  from distributed_embeddings_torch.ops import cuda_layout as cl
  from distributed_embeddings_torch.serving import golden

  # f32 products stay f32 (PyTorch's defaults, stated)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = nvidia_smi()
  cap = torch.cuda.get_device_capability(0)
  emit({"phase": "device", "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0), "capability": list(cap),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda})
  check(cap == (9, 0), f"compute capability {cap}, not (9, 0)")

  t0 = time.perf_counter()
  _build.build_all(_build.KERNELS)
  emit({"phase": "build", "kernels": list(_build.KERNELS),
        "seconds": time.perf_counter() - t0,
        "ptxas": [ln.strip() for name in _build.KERNELS
                  for ln in _build.BUILD_LOG[name].splitlines()
                  if "registers" in ln or "spill" in ln]})

  flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
  warm_up(torch)
  rows = {"interact_fwd": phase_kernel_fwd(torch, ci, flush),
          "interact_bwd": phase_kernel_bwd(torch, ci, flush)}
  torch.cuda.empty_cache()
  rows["apply_rows"] = phase_kernel_apply(
      torch, ca, flush, first_sparse_class(train_plan())[2])
  torch.cuda.empty_cache()
  phase_kernel_apply_zoo(torch, ca, flush)
  rows["gather_rows"] = phase_kernel_gather(torch, cx, flush)
  rows["build_delta_rows"] = phase_kernel_delta(torch, cd, flush)
  rows["row_major"] = phase_kernel_layout(torch, cl, flush)
  del flush
  torch.cuda.empty_cache()
  phase_golden(torch, golden)
  phase_train_golden(torch)
  phase_zoo_golden(torch)

  by_path = {}
  serve = phase_serve(torch, ci, smi)
  by_path["serve"] = {"interact_fwd": serve}
  for compute in ("f32", "bf16"):
    by_path[f"train_{compute}"] = phase_train(torch, ci, ca, cx, smi,
                                              compute)
  torch.cuda.empty_cache()
  by_path.update(phase_train_zoo(torch, (cd, ca, cl, cx, ci), smi))
  for path, name in (("train_zoo", "build_delta_rows"),
                     ("train_zoo", "apply_rows"),
                     ("train_zoo_pin", "row_major")):
    check(by_path[path][name] > 0, f"the {path} path never launched {name}")
  torch.cuda.empty_cache()
  by_path["train_world4"] = phase_world4(torch, smi)
  for name in W4_KERNELS:
    check(by_path["train_world4"][name] > 0,
          f"the world-4 path never launched {name}")

  by_path = {path: {name: p.get(name, 0) for name in _build.KERNELS}
             for path, p in by_path.items()}
  emit({"kernels": [
      kernel_entry(name, rows[name],
                   sum(p[name] for p in by_path.values()),
                   {path: p[name] for path, p in by_path.items()})
      for name in _build.KERNELS]})
  print(smi, flush=True)
  emit({"ok": True, "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}})
  return 0


if __name__ == "__main__":
  try:
    sys.exit(main())
  except SmokeFailure as exc:
    print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
    sys.exit(1)
