#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``distributed_embeddings_torch``) on one
NVIDIA H100.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It builds the port's CUDA kernels from ``distributed_embeddings_torch/
csrc/`` and drives the port's main path, DLRM serving on frozen tables,
on the card. One JSON line per phase:

1. ``device``: the card (``nvidia-smi`` name and power limit), which
   must have compute capability (9, 0);
2. ``build``: every kernel compiled with ``nvcc`` for ``sm_90a``;
3. ``kernel``: K2-fwd (``interact_fwd``) against its plain PyTorch
   version at F=27, D=128, k in {-1, 0}, B in {4096, 65536, 4000}: at
   least 99.9% of the cells bit-equal and every cell within one bf16 ulp
   (only the f32 summation order differs). Times are medians of CUDA-event
   timings of single launches, kernel, plain and library in turns, with
   the 50 MB L2 flushed and the card held busy while the host queues
   each call, after two seconds of warm-up;
4. ``golden``: the JAX package's serve golden
   (``tests/data/torch_serve_golden.npz``) replayed through the port's
   ``ServeEngine``: activations bit-equal, predictions within
   ``serving.golden.PRED_TOL``;
5. ``serve``: the full-width DLRM of ``bench.py`` (26 Criteo-1TB tables
   x 1/16, width 128, dense_row_threshold=4096, bf16 compute, one-hot
   ids, world 1), its packed tables drawn on the card from a seeded
   generator, frozen to f32 and to int8; per image a ``ServeEngine``
   answers 3 requests of batch 4096. The predictions are finite, agree
   with a recomputation through the plain interaction, and K2-fwd ran
   once per request. A fourth request per image runs under
   ``torch.profiler`` (``serve_trace``): the device's busy time and idle
   share, and the costliest device operations;

then the ``kernels`` line, the ``nvidia-smi`` line and, last, the
contract line ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before the last line; so does a machine without CUDA.
"""

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
TIMING_REPS = 50
SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's clocks
# published H100 SXM peaks (NVIDIA data sheet): HBM3 rate, dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
CRITEO_1TB_VOCAB = [
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36
]
REPLACES = "distributed_embeddings_tpu/ops/pallas_interact.py:139"
SOURCE = "distributed_embeddings_torch/csrc/interact_fwd.cu"


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
  flushed before each call (the serve step finds the interaction's
  inputs cold at large B). A spin of about a millisecond on the card
  precedes each start event, so the host has queued the whole call
  before the card reaches it: the time is the card's, not the host's
  launch latency."""
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


def warm_up(torch, seconds: float = 2.0) -> None:
  """Keep the card busy with bf16 matrix products for ``seconds``, so the
  timings that follow do not start from idle clocks."""
  a = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
  t0 = time.perf_counter()
  while time.perf_counter() - t0 < seconds:
    for _ in range(50):
      a @ a
    torch.cuda.synchronize()


def within_one_bf16_ulp(torch, got, want) -> tuple:
  """(cells that differ, max |got - want| / one bf16 ulp)."""
  differ = int((got != want).sum().item())
  _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
  ulp = torch.ldexp(torch.ones_like(got), e - 8)
  return differ, ((got - want).abs() / ulp).max().item()


def phase_kernel(torch, ci, flush) -> dict:
  """K2-fwd against its plain version; returns the main-path row."""
  main = None
  for b in KERNEL_BATCHES:
    for k in (-1, 0):
      gen = torch.Generator(device="cuda").manual_seed(SEED + b - k)
      parts = [(torch.randn((b, D), generator=gen, device="cuda") * 0.3)
               .to(torch.bfloat16) for _ in range(F)]
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
      bytes_moved = b * (F * D * 2 + npair * 4)
      flops = 2 * npair * D * b
      bound_ms = max(bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
      timed = event_ms(torch, {
          "kernel_ms": lambda: ci.interact_parts_fwd(parts, k),
          "plain_ms": lambda: ci.interact_parts_fwd_plain(parts, k),
          "library_ms": library}, flush)
      row = {
          "phase": "kernel", "name": "interact_fwd", "B": b, "F": F, "D": D,
          "k": k, "cells": got.numel(), "cells_differ": differ,
          "max_ulp": ulps, "max_abs_err": (got - want).abs().max().item(),
          **timed, "bound_ms": bound_ms,
          "bound_by": "bytes" if bytes_moved / HBM_BYTES_PER_S
                      >= flops / BF16_FLOPS else "operations"}
      emit(row)
      if b == SERVE_BATCH and k == -1:
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


def build_train_state(torch, plan, rule, model):
  """Packed sparse buffers and dense-class tables drawn on the card
  (uniform in +-1/sqrt(vocab), the DLRM initializer's distribution)."""
  from distributed_embeddings_torch.models.dlrm import dlrm_scale_rows
  from distributed_embeddings_torch.ops.packed_table import (
      PackedLayout,
      init_packed_uniform,
  )
  from distributed_embeddings_torch.parallel.lookup_engine import (
      class_param_name,
      padded_rows,
  )
  gen = torch.Generator(device="cuda").manual_seed(SEED)
  fused, emb_dense = {}, {}
  for key in plan.class_keys:
    cp = plan.classes[key]
    rows = padded_rows(plan, key)
    scale = torch.as_tensor(dlrm_scale_rows(plan, key), device="cuda")
    if cp.kind == "sparse":
      fused[class_param_name(*key)] = init_packed_uniform(
          PackedLayout(rows, cp.width, rule.n_aux), gen, scale,
          rule.aux_init, device="cuda")
    else:
      table = torch.rand((rows, cp.width), generator=gen, device="cuda")
      emb_dense[class_param_name(*key)] = (table * 2 - 1) * scale[:, None]
  return {"fused": fused, "emb_dense": emb_dense,
          "dense": model.state_dict()}


def plain_forward(torch, ci, model, numerical, acts):
  """The DLRM forward with the plain interaction in place of K2-fwd."""
  cd = model.compute_dtype
  bottom = model.bottom_mlp(numerical.to(cd))
  parts = [bottom.to(torch.bfloat16)] + [a.to(torch.bfloat16) for a in acts]
  x = torch.cat([ci.interact_parts_fwd_plain(parts, -1), bottom.float()], 1)
  return model.top_mlp(x.to(cd)).squeeze(-1).float()


def trace_request(torch, eng, numerical, cats) -> dict:
  """One more request under ``torch.profiler``: its host wall time, the
  device's busy time (kernels, copies and fills on the card) and idle
  share, the device operations it ran and the costliest of them."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    eng.predict(numerical, cats)
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
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
  return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
          "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
          "device_ops": len(spans),
          "top_ms": [[name[:72], ms] for name, ms in top]}


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

  vocab = [max(4, int(v / 16)) for v in CRITEO_1TB_VOCAB]
  plan = dlrm_embedding_plan(vocab, D, dense_row_threshold=4096)
  rule = sgd_rule(24.0)
  dense_tables = sum(len(cp.shards_per_rank[0])
                     for cp in plan.classes.values() if cp.kind == "dense")
  model = DLRM(vocab, D, compute_dtype=torch.bfloat16, device="cuda",
               generator=torch.Generator().manual_seed(SEED))
  t0 = time.perf_counter()
  state = build_train_state(torch, plan, rule, model)
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
          **trace_request(torch, eng, *requests[0])})
    del eng, frozen
    torch.cuda.empty_cache()
  return launches


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; this smoke "
          "runs on an NVIDIA H100 only", file=sys.stderr)
    return 2
  from distributed_embeddings_torch.ops import _build
  from distributed_embeddings_torch.ops import cuda_interact as ci
  from distributed_embeddings_torch.serving import golden

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
  main_row = phase_kernel(torch, ci, flush)
  del flush
  phase_golden(torch, golden)
  launches = phase_serve(torch, ci, smi)

  emit({"kernels": [{
      "name": "interact_fwd", "route": "cuda", "source": SOURCE,
      "replaces": REPLACES, "launches": launches,
      "max_abs_err": main_row["max_abs_err"], "ms": main_row["kernel_ms"],
      "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
      "bound_by": main_row["bound_by"],
      "library_ms": main_row["library_ms"], "ok": True}]})
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
