"""Spawned gloo ranks for the PyTorch port's world > 1 tests.

The port runs a world-N step as N processes over ``torch.distributed``;
its collectives only exist across real processes, so the tests spawn
them: ``world`` Python processes on a localhost rendezvous, gloo on the
CPU, one torch thread each. The workers import torch and the port only
(never JAX). A job is a function of this module, ``job(mesh, spec)``,
that every rank runs; ``spec`` comes from a pickle the test writes, and
each rank writes its own result pickle. The test process compares the
results with the JAX package.

Usage::

    from torch_ranks import spawn
    results = spawn(tmp_path, 4, "train_job", spec)   # one dict per rank
"""

import os
import pickle
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUNNER = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
import torch_ranks
torch_ranks._worker(*sys.argv[2:])
"""


def free_port() -> int:
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def spawn(tmp_path, world: int, job: str, spec, timeout_s: float = 300.0):
  """Run ``job`` on ``world`` gloo ranks; returns each rank's result."""
  spec_path = os.path.join(str(tmp_path), f"{job}_spec.pkl")
  with open(spec_path, "wb") as f:
    pickle.dump(spec, f)
  port = free_port()
  env = {k: v for k, v in os.environ.items()
         if k not in ("PYTHONPATH", "XLA_FLAGS", "OMP_NUM_THREADS")}
  env["OMP_NUM_THREADS"] = "1"
  procs = [subprocess.Popen(
      [sys.executable, "-c", _RUNNER, REPO, job, str(rank), str(world),
       str(port), spec_path],
      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
      for rank in range(world)]
  outs = []
  try:
    for p in procs:
      out, _ = p.communicate(timeout=timeout_s)
      outs.append(out)
  finally:
    for p in procs:  # a hung rank must not outlive the test
      if p.poll() is None:
        p.kill()
        p.wait()
  for rank, (p, out) in enumerate(zip(procs, outs)):
    assert p.returncode == 0, f"rank {rank} rc={p.returncode}\n{out[-4000:]}"
  results = []
  for rank in range(world):
    with open(f"{spec_path}.{rank}.out", "rb") as f:
      results.append(pickle.load(f))
  return results


def _worker(job, rank, world, port, spec_path):
  import torch
  torch.set_num_threads(1)
  from distributed_embeddings_torch.parallel.mesh import create_mesh
  mesh = create_mesh(int(world), int(rank),
                     f"tcp://127.0.0.1:{port}", device="cpu")
  with open(spec_path, "rb") as f:
    spec = pickle.load(f)
  try:
    result = globals()[job](mesh, spec)
  finally:
    mesh.close()
  with open(f"{spec_path}.{rank}.out", "wb") as f:
    pickle.dump(result, f)


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------


def wire_job(mesh, spec):
  """Every schedule of the wire on the same dest-major payloads, forward
  and backward: ``spec['x'][rank]`` is this rank's ``[world, ...]``
  float payload, ``spec['ids'][rank]`` its int payload."""
  import torch

  from distributed_embeddings_torch.parallel import wire

  x = torch.tensor(spec["x"][mesh.rank])
  ids = torch.tensor(spec["ids"][mesh.rank])
  ct = torch.tensor(spec["ct"][mesh.rank])
  out = {"ids/mono": wire.exchange_ids(ids, mesh).numpy()}
  for c in spec["chunks"]:
    out[f"ids/pipe{c}"] = wire.pipelined_exchange_ids(ids, mesh, c).numpy()

  def fwd_bwd(fn):
    leaf = x.clone().requires_grad_(True)
    y = fn(leaf)
    y.backward(ct)
    return y.detach().numpy(), leaf.grad.numpy()

  out["f32/mono"] = fwd_bwd(lambda t: wire.float_all_to_all(t, mesh))
  out["bf16/mono"] = fwd_bwd(
      lambda t: wire.float_all_to_all(t, mesh, torch.bfloat16))
  for c in spec["chunks"]:
    out[f"f32/pipe{c}"] = fwd_bwd(
        lambda t, c=c: wire.pipelined_float_exchange(t, mesh, None, c))
    out[f"bf16/pipe{c}"] = fwd_bwd(
        lambda t, c=c: wire.pipelined_float_exchange(t, mesh,
                                                     torch.bfloat16, c))
  world = mesh.world

  def fused(t, wd=None):
    # round k ships my block for rank (i + k) % world; placed source-major
    i = mesh.rank
    got = [wire.fused_block_send(t[(i + k) % world], mesh, k, wd)
           for k in range(world)]
    return torch.stack([got[(i - j) % world] for j in range(world)])

  out["f32/fused"] = fwd_bwd(fused)
  out["bf16/fused"] = fwd_bwd(lambda t: fused(t, torch.bfloat16))
  out["gather"] = wire.gather_blocks(x[0], mesh).numpy()
  return out


def _train_plan(spec, overlap, chunks):
  from distributed_embeddings_torch.layers.embedding import TableConfig
  from distributed_embeddings_torch.layers.planner import (
      DistEmbeddingStrategy,
  )
  tables = [TableConfig(input_dim=v, output_dim=spec["dim"],
                        combiner=spec["combiner"].get(i))
            for i, v in enumerate(spec["vocab"])]
  return DistEmbeddingStrategy(
      tables, spec["world"], spec["strategy"],
      dense_row_threshold=spec["dense_row_threshold"],
      row_slice_threshold=spec["row_slice"], batch_hint=spec["batch"],
      overlap=overlap, exchange_chunks=chunks)


def train_job(mesh, spec):
  """Three steps of the port's world-N train step from the JAX initial
  state, per schedule in ``spec['schedules']``; then the eval step. Every
  rank returns the global final state (gathered, and unpacked to the
  simple layout), the losses and the global predictions. With
  ``spec['tables']`` (simple-layout tables) it also packs them into rank
  blocks with ``init_sparse_state`` and returns the gathered buffers."""
  import functools

  import torch

  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.convert import train_state_from_flax
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops import packed_table as tpt
  from distributed_embeddings_torch.parallel import wire

  out = {}
  for overlap, chunks in spec["schedules"]:
    plan = _train_plan(spec, overlap, chunks)
    model = DLRM(spec["vocab"], spec["dim"], bottom_mlp=spec["bottom"],
                 top_mlp=spec["top"], num_numerical=spec["num"],
                 device="cpu")
    rule = getattr(tpt, f"{spec['rule']}_rule")(spec["lr"])
    sgd = functools.partial(torch.optim.SGD, lr=spec["lr"])
    state = train_state_from_flax(spec["state"], mesh=mesh)
    step = ttr.make_sparse_train_step(model, plan, bce_loss, sgd, rule,
                                      mesh=mesh)
    losses = []
    for numerical, cats, labels in spec["batches"]:
      num_d, cats_d, lab_d = ttr.shard_batch(
          (numerical, list(cats), labels), mesh, device="cpu")
      state, loss = step(state, num_d, cats_d, lab_d)
      losses.append(float(loss))
    ev = ttr.make_sparse_eval_step(model, plan, rule, mesh=mesh)
    numerical, cats = spec["eval_batch"]
    num_d, cats_d = ttr.shard_batch((numerical, list(cats)), mesh,
                                    device="cpu")
    preds = wire.gather_blocks(ev(state, num_d, cats_d), mesh)
    params, aux = ttr.unpack_sparse_state(plan, rule, state,
                                          include_aux=True, mesh=mesh)
    out[overlap] = {
        "unpacked": ({k: v.numpy() for k, v in params["embeddings"].items()},
                     {k: [a.numpy() for a in v] for k, v in aux.items()}),
        "losses": losses,
        "fused": {k: wire.gather_blocks(v, mesh).numpy()
                  for k, v in state["fused"].items()},
        "emb_dense": {k: wire.gather_blocks(v.detach(), mesh).numpy()
                      for k, v in state["emb_dense"].items()},
        "dense": {k: v.detach().numpy() for k, v in state["dense"].items()},
        "preds": preds.numpy(), "step": state["step"]}
  if "tables" in spec:
    # init_sparse_state per rank, on the JAX package's simple-layout tables
    plan = _train_plan(spec, "none", 1)
    tables = {k: torch.tensor(v) for k, v in spec["tables"].items()}
    model = DLRM(spec["vocab"], spec["dim"], bottom_mlp=spec["bottom"],
                 top_mlp=spec["top"], num_numerical=spec["num"],
                 device="cpu")
    state = ttr.init_sparse_state(
        plan, {"embeddings": tables, **model.state_dict()}, rule,
        functools.partial(torch.optim.SGD, lr=spec["lr"]), mesh=mesh)
    out["init_fused"] = {k: wire.gather_blocks(v, mesh).numpy()
                         for k, v in state["fused"].items()}
  return out


def golden_job(mesh, spec):
  """The committed world-4 golden replayed under each ``(overlap,
  chunks, compute)`` of ``spec['schedules']``; rank 0 returns
  ``{overlap/chunks/compute: (losses, global final state, global
  preds)}``."""
  from distributed_embeddings_torch import train_golden

  golden = train_golden.load(train_golden.WORLD4_PATH)
  out = {f"{ov}/{ch}/{cd}": train_golden.replay_world4(golden, mesh, ov, ch,
                                                       cd)
         for ov, ch, cd in spec["schedules"]}
  return out if mesh.rank == 0 else None
