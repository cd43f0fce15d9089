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
  return spawn_wait(spawn_start(tmp_path, world, job, spec), timeout_s)


def spawn_start(tmp_path, world: int, job: str, spec):
  """Start ``job`` on ``world`` gloo ranks and return at once (the caller
  can work meanwhile); :func:`spawn_wait` collects the results."""
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
  return procs, spec_path


def spawn_wait(started, timeout_s: float = 300.0):
  """Each rank's result of a :func:`spawn_start`."""
  procs, spec_path = started
  world = len(procs)
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
  out["fp8/mono"] = fwd_bwd(
      lambda t: wire.float_all_to_all(t, mesh, wire.FP8))
  for c in spec["chunks"]:
    out[f"fp8/pipe{c}"] = fwd_bwd(
        lambda t, c=c: wire.pipelined_float_exchange(t, mesh, wire.FP8, c))
  out["fp8/fused"] = fwd_bwd(lambda t: fused(t, wire.FP8))
  out["gather"] = wire.gather_blocks(x[0], mesh).numpy()
  return out


def _train_plan(spec, overlap, chunks, **plan_kw):
  """The port plan of a spec's tables under ``overlap`` and ``chunks``;
  ``plan_kw`` adds plan knobs (the wire's among them)."""
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
      overlap=overlap, exchange_chunks=chunks, **plan_kw)


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
                 tables=False, device="cpu")
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
                 tables=False, device="cpu")
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


def serve_job(mesh, spec):
  """World-N serving from artifacts: per quantize mode, every rank
  exports its blocks of the JAX state's rank view into ``spec['port']``,
  loads that artifact and the JAX package's (``spec['jax']``) with its
  mesh, and answers each global request of ``spec['requests']`` through
  a ``ServeEngine`` on either, and on the in-memory ``FrozenTables``;
  for f32 also through the world-N eval step (``spec['plan_kw']``: more
  plan knobs, the wire's). Returns every global prediction this rank
  saw."""
  import os

  import torch

  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.convert import train_state_from_flax
  from distributed_embeddings_torch.models import DLRM
  from distributed_embeddings_torch.ops.packed_table import sgd_rule
  from distributed_embeddings_torch.parallel import wire
  from distributed_embeddings_torch.serving import (
      ServeEngine,
      export,
      freeze,
      load,
  )

  plan = _train_plan(spec, "fused", 2, **spec.get("plan_kw", {}))
  rule = sgd_rule(spec["lr"])
  state = train_state_from_flax(spec["state"], mesh=mesh)

  def model():
    return DLRM(spec["vocab"], spec["dim"], bottom_mlp=spec["bottom"],
                top_mlp=spec["top"], num_numerical=spec["num"],
                tables=False, device="cpu")

  def answers(eng):
    return [eng.predict(numerical, list(cats))
            for numerical, cats in spec["requests"]]

  out = {}
  for q in spec["quantize"]:
    path = os.path.join(spec["port"], q)
    export(path, plan, rule, state, quantize=q, mesh=mesh)
    art = load(path, plan, mesh=mesh)
    got = {"port": answers(ServeEngine(model(), plan, art, mesh=mesh)),
           "jax": answers(ServeEngine(
               model(), plan, load(os.path.join(spec["jax"], q), plan,
                                   mesh=mesh), mesh=mesh)),
           "frozen": answers(ServeEngine(
               model(), plan, freeze(plan, rule, state, q, mesh=mesh),
               mesh=mesh)),
           "blocks": {n: art.rank_block(n, mesh.rank) for n in art.meta}}
    if q == "f32":
      m = model()
      ev = ttr.make_sparse_eval_step(m, plan, rule, mesh=mesh)
      got["eval"] = []
      for numerical, cats in spec["requests"]:
        num_d, cats_d = ttr.shard_batch((numerical, list(cats)), mesh,
                                        device="cpu")
        got["eval"].append(wire.gather_blocks(
            ev(state, num_d, cats_d), mesh).numpy())
    out[q] = got
  torch.distributed.barrier()
  return out


def dense_golden_job(mesh, spec):
  """The committed world-4 dense golden replayed by the port's
  ``make_train_step(mesh=)`` under each ``(overlap, chunks, compute)`` of
  ``spec['schedules']``; every rank returns ``{overlap/chunks/compute:
  (losses, global final params, global preds)}``."""
  from distributed_embeddings_torch import train_golden

  golden = train_golden.load(train_golden.DENSE_WORLD4_PATH)
  return {f"{ov}/{ch}/{cd}": train_golden.replay_dense_world4(
      golden, mesh, ov, ch, cd) for ov, ch, cd in spec["schedules"]}


def _tiny_rec(spec, mesh, overlap, chunks, **wire_kw):
  """A minimal model that owns a ``DistributedEmbedding``: the numerical
  features and every input's activation concatenated into one linear
  head (the flax model of ``tests/test_torch_dense_train_world4.py``);
  ``wire_kw`` sets the layer's wire compression."""
  import torch
  from torch import nn

  from distributed_embeddings_torch.layers.dist_model_parallel import (
      DistributedEmbedding,
  )
  from distributed_embeddings_torch.layers.embedding import TableConfig

  class TinyRec(nn.Module):

    def __init__(self):
      super().__init__()
      self.embeddings = DistributedEmbedding(
          [TableConfig(input_dim=v, output_dim=spec["dim"],
                       combiner=spec["combiner"].get(i))
           for i, v in enumerate(spec["vocab"])], "memory_balanced",
          row_slice=spec["row_slice"], world_size=mesh.world,
          dense_row_threshold=spec["dense_row_threshold"],
          overlap=overlap, exchange_chunks=chunks, mesh=mesh, **wire_kw)
      self.head = nn.Linear(spec["num"] + spec["dim"] * len(spec["vocab"]),
                            1)

    def forward(self, numerical, cats):
      x = torch.cat([numerical] + list(self.embeddings(cats)), dim=1)
      return self.head(x)[:, 0]

  return TinyRec()


def dense_extras_job(mesh, spec):
  """Three steps of ``make_train_step(mesh=)`` on :func:`_tiny_rec` with
  the plan's penalties (``spec['penalties']``: an l2 regularizer, a
  max_norm constraint), a multi-hot ``mean`` input and the port's
  ``training.Adagrad``, per ``(overlap, chunks)`` of
  ``spec['schedules']`` (or ``(overlap, chunks, wire knobs)``, keyed
  ``overlap/chunks/<knob>=<value>...``; ``spec['plan_kw']`` adds plan
  knobs to every run, column slicing), from the JAX init
  ``spec['init']``; every rank returns ``{overlap/chunks: (losses, global
  final params, global preds)}``."""
  import torch

  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.layers.embedding import TableConfig
  from distributed_embeddings_torch.layers.planner import (
      DistEmbeddingStrategy,
  )
  from distributed_embeddings_torch.models import bce_loss
  from distributed_embeddings_torch.parallel import wire

  plan = DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=spec["dim"],
                   combiner=spec["combiner"].get(i),
                   regularizer=spec["penalties"].get(("reg", i)),
                   constraint=spec["penalties"].get(("con", i)))
       for i, v in enumerate(spec["vocab"])], mesh.world, "memory_balanced",
      dense_row_threshold=spec["dense_row_threshold"],
      row_slice_threshold=spec["row_slice"], **spec.get("plan_kw", {}))
  init = {f"embeddings.{k}": v for k, v in spec["init"]["embeddings"].items()}
  init["head.weight"] = spec["init"]["head"]["kernel"].T.copy()
  init["head.bias"] = spec["init"]["head"]["bias"]
  out = {}
  for overlap, chunks, *wire_kw in spec["schedules"]:
    wire_kw = wire_kw[0] if wire_kw else {}
    model = _tiny_rec(spec, mesh, overlap, chunks,
                      **spec.get("plan_kw", {}), **wire_kw)
    assert model.embeddings.plan.class_keys == plan.class_keys
    model.load_state_dict(ttr.shard_params(init, mesh))
    opt = ttr.Adagrad(model.parameters(), lr=spec["lr"])
    step = ttr.make_train_step(
        lambda m, n, c, y: bce_loss(m(n, c), y), opt, model, mesh=mesh,
        plan=plan)
    losses = [float(step(*ttr.shard_batch(
        (numerical, list(cats), labels), mesh, device="cpu")))
        for numerical, cats, labels in spec["batches"]]
    numerical, cats = spec["eval_batch"]
    preds = ttr.make_eval_step(lambda m, n, c: m(n, c), model, mesh)(
        *ttr.shard_batch((numerical, list(cats)), mesh, device="cpu"))
    final = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    for name, p in model.embeddings.class_params().items():
      final[f"embeddings.{name}"] = wire.gather_blocks(p.detach(),
                                                      mesh).numpy()
    key = "/".join([overlap, str(chunks)] + [
        f"{k}={v}" for k, v in sorted(wire_kw.items())])
    out[key] = (losses, final, preds.numpy())
  return out


def hybrid_job(mesh, spec):
  """The hybrid-parallel helpers on a world-N DLRM (``spec['model']``'s
  arguments, ``spec['weights']`` its global tables, ``spec['dense']`` its
  MLPs):

  - ``grads``: this rank's ``loss.backward()`` on its slice of
    ``spec['batch']``, then ``finalize_hybrid_grads``; the class blocks'
    gradients gathered to their global buffers, the MLPs' as they are;
  - ``broadcast``: models whose MLPs were drawn from per-rank seeds,
    before and after ``broadcast_variables`` from rank 0, and whether the
    class blocks stayed bit-equal;
  - ``callback``: whether ``BroadcastGlobalVariablesCallback`` made the
    MLPs equal on its first ``on_batch_end`` and left them alone on its
    second;
  - ``oov``: ``DistributedEmbedding(return_oov=True)`` counters of
    ``spec['oov_inputs']`` (this rank's slice)."""
  import torch

  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.layers import dist_model_parallel as dmp
  from distributed_embeddings_torch.layers.embedding import TableConfig
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.parallel import wire

  def dlrm(seed):
    return DLRM(**spec["model"], world_size=mesh.world, mesh=mesh,
                generator=torch.Generator().manual_seed(seed))

  def mlp_flat(model):
    return torch.cat([p.detach().reshape(-1)
                      for n, p in model.named_parameters()
                      if not n.startswith("embeddings.")]).numpy()

  out = {}
  model = dlrm(0)
  tables = dmp.set_weights(model.embeddings.plan, spec["weights"])
  model.load_state_dict(ttr.shard_params(
      {**spec["dense"], **{f"embeddings.{k}": v for k, v in tables.items()}},
      mesh))
  numerical, cats, labels = ttr.shard_batch(spec["batch"], mesh,
                                            device="cpu")
  bce_loss(model(numerical, cats), labels).backward()
  dmp.finalize_hybrid_grads(model, mesh)
  grads = {}
  for name, p in model.named_parameters():
    g = p.grad
    if name.startswith("embeddings."):
      g = wire.gather_blocks(g, mesh)
    grads[name] = g.numpy()
  out["grads"] = grads

  model = dlrm(100 + mesh.rank)
  blocks = {n: p.detach().clone()
            for n, p in model.embeddings.class_params().items()}
  before = mlp_flat(model)
  dmp.broadcast_variables(model, 0, mesh)
  out["broadcast"] = {
      "before": before, "after": mlp_flat(model),
      "blocks_kept": all(torch.equal(p, blocks[n]) for n, p in
                         model.embeddings.class_params().items())}

  model = dlrm(200 + mesh.rank)
  cb = dmp.BroadcastGlobalVariablesCallback(0, model, mesh)
  cb.on_batch_end(0)
  first = mlp_flat(model)
  with torch.no_grad():
    model.top_mlp.layers[0].bias.add_(float(mesh.rank))
  cb.on_batch_end(1)
  out["callback"] = {"first": first, "second": mlp_flat(model)}

  layer = dmp.DistributedEmbedding(
      [TableConfig(input_dim=v, output_dim=spec["oov_dim"])
       for v in spec["oov_vocab"]], world_size=mesh.world, mesh=mesh)
  inputs = ttr.shard_batch(spec["oov_inputs"], mesh, device="cpu")
  _, oov = layer(inputs, return_oov=True)
  out["oov"] = {k: int(v) for k, v in oov.items()}
  return out



def _ckpt_factory(name, lr):
  import functools

  import torch

  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.utils import data as tdata
  if name == "sched":
    sched = tdata.dlrm_lr_schedule(*lr)
    return lambda ps: ttr.ScheduledSGD(ps, sched)
  return {"adagrad": functools.partial(ttr.Adagrad, lr=lr),
          "momentum": functools.partial(torch.optim.SGD, lr=lr,
                                        momentum=0.9)}[name]


def ckpt_job(mesh, spec):
  """Checkpoints at world N: every rank builds the port's state from the
  JAX initial state (``spec['state']``, its optax states included), and
  either (``spec['mode'] == 'save'``) takes ``spec['n']`` steps, saves at
  ``spec['path']`` and takes the remaining steps, or (``'restore'``)
  restores ``spec['path']`` (written by the JAX package) and takes the
  remaining steps. Each rank returns its own blocks and flat arrays at
  the checkpoint (saved or restored) and at the end, the losses, and at
  the checkpoint the global logical tables and optimizer lanes
  (``get_weights`` of the unpacked state). ``spec['plan_kw']``: more plan
  knobs (column slicing)."""
  import torch

  from distributed_embeddings_torch import checkpoint as tck
  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.convert import train_state_from_flax
  from distributed_embeddings_torch.layers import get_weights
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops import packed_table as tpt
  from distributed_embeddings_torch.utils import data as tdata

  plan = _train_plan(spec, spec["overlap"], spec["chunks"],
                     **spec.get("plan_kw", {}))
  model = DLRM(spec["vocab"], spec["dim"], bottom_mlp=spec["bottom"],
               top_mlp=spec["top"], num_numerical=spec["num"],
               tables=False, device="cpu")
  lr = spec["lr"]
  rule = (tpt.sgd_rule(tdata.dlrm_lr_schedule(*lr)) if spec["rule"] == "sched"
          else getattr(tpt, f"{spec['rule']}_rule")(lr))
  factory = _ckpt_factory(spec["opt"], lr)
  step = ttr.make_sparse_train_step(model, plan, bce_loss, factory, rule,
                                    mesh=mesh)

  def snap(state):
    out = {f"fused/{k}": v.numpy().copy() for k, v in state["fused"].items()}
    out.update({f"emb_dense/{k}": v.detach().numpy().copy()
                for k, v in state["emb_dense"].items()})
    from distributed_embeddings_torch.convert import optax_state_of
    for part in ("dense", "emb_dense"):
      flat = optax_state_of(state[f"{part}_opt"], state[part])
      out.update({f"{part}_opt/{k}": v for k, v in flat.items()})
    out.update({f"dense/{k}": v.detach().numpy().copy()
                for k, v in state["dense"].items()})
    out["step"] = state["step"]
    return out

  def run(state, batches):
    losses = []
    for numerical, cats, labels in batches:
      state, loss = step(state, *ttr.shard_batch(
          (numerical, list(cats), labels), mesh, device="cpu"))
      losses.append(float(loss))
    return state, losses

  state = ttr._with_optimizers(train_state_from_flax(spec["state"],
                                                     mesh=mesh),
                               factory, None)
  n = spec["n"]
  losses = []
  if spec["mode"] == "save":
    state, losses = run(state, spec["batches"][:n])
    tck.save(spec["path"], plan, rule, state, mesh=mesh)
  else:
    state = tck.restore(spec["path"], plan, rule, state, mesh=mesh)
  at_ckpt = snap(state)
  params, aux = ttr.unpack_sparse_state(plan, rule, state, include_aux=True,
                                        mesh=mesh)
  logical = {"tables": get_weights(plan, params["embeddings"])}
  for j in range(rule.n_aux):
    logical[f"aux{j}"] = get_weights(
        plan, {**params["embeddings"],
               **{k: v[j] for k, v in aux.items()}})
  state, more = run(state, spec["batches"][n:])
  return {"at_ckpt": at_ckpt, "logical": logical, "losses": losses + more,
          "final": snap(state)}


def mb_guard_job(mesh, spec):
  """The micro-batched and the guarded sparse step at world N: per entry
  of ``spec['runs']`` (``name``, ``overlap``, ``micro_batches``,
  ``guard``, optionally ``oov``, ``nan_rank``, ``oov_rank``, ``rule``
  (default ``spec['rule']``), ``plan_kw`` (more plan knobs: the wire's,
  column slicing), ``exact`` and ``chunks``) the port's state from the JAX initial state
  (``spec['state']``, the rule's sparse classes, SGD on the dense
  tensors), one step per batch of ``spec['batches']`` (or the run's own
  ``batches``). ``nan_rank`` poisons that rank's slice of the
  batch at the steps ``nan_steps`` only; ``oov_rank`` gives one of that
  rank's ids at the steps ``oov_steps`` a value past its vocabulary. Each
  rank returns, per run, the losses, the metrics (guarded), its own
  arrays before and after every step that the guard skipped (for the
  bit-equality check), and the global final state unpacked to the simple
  layout; with ``eval`` (a global ``(numerical, cats)``) also the eval
  step's OOV metrics and global predictions on the final state."""
  import functools

  import torch

  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.convert import train_state_from_flax
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops import packed_table as tpt
  from distributed_embeddings_torch.parallel import wire
  from distributed_embeddings_torch.resilience import guards

  def arrays(state):
    out = {f"fused/{k}": v.clone() for k, v in state["fused"].items()}
    for part in ("dense", "emb_dense"):
      out.update({f"{part}/{k}": v.detach().clone()
                  for k, v in state[part].items()})
    out["step"] = state["step"]
    return out

  def same(a, b):
    return sorted(k for k in a if not (
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else a[k] == b[k]))

  def counts(m):
    return {k: int(v) for k, v in m.items()}

  out = {}
  for run in spec["runs"]:
    plan = _train_plan(spec, run["overlap"], run.get(
        "chunks", 1 if run["overlap"] == "none" else 2),
                       **run.get("plan_kw", {}))
    plan.oov = run.get("oov", "clip")
    model = DLRM(spec["vocab"], spec["dim"], bottom_mlp=spec["bottom"],
                 top_mlp=spec["top"], num_numerical=spec["num"],
                 tables=False, device="cpu")
    rule = getattr(tpt, f"{run.get('rule', spec['rule'])}_rule")(spec["lr"])
    sgd = functools.partial(torch.optim.SGD, lr=spec["lr"])
    state = train_state_from_flax(spec["state"], mesh=mesh)
    step = ttr.make_sparse_train_step(
        model, plan, bce_loss, sgd, rule, mesh=mesh,
        micro_batches=run["micro_batches"], guard=run["guard"],
        exact=run.get("exact", False))
    losses, metrics, skipped, raised = [], [], [], []
    for i, (numerical, cats, labels) in enumerate(
        run.get("batches", spec["batches"])):
      num_d, cats_d, lab_d = ttr.shard_batch(
          (numerical, list(cats), labels), mesh, device="cpu")
      if run.get("nan_rank") == mesh.rank and i in run.get("nan_steps", ()):
        num_d = torch.full_like(num_d, float("nan"))
      if run.get("oov_rank") == mesh.rank and i in run.get("oov_steps", ()):
        cats_d[0] = cats_d[0].clone()
        cats_d[0][0] = spec["vocab"][0] + 5
      before = arrays(state)
      res = step(state, num_d, cats_d, lab_d)
      state, loss = res[0], res[1]
      losses.append(float(loss))
      if run["guard"]:
        m = res[2]
        metrics.append({"bad_step": int(m["bad_step"]),
                        "oov": counts(m["oov"])})
        if "dedup_overflow" in m:
          metrics[-1]["dedup_overflow"] = counts(m["dedup_overflow"])
        try:
          guards.check_oov(plan, m["oov"])
        except ValueError as e:
          raised.append((i, str(e)))
        if metrics[-1]["bad_step"]:
          skipped.append((i, same(arrays(state), before)))
    if run.get("eval") is not None:
      ev = ttr.make_sparse_eval_step(model, plan, rule, mesh=mesh,
                                     with_metrics=True)
      num_d, cats_d = ttr.shard_batch(run["eval"], mesh, device="cpu")
      preds, m = ev(state, num_d, list(cats_d))
      evaluated = {k: counts(v) for k, v in m.items()}
      evaluated["preds"] = wire.gather_blocks(preds, mesh).numpy()
    params, aux = ttr.unpack_sparse_state(plan, rule, state,
                                          include_aux=True, mesh=mesh)
    out[run["name"]] = {
        "eval": evaluated if run.get("eval") is not None else None,
        "losses": losses, "metrics": metrics, "skipped": skipped,
        "raised": raised, "step": state["step"],
        "unpacked": ({k: v.numpy() for k, v in params["embeddings"].items()},
                     {k: [a.numpy() for a in v] for k, v in aux.items()}),
        "dense": {k: v.detach().numpy() for k, v in state["dense"].items()}}
  return out


def trainer_job(mesh, spec):
  """``ResilientTrainer`` at world N: every rank builds a trainer over the
  guarded step with its mesh (the port's state from the JAX initial
  state ``spec['state']``; ``spec['plan_kw']``: more plan knobs), runs
  the global host batches ``spec['stream'][:spec['split']]`` with a
  snapshot every
  ``spec['snapshot_every']`` committed steps into ``spec['root']``; then
  a fresh trainer resumes the root and runs the rest of the stream from
  its ``consumed`` position. Each rank returns the losses, the resumed
  trainer's summary, its ``train/dedup_overflow/<class>`` counters and
  the global final state unpacked."""
  import functools
  import os

  import torch

  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.convert import train_state_from_flax
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops import packed_table as tpt
  from distributed_embeddings_torch.resilience.trainer import (
      ResilientTrainer,
  )
  from distributed_embeddings_torch.telemetry import MetricsRegistry

  plan = _train_plan(spec, spec["overlap"],
                     1 if spec["overlap"] == "none" else 2,
                     **spec.get("plan_kw", {}))
  model = DLRM(spec["vocab"], spec["dim"], bottom_mlp=spec["bottom"],
               top_mlp=spec["top"], num_numerical=spec["num"],
               tables=False, device="cpu")
  rule = getattr(tpt, f"{spec['rule']}_rule")(spec["lr"])
  sgd = functools.partial(torch.optim.SGD, lr=spec["lr"])
  step = ttr.make_sparse_train_step(model, plan, bce_loss, sgd, rule,
                                    mesh=mesh, guard=True)

  def trainer():
    state = ttr._with_optimizers(
        train_state_from_flax(spec["state"], mesh=mesh), sgd, None)
    return ResilientTrainer(step, state, plan, rule, spec["root"],
                            mesh=mesh, snapshot_every=spec["snapshot_every"],
                            telemetry=MetricsRegistry())

  first = trainer()
  losses = first.run(spec["stream"][:spec["split"]])
  second = trainer()
  resumed_at = second.consumed
  losses = losses[:resumed_at] + second.run(spec["stream"][resumed_at:])
  summary = second.metrics_summary()
  summary["resumed_from"] = os.path.basename(summary["resumed_from"] or "")
  counters = {k: v for k, v in
              second.telemetry.state_dict()["counters"].items()
              if k.startswith("train/dedup_overflow/")}
  params, aux = ttr.unpack_sparse_state(plan, rule, second.state,
                                        include_aux=True, mesh=mesh)
  return {"losses": losses, "summary": summary, "resumed_at": resumed_at,
          "dedup_overflow_counters": counters,
          "unpacked": ({k: v.numpy()
                        for k, v in params["embeddings"].items()},
                       {k: [a.numpy() for a in v] for k, v in aux.items()}),
          "dense": {k: v.detach().numpy()
                    for k, v in second.state["dense"].items()}}


def _plan_of(case, world):
  """A port plan from a picklable case: ``case['tables']`` as ``(vocab,
  width, combiner)`` triples, ``case['strategy']`` and the plan keywords
  ``case['plan_kw']`` (the wire knobs among them)."""
  from distributed_embeddings_torch.layers.embedding import TableConfig
  from distributed_embeddings_torch.layers.planner import (
      DistEmbeddingStrategy,
  )
  return DistEmbeddingStrategy(
      [TableConfig(input_dim=v, output_dim=w, combiner=c)
       for v, w, c in case["tables"]], world, case["strategy"],
      **case["plan_kw"])


def wire_forward_job(mesh, spec):
  """``DistributedLookup.forward`` at world N for each case of
  ``spec['cases']`` (a plan, its global simple-layout class params
  ``params`` and global ids ``inputs``): every rank looks up its rank's
  blocks and its slice of the batch; returns ``{name: the global
  outputs}`` (the ranks' slices gathered in rank order), and for the
  cases with ``backward`` the gathered global class gradients of
  ``sum(out * ct)`` for the global cotangents ``ct``."""
  import torch

  from distributed_embeddings_torch.parallel import wire
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
  )
  from distributed_embeddings_torch.training import shard_batch, shard_params

  out = {}
  for name, case in spec["cases"].items():
    plan = _plan_of(case, mesh.world)
    engine = DistributedLookup(plan, mesh=mesh)
    params = {k: v.requires_grad_(True) for k, v in shard_params(
        case["params"], mesh, device="cpu").items()}
    inputs = shard_batch(list(case["inputs"]), mesh, device="cpu")
    outs = engine.forward(params, inputs)
    got = {"outs": [wire.gather_blocks(o.detach(), mesh).numpy()
                    for o in outs]}
    if case.get("route"):
      # the ragged buckets' exchanged (vals, lens), this rank's
      got["routed"] = {repr(tuple(bk)): tuple(t.numpy() for t in ids)
                       for bk, ids in engine.route_ids(inputs).items()
                       if isinstance(ids, tuple)}
    if "ct" in case:
      cts = shard_batch(list(case["ct"]), mesh, device="cpu")
      sum((o * c).sum() for o, c in zip(outs, cts)).backward()
      got["grads"] = {k: wire.gather_blocks(v.grad, mesh).numpy()
                      for k, v in params.items()}
    out[name] = got
  return out


def mp_input_job(mesh, spec):
  """Model-parallel input mode at world N, per case of ``spec['cases']``
  (a plan, its global class params ``params``, the ranks' global-batch
  inputs ``per_rank``, ``hotness``, the same batch as dp inputs
  ``inputs`` and global cotangents ``ct``): ``pack_mp_inputs``, this
  rank's block through ``forward_mp`` and through a
  ``DistributedEmbedding(dp_input=False)``, and the dp-input forward of
  the batch; per form the gathered global outputs and, for the engine's
  two forms, the gathered class gradients of ``sum(out * ct)``."""
  from distributed_embeddings_torch.layers.dist_model_parallel import (
      DistributedEmbedding,
  )
  from distributed_embeddings_torch.layers.embedding import TableConfig
  from distributed_embeddings_torch.parallel import wire
  from distributed_embeddings_torch.parallel.lookup_engine import (
      DistributedLookup,
      pack_mp_inputs,
  )
  from distributed_embeddings_torch.training import shard_batch, shard_params

  out = {}
  for name, case in spec["cases"].items():
    plan = _plan_of(case, mesh.world)
    engine = DistributedLookup(plan, mesh=mesh)
    packed = pack_mp_inputs(plan, case["per_rank"], case["hotness"])
    block = shard_batch(packed, mesh, device="cpu")
    cts = shard_batch(list(case["ct"]), mesh, device="cpu")
    got = {"packed": {k: v.numpy() for k, v in packed.items()}}
    for form in ("mp", "dp"):
      params = {k: v.requires_grad_(True) for k, v in shard_params(
          case["params"], mesh, device="cpu").items()}
      if form == "mp":
        outs = engine.forward_mp(params, block, case["hotness"])
      else:
        outs = engine.forward(params, shard_batch(list(case["inputs"]), mesh,
                                                  device="cpu"))
      sum((o * c).sum() for o, c in zip(outs, cts)).backward()
      got[form] = {
          "outs": [wire.gather_blocks(o.detach(), mesh).numpy()
                   for o in outs],
          "grads": {k: wire.gather_blocks(v.grad, mesh).numpy()
                    for k, v in params.items()}}
    layer = DistributedEmbedding(
        [TableConfig(input_dim=v, output_dim=w, combiner=c)
         for v, w, c in case["tables"]], case["strategy"],
        world_size=mesh.world, dp_input=False,
        input_hotness=case["hotness"], mesh=mesh, device="cpu",
        **{k: v for k, v in case["plan_kw"].items()
           if k == "dense_row_threshold"})
    layer.load_state_dict(shard_params(case["params"], mesh, device="cpu"))
    got["layer"] = [wire.gather_blocks(o.detach(), mesh).numpy()
                    for o in layer(block)]
    out[name] = got
  return out


def multi_job(mesh, spec):
  """Several jobs of this module in one spawn: ``spec['jobs']`` maps a
  name to ``(job, job_spec)``; returns ``{name: that job's result}``."""
  return {name: globals()[job](mesh, job_spec)
          for name, (job, job_spec) in spec["jobs"].items()}


def zoo_dense_job(mesh, spec):
  """The synthetic zoo's dense-autodiff step at world N: per entry of
  ``spec['runs']`` (``name``, ``dense_row_threshold``, ``init``: the JAX
  model's global param tree) a ``SyntheticModel(spec['config'], mesh=)``
  holding this rank's blocks of ``init``, ``training.Adagrad(spec['lr'])``
  and ``make_train_step(mesh=)`` over ``spec['batch']`` (global) for
  ``spec['steps']`` steps. Every rank returns per run the losses and the
  global final class buffers."""
  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.convert import (
      synthetic_state_dict_from_flax,
  )
  from distributed_embeddings_torch.models import SyntheticModel, bce_loss
  from distributed_embeddings_torch.parallel import wire

  out = {}
  for run in spec["runs"]:
    model = SyntheticModel(spec["config"], world_size=mesh.world, mesh=mesh,
                           dense_row_threshold=run["dense_row_threshold"])
    model.load_state_dict(synthetic_state_dict_from_flax(run["init"],
                                                         mesh=mesh))
    opt = ttr.Adagrad(model.parameters(), lr=spec["lr"])
    step = ttr.make_train_step(
        lambda m, n, c, y: bce_loss(m(n, c), y), opt, model, mesh=mesh)
    batch = ttr.shard_batch(spec["batch"], mesh, device="cpu")
    losses = [float(step(*batch)) for _ in range(spec["steps"])]
    out[run["name"]] = {
        "losses": losses,
        "classes": {n: wire.gather_blocks(p.detach(), mesh).numpy()
                    for n, p in model.embeddings.class_params().items()}}
  return out


def zoo_plan_job(mesh, spec):
  """``utils.zoo_bench.run_zoo_plan_step`` at world N from the JAX
  recipe's initial state (``spec['state']``, global, numpy leaves); every
  rank returns the result dict."""
  from distributed_embeddings_torch.convert import zoo_train_state_from_flax
  from distributed_embeddings_torch.utils.zoo_bench import run_zoo_plan_step

  state = zoo_train_state_from_flax(spec["state"], mesh=mesh)
  return run_zoo_plan_step(spec["name"], mesh, mesh.world, state=state,
                           **spec.get("kw", {}))


def narrow_job(mesh, spec):
  """Narrow storage (bf16 tables) at world N: per entry of
  ``spec['runs']`` (``name``, ``rule``, ``overlap``, ``chunks``,
  optionally ``plan_kw``, ``state``, the key of its initial state,
  default the rule's, ``batches``, the key of its batches and eval batch
  in ``spec['batch_sets']`` (default ``spec['batches']`` and
  ``spec['eval']``), ``guard``, and ``rule_lr``, the rule's learning rate,
  default ``spec['lr']``) the port's state from the JAX bf16
  initial state (``spec['states'][state]``), SGD on the dense tensors,
  one step per batch, then the eval step. Returns per run the losses (and
  a guarded step's metrics), the buffers' dtypes, the global final tables
  and optimizer lanes as their ``uint16`` bits, the dense parameters and
  the global predictions."""
  import functools

  import torch

  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.convert import train_state_from_flax
  from distributed_embeddings_torch.hostarrays import numpy_of
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops import packed_table as tpt
  from distributed_embeddings_torch.parallel import wire

  out = {}
  for run in spec["runs"]:
    plan = _train_plan(spec, run["overlap"], run["chunks"],
                       **run.get("plan_kw", {}))
    model = DLRM(spec["vocab"], spec["dim"], bottom_mlp=spec["bottom"],
                 top_mlp=spec["top"], num_numerical=spec["num"],
                 tables=False, device="cpu")
    rule = getattr(tpt, f"{run['rule']}_rule")(run.get("rule_lr",
                                                        spec["lr"]))
    state = train_state_from_flax(
        spec["states"][run.get("state", run["rule"])], mesh=mesh)
    guard = run.get("guard", False)
    step = ttr.make_sparse_train_step(
        model, plan, bce_loss,
        functools.partial(torch.optim.SGD, lr=spec["lr"]), rule, mesh=mesh,
        guard=guard)
    batches, eval_batch = (spec["batch_sets"][run["batches"]]
                           if "batches" in run
                           else (spec["batches"], spec["eval"]))
    losses, metrics = [], []
    for numerical, cats, labels in batches:
      res = step(state, *ttr.shard_batch(
          (numerical, list(cats), labels), mesh, device="cpu"))
      state = res[0]
      losses.append(float(res[1]))
      if guard:
        metrics.append({k: int(v) if isinstance(v, torch.Tensor) else
                        {n: int(c) for n, c in v.items()}
                        for k, v in res[2].items()})
    # a capped plan's eval step carries its metrics (the JAX builder's rule)
    ev = ttr.make_sparse_eval_step(model, plan, rule, mesh=mesh,
                                   with_metrics=guard)
    preds = ev(state, *ttr.shard_batch(eval_batch, mesh, device="cpu"))
    if guard:
      preds = preds[0]
    params, aux = ttr.unpack_sparse_state(plan, rule, state,
                                          include_aux=True, mesh=mesh)
    out[run["name"]] = {
        "losses": losses, "metrics": metrics,
        "dtypes": {k: str(v.dtype) for part in ("fused", "emb_dense")
                   for k, v in state[part].items()},
        "tables": {k: numpy_of(v) for k, v in params["embeddings"].items()},
        "aux": {k: [numpy_of(a) for a in v] for k, v in aux.items()},
        "dense": {k: v.detach().numpy() for k, v in state["dense"].items()},
        "preds": wire.gather_blocks(preds, mesh).numpy()}
  return out


def _tiered_setup(mesh, spec, run):
  """One tiered run's port pieces at world N: ``(tplan, rule, store,
  trainer)`` from ``run``'s config and plan knobs and ``spec``'s JAX init
  (``dense`` flax params, ``tables[run['init']]`` global tables)."""
  import functools

  import torch

  import torch_tiering_cases as TC
  from distributed_embeddings_torch import tiering as tt
  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.convert import dlrm_state_dict_from_flax
  from distributed_embeddings_torch.models import bce_loss
  from distributed_embeddings_torch.ops import packed_table as tpt

  plan = TC.torch_plan(mesh.world, **run.get("plan_kw", {}))
  rule = getattr(tpt, f"{run.get('rule', 'adagrad')}_rule")(TC.LR)
  tplan = tt.TieringPlan(plan, rule, tt.TieringConfig(**run["cfg"]))
  store = tt.HostTierStore(tplan, owned_ranks=(mesh.rank,))
  if run.get("dense", "adam") == "adam":
    factory = functools.partial(torch.optim.Adam, lr=TC.ADAM_LR)
  else:
    factory = functools.partial(ttr.Adagrad, lr=TC.LR)
  params = dict(dlrm_state_dict_from_flax(spec["dense"]))
  params["embeddings"] = spec["tables"][run.get("init", "base")]
  state = tt.init_tiered_state_from_params(tplan, store, rule, params,
                                           factory, mesh=mesh)
  trainer = tt.TieredTrainer(TC.torch_model(), tplan, store, bce_loss,
                             factory, rule, mesh, state,
                             guard=run.get("guard", False))
  return tplan, rule, store, trainer


def _tiered_result(mesh, tplan, rule, store, trainer, losses):
  import numpy as np

  from distributed_embeddings_torch import tiering as tt
  from distributed_embeddings_torch.layers.dist_model_parallel import \
      get_weights
  trainer.flush()
  p = tt.unpack_tiered_state(tplan, store, rule, trainer.state, mesh=mesh)
  return {"losses": losses,
          "weights": [np.asarray(w) for w in
                      get_weights(tplan.plan, p["embeddings"])],
          "summary": trainer.metrics_summary(),
          "hits": {k: v.copy() for k, v in trainer.hits.items()},
          "resident": {k: [g.copy() for g in v]
                       for k, v in store.resident_grps.items()},
          "counts": {k: [c.copy() for c in v]
                     for k, v in store.counts.items()}}


def dense_bf16_loop_job(mesh, spec):
  """A hand-written hybrid-parallel loop on a world-N DLRM whose class
  buffers are bf16 (``spec['model']``'s arguments, the JAX init
  ``spec['init']`` cut per rank, then ``model.embeddings.to(bfloat16)``):
  per batch of ``spec['batches']`` ``zero_grad``, ``loss.backward()`` and
  a ``DistributedOptimizer`` over ``training.Adam(lr=spec['lr'])``. Every
  rank returns the losses averaged over the ranks and the global final
  params as flax paths (the bf16 class buffers as f32)."""
  import torch
  import torch.distributed as dist

  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.convert import (
      dlrm_state_dict_from_flax,
      dlrm_state_dict_to_flax,
  )
  from distributed_embeddings_torch.layers import dist_model_parallel as dmp
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.parallel import wire
  from distributed_embeddings_torch.train_golden import flax_paths

  model = DLRM(**spec["model"], world_size=mesh.world, mesh=mesh)
  model.load_state_dict(dlrm_state_dict_from_flax(spec["init"], mesh=mesh))
  model.embeddings.to(torch.bfloat16)
  opt = dmp.DistributedOptimizer(
      ttr.Adam(model.parameters(), lr=spec["lr"]), model, mesh)
  losses = []
  for numerical, cats, labels in spec["batches"]:
    opt.zero_grad()
    n, c, y = ttr.shard_batch((numerical, list(cats), labels), mesh,
                              device="cpu")
    loss = bce_loss(model(n, c), y)
    loss.backward()
    opt.step()
    total = loss.detach().clone()
    dist.all_reduce(total)
    losses.append(float(total) / mesh.world)
  sd = {k: v.detach() for k, v in model.state_dict().items()}
  for name, p in model.embeddings.class_params().items():
    assert p.dtype == torch.bfloat16, name
    sd[f"embeddings.{name}"] = wire.gather_blocks(
        p.detach().to(torch.float32), mesh)
  return {"losses": losses,
          "params": flax_paths(dlrm_state_dict_to_flax(sd))}


def tiered_job(mesh, spec):
  """Tiered training at world N (``tiering.TieredTrainer``, each rank's
  store owning its rank): per entry of ``spec['runs']`` (``name``,
  ``cfg``: the ``TieringConfig`` fields, optionally ``plan_kw``,
  ``guard``, ``dense`` and ``init``) the run over ``spec['batches']``
  (global host batches) from the JAX init ``spec['dense']`` /
  ``spec['tables']``. Every rank returns per run the losses, the final
  global tables (``get_weights``), the metrics summary, the hit counters
  and its replicated bookkeeping (resident groups and counts of every
  rank)."""
  out = {}
  for run in spec["runs"]:
    tplan, rule, store, trainer = _tiered_setup(mesh, spec, run)
    losses = trainer.run(spec["batches"])
    out[run["name"]] = _tiered_result(mesh, tplan, rule, store, trainer,
                                      losses)
  return out


def tiered_ckpt_job(mesh, spec):
  """Tiered checkpoints at world N: the run ``spec['run']`` takes three
  steps, saves to ``spec['port_path']`` (every rank, its own store) and
  takes the rest; a fresh store restores that checkpoint and takes the
  rest again; another fresh store restores the JAX package's checkpoint
  ``spec['jax_path']`` and takes the rest. Returns the losses of each and
  this rank's tier arrays as saved and as restored from the JAX one."""
  import numpy as np

  from distributed_embeddings_torch import checkpoint as tck

  def arrays(store):
    return {f"{part}/{name}/{r}": np.asarray(v).copy()
            for part in ("images", "resident_grps", "counts")
            for name, per in getattr(store, part).items()
            for r, v in enumerate(per) if v is not None}

  batches = spec["batches"]
  run = spec["run"]
  tplan, rule, store, tr = _tiered_setup(mesh, spec, run)
  head = tr.run(batches[:3])
  tck.save(spec["port_path"], tplan.plan, rule, tr.state, store=store,
           mesh=mesh)
  saved = arrays(store)
  tail = tr.run(batches[3:])
  out = {"head": head, "tail": tail, "saved": saved}
  for key, path in (("resumed", spec["port_path"]),
                    ("from_jax", spec["jax_path"])):
    tplan2, _, store2, tr2 = _tiered_setup(mesh, spec,
                                           dict(run, init="zeros"))
    tr2.state = tck.restore(path, tplan2.plan, rule, tr2.state, mesh=mesh,
                            store=store2, device="cpu")
    tr2.prefetcher.refresh_resident()
    if key == "from_jax":
      out["restored"] = arrays(store2)
    out[key] = tr2.run(batches[3:])
  return out


def _tiered_serve_setup(mesh, spec):
  """The port's world-N tiered serve pieces from the JAX case's arrays:
  ``(plan, rule, state, store)``, the store owning this rank's image."""
  import torch_serve_tiered_cases as SC
  from distributed_embeddings_torch.convert import train_state_from_flax

  _, plan = SC.torch_plans(mesh.world)
  rule, tplan = SC.torch_tplan(plan)
  store = SC.port_store(tplan, spec["store"], owned_ranks=(mesh.rank,))
  state = train_state_from_flax(spec["state"], mesh=mesh)
  return plan, rule, state, store


def serve_tiered_job(mesh, spec):
  """Tiered serving at world N, each rank's store owning its rank's
  image: per quantize mode of ``spec['quantize']``, ``freeze(store=,
  mesh=)`` (this rank's stripped image, every rank's ranking and counts),
  a tiered ``ServeEngine`` with metrics (predictions, counters, the
  activations of an acts model), the same through a two-row staging
  region (spills), the world-N ``export`` into ``spec['port']`` and a
  ``load`` of it from a copy that holds only this rank's cold files, and
  the JAX package's artifact ``spec['jax']`` loaded and served. Returns
  every global answer this rank saw."""
  import dataclasses
  import os
  import shutil

  import torch

  import torch_serve_tiered_cases as SC
  import torch_tiering_cases as TC
  from distributed_embeddings_torch.serving import (
      ServeEngine,
      ServeTierConfig,
      export,
      freeze,
      load,
  )

  class Acts(torch.nn.Module):
    def forward(self, numerical, cats, emb_acts=None):
      return torch.cat(list(emb_acts), dim=-1)

  def engine(art, cfg=SC.SERVE_CFG, acts=False, **kw):
    if acts:
      return ServeEngine(Acts(), plan, dataclasses.replace(art, dense={}),
                         mesh=mesh, tier_config=ServeTierConfig(**cfg), **kw)
    return ServeEngine(TC.torch_model(), plan, art, mesh=mesh,
                       tier_config=ServeTierConfig(**cfg), **kw)

  def answers(eng):
    out = [eng.predict(numerical, cats) for numerical, cats in spec["requests"]]
    return out, eng.prefetcher.spill_steps

  out = {}
  for q in spec["quantize"]:
    plan, rule, state, store = _tiered_serve_setup(mesh, spec)
    frozen = freeze(plan, rule, state, quantize=q, store=store, mesh=mesh)
    got = {"frozen": {n: {"images": frozen.host_images[n],
                          "ranking": frozen.ranking[n],
                          "counts": frozen.counts[n]}
                      for n in frozen.host_images},
           "served": answers(engine(frozen, with_metrics=True)),
           "acts": answers(engine(frozen, acts=True))[0],
           "spill": answers(engine(frozen, SC.SPILL_CFG, acts=True,
                                   with_metrics=True))}
    path = os.path.join(spec["port"], q)
    export(path, plan, rule, state, quantize=q, store=store, mesh=mesh)
    # this rank's copy of the artifact: the shared files and its own blocks
    mine = os.path.join(spec["port"], f"{q}_r{mesh.rank}")
    os.makedirs(mine)
    for f in os.listdir(path):
      if f.endswith(".npy") and not f.endswith(f"_r{mesh.rank}.npy"):
        continue
      shutil.copy(os.path.join(path, f), mine)
    art = load(mine, plan, mesh=mesh)
    got["loaded"] = {n: {"images": art.host_images[n],
                         "ranking": art.ranking[n], "counts": art.counts[n]}
                     for n in art.host_images}
    got["artifact"] = answers(engine(art))[0]
    got["jax_artifact"] = answers(engine(load(os.path.join(spec["jax"], q),
                                              plan, mesh=mesh)))[0]
    out[q] = got
  torch.distributed.barrier()
  return out


def leader_batcher_job(mesh, spec):
  """The rank-0 ``MicroBatcher`` at world N (``serving.world_batcher``) in
  front of a tiered engine of ``spec['quantize']``: every rank first
  answers each request of ``spec['direct']`` by a direct padded dispatch
  in lockstep; then rank 0 submits ``spec['schedule']`` (groups of
  requests, a ``flush_now`` after each), then a request that every rank
  refuses and a good one, to an unstarted batcher while the other ranks
  follow, and closes it; then a started batcher takes every
  request of ``spec['direct']`` at once and closes. Rank 0 returns the
  direct answers, every request's rows and the batchers' stats; a third
  batcher closes at once. The other ranks return their direct answers
  and what each of their three follow loops followed."""
  import numpy as np

  import torch_serve_tiered_cases as SC
  import torch_tiering_cases as TC
  from distributed_embeddings_torch.parallel.lookup_engine import PAD_ID
  from distributed_embeddings_torch.serving import (
      LeaderBatcher,
      ServeEngine,
      ServeTierConfig,
      follow,
      freeze,
      world_batcher,
  )

  plan, rule, state, store = _tiered_serve_setup(mesh, spec)
  eng = ServeEngine(TC.torch_model(), plan,
                    freeze(plan, rule, state, quantize=spec["quantize"],
                           store=store, mesh=mesh), mesh=mesh,
                    tier_config=ServeTierConfig(**SC.SERVE_CFG))
  max_batch = spec["max_batch"]

  def direct(rows):
    n = rows[0].shape[0]
    pad = max_batch - n
    num_p = np.concatenate(
        [rows[0], np.zeros((pad,) + rows[0].shape[1:], np.float32)])
    cats_p = [np.concatenate([c, np.full((pad,), PAD_ID, c.dtype)])
              for c in rows[1]]
    return eng.predict(num_p, cats_p)[:n]

  out = {"direct": [direct(r) for r in spec["direct"]]}
  if mesh.rank != 0:
    # the three batchers rank 0 opens in turn
    out["followed"] = [follow(eng),
                       world_batcher(eng, max_batch) is None, follow(eng)]
    out["follow_errors"] = eng.telemetry.counter("serve/follow_errors").value
    return out
  mb = world_batcher(eng, max_batch, start=False)
  assert isinstance(mb, LeaderBatcher)
  sched = []
  for group in spec["schedule"]:
    futs = [mb.submit(*spec["direct"][i]) for i in group]
    mb.flush_now()
    sched.append([f.result(timeout=60) for f in futs])
  # a request every rank refuses alike (a feature short: the bottom MLP
  # raises after the exchange on every rank): its future fails here, the
  # followers record the error and go on following
  numerical, cats = spec["direct"][0]
  bad = mb.submit(numerical[:, :-1], cats)
  try:
    mb.flush_now()
  except RuntimeError as exc:
    out["bad_flush"] = str(exc)
  try:
    bad.result(timeout=60)
  except RuntimeError as exc:
    out["bad_result"] = str(exc)
  fut = mb.submit(numerical, cats)
  mb.flush_now()
  out["after_bad"] = fut.result(timeout=60)
  mb.close()
  out["schedule"], out["schedule_stats"] = sched, mb.stats
  mb = world_batcher(eng, max_batch, max_delay_s=0.005)
  futs = [mb.submit(*r) for r in spec["direct"]]
  out["started"] = [f.result(timeout=60) for f in futs]
  mb.close()
  out["started_stats"] = mb.stats
  # the second batcher of this rank: close() stopped every follower, and
  # nothing more is sent
  mb = world_batcher(eng, max_batch, start=False)
  mb.close()
  return out


def _elastic_cell(world, spec):
  """``tests/test_elastic.py``'s cell in the port at ``world``: the plan
  (``[300, 200, 150, 20]``, width 16, the 20-row table a dense class),
  the DLRM without tables, Adagrad on both sides."""
  import functools

  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.layers.planner import \
      DistEmbeddingStrategy
  from distributed_embeddings_torch.models import DLRM
  from distributed_embeddings_torch.ops import packed_table as tpt
  plan = DistEmbeddingStrategy(
      [dict(input_dim=v, output_dim=16,
            initializer={"name": "uniform", "scale": 0.05})
       for v in spec["vocab"]], world, "basic", dense_row_threshold=32)
  model = DLRM(spec["vocab"], 16, bottom_mlp=(32, 16), top_mlp=(32, 1),
               num_numerical=13, tables=False, device="cpu")
  return (plan, model, tpt.adagrad_rule(0.05),
          functools.partial(ttr.Adagrad, lr=0.05))


def _rank_arrays(state):
  """This rank's fused blocks, dense-class block, dense parameters and
  both optimizers' optax states, numpy copies."""
  import numpy as np

  from distributed_embeddings_torch.convert import (
      dense_state_dict_to_flax,
      optax_state_of,
  )
  from distributed_embeddings_torch.resilience.elastic import \
      flatten_with_paths
  out = {f"fused/{k}": v.numpy().copy() for k, v in state["fused"].items()}
  out.update({f"emb_dense/{k}": v.detach().numpy().copy()
              for k, v in state["emb_dense"].items()})
  out.update({f"dense/{k}": np.asarray(v).copy()
              for k, v in flatten_with_paths(
                  dense_state_dict_to_flax(state["dense"])).items()})
  for part in ("dense", "emb_dense"):
    flat = optax_state_of(state[f"{part}_opt"], state[part])
    out.update({f"{part}_opt/{k}": np.asarray(v).copy()
                for k, v in flat.items()})
  out["step"] = state["step"]
  return out


def elastic_job(mesh, spec):
  """Elastic restores at world N (``tests/test_torch_elastic.py``): every
  rank restores the JAX world-4 checkpoint ``spec['path4']`` onto the
  world-``N`` plan (each rank reads only its own target blocks) and
  returns its arrays, takes one step and returns the loss, and the ranks
  save the restored state at ``spec['back']`` (for the 4 -> N -> 4 round
  trip). Padding neutrality: the JAX world-N checkpoint ``spec['pathn']``
  restored as it was and the same state after a trip through world 4
  (``spec['pathn_4']``, elastic) each take one step; both losses and
  resulting arrays are returned."""
  from distributed_embeddings_torch import checkpoint as tck
  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.convert import train_state_from_flax
  from distributed_embeddings_torch.models import bce_loss

  plan, model, rule, factory = _elastic_cell(mesh.world, spec)
  like = ttr._with_optimizers(train_state_from_flax(spec["like"], mesh=mesh),
                              factory, None)
  step = ttr.make_sparse_train_step(model, plan, bce_loss, factory, rule,
                                    mesh=mesh)
  batch = ttr.shard_batch(spec["batch"], mesh, device="cpu")

  def one(state):
    state, loss = step(state, *batch)
    return float(loss), _rank_arrays(state)

  out = {}
  s = tck.restore(spec["path4"], plan, rule, like, mesh=mesh)
  out["restored"] = _rank_arrays(s)
  tck.save(spec["back"], plan, rule, s, mesh=mesh)
  out["loss"], _ = one(s)
  a = tck.restore(spec["pathn"], plan, rule, like, mesh=mesh)
  b = tck.restore(spec["pathn_4"], plan, rule, like, mesh=mesh)
  out["direct"], out["trip"] = one(a), one(b)
  return out


def preempt_job(mesh, spec):
  """In-run resizes across processes (``tests/test_torch_preempt.py``):
  every rank is a pod member (``m<rank>``) of ``spec['pod']``.

  Sparse: a guarded ``ResilientTrainer`` of ``tests/test_elastic.py``'s
  cell (the JAX initial state ``spec['state']``) runs ``spec['batches']``
  and resizes 4 -> 2 before batch ``spec['shrink_at']`` (members 2 and 3
  park: they hold no state and wait at the next barrier) and 2 -> 4
  before batch ``spec['grow_at']`` (they return); each rank returns its
  arrays on both sides of each boundary, its losses and accounting. Then
  the same stream unresized at world 4 (the reference).

  Tiered: a guarded tiered trainer of the tiered cell takes
  ``spec['tiered_steps']`` steps at world 4 (each rank's store owning its
  rank), resizes 4 -> 2 (members 2 and 3 park), and takes the rest; each
  rank returns its store and state on both sides of the boundary."""
  import functools
  import os

  import numpy as np
  import torch

  from distributed_embeddings_torch import tiering as tt
  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.convert import train_state_from_flax
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.parallel.mesh import rank_mesh
  from distributed_embeddings_torch.resilience import elastic
  from distributed_embeddings_torch.resilience.trainer import \
      ResilientTrainer
  from distributed_embeddings_torch.telemetry import MetricsRegistry

  member = f"m{mesh.rank}"
  pod = spec["pod"]
  elastic.register_member(pod, member)
  model = _elastic_cell(1, spec)[1]
  rule, factory = _elastic_cell(1, spec)[2:]

  def step_for(world, new_mesh):
    plan = _elastic_cell(world, spec)[0]
    return plan, ttr.make_sparse_train_step(
        model, plan, bce_loss, factory, rule,
        mesh=new_mesh if world > 1 else None, guard=True)

  def new_mesh_for(world):
    r = elastic.member_rank(elastic.alive_members(pod), member, world)
    return None if r is None else rank_mesh(world, r, "cpu")

  reg = MetricsRegistry()
  plan4, step4 = step_for(4, mesh)
  state = ttr._with_optimizers(train_state_from_flax(spec["state"],
                                                     mesh=mesh),
                               factory, None)
  t = ResilientTrainer(step4, state, plan4, rule,
                       os.path.join(pod, f"ckpt_{member}"), mesh=mesh,
                       resume=False, telemetry=reg)
  out = {"losses": {}, "boundary": {}}
  epoch = 0
  for i, batch in enumerate(spec["batches"]):
    if i in (spec["shrink_at"], spec["grow_at"]):
      world = 2 if i == spec["shrink_at"] else 4
      epoch += 1
      if not t.parked:
        out["boundary"][f"{epoch}/before"] = _rank_arrays(t.state)
      new_mesh = new_mesh_for(world)
      step = step_for(world, new_mesh)[1] if new_mesh is not None else None
      t.resize(world, step, new_mesh=new_mesh, pod_dir=pod,
               barrier_epoch=epoch, member_id=member, n_participants=4)
      if not t.parked:
        out["boundary"][f"{epoch}/after"] = _rank_arrays(t.state)
    if t.parked:
      continue
    out["losses"][i] = t.step(*ttr.shard_batch(batch, t.mesh, device="cpu"))
  out["accounting"] = {"consumed": t.consumed, "steps": t.step_count,
                       "skipped": t.skipped_steps,
                       "resumed_from": t.resumed_from,
                       "resizes": reg.counter("elastic/resizes").value,
                       "barriers": reg.counter(
                           "elastic/membership_barriers").value}
  mesh4 = t.mesh
  ref_state = ttr._with_optimizers(train_state_from_flax(spec["state"],
                                                         mesh=mesh4),
                                   factory, None)
  ref = ResilientTrainer(step_for(4, mesh4)[1], ref_state, plan4, rule,
                         os.path.join(pod, f"ref_{member}"), mesh=mesh4,
                         resume=False, telemetry=MetricsRegistry())
  out["ref_losses"] = [ref.step(*ttr.shard_batch(b, mesh4, device="cpu"))
                       for b in spec["batches"]]

  # tiered: 4 -> 2 with two members parking
  import torch_tiering_cases as TC
  from distributed_embeddings_torch.ops import packed_table as tpt
  trule = tpt.adagrad_rule(TC.LR)
  cfg = tt.TieringConfig(cache_fraction=0.3, staging_grps=64)
  torch.manual_seed(0)  # the same dense parameters on every rank
  tmodel = TC.torch_model()
  tfactory = functools.partial(ttr.Adagrad, lr=TC.LR)

  def tiered_for(world, m):
    tplan = tt.TieringPlan(TC.torch_plan(world), trule, cfg)
    store = tt.HostTierStore(tplan, owned_ranks=(m.rank,) if world > 1
                             else None)

    def factory_(new_state):
      return tt.TieredTrainer(tmodel, tplan, store, bce_loss, tfactory,
                              trule, m if world > 1 else None, new_state,
                              guard=True, device="cpu")
    return tplan, store, factory_

  tplan4, store4, _ = tiered_for(4, mesh4)
  tstate = tt.init_tiered_state(
      tplan4, store4, trule, tmodel.state_dict(), tfactory,
      torch.Generator().manual_seed(7 + mesh4.rank), mesh=mesh4,
      image_seed=5)
  tr = ResilientTrainer(None, None, tplan4.plan, trule,
                        os.path.join(pod, f"tck_{member}"), mesh=mesh4,
                        resume=False, telemetry=MetricsRegistry(),
                        tiered=tt.TieredTrainer(
                            tmodel, tplan4, store4, bce_loss, tfactory,
                            trule, mesh4, tstate, guard=True))
  tb = [TC.jax_batch(900 + i) for i in range(spec["tiered_steps"] + 2)]
  out["tiered"] = {"losses": [tr.step(*b) for b in tb[:spec["tiered_steps"]]]}

  def tier_arrays(trainer):
    trainer.tiered.flush()
    st = trainer.store
    got = {f"{part}/{name}/{r}": np.asarray(v).copy()
           for part in ("images", "resident_grps", "counts")
           for name, per in getattr(st, part).items()
           for r, v in enumerate(per) if v is not None}
    got.update(_rank_arrays(trainer.state))
    return got

  out["tiered"]["before"] = tier_arrays(tr)
  new_mesh = new_mesh_for(2)
  if new_mesh is not None:
    tplan2, store2, factory2 = tiered_for(2, new_mesh)
    tr.resize(2, new_mesh=new_mesh, new_store=store2,
              tiered_factory=factory2, pod_dir=pod, barrier_epoch=epoch + 1,
              member_id=member, n_participants=4)
    out["tiered"]["after"] = tier_arrays(tr)
    out["tiered"]["losses"] += [tr.step(*b) for b in tb[spec["tiered_steps"]:]]
    out["tiered"]["missed"] = sum(
        v["missed"] for v in tr.tiered.metrics_summary()["per_class"].values())
    out["tiered"]["accounting"] = (tr.consumed, tr.step_count,
                                   tr.skipped_steps)
  else:
    tr.resize(2, pod_dir=pod, barrier_epoch=epoch + 1, member_id=member,
              n_participants=4)
    out["tiered"]["parked"] = tr.parked
  return out


def _dynvocab_run(mesh, spec, world):
  """``tests/test_torch_dynvocab.py``'s cell at ``world`` on this rank:
  a guarded ``DynVocabTrainer`` from the JAX state ``spec[f'state{world}']``
  over the global raw-id batches ``spec['batches']``; returns the plan,
  rule, trainer and its losses."""
  import functools

  from distributed_embeddings_torch import dynvocab as tdv
  from distributed_embeddings_torch import training as ttr
  from distributed_embeddings_torch.convert import train_state_from_flax
  from distributed_embeddings_torch.layers.planner import \
      DistEmbeddingStrategy
  from distributed_embeddings_torch.models import DLRM, bce_loss
  from distributed_embeddings_torch.ops import packed_table as tpt

  plan = DistEmbeddingStrategy(
      [dict(input_dim=v, output_dim=16) for v in spec["vocab"]], world,
      "memory_balanced", dense_row_threshold=0,
      overlap=spec["overlap"][world], **spec["knobs"])
  model = DLRM(spec["vocab"], 16, bottom_mlp=(32, 16), top_mlp=(32, 1),
               num_numerical=13, tables=False, device="cpu")
  rule = tpt.adagrad_rule(spec["lr"])
  opt = functools.partial(ttr.Adam, lr=spec["adam"])
  state = ttr._with_optimizers(
      train_state_from_flax(spec[f"state{world}"], mesh=mesh), opt, None)
  trainer = tdv.DynVocabTrainer(model, plan, tdv.DynVocabTranslator(plan, rule),
                                bce_loss, opt, rule, mesh, state, guard=True)
  losses = trainer.run(spec["batches"])
  return plan, rule, trainer, losses


def _dynvocab_result(mesh, plan, rule, trainer, losses):
  from distributed_embeddings_torch import training as ttr
  params, aux = ttr.unpack_sparse_state(plan, rule, trainer.state,
                                        include_aux=True, mesh=mesh)
  tables = {k: v.numpy().copy() for k, v in params["embeddings"].items()}
  tables.update({f"aux/{k}": v[0].numpy().copy() for k, v in aux.items()})
  return {"losses": losses, "tables": tables,
          "vocab": {k: v.copy() for k, v in
                    trainer.translator.state_arrays().items()},
          "summary": trainer.metrics_summary()}


def dynvocab_job(mesh, spec):
  """The dynamic vocabulary at world 4, then at world 2
  (``tests/test_torch_dynvocab.py``): the world-4 run's result, a save of
  it with its translator (``spec['ckpt']``, which also writes the
  ranks' ``pod_clock.json``); then the default process group is formed
  again at world 2 on ranks 0 and 1 (``spec['port2']``), which restore
  that checkpoint elastically with a fresh translator (its state
  returned) and run the cell at world 2. Ranks 2 and 3 return after the
  world-4 part."""
  import torch.distributed as dist

  from distributed_embeddings_torch import checkpoint as tck
  from distributed_embeddings_torch import dynvocab as tdv
  from distributed_embeddings_torch.parallel.mesh import join_group, \
      rank_mesh

  plan, rule, trainer, losses = _dynvocab_run(mesh, spec, 4)
  out = {"w4": _dynvocab_result(mesh, plan, rule, trainer, losses)}
  tck.save(spec["ckpt"], plan, rule, trainer.state, vocab=trainer.translator,
           mesh=mesh)
  state4 = trainer.state
  dist.destroy_process_group()
  if mesh.rank >= 2:
    return out
  mesh2 = join_group(rank_mesh(2, mesh.rank, "cpu"),
                     f"tcp://127.0.0.1:{spec['port2']}")
  plan2, rule2, trainer2, losses2 = _dynvocab_run(mesh2, spec, 2)
  tr = tdv.DynVocabTranslator(plan2, rule2)
  del state4
  tck.restore(spec["ckpt"], plan2, rule2, trainer2.state, mesh=mesh2,
              vocab=tr)
  out["restored_vocab"] = {k: v.copy() for k, v in tr.state_arrays().items()}
  out["w2"] = _dynvocab_result(mesh2, plan2, rule2, trainer2, losses2)
  return out


def stream_job(mesh, spec):
  """The delta stream at world N (``streaming/``; the cell of
  ``tests/torch_stream_cases.py``), every rank with its mesh:

  - ``publish``: per plan (raw, ``dedup_exchange``) the port trains over
    ``spec['batches']`` (global), and after every second batch three
    publishers (f32, int8, fp8, under ``spec['dir']/port_<dedup>_<q>``)
    publish the base, then a delta; returns this rank's fused blocks at
    each publication;
  - ``fold``: an f32 chain under ``spec['dir']/fold`` served by a
    ``DeltaSubscriber`` behind the rank-0 batcher
    (``serving.world_batcher``): after each of two deltas rank 0 polls
    and submits ``spec['requests']``, every rank folds through the
    leader's seq before the dispatch; returns the applied seq every rank
    saw after each dispatch, rank 0's answers, and whether the folded
    blocks equal a full re-export and its predictions;
  - ``tiered``: per quantize mode of ``spec['tiered']`` the tiered cell
    (each store owning its rank) publishes a base and a delta, and a
    tiered subscriber folds it in lockstep: its own cold images and
    predictions against a full re-export, and the tier misses;
  - ``trainer``: ``ResilientTrainer(stream=)`` at world N, killed-free
    restart: the second lifetime re-attaches and its chain folds to the
    re-export of the continued state."""
  import os

  import numpy as np
  import torch

  import torch_stream_cases as SC
  from distributed_embeddings_torch.resilience.trainer import \
      ResilientTrainer
  from distributed_embeddings_torch.serving import (
      ServeEngine,
      ServeTierConfig,
      world_batcher,
  )
  from distributed_embeddings_torch.serving import export as serve_export
  from distributed_embeddings_torch.serving import load as serve_load
  from distributed_embeddings_torch.streaming import (
      DeltaPublisher,
      DeltaSubscriber,
      RowGenerationTracker,
  )

  rank, world, root = mesh.rank, mesh.world, spec["dir"]
  batches = spec["batches"]
  rule = SC.torch_rule()
  out = {"publish": {}}

  def publisher(path, plan, quantize="f32", **kw):
    return DeltaPublisher(path, plan, rule, RowGenerationTracker(plan),
                          quantize=quantize, mesh=mesh, **kw)

  def blocks(state):
    return {k: v.numpy().copy() for k, v in state["fused"].items()}

  def full(tag, plan, state, quantize="f32", store=None):
    path = os.path.join(root, f"full_{tag}_{quantize}")
    serve_export(path, plan, rule, state, quantize=quantize, store=store,
                 mesh=mesh)
    return serve_load(path, plan, mesh=mesh)

  def same_blocks(sub, art):
    return all(torch.equal(sub.engine.state["serve"][n].view(torch.uint8),
                           b.view(torch.uint8))
               for n, b in art.state["serve"].items())

  # ---- publish parity ------------------------------------------------------
  for dedup in (False, True):
    plan = SC.torch_plan(world, dedup)
    state = SC.torch_state(plan, mesh)
    step = SC.torch_step(plan, mesh)
    pubs = [publisher(os.path.join(root, f"port_{int(dedup)}_{q}"), plan, q)
            for q in SC.QUANTIZE]
    got = []
    for i, bt in enumerate(batches):
      for p in pubs:
        p.observe_batch(bt[1])
      state = SC.run_step(step, state, bt, mesh)
      if i % 2:
        got.append(blocks(state))
        for p in pubs:
          if i == 1:
            p.publish_base(state)
          else:
            assert p.publish_delta(state) is not None
    out["publish"][dedup] = {"blocks": got, "step": int(state["step"]),
                             "seq": [p.seq for p in pubs]}

  # ---- the lockstep fold behind the rank-0 batcher -------------------------
  plan = SC.torch_plan(world)
  state = SC.torch_state(plan, mesh)
  step = SC.torch_step(plan, mesh)
  pub = publisher(os.path.join(root, "fold"), plan)
  for bt in batches[:2]:
    pub.observe_batch(bt[1])
    state = SC.run_step(step, state, bt, mesh)
  pub.publish_base(state)
  sub = DeltaSubscriber.from_artifact(SC.TorchActsModel(), plan,
                                      os.path.join(root, "fold"), mesh=mesh,
                                      device="cpu")
  seen = []
  dispatch_at = sub.dispatch_at

  def recorded(seq, numerical, cats):
    res = dispatch_at(seq, numerical, cats)
    seen.append(sub.applied_seq)
    return res

  sub.dispatch_at = recorded
  answers = []
  for bt in batches[2:4]:
    pub.observe_batch(bt[1])
    state = SC.run_step(step, state, bt, mesh)
    assert pub.publish_delta(state) is not None
    mb = world_batcher(sub, spec["max_batch"], start=False)
    if rank == 0:
      assert sub.poll_once() == 1
      futs = []
      for req in spec["requests"]:
        futs.append(mb.submit(*req))
        mb.flush_now()
      answers.append([f.result(timeout=60) for f in futs])
      mb.close()
  art = full("fold", plan, state)
  eng = ServeEngine(SC.TorchActsModel(), plan, art, mesh=mesh)
  want = [eng.predict(*req) for req in spec["requests"]]
  out["fold"] = {"seen": seen, "applied_seq": sub.applied_seq,
                 "blocks_equal": same_blocks(sub, art),
                 "answers": answers, "want": want,
                 "refused": sub.last_refusal}

  # ---- tiered, each store owning its rank ----------------------------------
  out["tiered"] = {}
  for q in spec["tiered"]:
    tplan_, trule, store, trainer = SC.tiered_cell(world, mesh)
    path = os.path.join(root, f"tiered_{q}")
    tpub = DeltaPublisher(path, tplan_, trule, RowGenerationTracker(tplan_),
                          quantize=q, store=store, mesh=mesh)
    for i in range(2):
      bt = SC.tiered_batch(100 + i)
      tpub.observe_batch(bt[1])
      trainer.step(*bt)
    tpub.publish_base(trainer.state)
    cfg = ServeTierConfig(**SC.T_CFG)
    tsub = DeltaSubscriber.from_artifact(
        SC.tiered_model(), tplan_, path, mesh=mesh, tier_config=cfg,
        with_metrics=True, device="cpu")
    for i in range(2):
      bt = SC.tiered_batch(200 + i)
      tpub.observe_batch(bt[1])
      trainer.step(*bt)
    before = {n: [None if img is None else img.copy() for img in imgs]
              for n, imgs in store.images.items()}
    assert tpub.publish_delta(trainer.state) is not None
    flush_free = all(img is None or np.array_equal(img, before[n][r])
                     for n, imgs in store.images.items()
                     for r, img in enumerate(imgs))
    if rank == 0:
      assert tsub.poll_once() == 1
    probe = SC.tiered_batch(999)
    preds, metrics = tsub.dispatch_at(1, probe[0], probe[1])
    tart = full("tiered", tplan_, trainer.state, q, store=store)
    teng = ServeEngine(SC.tiered_model(), tplan_, tart, mesh=mesh,
                       tier_config=cfg, with_metrics=True)
    want_p, _ = teng.predict(probe[0], probe[1])
    images_equal = all(
        np.array_equal(tsub.engine.store.images[n][rank].view(np.uint8),
                       np.asarray(tart.host_images[n][rank]).view(np.uint8))
        for n in tart.host_images)
    out["tiered"][q] = {
        "flush_free": flush_free, "images_equal": images_equal,
        "preds": preds.numpy(), "want": want_p,
        "missed": int(sum(int(v[2]) for v in metrics["tier"].values())),
        "applied_seq": tsub.applied_seq}

  # ---- ResilientTrainer(stream=): snapshot, restart, re-attach -------------
  plan = SC.torch_plan(world)
  guarded = SC.torch_step(plan, mesh, guard=True)
  ckpts, pubdir = os.path.join(root, "ckpts"), os.path.join(root, "rt")
  pub1 = publisher(pubdir, plan)
  t1 = ResilientTrainer(guarded, SC.torch_state(plan, mesh), plan, rule,
                        ckpts, mesh=mesh, snapshot_every=2, stream=pub1)
  pub1.publish_base(t1.state)
  t1.snapshot()
  for i in range(4):
    pub1.observe_batch(batches[i][1])
    t1.run([batches[i]])
    if i % 2:
      assert pub1.publish_delta(t1.state) is not None
  pub2 = publisher(pubdir, plan)
  t2 = ResilientTrainer(guarded, SC.torch_state(plan, mesh), plan, rule,
                        ckpts, mesh=mesh, snapshot_every=2, stream=pub2)
  res = {"resumed": t2.resumed_from is not None,
         "attached": pub2.attached, "seq": (pub1.seq, pub2.seq),
         "base": pub1.base_fingerprint == pub2.base_fingerprint}
  for i in range(t2.consumed, len(batches)):
    pub2.observe_batch(batches[i][1])
    t2.run([batches[i]])
  assert pub2.publish_delta(t2.state) is not None
  rsub = DeltaSubscriber.from_artifact(SC.TorchActsModel(), plan, pubdir,
                                       mesh=mesh, heartbeat=False,
                                       device="cpu")
  if rank == 0:
    assert rsub.poll_once() == pub2.seq
  probe = spec["requests"][0]
  rsub.dispatch_at(pub2.seq, *probe)
  res["blocks_equal"] = same_blocks(rsub, full("rt", plan, t2.state))
  res["applied_seq"] = rsub.applied_seq
  out["trainer"] = res
  return out
