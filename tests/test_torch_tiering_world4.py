"""Tiered storage at world 4: four gloo ranks (one spawn of ``tests/
torch_ranks.py: multi_job``), each a process whose ``HostTierStore`` owns
its rank's images and replicates every rank's bookkeeping, against the
JAX ``TieredTrainer`` over a 4-device CPU mesh (a store owning every
rank), on ``tests/test_tiering.py``'s configurations
(``tests/torch_tiering_cases.py``). The ranks run while the JAX side
computes (``spawn_start`` / ``spawn_wait``).

- **Trajectories** (``tiered_job``): ``cache_fraction=0.3,
  staging_grps=64, rerank_interval=3``; ``staging_grps=2`` (every step
  spills); ``overlap='fused', exchange_chunks=2``; ``dedup_exchange``.
  Every rank's losses within rtol 1e-5 / atol 1e-6 and final global
  tables within rtol 1e-4 / atol 1e-5 of JAX's; hit counters (summed over
  the ranks by the step's ``all_reduce``), spill steps and EVERY rank's
  resident sets and counts equal on every rank (the classify and the
  incremental re-rank agree across the processes), and the ranks'
  host-gather bytes sum to the JAX store's. The power-law batch gives the
  ranks different cold counts, so the padded staging size is a max over
  them.
- **Checkpoints** (``tiered_ckpt_job``, dense side Adagrad): the port's
  world-4 save (``cold_*_r<rank>.npy``, ``tiering_p<rank>.npz``) resumes
  bit-equal in the port and restores in the JAX package (arrays bit-equal,
  the continuation in the f32 class of the port's); the JAX package's save
  restores in the port (arrays bit-equal) and continues in the f32 class
  of the JAX run's.
"""

import numpy as np

import torch_tiering_cases as C
from distributed_embeddings_tpu import tiering as jt
from torch_ranks import spawn_start, spawn_wait

TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)
TABLE_TOL = dict(rtol=1e-4, atol=1e-5)
WORLD = 4
RUNS = {
    "rerank": (dict(cache_fraction=0.3, staging_grps=64, rerank_interval=3),
               {}),
    "spill": (dict(cache_fraction=0.3, staging_grps=2), {}),
    "fused": (dict(cache_fraction=0.3, staging_grps=64, rerank_interval=3),
              {"overlap": "fused", "exchange_chunks": 2}),
    "dedup": (dict(cache_fraction=0.3, staging_grps=64, rerank_interval=3),
              {"dedup_exchange": True}),
}
CKPT_CFG = dict(cache_fraction=0.3, staging_grps=16, rerank_interval=2)


def _jax_ckpt(path, batches):
  """The JAX world-4 tiered run of the checkpoint case: three steps,
  save, the rest; returns its tail losses and the saved tier arrays."""
  import jax
  import jax.numpy as jnp
  import optax
  from distributed_embeddings_tpu import checkpoint as jck
  from distributed_embeddings_tpu.models import bce_loss
  from distributed_embeddings_tpu.ops.packed_table import sparse_rule
  from distributed_embeddings_tpu.parallel import create_mesh
  from distributed_embeddings_tpu.training import shard_params
  del jax
  plan = C.jax_plan(WORLD)
  rule = sparse_rule("adagrad", C.LR)
  opt = optax.adagrad(C.LR)
  mesh = create_mesh(WORLD)
  dense_p, tables = C.jax_params(WORLD)

  def trainer(zeros=False):
    params = dict(dense_p)
    params["embeddings"] = {k: jnp.asarray(np.zeros_like(v) if zeros else v)
                            for k, v in tables.items()}
    tplan = jt.TieringPlan(plan, rule, jt.TieringConfig(**CKPT_CFG))
    store = jt.HostTierStore(tplan)
    state = shard_params(jt.init_tiered_state_from_params(
        tplan, store, rule, params, opt, mesh=mesh), mesh)
    return store, jt.TieredTrainer(C.jax_model(WORLD), tplan, store,
                                   bce_loss, opt, rule, mesh, state,
                                   batches[0], donate=False)

  store, tr = trainer()
  tr.run(batches[:3])
  jck.save(path, plan, rule, tr.state, store=store)
  saved = _arrays(store)
  tail = tr.run(batches[3:])

  def resume(from_path):
    store2, tr2 = trainer(zeros=True)
    tr2.state = shard_params(jck.restore(from_path, plan, rule, tr2.state,
                                         mesh=mesh, store=store2), mesh)
    tr2.prefetcher.refresh_resident()
    return _arrays(store2), tr2.run(batches[3:])

  return tail, saved, resume


def _arrays(store):
  return {f"{part}/{name}/{r}": np.asarray(v).copy()
          for part in ("images", "resident_grps", "counts")
          for name, per in getattr(store, part).items()
          for r, v in enumerate(per) if v is not None}


def test_world4_tiered_matches_jax(tmp_path):
  batches = [C.jax_batch(100 + i) for i in range(6)]
  dense, tables = C.jax_params(WORLD)
  tiered_spec = {
      "dense": dense, "tables": {"base": tables}, "batches": batches,
      "runs": [{"name": n, "cfg": cfg, "plan_kw": kw}
               for n, (cfg, kw) in RUNS.items()]}
  jax_path, port_path = str(tmp_path / "jax_ckpt"), str(tmp_path / "port")
  jtail, jsaved, jresume = _jax_ckpt(jax_path, batches)
  ckpt_spec = {
      "dense": dense, "batches": batches, "jax_path": jax_path,
      "port_path": port_path,
      "tables": {"base": tables,
                 "zeros": {k: np.zeros_like(v) for k, v in tables.items()}},
      "run": {"cfg": CKPT_CFG, "dense": "adagrad"}}
  started = spawn_start(tmp_path, WORLD, "multi_job", {"jobs": {
      "tiered": ("tiered_job", tiered_spec),
      "ckpt": ("tiered_ckpt_job", ckpt_spec)}})
  want = {n: C.jax_run(WORLD, jt.TieringConfig(**cfg), batches, plan_kw=kw)
          for n, (cfg, kw) in RUNS.items()}
  got = spawn_wait(started)

  for name in RUNS:
    w = want[name]
    for rank in range(WORLD):
      g = got[rank]["tiered"][name]
      np.testing.assert_allclose(g["losses"], w["losses"], err_msg=name,
                                 **TRAJ_TOL)
      for t, (a, b) in enumerate(zip(g["weights"], w["weights"])):
        np.testing.assert_allclose(a, b, err_msg=f"{name} table {t}",
                                   **TABLE_TOL)
      assert g["summary"]["spill_steps"] == w["summary"]["spill_steps"]
      assert g["summary"]["per_class"] == w["summary"]["per_class"], name
      for cname in w["hits"]:
        np.testing.assert_array_equal(g["hits"][cname], w["hits"][cname])
        for r in range(WORLD):
          np.testing.assert_array_equal(g["resident"][cname][r],
                                        w["resident"][cname][r])
          np.testing.assert_array_equal(g["counts"][cname][r],
                                        w["counts"][cname][r])
    assert sum(got[r]["tiered"][name]["summary"]["host_gather_bytes"]
               for r in range(WORLD)) == w["summary"]["host_gather_bytes"]
  assert want["spill"]["summary"]["spill_steps"] >= 5
  assert all(m["missed"] == 0 for w in want.values()
             for m in w["summary"]["per_class"].values())

  ck = [got[r]["ckpt"] for r in range(WORLD)]
  for rank in range(WORLD):
    assert ck[rank]["resumed"] == ck[rank]["tail"]  # bit-equal resume
    np.testing.assert_allclose(ck[rank]["from_jax"], jtail, **TRAJ_TOL)
    for k, v in ck[rank]["restored"].items():
      np.testing.assert_array_equal(v, jsaved[k], err_msg=k)
  # every rank saved its own image and the replicated bookkeeping
  port_saved = {}
  for rank in range(WORLD):
    port_saved.update({k: v for k, v in ck[rank]["saved"].items()
                       if not k.startswith("images/")
                       or k.endswith(f"/{rank}")})
  restored, jresumed = jresume(port_path)
  assert sorted(restored) == sorted(port_saved)
  for k, v in restored.items():
    np.testing.assert_array_equal(v, port_saved[k], err_msg=k)
  np.testing.assert_allclose(jresumed, ck[0]["tail"], **TRAJ_TOL)
