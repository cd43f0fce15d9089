"""The in-run elastic resize and pod membership in the port
(``resilience/elastic.py``: ``elastic_resize``, the membership files and
``PreemptionSupervisor``; ``ResilientTrainer.resize``;
``TieredPrefetcher.rebind``) against the JAX package's, on
``tests/test_elastic.py``'s cells.

- **``elastic_resize`` in one process** (``new_mesh=None``: a whole-world
  state, every rank's blocks): 4 -> 2 -> 4 bit-equal to the JAX
  package's ``elastic_resize`` of the same state at each boundary (every
  packed block, dense-class block, dense parameter and optax leaf), the
  world as an int or a plan alike, the refusals with the JAX reasons, a
  tiered state's images, resident sets and re-mapped counts, and a
  partly owned store refused without a spill directory.
- **``ResilientTrainer.resize`` with a pod directory** in one process: the
  membership barrier's record, the counter, the half-specified refusal,
  and the result equal to the in-process re-shard.
- **Across processes**: one spawn of four gloo ranks
  (``tests/torch_ranks.py: preempt_job``) resizes a guarded run 4 -> 2 ->
  4 with NaN batches around the boundaries, two members parking and
  coming back: at each boundary the new world's arrays equal the
  whole-world ``elastic_resize`` of the old world's, ``consumed ==
  steps + skipped`` on every member, the losses equal an unresized run
  before the first resize and stay in its f32 class after. A tiered run
  resizes 4 -> 2 the same way (each rank's store owning its rank): the
  stores and state equal the whole-world re-shard, no lookup misses.
- **Membership**: the barrier (agreement, epochs, a disagreeing member
  named), leases of live, dead and recycled pids, the supervisor's
  target world; **the prefetcher's rebind** keeps its counters.
"""

import functools
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import test_elastic as te
import test_preempt as tp
import test_torch_elastic as tte
import torch_ranks
from distributed_embeddings_torch import tiering as tt
from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import (
    dense_state_dict_from_flax,
    train_state_from_flax,
)
from distributed_embeddings_torch.models import bce_loss
from distributed_embeddings_torch.parallel.lookup_engine import (
    class_param_name,
    padded_rows,
)
from distributed_embeddings_torch.parallel.mesh import rank_mesh
from distributed_embeddings_torch.resilience import elastic
from distributed_embeddings_torch.resilience.trainer import ResilientTrainer
from distributed_embeddings_torch.serving.export import _unflatten_paths
from distributed_embeddings_torch.telemetry import MetricsRegistry
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.resilience import elastic as jel
from distributed_embeddings_tpu.resilience import faultinject as jfi
from distributed_embeddings_tpu.tiering import HostTierStore as JStore
from distributed_embeddings_tpu.tiering import TieringPlan as JTPlan

RULE = tte.RULE
FACTORY = tte.FACTORY
N_STEPS = 12
NAN_AT = {3, 7}
SHRINK_AT, GROW_AT = 5, 9
TIERED_STEPS = 3
TIERED_CFG = dict(cache_fraction=0.3, staging_grps=64)


# ---------------------------------------------------------------------------
# the module's one spawn: four pod members, started first
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
  """Start the four ranks at the module's first test; the tests that read
  them wait (the in-process tests run meanwhile)."""
  tmp = tmp_path_factory.mktemp("preempt")
  mesh4 = create_mesh(4)
  state = tte._host(te.init(4, mesh4)[4])
  batches = [te.make_batch(100 + i) for i in range(N_STEPS)]
  stream = list(jfi.nan_batches(batches, at_steps=NAN_AT))
  started = torch_ranks.spawn_start(tmp, 4, "preempt_job", {
      "vocab": te.VOCAB, "state": state, "batches": stream,
      "shrink_at": SHRINK_AT, "grow_at": GROW_AT,
      "tiered_steps": TIERED_STEPS, "pod": str(tmp / "pod")})
  box = {}

  def results():
    if "res" not in box:
      box["res"] = torch_ranks.spawn_wait(started)
    return box["res"]

  yield results
  results()  # never leave the ranks running


# ---------------------------------------------------------------------------
# helpers: a whole-world port state from rank arrays
# ---------------------------------------------------------------------------


def _global(per_rank, plan):
  """Rank arrays (``torch_ranks._rank_arrays``' form) -> the whole-world
  arrays: fused and dense-class row blocks concatenated by rank, the
  replicated leaves from rank 0 (equal on every rank)."""
  dense_rows = {class_param_name(*k): padded_rows(plan, k)
                for k in plan.class_keys if plan.classes[k].kind != "sparse"}
  out = {}
  for k, v in per_rank[0].items():
    if k.startswith(("images/", "resident_grps/", "counts/")):
      continue
    name = k.rpartition("/")[2]
    if k.startswith("fused/") or (k.startswith("emb_dense")
                                  and name in dense_rows):
      out[k] = np.concatenate([r[k] for r in per_rank])
    else:
      for r in per_rank[1:]:
        np.testing.assert_array_equal(r[k], v, err_msg=k)
      out[k] = np.asarray(v)
  return out


def _state_of(glob, factory):
  """A whole-world port state from :func:`_global`'s arrays."""

  def part(p):
    return {k.split("/", 1)[1]: v for k, v in glob.items()
            if k.startswith(p + "/")}

  state = {
      "fused": {k: torch.from_numpy(v.copy()) for k, v in part(
          "fused").items()},
      "emb_dense": {k: torch.from_numpy(v.copy()) for k, v in part(
          "emb_dense").items()},
      "dense": dense_state_dict_from_flax(_unflatten_paths(part("dense"))),
      "dense_opt": ttr.OptaxState(part("dense_opt")),
      "emb_dense_opt": ttr.OptaxState(part("emb_dense_opt")),
      "step": int(glob["step"]),
  }
  return ttr._with_optimizers(state, factory, None)


_arrays = tte._port_arrays


# ---------------------------------------------------------------------------
# elastic_resize in one process, against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained4():
  """The JAX world-4 state after three steps, and its port copy."""
  mesh4, plan4, step4, state = tp.sparse_world(4)
  sb = te.shard_batch(te.make_batch(), mesh4)
  for _ in range(3):
    state, _ = step4(state, *sb)
  return plan4, state


def test_elastic_resize_roundtrip_bit_exact(trained4):
  plan4j, state = trained4
  reg = MetricsRegistry()
  port = tte._port_like(state)
  want = te.logical_tables(plan4j, te.RULE, tte._host(state))
  p2, s2 = elastic.elastic_resize(port, tte._tplan(4), 2, RULE,
                                  telemetry=reg)
  assert p2.world_size == 2 and s2["step"] == 3
  plan2j, j2 = jel.elastic_resize(state, plan4j, 2, te.RULE,
                                  new_mesh=create_mesh(2))
  tte._assert_arrays_equal(_arrays(s2), tte._jax_arrays(j2))
  p4, s4 = elastic.elastic_resize(s2, p2, 4, RULE, telemetry=reg)
  _, j4 = jel.elastic_resize(j2, plan2j, 4, te.RULE, new_mesh=create_mesh(4))
  got = _arrays(s4)
  tte._assert_arrays_equal(got, tte._jax_arrays(j4))
  fused = {k[6:]: v for k, v in got.items() if k.startswith("fused/")}
  emb = {k[10:]: v for k, v in got.items() if k.startswith("emb_dense/")}
  te.assert_tables_equal(want, te.logical_tables(
      plan4j, te.RULE, {"fused": fused, "emb_dense": emb}))
  assert reg.counter("elastic/resizes").value == 2
  assert reg.histogram("elastic/quiesce_s").count == 2


def test_elastic_resize_accepts_plan_or_world_int(trained4):
  _, state = trained4
  port = tte._port_like(state)
  p_a, s_a = elastic.elastic_resize(port, tte._tplan(4), 2, RULE)
  p_b, s_b = elastic.elastic_resize(port, tte._tplan(4), tte._tplan(2), RULE)
  assert p_a.world_size == p_b.world_size == 2
  tte._assert_arrays_equal(_arrays(s_a), _arrays(s_b))


def test_resize_refusals_name_the_reason(trained4):
  plan4j, state = trained4
  port = tte._port_like(state)
  from distributed_embeddings_tpu.layers.planner import \
      DistEmbeddingStrategy as JStrategy

  def both(vocab, **kw):
    args = ([dict(input_dim=v, output_dim=16,
                  initializer={"name": "uniform", "scale": 0.05})
             for v in vocab], 2, "basic")
    return JStrategy(*args, **kw), tte.TStrategy(*args, **kw)

  for match, (jp, tpl) in {
      "tables differ": both([v + 1 for v in te.VOCAB],
                            dense_row_threshold=32),
      "kind": both(te.VOCAB, dense_row_threshold=0),
      "tier": both(te.VOCAB, dense_row_threshold=32,
                   host_row_threshold=250)}.items():
    with pytest.raises(ValueError) as got:
      elastic.elastic_resize(port, tte._tplan(4), tpl, RULE)
    with pytest.raises(ValueError) as want:
      jel.elastic_resize(state, plan4j, jp, te.RULE)
    assert str(got.value) == str(want.value) and match in str(got.value)


def _tiered_pair():
  """A JAX world-4 tiered state and store (drawn images, random observed
  counts), and the port's copy of both."""
  mesh4 = create_mesh(4)
  plan4, _, tplan4, store4, _, state4 = te.tiered_fresh(4, mesh4)
  rng = np.random.default_rng(11)
  for name, per in store4.counts.items():
    for cnt in per:
      cnt[:] = rng.integers(0, 50, cnt.shape)
  tplan = tt.TieringPlan(_tiered_tplan(4), RULE,
                         tt.TieringConfig(**TIERED_CFG))
  store = tt.HostTierStore(tplan)
  for name in store.images:
    for r in range(4):
      store.set_image(name, r, np.asarray(store4.images[name][r]))
      store.resident_map[name][r][:] = store4.resident_map[name][r]
      store.resident_grps[name][r] = store4.resident_grps[name][r].copy()
      store.counts[name][r][:] = store4.counts[name][r]
  port = ttr._with_optimizers(
      train_state_from_flax(tte._host(state4), device="cpu"),
      functools.partial(ttr.Adam, lr=1e-3), None)
  return plan4, store4, state4, tplan, store, port


def _tiered_tplan(world):
  return tte.TStrategy([dict(input_dim=v, output_dim=te.T_WIDTH)
                        for v in te.T_VOCAB], world, "memory_balanced",
                       dense_row_threshold=0, host_row_threshold=1000)


def test_tiered_resize_remaps_counts_bit_exact():
  plan4, jstore4, jstate4, tplan4, store4, port = _tiered_pair()
  plan2j, _ = te.tiered_build(2)
  jstore2 = JStore(JTPlan(plan2j, te.RULE, te.T_CFG))
  _, j2 = jel.elastic_resize(jstate4, plan4, plan2j, te.RULE,
                             new_mesh=create_mesh(2), old_store=jstore4,
                             new_store=jstore2)
  store2 = tt.HostTierStore(tt.TieringPlan(_tiered_tplan(2), RULE,
                                           tt.TieringConfig(**TIERED_CFG)))
  _, s2 = elastic.elastic_resize(port, tplan4.plan, store2.tplan.plan,
                                 RULE, old_store=store4, new_store=store2)
  for part in ("images", "resident_grps", "counts"):
    for name, per in getattr(jstore2, part).items():
      for r, v in enumerate(per):
        np.testing.assert_array_equal(getattr(store2, part)[name][r],
                                      np.asarray(v),
                                      err_msg=f"{part} {name} {r}")
  tte._assert_arrays_equal(_arrays(s2), tte._jax_arrays(j2))
  assert sum(int(c.sum()) for per in store2.counts.values()
             for c in per) > 0


def test_partly_owned_store_needs_a_spill_dir():
  plan4, _, _, tplan4, store4, port = _tiered_pair()
  partial = tt.HostTierStore(tplan4, owned_ranks=(0, 1))
  store2 = tt.HostTierStore(tt.TieringPlan(_tiered_tplan(2), RULE,
                                           tt.TieringConfig(**TIERED_CFG)))
  with pytest.raises(ValueError, match="needs spill_dir"):
    elastic.elastic_resize(port, tplan4.plan, 2, RULE, old_store=partial,
                           new_store=store2)


# ---------------------------------------------------------------------------
# ResilientTrainer.resize with a pod directory, in one process
# ---------------------------------------------------------------------------


def test_resize_membership_barrier_wiring(tmp_path, trained4):
  _, state = trained4
  reg = MetricsRegistry()
  t = ResilientTrainer(None, tte._port_like(state), tte._tplan(4), RULE,
                       str(tmp_path / "ckpts"), resume=False, telemetry=reg)
  model = torch_ranks._elastic_cell(1, {"vocab": te.VOCAB})[1]
  step1 = ttr.make_sparse_train_step(model, tte._tplan(1), bce_loss,
                                     FACTORY, RULE, guard=True)
  pod = str(tmp_path / "pod")
  with pytest.raises(ValueError, match="membership-change barrier"):
    t.resize(1, step1, new_mesh=rank_mesh(1, 0, "cpu"), pod_dir=pod)
  want = elastic.elastic_resize(t.state, t.plan, 1, RULE)[1]
  got = t.resize(1, step1, new_mesh=rank_mesh(1, 0, "cpu"), pod_dir=pod,
                 barrier_epoch=1, member_id="m0", n_participants=1)
  assert got.world_size == 1 and t.mesh.world == 1
  assert os.path.exists(os.path.join(pod, "barriers", "000001", "m0.json"))
  assert reg.counter("elastic/membership_barriers").value == 1
  assert reg.counter("elastic/resizes").value == 1
  tte._assert_arrays_equal(_arrays(t.state), _arrays(want))
  # the spill is gone after the move
  assert not os.listdir(os.path.join(pod, "spill"))


# ---------------------------------------------------------------------------
# across processes: 4 -> 2 -> 4 with two members parking
# ---------------------------------------------------------------------------


def test_trainer_resize_4_2_4_across_processes(ranks):
  res = ranks()
  plans = {w: tte._tplan(w) for w in (2, 4)}
  for epoch, (src, dst) in ((1, (4, 2)), (2, (2, 4))):
    before = [r["boundary"][f"{epoch}/before"]
              for r in res if f"{epoch}/before" in r["boundary"]]
    after = [r["boundary"][f"{epoch}/after"]
             for r in res if f"{epoch}/after" in r["boundary"]]
    assert len(before) == src and len(after) == dst
    old = _state_of(_global(before, plans[src]), FACTORY)
    _, want = elastic.elastic_resize(old, plans[src], dst, RULE)
    tte._assert_arrays_equal(_global(after, plans[dst]), _arrays(want))
  for rank, r in enumerate(res):
    acc = r["accounting"]
    assert acc["consumed"] == N_STEPS and acc["skipped"] == len(NAN_AT)
    assert acc["consumed"] == acc["steps"] + acc["skipped"]
    assert acc["resumed_from"] is None and acc["barriers"] == 2
    # members 2 and 3 parked for the middle of the stream
    ran = sorted(r["losses"])
    assert ran == (list(range(N_STEPS)) if rank < 2 else
                   [i for i in range(N_STEPS)
                    if i < SHRINK_AT or i >= GROW_AT])
    ref = r["ref_losses"]
    for i, loss in r["losses"].items():
      if i in NAN_AT:
        assert np.isnan(loss) and np.isnan(ref[i])
      elif i < SHRINK_AT:
        assert loss == ref[i], f"rank {rank} step {i}"
      else:
        assert np.isclose(loss, ref[i], rtol=5e-4, atol=1e-5), i


def test_tiered_resize_4_to_2_across_processes(ranks):
  res = ranks()
  assert [r["tiered"].get("parked", False) for r in res] == \
      [False, False, True, True]
  plan4, plan2 = _tiered_tplan(4), _tiered_tplan(2)
  cfg = tt.TieringConfig(**TIERED_CFG)
  old_store = tt.HostTierStore(tt.TieringPlan(plan4, RULE, cfg))
  before = [r["tiered"]["before"] for r in res]
  for name in old_store.images:
    for r, b in enumerate(before):
      old_store.set_image(name, r, b[f"images/{name}/{r}"])
      for part in ("resident_grps", "counts"):
        getattr(old_store, part)[name][r] = b[f"{part}/{name}/{r}"].copy()
      old_store.resident_map[name][r][:] = -1
      old_store.resident_map[name][r][b[f"resident_grps/{name}/{r}"]] = \
          np.arange(b[f"resident_grps/{name}/{r}"].shape[0], dtype=np.int32)
  old = _state_of(_global(before, plan4), functools.partial(
      ttr.Adagrad, lr=0.05))
  new_store = tt.HostTierStore(tt.TieringPlan(plan2, RULE, cfg))
  _, want = elastic.elastic_resize(old, plan4, plan2, RULE,
                                   old_store=old_store, new_store=new_store)
  after = [r["tiered"]["after"] for r in res[:2]]
  for r, a in enumerate(after):
    for name in new_store.images:
      np.testing.assert_array_equal(a[f"images/{name}/{r}"],
                                    new_store.images[name][r])
      for part in ("resident_grps", "counts"):
        for q in range(2):
          np.testing.assert_array_equal(a[f"{part}/{name}/{q}"],
                                        getattr(new_store, part)[name][q])
  tte._assert_arrays_equal(_global(after, plan2), _arrays(want))
  for r in res[:2]:
    assert r["tiered"]["missed"] == 0
    consumed, steps, skipped = r["tiered"]["accounting"]
    assert consumed == TIERED_STEPS + 2 == steps + skipped
    assert all(np.isfinite(r["tiered"]["losses"]))


# ---------------------------------------------------------------------------
# membership, the supervisor, the prefetcher's rebind
# ---------------------------------------------------------------------------


def test_membership_barrier(tmp_path):
  pod = str(tmp_path)
  res = {}

  def post(mid):
    res[mid] = elastic.membership_barrier(pod, 1, mid, 2, step=7, world=4)

  t = threading.Thread(target=post, args=("m1",))
  t.start()
  got = elastic.membership_barrier(pod, 1, "m0", 2, step=7, world=4)
  t.join()
  assert got == (7, 4) and res["m1"] == (7, 4)
  with pytest.raises(RuntimeError, match="only \\['m0'\\] of 2"):
    elastic.membership_barrier(pod, 2, "m0", 2, step=8, world=4,
                               timeout_s=0.3)
  d = os.path.join(pod, "barriers", "000003")
  os.makedirs(d)
  with open(os.path.join(d, "m1.json"), "w") as f:
    f.write('{"id": "m1", "step": 9, "world": 4}')
  with pytest.raises(RuntimeError, match="DISAGREES.*m1"):
    elastic.membership_barrier(pod, 3, "m0", 2, step=8, world=4)
  # a parked member posts no step and adopts the survivors'
  d = os.path.join(pod, "barriers", "000004")
  os.makedirs(d)
  with open(os.path.join(d, "m1.json"), "w") as f:
    f.write('{"id": "m1", "step": 12, "world": 2}')
  assert elastic.membership_barrier(pod, 4, "m2", 2, step=None,
                                    world=2) == (12, 2)


def test_membership_and_target_world(tmp_path):
  pod = str(tmp_path)
  sup = elastic.PreemptionSupervisor(pod, allowed_worlds=(1, 2, 4))
  assert sup.target_world() == 1
  assert elastic.agreed_target_world(sup) == 1  # no process group: local
  elastic.register_member(pod, "leader")
  assert elastic.alive_members(pod) == {"leader": os.getpid()}
  for k in range(3):
    elastic.register_member(pod, f"w{k}")
  assert sup.target_world() == 4
  assert elastic.member_rank(sup.members(), "w2", 4) == 3
  assert elastic.member_rank(sup.members(), "w2", 2) is None  # parks
  child = subprocess.Popen([sys.executable, "-c", ""])
  child.wait()
  elastic.register_member(pod, "w0", pid=child.pid)
  assert "w0" not in elastic.alive_members(pod)
  assert sup.target_world() == 2
  elastic.withdraw_member(pod, "w1")
  elastic.withdraw_member(pod, "w2")
  assert sup.target_world() == 1
  with open(os.path.join(pod, "members", "junk.json"), "w") as f:
    f.write("{not json")
  assert elastic.alive_members(pod) == {"leader": os.getpid()}


def test_recycled_pid_lease_is_stale(tmp_path):
  pod = str(tmp_path)
  elastic.register_member(pod, "w0")
  path = elastic.member_path(pod, "w0")
  with open(path) as f:
    rec = json.load(f)
  assert rec["start"] is not None  # /proc is there on Linux
  rec["start"] = int(rec["start"]) + 1  # same pid, another incarnation
  with open(path, "w") as f:
    json.dump(rec, f)
  assert "w0" not in elastic.alive_members(pod)
  del rec["start"]
  with open(path, "w") as f:
    json.dump(rec, f)
  assert "w0" in elastic.alive_members(pod)
  # the JAX package reads the port's lease the same way
  assert jel.alive_members(pod) == elastic.alive_members(pod)


def test_supervisor_validates_worlds(tmp_path):
  for worlds in ((), (0, 2)):
    with pytest.raises(ValueError) as got:
      elastic.PreemptionSupervisor(str(tmp_path), allowed_worlds=worlds)
    with pytest.raises(ValueError) as want:
      jel.PreemptionSupervisor(str(tmp_path), allowed_worlds=worlds)
    assert str(got.value) == str(want.value)


def test_prefetcher_rebind():
  _, _, _, tplan4, store4, _ = _tiered_pair()
  pf = tt.TieredPrefetcher(tplan4, store4, device="cpu")
  pf.prepare(te.tiered_batch(100)[1])
  bytes_before = pf.total_host_gather_bytes
  assert bytes_before > 0
  tplan2 = tt.TieringPlan(_tiered_tplan(2), RULE,
                          tt.TieringConfig(**TIERED_CFG))
  store2 = tt.HostTierStore(tplan2)
  store2.init_uniform(3)
  pf.steps_since_rerank = 5
  pf.rebind(tplan2, store2)
  assert pf.plan is tplan2.plan and pf.steps_since_rerank == 0
  assert pf.total_host_gather_bytes == bytes_before
  cold = pf.classify(te.tiered_batch(200)[1])  # routes against the NEW plan
  assert set(cold) == set(tplan2.tier_specs)
  assert all(len(per_rank) == 2 for per_rank in cold.values())
