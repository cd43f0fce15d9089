"""Tiered storage in the port (``distributed_embeddings_torch/tiering/``)
against the JAX package's, world 1, on ``tests/test_tiering.py``'s cell
(``tests/torch_tiering_cases.py``: vocabularies ``[5000, 300, 40]``,
width 16, ``host_row_threshold=1000``, Adagrad 0.05, power-law ids).

- **Plan.** ``TieringPlan`` geometry, compact layouts, spill caps and
  byte counts equal the JAX plan's for fraction and budget configs
  (world 1 and 4), and its refusals carry the JAX messages.
- **Translation.** ``_translate_tier`` bit-exact against JAX's on ids
  that are hot, staged, cold-missed, negative and the sentinel, at
  rows-per-physical-row 1 and 8, with and without staged rows, int32 and
  int64 ids (the dtype kept).
- **Classify and stage.** Cold lists and observed counts bit-exact
  against the JAX prefetcher's (world 1 and a world-4 store in one
  process), bucket and spill sizes equal, the "cannot serve" refusal, the
  staged blocks equal.
- **Re-rank.** Value-preserving (the flushed images unchanged) with
  resident maps equal to JAX's.
- **Images.** ``HostTierStore.init_uniform`` (numpy) draws the JAX
  package's images bit for bit.
- **Trajectory.** ``TieredTrainer`` with ``mesh=None`` against the JAX
  ``TieredTrainer`` (dense side ``optax.adam`` / ``torch.optim.Adam``):
  losses within rtol 1e-5 / atol 1e-6, reconciled tables within rtol 1e-4
  / atol 1e-5 (JAX's own ``_assert_parity``), hit counters, spill steps,
  resident sets and counts equal; for the cache-fraction config with
  re-ranks, the staging overflow config (every step spills) and the
  HBM-budget config.
- **Guard.** A poisoned batch through the guarded trainer leaves every
  buffer and image bit-equal and is counted.
- **Refusals.** ``make_tiered_train_step``'s refusals with the JAX
  messages, ``overlap_host`` building the pipelined trainer, ``RaggedIds`` in the
  classify.
"""

import functools

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_tiering_cases as C
from distributed_embeddings_torch import tiering as tt
from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import dlrm_state_dict_from_flax
from distributed_embeddings_torch.layers.dist_model_parallel import \
    get_weights
from distributed_embeddings_torch.models import bce_loss
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_torch.ops.ragged import RaggedIds
from distributed_embeddings_torch.parallel import lookup_engine as tle
from distributed_embeddings_tpu import tiering as jt
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.parallel import lookup_engine as jle

TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)
TABLE_TOL = dict(rtol=1e-4, atol=1e-5)
CONFIGS = {
    "fraction_rerank": dict(cache_fraction=0.3, staging_grps=64,
                            rerank_interval=3),
    "spill": dict(cache_fraction=0.3, staging_grps=2),
}


def _budget_cfg(world=1):
  """``test_hbm_budget_end_to_end``'s budget: the device tier plus half
  the cold stores."""
  report = C.jax_plan(world).tier_capacity_report(1)
  return dict(hbm_budget_bytes=report["device_bytes_per_rank"]
              + report["host_bytes_per_rank"] // 2,
              staging_grps=64, rerank_interval=3)


def _plans(world, cfg, rule="adagrad", **kw):
  jrule = getattr(jpt, f"{rule}_rule")(C.LR)
  trule = getattr(tpt, f"{rule}_rule")(C.LR)
  return (jt.TieringPlan(C.jax_plan(world, **kw), jrule, jt.TieringConfig(
      **cfg)), tt.TieringPlan(C.torch_plan(world, **kw), trule,
                              tt.TieringConfig(**cfg)))


def _adam():
  return functools.partial(torch.optim.Adam, lr=C.ADAM_LR)


def _port_trainer(cfg, guard=False, dense="adam"):
  plan = C.torch_plan(1)
  rule = tpt.adagrad_rule(C.LR)
  tplan = tt.TieringPlan(plan, rule, tt.TieringConfig(**cfg))
  store = tt.HostTierStore(tplan)
  dense_p, tables = C.jax_params(1)
  params = dict(dlrm_state_dict_from_flax(dense_p))
  params["embeddings"] = tables
  factory = (_adam() if dense == "adam"
             else functools.partial(ttr.Adagrad, lr=C.LR))
  state = tt.init_tiered_state_from_params(tplan, store, rule, params,
                                           factory, device="cpu")
  trainer = tt.TieredTrainer(C.torch_model(), tplan, store, bce_loss,
                             factory, rule, None, state, guard=guard,
                             device="cpu")
  return tplan, rule, store, trainer


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("cfg", ["fraction", "budget", "tiny_staging"])
def test_plan_geometry_matches_jax(world, cfg):
  kw = {"fraction": dict(cache_fraction=0.3, staging_grps=64),
        "budget": _budget_cfg(world),
        "tiny_staging": dict(cache_fraction=0.9, staging_grps=1,
                             spill_factor_max=1)}[cfg]
  jplan, tplan = _plans(world, kw)
  assert tplan.geometry() == jplan.geometry()
  assert tplan.rows_overrides == jplan.rows_overrides
  assert tplan.device_bytes_per_rank() == jplan.device_bytes_per_rank()
  assert tplan.host_bytes_per_rank() == jplan.host_bytes_per_rank()
  assert sorted(tplan.tier_specs) == sorted(jplan.tier_specs)
  for name, spec in jplan.tier_specs.items():
    assert tplan.tier_specs[name].__dict__ == spec.__dict__
    j, t = jplan.by_name(name), tplan.by_name(name)
    assert t.spill_cap_grps == j.spill_cap_grps
    for lay in ("layout_logical", "layout_compact"):
      jl, tl = getattr(j, lay), getattr(t, lay)
      assert (tl.rows, tl.width, tl.n_aux, tl.phys_rows, tl.phys_width) == (
          jl.rows, jl.width, jl.n_aux, jl.phys_rows, jl.phys_width)


def _same_refusal(fn_t, fn_j, exc=ValueError):
  with pytest.raises(exc) as got:
    fn_t()
  with pytest.raises(exc) as want:
    fn_j()
  assert str(got.value).startswith(str(want.value))
  return str(got.value)


def test_plan_refusals_match_jax():
  jrule, trule = jpt.adagrad_rule(C.LR), tpt.adagrad_rule(C.LR)
  report = C.jax_plan(1).tier_capacity_report(1)
  cases = [
      ((None,), {}, "no host-tier classes"),
      ((C.HOST_THR,), {"staging_grps": 0}, "staging_grps must be"),
      ((C.HOST_THR,), {"hbm_budget_bytes": report["device_bytes_per_rank"],
                       "staging_grps": 16}, "leaves no room"),
  ]
  for args, cfg, match in cases:
    msg = _same_refusal(
        lambda: tt.TieringPlan(C.torch_plan(1, *args), trule,
                               tt.TieringConfig(**cfg)),
        lambda: jt.TieringPlan(C.jax_plan(1, *args), jrule,
                               jt.TieringConfig(**cfg)))
    assert match in msg


# ---------------------------------------------------------------------------
# translation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rpp", [1, 8])
@pytest.mark.parametrize("s", [0, 5])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_translate_tier_bit_exact(rpp, s, dtype):
  rng = np.random.default_rng(rpp * 10 + s)
  rows = 800
  phys = rows // rpp
  cache = phys // 4
  spec_kw = dict(name="c", rows=rows, rpp=rpp, cache_grps=cache,
                 staging_grps=max(s, 1))
  resident = np.full((phys,), -1, np.int32)
  hot = rng.choice(phys, cache, replace=False)
  resident[hot] = np.arange(cache, dtype=np.int32)
  cold = np.setdiff1d(np.arange(phys), hot)
  staged = np.sort(rng.choice(cold, s, replace=False)).astype(np.int32)
  staged_pad = np.concatenate([staged, np.full((3,), jle.TIER_PAD_GRP,
                                               np.int32)]) if s else staged
  sentinel = rows
  ids = np.concatenate([
      rng.integers(0, rows, 200),           # hot, staged and missed
      np.repeat(staged, rpp) * rpp if s else [],  # every staged row
      [-1, -5, sentinel, sentinel + 3]]).astype(dtype)
  ids = ids.reshape(-1) if ids.shape[0] % 4 else ids.reshape(-1, 4)
  want, wm = jle._translate_tier(jnp.asarray(ids), jle.TierSpec(**spec_kw),
                                 sentinel, jnp.asarray(resident),
                                 jnp.asarray(staged_pad))
  got, gm = tle._translate_tier(torch.from_numpy(ids),
                                tle.TierSpec(**spec_kw), sentinel,
                                torch.from_numpy(resident),
                                torch.from_numpy(staged_pad))
  assert got.dtype == torch.from_numpy(ids).dtype
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
  hot_n, staged_n, missed, total = gm.tolist()
  assert total == hot_n + staged_n + missed and missed > 0 and hot_n > 0
  assert (staged_n > 0) == bool(s)


# ---------------------------------------------------------------------------
# classify, stage, spill, re-rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 4])
def test_classify_and_stage_match_jax(world):
  cfg = dict(cache_fraction=0.3, staging_grps=4)
  jplan, tplan = _plans(world, cfg)
  jstore, tstore = jt.HostTierStore(jplan), tt.HostTierStore(tplan)
  jstore.init_uniform(5)
  tstore.init_uniform(5)
  jpf = jt.TieredPrefetcher(jplan, jstore)
  tpf = tt.TieredPrefetcher(tplan, tstore, device="cpu")
  for seed in (200, 201):
    cats = C.jax_batch(seed, batch=64)[1]
    jcold = jpf.classify(cats)
    tcold = tpf.classify([torch.from_numpy(c) for c in cats])
    jb, tb = jpf.gather_cold(jcold), tpf.gather_cold(tcold)
    for name in jcold:
      for r in range(world):
        np.testing.assert_array_equal(tcold[name][r], jcold[name][r])
        np.testing.assert_array_equal(tstore.counts[name][r],
                                      jstore.counts[name][r])
        np.testing.assert_array_equal(tb.g_blocks[name][r],
                                      jb.g_blocks[name][r])
        np.testing.assert_array_equal(tb.r_blocks[name][r],
                                      jb.r_blocks[name][r])
    assert tb.s_eff == jb.s_eff and tb.spilled == jb.spilled
    assert tb.host_gather_bytes == jb.host_gather_bytes
  assert tb.spilled  # staging_grps=4 overflows
  # the overlap's repair: rows both batches staged re-gathered after the
  # previous write-back, as the JAX prefetcher does
  for store in (jstore, tstore):
    for name in store.images:
      for r in range(world):
        store.images[name][r] += 1.0  # the "write-back" landed
  prev = {n: [g[::2] for g in per] for n, per in tcold.items()}
  assert tpf.repair_conflicts(tb, prev) == jpf.repair_conflicts(jb, prev)
  for name in tb.r_blocks:
    for r in range(world):
      np.testing.assert_array_equal(tb.r_blocks[name][r],
                                    jb.r_blocks[name][r])
  staged = tpf.upload_staged(tb)
  for name, s in tb.s_eff.items():
    assert tuple(staged.device["grps"][name].shape) == (world * s,)
  (c_j,), (c_t,) = jplan.classes.values(), tplan.classes.values()
  for n in (0, 1, 4, 5, 9, 63, 64, 65, 300, c_t.spill_cap_grps):
    n = min(n, c_t.spill_cap_grps)
    assert tpf._bucket(c_t, n) == jpf._bucket(c_j, n)


def test_spill_past_hard_cap_raises():
  cfg = dict(cache_fraction=0.9, staging_grps=1, spill_factor_max=1)
  jplan, tplan = _plans(4, cfg)
  stores = (jt.HostTierStore(jplan), tt.HostTierStore(tplan))
  pfs = (jt.TieredPrefetcher(jplan, stores[0]),
         tt.TieredPrefetcher(tplan, stores[1], device="cpu"))
  for store in stores:
    for name in store.resident_map:
      for m in store.resident_map[name]:
        m[:] = -1  # nothing resident
  cats = [np.arange(v, dtype=np.int32) for v in C.VOCAB]
  msg = _same_refusal(lambda: pfs[1].stage(pfs[1].classify(cats)),
                      lambda: pfs[0].stage(pfs[0].classify(cats)))
  assert "cannot serve" in msg


@pytest.mark.parametrize("world", [1, 4])
def test_rerank_value_preserving_matches_jax(world):
  cfg = dict(cache_fraction=0.2, staging_grps=8)
  jplan, tplan = _plans(world, cfg)
  jstore, tstore = jt.HostTierStore(jplan), tt.HostTierStore(tplan)
  jstore.init_uniform(3)
  tstore.init_uniform(3)
  (c,) = tplan.classes.values()
  name = c.name
  for store in (jstore, tstore):
    for r in range(world):
      np.testing.assert_array_equal(tstore.images[name][r],
                                    jstore.images[name][r])
  jfused = jstore.build_fused()
  tfused = tstore.build_fused(device="cpu")
  np.testing.assert_array_equal(tfused[name].numpy(),
                                np.asarray(jfused[name]))
  before = [tstore.images[name][r].copy() for r in range(world)]
  rng = np.random.default_rng(9)
  for r in range(world):
    counts = rng.integers(0, 50, c.layout_logical.phys_rows)
    counts[-c.spec.cache_grps:] += 1000  # the top of the table moves in
    jstore.counts[name][r][:] = counts
    tstore.counts[name][r][:] = counts
  old = [tstore.resident_grps[name][r].copy() for r in range(world)]
  jfused = jt.TieredPrefetcher(jplan, jstore).rerank(dict(jfused))
  tfused = tt.TieredPrefetcher(tplan, tstore, device="cpu").rerank(tfused)
  assert any(not np.array_equal(old[r], tstore.resident_grps[name][r])
             for r in range(world))
  np.testing.assert_array_equal(tfused[name].numpy(),
                                np.asarray(jfused[name]))
  for r in range(world):
    for part in ("resident_grps", "resident_map", "counts"):
      np.testing.assert_array_equal(getattr(tstore, part)[name][r],
                                    getattr(jstore, part)[name][r])
    rmap = tstore.resident_map[name][r]
    assert np.array_equal(np.where(rmap >= 0)[0],
                          np.sort(tstore.resident_grps[name][r]))
  tstore.flush(tfused)
  for r in range(world):
    np.testing.assert_array_equal(tstore.images[name][r], before[r])


def test_snapshot_view_and_overlay_reader_reconcile():
  """``snapshot_view`` and ``overlay_reader`` give the flushed image
  without touching the live one."""
  tplan, rule, store, trainer = _port_trainer(CONFIGS["fraction_rerank"])
  trainer.run([C.jax_batch(100 + i) for i in range(3)])
  (name,) = tplan.tier_specs
  live = store.images[name][0].copy()
  view = store.snapshot_view(trainer.state["fused"])
  read = store.overlay_reader(name, 0, trainer.state["fused"])
  np.testing.assert_array_equal(store.images[name][0], live)
  trainer.flush()
  np.testing.assert_array_equal(view.images[name][0], store.images[name][0])
  np.testing.assert_array_equal(read(0, live.shape[0]),
                                store.images[name][0])
  np.testing.assert_array_equal(read(3, 40), store.images[name][0][3:40])


def test_init_uniform_draws_the_jax_images():
  jplan, tplan = _plans(4, dict(cache_fraction=0.3, staging_grps=8))
  jstore, tstore = jt.HostTierStore(jplan), tt.HostTierStore(tplan)
  jstore.init_uniform(11)
  tstore.init_uniform(11)
  for name in jstore.images:
    for r in range(4):
      np.testing.assert_array_equal(tstore.images[name][r],
                                    jstore.images[name][r])
  tfused = tstore.build_fused(device="cpu")
  jfused = jstore.build_fused()
  for name in jfused:
    np.testing.assert_array_equal(tfused[name].numpy(),
                                  np.asarray(jfused[name]))
  # the device draw (here: the CPU generator) keeps the distribution:
  # table lanes within each row's scale, aux lanes at their constant
  (c,) = tplan.classes.values()
  lay = c.layout_logical
  img = tpt.init_host_store_device(
      lay, torch.Generator().manual_seed(0),
      torch.full((lay.rows,), 0.5), (0.1,), device="cpu")
  table, (acc,) = lay.unpack(torch.from_numpy(img))
  assert float(table.abs().max()) <= 0.5 and float(table.std()) > 0.2
  assert torch.all(acc == np.float32(0.1))


# ---------------------------------------------------------------------------
# the trainer against the JAX trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["fraction_rerank", "spill", "budget"])
def test_trainer_trajectory_matches_jax(case):
  cfg = _budget_cfg() if case == "budget" else CONFIGS[case]
  batches = [C.jax_batch(100 + i) for i in range(6)]
  want = C.jax_run(1, jt.TieringConfig(**cfg), batches)
  tplan, rule, store, trainer = _port_trainer(cfg)
  losses = trainer.run(batches)
  np.testing.assert_allclose(losses, want["losses"], **TRAJ_TOL)
  trainer.flush()
  got = get_weights(tplan.plan, tt.unpack_tiered_state(
      tplan, store, rule, trainer.state)["embeddings"])
  for t, (a, b) in enumerate(zip(got, want["weights"])):
    np.testing.assert_allclose(np.asarray(a), b, err_msg=f"table {t}",
                               **TABLE_TOL)
  summary = trainer.metrics_summary()
  for key in ("steps", "per_class", "spill_steps", "host_gather_bytes"):
    assert summary[key] == want["summary"][key], key
  for name in want["hits"]:
    np.testing.assert_array_equal(trainer.hits[name], want["hits"][name])
    np.testing.assert_array_equal(store.resident_grps[name][0],
                                  want["resident"][name][0])
    np.testing.assert_array_equal(store.counts[name][0],
                                  want["counts"][name][0])
  if case == "spill":
    assert summary["spill_steps"] >= summary["steps"] - 1 > 0
  if case == "budget":
    assert trainer.hit_rate() > 0.8
  # the persistent compact buffers kept their shapes through spills
  for name, spec in tplan.tier_specs.items():
    assert tuple(trainer.state["fused"][name].shape)[0] == \
        spec.cache_grps + spec.staging_grps


def test_step_and_run_agree():
  """``step`` (classify at the step) and ``run`` (look-ahead classify,
  deferred on re-rank steps) give the same run bit for bit."""
  cfg = CONFIGS["fraction_rerank"]
  batches = [C.jax_batch(100 + i) for i in range(6)]
  _, _, store_a, a = _port_trainer(cfg)
  _, _, store_b, b = _port_trainer(cfg)
  assert a.run(batches) == [b.step(*bt) for bt in batches]
  a.flush()
  b.flush()
  for name in store_a.images:
    np.testing.assert_array_equal(store_a.images[name][0],
                                  store_b.images[name][0])


def test_guarded_poison_batch_leaves_everything_bit_equal():
  # the spill config (no re-rank moves rows on the poisoned step)
  tplan, rule, store, trainer = _port_trainer(CONFIGS["spill"], guard=True)
  trainer.run([C.jax_batch(100 + i) for i in range(2)])
  trainer.flush()
  fused = {k: v.clone() for k, v in trainer.state["fused"].items()}
  dense = {k: v.detach().clone() for k, v in trainer.state["dense"].items()}
  images = {k: [i.copy() for i in v] for k, v in store.images.items()}
  step = trainer.state["step"]
  numerical, cats, labels = C.jax_batch(300)
  numerical = numerical.copy()
  numerical[3, 2] = np.nan
  loss = trainer.step(numerical, cats, labels)
  assert np.isnan(loss)
  assert trainer.bad_steps == 1 and trainer.state["step"] == step
  for k, v in fused.items():
    # a tiered buffer's staging region is scratch (this step's staged
    # rows); its cache region is state
    keep = (tplan.tier_specs[k].cache_grps if k in tplan.tier_specs
            else v.shape[0])
    np.testing.assert_array_equal(trainer.state["fused"][k][:keep].numpy(),
                                  v[:keep].numpy())
  for k, v in dense.items():
    np.testing.assert_array_equal(
        trainer.state["dense"][k].detach().numpy(), v.numpy())
  trainer.flush()
  for k, v in images.items():
    np.testing.assert_array_equal(store.images[k][0], v[0])
  summary = trainer.metrics_summary()
  assert summary["bad_steps"] == 1
  assert all(m["missed"] == 0 for m in summary["per_class"].values())


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_step_refusals_match_jax():
  from distributed_embeddings_tpu.models import bce_loss as jbce
  from distributed_embeddings_tpu.training import make_tiered_train_step
  cfg = tt.TieringConfig(cache_fraction=0.3, staging_grps=8)
  jcfg = jt.TieringConfig(cache_fraction=0.3, staging_grps=8)
  cases = [
      ({"oov": "error"}, {}, ValueError, "oov='error'"),
      ({}, {"guard": True, "exact": True}, NotImplementedError,
       "guard=True with exact=True"),
      ({"wire_dtype": "bf16"}, {"exact": True}, ValueError,
       "requires wire_dtype='f32'"),
      ({"dedup_exchange": True, "dedup_capacity": 4}, {}, ValueError,
       "dedup_capacity"),
      ({"oov": "allocate"}, {}, NotImplementedError, "allocate"),
  ]
  for plan_kw, step_kw, exc, match in cases:
    jrule, trule = jpt.adagrad_rule(C.LR), tpt.adagrad_rule(C.LR)
    tplan = tt.TieringPlan(C.torch_plan(1, **plan_kw), trule, cfg)
    jplan = jt.TieringPlan(C.jax_plan(1, **plan_kw), jrule, jcfg)
    msg = _same_refusal(
        lambda: ttr.make_tiered_train_step(
            C.torch_model(), tplan, bce_loss, _adam(), trule, **step_kw),
        lambda: make_tiered_train_step(
            C.jax_model(1), jplan, jbce, optax.adam(1e-3), jrule, None,
            {}, None, **step_kw), exc)
    assert match in msg
    if plan_kw.get("oov") == "allocate":
      assert "ROADMAP.md §1 item 12" in msg


def test_unported_options_name_their_item():
  tplan, rule, store, trainer = _port_trainer(CONFIGS["spill"])
  # overlap_host (item 11a) is ported: the flag builds a trainer that
  # runs the pipeline (tests/test_torch_pipeline.py holds it to serial)
  assert tt.TieredTrainer(C.torch_model(), tplan, store, bce_loss, _adam(),
                          rule, None, trainer.state, overlap_host=True,
                          device="cpu").overlap_host
  rg = RaggedIds(torch.tensor([1, 2, 3]), torch.tensor([0, 1, 3]))
  cats = [rg, torch.tensor([0, 1]), torch.tensor([0, 1])]
  with pytest.raises(NotImplementedError, match="ragged_to_padded"):
    trainer.prefetcher.classify(cats)
  # a world-N process's store must own its own rank, and only it
  from distributed_embeddings_torch.parallel.mesh import Mesh
  plan4 = tt.TieringPlan(C.torch_plan(4), rule, tt.TieringConfig(
      **CONFIGS["spill"]))
  mesh = Mesh(rank=1, world=4, device=torch.device("cpu"), backend="gloo")
  with pytest.raises(ValueError, match="owned_ranks"):
    tt.init_tiered_state(plan4, tt.HostTierStore(plan4), rule, {}, _adam(),
                         torch.Generator(), mesh=mesh)
  # an un-owned image refuses access, naming the owner contract
  store1 = tt.HostTierStore(plan4, owned_ranks=(1,))
  (name,) = plan4.tier_specs
  with pytest.raises(ValueError, match="not owned"):
    store1.gather(name, 0, np.array([0]))
  with pytest.raises(IndexError, match="outside this rank's host image"):
    store1.gather(name, 1, np.array([10 ** 6]))


def test_tiered_from_fused_matches_the_all_device_step():
  """One drawn packed state trained all-device (``make_sparse_train_step``
  on the host-tier class's full buffer) and tiered
  (``init_tiered_state_from_fused`` of a copy): the losses and the
  reconciled tables agree, with spilling steps and a re-rank (the
  ``train_tiered_vs_device`` phase of ``chip_smoke.py`` on the CPU)."""
  plan = C.torch_plan(1)
  rule = tpt.sgd_rule(0.1)
  factory = functools.partial(torch.optim.SGD, lr=0.1)
  torch.manual_seed(0)
  model = C.torch_model()
  state = ttr.init_sparse_state_direct(plan, rule, model.state_dict(),
                                       factory, torch.Generator(),
                                       device="cpu")
  twin = {"fused": {k: v.clone() for k, v in state["fused"].items()},
          "emb_dense": {k: v.detach().clone()
                        for k, v in state["emb_dense"].items()},
          "dense": {k: v.detach().clone() for k, v in state["dense"].items()},
          "step": 0}
  tplan = tt.TieringPlan(plan, rule, tt.TieringConfig(
      cache_fraction=0.5, staging_grps=2, rerank_interval=3))
  store = tt.HostTierStore(tplan)
  tiered = tt.init_tiered_state_from_fused(tplan, store, twin)
  (name,) = tplan.tier_specs
  np.testing.assert_array_equal(store.images[name][0],
                                state["fused"][name].numpy())
  trainer = tt.TieredTrainer(model, tplan, store, bce_loss, factory, rule,
                             None, tiered, device="cpu")
  step = ttr.make_sparse_train_step(model, plan, bce_loss, factory, rule)
  batches = [C.jax_batch(400 + i, batch=64) for i in range(4)]
  want = []
  for numerical, cats, labels in batches:
    state, loss = step(state, torch.from_numpy(numerical),
                       [torch.from_numpy(c) for c in cats],
                       torch.from_numpy(labels))
    want.append(float(loss))
  got = trainer.run(batches)
  np.testing.assert_allclose(got, want, **TRAJ_TOL)
  assert trainer.metrics_summary()["spill_steps"] >= 1
  trainer.flush()
  np.testing.assert_allclose(store.images[name][0],
                             state["fused"][name].numpy(), rtol=1e-6,
                             atol=1e-7)
  for k, v in state["fused"].items():
    if k != name:
      np.testing.assert_allclose(trainer.state["fused"][k].numpy(),
                                 v.numpy(), rtol=1e-6, atol=1e-7)


def test_translate_tiered_ids_matches_jax_for_every_routing_form():
  """``translate_tiered_ids`` on one tiered class routed padded (one-hot
  and multi-hot), as a ragged ``(vals, lens)`` stream and as a
  ``DedupRouted`` bundle, against the JAX engine's: the translated ids
  bit-exact (the dedup bundle's unique block only, its inverse maps and
  local blocks kept), the ragged lengths kept, the per-class counters
  (summed over the buckets) equal."""
  jplan, tplan = _plans(1, dict(cache_fraction=0.3, staging_grps=8))
  (key,) = tplan.plan.host_tier_class_keys()
  (name,) = tplan.tier_specs
  spec = tplan.tier_specs[name]
  lay = tplan.by_name(name).layout_logical
  rng = np.random.default_rng(3)
  resident = np.full((lay.phys_rows,), -1, np.int32)
  resident[:spec.cache_grps] = np.arange(spec.cache_grps, dtype=np.int32)
  staged = np.sort(rng.choice(np.arange(spec.cache_grps, lay.phys_rows),
                              6, replace=False)).astype(np.int32)
  staged = np.concatenate([staged, np.full((2,), jle.TIER_PAD_GRP,
                                           np.int32)])
  sentinel = lay.rows

  def ids(shape):
    x = rng.integers(-2, sentinel + 2, shape).astype(np.int32)
    x.reshape(-1)[:6] = staged[:6] * spec.rpp  # some staged hits
    return x

  padded1, padded3 = ids((2, 16)), ids((1, 16, 3))
  vals, lens = ids((1, 1, 40)), rng.integers(0, 5, (1, 1, 16)).astype(
      np.int32)
  uniq, inv = ids((1, 24)), rng.integers(0, 24, (1, 2, 16)).astype(np.int32)
  w, c, kind, gen = key
  forms = {0: ("padded1", 1), 1: ("padded3", 3), 2: ("ragged", -41),
           3: ("dedup", 2)}
  tk = {i: tle.BucketKey(w, c or "", kind, gen, h, 0, False)
        for i, (_, h) in forms.items()}
  jk = {i: jle.BucketKey(w, c or "", kind, gen, h, 0, False)
        for i, (_, h) in forms.items()}
  t_all = {tk[0]: torch.from_numpy(padded1), tk[1]: torch.from_numpy(padded3),
           tk[2]: (torch.from_numpy(vals), torch.from_numpy(lens)),
           tk[3]: tle.DedupRouted(uniq=torch.from_numpy(uniq),
                                  inv=torch.from_numpy(inv),
                                  uniq_local=torch.from_numpy(uniq))}
  j_all = {jk[0]: jnp.asarray(padded1), jk[1]: jnp.asarray(padded3),
           jk[2]: (jnp.asarray(vals), jnp.asarray(lens)),
           jk[3]: jle.DedupRouted(uniq=jnp.asarray(uniq),
                                  inv=jnp.asarray(inv),
                                  uniq_local=jnp.asarray(uniq))}
  t_out, t_m = tle.DistributedLookup(tplan.plan).translate_tiered_ids(
      t_all, tplan.tier_specs, {name: torch.from_numpy(resident)},
      {name: torch.from_numpy(staged)})
  j_out, j_m = jle.DistributedLookup(jplan.plan).translate_tiered_ids(
      j_all, jplan.tier_specs, {name: jnp.asarray(resident)},
      {name: jnp.asarray(staged)})
  np.testing.assert_array_equal(t_out[tk[0]].numpy(), np.asarray(j_out[jk[0]]))
  np.testing.assert_array_equal(t_out[tk[1]].numpy(), np.asarray(j_out[jk[1]]))
  np.testing.assert_array_equal(t_out[tk[2]][0].numpy(),
                                np.asarray(j_out[jk[2]][0]))
  np.testing.assert_array_equal(t_out[tk[2]][1].numpy(), lens)
  np.testing.assert_array_equal(t_out[tk[3]].uniq.numpy(),
                                np.asarray(j_out[jk[3]].uniq))
  np.testing.assert_array_equal(t_out[tk[3]].inv.numpy(), inv)
  np.testing.assert_array_equal(t_out[tk[3]].uniq_local.numpy(), uniq)
  np.testing.assert_array_equal(t_m[name].numpy(), np.asarray(j_m[name]))
  hot, staged_hits, missed, total = t_m[name].tolist()
  assert hot and staged_hits and missed and total
