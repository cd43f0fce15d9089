"""Tiered checkpoints and the resilient tiered trainer in the port
(``checkpoint.save/restore(store=)``, ``ResilientTrainer(tiered=)``)
against the JAX package's, world 1, on ``tests/torch_tiering_cases.py``'s
cell (dense side Adagrad on both: the port carries optax's Adagrad state,
not its Adam state).

- **Port against port.** Three steps, save, restore into a fresh store and
  state, three more: losses bit-equal to six steps straight, the restored
  images, resident sets and counts bit-equal to the saved ones.
- **Both ways.** The JAX ``TieredTrainer`` saves, the port restores (the
  cold images, resident sets, counts, dense parameters and optimizer
  states bit-equal to what the JAX package wrote) and resumes in the f32
  class of the JAX run's own resume; the port saves, the JAX package
  restores the same arrays and resumes in the f32 class of the port's.
- **Refusals** with the JAX messages: a geometry mismatch, a tiered
  checkpoint without its store, and a tiered plan saved without its
  store; a world change is re-sharded as the JAX package re-shards it.
- **ResilientTrainer(tiered=)**: a NaN batch skipped, snapshots every two
  committed steps (sync and async), a fresh trainer resuming the root at
  its consumed position continues bit-equal to the uninterrupted run, and
  the JAX resilient tiered trainer over the same stream agrees (summary
  equal, losses in the f32 class).
"""

import functools
import os

import numpy as np
import optax
import pytest

import torch_tiering_cases as C
from distributed_embeddings_torch import checkpoint as tck
from distributed_embeddings_torch import tiering as tt
from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import dlrm_state_dict_from_flax
from distributed_embeddings_torch.models import bce_loss
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_torch.resilience import durable
from distributed_embeddings_torch.resilience.trainer import ResilientTrainer
from distributed_embeddings_torch.telemetry import MetricsRegistry
from distributed_embeddings_tpu import checkpoint as jck
from distributed_embeddings_tpu import tiering as jt
from distributed_embeddings_tpu.models import bce_loss as jbce
from distributed_embeddings_tpu.ops import packed_table as jpt

TOL = dict(rtol=1e-5, atol=1e-6)
CFG = dict(cache_fraction=0.3, staging_grps=16, rerank_interval=2)


def _factory():
  return functools.partial(ttr.Adagrad, lr=C.LR)


def _port(cfg=CFG, guard=False, seed_tables=True):
  plan = C.torch_plan(1)
  rule = tpt.adagrad_rule(C.LR)
  tplan = tt.TieringPlan(plan, rule, tt.TieringConfig(**cfg))
  store = tt.HostTierStore(tplan)
  dense_p, tables = C.jax_params(1)
  params = dict(dlrm_state_dict_from_flax(dense_p))
  params["embeddings"] = (tables if seed_tables else
                          {k: np.zeros_like(v) for k, v in tables.items()})
  state = tt.init_tiered_state_from_params(tplan, store, rule, params,
                                           _factory(), device="cpu")
  trainer = tt.TieredTrainer(C.torch_model(), tplan, store, bce_loss,
                             _factory(), rule, None, state, guard=guard,
                             device="cpu")
  return tplan, rule, store, trainer


def _jax(cfg=CFG, guard=False):
  import jax.numpy as jnp
  plan = C.jax_plan(1)
  rule = jpt.adagrad_rule(C.LR)
  opt = optax.adagrad(C.LR)
  tplan = jt.TieringPlan(plan, rule, jt.TieringConfig(**cfg))
  store = jt.HostTierStore(tplan)
  dense_p, tables = C.jax_params(1)
  params = dict(dense_p)
  params["embeddings"] = {k: jnp.asarray(v) for k, v in tables.items()}
  state = jt.init_tiered_state_from_params(tplan, store, rule, params, opt)
  trainer = jt.TieredTrainer(C.jax_model(1), tplan, store, jbce, opt, rule,
                             None, state, C.jax_batch(100), donate=False,
                             guard=guard)
  return tplan, rule, store, trainer, opt


def _batches(n, first=100):
  return [C.jax_batch(first + i) for i in range(n)]


def _tier_arrays(store):
  return {f"{part}/{name}/{r}": np.asarray(v).copy()
          for part in ("images", "resident_grps", "counts")
          for name, per in getattr(store, part).items()
          for r, v in enumerate(per) if v is not None}


def _assert_equal(got, want):
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_resume_is_bit_exact(tmp_path):
  batches = _batches(6)
  _, _, _, straight = _port()
  want = straight.run(batches)

  tplan, rule, store, a = _port()
  head = a.run(batches[:3])
  path = str(tmp_path / "ckpt")
  tck.save(path, tplan.plan, rule, a.state, store=store)
  files = set(os.listdir(path))
  assert "tiering.npz" in files and any(f.startswith("cold_") for f in files)
  assert not any(f.startswith(f"fused_{n}") for n in tplan.tier_specs
                 for f in files)
  assert tck.verify(path) == []
  saved = _tier_arrays(store)  # the save flushed the resident rows

  tplan_c, _, store_c, fresh = _port(seed_tables=False)
  state = tck.restore(path, tplan_c.plan, rule, fresh.state, store=store_c,
                      device="cpu")
  _assert_equal(_tier_arrays(store_c), saved)
  fresh.state = state
  fresh.prefetcher.refresh_resident()
  assert head + fresh.run(batches[3:]) == want


def test_checkpoints_cross_both_ways(tmp_path):
  batches = _batches(6)
  # JAX saves, the port restores and resumes
  jplan, jrule, jstore, jtr, opt = _jax()
  jtr.run(batches[:3])
  jpath = str(tmp_path / "jax")
  jck.save(jpath, jplan.plan, jrule, jtr.state, store=jstore)
  jsaved = _tier_arrays(jstore)
  jtail = jtr.run(batches[3:])

  tplan, trule, tstore, ttrainer = _port(seed_tables=False)
  state = tck.restore(jpath, tplan.plan, trule, ttrainer.state,
                      store=tstore, device="cpu")
  _assert_equal(_tier_arrays(tstore), jsaved)
  assert state["step"] == 3
  ttrainer.state = state
  ttrainer.prefetcher.refresh_resident()
  np.testing.assert_allclose(ttrainer.run(batches[3:]), jtail, **TOL)

  # the port saves, the JAX package restores and resumes
  tplan, trule, tstore, ttrainer = _port()
  ttrainer.run(batches[:3])
  tpath = str(tmp_path / "port")
  tck.save(tpath, tplan.plan, trule, ttrainer.state, store=tstore)
  tsaved = _tier_arrays(tstore)
  ttail = ttrainer.run(batches[3:])
  jplan, jrule, jstore, jtr, opt = _jax()
  jtr.state = jck.restore(tpath, jplan.plan, jrule, jtr.state, store=jstore)
  jtr.prefetcher.refresh_resident()
  _assert_equal(_tier_arrays(jstore), tsaved)
  np.testing.assert_allclose(jtr.run(batches[3:]), ttail, **TOL)


def test_tiered_checkpoint_refusals_match_jax(tmp_path):
  tplan, trule, tstore, tr = _port()
  tr.run(_batches(2))
  path = str(tmp_path / "ck")
  tck.save(path, tplan.plan, trule, tr.state, store=tstore)
  jplan, jrule, jstore, jtr, _ = _jax()

  def same(fn_t, fn_j, exc=ValueError):
    with pytest.raises(exc) as got:
      fn_t()
    with pytest.raises(exc) as want:
      fn_j()
    assert str(got.value) == str(want.value)
    return str(got.value)

  bad = dict(CFG, cache_fraction=0.2)
  tbad = tt.HostTierStore(tt.TieringPlan(tplan.plan, trule,
                                         tt.TieringConfig(**bad)))
  jbad = jt.HostTierStore(jt.TieringPlan(jplan.plan, jrule,
                                         jt.TieringConfig(**bad)))
  assert "tier geometry" in same(
      lambda: tck.restore(path, tplan.plan, trule, tr.state, store=tbad,
                          device="cpu"),
      lambda: jck.restore(path, jplan.plan, jrule, jtr.state, store=jbad))
  assert "tiering mismatch" in same(
      lambda: tck.restore(path, tplan.plan, trule, tr.state, device="cpu"),
      lambda: jck.restore(path, jplan.plan, jrule, jtr.state))
  assert "HostTierStore" in same(
      lambda: tck.save(str(tmp_path / "x"), tplan.plan, trule, tr.state),
      lambda: jck.save(str(tmp_path / "y"), jplan.plan, jrule, jtr.state))
  # the same tables on two ranks: a placement-only change, re-sharded
  # elastically by both packages (cold images, counts and resident sets
  # bit-equal)
  rule = tpt.adagrad_rule(C.LR)
  tplan2 = tt.TieringPlan(C.torch_plan(2), rule, tt.TieringConfig(**CFG))
  jplan2 = jt.TieringPlan(C.jax_plan(2), jrule, jt.TieringConfig(**CFG))
  tstore2, jstore2 = tt.HostTierStore(tplan2), jt.HostTierStore(jplan2)
  got = tck.restore(path, tplan2.plan, rule, tr.state, store=tstore2,
                    device="cpu")
  want = jck.restore(path, jplan2.plan, jrule, jtr.state, store=jstore2)
  _assert_equal(_tier_arrays(tstore2), _tier_arrays(jstore2))
  for name, buf in want["fused"].items():
    np.testing.assert_array_equal(got["fused"][name].numpy(),
                                  np.asarray(buf), err_msg=name)


def _poisoned(batches, at):
  numerical, cats, labels = batches[at]
  numerical = numerical.copy()
  numerical[0, 0] = np.nan
  out = list(batches)
  out[at] = (numerical, cats, labels)
  return out


@pytest.mark.parametrize("async_", [False, True])
def test_resilient_tiered_trainer_resumes_and_matches_jax(tmp_path, async_):
  from distributed_embeddings_tpu.resilience.trainer import \
      ResilientTrainer as JResilient
  from distributed_embeddings_tpu.telemetry import MetricsRegistry as JReg
  batches = _poisoned(_batches(7), 2)
  root = str(tmp_path / "root")
  _, _, _, straight_t = _port(guard=True)
  straight = ResilientTrainer(None, None, straight_t.tplan.plan,
                              tpt.adagrad_rule(C.LR), str(tmp_path / "s"),
                              tiered=straight_t, resume=False,
                              telemetry=MetricsRegistry())
  want = straight.run(batches)

  tplan, rule, store, tr = _port(guard=True)
  a = ResilientTrainer(None, None, tplan.plan, rule, root, tiered=tr,
                       snapshot_every=2, async_snapshots=async_,
                       telemetry=MetricsRegistry())
  head = a.run(batches[:5])
  assert a.metrics_summary()["skipped"] == 1 and a.step_count == 4
  assert [s for s, _ in durable.list_checkpoints(root)] == [2, 4]

  # a fresh process: other tables, the root's newest checkpoint
  tplan_b, _, store_b, tr_b = _port(guard=True, seed_tables=False)
  b = ResilientTrainer(None, None, tplan_b.plan, rule, root, tiered=tr_b,
                       telemetry=MetricsRegistry())
  assert b.consumed == 5 and b.step_count == 4
  tail = b.run(batches[b.consumed:])
  np.testing.assert_array_equal(head + tail, want)
  # the reconciled images agree (the re-rank phase restarts at a resume,
  # as in the JAX trainer, so the resident sets may differ)
  straight_t.flush()
  tr_b.flush()
  for name, imgs in straight_t.store.images.items():
    np.testing.assert_array_equal(store_b.images[name][0], imgs[0])

  jplan, jrule, jstore, jtr, _ = _jax(guard=True)
  j = JResilient(None, None, jplan.plan, jrule, str(tmp_path / "j"),
                 tiered=jtr, snapshot_every=2, telemetry=JReg())
  jlosses = j.run(batches)
  np.testing.assert_allclose(want, jlosses, **TOL)
  got, jsum = straight.metrics_summary(), j.metrics_summary()
  for key in ("steps", "consumed", "skipped", "oov"):
    assert got[key] == jsum[key], key
  np.testing.assert_array_equal(
      sum(straight_t.hits.values()), sum(jtr.hits.values()))
