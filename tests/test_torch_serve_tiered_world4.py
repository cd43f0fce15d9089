"""Tiered serving and the rank-0 micro-batcher at world 4: four gloo ranks
(one spawn of ``tests/torch_ranks.py: multi_job``), each a process whose
serve store owns its rank's cold image, against the JAX tiered
``ServeEngine`` over a 4-device CPU mesh (a store owning every rank), on
``tests/test_serving.py``'s tiered cell (``tests/torch_serve_tiered_
cases.py``). The ranks run while the JAX side computes.

- **Tiered serving** (``serve_tiered_job``, f32, int8 and fp8): each
  rank's ``freeze(store=, mesh=)`` strips its own rank's image byte-equal
  to the JAX ``freeze``'s and holds every rank's ranking and counts; every
  rank's engine gives the same global predictions, within rtol 1e-5 /
  atol 1e-6 of the JAX engine's, activations bit-equal to the JAX
  engine's (through a spilling staging region too) and the JAX engine's
  summed ``[hot, staged, missed, valid]`` counters on every rank.
- **World-N artifacts**: every rank exports its own cold image, rank 0
  the ranking; a rank loads from a copy holding only its own cold files;
  the JAX ``verify`` and ``load`` accept the port's artifact byte for
  byte, and the port serves the JAX package's, bit-equal.
- **The rank-0 batcher** (``leader_batcher_job``): each request's rows
  from ``world_batcher`` on rank 0 bit-equal to a direct padded world-4
  dispatch, on a fixed ``flush_now`` schedule and on a started batcher
  under concurrent submits; on the fixed schedule within rtol 1e-5 /
  atol 1e-6 of a world-1 batcher over the same tables; a request every
  rank refuses fails on rank 0 while the followers record it and go on;
  ``close()`` stops every follower, which followed each of rank 0's
  dispatches.
"""

import os

import numpy as np

import torch_serve_tiered_cases as S
import torch_tiering_cases as C
from distributed_embeddings_torch import serving as ts
from distributed_embeddings_torch.convert import train_state_from_flax
from distributed_embeddings_tpu import checkpoint as jckpt
from distributed_embeddings_tpu import serving as js
from distributed_embeddings_tpu.serving.export import freeze as jfreeze
from torch_ranks import spawn_start, spawn_wait

WORLD = 4
MAX_BATCH = 16
SCHEDULE = ([0, 1, 2], [3], [4, 5, 6, 7], [8, 9, 10, 11])
# f32: the world-4 plan column-slices the tables (three tables, four
# ranks), and an int8 or fp8 image scales each slice's row by its own
# amax, so only f32 answers are the same at world 1 and 4
BATCHER_Q = "f32"


def _bits(a):
  return np.asarray(a, np.float32).view(np.int32)


def _small_requests():
  """``test_batcher_end_to_end_with_engine``'s requests: 12 slices of 1-5
  rows of the fixture's request."""
  numerical, cats = S.request(7)
  rng = np.random.default_rng(11)
  out = []
  for _ in range(12):
    n = int(rng.integers(1, 6))
    lo = int(rng.integers(0, numerical.shape[0] - n))
    out.append((numerical[lo:lo + n], [c[lo:lo + n] for c in cats]))
  return out


def _jax_serve(case, jax_dir):
  """Per quantize mode: the JAX frozen tables, its engine's answers with
  counters and activations, the spilling engine's activations and spill
  count; the JAX artifact exported for the ranks to load."""
  out = {}
  for q in S.QUANTIZE:
    frozen = jfreeze(case["plan_t"], case["rule"], case["state_t"],
                     quantize=q, store=case["store"])
    res = {"frozen": frozen}
    for tag, cfg in (("serve", S.SERVE_CFG), ("spill", S.SPILL_CFG)):
      tc = js.ServeTierConfig(**cfg)
      eng = js.ServeEngine(case["model"], case["plan_t"], frozen,
                           mesh=case["mesh"], tier_config=tc,
                           with_metrics=True)
      acts = js.ServeEngine(S.JaxActs(), case["plan_t"], frozen,
                            mesh=case["mesh"], tier_config=tc)
      answers = []
      for seed in S.REQUESTS:
        preds, m = eng.predict(*S.request(seed))
        answers.append((preds, {k: np.asarray(v)
                                for k, v in m["tier"].items()},
                        np.asarray(acts.predict(*S.request(seed)))))
      res[tag] = (answers, eng.prefetcher.spill_steps)
    js.export(os.path.join(jax_dir, q), case["plan_t"], case["rule"],
              case["state_t"], quantize=q, store=case["store"])
    out[q] = res
  return out


def _world1_schedule(reqs):
  """The world-1 port batcher on the same logical tables and schedule."""
  case = S.jax_case(1, source_world=WORLD)
  _, plan = S.torch_plans(1)
  rule, tplan = S.torch_tplan(plan)
  store = S.port_store(tplan, S.store_arrays(case["store"]))
  state = train_state_from_flax(S.numpy_state(case["state_t"]), "cpu")
  eng = ts.ServeEngine(C.torch_model(), plan,
                       ts.freeze(plan, rule, state, quantize=BATCHER_Q,
                                 store=store),
                       device="cpu", tier_config=ts.ServeTierConfig(
                           **S.SERVE_CFG))
  mb = ts.world_batcher(eng, MAX_BATCH, start=False)
  out = []
  for group in SCHEDULE:
    futs = [mb.submit(*reqs[i]) for i in group]
    mb.flush_now()
    out.append([f.result(timeout=60) for f in futs])
  mb.close()
  return out


def test_world4_tiered_serving_and_leader_batcher(tmp_path):
  case = S.jax_case(WORLD)
  jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
  os.makedirs(port_dir)
  want = _jax_serve(case, jax_dir)
  arrays = S.store_arrays(case["store"])
  state = S.numpy_state(case["state_t"])
  reqs = _small_requests()
  started = spawn_start(tmp_path, WORLD, "multi_job", {"jobs": {
      "serve": ("serve_tiered_job", {
          "state": state, "store": arrays, "quantize": S.QUANTIZE,
          "requests": [S.request(s) for s in S.REQUESTS],
          "port": port_dir, "jax": jax_dir}),
      "batcher": ("leader_batcher_job", {
          "state": state, "store": arrays, "quantize": BATCHER_Q,
          "max_batch": MAX_BATCH, "direct": reqs, "schedule": SCHEDULE}),
  }})
  world1 = _world1_schedule(reqs)
  got = spawn_wait(started)

  for q in S.QUANTIZE:
    w = want[q]
    frozen = w["frozen"]
    names = sorted(frozen.host_images)
    assert names
    (w_answers, _), (w_spill, w_spill_steps) = w["serve"], w["spill"]
    for rank in range(WORLD):
      g = got[rank]["serve"][q]
      for part in ("frozen", "loaded"):
        assert sorted(g[part]) == names
        for name in names:
          imgs = g[part][name]["images"]
          # this rank's image only
          assert [i is None for i in imgs] == [r != rank
                                               for r in range(WORLD)]
          np.testing.assert_array_equal(
              S.bytes_of(imgs[rank]),
              S.bytes_of(frozen.host_images[name][rank]))
          for r in range(WORLD):
            np.testing.assert_array_equal(g[part][name]["ranking"][r],
                                          frozen.ranking[name][r])
            np.testing.assert_array_equal(g[part][name]["counts"][r],
                                          frozen.counts[name][r])
      answers, spill_steps = g["served"]
      assert spill_steps == 0
      for i, ((preds, m), (w_p, w_m, w_a)) in enumerate(zip(answers,
                                                            w_answers)):
        np.testing.assert_allclose(preds, w_p, err_msg=f"{q} {i}",
                                   **S.PRED_TOL)
        np.testing.assert_array_equal(
            _bits(preds), _bits(got[0]["serve"][q]["served"][0][i][0]))
        np.testing.assert_array_equal(_bits(g["acts"][i]), _bits(w_a))
        for name in names:
          np.testing.assert_array_equal(m["tier"][name], w_m[name])
          hot, staged, missed, valid = (int(v) for v in m["tier"][name])
          assert missed == 0 and hot + staged == valid > 0
        for tag in ("artifact", "jax_artifact"):
          np.testing.assert_array_equal(_bits(g[tag][i]), _bits(preds))
      s_answers, s_steps = g["spill"]
      assert s_steps == w_spill_steps >= 1
      for (a, m), (_, w_m, w_a) in zip(s_answers, w_spill):
        np.testing.assert_array_equal(_bits(a), _bits(w_a))
        for name in names:
          np.testing.assert_array_equal(m["tier"][name], w_m[name])
    # the JAX package verifies and loads the port's world-4 artifact
    path = os.path.join(port_dir, q)
    assert jckpt.verify(path) == []
    assert sorted(f for f in os.listdir(path)
                  if f.startswith("serve_cold_")) == sorted(
        f"serve_cold_{n}_r{r}.npy" for n in names for r in range(WORLD))
    art = js.load(path, case["plan_t"], mesh=case["mesh"])
    for name in names:
      for r in range(WORLD):
        np.testing.assert_array_equal(
            S.bytes_of(art.host_images[name][r]),
            S.bytes_of(frozen.host_images[name][r]))
        np.testing.assert_array_equal(art.ranking[name][r],
                                      frozen.ranking[name][r])
        np.testing.assert_array_equal(art.counts[name][r],
                                      frozen.counts[name][r])

  lead = got[0]["batcher"]
  for rank in range(WORLD):
    for a, b in zip(got[rank]["batcher"]["direct"], lead["direct"]):
      np.testing.assert_array_equal(_bits(a), _bits(b))
  for group, rows, rows1 in zip(SCHEDULE, lead["schedule"], world1):
    for i, r, r1 in zip(group, rows, rows1):
      np.testing.assert_array_equal(_bits(r), _bits(lead["direct"][i]))
      np.testing.assert_allclose(r, r1, **S.PRED_TOL)
  for r, d in zip(lead["started"], lead["direct"]):
    np.testing.assert_array_equal(_bits(r), _bits(d))
  # the refused request failed on rank 0 and every follower went on
  assert "shapes cannot be multiplied" in lead["bad_flush"]
  assert lead["bad_result"] == lead["bad_flush"]
  np.testing.assert_array_equal(_bits(lead["after_bad"]),
                                _bits(lead["direct"][0]))
  n_sched = lead["schedule_stats"]["batches"]  # the refused one uncounted
  n_started = lead["started_stats"]["batches"]
  assert lead["schedule_stats"]["completed"] == len(reqs) + 1
  assert lead["started_stats"]["completed"] == len(reqs)
  assert n_sched >= len(SCHEDULE) + 1 and n_started >= 1
  for rank in range(1, WORLD):
    assert got[rank]["batcher"]["followed"] == [n_sched + 1, True, 0]
    assert got[rank]["batcher"]["follow_errors"] == 1
