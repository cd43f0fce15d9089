"""The delta stream at world 4: four gloo ranks, one spawn for the module
(``stream_job`` of ``tests/torch_ranks.py``), against the JAX package's
single controller over a 4-device CPU mesh.

- publish parity: each rank seals its own block's rows into the shared
  ``delta_<seq>.tmp`` and rank 0 the shared files; the directories are
  the JAX publisher's (over the same global states, assembled from the
  ranks' blocks, and the same batches), file for file, at f32, int8 and
  fp8, under the raw and the ``dedup_exchange`` plan;
- the lockstep fold behind the rank-0 batcher: every rank reports the
  same applied seq after each dispatch, the folded blocks equal a full
  re-export's, rank 0's answers equal the re-export engine's, and the
  JAX subscriber folding the port's world-4 chain over its mesh predicts
  the same;
- tiered at world 4, f32 and int8: flush-free extraction, the folded
  cold images and the predictions equal a full re-export's, no misses;
- ``ResilientTrainer(stream=)`` at world 4 re-attaches after a restart.
"""

import os

import numpy as np
import pytest

import torch_stream_cases as SC
from distributed_embeddings_tpu import streaming as js
from distributed_embeddings_tpu.parallel import create_mesh
from test_torch_streaming import ActsModel, jax_plan, jax_rule
from torch_ranks import spawn

WORLD = 4
TIERED = ("f32", "int8")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
  tmp = str(tmp_path_factory.mktemp("stream_world4"))
  rng = np.random.default_rng(5)
  spec = {"dir": tmp, "batches": [SC.mkbatch(rng, 8) for _ in range(6)],
          "requests": [SC.mkbatch(rng, 8)[:2] for _ in range(2)],
          "max_batch": 8, "tiered": TIERED}
  return spawn(tmp, WORLD, "stream_job", spec, timeout_s=240), spec


@pytest.mark.parametrize("quantize", SC.QUANTIZE)
@pytest.mark.parametrize("dedup", [False, True])
def test_world4_publish_parity(ranks, dedup, quantize):
  res, spec = ranks
  tmp = spec["dir"]
  plan = jax_plan(WORLD, dedup)
  jdir = os.path.join(tmp, f"jax_{int(dedup)}_{quantize}")
  pub = js.DeltaPublisher(jdir, plan, jax_rule(),
                          js.RowGenerationTracker(plan), quantize=quantize)
  mine = [r["publish"][dedup] for r in res]
  for k in range(3):
    for bt in spec["batches"][2 * k:2 * k + 2]:
      pub.observe_batch(bt[1])
    state = {"fused": {name: np.concatenate([m["blocks"][k][name]
                                             for m in mine])
                       for name in mine[0]["blocks"][k]},
             "emb_dense": {}, "dense": {}, "step": 2 * (k + 1)}
    if k == 0:
      pub.publish_base(state)
    else:
      assert pub.publish_delta(state) is not None
  assert all(m["seq"] == [2, 2, 2] and m["step"] == 6 for m in mine)
  tdir = os.path.join(tmp, f"port_{int(dedup)}_{quantize}")
  SC.compare_artifacts(os.path.join(tdir, "base"),
                       os.path.join(jdir, "base"))
  for seq in (1, 2):
    names = SC.compare_artifacts(os.path.join(tdir, js.delta_dirname(seq)),
                                 os.path.join(jdir, js.delta_dirname(seq)))
    # every rank sealed its own rows
    assert {n.rsplit("_r", 1)[1] for n in names if n.startswith("rows_")} \
        == {f"{r}.npz" for r in range(WORLD)}


def test_world4_lockstep_fold(ranks):
  res, spec = ranks
  folds = [r["fold"] for r in res]
  n_req = len(spec["requests"])
  # one dispatch per request and delta; every rank at the same seq
  # after each dispatch
  assert folds[0]["seen"] == [1] * n_req + [2] * n_req
  assert all(f["seen"] == folds[0]["seen"] for f in folds)
  assert all(f["applied_seq"] == 2 and f["blocks_equal"]
             and f["refused"] is None for f in folds)
  for got, want in zip(folds[0]["answers"][-1], folds[0]["want"]):
    np.testing.assert_array_equal(got, want)
  # the JAX single controller folds the port's world-4 chain
  sub = js.DeltaSubscriber.from_artifact(
      ActsModel(), jax_plan(WORLD), os.path.join(spec["dir"], "fold"),
      mesh=create_mesh(WORLD), heartbeat=False)
  assert sub.poll_once() == 2 and sub.last_refusal is None
  for req, want in zip(spec["requests"], folds[0]["want"]):
    np.testing.assert_array_equal(sub.predict(*req), want)


@pytest.mark.parametrize("quantize", TIERED)
def test_world4_tiered(ranks, quantize):
  res, _ = ranks
  for r in res:
    t = r["tiered"][quantize]
    assert t["flush_free"] and t["images_equal"]
    assert t["missed"] == 0 and t["applied_seq"] == 1
    np.testing.assert_array_equal(t["preds"], t["want"])
  np.testing.assert_array_equal(res[0]["tiered"][quantize]["preds"],
                                res[3]["tiered"][quantize]["preds"])


def test_world4_resilient_trainer_reattach(ranks):
  res, _ = ranks
  for r in res:
    t = r["trainer"]
    assert t["resumed"] and t["attached"] and t["base"]
    assert t["seq"] == (2, 2)
    assert t["blocks_equal"] and t["applied_seq"] == 3
