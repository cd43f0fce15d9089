"""The port's world-4 sparse train and eval steps under
``dedup_exchange=True`` against the JAX package's dedup steps.

The cell of ``tests/torch_wire_cases.py`` (nine width-16 tables, a dense
class, two row-sliced tables, padded multi-hot ``sum`` and ``mean``
inputs, 32 samples of uniform ids over small vocabularies) runs three
steps from one JAX state: the JAX mesh step over a 4-device CPU mesh, the
port's as four gloo processes (``tests/torch_ranks.py: mb_guard_job``).

- **Eval**: the dedup eval step's predictions on the initial state are
  bit-equal to the port's raw eval step's, and within the f32 class of
  the JAX dedup eval step's (the activations are bit-exact against the
  JAX lookup, ``tests/test_torch_wire_forward.py``; the MLPs sum their
  products in each BLAS's own order).
- **SGD, f32 class** (rtol 1e-5, atol 1e-6): losses, the final tables
  and dense parameters and the eval predictions under the monolithic,
  pipelined (3 chunks) and fused (2 chunks) schedules and with
  ``micro_batches=2`` (SGD: slicing does not change the update), against
  the JAX one-shot dedup step (the JAX mesh micro-batch step does not
  build on this jax); the three schedules bit-exact against each other.
  The unique ids' cotangents are summed before the exchange rather than
  inside the scatter, so the expansion's backward orders the additions
  otherwise than JAX's ``segment_sum`` and the trajectories are held in
  the f32 class, not to the bit.
- **Adagrad, f32 class**: the per-unique-id rule semantics (once per
  unique id and source block) against the JAX dedup step under
  ``overlap='fused'``, the optimizer lanes included.
"""

import numpy as np
import pytest

import torch_wire_cases as C
from torch_ranks import spawn

SCHEDULES = {"none": {"overlap": "none"},
             "pipelined": {"overlap": "pipelined", "chunks": 3},
             "fused": {"overlap": "fused", "chunks": 2}}
DEDUP = {"dedup_exchange": True}


@pytest.fixture(scope="module")
def cell():
  return C.batches(C.STEPS), C.batches(1, seed=99)[0][:2]


@pytest.fixture(scope="module")
def sgd(cell, tmp_path_factory):
  batches, ev = cell
  state = C.initial("sgd")
  runs = [dict(name=name, micro_batches=1, guard=False, plan_kw=DEDUP,
               eval=ev, **kw) for name, kw in SCHEDULES.items()]
  runs += [dict(name="mb2", overlap="fused", micro_batches=2, guard=False,
                plan_kw=DEDUP, eval=ev),
           dict(name="eval_dedup", overlap="fused", micro_batches=1,
                guard=False, plan_kw=DEDUP, eval=ev, batches=[]),
           dict(name="eval_raw", overlap="fused", micro_batches=1,
                guard=False, eval=ev, batches=[])]
  got = spawn(tmp_path_factory.mktemp("wiresgd"), C.WORLD, "mb_guard_job",
              C.spec(state, "sgd", runs, batches))
  want = C.jax_run(state, "sgd", batches, eval_batch=ev, **DEDUP)
  want_eval = C.jax_run(state, "sgd", [], eval_batch=ev, overlap="fused",
                        **DEDUP)
  return got, want, want_eval


def assert_final(res, final, tol=C.TOL):
  from distributed_embeddings_torch.convert import dlrm_state_dict_from_flax
  params, aux = final
  got_params, got_aux = res["unpacked"]
  assert set(got_params) == set(params["embeddings"])
  for name, t in params["embeddings"].items():
    np.testing.assert_allclose(got_params[name], t, err_msg=name, **tol)
  for name, lanes in aux.items():
    for j, a in enumerate(lanes):
      np.testing.assert_allclose(got_aux[name][j], a, err_msg=name, **tol)
  want = dlrm_state_dict_from_flax(
      {k: v for k, v in params.items() if k != "embeddings"})
  for name, p in want.items():
    np.testing.assert_allclose(res["dense"][name], p.numpy(), err_msg=name,
                               **tol)


def test_dedup_eval_is_bit_exact(sgd):
  got, _, want_eval = sgd
  for rank_out in got:
    np.testing.assert_array_equal(rank_out["eval_dedup"]["eval"]["preds"],
                                  rank_out["eval_raw"]["eval"]["preds"])
    np.testing.assert_allclose(rank_out["eval_dedup"]["eval"]["preds"],
                               want_eval["eval"]["preds"], **C.TOL)
    assert rank_out["eval_dedup"]["eval"]["oov"] == want_eval["eval"]["oov"]


@pytest.mark.parametrize("name", list(SCHEDULES) + ["mb2"])
def test_sgd_dedup_matches_the_jax_dedup_step(sgd, name):
  got, want, _ = sgd
  for rank_out in got:
    res = rank_out[name]
    np.testing.assert_allclose(res["losses"], want["losses"], **C.TOL)
    assert res["step"] == C.STEPS
    np.testing.assert_allclose(res["eval"]["preds"], want["eval"]["preds"],
                               **C.TOL)
  assert_final(got[0][name], want["final"])
  # the first loss is a pure forward: bit-exact
  assert got[0][name]["losses"][0] == want["losses"][0]


@pytest.mark.parametrize("name", ["pipelined", "fused"])
def test_dedup_schedules_are_bit_exact_against_none(sgd, name):
  got, _, _ = sgd
  base, res = got[0]["none"], got[0][name]
  assert res["losses"] == base["losses"]
  for part in (0, 1):
    for k, arr in base["unpacked"][part].items():
      np.testing.assert_array_equal(res["unpacked"][part][k], arr,
                                    err_msg=k)
  np.testing.assert_array_equal(res["eval"]["preds"], base["eval"]["preds"])


@pytest.fixture(scope="module")
def adagrad(cell, tmp_path_factory):
  batches, ev = cell
  state = C.initial("adagrad")
  runs = [dict(name="fused", overlap="fused", micro_batches=1, guard=False,
               plan_kw=DEDUP, eval=ev, rule="adagrad")]
  got = spawn(tmp_path_factory.mktemp("wireada"), C.WORLD, "mb_guard_job",
              C.spec(state, "adagrad", runs, batches))
  want = C.jax_run(state, "adagrad", batches, eval_batch=ev,
                   overlap="fused", **DEDUP)
  return got, want


def test_adagrad_dedup_matches_the_jax_dedup_step(adagrad):
  got, want = adagrad
  for rank_out in got:
    res = rank_out["fused"]
    np.testing.assert_allclose(res["losses"], want["losses"], **C.TOL)
    np.testing.assert_allclose(res["eval"]["preds"], want["eval"]["preds"],
                               **C.TOL)
  assert_final(got[0]["fused"], want["final"])
  assert got[0]["fused"]["unpacked"][1], "Adagrad's lanes were compared"
