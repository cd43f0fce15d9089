"""DLRM serving end to end: the port's ``ServeEngine.predict`` against the
JAX package's ``make_serve_step`` on one frozen train state.

The small DLRM of ``test_torch_dlrm.py`` at world 1, three of its tables
served as dense classes. One JAX sparse train state (SGD rule) is frozen
by both packages, f32 and int8; the predictions must agree within the
DLRM tolerances of ``test_torch_dlrm.py`` (f32: BLAS summation order;
bf16 compute: one-ulp flips of bf16 roundings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_torch.convert import (
    serve_state_from_frozen,
    train_state_from_flax,
)
from distributed_embeddings_torch.models import dlrm_embedding_plan as \
    torch_dlrm_embedding_plan
from distributed_embeddings_torch.ops.packed_table import sgd_rule as \
    torch_sgd_rule
from distributed_embeddings_torch.serving import ServeEngine
from distributed_embeddings_torch.serving import freeze as torch_freeze
from distributed_embeddings_tpu.models.dlrm import dlrm_embedding_plan
from distributed_embeddings_tpu.ops.packed_table import sgd_rule
from distributed_embeddings_tpu.serving import make_serve_step
from distributed_embeddings_tpu.serving.export import (
    freeze,
    frozen_device_state,
)
from distributed_embeddings_tpu.training import init_sparse_state_direct
from test_torch_dlrm import (
    BF16_TOL,
    D,
    F32_TOL,
    NUM,
    VOCAB,
    flax_params,
    jax_dlrm,
    torch_dlrm,
)

DENSE_THR = 64
B = 32


@pytest.fixture(scope="module")
def train_state():
  plan = dlrm_embedding_plan(VOCAB, D, dense_row_threshold=DENSE_THR)
  state = init_sparse_state_direct(plan, sgd_rule(0.1), flax_params(),
                                   optax.sgd(0.1), jax.random.PRNGKey(3))
  rng = np.random.default_rng(4)
  numerical = rng.standard_normal((B, NUM)).astype(np.float32)
  cats = [rng.integers(0, v, (B,)).astype(np.int32) for v in VOCAB]
  return plan, state, numerical, cats


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("quantize", ["f32", "int8"])
def test_serve_predictions_match_jax(train_state, quantize, dtype):
  plan, state, numerical, cats = train_state
  jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
  tdt = torch.float32 if dtype == "f32" else torch.bfloat16

  frozen = freeze(plan, sgd_rule(0.1), state, quantize=quantize)
  sstate = frozen_device_state(frozen, plan)
  step = make_serve_step(jax_dlrm(jdt), plan, frozen.meta, None, sstate,
                         (numerical, tuple(cats)))
  want = np.asarray(step(sstate, jnp.asarray(numerical),
                         tuple(jnp.asarray(c) for c in cats)))

  tplan = torch_dlrm_embedding_plan(VOCAB, D, dense_row_threshold=DENSE_THR)
  assert {cp.kind for cp in tplan.classes.values()} == {"sparse", "dense"}
  np_state = {k: jax.tree_util.tree_map(np.asarray, state[k])
              for k in ("fused", "emb_dense", "dense", "step")}
  tfrozen = torch_freeze(tplan, torch_sgd_rule(0.1),
                         train_state_from_flax(np_state, device="cpu"),
                         quantize=quantize)
  model = torch_dlrm(flax_params(seed=9), tdt)  # weights come from frozen
  eng = ServeEngine(model, tplan, tfrozen, device="cpu")
  got = eng.predict(numerical, cats)
  assert got.shape == want.shape == (B,) and np.all(np.isfinite(got))
  np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "f32"
                                           else BF16_TOL))

  # the JAX image carried across as it is serves the same predictions
  moved = ServeEngine(torch_dlrm(flax_params(seed=9), tdt), tplan,
                      serve_state_from_frozen(frozen), device="cpu")
  np.testing.assert_array_equal(moved.predict(numerical, cats), got)
