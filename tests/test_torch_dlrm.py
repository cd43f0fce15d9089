"""The PyTorch port's DLRM forward against the JAX model, same weights.

A small DLRM (6 tables, D=16, narrow MLPs) gets the flax params through
``convert.dlrm_state_dict_from_flax`` and the same embedding activations
(``emb_acts``, the path serving takes). f32 logits agree to the CPU BLAS
summation order. Under ``compute_dtype=bfloat16`` both models round every
layer's output to bf16, and a one-ulp flip (2^-8 relative) in a hidden
unit moves the logit by about that much of its own scale: the measured
worst case over these inputs is below 1e-2, held at rtol=atol=3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_torch.convert import dlrm_state_dict_from_flax
from distributed_embeddings_torch.models import DLRM as TorchDLRM
from distributed_embeddings_tpu.models import DLRM

VOCAB = [50, 7, 300, 12, 90, 4000]
D = 16
BOTTOM = (32, 16)
TOP = (32, 16, 1)
NUM = 4
B = 64
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
# gradients, each scaled by its largest entry (see test_gradients_match_jax)
BF16_GRAD_TOL = dict(rtol=2e-2, atol=2e-2)


def jax_dlrm(compute_dtype):
  return DLRM(vocab_sizes=VOCAB, embedding_dim=D, bottom_mlp=BOTTOM,
              top_mlp=TOP, compute_dtype=compute_dtype)


def flax_params(seed=0):
  """Random flax DLRM dense params (the embedding module is never built:
  ``emb_acts`` short-circuits it)."""
  model = jax_dlrm(jnp.float32)
  acts = [jnp.zeros((2, D), jnp.float32) for _ in VOCAB]
  cats = [jnp.zeros((2,), jnp.int32) for _ in VOCAB]
  params = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, NUM)), cats,
                      emb_acts=acts)["params"]
  return jax.tree_util.tree_map(np.asarray, params)


def torch_dlrm(params, compute_dtype):
  model = TorchDLRM(VOCAB, embedding_dim=D, bottom_mlp=BOTTOM, top_mlp=TOP,
                    num_numerical=NUM, compute_dtype=compute_dtype,
                    device="cpu")
  model.load_state_dict(dlrm_state_dict_from_flax(params))
  return model


def inputs(seed=1):
  rng = np.random.default_rng(seed)
  numerical = rng.standard_normal((B, NUM)).astype(np.float32)
  acts = [(rng.standard_normal((B, D)) * 0.5).astype(np.float32)
          for _ in VOCAB]
  return numerical, acts


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_logits_match_jax(dtype):
  jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
  tdt = torch.float32 if dtype == "f32" else torch.bfloat16
  params = flax_params()
  numerical, acts = inputs()
  cats = [np.zeros((B,), np.int32) for _ in VOCAB]
  want = np.asarray(jax_dlrm(jdt).apply(
      {"params": params}, jnp.asarray(numerical), cats,
      emb_acts=[jnp.asarray(a) for a in acts]))
  with torch.no_grad():
    got = torch_dlrm(params, tdt)(
        torch.tensor(numerical), None,
        emb_acts=[torch.tensor(a) for a in acts]).numpy()
  assert got.shape == want.shape == (B,) and got.dtype == np.float32
  np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "f32"
                                           else BF16_TOL))


def test_state_dict_mapping_is_complete():
  params = flax_params()
  sd = dlrm_state_dict_from_flax(params)
  model = TorchDLRM(VOCAB, embedding_dim=D, bottom_mlp=BOTTOM, top_mlp=TOP,
                    num_numerical=NUM, device="cpu")
  assert set(sd) == set(model.state_dict())
  np.testing.assert_array_equal(
      sd["bottom_mlp.layers.0.weight"].numpy(),
      params["bottom_mlp"]["dense_0"]["kernel"].T)


def test_forward_needs_emb_acts():
  model = TorchDLRM(VOCAB, embedding_dim=D, bottom_mlp=BOTTOM, top_mlp=TOP,
                    num_numerical=NUM, device="cpu")
  with pytest.raises(NotImplementedError, match="emb_acts"):
    model(torch.zeros((2, NUM)), [torch.zeros(2, dtype=torch.long)] * 6)


def _jax_grads(params, numerical, acts, labels, jdt):
  from distributed_embeddings_tpu.models import bce_loss

  def loss(p, a):
    logits = jax_dlrm(jdt).apply({"params": p}, jnp.asarray(numerical),
                                 None, emb_acts=list(a))
    return bce_loss(logits, jnp.asarray(labels))

  value, (dp, da) = jax.value_and_grad(loss, argnums=(0, 1))(
      params, [jnp.asarray(a) for a in acts])
  return float(value), dlrm_state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, dp)), [np.asarray(a) for a in da]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gradients_match_jax(dtype):
  """``loss.backward()`` through the port's DLRM (the interaction's
  autograd Function, the casts, the MLPs) against ``jax.grad`` of the JAX
  DLRM: the loss, every dense-parameter gradient and every embedding
  activation's cotangent. f32: BLAS summation order; bf16 compute: both
  sides round each layer's output and cotangent to bf16, and a one-ulp
  flip of one of them moves a gradient entry by a few bf16 ulps of the
  gradient's own scale (the measured worst case here is 7e-3 of the
  largest entry)."""
  from distributed_embeddings_torch.models import bce_loss as torch_bce
  jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
  tdt = torch.float32 if dtype == "f32" else torch.bfloat16
  params = flax_params()
  numerical, acts = inputs()
  labels = np.random.default_rng(2).integers(0, 2, B).astype(np.float32)
  want_loss, want_dp, want_da = _jax_grads(params, numerical, acts, labels,
                                           jdt)
  model = torch_dlrm(params, tdt)
  acts_t = [torch.tensor(a, requires_grad=True) for a in acts]
  loss = torch_bce(model(torch.tensor(numerical), None, emb_acts=acts_t),
                   torch.tensor(labels))
  loss.backward()
  tol = F32_TOL if dtype == "f32" else BF16_GRAD_TOL
  np.testing.assert_allclose(float(loss), want_loss, **tol)
  for name, p in model.named_parameters():
    scale = np.abs(want_dp[name].numpy()).max()
    np.testing.assert_allclose(p.grad.numpy() / scale,
                               want_dp[name].numpy() / scale,
                               err_msg=name, **tol)
  for a, w in zip(acts_t, want_da):
    scale = np.abs(w).max()
    np.testing.assert_allclose(a.grad.numpy() / scale, w / scale, **tol)
