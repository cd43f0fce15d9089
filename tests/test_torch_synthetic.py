"""The port's synthetic model zoo against the JAX package's.

- ``expand_tables`` and ``model_size_gib`` of all seven published configs
  give the JAX package's tables, input maps and hotness;
- ``generate_batch`` (uniform ids, ``alpha=0``, and the benchmark's power
  law, ``alpha=1.05``) gives bit-equal arrays from the same seed;
- the ``SyntheticModel`` forward, with the JAX model's flax params carried
  across by ``convert.synthetic_state_dict_from_flax``, agrees with the
  JAX forward in the f32 class (rtol 1e-5, atol 1e-6: the two CPU BLAS
  libraries sum the MLP products in their own orders), at Tiny's widths
  and on a small config with ``interact_stride=7`` (the strided average
  pool with "SAME" padding, padded cells counted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_torch.convert import synthetic_state_dict_from_flax
from distributed_embeddings_torch.models import synthetic as tsyn
from distributed_embeddings_tpu.models import synthetic as jsyn

TOL = dict(rtol=1e-5, atol=1e-6)
NAMES = ["criteo", "tiny", "small", "medium", "large", "jumbo", "colossal"]
# a small config with the pool: 88 activation lanes -> 13 windows of 7
POOLED = [(3, (1,), 100, 8, False), (2, (1, 3), 50, 16, True)], [32, 16], 5, 7


def test_all_seven_configs_are_the_published_ones():
  assert sorted(tsyn.SYNTHETIC_MODELS) == sorted(jsyn.SYNTHETIC_MODELS)
  assert sorted(NAMES) == sorted(tsyn.SYNTHETIC_MODELS)


@pytest.mark.parametrize("name", NAMES)
def test_expand_tables_matches_jax(name):
  tcfg, jcfg = tsyn.SYNTHETIC_MODELS[name], jsyn.SYNTHETIC_MODELS[name]
  assert tcfg.mlp_sizes == jcfg.mlp_sizes
  assert tcfg.num_numerical_features == jcfg.num_numerical_features
  assert tcfg.interact_stride == jcfg.interact_stride
  tt, tmap, thot = tsyn.expand_tables(tcfg)
  jt, jmap, jhot = jsyn.expand_tables(jcfg)
  assert (tmap, thot) == (jmap, jhot)
  assert [(t.input_dim, t.output_dim, t.combiner) for t in tt] == \
      [(t.input_dim, t.output_dim, t.combiner) for t in jt]
  assert tsyn.model_size_gib(tcfg) == jsyn.model_size_gib(jcfg)


@pytest.mark.parametrize("alpha", [0.0, 1.05])
@pytest.mark.parametrize("name", ["tiny", "medium", "colossal"])
def test_generate_batch_is_bit_equal(name, alpha):
  got = tsyn.generate_batch(tsyn.SYNTHETIC_MODELS[name], 16, alpha=alpha,
                            seed=3)
  want = jsyn.generate_batch(jsyn.SYNTHETIC_MODELS[name], 16, alpha=alpha,
                             seed=3)
  for g, w in ((got[0], want[0]), (got[2], want[2])):
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)
  assert len(got[1]) == len(want[1])
  for g, w in zip(got[1], want[1]):
    assert g.dtype == w.dtype == np.int32
    np.testing.assert_array_equal(g, w)


def _configs(name):
  if name == "tiny":
    return tsyn.SYNTHETIC_MODELS["tiny"], jsyn.SYNTHETIC_MODELS["tiny"]
  groups, mlp, num, stride = POOLED
  return (tsyn._cfg("pooled", groups, mlp, num, stride),
          jsyn._cfg("pooled", groups, mlp, num, stride))


@pytest.mark.parametrize("name", ["tiny", "pooled"])
def test_forward_matches_jax(name):
  tcfg, jcfg = _configs(name)
  tables, tmap, _ = tsyn.expand_tables(tcfg)
  rng = np.random.default_rng(7)
  b = 32
  acts = [rng.standard_normal((b, tables[t].output_dim)).astype(np.float32)
          for t in tmap]
  numerical = rng.uniform(0, 100, (b, tcfg.num_numerical_features)) \
      .astype(np.float32)
  jmodel = jsyn.SyntheticModel(config=jcfg, world_size=1)
  params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(numerical[:2]),
                       None, emb_acts=[jnp.asarray(a[:2]) for a in acts])
  want = np.asarray(jmodel.apply(params, jnp.asarray(numerical), None,
                                 emb_acts=[jnp.asarray(a) for a in acts]))
  tmodel = tsyn.SyntheticModel(tcfg, tables=False, device="cpu")
  tmodel.load_state_dict(synthetic_state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, params["params"])))
  got = tmodel(torch.tensor(numerical), None,
               emb_acts=[torch.tensor(a) for a in acts])
  assert got.shape == (b,) and got.dtype == torch.float32
  np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_pool_geometry_is_flax_same_padding():
  # 88 lanes, window 7: 13 outputs, 3 padded cells (1 in front, 2 behind)
  assert tsyn._pool_geometry(88, 7) == (13, 1, 2)
  assert tsyn._pool_geometry(14, 7) == (2, 0, 0)
  x = torch.arange(10, dtype=torch.float32)[None, :]
  # [0 | 0..9 | 0]: windows of 4 over 12 cells, each sum over 4
  got = tsyn.avg_pool_same(x, 4)
  assert torch.equal(got, torch.tensor([[3.0, 18.0, 24.0]]) / 4)


def test_model_defaults_to_cuda():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: the default device is usable")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    tsyn.SyntheticModel(tsyn.SYNTHETIC_MODELS["tiny"])
