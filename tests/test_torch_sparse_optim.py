"""The table-level sparse optimizers (``ops/sparse_grad.py``) in the port
against the JAX package's.

The same numpy table and gradients go through the JAX
``sparse_optimizer(name, lr)`` (``init`` / jitted ``apply``) and the
port's, two steps over the same rows, with duplicate ids deduplicated by
each package's ``dedup_rows`` and padding ids (negative and past the
table) that neither may touch: the tables and every state leaf in the f32
class (rtol 1e-5, atol 1e-6), the counts equal. The JAX oracle is
``tests/test_sparse_training.py::test_sparse_optimizer_apply_matches_optax``
(dense optax on the deduplicated gradients), which the port is also held
to here. A schedule is read at the count in both, and the factory's error
is the JAX one, word for word.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_narrow_cases import one_torch_thread  # noqa: F401 (autouse)

from distributed_embeddings_torch import ops as tops
from distributed_embeddings_tpu.ops import sparse_grad as jsg

TOL = dict(rtol=1e-5, atol=1e-6)
ROWS, WIDTH = 30, 8
IDS = np.asarray([1, 7, 7, 29, 1, 3, -1, 30], np.int32)  # dups + padding
NAMES = ["sgd", "adagrad", "momentum", "adam"]


def _optax_of(name, lr):
  return {"sgd": lambda: optax.sgd(lr),
          "adagrad": lambda: optax.adagrad(lr),
          "momentum": lambda: optax.sgd(lr, momentum=0.9),
          "adam": lambda: optax.adam(lr)}[name]()


def _leaves(state):
  """A state's leaves by field name, as numpy."""
  return {f: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                        else v) for f, v in state._asdict().items()}


def _run(name, lr, steps=2, seed=4):
  rng = np.random.default_rng(seed)
  table = rng.standard_normal((ROWS, WIDTH)).astype(np.float32)
  grads = [rng.standard_normal((IDS.shape[0], WIDTH)).astype(np.float32)
           for _ in range(steps)]
  jopt, topt = jsg.sparse_optimizer(name, lr), tops.sparse_optimizer(name,
                                                                     lr)
  jt, tt = jnp.asarray(table), torch.tensor(table)
  js, ts = jopt.init(jt), topt.init(tt)
  japply = jax.jit(jopt.apply)
  for rows in grads:
    jt, js = japply(jt, js, jsg.dedup_rows(jnp.asarray(IDS),
                                           jnp.asarray(rows), ROWS))
    tt, ts = topt.apply(tt, ts, tops.dedup_rows(torch.tensor(IDS),
                                                torch.tensor(rows), ROWS))
  return table, grads, (jt, js), (tt, ts)


@pytest.mark.parametrize("name", NAMES)
def test_sparse_optimizer_matches_jax(name):
  table, grads, (jt, js), (tt, ts) = _run(name, 0.2)
  np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
  jl, tl = _leaves(js), _leaves(ts)
  assert sorted(jl) == sorted(tl)
  for field, want in jl.items():
    np.testing.assert_allclose(tl[field], want, err_msg=field, **TOL)
  assert int(ts.count) == int(js.count) == len(grads)
  # rows no live id touches, the padding's included, are unchanged
  live = sorted({int(i) for i in IDS if 0 <= i < ROWS})
  untouched = np.setdiff1d(np.arange(ROWS), live)
  np.testing.assert_array_equal(tt.numpy()[untouched], table[untouched])


@pytest.mark.parametrize("name", NAMES)
def test_sparse_optimizer_matches_dense_optax(name):
  """The JAX oracle's check on the port: dense optax on the deduplicated
  gradients, over two steps touching the same rows."""
  table, grads, _, (tt, _) = _run(name, 0.2)
  opt = _optax_of(name, 0.2)
  want = jnp.asarray(table)
  state = opt.init(want)
  live = (IDS >= 0) & (IDS < ROWS)
  for rows in grads:
    dense = jnp.zeros_like(want).at[IDS[live]].add(rows[live])
    upd, state = opt.update(dense, state, want)
    want = optax.apply_updates(want, upd)
  np.testing.assert_allclose(tt.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_schedule_is_read_at_the_count(name):
  def schedule(count):
    return 0.1 * (1.0 + count)

  _, _, (jt, js), (tt, ts) = _run(name, schedule, steps=3, seed=7)
  np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
  assert int(ts.count) == int(js.count) == 3


def test_dedup_rows_is_sparse_rows():
  got = tops.dedup_rows(torch.tensor(IDS), torch.ones((IDS.shape[0], 2)),
                        ROWS)
  want = jsg.dedup_rows(jnp.asarray(IDS), jnp.ones((IDS.shape[0], 2)), ROWS)
  assert isinstance(got, tops.SparseRows)
  np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
  np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
  ids, rows = got  # unpacks as the engine's (ids, rows)
  assert ids is got.ids and rows is got.rows


def test_factory_error_is_the_jax_message():
  with pytest.raises(ValueError) as want:
    jsg.sparse_optimizer("rmsprop", 0.1)
  with pytest.raises(ValueError) as got:
    tops.sparse_optimizer("rmsprop", 0.1)
  assert str(got.value) == str(want.value)
