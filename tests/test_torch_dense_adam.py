"""The port's dense Adam (``training.Adam``) against ``optax.adam``.

- ``training.Adam`` against ``optax.adam`` over three steps with one
  parameter whose gradient is missing (optax steps it on a zero gradient:
  its moments decay and it moves), a constant and a scheduled learning
  rate: the f32 class (rtol 1e-5, atol 1e-6); bf16 parameters with bf16
  gradients bit-equal (optax's weakly typed bf16 arithmetic);
- the sparse step with ``optax.adam`` / ``training.Adam`` on the dense
  side and the Adam rule on the sparse classes, world 1, against the JAX
  step (``tests/test_sparse_training.py::test_sparse_step_matches_dense_step_single_device``'s
  ``("adam", 32)`` cell), and the dense-autodiff step with Adam against
  the JAX ``make_train_step``: the f32 class;
- Adam's optax state (``0/count``, ``0/mu/<path>``, ``0/nu/<path>``, a
  schedule's ``1/count``) through ``convert`` and the checkpoint both
  ways: the port restores the JAX save and the JAX restore reads the
  port's, f32 moments; bf16 moments (optax's init on bf16 dense-class
  tables) byte-equal to the JAX save, which the port restores.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from torch_narrow_cases import one_torch_thread  # noqa: F401 (autouse)

from distributed_embeddings_torch import checkpoint as tck
from distributed_embeddings_torch import train_golden as port_golden
from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import (
    dlrm_state_dict_from_flax,
    dlrm_state_dict_to_flax,
    flatten_paths,
    install_optax_state,
    optax_state_of,
    train_state_from_flax,
)
from distributed_embeddings_torch.models import DLRM as TDLRM
from distributed_embeddings_torch.models import bce_loss as torch_bce
from distributed_embeddings_torch.models import \
    dlrm_embedding_plan as torch_plan
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_tpu import checkpoint as jck
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.models.dlrm import dlrm_embedding_plan
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.training import (
    init_sparse_state,
    init_sparse_state_direct,
    make_sparse_train_step,
    make_train_step,
)

BF16 = ml_dtypes.bfloat16
TOL = dict(rtol=1e-5, atol=1e-6)
LR = 0.1
STEPS = 3


def _schedule(count):
  return 0.05 * (1.0 + count)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scheduled", [False, True])
def test_adam_matches_optax(dtype, scheduled):
  rng = np.random.default_rng(3)
  jdt = np.float32 if dtype == "f32" else BF16
  params = {"a": rng.standard_normal((40, 8)).astype(jdt),
            "b": rng.standard_normal((7,)).astype(jdt)}
  grads = [{k: (rng.standard_normal(v.shape) * 0.1).astype(jdt)
            for k, v in params.items()} for _ in range(STEPS)]
  lr = _schedule if scheduled else LR
  opt = optax.adam(lr)
  jp = jax.tree_util.tree_map(jnp.asarray, params)
  js = opt.init(jp)

  @jax.jit
  def update(p, s, g):
    u, s = opt.update(g, s, p)
    return optax.apply_updates(p, u), s

  def tensor(x):
    if dtype == "f32":
      return torch.tensor(x)
    return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)

  tp = {k: torch.nn.Parameter(tensor(v)) for k, v in params.items()}
  topt = ttr.Adam(list(tp.values()), lr)
  for i, g in enumerate(grads):
    if i == 1:
      g = dict(g, b=np.zeros_like(g["b"]))  # optax sees a zero gradient
    jp, js = update(jp, js, jax.tree_util.tree_map(jnp.asarray, g))
    for k, p in tp.items():
      # the port's parameter has no gradient at all that step
      p.grad = None if (i == 1 and k == "b") else tensor(g[k])
    topt.step()
  assert topt.count == int(js[0].count) == STEPS
  for k in params:
    got = tp[k].detach().float().numpy()
    want = np.asarray(jp[k]).astype(np.float32)
    for slot in ("mu", "nu"):
      gs = topt.state[tp[k]][slot]
      ws = getattr(js[0], slot)[k]
      assert gs.dtype == tp[k].dtype and ws.dtype == jdt
      if dtype == "f32":
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
      else:
        np.testing.assert_array_equal(gs.float().numpy(),
                                      np.asarray(ws).astype(np.float32))
    if dtype == "f32":
      np.testing.assert_allclose(got, want, err_msg=k, **TOL)
    else:
      np.testing.assert_array_equal(got, want, err_msg=k)
  # the zero-gradient step moved the parameter
  assert not np.array_equal(tp["b"].detach().float().numpy(),
                            params["b"].astype(np.float32))


VOCAB = [64, 32, 16, 8]
D = 16
THRESHOLD = 32  # tables 1-3 are dense classes, table 0 sparse


def _model():
  return DLRM(vocab_sizes=VOCAB, embedding_dim=D, bottom_mlp=(32, D),
              top_mlp=(32, 1), dense_row_threshold=THRESHOLD)


def _batches(seed=1, b=32):
  rng = np.random.default_rng(seed)
  return [(rng.standard_normal((b, 13)).astype(np.float32),
           [rng.integers(0, v, b).astype(np.int32) for v in VOCAB],
           rng.integers(0, 2, b).astype(np.float32))
          for _ in range(STEPS)]


def _jax_params(batch):
  return _model().init(jax.random.PRNGKey(0), jnp.asarray(batch[0]),
                       [jnp.asarray(c) for c in batch[1]])["params"]


def _jb(batch):
  return (jnp.asarray(batch[0]), [jnp.asarray(c) for c in batch[1]],
          jnp.asarray(batch[2]))


def _tb(batch):
  return (torch.tensor(batch[0]), [torch.tensor(c) for c in batch[1]],
          torch.tensor(batch[2]))


def _numpy_state(state):
  return {k: jax.tree_util.tree_map(np.asarray, state[k])
          for k in ("fused", "emb_dense", "dense", "step", "dense_opt",
                    "emb_dense_opt")}


def _torch_model(tables=False):
  return TDLRM(VOCAB, D, bottom_mlp=(32, D), top_mlp=(32, 1),
               num_numerical=13, tables=tables,
               dense_row_threshold=THRESHOLD, device="cpu")


@pytest.fixture(scope="module")
def sparse_runs():
  """Three sparse steps of both packages (Adam rule, dense Adam) from one
  JAX state, the JAX states kept per step."""
  batches = _batches()
  params = _jax_params(batches[0])
  jplan = dlrm_embedding_plan(VOCAB, D, 1, dense_row_threshold=THRESHOLD)
  tplan = torch_plan(VOCAB, D, 1, dense_row_threshold=THRESHOLD)
  jrule, trule = jpt.adam_rule(LR), tpt.adam_rule(LR)
  opt = optax.adam(LR)
  state = init_sparse_state(jplan, params, jrule, opt)
  tstate = train_state_from_flax(_numpy_state(state), device="cpu")
  jstep = make_sparse_train_step(_model(), jplan, bce_loss, opt, jrule, None,
                                 state, _jb(batches[0]), exact=True,
                                 donate=False)
  tstep = ttr.make_sparse_train_step(
      _torch_model(), tplan, torch_bce, functools.partial(ttr.Adam, lr=LR),
      trule, exact=True)
  jstates, losses = [state], []
  for batch in batches:
    state, jl = jstep(state, *_jb(batch))
    tstate, tl = tstep(tstate, *_tb(batch))
    jstates.append(state)
    losses.append((float(tl), float(jl)))
  return {"jstates": jstates, "tstate": tstate, "losses": losses,
          "plans": (jplan, tplan), "rules": (jrule, trule)}


def test_sparse_step_with_dense_adam_matches_jax(sparse_runs):
  for tl, jl in sparse_runs["losses"]:
    np.testing.assert_allclose(tl, jl, **TOL)
  want, tstate = sparse_runs["jstates"][-1], sparse_runs["tstate"]
  for part in ("fused", "emb_dense"):
    assert tstate[part]
    for name, arr in want[part].items():
      np.testing.assert_allclose(tstate[part][name].detach().numpy(),
                                 np.asarray(arr), err_msg=name, **TOL)
  wd = dlrm_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                        want["dense"]))
  for name, p in tstate["dense"].items():
    np.testing.assert_allclose(p.detach().numpy(), wd[name].numpy(),
                               err_msg=name, **TOL)
  for part, params in (("dense_opt", tstate["dense"]),
                       ("emb_dense_opt", ttr.trained_tables(tstate))):
    got = optax_state_of(tstate[part], params)
    ref = flatten_paths(jax.tree_util.tree_map(np.asarray, want[part]))
    assert sorted(got) == sorted(ref), part
    for k, v in ref.items():
      np.testing.assert_allclose(np.asarray(got[k]), v, err_msg=k, rtol=1e-4,
                                 atol=1e-6)
    assert int(got["0/count"]) == STEPS


def test_dense_step_with_adam_matches_jax():
  batches = _batches(seed=2)
  params = _jax_params(batches[0])
  model = _model()

  def loss_fn(p, numerical, cats, labels):
    return bce_loss(model.apply({"params": p}, numerical, cats), labels)

  opt = optax.adam(LR)
  jstep = make_train_step(loss_fn, opt, None, params, opt.init(params),
                          _jb(batches[0]), donate=False)
  jp, js = params, opt.init(params)
  jl = []
  for batch in batches:
    jp, js, loss = jstep(jp, js, *_jb(batch))
    jl.append(float(loss))
  tmodel = _torch_model(tables=True)
  tmodel.load_state_dict(dlrm_state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, params)))
  topt = ttr.Adam(tmodel.parameters(), lr=LR)
  tstep = ttr.make_train_step(port_golden.dense_loss, topt, tmodel,
                              device="cpu")
  tl = [float(tstep(*_tb(batch))) for batch in batches]
  np.testing.assert_allclose(tl, jl, **TOL)
  got = port_golden.flax_paths(dlrm_state_dict_to_flax(tmodel.state_dict()))
  want = port_golden.flax_paths(jax.tree_util.tree_map(np.asarray, jp))
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_allclose(got[k], want[k], err_msg=k, rtol=1e-4,
                               atol=1e-5)


def test_install_refuses_foreign_slots_and_missing_counts():
  p = torch.nn.Parameter(torch.zeros(3))
  opt = ttr.Adam([p], lr=LR)
  with pytest.raises(NotImplementedError, match="no counterpart"):
    install_optax_state(opt, {"t": p}, {"0/v/t": np.zeros(3, np.float32)})
  with pytest.raises(ValueError, match="0/count"):
    install_optax_state(opt, {"t": p}, {"0/mu/t": np.zeros(3, np.float32),
                                        "0/nu/t": np.zeros(3, np.float32)})
  install_optax_state(opt, {"t": p}, {"0/mu/t": np.ones(3, np.float32),
                                      "0/nu/t": np.ones(3, np.float32),
                                      "0/count": np.int32(4)})
  assert opt.count == 4 and torch.equal(opt.state[p]["mu"], torch.ones(3))


def test_checkpoint_carries_adam_both_ways(sparse_runs, tmp_path):
  """A JAX checkpoint saved with ``optax.adam`` restores into the port
  and continues its state; the port's save of the same state restores
  into the JAX package with every optax leaf equal."""
  jplan, tplan = sparse_runs["plans"]
  jrule, trule = sparse_runs["rules"]
  jstate = sparse_runs["jstates"][1]
  jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
  jck.save(jpath, jplan, jrule, jstate)
  like = ttr._with_optimizers(
      train_state_from_flax(_numpy_state(jstate), device="cpu"),
      functools.partial(ttr.Adam, lr=LR), None)
  got = ttr._with_optimizers(
      tck.restore(jpath, tplan, trule, like, device="cpu"),
      functools.partial(ttr.Adam, lr=LR), None)
  for part, params in (("dense_opt", got["dense"]),
                       ("emb_dense_opt", ttr.trained_tables(got))):
    assert got[part].count == 1
    ref = flatten_paths(jax.tree_util.tree_map(np.asarray, jstate[part]))
    mine = optax_state_of(got[part], params)
    assert sorted(mine) == sorted(ref)
    for k, v in ref.items():
      np.testing.assert_array_equal(np.asarray(mine[k]), v, err_msg=k)
  tck.save(tpath, tplan, trule, like)
  back = jck.restore(tpath, jplan, jrule, jstate)
  for part in ("dense_opt", "emb_dense_opt"):
    ref = flatten_paths(jax.tree_util.tree_map(np.asarray, jstate[part]))
    mine = flatten_paths(jax.tree_util.tree_map(np.asarray, back[part]))
    assert sorted(mine) == sorted(ref)
    for k, v in ref.items():
      np.testing.assert_array_equal(mine[k], v, err_msg=k)


@pytest.mark.parametrize("scheduled", [False, True])
def test_bf16_moments_cross_convert_and_checkpoint(tmp_path, scheduled):
  """optax.adam's init on bf16 dense-class tables keeps bf16 moments: the
  port carries them as their bits (``convert``), saves them byte-equal to
  the JAX save (``'<V2'`` entries), and restores the JAX save into bf16
  moments; a schedule's ``1/count`` rides along."""
  batch = _batches()[0]
  params = _jax_params(batch)
  jplan = dlrm_embedding_plan(VOCAB, D, 1, dense_row_threshold=THRESHOLD)
  tplan = torch_plan(VOCAB, D, 1, dense_row_threshold=THRESHOLD)
  jrule, trule = jpt.adam_rule(LR), tpt.adam_rule(LR)
  lr = _schedule if scheduled else LR
  jstate = init_sparse_state_direct(jplan, jrule, params, optax.adam(lr),
                                    jax.random.PRNGKey(2),
                                    dtype=jnp.bfloat16)
  factory = functools.partial(ttr.Adam, lr=lr)
  tstate = ttr._with_optimizers(
      train_state_from_flax(_numpy_state(jstate), device="cpu"), factory,
      None)
  flat = optax_state_of(tstate["emb_dense_opt"], ttr.trained_tables(tstate))
  ref = flatten_paths(jax.tree_util.tree_map(np.asarray,
                                             jstate["emb_dense_opt"]))
  assert sorted(flat) == sorted(ref)
  assert any(v.dtype == BF16 for v in ref.values())
  for k, v in ref.items():
    if v.dtype == BF16:
      assert flat[k].dtype == torch.bfloat16, k
      np.testing.assert_array_equal(
          flat[k].view(torch.int16).numpy().view(np.uint16),
          v.view(np.uint16), err_msg=k)
    else:
      np.testing.assert_array_equal(np.asarray(flat[k]), v, err_msg=k)
  jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
  jck.save(jpath, jplan, jrule, jstate)
  tck.save(tpath, tplan, trule, tstate)
  for part in ("dense_opt", "emb_dense_opt"):
    with np.load(f"{jpath}/{part}.npz") as j, \
        np.load(f"{tpath}/{part}.npz") as t:
      assert sorted(j.files) == sorted(t.files), part
      for k in j.files:
        assert j[k].dtype.str == t[k].dtype.str, (part, k)
        assert j[k].tobytes() == t[k].tobytes(), (part, k)
  got = ttr._with_optimizers(
      tck.restore(jpath, tplan, trule, tstate, device="cpu"), factory, None)
  for name, table in ttr.trained_tables(got).items():
    mu = got["emb_dense_opt"].state[table]["mu"]
    assert mu.dtype == torch.bfloat16 and not mu.any()
