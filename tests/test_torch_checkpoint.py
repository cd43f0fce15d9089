"""Full train-state checkpoints in the port (``checkpoint.save`` /
``restore``) against the JAX package's, world 1.

- **Port against port.** N steps, save, restore into a fresh state, M
  more steps: bit-exact against N + M steps straight through (losses,
  every packed buffer, the dense-class tables, the dense params, the
  optimizer states and the step), as ``tests/test_checkpoint.py`` holds
  the JAX package. Dense optimizers: SGD, the scheduled SGD, momentum and
  Adagrad; sparse rules SGD (constant and scheduled) and Adagrad; one-hot
  and padded multi-hot ids; a dense class; ``exact=True``.
- **Across packages, both ways.** The JAX step runs N steps and saves,
  the port restores and runs M more, against the JAX package's N + M
  straight; the port runs N and saves, the JAX package restores and runs
  M more, against the port's N + M straight. Both start from one JAX
  state (``convert.train_state_from_flax``); losses and every final
  tensor, optimizer states included, agree in the f32 class (rtol 1e-5,
  atol 1e-6), and the restored arrays are bit-equal to the saved ones.
  ``train_state_from_flax`` carries a mid-run JAX Adagrad or momentum
  state, which continues as the JAX run does.
- **Refusals** with the JAX package's messages (wrong rule, plan,
  physical shape), the unported arguments naming their ROADMAP items,
  a placement-only plan change re-sharded as the JAX package does. (The ``telemetry``
  section is ported: ``tests/test_torch_resilience.py``.)
- **Atomicity and backup**: a ``.tmp`` is never restorable, a crash in
  the middle of a save leaves the previous checkpoint, ``.old`` is the
  fallback when the manifest is gone.
- **Legacy ``verify``**: a checkpoint without the checksums table gets
  the JAX package's existence checks, the same list from both packages.
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_embeddings_torch import checkpoint as tck
from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import (
    optax_state_of,
    train_state_from_flax,
)
from distributed_embeddings_torch.layers.embedding import \
    TableConfig as TTableConfig
from distributed_embeddings_torch.layers.planner import \
    DistEmbeddingStrategy as TStrategy
from distributed_embeddings_torch.models import DLRM as TDLRM
from distributed_embeddings_torch.models import bce_loss as torch_bce
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_torch.resilience import faultinject
from distributed_embeddings_torch.utils import data as tdata
from distributed_embeddings_tpu import checkpoint as jck
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models import DLRM, bce_loss
from distributed_embeddings_tpu.ops import packed_table as jpt
from distributed_embeddings_tpu.resilience.elastic import flatten_with_paths
from distributed_embeddings_tpu.training import (
    init_sparse_state_direct,
    make_sparse_train_step,
)
from distributed_embeddings_tpu.utils import data as jdata

TOL = dict(rtol=1e-5, atol=1e-6)
VOCAB = [300, 200, 150, 120, 100, 80, 60, 40, 30, 20]
DIM = 16
NUM = 13
B = 32
LR = 0.05
THRESHOLD = 32  # the three smallest tables ride a dense class
PAD_ID = -1
SCHED = (LR, 2, 5, 4)  # warmup, plateau and decay within six steps


def _schedules():
  return jdata.dlrm_lr_schedule(*SCHED), tdata.dlrm_lr_schedule(*SCHED)


# name -> (jax dense optimizer, port dense optimizer factory)
def _dense_opts(name):
  jsched, tsched = _schedules()
  return {
      "sgd": (optax.sgd(LR), functools.partial(torch.optim.SGD, lr=LR)),
      "sched": (optax.sgd(jsched),
                lambda ps: ttr.ScheduledSGD(ps, tsched)),
      "momentum": (optax.sgd(LR, momentum=0.9),
                   functools.partial(torch.optim.SGD, lr=LR, momentum=0.9)),
      "adagrad": (optax.adagrad(LR), functools.partial(ttr.Adagrad, lr=LR)),
  }[name]


def _rules(name):
  jsched, tsched = _schedules()
  if name == "sched":
    return jpt.sgd_rule(jsched), tpt.sgd_rule(tsched)
  return getattr(jpt, f"{name}_rule")(LR), getattr(tpt, f"{name}_rule")(LR)


def _configs(mod, hot):
  return [mod(input_dim=v, output_dim=DIM,
              combiner="sum" if i in hot else None)
          for i, v in enumerate(VOCAB)]


def _plans(hot, world=1):
  return (DistEmbeddingStrategy(_configs(TableConfig, hot), world,
                                dense_row_threshold=THRESHOLD),
          TStrategy(_configs(TTableConfig, hot), world,
                    dense_row_threshold=THRESHOLD))


def _batches(hot, n, seed=0):
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(n):
    cats = []
    for i, v in enumerate(VOCAB):
      if i in hot:
        ids = rng.integers(0, v, (B, hot[i])).astype(np.int32)
        ids[rng.random((B, hot[i])) < 0.3] = PAD_ID  # padded bags
        cats.append(ids)
      else:
        cats.append(rng.integers(0, v, B).astype(np.int32))
    out.append((rng.standard_normal((B, NUM)).astype(np.float32), cats,
                rng.integers(0, 2, B).astype(np.float32)))
  return out


def _tmodel():
  return TDLRM(VOCAB, DIM, bottom_mlp=(32, DIM), top_mlp=(32, 1),
               num_numerical=NUM, tables=False, device="cpu")


def _jmodel():
  return DLRM(vocab_sizes=VOCAB, embedding_dim=DIM, bottom_mlp=(32, DIM),
              top_mlp=(32, 1))


def _jax_init(jplan, jrule, jopt):
  acts = [jnp.zeros((2, DIM)) for _ in VOCAB]
  cats = [jnp.zeros((2,), jnp.int32) for _ in VOCAB]
  dense = _jmodel().init(jax.random.PRNGKey(0), jnp.zeros((2, NUM)), cats,
                         emb_acts=acts)["params"]
  return init_sparse_state_direct(jplan, jrule, dense, jopt,
                                  jax.random.PRNGKey(1))


def _numpy(state):
  return jax.tree_util.tree_map(np.asarray, jax.device_get(state))


def _port_steps(step, state, batches):
  losses = []
  for numerical, cats, labels in batches:
    state, loss = step(state, torch.tensor(numerical),
                       [torch.tensor(c) for c in cats], torch.tensor(labels))
    losses.append(float(loss))
  return state, losses


def _jax_steps(step, state, batches):
  losses = []
  for numerical, cats, labels in batches:
    state, loss = step(state, jnp.asarray(numerical),
                       [jnp.asarray(c) for c in cats], jnp.asarray(labels))
    losses.append(float(loss))
  return state, losses


def _port_snapshot(state):
  """Every array of a port state in the JAX package's flat spelling."""
  out = {f"fused/{k}": v.detach().numpy().copy()
         for k, v in state["fused"].items()}
  for part, flat in tck._npz_parts(state, None, None).items():
    out.update({f"{part}/{k}": np.asarray(v).copy() for k, v in flat.items()})
  out["step"] = np.asarray(state["step"])
  return out


def _jax_snapshot(state):
  st = _numpy(state)
  out = {f"fused/{k}": v for k, v in st["fused"].items()}
  for part in tck._PARTS:
    out.update({f"{part}/{k}": np.asarray(v)
                for k, v in flatten_with_paths(st[part]).items()})
  out["step"] = np.asarray(st["step"])
  return out


def _assert_snapshots(got, want, exact):
  assert sorted(got) == sorted(want)
  for k in want:
    if exact or want[k].dtype.kind in "iu":
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    else:
      np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


# (dense optimizer, sparse rule, multi-hot inputs, exact)
PORT_CASES = {
    "sgd_sgd": ("sgd", "sgd", {}, False),
    "sched_sched_multihot": ("sched", "sched", {0: 3, 8: 2}, False),
    "momentum_adagrad": ("momentum", "adagrad", {}, False),
    "adagrad_adagrad_multihot_exact": ("adagrad", "adagrad", {1: 4}, True),
    "sched_adagrad_exact": ("sched", "adagrad", {}, True),
}


def _port_setup(case, seed):
  opt_name, rule_name, hot, exact = PORT_CASES[case]
  _, tplan = _plans(hot)
  _, trule = _rules(rule_name)
  factory = _dense_opts(opt_name)[1]
  torch.manual_seed(seed)  # the MLPs' init
  model = _tmodel()
  gen = torch.Generator().manual_seed(seed)
  state = ttr.init_sparse_state_direct(tplan, trule, model.state_dict(),
                                       factory, gen, device="cpu")
  step = ttr.make_sparse_train_step(model, tplan, torch_bce, factory, trule,
                                    exact=exact)
  return tplan, trule, state, step, hot


@pytest.mark.parametrize("case", sorted(PORT_CASES))
def test_port_resume_is_bit_exact(tmp_path, case):
  tplan, trule, state, step, hot = _port_setup(case, 7)
  batches = _batches(hot, 4)
  straight, losses_a = _port_steps(step, state, batches)
  want = _port_snapshot(straight)

  _, _, state, step, _ = _port_setup(case, 7)
  state, losses_b = _port_steps(step, state, batches[:2])
  path = str(tmp_path / "ckpt")
  tck.save(path, tplan, trule, state)
  saved = _port_snapshot(state)
  _, _, fresh, _, _ = _port_setup(case, 8)  # other tables: all overwritten
  restored = tck.restore(path, tplan, trule, fresh, device="cpu")
  assert restored["step"] == 2
  assert isinstance(restored["dense_opt"], type(state["dense_opt"]))
  _assert_snapshots(_port_snapshot(restored), saved, exact=True)
  restored, losses_c = _port_steps(step, restored, batches[2:])
  assert losses_b + losses_c == losses_a
  _assert_snapshots(_port_snapshot(restored), want, exact=True)


# (dense optimizer, sparse rule, multi-hot inputs)
CROSS_CASES = {
    "sched_sched": ("sched", "sched", {}),
    "momentum_sgd_multihot": ("momentum", "sgd", {0: 3}),
    "adagrad_adagrad": ("adagrad", "adagrad", {}),
    "sgd_adagrad_multihot": ("sgd", "adagrad", {2: 2, 9: 3}),
}
N_STEPS, M_STEPS = 2, 2


def _cross_setup(case):
  opt_name, rule_name, hot = CROSS_CASES[case]
  jplan, tplan = _plans(hot)
  jrule, trule = _rules(rule_name)
  jopt, factory = _dense_opts(opt_name)
  jstate = _jax_init(jplan, jrule, jopt)
  batches = _batches(hot, N_STEPS + M_STEPS, seed=3)
  first = (jnp.asarray(batches[0][0]),
           [jnp.asarray(c) for c in batches[0][1]],
           jnp.asarray(batches[0][2]))
  jstep = make_sparse_train_step(_jmodel(), jplan, bce_loss, jopt, jrule,
                                 None, jstate, first, donate=False)
  tstep = ttr.make_sparse_train_step(_tmodel(), tplan, torch_bce, factory,
                                     trule)
  return jplan, tplan, jrule, trule, jstate, jstep, tstep, batches


@pytest.mark.parametrize("case", sorted(CROSS_CASES))
def test_jax_checkpoint_resumes_in_the_port(tmp_path, case):
  jplan, tplan, jrule, trule, jstate, jstep, tstep, batches = \
      _cross_setup(case)
  straight, jlosses = _jax_steps(jstep, jstate, batches)
  half, _ = _jax_steps(jstep, jstate, batches[:N_STEPS])
  path = str(tmp_path / "jax_ckpt")
  jck.save(path, jplan, jrule, half)
  like = train_state_from_flax(_numpy(jstate), device="cpu")
  like = ttr._with_optimizers(like, _dense_opts(CROSS_CASES[case][0])[1],
                              None)
  restored = tck.restore(path, tplan, trule, like, device="cpu")
  _assert_snapshots(_port_snapshot(restored), _jax_snapshot(half),
                    exact=True)
  restored, tlosses = _port_steps(tstep, restored, batches[N_STEPS:])
  np.testing.assert_allclose(tlosses, jlosses[N_STEPS:], **TOL)
  _assert_snapshots(_port_snapshot(restored), _jax_snapshot(straight),
                    exact=False)


@pytest.mark.parametrize("case", sorted(CROSS_CASES))
def test_port_checkpoint_resumes_in_jax(tmp_path, case):
  jplan, tplan, jrule, trule, jstate, jstep, tstep, batches = \
      _cross_setup(case)
  init = _numpy(jstate)
  straight, tlosses = _port_steps(
      tstep, train_state_from_flax(init, device="cpu"), batches)
  half, _ = _port_steps(tstep, train_state_from_flax(init, device="cpu"),
                        batches[:N_STEPS])
  path = str(tmp_path / "port_ckpt")
  tck.save(path, tplan, trule, half)
  restored = jck.restore(path, jplan, jrule, jstate)
  _assert_snapshots(_jax_snapshot(restored), _port_snapshot(half),
                    exact=True)
  restored, jlosses = _jax_steps(jstep, restored, batches[N_STEPS:])
  np.testing.assert_allclose(jlosses, tlosses[N_STEPS:], **TOL)
  _assert_snapshots(_jax_snapshot(restored), _port_snapshot(straight),
                    exact=False)


@pytest.mark.parametrize("case", ["adagrad_adagrad", "momentum_sgd_multihot"])
def test_mid_run_jax_state_continues_in_the_port(case):
  """``train_state_from_flax`` carries ``dense_opt`` / ``emb_dense_opt``:
  a JAX Adagrad or momentum run handed over after two steps continues as
  the JAX run does."""
  _, _, _, _, jstate, jstep, tstep, batches = _cross_setup(case)
  half, _ = _jax_steps(jstep, jstate, batches[:N_STEPS])
  straight, jlosses = _jax_steps(jstep, half, batches[N_STEPS:])
  port = train_state_from_flax(_numpy(half), device="cpu")
  assert isinstance(port["dense_opt"], ttr.OptaxState)
  port, tlosses = _port_steps(tstep, port, batches[N_STEPS:])
  np.testing.assert_allclose(tlosses, jlosses, **TOL)
  _assert_snapshots(_port_snapshot(port), _jax_snapshot(straight),
                    exact=False)


def test_optax_forms_round_trip_and_adam_is_refused():
  """Each supported optax form's flattened keys, as optax writes them,
  round-trip through the port's optimizers, ``optax.adam``'s through
  ``training.Adam`` (its ``0/count``, ``mu`` and ``nu``); the state of an
  optax optimizer the port has no counterpart for is refused by name, and
  so is ``torch.optim.Adam``, which is not ``optax.adam``'s rule."""
  model = _tmodel()
  params = {k: v.clone().requires_grad_(True)
            for k, v in model.state_dict().items()}
  jparams = jax.tree_util.tree_map(
      np.asarray, _jmodel().init(
          jax.random.PRNGKey(0), jnp.zeros((2, NUM)),
          [jnp.zeros((2,), jnp.int32) for _ in VOCAB],
          emb_acts=[jnp.zeros((2, DIM)) for _ in VOCAB])["params"])
  rng = np.random.default_rng(0)
  forms = {name: _dense_opts(name)
           for name in ("sgd", "sched", "momentum", "adagrad")}
  forms["adam"] = (optax.adam(LR), functools.partial(ttr.Adam, lr=LR))
  for name, (jopt, factory) in forms.items():
    want = {k: (rng.random(np.shape(v)).astype(np.float32)
                if np.ndim(v) else np.asarray(5, np.int32))
            for k, v in flatten_with_paths(jopt.init(jparams)).items()}
    opt = factory(list(params.values()))
    from distributed_embeddings_torch.convert import install_optax_state
    install_optax_state(opt, params, want)
    got = optax_state_of(opt, params)
    assert sorted(got) == sorted(want), name
    for k in want:
      np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
  foreign = {k: np.asarray(v) for k, v in
             flatten_with_paths(optax.adadelta(LR).init(jparams)).items()}
  with pytest.raises(NotImplementedError, match="no counterpart"):
    install_optax_state(torch.optim.SGD(list(params.values()), lr=LR),
                        params, foreign)
  with pytest.raises(NotImplementedError, match="training.Adam"):
    optax_state_of(torch.optim.Adam(list(params.values())), params)


def _saved(tmp_path, rule_name="adagrad", world=1):
  jplan, tplan = _plans({}, world)
  jrule, trule = _rules(rule_name)
  gen = torch.Generator().manual_seed(0)
  state = ttr.init_sparse_state_direct(
      tplan, trule, _tmodel().state_dict(),
      functools.partial(ttr.Adagrad, lr=LR), gen, device="cpu")
  path = str(tmp_path / "ckpt")
  tck.save(path, tplan, trule, state)
  return path, jplan, tplan, jrule, trule, state


def _same_refusal(fn_t, fn_j, exc=ValueError):
  with pytest.raises(exc) as got:
    fn_t()
  with pytest.raises(exc) as want:
    fn_j()
  assert str(got.value) == str(want.value)
  return str(got.value)


def test_restore_refuses_with_the_jax_messages(tmp_path):
  path, jplan, tplan, jrule, trule, state = _saved(tmp_path)
  jstate = jck.restore(path, jplan, jrule, _jax_init(
      jplan, jrule, optax.adagrad(LR)))
  msg = _same_refusal(
      lambda: tck.restore(path, tplan, tpt.sgd_rule(LR), state,
                          device="cpu"),
      lambda: jck.restore(path, jplan, jpt.sgd_rule(LR), jstate))
  assert "rule" in msg
  other_j = DistEmbeddingStrategy(
      [TableConfig(input_dim=v + 1, output_dim=DIM) for v in VOCAB], 1,
      dense_row_threshold=THRESHOLD)
  other_t = TStrategy(
      [TTableConfig(input_dim=v + 1, output_dim=DIM) for v in VOCAB], 1,
      dense_row_threshold=THRESHOLD)
  msg = _same_refusal(
      lambda: tck.restore(path, other_t, trule, state, device="cpu"),
      lambda: jck.restore(path, other_j, jrule, jstate))
  assert "plan does not match" in msg and "logical tables differ" in msg
  # a manifest whose physical shape disagrees with the plan's
  mpath = os.path.join(path, "manifest.json")
  manifest = json.load(open(mpath))
  name = sorted(manifest["fused"])[0]
  manifest["fused"][name]["phys_rows"] += 1
  json.dump(manifest, open(mpath, "w"))
  msg = _same_refusal(
      lambda: tck.restore(path, tplan, trule, state, device="cpu"),
      lambda: jck.restore(path, jplan, jrule, jstate))
  assert "physical shape" in msg


@pytest.mark.parametrize("arg,item", [
    ("vocab", "item 12"), ("stream", "item 12")])
def test_unported_arguments_name_their_item(tmp_path, arg, item):
  path, jplan, tplan, jrule, trule, state = _saved(tmp_path)
  if arg == "vocab":
    # item 12a ported the vocab section: on a static plan and checkpoint
    # a translator is refused at restore and at save, with the JAX
    # messages (tests/test_torch_dynvocab.py holds the section itself)
    jstate = jck.restore(path, jplan, jrule, _jax_init(
        jplan, jrule, optax.adagrad(LR)))
    msg = _same_refusal(
        lambda: tck.restore(path, tplan, trule, state, device="cpu",
                            vocab=object()),
        lambda: jck.restore(path, jplan, jrule, jstate, vocab=object()))
    assert "no 'vocab' section" in msg
    msg = _same_refusal(
        lambda: tck.save(path + "_v", tplan, trule, state, vocab=object()),
        lambda: jck.save(path + "_j", jplan, jrule, jstate, vocab=object()))
    assert "static-vocab plan" in msg
    return
  # item 12b ported the stream section: a checkpoint without one leaves
  # the argument untouched, an object that is no DeltaPublisher fails the
  # save alike, and a section of another quantize mode is refused with
  # the JAX message (tests/test_torch_streaming.py holds the section)
  from distributed_embeddings_torch import streaming as ts
  from distributed_embeddings_tpu import streaming as js
  jstate = jck.restore(path, jplan, jrule, _jax_init(
      jplan, jrule, optax.adagrad(LR)))
  tck.restore(path, tplan, trule, state, device="cpu", stream=object())
  jck.restore(path, jplan, jrule, jstate, stream=object())
  msg = _same_refusal(
      lambda: tck.save(path + "_s", tplan, trule, state, stream=object()),
      lambda: jck.save(path + "_j", jplan, jrule, jstate, stream=object()),
      exc=AttributeError)
  assert "manifest_section" in msg
  pub = ts.DeltaPublisher(str(tmp_path / "pub"), tplan, trule,
                          ts.RowGenerationTracker(tplan), quantize="f32")
  tck.save(path + "_f32", tplan, trule, state, stream=pub)
  msg = _same_refusal(
      lambda: tck.restore(
          path + "_f32", tplan, trule, state, device="cpu",
          stream=ts.DeltaPublisher(str(tmp_path / "pub"), tplan, trule,
                                   ts.RowGenerationTracker(tplan),
                                   quantize="int8")),
      lambda: jck.restore(
          path + "_f32", jplan, jrule, jstate,
          stream=js.DeltaPublisher(str(tmp_path / "jpub"), jplan, jrule,
                                   js.RowGenerationTracker(jplan),
                                   quantize="int8")))
  assert "quantize='f32'" in msg


def test_placement_only_mismatch_names_item_11(tmp_path):
  """A world-2 checkpoint (one process holding both ranks' blocks) under
  the world-1 plan of the same tables: a placement-only change (ROADMAP
  item 11b), re-sharded elastically by both packages. Every array of the
  port's restore is bit-equal to the JAX package's elastic restore."""
  path, jplan2, _, jrule, trule, _ = _saved(tmp_path, world=2)
  jplan1, tplan1 = _plans({})
  _, _, _, _, _, state1 = _saved(tmp_path / "w1")
  got = tck.restore(path, tplan1, trule, state1, device="cpu")
  want = jck.restore(path, jplan1, jrule, _jax_init(jplan1, jrule,
                                                    optax.adagrad(LR)))
  _assert_snapshots(_port_snapshot(got), _jax_snapshot(want), exact=True)


def test_tmp_is_never_restorable_and_old_is_the_fallback(tmp_path):
  path, _, tplan, _, trule, state = _saved(tmp_path)
  first = open(os.path.join(path, "manifest.json")).read()
  state["step"] = 5
  tck.save(path, tplan, trule, state)
  assert open(os.path.join(path + ".old", "manifest.json")).read() == first
  assert tck.restore(path, tplan, trule, state, device="cpu")["step"] == 5
  # a crash in the middle of the next save: the .tmp has no manifest and
  # the published checkpoint is untouched
  state["step"] = 9
  with faultinject.injected(
      faultinject.FaultInjector().crash_after("ckpt_write", 2)):
    with pytest.raises(faultinject.InjectedCrash):
      tck.save(path, tplan, trule, state)
  assert os.path.isdir(path + ".tmp")
  with pytest.raises(ValueError, match="missing manifest"):
    tck.restore(path + ".tmp", tplan, trule, state, device="cpu")
  assert tck.restore(path, tplan, trule, state, device="cpu")["step"] == 5
  # a crash between the two renames leaves only the backup
  os.rename(path, str(tmp_path / "moved"))
  assert tck.restore(path, tplan, trule, state, device="cpu")["step"] == 0


def test_legacy_verify_gives_the_jax_list(tmp_path):
  """A checkpoint from before the durable format (no checksums table):
  both ``verify``s run the same existence checks and return the same
  list, empty while every file is there."""
  path, *_ = _saved(tmp_path, world=2)
  mpath = os.path.join(path, "manifest.json")
  manifest = json.load(open(mpath))
  del manifest["checksums"]
  json.dump(manifest, open(mpath, "w"))
  assert tck.verify(path) == jck.verify(path) == []
  name = sorted(manifest["fused"])[0]
  os.remove(os.path.join(path, f"fused_{name}_r1.npy"))
  os.remove(os.path.join(path, "emb_dense_opt.npz"))
  got = tck.verify(path)
  assert got == jck.verify(path)
  assert len(got) == 2 and all(p.startswith("missing file:") for p in got)
  shutil.rmtree(path)
  assert tck.verify(path) == jck.verify(path)
