"""Elastic restores in the port (``checkpoint.restore`` across worlds,
``resilience/elastic``'s regroup engine) against the JAX package's, on
``tests/test_elastic.py``'s cell (vocabularies ``[300, 200, 150, 20]``,
width 16, the 20-row table a dense class, Adagrad on both sides) and its
tiered cell (``[5000, 300, 40]``, the 5,000-row table host-tier).

The JAX package writes world-4 and world-2 checkpoints of the cell
(three steps each, on its CPU mesh); every restore below must equal, bit
for bit, the JAX package's own elastic restore at that world: every
packed block (table and optimizer lanes), dense-class block, dense
parameter and optax leaf.

- **4 -> 1** and **2 -> 4** in this process, **4 -> 2** over two gloo ranks (one spawn
  for the module, ``tests/torch_ranks.py: elastic_job``; each rank reads
  only its own target blocks), the step restored.
- **4 -> 2 -> 4**: the ranks save their world-2 state; its restore at
  world 4 equals the JAX round trip, and every logical row equals the
  world-4 source's.
- **Padding is neutral to training**: the JAX world-2 checkpoint restored
  as written and after a trip through world 4 (padding re-zeroed) take a
  step at world 2 to the same loss and the same arrays.
- **Restore, then train** at world 2: the ranks' loss is JAX's (f32
  class) and the same on both ranks.
- **The manifest's world section** of the port's world-2 save equals the
  JAX package's.
- **Refusals** (different tables, a kind flip, a cross-tier move) with
  the JAX package's messages.
- **Tiered 4 -> 2**: the cold images, resident sets and re-mapped
  observed counts equal the JAX restore's.
- **bf16**, which the JAX package cannot restore: a bf16 state re-sharded
  2 -> 1 -> 2 keeps every logical row's bits (tables and optimizer
  lanes), and the dense-class optimizer leaves come back bit-equal.
"""

import functools
import os

import jax
import numpy as np
import optax
import pytest
import torch

import test_elastic as te
import torch_ranks
from distributed_embeddings_torch import checkpoint as tck
from distributed_embeddings_torch import tiering as tt
from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import train_state_from_flax
from distributed_embeddings_torch.layers.planner import \
    DistEmbeddingStrategy as TStrategy
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_torch.parallel.lookup_engine import (
    class_param_name,
    padded_rows,
)
from distributed_embeddings_tpu import checkpoint as jck
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.resilience.elastic import flatten_with_paths
from distributed_embeddings_tpu.tiering import TieredTrainer as JTiered
from distributed_embeddings_tpu.training import shard_params

RULE = tpt.adagrad_rule(0.05)
FACTORY = functools.partial(ttr.Adagrad, lr=0.05)
TOL = dict(rtol=1e-5, atol=1e-6)


def _tplan(world, **kw):
  return TStrategy(
      [dict(input_dim=v, output_dim=16,
            initializer={"name": "uniform", "scale": 0.05})
       for v in te.VOCAB], world, "basic", dense_row_threshold=32, **kw)


def _host(state):
  return jax.tree_util.tree_map(np.asarray, jax.device_get(state))


def _jax_arrays(state):
  """Every array of a JAX state in checkpoint spelling (global blocks)."""
  st = _host(state)
  out = {f"fused/{k}": v for k, v in st["fused"].items()}
  for part in ("dense", "dense_opt", "emb_dense", "emb_dense_opt"):
    out.update({f"{part}/{k}": np.asarray(v)
                for k, v in flatten_with_paths(st[part]).items()})
  out["step"] = np.asarray(st["step"])
  return out


def _port_arrays(state):
  """The same for a port state that holds every rank's blocks."""
  out = {f"fused/{k}": v.detach().numpy().copy()
         for k, v in state["fused"].items()}
  for part, flat in tck._npz_parts(state, None, None).items():
    out.update({f"{part}/{k}": np.asarray(v).copy() for k, v in flat.items()})
  out["step"] = np.asarray(state["step"])
  return out


def _assert_arrays_equal(got, want):
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _port_like(jstate):
  return ttr._with_optimizers(train_state_from_flax(_host(jstate),
                                                    device="cpu"),
                              FACTORY, None)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
  """The JAX checkpoints and oracles, and the module's one spawn of two
  gloo ranks (running while the JAX round trip and tiered runs go)."""
  tmp = tmp_path_factory.mktemp("elastic")
  path4, plan4, s4, _, _ = te.trained_checkpoint(str(tmp), world=4)
  path2, plan2, s2, step2, sb2 = te.trained_checkpoint(str(tmp), world=2)
  mesh2 = create_mesh(2)
  _, _, _, batch, like2 = te.init(2, mesh2)
  # the port's world-4 state of the JAX world-2 checkpoint (padding
  # re-zeroed), saved for the ranks' padding check
  mesh4 = create_mesh(4)
  jlike4 = te.init(4, mesh4)[4]
  like4 = _port_like(jlike4)
  s24 = tck.restore(path2, _tplan(4), RULE, like4, device="cpu")
  path2_4 = str(tmp / "port_2to4")
  tck.save(path2_4, _tplan(4), RULE, s24)
  back = str(tmp / "port_back")
  started = torch_ranks.spawn_start(tmp, 2, "elastic_job", {
      "vocab": te.VOCAB, "like": _host(like2), "batch": batch,
      "path4": path4, "pathn": path2, "pathn_4": path2_4, "back": back})

  out = {"tmp": tmp, "path4": path4, "plan4": plan4, "s4": _host(s4),
         "back": back, "batch": batch, "p24": _port_arrays(s24)}
  # the JAX oracle of 2 -> 4
  out["j24"] = _jax_arrays(jck.restore(path2, plan4, te.RULE, jlike4,
                                       mesh=mesh4))
  # the JAX oracles: 4 -> 2, the step after it, 4 -> 2 -> 4, 4 -> 1
  j2 = jck.restore(path4, plan2, te.RULE, like2, mesh=mesh2)
  out["j2"] = _jax_arrays(j2)
  out["j2_loss"] = float(step2(j2, *sb2)[1])
  jback = str(tmp / "jax_back")
  jck.save(jback, plan2, te.RULE, j2)
  out["j_back"] = jback
  out["j4b"] = _jax_arrays(jck.restore(jback, plan4, te.RULE, s4,
                                       mesh=create_mesh(4)))
  mesh1 = create_mesh(1)
  _, plan1, _, _, like1 = te.init(1, mesh1)
  out["j1"] = _jax_arrays(jck.restore(path4, plan1, te.RULE, like1,
                                      mesh=mesh1))
  out["like1"] = like1
  out["tiered"] = _jax_tiered(tmp)
  out["ranks"] = torch_ranks.spawn_wait(started)
  return out


def _jax_tiered(tmp):
  """The JAX world-4 tiered run (four steps), its checkpoint and its
  restore at world 2: the store's arrays and the template state."""
  mesh4, mesh2 = create_mesh(4), create_mesh(2)
  plan4, model4, tplan4, store4, b0, state4 = te.tiered_fresh(4, mesh4)
  tr4 = JTiered(model4, tplan4, store4, te.bce_loss, optax.adam(1e-3),
                te.RULE, mesh4, shard_params(state4, mesh4), b0,
                donate=False)
  tr4.run([te.tiered_batch(100 + i) for i in range(4)])
  tr4.flush()
  path = os.path.join(str(tmp), "ck_t4")
  jck.save(path, plan4, te.RULE, tr4.state, store=store4)
  plan2, _, _, jstore2, _, jlike = te.tiered_fresh(2, mesh2, seed=9)
  jck.restore(path, plan2, te.RULE, jlike, mesh=mesh2, store=jstore2)
  return {"path": path, "like": _host({**jlike, "fused": {}}),
          "store": {part: {name: [np.asarray(v) for v in per]
                           for name, per in getattr(jstore2, part).items()}
                    for part in ("images", "resident_grps", "counts")}}


def test_restore_4_to_1_bit_exact(cell):
  got = tck.restore(cell["path4"], _tplan(1), RULE, _port_like(
      cell["like1"]), device="cpu")
  assert got["step"] == 3
  _assert_arrays_equal(_port_arrays(got), cell["j1"])


def test_restore_2_to_4_bit_exact(cell):
  _assert_arrays_equal(cell["p24"], cell["j24"])


def test_restore_4_to_2_ranks_bit_exact(cell):
  """Each rank's blocks equal its rows of the JAX world-2 restore."""
  plan2 = _tplan(2)
  rows = {class_param_name(*k): padded_rows(plan2, k)
          for k in plan2.class_keys}
  for rank, res in enumerate(cell["ranks"]):
    got = res["restored"]
    assert got["step"] == 3
    for key, arr in got.items():
      if key == "step":
        continue
      part, _, name = key.partition("/")
      want = cell["j2"].get(key)
      cname = name.rpartition("/")[2]
      if part == "fused":
        n = want.shape[0] // 2
        want = want[rank * n:(rank + 1) * n]
      elif part.startswith("emb_dense") and cname in rows:
        n = rows[cname]
        want = want[rank * n:(rank + 1) * n]
      np.testing.assert_array_equal(arr, want, err_msg=f"rank {rank} {key}")


def test_roundtrip_4_2_4(cell):
  """The ranks' world-2 save restored at world 4 equals the JAX round
  trip, and every logical row is the world-4 source's."""
  got = tck.restore(cell["back"], _tplan(4), RULE,
                    _port_like(cell["s4"]), device="cpu")
  arrays = _port_arrays(got)
  _assert_arrays_equal(arrays, cell["j4b"])
  fused = {k.split("/", 1)[1]: v for k, v in arrays.items()
           if k.startswith("fused/")}
  emb = {k.split("/", 1)[1]: v for k, v in arrays.items()
         if k.startswith("emb_dense/")}
  te.assert_tables_equal(
      te.logical_tables(cell["plan4"], te.RULE, cell["s4"]),
      te.logical_tables(cell["plan4"], te.RULE,
                        {"fused": fused, "emb_dense": emb}))


def _rank_logical_rows(plan, rank, arrays):
  """A rank's live logical rows (table and optimizer lanes) of each
  class, from its packed blocks and its dense-class leaves: padding rows
  and lanes left out."""
  out = {}
  for key in plan.class_keys:
    cp = plan.classes[key]
    name = class_param_name(*key)
    if cp.kind != "sparse":
      for k, v in arrays.items():
        if k.startswith("emb_dense") and k.endswith("/" + name):
          for s in cp.slots_per_rank[rank]:
            out[(k, s.row_offset)] = \
                v[s.row_offset:s.row_offset + s.shard.input_dim]
      continue
    lay = tpt.PackedLayout(rows=padded_rows(plan, key), width=cp.width,
                           n_aux=RULE.n_aux)
    tbl, aux = lay.unpack(arrays[f"fused/{name}"])
    for s in cp.slots_per_rank[rank]:
      for a, p in enumerate([tbl] + list(aux)):
        out[(name, s.row_offset, a)] = \
            p[s.row_offset:s.row_offset + s.shard.input_dim]
  return out


def test_padding_reinit_is_training_neutral(cell):
  """The trip re-zeroes padding rows and lanes (the JAX draw fills the
  Adagrad lanes of padding with 0.1): the step's loss, every live
  logical row and every other array come out the same."""
  plan2 = _tplan(2)
  for rank, res in enumerate(cell["ranks"]):
    (loss_a, a), (loss_b, b) = res["direct"], res["trip"]
    assert loss_a == loss_b
    def rest(x):
      return {k: v for k, v in x.items()
              if not (k.startswith("fused/") or (
                  k.startswith("emb_dense") and k.endswith("_dense")))}
    _assert_arrays_equal(rest(b), rest(a))
    la, lb = (_rank_logical_rows(plan2, rank, x) for x in (a, b))
    assert sorted(la) == sorted(lb)
    for k in la:
      np.testing.assert_array_equal(lb[k], la[k], err_msg=str(k))


def test_restore_then_train_at_new_world(cell):
  losses = [res["loss"] for res in cell["ranks"]]
  assert losses[0] == losses[1] and np.isfinite(losses[0])
  np.testing.assert_allclose(losses[0], cell["j2_loss"], **TOL)


def test_manifest_world_section(cell):
  got = tck.read_manifest(cell["back"])
  want = jck.read_manifest(cell["j_back"])
  assert got["world"] == want["world"] and got["world"]["ranks"] == 2
  assert got["plan"] == want["plan"]


def test_refusals_carry_the_jax_reasons(cell):
  path = cell["path4"]
  mesh2 = create_mesh(2)
  _, _, _, _, jlike = te.init(2, mesh2)
  like = _port_like(jlike)
  from distributed_embeddings_tpu.layers.planner import \
      DistEmbeddingStrategy as JStrategy
  from distributed_embeddings_tpu.tiering import HostTierStore as JStore
  from distributed_embeddings_tpu.tiering import TieringConfig as JCfg
  from distributed_embeddings_tpu.tiering import TieringPlan as JTPlan

  def both(kw, table_kw=None):
    vocab = [v + 1 for v in te.VOCAB] if table_kw else te.VOCAB
    args = ([dict(input_dim=v, output_dim=16,
                  initializer={"name": "uniform", "scale": 0.05})
             for v in vocab], 2, "basic")
    return JStrategy(*args, **kw), TStrategy(*args, **kw)

  cases = {
      "cannot be elastically": both({"dense_row_threshold": 32}, True),
      "kind": both({"dense_row_threshold": 0}),
      "cross-tier": both({"dense_row_threshold": 32,
                          "host_row_threshold": 250}),
  }
  for match, (jp, tp) in cases.items():
    jstore = tstore = None
    if tp.host_tier_class_keys():
      cfg = dict(cache_fraction=0.3, staging_grps=8)
      jstore = JStore(JTPlan(jp, te.RULE, JCfg(**cfg)))
      tstore = tt.HostTierStore(tt.TieringPlan(tp, RULE,
                                               tt.TieringConfig(**cfg)))
    with pytest.raises(ValueError) as got:
      tck.restore(path, tp, RULE, like, store=tstore, device="cpu")
    with pytest.raises(ValueError) as want:
      jck.restore(path, jp, te.RULE, jlike, mesh=mesh2, store=jstore)
    assert str(got.value) == str(want.value)
    assert match in str(got.value)


def test_tiered_restore_4_to_2_and_remapped_counts(cell):
  """The JAX world-4 tiered run's checkpoint restored at world 2 (one
  process holding both ranks' stores): cold images, resident sets and the
  re-mapped observed counts equal the JAX restore's, counts nonzero and
  each rank's hottest group resident."""
  jt = cell["tiered"]
  path = jt["path"]
  tplan = tt.TieringPlan(
      TStrategy([dict(input_dim=v, output_dim=te.T_WIDTH)
                 for v in te.T_VOCAB], 2, "memory_balanced",
                dense_row_threshold=0, host_row_threshold=1000),
      RULE, tt.TieringConfig(cache_fraction=0.3, staging_grps=64))
  store = tt.HostTierStore(tplan)
  like = train_state_from_flax(jt["like"], device="cpu")
  like = ttr._with_optimizers(like, functools.partial(ttr.Adam, lr=1e-3),
                              None)
  got = tck.restore(path, tplan.plan, RULE, like, store=store, device="cpu")
  assert got["step"] == 4
  for part, per_name in jt["store"].items():
    for name, per in per_name.items():
      for r, v in enumerate(per):
        np.testing.assert_array_equal(getattr(store, part)[name][r], v,
                                      err_msg=f"{part} {name} {r}")
  assert sum(int(c.sum()) for per in store.counts.values() for c in per) > 0
  for name, per in store.counts.items():
    for r, cnt in enumerate(per):
      if cnt.max():
        assert int(np.argmax(cnt)) in store.resident_grps[name][r]


def _logical_bits(plan, state):
  """Every logical row (table and optimizer lanes) of a whole-world port
  state, as bits: ``{table_id: [1 + n_aux, rows, width] uint16}``."""
  n_aux = RULE.n_aux
  out = {}
  for key in plan.class_keys:
    cp = plan.classes[key]
    name = class_param_name(*key)
    rows = padded_rows(plan, key)
    if cp.kind == "sparse":
      lay = tpt.PackedLayout(rows=rows, width=cp.width, n_aux=n_aux)
      buf = state["fused"][name].view(torch.int16).numpy()
      for rank in range(plan.world_size):
        tbl, aux = lay.unpack(buf[rank * lay.phys_rows:
                                  (rank + 1) * lay.phys_rows])
        for s in cp.slots_per_rank[rank]:
          sh = s.shard
          dst = out.setdefault(sh.table_id, np.zeros(
              (1 + n_aux, te.VOCAB[sh.table_id], 16), np.int16))
          for a, p in enumerate([tbl] + list(aux)):
            dst[a, sh.row_start:sh.row_start + sh.input_dim,
                sh.col_start:sh.col_end] = \
                p[s.row_offset:s.row_offset + sh.input_dim]
    else:
      arr = state["emb_dense"][name].detach().view(torch.int16).numpy()
      for rank in range(plan.world_size):
        for s in cp.slots_per_rank[rank]:
          sh = s.shard
          dst = out.setdefault(sh.table_id, np.zeros(
              (1 + n_aux, te.VOCAB[sh.table_id], 16), np.int16))
          base = rank * rows + s.row_offset
          dst[0, sh.row_start:sh.row_start + sh.input_dim,
              sh.col_start:sh.col_end] = arr[base:base + sh.input_dim]
  return out


def test_bf16_restore_across_worlds_keeps_every_row(tmp_path):
  def plan(world):  # the Keras-uniform tables the direct draw takes
    return TStrategy([dict(input_dim=v, output_dim=16) for v in te.VOCAB],
                     world, "basic", dense_row_threshold=32)
  plan2, plan1 = plan(2), plan(1)
  model = torch_ranks._elastic_cell(1, {"vocab": te.VOCAB})[1]
  state = ttr.init_sparse_state_direct(
      plan2, RULE, model.state_dict(), FACTORY,
      torch.Generator().manual_seed(3), device="cpu", dtype=torch.bfloat16)
  p2, p1, p2b = (str(tmp_path / n) for n in ("w2", "w1", "w2b"))
  tck.save(p2, plan2, RULE, state)
  s1 = tck.restore(p2, plan1, RULE, state, device="cpu")
  assert all(t.dtype == torch.bfloat16 for t in s1["fused"].values())
  want = _logical_bits(plan2, state)
  got1 = _logical_bits(plan1, s1)
  for t in want:
    np.testing.assert_array_equal(got1[t], want[t], err_msg=f"table {t}")
  tck.save(p1, plan1, RULE, s1)
  s2 = tck.restore(p1, plan2, RULE, state, device="cpu")
  got2 = _logical_bits(plan2, s2)
  for t in want:
    np.testing.assert_array_equal(got2[t], want[t], err_msg=f"table {t}")
  # the dense-class optimizer leaves, on their live rows (padding rows
  # come back zero)
  tck.save(p2b, plan2, RULE, s2)
  flats = [tck._read_npz(p, "emb_dense_opt") for p in (p2, p2b)]
  live = {}
  for key in plan2.class_keys:
    cp = plan2.classes[key]
    if cp.kind != "sparse":
      rows = padded_rows(plan2, key)
      live[class_param_name(*key)] = np.concatenate([
          r * rows + s.row_offset + np.arange(s.shard.input_dim)
          for r in range(2) for s in cp.slots_per_rank[r]])
  assert sorted(flats[0]) == sorted(flats[1])
  for k, v in flats[0].items():
    name = k.rpartition("/")[2]
    a, b = (x.view(np.int16) if x.dtype.kind == "V" else x
            for x in (v, flats[1][k]))
    if name in live:
      a, b = a[live[name]], b[live[name]]
    np.testing.assert_array_equal(b, a, err_msg=k)
