"""The PyTorch port's planner (``distributed_embeddings_torch/layers/
planner.py``) against the JAX package's, field by field.

The plan is pure Python in both packages, so every field must be equal:
classes and their kinds, widths, shards, slots and row offsets, the
output pieces and the input -> table map.
"""

import pytest

from distributed_embeddings_torch.layers.embedding import (
    TableConfig as TorchTableConfig,
)
from distributed_embeddings_torch.layers.planner import (
    DistEmbeddingStrategy as TorchStrategy,
)
from distributed_embeddings_torch.models.dlrm import (
    dlrm_embedding_plan as torch_dlrm_embedding_plan,
)
from distributed_embeddings_tpu.layers.embedding import TableConfig
from distributed_embeddings_tpu.layers.planner import DistEmbeddingStrategy
from distributed_embeddings_tpu.models.dlrm import dlrm_embedding_plan

CRITEO_1TB_VOCAB = [
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36
]
BENCH_VOCAB = [max(4, int(v / 16)) for v in CRITEO_1TB_VOCAB]


def _shard(sh):
  return (sh.table_id, sh.col_start, sh.col_end, sh.input_dim, sh.combiner,
          sh.gen, sh.row_start, sh.row_sliced)


def plan_fields(plan):
  """Every field of a plan, as plain comparable data."""
  classes = {}
  for key in plan.class_keys:
    cp = plan.classes[key]
    classes[key] = dict(
        width=cp.width, combiner=cp.combiner, kind=cp.kind,
        shards=[[_shard(sh) for sh in shards]
                for shards in cp.shards_per_rank],
        row_offsets=cp.row_offsets_per_rank, rows=cp.rows_per_rank,
        slots=[[(s.input_id, s.row_offset, _shard(s.shard)) for s in slots]
               for slots in cp.slots_per_rank],
        max_rows=cp.max_rows, num_slots=cp.num_slots)
  pieces = [[(p.class_key, p.rank, p.slot, p.width, p.col_start,
              p.row_sliced) for p in pcs] for pcs in plan.output_pieces]
  return dict(
      class_keys=list(plan.class_keys), classes=classes,
      class_tiers=dict(plan.class_tiers), output_pieces=pieces,
      input_table_map=list(plan.input_table_map),
      rank_shards=[[_shard(sh) for sh in shards]
                   for shards in plan.rank_shards],
      table_ids=plan.table_ids, table_col_ranges=plan.table_col_ranges,
      table_row_ranges=plan.table_row_ranges,
      sliced_out_ranges=plan.sliced_out_ranges,
      input_ids_list=plan.input_ids_list, local_configs=plan.local_configs,
      local_group_list=plan.local_group_list,
      local_weight_offsets=plan.local_weight_offsets,
      local_maps=plan.local_maps,
      local_input_offsets=plan.local_input_offsets,
      widths_list_flat=plan.widths_list_flat,
      rev_global_input_ids=plan.rev_global_input_ids,
      strategy=plan.strategy, world_size=plan.world_size)


def test_bench_config_plan_equal():
  """The bench.py configuration: Criteo-1TB vocabularies x 1/16, width
  128, dense_row_threshold=4096, 'basic', world 1."""
  kw = dict(embedding_dim=128, world_size=1, strategy="basic",
            dense_row_threshold=4096, batch_hint=65536)
  want = dlrm_embedding_plan(BENCH_VOCAB, **kw)
  got = torch_dlrm_embedding_plan(BENCH_VOCAB, **kw)
  assert plan_fields(got) == plan_fields(want)
  kinds = {cp.kind for cp in got.classes.values()}
  assert kinds == {"sparse", "dense"}


TABLES = [(1000, 32, "sum"), (50, 16, "mean"), (200000, 64, None),
          (7, 8, None), (30000, 128, "sum"), (123, 32, "mean"),
          (4096, 16, None), (900, 64, "sum"), (2, 128, None)]


@pytest.mark.parametrize("strategy", ["memory_balanced", "memory_optimized"])
def test_world8_plan_equal(strategy):
  kw = dict(dense_row_threshold=256, column_slice_threshold=200000 * 16,
            input_table_map=[0, 1, 2, 3, 4, 5, 6, 7, 8, 2, 4],
            input_hotness=[1, 3, 1, 1, 2, 5, 1, 1, 1, 2, 1])
  want = DistEmbeddingStrategy(
      [TableConfig(v, w, combiner=c) for v, w, c in TABLES], 8, strategy,
      **kw)
  got = TorchStrategy(
      [TorchTableConfig(v, w, combiner=c) for v, w, c in TABLES], 8,
      strategy, **kw)
  assert plan_fields(got) == plan_fields(want)
  assert len(got.table_col_ranges[2]) > 1  # column slicing exercised


def test_dict_configs_and_refusals_match():
  dicts = [dict(input_dim=v, output_dim=w, combiner=c) for v, w, c in TABLES]
  want = DistEmbeddingStrategy(dicts, 4, "basic", row_slice_threshold=40000)
  got = TorchStrategy(dicts, 4, "basic", row_slice_threshold=40000)
  assert plan_fields(got) == plan_fields(want)
  assert any(sh.row_sliced for shards in got.rank_shards for sh in shards)
  for bad in (dict(strategy="nope"), dict(oov="maybe"),
              dict(wire_dtype="f16")):
    args = dict(strategy="basic")
    args.update(bad)
    strategy = args.pop("strategy")
    with pytest.raises(ValueError):
      DistEmbeddingStrategy(dicts, 2, strategy, **args)
    with pytest.raises(ValueError):
      TorchStrategy(dicts, 2, strategy, **args)
