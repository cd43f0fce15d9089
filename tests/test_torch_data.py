"""The port's split-binary Criteo reader (``utils/data.py``) against the
JAX package's ``RawBinaryCriteoDataset``, on splits that
``write_dummy_criteo_split`` writes (both packages' writers give the same
files).

Every batch is bit-equal to the JAX reader's (numpy backend) on both of
the port's backends: the native C++ loader (the port's own copy of
``cc/data_loader.cc``, built into ``build/torch_native/``) and numpy
memory maps. Covered: dp slicing over 4 ranks, a feature subset in its
own order, no numerical features, the valid split, the trailing partial
batch, the empty rank slice, direct indexing, and the size checks.
"""

import filecmp

import numpy as np
import pytest

from distributed_embeddings_torch import cc as tcc
from distributed_embeddings_torch.utils import data as tdata
from distributed_embeddings_tpu.utils import data as jdata

VOCAB = [50, 40_000, 3_000_000]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
  d = tmp_path_factory.mktemp("criteo")
  jdata.write_dummy_criteo_split(str(d), 1000, VOCAB, seed=3)
  return str(d)


def _kw(**over):
  kw = dict(batch_size=128, numerical_features=13,
            categorical_features=[0, 1, 2], categorical_feature_sizes=VOCAB)
  kw.update(over)
  return kw


def _assert_batches_equal(a, b):
  assert len(a) == len(b)
  for (n1, c1, l1), (n2, c2, l2) in zip(a, b):
    if n1 is None:
      assert n2 is None
    else:
      assert n1.dtype == n2.dtype
      np.testing.assert_array_equal(n1, n2)
    assert l1.dtype == l2.dtype
    np.testing.assert_array_equal(l1, l2)
    assert len(c1) == len(c2)
    for x, y in zip(c1, c2):
      assert x.dtype == y.dtype
      np.testing.assert_array_equal(x, y)


def _all_three(data_dir, **kw):
  """The JAX reader's batches, and the port's on each backend."""
  want = list(jdata.RawBinaryCriteoDataset(data_dir, backend="numpy", **kw))
  for backend in ("native", "numpy"):
    got = list(tdata.RawBinaryCriteoDataset(data_dir, backend=backend, **kw))
    _assert_batches_equal(got, want)
  return want


def test_writer_gives_the_jax_files(tmp_path):
  tdata.write_dummy_criteo_split(str(tmp_path / "t"), 300, VOCAB, seed=9)
  jdata.write_dummy_criteo_split(str(tmp_path / "j"), 300, VOCAB, seed=9)
  for split in ("train", "test"):
    names = ["label.bin", "numerical.bin"] + [f"cat_{i}.bin"
                                               for i in range(len(VOCAB))]
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "t" / split, tmp_path / "j" / split, names, shallow=False)
    assert sorted(match) == sorted(names), (mismatch, errors)


def test_native_loader_builds_into_the_build_directory():
  lib = tcc.load_data_loader()
  assert lib is not None
  path = tcc.library_path()
  assert path.exists() and path.parent == tcc.BUILD_DIR
  assert path.parent.parent.name == "build"


def test_batches_match_jax(data_dir):
  want = _all_three(data_dir, **_kw())
  assert len(want) == 1000 // 128


@pytest.mark.parametrize("rank", range(4))
def test_dp_slicing_matches_jax(data_dir, rank):
  _all_three(data_dir, rank=rank, world_size=4, **_kw())


def test_feature_subset_matches_jax(data_dir):
  want = _all_three(data_dir, **_kw(categorical_features=[2, 0]))
  assert want[0][1][0].dtype == np.int32


def test_no_numerical_features_match_jax(data_dir):
  want = _all_three(data_dir, **_kw(numerical_features=0))
  assert want[0][0] is None


def test_valid_split_matches_jax(data_dir):
  _all_three(data_dir, valid=True, **_kw())


def test_trailing_partial_batch_matches_jax(data_dir):
  want = _all_three(data_dir, **_kw(drop_last_batch=False))
  assert want[-1][2].shape[0] == 1000 % 128


@pytest.mark.parametrize("rank", (0, 1))
def test_empty_rank_slice_matches_jax(data_dir, rank):
  # 1000 samples, batch 384, world 2, no drop: the second global batch
  # leaves rank 1 an empty slice, yielded as a zero-length batch
  want = _all_three(data_dir, rank=rank, world_size=2,
                    **_kw(batch_size=384, drop_last_batch=False))
  assert len(want) == 2
  if rank == 1:
    assert want[-1][2].shape[0] == 0


def test_indexing_and_auto_backend_match_jax(data_dir):
  kw = _kw(rank=1, world_size=2, batch_size=96, drop_last_batch=False)
  j = jdata.RawBinaryCriteoDataset(data_dir, **kw)
  t = tdata.RawBinaryCriteoDataset(data_dir, **kw)
  assert len(t) == len(j)
  _assert_batches_equal([t[i] for i in range(len(t))],
                        [j[i] for i in range(len(j))])
  _assert_batches_equal(list(t), [j[i] for i in range(len(j))])
  with pytest.raises(IndexError):
    t[len(t)]
  with pytest.raises(ValueError, match="backend"):
    tdata.RawBinaryCriteoDataset(data_dir, batch_size=8, backend="mmap")


def test_size_mismatch_raises(tmp_path):
  tdata.write_dummy_criteo_split(str(tmp_path), 32, [100])
  p = tmp_path / "train" / "cat_0.bin"
  p.write_bytes(p.read_bytes()[:-8])
  with pytest.raises(ValueError, match="cat_0.bin"):
    tdata.RawBinaryCriteoDataset(str(tmp_path), batch_size=8,
                                 categorical_features=[0],
                                 categorical_feature_sizes=[100])
