"""The port's framework-free copies against the JAX package's originals, and
the port's independence from JAX."""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from recommender_system_tpu.utils import datasets as jdatasets
from recommender_system_tpu.utils import features as jfeatures
from recommender_system_tpu.utils import hashing as jhashing
from recommender_system_tpu_torch.utils import datasets as tdatasets
from recommender_system_tpu_torch.utils import features as tfeatures
from recommender_system_tpu_torch.utils import hashing as thashing

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "recommender_system_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "recommender_system_tpu"}


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        f"for name in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[name] = None\n"
        "import recommender_system_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 12


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in [*PACKAGE.rglob("*.py"), *ROOT.glob("chip_*.py")]))
def test_no_jax_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def _columns(mod):
    return [
        mod.SparseFeat("a", 100, "auto"),
        mod.SparseFeat("b", 50, 8, use_hash=True, embedding_name="shared",
                       group_name="g", trainable=False, init_std=0.1),
        mod.VarLenSparseFeat(mod.SparseFeat("h", 50, 8, embedding_name="shared"),
                             maxlen=5, combiner="sum", length_name="h_len",
                             weight_name="h_w", weight_norm=False),
        mod.DenseFeat("d", 3),
    ]


def test_features_match():
    jcols, tcols = _columns(jfeatures), _columns(tfeatures)
    for j, t in zip(jcols, tcols):
        assert type(j).__name__ == type(t).__name__
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert getattr(j, "maxlen", None) == getattr(t, "maxlen", None)
    assert ([[c.name for c in part] for part in jfeatures.split_columns(jcols)]
            == [[c.name for c in part] for part in tfeatures.split_columns(tcols)])
    assert jfeatures.get_feature_names(jcols) == tfeatures.get_feature_names(tcols)
    assert jfeatures.batch_spec(jcols, 7) == tfeatures.batch_spec(tcols, 7)
    for v in (1, 10, 1000, 10 ** 6):
        assert jfeatures.auto_embedding_dim(v) == tfeatures.auto_embedding_dim(v)


def test_synthetic_criteo_and_columns_match():
    jcols, jX, jy = jdatasets.synthetic_criteo(n_rows=37, n_dense=3, n_sparse=5,
                                               vocab=50, embedding_dim=4, seed=3)
    tcols, tX, ty = tdatasets.synthetic_criteo(n_rows=37, n_dense=3, n_sparse=5,
                                               vocab=50, embedding_dim=4, seed=3)
    assert [dataclasses.asdict(c) for c in jcols] == [dataclasses.asdict(c) for c in tcols]
    assert list(jX) == list(tX)
    for k in jX:
        assert jX[k].dtype == tX[k].dtype
        np.testing.assert_array_equal(jX[k], tX[k])
    np.testing.assert_array_equal(jy, ty)
    assert ([dataclasses.asdict(c) for c in jdatasets.criteo_columns(8, 1000)]
            == [dataclasses.asdict(c) for c in tdatasets.criteo_columns(8, 1000)])


@pytest.mark.parametrize("shuffle,drop_remainder", [(True, True), (False, False)])
def test_iter_batches_match(shuffle, drop_remainder):
    _, X, y = jdatasets.synthetic_criteo(n_rows=37, n_dense=3, n_sparse=5, vocab=50)
    jb = list(jdatasets.iter_batches(X, y, 8, shuffle=shuffle, seed=4,
                                     drop_remainder=drop_remainder))
    tb = list(tdatasets.iter_batches(X, y, 8, shuffle=shuffle, seed=4,
                                     drop_remainder=drop_remainder))
    assert len(jb) == len(tb) == (4 if drop_remainder else 5)
    for (jx, jyb), (tx, tyb) in zip(jb, tb):
        np.testing.assert_array_equal(jyb, tyb)
        for k in jx:
            np.testing.assert_array_equal(jx[k], tx[k])


@pytest.mark.parametrize("n", [1, 37, 64])
def test_pad_to_batch_match(n):
    _, X, y = jdatasets.synthetic_criteo(n_rows=n, n_dense=3, n_sparse=5, vocab=50)
    jX, jy, jm = jdatasets.pad_to_batch(X, y, 32)
    tX, ty, tm = tdatasets.pad_to_batch(X, y, 32)
    np.testing.assert_array_equal(jy, ty)
    np.testing.assert_array_equal(jm, tm)
    for k in jX:
        np.testing.assert_array_equal(jX[k], tX[k])


def _hash_inputs():
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 2, -2 ** 31 + 1,
                     12345, -12345], np.int32)
    return np.concatenate([edge, rng.integers(-2 ** 31, 2 ** 31 - 1, 2000,
                                              dtype=np.int64).astype(np.int32)])


@pytest.mark.parametrize("num_buckets", [2, 50, 1000, 1 << 20, 2 ** 31 - 1])
@pytest.mark.parametrize("mask_zero", [False, True])
def test_hash_ids_bit_exact(num_buckets, mask_zero):
    ids = _hash_inputs()
    want = np.asarray(jhashing.hash_ids(jnp.asarray(ids), num_buckets, mask_zero))
    got = thashing.hash_ids(torch.from_numpy(ids), num_buckets, mask_zero)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mask_zero,salt", [(False, 0), (True, 0), (True, 7)])
def test_hash_strings_np_bit_exact(mask_zero, salt):
    values = ["", None, float("nan"), "a", "68fd1e64", b"\x00\xffbytes",
              "long-token-" * 5, 12345, "é"]
    np.testing.assert_array_equal(
        thashing.hash_strings_np(values, 1000, mask_zero, salt),
        jhashing.hash_strings_np(values, 1000, mask_zero, salt))


def test_seed_everything_defaults_to_the_card():
    """``seed_everything`` returns a generator on the card unless another
    device is named, and raises without one, as ``Trainer`` does; the
    generator it returns draws on its device from the seed, and numpy's
    global generator is seeded too."""
    from recommender_system_tpu_torch.utils.logging import seed_everything

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            seed_everything(7)
    gen = seed_everything(7, device="cpu")
    assert gen.device == torch.device("cpu")
    assert np.random.random() == np.random.RandomState(7).random_sample()
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=torch.Generator().manual_seed(7)))
