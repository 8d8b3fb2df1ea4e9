"""The port's ETL (euromillioner_tpu_torch/data/) against the JAX package's
on the golden results page: the same rows, splits, windows, batches and
masks, bit for bit."""

import pathlib

import numpy as np
import pytest

from euromillioner_tpu.config import DataConfig as JaxDataConfig
from euromillioner_tpu.data import csvio as jax_csvio
from euromillioner_tpu.data import dataset as jax_dataset
from euromillioner_tpu.data import pipeline as jax_pipeline
from euromillioner_tpu.models.lstm import make_sequences as jax_make_sequences
from euromillioner_tpu_torch.config import DataConfig
from euromillioner_tpu_torch.data import csvio, dataset, pipeline
from euromillioner_tpu_torch.models.lstm import make_sequences
from euromillioner_tpu_torch.utils.errors import DataError, ParseError

GOLDEN = pathlib.Path(__file__).parent / "golden" / "euromillions.html"


@pytest.fixture(scope="module")
def html():
    return GOLDEN.read_text()


@pytest.fixture(scope="module")
def splits(html):
    return (pipeline.pipeline_from_html(html),
            jax_pipeline.pipeline_from_html(html))


def test_config_defaults_match_jax():
    mine, theirs = DataConfig(), JaxDataConfig()
    for name in ("table_class", "date_format", "train_percent",
                 "label_column", "batch_size", "shuffle"):
        assert getattr(mine, name) == getattr(theirs, name), name


def test_draws_from_html_bit_equal(html):
    rows = pipeline.draws_from_html(html)
    want = jax_pipeline.draws_from_html(html)
    assert len(rows) == 1705 and len(rows[0]) == 11
    assert rows == want


def test_pipeline_split_bit_equal(splits):
    (tr, va), (jtr, jva) = splits
    assert (len(tr), len(va)) == (1193, 512)
    assert tr.num_features == va.num_features == 10
    for mine, theirs in ((tr, jtr), (va, jva)):
        assert mine.x.dtype == theirs.x.dtype == np.float32
        np.testing.assert_array_equal(mine.x, theirs.x)
        np.testing.assert_array_equal(mine.y, theirs.y)
        np.testing.assert_array_equal(mine.full_rows(), theirs.full_rows())
        assert mine.feature_names == theirs.feature_names


@pytest.mark.parametrize("seq_len", [8, 64])
def test_windows_bit_equal(splits, seq_len):
    (tr, _), (jtr, _) = splits
    x, y = make_sequences(tr.full_rows(), seq_len)
    jx, jy = jax_make_sequences(jtr.full_rows(), seq_len)
    assert x.shape == (1193 - seq_len, seq_len, 11) and y.shape[1] == 7
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("shuffle,drop", [(False, False), (True, False),
                                          (False, True)])
def test_batches_padding_and_masks_bit_equal(splits, shuffle, drop):
    """1129 windows at B=64: 17 full batches and one of 41 rows padded
    with copies of row 0 under mask 0 — every batch keeps B=64."""
    (tr, _), (jtr, _) = splits
    x, y = make_sequences(tr.full_rows(), 64)
    mine = dataset.Dataset(x=x, y=y).batches(64, shuffle=shuffle, seed=5,
                                              drop_remainder=drop)
    theirs = jax_dataset.Dataset(x=x, y=y).batches(
        64, shuffle=shuffle, seed=5, drop_remainder=drop)
    mine, theirs = list(mine), list(theirs)
    assert len(mine) == len(theirs) == (17 if drop else 18)
    for b, jb in zip(mine, theirs):
        assert b.x.shape == (64, 64, 11)
        for name in ("x", "y", "mask"):
            np.testing.assert_array_equal(getattr(b, name),
                                          np.asarray(getattr(jb, name)))
    if not drop:
        last = mine[-1]
        assert last.mask.sum() == 1129 - 17 * 64
        np.testing.assert_array_equal(last.x[41:],
                                      np.broadcast_to(x[0], (23, 64, 11)))


def test_chronological_split_and_errors():
    ds = dataset.Dataset(x=np.arange(20, dtype=np.float32).reshape(10, 2),
                         y=np.arange(10, dtype=np.float32))
    tr, va = dataset.chronological_split(ds, 70)
    jtr, jva = jax_dataset.chronological_split(
        jax_dataset.Dataset(x=ds.x, y=ds.y), 70)
    np.testing.assert_array_equal(tr.x, jtr.x)
    np.testing.assert_array_equal(va.y, jva.y)
    with pytest.raises(DataError):
        dataset.chronological_split(ds, 0)
    with pytest.raises(DataError):
        dataset.Dataset(x=np.zeros((3, 2)), y=np.zeros(4))


def test_csv_round_trip_reads_like_jax(html, tmp_path):
    rows = pipeline.draws_from_html(html)
    path = str(tmp_path / "draws.csv")
    csvio.write_csv(path, rows)
    theirs = str(tmp_path / "jax.csv")
    jax_csvio.write_csv(theirs, rows)
    assert open(path).read() == open(theirs).read()
    x, y, names = csvio.read_csv(path)
    jx, jy, jnames = jax_csvio.read_csv(path)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert names == jnames
    ds = dataset.Dataset.from_csv(path)
    np.testing.assert_array_equal(ds.full_rows(), np.asarray(rows, np.float32))


def test_parse_errors():
    with pytest.raises(ParseError):
        pipeline.draws_from_html("<html><body>no table</body></html>")
