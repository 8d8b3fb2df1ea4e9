"""The native host library through the port's own loader
(utils/native_lib.py): ``libemtpu`` built from ``native/emtpu.cpp`` with
the host's C++ compiler into ``build/torch_native/``, its ABI, and the CSV
and container fast paths against the Python paths and the JAX package's.

The JAX package's ``tests/test_native.py`` cases (ABI: version, file
round trip, atomic write, missing file, malformed CSV; parse parity,
``read_csv``'s fast path, trailing separators, strictness, the header
after a blank line; the EMT1 round trip through native IO), then the
loader's fallbacks: no compiler takes the Python path, a library that
cannot be loaded logs a warning.
"""

from __future__ import annotations

import logging
import pathlib
import shutil

import numpy as np
import pytest
import torch

from euromillioner_tpu_torch.data import csvio
from euromillioner_tpu_torch.utils import native_lib as nl
from euromillioner_tpu_torch.utils import serialization

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "euromillions.html"


@pytest.fixture(scope="module")
def native_lib():
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    # a fresh load (an earlier test may have memoized another outcome)
    nl._searched = False
    nl._lib = None
    lib = nl.get()
    assert lib is not None, "libemtpu built but failed to load"
    return lib


@pytest.fixture
def fresh_loader(monkeypatch):
    """The loader's memo reset for this test and restored after it."""
    monkeypatch.setattr(nl, "_searched", False)
    monkeypatch.setattr(nl, "_lib", None)


class TestABI:
    def test_version(self, native_lib):
        assert native_lib.version().startswith("emtpu")
        assert nl.available()
        # built from the checkout's source into build/torch_native/
        assert any(nl.BUILD_DIR.glob("libemtpu-*.so"))

    def test_file_roundtrip(self, native_lib, tmp_path):
        p = str(tmp_path / "blob.bin")
        payload = bytes(range(256)) * 100
        native_lib.write_file(p, payload)
        assert native_lib.read_file(p) == payload

    def test_write_is_atomic_no_tmp_left(self, native_lib, tmp_path):
        p = str(tmp_path / "x.bin")
        native_lib.write_file(p, b"data")
        assert not (tmp_path / "x.bin.tmp").exists()

    def test_read_missing_file_raises(self, native_lib):
        with pytest.raises(OSError):
            native_lib.read_file("/nonexistent/nowhere.bin")

    def test_parse_csv_malformed_raises(self, native_lib):
        with pytest.raises(ValueError):
            native_lib.parse_csv(b"a,b\n1,oops\n", True)


def _python_read(path, **kw):
    """``read_csv`` on its Python path (the native parse disabled)."""
    real = nl.get
    nl.get = lambda: None
    try:
        return csvio.read_csv(path, **kw)
    finally:
        nl.get = real


class TestParseParity:
    def test_matches_python_parser(self, native_lib, tmp_path):
        """2000 x 11 float32 values written as ``repr`` of their float64
        value: the native parse is bit-equal to the Python parse and to
        the values."""
        rng = np.random.default_rng(0)
        data = rng.normal(size=(2000, 11)).astype(np.float32)
        path = str(tmp_path / "big.csv")
        header = ",".join(f"c{i}" for i in range(11))
        with open(path, "w") as fh:
            fh.write(header + "\n")
            for row in data:
                fh.write(",".join(repr(float(v)) for v in row) + "\n")
        native = native_lib.parse_csv(open(path, "rb").read(), True)
        assert native.tobytes() == data.tobytes()
        py, _, names = _python_read(path, label_column=None)
        assert native.tobytes() == py.tobytes()
        assert names == header.split(",")

    def test_read_csv_uses_fast_path(self, native_lib, tmp_path,
                                     monkeypatch):
        """``read_csv`` takes the native parse (its result is what the
        library returns) and splits the label as the Python path does;
        the golden page's featurized CSV reads bit-equal both ways."""
        rows = [[1, 10.5, 100], [0, 20.25, 200], [1, 30, 300]]
        path = str(tmp_path / "d.csv")
        csvio.write_csv(path, rows, header="label,a,b")
        calls = []
        parse = native_lib.parse_csv
        monkeypatch.setattr(native_lib, "parse_csv",
                            lambda *a: calls.append(a) or parse(*a))
        x, y, names = csvio.read_csv(path, label_column=0)
        assert len(calls) == 1
        np.testing.assert_array_equal(y, [1, 0, 1])
        np.testing.assert_allclose(x[:, 0], [10.5, 20.25, 30])
        assert names == ["a", "b"]
        from euromillioner_tpu_torch.config import DataConfig
        from euromillioner_tpu_torch.data.pipeline import draws_from_html

        golden = str(tmp_path / "golden.csv")
        csvio.write_csv(golden, draws_from_html(
            GOLDEN.read_text(encoding="utf-8"), DataConfig()))
        fast = csvio.read_csv(golden, label_column=0)
        slow = _python_read(golden, label_column=0)
        assert len(calls) == 2
        assert fast[0].tobytes() == slow[0].tobytes()
        assert fast[1].tobytes() == slow[1].tobytes()
        assert fast[2] == slow[2]

    def test_trailing_separators_and_spaces(self, native_lib):
        arr = native_lib.parse_csv(b"h1,h2\n 1 , 2 ,\n3,4,\r\n", True)
        np.testing.assert_allclose(arr, [[1, 2], [3, 4]])

    def test_strictness_matches_python(self, native_lib, tmp_path):
        """Inputs the Python parser rejects fail natively too, and
        ``read_csv`` then falls back to the Python parse's error."""
        from euromillioner_tpu_torch.utils.errors import DataError

        for bad in (b"h1,h2\n1 2\n",      # space-separated values
                    b"h1,h2\n0x10,2\n",   # strtof hex extension
                    b"h1,h2\n1,,2\n"):    # empty interior cell
            with pytest.raises(ValueError):
                native_lib.parse_csv(bad, True)
            path = tmp_path / "bad.csv"
            path.write_bytes(bad)
            with pytest.raises(DataError):
                csvio.read_csv(str(path), label_column=0)

    def test_header_after_blank_line(self, native_lib, tmp_path):
        from euromillioner_tpu.data.csvio import read_csv as jax_read_csv

        path = str(tmp_path / "b.csv")
        open(path, "w").write("\na,b,c\n1,2,3\n")
        x, y, names = csvio.read_csv(path, label_column=0)
        assert names == ["b", "c"]
        np.testing.assert_allclose(x, [[2, 3]])
        jx, jy, jnames = jax_read_csv(path, label_column=0)
        assert names == jnames
        assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()


class TestSerializationNativePath:
    def test_emt1_roundtrip_through_native_io(self, native_lib, tmp_path,
                                              monkeypatch):
        """EMT1 save/load through the library's IO: the same values back,
        the file byte-equal to the Python writer's and readable by the
        JAX package."""
        from euromillioner_tpu.utils import serialization as jax_ser

        writes = []
        write = native_lib.write_file
        monkeypatch.setattr(native_lib, "write_file",
                            lambda p, d: writes.append(p) or write(p, d))
        arrays = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                  "step": np.int32(7),
                  "mask": np.array([True, False])}
        p = str(tmp_path / "ckpt.emt")
        serialization.save(p, arrays)
        assert writes == [p]
        out = serialization.load(p)
        assert set(out) == set(arrays)
        np.testing.assert_array_equal(out["w"].numpy(), arrays["w"])
        assert int(out["step"]) == 7
        np.testing.assert_array_equal(out["mask"].numpy(), arrays["mask"])
        assert pathlib.Path(p).read_bytes() == serialization.dumps(arrays)
        np.testing.assert_array_equal(jax_ser.load(p)["w"], arrays["w"])


class TestLoaderFallbacks:
    def test_missing_compiler_takes_the_python_path(self, fresh_loader,
                                                    monkeypatch, tmp_path,
                                                    caplog):
        """No compiler: no library, no error; ``read_csv`` and the
        container read through Python, with the same results."""
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
        with caplog.at_level(logging.INFO, logger="euromillioner_tpu_torch"):
            assert nl.get() is None
        assert not nl.available()
        assert any("no C++ compiler" in r.message for r in caplog.records)
        path = str(tmp_path / "d.csv")
        csvio.write_csv(path, [[1, 2.5], [0, 3.25]], header="y,a")
        x, y, names = csvio.read_csv(path, label_column=0)
        np.testing.assert_array_equal(y, [1, 0])
        np.testing.assert_array_equal(x[:, 0], [2.5, 3.25])
        assert names == ["a"]
        p = str(tmp_path / "c.emt")
        serialization.save(p, {"a": np.ones(3, np.float32)})
        np.testing.assert_array_equal(serialization.load(p)["a"].numpy(),
                                      np.ones(3, np.float32))

    def test_unloadable_library_logs_a_warning(self, fresh_loader,
                                               monkeypatch, tmp_path,
                                               caplog):
        """A built library that cannot be loaded is disabled with a
        warning naming it, never silently; the Python paths serve."""
        bad = tmp_path / "libemtpu-broken.so"
        bad.write_bytes(b"not an ELF shared object")
        monkeypatch.setattr(nl, "build", lambda: bad)
        with caplog.at_level(logging.WARNING,
                             logger="euromillioner_tpu_torch"):
            assert nl.get() is None
        warned = [r for r in caplog.records if r.levelno == logging.WARNING]
        assert any("present but unusable" in r.message
                   and str(bad) in r.message for r in warned)
        path = str(tmp_path / "d.csv")
        csvio.write_csv(path, [[1, 2.5]], header="y,a")
        assert csvio.read_csv(path, label_column=0)[1].tolist() == [1.0]
