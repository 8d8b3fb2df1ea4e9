"""The native runner (euromillioner_tpu_torch/core/native_runner.py,
csrc/aoti_runner.cpp, csrc/emtpu_ops.cpp, csrc/plans.h) on the CPU: the
counterpart of the JAX package's ``tests/test_pjrt.py``.

Tier-1, fast (nothing compiled but a small torch-free probe of
``plans.h``):

- ``plans.h`` gives the Python wrappers' launch plans — K1's
  (``ops/fused_lstm.lstm_plan``, ``MAX_HIDDEN``) at B in {1, 8, 16, 32,
  128, 2048}, every H from 8 to past ``MAX_HIDDEN``, T in {1, 64}, both
  dtypes; K4a's (``ops/wide_onehot.fwd_plan`` and ``_vec``) at the
  Wide&Deep shapes, both dtypes, aligned and misaligned tables;
- the C++ schemas are the ones the Python custom ops infer;
- the ABI guard, and :class:`NativeRunnerError` (exit 16) when the runner
  cannot be built, is stale, cannot start, goes silent or reports an
  error, and when a package's device is not the runner's.

Marked ``slow`` (an AOTInductor compile takes 20-60 s on the CPU): the
runner built with g++ here runs exported packages of the MLP, of Wide&Deep
(``emtpu::wide_onehot_fwd`` served by the runner's C++ registration) and
of an LSTM built with ``fused="on"`` (``emtpu::lstm_sequence``), each
against ``run_torch`` at rtol 1e-5 / atol 1e-6, with the runner's own
counts of each op's calls matching the batches, and a second runner on the
same export compiling nothing:
``python -m pytest -m slow tests/test_torch_native_runner.py``.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import stat
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import euromillioner_tpu_torch.ops  # noqa: F401 — registers the ops
from euromillioner_tpu_torch.cli import main as port_main
from euromillioner_tpu_torch.core import export as ex
from euromillioner_tpu_torch.core import native_runner as nr
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.models.mlp import build_mlp
from euromillioner_tpu_torch.models.wide_deep import build_wide_deep
from euromillioner_tpu_torch.ops import fused_lstm, wide_onehot

torch.set_num_threads(2)

CSRC = pathlib.Path(nr.CSRC)
GOLDEN = str(pathlib.Path(__file__).parent / "golden" / "euromillions.html")
RTOL, ATOL = 1e-5, 1e-6

# A torch-free probe of plans.h: one query a line on stdin, one answer a
# line on stdout.
PROBE = r"""
#include <cstdio>
#include <cstring>
#include "plans.h"
int main() {
  char what[16];
  while (std::scanf("%15s", what) == 1) {
    if (!std::strcmp(what, "lstm")) {
      int bf16, b, h;
      std::scanf("%d %d %d", &bf16, &b, &h);
      const auto p = emtpu::lstm_plan(bf16, b, h);
      if (!p.ok) { std::puts("none"); continue; }
      std::printf("%d %d %d %d %d %d %d %d %d %d %d\n", p.cluster, p.rows,
                  p.units, p.k_pad, (int)p.resident, p.ktile, p.slots,
                  p.splits, p.threads, p.smem, p.tiles);
    } else if (!std::strcmp(what, "maxh")) {
      std::printf("%d\n", emtpu::lstm_max_hidden());
    } else if (!std::strcmp(what, "vec")) {
      long long e, addr; int itemsize;
      std::scanf("%lld %d %lld", &e, &itemsize, &addr);
      std::printf("%d\n", emtpu::onehot_vec(e, itemsize, addr));
    } else if (!std::strcmp(what, "onehot")) {
      int itemsize, vec; long long b, e;
      std::scanf("%d %lld %lld %d", &itemsize, &b, &e, &vec);
      const auto p = emtpu::onehot_fwd_plan(itemsize, b, e, vec);
      if (!p.ok) { std::puts("none"); continue; }
      std::printf("%d %d %d %d %d\n", p.vec, p.rows, p.group, p.threads,
                  p.blocks);
    }
  }
}
"""

LSTM_BATCHES = (1, 8, 16, 32, 128, 2048)
LSTM_STEPS = (1, 64)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# Wide&Deep's K4a calls: (B, K, V, E) of the 100M model's pair slab and of
# the small widths the tests and tiers use, at the serving buckets and
# bench.py's training batch
WD_BATCHES = (1, 8, 16, 32, 128, 2048, 8192)
WD_SHAPES = ((21, 4096, 1040), (21, 4096, 1024), (21, 256, 8), (5, 3, 20),
             (21, 4096, 7), (21, 1024, 12))


class _Ptr:
    """A stand-in tensor for ``_vec``: only its address is read."""

    def __init__(self, addr: int):
        self.addr = addr

    def data_ptr(self) -> int:
        return self.addr


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if cxx is None:
        pytest.skip("no C++ compiler")
    d = tmp_path_factory.mktemp("probe")
    (d / "probe.cpp").write_text(PROBE)
    exe = d / "probe"
    subprocess.run([cxx, "-std=c++17", "-O1", f"-I{CSRC}", "-o", str(exe),
                    str(d / "probe.cpp")], check=True, timeout=120)

    def ask(queries: list[str]) -> list[str]:
        done = subprocess.run([str(exe)], input="\n".join(queries) + "\n",
                              capture_output=True, text=True, check=True,
                              timeout=120)
        return done.stdout.splitlines()
    return ask


def _lstm_line(plan) -> str:
    if plan is None:
        return "none"
    return " ".join(str(int(v)) for v in (
        plan.cluster, plan.rows, plan.units, plan.k_pad, plan.resident,
        plan.ktile, plan.slots, plan.splits, plan.threads, plan.smem,
        plan.tiles))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k1_plans_match_python(probe, dtype):
    dt = DTYPES[dtype]
    hidden = range(8, fused_lstm.MAX_HIDDEN + 65)
    cases = [(b, h, t) for b in LSTM_BATCHES for h in hidden
             for t in LSTM_STEPS]
    got = probe([f"lstm {int(dt == torch.bfloat16)} {b} {h}"
                 for b, h, _t in cases])
    want = [_lstm_line(fused_lstm.lstm_plan(dt, b, h, t))
            for b, h, t in cases]
    assert len(got) == len(want)
    bad = [(c, g, w) for c, g, w in zip(cases, got, want) if g != w]
    assert not bad, f"{len(bad)} plans differ, first {bad[:3]}"


def test_k1_max_hidden_matches_python(probe):
    assert probe(["maxh"]) == [str(fused_lstm.MAX_HIDDEN)]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k4a_plans_match_python(probe, dtype):
    dt = DTYPES[dtype]
    size = torch.empty((), dtype=dt).element_size()
    cases, queries, want = [], [], []
    for b in WD_BATCHES:
        for k, v, e in WD_SHAPES:
            # an aligned table, and views 2, 4 and 8 bytes off
            for off in (0, 2, 4, 8):
                addr = 4096 + off
                vec = wide_onehot._vec(e, size, _Ptr(addr))
                cases.append((b, k, v, e, off))
                queries.append(f"vec {e} {size} {addr}")
                queries.append(f"onehot {size} {b} {e} {vec}")
                p = wide_onehot.fwd_plan(dt, b, k, v, e, vec)
                want += [str(vec), f"{p.vec} {p.rows} {p.group} {p.threads} "
                         f"{p.blocks}"]
    got = probe(queries)
    assert len(got) == len(want)
    bad = [(cases[i // 2], g, w) for i, (g, w) in enumerate(zip(got, want))
           if g != w]
    assert not bad, f"{len(bad)} answers differ, first {bad[:3]}"


def _defs(source: str) -> list[str]:
    return re.findall(r'm\.def\("([^"]+)"\)', (CSRC / source).read_text())


def test_cpp_schemas_are_the_python_ops():
    defs = {d.split("(")[0]: d for d in _defs("emtpu_ops.cpp")}
    assert sorted(defs) == ["lstm_sequence", "wide_onehot_fwd"]
    for name, schema in defs.items():
        assert f"emtpu::{schema}" == str(
            getattr(torch.ops.emtpu, name).default._schema)


def test_abi_versions_agree():
    cpp = (CSRC / "aoti_runner.cpp").read_text()
    m = re.search(r"kAbiVersion = (\d+);", cpp)
    assert m and int(m.group(1)) == nr._ABI_VERSION


# -- errors: each a NativeRunnerError, exit 16 --------------------------------

def _package(path: pathlib.Path, device: str) -> pathlib.Path:
    """A zip holding only an AOTInductor package's metadata."""
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("program/data/aotinductor/model/x.wrapper_metadata.json",
                   json.dumps({"AOTI_DEVICE_KEY": device}))
    return path


def _fake_runner(path: pathlib.Path, abi: int, body: str) -> pathlib.Path:
    """A stand-in executable: ``--abi-version`` prints ``abi``; otherwise
    it runs ``body`` (Python, ``out`` the binary stdout)."""
    path.write_text(
        f"#!{sys.executable}\nimport sys, struct, time\n"
        f"if sys.argv[1:] == ['--abi-version']:\n    print({abi}); sys.exit(0)\n"
        f"out = sys.stdout.buffer\n{body}\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return path


def test_cannot_build(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(nr.NativeRunnerError, match="no C\\+\\+ compiler") as e:
        nr.ensure_built(tmp_path / "build")
    assert e.value.exit_code == 16
    monkeypatch.setenv("CXX", shutil.which("false") or "/bin/false")
    with pytest.raises(nr.NativeRunnerError, match="building .* failed"):
        nr.ensure_built(tmp_path / "build")
    assert not list((tmp_path / "build").glob(f"{nr.NAME}-*"))


def test_stale_runner_is_refused(tmp_path):
    pkg = _package(tmp_path / "p.pt2", "cpu")
    for abi in (0, nr._ABI_VERSION + 1):
        exe = _fake_runner(tmp_path / f"r{abi}", abi, "sys.exit(0)")
        with pytest.raises(nr.NativeRunnerError, match="stale build"):
            nr.NativeRunner(pkg, "cpu", runner=exe)


def test_package_for_another_device_is_refused_by_name(tmp_path):
    exe = _fake_runner(tmp_path / "r", nr._ABI_VERSION, "sys.exit(3)")
    with pytest.raises(nr.NativeRunnerError,
                       match="compiled for cuda; it cannot run on cpu"):
        nr.NativeRunner(_package(tmp_path / "p.pt2", "cuda"), "cpu",
                        runner=exe)
    (tmp_path / "junk.pt2").write_bytes(b"not a zip")
    with pytest.raises(nr.NativeRunnerError, match="not an AOTInductor"):
        nr.NativeRunner(tmp_path / "junk.pt2", "cpu", runner=exe)


def test_runner_that_dies_or_stalls_is_reaped(tmp_path):
    pkg = _package(tmp_path / "p.pt2", "cpu")
    dies = _fake_runner(tmp_path / "dies", nr._ABI_VERSION,
                        "sys.stderr.write('cannot load it'); sys.exit(1)")
    with pytest.raises(nr.NativeRunnerError,
                       match="exited \\(exit code 1\\):\n.*cannot load it"):
        nr.NativeRunner(pkg, "cpu", runner=dies)
    stalls = _fake_runner(tmp_path / "stalls", nr._ABI_VERSION,
                          "time.sleep(60)")
    with pytest.raises(nr.NativeRunnerError, match="no reply within"):
        nr.NativeRunner(pkg, "cpu", runner=stalls, timeout_s=0.5)


def test_errors_the_runner_reports_are_raised(tmp_path):
    """A load the runner refuses ends the child; a refused execute is an
    error for that request and the runner goes on serving."""
    pkg = _package(tmp_path / "p.pt2", "cpu")
    msg = b"no kernel library for fused_lstm.cu was loaded"
    refuses = _fake_runner(
        tmp_path / "refuses", nr._ABI_VERSION,
        f"out.write(struct.pack('<IIII', {nr._MAGIC}, {nr._ABI_VERSION}, 1, "
        f"{len(msg)}) + {msg!r}); out.flush()")
    with pytest.raises(nr.NativeRunnerError, match=msg.decode()):
        nr.NativeRunner(pkg, "cpu", runner=refuses)
    serves = _fake_runner(tmp_path / "serves", nr._ABI_VERSION, f"""
def s(b): return struct.pack('<I', len(b)) + b
out.write(struct.pack('<III', {nr._MAGIC}, {nr._ABI_VERSION}, 0)
          + struct.pack('<d', 1.5) + s(b'out'))
out.flush()
while sys.stdin.buffer.read(4):
    n, = struct.unpack('<I', sys.stdin.buffer.read(4))
    for _ in range(n):
        code, nd = struct.unpack('<iI', sys.stdin.buffer.read(8))
        dims = struct.unpack(f'<{{nd}}q', sys.stdin.buffer.read(8 * nd))
        sys.stdin.buffer.read(4 * (dims[0] if dims else 1))
    out.write(struct.pack('<I', 1) + s(b'launch failed: CUDA error 9'))
    out.flush()
""")
    with nr.NativeRunner(pkg, "cpu", runner=serves) as rt:
        assert rt.load_ms == 1.5
        for _ in range(2):
            with pytest.raises(nr.NativeRunnerError,
                               match="execute failed: launch failed"):
                rt.execute([np.zeros(3, np.float32)])
        with pytest.raises(nr.NativeRunnerError, match="float32/int32"):
            rt.execute([np.zeros(3, np.float64)])
        proc = rt._proc
    assert rt._proc is None and proc.returncode == 0


# -- slow: the real runner on exported packages -------------------------------

@pytest.fixture(scope="module")
def runner():
    try:
        exe = nr.ensure_built()
    except nr.NativeRunnerError as e:
        pytest.skip(f"the runner cannot be built here: {e}")
    return exe


def _served(out: str, xs: list[np.ndarray]):
    """``xs`` through the native runtime (one runner) and the torch one:
    (native replies, torch replies, the runner's stats, compile seconds)."""
    with ex.ExportedRunner(out, "native", "cpu") as run:
        got = [run(x)[0] for x in xs]
        stats = run.runner.stats()
        compile_s = run.compile_s
    with ex.ExportedRunner(out, "torch", "cpu") as run:
        want = [run(x)[0] for x in xs]
    return got, want, stats, compile_s


CASES = {
    "mlp": (lambda: build_mlp(hidden_sizes=(32, 32), out_dim=7,
                              in_features=11, device="cpu"),
            lambda rng: rng.normal(size=(16, 11)).astype(np.float32),
            torch.float32, {}),
    "wide_deep": (lambda: build_wide_deep(target_params=300_000, embed_dim=8,
                                          hidden_sizes=(16,), device="cpu",
                                          compute_dtype=torch.float32),
                  lambda rng: np.concatenate([
                      rng.integers(1, 8, (16, 4)),
                      rng.integers(1, 51, (16, 7))], 1).astype(np.float32),
                  torch.float32, {"wide_onehot_fwd": 1}),
    "lstm": (lambda: build_lstm(hidden=32, num_layers=2, fused="on",
                                device="cpu"),
             lambda rng: rng.normal(size=(4, 8, 11)).astype(np.float32),
             torch.float32, {"lstm_sequence": 2}),
}
BATCHES = 3


@pytest.fixture(scope="module")
def exported(runner, tmp_path_factory):
    """Each case exported to a directory of its own (built lazily)."""
    root = tmp_path_factory.mktemp("exported")
    made = {}

    def get(name):
        if name not in made:
            build, draw, dtype, _per = CASES[name]
            x = draw(np.random.default_rng(0))
            out = str(root / name)
            ex.export_model(ex.ModelForward(build(), dtype), (x,), out)
            made[name] = out
        return made[name]
    return get


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CASES))
def test_runner_serves_exported_package(name, exported):
    out = exported(name)
    rng = np.random.default_rng(1)
    xs = [CASES[name][1](rng) for _ in range(BATCHES)]
    got, want, stats, _s = _served(out, xs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # the runner's own counts: each op's C++ CPU implementation, once per
    # call a batch makes; no kernel on the CPU
    per = CASES[name][3]
    assert stats["executes"] == BATCHES
    assert stats["cpu_calls"] == {
        op: per.get(op, 0) * BATCHES
        for op in ("lstm_sequence", "wide_onehot_fwd")}
    assert stats["launches"] == {"lstm_sequence": 0, "wide_onehot_fwd": 0}


@pytest.mark.slow
def test_second_runner_compiles_nothing(exported):
    out = exported("lstm")
    with ex.ExportedRunner(out, "native", "cpu") as first:
        pass
    with ex.ExportedRunner(out, "native", "cpu") as second:
        assert second.compile_s is None
        assert second.package == first.package
    assert len(list((pathlib.Path(out) / "native").glob("*.pt2"))) == 1


@pytest.mark.slow
def test_runner_links_no_libpython(runner):
    ldd = subprocess.run(["ldd", str(runner)], capture_output=True,
                         text=True, timeout=60).stdout
    assert "libtorch_cpu" in ldd and "libpython" not in ldd


@pytest.mark.slow
def test_export_program_two_outputs(runner, tmp_path):
    """The reference's elementwise and matmul parity as one program with
    two outputs (:func:`export_program`, the ``export_stablehlo``
    analog)."""
    rng = np.random.default_rng(0)
    x = torch.linspace(-3, 3, 4 * 128).reshape(4, 128)
    w = torch.from_numpy(rng.normal(size=(128, 16)).astype(np.float32))

    def fn(a, b):
        return torch.tanh(a) * 2.0 + 1.0, a @ b

    payload, specs = nr.export_program(fn, x, w)
    assert specs == [[[4, 128], "float32"], [[4, 16], "float32"]]
    pkg = tmp_path / "p.pt2"
    pkg.write_bytes(payload)
    with nr.NativeRunner(pkg, "cpu") as rt:
        assert rt.num_outputs() == 2
        got = rt.execute([x.numpy(), w.numpy()])
    for g, want in zip(got, fn(x, w)):
        np.testing.assert_allclose(g, want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.slow
def test_cli_predict_native_matches_torch(runner, tmp_path, capsys):
    """``predict --model-type exported --runtime native`` through the CLI:
    one finite line a draw, at the f32 pin of ``--runtime torch``."""
    ck = str(tmp_path / "ck")
    assert port_main(["train", "--model", "mlp", "--html-file", GOLDEN,
                      "--device", "cpu", "--train.epochs=1",
                      "--model.hidden_sizes=8",
                      "--model.compute_dtype=float32", "--save", ck]) == 0
    out = str(tmp_path / "exported")
    assert port_main(["export", "--model", "mlp", "--checkpoint", ck,
                      "--output", out, "--batch", "32", "--device", "cpu",
                      "--model.hidden_sizes=8",
                      "--model.compute_dtype=float32"]) == 0
    csv = str(tmp_path / "rows.csv")
    assert port_main(["fetch", "--html-file", GOLDEN, "--output", csv]) == 0
    capsys.readouterr()
    lines = {}
    for runtime in ("native", "torch"):
        assert port_main(["predict", "--model-type", "exported",
                          "--model-file", out, "--csv", csv, "--has-label",
                          "--runtime", runtime, "--device", "cpu"]) == 0
        lines[runtime] = np.array(
            capsys.readouterr().out.strip().splitlines(), dtype=np.float32)
    assert len(lines["native"]) == 1705
    assert np.isfinite(lines["native"]).all()
    np.testing.assert_allclose(lines["native"], lines["torch"], rtol=RTOL,
                               atol=ATOL)
