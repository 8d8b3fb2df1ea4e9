#!/usr/bin/env python3
"""K4a's and K4b's times on one NVIDIA GPU, for the checkout of the port at
``--root`` (by default this one), so that two checkouts' kernels can be
compared one after another on one card:

    python3 k4_times.py --root OLD
    python3 k4_times.py

At each shape of ``--batches`` x (float32, bfloat16) at full width (21
pair tables of 4096 codes, E = 1040; chip_smoke.py's inputs: the pair
codes of bench.py's rows, a seeded table and cotangent) it measures, for
each kernel:

* ``call_ms``: CUDA events around one call of the wrapper, median of 20
  (chip_smoke.time_ms: the host's work before the launch is inside it);
* ``device_ms``: the kernel's launches alone, outputs and scratch made
  beforehand, captured ``--launches`` times in a CUDA graph and replayed
  between CUDA events, divided by the count (no host time);
* ``host_us``: the wrapper's host time per call over calls issued back to
  back without synchronising;
* for K4b, its parts apart, each as ``device_ms``: a checkout whose
  wrapper has ``dw_plan`` (the counting sort) has ``sort`` (count, scan,
  place) and ``write`` (the row writer); an earlier one ``zero`` (the
  wrapper's ``torch.zeros`` of the block), ``sort`` (its bitonic sort,
  launched alone through the C entry, which returns after it when handed
  a vector width it has no kernel for) and ``runs`` (the full call less
  the two);
* at B = 8192, ``flushed_ms``: ``device_ms`` of a 128 MB write and the
  launch, less that of the write alone (the L2 holds none of the table).

It prints one line per shape, then one JSON line with every number, the
bounds (chip_smoke.k4_bound_ms) and the card's name and power limit. It
needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def host_us(fn, calls: int = 200) -> float:
    """Microseconds of host time per call of ``fn`` issued back to back."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def raw_calls(cs, K, w, ids, dh, v: int) -> dict:
    """Zero-argument calls that launch the kernels alone on buffers made
    here: ``fwd``, ``dw`` and K4b's parts, for either wrapper (a wrapper
    with plans through chip_smoke.k4_raw_calls)."""
    import torch

    if hasattr(K, "dw_plan"):
        return cs.k4_raw_calls(w, ids, dh, v)
    # the earlier wrapper: no plan, K4b's block zeroed by torch.zeros
    b, k = ids.shape
    e = w.shape[2]
    out = torch.empty((b, e), dtype=torch.float32, device="cuda")
    dw = torch.empty((k, v, e), dtype=dh.dtype, device="cuda")
    code = K.DTYPE_CODES[w.dtype]
    dev = w.device.index
    calls = {}
    vec = K._vec(e, w.element_size(), w)
    fargs = (w.data_ptr(), ids.data_ptr(), out.data_ptr(), b, k, v, e, code,
             vec, dev)
    keys = torch.empty((k, b), dtype=torch.int32, device="cuda")
    dvec = K._vec(e, dh.element_size(), dh, dw)
    dargs = (ids.data_ptr(), dh.data_ptr(), dw.data_ptr(), keys.data_ptr(),
             b, k, v, e, code)
    fn = K.WIDE_ONEHOT_DW
    fn.build()

    def sort_only():
        # a vector width with no runs kernel (16 bytes / itemsize x 2):
        # the entry launches the sort, then returns cudaErrorInvalidValue
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn._fn(*dargs, 32 // dh.element_size(), dev, stream)

    calls["fwd"] = lambda: K.WIDE_ONEHOT_FWD.launch(*fargs)
    calls["zero"] = dw.zero_
    calls["sort"] = sort_only
    calls["sort_runs"] = lambda: fn.launch(*dargs, dvec, dev)
    calls["dw"] = lambda: (dw.zero_(), fn.launch(*dargs, dvec, dev))
    calls["_keep"] = (out, dw, keys)
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=None,
                    help="checkout whose euromillioner_tpu_torch to time")
    ap.add_argument("--batches", default="64,8192")
    ap.add_argument("--launches", type=int, default=50)
    args = ap.parse_args()
    here = Path(__file__).resolve().parent
    root = (args.root or here).resolve()
    if not (root / "euromillioner_tpu_torch").is_dir():
        print(f"k4_times: no euromillioner_tpu_torch/ under {root}",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("k4_times: no CUDA device is available", file=sys.stderr)
        return 1
    # chip_smoke's inputs and timers from this checkout; the port from --root
    sys.path.insert(0, str(here))
    import chip_smoke as cs

    for name in [m for m in sys.modules
                 if m.split(".")[0] == "euromillioner_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    import euromillioner_tpu_torch
    from euromillioner_tpu_torch.core.device import resolve_device
    from euromillioner_tpu_torch.ops import wide_onehot as K

    loaded = Path(euromillioner_tpu_torch.__file__).resolve().parents[1]
    if loaded != root:
        print(f"k4_times: imported the port from {loaded}, not {root}",
              file=sys.stderr)
        return 1
    resolve_device("cuda")
    K.WIDE_ONEHOT_FWD.build()
    K.WIDE_ONEHOT_DW.build()
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device="cuda")
    n = args.launches
    flush_ms = cs.device_ms(lambda: flush.fill_(1.0), n)
    results = {}
    for b in (int(x) for x in args.batches.split(",")):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            w, ids, dh = cs.k4_inputs(b, 21, 4096, 1040, dtype)
            v = w.shape[1]
            raw = raw_calls(cs, K, w, ids, dh, v)
            bounds = cs.k4_bound_ms(ids, w, dh)
            row = {}
            for kern, key, wrap in (
                    ("K4a", "fwd", lambda: K.wide_onehot_fwd(w, ids)),
                    ("K4b", "dw", lambda: K.wide_onehot_dw(ids, dh, v))):
                r = {"call_ms": cs.time_ms(wrap),
                     "device_ms": cs.device_ms(raw[key], n),
                     "host_us": host_us(wrap),
                     "bound_ms": max(bounds[key])}
                if b >= 8192:
                    r["flushed_ms"] = cs.device_ms(
                        lambda: (flush.fill_(1.0), raw[key]()), n) - flush_ms
                row[kern] = r
            parts = {p: cs.device_ms(raw[p], n)
                     for p in ("zero", "sort", "sort_runs", "write")
                     if p in raw}
            if "sort_runs" in parts:
                parts["runs"] = parts.pop("sort_runs") - parts["sort"]
            row["K4b"]["parts_ms"] = parts
            results[f"{b}x21x4096x1040 {name}"] = row
            for kern in ("K4a", "K4b"):
                r = row[kern]
                print(f"k4_times {kern} B={b} {name}: call {r['call_ms']:.4f}"
                      f" ms, device {r['device_ms']:.4f} ms, host "
                      f"{r['host_us']:.1f} us/call, bound {r['bound_ms']:.4f}"
                      f" ms" + (f", L2 flushed {r['flushed_ms']:.4f} ms"
                                if "flushed_ms" in r else "")
                      + (f"; parts {json.dumps(r['parts_ms'])}"
                         if "parts_ms" in r else ""))
            del w, ids, dh, raw
            torch.cuda.empty_cache()
    print(json.dumps({"root": str(root),
                      "device": cs.nvidia_smi("name,power.limit"),
                      "launches": n, "k4": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
