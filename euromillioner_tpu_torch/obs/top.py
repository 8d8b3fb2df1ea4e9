"""obs-top: live one-line-per-second serving summary for bench/soak runs.

``python -m euromillioner_tpu_torch obs-top --jsonl metrics.jsonl`` tails a
serving engine's metrics JSONL (the shared-emitter stream: per-batch /
per-step records plus the 1 Hz ``{"event": "stats"}`` snapshots) and
renders one summary line per second::

    12:03:41 rps=1842.0 p50=1.2ms p99=6.3ms att=99.4% occ=0.81 q=3 err=0

``--url http://host:port`` polls ``GET /stats`` instead (the remote
form — no shared filesystem needed). ``--fleet url1,url2`` polls every
host's ``GET /metrics`` and renders ONE per-host attainment line per
poll (``h0[att=99.5% q=1 occ=0.50] h1[DOWN]`` — the fleet dashboard
that comes free with each host serving Prometheus text). ``--once``
renders everything already in the file and exits — the deterministic
mode tier-1 smoke tests against a recorded fixture.

The math is pure functions over parsed records (:func:`bucket_records`,
:func:`summarize_bucket`, :func:`format_line`) so tests drive them
directly; the CLI loop is a thin shell around them.
"""

from __future__ import annotations

import json
import time
from typing import Any, Iterable

# JSONL events that carry per-event request completions, with the key
# counting them. "batch" rows serve row engines; sequence engines count
# completions at readback ("readback": continuous) or batch
# ("sequences": whole-sequence).
_COMPLETION_KEYS = ("requests", "sequences")


def parse_jsonl(lines: Iterable[str]) -> list[dict]:
    """Parsed records, silently skipping malformed lines (a tail can
    catch a partially written line)."""
    out = []
    for ln in lines:
        ln = ln.strip()
        if not ln:
            continue
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and "ts" in rec:
            out.append(rec)
    return out


def bucket_records(records: list[dict]) -> list[tuple[int, list[dict]]]:
    """Group records by whole second of their ``ts``, in time order."""
    buckets: dict[int, list[dict]] = {}
    for rec in records:
        buckets.setdefault(int(rec["ts"]), []).append(rec)
    return sorted(buckets.items())


def _completions(rec: dict) -> int:
    ev = rec.get("event")
    if ev == "batch":
        for key in _COMPLETION_KEYS:
            if key in rec:
                return int(rec[key])
    if ev == "readback":
        return int(rec.get("sequences", 0))
    return 0


def summarize_bucket(second: int, recs: list[dict],
                     carry: dict | None = None) -> dict:
    """One second's summary: completions/sec from the per-batch records,
    latency/attainment/occupancy from the newest stats snapshot in (or,
    via ``carry``, carried into) the bucket — the 1 Hz snapshot limiter
    drifts against wall-clock seconds, so a bucket with batch records
    but no snapshot reuses the previous second's."""
    out: dict[str, Any] = {"second": second,
                           "rps": float(sum(_completions(r)
                                            for r in recs))}
    stats = [r for r in recs if r.get("event") == "stats"]
    st = stats[-1] if stats else carry
    if st is not None:
        # request latency and per-step-block dispatch latency are
        # different quantities — a continuous engine reports only the
        # latter at top level, so render it under its own step.* labels
        # instead of conflating it with p50=/p99=
        out["p50_ms"] = st.get("p50_ms")
        out["p99_ms"] = st.get("p99_ms")
        if out["p50_ms"] is None and out["p99_ms"] is None:
            out["step_p50_ms"] = st.get("p50_step_ms")
            out["step_p99_ms"] = st.get("p99_step_ms")
        out["queued"] = st.get("queue_depth", st.get("queued"))
        occ = st.get("mean_occupancy")
        if occ is None and "active" in st and st.get("slots"):
            occ = st["active"] / st["slots"]
        out["occupancy"] = occ
        out["errors"] = st.get("errors")
        slo = st.get("slo")
        if isinstance(slo, dict):
            met = sum(v.get("met", 0) for v in slo.values())
            miss = sum(v.get("missed", 0) for v in slo.values())
            out["attainment"] = (met / (met + miss)
                                 if met + miss else 1.0)
            out["classes"] = {
                c: v.get("attainment") for c, v in slo.items()}
        cls = st.get("classes")
        if isinstance(cls, dict):
            out["class_p99_ms"] = {
                c: v.get("p99_ms") for c, v in cls.items()
                if isinstance(v, dict)}
        # budget surface (serve.budget): parked eviction bytes across
        # both ledger tiers + spill count — rendered led=/spl= with the
        # non-zero-only err= idiom (pre-budget snapshots render nothing)
        budget = st.get("budget")
        if isinstance(budget, dict):
            b = budget.get("bytes")
            if isinstance(b, dict):
                out["ledger_bytes"] = (b.get("ram", 0) or 0) + \
                                      (b.get("disk", 0) or 0)
            out["spilled"] = budget.get("spills")
        # AOT store surface (serve.aot): disk hits — rendered aot= with
        # the same non-zero-only idiom (store-less snapshots render
        # nothing)
        aot = st.get("aot")
        if isinstance(aot, dict):
            out["aot_hits"] = aot.get("hits")
        # chunked-ensemble surface (serve.trees.chunk): chunk-program
        # dispatches — rendered chk= with the same non-zero-only idiom
        # (unchunked snapshots render nothing)
        trees = st.get("trees")
        if isinstance(trees, dict):
            out["tree_chunks"] = trees.get("chunks")
        # paged-pool surface (serve.paging): live oversubscribed
        # sequences vs. the page-store row count — rendered pg= with
        # the same non-zero idiom (dense pools render nothing)
        paging = st.get("paging")
        if isinstance(paging, dict) and paging.get("enabled"):
            out["pages_live"] = paging.get("live")
            out["pages_rows"] = paging.get("rows")
        # mixed-profile surface (serve.profiles): the active profile mix
        # — per-profile completion (or live-slot) counts, rendered
        # mix= with the non-zero-only idiom (single-profile hosts and
        # pre-profile snapshots render nothing)
        profs = st.get("profiles")
        if isinstance(profs, dict):
            mix = {}
            for p, v in profs.items():
                if not isinstance(v, dict):
                    continue
                n = v.get("active")
                if n is None:
                    n = v.get("completed", 0)
                if n:
                    mix[p] = int(n)
            if mix:
                out["profile_mix"] = mix
    return out


def format_line(s: dict) -> str:
    """Render one summary dict as the fixed-order console line."""
    parts = [time.strftime("%H:%M:%S", time.localtime(s["second"])),
             f"rps={s['rps']:.1f}"]
    if s.get("p50_ms") is not None:
        parts.append(f"p50={s['p50_ms']:.1f}ms")
    if s.get("p99_ms") is not None:
        parts.append(f"p99={s['p99_ms']:.1f}ms")
    if s.get("step_p50_ms") is not None:
        parts.append(f"step.p50={s['step_p50_ms']:.1f}ms")
    if s.get("step_p99_ms") is not None:
        parts.append(f"step.p99={s['step_p99_ms']:.1f}ms")
    if s.get("attainment") is not None:
        parts.append(f"att={100.0 * s['attainment']:.1f}%")
    if s.get("occupancy") is not None:
        parts.append(f"occ={s['occupancy']:.2f}")
    if s.get("queued") is not None:
        parts.append(f"q={s['queued']}")
    # ledger/spill activity, rendered like err=: only when non-zero
    if s.get("ledger_bytes"):
        parts.append(f"led={s['ledger_bytes'] / 2**20:.1f}M")
    if s.get("spilled"):
        parts.append(f"spl={s['spilled']}")
    # AOT disk hits (serve.aot), same non-zero idiom — a warm-started
    # host announces its executables came from the store
    if s.get("aot_hits"):
        parts.append(f"aot={s['aot_hits']}")
    # chunk-program dispatches (serve.trees.chunk), same non-zero idiom
    if s.get("tree_chunks"):
        parts.append(f"chk={s['tree_chunks']}")
    # paged-pool oversubscription (serve.paging), live/rows — rendered
    # only when sequences actually hold or await pages
    if s.get("pages_live"):
        rows = s.get("pages_rows")
        parts.append(f"pg={s['pages_live']}/{rows}" if rows
                     else f"pg={s['pages_live']}")
    # active precision-profile mix (serve.profiles), non-zero-only:
    # mix=f32:3,int8w:5 — which profiles the host is actually serving
    if s.get("profile_mix"):
        parts.append("mix=" + ",".join(
            f"{p}:{n}" for p, n in s["profile_mix"].items()))
    if s.get("errors"):
        parts.append(f"err={s['errors']}")
    cp = s.get("class_p99_ms")
    if cp:
        parts.append(" ".join(
            f"{c}.p99={v:.1f}ms" for c, v in cp.items()
            if v is not None))
    return " ".join(parts)


def run_jsonl(path: str, follow: bool = False, out=print,
              poll_s: float = 0.5, max_seconds: float | None = None
              ) -> int:
    """Render summaries from a metrics JSONL. ``follow=False`` (the
    ``--once`` smoke mode) renders the whole file and returns — an
    unreadable path is exit 1, not a vacuous pass; follow mode tolerates
    a not-yet-created file (the server may not have started) and tails
    until EOF stops growing for ``max_seconds`` (None = forever /
    Ctrl-C)."""
    watermark: int | None = None  # newest rendered second
    last_stats: dict | None = None  # carry-in for snapshot-less seconds
    pending: dict[int, list[dict]] = {}
    pos = 0
    t_last_data = time.monotonic()

    def render(second: int, rs: list[dict]) -> None:
        nonlocal watermark, last_stats
        if watermark is None or second > watermark:
            watermark = second
            out(format_line(summarize_bucket(second, rs, last_stats)))
        for rec in rs:
            if rec.get("event") == "stats":
                last_stats = rec

    try:
        while True:
            try:
                # binary offsets: exact byte positions (text-mode tell
                # cookies can't be rewound arithmetically)
                with open(path, "rb") as fh:
                    fh.seek(0, 2)
                    if fh.tell() < pos:
                        pos = 0  # truncated/rotated: start over
                    fh.seek(pos)
                    data = fh.read()
                    pos = fh.tell()
            except OSError as e:
                if not follow:
                    out(f"cannot read {path}: {e}")
                    return 1
                data = b""
            if follow and data:
                # consume only whole lines: a record caught mid-write
                # stays in the file for the next poll instead of being
                # split into two malformed fragments and lost
                nl = data.rfind(b"\n")
                keep = 0 if nl < 0 else nl + 1
                pos -= len(data) - keep
                data = data[:keep]
            chunk = data.decode("utf-8", errors="replace")
            recs = parse_jsonl(chunk.splitlines())
            if recs:
                t_last_data = time.monotonic()
                for second, rs in bucket_records(recs):
                    pending.setdefault(second, []).extend(rs)
            buckets = sorted(pending.items())
            # in follow mode hold back the newest (possibly
            # still-filling) second until a newer one appears or the
            # idle exit flushes it
            head = buckets if not follow else buckets[:-1]
            for second, rs in head:
                render(second, rs)
                del pending[second]
            if not follow:
                return 0
            if (max_seconds is not None
                    and time.monotonic() - t_last_data > max_seconds):
                for second, rs in sorted(pending.items()):
                    render(second, rs)  # flush the held-back tail
                return 0
            time.sleep(poll_s)
    except KeyboardInterrupt:
        # documented exit path for follow mode: flush what's held back
        # and leave cleanly, like cmd_serve's SIGTERM handling
        for second, rs in sorted(pending.items()):
            render(second, rs)
        return 0


def parse_prometheus(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Minimal Prometheus text-exposition parser: metric name →
    ``[(labels, value), ...]``. Comment/blank lines are skipped;
    malformed sample lines are skipped (a scrape race must not kill the
    dashboard). Only what the fleet view needs — quoted label values
    with escaped quotes are beyond this workload's own exposition."""
    out: dict[str, list[tuple[dict, float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            head, value = line.rsplit(" ", 1)
            labels: dict[str, str] = {}
            if "{" in head:
                name, rest = head.split("{", 1)
                body = rest.rsplit("}", 1)[0]
                for pair in body.split(","):
                    if not pair:
                        continue
                    k, v = pair.split("=", 1)
                    labels[k.strip()] = v.strip().strip('"')
            else:
                name = head
            out.setdefault(name, []).append((labels, float(value)))
        except ValueError:
            continue
    return out


def summarize_metrics(metrics: dict) -> dict:
    """One host's fleet-view summary from its parsed /metrics: per-class
    SLO attainment, completions, queue depth, occupancy, errors — the
    per-host slice of the ``fleet-top`` line."""
    out: dict[str, Any] = {}
    att = {lab.get("class"): v
           for lab, v in metrics.get("serve_slo_attainment_ratio", [])
           if lab.get("class")}
    if att:
        out["attainment"] = min(att.values())
        out["classes"] = att
    done = sum(v for _l, v in
               metrics.get("serve_requests_completed_total", []))
    out["completed"] = done
    q = metrics.get("serve_queue_depth")
    if q:
        out["queued"] = int(sum(v for _l, v in q))
    occ = metrics.get("serve_slot_occupancy")
    if occ:
        out["occupancy"] = sum(v for _l, v in occ) / len(occ)
    # preemption figures (serve.preempt): present only on slot hosts
    # that expose them — absent keys render nothing (old hosts / row
    # engines keep their line unchanged)
    pre = metrics.get("serve_preempted_total")
    if pre:
        out["preempted"] = int(sum(v for _l, v in pre))
    evd = metrics.get("serve_evicted_depth")
    if evd:
        out["evicted_depth"] = int(sum(v for _l, v in evd))
    # budget figures (serve.budget): ledger bytes summed across tiers,
    # spill count — absent keys render nothing (pre-budget hosts)
    led = metrics.get("serve_ledger_bytes")
    if led:
        out["ledger_bytes"] = int(sum(v for _l, v in led))
    spl = metrics.get("serve_spill_total")
    if spl:
        out["spilled"] = int(sum(v for _l, v in spl))
    # AOT store disk hits (serve.aot): present only on hosts with the
    # tier bound — absent renders nothing (store-less hosts unchanged)
    aot = metrics.get("serve_aot")
    if aot:
        out["aot_hits"] = int(sum(v for lab, v in aot
                                  if lab.get("stat") == "hits"))
    # chunked-ensemble dispatches (serve.trees.chunk): present only on
    # hosts serving a chunked tree path — absent renders nothing
    tc = metrics.get("serve_tree_chunks_total")
    if tc:
        out["tree_chunks"] = int(sum(v for _l, v in tc))
    # supervisor lifecycle figures (serve/supervisor.py): present only
    # on a router front end running a supervisor — absent keys render
    # nothing (plain hosts / unsupervised routers keep their line)
    spawns = metrics.get("fleet_spawns_total")
    if spawns:
        out["spawns"] = int(sum(v for _l, v in spawns))
    quar = metrics.get("fleet_hosts_quarantined")
    if quar:
        out["quarantined"] = int(sum(v for _l, v in quar))
    # live-sequence migrations (serve.fleet.migrate): router front
    # ends count fleet_migrations_total{reason}; a plain slot host
    # counts its own export+import halves — absent renders nothing
    mig = (metrics.get("fleet_migrations_total")
           or metrics.get("serve_migrations_total"))
    if mig:
        out["migrations"] = int(sum(v for _l, v in mig))
    err = metrics.get("serve_errors_total")
    if err:
        out["errors"] = int(sum(v for _l, v in err))
    return out


def format_fleet_line(second: float, hosts: dict[str, dict],
                      rps: dict[str, float] | None = None) -> str:
    """ONE line aggregating every host: ``h0[att=99% q=1 occ=0.5] ...``
    — the per-host attainment view a fleet dashboard tails."""
    parts = [time.strftime("%H:%M:%S", time.localtime(second))]
    for name in sorted(hosts):
        s = hosts[name]
        if s is None:
            parts.append(f"{name}[DOWN]")
            continue
        bits = []
        if s.get("attainment") is not None:
            bits.append(f"att={100.0 * s['attainment']:.1f}%")
        if rps and name in rps:
            bits.append(f"rps={rps[name]:.1f}")
        if s.get("queued") is not None:
            bits.append(f"q={s['queued']}")
        if s.get("occupancy") is not None:
            bits.append(f"occ={s['occupancy']:.2f}")
        # preemption activity, rendered like err=: only when non-zero
        # (a quiet or pre-preemption host keeps its line unchanged)
        if s.get("preempted"):
            bits.append(f"pre={s['preempted']}")
        if s.get("evicted_depth"):
            bits.append(f"evd={s['evicted_depth']}")
        # ledger MB + spill count (serve.budget), same non-zero idiom
        if s.get("ledger_bytes"):
            bits.append(f"led={s['ledger_bytes'] / 2**20:.1f}M")
        if s.get("spilled"):
            bits.append(f"spl={s['spilled']}")
        # AOT store disk hits (serve.aot), same non-zero idiom — a
        # freshly respawned warm host shows aot= next to its att=
        if s.get("aot_hits"):
            bits.append(f"aot={s['aot_hits']}")
        # chunked-ensemble dispatches (serve.trees.chunk), same idiom
        if s.get("tree_chunks"):
            bits.append(f"chk={s['tree_chunks']}")
        # supervisor lifecycle (serve/supervisor.py), same non-zero
        # idiom: warm spawns driven + hosts sitting in quarantine
        if s.get("spawns"):
            bits.append(f"spawn={s['spawns']}")
        if s.get("quarantined"):
            bits.append(f"quar={s['quarantined']}")
        # live migrations (serve.fleet.migrate), same non-zero idiom
        if s.get("migrations"):
            bits.append(f"mig={s['migrations']}")
        if s.get("errors"):
            bits.append(f"err={s['errors']}")
        parts.append(f"{name}[{' '.join(bits)}]")
    return " ".join(parts)


def run_fleet(urls: list[str], interval_s: float = 1.0, out=print,
              iterations: int | None = None) -> int:
    """``obs-top --fleet``: poll every host's ``GET /metrics`` each
    interval and render ONE per-host attainment line — the fleet
    dashboard that comes free with each host serving Prometheus text.
    A down host renders ``[DOWN]`` and polling continues (the whole
    point is watching a fleet through ejections). With bounded
    ``iterations`` (the ``--once`` smoke mode) the exit is 1 when NO
    host answered the final poll."""
    import urllib.request

    names = {u: f"h{i}" for i, u in enumerate(urls)}
    prev: dict[str, tuple[float, float]] = {}
    n = 0
    any_ok = False
    try:
        while iterations is None or n < iterations:
            n += 1
            t0 = time.time()
            hosts: dict[str, dict | None] = {}
            rps: dict[str, float] = {}
            any_ok = False
            for u in urls:
                name = names[u]
                try:
                    with urllib.request.urlopen(
                            u.rstrip("/") + "/metrics", timeout=5) as resp:
                        s = summarize_metrics(
                            parse_prometheus(resp.read().decode()))
                except Exception:  # noqa: BLE001 — a down host is data
                    hosts[name] = None
                    continue
                any_ok = True
                hosts[name] = s
                p = prev.get(name)
                if p is not None and t0 > p[0]:
                    rps[name] = max(0.0, (s["completed"] - p[1])
                                    / (t0 - p[0]))
                prev[name] = (t0, s["completed"])
            out(format_fleet_line(t0, hosts, rps))
            if iterations is None or n < iterations:
                time.sleep(interval_s)
    except KeyboardInterrupt:
        return 0  # documented exit path for indefinite polling
    return 0 if any_ok else 1


def run_url(url: str, interval_s: float = 1.0, out=print,
            iterations: int | None = None) -> int:
    """Poll ``GET {url}/stats`` and render one line per poll. The rps
    figure is the delta of completion counters between polls. With
    bounded ``iterations`` (the ``--once`` smoke mode) a failed final
    poll is exit 1, not a vacuous pass."""
    import urllib.request

    prev: dict | None = None
    n = 0
    last_ok = False
    try:
        while iterations is None or n < iterations:
            n += 1
            t0 = time.time()
            try:
                with urllib.request.urlopen(url.rstrip("/") + "/stats",
                                            timeout=5) as resp:
                    st = json.loads(resp.read())
            except Exception as e:  # noqa: BLE001 — keep polling
                last_ok = False
                out(f"{time.strftime('%H:%M:%S')} poll failed: {e}")
                time.sleep(interval_s)
                continue
            last_ok = True
            done = st.get("requests", st.get("sequences", 0))
            rps = 0.0
            if prev is not None:
                dt = t0 - prev["t"]
                rps = (max(0.0, (done - prev["done"]) / dt)
                       if dt > 0 else 0.0)
            prev = {"t": t0, "done": done}
            rec = {"ts": t0, "event": "stats", **st}
            s = summarize_bucket(int(t0), [rec])
            s["rps"] = rps
            out(format_line(s))
            if iterations is None or n < iterations:
                time.sleep(interval_s)
    except KeyboardInterrupt:
        return 0  # documented exit path for indefinite polling
    return 0 if last_ok else 1
