"""Dataclass configuration with dotted CLI overrides.

The sections and defaults are the JAX package's (``euromillioner_tpu/
config.py``), cut to the fields the ported path reads, so a command line
written for one package means the same to the other. ``apply_overrides``
walks dotted keys (``serve.precision=fused``) exactly as there.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

# The results page the reference scrapes, verbatim (its hard toDate cap
# included): ``data.url``'s default.
REFERENCE_URL = (
    "http://portalseven.com/lottery/euromillions_winning_numbers.jsp"
    "?fromDate=1900-01-01&toDate=2020-06-14&viewType=3"
)

# the featurized row: 4 date columns, then the 7 balls
FEATURE_COLUMNS = (
    "day_of_week", "month", "day", "year",
    "first", "second", "third", "fourth", "fifth",
    "special_1", "special_2",
)
FIXED_CSV_HEADER = ",".join(FEATURE_COLUMNS)
# The reference writer's header, typos (`fift`, `,;`) included — written
# only under data.compat_csv.
REFERENCE_CSV_HEADER = (
    "day_of_week, month, day, year, first, second, third, fourth, fift,;"
    " special_1, special_2,"
)


@dataclass
class DataConfig:
    """Acquisition and ETL: the results page (fetched from ``url``, or
    saved), or a featurized CSV."""

    url: str = REFERENCE_URL
    # Bootstrap-table class string of the results table.
    table_class: str = (
        "table table-bordered table-condensed table-striped text-center table-hover"
    )
    date_format: str = "%a, %b %d, %Y"  # "E, MMM d, yyyy"
    train_percent: int = 70             # chronological split
    label_column: int = 0               # DMatrix "?label_column=0"
    # compat=True reproduces the reference CSV writer's bytes: no
    # newlines, header typos, a trailing ", " after every value.
    compat_csv: bool = False
    # Stale-while-revalidate snapshot of the last good featurized rows:
    # refreshed on every successful fetch, served (with a warning) when
    # fetch retries exhaust. "" disables the degraded path.
    cache_path: str = ""
    batch_size: int = 64
    shuffle: bool = False               # the split is chronological, unshuffled


@dataclass
class GBTConfig:
    """XGBoost-parity gradient-boosted trees: the reference's literal
    config (the JAX package's ``GBTConfig``, same fields and defaults)."""

    booster: str = "gbtree"
    eta: float = 1.0
    max_depth: int = 3
    objective: str = "reg:logistic"
    subsample: float = 1.0
    colsample_bytree: float = 1.0       # xgboost default
    nthread: int = 6                    # accepted for parity, ignored
    gamma: float = 1.0                  # min split loss
    reg_lambda: float = 1.0             # xgboost default L2
    eval_metric: str = "logloss"
    nround: int = 500
    # Boosting rounds between host syncs (trees/gbt._resolve_fuse_rounds);
    # None = auto. Results are identical across settings.
    fuse_rounds: int | None = None
    max_bins: int = 256
    base_score: float = 0.5
    min_child_weight: float = 1.0       # xgboost default
    seed: int = 0
    hist_method: str = "auto"           # auto | scatter | pallas
    # auto / cuda / gpu train on the card; cpu on the CPU
    # (trees/gbt._resolve_device)
    device: str = "auto"

    def xgb_params(self) -> dict:
        """The xgboost-style params dict for ``trees.train`` (nround and
        fuse_rounds are call arguments, not params)."""
        return {
            "booster": self.booster,
            "eta": self.eta,
            "max_depth": self.max_depth,
            "objective": self.objective,
            "subsample": self.subsample,
            "colsample_bytree": self.colsample_bytree,
            "gamma": self.gamma,
            "lambda": self.reg_lambda,
            "eval_metric": self.eval_metric,
            "max_bins": self.max_bins,
            "base_score": self.base_score,
            "min_child_weight": self.min_child_weight,
            "seed": self.seed,
            "device": self.device,
            "hist_method": self.hist_method,
        }


@dataclass
class ForestConfig:
    """Spark-MLlib-style random forest (BASELINE.json config 3; the JAX
    package's ``ForestConfig``, same fields and defaults)."""

    num_trees: int = 100
    max_depth: int = 8
    max_bins: int = 32                  # MLlib default
    feature_subset: str = "sqrt"        # "auto"|"all"|"sqrt"|"log2"|fraction
    bootstrap: bool = True
    min_info_gain: float = 0.0
    seed: int = 0
    hist_method: str = "auto"           # auto | scatter | pallas


@dataclass
class ModelConfig:
    """Neural models (BASELINE.json configs 1, 2, 5)."""

    name: str = "mlp"                   # mlp | lstm | wide_deep
    hidden_sizes: tuple[int, ...] = (256, 256)
    lstm_hidden: int = 512
    lstm_layers: int = 2
    seq_len: int = 64
    embed_dim: int = 0                  # 0 = the model family's default
    dropout: float = 0.0
    # Wide&Deep total parameter target (BASELINE config 5's 100M stretch
    # by default; turn down for small runs/tests)
    wide_deep_target_params: int = 100_000_000
    graves_peepholes: bool = True       # GravesLSTM parity (dl4j 0.9.1)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"


@dataclass
class TrainConfig:
    """Trainer + optimizer + checkpointing."""

    optimizer: str = "adam"             # sgd | momentum | rmsprop | adam
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    momentum: float = 0.9
    epochs: int = 20
    log_every: int = 1
    # Truncated BPTT over the whole draw history (train/tbptt.py, ``train
    # --tbptt``): the gradient horizon per chunk, and the number of
    # parallel batch lanes the history is folded into.
    tbptt_chunk_len: int = 50
    tbptt_lanes: int = 8
    checkpoint_dir: str = ""
    checkpoint_every: int = 0           # epochs; 0 disables
    metrics_jsonl: str = ""
    seed: int = 0


@dataclass
class TreesServeConfig:
    """Chunked ensemble dispatch for the tree families (``serve.trees.*``;
    serve/session.py, trees/chunked.py): the ensemble's tables are cut
    into fixed-size tree chunks streamed to the device one window at a
    time, and an f32 carry threads chunk to chunk in tree order, so the
    replies stay bit-equal to ``predict``. The default (chunk=0) serves
    whole-ensemble programs."""

    # Trees per chunk (the tail pads with no-op trees); must be >= 2 when
    # set. 0 (default) = whole-ensemble programs.
    chunk: int = 0
    # Ensembles at or below this tree count keep the whole-ensemble path
    # even with chunk > 0.
    chunk_threshold: int = 512
    # Opt-in chunked mean for REGRESSION forests: an f32 sum carry divided
    # once at the end, served behind the pinned (rf, chunked_mean)
    # envelope with the whole-forest predict as the drift oracle. False
    # (the default) keeps the whole-forest program for a regressor.
    approx_mean: bool = False


@dataclass
class ObsServeConfig:
    """Serving telemetry (obs/): metrics registry, trace spans and SLO
    attainment (``serve.obs.*``)."""

    # Master switch for the telemetry extras: per-request trace spans,
    # SLO-attainment judging and the 1 Hz JSONL stats snapshots. The
    # metrics registry stays on: it is the engines' stats() store.
    enabled: bool = True
    # Bounded ring of completed trace spans served by GET /trace?n=K.
    trace_buffer: int = 512
    # Per-class default SLO deadline in ms, aligned by position with
    # serve.classes (serve.obs.slo_ms=50,2000: interactive at 50 ms, bulk
    # at 2 s). A request carrying an explicit max_wait_s is judged against
    # that instead; () judges only explicit deadlines.
    slo_ms: tuple[int, ...] = ()
    # Workload capture (obs/workload.py): when set, every admitted request
    # is appended here as one replayable trace line. Best-effort: one
    # write failure disables capture with a single warning. "" = off.
    capture_path: str = ""


@dataclass
class BudgetConfig:
    """Byte-accounted memory governance of the serving stack
    (``serve.budget.*``; serve/session.py ``MemoryLedger`` and the step
    scheduler's budget governor). Disabled (the default), bytes are
    tracked in ``stats()["budget"]`` and nothing is enforced."""

    # Enforce the budgets below. As one is approached the governor
    # degrades loudest-first: (1) stop preempting when the ledger's RAM
    # and disk tiers cannot hold another victim; (2) a parked sequence
    # whose restore needs RAM the ledger cannot free stays parked
    # (counted as deferred); (3) a submit past queue_bytes is shed with a
    # ServeError naming the budget.
    enabled: bool = False
    # Host-RAM bound of parked eviction state; colder blobs spill LRU to
    # spill_dir as crc32-checked EMT1 files and restore bit-exactly.
    ledger_bytes: int = 32 * 2**20
    # The spill tier's directory; "" keeps parked state in RAM only.
    spill_dir: str = ""
    # Bound on spilled bytes on disk.
    spill_bytes: int = 256 * 2**20
    # Bound on queued request payload bytes; 0 = unbounded.
    queue_bytes: int = 0


@dataclass
class PreemptConfig:
    """Slot preemption and the elastic pool of the step scheduler
    (``serve.preempt.*``). All off by default."""

    # Evict the least urgent slot-holder (its per-layer (h, c) rows, in
    # the pool's own dtype) when the admission heap holds a strictly more
    # urgent class; the victim restores when pressure clears and finishes
    # bit-equal to a never-preempted run.
    enabled: bool = False
    # Bound on parked victims; a full ledger stops preemption. A parked
    # sequence whose deadline passes is failed loudly (a shed).
    max_evicted: int = 64
    # Grow and shrink the live pool by load between min_slots and
    # serve.max_slots; a shrink evicts the occupied high slots.
    elastic: bool = False
    # Elastic floor (>= 2).
    min_slots: int = 2
    # Grow at (active + queued) / pool >= grow_load, shrink at <=
    # shrink_load, after resize_hysteresis block boundaries in a row.
    grow_load: float = 1.0
    shrink_load: float = 0.25
    resize_hysteresis: int = 8


@dataclass
class PagingConfig:
    """Paged slot state of the step scheduler (``serve.paging.*``): the
    per-layer (h, c) state lives in a page store of pages * page_slots
    rows, the live set may oversubscribe the rows up to max_live, and
    cold sequences demote to the ledger's RAM/disk tiers. Off by
    default."""

    enabled: bool = False
    # Rows per page (a live sequence holds one row).
    page_slots: int = 4
    # Device pages; 0 = ceil(max_slots / page_slots), the dense pool's
    # footprint.
    pages: int = 0
    # Live (admitted, unfinished) sequences; 0 = 4 x the device rows.
    max_live: int = 0


@dataclass
class AotConfig:
    """The AOT program store (serve/aotstore.py): serving programs compiled
    ahead of time with AOTInductor and kept on disk, so a restarted
    serving process loads its whole (bucket, rows, steps, block, profile)
    ladder instead of compiling it. Nested under ``serve`` — override as
    ``serve.aot.field=``. The default (disabled) keeps serving eager, as
    without the store."""

    # Master switch. On, every serving program is exported with its
    # parameters as inputs, compiled and kept (crc32-checked EMT1 blobs
    # keyed by the program's fingerprint and the environment: torch, CUDA,
    # the card, the CPU, the custom ops and kernel sources — a stale or
    # foreign entry is a miss, never a load); a warm manifest records
    # every key ever compiled, and warmup preloads them all. A corrupt
    # blob falls back to a fresh compile (counted, quarantined: the
    # serve.aot fault point); a failed compile raises.
    enabled: bool = False
    # Store directory. "" = .aot_store under the working directory.
    dir: str = ""
    # Size bound: after each save the store LRU-prunes (oldest file mtime
    # first; loads refresh it) down to this many bytes. 0 = unbounded.
    max_bytes: int = 1 << 30


@dataclass
class AutoscaleConfig:
    """The fleet supervisor (serve/supervisor.py): warm respawn of dead
    hosts, a load-derived host count with hysteresis and per-direction
    cooldowns, crash-loop quarantine. Nested under ``serve.fleet`` —
    override as ``serve.fleet.autoscale.field=``. Disabled (the default),
    the ``fleet`` command builds no supervisor."""

    # The scaling half; a supervisor attached without it still respawns
    # dead hosts and quarantines crash loops.
    enabled: bool = False
    # Host-count bounds. Scale-up spawns a warm host that enters through
    # the router's probation; scale-down drains its victim (no new
    # admissions, in-flight work completes), then retires it.
    min_hosts: int = 1
    max_hosts: int = 4
    # Tick cadence.
    interval_ms: float = 200.0
    # Scale up on any of: admission heap depth >= up_pending, mean
    # admitted-host occupancy >= up_occupancy, recent attainment of the
    # first class < up_attainment.
    up_pending: int = 1
    up_occupancy: float = 0.85
    up_attainment: float = 0.9
    # Scale down on all of: empty heap and queues, mean occupancy <=
    # down_occupancy, more than min_hosts admitted.
    down_occupancy: float = 0.25
    # Consecutive ticks wanting one direction before a decision fires,
    # and each direction's cooldown.
    scale_hysteresis: int = 2
    up_cooldown_ms: float = 2000.0
    down_cooldown_ms: float = 10000.0
    # An ejected host with no healthy streak for this many probes is
    # declared dead and respawned.
    dead_after_probes: int = 8
    # Spawn attempts per cycle (the fleet.spawn fault point) and the
    # first backoff; an exhausted cycle is a crash-loop strike.
    spawn_retries: int = 3
    spawn_backoff_ms: float = 50.0
    # This many deaths or exhausted spawn cycles of one host inside
    # strike_window_s quarantine it until `fleet --release`.
    quarantine_strikes: int = 3
    strike_window_s: float = 300.0


@dataclass
class MigrateConfig:
    """Live migration between fleet hosts (serve/router.py ``migrate``
    over the step scheduler's export and import): a slot holder's state
    moves as a stamped, crc-checked blob and resumes bit-identical.
    Nested under ``serve.fleet`` — override as
    ``serve.fleet.migrate.field=``."""

    # Off: scale-down waits out sequences, an ejection re-routes from
    # step 0 and a restart loses its slot holders.
    enabled: bool = True
    # Scale-down migrates the victim's slot holders (reason "drain").
    drain: bool = True
    # An SLO ejection of a reachable host migrates its live sequences
    # (reason "eject"); a stale host cannot answer its export surface.
    eject: bool = True
    # FleetSupervisor.restart_host migrates to peers and restores the
    # rest into the fresh engine (reason "respawn").
    respawn: bool = True
    # How long the router waits for one export before leaving the
    # sequence where it runs.
    export_timeout_ms: float = 30000.0


@dataclass
class FleetConfig:
    """The serving fleet (serve/fleet.py, serve/router.py,
    serve/rollout.py): router-owned admission, SLO-keyed ejection,
    drain and re-route, recovery probation, versioned rollout. Nested
    under ``serve`` — override as ``serve.fleet.field=``."""

    # Backend host URLs the `fleet` command fronts (comma-separated).
    # Empty with --smoke: in-process hosts.
    hosts: tuple[str, ...] = ()
    # Every host's /healthz is probed each interval, concurrently, with
    # a per-probe timeout, retries and pre-probe jitter.
    probe_interval_ms: float = 200.0
    probe_timeout_ms: float = 1000.0
    probe_retries: int = 2
    probe_jitter_ms: float = 10.0
    # HTTP /predict timeout per route attempt, apart from the probe's: a
    # request may queue for seconds on a healthy host.
    request_timeout_ms: float = 30000.0
    # Eject after eject_breach_probes bodies whose attainment of
    # eject_class ("" = the first serve.classes entry) is below
    # eject_attainment, or after eject_stale_probes failed probes.
    eject_attainment: float = 0.5
    eject_class: str = ""
    eject_breach_probes: int = 2
    eject_stale_probes: int = 3
    # Healthy probes before an ejected host is re-admitted.
    probation_probes: int = 3
    # Dispatch attempts per request across re-routes.
    max_route_attempts: int = 3
    # Bound on the admission heap during a fleet-wide outage; past it a
    # new arrival is shed (fleet_shed_total).
    max_pending: int = 4096
    # Versioned rollout (RolloutEngine.from_config): the canary share and
    # the auto-rollback gates.
    canary_pct: float = 10.0
    rollout_max_rel_err: float = 1e-3
    rollout_max_latency_x: float = 3.0
    rollout_min_attainment: float = 0.9
    # The supervisor (serve.fleet.autoscale.*).
    autoscale: AutoscaleConfig = field(default_factory=AutoscaleConfig)
    # Live migration (serve.fleet.migrate.*).
    migrate: MigrateConfig = field(default_factory=MigrateConfig)


@dataclass
class ServeConfig:
    """Serving: the HTTP front end (serve/transport.py), the sequence
    schedulers (serve/continuous.py) and the row engine
    (serve/engine.py)."""

    host: str = "127.0.0.1"
    port: int = 8777
    # Flush a micro-batch when it reaches the largest row bucket or when
    # the OLDEST queued request has waited max_wait_ms (serve/batcher.py).
    max_wait_ms: float = 2.0
    # Row buckets: a micro-batch pads up to the smallest that fits.
    buckets: tuple[int, ...] = (8, 32, 128)
    # In-flight micro-batch window (>= 2 overlaps the next batch's upload
    # with the current batch's compute).
    inflight: int = 2
    # Compiled programs an engine keeps in RAM (LRU) under serve.aot; the
    # eager default keeps none.
    max_executables: int = 16
    # Sequence family (lstm): "batch" coalesces whole sequences into
    # time/row-padded micro-batches; "continuous" schedules at the step
    # level over a device-resident slot pool. Row families ignore it.
    scheduler: str = "batch"
    # Continuous scheduler: state slots in the pool (one sequence each;
    # also the step program's row count, >= 2).
    max_slots: int = 32
    # Continuous scheduler: timesteps per dispatch (>= 2).
    step_block: int = 8
    # Continuous scheduler: adaptive step-block ladder (e.g. 2,8,32),
    # picked per dispatch by load with hysteresis; every rung >= 2.
    # Empty: the fixed step_block.
    step_blocks: tuple[int, ...] = ()
    # Continuous scheduler: finished outputs wait in a device-side
    # staging buffer and drain in one device→host read per interval
    # (sooner when a finisher's max_wait_s is due). 0 reads every step.
    readback_interval_ms: float = 0.0
    # SLO classes, most urgent first: requests name one ("class" key,
    # submit(cls=)); cuts and slot admission order by (class priority,
    # deadline). Unknown names are refused; no class is the first.
    classes: tuple[str, ...] = ("interactive", "bulk")
    # Time buckets: a micro-batch pads to the smallest fitting length;
    # the largest caps admissible sequence length.
    seq_buckets: tuple[int, ...] = (8, 16, 32, 64)
    # "f32" (the oracle profile), "bf16" (params cast once, served in
    # bfloat16), "fused" (the CUDA sequence kernel for the padded
    # zero-carry programs) or "int8w" (weight-only int8 params through the
    # same kernel), each behind its pinned envelope (core/precision.py).
    precision: str = "f32"
    # Extra profiles served beside ``precision`` from the same checkpoint,
    # picked per request ({"profile": ...}, submit(profile=)); each runs
    # on its own child scheduler. Empty: one profile.
    profiles: tuple[str, ...] = ()
    # int8w tier: fake-quantize the input block to the per-tensor int8 grid
    act_quant: bool = False
    # Accepted and validated (>= 2) so commands shared with the JAX
    # package mean the same; an eager loop has no unroll to tune.
    fused_unroll: int = 8
    # Serving device mesh as (data, model) axis sizes (serve/session.py
    # ``build_serving_mesh``): ``data`` shards micro-batch rows and the
    # step scheduler's slot pool (bit-identical to one device), ``model``
    # splits Wide&Deep's parameters per its sharding rules (within a
    # pinned rel-error envelope). (1, 1), the default, builds no mesh;
    # data*model must divide the device count. Bucket and slot tables
    # round UP to multiples of the data axis (logged once).
    mesh: tuple[int, int] = (1, 1)
    # Run every (row bucket, time bucket) program once before serving.
    warmup: bool = True
    # Per-micro-batch / per-step observability records (queue depth, fill
    # ratio, latency, trace ids) through the shared obs emitter.
    metrics_jsonl: str = ""
    # Telemetry knobs (serve.obs.enabled / trace_buffer / slo_ms / ...).
    obs: ObsServeConfig = field(default_factory=ObsServeConfig)
    # Tree-ensemble serving (serve.trees.chunk=...).
    trees: TreesServeConfig = field(default_factory=TreesServeConfig)
    # Step scheduler: preemption and the elastic pool (serve.preempt.*).
    preempt: PreemptConfig = field(default_factory=PreemptConfig)
    # Memory budgets and the spill tier (serve.budget.*).
    budget: BudgetConfig = field(default_factory=BudgetConfig)
    # Step scheduler: paged slot state (serve.paging.*).
    paging: PagingConfig = field(default_factory=PagingConfig)
    # The AOT program store (serve.aot.*).
    aot: AotConfig = field(default_factory=AotConfig)
    # The serving fleet (serve.fleet.*).
    fleet: FleetConfig = field(default_factory=FleetConfig)


@dataclass
class MeshConfig:
    """Device mesh axes (the JAX package's ``MeshConfig``, same fields and
    defaults); adapt via ``core.mesh.MeshSpec.from_config``: ``data``
    shards batches, ``model`` parameters (tensor parallelism), ``seq``
    the LSTM's time dim (sequence parallelism)."""

    data: int = -1                      # -1 → all devices
    model: int = 1
    seq: int = 1


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    gbt: GBTConfig = field(default_factory=GBTConfig)
    forest: ForestConfig = field(default_factory=ForestConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)


def _coerce(current: Any, value: str, optional: bool = False) -> Any:
    """Coerce a CLI string to the type of the current field value.
    ``optional`` marks fields whose declared default is None
    (``gbt.fuse_rounds``): "auto"/"none" restore the default, anything
    else must be an integer."""
    if optional and value.strip().lower() in ("auto", "none", ""):
        return None
    if current is None:
        try:
            return int(value)
        except ValueError:
            raise ValueError(
                f"cannot coerce {value!r} for an optional int field "
                f"(use an integer, or 'auto' for the default policy)")
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        return tuple(int(v) if v.strip().isdigit() else v.strip()
                     for v in value.split(",") if v.strip())
    return value


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply ``section.field=value`` overrides (e.g. ``serve.warmup=false``);
    keys walk nested dataclass sections."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be section.field=value: {ov!r}")
        key, value = ov.split("=", 1)
        parts = key.strip().lstrip("-").split(".")
        if len(parts) < 2:
            raise ValueError(f"override key must be section.field: {key!r}")
        sub: Any = cfg
        for section in parts[:-1]:
            sub = getattr(sub, section, None)
            if sub is None or not dataclasses.is_dataclass(sub):
                raise ValueError(f"unknown config section: {section!r}")
        fieldname = parts[-1]
        if not hasattr(sub, fieldname):
            raise ValueError(
                f"unknown field {fieldname!r} in section "
                f"{'.'.join(parts[:-1])!r}")
        current = getattr(sub, fieldname)
        if dataclasses.is_dataclass(current):
            raise ValueError(
                f"{key!r} names a config section, not a field — "
                f"override one of its fields instead")
        declared = {f.name: f for f in dataclasses.fields(sub)}[fieldname]
        setattr(sub, fieldname, _coerce(current, value,
                                        optional=declared.default is None))
    return cfg
