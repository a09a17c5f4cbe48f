"""Declarative scenario specs: TOML in, validated phase program out.

A spec is one TOML document::

    [scenario]
    name = "worst-day"
    description = "full-lifecycle churn with hostile inputs"
    seed = 7
    pods = 16

    [[scenario.corpus]]
    id = "ubuntu"
    kind = "real_tree"        # real_tree | real_tree2 | incompressible |
                              # compressible | cdc_resonant | tiny_files |
                              # huge_file
    # mib = 2                 # sized kinds
    # count = 2000            # tiny_files
    # avg_kib = 4             # cdc_resonant (FastCDC average, power of 2)
    # mode = "min"            # cdc_resonant: min | max

    [[scenario.phases]]
    op = "convert"            # convert | deploy | remove | gc | crash_restart
    corpus = ["ubuntu"]
    # adaptive = true         # convert: enable the adaptive codec
    # shard_failover = true   # convert: dict-HA fault arm (primary dies
    #                         # mid-merge; promotion + failover must match
    #                         # the straight-line oracle byte for byte)

    [[scenario.phases]]
    op = "deploy"
    corpus = ["ubuntu"]
    # pods = 8                # default scenario.pods
    # layers = 4              # snapshot chain depth per pod
    # peers = true            # peer chunk tier between pods (default on)
    # corrupt_peer = true     # one hostile peer serves corrupted bytes
    # soci = true             # unconverted gzip layer via the soci index
    # read_mib = 8            # demand-read window per pod (0 = whole blob)
    # crash = "mid"           # crash/restart the control plane mid-phase
    # gc_watermark_mib = 8    # concurrent watermark eviction during the phase
    # deploy_api = "grpc"     # drive the real snapshots.v1 gRPC surface
    # kill_zone = true        # topology fault arm: pods get deterministic
    #                         # rack:zone:region localities and one whole
    #                         # zone is killed mid-deploy

    [[scenario.phases]]
    op = "remove"
    # fraction = 0.5          # deterministic subset of deployed pods

    [[scenario.phases]]
    op = "gc"
    # watermark_mib = 0       # 0 = age-GC only

    [[scenario.faults]]
    site = "blobcache.fetch"  # any failpoint.KNOWN_SITES entry
    action = "error(OSError)*2"
    phase = 1                 # 0-based phase index the fault is armed for

    [scenario.slo]            # the in-run judge (deploy demand reads)
    demand_threshold_ms = 50.0
    demand_p95_factor = 2.0   # vs the unloaded baseline (gate, tools)
    target = 0.9
    window_secs = 0.6
    burn_threshold = 2.0

    [scenario.soak]           # endurance plane (scenario/soak.py; optional)
    epochs = 6                # waves to run
    base_pods = 4             # Poisson mean, diurnal x flash modulated
    drift_rate = 0.08         # corpus-evolution mutation probability
    # full key set (arrivals, scale-up, sentinel growth bounds) in
    # docs/scenarios.md

Validation is strict: unknown keys, unknown ops/kinds, fault sites not
in the failpoint catalog, unparsable fault actions and out-of-range
phase references all raise :class:`ScenarioSpecError` naming the table.
``load`` → ``to_dict`` → ``from_dict`` round-trips exactly.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch.failpoint.spec import SpecError, parse_action
from nydus_snapshotter_tpu_torch.utils.tomlcompat import tomllib


class ScenarioSpecError(ValueError):
    pass


CORPUS_KINDS = (
    "real_tree",
    "real_tree2",
    "incompressible",
    "compressible",
    "cdc_resonant",
    "tiny_files",
    "huge_file",
)
PHASE_OPS = ("convert", "deploy", "remove", "gc", "crash_restart")
CRASH_MODES = ("", "mid")
DEPLOY_APIS = ("", "snapshotter", "grpc")
# Per-layer lazy formats a soci deploy phase can ship (mirrors the
# FormatRouter's probe classes; "gzip" is the historical default).
SOCI_FORMATS = ("gzip", "zstd-seekable", "zstd-opaque", "zstd-chunked")


def _only_keys(table: dict, allowed: set, where: str) -> None:
    unknown = set(table) - allowed
    if unknown:
        raise ScenarioSpecError(f"{where}: unknown keys {sorted(unknown)}")


@dataclass(frozen=True)
class CorpusSpec:
    id: str
    kind: str
    mib: int = 1
    count: int = 1000
    avg_kib: int = 4
    mode: str = "min"

    @classmethod
    def from_dict(cls, d: dict, idx: int) -> "CorpusSpec":
        where = f"[[scenario.corpus]] #{idx}"
        _only_keys(d, {"id", "kind", "mib", "count", "avg_kib", "mode"}, where)
        if not d.get("id"):
            raise ScenarioSpecError(f"{where}: needs an id")
        kind = d.get("kind", "")
        if kind not in CORPUS_KINDS:
            raise ScenarioSpecError(
                f"{where} ({d['id']!r}): unknown kind {kind!r} "
                f"(one of {', '.join(CORPUS_KINDS)})"
            )
        spec = cls(
            id=d["id"],
            kind=kind,
            mib=int(d.get("mib", 1)),
            count=int(d.get("count", 1000)),
            avg_kib=int(d.get("avg_kib", 4)),
            mode=d.get("mode", "min"),
        )
        if spec.mib < 1 or spec.count < 1:
            raise ScenarioSpecError(f"{where} ({spec.id!r}): mib/count must be >= 1")
        if spec.kind == "cdc_resonant":
            avg = spec.avg_kib << 10
            if avg & (avg - 1) or spec.avg_kib < 4:
                raise ScenarioSpecError(
                    f"{where} ({spec.id!r}): avg_kib must be a power of two >= 4"
                )
            if spec.mode not in ("min", "max"):
                raise ScenarioSpecError(
                    f"{where} ({spec.id!r}): mode must be min|max"
                )
        return spec

    def to_dict(self) -> dict:
        return {
            "id": self.id, "kind": self.kind, "mib": self.mib,
            "count": self.count, "avg_kib": self.avg_kib, "mode": self.mode,
        }


@dataclass(frozen=True)
class PhaseSpec:
    op: str
    corpus: tuple = ()
    pods: int = 0  # 0 = scenario default
    layers: int = 3
    adaptive: bool = False
    peers: bool = True
    corrupt_peer: bool = False
    soci: bool = False
    # deploy + soci: per-corpus lazy format, parallel to ``corpus``
    # (one entry per image; empty = all gzip, the historical shape).
    # Mixed lists put gzip + zstd-seekable + zstd-opaque + TOC layers
    # in the SAME storm; every writer is deterministic so the serial
    # replay keeps blob-id identity.
    soci_formats: tuple = ()
    read_mib: int = 0  # demand-read window per pod (0 = whole blob)
    crash: str = ""
    gc_watermark_mib: int = 0
    watermark_mib: int = 0
    fraction: float = 0.5
    # deploy: "" (default, in-process Snapshotter calls), "snapshotter"
    # (explicit default), or "grpc" — pods drive the REAL snapshots.v1
    # gRPC surface over a UDS (api/service.py), exactly as containerd
    # would (ROADMAP item 5 follow-up).
    deploy_api: str = ""
    # convert: exercise the dict-HA plane end to end — the phase's
    # converted bootstraps merge through a primary+replica dict set, the
    # primary dies mid-sequence, the placement controller promotes, the
    # client fails over, and the reconstructed table must be byte-
    # identical to the straight-line oracle.
    shard_failover: bool = False
    # deploy: topology fault arm — pods get deterministic rack:zone:region
    # localities (two zones), every member of one zone is killed mid-
    # deploy, and the survivors must degrade to shield/origin with
    # serial-replay identity preserved.
    kill_zone: bool = False

    @classmethod
    def from_dict(cls, d: dict, idx: int) -> "PhaseSpec":
        where = f"[[scenario.phases]] #{idx}"
        _only_keys(
            d,
            {"op", "corpus", "pods", "layers", "adaptive", "peers",
             "corrupt_peer", "soci", "soci_formats", "read_mib", "crash",
             "gc_watermark_mib", "watermark_mib", "fraction", "deploy_api",
             "shard_failover", "kill_zone"},
            where,
        )
        op = d.get("op", "")
        if op not in PHASE_OPS:
            raise ScenarioSpecError(
                f"{where}: unknown op {op!r} (one of {', '.join(PHASE_OPS)})"
            )
        spec = cls(
            op=op,
            corpus=tuple(d.get("corpus", ())),
            pods=int(d.get("pods", 0)),
            layers=int(d.get("layers", 3)),
            adaptive=bool(d.get("adaptive", False)),
            peers=bool(d.get("peers", True)),
            corrupt_peer=bool(d.get("corrupt_peer", False)),
            soci=bool(d.get("soci", False)),
            soci_formats=tuple(d.get("soci_formats", ())),
            read_mib=int(d.get("read_mib", 0)),
            crash=d.get("crash", ""),
            gc_watermark_mib=int(d.get("gc_watermark_mib", 0)),
            watermark_mib=int(d.get("watermark_mib", 0)),
            fraction=float(d.get("fraction", 0.5)),
            deploy_api=d.get("deploy_api", ""),
            shard_failover=bool(d.get("shard_failover", False)),
            kill_zone=bool(d.get("kill_zone", False)),
        )
        if op in ("convert", "deploy") and not spec.corpus:
            raise ScenarioSpecError(f"{where}: {op} needs a corpus list")
        if spec.crash not in CRASH_MODES:
            raise ScenarioSpecError(f"{where}: crash must be one of {CRASH_MODES}")
        if spec.pods < 0 or spec.layers < 1:
            raise ScenarioSpecError(f"{where}: pods >= 0 and layers >= 1 required")
        if spec.read_mib < 0:
            raise ScenarioSpecError(f"{where}: read_mib must be >= 0 (0 = whole blob)")
        if not 0.0 < spec.fraction <= 1.0:
            raise ScenarioSpecError(f"{where}: fraction must be in (0, 1]")
        if spec.deploy_api not in DEPLOY_APIS:
            raise ScenarioSpecError(
                f"{where}: deploy_api must be one of {DEPLOY_APIS}"
            )
        if spec.deploy_api and op != "deploy":
            raise ScenarioSpecError(f"{where}: deploy_api only applies to deploy")
        if spec.shard_failover and op != "convert":
            raise ScenarioSpecError(
                f"{where}: shard_failover only applies to convert"
            )
        if spec.kill_zone and op != "deploy":
            raise ScenarioSpecError(f"{where}: kill_zone only applies to deploy")
        if spec.kill_zone and not spec.peers:
            raise ScenarioSpecError(f"{where}: kill_zone needs peers = true")
        if spec.soci_formats:
            if op != "deploy" or not spec.soci:
                raise ScenarioSpecError(
                    f"{where}: soci_formats only applies to deploy with"
                    " soci = true"
                )
            if len(spec.soci_formats) != len(spec.corpus):
                raise ScenarioSpecError(
                    f"{where}: soci_formats must be parallel to corpus"
                    f" ({len(spec.soci_formats)} formats for"
                    f" {len(spec.corpus)} corpora)"
                )
            bad = [f for f in spec.soci_formats if f not in SOCI_FORMATS]
            if bad:
                raise ScenarioSpecError(
                    f"{where}: unknown soci format(s) {bad}"
                    f" (one of {', '.join(SOCI_FORMATS)})"
                )
        return spec

    def to_dict(self) -> dict:
        return {
            "op": self.op, "corpus": list(self.corpus), "pods": self.pods,
            "layers": self.layers, "adaptive": self.adaptive,
            "peers": self.peers, "corrupt_peer": self.corrupt_peer,
            "soci": self.soci, "soci_formats": list(self.soci_formats),
            "read_mib": self.read_mib, "crash": self.crash,
            "gc_watermark_mib": self.gc_watermark_mib,
            "watermark_mib": self.watermark_mib, "fraction": self.fraction,
            "deploy_api": self.deploy_api,
            "shard_failover": self.shard_failover,
            "kill_zone": self.kill_zone,
        }


@dataclass(frozen=True)
class FaultSpec:
    site: str
    action: str
    phase: int

    @classmethod
    def from_dict(cls, d: dict, idx: int, n_phases: int) -> "FaultSpec":
        where = f"[[scenario.faults]] #{idx}"
        _only_keys(d, {"site", "action", "phase"}, where)
        site = d.get("site", "")
        if site not in failpoint.KNOWN_SITES:
            raise ScenarioSpecError(f"{where}: unknown failpoint site {site!r}")
        action = d.get("action", "")
        try:
            parse_action(action)
        except SpecError as e:
            raise ScenarioSpecError(f"{where}: bad action {action!r}: {e}") from e
        phase = int(d.get("phase", -1))
        if not 0 <= phase < n_phases:
            raise ScenarioSpecError(
                f"{where}: phase {phase} out of range (spec has {n_phases})"
            )
        return cls(site=site, action=action, phase=phase)

    def to_dict(self) -> dict:
        return {"site": self.site, "action": self.action, "phase": self.phase}


@dataclass(frozen=True)
class SloBudget:
    demand_threshold_ms: float = 50.0
    demand_p95_factor: float = 2.0
    target: float = 0.9
    window_secs: float = 0.6
    burn_threshold: float = 2.0

    @classmethod
    def from_dict(cls, d: dict) -> "SloBudget":
        _only_keys(
            d,
            {"demand_threshold_ms", "demand_p95_factor", "target",
             "window_secs", "burn_threshold"},
            "[scenario.slo]",
        )
        spec = cls(
            demand_threshold_ms=float(d.get("demand_threshold_ms", 50.0)),
            demand_p95_factor=float(d.get("demand_p95_factor", 2.0)),
            target=float(d.get("target", 0.9)),
            window_secs=float(d.get("window_secs", 0.6)),
            burn_threshold=float(d.get("burn_threshold", 2.0)),
        )
        if spec.demand_threshold_ms <= 0 or spec.window_secs <= 0:
            raise ScenarioSpecError("[scenario.slo]: threshold/window must be positive")
        from nydus_snapshotter_tpu_torch.metrics.registry import DEFAULT_DURATION_BUCKETS

        if spec.demand_threshold_ms not in DEFAULT_DURATION_BUCKETS:
            raise ScenarioSpecError(
                f"[scenario.slo]: demand_threshold_ms must align to a "
                f"histogram bucket boundary {DEFAULT_DURATION_BUCKETS}"
            )
        if not 0.0 < spec.target < 1.0:
            raise ScenarioSpecError("[scenario.slo]: target must be in (0, 1)")
        if spec.demand_p95_factor < 1.0 or spec.burn_threshold <= 0:
            raise ScenarioSpecError(
                "[scenario.slo]: demand_p95_factor >= 1 and burn_threshold > 0"
            )
        return spec

    def to_dict(self) -> dict:
        return {
            "demand_threshold_ms": self.demand_threshold_ms,
            "demand_p95_factor": self.demand_p95_factor,
            "target": self.target,
            "window_secs": self.window_secs,
            "burn_threshold": self.burn_threshold,
        }


@dataclass(frozen=True)
class SoakSpec:
    """``[scenario.soak]`` — the endurance-plane knobs (docs/scenarios.md).

    The soak runs ``epochs`` waves; each wave's pod count is a pure
    function of ``(seed, epoch)``: a Poisson draw around ``base_pods``
    modulated by a cosine diurnal curve (period ``epochs_per_day``,
    amplitude ``diurnal_amplitude``) with a ``flash_prob`` chance of a
    ``flash_factor`` flash crowd. ``drift_rate`` feeds the corpus
    evolution model (per-epoch per-path mutation probability). The
    ``*_growth_per_epoch`` bounds feed the leak sentinels; the scale-up
    trio (``queue_high``/``wait_high_ms``/``quiet_epochs``) feeds the
    closed-loop capacity policy.
    """

    epochs: int = 6
    base_pods: int = 4
    diurnal_amplitude: float = 0.5
    epochs_per_day: int = 8
    flash_prob: float = 0.12
    flash_factor: float = 3.0
    drift_rate: float = 0.08
    reads_per_pod: int = 1
    scaleup: bool = True
    max_extra_members: int = 2
    queue_high: int = 4
    wait_high_ms: float = 25.0
    quiet_epochs: int = 2
    rss_growth_mib_per_epoch: float = 8.0
    fd_growth_per_epoch: float = 4.0
    row_growth_per_epoch: float = 2.0

    @classmethod
    def from_dict(cls, d: dict) -> "SoakSpec":
        where = "[scenario.soak]"
        _only_keys(
            d,
            {"epochs", "base_pods", "diurnal_amplitude", "epochs_per_day",
             "flash_prob", "flash_factor", "drift_rate", "reads_per_pod",
             "scaleup", "max_extra_members", "queue_high", "wait_high_ms",
             "quiet_epochs", "rss_growth_mib_per_epoch",
             "fd_growth_per_epoch", "row_growth_per_epoch"},
            where,
        )
        spec = cls(
            epochs=int(d.get("epochs", 6)),
            base_pods=int(d.get("base_pods", 4)),
            diurnal_amplitude=float(d.get("diurnal_amplitude", 0.5)),
            epochs_per_day=int(d.get("epochs_per_day", 8)),
            flash_prob=float(d.get("flash_prob", 0.12)),
            flash_factor=float(d.get("flash_factor", 3.0)),
            drift_rate=float(d.get("drift_rate", 0.08)),
            reads_per_pod=int(d.get("reads_per_pod", 1)),
            scaleup=bool(d.get("scaleup", True)),
            max_extra_members=int(d.get("max_extra_members", 2)),
            queue_high=int(d.get("queue_high", 4)),
            wait_high_ms=float(d.get("wait_high_ms", 25.0)),
            quiet_epochs=int(d.get("quiet_epochs", 2)),
            rss_growth_mib_per_epoch=float(d.get("rss_growth_mib_per_epoch", 8.0)),
            fd_growth_per_epoch=float(d.get("fd_growth_per_epoch", 4.0)),
            row_growth_per_epoch=float(d.get("row_growth_per_epoch", 2.0)),
        )
        if spec.epochs < 1 or spec.base_pods < 1:
            raise ScenarioSpecError(f"{where}: epochs/base_pods must be >= 1")
        if not 0.0 <= spec.diurnal_amplitude < 1.0:
            raise ScenarioSpecError(f"{where}: diurnal_amplitude must be in [0, 1)")
        if spec.epochs_per_day < 1:
            raise ScenarioSpecError(f"{where}: epochs_per_day must be >= 1")
        if not 0.0 <= spec.flash_prob <= 1.0:
            raise ScenarioSpecError(f"{where}: flash_prob must be in [0, 1]")
        if spec.flash_factor < 1.0:
            raise ScenarioSpecError(f"{where}: flash_factor must be >= 1")
        if not 0.0 <= spec.drift_rate <= 1.0:
            raise ScenarioSpecError(f"{where}: drift_rate must be in [0, 1]")
        if spec.reads_per_pod < 1 or spec.quiet_epochs < 1:
            raise ScenarioSpecError(
                f"{where}: reads_per_pod/quiet_epochs must be >= 1"
            )
        if spec.max_extra_members < 0 or spec.queue_high < 1:
            raise ScenarioSpecError(
                f"{where}: max_extra_members >= 0 and queue_high >= 1 required"
            )
        if spec.wait_high_ms <= 0:
            raise ScenarioSpecError(f"{where}: wait_high_ms must be positive")
        if (spec.rss_growth_mib_per_epoch < 0 or spec.fd_growth_per_epoch < 0
                or spec.row_growth_per_epoch < 0):
            raise ScenarioSpecError(f"{where}: growth bounds must be >= 0")
        return spec

    def to_dict(self) -> dict:
        return {
            "epochs": self.epochs,
            "base_pods": self.base_pods,
            "diurnal_amplitude": self.diurnal_amplitude,
            "epochs_per_day": self.epochs_per_day,
            "flash_prob": self.flash_prob,
            "flash_factor": self.flash_factor,
            "drift_rate": self.drift_rate,
            "reads_per_pod": self.reads_per_pod,
            "scaleup": self.scaleup,
            "max_extra_members": self.max_extra_members,
            "queue_high": self.queue_high,
            "wait_high_ms": self.wait_high_ms,
            "quiet_epochs": self.quiet_epochs,
            "rss_growth_mib_per_epoch": self.rss_growth_mib_per_epoch,
            "fd_growth_per_epoch": self.fd_growth_per_epoch,
            "row_growth_per_epoch": self.row_growth_per_epoch,
        }


@dataclass(frozen=True)
class ScenarioSpec:
    name: str
    description: str = ""
    seed: int = 7
    pods: int = 4
    corpus: tuple = ()
    phases: tuple = ()
    faults: tuple = ()
    slo: SloBudget = field(default_factory=SloBudget)
    soak: Optional[SoakSpec] = None

    @classmethod
    def from_dict(cls, data: dict) -> "ScenarioSpec":
        if "scenario" not in data:
            raise ScenarioSpecError("spec needs a [scenario] table")
        sc = dict(data["scenario"])
        extra = set(data) - {"scenario"}
        if extra:
            raise ScenarioSpecError(f"unknown top-level tables {sorted(extra)}")
        _only_keys(
            sc,
            {"name", "description", "seed", "pods", "corpus", "phases",
             "faults", "slo", "soak"},
            "[scenario]",
        )
        if not sc.get("name"):
            raise ScenarioSpecError("[scenario]: needs a name")
        phases_raw = sc.get("phases", [])
        if not phases_raw:
            raise ScenarioSpecError("[scenario]: needs at least one [[scenario.phases]]")
        corpus = tuple(
            CorpusSpec.from_dict(c, i) for i, c in enumerate(sc.get("corpus", []))
        )
        ids = [c.id for c in corpus]
        if len(set(ids)) != len(ids):
            raise ScenarioSpecError(f"[scenario]: duplicate corpus ids in {ids}")
        phases = tuple(PhaseSpec.from_dict(p, i) for i, p in enumerate(phases_raw))
        for i, p in enumerate(phases):
            missing = set(p.corpus) - set(ids)
            if missing:
                raise ScenarioSpecError(
                    f"[[scenario.phases]] #{i}: corpus refs {sorted(missing)} "
                    "name no [[scenario.corpus]] entry"
                )
        faults = tuple(
            FaultSpec.from_dict(f, i, len(phases))
            for i, f in enumerate(sc.get("faults", []))
        )
        spec = cls(
            name=sc["name"],
            description=sc.get("description", ""),
            seed=int(sc.get("seed", 7)),
            pods=int(sc.get("pods", 4)),
            corpus=corpus,
            phases=phases,
            faults=faults,
            slo=SloBudget.from_dict(sc.get("slo", {})),
            soak=(SoakSpec.from_dict(sc["soak"]) if "soak" in sc else None),
        )
        if spec.pods < 1:
            raise ScenarioSpecError("[scenario]: pods must be >= 1")
        return spec

    def corpus_by_id(self, cid: str) -> CorpusSpec:
        for c in self.corpus:
            if c.id == cid:
                return c
        raise KeyError(cid)

    def to_dict(self) -> dict:
        sc = {
            "name": self.name,
            "description": self.description,
            "seed": self.seed,
            "pods": self.pods,
            "corpus": [c.to_dict() for c in self.corpus],
            "phases": [p.to_dict() for p in self.phases],
            "faults": [f.to_dict() for f in self.faults],
            "slo": self.slo.to_dict(),
        }
        if self.soak is not None:
            sc["soak"] = self.soak.to_dict()
        return {"scenario": sc}


def loads(text: str) -> ScenarioSpec:
    try:
        data = tomllib.loads(text)
    except Exception as e:  # tomllib.TOMLDecodeError (tomli variant differs)
        raise ScenarioSpecError(f"spec is not valid TOML: {e}") from e
    return ScenarioSpec.from_dict(data)


def load_spec(path: str) -> ScenarioSpec:
    with open(path, "r", encoding="utf-8") as f:
        return loads(f.read())


def list_specs(spec_dir: str) -> list[tuple[str, Optional[ScenarioSpec], str]]:
    """``(path, spec-or-None, error)`` for every ``*.toml`` in a spec dir
    (``ntpuctl scenario``'s catalog view; a broken spec lists its error
    instead of disappearing)."""
    out = []
    try:
        names = sorted(os.listdir(spec_dir))
    except OSError:
        return out
    for name in names:
        if not name.endswith(".toml"):
            continue
        path = os.path.join(spec_dir, name)
        try:
            out.append((path, load_spec(path), ""))
        except (ScenarioSpecError, OSError) as e:
            out.append((path, None, str(e)))
    return out
