"""Long-soak orchestrator: a production year compressed into epochs.

The worst-day storm (:mod:`.orchestrator`) proves the stack
survives a hand-written bad afternoon; the soak proves it survives a
YEAR of ordinary ones. :class:`SoakRunner` holds the full scenario
stack — snapshot control plane, blobcache/peer data plane, GC, SLO
judge, soci arm, whatever the template phases enable — under continuous
convert/deploy/read/remove/GC churn across N **epochs**, where each
epoch is one wave of the seeded arrival process (:mod:`.arrivals`) over
a corpus aged by the drift model (:mod:`.evolution`):

1. ``soak.wave`` fires; the wave's pod count is the deterministic
   Poisson × diurnal × flash-crowd draw for ``(seed, epoch)``.
2. ``soak.evolve`` fires; the real-tree corpora are re-materialized at
   this epoch's generations and re-converted — the chunk-dict/zdict
   planes age exactly as registries do in production.
3. The wave deploys (template deploy phase, pods from the wave), demand
   reads run, a deterministic fraction is removed, GC sweeps.
4. The scale-up policy (:class:`~nydus_snapshotter_tpu_torch.metrics.slo.
   SloScaleUp`) ticks on the wave's demand-pressure signal: clean burn
   but growing queues spawns serve-only peer members for the NEXT wave
   (``extra_serve_pods``), quiet retires them. A failed spawn degrades
   to shed-only — pinned by the ``soak.scaleup`` chaos suite.
5. Leak sentinels sample (RSS, fds, threads, metastore rows, cache
   entries, trace drops) and the end-state :meth:`~.orchestrator.
   ScenarioRunner.audit` runs — ANY audit issue or fitted growth-bound
   violation fails the epoch loudly.

Identity: every epoch's corpus, wave and read set are pure functions of
``(seed, epoch)``, so :meth:`SoakRunner.replay_epoch` re-runs one epoch
in a fresh serial runner and must reproduce the epoch's read digests
and blob ids byte-for-byte — the spot-check gate (full-run identity
stays the worst-day gate's job; a soak's value is the *churn*, not a
30-minute serial oracle). ``device`` (passed through to
:class:`~.orchestrator.ScenarioRunner`) is where the dict-service arms
run: CUDA unless the caller asks for the CPU.

Config: ``[soak]`` with ``NTPU_SOAK*`` env overrides (epochs/report
path); the per-spec knobs live in ``[scenario.soak]`` (spec.py).
"""

from __future__ import annotations

import os
import time
from dataclasses import replace as _dc_replace
from typing import Optional

from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch.scenario import arrivals, corpus as corpus_gen, evolution
from nydus_snapshotter_tpu_torch.scenario.orchestrator import (
    ScenarioRunError,
    ScenarioRunner,
)
from nydus_snapshotter_tpu_torch.scenario.sentinel import SentinelSeries
from nydus_snapshotter_tpu_torch.scenario.spec import PhaseSpec, ScenarioSpec

# Phase-index namespace per epoch: epoch e's convert/deploy/remove/gc
# phases run as indices BASE + e*STRIDE + {0,1,2,3}, so snapshot keys,
# pod dirs and read-digest tags never collide across epochs (and a
# replayed epoch lands on identical tags).
EPOCH_IDX_BASE = 100
EPOCH_IDX_STRIDE = 10

# Node admission ceiling for the concurrent soak: every demand read of a
# wave passes one shared per-epoch gate, so a flash crowd queues where a
# real cluster's does — at the serving tier's concurrency limit — and
# the demand-pressure signal (queued_peak / wait EWMA) actually moves.
# Each serve-only member the scale-up policy spawns brings its uplink:
# +SLOTS_PER_MEMBER admission slots for the NEXT wave. That is the
# closed loop the A/B efficacy gate measures.
NODE_SLOTS = 8
SLOTS_PER_MEMBER = 4


class SoakRuntimeConfig:
    __slots__ = ("epochs", "spot_epochs", "report_path")

    def __init__(self, epochs: int, spot_epochs: int, report_path: str):
        self.epochs = epochs
        self.spot_epochs = spot_epochs
        self.report_path = report_path


def _global_soak_config():
    try:
        from nydus_snapshotter_tpu_torch.config import config as _cfg

        return _cfg.get_global_config().soak
    except Exception:
        return None


def resolve_soak_config() -> SoakRuntimeConfig:
    """env (``NTPU_SOAK*``) > ``[soak]`` global config > defaults.

    ``epochs`` 0 means "use the spec's ``[scenario.soak]`` value";
    ``spot_epochs`` is how many epochs the profile replays serially for
    the identity spot-check."""
    from nydus_snapshotter_tpu_torch.daemon.fetch_sched import _env_int

    sc = _global_soak_config()
    repo = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    report_path = os.environ.get(
        "NTPU_SOAK_REPORT",
        getattr(sc, "report_path", "") or os.path.join(repo, "SOAK_r01.json"),
    )
    return SoakRuntimeConfig(
        epochs=max(0, _env_int("NTPU_SOAK_EPOCHS", getattr(sc, "epochs", 0))),
        spot_epochs=max(
            1, _env_int("NTPU_SOAK_SPOT_EPOCHS", getattr(sc, "spot_epochs", 2))
        ),
        report_path=report_path,
    )


class SoakRunner(ScenarioRunner):
    """Drive a spec's ``[scenario.soak]`` endurance loop.

    Reuses every phase primitive of :class:`ScenarioRunner`; what the
    soak adds is the epoch loop, the corpus-evolution override of
    :meth:`_corpus_tar`, the leak sentinels and the closed-loop
    capacity policy. ``serial=True`` gives the replay shape (pods
    sequential, peers off, no scale-up) used for identity spot-checks.
    """

    def __init__(
        self,
        spec: ScenarioSpec,
        workdir: str,
        serial: bool = False,
        epochs: Optional[int] = None,
        **kw,
    ):
        if spec.soak is None:
            raise ScenarioRunError(
                f"spec {spec.name!r} has no [scenario.soak] table"
            )
        super().__init__(spec, workdir, serial=serial, **kw)
        self.soak = spec.soak
        self.epochs = epochs if epochs else self.soak.epochs
        self.epoch = 0
        self.waves: list[dict] = []
        self.epoch_reports: list[dict] = []
        # Warm-up exclusion and evidence window scale with run length: a
        # full-size soak spends its first ~4 epochs compiling per-shape
        # convert kernels and filling allocator pools (measured RSS
        # plateaus around epoch 5 at full scale) — ramp, not leak —
        # and the allocator keeps taking one-off ~50 MiB pool steps at
        # arbitrary later epochs. A leak is MONOTONE growth, so the fit
        # only fires once the post-warmup window is wide enough that a
        # single step dilutes below the per-epoch bound (8+ samples:
        # a 54 MiB step reads as <8 MiB/epoch, a real 30 MiB/epoch leak
        # still reads as 30). Short smoke runs keep the tight window so
        # their sentinel gate still fires inside CI walls.
        warmup = 1 if self.epochs <= 4 else 4
        min_samples = 3 if self.epochs <= 4 else 12
        self.sentinel = SentinelSeries({
            "rss_bytes": self.soak.rss_growth_mib_per_epoch * (1 << 20),
            "open_fds": self.soak.fd_growth_per_epoch,
            "metastore_rows": self.soak.row_growth_per_epoch,
        }, warmup=warmup, min_samples=min_samples)
        self.scaleup = None  # built in run_soak (concurrent mode only)

    # -- corpus evolution ----------------------------------------------------

    def _corpus_tar(self, cid: str) -> bytes:
        """Real-tree corpora age with the drift model; synthetic kinds
        stay frozen (their value is the adversarial shape, not realism).
        Epoch 0 is byte-identical to the base runner's corpus."""
        cs = self.spec.corpus_by_id(cid)
        if cs.kind in ("real_tree", "real_tree2") and self.epoch > 0:
            manifest = corpus_gen.load_manifest(
                corpus_gen.MANIFEST_TREE1 if cs.kind == "real_tree"
                else corpus_gen.MANIFEST_TREE2
            )
            return corpus_gen.members_to_tar(
                evolution.evolved_members(
                    manifest, self.spec.seed, self.soak.drift_rate, self.epoch
                )
            )
        return super()._corpus_tar(cid)

    # -- template phases -----------------------------------------------------

    def _template(self, op: str) -> Optional[PhaseSpec]:
        for p in self.spec.phases:
            if p.op == op:
                return p
        return None

    def _epoch_phases(self, wave) -> list[tuple[str, PhaseSpec]]:
        """The four-phase churn program for one wave, derived from the
        spec's template phases (first of each op; convert/deploy are
        synthesized over all corpora when the spec has none)."""
        all_ids = tuple(c.id for c in self.spec.corpus)
        conv = self._template("convert") or PhaseSpec(op="convert", corpus=all_ids)
        dep = self._template("deploy") or PhaseSpec(op="deploy", corpus=all_ids)
        # Default remove fraction is 1.0 (not the storm's 0.5): a soak
        # epoch must return to steady state or the metastore-row growth
        # bound trips on perfectly healthy runs.
        rem = self._template("remove") or PhaseSpec(op="remove", fraction=1.0)
        gc = self._template("gc") or PhaseSpec(op="gc")
        return [
            ("convert", conv),
            ("deploy", _dc_replace(dep, pods=wave.pods)),
            ("remove", rem),
            ("gc", gc),
        ]

    # -- the epoch loop ------------------------------------------------------

    def _node_gate_for(self, e: int):
        """This epoch's node admission ceiling: base slots plus the
        uplink each live serve-only member contributes. Fresh per epoch
        so queued_peak / wait EWMA describe ONE wave, not the year."""
        from nydus_snapshotter_tpu_torch.daemon.fetch_sched import (
            AdmissionGate,
            MemoryBudget,
        )

        slots = NODE_SLOTS + SLOTS_PER_MEMBER * self.extra_serve_pods
        return AdmissionGate(
            budget=MemoryBudget(slots * (1 << 20)),
            max_concurrent=slots,
            demand_reserve=0,
            name=f"soak-node-e{e}",
        )

    def _run_epoch(self, e: int) -> dict:
        failpoint.hit("soak.wave")
        wave = arrivals.wave_for(self.soak, self.spec.seed, e)
        self.epoch = e
        self.waves.append(wave.to_dict())
        if not self.serial and not self.pods_sequential:
            self.node_gate = self._node_gate_for(e)
        base = EPOCH_IDX_BASE + e * EPOCH_IDX_STRIDE
        detail: dict = {"epoch": e, "wave": wave.to_dict()}
        t0 = time.perf_counter()
        for k, (op, phase) in enumerate(self._epoch_phases(wave)):
            if op == "convert":
                failpoint.hit("soak.evolve")
            dispatch = {
                "convert": self._phase_convert,
                "deploy": self._phase_deploy,
                "remove": self._phase_remove,
                "gc": self._phase_gc,
            }
            detail[op] = dispatch[op](base + k, phase)
        detail["wall_s"] = round(time.perf_counter() - t0, 4)
        # Registry GC: drop blob bytes from retired corpus generations
        # (ids stay known for audit accounting) — a year of evolution
        # must not read as an RSS leak in the sim's own origin.
        live = {img["blob_id"] for img in self.images.values()}
        detail["retired_blobs"] = self.registry.retire_except(live)
        detail["demand_pressure"] = dict(self.last_demand_pressure)
        detail["extra_serve_pods"] = self.extra_serve_pods
        if self.scaleup is not None:
            event = self.scaleup.tick()
            if event is not None:
                detail["scaleup_event"] = event
        aud = self.audit()
        detail["audit"] = {
            "clean": aud["clean"],
            "issues": aud["issues"][:8],
            "metastore_rows": aud["metastore_rows"],
            "cache_files": aud["cache_files"],
        }
        self.sentinel.sample({
            "metastore_rows": aud["metastore_rows"],
            "cache_entries": aud["cache_files"],
        })
        if not aud["clean"]:
            raise ScenarioRunError(
                f"epoch {e}: audit drift — {aud['issues'][:4]}"
            )
        leaks = self.sentinel.check()
        if leaks:
            raise ScenarioRunError(f"epoch {e}: {leaks[0]}")
        detail["fingerprint"] = self.epoch_fingerprint(e)
        self.epoch_reports.append(detail)
        return detail

    def epoch_fingerprint(self, e: int) -> dict:
        """One epoch's identity surface: the wave's read digests plus
        the epoch's converted blob ids — everything a standalone serial
        replay of the same epoch must reproduce byte-for-byte."""
        tag = f"ph{EPOCH_IDX_BASE + e * EPOCH_IDX_STRIDE + 1}-"
        return {
            "reads": {
                k: v for k, v in sorted(self.read_digests.items())
                if k.startswith(tag)
            },
            "blobs": {
                cid: img["blob_id"]
                for cid, img in sorted(self.images.items())
                if not str(cid).startswith("soci:")
            },
        }

    def _build_scaleup(self):
        from nydus_snapshotter_tpu_torch.metrics.slo import SloScaleUp

        def spawn(target: int) -> None:
            self.extra_serve_pods = target

        def retire(target: int) -> None:
            self.extra_serve_pods = target

        def demand() -> dict:
            # The queue drains before teardown reads the gate, so the
            # live depth is ~always 0; the epoch's PEAK depth is the
            # load signal the policy should act on.
            p = dict(self.last_demand_pressure)
            p["queued"] = max(
                int(p.get("queued", 0)), int(p.get("queued_peak", 0))
            )
            return p

        return SloScaleUp(
            self._engine,
            demand_fn=demand,
            spawn_fn=spawn,
            retire_fn=retire,
            queue_high=self.soak.queue_high,
            wait_high_ms=self.soak.wait_high_ms,
            quiet_ticks=self.soak.quiet_epochs,
            max_members=self.soak.max_extra_members,
        )

    def run_soak(self) -> dict:
        """The endurance loop; returns the soak report (never raises —
        failure lands in ``ok``/``error`` like :meth:`ScenarioRunner.run`)."""
        from nydus_snapshotter_tpu_torch import scenario as _scn

        report = {
            "scenario": self.spec.name,
            "mode": "soak",
            "serial": self.serial,
            "seed": self.spec.seed,
            "epochs_planned": self.epochs,
            "epochs": [],
            "ok": True,
            "error": "",
        }
        self._open_control_plane()
        self._start_judge()
        if self.soak.scaleup and not self.serial and not self.pods_sequential:
            self.scaleup = self._build_scaleup()
        try:
            for e in range(self.epochs):
                report["epochs"].append(self._run_epoch(e))
        except BaseException as exc:  # noqa: BLE001 — the run fails loudly
            report["ok"] = False
            report["error"] = f"epoch {len(report['epochs'])}: {exc!r}"
        finally:
            self._stop_judge()
        if self._engine is not None:
            status = self._engine.status()
            breaches = status.get("breaches", [])
            report["slo"] = {
                "breaches": len(breaches),
                "demand_p95_ms": self.demand_p95_ms(),
            }
            if breaches and report["ok"]:
                report["ok"] = False
                report["error"] = (
                    f"SLO judge: {len(breaches)} multi-window burn "
                    "breach(es) across the soak"
                )
        report["waves"] = list(self.waves)
        report["sentinel"] = self.sentinel.report()
        if report["sentinel"]["issues"] and report["ok"]:
            report["ok"] = False
            report["error"] = report["sentinel"]["issues"][0]
        if self.scaleup is not None:
            report["scaleup"] = self.scaleup.state()
        report["origin"] = {
            "egress_bytes": self.registry.egress,
            "calls": self.registry.calls,
        }
        _scn.RUNS_TOTAL.labels("pass" if report["ok"] else "fail").inc()
        return report


def replay_epoch(
    spec: ScenarioSpec,
    epoch: int,
    workdir: str,
    serial: bool = True,
    extra_serve_pods: int = 0,
    **kw,
) -> dict:
    """Standalone re-run of ONE soak epoch in a fresh runner; returns
    ``{"fingerprint", "demand_pressure", "demand_p95_ms", "ok"}``.

    With ``serial=True`` this is the identity oracle: the epoch's corpus
    and wave are pure functions of ``(seed, epoch)``, so the replay's
    fingerprint must equal the soak's record for that epoch. With
    ``serial=False`` it is the capacity A/B arm: same epoch, chosen
    ``extra_serve_pods``, compare demand pressure — pass the soak's
    ``origin_latency_s`` so both arms sit on the same analytic latency
    floor the soak measured against."""
    runner = SoakRunner(spec, workdir, serial=serial, epochs=1, **kw)
    runner._open_control_plane()
    runner._start_judge()
    runner.extra_serve_pods = 0 if serial else max(0, int(extra_serve_pods))
    try:
        detail = runner._run_epoch(epoch)
        return {
            "fingerprint": detail["fingerprint"],
            "demand_pressure": detail["demand_pressure"],
            "demand_p95_ms": runner.demand_p95_ms(),
            "ok": True,
        }
    finally:
        runner._stop_judge()
        runner.close()
