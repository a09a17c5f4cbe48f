"""Concurrency invariant analysis: static lock/blocking/drift detectors
plus an opt-in runtime lockset race detector.

Every plane of this snapshotter is concurrent — the convert pipeline,
the fetch scheduler's flight table, the WAL metastore writer, the
lock-striped trace ring, the lock-free dict probes. All of it is verified
*dynamically*, by storms that cannot explore every interleaving on a
small box. This package is the static correctness layer that runs
on every commit in milliseconds:

- :mod:`.package` — whole-package AST model: modules, classes, resolved
  lock objects (``with self._lock`` / ``Condition(lock)`` aliasing /
  ``acquire()``), per-function held-set walks and a best-effort call
  graph;
- :mod:`.locks` — the **lock-order analyzer** (inter-procedural lock
  acquisition graph; cycles and order inversions are potential
  deadlocks) and the **blocking-under-lock lint** (locks held across
  ``queue.put/get``, socket I/O, ``subprocess``, ``Future.result``,
  ``Thread.join``, sleeps, semaphore waits and failpoint-injectable
  sites);
- :mod:`.drift` — **drift gates** keeping the four hand-maintained
  catalogs honest: emitted ``ntpu_*`` metrics vs docs, ``[section]``
  config keys vs ``docs/configure.md`` / ``misc/snapshotter/config.toml``
  / their ``NTPU_*`` env overrides, failpoint sites fired vs
  ``failpoint.KNOWN_SITES`` vs ``docs/robustness.md`` vs chaos-test
  coverage, and thread-pool submissions of traced work vs explicit
  trace-context carry;
- :mod:`.baseline` — reviewed suppression list (every entry carries a
  justification); ``python -m nydus_snapshotter_tpu_torch.cmd.analyze
  --fail-on-new`` gates on *new* findings only. This package's own
  baseline is ``analysis/baseline.toml`` beside this file;
- :mod:`.runtime` — the opt-in (``NTPU_ANALYZE=1``) Eraser-style
  lockset race detector: instrumented lock wrappers + ``shared()``
  annotations on the hot shared structures, run under the existing
  stress/storm suites.

Entry point: ``python -m nydus_snapshotter_tpu_torch.cmd.analyze``
(docs/static_analysis.md describes the detectors).
"""

from nydus_snapshotter_tpu_torch.analysis.model import Finding  # noqa: F401
