"""Concurrency invariant analyzer CLI (docs/static_analysis.md).

Runs the whole-package static detectors of :mod:`..analysis` in seconds:

    python -m nydus_snapshotter_tpu_torch.cmd.analyze                  # report everything
    python -m nydus_snapshotter_tpu_torch.cmd.analyze --fail-on-new    # gate: exit 1 on findings
                                                                      # not in the baseline
    python -m nydus_snapshotter_tpu_torch.cmd.analyze --json out.json  # machine-readable findings
    python -m nydus_snapshotter_tpu_torch.cmd.analyze --write-baseline # refresh the baseline, keeping
                                                                      # existing justifications (new
                                                                      # entries get a TODO one for a
                                                                      # human to replace)

The default package is this one and the default baseline its own
``analysis/baseline.toml``; ``--package`` and ``--baseline`` point the
detectors at another package of the same repository.

Detectors: lock-order (inter-procedural acquisition cycles/inversions),
blocking-under-lock (incl. failpoint-injectable sites), and the four
drift gates (metrics/config/failpoints/trace-carry). The runtime lockset
race detector is separate: set NTPU_ANALYZE=1 and run the stress suites
(see docs/static_analysis.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from nydus_snapshotter_tpu_torch.analysis import baseline as baseline_mod
from nydus_snapshotter_tpu_torch.analysis.drift import find_all_drift
from nydus_snapshotter_tpu_torch.analysis.locks import (
    find_blocking_findings,
    find_lock_order_findings,
)
from nydus_snapshotter_tpu_torch.analysis.model import Report
from nydus_snapshotter_tpu_torch.analysis.package import PackageModel

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PACKAGE = "nydus_snapshotter_tpu_torch"


def run(root: str, package: str = PACKAGE, drift: bool = True) -> Report:
    model = PackageModel(root, package)
    rep = Report()
    rep.extend(find_lock_order_findings(model))
    rep.extend(find_blocking_findings(model))
    if drift:
        rep.extend(find_all_drift(model, root))
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="repository root")
    ap.add_argument("--package", default=PACKAGE)
    ap.add_argument("--baseline", default=baseline_mod.DEFAULT_PATH)
    ap.add_argument("--fail-on-new", action="store_true",
                    help="exit non-zero when findings outside the baseline exist")
    ap.add_argument("--fail-on-stale", action="store_true",
                    help="also exit non-zero on stale baseline entries")
    ap.add_argument("--no-drift", action="store_true",
                    help="skip the drift gates (lock analysis only)")
    ap.add_argument("--json", metavar="PATH", help="write findings as JSON")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    rep = run(args.root, args.package, drift=not args.no_drift)
    total = len(rep.findings)
    baseline = baseline_mod.load_baseline(args.baseline)

    if args.write_baseline:
        merged: dict[str, str] = {}
        for f in rep.findings:
            merged[f.fingerprint] = baseline.get(
                f.fingerprint, "TODO: justify or fix"
            )
        with open(args.baseline, "w", encoding="utf-8") as fh:
            fh.write(baseline_mod.render_baseline(merged))
        print(f"wrote {len(merged)} suppressions to {args.baseline}")
        return 0

    rep.apply_baseline(baseline)
    elapsed_ms = (time.perf_counter() - t0) * 1000.0

    if args.json:
        payload = {
            "new": [vars(f) | {"fingerprint": f.fingerprint} for f in rep.findings],
            "suppressed": [f.fingerprint for f in rep.suppressed],
            "stale_suppressions": rep.stale_suppressions,
            "elapsed_ms": elapsed_ms,
        }
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2)

    for f in rep.findings:
        print(f.render())
    print(
        f"analyze: {total} findings ({len(rep.findings)} new, "
        f"{len(rep.suppressed)} baselined) in {elapsed_ms:.0f} ms"
    )
    for fid in rep.stale_suppressions:
        print(f"stale suppression (no longer matches anything): {fid}")

    if args.fail_on_new and rep.findings:
        print("FAIL: new analyzer findings — fix them or add a justified "
              "suppression to the baseline", file=sys.stderr)
        return 1
    if args.fail_on_stale and rep.stale_suppressions:
        print("FAIL: stale baseline suppressions", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
