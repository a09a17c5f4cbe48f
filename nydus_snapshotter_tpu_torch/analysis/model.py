"""Finding model shared by every detector.

A finding's **fingerprint** deliberately excludes line numbers: the
baseline (analysis/baseline.toml) must survive unrelated edits to the
same file, so identity is ``detector:module:qualname:detail`` — the
detail key is chosen by each detector to be stable (lock names, metric
names, callee names), never positions.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Finding:
    detector: str  # lock-order | blocking-under-lock | drift-* | lockset
    module: str  # dotted module (or catalog file) the finding lives in
    qualname: str  # enclosing function/class, or catalog entry
    detail: str  # stable identity tail (lock pair, metric name, ...)
    message: str  # human-readable explanation
    lineno: int = 0
    severity: str = "error"  # error | warn

    @property
    def fingerprint(self) -> str:
        return f"{self.detector}:{self.module}:{self.qualname}:{self.detail}"

    def render(self) -> str:
        loc = f"{self.module}:{self.lineno}" if self.lineno else self.module
        return f"[{self.detector}] {loc} {self.qualname}: {self.message}"


@dataclass
class Report:
    """All findings from one analyzer run + baseline partition."""

    findings: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    stale_suppressions: list[str] = field(default_factory=list)

    def extend(self, fs: list[Finding]) -> None:
        self.findings.extend(fs)

    def apply_baseline(self, baseline: dict[str, str]) -> None:
        """Partition findings into new vs suppressed; record baseline
        entries that no longer match anything (stale)."""
        matched: set[str] = set()
        new: list[Finding] = []
        for f in self.findings:
            if f.fingerprint in baseline:
                matched.add(f.fingerprint)
                self.suppressed.append(f)
            else:
                new.append(f)
        self.findings = new
        self.stale_suppressions = sorted(set(baseline) - matched)
