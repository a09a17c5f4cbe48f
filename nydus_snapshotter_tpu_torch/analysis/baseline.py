"""Reviewed finding suppressions (analysis/baseline.toml).

The analyzers are heuristic and the tree contains *intentional*
blocking-under-lock (failpoint delay injection inside a planning
critical section is the point of the site) — so CI gates on **new**
findings only. Every suppression carries a human justification; an
entry without one fails the load, and entries that stop matching
anything are reported as stale so the file cannot rot.

Format::

    [[suppress]]
    id = "blocking-under-lock:pkg.mod:Class.fn:kind:desc"
    justification = "why this is intentional / safe"
"""

from __future__ import annotations

import os

from nydus_snapshotter_tpu_torch.utils.tomlcompat import tomllib

DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "baseline.toml")


class BaselineError(ValueError):
    pass


def load_baseline(path: str = DEFAULT_PATH) -> dict[str, str]:
    """{fingerprint: justification}; missing file = empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path, "rb") as f:
        data = tomllib.load(f)
    out: dict[str, str] = {}
    for i, entry in enumerate(data.get("suppress", [])):
        fid = entry.get("id", "")
        just = entry.get("justification", "").strip()
        if not fid:
            raise BaselineError(f"suppress[{i}]: missing id")
        if not just:
            raise BaselineError(
                f"suppress[{i}] ({fid}): a suppression requires a written "
                "justification"
            )
        if fid in out:
            raise BaselineError(f"duplicate suppression {fid}")
        out[fid] = just
    return out


def render_baseline(entries: dict[str, str]) -> str:
    lines = [
        "# Reviewed analyzer suppressions — cmd.analyze --fail-on-new gates",
        "# on findings NOT in this file. Every entry needs a",
        "# justification; stale entries are reported so this cannot rot.",
        "",
    ]
    for fid in sorted(entries):
        lines.append("[[suppress]]")
        lines.append(f'id = "{fid}"')
        just = entries[fid].replace("\\", "\\\\").replace('"', '\\"')
        lines.append(f'justification = "{just}"')
        lines.append("")
    return "\n".join(lines)
