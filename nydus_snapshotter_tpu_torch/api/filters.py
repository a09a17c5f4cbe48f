"""containerd filter expressions for snapshot List/Walk.

Subset of containerd's filters grammar (github.com/containerd/containerd
filters package) that snapshot walkers actually use: each filter string is
a comma-separated AND of clauses; the filter list is an OR. Clauses:

    field==value   field!=value   field~=regex   field (presence)

Fields: ``name``, ``parent``, ``kind``, ``labels.<key>`` where the key may
be quoted (``labels."containerd.io/snapshot.ref"``).
"""

from __future__ import annotations

import re
from typing import Callable, Sequence

_CLAUSE_RE = re.compile(
    r"""^\s*
    (?P<field>[A-Za-z_][\w]*(?:\.(?:"[^"]*"|[\w./-]+))?)
    \s*(?:(?P<op>==|!=|~=)\s*(?P<value>"[^"]*"|[^,]*))?\s*$""",
    re.VERBOSE,
)


def _unquote(s: str) -> str:
    s = s.strip()
    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        return s[1:-1]
    return s


def _field_value(info, field: str) -> tuple[str, bool]:
    """(value, present) of a filter field on a snapshot Info."""
    if field.startswith("labels."):
        key = _unquote(field[len("labels."):])
        labels = getattr(info, "labels", None) or {}
        if key in labels:
            return labels[key], True
        return "", False
    if field in ("name", "parent", "kind"):
        val = getattr(info, field, "")
        return str(val), val != ""
    return "", False


def _split_clauses(filter_str: str) -> list[str]:
    """Split on commas not inside quotes."""
    out, cur, in_q = [], [], False
    for ch in filter_str:
        if ch == '"':
            in_q = not in_q
            cur.append(ch)
        elif ch == "," and not in_q:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return [c for c in (s.strip() for s in out) if c]


def _compile_clause(clause: str) -> Callable[[object], bool]:
    m = _CLAUSE_RE.match(clause)
    if not m:
        raise ValueError(f"invalid filter clause {clause!r}")
    field, op, value = m.group("field"), m.group("op"), m.group("value")
    if op is None:
        return lambda info: _field_value(info, field)[1]
    val = _unquote(value or "")
    if op == "==":
        return lambda info: _field_value(info, field) == (val, True)
    if op == "!=":
        return lambda info: _field_value(info, field) != (val, True)
    rx = re.compile(val)
    return lambda info: (lambda fv: fv[1] and rx.search(fv[0]) is not None)(_field_value(info, field))


def compile_filters(filters: Sequence[str]) -> Callable[[object], bool]:
    """Predicate over Info: OR of filter strings, AND of clauses. An empty
    filter list matches everything (containerd semantics)."""
    if not filters:
        return lambda _info: True
    alternatives: list[list[Callable[[object], bool]]] = []
    for f in filters:
        clauses = [_compile_clause(c) for c in _split_clauses(f)]
        alternatives.append(clauses)
    return lambda info: any(all(c(info) for c in clauses) for clauses in alternatives)
