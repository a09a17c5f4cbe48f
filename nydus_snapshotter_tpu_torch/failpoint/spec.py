"""Failpoint spec grammar and action model.

A spec string arms one or more named fault sites::

    transport.fetch_blob=error(HTTPError:503)%0.5;daemon.spawn=delay(0.2);metastore.commit=panic

Grammar (informal)::

    SPECS  := SITE '=' ACTION (';' SITE '=' ACTION)*
    ACTION := KIND ['(' ARG ')'] ['%' PROB] ['*' COUNT]
    KIND   := 'error' | 'delay' | 'panic' | 'off'

``error(ExcName[:detail])`` raises the named exception at the site —
builtins (``OSError``, ``TimeoutError``, ``ConnectionResetError``, …),
``HTTPError:<code>`` from the registry client, or any
:mod:`nydus_snapshotter_tpu_torch.utils.errdefs` class; unknown names fall back
to ``RuntimeError``. ``delay(seconds)`` sleeps. ``panic`` raises
:class:`Panic`, which derives from ``BaseException`` so ordinary
``except Exception`` recovery code cannot swallow it (Go-panic
semantics). ``%p`` fires with probability ``p``; ``*n`` disarms the site
after ``n`` firings. ``off`` is accepted and ignored (spec-level way to
comment out one site).
"""

from __future__ import annotations

import builtins
import re
from dataclasses import dataclass
from typing import Optional

_KINDS = ("error", "delay", "panic", "off")

_ACTION_RE = re.compile(
    r"^(?P<kind>[a-z]+)"
    r"(?:\((?P<arg>[^)]*)\))?"
    r"(?:%(?P<prob>[0-9.]+))?"
    r"(?:\*(?P<count>[0-9]+))?$"
)


class Panic(BaseException):
    """Injected panic — intentionally not an Exception subclass."""


class SpecError(ValueError):
    pass


@dataclass
class Action:
    kind: str
    arg: str = ""
    prob: Optional[float] = None
    count: Optional[int] = None  # remaining shots; None = unlimited

    def __str__(self) -> str:
        s = self.kind
        if self.arg:
            s += f"({self.arg})"
        if self.prob is not None:
            s += f"%{self.prob:g}"
        if self.count is not None:
            s += f"*{self.count}"
        return s


def parse_action(text: str) -> Action:
    m = _ACTION_RE.match(text.strip())
    if m is None:
        raise SpecError(f"unparsable failpoint action {text!r}")
    kind = m.group("kind")
    if kind not in _KINDS:
        raise SpecError(f"unknown failpoint action kind {kind!r} in {text!r}")
    prob = None
    if m.group("prob") is not None:
        try:
            prob = float(m.group("prob"))
        except ValueError as e:
            raise SpecError(f"bad probability in {text!r}: {e}") from None
        if not 0.0 <= prob <= 1.0:
            raise SpecError(f"probability out of [0,1] in {text!r}")
    count = int(m.group("count")) if m.group("count") is not None else None
    arg = m.group("arg") or ""
    if kind == "delay":
        try:
            float(arg)
        except ValueError:
            raise SpecError(f"delay needs a numeric argument, got {arg!r}") from None
    return Action(kind=kind, arg=arg, prob=prob, count=count)


def parse_spec(spec: str) -> dict[str, Action]:
    """``site=action;site=action`` → {site: Action}; empty items tolerated."""
    out: dict[str, Action] = {}
    for item in spec.split(";"):
        item = item.strip()
        if not item:
            continue
        site, sep, action = item.partition("=")
        site = site.strip()
        if not sep or not site:
            raise SpecError(f"failpoint item {item!r} is not 'site=action'")
        act = parse_action(action)
        if act.kind != "off":
            out[site] = act
    return out


def build_error(arg: str, site: str) -> BaseException:
    """Construct the exception described by an ``error(...)`` argument."""
    name, _, detail = arg.partition(":")
    name = name.strip() or "RuntimeError"
    detail = detail.strip()
    if name == "HTTPError":
        from nydus_snapshotter_tpu_torch.remote.registry import HTTPError

        try:
            code = int(detail or 503)
        except ValueError:
            code = 503
        return HTTPError(code, f"failpoint://{site}")
    exc = getattr(builtins, name, None)
    if not (isinstance(exc, type) and issubclass(exc, BaseException)):
        from nydus_snapshotter_tpu_torch.utils import errdefs

        exc = getattr(errdefs, name, None)
    if isinstance(exc, type) and issubclass(exc, BaseException):
        return exc(detail or f"injected at failpoint {site}")
    return RuntimeError(f"{name}({detail}) injected at failpoint {site}")
