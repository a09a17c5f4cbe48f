"""Per-layer format routing for the lazy-read plane.

The resolver path (snapshot/snapshotter.py → soci/adaptor.py) asks one
question per layer: *cheapest way to make this blob lazily readable?*
:class:`FormatRouter` answers it from two ranged probe reads — 4 head
bytes (compression magic) and one tail read (eStargz footer /
zstd:chunked footer / seekable-zstd seek-table footer all live in the
last ≤56 bytes) — then picks among

- ``toc-adopt``     — the layer ships a TOC (eStargz or zstd:chunked):
                      adopt it as the file→extent map, zero build pass;
- ``seekable-index`` — zstd layer, frame-indexable (seek table parsed
                      for free, or frame-walked during the one
                      first-pull pass);
- ``zran-index``    — plain gzip, checkpoint-indexed (the PR-12 path);
- ``rafs-convert``  — nothing lazy applies (unknown compression, or the
                      needed decoder surface is missing): full pull +
                      conversion, the pre-soci behavior.

by **modeled cold-read cost**: origin bytes to first file read =
build-pass bytes (full blob for index builds, ~nothing for TOC
adoption) + first lazy read's fetch span. The model is closed-form and
deliberately coarse — its job is ordering, not prediction, and the
ordering is stable: a shipped TOC always beats an index build, which
always beats paying conversion on top of the same full pull.

Decisions are counted on ``ntpu_soci_route_total{backend}`` and carried
on the resolved blob (``Blob.route``) so ``ntpuctl soci`` can show why
each layer took the path it did.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Optional

from nydus_snapshotter_tpu_torch.metrics import registry as _metrics
from nydus_snapshotter_tpu_torch.soci import toc as ztoc
from nydus_snapshotter_tpu_torch.soci import zframe, zran
from nydus_snapshotter_tpu_torch.stargz import resolver as stargz_resolver
from nydus_snapshotter_tpu_torch.utils import zstd as _zstd

logger = logging.getLogger(__name__)

BACKEND_TOC_ADOPT = "toc-adopt"
BACKEND_SEEKABLE = "seekable-index"
BACKEND_ZRAN = "zran-index"
BACKEND_RAFS = "rafs-convert"

FORMAT_GZIP = "gzip"
FORMAT_ESTARGZ = "estargz"
FORMAT_ZSTD_SEEKABLE = "zstd-seekable"
FORMAT_ZSTD_CHUNKED = "zstd-chunked"
FORMAT_ZSTD_OPAQUE = "zstd-opaque"
FORMAT_UNKNOWN = "unknown"

_GZIP_MAGIC = b"\x1f\x8b"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

# Modeled first lazy read span when the real geometry is unknown: one
# default soci stride / one default frame (both 1 MiB by convention).
_EST_READ_SPAN = 1 << 20

_reg = _metrics.default_registry
ROUTE_TOTAL = _reg.register(
    _metrics.Counter(
        "ntpu_soci_route_total",
        "FormatRouter layer routing decisions by chosen backend"
        " (toc-adopt / seekable-index / zran-index / rafs-convert)",
        ("backend",),
    )
)


def route_counts() -> dict:
    """Cumulative routing decisions per backend (the ``ntpuctl soci``
    surface)."""
    return {
        b: ROUTE_TOTAL.value(b)
        for b in (BACKEND_TOC_ADOPT, BACKEND_SEEKABLE, BACKEND_ZRAN,
                  BACKEND_RAFS)
        if ROUTE_TOTAL.value(b)
    }


@dataclass
class RouteDecision:
    backend: str
    format: str
    reason: str
    probe_bytes: int = 0
    # backend -> modeled origin bytes to first cold file read; only the
    # feasible candidates appear.
    costs: dict[str, int] = field(default_factory=dict)
    # Tail geometry the adaptor reuses so prepare never re-probes:
    # parsed seek-table entries (zstd-seekable) or the TOC manifest
    # location (zstd-chunked).
    seek_entries: Optional[list] = None
    toc_location: Optional[tuple[int, int, int]] = None

    def describe(self) -> str:
        return f"{self.backend} ({self.format}: {self.reason})"


class FormatRouter:
    """Probe a layer blob's head/tail and route it to the cheapest lazy
    backend. ``enable_zstd`` / ``enable_toc`` mirror the ``[soci]``
    config keys; switching either off removes those candidates and the
    cost model picks among what remains."""

    def __init__(self, enable_zstd: bool = True, enable_toc: bool = True):
        self.enable_zstd = enable_zstd
        self.enable_toc = enable_toc

    def route(
        self, read_at: Callable[[int, int], bytes], size: int,
        record: bool = True,
    ) -> RouteDecision:
        probe = 0

        def _read(off: int, n: int) -> bytes:
            nonlocal probe
            off = max(0, off)
            n = min(n, size - off)
            if n <= 0:
                return b""
            probe += n
            return read_at(off, n)

        head = _read(0, 4)
        tail_span = max(
            ztoc.FOOTER_SIZE, stargz_resolver.ESTARGZ_FOOTER_SIZE, 9
        )
        tail = _read(size - tail_span, tail_span)

        decision = self._decide(head, tail, size)
        decision.probe_bytes = probe
        if record:
            ROUTE_TOTAL.labels(decision.backend).inc()
        logger.debug("soci route: %s", decision.describe())
        return decision

    # -- the model -----------------------------------------------------------

    def _decide(self, head: bytes, tail: bytes, size: int) -> RouteDecision:
        # Modeled first lazy read: one stride/frame, clamped to the blob
        # (a flat 1 MiB would dwarf 2*size on small layers and invert
        # the ordering). Every candidate pays it — including conversion,
        # whose first cold read comes only after pull + full re-store —
        # so the span cancels in comparisons and the ordering is stable
        # at every blob size: shipped TOC < index build < conversion.
        span = min(_EST_READ_SPAN, max(1, size))
        costs: dict[str, int] = {BACKEND_RAFS: 2 * size + span}

        if head[:2] == _GZIP_MAGIC:
            fmt = FORMAT_GZIP
            reason = "gzip magic"
            toc_off = 0
            for fsize in (stargz_resolver.ESTARGZ_FOOTER_SIZE,
                          stargz_resolver.FOOTER_SIZE):
                if fsize > len(tail):
                    continue
                off, ok = stargz_resolver.parse_footer(tail[len(tail) - fsize:])
                if ok and 0 < off < size:
                    fmt, toc_off = FORMAT_ESTARGZ, off
                    reason = "estargz footer"
                    break
            if fmt == FORMAT_ESTARGZ and self.enable_toc:
                costs[BACKEND_TOC_ADOPT] = (size - toc_off) + span
            if zran.available():
                costs[BACKEND_ZRAN] = size + span
            return self._pick(fmt, reason, costs)

        if head[:4] == _ZSTD_MAGIC or _zstd.is_skippable_frame(head):
            loc = ztoc.parse_footer(tail) if len(tail) >= ztoc.FOOTER_SIZE else None
            if loc is not None:
                fmt, reason = FORMAT_ZSTD_CHUNKED, "GnUlInUx footer"
                if self.enable_toc and _zstd.dctx_available():
                    costs[BACKEND_TOC_ADOPT] = loc[1] + span
                if self.enable_zstd and zframe.available():
                    # Frame-walking a chunked blob works too; it just
                    # pays the full pull the TOC makes unnecessary.
                    costs[BACKEND_SEEKABLE] = size + span
                return self._pick(fmt, reason, costs, toc_location=loc)

            table_size = zframe.seek_table_frame_size(tail[-9:])
            entries: Optional[list] = None
            if table_size is not None and table_size <= size:
                fmt, reason = FORMAT_ZSTD_SEEKABLE, "seek-table footer"
                if self.enable_zstd and zframe.available():
                    n = max(1, (table_size - 17) // 8)
                    frame_est = max(1, (size - table_size) // n)
                    # The table is free geometry, but the bootstrap's
                    # file map still costs the one first-pull pass.
                    costs[BACKEND_SEEKABLE] = size + min(frame_est, span)
                return self._pick(fmt, reason, costs, seek_entries=entries)

            fmt, reason = FORMAT_ZSTD_OPAQUE, "zstd magic, no TOC or seek table"
            if self.enable_zstd and zframe.available():
                costs[BACKEND_SEEKABLE] = size + span
            return self._pick(fmt, reason, costs)

        return self._pick(FORMAT_UNKNOWN, "unrecognized magic", costs)

    @staticmethod
    def _pick(
        fmt: str, reason: str, costs: dict[str, int],
        seek_entries: Optional[list] = None,
        toc_location: Optional[tuple[int, int, int]] = None,
    ) -> RouteDecision:
        backend = min(costs, key=lambda b: costs[b])
        return RouteDecision(
            backend=backend, format=fmt, reason=reason, costs=dict(costs),
            seek_entries=seek_entries, toc_location=toc_location,
        )
