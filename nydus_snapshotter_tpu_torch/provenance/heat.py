"""The ``.heat`` prefetch artifact: observed read heat, closed-loop.

The reference's ``tools/optimizer-server`` records what a workload
actually touched and feeds it back as the next deploy's prefetch list.
This module is that loop for the ledger: :func:`compile_heat` distills a
blob's first-touch read extents (provenance/ledger.py, access order
preserved) into a persisted, checksummed ``<blob_id>.heat`` artifact,
and the daemon's prefetch path replays it — in heat order, under a byte
budget — instead of walking the bootstrap file list, so the second
deploy of an image fetches only what the first one actually read.

The artifact follows the exact torn-write discipline of
``.soci.idx`` (soci/index.py): placeholder header -> payload -> fsync
-> real header (with the payload sha256) -> fsync -> rename, so a crash
at any point leaves either the old artifact or a detectably-invalid
one. ``.heat`` is a GC companion suffix (cache/manager.py): it is
accounted, aged and watermark-evicted with the blob it describes. A
corrupt or torn artifact is deleted on load and recompiled once from
the live ledger — never trusted, never fatal.

Replication rides the peer artifact plane (daemon/peer.py): compiled
artifacts register under :data:`ARTIFACT_KIND` and a cold node adopts a
neighbour's heat before falling back to bootstrap-order prefetch.
Chaos sites: ``prov.compile`` (compilation/persist boundary) and
``prov.adopt`` (peer-adoption boundary) — both degrade to "no heat",
which degrades to the bootstrap prefetch the daemon always had.
"""

from __future__ import annotations

import hashlib
import logging
import os
import struct
from typing import Callable, Optional

from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch.metrics.registry import Counter

from . import ledger as _ledger

logger = logging.getLogger(__name__)

#: Suffix of the artifact next to the blob's cache companions.
HEAT_SUFFIX = ".heat"
#: Kind under which the artifact registers on the peer artifact plane.
ARTIFACT_KIND = "heat"

_MAGIC = b"NTPUHEAT"
_VERSION = 1
# magic, version, n_extents, payload_len, source_size (staleness pin),
# read_bytes, payload sha256, blob_id (64 hex, space padded), reserved.
_HEADER = struct.Struct("<8sIIQQQ32s64s12s")
_EXTENT = struct.Struct("<QI")

HEAT_EVENTS = Counter(
    "ntpu_prov_heat_events_total",
    "Heat-artifact store events by outcome "
    "(compiled/loaded/adopted/corrupt/stale/error/missing)",
    ("outcome",),
)
HEAT_BYTES = Counter(
    "ntpu_prov_heat_bytes_total",
    "Bytes of .heat prefetch artifacts written",
)


class HeatError(Exception):
    """A .heat artifact failed validation (torn, corrupt, or foreign)."""


def heat_path(cache_dir: str, blob_id: str) -> str:
    return os.path.join(cache_dir, blob_id + HEAT_SUFFIX)


class HeatArtifact:
    """An ordered, budgeted prefetch list distilled from observed reads.

    ``extents`` is the first-touch access order — replaying it front to
    back warms bytes in the order the previous deploy needed them, so
    even a budget-truncated replay warms the critical prefix first.
    """

    def __init__(
        self,
        blob_id: str,
        extents: list[tuple[int, int]],
        source_size: int = 0,
        read_bytes: int = 0,
    ):
        self.blob_id = blob_id
        self.extents = list(extents)
        self.source_size = int(source_size)
        self.read_bytes = int(read_bytes) or sum(s for _, s in self.extents)

    def total_bytes(self) -> int:
        return sum(size for _, size in self.extents)

    # -- serialization (the .soci.idx torn-write discipline) -------------

    def _payload(self) -> bytes:
        return b"".join(
            _EXTENT.pack(off, size) for off, size in self.extents
        )

    def to_bytes(self) -> bytes:
        payload = self._payload()
        header = _HEADER.pack(
            _MAGIC,
            _VERSION,
            len(self.extents),
            len(payload),
            self.source_size,
            self.read_bytes,
            hashlib.sha256(payload).digest(),
            self.blob_id.encode()[:64].ljust(64),
            b"\x00" * 12,
        )
        return header + payload

    def save(self, path: str) -> int:
        """Atomic persist: placeholder header, payload, fsync, then the
        real checksummed header, fsync, rename — a torn write is always
        detectable, never half-trusted."""
        payload = self._payload()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(b"\x00" * _HEADER.size)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
            f.seek(0)
            f.write(self.to_bytes()[: _HEADER.size])
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
        return _HEADER.size + len(payload)

    @classmethod
    def from_bytes(
        cls, raw: bytes, blob_id: str = "", source_size: int = 0
    ) -> "HeatArtifact":
        if len(raw) < _HEADER.size:
            raise HeatError(f"truncated heat artifact ({len(raw)} bytes)")
        (
            magic,
            version,
            n_extents,
            payload_len,
            src_size,
            read_bytes,
            digest,
            bid_raw,
            _reserved,
        ) = _HEADER.unpack_from(raw, 0)
        if magic != _MAGIC:
            raise HeatError("bad magic (torn or foreign file)")
        if version != _VERSION:
            raise HeatError(f"unsupported heat version {version}")
        payload = raw[_HEADER.size :]
        if len(payload) != payload_len:
            raise HeatError(
                f"payload length {len(payload)} != header {payload_len}"
            )
        if hashlib.sha256(payload).digest() != digest:
            raise HeatError("payload checksum mismatch")
        bid = bid_raw.rstrip(b" \x00").decode(errors="replace")
        if blob_id and bid and bid != blob_id[:64]:
            raise HeatError(f"heat artifact belongs to blob {bid[:12]}…")
        if source_size and src_size and src_size != source_size:
            raise HeatError(
                f"stale heat artifact (source {src_size} != {source_size})"
            )
        if payload_len != n_extents * _EXTENT.size:
            raise HeatError("extent count disagrees with payload length")
        extents = [
            _EXTENT.unpack_from(payload, i)
            for i in range(0, payload_len, _EXTENT.size)
        ]
        return cls(
            bid or blob_id,
            extents,
            source_size=src_size,
            read_bytes=read_bytes,
        )

    @classmethod
    def load(
        cls, path: str, blob_id: str = "", source_size: int = 0
    ) -> "HeatArtifact":
        with open(path, "rb") as f:
            raw = f.read()
        return cls.from_bytes(raw, blob_id=blob_id, source_size=source_size)


# ---------------------------------------------------------------------------
# Compiler + store waterfall
# ---------------------------------------------------------------------------


def compile_heat(
    blob_id: str, cache_dir: str, source_size: int = 0
) -> Optional[HeatArtifact]:
    """Distill the ledger's first-touch heat for ``blob_id`` into a
    persisted artifact; returns None (and warms nothing less than
    before) when there is no heat, heat is disabled, or the
    ``prov.compile`` chaos site fires — compilation is an optimization,
    never an obligation."""
    cfg = _ledger.config()
    if not (cfg.enable and cfg.heat):
        return None
    extents = _ledger.heat_extents(blob_id)
    if not extents:
        return None
    try:
        failpoint.hit("prov.compile")
        art = HeatArtifact(
            blob_id, extents, source_size=source_size
        )
        n = art.save(heat_path(cache_dir, blob_id))
        HEAT_EVENTS.labels("compiled").inc()
        HEAT_BYTES.inc(n)
        return art
    except Exception:  # noqa: BLE001 — degrade to no artifact
        HEAT_EVENTS.labels("error").inc()
        logger.warning("heat compile for %s failed", blob_id[:12],
                       exc_info=True)
        return None


def find_heat(
    dirs: list[str], blob_id: str, source_size: int = 0
) -> Optional[HeatArtifact]:
    """First valid local artifact across ``dirs``. A corrupt, torn or
    stale file is DELETED on sight (the compiler rebuilds it once from
    the live ledger at the next close) — never served."""
    for d in dirs:
        path = heat_path(d, blob_id)
        if not os.path.exists(path):
            continue
        try:
            art = HeatArtifact.load(
                path, blob_id=blob_id, source_size=source_size
            )
            HEAT_EVENTS.labels("loaded").inc()
            return art
        except (HeatError, OSError):
            HEAT_EVENTS.labels("corrupt").inc()
            logger.warning(
                "deleting invalid heat artifact %s", path, exc_info=True
            )
            try:
                os.remove(path)
            except OSError:
                pass
    return None


def load_or_adopt_heat(
    dirs: list[str],
    blob_id: str,
    source_size: int = 0,
    fetch_remote: Optional[Callable[[], bytes]] = None,
    persist: bool = True,
) -> Optional[HeatArtifact]:
    """The store waterfall (mirrors soci/blob.load_or_build_index):
    local dirs -> peer replication -> None. An adopted payload is
    revalidated through :meth:`HeatArtifact.from_bytes` before it is
    trusted or persisted; the ``prov.adopt`` chaos site aborts adoption
    (falling back to bootstrap prefetch), never the mount."""
    art = find_heat(dirs, blob_id, source_size=source_size)
    if art is not None:
        return art
    if fetch_remote is not None:
        try:
            failpoint.hit("prov.adopt")
            raw = fetch_remote()
            if raw:
                art = HeatArtifact.from_bytes(
                    raw, blob_id=blob_id, source_size=source_size
                )
                if persist and dirs:
                    art.save(heat_path(dirs[0], blob_id))
                HEAT_EVENTS.labels("adopted").inc()
                return art
        except Exception:  # noqa: BLE001 — adoption is best-effort
            HEAT_EVENTS.labels("error").inc()
            logger.debug(
                "heat adoption for %s failed", blob_id[:12], exc_info=True
            )
    HEAT_EVENTS.labels("missing").inc()
    return None


def heat_counters() -> dict:
    """Cumulative heat-store outcomes (ntpuctl / profile deltas)."""
    return {
        k: HEAT_EVENTS.value(k)
        for k in (
            "compiled", "loaded", "adopted", "corrupt", "stale", "error",
            "missing",
        )
    }
