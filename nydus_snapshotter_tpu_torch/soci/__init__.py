"""Seekable-OCI backend: lazy-load plain OCI layers, convert nothing.

Every other lazy path in this tree (RAFS, eStargz, tarfs) needs the image
rewritten or annotated first. This package is the backend for the
registry's millions of images that never will be: on FIRST PULL the layer
is indexed — a zran/gzip checkpoint index (inflate resume points at a
configurable stride) or a zstd frame index (one entry per independent
frame, free when the blob ships a seekable-format seek table), plus a
per-layer file→decompressed-extent map — and from then on file reads
resolve to compressed byte ranges of the ORIGINAL registry blob, fetched
through the ordinary lazy-read data plane (daemon/fetch_sched.py:
singleflight, coalescing, readahead, watermark eviction, peer tier, QoS
admission lanes). Layers that ship their own TOC (eStargz, zstd:chunked)
skip even the index build: the TOC is adopted as the extent map for zero
build-pass bytes. The index is the only new artifact; no RAFS blob is
ever written.

Modules:

- :mod:`~nydus_snapshotter_tpu_torch.soci.zran` — ctypes binding of the SYSTEM
  libz (the same discipline as utils/zstd.py): checkpoint capture with
  ``Z_BLOCK`` during one sequential inflate, bit-exact mid-stream resume
  via ``inflatePrime`` + ``inflateSetDictionary``;
- :mod:`~nydus_snapshotter_tpu_torch.soci.zframe` — the zstd counterpart on
  the SYSTEM libzstd: frame walking via ``ZSTD_findFrameCompressedSize``
  and the seekable-format seek-table parser (frames decode independently,
  so the frame table IS the random-access index — no window captures);
- :mod:`~nydus_snapshotter_tpu_torch.soci.index` — the persisted, checksummed
  ``<blob_id>.soci.idx`` artifact (tail-first/header-last torn-write
  hardening like the v5 dict format) and the read→compressed-range
  resolve geometry;
- :mod:`~nydus_snapshotter_tpu_torch.soci.zindex` — the sibling
  ``<blob_id>.soci.zidx`` zstd frame-index artifact, same torn-write and
  checksum discipline;
- :mod:`~nydus_snapshotter_tpu_torch.soci.toc` — zstd:chunked footer/manifest
  parsing (and a deterministic writer for tests and benches);
- :mod:`~nydus_snapshotter_tpu_torch.soci.router` — the per-layer
  :class:`FormatRouter`: two ranged probe reads classify the blob and a
  closed-form cold-read cost model picks {toc-adopt, seekable-index,
  zran-index, rafs-convert}, surfaced as ``ntpu_soci_route_total``;
- :mod:`~nydus_snapshotter_tpu_torch.soci.blob` — :class:`SociStreamReader`
  (the concurrent decompressed-domain reader the daemon's BlobReader
  mounts) and the index store: local load → peer-tier replication →
  rebuild-once, never poisoning reads;
- :mod:`~nydus_snapshotter_tpu_torch.soci.zblob` — the zstd twin:
  :class:`ZstdStreamReader` plus the same store waterfall for the frame
  index (peer kind ``zsoci``);
- :mod:`~nydus_snapshotter_tpu_torch.soci.adaptor` — the snapshotter-side
  driver (resolver probe + routed prepare + layer merge), routed by
  ``filesystem/fs.py`` exactly like the stargz adaptor.

Failpoint sites ``soci.{index,resolve,fetch}`` (docs/robustness.md),
metrics ``ntpu_soci_*`` (docs/observability.md), config ``[soci]`` with
``NTPU_SOCI*`` env overrides (docs/configure.md).
"""

from nydus_snapshotter_tpu_torch.soci.adaptor import SociAdaptor, SociResolver  # noqa: F401
from nydus_snapshotter_tpu_torch.soci.blob import (  # noqa: F401
    SociStreamReader,
    load_or_build_index,
    resolve_soci_config,
)
from nydus_snapshotter_tpu_torch.soci.index import SociIndex, SociIndexError  # noqa: F401
from nydus_snapshotter_tpu_torch.soci.router import FormatRouter, RouteDecision  # noqa: F401
from nydus_snapshotter_tpu_torch.soci.zblob import (  # noqa: F401
    ZstdStreamReader,
    load_or_build_zindex,
)
from nydus_snapshotter_tpu_torch.soci.zindex import ZstdFrameIndex, ZstdIndexError  # noqa: F401
