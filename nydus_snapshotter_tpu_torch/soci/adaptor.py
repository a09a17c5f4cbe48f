"""Snapshotter-side soci driver: probe, route, index-on-first-pull, merge.

The exact shape of the stargz adaptor pair (stargz/{resolver,adaptor}.py),
for layers that carry NO cooperation from the image builder — and, since
the universal-formats work, for cooperating zstd:chunked / eStargz /
seekable-zstd layers too:

- :class:`SociResolver` probes a claimable layer the cheapest possible
  way — two ranged reads (4 head bytes + one ≤56-byte tail) through the
  per-layer :class:`~nydus_snapshotter_tpu_torch.soci.router.FormatRouter`,
  which picks {toc-adopt, seekable-index, zran-index} by modeled
  cold-read cost. A layer the model routes to ``rafs-convert`` (unknown
  compression, missing decoder surface) raises :class:`SociError` here,
  cheaply, so the snapshotter falls through to ordinary conversion. The
  decision rides the returned blob as ``blob.route``.
- :class:`SociAdaptor.prepare_meta_layer` executes the routed backend:

  * ``toc-adopt`` — fetch the shipped TOC (eStargz tar member or
    zstd:chunked manifest) with ranged reads and emit the bootstrap
    straight from it (``stargz/index.bootstrap_from_toc``): ZERO
    build-pass bytes, no index artifact — the TOC is the index.
  * ``seekable-index`` — the one full pull, one sequential frame pass
    (:func:`~nydus_snapshotter_tpu_torch.soci.zblob.build_zindex_from_zstd`
    — free when a seek table is shipped), bootstrap via
    ``pack_zstd_layer`` from the same pass, ``.soci.zidx`` persisted.
    A degenerate single-frame blob demotes to ``rafs-convert`` (no
    random access exists to index) by raising — the layer converts
    normally.
  * ``zran-index`` — the PR-12 gzip path, unchanged: one full pull, one
    inflate pass, ``.soci.idx`` persisted.

- ``merge_meta_layer`` is byte-for-byte the stargz merge (per-layer
  bootstraps named by digest hex → ``image.boot``), reused by
  composition: zran, zstd-frame and TOC bootstraps merge identically.

When the needed decoder surface is missing (no libz zran, no libzstd
frame API) the router's cost table simply lacks those candidates and
the layer routes to what remains — degraded modes are routing outcomes,
not special cases.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Callable, Mapping, Optional

from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.converter.types import PackOption
from nydus_snapshotter_tpu_torch.converter.zran import pack_gzip_layer
from nydus_snapshotter_tpu_torch.converter.zstd_ref import pack_zstd_layer
from nydus_snapshotter_tpu_torch.soci import blob as soci_blob
from nydus_snapshotter_tpu_torch.soci import router as soci_router
from nydus_snapshotter_tpu_torch.soci import toc as ztoc
from nydus_snapshotter_tpu_torch.soci import zblob, zran
from nydus_snapshotter_tpu_torch.soci.index import index_path
from nydus_snapshotter_tpu_torch.soci.router import (
    BACKEND_RAFS,
    BACKEND_SEEKABLE,
    BACKEND_TOC_ADOPT,
    FORMAT_ESTARGZ,
    FormatRouter,
)
from nydus_snapshotter_tpu_torch.soci.zindex import zindex_path
from nydus_snapshotter_tpu_torch.stargz.adaptor import StargzAdaptor
from nydus_snapshotter_tpu_torch.stargz.index import bootstrap_from_toc
from nydus_snapshotter_tpu_torch.stargz.resolver import Blob, Resolver, _blob_size
from nydus_snapshotter_tpu_torch.utils import errdefs

logger = logging.getLogger(__name__)


class SociError(errdefs.NydusError):
    pass


def _config_router() -> FormatRouter:
    cfg = soci_blob.resolve_soci_config()
    return FormatRouter(enable_zstd=cfg.zstd, enable_toc=cfg.toc_adopt)


class SociResolver(Resolver):
    """Ranged-blob resolver accepting any layer the FormatRouter can
    route to a lazy backend (gzip, eStargz, seekable/opaque/chunked
    zstd — no footer or annotation required)."""

    def get_blob(
        self, ref: str, digest: str, labels: Optional[Mapping[str, str]] = None
    ) -> Blob:
        from nydus_snapshotter_tpu_torch.auth import keychain as authmod
        from nydus_snapshotter_tpu_torch.remote.reference import parse_docker_ref

        parsed = parse_docker_ref(ref)
        kc = authmod.get_keychain_by_ref(ref, dict(labels or {}))
        _, client = self.pool.resolve(parsed, digest, keychain=kc)
        repo = parsed.path
        size = _blob_size(client, repo, digest)

        def read_at(offset: int, length: int) -> bytes:
            if length <= 0:
                return b""
            r = client.fetch_blob(
                repo, digest, byte_range=(offset, offset + length - 1)
            )
            try:
                return r.read()
            finally:
                r.close()

        # Routing IS the detection: an unroutable layer (unknown magic,
        # or every lazy candidate infeasible) must fail here, cheaply,
        # not later in the prepare path.
        decision = _config_router().route(read_at, size)
        if decision.backend == BACKEND_RAFS:
            raise SociError(
                f"blob {digest} routed to rafs-convert "
                f"({decision.format}: {decision.reason})"
            )
        blob = Blob(ref, digest, read_at, size)
        blob.route = decision
        return blob


class SociAdaptor:
    def __init__(
        self,
        upper_path_fn: Callable[[str], str],
        cache_dir: str = "",
        fs_driver: str = constants.FS_DRIVER_FUSEDEV,
        chunk_size: int = constants.CHUNK_SIZE_DEFAULT,
        stride: int = 0,
    ):
        self.upper_path = upper_path_fn
        self.cache_dir = cache_dir
        self.fs_driver = fs_driver
        self.chunk_size = chunk_size
        self.stride = stride  # 0 = resolve from [soci]/env at build time
        # The merge half is format-agnostic bootstrap plumbing — reuse it.
        self._merge = StargzAdaptor(
            upper_path_fn, cache_dir=cache_dir, fs_driver=fs_driver,
            chunk_size=chunk_size,
        )

    # -- prepare (route → adopt or index on first pull) ----------------------

    def prepare_meta_layer(
        self, blob: Blob, storage_path: str,
        _labels: Optional[Mapping[str, str]] = None,
    ) -> None:
        blob_id = blob.get_digest().split(":", 1)[-1]
        os.makedirs(storage_path, exist_ok=True)
        converted = os.path.join(storage_path, blob_id)
        if os.path.exists(converted):
            return

        route = getattr(blob, "route", None)
        if route is None:
            # Direct callers (tests, tools) that skipped the resolver:
            # route now, with the same counters.
            route = _config_router().route(blob.read_at, blob.size)
            if route.backend == BACKEND_RAFS:
                raise SociError(
                    f"blob {blob_id[:12]} routed to rafs-convert "
                    f"({route.format}: {route.reason})"
                )

        if route.backend == BACKEND_TOC_ADOPT:
            bootstrap = self._adopt_toc(blob, blob_id, route)
        elif route.backend == BACKEND_SEEKABLE:
            bootstrap = self._index_zstd(blob, blob_id, route)
        else:
            bootstrap = self._index_gzip(blob, blob_id)

        fd, tmp = tempfile.mkstemp(prefix="converting-soci", dir=storage_path)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(bootstrap.to_bytes())
            os.rename(tmp, converted)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        os.chmod(converted, 0o440)

    # -- backend arms --------------------------------------------------------

    def _adopt_toc(self, blob: Blob, blob_id: str, route) -> "object":
        """TOC adoption: the shipped file→extent map becomes the
        bootstrap. Ranged reads only — zero build-pass bytes."""
        if route.format == FORMAT_ESTARGZ:
            toc = blob.toc()
            data_end = blob.get_toc_offset()
            compressor = constants.COMPRESSOR_GZIP
        else:
            toc = ztoc.read_toc(blob.read_at, blob.size)
            if toc is None:
                raise SociError(
                    f"blob {blob_id[:12]} routed toc-adopt but carries no TOC"
                )
            loc = route.toc_location or ztoc.parse_footer(
                blob.read_at(blob.size - ztoc.FOOTER_SIZE, ztoc.FOOTER_SIZE)
            )
            data_end = loc[0]
            compressor = constants.COMPRESSOR_ZSTD
        logger.info("soci toc-adopt for %s (%s): bootstrap from shipped TOC",
                    blob_id[:12], route.format)
        return bootstrap_from_toc(
            toc,
            blob_id,
            chunk_size=self.chunk_size,
            blob_compressed_size=data_end,
            compressor=compressor,
        )

    def _index_zstd(self, blob: Blob, blob_id: str, route) -> "object":
        """seekable-index: the one full pull, one frame pass (seek table
        trusted when shipped), bootstrap + persisted ``.soci.zidx``."""
        raw = self._full_pull(blob, blob_id)
        index, tar_bytes = zblob.build_zindex_from_zstd(blob_id, raw)
        if len(index.frames) <= 1 and index.uncompressed_size > self.chunk_size:
            # One frame = no random access to index: every cold read
            # would decode from byte zero. The cost model's answer for
            # that shape is conversion; re-route and decline.
            soci_router.ROUTE_TOTAL.labels(BACKEND_RAFS).inc()
            raise SociError(
                f"blob {blob_id[:12]} is single-frame zstd "
                f"({index.uncompressed_size} bytes): re-routed to rafs-convert"
            )

        opt = PackOption(chunk_size=self.chunk_size, oci_ref=True)
        bootstrap = pack_zstd_layer(raw, opt, tar_bytes=tar_bytes)

        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            soci_blob.INDEX_BYTES.inc(
                index.save(zindex_path(self.cache_dir, blob_id))
            )
            soci_blob.INDEX_EVENTS.labels("built").inc()
        return bootstrap

    def _index_gzip(self, blob: Blob, blob_id: str) -> "object":
        """zran-index: the PR-12 gzip arm, unchanged."""
        raw = self._full_pull(blob, blob_id)
        index = None
        tar_bytes = None
        stride = self.stride or soci_blob.resolve_soci_config().stride_bytes
        if zran.available():
            index, tar_bytes = soci_blob.build_index_from_gzip(
                blob_id, raw, stride=stride
            )

        opt = PackOption(chunk_size=self.chunk_size, oci_ref=True)
        bootstrap = pack_gzip_layer(raw, opt, tar_bytes=tar_bytes)

        if index is not None and self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            soci_blob.INDEX_BYTES.inc(
                index.save(index_path(self.cache_dir, blob_id))
            )
            soci_blob.INDEX_EVENTS.labels("built").inc()
        elif index is None:
            logger.warning(
                "libz zran unavailable: soci layer %s gets no checkpoint "
                "index (sequential cold reads)", blob_id[:12],
            )
        return bootstrap

    @staticmethod
    def _full_pull(blob: Blob, blob_id: str) -> bytes:
        # The one full pull. Everything after this is ranged.
        raw = blob.read_at(0, blob.size)
        if len(raw) != blob.size:
            raise SociError(
                f"blob {blob_id[:12]} short pull: {len(raw)} of {blob.size}"
            )
        return raw

    # -- merge ---------------------------------------------------------------

    def merge_meta_layer(self, snapshot) -> None:
        self._merge.merge_meta_layer(snapshot)
