"""Docker schema1 manifest conversion (legacy registries).

The reference vendors containerd's schema1 puller
(pkg/remote/remotes/docker/schema1/converter.go): old registries serve
``application/vnd.docker.distribution.manifest.v1(+prettyjws)`` manifests
whose layers are listed newest-first with per-layer v1Compatibility JSON
instead of a config blob. Conversion to the OCI shape the rest of the
stack consumes requires synthesizing the image config — including
``rootfs.diff_ids``, which only exist as the sha256 of each *decompressed*
layer, so the layers must be pulled (the reference does the same; it is
the unavoidable cost of schema1).

Surface: ``is_schema1(media_type)`` and
``convert_schema1(body, fetch_blob)`` → (oci_manifest_dict, config_bytes).
Layer order is reversed to OCI's lowest-first, ``throwaway`` history
entries (schema1's empty layers) are dropped, and the synthesized config
carries architecture/os/created/config from the newest v1Compatibility
entry.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import zlib
from typing import Callable

MEDIA_TYPE_SCHEMA1 = "application/vnd.docker.distribution.manifest.v1+json"
MEDIA_TYPE_SCHEMA1_SIGNED = "application/vnd.docker.distribution.manifest.v1+prettyjws"
_MEDIA_TYPE_CONFIG = "application/vnd.oci.image.config.v1+json"
_MEDIA_TYPE_MANIFEST = "application/vnd.oci.image.manifest.v1+json"
_MEDIA_TYPE_LAYER = "application/vnd.oci.image.layer.v1.tar+gzip"


class Schema1Error(ValueError):
    pass


def is_schema1(media_type: str) -> bool:
    return media_type in (MEDIA_TYPE_SCHEMA1, MEDIA_TYPE_SCHEMA1_SIGNED)


def looks_like_schema1(manifest: dict) -> bool:
    """Body-shape detection: old registries serve schema1 under generic
    content types ('application/json', or none at all)."""
    return manifest.get("schemaVersion") == 1 and "fsLayers" in manifest


def _b64url(data: str) -> bytes:
    import base64

    pad = "=" * (-len(data) % 4)
    try:
        return base64.urlsafe_b64decode(data + pad)
    except (ValueError, TypeError) as e:
        raise Schema1Error(f"bad JWS base64: {e}") from e


def canonical_digest(body: bytes, parsed: dict | None = None) -> str:
    """The registry-canonical digest of a schema1 manifest body.

    Signed (+prettyjws) manifests are digested over the JWS payload with
    signatures stripped — ``body[:formatLength] + formatTail`` from the
    first signature's protected header (docker/libtrust semantics; the
    reference inherits this via containerd's schema1 DigestFromManifest).
    Unsigned bodies digest as-is. ``parsed`` passes an already-loaded body.
    """
    if parsed is not None:
        m = parsed
    else:
        try:
            m = json.loads(body)
        except (json.JSONDecodeError, UnicodeDecodeError):
            m = None
    sigs = m.get("signatures") if isinstance(m, dict) else None
    if isinstance(sigs, list) and sigs and isinstance(sigs[0], dict):
        protected_b64 = sigs[0].get("protected")
        if isinstance(protected_b64, str):
            try:
                protected = json.loads(_b64url(protected_b64))
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                raise Schema1Error(f"bad JWS protected header: {e}") from e
            if not isinstance(protected, dict):
                raise Schema1Error("JWS protected header is not an object")
            fl = protected.get("formatLength")
            tail_b64 = protected.get("formatTail")
            if not isinstance(fl, int) or not isinstance(tail_b64, str):
                raise Schema1Error("JWS protected header missing formatLength/formatTail")
            if not 0 <= fl <= len(body):
                raise Schema1Error(f"JWS formatLength {fl} outside body")
            payload = body[:fl] + _b64url(tail_b64)
            return "sha256:" + hashlib.sha256(payload).hexdigest()
    return "sha256:" + hashlib.sha256(body).hexdigest()


def _decompress_layer(blob: bytes) -> bytes:
    """Schema1 layers are tar+gzip on the wire; tolerate plain tars the way
    containerd's DecompressStream does (some mirrors re-serve decompressed)."""
    if blob[:2] == b"\x1f\x8b":
        try:
            return gzip.decompress(blob)
        except (OSError, EOFError, zlib.error) as e:
            raise Schema1Error(f"corrupt schema1 layer gzip: {e}") from e
    return blob


def convert_schema1(
    body: bytes, fetch_blob: Callable[[str], bytes], parsed: dict | None = None
) -> tuple[dict, bytes]:
    """Convert a schema1 manifest body into (OCI manifest dict, config bytes).

    ``fetch_blob(digest)`` must return the raw layer blob — needed to
    compute diff_ids for the synthesized config; each fetched blob is
    verified against its blobSum before its hash enters the synthesized
    manifest (the reference gets the same guarantee from content-store
    ingest). Signed (+prettyjws) manifests are accepted; signatures are not
    verified (parity with the reference converter, which relies on digest
    pinning instead). ``parsed`` passes an already-json.loads'd body.
    """
    if parsed is not None:
        m = parsed
    else:
        try:
            m = json.loads(body)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise Schema1Error(f"schema1 manifest is not JSON: {e}") from e
    if not isinstance(m, dict):
        raise Schema1Error("schema1 manifest is not an object")
    if m.get("schemaVersion") != 1:
        raise Schema1Error(f"not a schema1 manifest (schemaVersion={m.get('schemaVersion')!r})")
    fs_layers = m.get("fsLayers")
    history = m.get("history")
    if not isinstance(fs_layers, list) or not isinstance(history, list):
        raise Schema1Error("schema1 manifest missing fsLayers/history")
    if len(fs_layers) != len(history):
        raise Schema1Error(
            f"schema1 fsLayers ({len(fs_layers)}) != history ({len(history)})"
        )

    compat: list[dict] = []
    for h in history:
        if not isinstance(h, dict) or not isinstance(h.get("v1Compatibility"), str):
            raise Schema1Error("schema1 history entry missing v1Compatibility")
        try:
            c = json.loads(h["v1Compatibility"])
        except json.JSONDecodeError as e:
            raise Schema1Error(f"bad v1Compatibility JSON: {e}") from e
        if not isinstance(c, dict):
            raise Schema1Error("v1Compatibility is not an object")
        compat.append(c)

    # schema1 lists newest-first; OCI wants lowest-first.
    layers: list[dict] = []
    diff_ids: list[str] = []
    layer_history: list[dict] = []
    # Real schema1 manifests repeat the identical empty-gzip layer many
    # times (pre-throwaway Docker); fetch+hash each unique digest once.
    seen: dict[str, tuple[int, str]] = {}
    for idx in range(len(fs_layers) - 1, -1, -1):
        c = compat[idx]
        cmd = (c.get("container_config") or {}).get("Cmd") or []
        entry_history = {
            "created": c.get("created", ""),
            "created_by": " ".join(x for x in cmd if isinstance(x, str))
            if isinstance(cmd, list)
            else "",
        }
        if c.get("throwaway"):
            entry_history["empty_layer"] = True
            layer_history.append(entry_history)
            continue
        layer_history.append(entry_history)
        fsl = fs_layers[idx]
        digest = fsl.get("blobSum") if isinstance(fsl, dict) else None
        if not isinstance(digest, str) or not digest:
            raise Schema1Error("schema1 fsLayer missing blobSum")
        if digest not in seen:
            if not digest.startswith("sha256:"):
                # Docker schema1 only ever produced sha256 blobSums; an
                # unknown algorithm would mean skipping verification, and
                # unverified bytes must not enter the synthesized manifest.
                raise Schema1Error(f"unsupported blobSum algorithm: {digest}")
            blob = fetch_blob(digest)
            actual = "sha256:" + hashlib.sha256(blob).hexdigest()
            if actual != digest:
                raise Schema1Error(
                    f"layer blob digest mismatch: manifest says {digest}, "
                    f"fetched {actual}"
                )
            seen[digest] = (
                len(blob),
                "sha256:" + hashlib.sha256(_decompress_layer(blob)).hexdigest(),
            )
        size, diff_id = seen[digest]
        diff_ids.append(diff_id)
        layers.append({"mediaType": _MEDIA_TYPE_LAYER, "digest": digest, "size": size})

    newest = compat[0] if compat else {}
    config = {
        "architecture": m.get("architecture", newest.get("architecture", "amd64")),
        "os": newest.get("os", "linux"),
        "created": newest.get("created", ""),
        "config": newest.get("config") or {},
        "rootfs": {"type": "layers", "diff_ids": diff_ids},
        "history": layer_history,
    }
    config_bytes = json.dumps(config, sort_keys=True).encode()
    manifest = {
        "schemaVersion": 2,
        "mediaType": _MEDIA_TYPE_MANIFEST,
        "config": {
            "mediaType": _MEDIA_TYPE_CONFIG,
            "digest": "sha256:" + hashlib.sha256(config_bytes).hexdigest(),
            "size": len(config_bytes),
        },
        "layers": layers,
    }
    return manifest, config_bytes
