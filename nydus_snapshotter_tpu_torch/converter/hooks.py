"""containerd image-converter hooks: OCI manifest -> nydus manifest rewrite.

The reference toolchain's pkg/converter/convert_unix.go:735-1219, as the
reference package's ``converter/hooks.py`` carries it. The flow a client
drives against the local content store (converter/content.py):

1. ``layer_convert_func(opt)`` converts each OCI layer blob to a nydus blob
   (``pack_layer``: on the card, kernels K1 and K2 on the ``fused`` lane,
   unless ``device="cpu"``), honoring the conversion cache label
   ``nydus-target-digest`` so a re-converted layer is a metadata no-op;
   with ``opt.oci_ref`` the original gzip layer is indexed in place
   (converter/zran.py: its chunks digest on the card through a
   ``ChunkDigestEngine``, K2 or K4 under BLAKE3, and on the host under
   ``device="cpu"``) and the converted blob is a bootstrap-only stream;
2. ``convert_hook_func(opt)`` rewrites the manifest: every nydus blob
   layer plus one merged gzip bootstrap layer, the config's diffIDs and
   history, GC labels on the manifest blob;
3. ``merge_layers`` produces the bootstrap layer descriptor and the
   deduplicated blob descriptor list.

``convert_image`` drives all three over one manifest.
"""

from __future__ import annotations

import gzip
import hashlib
import json
from typing import TYPE_CHECKING, Callable, Optional

from nydus_snapshotter_tpu_torch import constants as C
from nydus_snapshotter_tpu_torch.converter import convert
from nydus_snapshotter_tpu_torch.converter.content import LocalContentStore
from nydus_snapshotter_tpu_torch.converter.types import MergeOption, PackOption
from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine
from nydus_snapshotter_tpu_torch.remote.registry import Descriptor
from nydus_snapshotter_tpu_torch.remote.unpack import decompress_stream
from nydus_snapshotter_tpu_torch.tensors import resolve_device
from nydus_snapshotter_tpu_torch.utils import errdefs

if TYPE_CHECKING:
    import torch

_LAYER_MEDIA_TYPES = {
    "application/vnd.docker.image.rootfs.diff.tar",
    "application/vnd.docker.image.rootfs.diff.tar.gzip",
    "application/vnd.oci.image.layer.v1.tar",
    "application/vnd.oci.image.layer.v1.tar+gzip",
    "application/vnd.oci.image.layer.v1.tar+zstd",
}

_MANIFEST_MEDIA_TYPES = {
    "application/vnd.oci.image.manifest.v1+json",
    "application/vnd.docker.distribution.manifest.v2+json",
}

_INDEX_MEDIA_TYPES = {
    "application/vnd.oci.image.index.v1+json",
    "application/vnd.docker.distribution.manifest.list.v2+json",
}


def is_layer_type(media_type: str) -> bool:
    return media_type in _LAYER_MEDIA_TYPES or media_type == C.MEDIA_TYPE_NYDUS_BLOB


def is_nydus_blob(desc: Descriptor) -> bool:
    """convert_unix.go:747-755."""
    return C.LAYER_ANNOTATION_NYDUS_BLOB in (desc.annotations or {})


def is_nydus_bootstrap(desc: Descriptor) -> bool:
    """convert_unix.go:757-765."""
    return C.LAYER_ANNOTATION_NYDUS_BOOTSTRAP in (desc.annotations or {})


def is_nydus_image(manifest: dict) -> bool:
    """Last layer is a bootstrap (convert_unix.go:767-778)."""
    layers = manifest.get("layers") or []
    return bool(layers) and C.LAYER_ANNOTATION_NYDUS_BOOTSTRAP in (
        layers[-1].get("annotations") or {}
    )


def _chain_id(ids: list[str]) -> str:
    """OCI identity.ChainID over digest strings."""
    if not ids:
        return ""
    chain = ids[0]
    for d in ids[1:]:
        chain = "sha256:" + hashlib.sha256(f"{chain} {d}".encode()).hexdigest()
    return chain


def make_blob_desc(
    cs: LocalContentStore, opt: PackOption, source_digest: str, target_digest: str
) -> Descriptor:
    """convert_unix.go makeBlobDesc :780-820."""
    info = cs.info(target_digest)
    cs.update_labels(target_digest, {C.LAYER_ANNOTATION_UNCOMPRESSED: target_digest})
    annotations = {
        C.LAYER_ANNOTATION_UNCOMPRESSED: target_digest,
        C.LAYER_ANNOTATION_NYDUS_BLOB: "true",
    }
    if opt.oci_ref:
        annotations[C.NYDUS_REF_LAYER] = source_digest
    if opt.encrypt:
        annotations[C.LAYER_ANNOTATION_NYDUS_ENCRYPTED_BLOB] = "true"
    return Descriptor(
        media_type=C.MEDIA_TYPE_NYDUS_BLOB,
        digest=target_digest,
        size=info.size,
        annotations=annotations,
    )


def layer_convert_func(
    opt: PackOption,
    backend_push: Optional[Callable] = None,
    device: "str | torch.device | None" = None,
) -> Callable[[LocalContentStore, Descriptor], Optional[Descriptor]]:
    """convert_unix.go LayerConvertFunc :822-928. Packed layers, and the
    ``oci_ref`` arm's chunk digests, run on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    engine = None
    if opt.oci_ref:
        dev = resolve_device(device)
        if dev.type == "cuda":
            engine = ChunkDigestEngine(
                chunk_size=opt.chunk_size, backend="jax", digest_backend="jax",
                digester=opt.digester, device=dev,
            )

    def convert_layer(cs: LocalContentStore, desc: Descriptor) -> Optional[Descriptor]:
        if not is_layer_type(desc.media_type):
            return None
        if is_nydus_blob(desc) or is_nydus_bootstrap(desc):
            return None

        # Conversion cache: an already-converted layer is a metadata no-op
        # (:842-844, constant.go ManifestNydusCache).
        info = cs.info(desc.digest)
        cached = info.labels.get(C.LAYER_ANNOTATION_NYDUS_TARGET_DIGEST, "")
        if cached.startswith("sha256:") and cs.exists(cached):
            return make_blob_desc(cs, opt, desc.digest, cached)

        raw = cs.read(desc.digest)
        if opt.oci_ref:
            # zran shape (create --type targz-ref, builder.go:180-218): the
            # original .tar.gz stays the only data artifact; the converted
            # "blob" is a bootstrap-only stream indexing its decompressed
            # content (converter/zran.py).
            from nydus_snapshotter_tpu_torch.converter import zran

            bs = zran.pack_gzip_layer(raw, opt, engine=engine)
            blob_stream = convert.frame_bootstrap_only(bs.to_bytes())
        else:
            tar_bytes = decompress_stream(raw)
            blob_stream, _result = convert.pack_layer(tar_bytes, opt, device=device)
        blob_digest = "sha256:" + hashlib.sha256(blob_stream).hexdigest()
        cs.write_blob(blob_stream, expected_digest=blob_digest)
        cs.update_labels(
            desc.digest, {C.LAYER_ANNOTATION_NYDUS_TARGET_DIGEST: blob_digest}
        )
        new_desc = make_blob_desc(cs, opt, desc.digest, blob_digest)
        if backend_push is not None:
            backend_push(cs, new_desc)
        return new_desc

    return convert_layer


def merge_layers(
    cs: LocalContentStore, descs: list[Descriptor], opt: MergeOption
) -> tuple[Descriptor, list[Descriptor]]:
    """convert_unix.go MergeLayers :1074-1219: bootstrap layer descriptor +
    dedup'd blob descriptor list."""
    layer_blobs = [cs.read(d.digest) for d in descs]
    result = convert.Merge(layer_blobs, opt)

    # Merge reports the dedup result as inner blob-data ids (the bootstrap
    # blob table). In the reference those equal the layer digests because
    # meta is inline (--blob-inline-meta); here the stored layer stream is
    # tar-framed, so map inner id -> stored stream descriptor.
    desc_by_blob_id: dict[str, Descriptor] = {}
    for d, stream in zip(descs, layer_blobs):
        try:
            for blob in convert.bootstrap_from_layer_blob(stream).blobs:
                desc_by_blob_id.setdefault(blob.blob_id, d)
        except Exception:
            continue

    boot_bytes = result.bootstrap
    uncompressed_digest = "sha256:" + hashlib.sha256(boot_bytes).hexdigest()
    compressed = gzip.compress(boot_bytes, mtime=0)
    compressed_digest = "sha256:" + hashlib.sha256(compressed).hexdigest()
    cs.write_blob(
        compressed,
        labels={C.LAYER_ANNOTATION_UNCOMPRESSED: uncompressed_digest},
        expected_digest=compressed_digest,
    )

    # Dedup result: the blob list the final bootstrap actually references —
    # with OCIRef the original OCI layer blobs stay authoritative.
    blob_descs: list[Descriptor] = []
    if opt.oci_ref:
        for d in descs:
            annotations = {
                C.LAYER_ANNOTATION_UNCOMPRESSED: d.digest,
                C.LAYER_ANNOTATION_NYDUS_BLOB: "true",
            }
            ref = (d.annotations or {}).get(C.NYDUS_REF_LAYER, "")
            if ref:
                annotations[C.NYDUS_REF_LAYER] = ref
            blob_descs.append(
                Descriptor(
                    media_type=C.MEDIA_TYPE_NYDUS_BLOB,
                    digest=d.digest,
                    size=d.size,
                    annotations=annotations,
                )
            )
    else:
        seen: set[str] = set()
        for blob_id in result.blob_digests:
            mapped = desc_by_blob_id.get(blob_id)
            if mapped is not None:
                digest, size = mapped.digest, mapped.size
            elif cs.exists("sha256:" + blob_id):
                digest = "sha256:" + blob_id  # e.g. chunk-dict blob stored raw
                size = cs.info(digest).size
            else:
                raise errdefs.NotFound(
                    f"merged bootstrap references unknown blob {blob_id}"
                )
            if digest in seen:
                continue
            seen.add(digest)
            blob_descs.append(
                Descriptor(
                    media_type=C.MEDIA_TYPE_NYDUS_BLOB,
                    digest=digest,
                    size=size,
                    annotations={
                        C.LAYER_ANNOTATION_UNCOMPRESSED: digest,
                        C.LAYER_ANNOTATION_NYDUS_BLOB: "true",
                    },
                )
            )

    media_type = (
        "application/vnd.oci.image.layer.v1.tar+gzip"
        if opt.oci
        else "application/vnd.docker.image.rootfs.diff.tar.gzip"
    )
    bootstrap_desc = Descriptor(
        media_type=media_type,
        digest=compressed_digest,
        size=len(compressed),
        annotations={
            C.LAYER_ANNOTATION_UNCOMPRESSED: uncompressed_digest,
            C.LAYER_ANNOTATION_FS_VERSION: opt.fs_version or "6",
            C.LAYER_ANNOTATION_NYDUS_BOOTSTRAP: "true",
        },
    )
    return bootstrap_desc, blob_descs


def convert_manifest(
    cs: LocalContentStore,
    old_desc: Descriptor,
    new_desc: Descriptor,
    opt: MergeOption,
    with_backend: bool = False,
) -> Descriptor:
    """convert_unix.go convertManifest :969-1070."""
    manifest = json.loads(cs.read(new_desc.digest))
    manifest_labels = dict(cs.info(new_desc.digest).labels)
    if is_nydus_image(manifest):
        return new_desc

    opt.with_tar = True
    if not opt.oci and old_desc.media_type == "application/vnd.oci.image.manifest.v1+json":
        opt.oci = True

    layer_descs = [Descriptor.from_json(o) for o in manifest.get("layers") or []]
    bootstrap_desc, blob_descs = merge_layers(cs, layer_descs, opt)

    if with_backend:
        # blobs live in external storage: manifest holds only the bootstrap
        manifest["layers"] = [bootstrap_desc.to_json()]
    else:
        for idx, blob_desc in enumerate(blob_descs):
            manifest_labels[f"containerd.io/gc.ref.content.l.{idx}"] = blob_desc.digest
        manifest["layers"] = [d.to_json() for d in blob_descs] + [bootstrap_desc.to_json()]
    manifest_labels[
        f"containerd.io/gc.ref.content.l.{len(manifest['layers']) - 1}"
    ] = bootstrap_desc.digest

    # Rewrite config diffIDs + history (:1016-1040).
    config_desc = Descriptor.from_json(manifest["config"])
    config = json.loads(cs.read(config_desc.digest))
    config_labels = dict(cs.info(config_desc.digest).labels)
    bootstrap_history = {
        "created_by": "Nydus Converter",
        "comment": "Nydus Bootstrap Layer",
    }
    if with_backend:
        config.setdefault("rootfs", {})["diff_ids"] = [
            bootstrap_desc.annotations[C.LAYER_ANNOTATION_UNCOMPRESSED]
        ]
        config["history"] = [bootstrap_history]
    else:
        diff_ids = []
        for layer in manifest["layers"]:
            annos = layer.get("annotations") or {}
            diff_ids.append(annos.get(C.LAYER_ANNOTATION_UNCOMPRESSED, ""))
            annos.pop(C.LAYER_ANNOTATION_UNCOMPRESSED, None)
        config.setdefault("rootfs", {})["diff_ids"] = diff_ids
        config.setdefault("history", []).append(bootstrap_history)

    config_bytes = json.dumps(config).encode()
    new_config_digest = "sha256:" + hashlib.sha256(config_bytes).hexdigest()
    cs.write_blob(config_bytes, labels=config_labels, expected_digest=new_config_digest)
    manifest["config"] = {
        "mediaType": config_desc.media_type,
        "digest": new_config_digest,
        "size": len(config_bytes),
    }
    manifest_labels["containerd.io/gc.ref.content.config"] = new_config_digest

    if opt.with_referrer:
        subject = old_desc.to_json()
        subject.pop("platform", None)
        manifest["subject"] = subject

    manifest_bytes = json.dumps(manifest).encode()
    new_manifest_digest = "sha256:" + hashlib.sha256(manifest_bytes).hexdigest()
    cs.write_blob(manifest_bytes, labels=manifest_labels, expected_digest=new_manifest_digest)
    return Descriptor(
        media_type=new_desc.media_type,
        digest=new_manifest_digest,
        size=len(manifest_bytes),
        annotations=new_desc.annotations,
    )


def convert_hook_func(
    opt: MergeOption, with_backend: bool = False
) -> Callable[[LocalContentStore, Descriptor, Optional[Descriptor]], Descriptor]:
    """convert_unix.go ConvertHookFunc :933-950."""

    def hook(
        cs: LocalContentStore, org_desc: Descriptor, new_desc: Optional[Descriptor]
    ) -> Descriptor:
        if new_desc is None:
            return org_desc
        if new_desc.media_type in _INDEX_MEDIA_TYPES:
            index = json.loads(cs.read(new_desc.digest))
            manifests = index.get("manifests") or []
            if len(manifests) == 1:
                return Descriptor.from_json(manifests[0])
            return new_desc
        if new_desc.media_type in _MANIFEST_MEDIA_TYPES:
            return convert_manifest(cs, org_desc, new_desc, opt, with_backend)
        return new_desc

    return hook


def convert_image(
    cs: LocalContentStore,
    manifest_desc: Descriptor,
    pack_opt: PackOption,
    merge_opt: MergeOption,
    device: "str | torch.device | None" = None,
) -> Descriptor:
    """End-to-end image conversion (the containerd
    images/converter role): convert every layer (on ``device``), then
    rewrite the manifest. Returns the new manifest descriptor."""
    manifest = json.loads(cs.read(manifest_desc.digest))
    convert_one = layer_convert_func(pack_opt, device=device)
    new_layers = []
    for layer_json in manifest.get("layers") or []:
        desc = Descriptor.from_json(layer_json)
        converted = convert_one(cs, desc)
        new_layers.append((converted or desc).to_json())
    manifest["layers"] = new_layers
    body = json.dumps(manifest).encode()
    digest = "sha256:" + hashlib.sha256(body).hexdigest()
    cs.write_blob(body, expected_digest=digest)
    intermediate = Descriptor(
        media_type=manifest_desc.media_type, digest=digest, size=len(body)
    )
    return convert_hook_func(merge_opt)(cs, manifest_desc, intermediate)
