"""The port's image-converter hooks (converter/hooks.py) against the JAX
package's.

The reference suite's layer-convert, conversion-cache, skip, full-image,
already-nydus and merge-descriptor cases (tests/test_converter_hooks.py)
run in both packages (``pkg``; the port packs on ``device="cpu"``). Then
parity: the same OCI image, published into one content store per package,
converts to the same manifest, config, descriptors and blobs (packed
layers and the ``oci_ref`` arm), byte for byte.
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import io
import json
import tarfile
from types import SimpleNamespace

import pytest

from nydus_snapshotter_tpu import constants as JC
from nydus_snapshotter_tpu.converter import convert as jconvert
from nydus_snapshotter_tpu.converter import hooks as jhooks
from nydus_snapshotter_tpu.converter.content import LocalContentStore as JContentStore
from nydus_snapshotter_tpu.converter.types import MergeOption as JMergeOption
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.remote.registry import Descriptor as JDescriptor
from nydus_snapshotter_tpu_torch import constants as TC
from nydus_snapshotter_tpu_torch.converter import convert as tconvert
from nydus_snapshotter_tpu_torch.converter import hooks as thooks
from nydus_snapshotter_tpu_torch.converter.content import LocalContentStore as TContentStore
from nydus_snapshotter_tpu_torch.converter.types import MergeOption as TMergeOption
from nydus_snapshotter_tpu_torch.converter.types import PackOption as TPackOption
from nydus_snapshotter_tpu_torch.remote.registry import Descriptor as TDescriptor


def _port_hooks():
    """The port's hooks with packs on the CPU."""
    return SimpleNamespace(
        layer_convert_func=functools.partial(thooks.layer_convert_func, device="cpu"),
        convert_image=functools.partial(thooks.convert_image, device="cpu"),
        merge_layers=thooks.merge_layers,
        is_nydus_blob=thooks.is_nydus_blob,
        is_nydus_bootstrap=thooks.is_nydus_bootstrap,
        is_nydus_image=thooks.is_nydus_image,
    )


PKG = {
    "port": SimpleNamespace(
        C=TC, convert=tconvert, hooks=_port_hooks(), ContentStore=TContentStore,
        PackOption=TPackOption, MergeOption=TMergeOption, Descriptor=TDescriptor,
        pack_layer=functools.partial(tconvert.pack_layer, device="cpu"),
    ),
    "ref": SimpleNamespace(
        C=JC, convert=jconvert, hooks=jhooks, ContentStore=JContentStore,
        PackOption=JPackOption, MergeOption=JMergeOption, Descriptor=JDescriptor,
        pack_layer=jconvert.pack_layer,
    ),
}
BOTH = pytest.mark.parametrize("pkg", ["port", "ref"])


def make_layer_tar(files: dict[str, bytes]) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:", format=tarfile.GNU_FORMAT) as tf:
        for name, data in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mode = 0o644
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def publish_oci_image(cs, p, layer_files: list[dict[str, bytes]]):
    """Write gzip layers, config and manifest into ``cs``."""
    layers, diff_ids = [], []
    for files in layer_files:
        tar = make_layer_tar(files)
        info = cs.write_blob(gzip.compress(tar, mtime=0))
        layers.append({"mediaType": "application/vnd.oci.image.layer.v1.tar+gzip",
                       "digest": info.digest, "size": info.size})
        diff_ids.append("sha256:" + hashlib.sha256(tar).hexdigest())
    config = {
        "architecture": "amd64", "os": "linux",
        "rootfs": {"type": "layers", "diff_ids": diff_ids},
        "history": [{"created_by": f"layer {i}"} for i in range(len(layers))],
    }
    cfg_info = cs.write_blob(json.dumps(config).encode())
    manifest = {
        "schemaVersion": 2,
        "mediaType": "application/vnd.oci.image.manifest.v1+json",
        "config": {"mediaType": "application/vnd.oci.image.config.v1+json",
                   "digest": cfg_info.digest, "size": cfg_info.size},
        "layers": layers,
    }
    info = cs.write_blob(json.dumps(manifest).encode())
    return p.Descriptor(media_type="application/vnd.oci.image.manifest.v1+json",
                        digest=info.digest, size=info.size)


def _pack_opt(pkg, **kw):
    return PKG[pkg].PackOption(backend="numpy", compressor="none", chunking="fixed", **kw)


@pytest.fixture()
def store(tmp_path, pkg):
    return PKG[pkg].ContentStore(str(tmp_path / "content"))


class TestLayerConvert:
    @BOTH
    def test_converts_oci_layer_to_nydus_blob(self, store, pkg):
        p = PKG[pkg]
        info = store.write_blob(gzip.compress(make_layer_tar({"etc/app": b"config"}), mtime=0))
        desc = p.Descriptor(media_type="application/vnd.oci.image.layer.v1.tar+gzip",
                            digest=info.digest, size=info.size)
        new_desc = p.hooks.layer_convert_func(_pack_opt(pkg))(store, desc)
        assert new_desc is not None
        assert new_desc.media_type == p.C.MEDIA_TYPE_NYDUS_BLOB
        assert p.hooks.is_nydus_blob(new_desc)
        assert store.exists(new_desc.digest)
        labels = store.info(desc.digest).labels
        assert labels[p.C.LAYER_ANNOTATION_NYDUS_TARGET_DIGEST] == new_desc.digest

    @BOTH
    def test_conversion_cache_is_a_noop(self, store, pkg):
        p = PKG[pkg]
        info = store.write_blob(gzip.compress(make_layer_tar({"f": b"x"}), mtime=0))
        desc = p.Descriptor("application/vnd.oci.image.layer.v1.tar+gzip", info.digest, info.size)
        fn = p.hooks.layer_convert_func(_pack_opt(pkg))
        first = fn(store, desc)
        count_before = len(list(store.walk()))
        second = fn(store, desc)
        assert second.digest == first.digest
        assert len(list(store.walk())) == count_before

    @BOTH
    def test_skips_non_layer_and_nydus_types(self, store, pkg):
        p = PKG[pkg]
        fn = p.hooks.layer_convert_func(_pack_opt(pkg))
        assert fn(store, p.Descriptor("application/weird", "sha256:" + "0" * 64, 1)) is None
        nydus = p.Descriptor(p.C.MEDIA_TYPE_NYDUS_BLOB, "sha256:" + "0" * 64, 1,
                             annotations={p.C.LAYER_ANNOTATION_NYDUS_BLOB: "true"})
        assert fn(store, nydus) is None


class TestConvertImage:
    @BOTH
    def test_full_image_conversion(self, store, pkg):
        p = PKG[pkg]
        manifest_desc = publish_oci_image(
            store, p, [{"bin/sh": b"#!/bin/sh", "etc/one": b"1"}, {"etc/two": b"2"}])
        new_desc = p.hooks.convert_image(store, manifest_desc, _pack_opt(pkg),
                                         p.MergeOption(oci=True))
        manifest = json.loads(store.read(new_desc.digest))
        assert p.hooks.is_nydus_image(manifest)
        layers = [p.Descriptor.from_json(o) for o in manifest["layers"]]
        assert all(p.hooks.is_nydus_blob(d) for d in layers[:-1])
        boot_desc = layers[-1]
        assert p.hooks.is_nydus_bootstrap(boot_desc)
        assert boot_desc.annotations[p.C.LAYER_ANNOTATION_FS_VERSION] == "6"
        bs = p.convert.bootstrap_from_bootstrap_layer(gzip.decompress(store.read(boot_desc.digest)))
        assert {"/bin/sh", "/etc/one", "/etc/two"} <= {i.path for i in bs.inodes}
        config = json.loads(store.read(manifest["config"]["digest"]))
        assert len(config["rootfs"]["diff_ids"]) == len(manifest["layers"])
        assert config["history"][-1]["comment"] == "Nydus Bootstrap Layer"
        labels = store.info(new_desc.digest).labels
        assert any(k.startswith("containerd.io/gc.ref.content.l.") for k in labels)

    @BOTH
    def test_already_nydus_image_untouched(self, store, pkg):
        p = PKG[pkg]
        manifest_desc = publish_oci_image(store, p, [{"a": b"1"}])
        once = p.hooks.convert_image(store, manifest_desc, _pack_opt(pkg), p.MergeOption(oci=True))
        twice = p.hooks.convert_image(store, once, _pack_opt(pkg), p.MergeOption(oci=True))
        assert twice.digest == once.digest


class TestMergeLayers:
    @BOTH
    def test_bootstrap_and_blob_descs(self, store, pkg):
        p = PKG[pkg]
        descs = []
        for files in ({"x": b"x" * 100}, {"y": b"y" * 100}):
            stream, _result = p.pack_layer(make_layer_tar(files), _pack_opt(pkg))
            info = store.write_blob(stream)
            descs.append(p.Descriptor(p.C.MEDIA_TYPE_NYDUS_BLOB, info.digest, info.size,
                                      annotations={p.C.LAYER_ANNOTATION_NYDUS_BLOB: "true"}))
        boot_desc, blob_descs = p.hooks.merge_layers(store, descs,
                                                     p.MergeOption(with_tar=False, oci=True))
        assert boot_desc.media_type == "application/vnd.oci.image.layer.v1.tar+gzip"
        assert p.hooks.is_nydus_bootstrap(boot_desc)
        assert len(blob_descs) == 2
        assert all(d.media_type == p.C.MEDIA_TYPE_NYDUS_BLOB for d in blob_descs)


# ---------------------------------------------------------------------------
# Parity: one image through both packages
# ---------------------------------------------------------------------------

IMAGE = [
    {"bin/sh": b"#!/bin/sh\n" * 300, "etc/one": b"1", "lib/big": bytes(range(256)) * 900},
    {"etc/two": b"2", "lib/big": bytes(range(255, -1, -1)) * 700, "usr/share/doc": b"d" * 40_000},
    {"etc/one": b"one, again", "opt/x": b"x" * 70_000},
]
PACKS = {
    "numpy-none-v6": dict(backend="numpy", compressor="none", chunking="fixed"),
    "hybrid-lz4": dict(backend="hybrid", chunk_size=0x10000),
    "hybrid-zstd-v5": dict(backend="hybrid", compressor="zstd", chunk_size=0x10000, fs_version="v5"),
    "oci-ref": dict(oci_ref=True, chunk_size=0x10000),
}


def _convert(pkg, root, pack, merge):
    p = PKG[pkg]
    cs = p.ContentStore(str(root))
    manifest_desc = publish_oci_image(cs, p, IMAGE)
    new_desc = p.hooks.convert_image(cs, manifest_desc, p.PackOption(**pack), p.MergeOption(**merge))
    blobs = {b.digest: cs.read(b.digest) for b in cs.walk()}
    labels = {b.digest: dict(cs.info(b.digest).labels) for b in cs.walk()}
    return new_desc, blobs, labels


@pytest.mark.parametrize("merge", [dict(oci=True), dict(oci=False, with_referrer=True)],
                         ids=["oci", "docker-referrer"])
@pytest.mark.parametrize("pack", PACKS, ids=list(PACKS))
def test_convert_image_equals_reference(tmp_path, pack, merge):
    """Manifest, config, every descriptor and every blob in the store (the
    packed layers, the bootstrap layer) and their labels are the
    reference's, byte for byte."""
    t_desc, t_blobs, t_labels = _convert("port", tmp_path / "port", PACKS[pack], merge)
    j_desc, j_blobs, j_labels = _convert("ref", tmp_path / "ref", PACKS[pack], merge)
    assert t_desc.to_json() == j_desc.to_json()
    assert t_blobs == j_blobs
    assert t_labels == j_labels
    manifest = json.loads(t_blobs[t_desc.digest])
    assert thooks.is_nydus_image(manifest)
    boot = tconvert.bootstrap_from_bootstrap_layer(
        gzip.decompress(t_blobs[manifest["layers"][-1]["digest"]]))
    assert {"/bin/sh", "/lib/big", "/opt/x"} <= {i.path for i in boot.inodes}


def test_cache_label_ignores_oci_ref_in_both(tmp_path):
    """Shared with the reference: the conversion-cache label on a source
    layer answers a later ``oci_ref`` conversion with the packed blob the
    first conversion stored, annotated as a ref layer, in both packages."""
    got = {}
    for pkg in ("port", "ref"):
        p = PKG[pkg]
        cs = p.ContentStore(str(tmp_path / pkg))
        raw = gzip.compress(make_layer_tar({"f": b"x" * 5000}), mtime=0)
        info = cs.write_blob(raw)
        desc = p.Descriptor("application/vnd.oci.image.layer.v1.tar+gzip", info.digest, info.size)
        packed = p.hooks.layer_convert_func(_pack_opt(pkg))(cs, desc)
        ref = p.hooks.layer_convert_func(p.PackOption(oci_ref=True))(cs, desc)
        assert ref.digest == packed.digest
        assert ref.annotations[p.C.NYDUS_REF_LAYER] == desc.digest
        got[pkg] = ref.to_json()
    assert got["port"] == got["ref"]
