"""The port's referrer package against the JAX package's.

Every case of tests/test_referrer.py runs in both packages (``pkg``)
against the in-process fake registry of tests/test_remote.py over plain
HTTP (each package's ``Remote`` switched to it, as the reference's tests
do). Cross-package cases hold the two packages' answers equal: the
referrer's descriptor, the metadata bytes each writes, the manager's
cached answer and its requests, and ``unpack`` on the same layers.
"""

from __future__ import annotations

import gzip
import hashlib
import importlib
import io
import json
import tarfile
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from tests.test_remote import FakeRegistry

SIDES = ("ref", "port")
ROOTS = {"ref": "nydus_snapshotter_tpu", "port": "nydus_snapshotter_tpu_torch"}
MODULES = {
    "C": "constants",
    "referrer": "referrer",
    "referrer_mod": "referrer.referrer",
    "remote": "remote.remote",
    "unpack_mod": "remote.unpack",
    "errdefs": "utils.errdefs",
    "singleflight": "utils.singleflight",
}


def _load(side: str) -> SimpleNamespace:
    ns = SimpleNamespace(side=side)
    for attr, mod in MODULES.items():
        setattr(ns, attr, importlib.import_module(f"{ROOTS[side]}.{mod}"))
    return ns


PKG = {side: _load(side) for side in SIDES}
REF, PORT = PKG["ref"], PKG["port"]
META = REF.referrer.METADATA_NAME_IN_LAYER


@pytest.fixture(params=SIDES)
def pkg(request):
    return PKG[request.param]


@pytest.fixture()
def registry():
    reg = FakeRegistry(require_auth=False)
    yield reg
    reg.close()


@pytest.fixture(autouse=True)
def plain_http(monkeypatch):
    for p in PKG.values():
        orig = p.remote.Remote.__init__

        def patched(self, keychain=None, insecure=False, orig=orig):
            orig(self, keychain=keychain, insecure=insecure)
            self.with_plain_http = True

        monkeypatch.setattr(p.remote.Remote, "__init__", patched)


def _bootstrap_layer_blob(content: bytes = b"bootstrap-bytes") -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:") as tf:
        info = tarfile.TarInfo(META)
        info.size = len(content)
        tf.addfile(info, io.BytesIO(content))
    return gzip.compress(buf.getvalue(), mtime=0)


def _setup_referrer(reg: FakeRegistry, with_annotation: bool = True, content: bytes = b"bootstrap-bytes"):
    """image digest D -> referrer manifest M whose last layer is a nydus
    bootstrap layer (test_referrer._setup_referrer)."""
    layer_blob = _bootstrap_layer_blob(content)
    layer_digest = reg.add_blob(layer_blob)
    annos = {REF.C.LAYER_ANNOTATION_NYDUS_BOOTSTRAP: "true"} if with_annotation else {}
    manifest = {"schemaVersion": 2, "layers": [{
        "mediaType": "application/vnd.oci.image.layer.v1.tar+gzip", "digest": layer_digest,
        "size": len(layer_blob), "annotations": annos}]}
    mbody = json.dumps(manifest).encode()
    mdigest = reg.add_blob(mbody)
    image_digest = "sha256:" + hashlib.sha256(b"the-oci-image" + content).hexdigest()
    reg.referrers[image_digest] = [{"mediaType": "application/vnd.oci.image.manifest.v1+json",
                                    "digest": mdigest, "size": len(mbody)}]
    return image_digest, layer_digest


# ---------------------------------------------------------------------------
# test_referrer.TestReferrer / TestManager
# ---------------------------------------------------------------------------


class TestReferrer:
    def test_check_referrer_finds_meta_layer(self, pkg, registry):
        image_digest, layer_digest = _setup_referrer(registry)
        desc = pkg.referrer.Referrer().check_referrer(f"{registry.host}/library/app:latest", image_digest)
        assert desc.digest == layer_digest
        assert pkg.C.LAYER_ANNOTATION_NYDUS_BOOTSTRAP in desc.annotations

    def test_no_referrers_raises(self, pkg, registry):
        digest = "sha256:" + "9" * 64
        registry.referrers[digest] = []
        with pytest.raises(Exception):
            pkg.referrer.Referrer().check_referrer(f"{registry.host}/library/app:latest", digest)

    def test_missing_annotation_rejected(self, pkg, registry):
        image_digest, _ = _setup_referrer(registry, with_annotation=False)
        with pytest.raises(pkg.errdefs.InvalidArgument):
            pkg.referrer.Referrer().check_referrer(f"{registry.host}/library/app:latest", image_digest)

    def test_fetch_metadata_unpacks_bootstrap(self, pkg, registry, tmp_path):
        image_digest, _ = _setup_referrer(registry)
        ref = f"{registry.host}/library/app:latest"
        referrer = pkg.referrer.Referrer()
        desc = referrer.check_referrer(ref, image_digest)
        out = tmp_path / "image.boot"
        referrer.fetch_metadata(ref, desc, str(out))
        assert out.read_bytes() == b"bootstrap-bytes"


class TestManager:
    def test_lru_cache_avoids_refetch(self, pkg, registry):
        image_digest, layer_digest = _setup_referrer(registry)
        ref = f"{registry.host}/library/app:latest"
        mgr = pkg.referrer.ReferrerManager()
        assert mgr.check_referrer(ref, image_digest).digest == layer_digest
        before = len(registry.requests)
        assert mgr.check_referrer(ref, image_digest).digest == layer_digest
        assert len(registry.requests) == before

    def test_try_fetch_metadata(self, pkg, registry, tmp_path):
        image_digest, _ = _setup_referrer(registry)
        out = tmp_path / "boot"
        pkg.referrer.ReferrerManager().try_fetch_metadata(
            f"{registry.host}/library/app:latest", image_digest, str(out))
        assert out.read_bytes() == b"bootstrap-bytes"


# ---------------------------------------------------------------------------
# test_referrer.TestSingleflight / TestUnpack
# ---------------------------------------------------------------------------


class TestSingleflight:
    def test_shares_one_flight(self, pkg):
        g = pkg.singleflight.Group()
        calls, results = [], []
        gate = threading.Event()

        def slow():
            gate.wait(2)
            calls.append(1)
            return "value"

        threads = [threading.Thread(target=lambda: results.append(g.do("k", slow))) for _ in range(5)]
        for t in threads:
            t.start()
        gate.set()
        for t in threads:
            t.join()
        assert len(calls) == 1
        assert all(r[0] == "value" for r in results)
        assert sum(1 for r in results if r[1]) == 4

    def test_exception_propagates_to_all(self, pkg):
        g = pkg.singleflight.Group()
        gate = threading.Event()
        errors = []

        def boom():
            gate.wait(2)
            raise RuntimeError("nope")

        def run():
            try:
                g.do("k", boom)
            except RuntimeError as e:
                errors.append(e)

        threads = [threading.Thread(target=run) for _ in range(3)]
        for t in threads:
            t.start()
        gate.set()
        for t in threads:
            t.join()
        assert len(errors) == 3

    def test_different_keys_run_independently(self, pkg):
        g = pkg.singleflight.Group()
        assert g.do("a", lambda: 1)[0] == 1
        assert g.do("b", lambda: 2)[0] == 2


class TestUnpack:
    def test_unpack_plain_tar(self, pkg, tmp_path):
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:") as tf:
            info = tarfile.TarInfo("dir/file.txt")
            info.size = 5
            tf.addfile(info, io.BytesIO(b"hello"))
        out = tmp_path / "x"
        pkg.unpack_mod.unpack(buf.getvalue(), "dir/file.txt", str(out))
        assert out.read_bytes() == b"hello"

    def test_unpack_gzip_tar(self, pkg, tmp_path):
        out = tmp_path / "boot"
        pkg.unpack_mod.unpack(_bootstrap_layer_blob(b"data123"), META, str(out))
        assert out.read_bytes() == b"data123"

    def test_unpack_missing_member_raises(self, pkg, tmp_path):
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:") as tf:
            info = tarfile.TarInfo("other")
            info.size = 0
            tf.addfile(info, io.BytesIO(b""))
        with pytest.raises(pkg.errdefs.NotFound):
            pkg.unpack_mod.unpack(buf.getvalue(), "missing", str(tmp_path / "y"))


# ---------------------------------------------------------------------------
# Cross-package answers
# ---------------------------------------------------------------------------


def test_constants_equal():
    assert PORT.referrer.METADATA_NAME_IN_LAYER == META
    assert PORT.referrer_mod.MAX_MANIFEST_INDEX_SIZE == REF.referrer_mod.MAX_MANIFEST_INDEX_SIZE
    assert PORT.C.LAYER_ANNOTATION_NYDUS_BOOTSTRAP == REF.C.LAYER_ANNOTATION_NYDUS_BOOTSTRAP


def test_referrer_answers_equal(registry, tmp_path):
    """A numpy-seeded bootstrap behind a referrer: both packages return the
    same descriptor, write the same bytes, and their managers make the
    same requests (one lookup, then the cache)."""
    content = np.random.default_rng(9).integers(0, 256, 70_000, dtype=np.uint8).tobytes()
    image_digest, _ = _setup_referrer(registry, content=content)
    ref = f"{registry.host}/library/app:latest"
    descs, wrote, reqs = {}, {}, {}
    for side in SIDES:
        p = PKG[side]
        r = p.referrer.Referrer()
        descs[side] = r.check_referrer(ref, image_digest).to_json()
        r.fetch_metadata(ref, r.check_referrer(ref, image_digest), str(tmp_path / f"{side}.boot"))
        wrote[side] = (tmp_path / f"{side}.boot").read_bytes()
        start = len(registry.requests)
        mgr = p.referrer.ReferrerManager()
        mgr.check_referrer(ref, image_digest)
        mgr.check_referrer(ref, image_digest)
        mgr.try_fetch_metadata(ref, image_digest, str(tmp_path / f"{side}.mgr.boot"))
        reqs[side] = [str(x) for x in registry.requests[start:]]
        assert (tmp_path / f"{side}.mgr.boot").read_bytes() == content
    assert descs["port"] == descs["ref"]
    assert wrote["port"] == wrote["ref"] == content
    assert reqs["port"] == reqs["ref"]


@pytest.mark.parametrize("annotated", [True, False])
def test_rejections_equal(registry, annotated):
    image_digest, _ = _setup_referrer(registry, with_annotation=annotated)
    empty = "sha256:" + "7" * 64
    registry.referrers[empty] = []
    ref = f"{registry.host}/library/app:latest"
    for digest in (image_digest, empty):
        outcome = {}
        for side in SIDES:
            try:
                outcome[side] = ("ok", PKG[side].referrer.Referrer().check_referrer(ref, digest).to_json())
            except Exception as e:  # noqa: BLE001 - the two packages' errors are compared
                outcome[side] = (type(e).__name__, str(e))
        assert outcome["port"] == outcome["ref"]
