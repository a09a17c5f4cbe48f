"""The port's registry read path against the JAX package's.

Every case of tests/test_remote.py (references, the registry client
against an in-process fake registry, the transport pool, list filters,
keychains, blob backends) and of tests/test_schema1.py (schema1 manifest
conversion, over HTTP too) runs in both packages (``pkg``). Cross-package
cases hold the two clients' answers and the schema1 conversion's bytes
equal, and a hypothesis case feeds both ``parse_docker_ref`` the same
generated references.
"""

from __future__ import annotations

import base64
import datetime
import gzip
import hashlib
import importlib
import io
import json
import tarfile
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tests.test_remote import FakeRegistry

SIDES = ("ref", "port")
ROOTS = {"ref": "nydus_snapshotter_tpu", "port": "nydus_snapshotter_tpu_torch"}
MODULES = {
    "C": "constants",
    "errdefs": "utils.errdefs",
    "docker": "auth.docker",
    "image_proxy": "auth.image_proxy",
    "kubesecret": "auth.kubesecret",
    "keychain": "auth.keychain",
    "backend": "backend",
    "backend_mod": "backend.backend",
    "s3": "backend.s3",
    "oss": "backend.oss",
    "reference": "remote.reference",
    "registry": "remote.registry",
    "transport": "remote.transport",
    "schema1": "remote.schema1",
    "filters": "api.filters",
    "convert": "converter.convert",
    "types": "converter.types",
}


def _load(side: str) -> SimpleNamespace:
    ns = SimpleNamespace(side=side)
    for attr, mod in MODULES.items():
        setattr(ns, attr, importlib.import_module(f"{ROOTS[side]}.{mod}"))
    return ns


PKG = {side: _load(side) for side in SIDES}


@pytest.fixture(params=SIDES)
def pkg(request):
    return PKG[request.param]


@pytest.fixture()
def registry():
    reg = FakeRegistry()
    yield reg
    reg.close()


# ------------------------------------------------------------------- reference


def test_parse_docker_ref_normalization(pkg):
    parse, invalid = pkg.reference.parse_docker_ref, pkg.reference.InvalidReference
    r = parse("ubuntu")
    assert (r.domain, r.path, r.tag) == ("docker.io", "library/ubuntu", "latest")
    r = parse("ghcr.io/org/app:v1.2")
    assert (r.domain, r.path, r.tag) == ("ghcr.io", "org/app", "v1.2")
    r = parse("localhost:5000/a/b@sha256:" + "0" * 64)
    assert r.domain == "localhost:5000" and r.digest.startswith("sha256:")
    assert r.tag is None
    r = parse("index.docker.io/library/alpine:3.19")
    assert r.name == "docker.io/library/alpine"
    with pytest.raises(invalid):
        parse("UPPER/case")
    with pytest.raises(invalid):
        parse("repo:bad tag")


def test_parse_www_authenticate(pkg):
    scheme, params = pkg.registry.parse_www_authenticate(
        'Bearer realm="https://auth.docker.io/token",service="registry.docker.io",scope="repository:library/x:pull"'
    )
    assert scheme == "bearer"
    assert params["realm"] == "https://auth.docker.io/token"
    assert params["service"] == "registry.docker.io"


# -------------------------------------------------------------- registry client


def _client(pkg, reg: FakeRegistry):
    return pkg.registry.RegistryClient(reg.host, plain_http=True)


def test_fetch_blob_with_token_auth(pkg, registry):
    digest = registry.add_blob(b"layer-bytes" * 100)
    c = _client(pkg, registry)
    r = c.fetch_blob("library/app", digest)
    assert r.read() == b"layer-bytes" * 100
    r.close()
    # Token fetched exactly once, reused afterwards.
    r = c.fetch_blob("library/app", digest)
    r.close()
    assert sum(1 for q in registry.requests if q.startswith("GET /token")) == 1


def test_fetch_blob_range(pkg, registry):
    digest = registry.add_blob(bytes(range(256)))
    r = _client(pkg, registry).fetch_blob("a/b", digest, byte_range=(10, 19))
    assert r.read() == bytes(range(10, 20))
    r.close()


def test_resolve_and_fetch_manifest(pkg, registry):
    manifest = json.dumps({"schemaVersion": 2, "layers": []}).encode()
    registry.manifests["v1"] = ("application/vnd.oci.image.manifest.v1+json", manifest)
    c = _client(pkg, registry)
    desc = c.resolve("library/app", "v1")
    assert desc.digest == "sha256:" + hashlib.sha256(manifest).hexdigest()
    assert desc.size == len(manifest)
    got_desc, body = c.fetch_manifest("library/app", "v1")
    assert body == manifest and got_desc.digest == desc.digest


def test_blob_redirect_followed(pkg):
    reg = FakeRegistry(redirect_blobs=True)
    try:
        digest = reg.add_blob(b"cdn-data")
        r = pkg.registry.RegistryClient(reg.host, plain_http=True).fetch_blob("x/y", digest)
        assert r.read() == b"cdn-data"
        r.close()
    finally:
        reg.close()


def test_fetch_referrers(pkg, registry):
    digest = registry.add_blob(b"image-manifest")
    registry.referrers[digest] = [
        {"mediaType": "application/vnd.oci.image.manifest.v1+json",
         "digest": "sha256:" + "a" * 64, "size": 10,
         "annotations": {"containerd.io/snapshot/nydus-bootstrap": "true"}}
    ]
    refs = _client(pkg, registry).fetch_referrers("x/y", digest)
    assert len(refs) == 1 and refs[0].digest == "sha256:" + "a" * 64


def test_push_blob_and_manifest(pkg, registry):
    data = b"pushed-blob-content"
    digest = "sha256:" + hashlib.sha256(data).hexdigest()
    c = _client(pkg, registry)
    c.push_blob("x/y", digest, data)
    assert registry.blobs[digest] == data
    # Second push is a no-op (HEAD hit).
    before = len([q for q in registry.requests if q.startswith("POST")])
    c.push_blob("x/y", digest, data)
    assert len([q for q in registry.requests if q.startswith("POST")]) == before
    mdigest = c.push_manifest("x/y", "v2", "application/vnd.oci.image.manifest.v1+json", b"{}")
    assert registry.manifests["v2"][1] == b"{}"
    assert mdigest == "sha256:" + hashlib.sha256(b"{}").hexdigest()


def test_not_found_maps_to_errdefs(pkg, registry):
    with pytest.raises(pkg.errdefs.NotFound):
        _client(pkg, registry).fetch_by_digest("x/y", "sha256:" + "f" * 64)


# ------------------------------------------------------------------- transport


def test_pool_resolves_and_caches(pkg, registry):
    digest = registry.add_blob(b"pooled")
    pool = pkg.transport.Pool(plain_http=True)
    ref = pkg.reference.parse_docker_ref(f"{registry.host}/x/y:v1")
    url1, c1 = pool.resolve(ref, digest)
    url2, c2 = pool.resolve(ref, digest)
    assert c1 is c2 and url1 == url2
    assert url1.endswith(f"/v2/x/y/blobs/{digest}")


def test_pool_returns_redirect_target(pkg):
    reg = FakeRegistry(redirect_blobs=True)
    try:
        digest = reg.add_blob(b"cdn-bytes")
        pool = pkg.transport.Pool(plain_http=True)
        url, _ = pool.resolve(pkg.reference.parse_docker_ref(f"{reg.host}/x/y:v1"), digest)
        assert "/redirected/blobs/" in url
    finally:
        reg.close()


def test_list_filters(pkg):
    compile_filters = pkg.filters.compile_filters

    @dataclass
    class Info:
        name: str = ""
        parent: str = ""
        kind: str = ""
        labels: dict = field(default_factory=dict)

    a = Info(name="snap-a", parent="base", labels={"containerd.io/snapshot.ref": "r1"})
    b = Info(name="snap-b", kind="committed")
    assert compile_filters([])(a) and compile_filters([])(b)
    m = compile_filters(["parent==base"])
    assert m(a) and not m(b)
    m = compile_filters(['labels."containerd.io/snapshot.ref"==r1'])
    assert m(a) and not m(b)
    m = compile_filters(["name~=snap-.*"])
    assert m(a) and m(b)
    m = compile_filters(["kind==committed", "parent==base"])  # OR of filters
    assert m(a) and m(b)
    m = compile_filters(["kind==committed,parent==base"])  # AND inside one
    assert not m(a) and not m(b)
    m = compile_filters(["labels.missing"])
    assert not m(a)


# ------------------------------------------------------------------- keychain


def test_keychain_base64_roundtrip(pkg):
    kc = pkg.keychain.PassKeyChain("user", "pass")
    assert pkg.keychain.from_base64(kc.to_base64()) == kc
    assert pkg.keychain.PassKeyChain("", "tok").token_base()
    assert not kc.token_base()


def test_keychain_from_labels(pkg):
    C, kc_mod = pkg.C, pkg.keychain
    assert kc_mod.from_labels({}) is None
    kc = kc_mod.from_labels({C.NYDUS_IMAGE_PULL_USERNAME: "u", C.NYDUS_IMAGE_PULL_SECRET: "s"})
    assert kc == kc_mod.PassKeyChain("u", "s")


def test_keychain_chain_order(pkg, tmp_path, monkeypatch):
    C, image_proxy, kubesecret = pkg.C, pkg.image_proxy, pkg.kubesecret
    PassKeyChain, get_registry_keychain = pkg.keychain.PassKeyChain, pkg.keychain.get_registry_keychain
    image_proxy.reset()
    kubesecret.reset()
    # docker config dir (fake, as in pkg/auth/docker_test.go)
    cfg = {"auths": {"reg.example.com": {"auth": base64.b64encode(b"du:dp").decode()}}}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    monkeypatch.setenv("DOCKER_CONFIG", str(tmp_path))

    # 1. labels win
    kc = get_registry_keychain("reg.example.com", "reg.example.com/a:v1",
                               {C.NYDUS_IMAGE_PULL_USERNAME: "lu", C.NYDUS_IMAGE_PULL_SECRET: "lp"})
    assert kc == PassKeyChain("lu", "lp")
    # 2. CRI captures beat docker config
    image_proxy.capture("reg.example.com/a:v1", PassKeyChain("cu", "cp"))
    assert get_registry_keychain("reg.example.com", "reg.example.com/a:v1", {}) == PassKeyChain("cu", "cp")
    image_proxy.reset()
    # 3. docker config
    assert get_registry_keychain("reg.example.com", "reg.example.com/a:v1", {}) == PassKeyChain("du", "dp")
    # 4. kube secret fallback
    kubesecret.add_dockerconfigjson(json.dumps(
        {"auths": {"other.example.com": {"username": "ku", "password": "kp"}}}
    ))
    assert get_registry_keychain("other.example.com", "other.example.com/b:v1", {}) == PassKeyChain("ku", "kp")
    kubesecret.reset()


def test_docker_hub_host_mapping(pkg, tmp_path, monkeypatch):
    cfg = {"auths": {"https://index.docker.io/v1/": {"username": "hubu", "password": "hubp"}}}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    monkeypatch.setenv("DOCKER_CONFIG", str(tmp_path))
    assert pkg.docker.from_docker_config("registry-1.docker.io") == pkg.keychain.PassKeyChain("hubu", "hubp")


def test_kubesecret_dir_scan(pkg, tmp_path):
    kubesecret = pkg.kubesecret
    kubesecret.reset()
    (tmp_path / "sec1").write_text(json.dumps(
        {"auths": {"https://k8s.example.com": {"auth": base64.b64encode(b"a:b").decode()}}}
    ))
    assert kubesecret.load_secrets_dir(str(tmp_path)) == 1
    assert kubesecret.from_kube_secret("k8s.example.com") == pkg.keychain.PassKeyChain("a", "b")
    kubesecret.reset()


# -------------------------------------------------------------------- backends


def test_localfs_backend_roundtrip(pkg, tmp_path):
    b = pkg.backend.new_backend("localfs", {"dir": str(tmp_path / "blobs")})
    data = b"blob-payload"
    digest = "sha256:" + hashlib.sha256(data).hexdigest()
    with pytest.raises(pkg.errdefs.NotFound):
        b.check(digest)
    b.push(data, digest)
    path = b.check(digest)
    assert open(path, "rb").read() == data
    assert b.type() == "localfs"


def test_backend_factory_rejects_unknown(pkg):
    with pytest.raises(pkg.errdefs.InvalidArgument):
        pkg.backend.new_backend("ipfs", {})


def test_sigv4_signature_shape(pkg):
    hdrs = pkg.s3.sigv4_headers(
        "PUT", "s3.amazonaws.com", "/bucket/key", {}, "us-east-1",
        "AKID", "SECRET", "UNSIGNED-PAYLOAD",
        now=datetime.datetime(2026, 7, 29, 12, 0, 0, tzinfo=datetime.timezone.utc),
    )
    assert hdrs["Authorization"].startswith("AWS4-HMAC-SHA256 Credential=AKID/20260729/us-east-1/s3/aws4_request")
    assert "Signature=" in hdrs["Authorization"]
    assert hdrs["x-amz-date"] == "20260729T120000Z"


def test_s3_backend_config_validation(pkg):
    S3Backend = pkg.s3.S3Backend
    with pytest.raises(pkg.errdefs.InvalidArgument):
        S3Backend({"bucket_name": "b"})  # missing region
    b = S3Backend({"bucket_name": "b", "region": "r", "object_prefix": "p/"})
    assert b._object_key("sha256:abcd") == "p/abcd"
    assert b.type() == "s3"


def test_multipart_upload_streams_and_aborts(pkg):
    multipart_upload = pkg.backend_mod.multipart_upload
    calls = []

    def ok_request(method, key, query=None, body=b""):
        calls.append((method, dict(query or {}), len(body)))
        if query and "uploads" in query:
            return 200, {}, b"<R><UploadId>uid-1</UploadId></R>"
        if query and "partNumber" in query:
            return 200, {"ETag": f'"{query["partNumber"]}"'}, b""
        return 200, {}, b""

    multipart_upload(ok_request, "k", b"x" * 10, part_size=4, upload_id_tags=("UploadId",), service="S3")
    parts = [c for c in calls if "partNumber" in c[1]]
    assert [p[2] for p in parts] == [4, 4, 2]  # streamed in part-size chunks
    assert calls[-1][0] == "POST" and calls[-1][1] == {"uploadId": "uid-1"}

    # Failure mid-part aborts the session (DELETE uploadId).
    calls.clear()

    def bad_request(method, key, query=None, body=b""):
        calls.append((method, dict(query or {})))
        if query and "uploads" in query:
            return 200, {}, b"<R><UploadId>uid-2</UploadId></R>"
        if query and query.get("partNumber") == "2":
            return 500, {}, b""
        return 200, {}, b""

    with pytest.raises(pkg.errdefs.Unavailable):
        multipart_upload(bad_request, "k", b"x" * 10, part_size=4, upload_id_tags=("UploadId",), service="S3")
    assert calls[-1] == ("DELETE", {"uploadId": "uid-2"})


def test_oss_backend_config_validation(pkg):
    OSSBackend = pkg.oss.OSSBackend
    with pytest.raises(pkg.errdefs.InvalidArgument):
        OSSBackend({"bucket_name": "b"})  # missing endpoint
    b = OSSBackend({"endpoint": "oss-cn.example.com", "bucket_name": "b"})
    assert b.type() == "oss"


# ---------------------------------------------------------------------- schema1

RNG = np.random.default_rng(0x5C1)


def mk_layer(files: dict[str, bytes]) -> tuple[bytes, bytes]:
    """(gzip blob, tar bytes); gzip at mtime 0, so both packages see the
    same blob bytes."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, data in files.items():
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    tar = buf.getvalue()
    return gzip.compress(tar, mtime=0), tar


def mk_schema1(layers: list[bytes], throwaway_top: bool = False) -> tuple[bytes, dict]:
    """Newest-first schema1 manifest + blob store."""
    blobs = {}
    fs_layers = []
    history = []
    for i, blob in enumerate(reversed(layers)):
        digest = "sha256:" + hashlib.sha256(blob).hexdigest()
        blobs[digest] = blob
        fs_layers.append({"blobSum": digest})
        compat = {
            "id": f"layer-{i}",
            "created": f"2026-07-0{i + 1}T00:00:00Z",
            "os": "linux",
            "architecture": "amd64",
            "container_config": {"Cmd": [f"cmd-{i}"]},
            "config": {"Entrypoint": ["/bin/app"]},
        }
        if throwaway_top and i == 0:
            compat["throwaway"] = True
        history.append({"v1Compatibility": json.dumps(compat)})
    manifest = {
        "schemaVersion": 1,
        "name": "library/legacy",
        "tag": "latest",
        "architecture": "amd64",
        "fsLayers": fs_layers,
        "history": history,
    }
    return json.dumps(manifest).encode(), blobs


class TestSchema1:
    def test_media_type_detection(self, pkg):
        is_schema1 = pkg.schema1.is_schema1
        assert is_schema1("application/vnd.docker.distribution.manifest.v1+json")
        assert is_schema1("application/vnd.docker.distribution.manifest.v1+prettyjws")
        assert not is_schema1("application/vnd.oci.image.manifest.v1+json")

    def test_convert_orders_layers_and_diff_ids(self, pkg):
        g0, t0 = mk_layer({"a": b"lower"})
        g1, t1 = mk_layer({"b": RNG.integers(0, 256, 50_000, dtype=np.uint8).tobytes()})
        body, blobs = mk_schema1([g0, g1])
        manifest, config_bytes = pkg.schema1.convert_schema1(body, blobs.__getitem__)
        # lowest-first in OCI
        assert [ld["digest"] for ld in manifest["layers"]] == [
            "sha256:" + hashlib.sha256(g0).hexdigest(),
            "sha256:" + hashlib.sha256(g1).hexdigest(),
        ]
        config = json.loads(config_bytes)
        assert config["rootfs"]["diff_ids"] == [
            "sha256:" + hashlib.sha256(t0).hexdigest(),
            "sha256:" + hashlib.sha256(t1).hexdigest(),
        ]
        assert config["architecture"] == "amd64"
        assert manifest["config"]["digest"] == (
            "sha256:" + hashlib.sha256(config_bytes).hexdigest()
        )
        assert manifest["config"]["size"] == len(config_bytes)

    def test_throwaway_layers_skipped_but_in_history(self, pkg):
        g0, _ = mk_layer({"a": b"content"})
        g_empty, _ = mk_layer({})
        body, blobs = mk_schema1([g0, g_empty], throwaway_top=True)
        manifest, config_bytes = pkg.schema1.convert_schema1(body, blobs.__getitem__)
        assert len(manifest["layers"]) == 1
        config = json.loads(config_bytes)
        assert len(config["rootfs"]["diff_ids"]) == 1
        assert any(h.get("empty_layer") for h in config["history"])

    def test_plain_tar_layer_tolerated(self, pkg):
        _, tar = mk_layer({"x": b"not gzipped"})
        digest = "sha256:" + hashlib.sha256(tar).hexdigest()
        body, _ = mk_schema1([tar])
        manifest, config_bytes = pkg.schema1.convert_schema1(body, {digest: tar}.__getitem__)
        assert json.loads(config_bytes)["rootfs"]["diff_ids"] == [
            "sha256:" + hashlib.sha256(tar).hexdigest()
        ]

    def test_malformed_inputs_raise_schema1error(self, pkg):
        g0, _ = mk_layer({"a": b"x"})
        body, blobs = mk_schema1([g0])
        for mutant in (
            b"not json",
            b"[]",
            json.dumps({"schemaVersion": 2}).encode(),
            json.dumps({"schemaVersion": 1, "fsLayers": [], "history": [{}]}).encode(),
            json.dumps(
                {"schemaVersion": 1, "fsLayers": [{}],
                 "history": [{"v1Compatibility": "{}"}]}
            ).encode(),
            json.dumps(
                {"schemaVersion": 1, "fsLayers": [{"blobSum": "sha256:aa"}],
                 "history": [{"v1Compatibility": "not json"}]}
            ).encode(),
        ):
            with pytest.raises(pkg.schema1.Schema1Error):
                pkg.schema1.convert_schema1(mutant, blobs.__getitem__)

    def test_converted_image_packs_like_oci(self, pkg):
        """The endgame: a schema1 image converts into the RAFS pipeline
        (the port's default fused lane on the CPU: the kernels' plain
        versions)."""
        payload = RNG.integers(0, 256, 80_000, dtype=np.uint8).tobytes()
        g0, t0 = mk_layer({"app/bin": payload})
        body, blobs = mk_schema1([g0])
        manifest, _ = pkg.schema1.convert_schema1(body, blobs.__getitem__)
        layer_blob = blobs[manifest["layers"][0]["digest"]]
        kw = {"device": "cpu"} if pkg.side == "port" else {}
        blob, res = pkg.convert.pack_layer(
            pkg.schema1._decompress_layer(layer_blob), pkg.types.PackOption(chunk_size=0x1000), **kw
        )
        out = pkg.convert.Unpack(res.bootstrap, {res.blob_id: pkg.convert.blob_data_from_layer_blob(blob)})
        with tarfile.open(fileobj=io.BytesIO(out)) as tf:
            assert tf.extractfile("app/bin").read() == payload


class TestRegistryIntegration:
    def test_fetch_manifest_oci_converts_schema1_over_http(self, pkg):
        payload = RNG.integers(0, 256, 40_000, dtype=np.uint8).tobytes()
        g0, t0 = mk_layer({"app/data": payload})
        body, blobs = mk_schema1([g0])
        reg = FakeRegistry(require_auth=False)
        try:
            for digest, blob in blobs.items():
                assert reg.add_blob(blob) == digest
            reg.manifests["legacy"] = (
                "application/vnd.docker.distribution.manifest.v1+prettyjws",
                body,
            )
            client = pkg.registry.RegistryClient(reg.host, plain_http=True)
            desc, manifest, config = client.fetch_manifest_oci("library/old", "legacy")
            assert pkg.schema1.is_schema1(desc.media_type)
            assert manifest["schemaVersion"] == 2
            assert config is not None
            assert json.loads(config)["rootfs"]["diff_ids"] == [
                "sha256:" + hashlib.sha256(t0).hexdigest()
            ]

            # a native OCI manifest passes through untouched (config None)
            oci = json.dumps({"schemaVersion": 2, "layers": []}).encode()
            reg.manifests["modern"] = (
                "application/vnd.oci.image.manifest.v1+json", oci
            )
            desc2, manifest2, config2 = client.fetch_manifest_oci(
                "library/new", "modern"
            )
            assert config2 is None and manifest2["schemaVersion"] == 2
        finally:
            reg.close()


class TestCanonicalDigest:
    def test_unsigned_body_hashes_as_is(self, pkg):
        body, _ = mk_schema1([mk_layer({"a": b"x"})[0]])
        assert pkg.schema1.canonical_digest(body) == "sha256:" + hashlib.sha256(body).hexdigest()

    def test_signed_body_hashes_stripped_payload(self, pkg):
        body, _ = mk_schema1([mk_layer({"a": b"x"})[0]])
        # Build a prettyjws wrapper the way libtrust does: the canonical
        # payload is body minus its closing brace, plus formatTail ("\n}").
        assert body.endswith(b"}")
        fl = len(body) - 1
        tail = b"\n}"
        payload = body[:fl] + tail

        def b64(data: bytes) -> str:
            return base64.urlsafe_b64encode(data).decode().rstrip("=")

        protected = b64(json.dumps(
            {"formatLength": fl, "formatTail": b64(tail),
             "time": "2026-07-29T00:00:00Z"}
        ).encode())
        signed = json.loads(body)
        signed["signatures"] = [
            {"header": {"alg": "ES256"}, "signature": "xx", "protected": protected}
        ]
        signed_body = (body[:fl].decode() + ',"signatures":'
                       + json.dumps(signed["signatures"]) + "\n}").encode()
        assert pkg.schema1.canonical_digest(signed_body) == (
            "sha256:" + hashlib.sha256(payload).hexdigest()
        )

    def test_malformed_jws_raises(self, pkg):
        body = json.dumps(
            {"schemaVersion": 1,
             "signatures": [{"protected": "!!!not-b64$$"}]}
        ).encode()
        with pytest.raises(pkg.schema1.Schema1Error):
            pkg.schema1.canonical_digest(body)

    def test_body_shape_detection_without_media_type(self, pkg):
        g0, t0 = mk_layer({"f": b"legacy-content"})
        body, blobs = mk_schema1([g0])
        reg = FakeRegistry(require_auth=False)
        try:
            for digest, blob in blobs.items():
                reg.add_blob(blob)
            # generic content type: detection must fall back to body shape
            reg.manifests["untyped"] = ("application/json", body)
            client = pkg.registry.RegistryClient(reg.host, plain_http=True)
            _, manifest, config = client.fetch_manifest_oci("library/old", "untyped")
            assert manifest["schemaVersion"] == 2 and config is not None
        finally:
            reg.close()

    def test_duplicate_blobsums_fetch_once(self, pkg):
        g0, _ = mk_layer({"a": b"dup-layer"})
        digest = "sha256:" + hashlib.sha256(g0).hexdigest()
        # same blob listed 3x (pre-throwaway docker style)
        fs_layers = [{"blobSum": digest}] * 3
        history = [
            {"v1Compatibility": json.dumps({"id": f"l{i}", "created": ""})}
            for i in range(3)
        ]
        body = json.dumps(
            {"schemaVersion": 1, "fsLayers": fs_layers, "history": history}
        ).encode()
        calls = []

        def fetch(d):
            calls.append(d)
            return g0

        manifest, _ = pkg.schema1.convert_schema1(body, fetch)
        assert len(manifest["layers"]) == 3
        assert calls == [digest], "duplicate blobSum must fetch once"


def test_layer_digest_mismatch_rejected(pkg):
    g0, _ = mk_layer({"a": b"x"})
    body, blobs = mk_schema1([g0])

    def evil_fetch(d):
        return b"not the right bytes"

    with pytest.raises(pkg.schema1.Schema1Error):
        pkg.schema1.convert_schema1(body, evil_fetch)


# ---------------------------------------------------------- across packages


def test_clients_answer_alike_over_one_registry(registry):
    """One fake registry, both clients: the same descriptors, bodies, byte
    ranges, referrers and error types (by name)."""
    manifest = json.dumps({"schemaVersion": 2, "layers": [], "x": "y"}).encode()
    registry.manifests["v3"] = ("application/vnd.oci.image.manifest.v1+json", manifest)
    data = RNG.integers(0, 256, 9000, dtype=np.uint8).tobytes()
    digest = registry.add_blob(data)
    registry.referrers[digest] = [{"mediaType": "m", "digest": "sha256:" + "b" * 64, "size": 3}]
    got = {}
    for side, p in PKG.items():
        c = _client(p, registry)
        r = c.fetch_blob("x/y", digest, byte_range=(100, 4099))
        rng_bytes = r.read()
        r.close()
        try:
            c.fetch_by_digest("x/y", "sha256:" + "e" * 64)
            missing = None
        except Exception as e:  # noqa: BLE001 - the error's class is what is compared
            missing = type(e).__name__
        got[side] = (
            c.resolve("x/y", "v3").to_json(), c.fetch_manifest("x/y", "v3")[1], rng_bytes,
            c.fetch_by_digest("x/y", digest), [d.to_json() for d in c.fetch_referrers("x/y", digest)],
            c.head_blob("x/y", digest), missing,
        )
    assert got["port"] == got["ref"]
    assert got["port"][2] == data[100:4100] and got["port"][6] == "NotFound"


def test_descriptor_is_the_reference_class_shape():
    """``Descriptor`` stayed as it was for the converter: the same JSON
    both ways, and the same refusals of malformed registry objects."""
    obj = {"mediaType": "m", "digest": "sha256:" + "c" * 64, "size": 7,
           "annotations": {"a": "b"}, "urls": ["u"], "platform": {"os": "linux"}}
    for side, p in PKG.items():
        assert p.registry.Descriptor.from_json(obj).to_json() == obj, side
        for bad in ({"size": 1}, {"digest": "d", "size": True}, {"digest": "d", "urls": "x"}):
            with pytest.raises(ValueError):
                p.registry.Descriptor.from_json(bad)


_REF_PART = st.from_regex(r"[a-z0-9]{1,8}([._-][a-z0-9]{1,6}){0,2}", fullmatch=True)
_REFS = st.one_of(
    st.builds(
        lambda dom, port, parts, tag, dig: (
            (f"{dom}{port}/" if dom else "") + "/".join(parts)
            + (f":{tag}" if tag else "") + (f"@sha256:{dig}" if dig else "")
        ),
        st.sampled_from(["", "docker.io", "index.docker.io", "ghcr.io", "localhost", "reg.example.com"]),
        st.sampled_from(["", ":5000"]),
        st.lists(_REF_PART, min_size=1, max_size=3),
        st.one_of(st.just(""), st.from_regex(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,20}", fullmatch=True)),
        st.one_of(st.just(""), st.from_regex(r"[0-9a-f]{64}", fullmatch=True)),
    ),
    st.text(alphabet="abcAZ09:/@._- ", max_size=40),
)


def _parse_outcome(p, ref: str):
    try:
        r = p.reference.parse_docker_ref(ref)
    except p.reference.InvalidReference as e:
        return ("invalid", str(e))
    return (r.domain, r.path, r.tag, r.digest, r.name, r.familiar, str(r),
            p.reference.registry_host(r.domain))


@settings(max_examples=300, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(ref=_REFS)
def test_parse_docker_ref_equals_reference(ref):
    assert _parse_outcome(PKG["port"], ref) == _parse_outcome(PKG["ref"], ref)


@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(
    layers=st.lists(
        st.dictionaries(st.from_regex(r"[a-z]{1,6}(/[a-z]{1,6})?", fullmatch=True),
                        st.binary(max_size=300), max_size=3),
        min_size=1, max_size=3),
    throwaway=st.booleans(),
    gzipped=st.booleans(),
)
def test_schema1_conversion_equals_reference(layers, throwaway, gzipped):
    """Generated schema1 images: both conversions give the same manifest,
    config bytes and canonical digest, or both refuse."""
    blobs_in = [mk_layer(files)[0 if gzipped else 1] for files in layers]
    body, blobs = mk_schema1(blobs_in, throwaway_top=throwaway)
    got = {}
    for side, p in PKG.items():
        try:
            manifest, config = p.schema1.convert_schema1(body, blobs.__getitem__)
            got[side] = (json.dumps(manifest, sort_keys=True), config, p.schema1.canonical_digest(body))
        except p.schema1.Schema1Error as e:
            got[side] = ("refused", str(e))
    assert got["port"] == got["ref"]
