"""The port's registry mirrors, health scoring and transport hardening
against the JAX package's.

Every case of tests/test_mirrors.py (the per-registry ``hosts.toml``
directories, ``DaemonRuntimeConfig.supplement``, the shipped example
configs) and of tests/test_mirror_failover.py (mirror failover on 5xx and
connect failures, failpoint-driven failover at ``transport.probe``, health
cooldowns, ``Retry-After`` on 429, the deadline-aware resolver) runs in
both packages (``pkg``), each against its own fake registries. Both
packages keep a process-wide failpoint table: every test clears both.
"""

from __future__ import annotations

import importlib
import os
from types import SimpleNamespace

import pytest

from tests.test_mirror_failover import ScriptedRegistry

SIDES = ("ref", "port")
ROOTS = {"ref": "nydus_snapshotter_tpu", "port": "nydus_snapshotter_tpu_torch"}
MODULES = {
    "failpoint": "failpoint",
    "errdefs": "utils.errdefs",
    "daemonconfig": "config.daemonconfig",
    "mirrors": "config.mirrors",
    "config": "config.config",
    "mirror": "remote.mirror",
    "reference": "remote.reference",
    "registry": "remote.registry",
    "transport": "remote.transport",
    "resolve": "remote.resolve",
}


def _load(side: str) -> SimpleNamespace:
    ns = SimpleNamespace(side=side)
    for attr, mod in MODULES.items():
        setattr(ns, attr, importlib.import_module(f"{ROOTS[side]}.{mod}"))
    return ns


PKG = {side: _load(side) for side in SIDES}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=SIDES)
def pkg(request):
    return PKG[request.param]


@pytest.fixture(autouse=True)
def _clean_failpoints():
    for p in PKG.values():
        p.failpoint.clear()
    yield
    for p in PKG.values():
        p.failpoint.clear()


# ------------------------------------------------------------ tests/test_mirrors.py

HOSTS_TOML = b"""
[host."https://mirror-a.example.com"]
ping_url = "https://mirror-a.example.com/v2"
health_check_interval = 10
failure_limit = 3
  [host."https://mirror-a.example.com".header]
  X-Registry = "docker.io"
  Multi = ["a", "b"]

[host."mirror-b.example.com:5000"]
"""


class TestHostDirs:
    def test_host_directory_mangling(self, pkg):
        assert pkg.mirrors.host_directory("registry:5000") == "registry_5000_"
        assert pkg.mirrors.host_directory("docker.io") == "docker.io"

    def test_host_paths_order(self, pkg, tmp_path):
        paths = pkg.mirrors.host_paths(str(tmp_path), "reg:5000")
        assert [p.rsplit("/", 1)[1] for p in paths] == ["reg_5000_", "reg:5000", "_default"]

    def test_host_dir_from_root_prefers_specific(self, pkg, tmp_path):
        host_dir_from_root = pkg.mirrors.host_dir_from_root
        (tmp_path / "docker.io").mkdir()
        (tmp_path / "_default").mkdir()
        assert host_dir_from_root(str(tmp_path), "docker.io").endswith("docker.io")
        assert host_dir_from_root(str(tmp_path), "other.io").endswith("_default")
        assert host_dir_from_root(str(tmp_path / "none"), "x") == ""


class TestHostsFile:
    def test_parse_ordered_hosts(self, pkg):
        mirrors = pkg.mirrors.parse_hosts_file(HOSTS_TOML)
        assert [m.host for m in mirrors] == [
            "https://mirror-a.example.com",
            "https://mirror-b.example.com:5000",
        ]
        a = mirrors[0]
        assert a.ping_url == "https://mirror-a.example.com/v2"
        assert a.health_check_interval == 10
        assert a.failure_limit == 3
        assert a.headers["X-Registry"] == "docker.io"
        assert a.headers["Multi"] == "a, b"

    def test_bad_toml_rejected(self, pkg):
        with pytest.raises(pkg.errdefs.InvalidArgument):
            pkg.mirrors.parse_hosts_file(b"not [valid toml")

    def test_missing_host_tree_rejected(self, pkg):
        with pytest.raises(pkg.errdefs.InvalidArgument):
            pkg.mirrors.parse_hosts_file(b"x = 1")


class TestLoadMirrors:
    def test_load_for_registry(self, pkg, tmp_path):
        d = tmp_path / "docker.io"
        d.mkdir()
        (d / "hosts.toml").write_bytes(HOSTS_TOML)
        mirrors = pkg.mirrors.load_mirrors_config(str(tmp_path), "docker.io")
        assert len(mirrors) == 2

    def test_no_dir_is_empty(self, pkg, tmp_path):
        assert pkg.mirrors.load_mirrors_config(str(tmp_path), "unknown.io") == []
        assert pkg.mirrors.load_mirrors_config("", "docker.io") == []

    def test_supplement_wires_mirrors(self, pkg, tmp_path):
        d = tmp_path / "ghcr.io"
        d.mkdir()
        (d / "hosts.toml").write_bytes(HOSTS_TOML)
        cfg = pkg.daemonconfig.DaemonRuntimeConfig.from_dict({}, "fusedev")
        cfg.supplement(
            image_ref="ghcr.io/org/app:latest",
            mirrors_config_dir=str(tmp_path),
        )
        assert cfg.backend.host == "ghcr.io"
        assert len(cfg.backend.mirrors) == 2
        assert cfg.backend.mirrors[0].host == "https://mirror-a.example.com"


def test_shipped_example_configs_parse(pkg):
    """misc/snapshotter configs must never rot out of sync with the
    parser (the reference ships the same artifacts)."""
    for name, driver in (
        ("config.toml", "fusedev"),
        ("config-tarfs.toml", "blockdev"),
    ):
        cfg = pkg.config.load_config(os.path.join(REPO, "misc", "snapshotter", name))
        cfg.validate()
        assert cfg.daemon.fs_driver == driver


def test_daemon_configs_equal_reference(tmp_path):
    """Both packages build the same daemon runtime config (``to_dict``,
    secrets kept and filtered) from the same inputs and mirrors directory."""
    d = tmp_path / "ghcr.io"
    d.mkdir()
    (d / "hosts.toml").write_bytes(HOSTS_TOML)
    got = {}
    for side, p in PKG.items():
        out = []
        for driver in ("fusedev", "fscache"):
            cfg = p.daemonconfig.DaemonRuntimeConfig.from_dict(
                {"device": {"backend": {"type": "registry", "config": {"timeout": 7}}}}, driver)
            cfg.supplement(image_ref="ghcr.io/org/app:latest", mirrors_config_dir=str(tmp_path))
            out.append((cfg.to_dict(), cfg.to_dict(filter_secrets=True)))
        got[side] = out
    assert got["port"] == got["ref"]


# ----------------------------------------------------- tests/test_mirror_failover.py


@pytest.fixture
def upstream():
    r = ScriptedRegistry()
    yield r
    r.close()


@pytest.fixture
def mirror_reg():
    r = ScriptedRegistry()
    yield r
    r.close()


def _mirrors_dir(pkg, tmp_path, upstream_host: str, mirror_host: str, extra: str = "") -> str:
    d = tmp_path / "certs.d" / pkg.mirrors.host_directory(upstream_host)
    d.mkdir(parents=True)
    (d / "hosts.toml").write_text(
        f'[host."http://{mirror_host}"]\n{extra}'
    )
    return str(tmp_path / "certs.d")


def _ref(pkg, host: str):
    return pkg.reference.parse_docker_ref(f"{host}/x/y:v1")


class TestMirrorFailover:
    def test_503_fails_over_and_read_succeeds(self, pkg, tmp_path, upstream, mirror_reg):
        data = b"blob-via-mirror" * 64
        digest = upstream.add_blob(data)
        mirror_reg.add_blob(data)
        upstream.always_fail(503)
        pool = pkg.transport.Pool(plain_http=True, mirrors_config_dir=_mirrors_dir(
            pkg, tmp_path, upstream.host, mirror_reg.host))
        ref = _ref(pkg, upstream.host)
        url, client = pool.resolve(ref, digest)
        assert mirror_reg.host in url
        # Acceptance: the read still succeeds via the mirror.
        r = client.fetch_blob("x/y", digest)
        assert r.read() == data
        r.close()
        # The mirror client is pooled: the next resolve doesn't touch upstream.
        upstream_hits = len(upstream.blob_requests)
        _, client2 = pool.resolve(ref, digest)
        assert client2 is client
        assert len(upstream.blob_requests) == upstream_hits

    def test_connect_failure_fails_over(self, pkg, tmp_path, mirror_reg):
        data = b"mirror-data"
        digest = mirror_reg.add_blob(data)
        dead_host = "127.0.0.1:1"  # nothing listens here
        pool = pkg.transport.Pool(plain_http=True, mirrors_config_dir=_mirrors_dir(
            pkg, tmp_path, dead_host, mirror_reg.host))
        url, client = pool.resolve(_ref(pkg, dead_host), digest)
        assert mirror_reg.host in url

    def test_404_does_not_fail_over(self, pkg, tmp_path, upstream, mirror_reg):
        digest = "sha256:" + "0" * 64
        mirror_reg.add_blob(b"should never be consulted")
        pool = pkg.transport.Pool(plain_http=True, mirrors_config_dir=_mirrors_dir(
            pkg, tmp_path, upstream.host, mirror_reg.host))
        with pytest.raises((pkg.errdefs.NotFound, pkg.registry.HTTPError)):
            pool.resolve(_ref(pkg, upstream.host), digest)
        assert mirror_reg.blob_requests == []

    def test_mirror_headers_are_sent(self, pkg, tmp_path, upstream, mirror_reg):
        digest = upstream.add_blob(b"d")
        mirror_reg.add_blob(b"d")
        upstream.always_fail(502)
        extra = '[host."http://%s".header]\nX-Registry = "docker.io"\n' % mirror_reg.host
        pool = pkg.transport.Pool(plain_http=True, mirrors_config_dir=_mirrors_dir(
            pkg, tmp_path, upstream.host, mirror_reg.host, extra=extra))
        pool.resolve(_ref(pkg, upstream.host), digest)
        assert mirror_reg.blob_requests[0].get("X-Registry") == "docker.io"

    def test_failpoint_driven_failover(self, pkg, tmp_path, upstream, mirror_reg):
        """A one-shot injected 503 on the probe exercises the same path
        without a misbehaving upstream."""
        data = b"healthy-upstream"
        digest = upstream.add_blob(data)
        mirror_reg.add_blob(data)
        pool = pkg.transport.Pool(plain_http=True, mirrors_config_dir=_mirrors_dir(
            pkg, tmp_path, upstream.host, mirror_reg.host))
        with pkg.failpoint.injected("transport.probe", "error(HTTPError:503)*1"):
            url, client = pool.resolve(_ref(pkg, upstream.host), digest)
        assert mirror_reg.host in url
        r = client.fetch_blob("x/y", digest)
        assert r.read() == data
        r.close()

    def test_all_mirrors_down_surfaces_upstream_error(self, pkg, tmp_path, upstream, mirror_reg):
        digest = upstream.add_blob(b"d")
        upstream.always_fail(503)
        mirror_reg.always_fail(503)
        pool = pkg.transport.Pool(plain_http=True, mirrors_config_dir=_mirrors_dir(
            pkg, tmp_path, upstream.host, mirror_reg.host))
        with pytest.raises(pkg.registry.HTTPError) as ei:
            pool.resolve(_ref(pkg, upstream.host), digest)
        assert ei.value.code == 503 and upstream.host in ei.value.url


class TestHealthScoring:
    def test_cooldown_after_failure_limit(self, pkg):
        t = [0.0]
        h = pkg.mirror.HostHealth(failure_limit=2, cooldown=5.0, clock=lambda: t[0])
        assert h.available()
        h.record_failure()
        assert h.available()  # under the limit
        h.record_failure()
        assert not h.available()  # tripped
        t[0] = 5.1
        assert h.available()  # cooldown expired

    def test_success_resets_streak(self, pkg):
        h = pkg.mirror.HostHealth(failure_limit=2, cooldown=5.0)
        h.record_failure()
        h.record_success()
        h.record_failure()
        assert h.available()

    def test_router_orders_and_skips_cooled_down(self, pkg, tmp_path):
        d = tmp_path / pkg.mirrors.host_directory("up.example.com")
        d.mkdir(parents=True)
        (d / "hosts.toml").write_text(
            '[host."https://m1.example.com"]\nfailure_limit = 1\n'
            'health_check_interval = 10\n'
            '[host."https://m2.example.com"]\n'
        )
        t = [0.0]
        router = pkg.mirror.MirrorRouter(str(tmp_path), clock=lambda: t[0])
        cands = router.candidates("up.example.com")
        assert [m.host for m in cands] == [
            "https://m1.example.com", "https://m2.example.com"
        ]
        router.record(cands[0], ok=False)  # failure_limit=1 trips at once
        assert [m.host for m in router.candidates("up.example.com")] == [
            "https://m2.example.com"
        ]
        t[0] = 10.1
        assert len(router.candidates("up.example.com")) == 2

    def test_split_mirror_host(self, pkg):
        split_mirror_host = pkg.mirror.split_mirror_host
        assert split_mirror_host("https://m:5000") == ("m:5000", False)
        assert split_mirror_host("http://m") == ("m", True)
        assert split_mirror_host("bare-host:5000")[0]  # tolerated

    def test_no_config_dir_no_mirrors(self, pkg):
        router = pkg.mirror.MirrorRouter("")
        assert router.mirrors_for("docker.io") == []
        assert router.candidates("docker.io") == []


class TestRetryAfter:
    def test_parse_retry_after(self, pkg):
        parse_retry_after = pkg.registry.parse_retry_after
        assert parse_retry_after(None) == 0.0
        assert parse_retry_after("3") == 3.0
        assert parse_retry_after("0") == 0.0
        assert parse_retry_after("nonsense") == 0.0
        assert parse_retry_after("Wed, 21 Oct 2199 07:28:00 GMT") > 0

    def test_429_honored_in_place_without_evicting(self, pkg, upstream):
        data = b"throttled-blob"
        digest = upstream.add_blob(data)
        sleeps: list[float] = []
        pool = pkg.transport.Pool(plain_http=True, sleep=sleeps.append)
        ref = _ref(pkg, upstream.host)
        _, c1 = pool.resolve(ref, digest)  # warm the pool
        upstream.script = [(429, {"Retry-After": "2"})]
        _, c2 = pool.resolve(ref, digest)
        assert c2 is c1  # the authenticated client survived the throttle
        assert sleeps == [2.0]

    def test_retry_after_is_capped(self, pkg, upstream):
        digest = upstream.add_blob(b"x")
        sleeps: list[float] = []
        pool = pkg.transport.Pool(plain_http=True, sleep=sleeps.append)
        upstream.script = [(429, {"Retry-After": "3600"})]
        pool.resolve(_ref(pkg, upstream.host), digest)
        assert sleeps == [pkg.transport.RETRY_AFTER_CAP]

    def test_persistent_429_evicts_and_reauths(self, pkg, upstream):
        digest = upstream.add_blob(b"x")
        pool = pkg.transport.Pool(plain_http=True, sleep=lambda _d: None)
        ref = _ref(pkg, upstream.host)
        _, c1 = pool.resolve(ref, digest)
        # cached probe + its retry both 429; the fresh client then succeeds
        upstream.script = [(429, {}), (429, {})]
        _, c2 = pool.resolve(ref, digest)
        assert c2 is not c1  # throttle outlasted the grace retry -> evicted


class TestResolverDeadline:
    def test_resolver_reads_via_pool(self, pkg, upstream):
        data = b"resolver-bytes"
        digest = upstream.add_blob(data)
        resolver = pkg.resolve.Resolver(plain_http=True)
        r = resolver.resolve(f"{upstream.host}/x/y:v1", digest, labels={})
        assert r.read() == data
        r.close()

    def test_resolver_retries_transient_then_succeeds(self, pkg, upstream):
        data = b"transient"
        digest = upstream.add_blob(data)
        resolver = pkg.resolve.Resolver(plain_http=True)
        # one injected transient failure; the deadline-aware retry recovers
        with pkg.failpoint.injected("transport.resolve", "error(OSError:flap)*1"):
            r = resolver.resolve(f"{upstream.host}/x/y:v1", digest, labels={})
        assert r.read() == data
        r.close()


class TestMirrorConfigDefaults:
    def test_mirror_config_shape(self, pkg):
        m = pkg.daemonconfig.MirrorConfig(host="https://m")
        assert m.failure_limit == 5 and m.health_check_interval == 5


def test_failover_sequences_equal_reference(tmp_path):
    """The same scripted upstream failures, through both pools: the same
    mirror choices, the same requests seen by each registry, the same
    sleeps and the same final bytes."""
    got = {}
    for side, p in PKG.items():
        up, mr = ScriptedRegistry(), ScriptedRegistry()
        try:
            data = b"sequence" * 100
            digest = up.add_blob(data)
            mr.add_blob(data)
            sleeps: list[float] = []
            pool = p.transport.Pool(plain_http=True, sleep=sleeps.append, mirrors_config_dir=_mirrors_dir(
                p, tmp_path / side, up.host, mr.host))
            ref = _ref(p, up.host)
            steps = []
            for script in ([], [(429, {"Retry-After": "1"})], [(503, {})] * 4, [(502, {})]):
                up.script = list(script)
                url, client = pool.resolve(ref, digest)
                r = client.fetch_blob("x/y", digest)
                body = r.read()
                r.close()
                steps.append((url.replace(up.host, "UP").replace(mr.host, "MIRROR"), body == data))
            got[side] = (steps, sleeps, len(up.blob_requests), len(mr.blob_requests))
        finally:
            up.close()
            mr.close()
    assert got["port"] == got["ref"]
