"""The port's fault, trace and metrics planes against the JAX package's.

Both packages keep process-wide tables (the armed failpoints, the tracer,
the metrics registry); every test here resets both. Each case runs the
same calls in the two packages and compares: failpoint spec parsing and
the inject / clear / n-shot / probability / panic rules, the site
catalog, every site of a ported module firing in both packages, the span
tree, errors, sampling, env resolution, context carried across pipeline
workers, ``BatchConverter`` layers and the dict service's RPCs, the
Chrome export, and the registry's exposition text.
"""

import io
import json
import os
import re
import tarfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from nydus_snapshotter_tpu import failpoint as jfp
from nydus_snapshotter_tpu import trace as jtrace
from nydus_snapshotter_tpu.converter.batch import BatchConverter as JBatchConverter
from nydus_snapshotter_tpu.converter.convert import pack_layer as j_pack_layer
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.failpoint import spec as jspec
from nydus_snapshotter_tpu.metrics import registry as jreg
from nydus_snapshotter_tpu.ops import cdc as jcdc
from nydus_snapshotter_tpu.ops import fused_convert as jfused
from nydus_snapshotter_tpu.ops import native_cdc as jnative
from nydus_snapshotter_tpu.parallel import dict_service as jds
from nydus_snapshotter_tpu.parallel import sharded_dict as jsd
from nydus_snapshotter_tpu.utils import errdefs as jerrdefs
from nydus_snapshotter_tpu_torch import failpoint as tfp
from nydus_snapshotter_tpu_torch import trace as ttrace
from nydus_snapshotter_tpu_torch.converter import PackOption, pack_layer
from nydus_snapshotter_tpu_torch.converter.batch import BatchConverter
from nydus_snapshotter_tpu_torch.failpoint import spec as tspec
from nydus_snapshotter_tpu_torch.metrics import registry as treg
from nydus_snapshotter_tpu_torch.ops import cdc as tcdc
from nydus_snapshotter_tpu_torch.ops import fused_convert as tfused
from nydus_snapshotter_tpu_torch.ops import native_cdc as tnative
from nydus_snapshotter_tpu_torch.parallel import dict_service as tds
from nydus_snapshotter_tpu_torch.parallel import sharded_dict as tsd
from nydus_snapshotter_tpu_torch.utils import errdefs as terrdefs

PORT = Path(__file__).resolve().parent.parent / "nydus_snapshotter_tpu_torch"

PKG = {
    "port": SimpleNamespace(fp=tfp, spec=tspec, trace=ttrace, reg=treg, errdefs=terrdefs),
    "ref": SimpleNamespace(fp=jfp, spec=jspec, trace=jtrace, reg=jreg, errdefs=jerrdefs),
}

# The sites of the modules this package has ported; the rest of the
# reference's catalog belongs to modules it does not have yet.
PORTED_SITES = {
    "converter.pack", "pipeline.chunk", "pipeline.queue", "pipeline.compress",
    "pipeline.assemble", "fused.dispatch", "dict.insert", "dict.rebuild", "dict.rpc",
    "dict.shard", "chunk.vec", "compress.probe", "compress.train", "compress.encode",
    "compress.batch",
}


@pytest.fixture(autouse=True)
def _clean_planes():
    for p in PKG.values():
        p.fp.clear()
        p.trace.configure(enabled=True, ring_capacity=4096, slow_op_threshold_ms=0)
    yield
    for p in PKG.values():
        p.fp.clear()
        p.trace.reset()


def _tar(n_files=6, seed=5, size=(30_000, 200_000)) -> bytes:
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        for i in range(n_files):
            data = rng.integers(0, 256, int(rng.integers(*size)), dtype=np.uint8).tobytes()
            ti = tarfile.TarInfo(f"c/f{i}")
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


LAYER = _tar()
PIPE = dict(chunk_size=0x10000, backend="hybrid", batch_size=0x4000)


# ---------------------------------------------------------------- failpoint


@pytest.mark.parametrize("pkg", ["port", "ref"])
class TestFailpointSpec:
    def test_parse_multi_site_spec(self, pkg):
        table = PKG[pkg].spec.parse_spec(
            "transport.fetch_blob=error(OSError:503)%0.5;daemon.spawn=delay(0.2);metastore.commit=panic"
        )
        assert set(table) == {"transport.fetch_blob", "daemon.spawn", "metastore.commit"}
        a = table["transport.fetch_blob"]
        assert (a.kind, a.arg, a.prob) == ("error", "OSError:503", 0.5)
        assert (table["daemon.spawn"].kind, table["metastore.commit"].kind) == ("delay", "panic")

    def test_parse_count_and_off(self, pkg):
        table = PKG[pkg].spec.parse_spec("a=error(OSError)*2;b=off;;")
        assert table["a"].count == 2 and "b" not in table

    @pytest.mark.parametrize("bad", ["a=explode", "a=error(X)%1.5", "noequals", "=error(X)",
                                     "a=delay(x)"])
    def test_bad_specs_rejected(self, pkg, bad):
        with pytest.raises(PKG[pkg].spec.SpecError):
            PKG[pkg].spec.parse_spec(bad)

    def test_action_roundtrips_through_str(self, pkg):
        a = PKG[pkg].spec.parse_action("error(OSError:boom)%0.25*3")
        assert PKG[pkg].spec.parse_action(str(a)) == a

    def test_build_error_mapping(self, pkg):
        p = PKG[pkg]
        assert isinstance(p.spec.build_error("OSError:boom", "s"), OSError)
        assert isinstance(p.spec.build_error("TimeoutError", "s"), TimeoutError)
        assert isinstance(p.spec.build_error("Unavailable:down", "s"), p.errdefs.Unavailable)
        assert type(p.spec.build_error("NoSuchThing", "s")) is RuntimeError


def test_http_error_refused_at_arming():
    """``error(HTTPError:…)`` raises the reference's registry-client error,
    a plane this package lacks: arming it is a ValueError naming it, not a
    silent RuntimeError at the site."""
    assert jspec.parse_action("error(HTTPError:503)").arg == "HTTPError:503"
    for arm in (lambda: tspec.parse_spec("transport.fetch_blob=error(HTTPError:503)"),
                lambda: tfp.inject("x", "error(HTTPError:429)"),
                lambda: tfp.inject("x", tspec.Action(kind="error", arg="HTTPError")),
                lambda: tfp.configure("x=error(HTTPError)")):
        with pytest.raises(ValueError, match="remote.registry.HTTPError"):
            arm()
    assert tfp.active() == {}
    assert not tfp.configure_from_env({tfp.ENV_VAR: "x=error(HTTPError:503)"})


@pytest.mark.parametrize("pkg", ["port", "ref"])
class TestFailpointRegistry:
    def test_disabled_hit_is_noop(self, pkg):
        fp = PKG[pkg].fp
        assert fp.active() == {}
        fp.hit("converter.pack")

    def test_unarmed_site_is_noop_while_others_armed(self, pkg):
        fp = PKG[pkg].fp
        with fp.injected("some.site", "error(OSError)"):
            fp.hit("other.site")
        assert fp.counts().get("other.site") is None

    def test_inject_fire_clear(self, pkg):
        fp = PKG[pkg].fp
        fp.inject("x", "error(OSError:kaboom)")
        with pytest.raises(OSError, match="kaboom"):
            fp.hit("x")
        fp.clear("x")
        fp.hit("x")
        assert fp.counts()["x"] == 1

    def test_n_shot_disarms(self, pkg):
        fp = PKG[pkg].fp
        fp.inject("x", "error(OSError)*2")
        for _ in range(2):
            with pytest.raises(OSError):
                fp.hit("x")
        fp.hit("x")
        assert "x" not in fp.active() and fp.counts()["x"] == 2

    def test_probability_extremes(self, pkg):
        fp = PKG[pkg].fp
        fp.inject("never", "error(OSError)%0.0")
        for _ in range(20):
            fp.hit("never")
        fp.inject("always", "error(OSError)%1.0")
        with pytest.raises(OSError):
            fp.hit("always")

    def test_delay_sleeps(self, pkg):
        fp = PKG[pkg].fp
        fp.inject("z", "delay(0.02)")
        t0 = time.monotonic()
        fp.hit("z")
        assert time.monotonic() - t0 >= 0.015

    def test_panic_bypasses_except_exception(self, pkg):
        fp = PKG[pkg].fp
        fp.inject("p", "panic(boom)")
        with pytest.raises(fp.Panic):
            try:
                fp.hit("p")
            except Exception:  # noqa: BLE001 - what a panic must get past
                pytest.fail("Panic was caught as an Exception")

    def test_env_activation_and_malformed_env(self, pkg):
        fp = PKG[pkg].fp
        assert fp.configure_from_env({fp.ENV_VAR: "a=error(OSError)*1;b=delay(0)"})
        assert fp.active() == {"a": "error(OSError)*1", "b": "delay(0)"}
        fp.clear()
        assert not fp.configure_from_env({fp.ENV_VAR: "not a spec!!"})
        assert fp.active() == {}


def test_catalog_equal_and_ported_sites_wired():
    """The port keeps the reference's whole catalog. Every site its
    modules fire is cataloged, and they are exactly the ported modules'
    sites; the others belong to modules not yet ported."""
    assert tfp.KNOWN_SITES == jfp.KNOWN_SITES
    wired = set()
    for path in PORT.rglob("*.py"):
        if path.parent.name != "failpoint":  # its docstring's example
            wired |= set(re.findall(r'hit\("([a-z_.]+)"\)', path.read_text()))
    assert wired == PORTED_SITES
    assert PORTED_SITES <= set(tfp.KNOWN_SITES)
    not_ported = set(tfp.KNOWN_SITES) - PORTED_SITES
    assert "transport.fetch_blob" in not_ported and "ha.replicate" in not_ported


def _drive_pack(pkg):
    if pkg == "port":
        return pack_layer(LAYER, PackOption(**PIPE), device="cpu")
    return j_pack_layer(LAYER, JPackOption(**PIPE))


def _drive_fused(pkg):
    if pkg == "port":
        return tfused.FusedDeviceEngine(chunk_size=0x10000, device="cpu").process_many([b"x" * 1024])
    return jfused.FusedDeviceEngine(chunk_size=0x10000).process_many([b"x" * 1024])


def _drive_vec(pkg):
    data = np.random.default_rng(3).integers(0, 256, 50_000, dtype=np.uint8)
    if pkg == "port":
        return tnative.chunk_data_vec_native(data, tcdc.CDCParams(0x1000))
    return jnative.chunk_data_vec_native(data, jcdc.CDCParams(0x1000))


def _dict(pkg, n=16, load_factor=0.85):
    digs = np.random.default_rng(4).integers(0, 2**32, (n, 8), dtype=np.uint32)
    if pkg == "port":
        return tsd.ShardedChunkDict(digs, device="cpu", load_factor=load_factor)
    return jsd.ShardedChunkDict(digs, load_factor=load_factor)


def _drive_insert(pkg):
    return _dict(pkg).insert_u32(np.random.default_rng(5).integers(0, 2**32, (4, 8), dtype=np.uint32))


def _drive_rebuild(pkg):
    # far past the load factor: the insert rebuilds the table
    d = _dict(pkg, n=8, load_factor=0.5)
    return d.insert_u32(np.random.default_rng(6).integers(0, 2**32, (400, 8), dtype=np.uint32))


def _drive_rpc(pkg):
    svc = tds.DictService(device="cpu") if pkg == "port" else jds.DictService()
    status, _ctype, body = svc.handle("GET", "/api/v1/dict/ns/stats", {}, b"")
    if status != 200:
        raise OSError(f"status {status}: {body!r}")


def _drive_shard(pkg, tmp_path):
    mod = tds if pkg == "port" else jds
    svcs = []
    for i in range(2):
        svcs.append(tds.DictService(device="cpu") if pkg == "port" else jds.DictService())
        svcs[-1].run(str(tmp_path / f"{pkg}{i}.sock"))
    try:
        mirror = mod.ServiceChunkDict([mod.DictClient(s.sock_path) for s in svcs], "ns")
        try:
            mirror.sync()
        finally:
            mirror.close()
    finally:
        for s in svcs:
            s.stop()


def _codec_mod(pkg):
    from nydus_snapshotter_tpu.converter import codec as jcodec
    from nydus_snapshotter_tpu_torch.converter import codec as tcodec

    return tcodec if pkg == "port" else jcodec


def _codec(pkg, **kw):
    mod = _codec_mod(pkg)
    return mod.AdaptiveCodec(mod.CodecConfig(adaptive=True, **kw))


def _drive_probe(pkg):
    c = _codec(pkg)
    c.encode(np.random.default_rng(7).integers(0, 256, 32 << 10, dtype=np.uint8).tobytes())
    if c.counts["fallback"]:  # the probe's failure degrades, it does not raise
        raise OSError("site-chaos: the probe fell back to always-compress")


def _drive_train(pkg):
    c = _codec(pkg, train=True, train_sample_mib=1, train_dict_kib=16)
    c.attach_trainer()
    rng = np.random.default_rng(8)
    words = [bytes(rng.integers(97, 123, 6, dtype=np.uint8)) for _ in range(300)]
    for _ in range(60):
        c.encode(b" ".join(words[int(k)] for k in rng.integers(0, 300, 3000)))
    td = c.maybe_train(force=True)
    if td is None:  # a failed training degrades, it does not raise
        raise OSError("site-chaos: training fell back to untrained")
    _codec_mod(pkg).unregister_trained_dict(td.dict_id)  # the registry is process-wide


def _drive_encode(pkg):
    return _codec(pkg).encode(b"x" * 8192)


def _drive_batch(pkg):
    return _codec(pkg).encode_batch([b"x" * 8192, b"y" * 9000])


DRIVERS = {
    "converter.pack": _drive_pack,
    "pipeline.chunk": _drive_pack,
    "pipeline.queue": _drive_pack,
    "pipeline.compress": _drive_pack,
    "pipeline.assemble": _drive_pack,
    "fused.dispatch": _drive_fused,
    "chunk.vec": _drive_vec,
    "dict.insert": _drive_insert,
    "dict.rebuild": _drive_rebuild,
    "dict.rpc": _drive_rpc,
    "dict.shard": _drive_shard,
    "compress.probe": _drive_probe,
    "compress.train": _drive_train,
    "compress.encode": _drive_encode,
    "compress.batch": _drive_batch,
}


@pytest.mark.parametrize("site", sorted(DRIVERS))
def test_each_ported_site_fires_in_both_packages(monkeypatch, tmp_path, site):
    assert set(DRIVERS) == PORTED_SITES
    monkeypatch.setenv("NTPU_PACK_THREADS", "4")
    monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")
    for pkg in ("port", "ref"):
        fp = PKG[pkg].fp
        drive = DRIVERS[site]
        run = (lambda: drive(pkg, tmp_path)) if site == "dict.shard" else (lambda: drive(pkg))
        fp.inject(site, "error(OSError:site-chaos)*1")
        with pytest.raises(OSError, match="site-chaos|status 500"):
            run()
        assert fp.counts().get(site) == 1, pkg
        run()  # one shot spent: the next call goes through
        fp.clear()


def test_fused_dispatch_counts_and_propagates_out_of_pack():
    """``fused.dispatch`` fires at the device batch boundary; an injected
    error leaves the fused pack (only FusedOverflow falls back), and the
    dispatch counters move as the reference's do."""
    disp = treg.default_registry.register(treg.Counter("ntpu_fused_convert_dispatches", ""))
    stage = treg.default_registry.register(
        treg.Counter("ntpu_fused_convert_stage_seconds", "", ("stage",)))
    before = disp.value(), stage.value("pass1_gear")
    opt = dict(chunk_size=0x10000, backend="fused")
    with tfp.injected("fused.dispatch", "error(OSError:fused-chaos)*1"):
        with pytest.raises(OSError, match="fused-chaos"):
            pack_layer(LAYER, PackOption(**opt), device="cpu")
    with jfp.injected("fused.dispatch", "error(OSError:fused-chaos)*1"):
        with pytest.raises(OSError, match="fused-chaos"):
            j_pack_layer(LAYER, JPackOption(**opt))
    assert tfp.counts()["fused.dispatch"] == 1
    blob, _ = pack_layer(LAYER, PackOption(**opt), device="cpu")
    assert blob == j_pack_layer(LAYER, JPackOption(**opt))[0]
    assert disp.value() == before[0] + 1 and stage.value("pass1_gear") > before[1]


def test_pipeline_panic_escapes_batch_converter(monkeypatch):
    monkeypatch.setenv("NTPU_PACK_THREADS", "4")
    monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")
    tfp.inject("pipeline.compress", "panic(boom)")
    bc = BatchConverter(PackOption(**PIPE), layer_fanout=2, device="cpu")
    with pytest.raises(tfp.Panic):
        bc.convert_many([("img", [LAYER, _tar(seed=6)])])


# -------------------------------------------------------------------- trace


@pytest.mark.parametrize("pkg", ["port", "ref"])
class TestTrace:
    def test_span_tree_parent_links(self, pkg):
        tr = PKG[pkg].trace
        with tr.span("root", k=1) as root:
            with tr.span("child") as child:
                with tr.span("grandchild") as gc:
                    pass
        assert child.parent_id == root.span_id and gc.parent_id == child.span_id
        assert {s.trace_id for s in (root, child, gc)} == {root.trace_id}
        assert [s.name for s in tr.snapshot_spans()] == ["root", "child", "grandchild"]

    def test_span_records_error_attr(self, pkg):
        tr = PKG[pkg].trace
        with pytest.raises(ValueError):
            with tr.span("op"):
                raise ValueError("bad thing")
        assert tr.snapshot_spans()[-1].attrs["error"] == "ValueError: bad thing"

    def test_sample_ratio_zero_produces_zero_spans(self, pkg):
        tr = PKG[pkg].trace
        tr.configure(enabled=True, sample_ratio=0.0)
        with tr.span("root"):
            with tr.span("child"):
                assert tr.capture() is not None and not tr.capture().sampled
        assert tr.snapshot_spans() == []

    def test_disabled_is_noop_and_capture_none(self, pkg):
        tr = PKG[pkg].trace
        tr.configure(enabled=False)
        with tr.span("x"):
            assert tr.capture() is None
        assert tr.snapshot_spans() == [] and not tr.enabled()

    def test_failpoint_annotates_current_span(self, pkg):
        p = PKG[pkg]
        p.fp.inject("site.a", "delay(0)")
        with p.trace.span("op"):
            p.fp.hit("site.a")
        assert p.trace.snapshot_spans()[-1].attrs["failpoints"] == ["site.a"]


@pytest.mark.parametrize("pkg", ["port", "ref"])
@pytest.mark.parametrize("capacity", [1, 7, 64])
def test_ring_concurrent_writers_keep_count(pkg, capacity):
    """len + dropped == pushes under concurrent writers, oldest first."""
    import threading

    ring_mod = __import__(PKG[pkg].trace.__name__ + ".ring", fromlist=["SpanRing"])
    ring = ring_mod.SpanRing(capacity)

    def write(base):
        for i in range(500):
            ring.push(SimpleNamespace(start=float(base + i)))

    threads = [threading.Thread(target=write, args=(k * 1000,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(ring) + ring.dropped() == ring.pushes() == 4000
    assert len(ring) <= capacity
    starts = [sp.start for sp in ring.snapshot()]
    assert starts == sorted(starts)


@pytest.mark.parametrize(
    "env",
    [{}, {"NTPU_TRACE": "0"}, {"NTPU_TRACE_RING_CAPACITY": "17", "NTPU_TRACE_SLOW_OP_MS": "5",
                               "NTPU_TRACE_SAMPLE_RATIO": "0.25"},
     {"NTPU_TRACE_SAMPLE_RATIO": "7", "NTPU_TRACE_SLOW_OP_MS": "x"}],
    ids=["defaults", "off", "knobs", "clamped"],
)
def test_env_resolution_matches_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert ttrace.resolve_trace_config().__dict__ == jtrace.resolve_trace_config().__dict__


def test_chrome_export_matches_reference():
    spans = [
        SimpleNamespace(name=f"s{i}", trace_id=7, span_id=10 + i, parent_id=(10 if i else 0),
                        start=1000.0 + i, duration_ms=2.5 * i, attrs={"i": i}, thread="t")
        for i in range(3)
    ]
    from nydus_snapshotter_tpu.trace import export as jexport
    from nydus_snapshotter_tpu_torch.trace import export as texport

    assert texport.to_chrome_trace(spans) == jexport.to_chrome_trace(spans)
    assert texport.format_tree(spans, 7) == jexport.format_tree(spans, 7)
    with ttrace.span("a"):
        pass
    doc = json.loads(ttrace.chrome_trace_bytes())
    assert [e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"] == ["a"]


def test_propagation_across_pipeline_workers(monkeypatch):
    """Each pipeline worker opens one span in the converting caller's
    trace, as the reference's do."""
    monkeypatch.setenv("NTPU_PACK_THREADS", "4")
    monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")
    for tr, pack in ((ttrace, lambda: pack_layer(LAYER, PackOption(**PIPE), device="cpu")),
                     (jtrace, lambda: j_pack_layer(LAYER, JPackOption(**PIPE)))):
        with tr.span("convert") as root:
            pack()
        workers = [s for s in tr.snapshot_spans() if s.name.startswith("convert.")]
        assert {s.name for s in workers} == {"convert.chunk.worker", "convert.compress.worker"}
        assert all(s.trace_id == root.trace_id and s.parent_id == root.span_id for s in workers)


def test_propagation_across_batch_converter_layers(monkeypatch):
    """One ``convert`` span per image; every layer's pipeline workers,
    run on the fan-out's threads, join its trace."""
    monkeypatch.setenv("NTPU_PACK_THREADS", "4")
    monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")
    layers = [LAYER, _tar(seed=6)]
    for tr, bc in ((ttrace, BatchConverter(PackOption(**PIPE), layer_fanout=2, device="cpu")),
                   (jtrace, JBatchConverter(JPackOption(**PIPE), layer_fanout=2))):
        bc.convert_many([("img", layers)])
        spans = tr.snapshot_spans()
        roots = [s for s in spans if s.name == "convert"]
        assert len(roots) == 1 and roots[0].attrs == {"image": "img", "layers": 2}
        workers = [s for s in spans if s.name == "convert.chunk.worker"]
        assert len(workers) >= 2 and {s.trace_id for s in workers} == {roots[0].trace_id}


def test_dict_rpc_span_joins_client_trace(tmp_path):
    """A probe RPC from inside a span: the service's ``dict.rpc.probe``
    span carries the client's trace id and parents on the client's span;
    ``/metrics`` shows the RPC counters and ``/api/v1/traces`` the span."""
    import http.client
    import socket

    boot = pack_layer(LAYER, PackOption(chunk_size=0x10000, backend="hybrid"), device="cpu")[1].bootstrap
    svc = tds.DictService(device="cpu")
    svc.run(str(tmp_path / "d.sock"))
    try:
        cli = tds.DictClient(svc.sock_path)
        cli.merge(boot, "ns")
        digs = [c.digest for c in tds.Bootstrap.from_bytes(boot).chunks][:3]
        with ttrace.span("convert") as root:
            assert list(cli.probe(digs, "ns")) == [0, 1, 2]
        rpc = [s for s in ttrace.snapshot_spans() if s.name == "dict.rpc.probe"]
        assert len(rpc) == 1
        assert (rpc[0].trace_id, rpc[0].parent_id) == (root.trace_id, root.span_id)
        assert rpc[0].attrs["namespace"] == "ns"
        jcli = jds.DictClient(svc.sock_path)  # the reference's client sends the same headers
        with jtrace.span("convert") as jroot:
            jcli.probe(digs, "ns")
        assert [s.trace_id for s in ttrace.snapshot_spans() if s.name == "dict.rpc.probe"][-1] == \
            jroot.trace_id

        class Conn(http.client.HTTPConnection):
            def connect(self):
                self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                self.sock.connect(svc.sock_path)

        # the RPC counters live outside the default registry, as the
        # reference's do; /metrics renders the default registry
        assert tds._RPC_TOTAL.value("probe") >= 2 and tds._RPC_MS.labels("probe")
        for path, want in (("/metrics", "# TYPE ntpu_trace_spans_total counter"),
                           ("/api/v1/traces", '"dict.rpc.probe"')):
            c = Conn("localhost")
            c.request("GET", path)
            resp = c.getresponse()
            body = resp.read().decode()
            c.close()
            assert resp.status == 200 and want in body
        cli.close()
        jcli.close()
    finally:
        svc.stop()


# ------------------------------------------------------------------ metrics


def _metric_updates(reg_mod):
    clock = SimpleNamespace(now=0.0)
    r = reg_mod.Registry()
    c = r.register(reg_mod.Counter("ntpu_x_total", "x help", ("op",)))
    c.labels("probe").inc()
    c.labels("merge").inc(2.5)
    c.labels('we"ird\\').inc(3)
    plain = r.register(reg_mod.Counter("ntpu_plain_total", "plain"))
    plain.inc(4)
    r.register(reg_mod.Counter("ntpu_plain_total", "registered twice"))
    g = r.register(reg_mod.Gauge("ntpu_g", "g help", ("q",)))
    g.labels("a").set(1.5)
    g.labels("b").set(float("inf"))
    r.register(reg_mod.Gauge("ntpu_empty", "no series"))
    h = r.register(reg_mod.Histogram("ntpu_ms", "h help", ("op",), buckets=(1, 5, 10)))
    for v in (0.5, 3, 7, 20):
        h.labels("probe").observe(v)
    t = r.register(reg_mod.TTLGauge("ntpu_ttl", "ttl", ("d",), ttl_sec=10, clock=lambda: clock.now))
    t.labels("old").set(1)
    clock.now = 20.0
    t.labels("new").set(2)
    return r.render()


def test_registry_render_matches_reference():
    """The same sequence of updates renders the same exposition text."""
    got = _metric_updates(treg)
    assert got == _metric_updates(jreg)
    assert 'ntpu_x_total{op="we\\"ird\\\\"} 3' in got and "ntpu_ttl{d=\"old\"}" not in got


def test_pipeline_metrics_render_equal_after_same_pack(monkeypatch):
    """The pipeline's series exist under the reference's names in the
    port's default registry after a pipelined pack."""
    monkeypatch.setenv("NTPU_PACK_THREADS", "4")
    monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")
    from nydus_snapshotter_tpu_torch.parallel import pipeline as tpl

    before = tpl.snapshot_counters()
    pack_layer(LAYER, PackOption(**PIPE), device="cpu")
    after = tpl.snapshot_counters()
    assert after["runs"] == before["runs"] + 1
    assert after["stage_items"]["chunk"] == before["stage_items"]["chunk"] + 6
    text = treg.default_registry.render()
    for name in ("ntpu_convert_pipeline_stage_busy_seconds", "ntpu_convert_pipeline_runs",
                 "ntpu_trace_spans_total"):
        assert f"# TYPE {name} " in text
