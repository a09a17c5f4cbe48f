"""The port's stage-parallel pack pipeline against the JAX package's.

The pipelined lane (``backend`` "hybrid" or "numpy", more than one thread
and more than one file above the minimum chunk) must give the blob,
bootstrap and blob id of the reference's pipelined ``pack_stream`` on the
same numpy-seeded layer: at 1, 2 and 8 workers forced, every codec,
``batch_size``, v5 ``aligned_chunk``, a chunk dict, and a file-like source
(which walks serially in both). Then the pipeline under pressure (tiny
queue, budget and window; ``NTPU_PIPELINE=off``; thread leaks; a budget
shared across a ``BatchConverter`` fan-out) and under faults at each
``pipeline.*`` site (errors propagate and workers join, the budget
drains, a panic escapes), each case run in both packages.
"""

import io
import tarfile
import threading
import time

import numpy as np
import pytest

from nydus_snapshotter_tpu import failpoint as jfailpoint
from nydus_snapshotter_tpu.converter.batch import BatchConverter as JBatchConverter
from nydus_snapshotter_tpu.converter.convert import Pack as JPack
from nydus_snapshotter_tpu.converter.convert import pack_layer as j_pack_layer
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.models.bootstrap import Bootstrap as JBootstrap
from nydus_snapshotter_tpu.models.bootstrap import ChunkDict as JChunkDict
from nydus_snapshotter_tpu.parallel import pipeline as jpl
from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch.converter import Pack, PackOption, pack_layer
from nydus_snapshotter_tpu_torch.converter.batch import BatchConverter
from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap, ChunkDict
from nydus_snapshotter_tpu_torch.parallel import pipeline as pl


def _mk_layer(n_files=18, dup_every=4, seed=77) -> bytes:
    """Duplicated content (dedup is real), log-spread sizes (multi-chunk
    and sub-chunk files), as the reference suite's layer."""
    rng = np.random.default_rng(seed)
    dup = rng.integers(0, 256, 120_000, dtype=np.uint8).tobytes()
    text = (b"const a = require('b'); " * 4000)[:90_000]
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        d = tarfile.TarInfo("mod")
        d.type = tarfile.DIRTYPE
        tf.addfile(d)
        for i in range(n_files):
            if i % dup_every == 0:
                data = dup
            elif i % dup_every == 1:
                data = text
            else:
                data = rng.integers(0, 256, int(rng.integers(500, 260_000)), dtype=np.uint8).tobytes()
            ti = tarfile.TarInfo(f"mod/d{i % 5}/f{i}.bin")
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


LAYER = _mk_layer()
BASE = dict(chunk_size=0x10000, backend="hybrid")


@pytest.fixture(autouse=True)
def _clean_planes():
    """Both packages keep process-wide failpoint tables and budgets."""
    for fp in (failpoint, jfailpoint):
        fp.clear()
    yield
    for fp in (failpoint, jfailpoint):
        fp.clear()


def _threads(monkeypatch, n, **env):
    monkeypatch.setenv("NTPU_PACK_THREADS", str(n))
    monkeypatch.setenv("NTPU_PACK_THREADS_FORCE", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))


def _both(raw, kw, port_dict=None, ref_dict=None, stats=None):
    jb, jr = j_pack_layer(raw, JPackOption(**kw), chunk_dict=ref_dict)
    tb, tr = pack_layer(raw, PackOption(**kw), chunk_dict=port_dict, device="cpu", stats=stats)
    assert tb == jb
    assert tr.bootstrap == jr.bootstrap
    assert tr.blob_id == jr.blob_id
    return tb, tr


class TestByteIdentity:
    @pytest.mark.parametrize("workers", [1, 2, 8])
    @pytest.mark.parametrize(
        "kw",
        [
            {},
            {"compressor": "zstd"},
            {"compressor": "none"},
            {"batch_size": 0x10000},
            {"batch_size": 0x10000, "compressor": "zstd"},
            {"fs_version": "v5", "aligned_chunk": True},
            {"backend": "numpy"},
            {"backend": "numpy", "batch_size": 0x10000},
            {"chunking": "fixed"},
            {"digester": "blake3"},
        ],
        ids=["lz4", "zstd", "none", "batch", "batch_zstd", "v5_aligned", "numpy", "numpy_batch",
             "fixed", "blake3"],
    )
    def test_pipelined_pack_matches_reference(self, monkeypatch, workers, kw):
        _threads(monkeypatch, workers)
        stats = {}
        _blob, res = _both(LAYER, {**BASE, **kw}, stats=stats)
        assert (res.route["lane"] == "pipeline") == (workers > 1)
        assert ("pipeline_runs" in stats) == (workers > 1)

    @pytest.mark.parametrize("workers", [2, 8])
    def test_chunk_dict_matches_reference(self, monkeypatch, workers):
        _threads(monkeypatch, 1)
        kw = {**BASE, "batch_size": 0x4000}
        _blob, first = _both(LAYER, kw)
        jdict = JChunkDict(JBootstrap.from_bytes(first.bootstrap))
        tdict = ChunkDict(Bootstrap.from_bytes(first.bootstrap))
        other = _mk_layer(seed=99)  # overlaps through the duplicated block
        serial = _both(other, kw, tdict, jdict)
        _threads(monkeypatch, workers)
        blob, res = _both(other, kw, tdict, jdict)
        assert res.route["lane"] == "pipeline"
        assert blob == serial[0] and len(res.referenced_blob_ids) > 1

    def test_file_like_source_matches_reference(self, monkeypatch):
        _threads(monkeypatch, 8)
        kw = {**BASE, "compressor": "zstd"}
        jout, tout = io.BytesIO(), io.BytesIO()
        JPack(jout, io.BytesIO(LAYER), JPackOption(**kw))
        res = Pack(tout, io.BytesIO(LAYER), PackOption(**kw), device="cpu")
        assert tout.getvalue() == jout.getvalue()
        assert res.route["lane"] == "stream"

    def test_explicit_budget(self, monkeypatch):
        _threads(monkeypatch, 4)
        kw = {**BASE, "batch_size": 0x4000}
        jb, _ = j_pack_layer(LAYER, JPackOption(**kw), budget=jpl.MemoryBudget(1 << 20))
        budget = pl.MemoryBudget(1 << 20)
        tb, _ = pack_layer(LAYER, PackOption(**kw), device="cpu", budget=budget)
        assert tb == jb and budget.held == 0


class TestPressure:
    def test_tiny_queue_and_budget_backpressure(self, monkeypatch):
        """1 MiB queue, budget and window: constant backpressure and
        shedding, the same bytes."""
        _threads(monkeypatch, 8, NTPU_PIPELINE_QUEUE_MIB=1, NTPU_PIPELINE_BUDGET_MIB=1,
                 NTPU_PIPELINE_WINDOW_MIB=1)
        kw = {**BASE, "batch_size": 0x4000}
        budget = pl.MemoryBudget(1 << 20)
        tb, tr = pack_layer(LAYER, PackOption(**kw), device="cpu", budget=budget)
        jb, _ = j_pack_layer(LAYER, JPackOption(**kw), budget=jpl.MemoryBudget(1 << 20))
        assert tb == jb and tr.route["lane"] == "pipeline" and budget.held == 0

    def test_pipeline_off_knob(self, monkeypatch):
        _threads(monkeypatch, 8, NTPU_PIPELINE="off")
        stats = {}
        _blob, res = _both(LAYER, BASE, stats=stats)
        assert res.route["lane"] == "per_file" and "pipeline_runs" not in stats

    def test_many_workers_short_switch_interval(self, monkeypatch):
        """More workers than cores and a thread switch every microsecond:
        a lost update in the pipeline's shared state would change bytes."""
        import os
        import sys

        _threads(monkeypatch, 2 * (os.cpu_count() or 1) + 1)
        kw = {**BASE, "batch_size": 0x4000, "compressor": "zstd"}
        want = j_pack_layer(LAYER, JPackOption(**kw))[0]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for _ in range(3):
                assert pack_layer(LAYER, PackOption(**kw), device="cpu")[0] == want
        finally:
            sys.setswitchinterval(old)

    def test_no_thread_leak(self, monkeypatch):
        _threads(monkeypatch, 8)
        before = threading.active_count()
        for _ in range(3):
            pack_layer(LAYER, PackOption(**BASE, batch_size=0x4000), device="cpu")
        assert threading.active_count() <= before
        assert not [t for t in threading.enumerate() if t.name.startswith("ntpu-pipe")]

    def test_shared_budget_across_fanout(self, monkeypatch):
        """``BatchConverter(memory_budget_mib=)``: one private budget for
        every layer in flight, drained after the batch; images
        byte-identical to the reference's."""
        _threads(monkeypatch, 4)
        layers = [_mk_layer(seed=s) for s in (1, 2, 3)]
        kw = {**BASE, "batch_size": 0x4000}
        bc = BatchConverter(PackOption(**kw), memory_budget_mib=2, layer_fanout=3, device="cpu")
        jbc = JBatchConverter(JPackOption(**kw), memory_budget_mib=2, layer_fanout=3)
        assert bc.budget is not pl.shared_budget() and bc.budget.total == 2 << 20
        got = bc.convert_many([("img", layers), ("again", layers[:1])])
        want = jbc.convert_many([("img", layers), ("again", layers[:1])])
        for g, w in zip(got, want):
            assert (g.bootstrap, g.blob_digests, g.layer_blobs, g.new_dict_chunks) == (
                w.bootstrap, w.blob_digests, w.layer_blobs, w.new_dict_chunks)
        assert bc.budget.held == 0


class TestPrimitives:
    def test_queue_byte_bound_and_order(self):
        for mod in (pl, jpl):
            q = mod.ByteBoundedQueue(10, name="t")
            q.put("a", 6)
            q.put("b", 4)
            got = []
            t = threading.Thread(target=lambda: q.put("c", 5))
            t.start()
            time.sleep(0.05)
            assert t.is_alive()  # 10 bytes held: "c" waits
            got.append(q.get())
            t.join(2)
            got += [q.get(), q.get()]
            q.close()
            assert got == ["a", "b", "c"] and q.get() is mod.ByteBoundedQueue.CLOSED

    def test_budget_blocks_then_releases(self):
        for mod in (pl, jpl):
            b = mod.MemoryBudget(100)
            b.acquire(80)
            assert not b.try_acquire(30, timeout=0.05)
            b.release(80)
            assert b.try_acquire(30, timeout=0.05) and b.held == 30
            b.release(30)
            b.acquire(500)  # oversized: admitted alone when nothing is held
            assert b.held == 500

    @pytest.mark.parametrize(
        "env",
        [{}, {"NTPU_PIPELINE": "off"}, {"NTPU_PIPELINE": "on"},
         {"NTPU_CHUNK_THREADS": "3", "NTPU_COMPRESS_THREADS": "5", "NTPU_PIPELINE_QUEUE_MIB": "7"}],
        ids=["auto", "off", "on", "knobs"],
    )
    @pytest.mark.parametrize("n", [1, 4])
    def test_resolve_config_matches_reference(self, monkeypatch, env, n):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert pl.resolve_config(n).__dict__ == jpl.resolve_config(n).__dict__


def _pipe_threads():
    return [t for t in threading.enumerate() if t.name.startswith("ntpu-pipe")]


def _assert_joined(deadline=5.0):
    end = time.monotonic() + deadline
    while _pipe_threads() and time.monotonic() < end:
        time.sleep(0.01)
    assert not _pipe_threads(), [t.name for t in _pipe_threads()]


SITES = ["pipeline.chunk", "pipeline.queue", "pipeline.compress", "pipeline.assemble"]
# batch_size keeps the serial section writer, so the compress stage runs
CHAOS = {**BASE, "batch_size": 0x4000}


class TestChaos:
    @pytest.mark.parametrize("site", SITES)
    def test_error_propagates_and_threads_join(self, monkeypatch, site):
        _threads(monkeypatch, 4)
        for fp, pack in ((failpoint, lambda: pack_layer(LAYER, PackOption(**CHAOS), device="cpu")),
                         (jfailpoint, lambda: j_pack_layer(LAYER, JPackOption(**CHAOS)))):
            fp.inject(site, "error(OSError:injected)")
            with pytest.raises(OSError, match="injected"):
                pack()
            _assert_joined()
            assert fp.counts().get(site, 0) >= 1
            fp.clear()

    @pytest.mark.parametrize("site", SITES)
    def test_one_shot_abort_then_identical_retry(self, monkeypatch, site):
        _threads(monkeypatch, 4)
        failpoint.inject(site, "error(RuntimeError:midlayer)*1")
        with pytest.raises(RuntimeError, match="midlayer"):
            pack_layer(LAYER, PackOption(**CHAOS), device="cpu")
        _assert_joined()
        retry, _ = pack_layer(LAYER, PackOption(**CHAOS), device="cpu")
        assert retry == j_pack_layer(LAYER, JPackOption(**CHAOS))[0]

    def test_panic_escapes(self, monkeypatch):
        _threads(monkeypatch, 4)
        failpoint.inject("pipeline.compress", "panic(boom)")
        with pytest.raises(failpoint.Panic):
            pack_layer(LAYER, PackOption(**CHAOS), device="cpu")
        _assert_joined()

    def test_budget_drains_after_fault(self, monkeypatch):
        _threads(monkeypatch, 4)
        budget = pl.MemoryBudget(64 << 20)
        failpoint.inject("pipeline.compress", "error(OSError:mid)*1")
        out = io.BytesIO()
        with pytest.raises(OSError):
            Pack(out, LAYER, PackOption(**CHAOS), device="cpu", budget=budget)
        _assert_joined()
        assert budget.held == 0

    def test_delay_changes_nothing(self, monkeypatch):
        _threads(monkeypatch, 4)
        failpoint.inject("pipeline.chunk", "delay(0.001)")
        blob, _ = pack_layer(LAYER, PackOption(**CHAOS), device="cpu")
        assert blob == j_pack_layer(LAYER, JPackOption(**CHAOS))[0]
