"""Stage clocks on the port's batch conversion path.

The registry's always-on counters (``ntpu_batch_stage_seconds``,
``ntpu_pack_stage_seconds``, the fused lane's pass-1 split, the
collector's ``ntpu_gc_*``), the spans under each image's ``convert`` root,
and the profiler ranges every span opens while a ``torch.profiler``
records.
"""

import gc
import io
import os
import subprocess
import sys
import tarfile
import threading
import time

import numpy as np
import pytest
import torch

from nydus_snapshotter_tpu_torch import trace
from nydus_snapshotter_tpu_torch.converter import PackOption, pack
from nydus_snapshotter_tpu_torch.converter import batch as batch_mod
from nydus_snapshotter_tpu_torch.converter.batch import BatchConverter
from nydus_snapshotter_tpu_torch.metrics import gc_pauses
from nydus_snapshotter_tpu_torch.metrics import registry as reg
from nydus_snapshotter_tpu_torch.ops import fused_convert
from nydus_snapshotter_tpu_torch.trace import export, ring

BATCH_STAGES = ("fanout", "merge", "dict_grow", "train")
PACK_STAGES = ("scan", "chunk_digest", "fused_pack", "dedup", "assemble", "bootstrap")


def mk_tar(seed: int, n_files: int = 6, size: int = 400_000) -> bytes:
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for i in range(n_files):
            data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            ti = tarfile.TarInfo(f"l{seed}/f{i}")
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


@pytest.fixture(scope="module")
def layers():
    return [mk_tar(seed) for seed in range(3)]


@pytest.fixture(autouse=True)
def _tracer():
    trace.configure(enabled=True)
    yield
    trace.reset()


def batch_seconds() -> dict:
    return {k: batch_mod._STAGE_SECONDS.value(k) for k in BATCH_STAGES}


def pack_seconds() -> dict:
    return {k: pack._STAGE_SECONDS.value(k) for k in PACK_STAGES}


def converter() -> BatchConverter:
    return BatchConverter(PackOption(backend="numpy", chunk_size=0x10000), layer_fanout=3,
                          device="cpu")


def test_batch_stages_cover_the_image_wall(layers):
    bc = converter()
    bc.convert_many([("warm", layers[:1])])
    before, images0 = batch_seconds(), batch_mod._IMAGES.value()
    t0 = time.perf_counter()
    bc.convert_image("img", layers)
    wall = time.perf_counter() - t0
    after = batch_seconds()
    moved = {k: after[k] - before[k] for k in BATCH_STAGES}
    assert all(v > 0 for v in moved.values()), moved
    assert sum(moved.values()) == pytest.approx(wall, rel=0.05)
    assert batch_mod._IMAGES.value() == images0 + 1


def test_pack_counters_advance_by_the_stats_split(layers):
    before, layers0 = pack_seconds(), pack._LAYERS.value()
    stats = {}
    pack.pack_layer(layers[0], PackOption(backend="numpy", chunk_size=0x10000), device="cpu",
                    stats=stats)
    after = pack_seconds()
    for k in PACK_STAGES:
        # the same seconds, up to the rounding of the counter's running sum
        assert after[k] - before[k] == pytest.approx(stats[k], rel=1e-9, abs=1e-12), k
    assert pack._LAYERS.value() == layers0 + 1


def test_fused_pass1_split(layers):
    eng = fused_convert.FusedDeviceEngine(chunk_size=0x1000, device="cpu")
    stage = fused_convert._STAGE_SECONDS
    keys = ("pass1_gear", "pass1_layout", "pass1_upload")
    before = {k: stage.value(k) for k in keys}
    data = np.random.default_rng(3).integers(0, 256, 50_000, dtype=np.uint8)
    eng.process_many([data, data[:7000]])
    moved = {k: stage.value(k) - before[k] for k in keys}
    assert moved["pass1_layout"] > 0 and moved["pass1_upload"] > 0
    assert moved["pass1_layout"] + moved["pass1_upload"] <= moved["pass1_gear"]
    names = [s.name for s in trace.snapshot_spans()]
    assert names == ["fused.pass1", "fused.host_resolve", "fused.pass2"]


def test_a_fused_dispatch_registers_nothing(monkeypatch):
    """The fused lane's counters are registered once, at import."""
    eng = fused_convert.FusedDeviceEngine(chunk_size=0x1000, device="cpu")
    data = np.random.default_rng(4).integers(0, 256, 20_000, dtype=np.uint8)
    eng.process_many([data])  # any lazy import of the first dispatch

    def refuse(metric):
        raise AssertionError(f"{metric.name} registered on a dispatch")

    monkeypatch.setattr(reg.default_registry, "register", refuse)
    bytes0 = fused_convert._BYTES.value()
    eng.process_many([data])
    assert fused_convert._BYTES.value() == bytes0 + data.size


def test_spans_under_the_convert_root(layers):
    converter().convert_image("img", layers)
    spans = trace.snapshot_spans()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    (root,) = by_name["convert"]
    (fanout,) = by_name["batch.fanout"]
    for name in ("batch.fanout", "batch.merge", "batch.dict_grow"):
        (sp,) = by_name[name]
        assert (sp.trace_id, sp.parent_id) == (root.trace_id, root.span_id)
    packs = by_name["pack"]
    assert sorted(s.attrs["layer"] for s in packs) == [0, 1, 2]
    assert all(s.parent_id == fanout.span_id and s.thread != root.thread for s in packs)
    assert sorted(s.attrs["bytes"] for s in packs) == sorted(len(t) for t in layers)
    assert all(s.attrs["route"]["lane"] for s in packs)
    assembles = by_name["pack.assemble"]
    assert {s.parent_id for s in assembles} == {s.span_id for s in packs}


def test_gc_collect_advances_generation_2():
    seconds0, count0 = gc_pauses.PAUSE_SECONDS.value("2"), gc_pauses.COLLECTIONS.value("2")
    gc.collect(2)
    assert gc_pauses.COLLECTIONS.value("2") == count0 + 1
    assert gc_pauses.PAUSE_SECONDS.value("2") > seconds0
    text = reg.default_registry.render()
    assert 'ntpu_gc_pause_seconds{generation="2"}' in text
    assert 'ntpu_gc_collections{generation="0"}' in text


def test_a_collection_under_held_locks_completes():
    """A collection that starts on a thread holding the registry's, the gc
    counters', a stage counter's and the span ring's locks: the callback
    takes none of them (they are not reentrant), so it completes."""
    tr = trace.configure(enabled=True)
    locks = [reg.default_registry._lock, gc_pauses.PAUSE_SECONDS._lock,
             gc_pauses.COLLECTIONS._lock, batch_mod._STAGE_SECONDS._lock,
             pack._STAGE_SECONDS._lock, *(st.lock for st in tr.ring._stripes)]
    count0 = gc_pauses.COLLECTIONS.value("2")
    done = threading.Event()

    def collect_under_locks():
        for lk in locks:
            lk.acquire()
        try:
            gc.collect(2)
            gc.collect(0)
        finally:
            for lk in reversed(locks):
                lk.release()
        done.set()

    t = threading.Thread(target=collect_under_locks, daemon=True)
    t.start()
    assert done.wait(60), "a collection under the held locks did not complete"
    assert gc_pauses.COLLECTIONS.value("2") >= count0 + 1


def test_collection_counts_match_the_interpreter_under_threads():
    """More allocating threads than cores, a short switch interval: every
    collection the interpreter counts (``gc.get_stats``) is counted once
    by the hook, whichever thread ran it."""
    before = [g["collections"] for g in gc.get_stats()]
    ours = [gc_pauses.COLLECTIONS.value(str(g)) for g in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    stop = time.monotonic() + 2.0

    def churn():
        while time.monotonic() < stop:
            junk = [[i] for i in range(2000)]
            junk.append(junk)
            del junk

    threads = [threading.Thread(target=churn, daemon=True) for _ in range(2 * (os.cpu_count() or 2))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    after = [g["collections"] for g in gc.get_stats()]
    moved = [gc_pauses.COLLECTIONS.value(str(g)) - ours[g] for g in range(3)]
    assert moved == [a - b for a, b in zip(after, before)]
    assert moved[0] > 100


def test_profiler_holds_the_program_ranges(layers):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    bc = converter()
    main = threading.get_ident()
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        bc.convert_image("img", layers)
        gc.collect(2)
    events = prof.events()
    names = {e.name for e in events}
    program = {"convert", "batch.fanout", "batch.merge", "batch.dict_grow", "pack",
               "pack.assemble", "gc.gen2"}
    assert program <= names
    # op-scope ranges, not user annotations: on a card a user annotation
    # would also lay an interval over its kernels on the device timeline
    assert not any(e.is_user_annotation for e in events if e.name in program)
    (conv,) = [e for e in events if e.name == "convert"]
    packs = [e for e in events if e.name == "pack"]
    assert len(packs) == 3
    # the packs ran on the pool's threads, inside the image's range
    assert {e.thread for e in packs} - {conv.thread}
    assert all(conv.time_range.start <= e.time_range.start and e.time_range.end
               <= conv.time_range.end for e in packs)
    assert threading.get_ident() == main
    # no profiler: the spans open no range and record as before
    from nydus_snapshotter_tpu_torch.utils import profiler_ranges

    assert not profiler_ranges.recording()
    with trace.span("after") as sp:
        assert sp._range is None


def test_ntpu_trace_0_records_no_span_and_counters_advance(layers, monkeypatch):
    monkeypatch.setenv("NTPU_TRACE", "0")
    trace.reset()
    assert not trace.enabled()
    before, pack0 = batch_seconds(), pack_seconds()
    converter().convert_image("img", layers[:2])
    assert trace.snapshot_spans() == []
    assert all(batch_seconds()[k] > before[k] for k in BATCH_STAGES)
    assert pack_seconds()["dedup"] > pack0["dedup"]


def test_slow_op_tree_is_built_from_its_own_trace_only():
    tr = trace.configure(enabled=True, slow_op_threshold_ms=1.0)
    for i in range(50):
        with trace.span(f"other{i}"):
            with trace.span("child"):
                pass
    calls = []
    orig = tr.ring.snapshot
    tr.ring.snapshot = lambda: calls.append(1) or orig()
    with trace.span("root"):
        with trace.span("a"):
            with trace.span("b"):
                time.sleep(0.005)
    assert calls == []  # the recorder no longer snapshots the whole ring
    rec = trace.slow_ops()[-1]
    assert rec["op"] == "root"
    assert [line.split()[0] for line in rec["tree"].splitlines()] == ["root", "a", "b"]
    root = [s for s in tr.ring.snapshot() if s.name == "root"][0]
    assert {s.name for s in tr.ring.of_trace(root.trace_id)} == {"root", "a", "b"}
    assert export.format_tree(tr.ring.of_trace(root.trace_id), root.trace_id) == rec["tree"]


def test_lazy_counter_with_labels():
    c = reg.LazyCounter("ntpu_test_lazy_labelled", "test", ("k",))
    totals = {("x",): 1.5, ("y",): 2}
    c.bind(lambda: totals)
    assert c.value("x") == 1.5 and c.value("y") == 2.0
    totals[("x",)] = 4
    assert 'ntpu_test_lazy_labelled{k="x"} 4' in c.render()
    assert ring.LazyCounter is reg.LazyCounter
    unlabelled = reg.LazyCounter("ntpu_test_lazy_plain", "test")
    unlabelled.bind(lambda: 7)
    assert unlabelled.value() == 7.0


def test_profiler_flag_read_imports_no_torch():
    """The tracer's profiler check reads ``sys.modules``; here torch is
    loaded and the flag follows a recording profiler."""
    from torch.profiler import ProfilerActivity, profile

    from nydus_snapshotter_tpu_torch.utils import profiler_ranges

    assert not profiler_ranges.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiler_ranges.recording()
        with trace.span("inside") as sp:
            assert sp._range is not None
    assert not profiler_ranges.recording()
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_a_collection_while_torch_imports_its_profiler(monkeypatch):
    """A gen-2 collection can run while ``torch.autograd.profiler`` is in
    ``sys.modules`` but not yet initialised: the hook reads no profiler
    flag then, and raises nothing."""
    import types

    from nydus_snapshotter_tpu_torch.utils import profiler_ranges

    monkeypatch.setitem(sys.modules, "torch.autograd.profiler", types.ModuleType("partial"))
    monkeypatch.setattr(profiler_ranges, "_flags", None)
    assert profiler_ranges.recording() is False
    count0 = gc_pauses.COLLECTIONS.value("2")
    gc_pauses._on_gc("start", {"generation": 2})
    gc_pauses._on_gc("stop", {"generation": 2})
    assert gc_pauses.COLLECTIONS.value("2") == count0 + 1


def test_trace_and_the_gc_hook_import_no_torch():
    """Spans, the gc hook and its scrape in a fresh interpreter: torch is
    never loaded, and the profiler check stays off."""
    code = (
        "import gc, sys\n"
        "from nydus_snapshotter_tpu_torch import trace\n"
        "from nydus_snapshotter_tpu_torch.metrics import default_registry\n"
        "with trace.span('convert'):\n"
        "    with trace.span('batch.merge') as sp:\n"
        "        assert sp._range is None\n"
        "gc.collect(2)\n"
        "assert 'ntpu_gc_collections{generation=\"2\"} 1' in default_registry.render()\n"
        "print('TORCH', 'torch' in sys.modules)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TORCH False" in proc.stdout
