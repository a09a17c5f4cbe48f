"""The PyTorch port's growing chunk dict against the JAX package's.

Both packages build, grow, save and load single-shard dicts from the same
numpy-seeded digests. The reference runs as its own tests run it: its
native host arms (``probe_backend="host"``), the Pallas probe in interpret
mode where noted. The port runs on the CPU, where kernel K3's plain version
answers every device probe. Answers are integers: equality is exact.
"""

import os
import threading

import numpy as np
import pytest
import torch

from nydus_snapshotter_tpu.ops import fused_convert as jfc
from nydus_snapshotter_tpu.ops import native_cdc as j_native
from nydus_snapshotter_tpu.parallel import mesh as mesh_lib
from nydus_snapshotter_tpu.parallel.sharded_dict import DictEpochError as JDictEpochError
from nydus_snapshotter_tpu.parallel.sharded_dict import ShardedChunkDict as JDict
from nydus_snapshotter_tpu_torch.ops import fused_convert, native_cdc, probe_cuda
from nydus_snapshotter_tpu_torch.parallel import sharded_dict
from nydus_snapshotter_tpu_torch.parallel.sharded_dict import DictEpochError, ShardedChunkDict


def _digests(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, (n, 8), dtype=np.uint32)


def _port(digests, **kw):
    return ShardedChunkDict(digests, device="cpu", **kw)


def _ref(digests, **kw):
    kw.setdefault("probe_backend", "host")
    return JDict(digests, mesh_lib.make_mesh(1), **kw)


def _same_tables(pd: ShardedChunkDict, jd: JDict) -> None:
    keys, values, depth, epoch = pd.fused_probe_tables()
    jkeys, jvalues, jdepth, jepoch = jd.fused_probe_tables()
    assert np.array_equal(keys, jkeys) and np.array_equal(values, jvalues)
    assert (depth, epoch, pd.rebuild_epoch, pd.n_entries) == (
        jdepth, jepoch, jd.rebuild_epoch, jd.n_entries
    )
    assert pd._ensure_unique_count() == jd._ensure_unique_count()


@pytest.fixture(autouse=True)
def _native_engine_is_the_ports_own():
    """The port loads its own build of the chunk engine, never the
    reference package's native/bin library."""
    yield
    path = native_cdc.library_path()
    assert path.parent == native_cdc.BUILD_DIR and path.exists()
    assert "nydus_snapshotter_tpu/native" not in str(native_cdc.load()._name)


class TestBuild:
    def test_native_and_numpy_builds_lookup_equivalent(self, monkeypatch):
        """The native build and the numpy lockstep build place duplicates
        and chains differently; every lookup answer agrees."""
        d = _digests(1, 20_000)
        d[5] = d[2]
        d[19_999] = d[0]
        native = _port(d)
        monkeypatch.setattr(native_cdc, "dict_build_available", lambda: False)
        numpy_arm = _port(d)
        q = np.concatenate([d[:3000], d[[5, 2, 19_999, 0]], _digests(2, 500)])
        assert np.array_equal(native.lookup_u32(q), numpy_arm.lookup_u32(q))
        assert np.array_equal(native.lookup_u32(d[[5, 19_999]]), [2, 0])

    @pytest.mark.parametrize("n", [0, 1, 5000, 40_000])
    def test_tables_equal_reference_native_build(self, n):
        """Native on both sides: the same tables, max chain and answers."""
        d = _digests(3 + n, n)
        if n > 100:
            d[n - 50 :] = d[:50]  # duplicates: first insertion wins
        pd, jd = _port(d), _ref(d)
        _same_tables(pd, jd)
        q = np.concatenate([d, _digests(4, 300)])
        assert np.array_equal(pd.lookup_u32(q), jd.lookup_u32(q))

    def test_answers_equal_reference_pallas_probe(self):
        d = _digests(5, 3000)
        jd = _ref(d, probe_backend="pallas")  # interpret mode on the CPU
        q = np.concatenate([d[::7], _digests(6, 200)])
        for backend in ("auto", "device", "pallas", "host"):
            assert np.array_equal(_port(d, probe_backend=backend).lookup_u32(q), jd.lookup_u32(q))

    def test_bad_arguments_raise(self):
        with pytest.raises(ValueError, match="probe backend"):
            _port(_digests(7, 10), probe_backend="gpu")
        with pytest.raises(ValueError, match="load_factor"):
            _port(_digests(7, 10), load_factor=1.0)


class TestGrowth:
    def test_old_indices_stable_across_batches(self):
        base = _digests(10, 4000)
        pd, jd = _port(base), _ref(base)
        before = pd.lookup_u32(base)
        assert np.array_equal(before, np.arange(len(base)))
        total = len(base)
        for b in range(6):
            batch = _digests(11 + b, 500 + 97 * b)
            idx = pd.insert_u32(batch)
            assert np.array_equal(idx, np.arange(total, total + len(batch)))
            assert np.array_equal(idx, jd.insert_u32(batch))
            total += len(batch)
            assert np.array_equal(pd.lookup_u32(base), before)
        _same_tables(pd, jd)

    @pytest.mark.parametrize("backend", ["auto", "host"])
    def test_growth_equivalent_to_fresh_build(self, backend):
        base, extra = _digests(20, 3000), _digests(21, 2500)
        # duplicates inside the batch and against the dict
        batch = np.concatenate([extra[:1500], base[100:300], extra[:50], extra[1500:]])
        pd, jd = _port(base, probe_backend=backend), _ref(base)
        got = pd.insert_u32(batch)
        assert np.array_equal(got, jd.insert_u32(batch))
        fresh = _port(np.concatenate([base, batch]))
        q = np.concatenate([base, extra, _digests(22, 800)])
        assert np.array_equal(pd.lookup_u32(q), fresh.lookup_u32(q))
        assert np.array_equal(pd.lookup_u32(q), jd.lookup_u32(q))
        assert np.array_equal(got, fresh.lookup_u32(batch))
        _same_tables(pd, jd)

    def test_first_insert_into_empty_dict(self):
        """An empty dict takes the vectorized path (lookup under the lock,
        then a rebuild into headroom), as the service's first merge does."""
        digs = [d.tobytes() for d in _digests(23, 64)]
        pd = _port(np.zeros((0, 8), np.uint32))
        jd = _ref(np.zeros((0, 8), np.uint32))
        idx = pd.insert_digests(digs + digs[:8])
        assert np.array_equal(idx, jd.insert_digests(digs + digs[:8]))
        assert np.array_equal(idx[64:], np.arange(8))
        assert np.array_equal(pd.lookup_digests(digs), np.arange(64))
        _same_tables(pd, jd)

    def test_rebuild_on_load_factor_breach_preserves_values(self):
        base = _digests(30, 200)
        pd = _port(base, capacity_factor=1.5, load_factor=0.6)
        jd = _ref(base, capacity_factor=1.5, load_factor=0.6)
        cap0 = pd.capacity
        big = _digests(31, 8000)
        assert np.array_equal(pd.insert_u32(big), jd.insert_u32(big))
        assert pd.capacity > cap0 and pd.rebuild_epoch > 0
        fresh = _port(np.concatenate([base, big]))
        q = np.concatenate([base, big[::7]])
        assert np.array_equal(pd.lookup_u32(q), fresh.lookup_u32(q))
        assert np.array_equal(pd.lookup_u32(base), np.arange(len(base)))
        _same_tables(pd, jd)

    @pytest.mark.parametrize("backend", ["auto", "pallas"])
    def test_deeper_chain_restages_padded_window(self, backend):
        """An insert that deepens a chain past the staged window: the next
        probe must re-pad the device copy (a copy padded for the old depth
        would miss rows past its window)."""
        base = _digests(40, 2000)
        pd, jd = _port(base, probe_backend=backend), _ref(base)
        assert np.array_equal(pd.lookup_u32(base), np.arange(2000))  # stages W for the old depth
        old_w = probe_cuda.window_rows(pd.max_depth)
        restages = pd.restages
        crowd = _digests(41, 80)
        crowd[:, 1] = base[0, 1]  # one chain: every entry starts at base[0]'s slot
        idx = pd.insert_u32(crowd)
        assert np.array_equal(idx, jd.insert_u32(crowd))
        assert pd.max_depth > old_w
        got = pd.lookup_u32(crowd)
        assert np.array_equal(got, np.arange(2000, 2080)) and pd.restages == restages + 1
        tk, tv, cap, depth = pd.device_snapshot()
        assert (cap, depth) == (pd.capacity, pd.max_depth)
        assert tk.shape[0] == cap + probe_cuda.window_rows(depth)
        assert np.array_equal(got, jd.lookup_u32(crowd))
        _same_tables(pd, jd)

    @pytest.mark.parametrize("backend", ["auto", "pallas"])
    def test_upsert_overflow_falls_back_on_live_tables(self, backend):
        """More than INSERT_MAX_PROBE new digests on one chain, below the
        load factor: the native upsert places a prefix and overflows. The
        fallback must read that prefix from the live host tables (a device
        copy staged before the insert lacks it) and restage nothing."""
        base = _digests(44, 1000)
        probe = _port(base)
        crowd = _digests(45, sharded_dict.INSERT_MAX_PROBE + 60)
        # One chain at this capacity, from the first run of empty slots as
        # long as the table's depth: the prefix the upsert places there lies
        # inside the probe window. The high bits spread it in a rebuild.
        depth = probe.max_depth
        empty = np.convolve(probe._values[0] == 0, np.ones(depth, int), "valid") == depth
        slot = np.uint32(np.argmax(empty))
        assert empty[slot]
        mask = np.uint32(probe.capacity - 1)
        crowd[:, 1] = (crowd[:, 1] & ~mask) | slot
        batch = np.concatenate([crowd, crowd[:20]])
        assert probe._ensure_unique_count() + len(batch) <= int(probe.load_factor * probe.capacity)
        assert probe._insert_fast(batch, probe.n_entries) is None  # the upsert overflows
        pd, jd = _port(base, probe_backend=backend), _ref(base)
        assert np.array_equal(pd.lookup_u32(base), np.arange(1000))  # stages the old tables
        restages = pd.restages
        idx = pd.insert_u32(batch)
        assert pd.restages == restages
        assert np.array_equal(idx, jd.insert_u32(batch))
        want = np.concatenate([np.arange(1000, 1000 + len(crowd)), np.arange(1000, 1020)])
        assert np.array_equal(idx, want)
        fresh = _port(np.concatenate([base, batch]))
        q = np.concatenate([base, crowd, _digests(46, 200)])
        assert np.array_equal(pd.lookup_u32(q), fresh.lookup_u32(q))
        assert np.array_equal(pd.lookup_u32(q), jd.lookup_u32(q))
        _same_tables(pd, jd)

    def test_restage_once_per_mutation(self):
        pd = _port(_digests(42, 1000))
        q = _digests(42, 1000)[:100]
        for _ in range(3):
            pd.lookup_u32(q)
        assert pd.restages == 1
        pd.insert_u32(np.zeros((0, 8), np.uint32))  # empty batch: no mutation
        pd.insert_u32(_digests(42, 1000)[:10])  # all present: no table write
        pd.lookup_u32(q)
        assert pd.restages == 1
        pd.insert_u32(_digests(43, 10))
        pd.lookup_u32(q)
        pd.lookup_u32(q)
        assert pd.restages == 2

    def test_epoch_and_journal_replay(self):
        base = _digests(50, 1000)
        # 4x headroom: the four journal batches must not breach the load
        # factor (a rebuild would compact the journal mid-test).
        pd, jd = _port(base, capacity_factor=4.0), _ref(base, capacity_factor=4.0)
        seen = [0]
        for b in range(4):
            batch = _digests(51 + b, 300)
            pd.insert_u32(batch)
            jd.insert_u32(batch)
            assert pd.epoch == seen[-1] + 1
            seen.append(pd.epoch)
        digs, vals, epoch = pd.entries_since(seen[1])
        jdigs, jvals, jepoch = jd.entries_since(seen[1])
        assert np.array_equal(digs, jdigs) and np.array_equal(vals, jvals) and epoch == jepoch
        assert len(digs) == 900 and np.array_equal(pd.lookup_u32(digs), vals)
        assert len(pd.entries_since(pd.epoch)[0]) == 0
        big = _digests(60, 60_000)
        pd.insert_u32(big)
        jd.insert_u32(big)
        assert pd.rebuild_epoch == jd.rebuild_epoch > 0
        with pytest.raises(DictEpochError):
            pd.entries_since(0)
        with pytest.raises(JDictEpochError):
            jd.entries_since(0)

    def test_copy_is_independent(self):
        pd = _port(_digests(61, 500))
        pd.insert_u32(_digests(62, 50))
        other = pd.copy()
        assert (other.epoch, other.n_entries, other.max_depth) == (pd.epoch, 550, pd.max_depth)
        other.insert_u32(_digests(63, 50))
        assert pd.n_entries == 550 and (pd.lookup_u32(_digests(63, 50)) == -1).all()
        assert np.array_equal(other.lookup_u32(_digests(63, 50)), np.arange(550, 600))

    def test_concurrent_probe_during_insert(self):
        """Probes racing inserts never see torn state: an old digest always
        answers its index; a new one -1 or an index past the base."""
        base = _digests(70, 6000)
        batches = [_digests(71 + i, 1500) for i in range(8)]
        pd = _port(base)
        stop = threading.Event()
        errors: list = []

        def prober():
            qold, want_old = base[::5], np.arange(len(base))[::5]
            allnew = np.concatenate(batches)[::11]
            try:
                while not stop.is_set():
                    if not np.array_equal(pd.lookup_u32(qold), want_old):
                        errors.append("old index moved")
                        return
                    ans = pd.lookup_u32(allnew)
                    if not np.all((ans == -1) | (ans >= len(base))):
                        errors.append("new digest resolved below base range")
                        return
            except Exception as e:  # surfaced by the assert below
                errors.append(repr(e))

        threads = [threading.Thread(target=prober) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            for b in batches:
                pd.insert_u32(b)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        jd = _ref(np.concatenate([base] + batches))
        q = np.concatenate([base[::7], np.concatenate(batches)[::13]])
        assert np.array_equal(pd.lookup_u32(q), jd.lookup_u32(q))


def _write_v4(path, jd: JDict) -> None:
    """The reference's v4 raw layout (magic, five u64 fields, tables)."""
    keys, values = jd._host_keys, jd._host_values
    with open(path, "wb") as f:
        f.write(b"NTPUDICT")
        f.write(np.asarray([4, jd.n_shards, jd.n_entries, jd.capacity, jd.max_depth],
                           dtype=np.uint64).tobytes())
        keys.tofile(f)
        values.tofile(f)


def _write_npz(path, jd: JDict) -> None:
    np.savez_compressed(
        path, format_version=np.int64(1), n_shards=jd.n_shards, n_entries=jd.n_entries,
        keys=jd._host_keys, values=jd._host_values,
    )


class TestPersistence:
    def _grown(self, tmp_path):
        """A reference dict saved, then grown twice and saved
        incrementally: a v5 file with a two-batch tail."""
        base = _digests(80, 4000)
        jd = _ref(base)
        path = str(tmp_path / "ref.dict")
        jd.save(path)
        b1, b2 = _digests(81, 700), _digests(82, 300)
        jd.insert_u32(b1)
        assert jd.save_incremental(path) == {"mode": "append", "appended": 700}
        jd.insert_u32(b2)
        assert jd.save_incremental(path) == {"mode": "append", "appended": 300}
        q = np.concatenate([base, b1, b2, _digests(83, 200)])
        return jd, path, q

    def test_reference_v5_with_tail_loads_in_port(self, tmp_path):
        jd, path, q = self._grown(tmp_path)
        pd = ShardedChunkDict.load(path, device="cpu")
        jl = JDict.load(path, mesh_lib.make_mesh(1), probe_backend="host")
        assert np.array_equal(pd.lookup_u32(q), jd.lookup_u32(q))
        _same_tables(pd, jl)
        assert (pd.epoch, pd.n_entries) == (jd.epoch, jd.n_entries)
        digs, vals, _ = pd.entries_since(0)  # the replayed tail is the journal
        assert len(digs) == 1000 and np.array_equal(pd.lookup_u32(digs), vals)

    def test_port_v5_with_tail_loads_in_reference(self, tmp_path):
        base = _digests(84, 4000)
        pd = _port(base)
        path = str(tmp_path / "port.dict")
        pd.save(path)
        size0 = os.path.getsize(path)
        b1, b2 = _digests(85, 700), _digests(86, 300)
        pd.insert_u32(b1)
        assert pd.save_incremental(path) == {"mode": "append", "appended": 700}
        pd.insert_u32(b2)
        assert pd.save_incremental(path) == {"mode": "append", "appended": 300}
        assert os.path.getsize(path) - size0 == 1000 * (32 + 8)  # the tail, not the table
        jl = JDict.load(path, mesh_lib.make_mesh(1), probe_backend="host")
        q = np.concatenate([base, b1, b2, _digests(87, 200)])
        assert np.array_equal(jl.lookup_u32(q), pd.lookup_u32(q))
        assert (jl.epoch, jl.n_entries) == (pd.epoch, pd.n_entries)
        # and the same file back in the port, tail replayed
        pl = ShardedChunkDict.load(path, device="cpu")
        _same_tables(pl, jl)

    def test_full_save_bytes_equal_reference(self, tmp_path):
        d = _digests(88, 3000)
        pd, jd = _port(d), _ref(d)
        for dd in (pd, jd):
            dd.insert_u32(_digests(89, 400))
        pd.save(str(tmp_path / "p"))
        jd.save(str(tmp_path / "j"))
        assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()

    @pytest.mark.parametrize("fmt", ["v4", "npz"])
    def test_legacy_formats_load_in_both(self, tmp_path, fmt):
        d = _digests(90, 3000)
        jd = _ref(d)
        path = str(tmp_path / f"legacy.{fmt}")
        (_write_v4 if fmt == "v4" else _write_npz)(path, jd)
        pd = ShardedChunkDict.load(path, device="cpu")
        jl = JDict.load(path, mesh_lib.make_mesh(1), probe_backend="host")
        _same_tables(pd, jl)
        q = np.concatenate([d[::3], _digests(91, 100)])
        assert np.array_equal(pd.lookup_u32(q), jd.lookup_u32(q))
        # growth after a legacy load: copy-on-insert, counts recovered
        b = _digests(92, 500)
        assert np.array_equal(pd.insert_u32(b), jl.insert_u32(b))
        _same_tables(pd, jl)
        assert np.array_equal(pd.lookup_u32(b), np.arange(3000, 3500))

    @pytest.mark.parametrize("shards", [2, 4])
    def test_multi_shard_reference_file_loads_into_one_shard(self, tmp_path, shards):
        d = _digests(93, 5000)
        jd = JDict(d, mesh_lib.make_mesh(shards), probe_backend="host")
        jd.insert_u32(_digests(94, 300))
        path = str(tmp_path / "sharded.dict")
        jd.save(path)
        pd = ShardedChunkDict.load(path, device="cpu")
        jl = JDict.load(path, mesh_lib.make_mesh(1), probe_backend="host")
        assert pd.capacity == jl.capacity
        _same_tables(pd, jl)
        q = np.concatenate([d[::5], _digests(94, 300), _digests(95, 100)])
        assert np.array_equal(pd.lookup_u32(q), jd.lookup_u32(q))

    def test_mmap_load_copies_on_first_insert(self, tmp_path):
        pd = _port(_digests(96, 2000))
        path = str(tmp_path / "m.dict")
        pd.save(path)
        before = (tmp_path / "m.dict").read_bytes()
        pl = ShardedChunkDict.load(path, device="cpu")
        assert not pl.fused_probe_tables()[0].flags.writeable
        assert np.array_equal(pl.lookup_u32(_digests(96, 2000)), np.arange(2000))
        pl.insert_u32(_digests(97, 300))
        assert pl.fused_probe_tables()[0].flags.writeable
        assert (tmp_path / "m.dict").read_bytes() == before
        assert np.array_equal(pl.lookup_u32(_digests(97, 300)), np.arange(2000, 2300))

    @pytest.mark.parametrize("mode", ["append", "compact", "no_file"])
    def test_save_incremental_modes(self, tmp_path, mode):
        base = _digests(100, 200 if mode == "compact" else 3000)
        kw = {"capacity_factor": 1.5, "load_factor": 0.6} if mode == "compact" else {}
        pd, jd = _port(base, **kw), _ref(base, **kw)
        path_p, path_j = str(tmp_path / "p.dict"), str(tmp_path / "j.dict")
        if mode != "no_file":
            pd.save(path_p)
            jd.save(path_j)
        batch = _digests(101, 8000 if mode == "compact" else 500)
        pd.insert_u32(batch)
        jd.insert_u32(batch)
        got, want = pd.save_incremental(path_p), jd.save_incremental(path_j)
        assert got == want
        assert got["mode"] == ("append" if mode == "append" else "full")
        if mode == "compact":
            assert pd.rebuild_epoch > 0
        assert (tmp_path / "p.dict").read_bytes() == (tmp_path / "j.dict").read_bytes()
        pl = ShardedChunkDict.load(path_p, device="cpu")
        q = np.concatenate([base[::3], batch[::5]])
        assert np.array_equal(pl.lookup_u32(q), jd.lookup_u32(q))
        assert (pl.epoch, pl.rebuild_epoch, pl.n_entries) == (
            jd.epoch, jd.rebuild_epoch, jd.n_entries
        )

    def test_load_rejects_bad_format_version(self, tmp_path):
        pd = _port(_digests(102, 100))
        path = str(tmp_path / "d.bin")
        pd.save(path)
        raw = bytearray(open(path, "rb").read())
        raw[8:16] = np.asarray([999], dtype=np.uint64).tobytes()
        open(path, "wb").write(bytes(raw))
        with pytest.raises(sharded_dict.DictBuildError):
            ShardedChunkDict.load(path, device="cpu")


class TestFusedAfterInsert:
    def test_process_many_sees_the_grown_dict(self):
        """The fused engine's pass-2 probe reads the dict's device snapshot:
        after an insert_u32 of a file's digests, that file's chunks hit."""
        rng = np.random.default_rng(110)
        files = [rng.integers(0, 256, s, dtype=np.uint8).tobytes() for s in (30_000, 24_000, 9_000)]
        eng = fused_convert.FusedDeviceEngine(chunk_size=0x1000, device="cpu")
        first = eng.process_many(files)

        def keys(i):  # pass 2's probe keys: SHA-256 state words
            return np.frombuffer(b"".join(first.digests[i]), dtype=">u4").astype(np.uint32).reshape(-1, 8)

        pd, jd = _port(keys(0)), _ref(keys(0))
        before = eng.process_many(files, chunk_dict=pd)
        n0, n1 = len(first.digests[0]), len(first.digests[1])
        assert (before.probe[:n0] > 0).all() and (before.probe[n0:] == 0).all()
        idx = pd.insert_u32(keys(1))
        assert np.array_equal(idx, jd.insert_u32(keys(1)))
        after = eng.process_many(files, chunk_dict=pd)
        assert np.array_equal(after.probe[:n0], before.probe[:n0])
        assert np.array_equal(after.probe[n0 : n0 + n1], idx + 1)
        assert (after.probe[n0 + n1 :] == 0).all()
        jkeys, jvalues, jdepth, jepoch = jd.fused_probe_tables()
        want = jfc.FusedDeviceEngine(chunk_size=0x1000).process_many(
            files, chunk_dict=(jkeys, jvalues), depth=jdepth, probe_kernel="pallas-interpret",
            dict_epoch=jepoch,
        )
        assert np.array_equal(after.probe, want.probe)


def test_reference_native_engine_is_built():
    """The reference's own build arm is what the comparisons above hold the
    port's native tables against."""
    assert j_native.dict_build_available() and native_cdc.dict_build_available()
    assert native_cdc.dict_insert_available() and native_cdc.dict_upsert_available()
    assert native_cdc.dict_probe_available()
    assert torch.device("cpu") == _port(_digests(120, 10)).device
