"""The PyTorch port's fused full path against the JAX package's.

``FusedDeviceEngine(device="cpu")`` runs every kernel's plain version; the
reference engine runs its XLA formulation with the Pallas probe in
interpret mode. Same streams, same dict tables: cuts, digests and probe
answers must be identical, and the reference's bucket plan too.
"""

import hashlib

import numpy as np
import pytest
import torch

from nydus_snapshotter_tpu.ops import fused_convert as jfc
from nydus_snapshotter_tpu.parallel.sharded_dict import _build_host_tables as j_build
from nydus_snapshotter_tpu.parallel.sharded_dict import _table_max_depth as j_depth
from nydus_snapshotter_tpu_torch.ops import fused_convert, probe_cuda, sha256_cuda
from nydus_snapshotter_tpu_torch.parallel.sharded_dict import from_tables

# Small average chunk: many chunks per small stream, and short chunks keep
# the plain SHA-256 (one Python-level loop step per 64-byte block) quick.
CHUNK = 0x1000


def _corpus(seed: int, sizes: list[int]) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i, size in enumerate(sizes):
        if i % 3 == 0:
            data = rng.integers(0, 256, size, dtype=np.uint8)
        elif i % 3 == 1:
            base = rng.integers(0, 256, max(1, size // 7), dtype=np.uint8)
            data = np.tile(base, 8)[:size]
        else:
            data = rng.integers(32, 127, size, dtype=np.uint8)
        out.append(data.tobytes())
    return out


@pytest.fixture(scope="module")
def dict_tables():
    """A single-shard dict over the digests of one corpus, built by the
    reference package (keys are SHA state words, as pass 2 queries)."""
    streams = _corpus(13, [40_000, 20_000])
    res = fused_convert.FusedDeviceEngine(chunk_size=CHUNK, device="cpu").process_many(streams)
    flat = [d for digs in res.digests for d in digs]
    digests_u32 = np.frombuffer(b"".join(flat), dtype=">u4").astype(np.uint32).reshape(-1, 8)
    keys, values = j_build(digests_u32, 1)
    return streams, flat, keys[0], values[0], j_depth(keys, values)


class TestFusedAgainstReference:
    def test_cuts_digests_probe_match(self, dict_tables):
        src, flat, keys, values, depth = dict_tables
        # one stream reused verbatim (all hits), fresh ones (misses), empties
        streams = [src[0], b""] + _corpus(17, [3, 30_001, 64, 25_000])
        port = fused_convert.FusedDeviceEngine(chunk_size=CHUNK, device="cpu")
        ref = jfc.FusedDeviceEngine(chunk_size=CHUNK)
        got = port.process_many(streams, chunk_dict=from_tables(keys, values, depth, device="cpu"))
        want = ref.process_many(
            streams, chunk_dict=(keys, values), depth=depth, probe_kernel="pallas-interpret"
        )
        assert len(got.cuts) == len(want.cuts) == len(streams)
        for i in range(len(streams)):
            assert np.array_equal(got.cuts[i], want.cuts[i]), i
            assert got.digests[i] == want.digests[i], i
        assert np.array_equal(got.probe, want.probe)
        n0 = len(got.digests[0])
        assert (got.probe[:n0] > 0).all()
        for d, h in zip(got.digests[0], got.probe[:n0]):
            assert flat[int(h) - 1] == d
        # digests are real SHA-256
        for s, cuts, digs in zip(streams, got.cuts, got.digests):
            prev = 0
            for cut, d in zip(cuts, digs):
                assert hashlib.sha256(s[prev:int(cut)]).digest() == d
                prev = int(cut)
        assert port.stats["batches"] == 1 and port.stats["bytes"] == sum(map(len, streams))

    def test_one_sha_launch_per_pass2(self, dict_tables, monkeypatch):
        """Pass 2 digests every chunk in ONE sha256_chunks call over the
        stream-order extents; its rows equal per-bucket calls of the
        reference's plan, and the engine's results the reference's."""
        src, _flat, keys, values, depth = dict_tables
        streams = [src[1]] + _corpus(29, [70_000, 5, 12_345, 0, 41_000])
        calls = []
        real = sha256_cuda.sha256_chunks

        def counted(*args):
            calls.append(args[1].shape[0])
            return real(*args)

        monkeypatch.setattr(sha256_cuda, "sha256_chunks", counted)
        port = fused_convert.FusedDeviceEngine(chunk_size=CHUNK, device="cpu")
        cdict = from_tables(keys, values, depth, device="cpu")
        got = port.process_many(streams, chunk_dict=cdict)
        n_chunks = sum(len(c) for c in got.cuts)
        assert calls == [n_chunks]

        arrs = [np.frombuffer(s, np.uint8) for s in streams]
        buf, table = port.layout(arrs)
        buckets, order = port.plan_buckets(table, got.cuts)
        assert len(buckets) > 2 and len(order) == n_chunks
        buffer = torch.from_numpy(buf)
        extents = port.chunk_extents(table, got.cuts)
        assert extents.dtype == np.int32 and extents.shape == (2, n_chunks)
        calls.clear()
        states, probe = port.digest_probe(buffer, extents, cdict)
        assert calls == [n_chunks] and states.shape == (n_chunks, 8)
        tk, tv, _cap, _depth = cdict.device_snapshot()
        per_bucket = {}
        for b in buckets:
            want = real(buffer, torch.from_numpy(b.offsets), torch.from_numpy(b.sizes))
            wstart, off = probe_cuda.window_starts(want, cdict.capacity)
            per_bucket[b.cap_blocks] = (
                b, want, probe_cuda.probe_padded(tk, tv, want, wstart, off, depth)
            )
        for i, (cap, row) in enumerate(order):
            b, want, want_probe = per_bucket[cap]
            assert (extents[0, i], extents[1, i]) == (b.offsets[row], b.sizes[row])
            assert torch.equal(states[i], want[row]) and probe[i] == want_probe[row]

        ref = jfc.FusedDeviceEngine(chunk_size=CHUNK).process_many(
            streams, chunk_dict=(keys, values), depth=depth, probe_kernel="pallas-interpret"
        )
        for i in range(len(streams)):
            assert np.array_equal(got.cuts[i], ref.cuts[i]) and got.digests[i] == ref.digests[i]
        assert np.array_equal(got.probe, ref.probe) and (got.probe > 0).any()

    def test_plan_matches_reference(self):
        streams = _corpus(19, [50_000, 9_000, 0, 33_000])
        port = fused_convert.FusedDeviceEngine(chunk_size=CHUNK, device="cpu")
        ref = jfc.FusedDeviceEngine(chunk_size=CHUNK)
        arrs = [np.frombuffer(s, np.uint8) for s in streams]
        pbuf, ptable = port.layout(arrs)
        jbuf, jtable = ref.layout(arrs)
        assert np.array_equal(pbuf, jbuf) and ptable == jtable
        cuts = ref.process_many(streams).cuts
        pb, porder = port.plan_buckets(ptable, cuts)
        jb, jorder = ref.plan_buckets(jtable, cuts)
        assert porder == jorder
        assert [(b.cap_blocks, b.count) for b in pb] == [(b.cap_blocks, b.count) for b in jb]
        for x, y in zip(pb, jb):
            assert np.array_equal(x.offsets, y.offsets) and np.array_equal(x.sizes, y.sizes)


class TestFusedEdges:
    def test_empty_and_tiny_batch(self):
        eng = fused_convert.FusedDeviceEngine(chunk_size=CHUNK, device="cpu")
        assert eng.process_many([]).cuts == []
        res = eng.process_many([b"", b"x"])
        assert list(res.cuts[0]) == []
        assert list(res.cuts[1]) == [1]
        assert res.digests[1] == [hashlib.sha256(b"x").digest()]
        empty = eng.process_many(
            [b""], chunk_dict=from_tables(np.zeros((64, 8), np.uint32), np.zeros(64, np.int32), 1, device="cpu")
        )
        assert empty.probe is not None and empty.probe.size == 0

    def test_overflow_raises(self, monkeypatch):
        # Truncated candidates would yield WRONG cuts: the engine must
        # refuse loudly when the static capacity is exceeded.
        monkeypatch.setattr(fused_convert, "_wcap_for", lambda n, bits, floor=1024: 2)
        eng = fused_convert.FusedDeviceEngine(chunk_size=CHUNK, device="cpu")
        data = _corpus(23, [1 << 16])[0]
        with pytest.raises(fused_convert.FusedOverflow):
            eng.process_many([data])

    def test_batch_beyond_int32_addressing_is_refused(self):
        eng = fused_convert.FusedDeviceEngine(chunk_size=CHUNK, device="cpu")

        class _Sized:  # layout() only reads .size before it refuses
            size = 1 << 31

        with pytest.raises(fused_convert.FusedOverflow):
            eng.layout([_Sized()])

    def test_split_batches_stay_below_int32_addressing(self, monkeypatch):
        monkeypatch.setattr(fused_convert, "MAX_BATCH_PAD", 3 * fused_convert.WINDOW)
        eng = fused_convert.FusedDeviceEngine(chunk_size=CHUNK, device="cpu")
        sizes = [0, 3 << 20, 1 << 20, 5 << 20, 100, 0, 6 << 20, 7]
        batches = eng.split_batches(sizes)
        assert [i for b in batches for i in b] == list(range(len(sizes)))
        assert len(batches) > 1
        for b in batches:
            assert eng.padded_size(sum(sizes[i] for i in b)) < fused_convert.MAX_BATCH_PAD
        assert eng.split_batches([]) == []
        with pytest.raises(fused_convert.FusedOverflow):
            eng.split_batches([1, 3 * fused_convert.WINDOW])

    def test_dict_on_another_device_is_refused(self):
        eng = fused_convert.FusedDeviceEngine(chunk_size=CHUNK, device="cpu")
        d = from_tables(np.zeros((64, 8), np.uint32), np.zeros(64, np.int32), 1, device="cpu")
        d.device = torch.device("meta")
        with pytest.raises(ValueError):
            eng.process_many([b"x" * 100], chunk_dict=d)
