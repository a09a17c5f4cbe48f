"""The PyTorch port's ChunkDigestEngine against the JAX package's.

``ChunkDigestEngine(device="cpu")`` runs the kernels' plain versions (K1's
``gear_bitmaps_plain``, K2's ``sha256_chunks_plain``) through the same
windowing, staging and batching code that drives the kernels on the card;
the reference engine runs its XLA formulation on the CPU. Inputs come from
seeded numpy; cuts and digests are integers and bytes, so equality is
exact. Small average chunks (0x1000) keep the plain SHA-256, one Python
step per 64-byte block, quick.
"""

import hashlib

import numpy as np
import pytest
import torch

from nydus_snapshotter_tpu.ops.chunker import ChunkDigestEngine as JEngine
from nydus_snapshotter_tpu_torch.ops import chunker, fused_convert, gear_cuda, sha256_cuda
from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine

CHUNK = 0x1000
RNG_SEED = 20261017


def _streams(seed: int, sizes: list[int]) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i, size in enumerate(sizes):
        if i % 3 == 2:  # low entropy: long runs without candidates
            data = rng.integers(0, 4, size, dtype=np.uint8)
        else:
            data = rng.integers(0, 256, size, dtype=np.uint8)
        out.append(data.tobytes())
    return out


def _metas(metas):
    return [(m.offset, m.size, m.digest) for m in metas]


@pytest.fixture
def counted(monkeypatch):
    """Calls of K1's and K2's plain versions (the CPU path of each
    wrapper, where the card would launch the kernel)."""
    calls = {"gear": 0, "sha": 0}
    real_gear, real_sha = gear_cuda.gear_bitmaps_plain, sha256_cuda.sha256_chunks_plain

    def gear(*args):
        calls["gear"] += 1
        return real_gear(*args)

    def sha(*args):
        calls["sha"] += 1
        return real_sha(*args)

    monkeypatch.setattr(gear_cuda, "gear_bitmaps_plain", gear)
    monkeypatch.setattr(sha256_cuda, "sha256_chunks_plain", sha)
    return calls


class TestBoundaries:
    def test_windowed_equals_whole_stream(self):
        data = _streams(RNG_SEED, [3_000_000])[0]
        port = ChunkDigestEngine(chunk_size=CHUNK, window=1 << 20, device="cpu")
        whole = JEngine(chunk_size=CHUNK, backend="numpy")
        assert np.array_equal(port.boundaries(data), whole.boundaries(data))

    def test_boundaries_many_matches_reference(self):
        streams = _streams(RNG_SEED + 1, [0, 700_000, 17, 40_000, 0, 600_000, 5_000])
        port = ChunkDigestEngine(chunk_size=CHUNK, device="cpu")
        ref = JEngine(chunk_size=CHUNK)
        arrs = [np.frombuffer(s, np.uint8) for s in streams]
        got, want = port.boundaries_many(arrs), ref.boundaries_many(arrs)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)

    def test_staging_is_a_ring_per_window_size(self, monkeypatch):
        """Staging slots are allocated once per window geometry (at most
        DEPTH each), not once per stream."""
        made = []
        real = chunker._Slot.__init__

        def init(self, rows, w, pin):
            made.append(w)
            real(self, rows, w, pin)

        monkeypatch.setattr(chunker._Slot, "__init__", init)
        streams = _streams(RNG_SEED + 2, [3_000] * 7 + [600_000] * 3)
        ChunkDigestEngine(chunk_size=CHUNK, device="cpu").boundaries_many(
            [np.frombuffer(s, np.uint8) for s in streams]
        )
        assert sorted(made) == [1 << 19] * chunker.DEPTH + [1 << 20] * chunker.DEPTH


class TestProcess:
    def test_process_matches_reference(self):
        data = _streams(RNG_SEED + 3, [400_000])[0]
        got = ChunkDigestEngine(chunk_size=CHUNK, device="cpu").process(data)
        assert _metas(got) == _metas(JEngine(chunk_size=CHUNK).process(data))
        assert sum(m.size for m in got) == len(data)

    @pytest.mark.parametrize("backend", ["jax", "numpy", "fused"])
    def test_process_many_matches_reference(self, backend):
        streams = _streams(RNG_SEED + 4, [90_000, 0, 3, 30_001, 64, 25_000])
        got = ChunkDigestEngine(chunk_size=CHUNK, backend=backend, device="cpu").process_many(streams)
        want = JEngine(chunk_size=CHUNK, backend="numpy").process_many(streams)
        assert [_metas(m) for m in got] == [_metas(m) for m in want]

    def test_fused_falls_back_on_overflow(self, monkeypatch, counted):
        """A forced FusedOverflow takes the windowed device path, as the
        reference's ``process_many`` does: same cuts and digests, one K1
        call per non-empty stream after the fused pass's own."""
        monkeypatch.setattr(fused_convert, "_wcap_for", lambda n, bits, floor=1024: 2)
        streams = _streams(RNG_SEED + 5, [80_000, 0, 50_000, 9])
        got = ChunkDigestEngine(chunk_size=CHUNK, backend="fused", device="cpu").process_many(streams)
        want = JEngine(chunk_size=CHUNK, backend="numpy").process_many(streams)
        assert [_metas(m) for m in got] == [_metas(m) for m in want]
        assert counted == {"gear": 1 + 3, "sha": 1}

    def test_launch_counts(self, counted):
        """process_many: one K1 call per non-empty stream, one K2 call for
        every chunk (one int32-addressable piece)."""
        streams = _streams(RNG_SEED + 6, [50_000, 0, 700_000, 12, 0])
        ChunkDigestEngine(chunk_size=CHUNK, device="cpu").process_many(streams)
        assert counted == {"gear": 3, "sha": 1}

    def test_pieces_split_at_int32_addressing(self, monkeypatch, counted):
        """Chunks beyond one piece's addressing go in several K2 calls;
        the digests do not change."""
        streams = _streams(RNG_SEED + 7, [30_000, 20_000])
        eng = ChunkDigestEngine(chunk_size=CHUNK, device="cpu")
        whole = eng.process_many(streams)
        counted["sha"] = 0
        monkeypatch.setattr(chunker, "MAX_PIECE_BYTES", 16_384)
        split = eng.process_many(streams)
        assert [_metas(m) for m in split] == [_metas(m) for m in whole]
        assert counted["sha"] >= 50_000 // 16_384


class TestDigests:
    @pytest.mark.parametrize("digest_backend", ["jax", "host", "numpy"])
    def test_digest_all_and_many_match_reference(self, digest_backend):
        # at most max_size (16 KiB) a chunk: the reference's device digests
        # take no longer chunk
        streams = _streams(RNG_SEED + 8, [16_000, 1, 0, 9_999])
        arrs = [np.frombuffer(s, np.uint8) for s in streams]
        port = ChunkDigestEngine(chunk_size=CHUNK, digest_backend=digest_backend, device="cpu")
        ref = JEngine(chunk_size=CHUNK)
        extents = [([(0, 5), (5, 70)] if a.size > 75 else []) + [(0, a.size)] for a in arrs]
        assert port.digest_all(arrs, extents) == ref.digest_all(arrs, extents)
        assert port.digest_many(streams) == ref.digest_many(streams)
        cuts = ref.boundaries(arrs[0])
        assert port.digests(arrs[0], cuts) == ref.digests(arrs[0], cuts)

    def test_digester_submit_does_not_sync(self, monkeypatch):
        """Between submit and collect nothing reads a tensor back to the
        host: the extents are checked on the host before the upload."""
        monkeypatch.setattr(
            sha256_cuda, "sha256_chunks_plain",
            lambda buf, offs, sizes: torch.zeros((offs.shape[0], 8), dtype=torch.int32),
        )
        reads = []
        for name in ("tolist", "item"):
            real = getattr(torch.Tensor, name)
            monkeypatch.setattr(
                torch.Tensor, name, lambda self, *a, _r=real, _n=name: reads.append(_n) or _r(self, *a)
            )
        arr = np.frombuffer(_streams(RNG_SEED + 9, [10_000])[0], np.uint8)
        dig = chunker.DeviceDigester(device="cpu")
        handle = dig.submit([(arr, 0, 100), (arr, 100, 5_000), (arr, 7_000, 3)])
        assert reads == []
        assert len(dig.collect(handle)) == 3

    def test_digester_joins_chunks_in_order(self):
        arr = np.frombuffer(_streams(RNG_SEED + 10, [9_000])[0], np.uint8)
        other = np.frombuffer(b"abc", np.uint8)
        items = [(arr, 0, 1000), (arr, 1000, 17), (other, 0, 3), (arr, 5000, 0), (arr, 1017, 4000)]
        dig = chunker.DeviceDigester(device="cpu")
        got = dig.collect(dig.submit(items))
        assert got == [hashlib.sha256(a[o : o + s]).digest() for a, o, s in items]


class TestHybridEngine:
    """``backend="hybrid"``: the native chunk engine's host lane, against
    the reference's hybrid engine and the port's numpy engine."""

    @pytest.mark.parametrize("digester", ["sha256", "blake3"])
    @pytest.mark.parametrize("mode", ["cdc", "fixed"])
    def test_matches_reference_and_numpy(self, mode, digester):
        streams = _streams(RNG_SEED + 11, [0, 1, 5_000, 100_000, 300_001, 70_000])
        kw = dict(chunk_size=CHUNK, mode=mode, digester=digester)
        eng = ChunkDigestEngine(backend="hybrid", **kw)
        got = [_metas(m) for m in eng.process_many(streams)]
        want = JEngine(backend="hybrid", **kw).process_many(streams)
        oracle = ChunkDigestEngine(backend="numpy", **kw).process_many(streams)
        assert got == [_metas(m) for m in want] == [_metas(m) for m in oracle]
        assert [_metas(eng.process(s)) for s in streams] == got

    def test_boundaries_and_digests_match_reference(self):
        streams = _streams(RNG_SEED + 12, [0, 700_000, 17, 40_000, 600_000])
        arrs = [np.frombuffer(s, np.uint8) for s in streams]
        eng = ChunkDigestEngine(chunk_size=CHUNK, backend="hybrid")
        ref = JEngine(chunk_size=CHUNK, backend="hybrid")
        for g, w in zip(eng.boundaries_many(arrs), ref.boundaries_many(arrs)):
            assert np.array_equal(g, w)
        pieces = [s[: (i * 997) % 3000] for i, s in enumerate(streams * 3)]
        assert eng.digest_many(pieces) == ref.digest_many(pieces)
        assert eng.digest_many(pieces) == [hashlib.sha256(p).digest() for p in pieces]

    def test_fused_arm_takes_host_digests(self, monkeypatch):
        """With host digests process_many makes one native chunk+digest
        call per stream; with numpy digests it cuts and digests apart."""
        calls = []
        real = chunker.native_cdc.chunk_digest_native
        monkeypatch.setattr(chunker.native_cdc, "chunk_digest_native",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        streams = _streams(RNG_SEED + 13, [50_000, 0, 9])
        fused = ChunkDigestEngine(chunk_size=CHUNK, backend="hybrid").process_many(streams)
        assert len(calls) == len(streams)
        apart = ChunkDigestEngine(chunk_size=CHUNK, backend="hybrid",
                                  digest_backend="numpy").process_many(streams)
        assert len(calls) == len(streams)
        assert [_metas(m) for m in fused] == [_metas(m) for m in apart]

    def test_device_digests_on_request(self, counted):
        """digest_backend="jax": native cuts, digests by K2's wrapper on the
        engine's device (its plain version on the CPU); no K1."""
        streams = _streams(RNG_SEED + 14, [40_000, 3])
        eng = ChunkDigestEngine(chunk_size=CHUNK, backend="hybrid", digest_backend="jax", device="cpu")
        assert eng.device == torch.device("cpu")
        got = eng.process_many(streams)
        want = JEngine(chunk_size=CHUNK, backend="numpy").process_many(streams)
        assert [_metas(m) for m in got] == [_metas(m) for m in want]
        assert counted == {"gear": 0, "sha": 1}

    @pytest.mark.parametrize("n", [1, 7, 8, 40])
    def test_host_digest_routes(self, monkeypatch, n):
        """Host SHA-256: the native batch call from 8 items, hashlib below;
        host BLAKE3 always native. Digests as hashlib and the pure-Python
        BLAKE3 give them."""
        from nydus_snapshotter_tpu_torch.utils import blake3 as pyb3

        calls = {"sha": 0, "b3": 0}
        for key, name in (("sha", "sha256_many_native"), ("b3", "blake3_many_native")):
            real = getattr(chunker.native_cdc, name)
            monkeypatch.setattr(chunker.native_cdc, name,
                                lambda *a, _r=real, _k=key: calls.__setitem__(_k, calls[_k] + 1) or _r(*a))
        arr = np.frombuffer(_streams(RNG_SEED + 15, [n * 300 + 5])[0], np.uint8)
        items = [(arr, 300 * i + i % 5, 290 + i % 7) for i in range(n)]
        raw = [arr[o : o + s].tobytes() for _a, o, s in items]
        assert chunker._host_digests(items) == [hashlib.sha256(r).digest() for r in raw]
        assert (calls["sha"] > 0) == (n >= 8)
        assert chunker._host_digests_blake3(items) == [pyb3.blake3(r) for r in raw]
        assert calls["b3"] > 0


class TestModesAndArguments:
    def test_fixed_mode(self):
        data = b"z" * 20_000
        metas = ChunkDigestEngine(chunk_size=CHUNK, mode="fixed", device="cpu").process(data)
        assert _metas(metas) == _metas(JEngine(chunk_size=CHUNK, mode="fixed").process(data))
        assert [m.size for m in metas] == [CHUNK] * 4 + [20_000 - 4 * CHUNK]

    def test_empty_and_tiny(self):
        eng = ChunkDigestEngine(chunk_size=CHUNK, device="cpu")
        assert eng.process(b"") == [] and eng.process_many([]) == []
        t = eng.process(b"hi")
        assert len(t) == 1 and t[0].digest == hashlib.sha256(b"hi").digest()
        assert [len(m) for m in eng.process_many([b"", b"x"])] == [0, 1]

    @pytest.mark.parametrize(
        "kw,match",
        [
            pytest.param({"mode": "nope"}, "mode", id="kw0-mode"),
            pytest.param({"backend": "cuda"}, "backend", id="kw1-backend"),
            pytest.param({"window": 100}, "window", id="kw2-window"),
            pytest.param({"digest_backend": "gpu"}, "digest backend", id="kw3-digest backend"),
            pytest.param({"digester": "md5"}, "digester", id="kw5-digester"),
        ],
    )
    def test_invalid_args(self, kw, match):
        with pytest.raises(ValueError, match=match):
            ChunkDigestEngine(device="cpu", **kw)

    @pytest.mark.parametrize("kw", [pytest.param({"backend": "hybrid"}, id="kw4")])
    def test_formerly_refused_args(self, kw):
        """``backend="hybrid"`` (refused until the native chunk engine's
        arms were ported; same id) runs: host digests by default, no
        device, the reference's chunks."""
        eng = ChunkDigestEngine(chunk_size=CHUNK, device="cpu", **kw)
        assert eng.digest_backend == "host" and eng.device is None
        streams = _streams(RNG_SEED, [0, 1, 70_000])
        want = JEngine(chunk_size=CHUNK, **kw).process_many(streams)
        assert [_metas(m) for m in eng.process_many(streams)] == [_metas(m) for m in want]

    def test_numpy_engine_needs_no_device(self):
        eng = ChunkDigestEngine(chunk_size=CHUNK, backend="numpy")
        assert eng.device is None
        assert len(eng.process(b"q" * 10_000)) >= 1
