"""BLAKE3 in the PyTorch port against the JAX package.

The port's plain versions (``ops/blake3.blake3_batch``, and
``blake3_chunks_plain``, the CPU path of kernel K4's wrapper) take the same
numpy-seeded inputs as the reference's ``ops/blake3_jax`` on the CPU and its
gather front end, and both are held against the pure-Python spec copies.
Then every entry point that takes ``digester="blake3"``:
``ChunkDigestEngine``, ``FusedDeviceEngine`` (cuts, digests, dict probe) and
``pack_layer`` (blob, bootstrap, blob id) against the reference's. Digests,
cuts, answers and blobs are integers and bytes: equality is exact.
"""

import io
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nydus_snapshotter_tpu.converter.convert import pack_layer as j_pack_layer
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.models.bootstrap import Bootstrap as JBootstrap
from nydus_snapshotter_tpu.models.bootstrap import ChunkDict as JChunkDict
from nydus_snapshotter_tpu.ops import blake3_jax as jb3
from nydus_snapshotter_tpu.ops import fused_convert as jfc
from nydus_snapshotter_tpu.ops.chunker import ChunkDigestEngine as JEngine
from nydus_snapshotter_tpu.parallel.sharded_dict import _build_host_tables as j_build
from nydus_snapshotter_tpu.parallel.sharded_dict import _table_max_depth as j_depth
from nydus_snapshotter_tpu.utils import blake3 as j_pyb3
from nydus_snapshotter_tpu_torch.converter import Pack, PackOption, pack_layer
from nydus_snapshotter_tpu_torch.models import layout
from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap, ChunkDict
from nydus_snapshotter_tpu_torch.ops import (
    blake3,
    blake3_cuda,
    chunker,
    fused_convert,
    gear_cuda,
    sha256_cuda,
)
from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine
from nydus_snapshotter_tpu_torch.parallel.sharded_dict import from_tables
from nydus_snapshotter_tpu_torch.tensors import from_u32, to_u32
from nydus_snapshotter_tpu_torch.utils import blake3 as pyb3

CPU = torch.device("cpu")
CHUNK = 0x1000
# test_blake3_jax.py's sizes: every block, leaf and tree-split edge
SIZES = [0, 1, 63, 64, 65, 1023, 1024, 1025, 2048, 3071, 3072, 4096,
         5 * 1024 + 7, 65536, (1 << 17) + 13]


def _msgs(seed: int, sizes: list[int]) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8).tobytes() for s in sizes]


def _streams(seed: int, sizes: list[int]) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i, size in enumerate(sizes):
        if i % 3 == 2:  # low entropy: long runs without candidates
            out.append(rng.integers(0, 4, size, dtype=np.uint8).tobytes())
        else:
            out.append(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    return out


def _batch(blocks: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    return to_u32(blake3.blake3_batch(from_u32(blocks, CPU), torch.from_numpy(lengths)))


def _extents(seed: int, sizes: list[int], phase: int):
    """A random buffer and chunk extents whose offsets are ``phase`` mod 4
    (and mixed mod 16), with gaps between chunks."""
    rng = np.random.default_rng(seed)
    offs, pos = [], 0
    for i, s in enumerate(sizes):
        pos += (-pos) % 4 + phase + 4 * (i % 4)
        offs.append(pos)
        pos += s
    buf = rng.integers(0, 256, pos + 64, dtype=np.uint8)
    return buf, np.asarray(offs, np.int32), np.asarray(sizes, np.int32)


def _plain(buf, offs, sizes) -> np.ndarray:
    return to_u32(blake3_cuda.blake3_chunks(
        torch.from_numpy(buf), torch.from_numpy(offs), torch.from_numpy(sizes)))


class TestBlake3Batch:
    def test_matches_reference_and_oracle(self):
        msgs = _msgs(3, SIZES)
        blocks, lengths = blake3.pack_messages_np(msgs)
        jblocks, jlengths = jb3.pack_messages_np(msgs)
        assert np.array_equal(blocks, jblocks) and np.array_equal(lengths, jlengths)
        got = _batch(blocks, lengths)
        want = np.asarray(jb3.blake3_batch(jnp.asarray(jblocks), jnp.asarray(jlengths)))
        assert np.array_equal(got, want)
        for i, m in enumerate(msgs):
            assert blake3.digest_to_bytes(got[i]) == pyb3.blake3(m), SIZES[i]

    def test_known_vector_empty(self):
        blocks, lengths = blake3.pack_messages_np([b""])
        got = blake3.digest_to_bytes(_batch(blocks, lengths)[0])
        assert got.hex().startswith("af1349b9f5f9a1a6") and got == pyb3.blake3(b"")

    def test_capacity_rounding_and_pad_rows(self):
        """A capacity that is not a power of two rounds up, as in the
        reference; zero pad rows digest the empty message."""
        msgs = _msgs(9, [10, 5000, 70000])
        blocks, lengths = blake3.pack_messages_np(msgs, leaf_capacity=96)
        jblocks, jlengths = jb3.pack_messages_np(msgs, leaf_capacity=96)
        assert blocks.shape[1] == 128 and np.array_equal(blocks, jblocks)
        assert np.array_equal(lengths, jlengths)
        blocks = np.concatenate([blocks, np.zeros((2,) + blocks.shape[1:], np.uint32)])
        lengths = np.concatenate([lengths, np.zeros(2, np.int32)])
        got = _batch(blocks, lengths)
        for i, m in enumerate(msgs):
            assert blake3.digest_to_bytes(got[i]) == pyb3.blake3(m)
        assert blake3.digest_to_bytes(got[3]) == pyb3.blake3(b"")

    def test_capacity_overflow_rejected(self):
        for pack in (blake3.pack_messages_np, jb3.pack_messages_np):
            with pytest.raises(ValueError):
                pack([b"x" * 5000], leaf_capacity=4)

    def test_non_pow2_capacity_refused(self):
        with pytest.raises(ValueError):
            blake3.blake3_batch(torch.zeros((1, 3, 16, 16), dtype=torch.int32),
                                torch.zeros(1, dtype=torch.int32))

    def test_pure_python_copy_matches_reference(self):
        for m in _msgs(11, SIZES + [200_000]):
            assert pyb3.blake3(m) == j_pyb3.blake3(m)


class TestChunksPlain:
    @pytest.mark.parametrize("phase", [0, 1, 2, 3])
    def test_offsets_mod4_match_reference_and_oracle(self, phase):
        buf, offs, sizes = _extents(20 + phase, SIZES, phase)
        got = _plain(buf, offs, sizes)
        cap = 256  # pow2 leaves of the largest size, (1 << 17) + 13 bytes
        jbuf = jnp.asarray(np.concatenate([buf, np.zeros(cap * 1024, np.uint8)]))
        jsizes = jnp.asarray(sizes)
        jblocks = jfc._gather_pack_b3(jbuf, jnp.asarray(offs), jsizes, cap)
        want = np.asarray(jb3._blake3_batch_jit(jblocks, jsizes, False))
        assert np.array_equal(got, want)
        for i, (o, s) in enumerate(zip(offs, sizes)):
            assert blake3.digest_to_bytes(got[i]) == pyb3.blake3(buf[o : o + s].tobytes())

    def test_gather_pack_matches_reference(self):
        buf, offs, sizes = _extents(5, [0, 1, 1023, 1024, 1025, 3000, 4096], 3)
        got = blake3.gather_pack_b3(
            torch.from_numpy(buf), torch.from_numpy(offs), torch.from_numpy(sizes), 4
        )
        jbuf = jnp.asarray(np.concatenate([buf, np.zeros(4096, np.uint8)]))
        want = np.asarray(jfc._gather_pack_b3(jbuf, jnp.asarray(offs), jnp.asarray(sizes), 4))
        assert np.array_equal(to_u32(got), want)

    def test_plain_slices_take_their_own_cap(self, monkeypatch):
        """A long chunk among short ones: each slice is padded to its own
        first (longest) row's leaves, and rows come back in order."""
        sizes = [100, 70_000, 0, 1024, 1025, 3000, 5, 2048, 9000, 1]
        buf, offs, sizes = _extents(7, sizes, 1)
        slices = []
        real = blake3.gather_pack_b3

        def recorded(b, o, s, cap):
            slices.append((o.shape[0], cap))
            return real(b, o, s, cap)

        monkeypatch.setattr(blake3, "gather_pack_b3", recorded)
        monkeypatch.setattr(blake3, "_PLAIN_SLICE_BYTES", 3 * 16 * 1024)
        monkeypatch.setattr(blake3, "_GATHER_ELEMS", 3000)
        got = _plain(buf, offs, sizes)
        for i, (o, s) in enumerate(zip(offs, sizes)):
            assert blake3.digest_to_bytes(got[i]) == pyb3.blake3(buf[o : o + s].tobytes())
        assert slices[0] == (1, 128)  # the 69-leaf chunk alone
        assert sum(r for r, _ in slices) == len(sizes)
        assert all(r * cap * 1024 <= 3 * 16 * 1024 for r, cap in slices[1:])
        assert [cap for _, cap in slices] == sorted((cap for _, cap in slices), reverse=True)

    def test_empty_batch(self):
        out = blake3_cuda.blake3_chunks(
            torch.zeros(16, dtype=torch.uint8),
            torch.zeros(0, dtype=torch.int32),
            torch.zeros(0, dtype=torch.int32),
        )
        assert out.shape == (0, 8)

    def test_leaf_counts(self):
        got = blake3_cuda.leaf_counts(np.asarray([0, 1, 1024, 1025, 4 << 20], np.int32))
        assert got.tolist() == [blake3.n_leaves(s) for s in (0, 1, 1024, 1025, 4 << 20)]
        assert got.tolist() == [1, 1, 1, 2, 4096]


class _OnCard(torch.Tensor):
    """A host tensor that reports a CUDA device: reaches the wrapper's
    checks for card buffers without launching anything."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class TestWrapperArguments:
    def test_cpu_buffer_takes_plain_version(self, monkeypatch):
        calls = []
        real = blake3.blake3_chunks_plain
        monkeypatch.setattr(blake3, "blake3_chunks_plain",
                            lambda *a: calls.append(a[1].shape[0]) or real(*a))
        before = (blake3_cuda.LEAVES.launches, blake3_cuda.PARENTS.launches)
        buf, offs, sizes = _extents(2, [0, 5000, 17], 2)
        got = _plain(buf, offs, sizes)
        assert calls == [3]
        assert (blake3_cuda.LEAVES.launches, blake3_cuda.PARENTS.launches) == before
        assert blake3.digest_to_bytes(got[1]) == pyb3.blake3(buf[offs[1] : offs[1] + 5000].tobytes())

    @pytest.mark.parametrize("start,length", [(1, 64), (0, 72), (4, 64)])
    def test_misaligned_card_buffer_raises(self, start, length):
        base = torch.zeros(256, dtype=torch.uint8)
        shift = (-base.data_ptr()) % 16
        buf = torch.Tensor._make_subclass(_OnCard, base[shift + start : shift + start + length])
        assert buf.device.type == "cuda"
        ext = torch.zeros(1, dtype=torch.int32)
        with pytest.raises(ValueError, match="16-byte aligned"):
            blake3_cuda.blake3_chunks(buf, ext, ext)

    @pytest.mark.parametrize(
        "off,size", [(90, 11), (-1, 4), (0, -1), (100, 1)], ids=["past_end", "neg_off", "neg_size", "at_end"]
    )
    def test_extents_outside_buffer_raise(self, off, size):
        buf = torch.zeros(100, dtype=torch.uint8)
        with pytest.raises(ValueError, match="leave the buffer"):
            blake3_cuda.blake3_chunks(
                buf, torch.tensor([off], dtype=torch.int32), torch.tensor([size], dtype=torch.int32)
            )

    def test_extents_must_be_host_int32(self):
        buf = torch.zeros(100, dtype=torch.uint8)
        one = torch.tensor([1], dtype=torch.int32)
        for offs, sizes in ((one.long(), one), (one, one.to("meta")), (one, torch.ones(2, dtype=torch.int32))):
            with pytest.raises(ValueError):
                blake3_cuda.blake3_chunks(buf, offs, sizes)
        with pytest.raises(ValueError, match="u8"):
            blake3_cuda.blake3_chunks(buf.to(torch.int8), one, one)


def _metas(metas):
    return [(m.offset, m.size, m.digest) for m in metas]


@pytest.fixture
def counted(monkeypatch):
    """Calls of K1's, K2's and K4's plain versions (each wrapper's CPU
    path, where the card would launch the kernel)."""
    calls = {"gear": 0, "sha": 0, "blake3": 0}
    for key, mod, name in (("gear", gear_cuda, "gear_bitmaps_plain"),
                           ("sha", sha256_cuda, "sha256_chunks_plain"),
                           ("blake3", blake3, "blake3_chunks_plain")):
        real = getattr(mod, name)

        def wrapped(*args, _real=real, _key=key):
            calls[_key] += 1
            return _real(*args)

        monkeypatch.setattr(mod, name, wrapped)
    return calls


class TestEngine:
    @pytest.mark.parametrize("backend", ["jax", "fused", "numpy"])
    def test_process_many_matches_reference(self, backend, counted):
        streams = _streams(41, [90_000, 0, 3, 30_001, 64, 25_000])
        got = ChunkDigestEngine(
            chunk_size=CHUNK, backend=backend, digester="blake3", device="cpu"
        ).process_many(streams)
        want = JEngine(chunk_size=CHUNK, backend="numpy", digester="blake3").process_many(streams)
        assert [_metas(m) for m in got] == [_metas(m) for m in want]
        # the card's digests: one K4 pass over every chunk; the host arm
        # digests the numpy backend's
        assert counted["sha"] == 0
        assert counted["blake3"] == (0 if backend == "numpy" else 1)
        if backend == "jax":
            assert counted["gear"] == 5

    def test_fused_and_jax_match_reference_device_lanes(self):
        """The reference's own device BLAKE3 lanes (the fused engine's
        pass 2 and the bucketed XLA lane) give the port's digests."""
        streams = _streams(43, [40_000, 7, 12_000])
        for backend in ("fused", "jax"):
            got = ChunkDigestEngine(
                chunk_size=CHUNK, backend=backend, digester="blake3", device="cpu"
            ).process_many(streams)
            want = JEngine(chunk_size=CHUNK, backend=backend, digester="blake3").process_many(streams)
            assert [_metas(m) for m in got] == [_metas(m) for m in want], backend

    @pytest.mark.parametrize("digest_backend", ["jax", "host", "numpy"])
    def test_digest_all_and_many_match_reference(self, digest_backend):
        streams = _streams(45, [16_000, 1, 0, 9_999])
        arrs = [np.frombuffer(s, np.uint8) for s in streams]
        port = ChunkDigestEngine(
            chunk_size=CHUNK, digest_backend=digest_backend, digester="blake3", device="cpu"
        )
        ref = JEngine(chunk_size=CHUNK, backend="numpy", digester="blake3")
        extents = [([(0, 5), (5, 70)] if a.size > 75 else []) + [(0, a.size)] for a in arrs]
        assert port.digest_all(arrs, extents) == ref.digest_all(arrs, extents)
        assert port.digest_many(streams) == ref.digest_many(streams)
        cuts = ref.boundaries(arrs[0])
        assert port.digests(arrs[0], cuts) == ref.digests(arrs[0], cuts)

    def test_device_digester_one_launch_per_piece(self, monkeypatch, counted):
        """``digest_all`` launches K4 once per int32-addressable piece."""
        streams = _streams(47, [30_000, 20_000])
        eng = ChunkDigestEngine(chunk_size=CHUNK, digester="blake3", device="cpu")
        whole = eng.process_many(streams)
        assert counted["blake3"] == 1
        monkeypatch.setattr(chunker, "MAX_PIECE_BYTES", 16_384)
        split = eng.process_many(streams)
        assert [_metas(m) for m in split] == [_metas(m) for m in whole]
        assert counted["blake3"] - 1 >= 50_000 // 16_384

    def test_fused_falls_back_on_overflow(self, monkeypatch, counted):
        monkeypatch.setattr(fused_convert, "_wcap_for", lambda n, bits, floor=1024: 2)
        streams = _streams(49, [80_000, 0, 50_000, 9])
        eng = ChunkDigestEngine(chunk_size=CHUNK, backend="fused", digester="blake3", device="cpu")
        got = eng.process_many(streams)
        want = JEngine(chunk_size=CHUNK, backend="numpy", digester="blake3").process_many(streams)
        assert [_metas(m) for m in got] == [_metas(m) for m in want]
        assert eng.stats["fused_fallbacks"] == 1
        assert counted == {"gear": 1 + 3, "sha": 0, "blake3": 1}

    def test_host_digester(self):
        arr = np.frombuffer(_streams(51, [9_000])[0], np.uint8)
        items = [(arr, 0, 1000), (arr, 1000, 0), (arr, 1000, 8000)]
        dig = chunker.HostDigester("blake3")
        assert dig.collect(dig.submit(items)) == [pyb3.blake3(arr[o : o + s].tobytes()) for _a, o, s in items]


@pytest.fixture(scope="module")
def b3_dict():
    """A single-shard dict over the BLAKE3 digests of one corpus, built by
    the reference package (keys are the digests' little-endian words, as
    the BLAKE3 pass 2 queries)."""
    streams = _streams(53, [40_000, 20_000])
    res = fused_convert.FusedDeviceEngine(
        chunk_size=CHUNK, digester="blake3", device="cpu"
    ).process_many(streams)
    flat = [d for digs in res.digests for d in digs]
    words = np.frombuffer(b"".join(flat), dtype="<u4").astype(np.uint32).reshape(-1, 8)
    keys, values = j_build(words, 1)
    return streams, flat, keys[0], values[0], j_depth(keys, values)


class TestFused:
    def test_cuts_digests_probe_match(self, b3_dict, counted):
        src, flat, keys, values, depth = b3_dict
        streams = [src[0], b""] + _streams(55, [3, 30_001, 64, 25_000])
        port = fused_convert.FusedDeviceEngine(chunk_size=CHUNK, digester="blake3", device="cpu")
        ref = jfc.FusedDeviceEngine(chunk_size=CHUNK, digester="blake3")
        got = port.process_many(streams, chunk_dict=from_tables(keys, values, depth, device="cpu"))
        want = ref.process_many(streams, chunk_dict=(keys, values), depth=depth, probe_kernel="xla")
        assert counted == {"gear": 1, "sha": 0, "blake3": 1}
        for i in range(len(streams)):
            assert np.array_equal(got.cuts[i], want.cuts[i]), i
            assert got.digests[i] == want.digests[i], i
        assert np.array_equal(got.probe, want.probe)
        n0 = len(got.digests[0])
        assert n0 and (got.probe[:n0] > 0).all() and not (got.probe[n0:] > 0).any()
        for d, h in zip(got.digests[0], got.probe[:n0]):
            assert flat[int(h) - 1] == d
        for s, cuts, digs in zip(streams, got.cuts, got.digests):
            prev = 0
            for cut, d in zip(cuts, digs):
                assert pyb3.blake3(s[prev : int(cut)]) == d
                prev = int(cut)

    def test_sha256_dict_misses_blake3_digests(self, b3_dict):
        """The same content probed with SHA-256 against the BLAKE3-keyed
        dict misses everywhere (the reference's
        test_sha256_pack_misses_blake3_dict, at the engine)."""
        src, _flat, keys, values, depth = b3_dict
        res = fused_convert.FusedDeviceEngine(chunk_size=CHUNK, device="cpu").process_many(
            [src[0]], chunk_dict=from_tables(keys, values, depth, device="cpu")
        )
        assert res.probe.size and not (res.probe > 0).any()

    def test_plan_matches_reference_blake3(self):
        streams = _streams(57, [50_000, 9_000, 0, 33_000])
        port = fused_convert.FusedDeviceEngine(chunk_size=CHUNK, digester="blake3", device="cpu")
        ref = jfc.FusedDeviceEngine(chunk_size=CHUNK, digester="blake3")
        arrs = [np.frombuffer(s, np.uint8) for s in streams]
        pbuf, ptable = port.layout(arrs)
        cuts = port.process_many(streams).cuts
        pb, porder = port.plan_buckets(ptable, cuts)
        jb, jorder = ref.plan_buckets(ptable, cuts)
        assert porder == jorder and len(pb) > 1
        assert [(b.cap_blocks, b.count) for b in pb] == [(b.cap_blocks, b.count) for b in jb]
        for x, y in zip(pb, jb):
            assert np.array_equal(x.offsets, y.offsets) and np.array_equal(x.sizes, y.sizes)

    @pytest.mark.parametrize("digester", ["sha256", "blake3"])
    @pytest.mark.parametrize("chunk_size", [0x1000, 0x100000])
    def test_capacity_units_match_reference(self, digester, chunk_size):
        port = fused_convert.FusedDeviceEngine(chunk_size=chunk_size, digester=digester, device="cpu")
        ref = jfc.FusedDeviceEngine(chunk_size=chunk_size, digester=digester)
        assert port.max_read_span() == ref.max_read_span()
        for size in (0, 1, 55, 56, 1024, 1025, chunk_size, port.params.max_size):
            assert port._blocks_of(size) == ref._blocks_of(size)

    def test_unknown_digester_refused(self):
        with pytest.raises(ValueError, match="digester"):
            fused_convert.FusedDeviceEngine(digester="md5", device="cpu")


def _small_tar(seed: int = 7, files: int = 12) -> bytes:
    """Files of 0 to 40 000 bytes (one repeated, so a chunk dedups), and
    a symlink: small enough for the host BLAKE3 arm's pure Python."""
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        dup = rng.integers(0, 256, 9_000, dtype=np.uint8).tobytes()
        for i in range(files):
            size = int(rng.choice([0, 100, 1500, 9000, 40_000]))
            data = dup if i % 5 == 4 else rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            ti = tarfile.TarInfo(f"d/f{i}")
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
        ti = tarfile.TarInfo("d/link")
        ti.type = tarfile.SYMTYPE
        ti.linkname = "f0"
        tf.addfile(ti)
    return buf.getvalue()


@pytest.fixture(scope="module")
def small_tar():
    return _small_tar()


B3_OPT = dict(chunk_size=CHUNK, compressor="none", digester="blake3")


class TestPack:
    @pytest.mark.parametrize("fs_version", [layout.RAFS_V6, layout.RAFS_V5])
    @pytest.mark.parametrize("backend", ["fused", "jax", "numpy"])
    def test_matches_reference(self, small_tar, backend, fs_version):
        opt = dict(B3_OPT, backend=backend, fs_version=fs_version)
        blob, res = pack_layer(small_tar, PackOption(**opt), device="cpu")
        jblob, jres = j_pack_layer(small_tar, JPackOption(**opt))
        assert blob == jblob
        assert res.bootstrap == jres.bootstrap
        assert res.blob_id == jres.blob_id and res.blob_size == jres.blob_size
        assert res.referenced_blob_ids == jres.referenced_blob_ids

    def test_blob_identical_to_sha256_pack(self, small_tar):
        """BLAKE3 changes only the bootstrap's chunk digests (the
        reference's test_pack_blake3_blob_identical_to_sha256): each is the
        BLAKE3 of its chunk's bytes in the blob."""
        blob, res = pack_layer(small_tar, PackOption(**B3_OPT), device="cpu")
        sblob, sres = pack_layer(
            small_tar, PackOption(chunk_size=CHUNK, compressor="none"), device="cpu"
        )
        assert blob[: res.blob_size] == sblob[: sres.blob_size] and res.blob_id == sres.blob_id
        assert res.bootstrap != sres.bootstrap
        chunks = Bootstrap.from_bytes(res.bootstrap).chunks
        assert chunks
        for c in chunks:
            data = blob[c.compressed_offset : c.compressed_offset + c.compressed_size]
            assert c.digest == pyb3.blake3(data)

    def test_streaming_pack_matches_reference(self, small_tar):
        """A file-like tar streams through IncrementalChunker, its BLAKE3
        digests on K4's wrapper, and packs the reference's bytes."""
        out = io.BytesIO()
        res = Pack(out, io.BytesIO(small_tar), PackOption(backend="jax", **B3_OPT), device="cpu")
        jblob, jres = j_pack_layer(small_tar, JPackOption(backend="numpy", **B3_OPT))
        assert out.getvalue() == jblob and res.bootstrap == jres.bootstrap

    def test_jax_lane_digests_with_k4(self, monkeypatch, small_tar, counted):
        """The jax lane digests BLAKE3 through K4's wrapper, one call for
        its one digest batch, and never on the host BLAKE3 arm."""

        def host_arm(items):
            raise AssertionError("the jax lane digested on the host BLAKE3 arm")

        monkeypatch.setattr(chunker, "_host_digests_blake3", host_arm)
        blob, res = pack_layer(small_tar, PackOption(backend="jax", **B3_OPT), device="cpu")
        jblob, jres = j_pack_layer(small_tar, JPackOption(backend="numpy", **B3_OPT))
        assert blob == jblob and res.bootstrap == jres.bootstrap
        assert counted["blake3"] == 1 and counted["sha"] == 0

    def test_candidate_overflow_falls_back(self, monkeypatch, small_tar):
        monkeypatch.setattr(fused_convert, "_wcap_for", lambda n, bits, floor=1024: 2)
        blob, res = pack_layer(small_tar, PackOption(backend="fused", **B3_OPT), device="cpu")
        jblob, jres = j_pack_layer(small_tar, JPackOption(backend="numpy", **B3_OPT))
        assert blob == jblob and res.bootstrap == jres.bootstrap and res.blob_id == jres.blob_id

    def test_chunk_dict_hits_match_reference(self, small_tar):
        """A BLAKE3 dict built from the same layer: every chunk is a hit,
        nothing is stored, in both packages."""
        _jblob, jres = j_pack_layer(small_tar, JPackOption(backend="numpy", **B3_OPT))
        jdict = JChunkDict(JBootstrap.from_bytes(jres.bootstrap))
        pdict = ChunkDict(Bootstrap.from_bytes(jres.bootstrap))
        blob, res = pack_layer(small_tar, PackOption(backend="fused", **B3_OPT),
                               chunk_dict=pdict, device="cpu")
        jblob, jres2 = j_pack_layer(small_tar, JPackOption(backend="numpy", **B3_OPT),
                                    chunk_dict=jdict)
        assert blob == jblob and res.bootstrap == jres2.bootstrap
        assert res.blob_size == 0 and res.referenced_blob_ids == [jres.blob_id]
