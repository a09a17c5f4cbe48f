"""The plain reference on hand cases: cuts, digests, frames, the bootstrap
reader. The port appears here only as a second witness; the reference
itself imports none of it (test_bench_imports.py)."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from benchmark.reference import blake3, cdc, check, codecs, rafs

MIB = 1 << 20


def test_cuts_of_small_and_empty_files():
    assert cdc.cuts(np.zeros(0, np.uint8), MIB).tolist() == []
    assert cdc.cuts(np.ones(100, np.uint8), MIB).tolist() == [100]
    assert cdc.cuts(np.ones(MIB // 4, np.uint8), MIB).tolist() == [MIB // 4]


def test_cuts_of_a_file_without_candidates_are_forced_at_the_maximum():
    # a constant byte gives one hash value everywhere; 0x01's fails both masks
    h = cdc.gear_hashes(np.ones(64, np.uint8))[-1]
    assert h & ((1 << 18) - 1)
    data = np.ones(9 * MIB + 5, np.uint8)
    assert cdc.cuts(data, MIB).tolist() == [4 * MIB, 8 * MIB, 9 * MIB + 5]


def test_gear_hash_by_its_definition():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, 5000, dtype=np.uint8)
    g = cdc.GEAR.astype(np.uint64)
    want = [int(sum(int(g[x[i - k]]) << k for k in range(32)) & 0xFFFFFFFF)
            for i in range(31, 5000, 97)]
    assert cdc.gear_hashes(x)[31::97].tolist() == want


@pytest.mark.parametrize("avg", [0x4000, 0x100000])
def test_cuts_match_the_ports_plain_chunker(avg):
    from nydus_snapshotter_tpu_torch.ops import cdc as port_cdc

    rng = np.random.default_rng(avg)
    for size in (avg // 4 + 1, 3 * avg, 9 * avg + 17):
        data = rng.integers(0, 256, size, dtype=np.uint8)
        data[size // 3 : size // 2] = 0
        assert np.array_equal(cdc.cuts(data, avg),
                              port_cdc.chunk_data_np(data, port_cdc.CDCParams(avg)))


def test_blake3_known_answers():
    assert blake3.digests([b""])[0].hex() == (
        "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262")
    assert blake3.digests([b"abc"])[0].hex() == (
        "6437b3ac38465133ffb63b75273a8db548c558465d79db03fd359c6cd5bd9d85")


def test_blake3_over_leaf_and_tree_edges():
    from nydus_snapshotter_tpu_torch.utils import blake3 as port_blake3

    rng = np.random.default_rng(3)
    sizes = (0, 1, 63, 64, 65, 1023, 1024, 1025, 2048, 3072, 4097, 7 * 1024, 33 * 1024 + 7)
    inputs = [rng.bytes(n) for n in sizes]
    assert blake3.digests(inputs) == [port_blake3.blake3(x) for x in inputs]


def test_sha256_is_hashlibs():
    assert hashlib.sha256(b"abc").hexdigest().startswith("ba7816bf")


def text_like(n: int) -> bytes:
    rng = np.random.default_rng(9)
    words = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8)) for k in rng.integers(3, 11, 300)]
    return b" ".join(words[int(i)] for i in rng.integers(0, 300, n // 6))[:n]


def test_lz4_frames_are_the_librarys_at_the_stated_acceleration():
    from nydus_snapshotter_tpu_torch.utils import lz4

    data = text_like(300_000)
    enc = codecs.Encoder("lz4_block", 1)
    assert bytes(enc.encode(data)) == lz4.compress_block(data, 1)
    # a faster setting stores other, larger bytes
    fast = bytes(codecs.Encoder("lz4_block", 8).encode(data))
    assert fast != bytes(enc.encode(data)) and len(fast) > len(enc.encode(data))


def test_zstd_frames_are_the_librarys_at_the_stated_level():
    import zstandard

    from nydus_snapshotter_tpu_torch.utils import zstd

    data = text_like(300_000)
    enc = codecs.Encoder("zstd", 3)
    frame = bytes(enc.encode(data))
    assert frame == zstd.compress_block(data, 3)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert bytes(enc.encode(data)) == frame  # the context is reused alike
    lower = bytes(codecs.Encoder("zstd", 1).encode(data))
    assert lower != frame and len(lower) > len(frame)
    with pytest.raises(codecs.CodecError):
        codecs.Encoder("gzip", 6)


def test_stated_settings():
    assert codecs.setting({"compressor": "lz4_block", "lz4_acceleration": 1}) == 1
    assert codecs.setting({"compressor": "zstd", "zstd_level": 3}) == 3


def test_bootstrap_reader_against_the_ports_writer():
    from nydus_snapshotter_tpu_torch.models import bootstrap as b

    boot = b.Bootstrap(
        chunk_size=MIB,
        inodes=[b.Inode("/", mode=0o40755), b.Inode("/a", mode=0o40755),
                b.Inode("/a/f", mode=0o100644, size=7, chunk_index=0, chunk_count=2),
                b.Inode("/g", mode=0o100644, size=0)],
        chunks=[b.ChunkRecord(bytes(range(32)), 0, 4, 0, 0, 3, 5),
                b.ChunkRecord(b"\x01" * 31 + b"\0", 0, 4, 3, 5, 4, 6)],
        blobs=[b.BlobRecord("ab" * 31 + "00", 11, 7, 2)])
    got = rafs.read_bootstrap(boot.to_bytes())
    assert got.paths == ["/", "/a", "/a/f", "/g"]
    assert got.inodes["size"].tolist() == [0, 0, 7, 0]
    assert got.chunks["usize"].tolist() == [3, 4]
    assert bytes(got.chunks["digest"][1]).ljust(32, b"\0") == b"\x01" * 31 + b"\0"
    assert got.blob_ids == ["ab" * 31 + "00"]  # an id ending in a zero byte
    with pytest.raises(rafs.FormatError):
        rafs.read_bootstrap(b"\0" * 4096)


def test_blob_sections():
    from nydus_snapshotter_tpu_torch.models import nydus_tar

    blob = nydus_tar.pack_entries([("image.blob", b"DATA" * 10), ("image.boot", b"B" * 3)])
    off, size = rafs.blob_section(blob)
    assert blob[off : off + size] == b"DATA" * 10
    assert rafs.blob_section(blob, "nothing") is None


def test_the_blake3_sample_holds_every_stratum():
    rng = np.random.default_rng(4)
    # layer 0: 5 000 one-leaf chunks and two long ones; layer 1: a few 2-16
    # leaf chunks among many one-leaf ones
    sizes = np.array([700] * 5000 + [3 << 20, 1 << 20] + [900] * 3000 + [5000, 9000, 16384])
    layers = np.array([0] * 5002 + [1] * 3003)
    pick, n = check.b3_sample(sizes, layers, 64 << 10, rng)
    assert n == 4
    leaves = -(-sizes[pick] // 1024)
    got = {(int(layers[i]), 0 if k <= 1 else (1 if k <= 16 else 2)) for i, k in zip(pick, leaves)}
    assert got == {(0, 0), (0, 2), (1, 0), (1, 1)}
    assert 5000 in pick  # the longest chunk
    assert sum(sizes[pick]) < (64 << 10) + (3 << 20) + (1 << 20) + 16384
