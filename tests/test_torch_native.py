"""The port's native chunk engine arms against the JAX package's.

Both packages bind their own build of the same engine sources: the port's
``ops/native_cdc`` (built by ``native_cdc.build()`` into the port's
``build/``) and the reference's ``ops/native_cdc`` (its ``native/bin``).
The same numpy-seeded inputs go through each arm of both, and through an
independent oracle: the byte-at-a-time FastCDC of
``cdc.chunk_sequential_reference``, ``gear.gear_hashes_np``, ``hashlib``,
the pure-Python BLAKE3 of ``utils/blake3.py`` and the port's codec bindings
of the system liblz4/libzstd. Outputs are integers and bytes: equality is
exact. The SIMD arms are pinned by environment variables that the library
reads once per process, so each pinned arm runs in a child process.
"""

import hashlib
import inspect
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from nydus_snapshotter_tpu.ops import cdc as jcdc
from nydus_snapshotter_tpu.ops import native_cdc as j_native
from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.ops import cdc, gear, native_cdc
from nydus_snapshotter_tpu_torch.utils import blake3 as pyb3
from nydus_snapshotter_tpu_torch.utils import lz4, zstd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 0x1000
SEED = 20261018


def _data(seed: int, size: int, low_entropy: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4 if low_entropy else 256, size, dtype=np.uint8)


def _extents(sizes: list[int]) -> np.ndarray:
    offs = np.concatenate([[0], np.cumsum(sizes[:-1])]) if sizes else np.zeros(0)
    return np.stack([offs, sizes], axis=1).astype(np.int64).reshape(-1, 2)


def test_library_is_the_ports_own_build():
    path = native_cdc.library_path()
    assert path.parent == native_cdc.BUILD_DIR and path.exists()
    assert "nydus_snapshotter_tpu/native" not in str(native_cdc.load()._name)
    assert native_cdc.available()


def test_every_reference_arm_has_a_counterpart():
    """Every public function of the reference's native_cdc exists in the
    port's, and every ``*_available`` says yes on the port's build."""
    ref = {n for n, f in inspect.getmembers(j_native, inspect.isfunction)
           if f.__module__ == j_native.__name__ and not n.startswith("_")}
    port = {n for n, f in inspect.getmembers(native_cdc, inspect.isfunction)
            if f.__module__ == native_cdc.__name__}
    assert ref - port == set()
    assert "_comp_bound_total" in port
    for name in sorted(n for n in port if n.endswith("_available")):
        assert getattr(native_cdc, name)(), name


def test_gear_hashes_match_numpy_and_reference():
    data = _data(SEED, 70_001)
    got = native_cdc.gear_hashes_native(data)
    # a rolling hash from a zero state: past the 32-byte window it is the
    # windowed hash; the first positions see no zero-byte prefix
    w = gear.GEAR_WINDOW
    assert np.array_equal(got[w:], gear.gear_hashes_np(data)[w:])
    h, head = 0, []
    for x in data[:w].tolist():
        h = ((h << 1) + int(gear.gear_table()[x])) & 0xFFFFFFFF
        head.append(h)
    assert got[:w].tolist() == head
    assert np.array_equal(got, j_native.gear_hashes_native(data))
    assert native_cdc.gear_hashes_native(b"").size == 0


@pytest.mark.parametrize(
    "size,low", [(0, False), (1, False), (CHUNK // 4, False), (CHUNK // 4 + 1, False),
                 (150_003, False), (150_003, True)],
    ids=["empty", "one", "min", "min+1", "random", "low_entropy"],
)
def test_chunkers_match_sequential_reference(size, low):
    """All three scans cut where the byte-at-a-time FastCDC cuts, and where
    the reference's arms cut."""
    data = _data(SEED + size, size, low)
    params = cdc.CDCParams(CHUNK)
    want = cdc.chunk_sequential_reference(data.tobytes(), params)
    jparams = jcdc.CDCParams(CHUNK)
    for fn in ("chunk_data_native", "chunk_data_vec_native", "chunk_data_best"):
        got = getattr(native_cdc, fn)(data, params)
        assert np.array_equal(got, want), fn
        assert np.array_equal(got, getattr(j_native, fn)(data, jparams)), fn
    assert np.array_equal(native_cdc.chunk_data_native(data.tobytes(), params), want)


@pytest.mark.parametrize("chunk", [0x1000, 0x10000, 0x100000])
def test_chunkers_match_numpy_on_larger_streams(chunk):
    data = _data(SEED + chunk, 3 << 20)
    params = cdc.CDCParams(chunk)
    want = cdc.chunk_data_np(data, params)
    for fn in ("chunk_data_native", "chunk_data_vec_native"):
        assert np.array_equal(getattr(native_cdc, fn)(data, params), want), fn


def test_vectorized_mode_dispatch(monkeypatch):
    data = _data(SEED, 40_000)
    params = cdc.CDCParams(CHUNK)
    want = cdc.chunk_data_np(data, params)
    for mode in ("auto", "on", "off", "bogus"):
        monkeypatch.setenv("NTPU_COMPRESS_VECTORIZED", mode)
        assert native_cdc.vectorized_mode() == (mode if mode != "bogus" else "auto")
        assert np.array_equal(native_cdc.chunk_data_best(data, params), want)
    monkeypatch.setattr(native_cdc, "vectorized_available", lambda: False)
    monkeypatch.setenv("NTPU_COMPRESS_VECTORIZED", "on")
    with pytest.raises(RuntimeError, match="ntpu_cdc_chunk_vec"):
        native_cdc.chunk_data_best(data, params)
    monkeypatch.setenv("NTPU_COMPRESS_VECTORIZED", "auto")
    assert np.array_equal(native_cdc.chunk_data_best(data, params), want)


def _items(seed: int):
    sizes = [0, 1, 55, 56, 63, 64, 65, 1023, 1024, 1025, 2048, 3073, 16_385, 70_000]
    data = _data(seed, sum(sizes) + 7)[7:]  # an unaligned base
    return data, _extents(sizes)


def test_sha256_many_matches_hashlib_and_reference():
    data, ext = _items(SEED)
    got = native_cdc.sha256_many_native(data, ext)
    want = b"".join(hashlib.sha256(data[o : o + s].tobytes()).digest() for o, s in ext)
    assert got == want == j_native.sha256_many_native(data, ext)
    assert native_cdc.sha256_many_native(data, np.zeros((0, 2), np.int64)) == b""


def test_blake3_many_matches_pure_python_and_reference():
    data, ext = _items(SEED + 1)
    got = native_cdc.blake3_many_native(data, ext)
    want = b"".join(pyb3.blake3(data[o : o + s].tobytes()) for o, s in ext)
    assert got == want == j_native.blake3_many_native(data, ext)


@pytest.mark.parametrize("digester", ["sha256", "blake3"])
@pytest.mark.parametrize("size", [0, 1, 200_001])
def test_chunk_digest_native(digester, size):
    data = _data(SEED + size, size)
    params = cdc.CDCParams(CHUNK)
    cuts, digs = native_cdc.chunk_digest_native(data, params, digester=digester)
    assert np.array_equal(cuts, cdc.chunk_data_np(data, params))
    h = pyb3.blake3 if digester == "blake3" else (lambda b: hashlib.sha256(b).digest())
    want = b"".join(h(data[o : o + s].tobytes()) for o, s in cdc.cuts_to_extents(cuts))
    assert digs == want
    jcuts, jdigs = j_native.chunk_digest_native(data, jcdc.CDCParams(CHUNK), digester=digester)
    assert np.array_equal(cuts, jcuts) and digs == jdigs
    cuts2, none = native_cdc.chunk_digest_native(data, params, want_digests=False)
    assert np.array_equal(cuts2, cuts) and none == b""


@pytest.mark.parametrize("digester", ["sha256", "blake3"])
def test_chunk_digest_multi_matches_per_file_calls(digester):
    sizes = [0, 5, 900, 30_000, 0, 123_457, 4096]
    data = _data(SEED + 2, sum(sizes))
    ext = _extents(sizes)
    params = cdc.CDCParams(CHUNK)
    ncuts, cuts, digs = native_cdc.chunk_digest_multi(data, ext, params, digester=digester)
    want_cuts, want_digs = [], b""
    for o, s in ext:
        c, d = native_cdc.chunk_digest_native(data[o : o + s], params, digester=digester)
        want_cuts.append(c)
        want_digs += d
    assert ncuts.tolist() == [len(c) for c in want_cuts]
    assert np.array_equal(cuts, np.concatenate(want_cuts)) and digs == want_digs
    j = j_native.chunk_digest_multi(data, ext, jcdc.CDCParams(CHUNK), digester=digester)
    assert np.array_equal(ncuts, j[0]) and np.array_equal(cuts, j[1]) and digs == j[2]
    empty = native_cdc.chunk_digest_multi(data, np.zeros((0, 2), np.int64), params)
    assert [len(x) for x in empty] == [0, 0, 0]


def test_comp_bound_total_is_the_references():
    for total in (0, 1, 255, 4096, 1 << 20, 123_456_789):
        for n in (0, 1, 7, 10_000):
            for kind in (0, 1, 2):
                assert native_cdc._comp_bound_total(total, n, kind) == j_native._comp_bound_total(
                    total, n, kind
                )


def _section_input(seed: int):
    """Chunks from a 'tar' buffer (source 0) and loose bytes (source 1),
    interleaved, compressible and random."""
    rng = np.random.default_rng(seed)
    src0 = np.concatenate([_data(seed, 90_000), np.tile(np.arange(64, dtype=np.uint8), 2000)])
    src1 = np.concatenate([np.full(20_000, 7, np.uint8), _data(seed + 1, 30_000)])
    ext = []
    for k in range(40):
        src = k % 3 == 2
        buf = src1 if src else src0
        size = int(rng.integers(1, 9000))
        off = int(rng.integers(0, buf.size - size))
        ext.append((int(src), off, size))
    return src0, src1, np.asarray(ext, np.int64)


def _frame(kind: int, data: bytes, accel: int) -> bytes:
    if kind == 1:
        return lz4.compress_block(data, accel)
    if kind == 2:
        return zstd.compress_block(data, accel)
    return data


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("kind,accel", [(0, 1), (1, 1), (1, 8), (2, constants.ZSTD_LEVEL)],
                         ids=["none", "lz4", "lz4_accel8", "zstd"])
def test_pack_section(kind, accel, threads):
    """The section is the frames of the port's codec bindings back to back,
    its digest their SHA-256; equal to the reference's at any thread count."""
    src0, src1, ext = _section_input(SEED + kind)
    blob, comp, digest = native_cdc.pack_section(src0, src1, ext, kind, accel, threads)
    frames = [_frame(kind, (src1 if s else src0)[o : o + n].tobytes(), accel) for s, o, n in ext]
    assert blob.tobytes() == b"".join(frames)
    assert comp[:, 1].tolist() == [len(f) for f in frames]
    assert comp[:, 0].tolist() == np.concatenate([[0], np.cumsum(comp[:-1, 1])]).tolist()
    assert digest == hashlib.sha256(blob.tobytes()).digest()
    jblob, jcomp, jdigest = j_native.pack_section(src0, src1, ext, kind, accel, threads)
    assert blob.tobytes() == jblob.tobytes() and np.array_equal(comp, jcomp) and digest == jdigest


def test_pack_section_edges(monkeypatch):
    src0 = _data(SEED, 10_000)
    empty = native_cdc.pack_section(src0, np.empty(0, np.uint8), np.zeros((0, 3), np.int64), 1)
    assert empty[0].size == 0 and empty[1].shape == (0, 2) and empty[2] == b""
    # only source 0: src1 is passed as a null pointer
    blob, _c, _d = native_cdc.pack_section(src0, np.empty(0, np.uint8),
                                           np.asarray([(0, 5, 100)], np.int64), 2,
                                           constants.ZSTD_LEVEL, 2)
    assert blob.tobytes() == zstd.compress_block(src0[5:105].tobytes(), constants.ZSTD_LEVEL)
    # an output buffer below the codec's bound: the engine refuses, the arm raises
    monkeypatch.setattr(native_cdc, "_comp_bound_total", lambda total, n, kind: 16)
    for threads in (1, 3):
        with pytest.raises(RuntimeError, match="pack_section"):
            native_cdc.pack_section(src0, np.empty(0, np.uint8),
                                    np.asarray([(0, 0, 5000), (0, 10, 4000)], np.int64), 1, 1,
                                    threads)


@pytest.mark.parametrize("digester", [None, "sha256", "blake3"])
def test_encode_batch_native(digester):
    src0, _src1, ext3 = _section_input(SEED + 7)
    ext = ext3[ext3[:, 0] == 0][:, 1:]
    payload, comp, digs = native_cdc.encode_batch_native(src0, ext, constants.ZSTD_LEVEL, 3,
                                                         digester=digester)
    chunks = [src0[o : o + n].tobytes() for o, n in ext]
    assert [payload[o : o + n].tobytes() for o, n in comp] == [
        zstd.compress_block(c, constants.ZSTD_LEVEL) for c in chunks
    ]
    h = {None: None, "sha256": lambda b: hashlib.sha256(b).digest(), "blake3": pyb3.blake3}[digester]
    assert digs == (b"".join(h(c) for c in chunks) if h else b"")
    j = j_native.encode_batch_native(src0, ext, constants.ZSTD_LEVEL, 3, digester=digester)
    assert payload.tobytes() == j[0].tobytes() and np.array_equal(comp, j[1]) and digs == j[2]
    empty = native_cdc.encode_batch_native(src0, np.zeros((0, 2), np.int64), 3)
    assert empty[0].size == 0 and empty[1].shape == (0, 2)


def _pack_files_oracle(data, ext, params, kind, accel, digester):
    """Per-file chunk+digest calls, first-wins dedup and one pack_section
    over the unique chunks."""
    digs, sizes, uniq, first, items, nchunks = [], [], [], {}, [], []
    for o, s in ext:
        cuts, d = native_cdc.chunk_digest_native(data[o : o + s], params, digester=digester)
        nchunks.append(len(cuts))
        for i, (co, cs) in enumerate(cdc.cuts_to_extents(cuts)):
            dg = d[32 * i : 32 * i + 32]
            if dg not in first:
                first[dg] = len(items)
                items.append((0, o + co, cs))
            digs.append(dg)
            sizes.append(cs)
            uniq.append(first[dg])
    blob, comp, bdig = native_cdc.pack_section(data, np.empty(0, np.uint8),
                                               np.asarray(items, np.int64).reshape(-1, 3), kind,
                                               accel, 1)
    return nchunks, b"".join(digs), sizes, uniq, [n for _s, _o, n in items], comp, blob, bdig


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("digester", ["sha256", "blake3"])
@pytest.mark.parametrize("kind", [0, 1, 2], ids=["none", "lz4", "zstd"])
def test_pack_files_matches_per_file_calls(kind, digester, threads):
    rng = np.random.default_rng(SEED + kind)
    base = _data(SEED + 3, 60_000)
    # repeated files dedup; a low-entropy file makes long chunks
    parts = [base, _data(SEED + 4, 1000), base[:30_000], np.zeros(50_000, np.uint8), base]
    data = np.concatenate(parts)
    ext = _extents([p.size for p in parts])
    params = cdc.CDCParams(CHUNK)
    accel = constants.ZSTD_LEVEL if kind == 2 else int(rng.integers(1, 3))
    got = native_cdc.pack_files(data, ext, params, kind, accel, threads, digester=digester)
    nchunks, digs, sizes, uniq, usizes, comp, blob, bdig = _pack_files_oracle(
        data, ext, params, kind, accel, digester
    )
    assert got["file_nchunks"].tolist() == nchunks and got["digests"] == digs
    assert got["chunk_sizes"].tolist() == sizes and got["chunk_uniq"].tolist() == uniq
    assert got["uniq_sizes"].tolist() == usizes and len(usizes) < len(sizes)
    assert np.array_equal(got["comp_extents"], comp)
    assert got["blob"].tobytes() == blob.tobytes() and got["blob_digest"] == bdig
    j = j_native.pack_files(data, ext, jcdc.CDCParams(CHUNK), kind, accel, threads,
                            digester=digester)
    for key in ("file_nchunks", "chunk_sizes", "chunk_uniq", "uniq_sizes", "comp_extents", "blob"):
        assert np.array_equal(got[key], j[key]), key
    assert got["digests"] == j["digests"] and got["blob_digest"] == j["blob_digest"]


def test_pack_files_empty_extent_list():
    got = native_cdc.pack_files(np.empty(0, np.uint8), np.zeros((0, 2), np.int64),
                                cdc.CDCParams(CHUNK), 1)
    want = j_native.pack_files(np.empty(0, np.uint8), np.zeros((0, 2), np.int64),
                               jcdc.CDCParams(CHUNK), 1)
    assert got["blob"].size == 0 and got["blob_digest"] == hashlib.sha256(b"").digest()
    assert set(got) == set(want)
    for key in got:
        if isinstance(got[key], np.ndarray):
            assert got[key].shape == want[key].shape, key
        else:
            assert got[key] == want[key], key


def test_concat_extents():
    views = [b"ab", memoryview(b"cde")[1:], np.arange(4, dtype=np.uint8).tobytes(), b""]
    buf, ext = native_cdc.concat_extents(views)
    jbuf, jext = j_native.concat_extents(views)
    assert buf.tobytes() == b"abde\x00\x01\x02\x03" == jbuf.tobytes()
    assert np.array_equal(ext, jext) and ext.tolist() == [[0, 2], [2, 2], [4, 4], [8, 0]]


_ISA_CHILD = textwrap.dedent(
    """
    import hashlib, json, sys
    import numpy as np
    from nydus_snapshotter_tpu_torch.ops import cdc, native_cdc

    def sig(*parts):
        h = hashlib.sha256()
        for p in parts:
            h.update(p if isinstance(p, bytes) else np.ascontiguousarray(p).tobytes())
        return h.hexdigest()

    rng = np.random.default_rng(0x15A)
    params = cdc.CDCParams(0x1000)
    runs = []
    for size in (0, 1, 2047, 2048, 65536 * 3 + 5, 1 << 20):
        data = rng.integers(0, 256, size, dtype=np.uint8)
        low = rng.integers(0, 3, size, dtype=np.uint8)
        ext = np.asarray([(0, size), (size // 3, size - size // 3)], np.int64)
        runs.append([
            sig(*native_cdc.chunk_digest_native(data, params, digester="sha256")),
            sig(*native_cdc.chunk_digest_native(data, params, digester="blake3")),
            sig(native_cdc.chunk_data_vec_native(data, params),
                native_cdc.chunk_data_vec_native(low, params)),
            sig(native_cdc.blake3_many_native(data, ext), native_cdc.sha256_many_native(data, ext)),
        ])
    print(json.dumps({"gear": native_cdc.gear_active_isa(), "cdc": native_cdc.cdc_active_isa(),
                      "b3": native_cdc.b3_active_isa(), "forced": native_cdc.forced_isa(),
                      "runs": runs}))
    """
)


def _run_child(env_pins: dict) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "NTPU_GEAR_FORCE_ISA", "NTPU_CDC_FORCE_ISA",
                        "NTPU_B3_FORCE_ISA")}
    env.update(PYTHONPATH=REPO, **env_pins)
    proc = subprocess.run([sys.executable, "-c", _ISA_CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def host_arms():
    """The arms the library picks on this CPU with nothing pinned."""
    return _run_child({})


# (variable, value, the arm it asks for, the key of its active-arm report)
ISA_PINS = [
    ("NTPU_GEAR_FORCE_ISA", "scalar", 1, "gear"),
    ("NTPU_GEAR_FORCE_ISA", "avx2", 2, "gear"),
    ("NTPU_CDC_FORCE_ISA", "scalar", 1, "cdc"),
    ("NTPU_CDC_FORCE_ISA", "avx2", 2, "cdc"),
    ("NTPU_B3_FORCE_ISA", "scalar", 1, "b3"),
    ("NTPU_B3_FORCE_ISA", "avx2", 2, "b3"),
    ("NTPU_B3_FORCE_ISA", "avx512", 3, "b3"),
]


@pytest.mark.parametrize("var,value,arm,key", ISA_PINS,
                         ids=[f"{v.split('_')[1].lower()}-{x}" for v, x, _a, _k in ISA_PINS])
def test_forced_isa_arm_matches_host_dispatch(host_arms, var, value, arm, key):
    """A pinned arm runs (never wider than the CPU offers: the library
    degrades a pin the CPU lacks) and computes what the host's own pick
    computes, on every arm the CPU has."""
    pinned = _run_child({var: value})
    assert pinned[key] == min(arm, host_arms[key])
    assert pinned["runs"] == host_arms["runs"]
    assert pinned["forced"] == (value if var == "NTPU_CDC_FORCE_ISA" else "")
