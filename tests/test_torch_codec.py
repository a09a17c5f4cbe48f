"""The port's chunk codecs against the JAX package's.

``nydus_snapshotter_tpu_torch/utils/{lz4,zstd,zstdcompat}.py`` are the
port's own copies of the reference package's codec modules, both bound to
the same system liblz4/libzstd. On seeded inputs (empty, 1 byte,
incompressible, highly compressible, 4 MiB mixed) the frames must be
byte-identical and each package must decode the other's frames exactly.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from nydus_snapshotter_tpu.utils import lz4 as jlz4
from nydus_snapshotter_tpu.utils import zstd as jzstd
from nydus_snapshotter_tpu.utils import zstdcompat as jzstdcompat
from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.utils import lz4, zstd, zstdcompat

REPO = Path(__file__).resolve().parent.parent


def _inputs() -> dict[str, bytes]:
    rng = np.random.default_rng(31)
    text = b" ".join(rng.choice([b"lorem", b"ipsum", b"dolor", b"sit", b"amet"], 40_000))
    mixed = np.concatenate(
        [
            rng.integers(0, 256, 1 << 20, dtype=np.uint8),
            np.zeros(1 << 20, np.uint8),
            np.frombuffer((text * 8)[: 1 << 20], np.uint8),
            np.where(rng.random(1 << 20) < 0.55, 0, rng.integers(0, 256, 1 << 20)).astype(np.uint8),
        ]
    ).tobytes()
    return {
        "empty": b"",
        "one_byte": b"\x7f",
        "incompressible": rng.integers(0, 256, 65_536, dtype=np.uint8).tobytes(),
        "compressible": b"\0" * 100_000 + text[:100_000],
        "mixed_4mib": mixed,
    }


INPUTS = _inputs()
needs_lz4 = pytest.mark.skipif(not lz4.native_available(), reason="no system liblz4")
needs_zstd = pytest.mark.skipif(not zstd.available(), reason="no system libzstd")


def test_both_packages_bind_the_system_libraries():
    assert lz4.native_available() == jlz4.native_available()
    assert zstd.available() == jzstd.available()
    for lib, name in ((lz4.library(), "lz4"), (zstd.library(), "zstd")):
        if lib is not None:
            path, version = lib
            assert name in Path(path).name and version.count(".") == 2


@needs_lz4
@pytest.mark.parametrize("accel", [1, 8])
@pytest.mark.parametrize("name", list(INPUTS))
def test_lz4_block_matches_reference(name, accel):
    data = INPUTS[name]
    frame = lz4.compress_block(data, accel)
    assert frame == jlz4.compress_block(data, accel)
    # zero-copy sources (a read-only view of a larger buffer) give the same frame
    view = memoryview(b"#" + data)[1:]
    assert lz4.compress_block(view, accel) == frame
    assert lz4.decompress_block(frame, len(data)) == data
    assert jlz4.decompress_block(frame, len(data)) == data
    assert lz4.decompress_block(jlz4.compress_block(data, accel), len(data)) == data


@pytest.mark.parametrize("name", ["empty", "one_byte", "incompressible", "compressible"])
def test_lz4_literal_fallback_matches_reference(name):
    """The literal-only blocks written where liblz4 is missing, and the
    pure-Python decoder, are the reference's."""
    data = INPUTS[name]
    frame = lz4._compress_literals(data)
    assert frame == jlz4._compress_literals(data)
    if data:
        assert lz4._decompress_py(frame, len(data)) == data
        assert lz4._decompress_py(jlz4.compress_block(data), len(data)) == data


@needs_zstd
@pytest.mark.parametrize("name", list(INPUTS))
def test_zstd_matches_reference(name):
    data = INPUTS[name]
    frame = zstd.compress_block(data, constants.ZSTD_LEVEL)
    assert frame == jzstd.compress_block(data, constants.ZSTD_LEVEL)
    ctx = zstd._API.acquire()
    try:
        assert zstd.compress_with_ctx(ctx, memoryview(data)) == frame
    finally:
        zstd._API.release(ctx)
    assert zstd.decompress_block(frame) == data
    assert jzstd.decompress_block(frame) == data
    assert zstd.decompress_block(jzstd.compress_block(data)) == data
    assert zstdcompat.decompress_block(frame) == jzstdcompat.decompress_block(frame) == data


@needs_zstd
def test_zstd_bounded_output_raises_like_reference():
    frame = zstd.compress_block(INPUTS["compressible"])
    with pytest.raises(zstd.ZstdError):
        zstd.decompress_block(frame, max_output_size=1000)
    with pytest.raises(jzstd.ZstdError):
        jzstd.decompress_block(frame, max_output_size=1000)


def _load_without_wheel(monkeypatch, path: Path, name: str):
    """A fresh copy of a zstdcompat module as it loads where the
    ``zstandard`` wheel is missing (the card machine has none)."""
    monkeypatch.setitem(sys.modules, "zstandard", None)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@needs_zstd
@pytest.mark.parametrize("name", ["empty", "one_byte", "compressible", "mixed_4mib"])
def test_zstdcompat_shim_matches_reference(monkeypatch, name):
    """Without the wheel, both shims compress through the system libzstd:
    the frames equal utils/zstd's and decode back exactly."""
    port = _load_without_wheel(
        monkeypatch, REPO / "nydus_snapshotter_tpu_torch/utils/zstdcompat.py", "_port_zstdcompat"
    )
    ref = _load_without_wheel(
        monkeypatch, REPO / "nydus_snapshotter_tpu/utils/zstdcompat.py", "_ref_zstdcompat"
    )
    assert not port._HAVE_PACKAGE and port.available()
    data = INPUTS[name]
    frame = port.zstandard.ZstdCompressor(level=constants.ZSTD_LEVEL).compress(data)
    assert frame == ref.zstandard.ZstdCompressor(level=constants.ZSTD_LEVEL).compress(data)
    assert frame == zstd.compress_block(data)
    assert port.zstandard.ZstdDecompressor().decompress(frame) == data
    assert port.decompress_block(frame) == ref.decompress_block(frame) == data
