"""The port's configuration plane against the JAX package's.

Both packages load the same TOML to equal dataclass trees and refuse the
same bad files. Each resolver the port reads from the global config does
so as the reference does (env > config section > default): the trace's
``[trace]``, the pipeline's ``[convert]`` (and ``[compression]
batch_chunks``), the dict's ``[chunk_dict]``, the native chunker's
``[compression] vectorized``, and ``[compression] adaptive``, which the
port refuses with zstd as it refuses ``NTPU_COMPRESS_ADAPTIVE`` (the
adaptive codec is not ported).
"""

import dataclasses
import io
import tarfile
from pathlib import Path

import numpy as np
import pytest

from nydus_snapshotter_tpu import trace as jtrace
from nydus_snapshotter_tpu.config import config as jcfg
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.ops import native_cdc as jnative
from nydus_snapshotter_tpu.parallel import dict_service as jds
from nydus_snapshotter_tpu.parallel import pipeline as jpl
from nydus_snapshotter_tpu_torch import trace as ttrace
from nydus_snapshotter_tpu_torch.config import config as tcfg
from nydus_snapshotter_tpu_torch.converter import ConvertError, PackOption, pack_layer
from nydus_snapshotter_tpu_torch.converter.batch import BatchConverter
from nydus_snapshotter_tpu_torch.converter.pack import adaptive_codec_requested
from nydus_snapshotter_tpu_torch.ops import native_cdc as tnative
from nydus_snapshotter_tpu_torch.parallel import dict_service as tds
from nydus_snapshotter_tpu_torch.parallel import pipeline as tpl
from nydus_snapshotter_tpu_torch.utils import zstd as zstd_native

REPO = Path(__file__).resolve().parent.parent

TOML = """
root = "/var/lib/containerd-nydus-tpu"
[daemon]
fs_driver = "fusedev"
[convert]
pipeline = "on"
chunk_workers = 3
compress_workers = 5
queue_mib = 7
memory_budget_mib = 9
window_mib = 11
[compression]
adaptive = true
vectorized = "off"
batch_chunks = 4
[trace]
enabled = true
ring_capacity = 123
slow_op_threshold_ms = 45.5
sample_ratio = 0.5
[chunk_dict]
load_factor = 0.7
headroom = 3.0
service = "/run/dict.sock"
namespace = "team"
service_backend = "host"
"""

KNOBS = ("NTPU_PIPELINE", "NTPU_CHUNK_THREADS", "NTPU_COMPRESS_THREADS", "NTPU_PIPELINE_QUEUE_MIB",
         "NTPU_PIPELINE_BUDGET_MIB", "NTPU_PIPELINE_WINDOW_MIB", "NTPU_COMPRESS_ADAPTIVE",
         "NTPU_COMPRESS_VECTORIZED", "NTPU_COMPRESS_BATCH_CHUNKS", "NTPU_TRACE",
         "NTPU_TRACE_RING_CAPACITY", "NTPU_TRACE_SLOW_OP_MS", "NTPU_TRACE_SAMPLE_RATIO",
         "NTPU_DICT_LOAD_FACTOR", "NTPU_DICT_HEADROOM", "NTPU_DICT_SERVICE", "NTPU_DICT_NAMESPACE",
         "NTPU_DICT_BACKEND")


@pytest.fixture(autouse=True)
def _clean_config(monkeypatch):
    """Both packages' global configs unset, and no env knob, around each
    case."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tcfg, "_global", None)
    monkeypatch.setattr(jcfg, "_global", None)
    yield


@pytest.fixture()
def toml(tmp_path):
    path = tmp_path / "config.toml"
    path.write_text(TOML)
    return str(path)


def _both_global(path):
    tcfg.set_global_config(tcfg.load_config(path))
    jcfg.set_global_config(jcfg.load_config(path))


@pytest.mark.parametrize(
    "source", ["defaults", "toml", "misc/snapshotter/config.toml", "misc/snapshotter/config-tarfs.toml"]
)
def test_load_config_equal_trees(toml, source):
    path = {"defaults": None, "toml": toml}.get(source, str(REPO / source))
    assert dataclasses.asdict(tcfg.load_config(path)) == dataclasses.asdict(jcfg.load_config(path))


def test_overrides_equal_trees(toml):
    over = {"log": {"log_level": "debug"}, "trace": {"sample_ratio": 0.1}}
    assert dataclasses.asdict(tcfg.load_config(toml, over)) == dataclasses.asdict(
        jcfg.load_config(toml, over))


@pytest.mark.parametrize(
    "bad",
    ['nosuchkey = 1', '[convert]\npipeline = "sideways"', '[compression]\nbatch_chunks = -1',
     '[trace]\nring_capacity = "many"', '[chunk_dict]\nload_factor = 2.0'],
    ids=["unknown_key", "pipeline_mode", "batch_chunks", "type", "load_factor"],
)
def test_same_refusals(tmp_path, bad):
    """The same exception, type and message (a mistyped number reaches
    validation and fails there with a TypeError in both)."""
    path = tmp_path / "bad.toml"
    path.write_text(bad + "\n")
    with pytest.raises(Exception) as jerr:
        jcfg.load_config(str(path))
    with pytest.raises(Exception) as terr:
        tcfg.load_config(str(path))
    assert (type(terr.value).__name__, str(terr.value)) == (type(jerr.value).__name__, str(jerr.value))


def test_global_accessor_unset_raises():
    with pytest.raises(tcfg.ConfigError, match="not initialized"):
        tcfg.get_global_config()


def test_convert_section_read_as_reference(toml):
    _both_global(toml)
    for n in (1, 4):
        got = tpl.resolve_config(n)
        assert got.__dict__ == jpl.resolve_config(n).__dict__
        assert (got.enabled, got.chunk_workers, got.compress_workers, got.queue_bytes,
                got.budget_bytes, got.window_bytes) == (True, 3, 5, 7 << 20, 9 << 20, 11 << 20)
    assert tpl.resolve_batch_chunks() == 4


def test_env_overrides_convert_section(toml, monkeypatch):
    _both_global(toml)
    monkeypatch.setenv("NTPU_PIPELINE", "off")
    monkeypatch.setenv("NTPU_COMPRESS_BATCH_CHUNKS", "0")
    assert tpl.resolve_config(4).__dict__ == jpl.resolve_config(4).__dict__
    assert not tpl.resolve_config(4).enabled and tpl.resolve_batch_chunks() == 0


def test_trace_section_read_as_reference(toml, monkeypatch):
    _both_global(toml)
    got = ttrace.resolve_trace_config()
    assert got.__dict__ == jtrace.resolve_trace_config().__dict__
    assert (got.ring_capacity, got.slow_op_threshold_ms, got.sample_ratio) == (123, 45.5, 0.5)
    monkeypatch.setenv("NTPU_TRACE", "off")
    assert not ttrace.resolve_trace_config().enabled
    assert ttrace.resolve_trace_config().__dict__ == jtrace.resolve_trace_config().__dict__


def test_chunk_dict_section_read_as_reference(toml, monkeypatch):
    _both_global(toml)
    got, want = tds.resolve_dict_config(), jds.resolve_dict_config()
    fields = ("load_factor", "headroom", "service", "namespace", "backend")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    assert [getattr(got, f) for f in fields] == [0.7, 3.0, "/run/dict.sock", "team", "host"]
    monkeypatch.setenv("NTPU_DICT_NAMESPACE", "env")
    assert tds.resolve_dict_config().namespace == jds.resolve_dict_config().namespace == "env"


def test_vectorized_read_as_reference(toml, monkeypatch):
    assert tnative.vectorized_mode() == jnative.vectorized_mode() == "auto"
    _both_global(toml)
    assert tnative.vectorized_mode() == jnative.vectorized_mode() == "off"
    monkeypatch.setenv("NTPU_COMPRESS_VECTORIZED", "on")
    assert tnative.vectorized_mode() == jnative.vectorized_mode() == "on"


def _tar() -> bytes:
    data = np.random.default_rng(3).integers(0, 256, 50_000, dtype=np.uint8).tobytes()
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        ti = tarfile.TarInfo("f")
        ti.size = len(data)
        tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


@pytest.mark.skipif(not zstd_native.available(), reason="the system libzstd is not bound")
def test_adaptive_config_refused_as_env(toml, monkeypatch):
    """``[compression] adaptive = true`` makes the reference pack zstd
    through its adaptive codec; the port refuses it as it refuses
    ``NTPU_COMPRESS_ADAPTIVE=1``, and the env var still wins."""
    from nydus_snapshotter_tpu.converter import codec as jcodec

    _both_global(toml)
    opt = PackOption(compressor="zstd", chunk_size=0x4000, backend="hybrid")
    assert jcodec.resolve_codec(JPackOption(compressor="zstd")) is not None
    assert adaptive_codec_requested(opt)
    with pytest.raises(ConvertError, match="adaptive codec"):
        pack_layer(_tar(), opt, device="cpu")
    with pytest.raises(ConvertError, match="adaptive codec"):
        BatchConverter(opt, device="cpu")
    pack_layer(_tar(), PackOption(compressor="lz4_block", chunk_size=0x4000, backend="hybrid"),
               device="cpu")
    monkeypatch.setenv("NTPU_COMPRESS_ADAPTIVE", "0")
    assert not adaptive_codec_requested(opt)
    assert jcodec.resolve_codec(JPackOption(compressor="zstd")) is None
    pack_layer(_tar(), opt, device="cpu")
