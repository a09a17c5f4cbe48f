"""Adaptive per-chunk compression engine: the codec stage behind the
pack lanes' section writer and the pipeline's speculative-compress
workers. The PyTorch port's copy of the reference package's
``converter/codec.py``; frames, classes and trained-dictionary files are
byte-identical to it.

Per-chunk frames are independent, so the codec decides per chunk:

- **probe**: a cheap compressibility estimate per chunk: a sampled
  trial-compress at level 1 (``probe = "sample"``) or a byte-entropy
  estimate (``"entropy"``), classifying the chunk into bypass / fast /
  default / best corpus classes;
- **store-raw bypass**: incompressible chunks are stored uncompressed
  (the ``COMPRESSOR_NONE`` chunk flag, which every reader handles);
- **per-class levels**: low-gain chunks drop to a fast level, high-gain
  chunks may opt into a better level;
- **corpus-trained dictionaries**: a ZDICT dictionary trained from chunk
  samples during batch convert (epoch-stamped, persisted beside the chunk
  dictionary and shared through ``parallel/dict_service.py``) compresses
  small and medium chunks against shared context;
- **per-worker context reuse**: each compress worker pins ONE
  ``ZSTD_CCtx`` (and one digested ``CDict`` per level) for its whole run.

Everything is OFF by default: with ``[compression] adaptive = false`` no
codec object is constructed and pack output is the fixed-level lane's.
Trained-dict frames carry a versioned header (``nZD1`` + dictionary id)
and fail loudly without the dictionary (:func:`decode_trained_frame`).

The codec runs on the host in both packages: the probe, the per-chunk
encodes and the training are libzstd calls. On the card's lanes the cuts
and digests stay on the device; an active codec only moves the pack to
the serial section writer (converter/pack.py).
"""

from __future__ import annotations

import hashlib
import os
import struct
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Optional

from nydus_snapshotter_tpu_torch import constants, failpoint
from nydus_snapshotter_tpu_torch.config.config import global_section
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics
from nydus_snapshotter_tpu_torch.utils import zstd as zstd_native

_reg = _metrics.default_registry

PROBE_TOTAL = _reg.register(
    _metrics.Counter(
        "ntpu_compress_probe_total",
        "Per-chunk compressibility-probe decisions by class "
        "(bypass/fast/default/best; fallback = probe failed, chunk "
        "compressed at the default level)",
        ("decision",),
    )
)
BYPASS_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_compress_bypass_bytes_total",
        "Chunk bytes stored raw by the incompressibility bypass",
    )
)
LEVEL_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_compress_level_bytes_total",
        "Input chunk bytes compressed per zstd level",
        ("level",),
    )
)
DICT_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_compress_trained_dict_bytes_total",
        "Input chunk bytes compressed against a trained dictionary",
    )
)
CTX_REUSE = _reg.register(
    _metrics.Counter(
        "ntpu_compress_ctx_reuse_total",
        "Encodes served by an already-pinned per-worker compression context",
    )
)
TRAIN_TOTAL = _reg.register(
    _metrics.Counter(
        "ntpu_compress_train_total",
        "Dictionary training outcomes (trained / failed / skipped)",
        ("outcome",),
    )
)
BATCH_TOTAL = _reg.register(
    _metrics.Counter(
        "ntpu_compress_batch_total",
        "Batched encode calls served by the native batch lane "
        "(one GIL-released ntpu_encode_batch call per level group)",
    )
)
BATCH_CHUNKS = _reg.register(
    _metrics.Counter(
        "ntpu_compress_batch_chunks_total",
        "Chunks whose zstd frame came out of the native batch lane",
    )
)


class CodecError(RuntimeError):
    """Adaptive-codec failure (probe/train/encode/decode)."""


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclass
class CodecConfig:
    """Resolved ``[compression]`` knobs (env > global config > defaults).

    ``adaptive`` is the master switch; with it off nothing below
    applies and pack output stays byte-identical to the reference lane.
    Ratios are predicted ``compressed/uncompressed`` on the probe sample:
    ``>= bypass_ratio`` stores raw, ``>= low_gain_ratio`` compresses at
    ``level_fast``, ``<= high_gain_ratio`` at ``level_best``, the rest at
    ``level_default`` (0 = ``constants.ZSTD_LEVEL``).
    """

    adaptive: bool = False
    probe: str = "sample"  # sample | entropy | off
    probe_sample_kib: int = 16
    bypass_ratio: float = 0.97
    low_gain_ratio: float = 0.85
    high_gain_ratio: float = 0.35
    level_fast: int = 1
    level_default: int = 0  # 0 = constants.ZSTD_LEVEL
    # The high-gain class defaults to the reference level — the default
    # engine is strictly speed-positive (bypass + fast-lane savings,
    # never a costlier level). Raising level_best trades some of that
    # win back into ratio on exactly the chunks where a level is
    # cheapest per saved byte (the profile tool's levels arm measures
    # the trade).
    level_best: int = 3
    dict_path: str = ""  # epoch-stamped trained dictionary to load
    train: bool = False  # train per-namespace during batch convert
    train_dict_kib: int = 112
    train_sample_mib: int = 8
    # Batched codec lane: how many chunks a pipeline compress worker may
    # drain into one encode_batch() call (0 disables draining — every
    # chunk goes through encode() alone). Output is byte-identical either
    # way; the batch only changes how many frames one GIL-released native
    # call produces.
    batch_chunks: int = 16
    # Vectorized CDC scan: auto = use the SIMD lane-parallel scanner when
    # the native library exposes it, on = require it (loud failure when
    # absent), off = always the sequential gear scanner. Cut positions
    # are identical across all three — this is purely a throughput knob.
    vectorized: str = "auto"

    # Chunks below this size skip the probe (probe overhead beats any
    # possible saving) and compress at the default level.
    MIN_PROBE_BYTES = 4096

    def effective_level(self, cls: str) -> int:
        if cls == "fast":
            return self.level_fast
        if cls == "best":
            return self.level_best
        return self.level_default or constants.ZSTD_LEVEL


def _env_str(name: str, default: str) -> str:
    v = os.environ.get(name, "")
    return v if v else default


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name, "")
    if v in ("", None):
        return default
    return v not in ("0", "off", "false", "no")


def _env_int(name: str, default: int) -> int:
    try:
        v = int(os.environ.get(name, ""))
        return v if v > 0 else default
    except ValueError:
        return default


def _env_int0(name: str, default: int) -> int:
    """Like :func:`_env_int` but 0 is a valid (disabling) value."""
    try:
        v = int(os.environ.get(name, ""))
        return v if v >= 0 else default
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def resolve_codec_config() -> CodecConfig:
    """env (``NTPU_COMPRESS_*``) > ``[compression]`` config > defaults."""
    c = global_section("compression")
    cfg = CodecConfig(
        adaptive=_env_bool(
            "NTPU_COMPRESS_ADAPTIVE", bool(getattr(c, "adaptive", False))
        ),
        probe=_env_str("NTPU_COMPRESS_PROBE", getattr(c, "probe", "") or "sample"),
        probe_sample_kib=_env_int(
            "NTPU_COMPRESS_PROBE_SAMPLE_KIB",
            getattr(c, "probe_sample_kib", 0) or 16,
        ),
        bypass_ratio=_env_float(
            "NTPU_COMPRESS_BYPASS_RATIO", getattr(c, "bypass_ratio", 0.97)
        ),
        low_gain_ratio=getattr(c, "low_gain_ratio", 0.85),
        high_gain_ratio=getattr(c, "high_gain_ratio", 0.35),
        dict_path=_env_str("NTPU_COMPRESS_DICT", getattr(c, "dict_path", "") or ""),
        train=_env_bool("NTPU_COMPRESS_TRAIN", bool(getattr(c, "train", False))),
        train_dict_kib=getattr(c, "train_dict_kib", 112) or 112,
        train_sample_mib=getattr(c, "train_sample_mib", 8) or 8,
        level_fast=getattr(c, "level_fast", 1),
        level_default=getattr(c, "level_default", 0),
        level_best=getattr(c, "level_best", 3),
        batch_chunks=_env_int0(
            "NTPU_COMPRESS_BATCH_CHUNKS", getattr(c, "batch_chunks", 16)
        ),
        vectorized=_env_str(
            "NTPU_COMPRESS_VECTORIZED", getattr(c, "vectorized", "") or "auto"
        ),
    )
    if cfg.vectorized not in ("auto", "on", "off"):
        cfg.vectorized = "auto"
    levels = os.environ.get("NTPU_COMPRESS_LEVELS", "")
    if levels:
        try:
            fast, default, best = (int(x) for x in levels.split(","))
            cfg.level_fast, cfg.level_default, cfg.level_best = fast, default, best
        except ValueError:
            pass
    return cfg


def resolve_codec(opt) -> "Optional[AdaptiveCodec]":
    """The pack path's codec hook: an :class:`AdaptiveCodec` when the
    adaptive engine is enabled AND applies to this pack (zstd compressor,
    system libzstd bound), else ``None`` — the byte-identical default."""
    if getattr(opt, "compressor", "") != "zstd":
        return None
    cfg = resolve_codec_config()
    if not cfg.adaptive or not zstd_native.available():
        return None
    trained = None
    if cfg.dict_path:
        trained = TrainedDict.load(cfg.dict_path)
    codec = AdaptiveCodec(cfg, trained=trained)
    if cfg.train and trained is None:
        codec.attach_trainer()
    return codec


# ---------------------------------------------------------------------------
# Trained dictionaries: file format, registry, digested handles
# ---------------------------------------------------------------------------

# Chunk-frame header for trained-dict frames. Versioned: the trailing
# digit is the layout version — readers reject versions they don't know
# LOUDLY instead of feeding libzstd a frame it cannot have the dict for.
TRAINED_FRAME_MAGIC = b"nZD1"
_TRAINED_HEADER = struct.Struct("<4sI")  # magic | dict_id

# Epoch-stamped on-disk format (the v5 chunk-dict discipline:
# header-last is not needed here because the file is written whole, but
# the checksum rejects torn/corrupt writes).
_DICT_FILE_MAGIC = b"NTPUZDCT"
_DICT_FILE_VERSION = 1
_DICT_HDR = struct.Struct("<8sIIQI")  # magic | version | dict_id | epoch | len


class TrainedDict:
    """An epoch-stamped ZDICT dictionary: the trained bytes plus the
    identity (``dict_id``) every frame compressed with it embeds."""

    def __init__(self, dict_bytes: bytes, epoch: int):
        self.bytes = dict_bytes
        self.epoch = int(epoch)
        self.dict_id = zstd_native.dict_id_of(dict_bytes)
        if self.dict_id == 0:
            raise CodecError("trained dictionary carries no ZDICT id")

    # -- wire/disk format ----------------------------------------------------

    def serialize(self) -> bytes:
        hdr = _DICT_HDR.pack(
            _DICT_FILE_MAGIC,
            _DICT_FILE_VERSION,
            self.dict_id,
            self.epoch,
            len(self.bytes),
        )
        return hdr + self.bytes + hashlib.sha256(hdr + self.bytes).digest()[:8]

    @classmethod
    def deserialize(cls, data: bytes) -> "TrainedDict":
        if len(data) < _DICT_HDR.size + 8:
            raise CodecError("trained-dict blob too short")
        magic, version, dict_id, epoch, n = _DICT_HDR.unpack_from(data)
        if magic != _DICT_FILE_MAGIC:
            raise CodecError("not a trained-dict blob (bad magic)")
        if version != _DICT_FILE_VERSION:
            raise CodecError(f"unsupported trained-dict format v{version}")
        end = _DICT_HDR.size + n
        if len(data) < end + 8:
            raise CodecError("trained-dict blob truncated")
        if hashlib.sha256(data[:end]).digest()[:8] != data[end : end + 8]:
            raise CodecError("trained-dict blob checksum mismatch (torn write?)")
        td = cls(data[_DICT_HDR.size : end], epoch)
        if td.dict_id != dict_id:
            raise CodecError(
                f"trained-dict id skew: header says {dict_id}, "
                f"payload says {td.dict_id}"
            )
        return td

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(self.serialize())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "TrainedDict":
        with open(path, "rb") as f:
            return cls.deserialize(f.read())


class _DictHandles:
    """Digested handles for one registered dictionary: a DDict for decode
    plus lazily-created per-level CDicts for encode."""

    def __init__(self, td: TrainedDict):
        self.td = td
        self.ddict = zstd_native.DDict(td.bytes)
        self._cdicts: dict[int, zstd_native.CDict] = {}
        self._mu = threading.Lock()

    def cdict(self, level: int) -> zstd_native.CDict:
        with self._mu:
            cd = self._cdicts.get(level)
            if cd is None:
                cd = self._cdicts[level] = zstd_native.CDict(self.td.bytes, level)
            return cd


_registry_mu = threading.Lock()
_dict_registry: dict[int, _DictHandles] = {}


def register_trained_dict(td: TrainedDict) -> _DictHandles:
    """Make a trained dictionary decodable process-wide (keyed by its
    embedded dict id — the id every frame it produced carries)."""
    with _registry_mu:
        h = _dict_registry.get(td.dict_id)
        if h is None or h.td.epoch < td.epoch:
            h = _dict_registry[td.dict_id] = _DictHandles(td)
        return h


def unregister_trained_dict(dict_id: int) -> None:
    with _registry_mu:
        _dict_registry.pop(dict_id, None)


def lookup_trained_dict(dict_id: int) -> Optional[_DictHandles]:
    with _registry_mu:
        return _dict_registry.get(dict_id)


def is_trained_frame(data) -> bool:
    """True when a COMPRESSOR_ZSTD chunk payload is a trained-dict frame
    (``nZD1`` header). A plain zstd frame can never collide: its first
    byte is the zstd magic's 0x28 (or 0x50-0x5f for skippable frames),
    never ``n``."""
    return len(data) >= _TRAINED_HEADER.size and bytes(data[:4]) == TRAINED_FRAME_MAGIC


def decode_trained_frame(data, expect_size: int = 0) -> bytes:
    """Decode one ``nZD1`` trained-dict chunk frame.

    Fails LOUDLY — naming the dictionary id the frame was compressed
    with — when that dictionary is not registered in this process; a
    reader must fetch it (``[compression] dict_path``, or the dict
    service's ``zdict`` endpoint) before it can serve the blob.
    """
    magic, dict_id = _TRAINED_HEADER.unpack_from(bytes(data[: _TRAINED_HEADER.size]))
    if magic != TRAINED_FRAME_MAGIC:
        raise CodecError("not a trained-dict chunk frame")
    h = lookup_trained_dict(dict_id)
    if h is None:
        raise CodecError(
            f"chunk frame was compressed with trained zstd dictionary "
            f"id={dict_id} which is not loaded — load the namespace's "
            f"epoch-stamped dictionary (config [compression] dict_path, "
            f"or GET /api/v1/dict/<ns>/zdict) before reading this blob"
        )
    try:
        return zstd_native.decompress_with_ddict(
            data[_TRAINED_HEADER.size :], h.ddict, expect_size
        )
    except zstd_native.ZstdError as e:
        raise CodecError(str(e)) from e


# ---------------------------------------------------------------------------
# Dictionary training
# ---------------------------------------------------------------------------


class DictTrainer:
    """Bounded, deterministic chunk-sample reservoir for ZDICT training.

    Compress workers ``offer()`` every chunk they encode; the trainer
    keeps a deterministic every-Nth stride of them (clamped per-sample so
    one huge chunk cannot eat the budget) until ``train_sample_mib`` is
    reached. Training runs ONCE, off the converter's ordered path.
    """

    STRIDE = 4  # keep every 4th offered chunk
    SAMPLE_CLAMP = 64 << 10  # per-sample byte cap
    MIN_SAMPLES = 8

    def __init__(self, cfg: CodecConfig):
        self.cfg = cfg
        self._mu = threading.Lock()
        self._samples: list[bytes] = []
        self._bytes = 0
        self._seen = 0
        self._budget = cfg.train_sample_mib << 20

    def offer(self, data) -> None:
        if self._bytes >= self._budget:
            return
        with self._mu:
            self._seen += 1
            if self._seen % self.STRIDE or self._bytes >= self._budget:
                return
            piece = bytes(data[: self.SAMPLE_CLAMP])
            if not piece:
                return
            self._samples.append(piece)
            self._bytes += len(piece)

    def ready(self) -> bool:
        with self._mu:
            return (
                self._bytes >= self._budget and len(self._samples) >= self.MIN_SAMPLES
            )

    def stats(self) -> dict:
        with self._mu:
            return {
                "samples": len(self._samples),
                "bytes": self._bytes,
                "seen": self._seen,
            }

    def train(self, epoch: Optional[int] = None) -> TrainedDict:
        """ZDICT training over the reservoir → an epoch-stamped
        :class:`TrainedDict`. Raises :class:`CodecError` on failure (the
        caller falls back to untrained compression)."""
        failpoint.hit("compress.train")
        with self._mu:
            samples = list(self._samples)
        if len(samples) < self.MIN_SAMPLES:
            raise CodecError(
                f"too few chunk samples to train a dictionary "
                f"({len(samples)} < {self.MIN_SAMPLES})"
            )
        try:
            dict_bytes = zstd_native.train_dict(
                samples, self.cfg.train_dict_kib << 10
            )
        except zstd_native.ZstdError as e:
            raise CodecError(str(e)) from e
        return TrainedDict(dict_bytes, epoch if epoch is not None else int(time.time()))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class _WorkerState:
    """One compress worker's pinned codec state: a ZSTD_CCtx taken from
    the pool ONCE (returned when the worker thread dies) — per-chunk
    encode pays neither a context allocation nor the pool lock."""

    __slots__ = ("ctx", "_fin", "__weakref__")

    def __init__(self):
        self.ctx = zstd_native.cctx_acquire()
        self._fin = weakref.finalize(self, zstd_native.cctx_release, self.ctx)


class AdaptiveCodec:
    """The codec stage: ``encode(view) -> (payload, chunk_flag)``.

    Deterministic in chunk content alone (probe, level choice and codec
    output are pure functions of the bytes + config), so the pipeline's
    speculative compress workers and the inline assembler produce
    identical payloads — the same invariant the fixed-level lane holds.
    Thread-safe: per-worker state is thread-local.
    """

    def __init__(
        self,
        cfg: Optional[CodecConfig] = None,
        trained: Optional[TrainedDict] = None,
        trainer: Optional[DictTrainer] = None,
    ):
        if not zstd_native.available():
            raise CodecError("adaptive codec needs the system libzstd")
        self.cfg = cfg or resolve_codec_config()
        self.trained: Optional[TrainedDict] = None
        self._handles: Optional[_DictHandles] = None
        self._trainer = trainer
        self._train_failed = False
        self._tls = threading.local()
        self.counts = {"bypass": 0, "fast": 0, "default": 0, "best": 0, "fallback": 0}
        self.class_bytes = {"bypass": 0, "fast": 0, "default": 0, "best": 0, "fallback": 0}
        self._mu = threading.Lock()
        if trained is not None:
            self.set_trained(trained)

    # -- dictionary lifecycle ------------------------------------------------

    def set_trained(self, td: TrainedDict) -> None:
        """Adopt (and globally register, so this process can decode its
        own output) a trained dictionary."""
        self._handles = register_trained_dict(td)
        self.trained = td

    def attach_trainer(self) -> DictTrainer:
        if self._trainer is None:
            self._trainer = DictTrainer(self.cfg)
        return self._trainer

    @property
    def trainer(self) -> Optional[DictTrainer]:
        return self._trainer

    def maybe_train(self, force: bool = False) -> Optional[TrainedDict]:
        """Train once the sample reservoir is full (or ``force``d with
        whatever it holds). Training failure is NOT fatal: the codec
        falls back to untrained compression permanently and says so in
        ``ntpu_compress_train_total{outcome="failed"}``."""
        if self.trained is not None or self._trainer is None or self._train_failed:
            return None
        if not force and not self._trainer.ready():
            return None
        try:
            td = self._trainer.train()
        except failpoint.Panic:
            raise
        except Exception:
            self._train_failed = True
            TRAIN_TOTAL.labels("failed").inc()
            return None
        self.set_trained(td)
        TRAIN_TOTAL.labels("trained").inc()
        return td

    # -- probe ---------------------------------------------------------------

    def _sample(self, data) -> bytes:
        """Up to ``probe_sample_kib`` KiB as head/middle/tail slices —
        deterministic in content, cheap to assemble."""
        n = len(data)
        budget = self.cfg.probe_sample_kib << 10
        if n <= budget:
            return bytes(data)
        piece = budget // 3
        mid = (n - piece) // 2
        return b"".join(
            (
                bytes(data[:piece]),
                bytes(data[mid : mid + piece]),
                bytes(data[n - piece :]),
            )
        )

    def _predicted_ratio(self, data) -> float:
        sample = self._sample(data)
        if not sample:
            return 0.0
        if self.cfg.probe == "entropy":
            import numpy as np

            counts = np.bincount(
                np.frombuffer(sample, dtype=np.uint8), minlength=256
            )
            p = counts[counts > 0] / len(sample)
            h = float(-(p * np.log2(p)).sum())  # bits/byte
            return h / 8.0
        st = self._state()
        comp = zstd_native.compress_with_ctx(st.ctx, sample, self.cfg.level_fast)
        return len(comp) / len(sample)

    def classify(self, data) -> str:
        """The per-chunk corpus class — bypass / fast / default / best.
        Probe failure (chaos-injectable at ``compress.probe``) degrades
        to ``fallback``: always-compress at the default level."""
        if self.cfg.probe == "off" or len(data) < CodecConfig.MIN_PROBE_BYTES:
            return "default"
        try:
            failpoint.hit("compress.probe")
            r = self._predicted_ratio(data)
        except failpoint.Panic:
            raise
        except Exception:
            return "fallback"
        if r >= self.cfg.bypass_ratio:
            return "bypass"
        if r >= self.cfg.low_gain_ratio:
            return "fast"
        if r <= self.cfg.high_gain_ratio:
            return "best"
        return "default"

    # -- encode --------------------------------------------------------------

    def _state(self) -> _WorkerState:
        st = getattr(self._tls, "st", None)
        if st is None:
            st = self._tls.st = _WorkerState()
        return st

    def _count(self, cls: str, n: int) -> None:
        with self._mu:
            self.counts[cls] += 1
            self.class_bytes[cls] += n

    def _plan(self, data) -> tuple[str, Optional[int]]:
        """Shared per-chunk front half of :meth:`encode` and
        :meth:`encode_batch`: trainer offer, classification, class
        accounting. Returns ``(cls, level)``; ``level is None`` means the
        store-raw bypass already decided the chunk."""
        n = len(data)
        if self._trainer is not None and self.trained is None:
            self._trainer.offer(data)
        cls = self.classify(data)
        self._count(cls, n)
        PROBE_TOTAL.labels(cls).inc()
        if cls == "bypass":
            BYPASS_BYTES.inc(n)
            return cls, None
        return cls, self.cfg.effective_level(cls)

    def _seal(self, data, cls: str, level: int, payload: bytes) -> tuple[bytes, int]:
        """Shared back half: per-level byte accounting plus the
        late-bypass backstop. A frame that grew past the raw bytes stores
        raw. (The probe already catches ~all of these; this is the
        backstop that makes storing a frame never cost ratio. The
        fallback class skips it — probe failure means always-compress.)"""
        n = len(data)
        LEVEL_BYTES.labels(str(level)).inc(n)
        if len(payload) >= n and n > 0 and cls != "fallback":
            BYPASS_BYTES.inc(n)
            return bytes(data), constants.COMPRESSOR_NONE
        return payload, constants.COMPRESSOR_ZSTD

    def _encode_dict(self, data, cls: str, level: int) -> tuple[bytes, int]:
        """The trained-dictionary frame lane (``nZD1`` header + CDict
        body). Per-chunk by nature: digested CDicts are per-frame zstd
        API, so the batch lane below never routes these."""
        if getattr(self._tls, "st", None) is not None:
            CTX_REUSE.inc()
        st = self._state()
        payload = _TRAINED_HEADER.pack(
            TRAINED_FRAME_MAGIC, self.trained.dict_id
        ) + zstd_native.compress_with_cdict(st.ctx, data, self._handles.cdict(level))
        DICT_BYTES.inc(len(data))
        return self._seal(data, cls, level, payload)

    def encode(self, data) -> tuple[bytes, int]:
        """One chunk → ``(payload, chunk_compressor_flag)``.

        The pipeline's speculative compress workers and the serial
        assembler both call exactly this; determinism in content keeps
        them byte-identical.
        """
        failpoint.hit("compress.encode")
        cls, level = self._plan(data)
        if level is None:
            return bytes(data), constants.COMPRESSOR_NONE
        if self._handles is not None:
            return self._encode_dict(data, cls, level)
        if getattr(self._tls, "st", None) is not None:
            CTX_REUSE.inc()
        st = self._state()
        payload = zstd_native.compress_with_ctx(st.ctx, data, level)
        return self._seal(data, cls, level, payload)

    def encode_batch(self, views, n_threads: int = 1) -> list[tuple[bytes, int]]:
        """Many chunks → ``[(payload, chunk_flag)]``, byte-identical to
        ``[encode(v) for v in views]``.

        Per-chunk probe/class/dictionary decisions stay in Python (pure
        in content and cheap); every chunk that lands on the PLAIN zstd
        lane is then compressed by ONE GIL-released native call per level
        group (``ntpu_encode_batch``: pinned per-thread ``ZSTD_CCtx``s in
        C, frames byte-identical to :func:`zstd.compress_with_ctx` —
        libzstd's one-shot ``ZSTD_compressCCtx`` on both sides). Bypass,
        trained-dict and fallback-class chunks take exactly the per-chunk
        path, as does everything when the native arm is unavailable. The
        batch entry is the future device-codec slot: a GPU/TPU codec
        replaces the native call, not the converter walk.
        """
        failpoint.hit("compress.batch")
        results: list[Optional[tuple[bytes, int]]] = [None] * len(views)
        groups: dict[int, list[int]] = {}
        classes: dict[int, str] = {}
        for i, data in enumerate(views):
            failpoint.hit("compress.encode")
            cls, level = self._plan(data)
            if level is None:
                results[i] = (bytes(data), constants.COMPRESSOR_NONE)
            elif self._handles is not None:
                results[i] = self._encode_dict(data, cls, level)
            else:
                classes[i] = cls
                groups.setdefault(level, []).append(i)
        if not groups:
            return results
        from nydus_snapshotter_tpu_torch.ops import native_cdc

        if not native_cdc.encode_batch_available():
            if getattr(self._tls, "st", None) is not None:
                CTX_REUSE.inc()
            st = self._state()
            for level, idxs in groups.items():
                for i in idxs:
                    payload = zstd_native.compress_with_ctx(st.ctx, views[i], level)
                    results[i] = self._seal(views[i], classes[i], level, payload)
            return results
        for level, idxs in sorted(groups.items()):
            buf, ext = native_cdc.concat_extents([views[i] for i in idxs])
            res = native_cdc.encode_batch_native(buf, ext, level, n_threads)
            if res is None:
                # The library raced away mid-run: per-chunk lane.
                st = self._state()
                for i in idxs:
                    payload = zstd_native.compress_with_ctx(st.ctx, views[i], level)
                    results[i] = self._seal(views[i], classes[i], level, payload)
                continue
            payloads, comp, _digests = res
            BATCH_TOTAL.inc()
            BATCH_CHUNKS.inc(len(idxs))
            for k, i in enumerate(idxs):
                coff, csz = int(comp[k, 0]), int(comp[k, 1])
                results[i] = self._seal(
                    views[i], classes[i], level, payloads[coff : coff + csz].tobytes()
                )
        return results

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        with self._mu:
            out = {
                "counts": dict(self.counts),
                "class_bytes": dict(self.class_bytes),
            }
        out["trained_dict_id"] = self.trained.dict_id if self.trained else 0
        out["trained_epoch"] = self.trained.epoch if self.trained else 0
        if self._trainer is not None:
            out["trainer"] = self._trainer.stats()
        return out
