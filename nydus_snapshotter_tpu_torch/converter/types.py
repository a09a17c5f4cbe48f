"""Converter option surface — semantic parity with reference types.go:58-145.

A copy of the reference package's ``PackOption``, ``MergeOption``,
``UnpackOption`` and ``ConvertError``, with their defaults;
converter/pack.py states which option values this package's ``Pack``
refuses."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.models import layout


class ConvertError(RuntimeError):
    pass


@dataclass
class PackOption:
    """Options for packing one OCI layer tar into a nydus blob.

    Field semantics follow reference PackOption (pkg/converter/types.go:58-90);
    fields that configured the external builder binary are replaced by engine
    selection knobs (``backend``, ``chunking``). The fields the reference's
    ``pack_layer`` never reads (work_dir, oci_ref, timeout) are left out.
    """

    fs_version: str = layout.RAFS_V6
    chunk_dict_path: str = ""
    prefetch_patterns: str = ""
    # lz4_block, the reference's default (the legacy v5 blob default;
    # modern nydus-image defaults to zstd). Chunks compress on the host
    # through the system liblz4/libzstd (utils/lz4.py, utils/zstd.py).
    compressor: str = "lz4_block"  # "none" | "zstd" | "lz4_block"
    # LZ4 acceleration (liblz4 LZ4_compress_fast): 1 = default-codec
    # output (max ratio); each step up trades ratio for speed.
    # Deterministic for a fixed value.
    lz4_acceleration: int = 1
    aligned_chunk: bool = False
    chunk_size: int = constants.CHUNK_SIZE_DEFAULT
    batch_size: int = 0
    encrypt: bool = False
    # Engine selection, with the reference's value names: fused = the device full path (ops/fused_convert, the default
    # here); jax = the windowed device lane (ops/chunker.ChunkDigestEngine,
    # on CUDA in this package); hybrid = the native chunk engine's host lane
    # (ops/native_cdc: SIMD cuts with SHA-NI or BLAKE3 digests in one pass,
    # no device); numpy = the host differential path (numpy CDC, host
    # digests).
    backend: str = "fused"
    chunking: str = "cdc"  # "cdc" | "fixed"
    # "" = engine default for the backend; "jax" routes chunk digests
    # through the device digester (K2, or K4 for BLAKE3) while boundaries
    # stay with the backend; "host" digests on the host where the
    # reference does (converter/pack.py).
    digest_backend: str = ""
    # Chunk-digest algorithm (reference `nydus-image --digester`,
    # RafsSuperFlags 0x4 blake3 / 0x8 sha256): it changes the chunk digests
    # in the bootstrap and nothing else. The fused and jax lanes digest
    # either on the card; the hybrid and numpy lanes on the native host arm.
    # The blob ID stays sha256 (OCI convention).
    digester: str = "sha256"

    def validate(self) -> None:
        if self.fs_version not in (layout.RAFS_V5, layout.RAFS_V6):
            raise ConvertError(f"invalid fs version {self.fs_version!r}")
        if self.compressor not in ("none", "zstd", "lz4_block"):
            raise ConvertError(f"unsupported compressor {self.compressor!r}")
        if not 1 <= self.lz4_acceleration <= 65537:
            raise ConvertError(
                f"lz4 acceleration {self.lz4_acceleration} out of range [1, 65537]"
            )
        cs = self.chunk_size
        if cs & (cs - 1) or not (constants.CHUNK_SIZE_MIN <= cs <= constants.CHUNK_SIZE_MAX):
            raise ConvertError(
                f"chunk size must be power of two in "
                f"[{constants.CHUNK_SIZE_MIN:#x}, {constants.CHUNK_SIZE_MAX:#x}]"
            )
        if self.digest_backend not in ("", "host", "jax"):
            raise ConvertError(
                f"unsupported digest backend {self.digest_backend!r}"
            )
        if self.digester not in ("sha256", "blake3"):
            raise ConvertError(f"unsupported digester {self.digester!r}")
        bs = self.batch_size
        # Reference bound (types.go:78-79): power of two in 0x1000-0x1000000
        # or zero (disabled).
        if bs and (
            bs & (bs - 1) or not (constants.CHUNK_SIZE_MIN <= bs <= constants.CHUNK_SIZE_MAX)
        ):
            raise ConvertError(
                f"batch size must be zero or a power of two in "
                f"[{constants.CHUNK_SIZE_MIN:#x}, {constants.CHUNK_SIZE_MAX:#x}]"
            )


@dataclass
class MergeOption:
    """Options for merging layer bootstraps into an image bootstrap
    (reference types.go:92-133)."""

    work_dir: str = ""
    # Empty = inherit the version of the top layer (explicit value overrides).
    fs_version: str = ""
    chunk_dict_path: str = ""
    parent_bootstrap_path: str = ""
    prefetch_patterns: str = ""
    with_tar: bool = False
    oci: bool = False
    oci_ref: bool = False
    with_referrer: bool = False
    timeout: Optional[float] = None
    # "native" (this package's format), or the reference toolchain's
    # real on-disk layouts: "rafs-v5" / "rafs-v6" (models/nydus_real_write).
    bootstrap_format: str = "native"
    # Inode-digest algorithm when emitting a real layout ("blake3" is the
    # toolchain default; use the same algorithm the layers' CHUNK digests
    # were packed with — PackOption.digester — for a coherent image).
    digester: str = "sha256"


@dataclass
class UnpackOption:
    """Options for unpacking a nydus blob back to an OCI tar
    (reference types.go:135-145)."""

    work_dir: str = ""
    timeout: Optional[float] = None
    stream: bool = False
