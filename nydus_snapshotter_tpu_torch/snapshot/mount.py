"""Mount-slice synthesis.

Reference snapshot/snapshot.go:825-985 (bind/overlay/proxy/remote mounts)
and snapshot/mount_option.go (``extraoption=`` base64 payloads, Kata
virtual-volume encoding with its 8 volume types, dm-verity validation).
"""

from __future__ import annotations

import base64
import json
import re
from dataclasses import dataclass, field
from typing import Mapping, Optional

from nydus_snapshotter_tpu_torch import constants as C
from nydus_snapshotter_tpu_torch.utils import errdefs

KATA_VOLUME_DEFAULT_SOURCE = "overlay"
KATA_VOLUME_DUMMY_SOURCE = "dummy-image-reference"
KATA_VOLUME_OPTION_NAME = "io.katacontainers.volume"

# Kata virtual volume types (mount_option.go:310-320)
KATA_DIRECT_BLOCK = "direct_block"
KATA_IMAGE_RAW_BLOCK = "image_raw_block"
KATA_LAYER_RAW_BLOCK = "layer_raw_block"
KATA_IMAGE_NYDUS_BLOCK = "image_nydus_block"
KATA_LAYER_NYDUS_BLOCK = "layer_nydus_block"
KATA_IMAGE_NYDUS_FS = "image_nydus_fs"
KATA_LAYER_NYDUS_FS = "layer_nydus_fs"
KATA_IMAGE_GUEST_PULL = "image_guest_pull"

_KATA_VOLUME_TYPES = (
    KATA_DIRECT_BLOCK,
    KATA_IMAGE_RAW_BLOCK,
    KATA_LAYER_RAW_BLOCK,
    KATA_IMAGE_NYDUS_BLOCK,
    KATA_LAYER_NYDUS_BLOCK,
    KATA_IMAGE_NYDUS_FS,
    KATA_LAYER_NYDUS_FS,
    KATA_IMAGE_GUEST_PULL,
)

_MIN_BLOCK_SIZE = 1 << 9
_MAX_BLOCK_SIZE = 1 << 19


@dataclass
class Mount:
    """One containerd mount entry (type/source/options)."""

    type: str
    source: str
    options: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"type": self.type, "source": self.source, "options": list(self.options)}


def bind_mount(source: str, ro_flag: str) -> list[Mount]:
    return [Mount(type="bind", source=source, options=[ro_flag, "rbind"])]


def overlay_mount(options: list[str]) -> list[Mount]:
    return [Mount(type="overlay", source="overlay", options=list(options))]


@dataclass
class ExtraOption:
    """The ``extraoption=`` payload consumed by the nydus-overlayfs mount
    helper (mount_option.go:35-40): bootstrap path, full daemon config,
    snapshot dir, and RAFS version."""

    source: str
    config: str
    snapshotdir: str
    fs_version: str

    def encode(self) -> str:
        payload = json.dumps(
            {
                "source": self.source,
                "config": self.config,
                "snapshotdir": self.snapshotdir,
                "fs_version": self.fs_version,
            }
        )
        return "extraoption=" + base64.b64encode(payload.encode()).decode()

    @classmethod
    def decode(cls, option: str) -> "ExtraOption":
        if not option.startswith("extraoption="):
            raise errdefs.InvalidArgument("not an extraoption mount option")
        d = json.loads(base64.b64decode(option[len("extraoption=") :]))
        return cls(
            source=d["source"],
            config=d["config"],
            snapshotdir=d["snapshotdir"],
            fs_version=d["fs_version"],
        )


def _validate_block_size(size: int) -> bool:
    return _MIN_BLOCK_SIZE <= size <= _MAX_BLOCK_SIZE and (size & (size - 1)) == 0


@dataclass
class DmVerityInfo:
    """Dm-verity configuration (mount_option.go:326-420)."""

    hashtype: str = "sha256"
    hash: str = ""
    blocknum: int = 0
    blocksize: int = 512
    hashsize: int = 4096
    offset: int = 0

    def validate(self) -> None:
        ht = self.hashtype.lower()
        want_len = {"sha256": 64, "sha1": 40}.get(ht)
        if want_len is None:
            raise errdefs.InvalidArgument(f"unsupported dm-verity hash algorithm {self.hashtype}")
        if len(self.hash) != want_len or not re.fullmatch(r"[0-9a-fA-F]+", self.hash or "x"):
            raise errdefs.InvalidArgument(f"invalid {ht} hash {self.hash!r}")
        if self.blocknum == 0 or self.blocknum > 0xFFFFFFFF:
            raise errdefs.InvalidArgument(f"zero block count for dm-verity device {self.hash}")
        if not _validate_block_size(self.blocksize) or not _validate_block_size(self.hashsize):
            raise errdefs.InvalidArgument(
                f"unsupported verity block size: data={self.blocksize} hash={self.hashsize}"
            )
        if self.offset % self.hashsize != 0 or self.offset < self.blocksize * self.blocknum:
            raise errdefs.InvalidArgument(
                f"invalid hash offset {self.offset} for dm-verity device {self.hash}"
            )

    def to_dict(self) -> dict:
        return {
            "hashtype": self.hashtype,
            "hash": self.hash,
            "blocknum": self.blocknum,
            "blocksize": self.blocksize,
            "hashsize": self.hashsize,
            "offset": self.offset,
        }


def parse_tarfs_dm_verity(info: str) -> DmVerityInfo:
    """Parse the `"<datablocks>,<hashoffset>,sha256:<roothash>"` string the
    tarfs exporter emits (mount_option.go:281-303)."""
    m = re.fullmatch(r"(\d+),(\d+),sha256:([0-9a-fA-F]+)", info.strip())
    if not m:
        raise errdefs.InvalidArgument(f"invalid dm-verity information: {info!r}")
    di = DmVerityInfo(
        hashtype="sha256",
        hash=m.group(3),
        blocknum=int(m.group(1)),
        blocksize=512,
        hashsize=4096,
        offset=int(m.group(2)),
    )
    di.validate()
    return di


@dataclass
class ImagePullVolume:
    metadata: dict[str, str] = field(default_factory=dict)


@dataclass
class NydusImageVolume:
    config: str = ""
    snapshot_dir: str = ""


@dataclass
class KataVirtualVolume:
    """Kata virtual-volume descriptor passed through mount options
    (mount_option.go:422-476)."""

    volume_type: str
    source: str = ""
    fs_type: str = ""
    options: list[str] = field(default_factory=list)
    dm_verity: Optional[DmVerityInfo] = None
    image_pull: Optional[ImagePullVolume] = None
    nydus_image: Optional[NydusImageVolume] = None

    def validate(self) -> bool:
        if self.volume_type not in _KATA_VOLUME_TYPES:
            return False
        if self.volume_type in (
            KATA_DIRECT_BLOCK,
            KATA_IMAGE_RAW_BLOCK,
            KATA_LAYER_RAW_BLOCK,
        ):
            if not self.source:
                return False
            if self.dm_verity is not None:
                try:
                    self.dm_verity.validate()
                except errdefs.InvalidArgument:
                    return False
            return True
        if self.volume_type in (KATA_IMAGE_NYDUS_BLOCK, KATA_LAYER_NYDUS_BLOCK):
            return bool(self.source) and self.nydus_image is not None
        if self.volume_type in (KATA_IMAGE_NYDUS_FS, KATA_LAYER_NYDUS_FS):
            return bool(self.source)
        if self.volume_type == KATA_IMAGE_GUEST_PULL:
            return self.image_pull is not None
        return False

    def to_dict(self) -> dict:
        d: dict = {"volume_type": self.volume_type, "source": self.source}
        if self.fs_type:
            d["fs_type"] = self.fs_type
        if self.options:
            d["options"] = list(self.options)
        if self.dm_verity is not None:
            d["dm_verity"] = self.dm_verity.to_dict()
        if self.image_pull is not None:
            d["image_pull"] = {"metadata": dict(self.image_pull.metadata)}
        if self.nydus_image is not None:
            d["nydus_image"] = {
                "config": self.nydus_image.config,
                "snapshot_dir": self.nydus_image.snapshot_dir,
            }
        return d

    def encode_option(self) -> str:
        if not self.validate():
            raise errdefs.InvalidArgument(f"invalid kata volume {self.to_dict()}")
        b64 = base64.b64encode(json.dumps(self.to_dict()).encode()).decode()
        return f"{KATA_VOLUME_OPTION_NAME}={b64}"

    @classmethod
    def decode_option(cls, option: str) -> "KataVirtualVolume":
        prefix = KATA_VOLUME_OPTION_NAME + "="
        if not option.startswith(prefix):
            raise errdefs.InvalidArgument("not a kata volume mount option")
        d = json.loads(base64.b64decode(option[len(prefix) :]))
        vol = cls(
            volume_type=d["volume_type"],
            source=d.get("source", ""),
            fs_type=d.get("fs_type", ""),
            options=list(d.get("options", [])),
        )
        if "dm_verity" in d:
            vol.dm_verity = DmVerityInfo(**d["dm_verity"])
        if "image_pull" in d:
            vol.image_pull = ImagePullVolume(metadata=dict(d["image_pull"].get("metadata", {})))
        if "nydus_image" in d:
            vol.nydus_image = NydusImageVolume(
                config=d["nydus_image"].get("config", ""),
                snapshot_dir=d["nydus_image"].get("snapshot_dir", ""),
            )
        return vol


def prepare_kata_virtual_volume(
    block_type: str,
    source: str,
    volume_type: str,
    fs_type: str,
    options: list[str],
    labels: Mapping[str, str],
) -> str:
    """Build the encoded kata-volume option for a block/proxy mount
    (mount_option.go:250-279)."""
    vol = KataVirtualVolume(
        volume_type=volume_type, source=source, fs_type=fs_type, options=list(options)
    )
    if block_type in (C.NYDUS_IMAGE_BLOCK_INFO, C.NYDUS_LAYER_BLOCK_INFO):
        info = labels.get(block_type, "")
        if info:
            vol.dm_verity = parse_tarfs_dm_verity(info)
    elif block_type == C.NYDUS_PROXY_MODE:
        vol.image_pull = ImagePullVolume(metadata=dict(labels))
    return vol.encode_option()
