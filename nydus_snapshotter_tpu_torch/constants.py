"""Framework-wide constants.

Mirrors the *behavioral* constants of the reference (values surveyed from
the reference's internal/constant/values.go:19-55, pkg/converter/constant.go:9-30,
pkg/label/label.go:17-88) so that images, labels, and configs interoperate.
"""

# ---------------------------------------------------------------------------
# Filesystem drivers (reference internal/constant/values.go:19-30)
# ---------------------------------------------------------------------------
FS_DRIVER_FUSEDEV = "fusedev"
FS_DRIVER_FSCACHE = "fscache"
FS_DRIVER_BLOCKDEV = "blockdev"
FS_DRIVER_NODEV = "nodev"
FS_DRIVER_PROXY = "proxy"

FS_DRIVERS = (
    FS_DRIVER_FUSEDEV,
    FS_DRIVER_FSCACHE,
    FS_DRIVER_BLOCKDEV,
    FS_DRIVER_NODEV,
    FS_DRIVER_PROXY,
)

# Daemon modes (how nydusd-equivalent daemons are shared across images)
DAEMON_MODE_SHARED = "shared"
DAEMON_MODE_DEDICATED = "dedicated"
DAEMON_MODE_NONE = "none"

# Daemon recovery policies (reference config/config.go:77-110)
RECOVER_POLICY_NONE = "none"
RECOVER_POLICY_RESTART = "restart"
RECOVER_POLICY_FAILOVER = "failover"

# ---------------------------------------------------------------------------
# Defaults (reference internal/constant/values.go:32-55)
# ---------------------------------------------------------------------------
DEFAULT_ADDRESS = "/run/containerd-nydus/containerd-nydus-grpc.sock"
DEFAULT_CONFIG_PATH = "/etc/nydus/config.toml"
DEFAULT_ROOT_DIR = "/var/lib/containerd/io.containerd.snapshotter.v1.nydus"
DEFAULT_LOG_LEVEL = "info"
DEFAULT_DAEMON_MODE = DAEMON_MODE_DEDICATED
DEFAULT_FS_DRIVER = FS_DRIVER_FUSEDEV
DEFAULT_GC_PERIOD = "24h"
DEFAULT_METRICS_ADDRESS = ":9110"
DEFAULT_SYSTEM_CONTROLLER_ADDRESS = "/run/containerd-nydus/system.sock"

# The unix(7) sun_path limit that caps root-path length
# (reference config/config.go:50-59 validates root < 70 bytes).
MAX_ROOT_PATH_LEN = 70

# ---------------------------------------------------------------------------
# RAFS / conversion constants (reference pkg/converter/constant.go:9-30)
# ---------------------------------------------------------------------------
MANIFEST_OS_FEATURE_NYDUS = "nydus.remoteimage.v1"
MEDIA_TYPE_NYDUS_CONFIG = "application/vnd.nydus.image.config.v1+json"
MEDIA_TYPE_NYDUS_BLOB = "application/vnd.oci.image.layer.nydus.blob.v1"
BOOTSTRAP_FILE_NAME_IN_LAYER = "image/image.boot"

MANIFEST_NYDUS_CACHE = "containerd.io/snapshot/nydus-cache"

LAYER_ANNOTATION_FS_VERSION = "containerd.io/snapshot/nydus-fs-version"
LAYER_ANNOTATION_NYDUS_BLOB = "containerd.io/snapshot/nydus-blob"
LAYER_ANNOTATION_NYDUS_BLOB_DIGEST = "containerd.io/snapshot/nydus-blob-digest"
LAYER_ANNOTATION_NYDUS_BLOB_SIZE = "containerd.io/snapshot/nydus-blob-size"
LAYER_ANNOTATION_NYDUS_BOOTSTRAP = "containerd.io/snapshot/nydus-bootstrap"
LAYER_ANNOTATION_NYDUS_SOURCE_CHAINID = "containerd.io/snapshot/nydus-source-chainid"
LAYER_ANNOTATION_NYDUS_ENCRYPTED_BLOB = "containerd.io/snapshot/nydus-encrypted-blob"
LAYER_ANNOTATION_NYDUS_SOURCE_DIGEST = "containerd.io/snapshot/nydus-source-digest"
LAYER_ANNOTATION_NYDUS_TARGET_DIGEST = "containerd.io/snapshot/nydus-target-digest"
LAYER_ANNOTATION_NYDUS_REFERENCE_BLOB_IDS = "containerd.io/snapshot/nydus-reference-blob-ids"
LAYER_ANNOTATION_UNCOMPRESSED = "containerd.io/uncompressed"

# ---------------------------------------------------------------------------
# Snapshot labels (reference pkg/label/label.go:17-88)
# ---------------------------------------------------------------------------
# Labels set by containerd / CRI on snapshots.
CRI_IMAGE_REF = "containerd.io/snapshot/cri.image-ref"
CRI_LAYER_DIGEST = "containerd.io/snapshot/cri.layer-digest"
CRI_IMAGE_LAYERS = "containerd.io/snapshot/cri.image-layers"
CRI_MANIFEST_DIGEST = "containerd.io/snapshot/cri.manifest-digest"
TARGET_SNAPSHOT_REF = "containerd.io/snapshot.ref"

# Labels that drive the per-layer processor choice
# (reference snapshot/process.go:26-183).
NYDUS_DATA_LAYER = LAYER_ANNOTATION_NYDUS_BLOB
NYDUS_META_LAYER = LAYER_ANNOTATION_NYDUS_BOOTSTRAP
NYDUS_REF_LAYER = "containerd.io/snapshot/nydus-ref"
NYDUS_SIGNATURE = "containerd.io/snapshot/nydus-signature"
NYDUS_TARFS_LAYER = "containerd.io/snapshot/nydus-tarfs"
NYDUS_PROXY_MODE = "containerd.io/snapshot/nydus-proxy-mode"
OVERLAYFS_VOLATILE_OPT = "containerd.io/snapshot/overlay.volatile"
TARGET_IMAGE_REF = "containerd.io/snapshot/remote/image.reference"
# Dm-verity information for image/layer block devices (label.go:41-44).
NYDUS_IMAGE_BLOCK_INFO = "containerd.io/snapshot/nydus-image-block"
NYDUS_LAYER_BLOCK_INFO = "containerd.io/snapshot/nydus-layer-block"
# Registry pull credentials attached by CRI (label.go:45-48).
NYDUS_IMAGE_PULL_SECRET = "containerd.io/snapshot/pullsecret"
NYDUS_IMAGE_PULL_USERNAME = "containerd.io/snapshot/pullusername"
# Marks a snapshot holding an estargz layer (label.go:54).
STARGZ_LAYER = "containerd.io/snapshot/stargz"
# Marks a snapshot holding a seekable-OCI indexed plain gzip layer
# (soci/adaptor.py — this framework's backend, no reference equivalent).
SOCI_LAYER = "containerd.io/snapshot/ntpu-soci"
# The FormatRouter's backend decision for a soci-claimed layer
# (toc-adopt / seekable-index / zran-index), surfaced on the snapshot so
# tooling can see which lazy path each layer took (soci/router.py).
SOCI_ROUTE = "containerd.io/snapshot/ntpu-soci-route"
# Builder hint that an image should run in tarfs mode (label.go:63-65).
TARFS_HINT = "containerd.io/snapshot/tarfs-hint"

# ---------------------------------------------------------------------------
# Chunking parameters (reference pkg/converter/types.go:76-79 bounds)
# ---------------------------------------------------------------------------
CHUNK_SIZE_MIN = 0x1000  # 4 KiB
CHUNK_SIZE_MAX = 0x1000000  # 16 MiB
CHUNK_SIZE_DEFAULT = 0x100000  # 1 MiB, nydus default

# Compressor flags, bit-compatible with the reference TOC entry flags
# (reference pkg/converter/types.go:26-31).
COMPRESSOR_NONE = 0x0000_0001
COMPRESSOR_ZSTD = 0x0000_0002
COMPRESSOR_LZ4_BLOCK = 0x0000_0004

# zstd level for chunk compression — the SINGLE source: the Python codec
# lane (utils/zstd.py), the converter, and the native fused arms (level
# threaded through the pack ABI's codec-param slot) all read this, so the
# cross-lane byte-identity invariant cannot drift on a level bump.
ZSTD_LEVEL = 3
COMPRESSOR_GZIP = 0x0000_0008  # estargz chunks stay gzip streams in-place
COMPRESSOR_MASK = 0x0000_000F
