"""Build-time version info (reference version/version.go)."""

VERSION = "0.1.0"
REVISION = "unknown"
PACKAGE = "nydus-snapshotter-tpu"


def pretty() -> str:
    return f"{PACKAGE} {VERSION} ({REVISION})"
