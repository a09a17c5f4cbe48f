"""mount.fuse helper: strip nydus-specific overlay options, then mount(2).

Reference cmd/nydus-overlayfs/main.go:38-146. containerd invokes it as::

    nydus-overlayfs overlay <target> -o lowerdir=...,extraoption={...},dev

``extraoption=`` (base64 nydus payload) and ``io.katacontainers.volume=``
are consumed by the runtime, not the kernel — they're filtered out before
the real overlay mount. The syscall goes through libc ``mount(2)`` via
ctypes (the helper runs as root under containerd).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import sys
from dataclasses import dataclass, field

EXTRA_OPTION_KEY = "extraoption="
KATA_VOLUME_OPTION_KEY = "io.katacontainers.volume="

# mount(2) flag values (linux/mount.h), mirroring main.go:66-93's table
MS_RDONLY = 0x1
MS_NOSUID = 0x2
MS_NODEV = 0x4
MS_NOEXEC = 0x8
MS_SYNCHRONOUS = 0x10
MS_REMOUNT = 0x20
MS_MANDLOCK = 0x40
MS_DIRSYNC = 0x80
MS_NOATIME = 0x400
MS_NODIRATIME = 0x800
MS_BIND = 0x1000
MS_REC = 0x4000
MS_RELATIME = 0x200000
MS_STRICTATIME = 0x1000000

# (clear, flag) pairs with containerd mount-option semantics: "dev" CLEARS
# MS_NODEV, "rw" clears MS_RDONLY. The reference helper's table
# (main.go:66-93) ORs the listed bit even for the clearing spellings — a
# latent bug inherited from simplifying containerd's invert table; the
# correct semantics are restored here.
_FLAGS_TABLE = {
    "async": (True, MS_SYNCHRONOUS),
    "atime": (True, MS_NOATIME),
    "bind": (False, MS_BIND),
    "defaults": (False, 0),
    "dev": (True, MS_NODEV),
    "diratime": (True, MS_NODIRATIME),
    "dirsync": (False, MS_DIRSYNC),
    "exec": (True, MS_NOEXEC),
    "mand": (False, MS_MANDLOCK),
    "noatime": (False, MS_NOATIME),
    "nodev": (False, MS_NODEV),
    "nodiratime": (False, MS_NODIRATIME),
    "noexec": (False, MS_NOEXEC),
    "nomand": (True, MS_MANDLOCK),
    "norelatime": (True, MS_RELATIME),
    "nostrictatime": (True, MS_STRICTATIME),
    "nosuid": (False, MS_NOSUID),
    "rbind": (False, MS_BIND | MS_REC),
    "relatime": (False, MS_RELATIME),
    "remount": (False, MS_REMOUNT),
    "ro": (False, MS_RDONLY),
    "rw": (True, MS_RDONLY),
    "strictatime": (False, MS_STRICTATIME),
    "suid": (True, MS_NOSUID),
    "sync": (False, MS_SYNCHRONOUS),
}


@dataclass
class MountArgs:
    fs_type: str
    target: str
    options: list[str] = field(default_factory=list)


def parse_args(args: list[str]) -> MountArgs:
    """main.go parseArgs :38-64 — exactly 4 argv words expected."""
    if len(args) != 4:
        raise ValueError("usage: nydus-overlayfs overlay <target> -o <options>")
    margs = MountArgs(fs_type=args[0], target=args[1])
    if margs.fs_type != "overlay":
        raise ValueError(f"invalid filesystem type {margs.fs_type} for overlayfs")
    if not margs.target:
        raise ValueError("empty overlayfs mount target")
    if args[2] == "-o" and args[3]:
        for opt in args[3].split(","):
            if opt.startswith(EXTRA_OPTION_KEY) or opt.startswith(KATA_VOLUME_OPTION_KEY):
                continue  # filter nydus-specific options
            margs.options.append(opt)
    if not margs.options:
        raise ValueError("empty overlayfs mount options")
    return margs


def parse_options(options: list[str]) -> tuple[int, str]:
    """main.go parseOptions :66-93: split flags vs data string."""
    flags = 0
    data = []
    for opt in options:
        entry = _FLAGS_TABLE.get(opt)
        if entry is not None:
            clear, bit = entry
            if clear:
                flags &= ~bit
            else:
                flags |= bit
        else:
            data.append(opt)
    return flags, ",".join(data)


def _libc_mount(source: str, target: str, fstype: str, flags: int, data: str) -> None:
    libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6", use_errno=True)
    rc = libc.mount(
        source.encode(), target.encode(), fstype.encode(),
        ctypes.c_ulong(flags), data.encode(),
    )
    if rc != 0:
        errno = ctypes.get_errno()
        raise OSError(errno, f"mount overlay at {target}: {os.strerror(errno)}")


def run(args: list[str], mount_fn=_libc_mount) -> None:
    margs = parse_args(args)
    flags, data = parse_options(margs.options)
    mount_fn(margs.fs_type, margs.target, margs.fs_type, flags, data)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        run(argv)
    except (ValueError, OSError) as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
