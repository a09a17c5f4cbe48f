"""On-demand builder for the port's native targets (``native/Makefile``).

The sources live in ``native/<src_subdir>`` and the artifacts in the
git-ignored ``build/bin/``, so a fresh checkout has none; consumers
(``fanotify/server.py`` for optimizer-server) call :func:`ensure_built`
on first use. Discipline, as ``ops/native_cdc.py`` builds the chunk
engine:

- one builder at a time: a file lock in ``build/``, and a second look
  for the artifact once it is held;
- build into a private temporary directory and land with an atomic
  ``os.replace``, so a concurrent process never execs a half-written
  file;
- refuse nothing here: staleness policy is the caller's (a target older
  than its sources is rebuilt below);
- remember build FAILURES on disk keyed on source mtimes, so other
  processes degrade at once instead of each paying again for a doomed
  compile. The marker carries the compiler's stderr after the stamp
  line, so :func:`failure_reason` tells callers WHY the target is
  unbuildable even when this process never ran the compile. Filesystem
  errors after a build leave no memo: the toolchain works, and the next
  process simply tries again.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_BIN_DIR = os.path.join(_BUILD_DIR, "bin")

# Compiler stderr kept in the failure memo: enough for the first errors,
# bounded so a pathological template spew cannot bloat the marker.
_MEMO_STDERR_CAP = 8192


def source_dir(src_subdir: str) -> str:
    """native/<src_subdir>: where a target's sources are."""
    return os.path.join(_NATIVE_DIR, src_subdir)


def src_stamp(src_subdir: str) -> str:
    """Newest source mtime under native/<src_subdir> ('' when unreadable)."""
    src_dir = source_dir(src_subdir)
    try:
        return str(
            max(os.path.getmtime(os.path.join(src_dir, f)) for f in os.listdir(src_dir))
        )
    except (OSError, ValueError):
        return ""


def target_path(target: str) -> str:
    return os.path.join(_BIN_DIR, target)


def _marker_path(target: str) -> str:
    return os.path.join(_BIN_DIR, f".build_failed.{target}")


def sources_newer(target: str, src_subdir: str) -> bool:
    stamp = src_stamp(src_subdir)
    try:
        return bool(stamp) and float(stamp) > os.path.getmtime(target_path(target))
    except OSError:
        return False


def failure_reason(target: str) -> str:
    """The memoized compiler error for ``target`` ('' when there is no
    failure memo). First line of the marker is the source stamp; the rest
    is the captured stderr of the failed compile, possibly from another
    process entirely, which is the point: repeat callers get the WHY
    without paying again for the doomed compile."""
    try:
        with open(_marker_path(target)) as fp:
            memo = fp.read()
    except OSError:
        return ""
    _stamp, _nl, stderr = memo.partition("\n")
    return stderr.strip()


def _current(target: str, src_subdir: str) -> bool:
    return os.path.exists(target_path(target)) and not sources_newer(target, src_subdir)


def ensure_built(target: str, src_subdir: str) -> bool:
    """Build build/bin/<target> if missing or stale. True when the
    artifact is present and current afterwards."""
    if _current(target, src_subdir):
        return True
    marker = _marker_path(target)
    stamp = src_stamp(src_subdir)
    try:
        with open(marker) as fp:
            if fp.read().partition("\n")[0] == stamp:
                return False  # this exact source state already failed
    except OSError:
        pass
    if not shutil.which("make") or not shutil.which("g++"):
        return False
    try:
        os.makedirs(_BIN_DIR, exist_ok=True)
        lock = open(os.path.join(_BUILD_DIR, f".{target}.lock"), "w")
    except OSError:
        return False
    tmp = os.path.join(_BUILD_DIR, f"bin.build.{target}.{os.getpid()}")
    with lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the process dies
        if _current(target, src_subdir):  # another process built it meanwhile
            return True
        try:
            stderr = ""
            try:
                proc = subprocess.run(
                    ["make", "-C", _NATIVE_DIR, f"{tmp}/{target}", f"BIN_DIR={tmp}"],
                    capture_output=True,
                    timeout=120,
                )
                ok = proc.returncode == 0
                if not ok:
                    stderr = proc.stderr.decode("utf-8", "replace")[:_MEMO_STDERR_CAP]
            except (OSError, subprocess.TimeoutExpired) as e:
                ok = False
                stderr = f"{type(e).__name__}: {e}"[:_MEMO_STDERR_CAP]
            if not ok:
                try:
                    with open(marker, "w") as fp:
                        fp.write(stamp + "\n" + stderr)
                except OSError:
                    pass
                return False
            os.replace(os.path.join(tmp, target), target_path(target))
            try:
                os.unlink(marker)
            except OSError:
                pass
            return True
        except OSError:
            return False
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
