"""Host-side daemon model (reference pkg/daemon/daemon.go:64-662).

Tracks one daemon process: identity, sockets, config, lifecycle state
polling, ref-counted RAFS instance attachment, shared mounts through the
API client, and vestige cleanup after crashes.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from nydus_snapshotter_tpu_torch import constants, failpoint
from nydus_snapshotter_tpu_torch.daemon.client import NydusdClient
from nydus_snapshotter_tpu_torch.daemon.command import DaemonCommand
from nydus_snapshotter_tpu_torch.daemon.types import DaemonState
from nydus_snapshotter_tpu_torch.rafs.rafs import Rafs, RafsCache
from nydus_snapshotter_tpu_torch.utils import errdefs
from nydus_snapshotter_tpu_torch.utils import mount as mount_utils

SHARED_DAEMON_ID = "shared_daemon"


@dataclass
class ConfigState:
    """Persisted daemon identity/config (reference daemon.go ConfigState)."""

    daemon_id: str
    fs_driver: str = constants.FS_DRIVER_FUSEDEV
    daemon_mode: str = constants.DAEMON_MODE_DEDICATED
    api_socket: str = ""
    log_file: str = ""
    workdir: str = ""
    supervisor_path: str = ""
    config_path: str = ""
    process_id: int = 0

    def to_dict(self) -> dict[str, Any]:
        return dict(self.__dict__)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ConfigState":
        return cls(**d)


class Daemon:
    def __init__(self, states: ConfigState):
        self.states = states
        self.instances = RafsCache()
        self._proc: Optional[subprocess.Popen] = None
        self._client: Optional[NydusdClient] = None

    # -- identity -----------------------------------------------------------

    @property
    def id(self) -> str:
        return self.states.daemon_id

    @property
    def pid(self) -> int:
        if self._proc is not None:
            return self._proc.pid
        return self.states.process_id

    def client(self) -> NydusdClient:
        if self._client is None:
            self._client = NydusdClient(self.states.api_socket)
        return self._client

    def is_shared(self) -> bool:
        return self.states.daemon_mode == constants.DAEMON_MODE_SHARED

    # -- process ------------------------------------------------------------

    def command(self, upgrade: bool = False) -> DaemonCommand:
        return DaemonCommand(
            id=self.id,
            apisock=self.states.api_socket,
            supervisor=self.states.supervisor_path,
            workdir=self.states.workdir,
            log_file=self.states.log_file,
            upgrade=upgrade,
        )

    def spawn(self, upgrade: bool = False) -> int:
        failpoint.hit("daemon.spawn")
        argv = self.command(upgrade=upgrade).build()
        # The daemon runs `-m nydus_snapshotter_tpu_torch.daemon.server`; make sure
        # the package root is importable regardless of the caller's cwd.
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        self._proc = subprocess.Popen(
            argv, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env
        )
        self.states.process_id = self._proc.pid
        return self._proc.pid

    def terminate(self) -> None:
        pid = self.pid
        if pid:
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass

    def wait(self, timeout: float = 10.0) -> None:
        if self._proc is not None:
            try:
                self._proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait(timeout=5)
        else:
            deadline = time.time() + timeout
            while time.time() < deadline and _pid_alive(self.states.process_id):
                time.sleep(0.05)

    # -- state machine ------------------------------------------------------

    def state(self) -> DaemonState:
        try:
            info = self.client().get_daemon_info()
            return DaemonState(info.get("state", DaemonState.UNKNOWN.value))
        except (OSError, errdefs.NydusError, ValueError):
            return DaemonState.UNKNOWN

    def wait_until_state(self, want: DaemonState, timeout: float = 30.0) -> None:
        """Poll the API until the daemon reaches `want`
        (reference daemon.go:197-227)."""
        deadline = time.time() + timeout
        last = DaemonState.UNKNOWN
        while time.time() < deadline:
            last = self.state()
            if last == want:
                return
            time.sleep(0.05)
        raise TimeoutError(f"daemon {self.id} stuck in {last.value}, wanted {want.value}")

    def start(self) -> None:
        self.client().start()

    def exit(self) -> None:
        self.client().exit()

    def send_fd(self) -> None:
        self.client().send_fd(self._fd_driver())

    def takeover(self) -> None:
        self.client().takeover(self._fd_driver())

    def _fd_driver(self) -> str:
        return "fscache" if self.states.fs_driver == constants.FS_DRIVER_FSCACHE else "fuse"

    # -- instances ----------------------------------------------------------

    def add_rafs_instance(self, rafs: Rafs) -> None:
        self.instances.add(rafs)

    def remove_rafs_instance(self, snapshot_id: str) -> None:
        self.instances.remove(snapshot_id)

    def ref_count(self) -> int:
        return len(self.instances)

    def shared_mount(self, rafs: Rafs, bootstrap: str, config_json: str) -> None:
        """Attach one RAFS instance to a running daemon via the API
        (reference daemon.go:229-273). The fscache driver's in-kernel
        EROFS attach is the explicit :meth:`shared_erofs_mount` — it
        requires a cachefiles-capable daemon, which the bundled userspace
        daemon is not (it serves FUSE and API reads)."""
        self.client().mount(rafs.relative_mountpoint(), bootstrap, config_json)
        self.add_rafs_instance(rafs)

    def shared_umount(self, rafs: Rafs) -> None:
        self.client().umount(rafs.relative_mountpoint())
        self.remove_rafs_instance(rafs.snapshot_id)

    # Annotation key remembering which blob a snapshot's erofs mount bound,
    # so umount can unbind exactly it.
    _EROFS_BLOB_ANNO = "nydus.erofs.blob_id"

    def shared_erofs_mount(
        self, rafs: Rafs, bootstrap: str, config_json: str, mounter=None
    ) -> None:
        """fscache arm (reference daemon.go:275-324): PUT the blob config
        to the daemon's v2 API (a cachefiles-capable daemon opens the
        kernel session), then mount in-kernel EROFS over fscache at the
        snapshot mountpoint. ``mounter`` injects the mount(2) step for
        tests — kernel fscache support isn't universal.

        This is an EXPLICIT surface for cachefiles-capable daemons: the
        Filesystem facade routes the fscache driver through shared_mount
        (API reads) because the bundled userspace daemon serves FUSE and
        API reads, not cachefiles. Do not mix the two surfaces for one
        instance — their teardowns differ.
        """
        mp = rafs.mountpoint or os.path.join(
            self.states.workdir, "erofs", rafs.snapshot_id
        )
        fscache_id = mount_utils.erofs_fscache_id(rafs.snapshot_id)
        # Carry the bootstrap + fsid in the bind config (the reference's
        # fscache daemon config has metadata_path the same way): a
        # cachefiles-capable daemon then serves the EROFS meta cookie —
        # the fsid mount's first read — not just the data blob cookies.
        try:
            cfg = json.loads(config_json or "{}")
            blob_id = cfg.get("id", "")
            # direct assignment, not setdefault: the cookie keys must
            # match the fsid/bootstrap THIS mount actually uses
            cfg["metadata_path"] = bootstrap
            cfg["fscache_id"] = fscache_id
            config_json = json.dumps(cfg)
        except ValueError:
            blob_id = ""
        self.client().bind_blob(config_json)
        try:
            os.makedirs(mp, exist_ok=True)
            (mounter or mount_utils.erofs_mount)(bootstrap, fscache_id, fscache_id, mp)
        except Exception:
            # roll the bind back: nothing else will ever unbind it
            try:
                self.client().unbind_blob(fscache_id, blob_id)
            except (OSError, errdefs.NydusError):
                pass
            raise
        rafs.mountpoint = mp
        if blob_id:
            rafs.annotations[self._EROFS_BLOB_ANNO] = blob_id
        self.add_rafs_instance(rafs)

    def shared_erofs_umount(self, rafs: Rafs, umounter=None) -> None:
        if rafs.mountpoint:
            (umounter or mount_utils.erofs_umount)(rafs.mountpoint)
        # Mirror the mount-failure rollback (which unbinds unconditionally,
        # tolerating failure): bind_blob was issued at mount time even when
        # the config JSON had no id, so always attempt the unbind — but a
        # server rejecting an empty-id unbind must not block instance
        # removal after the kernel umount already succeeded.
        blob_id = rafs.annotations.pop(self._EROFS_BLOB_ANNO, "")
        try:
            self.client().unbind_blob(
                mount_utils.erofs_fscache_id(rafs.snapshot_id), blob_id
            )
        except (OSError, errdefs.NydusError):
            if blob_id:
                raise  # a real bound blob failing to unbind IS an error
        self.remove_rafs_instance(rafs.snapshot_id)

    def recover_rafs_instances(self, instances: list[Rafs], configs: dict[str, str]) -> None:
        """Replay persisted mounts in seq order after daemon restart
        (reference daemon.go:618-660)."""
        for rafs in sorted(instances, key=lambda r: r.seq):
            bootstrap = rafs.bootstrap_file()
            self.client().mount(
                rafs.relative_mountpoint(), bootstrap, configs.get(rafs.snapshot_id, "")
            )
            self.add_rafs_instance(rafs)

    # -- cleanup ------------------------------------------------------------

    def clear_vestige(self) -> None:
        """Remove leftovers of a dead daemon: stale api socket
        (reference daemon.go:579-605)."""
        sock = self.states.api_socket
        if sock and os.path.exists(sock) and not _pid_alive(self.states.process_id):
            try:
                os.unlink(sock)
            except OSError:
                pass

    def get_daemon_version(self) -> str:
        info = self.client().get_daemon_info()
        version = info.get("version", {})
        return version.get("package_ver", "") if isinstance(version, dict) else str(version)


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
