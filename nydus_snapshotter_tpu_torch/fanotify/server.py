"""Drive the native fanotify tracer and persist its access log.

Reference pkg/fanotify/fanotify.go:38-163 + conn/conn.go: fork the
optimizer-server binary with ``_MNTNS_PID``/``_TARGET`` env (it joins the
container's namespaces itself), read JSON events from its stdout, and write
two artifacts next to each other: the newline-separated accessed-path list
(``PersistFile``) and a ``<PersistFile>.csv`` with path,size,elapsed — the
exact inputs the prefetch table builder consumes.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import signal
import subprocess
import threading
from dataclasses import dataclass
from typing import Optional

from nydus_snapshotter_tpu_torch.utils import display

logger = logging.getLogger(__name__)


@dataclass
class EventInfo:
    path: str
    size: int
    elapsed: int

    @classmethod
    def from_json_line(cls, line: bytes) -> "EventInfo":
        obj = json.loads(line)
        if not isinstance(obj, dict):
            raise ValueError(f"event line is not a JSON object: {obj!r}")
        return cls(path=obj["path"], size=int(obj["size"]), elapsed=int(obj["elapsed"]))


def default_binary_path() -> str:
    """The in-tree native build output, built on demand when missing or
    stale (build artifacts are git-ignored, so a fresh checkout has
    none). utils.native_build gives the atomic-rename + failure-memo
    discipline, so concurrent NRI events never exec a half-written
    binary and a doomed compile is paid once per source state."""
    from nydus_snapshotter_tpu_torch.utils import native_build

    native_build.ensure_built("optimizer-server", "optimizer_server")
    return native_build.target_path("optimizer-server")


class Server:
    def __init__(
        self,
        binary_path: str,
        container_pid: int,
        image_name: str,
        persist_file: str,
        readable: bool = False,
        overwrite: bool = True,
        timeout: float = 0.0,
        target: str = "/",
    ):
        self.binary_path = binary_path or default_binary_path()
        self.container_pid = container_pid
        self.image_name = image_name
        self.persist_file = persist_file
        self.readable = readable
        self.overwrite = overwrite
        self.timeout = timeout
        self.target = target
        self.proc: Optional[subprocess.Popen] = None
        self._receiver: Optional[threading.Thread] = None
        self._timer: Optional[threading.Timer] = None

    def run_server(self) -> None:
        """fanotify.go RunServer :52-101."""
        if not self.overwrite and os.path.isfile(self.persist_file):
            return
        env = {
            "_MNTNS_PID": str(self.container_pid) if self.container_pid else "",
            "_TARGET": self.target,
        }
        self.proc = subprocess.Popen(
            [self.binary_path],
            env=env,
            stdout=subprocess.PIPE,
            stderr=None if logger.isEnabledFor(logging.DEBUG) else subprocess.DEVNULL,
            start_new_session=True,  # Setpgid: SIGTERM the whole group
        )
        self._receiver = threading.Thread(
            target=self._run_receiver, daemon=True,
            name=f"fanotify-recv-{self.image_name}",
        )
        self._receiver.start()
        if self.timeout > 0:
            self._timer = threading.Timer(self.timeout, self.stop_server)
            self._timer.start()

    def _run_receiver(self) -> None:
        """fanotify.go RunReceiver :103-150: path list + CSV side by side."""
        assert self.proc is not None and self.proc.stdout is not None
        os.makedirs(os.path.dirname(self.persist_file) or ".", exist_ok=True)
        with open(self.persist_file, "w") as f, open(
            f"{self.persist_file}.csv", "w", newline=""
        ) as fcsv:
            writer = csv.writer(fcsv)
            writer.writerow(["path", "size", "elapsed"])
            fcsv.flush()
            for line in self.proc.stdout:
                try:
                    info = EventInfo.from_json_line(line)
                except (ValueError, KeyError, TypeError) as e:
                    logger.warning("bad event line %r: %s", line, e)
                    continue
                print(info.path, file=f)
                f.flush()
                if self.readable:
                    row = [
                        info.path,
                        display.byte_to_readable_iec(info.size),
                        display.microsecond_to_readable(info.elapsed),
                    ]
                else:
                    row = [info.path, str(info.size), str(info.elapsed)]
                writer.writerow(row)
                fcsv.flush()
        logger.info("fanotify receiver for %s done", self.image_name)

    def stop_server(self) -> None:
        """SIGTERM the process group, reap (fanotify.go :152-163)."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self.proc is None:
            return
        try:
            os.killpg(self.proc.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            logger.error("fanotify server %d did not exit, killing", self.proc.pid)
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        if self._receiver is not None:
            self._receiver.join(timeout=5)
        self.proc = None  # a recycled pid must never be re-signalled
