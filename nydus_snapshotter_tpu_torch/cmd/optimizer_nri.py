"""optimizer NRI plugin: trace container file access for prefetch tuning.

Reference cmd/optimizer-nri-plugin/main.go: on StartContainer, fork the
native fanotify tracer into the container's namespaces and persist the
accessed-file list + CSV under ``<persist_dir>/<repo-dir>/<image:tag>``;
on StopContainer, SIGTERM the tracer.

The containerd NRI transport (ttrpc) is replaced by a line-delimited JSON
event feed on stdin — each line ``{"event": "StartContainer", "container":
{"pid": N, "annotations": {...}}}`` — so the plugin runs under any
supervisor that can relay NRI events (the handlers themselves are
transport-agnostic and unit-tested directly).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from dataclasses import dataclass, field

from nydus_snapshotter_tpu_torch.fanotify import Server, default_binary_path
from nydus_snapshotter_tpu_torch.remote.reference import parse_docker_ref

logger = logging.getLogger("optimizer-nri-plugin")

DEFAULT_EVENTS = "StartContainer,StopContainer"
DEFAULT_PERSIST_DIR = "/opt/nri/optimizer/results"
IMAGE_NAME_LABEL = "io.kubernetes.cri.image-name"


@dataclass
class PluginConfig:
    """main.go:38-47."""

    events: list[str] = field(default_factory=lambda: DEFAULT_EVENTS.split(","))
    server_path: str = ""
    persist_dir: str = DEFAULT_PERSIST_DIR
    readable: bool = False
    timeout: int = 0
    overwrite: bool = False


def get_image_name(annotations: dict) -> tuple[str, str]:
    """(repo dir, image:tag) from the CRI image-name annotation
    (main.go GetImageName :203-217)."""
    ref = annotations.get(IMAGE_NAME_LABEL, "")
    parsed = parse_docker_ref(ref)
    repo = parsed.path
    dirname, _, image = repo.rpartition("/")
    return dirname or ".", f"{image}:{parsed.tag or 'latest'}"


class OptimizerPlugin:
    def __init__(self, config: PluginConfig):
        self.config = config
        self.servers: dict[str, Server] = {}

    @staticmethod
    def _server_key(container: dict, image_name: str) -> str:
        # Key by container id when the runtime provides one: two concurrent
        # containers of the same image must not clobber each other's tracer
        # (the reference keys by image name only, main.go:184, and leaks the
        # first tracer in that case).
        return container.get("id") or image_name

    def start_container(self, container: dict) -> None:
        """main.go StartContainer :161-186."""
        dirname, image_name = get_image_name(container.get("annotations") or {})
        persist_dir = os.path.join(self.config.persist_dir, dirname)
        os.makedirs(persist_dir, exist_ok=True)
        persist_file = os.path.join(persist_dir, image_name)
        if self.config.timeout > 0:
            persist_file = f"{persist_file}.timeout{self.config.timeout}s"
        server = Server(
            binary_path=self.config.server_path or default_binary_path(),
            container_pid=int(container.get("pid") or 0),
            image_name=image_name,
            persist_file=persist_file,
            readable=self.config.readable,
            overwrite=self.config.overwrite,
            timeout=float(self.config.timeout),
        )
        server.run_server()
        self.servers[self._server_key(container, image_name)] = server

    def stop_container(self, container: dict) -> None:
        """main.go StopContainer :188-201."""
        _, image_name = get_image_name(container.get("annotations") or {})
        server = self.servers.pop(self._server_key(container, image_name), None)
        if server is None:
            raise KeyError(
                f"can not find fanotify server for container image {image_name}"
            )
        server.stop_server()

    def on_close(self) -> None:
        for server in self.servers.values():
            server.stop_server()
        self.servers.clear()

    def handle_event(self, event: dict) -> None:
        kind = event.get("event")
        if kind == "StartContainer" and "StartContainer" in self.config.events:
            self.start_container(event.get("container") or {})
        elif kind == "StopContainer" and "StopContainer" in self.config.events:
            self.stop_container(event.get("container") or {})


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="optimizer-nri-plugin")
    p.add_argument("--name", default="optimizer")
    p.add_argument("--idx", default="")
    p.add_argument("--events", default=DEFAULT_EVENTS)
    p.add_argument("--server-path", default="")
    p.add_argument("--persist-dir", default=DEFAULT_PERSIST_DIR)
    p.add_argument("--readable", action="store_true")
    p.add_argument("--timeout", type=int, default=0)
    p.add_argument("--overwrite", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    plugin = OptimizerPlugin(
        PluginConfig(
            events=args.events.split(","),
            server_path=args.server_path,
            persist_dir=args.persist_dir,
            readable=args.readable,
            timeout=args.timeout,
            overwrite=args.overwrite,
        )
    )
    try:
        # readline(), not stdin iteration: the iterator's read-ahead buffer
        # would delay events until EOF on a pipe feed
        for line in iter(sys.stdin.readline, ""):
            line = line.strip()
            if not line:
                continue
            try:
                plugin.handle_event(json.loads(line))
            except Exception as e:
                logger.error("event failed: %s", e)
    finally:
        plugin.on_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
