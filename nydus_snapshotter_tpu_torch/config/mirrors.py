"""Per-registry mirror configuration directories, containerd certs.d style.

Reference config/daemonconfig/mirrors.go:90-259: the operator drops
``<dir>/<registry-host>/hosts.toml`` files (with the same ``host:port`` →
``host_port_`` directory-name mangling containerd uses, and a ``_default``
fallback dir); each ``[host."https://mirror"]`` section carries optional
headers plus the mirror health-check knobs consumed by the daemon's
backend config.
"""

from __future__ import annotations

import os
import urllib.parse

from nydus_snapshotter_tpu_torch.config.daemonconfig import MirrorConfig
from nydus_snapshotter_tpu_torch.utils import errdefs
from nydus_snapshotter_tpu_torch.utils.tomlcompat import tomllib


def host_directory(host: str) -> str:
    """`registry:5000` → `registry_5000_` (mirrors.go:90-97)."""
    idx = host.rfind(":")
    if idx > 0:
        return f"{host[:idx]}_{host[idx + 1:]}_"
    return host


def host_paths(root: str, host: str) -> list[str]:
    """Candidate config dirs, most specific first (mirrors.go:99-108)."""
    paths = []
    mangled = host_directory(host)
    if mangled != host:
        paths.append(os.path.join(root, mangled))
    paths.append(os.path.join(root, host))
    paths.append(os.path.join(root, "_default"))
    return paths


def host_dir_from_root(root: str, host: str) -> str:
    """First existing candidate dir, or "" (mirrors.go:110-119)."""
    for path in host_paths(root, host):
        if os.path.isdir(path):
            return path
    return ""


def _parse_host_config(server: str, config: dict) -> MirrorConfig:
    """One ``[host."..."]`` section → MirrorConfig (mirrors.go:140-179)."""
    if not server.startswith("http"):
        server = "https://" + server
    parsed = urllib.parse.urlsplit(server)
    if not parsed.netloc:
        raise errdefs.InvalidArgument(f"unable to parse mirror server {server!r}")
    headers: dict[str, str] = {}
    for key, value in (config.get("header") or {}).items():
        if isinstance(value, str):
            headers[key] = value
        elif isinstance(value, list):
            headers[key] = ", ".join(str(v) for v in value)
        else:
            raise errdefs.InvalidArgument(
                f"invalid type {type(value).__name__} for header {key!r}"
            )
    return MirrorConfig(
        host=f"{parsed.scheme}://{parsed.netloc}",
        headers=headers,
        health_check_interval=int(config.get("health_check_interval", 5)),
        failure_limit=int(config.get("failure_limit", 5)),
        ping_url=str(config.get("ping_url", "")),
    )


def parse_hosts_file(data: bytes) -> list[MirrorConfig]:
    """hosts.toml → ordered mirror list (mirrors.go:181-219; tomllib keeps
    document order for table keys, matching getSortedHosts)."""
    try:
        tree = tomllib.loads(data.decode())
    except (tomllib.TOMLDecodeError, UnicodeDecodeError) as e:
        raise errdefs.InvalidArgument(f"failed to parse hosts.toml: {e}") from e
    hosts = tree.get("host")
    if not isinstance(hosts, dict):
        raise errdefs.InvalidArgument("invalid `host` tree in hosts.toml")
    return [
        _parse_host_config(server, config or {})
        for server, config in hosts.items()
        if server
    ]


def load_mirrors_config(mirrors_config_dir: str, registry_host: str) -> list[MirrorConfig]:
    """Mirrors for ``registry_host`` from the config dir tree
    (mirrors.go LoadMirrorsConfig :240-259)."""
    if not mirrors_config_dir:
        return []
    host_dir = host_dir_from_root(mirrors_config_dir, registry_host)
    if not host_dir:
        return []
    hosts_file = os.path.join(host_dir, "hosts.toml")
    if not os.path.exists(hosts_file):
        return []
    with open(hosts_file, "rb") as f:
        return parse_hosts_file(f.read())
