"""Global image -> prefetch-file-list map (reference pkg/prefetch/prefetch.go).

Fed by the prefetchfiles NRI plugin through the system controller's
PUT /api/v1/prefetch; consumed as ``--prefetch-files`` when a daemon starts
(daemon_adaptor.go:179-185).
"""

from __future__ import annotations

import json
import threading


class PrefetchManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._map: dict[str, str] = {}

    def set_prefetch_files(self, body: bytes | str) -> None:
        """Parse ``[{"image": ..., "prefetch": ...}, ...]`` (prefetch.go:23-43)."""
        if isinstance(body, (bytes, bytearray)):
            body = body.decode()
        msg = json.loads(body)
        if not isinstance(msg, list):
            raise ValueError("prefetch list must be a JSON array")
        with self._lock:
            for item in msg:
                self._map[item["image"]] = item.get("prefetch", "")

    def get_prefetch_info(self, image: str) -> str:
        with self._lock:
            return self._map.get(image, "")

    def paths_for(self, image: str) -> list[str]:
        """The image's prefetch hint as an ordered replay list for
        :class:`~nydus_snapshotter_tpu_torch.daemon.fetch_sched.PrefetchReplayer`
        (newline- or comma-separated paths, duplicates dropped, order —
        i.e. replay priority — preserved)."""
        info = self.get_prefetch_info(image)
        seen: set[str] = set()
        out: list[str] = []
        for p in info.replace(",", "\n").split("\n"):
            p = p.strip()
            if p and p not in seen:
                seen.add(p)
                out.append(p)
        return out

    def delete(self, image: str) -> None:
        with self._lock:
            self._map.pop(image, None)

    def reset(self) -> None:
        with self._lock:
            self._map.clear()


Pm = PrefetchManager()


def patterns_from_trace(trace_path: str, strip_prefix: str = "") -> str:
    """Turn an optimizer access trace (one accessed path per line, the
    fanotify receiver's persist file) into converter prefetch patterns.

    This closes the reference's optimization loop (optimizer-nri-plugin →
    accessed-file list → ``nydus-image --prefetch-files``,
    docs/optimize_nydus_image.md): feed the result to
    ``PackOption.prefetch_patterns`` / ``MergeOption.prefetch_patterns``.
    Order is preserved (first access first — that IS the prefetch
    priority), duplicates dropped, ``strip_prefix`` removes a container
    rootfs mount prefix so paths are image-relative.
    """
    seen: set[str] = set()
    out: list[str] = []
    with open(trace_path) as f:
        for line in f:
            path = line.strip()
            if not path:
                continue
            if strip_prefix:
                # Path-boundary-aware: "/rootfs" must not mangle "/rootfs2".
                if path == strip_prefix:
                    path = "/"
                elif path.startswith(strip_prefix + "/"):
                    path = path[len(strip_prefix):]
            if not path.startswith("/"):
                path = "/" + path
            if path not in seen:
                seen.add(path)
                out.append(path)
    return "\n".join(out)
