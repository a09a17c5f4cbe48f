"""Container file-access tracing via the native fanotify server
(reference pkg/fanotify + tools/optimizer-server)."""

from nydus_snapshotter_tpu_torch.fanotify.server import EventInfo, Server, default_binary_path

__all__ = ["EventInfo", "Server", "default_binary_path"]
