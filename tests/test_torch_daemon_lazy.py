"""The port's serving daemon pulling lazily from a registry, against the
JAX package's: reads through the daemon API and the kernel FUSE mount
fetch ranged chunks from the in-process registry, the chunk cache answers
after the registry dies, a dead mirror fails over to the origin, the
cache map survives a daemon restart, and the inflight metrics expose a
stuck read.

Every case of tests/test_lazy_registry_daemon.py runs in both packages
(``pkg``, through ``ported_cases``; the port's ``pack_layer`` on the host,
``device="cpu"``), each spawning its own package's daemon: the port twin
imports the spawner of tests/test_fusedev.py's port twin, which
tests/test_torch_daemon.py checks runs ``nydus_snapshotter_tpu_torch.daemon.server``.
``TestFullStackLazyPull::test_filesystem_mount_supplements_registry_and_reads_lazily``
mounts through each package's ``Filesystem`` and ``Manager``, whose
daemon spawns are checked to run their own package's server; its roots
live under this file's short ``tmp_path``.
"""

from __future__ import annotations

import tests.test_torch_daemon as _daemon_cases  # noqa: F401  (loads the checked spawner first)
from tests.test_torch_fetch_sched import other_package_still, ported_cases
from tests.test_torch_snapshotter import short_tmp_path, spawns_own_server

tmp_path = short_tmp_path("dl")
ported_cases("test_lazy_registry_daemon", globals(), host=("pack_layer",), twins=("test_fusedev",))
_other_package_still = other_package_still()
_spawns_own_server = spawns_own_server()
