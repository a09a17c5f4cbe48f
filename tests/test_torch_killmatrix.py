"""The port's snapshotter stack through containerd's transcripts and a
kill matrix, against the JAX package's: part one, the restarts.

The cases of tests/test_transcript_killmatrix.py run in both packages
(``pkg``, through ``ported_cases``) over the real stack: ``Manager``,
``Filesystem``, ``Snapshotter`` and the gRPC service on a UDS, driven by
``SnapshotsClient``, with real daemons. This file holds the two cases that
restart the snapshotter (over a live daemon, and after both die); the
rest are in tests/test_torch_killmatrix2.py, so that neither file runs
much over two minutes on one xdist worker. The twin imports
``_build_image`` from the port twin of tests/test_daemon_lifecycle.py
(the port's ``pack_layer`` on the host), and every daemon a port case
spawns is checked to run the port's server.
"""

from __future__ import annotations

from tests.test_torch_fetch_sched import other_package_still, port_twin, ported_cases
from tests.test_torch_snapshotter import short_tmp_path, spawns_own_server

RESTARTS = (
    "TestSnapshotterRestartLiveDaemon::test_restart_reconnects_live_daemon",
    "TestKillSnapshotterAndDaemonRecover::test_kill_both_then_recover_from_persisted_state",
)

tmp_path = short_tmp_path("km")
port_twin("test_daemon_lifecycle", host=("pack_layer",))
ported_cases("test_transcript_killmatrix", globals(), twins=("test_daemon_lifecycle",), only=RESTARTS)
_other_package_still = other_package_still()
_spawns_own_server = spawns_own_server()
