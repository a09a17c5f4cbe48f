"""The port's snapshotter stack through containerd's transcripts and a
kill matrix, against the JAX package's: part two.

Every case of tests/test_transcript_killmatrix.py that
tests/test_torch_killmatrix.py does not hold runs here in both packages
(``pkg``, through ``ported_cases``): daemon kills under the restart and
failover policies, dedicated and shared daemons, image pull and removal
loops, usage, the plain OCI fallback and the blob cache's removal. The
twin imports ``_build_image`` from the port twin of
tests/test_daemon_lifecycle.py, and every daemon a port case spawns is
checked to run the port's server. One more case holds the port to a
fix the reference lacks: a daemon killed after a snapshotter restart comes
back with its instances.
"""

from __future__ import annotations

import os
import signal
import threading
import time

import pytest

from tests.test_torch_fetch_sched import other_package_still, port_twin, ported_cases
from tests.test_torch_killmatrix import RESTARTS
from tests.test_torch_snapshotter import short_tmp_path, spawns_own_server

tmp_path = short_tmp_path("kn")
port_twin("test_daemon_lifecycle", host=("pack_layer",))
KILLMATRIX = port_twin("test_transcript_killmatrix", twins=("test_daemon_lifecycle",))
ported_cases("test_transcript_killmatrix", globals(), twins=("test_daemon_lifecycle",), leave_out=RESTARTS)
_other_package_still = other_package_still()
_spawns_own_server = spawns_own_server()


@pytest.mark.parametrize("pkg", ["port"])  # the spawn check: the port's server
def test_restart_then_daemon_kill_respawns_with_instances(tmp_path, pkg, _spawns_own_server):
    """After a snapshotter restart over a live shared daemon, the port's
    ``Manager.recover`` takes the daemon back with its persisted RAFS
    instances, so when that daemon is then SIGKILLed the restart policy
    respawns it and re-mounts them: the container's reads go on. (The
    reference's ``recover`` attaches no instance to a live daemon, and its
    respawned daemon serves none; ROADMAP Queue C.)"""
    from nydus_snapshotter_tpu_torch import constants as C
    from nydus_snapshotter_tpu_torch.daemon.types import DaemonState

    mod = KILLMATRIX
    cfg = mod._mk_cfg(tmp_path)
    boot, blob_dir, files = mod._build_image(tmp_path)
    db, mgr, fs, sn, server, client, _sock = mod._mk_stack(cfg)
    try:
        mod._pull_and_run(client, sn, fs, boot, blob_dir)
        snap_id = fs.instances.list()[0].snapshot_id
        live = fs.get_shared_daemon(C.FS_DRIVER_FUSEDEV)
        pid1 = live.pid
        # the daemon is this process's child; a restarted snapshotter is not
        # its parent: reap it on exit, as init would
        threading.Thread(target=live._proc.wait, daemon=True).start()
    finally:
        client.close()
        server.stop(grace=None)
        sn.close()
        mgr.stop()
    db2, mgr2, fs2, sn2, server2, client2, _sock2 = mod._mk_stack(cfg)
    try:
        d = fs2.get_shared_daemon(C.FS_DRIVER_FUSEDEV)
        assert d.pid == pid1 and [r.snapshot_id for r in d.instances.list()] == [snap_id]
        assert d.client().read_file(f"/{snap_id}", "/app/hello.txt") == files["/app/hello.txt"]
        os.kill(pid1, signal.SIGKILL)
        deadline = time.time() + 60
        while time.time() < deadline:
            d = fs2.get_shared_daemon(C.FS_DRIVER_FUSEDEV)
            if d.pid != pid1 and d.state() == DaemonState.RUNNING:
                break
            time.sleep(0.1)
        else:
            pytest.fail("the restart policy did not respawn the daemon")
        assert [r.snapshot_id for r in fs2.instances.list()] == [snap_id]
        assert [r.snapshot_id for r in d.instances.list()] == [snap_id]
        assert d.pid in _spawns_own_server
        assert d.client().read_file(f"/{snap_id}", "/app/hello.txt") == files["/app/hello.txt"]
    finally:
        client2.close()
        server2.stop(grace=None)
        fs2.teardown()
        sn2.close()
        mgr2.stop()
