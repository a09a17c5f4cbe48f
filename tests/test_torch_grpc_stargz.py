"""The port's snapshotter stack over lazy-format layers, against the JAX
package's: an eStargz image and a plain gzip layer indexed by soci.

``tests/test_grpc_stargz.py::TestStargzOverGrpc`` (an eStargz image
pulled lazily through the gRPC service: the TOC built into a bootstrap,
merged, mounted on the shared daemon and read) and
``tests/test_soci_backend.py::TestSociOverGrpc::test_plain_gzip_layer_lazy_pull_merge_mount_read``
(a plain gzip layer indexed by the soci adaptor, merged, mounted and read
lazily) run in both packages (``pkg``, through ``ported_cases``); every
daemon a port case spawns is checked to run the port's server. The stargz
case re-runs itself in a fresh interpreter, as the reference's does: its
port arm re-runs this file's node, so the inner process builds the port's
stack too.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys

import pytest

from tests.test_torch_fetch_sched import other_package_still, port_twin, ported_cases
from tests.test_torch_snapshotter import short_tmp_path, spawns_own_server

tmp_path = short_tmp_path("gs")
STARGZ = port_twin("test_grpc_stargz")


def _rerun_port_scenario_isolated(self):
    """The port arm of the scenario's fresh-interpreter re-run: this
    file's node, with the reference's time limit and checks."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    node = f"{os.path.abspath(__file__)}::TestStargzOverGrpc::test_lazy_pull_merge_mount_and_read[port]"
    env = dict(os.environ, NTPU_STARGZ_ISOLATED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", node],
        env=env,
        cwd=repo,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        start_new_session=True,
    )
    try:
        out, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail("isolated stargz grpc scenario wedged (>300s), pgroup killed:\n" + out[-4000:])
    assert proc.returncode == 0, f"isolated stargz grpc scenario failed rc={proc.returncode}:\n" + out[-4000:]
    if " skipped" in out and " passed" not in out:
        pytest.skip("isolated stargz scenario skipped:\n" + out[-600:])


STARGZ.TestStargzOverGrpc._rerun_isolated = _rerun_port_scenario_isolated
ported_cases("test_grpc_stargz", globals())
ported_cases(
    "test_soci_backend",
    globals(),
    only=("TestSociOverGrpc::test_plain_gzip_layer_lazy_pull_merge_mount_read",),
)
_other_package_still = other_package_still()
_spawns_own_server = spawns_own_server()
