"""The port's snapshots service under random walks, against the JAX
package's.

Every case of tests/test_grpc_monkey.py runs in both packages (``pkg``,
through ``ported_cases``): seeded random walks over the gRPC service
checked against a model, nydus image lifecycles on the shared daemon with
reads after each container create, and concurrent walkers that must leave
no residue. The twin imports ``_mk_stack`` from the port twin of
tests/test_transcript_killmatrix.py and ``_build_image`` from that of
tests/test_daemon_lifecycle.py, so each port case builds the port's stack;
every daemon a port case spawns is checked to run the port's server.
"""

from __future__ import annotations

from tests.test_torch_fetch_sched import other_package_still, port_twin, ported_cases
from tests.test_torch_snapshotter import short_tmp_path, spawns_own_server

tmp_path = short_tmp_path("gm")
port_twin("test_daemon_lifecycle", host=("pack_layer",))
port_twin("test_transcript_killmatrix", twins=("test_daemon_lifecycle",))
ported_cases("test_grpc_monkey", globals(), twins=("test_transcript_killmatrix", "test_daemon_lifecycle"))
_other_package_still = other_package_still()
_spawns_own_server = spawns_own_server()
