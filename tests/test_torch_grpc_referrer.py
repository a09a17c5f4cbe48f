"""The port's snapshotter stack over a referrer-detected image, against
the JAX package's.

``tests/test_grpc_referrer.py`` runs in both packages (``pkg``, through
``ported_cases``): a plain OCI image whose nydus bootstrap is published
as a referrer is detected by the referrer manager, fetched, mounted on
the shared daemon and read through the gRPC service. The twin imports
``_build_image`` from the port twin of tests/test_daemon_lifecycle.py (the
port's ``pack_layer`` on the host), and every daemon a port case spawns is
checked to run the port's server.
"""

from __future__ import annotations

from tests.test_torch_fetch_sched import other_package_still, port_twin, ported_cases
from tests.test_torch_snapshotter import short_tmp_path, spawns_own_server

tmp_path = short_tmp_path("gr")
port_twin("test_daemon_lifecycle", host=("pack_layer",))
ported_cases("test_grpc_referrer", globals(), twins=("test_daemon_lifecycle",))
_other_package_still = other_package_still()
_spawns_own_server = spawns_own_server()
