"""The port's snapshotter control plane under concurrency, and the
containerd wire transcript, against the JAX package's.

Every case of tests/test_snapshot_concurrency.py (the metastore read pool,
the prepare fan-out, the usage and cleanup workers, the ancestor cache,
the ``NTPU_SNAPSHOT_*`` variables) and tests/test_containerd_transcript.py
(a CRI lazy pull, container start and removal over the gRPC service on a
UDS) runs in both packages (``pkg``, through ``ported_cases``). The
storm cases drive tools/snapshot_profile.py's pod storm: the port twin
runs a copy of that tool pointed at the port. The transcript's port twin imports ``FakeFs`` from the port twin of
tests/test_snapshotter.py, whose fake raises the port's errdefs.
"""

from __future__ import annotations

from tests.test_torch_fetch_sched import other_package_still, port_twin, ported_cases
from tests.test_torch_snapshotter import short_tmp_path

tmp_path = short_tmp_path()
port_twin("test_snapshotter")
ported_cases("test_snapshot_concurrency", globals(), tools=("snapshot_profile",))
ported_cases("test_containerd_transcript", globals(), twins=("test_snapshotter",))
_other_package_still = other_package_still()
