"""The port's prefetch table against the JAX package's: the bootstrap's
prefetch table (order kept, directory patterns expanded, unknown inodes
refused, ``Merge`` carrying the patterns), ``prefetch.patterns_from_trace``
closing the optimizer loop, and ``PrefetchManager``.

Every portable case of tests/test_prefetch_table.py runs in both packages
(``pkg``, through ``ported_cases``; the port's ``pack_layer`` on the
host, ``device="cpu"``), and so does the ``patterns_from_trace`` case of
tests/test_zran.py (``test_strip_prefix_is_path_boundary_aware``).
``TestDaemonWarmup::test_mount_warms_prefetch_and_reports_amount`` spawns
each package's own daemon: the port twin imports the spawner of
tests/test_fusedev.py's port twin, which tests/test_torch_daemon.py checks
runs ``nydus_snapshotter_tpu_torch.daemon.server``.

Cross-package cases: ``patterns_from_trace`` on numpy-seeded traces gives
equal patterns; ``PrefetchManager``'s per-image lists and their JSON
agree; ``PrefetchReplayer.paths_from_trace`` reaches each package's own
``patterns_from_trace``.
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest

import tests.test_torch_daemon as _daemon_cases  # noqa: F401  (loads the checked spawner first)
from tests.test_torch_fetch_sched import ROOTS, SIDES, other_package_still, ported_cases

ported_cases("test_prefetch_table", globals(), host=("pack_layer",), twins=("test_fusedev",))
ported_cases("test_zran", globals(), only=("test_strip_prefix_is_path_boundary_aware",))
_other_package_still = other_package_still()


def _pf(side: str):
    return importlib.import_module(f"{ROOTS[side]}.prefetch.prefetch")


def _trace(seed: int) -> str:
    rng = np.random.default_rng(seed)
    dirs = ["/rootfs/bin", "/rootfs/usr/lib", "/rootfs2/etc", "/other", "/rootfs"]
    lines = []
    for _ in range(120):
        d = dirs[int(rng.integers(0, len(dirs)))]
        lines.append(f"{d}/f{int(rng.integers(0, 40))}" if rng.integers(0, 6) else d)
        if not rng.integers(0, 10):
            lines.append("")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("strip", ["", "/rootfs"])
def test_patterns_from_trace_equal(tmp_path, seed, strip):
    path = tmp_path / "trace"
    path.write_text(_trace(seed))
    assert _pf("ref").patterns_from_trace(str(path), strip_prefix=strip) == _pf(
        "port"
    ).patterns_from_trace(str(path), strip_prefix=strip)


def test_replayer_paths_from_trace_equal(tmp_path):
    path = tmp_path / "trace"
    path.write_text(_trace(9))
    got = {
        side: importlib.import_module(f"{ROOTS[side]}.daemon.fetch_sched").PrefetchReplayer.paths_from_trace(
            str(path), strip_prefix="/rootfs"
        )
        for side in SIDES
    }
    assert got["ref"] == got["port"]
    assert got["port"] == _pf("port").patterns_from_trace(str(path), strip_prefix="/rootfs").split("\n")


def test_prefetch_manager_equal():
    rng = np.random.default_rng(4)
    managers = {side: _pf(side).PrefetchManager() for side in SIDES}
    for _ in range(20):
        items = []
        for _ in range(int(rng.integers(1, 4))):
            files = [f"/f{int(x)}" for x in rng.integers(0, 50, int(rng.integers(0, 6)))]
            sep = ",\n"[int(rng.integers(0, 2))]
            items.append({"image": f"img{int(rng.integers(0, 5))}", "prefetch": sep.join(files)})
        body = json.dumps(items).encode()
        for m in managers.values():
            m.set_prefetch_files(body)
    ref, port = managers["ref"], managers["port"]
    for i in range(6):
        assert ref.get_prefetch_info(f"img{i}") == port.get_prefetch_info(f"img{i}")
        assert ref.paths_for(f"img{i}") == port.paths_for(f"img{i}")
    for m in managers.values():
        with pytest.raises(ValueError):
            m.set_prefetch_files(b"{}")
