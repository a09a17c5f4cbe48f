"""The port's serving daemon against the JAX package's, through the daemon
process: the kernel FUSE mount, byte-for-byte walks, supervisor failover,
the shared-daemon races and prefetch warm-up.

Every case of tests/test_fusedev.py, tests/test_fidelity_e2e.py,
``tests/test_registry_e2e.py::TestConvertFromRegistry`` and
``tests/test_concurrency_stress2.py`` runs in both packages (``pkg``,
through ``ported_cases``; the port's ``pack_layer`` on the host,
``device="cpu"``). The reference files import the daemon spawner from
tests/test_fusedev.py; their port twins import it from that file's port
twin, whose spawner runs ``python -m nydus_snapshotter_tpu_torch.daemon.server``.
Each port spawn is checked: the child's ``/proc/<pid>/cmdline`` names the
port's server module, and the daemon's own ``pid`` answer is the child.
``TestFuseTakeoverStorm`` keeps the reference's ``slow`` mark; its port arm
re-runs itself in a fresh interpreter through this file's node.

The kernel FUSE cases run where this process can mount FUSE (root with
/dev/fuse), under the reference's own skip condition.
"""

from __future__ import annotations

import functools
import os
import signal
import subprocess
import sys

import pytest

from tests.test_torch_fetch_sched import ROOTS, SIDES, other_package_still, port_twin, ported_cases

PORT_SERVER = f"{ROOTS['port']}.daemon.server"


def _cmdline(pid: int) -> list[str]:
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return [a.decode() for a in f.read().split(b"\0") if a]


def _spawns_port_server(mod, name: str) -> None:
    """``mod.<name>`` checked: the child it starts runs the port's server.
    Once per twin: this file also runs again as ``tests.test_torch_daemon``
    when another test file imports it, and the twins are shared."""
    spawn = getattr(mod, name)
    if hasattr(spawn, "__wrapped__"):
        return

    @functools.wraps(spawn)
    def checked(*args, **kw):
        proc, cli = spawn(*args, **kw)
        argv = _cmdline(proc.pid)
        assert argv[1:3] == ["-m", PORT_SERVER], argv
        assert cli.get_daemon_info()["pid"] == proc.pid
        return proc, cli

    setattr(mod, name, checked)


FUSEDEV = port_twin("test_fusedev", host=("pack_layer",))
_spawns_port_server(FUSEDEV, "_spawn_daemon")

ported_cases("test_fusedev", globals(), host=("pack_layer",))
ported_cases("test_fidelity_e2e", globals(), host=("pack_layer",), twins=("test_fusedev",))
ported_cases(
    "test_registry_e2e",
    globals(),
    host=("pack_layer",),
    twins=("test_fusedev",),
    only=("TestConvertFromRegistry::test_pull_convert_read",),
)
STRESS = port_twin("test_concurrency_stress2", twins=("test_fusedev",))
_spawns_port_server(STRESS, "_spawn_nofuse_daemon")


def _rerun_port_storm_isolated(self):
    """The port arm of the storm's fresh-interpreter re-run: this file's
    node, so the inner process runs the port's daemon too."""
    node = (
        f"{os.path.abspath(__file__)}::TestFuseTakeoverStorm::"
        "test_fuse_reads_inflight_across_sigkill_takeover_cycles[port]"
    )
    env = dict(os.environ, NTPU_STORM_ISOLATED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-m", "slow", node],
        env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        start_new_session=True,
    )
    try:
        out, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail("isolated takeover storm wedged (>600s), pgroup killed:\n" + out[-4000:])
    assert proc.returncode == 0, f"isolated takeover storm failed rc={proc.returncode}:\n" + out[-4000:]
    if " skipped" in out and " passed" not in out:
        pytest.skip("isolated takeover storm skipped:\n" + out[-600:])


STRESS.TestFuseTakeoverStorm._rerun_isolated = _rerun_port_storm_isolated
ported_cases("test_concurrency_stress2", globals(), twins=("test_fusedev",))
_other_package_still = other_package_still()


def test_port_twins_share_the_checked_spawner():
    """The port twins that import the spawner got the checked one, so no
    port case can start a daemon that escaped the check."""
    fidelity = sys.modules["tests.test_fidelity_e2e__port"]
    assert STRESS._spawn_daemon is FUSEDEV._spawn_daemon is fidelity._spawn_daemon
    for spawn, mod in ((FUSEDEV._spawn_daemon, FUSEDEV), (STRESS._spawn_nofuse_daemon, STRESS)):
        assert spawn.__wrapped__.__module__ == mod.__name__
        assert not hasattr(spawn.__wrapped__, "__wrapped__")  # checked once


@pytest.mark.parametrize("side", SIDES)
def test_spawner_runs_each_packages_server(tmp_path, side):
    """The reference's spawner runs the reference's server, the twin's the
    port's: same flags, only the module differs."""
    mod = sys.modules["tests.test_fusedev"] if side == "ref" else FUSEDEV
    spawn = getattr(mod._spawn_daemon, "__wrapped__", mod._spawn_daemon)
    proc, cli = spawn(str(tmp_path), f"which-{side}")
    try:
        argv = _cmdline(proc.pid)
        assert argv[1:3] == ["-m", f"{ROOTS[side]}.daemon.server"], argv
        assert argv[3:] == ["--id", f"which-{side}", "--apisock", str(tmp_path / f"which-{side}.sock"),
                            "--workdir", str(tmp_path)]
        assert cli.get_daemon_info()["id"] == f"which-{side}"
    finally:
        proc.terminate()
        proc.wait(timeout=10)
