"""The port's multi-device dry run stays runnable (``entry.dryrun_multichip``).

Mirrors tests/test_graft_entry.py: the dry run runs in a fresh process, as
a driver invokes it, here on a mesh of repeated ``cpu`` devices (the plain
versions of K1, K2 and K3), and must import neither jax nor the reference
package.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = (
    "import sys\n"
    "from nydus_snapshotter_tpu_torch import entry\n"
    "entry.dryrun_multichip({n}, devices=['cpu'] * {n})\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
    "             or m == 'nydus_snapshotter_tpu' or m.startswith('nydus_snapshotter_tpu.'))\n"
    "print('LEAKED', bad)\n"
)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip(n):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _CHILD.format(n=n)],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dryrun_multichip OK" in out.stdout
    if n >= 5:
        assert "overflowed the" in out.stdout  # the forced-overflow phase ran
    else:
        assert "overflow impossible below 5 devices" in out.stdout
    assert "LEAKED []" in out.stdout
