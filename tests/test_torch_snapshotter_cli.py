"""The port's snapshotter process against the JAX package's, each run as
``python -m <package>.cmd.snapshotter --config <toml>``.

With tarfs on and ``[daemon] accel_backend = "jax"`` the tarfs manager
indexes every layer on the card lane's engine: the port's with
``--device cpu`` (kernel K2's plain version), the reference's on JAX's
CPU backend. One numpy-seeded image (three layers, a whiteout in the top
one) is published with the tarfs hint on an in-process registry, and one
containerd transcript runs over each process's snapshots.v1 socket: the
pull (each layer's Prepare claimed by the tarfs arm, answered
ALREADY_EXISTS), Stat of every chain, the container's Prepare and Mounts
(its files read through the tarfs EROFS mount equal the image's), a Commit of the container, Walk, every Remove and a Cleanup. The replies
(the roots taken out) and status codes are equal, and so are the layers'
``layer.boot`` indexes and the container's merged ``image.boot``. SIGTERM
then ends each process with 0 and leaves its sockets gone.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import grpc
import numpy as np
import pytest

from nydus_snapshotter_tpu_torch import constants as C
from nydus_snapshotter_tpu_torch.api.client import SnapshotsClient
from tests.test_remote import FakeRegistry
from tests.test_tarfs import publish_image
from tests.test_torch_fetch_sched import ROOTS, SIDES
from tests.test_torch_snapshotter import short_tmp_path

REPO = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(
    os.geteuid() != 0 or not os.path.exists("/dev/loop-control"),
    reason="needs root + loop devices for the tarfs container's EROFS mount",
)

tmp_path = short_tmp_path("cli")


def _layers(seed: int) -> list[dict[str, bytes]]:
    rng = np.random.default_rng(seed)
    layers = []
    for i in range(3):
        files = {f"l{i}/": b""}
        for j in range(int(rng.integers(3, 7))):
            # small: on the CPU, K2's plain version digests about 7 KB/s
            files[f"l{i}/f{j}.bin"] = rng.integers(0, 256, int(rng.integers(0, 2500)), dtype=np.uint8).tobytes()
        layers.append(files)
    layers[2]["l0/.wh.f0.bin"] = b""
    return layers


def _config(root: Path, side: str) -> str:
    toml = root / "config.toml"
    toml.write_text(
        f'root = "{root}/r"\naddress = "{root}/grpc.sock"\ndaemon_mode = "none"\n'
        f'[system]\naddress = "{root}/system.sock"\n[metrics]\naddress = ""\n'
        f'[log]\nlog_to_stdout = false\nlog_dir = "{root}/log"\n'
        f'[experimental]\ntarfs_enable = true\ntarfs_mount_on_host = true\n'
        f'[daemon]\naccel_backend = "jax"\n'
    )
    return str(toml)


def _start(side: str, root: Path) -> subprocess.Popen:
    cmd = [sys.executable, "-m", f"{ROOTS[side]}.cmd.snapshotter", "--config", _config(root, side)]
    if side == "port":
        cmd += ["--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if not k.startswith("NTPU_")}
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    deadline = time.time() + 120
    while not os.path.exists(root / "grpc.sock"):
        if proc.poll() is not None or time.time() > deadline:
            proc.kill()
            raise AssertionError(f"{side} snapshotter never served: {proc.communicate()[0].decode()[-3000:]}")
        time.sleep(0.05)
    return proc


def _call(replies: list, name: str, fn, *args):
    try:
        out = fn(*args)
    except grpc.RpcError as e:
        replies.append((name, args, e.code().name))
        return None
    replies.append((name, args, out))
    return out


def _mounts(mounts) -> list:
    """Mounts as (type, source, options), the ``extraoption`` decoded (it
    carries the bootstrap's path under the root)."""
    out = []
    for m in mounts:
        opts = [("extraoption", json.loads(base64.b64decode(o.split("=", 1)[1]))) if o.startswith("extraoption=")
                else o for o in m.options]
        out.append((m.type, m.source, opts))
    return out


def _transcript(client, ref: str, mdigest: str, layer_digests: list[str], root: Path,
                want: dict[str, bytes]) -> tuple[list, dict]:
    replies: list = []
    parent = ""
    chains = []
    for i, ld in enumerate(layer_digests):
        chain = f"sha256:chain-{i}"
        labels = {C.CRI_IMAGE_REF: ref, C.CRI_MANIFEST_DIGEST: mdigest, C.CRI_LAYER_DIGEST: ld,
                  C.CRI_IMAGE_LAYERS: ",".join(layer_digests), C.TARGET_SNAPSHOT_REF: chain}
        _call(replies, "Prepare", client.prepare, f"extract-{i} {chain}", parent, labels)
        info = _call(replies, "Stat", client.stat, chain)
        replies[-1] = ("Stat", chain, (info.name, info.parent, info.kind, sorted(info.labels.items())))
        chains.append(chain)
        parent = chain
    mounts = _call(replies, "Prepare", client.prepare, "ctr", parent, {C.CRI_IMAGE_REF: ref})
    replies[-1] = ("Prepare", "ctr", _mounts(mounts))
    replies.append(("Mounts", "ctr", _mounts(client.mounts("ctr"))))
    # the container reads the image through its overlay's lowest layer: the
    # tarfs EROFS mount on the host
    lower = next(o for o in mounts[0].options if o.startswith("lowerdir=")).split("=", 1)[1].split(":")[-1]
    seen = {str(p.relative_to(lower)): p.read_bytes() for p in Path(lower).rglob("*") if p.is_file()}
    assert seen == want
    boots = {}
    for path in sorted((root / "r").rglob("*.boot")):
        boots[str(path.relative_to(root))] = hashlib.sha256(path.read_bytes()).hexdigest()
    _call(replies, "Commit", client.commit, "sha256:committed", "ctr", {"example.com/k": "v"})
    walk = sorted((i.name, i.parent, i.kind, sorted(i.labels.items())) for i in client.list())
    replies.append(("Walk", walk))
    for key in ["sha256:committed"] + chains[::-1]:
        _call(replies, "Remove", client.remove, key)
    _call(replies, "Cleanup", client.cleanup)
    replies.append(("Walk", [i.name for i in client.list()]))
    text = json.dumps(replies, default=str).replace(str(root), "<root>")
    return json.loads(text), boots


@pytest.mark.parametrize("seed", [0])
def test_cli_tarfs_transcript_equal_on_card_lane(tmp_path, seed):
    reg = FakeRegistry(require_auth=False)
    try:
        mdigest, layer_digests = publish_image(reg, _layers(seed), tarfs_hint="true")
        ref = f"{reg.host}/library/app:latest"
        want = {}
        for files in _layers(seed):
            for name, data in files.items():
                if "/.wh." in name:
                    want.pop(name.replace(".wh.", ""), None)
                elif not name.endswith("/"):
                    want[name] = data
        got = {}
        for side in SIDES:
            root = tmp_path / side[0]
            root.mkdir()
            proc = _start(side, root)
            try:
                client = SnapshotsClient(str(root / "grpc.sock"), timeout=120.0)
                try:
                    got[side] = _transcript(client, ref, mdigest, layer_digests, root, want)
                finally:
                    client.close()
                proc.send_signal(signal.SIGTERM)
                out = proc.communicate(timeout=60)[0].decode()
                assert proc.returncode == 0, out[-3000:]
                assert not os.path.exists(root / "grpc.sock") and not os.path.exists(root / "system.sock")
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        assert got["port"] == got["ref"]
        replies, boots = got["port"]
        codes = [r[2] for r in replies if r[0] == "Prepare" and isinstance(r[2], str)]
        assert codes == ["ALREADY_EXISTS"] * 3
        assert sum(p.endswith("layer.boot") for p in boots) == 3
        assert any(p.endswith("image.boot") for p in boots)
        assert replies[-1] == ["Walk", []]
    finally:
        reg.close()
