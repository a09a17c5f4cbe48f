"""The PyTorch port's multi-host rendezvous against the JAX package's.

Mirrors tests/test_multihost_dcn.py: two localhost processes join a real
gloo process group through ``multihost.runtime`` (the port's counterpart
of ``jax.distributed``), split a batch of images, convert each slice, and
the union must equal one-process conversions by both packages bit for bit
(blob ids are content digests). The group is process-wide, so it lives in
child processes only, each bounded by a wall timeout and killed as a
process group past it.
"""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import tarfile

import numpy as np
import pytest

from nydus_snapshotter_tpu.converter.convert import pack_layer as j_pack_layer
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu_torch.converter import PackOption, pack_layer
from nydus_snapshotter_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALL_S = 300  # per child: covers a starved interpreter start, not the join

_IMAGE = r"""
def image_tar(i):
    rng = np.random.default_rng(1000 + i)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        for f in range(4):
            size = int(rng.integers(1000, 120_000))
            ti = tarfile.TarInfo(f"img{i}/f{f}")
            ti.size = size
            tf.addfile(ti, io.BytesIO(rng.integers(0, 256, size, dtype=np.uint8).tobytes()))
    return buf.getvalue()
"""

_CHILD = r"""
import io, json, os, sys, tarfile
sys.path.insert(0, os.environ["NTPU_REPO"])
import numpy as np
from nydus_snapshotter_tpu_torch.parallel import multihost
from nydus_snapshotter_tpu_torch.converter import PackOption, pack_layer
""" + _IMAGE + r"""
rt = multihost.runtime(
    coordinator=os.environ["COORD"],
    process_id=int(os.environ["PID_IDX"]),
    num_processes=2,
    init_timeout_s=60,
)
assert rt.count == 2, f"expected 2 joined processes, got {rt.count}"
assert rt.index == int(os.environ["PID_IDX"])
out = {}
for i in rt.shard(list(range(int(os.environ["N_IMAGES"])))):
    _blob, res = pack_layer(image_tar(i), PackOption(chunk_size=0x10000, backend="hybrid"))
    out[i] = res.blob_id
rt.barrier("packed")
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "nydus_snapshotter_tpu" or m.startswith("nydus_snapshotter_tpu."))
with open(os.environ["RESULT_PATH"] + ".tmp", "w") as f:
    json.dump({"index": rt.index, "count": rt.count, "blobs": out, "leaked": bad}, f)
os.rename(os.environ["RESULT_PATH"] + ".tmp", os.environ["RESULT_PATH"])
"""

_DICT_CHILD = r"""
import io, json, os, sys, tarfile
sys.path.insert(0, os.environ["NTPU_REPO"])
import numpy as np
from nydus_snapshotter_tpu_torch.parallel import multihost
from nydus_snapshotter_tpu_torch.converter import Merge, MergeOption, PackOption, pack_layer
from nydus_snapshotter_tpu_torch.converter.convert import bootstrap_from_layer_blob
from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap, ChunkDict

rt = multihost.runtime(
    coordinator=os.environ["COORD"],
    process_id=int(os.environ["PID_IDX"]),
    num_processes=2,
    init_timeout_s=60,
)
share = os.environ["SHARE_DIR"]  # the storage boundary (registry stand-in)
opt = PackOption(chunk_size=0x10000, backend="hybrid")


def result(payload):
    path = os.environ["RESULT_PATH"]
    with open(path + ".tmp", "w") as f:
        json.dump(payload, f)
    os.rename(path + ".tmp", path)


def image_tar(seed, pool):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        for f in range(5):
            data = pool[rng.integers(0, len(pool))]
            ti = tarfile.TarInfo(f"app/f{seed}-{f}")
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


prng = np.random.default_rng(777)  # a shared content pool: cross-host overlap
pool = [prng.integers(0, 256, 60_000, dtype=np.uint8).tobytes() for _ in range(8)]
if rt.index == 0:
    # Host 0 converts the base image and publishes its merged bootstrap as
    # the fleet's chunk-dict artifact.
    blob, res = pack_layer(image_tar(1, pool), opt)
    merged = Merge([blob], MergeOption(with_tar=False))
    with open(os.path.join(share, "dict.boot.tmp"), "wb") as f:
        f.write(merged.bootstrap)
    os.rename(os.path.join(share, "dict.boot.tmp"), os.path.join(share, "dict.boot"))
    rt.barrier("dict-published")
    result({"index": 0, "dict_chunks": len(ChunkDict(Bootstrap.from_bytes(merged.bootstrap))),
            "bootstrap": merged.bootstrap.hex()})
else:
    rt.barrier("dict-published")  # wait for host 0's artifact
    cdict = ChunkDict.from_path(os.path.join(share, "dict.boot"))
    blob, res = pack_layer(image_tar(2, pool), opt, chunk_dict=cdict)
    bs = bootstrap_from_layer_blob(blob)
    foreign = sum(c.uncompressed_size for c in bs.chunks
                  if bs.blobs[c.blob_index].blob_id != res.blob_id)
    result({
        "index": 1, "dedup_bytes": foreign,
        "total_bytes": sum(c.uncompressed_size for c in bs.chunks),
        "referenced": sorted({bs.blobs[c.blob_index].blob_id for c in bs.chunks}),
        "own": res.blob_id, "blob": blob.hex(),
    })
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(child: str, tmp_path, **env_extra) -> dict[int, dict]:
    """Two children joined at one coordinator; their result files."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(NTPU_REPO=REPO, COORD=f"127.0.0.1:{_free_port()}", **env_extra)
    procs, paths = [], []
    for idx in range(2):
        path = str(tmp_path / f"result{idx}.json")
        paths.append(path)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", child], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env={**env, "PID_IDX": str(idx), "RESULT_PATH": path}, cwd=REPO,
            start_new_session=True,
        ))
    results = {}
    try:
        for p, path in zip(procs, paths):
            out, err = p.communicate(timeout=WALL_S)
            assert p.returncode == 0, (out[-500:], err[-2000:])
            with open(path) as f:
                r = json.load(f)
            results[r["index"]] = r
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    return results


def _image_tar(i: int) -> bytes:
    ns: dict = {"np": np, "io": io, "tarfile": tarfile}
    exec(_IMAGE, ns)
    return ns["image_tar"](i)


def test_two_process_group_splits_the_batch(tmp_path):
    n_images = 6
    results = _run_pair(_CHILD, tmp_path, N_IMAGES=str(n_images))
    assert set(results) == {0, 1}
    assert all(r["count"] == 2 and r["leaked"] == [] for r in results.values())
    blobs = {i: {int(k): v for k, v in r["blobs"].items()} for i, r in results.items()}
    # a disjoint, complete strided partition
    assert set(blobs[0]) == {0, 2, 4} and set(blobs[1]) == {1, 3, 5}
    merged = {**blobs[0], **blobs[1]}
    for i in range(n_images):
        tar = _image_tar(i)
        _b, res = pack_layer(tar, PackOption(chunk_size=0x10000, backend="hybrid"))
        _jb, jres = j_pack_layer(tar, JPackOption(chunk_size=0x10000))
        assert merged[i] == res.blob_id == jres.blob_id, f"image {i} diverged across the fleet"


def test_genuine_join_failure_never_degrades():
    """An unreachable coordinator raises: it never degrades to a (0, 1)
    singleton that would re-convert the whole image list."""
    child = (
        "import os, sys; sys.path.insert(0, os.environ['NTPU_REPO'])\n"
        "from nydus_snapshotter_tpu_torch.parallel import multihost\n"
        "try:\n"
        "    multihost.runtime(coordinator='127.0.0.1:1', process_id=1, num_processes=2, init_timeout_s=5)\n"
        "except Exception as e:\n"
        "    print('RAISED', type(e).__name__); raise SystemExit(17)\n"
        "print('DEGRADED'); raise SystemExit(0)\n"
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", child], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "NTPU_REPO": REPO}, cwd=REPO, start_new_session=True,
    )
    try:
        stdout, stderr = proc.communicate(timeout=WALL_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        pytest.fail("join-failure child wedged past its wall (process group killed):\n" + stderr[-800:])
    assert "DEGRADED" not in stdout, stdout
    assert proc.returncode == 17 and "RAISED" in stdout, (stdout, stderr[-800:])


def test_single_host_views():
    assert multihost.runtime() == multihost.HostRuntime(0, 1)
    rt = multihost.runtime(process_id=2, num_processes=3)
    assert rt == multihost.HostRuntime(2, 3)
    assert rt.shard(list(range(8))) == [2, 5]
    multihost.HostRuntime(0, 1).barrier("alone")  # no group: a no-op


def test_cross_host_chunk_dict_over_storage_boundary(tmp_path):
    """Host 0 converts and publishes its merged bootstrap; a barrier gates
    host 1, which loads it from the shared store and converts an
    overlapping image against it: cross-host dedup gives foreign-blob
    references, and host 1's blob equals the reference's pack of the same
    image against the same dict bootstrap."""
    from nydus_snapshotter_tpu.models.bootstrap import Bootstrap as JBootstrap
    from nydus_snapshotter_tpu.models.bootstrap import ChunkDict as JChunkDict

    share = tmp_path / "registry"
    share.mkdir()
    results = _run_pair(_DICT_CHILD, tmp_path, SHARE_DIR=str(share))
    assert results[0]["dict_chunks"] > 0
    r1 = results[1]
    assert 0 < r1["dedup_bytes"] <= r1["total_bytes"], "no cross-host dedup hits"
    assert r1["own"] in r1["referenced"] and len(r1["referenced"]) == 2
    # the reference, one process, same artifact
    prng = np.random.default_rng(777)
    pool = [prng.integers(0, 256, 60_000, dtype=np.uint8).tobytes() for _ in range(8)]
    rng = np.random.default_rng(2)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        for f in range(5):
            data = pool[rng.integers(0, len(pool))]
            ti = tarfile.TarInfo(f"app/f2-{f}")
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    jdict = JChunkDict(JBootstrap.from_bytes(bytes.fromhex(results[0]["bootstrap"])))
    jblob, _ = j_pack_layer(buf.getvalue(), JPackOption(chunk_size=0x10000), chunk_dict=jdict)
    assert bytes.fromhex(r1["blob"]) == jblob
