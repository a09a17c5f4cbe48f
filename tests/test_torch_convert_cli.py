"""The port's converter CLI (cmd/convert.py) against the JAX package's.

Every case of tests/test_convert_cli.py runs both CLIs in process through
``main(argv)`` on the same inputs: return codes, stdout and stderr lines
and every file written (layer streams, bootstraps, tars, EROFS disks,
batch outputs) must be byte-identical. The device lanes run on the port
with ``--device cpu`` (the kernels' plain versions) and on the reference
on its CPU platform. Two subprocess runs of the port hold the process
contract (rc 0 and one JSON line; rc 1 and one stderr line). The content
store proxy and feature detection (tests/test_converter_hooks.py) close
the file.
"""

from __future__ import annotations

import contextlib
import gzip
import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import tarfile
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nydus_snapshotter_tpu.cmd import convert as ref_cli
from nydus_snapshotter_tpu.converter import convert as jconvert
from nydus_snapshotter_tpu.converter.content import LocalContentStore as JContentStore
from nydus_snapshotter_tpu.converter.cs_proxy import ContentStoreProxy as JProxy
from nydus_snapshotter_tpu.converter.feature import detect_features as j_detect
from nydus_snapshotter_tpu.converter.types import MergeOption as JMergeOption
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.tarfs.bootstrap import tarfs_bootstrap_from_tar as j_tarfs
from nydus_snapshotter_tpu_torch.cmd import convert as port_cli
from nydus_snapshotter_tpu_torch.converter import convert as tconvert
from nydus_snapshotter_tpu_torch.converter.content import LocalContentStore as TContentStore
from nydus_snapshotter_tpu_torch.converter.cs_proxy import ContentStoreProxy as TProxy
from nydus_snapshotter_tpu_torch.converter.feature import Feature, detect_features
from nydus_snapshotter_tpu_torch.converter.types import MergeOption as TMergeOption
from nydus_snapshotter_tpu_torch.converter.types import PackOption as TPackOption
from nydus_snapshotter_tpu_torch.ops import blake3, gear_cuda, sha256_cuda
from nydus_snapshotter_tpu_torch.tarfs.bootstrap import tarfs_bootstrap_from_tar as t_tarfs

RNG = np.random.default_rng(0xC11)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = RNG.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
SIDES = ("ref", "port")
# the device lanes step the plain SHA-256 per 64-byte block on the CPU: the
# cases that run them take 4 KiB chunks
DEVICE_LANES = ("fused", "jax")


def mk_tar(files: dict[str, bytes]) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, data in files.items():
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


def run_cli(capsys, side: str, *argv: str):
    """One in-process CLI call -> (rc, stdout, stderr). The port's device
    lanes run on the CPU (``--device cpu``)."""
    if side == "port":
        rc = port_cli.main(["--device", "cpu", *argv])
    else:
        rc = ref_cli.main(list(argv))
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def run_both(capsys, tmp_path, *argv: str):
    """The same verb through both CLIs: ``{o}`` in an argument becomes a
    directory of each side's own. Return codes, stdout and stderr must be
    equal; -> (rc, stdout, stderr, {side: its directory})."""
    dirs, got = {}, {}
    for side in SIDES:
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        dirs[side] = d
        got[side] = run_cli(capsys, side, *(a.replace("{o}", str(d)) for a in argv))
    assert got["port"] == got["ref"], got
    return (*got["port"], dirs)


def same_files(dirs) -> list[str]:
    """Every file under each side's directory, byte for byte."""
    trees = {}
    for side, d in dirs.items():
        trees[side] = {
            os.path.relpath(os.path.join(root, f), d): open(os.path.join(root, f), "rb").read()
            for root, _, files in os.walk(d)
            for f in files
        }
    assert trees["port"].keys() == trees["ref"].keys()
    for name in trees["ref"]:
        assert trees["port"][name] == trees["ref"][name], name
    return sorted(trees["ref"])


class TestCliRoundTrip:
    @pytest.mark.parametrize("backend", ["hybrid", "numpy", "fused", "jax"])
    def test_pack_merge_check_unpack(self, capsys, tmp_path, backend):
        src = tmp_path / "layer.tar"
        src.write_bytes(mk_tar({"app/data.bin": SHARED, "app/note": b"hi"}))
        rc, out, _, dirs = run_both(
            capsys, tmp_path, "pack", "--in", str(src), "--out", "{o}/layer.nydus",
            "--chunk-size", "0x1000", "--backend", backend
        )
        assert rc == 0
        res = json.loads(out)
        blob_id = res["blob_id"]
        assert res["blob_size"] > 0

        rc, out, _, _ = run_both(capsys, tmp_path, "merge", "{o}/layer.nydus", "--out", "{o}/image.boot")
        assert rc == 0 and json.loads(out)["blob_digests"] == [blob_id]
        rc, out, _, _ = run_both(capsys, tmp_path, "check", "--boot", "{o}/image.boot")
        info = json.loads(out)
        assert rc == 0 and info["version"] == "v6" and info["blobs"] == [blob_id]

        for side, d in dirs.items():
            blob_dir = d / "blobs"
            blob_dir.mkdir()
            (blob_dir / blob_id).write_bytes(
                tconvert.blob_data_from_layer_blob((d / "layer.nydus").read_bytes())
            )
        rc, out, _, _ = run_both(capsys, tmp_path, "unpack", "--boot", "{o}/image.boot",
                                 "--blob-dir", "{o}/blobs", "--out", "{o}/out.tar")
        assert rc == 0
        assert same_files(dirs) == sorted(["blobs/" + blob_id, "image.boot", "layer.nydus", "out.tar"])
        with tarfile.open(dirs["port"] / "out.tar") as tf:
            assert tf.extractfile("app/data.bin").read() == SHARED

    @pytest.mark.parametrize("backend", ["hybrid", "fused"])
    def test_pack_blake3(self, capsys, tmp_path, backend):
        src = tmp_path / "layer.tar"
        src.write_bytes(mk_tar({"b3/data.bin": SHARED[:60_000], "b3/tiny": b"x"}))
        rc, out, _, dirs = run_both(
            capsys, tmp_path, "pack", "--in", str(src), "--out", "{o}/layer.nydus",
            "--digester", "blake3", "--chunk-size", "0x1000", "--backend", backend
        )
        assert rc == 0 and json.loads(out)["blob_size"] > 0
        same_files(dirs)

    def test_pack_oci_ref(self, capsys, tmp_path):
        src = tmp_path / "layer.tgz"
        src.write_bytes(gzip.compress(mk_tar({"f": SHARED}), mtime=0))
        rc, out, _, dirs = run_both(capsys, tmp_path, "pack", "--in", str(src), "--out",
                                    "{o}/ref.boot", "--oci-ref", "--chunk-size", "0x10000")
        assert rc == 0
        res = json.loads(out)
        assert res["chunks"] > 0
        rc, out, _, _ = run_both(capsys, tmp_path, "check", "--boot", "{o}/ref.boot")
        assert json.loads(out)["blobs"] == [res["blob_id"]]
        same_files(dirs)

    @pytest.mark.parametrize("backend", ["hybrid", "fused"])
    def test_batch_with_dict_growth(self, capsys, tmp_path, backend):
        imgs = []
        for i, files in enumerate([{"a/shared": SHARED}, {"b/dup": SHARED, "b/new": b"x" * 3000}]):
            p = tmp_path / f"img{i}.tar"
            p.write_bytes(mk_tar(files))
            imgs.append(str(p))
        rc, out, _, dirs = run_both(capsys, tmp_path, "batch", *imgs, "--out-dir", "{o}/converted",
                                    "--dict-out", "{o}/dict.boot", "--chunk-size", "0x1000",
                                    "--backend", backend)
        assert rc == 0
        res = json.loads(out)
        assert len(res["images"]) == 2 and (res["host"], res["hosts"]) == (0, 1)
        # image 1 dedups against image 0's chunks
        assert res["images"][1]["new_chunks"] < res["images"][0]["new_chunks"]
        names = same_files(dirs)
        assert "dict.boot" in names and "converted/img0.tar.boot" in names

    def test_export_erofs(self, capsys, tmp_path):
        tar = mk_tar({"d/file": SHARED})
        bs = t_tarfs(io.BytesIO(tar), blob_id="ab" * 32)
        assert bs.to_bytes() == j_tarfs(io.BytesIO(tar), blob_id="ab" * 32).to_bytes()
        boot = tmp_path / "t.boot"
        boot.write_bytes(bs.to_bytes())
        tar_dir = tmp_path / "tars"
        tar_dir.mkdir()
        (tar_dir / ("ab" * 32)).write_bytes(tar)
        rc, out, _, dirs = run_both(capsys, tmp_path, "export-erofs", "--boot", str(boot),
                                    "--tar-dir", str(tar_dir), "--out", "{o}/image.erofs")
        assert rc == 0
        disk = (dirs["port"] / "image.erofs").read_bytes()
        assert len(disk) == json.loads(out)["image_bytes"]
        assert struct.unpack_from("<I", disk, 1024)[0] == 0xE0F5E1E2  # a real EROFS image
        same_files(dirs)

    @pytest.mark.parametrize("fmt", ["v5", "v6"])
    def test_export_real(self, capsys, tmp_path, fmt):
        src = tmp_path / "layer.tar"
        src.write_bytes(mk_tar({"opt/a.bin": SHARED[:90_000], "opt/b": b"bee"}))
        run_both(capsys, tmp_path, "pack", "--in", str(src), "--out", "{o}/layer.nydus",
                 "--chunk-size", "0x1000", "--chunking", "fixed")
        run_both(capsys, tmp_path, "merge", "{o}/layer.nydus", "--out", "{o}/image.boot")
        rc, out, _, dirs = run_both(capsys, tmp_path, "export-real", "--boot", "{o}/image.boot",
                                    "--out", "{o}/real.boot", "--format", fmt)
        assert rc == 0 and json.loads(out)["source"] == "native"
        # and back again: a real bootstrap transcodes verbatim
        rc, out, _, _ = run_both(capsys, tmp_path, "export-real", "--boot", "{o}/real.boot",
                                 "--out", "{o}/again.boot", "--format", fmt)
        assert rc == 0 and json.loads(out)["source"] == f"real-{fmt}"
        rc, out, _, _ = run_both(capsys, tmp_path, "check", "--boot", "{o}/again.boot")
        assert rc == 0
        same_files(dirs)

    def test_error_contract(self, capsys, tmp_path):
        rc, out, err, _ = run_both(capsys, tmp_path, "check", "--boot", str(tmp_path / "missing.boot"))
        assert rc == 1 and out == ""
        assert err.startswith("ntpu-convert:") and err.count("\n") == 1


def test_oci_ref_output_feeds_merge(capsys, tmp_path):
    src = tmp_path / "layer.tgz"
    src.write_bytes(gzip.compress(mk_tar({"f": SHARED}), mtime=0))
    rc, _, _, _ = run_both(capsys, tmp_path, "pack", "--in", str(src), "--out", "{o}/ref.nydus",
                           "--oci-ref", "--chunk-size", "0x10000")
    assert rc == 0
    rc, out, _, dirs = run_both(capsys, tmp_path, "merge", "{o}/ref.nydus", "--out", "{o}/image.boot")
    assert rc == 0
    assert json.loads(out)["blob_digests"] == [hashlib.sha256(src.read_bytes()).hexdigest()]
    same_files(dirs)


def _merged_boot(tmp_path, members, seed: int, chunk_size: int):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, size in members:
            ti = tarfile.TarInfo(name)
            ti.size = size
            tf.addfile(ti, io.BytesIO(rng.integers(0, 256, size, dtype=np.uint8).tobytes()))
    blob, _res = jconvert.pack_layer(buf.getvalue(), JPackOption(chunk_size=chunk_size))
    boot_bytes = jconvert.Merge([blob], JMergeOption(with_tar=False)).bootstrap
    # the port builds the same image bootstrap from the same tar
    tblob, _ = tconvert.pack_layer(buf.getvalue(), TPackOption(chunk_size=chunk_size, backend="numpy"))
    assert tconvert.Merge([tblob], TMergeOption(with_tar=False)).bootstrap == boot_bytes
    boot = tmp_path / "img.boot"
    boot.write_bytes(boot_bytes)
    return boot


def test_inspect_subcommand(capsys, tmp_path):
    """``inspect``: tree listing, per-path chunk detail, dir listing."""
    boot = _merged_boot(tmp_path, (("app/a.bin", 150_000), ("app/sub/b.bin", 3000)), 8, 0x10000)

    rc, out, _, _ = run_both(capsys, tmp_path, "inspect", "--boot", str(boot))
    d = json.loads(out.strip())
    assert rc == 0 and "/app/a.bin" in d["paths"] and d["inodes"] >= 4

    _, out, _, _ = run_both(capsys, tmp_path, "inspect", "--boot", str(boot), "--path", "/app/a.bin")
    d = json.loads(out.strip())
    assert d["size"] == 150_000 and len(d["chunks"]) >= 2
    assert all(len(c["digest"]) == 64 for c in d["chunks"])

    _, out, _, _ = run_both(capsys, tmp_path, "inspect", "--boot", str(boot), "--list", "/app")
    assert json.loads(out.strip())["entries"] == ["a.bin", "sub"]

    rc, _, err, _ = run_both(capsys, tmp_path, "inspect", "--boot", str(boot), "--path", "/nope")
    assert rc == 1 and err.count("\n") == 1


def test_inspect_edge_semantics(capsys, tmp_path):
    """Mutually exclusive queries, a missing dir is rc 1 (not an empty
    listing), trailing slashes normalize, prefix matches components."""
    boot = _merged_boot(tmp_path, (("opt/x.bin", 1000), ("opt2/y.bin", 1000)), 9, 0x10000)

    assert run_both(capsys, tmp_path, "inspect", "--boot", str(boot), "--path", "/opt/")[0] == 0
    assert run_both(capsys, tmp_path, "inspect", "--boot", str(boot), "--list", "/typo")[0] == 1
    _, out, _, _ = run_both(capsys, tmp_path, "inspect", "--boot", str(boot), "--prefix", "/opt")
    d = json.loads(out.strip())
    assert "/opt/x.bin" in d["paths"] and not any(p.startswith("/opt2") for p in d["paths"])
    for side in SIDES:  # argparse exits on the conflicting flags, as the reference's does
        with pytest.raises(SystemExit) as e:
            run_cli(capsys, side, "inspect", "--boot", str(boot), "--path", "/opt", "--list", "/opt")
        assert e.value.code != 0
        capsys.readouterr()


class TestDeviceFlag:
    def test_device_lane_without_card_exits_1_and_launches_nothing(self, capsys, tmp_path, monkeypatch):
        """No ``--device`` means the card: with no card a device lane fails
        with one stderr line naming CUDA, and no plain version runs in its
        place."""
        if torch.cuda.is_available():
            return  # only meaningful on a host without CUDA, such as CI
        ran = []
        for mod, name in ((gear_cuda, "gear_bitmaps_plain"), (sha256_cuda, "sha256_chunks_plain"),
                          (blake3, "blake3_chunks_plain")):
            monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: ran.append(_n))
        src = tmp_path / "layer.tar"
        src.write_bytes(mk_tar({"f": SHARED}))
        for backend in DEVICE_LANES:
            for digester in ("sha256", "blake3"):
                rc = port_cli.main(["pack", "--backend", backend, "--digester", digester,
                                    "--in", str(src), "--out", str(tmp_path / "o.nydus")])
                cap = capsys.readouterr()
                assert rc == 1 and cap.out == "" and cap.err.count("\n") == 1
                assert cap.err.startswith("ntpu-convert:") and "CUDA" in cap.err
        rc = port_cli.main(["batch", str(src), "--backend", "fused", "--out-dir", str(tmp_path / "b")])
        assert rc == 1 and "CUDA" in capsys.readouterr().err
        assert ran == []

    def test_named_device_must_exist(self, capsys, tmp_path):
        if torch.cuda.is_available():
            return
        for dev in ("cuda", "cuda:1"):
            rc = port_cli.main(["--device", dev, "check", "--boot", str(tmp_path / "x")])
            err = capsys.readouterr().err
            assert rc == 1 and "CUDA is not available" in err and err.count("\n") == 1

    def test_named_ordinal_must_exist(self, capsys, tmp_path, monkeypatch):
        """On a one-card host ``cuda:1`` names no card: ``resolve_device``
        raises, feature detection reports no DEVICE_DIGEST and the CLI
        exits 1 with one stderr line; ``cuda:0`` and ``cuda`` pass all
        three."""
        from nydus_snapshotter_tpu_torch import tensors
        from nydus_snapshotter_tpu_torch.converter import feature

        src = tmp_path / "layer.tar"
        src.write_bytes(mk_tar({"f": b"ordinal"}))
        with contextlib.redirect_stdout(io.StringIO()):
            assert port_cli.main(["pack", "--backend", "numpy", "--in", str(src),
                                  "--out", str(tmp_path / "l.nydus")]) == 0
            assert port_cli.main(["merge", str(tmp_path / "l.nydus"), "--out", str(tmp_path / "i.boot")]) == 0
        capsys.readouterr()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setattr(feature, "_detected", {})
        with pytest.raises(RuntimeError, match="1 CUDA device"):
            tensors.resolve_device("cuda:1")
        assert tensors.resolve_device("cuda:0") == torch.device("cuda", 0)
        assert tensors.resolve_device("cuda") == torch.device("cuda")
        assert not detect_features(force=True, device="cuda:1").contains(Feature.DEVICE_DIGEST)
        for dev in ("cuda:0", "cuda"):
            assert detect_features(force=True, device=dev).contains(Feature.DEVICE_DIGEST)
        rc = port_cli.main(["--device", "cuda:1", "check", "--boot", str(tmp_path / "i.boot")])
        cap = capsys.readouterr()
        assert rc == 1 and cap.out == "" and cap.err.count("\n") == 1
        assert cap.err.startswith("ntpu-convert:") and "1 CUDA device" in cap.err
        for dev in ("cuda:0", "cuda"):
            rc = port_cli.main(["--device", dev, "check", "--boot", str(tmp_path / "i.boot")])
            cap = capsys.readouterr()
            assert rc == 0 and cap.err == "" and cap.out.count("\n") == 1

    def test_host_lanes_need_no_device(self, capsys, tmp_path):
        """``hybrid`` (the default) and ``numpy`` are host lanes: no card
        and no ``--device``, the reference's bytes."""
        src = tmp_path / "layer.tar"
        src.write_bytes(mk_tar({"h/data": SHARED}))
        outs = {}
        for side, cli in (("ref", ref_cli), ("port", port_cli)):
            for backend in ("hybrid", "numpy"):
                out = tmp_path / f"{side}-{backend}.nydus"
                assert cli.main(["pack", "--backend", backend, "--in", str(src), "--out", str(out)]) == 0
                outs[(side, backend)] = (out.read_bytes(), capsys.readouterr().out)
        assert outs[("port", "hybrid")] == outs[("ref", "hybrid")] == outs[("ref", "numpy")]
        assert outs[("port", "numpy")] == outs[("ref", "numpy")]


def _port_subprocess(*argv: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "nydus_snapshotter_tpu_torch.cmd.convert", *argv],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )


class TestProcessContract:
    def test_pack_rc0_one_json_line(self, capsys, tmp_path):
        src = tmp_path / "layer.tar"
        src.write_bytes(mk_tar({"app/data.bin": SHARED, "app/note": b"hi"}))
        out = _port_subprocess("--device", "cpu", "pack", "--backend", "fused", "--chunk-size",
                               "0x1000", "--in", str(src), "--out", str(tmp_path / "port.nydus"))
        assert out.returncode == 0, out.stderr
        assert out.stdout.count("\n") == 1
        assert ref_cli.main(["pack", "--backend", "fused", "--chunk-size", "0x1000", "--in",
                             str(src), "--out", str(tmp_path / "ref.nydus")]) == 0
        assert out.stdout == capsys.readouterr().out
        assert (tmp_path / "port.nydus").read_bytes() == (tmp_path / "ref.nydus").read_bytes()

    def test_error_rc1_one_stderr_line(self, tmp_path):
        src = tmp_path / "layer.tar"
        src.write_bytes(mk_tar({"f": b"abc"}))
        if torch.cuda.is_available():  # the card is there: a missing input instead
            out = _port_subprocess("check", "--boot", str(tmp_path / "missing.boot"))
        else:
            out = _port_subprocess("pack", "--backend", "fused", "--in", str(src),
                                   "--out", str(tmp_path / "o.nydus"))
            assert "CUDA" in out.stderr
        assert out.returncode == 1 and out.stdout == ""
        assert out.stderr.startswith("ntpu-convert:") and out.stderr.count("\n") == 1


# ---------------------------------------------------------------------------
# content-store proxy and feature detection (tests/test_converter_hooks.py)
# ---------------------------------------------------------------------------

PROXY = {"ref": (JContentStore, JProxy), "port": (TContentStore, TProxy)}


@pytest.mark.parametrize("side", SIDES)
class TestContentStoreProxy:
    def test_serves_blob_ranges(self, tmp_path, side):
        store, proxy_cls = PROXY[side]
        cs = store(str(tmp_path / "content"))
        info = cs.write_blob(b"0123456789abcdef")
        proxy = proxy_cls(cs)
        proxy.start()
        try:
            with urllib.request.urlopen(proxy.blob_url(info.digest, offset=4, size=6)) as r:
                assert r.read() == b"456789"
            with urllib.request.urlopen(proxy.blob_url(info.digest)) as r:
                assert r.read() == b"0123456789abcdef"
        finally:
            proxy.stop()

    def test_unknown_blob_404(self, tmp_path, side):
        store, proxy_cls = PROXY[side]
        proxy = proxy_cls(store(str(tmp_path / "content")))
        proxy.start()
        try:
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(proxy.blob_url("sha256:" + "9" * 64))
        finally:
            proxy.stop()


def test_proxies_serve_the_same_bytes(tmp_path):
    """One layer blob in each package's store: every range both proxies
    serve is the same."""
    blob = mk_tar({"x": SHARED})
    served = {}
    for side, (store, proxy_cls) in PROXY.items():
        cs = store(str(tmp_path / side))
        info = cs.write_blob(blob)
        proxy = proxy_cls(cs)
        proxy.start()
        try:
            served[side] = [info.digest]
            for off, size in ((0, -1), (512, 4096), (len(blob) - 10, 100)):
                with urllib.request.urlopen(proxy.blob_url(info.digest, off, size)) as r:
                    served[side].append(r.read())
        finally:
            proxy.stop()
    assert served["port"] == served["ref"]


class TestFeatures:
    def test_detect_features_cached(self):
        import importlib.util

        for device in (None, "cpu"):
            f1 = detect_features(force=True, device=device)
            f2 = detect_features(device=device)
            assert f1 is f2
            assert f1.contains(Feature.TAR_RAFS)
            assert f1.contains(Feature.CDC_CHUNKING)
            # ENCRYPT tracks whether a cipher backend is importable here.
            assert f1.contains(Feature.ENCRYPT) == (importlib.util.find_spec("cryptography") is not None)
            assert not f1.contains(Feature.BATCH_SIZE)
        assert detect_features(device="cpu") is not detect_features()

    def test_cpu_features_equal_the_reference_on_its_cpu_platform(self):
        """``device="cpu"`` is where the plain versions run: the same set as
        the reference's on its CPU platform (DEVICE_DIGEST included)."""
        want = {f.value for f in j_detect(force=True)}
        got = {f.value for f in detect_features(force=True, device="cpu")}
        assert got == want and Feature.DEVICE_DIGEST.value in got

    def test_no_card_no_device_digest(self):
        feats = detect_features(force=True)
        assert feats.contains(Feature.DEVICE_DIGEST) == torch.cuda.is_available()
