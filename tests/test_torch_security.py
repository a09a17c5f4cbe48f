"""The port's bootstrap signatures, content store and daemon cgroups
against the JAX package's.

Every case of tests/test_security.py runs in both packages (``pkg``,
through ``ported_cases``: the reference's own bodies and keys), except
``TestEncryption``, whose cases tests/test_torch_encryption.py already runs
in both packages with cross-package round trips. ``TestCgroup`` includes
the command line's ``_parse_size`` (``cmd.snapshotter``).

Cross-package cases, on numpy-seeded payloads: a signature made by one
package's ``Signer`` verifies with the other's, through each package's
``Verifier`` against a bootstrap file; the cgroup managers of both packages
write the same files into one fake cgroup tree; and ``_parse_size`` and
``_parse_duration`` give equal answers.
"""

from __future__ import annotations

import base64
import importlib
import os

import numpy as np
import pytest

from tests.test_torch_fetch_sched import ROOTS, SIDES, ported_cases

ENCRYPTION = (
    "test_encrypt_decrypt_roundtrip", "test_multiple_recipients", "test_wrong_key_rejected",
    "test_unwrap_only_does_not_decrypt", "test_unsupported_media_type", "test_filter_out_annotations",
    "test_content_store_flow",
)
ported_cases("test_security", globals(), leave_out=tuple(f"TestEncryption::{m}" for m in ENCRYPTION))


def _mod(side: str, name: str):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


@pytest.fixture(scope="module")
def pair():
    return _mod("ref", "utils.signer").generate_keypair(2048)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_signatures_verify_across_packages(tmp_path, pair, seed):
    """A seeded bootstrap signed by either package's ``Signer`` verifies in
    both packages' ``Verifier`` (label mode, key from a file); a byte
    flipped in the bootstrap is refused by both alike."""
    priv, pub = pair
    rng = np.random.default_rng(seed)
    boot = tmp_path / "image.boot"
    payload = rng.integers(0, 256, int(rng.integers(1, 50_000)), dtype=np.uint8).tobytes()
    boot.write_bytes(payload)
    key_file = tmp_path / "pub.pem"
    key_file.write_bytes(pub)
    label = _mod("ref", "constants").NYDUS_SIGNATURE
    assert label == _mod("port", "constants").NYDUS_SIGNATURE
    for signer_side in SIDES:
        sig = base64.b64encode(_mod(signer_side, "utils.signer").sign(priv, payload)).decode()
        for verifier_side in SIDES:
            v = _mod(verifier_side, "signature").Verifier(public_key_file=str(key_file), validate_signature=True)
            v.verify({label: sig}, str(boot))
    flipped = bytearray(payload)
    flipped[len(flipped) // 2] ^= 1
    boot.write_bytes(bytes(flipped))
    sig = base64.b64encode(_mod("ref", "utils.signer").sign(priv, payload)).decode()
    errors = {}
    for side in SIDES:
        v = _mod(side, "signature").Verifier(public_key_file=str(key_file), validate_signature=True)
        with pytest.raises(Exception) as ei:
            v.verify({label: sig}, str(boot))
        errors[side] = (type(ei.value).__name__, str(ei.value))
    assert errors["port"] == errors["ref"]


def _fake_root(root, v2: bool):
    if v2:
        os.makedirs(root)
        with open(os.path.join(root, "cgroup.controllers"), "w") as f:
            f.write("cpu memory io\n")
    else:
        os.makedirs(os.path.join(root, "memory"))


def _tree(root) -> dict:
    out = {}
    for d, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path) as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("v2", [True, False])
@pytest.mark.parametrize("limit", ["", "512MB", "1GiB", "1073741824", "64k"])
def test_cgroup_managers_write_equal_trees(tmp_path, limit, v2):
    """Both packages' cgroup managers, over the same fake cgroup root (v2
    or v1) with a memory limit parsed by each package's ``_parse_size``,
    create the same group with the same files, and add a pid alike."""
    trees = {}
    for side in SIDES:
        cg = _mod(side, "cgroup")
        size = _mod(side, "cmd.snapshotter")._parse_size(limit)
        root = str(tmp_path / side)
        _fake_root(root, v2)
        mgr = cg.Manager("nydusd", cg.Config(memory_limit_in_bytes=size), root=root)
        mgr.add_proc(4242)
        trees[side] = (cg.detect_mode(root).value, size, _tree(root))
    assert trees["port"] == trees["ref"]


@pytest.mark.parametrize("seed", [0, 1])
def test_size_and_duration_grammars_equal(seed):
    """``_parse_size`` and ``_parse_duration`` answer alike on seeded
    strings: every unit, empty, bare numbers and invalid text."""
    rng = np.random.default_rng(seed)
    sizes = ["", " ", "0", "1b"] + [f"{int(rng.integers(0, 5000))}{u}" for u in
                                   ("kb", "MB", "gb", "KiB", "mib", "GiB", "k", "M", "g", "")]
    durations = ["", "x", "5x"] + [f"{float(rng.uniform(0, 100)):.2f}{u}" for u in ("h", "m", "s", "", "H")]
    got = {}
    for side in SIDES:
        cli = _mod(side, "cmd.snapshotter")
        got[side] = ([cli._parse_size(s) for s in sizes], [cli._parse_duration(d) for d in durations])
    assert got["port"] == got["ref"]
