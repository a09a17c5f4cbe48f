"""Whole runs of the harness on the CPU at a tiny size (the ``numpy`` lane):
the result's form, the rate over a window that holds a stall, the control
and the faults that ``correct`` must catch."""

from __future__ import annotations

import json
import time

import pytest

from benchmark import control, manifest, run
from benchmark.gen import image_family
from benchmark.tests.conftest import B3_CELL, SECONDS, SHA_CELL, tiny_traffic

SEED = 2**31 + 77


def one_run(cell, trace=0, control=None, seed=SEED, seconds=SECONDS):
    return run.run(run.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                              "--trace", str(trace)]), device_check=False, control=control)


@pytest.mark.parametrize("cell", [SHA_CELL, B3_CELL])
def test_sound_runs_are_correct_and_well_formed(tiny_cell, cell):
    res = one_run(cell)
    assert res["correct"] and res["attempted"] == 2 and res["failed"] == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["metrics"]) == {"convert_gibps", "setup_s"}
    assert all(c == {"value": 0, "limit": 0} for c in res["checks"].values())
    traced = one_run(cell, trace=1)
    assert traced["correct"] and list(traced)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(traced["device"])
    # on the CPU no kernel runs: the rooflines and the stage split stay silent
    assert set(traced["metrics"]) == {"device_idle_pct.convert"}
    json.dumps(traced)


def test_the_rate_counts_a_stall(monkeypatch):
    orig = manifest.cell

    def cell(man, workload):
        c, config, traffic = orig(man, workload)
        return c, dict(config, backend="numpy"), tiny_traffic(traffic, window=4)

    monkeypatch.setattr(manifest, "cell", cell)

    spans = []

    def stall(driver, image):
        t0 = time.perf_counter()
        out = driver.convert(image)
        if image.name == "img2":
            time.sleep(1.5)
        spans.append((t0, time.perf_counter()))
        return out

    # four window images, which run out before the window's end: the rate is
    # their bytes over the whole span of their calls, the stall in it
    res = one_run(SHA_CELL, control=stall)
    assert res["attempted"] == 4
    _c, _config, traffic = manifest.cell(manifest.load(), SHA_CELL)
    gib = sum(im.nbytes for im in image_family.build(traffic, SEED, 5)[1:]) / 2**30
    window = spans[-1][1] - spans[1][0]  # spans[0] is the warm-up image
    assert window > 1.5
    assert gib / res["metrics"]["convert_gibps"]["value"] == pytest.approx(window, abs=0.05)


def state_unchanged(driver, image):
    """The dict's growth returns it unchanged."""
    driver.converter.dict.add_bootstrap_bytes = lambda data: 0
    return driver.convert(image)


def half_left_out(driver, image):
    """Half of the image's layers are not converted."""
    tars = image.tars
    return driver.converter.convert_many([(image.name, tars[: len(tars) // 2])])[0]


def digest_altered(driver, image):
    """One chunk digest altered where the merged bootstrap is written."""
    out = driver.convert(image)
    boot = bytearray(out.bootstrap)
    off = _chunk_table_offset(out.bootstrap)
    boot[off] ^= 0x40
    out.bootstrap = bytes(boot)
    return out


def byte_altered(driver, image):
    """One byte of a stored frame altered in a layer blob."""
    out = driver.convert(image)
    bid, blob = next(iter(out.layer_blobs.items()))
    blob = bytearray(blob)
    blob[0] ^= 0x01
    out.layer_blobs[bid] = bytes(blob)
    return out


def digests_of_one_class_altered(lo: int, hi: int):
    """Every chunk digest of one size class altered in the merged bootstrap:
    a digester fault that only chunks of lo < size <= hi bytes show."""
    import struct

    def fault(driver, image):
        out = driver.convert(image)
        boot = bytearray(out.bootstrap)
        count = struct.unpack_from("<I", boot, 1024 + 6 * 4 + 8)[0]
        off = _chunk_table_offset(out.bootstrap)
        for i in range(count):
            rec = off + 64 * i
            if lo < struct.unpack_from("<I", boot, rec + 56)[0] <= hi:
                boot[rec] ^= 0x40
        out.bootstrap = bytes(boot)
        return out

    return fault


@pytest.mark.parametrize("lo,hi", [(0, 1024), (1024, 16 * 1024), (16 * 1024, 1 << 30)])
def test_a_blake3_fault_in_any_leaf_class_is_caught(tiny_cell, lo, hi):
    res = one_run(B3_CELL, control=digests_of_one_class_altered(lo, hi))
    assert not res["correct"] and res["checks"]["digests_wrong"]["value"] > 0


def _chunk_table_offset(boot: bytes) -> int:
    import struct

    return struct.unpack_from("<Q", boot, 1024 + 6 * 4 + 3 * 8 + 8)[0]


@pytest.mark.parametrize("cell", [SHA_CELL, B3_CELL])
def test_a_faster_codec_setting_makes_the_run_incorrect(tiny_cell, cell):
    res = one_run(cell, control=control.faster_codec_each_image)
    assert not res["correct"] and res["failed"] > 0
    assert res["checks"]["frames_wrong"]["value"] > 0
    assert sum(c["value"] for c in res["checks"].values()) == res["checks"]["frames_wrong"]["value"]


@pytest.mark.parametrize("fault,count", [(state_unchanged, "dedup_wrong"),
                                         (half_left_out, "tree_wrong"),
                                         (digest_altered, "digests_wrong"),
                                         (byte_altered, "frames_wrong")])
def test_faults_make_the_run_incorrect(tiny_cell, fault, count):
    res = one_run(SHA_CELL, control=fault)
    assert not res["correct"] and res["failed"] > 0
    assert res["checks"][count]["value"] > 0
