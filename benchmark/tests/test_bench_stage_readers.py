"""The readers of the program's stage clocks on a stub context: silent
without their counters (a program that lacks them), the right ratio with
them."""

from __future__ import annotations

import pytest

from benchmark import manifest, run

GIB = 2**30
OVER_WINDOW = {
    "fanout_s_per_gib": ['ntpu_batch_stage_seconds{stage="fanout"}'],
    "merge_s_per_gib": ['ntpu_batch_stage_seconds{stage="merge"}'],
    "dict_grow_s_per_gib": ['ntpu_batch_stage_seconds{stage="dict_grow"}'],
    "gc_pause_s_per_gib": [f'ntpu_gc_pause_seconds{{generation="{g}"}}' for g in (0, 1, 2)],
    "pack_scan_s_per_gib": ['ntpu_pack_stage_seconds{stage="scan"}'],
    "pack_dedup_s_per_gib": ['ntpu_pack_stage_seconds{stage="dedup"}'],
    "pack_assemble_s_per_gib": ['ntpu_pack_stage_seconds{stage="assemble"}'],
}
OVER_FUSED_BYTES = {
    "pass1_layout_s_per_gib": 'ntpu_fused_convert_stage_seconds{stage="pass1_layout"}',
    "pass1_upload_s_per_gib": 'ntpu_fused_convert_stage_seconds{stage="pass1_upload"}',
}


def ctx(counters: dict, window_bytes: int = 4 * GIB) -> run.Context:
    return run.Context({}, None, 10.0, window_bytes, counters, {})


@pytest.mark.parametrize("metric", sorted(OVER_WINDOW))
def test_a_stage_over_the_window_bytes(metric):
    read = manifest.reader(metric).read
    unrelated = {"ntpu_fused_convert_bytes": float(GIB)}
    assert read(ctx({})) is None and read(ctx(unrelated)) is None
    keys = OVER_WINDOW[metric]
    counters = {k: 0.5 * (i + 1) for i, k in enumerate(keys)}
    assert read(ctx(counters)) == pytest.approx(sum(counters.values()) / 4)
    assert read(ctx(counters, window_bytes=0)) is None


@pytest.mark.parametrize("metric", sorted(OVER_FUSED_BYTES))
def test_a_pass1_stage_over_the_fused_bytes(metric):
    read = manifest.reader(metric).read
    stage = OVER_FUSED_BYTES[metric]
    assert read(ctx({})) is None
    # off the fused lane the bytes stay 0: silent
    assert read(ctx({stage: 0.0, "ntpu_fused_convert_bytes": 0.0})) is None
    got = read(ctx({stage: 3.0, "ntpu_fused_convert_bytes": 2.0 * GIB}))
    assert got == pytest.approx(1.5)


def test_the_new_readers_are_in_the_manifest():
    man = manifest.load()
    per_layer = {m["name"]: m for m in man["per_layer"]}
    cells = {w["name"] for w in man["workloads"]}
    for name in [*OVER_WINDOW, *OVER_FUSED_BYTES]:
        m = per_layer[name]
        assert m["source"] == "program_counter" and m["moves"] == "convert_gibps"
        assert set(m["workloads"]) == cells
