"""Fixtures of the benchmark's CPU tests.

    python3 -m pytest benchmark/tests -q

A test that needs a CUDA card carries the ``cuda`` marker and takes the
``cuda_card`` fixture, which skips it without one (decided when the test
runs, never at import).
"""

from __future__ import annotations

import pytest

from benchmark import manifest

SHA_CELL = "rafs6-sha256-lz4-1m.node21-family"
B3_CELL = "rafs6-blake3-zstd-1m.node21-family"


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skipped without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cell runs only on the chip")
    return torch.device("cuda", 0)


SECONDS = 30  # the tiny runs' window, which their families run out of
TINY = 128  # the tiny family's layers and files are this many times smaller


def tiny_traffic(traffic: dict, window: int = 2) -> dict:
    """The cell's traffic at a size a CPU test holds: every layer, named
    file and reference sample ``TINY`` times smaller, its directory tree 16
    times smaller, one
    warm-up and ``window`` window images for a window of ``SECONDS``."""
    layers = [dict(spec, mb=spec["mb"] / TINY, dirs=spec["dirs"] // 16,
                   files=[dict(f, bytes=max(1, f["bytes"] // TINY)) for f in spec["files"]])
              for spec in traffic["layers"]]
    rewritten = [dict(r, bytes=[max(1, b // TINY) for b in r["bytes"]])
                 for r in traffic.get("rewritten", ())]
    image_mib = sum(spec["mb"] for spec in layers) * 1e6 / 2**20
    return dict(traffic, layers=layers, rewritten=rewritten,
                blake3_sample_mib=traffic["blake3_sample_mib"] / TINY,
                cdc_sample_mib=traffic["cdc_sample_mib"] / TINY,
                max_gib_per_s=(window - 1.5) * image_mib / 1024 / SECONDS)


@pytest.fixture
def tiny_cell(monkeypatch):
    """Run cells on the CPU at a tiny size, on the ``numpy`` lane (the port's
    host lane, byte-identical to ``fused``; the fused lane's plain SHA-256
    steps per block in Python on the CPU)."""
    orig = manifest.cell

    def cell(man, workload):
        c, config, traffic = orig(man, workload)
        return c, dict(config, backend="numpy"), tiny_traffic(traffic)

    monkeypatch.setattr(manifest, "cell", cell)
    return cell
