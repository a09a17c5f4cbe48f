"""What a run loads: never JAX or the JAX package (top-level names compared
whole: the port's name begins with the JAX package's); and the reference
loads nothing of the port."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark import manifest

RUN_TINY = """
import json, sys
from benchmark import manifest, run
from benchmark.tests.conftest import tiny_traffic
orig = manifest.cell
def cell(man, workload):
    c, config, traffic = orig(man, workload)
    return c, dict(config, backend="numpy"), tiny_traffic(traffic)
manifest.cell = cell
res = run.run(run.parse(["--workload", sys.argv[1], "--seed", "5", "--seconds", "30",
                         "--trace", "1"]), device_check=False)
print(json.dumps({"correct": res["correct"],
                  "top": sorted({n.split(".", 1)[0] for n in sys.modules}),
                  "forbidden": run.forbidden_modules()}))
"""

REFERENCE = """
import json, sys
import numpy as np
from benchmark.reference import blake3, cdc, check, codecs, rafs
cdc.cuts(np.arange(1 << 20, dtype=np.uint8), 0x4000)
blake3.digests([b"abc"])
codecs.Encoder("lz4_block", 1).encode(b"abc"), codecs.Encoder("zstd", 3).encode(b"abc")
check.Reference({"chunk_size": 0x4000, "digester": "blake3", "compressor": "zstd",
                 "zstd_level": 3},
                np.random.default_rng(0), 1 << 20, 1 << 20)
print(json.dumps(sorted({n.split(".", 1)[0] for n in sys.modules})))
"""


def child(code: str, *args: str) -> str:
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    for cell in ("rafs6-sha256-lz4-1m.node21-family", "rafs6-blake3-zstd-1m.node21-family"):
        got = json.loads(child(RUN_TINY, cell))
        assert got["correct"]
        assert "nydus_snapshotter_tpu_torch" in got["top"]
        assert not {"jax", "jaxlib", "flax", "nydus_snapshotter_tpu"} & set(got["top"])
        assert got["forbidden"] == []


def test_the_reference_loads_nothing_of_the_port():
    top = set(json.loads(child(REFERENCE)))
    assert not {"nydus_snapshotter_tpu_torch", "nydus_snapshotter_tpu", "jax", "torch"} & top


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "nydus_snapshotter_tpu_torch_x", sys)
    assert "nydus_snapshotter_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()
