"""Time chip_smoke.py phase 13's image batches on a CUDA card, for A/B
calls across checkouts.

Builds images A, B and C from phase 2's files (``chip_smoke.image_corpus``
over ``FileGen(SEED).pool(LAYER_MIB)``) and converts them with the port's
``BatchConverter`` on the fused lane at the default fan-out and on the
hybrid lane, ``--reps`` times each in turns, after one untimed fused batch.
``chip_smoke`` and ``nydus_snapshotter_tpu_torch`` are imported from the
current directory, so one copy of this script times any checkout that has
phase 13:

    cd <checkout> && python3 <this repo>/tools/torch_batch_ab.py --label parent

Run parent, change, change, parent in one chip call to compare two commits
on one card. Prints one JSON line: wall seconds and host CPU seconds per
batch, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("torch_batch_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from nydus_snapshotter_tpu_torch.converter import PackOption, batch

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    images = cs.image_corpus(cs.FileGen(cs.SEED).pool(cs.LAYER_MIB))["images"]
    setup_s = time.perf_counter() - t0

    def run(backend: str) -> tuple[float, float]:
        bc = batch.BatchConverter(PackOption(backend=backend), device=dev)
        c0, w0 = os.times(), time.perf_counter()
        bc.convert_many(images)
        torch.cuda.synchronize()
        c1, w1 = os.times(), time.perf_counter()
        return w1 - w0, (c1.user + c1.system) - (c0.user + c0.system)

    run("fused")  # kernels built and loaded, the dict warm
    runs: dict[str, list] = {"fused": [], "hybrid": []}
    for _ in range(args.reps):
        for backend in runs:
            runs[backend].append(run(backend))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "setup_s": setup_s,
                      "input_bytes": sum(len(t) for _n, tars in images for t in tars),
                      "runs": {k: [{"wall_s": w, "host_cpu_s": c} for w, c in v]
                               for k, v in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
