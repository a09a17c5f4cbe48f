"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (everything from process start to the window, ``setup_s``): the
interpreter, torch and the CUDA context, the cell's inputs made from the
seed, the program's driver, and the warm-up images converted (kernels built
or loaded from the checkout's build cache, every shape the traffic uses
run once). The window then converts the family's next images in a closed
loop, one image a call, until ``--seconds`` have passed at the end of an
image: the rate is over whole images, all of the window's work over all of
its time. With ``--trace 1`` the window runs under ``torch.profiler`` and
the driver's host ranges, and the per-layer metrics are reported instead of
the end-to-end ones.

After the window the program is freed and the plain reference judges what
the window produced (``reference/check.py``). Earlier lines carry the card,
the launches, the stage split, the serial terms and the sizes; the last
lines of standard error each number compared beside its limit; the last
line of standard output the result object.

Exit 2 without a result: no CUDA card, or fewer cards than the cell asks
for. Exit 3 without a result: ``jax`` or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import resource
import sys
import time
from pathlib import Path

from benchmark import manifest
from benchmark import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "nydus_snapshotter_tpu")
_T_IMPORT = time.monotonic()


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n.split(".", 1)[0] for n in sys.modules} & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so only a
    checkout's first run builds. The port's nvcc and g++ builds go to its
    own ``nydus_snapshotter_tpu_torch/build/`` inside the checkout."""
    cache = root / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def log(msg: str) -> None:
    print(msg, flush=True)


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(args, device_check: bool = True, control=None) -> dict:
    """One run -> the result object. ``control`` (a function of the driver
    and the next image) stands in for the driver's conversion."""
    root = manifest.ROOT
    set_cache_dirs(root)
    man = manifest.load(root)
    cell, config, traffic = manifest.cell(man, args.workload)

    import torch

    if device_check:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: the cell needs {cell['chips']} CUDA card(s), found {have}",
                  file=sys.stderr)
            raise SystemExit(2)
        device = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(0)
    else:
        device, kind = torch.device("cpu"), "cpu"
    log(f"[bench] {args.workload} seed {args.seed}: {kind}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}; card {_smi()}")

    gen = importlib.import_module("benchmark.gen." + traffic["generator"])
    n_warm = int(traffic["warmup_images"])
    t0 = time.perf_counter()
    images = gen.build(traffic, args.seed, n_warm + gen.window_count(traffic, args.seconds))
    gen_s = time.perf_counter() - t0
    log(f"[bench] inputs: {len(images)} images in {gen_s:.3f} s; "
        + ", ".join(f"{im.name} {im.nbytes} B in {len(im.layers)} layers "
                    f"({sum(len(layer.paths) for layer in im.layers)} files)"
                    for im in images[: n_warm + 1]))

    drv_mod = importlib.import_module("benchmark.drivers." + config["driver"])
    driver = drv_mod.Driver(config, device)
    convert = driver.convert if control is None else (lambda im: control(driver, im))
    outputs = []
    t0 = time.perf_counter()
    for im in images[:n_warm]:
        outputs.append(convert(im))
    _sync(device)
    warm_s = time.perf_counter() - t0
    launches0, counters0 = driver.launches(), driver.counters()

    prof, host_ranges, window_t0 = None, [], 0.0
    walls = []
    with contextlib.ExitStack() as stack:
        if args.trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            stack.enter_context(driver.spans(host_ranges))
            prof = stack.enter_context(profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])))
            stack.enter_context(record_function(trace_mod.WINDOW_LABEL))
            window_t0 = time.perf_counter()
        setup_s = process_age_s()
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t_start = time.perf_counter()
        for im in images[n_warm:]:
            t = time.perf_counter()
            outputs.append(convert(im))
            _sync(device)
            walls.append(time.perf_counter() - t)
            if time.perf_counter() - t_start >= args.seconds:
                break
        window_s = time.perf_counter() - t_start
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
    log(f"[bench] host in the window: {_host(ru0, ru1)}")
    trace = None
    if prof is not None:
        trace = trace_mod.collect(prof, host_ranges, window_t0)
        ranges: dict[str, int] = {}
        for h in trace.host:
            ranges[h.name] = ranges.get(h.name, 0) + 1
        log(f"[bench] trace: {len(trace.device)} device events, busy {trace.busy_s():.6f} s; "
            f"host ranges {json.dumps(ranges)}")
    n_done = len(walls)
    done = images[n_warm : n_warm + n_done]
    window_bytes = drv_mod.input_bytes(done)
    if n_done == len(images) - n_warm and window_s < args.seconds:
        log(f"[bench] the family ran out after {window_s:.3f} s: the window is shorter")
    launches = {k: v - launches0[k] for k, v in driver.launches().items()}
    counters1 = driver.counters()
    counters = {k: v - counters0.get(k, 0.0) for k, v in counters1.items()}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"[bench] set-up {setup_s:.3f} s (inputs {gen_s:.3f}, warm-up {warm_s:.3f}); window "
        f"{window_s:.6f} s over {n_done} images, {window_bytes} B; image walls "
        + " ".join(f"{w:.3f}" for w in walls))
    log(f"[bench] launches in the window: {json.dumps(launches)}")
    stage = {k: v for k, v in counters.items() if k.startswith(drv_mod.COUNTERS)}
    log(f"[bench] the program's counters in the window: {json.dumps(stage)}")
    del driver, convert
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- the reference, after the window and with the program freed --------
    ref = importlib.import_module("benchmark.reference." + config["reference"])
    t0 = time.perf_counter()
    tally = ref.judge(config, traffic, args.seed, list(zip(images[:n_warm], outputs[:n_warm])),
                      list(zip(done, outputs[n_warm:])))
    check_s = time.perf_counter() - t0
    correct = n_done > 0 and all(v == 0 for v in tally.counts.values())
    log(f"[bench] reference in {check_s:.3f} s: {tally.summary()}")

    work = tally.work()
    _log_serial(work)
    result = {"correct": correct, "attempted": n_done,
              "failed": tally.bad_images,
              "metrics": {}, "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                                        "kind": kind, "count": cell["chips"],
                                        "memory_peak_bytes": int(peak)}}
    if args.trace:
        ctx = Context(config, trace, window_s, window_bytes, counters, work)
        for m in manifest.metrics_of(man, args.workload, "per_layer"):
            value = manifest.reader(m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        busy = trace.busy_s() if trace is not None else 0.0
        result["device"].update({"busy_s": busy, "window_s": window_s})
        result["breakdown"] = trace.breakdown() if trace is not None else {}
    else:
        e2e = {**drv_mod.rates(window_bytes, window_s), "setup_s": setup_s}
        for m in manifest.metrics_of(man, args.workload, "end_to_end"):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result["checks"] = {k: {"value": v, "limit": ref.LIMITS[k]} for k, v in tally.counts.items()}
    return result


class Context:
    """What a per-layer metric's reader reads."""

    def __init__(self, config, trace, window_s, window_bytes, counters, work):
        self.config = config
        self.trace = trace  # benchmark.trace.DeviceTrace, or None
        self.window_s = window_s
        self.window_bytes = window_bytes  # the input bytes of the window's work
        self.counters = counters  # the program's registry samples, window deltas
        self.work = work  # the window's work, from the reference: positions, chunk sizes

    def counter(self, key: str) -> float | None:
        return self.counters.get(key)


def _log_serial(work) -> None:
    """K2's and K4's serial terms, apart from their rooflines."""
    from benchmark import bounds

    sizes = work.get("chunk_sizes", ())
    if len(sizes):
        blocks = bounds.k2_serial_blocks(sizes)
        log(f"[bench] serial terms (not in any roofline): K2's longest chunk {int(sizes.max())} B "
            f"= {blocks} blocks x 64 dependent rounds; K4's {bounds.k4_chain(sizes)} dependent "
            f"compressions; chunks {len(sizes)}, file bytes {work['positions']}")


def _host(ru0, ru1) -> str:
    """What the host gave the window: the process's CPU seconds (the same
    work takes more of them when the host's cores are shared), its cores."""
    cpu = (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime)
    return (f"cpu {cpu:.3f} s (sys {ru1.ru_stime - ru0.ru_stime:.3f}), "
            f"cores {len(os.sched_getaffinity(0))}")


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _smi() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip() or "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    args = parse(argv)
    result = run(args)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
