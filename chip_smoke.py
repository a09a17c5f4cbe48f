#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, measure.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

0. device — the card's name and power limit as nvidia-smi reports them;
1. build  — nvcc compiles the three kernels of csrc/ in parallel;
2. main path — ``FusedDeviceEngine.process_many`` over a 1 GiB
   node:21-shaped layer (log-normal file sizes, 40/40/20 text/binary/random)
   at 64 KiB average chunks, probing a 2^23-entry chunk dict that holds the
   digests of a third of the layer's files. Launch counters are zeroed just
   before and read just after; every chunk digest is checked against
   hashlib, the cuts of >= 64 MiB of files against the numpy chunker, and
   every probe answer against a host numpy probe;
3. kernels — each kernel against its plain PyTorch version on the card, on
   the main path's inputs (K1 over a 64 MiB slice of the layer buffer, K2
   over one full pass-2 bucket, K3 over every query of phase 2); exact
   equality required;
4. pack — ``pack_layer`` over a ~256 MiB node:21-shaped tar, fused backend
   against the numpy (host) backend: blob, bootstrap and blob id identical;
5. timings — CUDA events, median of 5 runs after a warm-up; end-to-end
   GiB/s of ``process_many`` with its pass1/host/pass2 split, and the
   device's busy share of it from one torch.profiler trace.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import io
import json
import subprocess
import sys
import tarfile
import time

import numpy as np

SEED = 20261016
LAYER_MIB = 1024
PACK_MIB = 256
CHUNK_SIZE = 0x10000
DICT_ENTRIES = 1 << 23
CUT_CHECK_BYTES = 64 << 20
K1_SLICE = 64 << 20
K2_PLAIN_MAX_CAP = 128  # the plain SHA-256 loops in Python per 64-byte block
REPS = 5
DEVICE = "cuda"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
INT32_LANES_PER_SM = 64  # Hopper SM: 4 partitions x 16 INT32 lanes per clock

# Integer operations per unit of work: the fewest the FUNCTION needs on
# this card's instruction set (LOP3 = any 3-input logic op, IADD3 = a
# 3-input add, SHF = a rotate), not what the current kernels issue.
# K1, per position: the 32-term gear sum is the rolling recurrence
# h_i = (h_{i-1} << 1) + g(x_i) — one lookup in the 256-entry gear table
# and one shift-add — plus two mask tests (and + compare each).
K1_OPS_PER_POS = 1 + 1 + 2 * 2
# K2, per 64-byte block: 64 rounds x 14 (S1 and S0: 3 SHF + 1 LOP3 each,
# ch and maj: 1 LOP3 each, t1: 2 IADD3, a: 1 IADD3, e: 1 add), 48 schedule
# steps x 10 (s0 and s1: 2 SHF + 1 shift + 1 LOP3 each, 2 IADD3), 8 state
# adds and one byte swap per message word.
K2_OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8 + 16
# K3, per chain row examined: 8 word compares and the group ballot test.
K3_OPS_PER_ROW = 8 * 2


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# node:21-shaped data (log-normal file sizes, 40/40/20 text/binary/random)
# ---------------------------------------------------------------------------


class FileGen:
    """Seeded synthetic files shaped like a node_modules-heavy image."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self._text = None

    def _text_base(self) -> np.ndarray:
        """1 MiB of word-like ASCII."""
        if self._text is None:
            rng = self.rng
            words = [
                rng.integers(97, 123, int(rng.integers(3, 11)), dtype=np.uint8)
                for _ in range(400)
            ]
            parts = []
            n = 0
            while n < (1 << 20):
                w = words[int(rng.integers(0, len(words)))]
                parts.append(w)
                parts.append(np.frombuffer(b" ", dtype=np.uint8))
                n += len(w) + 1
            self._text = np.concatenate(parts)[: 1 << 20]
        return self._text

    def file(self, size: int, kind: str) -> np.ndarray:
        rng = self.rng
        if kind == "text":
            base = self._text_base()
            reps = -(-size // base.size)
            off = int(rng.integers(0, base.size))
            return np.concatenate([base[off:]] + [base] * reps)[:size]
        if kind == "binary":  # ELF-ish: random bytes with zero runs
            data = rng.integers(0, 256, size, dtype=np.uint8)
            data[rng.random(size) < 0.55] = 0
            return data
        return rng.integers(0, 256, size, dtype=np.uint8)

    def pool(self, total_mib: int) -> list[np.ndarray]:
        total = total_mib << 20
        files = []
        used = 0
        while used < total:
            size = int(np.clip(self.rng.lognormal(8.5, 2.0), 128, 8 << 20))
            r = self.rng.random()
            kind = "text" if r < 0.4 else ("binary" if r < 0.8 else "random")
            files.append(self.file(size, kind))
            used += size
        return files


def layer_tar(files: list[np.ndarray]) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        for fi, data in enumerate(files):
            ti = tarfile.TarInfo(f"layer0/d{fi % 97}/f{fi}.bin")
            ti.size = data.size
            tf.addfile(ti, io.BytesIO(data.tobytes()))
        ti = tarfile.TarInfo("layer0/current")
        ti.type = tarfile.SYMTYPE
        ti.linkname = "d0"
        tf.addfile(ti)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median ms of ``fn`` over ``reps`` runs after one warm-up, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_abs_err(got, want) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def host_probe(keys: np.ndarray, values: np.ndarray, q: np.ndarray, depth: int):
    """numpy probe of the unpadded table -> (answers i32[Q], rows examined)."""
    cap = keys.shape[0]
    slot0 = (q[:, 1] & np.uint32(cap - 1)).astype(np.int64)
    slots = (slot0[:, None] + np.arange(depth)) & (cap - 1)
    vals = values[slots]
    match = (keys[slots] == q[:, None, :]).all(axis=2) & (vals != 0)
    found = match.any(axis=1)
    first = match.argmax(axis=1)
    ans = np.where(found, vals[np.arange(len(q)), first], 0).astype(np.int32)
    rows = np.where(found, first + 1, depth)
    return ans, rows


def device_busy(fn) -> tuple[float, dict[str, float]]:
    """Run ``fn`` under torch.profiler (after one profiled warm-up) ->
    (ms during which the device ran something: the union of its kernel and
    copy intervals, {event name: device ms})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        # CUPTI's own buffer bookkeeping is reported as a device event too
        if e.device_type != DeviceType.CUDA or "Activity Buffer" in e.name:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy_us, edge = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > edge:
            busy_us += end - max(start, edge)
            edge = end
    return busy_us / 1e3, by_name


def bound_ms(nbytes: float, ops: float, int_ops_per_s: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from nydus_snapshotter_tpu_torch.converter import PackOption, pack_layer
        from nydus_snapshotter_tpu_torch.ops import (
            cdc, cuda_build, fused_convert, gear_cuda, probe_cuda, sha256, sha256_cuda,
        )
        from nydus_snapshotter_tpu_torch.parallel import sharded_dict
        from nydus_snapshotter_tpu_torch.tensors import to_u32
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device(DEVICE, 0)
    kernels = {"gear": gear_cuda.KERNEL, "sha": sha256_cuda.KERNEL, "probe": probe_cuda.KERNEL}

    # -- 0. device ---------------------------------------------------------
    smi = nvidia_smi("name,power.limit")
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int_ops_per_s = props.multi_processor_count * INT32_LANES_PER_SM * max_sm_mhz * 1e6
    log(f"[0] device: {name}; {props.multi_processor_count} SMs, max SM clock "
        f"{max_sm_mhz:.0f} MHz -> INT32 peak {int_ops_per_s / 1e12:.2f} Tops/s; "
        f"HBM peak {HBM_BYTES_PER_S / 1e12:.2f} TB/s (data sheet); torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build_all(list(kernels.values()))
    log(f"[1] build: 3 kernels in {time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    for key, k in kernels.items():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas {k.source}: {line.strip()}")

    # -- 2. main path ------------------------------------------------------
    t0 = time.perf_counter()
    files = FileGen(SEED).pool(LAYER_MIB)
    n_bytes = sum(f.size for f in files)
    log(f"[2] layer: {len(files)} files, {n_bytes} bytes "
        f"({n_bytes / 2**30:.3f} GiB), generated in {time.perf_counter() - t0:.1f} s")
    eng = fused_convert.FusedDeviceEngine(chunk_size=CHUNK_SIZE, device=dev)
    first = eng.process_many(files)  # warm-up; its digests seed the dict
    dict_src = np.concatenate(
        [np.frombuffer(b"".join(d), dtype=">u4").astype(np.uint32).reshape(-1, 8)
         for i, d in enumerate(first.digests) if i % 3 == 0 and d]
    )
    # A dict holds each digest once. (The numpy build gives every copy of a
    # digest that loses a slot race its own later slot, so thousands of
    # copies of one chunk — text files share chunks — would exhaust its
    # 64-round bound.)
    _, first_idx = np.unique(
        np.ascontiguousarray(dict_src).view(np.dtype((np.void, 32)))[:, 0], return_index=True
    )
    dict_src = dict_src[np.sort(first_idx)]
    rng = np.random.default_rng(SEED + 1)
    digests = np.concatenate(
        [rng.integers(0, 2**32, (DICT_ENTRIES - len(dict_src), 8), dtype=np.uint32), dict_src]
    )
    t0 = time.perf_counter()
    cdict = sharded_dict.ShardedChunkDict(digests, device=dev)
    keys, values, depth, _epoch = cdict.fused_probe_tables()
    log(f"[2] dict: {len(digests)} entries ({len(dict_src)} unique digests from a third of "
        f"the layer's files), {keys.shape[0]} slots ({keys.nbytes >> 20} MiB of keys), max "
        f"chain {depth}, built in {time.perf_counter() - t0:.1f} s (the build doubles the "
        f"slots past 2x the entries when a chain would outgrow {sharded_dict.MAX_PROBE} rows)")

    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = eng.process_many(files, chunk_dict=cdict)
    main_s = time.perf_counter() - t0
    launches = {key: k.launches for key, k in kernels.items()}
    n_chunks = sum(len(c) for c in res.cuts)
    log(f"[2] main path: {n_chunks} chunks in {main_s:.2f} s (first call with this "
        f"dict, includes its table upload); launches {launches}")
    for key, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {key} was not launched on the main path")

    t0 = time.perf_counter()
    for f, cuts, digs in zip(files, res.cuts, res.digests):
        prev = 0
        for cut, d in zip(cuts, digs):
            if hashlib.sha256(f[prev:int(cut)]).digest() != d:
                raise AssertionError("chunk digest differs from hashlib")
            prev = int(cut)
    checked = 0
    params = cdc.CDCParams(CHUNK_SIZE)
    for f, cuts in zip(files, res.cuts):
        if checked >= CUT_CHECK_BYTES:
            break
        if not np.array_equal(cdc.chunk_data_np(f, params), cuts):
            raise AssertionError("device cuts differ from the numpy chunker")
        checked += f.size
    q_host = np.concatenate(
        [np.frombuffer(b"".join(d), dtype=">u4").astype(np.uint32).reshape(-1, 8)
         for d in res.digests if d]
    )
    want_probe, _ = host_probe(keys, values, q_host, depth)
    if not np.array_equal(res.probe, want_probe):
        raise AssertionError("probe answers differ from the host probe")
    n_hits = int((res.probe > 0).sum())
    if n_hits < len(dict_src):
        raise AssertionError(f"{n_hits} hits < {len(dict_src)} planted digests")
    log(f"[2] checks: {n_chunks} digests == hashlib; cuts == numpy chunker over "
        f"{checked} bytes; {len(q_host)} probe answers == host probe ({n_hits} hits) "
        f"in {time.perf_counter() - t0:.1f} s")

    # -- 3. each kernel against its plain version, main-path inputs --------
    buf, table = eng.layout(files)
    buffer_dev = torch.from_numpy(buf).to(dev)
    cand_s, cand_l = eng.candidates(buffer_dev, n_bytes)
    buckets, _order = eng.plan_buckets(table, eng.resolve(cand_s, cand_l, table))
    p = eng.params
    W, TAIL = fused_convert.WINDOW, fused_convert.TAIL
    main = buffer_dev.view(-1, W)
    rows_full = torch.cat(
        [torch.cat([torch.zeros((1, TAIL), dtype=torch.uint8, device=dev), main[:-1, W - TAIL:]]), main],
        dim=1,
    )
    rows_k1 = rows_full[: K1_SLICE // W].contiguous()
    k1_args = (rows_k1, p.mask_small, p.mask_large, W)
    k1 = gear_cuda.gear_bitmaps(*k1_args)
    k1_plain = gear_cuda.gear_bitmaps_plain(*k1_args)
    k1_err = max(max_abs_err(a, b) for a, b in zip(k1, k1_plain))

    dev_buckets = [
        (b, torch.from_numpy(b.offsets).to(dev), torch.from_numpy(b.sizes).to(dev)) for b in buckets
    ]
    small = [x for x in dev_buckets if x[0].cap_blocks <= K2_PLAIN_MAX_CAP] or dev_buckets
    kb, koffs, ksizes = max(small, key=lambda x: x[0].count)
    k2_args = (buffer_dev, koffs, ksizes)
    k2 = sha256_cuda.sha256_chunks(*k2_args)
    k2_plain = sha256_cuda.sha256_chunks_plain(*k2_args)
    k2_err = max_abs_err(k2, k2_plain)
    k2_host = to_u32(k2)
    for r in np.random.default_rng(SEED + 2).choice(kb.count, min(256, kb.count), replace=False):
        o, s = int(kb.offsets[r]), int(kb.sizes[r])
        if sha256.digest_to_bytes(k2_host[r]) != hashlib.sha256(buf[o:o + s]).digest():
            raise AssertionError("K2 digest differs from hashlib")

    states = [sha256_cuda.sha256_chunks(buffer_dev, o, s) for _b, o, s in dev_buckets]
    allq = torch.cat(states)
    tk, tv = cdict.device_tables()  # the tables the main path probed
    wstart, off = probe_cuda.window_starts(allq, keys.shape[0])
    k3_args = (tk, tv, allq, wstart, off, depth)
    k3 = probe_cuda.probe_padded(*k3_args)
    k3_plain = probe_cuda.probe_padded_plain(*k3_args)
    k3_err = max_abs_err(k3, k3_plain)
    torch.cuda.synchronize()
    for label, err in (("K1", k1_err), ("K2", k2_err), ("K3", k3_err)):
        if err != 0:
            raise AssertionError(f"{label} kernel differs from its plain version (max err {err})")
    log(f"[3] kernels == plain versions: K1 over {rows_k1.shape[0]} x {W} positions; K2 over "
        f"bucket cap {kb.cap_blocks} blocks ({kb.count} chunks + {len(kb.offsets) - kb.count} "
        f"pad rows; 256 sampled == hashlib); K3 over {allq.shape[0]} queries, depth {depth}")

    # -- 4. pack -----------------------------------------------------------
    t0 = time.perf_counter()
    tar = layer_tar(FileGen(SEED + 3).pool(PACK_MIB))
    t_gen = time.perf_counter() - t0
    opt = dict(chunk_size=CHUNK_SIZE, compressor="none")
    t0 = time.perf_counter()
    blob_f, res_f = pack_layer(tar, PackOption(backend="fused", **opt), device=dev)
    t_fused = time.perf_counter() - t0
    t0 = time.perf_counter()
    blob_n, res_n = pack_layer(tar, PackOption(backend="numpy", **opt))
    t_numpy = time.perf_counter() - t0
    if not (blob_f == blob_n and res_f.bootstrap == res_n.bootstrap and res_f.blob_id == res_n.blob_id):
        raise AssertionError("fused and numpy pack_layer outputs differ")
    log(f"[4] pack: {len(tar)} byte tar (built in {t_gen:.1f} s) -> {len(blob_f)} byte layer "
        f"blob, blob id {res_f.blob_id[:16]}..; fused == numpy byte for byte; fused "
        f"{t_fused:.2f} s, numpy {t_numpy:.2f} s")

    # -- 5. timings --------------------------------------------------------
    k1_ms = cuda_ms(lambda: gear_cuda.gear_bitmaps(*k1_args))
    k1_plain_ms = cuda_ms(lambda: gear_cuda.gear_bitmaps_plain(*k1_args))
    k1_main_ms = cuda_ms(lambda: gear_cuda.gear_bitmaps(rows_full, p.mask_small, p.mask_large, W))
    k2_ms = cuda_ms(lambda: sha256_cuda.sha256_chunks(*k2_args))
    k2_plain_ms = cuda_ms(lambda: sha256_cuda.sha256_chunks_plain(*k2_args))
    k2_main_ms = cuda_ms(lambda: [sha256_cuda.sha256_chunks(buffer_dev, o, s) for _b, o, s in dev_buckets])
    k3_ms = cuda_ms(lambda: probe_cuda.probe_padded(*k3_args))
    k3_plain_ms = cuda_ms(lambda: probe_cuda.probe_padded_plain(*k3_args))

    e2e, splits = [], []
    for _ in range(1 + REPS):
        before = dict(eng.stats)
        t0 = time.perf_counter()
        eng.process_many(files, chunk_dict=cdict)
        e2e.append(time.perf_counter() - t0)
        splits.append({k: eng.stats[k] - before[k] for k in ("pass1_s", "host_s", "pass2_s")})
    e2e, splits = e2e[1:], splits[1:]
    e2e_s = float(np.median(e2e))
    split = {k: float(np.median([s[k] for s in splits])) for k in splits[0]}
    log(f"[5] process_many: median {e2e_s:.3f} s over {REPS} runs -> "
        f"{n_bytes / 2**30 / e2e_s:.3f} GiB/s end to end; pass1 {split['pass1_s']:.3f} s, "
        f"host {split['host_s']:.3f} s, pass2 {split['pass2_s']:.3f} s")
    busy_ms, by_name = device_busy(
        lambda: eng.process_many(files, chunk_dict=cdict)
    )
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"[5] device busy {busy_ms:.3f} ms per process_many (torch.profiler: union of kernel "
        f"and copy intervals) = {100 * busy_ms / (e2e_s * 1e3):.1f}% of the median wall time; "
        f"idle {100 - 100 * busy_ms / (e2e_s * 1e3):.1f}%; top: "
        + "; ".join(f"{n[:48]} {ms:.3f} ms" for n, ms in top))

    k1_pos = rows_k1.shape[0] * W
    k1_bound = bound_ms(rows_k1.numel() + 2 * k1_pos / 8, k1_pos * K1_OPS_PER_POS, int_ops_per_s)
    k2_blocks = float(((kb.sizes.astype(np.int64) + 8) // 64 + 1).sum())
    k2_bound = bound_ms(
        float(kb.sizes.astype(np.int64).sum()) + len(kb.sizes) * (8 + 32),
        k2_blocks * K2_OPS_PER_BLOCK, int_ops_per_s,
    )
    q_all = to_u32(allq)
    _, rows_seen = host_probe(keys, values, q_all, depth)
    k3_hits = to_u32(k3).astype(bool)
    k3_bytes = len(q_all) * (32 + 8 + 4) + float(rows_seen.sum()) * 32 + float(k3_hits.sum()) * 4
    k3_bound = bound_ms(k3_bytes, float(rows_seen.sum()) * K3_OPS_PER_ROW, int_ops_per_s)
    n_buckets = len(buckets)
    main_pos = rows_full.shape[0] * W
    k1_main_bound = bound_ms(rows_full.numel() + 2 * main_pos / 8, main_pos * K1_OPS_PER_POS, int_ops_per_s)
    all_sizes = np.concatenate([b.sizes for b in buckets]).astype(np.int64)
    k2_main_bound = bound_ms(
        float(all_sizes.sum()) + len(all_sizes) * (8 + 32),
        float(((all_sizes + 8) // 64 + 1).sum()) * K2_OPS_PER_BLOCK, int_ops_per_s,
    )
    log(f"[5] K1 gear_bitmaps: {k1_ms:.4f} ms over {k1_pos} positions (plain {k1_plain_ms:.3f} ms, "
        f"bound {k1_bound[0]:.4f} ms by {k1_bound[1]}); whole main-path buffer "
        f"{rows_full.shape[0]} x {W}: {k1_main_ms:.4f} ms (bound {k1_main_bound[0]:.4f} ms), "
        f"1 launch per process_many")
    log(f"[5] K2 sha256_chunks: {k2_ms:.4f} ms over bucket cap {kb.cap_blocks} "
        f"({int(k2_blocks)} blocks; plain {k2_plain_ms:.3f} ms, bound {k2_bound[0]:.4f} ms by "
        f"{k2_bound[1]}); all {n_buckets} buckets of one process_many: {k2_main_ms:.4f} ms "
        f"(bound {k2_main_bound[0]:.4f} ms), {n_buckets} launches per process_many")
    log(f"[5] K3 probe_padded: {k3_ms:.4f} ms over {len(q_all)} queries "
        f"({int(rows_seen.sum())} chain rows; plain {k3_plain_ms:.3f} ms, bound "
        f"{k3_bound[0]:.4f} ms by {k3_bound[1]}), 1 launch per process_many")

    def row(key, name, source, replaces, err, ms, plain, bound, main_ms, main_bound, work):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "status": "ported: built, equal to plain, launched on the main path",
            "work": work, "main_path_ms": main_ms, "main_path_bound_ms": main_bound[0],
        }

    pkg = "nydus_snapshotter_tpu_torch/csrc/"
    line = {"kernels": [
        row("gear", "gear_bitmaps", pkg + "gear_bitmaps.cu",
            "nydus_snapshotter_tpu/ops/gear_pallas.py:115", k1_err, k1_ms, k1_plain_ms,
            k1_bound, k1_main_ms, k1_main_bound, f"{rows_k1.shape[0]}x{W} positions"),
        row("sha", "sha256_chunks", pkg + "sha256.cu",
            "nydus_snapshotter_tpu/ops/sha256_pallas.py:125", k2_err, k2_ms, k2_plain_ms,
            k2_bound, k2_main_ms, k2_main_bound, f"bucket cap {kb.cap_blocks}: {len(kb.sizes)} rows, {int(k2_blocks)} blocks"),
        row("probe", "probe_padded", pkg + "probe.cu",
            "nydus_snapshotter_tpu/ops/probe_pallas.py:151", k3_err, k3_ms, k3_plain_ms,
            k3_bound, k3_ms, k3_bound, f"{len(q_all)} queries, depth {depth}"),
    ]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
