"""Driver entry points: the flagship forward step, the convert step over a
device mesh, and the multi-device dry run.

``entry()`` returns ``(forward, example_args)``: one step of gear candidate
bitmaps over a batch of windows (kernel K1) plus chunk SHA-256 over a
buffer of messages (kernel K2) — the counterpart of the reference
package's ``__graft_entry__.entry()``. ``sharded_convert_step`` and
``dryrun_multichip`` are the counterparts of the reference's functions of
those names: the whole convert step with every shard's K1 and K2 launches
on its own device, and one step of it, with both mesh probes of the
chunk dict, on tiny shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from nydus_snapshotter_tpu_torch.ops import gear, gear_cuda, sha256, sha256_cuda
from nydus_snapshotter_tpu_torch.tensors import resolve_device, to_u32

WINDOW = 1 << 16
MASK_S, MASK_L = 0x3FFF, 0x3FF


def forward(
    windows: torch.Tensor,
    mask_s: int,
    mask_l: int,
    buffer: torch.Tensor,
    offs: torch.Tensor,
    sizes: torch.Tensor,
):
    """-> (bitmap_s int32[B, n/32], bitmap_l int32[B, n/32], digests int32[M, 8])."""
    n = windows.shape[1] - (gear.GEAR_WINDOW - 1)
    bm_s, bm_l = gear_cuda.gear_bitmaps(windows, mask_s, mask_l, n)
    return bm_s, bm_l, sha256_cuda.sha256_chunks(buffer, offs, sizes)


def example_args(
    device: "str | torch.device | None" = None,
    n_win: int = 4,
    win: int = WINDOW,
    n_msgs: int = 8,
    msg_len: int = 1500,
):
    """Seeded inputs for ``forward``: windows u8[n_win, win+31], the masks,
    and n_msgs messages of msg_len bytes laid end to end in one buffer
    (their extents on the host, where ``sha256_chunks`` takes them)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    windows = rng.integers(0, 256, (n_win, win + gear.GEAR_WINDOW - 1), dtype=np.uint8)
    buf = rng.integers(0, 256, -(-n_msgs * msg_len // 16) * 16, dtype=np.uint8)
    offs = np.arange(n_msgs, dtype=np.int32) * msg_len
    sizes = np.full(n_msgs, msg_len, dtype=np.int32)
    return (
        torch.from_numpy(windows).to(dev),
        MASK_S,
        MASK_L,
        torch.from_numpy(buf).to(dev),
        torch.from_numpy(offs),
        torch.from_numpy(sizes),
    )


def entry(device: "str | torch.device | None" = None):
    """(forward, example_args) of the conversion plane's forward step."""
    return forward, example_args(device)


# ---------------------------------------------------------------------------
# The convert step over a device mesh, and its dry run
# ---------------------------------------------------------------------------


def _emit_bootstrap(files: list[bytes], cuts_list, digests_list) -> bytes:
    """Real bootstrap bytes from per-file cuts and digests (models/bootstrap).

    Shared by the sharded convert step and its single-device truth, so a
    byte-identity check of bootstraps reduces exactly to cut and digest
    identity: flags and blob bookkeeping cannot mask a divergence. The
    reference's ``__graft_entry__._emit_bootstrap``, byte for byte.
    """
    import hashlib

    from nydus_snapshotter_tpu_torch.models.bootstrap import (
        BlobRecord,
        Bootstrap,
        ChunkRecord,
        Inode,
    )

    inodes = [Inode(path="/", mode=0o40755)]
    chunks: list[ChunkRecord] = []
    uoff = 0
    blob_hash = hashlib.sha256()
    for i, (data, cuts, digests) in enumerate(zip(files, cuts_list, digests_list)):
        inodes.append(
            Inode(
                path=f"/f{i:04d}",
                mode=0o100644,
                size=len(data),
                chunk_index=len(chunks),
                chunk_count=len(cuts),
            )
        )
        prev = 0
        for cut, digest in zip(cuts, digests):
            size = int(cut) - prev
            chunks.append(
                ChunkRecord(
                    digest=digest,
                    blob_index=0,
                    uncompressed_offset=uoff,
                    compressed_offset=uoff,
                    uncompressed_size=size,
                    compressed_size=size,
                )
            )
            blob_hash.update(digest)
            uoff += size
            prev = int(cut)
    blob = BlobRecord(
        blob_id=blob_hash.hexdigest(),
        compressed_size=uoff,
        uncompressed_size=uoff,
        chunk_count=len(chunks),
    )
    return Bootstrap(chunk_size=0x1000, inodes=inodes, chunks=chunks, blobs=[blob]).to_bytes()


SHARD_WINDOW = 1 << 12  # pass-1 row width of the sharded step (the reference's)


def _window_rows(buf: np.ndarray, total: int, n_devices: int) -> np.ndarray:
    """u8[R, 31 + SHARD_WINDOW]: the corpus in rows, each prefixed by the
    31 bytes before it (row 0 by zeros), R padded with zero rows to a
    multiple of the mesh size."""
    win, tail = SHARD_WINDOW, gear.GEAR_WINDOW - 1
    n_live = -(-total // win)
    body = np.zeros(n_live * win, dtype=np.uint8)
    body[:total] = buf[:total]
    body = body.reshape(n_live, win)
    rows = np.zeros((n_live + (-n_live) % n_devices, tail + win), dtype=np.uint8)
    rows[:n_live, tail:] = body
    rows[1:n_live, :tail] = body[:-1, win - tail :]
    return rows


def _bitmap_positions(words: np.ndarray, total: int) -> np.ndarray:
    """Candidate positions (int64, ascending) of stream-order bitmap words
    u32[R, SHARD_WINDOW / 32], below ``total``."""
    flat = words.reshape(-1)
    sel = np.nonzero(flat)[0]
    bits = np.unpackbits(flat[sel].view(np.uint8).reshape(-1, 4), axis=1, bitorder="little")
    w, b = np.nonzero(bits)
    pos = sel[w].astype(np.int64) * 32 + b
    return pos[pos < total]


def _slab(data: np.ndarray, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(allocation, operand) of one shard's corpus bytes on ``dev``. K2
    reads whole blocks as aligned 16-byte pieces, so the allocation is the
    operand rounded up to 16 bytes with zeros; the operand view is what
    the shard holds of the corpus."""
    n = data.size
    data = np.ascontiguousarray(data)
    alloc = torch.zeros(-(-max(n, 1) // 16) * 16, dtype=torch.uint8, device=dev)
    alloc[:n].copy_(torch.from_numpy(data if data.flags.writeable else data.copy()))
    return alloc, alloc[:n]


def sharded_convert_step(
    files: list[bytes],
    chunk_size: int,
    n_devices: int,
    mesh=None,
    pack: "str | None" = None,
    report: "dict | None" = None,
    stats: "dict | None" = None,
):
    """The whole convert step sharded over the mesh (the reference's
    ``__graft_entry__.sharded_convert_step``).

    Gear bitmaps (4 KiB window rows with their 31-byte seam tails, sharded
    over the mesh: K1 once per shard, per ``gear_cuda.MAX_ROWS`` rows) ->
    host cut resolution (``FusedDeviceEngine.resolve``) -> extent planning
    (ops/mesh_pack: contiguous byte shards + read-span halo) -> SHA-256 of
    every chunk (K2 once per capacity class per shard, over the shard's
    rows) -> bootstrap emit from the merged per-shard batches. Returns
    (cuts_list, digests_list, bootstrap_bytes). ``mesh`` defaults to
    ``make_mesh(n_devices)``, which needs the card.

    ``pack``: "extent" (the default, ``resolve_mesh_config``) gives each
    shard its byte shard plus the halo, at local offsets; "replicated"
    runs the identical partition over the whole corpus (plus the clamp
    guard) copied onto every shard. ``report``, when given, is filled
    with the plan geometry and the per-shard bytes of the corpus operand.
    ``stats``, when given, accumulates wall seconds: ``pass1_s`` (window
    rows, their copies to the shards, K1, bitmap download), ``host_s``
    (candidates, cut resolution, the bucket and extent plans), ``pass2_s``
    (the shards' operands, K2, digest download) and ``emit_s``.
    """
    from time import perf_counter

    from nydus_snapshotter_tpu_torch.ops import fused_convert, mesh_pack
    from nydus_snapshotter_tpu_torch.parallel import mesh as mesh_lib

    if mesh is None:
        mesh = mesh_lib.make_mesh(n_devices)
    if mesh.size != n_devices:
        raise ValueError(f"mesh has {mesh.size} shards, n_devices is {n_devices}")
    cfg = mesh_pack.resolve_mesh_config()
    if pack is None:
        pack = cfg.pack
    if pack not in ("extent", "replicated"):
        raise ValueError(f"unknown pack mode {pack!r} (extent | replicated)")
    eng = fused_convert.FusedDeviceEngine(chunk_size=chunk_size, device=mesh.devices[0])

    table = []
    total = 0
    for f in files:
        table.append((total, len(f)))
        total += len(f)
    buf = np.frombuffer(b"".join(files), dtype=np.uint8)
    if total == 0:
        cuts_list = [np.asarray([], dtype=np.int64) for _ in files]
        digests_list: list[list[bytes]] = [[] for _ in files]
        if report is not None:
            report.update(pack=pack, corpus_bytes=0, max_device_bytes=0)
        return cuts_list, digests_list, _emit_bootstrap(files, cuts_list, digests_list)

    def lap(key: str, t0: float) -> float:
        now = perf_counter()
        if stats is not None:
            stats[key] = stats.get(key, 0.0) + now - t0
        return now

    # pass 1: window rows over the mesh, K1 per shard
    t = perf_counter()
    p = eng.params
    bms: list[tuple[torch.Tensor, torch.Tensor]] = []
    for part in mesh_lib.shard_rows(_window_rows(buf, total, n_devices), mesh):
        for lo in range(0, part.shape[0], gear_cuda.MAX_ROWS):
            bms.append(gear_cuda.gear_bitmaps(
                part[lo : lo + gear_cuda.MAX_ROWS], p.mask_small, p.mask_large, SHARD_WINDOW
            ))
    bm_s = np.concatenate([to_u32(s) for s, _ in bms])
    bm_l = np.concatenate([to_u32(l) for _, l in bms])
    t = lap("pass1_s", t)
    cuts_list = eng.resolve(_bitmap_positions(bm_s, total), _bitmap_positions(bm_l, total), table)

    # pass 2: the extent plan, then K2 per capacity class per shard over the
    # shard's slab (extent) or its whole-corpus copy (replicated)
    buckets, order = eng.plan_buckets(table, cuts_list)
    plan = mesh_pack.plan_mesh_pack(
        buckets, order, total, n_devices,
        halo_bytes=max(eng.max_read_span(), cfg.halo_kib << 10),
    )
    t = lap("host_s", t)
    if pack == "extent":
        packed = mesh_pack.pack_buffers(buf, plan)
        slabs = [_slab(packed[d], dev) for d, dev in enumerate(mesh.devices)]
        del packed
    else:
        whole = np.concatenate([buf, np.zeros(p.max_size + 64, np.uint8)])
        slabs = [_slab(whole, dev) for dev in mesh.devices]
        del whole
    operands = [op for _alloc, op in slabs]
    if report is not None:
        per_dev = mesh_pack.addressable_bytes_per_device(operands)
        report.update(
            pack=pack,
            corpus_bytes=total,
            shard_bytes=plan.shard_bytes,
            halo_bytes=plan.halo_bytes,
            pack_len=plan.pack_len,
            bound_bytes=plan.bound_bytes,
            addressable_bytes_per_device=per_dev,
            max_device_bytes=max(per_dev.values(), default=0),
            buckets=len(plan.buckets),
            rows_padded=sum(
                b.rows_per_device * n_devices - sum(b.counts) for b in plan.buckets
            ),
        )
    if pack == "extent":
        mesh_pack.assert_extent_packed(operands, plan)
    states: dict[int, list[torch.Tensor]] = {}
    for sb in plan.buckets:
        offs = sb.offsets_local if pack == "extent" else sb.offsets_abs
        m = sb.rows_per_device
        states[sb.cap_blocks] = [
            sha256_cuda.sha256_chunks(
                alloc,
                torch.from_numpy(offs[d * m : (d + 1) * m].copy()),
                torch.from_numpy(sb.sizes[d * m : (d + 1) * m].copy()),
            )
            for d, (alloc, _op) in enumerate(slabs)
        ]
    by_cap = {cap: np.concatenate([to_u32(s) for s in parts]) for cap, parts in states.items()}
    del slabs, operands, states
    t = lap("pass2_s", t)

    flat = [sha256.digest_to_bytes(by_cap[cap][row]) for cap, row in plan.order]
    digests_list = []
    pos = 0
    for cuts in cuts_list:
        digests_list.append(flat[pos : pos + len(cuts)])
        pos += len(cuts)
    boot = _emit_bootstrap(files, cuts_list, digests_list)
    lap("emit_s", t)
    return cuts_list, digests_list, boot


def _example_batch(n_win: int, win: int, n_msgs: int):
    """The reference's dry-run inputs from the same seed: windows
    u8[n_win, win + 31] and n_msgs 1500-byte messages."""
    rng = np.random.default_rng(0)
    windows = rng.integers(0, 256, (n_win, win + gear.GEAR_WINDOW - 1), dtype=np.uint8)
    msgs = [rng.integers(0, 256, 1500, dtype=np.uint8).tobytes() for _ in range(n_msgs)]
    return windows, msgs


def _pad_rows(q: np.ndarray, n: int) -> np.ndarray:
    """Zero rows appended to a multiple of ``n`` (a zero digest hashes to
    shard 0; callers slice the answers back)."""
    pad = (-len(q)) % n
    return np.concatenate([q, np.zeros((pad, 8), np.uint32)]) if pad else q


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """One sharded conversion step over an n-device mesh, tiny shapes (the
    reference's ``__graft_entry__.dryrun_multichip``).

    Phase 1: window hashing (K1 per shard) and message digests (K2 per
    shard) over the mesh, and the chunk-dict probe through both mesh
    shapes, routed (all_to_all) and dense (all_gather + sum), which must
    agree. Phase 2: a 64k-entry dict and skewed queries that overflow the
    routed buckets at ``n >= 5``; the dense fallback and ``lookup_u32``
    must equal the native host probe. Phase 3: the full sharded convert
    step on both operand layouts, equal to the single-device host lane.

    ``devices`` defaults to the visible CUDA devices (repeat one to shard
    logically over it, e.g. ``["cuda:0"] * 8``, or ``["cpu"] * 8`` for the
    plain versions on the host).
    """
    import hashlib

    from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine
    from nydus_snapshotter_tpu_torch.parallel import mesh as mesh_lib
    from nydus_snapshotter_tpu_torch.parallel.sharded_dict import (
        ShardedChunkDict,
        _probe_routed,
        _probe_sharded,
    )

    mesh = mesh_lib.make_mesh(n_devices, devices)

    def tables(d: ShardedChunkDict):
        shards, cap, depth = d.device_shards()
        return [k for k, _ in shards], [v for _, v in shards], depth, cap

    # ---- phase 1: hash + digest sharded over the mesh, both probe shapes
    win = 1 << 12
    windows, msgs = _example_batch(2 * n_devices, win, 4 * n_devices)
    for part in mesh_lib.shard_rows(windows, mesh):
        gear_cuda.gear_bitmaps(part, MASK_S, MASK_L, win)
    per_shard = len(msgs) // n_devices
    for d, dev in enumerate(mesh.devices):
        mine = msgs[d * per_shard : (d + 1) * per_shard]
        buf, _op = _slab(np.frombuffer(b"".join(mine), np.uint8), dev)
        offs = torch.arange(len(mine), dtype=torch.int32) * 1500
        got = to_u32(sha256_cuda.sha256_chunks(buf, offs, torch.full_like(offs, 1500)))
        for st, msg in zip(got, mine):
            assert sha256.digest_to_bytes(st) == hashlib.sha256(msg).digest(), (
                "sharded message digest wrong on dry run"
            )

    rng = np.random.default_rng(1)
    dict_digests = rng.integers(0, 2**32, (512, 8), dtype=np.uint32)
    sdict = ShardedChunkDict(dict_digests, mesh)
    queries = np.concatenate(
        [dict_digests[:8], rng.integers(0, 2**32, (8, 8), dtype=np.uint32)]
    )
    q = mesh_lib.shard_rows(_pad_rows(queries, n_devices).view(np.int32), mesh)
    dk, dv, depth, cap = tables(sdict)
    routed, overflowed = _probe_routed(dk, dv, q, n_devices, mesh, depth, cap)
    dense = _probe_sharded(dk, dv, q, n_devices, mesh, depth, cap)
    routed = routed.cpu().numpy()[: len(queries)]
    dense = dense.cpu().numpy()[: len(queries)]
    assert (dense[:8] - 1 == np.arange(8)).all(), "sharded dict probe wrong on dry run"
    assert (dense[8:] == 0).all()
    assert not overflowed.any(), "all_to_all bucket overflow on tiny dry-run shapes"
    assert (routed == dense).all(), "all_to_all probe disagrees with dense fallback"

    # ---- phase 2: a 64k-entry dict and skewed queries that force bucket
    # overflow, so the dense fallback fires and is checked. Every query's
    # word0 is a multiple of n_devices: all route to shard 0, and each
    # shard's bucket for shard 0 overflows its 4x-uniform capacity. With
    # the 4x+8 capacity policy, all-to-one skew overflows only at
    # n_devices >= 5 (m_local * (1 - 4/n) > 8 has no solution below), so
    # the overflow assertion is gated; the equality checks always run.
    can_overflow = n_devices >= 5
    dict2 = rng.integers(0, 2**32, (1 << 16, 8), dtype=np.uint32)
    sdict2 = ShardedChunkDict(dict2, mesh, probe_backend="device")
    host_truth_dict = ShardedChunkDict(dict2, mesh, probe_backend="host")
    hits2 = dict2[dict2[:, 0] % np.uint32(n_devices) == 0][:192]
    misses2 = rng.integers(0, 2**32, (384 - len(hits2), 8), dtype=np.uint32)
    misses2[:, 0] -= misses2[:, 0] % np.uint32(n_devices)
    skewed = np.concatenate([hits2, misses2])
    q2 = mesh_lib.shard_rows(_pad_rows(skewed, n_devices).view(np.int32), mesh)
    dk2, dv2, depth2, cap2 = tables(sdict2)
    _routed2, overflowed2 = _probe_routed(dk2, dv2, q2, n_devices, mesh, depth2, cap2)
    if can_overflow:
        assert overflowed2.any(), (
            "skewed queries were sized to overflow the all_to_all buckets, "
            "but no overflow was reported: the fallback trigger is broken"
        )
    dense2 = _probe_sharded(dk2, dv2, q2, n_devices, mesh, depth2, cap2).cpu().numpy()
    truth = host_truth_dict.lookup_u32(skewed)
    assert (dense2[: len(skewed)].astype(np.int64) - 1 == truth).all(), (
        "dense fallback disagrees with the native host probe on the skewed "
        "64k-dict workload"
    )
    # The entry point survives the overflow (detect, rerun dense) and
    # agrees with the host arm.
    assert (sdict2.lookup_u32(skewed) == truth).all(), (
        "lookup_u32 overflow fallback returned different answers than the host probe"
    )
    assert (truth[: len(hits2)] >= 0).all() and (truth[len(hits2) :] == -1).all()

    # ---- phase 3: the full convert step sharded over the mesh, both
    # operand layouts, against the single-device host lane
    rng3 = np.random.default_rng(3)
    files = []
    for _ in range(2 * n_devices):
        size = int(rng3.integers(1, 6)) * 8192 + int(rng3.integers(0, 997))
        files.append(rng3.integers(0, 256, size, dtype=np.uint8).tobytes())
    chunk_size = 0x1000
    rep: dict = {}
    cuts_sh, digs_sh, boot_sh = sharded_convert_step(
        files, chunk_size, n_devices, mesh, pack="extent", report=rep
    )
    assert rep["max_device_bytes"] <= rep["bound_bytes"], (
        "extent-packed convert left a shard holding more than its shard + halo"
    )
    boot_repl = sharded_convert_step(files, chunk_size, n_devices, mesh, pack="replicated")[2]
    assert boot_repl == boot_sh, "replicated-arm bootstrap diverges from the extent-packed arm"
    oracle = ChunkDigestEngine(chunk_size=chunk_size, backend="numpy", digest_backend="numpy")
    truth3 = oracle.process_many(files)
    cuts_truth = [np.asarray([m.offset + m.size for m in metas], dtype=np.int64) for metas in truth3]
    digs_truth = [[m.digest for m in metas] for metas in truth3]
    for i, (a, b) in enumerate(zip(cuts_sh, cuts_truth)):
        assert (np.asarray(a) == b).all(), f"sharded cuts diverge on file {i}"
    assert digs_sh == digs_truth, "sharded digests diverge from host lane"
    assert boot_sh == _emit_bootstrap(files, cuts_truth, digs_truth), (
        "bootstrap emitted from sharded per-shard batches is not byte-identical "
        "to the single-device bootstrap"
    )
    # the sharded digests also ride the routed dict probe (content hits)
    all_digs = [d for digs in digs_sh for d in digs]
    dict_u32 = np.frombuffer(b"".join(all_digs), dtype="<u4").reshape(-1, 8)
    sdict3 = ShardedChunkDict(dict_u32, mesh, probe_backend="device")
    first_idx: dict[bytes, int] = {}
    for j, d in enumerate(all_digs):
        first_idx.setdefault(d, j)
    want3 = np.asarray([first_idx[d] for d in all_digs])
    assert (sdict3.lookup_digests(all_digs) == want3).all(), "routed probe of sharded digests wrong"

    print(
        f"dryrun_multichip OK: {n_devices}-device mesh {[str(d) for d in mesh.devices]}, "
        f"hash {windows.shape} + digest {len(msgs)} messages + "
        f"{len(queries)}-query dict probe (all_to_all routed == dense); "
        f"64k-entry dict, {len(skewed)} skewed queries "
        + (
            "overflowed the all_to_all buckets and the dense fallback "
            "matched the host probe"
            if can_overflow
            else "ran the skew shape (overflow impossible below 5 devices)"
        )
        + f"; FULL convert step sharded: {len(files)} files -> {len(all_digs)} "
        "chunks, cuts+digests+bootstrap byte-identical to single-device "
        "(extent-packed == replicated == host lane, "
        f"max {rep['max_device_bytes']} B/device <= shard+halo "
        f"{rep['bound_bytes']} B), "
        "probe of all chunk digests resolved first-occurrence indices",
        flush=True,
    )
