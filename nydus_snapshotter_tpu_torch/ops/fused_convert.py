"""Fused device full-path convert: gear -> cuts -> digest -> dict probe.

The layer's files are laid out in one buffer, uploaded to the device once,
and never come back; only kilobytes of metadata cross between the phases:

- **Pass 1.** Gear candidate bitmaps over the whole buffer (kernel K1,
  ops/gear_cuda.py), then on-device compaction: the nonzero bitmap words
  and their indices (``torch.nonzero``), checked against a static
  capacity. The host gets the candidate words, not the N/32-byte bitmaps.
- **Host middle.** FastCDC cut resolution over the sparse candidates per
  file (ops/cdc.resolve_cuts) and the chunk extents in stream order.
- **Pass 2.** The digest of every chunk, read straight from the device
  buffer by (offset, size), in one pass: SHA-256 (kernel K2,
  ops/sha256_cuda.py, one launch) or BLAKE3 (kernel K4, ops/blake3_cuda.py,
  a leaf launch and a tree launch); then the chunk-dict probe over every
  digest (kernel K3, ops/probe_cuda.py), whose keys are the digester's
  words (big-endian for SHA-256, little-endian for BLAKE3). The host gets
  32 B of digest and 4 B of dict answer per chunk.

Replaces the one-process hot loop of the reference's ``nydus-image
create`` (chunk + digest + dedup inside pkg/converter/tool/builder.go:148-178;
the chunk-dict probe at builder.go:122-123). Port of the reference
package's ops/fused_convert.py: same plan, cuts, digests and probe answers.
"""

from __future__ import annotations

from dataclasses import dataclass
from time import perf_counter
from typing import TYPE_CHECKING

import numpy as np
import torch

from nydus_snapshotter_tpu_torch import trace
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics
from nydus_snapshotter_tpu_torch.ops import (
    blake3, blake3_cuda, cdc, gear, gear_cuda, probe_cuda, sha256, sha256_cuda,
)
from nydus_snapshotter_tpu_torch.tensors import resolve_device, to_u32

if TYPE_CHECKING:
    from nydus_snapshotter_tpu_torch.parallel.sharded_dict import ShardedChunkDict

WINDOW = 1 << 22  # pass-1 hash window
TAIL = gear.GEAR_WINDOW - 1
# Chunk offsets travel as int32: a batch's padded buffer stays below this.
MAX_BATCH_PAD = 1 << 31


class FusedOverflow(RuntimeError):
    """Candidate compaction capacity exceeded (pathological input), or a
    batch beyond int32 chunk addressing. Callers refuse the input or split
    the batch (:meth:`FusedDeviceEngine.split_batches`); they never finish
    the work on the host under the device backend's name."""


_reg = _metrics.default_registry
_DISPATCHES = _reg.register(
    _metrics.Counter("ntpu_fused_convert_dispatches", "Fused device convert batches dispatched")
)
_BYTES = _reg.register(
    _metrics.Counter("ntpu_fused_convert_bytes", "Bytes processed by fused device convert batches")
)
_STAGE_SECONDS = _reg.register(
    _metrics.Counter(
        "ntpu_fused_convert_stage_seconds", "Wall seconds per fused-convert stage", ("stage",)
    )
)
_STAGES = {
    k: _STAGE_SECONDS.labels(k)
    for k in ("pass1_gear", "pass1_layout", "pass1_upload", "host_resolve", "pass2_digest")
}


def _record_dispatch(n_bytes: int, pass1_s: float, layout_s: float, upload_s: float,
                     host_s: float, pass2_s: float) -> None:
    """Fused-convert stage counters next to the pipeline's
    (ntpu_convert_pipeline_*): pass1_gear = layout, upload and K1 with the
    candidate compaction, of which pass1_layout is the layout and
    pass1_upload the host-to-device copy; host_resolve = cut resolution and
    chunk extents (the host arm between the passes); pass2_digest = digests
    (K2 or K4), the probe (K3) and the download."""
    _DISPATCHES.inc()
    _BYTES.inc(n_bytes)
    _STAGES["pass1_gear"].inc(pass1_s)
    _STAGES["pass1_layout"].inc(layout_s)
    _STAGES["pass1_upload"].inc(upload_s)
    _STAGES["host_resolve"].inc(host_s)
    _STAGES["pass2_digest"].inc(pass2_s)


def chunk_digests(
    digester: str, buffer: torch.Tensor, offs: torch.Tensor, sizes: torch.Tensor
) -> torch.Tensor:
    """int32[M, 8] state words of every chunk: K2 for SHA-256, K4 for BLAKE3
    (same argument contract, ops/sha256_cuda.check_chunk_args)."""
    if digester == "blake3":
        return blake3_cuda.blake3_chunks(buffer, offs, sizes)
    return sha256_cuda.sha256_chunks(buffer, offs, sizes)


def state_bytes(words: np.ndarray, digester: str) -> bytes:
    """u32[M, 8] state words -> M raw 32-byte digests, concatenated. SHA-256
    states are big-endian words of the digest, BLAKE3's little-endian."""
    return words.astype("<u4" if digester == "blake3" else ">u4").tobytes()


def _pow2_ceil(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _wcap_for(n: int, density_bits: int, floor: int = 1024) -> int:
    """Static candidate-word capacity: 4x the expected count for a
    2^-density_bits per-position hit rate, floored."""
    expected = max(1, n >> density_bits)
    return _pow2_ceil(max(floor, 4 * expected))


# ---------------------------------------------------------------------------
# Pass 1: gear bitmaps + on-device candidate compaction
# ---------------------------------------------------------------------------


def _pass1(buffer: torch.Tensor, n: int, mask_s: int, mask_l: int):
    """buffer u8[NP] (NP % WINDOW == 0), n valid bytes ->
    ((sel_s int64[nw_s], words_s int32[nw_s]), (sel_l, words_l)).

    sel_* are the ascending indices of the nonzero candidate words among
    the first ceil(n/32) words (window padding past ``n`` would otherwise
    flood the capacity with phantom candidates), words_* their raw bits.
    """
    npad = buffer.numel()
    b = npad // WINDOW
    # windows with 31-byte seam-carry tails (row i prefixed by the last 31
    # bytes of row i-1; row 0 by zero BYTES — positions < min_size are never
    # judged, so they can't reach a resolved cut)
    main = buffer.view(b, WINDOW)
    tails = torch.cat(
        [torch.zeros((1, TAIL), dtype=torch.uint8, device=buffer.device),
         main[:-1, WINDOW - TAIL :]],
        dim=0,
    )
    rows = torch.cat([tails, main], dim=1)  # u8[B, TAIL + WINDOW]
    bm_s, bm_l = gear_cuda.gear_bitmaps(rows, mask_s, mask_l, WINDOW)
    nvalid = (n + 31) // 32

    def compact(bm: torch.Tensor):
        words = bm.reshape(-1)[:nvalid]
        sel = torch.nonzero(words).reshape(-1)
        return sel, words[sel]

    return compact(bm_s), compact(bm_l)


# ---------------------------------------------------------------------------
# Pass 2 plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Bucket:
    """One power-of-two capacity class (SHA-256 blocks or BLAKE3 leaves) of
    the reference's pass-2 plan.

    offsets/sizes are pow2-padded (padding rows have size 0 and offset 0
    and are discarded on assembly); ``count`` is the live prefix.
    """

    cap_blocks: int
    offsets: np.ndarray  # i32[M] absolute byte offsets into the buffer
    sizes: np.ndarray  # i32[M]
    count: int


@dataclass(frozen=True)
class FusedResult:
    """Per-stream chunk extents/digests + optional dict-probe hits."""

    cuts: list[np.ndarray]  # per-stream exclusive cut ends
    digests: list[list[bytes]]  # per-stream raw 32-B digests (the engine's digester)
    probe: np.ndarray | None  # i32 over all chunks in stream order (0=miss)


class FusedDeviceEngine:
    """Full-path device convert for a batch of per-file streams.

    Per-file CDC with the engine's CDCParams and a per-chunk digest
    (``digester`` ``sha256`` or ``blake3``), run as two device passes with
    the host middle between them. ``chunk_dict``
    (a parallel/sharded_dict.ShardedChunkDict on the engine's device) adds
    the dedup probe to pass 2. ``stats`` accumulates batches, bytes and the
    wall seconds of pass 1 (gear + compaction + candidate download), the
    host middle (cut resolution + chunk extents) and pass 2 (digest + probe
    + result download).
    """

    def __init__(
        self,
        chunk_size: int = 0x100000,
        device: "str | torch.device | None" = None,
        digester: str = "sha256",
    ):
        if digester not in ("sha256", "blake3"):
            raise ValueError(f"unknown digester {digester!r}")
        self.device = resolve_device(device)
        self.params = cdc.CDCParams(chunk_size)
        self.digester = digester
        self.stats = {"batches": 0, "bytes": 0, "pass1_s": 0.0, "host_s": 0.0, "pass2_s": 0.0}

    # -- planning ------------------------------------------------------------

    def _blocks_of(self, size: int) -> int:
        """Capacity units of one chunk in the reference's plan: SHA-256
        padded blocks, or BLAKE3 leaves."""
        if self.digester == "blake3":
            return blake3.n_leaves(size)
        return sha256.n_padded_blocks(size)

    def max_read_span(self) -> int:
        """Largest gather span of the reference's pass 2 for this engine's
        largest chunk, in bytes."""
        if self.digester == "blake3":
            return self._blocks_of(self.params.max_size) * blake3.LEAF_BYTES
        return self._blocks_of(self.params.max_size) * 64

    def padded_size(self, total: int) -> int:
        """Bytes of the device buffer that holds ``total`` bytes of streams:
        a window multiple with one max-chunk guard, quantized to 1/8-pow2
        steps (the reference's plan, kept so both packages lay out
        identical buffers)."""
        guard = self.params.max_size + 64
        npad = -(-max(1, total + guard) // WINDOW) * WINDOW
        step = max(WINDOW, _pow2_ceil(npad) // 8)
        return -(-npad // step) * step

    def split_batches(self, sizes: list[int]) -> list[range]:
        """Consecutive index ranges of streams whose padded buffer stays
        below ``MAX_BATCH_PAD``. Per-file cuts and digests do not depend on
        the batch, so processing the ranges one by one gives the result of
        one batch. A single stream too large for any batch raises
        :class:`FusedOverflow`."""
        out = []
        start, total = 0, 0
        for i, size in enumerate(sizes):
            if self.padded_size(size) >= MAX_BATCH_PAD:
                raise FusedOverflow(
                    f"stream of {size} bytes pads beyond int32 chunk addressing"
                )
            if i > start and self.padded_size(total + size) >= MAX_BATCH_PAD:
                out.append(range(start, i))
                start, total = i, 0
            total += size
        if start < len(sizes):
            out.append(range(start, len(sizes)))
        return out

    def layout(self, arrs: list[np.ndarray]) -> tuple[np.ndarray, list[tuple[int, int]]]:
        """Concatenate streams; returns (buffer, [(offset, length)])."""
        table = []
        total = 0
        for a in arrs:
            table.append((total, a.size))
            total += a.size
        npad = self.padded_size(total)
        if npad >= MAX_BATCH_PAD:
            raise FusedOverflow(
                f"batch of {total} bytes pads to {npad} — beyond int32 "
                "chunk addressing; split the batch (split_batches)"
            )
        buf = np.zeros(npad, dtype=np.uint8)
        pos = 0
        for a in arrs:
            buf[pos : pos + a.size] = a
            pos += a.size
        return buf, table

    def resolve(
        self,
        cand_s: np.ndarray,
        cand_l: np.ndarray,
        table: list[tuple[int, int]],
    ) -> list[np.ndarray]:
        """Per-file cut resolution over the global candidate arrays.

        Candidates judged per file always sit >= min_size-1 >= 31 bytes
        past the file start, where the 32-byte gear window lies entirely
        inside the file — so global (concatenated) hashing resolves to
        bit-identical per-file cuts.
        """
        cuts = []
        for off, length in table:
            if length == 0:
                cuts.append(np.asarray([], dtype=np.int64))
                continue
            lo_s, hi_s = np.searchsorted(cand_s, [off, off + length])
            lo_l, hi_l = np.searchsorted(cand_l, [off, off + length])
            cuts.append(
                cdc.resolve_cuts(
                    cand_s[lo_s:hi_s] - off,
                    cand_l[lo_l:hi_l] - off,
                    length,
                    self.params,
                )
            )
        return cuts

    def chunk_extents(
        self, table: list[tuple[int, int]], cuts: list[np.ndarray]
    ) -> np.ndarray:
        """int32[2, M]: the absolute offset and the size of every chunk,
        in stream order (pass 2's rows; ``layout`` keeps them in int32)."""
        offs, sizes = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
        for (f_off, _f_len), f_cuts in zip(table, cuts):
            ends = np.asarray(f_cuts, np.int64)
            starts = np.concatenate([[0], ends])[:-1]
            offs.append(f_off + starts)
            sizes.append(ends - starts)
        return np.stack([np.concatenate(offs), np.concatenate(sizes)]).astype(np.int32)

    def plan_buckets(
        self, table: list[tuple[int, int]], cuts: list[np.ndarray]
    ) -> tuple[list[Bucket], list[tuple[int, int]]]:
        """The reference's pass-2 plan: chunks bucketed by pow2 capacity
        class (:meth:`_blocks_of`) with EXACT counts.

        Returns (buckets, flat chunk order) where the flat order is
        (bucket cap, row) per chunk in stream order. The port's pass 2
        digests every chunk in one launch and does not use the plan; it is
        kept to hold the port's chunk rows against the reference's plan.
        """
        max_blocks = self._blocks_of(self.params.max_size)
        per_class: dict[int, list[tuple[int, int]]] = {}
        order: list[tuple[int, int]] = []
        for (f_off, _f_len), f_cuts in zip(table, cuts):
            prev = 0
            for cut in f_cuts:
                size = int(cut) - prev
                cap = min(_pow2_ceil(self._blocks_of(size)), max_blocks)
                rows = per_class.setdefault(cap, [])
                order.append((cap, len(rows)))
                rows.append((f_off + prev, size))
                prev = int(cut)
        buckets = []
        for cap in sorted(per_class):
            rows = per_class[cap]
            m = _pow2_ceil(len(rows))
            offs = np.zeros(m, dtype=np.int32)
            sizes = np.zeros(m, dtype=np.int32)
            offs[: len(rows)] = [r[0] for r in rows]
            sizes[: len(rows)] = [r[1] for r in rows]
            buckets.append(Bucket(cap, offs, sizes, len(rows)))
        return buckets, order

    # -- execution -----------------------------------------------------------

    def candidates(self, buffer_dev: torch.Tensor, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Pass 1 on an already-device-resident buffer -> host candidate
        positions (int64, ascending) for the small and large masks."""
        p = self.params
        wcap_s = _wcap_for(n, p.bits + 2)
        wcap_l = _wcap_for(n, p.bits - 2)
        (sel_s, got_s), (sel_l, got_l) = _pass1(buffer_dev, n, p.mask_small, p.mask_large)
        nw_s, nw_l = sel_s.numel(), sel_l.numel()
        if nw_s > wcap_s or nw_l > wcap_l:
            raise FusedOverflow(
                f"candidate words {nw_s}/{nw_l} exceed caps {wcap_s}/{wcap_l}"
            )

        def host_pos(sel: torch.Tensor, got: torch.Tensor) -> np.ndarray:
            # expand word index + bitmap word to int64 byte positions
            sel_np = sel.cpu().numpy().astype(np.int64)
            bits = np.unpackbits(
                to_u32(got).view(np.uint8).reshape(-1, 4), axis=1, bitorder="little"
            )  # [nw, 32]
            widx, bit = np.nonzero(bits)
            pos = sel_np[widx] * 32 + bit
            return pos[pos < n]

        return host_pos(sel_s, got_s), host_pos(sel_l, got_l)

    def digest_probe(
        self,
        buffer_dev: torch.Tensor,
        extents: np.ndarray,
        chunk_dict: "ShardedChunkDict | None" = None,
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Pass 2 over the chunk extents int32[2, M] (:meth:`chunk_extents`):
        digest states int32[M, 8] from one pass of K2 (SHA-256) or K4
        (BLAKE3) over every chunk, and the optional dict probe int32[M] over
        them.

        The dict owns its padded device tables and the geometry they were
        padded for (restaged once after each insert or rebuild, never
        cached here), so repeated batches never re-upload them and a grown
        dict is probed whole.
        """
        offs, sizes = torch.from_numpy(extents)
        states = chunk_digests(self.digester, buffer_dev, offs, sizes)
        probe = None
        if chunk_dict is not None:
            if chunk_dict.device != self.device:
                raise ValueError(
                    f"chunk dict lives on {chunk_dict.device}, the engine on {self.device}"
                )
            tk, tv, cap, depth = chunk_dict.device_snapshot()
            wstart, off = probe_cuda.window_starts(states, cap)
            probe = probe_cuda.probe_padded(tk, tv, states, wstart, off, depth)
        return states, probe

    def process_many(
        self,
        streams: list[bytes | np.ndarray],
        chunk_dict: "ShardedChunkDict | None" = None,
    ) -> FusedResult:
        from nydus_snapshotter_tpu_torch import failpoint

        # The device batch boundary: an injected error propagates out of
        # Pack (only FusedOverflow falls back to the windowed lane).
        failpoint.hit("fused.dispatch")
        arrs = [
            np.frombuffer(s, dtype=np.uint8) if isinstance(s, (bytes, bytearray)) else s
            for s in streams
        ]
        n = sum(a.size for a in arrs)
        if n == 0:
            return FusedResult(
                cuts=[np.asarray([], dtype=np.int64) for _ in arrs],
                digests=[[] for _ in arrs],
                probe=np.zeros(0, np.int32) if chunk_dict is not None else None,
            )
        t0 = perf_counter()
        with trace.span("fused.pass1", bytes=n, streams=len(arrs)):
            buf, table = self.layout(arrs)
            t_up = perf_counter()
            buffer_dev = torch.from_numpy(buf).to(self.device)
            t_k1 = perf_counter()
            cand_s, cand_l = self.candidates(buffer_dev, n)
        t1 = perf_counter()
        with trace.span("fused.host_resolve"):
            cuts = self.resolve(cand_s, cand_l, table)
            extents = self.chunk_extents(table, cuts)
        t2 = perf_counter()
        with trace.span("fused.pass2", chunks=extents.shape[1]):
            states, probe = self.digest_probe(buffer_dev, extents, chunk_dict)
            raw = state_bytes(to_u32(states), self.digester)
            probe_np = probe.cpu().numpy().astype(np.int32) if probe is not None else None
        t3 = perf_counter()
        self.stats["batches"] += 1
        self.stats["bytes"] += n
        self.stats["pass1_s"] += t1 - t0
        self.stats["host_s"] += t2 - t1
        self.stats["pass2_s"] += t3 - t2
        _record_dispatch(n, t1 - t0, t_up - t0, t_k1 - t_up, t2 - t1, t3 - t2)

        out_digests: list[list[bytes]] = []
        pos = 0
        for f_cuts in cuts:
            out_digests.append([raw[32 * i : 32 * i + 32] for i in range(pos, pos + len(f_cuts))])
            pos += len(f_cuts)
        return FusedResult(cuts=cuts, digests=out_digests, probe=probe_np)
