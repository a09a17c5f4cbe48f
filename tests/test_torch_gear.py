"""Gear bitmaps and cuts of the PyTorch port against the JAX package.

Same inputs, made from numpy seeds, go through the reference's functions
(the Pallas kernel in interpret mode, its XLA twin, the byte-sequential
FastCDC oracle) and through the port's plain versions (the CPU path of
ops/gear_cuda.gear_bitmaps). Outputs are integers: equality is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nydus_snapshotter_tpu.ops import cdc as jcdc
from nydus_snapshotter_tpu.ops import gear as jgear
from nydus_snapshotter_tpu.ops import gear_pallas
from nydus_snapshotter_tpu.ops.chunker import _hash_bitmaps_kernel as j_hash_bitmaps
from nydus_snapshotter_tpu_torch.ops import cdc, chunker, gear, gear_cuda
from nydus_snapshotter_tpu_torch.ops.fused_convert import FusedDeviceEngine
from nydus_snapshotter_tpu_torch.tensors import to_u32

RNG_SEED = 20261016
TAIL = 31


def _u32(t):
    return to_u32(t)


class TestGearPrimitives:
    def test_mix32_matches_table(self):
        got = gear.mix32_torch(torch.arange(256)).numpy().astype(np.uint32)
        assert np.array_equal(got, jgear.gear_table())
        assert np.array_equal(gear.gear_table(), jgear.gear_table())

    def test_windowed_sum_matches_numpy_hashes(self):
        rng = np.random.default_rng(RNG_SEED)
        data = rng.integers(0, 256, 5000, dtype=np.uint8)
        x = np.concatenate([np.zeros(31, np.uint8), data])
        h = gear.windowed_gear_sum(gear.mix32_torch(torch.from_numpy(x)))[31:]
        assert np.array_equal(h.numpy().astype(np.uint32), jgear.gear_hashes_np(data))


class TestBitmaps:
    def test_plain_matches_pallas_interpret(self):
        """The K1 oracle against the TPU kernel itself (interpret mode), at
        two of its grid steps per row."""
        rng = np.random.default_rng(RNG_SEED + 1)
        n = gear_pallas.LANES * gear_pallas.ROWS_PER_TILE * 2
        x = rng.integers(0, 256, (2, n + 31), dtype=np.uint8)
        ms, ml = 0x3FFF, 0x3FF
        ps, pl_ = gear_pallas.gear_bitmaps(jnp.asarray(x), ms, ml, n, interpret=True)
        gs, gl = gear_cuda.gear_bitmaps(torch.from_numpy(x), ms, ml, n)
        assert np.array_equal(_u32(gs), np.asarray(ps))
        assert np.array_equal(_u32(gl), np.asarray(pl_))

    @pytest.mark.parametrize("rows,n", [(3, 4064), (1, 32), (2, 96 * 32)])
    def test_plain_matches_xla_kernel_off_tile(self, rows, n):
        """Sizes that are no tile multiple of either kernel."""
        rng = np.random.default_rng(RNG_SEED + n)
        x = rng.integers(0, 256, (rows, n + 31), dtype=np.uint8)
        ms, ml = 0xFFF, 0x3F
        rs, rl = j_hash_bitmaps(jnp.asarray(x), jnp.uint32(ms), jnp.uint32(ml), n)
        gs, gl = gear_cuda.gear_bitmaps(torch.from_numpy(x), ms, ml, n)
        assert np.array_equal(_u32(gs), np.asarray(rs))
        assert np.array_equal(_u32(gl), np.asarray(rl))
        ps, pl_ = chunker._hash_bitmaps_kernel(torch.from_numpy(x), ms, ml, n)
        assert np.array_equal(_u32(gs), _u32(ps)) and np.array_equal(_u32(gl), _u32(pl_))

    def test_zero_prefix_hashes_byte_zero(self):
        """Positions before the stream start hash byte 0, whose gear value
        mix32(0) is not 0: a zero-prefixed row must reproduce the
        whole-stream hashes in its first 31 positions."""
        rng = np.random.default_rng(RNG_SEED + 2)
        data = rng.integers(0, 256, 256, dtype=np.uint8)
        x = np.concatenate([np.zeros(31, np.uint8), data])[None, :]
        mask = 0x1  # ~half of positions are candidates: sensitive to every hash
        bs, _ = gear_cuda.gear_bitmaps(torch.from_numpy(x), mask, mask, 256)
        want = (jgear.gear_hashes_np(data) & np.uint32(mask)) == 0
        got = chunker._unpack_positions(_u32(bs)[0], 256)
        assert np.array_equal(got, np.nonzero(want)[0])

    def test_wrapper_validates_shape(self):
        x = torch.zeros((1, 64 + 30), dtype=torch.uint8)
        with pytest.raises(ValueError):
            gear_cuda.gear_bitmaps(x, 1, 1, 64)
        with pytest.raises(ValueError):
            gear_cuda.gear_bitmaps(torch.zeros((1, 40 + 31), dtype=torch.uint8), 1, 1, 40)


def _runs_model(x: np.ndarray, mask_s: int, mask_l: int, n: int, run: int):
    """numpy model of K1's schedule: each run of ``run`` positions starts
    31 bytes before its first position with h = 0 and steps
    h = (h << 1) + mix32(x) — the rolling recurrence, not the 32-term sum.
    x u8[B, n+31] -> (u32[B, n/32], u32[B, n/32])."""
    g = jgear.gear_table()[x]  # uint32[B, n+31]
    starts = np.arange(0, n, run)
    h = np.zeros((x.shape[0], starts.size), np.uint32)
    hits_s = np.zeros((x.shape[0], n), bool)
    hits_l = np.zeros((x.shape[0], n), bool)
    for k in range(run + TAIL):
        byte = np.minimum(starts + k, n + TAIL - 1)  # past the row: never kept
        h = (h << np.uint32(1)) + g[:, byte]
        if k < TAIL:
            continue
        pos = starts + k - TAIL
        keep = pos < n
        hits_s[:, pos[keep]] = (h[:, keep] & np.uint32(mask_s)) == 0
        hits_l[:, pos[keep]] = (h[:, keep] & np.uint32(mask_l)) == 0

    def pack(hits):
        return np.packbits(hits, axis=1, bitorder="little").view("<u4").astype(np.uint32)

    return pack(hits_s), pack(hits_l)


class TestRunRecurrence:
    """K1 runs the recurrence over runs of ``gear_cuda.RUN`` positions; the
    identity it relies on, held against the reference's hashes and its
    Pallas kernel on rows cut from one stream (seams between rows)."""

    @pytest.mark.parametrize("kind", ["random", "resonant"])
    def test_runs_match_gear_hashes_and_pallas(self, kind):
        from nydus_snapshotter_tpu.scenario.corpus import cdc_resonant_data

        rows = 3
        run = gear_cuda.RUN
        n = 32 * (gear_pallas.LANES * gear_pallas.ROWS_PER_TILE // 32 - 3)
        assert n % 32 == 0 and n % run != 0
        n_pallas = gear_pallas.LANES * gear_pallas.ROWS_PER_TILE
        size = (rows - 1) * n + n_pallas
        params = cdc.CDCParams(CHUNK)
        ms, ml = params.mask_small, params.mask_large
        if kind == "random":
            stream = np.random.default_rng(RNG_SEED + 7).integers(0, 256, size, dtype=np.uint8)
        else:  # every min_size unit ends in a small-mask hit
            stream = np.frombuffer(cdc_resonant_data(5, size, CHUNK, "min"), np.uint8)
        padded = np.concatenate([np.zeros(TAIL, np.uint8), stream])
        # row i = the 31 bytes before stream[i*n] + the row's own bytes
        x = np.stack([padded[i * n : i * n + n + TAIL] for i in range(rows)])
        xp = np.stack([padded[i * n : i * n + n_pallas + TAIL] for i in range(rows)])

        got_s, got_l = _runs_model(x, ms, ml, n, run)
        hashes = jgear.gear_hashes_np(stream[: rows * n]).reshape(rows, n)
        want_s = np.packbits((hashes & np.uint32(ms)) == 0, axis=1, bitorder="little").view("<u4")
        want_l = np.packbits((hashes & np.uint32(ml)) == 0, axis=1, bitorder="little").view("<u4")
        assert np.array_equal(got_s, want_s) and np.array_equal(got_l, want_l)
        assert want_s.any()
        ps, pl_ = gear_pallas.gear_bitmaps(jnp.asarray(xp), ms, ml, n_pallas, interpret=True)
        assert np.array_equal(got_s, np.asarray(ps)[:, : n // 32])
        assert np.array_equal(got_l, np.asarray(pl_)[:, : n // 32])
        # and the port's plain version, at the kernel's shape
        gs, gl = gear_cuda.gear_bitmaps(torch.from_numpy(x), ms, ml, n)
        assert np.array_equal(_u32(gs), got_s) and np.array_equal(_u32(gl), got_l)


def _corpus(kind: str, size: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    if kind == "repeat":
        base = rng.integers(0, 256, 997, dtype=np.uint8)
        return np.tile(base, size // 997 + 1)[:size].tobytes()
    if kind == "text":
        return rng.integers(32, 127, size, dtype=np.uint8).tobytes()
    return bytes(size)  # zeros: no content cut, every cut forced at max_size


CHUNK = 0x1000  # small average so small corpora give many chunks


class TestCuts:
    @pytest.mark.parametrize("kind", ["random", "repeat", "text", "zeros"])
    def test_chunk_data_np_matches_sequential_reference(self, kind):
        data = _corpus(kind, 60_000, seed=len(kind))
        params = cdc.CDCParams(CHUNK)
        want = jcdc.chunk_sequential_reference(data, jcdc.CDCParams(CHUNK))
        assert np.array_equal(cdc.chunk_data_np(data, params), want)
        assert np.array_equal(cdc.chunk_sequential_reference(data, params), want)

    def test_engine_cuts_match_sequential_reference(self):
        """Whole-batch device cuts (CPU plain path) equal the per-file
        byte-sequential oracle on every corpus kind at once."""
        streams = [
            _corpus(k, s, seed=i)
            for i, (k, s) in enumerate(
                [("random", 50_000), ("repeat", 33_333), ("text", 20_001), ("zeros", 40_000), ("random", 7)]
            )
        ]
        res = FusedDeviceEngine(chunk_size=CHUNK, device="cpu").process_many(streams)
        for s, cuts in zip(streams, res.cuts):
            want = jcdc.chunk_sequential_reference(s, jcdc.CDCParams(CHUNK))
            assert np.array_equal(cuts, want)
