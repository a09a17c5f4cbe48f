"""Chunk SHA-256 of the PyTorch port against the JAX package and hashlib.

The port's plain versions (the CPU path of ops/sha256_cuda.sha256_chunks)
take the same numpy-seeded inputs as the reference's Pallas SHA-256 kernel
in interpret mode and its gather/pad front end. Outputs are integers and
bytes: equality is exact.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nydus_snapshotter_tpu.ops import sha256 as jsha
from nydus_snapshotter_tpu.ops.fused_convert import _gather_pack_sha as j_gather_pack_sha
from nydus_snapshotter_tpu.ops.sha256_pallas import sha256_batch_pallas
from nydus_snapshotter_tpu_torch.ops import sha256, sha256_cuda
from nydus_snapshotter_tpu_torch.tensors import from_u32, to_u32

RNG = np.random.default_rng(31)


def _messages() -> list[bytes]:
    # the message set of the reference's Pallas SHA test, plus the sizes
    # around the one-block / two-block padding edges
    msgs = [
        b"",
        b"abc",
        b"a" * 63,
        b"b" * 64,
        b"c" * 65,
        RNG.integers(0, 256, 1000, dtype=np.uint8).tobytes(),
        RNG.integers(0, 256, 4096, dtype=np.uint8).tobytes(),
    ]
    msgs += [RNG.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (55, 56, 63, 64, 119, 120)]
    return msgs


class TestSha256Batch:
    def test_plain_matches_pallas_interpret_and_hashlib(self):
        msgs = _messages()
        blocks, counts = jsha.pack_messages_np(msgs, block_capacity=66)
        pblocks, pcounts = sha256.pack_messages_np(msgs, block_capacity=66)
        assert np.array_equal(blocks, pblocks) and np.array_equal(counts, pcounts)
        want = np.asarray(
            sha256_batch_pallas(jnp.asarray(blocks), jnp.asarray(counts), interpret=True)
        )
        got = to_u32(sha256.sha256_batch(from_u32(blocks, torch.device("cpu")), torch.from_numpy(counts)))
        assert np.array_equal(got, want)
        for i, m in enumerate(msgs):
            assert sha256.digest_to_bytes(got[i]) == hashlib.sha256(m).digest()


def _odd_extents(seed: int):
    rng = np.random.default_rng(seed)
    sizes = [0, 1, 3, 55, 56, 57, 63, 64, 65, 119, 120, 121, 1000, 4096, 5003]
    buf = rng.integers(0, 256, sum(sizes) + 2 * len(sizes) + 64, dtype=np.uint8)
    offs = []
    pos = 1  # odd start: every chunk begins unaligned
    for i, s in enumerate(sizes):
        offs.append(pos)
        pos += s + (i % 3)  # gaps of 0..2 bytes keep the alignments mixed
    return buf, np.asarray(offs, np.int32), np.asarray(sizes, np.int32)


class TestChunkDigests:
    @pytest.mark.parametrize("seed", [1, 2])
    def test_odd_offsets_match_hashlib_and_reference(self, seed):
        buf, offs, sizes = _odd_extents(seed)
        got = to_u32(
            sha256_cuda.sha256_chunks(
                torch.from_numpy(buf), torch.from_numpy(offs), torch.from_numpy(sizes)
            )
        )
        for i, (o, s) in enumerate(zip(offs, sizes)):
            assert sha256.digest_to_bytes(got[i]) == hashlib.sha256(buf[o : o + s].tobytes()).digest()
        # the reference's gather+pad then Pallas SHA on the same extents
        cap = int(max(jsha.n_padded_blocks(int(s)) for s in sizes))
        jbuf = jnp.asarray(np.concatenate([buf, np.zeros(cap * 64, np.uint8)]))
        jblocks = j_gather_pack_sha(jbuf, jnp.asarray(offs), jnp.asarray(sizes), cap)
        want = np.asarray(
            sha256_batch_pallas(jblocks, jnp.asarray((sizes + 8) // 64 + 1), interpret=True)
        )
        assert np.array_equal(got, want)

    def test_gather_pack_matches_reference(self):
        buf, offs, sizes = _odd_extents(3)
        cap = 4
        keep = sizes <= cap * 64 - 9
        offs, sizes = offs[keep], sizes[keep]
        got = sha256_cuda.gather_pack_sha(
            torch.from_numpy(buf), torch.from_numpy(offs), torch.from_numpy(sizes), cap
        )
        jbuf = jnp.asarray(np.concatenate([buf, np.zeros(cap * 64, np.uint8)]))
        want = np.asarray(j_gather_pack_sha(jbuf, jnp.asarray(offs), jnp.asarray(sizes), cap))
        assert np.array_equal(to_u32(got), want)

    def test_extents_outside_buffer_raise(self):
        buf = torch.zeros(100, dtype=torch.uint8)
        with pytest.raises(ValueError):
            sha256_cuda.sha256_chunks(
                buf, torch.tensor([90], dtype=torch.int32), torch.tensor([11], dtype=torch.int32)
            )
        with pytest.raises(ValueError):
            sha256_cuda.sha256_chunks(
                buf, torch.tensor([0], dtype=torch.int64), torch.tensor([1], dtype=torch.int32)
            )

    def test_empty_batch(self):
        out = sha256_cuda.sha256_chunks(
            torch.zeros(8, dtype=torch.uint8),
            torch.zeros(0, dtype=torch.int32),
            torch.zeros(0, dtype=torch.int32),
        )
        assert out.shape == (0, 8)
