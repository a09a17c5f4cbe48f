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

    def test_plain_slices_take_their_own_cap(self, monkeypatch):
        """A long chunk among many short ones: the plain version pads each
        slice to its own longest row, and the rows come back in order."""
        rng = np.random.default_rng(7)
        sizes = np.asarray([100, 5000, 0, 64, 130, 90, 119, 3, 120, 77, 1], np.int32)
        buf = rng.integers(0, 256, int(sizes.sum()) + 64, dtype=np.uint8)
        offs = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int32) + 5
        slices = []
        real = sha256_cuda.gather_pack_sha

        def recorded(b, o, s, cap):
            slices.append((o.shape[0], cap))
            return real(b, o, s, cap)

        monkeypatch.setattr(sha256_cuda, "gather_pack_sha", recorded)
        monkeypatch.setattr(sha256_cuda, "_PLAIN_SLICE_BYTES", 4 * 3 * 64)
        got = to_u32(
            sha256_cuda.sha256_chunks_plain(
                torch.from_numpy(buf), torch.from_numpy(offs), torch.from_numpy(sizes)
            )
        )
        for i, (o, s) in enumerate(zip(offs, sizes)):
            assert sha256.digest_to_bytes(got[i]) == hashlib.sha256(buf[o : o + s].tobytes()).digest()
        # the 79-block chunk alone, then the short rows padded to 3 blocks
        # or fewer (never to 79), each slice within the slice budget
        assert slices[0] == (1, 79)
        assert sum(r for r, _ in slices) == len(sizes)
        assert all(cap <= 3 and r * cap * 64 <= 4 * 3 * 64 for r, cap in slices[1:])
        assert [cap for _, cap in slices] == sorted((cap for _, cap in slices), reverse=True)

    def test_empty_batch(self):
        out = sha256_cuda.sha256_chunks(
            torch.zeros(8, dtype=torch.uint8),
            torch.zeros(0, dtype=torch.int32),
            torch.zeros(0, dtype=torch.int32),
        )
        assert out.shape == (0, 8)


class TestLongestFirst:
    def test_perm_is_descending_permutation(self):
        sizes = torch.from_numpy(np.asarray([5, 0, 4096, 64, 4096, 1, 0, 300], np.int32))
        perm = sha256_cuda.longest_first(sizes)
        assert perm.dtype == torch.int32
        assert sorted(perm.tolist()) == list(range(sizes.numel()))
        ordered = sizes[perm.long()].tolist()
        assert ordered == sorted(sizes.tolist(), reverse=True)
        # ties keep row order (stable), so the schedule is deterministic
        assert perm.tolist()[:2] == [2, 4] and perm.tolist()[-2:] == [1, 6]

    def test_digests_scattered_through_perm_equal_unpermuted(self):
        buf, offs, sizes = _odd_extents(4)
        tb, to, ts = torch.from_numpy(buf), torch.from_numpy(offs), torch.from_numpy(sizes)
        perm = sha256_cuda.longest_first(ts).long()
        out = torch.empty((len(offs), 8), dtype=torch.int32)
        out[perm] = sha256_cuda.sha256_chunks(tb, to[perm], ts[perm])
        assert torch.equal(out, sha256_cuda.sha256_chunks(tb, to, ts))
