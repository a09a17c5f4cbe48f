"""Chunk-dict probe of the PyTorch port against the JAX package.

Tables are built by the reference package, carried across with
``sharded_dict.from_tables`` (what ``fused_probe_tables()`` returns), and
probed by both: the reference's Pallas probe in interpret mode and its XLA
gather oracle ``_probe_local``, against the port's plain padded-table probe
(the CPU path of ops/probe_cuda.probe_padded) and its ``_probe_local``.
Answers are integers: equality is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke

from nydus_snapshotter_tpu.ops import probe_pallas
from nydus_snapshotter_tpu.parallel import mesh as mesh_lib
from nydus_snapshotter_tpu.parallel.sharded_dict import INSERT_MAX_PROBE, MAX_PROBE
from nydus_snapshotter_tpu.parallel.sharded_dict import ShardedChunkDict as JDict
from nydus_snapshotter_tpu.parallel.sharded_dict import _build_host_tables as j_build
from nydus_snapshotter_tpu.parallel.sharded_dict import _probe_local as j_probe_local
from nydus_snapshotter_tpu.parallel.sharded_dict import _table_max_depth as j_depth
from nydus_snapshotter_tpu_torch.ops import probe_cuda
from nydus_snapshotter_tpu_torch.parallel import sharded_dict
from nydus_snapshotter_tpu_torch.tensors import from_u32

CPU = torch.device("cpu")


def _mk_table(n=20_000, seed=5):
    rng = np.random.default_rng(seed)
    digests = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    keys, values = j_build(digests, 1)
    return digests, keys[0], values[0]


def _queries(digests, m, seed=9):
    rng = np.random.default_rng(seed)
    q = np.concatenate(
        [
            digests[rng.integers(0, len(digests), m // 2)],
            rng.integers(0, 2**32, (m - m // 2, 8), dtype=np.uint32),
        ]
    )
    rng.shuffle(q)
    return q


def _reference(keys, values, q, depth):
    pallas = probe_pallas.probe(keys, values, q, depth, interpret=True)
    xla = np.asarray(
        j_probe_local(jnp.asarray(keys), jnp.asarray(values), jnp.asarray(q), keys.shape[0], depth)
    )
    assert np.array_equal(pallas, xla)
    return pallas


def _port_local(keys, values, q, depth):
    return sharded_dict._probe_local(
        from_u32(keys, CPU), torch.from_numpy(values), from_u32(q, CPU), keys.shape[0], depth
    ).numpy()


class TestProbe:
    def test_matches_reference(self):
        digests, keys, values = _mk_table()
        depth = j_depth(keys[None], values[None])
        q = _queries(digests, 1500)
        want = _reference(keys, values, q, depth)
        got = probe_cuda.probe(keys, values, q, depth, device="cpu")
        assert np.array_equal(got, want)
        assert np.array_equal(_port_local(keys, values, q, depth), want)
        assert (got != 0).sum() == 750  # every planted digest found

    def test_chain_window_wraps_at_table_end(self):
        """Entries whose chains start in the last slot wrap to the table
        head: the padded copy of the head must answer them."""
        rng = np.random.default_rng(11)
        digests = rng.integers(0, 2**32, (30, 8), dtype=np.uint32)
        digests[:, 1] = 63  # every base slot = C - 1 (C = 64): one long chain
        keys, values = j_build(digests, 1)
        keys, values = keys[0], values[0]
        assert keys.shape[0] == 64
        depth = j_depth(keys[None], values[None])
        assert depth == 30
        q = np.concatenate([digests, rng.integers(0, 2**32, (8, 8), dtype=np.uint32)])
        want = _reference(keys, values, q, depth)
        got = probe_cuda.probe(keys, values, q, depth, device="cpu")
        assert np.array_equal(got, want)
        assert np.array_equal(got[:30], np.arange(1, 31))

    @pytest.mark.parametrize("depth", [1, 8, MAX_PROBE])
    def test_depths(self, depth):
        digests, keys, values = _mk_table(n=500, seed=3)
        q = _queries(digests, 64, seed=4)
        want = _reference(keys, values, q, depth)
        assert np.array_equal(probe_cuda.probe(keys, values, q, depth, device="cpu"), want)
        assert np.array_equal(_port_local(keys, values, q, depth), want)

    def test_zero_value_row_never_matches(self):
        """An empty slot's all-zero key must not answer an all-zero query."""
        keys = np.zeros((64, 8), np.uint32)
        values = np.zeros(64, np.int32)
        q = np.zeros((3, 8), np.uint32)
        want = _reference(keys, values, q, 8)
        got = probe_cuda.probe(keys, values, q, 8, device="cpu")
        assert np.array_equal(got, want) and not got.any()

    @pytest.mark.parametrize("depth", [1, 15, 16, 17, 54, 64, INSERT_MAX_PROBE])
    def test_edge_tables(self, depth):
        """chip_smoke's hand-made tables around the CUDA kernel's step
        edges (a first step of 16 chain rows, then steps of 64): hits at
        chain rows 0, 15, 16, 17 and depth - 1, from random slots and from
        slot C - 1 (the chain wraps), a key-equal row of value 0 ahead of
        the real match, all-zero queries through empty rows, misses."""
        keys, values, q, want = chip_smoke.k3_edge_case(depth, np.random.default_rng(depth))
        assert len(q) <= 64
        assert np.array_equal(_reference(keys, values, q, depth), want)
        assert np.array_equal(probe_cuda.probe(keys, values, q, depth, device="cpu"), want)
        assert np.array_equal(_port_local(keys, values, q, depth), want)

    def test_chain_outside_table_raises(self):
        keys_pad, vals_pad = probe_cuda.pad_tables(np.zeros((64, 8), np.uint32), np.zeros(64, np.int32), 1)
        q = torch.zeros((1, 8), dtype=torch.int32)
        with pytest.raises(ValueError):
            probe_cuda.probe_padded(
                from_u32(keys_pad, CPU), torch.from_numpy(vals_pad.reshape(-1)), q,
                torch.tensor([64], dtype=torch.int32), torch.tensor([7], dtype=torch.int32), 8,
            )


class TestCarriedDict:
    def test_from_tables_probes_like_reference_dict(self):
        rng = np.random.default_rng(21)
        digests = rng.integers(0, 2**32, (30_000, 8), dtype=np.uint32)
        jd = JDict(digests, mesh_lib.make_mesh(1), probe_backend="pallas")
        keys, values, depth, epoch = jd.fused_probe_tables()
        pd = sharded_dict.from_tables(keys, values, depth, epoch, device="cpu")
        q = _queries(digests, 2048, seed=22)
        got = pd.lookup_u32(q)
        assert np.array_equal(got, jd.lookup_u32(q))
        assert (got >= 0).sum() == 1024
        assert pd.fused_probe_tables()[2:] == (depth, epoch)

    def test_numpy_build_matches_reference_build(self, monkeypatch):
        """The port's numpy build is the reference's numpy build, table for
        table (duplicates included), and its native build the reference's
        native build; the port's dict (native) answers as the reference's
        default build arm."""
        from nydus_snapshotter_tpu.ops import native_cdc
        from nydus_snapshotter_tpu_torch.ops import native_cdc as p_native

        rng = np.random.default_rng(23)
        digests = rng.integers(0, 2**32, (5000, 8), dtype=np.uint32)
        digests[4000:] = digests[:1000]  # duplicates: first insertion wins
        nkeys, nvals = sharded_dict._build_host_tables(digests, 1)
        dkeys, dvals = j_build(digests, 1)
        assert np.array_equal(nkeys, dkeys) and np.array_equal(nvals, dvals)
        monkeypatch.setattr(native_cdc, "dict_build_available", lambda: False)
        monkeypatch.setattr(p_native, "dict_build_available", lambda: False)
        pkeys, pvals = sharded_dict._build_host_tables(digests, 1)
        jkeys, jvals = j_build(digests, 1)
        assert np.array_equal(pkeys, jkeys) and np.array_equal(pvals, jvals)
        assert sharded_dict._table_max_depth(pkeys, pvals) == j_depth(jkeys, jvals)
        monkeypatch.undo()
        pd = sharded_dict.ShardedChunkDict(digests, device="cpu")
        q = np.concatenate([digests, rng.integers(0, 2**32, (500, 8), dtype=np.uint32)])
        ddepth = j_depth(dkeys, dvals)
        want = _reference(dkeys[0], dvals[0], q, ddepth).astype(np.int64) - 1
        assert np.array_equal(pd.lookup_u32(q), want)
        assert np.array_equal(pd.lookup_u32(digests[4000:4100]), np.arange(100))

    def test_empty_dict_and_empty_query(self):
        pd = sharded_dict.ShardedChunkDict(np.zeros((0, 8), np.uint32), device="cpu")
        assert pd.lookup_u32(np.zeros((0, 8), np.uint32)).shape == (0,)
        assert (pd.lookup_u32(np.ones((3, 8), np.uint32)) == -1).all()
