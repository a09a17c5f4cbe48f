"""The port's scenario corpora (scenario/corpus.py) against the JAX
package's.

Every case of tests/test_scenario_corpus.py but one runs in both packages
(``pkg``); every generator's bytes equal the reference's; the real-vs-real
cross-tree dedup gives the reference's figures. Then the adversarial
layers go through the port's pack lanes: the device lanes (``fused``,
``jax``) on ``device="cpu"``, where the kernels' plain versions run, each
byte-identical to the reference's same lane and to the host lane, with
the resonance visible in the packed chunk table. ``test_peer_crc_rejects_
corrupt_blob`` waits for the port's ``daemon/peer`` and
``scenario/orchestrator.py``.
"""

from __future__ import annotations

import io
import tarfile
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

from nydus_snapshotter_tpu.converter import convert as jconvert
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.ops import cdc as jcdc
from nydus_snapshotter_tpu.scenario import corpus as jcorpus
from nydus_snapshotter_tpu_torch.converter import convert as tconvert
from nydus_snapshotter_tpu_torch.converter.types import PackOption as TPackOption
from nydus_snapshotter_tpu_torch.ops import cdc as tcdc
from nydus_snapshotter_tpu_torch.ops.fused_convert import FusedDeviceEngine
from nydus_snapshotter_tpu_torch.scenario import corpus as tcorpus

PKG = {
    "ref": SimpleNamespace(corpus=jcorpus, cdc=jcdc),
    "port": SimpleNamespace(corpus=tcorpus, cdc=tcdc),
}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKG[request.param]


def _tar_names(data: bytes) -> list:
    with tarfile.open(fileobj=io.BytesIO(data)) as tf:
        return [m.name for m in tf.getmembers()]


class TestDeterminism:
    def test_incompressible_deterministic(self, pkg):
        c = pkg.corpus
        assert c.incompressible_layer(7, 1) == c.incompressible_layer(7, 1)
        assert c.incompressible_layer(7, 1) != c.incompressible_layer(8, 1)

    def test_compressible_deterministic(self, pkg):
        assert pkg.corpus.compressible_layer(3, 1) == pkg.corpus.compressible_layer(3, 1)

    def test_tiny_files_deterministic(self, pkg):
        a = pkg.corpus.tiny_files_layer(5, 500)
        assert a == pkg.corpus.tiny_files_layer(5, 500)
        assert a != pkg.corpus.tiny_files_layer(6, 500)

    def test_huge_file_deterministic(self, pkg):
        assert pkg.corpus.single_huge_file_layer(9, 2) == pkg.corpus.single_huge_file_layer(9, 2)

    def test_resonant_deterministic(self, pkg):
        a = pkg.corpus.cdc_resonant_data(3, 64 << 10, 0x1000, "min")
        assert a == pkg.corpus.cdc_resonant_data(3, 64 << 10, 0x1000, "min")
        assert a != pkg.corpus.cdc_resonant_data(4, 64 << 10, 0x1000, "min")

    def test_real_trees_deterministic(self, pkg):
        c = pkg.corpus
        t1 = c.members_to_tar(c.real_tree_members())
        assert t1 == c.members_to_tar(c.real_tree_members())
        t2 = c.members_to_tar(c.real_tree2_members())
        assert t2 == c.members_to_tar(c.real_tree2_members())
        assert t1 != t2


class TestRealTrees:
    def test_tree2_is_real_derived_subgraph(self, pkg):
        m1 = pkg.corpus.load_manifest(pkg.corpus.MANIFEST_TREE1)
        m2 = pkg.corpus.load_manifest(pkg.corpus.MANIFEST_TREE2)
        assert {e["path"] for e in m2["entries"]} < {e["path"] for e in m1["entries"]}
        assert m2["dropped"] > 0 and m2["changed"] > 0
        assert m2["inodes"] == len(m2["entries"]) and "derivation" in m2

    def test_shared_paths_share_content_changed_do_not(self, pkg):
        c = pkg.corpus
        m2 = c.load_manifest(c.MANIFEST_TREE2)
        changed = next(e for e in m2["entries"] if e.get("gen") and e["size"] > 0)
        same = next(e for e in m2["entries"] if not e.get("gen") and e.get("chunks") and e["size"] > 0)
        assert c.synth_content(same["path"], 0, same["size"]) == c.synth_content(same["path"], 0, same["size"])
        assert c.synth_content(changed["path"], 1, changed["size"]) != \
            c.synth_content(changed["path"], 0, changed["size"])

    def test_cross_tree_dedup_ratio(self, pkg):
        r = pkg.corpus.cross_tree_dedup()
        assert 0.3 <= r["dedup_ratio"] < 1.0
        assert r["dict_chunks"] > 0
        assert "caveat" in r and "synthesized" in r["caveat"]


class TestCdcResonance:
    @pytest.mark.parametrize("avg", [0x1000, 0x4000])
    def test_min_mode_every_chunk_cuts_at_min_size(self, pkg, avg):
        params = pkg.cdc.CDCParams(avg)
        data = pkg.corpus.cdc_resonant_data(11, 16 * params.min_size, avg, "min")
        sizes = np.diff(np.concatenate([[0], pkg.cdc.chunk_data_np(data, params)]))
        assert set(sizes[:-1].tolist()) == {params.min_size}
        assert sizes[-1] <= params.min_size

    def test_max_mode_no_content_cut_ever_fires(self, pkg):
        params = pkg.cdc.CDCParams(0x1000)
        data = pkg.corpus.cdc_resonant_data(11, 4 * params.max_size + 100, 0x1000, "max")
        sizes = np.diff(np.concatenate([[0], pkg.cdc.chunk_data_np(data, params)]))
        assert set(sizes[:-1].tolist()) == {params.max_size}

    def test_resonance_holds_on_sequential_oracle(self, pkg):
        params = pkg.cdc.CDCParams(0x1000)
        data = pkg.corpus.cdc_resonant_data(2, 8 * params.min_size, 0x1000, "min")
        sizes = np.diff(np.concatenate([[0], pkg.cdc.chunk_sequential_reference(data, params)]))
        assert set(sizes[:-1].tolist()) == {params.min_size}

    def test_min_mode_maximizes_chunk_count(self, pkg):
        params = pkg.cdc.CDCParams(0x1000)
        n = 32 * params.min_size
        resonant = pkg.corpus.cdc_resonant_data(1, n, 0x1000, "min")
        random_data = np.random.default_rng(1).integers(0, 256, n, dtype=np.uint8).tobytes()
        assert len(pkg.cdc.chunk_data_np(resonant, params)) > len(pkg.cdc.chunk_data_np(random_data, params))

    def test_bad_mode_rejected(self, pkg):
        with pytest.raises(ValueError):
            pkg.corpus.cdc_resonant_data(1, 4096, 0x1000, "sideways")


class TestDegenerateTrees:
    def test_tiny_files_layer_shape(self, pkg):
        data = pkg.corpus.tiny_files_layer(3, 2000)
        assert len(_tar_names(data)) == 2000
        with tarfile.open(fileobj=io.BytesIO(data)) as tf:
            sizes = [m.size for m in tf.getmembers()]
        assert max(sizes) <= 64 and min(sizes) >= 1

    def test_single_huge_file_layer_shape(self, pkg):
        with tarfile.open(fileobj=io.BytesIO(pkg.corpus.single_huge_file_layer(3, 2))) as tf:
            members = tf.getmembers()
        assert len(members) == 1 and members[0].size == 2 << 20

    def test_incompressible_really_is(self, pkg):
        data = pkg.corpus.incompressible_layer(5, 1)
        assert len(zlib.compress(data, 6)) > 0.95 * len(data)

    def test_compressible_really_is(self, pkg):
        data = pkg.corpus.compressible_layer(5, 1)
        assert len(zlib.compress(data, 6)) < 0.5 * len(data)


class TestCorruptVariants:
    @pytest.mark.parametrize("mode", ["flip", "truncate", "zero"])
    def test_corrupt_differs_and_is_deterministic(self, pkg, mode):
        data = pkg.corpus.incompressible_layer(1, 1)
        bad = pkg.corpus.corrupt_variant(data, 9, mode)
        assert bad != data and bad == pkg.corpus.corrupt_variant(data, 9, mode)
        assert (len(bad) < len(data)) if mode == "truncate" else (len(bad) == len(data))

    def test_empty_and_bad_mode_rejected(self, pkg):
        with pytest.raises(ValueError):
            pkg.corpus.corrupt_variant(b"", 1, "flip")
        with pytest.raises(ValueError):
            pkg.corpus.corrupt_variant(b"x", 1, "shuffle")


# ---------------------------------------------------------------------------
# Parity: every generator, byte for byte
# ---------------------------------------------------------------------------

GENERATORS = {
    "incompressible": lambda c: c.incompressible_layer(7, 1, files=3),
    "compressible": lambda c: c.compressible_layer(3, 1),
    "resonant_min_4k": lambda c: c.cdc_resonant_data(3, 64 << 10, 0x1000, "min"),
    "resonant_min_64k": lambda c: c.cdc_resonant_data(5, 1 << 20, 0x10000, "min"),
    "resonant_max_64k": lambda c: c.cdc_resonant_data(5, 1 << 20, 0x10000, "max"),
    "resonant_layer_min": lambda c: c.cdc_resonant_layer(2, 1, 0x1000, "min"),
    "resonant_layer_max": lambda c: c.cdc_resonant_layer(2, 1, 0x1000, "max"),
    "tiny_files": lambda c: c.tiny_files_layer(5, 3000, fanout=64),
    "single_huge_file": lambda c: c.single_huge_file_layer(9, 2),
    "corrupt_flip": lambda c: c.corrupt_variant(c.incompressible_layer(1, 1), 9, "flip"),
    "corrupt_truncate": lambda c: c.corrupt_variant(c.compressible_layer(1, 1), 9, "truncate"),
    "corrupt_zero": lambda c: c.corrupt_variant(c.incompressible_layer(1, 1), 9, "zero"),
    "tree1": lambda c: c.members_to_tar(c.real_tree_members()),
    "tree2": lambda c: c.members_to_tar(c.real_tree2_members()),
    "tree1_gen2": lambda c: c.members_to_tar(c.real_tree_members(gen_of=lambda p: 2)),
    "synth_text_and_binary": lambda c: b"".join(
        c.synth_content(f"/p{i}", g, 5000) for i in range(10) for g in (0, 1)),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_bytes_equal_reference(name):
    assert GENERATORS[name](tcorpus) == GENERATORS[name](jcorpus)


def test_cross_tree_dedup_equals_reference():
    """The real-vs-real figures (the numpy lane, as the reference's
    default) and the host ``hybrid`` lane's, equal the reference's."""
    want = jcorpus.cross_tree_dedup()
    for opt in (None, TPackOption(chunking="fixed", backend="hybrid")):
        got = tcorpus.cross_tree_dedup(opt)
        assert {k: v for k, v in got.items() if k != "caveat"} == \
            {k: v for k, v in want.items() if k != "caveat"}


def test_cross_tree_dedup_device_lane_needs_the_card():
    import torch

    if torch.cuda.is_available():
        return  # only meaningful on a host without CUDA, such as CI
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcorpus.cross_tree_dedup(TPackOption(chunking="fixed", backend="fused"))


# ---------------------------------------------------------------------------
# The adversarial layers through the pack lanes
# ---------------------------------------------------------------------------

AVG = 0x1000
LAYERS = {
    "resonant_min": lambda c: c.cdc_resonant_layer(4, 1, AVG, "min"),
    "resonant_max": lambda c: c.cdc_resonant_layer(4, 1, AVG, "max"),
    "single_huge_file": lambda c: c.single_huge_file_layer(6, 1),
    "tiny_files": lambda c: c.tiny_files_layer(8, 1500, fanout=32),
    "incompressible": lambda c: c.incompressible_layer(10, 1),
    "compressible": lambda c: c.compressible_layer(10, 1),
}


def _pack(side: str, tar: bytes, backend: str, **kw):
    if side == "port":
        return tconvert.pack_layer(tar, TPackOption(chunk_size=AVG, backend=backend, **kw), device="cpu")
    return jconvert.pack_layer(tar, JPackOption(chunk_size=AVG, backend=backend, **kw))


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_adversarial_layers_pack_reference_bytes(layer):
    """Each layer on the fused lane (the plain versions on the CPU) and the
    host lane: the reference's fused bytes on both."""
    tar = LAYERS[layer](tcorpus)
    want_blob, want = _pack("ref", tar, "fused")
    for backend in ("fused", "hybrid"):
        blob, res = _pack("port", tar, backend)
        assert blob == want_blob and res.bootstrap == want.bootstrap, backend
    if layer.startswith("resonant"):
        blob, res = _pack("port", tar, "jax")
        assert blob == want_blob and res.bootstrap == want.bootstrap


@pytest.mark.parametrize("mode", ["min", "max"])
def test_resonance_survives_the_fused_engine(mode):
    """The fused engine's cuts of a resonant stream: every chunk but the
    last is ``min_size`` (min: a candidate at every unit end) or
    ``max_size`` (max: no candidate at all)."""
    params = tcdc.CDCParams(AVG)
    data = tcorpus.cdc_resonant_data(12, 96 * params.min_size + 77, AVG, mode)
    res = FusedDeviceEngine(chunk_size=AVG, device="cpu").process_many([data, data[:params.max_size]])
    want = params.min_size if mode == "min" else params.max_size
    for cuts in res.cuts:
        sizes = np.diff(np.concatenate([[0], cuts]))
        assert set(sizes[:-1].tolist()) <= {want} and 0 < sizes[-1] <= want
    assert len(res.cuts[0]) > 4
    assert np.array_equal(res.cuts[0], jcdc.chunk_data_np(data, jcdc.CDCParams(AVG)))


def test_adaptive_codec_bypass_engages_on_incompressible_only(monkeypatch):
    """zstd under the adaptive codec: the store-raw bypass takes the
    incompressible layer and leaves the compressible one, in both packages,
    with the same blobs."""
    from nydus_snapshotter_tpu.converter import codec as jcodec
    from nydus_snapshotter_tpu_torch.converter import codec as tcodec

    for layer, bypassed in (("incompressible", True), ("compressible", False)):
        tar = LAYERS[layer](tcorpus)
        tc = tcodec.AdaptiveCodec(tcodec.CodecConfig(adaptive=True))
        jc = jcodec.AdaptiveCodec(jcodec.CodecConfig(adaptive=True))
        t_blob, _ = tconvert.pack_layer(tar, TPackOption(chunk_size=AVG, backend="fused", compressor="zstd"),
                                        device="cpu", codec=tc)
        j_blob, _ = jconvert.pack_layer(tar, JPackOption(chunk_size=AVG, backend="fused", compressor="zstd"),
                                        codec=jc)
        assert t_blob == j_blob
        counts = tc.stats()["counts"]
        assert counts == jc.stats()["counts"]
        assert (counts.get("bypass", 0) > 0) == bypassed, counts
