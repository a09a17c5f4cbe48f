"""The image family: deterministic by seed, the same shapes for every seed,
the same shares of repeated and new bytes in every image after the first,
and tars as ``tarfile`` writes them."""

from __future__ import annotations

import io
import json
import tarfile

import numpy as np
import pytest

from benchmark import manifest
from benchmark.gen import image_family
from benchmark.tests.conftest import tiny_traffic


@pytest.fixture(scope="module")
def traffic():
    raw = json.loads((manifest.HERE / "traffic" / "node21-family.json").read_text())
    return tiny_traffic(raw)


def sizes(images):
    return [[[m.size for m in layer.members] for layer in im.layers] for im in images]


def test_same_seed_same_bytes(traffic):
    a = image_family.build(traffic, 2**31 + 5, 3)
    b = image_family.build(traffic, 2**31 + 5, 3)
    assert [im.tars for im in a] == [im.tars for im in b]


def test_seeds_share_shapes_not_bytes(traffic):
    a = image_family.build(traffic, 7, 3)
    b = image_family.build(traffic, -8, 3)
    assert sizes(a) == sizes(b)
    assert [[[m.path for m in la.members] for la in im.layers] for im in a] == \
        [[[m.path for m in la.members] for la in im.layers] for im in b]
    assert all(b"".join(x.tars) != b"".join(y.tars) for x, y in zip(a, b))


def test_later_images_keep_the_base_and_rebuild_the_rest(traffic):
    images = image_family.build(traffic, 11, 4)
    kept = [i for i, spec in enumerate(traffic["layers"]) if spec["kept"]]
    rebuilt = [i for i, spec in enumerate(traffic["layers"]) if not spec["kept"]]
    assert kept == [0, 1, 2, 3] and images[0].new_layers == list(range(8))
    for prev, im in zip(images, images[1:]):
        assert all(im.layers[i] is prev.layers[i] for i in kept)
        assert im.new_layers == rebuilt
        for i in rebuilt:
            a, b = prev.layers[i], im.layers[i]
            assert a.tar != b.tar  # stamped with the release
            assert [(m.path, m.size) for m in a.members] == [(m.path, m.size) for m in b.members]
    # the same shares of new bytes in every image after the first
    new_bytes = []
    for prev, im in zip(images, images[1:]):
        new = 0
        for i in rebuilt:
            a, b = prev.layers[i], im.layers[i]
            new += sum(m.size for m, n in zip(a.members, b.members)
                       if bytes(a.data(m)) != bytes(b.data(n)))
        new_bytes.append(new)
    node = traffic["layers"][5]
    binary = next(f["bytes"] for f in node["files"] if f.get("changes"))
    assert all(binary < n < node["mb"] * 1e6 for n in new_bytes)
    assert max(new_bytes) / min(new_bytes) < 1.5


def test_overridden_files_take_the_upper_layer(traffic):
    image = image_family.build(traffic, 5, 1)[0]
    where = {}
    for li, layer in enumerate(image.layers):
        for m in layer.members:
            where.setdefault(m.path, []).append(li)
    for r in traffic["rewritten"]:
        assert where[r["path"]] == r["layers"]
    # nothing else is written twice: the pool's paths are the layer's own
    assert sum(len(v) > 1 for v in where.values()) == len(traffic["rewritten"])
    depth = max(p.count("/") for p in where)
    assert depth >= 6


def test_the_full_family_has_node21s_layers():
    raw = json.loads((manifest.HERE / "traffic" / "node21-family.json").read_text())
    shapes = image_family.layer_shapes(raw)
    assert len(shapes) == 8
    sizes = [sum(s.sizes) for s in shapes]
    assert sizes == image_family.layer_bytes(raw)
    assert 1.0 < sum(sizes) / 2**30 < 1.1  # BASELINE config 2: ~1 GiB


@pytest.mark.parametrize("mtime", [0, image_family.RELEASE_MTIME + 3])
def test_tar_is_what_tarfile_writes(mtime):
    rng = np.random.default_rng(0)
    files = [(f"a/d{i}/f{i}.bin", rng.integers(0, 256, int(n), dtype=np.uint8))
             for i, n in enumerate((0, 1, 511, 512, 513, 10000))]
    layer = image_family.build_tar(files, mtime)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        for name, data in files:
            ti = tarfile.TarInfo(name)
            ti.size = data.size
            ti.mtime = mtime
            tf.addfile(ti, io.BytesIO(data.tobytes()))
    assert layer.tar == buf.getvalue()
    for (name, data), m in zip(files, layer.members):
        assert m.path == name and bytes(layer.data(m)) == data.tobytes()


def test_window_sizes_the_family():
    t = {"layers": [{"mb": 2**20 * 1152 / 1e6}], "max_gib_per_s": 0.6}
    # 1 152 MiB an image: 10 s at 0.6 GiB/s is 5.33 images, plus one
    assert image_family.window_count(t, 10) == 7
