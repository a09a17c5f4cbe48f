"""Image families: the releases of one image, converted in order.

Image 0 is the traffic file's ``layers``, lowest first. A layer holds its
named ``files``, its version of each ``rewritten`` file that lists it, and
files from the size generator (``filegen.shapes``) until it holds ``mb``
megabytes, each in a directory drawn from a tree of ``dirs`` directories
under the layer's ``roots`` (at most ``max_depth`` levels below a root). A
rewritten file that a later layer writes again is overridden in the merged
tree, as apt's databases and logs are in each apt layer of a real image.

Image k+1 keeps image k's ``kept`` layers verbatim (the same tar objects)
and rebuilds the others, as a new release does on one base: the same paths
and sizes, the tar headers stamped with the release, the named files marked
``changes`` and ``changed_share`` of the layer's other files with new
content, and the rest byte for byte image k's. So every image after the
first has the same shares of repeated and new bytes.

Every seed gets the same shapes (paths, sizes, kinds, which files change;
the traffic file's ``shape_seed``), with content from ``--seed`` (a
generator for each layer of each image). Layer tars are GNU tars as
``tarfile`` writes them, files in path order, built straight into one
buffer; a member's bytes are a view into its tar.
"""

from __future__ import annotations

import math
import tarfile
from dataclasses import dataclass, field

import numpy as np

from benchmark.gen.filegen import KINDS, Content, shapes, text_base

BLOCK = 512
RECORD = 20 * BLOCK  # tarfile's record size: an archive ends on a record
RELEASE_MTIME = 1_700_000_000  # image k's rebuilt layers are stamped this + k


@dataclass(frozen=True)
class Member:
    path: str  # the tar name, no leading "/"
    offset: int  # of the data in the layer tar
    size: int


class Layer:
    """A layer tar and where its files lie in it. The harness holds its
    inputs through the window: they are kept as bytes, a list of strings and
    arrays, which the interpreter's collector does not track, so its gen-2
    passes scan the program's objects and not the harness's."""

    def __init__(self, tar: bytes, paths: list[str], offsets, sizes):
        self.tar = tar
        self.paths = paths
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.sizes = np.asarray(sizes, dtype=np.int64)

    @property
    def members(self) -> list[Member]:
        return [Member(p, int(o), int(n)) for p, o, n in zip(self.paths, self.offsets, self.sizes)]

    def data(self, m: Member) -> memoryview:
        return memoryview(self.tar)[m.offset : m.offset + m.size]

    def data_at(self, i: int) -> memoryview:
        o = int(self.offsets[i])
        return memoryview(self.tar)[o : o + int(self.sizes[i])]


@dataclass
class Image:
    name: str
    layers: list[Layer]
    new_layers: list[int] = field(default_factory=list)  # indexes made for this image

    @property
    def tars(self) -> list[bytes]:
        return [layer.tar for layer in self.layers]

    @property
    def nbytes(self) -> int:
        return sum(len(layer.tar) for layer in self.layers)


@dataclass
class Shape:
    """One layer's files, in tar (path) order."""

    paths: list[str]
    sizes: list[int]
    kinds: list[int]
    changes: np.ndarray  # bool: new content in every rebuild


def seed_entropy(seed: int, *more: int) -> list[int]:
    """SeedSequence words for any whole number (negative ones too)."""
    return [seed & (2**64 - 1), int(seed < 0), *more]


def build_tar(files: list[tuple[str, np.ndarray | memoryview]], mtime: int = 0) -> Layer:
    """A GNU tar of regular files, byte for byte what ``tarfile`` writes for
    ``TarInfo(name)`` entries of these sizes and ``mtime``."""
    headers, total = [], 0
    for name, data in files:
        ti = tarfile.TarInfo(name)
        ti.size = len(data)
        ti.mtime = mtime
        hdr = ti.tobuf(tarfile.GNU_FORMAT, "utf-8", "surrogateescape")
        headers.append(hdr)
        total += len(hdr) + -(-len(data) // BLOCK) * BLOCK
    total += 2 * BLOCK
    total = -(-total // RECORD) * RECORD
    buf = np.zeros(total, dtype=np.uint8)
    offsets, pos = [], 0
    for (name, data), hdr in zip(files, headers):
        buf[pos : pos + len(hdr)] = np.frombuffer(hdr, dtype=np.uint8)
        pos += len(hdr)
        buf[pos : pos + len(data)] = np.frombuffer(data, dtype=np.uint8)
        offsets.append(pos)
        pos += -(-len(data) // BLOCK) * BLOCK
    return Layer(buf.tobytes(), [name for name, _d in files], offsets,
                 [len(data) for _n, data in files])


def layer_bytes(params: dict) -> list[int]:
    return [int(round(spec["mb"] * 1e6)) for spec in params["layers"]]


def window_count(params: dict, seconds: float) -> int:
    """Images a window of ``seconds`` may need: that long at the traffic's
    ``max_gib_per_s``, plus one."""
    image_mib = sum(layer_bytes(params)) / 2**20
    return math.ceil(seconds * params["max_gib_per_s"] * 1024 / image_mib) + 1


def directories(rng: np.random.Generator, li: int, roots: list[str], n: int,
                max_depth: int) -> list[str]:
    """The roots and ``n`` directories drawn under them: each new one a
    child of a directory drawn from those less than ``max_depth`` deep."""
    dirs, depth = list(roots), [0] * len(roots)
    open_ = list(range(len(roots)))
    for i in range(n if max_depth > 0 else 0):
        parent = open_[int(rng.integers(len(open_)))]
        dirs.append(f"{dirs[parent]}/d{li}.{i}")
        depth.append(depth[parent] + 1)
        if depth[-1] < max_depth:
            open_.append(len(dirs) - 1)
    return dirs


def layer_shapes(params: dict) -> list[Shape]:
    """Every layer's files, drawn from the traffic file's ``shape_seed``."""
    rng = np.random.default_rng([int(params["shape_seed"])])
    lo = int(params["size_clip"][0])
    kind = {k: i for i, k in enumerate(KINDS)}
    out = []
    for li, (spec, target) in enumerate(zip(params["layers"], layer_bytes(params))):
        files = {f["path"]: (int(f["bytes"]), kind[f["kind"]], bool(f.get("changes", False)))
                 for f in spec["files"]}
        for r in params.get("rewritten", ()):
            if li in r["layers"]:
                files[r["path"]] = (int(r["bytes"][r["layers"].index(li)]), kind[r["kind"]], False)
        dirs = directories(rng, li, spec["roots"], int(spec["dirs"]), int(spec["max_depth"]))
        rest = target - sum(s for s, _k, _c in files.values())
        if rest > 0:
            drawn = shapes(rng, rest, params)
            over = sum(s for s, _k in drawn) - rest
            size, k = drawn[-1]
            drawn[-1] = (max(lo, size - over), k)  # the last file ends the layer at its size
            where = rng.integers(0, len(dirs), len(drawn))
            for i, ((size, k), d) in enumerate(zip(drawn, where)):
                files[f"{dirs[d]}/l{li}f{i}"] = (size, k, False)
        paths = sorted(files)
        out.append(Shape(paths, [files[p][0] for p in paths], [files[p][1] for p in paths],
                         np.array([files[p][2] for p in paths], dtype=bool)))
    return out


def changed(params: dict, shape: Shape, k: int, li: int) -> np.ndarray:
    """Which files of rebuilt layer ``li`` image ``k`` gives new content:
    the named ones that change, and ``changed_share`` of the others, drawn
    from the shape's generator for that image."""
    share = float(params["layers"][li].get("changed_share", 0.0))
    mask = shape.changes.copy()
    others = np.flatnonzero(~mask)
    rng = np.random.default_rng([int(params["shape_seed"]), k, li])
    mask[rng.permutation(others)[: int(round(share * len(others)))]] = True
    return mask


def build(params: dict, seed: int, n_images: int) -> list[Image]:
    """Images 0..n_images-1 of the family for ``seed``."""
    zero = float(params["binary_zero_share"])
    specs = params["layers"]
    shapes_ = layer_shapes(params)
    images: list[Image] = []
    for k in range(n_images):
        text = text_base(np.random.default_rng(seed_entropy(seed, k)))
        layers, made = [], []
        for li, (spec, shape) in enumerate(zip(specs, shapes_)):
            if k and spec["kept"]:
                layers.append(images[-1].layers[li])
                continue
            content = Content(np.random.default_rng(seed_entropy(seed, k, li, 2)), zero, text)
            new = changed(params, shape, k, li) if k else np.ones(len(shape.paths), dtype=bool)
            prev = images[-1].layers[li] if k else None
            files = [(path, content.file(size, kind) if fresh else prev.data_at(i))
                     for i, (path, size, kind, fresh)
                     in enumerate(zip(shape.paths, shape.sizes, shape.kinds, new))]
            layers.append(build_tar(files, RELEASE_MTIME + k if k else 0))
            made.append(li)
        images.append(Image(f"img{k}", layers, made))
    return images
