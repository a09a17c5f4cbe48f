"""Deterministic scenario corpora: real-derived trees + adversarial layers.

Every generator is a pure function of its seed/parameters — two calls
with the same arguments produce byte-identical tars on any host, so
scenario runs replay exactly and a storm's serial oracle re-derives the
same corpus without shipping blobs around.

Real trees
----------
``real_tree_members()`` materializes the committed manifest of the
reference's REAL Ubuntu v6 fixture (``misc/fixtures/
ubuntu_v6_manifest.json.gz``, extracted by ``tools/
extract_real_manifest.py``): real paths, modes, sizes, symlink targets
and per-file chunk runs; file CONTENT is synthesized deterministically
per ``(path, generation)``. ``real_tree2_members()`` is the second
real-derived tree (``ubuntu_v6_tree2_manifest.json.gz``): a sibling
image sharing the fixture's real base — a deterministic package subset
with a deterministic changed-file delta — used for **real-vs-real**
cross-tree dedup against a real bootstrap dict
(:func:`cross_tree_dedup`). Content-synthesis caveat: the fixture ships
no blob bytes, so shared paths dedup through identical *synthesized*
content; the measured ratio reflects real tree-shape/path overlap and
the real chunk grid, not byte-level CDC behavior of real payloads.

Adversarial layers
------------------
- :func:`incompressible_layer` — pure high-entropy bytes (the adaptive
  codec's bypass must engage; a codec that compresses this is burning CPU);
- :func:`compressible_layer` — the control arm (bypass must NOT engage);
- :func:`cdc_resonant_data` — chunk-boundary-resonant bytes built from
  the gear table itself: ``mode="min"`` crafts a unit whose final
  32-byte window hashes to ``h & mask_small == 0`` so EVERY chunk cuts
  at ``min_size`` (maximum chunk count — chunk-index/dict pressure);
  ``mode="max"`` picks a constant byte whose steady-state gear hash
  misses both FastCDC masks so NO content cut ever fires and every chunk
  is a forced ``max_size`` cut (degenerate candidate-free streams);
- :func:`tiny_files_layer` — the million-tiny-file class (count is a
  parameter: storms size it to the box, the class is the point);
- :func:`single_huge_file_layer` — one file owning the whole layer;
- :func:`corrupt_variant` — truncated / bit-flipped / zero-filled blob
  variants for hostile-peer injection (guaranteed ``!= data``).
"""

from __future__ import annotations

import gzip
import hashlib
import io
import json
import os
import stat as statmod
import tarfile

import numpy as np

from nydus_snapshotter_tpu_torch.ops import gear
from nydus_snapshotter_tpu_torch.ops.cdc import CDCParams

_FIXTURES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "misc",
    "fixtures",
)

MANIFEST_TREE1 = "ubuntu_v6_manifest.json.gz"
MANIFEST_TREE2 = "ubuntu_v6_tree2_manifest.json.gz"


def load_manifest(name: str = MANIFEST_TREE1) -> dict:
    """Load a committed real-tree manifest (path/mode/size/symlink/chunks)."""
    with gzip.open(os.path.join(_FIXTURES, name), "rb") as f:
        return json.load(f)


def synth_content(path: str, generation: int, size: int) -> bytes:
    """Deterministic file content for a manifest entry.

    Per ``(path, generation)``: bumping a file's generation models a
    changed file in an upgraded image while every other byte stays
    identical — the SAME function for every tree, so shared paths at the
    same generation dedup across trees by construction.
    """
    seed = int.from_bytes(
        hashlib.sha256(f"{path}:{generation}".encode()).digest()[:8], "little"
    )
    rng = np.random.default_rng(seed)
    if seed % 5 < 3:  # text-ish: low-entropy, compressible
        base = rng.integers(32, 127, max(1, size // 6 + 1), dtype=np.uint8)
        return np.tile(base, 7)[:size].tobytes()
    return rng.integers(0, 256, size, dtype=np.uint8).tobytes()


def manifest_members(manifest: dict, gen_of=None) -> list:
    """Materialize a manifest as tar members ``(path, mode, data, link)``.

    ``gen_of(path)`` overrides the per-entry generation (tree2 entries
    carry their own ``gen``; tree1 defaults to 0).
    """
    members = []
    for e in manifest["entries"]:
        p = e["path"].lstrip("/")
        if not p:
            continue
        mode = e["mode"]
        if statmod.S_ISDIR(mode):
            members.append((p, mode, None, e.get("symlink")))
        elif statmod.S_ISLNK(mode):
            members.append((p, mode, None, e["symlink"]))
        elif statmod.S_ISREG(mode):
            gen = gen_of(e["path"]) if gen_of is not None else e.get("gen", 0)
            members.append((p, mode, synth_content(e["path"], gen, e["size"]), None))
    return members


def real_tree_members(gen_of=None) -> list:
    return manifest_members(load_manifest(MANIFEST_TREE1), gen_of=gen_of)


def real_tree2_members(gen_of=None) -> list:
    return manifest_members(load_manifest(MANIFEST_TREE2), gen_of=gen_of)


def members_to_tar(members) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        for p, mode, data, link in members:
            ti = tarfile.TarInfo(p)
            ti.mode = mode & 0o7777
            if data is None and link is not None:
                ti.type = tarfile.SYMTYPE
                ti.linkname = link
                tf.addfile(ti)
            elif data is None:
                ti.type = tarfile.DIRTYPE
                tf.addfile(ti)
            else:
                ti.size = len(data)
                tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


def _tar_of_files(files: list) -> bytes:
    """tar of ``[(path, bytes), ...]`` regular files (0o644)."""
    return members_to_tar([(p, 0o100644, data, None) for p, data in files])


# ---------------------------------------------------------------------------
# Adversarial generators
# ---------------------------------------------------------------------------


def incompressible_layer(seed: int, mib: int, files: int = 4) -> bytes:
    """All-incompressible layer: ``files`` files of pure random bytes.

    The adaptive codec's probe must route every chunk of this to the store-raw
    bypass; a run where it doesn't is a storm-scale bypass regression.
    """
    rng = np.random.default_rng(seed)
    per = max(1, (mib << 20) // max(1, files))
    return _tar_of_files(
        [
            (f"opaque/blob{i:02d}.bin", rng.integers(0, 256, per, dtype=np.uint8).tobytes())
            for i in range(files)
        ]
    )


def compressible_layer(seed: int, mib: int, files: int = 4) -> bytes:
    """Control arm: low-entropy text-like content (bypass must NOT engage)."""
    rng = np.random.default_rng(seed)
    per = max(1, (mib << 20) // max(1, files))
    out = []
    for i in range(files):
        # 8 KiB-period repetition: well inside every codec's match
        # window, so the content is unambiguously compressible.
        base = rng.integers(32, 127, max(1, per // 32 + 1), dtype=np.uint8)
        out.append((f"text/doc{i:02d}.txt", np.tile(base, 33)[:per].tobytes()))
    return _tar_of_files(out)


def _min_resonant_unit(seed: int, params: CDCParams) -> bytes:
    """A ``min_size`` unit whose final gear window is a small-mask
    candidate: repeated, every FastCDC chunk cuts at exactly
    ``min_size`` — the earliest judged position is the designed hit, so
    no accidental candidate can precede it.
    """
    table = gear.gear_table()
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 256, params.min_size, dtype=np.uint8)
    # Hash at the unit's last byte covers its final GEAR_WINDOW bytes:
    # h = sum_k table[u[-1-k]] << k (mod 2^32 — uint32 wrap IS the gear
    # semantics). Fix the last 3 bytes by search.
    ks = np.arange(3, gear.GEAR_WINDOW, dtype=np.uint32)
    base = np.sum(
        table[unit[-1 - np.arange(3, gear.GEAR_WINDOW)]].astype(np.uint32) << ks,
        dtype=np.uint32,
    )
    t0 = table.astype(np.uint32)
    mask = np.uint32(params.mask_small)
    ta = (t0 << np.uint32(2))[:, None]  # byte at -3
    tb = (t0 << np.uint32(1))[None, :]  # byte at -2
    pair = base + ta + tb  # uint32[256, 256]
    for c in range(256):
        hit = np.nonzero(((pair + t0[c]) & mask) == 0)
        if len(hit[0]):
            a, b = int(hit[0][0]), int(hit[1][0])
            unit[-3], unit[-2], unit[-1] = a, b, c
            return unit.tobytes()
    raise ValueError(
        f"no 3-byte resonant suffix for mask {params.mask_small:#x} "
        f"(avg {params.avg_size:#x} too large for this construction)"
    )


def _max_antiresonant_byte(params: CDCParams) -> int:
    """A constant byte whose steady-state gear hash misses BOTH FastCDC
    masks: a constant stream of it has zero candidates, so every chunk
    is a forced ``max_size`` cut."""
    table = gear.gear_table()
    for c in range(256):
        ss = (-int(table[c])) & 0xFFFFFFFF  # steady state of a constant stream
        if ss & params.mask_small and ss & params.mask_large:
            return c
    raise ValueError("no anti-resonant byte for these masks")  # pragma: no cover


def cdc_resonant_data(seed: int, size: int, avg_size: int, mode: str = "min") -> bytes:
    """Chunk-boundary-resonant content for the FastCDC engine.

    ``mode="min"``: every chunk cuts at exactly ``min_size`` (maximum
    chunk count). ``mode="max"``: no content cut ever fires — every
    chunk is a forced ``max_size`` cut (zero candidates). Deterministic
    in ``(seed, size, avg_size, mode)``.
    """
    params = CDCParams(avg_size)
    if mode == "min":
        unit = _min_resonant_unit(seed, params)
        reps = size // len(unit) + 1
        return (unit * reps)[:size]
    if mode == "max":
        return bytes([_max_antiresonant_byte(params)]) * size
    raise ValueError(f"cdc_resonant mode must be 'min' or 'max', got {mode!r}")


def cdc_resonant_layer(seed: int, mib: int, avg_size: int, mode: str = "min") -> bytes:
    return _tar_of_files(
        [(f"resonant/{mode}.bin", cdc_resonant_data(seed, mib << 20, avg_size, mode))]
    )


def tiny_files_layer(seed: int, count: int, fanout: int = 256) -> bytes:
    """The million-tiny-file class: ``count`` files of 1–64 bytes spread
    over ``fanout``-way directories (inode/metadata pressure; the blob is
    almost all chunk-table and bootstrap overhead)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 65, count)
    pool = rng.integers(32, 127, 64 * max(1, count // 64) + 64, dtype=np.uint8).tobytes()
    files = []
    for i in range(count):
        off = (i * 37) % (len(pool) - 64)
        files.append(
            (f"tiny/d{i % fanout:03d}/f{i:07d}", pool[off : off + int(sizes[i])])
        )
    return _tar_of_files(files)


def single_huge_file_layer(seed: int, mib: int) -> bytes:
    """One file owning the whole layer: the opposite degenerate shape —
    a single inode whose chunk run is the entire blob."""
    rng = np.random.default_rng(seed)
    size = mib << 20
    base = rng.integers(0, 256, max(1, size // 3 + 1), dtype=np.uint8)
    return _tar_of_files([("huge/image.raw", np.tile(base, 4)[:size].tobytes())])


def corrupt_variant(data: bytes, seed: int, mode: str = "flip") -> bytes:
    """Deterministically corrupted blob variant (always ``!= data``).

    ``flip`` XORs a seeded sample of bytes, ``truncate`` drops the tail,
    ``zero`` blanks a seeded extent — the three shapes a hostile or
    failing peer serves (tests pin that the CRC frame rejects each).
    """
    if not data:
        raise ValueError("cannot corrupt an empty blob")
    rng = np.random.default_rng(seed)
    arr = np.frombuffer(data, dtype=np.uint8).copy()
    if mode == "flip":
        idx = rng.integers(0, len(arr), max(1, len(arr) // 1024))
        arr[idx] ^= np.uint8(0xA5)
        return arr.tobytes()
    if mode == "truncate":
        keep = int(len(arr) * 0.75) if len(arr) > 4 else len(arr) - 1
        return arr[:keep].tobytes()
    if mode == "zero":
        lo = int(rng.integers(0, max(1, len(arr) // 2)))
        hi = min(len(arr), lo + max(1, len(arr) // 8))
        arr[lo:hi] = 0
        out = arr.tobytes()
        return out if out != data else bytes([data[0] ^ 0xFF]) + data[1:]
    raise ValueError(f"corrupt mode must be flip|truncate|zero, got {mode!r}")


# ---------------------------------------------------------------------------
# Real-vs-real cross-tree dedup
# ---------------------------------------------------------------------------

CROSS_TREE_CAVEAT = (
    "real layout (paths/modes/sizes/chunk grid from the reference's v6 "
    "fixture, tree2 a real-derived sibling subset), synthesized content: "
    "shared paths dedup through identical per-(path,gen) synthesized "
    "bytes, so the ratio measures real tree overlap on the real chunk "
    "grid, not byte-level CDC of real payloads"
)


def cross_tree_dedup(opt=None, device=None) -> dict:
    """Convert the real tree, round-trip its merged bootstrap through the
    REAL v6 on-disk layout into a chunk dict, then convert the second
    real-derived tree against it — the real-vs-real ratio counts tree2's
    bytes resolved into tree1's blobs (``--chunk-dict bootstrap=<real
    image>``, cross-image). ``device`` is where a device backend of
    ``opt`` runs (the card unless ``"cpu"`` is asked for)."""
    from dataclasses import replace

    from nydus_snapshotter_tpu_torch.converter.convert import (
        Merge,
        bootstrap_from_layer_blob,
        pack_layer,
    )
    from nydus_snapshotter_tpu_torch.converter.types import MergeOption, PackOption
    from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap, ChunkDict
    from nydus_snapshotter_tpu_torch.models.nydus_real import load_any_bootstrap
    from nydus_snapshotter_tpu_torch.models.nydus_real_write import (
        real_from_bootstrap,
        write_real_v6,
    )

    # REAL v6 images are fixed-chunked (the on-disk chunk index is a
    # fixed grid), so both trees pack fixed for a valid round trip.
    opt = replace(opt, chunking="fixed") if opt is not None else PackOption(
        chunking="fixed", backend="numpy"
    )
    tar_a = members_to_tar(real_tree_members())
    blob_a, _res_a = pack_layer(tar_a, opt, device=device)
    merged = Merge([blob_a], MergeOption(with_tar=False))
    real_v6 = write_real_v6(real_from_bootstrap(Bootstrap.from_bytes(merged.bootstrap)))
    cdict = ChunkDict(load_any_bootstrap(real_v6))

    tar_b = members_to_tar(real_tree2_members())
    blob_b, res_b = pack_layer(tar_b, opt, chunk_dict=cdict, device=device)
    bs_b = bootstrap_from_layer_blob(blob_b)
    own = {res_b.blob_id}
    dedup_bytes = sum(
        c.uncompressed_size
        for c in bs_b.chunks
        if bs_b.blobs[c.blob_index].blob_id not in own
    )
    total = sum(c.uncompressed_size for c in bs_b.chunks)
    m2 = load_manifest(MANIFEST_TREE2)
    return {
        "tree1_mib": round(len(tar_a) / (1 << 20), 1),
        "tree2_mib": round(len(tar_b) / (1 << 20), 1),
        "tree2_inodes": m2["inodes"],
        "tree2_derivation": m2.get("derivation", ""),
        "dict_source": "REAL v6 layout round trip (write_real_v6 -> "
        "load_any_bootstrap)",
        "dict_chunks": len(cdict),
        "dedup_ratio": round(dedup_bytes / max(1, total), 4),
        "caveat": CROSS_TREE_CAVEAT,
    }
