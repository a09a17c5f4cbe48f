"""The comparison that decides ``correct`` for image-family conversions.

It follows the images in the order they were converted and holds every
layer the window drives to a plain reference that imports nothing of the
port and takes nothing the program made but the outputs it judges:

- the tree: each regular file of the image's tars (upper layers over lower
  ones) is in the merged bootstrap with its size and mode, and the
  directories are exactly the files' ancestors;
- the CDC cuts: every file's chunks tile it within the minimum and maximum
  sizes; a file no larger than the minimum is one chunk; the cuts of a
  sample of the larger files, drawn from the seed in every stratum of layer
  and file size, each image's largest file always in it, are the plain
  FastCDC's (``reference/cdc.py``);
- every chunk digest: SHA-256 by ``hashlib`` for every chunk; BLAKE3
  (``reference/blake3.py``) for a sample drawn from the seed in every
  stratum of layer and leaf count (one 1 KiB leaf, 2-16, more), each
  image's longest chunk always in it;
- the dedup decisions: a chunk whose bytes were in an earlier image is
  referenced into an earlier image's blob (a blob this image made again, byte
  for byte an earlier one, stores it again), a new one is stored in a blob of
  this image, and a blob stores a chunk's bytes once;
- every chunk record's frame is byte for byte the chunk compressed by the
  system library at the configuration's setting (``reference/codecs.py``),
  flagged with that codec;
- each blob's id is the SHA-256 of its data section, and the bootstrap's
  blob table names only blobs made so far, with their section sizes.

Chunk identity across images is the SHA-256 of the chunk's bytes, whatever
the digester. Outside the CDC sample the chunk extents are the program's,
checked for tiling and size. The warm-up images are learnt, not judged:
their chunks (at the program's extents) become the contents seen before the
window. Each count is of things found wrong; every limit is 0.
"""

from __future__ import annotations

import hashlib
import os
import stat
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from benchmark.reference import blake3, cdc, codecs, rafs

COUNTS = ("tree_wrong", "cuts_wrong", "digests_wrong", "dedup_wrong", "frames_wrong",
          "blob_ids_wrong")
LIMITS = dict.fromkeys(COUNTS, 0)  # exact comparisons
FILE_MODE = stat.S_IFREG | 0o644


@dataclass
class Tally:
    counts: dict = field(default_factory=lambda: dict.fromkeys(COUNTS, 0))
    images: int = 0
    bad_images: int = 0
    chunks: int = 0
    cdc_files: int = 0
    cdc_bytes: int = 0
    b3_sampled: int = 0
    b3_strata: int = 0
    chunk_sizes: list = field(default_factory=list)  # per judged file, its chunks' sizes
    seconds: dict = field(default_factory=lambda: dict.fromkeys(("cdc", "frames", "blake3"), 0.0))
    first_fault: str = ""

    positions: int = 0  # bytes of the judged images' files

    def fault(self, name: str, what: str, n: int = 1) -> None:
        self.counts[name] += n
        if not self.first_fault:
            self.first_fault = f"{name}: {what}"

    def summary(self) -> str:
        return (f"{self.images} images, {self.chunks} chunks, plain FastCDC over "
                f"{self.cdc_files} files ({self.cdc_bytes} B), {self.b3_sampled} BLAKE3 samples in "
                f"{self.b3_strata} strata ("
                + ", ".join(f"{k} {v:.3f} s" for k, v in self.seconds.items()) + ")"
                + (f"; first fault {self.first_fault}" if self.first_fault else ""))

    def work(self) -> dict:
        """The window's work: the bytes of its files (K1's positions) and
        every chunk's size as the judged bootstraps cut them."""
        sizes = np.concatenate(self.chunk_sizes) if self.chunk_sizes else np.zeros(0, np.int64)
        return {"positions": self.positions, "chunk_sizes": sizes}


def judge(config: dict, traffic: dict, seed: int, warm: list, window: list) -> Tally:
    """Learn the warm-up images, then judge the window's, in order; both
    are lists of (image, the program's output)."""
    from benchmark.gen.image_family import seed_entropy

    ref = Reference(config, np.random.default_rng(seed_entropy(seed, 7)),
                    int(traffic["cdc_sample_mib"] * 2**20), int(traffic["blake3_sample_mib"] * 2**20))
    tally = Tally()
    for image, output in warm:
        ref.learn(image, output)
    for image, output in window:
        ref.check(image, output, tally)
        tally.positions += sum(m.size for layer in image.layers for m in layer.members)
    return tally


class Reference:
    """Reference state across one run's images: the chunk contents seen in
    earlier images and the blobs made so far."""

    def __init__(self, config: dict, rng: np.random.Generator, cdc_sample_bytes: int,
                 b3_sample_bytes: int):
        self.avg = int(config["chunk_size"])
        self.min, self.max = self.avg // 4, self.avg * 4
        self.digester = config["digester"]
        self.codec = (config["compressor"], codecs.setting(config))
        self.flag = codecs.FLAG[config["compressor"]]
        self.rng = rng
        self.cdc_budget = cdc_sample_bytes
        self.b3_budget = b3_sample_bytes
        self.seen: set[bytes] = set()
        self.blobs: dict[str, memoryview] = {}  # blob id -> data section
        self._keys: dict[tuple, tuple[bytes, list[bytes]]] = {}
        self._cuts: dict[bytes, np.ndarray] = {}  # whole-file sha256 -> plain cuts
        self._judged: set[tuple] = set()  # files whose cuts the plain FastCDC checked
        self._frames: dict[tuple, bytes] = {}  # verified (blob, coff, csize, usize) -> key
        self._encoders = [codecs.Encoder(*self.codec) for _ in range(min(8, os.cpu_count() or 1))]

    # -- the reference's own answers -----------------------------------------

    def plain_cuts(self, data: memoryview) -> np.ndarray:
        """FastCDC cut ends of one file; a copy of a file is cut once."""
        whole = hashlib.sha256(data).digest()
        ends = self._cuts.get(whole)
        if ends is None:
            ends = cdc.cuts(np.frombuffer(data, dtype=np.uint8), self.avg)
            self._cuts[whole] = ends
        return ends

    def keys(self, layer, m, ends: np.ndarray) -> list[bytes]:
        """SHA-256 of each chunk of a member cut at ``ends``; a member of a
        layer shared between images is hashed once."""
        at = (id(layer), m.offset)
        sig = ends.tobytes()
        got = self._keys.get(at)
        if got is None or got[0] != sig:
            data = layer.data(m)
            starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
            got = (sig, [hashlib.sha256(data[s:e]).digest() for s, e in zip(starts, ends)])
            self._keys[at] = got
        return got[1]

    def learn(self, image, output) -> None:
        """An image converted before the window (set-up): its chunks become
        'seen' and its blobs earlier blobs; nothing of it is judged."""
        boot = rafs.read_bootstrap(output.bootstrap)
        where = {"/" + m.path: (layer, m) for layer in image.layers for m in layer.members}
        for path, rec in zip(boot.paths, boot.inodes):
            if path in where:
                first, count = int(rec["chunk_index"]), int(rec["chunk_count"])
                ends = np.cumsum(boot.chunks["usize"][first : first + count].astype(np.int64))
                self.seen.update(self.keys(*where[path], ends))
        self._add_blobs(output.layer_blobs, Tally())

    # -- the comparison ------------------------------------------------------

    def _add_blobs(self, layer_blobs: dict, tally: Tally) -> dict[str, memoryview]:
        new = {}
        for bid, framed in layer_blobs.items():
            sec = rafs.blob_section(framed)
            if sec is None:
                tally.fault("blob_ids_wrong", f"blob {bid[:12]} has no data section")
                continue
            data = memoryview(framed)[sec[0] : sec[0] + sec[1]]
            if hashlib.sha256(data).hexdigest() != bid:
                tally.fault("blob_ids_wrong", f"blob {bid[:12]} is not the sha256 of its data")
            new[bid] = data
        self.blobs.update(new)
        return new

    def check(self, image, output, tally: Tally) -> None:
        """Judge one converted image and learn it."""
        before = sum(tally.counts.values())
        self._check(image, output, tally)
        tally.images += 1
        tally.bad_images += sum(tally.counts.values()) > before

    def _sample(self, image) -> dict[tuple, tuple]:
        """Files above the minimum chunk whose cuts the plain FastCDC checks
        in this image: its largest, and in every stratum of layer and size
        (up to the average chunk, up to the maximum, more) files drawn from
        the seed until the stratum's share of the byte budget is spent, at
        least one (a shared layer's file drawn once)."""
        strata: dict[tuple, list] = {}
        for li, layer in enumerate(image.layers):
            for m in layer.members:
                if m.size > self.min:
                    klass = 0 if m.size <= self.avg else (1 if m.size <= self.max else 2)
                    strata.setdefault((li, klass), []).append((id(layer), m))
        if not strata:
            return {}
        big = [lm for members in strata.values() for lm in members]
        pick = {max(big, key=lambda lm: lm[1].size)}
        share = self.cdc_budget / len(strata)
        for key in sorted(strata):
            members, used = strata[key], 0
            for i in self.rng.permutation(len(members)):
                if used >= share:
                    break
                pick.add(members[i])
                used += members[i][1].size
        layers = {id(layer): layer for layer in image.layers}
        return {(lid, m.offset): (layers[lid], m) for lid, m in pick}

    def _precut(self, sample: dict, tally: Tally) -> None:
        """The plain FastCDC's cuts of the sampled files not judged yet, on
        threads (numpy and hashlib let go of the interpreter's lock)."""
        todo = [(layer, m) for at, (layer, m) in sample.items() if at not in self._judged]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(self._encoders)) as pool:
            list(pool.map(lambda lm: self.plain_cuts(lm[0].data(lm[1])), todo))
        tally.seconds["cdc"] += time.perf_counter() - t0

    def _check(self, image, output, tally: Tally) -> None:
        earlier = set(self.blobs)
        try:
            boot = rafs.read_bootstrap(output.bootstrap)
        except (rafs.FormatError, KeyError, UnicodeDecodeError) as e:
            tally.fault("tree_wrong", f"{image.name}: bootstrap unreadable ({e})")
            return
        # a blob made again (the same bytes as an earlier image's) stores again
        remade = set(output.layer_blobs) & earlier
        new = self._add_blobs(output.layer_blobs, tally)
        for i, bid in enumerate(boot.blob_ids):
            if bid not in self.blobs:
                tally.fault("blob_ids_wrong", f"{image.name}: blob table names unknown {bid[:12]}")
            elif int(boot.blobs["csize"][i]) != len(self.blobs[bid]):
                tally.fault("blob_ids_wrong", f"{image.name}: blob {bid[:12]} size in the table")

        files = {}
        for layer in image.layers:
            for m in layer.members:
                files["/" + m.path] = (layer, m)
        dirs = {"/"}
        for path in files:
            parts = path.split("/")
            for k in range(2, len(parts)):
                dirs.add("/".join(parts[:k]))
        sample = self._sample(image)
        self._precut(sample, tally)
        got_dirs = set()
        stored_at: dict[tuple, int] = {}
        b3_pool = []
        frames: dict[tuple, tuple] = {}
        keys_here = []
        layer_of = {id(layer): li for li, layer in enumerate(image.layers)}
        for path, rec in zip(boot.paths, boot.inodes):
            mode = int(rec["mode"])
            if stat.S_ISDIR(mode):
                got_dirs.add(path)
                continue
            want = files.pop(path, None)
            if want is None or mode != FILE_MODE or int(rec["size"]) != want[1].size:
                tally.fault("tree_wrong", f"{image.name}: {path} not as in the tar")
                continue
            layer, m = want
            first, count = int(rec["chunk_index"]), int(rec["chunk_count"])
            recs = boot.chunks[first : first + count]
            sizes = recs["usize"].astype(np.int64)
            ends = np.cumsum(sizes)
            if not self._cuts_ok(layer, m, ends, sizes, sample, tally):
                tally.fault("cuts_wrong", f"{image.name}: {path} cut elsewhere")
                continue
            keys = self.keys(layer, m, ends)
            keys_here.extend(keys)
            tally.chunk_sizes.append(sizes)
            data = layer.data(m)
            end = 0
            for r, cut, key in zip(recs, ends, keys):
                tally.chunks += 1
                start, end = end, int(cut)
                chunk = data[start:end]
                digest = bytes(r["digest"]).ljust(32, b"\0")
                if self.digester == "sha256":
                    if digest != key:
                        tally.fault("digests_wrong", f"{image.name}: {path} chunk at {start}")
                else:
                    b3_pool.append((chunk, digest, path, layer_of[id(layer)]))
                bid = boot.blob_ids[int(r["blob_index"])]
                if (key in self.seen) != (bid in earlier) or bid in remade:
                    tally.fault("dedup_wrong", f"{image.name}: {path} chunk at {start} "
                                + ("stored again" if key in self.seen else "referenced"))
                if bid in new:
                    at = stored_at.setdefault((bid, key), int(r["coff"]))
                    if at != int(r["coff"]):
                        tally.fault("dedup_wrong", f"{image.name}: {path} stored twice in a blob")
                self._frame(bid, r, chunk, key, frames, tally, image.name, path)
        t0 = time.perf_counter()
        self._check_frames(frames, tally, image.name)
        tally.seconds["frames"] += time.perf_counter() - t0
        for path in files:
            tally.fault("tree_wrong", f"{image.name}: {path} missing from the bootstrap")
        if got_dirs != dirs:
            tally.fault("tree_wrong", f"{image.name}: directories differ", len(got_dirs ^ dirs))
        if b3_pool:
            t0 = time.perf_counter()
            self._check_blake3(b3_pool, tally, image.name)
            tally.seconds["blake3"] += time.perf_counter() - t0
        self.seen.update(keys_here)

    def _cuts_ok(self, layer, m, ends: np.ndarray, sizes: np.ndarray, sample: set,
                 tally: Tally) -> bool:
        """The program's cut ends of one file (and its chunk sizes): they
        tile it within the size limits, and equal the plain FastCDC's where
        the file is sampled."""
        if m.size <= self.min:
            return ends.tolist() == ([m.size] if m.size else [])
        if ends[-1] != m.size or sizes.min() <= 0 or sizes.max() > self.max \
                or (len(sizes) > 1 and sizes[:-1].min() < self.min):
            return False
        at = (id(layer), m.offset)
        if at in sample and at not in self._judged:
            self._judged.add(at)
            tally.cdc_files += 1
            tally.cdc_bytes += m.size
            return np.array_equal(self.plain_cuts(layer.data(m)), ends)
        return True

    def _frame(self, bid, r, chunk, key, frames, tally, name, path) -> None:
        """Queue one chunk record's frame for ``_check_frames``."""
        if (int(r["flags"]) & codecs.MASK) != self.flag:
            tally.fault("frames_wrong", f"{name}: {path} flagged {int(r['flags']):#x}")
            return
        where = (bid, int(r["coff"]), int(r["csize"]), int(r["usize"]))
        if self._frames.get(where) != key:
            frames[where] = (key, chunk, path)

    def _check_frames(self, frames: dict, tally: Tally, name: str) -> None:
        """Each frame is its chunk compressed at the stated setting, byte for
        byte: the chunks compress on the encoders' threads (ctypes lets go
        of the interpreter's lock)."""
        items = list(frames.items())
        n = len(self._encoders)

        def run(w: int) -> list:
            enc, bad = self._encoders[w], []
            for where, (key, chunk, path) in items[w::n]:
                blob = self.blobs.get(where[0])
                frame = blob[where[1] : where[1] + where[2]] if blob is not None else b""
                try:
                    ok = len(chunk) == where[3] and len(frame) == where[2] \
                        and bytes(enc.encode(chunk)) == bytes(frame)
                except codecs.CodecError:
                    ok = False
                if not ok:
                    bad.append((where, path))
            return bad

        with ThreadPoolExecutor(n) as pool:
            bad = [b for part in pool.map(run, range(n)) for b in part]
        wrong = set()
        for where, path in bad:
            wrong.add(where)
            tally.fault("frames_wrong", f"{name}: {path} frame at {where[1]} of {where[0][:12]}")
        for where, (key, _chunk, _path) in items:
            if where not in wrong:
                self._frames[where] = key

    def _check_blake3(self, pool, tally, name) -> None:
        sizes = np.array([len(c) for c, _d, _p, _li in pool])
        pick, n_strata = b3_sample(sizes, np.array([li for *_x, li in pool]), self.b3_budget,
                                   self.rng)
        got = blake3.digests([pool[i][0] for i in pick])
        tally.b3_sampled += len(pick)
        tally.b3_strata += n_strata
        for i, d in zip(pick, got):
            if d != pool[i][1]:
                tally.fault("digests_wrong", f"{name}: {pool[i][2]} BLAKE3")


def b3_sample(sizes: np.ndarray, layers: np.ndarray, budget: float,
              rng: np.random.Generator) -> tuple[list[int], int]:
    """The chunks whose BLAKE3 digests the reference computes: the longest,
    and in every stratum of layer and leaf count (one leaf, 2-16, more)
    chunks drawn from ``rng`` until the stratum's share of the byte budget
    is spent, at least one. -> (sorted indexes, number of strata)."""
    leaves = -(-np.maximum(sizes, 1) // blake3.LEAF)
    klass = np.where(leaves <= 1, 0, np.where(leaves <= 16, 1, 2))
    strata: dict[tuple, list[int]] = {}
    for i, (li, k) in enumerate(zip(layers.tolist(), klass.tolist())):
        strata.setdefault((li, k), []).append(i)
    share = budget / len(strata)
    pick = {int(np.argmax(sizes))}
    for key in sorted(strata):
        members, used = strata[key], 0
        for j in rng.permutation(len(members)):
            if used >= share:
                break
            pick.add(members[j])
            used += int(sizes[members[j]])
    return sorted(pick), len(strata)
