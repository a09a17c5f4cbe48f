#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, measure.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh-only   # phases 0-3 and 15 alone, on every visible card

Phases (any failure exits non-zero; nothing is caught):

0. device — the card's name and power limit as nvidia-smi reports them;
1. build  — nvcc compiles the four kernels of csrc/ (K1 gear_bitmaps.cu,
   K2 sha256.cu, K3 probe.cu, K4 blake3.cu) and the round-latency probe in
   parallel, one nvcc per source; the probe measures the cycles of one
   SHA-256 round's dependent chain (SHF -> LOP3 -> IADD3) on this card for
   K2's and K4's bounds;
2. main path — ``FusedDeviceEngine.process_many`` over a 1 GiB
   node:21-shaped layer (log-normal file sizes, 40/40/20 text/binary/random)
   at 64 KiB average chunks, probing a 2^23-entry chunk dict that holds the
   digests of a third of the layer's files. Launch counters are zeroed just
   before and read just after (K2 must launch exactly once: every chunk in
   one launch); every chunk digest is checked against hashlib, the cuts of
   >= 64 MiB of files against the numpy chunker, and every probe answer
   against a host numpy probe;
3. kernels — each kernel against its plain PyTorch version on the card, on
   the main path's inputs and on edge shapes; exact equality required.
   K1: a 64 MiB slice of the layer buffer, and 3 rows at n = 32k for a k
   that leaves a thread's run partial, from an unaligned base. K2: one
   launch over the largest bucket of <= 128 blocks per chunk (the
   reference's pass-2 plan, ``plan_buckets``) mixed
   with chunks of sizes {0, 1, 55, 56, 63, 64, 119, 120, 4095, max} at
   offsets 0..3 mod 4 (256 bucket rows and every edge row also against
   hashlib; the edge rows' plain version runs on the host copy of the
   buffer). K3: every query of phase 2, and hand-made padded tables at
   depths 1, 15, 16, 17, 54, 64 and 256 (hits at chain rows 0, 15, 16, 17
   and depth - 1, a key-equal row of value 0 ahead of the real match,
   all-zero queries against empty rows, a chain from slot C - 1 that ends
   on the table's last row, misses);
4. pack — ``pack_layer`` over a ~256 MiB node:21-shaped tar, fused backend
   against the numpy (host) backend: blob, bootstrap and blob id identical;
   each wall time the median of 3 runs after that checked one, every run
   printed with its host CPU seconds and minor page faults, and the fused
   runs' ``stats`` (``scan`` is the fast tar header walk). Then the tar's
   header walk alone, the fast walk beside ``tarfile``'s (median of 3 in
   turns), and one fused
   ``Pack`` with the ``fused.dispatch`` failpoint armed with an error: it
   raises, writes nothing, launches nothing, the site fires once; cleared,
   the pack gives phase 4's blob and bootstrap;
5. timings — each kernel alone (``kernel_ms``: many launches of its C entry
   with pointers prepared in advance, between two CUDA events; K3's after
   an L2 flush before each launch, as the main path meets it) and through
   its wrapper (``call_ms``: one call between two events, median of 5 after
   a warm-up, checks and host syncs included); end-to-end GiB/s of
   ``process_many`` with its pass1/host/pass2 split, and the device's busy
   share of it from one torch.profiler trace;
6. registry — K3's second workload, the JAX package's registry-scale dict
   (tools/registry_scale.py): 32,000,000 digests from
   ``default_rng(42)``, 2,000,000 queries (1M planted rows, then 1M random
   digests) through one ``ShardedChunkDict.lookup_u32``; K3 must launch
   once, every planted query answer its insertion index, every answer
   equal the plain version on the card and a 65,536-query sample the host
   probe. That call is the warm-up of ``lookup_u32``'s wall time, the
   median of 5 more calls;
7. windowed engine — ``ChunkDigestEngine(backend="jax")``'s
   ``process_many`` over phase 2's layer: every cut and digest equal to
   phase 2's fused results, K1 launched once per non-empty file and K2 once
   per int32-addressable piece; wall time the median of ``WINDOWED_REPS``
   runs after that checked run (the warm-up), split into ``boundaries_many`` and ``digest_all``, and the
   device's busy share from one torch.profiler trace; K1 alone on one
   512 KiB window and K2 alone on one 32 MiB digest batch (the windowed
   lanes' own shapes), K1's output against its plain version and K2's
   against hashlib; the engine's own staged rows and bitmaps of one
   multi-row stream (the layer's largest files joined) at 1, 2 and 4 MiB
   windows against the plain version, exactly, and its cuts against the
   numpy chunker; then 1 + ``WINDOWED_REPS`` runs at the engine's default 1 MiB average
   chunks, every digest against hashlib, the cuts of >= 64 MiB of files
   against the numpy chunker, and K2 alone on that launch (its output
   against hashlib);
8. pack lanes — ``pack_layer`` over phase 4's tar with ``backend="jax"``,
   the file-like ``Pack`` from a ``BytesIO``, and ``backend="fused"`` with
   the candidate capacity forced to overflow (the per-file windowed
   fallback): blob, bootstrap and blob id equal to phase 4's numpy and
   fused outputs; K1 launched once per non-empty file on the bytes lane
   (at least that on the other two); each wall time the median of 3 after
   a checked run (host CPU seconds and page faults beside each run), in
   which the device digester's ``submit`` runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
9. blake3 — kernel K4 (csrc/blake3.cu: a leaf launch, one thread per
   1024-byte leaf, and a tree launch, one block per chunk) against its
   plain PyTorch version on the card, exactly, on every chunk of phase 2's
   layer, on phase 7's 1 MiB-average chunks and on edge rows of sizes
   {0, 1, 63, 64, 65, 1023, 1024, 1025, 2047, 2048, 2049, 3072, 3073,
   16384, 16385, max} at offsets 0..3 mod 4; the edge rows, one chunk of
   at least 1 MiB and 64 layer chunks also against the pure-Python BLAKE3
   (utils/blake3.py), and the empty chunk against af1349b9f5f9a1a6...;
   ``FusedDeviceEngine(digester="blake3").process_many`` over phase 2's
   layer with a BLAKE3-keyed dict of a third of its files (counters zeroed
   just before: K1 once, K3 once, K2 never, each K4 launch once; cuts equal
   phase 2's, digests the plain version's, probe answers the host probe's;
   wall time the median of 5 after the checked run, pass split, busy share
   from one profiler trace); ``ChunkDigestEngine(backend="jax",
   digester="blake3")`` at 1 MiB chunks (K4 once per piece, its batch
   submitted under sync debug mode "error", digests equal the plain
   version's; median of ``WINDOWED_REPS`` after the checked run, with the
   boundaries and digest split); ``pack_layer(backend="fused", digester="blake3")`` over
   phase 4's tar (blob and blob id equal phase 4's SHA-256 fused blob, the
   bootstrap's digests the plain version's over the blob's chunks; median
   of 3) and ``pack_layer(backend="jax", digester="blake3")`` over the same
   tar (K4 per digest batch, each submitted under sync debug mode "error";
   equal to the fused BLAKE3 pack; median of 3); K4 alone, through its
   wrapper and as the plain version, beside its bound, on the main path
   and at 1 MiB chunks;
10. compressed packs — the path and version of the bound liblz4 and
   libzstd (``LZ4_versionNumber``, ``ZSTD_versionNumber``); each codec whose
   system library is bound runs (at least one must), the others are
   printed as not run. Per codec, at SHA-256 and 64 KiB chunks, over phase
   4's tar: ``pack_layer(backend="numpy")`` once (the oracle), then
   ``fused`` and ``jax``, each equal to it (blob, bootstrap, blob id) with
   the launches of its uncompressed twin (fused: K1 1, K2 1; jax: phase
   8's, K1 once per non-empty file, K2 once per 32 MiB batch, each batch
   submitted under sync debug mode "error"), wall time the median of 3
   after the checked run, each run printed with its host CPU seconds and
   its ``stats`` split (scan, chunk_digest, dedup, assemble, bootstrap);
   every chunk record's frame, located by its compressed offset and size
   and decompressed with the port's codec, equals the tar's bytes at the
   chunk's file offset; the compression ratio. Then one fused pack with
   every new option at once (zstd, or lz4_block without libzstd;
   ``digester="blake3"``, ``batch_size=0x10000``, ``prefetch_patterns``
   naming a directory and two files, ``chunk_dict_path="bootstrap=<file>"``
   holding the bootstrap of a numpy pack of every third file): K1 1, K4's
   two launches once each, equal to its numpy twin (which, like the dict
   pack, digests with K4 through ``digest_backend="jax"``: the numpy lane's
   pure-Python BLAKE3 would take ~11 minutes over this tar); dict hits,
   own and dict batch records and the prefetch table present; every
   frame, of the pack's blob and of the dict's, decompresses to the tar's
   bytes, and every BLAKE3 digest equals the plain version's on the card;
   and equal to its true numpy-lane twin too (BLAKE3 on the native host
   arm, no launch). Every compressed fused and jax pack must take the
   deferred section writer (``PackResult.route``: the native
   ``pack_section`` pass, no Python replay, ``_pack_threads()`` workers,
   every unique chunk a zero-copy extent of the tar); each run prints its
   route and its ``stats`` beside the serial writer's split. Per codec the
   fused pack at ``NTPU_PACK_THREADS=1`` and the file-like ``Pack`` over a
   ``BytesIO`` of the tar (the serial ``_SectionWriter``) must equal it;
11. growth and the dict service — (a) phase 6's dict (the native build)
   grows by tools/registry_scale.py's 2,000,000-digest growth batch (the
   workload generator's next draws): indices n .. n + 2M - 1; then every
   ``lookup_u32`` launches K3 once; phase 6's 2M queries answer as before,
   grow[:1000] answers arange(n, n + 1000), and a grow[::41] + 50,000-random
   sample equals a fresh native build over the concatenation, probed with
   K3; save -> load (mmap) answers identically; a second insert of 100,000,
   ``save_incremental`` -> {"mode": "append", "appended": 100000}, load with
   the tail replayed answers identically, and ``entries_since`` the epoch
   before it returns exactly that batch; two restages (one per mutation a
   probe followed). Printed: insert, restage, first lookup after it, median
   of 5 lookups, the fresh build, save, load, incremental save; the files
   live in a temporary directory, removed at the end. (b) a ``DictService``
   on the card over a unix socket: merges of the bootstrap of a fused
   SHA-256 pack of every third file of phase 4's tar (median of 3, each into
   a fresh namespace), one ``DictClient.probe`` of every chunk digest of
   phase 4's tar (one K3 launch, answers equal to ``GrowingChunkDict``
   positions; median of 3 after a checked RPC), and ``pack_layer(fused,
   chunk_dict_path="service://<sock>#ns")`` equal, byte for byte, to the
   pack with ``chunk_dict=GrowingChunkDict(seed=<that bootstrap>)`` (median
   of 3 after the checked run). A probe RPC inside a client ``convert``
   span: the service's ``dict.rpc.probe`` span (K3 inside it) joins the
   client's trace id; ``GET /metrics`` and ``GET /api/v1/traces`` answer
   on the socket. (c) phase 2's dict grown by the digests of
   another third of the layer's files, then ``process_many`` with it: K3
   once, every answer equal to the host probe of the grown table, every
   inserted digest answering its assigned index;
12. host arms — the native chunk engine on the card machine's CPU: its
   active SIMD arms (gear bitmaps, table scan, BLAKE3 leaves), SHA-NI, the
   core counts. (a) ``ChunkDigestEngine(backend="hybrid").process_many``
   over phase 2's layer at SHA-256 and BLAKE3, 64 KiB and 1 MiB chunks:
   every cut and digest equal to phases 2, 7 and 9's results, no kernel
   launched (counters zeroed just before, read just after); median of
   ``HYBRID_REPS`` after the checked run, GiB/s. (b) ``pack_layer(backend="hybrid")`` over
   phase 4's tar (lz4_block) at ``NTPU_PACK_THREADS=1``: the whole-layer
   ``pack_files`` lane at SHA-256 and at BLAKE3, and the
   ``chunk_digest_multi`` lane with phase 10's dict bootstrap as
   ``chunk_dict_path``; (c) at the default thread count, the per-file lane
   on the stage-parallel pipeline (route lane ``pipeline``). Each equal to its fused twin (blob, bootstrap, blob id),
   its lane and route printed, no launch, the median of 3 after the checked
   run with its ``stats``.
13. images — image-level conversion, BASELINE configs #2 and #3 at the
   ``PackOption`` defaults (1 MiB CDC chunks, lz4_block, SHA-256). Image A
   is phase 2's file population split into bench.py's six log-spread
   layers (weights 32:16:8:4:2:2); image B rebuilds A (its lower five
   layer tars byte for byte, its top layer A's with a quarter of the files
   rewritten, ``.wh.`` whiteouts for a tenth of A's fifth layer and an
   opaque marker on a lower-layer directory); image C runs another app on
   A's lowest three layers (three new layers of ~256 MiB, half their files
   copies of A's upper-layer files under other paths).
   ``BatchConverter(PackOption(backend="fused")).convert_many([A, B, C])``
   with launch counters zeroed just before and read just after: K1 and K2
   exactly once per layer, K3 and K4 never (pack and merge dedup on host
   lookups). Every image's bootstrap, ``blob_digests``, ``layer_blobs`` and
   ``new_dict_chunks`` equal the ``hybrid`` batch's (no launch) and the
   fused batch's at ``layer_fanout=1``; ``Unpack`` of each image, with the
   blobs of every image so far, equals ``apply_overlay`` of its source
   layer trees (paths, modes, sizes, link targets, whiteouts applied, every
   regular file's bytes). Real formats: A's image as ``rafs-v5`` read back
   by ``load_any_bootstrap`` with the same chunk records; that file as
   ``chunk_dict_path`` of a fused pack of C's largest new layer, equal to
   its hybrid twin with the same hit set as against A's native bootstrap;
   a ``rafs-v6`` emit of A's top layer packed at ``chunking="fixed"`` read
   back the same way. Printed: the wall s and GiB/s of the fused batch
   (median of 3 after the checked run), the fan-out-1 and hybrid batches
   (their checked runs); per image input bytes, stored blob bytes, dedup
   ratio, new dict chunks, Merge ms and Unpack s; each real-format emit and
   load; the phase's seconds; the checked fused batch's ``convert`` trace
   span seconds per image and its ``ntpu_fused_convert_stage_seconds`` by
   stage (pass 1 / host / pass 2, summed over the layers). The fan-out-1
   batch runs with ``memory_budget_mib=256``; the hybrid batch takes the
   pipelined lane (every layer's route lane ``pipeline``) and prints its
   ``ntpu_convert_pipeline_*`` stage busy seconds. Files go to a temporary
   directory, removed.
14. codec and cipher — the adaptive zstd codec and blob encryption (both
   on the host, behind the serial section writer, with cuts and digests on
   the card). (a) Phase 4's tar packed with zstd under
   ``NTPU_COMPRESS_ADAPTIVE=1``: fused (one checked run, K1 and K2 once,
   route ``fused``/``serial``; every chunk read back through ``BlobReader``
   equals the tar's bytes; then 2 timed runs with an explicit codec), the
   ``hybrid`` lane at ``NTPU_PACK_THREADS=8`` (no launch) and a fused
   BLAKE3 pack (K1 once, K4's two entries once each), all the same data
   section; printed: the class counts and bytes, the ratio beside phase
   10's fixed-level zstd ratio. (b) A trained batch (``NTPU_COMPRESS_TRAIN=1``,
   ``layer_fanout=1``): image A = phase 13's A's two smallest layers, image
   B = A's fifth layer and B's top layer with its rewritten quarter drawn as
   text; the dictionary trains after A (``train_codec_dict``), B carries
   ``nZD1`` frames, ``Unpack`` of B equals the overlay of its layers, the
   ``hybrid`` twin at one pack thread trains the same dictionary and
   converts the same bytes, ``save_trained_dict`` round-trips, and a
   ``DictService``'s ``put_zdict``/``get_zdict`` is adopted by a second
   ``BatchConverter`` whose pack writes ``nZD1`` frames. (c) Whether the
   ``cryptography`` package imports (its version); if it does, phase 4's
   tar packed fused with zstd and ``encrypt=True`` (K1 and K2 once): its
   data section decrypted equals phase 10's zstd section, every chunk of
   300 random files read through ``BlobReader`` equals the tar's bytes, and
   ``Unpack`` equals the tar's tree; if not, ``Pack(encrypt=True)`` raises
   ``CryptoError`` and writes nothing.
15. mesh — the device mesh on 8 logical shards of the card
   (``make_mesh(8, devices=["cuda:0"] * 8)``; shard-to-shard copies stay
   on the card). Phase 2's 2^23 dict digests built into an 8-shard
   ``ShardedChunkDict``, saved, and loaded back onto one shard (rebuilt),
   where it answers phase 5's queries as phase 2's dict did (the twin the
   mesh lookups are timed against: phase 11 grows phase 2's own dict).
   Phase 5's queries through the routed ``lookup_u32`` (K3 once per shard,
   answers equal phase 5's; median of 3 beside the one-shard twin's, and
   the host dedup alone), the dense probe (K3 once per shard, equal), and
   ``dryrun_multichip``'s skewed queries (the routed buckets overflow; the
   dense fallback, K3 twice per shard in all, equals the host probe).
   ``dryrun_multichip(8)`` on the logical shards. ``sharded_convert_step``
   over phase 2's layer: the extent arm (checked: cuts and digests equal
   phase 2's, K1 once and K2 once per capacity class per shard, no shard
   above its byte shard plus halo; timed once with its stage split; the
   card's busy ms under torch.profiler) and the replicated arm (checked,
   the same bootstrap). Then the same checks on ``make_mesh()``, every
   visible card (one on a one-card machine; K1 splits at the launch
   grid's 65535 rows there).

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import io
import json
import re
import subprocess
import sys
import tarfile
import time
from pathlib import Path

import numpy as np

SEED = 20261016
LAYER_MIB = 1024
PACK_MIB = 256
CHUNK_SIZE = 0x10000
DICT_ENTRIES = 1 << 23
CUT_CHECK_BYTES = 64 << 20
K1_SLICE = 64 << 20
K2_PLAIN_MAX_CAP = 128  # the plain SHA-256 loops in Python per 64-byte block
REPS = 5
# Timed runs after the checked one of the slowest host-bound earlier lanes:
# the windowed engine (phases 7 and 9, ~10-15 s a run) and the hybrid
# engine (phase 12, ~4 s a run). One each keeps the script inside its time
# limit with phase 13; their medians of 3 from PRs 5-9 stand in PERF.md.
WINDOWED_REPS = 1
HYBRID_REPS = 1
DEVICE = "cuda"

# K3's registry-scale workload: tools/registry_scale.py's deployment.
REGISTRY_SEED = 42
REGISTRY_ENTRIES = 32_000_000
REGISTRY_QUERIES = 2_000_000
REGISTRY_SAMPLE = 65_536  # queries also checked against the host probe
REGISTRY_GROW = 2_000_000  # tools/registry_scale.py's growth batch
REGISTRY_GROW_Q_RANDOM = 50_000  # its grow[::41] sample's random half
REGISTRY_SECOND = 100_000  # the batch save_incremental appends
SERVICE_REPS = 3
# Phase 13's images: bench.py's six log-spread layers of one image; image
# C's three new layers; the fused batch's timed runs after the checked one.
IMAGE_WEIGHTS = (32, 16, 8, 4, 2, 2)
IMAGE_C_NEW_MIB = (128, 80, 48)
IMAGE_REPS = 3
# Phase 10's compressed packs as the serial section writer ran them before
# the deferred writer took them (the median run's wall and stats: scan +
# chunk_digest + dedup + assemble + bootstrap, s; NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md section 5): printed beside this run's.
SERIAL_WRITER_COMPRESSED = {
    ("lz4_block", "fused"): "2.364 s [0.475 + 0.562 + 0.050 + 1.117 + 0.141]",
    ("lz4_block", "jax"): "4.519 s [0.477 + 2.885 + 0.054 + 0.976 + 0.109]",
    ("zstd", "fused"): "3.646 s [0.273 + 0.490 + 0.049 + 2.730 + 0.079]",
    ("zstd", "jax"): "7.406 s [0.510 + 3.772 + 0.077 + 2.903 + 0.126]",
}
PLAIN_SLICE_QUERIES = 1 << 18  # the plain probe gathers [Q, depth, 8] per slice
K3_EDGE_DEPTHS = (1, 15, 16, 17, 54, 64, 256)
K3_FIRST_STEP = 16  # chain rows of K3's first step (csrc/probe.cu kFirstRows)
L2_FLUSH_BYTES = 128 << 20  # written before a cold launch: > the 50 MB L2

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
INT32_LANES_PER_SM = 64  # Hopper SM: 4 partitions x 16 INT32 lanes per clock

# Integer operations per unit of work: the fewest the FUNCTION needs on
# this card's instruction set (LOP3 = any 3-input logic op, IADD3 = a
# 3-input add, SHF = a rotate), not what the current kernels issue.
# K1, per position: the 32-term gear sum is the rolling recurrence
# h_i = (h_{i-1} << 1) + g(x_i) — one lookup in the 256-entry gear table
# and one shift-add — plus two mask tests (and + compare each).
K1_OPS_PER_POS = 1 + 1 + 2 * 2
# K2, per 64-byte block: 64 rounds x 14 (S1 and S0: 3 SHF + 1 LOP3 each,
# ch and maj: 1 LOP3 each, t1: 2 IADD3, a: 1 IADD3, e: 1 add), 48 schedule
# steps x 10 (s0 and s1: 2 SHF + 1 shift + 1 LOP3 each, 2 IADD3), 8 state
# adds and one byte swap per message word.
K2_OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8 + 16
# K2's serial term: a chunk's blocks chain through the state. Within a
# round, e' = (d + h + K[r] + W[r]) + S1(e) + Ch(e, f, g): d, h, K and W
# are known rounds ahead, so their sum is taken off the chain, and e'
# depends on e through 3 instructions — the rotates of S1 (SHF, in
# parallel), their 3-input xor (LOP3; Ch is a LOP3 beside it), and one
# IADD3 of S1, Ch and that sum. a' = T1 + S0(a) + Maj(a, b, c) has the
# same depth. The cycles of that 3-instruction chain are measured on the
# card in phase 1 (csrc/round_latency.cu).
K2_ROUND_DEPTH = 3
ROUND_PROBE_STEPS = 1 << 16
# K3, per chain row examined: 8 word compares and the group ballot test.
K3_OPS_PER_ROW = 8 * 2
# K4, per 64-byte compression: 7 rounds x 8 G mixes x 12 (a += b + m twice:
# 1 IADD3 each; c += d twice: 1 add each; four xors, 1 LOP3 each; four
# rotates, 1 SHF each) and the 8 output xors. Message words are
# little-endian: no byte swap. A chunk of n leaves takes every leaf's
# blocks (at least one) and n - 1 parent compressions.
K4_OPS_PER_COMPRESSION = 7 * 8 * 12 + 8
# K4's serial term: a leaf's blocks chain through its CV, then the tree's
# log2(n) levels. Within a compression every instruction of a G mix depends
# on the one before (a, d, c, b in turn: 12 instructions), the diagonal
# mixes on the column mixes, so a round is 24 dependent instructions and a
# compression 7 x 24 + 1 (the output xor), each at the cycles per dependent
# instruction that phase 1's round-latency probe measures.
K4_CHAIN_DEPTH = 7 * 2 * 12 + 1


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# node:21-shaped data (log-normal file sizes, 40/40/20 text/binary/random)
# ---------------------------------------------------------------------------


class FileGen:
    """Seeded synthetic files shaped like a node_modules-heavy image."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self._text = None

    def _text_base(self) -> np.ndarray:
        """1 MiB of word-like ASCII."""
        if self._text is None:
            rng = self.rng
            words = [
                rng.integers(97, 123, int(rng.integers(3, 11)), dtype=np.uint8)
                for _ in range(400)
            ]
            parts = []
            n = 0
            while n < (1 << 20):
                w = words[int(rng.integers(0, len(words)))]
                parts.append(w)
                parts.append(np.frombuffer(b" ", dtype=np.uint8))
                n += len(w) + 1
            self._text = np.concatenate(parts)[: 1 << 20]
        return self._text

    def file(self, size: int, kind: str) -> np.ndarray:
        rng = self.rng
        if kind == "text":
            base = self._text_base()
            reps = -(-size // base.size)
            off = int(rng.integers(0, base.size))
            return np.concatenate([base[off:]] + [base] * reps)[:size]
        if kind == "binary":  # ELF-ish: random bytes with zero runs
            data = rng.integers(0, 256, size, dtype=np.uint8)
            data[rng.random(size) < 0.55] = 0
            return data
        return rng.integers(0, 256, size, dtype=np.uint8)

    def pool(self, total_mib: int) -> list[np.ndarray]:
        total = total_mib << 20
        files = []
        used = 0
        while used < total:
            size = int(np.clip(self.rng.lognormal(8.5, 2.0), 128, 8 << 20))
            r = self.rng.random()
            kind = "text" if r < 0.4 else ("binary" if r < 0.8 else "random")
            files.append(self.file(size, kind))
            used += size
        return files


def layer_tar(files: list[np.ndarray]) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        for fi, data in enumerate(files):
            ti = tarfile.TarInfo(f"layer0/d{fi % 97}/f{fi}.bin")
            ti.size = data.size
            tf.addfile(ti, io.BytesIO(data.tobytes()))
        ti = tarfile.TarInfo("layer0/current")
        ti.type = tarfile.SYMTYPE
        ti.linkname = "d0"
        tf.addfile(ti)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median ms of ``fn`` over ``reps`` runs after one warm-up, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def c_launch(kernel, *args):
    """A launch of ``kernel``'s C entry with ``args`` (tensors become their
    pointers now) on the current stream; the closure keeps the tensors
    alive."""
    import torch

    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    ptrs.append(torch.cuda.current_stream().cuda_stream)

    def launch():
        kernel.launch(*ptrs)

    launch.tensors = args
    return launch


def kernel_ms(launch, n: int, sm_hz: float, flush=None, reps: int = 3) -> float:
    """Kernel-alone ms per launch: ``n`` back-to-back ``launch()`` calls
    between two CUDA events, divided by ``n``; median of ``reps`` after a
    warm-up.

    ``launch`` calls a kernel's C entry directly, with pointers prepared in
    advance: no wrapper checks, no host sync. A spin kernel holds the stream
    while the host enqueues all ``n`` launches, so the host's launch cost
    stays out of the window; the hold doubles until the enqueue fits in
    it. With ``flush`` (called before each launch to evict the L2), each
    launch is timed by its own pair of events and the pairs are summed."""
    import torch

    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    hold_s = 1e-3 + n * 50e-6
    times = []
    while len(times) < reps:
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(n if flush else 1)]
        torch.cuda._sleep(int(hold_s * sm_hz))
        t0 = time.perf_counter()
        if flush is None:
            pairs[0][0].record()
            for _ in range(n):
                launch()
            pairs[0][1].record()
        else:
            for start, end in pairs:
                flush()
                start.record()
                launch()
                end.record()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if enqueue_s > 0.8 * hold_s:  # the card may have waited on the host
            hold_s *= 2
            if hold_s > 2.0:
                raise AssertionError(f"the host took {enqueue_s:.3f} s to enqueue {n} launches")
            continue
        times.append(sum(s.elapsed_time(e) for s, e in pairs) / n)
    return float(np.median(times))


def host_timed(fn) -> tuple[float, float, int]:
    """One call of ``fn``: wall seconds, host CPU seconds of the process
    (every thread) and its minor page faults."""
    import resource

    r0, c0, t0 = resource.getrusage(resource.RUSAGE_SELF), time.process_time(), time.perf_counter()
    fn()
    wall, cpu = time.perf_counter() - t0, time.process_time() - c0
    return wall, cpu, resource.getrusage(resource.RUSAGE_SELF).ru_minflt - r0.ru_minflt


@contextlib.contextmanager
def submits_without_sync(submits: list):
    """Inside: every ``DeviceDigester.submit`` (K2's or K4's batch) runs
    under ``torch.cuda.set_sync_debug_mode("error")``, so a host sync in it
    raises, and appends its batch's chunk count to ``submits``."""
    import torch

    from nydus_snapshotter_tpu_torch.ops import chunker

    real = chunker.DeviceDigester.submit

    def submit(self, items):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(self, items)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            submits.append(len(items))

    chunker.DeviceDigester.submit = submit
    try:
        yield submits
    finally:
        chunker.DeviceDigester.submit = real


STAT_KEYS = ("scan", "chunk_digest", "fused_pack", "dedup", "assemble", "bootstrap")


def fmt_stats(st: dict) -> str:
    """A pack's ``stats`` split, s (``fused_pack`` only where it ran)."""
    return " + ".join(f"{k} {st[k]:.3f}" for k in STAT_KEYS if k != "fused_pack" or st[k])


@contextlib.contextmanager
def pack_threads(value: str):
    """Inside: ``NTPU_PACK_THREADS=value`` with ``NTPU_PACK_THREADS_FORCE``
    unset (the count is capped at the core count)."""
    import os

    saved = {k: os.environ.pop(k, None) for k in ("NTPU_PACK_THREADS", "NTPU_PACK_THREADS_FORCE")}
    os.environ["NTPU_PACK_THREADS"] = value
    try:
        yield
    finally:
        os.environ.pop("NTPU_PACK_THREADS")
        os.environ.update({k: v for k, v in saved.items() if v is not None})


def max_abs_err(got, want) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def digest_words(digests: list[bytes]):
    """Raw SHA-256 digests -> int32[M, 8] as K2 returns them (big-endian
    words as u32 patterns)."""
    import torch

    words = np.frombuffer(b"".join(digests), dtype=">u4").astype(np.uint32)
    return torch.from_numpy(words.view(np.int32).reshape(-1, 8))


def sha_blocks(sizes: np.ndarray) -> np.ndarray:
    """SHA-256 blocks of each chunk after padding."""
    return (sizes.astype(np.int64) + 8) // 64 + 1


def host_probe(keys: np.ndarray, values: np.ndarray, q: np.ndarray, depth: int):
    """numpy probe of the unpadded table -> (answers i32[Q], rows examined)."""
    cap = keys.shape[0]
    slot0 = (q[:, 1] & np.uint32(cap - 1)).astype(np.int64)
    slots = (slot0[:, None] + np.arange(depth)) & (cap - 1)
    vals = values[slots]
    match = (keys[slots] == q[:, None, :]).all(axis=2) & (vals != 0)
    found = match.any(axis=1)
    first = match.argmax(axis=1)
    ans = np.where(found, vals[np.arange(len(q)), first], 0).astype(np.int32)
    rows = np.where(found, first + 1, depth)
    return ans, rows


def k3_edge_case(depth: int, rng):
    """A hand-made table for K3 at ``depth`` -> (keys u32[C,8], values
    i32[C], queries u32[Q,8], expected answers i32[Q]).

    C = 1024 slots of random keys and values, rows 0..7 empty (key 0,
    value 0). Planted: hits at chain rows 0, 15, 16, 17 and depth - 1 (those
    below depth), from random slots and from slot C - 1 (its chain wraps);
    a key-equal row of value 0 ahead of the real match; all-zero queries
    (answer 0: only empty rows hold a zero key); random misses. Planted
    rows never overlap, so each planted query's answer is known."""
    cap = 1024
    keys = rng.integers(1, 2**32, (cap, 8), dtype=np.uint32)
    values = rng.integers(1, 2**31 - 1, cap, dtype=np.int64).astype(np.int32)
    keys[:8], values[:8] = 0, 0
    used = set(range(8))
    queries, want = [], []

    def plant(slot0: int, rows: list[int], vals: list[int]) -> bool:
        slots = [(slot0 + r) % cap for r in rows]
        if used.intersection(slots):
            return False
        q = rng.integers(0, 2**32, 8, dtype=np.uint32)
        q[1] = np.uint32(slot0 + cap * int(rng.integers(0, 2**20)))
        for s, v in zip(slots, vals):
            keys[s], values[s] = q, v
        used.update(slots)
        queries.append(q)
        want.append(vals[-1])
        return True

    for r in sorted({r for r in (0, 15, 16, 17, depth - 1) if r < depth}):
        plant(cap - 1, [r], [int(rng.integers(1, 2**31 - 1))])  # skipped once C - 1 is taken
        for _ in range(2):
            while not plant(int(rng.integers(8, cap)), [r], [int(rng.integers(1, 2**31 - 1))]):
                pass
    for lo in sorted({0, depth // 3, K3_FIRST_STEP - 2}):
        if lo < depth - 1:  # key-equal, value 0, ahead of the real match at depth - 1
            while not plant(int(rng.integers(8, cap)), [lo, depth - 1],
                            [0, int(rng.integers(1, 2**31 - 1))]):
                pass
    for _ in range(4):  # all-zero queries: chains through the empty rows
        queries.append(np.zeros(8, np.uint32))
        want.append(0)
    for _ in range(8):  # misses
        queries.append(rng.integers(0, 2**32, 8, dtype=np.uint32))
        want.append(0)
    return keys, values, np.stack(queries), np.asarray(want, np.int32)


def plain_sliced(keys_pad, vals_pad, q, wstart, off, depth: int):
    """K3's plain version over slices of the queries (its gather is
    [Q, depth, 8])."""
    import torch

    from nydus_snapshotter_tpu_torch.ops import probe_cuda

    return torch.cat([
        probe_cuda.probe_padded_plain(keys_pad, vals_pad, q[s:s + PLAIN_SLICE_QUERIES],
                                      wstart[s:s + PLAIN_SLICE_QUERIES],
                                      off[s:s + PLAIN_SLICE_QUERIES], depth)
        for s in range(0, q.shape[0], PLAIN_SLICE_QUERIES)
    ])


def chain_stats(keys_pad, vals_pad, q, wstart, off, depth: int) -> dict:
    """Chain rows a probe of these queries examines (a hit stops at its
    row, a miss walks the whole chain), and where the hits sit; on the
    queries' device, in slices."""
    import torch

    rows_total, hits, within_first, deepest = 0, 0, 0, -1
    ar = torch.arange(depth, dtype=torch.int64, device=q.device)
    for s in range(0, q.shape[0], PLAIN_SLICE_QUERIES):
        e = s + PLAIN_SLICE_QUERIES
        rows = (wstart[s:e].long() + off[s:e])[:, None] + ar
        match = (keys_pad[rows] == q[s:e, None, :]).all(dim=2) & (vals_pad[rows] != 0)
        found = match.any(dim=1)
        first = match.to(torch.int32).argmax(dim=1)
        rows_total += int(torch.where(found, first + 1, depth).sum())
        hits += int(found.sum())
        within_first += int((found & (first < K3_FIRST_STEP)).sum())
        if found.any():
            deepest = max(deepest, int(first[found].max()))
    return {"rows": rows_total, "hits": hits, "hits_in_first_step": within_first,
            "deepest_hit_row": deepest}


def k3_bound(n_queries: int, rows: float, hits: float, int_ops_per_s: float):
    """K3's bound: each query's 32 B digest and 8 B of chain start in, 4 B
    of answer out, 32 B per chain row examined and 4 B of value per hit."""
    return bound_ms(n_queries * (32 + 8 + 4) + rows * 32 + hits * 4,
                    rows * K3_OPS_PER_ROW, int_ops_per_s)


def device_busy(fn) -> tuple[float, dict[str, float]]:
    """Run ``fn`` under torch.profiler (after one profiled warm-up) ->
    (ms during which the device ran something: the union of its kernel and
    copy intervals, {event name: device ms})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        # CUPTI's own buffer bookkeeping is reported as a device event too
        if e.device_type != DeviceType.CUDA or "Activity Buffer" in e.name:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy_us, edge = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > edge:
            busy_us += end - max(start, edge)
            edge = end
    return busy_us / 1e3, by_name


def bound_ms(nbytes: float, ops: float, int_ops_per_s: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_bound(sizes: np.ndarray, int_ops_per_s: float, sm_hz: float, round_cycles: float):
    """K2's bound over chunks of these sizes -> (ms, by, throughput-term ms,
    what bounds the throughput term, serial-term ms).

    The throughput term is the larger of the bytes (each chunk byte read
    once, offset + size in, 32 B of digest out) and all blocks' operations
    over the card; the serial term is the longest chunk's dependent chain
    (all its blocks x 64 rounds x the measured cycles of one round's
    critical path), which no parallelism shortens."""
    blocks = sha_blocks(sizes)
    through, by = bound_ms(
        float(sizes.astype(np.int64).sum()) + len(sizes) * (8 + 32),
        float(blocks.sum()) * K2_OPS_PER_BLOCK, int_ops_per_s,
    )
    serial = float(blocks.max()) * 64 * round_cycles / sm_hz * 1e3
    if serial > through:
        return serial, "operations", through, by, serial
    return through, by, through, by, serial


def sass_opcodes(lib) -> dict[str, int]:
    """Opcode counts of the machine code in a built kernel library."""
    from nydus_snapshotter_tpu_torch.ops import cuda_build

    tool = str(Path(cuda_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts: dict[str, int] = {}
    for line in sass.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def round_cycles(probe) -> float:
    """SM cycles of one SHA-256 round's dependent chain (SHF -> LOP3 ->
    IADD3), from one thread running ``ROUND_PROBE_STEPS`` of them
    (second of two runs: the first warms the instruction cache)."""
    import torch

    dev = torch.device(DEVICE, 0)
    arg = torch.tensor([6, 0x3C6EF372, 0x1F83D9AB, 0x9B05688C, 0x510E527F, 0x6A09E667],
                       dtype=torch.int64, device=dev).to(torch.int32)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    for _ in range(2):
        probe.launch(arg.data_ptr(), out.data_ptr(), cycles.data_ptr(), ROUND_PROBE_STEPS,
                     torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return int(cycles.item()) / ROUND_PROBE_STEPS


def registry_workload():
    """tools/registry_scale.py's dict and queries -> (digests u32[N,8],
    planted rows i64[M/2], queries u32[M,8]: the planted rows' digests, then
    random digests; the generator, whose next draws are the tool's growth
    batch)."""
    n, m = REGISTRY_ENTRIES, REGISTRY_QUERIES
    rng = np.random.default_rng(REGISTRY_SEED)
    digests = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    hit_rows = rng.choice(n, m // 2, replace=False)
    queries = np.concatenate(
        [digests[hit_rows], rng.integers(0, 2**32, (m - m // 2, 8), dtype=np.uint32)]
    )
    return digests, hit_rows, queries, rng


def registry_phase(dev, int_ops_per_s: float, sm_hz: float) -> tuple[dict, dict]:
    """Phase 6: K3 at registry scale, the JAX package's
    tools/registry_scale.py deployment, through ``lookup_u32`` -> (its
    figures, and what phase 11 grows: the dict, its digests, the queries,
    their answers and the workload's generator)."""
    import torch

    from nydus_snapshotter_tpu_torch.ops import probe_cuda
    from nydus_snapshotter_tpu_torch.parallel import sharded_dict
    from nydus_snapshotter_tpu_torch.tensors import from_u32

    t0 = time.perf_counter()
    n, m = REGISTRY_ENTRIES, REGISTRY_QUERIES
    digests, hit_rows, queries, rng = registry_workload()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cdict = sharded_dict.ShardedChunkDict(digests, device=dev)
    build_s = time.perf_counter() - t0
    keys, values, depth, _epoch = cdict.fused_probe_tables()
    t0 = time.perf_counter()
    tk, tv, _cap, _depth = cdict.device_snapshot()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0

    probe_cuda.KERNEL.launches = 0
    t0 = time.perf_counter()
    got = cdict.lookup_u32(queries)
    first_s = time.perf_counter() - t0
    launches = probe_cuda.KERNEL.launches
    if launches != 1:
        raise AssertionError(f"K3 launched {launches} times in one lookup_u32")
    if not np.array_equal(got[: m // 2], hit_rows):
        raise AssertionError("a planted query does not answer its insertion index")
    qd = from_u32(queries, dev)
    ws, off = probe_cuda.window_starts(qd, cdict.capacity)
    if not np.array_equal(plain_sliced(tk, tv, qd, ws, off, depth).cpu().numpy() - 1, got):
        raise AssertionError("K3 differs from its plain version at registry scale")
    sample = np.random.default_rng(REGISTRY_SEED + 1).choice(m, REGISTRY_SAMPLE, replace=False)
    want, _ = host_probe(keys, values, queries[sample], depth)
    if not np.array_equal(want.astype(np.int64) - 1, got[sample]):
        raise AssertionError("K3 differs from the host probe on the registry sample")
    st = chain_stats(tk, tv, qd, ws, off, depth)

    lookups = []  # the first call above was the warm-up
    for _ in range(REPS):
        t0 = time.perf_counter()
        again = cdict.lookup_u32(queries)
        lookups.append(time.perf_counter() - t0)
        if not np.array_equal(again, got):
            raise AssertionError("lookup_u32 answers differ between calls")
    lookup_s = float(np.median(lookups))
    k_ms = kernel_ms(c_launch(probe_cuda.KERNEL, tk, tv, qd, ws, off, torch.empty_like(ws), m,
                              depth), 20, sm_hz)
    call_ms = cuda_ms(lambda: probe_cuda.probe_padded(tk, tv, qd, ws, off, depth))
    plain_ms = cuda_ms(lambda: plain_sliced(tk, tv, qd, ws, off, depth), reps=3)
    bound = k3_bound(m, st["rows"], st["hits"], int_ops_per_s)
    log(f"[6] registry dict: {n} digests (default_rng({REGISTRY_SEED})), {cdict.capacity} slots "
        f"({keys.nbytes >> 20} MiB of keys), max chain {depth}; generated in {gen_s:.1f} s, "
        f"built in {build_s:.1f} s (native engine), padded and uploaded in {upload_s:.2f} s")
    log(f"[6] registry lookup_u32: {m} queries in one call, {launches} K3 launch; median "
        f"{lookup_s * 1e3:.3f} ms wall over {REPS} calls after a warm-up = "
        f"{m / lookup_s / 1e6:.2f} M queries/s (warm-up {first_s * 1e3:.3f} ms, runs: "
        + ", ".join(f"{x * 1e3:.3f}" for x in lookups) + f" ms); {st['hits']} hits, "
        f"every planted query == its insertion index, every answer == the plain version, "
        f"{REGISTRY_SAMPLE} sampled == host probe; {st['rows']} chain rows examined, "
        f"{st['hits_in_first_step']} hits in the first {K3_FIRST_STEP} rows, deepest hit row "
        f"{st['deepest_hit_row']}")
    log(f"[6] registry K3: kernel {k_ms:.4f} ms, call {call_ms:.4f} ms (plain {plain_ms:.2f} ms, "
        f"bound {bound[0]:.4f} ms by {bound[1]}: {k_ms / bound[0]:.2f}x)")
    return {
        "queries": m, "entries": n, "capacity": cdict.capacity, "depth": depth,
        "launches": launches, "kernel_ms": k_ms, "call_ms": call_ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "lookup_ms": lookup_s * 1e3,
        "lookup_runs_ms": [x * 1e3 for x in lookups], "queries_per_s": m / lookup_s,
        "chain_rows": st["rows"], "hits": st["hits"],
        "hits_in_first_step": st["hits_in_first_step"], "deepest_hit_row": st["deepest_hit_row"],
        "build_s": build_s, "upload_s": upload_s,
    }, {"dict": cdict, "digests": digests, "queries": queries, "answers": got, "rng": rng}


def windowed_phase(dev, files, fused_res, kernels, int_ops_per_s, sm_hz, rc) -> dict:
    """Phase 7: the windowed ChunkDigestEngine over phase 2's layer."""
    import torch

    from nydus_snapshotter_tpu_torch.ops import cdc, chunker, gear_cuda, sha256_cuda

    n_bytes = sum(f.size for f in files)
    nonempty = sum(1 for f in files if f.size)
    eng = chunker.ChunkDigestEngine(chunk_size=CHUNK_SIZE, backend="jax", device=dev)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    got = eng.process_many(files)
    first_s = time.perf_counter() - t0
    launches = {key: k.launches for key, k in kernels.items()}
    for metas, cuts, digs in zip(got, fused_res.cuts, fused_res.digests):
        if [m.offset + m.size for m in metas] != [int(c) for c in cuts]:
            raise AssertionError("windowed cuts differ from the fused engine's")
        if [m.digest for m in metas] != digs:
            raise AssertionError("windowed digests differ from the fused engine's")
    if n_bytes > chunker.MAX_PIECE_BYTES:
        raise AssertionError("the layer no longer fits one K2 piece; adjust the K2 launch check")
    if launches != {"gear": nonempty, "sha": 1, "probe": 0}:
        raise AssertionError(f"windowed process_many launched {launches}; want K1 x {nonempty}, K2 x 1")
    n_chunks = sum(len(m) for m in got)
    log(f"[7] windowed process_many: {n_chunks} chunks, every cut and digest == phase 2's fused "
        f"results; launches {launches} ({nonempty} non-empty files); checked run {first_s:.3f} s")

    walls, splits = [], []
    for _ in range(WINDOWED_REPS):
        before = dict(eng.stats)
        t0 = time.perf_counter()
        eng.process_many(files)
        walls.append(time.perf_counter() - t0)
        splits.append({k: eng.stats[k] - before[k] for k in eng.stats})
    wall = float(np.median(walls))
    split = {k: float(np.median([x[k] for x in splits])) for k in splits[0]}
    busy_ms, by_name = device_busy(lambda: eng.process_many(files))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"[7] windowed process_many: median {wall:.3f} s over {WINDOWED_REPS} runs after the "
        f"checked one -> "
        f"{n_bytes / 2**30 / wall:.3f} GiB/s (runs: " + ", ".join(f"{x:.3f}" for x in walls)
        + f" s); boundaries_many {split['boundaries_s']:.3f} s, digest_all {split['digest_s']:.3f} s; "
        f"device busy {busy_ms:.3f} ms = {100 * busy_ms / (wall * 1e3):.1f}% of the median, idle "
        f"{100 - 100 * busy_ms / (wall * 1e3):.1f}%; top: "
        + "; ".join(f"{n[:40]} {ms:.3f} ms" for n, ms in top))
    windows = [min(eng.window, max(chunker.MIN_WINDOW, chunker._pow2_ceil(f.size)))
               for f in files if f.size]
    padded = sum(w * -(-f.size // w) for w, f in zip(windows, (f for f in files if f.size)))

    # The windowed lanes' own kernel shapes: one 512 KiB window row, and
    # one 32 MiB digest batch (the pack lane's DIGEST_BATCH_BYTES).
    p = eng.params
    w = chunker.MIN_WINDOW
    big = next(f for f in files if f.size >= w)
    row = torch.from_numpy(np.concatenate([np.zeros(chunker.TAIL, np.uint8), big[:w]])).to(dev)[None]
    o = torch.empty((2, 1, w // 32), dtype=torch.int32, device=dev)
    win_ms = kernel_ms(c_launch(gear_cuda.KERNEL, row, o[0], o[1], 1, w, p.mask_small,
                                p.mask_large), 200, sm_hz)
    win_bound = bound_ms(row.numel() + 2 * w / 8, w * K1_OPS_PER_POS, int_ops_per_s)
    k1_err = max(max_abs_err(a, b) for a, b in
                 zip(o, gear_cuda.gear_bitmaps_plain(row, p.mask_small, p.mask_large, w)))
    # One multi-row stream at each larger window, staged and read back by the
    # engine itself: its bitmaps against the plain version on the same rows,
    # its cuts against the numpy chunker. The stream joins the layer's
    # largest files, past three 4 MiB rows.
    largest, size = [], 0
    for f in sorted(files, key=lambda f: -f.size):
        largest.append(f)
        size += f.size
        if size > 3 * chunker.DEFAULT_WINDOW:
            break
    stream = np.concatenate(largest)
    stream_rows = []
    stream_windows = (chunker.DEFAULT_WINDOW >> 2, chunker.DEFAULT_WINDOW >> 1, chunker.DEFAULT_WINDOW)
    for ww in stream_windows:
        e = chunker.ChunkDigestEngine(chunk_size=CHUNK_SIZE, backend="jax", window=ww, device=dev)
        h = e._dispatch_windows(stream)
        slot, w_got, n = h
        if slot.done is not None:
            slot.done.synchronize()
        if w_got != ww or n != -(-stream.size // ww) or n < 2:
            raise AssertionError(f"window {ww}: staged {n} rows of {w_got}")
        want = gear_cuda.gear_bitmaps_plain(slot.rows[:n].to(dev), p.mask_small, p.mask_large, ww)
        k1_err = max([k1_err] + [max_abs_err(slot.bits[i, :n], want[i].cpu()) for i in range(2)])
        if not np.array_equal(cdc.resolve_cuts(*e._collect_windows(h, stream), stream.size, p),
                              cdc.chunk_data_np(stream, p)):
            raise AssertionError(f"window {ww}: cuts differ from the numpy chunker")
        stream_rows.append(n)
    if k1_err:
        raise AssertionError(f"K1 on the windowed lane's rows differs from its plain version "
                             f"(max err {k1_err})")
    sizes, parts, total = [], [], 0
    for metas, f in zip(got, files):
        for m in metas:
            if total >= 32 << 20:
                break
            parts.append(f[m.offset:m.offset + m.size])
            sizes.append(m.size)
            total += m.size
    sizes = np.asarray(sizes, np.int32)
    joined = np.zeros(-(-total // 16) * 16, np.uint8)
    joined[:total] = np.concatenate(parts)
    b_buf = torch.from_numpy(joined).to(dev)
    b_offs = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int32)
    b_offs_d, b_sizes_d = torch.from_numpy(np.stack([b_offs, sizes])).to(dev)
    b_out = torch.empty((len(sizes), 8), dtype=torch.int32, device=dev)
    batch_ms = kernel_ms(c_launch(sha256_cuda.KERNEL, b_buf, b_offs_d, b_sizes_d,
                                  sha256_cuda.longest_first(b_sizes_d), b_out, len(sizes)),
                         20, sm_hz)
    batch_bound = k2_bound(sizes, int_ops_per_s, sm_hz, rc)
    k2_err = max_abs_err(b_out.cpu(), digest_words([hashlib.sha256(x).digest() for x in parts]))
    log(f"[7] K1 alone on one {w}-byte window: {win_ms:.4f} ms (bound {win_bound[0]:.5f} ms by "
        f"{win_bound[1]}); its output, and the engine's bitmaps of one {stream.size}-byte stream "
        f"in {stream_rows} rows of {[x >> 10 for x in stream_windows]} KiB, == the plain "
        f"version, their cuts == the numpy "
        f"chunker; the layer's {nonempty} windows hold {padded} positions for {n_bytes} "
        f"bytes ({padded / n_bytes:.2f}x); K2 alone on one {total}-byte digest batch "
        f"({len(sizes)} chunks, longest {int(sha_blocks(sizes).max())} blocks): {batch_ms:.4f} ms "
        f"(bound {batch_bound[0]:.4f} ms: throughput {batch_bound[2]:.4f}, serial "
        f"{batch_bound[4]:.4f}), every digest == hashlib")
    del b_buf, row

    # The engine's default 1 MiB average chunks.
    eng_1m = chunker.ChunkDigestEngine(backend="jax", device=dev)
    walls_1m, splits_1m, res_1m = [], [], None
    for _ in range(1 + WINDOWED_REPS):
        before = dict(eng_1m.stats)
        t0 = time.perf_counter()
        out = eng_1m.process_many(files)
        walls_1m.append(time.perf_counter() - t0)
        splits_1m.append(tuple(eng_1m.stats[k] - before[k] for k in ("boundaries_s", "digest_s")))
        if res_1m is None:
            res_1m = out
        elif [[m.digest for m in x] for x in out] != [[m.digest for m in x] for x in res_1m]:
            raise AssertionError("1 MiB-chunk runs differ")
    checked = 0
    for f, metas in zip(files, res_1m):
        for m in metas:
            if hashlib.sha256(f[m.offset:m.offset + m.size]).digest() != m.digest:
                raise AssertionError("1 MiB-chunk digest differs from hashlib")
        if checked < CUT_CHECK_BYTES and f.size:
            cuts = cdc.chunk_data_np(f, eng_1m.params)
            if not np.array_equal(cuts, [m.offset + m.size for m in metas]):
                raise AssertionError("1 MiB-chunk cuts differ from the numpy chunker")
            checked += f.size
    sizes_1m = np.asarray([m.size for metas in res_1m for m in metas], np.int32)
    offs_1m = np.concatenate([[0], np.cumsum(sizes_1m[:-1])]).astype(np.int32)
    whole = np.zeros(-(-n_bytes // 16) * 16, np.uint8)
    whole[:n_bytes] = np.concatenate(files)
    w_buf = torch.from_numpy(whole).to(dev)
    del whole
    o_d, s_d = torch.from_numpy(np.stack([offs_1m, sizes_1m])).to(dev)
    out_1m = torch.empty((len(sizes_1m), 8), dtype=torch.int32, device=dev)
    k2_1m_ms = kernel_ms(c_launch(sha256_cuda.KERNEL, w_buf, o_d, s_d,
                                  sha256_cuda.longest_first(s_d), out_1m, len(sizes_1m)), 2, sm_hz)
    bound_1m = k2_bound(sizes_1m, int_ops_per_s, sm_hz, rc)
    k2_err = max(k2_err, max_abs_err(out_1m.cpu(), digest_words(
        [m.digest for metas in res_1m for m in metas])))
    if k2_err:
        raise AssertionError(f"K2 on the windowed lane's batches differs from hashlib "
                             f"(max err {k2_err})")
    longest_1m = int(sha_blocks(sizes_1m).max())
    del w_buf
    log(f"[7] 1 MiB average chunks: {len(sizes_1m)} chunks, runs (wall: boundaries_many + "
        "digest_all) " + ", ".join(f"{x:.3f}: {b:.3f} + {d:.3f}" for x, (b, d) in
                                   zip(walls_1m, splits_1m)) + f" s (median {np.median(walls_1m):.3f} s = "
        f"{n_bytes / 2**30 / np.median(walls_1m):.3f} GiB/s); every digest == hashlib, cuts == "
        f"numpy chunker over {checked} bytes; longest chunk {longest_1m} blocks; K2 alone on all "
        f"{len(sizes_1m)} chunks in one launch (== hashlib) {k2_1m_ms:.3f} ms (bound {bound_1m[0]:.3f} ms: "
        f"throughput {bound_1m[2]:.4f}, serial {bound_1m[4]:.3f}) = "
        f"{k2_1m_ms * 1e-3 * sm_hz / longest_1m:.0f} cycles per block of the longest chunk")
    return {
        "offs_1m": offs_1m, "sizes_1m": sizes_1m,
        "digests_1m": [m.digest for metas in res_1m for m in metas],
        "launches": launches, "wall_s": wall, "runs_s": walls, "split_s": split,
        "gib_per_s": n_bytes / 2**30 / wall, "busy_ms": busy_ms,
        "window_kernel_ms": win_ms, "window_bound_ms": win_bound[0], "window_bound_by": win_bound[1],
        "padded_positions": padded,
        "batch_kernel_ms": batch_ms, "batch_bound_ms": batch_bound[0], "batch_bytes": total,
        "chunks_1m": len(sizes_1m), "runs_1m_s": walls_1m, "splits_1m_s": splits_1m,
        "longest_1m_blocks": longest_1m,
        "k2_1m_kernel_ms": k2_1m_ms, "k2_1m_bound_ms": bound_1m[0],
        "k1_err": k1_err, "k2_err": k2_err,
    }


def pack_lanes_phase(dev, tar, blob_n, res_n, blob_f, kernels) -> dict:
    """Phase 8: the pack ``jax`` lane, the file-like Pack and the fused
    lane's overflow fallback against phase 4's outputs."""
    from nydus_snapshotter_tpu_torch.converter import Pack, PackOption, pack_layer
    from nydus_snapshotter_tpu_torch.ops import fused_convert

    opt = dict(chunk_size=CHUNK_SIZE, compressor="none")
    with tarfile.open(fileobj=io.BytesIO(tar)) as tf:
        n_files = sum(1 for m in tf if m.isreg() and m.size)

    def bytes_jax():
        return pack_layer(tar, PackOption(backend="jax", **opt), device=dev)

    def stream_jax():
        out = io.BytesIO()
        res = Pack(out, io.BytesIO(tar), PackOption(backend="jax", **opt), device=dev)
        return out.getvalue(), res

    def fused_overflow():
        real = fused_convert._wcap_for
        fused_convert._wcap_for = lambda n, bits, floor=1024: 2
        try:
            return pack_layer(tar, PackOption(backend="fused", **opt), device=dev)
        finally:
            fused_convert._wcap_for = real

    submits = []
    out = {}
    for name, fn in (("jax", bytes_jax), ("jax_filelike", stream_jax),
                     ("fused_overflow", fused_overflow)):
        for k in kernels.values():
            k.launches = 0
        with submits_without_sync(submits):
            t0 = time.perf_counter()
            blob, res = fn()
            first = time.perf_counter() - t0
        launches = {key: k.launches for key, k in kernels.items()}
        if not (blob == blob_n == blob_f and res.bootstrap == res_n.bootstrap
                and res.blob_id == res_n.blob_id):
            raise AssertionError(f"pack {name} differs from the numpy and fused backends")
        # K1 once per non-empty file on the bytes lane; the file-like lane
        # cuts a large file in several drains, the fused lane adds its own
        # pass before it overflows.
        k1_ok = launches["gear"] == n_files if name == "jax" else launches["gear"] >= n_files
        if not k1_ok or launches["sha"] != len(submits) or not submits:
            raise AssertionError(f"pack {name}: launches {launches} for {n_files} non-empty "
                                 f"files, {len(submits)} digest batches")
        runs = [host_timed(fn) for _ in range(3)]
        walls = [r[0] for r in runs]
        log(f"[8] pack {name}: == numpy and fused byte for byte; launches {launches} "
            f"({n_files} non-empty files, {len(submits)} digest batches, each submitted under "
            f"sync debug mode 'error'); checked run {first:.2f} s, median {np.median(walls):.3f} s "
            "(runs, wall / host CPU s / minor page faults: "
            + ", ".join(f"{w:.3f} / {c:.3f} / {f}" for w, c, f in runs) + ")")
        out[name] = {"launches": launches, "batches": len(submits), "wall_s": float(np.median(walls)),
                     "runs_s": walls}
        submits.clear()
    return out


def b3_compressions(sizes: np.ndarray) -> tuple[float, int]:
    """BLAKE3 compressions the chunks of these sizes need (every leaf's
    blocks, at least one, and one parent per merge) -> (total, the longest
    dependent chain: a leaf's 16 blocks then log2 of the leaves, over all
    chunks)."""
    s = sizes.astype(np.int64)
    leaves = np.maximum((s + 1023) // 1024, 1)
    full, tail = s // 1024, s % 1024
    blocks = full * 16 + (tail + 63) // 64 + (s == 0)  # the empty chunk's one block
    total = float(blocks.sum() + (leaves - 1).sum())
    depth = int(np.ceil(np.log2(leaves.max()))) if len(s) else 0
    chain = int(np.minimum((s.max() + 63) // 64, 16)) + depth if len(s) else 0
    return total, max(chain, 1)


def k4_bound(sizes: np.ndarray, int_ops_per_s: float, sm_hz: float, round_cycles: float):
    """K4's bound over chunks of these sizes -> (ms, by, throughput-term ms,
    what bounds it, serial-term ms, compressions). Throughput: each chunk
    byte read once, offset + size in, 32 B of digest out, against every
    compression's operations; serial: the longest chain of dependent
    compressions (K4_CHAIN_DEPTH instructions each, at the cycles per
    dependent instruction measured by the round-latency probe)."""
    total, chain = b3_compressions(sizes)
    through, by = bound_ms(float(sizes.astype(np.int64).sum()) + len(sizes) * (8 + 32),
                           total * K4_OPS_PER_COMPRESSION, int_ops_per_s)
    serial = chain * K4_CHAIN_DEPTH * (round_cycles / K2_ROUND_DEPTH) / sm_hz * 1e3
    if serial > through:
        return serial, "operations", through, by, serial, total
    return through, by, through, by, serial, total


def k4_c(buffer, offs_d, sizes_d, m: int):
    """Launches of K4's two C entries over prepared pointers (leaf ends,
    scratch and output allocated here, once) -> (both, leaves, parents)."""
    import torch

    from nydus_snapshotter_tpu_torch.ops import blake3_cuda

    leaves = torch.clamp((sizes_d.long() + 1023) // 1024, min=1)
    leaf_end = torch.cumsum(leaves, 0)
    total, most = int(leaf_end[-1]), int(leaves.max())
    cvs = torch.empty((total, 8), dtype=torch.int32, device=buffer.device)
    cv_b = torch.empty((total if most > blake3_cuda.shared_cvs() else 1, 8), dtype=torch.int32,
                       device=buffer.device)
    out = torch.empty((m, 8), dtype=torch.int32, device=buffer.device)
    a = c_launch(blake3_cuda.LEAVES, buffer, offs_d, sizes_d, leaf_end, m, total, cvs, out)
    b = c_launch(blake3_cuda.PARENTS, sizes_d, leaf_end, m, cvs, cv_b, out)

    def both():
        a()
        b()

    both.tensors = (a.tensors, b.tensors)
    return both, a, b, out


def blake3_phase(dev, files, res_sha, buffer_dev, extents, windowed, tar, blob_f, res_f,
                 kernels, int_ops_per_s, sm_hz, rc) -> dict:
    """Phase 9: BLAKE3 (kernel K4) on every device path of the port."""
    import torch

    from nydus_snapshotter_tpu_torch.converter import PackOption, pack_layer
    from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap
    from nydus_snapshotter_tpu_torch.ops import blake3, blake3_cuda, chunker, fused_convert
    from nydus_snapshotter_tpu_torch.parallel import sharded_dict
    from nydus_snapshotter_tpu_torch.tensors import to_u32
    from nydus_snapshotter_tpu_torch.utils import blake3 as pyb3

    t_phase = time.perf_counter()
    n_bytes = sum(f.size for f in files)
    params = fused_convert.FusedDeviceEngine(chunk_size=CHUNK_SIZE, device=dev).params

    def plain_timed(buf, offs, sizes):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = blake3.blake3_chunks_plain(buf, offs, sizes)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def host_b3(raw: np.ndarray, offs, sizes) -> list[bytes]:
        return [pyb3.blake3(raw[o:o + s].tobytes()) for o, s in zip(offs.tolist(), sizes.tolist())]

    def le_words(digests: list[bytes]):
        return torch.from_numpy(np.frombuffer(b"".join(digests), dtype="<u4").astype(np.uint32)
                                .view(np.int32).reshape(-1, 8).copy())

    # -- K4 against its plain version: every chunk of phase 2's layer ------
    offs_h, sizes_h = torch.from_numpy(extents)
    main_k4 = blake3_cuda.blake3_chunks(buffer_dev, offs_h, sizes_h)
    main_plain, main_plain_ms = plain_timed(buffer_dev, offs_h, sizes_h)
    k4_err = max_abs_err(main_k4, main_plain)
    raw_main = buffer_dev.cpu().numpy()
    rng = np.random.default_rng(SEED + 9)
    pick = np.sort(rng.choice(extents.shape[1], 64, replace=False))
    k4_err = max(k4_err, max_abs_err(main_k4[pick].cpu(), le_words(
        host_b3(raw_main, extents[0, pick], extents[1, pick]))))
    # Edge rows at offsets 0..3 mod 4 (and mixed mod 16), in the same buffer.
    edge_sizes = [0, 1, 63, 64, 65, 1023, 1024, 1025, 2047, 2048, 2049, 3072, 3073, 16384,
                  16385, params.max_size]
    e_offs, e_sizes = [], []
    for i, size in enumerate(edge_sizes):
        for a in range(4):
            base = int(rng.integers(0, (n_bytes - params.max_size - 16) // 16)) * 16
            e_offs.append(base + 4 * ((i + a) % 4) + a)
            e_sizes.append(size)
    e_offs, e_sizes = np.asarray(e_offs, np.int32), np.asarray(e_sizes, np.int32)
    edge_k4 = blake3_cuda.blake3_chunks(buffer_dev, torch.from_numpy(e_offs), torch.from_numpy(e_sizes))
    edge_plain = blake3.blake3_chunks_plain(buffer_dev, torch.from_numpy(e_offs),
                                            torch.from_numpy(e_sizes))
    edge_host = host_b3(raw_main, e_offs, e_sizes)
    k4_err = max(k4_err, max_abs_err(edge_k4, edge_plain),
                 max_abs_err(edge_k4.cpu(), le_words(edge_host)))
    empty = blake3.digest_to_bytes(to_u32(edge_k4[0]))
    if not empty.hex().startswith("af1349b9f5f9a1a6") or empty != pyb3.blake3(b""):
        raise AssertionError(f"K4 digest of the empty chunk is {empty.hex()}")
    del raw_main

    # -- K4 against its plain version: phase 7's 1 MiB-chunk extents -------
    offs_1m, sizes_1m = windowed["offs_1m"], windowed["sizes_1m"]
    whole = np.zeros(-(-n_bytes // 16) * 16, np.uint8)
    whole[:n_bytes] = np.concatenate(files)
    w_buf = torch.from_numpy(whole).to(dev)
    o1m, s1m = torch.from_numpy(offs_1m), torch.from_numpy(sizes_1m)
    k4_1m = blake3_cuda.blake3_chunks(w_buf, o1m, s1m)
    plain_1m, plain_1m_ms = plain_timed(w_buf, o1m, s1m)
    k4_err = max(k4_err, max_abs_err(k4_1m, plain_1m))
    big = int(np.flatnonzero(sizes_1m >= 1 << 20)[np.argmin(sizes_1m[sizes_1m >= 1 << 20])])
    k4_err = max(k4_err, max_abs_err(k4_1m[big:big + 1].cpu(), le_words(
        host_b3(whole, offs_1m[big:big + 1], sizes_1m[big:big + 1]))))
    del whole
    if k4_err:
        raise AssertionError(f"K4 differs from its plain version or the pure-Python BLAKE3 "
                             f"(max err {k4_err})")
    log(f"[9] K4 == plain version on all {extents.shape[1]} chunks of phase 2 (plain "
        f"{main_plain_ms:.1f} ms, one run), all {len(sizes_1m)} 1 MiB-average chunks of phase 7 "
        f"(plain {plain_1m_ms:.1f} ms) and {len(e_sizes)} edge rows (sizes {edge_sizes} at "
        f"offsets 0..3 mod 4); == the pure-Python BLAKE3 on 64 layer chunks, the edge rows and "
        f"one {int(sizes_1m[big])}-byte chunk; empty chunk {empty.hex()[:16]}..")

    # -- fused process_many with a BLAKE3-keyed dict --------------------------
    flat_plain = to_u32(main_plain)
    starts = np.cumsum([0] + [len(c) for c in res_sha.cuts])
    dict_src = np.concatenate([flat_plain[starts[i]:starts[i + 1]]
                               for i in range(0, len(files), 3) if starts[i + 1] > starts[i]])
    _, first_idx = np.unique(
        np.ascontiguousarray(dict_src).view(np.dtype((np.void, 32)))[:, 0], return_index=True
    )
    dict_src = dict_src[np.sort(first_idx)]
    digests = np.concatenate([rng.integers(0, 2**32, (DICT_ENTRIES - len(dict_src), 8),
                                           dtype=np.uint32), dict_src])
    t0 = time.perf_counter()
    cdict = sharded_dict.ShardedChunkDict(digests, device=dev)
    keys, values, depth, _epoch = cdict.fused_probe_tables()
    build_s = time.perf_counter() - t0
    eng = fused_convert.FusedDeviceEngine(chunk_size=CHUNK_SIZE, digester="blake3", device=dev)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = eng.process_many(files, chunk_dict=cdict)
    first_s = time.perf_counter() - t0
    launches = {key: k.launches for key, k in kernels.items()}
    want = {"gear": 1, "sha": 0, "probe": 1, "b3_leaves": 1, "b3_parents": 1}
    if launches != want:
        raise AssertionError(f"fused BLAKE3 process_many launched {launches}; want {want}")
    for cuts, cuts_sha in zip(res.cuts, res_sha.cuts):
        if not np.array_equal(cuts, cuts_sha):
            raise AssertionError("fused BLAKE3 cuts differ from phase 2's")
    flat = [d for digs in res.digests for d in digs]
    q_host = np.frombuffer(b"".join(flat), dtype="<u4").astype(np.uint32).reshape(-1, 8)
    if not np.array_equal(q_host, flat_plain):
        raise AssertionError("fused BLAKE3 digests differ from the plain version")
    want_probe, _ = host_probe(keys, values, q_host, depth)
    if not np.array_equal(res.probe, want_probe):
        raise AssertionError("fused BLAKE3 probe answers differ from the host probe")
    n_hits = int((res.probe > 0).sum())
    if n_hits < len(dict_src):
        raise AssertionError(f"{n_hits} hits < {len(dict_src)} planted digests")
    walls, splits = [], []
    for _ in range(REPS):
        before = dict(eng.stats)
        t0 = time.perf_counter()
        eng.process_many(files, chunk_dict=cdict)
        walls.append(time.perf_counter() - t0)
        splits.append({k: eng.stats[k] - before[k] for k in ("pass1_s", "host_s", "pass2_s")})
    wall = float(np.median(walls))
    split = {k: float(np.median([x[k] for x in splits])) for k in splits[0]}
    busy_ms, by_name = device_busy(lambda: eng.process_many(files, chunk_dict=cdict))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"[9] fused process_many(digester='blake3'): {len(flat)} chunks, cuts == phase 2's, "
        f"digests == the plain version, {len(q_host)} probe answers == host probe ({n_hits} hits; "
        f"dict of {len(digests)} entries, {len(dict_src)} BLAKE3 digests from a third of the "
        f"files, max chain {depth}, built in {build_s:.1f} s); launches {launches}; checked run "
        f"{first_s:.3f} s; median {wall:.3f} s over {REPS} runs -> {n_bytes / 2**30 / wall:.3f} "
        f"GiB/s (runs: " + ", ".join(f"{x:.3f}" for x in walls) + f" s); pass1 "
        f"{split['pass1_s']:.3f} s, host {split['host_s']:.3f} s, pass2 {split['pass2_s']:.3f} s; "
        f"device busy {busy_ms:.3f} ms = {100 * busy_ms / (wall * 1e3):.1f}%, idle "
        f"{100 - 100 * busy_ms / (wall * 1e3):.1f}%; top: "
        + "; ".join(f"{n[:40]} {ms:.3f} ms" for n, ms in top))
    del cdict

    # -- the windowed engine at 1 MiB chunks --------------------------------
    weng = chunker.ChunkDigestEngine(backend="jax", digester="blake3", device=dev)
    for k in kernels.values():
        k.launches = 0
    submits = []
    t0 = time.perf_counter()
    with submits_without_sync(submits):
        metas = weng.process_many(files)
    win_s = time.perf_counter() - t0
    win_first = (weng.stats["boundaries_s"], weng.stats["digest_s"])
    win_launches = {key: k.launches for key, k in kernels.items()}
    nonempty = sum(1 for f in files if f.size)
    want = {"gear": nonempty, "sha": 0, "probe": 0, "b3_leaves": 1, "b3_parents": 1}
    if win_launches != want or submits != [len(sizes_1m)]:
        raise AssertionError(f"windowed BLAKE3 process_many launched {win_launches} over digest "
                             f"batches {submits}; want {want} over one batch")
    if [m.size for ms in metas for m in ms] != sizes_1m.tolist():
        raise AssertionError("windowed BLAKE3 cuts differ from phase 7's")
    if le_words([m.digest for ms in metas for m in ms]).tolist() != plain_1m.cpu().tolist():
        raise AssertionError("windowed BLAKE3 digests differ from the plain version")
    win_walls, win_splits = [], []
    for _ in range(WINDOWED_REPS):
        before = dict(weng.stats)
        t0 = time.perf_counter()
        weng.process_many(files)
        win_walls.append(time.perf_counter() - t0)
        win_splits.append(tuple(weng.stats[k] - before[k] for k in ("boundaries_s", "digest_s")))
    win_wall = float(np.median(win_walls))
    log(f"[9] windowed ChunkDigestEngine(backend='jax', digester='blake3') at 1 MiB chunks: "
        f"{len(sizes_1m)} chunks, cuts == phase 7's, digests == the plain version; launches "
        f"{win_launches}, the digest batch submitted under sync debug mode 'error'; checked run "
        f"{win_s:.3f}: {win_first[0]:.3f} + {win_first[1]:.3f} s; median {win_wall:.3f} s over {WINDOWED_REPS} runs after it (wall: boundaries_many + "
        "digest_all) " + ", ".join(f"{x:.3f}: {b:.3f} + {d:.3f}" for x, (b, d) in
                                   zip(win_walls, win_splits)) + " s (SHA-256, phase 7: "
        + ", ".join(f"{x:.3f}: {b:.3f} + {d:.3f}" for x, (b, d) in
                    zip(windowed["runs_1m_s"], windowed["splits_1m_s"])) + " s)")

    # -- pack, fused and jax lanes -------------------------------------------
    opt = dict(chunk_size=CHUNK_SIZE, compressor="none", digester="blake3")
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    blob_b, res_b = pack_layer(tar, PackOption(backend="fused", **opt), device=dev)
    pack_first = time.perf_counter() - t0
    pack_launches = {key: k.launches for key, k in kernels.items()}
    want = {"gear": 1, "sha": 0, "probe": 0, "b3_leaves": 1, "b3_parents": 1}
    if pack_launches != want:  # one fused batch: the tar is far below int32 addressing
        raise AssertionError(f"fused BLAKE3 pack launched {pack_launches}; want {want}")
    if blob_b[:res_b.blob_size] != blob_f[:res_f.blob_size] or res_b.blob_id != res_f.blob_id:
        raise AssertionError("the BLAKE3 pack's blob differs from phase 4's SHA-256 blob")
    chunks = Bootstrap.from_bytes(res_b.bootstrap).chunks
    data = np.zeros(-(-res_b.blob_size // 16) * 16, np.uint8)
    data[:res_b.blob_size] = np.frombuffer(blob_b, np.uint8, count=res_b.blob_size)
    c_offs = np.asarray([c.compressed_offset for c in chunks], np.int32)
    c_sizes = np.asarray([c.compressed_size for c in chunks], np.int32)
    boot_plain = blake3.blake3_chunks_plain(torch.from_numpy(data).to(dev), torch.from_numpy(c_offs),
                                            torch.from_numpy(c_sizes))
    if le_words([c.digest for c in chunks]).tolist() != boot_plain.cpu().tolist():
        raise AssertionError("the BLAKE3 pack's bootstrap digests differ from the plain version")
    del data
    pack_runs = []
    for _ in range(3):
        got = []
        pack_runs.append(host_timed(lambda: got.append(
            pack_layer(tar, PackOption(backend="fused", **opt), device=dev)[0])))
        if got[0] != blob_b:
            raise AssertionError("the fused BLAKE3 pack differs from its checked run")
    pack_wall = float(np.median([r[0] for r in pack_runs]))
    log(f"[9] pack fused, digester='blake3': blob and blob id == phase 4's SHA-256 fused blob, "
        f"{len(chunks)} bootstrap digests == the plain version; launches {pack_launches}; checked "
        f"run {pack_first:.3f} s, median {pack_wall:.3f} s (runs, wall / host CPU s / minor page "
        "faults: " + ", ".join(f"{w:.3f} / {c:.3f} / {f}" for w, c, f in pack_runs) + ")")

    with tarfile.open(fileobj=io.BytesIO(tar)) as tf:
        n_files = sum(1 for m in tf if m.isreg() and m.size)
    for k in kernels.values():
        k.launches = 0
    submits = []
    t0 = time.perf_counter()
    with submits_without_sync(submits):
        blob_j, res_j = pack_layer(tar, PackOption(backend="jax", **opt), device=dev)
    jax_first = time.perf_counter() - t0
    jax_launches = {key: k.launches for key, k in kernels.items()}
    if blob_j != blob_b or res_j.bootstrap != res_b.bootstrap or res_j.blob_id != res_b.blob_id:
        raise AssertionError("the jax lane's BLAKE3 pack differs from the fused lane's")
    # K1 once per non-empty file, K4's leaf launch once per digest batch
    # (its tree launch where the batch holds a chunk of two leaves or more)
    if (jax_launches["gear"] != n_files or jax_launches["sha"] or jax_launches["probe"]
            or not submits or jax_launches["b3_leaves"] != len(submits)
            or not 1 <= jax_launches["b3_parents"] <= len(submits)):
        raise AssertionError(f"jax BLAKE3 pack launched {jax_launches} for {n_files} non-empty "
                             f"files, {len(submits)} digest batches")
    jax_runs = []
    for _ in range(3):
        got = []
        jax_runs.append(host_timed(lambda: got.append(
            pack_layer(tar, PackOption(backend="jax", **opt), device=dev)[0])))
        if got[0] != blob_b:
            raise AssertionError("the jax lane's BLAKE3 pack differs from its checked run")
    jax_wall = float(np.median([r[0] for r in jax_runs]))
    log(f"[9] pack jax, digester='blake3': == the fused BLAKE3 pack (blob, bootstrap, blob id); "
        f"launches {jax_launches} ({n_files} non-empty files, {len(submits)} digest batches, each "
        f"submitted under sync debug mode 'error'); checked run {jax_first:.3f} s, median "
        f"{jax_wall:.3f} s (runs, wall / host CPU s / minor page faults: "
        + ", ".join(f"{w:.3f} / {c:.3f} / {f}" for w, c, f in jax_runs) + ")")

    # -- timings -------------------------------------------------------------
    offs_d, sizes_d = torch.from_numpy(extents).to(dev)
    both, leaves_only, parents_only, k4_out = k4_c(buffer_dev, offs_d, sizes_d, extents.shape[1])
    k_ms = kernel_ms(both, 20, sm_hz)
    k_leaves_ms = kernel_ms(leaves_only, 20, sm_hz)
    k_parents_ms = kernel_ms(parents_only, 20, sm_hz)
    if max_abs_err(k4_out, main_plain):
        raise AssertionError("K4 launched by kernel_ms differs from the plain version")
    call_ms = cuda_ms(lambda: blake3_cuda.blake3_chunks(buffer_dev, offs_h, sizes_h))
    o1_d, s1_d = torch.from_numpy(np.stack([offs_1m, sizes_1m])).to(dev)
    both_1m, _a, _b, out_1m = k4_c(w_buf, o1_d, s1_d, len(sizes_1m))
    k_1m_ms = kernel_ms(both_1m, 20, sm_hz)
    if max_abs_err(out_1m, plain_1m):
        raise AssertionError("K4 at 1 MiB chunks (kernel_ms) differs from the plain version")
    call_1m_ms = cuda_ms(lambda: blake3_cuda.blake3_chunks(w_buf, o1m, s1m))
    del w_buf
    bd = k4_bound(extents[1], int_ops_per_s, sm_hz, rc)
    bd_1m = k4_bound(sizes_1m, int_ops_per_s, sm_hz, rc)
    log(f"[9] K4 blake3_chunks over all {extents.shape[1]} chunks of one process_many "
        f"({int(bd[5])} compressions): kernel {k_ms:.4f} ms (leaf launch {k_leaves_ms:.4f}, tree "
        f"launch {k_parents_ms:.4f}), call {call_ms:.4f} ms (plain {main_plain_ms:.1f} ms, bound "
        f"{bd[0]:.4f} ms: throughput term {bd[2]:.4f} ms by {bd[3]}, serial term {bd[4]:.4f} ms; "
        f"{k_ms / bd[0]:.2f}x); at 1 MiB chunks ({len(sizes_1m)} chunks, {int(bd_1m[5])} "
        f"compressions): kernel {k_1m_ms:.4f} ms, call {call_1m_ms:.4f} ms (plain "
        f"{plain_1m_ms:.1f} ms, bound {bd_1m[0]:.4f} ms: throughput {bd_1m[2]:.4f}, serial "
        f"{bd_1m[4]:.4f}); phase {time.perf_counter() - t_phase:.1f} s")
    return {
        "launches": launches, "max_abs_err": k4_err, "kernel_ms": k_ms, "call_ms": call_ms,
        "leaves_kernel_ms": k_leaves_ms, "parents_kernel_ms": k_parents_ms,
        "plain_ms": main_plain_ms, "bound": bd, "kernel_1m_ms": k_1m_ms, "call_1m_ms": call_1m_ms,
        "plain_1m_ms": plain_1m_ms, "bound_1m": bd_1m, "windowed_launches": win_launches,
        "digests_u32": flat_plain, "digests_1m_u32": to_u32(plain_1m),
        "pack_fused_launches": pack_launches, "wall_s": wall, "gib_per_s": n_bytes / 2**30 / wall,
        "busy_ms": busy_ms, "pack_wall_s": pack_wall, "windowed_1m_wall_s": win_wall,
        "pack_jax_launches": jax_launches, "pack_jax_wall_s": jax_wall,
    }


def compressed_phase(dev, tar, lanes, kernels) -> dict:
    """Phase 10: compressed packs (lz4_block, zstd) and the rest of
    ``PackOption`` on the card's pack lanes, over phase 4's tar."""
    import tempfile

    import torch

    from nydus_snapshotter_tpu_torch import constants
    from nydus_snapshotter_tpu_torch.converter import Pack, PackOption, pack_layer
    from nydus_snapshotter_tpu_torch.converter.pack import _pack_threads
    from nydus_snapshotter_tpu_torch.models import fstree
    from nydus_snapshotter_tpu_torch.models.bootstrap import CHUNK_FLAG_BATCH, Bootstrap
    from nydus_snapshotter_tpu_torch.ops import blake3
    from nydus_snapshotter_tpu_torch.utils import lz4, zstd

    t_phase = time.perf_counter()
    libs = {"lz4_block": lz4.library(), "zstd": zstd.library()}
    log("[10] codec libraries: " + "; ".join(
        f"{c} {lib[0]} {lib[1]}" if lib else f"{c}: no system library bound" for c, lib in libs.items()))
    codecs = [c for c, lib in libs.items() if lib]
    for c in libs:
        if c not in codecs:
            log(f"[10] {c}: not run (its system library is not bound on this machine)")
    if not codecs:
        raise AssertionError("neither liblz4 nor libzstd is bound: no codec to run")

    with tarfile.open(fileobj=io.BytesIO(tar)) as tf:
        regs = [m for m in tf if m.isreg()]
    members = {fstree.norm_path(m.name): (m.offset_data, m.size) for m in regs}
    n_files = sum(1 for m in regs if m.size)
    file_bytes = sum(m.size for m in regs)

    def decompress(flag: int, frame: bytes, usize: int) -> bytes:
        kind = flag & constants.COMPRESSOR_MASK
        if kind == constants.COMPRESSOR_LZ4_BLOCK:
            return lz4.decompress_block(frame, usize)
        if kind == constants.COMPRESSOR_ZSTD:
            return zstd.decompress_block(frame)
        raise AssertionError(f"chunk flag {flag:#x}: not a compressed frame")

    def check_frames(res, sections: dict[str, bytes]) -> tuple[int, int, list]:
        """Every chunk record's frame, located by compressed_offset and
        compressed_size in its blob's data section and decompressed with the
        port's codec, equals the tar's bytes at that chunk's file offset.
        -> (records, distinct frames, the records' tar extents)."""
        boot = Bootstrap.from_bytes(res.bootstrap)
        batch_of = {(b.blob_index, b.compressed_offset): b for b in boot.batches}
        frames: dict[tuple[int, int], bytes] = {}
        extents = []
        for ino in boot.inodes:
            if not ino.chunk_count:
                continue
            off_data, size = members[ino.path]
            pos = 0
            for c in boot.chunks[ino.chunk_index:ino.chunk_index + ino.chunk_count]:
                key = (c.blob_index, c.compressed_offset)
                batch = batch_of[key] if c.flags & CHUNK_FLAG_BATCH else None
                data = frames.get(key)
                if data is None:
                    section = sections[boot.blobs[c.blob_index].blob_id]
                    frame = section[c.compressed_offset:c.compressed_offset + c.compressed_size]
                    usize = batch.uncompressed_size if batch else c.uncompressed_size
                    data = frames[key] = decompress(c.flags, frame, usize)
                    if len(data) != usize:
                        raise AssertionError(f"frame at {key} holds {len(data)} bytes, not {usize}")
                if batch:
                    lo = c.uncompressed_offset - batch.uncompressed_base
                    data = data[lo:lo + c.uncompressed_size]
                if data != tar[off_data + pos:off_data + pos + c.uncompressed_size]:
                    raise AssertionError(f"{ino.path}: the chunk at file offset {pos} does not "
                                         "decompress to the tar's bytes")
                extents.append((off_data + pos, c.uncompressed_size))
                pos += c.uncompressed_size
            if pos != size:
                raise AssertionError(f"{ino.path}: chunks cover {pos} of {size} bytes")
        return len(extents), len(frames), extents

    def counted(fn):
        for k in kernels.values():
            k.launches = 0
        submits = []
        with submits_without_sync(submits):
            t0 = time.perf_counter()
            out = fn()
            first = time.perf_counter() - t0
        return out, first, {key: k.launches for key, k in kernels.items()}, len(submits)

    def same(a, b) -> bool:
        return a[0] == b[0] and a[1].bootstrap == b[1].bootstrap and a[1].blob_id == b[1].blob_id

    def fmt_route(r: dict) -> str:
        return ", ".join(f"{k} {v}" for k, v in r.items())

    out: dict = {"codecs": {}, "libraries": {c: list(lib) if lib else None for c, lib in libs.items()}}
    for codec in codecs:
        opt = dict(chunk_size=CHUNK_SIZE, compressor=codec)
        st_n = {}
        t0 = time.perf_counter()
        ref = pack_layer(tar, PackOption(backend="numpy", **opt), stats=st_n)
        numpy_s = time.perf_counter() - t0
        n_rec, n_frames, _ext = check_frames(ref[1], {ref[1].blob_id: ref[0][:ref[1].blob_size]})
        ratio = ref[1].blob_size / file_bytes
        log(f"[10] {codec} numpy (the oracle): {len(ref[0])} byte layer blob, data section "
            f"{ref[1].blob_size} bytes = {ratio:.4f} of the {file_bytes} file bytes; all {n_rec} "
            f"chunk records' frames ({n_frames} distinct) decompress to the tar's bytes; "
            f"{numpy_s:.3f} s ({fmt_stats(st_n)})")
        res_c = {"numpy_s": numpy_s, "numpy_stats": st_n, "ratio": ratio, "records": n_rec,
                 "frames": n_frames, "data_bytes": ref[1].blob_size, "numpy_route": ref[1].route}
        n_unique = Bootstrap.from_bytes(ref[1].bootstrap).blobs[0].chunk_count
        for lane in ("fused", "jax"):
            got, first, launches, batches = counted(
                lambda: pack_layer(tar, PackOption(backend=lane, **opt), device=dev))
            if not same(got, ref):
                raise AssertionError(f"{codec} pack {lane} differs from the numpy lane")
            # The reference's writer choice for an in-memory tar: the deferred
            # section writer, its native pass (no Python replay), every unique
            # chunk a zero-copy extent of the tar.
            route = got[1].route
            want_route = {"lane": "fused" if lane == "fused" else "per_file", "writer": "deferred",
                          "native": True, "threads": _pack_threads(), "src0": n_unique, "src1": 0}
            if route != want_route:
                raise AssertionError(f"{codec} pack {lane} took {route}; want {want_route}")
            # the uncompressed twins' counts: fused one K1 and one K2 launch
            # (the tar is one batch); jax those of phase 8's jax pack
            want = ({"gear": 1, "sha": 1} if lane == "fused" else
                    {k: lanes["jax"]["launches"][k] for k in ("gear", "sha")})
            want.update(probe=0, b3_leaves=0, b3_parents=0)
            if (launches != want or (lane == "jax" and (launches["gear"] != n_files
                                                         or launches["sha"] != batches))):
                raise AssertionError(f"{codec} pack {lane} launched {launches}; want {want} "
                                     f"({n_files} non-empty files, {batches} digest batches)")
            runs, stats = [], []
            for _ in range(3):
                st, blobs = {}, []
                runs.append(host_timed(lambda: blobs.append(
                    pack_layer(tar, PackOption(backend=lane, **opt), device=dev, stats=st)[0])))
                stats.append(st)
                if blobs[0] != ref[0]:
                    raise AssertionError(f"{codec} pack {lane} differs from its checked run")
            wall = float(np.median([r[0] for r in runs]))
            batch_note = (f" ({batches} digest batches, each submitted under sync debug mode "
                          "'error')" if lane == "jax" else "")
            log(f"[10] {codec} pack {lane}: == numpy byte for byte; launches {launches}{batch_note}; "
                f"route: {fmt_route(route)} (no replay); checked run {first:.3f} s, median "
                f"{wall:.3f} s (runs, wall / host CPU s / minor page faults [stats s]: " + ", ".join(
                    f"{w:.3f} / {c:.3f} / {f} [{fmt_stats(s)}]" for (w, c, f), s in zip(runs, stats))
                + f"); the serial section writer, median run [stats s]: "
                f"{SERIAL_WRITER_COMPRESSED[codec, lane]}")
            res_c[lane] = {"launches": launches, "batches": batches, "first_s": first, "wall_s": wall,
                           "runs": [list(r) for r in runs], "stats": stats, "route": route}

        # The same fused pack on one section thread, and through the
        # file-like Pack (every member streamed, the serial section writer).
        st1, got1 = {}, []
        with pack_threads("1"):
            one = host_timed(lambda: got1.append(pack_layer(
                tar, PackOption(backend="fused", **opt), device=dev, stats=st1)))
        if not same(got1[0], ref) or got1[0][1].route["threads"] != 1:
            raise AssertionError(f"{codec} fused pack at NTPU_PACK_THREADS=1 differs "
                                 f"({got1[0][1].route})")
        del got1
        st_s, got_s = {}, []
        stream = io.BytesIO()
        t_s = host_timed(lambda: got_s.append(Pack(
            stream, io.BytesIO(tar), PackOption(backend="fused", **opt), device=dev, stats=st_s)))
        sres = got_s[0]
        if not same((stream.getvalue(), sres), ref) or sres.route["writer"] != "serial":
            raise AssertionError(f"{codec} file-like Pack differs from the in-memory packs "
                                 f"({sres.route})")
        del stream
        log(f"[10] {codec} fused pack at NTPU_PACK_THREADS=1: == byte for byte, {one[0]:.3f} s / "
            f"host CPU {one[1]:.3f} s [{fmt_stats(st1)}]; the file-like Pack (BytesIO of the tar, "
            f"{fmt_route(sres.route)}): == blob, bootstrap and blob id, {t_s[0]:.3f} s / host CPU "
            f"{t_s[1]:.3f} s [{fmt_stats(st_s)}]")
        res_c.update(one_thread=list(one), one_thread_stats=st1, file_like=list(t_s),
                     file_like_stats=st_s)
        if codec == "zstd":  # phase 14 decrypts its encrypted twin against it
            out["zstd_ref"] = ref
        out["codecs"][codec] = res_c

    # -- every new option at once: one fused pack against its numpy twin -----
    codec = "zstd" if "zstd" in codecs else codecs[0]
    third = io.BytesIO()
    with tarfile.open(fileobj=third, mode="w", format=tarfile.GNU_FORMAT) as tf:
        for m in regs[::3]:
            tf.addfile(m, io.BytesIO(tar[m.offset_data:m.offset_data + m.size]))
    # The numpy lane's BLAKE3 host arm is pure Python (~0.4 MB/s): the dict
    # pack and the twin below cut on the host and digest with K4
    # (digest_backend="jax"); the pack's digests are held against the plain
    # BLAKE3 version separately.
    common = dict(chunk_size=CHUNK_SIZE, compressor=codec, digester="blake3", batch_size=0x10000)
    t0 = time.perf_counter()
    dblob, dres = pack_layer(third.getvalue(), PackOption(backend="numpy", digest_backend="jax",
                                                          **common), device=dev)
    dict_s = time.perf_counter() - t0
    prefetch = ["layer0/d5", "/layer0/d7/f7.bin", "layer0/d1/f1.bin/"]
    want_prefetch = sorted(p for p in members if p.startswith("/layer0/d5/")) + [
        "/layer0/d7/f7.bin", "/layer0/d1/f1.bin"]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "dict.boot"
        path.write_bytes(dres.bootstrap)
        opt_all = dict(common, prefetch_patterns="\n".join(prefetch),
                       chunk_dict_path=f"bootstrap={path}")
        st_a = {}
        fused, first, launches, _b = counted(
            lambda: pack_layer(tar, PackOption(backend="fused", **opt_all), device=dev, stats=st_a))
        want = {"gear": 1, "sha": 0, "probe": 0, "b3_leaves": 1, "b3_parents": 1}
        if launches != want:
            raise AssertionError(f"the all-options fused pack launched {launches}; want {want}")
        st_t = {}
        t0 = time.perf_counter()
        twin = pack_layer(tar, PackOption(backend="numpy", digest_backend="jax", **opt_all), device=dev,
                          stats=st_t)
        twin_s = time.perf_counter() - t0
        # the numpy lane as it is: BLAKE3 on the native host arm, no device
        for k in kernels.values():
            k.launches = 0
        st_h = {}
        t0 = time.perf_counter()
        host_twin = pack_layer(tar, PackOption(backend="numpy", **opt_all), stats=st_h)
        host_s = time.perf_counter() - t0
        host_launches = {key: k.launches for key, k in kernels.items()}
    if not same(fused, twin) or not same(fused, host_twin):
        raise AssertionError("the all-options fused pack differs from its numpy twins")
    if any(host_launches.values()):
        raise AssertionError(f"the all-options numpy twin launched {host_launches}")
    res = fused[1]
    boot = Bootstrap.from_bytes(res.bootstrap)
    hits = sum(1 for c in boot.chunks if c.blob_index == 1)
    own_batches = sum(1 for b in boot.batches if b.blob_index == 0)
    dict_batches = sum(1 for b in boot.batches if b.blob_index == 1)
    if res.referenced_blob_ids != [res.blob_id, dres.blob_id] or not hits:
        raise AssertionError(f"the all-options pack shows no dict hits ({res.referenced_blob_ids})")
    if not own_batches or not dict_batches:
        raise AssertionError(f"batch records: {own_batches} own, {dict_batches} from the dict")
    if boot.prefetch != want_prefetch:
        raise AssertionError(f"prefetch table {boot.prefetch[:4]}..; want {want_prefetch[:4]}..")
    n_rec, n_frames, extents = check_frames(res, {res.blob_id: fused[0][:res.blob_size],
                                                  dres.blob_id: dblob[:dres.blob_size]})
    ext = np.asarray(extents, np.int64).T
    buf = np.zeros(-(-len(tar) // 16) * 16, np.uint8)
    buf[:len(tar)] = np.frombuffer(tar, np.uint8)
    plain = blake3.blake3_chunks_plain(torch.from_numpy(buf).to(dev),
                                       torch.from_numpy(ext[0].astype(np.int32)),
                                       torch.from_numpy(ext[1].astype(np.int32)))
    digests = np.frombuffer(b"".join(c.digest for ino in boot.inodes if ino.chunk_count
                                     for c in boot.chunks[ino.chunk_index:ino.chunk_index
                                                          + ino.chunk_count]), "<u4")
    if not np.array_equal(digests.astype(np.uint32).view(np.int32).reshape(-1, 8),
                          plain.cpu().numpy()):
        raise AssertionError("the all-options pack's BLAKE3 digests differ from the plain version")
    del buf
    log(f"[10] all options, {codec} + blake3 + batch_size 0x10000 + prefetch_patterns {prefetch} + "
        f"chunk_dict_path (the bootstrap of a numpy pack of every third file, {dict_s:.3f} s): "
        f"fused == its numpy twins (digest_backend='jax', and the host lane: native BLAKE3, no "
        f"launch, {host_s:.3f} s [{fmt_stats(st_h)}]) byte for byte; launches {launches}; "
        f"{hits} dict hits, {own_batches} own and {dict_batches} dict batch records, "
        f"{len(boot.prefetch)} prefetch entries; all {n_rec} records' frames ({n_frames} distinct, "
        f"own and dict blob) decompress to the tar's bytes and their BLAKE3 digests == the plain "
        f"version; fused {first:.3f} s ({fmt_stats(st_a)}), twin {twin_s:.3f} s "
        f"({fmt_stats(st_t)}); phase {time.perf_counter() - t_phase:.1f} s")
    out["all_options"] = {"codec": codec, "launches": launches, "fused_s": first, "fused_stats": st_a,
                          "twin_s": twin_s, "host_twin_s": host_s, "dict_hits": hits,
                          "dict_bootstrap": dres.bootstrap, "own_batches": own_batches,
                          "dict_batches": dict_batches, "prefetch": len(boot.prefetch)}
    return out


# ---------------------------------------------------------------------------


def growth_phase(dev, grown: dict, kernels) -> dict:
    """Phase 11a: the registry dict of phase 6 grown, saved, loaded and
    saved incrementally, every lookup through K3."""
    import tempfile

    import torch

    from nydus_snapshotter_tpu_torch.ops import probe_cuda
    from nydus_snapshotter_tpu_torch.parallel import sharded_dict

    cdict, digests, queries, answers, rng = (
        grown[k] for k in ("dict", "digests", "queries", "answers", "rng"))
    n = len(digests)
    # tools/registry_scale.py's next draws: the growth batch, then the
    # random half of its probe sample.
    grow = rng.integers(0, 2**32, (REGISTRY_GROW, 8), dtype=np.uint32)
    grow_q = np.concatenate(
        [grow[::41], rng.integers(0, 2**32, (REGISTRY_GROW_Q_RANDOM, 8), dtype=np.uint32)])
    second = rng.integers(0, 2**32, (REGISTRY_SECOND, 8), dtype=np.uint32)
    launches = []

    def lookup(d, q):  # one lookup_u32, its K3 launches recorded
        kernels["probe"].launches = 0
        got = d.lookup_u32(q)
        launches.append(kernels["probe"].launches)
        if launches[-1] != 1:
            raise AssertionError(f"K3 launched {launches[-1]} times in one lookup_u32")
        return got

    restages0, depth0 = cdict.restages, cdict.max_depth
    t = {}
    t0 = time.perf_counter()
    idx = cdict.insert_u32(grow)
    t["insert_s"] = time.perf_counter() - t0
    if not np.array_equal(idx, np.arange(n, n + REGISTRY_GROW)):
        raise AssertionError("the growth batch was not given indices n .. n + 2M - 1")
    t0 = time.perf_counter()
    cdict.device_snapshot()
    torch.cuda.synchronize()
    t["restage_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = lookup(cdict, queries)
    t["first_lookup_s"] = time.perf_counter() - t0
    if not np.array_equal(got, answers):
        raise AssertionError("phase 6's queries answer differently after the insert")
    runs = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        again = lookup(cdict, queries)
        runs.append(time.perf_counter() - t0)
        if not np.array_equal(again, answers):
            raise AssertionError("lookup_u32 answers differ between calls after the insert")
    t["lookup_s"] = float(np.median(runs))
    if not np.array_equal(lookup(cdict, grow[:1000]), np.arange(n, n + 1000)):
        raise AssertionError("grow[:1000] does not answer arange(n, n + 1000)")
    grown_q = lookup(cdict, grow_q)

    t0 = time.perf_counter()
    fresh = sharded_dict.ShardedChunkDict(np.concatenate([digests, grow]), device=dev)
    t["fresh_build_s"] = time.perf_counter() - t0
    fresh_cap, fresh_depth = fresh.capacity, fresh.max_depth
    if not np.array_equal(lookup(fresh, grow_q), grown_q):
        raise AssertionError("the grown dict differs from a fresh build over the concatenation")
    del fresh
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "registry.dict")
        t0 = time.perf_counter()
        cdict.save(path)
        t["save_s"] = time.perf_counter() - t0
        file_mib = Path(path).stat().st_size / 2**20
        t0 = time.perf_counter()
        loaded = sharded_dict.ShardedChunkDict.load(path, device=dev)
        t["load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if not (np.array_equal(lookup(loaded, queries), answers)
                and np.array_equal(lookup(loaded, grow_q), grown_q)):
            raise AssertionError("the loaded dict answers differently")
        t["loaded_first_lookup_s"] = time.perf_counter() - t0
        del loaded
        torch.cuda.empty_cache()

        epoch_before = cdict.epoch
        t0 = time.perf_counter()
        idx2 = cdict.insert_u32(second)
        t["second_insert_s"] = time.perf_counter() - t0
        base2 = n + REGISTRY_GROW
        if not np.array_equal(idx2, np.arange(base2, base2 + REGISTRY_SECOND)):
            raise AssertionError("the second batch was not given consecutive indices")
        second_ans = lookup(cdict, second)
        t0 = time.perf_counter()
        inc = cdict.save_incremental(path)
        t["save_incremental_s"] = time.perf_counter() - t0
        if inc != {"mode": "append", "appended": REGISTRY_SECOND}:
            raise AssertionError(f"save_incremental reported {inc}")
        digs, vals, _epoch = cdict.entries_since(epoch_before)
        if not (np.array_equal(digs, second) and np.array_equal(vals, idx2)):
            raise AssertionError("entries_since(epoch before) is not exactly the second batch")
        t0 = time.perf_counter()
        reloaded = sharded_dict.ShardedChunkDict.load(path, device=dev)
        t["tail_load_s"] = time.perf_counter() - t0
        if not (np.array_equal(lookup(reloaded, queries), answers)
                and np.array_equal(lookup(reloaded, grow_q), grown_q)
                and np.array_equal(lookup(reloaded, second), second_ans)):
            raise AssertionError("the dict loaded with its tail replayed answers differently")
        del reloaded
        torch.cuda.empty_cache()
    restages = cdict.restages - restages0
    if restages != 2:  # the growth batch and the second batch, each probed after
        raise AssertionError(f"{restages} restages for 2 mutations that probes followed")
    log(f"[11] growth: {REGISTRY_GROW} digests (tools/registry_scale.py's grow batch) into "
        f"phase 6's {n}-entry dict: indices n .. n + {REGISTRY_GROW - 1}; insert "
        f"{t['insert_s']:.3f} s (native upsert), max chain {depth0} -> {cdict.max_depth}; restage "
        f"{t['restage_s']:.3f} s (pad + upload of {cdict.capacity} slots); first lookup_u32 after "
        f"it {t['first_lookup_s'] * 1e3:.3f} ms, median of {REPS} {t['lookup_s'] * 1e3:.3f} ms "
        f"(runs " + ", ".join(f"{x * 1e3:.3f}" for x in runs) + f" ms) = "
        f"{len(queries) / t['lookup_s'] / 1e6:.2f} M queries/s; phase 6's {len(queries)} answers "
        f"unchanged, grow[:1000] == arange(n, n + 1000), {len(grow_q)} sampled answers == a fresh "
        f"native build over the concatenation ({fresh_cap} slots, max chain {fresh_depth}, built in "
        f"{t['fresh_build_s']:.2f} s), probed with K3")
    log(f"[11] persistence: save {t['save_s']:.2f} s ({file_mib:.0f} MiB), load (mmap) "
        f"{t['load_s']:.3f} s, its first lookups {t['loaded_first_lookup_s']:.2f} s (restage from "
        f"the map included), answers identical; second insert of {REGISTRY_SECOND} in "
        f"{t['second_insert_s'] * 1e3:.1f} ms, save_incremental {inc} in "
        f"{t['save_incremental_s'] * 1e3:.1f} ms, load with the tail replayed "
        f"{t['tail_load_s']:.3f} s, answers identical; entries_since == the second batch; "
        f"{restages} restages; K3 launches per lookup_u32 {sorted(set(launches))} over "
        f"{len(launches)} calls")
    return {"launches_per_lookup": sorted(set(launches)), "lookups": len(launches),
            "restages": restages, "depth_before": depth0, "depth_after": cdict.max_depth,
            "lookup_runs_ms": [x * 1e3 for x in runs], "file_mib": file_mib,
            "fresh_capacity": fresh_cap, "fresh_depth": fresh_depth, **t}


def fused_after_insert_phase(dev, eng, files, first, cdict, kernels) -> dict:
    """Phase 11c: phase 2's fused process_many against its dict after an
    insert_u32 of the digests of another third of the layer's files."""
    keys_of = [np.frombuffer(b"".join(d), dtype=">u4").astype(np.uint32).reshape(-1, 8)
               for i, d in enumerate(first.digests) if i % 3 == 1 and d]
    extra = np.concatenate(keys_of)
    epoch0 = cdict.epoch
    t0 = time.perf_counter()
    idx = cdict.insert_u32(extra)
    insert_s = time.perf_counter() - t0
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = eng.process_many(files, chunk_dict=cdict)
    wall_s = time.perf_counter() - t0
    launches = {key: k.launches for key, k in kernels.items()}
    if launches["probe"] != 1:
        raise AssertionError(f"K3 launched {launches['probe']} times in process_many")
    keys, values, depth, epoch = cdict.fused_probe_tables()
    q_host = np.concatenate(
        [np.frombuffer(b"".join(d), dtype=">u4").astype(np.uint32).reshape(-1, 8)
         for d in res.digests if d])
    want, _ = host_probe(keys, values, q_host, depth)
    if not np.array_equal(res.probe, want):
        raise AssertionError("probe answers after the insert differ from the host probe")
    pos = {}
    for d, v in zip(extra.view(np.dtype((np.void, 32)))[:, 0].tolist(), idx.tolist()):
        pos.setdefault(d, v + 1)
    got = dict(zip(q_host.view(np.dtype((np.void, 32)))[:, 0].tolist(), res.probe.tolist()))
    if any(got.get(d, v) != v for d, v in pos.items()):
        raise AssertionError("an inserted digest does not answer its assigned index")
    hits = int((res.probe > 0).sum())
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = eng.process_many(files, chunk_dict=cdict)
        runs.append(time.perf_counter() - t0)
        if not np.array_equal(again.probe, res.probe):
            raise AssertionError("probe answers differ between process_many calls")
    log(f"[11] fused after insert: {len(extra)} digests of another third of the layer's files "
        f"into phase 2's dict (epoch {epoch0} -> {epoch}, max chain {depth}) in "
        f"{insert_s * 1e3:.1f} ms; process_many {wall_s:.3f} s (the dict's restage included), "
        f"launches {launches}; {len(q_host)} probe answers == host probe of the grown table, "
        f"{hits} hits, every inserted digest == its assigned index; median of 3 after it "
        f"{np.median(runs):.3f} s (runs " + ", ".join(f"{x:.3f}" for x in runs) + " s)")
    return {"launches": launches, "insert_s": insert_s, "wall_s": wall_s, "hits": hits,
            "depth": depth, "median_s": float(np.median(runs)), "runs_s": runs}


def service_phase(dev, tar, blob_f, res_f, kernels) -> dict:
    """Phase 11b: a DictService on the card over a unix socket, probed with
    one RPC, timed in merge-then-probe cycles (the first probe after a merge
    restages the grown table) and packed through with service://."""
    import tempfile

    from nydus_snapshotter_tpu_torch.converter import PackOption, pack_layer
    from nydus_snapshotter_tpu_torch.converter.batch import GrowingChunkDict
    from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap
    from nydus_snapshotter_tpu_torch.parallel.dict_service import DictClient, DictService

    src = tarfile.open(fileobj=io.BytesIO(tar))
    regs = [m for m in src.getmembers() if m.isreg()]
    opt = dict(chunk_size=CHUNK_SIZE, compressor="none")

    def boot_of(members):  # the bootstrap of a fused pack of these files
        part = io.BytesIO()
        with tarfile.open(fileobj=part, mode="w", format=tarfile.GNU_FORMAT) as tf:
            for m in members:
                tf.addfile(m, io.BytesIO(tar[m.offset_data:m.offset_data + m.size]))
        return pack_layer(part.getvalue(), PackOption(backend="fused", **opt), device=dev)[1]

    dres = boot_of(regs[::3])
    seed = Bootstrap.from_bytes(dres.bootstrap)
    # one image's bootstrap per merge-then-probe cycle: disjoint files
    cycle_boots = [boot_of(regs[1::3][i::SERVICE_REPS]).bootstrap for i in range(SERVICE_REPS)]
    private = GrowingChunkDict(seed=seed)
    pos = {c.digest: i for i, c in enumerate(private.bootstrap.chunks)}
    digs = [c.digest for c in Bootstrap.from_bytes(res_f.bootstrap).chunks]
    want = np.asarray([pos.get(d, -1) for d in digs], dtype=np.int64)
    with tempfile.TemporaryDirectory() as tmp:
        svc = DictService(device=dev)
        svc.run(str(Path(tmp) / "dict.sock"))
        try:
            cli = DictClient(svc.sock_path)
            merges = []
            for i in range(SERVICE_REPS):  # each into a fresh namespace: a real merge
                t0 = time.perf_counter()
                st = cli.merge(dres.bootstrap, f"m{i}")
                merges.append(time.perf_counter() - t0)
                if st["added"] != len(private):
                    raise AssertionError(f"merge added {st['added']} of {len(private)} chunks")
            cli.merge(dres.bootstrap, "ns")
            probes, rpc_launches = [], []

            def probe_rpc(ns, expect):  # one probe RPC, its K3 launches recorded
                kernels["probe"].launches = 0
                t0 = time.perf_counter()
                ans = cli.probe(digs, ns)
                took = time.perf_counter() - t0
                rpc_launches.append(kernels["probe"].launches)
                if rpc_launches[-1] != 1:
                    raise AssertionError(f"K3 launched {rpc_launches[-1]} times in one probe RPC")
                if not np.array_equal(ans, expect):
                    raise AssertionError("probe RPC answers differ from GrowingChunkDict positions")
                return took

            for i in range(1 + SERVICE_REPS):
                probes.append(probe_rpc("ns", want))
            observed = service_planes(svc, probe_rpc, want)
            # A service's traffic: one merge and one probe per converted
            # image. Each merge grows the namespace's table, so the first
            # probe after it restages the padded device copy.
            records = GrowingChunkDict(seed=seed)
            cli.merge(dres.bootstrap, "cycle")
            probe_rpc("cycle", want)
            index = svc._dicts["cycle"].index
            cycles = []  # (merge s, first probe s, second probe s, restages)
            for boot in cycle_boots:
                restages = index.restages
                t0 = time.perf_counter()
                st = cli.merge(boot, "cycle")
                merge_s = time.perf_counter() - t0
                added = records.add_bootstrap(Bootstrap.from_bytes(boot))
                if st["added"] != added or not added:
                    raise AssertionError(f"cycle merge added {st['added']}; want {added} (> 0)")
                cpos = {c.digest: i for i, c in enumerate(records.bootstrap.chunks)}
                cwant = np.asarray([cpos.get(d, -1) for d in digs], dtype=np.int64)
                after_s = probe_rpc("cycle", cwant)
                again_s = probe_rpc("cycle", cwant)
                cycles.append((merge_s, after_s, again_s, index.restages - restages))
                if cycles[-1][3] != 1:
                    raise AssertionError(f"{cycles[-1][3]} restages in one merge-then-probe cycle")
            path = f"service://{svc.sock_path}#ns"
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            via = pack_layer(tar, PackOption(backend="fused", chunk_dict_path=path, **opt),
                             device=dev)
            first_s = time.perf_counter() - t0
            launches = {key: k.launches for key, k in kernels.items()}
            priv = pack_layer(tar, PackOption(backend="fused", **opt), chunk_dict=private,
                              device=dev)
            if not (via[0] == priv[0] and via[1].bootstrap == priv[1].bootstrap
                    and via[1].blob_id == priv[1].blob_id):
                raise AssertionError("the service:// pack differs from the private-dict pack")
            if dres.blob_id not in via[1].referenced_blob_ids or via[0] == blob_f:
                raise AssertionError("the service:// pack found no dict hit")
            packs, privs = [], []  # in turns: service, private
            for _ in range(SERVICE_REPS):
                for runs, kw, cd in ((packs, {"chunk_dict_path": path}, None), (privs, {}, private)):
                    t0 = time.perf_counter()
                    again = pack_layer(tar, PackOption(backend="fused", **opt, **kw), chunk_dict=cd,
                                       device=dev)
                    runs.append(time.perf_counter() - t0)
                    if again[0] != via[0]:
                        raise AssertionError("a timed pack differs from the checked service:// pack")
            cli.close()
        finally:
            svc.stop()
    hits = int((want >= 0).sum())
    out = {"probe_launches": sorted(set(rpc_launches)), "pack_launches": launches,
           "digests": len(digs), "hits": hits,
           "dict_chunks": len(private), "merge_ms": float(np.median(merges)) * 1e3,
           "probe_rpc_ms": float(np.median(probes[1:])) * 1e3,
           "probe_rpc_runs_ms": [x * 1e3 for x in probes],
           "cycle_chunks": len(records), "cycle_capacity": index.capacity,
           "cycle_merge_ms": float(np.median([c[0] for c in cycles])) * 1e3,
           "probe_after_merge_ms": float(np.median([c[1] for c in cycles])) * 1e3,
           "probe_after_merge_runs_ms": [c[1] * 1e3 for c in cycles],
           "probe_second_after_merge_ms": float(np.median([c[2] for c in cycles])) * 1e3,
           "pack_s": float(np.median(packs)), "pack_runs_s": packs, "pack_first_s": first_s,
           "private_pack_s": float(np.median(privs)), "private_pack_runs_s": privs,
           "planes": observed}
    log(f"[11] service: DictService on {dev} over a unix socket; merge of a {len(private)}-chunk "
        f"bootstrap (fused SHA-256 pack of every third file of phase 4's tar) median "
        f"{out['merge_ms']:.1f} ms (runs " + ", ".join(f"{x * 1e3:.1f}" for x in merges)
        + f" ms); probe RPC of all {len(digs)} chunk digests of phase 4's tar: one K3 launch, "
        f"answers == GrowingChunkDict positions ({hits} hits), median {out['probe_rpc_ms']:.2f} ms "
        f"after the first (runs " + ", ".join(f"{x * 1e3:.2f}" for x in probes) + " ms); K3 "
        f"launches per RPC {out['probe_launches']}")
    log(f"[11] service merge-then-probe: {SERVICE_REPS} cycles into one namespace (disjoint files "
        f"of phase 4's tar; {out['cycle_chunks']} chunks, capacity {out['cycle_capacity']} at the "
        f"end), one restage each; merge median {out['cycle_merge_ms']:.1f} ms, first probe RPC "
        f"after it {out['probe_after_merge_ms']:.2f} ms (runs " + ", ".join(
            f"{c[1] * 1e3:.2f}" for c in cycles) + f" ms), the second "
        f"{out['probe_second_after_merge_ms']:.2f} ms")
    log(f"[11] service:// pack: fused pack_layer of phase 4's tar through the service == the "
        f"private GrowingChunkDict pack (blob, bootstrap, blob id), dict blob referenced; "
        f"launches {launches}; checked run {first_s:.3f} s; in turns with the private-dict pack, "
        f"median of {SERVICE_REPS} {out['pack_s']:.3f} s (runs " + ", ".join(f"{x:.3f}" for x in packs)
        + f" s) against {out['private_pack_s']:.3f} s (runs " + ", ".join(f"{x:.3f}" for x in privs)
        + " s)")
    return out


def uds_get(sock_path: str, path: str) -> tuple[int, bytes]:
    import http.client
    import socket

    class Conn(http.client.HTTPConnection):
        def connect(self):
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self.sock.connect(sock_path)

    conn = Conn("localhost", timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def service_planes(svc, probe_rpc, want) -> dict:
    """Phase 11c: a probe RPC inside a client span: the service's
    ``dict.rpc.probe`` span (K3 inside it) joins the client's trace; then
    ``GET /metrics`` and ``GET /api/v1/traces`` on the service."""
    from nydus_snapshotter_tpu_torch import trace

    trace.configure(enabled=True, ring_capacity=1 << 16, slow_op_threshold_ms=0)
    with trace.span("convert", image="chip_smoke") as root:
        took = probe_rpc("ns", want)
    rpc = [sp for sp in trace.snapshot_spans() if sp.name == "dict.rpc.probe"]
    if len(rpc) != 1 or (rpc[0].trace_id, rpc[0].parent_id) != (root.trace_id, root.span_id):
        raise AssertionError(f"the dict.rpc.probe spans {[(sp.trace_id, sp.parent_id) for sp in rpc]}"
                             f" do not join the client's trace {root.trace_id} / {root.span_id}")
    got = {}
    for path, needle in (("/metrics", b"# TYPE ntpu_trace_spans_total counter"),
                         ("/api/v1/traces", b'"dict.rpc.probe"')):
        status, body = uds_get(svc.sock_path, path)
        if status != 200 or needle not in body:
            raise AssertionError(f"GET {path} on the dict service: {status}, {body[:200]!r}")
        got[path] = len(body)
    from nydus_snapshotter_tpu_torch.parallel import dict_service

    out = {"rpc_span_ms": rpc[0].duration_ms, "rpc_wall_ms": took * 1e3,
           "trace_id": f"{root.trace_id:x}", "metrics_bytes": got["/metrics"],
           "traces_bytes": got["/api/v1/traces"],
           "rpc_total_probe": dict_service._RPC_TOTAL.value("probe")}
    log(f"[11] service planes: a probe RPC in a client span: the service's dict.rpc.probe span "
        f"(K3 inside it, {out['rpc_span_ms']:.2f} ms of the RPC's {out['rpc_wall_ms']:.2f} ms) "
        f"joins trace {out['trace_id']}; GET /metrics {got['/metrics']} bytes, GET /api/v1/traces "
        f"{got['/api/v1/traces']} bytes; {out['rpc_total_probe']:.0f} probe RPCs counted")
    return out


def cpu_flag(flag: str) -> bool:
    """Whether /proc/cpuinfo lists ``flag`` for this host's CPU."""
    try:
        with open("/proc/cpuinfo") as f:
            return any(line.startswith("flags") and flag in line.split() for line in f)
    except OSError:
        return False


def host_arms_phase(dev, files, res_sha, windowed, b3, e2e_s, tar, comp, kernels) -> dict:
    """Phase 12: the native engine's host arms on the card machine, the
    ``hybrid`` engine and its pack lanes; no kernel may launch in them."""
    import os
    import tempfile

    from nydus_snapshotter_tpu_torch.converter import PackOption, pack_layer
    from nydus_snapshotter_tpu_torch.converter.pack import _pack_threads
    from nydus_snapshotter_tpu_torch.ops import chunker, native_cdc

    t_phase = time.perf_counter()
    arm = {3: "avx512", 2: "avx2", 1: "scalar"}
    isa = {"gear": native_cdc.gear_active_isa(), "cdc": native_cdc.cdc_active_isa(),
           "b3": native_cdc.b3_active_isa(), "sha_ni": cpu_flag("sha_ni")}
    cores = {"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
             "pack_threads": _pack_threads()}
    log(f"[12] host: os.cpu_count() {cores['cpu_count']}, {cores['affinity']} cores in this "
        f"process's affinity mask, _pack_threads() {cores['pack_threads']}; the engine's arms: gear "
        f"bitmaps {arm[isa['gear']]}, table scan {arm[isa['cdc']]}, BLAKE3 leaves "
        f"{arm[isa['b3']]}; SHA-NI {'in use' if isa['sha_ni'] else 'absent (scalar SHA-256)'}")
    n_bytes = sum(f.size for f in files)

    def zero():
        for k in kernels.values():
            k.launches = 0

    def no_launch(what: str):
        got = {key: k.launches for key, k in kernels.items()}
        if any(got.values()):
            raise AssertionError(f"{what} launched {got}; the host lane launches nothing")

    def words(digests: list[bytes]) -> np.ndarray:
        return np.frombuffer(b"".join(digests), dtype="<u4").astype(np.uint32).reshape(-1, 8)

    # -- (a) the engine over phase 2's layer --------------------------------
    sizes_64k = [np.diff(np.concatenate([[0], c])).tolist() for c in res_sha.cuts]
    cases = [
        (CHUNK_SIZE, "sha256", [s for f in sizes_64k for s in f],
         lambda d: d == [x for digs in res_sha.digests for x in digs], "phase 2's fused results"),
        (CHUNK_SIZE, "blake3", [s for f in sizes_64k for s in f],
         lambda d: np.array_equal(words(d), b3["digests_u32"]), "phase 9's fused BLAKE3 results"),
        (0x100000, "sha256", windowed["sizes_1m"].tolist(),
         lambda d: d == windowed["digests_1m"], "phase 7's results"),
        (0x100000, "blake3", windowed["sizes_1m"].tolist(),
         lambda d: np.array_equal(words(d), b3["digests_1m_u32"]), "phase 9's 1 MiB BLAKE3 results"),
    ]
    out: dict = {"isa": isa, "cores": cores, "engine": {}}
    for chunk_size, digester, want_sizes, digests_ok, against in cases:
        eng = chunker.ChunkDigestEngine(chunk_size=chunk_size, backend="hybrid", digester=digester)
        if eng.device is not None:
            raise AssertionError("the hybrid engine took a device")
        zero()
        t0 = time.perf_counter()
        got = eng.process_many(files)
        first = time.perf_counter() - t0
        no_launch(f"hybrid process_many ({digester}, {chunk_size >> 10} KiB)")
        if [m.size for metas in got for m in metas] != want_sizes:
            raise AssertionError(f"hybrid cuts ({digester}, {chunk_size >> 10} KiB) differ from {against}")
        if not digests_ok([m.digest for metas in got for m in metas]):
            raise AssertionError(f"hybrid digests ({digester}, {chunk_size >> 10} KiB) differ from "
                                 f"{against}")
        runs = [host_timed(lambda: eng.process_many(files)) for _ in range(HYBRID_REPS)]
        wall = float(np.median([r[0] for r in runs]))
        log(f"[12] ChunkDigestEngine(backend='hybrid', digester='{digester}') at "
            f"{chunk_size >> 10} KiB chunks: {len(want_sizes)} chunks, every cut and digest == "
            f"{against}; no launch; checked run {first:.3f} s, median {wall:.3f} s over {HYBRID_REPS} = "
            f"{n_bytes / 2**30 / wall:.3f} GiB/s (runs, wall / host CPU s / minor page faults: "
            + ", ".join(f"{w:.3f} / {c:.3f} / {f}" for w, c, f in runs) + ")"
            + (f"; the fused device engine, phase 5: {n_bytes / 2**30 / e2e_s:.3f} GiB/s"
               if (chunk_size, digester) == (CHUNK_SIZE, "sha256") else ""))
        out["engine"][f"{digester}_{chunk_size >> 10}k"] = {
            "first_s": first, "wall_s": wall, "gib_per_s": n_bytes / 2**30 / wall,
            "runs": [list(r) for r in runs]}
        del got

    # -- (b) and (c): the hybrid pack lanes over phase 4's tar ----------------
    codec = "lz4_block" if "lz4_block" in comp["codecs"] else next(iter(comp["codecs"]))

    def same(a, b) -> bool:
        return a[0] == b[0] and a[1].bootstrap == b[1].bootstrap and a[1].blob_id == b[1].blob_id

    def lane_case(name: str, threads: "str | None", want_lane: str, **kw):
        opt = PackOption(chunk_size=CHUNK_SIZE, compressor=codec, **kw)
        twin = pack_layer(tar, dataclasses.replace(opt, backend="fused"), device=dev)
        hopt = dataclasses.replace(opt, backend="hybrid")
        with pack_threads(threads) if threads else contextlib.nullcontext():
            zero()
            st = {}
            t0 = time.perf_counter()
            got = pack_layer(tar, hopt, stats=st)
            first = time.perf_counter() - t0
            no_launch(f"the hybrid pack ({name})")
            route = got[1].route
            if not same(got, twin):
                raise AssertionError(f"the hybrid pack ({name}) differs from its fused twin")
            if route["lane"] != want_lane or route["writer"] != "deferred" or not route["native"]:
                raise AssertionError(f"the hybrid pack ({name}) took {route}; want lane {want_lane}, "
                                     "the deferred writer's native pass")
            runs, stats = [], []
            for _ in range(3):
                st_r, blobs = {}, []
                runs.append(host_timed(lambda: blobs.append(pack_layer(tar, hopt, stats=st_r)[0])))
                stats.append(st_r)
                if blobs[0] != got[0]:
                    raise AssertionError(f"the hybrid pack ({name}) differs from its checked run")
        wall = float(np.median([r[0] for r in runs]))
        log(f"[12] hybrid pack, {name}, NTPU_PACK_THREADS={threads or 'unset'}: == its fused twin "
            f"(blob, bootstrap, blob id); no launch; route: "
            + ", ".join(f"{k} {v}" for k, v in route.items())
            + f"; checked run {first:.3f} s [{fmt_stats(st)}], median {wall:.3f} s (runs, wall / "
            "host CPU s / minor page faults [stats s]: " + ", ".join(
                f"{w:.3f} / {c:.3f} / {f} [{fmt_stats(x)}]" for (w, c, f), x in zip(runs, stats)) + ")")
        return {"route": route, "first_s": first, "wall_s": wall, "runs": [list(r) for r in runs],
                "stats": stats}

    out["packs"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "dict.boot"
        path.write_bytes(comp["all_options"]["dict_bootstrap"])
        for name, threads, lane, kw in (
            (f"{codec} SHA-256, no dict", "1", "pack_files", {}),
            (f"{codec} BLAKE3, no dict", "1", "pack_files", {"digester": "blake3"}),
            (f"{codec} BLAKE3, phase 10's dict file", "1", "chunk_digest_multi",
             {"digester": "blake3", "chunk_dict_path": f"bootstrap={path}"}),
            (f"{codec} SHA-256, no dict", None,
             "pipeline" if _pack_threads() > 1 else "pack_files", {}),
        ):
            out["packs"][f"{lane}_{kw.get('digester', 'sha256')}_{threads or 'default'}"] = lane_case(
                name, threads, lane, **kw)
    log(f"[12] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def failpoint_check(dev, tar, blob_f, res_f, opt, kernels) -> dict:
    """Phase 4b: the tar header walks of phase 4's tar, and one fused pack
    of it with ``fused.dispatch`` armed with an error: it must raise before
    any output or launch, the site counted once; disarmed, the pack gives
    phase 4's blob."""
    from nydus_snapshotter_tpu_torch import failpoint
    from nydus_snapshotter_tpu_torch.converter import Pack, PackOption
    from nydus_snapshotter_tpu_torch.converter.pack import _fast_tar_members

    runs: dict[str, list] = {"fast walk": [], "tarfile": []}
    found = {}
    for _ in range(3):  # in turns, so neither side always meets a cold heap
        for name, walk in (("fast walk", lambda: _fast_tar_members(memoryview(tar))),
                           ("tarfile", lambda: tarfile.open(fileobj=io.BytesIO(tar),
                                                            mode="r:").getmembers())):
            t0 = time.perf_counter()
            found[name] = len(walk())
            runs[name].append(time.perf_counter() - t0)
    walks = {name: (float(np.median(r)), found[name]) for name, r in runs.items()}
    if found["fast walk"] != found["tarfile"]:
        raise AssertionError(f"the fast tar walk found {found['fast walk']} members, tarfile "
                             f"{found['tarfile']}")
    for k in kernels.values():
        k.launches = 0
    failpoint.clear()
    failpoint.inject("fused.dispatch", "error(RuntimeError:chip_smoke fault)")
    dest = io.BytesIO()
    try:
        Pack(dest, tar, PackOption(backend="fused", **opt), device=dev)
    except RuntimeError as e:
        if "chip_smoke fault" not in str(e):
            raise
    else:
        raise AssertionError("the fused pack with fused.dispatch armed did not raise")
    finally:
        fired = failpoint.counts().get("fused.dispatch", 0)
        failpoint.clear()
    launched = {key: k.launches for key, k in kernels.items()}
    if fired != 1 or dest.getvalue() or any(launched.values()):
        raise AssertionError(f"fused.dispatch fired {fired} times, the pack wrote "
                             f"{len(dest.getvalue())} bytes and launched {launched}; want once, "
                             "nothing, nothing")
    dest = io.BytesIO()
    res = Pack(dest, tar, PackOption(backend="fused", **opt), device=dev)
    if dest.getvalue() != blob_f or res.bootstrap != res_f.bootstrap:
        raise AssertionError("the fused pack after the failpoint was cleared differs from phase 4's")
    log(f"[4] tar header walks of phase 4's tar ({walks['tarfile'][1]} members), median of 3 in "
        f"turns: the fast walk {walks['fast walk'][0]:.3f} s, tarfile {walks['tarfile'][0]:.3f} s "
        "(runs " + "; ".join(f"{k} " + ", ".join(f"{x:.3f}" for x in r) for k, r in runs.items())
        + "); fused pack with "
        "fused.dispatch armed: raised at the device batch boundary, site fired once, no output, "
        "no launch; disarmed: == phase 4's blob and bootstrap")
    return {"walk_s": {k: v[0] for k, v in walks.items()}, "walk_runs_s": runs,
            "members": found["tarfile"]}


def split_by_weight(files: list[np.ndarray], weights) -> list[list[np.ndarray]]:
    """``files`` in order, cut into ``len(weights)`` runs whose byte totals
    follow ``weights`` (the last run takes the rest)."""
    total = sum(f.size for f in files)
    ends = np.cumsum(np.asarray(weights, dtype=np.float64) / sum(weights) * total)
    groups: list[list[np.ndarray]] = [[] for _ in weights]
    used, li = 0, 0
    for f in files:
        while li < len(weights) - 1 and used >= ends[li]:
            li += 1
        groups[li].append(f)
        used += f.size
    return groups


def named_tar(members: list, extra: tuple = ()) -> bytes:
    """A layer tar of ``(name, array)`` members, then empty entries named
    ``extra``: directories (a trailing "/"), ``.wh.`` whiteouts, opaque
    markers."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        for name, data in members:
            ti = tarfile.TarInfo(name)
            ti.size = data.size
            tf.addfile(ti, io.BytesIO(data.data))
        for name in extra:
            ti = tarfile.TarInfo(name.rstrip("/"))
            if name.endswith("/"):
                ti.type, ti.mode = tarfile.DIRTYPE, 0o755
            tf.addfile(ti)
    return buf.getvalue()


def image_members(files: list[np.ndarray]) -> list[list[tuple[str, np.ndarray]]]:
    """Image A's six layers as ``(name, array)`` members (phase 13)."""
    layers = split_by_weight(files, IMAGE_WEIGHTS)
    return [[(f"layer{li}/d{fi % 97}/f{fi}.bin", f) for fi, f in enumerate(g)]
            for li, g in enumerate(layers)]


def image_b_top(members, gen: FileGen, kind: str) -> tuple[bytes, list[str], str]:
    """Image B's top layer: A's top with every fourth file rewritten as a
    fresh ``kind`` file of ``gen``, ``.wh.`` whiteouts for a tenth of A's
    fifth layer and an opaque marker on a directory of its fourth ->
    (tar, the whited-out paths, the opaque directory)."""
    top = [(name, gen.file(f.size, kind) if fi % 4 == 0 else f)
           for fi, (name, f) in enumerate(members[5])]
    gone = [name for fi, (name, _f) in enumerate(members[4]) if fi % 10 == 0]
    opaque = members[3][0][0].rsplit("/", 1)[0]
    whiteouts = tuple(n.rsplit("/", 1)[0] + "/.wh." + n.rsplit("/", 1)[1] for n in gone)
    # the opaque directory's own entries precede its marker, as in a
    # container engine's layer diff (a marker two levels below any entry of
    # its layer is refused by the reference's Pack, and so by this one's)
    dirs = (opaque.rsplit("/", 1)[0] + "/", opaque + "/")
    return named_tar(top, whiteouts + dirs + (opaque + "/.wh..wh..opq",)), gone, opaque


def image_corpus(files: list[np.ndarray]) -> dict:
    """Phase 13's images A, B and C (see the module docstring) from phase
    2's ``files``: their layer tars and what B whites out."""
    members = image_members(files)
    a = [named_tar(m) for m in members]
    top, gone, opaque = image_b_top(members, FileGen(SEED + 13), "random")
    b = a[:5] + [top]
    upper = [f for m in members[3:] for _n, f in m]
    fresh = FileGen(SEED + 17)
    c_new, k = [], 0
    for li, mib in enumerate(IMAGE_C_NEW_MIB):
        out, used, fi = [], 0, 0
        while used < mib << 20:
            if fi % 2 == 0:  # a copy of one of A's upper-layer files, another path
                data, name = upper[k % len(upper)], f"app{li}/copies/c{fi}.bin"
                k += 1
            else:
                size = int(np.clip(fresh.rng.lognormal(8.5, 2.0), 128, 8 << 20))
                r = fresh.rng.random()
                data = fresh.file(size, "text" if r < 0.4 else ("binary" if r < 0.8 else "random"))
                name = f"app{li}/d{fi % 53}/g{fi}.bin"
            out.append((name, data))
            used += data.size
            fi += 1
        c_new.append(named_tar(out))
    return {"images": [("A", a), ("B", b), ("C", a[:3] + c_new)], "gone": gone,
            "opaque": opaque}


def tree_of(entries) -> tuple[dict, set]:
    """Non-directory entries -> {path: (mode, symlink, hardlink, bytes)},
    and the set of directory paths."""
    files, dirs = {}, set()
    for e in entries:
        if e.is_dir:
            dirs.add(e.path)
        else:
            files[e.path] = (e.mode, e.symlink_target, e.hardlink_target, e.data)
    return files, dirs


def image_phase(dev, files, kernels, t_start: float) -> dict:
    """Phase 13: BatchConverter over images A, B and C on the fused lane,
    against the hybrid and fan-out-1 batches, Unpack against the source
    trees, and the real RAFS v5/v6 bootstraps."""
    import tempfile

    from nydus_snapshotter_tpu_torch.converter import (
        Merge, MergeOption, PackOption, Unpack, batch, pack_layer,
    )
    from nydus_snapshotter_tpu_torch.converter.convert import (
        blob_data_from_layer_blob, bootstrap_from_layer_blob,
    )
    from nydus_snapshotter_tpu_torch import trace
    from nydus_snapshotter_tpu_torch.converter.pack import _pack_threads
    from nydus_snapshotter_tpu_torch.metrics import registry
    from nydus_snapshotter_tpu_torch.models import fstree
    from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap
    from nydus_snapshotter_tpu_torch.models.nydus_real import load_any_bootstrap
    from nydus_snapshotter_tpu_torch.parallel import pipeline

    t_phase = time.perf_counter()
    corpus = image_corpus(files)
    images = corpus["images"]
    n_layers = sum(len(t) for _n, t in images)
    in_bytes = {name: sum(len(t) for t in tars) for name, tars in images}
    total_in = sum(in_bytes.values())
    t_gen = time.perf_counter() - t_phase
    log(f"[13] images: " + "; ".join(
        f"{name} {len(tars)} layers, {in_bytes[name]} bytes of tar ("
        + " / ".join(f"{len(t) / 2**20:.1f}" for t in tars) + " MiB)" for name, tars in images)
        + f"; {n_layers} layers, {total_in / 2**30:.3f} GiB in all; B whites out "
        f"{len(corpus['gone'])} files and makes {corpus['opaque']} opaque; built in {t_gen:.1f} s")

    def counts() -> dict:
        return {key: k.launches for key, k in kernels.items()}

    def zero():
        for k in kernels.values():
            k.launches = 0

    def same(got, want, what: str):
        for g, w in zip(got, want):
            if (g.bootstrap, g.blob_digests, g.layer_blobs, g.new_dict_chunks) != (
                    w.bootstrap, w.blob_digests, w.layer_blobs, w.new_dict_chunks):
                raise AssertionError(f"image {g.name}: the {what} differs from the fused batch")

    cpu_s: dict[str, list] = {"fused": [], "fanout1": [], "hybrid": []}

    def run(backend: str, key: str = "", **kw):
        """One batch -> (results, wall s); its host CPU s go to cpu_s[key]."""
        bc = batch.BatchConverter(PackOption(backend=backend), device=dev, **kw)
        out = []
        wall, cpu, _faults = host_timed(lambda: out.append(bc.convert_many(images)))
        if key:
            cpu_s[key].append(cpu)
        return out[0], wall

    # -- the fused batch: launches, checked run ---------------------------
    merge_ms: list[float] = []
    real_merge = batch.Merge

    def timed_merge(*a, **k):
        t0 = time.perf_counter()
        out = real_merge(*a, **k)
        merge_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    # the fused engine's stage counters (ops/fused_convert._record_dispatch)
    fused_stage = registry.default_registry.register(registry.Counter(
        "ntpu_fused_convert_stage_seconds", "Wall seconds per fused-convert stage", ("stage",)))
    stages = ("pass1_gear", "host_resolve", "pass2_digest")
    trace.configure(enabled=True, ring_capacity=1 << 16, slow_op_threshold_ms=0)
    stage_before = {k: fused_stage.value(k) for k in stages}
    batch.Merge = timed_merge
    try:
        zero()
        fused, fused_first = run("fused")
        launches = counts()
    finally:
        batch.Merge = real_merge
    stage_s = {k: fused_stage.value(k) - stage_before[k] for k in stages}
    convert_s = {sp.attrs["image"]: sp.duration_ms / 1e3 for sp in trace.snapshot_spans()
                 if sp.name == "convert"}
    if sorted(convert_s) != sorted(name for name, _t in images):
        raise AssertionError(f"convert spans for {sorted(convert_s)}; want one per image")
    want = {"gear": n_layers, "sha": n_layers, "probe": 0, "b3_leaves": 0, "b3_parents": 0}
    if launches != want:
        raise AssertionError(f"the fused batch launched {launches}; want {want} (K1 and K2 once "
                             "per layer, K3 and K4 never)")
    fused_walls = []
    for _ in range(IMAGE_REPS):
        again, wall = run("fused", "fused")
        same(again, fused, "fused batch's timed run")
        fused_walls.append(wall)
    del again
    fused_wall = float(np.median(fused_walls))
    zero()
    serial, serial_wall = run("fused", "fanout1", layer_fanout=1, memory_budget_mib=256)
    serial_launches = counts()
    same(serial, fused, "fan-out-1 batch (memory_budget_mib=256)")
    if serial_launches != want:
        raise AssertionError(f"the fan-out-1 batch launched {serial_launches}; want {want}")
    del serial
    zero()
    routes = []
    real_pack = batch.Pack

    def routed_pack(*a, **k):
        res = real_pack(*a, **k)
        routes.append(res.route)
        return res

    pipe_before = pipeline.snapshot_counters()
    batch.Pack = routed_pack
    try:
        hybrid, hybrid_wall = run("hybrid", "hybrid")
    finally:
        batch.Pack = real_pack
    pipe_after = pipeline.snapshot_counters()
    if any(counts().values()):
        raise AssertionError(f"the hybrid batch launched {counts()}")
    same(hybrid, fused, "hybrid batch")
    del hybrid
    lanes = sorted({r["lane"] for r in routes})
    if _pack_threads() > 1 and lanes != ["pipeline"]:
        raise AssertionError(f"the hybrid batch's layers took {lanes}; want the pipeline")
    busy = {k: pipe_after["stage_busy_s"][k] - pipe_before["stage_busy_s"][k]
            for k in ("chunk", "compress")}
    pipe = {"runs": pipe_after["runs"] - pipe_before["runs"], "stage_busy_s": busy,
            "chunk_items": pipe_after["stage_items"]["chunk"] - pipe_before["stage_items"]["chunk"],
            "lanes": lanes, "route": routes[0]}
    log(f"[13] fused BatchConverter.convert_many([A, B, C]): launches {launches} over {n_layers} "
        f"layers (K1 and K2 once per layer, K3 and K4 never); == the hybrid batch (no launch) "
        f"and the fan-out-1 batch (launches {serial_launches}) in every image's bootstrap, "
        f"blob_digests, layer_blobs and new_dict_chunks. Wall: fused median {fused_wall:.3f} s "
        f"= {total_in / 2**30 / fused_wall:.3f} GiB/s (runs, wall / host CPU s: " + ", ".join(
            f"{w:.3f} / {c:.3f}" for w, c in zip(fused_walls, cpu_s["fused"]))
        + f"; checked run {fused_first:.3f} s), fan-out 1 {serial_wall:.3f} s = "
        f"{total_in / 2**30 / serial_wall:.3f} GiB/s (host CPU {cpu_s['fanout1'][0]:.3f} s), "
        f"hybrid {hybrid_wall:.3f} s = {total_in / 2**30 / hybrid_wall:.3f} GiB/s (host CPU "
        f"{cpu_s['hybrid'][0]:.3f} s); fan-out gain {serial_wall / fused_wall:.2f}x")
    log(f"[13] fused batch (checked run): convert span s per image " + ", ".join(
        f"{k} {v:.3f}" for k, v in convert_s.items()) + "; ntpu_fused_convert_stage_seconds over "
        f"its {n_layers} layers: " + ", ".join(f"{k} {v:.3f}" for k, v in stage_s.items())
        + f"; the fan-out-1 batch ran with memory_budget_mib=256")
    log(f"[13] hybrid batch: {len(routes)} layers, lanes {lanes}, route {routes[0]}; pipeline runs "
        f"{pipe['runs']:.0f}, files chunked {pipe['chunk_items']:.0f}, ntpu_convert_pipeline_stage_"
        f"busy_seconds chunk {busy['chunk']:.3f}, compress {busy['compress']:.3f} (the deferred "
        "writer compresses in its native pass)")

    # -- per image: dedup, Unpack against the source trees -------------------
    parsed: dict[int, list] = {}
    blobs: dict[str, bytes] = {}
    per_image = {}
    for (name, tars), res, m_ms in zip(images, fused, merge_ms):
        own = {bid: blob_data_from_layer_blob(b) for bid, b in res.layer_blobs.items()}
        blobs.update(own)
        bs = Bootstrap.from_bytes(res.bootstrap)
        sizes = np.fromiter((c.uncompressed_size for c in bs.chunks), dtype=np.int64)
        earlier = np.fromiter((bs.blobs[c.blob_index].blob_id not in own for c in bs.chunks),
                              dtype=bool)
        ratio = float(sizes[earlier].sum() / max(int(sizes.sum()), 1))
        t0 = time.perf_counter()
        out = Unpack(res.bootstrap, blobs)
        unpack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want_tree: list = []
        for t in tars:
            if id(t) not in parsed:
                parsed[id(t)] = fstree.tree_from_tar(t)
            want_tree = fstree.apply_overlay(want_tree, parsed[id(t)])
        got_files, got_dirs = tree_of(fstree.tree_from_tar(out))
        want_files, want_dirs = tree_of(want_tree)
        if got_files != want_files or not want_dirs <= got_dirs:
            missing = sorted(set(want_files) ^ set(got_files))[:5]
            raise AssertionError(f"image {name}: Unpack differs from the overlay of its layer "
                                 f"trees (paths in one only: {missing})")
        if name == "B" and (any(g in got_files for g in corpus["gone"]) or any(
                p.startswith(corpus["opaque"] + "/") for p in got_files)):
            raise AssertionError("image B: a whiteout or the opaque marker was not applied")
        check_s = time.perf_counter() - t0
        stored = sum(len(v) for v in own.values())
        per_image[name] = {"input_bytes": in_bytes[name], "stored_blob_bytes": stored,
                           "dedup_ratio": ratio, "new_dict_chunks": res.new_dict_chunks,
                           "merge_ms": m_ms, "unpack_s": unpack_s, "check_s": check_s,
                           "files": len(got_files)}
        log(f"[13] image {name}: {in_bytes[name]} bytes in, {stored} bytes of blob stored "
            f"({len(own)} new blobs, {len(res.blob_digests)} referenced), dedup ratio {ratio:.4f} "
            f"(chunk bytes on earlier images' blobs / all), {res.new_dict_chunks} new dict chunks, "
            f"Merge {m_ms:.1f} ms, Unpack {unpack_s:.3f} s: {len(got_files)} files == the overlay "
            f"of its layer trees (modes, sizes, link targets, bytes; whiteouts applied; checked in "
            f"{check_s:.3f} s)")
        del out, want_tree, got_files, want_files
    del parsed

    # -- real formats ----------------------------------------------------------
    def records(bs, uoffs: bool = True) -> list:
        # RAFS v6 puts each chunk's uncompressed offset on its 4 KiB block
        # grid (the reference's nydus_real_write._v6_realign_uoffs)
        return [(c.digest, bs.blobs[c.blob_index].blob_id, c.flags,
                 c.uncompressed_offset if uoffs else None, c.compressed_offset,
                 c.uncompressed_size, c.compressed_size) for c in bs.chunks]

    def hits(layer_blob: bytes, own_id: str) -> set:
        bs = bootstrap_from_layer_blob(layer_blob)
        return {c.digest for c in bs.chunks if bs.blobs[c.blob_index].blob_id != own_id}

    a_res = fused[0]
    a_blobs = [a_res.layer_blobs[bid] for bid in a_res.blob_digests]
    real = {}
    t0 = time.perf_counter()
    v5 = Merge(a_blobs, MergeOption(bootstrap_format="rafs-v5")).bootstrap
    real["v5_emit_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    v5_back = load_any_bootstrap(v5)
    real["v5_load_ms"] = 1e3 * (time.perf_counter() - t0)
    if records(v5_back) != records(Bootstrap.from_bytes(a_res.bootstrap)):
        raise AssertionError("image A's rafs-v5 bootstrap reads back with other chunk records")
    c_tars = images[2][1][3:]
    big = max(c_tars, key=len)
    with tempfile.TemporaryDirectory() as tmp:
        v5_path, native_path = Path(tmp) / "a.v5.boot", Path(tmp) / "a.boot"
        v5_path.write_bytes(v5)
        native_path.write_bytes(a_res.bootstrap)
        zero()
        t0 = time.perf_counter()
        f_blob, f_res = pack_layer(big, PackOption(backend="fused", chunk_dict_path=f"bootstrap={v5_path}"),
                                   device=dev)
        real["v5_dict_pack_s"] = time.perf_counter() - t0
        v5_launches = counts()
        h_blob, h_res = pack_layer(big, PackOption(backend="hybrid", chunk_dict_path=f"bootstrap={v5_path}"))
        n_blob, n_res = pack_layer(big, PackOption(backend="fused", chunk_dict_path=f"bootstrap={native_path}"),
                                   device=dev)
    if (f_blob, f_res.bootstrap, f_res.blob_id) != (h_blob, h_res.bootstrap, h_res.blob_id):
        raise AssertionError("the fused pack against A's rafs-v5 dict differs from its hybrid twin")
    v5_hits = hits(f_blob, f_res.blob_id)
    if not v5_hits or v5_hits != hits(n_blob, n_res.blob_id):
        raise AssertionError("the rafs-v5 dict's hit set differs from the native bootstrap's")
    a_top = images[0][1][5]
    fixed_blob, _fixed_res = pack_layer(a_top, PackOption(backend="fused", chunking="fixed"), device=dev)
    t0 = time.perf_counter()
    v6 = Merge([fixed_blob], MergeOption(bootstrap_format="rafs-v6")).bootstrap
    real["v6_emit_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    v6_back = load_any_bootstrap(v6)
    real["v6_load_ms"] = 1e3 * (time.perf_counter() - t0)
    if records(v6_back, uoffs=False) != records(
            Bootstrap.from_bytes(Merge([fixed_blob], MergeOption()).bootstrap), uoffs=False):
        raise AssertionError("the rafs-v6 emit of A's top layer reads back with other chunk records")
    log(f"[13] real formats: A's image as rafs-v5 ({len(v5)} bytes) emitted in "
        f"{real['v5_emit_ms']:.1f} ms, read back in {real['v5_load_ms']:.1f} ms with the same "
        f"{len(v5_back.chunks)} chunk records; as chunk_dict_path of a fused pack of C's largest new "
        f"layer ({len(big)} bytes, {real['v5_dict_pack_s']:.3f} s, launches {v5_launches}): == "
        f"its hybrid twin, {len(v5_hits)} dict hits == those against A's native bootstrap; A's top "
        f"layer at chunking='fixed' as rafs-v6 ({len(v6)} bytes) emitted in "
        f"{real['v6_emit_ms']:.1f} ms, read back in {real['v6_load_ms']:.1f} ms with the same "
        f"{len(v6_back.chunks)} chunk records (uncompressed offsets on v6's block grid)")
    phase_s = time.perf_counter() - t_phase
    log(f"[13] phase {phase_s:.1f} s; script so far {time.perf_counter() - t_start:.1f} s")
    return {"launches": launches, "fanout1_launches": serial_launches, "layers": n_layers,
            "input_bytes": total_in, "fused_wall_s": fused_wall, "fused_runs_s": fused_walls,
            "fused_first_s": fused_first, "fanout1_wall_s": serial_wall,
            "hybrid_wall_s": hybrid_wall, "host_cpu_s": cpu_s, "images": per_image, "real": real,
            "phase_s": phase_s, "convert_span_s": convert_s, "fused_stage_s": stage_s,
            "hybrid_pipeline": pipe}


@contextlib.contextmanager
def environ(**values: str):
    """Inside: the given environment variables set, restored after."""
    import os

    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def codec_cipher_phase(dev, tar, files, comp, kernels) -> dict:
    """Phase 14: the adaptive zstd codec and blob encryption on the card's
    pack lanes, over phase 4's tar and two layers each of phase 13's
    images A and B."""
    import dataclasses as dc
    import random
    import tempfile

    from nydus_snapshotter_tpu_torch import constants
    from nydus_snapshotter_tpu_torch.converter import Pack, PackOption, Unpack, batch, pack_layer
    from nydus_snapshotter_tpu_torch.converter import codec as codec_mod
    from nydus_snapshotter_tpu_torch.converter import crypto
    from nydus_snapshotter_tpu_torch.converter.convert import (
        blob_data_from_layer_blob, bootstrap_from_layer_blob, make_bytes_reader,
    )
    from nydus_snapshotter_tpu_torch.models import fstree
    from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap
    from nydus_snapshotter_tpu_torch.parallel.dict_service import DictClient, DictService
    from nydus_snapshotter_tpu_torch.utils import zstd

    t_phase = time.perf_counter()
    if zstd.library() is None or not zstd.dict_support():
        raise AssertionError("the adaptive codec needs the system libzstd with its dictionary arms")
    with tarfile.open(fileobj=io.BytesIO(tar)) as tf:
        regs = [m for m in tf if m.isreg()]
    members = {fstree.norm_path(m.name): (m.offset_data, m.size) for m in regs}
    file_bytes = sum(m.size for m in regs)

    def adaptive(**kw):
        return codec_mod.AdaptiveCodec(dc.replace(codec_mod.resolve_codec_config(), adaptive=True, **kw))

    def counts() -> dict:
        return {key: k.launches for key, k in kernels.items()}

    def counted(fn):
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, counts()

    def launches_are(got: dict, what: str, **want):
        full = {key: want.get(key, 0) for key in kernels}
        if got != full:
            raise AssertionError(f"{what} launched {got}; want {full}")

    def frames_of(boot, section: bytes, own: int = 0) -> tuple[int, int, int]:
        """(records, nZD1 frames, raw records) of the blob at ``own``."""
        recs = [c for c in boot.chunks if c.blob_index == own]
        trained = sum(1 for c in recs if codec_mod.is_trained_frame(
            section[c.compressed_offset:c.compressed_offset + 8]))
        raw = sum(1 for c in recs if c.flags & constants.COMPRESSOR_MASK == constants.COMPRESSOR_NONE)
        return len(recs), trained, raw

    def reads_back(res, section: bytes, paths=None) -> int:
        """Every chunk of every regular file (or of ``paths``) read through
        BlobReader equals the tar's bytes -> chunks read."""
        boot = Bootstrap.from_bytes(res.bootstrap)
        reader = make_bytes_reader(boot, 0, section)
        n = 0
        for ino in boot.inodes:
            if not ino.chunk_count or (paths is not None and ino.path not in paths):
                continue
            off, size = members[ino.path]
            pos = 0
            for c in boot.chunks[ino.chunk_index:ino.chunk_index + ino.chunk_count]:
                if reader.chunk_data(c) != tar[off + pos:off + pos + c.uncompressed_size]:
                    raise AssertionError(f"{ino.path}: the chunk at file offset {pos} reads back "
                                         "other bytes")
                pos += c.uncompressed_size
                n += 1
            if pos != size:
                raise AssertionError(f"{ino.path}: chunks cover {pos} of {size} bytes")
        return n

    out: dict = {}
    # -- (a) adaptive zstd packs of phase 4's tar ----------------------------
    opt = dict(chunk_size=CHUNK_SIZE, compressor="zstd")
    with environ(NTPU_COMPRESS_ADAPTIVE="1"):
        (blob, res), first_s, launches = counted(
            lambda: pack_layer(tar, PackOption(backend="fused", **opt), device=dev))
    launches_are(launches, "the fused adaptive pack", gear=1, sha=1)
    if res.route != {"lane": "fused", "writer": "serial"}:
        raise AssertionError(f"the fused adaptive pack took {res.route}")
    section = blob[:res.blob_size]
    n_read = reads_back(res, section)
    n_rec, n_trained, n_raw = frames_of(Bootstrap.from_bytes(res.bootstrap), section)
    ratio = res.blob_size / file_bytes
    fixed_ratio = comp["codecs"]["zstd"]["ratio"]
    runs, stats = [], []
    for _ in range(2):
        c = adaptive()
        st, got = {}, []
        runs.append(host_timed(lambda: got.append(
            pack_layer(tar, PackOption(backend="fused", **opt), device=dev, stats=st, codec=c)[0])))
        stats.append(st)
        if got[0] != blob:
            raise AssertionError("a timed fused adaptive pack differs from the checked one")
    cstats = c.stats()
    wall = float(np.median([r[0] for r in runs]))
    ch = adaptive()
    with pack_threads("8"):
        st_h = {}
        (h_blob, h_res), hybrid_s, h_launches = counted(lambda: pack_layer(
            tar, PackOption(backend="hybrid", **opt), stats=st_h, codec=ch))
    launches_are(h_launches, "the hybrid adaptive pack")
    if (h_blob, h_res.bootstrap) != (blob, res.bootstrap):
        raise AssertionError("the hybrid adaptive pack at 8 threads differs from the fused one")
    (b3_blob, b3_res), b3_s, b3_launches = counted(lambda: pack_layer(
        tar, PackOption(backend="fused", digester="blake3", **opt), device=dev, codec=adaptive()))
    launches_are(b3_launches, "the fused BLAKE3 adaptive pack", gear=1, b3_leaves=1, b3_parents=1)
    if b3_res.blob_id != res.blob_id or b3_blob[:b3_res.blob_size] != section:
        raise AssertionError("the BLAKE3 adaptive pack's data section differs from the SHA-256 one")
    log(f"[14] adaptive zstd pack fused (NTPU_COMPRESS_ADAPTIVE=1) of phase 4's tar: route "
        f"{res.route}, launches {launches}; all {n_read} chunks read back through BlobReader == the "
        f"tar's bytes ({n_rec} records, {n_raw} stored raw); classes {cstats['counts']}, bytes "
        f"{cstats['class_bytes']} (bypass {cstats['class_bytes']['bypass']} bytes); data section "
        f"{res.blob_size} bytes = ratio {ratio:.4f} (fixed-level zstd, phase 10: {fixed_ratio:.4f}); "
        f"checked run {first_s:.3f} s, 2 timed runs (wall / host CPU s / minor faults [stats s]): "
        + ", ".join(f"{w:.3f} / {cpu:.3f} / {f} [{fmt_stats(x)}]" for (w, cpu, f), x in zip(runs, stats))
        + f"; hybrid at {h_res.route.get('lane')} lane, NTPU_PACK_THREADS=8: == fused byte for "
        f"byte, no launch, {hybrid_s:.3f} s [{fmt_stats(st_h)}]; fused BLAKE3: same data section "
        f"and blob id, launches {b3_launches}, {b3_s:.3f} s")
    out["adaptive"] = {"route": res.route, "launches": launches, "first_s": first_s, "wall_s": wall,
                       "runs": [list(r) for r in runs], "stats": stats, "ratio": ratio,
                       "fixed_ratio": fixed_ratio, "classes": cstats["counts"],
                       "class_bytes": cstats["class_bytes"], "records": n_rec, "raw_records": n_raw,
                       "hybrid_s": hybrid_s, "hybrid_stats": st_h, "hybrid_route": h_res.route,
                       "blake3_s": b3_s, "blake3_launches": b3_launches}
    del h_blob, b3_blob

    # -- (b) a trained batch over two layers each of images A and B ---------
    t_b = time.perf_counter()
    img = image_members(files)
    low = [named_tar(m) for m in img[4:6]]  # A's two smallest layers
    # B's update rewrites text (phase 13's B rewrites with random bytes, which
    # the codec stores raw and no dictionary compresses)
    top, gone, _opaque = image_b_top(img, FileGen(SEED + 14), "text")
    images = [("A", low), ("B", [low[0], top])]
    in_bytes = sum(len(t) for _n, ts in images for t in ts)

    def trained_batch(backend: str):
        with environ(NTPU_COMPRESS_ADAPTIVE="1", NTPU_COMPRESS_TRAIN="1"):
            bc = batch.BatchConverter(PackOption(backend=backend, **opt), layer_fanout=1, device=dev)
        if bc.codec is None or bc.codec.trainer is None:
            raise AssertionError("the batch resolved no training codec")
        ra = bc.convert_image("A", images[0][1])
        # between the images: trained already if A filled the sample
        # reservoir, else trained now from what it holds
        td = bc.codec.trained or bc.train_codec_dict()
        if td is None:
            raise AssertionError(f"training after image A failed ({bc.codec.trainer.stats()})")
        rb = bc.convert_image("B", images[1][1])
        return bc, td, [ra, rb]

    (bc, td, fused), batch_s, b_launches = counted(lambda: trained_batch("fused"))
    n_layers = sum(len(ts) for _n, ts in images)
    launches_are(b_launches, "the trained fused batch", gear=n_layers, sha=n_layers)
    with pack_threads("1"):  # the trainer samples chunks in tar order on one thread
        (hbc, htd, hybrid), hbatch_s, hb_launches = counted(lambda: trained_batch("hybrid"))
    launches_are(hb_launches, "the trained hybrid batch")
    if htd.bytes != td.bytes:
        raise AssertionError("the hybrid batch trained another dictionary")
    for g, w in zip(hybrid, fused):
        if (g.bootstrap, g.blob_digests, g.layer_blobs) != (w.bootstrap, w.blob_digests, w.layer_blobs):
            raise AssertionError(f"image {g.name}: the trained hybrid batch differs from the fused one")
    blobs = {}
    for r in fused:
        blobs.update({bid: blob_data_from_layer_blob(b) for bid, b in r.layer_blobs.items()})
    b_frames = [frames_of(bootstrap_from_layer_blob(b), blobs[bid]) for bid, b in fused[1].layer_blobs.items()]
    if not sum(t for _r, t, _w in b_frames):
        raise AssertionError(f"image B carries no nZD1 frame ({b_frames})")
    t0 = time.perf_counter()
    got_b = Unpack(fused[1].bootstrap, blobs)
    unpack_b_s = time.perf_counter() - t0
    want_tree: list = []
    for t in images[1][1]:
        want_tree = fstree.apply_overlay(want_tree, fstree.tree_from_tar(t))
    got_files, got_dirs = tree_of(fstree.tree_from_tar(got_b))
    want_files, want_dirs = tree_of(want_tree)
    if got_files != want_files or not want_dirs <= got_dirs or any(g in got_files for g in gone):
        raise AssertionError("image B's Unpack differs from the overlay of its layer trees")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "zdict")
        if not bc.save_trained_dict(path):
            raise AssertionError("save_trained_dict saved nothing")
        back = codec_mod.TrainedDict.load(path)
        if (back.bytes, back.dict_id, back.epoch) != (td.bytes, td.dict_id, td.epoch):
            raise AssertionError("the saved trained dictionary loads back different")
        svc = DictService(device=dev)
        svc.run(str(Path(tmp) / "dict.sock"))
        try:
            cli = DictClient(svc.sock_path)
            put = cli.put_zdict(td.serialize(), "codec")
            if cli.get_zdict("codec") != td.serialize() or put["zdict_id"] != td.dict_id:
                raise AssertionError(f"the service's zdict round trip differs ({put})")
            cli.close()
            bc2 = batch.BatchConverter(PackOption(backend="fused", **opt), device=dev,
                                       dict_service=svc.sock_path, namespace="codec", codec=adaptive())
            try:
                if bc2.codec.trained is None or bc2.codec.trained.dict_id != td.dict_id:
                    raise AssertionError("the second BatchConverter did not adopt the service's "
                                         "dictionary")
                (r2,), _s, s_launches = counted(lambda: [bc2.convert_image("B-top", [top])])
            finally:
                bc2.dict.close()
        finally:
            svc.stop()
    launches_are(s_launches, "the service-adopting batch", gear=1, sha=1)
    s_frames = [frames_of(bootstrap_from_layer_blob(b), blob_data_from_layer_blob(b))
                for b in r2.layer_blobs.values()]
    if not sum(t for _r, t, _w in s_frames):
        raise AssertionError("the service-adopting batch wrote no nZD1 frame")
    train_s = time.perf_counter() - t_b
    log(f"[14] trained batch (NTPU_COMPRESS_ADAPTIVE=1, NTPU_COMPRESS_TRAIN=1, layer_fanout=1): "
        f"A = phase 13 A's two smallest layers, B = A's fifth layer + B's top layer with its "
        f"rewritten quarter as text ({in_bytes} bytes of tar); dictionary trained after A from "
        f"{bc.codec.trainer.stats()} -> id {td.dict_id}, {len(td.bytes)} bytes; fused batch "
        f"{batch_s:.3f} s, launches {b_launches} ({n_layers} layers); B's new blobs: (records, nZD1 "
        f"frames, raw) {b_frames}; Unpack of B ({unpack_b_s:.3f} s) == the overlay of its layer "
        f"trees ({len(got_files)} files); hybrid twin at NTPU_PACK_THREADS=1: same dictionary "
        f"bytes and images byte for byte, no launch, {hbatch_s:.3f} s; save_trained_dict -> "
        f"TrainedDict.load round-trips; put_zdict/get_zdict on a DictService, adopted by a second "
        f"BatchConverter whose pack of B's top layer writes {s_frames} (launches {s_launches}); "
        f"{train_s:.1f} s")
    out["trained_batch"] = {"input_bytes": in_bytes, "fused_s": batch_s, "hybrid_s": hbatch_s,
                            "launches": b_launches, "dict_id": td.dict_id, "dict_bytes": len(td.bytes),
                            "b_frames": b_frames, "service_frames": s_frames,
                            "unpack_b_s": unpack_b_s, "phase_s": train_s}
    del got_b, blobs, fused, hybrid

    # -- (c) blob encryption ----------------------------------------------------
    try:
        import cryptography

        crypto_version = cryptography.__version__
    except ImportError:
        crypto_version = None
    log(f"[14] cryptography: {crypto_version or 'not importable on this machine'}")
    out["cryptography"] = crypto_version
    enc_opt = dict(opt, encrypt=True)
    if crypto_version is None:
        dest = io.BytesIO()
        try:
            Pack(dest, tar, PackOption(backend="fused", **enc_opt), device=dev)
        except crypto.CryptoError as e:
            if dest.getvalue():
                raise AssertionError("Pack(encrypt=True) wrote bytes before its CryptoError")
            log(f"[14] encryption: not run on the card (no cryptography package); "
                f"Pack(encrypt=True) raises CryptoError ({e}) and writes nothing")
        else:
            raise AssertionError("Pack(encrypt=True) without cryptography did not raise")
    else:
        (e_blob, e_res), enc_s, e_launches = counted(
            lambda: pack_layer(tar, PackOption(backend="fused", **enc_opt), device=dev))
        launches_are(e_launches, "the fused encrypted pack", gear=1, sha=1)
        boot = Bootstrap.from_bytes(e_res.bootstrap)
        cipher = boot.cipher_for(0)
        if cipher is None or cipher.algo != crypto.CIPHER_AES_256_CTR or e_res.route["writer"] != "serial":
            raise AssertionError(f"the encrypted pack: cipher {cipher}, route {e_res.route}")
        e_section = e_blob[:e_res.blob_size]
        plain_blob, plain_res = comp["zstd_ref"]
        t0 = time.perf_counter()
        dec = crypto.decrypt_range(e_section, 0, cipher.key, cipher.iv)
        dec_s = time.perf_counter() - t0
        if dec != plain_blob[:plain_res.blob_size]:
            raise AssertionError("the encrypted section, decrypted, differs from the plain zstd pack's")
        paths = set(random.Random(SEED + 14).sample(sorted(members), min(300, len(members))))
        n_enc = reads_back(e_res, e_section, paths)
        t0 = time.perf_counter()
        got = Unpack(e_res.bootstrap, {e_res.blob_id: e_section})
        unpack_s = time.perf_counter() - t0
        got_files, got_dirs = tree_of(fstree.tree_from_tar(got))
        want_files, want_dirs = tree_of(fstree.tree_from_tar(tar))
        if got_files != want_files or not want_dirs <= got_dirs:
            raise AssertionError("the encrypted pack's Unpack differs from the tar's tree")
        log(f"[14] encrypted fused zstd pack: {enc_s:.3f} s, launches {e_launches}, route "
            f"{e_res.route}; its data section ({e_res.blob_size} bytes) decrypted with the "
            f"bootstrap's AES-256-CTR context ({dec_s:.3f} s) == phase 10's zstd pack's; "
            f"{n_enc} chunks of {len(paths)} random files read through BlobReader == the tar's "
            f"bytes; Unpack ({unpack_s:.3f} s) == the tar's tree ({len(got_files)} files)")
        out["encrypted"] = {"s": enc_s, "launches": e_launches, "decrypt_s": dec_s,
                            "unpack_s": unpack_s, "reads": n_enc}
        del e_blob, e_section, dec, got
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[14] phase {out['phase_s']:.1f} s")
    return out


MESH_SHARDS = 8  # phase 15's logical mesh: this many shards on the one card


def mesh_phase(dev, files, res, digests, q_all, answers, kernels) -> dict:
    """Phase 15: the device mesh. Phase 2's dict digests and layer over
    ``MESH_SHARDS`` logical shards on the card, then over ``make_mesh()``
    (every visible card). ``answers`` are phase 5's K3 answers (index + 1)
    to ``q_all``, phase 2's chunk digests, from phase 2's dict before
    phase 11 grew it."""
    import tempfile

    import torch

    from nydus_snapshotter_tpu_torch import entry
    from nydus_snapshotter_tpu_torch.parallel import mesh as mesh_lib
    from nydus_snapshotter_tpu_torch.parallel import sharded_dict

    t_phase = time.perf_counter()
    n = MESH_SHARDS
    logical = mesh_lib.make_mesh(n, devices=[dev] * n)
    want = answers.astype(np.int64) - 1
    out: dict = {"shards": n, "launches": {}}

    def counted(key: str, fn):
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["launches"][key] = {name: k.launches for name, k in kernels.items()}
        return got, wall

    # -- the dict over the logical mesh: build, save, reload onto one shard --
    t0 = time.perf_counter()
    md = sharded_dict.ShardedChunkDict(digests, logical)
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "mesh.dict")
        t0 = time.perf_counter()
        md.save(path)
        save_s = time.perf_counter() - t0
        file_mib = Path(path).stat().st_size / 2**20
        t0 = time.perf_counter()
        one = sharded_dict.ShardedChunkDict.load(path, device=dev)
        load_s = time.perf_counter() - t0
    # the one-shard twin: phase 2's dict as it was before phase 11 grew it
    if not np.array_equal(one.lookup_u32(q_all), want):
        raise AssertionError("the 8-shard file reloaded onto one shard answers unlike phase 2's dict")
    keys1, values1, depth1, _e = one.fused_probe_tables()
    log(f"[15] dict: phase 2's {len(digests)} digests on {n} logical shards of {dev}: capacity "
        f"{md.capacity} a shard ({md.capacity * n * 36 / 2**30:.3f} GiB of tables), max chain "
        f"{md.max_depth}, built in {build_s:.1f} s; saved ({file_mib:.0f} MiB) in {save_s:.2f} s; "
        f"loaded onto one shard (rebuilt) in {load_s:.1f} s, answers == phase 5's")

    # -- the routed probe: phase 5's queries, K3 once a shard -------------
    _shards, _cap, _depth = md.device_shards()  # stage the 8 padded copies
    got, routed_first = counted("routed_lookup", lambda: md.lookup_u32(q_all))
    if not np.array_equal(got, want):
        raise AssertionError("the routed lookup_u32 answers differ from phase 5's")
    if out["launches"]["routed_lookup"]["probe"] != n:
        raise AssertionError(f"routed lookup_u32 launched K3 {out['launches']['routed_lookup']} times")
    routed, single = [], []
    for _ in range(3):
        routed.append(host_timed(lambda: md.lookup_u32(q_all))[0])
        single.append(host_timed(lambda: one.lookup_u32(q_all))[0])
    void = np.ascontiguousarray(q_all).view(np.dtype((np.void, 32)))[:, 0]
    dedup = []  # the host dedup inside the routed lookup_u32, alone
    for _ in range(3):
        dedup.append(host_timed(lambda: np.unique(void, return_index=True, return_inverse=True))[0])
    uniq = np.unique(void)
    uq = entry._pad_rows(uniq.view(np.uint32).reshape(-1, 8), n)
    shards, cap, depth = md.device_shards()
    tk, tv = [k for k, _ in shards], [v for _, v in shards]
    qs = mesh_lib.shard_rows(uq.view(np.int32), logical)
    dense, _w = counted("dense", lambda: sharded_dict._probe_sharded(tk, tv, qs, n, logical, depth, cap))
    if out["launches"]["dense"]["probe"] != n:
        raise AssertionError("the dense probe must launch K3 once a shard")
    routed_a, over = sharded_dict._probe_routed(tk, tv, qs, n, logical, depth, cap)
    if over.any() or not torch.equal(dense, routed_a):
        raise AssertionError("the dense probe differs from the routed probe")
    want_u = one.lookup_u32(uq)
    if not np.array_equal(dense.cpu().numpy().astype(np.int64) - 1, want_u):
        raise AssertionError("the dense probe's answers differ from phase 2's dict")

    # -- dryrun_multichip's skew: every query owned by shard 0 -------------
    hits = digests[digests[:, 0] % np.uint32(n) == 0][:192]
    misses = np.random.default_rng(SEED + 15).integers(0, 2**32, (384 - len(hits), 8), dtype=np.uint32)
    misses[:, 0] -= misses[:, 0] % np.uint32(n)
    skewed = np.concatenate([hits, misses])
    _a, over = sharded_dict._probe_routed(
        tk, tv, mesh_lib.shard_rows(skewed.view(np.int32), logical), n, logical, depth, cap)
    if not over.any():
        raise AssertionError("skewed queries did not overflow the routed buckets")
    got, _w = counted("skewed_lookup", lambda: md.lookup_u32(skewed))
    host, _rows = host_probe(keys1, values1, skewed, depth1)
    if not np.array_equal(got, host.astype(np.int64) - 1):
        raise AssertionError("the dense fallback's answers differ from the host probe")
    if out["launches"]["skewed_lookup"]["probe"] != 2 * n:
        raise AssertionError("the skewed lookup must route (K3 x shards) then rerun dense (x shards)")
    log(f"[15] lookup_u32 of phase 5's {len(q_all)} queries ({len(uniq)} unique) routed over {n} "
        f"shards: == phase 5's answers, K3 launched {n} times; wall median "
        f"{np.median(routed) * 1e3:.3f} ms (runs " + ", ".join(f"{x * 1e3:.3f}" for x in routed)
        + f"; the first, after staging, {routed_first * 1e3:.3f} ms) against the one-shard dict's "
        f"{np.median(single) * 1e3:.3f} ms (" + ", ".join(f"{x * 1e3:.3f}" for x in single)
        + f"; the reloaded one-shard twin): {np.median(routed) / np.median(single):.2f}x, of which "
        f"the host dedup (np.unique of the 32-byte rows) {np.median(dedup) * 1e3:.3f} ms; dense probe ({n} K3 launches) == "
        f"routed; {len(skewed)} skewed queries overflowed shard 0's buckets, the dense fallback "
        f"== the host probe ({out['launches']['skewed_lookup']['probe']} K3 launches)")
    del md, one, shards, tk, tv, qs, dense, routed_a
    torch.cuda.empty_cache()

    # -- the dry run on the card ---------------------------------------------
    t0 = time.perf_counter()
    _none, _w = counted("dryrun", lambda: entry.dryrun_multichip(n, devices=[dev] * n))
    log(f"[15] dryrun_multichip({n}) on {n} logical shards: passed in {time.perf_counter() - t0:.1f} s; "
        f"launches {out['launches']['dryrun']}")

    # -- the convert step over phase 2's layer -------------------------------
    blobs = [f.tobytes() for f in files]
    want_cuts = res.cuts
    want_digs = res.digests

    def check(label, got):
        cuts, digs, _boot = got
        if not all(np.array_equal(a, b) for a, b in zip(cuts, want_cuts)) or digs != want_digs:
            raise AssertionError(f"sharded_convert_step ({label}) differs from phase 2's process_many")

    def step(mesh, pack, rep=None, st=None):
        return entry.sharded_convert_step(blobs, CHUNK_SIZE, mesh.size, mesh, pack=pack,
                                          report=rep, stats=st)

    rep_e, st_e = {}, {}
    got, wall_e = counted("convert_extent", lambda: step(logical, "extent", rep_e, st_e))
    check("extent", got)
    boot_e = got[2]
    if rep_e["max_device_bytes"] > rep_e["bound_bytes"]:
        raise AssertionError("an extent-packed shard holds more than its shard + halo")
    la = out["launches"]["convert_extent"]
    if la["gear"] != n or la["sha"] != rep_e["buckets"] * n:
        raise AssertionError(f"convert step launches {la}: want K1 x {n}, K2 x classes x {n}")
    st_t = {}
    wall_t = host_timed(lambda: step(logical, "extent", st=st_t))[0]
    busy_ms, by_name = device_busy(lambda: step(logical, "extent"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    rep_r = {}
    got, wall_r = counted("convert_replicated", lambda: step(logical, "replicated", rep_r))
    check("replicated", got)
    if got[2] != boot_e:
        raise AssertionError("the replicated arm's bootstrap differs from the extent arm's")
    del got
    torch.cuda.empty_cache()
    log(f"[15] sharded_convert_step over phase 2's layer ({rep_e['corpus_bytes']} bytes, "
        f"{sum(len(c) for c in want_cuts)} chunks) on {n} logical shards: cuts and digests == "
        f"phase 2's, extent and replicated bootstraps equal; extent: {rep_e['buckets']} classes, "
        f"launches K1 {la['gear']}, K2 {la['sha']}; max shard bytes {rep_e['max_device_bytes']} <= "
        f"bound {rep_e['bound_bytes']} (shard {rep_e['shard_bytes']} + halo {rep_e['halo_bytes']}); "
        f"replicated: max shard bytes {rep_r['max_device_bytes']}; walls: extent checked "
        f"{wall_e:.2f} s, timed {wall_t:.2f} s (" + ", ".join(f"{k} {v:.3f}" for k, v in st_t.items())
        + f"), replicated {wall_r:.2f} s; the card busy {busy_ms:.1f} ms of an extent step "
        f"(torch.profiler: kernels and copies; top: "
        + "; ".join(f"{k[:40]} {v:.1f} ms" for k, v in top) + ")")
    out.update(build_s=build_s, save_s=save_s, load_s=load_s, file_mib=file_mib,
               routed_ms=[x * 1e3 for x in routed], dedup_ms=[x * 1e3 for x in dedup],
               convert_busy_ms=busy_ms, convert_busy_top_ms=dict(top),
               single_ms=[x * 1e3 for x in single], routed_first_ms=routed_first * 1e3,
               convert_s={"extent_checked": wall_e, "extent_timed": wall_t, "replicated": wall_r},
               convert_stages_s=st_t, convert_report=rep_e)

    # -- the real mesh: every visible card -----------------------------------
    real = mesh_lib.make_mesh()
    rd = sharded_dict.ShardedChunkDict(digests, real)
    got, _w = counted("real_lookup", lambda: rd.lookup_u32(q_all))
    if not np.array_equal(got, want):
        raise AssertionError("lookup_u32 on make_mesh() differs from phase 5's answers")
    real_lookup = [host_timed(lambda: rd.lookup_u32(q_all))[0] for _ in range(3)]
    del rd
    rep_x, st_x = {}, {}
    got, wall_x = counted("real_convert", lambda: step(real, "extent", rep_x, st_x))
    check("make_mesh(), extent", got)
    if step(real, "replicated")[2] != got[2] or got[2] != boot_e:
        raise AssertionError("the bootstraps on make_mesh() differ")
    del got
    torch.cuda.empty_cache()
    out.update(real_devices=real.size, real_lookup_ms=[x * 1e3 for x in real_lookup],
               real_convert_s=wall_x, real_convert_stages_s=st_x)
    log(f"[15] make_mesh(): {real.size} device(s) {[str(d) for d in real.devices]}: lookup_u32 == "
        f"phase 5's ({out['launches']['real_lookup']['probe']} K3 launch(es)), wall median "
        f"{np.median(real_lookup) * 1e3:.3f} ms (" + ", ".join(f"{x * 1e3:.3f}" for x in real_lookup)
        + f"); the convert step == phase 2's on both arms (launches K1 "
        f"{out['launches']['real_convert']['gear']}, K2 {out['launches']['real_convert']['sha']}), "
        f"extent checked run {wall_x:.2f} s (" + ", ".join(f"{k} {v:.3f}" for k, v in st_x.items())
        + ")" + ("; cross-card copies: none on one card" if real.size == 1 else
                 f"; shard-to-shard copies cross {real.size} cards"))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[15] phase {out['phase_s']:.1f} s")
    return out


def main() -> int:
    import torch

    args = sys.argv[1:]
    if args not in ([], ["--mesh-only"]):
        print(f"usage: {sys.argv[0]} [--mesh-only]", file=sys.stderr)
        return 2
    mesh_only = args == ["--mesh-only"]
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from nydus_snapshotter_tpu_torch.converter import PackOption, pack_layer
        from nydus_snapshotter_tpu_torch.ops import (
            blake3_cuda, cdc, cuda_build, fused_convert, gear_cuda, probe_cuda, sha256, sha256_cuda,
        )
        from nydus_snapshotter_tpu_torch.parallel import sharded_dict
        from nydus_snapshotter_tpu_torch.tensors import from_u32, to_u32
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device(DEVICE, 0)
    kernels = {"gear": gear_cuda.KERNEL, "sha": sha256_cuda.KERNEL, "probe": probe_cuda.KERNEL}
    # K4's two launches; phases 2-8 drive the SHA-256 paths with the three above
    all_kernels = {**kernels, "b3_leaves": blake3_cuda.LEAVES, "b3_parents": blake3_cuda.PARENTS}

    # -- 0. device ---------------------------------------------------------
    smi = nvidia_smi("name,power.limit")
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int_ops_per_s = props.multi_processor_count * INT32_LANES_PER_SM * max_sm_mhz * 1e6
    log(f"[0] device: {name}; {props.multi_processor_count} SMs, max SM clock "
        f"{max_sm_mhz:.0f} MHz -> INT32 peak {int_ops_per_s / 1e12:.2f} Tops/s; "
        f"HBM peak {HBM_BYTES_PER_S / 1e12:.2f} TB/s (data sheet); torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    probe = cuda_build.Kernel("round_latency.cu", "ntpu_round_latency",
                              [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
    cuda_build.build_all(list(all_kernels.values()) + [probe])
    log(f"[1] build: 4 kernels (K4 has two entry points) and the round-latency probe in "
        f"{time.perf_counter() - t0:.2f} s (nvcc in parallel, one per source)")
    for key, k in list(kernels.items()) + [("b3", blake3_cuda.LEAVES)]:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas {k.source}: {line.strip()}")
    rc = round_cycles(probe)
    ops = sass_opcodes(cuda_build.library_path(probe.source))
    # The probe must compile to the chain it claims to time: one SHF, LOP3
    # and IADD3 per unrolled round (a 2-operand add compiles to IMAD), and
    # at least a cycle per dependent instruction (else it was folded).
    if min(ops.get(op, 0) for op in ("SHF", "LOP3", "IADD3")) < 64 or rc < K2_ROUND_DEPTH:
        raise AssertionError(f"round probe: {rc} cycles per round, SASS {ops}")
    log(f"[1] SHA-256 round critical path on this card: {rc:.3f} cycles per round "
        f"(SHF -> LOP3 -> IADD3, dependent; {rc / K2_ROUND_DEPTH:.3f} per instruction) over "
        f"{ROUND_PROBE_STEPS} rounds in one thread, clock64; the probe's SASS: "
        + ", ".join(f"{op} {n}" for op, n in sorted(ops.items()) if op in
                    ("SHF", "LOP3", "IADD3", "IMAD", "IADD", "LOP", "SHL", "SHR", "PRMT")))

    # -- 2. main path ------------------------------------------------------
    t0 = time.perf_counter()
    files = FileGen(SEED).pool(LAYER_MIB)
    n_bytes = sum(f.size for f in files)
    log(f"[2] layer: {len(files)} files, {n_bytes} bytes "
        f"({n_bytes / 2**30:.3f} GiB), generated in {time.perf_counter() - t0:.1f} s")
    eng = fused_convert.FusedDeviceEngine(chunk_size=CHUNK_SIZE, device=dev)
    first = eng.process_many(files)  # warm-up; its digests seed the dict
    dict_src = np.concatenate(
        [np.frombuffer(b"".join(d), dtype=">u4").astype(np.uint32).reshape(-1, 8)
         for i, d in enumerate(first.digests) if i % 3 == 0 and d]
    )
    # A dict holds each digest once. (The numpy build gives every copy of a
    # digest that loses a slot race its own later slot, so thousands of
    # copies of one chunk — text files share chunks — would exhaust its
    # 64-round bound.)
    _, first_idx = np.unique(
        np.ascontiguousarray(dict_src).view(np.dtype((np.void, 32)))[:, 0], return_index=True
    )
    dict_src = dict_src[np.sort(first_idx)]
    rng = np.random.default_rng(SEED + 1)
    digests = np.concatenate(
        [rng.integers(0, 2**32, (DICT_ENTRIES - len(dict_src), 8), dtype=np.uint32), dict_src]
    )
    t0 = time.perf_counter()
    cdict = sharded_dict.ShardedChunkDict(digests, device=dev)
    keys, values, depth, _epoch = cdict.fused_probe_tables()
    log(f"[2] dict: {len(digests)} entries ({len(dict_src)} unique digests from a third of "
        f"the layer's files), {keys.shape[0]} slots ({keys.nbytes >> 20} MiB of keys), max "
        f"chain {depth}, built in {time.perf_counter() - t0:.1f} s (the build doubles the "
        f"slots past 2x the entries when a chain would outgrow {sharded_dict.MAX_PROBE} rows)")

    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = eng.process_many(files, chunk_dict=cdict)
    main_s = time.perf_counter() - t0
    launches = {key: k.launches for key, k in kernels.items()}
    n_chunks = sum(len(c) for c in res.cuts)
    log(f"[2] main path: {n_chunks} chunks in {main_s:.2f} s (first call with this "
        f"dict, includes its table upload); launches {launches}")
    for key, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {key} was not launched on the main path")
    if launches["sha"] != 1:
        raise AssertionError(f"K2 launched {launches['sha']} times; pass 2 makes one launch")

    t0 = time.perf_counter()
    for f, cuts, digs in zip(files, res.cuts, res.digests):
        prev = 0
        for cut, d in zip(cuts, digs):
            if hashlib.sha256(f[prev:int(cut)]).digest() != d:
                raise AssertionError("chunk digest differs from hashlib")
            prev = int(cut)
    checked = 0
    params = cdc.CDCParams(CHUNK_SIZE)
    for f, cuts in zip(files, res.cuts):
        if checked >= CUT_CHECK_BYTES:
            break
        if not np.array_equal(cdc.chunk_data_np(f, params), cuts):
            raise AssertionError("device cuts differ from the numpy chunker")
        checked += f.size
    q_host = np.concatenate(
        [np.frombuffer(b"".join(d), dtype=">u4").astype(np.uint32).reshape(-1, 8)
         for d in res.digests if d]
    )
    want_probe, _ = host_probe(keys, values, q_host, depth)
    if not np.array_equal(res.probe, want_probe):
        raise AssertionError("probe answers differ from the host probe")
    n_hits = int((res.probe > 0).sum())
    if n_hits < len(dict_src):
        raise AssertionError(f"{n_hits} hits < {len(dict_src)} planted digests")
    log(f"[2] checks: {n_chunks} digests == hashlib; cuts == numpy chunker over "
        f"{checked} bytes; {len(q_host)} probe answers == host probe ({n_hits} hits) "
        f"in {time.perf_counter() - t0:.1f} s")

    # -- 3. each kernel against its plain version: main-path inputs, edges -
    t0 = time.perf_counter()
    buf, table = eng.layout(files)
    buffer_dev = torch.from_numpy(buf).to(dev)
    cand_s, cand_l = eng.candidates(buffer_dev, n_bytes)
    cuts = eng.resolve(cand_s, cand_l, table)
    buckets, _order = eng.plan_buckets(table, cuts)  # the reference's plan: one small-chunk set
    p = eng.params
    W, TAIL = fused_convert.WINDOW, fused_convert.TAIL
    main = buffer_dev.view(-1, W)
    rows_full = torch.cat(
        [torch.cat([torch.zeros((1, TAIL), dtype=torch.uint8, device=dev), main[:-1, W - TAIL:]]), main],
        dim=1,
    )
    rows_k1 = rows_full[: K1_SLICE // W].contiguous()
    k1_args = (rows_k1, p.mask_small, p.mask_large, W)
    k1 = gear_cuda.gear_bitmaps(*k1_args)
    k1_plain = gear_cuda.gear_bitmaps_plain(*k1_args)
    k1_err = max(max_abs_err(a, b) for a, b in zip(k1, k1_plain))
    # Edge: a k whose last run is partial (k odd at two words per run),
    # several tiles per row, from a base one byte past an allocation.
    rng = np.random.default_rng(SEED + 4)
    k1_edge_n = 32 * (2 * 4321 + 1)
    assert k1_edge_n % gear_cuda.RUN
    flat = torch.from_numpy(rng.integers(0, 256, 3 * (k1_edge_n + TAIL) + 1, dtype=np.uint8)).to(dev)
    for n_edge, x_edge in (
        (k1_edge_n, flat[1:].view(3, k1_edge_n + TAIL)),
        (32, flat[: 3 * (32 + TAIL)].view(3, 32 + TAIL)),
    ):
        got = gear_cuda.gear_bitmaps(x_edge, p.mask_small, 0x3, n_edge)
        want = gear_cuda.gear_bitmaps_plain(x_edge, p.mask_small, 0x3, n_edge)
        k1_err = max([k1_err] + [max_abs_err(a, b) for a, b in zip(got, want)])

    dev_buckets = [
        (b, torch.from_numpy(b.offsets).to(dev), torch.from_numpy(b.sizes).to(dev)) for b in buckets
    ]
    small = [x for x in dev_buckets if x[0].cap_blocks <= K2_PLAIN_MAX_CAP] or dev_buckets
    kb, koffs, ksizes = max(small, key=lambda x: x[0].count)
    k2_args = (buffer_dev, koffs, ksizes)  # the plain version's: extents on the card
    k2_call_args = (buffer_dev, torch.from_numpy(kb.offsets), torch.from_numpy(kb.sizes))
    # Edge chunks mixed into that bucket: the padding boundaries, a long
    # full-block run and the longest chunk, at every offset mod 4 (and
    # mixed word offsets mod 16).
    edge_sizes = np.asarray([0, 1, 55, 56, 63, 64, 119, 120, 4095, p.max_size], np.int64)
    e_sizes, e_offs = [], []
    for i, size in enumerate(edge_sizes):
        for a in range(4):
            base = int(rng.integers(0, (n_bytes - int(edge_sizes.max()) - 16) // 16)) * 16
            e_offs.append(base + 4 * ((i + a) % 4) + a)
            e_sizes.append(int(size))
    e_offs, e_sizes = np.asarray(e_offs, np.int32), np.asarray(e_sizes, np.int32)
    mix_offs = torch.from_numpy(np.concatenate([kb.offsets, e_offs]))
    mix_sizes = torch.from_numpy(np.concatenate([kb.sizes, e_sizes]))
    k2_mix = sha256_cuda.sha256_chunks(buffer_dev, mix_offs, mix_sizes)  # one launch
    nk = len(kb.offsets)
    short = e_sizes < 4096
    # The edge rows' plain version runs on the host copy of the same buffer:
    # it steps in Python per 64-byte block, and a 4097-block chunk costs
    # ~4k steps of ~2k tiny ops, several times faster on the CPU than as
    # kernel launches on the card.
    k2_err = max(
        max_abs_err(k2_mix[:nk], sha256_cuda.sha256_chunks_plain(*k2_args)),
        max_abs_err(
            k2_mix[nk:].cpu(),
            sha256_cuda.sha256_chunks_plain(
                torch.from_numpy(buf), torch.from_numpy(e_offs), torch.from_numpy(e_sizes)
            ),
        ),
    )
    k2_host = to_u32(k2_mix)
    for r in np.random.default_rng(SEED + 2).choice(kb.count, min(256, kb.count), replace=False):
        o, s = int(kb.offsets[r]), int(kb.sizes[r])
        if sha256.digest_to_bytes(k2_host[r]) != hashlib.sha256(buf[o:o + s]).digest():
            raise AssertionError("K2 digest differs from hashlib")
    for r, (o, s) in enumerate(zip(e_offs.tolist(), e_sizes.tolist())):
        if sha256.digest_to_bytes(k2_host[nk + r]) != hashlib.sha256(buf[o:o + s]).digest():
            raise AssertionError(f"K2 digest of a {s}-byte chunk at offset {o} differs from hashlib")

    extents = eng.chunk_extents(table, cuts)
    all_offs_h, all_sizes_h = torch.from_numpy(extents)
    all_offs, all_sizes_dev = torch.from_numpy(extents).to(dev)
    allq = sha256_cuda.sha256_chunks(buffer_dev, all_offs_h, all_sizes_h)  # pass 2's launch
    tk, tv, _cap, _depth = cdict.device_snapshot()  # the tables the main path probed
    wstart, off = probe_cuda.window_starts(allq, keys.shape[0])
    k3_args = (tk, tv, allq, wstart, off, depth)
    k3 = probe_cuda.probe_padded(*k3_args)
    k3_plain = probe_cuda.probe_padded_plain(*k3_args)
    k3_err = max_abs_err(k3, k3_plain)
    # Edge tables, each cut to C - 1 + depth rows so that the chain from
    # slot C - 1 ends on the table's last row.
    n_edge_q = 0
    for edge_depth in K3_EDGE_DEPTHS:
        ek, ev, eq, ewant = k3_edge_case(edge_depth, rng)
        cap = ek.shape[0]
        ekp, evp = probe_cuda.pad_tables(ek, ev, edge_depth)
        ekp = from_u32(ekp[: cap - 1 + edge_depth], dev)
        evp = torch.from_numpy(evp.reshape(-1)[: cap - 1 + edge_depth].copy()).to(dev)
        eqd = from_u32(eq, dev)
        ews, eoff = probe_cuda.window_starts(eqd, cap)
        got = probe_cuda.probe_padded(ekp, evp, eqd, ews, eoff, edge_depth)
        k3_err = max(k3_err, max_abs_err(got, probe_cuda.probe_padded_plain(
            ekp, evp, eqd, ews, eoff, edge_depth)))
        if not np.array_equal(got.cpu().numpy(), ewant):
            raise AssertionError(f"K3 edge table at depth {edge_depth}: planted answers differ")
        n_edge_q += len(eq)
    torch.cuda.synchronize()
    for label, err in (("K1", k1_err), ("K2", k2_err), ("K3", k3_err)):
        if err != 0:
            raise AssertionError(f"{label} kernel differs from its plain version (max err {err})")
    log(f"[3] kernels == plain versions: K1 over {rows_k1.shape[0]} x {W} positions and 3 x "
        f"{k1_edge_n} / 3 x 32 edge rows (unaligned base); K2 in one launch over bucket cap "
        f"{kb.cap_blocks} blocks ({kb.count} chunks + {nk - kb.count} pad rows) + "
        f"{len(e_sizes)} edge chunks ({int(short.sum())} up to 4095 bytes, "
        f"{int((~short).sum())} of {p.max_size}; their plain version on the host); 256 sampled "
        f"rows and every edge row == hashlib; K3 over {allq.shape[0]} queries, depth {depth}, "
        f"and {n_edge_q} queries on edge tables at depths {K3_EDGE_DEPTHS} (planted answers "
        f"as expected); {time.perf_counter() - t0:.1f} s")

    if mesh_only:  # phases 0-3, then 15 (every visible card: e.g. a 4-card machine)
        mesh = mesh_phase(dev, files, res, digests, to_u32(allq), to_u32(k3), kernels)
        log(f"[done] {time.perf_counter() - t_start:.1f} s (--mesh-only: phases 0-3 and 15)")
        print(smi, flush=True)
        print(json.dumps({"mesh": mesh}, default=float), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                  "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # -- 4. pack -----------------------------------------------------------
    t0 = time.perf_counter()
    tar = layer_tar(FileGen(SEED + 3).pool(PACK_MIB))
    t_gen = time.perf_counter() - t0
    opt = dict(chunk_size=CHUNK_SIZE, compressor="none")
    t0 = time.perf_counter()
    blob_f, res_f = pack_layer(tar, PackOption(backend="fused", **opt), device=dev)
    t_fused = time.perf_counter() - t0
    t0 = time.perf_counter()
    blob_n, res_n = pack_layer(tar, PackOption(backend="numpy", **opt))
    t_numpy = time.perf_counter() - t0
    if not (blob_f == blob_n and res_f.bootstrap == res_n.bootstrap and res_f.blob_id == res_n.blob_id):
        raise AssertionError("fused and numpy pack_layer outputs differ")
    # Wall times: the median of 3 runs after the checked one, with the
    # fused runs' stage split (phase 10 sets its compressed packs beside it).
    pack_runs, fused_stats = {}, []
    for backend, want in (("fused", blob_f), ("numpy", blob_n)):
        pack_runs[backend] = []
        for _ in range(3):
            got, st = [], {}
            pack_runs[backend].append(host_timed(lambda: got.append(
                pack_layer(tar, PackOption(backend=backend, **opt), device=dev, stats=st)[0])))
            if got[0] != want:
                raise AssertionError(f"pack_layer({backend}) differs from its checked run")
            if backend == "fused":
                fused_stats.append(st)
    log(f"[4] pack: {len(tar)} byte tar (built in {t_gen:.1f} s) -> {len(blob_f)} byte layer "
        f"blob, blob id {res_f.blob_id[:16]}..; fused == numpy byte for byte; checked runs fused "
        f"{t_fused:.3f} s, numpy {t_numpy:.3f} s; median of 3 after them (runs, wall / host CPU "
        "s / minor page faults): " + "; ".join(
            f"{b} {np.median([r[0] for r in rs]):.3f} s ("
            + ", ".join(f"{w:.3f} / {c:.3f} / {f}" for w, c, f in rs) + ")"
            for b, rs in pack_runs.items())
        + "; fused runs' stats s: " + ", ".join(
            " + ".join(f"{k} {st[k]:.3f}" for k in ("scan", "chunk_digest", "dedup", "assemble",
                                                      "bootstrap")) for st in fused_stats))

    failpoint_check(dev, tar, blob_f, res_f, opt, kernels)

    # -- 5. timings --------------------------------------------------------
    sm_hz = max_sm_mhz * 1e6

    def k1_c(x):  # K1's C entry over rows x, outputs allocated here
        o = torch.empty((2, x.shape[0], W // 32), dtype=torch.int32, device=dev)
        return c_launch(gear_cuda.KERNEL, x, o[0], o[1], x.shape[0], W, p.mask_small, p.mask_large)

    def k2_c(offs, sizes):  # K2's C entry; its row order computed once, here
        out = torch.empty((offs.shape[0], 8), dtype=torch.int32, device=dev)
        return c_launch(sha256_cuda.KERNEL, buffer_dev, offs, sizes,
                        sha256_cuda.longest_first(sizes), out, offs.shape[0])

    top_row = int(all_sizes_dev.argmax())  # the longest chunk alone: one thread's chain
    longest_args = (all_offs[top_row:top_row + 1], all_sizes_dev[top_row:top_row + 1])
    longest_host = (all_offs_h[top_row:top_row + 1], all_sizes_h[top_row:top_row + 1])
    l2_flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    k1_ms = kernel_ms(k1_c(rows_k1), 100, sm_hz)
    k1_main_ms = kernel_ms(k1_c(rows_full), 20, sm_hz)
    k2_ms = kernel_ms(k2_c(koffs, ksizes), 50, sm_hz)
    k2_main_ms = kernel_ms(k2_c(all_offs, all_sizes_dev), 10, sm_hz)
    k2_longest_ms = kernel_ms(k2_c(*longest_args), 10, sm_hz)
    k3_launch = c_launch(probe_cuda.KERNEL, tk, tv, allq, wstart, off,
                         torch.empty_like(wstart), allq.shape[0], depth)
    # The main path probes a 1 GiB table once, so K3's time there is the
    # one after an L2 flush; back to back, its ~17 MB of rows stay in the L2.
    k3_ms = kernel_ms(k3_launch, 100, sm_hz, flush=l2_flush.zero_)
    k3_warm_ms = kernel_ms(k3_launch, 200, sm_hz)
    del l2_flush
    k1_call_ms = cuda_ms(lambda: gear_cuda.gear_bitmaps(*k1_args))
    k1_plain_ms = cuda_ms(lambda: gear_cuda.gear_bitmaps_plain(*k1_args))
    k1_main_call_ms = cuda_ms(lambda: gear_cuda.gear_bitmaps(rows_full, p.mask_small, p.mask_large, W))
    k2_call_ms = cuda_ms(lambda: sha256_cuda.sha256_chunks(*k2_call_args))
    k2_plain_ms = cuda_ms(lambda: sha256_cuda.sha256_chunks_plain(*k2_args))
    k2_main_call_ms = cuda_ms(lambda: sha256_cuda.sha256_chunks(buffer_dev, all_offs_h, all_sizes_h))
    k2_longest_call_ms = cuda_ms(lambda: sha256_cuda.sha256_chunks(buffer_dev, *longest_host))
    k3_call_ms = cuda_ms(lambda: probe_cuda.probe_padded(*k3_args))
    k3_plain_ms = cuda_ms(lambda: probe_cuda.probe_padded_plain(*k3_args))

    e2e, splits = [], []
    for _ in range(1 + REPS):
        before = dict(eng.stats)
        t0 = time.perf_counter()
        eng.process_many(files, chunk_dict=cdict)
        e2e.append(time.perf_counter() - t0)
        splits.append({k: eng.stats[k] - before[k] for k in ("pass1_s", "host_s", "pass2_s")})
    e2e, splits = e2e[1:], splits[1:]
    e2e_s = float(np.median(e2e))
    split = {k: float(np.median([s[k] for s in splits])) for k in splits[0]}
    log(f"[5] process_many: median {e2e_s:.3f} s over {REPS} runs -> "
        f"{n_bytes / 2**30 / e2e_s:.3f} GiB/s end to end (runs: "
        + ", ".join(f"{x:.3f}" for x in e2e) + f" s); pass1 {split['pass1_s']:.3f} s, "
        f"host {split['host_s']:.3f} s, pass2 {split['pass2_s']:.3f} s")
    busy_ms, by_name = device_busy(
        lambda: eng.process_many(files, chunk_dict=cdict)
    )
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"[5] device busy {busy_ms:.3f} ms per process_many (torch.profiler: union of kernel "
        f"and copy intervals) = {100 * busy_ms / (e2e_s * 1e3):.1f}% of the median wall time; "
        f"idle {100 - 100 * busy_ms / (e2e_s * 1e3):.1f}%; top: "
        + "; ".join(f"{n[:48]} {ms:.3f} ms" for n, ms in top))

    k1_pos = rows_k1.shape[0] * W
    k1_bound = bound_ms(rows_k1.numel() + 2 * k1_pos / 8, k1_pos * K1_OPS_PER_POS, int_ops_per_s)
    k2_blocks = float(sha_blocks(kb.sizes).sum())
    k2_bd = k2_bound(kb.sizes, int_ops_per_s, sm_hz, rc)
    q_all = to_u32(allq)
    _, rows_seen = host_probe(keys, values, q_all, depth)
    k3_bd = k3_bound(len(q_all), float(rows_seen.sum()), float(to_u32(k3).astype(bool).sum()),
                     int_ops_per_s)
    main_pos = rows_full.shape[0] * W
    k1_main_bound = bound_ms(rows_full.numel() + 2 * main_pos / 8, main_pos * K1_OPS_PER_POS, int_ops_per_s)
    all_sizes = extents[1]
    k2_main_bd = k2_bound(all_sizes, int_ops_per_s, sm_hz, rc)
    longest = int(sha_blocks(all_sizes).max())
    log(f"[5] K1 gear_bitmaps over {k1_pos} positions: kernel {k1_ms:.4f} ms, call "
        f"{k1_call_ms:.4f} ms (plain {k1_plain_ms:.3f} ms, bound {k1_bound[0]:.4f} ms by "
        f"{k1_bound[1]}); whole main-path buffer {rows_full.shape[0]} x {W}: kernel "
        f"{k1_main_ms:.4f} ms, call {k1_main_call_ms:.4f} ms (bound {k1_main_bound[0]:.4f} ms), "
        f"1 launch per process_many")
    log(f"[5] K2 sha256_chunks over bucket cap {kb.cap_blocks} ({int(k2_blocks)} blocks): kernel "
        f"{k2_ms:.4f} ms, call {k2_call_ms:.4f} ms (plain {k2_plain_ms:.3f} ms, bound "
        f"{k2_bd[0]:.4f} ms: throughput term {k2_bd[2]:.4f} ms, serial term {k2_bd[4]:.4f} ms); "
        f"all {len(all_sizes)} chunks of one process_many (longest {longest} blocks) in "
        f"{launches['sha']} launch: kernel {k2_main_ms:.4f} ms, call {k2_main_call_ms:.4f} ms "
        f"(bound {k2_main_bd[0]:.4f} ms: throughput term {k2_main_bd[2]:.4f} ms by "
        f"{k2_main_bd[3]}, serial term {k2_main_bd[4]:.4f} ms = {longest} blocks x 64 rounds x "
        f"{rc:.3f} cycles (measured, {K2_ROUND_DEPTH} dependent instructions) at "
        f"{max_sm_mhz:.0f} MHz; the {'serial' if k2_main_bd[4] > k2_main_bd[2] else 'throughput'} "
        f"term bounds); the longest chunk alone: kernel {k2_longest_ms:.4f} ms = "
        f"{k2_longest_ms * 1e-3 * sm_hz / longest:.0f} cycles per block at the max clock, call "
        f"{k2_longest_call_ms:.4f} ms")
    log(f"[5] K3 probe_padded over {len(q_all)} queries ({int(rows_seen.sum())} chain rows, depth "
        f"{depth}): kernel {k3_ms:.4f} ms after an L2 flush ({k3_ms / k3_bd[0]:.2f}x the bound), "
        f"{k3_warm_ms:.4f} ms back to back (L2 warm), call {k3_call_ms:.4f} ms (plain "
        f"{k3_plain_ms:.3f} ms, bound {k3_bd[0]:.4f} ms by {k3_bd[1]}), 1 launch per "
        f"process_many")

    # -- 6. registry -------------------------------------------------------
    registry, grown = registry_phase(dev, int_ops_per_s, sm_hz)

    # -- 7. windowed engine --------------------------------------------------
    windowed = windowed_phase(dev, files, res, kernels, int_ops_per_s, sm_hz, rc)

    # -- 8. pack lanes ---------------------------------------------------------
    lanes = pack_lanes_phase(dev, tar, blob_n, res_n, blob_f, kernels)
    k1_err = max(k1_err, windowed["k1_err"])
    k2_err = max(k2_err, windowed["k2_err"])

    # -- 9. BLAKE3 -------------------------------------------------------------
    b3 = blake3_phase(dev, files, res, buffer_dev, extents, windowed, tar, blob_f, res_f,
                      all_kernels, int_ops_per_s, sm_hz, rc)

    # -- 10. compressed packs --------------------------------------------------
    comp = compressed_phase(dev, tar, lanes, all_kernels)

    # -- 11. registry growth, the dict service, the fused probe after an insert --
    t11 = time.perf_counter()
    growth = growth_phase(dev, grown, kernels)
    del grown
    service = service_phase(dev, tar, blob_f, res_f, kernels)
    fused_grown = fused_after_insert_phase(dev, eng, files, first, cdict, kernels)
    log(f"[11] {time.perf_counter() - t11:.1f} s")

    # -- 12. the native engine's host arms: the hybrid engine and pack lanes --
    host_arms_phase(dev, files, res, windowed, b3, e2e_s, tar, comp, all_kernels)

    # -- 13. images: BatchConverter, Merge, Unpack, real RAFS v5/v6 ------------
    images = image_phase(dev, files, all_kernels, t_start)

    # -- 14. codec and cipher: the adaptive zstd codec, blob encryption ---------
    cc = codec_cipher_phase(dev, tar, files, comp, all_kernels)

    # -- 15. the device mesh: the sharded dict and its probes, the sharded step --
    mesh = mesh_phase(dev, files, res, digests, q_all, to_u32(k3), kernels)

    def row(key, name, source, replaces, err, kern, call, plain, bound, main_kern, main_call,
            main_bound, work, n_launches=None, **extra):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key] if n_launches is None else n_launches,
            "max_abs_err": err, "ms": kern, "plain_ms": plain,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "status": "ported: built, equal to plain, launched on the main path",
            "work": work, "kernel_ms": kern, "call_ms": call, "main_path_kernel_ms": main_kern,
            "main_path_call_ms": main_call, "main_path_bound_ms": main_bound[0], **extra,
        }

    def cc_launches(key):  # phase 14: per fused pack or batch
        return {"adaptive_fused": cc["adaptive"]["launches"][key],
                "adaptive_fused_blake3": cc["adaptive"]["blake3_launches"][key],
                "trained_batch": cc["trained_batch"]["launches"][key],
                "encrypted_fused": cc.get("encrypted", {}).get("launches", {}).get(key)}

    def comp_launches(key):  # phase 10: per codec and lane
        return {c: {lane: r[lane]["launches"][key] for lane in ("fused", "jax")}
                for c, r in comp["codecs"].items()}

    def mesh_launches(key):  # phase 15: per mesh path
        return {path: counts[key] for path, counts in mesh["launches"].items()}

    pkg = "nydus_snapshotter_tpu_torch/csrc/"
    line = {"kernels": [
        row("gear", "gear_bitmaps", pkg + "gear_bitmaps.cu",
            "nydus_snapshotter_tpu/ops/gear_pallas.py:115", k1_err, k1_ms, k1_call_ms, k1_plain_ms,
            k1_bound, k1_main_ms, k1_main_call_ms, k1_main_bound, f"{rows_k1.shape[0]}x{W} positions",
            windowed_launches=windowed["launches"]["gear"],
            pack_jax_launches=lanes["jax"]["launches"]["gear"],
            pack_compressed_launches=comp_launches("gear"),
            image_batch_launches=images["launches"]["gear"], image_batch_layers=images["layers"],
            codec_cipher_launches=cc_launches("gear"), mesh_launches=mesh_launches("gear"),
            window_kernel_ms=windowed["window_kernel_ms"], window_bound_ms=windowed["window_bound_ms"]),
        row("sha", "sha256_chunks", pkg + "sha256.cu",
            "nydus_snapshotter_tpu/ops/sha256_pallas.py:125", k2_err, k2_ms, k2_call_ms, k2_plain_ms,
            k2_bd, k2_main_ms, k2_main_call_ms, k2_main_bd,
            f"bucket cap {kb.cap_blocks}: {len(kb.sizes)} rows, {int(k2_blocks)} blocks",
            bound_terms_ms={"throughput": k2_bd[2], "serial": k2_bd[4]},
            main_path_bound_terms_ms={"throughput": k2_main_bd[2], "serial": k2_main_bd[4]},
            longest_chunk_kernel_ms=k2_longest_ms, longest_chunk_call_ms=k2_longest_call_ms,
            longest_chunk_blocks=longest, round_cycles=rc, round_depth=K2_ROUND_DEPTH,
            windowed_launches=windowed["launches"]["sha"],
            pack_jax_launches=lanes["jax"]["launches"]["sha"],
            pack_compressed_launches=comp_launches("sha"),
            image_batch_launches=images["launches"]["sha"], image_batch_layers=images["layers"],
            codec_cipher_launches=cc_launches("sha"), mesh_launches=mesh_launches("sha"),
            batch32_kernel_ms=windowed["batch_kernel_ms"], batch32_bound_ms=windowed["batch_bound_ms"],
            chunks_1m_kernel_ms=windowed["k2_1m_kernel_ms"], chunks_1m_bound_ms=windowed["k2_1m_bound_ms"],
            chunks_1m_longest_blocks=windowed["longest_1m_blocks"]),
        row("probe", "probe_padded", pkg + "probe.cu",
            "nydus_snapshotter_tpu/ops/probe_pallas.py:151", k3_err, k3_ms, k3_call_ms, k3_plain_ms,
            k3_bd, k3_ms, k3_call_ms, k3_bd, f"{len(q_all)} queries, depth {depth}",
            kernel_l2_warm_ms=k3_warm_ms, registry=registry,
            growth_launches_per_lookup=growth["launches_per_lookup"],
            service_probe_launches=service["probe_launches"],
            fused_after_insert_launches=fused_grown["launches"]["probe"],
            mesh_launches=mesh_launches("probe"),
            growth=growth, service=service, fused_after_insert=fused_grown,
            mesh={k: v for k, v in mesh.items() if k != "launches"}),
        row(None, "blake3_chunks", pkg + "blake3.cu",
            "nydus_snapshotter_tpu/ops/blake3_jax.py:214", b3["max_abs_err"],
            b3["kernel_ms"], b3["call_ms"], b3["plain_ms"], b3["bound"], b3["kernel_ms"],
            b3["call_ms"], b3["bound"], f"{extents.shape[1]} chunks, {int(b3['bound'][5])} "
            "compressions", n_launches=b3["launches"]["b3_leaves"] + b3["launches"]["b3_parents"],
            tpu_kernel="nydus_snapshotter_tpu/ops/blake3_jax.py:214 (XLA, not Pallas)",
            launches_by_entry={k: b3["launches"][k] for k in ("b3_leaves", "b3_parents")},
            leaves_kernel_ms=b3["leaves_kernel_ms"], parents_kernel_ms=b3["parents_kernel_ms"],
            bound_terms_ms={"throughput": b3["bound"][2], "serial": b3["bound"][4]},
            windowed_1m_launches=b3["windowed_launches"]["b3_leaves"]
            + b3["windowed_launches"]["b3_parents"],
            pack_fused_launches=b3["pack_fused_launches"]["b3_leaves"]
            + b3["pack_fused_launches"]["b3_parents"],
            chunks_1m_kernel_ms=b3["kernel_1m_ms"], chunks_1m_call_ms=b3["call_1m_ms"],
            chunks_1m_plain_ms=b3["plain_1m_ms"], chunks_1m_bound_ms=b3["bound_1m"][0],
            chunks_1m_bound_terms_ms={"throughput": b3["bound_1m"][2], "serial": b3["bound_1m"][4]},
            pack_jax_launches=b3["pack_jax_launches"]["b3_leaves"]
            + b3["pack_jax_launches"]["b3_parents"],
            pack_all_options_launches=comp["all_options"]["launches"]["b3_leaves"]
            + comp["all_options"]["launches"]["b3_parents"],
            codec_cipher_launches=cc["adaptive"]["blake3_launches"]["b3_leaves"]
            + cc["adaptive"]["blake3_launches"]["b3_parents"],
            fused_gib_per_s=b3["gib_per_s"], pack_fused_wall_s=b3["pack_wall_s"],
            pack_jax_wall_s=b3["pack_jax_wall_s"], windowed_1m_wall_s=b3["windowed_1m_wall_s"]),
    ]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
