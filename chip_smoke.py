#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, measure.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh-only   # phases 0-3 and 15 alone, on every visible card
    python3 chip_smoke.py --ha-only     # phases 0-3, 16 and 17 alone
    python3 chip_smoke.py --convert-only  # phases 0-3 and 18 alone
    python3 chip_smoke.py --registry-only  # phases 0-3 and 19 alone
    python3 chip_smoke.py --formats-only  # phases 0-3 and 20 alone
    python3 chip_smoke.py --fetch-only    # phases 0-3 and 21 alone
    python3 chip_smoke.py --serve-only    # phases 0-3 and 22 alone
    python3 chip_smoke.py --snapshot-only  # phases 0-3 and 23 alone
    python3 chip_smoke.py --cli-only       # phases 0-3 and 24 alone

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
   each wall time the median of ``PACK_REPS`` runs after that checked one, every run
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
   (at least that on the other two); each wall time the median of ``PACK_REPS`` after
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
   of ``PACK_REPS``) and ``pack_layer(backend="jax", digester="blake3")`` over the same
   tar (K4 per digest batch, each submitted under sync debug mode "error";
   equal to the fused BLAKE3 pack; median of ``PACK_REPS``); K4 alone, through its
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
   submitted under sync debug mode "error"), wall time the median of
   ``PACK_REPS`` after the checked run, each run printed with its host CPU seconds and
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
   ``HYBRID_REPS`` after the checked run (the checked run when 0), GiB/s. (b) ``pack_layer(backend="hybrid")`` over
   phase 4's tar (lz4_block) at ``NTPU_PACK_THREADS=1``: the whole-layer
   ``pack_files`` lane at SHA-256 and at BLAKE3, and the
   ``chunk_digest_multi`` lane with phase 10's dict bootstrap as
   ``chunk_dict_path``; (c) at the default thread count, the per-file lane
   on the stage-parallel pipeline (route lane ``pipeline``). Each equal to its fused twin (blob, bootstrap, blob id),
   its lane and route printed, no launch, the median of ``PACK_REPS`` after
   the checked run with its ``stats``.
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
   (median of ``IMAGE_REPS`` after the checked run, or the checked run
   when that is 0), the fan-out-1 and hybrid batches
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
16. HA — the dict plane on the card. A primary ``ha.runner`` child process
   (``--device cuda:0``) holds a namespace of phase 4's tar bootstrap,
   phase 2's layer (one record per chunk) and 2^20 synthetic chunk
   records (random digests from the seed); an in-process replica
   (``DictService`` + ``HaAgent`` on the card) is placed by an in-process
   ``PlacementController`` (members and liveness injected) and catches up
   from zero in byte-budgeted pulls (wall time, pulls, largest pull
   printed; the largest pull within the budget plus the non-chunk rows).
   The replica's record tables equal the primary's saved bootstrap, and it
   stays caught up without a resync; phase
   5's queries answer identically on both, the replica's through one K3
   launch. Then two images (two layers each of phase 13's A, and A's
   lowest beside a text-rewritten top) convert twice with
   ``BatchConverter(dict_service=...)``: against one ``DictService`` (the
   oracle) and against ``service://<primary>|<replica>``, the primary
   SIGKILLed after the first image, ``report_down`` + ``tick()`` promoting
   the replica, the mirror failing over; every blob and bootstrap equals
   the oracle's (K1 and K2 once per layer), and a probe RPC on the promoted
   replica launches K3 once with the same answers. Kill -> promoted ->
   failed over -> first merge acknowledged is printed.
17. OCIRef — phase 4's tar as a gzip layer (level 1, in parallel members:
   a multi-member stream) and a zstd -3 layer; ``pack_gzip_layer`` and
   ``pack_zstd_layer`` on the host path and on the card's
   ``ChunkDigestEngine`` (K2 under SHA-256, K4 under BLAKE3; the tar
   handed over), bootstraps byte-identical; 64 seeded random files read
   through ``BlobReader``'s gzip checkpoints (random order), and the same
   64 through its zstd cursor (ascending offsets: it resumes forward
   reads and rewinds to the stream's start whenever a chunk begins behind
   it), equal the tar's bytes; ``Unpack`` of the whole gzip ref layer
   (its stream chunks read in ascending offset order, one inflate pass)
   equals the tar's tree; ``hooks.convert_image`` over a three-layer
   gzip OCI image in a temporary ``LocalContentStore``, packed (K1 and K2
   once a layer) and ``oci_ref`` (K2 once a layer, the index's digests):
   four-layer nydus manifests with their configs, a file of every layer
   read back.
18. converter CLI and corpora — (a) ``cmd.convert.main`` in process on
   phase 4's tar at the CLI's defaults (1 MiB CDC chunks, lz4_block, v6;
   no ``--device``: the card): ``pack --backend fused`` (K1 and K2 once)
   and the default ``hybrid`` (no launch) write the same layer stream, as
   do ``--digester blake3`` fused (K1 once, K4's two launches once each)
   and hybrid; ``detect_features()`` has DEVICE_DIGEST. (b) ``merge``,
   ``check``, ``inspect --prefix`` (the tar's paths under the prefix) and
   ``unpack`` (every member's bytes equal the source's) on (a)'s output,
   no launch. (c) ``tarfs_bootstrap_from_tar`` of the tar with the card's
   ``ChunkDigestEngine`` (K2 once): every region's digest equals
   hashlib's and the bootstrap the host route's; ``export-erofs`` (an
   EROFS disk holding the tar at a 512-byte boundary) and ``export-real
   --format v6`` of it (the real layout reads back with the same digests).
   (d) ``python -m nydus_snapshotter_tpu_torch.cmd.convert pack --backend
   fused`` as a process: rc 0, one JSON line, the blob of (a); ``check`` of
   4096 random bytes: rc 1, one stderr line. (e) The scenario corpora at
   64 KiB chunks, ``pack_layer`` fused (K1 and K2 once) against hybrid (no
   launch), byte for byte, each with its route and ``stats`` split:
   ``cdc_resonant_layer`` in ``min`` and ``max`` mode (256 MiB; every
   chunk of a file but its last is ``min_size`` / ``max_size``),
   ``single_huge_file_layer`` (1024 MiB, one file),
   ``tiny_files_layer`` (100 000 files), ``incompressible_layer`` and
   ``compressible_layer`` (256 MiB each, zstd under the adaptive codec:
   the bypass engages on the first only). (f) ``cross_tree_dedup`` with
   fixed chunks on the card (K2 only) and on the hybrid lane: the same
   figures. (g) Tree 1 at drift epochs 0, 8, 16 and 24
   (``misc/scenarios/soak.toml``'s seed and drift rate) through ``batch``
   with a growing dict, fused (K1 and K2 once per image) and hybrid: the
   same images and dict; each epoch's new chunks beside its
   ``shared_fraction``.
19. registry and tarfs manager — an in-process OCI registry on
   127.0.0.1 (``OciRegistry``: manifests, configs, blobs with ``Range``)
   serves a three-layer image: phase 4's tar as a plain layer, a gzip'd
   ``TARFS_L2_MIB`` tar and a gzip'd ``TARFS_L3_MIB`` tar that whites out
   one of L1's files and makes one of its directories opaque. A
   ``tarfs.Manager(engine=ChunkDigestEngine(device=<the card>),
   validate_diff_id=True, export_mode="image_block_with_verity")`` prepares
   the three layers at once (its ``Remote`` switched to plain HTTP, as the
   reference's tests do): each READY, K2 launched once per layer index
   build (three ``digest_many`` calls, one per layer thread), each
   ``layer.boot`` equal to a host-route ``Manager(engine=None)``'s from the
   same registry (no launch). ``merge_layers`` equals the host route's
   ``image.boot`` (L3's whiteout and opaque directory applied);
   ``export_block_data`` writes the EROFS disk whose dm-verity tree
   ``tarfs.verity.verify`` accepts; ``mount_tar_erofs`` with recording loop
   and mount backends (``utils.losetup`` / ``utils.mount``'s seams, as the
   reference's tests replace them: the operating system, not the card, is
   stood in for) attaches the three tars and the meta image and mounts
   EROFS with their ``device=`` list; ``umount_tar_erofs`` and
   ``detach_layer`` leave nothing behind. A layer whose config names a
   wrong diff ID ends FAILED with the reference's logged message and no
   launch. Printed: the pulls, each index build, the merge and the export
   with the card's name and power limit.
20. lazy formats — phase 4's tar as four layers on an in-process registry
   (``OciRegistry``, which also serves the referrers API): gzip level 1 in
   8 members, seekable zstd -3 in 1 MiB frames (``zframe.write_seekable``),
   zstd:chunked over its files (``toc.write_zstd_chunked``) and eStargz
   over ``FORMATS_ESTARGZ_FILES`` of its files (``estargz_blob``, the shape
   of tests/test_stargz.py's ``build_estargz``), and a single-frame zstd
   layer. ``SociResolver.get_blob`` routes them over HTTP ranges to
   zran-index, seekable-index and toc-adopt (twice); the single-frame
   layer's prepare raises ``SociError`` (rafs-convert), and
   ``route_counts`` moves by exactly those. ``SociAdaptor`` prepares the
   four layers and merges them on the host with no launch; the persisted
   ``.soci.idx`` and ``.soci.zidx`` reload through ``find_index`` /
   ``find_zindex`` into the indexes it built. ``pack_gzip_layer`` /
   ``pack_zstd_layer`` on a ``ChunkDigestEngine(backend="jax",
   digest_backend="jax")`` on the card: K2 once per SHA-256 pack, K4's two
   launches once each per BLAKE3 pack, each bootstrap equal to the host's
   (the adaptor's for SHA-256). ``FORMATS_READS`` seeded files read in
   descending offsets through ``BlobReader`` over the card's bootstrap with
   ``SociStreamReader`` / ``ZstdStreamReader`` mounted (from memory and
   over the registry's ranges) and through the sequential readers (all of
   them for gzip, ``FORMATS_SEQ_ZSTD_READS`` for zstd), each equal to the
   tar's bytes: s and compressed bytes fetched per read. A
   ``ReferrerManager`` finds a nydus bootstrap layer behind the referrers
   API (its second lookup cached) and ``fetch_metadata`` writes the merged
   ``image.boot``.
21. lazy fetch — the daemon's fetch side at the reference's defaults
   (``FetchConfig()``: 4 fetch workers, 128 KiB merge gap, 1 MiB readahead,
   a 64 MiB budget) over phase 4's tar packed on the card:
   ``pack_layer(backend="fused", compressor="lz4_block")`` with a prefetch
   table of ``FETCH_PREFETCH_FILES`` seeded files launches K1 and K2 once
   each and equals the hybrid lane's blob, bootstrap and blob id (no
   launch); the blob's data section is served by ``OciRegistry`` with
   ``Range``, every ranged GET counted. Node A: ``CachedBlob`` over
   ``RegistryBlobFetcher`` reads ``FETCH_READS`` seeded files chunk by chunk
   (``BlobReader.chunk_data`` over ``read_at``) from ``FETCH_THREADS``
   threads, each equal to the tar's bytes; the provenance ledger conserves
   the fetched bytes, one GET per flight; a first node with merge gap 0
   fetches no byte twice, and at the defaults the bytes that coalesced
   flights fetched again are counted. A second pass is all hits (any GET a
   readahead flight). Node B reads the same files through
   ``PeerAwareFetcher`` from A's ``PeerChunkServer`` over UDS: every
   demand flight served by the peer (the ledger's cause and tier rows),
   registry GETs only for readahead windows A never fetched; with A's
   server stopped, ``FETCH_AFTER_READS`` new files fall back to the
   registry, still equal. Node C's ``PrefetchReplayer`` warms the
   bootstrap's prefetch table at the prefetch lane; its files then read as
   hits. ``compile_heat`` on A's ledger writes a ``.heat`` artifact that
   ``load_or_adopt_heat`` adopts in a fresh cache dir with equal extents.
   ``CacheManager`` counts A's and C's entries with their companions, and
   ``gc_watermark`` evicts A's under its live ``CachedBlob``, whose next
   reads re-fetch, still equal. The tar's gzip layer (8 members) reads
   ``FETCH_SOCI_READS`` files in descending offsets through
   ``SociStreamReader`` over a ``CachedBlob``, equal to the tar; a second
   pass fetches nothing. Printed: ms a read, GETs, bytes fetched against
   requested, coalesced flights and singleflight joins of every pass, with
   the card's name and power limit.
22. serving — the daemon's serving side over an image packed on the card.
   Phase 4's tar split into two layers by a seeded half of its files, each
   ``pack_layer(backend="fused", compressor="lz4_block")`` with its part of
   a ``SERVE_PREFETCH_FILES``-file prefetch table (K1 and K2 once per
   layer), ``Merge``d with the whole table; the blobs in a localfs blob dir
   and behind ``OciRegistry``. The port's ``Daemon`` spawns its server
   (``DaemonCommand``: ``python -m nydus_snapshotter_tpu_torch.daemon.server``,
   its command line printed and checked against ``/proc/<pid>/cmdline``)
   with a port ``Supervisor``; its pid must not be among ``nvidia-smi
   --query-compute-apps=pid`` (no CUDA context). The merged bootstrap is
   mounted twice, localfs and registry (the fetch defaults); the daemon
   makes the kernel FUSE mount where mount(2) is allowed (a probe prints
   mount(2)'s error where it is not), else serves its HTTP file API only.
   ``prefetch_data_amount`` grows to the table's bytes with no client read.
   ``SERVE_READS`` seeded files from ``SERVE_THREADS`` threads through
   ``/api/v1/fs?op=read``, localfs then registry, cold then warm (and
   through the kernel mounts where made), each equal to the tar's bytes:
   ms a read (median, p95), registry GETs, ``/api/v1/metrics/blobcache``;
   ``/api/v1/provenance`` conserves every blob's fetched bytes. SIGKILL, the
   successor spawned with ``--upgrade`` takes the state (and FUSE fds) from
   the supervisor: ms from the kill to its first read served, then every
   read again equal. fscache: ``bind_blob`` on the daemon's API, and in
   this process a ``DaemonServer``'s cookies served by the ondemand loop
   over an injected ``DeviceIO`` pipe: the meta cookie of the two layers'
   merged tarfs bootstrap equals ``erofs_from_rafs`` of it (the lz4 image's
   meta cookie gets a negative copen, as EROFS export needs identity-mapped
   chunks), a blob cookie's READ windows equal the blob's bytes. SIGTERM
   ends the daemon within ``SERVE_EXIT_S``: its socket removed, no mount
   left. The launch counters run over the whole phase: K1 and K2 twice.
23. container start — the port's snapshotter stack as ``cmd/snapshotter.py``
   builds it (``SnapshotterConfig`` on a short root, ``Database``,
   ``Manager`` for fusedev and blockdev under the restart policy,
   ``CacheManager``, ``tarfs.Manager(engine=ChunkDigestEngine(chunk_size=
   DEFAULT_CHUNK_SIZE, mode="fixed", backend="jax", device=<the card>))``,
   ``Filesystem``, ``Snapshotter``, ``api.service.serve`` on a UDS) driven
   by ``SnapshotsClient``. A nydus image (phase 4's tar split in two
   layers, each packed fused with lz4: K1 and K2 once per layer, merged):
   containerd's pull transcript (Stat, then Prepare per layer with the CRI
   and nydus labels: the blob layers answer ALREADY_EXISTS, the bootstrap
   layer is prepared, unpacked and committed), the container's Prepare and
   Mounts, which name the shared daemon ``Manager`` spawned (the port's
   server by its command line, no CUDA context). Phase 19's tarfs image
   with the tarfs hint: each layer's Prepare goes through
   ``prepare_tarfs_layer`` (K2 once per layer index build; the committed
   snapshot must carry ``NYDUS_TARFS_LAYER``), the container's Prepare
   merges them (every ``layer.boot`` and the ``image.boot`` equal the host
   route's, ``Manager(engine=None)``), Mounts gives the EROFS mount: loop
   and EROFS mounts made where a probe finds them allowed, else recorded
   (the reason printed). ``SNAP_READS`` seeded files from ``SNAP_THREADS``
   threads from each container (through the daemon's file API or its
   kernel mount, through the EROFS mount or the layers' tars by the merged
   chunk table), equal to the tar's bytes. SIGKILL of the daemon: the
   death handler respawns it (ms to the first read served); the
   snapshotter and its gRPC server closed with the daemon left running and
   a new stack on the same root (``Manager.recover`` takes the daemon
   back, Walk lists the same snapshots; ms to the first read served);
   reads equal after both. Every snapshot removed (containers first), then
   Cleanup: no snapshot directory, mount, loop device or daemon left.
   Printed: ms per RPC (median, p95), ms from each image's first layer
   Prepare to its container's Mounts, ms a read, each index build's time,
   K1 and K2 launches over the phase.
24. command line — ``cmd.snapshotter.build_stack`` in this process on a
   config with tarfs on and ``accel_backend = "jax"`` on the card: phase
   19's tarfs image (behind the registry again) pulled and a container
   prepared through ``SnapshotsClient``; K2 once per layer, K1, K3 and K4
   never; every ``layer.boot`` and the ``image.boot`` equal phase 23's (the
   host route's under ``--cli-only``). Then ``python -m
   nydus_snapshotter_tpu_torch.cmd.snapshotter --config <toml>`` as a
   process (system controller, fleet plane, metrics exporter on; a shared
   daemon): ms to its ready sockets, the same pull and container (ms from
   the first layer's Prepare to the Mounts); the process holds a CUDA
   context and its daemon none; its launches, counted at its exit by a
   ``sitecustomize`` this phase puts on its path, K2 once per layer; the
   indexes equal; ``SNAP_READS`` seeded files read through the container
   (the kernel EROFS mount where loop devices are allowed, else the
   layers' tars by the merged chunk table); ``/v1/metrics`` and the
   controller's fleet members, federated metrics and daemons scraped;
   everything removed, SIGTERM: exit 0 within ``CLI_EXIT_S`` (ms printed),
   no socket, mount or daemon left. fanotify: where ``fanotify_init`` is
   allowed, ``optimizer-server`` is built and one trace run; else the
   reason is printed.

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
# engine (phase 12, ~4 s a run); 0 reports the checked run. They keep the
# script inside its time limit; their medians of 3 from PRs 5-9 stand in
# PERF.md.
WINDOWED_REPS = 0
HYBRID_REPS = 0
# Timed runs after each checked pack (phases 4, 8-12; phase 14 keeps one,
# whose codec it reads) and after phase 13's checked fused batch; 0 reports
# the checked run. None keeps the script, phase 18 included, inside its time
# limit on the slower card hosts (1212 s of command with 3 and 1 on one such
# host, PERF.md §4). Checks all stay.
PACK_REPS = 0
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
IMAGE_REPS = 0
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


def or_checked(runs: list, first_s: float) -> list:
    """Timed repetitions after a checked run, or, with none (a ``*_REPS``
    of 0), the checked run's wall seconds standing for them (its host CPU
    seconds and page faults were not taken: nan and -1)."""
    return runs or [(first_s, float("nan"), -1)]


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
    before = dict(eng.stats)
    t0 = time.perf_counter()
    got = eng.process_many(files)
    first_s = time.perf_counter() - t0
    first_split = {k: eng.stats[k] - before[k] for k in eng.stats}
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
    walls, splits = walls or [first_s], splits or [first_split]
    wall = float(np.median(walls))
    split = {k: float(np.median([x[k] for x in splits])) for k in splits[0]}
    busy_ms, by_name = device_busy(lambda: eng.process_many(files))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"[7] windowed process_many: median {wall:.3f} s over {WINDOWED_REPS} runs after the "
        f"checked one (the checked run when 0) -> "
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
            got = []
            first_run = host_timed(lambda: got.append(fn()))
            (blob, res), first = got[0], first_run[0]
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
        runs = [host_timed(fn) for _ in range(PACK_REPS)] or [first_run]
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
    win_walls, win_splits = win_walls or [win_s], win_splits or [win_first]
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
    for _ in range(PACK_REPS):
        got = []
        pack_runs.append(host_timed(lambda: got.append(
            pack_layer(tar, PackOption(backend="fused", **opt), device=dev)[0])))
        if got[0] != blob_b:
            raise AssertionError("the fused BLAKE3 pack differs from its checked run")
    pack_runs = or_checked(pack_runs, pack_first)
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
    for _ in range(PACK_REPS):
        got = []
        jax_runs.append(host_timed(lambda: got.append(
            pack_layer(tar, PackOption(backend="jax", **opt), device=dev)[0])))
        if got[0] != blob_b:
            raise AssertionError("the jax lane's BLAKE3 pack differs from its checked run")
    jax_runs = or_checked(jax_runs, jax_first)
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
            st0 = {}
            got, first, launches, batches = counted(
                lambda: pack_layer(tar, PackOption(backend=lane, **opt), device=dev, stats=st0))
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
            for _ in range(PACK_REPS):
                st, blobs = {}, []
                runs.append(host_timed(lambda: blobs.append(
                    pack_layer(tar, PackOption(backend=lane, **opt), device=dev, stats=st)[0])))
                stats.append(st)
                if blobs[0] != ref[0]:
                    raise AssertionError(f"{codec} pack {lane} differs from its checked run")
            runs, stats = or_checked(runs, first), stats or [st0]
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
    for _ in range(PACK_REPS):
        t0 = time.perf_counter()
        again = eng.process_many(files, chunk_dict=cdict)
        runs.append(time.perf_counter() - t0)
        if not np.array_equal(again.probe, res.probe):
            raise AssertionError("probe answers differ between process_many calls")
    runs = runs or [wall_s]
    log(f"[11] fused after insert: {len(extra)} digests of another third of the layer's files "
        f"into phase 2's dict (epoch {epoch0} -> {epoch}, max chain {depth}) in "
        f"{insert_s * 1e3:.1f} ms; process_many {wall_s:.3f} s (the dict's restage included), "
        f"launches {launches}; {len(q_host)} probe answers == host probe of the grown table, "
        f"{hits} hits, every inserted digest == its assigned index; median of {PACK_REPS} after it "
        "(the checked run when 0) "
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
        wall = float(np.median([r[0] for r in runs])) if runs else first
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
            for _ in range(PACK_REPS):
                st_r, blobs = {}, []
                runs.append(host_timed(lambda: blobs.append(pack_layer(tar, hopt, stats=st_r)[0])))
                stats.append(st_r)
                if blobs[0] != got[0]:
                    raise AssertionError(f"the hybrid pack ({name}) differs from its checked run")
        runs, stats = or_checked(runs, first), stats or [st]
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
    fused_wall = float(np.median(fused_walls)) if fused_walls else fused_first
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
    for _ in range(max(PACK_REPS, 1)):  # one at least: the class counts need an explicit codec
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


# ---------------------------------------------------------------------------
# Phase 16: the HA dict plane
# ---------------------------------------------------------------------------

HA_SYNTH_CHUNKS = 1 << 20  # synthetic chunk records in the replicated namespace
HA_NS = "registry"
HA_BATCH_NS = "batch"


def records_bootstrap(chunks, blob_id: str, chunk_size: int = CHUNK_SIZE) -> bytes:
    """A dict-image bootstrap of ``chunks`` = [(digest, uoff, usize)] in one
    blob, stored uncompressed."""
    from nydus_snapshotter_tpu_torch.models.bootstrap import BlobRecord, Bootstrap, ChunkRecord

    recs = [ChunkRecord(digest=d, blob_index=0, flags=0, uncompressed_offset=o,
                        compressed_offset=o, uncompressed_size=s, compressed_size=s)
            for d, o, s in chunks]
    total = sum(s for _d, _o, s in chunks)
    blob = BlobRecord(blob_id=blob_id, compressed_size=total, uncompressed_size=total,
                      chunk_count=len(recs))
    return Bootstrap(chunk_size=chunk_size, inodes=[], chunks=recs, blobs=[blob]).to_bytes()


def layer_records(files, res) -> list:
    """Phase 2's chunks as (digest, offset in the joined layer, size)."""
    out, base = [], 0
    for f, cuts, digs in zip(files, res.cuts, res.digests):
        prev = 0
        for cut, d in zip(cuts, digs):
            out.append((d, base + prev, int(cut) - prev))
            prev = int(cut)
        base += f.size
    return out


def ha_phase(dev, files, res, res_f, q_all, kernels) -> dict:
    """Phase 16: a primary ``ha.runner`` child on the card, an in-process
    replica (DictService + HaAgent on the card) placed by an in-process
    PlacementController; catch-up from zero, identical tables and answers,
    and a failover batch with the primary SIGKILLed after its first image."""
    import os
    import signal
    import subprocess
    import tempfile

    from nydus_snapshotter_tpu_torch import fleet
    from nydus_snapshotter_tpu_torch.converter import PackOption, batch
    from nydus_snapshotter_tpu_torch.ha.placement import PlacementController, _rank
    from nydus_snapshotter_tpu_torch.ha.replicate import HaAgent
    from nydus_snapshotter_tpu_torch.parallel.dict_service import DictClient, DictService
    from nydus_snapshotter_tpu_torch.utils import udshttp

    t_phase = time.perf_counter()
    probe = kernels["probe"]
    tmp = tempfile.mkdtemp(prefix="ntpu-ha-")
    psock, rsock, osock = (str(Path(tmp) / n) for n in ("p.sock", "r.sock", "o.sock"))
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    env.pop("NTPU_FLEET_CONTROLLER", None)
    child_log = open(Path(tmp) / "primary.log", "wb")
    child = subprocess.Popen(
        [sys.executable, "-m", "nydus_snapshotter_tpu_torch.ha.runner", "--listen", psock,
         "--role", "primary", "--device", str(dev)],
        cwd=str(Path(__file__).resolve().parent), env=env, stdout=child_log,
        stderr=subprocess.STDOUT)
    repl = DictService(device=dev)
    agent = HaAgent(repl, role="unassigned")
    oracle = DictService(device=dev)
    try:
        # the namespace's contents, made while the child reaches the card
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED + 16)
        synth = rng.integers(0, 2**32, (HA_SYNTH_CHUNKS, 8), dtype=np.uint32)
        sdigs = synth.view(np.uint8).reshape(-1, 32)
        synth_boot = records_bootstrap(
            [(sdigs[i].tobytes(), i * CHUNK_SIZE, CHUNK_SIZE) for i in range(HA_SYNTH_CHUNKS)],
            f"{SEED + 16:064x}")
        layer_recs = layer_records(files, res)
        layer_boot = records_bootstrap(layer_recs, hashlib.sha256(b"phase 2 layer").hexdigest())
        boots = [("phase 4 tar", res_f.bootstrap), ("phase 2 layer", layer_boot),
                 ("synthetic", synth_boot)]
        t_make = time.perf_counter() - t0
        deadline = time.monotonic() + 120
        while True:
            if child.poll() is not None:
                raise AssertionError(f"the primary runner exited with {child.returncode}: "
                                     + (Path(tmp) / "primary.log").read_text()[-2000:])
            try:
                if udshttp.get_json(psock, "/api/v1/ha/status", timeout=1.0)["role"] == "primary":
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise AssertionError("the primary runner's socket never answered")
            time.sleep(0.1)
        t_child = time.perf_counter() - t_phase
        pcli = DictClient(psock, timeout=300)
        t0 = time.perf_counter()
        added = [pcli.merge(b, HA_NS)["added"] for _n, b in boots]
        t_merge = time.perf_counter() - t0
        total = pcli.stats(HA_NS)["chunks"]
        if total != sum(added) or added[2] != HA_SYNTH_CHUNKS:
            raise AssertionError(f"primary merges added {added}, holds {total} chunks")
        log(f"[16] primary ha.runner child (pid {child.pid}) on {dev}: answering after "
            f"{t_child:.1f} s; namespace {HA_NS!r}: phase 4's tar bootstrap, phase 2's layer "
            f"({len(layer_recs)} chunks) and {HA_SYNTH_CHUNKS} synthetic records, built in "
            f"{t_make:.1f} s, merged in {t_merge:.1f} s -> {total} records "
            f"({total * 64 / 2**20:.1f} MiB of chunk rows)")

        # -- placement: the child is the rank-first member, so it stays primary
        repl.run(rsock)
        names = _rank(0, ["dict-a", "dict-b"])
        pname, rname = names
        members = [fleet.Member(name=pname, component="dict", address=psock, pid=child.pid),
                   fleet.Member(name=rname, component="dict", address=rsock, pid=os.getpid())]
        live = {m.name: {"up": True, "stale": False} for m in members}
        pc = PlacementController(lambda: members, lambda: dict(live), shards=1, replicas=1)
        t0 = time.perf_counter()
        if not pc.tick():
            raise AssertionError("the first placement tick changed nothing")
        seat = pc.map()["assignments"][0]
        if seat["primary"]["address"] != psock or agent.role != "replica":
            raise AssertionError(f"placement {seat}; the replica's role {agent.role}")
        rsd = None
        while True:  # catch-up from zero
            sd = repl._dicts.get(HA_NS)
            if sd is not None and len(sd.records.bootstrap.chunks) >= total:
                rsd = sd
                break
            if time.perf_counter() - t0 > 120:
                raise AssertionError(f"the replica did not catch up: {agent.status()}")
            time.sleep(0.01)
        t_catch = time.perf_counter() - t0
        tail = agent.tailer.status()
        budget = tail["budget_bytes"]
        if tail["max_pull_bytes"] > budget + 4096:  # a pull's non-chunk slack
            raise AssertionError(f"a pull of {tail['max_pull_bytes']} bytes over the "
                                 f"{budget}-byte budget")
        restages_catch = rsd.index.restages
        with tempfile.TemporaryDirectory() as d:
            pcli.save(str(Path(d) / "p.boot"), HA_NS)
            rsd.records.save(str(Path(d) / "r.boot"))
            if (Path(d) / "p.boot").read_bytes() != (Path(d) / "r.boot").read_bytes():
                raise AssertionError("the replica's record tables differ from the primary's")
        q_bytes = [row.astype(">u4").tobytes() for row in q_all]  # K2's words -> digests
        t0 = time.perf_counter()
        want = pcli.probe(q_bytes, HA_NS)
        p_probe_ms = 1e3 * (time.perf_counter() - t0)
        probe.launches = 0
        t0 = time.perf_counter()
        got = rsd.probe(b"".join(q_bytes))
        r_probe_ms = 1e3 * (time.perf_counter() - t0)
        replica_k3 = probe.launches
        if replica_k3 != 1 or not np.array_equal(got, want):
            raise AssertionError(f"replica probe: {replica_k3} K3 launches, answers equal "
                                 f"{np.array_equal(got, want)}")
        hits = int((want >= 0).sum())
        if hits != len(q_all):  # phase 2's layer is in the namespace: every query hits
            raise AssertionError(f"{hits} of {len(q_all)} of phase 5's queries hit")
        log(f"[16] replica (in process, {dev}): caught up from zero in {t_catch:.3f} s over "
            f"{tail['pulls']} pulls (budget {budget} bytes, largest pull {tail['max_pull_bytes']} "
            f"bytes), {restages_catch} restages during catch-up; record tables == the primary's "
            f"(saved bootstrap, {total} records); phase 5's {len(q_all)} queries: primary RPC "
            f"{p_probe_ms:.1f} ms, replica lookup {r_probe_ms:.1f} ms (first probe: restage + "
            f"K3, {replica_k3} launch), answers identical ({hits} hits)")

        # -- the failover batch ------------------------------------------------
        img = image_members(files)
        low = [named_tar(m) for m in img[4:6]]
        top, _gone, _opaque = image_b_top(img, FileGen(SEED + 16), "text")
        images = [("A", low), ("B", [low[0], top])]
        in_bytes = sum(len(t) for _n, ts in images for t in ts)
        opt = PackOption(backend="fused", chunk_size=CHUNK_SIZE, compressor="none")
        oracle.run(osock)
        t0 = time.perf_counter()
        obc = batch.BatchConverter(opt, dict_service=osock, namespace=HA_BATCH_NS, device=dev)
        try:
            want_imgs = [obc.convert_image(n, ts) for n, ts in images]
        finally:
            obc.dict.close()
        t_oracle = time.perf_counter() - t0
        for k in kernels.values():
            k.launches = 0
        hbc = batch.BatchConverter(opt, dict_service=f"service://{psock}|{rsock}",
                                   namespace=HA_BATCH_NS, device=dev)
        try:
            got_imgs = [hbc.convert_image(*images[0])]
            first_launches = {key: k.launches for key, k in kernels.items()}
            reg = agent.tailer.status()["namespaces"][HA_NS]
            if reg["resyncs"] or len(rsd.records.bootstrap.chunks) != total:
                raise AssertionError(f"the replica's {HA_NS!r} namespace before the kill: {reg}")
            child.send_signal(signal.SIGKILL)
            child.wait(timeout=30)
            t_kill = time.perf_counter()
            live[pname] = {"up": False, "stale": True}
            pc.report_down(pname, source="chip_smoke")
            if not pc.tick() or not agent.is_primary():
                raise AssertionError(f"no promotion: {pc.map()}")
            t_promoted = time.perf_counter()
            if len(repl.dict_for(HA_NS).records.bootstrap.chunks) != total:
                raise AssertionError("the promoted replica lost records of the namespace")
            hbc.dict.sync()  # the dead primary fails the RPC: failover + repair
            t_failover = time.perf_counter()
            if hbc.dict.client.sock_path != rsock:
                raise AssertionError("the mirror did not fail over to the promoted replica")
            got_imgs.append(hbc.convert_image(*images[1]))
            t_acked = time.perf_counter()
        finally:
            hbc.dict.close()
        batch_launches = {key: k.launches for key, k in kernels.items()}
        for g, w in zip(got_imgs, want_imgs):
            if (g.bootstrap, g.blob_digests, g.layer_blobs) != (w.bootstrap, w.blob_digests,
                                                                w.layer_blobs):
                raise AssertionError(f"image {g.name}: the failover batch differs from the oracle")
        n_layers = sum(len(ts) for _n, ts in images)
        if batch_launches["gear"] != n_layers or batch_launches["sha"] != n_layers:
            raise AssertionError(f"the failover batch launched {batch_launches}")
        probe.launches = 0
        rcli = DictClient(rsock)
        again = rcli.probe(q_bytes, HA_NS)
        promoted_k3 = probe.launches
        rcli.close()
        if promoted_k3 != 1 or not np.array_equal(again, want):
            raise AssertionError(f"the promoted replica's probe RPC: {promoted_k3} K3 launches")
        ev = pc.map()["events"][-1]
        log(f"[16] failover batch: 2 images, {n_layers} layers, {in_bytes} bytes of tar; oracle "
            f"(one DictService) {t_oracle:.1f} s; through service://primary|replica: image A, "
            f"SIGKILL of the primary child, report_down + tick promoted {ev['to']} "
            f"(applied_chunks {ev['applied_chunks']}) {1e3 * (t_promoted - t_kill):.1f} ms after "
            f"the kill, the mirror failed over {1e3 * (t_failover - t_kill):.1f} ms after it, "
            f"image B's merge acknowledged {t_acked - t_kill:.2f} s after it; every blob and "
            f"bootstrap == the oracle's; launches {batch_launches} (image A {first_launches}); "
            f"the promoted replica's probe RPC: {promoted_k3} K3 launch, answers == before")
        out = {
            "records": total, "synthetic_records": HA_SYNTH_CHUNKS, "catch_up_s": t_catch,
            "pulls": tail["pulls"], "max_pull_bytes": tail["max_pull_bytes"],
            "budget_bytes": budget, "restages_during_catch_up": restages_catch,
            "primary_probe_rpc_ms": p_probe_ms, "replica_probe_ms": r_probe_ms,
            "replica_probe_launches": replica_k3, "promoted_probe_launches": promoted_k3,
            "kill_to_promoted_ms": 1e3 * (t_promoted - t_kill),
            "kill_to_failover_ms": 1e3 * (t_failover - t_kill),
            "kill_to_first_merge_acked_s": t_acked - t_kill,
            "batch_launches": batch_launches, "batch_input_bytes": in_bytes,
            "oracle_batch_s": t_oracle,
        }
    finally:
        if child.poll() is None:
            child.kill()
        child.wait(timeout=30)
        child_log.close()
        if agent.tailer is not None:
            agent.tailer.stop()
        repl.stop()
        oracle.stop()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[16] {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 17: OCIRef layers
# ---------------------------------------------------------------------------

OCIREF_READS = 64
OCIREF_GZIP_MEMBERS = 8  # the tar compressed as concatenated gzip members, in parallel
OCIREF_HOOK_LAYER_MIB = 2


def gzip_members(tar: bytes) -> bytes:
    """The tar as ``OCIREF_GZIP_MEMBERS`` concatenated gzip members (level 1),
    compressed in parallel."""
    import gzip
    from concurrent.futures import ThreadPoolExecutor

    step = -(-len(tar) // OCIREF_GZIP_MEMBERS)
    with ThreadPoolExecutor(OCIREF_GZIP_MEMBERS) as pool:
        return b"".join(pool.map(lambda i: gzip.compress(tar[i:i + step], compresslevel=1, mtime=0),
                                 range(0, len(tar), step)))


def ociref_phase(dev, tar, kernels) -> dict:
    """Phase 17: the OCIRef conversion of phase 4's tar as gzip and zstd
    layers on the card's digest kernels, lazy reads, Unpack, and the
    image-converter hooks over a content store."""
    import gzip
    import json as json_mod
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from nydus_snapshotter_tpu_torch.converter import MergeOption, PackOption, Unpack, hooks
    from nydus_snapshotter_tpu_torch.converter import content, convert, zran, zstd_ref
    from nydus_snapshotter_tpu_torch.models import fstree
    from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine
    from nydus_snapshotter_tpu_torch.remote.registry import Descriptor
    from nydus_snapshotter_tpu_torch.utils import zstd

    t_phase = time.perf_counter()
    if not zstd.frames_available():
        raise AssertionError("the system libzstd lacks the frame surface (zstd OCIRef layers)")

    def counted(fn):
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, {key: k.launches for key, k in kernels.items()}

    # -- the compressed layers: gzip level 1 in parallel members, zstd -3 ----
    t0 = time.perf_counter()
    step = -(-len(tar) // OCIREF_GZIP_MEMBERS)
    with ThreadPoolExecutor(OCIREF_GZIP_MEMBERS + 1) as pool:
        zs_f = pool.submit(zstd.compress_block, tar, 3)
        parts = list(pool.map(lambda i: gzip.compress(tar[i:i + step], compresslevel=1, mtime=0),
                              range(0, len(tar), step)))
        zs = zs_f.result()
    gz = b"".join(parts)
    t_comp = time.perf_counter() - t0
    log(f"[17] layers: phase 4's {len(tar)} byte tar -> gzip level 1 in {len(parts)} members "
        f"{len(gz)} bytes, zstd -3 {len(zs)} bytes, in {t_comp:.2f} s (threads)")

    # -- ref packs: the host path and the device engine, SHA-256 and BLAKE3 --
    packs, rows = {}, []
    for fmt, raw, pack_fn in (("gzip", gz, zran.pack_gzip_layer),
                              ("zstd", zs, zstd_ref.pack_zstd_layer)):
        for digester in ("sha256", "blake3"):
            opt = PackOption(oci_ref=True, chunk_size=CHUNK_SIZE, digester=digester)
            # the host path inflates the layer itself once; the rest hand the tar over
            kw = {} if digester == "sha256" else {"tar_bytes": tar}
            host, host_s, host_l = counted(lambda: pack_fn(raw, opt, **kw))
            eng = ChunkDigestEngine(chunk_size=CHUNK_SIZE, backend="jax", digest_backend="jax",
                                    digester=digester, device=dev)
            dbs, dev_s, dev_l = counted(lambda: pack_fn(raw, opt, engine=eng, tar_bytes=tar))
            if any(host_l.values()):
                raise AssertionError(f"the host {fmt} ref pack launched {host_l}")
            want_l = ({"sha"} if digester == "sha256" else {"b3_leaves", "b3_parents"})
            if {k for k, n in dev_l.items() if n} != want_l:
                raise AssertionError(f"the device {fmt}/{digester} ref pack launched {dev_l}")
            if dbs.to_bytes() != host.to_bytes():
                raise AssertionError(f"{fmt}/{digester}: the device engine's bootstrap differs")
            packs[(fmt, digester)] = host
            rows.append(f"{fmt}/{digester} host {host_s:.2f} s, device {dev_s:.2f} s "
                        f"({', '.join(f'{k} {n}' for k, n in dev_l.items() if n)})")
            packs[(fmt, digester, "launches")] = dev_l
            packs[(fmt, digester, "s")] = (host_s, dev_s)
    bs_gz, bs_zs = packs[("gzip", "sha256")], packs[("zstd", "sha256")]
    log(f"[17] ref packs ({len(bs_gz.chunks)} chunks of {len(bs_gz.inodes)} inodes; the "
        f"device engine's bootstraps == the host path's): " + "; ".join(rows))

    # -- lazy reads: 64 seeded random files through each reader --------------
    regs = [i for i in bs_gz.inodes if i.chunk_count]
    pick = np.random.default_rng(SEED + 17).choice(len(regs), OCIREF_READS, replace=False)

    def file_reads(bs, raw, order):
        reader = convert.BlobReader(bs, 0, lambda o, s: raw[o:o + s])
        by_path = bs.inode_by_path()
        n = 0
        for k in order:
            ino = by_path[regs[k].path]
            recs = bs.chunks[ino.chunk_index:ino.chunk_index + ino.chunk_count]
            got = b"".join(reader.chunk_data(c) for c in recs)
            lo = recs[0].uncompressed_offset
            if got != tar[lo:lo + ino.size]:
                raise AssertionError(f"{ino.path}: the ref read differs from the tar's bytes")
            n += len(recs)
        return n

    t0 = time.perf_counter()
    n_gz = file_reads(bs_gz, gz, pick)  # random order: the gzip checkpoints
    t_gz = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_zs = file_reads(bs_zs, zs, sorted(pick, key=lambda k: bs_gz.chunks[regs[k].chunk_index]
                                        .uncompressed_offset))
    t_zs = time.perf_counter() - t0
    log(f"[17] reads: seeded random files == the tar's bytes: {OCIREF_READS} through the gzip "
        f"checkpoints, random order, {n_gz} chunks in {t_gz:.2f} s; the same {OCIREF_READS} "
        f"through the zstd sequential cursor, ascending offsets, {n_zs} chunks in {t_zs:.2f} s")

    # -- Unpack of the whole gzip ref layer --------------------------------------
    def tree(tar_bytes):
        with tarfile.open(fileobj=io.BytesIO(tar_bytes)) as tf:
            return {fstree.norm_path(m.name): tf.extractfile(m).read() if m.isreg() else m.linkname
                    for m in tf if m.isreg() or m.issym()}

    t0 = time.perf_counter()
    out = Unpack(bs_gz, {bs_gz.blobs[0].blob_id: gz})
    t_unpack = time.perf_counter() - t0
    want = tree(tar)
    if tree(out) != want:
        raise AssertionError("Unpack of the gzip ref layer differs from the tar's tree")
    del out
    log(f"[17] Unpack of the gzip ref layer ({len(want)} files and links, {len(tar)} bytes of "
        f"tar, {len(bs_gz.chunks)} chunks; stream chunks in ascending offset order) == the "
        f"tar's tree in {t_unpack:.2f} s")

    # -- hooks: a three-layer gzip OCI image, packed and oci_ref ----------------
    gen = FileGen(SEED + 171)
    layers = [named_tar([(f"l{li}/f{fi}.bin", f) for fi, f in enumerate(gen.pool(OCIREF_HOOK_LAYER_MIB))])
              for li in range(3)]
    hook_rows = {}

    def publish(cs):
        """The image in ``cs`` -> (manifest descriptor, layer descriptors)."""
        descs = []
        for lt in layers:
            info = cs.write_blob(gzip.compress(lt, compresslevel=1, mtime=0))
            descs.append({"mediaType": "application/vnd.oci.image.layer.v1.tar+gzip",
                          "digest": info.digest, "size": info.size})
        cfg = cs.write_blob(json_mod.dumps({"architecture": "amd64", "os": "linux",
                                            "rootfs": {"type": "layers", "diff_ids": []}}).encode())
        man = cs.write_blob(json_mod.dumps({
            "schemaVersion": 2, "mediaType": "application/vnd.oci.image.manifest.v1+json",
            "config": {"mediaType": "application/vnd.oci.image.config.v1+json",
                       "digest": cfg.digest, "size": cfg.size},
            "layers": descs}).encode())
        return Descriptor("application/vnd.oci.image.manifest.v1+json", man.digest, man.size), descs

    # each arm in a store of its own: the conversion-cache label would
    # otherwise answer the second arm with the first one's blobs
    for arm, popt in (("packed", PackOption(backend="fused", chunk_size=CHUNK_SIZE)),
                      ("oci_ref", PackOption(oci_ref=True, chunk_size=CHUNK_SIZE))):
        with tempfile.TemporaryDirectory() as d:
            cs = content.LocalContentStore(d)
            man_desc, descs = publish(cs)
            new, hook_s, hook_l = counted(lambda: hooks.convert_image(
                cs, man_desc, popt, MergeOption(oci=True), device=dev))
            manifest = json_mod.loads(cs.read(new.digest))
            if not hooks.is_nydus_image(manifest) or len(manifest["layers"]) != 4:
                raise AssertionError(f"hooks {arm}: not a four-layer nydus manifest")
            config = json_mod.loads(cs.read(manifest["config"]["digest"]))
            if len(config["rootfs"]["diff_ids"]) != 4:
                raise AssertionError(f"hooks {arm}: {config['rootfs']['diff_ids']}")
            boot = convert.bootstrap_from_bootstrap_layer(
                gzip.decompress(cs.read(manifest["layers"][-1]["digest"])))
            provider = {}
            for lj, src in zip(manifest["layers"][:-1], descs):
                if arm == "oci_ref":  # the original gzip layer is the data
                    provider[src["digest"].split(":")[1]] = cs.read(src["digest"])
                else:
                    stream = cs.read(lj["digest"])
                    for b in convert.bootstrap_from_layer_blob(stream).blobs:
                        provider[b.blob_id] = convert.blob_data_from_layer_blob(stream)
            by_path = boot.inode_by_path()
            for li, lt in enumerate(layers):
                with tarfile.open(fileobj=io.BytesIO(lt)) as tf:
                    members = [m for m in tf if m.isreg()]
                m = members[len(members) // 2]  # one file of each layer, read back
                ino = by_path[fstree.norm_path(m.name)]
                recs = boot.chunks[ino.chunk_index:ino.chunk_index + ino.chunk_count]
                data = provider[boot.blobs[recs[0].blob_index].blob_id]
                reader = convert.BlobReader(boot, recs[0].blob_index, lambda o, s: data[o:o + s])
                if b"".join(reader.chunk_data(c) for c in recs) != lt[m.offset_data:m.offset_data + m.size]:
                    raise AssertionError(f"hooks {arm}: layer {li} does not read back")
            # oci_ref: K2 digests each layer's index (on the host under a
            # CPU rehearsal, as hooks do for device="cpu")
            want_l = ({"gear": 3, "sha": 3} if arm == "packed"
                      else {"sha": 3} if dev.type == "cuda" else {})
            if {k: n for k, n in hook_l.items() if n} != want_l:
                raise AssertionError(f"hooks {arm} launched {hook_l}; want {want_l}")
            hook_rows[arm] = {"s": hook_s, "launches": hook_l, "manifest": new.digest}
            log(f"[17] hooks.convert_image ({arm}): 3 gzip layers of {OCIREF_HOOK_LAYER_MIB} MiB "
                f"-> {new.digest[:19]}.., a four-layer nydus manifest with its config; a file of "
                f"each layer read back; {hook_s:.2f} s, launches "
                + (", ".join(f"{k} {n}" for k, n in hook_l.items() if n) or "none"))
    out_d = {
        "gzip_bytes": len(gz), "zstd_bytes": len(zs), "compress_s": t_comp,
        "chunks": len(bs_gz.chunks),
        "packs": {f"{f}/{g}": {"host_s": packs[(f, g, "s")][0], "device_s": packs[(f, g, "s")][1],
                               "launches": packs[(f, g, "launches")]}
                  for f in ("gzip", "zstd") for g in ("sha256", "blake3")},
        "reads": {"gzip_files": OCIREF_READS, "gzip_chunks": n_gz, "gzip_s": t_gz,
                  "zstd_files": OCIREF_READS, "zstd_chunks": n_zs, "zstd_s": t_zs},
        "unpack": {"files": len(want), "tar_bytes": len(tar), "s": t_unpack},
        "hooks": hook_rows,
    }
    out_d["phase_s"] = time.perf_counter() - t_phase
    log(f"[17] {out_d['phase_s']:.1f} s")
    return out_d


CONVERT_CORPUS_MIB = 256  # phase 18's resonant, incompressible and compressible layers
CONVERT_HUGE_MIB = 1024  # its single-file layer
CONVERT_TINY_FILES = 100_000
CONVERT_EPOCHS = (0, 8, 16, 24)  # drift epochs of tree 1 fed to `batch`


def convert_phase(dev, tar, kernels) -> dict:
    """Phase 18: the converter CLI in process and as a process, tar-tarfs
    and the exports, the scenario corpora on the fused lane against the
    hybrid lane, real-vs-real cross-tree dedup, and image evolution
    through ``batch``."""
    import contextlib
    import os
    import tempfile

    from nydus_snapshotter_tpu_torch.cmd import convert as cli
    from nydus_snapshotter_tpu_torch.converter import PackOption, convert, feature, pack_layer
    from nydus_snapshotter_tpu_torch.converter import codec as codec_mod
    from nydus_snapshotter_tpu_torch.models import erofs_image, fstree, nydus_real
    from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap
    from nydus_snapshotter_tpu_torch.ops.cdc import CDCParams
    from nydus_snapshotter_tpu_torch.ops import fused_convert
    from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine
    from nydus_snapshotter_tpu_torch.scenario import corpus, evolution
    from nydus_snapshotter_tpu_torch.scenario import spec as scenario_spec
    from nydus_snapshotter_tpu_torch.tarfs import tarfs_bootstrap_from_tar

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    # no --device: the card (the CLI's default); a CPU rehearsal asks for the CPU
    dev_args = [] if dev.type == "cuda" else ["--device", "cpu"]
    feats = feature.detect_features(force=True, device=None if dev.type == "cuda" else "cpu")
    if not feats.contains(feature.Feature.DEVICE_DIGEST):
        raise AssertionError("detect_features: no DEVICE_DIGEST with the card present")
    sha_l = {"gear": 1, "sha": 1}
    b3_l = {"gear": 1, "b3_leaves": 1, "b3_parents": 1}

    def counted(fn):
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, {key: k.launches for key, k in kernels.items() if k.launches}

    def run_cli(*argv, want=None):
        """``main(argv)`` in process -> (its one stdout line, s, launches)."""
        out = io.StringIO()

        def call():
            with contextlib.redirect_stdout(out):
                return cli.main([*dev_args, *argv])

        rc, s, launched = counted(call)
        lines = out.getvalue().splitlines()
        if rc != 0 or len(lines) != 1:
            raise AssertionError(f"ntpu-convert {argv[0]}: rc {rc}, stdout {lines}")
        if want is not None and launched != want:
            raise AssertionError(f"ntpu-convert {' '.join(argv[:3])} launched {launched}; want {want}")
        return lines[0], s, launched

    def tree(tar_bytes):
        with tarfile.open(fileobj=io.BytesIO(tar_bytes)) as tf:
            return {fstree.norm_path(m.name): tf.extractfile(m).read() if m.isreg() else m.linkname
                    for m in tf if m.isreg() or m.issym()}

    def fmt_l(launched):
        return ", ".join(f"{k} {n}" for k, n in launched.items()) or "none"

    out_d = {"features": sorted(f.name for f in feats)}
    with tempfile.TemporaryDirectory() as work:
        w = Path(work)
        src = w / "layer.tar"
        src.write_bytes(tar)

        # -- (a) CLI packs at the CLI defaults: 1 MiB CDC, lz4_block, v6 ----------
        packs = {}
        for name, extra, want in (("fused", ["--backend", "fused"], sha_l), ("hybrid", [], {}),
                                  ("fused_blake3", ["--backend", "fused", "--digester", "blake3"], b3_l),
                                  ("hybrid_blake3", ["--digester", "blake3"], {})):
            line, s, launched = run_cli("pack", "--in", str(src), "--out", str(w / f"{name}.nydus"), *extra,
                                        want=want)
            packs[name] = {"line": line, "s": s, "launches": launched}
        for a, b in (("fused", "hybrid"), ("fused_blake3", "hybrid_blake3")):
            if (w / f"{a}.nydus").read_bytes() != (w / f"{b}.nydus").read_bytes() \
                    or packs[a]["line"] != packs[b]["line"]:
                raise AssertionError(f"ntpu-convert pack: {a} differs from {b}")
        blob_id = json.loads(packs["fused"]["line"])["blob_id"]
        log(f"[18] features {out_d['features']}; CLI pack of phase 4's {len(tar)} byte tar at the "
            "defaults (1 MiB CDC, lz4_block, v6), in process: " + "; ".join(
                f"{n} {p['s']:.2f} s ({fmt_l(p['launches'])})" for n, p in packs.items())
            + "; fused == hybrid byte for byte, at SHA-256 and at BLAKE3")

        # -- (b) the other verbs on (a)'s output ---------------------------------
        verbs = {}
        line, verbs["merge"], _ = run_cli("merge", str(w / "fused.nydus"), "--out", str(w / "image.boot"),
                                          want={})
        if json.loads(line)["blob_digests"] != [blob_id]:
            raise AssertionError(f"merge: {line}")
        line, verbs["check"], _ = run_cli("check", "--boot", str(w / "image.boot"), want={})
        info = json.loads(line)
        if info["version"] != "v6" or info["blobs"] != [blob_id]:
            raise AssertionError(f"check: {line[:300]}")
        want_tree = tree(tar)
        prefix = "/layer0/d5"
        line, verbs["inspect"], _ = run_cli("inspect", "--boot", str(w / "image.boot"), "--prefix", prefix,
                                            want={})
        want_paths = sorted([prefix] + [p for p in want_tree if p.startswith(prefix + "/")])
        if json.loads(line)["paths"] != want_paths:
            raise AssertionError("inspect --prefix: the listing differs from the tar's")
        (w / "blobs").mkdir()
        (w / "blobs" / blob_id).write_bytes(convert.blob_data_from_layer_blob((w / "fused.nydus").read_bytes()))
        line, verbs["unpack"], _ = run_cli("unpack", "--boot", str(w / "image.boot"), "--blob-dir",
                                           str(w / "blobs"), "--out", str(w / "out.tar"), want={})
        if tree((w / "out.tar").read_bytes()) != want_tree:
            raise AssertionError("unpack: the tar's members differ from the source's")
        log(f"[18] merge {verbs['merge']:.2f} s, check {verbs['check']:.2f} s, inspect --prefix "
            f"{verbs['inspect']:.2f} s ({len(want_paths)} paths), unpack {verbs['unpack']:.2f} s: "
            f"{info['inodes']} inodes, {info['chunks']} chunks; every member of the unpacked tar == "
            f"the source's ({len(want_tree)} files and links); no launch")

        # -- (c) tar-tarfs on the card's engine, then the exports ----------------
        tar_id = hashlib.sha256(tar).hexdigest()
        eng = ChunkDigestEngine(chunk_size=CHUNK_SIZE, backend="jax", digest_backend="jax", device=dev)
        tbs, tarfs_s, tarfs_l = counted(lambda: tarfs_bootstrap_from_tar(io.BytesIO(tar), tar_id, engine=eng))
        if tarfs_l != {"sha": 1}:
            raise AssertionError(f"tar-tarfs launched {tarfs_l}; want K2 once")
        for c in tbs.chunks:
            o, n = c.uncompressed_offset, c.uncompressed_size
            if c.digest != hashlib.sha256(tar[o:o + n]).digest():
                raise AssertionError(f"tar-tarfs: the digest of region {o}+{n} differs from hashlib")
        if tbs.to_bytes() != tarfs_bootstrap_from_tar(io.BytesIO(tar), tar_id).to_bytes():
            raise AssertionError("tar-tarfs: the engine's bootstrap differs from the host route's")
        (w / "tarfs.boot").write_bytes(tbs.to_bytes())
        (w / "tars").mkdir()
        (w / "tars" / tar_id).write_bytes(tar)
        line, erofs_s, _ = run_cli("export-erofs", "--boot", str(w / "tarfs.boot"), "--tar-dir",
                                   str(w / "tars"), "--out", str(w / "disk.erofs"), want={})
        disk = (w / "disk.erofs").read_bytes()
        base = disk.find(tar[:1 << 16])
        if (len(disk) != json.loads(line)["image_bytes"] or base <= 0 or base % 512
                or int.from_bytes(disk[1024:1028], "little") != erofs_image.EROFS_MAGIC
                or disk[base:base + len(tar)] != tar):
            raise AssertionError("export-erofs: not an EROFS disk holding the tar")
        line, real_s, _ = run_cli("export-real", "--boot", str(w / "tarfs.boot"), "--out",
                                  str(w / "real.v6"), "--format", "v6", want={})
        real = nydus_real.load_any_bootstrap((w / "real.v6").read_bytes())
        if real.version != "v6" or [c.digest for c in real.chunks] != [c.digest for c in tbs.chunks]:
            raise AssertionError("export-real v6: the real bootstrap's chunks differ")
        del disk
        out_d["tarfs"] = {"chunks": len(tbs.chunks), "s": tarfs_s, "launches": tarfs_l,
                          "export_erofs_s": erofs_s, "export_real_s": real_s}
        log(f"[18] tar-tarfs: {len(tbs.chunks)} regions of <= 4 MiB digested on the card in "
            f"{tarfs_s:.2f} s ({fmt_l(tarfs_l)}), == hashlib and == the host route's bootstrap; "
            f"export-erofs {erofs_s:.2f} s (an EROFS disk with the tar at byte {base}), export-real "
            f"v6 {real_s:.2f} s (the real layout reads back with the same digests)")

        # -- (d) the process contract ---------------------------------------------
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = str(root)
        cmd = [sys.executable, "-m", "nydus_snapshotter_tpu_torch.cmd.convert", *dev_args]
        (w / "bad.boot").write_bytes(np.random.default_rng(SEED + 18).integers(
            0, 256, 4096, dtype=np.uint8).tobytes())
        # the two processes side by side: each pays the interpreter and torch
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd + argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  cwd=str(root), env=env)
                 for argv in (["pack", "--backend", "fused", "--in", str(src), "--out", str(w / "proc.nydus")],
                              ["check", "--boot", str(w / "bad.boot")])]
        try:
            (p_out, p_err), (b_out, b_err) = (p.communicate(timeout=600) for p in procs)
        finally:
            for p in procs:
                p.kill()
                p.wait()
        proc_s = time.perf_counter() - t0
        proc, bad = procs
        if proc.returncode != 0 or p_out != packs["fused"]["line"] + "\n" \
                or (w / "proc.nydus").read_bytes() != (w / "fused.nydus").read_bytes():
            raise AssertionError(f"the CLI process: rc {proc.returncode}, {p_out[:200]!r}, {p_err[-400:]!r}")
        if bad.returncode != 1 or b_out or b_err.count("\n") != 1 or not b_err.startswith("ntpu-convert:"):
            raise AssertionError(f"bad input: rc {bad.returncode}, {b_out!r}, {b_err[-400:]!r}")
        out_d["process"] = {"pack_s": proc_s}
        log(f"[18] python -m nydus_snapshotter_tpu_torch.cmd.convert pack --backend fused: rc 0, one "
            f"JSON line and the blob == (a)'s; beside it check of 4096 random bytes: rc 1, one stderr "
            f"line: {b_err.strip()[:120]}; both done in {proc_s:.2f} s (interpreter, torch, CUDA "
            "context and the pack)")
    out_d["cli"] = {"packs": packs, "verbs_s": verbs}
    del src

    # -- (e) the corpora: fused against hybrid, 64 KiB chunks ---------------------
    params = CDCParams(CHUNK_SIZE)

    def lanes(name, layer, check=None, fused_want=sha_l, **opt_kw):
        got, rows = {}, []
        for lane in ("fused", "hybrid"):
            codec = codec_mod.AdaptiveCodec(codec_mod.CodecConfig(adaptive=True)) if "compressor" in opt_kw \
                else None
            st = {}
            (blob, res), s, launched = counted(lambda: pack_layer(
                layer, PackOption(backend=lane, chunk_size=CHUNK_SIZE, **opt_kw), device=dev, stats=st,
                codec=codec))
            if launched != (fused_want if lane == "fused" else {}):
                raise AssertionError(f"{name} {lane} launched {launched}")
            got[lane] = (blob, res, codec)
            rows.append(f"{lane} {s:.2f} s, route {res.route['lane']}/{res.route['writer']}, "
                        f"{fmt_stats(st)}, launches {fmt_l(launched)}")
            got[lane + "_row"] = {"s": s, "route": dict(res.route), "stats": dict(st), "launches": launched}
        (bf, rf, cf), (bh, rh, ch) = got["fused"], got["hybrid"]
        if bf != bh or rf.bootstrap != rh.bootstrap or rf.blob_id != rh.blob_id:
            raise AssertionError(f"{name}: the fused pack differs from the hybrid pack")
        bs = Bootstrap.from_bytes(rf.bootstrap)
        extra = check(bs, cf) if check else ""
        log(f"[18] {name}: {len(layer)} byte tar, {len(bs.chunks)} chunks, blob {len(bf)} bytes; fused == "
            f"hybrid byte for byte{extra}; " + "; ".join(rows))
        return {"tar_bytes": len(layer), "chunks": len(bs.chunks), "blob_bytes": len(bf),
                "fused": got["fused_row"], "hybrid": got["hybrid_row"]}

    def every_chunk(size):
        def check(bs, _codec):
            n = 0
            for ino in bs.inodes:
                sizes = [c.uncompressed_size for c in bs.chunks[ino.chunk_index:ino.chunk_index + ino.chunk_count]]
                if sizes and (any(x != size for x in sizes[:-1]) or not 0 < sizes[-1] <= size):
                    raise AssertionError(f"{ino.path}: chunk sizes {sorted(set(sizes))}, want {size}")
                n += len(sizes)
            return f"; all {n} chunks of each file but its last are {size} bytes"
        return check

    def bypass(engaged):
        def check(_bs, codec):
            counts = codec.stats()["counts"]
            if (counts["bypass"] > 0) != engaged:
                raise AssertionError(f"adaptive codec classes {counts}; bypass engaged should be {engaged}")
            return f"; codec classes {counts} (bypass {'engaged' if engaged else 'not engaged'})"
        return check

    def overflow(mode):
        """The full-path engine alone on the resonant file: its candidate
        compaction's overflow message, or "" (then no windowed fallback)."""
        data = corpus.cdc_resonant_data(SEED, CONVERT_CORPUS_MIB << 20, CHUNK_SIZE, mode)
        try:
            fused_convert.FusedDeviceEngine(chunk_size=CHUNK_SIZE, device=dev).process_many([data])
        except fused_convert.FusedOverflow as e:
            return str(e)
        return ""

    corpora = {}
    t0 = time.perf_counter()
    for mode, size in (("min", params.min_size), ("max", params.max_size)):
        # A layer whose candidates overflow the compaction's capacity (4x the
        # expected density, the reference's) takes the windowed lane on the
        # card: K1 again, once per file, and K2 once.
        why = overflow(mode)
        layer = corpus.cdc_resonant_layer(SEED, CONVERT_CORPUS_MIB, CHUNK_SIZE, mode)
        corpora[f"resonant_{mode}"] = lanes(
            f"cdc_resonant {mode} (fused fallback: {why or 'none'})", layer, every_chunk(size),
            fused_want={"gear": 2, "sha": 1} if why else sha_l)
        corpora[f"resonant_{mode}"]["fused_overflow"] = why
    layer = corpus.single_huge_file_layer(SEED, CONVERT_HUGE_MIB)
    corpora["single_huge_file"] = lanes("single_huge_file", layer)
    layer = corpus.tiny_files_layer(SEED, CONVERT_TINY_FILES)
    corpora["tiny_files"] = lanes("tiny_files", layer)
    layer = corpus.incompressible_layer(SEED, CONVERT_CORPUS_MIB)
    corpora["incompressible"] = lanes("incompressible, adaptive zstd", layer, bypass(True), compressor="zstd")
    layer = corpus.compressible_layer(SEED, CONVERT_CORPUS_MIB)
    corpora["compressible"] = lanes("compressible, adaptive zstd", layer, bypass(False), compressor="zstd")
    del layer
    corpora_s = time.perf_counter() - t0

    # -- (f) real-vs-real cross-tree dedup on the card ----------------------------
    fixed = dict(chunking="fixed")
    xf, xf_s, xf_l = counted(lambda: corpus.cross_tree_dedup(PackOption(backend="fused", **fixed), device=dev))
    xh, xh_s, xh_l = counted(lambda: corpus.cross_tree_dedup(PackOption(backend="hybrid", **fixed)))
    if xf != xh or xh_l or set(xf_l) != {"sha"}:
        raise AssertionError(f"cross_tree_dedup: fused {xf['dedup_ratio']} ({xf_l}), hybrid "
                             f"{xh['dedup_ratio']} ({xh_l})")
    log(f"[18] cross_tree_dedup (fixed 1 MiB chunks; tree 1 {xf['tree1_mib']} MiB through the real v6 "
        f"layout into a dict of {xf['dict_chunks']} chunks, tree 2 {xf['tree2_mib']} MiB against it): "
        f"ratio {xf['dedup_ratio']} on the card in {xf_s:.2f} s ({fmt_l(xf_l)}) == the hybrid lane's in "
        f"{xh_s:.2f} s")

    # -- (g) image evolution through `batch` ---------------------------------------
    soak = scenario_spec.load_spec(str(root / "misc" / "scenarios" / "soak.toml"))
    seed, drift = soak.seed, soak.soak.drift_rate
    manifest = corpus.load_manifest(corpus.MANIFEST_TREE1)
    shared = [evolution.shared_fraction(manifest, seed, drift, e) for e in CONVERT_EPOCHS]
    with tempfile.TemporaryDirectory() as work:
        w = Path(work)
        images = []
        for e in CONVERT_EPOCHS:
            images.append(str(w / f"epoch{e:02d}.tar"))
            Path(images[-1]).write_bytes(corpus.members_to_tar(evolution.evolved_members(manifest, seed, drift, e)))
        batch = {}
        for lane, want in (("fused", {"gear": len(images), "sha": len(images)}), ("hybrid", {})):
            line, s, launched = run_cli("batch", *images, "--out-dir", str(w / lane), "--dict-out",
                                        str(w / f"{lane}.dict"), "--backend", lane, want=want)
            batch[lane] = {"line": line, "s": s, "launches": launched}
        if batch["fused"]["line"] != batch["hybrid"]["line"] or any(
                (w / "fused" / f.name).read_bytes() != f.read_bytes() for f in (w / "hybrid").iterdir()) \
                or (w / "fused.dict").read_bytes() != (w / "hybrid.dict").read_bytes():
            raise AssertionError("batch: the fused lane's images or dict differ from the hybrid lane's")
    new = [img["new_chunks"] for img in json.loads(batch["fused"]["line"])["images"]]
    if new[0] <= 0 or any(not 0 <= n < new[0] for n in new[1:]):
        raise AssertionError(f"evolution: new chunks per epoch {new}")
    log(f"[18] evolution of tree 1 (soak.toml: seed {seed}, drift_rate {drift}) through `batch`, "
        f"growing dict: fused {batch['fused']['s']:.2f} s ({fmt_l(batch['fused']['launches'])}), hybrid "
        f"{batch['hybrid']['s']:.2f} s, images and dict byte-identical; epoch: new chunks / "
        "shared_fraction: " + ", ".join(f"{e}: {n} / {f:.4f}" for e, n, f in zip(CONVERT_EPOCHS, new, shared)))

    out_d.update({
        "corpora": corpora, "corpora_s": corpora_s,
        "cross_tree": {"ratio": xf["dedup_ratio"], "fused_s": xf_s, "hybrid_s": xh_s, "launches": xf_l},
        "evolution": {"epochs": list(CONVERT_EPOCHS), "new_chunks": new, "shared_fraction": shared,
                      "fused_s": batch["fused"]["s"], "hybrid_s": batch["hybrid"]["s"],
                      "launches": batch["fused"]["launches"]},
    })
    out_d["phase_s"] = time.perf_counter() - t_phase
    log(f"[18] {out_d['phase_s']:.1f} s")
    return out_d


# ---------------------------------------------------------------------------
# Phase 19: the registry read path and the tarfs manager
# ---------------------------------------------------------------------------

TARFS_L2_MIB = 32  # phase 19's gzip'd second layer
TARFS_L3_MIB = 8  # its gzip'd top layer (a whiteout and an opaque directory over L1's paths)
TARFS_REPO = "library/tarfs"


class OciRegistry:
    """A small in-process OCI distribution registry on 127.0.0.1: manifests
    by tag or digest, configs and blobs by digest, ``Range`` on blobs, the
    referrers API (``referrers``: subject digest -> manifest descriptors),
    no auth; every request counted."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.blobs: dict[str, bytes] = {}
        self.manifests: dict[str, bytes] = {}
        self.referrers: dict[str, list[dict]] = {}
        self.requests: list[str] = []
        reg = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, body: bytes, media: str = "", head: bool = False, status: int = 200,
                      extra: dict | None = None):
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Docker-Content-Digest", "sha256:" + hashlib.sha256(body).hexdigest())
                if media:
                    self.send_header("Content-Type", media)
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                if not head:
                    self.wfile.write(body)

            def _serve(self, head: bool):
                reg.requests.append(f"{self.command} {self.path}")
                if "/referrers/" in self.path:
                    subject = self.path.split("/referrers/")[-1].split("?")[0]
                    body = json.dumps({"schemaVersion": 2, "manifests": reg.referrers.get(subject, [])})
                    return self._send(body.encode(), "application/vnd.oci.image.index.v1+json", head)
                if "/manifests/" in self.path:
                    body = reg.manifests.get(self.path.rsplit("/", 1)[-1])
                    if body is not None:
                        return self._send(body, "application/vnd.oci.image.manifest.v1+json", head)
                elif "/blobs/" in self.path:
                    data = reg.blobs.get(self.path.rsplit("/", 1)[-1])
                    if data is not None:
                        rng = self.headers.get("Range")
                        if rng and rng.startswith("bytes="):
                            lo, hi = rng[6:].split("-")
                            lo, hi = int(lo), int(hi or len(data) - 1)
                            return self._send(data[lo:hi + 1], head=head, status=206, extra={
                                "Content-Range": f"bytes {lo}-{hi}/{len(data)}"})
                        return self._send(data, head=head)
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                self._serve(False)

            def do_HEAD(self):
                self._serve(True)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    @property
    def host(self) -> str:
        return f"127.0.0.1:{self.server.server_address[1]}"

    def add_blob(self, data: bytes) -> str:
        digest = "sha256:" + hashlib.sha256(data).hexdigest()
        self.blobs[digest] = data
        return digest

    def publish(self, tag: str, layers: list[tuple[bytes, str]],
                annotations: dict | None = None) -> tuple[str, list[str]]:
        """An image of ``(blob, diff_id)`` layers, bottom first, under
        ``tag`` -> (manifest digest, layer digests); ``annotations`` go on
        the manifest."""
        cfg = json.dumps({"architecture": "amd64", "os": "linux",
                          "rootfs": {"type": "layers", "diff_ids": [d for _b, d in layers]}}).encode()
        descs = [{"mediaType": "application/vnd.oci.image.layer.v1.tar" + ("+gzip" if b[:2] == b"\x1f\x8b" else ""),
                  "digest": self.add_blob(b), "size": len(b)} for b, _d in layers]
        body = json.dumps({"schemaVersion": 2, "mediaType": "application/vnd.oci.image.manifest.v1+json",
                           "config": {"mediaType": "application/vnd.oci.image.config.v1+json",
                                      "digest": self.add_blob(cfg), "size": len(cfg)},
                           "layers": descs, **({"annotations": annotations} if annotations else {})}).encode()
        mdigest = self.add_blob(body)
        self.manifests[tag] = self.manifests[mdigest] = body
        return mdigest, [d["digest"] for d in descs]

    def close(self):
        self.server.shutdown()
        self.server.server_close()


class LoopRecorder:
    """Stands in for the operating system's loop devices (``utils.losetup``'s
    ``backend`` seam, as the reference's tests replace it): records every
    attach and detach."""

    def __init__(self, losetup):
        self.losetup = losetup
        self.attached: dict[int, str] = {}
        self.log: list[tuple] = []
        self._next = 0

    def attach(self, blob_path, offset=0, ro=True):
        dev = self.losetup.LoopDevice(self._next)
        self.attached[self._next] = blob_path
        self.log.append(("attach", blob_path, offset, ro))
        self._next += 1
        return dev

    def detach(self, dev):
        self.log.append(("detach", dev.index))
        self.attached.pop(dev.index, None)


class MountRecorder:
    """Stands in for mount(2) (``utils.mount``'s ``backend`` seam)."""

    def __init__(self):
        self.mounts: dict[str, tuple[str, str, str]] = {}
        self.log: list[tuple] = []

    def mount(self, source, target, fstype, options=""):
        self.log.append(("mount", source, target, fstype, options))
        self.mounts[target] = (source, fstype, options)

    def umount(self, target, flags=0):
        self.log.append(("umount", target))
        self.mounts.pop(target, None)


def tarfs_layers(tar: bytes) -> list[tuple[bytes, bytes]]:
    """Phase 19's three layers, bottom first, as (blob, tar): phase 4's tar
    served plain; a gzip'd tar of ``TARFS_L2_MIB``; a gzip'd tar of
    ``TARFS_L3_MIB`` that whites out one of L1's files and makes one of its
    directories opaque (the directory entries precede the marker, as in a
    container engine's layer diff)."""
    import gzip

    gen = FileGen(SEED + 19)
    l2 = named_tar([(f"app/d{fi % 31}/g{fi}.bin", f) for fi, f in enumerate(gen.pool(TARFS_L2_MIB))])
    top = [(f"layer0/d7/n{fi}.bin", f) for fi, f in enumerate(gen.pool(TARFS_L3_MIB))]
    l3 = named_tar(top, ("layer0/", "layer0/d5/", "layer0/d5/.wh.f5.bin", "layer0/d7/",
                         "layer0/d7/.wh..wh..opq"))
    return [(tar, tar), (gzip.compress(l2, compresslevel=1, mtime=0), l2),
            (gzip.compress(l3, compresslevel=1, mtime=0), l3)]


@contextlib.contextmanager
def plain_http_remote(remote_mod):
    """``Remote`` speaks plain HTTP to the in-process registry, the way the
    reference's tests switch it (tests/test_tarfs.py's ``plain_http``)."""
    orig = remote_mod.Remote.__init__

    def patched(self, keychain=None, insecure=False):
        orig(self, keychain=keychain, insecure=insecure)
        self.with_plain_http = True

    remote_mod.Remote.__init__ = patched
    try:
        yield
    finally:
        remote_mod.Remote.__init__ = orig


def tarfs_manager_phase(dev, tar: bytes, kernels) -> dict:
    """Phase 19: pull a three-layer image from an in-process registry through
    the tarfs manager, every layer indexed on the card (K2 once per layer),
    held against a host-route manager; merge, export with dm-verity, mount
    with recorded loop and mount backends, and a wrong diff ID."""
    import gzip
    import logging
    import os
    import shutil
    import tempfile
    import threading

    from nydus_snapshotter_tpu_torch import constants as C
    from nydus_snapshotter_tpu_torch import tarfs
    from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap
    import torch

    from nydus_snapshotter_tpu_torch.ops import fused_convert, sha256_cuda
    from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine
    from nydus_snapshotter_tpu_torch.remote import remote as remote_mod
    from nydus_snapshotter_tpu_torch.tarfs import tarfs as manager_mod
    from nydus_snapshotter_tpu_torch.tarfs import verity
    from nydus_snapshotter_tpu_torch.utils import errdefs, losetup
    from nydus_snapshotter_tpu_torch.tensors import to_u32
    from nydus_snapshotter_tpu_torch.utils import mount as mount_utils

    t_phase = time.perf_counter()
    smi = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    layers = tarfs_layers(tar)
    reg = OciRegistry()
    mdigest, ldigests = reg.publish(
        "v1", [(blob, "sha256:" + hashlib.sha256(raw).hexdigest()) for blob, raw in layers])
    ref = f"{reg.host}/{TARFS_REPO}:v1"
    log(f"[19] image: {len(layers)} layers, blobs of "
        + ", ".join(f"{len(b)} bytes ({len(t)} as tar)" for b, t in layers)
        + f", made and published on {reg.host} in {time.perf_counter() - t0:.1f} s")
    sids = [str(len(layers) - i) for i in range(len(layers))]  # the bottom layer takes the highest id
    loops, mounts = LoopRecorder(losetup), MountRecorder()
    saved = (losetup.backend, mount_utils.backend)
    losetup.backend, mount_utils.backend = loops, mounts
    log("[19] loop devices and mount(2) are recorders here (utils.losetup / utils.mount "
        "backends replaced, as the reference's tests do): the disk image is real and verified, "
        "the index is built on the card")
    w = Path(tempfile.mkdtemp(prefix="ntpu-tarfs-"))
    try:
        with plain_http_remote(remote_mod):
            eng = ChunkDigestEngine(device=dev)
            calls, times = [], {}
            digest_many = eng.digest_many

            def timed_digest_many(datas):
                t = time.perf_counter()
                out = digest_many(datas)
                calls.append((threading.current_thread().name, len(datas), time.perf_counter() - t))
                return out

            eng.digest_many = timed_digest_many

            def manager(name: str, engine):
                mgr = tarfs.Manager(cache_dir_path=str(w / name / "cache"), validate_diff_id=True,
                                    export_mode="image_block_with_verity", engine=engine)
                gen = mgr._generate_bootstrap

                def timed_gen(tar_bytes, snapshot_id, blob_id, upper):
                    t = time.perf_counter()
                    gen(tar_bytes, snapshot_id, blob_id, upper)
                    times[(name, snapshot_id)] = time.perf_counter() - t

                mgr._generate_bootstrap = timed_gen
                return mgr

            def pull(name: str, engine):
                mgr = manager(name, engine)
                uppers = {}
                t = time.perf_counter()
                for sid, ld in zip(sids, ldigests):
                    upper = w / name / "snap" / sid / "fs"
                    upper.mkdir(parents=True)
                    uppers[sid] = str(upper)
                    mgr.prepare_layer({C.CRI_IMAGE_REF: ref, C.CRI_MANIFEST_DIGEST: mdigest,
                                       C.CRI_LAYER_DIGEST: ld}, sid, str(upper))
                for sid in sids:
                    mgr.wait_layer_ready(sid, timeout=600)
                return mgr, uppers, time.perf_counter() - t

            for k in kernels.values():
                k.launches = 0
            mgr, uppers, pull_s = pull("card", eng)
            launches = {key: k.launches for key, k in kernels.items() if k.launches}
            for sid in sids:
                if mgr._get_status(sid).status != tarfs.TARFS_STATUS_READY:
                    raise AssertionError(f"tarfs layer {sid} is not READY")
            by_thread = sorted(c[0] for c in calls)
            if launches != {"sha": len(layers)} or by_thread != sorted(f"tarfs-blob-{s}" for s in sids):
                raise AssertionError(f"index builds launched {launches} over digest_many calls "
                                     f"{calls}; want K2 once per layer ({len(layers)})")
            for k in kernels.values():
                k.launches = 0
            host, host_uppers, host_s = pull("host", None)
            if any(k.launches for k in kernels.values()):
                raise AssertionError("the host-route manager launched a kernel")
            for sid in sids:
                got = Path(mgr.layer_meta_file_path(uppers[sid])).read_bytes()
                want = Path(host.layer_meta_file_path(host_uppers[sid])).read_bytes()
                if got != want:
                    raise AssertionError(f"layer {sid}: the card's layer.boot differs from the host route's")
            boots = [Bootstrap.from_bytes(Path(mgr.layer_meta_file_path(uppers[s])).read_bytes()) for s in sids]
            regions = [len(b.chunks) for b in boots]
            # K2 through its wrapper on each layer's regions, the tar already
            # on the card (these launches compare, they are not the path's):
            # the digests the layer.boot holds; median of 3 calls between
            # CUDA events
            k2 = {}
            for sid, (_blob, raw), bs in zip(sids, layers, boots):
                offs = torch.tensor([c.uncompressed_offset for c in bs.chunks], dtype=torch.int32)
                sizes = torch.tensor([c.uncompressed_size for c in bs.chunks], dtype=torch.int32)
                staged = np.zeros(-(-len(raw) // 16) * 16, dtype=np.uint8)
                staged[:len(raw)] = np.frombuffer(raw, dtype=np.uint8)
                buf = torch.from_numpy(staged).to(dev)
                got = sha256_cuda.sha256_chunks(buf, offs, sizes)
                if fused_convert.state_bytes(to_u32(got), "sha256") != b"".join(c.digest for c in bs.chunks):
                    raise AssertionError(f"layer {sid}: K2 over its regions differs from its layer.boot")
                if dev.type == "cuda":
                    ms = cuda_ms(lambda: sha256_cuda.sha256_chunks(buf, offs, sizes), 3)
                else:
                    t = time.perf_counter()
                    sha256_cuda.sha256_chunks(buf, offs, sizes)
                    ms = (time.perf_counter() - t) * 1e3
                k2[sid] = {"call_ms": ms, "regions": len(bs.chunks), "bytes": int(sizes.sum()),
                           "longest_blocks": int(sizes.max()) // 64 + 1}
                del buf
            log(f"[19] pull + index of {len(layers)} layers at once: {pull_s:.2f} s on the card's engine "
                f"(launches {launches}: K2 once per layer, {len(calls)} digest_many calls, one per "
                f"layer thread), {host_s:.2f} s on the host route (hashlib); layer.boot of each == the "
                f"host route's")
            for sid, ld, n_reg in zip(sids, ldigests, regions):
                call = next(c for c in calls if c[0] == f"tarfs-blob-{sid}")
                log(f"[19]   layer {sid} ({ld[:19]}): {n_reg} regions; index build (tar written, "
                    f"regions digested, layer.boot written) {times[('card', sid)]:.3f} s card / "
                    f"{times[('host', sid)]:.3f} s host; digest_many {call[2]:.3f} s over {call[1]} "
                    f"regions (staging, K2, download); K2 call {k2[sid]['call_ms']:.3f} ms over "
                    f"{k2[sid]['bytes']} bytes (longest region {k2[sid]['longest_blocks']} blocks)")

            snap = type("Snap", (), {"id": "0", "parent_ids": sids[::-1]})()
            t = time.perf_counter()
            mgr.merge_layers(snap, lambda sid: uppers[sid])
            merge_s = time.perf_counter() - t
            host.merge_layers(snap, lambda sid: host_uppers[sid])
            merged = Path(mgr.image_meta_file_path(uppers[sids[-1]])).read_bytes()
            if merged != Path(host.image_meta_file_path(host_uppers[sids[-1]])).read_bytes():
                raise AssertionError("merged image.boot differs from the host route's")
            paths = {i.path for i in Bootstrap.from_bytes(merged).inodes}
            if "/layer0/d5/f5.bin" in paths or any(p.startswith("/layer0/d7/f") for p in paths) \
                    or "/layer0/d7/n0.bin" not in paths or "/app/d0/g0.bin" not in paths:
                raise AssertionError("the merged tree does not apply L3's whiteout and opaque directory")

            top_blob = ldigests[-1].split(":")[1]
            labels = {C.NYDUS_TARFS_LAYER: top_blob}
            t = time.perf_counter()
            fields = mgr.export_block_data(snap, False, labels, lambda sid: uppers[sid])
            export_s = time.perf_counter() - t
            if fields != ["labels." + C.NYDUS_IMAGE_BLOCK_INFO]:
                raise AssertionError(f"export_block_data updated {fields}")
            info = verity.parse_block_info_label(labels[C.NYDUS_IMAGE_BLOCK_INFO])
            disk = Path(mgr.image_disk_file_path(top_blob)).read_bytes()
            t = time.perf_counter()
            if not verity.verify(disk[: info.data_blocks * verity.DATA_BLOCK_SIZE], info,
                                 disk[info.hash_offset:]):
                raise AssertionError("the exported disk's dm-verity tree does not verify")
            verify_s = time.perf_counter() - t
            log(f"[19] merge {merge_s:.3f} s ({len(paths)} paths; == the host route's image.boot, "
                f"L3's whiteout and opaque directory applied); export {export_s:.2f} s: {len(disk)} "
                f"bytes, {info.data_blocks} data blocks, root {info.root_hash[:16]}..., verified "
                f"with tarfs.verity.verify in {verify_s:.2f} s")

            mgr.mount_on_host = True
            rafs = type("Rafs", (), {"snapshot_dir": str(w / "card" / "snap" / sids[-1]),
                                     "mountpoint": "", "annotations": {}})()
            mgr.mount_tar_erofs(sids[-1], snap, labels, rafs)
            mnt = os.path.join(rafs.snapshot_dir, "mnt")
            meta_image = mgr.image_meta_file_path(uppers[sids[-1]]) + ".erofs"
            merged_bs = Bootstrap.from_bytes(merged)
            want_tars = [mgr.layer_tar_file_path(b.blob_id) for b in merged_bs.blobs]
            attach_paths = [e[1] for e in loops.log if e[0] == "attach"]
            if attach_paths != want_tars + [meta_image] or rafs.mountpoint != mnt:
                raise AssertionError(f"loop attaches {attach_paths}; want {want_tars} then {meta_image}")
            src, fstype, opts = mounts.mounts[mnt]
            want_opts = ",".join(f"device=/dev/loop{i}" for i in range(len(want_tars)))
            if (src, fstype, opts) != (f"/dev/loop{len(want_tars)}", "erofs", want_opts):
                raise AssertionError(f"mount recorded {(src, fstype, opts)}")
            if rafs.annotations.get(C.NYDUS_IMAGE_BLOCK_INFO) != labels[C.NYDUS_IMAGE_BLOCK_INFO]:
                raise AssertionError("the mount did not carry the block-info annotation")
            mgr.umount_tar_erofs(sids[-1])
            for sid in sids:
                mgr.detach_layer(sid)
            if mounts.mounts or loops.attached:
                raise AssertionError(f"left mounted {mounts.mounts}, attached {loops.attached}")
            log(f"[19] mount_tar_erofs: {len(want_tars)} layer tars + the EROFS meta image attached "
                f"(recorded), mount {fstype} {src} -o {opts}; umount_tar_erofs and detach_layer "
                f"left nothing attached or mounted")

            # a config that names a wrong diff ID
            bad_tar = named_tar([("x/f", np.frombuffer(b"wrong diff id", dtype=np.uint8))])
            bad_blob = gzip.compress(bad_tar, mtime=0)
            wrong = "sha256:" + "0" * 64
            bad_m, bad_l = reg.publish("bad", [(bad_blob, wrong)])
            records: list[str] = []

            class Grab(logging.Handler):
                def emit(self, record):
                    records.append(record.getMessage())

            grab = Grab(level=logging.ERROR)
            manager_mod.logger.addHandler(grab)
            try:
                for k in kernels.values():
                    k.launches = 0
                bad_mgr = tarfs.Manager(cache_dir_path=str(w / "bad" / "cache"), engine=eng)
                (w / "bad" / "fs").mkdir(parents=True)
                bad_mgr.prepare_layer({C.CRI_IMAGE_REF: f"{reg.host}/{TARFS_REPO}:bad",
                                       C.CRI_MANIFEST_DIGEST: bad_m, C.CRI_LAYER_DIGEST: bad_l[0]},
                                      "99", str(w / "bad" / "fs"))
                try:
                    bad_mgr.wait_layer_ready("99", timeout=120)
                    raise AssertionError("a layer with a wrong diff ID became ready")
                except errdefs.Unavailable:
                    pass
            finally:
                manager_mod.logger.removeHandler(grab)
            want_msg = ("prepare tarfs layer for snapshot 99: layer diffID mismatch: sha256:"
                        f"{hashlib.sha256(bad_tar).hexdigest()} != {wrong}")
            if bad_mgr._get_status("99").status != tarfs.TARFS_STATUS_FAILED or records != [want_msg]:
                raise AssertionError(f"wrong diff ID: status {bad_mgr._get_status('99').status}, "
                                     f"logged {records}")
            if any(k.launches for k in kernels.values()):
                raise AssertionError("the refused layer launched a kernel")
            log(f"[19] wrong diff ID: FAILED, logged {want_msg[:60]}... (the reference's message), "
                f"no launch")
    finally:
        losetup.backend, mount_utils.backend = saved
        reg.close()
        shutil.rmtree(w, ignore_errors=True)
    out = {
        "layers": len(layers), "launches": launches, "pull_index_s": pull_s, "host_pull_index_s": host_s,
        "index_build_s": {sid: times[("card", sid)] for sid in sids},
        "host_index_build_s": {sid: times[("host", sid)] for sid in sids},
        "digest_many_s": {c[0]: c[2] for c in calls}, "regions": dict(zip(sids, regions)),
        "k2_call": k2,
        "merge_s": merge_s, "export_s": export_s, "verify_s": verify_s, "disk_bytes": len(disk),
        "phase_s": time.perf_counter() - t_phase, "device": smi,
    }
    log(f"[19] {out['phase_s']:.1f} s on {smi}")
    return out


# ---------------------------------------------------------------------------
# Phase 20: the lazy formats (soci/, stargz/, referrer/)
# ---------------------------------------------------------------------------

FORMATS_READS = 64  # seeded files read backward through each index
FORMATS_SEQ_ZSTD_READS = 8  # of them through the sequential zstd reader
FORMATS_FRAME_USIZE = 1 << 20  # the seekable zstd layer's frames
FORMATS_ESTARGZ_FILES = 3000  # files of phase 4's tar in the eStargz layer
FORMATS_ESTARGZ_MAX = 256 << 10  # the largest file it takes
FORMATS_REPO = "library/formats"
ESTARGZ_TOC = "stargz.index.json"


def _gzip_member(data: bytes, extra: bytes = b"") -> bytes:
    """One gzip member at level 9 with an optional FEXTRA field."""
    import struct
    import zlib

    head = bytes([0x1F, 0x8B, 0x08, 0x04 if extra else 0x00, 0, 0, 0, 0, 0, 0xFF])
    if extra:
        head += struct.pack("<H", len(extra)) + extra
    if data:
        comp = zlib.compressobj(9, zlib.DEFLATED, -15)
        body = comp.compress(data) + comp.flush()
    else:
        body = b"\x01\x00\x00\xff\xff"  # a final stored empty block
    return head + body + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data) & 0xFFFFFFFF)


def _tar_member(name: str, data: bytes) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:", format=tarfile.GNU_FORMAT) as tf:
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
    raw = buf.getvalue()
    while raw.endswith(b"\x00" * 512):  # members concatenate
        raw = raw[:-512]
    return raw


def estargz_blob(files: dict[str, bytes]) -> bytes:
    """An eStargz layer of ``files`` (path -> content), the shape
    tests/test_stargz.py's ``build_estargz`` makes: each regular file's tar
    header ends one gzip member and its data starts the next, so a TOC
    entry's ``offset`` inflates straight to the file's bytes; then the TOC
    (``stargz.index.json``) in a member of its own and the 51-byte footer.
    The members are independent, so 8 threads compress them."""
    import struct
    from concurrent.futures import ThreadPoolExecutor

    payloads = []
    for name, data in files.items():
        full = _tar_member(name, b"\xaa" * len(data))
        pad = (-len(data)) % 512
        payloads += [full[: len(full) - len(data) - pad], data + b"\0" * pad]
    with ThreadPoolExecutor(8) as pool:
        members = list(pool.map(_gzip_member, payloads))
    out = io.BytesIO()
    entries = [{"name": "./", "type": "dir", "mode": 0o755}]
    for i, (name, data) in enumerate(files.items()):
        out.write(members[2 * i])
        offset = out.tell()
        out.write(members[2 * i + 1])
        digest = "sha256:" + hashlib.sha256(data).hexdigest()
        entries.append({"name": name, "type": "reg", "size": len(data), "mode": 0o644,
                        "offset": offset, "chunkDigest": digest, "digest": digest})
    toc_offset = out.tell()
    out.write(_gzip_member(_tar_member(ESTARGZ_TOC, json.dumps({"version": 1, "entries": entries}).encode())))
    payload = b"%016x" % toc_offset + b"STARGZ"
    out.write(_gzip_member(b"", extra=b"SG" + struct.pack("<H", len(payload)) + payload))
    return out.getvalue()


def formats_phase(dev, tar: bytes, kernels) -> dict:
    """Phase 20: phase 4's tar as gzip, seekable zstd, zstd:chunked and
    eStargz layers on an in-process registry, routed and prepared by the
    soci adaptor on the host (no launch), the gzip and zstd ref packs on the
    card (K2, K4) equal to the host's bootstraps, the persisted indexes
    reloaded, backward reads through the indexes against the sequential
    readers, and a referrer's bootstrap fetched."""
    import gzip
    import os
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from nydus_snapshotter_tpu_torch.constants import LAYER_ANNOTATION_NYDUS_BOOTSTRAP
    from nydus_snapshotter_tpu_torch.converter import PackOption, convert, zran, zstd_ref
    from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap
    from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine
    from nydus_snapshotter_tpu_torch.referrer import METADATA_NAME_IN_LAYER, Referrer, ReferrerManager
    from nydus_snapshotter_tpu_torch.remote import remote as remote_mod
    from nydus_snapshotter_tpu_torch.remote import transport
    from nydus_snapshotter_tpu_torch.soci import (
        SociAdaptor, SociResolver, SociStreamReader, ZstdStreamReader, router, zframe,
    )
    from nydus_snapshotter_tpu_torch.soci import adaptor as adaptor_mod
    from nydus_snapshotter_tpu_torch.soci import blob as soci_blob
    from nydus_snapshotter_tpu_torch.soci import toc as ztoc
    from nydus_snapshotter_tpu_torch.soci import zblob
    from nydus_snapshotter_tpu_torch.soci import zran as soci_zran
    from nydus_snapshotter_tpu_torch.utils import zstd

    t_phase = time.perf_counter()
    smi = nvidia_smi("name,power.limit")
    if not (zframe.available() and soci_zran.available()):
        raise AssertionError("the system libzstd frame API or libz inflatePrime is missing: "
                             "the seekable and zran routes cannot run")

    def counted(fn):
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, {key: k.launches for key, k in kernels.items() if k.launches}

    # -- the layers, made in parallel -------------------------------------------
    with tarfile.open(fileobj=io.BytesIO(tar)) as tf:
        members = [m for m in tf if m.isreg()]
    files = {m.name: tar[m.offset_data:m.offset_data + m.size] for m in members}
    small = {n: d for n, d in files.items() if len(d) <= FORMATS_ESTARGZ_MAX}
    est_files = dict(list(small.items())[:FORMATS_ESTARGZ_FILES])
    t0 = time.perf_counter()
    single_tar = named_tar([(f"one/f{i}.bin", np.frombuffer(d, dtype=np.uint8))
                            for i, d in enumerate(list(files.values())[:64])])
    make_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        make_s[name] = time.perf_counter() - t
        return out

    with ThreadPoolExecutor(5) as pool:  # each layer on a thread; gzip and eStargz fan out again
        jobs = {"estargz": pool.submit(timed, "estargz", estargz_blob, est_files),
                "gzip": pool.submit(timed, "gzip", gzip_members, tar),
                "seekable": pool.submit(timed, "seekable", zframe.write_seekable, tar, FORMATS_FRAME_USIZE, 3),
                "chunked": pool.submit(timed, "chunked", ztoc.write_zstd_chunked, files),
                "single": pool.submit(timed, "single", zstd.compress_block, single_tar, 3)}
        layers = {k: f.result() for k, f in jobs.items()}
    single = layers.pop("single")
    layers = {k: layers[k] for k in ("gzip", "seekable", "chunked", "estargz")}
    t_make = time.perf_counter() - t0
    log(f"[20] layers from phase 4's {len(tar)} byte tar ({len(files)} files) in {t_make:.2f} s "
        f"(a thread each): gzip level 1 in {OCIREF_GZIP_MEMBERS} members {len(layers['gzip'])} bytes "
        f"({make_s['gzip']:.2f} s); seekable zstd -3 in {FORMATS_FRAME_USIZE >> 20} MiB frames "
        f"{len(layers['seekable'])} bytes ({make_s['seekable']:.2f} s); zstd:chunked "
        f"{len(layers['chunked'])} bytes ({make_s['chunked']:.2f} s); eStargz of {len(est_files)} "
        f"files ({sum(map(len, est_files.values()))} bytes, level-9 members on 8 threads) "
        f"{len(layers['estargz'])} bytes ({make_s['estargz']:.2f} s); a single-frame zstd layer "
        f"{len(single)} bytes ({len(single_tar)} as tar)")

    reg = OciRegistry()
    digests = {k: reg.add_blob(b) for k, b in layers.items()}
    digests["single"] = reg.add_blob(single)
    ref = f"{reg.host}/{FORMATS_REPO}:v1"
    w = Path(tempfile.mkdtemp(prefix="ntpu-formats-"))
    cache = str(w / "cache")
    try:
        # -- route: SociResolver.get_blob over HTTP ranges ----------------------
        want_route = {"gzip": router.BACKEND_ZRAN, "seekable": router.BACKEND_SEEKABLE,
                      "chunked": router.BACKEND_TOC_ADOPT, "estargz": router.BACKEND_TOC_ADOPT}
        before = router.route_counts()
        resolver = SociResolver(pool=transport.Pool(plain_http=True))
        blobs, routes = {}, {}
        t0 = time.perf_counter()
        for kind in want_route:
            blobs[kind] = resolver.get_blob(ref, digests[kind])
            routes[kind] = blobs[kind].route
            if routes[kind].backend != want_route[kind]:
                raise AssertionError(f"{kind} routed {routes[kind].describe()}; want {want_route[kind]}")
        t_route = time.perf_counter() - t0
        one = resolver.get_blob(ref, digests["single"])  # opaque zstd: indexable until its frames are seen
        adaptor = SociAdaptor(lambda sid: str(w / "snap" / sid / "fs"), cache_dir=cache,
                              chunk_size=CHUNK_SIZE)
        try:
            adaptor.prepare_meta_layer(one, str(w / "snap" / "single" / "fs"))
            raise AssertionError("a single-frame zstd layer was prepared")
        except adaptor_mod.SociError as e:
            single_msg = str(e)
        after = router.route_counts()
        moved = {b: after.get(b, 0) - before.get(b, 0) for b in after if after.get(b, 0) != before.get(b, 0)}
        want_moved = {router.BACKEND_ZRAN: 1, router.BACKEND_SEEKABLE: 2, router.BACKEND_TOC_ADOPT: 2,
                      router.BACKEND_RAFS: 1}
        if moved != want_moved:
            raise AssertionError(f"route_counts moved {moved}; want {want_moved}")
        log(f"[20] SociResolver.get_blob over HTTP ranges in {t_route:.3f} s: "
            + "; ".join(f"{k} -> {r.describe()}" for k, r in routes.items())
            + f"; the single-frame zstd layer raised SociError ({single_msg[:70]}...); route_counts "
            f"moved {moved}")

        # -- prepare and merge on the host: no launch ---------------------------
        built = {}
        orig_gz, orig_zs = soci_blob.build_index_from_gzip, zblob.build_zindex_from_zstd

        def keep(name, fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                built[name] = out[0]
                return out
            return wrapped

        soci_blob.build_index_from_gzip = keep("gzip", orig_gz)
        zblob.build_zindex_from_zstd = keep("seekable", orig_zs)
        kinds = list(want_route)  # bottom first
        sids = {kind: str(len(kinds) - i) for i, kind in enumerate(kinds)}
        prep_s, prep_fetch = {}, {}
        try:
            for kind in kinds:
                fetched = []
                b = blobs[kind]
                read_at = b._read_at  # under Blob.read_at, read_toc and the TOC probes
                b._read_at = lambda o, n, read_at=read_at, fetched=fetched: (
                    fetched.append(n), read_at(o, n))[1]
                _, prep_s[kind], launched = counted(
                    lambda: adaptor.prepare_meta_layer(b, str(w / "snap" / sids[kind] / "fs")))
                prep_fetch[kind] = sum(fetched)
                if launched:
                    raise AssertionError(f"the adaptor's {kind} prepare launched {launched}")
        finally:
            soci_blob.build_index_from_gzip, zblob.build_zindex_from_zstd = orig_gz, orig_zs
        snap = type("Snap", (), {"parent_ids": [sids[k] for k in kinds[::-1]]})()
        _, merge_s, launched = counted(lambda: adaptor.merge_meta_layer(snap))
        if launched:
            raise AssertionError(f"merge_meta_layer launched {launched}")
        host_boot = {k: (w / "snap" / sids[k] / "fs" / digests[k].split(":")[1]).read_bytes() for k in kinds}
        merged = (w / "snap" / sids[kinds[-1]] / "fs" / "image.boot").read_bytes()
        merged_bs = Bootstrap.from_bytes(merged)
        paths = {i.path for i in merged_bs.inodes}
        missing = [n for n in files if "/" + n not in paths]
        if missing:
            raise AssertionError(f"the merged image.boot lacks {len(missing)} files, e.g. {missing[:3]}")
        for kind in ("chunked", "estargz"):
            if prep_fetch[kind] > len(layers[kind]) // 4:
                raise AssertionError(f"toc-adopt of {kind} fetched {prep_fetch[kind]} bytes")
        log(f"[20] SociAdaptor.prepare_meta_layer on the host, 0 launches: "
            + "; ".join(f"{k} {prep_s[k]:.2f} s, {prep_fetch[k]} bytes fetched" for k in kinds)
            + f"; merge_meta_layer {merge_s:.3f} s, 0 launches ({len(merged_bs.inodes)} inodes, "
            f"{len(merged_bs.blobs)} blobs)")

        # -- the persisted indexes reload into equal objects --------------------
        gz_id, zs_id = digests["gzip"].split(":")[1], digests["seekable"].split(":")[1]
        t0 = time.perf_counter()
        gidx, gbad = soci_blob.find_index([cache], gz_id, csize=len(layers["gzip"]))
        zidx, zbad = zblob.find_zindex([cache], zs_id, csize=len(layers["seekable"]))
        t_load = time.perf_counter() - t0
        if (gbad, zbad) != (0, 0) or gidx != built["gzip"] or zidx != built["seekable"]:
            raise AssertionError("a persisted index does not reload into the index the adaptor built")
        idx_bytes = {k: os.path.getsize(p) for k, p in (("soci.idx", soci_blob.index_path(cache, gz_id)),
                                                        ("soci.zidx", zblob.zindex_path(cache, zs_id)))}
        log(f"[20] find_index / find_zindex reload == the built indexes in {t_load:.3f} s: "
            f"{len(gidx.checkpoints)} checkpoints at stride {gidx.stride >> 10} KiB, {len(gidx.files)} "
            f"files ({idx_bytes['soci.idx']} bytes); {len(zidx.frames)} frames from the "
            f"{zidx.source_name} ({idx_bytes['soci.zidx']} bytes)")

        # -- the card's ref packs equal the host's bootstraps -------------------
        packs, dev_boot = {}, {}
        for kind, raw, pack_fn in (("gzip", layers["gzip"], zran.pack_gzip_layer),
                                   ("seekable", layers["seekable"], zstd_ref.pack_zstd_layer)):
            for digester in ("sha256", "blake3"):
                opt = PackOption(oci_ref=True, chunk_size=CHUNK_SIZE, digester=digester)
                eng = ChunkDigestEngine(chunk_size=CHUNK_SIZE, backend="jax", digest_backend="jax",
                                        digester=digester, device=dev)
                bs, dev_s, launched = counted(lambda: pack_fn(raw, opt, engine=eng, tar_bytes=tar))
                want_l = {"sha": 1} if digester == "sha256" else {"b3_leaves": 1, "b3_parents": 1}
                if launched != want_l:
                    raise AssertionError(f"the card's {kind}/{digester} ref pack launched {launched}; "
                                         f"want {want_l}")
                if digester == "sha256":
                    want = host_boot[kind]
                else:
                    want = pack_fn(raw, opt, tar_bytes=tar).to_bytes()
                if bs.to_bytes() != want:
                    raise AssertionError(f"{kind}/{digester}: the card's bootstrap differs from the host's")
                packs[f"{kind}/{digester}"] = {"s": dev_s, "launches": launched}
                dev_boot[(kind, digester)] = bs
        log("[20] ref packs on the card == the host's bootstraps (the adaptor's for SHA-256): "
            + "; ".join(f"{k} {p['s']:.2f} s ({', '.join(f'{n} {c}' for n, c in p['launches'].items())})"
                        for k, p in packs.items()))

        # -- backward reads through the indexes, against the sequential readers --
        reads = {}
        for kind, reader_cls, idx in (("gzip", SociStreamReader, gidx), ("seekable", ZstdStreamReader, zidx)):
            raw = layers[kind]
            bs = dev_boot[(kind, "sha256")]
            regs = [i for i in bs.inodes if i.chunk_count]
            pick = np.random.default_rng(SEED + 20).choice(len(regs), FORMATS_READS, replace=False)
            order = sorted((regs[k] for k in pick), key=lambda i: -bs.chunks[i.chunk_index].uncompressed_offset)
            mount = "mount_gzip_stream" if kind == "gzip" else "mount_zstd_stream"

            def read_files(reader, inodes, pulled):
                per = []
                for ino in inodes:
                    recs = bs.chunks[ino.chunk_index:ino.chunk_index + ino.chunk_count]
                    lo = recs[0].uncompressed_offset
                    f0, p0, t = soci_blob.FETCH_BYTES.value(), sum(pulled), time.perf_counter()
                    got = b"".join(reader.chunk_data(c) for c in recs)
                    per.append((time.perf_counter() - t, soci_blob.FETCH_BYTES.value() - f0 + sum(pulled) - p0,
                                len(recs)))
                    if got != tar[lo:lo + ino.size]:
                        raise AssertionError(f"{kind} {ino.path}: the read differs from the tar's bytes")
                return per

            arms = {}
            for arm, read_comp in (("memory", lambda o, n, raw=raw: raw[o:o + n]),
                                   ("registry", blobs[kind].read_at)):
                br = convert.BlobReader(bs, 0, lambda o, n, raw=raw: raw[o:o + n])
                getattr(br, mount)(reader_cls(idx, read_comp))
                arms[arm] = read_files(br, order, [])
            pulled = []
            seq = convert.BlobReader(bs, 0, lambda o, n, raw=raw: (pulled.append(n), raw[o:o + n])[1])
            n_seq = FORMATS_READS if kind == "gzip" else FORMATS_SEQ_ZSTD_READS
            arms["sequential"] = read_files(seq, order[:n_seq], pulled)
            reads[kind] = {arm: {"files": len(per), "chunks": sum(p[2] for p in per),
                                 "s_per_read": sum(p[0] for p in per) / len(per),
                                 "s_per_chunk": sum(p[0] for p in per) / sum(p[2] for p in per),
                                 "fetch_bytes_per_read": sum(p[1] for p in per) / len(per),
                                 "max_fetch_bytes": max(p[1] for p in per)}
                           for arm, per in arms.items()}
            if kind == "gzip":
                cuts = [0] + [cp.cin for cp in idx.checkpoints] + [len(raw)]
                widest = max(b - a for a, b in zip(cuts, cuts[1:]))
            else:
                widest = max(f.csize for f in idx.frames)
            reads[kind]["widest_span_bytes"] = widest
            r = reads[kind]
            log(f"[20] {kind}: {FORMATS_READS} seeded files in descending offsets, bytes == the tar's: "
                + "; ".join(f"{arm} {v['s_per_read'] * 1e3:.2f} ms a read ({v['chunks']} chunks, "
                            f"{v['s_per_chunk'] * 1e3:.2f} ms a chunk), {v['fetch_bytes_per_read']:.0f} "
                            f"compressed bytes a read (largest {v['max_fetch_bytes']})"
                            for arm, v in r.items() if isinstance(v, dict))
                + f"; the index's widest span {widest} bytes"
                + ("" if kind == "gzip" else f" (sequential: the first {FORMATS_SEQ_ZSTD_READS} files)"))

        # -- the referrer: a nydus bootstrap layer behind the OCI referrers API --
        meta = io.BytesIO()
        with tarfile.open(fileobj=meta, mode="w:") as tf:
            ti = tarfile.TarInfo(METADATA_NAME_IN_LAYER)
            ti.size = len(merged)
            tf.addfile(ti, io.BytesIO(merged))
        layer = gzip.compress(meta.getvalue(), compresslevel=1, mtime=0)
        man = json.dumps({"schemaVersion": 2, "layers": [{
            "mediaType": "application/vnd.oci.image.layer.v1.tar+gzip", "digest": reg.add_blob(layer),
            "size": len(layer), "annotations": {LAYER_ANNOTATION_NYDUS_BOOTSTRAP: "true"}}]}).encode()
        image_digest = digests["gzip"]
        reg.referrers[image_digest] = [{"mediaType": "application/vnd.oci.image.manifest.v1+json",
                                        "digest": reg.add_blob(man), "size": len(man)}]
        t0 = time.perf_counter()
        with plain_http_remote(remote_mod):
            mgr = ReferrerManager()
            desc = mgr.check_referrer(ref, image_digest)
            n_req = len(reg.requests)
            if mgr.check_referrer(ref, image_digest).digest != desc.digest or len(reg.requests) != n_req:
                raise AssertionError("the referrer manager's second lookup was not served from its cache")
            Referrer().fetch_metadata(ref, desc, str(w / "referrer.boot"))
            mgr.try_fetch_metadata(ref, image_digest, str(w / "manager.boot"))
        t_ref = time.perf_counter() - t0
        if (w / "referrer.boot").read_bytes() != merged or (w / "manager.boot").read_bytes() != merged:
            raise AssertionError("the referrer's bootstrap differs from the merged image.boot")
        log(f"[20] referrer: ReferrerManager.check_referrer -> {desc.digest[:19]}.. (cached on the second "
            f"lookup), Referrer.fetch_metadata and try_fetch_metadata wrote the merged image.boot "
            f"({len(merged)} bytes) in {t_ref:.3f} s")
    finally:
        reg.close()
        shutil.rmtree(w, ignore_errors=True)
    out = {
        "layers": {k: len(b) for k, b in layers.items()}, "make_s": t_make, "layer_make_s": make_s,
        "route_s": t_route,
        "routes": {k: r.backend for k, r in routes.items()}, "route_counts": moved,
        "prepare_s": prep_s, "prepare_fetch_bytes": prep_fetch, "merge_s": merge_s,
        "index_files": idx_bytes, "index_load_s": t_load, "packs": packs, "reads": reads,
        "referrer_s": t_ref, "phase_s": time.perf_counter() - t_phase, "device": smi,
    }
    log(f"[20] {out['phase_s']:.1f} s on {smi}")
    return out


FETCH_READS = 256  # seeded files node A reads cold and warm, node B through the peer
FETCH_AFTER_READS = 64  # more seeded files node B reads once the peer is gone
FETCH_THREADS = 8
FETCH_PREFETCH_FILES = 64  # the pack's prefetch table
FETCH_SOCI_READS = 64  # gzip-layer files read backward through SociStreamReader over a CachedBlob
FETCH_REPO = "library/fetch"


def fetch_phase(dev, tar: bytes, kernels) -> dict:
    """Phase 21: the daemon's fetch side over blobs packed on the card. The
    tar's fused lz4 pack (K1, K2 once each; equal to the hybrid lane's) is
    served by an in-process registry with ``Range``; node A reads seeded
    files cold through ``CachedBlob`` over ``RegistryBlobFetcher`` from 8
    threads, then warm; node B reads them through ``PeerAwareFetcher`` from
    A's ``PeerChunkServer`` and falls back to the registry once A's server
    stops; node C replays the bootstrap's prefetch table; A's ledger
    compiles a ``.heat`` artifact a fresh cache dir adopts; ``CacheManager``
    accounts both caches and evicts A's entry under its live ``CachedBlob``;
    the tar's gzip layer reads backward through ``SociStreamReader`` over a
    ``CachedBlob``."""
    import os
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from types import SimpleNamespace

    from nydus_snapshotter_tpu_torch import cache, provenance
    from nydus_snapshotter_tpu_torch.converter import PackOption, convert, pack_layer
    from nydus_snapshotter_tpu_torch.daemon import blobcache, fetch_sched, peer
    from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap
    from nydus_snapshotter_tpu_torch.soci import SociStreamReader
    from nydus_snapshotter_tpu_torch.soci import blob as soci_blob
    from nydus_snapshotter_tpu_torch.soci import zran as soci_zran

    t_phase = time.perf_counter()
    smi = nvidia_smi("name,power.limit")
    cfg = fetch_sched.FetchConfig()
    if (cfg.fetch_workers, cfg.merge_gap, cfg.readahead, cfg.budget_bytes) != (4, 128 << 10, 1 << 20, 64 << 20):
        raise AssertionError(f"the fetch scheduler's defaults moved: {cfg}")
    if not soci_zran.available():
        raise AssertionError("the system libz lacks inflatePrime: the gzip index cannot run")

    def counted(fn):
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, {key: k.launches for key, k in kernels.items()}

    with tarfile.open(fileobj=io.BytesIO(tar)) as tf:
        members = [m for m in tf if m.isreg()]
    files = {"/" + m.name: tar[m.offset_data:m.offset_data + m.size] for m in members}
    rng = np.random.default_rng(SEED + 21)
    nonempty = [n for n in files if files[n]]
    prefetch = [nonempty[i] for i in sorted(rng.choice(len(nonempty), FETCH_PREFETCH_FILES, replace=False))]

    # -- 1. pack on the card -----------------------------------------------------
    opt = dict(chunk_size=CHUNK_SIZE, compressor="lz4_block", prefetch_patterns="\n".join(prefetch))
    (blob_f, res_f), pack_s, launches = counted(
        lambda: pack_layer(tar, PackOption(backend="fused", **opt), device=dev))
    want_l = {k: 0 for k in kernels}
    want_l.update(gear=1, sha=1)
    if launches != want_l:
        raise AssertionError(f"the fused lz4 pack launched {launches}; want {want_l}")
    (blob_h, res_h), hybrid_s, launched_h = counted(
        lambda: pack_layer(tar, PackOption(backend="hybrid", **opt)))
    if any(launched_h.values()):
        raise AssertionError(f"the hybrid pack launched {launched_h}")
    if (blob_f, res_f.bootstrap, res_f.blob_id) != (blob_h, res_h.bootstrap, res_h.blob_id):
        raise AssertionError("the fused and hybrid lz4 packs differ")
    data = convert.blob_data_from_layer_blob(blob_f)
    blob_id = res_f.blob_id
    if hashlib.sha256(data).hexdigest() != blob_id:
        raise AssertionError("the blob id is not the data section's SHA-256")
    bs = Bootstrap.from_bytes(res_f.bootstrap)
    if list(bs.prefetch) != prefetch:
        raise AssertionError(f"the bootstrap's prefetch table holds {len(bs.prefetch)} paths, not the pattern's")
    by_path = {i.path: i for i in bs.inodes}
    readable = [i for i in bs.inodes if i.chunk_count and not i.hardlink_target and i.path in files]
    pick = rng.choice(len(readable), FETCH_READS + FETCH_AFTER_READS, replace=False)
    reads = [readable[k] for k in pick[:FETCH_READS]]
    after = [readable[k] for k in pick[FETCH_READS:]]
    log(f"[21] fused lz4 pack on the card {pack_s:.2f} s (launches {launches}), == the hybrid lane "
        f"({hybrid_s:.2f} s, no launch): {len(data)} byte blob {blob_id[:16]}.., {len(bs.chunks)} chunks, "
        f"prefetch table of {len(bs.prefetch)} files")

    reg = OciRegistry()
    reg.add_blob(data)
    backend = SimpleNamespace(host=reg.host, repo=FETCH_REPO, scheme="http", auth="", skip_verify=False,
                              mirrors=[])

    def gets(digest_hex: str = blob_id) -> int:
        return sum(1 for r in reg.requests if r.startswith("GET ") and f"/blobs/sha256:{digest_hex}" in r)

    def delta(before: dict) -> dict:
        now = fetch_sched.snapshot_counters()
        return {k: now[k] - before[k] for k in ("hit_bytes", "miss_bytes", "fetch_requests",
                                                "coalesced_requests", "readahead_bytes",
                                                "singleflight_waits", "prefetch_bytes")}

    def settle(cb) -> None:
        """Wait out the readahead flights a pass left in flight, so its
        counters and GETs are read whole."""
        while cb.sched.overlapping_flights(0, cb.blob_size):
            time.sleep(0.001)

    def read_files(cb, inodes, threads: int = FETCH_THREADS) -> dict:
        """Each file chunk by chunk through its compressed extents
        (``BlobReader.chunk_data`` over ``cb.read_at``), one reader a thread."""

        def work(k):
            reader = convert.BlobReader(bs, 0, cb.read_at)
            out = []
            for ino in inodes[k::threads]:
                recs = bs.chunks[ino.chunk_index:ino.chunk_index + ino.chunk_count]
                t0 = time.perf_counter()
                got = b"".join(reader.chunk_data(r) for r in recs)
                dt = time.perf_counter() - t0
                if got != files[ino.path]:
                    raise AssertionError(f"{ino.path}: the chunks do not decompress to the tar's bytes")
                out.append((dt, sum(r.compressed_size for r in recs), len(recs)))
            return out

        c0, g0, t0 = fetch_sched.snapshot_counters(), gets(), time.perf_counter()
        with ThreadPoolExecutor(threads) as pool:
            per = [x for part in pool.map(work, range(threads)) for x in part]
        wall = time.perf_counter() - t0
        settle(cb)
        return {"files": len(per), "chunks": sum(p[2] for p in per), "wall_s": wall,
                "ms_per_read": 1e3 * sum(p[0] for p in per) / len(per),
                "requested_bytes": sum(p[1] for p in per), "gets": gets() - g0, **delta(c0)}

    def fmt(r: dict) -> str:
        return (f"{r['files']} files / {r['chunks']} chunks in {r['wall_s']:.3f} s, {r['ms_per_read']:.3f} "
                f"ms a read, {r['gets']} GETs, {r['miss_bytes']} bytes fetched for {r['requested_bytes']} "
                f"requested ({r['hit_bytes']} hit), {r['fetch_requests']} flights ({r['coalesced_requests']} "
                f"coalesced, {r['readahead_bytes']} readahead bytes), {r['singleflight_waits']} singleflight joins")

    # The caches live on tmpfs: on a 9p root (the card machine's) an open
    # file keeps st_nlink 1 after its unlink, so a CachedBlob cannot see a
    # watermark eviction (PERF.md §7); a node's local disk behaves as tmpfs.
    w = Path(tempfile.mkdtemp(prefix="ntpu-fetch-", dir="/dev/shm" if os.path.isdir("/dev/shm") else None))
    sockdir = tempfile.mkdtemp(prefix="f", dir="/tmp")
    out: dict = {"launches": launches, "pack_s": pack_s, "hybrid_pack_s": hybrid_s, "blob_bytes": len(data),
                 "chunks": len(bs.chunks), "config": dataclasses.asdict(cfg)}
    opened = []
    try:
        # -- 2. node A, cold then warm -------------------------------------------
        # The ledger is process-wide and keyed by blob id: each node's
        # conservation is read between resets. A node that coalesces nothing
        # (merge_gap 0) reads first: no byte may be fetched twice there. At
        # the defaults a flight coalesced across a hole that is cached or in
        # flight fetches that hole again; those bytes are counted, not refused.
        cold = {}
        for arm, arm_cfg in (("merge_gap_0", dataclasses.replace(cfg, merge_gap=0)), ("defaults", cfg)):
            provenance.reset()
            cb = blobcache.CachedBlob(str(w / ("a" if arm == "defaults" else "a0")), blob_id,
                                      blobcache.RegistryBlobFetcher(backend, blob_id).read_range,
                                      blob_size=len(data), config=arm_cfg)
            opened.append(cb)
            r = read_files(cb, reads)
            cons = provenance.conservation(blob_id)
            r["ledger_fetched_bytes"] = cons["fetched_bytes"]
            r["duplicate_bytes"] = cons["fetched_bytes"] - cb.coverage_bytes()
            if not cons["exact"] or cons["fetched_bytes"] != r["miss_bytes"]:
                raise AssertionError(f"node A ({arm}): the ledger does not conserve the fetched bytes: {cons}, {r}")
            if r["gets"] != r["fetch_requests"]:
                raise AssertionError(f"node A ({arm}): {r['gets']} GETs for {r['fetch_requests']} flights")
            if arm == "merge_gap_0" and (r["duplicate_bytes"] or r["coalesced_requests"]):
                raise AssertionError(f"node A (merge_gap 0) fetched {r['duplicate_bytes']} bytes twice")
            log(f"[21] node A cold, {arm}: {fmt(r)}; the ledger conserves {cons['fetched_bytes']} bytes, "
                f"{r['duplicate_bytes']} of them fetched twice")
            cold[arm] = r
        cb_a = opened[-1]
        warm = read_files(cb_a, reads)
        if warm["hit_bytes"] != warm["requested_bytes"] or warm["miss_bytes"] != warm["readahead_bytes"]:
            raise AssertionError(f"node A's second pass missed: {warm}")
        if warm["gets"] != warm["fetch_requests"]:
            raise AssertionError(f"node A's second pass: {warm['gets']} GETs for {warm['fetch_requests']} "
                                 "readahead flights")
        log(f"[21] node A warm: {fmt(warm)} (every read a hit; any GET is a readahead flight)")
        out.update(cold=cold["defaults"], cold_merge_gap_0=cold["merge_gap_0"], warm=warm)
        art = provenance.compile_heat(blob_id, str(w / "a"), source_size=len(data))
        if art is None or not art.extents:
            raise AssertionError("node A's ledger compiled no heat artifact")

        # -- 3. node B through A's chunk server, then without it -----------------
        sock_a = os.path.join(sockdir, "a.sock")
        export = peer.PeerExport()
        export.register(blob_id, cb_a)
        server = peer.PeerChunkServer(export, pull_through=False)
        server.run(sock_a)
        # Node B serves no region itself (no self address): every extent's
        # owner is A, a cover-only server. B's readahead windows are its own
        # (the 8 threads interleave differently than on A), so a window A
        # never fetched falls back to the registry; a demand read never may.
        origin_b = blobcache.RegistryBlobFetcher(backend, blob_id)
        router = peer.PeerRouter([sock_a])
        cb_b = blobcache.CachedBlob(str(w / "b"), blob_id,
                                    peer.PeerAwareFetcher(blob_id, origin_b.read_range, router).read_range,
                                    blob_size=len(data), config=cfg)
        opened.append(cb_b)
        provenance.reset()
        p0 = peer.FETCH_BYTES.value()
        via_peer = read_files(cb_b, reads)
        via_peer["peer_bytes"] = peer.FETCH_BYTES.value() - p0
        rows = provenance.waterfall(blob_id)
        server.stop()
        by = {}
        for r in rows:
            key = (r["cause"], r["tier"] or "registry")
            by[key] = by.get(key, 0) + r["bytes"]
        via_peer["bytes_by_cause_and_tier"] = {f"{c}/{t}": n for (c, t), n in sorted(by.items())}
        demand_origin = sum(n for (c, t), n in by.items() if c == "demand" and t != peer.TIER_FLAT)
        origin_rows = [r for r in rows if r["tier"] != peer.TIER_FLAT]
        if len(rows) != via_peer["fetch_requests"] or sum(r["bytes"] for r in rows) != via_peer["miss_bytes"]:
            raise AssertionError(f"node B's ledger rows do not match its flights: {len(rows)}, {via_peer}")
        if demand_origin or via_peer["gets"] != len(origin_rows):
            raise AssertionError(f"node B's demand reads went to the registry: {via_peer}")
        if via_peer["peer_bytes"] != sum(r["bytes"] for r in rows if r["tier"] == peer.TIER_FLAT):
            raise AssertionError(f"node B's peer bytes disagree with its ledger: {via_peer}")
        log(f"[21] node B through A's PeerChunkServer (UDS): {fmt(via_peer)}; bytes by cause/tier "
            f"{via_peer['bytes_by_cause_and_tier']} (every demand flight from the peer)")
        g0 = gets()
        fallback = read_files(cb_b, after)
        if fallback["gets"] == 0 or gets() == g0:
            raise AssertionError("node B read uncached extents with the peer gone and made no GET")
        log(f"[21] node B with A's server stopped, {FETCH_AFTER_READS} new files: {fmt(fallback)}")
        out.update(peer=via_peer, origin_fallback=fallback)

        # -- 4. node C: prefetch replay, heat adoption ---------------------------
        cb_c = blobcache.CachedBlob(str(w / "c"), blob_id, blobcache.RegistryBlobFetcher(backend, blob_id).read_range,
                                    blob_size=len(data), config=cfg)
        opened.append(cb_c)

        def warm_chunk(rec) -> int:
            flights = cb_c.warm(rec.compressed_offset, rec.compressed_size)
            for f in flights:
                f.wait()
            return 0 if any(f.error for f in flights) else rec.compressed_size

        replayer = fetch_sched.PrefetchReplayer(bs, by_path, warm_chunk, on_file=cb_c.flush_map)
        c0, g0, t0 = fetch_sched.snapshot_counters(), gets(), time.perf_counter()
        warmed = replayer.replay(list(bs.prefetch))
        replay = {"s": time.perf_counter() - t0, "warmed_bytes": warmed, "files": replayer.files_replayed,
                  "gets": gets() - g0, **delta(c0)}
        if replayer.files_replayed != len(bs.prefetch) or replay["prefetch_bytes"] != warmed:
            raise AssertionError(f"prefetch replay: {replay}")
        pf_inodes = [by_path[p] for p in bs.prefetch if by_path[p].chunk_count and not by_path[p].hardlink_target]
        after_replay = read_files(cb_c, pf_inodes)
        if (after_replay["hit_bytes"] != after_replay["requested_bytes"]
                or after_replay["miss_bytes"] != after_replay["readahead_bytes"]):
            raise AssertionError(f"reads after the prefetch replay missed: {after_replay}")
        heat_dir = w / "fresh"
        heat_dir.mkdir()
        raw_heat = Path(provenance.heat_path(str(w / "a"), blob_id)).read_bytes()
        adopted = provenance.load_or_adopt_heat([str(heat_dir)], blob_id, source_size=len(data),
                                                fetch_remote=lambda: raw_heat)
        if adopted is None or adopted.extents != art.extents:
            raise AssertionError("the adopted heat artifact's extents differ from node A's")
        log(f"[21] node C: PrefetchReplayer warmed {warmed} bytes of {replayer.files_replayed} files at the "
            f"prefetch lane in {replay['s']:.3f} s ({replay['gets']} GETs, {replay['fetch_requests']} flights); "
            f"then {fmt(after_replay)}; A's .heat ({len(raw_heat)} bytes, {len(art.extents)} extents, "
            f"{art.total_bytes()} bytes) adopted in a fresh cache dir with equal extents")
        out.update(prefetch_replay=replay, after_replay=after_replay,
                   heat={"bytes": len(raw_heat), "extents": len(art.extents), "heat_bytes": art.total_bytes()})

        # -- 5. the cache manager: accounting, eviction under a live CachedBlob ----
        usage = {}
        for node, cb in (("a", cb_a), ("c", cb_c)):
            cb.flush_map()
            mgr = cache.CacheManager(str(w / node))
            present = [n for n in os.listdir(w / node) if n.startswith(blob_id)]
            got = mgr.cache_usage(blob_id)
            size = sum(os.lstat(w / node / n).st_size for n in present)
            if (got.inodes, got.size) != (len(present), size):
                raise AssertionError(f"node {node}: CacheManager counts {got}, the dir holds {present}")
            usage[node] = {"inodes": got.inodes, "bytes": got.size, "files": sorted(n[64:] for n in present)}
        if ".heat" not in usage["a"]["files"]:
            raise AssertionError(f"node A's entry lacks its .heat companion: {usage['a']}")
        ev0 = fetch_sched.EVICTED_BYTES.value()
        removed = cache.CacheManager(str(w / "a")).gc_watermark(1)
        evicted = fetch_sched.EVICTED_BYTES.value() - ev0
        if sorted(os.path.basename(p)[64:] for p in removed) != usage["a"]["files"] or evicted != usage["a"]["bytes"]:
            raise AssertionError(f"the watermark eviction removed {removed} ({evicted} bytes)")
        # The entry is gone: a byte this pass hits was fetched again in it.
        again = read_files(cb_a, reads[:FETCH_THREADS * 4])
        if again["gets"] == 0 or again["hit_bytes"] > again["miss_bytes"]:
            raise AssertionError(f"node A's reads after the eviction did not re-fetch: {again}")
        log(f"[21] CacheManager: node A {usage['a']}, node C {usage['c']}; gc_watermark(1) evicted A's "
            f"{len(removed)} files ({evicted} bytes) under its live CachedBlob; its next reads: {fmt(again)}")
        out.update(cache_usage=usage, evicted_files=len(removed), after_eviction=again)

        # -- 6. soci over the cache: the gzip layer read backward -------------------
        t0 = time.perf_counter()
        gz = gzip_members(tar)
        gz_id = reg.add_blob(gz).split(":")[1]
        idx, _ = soci_blob.build_index_from_gzip(gz_id, gz)
        t_idx = time.perf_counter() - t0
        cb_s = blobcache.CachedBlob(str(w / "s"), gz_id, blobcache.RegistryBlobFetcher(backend, gz_id).read_range,
                                    blob_size=len(gz), config=cfg)
        opened.append(cb_s)
        reader = SociStreamReader(idx, cb_s.read_at)
        names = sorted(idx.files)
        chosen = [names[k] for k in np.random.default_rng(SEED + 22).choice(len(names), FETCH_SOCI_READS,
                                                                             replace=False)]
        chosen.sort(key=lambda n: -idx.files[n][0])
        passes = []
        for _ in range(2):
            c0, g0, t0, per = fetch_sched.snapshot_counters(), gets(gz_id), time.perf_counter(), []
            for n in chosen:
                uoff, usize = idx.files[n]
                t1 = time.perf_counter()
                if reader.read_range(uoff, usize) != tar[uoff:uoff + usize] or tar[uoff:uoff + usize] != files[n]:
                    raise AssertionError(f"{n}: the gzip layer's read through the cache differs from the tar")
                per.append(time.perf_counter() - t1)
            passes.append({"s": time.perf_counter() - t0, "ms_per_read": 1e3 * sum(per) / len(per),
                           "gets": gets(gz_id) - g0, **delta(c0)})
        if passes[1]["miss_bytes"] or passes[1]["gets"]:
            raise AssertionError(f"the second soci pass fetched: {passes[1]}")
        log(f"[21] soci: the gzip layer ({len(gz)} bytes, {OCIREF_GZIP_MEMBERS} members; index of "
            f"{len(idx.checkpoints)} checkpoints built with the layer in {t_idx:.2f} s) read backward, "
            f"{FETCH_SOCI_READS} files == the tar through SociStreamReader over a CachedBlob: first pass "
            f"{passes[0]['ms_per_read']:.3f} ms a read, {passes[0]['gets']} GETs, {passes[0]['miss_bytes']} "
            f"bytes; second pass {passes[1]['ms_per_read']:.3f} ms a read, 0 GETs, 0 bytes")
        out["soci"] = {"layer_bytes": len(gz), "index_s": t_idx, "passes": passes}
    finally:
        for cb in opened:
            cb.close()
        reg.close()
        shutil.rmtree(w, ignore_errors=True)
        shutil.rmtree(sockdir, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    out["device"] = smi
    log(f"[21] {out['phase_s']:.1f} s on {smi}")
    return out


SERVE_READS = 256  # seeded files read through the daemon's API (and its FUSE mount), cold and warm
SERVE_THREADS = 8
SERVE_PREFETCH_FILES = 64  # the merged bootstrap's prefetch table
SERVE_REPO = "library/serve"
SERVE_EXIT_S = 5.0  # SIGTERM must end the daemon within this


def split_layers(tar: bytes, seed: int) -> tuple[bytes, bytes]:
    """The tar's members in two layer tars: a seeded half of its regular
    files in the first (with every other member), the rest in the second."""
    with tarfile.open(fileobj=io.BytesIO(tar)) as tf:
        members = list(tf)
    regular = [m for m in members if m.isreg()]
    picked = np.random.default_rng(seed).choice(len(regular), len(regular) // 2, replace=False)
    lower = {id(regular[i]) for i in picked.tolist()}
    out = []
    for want_lower in (True, False):
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
            for m in members:
                if m.isreg():
                    if (id(m) in lower) != want_lower:
                        continue
                    tf.addfile(m, io.BytesIO(tar[m.offset_data:m.offset_data + m.size]))
                elif want_lower:
                    tf.addfile(m)
        out.append(buf.getvalue())
    return out[0], out[1]


def probe_fuse_mount() -> str:
    """'' when this process can complete a FUSE mount(2), else why not
    (the daemon, a child of this process, has the same rights)."""
    import os
    import tempfile

    if not os.path.exists("/dev/fuse"):
        return "no /dev/fuse"
    libc = ctypes.CDLL("libc.so.6", use_errno=True)
    d = tempfile.mkdtemp(prefix="ntpu-fuse-probe-")
    try:
        try:
            fd = os.open("/dev/fuse", os.O_RDWR)
        except OSError as e:
            return f"open(/dev/fuse): {e.strerror}"
        try:
            opts = f"fd={fd},rootmode=40000,user_id=0,group_id=0".encode()
            if libc.mount(b"probe", d.encode(), b"fuse.probe", 1, opts) == 0:
                libc.umount2(d.encode(), 2)
                return ""
            return f"mount(2): {os.strerror(ctypes.get_errno())} (euid {os.geteuid()})"
        finally:
            os.close(fd)
    finally:
        os.rmdir(d)


def mounted(paths) -> list[str]:
    """The paths /proc/mounts lists (no I/O on the mountpoints themselves)."""
    with open("/proc/mounts") as f:
        points = {line.split()[1] for line in f}
    return [p for p in paths if p in points]


def serve_phase(dev, tar: bytes, kernels) -> dict:
    """Phase 22: the daemon's serving side over an image packed on the
    card. Phase 4's tar split into two layers, each packed fused with lz4
    (K1, K2 once per layer) and merged, is served by the port's daemon
    process (``Daemon.spawn``, with a port ``Supervisor``) from a localfs
    blob dir and from an in-process registry; reads go through the HTTP
    file API and, where mount(2) is allowed, the kernel FUSE mount; the
    daemon is SIGKILLed and its successor takes the state (and FUSE fds)
    over; the fscache ondemand loop runs in this process over a pipe;
    SIGTERM ends the daemon."""
    import os
    import shutil
    import signal
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from nydus_snapshotter_tpu_torch.converter import Merge, MergeOption, PackOption, convert, pack_layer
    from nydus_snapshotter_tpu_torch.daemon import Daemon, DaemonState, cachefiles
    from nydus_snapshotter_tpu_torch.daemon import server as server_mod
    from nydus_snapshotter_tpu_torch.daemon.daemon import ConfigState
    from nydus_snapshotter_tpu_torch.fusedev import fuse_available
    from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap
    from nydus_snapshotter_tpu_torch.models.erofs_image import erofs_from_rafs
    from nydus_snapshotter_tpu_torch.models.nydus_real import load_any_bootstrap
    from nydus_snapshotter_tpu_torch.supervisor import Supervisor
    from nydus_snapshotter_tpu_torch.tarfs import tarfs_bootstrap_from_tar

    t_phase = time.perf_counter()
    smi = nvidia_smi("name,power.limit")
    for k in kernels.values():
        k.launches = 0

    # -- 1. two layers packed on the card, merged --------------------------------
    with tarfile.open(fileobj=io.BytesIO(tar)) as tf:
        files = {"/" + m.name: tar[m.offset_data:m.offset_data + m.size] for m in tf if m.isreg()}
    rng = np.random.default_rng(SEED + 23)
    names = sorted(files)
    nonempty = [n for n in names if files[n]]
    prefetch = [nonempty[i] for i in sorted(rng.choice(len(nonempty), SERVE_PREFETCH_FILES, replace=False))]
    layers = split_layers(tar, SEED + 24)
    t0 = time.perf_counter()
    packed = []
    for layer in layers:
        with tarfile.open(fileobj=io.BytesIO(layer)) as tf:
            own = {"/" + m.name for m in tf if m.isreg()}
        pats = "\n".join(p for p in prefetch if p in own)
        packed.append(pack_layer(layer, PackOption(backend="fused", chunk_size=CHUNK_SIZE, compressor="lz4_block",
                                                   prefetch_patterns=pats), device=dev))
    pack_s = time.perf_counter() - t0
    pack_launches = {key: k.launches for key, k in kernels.items()}
    want_l = {key: 0 for key in kernels}
    want_l.update(gear=2, sha=2)
    if pack_launches != want_l:
        raise AssertionError(f"the two fused lz4 packs launched {pack_launches}; want {want_l}")
    merged = Merge([b for b, _r in packed], MergeOption(prefetch_patterns="\n".join(prefetch)))
    bs = Bootstrap.from_bytes(merged.bootstrap)
    if list(bs.prefetch) != prefetch:
        raise AssertionError(f"the merged prefetch table holds {len(bs.prefetch)} paths, not the pattern's")
    blobs = {r.blob_id: convert.blob_data_from_layer_blob(b) for b, r in packed}
    if sorted(b.blob_id for b in bs.blobs) != sorted(blobs):
        raise AssertionError(f"the merged blob table {[b.blob_id for b in bs.blobs]} is not the layers' blobs")
    by_path = {i.path: i for i in bs.inodes}
    warmed = set(prefetch)
    pool = [n for n in nonempty if n not in warmed and not by_path[n].hardlink_target]
    reads = [pool[i] for i in rng.choice(len(pool), SERVE_READS, replace=False)]
    pf_bytes = {"localfs": 0, "registry": 0}
    for p in prefetch:
        ino = by_path[p]
        for rec in bs.chunks[ino.chunk_index:ino.chunk_index + ino.chunk_count]:
            pf_bytes["localfs"] += rec.uncompressed_size
            pf_bytes["registry"] += rec.compressed_size
    log(f"[22] two layers ({len(layers[0])} + {len(layers[1])} tar bytes) packed fused with lz4 on the card in "
        f"{pack_s:.2f} s (launches {pack_launches}), merged: {len(bs.inodes)} inodes, {len(bs.chunks)} chunks, "
        f"blobs {[len(v) for v in blobs.values()]} bytes, prefetch table of {len(bs.prefetch)} files")

    w = Path(tempfile.mkdtemp(prefix="ntpu-serve-", dir="/dev/shm" if os.path.isdir("/dev/shm") else None))
    sockdir = tempfile.mkdtemp(prefix="s", dir="/tmp")
    blob_dir = w / "blobs"
    blob_dir.mkdir()
    for bid, data in blobs.items():
        (blob_dir / bid).write_bytes(data)
    boot = w / "image.boot"
    boot.write_bytes(merged.bootstrap)
    reg = OciRegistry()
    for data in blobs.values():
        reg.add_blob(data)
    mps = {"localfs": str(w / "mnt-local"), "registry": str(w / "mnt-registry")}
    for mp in mps.values():
        os.makedirs(mp)
    cfgs = {
        "localfs": json.dumps({"device": {"backend": {"type": "localfs", "config": {"blob_dir": str(blob_dir)}}}}),
        "registry": json.dumps({"device": {"backend": {"type": "registry", "config": {
            "host": reg.host, "repo": SERVE_REPO, "scheme": "http"}}, "cache": {"config": {
                "work_dir": str(w / "cache")}}}}),
    }
    fuse_why = probe_fuse_mount()
    log(f"[22] FUSE from this process: fuse_available() {fuse_available()}, mount(2) "
        f"{'allowed' if not fuse_why else 'refused: ' + fuse_why}")

    def gets() -> int:
        return sum(1 for r in reg.requests if r.startswith("GET ") and "/blobs/sha256:" in r)

    def read_api(client_fn, mp: str, names_: list) -> dict:
        def work(k):
            cli = client_fn()
            out = []
            for n in names_[k::SERVE_THREADS]:
                t1 = time.perf_counter()
                got = cli.read_file(mp, n)
                out.append(time.perf_counter() - t1)
                if got != files[n]:
                    raise AssertionError(f"{mp}{n}: the daemon's API read differs from the tar")
            return out

        g0, t1 = gets(), time.perf_counter()
        with ThreadPoolExecutor(SERVE_THREADS) as ex:
            per = np.array([x for part in ex.map(work, range(SERVE_THREADS)) for x in part]) * 1e3
        return {"files": len(per), "wall_s": time.perf_counter() - t1, "ms_median": float(np.median(per)),
                "ms_p95": float(np.percentile(per, 95)), "ms_mean": float(per.mean()), "gets": gets() - g0,
                "bytes": sum(len(files[n]) for n in names_)}

    def read_kernel(mp: str, names_: list) -> dict:
        def work(k):
            out = []
            for n in names_[k::SERVE_THREADS]:
                t1 = time.perf_counter()
                with open(mp + n, "rb") as f:
                    got = f.read()
                out.append(time.perf_counter() - t1)
                if got != files[n]:
                    raise AssertionError(f"{mp}{n}: the kernel FUSE read differs from the tar")
            return out

        g0, t1 = gets(), time.perf_counter()
        with ThreadPoolExecutor(SERVE_THREADS) as ex:
            per = np.array([x for part in ex.map(work, range(SERVE_THREADS)) for x in part]) * 1e3
        return {"files": len(per), "wall_s": time.perf_counter() - t1, "ms_median": float(np.median(per)),
                "ms_p95": float(np.percentile(per, 95)), "gets": gets() - g0}

    def fmt(r: dict) -> str:
        return (f"{r['files']} files in {r['wall_s']:.3f} s, {r['ms_median']:.3f} ms a read median, "
                f"{r['ms_p95']:.3f} ms p95, {r['gets']} registry GETs")

    out: dict = {"pack_s": pack_s, "pack_launches": pack_launches, "blob_bytes": [len(v) for v in blobs.values()],
                 "chunks": len(bs.chunks), "fuse_probe": fuse_why or "allowed"}
    sup = Supervisor("serve", os.path.join(sockdir, "sup.sock"))
    sup.start()
    states = ConfigState(daemon_id="serve", api_socket=os.path.join(sockdir, "api.sock"), workdir=str(w),
                         supervisor_path=sup.sock_path, log_file=str(w / "daemon.log"))
    daemon = Daemon(states)
    procs = []  # every daemon process this phase started
    try:
        # -- 2. the port's daemon process, no CUDA context -------------------------
        argv = daemon.command().build()
        t0 = time.perf_counter()
        daemon.spawn()
        procs.append(daemon._proc)
        cli = daemon.client()
        cli.wait_until_socket_exists(60)
        daemon.wait_until_state(DaemonState.READY, timeout=30)
        start_s = time.perf_counter() - t0
        pid = daemon.pid
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            cmdline = [a.decode() for a in f.read().split(b"\0") if a]
        if cmdline != argv or cmdline[1:3] != ["-m", "nydus_snapshotter_tpu_torch.daemon.server"]:
            raise AssertionError(f"the daemon runs {cmdline}, not the port's server {argv}")
        apps = compute_pids()
        d_fds, d_libs = cuda_handles(pid)
        s_fds, s_libs = cuda_handles(os.getpid())
        if pid in apps or d_fds or any(n.startswith("libcuda.") for n in d_libs):
            raise AssertionError(f"the daemon (pid {pid}) holds a CUDA context: compute apps {apps}, "
                                 f"/dev/nvidia files {d_fds}, libraries {d_libs}")
        log(f"[22] the port's daemon: {' '.join(cmdline)} (pid {pid}, READY {1e3 * start_s:.0f} ms after spawn); "
            f"compute apps on the card {apps} (this script {os.getpid()}{'' if os.getpid() in apps else ', not listed'})"
            f"; the daemon has no /dev/nvidia file open and maps {d_libs or 'no CUDA or torch library'} (this "
            f"script: {len(s_fds)} /dev/nvidia files, {s_libs}): it holds no CUDA context")
        out["daemon"] = {"ready_ms": 1e3 * start_s, "libs": d_libs}

        # -- 3. mounts: localfs and registry, the kernel mount where allowed --------
        for kind in ("localfs", "registry"):
            cli.mount(mps[kind], str(boot), cfgs[kind])
        cli.start()
        daemon.wait_until_state(DaemonState.RUNNING, timeout=10)
        kernel_mounts = mounted(mps.values())
        log(f"[22] mounted the merged bootstrap twice (localfs blob dir; registry at the fetch defaults): kernel "
            f"FUSE mounts {'made at ' + str(kernel_mounts) if kernel_mounts else 'not made (mount(2) from this process: ' + (fuse_why or 'allowed') + ')'}; "
            "the daemon serves its HTTP file API either way")
        out["kernel_mounts"] = len(kernel_mounts)

        # prefetch grows with no client read
        t0 = time.perf_counter()
        want_pf = pf_bytes["localfs"] + pf_bytes["registry"]
        amount, first_seen = 0, None
        while time.perf_counter() - t0 < 60:
            amount = cli.cache_metrics()["prefetch_data_amount"]
            if amount and first_seen is None:
                first_seen = time.perf_counter() - t0
            if amount >= want_pf:
                break
            time.sleep(0.01)
        fsm = cli.fs_metrics()
        if amount != want_pf or fsm["data_read"] != 0 or first_seen is None:
            raise AssertionError(f"prefetch_data_amount {amount} (want {want_pf}) with {fsm['data_read']} bytes "
                                 "of client reads")
        prefetch_s = time.perf_counter() - t0
        log(f"[22] prefetch_data_amount grew to {amount} bytes ({pf_bytes['localfs']} localfs, "
            f"{pf_bytes['registry']} registry compressed) in {prefetch_s:.3f} s with no client read "
            f"(first bytes after {1e3 * first_seen:.1f} ms)")
        out["prefetch"] = {"bytes": amount, "s": prefetch_s}

        # -- 4. reads: API (and kernel) cold then warm -----------------------------------
        passes = {}
        bc0 = cli.cache_metrics()
        # localfs first: the registry passes leave readahead flights that
        # would count as GETs in a later pass
        for kind in ("localfs", "registry"):
            for temp in ("cold", "warm"):
                r = read_api(daemon.client, mps[kind], reads)
                passes[f"{kind}_{temp}"] = r
                log(f"[22] API {kind} {temp}: {fmt(r)}")
        bc1 = cli.cache_metrics()
        fetched = {k: bc1[k] - bc0[k] for k in ("miss_bytes", "hit_bytes", "fetch_requests", "readahead_bytes",
                                                "coalesced_requests")}
        if passes["registry_cold"]["gets"] == 0 or passes["localfs_cold"]["gets"] or passes["localfs_warm"]["gets"]:
            raise AssertionError(f"registry GETs in the wrong passes: {passes}")
        log(f"[22] /api/v1/metrics/blobcache over the reads: {fetched}")
        for bid in blobs:
            t1 = time.time()
            while True:  # a readahead flight still landing is not yet accounted
                code, body = uds_get(states.api_socket, f"/api/v1/provenance?blob={bid}")
                view = json.loads(body)
                if code == 200 and view["conservation"]["exact"] or time.time() - t1 > 10:
                    break
                time.sleep(0.05)
            if code != 200 or not view["conservation"]["exact"]:
                raise AssertionError(f"/api/v1/provenance for {bid[:12]}: {code} {view}")
            log(f"[22] /api/v1/provenance {bid[:12]}..: conserves {view['conservation']['fetched_bytes']} "
                "fetched bytes")
        if kernel_mounts:
            for kind in ("registry", "localfs"):
                r = read_kernel(mps[kind], reads)
                passes[f"{kind}_kernel"] = r
                log(f"[22] kernel FUSE {kind}: {fmt(r)}")
        out.update(reads=passes, blobcache=fetched)

        # -- 5. takeover: SIGKILL, the successor takes state and fds ---------------------
        if not sup.wait_for_state(10):
            raise AssertionError("the daemon pushed no state to the supervisor")
        deadline = time.time() + 10
        while time.time() < deadline:
            held = {i["mountpoint"] for i in json.loads(sup.fetch_state())["instances"]}
            if held == set(mps.values()):
                break
            time.sleep(0.05)
        else:
            raise AssertionError(f"the supervisor holds {held}")
        time.sleep(0.2)
        t_kill = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        daemon.wait(timeout=10)
        daemon.spawn(upgrade=True)
        procs.append(daemon._proc)
        cli = daemon.client()
        cli.wait_until_socket_exists(60)
        cli.takeover()
        cli.start()
        got = cli.read_file(mps["registry"], reads[0])
        first = time.perf_counter() - t_kill
        if got != files[reads[0]]:
            raise AssertionError("the successor's first read differs from the tar")
        kernel_after = mounted(mps.values())
        if kernel_after != kernel_mounts:
            raise AssertionError(f"kernel mounts {kernel_mounts} before the kill, {kernel_after} after")
        after = {kind: read_api(daemon.client, mps[kind], reads) for kind in ("registry", "localfs")}
        if kernel_mounts:
            after.update({f"{kind}_kernel": read_kernel(mps[kind], reads) for kind in ("registry", "localfs")})
        info = cli.get_daemon_info()
        log(f"[22] takeover: SIGKILL -> successor (pid {daemon.pid}, {info['state']}) served its first read "
            f"{1e3 * first:.1f} ms after the kill; then {', '.join(f'{k}: {fmt(r)}' for k, r in after.items())}")
        out["takeover"] = {"kill_to_first_read_ms": 1e3 * first, "reads": after}

        # -- 6. fscache: bind_blob and the ondemand loop over a pipe ---------------------
        lower_tarfs = [tarfs_bootstrap_from_tar(io.BytesIO(layer), hashlib.sha256(layer).hexdigest())
                       for layer in layers]
        tarfs_boot = w / "tarfs.boot"
        tarfs_boot.write_bytes(Merge(lower_tarfs, MergeOption()).bootstrap)
        want_meta = erofs_from_rafs(load_any_bootstrap(tarfs_boot.read_bytes()))
        backend = {"type": "localfs", "config": {"blob_dir": str(blob_dir)}}
        if not cachefiles.supported():  # the kernel's own device stays untouched
            cli.bind_blob(json.dumps({"id": bs.blobs[0].blob_id, "device": {"backend": backend}}))
            cli.unbind_blob("", bs.blobs[0].blob_id)
        fs_srv = server_mod.DaemonServer("fscache", os.path.join(sockdir, "fs.sock"), workdir=str(w))
        r_fd, w_fd = os.pipe()

        class PipeDevice(cachefiles.DeviceIO):
            def __init__(self, fd: int):
                super().__init__(fd)
                self.writes, self.ioctls = [], []

            def write(self, b):
                self.writes.append(bytes(b))
                return len(b)

            def ioctl(self, obj_fd, req, arg):
                self.ioctls.append(arg)

        dev_io = PipeDevice(r_fd)
        ondemand = cachefiles.CachefilesOndemandDaemon(fs_srv._resolve_cachefiles_cookie, device=dev_io)
        fs_srv._cachefiles = ondemand  # the injected device: bind_blob finds its ondemand daemon running
        ondemand.start()
        fs_srv.bind_blob(json.dumps({"id": bs.blobs[0].blob_id, "metadata_path": str(tarfs_boot),
                                     "fscache_id": "fsid-tarfs", "device": {"backend": backend}}))
        fs_srv.bind_blob(json.dumps({"id": bs.blobs[1].blob_id, "metadata_path": str(boot),
                                     "fscache_id": "fsid-lz4", "device": {"backend": backend}}))
        objs = {}
        msg_id = 0

        def send(obj: int, opcode: int, payload: bytes) -> int:
            nonlocal msg_id
            msg_id += 1
            os.write(w_fd, cachefiles._MSG_HDR.pack(msg_id, obj, opcode, 16 + len(payload)) + payload)
            return msg_id

        def open_obj(obj: int, cookie: str) -> int:
            path = w / f"obj{obj}"
            fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
            objs[obj] = path
            key = cookie.encode() + b"\0"
            return send(obj, cachefiles.OP_OPEN, cachefiles._OPEN_HDR.pack(6, len(key), fd, 0) + b"erofs\0" + key)

        def wait_for(pred, what: str):
            t1 = time.time()
            while not pred():
                if time.time() - t1 > 30:
                    raise AssertionError(f"the ondemand loop did not answer {what}: {dev_io.writes}")
                time.sleep(0.002)

        t0 = time.perf_counter()
        m1 = open_obj(1, "fsid-tarfs")
        m2 = open_obj(2, bs.blobs[1].blob_id)
        m3 = open_obj(3, "fsid-lz4")
        wait_for(lambda: len(dev_io.writes) == 3, "three OPENs")
        blob1 = blobs[bs.blobs[1].blob_id]
        want_copens = [f"copen {m1},{len(want_meta)}".encode(), f"copen {m2},{len(blob1)}".encode(),
                       f"copen {m3},-2".encode()]
        if dev_io.writes != want_copens:
            raise AssertionError(f"copen answers {dev_io.writes}, want {want_copens}")
        windows = [(0, len(want_meta), 1)]
        wr = np.random.default_rng(SEED + 25)
        for _ in range(3):
            off = int(wr.integers(0, len(blob1)))
            windows.append((off, int(wr.integers(1, 4 << 20)), 2))
        for off, ln, obj in windows:
            send(obj, cachefiles.OP_READ, cachefiles._READ_REQ.pack(off, ln))
        wait_for(lambda: len(dev_io.ioctls) == len(windows), "the READs")
        meta = objs[1].read_bytes()
        if meta != want_meta:
            raise AssertionError("the meta cookie's bytes differ from erofs_from_rafs of the merged tarfs bootstrap")
        got2 = objs[2].read_bytes()
        for off, ln, obj in windows[1:]:
            end = min(off + ln, len(blob1))
            if got2[off:end] != blob1[off:end]:
                raise AssertionError(f"the READ window {off}+{ln} differs from the blob's bytes")
        send(1, cachefiles.OP_CLOSE, b"")
        send(2, cachefiles.OP_CLOSE, b"")
        wait_for(lambda: not ondemand.objects, "the CLOSEs")
        fscache_s = time.perf_counter() - t0
        ondemand.stop()
        os.close(w_fd)
        log(f"[22] fscache: bind_blob on the daemon's API (204) and in process; the ondemand loop over a pipe "
            f"answered copen for the meta cookie ({len(want_meta)} bytes == erofs_from_rafs of the two layers' "
            f"merged tarfs bootstrap; the lz4 image's meta cookie refused, -2: EROFS export needs identity-mapped "
            f"chunks), the blob cookie ({len(blob1)} bytes) and {len(windows)} READ windows equal to their bytes, "
            f"in {fscache_s:.3f} s")
        out["fscache"] = {"meta_bytes": len(want_meta), "windows": len(windows), "s": fscache_s}

        # -- 7. SIGTERM ---------------------------------------------------------------
        t0 = time.perf_counter()
        daemon.terminate()
        daemon._proc.wait(timeout=SERVE_EXIT_S)
        exit_s = time.perf_counter() - t0
        left = mounted(mps.values())
        if exit_s > SERVE_EXIT_S or os.path.exists(states.api_socket) or left:
            raise AssertionError(f"SIGTERM: exit after {exit_s:.2f} s, socket left "
                                 f"{os.path.exists(states.api_socket)}, mounts left {left}")
        log(f"[22] SIGTERM ended the daemon in {1e3 * exit_s:.0f} ms (rc {daemon._proc.returncode}); its socket "
            "is removed and no mount is left")
        out["sigterm_ms"] = 1e3 * exit_s
    except Exception:
        log_path = w / "daemon.log"
        if log_path.exists():
            log("[22] the daemon's log, last 4000 bytes:\n" + log_path.read_text(errors="replace")[-4000:])
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        for mp in mounted(mps.values()):
            ctypes.CDLL("libc.so.6").umount2(mp.encode(), 2)
        sup.stop()
        reg.close()
        shutil.rmtree(w, ignore_errors=True)
        shutil.rmtree(sockdir, ignore_errors=True)
    launches = {key: k.launches for key, k in kernels.items()}
    if launches != want_l:
        raise AssertionError(f"phase 22 launched {launches}; the packs only {want_l}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    out["device"] = smi
    log(f"[22] {out['phase_s']:.1f} s on {smi}")
    return out


def cuda_handles(pid: int) -> tuple[list[str], list[str]]:
    """A process's open /dev/nvidia* files and its mapped CUDA or torch
    libraries: a CUDA context holds the first and maps libcuda."""
    import os

    fds = []
    for fd in os.listdir(f"/proc/{pid}/fd"):
        with contextlib.suppress(OSError):
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
            if target.startswith("/dev/nvidia"):
                fds.append(target)
    with open(f"/proc/{pid}/maps") as f:
        libs = {line.split()[-1].rsplit("/", 1)[-1] for line in f if ".so" in line}
    return sorted(set(fds)), sorted(n for n in libs if n.startswith(("libcuda", "libtorch", "libcudart")))


def compute_pids() -> list[int]:
    """The pids ``nvidia-smi --query-compute-apps=pid`` lists."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


# ---------------------------------------------------------------------------
# Phase 23: a container start through the snapshots service
# ---------------------------------------------------------------------------

SNAP_READS = 256  # seeded files read from each container, from SNAP_THREADS threads
SNAP_THREADS = 8
SNAP_RPC_REPS = 32  # extra Stat, Mounts and Walk calls on the running stack, for their spread
SNAP_REPO = "library/snap"
SNAP_IMAGE_REF = "registry.example.com/library/snap-nydus:latest"


def probe_loop_erofs(where: str) -> str:
    """'' when this process can attach a loop device and mount(2) a
    filesystem, and the kernel knows EROFS; else the operating system's
    reason. (The tarfs mounts need all three.)"""
    import os
    import tempfile

    if not os.path.exists("/dev/loop-control"):
        return "no /dev/loop-control"
    with open("/proc/filesystems") as f:
        if "erofs" not in f.read().split():
            return "erofs is not in /proc/filesystems"
    from nydus_snapshotter_tpu_torch.utils import losetup

    d = tempfile.mkdtemp(prefix="lp", dir=where)
    try:
        img = os.path.join(d, "img")
        with open(img, "wb") as f:
            f.write(b"\0" * 4096)
        try:
            dev = losetup.KernelBackend().attach(img)
        except OSError as e:
            return f"loop attach: {e}"
        losetup.KernelBackend().detach(dev)
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        mnt = os.path.join(d, "m")
        os.mkdir(mnt)
        if libc.mount(b"none", mnt.encode(), b"tmpfs", 0, b"size=4k") != 0:
            return f"mount(2): {os.strerror(ctypes.get_errno())} (euid {os.geteuid()})"
        libc.umount2(mnt.encode(), 2)
        return ""
    finally:
        import shutil

        shutil.rmtree(d, ignore_errors=True)


def merged_view(layer_tars: list[bytes]) -> dict[str, bytes]:
    """path -> bytes of the regular files an overlay of ``layer_tars``
    (bottom first) shows: a ``.wh.<name>`` removes ``<name>`` below it, a
    ``.wh..wh..opq`` every lower entry under its directory."""
    view: dict[str, bytes] = {}
    for raw in layer_tars:
        with tarfile.open(fileobj=io.BytesIO(raw)) as tf:
            members = list(tf)
        for m in members:
            name = "/" + m.name.strip("/")
            base = name.rsplit("/", 1)
            if base[1] == ".wh..wh..opq":
                view = {p: v for p, v in view.items() if not p.startswith(base[0] + "/")}
            elif base[1].startswith(".wh."):
                gone = base[0] + "/" + base[1][4:]
                view = {p: v for p, v in view.items() if p != gone and not p.startswith(gone + "/")}
        for m in members:
            if m.isreg() and not m.name.rsplit("/", 1)[-1].startswith(".wh."):
                view["/" + m.name.strip("/")] = raw[m.offset_data:m.offset_data + m.size]
    return view


def tarfs_host_reader(merged_boot: bytes, tar_path_of) -> callable:
    """Reads a file of a merged tarfs bootstrap straight from its layers'
    tar files (``tar_path_of(blob_id)``): what the EROFS mount serves,
    through the chunk table instead of the kernel."""
    from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap

    bs = Bootstrap.from_bytes(merged_boot)
    by_path = {i.path: i for i in bs.inodes}
    tars = [np.memmap(tar_path_of(b.blob_id), dtype=np.uint8, mode="r") for b in bs.blobs]

    def read(path: str) -> bytes:
        ino = by_path[path]
        if ino.hardlink_target:
            ino = by_path[ino.hardlink_target]
        return b"".join(
            tars[c.blob_index][c.uncompressed_offset:c.uncompressed_offset + c.uncompressed_size].tobytes()
            for c in bs.chunks[ino.chunk_index:ino.chunk_index + ino.chunk_count])

    read.paths = set(by_path)
    return read


def pid_alive(pid: int) -> bool:
    """The process exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def snapshot_phase(dev, tar: bytes, kernels) -> dict:
    """Phase 23: a container start through the snapshots service. The
    port's stack (``SnapshotterConfig``, ``Database``, ``Manager`` for
    fusedev and blockdev, ``CacheManager``, ``tarfs.Manager`` on the
    card's engine, ``Filesystem``, ``Snapshotter``, ``api.service.serve``
    on a UDS) driven by ``SnapshotsClient`` through containerd's pull
    transcripts of a nydus image packed on the card and of phase 19's
    tarfs image; reads through each container; a snapshotter restart over
    the live daemon, a SIGKILL of the daemon, and a teardown that leaves
    nothing."""
    import os
    import select
    import shutil
    import signal
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import grpc

    from nydus_snapshotter_tpu_torch import constants as C
    from nydus_snapshotter_tpu_torch import tarfs
    from nydus_snapshotter_tpu_torch.api.client import SnapshotsClient
    from nydus_snapshotter_tpu_torch.api.service import serve
    from nydus_snapshotter_tpu_torch.cache.manager import CacheManager
    from nydus_snapshotter_tpu_torch.config.config import SnapshotterConfig
    from nydus_snapshotter_tpu_torch.config.daemonconfig import DaemonRuntimeConfig
    from nydus_snapshotter_tpu_torch.converter import Merge, MergeOption, PackOption, convert, pack_layer
    from nydus_snapshotter_tpu_torch.daemon import daemon as daemon_mod
    from nydus_snapshotter_tpu_torch.filesystem import Filesystem
    from nydus_snapshotter_tpu_torch.manager import Manager
    from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine
    from nydus_snapshotter_tpu_torch.remote import remote as remote_mod
    from nydus_snapshotter_tpu_torch.snapshot.snapshotter import Snapshotter
    from nydus_snapshotter_tpu_torch.store import Database
    from nydus_snapshotter_tpu_torch.utils import losetup
    from nydus_snapshotter_tpu_torch.utils import mount as mount_utils

    t_phase = time.perf_counter()
    smi = nvidia_smi("name,power.limit")
    for k in kernels.values():
        k.launches = 0

    # -- 1. the nydus image: two layers packed on the card, merged ---------------
    t0 = time.perf_counter()
    layers = split_layers(tar, SEED + 31)
    packed = [pack_layer(layer, PackOption(backend="fused", chunk_size=CHUNK_SIZE, compressor="lz4_block"),
                         device=dev) for layer in layers]
    pack_s = time.perf_counter() - t0
    pack_launches = {key: k.launches for key, k in kernels.items()}
    want_pack = {key: 0 for key in kernels}
    want_pack.update(gear=2, sha=2)
    if pack_launches != want_pack:
        raise AssertionError(f"the two fused lz4 packs launched {pack_launches}; want {want_pack}")
    merged = Merge([b for b, _r in packed], MergeOption())
    blobs = {r.blob_id: convert.blob_data_from_layer_blob(b) for b, r in packed}
    nydus_files = merged_view(list(layers))
    rng = np.random.default_rng(SEED + 32)
    nonempty = sorted(p for p, v in nydus_files.items() if v)
    nydus_reads = [nonempty[i] for i in rng.choice(len(nonempty), SNAP_READS, replace=False)]
    log(f"[23] nydus image: phase 4's tar as two layers ({len(layers[0])} + {len(layers[1])} tar bytes) packed "
        f"fused with lz4 on the card in {pack_s:.2f} s (launches {pack_launches}), merged: blobs "
        f"{[len(v) for v in blobs.values()]} bytes, bootstrap {len(merged.bootstrap)} bytes")

    # -- 2. the tarfs image: phase 19's three layers behind the registry ---------
    t0 = time.perf_counter()
    t_layers = tarfs_layers(tar)
    reg = OciRegistry()
    mdigest, ldigests = reg.publish(
        "v1", [(blob, "sha256:" + hashlib.sha256(raw).hexdigest()) for blob, raw in t_layers],
        annotations={C.TARFS_HINT: "true"})
    tref = f"{reg.host}/{SNAP_REPO}:v1"
    tarfs_files = merged_view([raw for _b, raw in t_layers])
    tnonempty = sorted(p for p, v in tarfs_files.items() if v)
    tarfs_reads = [tnonempty[i] for i in rng.choice(len(tnonempty), SNAP_READS, replace=False)]
    log(f"[23] tarfs image: phase 19's {len(t_layers)} layers (blobs "
        + ", ".join(str(len(b)) for b, _t in t_layers) + f" bytes) published on {reg.host} with the tarfs "
        f"hint in {time.perf_counter() - t0:.1f} s")

    where = "/dev/shm" if os.path.isdir("/dev/shm") else "/tmp"
    loop_why = probe_loop_erofs(where)
    real_mounts = not loop_why
    saved_backends = (losetup.backend, mount_utils.backend)
    if not real_mounts:
        losetup.backend, mount_utils.backend = LoopRecorder(losetup), MountRecorder()
    log(f"[23] loop devices and EROFS mounts: "
        + ("made (loop attach and mount(2) allowed, erofs in /proc/filesystems)" if real_mounts else
           f"recorded (utils.losetup / utils.mount backends replaced, as phase 19): {loop_why}"))

    # every daemon the stack spawns: its command line, no CUDA context
    spawned: list[tuple[int, list[str]]] = []
    spawn = daemon_mod.Daemon.spawn

    def checked_spawn(self, *a, **kw):
        pid = spawn(self, *a, **kw)
        t1 = time.time()
        argv: list[str] = []
        while not argv and time.time() - t1 < 5:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = [x.decode() for x in f.read().split(b"\0") if x]
        if argv[1:3] != ["-m", "nydus_snapshotter_tpu_torch.daemon.server"]:
            raise AssertionError(f"the stack spawned {argv}, not the port's daemon server")
        spawned.append((pid, argv))
        return pid

    daemon_mod.Daemon.spawn = checked_spawn
    rpc_ms: dict[str, list[float]] = {}
    w = Path(tempfile.mkdtemp(prefix="n23", dir=where))
    root = str(w / "r")
    index_s: dict[str, float] = {}
    digest_calls: list[tuple[str, int, float]] = []

    def mk_stack():
        """The stack ``cmd/snapshotter.py`` builds, with the tarfs engine of
        ``accel_backend = "jax"`` on this card."""
        cfg = SnapshotterConfig(root=root)
        cfg.daemon.recover_policy = C.RECOVER_POLICY_RESTART
        cfg.validate()
        db = Database(cfg.database_path)
        mgr = Manager(cfg, db, fs_driver=C.FS_DRIVER_FUSEDEV)
        blk = Manager(cfg, db, fs_driver=C.FS_DRIVER_BLOCKDEV)
        eng = ChunkDigestEngine(chunk_size=tarfs.DEFAULT_CHUNK_SIZE, mode="fixed", backend="jax", device=dev)
        digest_many = eng.digest_many

        def timed_digest_many(datas):
            t1 = time.perf_counter()
            out = digest_many(datas)
            digest_calls.append((threading.current_thread().name, len(datas), time.perf_counter() - t1))
            return out

        eng.digest_many = timed_digest_many
        tm = tarfs.Manager(cache_dir_path=cfg.cache_root, mount_on_host=True, insecure=True, engine=eng)
        gen = tm._generate_bootstrap

        def timed_gen(tar_bytes, snapshot_id, blob_id, upper):
            t1 = time.perf_counter()
            gen(tar_bytes, snapshot_id, blob_id, upper)
            index_s[snapshot_id] = time.perf_counter() - t1

        tm._generate_bootstrap = timed_gen
        fs = Filesystem(
            managers={C.FS_DRIVER_FUSEDEV: mgr, C.FS_DRIVER_BLOCKDEV: blk},
            cache_mgr=CacheManager(cfg.cache_root), root=cfg.root, fs_driver=C.FS_DRIVER_FUSEDEV,
            daemon_mode=C.DAEMON_MODE_SHARED,
            daemon_config=DaemonRuntimeConfig.from_dict({"device": {"backend": {"type": "localfs"}}},
                                                        C.FS_DRIVER_FUSEDEV),
            tarfs_mgr=tm,
        )
        fs.startup()
        mgr.run_death_handler()
        sn = Snapshotter(root=cfg.root, fs=fs)
        sock = os.path.join(cfg.root, "grpc.sock")
        server = serve(sn, sock)
        client = SnapshotsClient(sock, timeout=600.0)
        call = client._call

        def timed_call(name, req):
            t1 = time.perf_counter()
            try:
                return call(name, req)
            finally:
                rpc_ms.setdefault(name, []).append((time.perf_counter() - t1) * 1e3)

        client._call = timed_call
        return dict(cfg=cfg, db=db, mgr=mgr, blk=blk, tm=tm, fs=fs, sn=sn, server=server, client=client)

    def walk(st) -> list:
        t1 = time.perf_counter()
        got = st["client"].list()
        rpc_ms.setdefault("Walk", []).append((time.perf_counter() - t1) * 1e3)
        return sorted((i.name, i.parent, i.kind, sorted(i.labels.items())) for i in got)

    def close(st, teardown: bool):
        st["client"].close()
        st["server"].stop(grace=None)
        if teardown:
            st["fs"].teardown()
        st["sn"].close()
        st["mgr"].stop()
        st["blk"].stop()

    def lowerdir(mounts) -> str:
        for m in mounts:
            for o in m.options:
                if o.startswith("lowerdir="):
                    return o[len("lowerdir="):].split(":")[0]
        raise AssertionError(f"no overlay lowerdir in {mounts}")

    def read_many(read_one, names: list, want: dict) -> dict:
        def work(k):
            out = []
            for n in names[k::SNAP_THREADS]:
                t1 = time.perf_counter()
                got = read_one(n)
                out.append(time.perf_counter() - t1)
                if got != want[n]:
                    raise AssertionError(f"{n}: the container's read differs from the tar")
            return out

        t1 = time.perf_counter()
        with ThreadPoolExecutor(SNAP_THREADS) as ex:
            per = np.array([x for part in ex.map(work, range(SNAP_THREADS)) for x in part]) * 1e3
        return {"files": len(per), "wall_s": time.perf_counter() - t1, "ms_median": float(np.median(per)),
                "ms_p95": float(np.percentile(per, 95)), "bytes": sum(len(want[n]) for n in names)}

    def fmt(r: dict) -> str:
        return (f"{r['files']} files ({r['bytes']} bytes) in {r['wall_s']:.3f} s, {r['ms_median']:.3f} ms a read "
                f"median, {r['ms_p95']:.3f} ms p95")

    out: dict = {"pack_s": pack_s, "pack_launches": pack_launches, "loop_erofs": loop_why or "made"}
    st = None
    import logging

    records: list[str] = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(f"{record.name} {record.levelname}: {record.getMessage()}")

    keep = Keep(level=logging.INFO)
    pkg_log = logging.getLogger("nydus_snapshotter_tpu_torch")
    pkg_level = pkg_log.level
    pkg_log.addHandler(keep)
    pkg_log.setLevel(logging.INFO)
    try:
        with plain_http_remote(remote_mod):
            t0 = time.perf_counter()
            st = mk_stack()
            shared = st["fs"].get_shared_daemon(C.FS_DRIVER_FUSEDEV)
            log(f"[23] stack on {root} up in {time.perf_counter() - t0:.2f} s: the shared daemon spawned by "
                f"Manager, {' '.join(spawned[-1][1])} (pid {shared.pid})")
            client, sn, fs = st["client"], st["sn"], st["fs"]

            # -- 3. the nydus image's pull transcript, then the container ---------
            os.makedirs(fs.cache_mgr.cache_dir, exist_ok=True)
            for bid, data in blobs.items():
                Path(fs.cache_mgr.cache_dir, bid).write_bytes(data)
            t_img = time.perf_counter()
            parent, n_chains = "", []
            layer_ids = [f"sha256:{bid}" for bid in blobs] + ["sha256:" + hashlib.sha256(merged.bootstrap).hexdigest()]
            for i, layer_digest in enumerate(layer_ids):
                chain = f"sha256:nydus-chain-{i}"
                data = i < len(blobs)
                labels = {C.CRI_IMAGE_REF: SNAP_IMAGE_REF, C.CRI_LAYER_DIGEST: layer_digest,
                          C.CRI_IMAGE_LAYERS: ",".join(layer_ids), C.TARGET_SNAPSHOT_REF: chain,
                          (C.NYDUS_DATA_LAYER if data else C.NYDUS_META_LAYER): "true"}
                key = f"extract-{i} {chain}"
                try:
                    client.stat(chain)
                    raise AssertionError(f"{chain} exists before its pull")
                except grpc.RpcError as e:
                    if e.code() != grpc.StatusCode.NOT_FOUND:
                        raise
                if data:  # the snapshotter commits the blob layer itself: containerd skips it
                    try:
                        client.prepare(key, parent, labels)
                        raise AssertionError("a nydus data layer's Prepare did not answer ALREADY_EXISTS")
                    except grpc.RpcError as e:
                        if e.code() != grpc.StatusCode.ALREADY_EXISTS:
                            raise
                else:  # the bootstrap layer: containerd unpacks image.boot, then commits
                    client.prepare(key, parent, labels)
                    sid = sn.ms.get_snapshot(key).id
                    image_dir = Path(sn.upper_path(sid), "image")
                    image_dir.mkdir(parents=True, exist_ok=True)
                    (image_dir / "image.boot").write_bytes(merged.bootstrap)
                    client.commit(chain, key, {k: v for k, v in labels.items() if k != C.TARGET_SNAPSHOT_REF})
                n_chains.append(chain)
                parent = chain
            client.prepare("default/1/nydus-ctr", parent, {C.CRI_IMAGE_REF: SNAP_IMAGE_REF})
            n_mounts = client.mounts("default/1/nydus-ctr")
            nydus_start_ms = (time.perf_counter() - t_img) * 1e3
            meta_sid = sn.ms.get_snapshot(n_chains[-1]).id
            rafs = fs.instances.get(meta_sid)
            shared = fs.get_shared_daemon(C.FS_DRIVER_FUSEDEV)
            if rafs is None or rafs.daemon_id != shared.id or not lowerdir(n_mounts).startswith(rafs.mountpoint):
                raise AssertionError(f"Mounts {n_mounts} do not name the shared daemon's instance {rafs}")
            apps = compute_pids()
            d_fds, d_libs = cuda_handles(shared.pid)
            if shared.pid in apps or d_fds or any(n.startswith("libcuda.") for n in d_libs):
                raise AssertionError(f"the daemon (pid {shared.pid}) holds a CUDA context: compute apps {apps}, "
                                     f"/dev/nvidia files {d_fds}, libraries {d_libs}")
            log(f"[23] nydus container: {len(n_chains)} layers pulled (two data layers answered ALREADY_EXISTS, "
                f"the bootstrap layer prepared, unpacked and committed), the container's Prepare and Mounts "
                f"{nydus_start_ms:.1f} ms after the first layer's Prepare; Mounts: {n_mounts[0].type} lowerdir "
                f"{lowerdir(n_mounts)} = instance {meta_sid} of daemon {shared.id} (pid {shared.pid}); the daemon "
                f"is not among the compute apps {apps}, has no /dev/nvidia file and maps "
                f"{d_libs or 'no CUDA or torch library'}")
            n_mnt = lowerdir(n_mounts)
            n_kernel = bool(mounted([rafs.mountpoint]))

            def nydus_reader(fs_):
                if n_kernel:
                    return lambda p: Path(n_mnt + p).read_bytes()
                d = fs_.get_shared_daemon(C.FS_DRIVER_FUSEDEV)
                return lambda p: d.client().read_file(f"/{meta_sid}", p)

            reads = {"nydus": read_many(nydus_reader(fs), nydus_reads, nydus_files)}
            log(f"[23] nydus reads through the daemon's "
                + ("kernel FUSE mount" if n_kernel else
                   f"file API (the shared daemon serves instances at /<id> in its own namespace: no kernel "
                   f"mount at {rafs.mountpoint})") + f": {fmt(reads['nydus'])}")

            # -- 4. the tarfs image's pull transcript, then the container ---------
            for k in kernels.values():
                k.launches = 0
            digest_calls.clear()
            t_img = time.perf_counter()
            parent, t_chains = "", []
            for i, ld in enumerate(ldigests):
                chain = f"sha256:tarfs-chain-{i}"
                labels = {C.CRI_IMAGE_REF: tref, C.CRI_MANIFEST_DIGEST: mdigest, C.CRI_LAYER_DIGEST: ld,
                          C.CRI_IMAGE_LAYERS: ",".join(ldigests), C.TARGET_SNAPSHOT_REF: chain}
                try:
                    client.prepare(f"extract-t{i} {chain}", parent, labels)
                    raise AssertionError("a tarfs layer's Prepare did not answer ALREADY_EXISTS")
                except grpc.RpcError as e:
                    if e.code() != grpc.StatusCode.ALREADY_EXISTS:
                        raise
                info = client.stat(chain)
                if info.labels.get(C.NYDUS_TARFS_LAYER) != ld.split(":", 1)[1]:
                    raise AssertionError(f"layer {i} took no tarfs route (a quiet fallback): labels {dict(info.labels)}")
                t_chains.append(chain)
                parent = chain
            client.prepare("default/2/tarfs-ctr", parent, {C.CRI_IMAGE_REF: tref})
            t_mounts = client.mounts("default/2/tarfs-ctr")
            tarfs_start_ms = (time.perf_counter() - t_img) * 1e3
            t_launches = {key: k.launches for key, k in kernels.items() if k.launches}
            sids = [sn.ms.get_snapshot(c).id for c in t_chains]
            builders = sorted(c[0] for c in digest_calls)
            if t_launches != {"sha": len(t_layers)} or builders != sorted(f"tarfs-blob-{s}" for s in sids):
                raise AssertionError(f"the tarfs pull launched {t_launches} over digest_many calls {digest_calls}; "
                                     f"want K2 once per layer index build ({len(t_layers)})")
            tm = st["tm"]
            merged_t = Path(tm.image_meta_file_path(sn.upper_path(sids[-1]))).read_bytes()
            # the host route: the reference's engine-less manager over the same registry
            host = tarfs.Manager(cache_dir_path=str(w / "host-cache"), engine=None)
            host_uppers = {}
            t0 = time.perf_counter()
            for sid, ld in zip(sids, ldigests):
                host_uppers[sid] = str(w / "host" / sid / "fs")
                os.makedirs(host_uppers[sid])
                host.prepare_layer({C.CRI_IMAGE_REF: tref, C.CRI_MANIFEST_DIGEST: mdigest,
                                    C.CRI_LAYER_DIGEST: ld}, sid, host_uppers[sid])
            for sid in sids:
                host.wait_layer_ready(sid, timeout=600)
            host_s = time.perf_counter() - t0
            snap = type("Snap", (), {"id": "0", "parent_ids": sids[::-1]})()
            host.merge_layers(snap, lambda s: host_uppers[s])
            for sid in sids:
                if Path(tm.layer_meta_file_path(sn.upper_path(sid))).read_bytes() != \
                        Path(host.layer_meta_file_path(host_uppers[sid])).read_bytes():
                    raise AssertionError(f"layer {sid}: the stack's layer.boot differs from the host route's")
            if merged_t != Path(host.image_meta_file_path(host_uppers[sids[-1]])).read_bytes():
                raise AssertionError("the tarfs container's image.boot differs from the host route's")
            t_mnt = lowerdir(t_mounts)
            t_rafs = fs.instances.get(sn.ms.get_snapshot("default/2/tarfs-ctr").id) or fs.instances.get(sids[-1])
            if real_mounts:
                if not mounted([t_mnt]):
                    raise AssertionError(f"no EROFS mount at {t_mnt}")
                tarfs_read = lambda p: Path(t_mnt + p).read_bytes()  # noqa: E731
            else:
                if not mount_utils.backend.mounts:
                    raise AssertionError("the tarfs container's EROFS mount was not made (recorded)")
                tarfs_read = tarfs_host_reader(merged_t, tm.layer_tar_file_path)
            gone = "/layer0/d5/f5.bin"
            present = os.path.exists(t_mnt + gone) if real_mounts else gone in tarfs_read.paths
            if present:
                raise AssertionError("L3's whiteout is not applied in the tarfs container")
            reads["tarfs"] = read_many(tarfs_read, tarfs_reads, tarfs_files)
            log(f"[23] tarfs container: {len(t_chains)} layers each claimed by prepare_tarfs_layer (ALREADY_EXISTS, "
                f"committed with {C.NYDUS_TARFS_LAYER}), K2 {t_launches.get('sha', 0)} launches over "
                f"{len(digest_calls)} index builds (one per layer thread); index build (tar written, regions "
                f"digested, layer.boot written) " + ", ".join(f"{sid}: {index_s[sid]:.3f} s" for sid in sids)
                + f"; the container's Prepare and Mounts {tarfs_start_ms:.1f} ms after the first layer's "
                f"Prepare; layer.boot x{len(sids)} and image.boot == the host route's ({host_s:.2f} s on "
                f"hashlib); Mounts: {t_mounts[0].type} lowerdir {t_mnt} (instance {getattr(t_rafs, 'snapshot_id', '?')}); "
                f"reads through the " + ("kernel EROFS mount" if real_mounts else
                                         "layers' tars by the merged chunk table (mounts recorded)")
                + f": {fmt(reads['tarfs'])}")
            out["tarfs_boot_sha256"] = {
                "layers": [hashlib.sha256(Path(tm.layer_meta_file_path(sn.upper_path(s))).read_bytes()).hexdigest()
                           for s in sids],
                "image": hashlib.sha256(merged_t).hexdigest()}
            out.update(tarfs_launches=t_launches, index_build_s={s: index_s[s] for s in sids},
                       digest_many_s={c[0]: c[2] for c in digest_calls}, host_index_s=host_s,
                       start_ms={"nydus": nydus_start_ms, "tarfs": tarfs_start_ms})

            # RPC spread on the running stack
            for _ in range(SNAP_RPC_REPS):
                client.stat(n_chains[-1])
                client.mounts("default/1/nydus-ctr")
                walk(st)
            before = walk(st)

            # -- 5. restart: the snapshotter goes, the daemon stays -----------------
            live = fs.get_shared_daemon(C.FS_DRIVER_FUSEDEV)
            pid1 = live.pid
            n_spawned = len(spawned)
            # The daemon outlives this stack. Here it is a child of this process,
            # which a restarted snapshotter is not: reap it when it exits, as init
            # would, so the new stack sees its exit.
            if live._proc is not None:
                threading.Thread(target=live._proc.wait, daemon=True).start()
            close(st, teardown=False)
            st = None
            t0 = time.perf_counter()
            st = mk_stack()
            fs = st["fs"]
            fs.wait_until_ready(meta_sid)
            first = nydus_reader(fs)(nydus_reads[0])
            restart_ms = (time.perf_counter() - t0) * 1e3
            client, sn = st["client"], st["sn"]
            shared = fs.get_shared_daemon(C.FS_DRIVER_FUSEDEV)
            if shared.pid != pid1 or len(spawned) != n_spawned or first != nydus_files[nydus_reads[0]]:
                raise AssertionError(f"after the restart the daemon is pid {shared.pid} (was {pid1}), spawned "
                                     f"{spawned[n_spawned:]}")
            if walk(st) != before:
                raise AssertionError("Walk after the restart lists other snapshots")
            if lowerdir(client.mounts("default/1/nydus-ctr")) != n_mnt:
                raise AssertionError("the nydus container's Mounts changed across the restart")
            reads["nydus_after_restart"] = read_many(nydus_reader(fs), nydus_reads, nydus_files)
            reads["tarfs_after_restart"] = read_many(tarfs_read, tarfs_reads, tarfs_files)
            log(f"[23] restart: the snapshotter and its gRPC server closed with the daemon left running; a new "
                f"stack on the same root served its first read {restart_ms:.1f} ms after its start (Manager.recover "
                f"took pid {pid1} back, no spawn); Walk lists the same {len(before)} snapshots; nydus "
                f"{fmt(reads['nydus_after_restart'])}; tarfs {fmt(reads['tarfs_after_restart'])}")

            # -- 6. failover: SIGKILL the daemon, the restart policy respawns it ----
            # The restarted stack's liveness monitor must see the daemon die and
            # its death handler respawn it with the instances Manager.recover
            # took back: nothing here hands the manager a death event.
            pid1 = shared.pid
            n_spawned = len(spawned)
            monitor = st["mgr"].monitor
            watched = monitor._by_id.get(shared.id)
            if watched is None:
                raise AssertionError("the restarted stack's liveness monitor does not watch the daemon")
            if [r.snapshot_id for r in shared.instances.list()] != [meta_sid]:
                raise AssertionError(f"Manager.recover took the daemon back with instances "
                                     f"{[r.snapshot_id for r in shared.instances.list()]}, not [{meta_sid}]")
            t_kill = time.perf_counter()
            os.kill(pid1, signal.SIGKILL)
            seen_ms = None
            last_err = None
            while True:
                if seen_ms is None and shared.id not in monitor._by_id:
                    seen_ms = (time.perf_counter() - t_kill) * 1e3
                if time.perf_counter() - t_kill > 60:
                    d = fs.get_shared_daemon(C.FS_DRIVER_FUSEDEV)
                    bits = []
                    if seen_ms is None:
                        poller = select.poll()
                        poller.register(watched, select.POLLIN | select.POLLPRI | select.POLLOUT | select.POLLERR
                                        | select.POLLHUP | select.POLLRDHUP)
                        got = dict(poller.poll(0)).get(watched, 0)
                        bits = [n for n in ("POLLIN", "POLLPRI", "POLLOUT", "POLLERR", "POLLHUP", "POLLRDHUP")
                                if got & getattr(select, n)]
                    raise AssertionError(
                        f"the death handler did not respawn the daemon in 60 s: killed {pid1} (alive "
                        f"{pid_alive(pid1)}), monitor saw the death after {seen_ms} ms (the watched socket polls "
                        f"{bits}), daemon pid {d.pid} (alive {pid_alive(d.pid)}), spawned "
                        f"{[p for p, _a in spawned]}, pending death events {monitor.events.qsize()}, degraded "
                        f"{st['mgr'].degraded}, instances {[r.snapshot_id for r in d.instances.list()]}, last read "
                        f"error {last_err!r}")
                try:
                    d = fs.get_shared_daemon(C.FS_DRIVER_FUSEDEV)
                    if d.pid != pid1 and nydus_reader(fs)(nydus_reads[0]) == nydus_files[nydus_reads[0]]:
                        break
                except Exception as e:  # noqa: BLE001 — not back yet
                    last_err = e
                time.sleep(0.005)
            failover_ms = (time.perf_counter() - t_kill) * 1e3
            d = fs.get_shared_daemon(C.FS_DRIVER_FUSEDEV)
            if len(spawned) != n_spawned + 1 or spawned[-1][0] != d.pid or d.pid in compute_pids():
                raise AssertionError(f"the respawn: spawned {spawned[n_spawned:]}, daemon pid {d.pid}")
            reads["nydus_after_failover"] = read_many(nydus_reader(fs), nydus_reads, nydus_files)
            reads["tarfs_after_failover"] = read_many(tarfs_read, tarfs_reads, tarfs_files)
            log(f"[23] failover: SIGKILL of pid {pid1} -> the liveness monitor saw the daemon's end close after "
                f"{seen_ms:.1f} ms -> the death handler respawned the port's daemon (pid {d.pid}) and re-mounted "
                f"the instance Manager.recover took back; first read served {failover_ms:.1f} ms after the kill; "
                f"nydus {fmt(reads['nydus_after_failover'])}; tarfs {fmt(reads['tarfs_after_failover'])}")
            out["failover"] = {"monitor_saw_ms": seen_ms}

            # -- 7. teardown: children first, then Cleanup ---------------------------
            t0 = time.perf_counter()
            for key in ("default/2/tarfs-ctr", "default/1/nydus-ctr"):
                client.remove(key)
            for chain in reversed(t_chains):
                client.remove(chain)
            for chain in reversed(n_chains):
                client.remove(chain)
            client.cleanup()
            left_snaps = walk(st)
            close(st, teardown=True)
            st = None
            teardown_ms = (time.perf_counter() - t0) * 1e3
            snap_dirs = [p for p in os.listdir(os.path.join(root, "snapshots")) if p != "metadata.db"
                         and not p.startswith("metadata.db")]
            with open("/proc/mounts") as f:
                left_mounts = [line.split()[1] for line in f if str(w) in line.split()[1]]
            loops = subprocess.run(["losetup", "-a"], capture_output=True, text=True).stdout if real_mounts else ""
            left_loops = [x for x in loops.splitlines() if str(w) in x]
            # Recorded: the restarted manager unmounts by the persisted path only
            # where os.path.ismount sees a mount, and leaves loops to AUTOCLEAR, as
            # the reference does; the recorders emulate neither, so what they
            # still hold is printed, not checked.
            recorded = {} if real_mounts else {"loops": sorted(losetup.backend.attached.values()),
                                               "mounts": sorted(mount_utils.backend.mounts)}
            left_daemons = [pid for pid, _a in spawned if pid_alive(pid)]
            if left_snaps or snap_dirs or left_mounts or left_loops or left_daemons:
                raise AssertionError(f"left after teardown: snapshots {left_snaps}, dirs {snap_dirs}, mounts "
                                     f"{left_mounts}, loops {left_loops}, daemons {left_daemons}")
            log(f"[23] teardown: {len(t_chains) + len(n_chains) + 2} snapshots removed (containers first), Cleanup; "
                f"no snapshot directory, mount, loop device or daemon left ({teardown_ms:.0f} ms)"
                + (f"; the recorders still hold {recorded} from the first stack's manager" if recorded else ""))
    except Exception:
        log("[23] the stack's log records, last 60:\n" + "\n".join(records[-60:]))
        for log_path in sorted(w.glob("r/daemons/*/daemon.log")):
            log(f"[23] {log_path}, last 3000 bytes:\n" + log_path.read_text(errors="replace")[-3000:])
        raise
    finally:
        pkg_log.removeHandler(keep)
        pkg_log.setLevel(pkg_level)
        daemon_mod.Daemon.spawn = spawn
        if st is not None:
            with contextlib.suppress(Exception):
                close(st, teardown=True)
        for pid, _a in spawned:
            if pid_alive(pid):
                with contextlib.suppress(OSError):
                    os.kill(pid, signal.SIGKILL)
        with open("/proc/mounts") as f:
            for target in [line.split()[1] for line in f if str(w) in line.split()[1]][::-1]:
                ctypes.CDLL("libc.so.6").umount2(target.encode(), 2)
        losetup.backend, mount_utils.backend = saved_backends
        reg.close()
        shutil.rmtree(w, ignore_errors=True)
    launches = {key: k.launches for key, k in kernels.items()}
    want = {key: 0 for key in kernels}
    want.update(sha=len(t_layers))
    if launches != want:
        raise AssertionError(f"phase 23 after the tarfs pull launched {launches}; the index builds only {want}")
    rpc = {name: {"n": len(v), "ms_median": float(np.median(v)), "ms_p95": float(np.percentile(v, 95))}
           for name, v in rpc_ms.items()}
    log("[23] ms per RPC (median / p95 over the phase): " + ", ".join(
        f"{name} {r['ms_median']:.2f} / {r['ms_p95']:.2f} (n {r['n']})" for name, r in sorted(rpc.items())))
    out.update(reads=reads, restart_to_first_read_ms=restart_ms, kill_to_first_read_ms=failover_ms,
               teardown_ms=teardown_ms, rpc=rpc,
               launches={"gear": pack_launches["gear"], "sha": pack_launches["sha"] + launches["sha"],
                         "probe": 0, "b3_leaves": 0, "b3_parents": 0},
               daemon_argv=spawned[0][1], phase_s=time.perf_counter() - t_phase, device=smi)
    log(f"[23] launches over the phase: K1 {out['launches']['gear']}, K2 {out['launches']['sha']} (two packs, "
        f"{len(t_layers)} tarfs index builds), K3 0, K4 0; {out['phase_s']:.1f} s on {smi}")
    return out


# ---------------------------------------------------------------------------
# Phase 24: the snapshotter's command line: build_stack, then the process
# ---------------------------------------------------------------------------

CLI_EXIT_S = 15.0  # SIGTERM must end the snapshotter within this (its gRPC grace is 2 s)
CLI_READY_S = 180.0
CLI_LAUNCHES_SITE = """\
import atexit, json, os, sys


def _dump():
    kernels = {"gear": ("gear_cuda", "KERNEL"), "sha": ("sha256_cuda", "KERNEL"),
               "probe": ("probe_cuda", "KERNEL"), "b3_leaves": ("blake3_cuda", "LEAVES"),
               "b3_parents": ("blake3_cuda", "PARENTS")}
    out = {}
    for key, (mod, attr) in kernels.items():
        m = sys.modules.get("nydus_snapshotter_tpu_torch.ops." + mod)
        out[key] = getattr(m, attr).launches if m is not None else 0
    with open(os.path.join(os.environ["CHIP_SMOKE_LAUNCHES"], f"{os.getpid()}.json"), "w") as f:
        json.dump(out, f)


atexit.register(_dump)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def children(pid: int) -> list[int]:
    """The pids whose parent is ``pid``."""
    import os

    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            with contextlib.suppress(OSError):
                with open(f"/proc/{d}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        out.append(int(d))
    return out


def probe_fanotify() -> str:
    """'' when this process may call fanotify_init(2) (CAP_SYS_ADMIN), else
    the operating system's reason."""
    import os

    libc = ctypes.CDLL("libc.so.6", use_errno=True)
    fd = libc.fanotify_init(0, os.O_RDONLY)  # FAN_CLASS_NOTIF
    if fd < 0:
        return (f"fanotify_init refused: {os.strerror(ctypes.get_errno())} (euid {os.geteuid()}; optimizer-server "
                "needs fanotify(7) and CAP_SYS_ADMIN)")
    os.close(fd)
    return ""


def tarfs_pull(client, ref: str, mdigest: str, ldigests: list[str], tag: str) -> list[str]:
    """containerd's pull transcript of a tarfs image: every layer's Prepare
    claimed by the tarfs arm (ALREADY_EXISTS) and labelled a tarfs layer.
    Returns the chains, bottom first."""
    import grpc

    from nydus_snapshotter_tpu_torch import constants as C

    parent, chains = "", []
    for i, ld in enumerate(ldigests):
        chain = f"sha256:{tag}-chain-{i}"
        labels = {C.CRI_IMAGE_REF: ref, C.CRI_MANIFEST_DIGEST: mdigest, C.CRI_LAYER_DIGEST: ld,
                  C.CRI_IMAGE_LAYERS: ",".join(ldigests), C.TARGET_SNAPSHOT_REF: chain}
        try:
            client.prepare(f"extract-{tag}{i} {chain}", parent, labels)
            raise AssertionError("a tarfs layer's Prepare did not answer ALREADY_EXISTS")
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.ALREADY_EXISTS:
                raise
        if client.stat(chain).labels.get(C.NYDUS_TARFS_LAYER) != ld.split(":", 1)[1]:
            raise AssertionError(f"layer {i} took no tarfs route (a quiet fallback)")
        chains.append(chain)
        parent = chain
    return chains


def cli_phase(dev, tar: bytes, kernels, want_boots: dict | None) -> dict:
    """Phase 24: the snapshotter's command line. ``cmd.snapshotter.build_stack``
    in this process on a config with tarfs on and ``accel_backend = "jax"``
    (the tarfs engine on this card): a tarfs container prepared through
    ``SnapshotsClient``, K2 once per layer. Then ``python -m
    nydus_snapshotter_tpu_torch.cmd.snapshotter --config <toml>`` as a
    process, with the system controller, the fleet plane and the metrics
    exporter on: the same container prepared over its socket, read, the
    exporter and the controller scraped, SIGTERM. ``want_boots`` holds the
    sha256 of phase 23's ``layer.boot`` files and ``image.boot``; without it
    (``--cli-only``) the engine-less manager builds them on the host."""
    import os
    import shutil
    import signal
    import tempfile

    from nydus_snapshotter_tpu_torch import constants as C
    from nydus_snapshotter_tpu_torch import tarfs
    from nydus_snapshotter_tpu_torch.api.client import SnapshotsClient
    from nydus_snapshotter_tpu_torch.api.service import serve
    from nydus_snapshotter_tpu_torch.cmd import snapshotter as cli
    from nydus_snapshotter_tpu_torch.utils import udshttp

    t_phase = time.perf_counter()
    smi = nvidia_smi("name,power.limit")
    t_layers = tarfs_layers(tar)
    reg = OciRegistry()
    mdigest, ldigests = reg.publish(
        "v1", [(blob, "sha256:" + hashlib.sha256(raw).hexdigest()) for blob, raw in t_layers],
        annotations={C.TARFS_HINT: "true"})
    tref = f"{reg.host}/library/cli:v1"
    files = merged_view([raw for _b, raw in t_layers])
    rng = np.random.default_rng(SEED + 24)
    nonempty = sorted(p for p, v in files.items() if v)
    reads = [nonempty[i] for i in rng.choice(len(nonempty), SNAP_READS, replace=False)]
    where = "/dev/shm" if os.path.isdir("/dev/shm") else "/tmp"
    loop_why = probe_loop_erofs(where)
    w = Path(tempfile.mkdtemp(prefix="n24", dir=where))
    out: dict = {"loop_erofs": loop_why or "made", "device": smi}
    child = None
    try:
        held_to = "phase 23's"
        if want_boots is None:  # --cli-only: the reference's engine-less route on the host
            held_to = "the host route's"
            host = tarfs.Manager(cache_dir_path=str(w / "host-cache"), engine=None, insecure=True)
            uppers = []
            for i, ld in enumerate(ldigests):
                uppers.append(str(w / "host" / str(i) / "fs"))
                os.makedirs(uppers[-1])
                host.prepare_layer({C.CRI_IMAGE_REF: tref, C.CRI_MANIFEST_DIGEST: mdigest,
                                    C.CRI_LAYER_DIGEST: ld}, str(i), uppers[-1])
            for i in range(len(ldigests)):
                host.wait_layer_ready(str(i), timeout=600)
            host.merge_layers(type("Snap", (), {"id": "x", "parent_ids": [str(i) for i in
                                                                          range(len(ldigests))][::-1]})(),
                              lambda sid: uppers[int(sid)])
            want_boots = {"layers": [hashlib.sha256(Path(host.layer_meta_file_path(u)).read_bytes()).hexdigest()
                                     for u in uppers],
                          "image": hashlib.sha256(Path(host.image_meta_file_path(uppers[-1])).read_bytes()).hexdigest()}

        def boots_of(sn_upper, chains_sids) -> dict:
            layers = [hashlib.sha256(Path(sn_upper(s), "image", tarfs.LAYER_BOOTSTRAP_NAME).read_bytes()).hexdigest()
                      for s in chains_sids]
            image = hashlib.sha256(Path(sn_upper(chains_sids[-1]), "image",
                                        tarfs.IMAGE_BOOTSTRAP_NAME).read_bytes()).hexdigest()
            return {"layers": layers, "image": image}

        # -- 1. build_stack in this process: the tarfs engine on this card --------
        for k in kernels.values():
            k.launches = 0
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            ["--root", str(w / "s" / "r"), "--address", str(w / "s" / "grpc.sock"), "--daemon-mode", "none"]))
        cfg.experimental.tarfs_enable = True
        cfg.daemon.accel_backend = "jax"
        cfg.metrics.address = ""
        t0 = time.perf_counter()
        sn, fs, managers, db = cli.build_stack(cfg, device=dev)
        stack_s = time.perf_counter() - t0
        eng = fs.tarfs_mgr.engine
        if eng.backend != "jax" or eng.device != dev:
            raise AssertionError(f"build_stack gave the tarfs manager {eng.backend} on {eng.device}, not jax on {dev}")
        index_s: dict[str, float] = {}
        gen = fs.tarfs_mgr._generate_bootstrap

        def timed_gen(tar_bytes, snapshot_id, blob_id, upper):
            t1 = time.perf_counter()
            gen(tar_bytes, snapshot_id, blob_id, upper)
            index_s[snapshot_id] = time.perf_counter() - t1

        fs.tarfs_mgr._generate_bootstrap = timed_gen
        server = serve(sn, cfg.address)
        client = SnapshotsClient(cfg.address, timeout=600.0)
        try:
            t0 = time.perf_counter()
            chains = tarfs_pull(client, tref, mdigest, ldigests, "a")
            client.prepare("default/24/tarfs-ctr", chains[-1], {C.CRI_IMAGE_REF: tref})
            mounts = client.mounts("default/24/tarfs-ctr")
            inproc_ms = (time.perf_counter() - t0) * 1e3
            sids = [sn.ms.get_snapshot(c).id for c in chains]
            inproc_launches = {key: k.launches for key, k in kernels.items()}
            want_l = {key: 0 for key in kernels}
            want_l.update(sha=len(t_layers))
            if inproc_launches != want_l:
                raise AssertionError(f"build_stack's tarfs pull launched {inproc_launches}; want {want_l}")
            got_boots = boots_of(sn.upper_path, sids)
            if got_boots != want_boots:
                raise AssertionError(f"build_stack's tarfs indexes {got_boots} differ from {held_to} {want_boots}")
            for key in ("default/24/tarfs-ctr", *chains[::-1]):
                client.remove(key)
            client.cleanup()
        finally:
            client.close()
            server.stop(grace=None)
            fs.teardown()
            sn.close()
            for m in managers.values():
                m.stop()
            db.close()
        log(f"[24] build_stack (in this process, tarfs on, accel_backend jax on {dev}): stack up in {stack_s:.3f} s; "
            f"the tarfs container {inproc_ms:.1f} ms from its first layer's Prepare to its Mounts "
            f"({mounts[0].type}); K2 {inproc_launches['sha']} launches, one per layer index build ("
            + ", ".join(f"{sid}: {index_s[sid]:.3f} s" for sid in sids)
            + f"), K1 K3 K4 none; layer.boot x{len(sids)} and image.boot == {held_to}; on {smi}")
        out.update(build_stack_s=stack_s, build_stack_start_ms=inproc_ms, launches=inproc_launches,
                   index_build_s=[index_s[s] for s in sids])

        # -- 2. the command line as a process ----------------------------------------
        cdir = w / "c"
        (cdir / "site").mkdir(parents=True)
        (cdir / "site" / "sitecustomize.py").write_text(CLI_LAUNCHES_SITE)
        metrics_addr = f"127.0.0.1:{free_port()}"
        toml = cdir / "config.toml"
        toml.write_text(
            f'root = "{cdir}/r"\naddress = "{cdir}/grpc.sock"\ndaemon_mode = "shared"\n'
            f'[system]\naddress = "{cdir}/system.sock"\n[metrics]\naddress = "{metrics_addr}"\n'
            f'[fleet]\nenable = true\n'
            f'[log]\nlog_to_stdout = false\nlog_dir = "{cdir}/log"\nlog_level = "info"\n'
            f'[daemon]\naccel_backend = "jax"\n'
            f'[experimental]\ntarfs_enable = true\ntarfs_mount_on_host = {"false" if loop_why else "true"}\n')
        env = {k: v for k, v in os.environ.items() if not k.startswith("NTPU_")}
        env["PYTHONPATH"] = os.pathsep.join([str(cdir / "site"), str(Path(__file__).resolve().parent)])
        env["CHIP_SMOKE_LAUNCHES"] = str(cdir / "launches")  # <pid>.json per process at its exit
        (cdir / "launches").mkdir()
        argv = [sys.executable, "-m", "nydus_snapshotter_tpu_torch.cmd.snapshotter", "--config", str(toml)]
        if dev.type == "cpu":  # a rehearsal without the card: the kernels' plain versions
            argv += ["--device", "cpu"]
        apps_before = compute_pids()  # nvidia-smi may show another pid namespace's numbers: count them
        t0 = time.perf_counter()
        child = subprocess.Popen(argv, cwd=str(cdir), env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        sockets = [cdir / "grpc.sock", cdir / "system.sock"]
        while not all(p.exists() for p in sockets):
            if child.poll() is not None or time.perf_counter() - t0 > CLI_READY_S:
                raise AssertionError(f"the snapshotter never served (rc {child.poll()}): "
                                     + child.stderr.read().decode(errors="replace")[-3000:]
                                     if child.poll() is not None else "the snapshotter never served")
            time.sleep(0.01)
        ready_ms = (time.perf_counter() - t0) * 1e3
        daemons = [p for p in children(child.pid) if "nydus_snapshotter_tpu_torch.daemon.server" in
                   " ".join(Path(f"/proc/{p}/cmdline").read_bytes().decode(errors="replace").split("\0"))]
        client = SnapshotsClient(str(cdir / "grpc.sock"), timeout=600.0)
        try:
            t0 = time.perf_counter()
            chains = tarfs_pull(client, tref, mdigest, ldigests, "b")
            client.prepare("default/24/cli-ctr", chains[-1], {C.CRI_IMAGE_REF: tref})
            mounts = client.mounts("default/24/cli-ctr")
            cli_ms = (time.perf_counter() - t0) * 1e3
            apps = compute_pids()
            c_fds, c_libs = cuda_handles(child.pid)
            if len(apps) != len(apps_before) + 1 or not c_fds or not any(n.startswith("libcuda.") for n in c_libs):
                raise AssertionError(f"the snapshotter (pid {child.pid}) holds no CUDA context: compute apps "
                                     f"{apps} (before it {apps_before}), /dev/nvidia files {c_fds}, libraries "
                                     f"{c_libs}")
            if not daemons:
                raise AssertionError(f"the snapshotter (pid {child.pid}) spawned no daemon")
            for d in daemons:
                d_fds, d_libs = cuda_handles(d)
                if d_fds or any(n.startswith("libcuda.") for n in d_libs):
                    raise AssertionError(f"its daemon (pid {d}) holds a CUDA context: {d_fds} {d_libs}")
            # the chains' snapshot directories, by the snapshotter's own metastore file
            import sqlite3

            with contextlib.closing(sqlite3.connect(f"file:{cdir}/r/snapshots/metadata.db?mode=ro",
                                                    uri=True)) as con:
                ids = dict(con.execute("SELECT key, id FROM snapshots").fetchall())
            sids = [str(ids[c]) for c in chains]
            upper = lambda sid: str(cdir / "r" / "snapshots" / sid / "fs")  # noqa: E731
            cli_boots = boots_of(upper, sids)
            if cli_boots != want_boots:
                raise AssertionError(f"the process's tarfs indexes {cli_boots} differ from {want_boots}")
            lower = next(o for o in mounts[0].options if o.startswith("lowerdir=")).split("=", 1)[1].split(":")[-1]
            if not loop_why:
                if not mounted([lower]):
                    raise AssertionError(f"no EROFS mount at {lower}")
                read_one = lambda p: Path(lower + p).read_bytes()  # noqa: E731
                how = f"the kernel EROFS mount at {lower}"
            else:
                merged_boot = Path(upper(sids[-1]), "image", tarfs.IMAGE_BOOTSTRAP_NAME).read_bytes()
                read_one = tarfs_host_reader(merged_boot, lambda bid: str(cdir / "r" / "cache" / bid))
                how = "the layers' tars by the merged chunk table (no loop devices here)"
            t1 = time.perf_counter()
            for path in reads:
                if read_one(path) != files[path]:
                    raise AssertionError(f"{path}: the container's read differs from the tar")
            read_s = time.perf_counter() - t1
            # the metrics exporter and the controller's fleet routes
            import urllib.request

            with urllib.request.urlopen(f"http://{metrics_addr}/v1/metrics", timeout=30) as resp:
                exported = resp.read().decode()
            members = udshttp.get_json(str(cdir / "system.sock"), "/api/v1/fleet/members")
            status, fed = udshttp.request(str(cdir / "system.sock"), "/api/v1/fleet/metrics")
            daemons_route = udshttp.get_json(str(cdir / "system.sock"), "/api/v1/daemons")
            if ("snapshotter_memory_usage_kilobytes" not in exported or status != 200
                    or "snapshotter" not in [m["name"] for m in members]
                    or sorted(d["pid"] for d in daemons_route) != sorted(daemons)):
                raise AssertionError(f"scrapes: exporter {len(exported)} bytes, members {members}, federated "
                                     f"{status}, daemons {daemons_route}")
            for key in ("default/24/cli-ctr", *chains[::-1]):
                client.remove(key)
            client.cleanup()
        finally:
            client.close()
        t0 = time.perf_counter()
        child.send_signal(signal.SIGTERM)
        try:
            rc = child.wait(timeout=CLI_EXIT_S)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"the snapshotter did not exit within {CLI_EXIT_S} s of SIGTERM") from None
        exit_ms = (time.perf_counter() - t0) * 1e3
        err = child.stderr.read().decode(errors="replace")
        if rc != 0:
            raise AssertionError(f"the snapshotter exited {rc} on SIGTERM: {err[-3000:]}")
        deadline = time.perf_counter() + CLI_EXIT_S
        while any(pid_alive(d) for d in daemons) and time.perf_counter() < deadline:
            time.sleep(0.01)
        with open("/proc/mounts") as f:
            left_mounts = [line.split()[1] for line in f if str(w) in line.split()[1]]
        left = [p for p in sockets if p.exists()] + left_mounts + [d for d in daemons if pid_alive(d)]
        if left:
            raise AssertionError(f"left after SIGTERM: {left}")
        cli_launches = json.loads((cdir / "launches" / f"{child.pid}.json").read_text())
        want_l = {key: 0 for key in kernels}
        want_l.update(sha=len(t_layers))
        if cli_launches != want_l:
            raise AssertionError(f"the snapshotter process launched {cli_launches}; want {want_l}")
        log(f"[24] {' '.join(argv[1:])}: sockets ready {ready_ms:.1f} ms after the start (the system "
            f"controller, the fleet plane and the metrics exporter on {metrics_addr}; a shared daemon, pid "
            f"{daemons}); the tarfs container {cli_ms:.1f} ms from its first layer's Prepare to its Mounts "
            f"({mounts[0].type}); the process holds a CUDA context (one more compute app, {len(c_fds)} /dev/nvidia "
            f"files, libcuda mapped), its daemon none; K2 {cli_launches['sha']} launches in the process (counted at its exit), K1 K3 K4 "
            f"none; layer.boot x{len(sids)} and image.boot == build_stack's; {len(reads)} files read through "
            f"{how} in {read_s:.3f} s, equal; /v1/metrics {len(exported)} bytes, fleet members "
            f"{[m['name'] for m in members]}, /api/v1/fleet/metrics {len(fed)} bytes; SIGTERM to exit 0 in "
            f"{exit_ms:.1f} ms, no socket, mount or daemon left; on {smi}")
        out.update(ready_ms=ready_ms, start_ms=cli_ms, exit_ms=exit_ms, cli_launches=cli_launches,
                   read_s=read_s, daemons=len(daemons))
        child = None
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        reg.close()
        with open("/proc/mounts") as f:
            for target in [line.split()[1] for line in f if str(w) in line.split()[1]][::-1]:
                ctypes.CDLL("libc.so.6").umount2(target.encode(), 2)
        shutil.rmtree(w, ignore_errors=True)

    # -- 3. fanotify: the optimizer-server tracer, where the machine allows it ------
    fan_why = probe_fanotify()
    if not fan_why:
        if not (shutil.which("make") and shutil.which("g++")):
            fan_why = "no make or g++ on this machine to build optimizer-server"
    if fan_why:
        log(f"[24] fanotify: not run, {fan_why}")
        out["fanotify"] = fan_why
    else:
        from nydus_snapshotter_tpu_torch.fanotify import Server, default_binary_path
        from nydus_snapshotter_tpu_torch.utils import native_build

        binary = default_binary_path()
        if not os.path.exists(binary):
            raise AssertionError(f"optimizer-server did not build: {native_build.failure_reason('optimizer-server')}")
        d = Path(tempfile.mkdtemp(prefix="n24f", dir="/tmp"))
        try:
            persist = d / "results" / "app:latest"
            tracer = Server(binary_path=binary, container_pid=0, image_name="app:latest", persist_file=str(persist))
            tracer.run_server()
            try:
                time.sleep(0.3)
                victim = str(Path(__file__).resolve())
                Path(victim).read_bytes()
                deadline = time.time() + 5
                while time.time() < deadline and not (persist.exists() and victim in persist.read_text()):
                    time.sleep(0.05)
            finally:
                tracer.stop_server()
            if victim not in persist.read_text():
                raise AssertionError("the fanotify trace did not see the file this phase opened")
            log(f"[24] fanotify: optimizer-server built ({binary}), one trace of this mount namespace "
                f"saw {victim} ({len(persist.read_text().splitlines())} paths)")
            out["fanotify"] = "traced"
        finally:
            shutil.rmtree(d, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[24] {out['phase_s']:.1f} s on {smi}")
    return out


def main() -> int:
    import torch

    args = sys.argv[1:]
    if args not in ([], ["--mesh-only"], ["--ha-only"], ["--convert-only"], ["--registry-only"],
                    ["--formats-only"], ["--fetch-only"], ["--serve-only"], ["--snapshot-only"], ["--cli-only"]):
        print(f"usage: {sys.argv[0]} [--mesh-only | --ha-only | --convert-only | --registry-only | "
              "--formats-only | --fetch-only | --serve-only | --snapshot-only | --cli-only]", file=sys.stderr)
        return 2
    mesh_only = args == ["--mesh-only"]
    ha_only = args == ["--ha-only"]
    convert_only = args == ["--convert-only"]
    registry_only = args == ["--registry-only"]
    formats_only = args == ["--formats-only"]
    fetch_only = args == ["--fetch-only"]
    serve_only = args == ["--serve-only"]
    snapshot_only = args == ["--snapshot-only"]
    cli_only = args == ["--cli-only"]
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
    if ha_only:  # phases 0-3, phase 4's checked fused pack, then 16 and 17
        tar = layer_tar(FileGen(SEED + 3).pool(PACK_MIB))
        _blob_f, res_f = pack_layer(tar, PackOption(backend="fused", chunk_size=CHUNK_SIZE,
                                                    compressor="none"), device=dev)
        ha = ha_phase(dev, files, res, res_f, to_u32(allq), all_kernels)
        ociref = ociref_phase(dev, tar, all_kernels)
        log(f"[done] {time.perf_counter() - t_start:.1f} s (--ha-only: phases 0-3, 16 and 17)")
        print(smi, flush=True)
        print(json.dumps({"ha": ha, "ociref": ociref}, default=float), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                  "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if convert_only:  # phases 0-3, then 18 on phase 4's tar
        conv = convert_phase(dev, layer_tar(FileGen(SEED + 3).pool(PACK_MIB)), all_kernels)
        log(f"[done] {time.perf_counter() - t_start:.1f} s (--convert-only: phases 0-3 and 18)")
        print(smi, flush=True)
        print(json.dumps({"convert": conv}, default=float), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                  "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if registry_only:  # phases 0-3, then 19 on phase 4's tar
        tm = tarfs_manager_phase(dev, layer_tar(FileGen(SEED + 3).pool(PACK_MIB)), all_kernels)
        log(f"[done] {time.perf_counter() - t_start:.1f} s (--registry-only: phases 0-3 and 19)")
        print(smi, flush=True)
        print(json.dumps({"tarfs_manager": tm}, default=float), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                  "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if formats_only:  # phases 0-3, then 20 on phase 4's tar
        fm = formats_phase(dev, layer_tar(FileGen(SEED + 3).pool(PACK_MIB)), all_kernels)
        log(f"[done] {time.perf_counter() - t_start:.1f} s (--formats-only: phases 0-3 and 20)")
        print(smi, flush=True)
        print(json.dumps({"formats": fm}, default=float), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                  "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if fetch_only:  # phases 0-3, then 21 on phase 4's tar
        fe = fetch_phase(dev, layer_tar(FileGen(SEED + 3).pool(PACK_MIB)), all_kernels)
        log(f"[done] {time.perf_counter() - t_start:.1f} s (--fetch-only: phases 0-3 and 21)")
        print(smi, flush=True)
        print(json.dumps({"fetch": fe}, default=float), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                  "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if serve_only:  # phases 0-3, then 22 on phase 4's tar
        sv = serve_phase(dev, layer_tar(FileGen(SEED + 3).pool(PACK_MIB)), all_kernels)
        log(f"[done] {time.perf_counter() - t_start:.1f} s (--serve-only: phases 0-3 and 22)")
        print(smi, flush=True)
        print(json.dumps({"serve": sv}, default=float), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                  "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if snapshot_only:  # phases 0-3, then 23 on phase 4's tar
        sp = snapshot_phase(dev, layer_tar(FileGen(SEED + 3).pool(PACK_MIB)), all_kernels)
        log(f"[done] {time.perf_counter() - t_start:.1f} s (--snapshot-only: phases 0-3 and 23)")
        print(smi, flush=True)
        print(json.dumps({"snapshot": sp}, default=float), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                  "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if cli_only:  # phases 0-3, then 24 on phase 4's tar (its indexes held to the host route's)
        cp = cli_phase(dev, layer_tar(FileGen(SEED + 3).pool(PACK_MIB)), all_kernels, None)
        log(f"[done] {time.perf_counter() - t_start:.1f} s (--cli-only: phases 0-3 and 24)")
        print(smi, flush=True)
        print(json.dumps({"cli": cp}, default=float), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                  "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # -- 4. pack -----------------------------------------------------------
    t0 = time.perf_counter()
    tar = layer_tar(FileGen(SEED + 3).pool(PACK_MIB))
    t_gen = time.perf_counter() - t0
    opt = dict(chunk_size=CHUNK_SIZE, compressor="none")
    st_f = {}
    t0 = time.perf_counter()
    blob_f, res_f = pack_layer(tar, PackOption(backend="fused", **opt), device=dev, stats=st_f)
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
        for _ in range(PACK_REPS):
            got, st = [], {}
            pack_runs[backend].append(host_timed(lambda: got.append(
                pack_layer(tar, PackOption(backend=backend, **opt), device=dev, stats=st)[0])))
            if got[0] != want:
                raise AssertionError(f"pack_layer({backend}) differs from its checked run")
            if backend == "fused":
                fused_stats.append(st)
        pack_runs[backend] = or_checked(pack_runs[backend], t_fused if backend == "fused" else t_numpy)
    fused_stats = fused_stats or [st_f]
    log(f"[4] pack: {len(tar)} byte tar (built in {t_gen:.1f} s) -> {len(blob_f)} byte layer "
        f"blob, blob id {res_f.blob_id[:16]}..; fused == numpy byte for byte; checked runs fused "
        f"{t_fused:.3f} s, numpy {t_numpy:.3f} s; median of {PACK_REPS} after them (the checked "
        "runs when 0; runs, wall / host CPU "
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

    # -- 16. the HA dict plane: replica catch-up, promotion, a failover batch --
    ha = ha_phase(dev, files, res, res_f, q_all, all_kernels)

    # -- 17. OCIRef layers: gzip and zstd ref packs, reads, Unpack, the hooks --
    ociref = ociref_phase(dev, tar, all_kernels)

    # -- 18. the converter CLI, tar-tarfs and the exports, the scenario corpora --
    conv = convert_phase(dev, tar, all_kernels)

    # -- 19. the registry read path and the tarfs manager, every layer indexed on K2 --
    tm = tarfs_manager_phase(dev, tar, all_kernels)

    # -- 20. the lazy formats: soci routes, indexes and readers, stargz, referrer --
    fm = formats_phase(dev, tar, all_kernels)

    # -- 21. the lazy fetch side: blob cache, peer tier, prefetch, heat, cache manager --
    fe = fetch_phase(dev, tar, all_kernels)

    # -- 22. the serving side: the daemon process, API and FUSE reads, takeover, fscache --
    sv = serve_phase(dev, tar, all_kernels)

    # -- 23. a container start through the snapshots service: nydus and tarfs images --
    sp = snapshot_phase(dev, tar, all_kernels)

    # -- 24. the snapshotter's command line: build_stack, then the process -----
    cp = cli_phase(dev, tar, all_kernels, sp["tarfs_boot_sha256"])

    def formats_launches(*keys):  # phase 20: per card ref pack; the adaptor path launches none
        out = {name: sum(p["launches"].get(k, 0) for k in keys) for name, p in fm["packs"].items()}
        out["adaptor_prepare_and_merge"] = 0
        return out

    def convert_launches(*keys):  # phase 18: per CLI pack, tarfs, corpus layer, batch
        def n(launched):
            return sum(launched.get(k, 0) for k in keys)
        out = {f"cli_{name}": n(p["launches"]) for name, p in conv["cli"]["packs"].items()}
        out["tarfs"] = n(conv["tarfs"]["launches"])
        out.update({f"corpus_{name}": n(r["fused"]["launches"]) for name, r in conv["corpora"].items()})
        out["cross_tree_fused"] = n(conv["cross_tree"]["launches"])
        out["evolution_batch"] = n(conv["evolution"]["launches"])
        return out

    def ociref_launches(*keys):  # phase 17: per ref pack and hooks arm
        out = {name: sum(r["launches"][k] for k in keys) for name, r in ociref["packs"].items()}
        out.update({f"hooks_{arm}": sum(r["launches"][k] for k in keys)
                    for arm, r in ociref["hooks"].items()})
        return out

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
            ha_batch_launches=ha["batch_launches"]["gear"], ociref_launches=ociref_launches("gear"),
            convert_launches=convert_launches("gear"), fetch_launches=fe["launches"]["gear"],
            serve_launches=sv["launches"]["gear"], snapshot_launches=sp["launches"]["gear"],
            cli_launches=cp["cli_launches"]["gear"], cli_build_stack_launches=cp["launches"]["gear"],
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
            ha_batch_launches=ha["batch_launches"]["sha"], ociref_launches=ociref_launches("sha"),
            convert_launches=convert_launches("sha"),
            tarfs_manager_launches=tm["launches"].get("sha", 0), tarfs_manager_layers=tm["layers"],
            formats_launches=formats_launches("sha"), fetch_launches=fe["launches"]["sha"],
            serve_launches=sv["launches"]["sha"], snapshot_launches=sp["launches"]["sha"],
            snapshot_tarfs_index_builds=len(sp["index_build_s"]),
            cli_launches=cp["cli_launches"]["sha"], cli_build_stack_launches=cp["launches"]["sha"],
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
            mesh_launches=mesh_launches("probe"), fetch_launches=fe["launches"]["probe"],
            serve_launches=sv["launches"]["probe"], snapshot_launches=sp["launches"]["probe"],
            cli_launches=cp["cli_launches"]["probe"], cli_build_stack_launches=cp["launches"]["probe"],
            ha_replica_probe_launches=ha["replica_probe_launches"],
            ha_promoted_probe_launches=ha["promoted_probe_launches"],
            ha={k: v for k, v in ha.items() if k != "batch_launches"},
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
            ociref_launches=ociref_launches("b3_leaves", "b3_parents"),
            convert_launches=convert_launches("b3_leaves", "b3_parents"),
            formats_launches=formats_launches("b3_leaves", "b3_parents"),
            fetch_launches=fe["launches"]["b3_leaves"] + fe["launches"]["b3_parents"],
            serve_launches=sv["launches"]["b3_leaves"] + sv["launches"]["b3_parents"],
            snapshot_launches=sp["launches"]["b3_leaves"] + sp["launches"]["b3_parents"],
            cli_launches=cp["cli_launches"]["b3_leaves"] + cp["cli_launches"]["b3_parents"],
            cli_build_stack_launches=cp["launches"]["b3_leaves"] + cp["launches"]["b3_parents"],
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
