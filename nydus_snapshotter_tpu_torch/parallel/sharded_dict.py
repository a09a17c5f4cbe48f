"""Chunk dictionary for cross-image dedup, sharded over a device mesh,
grown and persisted.

Port of the reference's parallel/sharded_dict.py:

- **Layout.** One open-addressing table per shard: keys ``u32[S, C, 8]``
  (a digest as 8 words), values ``i32[S, C]`` (dict index + 1; 0 = empty).
  Shard = ``digest_word0 mod S``, slot base = ``digest_word1 mod C``,
  bounded linear probing; ``C`` is sized by the fullest shard. ``S`` is
  the mesh's size (parallel/mesh.py): ``device=`` means a one-shard mesh
  on that device, and a dict given neither takes ``make_mesh()``.
- **Build.** Host-side: the native engine's sequential first-wins build
  (ops/native_cdc) first; the vectorized numpy lockstep build stays as
  the reference keeps it. The two arms place duplicates and chains
  differently and answer every lookup alike.
- **Growth.** ``insert_u32`` open-addresses new entries into the spare
  capacity the build's ``capacity_factor`` headroom leaves, at a cost
  proportional to the batch (``_insert_fast``: one native probe-or-insert
  pass), and falls back to a value-preserving ``_rebuild`` on a
  load-factor breach or an ``INSERT_MAX_PROBE`` chain overflow. Values are
  first-occurrence positions in the concatenated insertion sequence:
  issued indices never move. Every mutation batch bumps ``epoch`` and
  journals its new entries (``entries_since``) until the next rebuild.
- **Persistence.** ``save`` writes the reference's v5 raw file (header,
  tables); ``save_incremental`` appends only the journal tail a saved file
  lacks; ``load`` maps v5 (its tail replayed), v4 raw and the legacy
  ``.npz`` (format 1) read-only, copying on the first insert. A file of
  another shard count is rebuilt for the loading mesh. Files are
  byte-compatible with the reference package's in both directions, at
  every shard count.
- **Probe.** ``probe_backend`` ``"host"`` probes with the native engine's
  ``ntpu_dict_probe``; the others with kernel K3 (ops/probe_cuda) over
  padded copies of each shard's table on the shard's device (on the CPU,
  K3's plain version). On one shard every device backend launches K3 once
  over all queries: the reference's ``"auto"`` picks its native host probe
  there (``_use_host_probe``), the port probes on the card, with the same
  answers. On more than one, ``"auto"`` and ``"device"`` dedup the
  queries and take the routed probe (``_probe_routed``: bucket by owning
  shard, all_to_all, K3 per shard, all_to_all back), rerunning the dense
  probe (``_probe_sharded``: all_gather, K3 per shard, sum) on a bucket
  overflow; ``"pallas"`` partitions the queries by shard on the host and
  launches K3 once per shard.
- **Device tables.** The padded device copies are staged on the first
  probe after a mutation and reused until the next: every mutation
  publishes a new snapshot tuple (keys, values, capacity, depth), and the
  staged copies, one per shard at the dict's one depth, are keyed on it.
  Restaging holds the mutation lock, so it never copies arrays a native
  insert is writing; a probe that finds its copies current takes no lock.
- **State carried across.** :func:`from_tables` takes the tables a
  reference ``ShardedChunkDict.fused_probe_tables()`` returns, so a dict
  built there probes identically here.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics
from nydus_snapshotter_tpu_torch.ops import native_cdc, probe_cuda
from nydus_snapshotter_tpu_torch.parallel import mesh as mesh_lib
from nydus_snapshotter_tpu_torch.tensors import from_u32

# Longest probe chain the BUILD tolerates before doubling capacity; probes
# bound their loops by the table's actual max chain (_table_max_depth).
MAX_PROBE = 64
# Chain tolerance of INCREMENTAL inserts: linear-probing clusters grow
# superlinearly with load, and a table built at ~0.48 load passes the build
# bound as it fills toward 0.6; inserts tolerate 4x deeper chains before
# rebuilding. The stored max_depth keeps K3's window exact.
INSERT_MAX_PROBE = 256

_FORMAT_VERSION = 1  # legacy .npz container (read-only support)
_RAW_FORMAT_VERSION = 4  # NTPUDICT raw header + dense tables (read-only support)
_RAW_HEADER_FIELDS = 5  # version, n_shards, n_entries, capacity, max_depth
# v5: epoch-stamped base tables + incremental tail of appended entries.
_RAW_FORMAT_VERSION_5 = 5
_RAW_HEADER_FIELDS_V5 = 10  # version, n_shards, n_entries, capacity,
#   max_depth, epoch, rebuild_epoch, n_unique, tail_count, reserved
_TAIL_RECORD_DT = np.dtype([("d", "<u4", 8), ("v", "<u8")])  # digest + stored value
_RAW_MAGIC = b"NTPUDICT"

# Growth defaults (the reference's [chunk_dict] load_factor / headroom).
DEFAULT_LOAD_FACTOR = 0.85
DEFAULT_HEADROOM = 2.0

PROBE_BACKENDS = ("auto", "device", "host", "pallas")


_INSERT_BATCHES = _metrics.Counter(
    "ntpu_dict_insert_batches_total",
    "Incremental chunk-dict insert batches (epoch bumps)",
)
_INSERT_ENTRIES = _metrics.Counter(
    "ntpu_dict_insert_entries_total",
    "New entries inserted incrementally into chunk-dict tables",
)
_REBUILDS = _metrics.Counter(
    "ntpu_dict_rebuilds_total",
    "Chunk-dict full rebuilds (load-factor breach or chain overflow)",
)


class DictBuildError(RuntimeError):
    pass


class DictEpochError(RuntimeError):
    """Requested epoch predates the last rebuild/compaction: the caller
    holds indices the journal can no longer replay and must full-resync."""


def _build_host_tables(
    digests: np.ndarray, n_shards: int = 1, capacity_factor: float = DEFAULT_HEADROOM
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic build -> (keys u32[S,C,8], values i32[S,C]).

    The native engine's sequential first-wins build when it is available.
    Otherwise the vectorized numpy build: entries march down their probe
    chains in lockstep rounds. Per round, an entry whose candidate slot
    holds its own digest is a duplicate and is dropped; contenders for one
    free slot are resolved first-come via a reverse-order scatter (numpy
    duplicate-index scatter keeps the last write, so scattering positions
    in reverse makes the earliest entry win). Duplicates that lose a slot
    race to their own digest land later in the probe chain, where lookups
    (which take the first match in chain order) never reach them — value
    semantics stay "index of first occurrence".
    """
    digests = np.ascontiguousarray(digests, dtype=np.uint32)
    n = len(digests)
    shard_of = digests[:, 0] % np.uint32(n_shards) if n else np.zeros(0, np.uint32)
    max_count = int(np.bincount(shard_of, minlength=n_shards).max()) if n else 0
    cap = max(64, 1 << int(np.ceil(np.log2(max(1, capacity_factor * max_count)))))

    if native_cdc.dict_build_available():
        while True:
            keys = np.empty((n_shards, cap, 8), dtype=np.uint32)
            keys.fill(0)
            values = np.empty((n_shards, cap), dtype=np.int32)
            values.fill(0)
            if native_cdc.dict_build_native(
                digests, n_shards, cap, MAX_PROBE, keys.reshape(-1, 8), values.reshape(-1)
            ):
                return keys, values
            if cap > 1 << 28:
                raise DictBuildError("chunk dict table grew beyond 2^28 slots")
            cap *= 2

    shard_of32 = shard_of.astype(np.int32)
    base_word = digests[:, 1].astype(np.int32) if n else np.zeros(0, np.int32)
    while True:
        # fill() instead of np.zeros: pre-faulting the pages up front turns
        # the first round's random writes from a page-fault storm into
        # plain stores.
        keys = np.empty((n_shards, cap, 8), dtype=np.uint32)
        keys.fill(0)
        values = np.empty((n_shards, cap), dtype=np.int32)
        values.fill(0)
        flat_keys = keys.reshape(-1, 8)
        flat_vals = values.reshape(-1)
        first_writer = np.full(n_shards * cap, -1, dtype=np.int32)
        remaining = np.arange(n, dtype=np.int32)
        shard_lin = shard_of32 * np.int32(cap)
        for j in range(MAX_PROBE):
            if not len(remaining):
                break
            lin = shard_lin[remaining] + ((base_word[remaining] + np.int32(j)) & np.int32(cap - 1))
            if j == 0:
                # The table is empty on the first round: every slot is free,
                # nothing can be a duplicate — skip the 32-byte key gather.
                cand, cand_lin = remaining, lin
                dup_idx = remaining[:0]
            else:
                occupant = flat_vals[lin]
                free = occupant == 0
                dup = ~free & (flat_keys[lin] == digests[remaining]).all(axis=1)
                cand = remaining[free]
                cand_lin = lin[free]
                dup_idx = remaining[dup]
            first_writer[cand_lin[::-1]] = cand[::-1]
            win_mask = first_writer[cand_lin] == cand
            winners = cand[win_mask]
            win_lin = cand_lin[win_mask]
            flat_keys[win_lin] = digests[winners]
            flat_vals[win_lin] = winners + np.int32(1)
            first_writer[cand_lin] = -1  # reset only the touched cells
            drop = np.zeros(n, dtype=bool)
            drop[winners] = True
            drop[dup_idx] = True
            remaining = remaining[~drop[remaining]]
        if not len(remaining):
            return keys, values
        if cap > 1 << 28:
            raise DictBuildError("chunk dict table grew beyond 2^28 slots")
        cap *= 2


def _table_max_depth(keys: np.ndarray, values: np.ndarray) -> int:
    """Longest probe chain actually present in the built table (keys
    u32[S,C,8], values i32[S,C]); probes never need more rounds."""
    cap = keys.shape[1]
    flat_v = values.reshape(-1)
    occ = flat_v != 0
    if not occ.any():
        return 1
    occ_keys = keys.reshape(-1, 8)[occ]
    slots = np.nonzero(occ)[0] % cap
    base = occ_keys[:, 1] & np.uint32(cap - 1)
    depth = (slots - base) & np.uint32(cap - 1)
    return int(depth.max()) + 1


def _probe_local(
    k: torch.Tensor, v: torch.Tensor, q: torch.Tensor, cap: int, depth: int = MAX_PROBE
) -> torch.Tensor:
    """Probe queries against one unpadded table: k int32[C,8], v int32[C],
    q int32[M,8] -> int32[M]. One gather of the whole chain window
    (int32[M, D, 8]); the slot index wraps mod C."""
    slot0 = (q[:, 1] & (cap - 1)).to(torch.int64)
    slots = (slot0[:, None] + torch.arange(depth, dtype=torch.int64, device=q.device)) & (
        cap - 1
    )  # [M, D]
    cand_keys = k[slots]
    cand_vals = v[slots]
    match = (cand_keys == q[:, None, :]).all(dim=2) & (cand_vals != 0)
    hit = match.to(torch.int32).argmax(dim=1)  # first True
    found = cand_vals.gather(1, hit[:, None])[:, 0]
    return torch.where(match.any(dim=1), found, 0).to(torch.int32)


def _probe_shard(
    k: torch.Tensor, v: torch.Tensor, q: torch.Tensor, cap: int, depth: int
) -> torch.Tensor:
    """Probe queries int32[M,8] against one shard's padded table (``_stage``)
    -> int32[M]: one launch of K3, which computes :func:`_probe_local` (the
    reference's ``_probe_local``) over the wrap-free layout."""
    wstart, off = probe_cuda.window_starts(q, cap)
    return probe_cuda.probe_padded(k, v, q, wstart, off, depth)


def _shard_of(q: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The owning shard of each query int32[M,8] (word 0 as u32, mod S)."""
    return (q[:, 0].to(torch.int64) & 0xFFFFFFFF) % n_shards


def _probe_sharded(keys, values, queries, n_shards: int, mesh, depth: int, cap: int):
    """Dense probe (all_gather + sum): exact for any query distribution.

    ``keys``/``values`` are the shards' padded tables, ``queries`` the
    shards' int32[M/S, 8] rows (``mesh.shard_rows``); every shard receives
    every query, probes its own table with K3, zeroes the answers of the
    queries it does not own, and the shards' answers are summed ->
    int32[M] on the mesh's first device."""
    partial = []
    for s, (k, v, q) in enumerate(zip(keys, values, mesh_lib.all_gather(queries, mesh))):
        found = _probe_shard(k, v, q, cap, depth)
        partial.append(torch.where(_shard_of(q, n_shards) == s, found, 0))
    return mesh_lib.sum_shards(partial, mesh.devices[0])


def _bucket_capacity(m_local: int, n_shards: int) -> int:
    """Fixed per-(device, target-shard) bucket size: 4x the uniform
    expectation plus headroom."""
    return int(4 * ((m_local + n_shards - 1) // n_shards) + 8)


def _probe_routed(keys, values, queries, n_shards: int, mesh, depth: int, cap: int):
    """all_to_all probe: route each query to its owning shard, answer it
    there with K3, route the answers back. Arguments as
    :func:`_probe_sharded`. Returns (answers int32[M], overflowed bool[S])
    on the mesh's first device; when a shard's bucket for some target
    overflowed, the answers are incomplete and the caller falls back to
    :func:`_probe_sharded`."""
    m_local = queries[0].shape[0]
    bucket_cap = _bucket_capacity(m_local, n_shards)
    sends, places, overflow = [], [], []
    for q in queries:
        target = _shard_of(q, n_shards)
        # Rank of each query within its target bucket (stable, by position):
        # the one-hot running count of earlier rows with the same target.
        onehot = torch.nn.functional.one_hot(target, n_shards)
        rank = (onehot.cumsum(0) - onehot).gather(1, target[:, None])[:, 0]
        ok = rank < bucket_cap
        slot = torch.where(ok, target * bucket_cap + rank, n_shards * bucket_cap)
        # The padded send buffer with a validity lane; one spill row absorbs
        # the overflowing writes.
        send = torch.zeros((n_shards * bucket_cap + 1, 9), dtype=torch.int32, device=q.device)
        send[slot] = torch.cat([q, torch.ones((m_local, 1), dtype=torch.int32, device=q.device)], 1)
        sends.append(send[:-1])
        places.append((ok, slot.clamp(max=n_shards * bucket_cap - 1)))
        overflow.append((~ok).any())
    recv = mesh_lib.all_to_all(sends, mesh)
    found = [
        _probe_shard(k, v, rq[:, :8].contiguous(), cap, depth) * rq[:, 8]
        for k, v, rq in zip(keys, values, recv)
    ]
    back = mesh_lib.all_to_all(found, mesh)
    dev = mesh.devices[0]
    answers = torch.cat([
        torch.where(ok, b[slot], 0).to(dev) for b, (ok, slot) in zip(back, places)
    ])
    return answers, torch.stack([o.to(dev) for o in overflow])


def _stage(keys: np.ndarray, values: np.ndarray, depth: int, dev: torch.device):
    """The wrap-free padded layout of ``probe_cuda.pad_tables`` built
    straight on ``dev``: the table, then its first W rows again. Never an
    alias of the host arrays (inserts write those in place)."""
    cap = keys.shape[0]
    w = min(probe_cuda.window_rows(depth), cap)
    tk = torch.empty((cap + w, 8), dtype=torch.int32, device=dev)
    tv = torch.empty(cap + w, dtype=torch.int32, device=dev)
    with warnings.catch_warnings():  # a mmap'd load is read-only; only read here
        warnings.simplefilter("ignore", UserWarning)
        k_src = torch.from_numpy(np.asarray(keys).view(np.int32))
        v_src = torch.from_numpy(np.asarray(values))
    tk[:cap].copy_(k_src)
    tk[cap:].copy_(k_src[:w])
    tv[:cap].copy_(v_src)
    tv[cap:].copy_(v_src[:w])
    return tk, tv


def _resolve_mesh(mesh, device) -> "mesh_lib.Mesh":
    """``device=`` is a one-shard mesh on it; neither takes ``make_mesh()``."""
    if mesh is not None and device is not None:
        raise ValueError("pass a mesh or a device, not both")
    if device is not None:
        return mesh_lib.Mesh([device])
    return mesh if mesh is not None else mesh_lib.make_mesh()


class ShardedChunkDict:
    """Dedup dictionary, one shard per mesh device, grown in place."""

    def __init__(
        self,
        digests_u32: np.ndarray,
        mesh: "mesh_lib.Mesh | None" = None,
        capacity_factor: float = DEFAULT_HEADROOM,
        probe_backend: str = "auto",
        load_factor: float = DEFAULT_LOAD_FACTOR,
        device: "str | torch.device | None" = None,
    ):
        self._configure(_resolve_mesh(mesh, device), probe_backend, capacity_factor, load_factor)
        digests_u32 = np.asarray(digests_u32, dtype=np.uint32).reshape(-1, 8)
        self.n_entries = len(digests_u32)
        keys, values = _build_host_tables(digests_u32, self.n_shards, capacity_factor)
        self._put_tables(keys, values)
        self._n_unique = int(np.count_nonzero(self._values))

    def _configure(
        self, mesh: "mesh_lib.Mesh", probe_backend: str, capacity_factor: float, load_factor: float
    ) -> None:
        if probe_backend not in PROBE_BACKENDS:
            raise ValueError(f"unknown probe backend {probe_backend!r}")
        if not 0.0 < load_factor < 1.0:
            raise ValueError(f"load_factor must be in (0, 1), got {load_factor}")
        self.mesh = mesh
        self.n_shards = mesh.size
        self.device = mesh.devices[0]
        self.probe_backend = probe_backend
        self.capacity_factor = capacity_factor
        self.load_factor = load_factor
        # Epoch bumps once per mutation batch; rebuild_epoch marks the last
        # compaction point (journal entries before it are folded into the
        # base table and can no longer be replayed individually).
        self.epoch = 0
        self.rebuild_epoch = 0
        # (epoch, digests u32[k,8], stored values i64[k]) per insert batch
        # since the last rebuild — feeds save_incremental/entries_since.
        self._journal: list[tuple[int, np.ndarray, np.ndarray]] = []
        self._n_unique: "int | None" = None  # occupied slots (lazy for v4 loads)
        # Serializes mutation and device restaging. Reentrant:
        # save_incremental's full rewrite calls save while holding it.
        self._mu = _an.make_rlock("dict.mutate")
        self._staged = None  # (snapshot, [(keys_pad, vals_pad) per shard])
        self.restages = 0

    def _put_tables(
        self, keys: np.ndarray, values: np.ndarray, max_depth: "int | None" = None
    ) -> None:
        """Adopt host tables keys u32[S,C,8], values i32[S,C] (an mmap'd
        load's stay read-only until the first insert copies them)."""
        if max_depth is None:
            max_depth = _table_max_depth(keys, values)
        self._keys = np.ascontiguousarray(keys, dtype=np.uint32)
        self._values = np.ascontiguousarray(values, dtype=np.int32)
        self.capacity = self._keys.shape[1]
        self.max_depth = int(max_depth)
        self._publish()

    def _publish(self) -> None:
        """One snapshot tuple read by every probe: a concurrent insert or
        rebuild publishes tables, capacity and depth together."""
        self._tables = (self._keys, self._values, self.capacity, self.max_depth)

    def _slots(self) -> int:
        return self.n_shards * self.capacity

    # -- incremental growth --------------------------------------------------

    def insert_digests(self, digests: list[bytes]) -> np.ndarray:
        """Insert raw 32-byte digests; returns their dict indices."""
        if not digests:
            return np.zeros(0, dtype=np.int64)
        arr = np.frombuffer(b"".join(digests), dtype="<u4").reshape(len(digests), 8)
        return self.insert_u32(arr)

    def insert_u32(self, digests_u32: np.ndarray) -> np.ndarray:
        """Insert a batch of digests into spare capacity: u32[M,8] ->
        int64[M] dict indices.

        Semantics are exactly a fresh build over the concatenated insertion
        sequence: a digest already in the dict (or earlier in this batch)
        resolves to its first-occurrence index; new digests get consecutive
        indices continuing ``n_entries``. A load-factor breach or chain
        overflow triggers a value-preserving rebuild. Bumps ``epoch`` once.
        """
        digests_u32 = np.asarray(digests_u32, dtype=np.uint32).reshape(-1, 8)
        n = len(digests_u32)
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        failpoint.hit("dict.insert")
        with self._mu:
            base = self.n_entries
            if base + n + 1 >= 1 << 31:
                raise DictBuildError("chunk dict exceeds int32 index space")
            fast = self._insert_fast(digests_u32, base)
            if fast is not None:
                return fast
            # Batch-internal first occurrence (value semantics = index of
            # first occurrence in the concatenated sequence).
            void = np.ascontiguousarray(digests_u32).view(np.dtype((np.void, 32)))[:, 0]
            _, first, inverse = np.unique(void, return_index=True, return_inverse=True)
            uniq = digests_u32[first]
            # The live host tables, as the reference's native probe reads
            # them: an overflowed _insert_fast left its placed prefix there
            # without publishing, so the device copies cannot see it.
            existing = native_cdc.dict_probe_native(
                uniq, self._keys.reshape(-1, 8), self._values.reshape(-1),
                self.n_shards, self.capacity, self.max_depth,
            )  # int64, -1 = absent
            new_mask = existing < 0
            assigned = np.where(new_mask, base + first, existing)
            self.epoch += 1
            _INSERT_BATCHES.inc()
            if new_mask.any():
                ins_rows = np.sort(first[new_mask])
                ins_digests = np.ascontiguousarray(digests_u32[ins_rows])
                ins_values = (base + ins_rows + 1).astype(np.int64)  # stored form
                rebuilt = self._insert_entries(ins_digests, ins_values)
                if not rebuilt:
                    self._journal.append((self.epoch, ins_digests, ins_values))
                _INSERT_ENTRIES.inc(len(ins_rows))
            self.n_entries = base + n
            return assigned[inverse.reshape(-1)].astype(np.int64)

    def _writable(self) -> None:
        """mmap'd load: copy on the first insert (probes before it keep the
        lazily page-faulting map)."""
        if not self._keys.flags.writeable:
            self._keys = np.array(self._keys)
            self._values = np.array(self._values)
            self._publish()

    def _insert_fast(self, digests_u32: np.ndarray, base: int) -> "np.ndarray | None":
        """One native pass over the batch (probe-or-insert per entry, in
        order): no host-side dedup sort and no separate lookup. Returns the
        assigned indices, or None when the dict is empty, a worst-case
        batch would breach the load factor, or a chain overflowed mid-batch
        (the entries placed so far carry their final values; the vectorized
        fallback probes the live host tables, where those within the
        published depth read as hits). Caller holds ``_mu``."""
        n = len(digests_u32)
        if self.n_entries == 0:
            return None
        if self._ensure_unique_count() + n > int(self.load_factor * self._slots()):
            return None  # worst-case (all new) breaches: take the slow path
        self._writable()
        res = native_cdc.dict_upsert_native(
            np.ascontiguousarray(digests_u32), base, self.n_shards, self.capacity,
            INSERT_MAX_PROBE, self._keys.reshape(-1, 8), self._values.reshape(-1),
        )
        if res is None:
            return None
        depth, n_new, assigned = res
        self.epoch += 1
        _INSERT_BATCHES.inc()
        if n_new:
            new_mask = assigned == (base + np.arange(n, dtype=np.int64))
            ins_digests = np.ascontiguousarray(digests_u32[new_mask])
            ins_values = assigned[new_mask] + 1  # stored (+1) form
            self._journal.append((self.epoch, ins_digests, ins_values))
            _INSERT_ENTRIES.inc(n_new)
            self._n_unique = self._ensure_unique_count() + n_new
            self.max_depth = max(self.max_depth, depth)
            self._publish()
        self.n_entries = base + n
        return assigned

    def _ensure_unique_count(self) -> int:
        if self._n_unique is None:  # legacy v4 load: count once, lazily
            self._n_unique = int(np.count_nonzero(self._values))
        return self._n_unique

    def _insert_entries(self, digests: np.ndarray, stored_values: np.ndarray) -> bool:
        """Place unique, absent digests with explicit stored values (+1
        form). Returns True when the batch forced a full rebuild. Caller
        holds ``_mu`` (or is still constructing the instance)."""
        k = len(digests)
        if k == 0:
            return False
        self._writable()
        if self._ensure_unique_count() + k > int(self.load_factor * self._slots()):
            self._rebuild(digests, stored_values)
            return True
        depth = native_cdc.dict_insert_native(
            np.ascontiguousarray(digests),
            np.ascontiguousarray(stored_values.astype(np.int32)),
            self.n_shards, self.capacity, INSERT_MAX_PROBE,
            self._keys.reshape(-1, 8), self._values.reshape(-1),
        )
        if depth < 0:
            # Chain overflow: fold the whole batch into a rebuild (the
            # placed prefix is in the table; the build's first-wins dedup
            # drops those duplicates).
            self._rebuild(digests, stored_values)
            return True
        self._n_unique = self._ensure_unique_count() + k
        self.max_depth = max(self.max_depth, depth)
        self._publish()
        return False

    def _rebuild(
        self,
        extra_digests: "np.ndarray | None" = None,
        extra_values: "np.ndarray | None" = None,
    ) -> None:
        """Value-preserving full rebuild with ``capacity_factor`` headroom.

        Stored values are first-occurrence indices and must survive: the
        fresh build assigns positional values over the value-ordered digest
        list, which are then remapped onto the original stored values.
        Compaction point: the journal resets and ``rebuild_epoch`` advances
        to the current epoch.
        """
        failpoint.hit("dict.rebuild")
        _REBUILDS.inc()
        occ = self._values != 0
        digs = self._keys[occ]
        vals = self._values[occ].astype(np.int64)
        if extra_digests is not None and len(extra_digests):
            digs = np.concatenate([digs, extra_digests])
            vals = np.concatenate([vals, np.asarray(extra_values, dtype=np.int64)])
        order = np.argsort(vals, kind="stable")
        digs = np.ascontiguousarray(digs[order])
        vals = vals[order]
        keys, values = _build_host_tables(digs, self.n_shards, self.capacity_factor)
        # Rebuilt values index into ``digs``; remap onto the stored values.
        orig = np.concatenate([[0], vals]).astype(np.int32)
        self._put_tables(keys, orig[values])
        self._n_unique = len(digs)
        self._journal = []
        self.rebuild_epoch = self.epoch

    def entries_since(self, since_epoch: int) -> tuple[np.ndarray, np.ndarray, int]:
        """Journal replay for epoch reconciliation: entries inserted after
        ``since_epoch`` as (digests u32[k,8], indices int64[k], epoch).
        Raises :class:`DictEpochError` when the epoch predates the last
        rebuild (the journal was compacted; caller must full-resync)."""
        with self._mu:
            if since_epoch < self.rebuild_epoch:
                raise DictEpochError(
                    f"epoch {since_epoch} predates last rebuild "
                    f"(epoch {self.rebuild_epoch}); reload a full snapshot"
                )
            batches = [(d, v) for e, d, v in self._journal if e > since_epoch]
            if not batches:
                return (
                    np.zeros((0, 8), dtype=np.uint32),
                    np.zeros(0, dtype=np.int64),
                    self.epoch,
                )
            digs = np.concatenate([d for d, _ in batches])
            vals = np.concatenate([v for _, v in batches]) - 1  # stored -> index
            return digs, vals, self.epoch

    def copy(self) -> "ShardedChunkDict":
        """Deep copy of tables and growth state, on the same mesh."""
        with self._mu:
            other = self.__class__.__new__(self.__class__)
            other._configure(self.mesh, self.probe_backend, self.capacity_factor, self.load_factor)
            other.epoch = self.epoch
            other.rebuild_epoch = self.rebuild_epoch
            other._journal = [(e, d.copy(), v.copy()) for e, d, v in self._journal]
            other._n_unique = self._n_unique
            other.n_entries = self.n_entries
            other._put_tables(self._keys.copy(), self._values.copy(), self.max_depth)
            return other

    def fused_probe_tables(self) -> tuple[np.ndarray, np.ndarray, int, int]:
        """(keys u32[C,8], values i32[C], depth, epoch) of the single shard's
        published snapshot, the reference's surface for the fused engine."""
        if self.n_shards != 1:
            raise DictBuildError(f"fused probe wants a single-shard dict, have {self.n_shards}")
        keys, values, _cap, depth = self._tables
        return keys[0], values[0], depth, self.epoch

    def device_shards(self) -> tuple[list[tuple[torch.Tensor, torch.Tensor]], int, int]:
        """([(keys_pad int32[C+W, 8], vals_pad int32[C+W]) per shard, each on
        its shard's device], capacity, depth): the padded copies of the
        published snapshot, restaged once after each mutation, and the
        geometry they were padded for. Every device probe reads them."""
        staged = self._staged
        if staged is None or staged[0] is not self._tables:
            with self._mu:
                tables = self._tables
                staged = self._staged
                if staged is None or staged[0] is not tables:
                    keys, values, _cap, depth = tables
                    staged = (tables, [
                        _stage(keys[s], values[s], depth, dev)
                        for s, dev in enumerate(self.mesh.devices)
                    ])
                    self._staged = staged
                    self.restages += 1
        return staged[1], staged[0][2], staged[0][3]

    def device_snapshot(self) -> tuple[torch.Tensor, torch.Tensor, int, int]:
        """(keys_pad, vals_pad, capacity, depth) of a single-shard dict's
        staged copy (:meth:`device_shards`), as the fused engine reads it."""
        if self.n_shards != 1:
            raise DictBuildError(f"fused probe wants a single-shard dict, have {self.n_shards}")
        shards, cap, depth = self.device_shards()
        return shards[0][0], shards[0][1], cap, depth

    # -- persistence ----------------------------------------------------------
    #
    # Dense raw format: a fixed header (with max_depth, so loading never
    # rescans the table) and both tables as raw bytes; load is an mmap whose
    # pages fault in as probes touch them. The v5 header adds the epoch
    # stamp and the count of tail records appended by save_incremental.

    def _header_bytes(self, tail_count: int) -> bytes:
        return _RAW_MAGIC + np.asarray(
            [
                _RAW_FORMAT_VERSION_5, self.n_shards, self.n_entries,
                self.capacity, self.max_depth, self.epoch, self.rebuild_epoch,
                self._ensure_unique_count(), tail_count, 0,
            ],
            dtype=np.uint64,
        ).tobytes()

    def save(self, path: str) -> None:
        """Persist the full table, epoch-stamped (reload with ``load``, no
        rebuild). The file carries zero tail entries: it is the compaction
        ``save_incremental`` appends against."""
        with self._mu:
            with open(path, "wb") as f:
                f.write(self._header_bytes(0))
                self._keys.tofile(f)
                self._values.tofile(f)

    def save_incremental(self, path: str) -> dict:
        """Refresh a saved snapshot by appending only the entries it lacks.

        Appends the journal batches newer than the file's epoch as tail
        records and re-stamps the header. Falls back to a full rewrite —
        compaction — when the base table was rebuilt since the file was
        written, the file belongs to a different table shape, or the file
        does not exist. Returns ``{"mode": "append"|"full", "appended": k}``.
        """
        with self._mu:
            hdr = _read_v5_header(path)
            if (
                hdr is not None
                and hdr["n_shards"] == self.n_shards
                and hdr["capacity"] == self.capacity
                and hdr["rebuild_epoch"] == self.rebuild_epoch
                and hdr["epoch"] <= self.epoch
            ):
                pending = [(d, v) for e, d, v in self._journal if e > hdr["epoch"]]
                k = sum(len(d) for d, _ in pending)
                expect = (
                    8 + 8 * _RAW_HEADER_FIELDS_V5
                    + self._slots() * 36
                    + hdr["tail_count"] * _TAIL_RECORD_DT.itemsize
                )
                if os.path.getsize(path) == expect:
                    with open(path, "r+b") as f:
                        # Tail first, header last: a torn append leaves the
                        # old header, whose tail_count ignores the partial
                        # records past the end it describes.
                        f.seek(0, 2)
                        for digs, vals in pending:
                            rec = np.zeros(len(digs), dtype=_TAIL_RECORD_DT)
                            rec["d"] = digs
                            rec["v"] = vals.astype(np.uint64)
                            rec.tofile(f)
                        f.seek(0)
                        f.write(self._header_bytes(hdr["tail_count"] + k))
                    return {"mode": "append", "appended": k}
            self.save(path)
            return {"mode": "full", "appended": self.n_entries}

    @classmethod
    def load(
        cls,
        path: str,
        mesh: "mesh_lib.Mesh | None" = None,
        probe_backend: str = "auto",
        capacity_factor: float = DEFAULT_HEADROOM,
        load_factor: float = DEFAULT_LOAD_FACTOR,
        device: "str | torch.device | None" = None,
    ) -> "ShardedChunkDict":
        """Load a file ``save``/``save_incremental`` wrote (v5, its tail
        replayed with the original values), a v4 raw file, or a legacy
        ``.npz`` (format 1) — the reference package's files included. Raw
        tables are mapped read-only; a file of another shard count is
        rebuilt for the loading mesh."""
        mesh = _resolve_mesh(mesh, device)
        with open(path, "rb") as f:
            magic = f.read(8)
        tail = None
        epoch = rebuild_epoch = 0
        n_unique: "int | None" = None
        if magic == _RAW_MAGIC:
            hdr5 = _read_v5_header(path)
            if hdr5 is not None:
                n_shards, n_entries = hdr5["n_shards"], hdr5["n_entries"]
                cap, max_depth = hdr5["capacity"], hdr5["max_depth"]
                epoch, rebuild_epoch = hdr5["epoch"], hdr5["rebuild_epoch"]
                base = 8 + 8 * _RAW_HEADER_FIELDS_V5
                tail_count = hdr5["tail_count"]
                n_unique = hdr5["n_unique"] - tail_count  # base-table occupancy
                tail_base = base + n_shards * cap * 36
                if os.path.getsize(path) < tail_base + tail_count * _TAIL_RECORD_DT.itemsize:
                    raise DictBuildError("chunk dict file truncated")
                if tail_count:
                    tail = np.fromfile(
                        path, dtype=_TAIL_RECORD_DT, count=tail_count, offset=tail_base
                    )
            else:
                hdr = np.fromfile(path, dtype=np.uint64, count=_RAW_HEADER_FIELDS, offset=8)
                if len(hdr) != _RAW_HEADER_FIELDS:
                    raise DictBuildError("chunk dict file truncated (short header)")
                version, n_shards, n_entries, cap, max_depth = (int(x) for x in hdr)
                if version != _RAW_FORMAT_VERSION:
                    raise DictBuildError(
                        f"chunk dict file format {version} != {_RAW_FORMAT_VERSION}"
                    )
                base = 8 + 8 * _RAW_HEADER_FIELDS
                if os.path.getsize(path) < base + n_shards * cap * 36:
                    raise DictBuildError("chunk dict file truncated")
            keys = np.memmap(
                path, dtype=np.uint32, mode="r", offset=base, shape=(n_shards, cap, 8)
            )
            values = np.memmap(
                path, dtype=np.int32, mode="r", offset=base + keys.nbytes, shape=(n_shards, cap)
            )
            loaded_depth = int(max_depth)
        else:
            with np.load(path) as z:
                if int(z["format_version"]) != _FORMAT_VERSION:
                    raise DictBuildError(
                        f"chunk dict file format {int(z['format_version'])} != {_FORMAT_VERSION}"
                    )
                keys, values = z["keys"], z["values"]
                n_shards, n_entries = int(z["n_shards"]), int(z["n_entries"])
            loaded_depth = None  # legacy files carry no depth: rescan
        self = cls.__new__(cls)
        self._configure(mesh, probe_backend, capacity_factor, load_factor)
        self.n_entries = n_entries
        if self.n_shards != n_shards:
            # The shard count is baked into the layout: rebuild for this
            # mesh from the stored keys (empties dropped, first-wins order
            # by stored value = original insertion index) at the default
            # headroom, as the reference does, and remap the rebuilt values
            # back onto the stored ones.
            flat_v = values.reshape(-1)
            occupied = flat_v != 0
            order = np.argsort(flat_v[occupied], kind="stable")
            digests = keys.reshape(-1, 8)[occupied][order]
            k2, v2 = _build_host_tables(digests, self.n_shards)
            orig = np.concatenate([[0], np.sort(flat_v[occupied])]).astype(np.int32)
            self._put_tables(k2, orig[v2])
            self._n_unique = int(occupied.sum())
        else:
            self._put_tables(keys, values, max_depth=loaded_depth)
            self._n_unique = n_unique
        self.epoch = epoch
        self.rebuild_epoch = rebuild_epoch
        if tail is not None and len(tail):
            # Replay the appended entries with their original values
            # (probe-identical to the in-memory incremental inserts).
            digs = np.ascontiguousarray(tail["d"])
            vals = tail["v"].astype(np.int64)
            if not self._insert_entries(digs, vals):
                self._journal = [(epoch, digs, vals)]
        self.n_entries = n_entries
        return self

    # -- probing --------------------------------------------------------------

    def lookup_u32(self, queries_u32: np.ndarray) -> np.ndarray:
        """Probe a batch: u32[M,8] digests -> int64[M] dict indices (-1 = miss).

        ``"host"`` probes the published snapshot with the native engine. On
        one shard every other backend launches K3 once over all queries; on
        more, ``"pallas"`` launches it once per shard over the shard's
        queries, and ``"auto"``/``"device"`` route the unique queries over
        the mesh (:func:`_probe_routed`, :func:`_probe_sharded` on a bucket
        overflow)."""
        queries_u32 = np.asarray(queries_u32, dtype=np.uint32).reshape(-1, 8)
        m = len(queries_u32)
        if m == 0:
            return np.zeros(0, dtype=np.int64)
        if self.n_entries == 0:
            return np.full(m, -1, dtype=np.int64)
        if self.probe_backend == "host":
            keys, values, cap, depth = self._tables
            return native_cdc.dict_probe_native(
                queries_u32, keys.reshape(-1, 8), values.reshape(-1), self.n_shards, cap, depth
            )
        if self.n_shards == 1 or self.probe_backend == "pallas":
            return self._lookup_per_shard(queries_u32)
        # Route unique queries only: duplicates would concentrate buckets
        # (and waste probe work); uniqueness restores the uniform digest
        # distribution the bucket capacity is sized for.
        void = np.ascontiguousarray(queries_u32).view(np.dtype((np.void, 32)))[:, 0]
        _, first, inverse = np.unique(void, return_index=True, return_inverse=True)
        return self._lookup_unique(queries_u32[first])[inverse.reshape(-1)]

    def _lookup_per_shard(self, queries_u32: np.ndarray) -> np.ndarray:
        """The reference's ``_lookup_pallas``: queries partitioned by owning
        shard on the host, one K3 launch per shard that has any (on one
        shard, one launch over the queries as given)."""
        shards, cap, depth = self.device_shards()
        if self.n_shards == 1:
            tk, tv = shards[0]
            ans = _probe_shard(tk, tv, from_u32(queries_u32, tk.device), cap, depth)
            return ans.cpu().numpy().astype(np.int64) - 1
        out = np.zeros(len(queries_u32), dtype=np.int64)
        shard_of = queries_u32[:, 0] % np.uint32(self.n_shards)
        for s, (tk, tv) in enumerate(shards):
            idx = np.nonzero(shard_of == s)[0]
            if len(idx):
                ans = _probe_shard(tk, tv, from_u32(queries_u32[idx], tk.device), cap, depth)
                out[idx] = ans.cpu().numpy()
        return out - 1

    def _lookup_unique(self, queries_u32: np.ndarray) -> np.ndarray:
        """Routed probe of unique queries, padded with zero rows to the
        mesh; the dense probe reruns them on a bucket overflow."""
        m = len(queries_u32)
        pad = (-m) % self.n_shards
        if pad:
            queries_u32 = np.concatenate([queries_u32, np.zeros((pad, 8), dtype=np.uint32)])
        shards, cap, depth = self.device_shards()
        keys = [k for k, _ in shards]
        values = [v for _, v in shards]
        q = mesh_lib.shard_rows(queries_u32.view(np.int32), self.mesh)
        ans, overflowed = _probe_routed(keys, values, q, self.n_shards, self.mesh, depth, cap)
        if bool(overflowed.any()):
            ans = _probe_sharded(keys, values, q, self.n_shards, self.mesh, depth, cap)
        return ans[:m].cpu().numpy().astype(np.int64) - 1

    def lookup_digests(self, digests: list[bytes]) -> np.ndarray:
        """Probe raw 32-byte digests."""
        if not digests:
            return np.zeros(0, dtype=np.int64)
        arr = np.frombuffer(b"".join(digests), dtype="<u4").reshape(len(digests), 8)
        return self.lookup_u32(arr)


def _read_v5_header(path: str) -> "dict | None":
    try:
        with open(path, "rb") as f:
            magic = f.read(8)
            raw = f.read(8 * _RAW_HEADER_FIELDS_V5)
    except OSError:
        return None
    if magic != _RAW_MAGIC or len(raw) != 8 * _RAW_HEADER_FIELDS_V5:
        return None
    vals = np.frombuffer(raw, dtype=np.uint64)
    if int(vals[0]) != _RAW_FORMAT_VERSION_5:
        return None
    names = (
        "version", "n_shards", "n_entries", "capacity", "max_depth",
        "epoch", "rebuild_epoch", "n_unique", "tail_count",
    )
    return {k: int(v) for k, v in zip(names, vals)}


def from_tables(
    keys: np.ndarray,
    values: np.ndarray,
    depth: int,
    epoch: int = 0,
    device: "str | torch.device | None" = None,
) -> ShardedChunkDict:
    """A dict over tables built elsewhere: keys u32[C,8], values i32[C]
    (C a power of two), its max chain ``depth`` and mutation ``epoch`` —
    what the reference's ``ShardedChunkDict.fused_probe_tables()`` returns."""
    keys = np.asarray(keys, dtype=np.uint32)
    values = np.asarray(values, dtype=np.int32)
    cap = keys.shape[0]
    if keys.shape != (cap, 8) or values.shape != (cap,) or cap & (cap - 1) or cap == 0:
        raise DictBuildError(
            f"want keys u32[C,8] and values i32[C] with C a power of two, got "
            f"{keys.shape} and {values.shape}"
        )
    d = ShardedChunkDict.__new__(ShardedChunkDict)
    d._configure(mesh_lib.Mesh([device]), "auto", DEFAULT_HEADROOM, DEFAULT_LOAD_FACTOR)
    d.n_entries = int(np.count_nonzero(values))
    d._put_tables(keys[None], values[None], depth)
    d.epoch = int(epoch)
    d._n_unique = d.n_entries
    return d
