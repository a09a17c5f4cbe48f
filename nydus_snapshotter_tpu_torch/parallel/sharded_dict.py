"""Device-resident chunk dictionary for cross-image dedup — single shard.

The single-shard subset of the reference's parallel/sharded_dict.py:

- **Layout.** Open-addressing table: keys ``u32[C, 8]`` (a digest as 8
  words), values ``i32[C]`` (dict index + 1; 0 = empty). Slot base =
  ``digest_word1 mod C``, bounded linear probing.
- **Build.** Host-side, vectorized numpy (the reference's numpy path):
  entries march down their probe chains in lockstep rounds, first
  insertion wins, identical to sequential insertion order.
- **Probe.** The padded-table kernel (ops/probe_cuda.py) over the table on
  the dict's device; ``_probe_local`` is the plain gather formulation over
  the unpadded table.
- **State carried across.** :func:`from_tables` takes the tables a
  reference ``ShardedChunkDict.fused_probe_tables()`` returns, so a dict
  built there probes identically here.
"""

from __future__ import annotations

import numpy as np
import torch

from nydus_snapshotter_tpu_torch.ops import probe_cuda
from nydus_snapshotter_tpu_torch.tensors import from_u32, resolve_device

# Longest probe chain the BUILD tolerates before doubling capacity; probes
# bound their loops by the table's actual max chain (_table_max_depth).
MAX_PROBE = 64
DEFAULT_HEADROOM = 2.0


class DictBuildError(RuntimeError):
    pass


def _build_host_tables(
    digests: np.ndarray, n_shards: int = 1, capacity_factor: float = DEFAULT_HEADROOM
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic vectorized build -> (keys u32[S,C,8], values i32[S,C]).

    First-insertion-wins without any global sort: entries march down their
    probe chains in lockstep rounds. Per round, an entry whose candidate
    slot holds its own digest is a duplicate and is dropped; contenders for
    one free slot are resolved first-come via a reverse-order scatter (numpy
    duplicate-index scatter keeps the last write, so scattering positions in
    reverse makes the earliest entry win). Duplicates that lose a slot race
    to their own digest land later in the probe chain, where lookups (which
    take the first match in chain order) never reach them — value semantics
    stay "index of first occurrence".
    """
    digests = np.ascontiguousarray(digests, dtype=np.uint32)
    n = len(digests)
    shard_of = digests[:, 0] % np.uint32(n_shards) if n else np.zeros(0, np.uint32)
    max_count = int(np.bincount(shard_of, minlength=n_shards).max()) if n else 0
    cap = max(64, 1 << int(np.ceil(np.log2(max(1, capacity_factor * max_count)))))

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


class ShardedChunkDict:
    """Single-shard device dedup dictionary (``n_shards == 1``)."""

    def __init__(
        self,
        digests_u32: np.ndarray,
        capacity_factor: float = DEFAULT_HEADROOM,
        device: "str | torch.device | None" = None,
    ):
        self.device = resolve_device(device)
        digests_u32 = np.asarray(digests_u32, dtype=np.uint32).reshape(-1, 8)
        self.n_entries = len(digests_u32)
        keys, values = _build_host_tables(digests_u32, 1, capacity_factor)
        self._set_tables(keys[0], values[0], _table_max_depth(keys, values), epoch=0)

    def _set_tables(self, keys: np.ndarray, values: np.ndarray, depth: int, epoch: int) -> None:
        self._keys = np.ascontiguousarray(keys, dtype=np.uint32)
        self._values = np.ascontiguousarray(values, dtype=np.int32)
        self.capacity = self._keys.shape[0]
        self.max_depth = int(depth)
        self.epoch = int(epoch)
        self._staged = None  # padded device tables, staged on first probe

    def fused_probe_tables(self) -> tuple[np.ndarray, np.ndarray, int, int]:
        """(keys u32[C,8], values i32[C], depth, epoch) for the fused
        engine's pass-2 probe (ops/fused_convert)."""
        return self._keys, self._values, self.max_depth, self.epoch

    def device_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The wrap-free padded tables on the dict's device (keys
        int32[C+W, 8], values int32[C+W]) that every probe of this dict
        reads: staged on first use, dropped when the tables change."""
        if self._staged is None:
            keys_pad, vals_pad = probe_cuda.pad_tables(self._keys, self._values, self.max_depth)
            self._staged = (
                from_u32(keys_pad, self.device),
                torch.from_numpy(vals_pad.reshape(-1)).to(self.device),
            )
        return self._staged

    def lookup_u32(self, queries_u32: np.ndarray) -> np.ndarray:
        """Probe a batch: u32[M,8] digests -> int64[M] dict indices (-1 = miss)."""
        queries_u32 = np.asarray(queries_u32, dtype=np.uint32).reshape(-1, 8)
        m = len(queries_u32)
        if m == 0:
            return np.zeros(0, dtype=np.int64)
        if self.n_entries == 0:
            return np.full(m, -1, dtype=np.int64)
        tk, tv = self.device_tables()
        q = from_u32(queries_u32, self.device)
        wstart, off = probe_cuda.window_starts(q, self.capacity)
        ans = probe_cuda.probe_padded(tk, tv, q, wstart, off, self.max_depth)
        return ans.cpu().numpy().astype(np.int64) - 1


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
    d.device = resolve_device(device)
    d.n_entries = int(np.count_nonzero(values))
    d._set_tables(keys, values, depth, epoch)
    return d
