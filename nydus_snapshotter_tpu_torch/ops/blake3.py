"""BLAKE3 over batches of messages, as plain tensor ops.

Counterpart of the reference's ops/blake3_jax.py, with the same layout: one
message is ``[C, 16, 16]`` little-endian words (C leaves of 1024 bytes x 16
blocks x 16 words, C a power of two) plus its byte length; a batch is
``[M, C, 16, 16]`` + ``[M]`` lengths. The leaf phase scans the 16 blocks of
every (message, leaf) lane at once; the tree phase merges log2(C) levels,
"pair adjacent, odd lane promotes" (the spec's largest-power-of-two left
subtree), ROOT on the last merge. Flags are lane tensors, so single-leaf
ROOT finalization and ragged tails need no control flow per lane. The
compression counter is the leaf index (high word 0).

Words are int32 tensors holding the u32 bit pattern at the boundary; inside,
int64 masked to 32 bits (CPU torch has no uint32 shift). This is the plain
version of kernel K4 (ops/blake3_cuda.py) and the CPU path, not a fast path.
The numpy packing helpers are copies of the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from nydus_snapshotter_tpu_torch.tensors import MASK32, as_int32, as_u32_int64

IV = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint32,
)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

_PERM = [2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8]
# _SCHED[r][i]: the word of the ORIGINAL block that round r uses at
# position i (identity, then _PERM composed r times).
_SCHED = [list(range(16))]
for _ in range(6):
    _SCHED.append([_SCHED[-1][p] for p in _PERM])

LEAF_BYTES = 1024
BLOCKS_PER_LEAF = 16


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate right of clean u32 values held in int64."""
    return ((x >> r) | (x << (32 - r))) & MASK32


def _g(v: list, a: int, b: int, c: int, d: int, mx, my) -> None:
    va = (v[a] + v[b] + mx) & MASK32
    vd = _rotr(v[d] ^ va, 16)
    vc = (v[c] + vd) & MASK32
    vb = _rotr(v[b] ^ vc, 12)
    va = (va + vb + my) & MASK32
    vd = _rotr(vd ^ va, 8)
    vc = (vc + vd) & MASK32
    vb = _rotr(vb ^ vc, 7)
    v[a], v[b], v[c], v[d] = va, vb, vc, vd


def _compress(cv: list, m: list, counter, block_len, flags) -> list:
    """One compression over lanes: cv 8 and m 16 int64 tensors (u32
    values); counter, block_len, flags int64 tensors or ints (broadcast).
    Returns the 8-word output chaining value (v[0:8] ^ v[8:16])."""
    like = cv[0]
    v = list(cv) + [torch.full_like(like, int(IV[i])) for i in range(4)]
    v += [torch.zeros_like(like) + counter, torch.zeros_like(like),
          torch.zeros_like(like) + block_len, torch.zeros_like(like) + flags]
    for s in _SCHED[:7]:
        _g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    return [v[i] ^ v[i + 8] for i in range(8)]


def blake3_batch(blocks: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Digest a batch: blocks int32[M, C, 16, 16] LE words (C a power of
    two), lengths int32[M] -> int32[M, 8] little-endian digest words.

    Leaf phase: every (message, leaf) lane scans its 16 blocks; a lane
    past its leaf's last block keeps its CV, blocks past every lane's last
    are never visited. Tree phase: as the reference's ``_blake3_one``
    (blake3_jax.py:184-211)."""
    m, c = blocks.shape[0], blocks.shape[1]
    if c & (c - 1):
        raise ValueError(f"leaf capacity {c} is not a power of two")
    dev = blocks.device
    length = lengths.to(torch.int64)
    n_leaf = torch.clamp((length + LEAF_BYTES - 1) // LEAF_BYTES, min=1)  # [M]
    leaf_idx = torch.arange(c, dtype=torch.int64, device=dev)[None, :]  # [1, C]
    leaf_len = torch.clamp(length[:, None] - leaf_idx * LEAF_BYTES, 0, LEAF_BYTES)  # [M, C]
    nblocks = torch.clamp((leaf_len + 63) // 64, min=1)
    single = (n_leaf == 1)[:, None]
    cv = [torch.full((m, c), int(IV[i]), dtype=torch.int64, device=dev) for i in range(8)]
    last = int(nblocks.max()) if m else 0
    for j in range(last):
        words = as_u32_int64(blocks[:, :, j, :])  # [M, C, 16]
        blen = torch.clamp(leaf_len - j * 64, 0, 64)
        end = nblocks == j + 1
        flags = (CHUNK_START if j == 0 else 0) + end * CHUNK_END + (end & single) * ROOT
        new = _compress(cv, [words[..., i] for i in range(16)], leaf_idx, blen, flags)
        live = j < nblocks
        cv = [torch.where(live, n_, o) for n_, o in zip(new, cv)]

    k = n_leaf
    width = c
    iv = [int(x) for x in IV]
    while width > 1:
        half = width // 2
        left = [x[:, 0::2][:, :half] for x in cv]
        right = [x[:, 1::2] for x in cv]
        lane = torch.arange(half, dtype=torch.int64, device=dev)[None, :]
        flags = PARENT + ((lane == 0) & (k[:, None] == 2)) * ROOT
        ivs = [torch.full_like(left[0], x) for x in iv]
        merged = _compress(ivs, left + right, 0, 64, flags)
        has_pair = (2 * lane + 1) < k[:, None]
        cv = [torch.where(has_pair, a, b) for a, b in zip(merged, left)]
        k = (k + 1) // 2
        width = half
    return as_int32(torch.stack([x[:, 0] for x in cv], dim=1))


# ---------------------------------------------------------------------------
# Host-side packing (copies of the reference's)
# ---------------------------------------------------------------------------


def n_leaves(length: int) -> int:
    """Leaf count of a message (>= 1: the empty message is one leaf)."""
    return max((length + LEAF_BYTES - 1) // LEAF_BYTES, 1)


def pack_messages_np(
    msgs: list[bytes | np.ndarray], leaf_capacity: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Pack messages into a fixed-shape batch (u32[M,C,16,16], i32[M]);
    C is the leaf capacity rounded up to a power of two (the tree phase
    halves the lane width level by level)."""
    lengths = np.asarray([len(m) for m in msgs], dtype=np.int32)
    need = max((n_leaves(int(n)) for n in lengths), default=1)
    cap = leaf_capacity or need
    if len(msgs) and need > cap:
        raise ValueError(f"message needs {need} leaves > capacity {cap}")
    cap = 1 << (cap - 1).bit_length() if cap > 1 else 1
    out = np.zeros((len(msgs), cap * LEAF_BYTES), dtype=np.uint8)
    for i, m in enumerate(msgs):
        src = m if isinstance(m, np.ndarray) else np.frombuffer(m, dtype=np.uint8)
        out[i, : lengths[i]] = src
    blocks = out.view("<u4").astype(np.uint32).reshape(len(msgs), cap, BLOCKS_PER_LEAF, 16)
    return blocks, lengths


def digest_to_bytes(words: np.ndarray) -> bytes:
    """u32[8] digest words -> canonical 32-byte little-endian digest."""
    return np.asarray(words, dtype="<u4").tobytes()


# ---------------------------------------------------------------------------
# Chunks read from a flat buffer: the plain version of K4
# ---------------------------------------------------------------------------

# Elements of one gather's index tensor, and padded bytes of one plain
# batch (its int64 words and lane tensors scale with it).
_GATHER_ELEMS = 1 << 24
_PLAIN_SLICE_BYTES = 1 << 27


def gather_pack_b3(
    buffer: torch.Tensor, offs: torch.Tensor, sizes: torch.Tensor, cap_leaves: int
) -> torch.Tensor:
    """Gather chunks at byte-exact offsets into the batch layout
    int32[M, cap_leaves, 16, 16] of LE words, zero past each chunk's end:
    the reference's ``_gather_pack_b3`` (fused_convert.py:222-243). Built a
    group of leaf columns at a time so the index tensor stays bounded."""
    m = offs.shape[0]
    dev = buffer.device
    out = torch.empty((m, cap_leaves, LEAF_BYTES), dtype=torch.uint8, device=dev)
    off = offs.to(torch.int64)[:, None]
    size = sizes.to(torch.int64)[:, None]
    top = max(buffer.numel() - 1, 0)
    group = max(1, min(cap_leaves, _GATHER_ELEMS // max(1, m * LEAF_BYTES)))
    for lo in range(0, cap_leaves, group):
        hi = min(cap_leaves, lo + group)
        pos = torch.arange(lo * LEAF_BYTES, hi * LEAF_BYTES, dtype=torch.int64, device=dev)
        raw = buffer[(off + pos).clamp_(max=top)]
        out[:, lo:hi] = torch.where(pos < size, raw, 0).reshape(m, hi - lo, LEAF_BYTES)
    # Both the host and the card are little-endian: four bytes viewed as
    # one int32 are the LE word.
    return out.view(torch.int32).reshape(m, cap_leaves, BLOCKS_PER_LEAF, 16)


def blake3_chunks_plain(
    buffer: torch.Tensor, offs: torch.Tensor, sizes: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version of K4 (any device): gather + batch BLAKE3
    in row slices, -> int32[M, 8] LE digest words.

    Rows are taken longest first, so each slice is padded to the
    power-of-two leaf count of its own first row, and a slice's padded
    bytes stay within ``_PLAIN_SLICE_BYTES``."""
    m = offs.shape[0]
    dev = buffer.device
    out = torch.empty((m, 8), dtype=torch.int32, device=dev)
    offs, sizes = offs.to(dev), sizes.to(dev)
    order = torch.argsort(sizes, descending=True, stable=True)
    offs, sizes = offs[order], sizes[order]
    leaves = torch.clamp((sizes.to(torch.int64) + LEAF_BYTES - 1) // LEAF_BYTES, min=1)
    leaves_host = leaves.tolist()
    s = 0
    while s < m:
        cap = _pow2_ceil(leaves_host[s])
        e = min(m, s + max(1, _PLAIN_SLICE_BYTES // (cap * LEAF_BYTES)))
        blocks = gather_pack_b3(buffer, offs[s:e], sizes[s:e], cap)
        out[order[s:e]] = blake3_batch(blocks, sizes[s:e])
        s = e
    return out


def _pow2_ceil(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1
