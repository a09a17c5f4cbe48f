"""Plain BLAKE3 (the default 32-byte hash), vectorized with numpy.

Written from the BLAKE3 specification (O'Connor, Aumasson, Neves,
Wilcox-O'Hearn, 2020): 1024-byte chunks ("leaves" here, since the
converter's chunks are the inputs) of 64-byte blocks, the leaf counter in
the compression, CHUNK_START / CHUNK_END / PARENT / ROOT flags, and the
left-complete binary tree of parent nodes. Every input's leaves compress
side by side (one numpy lane per leaf), then the tree is reduced one level
at a time across all inputs: adjacent nodes pair, an odd last node rises
unchanged, which builds exactly the specification's tree.
"""

from __future__ import annotations

import numpy as np

IV = np.array([0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
               0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19], dtype=np.uint32)
PERMUTE = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
CHUNK_START, CHUNK_END, PARENT, ROOT = 1, 2, 4, 8
LEAF = 1024
BLOCK = 64
_ROUNDS = 7
_GS = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
       (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def _rotr(x: np.ndarray, n: int, tmp: np.ndarray) -> None:
    """x = x rotated right by n, in place."""
    np.right_shift(x, np.uint32(n), out=tmp)
    np.left_shift(x, np.uint32(32 - n), out=x)
    np.bitwise_or(x, tmp, out=x)


def compress(cv: list, m: list, counter: np.ndarray, block_len: np.ndarray,
             flags: np.ndarray) -> list:
    """One compression per lane: ``cv`` 8 and ``m`` 16 arrays of words ->
    the 8 output chaining words."""
    n = counter.shape[0]
    v = [w.astype(np.uint32) for w in cv] + [np.full(n, IV[i], dtype=np.uint32) for i in range(4)]
    v += [counter.astype(np.uint32), np.zeros(n, np.uint32),
          block_len.astype(np.uint32), flags.astype(np.uint32)]
    tmp = np.empty(n, np.uint32)
    m = list(m)
    for r in range(_ROUNDS):
        for gi, (a, b, c, d) in enumerate(_GS):
            va, vb, vc, vd = v[a], v[b], v[c], v[d]
            va += vb
            va += m[2 * gi]
            vd ^= va
            _rotr(vd, 16, tmp)
            vc += vd
            vb ^= vc
            _rotr(vb, 12, tmp)
            va += vb
            va += m[2 * gi + 1]
            vd ^= va
            _rotr(vd, 8, tmp)
            vc += vd
            vb ^= vc
            _rotr(vb, 7, tmp)
        if r < _ROUNDS - 1:
            m = [m[i] for i in PERMUTE]
    return [v[i] ^ v[i + 8] for i in range(8)]


def digests(inputs: list) -> list[bytes]:
    """The 32-byte BLAKE3 hash of every input (bytes-like)."""
    if not inputs:
        return []
    sizes = np.array([len(x) for x in inputs], dtype=np.int64)
    leaves = np.maximum(-(-sizes // LEAF), 1)
    padded = leaves * LEAF
    buf = np.zeros(int(padded.sum()), dtype=np.uint8)
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    for x, s in zip(inputs, starts):
        buf[s : s + len(x)] = np.frombuffer(x, dtype=np.uint8)
    words = buf.view("<u4").reshape(-1, LEAF // BLOCK, BLOCK // 4)
    n_leaves = words.shape[0]
    owner = np.repeat(np.arange(len(inputs)), leaves)
    index = np.arange(n_leaves) - np.repeat(np.cumsum(leaves) - leaves, leaves)
    leaf_len = np.minimum(sizes[owner] - index * LEAF, LEAF)
    blocks = np.maximum(-(-leaf_len // BLOCK), 1)
    single = leaves[owner] == 1

    cv = [np.full(n_leaves, IV[i], dtype=np.uint32) for i in range(8)]
    for b in range(LEAF // BLOCK):
        live = np.flatnonzero(blocks > b)
        if live.size == 0:
            break
        last = blocks[live] == b + 1
        flags = np.where(b == 0, CHUNK_START, 0) | np.where(last, CHUNK_END, 0)
        flags = flags | np.where(last & single[live], ROOT, 0)
        blen = np.where(last, leaf_len[live] - b * BLOCK, BLOCK)
        # the block's 16 message words of every live leaf, word-major
        m = list(np.ascontiguousarray(words[live, b].T))
        out = compress([w[live] for w in cv], m, index[live], blen, flags)
        for i in range(8):
            cv[i][live] = out[i]

    # tree: pair adjacent nodes of each input, an odd last one rises
    node_cv = np.stack(cv, axis=1)
    node_owner, count = owner, leaves.copy()
    pos = index
    while (count > 1).any():
        pair_left = (pos % 2 == 0) & (pos + 1 < count[node_owner])
        left = np.flatnonzero(pair_left)
        rest = np.flatnonzero((pos % 2 == 0) & ~pair_left)
        root = count[node_owner[left]] == 2
        words_in = [node_cv[left, i] for i in range(8)] + [node_cv[left + 1, i] for i in range(8)]
        zeros = np.zeros(left.size, np.int64)
        merged = compress([np.full(left.size, IV[i], np.uint32) for i in range(8)], words_in,
                          zeros, np.full(left.size, BLOCK), PARENT | np.where(root, ROOT, 0))
        keep = np.sort(np.concatenate([left, rest]))
        new_cv = node_cv[keep].copy()
        at = np.searchsorted(keep, left)
        new_cv[at] = np.stack(merged, axis=1)
        node_cv, node_owner, pos = new_cv, node_owner[keep], pos[keep] // 2
        count = -(-count // 2)
    return [node_cv[i].astype("<u4").tobytes() for i in range(node_cv.shape[0])]
