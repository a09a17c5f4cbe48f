"""Pure-Python BLAKE3 (hash mode only): the port's host oracle and host arm.

A copy of the reference package's utils/blake3.py, kept here so the port
imports nothing of that package. The reference toolchain's default chunk
digester is BLAKE3 (RafsSuperFlags HASH_BLAKE3 = 0x4), and no ``blake3``
package is installed, so this spec implementation is what the host arm of
``digester="blake3"`` digests with (``ops/chunker._host_digests_blake3``),
and what the tests and ``chip_smoke.py`` hold kernel K4
(``ops/blake3_cuda.py``) against. It runs at well under 1 MB/s: it is an
oracle, not a fast path.

Implements the unkeyed hash with the full chunk/binary-tree structure
(chunks of 1024 bytes, largest-power-of-two left subtrees, ROOT
finalization), 32-byte output. Keyed mode / derive-key / XOF beyond 32
bytes are omitted.
"""

from __future__ import annotations

_IV = (
    0x6A09E667,
    0xBB67AE85,
    0x3C6EF372,
    0xA54FF53A,
    0x510E527F,
    0x9B05688C,
    0x1F83D9AB,
    0x5BE0CD19,
)

_MSG_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

_CHUNK_START = 1 << 0
_CHUNK_END = 1 << 1
_PARENT = 1 << 2
_ROOT = 1 << 3

_BLOCK = 64
_CHUNK = 1024

_M32 = 0xFFFFFFFF


def _compress(cv, block_words, counter, block_len, flags):
    v = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        _IV[0], _IV[1], _IV[2], _IV[3],
        counter & _M32, (counter >> 32) & _M32, block_len, flags,
    ]
    m = list(block_words)

    def g(a, b, c, d, mx, my):
        va = (v[a] + v[b] + mx) & _M32
        vd = v[d] ^ va
        vd = ((vd >> 16) | (vd << 16)) & _M32
        vc = (v[c] + vd) & _M32
        vb = v[b] ^ vc
        vb = ((vb >> 12) | (vb << 20)) & _M32
        va = (va + vb + my) & _M32
        vd = vd ^ va
        vd = ((vd >> 8) | (vd << 24)) & _M32
        vc = (vc + vd) & _M32
        vb = vb ^ vc
        vb = ((vb >> 7) | (vb << 25)) & _M32
        v[a], v[b], v[c], v[d] = va, vb, vc, vd

    for rnd in range(7):
        g(0, 4, 8, 12, m[0], m[1])
        g(1, 5, 9, 13, m[2], m[3])
        g(2, 6, 10, 14, m[4], m[5])
        g(3, 7, 11, 15, m[6], m[7])
        g(0, 5, 10, 15, m[8], m[9])
        g(1, 6, 11, 12, m[10], m[11])
        g(2, 7, 8, 13, m[12], m[13])
        g(3, 4, 9, 14, m[14], m[15])
        if rnd < 6:
            m = [m[p] for p in _MSG_PERM]

    return [
        v[0] ^ v[8], v[1] ^ v[9], v[2] ^ v[10], v[3] ^ v[11],
        v[4] ^ v[12], v[5] ^ v[13], v[6] ^ v[14], v[7] ^ v[15],
        v[8] ^ cv[0], v[9] ^ cv[1], v[10] ^ cv[2], v[11] ^ cv[3],
        v[12] ^ cv[4], v[13] ^ cv[5], v[14] ^ cv[6], v[15] ^ cv[7],
    ]


def _words(block: bytes):
    block = block.ljust(_BLOCK, b"\0")
    return [int.from_bytes(block[i : i + 4], "little") for i in range(0, _BLOCK, 4)]


def _chunk_output(chunk: bytes, counter: int):
    """(input_cv, last_block_words, counter, last_block_len, flags) of a
    <=1024-byte chunk — finalization deferred so the root can add ROOT."""
    blocks = [chunk[i : i + _BLOCK] for i in range(0, len(chunk), _BLOCK)] or [b""]
    cv = _IV
    for i, blk in enumerate(blocks[:-1]):
        flags = _CHUNK_START if i == 0 else 0
        cv = _compress(cv, _words(blk), counter, _BLOCK, flags)[:8]
    last = blocks[-1]
    flags = (_CHUNK_START if len(blocks) == 1 else 0) | _CHUNK_END
    return (cv, _words(last), counter, len(last), flags)


def _subtree_cv(data: bytes, counter: int):
    """Non-root 8-word chaining value of a subtree starting at chunk
    ``counter``."""
    if len(data) <= _CHUNK:
        cv, words, ctr, blen, flags = _chunk_output(data, counter)
        return _compress(cv, words, ctr, blen, flags)[:8]
    n_chunks = -(-len(data) // _CHUNK)
    left_chunks = 1 << (n_chunks - 1).bit_length() - 1
    split = left_chunks * _CHUNK
    left = _subtree_cv(data[:split], counter)
    right = _subtree_cv(data[split:], counter + left_chunks)
    return _compress(_IV, left + right, 0, _BLOCK, _PARENT)[:8]


def blake3(data: bytes) -> bytes:
    """32-byte BLAKE3 hash of ``data``."""
    if len(data) <= _CHUNK:
        cv, words, ctr, blen, flags = _chunk_output(data, 0)
        out = _compress(cv, words, ctr, blen, flags | _ROOT)
    else:
        n_chunks = -(-len(data) // _CHUNK)
        left_chunks = 1 << (n_chunks - 1).bit_length() - 1
        split = left_chunks * _CHUNK
        left = _subtree_cv(data[:split], 0)
        right = _subtree_cv(data[split:], left_chunks)
        out = _compress(_IV, left + right, 0, _BLOCK, _PARENT | _ROOT)
    return b"".join(w.to_bytes(4, "little") for w in out[:8])
