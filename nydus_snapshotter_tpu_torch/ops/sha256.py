"""SHA-256 over batches of pre-padded messages, as plain tensor ops.

One chunk is a row of 64-byte blocks (``int32[B, 16]`` big-endian words as
u32 bit patterns, standard SHA padding applied); a batch is ``[M, B, 16]``
plus per-chunk block counts. As in the reference's ``_compress_looped``,
the message schedule is computed first and the 64 rounds then loop in
Python, across all M chunks at once, in int64 holding u32 values (CPU
torch has no uint32 arithmetic). It is the oracle of the hand-written
kernel (ops/sha256_cuda.py), not a fast path.

The numpy packing helpers are copied from the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from nydus_snapshotter_tpu_torch.tensors import MASK32, as_int32, as_u32_int64

_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
        0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
        0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
        0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
        0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
        0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

_H0 = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19],
    dtype=np.uint32,
)


def _rot_source(x: torch.Tensor) -> torch.Tensor:
    """x (any high bits) -> its low 32 bits duplicated into both halves, so
    ``(src >> r)`` holds rotr(x, r) in its low 32 bits (r < 32)."""
    xc = x & MASK32
    return xc | (xc << 32)


def _ssig0(x: torch.Tensor) -> torch.Tensor:  # schedule sigma0, clean input
    xx = _rot_source(x)
    return (xx >> 7) ^ (xx >> 18) ^ (x >> 3)


def _ssig1(x: torch.Tensor) -> torch.Tensor:  # schedule sigma1, clean input
    xx = _rot_source(x)
    return (xx >> 17) ^ (xx >> 19) ^ (x >> 10)


def _schedule(words: torch.Tensor) -> torch.Tensor:
    """Message schedule of every block at once: int64[M, L, 16] (u32
    values) -> int64[L, 64, M] holding W[t] + K[t] (low 32 bits)."""
    w = [words[..., i] for i in range(16)]
    for t in range(16, 64):
        w.append((w[t - 16] + _ssig0(w[t - 15]) + w[t - 7] + _ssig1(w[t - 2])) & MASK32)
    kw = torch.stack([w[t] + int(_K[t]) for t in range(64)], dim=0)  # [64, M, L]
    return kw.permute(2, 0, 1).contiguous()


def _rounds(state: list[torch.Tensor], kw: torch.Tensor) -> list[torch.Tensor]:
    """The 64 rounds of one compression over a batch: 8 state tensors [M]
    (u32 values) and kw int64[64, M] -> 8 new state tensors. Working
    variables carry garbage above bit 31 (sums are only ever taken mod
    2^32); rotations read the masked low half."""
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        ee = _rot_source(e)
        s1 = (ee >> 6) ^ (ee >> 11) ^ (ee >> 25)
        ch = g ^ (e & (f ^ g))
        t1 = h + s1 + ch + kw[i]
        aa = _rot_source(a)
        s0 = (aa >> 2) ^ (aa >> 13) ^ (aa >> 22)
        maj = (a & b) | (c & (a | b))
        a, b, c, d, e, f, g, h = t1 + s0 + maj, a, b, c, d + t1, e, f, g
    return [(x + s) & MASK32 for x, s in zip((a, b, c, d, e, f, g, h), state)]


def sha256_batch(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Digest a batch: blocks int32[M,B,16], nblocks int32[M] -> int32[M,8].

    A chunk's state advances only while the block index is below its
    count; blocks past every chunk's count are never visited. The schedule
    of all blocks is computed up front (it does not depend on the state),
    then the rounds loop over blocks.
    """
    m = blocks.shape[0]
    dev = blocks.device
    state = [torch.full((m,), int(v), dtype=torch.int64, device=dev) for v in _H0]
    counts = nblocks.to(torch.int64)
    last = min(int(counts.max()), blocks.shape[1]) if m else 0
    if last:
        kw = _schedule(as_u32_int64(blocks[:, :last, :]))
        all_live = int(counts.min())
        for j in range(last):
            new = _rounds(state, kw[j])
            if j < all_live:
                state = new
            else:
                live = j < counts
                state = [torch.where(live, n_, o) for n_, o in zip(new, state)]
    return as_int32(torch.stack(state, dim=1))


# ---------------------------------------------------------------------------
# Host-side packing
# ---------------------------------------------------------------------------


def n_padded_blocks(length: int) -> int:
    """Number of 64-byte blocks after standard SHA padding."""
    return (length + 8) // 64 + 1


def pad_message_np(data: bytes | np.ndarray) -> np.ndarray:
    """Standard SHA-256 padding -> big-endian words u32[nblocks, 16]."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    n = arr.size
    nb = n_padded_blocks(n)
    buf = np.zeros(nb * 64, dtype=np.uint8)
    buf[:n] = arr
    buf[n] = 0x80
    buf[-8:] = np.frombuffer((n * 8).to_bytes(8, "big"), dtype=np.uint8)
    return buf.view(">u4").astype(np.uint32).reshape(nb, 16)


def pack_messages_np(
    msgs: list[bytes], block_capacity: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Pack messages into a fixed-shape batch (u32[M,B,16], i32[M])."""
    counts = np.asarray([n_padded_blocks(len(m)) for m in msgs], dtype=np.int32)
    cap = block_capacity or (int(counts.max()) if len(msgs) else 1)
    if len(msgs) and int(counts.max()) > cap:
        raise ValueError(f"message needs {int(counts.max())} blocks > capacity {cap}")
    out = np.zeros((len(msgs), cap, 16), dtype=np.uint32)
    for i, m in enumerate(msgs):
        out[i, : counts[i]] = pad_message_np(m)
    return out, counts


def digest_to_bytes(state: np.ndarray) -> bytes:
    """u32[8] state -> canonical 32-byte big-endian digest."""
    return np.asarray(state, dtype=">u4").tobytes()
