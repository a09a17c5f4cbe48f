"""Seeded synthetic files shaped like a node_modules-heavy image layer.

A frozen copy of ``FileGen`` from ``chip_smoke.py`` (the repository's
``bench.py`` uses the same numpy generator), split in two so that every
seed converts the same work:

- the *shape* of a file set (each file's size and kind) comes from
  :func:`shapes`, drawn from a generator the traffic file seeds;
- the *content* of each file comes from :class:`Content`, seeded from the
  run's ``--seed``.

Sizes are log-normal, clipped to [128 B, 8 MiB]; kinds are text (word-like
ASCII cut from one cyclic 1 MiB base), binary (random bytes with a share of
zeros, ELF-like) and random, in the shares the traffic file gives.
"""

from __future__ import annotations

import numpy as np

KINDS = ("text", "binary", "random")


def shapes(rng: np.random.Generator, total_bytes: int, params: dict) -> list[tuple[int, int]]:
    """(size, kind index) of files until their sizes reach ``total_bytes``:
    ``FileGen.pool``'s draw, one size then one kind per file."""
    mu, sigma = params["size_lognormal"]
    lo, hi = params["size_clip"]
    cut_text, cut_binary = np.cumsum([params["kind_shares"][k] for k in KINDS])[:2]
    out = []
    used = 0
    while used < total_bytes:
        size = int(np.clip(rng.lognormal(mu, sigma), lo, hi))
        r = rng.random()
        out.append((size, 0 if r < cut_text else (1 if r < cut_binary else 2)))
        used += size
    return out


def random_bytes(rng: np.random.Generator, size: int) -> np.ndarray:
    """``size`` uniform bytes: the bit generator's raw 64-bit words."""
    return rng.bit_generator.random_raw(-(-size // 8)).view(np.uint8)[:size]


def text_base(rng: np.random.Generator) -> np.ndarray:
    """1 MiB of word-like ASCII, twice over (a cyclic read from any offset
    is one slice): 400 words of 3-10 lowercase letters, drawn with
    repetition, each followed by a space."""
    lens = rng.integers(3, 11, 400)
    letters = rng.integers(97, 123, int(lens.sum()), dtype=np.uint8)
    words = np.concatenate([np.insert(w, len(w), 32) for w in
                            np.split(letters, np.cumsum(lens)[:-1])])
    starts = np.concatenate([[0], np.cumsum(lens + 1)[:-1]])
    pick = rng.integers(0, 400, (1 << 20) // 4)
    out_lens = lens[pick] + 1
    keep = int(np.searchsorted(np.cumsum(out_lens), 1 << 20)) + 1
    pick, out_lens = pick[:keep], out_lens[:keep]
    begin = np.cumsum(out_lens) - out_lens
    gather = np.repeat(starts[pick] - begin, out_lens) + np.arange(int(out_lens.sum()))
    base = words[gather][: 1 << 20]
    return np.concatenate([base, base])


class Content:
    """File bytes from one seeded generator (``FileGen.file``), text read
    from a shared base (``text_base``)."""

    def __init__(self, rng: np.random.Generator, binary_zero_share: float, text: np.ndarray):
        self.rng = rng
        # zero a byte where a byte drawn beside it falls below the share
        # (141 / 256 = 0.5508 for 0.55)
        self.zero_cut = round(binary_zero_share * 256)
        self.text = text

    def file(self, size: int, kind: int) -> np.ndarray:
        rng = self.rng
        if kind == 0:  # the base read cyclically from a random offset
            period = self.text.size // 2
            off = int(rng.integers(0, period))
            if size <= period:
                return self.text[off : off + size].copy()
            return np.resize(self.text[off : off + period], size)
        data = random_bytes(rng, size)
        if kind == 1:
            return data * (random_bytes(rng, size) >= self.zero_cut)
        return data
