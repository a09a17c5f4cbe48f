"""The flagship forward step of the conversion data plane.

``entry()`` returns ``(forward, example_args)``: one step of gear candidate
bitmaps over a batch of windows (kernel K1) plus chunk SHA-256 over a
buffer of messages (kernel K2) — the counterpart of the reference
package's ``__graft_entry__.entry()``.
"""

from __future__ import annotations

import numpy as np
import torch

from nydus_snapshotter_tpu_torch.ops import gear, gear_cuda, sha256_cuda
from nydus_snapshotter_tpu_torch.tensors import resolve_device

WINDOW = 1 << 16
MASK_S, MASK_L = 0x3FFF, 0x3FF


def forward(
    windows: torch.Tensor,
    mask_s: int,
    mask_l: int,
    buffer: torch.Tensor,
    offs: torch.Tensor,
    sizes: torch.Tensor,
):
    """-> (bitmap_s int32[B, n/32], bitmap_l int32[B, n/32], digests int32[M, 8])."""
    n = windows.shape[1] - (gear.GEAR_WINDOW - 1)
    bm_s, bm_l = gear_cuda.gear_bitmaps(windows, mask_s, mask_l, n)
    return bm_s, bm_l, sha256_cuda.sha256_chunks(buffer, offs, sizes)


def example_args(
    device: "str | torch.device | None" = None,
    n_win: int = 4,
    win: int = WINDOW,
    n_msgs: int = 8,
    msg_len: int = 1500,
):
    """Seeded inputs for ``forward``: windows u8[n_win, win+31], the masks,
    and n_msgs messages of msg_len bytes laid end to end in one buffer
    (their extents on the host, where ``sha256_chunks`` takes them)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    windows = rng.integers(0, 256, (n_win, win + gear.GEAR_WINDOW - 1), dtype=np.uint8)
    buf = rng.integers(0, 256, -(-n_msgs * msg_len // 16) * 16, dtype=np.uint8)
    offs = np.arange(n_msgs, dtype=np.int32) * msg_len
    sizes = np.full(n_msgs, msg_len, dtype=np.int32)
    return (
        torch.from_numpy(windows).to(dev),
        MASK_S,
        MASK_L,
        torch.from_numpy(buf).to(dev),
        torch.from_numpy(offs),
        torch.from_numpy(sizes),
    )


def entry(device: "str | torch.device | None" = None):
    """(forward, example_args) of the conversion plane's forward step."""
    return forward, example_args(device)
