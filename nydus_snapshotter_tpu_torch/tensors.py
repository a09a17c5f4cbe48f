"""Device selection and the 32-bit word convention shared by the port.

Hash words (gear hashes, bitmap words, SHA-256 state, dict keys) travel as
``torch.int32`` tensors holding the u32 bit pattern: CPU torch has no
``uint32`` add or shift. Plain versions compute in int64 masked to 32 bits
and convert back with :func:`as_int32`; the public boundary views the
result as ``np.uint32`` (:func:`to_u32`), so it compares directly with the
reference package's ``u32`` arrays.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asked for
    another. Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bit pattern."""
    return torch.where(x > 0x7FFFFFFF, x - (1 << 32), x).to(torch.int32)


def as_u32_int64(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def from_u32(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy u32 array -> int32 tensor (bit pattern) on ``device``. A
    read-only array (``np.frombuffer`` of bytes) is copied first: torch
    tensors are writable."""
    arr = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor (bit pattern) -> numpy u32 array on the host."""
    return t.detach().cpu().numpy().view(np.uint32)
