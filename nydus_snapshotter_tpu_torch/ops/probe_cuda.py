"""Chunk-dict probe over the wrap-free padded table: kernel K3 and wrapper.

Table layout contract (prepared by ``pad_tables``, as in the reference's
ops/probe_pallas.py):

- ``keys_pad u32[C + W, 8]`` — the open-addressing table with its own head
  replicated after the end, so a chain starting anywhere in ``[0, C)``
  never wraps.
- ``vals_pad i32[C + W, 1]`` — the same replication for the values.
- ``W = align8(depth + 7)``; a query's chain is rows
  ``wstart + off + r`` for ``r < depth`` with ``slot0 = q[1] & (C - 1)``,
  ``wstart = slot0 & ~7`` and ``off = slot0 - wstart``.

The answer is the value of the first chain row whose key equals the query
and whose value is not 0 (values are dict index + 1), else 0.
``probe_padded`` takes a CPU tensor through the plain version and a CUDA
tensor through csrc/probe.cu, or raises. The kernel walks a chain in steps
(rows [0, 16), then 64 rows at a time) with every load of a step in flight
before the first compare.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nydus_snapshotter_tpu_torch.ops import cuda_build
from nydus_snapshotter_tpu_torch.tensors import from_u32, resolve_device

KERNEL = cuda_build.Kernel(
    "probe.cu",
    "ntpu_probe",
    [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
)


def _align8(n: int) -> int:
    return (n + 7) & ~7


def window_rows(depth: int) -> int:
    return _align8(depth + 7)


def pad_tables(keys: np.ndarray, values: np.ndarray, depth: int):
    """(keys u32[C,8], values i32[C]) -> wrap-free padded host layout."""
    w = window_rows(depth)
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    values = np.ascontiguousarray(values, dtype=np.int32).reshape(-1, 1)
    keys_pad = np.concatenate([keys, keys[:w]], axis=0)
    vals_pad = np.concatenate([values, values[:w]], axis=0)
    return keys_pad, vals_pad


def window_starts(queries: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(wstart, off) int32[Q] of each query's chain for a C = cap table."""
    slot0 = queries[:, 1] & (cap - 1)
    wstart = slot0 & ~7
    return wstart, slot0 - wstart


def probe_padded_plain(
    keys_pad: torch.Tensor,
    vals_pad: torch.Tensor,
    queries: torch.Tensor,
    wstart: torch.Tensor,
    off: torch.Tensor,
    depth: int,
) -> torch.Tensor:
    """The plain PyTorch version of K3 (any device): one gather of every
    query's whole chain, first match by argmax."""
    rows = (wstart.to(torch.int64) + off)[:, None] + torch.arange(
        depth, dtype=torch.int64, device=queries.device
    )  # [Q, D]
    cand_keys = keys_pad[rows]  # [Q, D, 8]
    cand_vals = vals_pad.reshape(-1)[rows]  # [Q, D]
    match = (cand_keys == queries[:, None, :]).all(dim=2) & (cand_vals != 0)
    hit = match.to(torch.int32).argmax(dim=1)  # first True
    found = cand_vals.gather(1, hit[:, None])[:, 0]
    return torch.where(match.any(dim=1), found, 0).to(torch.int32)


def probe_padded(
    keys_pad: torch.Tensor,
    vals_pad: torch.Tensor,
    queries: torch.Tensor,
    wstart: torch.Tensor,
    off: torch.Tensor,
    depth: int,
) -> torch.Tensor:
    """Probe queries int32[Q,8] against a pad_tables() layout -> int32[Q]."""
    nq = queries.shape[0]
    dev = queries.device
    if keys_pad.dtype != torch.int32 or keys_pad.dim() != 2 or keys_pad.shape[1] != 8:
        raise ValueError(f"keys_pad must be int32[C+W, 8], got {keys_pad.dtype}{list(keys_pad.shape)}")
    if vals_pad.dtype != torch.int32 or vals_pad.numel() != keys_pad.shape[0]:
        raise ValueError("vals_pad must be int32 with one value per key row")
    if queries.dtype != torch.int32 or queries.dim() != 2 or queries.shape[1] != 8:
        raise ValueError(f"queries must be int32[Q, 8], got {queries.dtype}{list(queries.shape)}")
    for name, t in (("wstart", wstart), ("off", off)):
        if t.dtype != torch.int32 or t.shape != (nq,):
            raise ValueError(f"{name} must be int32[{nq}]")
    if any(t.device != dev for t in (keys_pad, vals_pad, wstart, off)):
        raise ValueError("all probe operands must be on one device")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if nq:
        lo, hi = torch.stack([(wstart + off).min(), (wstart + off).max()]).tolist()
        if lo < 0 or hi + depth > keys_pad.shape[0]:
            raise ValueError("a probe chain leaves the padded table")
    if dev.type == "cpu":
        return probe_padded_plain(keys_pad, vals_pad, queries, wstart, off, depth)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in (keys_pad, vals_pad, queries, wstart, off)):
        raise ValueError("probe operands must be contiguous")
    # The kernel reads keys and queries as aligned 16-byte half-rows.
    if keys_pad.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("keys_pad and queries must be 16-byte aligned")
    out = torch.empty(nq, dtype=torch.int32, device=dev)
    if nq:
        with torch.cuda.device(dev):
            KERNEL.launch(
                keys_pad.data_ptr(), vals_pad.data_ptr(), queries.data_ptr(),
                wstart.data_ptr(), off.data_ptr(), out.data_ptr(), nq, depth,
                torch.cuda.current_stream().cuda_stream,
            )
    return out


def probe(
    keys: np.ndarray,
    values: np.ndarray,
    queries: np.ndarray,
    depth: int,
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """Convenience single-shard probe: pads the table, computes the chain
    starts, probes on ``device``. -> i32[Q] (0 = miss; hits are dict
    index + 1)."""
    dev = resolve_device(device)
    cap = keys.shape[0]
    keys_pad, vals_pad = pad_tables(keys, values, depth)
    q = from_u32(np.asarray(queries, dtype=np.uint32).reshape(-1, 8), dev)
    wstart, off = window_starts(q, cap)
    out = probe_padded(
        from_u32(keys_pad, dev),
        torch.from_numpy(vals_pad.reshape(-1)).to(dev),
        q, wstart, off, depth,
    )
    return out.cpu().numpy()
