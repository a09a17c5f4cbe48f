"""Chunk BLAKE3 read straight from the layer buffer: kernel K4 and wrapper.

``blake3_chunks(buffer, offs, sizes)`` digests chunk m = buffer[offs[m] :
offs[m] + sizes[m]] and returns its BLAKE3 digest as little-endian words;
the extents stay on the host, where the caller made them. It is the
function the reference computes as ``_blake3_batch_jit(_gather_pack_b3(
buffer, offs, sizes, cap), sizes)``; ops/blake3.blake3_chunks_plain is that
composition in torch. A CPU tensor takes the plain version; a CUDA tensor
launches csrc/blake3.cu or raises.

K4 is two launches a call: ``LEAVES`` (one thread per 1024-byte leaf of
every chunk, single-leaf chunks finished there) and ``PARENTS`` (one block
per chunk, the tree), the second skipped when no chunk has two leaves.
Each counts its own launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from nydus_snapshotter_tpu_torch.ops import blake3, cuda_build, sha256_cuda

LEAVES = cuda_build.Kernel(
    "blake3.cu",
    "ntpu_blake3_leaves",
    [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64] + [ctypes.c_void_p] * 3,
)
PARENTS = cuda_build.Kernel(
    "blake3.cu",
    "ntpu_blake3_parents",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4,
)
KERNELS = (LEAVES, PARENTS)
# Not a kernel: csrc/blake3.cu's kSharedCvs, read from the built library.
_SHARED_CVS = cuda_build.Kernel("blake3.cu", "ntpu_blake3_shared_cvs", [])


@functools.cache
def shared_cvs() -> int:
    """The widest tree level K4 keeps in shared memory: a chunk of more
    leaves needs the second device scratch ``cv_b`` of PARENTS."""
    return int(_SHARED_CVS.load()())


def leaf_counts(sizes: np.ndarray) -> np.ndarray:
    """int64 leaves of each chunk (the empty chunk is one leaf)."""
    return np.maximum((sizes.astype(np.int64) + blake3.LEAF_BYTES - 1) // blake3.LEAF_BYTES, 1)


def blake3_chunks(
    buffer: torch.Tensor, offs: torch.Tensor, sizes: torch.Tensor
) -> torch.Tensor:
    """buffer u8[N] on any device, offs/sizes int32[M] on the host ->
    int32[M, 8] BLAKE3 digests on the buffer's device (little-endian words
    as u32 patterns).

    The extents are checked on the host and, for a CUDA buffer, uploaded
    in one non-blocking copy from pinned memory; the leaf ends are
    prefix-summed on the card. The call queues its work and returns
    without waiting on the card."""
    sha256_cuda.check_chunk_args(buffer, offs, sizes)
    if buffer.device.type == "cpu":
        return blake3.blake3_chunks_plain(buffer, offs, sizes)
    m = offs.shape[0]
    out = torch.empty((m, 8), dtype=torch.int32, device=buffer.device)
    if m:
        leaves = leaf_counts(sizes.numpy())
        total, most = int(leaves.sum()), int(leaves.max())
        rows = torch.stack([offs, sizes]).pin_memory()
        with torch.cuda.device(buffer.device):
            ext = rows.to(buffer.device, non_blocking=True)
            leaf_end = torch.cumsum(
                torch.clamp((ext[1].to(torch.int64) + blake3.LEAF_BYTES - 1) // blake3.LEAF_BYTES,
                            min=1),
                0,
            )
            cvs = torch.empty((total, 8), dtype=torch.int32, device=buffer.device)
            stream = torch.cuda.current_stream().cuda_stream
            LEAVES.launch(
                buffer.data_ptr(), ext[0].data_ptr(), ext[1].data_ptr(), leaf_end.data_ptr(),
                m, total, cvs.data_ptr(), out.data_ptr(), stream,
            )
            if most > 1:
                cv_b = torch.empty((total if most > shared_cvs() else 1, 8), dtype=torch.int32,
                                   device=buffer.device)
                PARENTS.launch(
                    ext[1].data_ptr(), leaf_end.data_ptr(), m, cvs.data_ptr(), cv_b.data_ptr(),
                    out.data_ptr(), stream,
                )
    return out
