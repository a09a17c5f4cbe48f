"""Drive the port's image conversion: ``BatchConverter.convert_many`` on the
configuration's lane, one image a call, each image dedupping against the
converter's growing chunk dict (images 0..N-1 before image N).

The converter runs at its default layer fan-out (one thread and one CUDA
stream a layer). ``spans()`` times the calls into each layer for a traced
run; an untraced run calls the program untouched.
"""

from __future__ import annotations

import contextlib
import functools
import time

# The program's registry counters a run prints: the fused lane's stage
# seconds and bytes (ops/fused_convert.py).
COUNTERS = ("ntpu_fused_convert_stage_seconds", "ntpu_fused_convert_bytes")


def input_bytes(images) -> int:
    """The layer-tar bytes of these images: the work the rate counts."""
    return sum(im.nbytes for im in images)


def rates(window_bytes: int, window_s: float) -> dict:
    """The end-to-end rate of a window: GiB of layer tars converted a second."""
    return {"convert_gibps": window_bytes / 2**30 / window_s if window_bytes else 0.0}


class Driver:
    def __init__(self, config: dict, device):
        from nydus_snapshotter_tpu_torch.converter import PackOption, batch

        self.opt = PackOption(
            backend=config["backend"],
            fs_version=config["fs_version"],
            chunk_size=int(config["chunk_size"]),
            chunking=config["chunking"],
            digester=config["digester"],
            compressor=config["compressor"],
        )
        self.converter = batch.BatchConverter(self.opt, device=device)

    def convert(self, image):
        """Convert one image -> its ``ImageResult`` (merged bootstrap, the
        layer blobs made)."""
        return self.converter.convert_many([(image.name, image.tars)])[0]

    @staticmethod
    def counters() -> dict[str, float]:
        """Every sample of the program's metrics registry, keyed as its text
        exposition writes them (``name{label="v"}``)."""
        from nydus_snapshotter_tpu_torch.metrics import registry

        out = {}
        for line in registry.default_registry.render().splitlines():
            if line and not line.startswith("#"):
                key, _sep, value = line.rpartition(" ")
                try:
                    out[key] = float(value)
                except ValueError:
                    continue
        return out

    @staticmethod
    def launches() -> dict[str, int]:
        from nydus_snapshotter_tpu_torch.ops import blake3_cuda, gear_cuda, probe_cuda, sha256_cuda

        return {"K1": gear_cuda.KERNEL.launches, "K2": sha256_cuda.KERNEL.launches,
                "K3": probe_cuda.KERNEL.launches, "K4_leaves": blake3_cuda.LEAVES.launches,
                "K4_parents": blake3_cuda.PARENTS.launches}

    @staticmethod
    @contextlib.contextmanager
    def spans(sink: list):
        """Host ranges around the calls into each layer, from any thread: a
        layer's pack, the fused engine's pass, its host middle, the merge,
        the dict's growth, the section writer's native pass and the tar
        walk, appended to ``sink`` as (label, start, end) perf_counter
        seconds."""
        from nydus_snapshotter_tpu_torch.converter import batch, pack
        from nydus_snapshotter_tpu_torch.ops import fused_convert, native_cdc

        sites = [(batch, "Pack", "pack"), (batch, "Merge", "merge"),
                 (batch.GrowingChunkDict, "add_bootstrap_bytes", "dict_grow"),
                 (fused_convert.FusedDeviceEngine, "process_many", "fused_pass"),
                 (fused_convert.FusedDeviceEngine, "resolve", "host_resolve"),
                 (native_cdc, "pack_section", "assemble"), (pack, "_fast_tar_members", "tar_walk")]
        saved = []

        def wrap(fn, label):
            @functools.wraps(fn)
            def inner(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    sink.append((label, t0, time.perf_counter()))
            return inner

        try:
            for owner, attr, label in sites:
                fn = owner.__dict__[attr]
                saved.append((owner, attr, fn))
                setattr(owner, attr, wrap(fn, label))
            yield
        finally:
            for owner, attr, fn in reversed(saved):
                setattr(owner, attr, fn)
