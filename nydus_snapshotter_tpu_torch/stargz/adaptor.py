"""Filesystem-side stargz driver: TOC → bootstrap build + layer merge.

Reference pkg/filesystem/stargz_adaptor.go:

- ``prepare_meta_layer`` (:165-260): persist the TOC as
  ``stargz.index.json``, then convert it to a per-layer bootstrap named by
  the layer digest hex. The reference shells out to ``nydus-image create
  --source-type stargz_index``; here the bootstrap is emitted in-process
  via :mod:`nydus_snapshotter_tpu_torch.stargz.index`.
- ``merge_meta_layer`` (:73-160): collect each parent layer's bootstrap
  (the file named by a bare sha256 hex) bottom-up and merge them into
  ``image.boot`` in the topmost parent's upper dir, copying sibling
  ``*.blob.meta`` files next to it for the daemon's benefit.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Callable, Mapping, Optional

from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.converter.convert import Merge
from nydus_snapshotter_tpu_torch.converter.types import MergeOption
from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap
from nydus_snapshotter_tpu_torch.stargz import index as stargz_index
from nydus_snapshotter_tpu_torch.stargz.resolver import TOC_FILENAME, Blob
from nydus_snapshotter_tpu_torch.utils import errdefs

_HEX_DIGEST = re.compile(r"^[0-9a-f]{64}$")

MERGED_BOOTSTRAP = "image.boot"


class StargzAdaptor:
    def __init__(
        self,
        upper_path_fn: Callable[[str], str],
        cache_dir: str = "",
        fs_driver: str = constants.FS_DRIVER_FUSEDEV,
        chunk_size: int = stargz_index.DEFAULT_CHUNK_SIZE,
    ):
        self.upper_path = upper_path_fn
        self.cache_dir = cache_dir
        self.fs_driver = fs_driver
        self.chunk_size = chunk_size

    # -- prepare -------------------------------------------------------------

    def prepare_meta_layer(
        self, blob: Blob, storage_path: str, _labels: Optional[Mapping[str, str]] = None
    ) -> None:
        blob_id = blob.get_digest().split(":", 1)[-1]
        os.makedirs(storage_path, exist_ok=True)
        converted = os.path.join(storage_path, blob_id)
        if os.path.exists(converted):
            return

        toc_json = blob.read_toc()
        toc_path = os.path.join(storage_path, TOC_FILENAME)
        with open(toc_path, "wb") as f:
            f.write(toc_json)
        os.chmod(toc_path, 0o440)

        import json

        bootstrap = stargz_index.bootstrap_from_toc(
            json.loads(toc_json),
            blob_id,
            chunk_size=self.chunk_size,
            blob_compressed_size=blob.size,
        )

        # blob.meta sits in the shared cache dir for fusedev, but fscache's
        # cache dir is kernel-managed so it stays beside the bootstrap
        # (stargz_adaptor.go:207-216).
        meta_dir = (
            storage_path
            if self.fs_driver == constants.FS_DRIVER_FSCACHE or not self.cache_dir
            else self.cache_dir
        )
        os.makedirs(meta_dir, exist_ok=True)
        meta_path = os.path.join(meta_dir, f"{blob_id}.blob.meta")
        with open(meta_path, "wb") as f:
            for chunk in bootstrap.chunks:
                f.write(chunk.pack())

        fd, tmp = tempfile.mkstemp(prefix="converting-stargz", dir=storage_path)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(bootstrap.to_bytes())
            os.rename(tmp, converted)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        os.chmod(converted, 0o440)

    # -- merge ---------------------------------------------------------------

    def merge_meta_layer(self, snapshot) -> None:
        if not snapshot.parent_ids:
            raise errdefs.InvalidArgument("stargz merge needs parent layers")
        merged_dir = self.upper_path(snapshot.parent_ids[0])
        merged_bootstrap = os.path.join(merged_dir, MERGED_BOOTSTRAP)
        if os.path.exists(merged_bootstrap):
            return

        bootstraps: list[str] = []
        for idx, snapshot_id in enumerate(snapshot.parent_ids):
            upper = self.upper_path(snapshot_id)
            bootstrap_name = ""
            blob_meta_name = ""
            for name in sorted(os.listdir(upper)):
                if _HEX_DIGEST.match(name):
                    bootstrap_name = name
                if name.endswith("blob.meta"):
                    blob_meta_name = name
            if not bootstrap_name:
                raise errdefs.NotFound(
                    f"can't find bootstrap for snapshot {snapshot_id}"
                )
            if blob_meta_name and idx != 0:
                shutil.copy2(
                    os.path.join(upper, blob_meta_name),
                    os.path.join(merged_dir, blob_meta_name),
                )
            # parent_ids is topmost-first: prepend for lowest-first order.
            bootstraps.insert(0, os.path.join(upper, bootstrap_name))

        if len(bootstraps) == 1:
            shutil.copy2(bootstraps[0], merged_bootstrap)
        else:
            layers = []
            for path in bootstraps:
                with open(path, "rb") as f:
                    layers.append(Bootstrap.from_bytes(f.read()))
            result = Merge(layers, MergeOption())
            fd, tmp = tempfile.mkstemp(prefix="merging-stargz", dir=merged_dir)
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(result.bootstrap)
                os.rename(tmp, merged_bootstrap)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
        os.chmod(merged_bootstrap, 0o440)
