"""Converter CLI — the nydusify/``nydus-image``-shaped entry point.

The reference ships conversion behind external binaries (``nydus-image
create/merge/unpack/check``, plus nydusify driving the containerd
converter); this CLI exposes the same verbs over the in-process engine so
a user of that toolchain finds the workflow here:

    python -m nydus_snapshotter_tpu_torch.cmd.convert pack   --in layer.tar --out layer.nydus [--chunk-dict d.boot] [...]
    python -m nydus_snapshotter_tpu_torch.cmd.convert merge  --out image.boot layer1.nydus layer2.nydus [--chunk-dict d.boot]
    python -m nydus_snapshotter_tpu_torch.cmd.convert unpack --boot image.boot --blob-dir blobs/ --out layer.tar
    python -m nydus_snapshotter_tpu_torch.cmd.convert check  --boot image.boot
    python -m nydus_snapshotter_tpu_torch.cmd.convert inspect --boot image.boot [--path /etc/foo | --list /etc | --prefix /opt]
    python -m nydus_snapshotter_tpu_torch.cmd.convert batch  --out-dir converted/ --dict-out dict.boot img1.tar,img2.tar ...
    python -m nydus_snapshotter_tpu_torch.cmd.convert export-erofs --boot image.boot --tar-dir tars/ --out image.erofs
    python -m nydus_snapshotter_tpu_torch.cmd.convert --device cpu pack --backend fused --in layer.tar --out layer.nydus

``--device`` (before the verb) is where the device lanes (``--backend
fused`` and ``jax``) run: "" (the default) is the CUDA card, else ``cpu``
(the kernels' plain versions), ``cuda`` or ``cuda:N``. A device lane with
no card and no ``--device cpu`` fails; it never falls back to the CPU. The
``hybrid`` (default) and ``numpy`` backends are host lanes on any device.

Exit code 0 on success; errors print one line to stderr and exit 1
(reference builder's subprocess contract, tool/builder.go:148-178).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _pack_option(args) -> "PackOption":
    from nydus_snapshotter_tpu_torch.converter.types import PackOption

    return PackOption(
        fs_version=args.fs_version,
        compressor=args.compressor,
        lz4_acceleration=getattr(args, "lz4_acceleration", 1),
        chunk_size=args.chunk_size,
        batch_size=args.batch_size,
        chunk_dict_path=args.chunk_dict or "",
        backend=args.backend,
        chunking=args.chunking,
        oci_ref=getattr(args, "oci_ref", False),
        encrypt=getattr(args, "encrypt", False),
        digester=getattr(args, "digester", "sha256"),
        prefetch_patterns=_read_prefetch(args),
    )


def _read_prefetch(args) -> str:
    if getattr(args, "prefetch_files", ""):
        with open(args.prefetch_files) as f:
            return f.read()
    return ""


def cmd_pack(args) -> int:
    from nydus_snapshotter_tpu_torch.converter.convert import Pack
    from nydus_snapshotter_tpu_torch.converter.zran import pack_gzip_layer

    opt = _pack_option(args)
    with open(args.input, "rb") as f:
        src = f.read()
    if args.oci_ref:
        from nydus_snapshotter_tpu_torch.converter.convert import frame_bootstrap_only

        bootstrap = pack_gzip_layer(src, opt)
        # Framed like every other layer stream so the output feeds
        # straight into `merge`.
        with open(args.out, "wb") as out:
            out.write(frame_bootstrap_only(bootstrap.to_bytes()))
        print(json.dumps({"blob_id": bootstrap.blobs[0].blob_id,
                          "chunks": len(bootstrap.chunks)}))
        return 0
    with open(args.out, "wb") as out:
        res = Pack(out, src, opt, device=args.device or None)
    print(json.dumps({
        "blob_id": res.blob_id,
        "blob_size": res.blob_size,
        "referenced_blobs": res.referenced_blob_ids,
    }))
    return 0


def cmd_merge(args) -> int:
    from nydus_snapshotter_tpu_torch.converter.convert import Merge
    from nydus_snapshotter_tpu_torch.converter.types import MergeOption

    layers = []
    for path in args.layers:
        with open(path, "rb") as f:
            layers.append(f.read())
    res = Merge(
        layers,
        MergeOption(
            fs_version=args.fs_version,
            chunk_dict_path=args.chunk_dict or "",
            prefetch_patterns=_read_prefetch(args),
            bootstrap_format=getattr(args, "bootstrap_format", "native"),
            digester=getattr(args, "digester", "sha256"),
        ),
    )
    with open(args.out, "wb") as f:
        f.write(res.bootstrap)
    print(json.dumps({"blob_digests": res.blob_digests}))
    return 0


def cmd_unpack(args) -> int:
    from nydus_snapshotter_tpu_torch.converter.convert import Unpack

    with open(args.boot, "rb") as f:
        boot = f.read()

    def provider(blob_id: str) -> bytes:
        with open(os.path.join(args.blob_dir, blob_id), "rb") as bf:
            return bf.read()

    tar = Unpack(boot, provider)
    with open(args.out, "wb") as f:
        f.write(tar)
    print(json.dumps({"tar_bytes": len(tar)}))
    return 0


def _inode_json(bs, ino) -> dict:
    out = {
        "path": ino.path,
        "mode": oct(ino.mode),
        "uid": ino.uid,
        "gid": ino.gid,
        "mtime": ino.mtime,
        "size": ino.size,
    }
    if ino.symlink_target:
        out["symlink"] = ino.symlink_target
    if ino.hardlink_target:
        out["hardlink"] = ino.hardlink_target
    if ino.xattrs:
        out["xattrs"] = sorted(ino.xattrs)
    if ino.chunk_count:
        end = ino.chunk_index + ino.chunk_count
        if ino.chunk_index < 0 or end > len(bs.chunks):
            raise SystemExit(
                f"ntpu-convert: inode {ino.path!r} chunk run "
                f"[{ino.chunk_index}, {end}) overruns the chunk table "
                f"of {len(bs.chunks)} records (corrupt bootstrap)"
            )
        out["chunks"] = [
            {
                "digest": c.digest.hex(),
                "blob": bs.blobs[c.blob_index].blob_id
                if 0 <= c.blob_index < len(bs.blobs)
                else f"<invalid blob index {c.blob_index}>",
                "compressed_offset": c.compressed_offset,
                "compressed_size": c.compressed_size,
                "uncompressed_size": c.uncompressed_size,
                "flags": c.flags,
            }
            for c in bs.chunks[ino.chunk_index : end]
        ]
    return out


def cmd_inspect(args) -> int:
    """``nydus-image inspect`` shape: query the inode tree of a bootstrap
    (either layout — native or real-toolchain)."""
    from nydus_snapshotter_tpu_torch.models.nydus_real import load_any_bootstrap

    with open(args.boot, "rb") as f:
        bs = load_any_bootstrap(f.read())
    by_path = {i.path: i for i in bs.inodes}
    if args.path:
        norm = "/" + args.path.strip("/") if args.path != "/" else "/"
        ino = by_path.get(norm)
        if ino is None:
            print(f"ntpu-convert: no inode at {args.path!r}", file=sys.stderr)
            return 1
        print(json.dumps(_inode_json(bs, ino)))
        return 0
    if args.list_dir:
        d = "/" + args.list_dir.strip("/") if args.list_dir != "/" else "/"
        if d != "/" and d not in by_path:
            print(f"ntpu-convert: no directory at {args.list_dir!r}", file=sys.stderr)
            return 1
        prefix = d.rstrip("/") + "/" if d != "/" else "/"
        names = sorted(
            p[len(prefix) :]
            for p in by_path
            if p != "/" and p.startswith(prefix) and "/" not in p[len(prefix) :]
        )
        print(json.dumps({"dir": d, "entries": names}))
        return 0
    pfx = ("/" + args.prefix.strip("/")) if args.prefix else ""
    paths = sorted(
        p
        for p in by_path
        # component-boundary prefix match: /opt must not pull in /opt2
        if not pfx or p == pfx or p.startswith(pfx.rstrip("/") + "/")
    )
    print(
        json.dumps(
            {
                "version": bs.version,
                "inodes": len(bs.inodes),
                "chunks": len(bs.chunks),
                "blobs": [b.blob_id for b in bs.blobs],
                "paths": paths,
            }
        )
    )
    return 0


def cmd_check(args) -> int:
    """``nydus-image check`` shape: parse + structural validation."""
    with open(args.boot, "rb") as f:
        buf = f.read()
    try:
        # Either layout — native or a REAL toolchain bootstrap (bridged).
        from nydus_snapshotter_tpu_torch.models.nydus_real import load_any_bootstrap

        bs = load_any_bootstrap(buf)
        version = bs.version
    except Exception:
        # Maybe a framed layer stream (pack output) rather than a bare
        # bootstrap — accept both, like nydus-image check does.
        from nydus_snapshotter_tpu_torch.converter.convert import bootstrap_from_layer_blob

        bs = bootstrap_from_layer_blob(buf)
        version = bs.version
    print(json.dumps({
        "version": version,
        "inodes": len(bs.inodes),
        "chunks": len(bs.chunks),
        "blobs": [b.blob_id for b in bs.blobs],
        "batches": len(bs.batches),
        "prefetch": bs.prefetch,
        "encrypted": any(c.algo for c in bs.ciphers),
    }))
    return 0


def cmd_batch(args) -> int:
    """Cross-image batch conversion with a growing chunk dict
    (BASELINE configs #3/#5; converter/batch.py)."""
    from nydus_snapshotter_tpu_torch.converter.batch import BatchConverter
    from nydus_snapshotter_tpu_torch.parallel.multihost import runtime

    opt = _pack_option(args)
    if args.chunk_dict:
        raise SystemExit("batch owns the dict; use --dict-in/--dict-out")
    bc = BatchConverter(opt, dict_path=args.dict_in or None, device=args.device or None)
    rt = runtime()
    names = sorted(args.images)
    mine = rt.shard(names)
    os.makedirs(args.out_dir, exist_ok=True)
    summary = []
    for name in mine:
        with open(name, "rb") as f:
            layers = [f.read()]
        res = bc.convert_image(os.path.basename(name), layers)
        base = os.path.join(args.out_dir, os.path.basename(name))
        with open(base + ".boot", "wb") as f:
            f.write(res.bootstrap)
        for blob_id, blob in res.layer_blobs.items():
            with open(os.path.join(args.out_dir, blob_id), "wb") as f:
                f.write(blob)
        summary.append({
            "image": os.path.basename(name),
            "blobs": res.blob_digests,
            "new_chunks": res.new_dict_chunks,
        })
    if args.dict_out:
        bc.save_dict(args.dict_out)
    print(json.dumps({"host": rt.index, "hosts": rt.count, "images": summary}))
    return 0


def cmd_export_real(args) -> int:
    """Transcode any bootstrap (native, or real v5/v6) into the reference
    toolchain's real on-disk layout — including real v5 <-> v6."""
    from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap, BootstrapError
    from nydus_snapshotter_tpu_torch.models.nydus_real import parse_real_bootstrap
    from nydus_snapshotter_tpu_torch.models.nydus_real_write import (
        real_from_bootstrap,
        write_real_v5,
        write_real_v6,
    )

    with open(args.boot, "rb") as f:
        data = f.read()
    try:
        real = real_from_bootstrap(
            Bootstrap.from_bytes(data), digester=args.digester
        )
        source = "native"
    except (BootstrapError, ValueError):
        real = parse_real_bootstrap(data)  # digests preserved verbatim
        source = f"real-{real.version}"
    out = write_real_v5(real) if args.format == "v5" else write_real_v6(real)
    with open(args.out, "wb") as f:
        f.write(out)
    print(
        json.dumps(
            {
                "source": source,
                "format": args.format,
                "bytes": len(out),
                "inodes": len(real.inodes),
                "chunks": len(real.chunks),
            }
        )
    )
    return 0


def cmd_export_erofs(args) -> int:
    """``nydus-image export --block`` shape: self-contained EROFS disk."""
    from nydus_snapshotter_tpu_torch.models.bootstrap import Bootstrap
    from nydus_snapshotter_tpu_torch.models.erofs_image import write_erofs_disk

    with open(args.boot, "rb") as f:
        bs = Bootstrap.from_bytes(f.read())

    def tar_path_of(blob_id: str) -> str:
        return os.path.join(args.tar_dir, blob_id)

    with open(args.out, "w+b") as out:
        size = write_erofs_disk(bs, tar_path_of, out)
    print(json.dumps({"image_bytes": size}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ntpu-convert", description=__doc__)
    p.add_argument(
        "--device",
        default="",
        help="where the fused and jax backends run: '' (default) = the CUDA "
        "card, 'cpu' = the kernels' plain versions, 'cuda' or 'cuda:N'",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, dict_opt=True):
        sp.add_argument("--fs-version", default="v6", choices=("v5", "v6"))
        sp.add_argument("--compressor", default="lz4_block",
                        choices=("none", "zstd", "lz4_block"))
        sp.add_argument("--lz4-acceleration", type=int, default=1,
                        help="LZ4_compress_fast acceleration (1 = max "
                        "ratio; higher trades ratio for speed)")
        sp.add_argument("--chunk-size", type=lambda v: int(v, 0), default=0x100000)
        sp.add_argument("--batch-size", type=lambda v: int(v, 0), default=0)
        sp.add_argument("--backend", default="hybrid",
                        choices=("jax", "numpy", "hybrid", "fused"))
        sp.add_argument("--chunking", default="cdc", choices=("cdc", "fixed"))
        sp.add_argument("--digester", default="sha256",
                        choices=("sha256", "blake3"),
                        help="chunk digest algorithm (blake3 = the real "
                        "toolchain default; needed for content dedup "
                        "against real nydus images)")
        sp.add_argument("--prefetch-files", default="",
                        help="file of prefetch patterns, one per line")
        if dict_opt:
            sp.add_argument("--chunk-dict", default="",
                            help="dict bootstrap (bootstrap=<path> accepted)")

    sp = sub.add_parser("pack", help="OCI layer tar -> nydus layer stream")
    sp.add_argument("--in", dest="input", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--oci-ref", action="store_true",
                    help="zran: index the original .tar.gz, store nothing")
    sp.add_argument("--encrypt", action="store_true")
    common(sp)
    sp.set_defaults(fn=cmd_pack)

    sp = sub.add_parser("merge", help="layer streams -> image bootstrap")
    sp.add_argument("layers", nargs="+")
    sp.add_argument("--out", required=True)
    sp.add_argument("--bootstrap-format", default="native",
                    choices=("native", "rafs-v5", "rafs-v6"),
                    help="emit the image bootstrap in this framework's "
                    "format or the reference toolchain's real layout")
    # --digester comes from common(): one flag covers chunk digests at
    # pack time and inode digests when emitting a real layout.
    common(sp)
    sp.set_defaults(fn=cmd_merge)

    sp = sub.add_parser(
        "export-real",
        help="bootstrap (either format) -> real nydus v5/v6 layout",
    )
    sp.add_argument("--boot", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--format", required=True, choices=("v5", "v6"))
    sp.add_argument("--digester", default="sha256",
                    choices=("sha256", "blake3"))
    sp.set_defaults(fn=cmd_export_real)

    sp = sub.add_parser("unpack", help="bootstrap + blobs -> OCI tar")
    sp.add_argument("--boot", required=True)
    sp.add_argument("--blob-dir", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_unpack)

    sp = sub.add_parser(
        "inspect", help="query a bootstrap: tree listing / per-path detail"
    )
    sp.add_argument("--boot", required=True)
    g = sp.add_mutually_exclusive_group()
    g.add_argument("--path", default="", help="inspect one path in detail")
    g.add_argument("--list", dest="list_dir", default="",
                   help="list the entries of a directory path")
    g.add_argument("--prefix", default="",
                   help="restrict the full listing to a path prefix")
    sp.set_defaults(fn=cmd_inspect)

    sp = sub.add_parser("check", help="validate + describe a bootstrap")
    sp.add_argument("--boot", required=True)
    sp.set_defaults(fn=cmd_check)

    sp = sub.add_parser("batch", help="many images, growing cross-image dict")
    sp.add_argument("images", nargs="+", help="layer tar files, one image each")
    sp.add_argument("--out-dir", required=True)
    sp.add_argument("--dict-in", default="")
    sp.add_argument("--dict-out", default="")
    common(sp)
    sp.set_defaults(fn=cmd_batch)

    sp = sub.add_parser("export-erofs", help="bootstrap + tars -> EROFS disk")
    sp.add_argument("--boot", required=True)
    sp.add_argument("--tar-dir", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_export_erofs)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.device:  # a device asked for by name must exist
            from nydus_snapshotter_tpu_torch.tensors import resolve_device

            resolve_device(args.device)
        return args.fn(args)
    except Exception as e:  # noqa: BLE001 — subprocess contract: 1 line, rc 1
        print(f"ntpu-convert: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
