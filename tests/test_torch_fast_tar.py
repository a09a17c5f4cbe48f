"""The port's fast tar header walk against the JAX package's.

``_fast_tar_members`` reads an in-memory layer tar's headers without
``tarfile`` and bails to it (returns None) on anything it does not take.
Each case below, built with numpy-seeded data, goes through both
packages' walks: the same members (name, size, type, mode, ids, mtime,
link, device numbers, pax headers, data offset), the same bail, the same
``ConvertError``. Then both packages pack the tar: the same blob, or the
same refusal, from memory and streamed.
"""

import io
import tarfile

import numpy as np
import pytest

from nydus_snapshotter_tpu.converter import stream as jstream
from nydus_snapshotter_tpu.converter.convert import pack_layer as j_pack_layer
from nydus_snapshotter_tpu.converter.types import ConvertError as JConvertError
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu_torch.converter import pack as tpack
from nydus_snapshotter_tpu_torch.converter.types import ConvertError, PackOption

OPT = dict(chunk_size=0x4000, backend="hybrid")
RNG_SEED = 20261017


def _tar(members, fmt=tarfile.GNU_FORMAT, **kw) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=fmt, **kw) as tf:
        for ti, data in members:
            tf.addfile(ti, io.BytesIO(data) if data else None)
    return buf.getvalue()


def _reg(name, data, **attrs):
    ti = tarfile.TarInfo(name)
    ti.size = len(data)
    for k, v in attrs.items():
        setattr(ti, k, v)
    return ti, data


def _special(name, typ, **attrs):
    ti = tarfile.TarInfo(name)
    ti.type = typ
    for k, v in attrs.items():
        setattr(ti, k, v)
    return ti, None


def _fix_checksum(buf: bytearray, at: int = 0) -> bytes:
    buf[at + 148 : at + 156] = b" " * 8
    buf[at + 148 : at + 156] = ("%06o\0 " % sum(buf[at : at + 512])).encode("ascii")
    return bytes(buf)


def _basic(rng):
    out = [_special("dir", tarfile.DIRTYPE, mode=0o755)]
    for i, size in enumerate([0, 100, 511, 512, 513, 70_000]):
        out.append(_reg(f"dir/f{i}", rng.integers(0, 256, size, dtype=np.uint8).tobytes(),
                        mode=0o644, uid=1000 + i, gid=7, mtime=1_700_000_000 + i))
    out.append(_special("dir/link", tarfile.SYMTYPE, linkname="f1"))
    out.append(_special("dir/hard", tarfile.LNKTYPE, linkname="dir/f2"))
    return out


def _cases():
    rng = np.random.default_rng(RNG_SEED)
    data = rng.integers(0, 256, 90_000, dtype=np.uint8).tobytes()
    basic = _basic(rng)
    cases = {
        "gnu": _tar(basic),
        "ustar": _tar(basic, fmt=tarfile.USTAR_FORMAT),
        "pax": _tar(basic, fmt=tarfile.PAX_FORMAT),
        # ustar splits a long name into prefix + name
        "ustar_prefix": _tar([_reg("p/" + "a" * 120 + "/" + "b" * 60, data[:700])],
                             fmt=tarfile.USTAR_FORMAT),
        "pax_long_name_xattr": _tar(
            [_reg("bin/cap", b"data", pax_headers={"SCHILY.xattr.user.k": "vé"}),
             _reg("deep/" + "n" * 180 + "/file.bin", data[:600])], fmt=tarfile.PAX_FORMAT),
        "pax_fractional_mtime": _tar([_reg("f", data[:50], mtime=1_700_000_000.25)],
                                     fmt=tarfile.PAX_FORMAT),
        "pax_big_ids": _tar([_reg("f", data[:50], uid=1 << 22, gid=1 << 23)],
                            fmt=tarfile.PAX_FORMAT),
        "gnu_big_ids": _tar([_reg("f", data[:50], uid=1 << 22, gid=1 << 23)]),
        "devices": _tar([_special("dev/null", tarfile.CHRTYPE, devmajor=1, devminor=3),
                         _special("dev/sda", tarfile.BLKTYPE, devmajor=8, devminor=0),
                         _special("dev/fifo", tarfile.FIFOTYPE)]),
        "whiteouts": _tar([_special("a", tarfile.DIRTYPE), _reg("a/x", data[:10]),
                           _special("a/.wh.y", tarfile.REGTYPE),
                           _special("a/.wh..wh..opq", tarfile.REGTYPE)]),
        "negative_mtime_base256": _tar([_reg("old", b"data", mtime=-100)]),
        "pax_global": _tar([_reg("f", b"data")], fmt=tarfile.PAX_FORMAT,
                           pax_headers={"comment": "global"}),
        "gnu_longname": _tar([_reg("a/" + "x" * 150, b"abcd")]),
        "pax_sparse": _tar([_reg("s", b"data", pax_headers={"GNU.sparse.major": "1"})],
                           fmt=tarfile.PAX_FORMAT),
        "pax_negative_size": _tar([_reg("evil", b"data", pax_headers={"size": "-512"}),
                                   _reg("ok", b"good")], fmt=tarfile.PAX_FORMAT),
        "pax_huge_mtime": _tar([_reg("evil", b"data", pax_headers={"mtime": "1e300"})],
                               fmt=tarfile.PAX_FORMAT),
        "pax_nan_mtime": _tar([_reg("evil", b"data", pax_headers={"mtime": "nan"})],
                              fmt=tarfile.PAX_FORMAT),
        "pax_inf_mtime": _tar([_reg("evil", b"data", pax_headers={"mtime": "inf"})],
                              fmt=tarfile.PAX_FORMAT),
        "garbage": b"garbage",
    }
    raw = _tar(basic)
    cases["truncated"] = raw[: len(raw) // 2]
    bad = bytearray(raw)
    bad[148] ^= 0x05
    cases["corrupt_checksum"] = bytes(bad)
    neg = bytearray(_tar([_reg("evil", b"data")]))
    neg[124:136] = tarfile.itn(-512, 12, tarfile.GNU_FORMAT)
    cases["negative_size_base256"] = _fix_checksum(neg)
    dev = bytearray(_tar([_special("dev/weird", tarfile.CHRTYPE, devmajor=1, devminor=3)]))
    dev[329:336] = b"zzzzzzz"
    cases["malformed_devnum"] = _fix_checksum(dev)
    # a regular typeflag with a trailing slash is a directory
    slash = bytearray(_tar([_reg("d", b"")]))
    slash[0:2] = b"d/"
    cases["trailing_slash_dir"] = _fix_checksum(slash)
    # a symlink member that carries data
    sym = bytearray(_tar([_reg("l", b"x" * 10)]))
    sym[156:157] = b"2"
    cases["symlink_with_data"] = _fix_checksum(sym)
    return cases


CASES = _cases()


def _walk(fn, raw, err):
    try:
        got = fn(memoryview(raw))
    except err as e:
        return ("ConvertError", str(e))
    if got is None:
        return None
    return [
        (ti.name, ti.size, ti.type, ti.mode, ti.uid, ti.gid, ti.mtime, ti.linkname,
         ti.devmajor, ti.devminor, dict(ti.pax_headers), off)
        for ti, off in got
    ]


@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_matches_reference(case):
    raw = CASES[case]
    want = _walk(jstream._fast_tar_members, raw, JConvertError)
    got = _walk(tpack._fast_tar_members, raw, ConvertError)
    assert got == want


@pytest.mark.parametrize(
    "case, outcome",
    [("gnu", "list"), ("pax_long_name_xattr", "list"), ("negative_mtime_base256", "list"),
     ("pax_huge_mtime", "list"), ("pax_global", None), ("gnu_longname", None),
     ("corrupt_checksum", None), ("truncated", None), ("garbage", None),
     ("negative_size_base256", None), ("malformed_devnum", None), ("pax_nan_mtime", None),
     ("pax_sparse", None), ("symlink_with_data", None), ("pax_negative_size", "error")],
)
def test_walk_outcome(case, outcome):
    """Which cases the walk takes, bails on, or rejects (a negative pax
    size: bailing to tarfile would drop the member and all after it)."""
    got = _walk(tpack._fast_tar_members, CASES[case], ConvertError)
    kind = None if got is None else ("error" if isinstance(got, tuple) else "list")
    assert kind == outcome


def _pack(fn, raw, opt, err):
    try:
        blob, res = fn(raw, opt)
    except err:
        return "ConvertError"
    return blob, res.bootstrap, res.blob_id


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_matches_reference(case):
    """Both packages pack every case to the same bytes or both refuse it
    (the huge and non-finite mtimes and the negative size with
    ``ConvertError``), from memory (the fast walk) and streamed (tarfile)."""
    raw = CASES[case]
    want = _pack(j_pack_layer, raw, JPackOption(**OPT), JConvertError)
    got = _pack(lambda r, o: tpack.pack_layer(r, o, device="cpu"), raw, PackOption(**OPT),
                ConvertError)
    assert got == want
    want_stream = _pack(lambda r, o: j_pack_layer(io.BytesIO(r), o), raw, JPackOption(**OPT),
                        JConvertError)
    stream = _pack(lambda r, o: tpack.pack_layer(io.BytesIO(r), o, device="cpu"), raw,
                   PackOption(**OPT), ConvertError)
    assert stream == want_stream


def test_pack_uses_fast_walk(monkeypatch):
    """An in-memory tar the walk takes never opens ``tarfile``."""
    opened = []
    real = tpack.tarfile.open
    monkeypatch.setattr(tpack.tarfile, "open", lambda *a, **k: opened.append(1) or real(*a, **k))
    tpack.pack_layer(CASES["pax"], PackOption(**OPT), device="cpu")
    assert opened == []
    tpack.pack_layer(CASES["gnu_longname"], PackOption(**OPT), device="cpu")
    assert opened == [1]
