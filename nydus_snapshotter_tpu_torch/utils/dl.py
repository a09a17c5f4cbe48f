"""Where a ctypes-bound shared library was loaded from."""

from __future__ import annotations

import ctypes
import os


class _DlInfo(ctypes.Structure):
    _fields_ = [
        ("dli_fname", ctypes.c_char_p),
        ("dli_fbase", ctypes.c_void_p),
        ("dli_sname", ctypes.c_char_p),
        ("dli_saddr", ctypes.c_void_p),
    ]


def object_path(func) -> str:
    """The resolved file of the shared object that holds the ctypes
    function ``func`` (``dladdr``), or its library's load name when the
    loader cannot say."""
    info = _DlInfo()
    for name in (None, "libdl.so.2"):
        try:
            dladdr = ctypes.CDLL(name).dladdr
        except (OSError, AttributeError):
            continue
        dladdr.argtypes = [ctypes.c_void_p, ctypes.POINTER(_DlInfo)]
        dladdr.restype = ctypes.c_int
        if dladdr(ctypes.cast(func, ctypes.c_void_p), ctypes.byref(info)) and info.dli_fname:
            return os.path.realpath(info.dli_fname.decode())
    return getattr(func, "__name__", "?")
