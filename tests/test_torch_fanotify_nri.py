"""The port's node-side helpers against the JAX package's: the fanotify
tracer (``fanotify.Server`` over the port's own ``optimizer-server``), the
``nydus-overlayfs`` mount helper, the optimizer and prefetch-files NRI
plugins, ``utils.display``, and the on-demand native builder.

Every case of tests/test_fanotify_nri.py runs in both packages (``pkg``,
through ``ported_cases``; the live tracer cases keep the reference's skip
condition: a built binary and root). So do the ``TestNativeBuild`` cases of
tests/test_utils_infra.py: the port's ``utils.native_build`` builds its
targets from ``native/`` (its copy of ``optimizer_server/main.cpp`` and of
the Makefile's rules) into the git-ignored ``build/bin/``, so its twin
finds a target's sources through ``native_build.source_dir`` rather than
next to the target.

Cross-package cases, on numpy-seeded inputs: ``nydus_overlayfs`` parses
and splits the same mount arguments alike, the optimizer plugin derives
the same persist paths from the same image annotations, ``display``
renders the same sizes and times, and ``EventInfo`` parses the same
tracer lines.
"""

from __future__ import annotations

import importlib
import json
import os

import numpy as np
import pytest

from tests.test_torch_cachefiles import UTILS_INFRA_SUBS
from tests.test_torch_fetch_sched import ROOTS, SIDES, ported_cases

ported_cases("test_fanotify_nri", globals())
ported_cases(
    "test_utils_infra",
    globals(),
    subs=UTILS_INFRA_SUBS,
    only=(
        "TestNativeBuild::test_built_artifact_is_current",
        "TestNativeBuild::test_sources_newer_after_touch",
        "TestNativeBuild::test_failure_memo_blocks_only_same_stamp",
        "TestNativeBuild::test_src_stamp_unreadable_dir",
    ),
)


def _mod(side: str, name: str):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the error is the answer compared
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_overlayfs_arguments_split_equally(seed):
    """Seeded mount arguments (fs type, flags, data options, the nydus
    ``extraoption`` and kata volume keys) parse to equal ``MountArgs``
    and split to equal flags and data in both packages."""
    rng = np.random.default_rng(seed)
    words = ["ro", "rw", "nosuid", "nodev", "noexec", "dev", "suid", "sync", "remount",
             "lowerdir=/l2:/l1", "upperdir=/u", "workdir=/w", "extraoption=eyJ4IjoxfQ==",
             "io.katacontainers.volume=abc", "index=off", "volatile"]
    cases = []
    for _ in range(12):
        opts = [words[int(i)] for i in rng.integers(0, len(words), int(rng.integers(0, 7)))]
        fs_type = ["overlay", "overlay", "ext4"][int(rng.integers(0, 3))]
        cases.append([fs_type, f"/mnt/t{int(rng.integers(0, 9))}", "-o", ",".join(opts)])
    got = {}
    for side in SIDES:
        ov = _mod(side, "cmd.nydus_overlayfs")
        out = []
        for argv in cases:
            parsed = _outcome(ov.parse_args, argv)
            if parsed[0] == "ok":
                m = parsed[1]
                parsed = ("ok", m.fs_type, m.target, list(m.options), ov.parse_options(list(m.options)))
            out.append(parsed)
        got[side] = out
    assert got["port"] == got["ref"]
    assert any(o[0] == "ok" for o in got["port"]) and any(o[0] == "error" for o in got["port"])


@pytest.mark.parametrize("seed", [0, 1])
def test_optimizer_plugin_persist_paths_equal(tmp_path, seed, monkeypatch):
    """The optimizer NRI plugin of each package, over the same seeded
    StartContainer / StopContainer events, starts tracers with equal
    arguments (persist paths under its own directory, each package's own
    ``optimizer-server``) and stops them alike."""
    rng = np.random.default_rng(seed)
    images = [f"{h}/{ns}/{name}:{tag}" for h, ns, name, tag in
              (("docker.io", "library", "redis", "7"), ("ghcr.io", "dragonflyoss", "nginx", "1.21"),
               ("quay.io", "org", "app", "v2"))]
    events = []
    for i in range(6):
        image = images[int(rng.integers(0, len(images)))]
        events.append({"event": "StartContainer", "container": {
            "pid": int(rng.integers(1, 1 << 20)), "annotations": {"io.kubernetes.cri.image-name": image}}})
    timeout = int(rng.integers(0, 60))
    got = {}
    for side in SIDES:
        nri = _mod(side, "cmd.optimizer_nri")
        calls = []

        class FakeServer:
            def __init__(self, **kw):
                self.kw = kw

            def run_server(self):
                kw = dict(self.kw, binary_path=os.path.basename(self.kw["binary_path"]))
                calls.append(("start", {k: str(v).replace(str(tmp_path / side), "<dir>")
                                        for k, v in sorted(kw.items())}))

            def stop_server(self):
                calls.append(("stop", self.kw["image_name"]))

        monkeypatch.setattr(nri, "Server", FakeServer)
        plugin = nri.OptimizerPlugin(nri.PluginConfig(persist_dir=str(tmp_path / side), timeout=timeout,
                                                      readable=bool(seed)))
        for ev in events:
            plugin.handle_event(ev)
        for ev in events[::2]:
            calls.append(_outcome(plugin.handle_event, dict(ev, event="StopContainer"))[0])
        got[side] = calls
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("seed", [0, 1])
def test_display_and_event_lines_equal(seed):
    """``display`` renders seeded sizes and durations alike, and
    ``EventInfo`` parses seeded tracer lines (and refuses bad ones) alike."""
    rng = np.random.default_rng(seed)
    sizes = [int(x) for x in rng.integers(0, 1 << 40, 30)] + [0, 1023, 1024, 1 << 20]
    micros = [int(x) for x in rng.integers(0, 10**10, 30)] + [0, 999, 1000, 10**6]
    lines = [json.dumps({"path": f"/usr/lib/f{int(rng.integers(0, 999))}", "size": int(rng.integers(0, 1 << 30)),
                         "elapsed": int(rng.integers(0, 1 << 30))}).encode() + b"\n" for _ in range(8)]
    lines += [b"not json\n", b"[1, 2]\n", b'{"path": "/x"}\n']
    got = {}
    for side in SIDES:
        display = _mod(side, "utils.display")
        info = _mod(side, "fanotify").EventInfo
        got[side] = ([display.byte_to_readable_iec(s) for s in sizes],
                     [display.microsecond_to_readable(m) for m in micros],
                     [_outcome(lambda line: tuple(vars(info.from_json_line(line)).values()), line) for line in lines])
    assert got["port"] == got["ref"]
