"""ops/cuda_build under concurrent callers, on the CPU.

BatchConverter packs an image's layers on a thread pool, so the fused
lane's kernels are first built, loaded and launched from several threads
at once. A stub compiler (a script in place of ``nvcc`` that sleeps, then
writes its ``-o`` file) and a stub entry point stand in for the card.
"""

import os
import stat
import sys
import textwrap
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest

from nydus_snapshotter_tpu_torch.ops import cuda_build

STUB_NVCC = textwrap.dedent(
    f"""\
    #!{sys.executable}
    import sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    time.sleep(0.2)
    with open(out, "wb") as f:
        f.write(b"stub library")
    """
)


@pytest.fixture()
def stub_tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "stub.cu").write_text('extern "C" int stub(void) { return 0; }\n')
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(STUB_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    calls = []

    def counted_nvcc():
        calls.append(threading.get_ident())
        return str(nvcc)

    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build)
    monkeypatch.setattr(cuda_build, "_nvcc", counted_nvcc)
    return build, calls


@pytest.mark.parametrize("threads", [2, 8])
def test_concurrent_builds_of_one_source(stub_tree, threads):
    """Every thread gets the one library; the compiler ran once and no
    temporary file is left behind."""
    build, calls = stub_tree
    barrier = threading.Barrier(threads)

    def one(_):
        barrier.wait()
        return cuda_build.build("stub.cu")

    with ThreadPoolExecutor(max_workers=threads) as pool:
        results = [f.result(timeout=60) for f in [pool.submit(one, i) for i in range(threads)]]
    paths = {path for path, _log in results}
    assert paths == {cuda_build.library_path("stub.cu")}
    assert sorted(os.listdir(build)) == [cuda_build.library_path("stub.cu").name]
    assert len(calls) == 1
    assert (build / cuda_build.library_path("stub.cu").name).read_bytes() == b"stub library"


def test_failed_build_leaves_nothing(stub_tree, monkeypatch, tmp_path):
    build, _calls = stub_tree
    bad = tmp_path / "bad_nvcc"
    bad.write_text(f"#!{sys.executable}\nimport sys\nsys.stderr.write('no')\nsys.exit(1)\n")
    bad.chmod(bad.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(bad))
    with pytest.raises(cuda_build.BuildError, match="nvcc failed"):
        cuda_build.build("stub.cu")
    assert not build.exists() or os.listdir(build) == []


def test_launch_counter_under_threads():
    """``launches`` counts every launch of a stub entry point made from 8
    threads at once (the counter's read-add-store is locked)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        k = cuda_build.Kernel("stub.cu", "stub", [])
        k._fn = lambda *a: 0  # the loaded entry point: returns cudaSuccess
        per_thread = 5000
        barrier = threading.Barrier(8)

        def run(_):
            barrier.wait()
            for _i in range(per_thread):
                k.launch()

        with ThreadPoolExecutor(max_workers=8) as pool:
            for f in [pool.submit(run, i) for i in range(8)]:
                f.result(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert k.launches == 8 * per_thread


def test_failed_launch_not_counted():
    k = cuda_build.Kernel("stub.cu", "stub", [])
    k._fn = lambda *a: 719  # cudaErrorLaunchFailure
    with pytest.raises(cuda_build.KernelError, match="CUDA error 719"):
        k.launch()
    assert k.launches == 0


def test_concurrent_loads_bind_once(stub_tree, monkeypatch):
    """Threads racing into ``Kernel.load`` build and bind the library once."""
    import ctypes

    opened = []

    class FakeLib:
        def __init__(self, path):
            opened.append(path)
            self.stub = lambda *a: 0

    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    k = cuda_build.Kernel("stub.cu", "stub", [])
    barrier = threading.Barrier(8)

    def one(_):
        barrier.wait()
        k.launch()

    with ThreadPoolExecutor(max_workers=8) as pool:
        for f in [pool.submit(one, i) for i in range(8)]:
            f.result(timeout=60)
    assert len(opened) == 1 and k.launches == 8
