"""The frozen roofline arithmetic on hand counts."""

from __future__ import annotations

import pytest

from benchmark import bounds


def test_peaks():
    assert bounds.INT32_OPS_PER_S == pytest.approx(132 * 64 * 1.98e9)
    assert bounds.HBM_BYTES_PER_S == 3.35e12


def test_operation_counts():
    assert bounds.K1_OPS_PER_POS == 6
    assert bounds.K2_OPS_PER_BLOCK == 1400
    assert bounds.K4_OPS_PER_COMPRESSION == 680


def test_sha256_blocks():
    # the padding adds 0x80 and an 8-byte length: 55 bytes fit one block, 56 do not
    assert bounds.sha256_blocks([0, 55, 56, 64, 119, 120]).tolist() == [1, 1, 2, 2, 2, 3]


def test_blake3_compressions():
    # empty: one block; 1 KiB: one leaf of 16; 1025: 16 + 1 blocks + 1 parent;
    # 3 KiB: 48 blocks + 2 parents
    assert bounds.blake3_compressions([0]) == 1
    assert bounds.blake3_compressions([64, 65]) == 1 + 2
    assert bounds.blake3_compressions([1024]) == 16
    assert bounds.blake3_compressions([1025]) == 18
    assert bounds.blake3_compressions([3072]) == 50


def test_k1_bound_is_bytes_or_operations():
    n = 2**30
    by_bytes = 1.25 * n / 3.35e12
    by_ops = 6 * n / bounds.INT32_OPS_PER_S
    assert bounds.k1_bound_s(n) == pytest.approx(max(by_bytes, by_ops))


def test_k2_bound_of_hand_chunks():
    sizes = [1 << 20] * 4
    blocks = 4 * ((1 << 20) // 64 + 1)
    assert bounds.k2_bound_s(sizes) == pytest.approx(blocks * 1400 / bounds.INT32_OPS_PER_S)
    assert bounds.k2_serial_blocks(sizes) == (1 << 20) // 64 + 1


def test_k4_bound_of_hand_chunks():
    sizes = [2048, 1 << 20]
    comp = (32 + 1) + (16384 + 1023)
    assert bounds.k4_bound_s(sizes) == pytest.approx(comp * 680 / bounds.INT32_OPS_PER_S)
    # the 1 MiB chunk: a full leaf of 16 blocks, then 10 tree levels
    assert bounds.k4_chain(sizes) == 16 + 10


def test_roofline_of_a_reader():
    from benchmark import manifest, trace

    tr = trace.DeviceTrace(device=[
        trace.Interval("(anonymous namespace)::gear_bitmaps_kernel(unsigned char const*, long)",
                       0.0, 0.004),
        trace.Interval("(anonymous namespace)::sha256_chunks_kernel(unsigned char const*)",
                       0.004, 0.005)])

    class Ctx:
        pass

    ctx = Ctx()
    ctx.trace = tr
    ctx.work = {"positions": 2**30, "chunk_sizes": [1 << 20] * 1024}
    got = manifest.reader("k1_roofline_pct").read(ctx)
    assert got == pytest.approx(100 * bounds.k1_bound_s(2**30) / 0.004)
    assert manifest.reader("k4_roofline_pct").read(ctx) is None  # no K4 kernel ran
    tr.device = [trace.Interval("gear_bitmaps_v2", 0, 1)]  # renamed: the metric falls silent
    assert manifest.reader("k1_roofline_pct").read(ctx) is None


def test_kernel_names():
    from benchmark import trace

    name = "void at::native::vectorized_elementwise_kernel<2, at::native::F<long> >(int, F)"
    assert trace.DeviceTrace.short(name) == "at::native::vectorized_elementwise_kernel"
    assert trace.DeviceTrace.ident("(anonymous namespace)::blake3_leaves(unsigned char const*)") \
        == "blake3_leaves"
    assert trace.DeviceTrace.short("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
