"""The frozen roofline arithmetic reproduces the bounds the port's
bring-up printed for kernel A."""

import pytest

from harness import roofline


def test_warp_a_bound_turntable_24_views():
    # 512^3 x 24 views of 320x240: 2.98 ms, by operations
    t, by = roofline.warp_a_bound_s(512, 512, 512, 24, 240, 320)
    assert by == "operations"
    assert t * 1e3 == pytest.approx(2.98, abs=0.005)


def test_warp_a_bound_uhd_facade():
    # 512^3 x 36 views of 3840x2160: 7.789 ms, pass 1 over 1024 rows
    t, by = roofline.warp_a_bound_s(512, 512, 512, 36, 2160, 3840)
    assert by == "operations"
    assert t * 1e3 == pytest.approx(7.789, abs=0.0005)


def test_warp_a_bound_qvga_36_views():
    t, _ = roofline.warp_a_bound_s(512, 512, 512, 36, 240, 320)
    assert t * 1e3 == pytest.approx(4.48, abs=0.005)


def test_mc_b_bound_counts_the_state_once():
    t, by = roofline.mc_b_bound_s(512, 512, 512, 0, 0)
    assert by == "bytes"
    assert t == pytest.approx(8 * 512**3 / roofline.PEAK_BYTES_S)
    more, _ = roofline.mc_b_bound_s(512, 512, 512, 1000, 1001)
    assert more == pytest.approx(t + 8 * (1000 + 201) / roofline.PEAK_BYTES_S)
