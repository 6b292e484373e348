"""The K4 and K3 work counts against hand counts at a tiny shape."""

import math

import pytest

from port_bench import roofline

CFG = {"rank": 2, "cc_frac": 0.95, "n_restarts": 3, "maxiter": 500}


def test_lane_trip_counts_by_hand():
    r, m, n = 2, 20, 4
    # A^H(Y - M/mu): 2x20 @ 20x4, U: 2x4 @ 4x4, A X: 2x4 @ 4x20,
    # A^H Y: 2x20 @ 20x4; 6 flops a complex multiply-add
    macs = 2 * 20 * 4 + 2 * 4 * 4 + 2 * 4 * 20 + 2 * 20 * 4
    assert roofline.lane_trip_products(r, m, n) == 6 * macs
    entries = (2 * 20 + 2 * 4) + (2 * 4 + 2 * 4) + (2 * 4 + 2 * 20) + (
        2 * 20 + 2 * 4)
    assert roofline.lane_trip_bytes(r, m, n) == 8 * entries
    nr = 2
    assert roofline.lane_trip_rest(r, m, n, nr) == (
        2 * r * n * nr * 8 + 7 * nr ** 3 * 8 + 16 * r * m)


def test_refine_bound():
    # 288 lockstep trips (1155 launches); 819 iters over 3 restarts:
    # the refine ran at most (3 * 1155 / 4 - 819) / 2 trips
    assert roofline.refine_trip_bound(819, 1155, 3, 500) == math.floor(
        (3 * 1155 / 4 - 819) / 2)
    assert roofline.refine_trip_bound(10, 1155, 3, 500) == 10
    assert roofline.refine_trip_bound(900, 400, 3, 500) == 0
    assert roofline.refine_trip_bound(700, 4000, 1, 500) == 500


def test_k4_work_by_hand():
    nt = nr = 2
    m = 20
    mt = math.floor(20 * 0.95)
    iters, launches = [[40, 30]], [4 * 20]
    flops, n_bytes = roofline.k4_work(iters, launches, CFG, nt, nr, m)
    want_f = want_b = 0.0
    for it in (40, 30):
        ref = min(it, math.floor((3 * 20 - it) / 2))
        for r, trips in ((2, it - ref), (1, ref)):
            want_f += trips * 6 * r * (3 * mt * 4 + 16)
            want_b += trips * 8 * r * (3 * mt + 5 * 4)
    assert flops == pytest.approx(want_f) and n_bytes == pytest.approx(want_b)


def test_k3_work_by_hand():
    nt = nr = 2
    tc, rest = roofline.k3_work([600, 300], CFG, nt, nr, 20)
    mt = 19
    want = 100 * 6 * 2 * (3 * mt * 4 + 16) + 500 * 6 * 1 * (3 * mt * 4 + 16)
    want += 300 * 6 * 1 * (3 * mt * 4 + 16)
    assert tc == pytest.approx(want)
    assert rest > 0


def test_least_seconds_takes_the_largest():
    assert roofline.least_seconds(495e12, 0, 0) == pytest.approx(3.0)
    assert roofline.least_seconds(0, 67e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 0, 3.35e12) == pytest.approx(1.0)
