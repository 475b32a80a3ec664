"""The work formulas of the rooflines against counts made by hand."""

import json
import os
from collections import Counter

import pytest

from prover_bench.readers import least_time
from prover_bench.work import h, msm

PEAKS = json.load(open(os.path.join(os.path.dirname(__file__), "..",
                                    "peaks.json")))


def test_msm_products_by_hand():
    # scalars of 3, 3 and 1 bits in G1: c = 3 is one window, 3 adds of
    # the points and 2^3 - 2 of the reduction: 9 adds of 6 products;
    # c = 1 (9 adds, 2 doublings: 68), c = 2 (10 adds, 2 doublings: 74)
    assert msm.products(Counter({3: 2, 1: 1}), "g1") == 54
    assert msm.products(Counter({3: 2, 1: 1}), "g2") == 9 * 17
    assert msm.products(Counter({0: 5}), "g1") == 0
    # zero scalars add nothing beside the others
    assert (msm.products(Counter({3: 2, 1: 1, 0: 7}), "g1")
            == msm.products(Counter({3: 2, 1: 1}), "g1"))


def test_msm_window_is_the_least_over_c():
    bits = Counter({254: 1 << 20})
    best = msm.products(bits, "g1")
    # c = 17: 15 windows of 2^20 adds and 2^17 - 2, 14 joins, 14 x 17
    # doublings
    c17 = (15 * (1 << 20) + 15 * ((1 << 17) - 2) + 14) * 6 + 14 * 17 * 7
    assert best == c17


def test_msm_work_of_a_proof():
    circuit = {"num_inputs": 2, "num_aux": 2, "a": [[]] * 3}
    z = [1, 5, 0, 2]       # bit lengths 1, 3, 0, 2; m = 8
    w = msm.work(circuit, z, PEAKS)
    zb, aux = Counter({1: 1, 3: 1, 0: 1, 2: 1}), Counter({0: 1, 2: 1})
    prods = (2 * msm.products(zb, "g1") + msm.products(aux, "g1")
             + msm.products(Counter({254: 7}), "g1")
             + msm.products(zb, "g2"))
    assert w["products"] == prods and w["ops"] == 256 * prods
    assert w["bytes"] == (2 * (4 * 96 + 64) + (2 * 96 + 64) + (7 * 96 + 64)
                          + (4 * 160 + 128))


def test_butterflies_by_hand():
    # size 8: stage 1 all twiddles 1; stage 2 two of 1, w^2; stage 3
    # w, w^2, w^3: 5 products
    assert h.butterfly_products(8) == 5
    assert h.butterfly_products(2) == 0
    assert h.butterfly_products(1 << 21) == (1 << 20) * 21 - ((1 << 21) - 1)


def test_h_work_by_hand():
    # 2 rows + 1 input row... 3 rows, one input: m = 4
    circuit = {"num_inputs": 1, "num_aux": 2,
               "a": [[(1, 1)], [(2, 3)]], "b": [[(1, 1)], [(0, 0)]],
               "c": [[(2, 1), (0, 7)], [(1, 1)]]}
    w = h.work(circuit, None, PEAKS)
    entries, by_coef = 6, 2          # the (0, 0) entry is no entry
    assert w["products"] == by_coef + 7 * h.butterfly_products(4) + 5 * 4
    assert w["bytes"] == entries * 36 + 3 * 32 + 3 * 4 * 32 + 3 * 32


def test_least_time_is_the_larger_bound():
    rate = 132 * 64 * 1.98e9
    assert least_time({"ops": rate, "bytes": 0}, PEAKS) == pytest.approx(1)
    assert least_time({"ops": 0, "bytes": 3.35e12}, PEAKS) == (
        pytest.approx(1))
    assert least_time({"ops": rate, "bytes": 6.7e12}, PEAKS) == (
        pytest.approx(2))
