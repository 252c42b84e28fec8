"""Each bound count of portbench/bounds.py against a count by hand."""

from __future__ import annotations

from portbench import bounds


def test_peaks():
    assert bounds.HBM_BYTES_PER_S == 3.35e12
    assert bounds.INT32_OPS_PER_S == 64 * 132 * 1.98e9 == 16_727_040e6
    assert bounds.SEARCH_STEP_BYTES == 80


def test_k1_key_words():
    # n_pad 64: two bitset words, and the state word of a scalar model
    assert bounds.vec_key_words("cas-register", 64, 1) == 3
    assert bounds.vec_key_words("unordered-queue", 64, 4) == 2
    assert bounds.vec_key_words("fifo-queue", 64, 16) == 2 + 16 - 8
    assert bounds.vec_key_words("mutex", 1, 1) == 2


def test_k1_bound_by_hand():
    # 128 lanes of n_pad 64: the packed buffer 129 x 128 words, the step
    # budgets 128 words, the result block 5 x 128, the best stack 64 x 128
    words = 129 * 128 + 128 + 5 * 128 + 64 * 128
    t_bytes, t_ops = bounds.bound_vec(129 * 128, 128, 64, 1_000_000, 3)
    assert t_bytes == 4 * words / 3.35e12
    assert t_ops == 1_000_000 * (3 + 64) / (64 * 132 * 1.98e9)
    assert t_ops > t_bytes


def test_k2_bound_by_hand():
    # one lane of n_pad 32768, a cas register (state in the key)
    kw, kw_min = bounds.search_key_words("cas-register", True, 32768, 1)
    assert (kw, kw_min) == (1024 + 1, 1025)
    assert bounds.search_key_words("fifo-queue", True, 64, 40) == (42, 3)
    packed = 32768 * 8 + 1
    t_bytes, t_ops = bounds.bound_search(packed, 1, 20_000, 20_000, kw_min)
    assert t_bytes == (4 * (packed + 1 + 3) + 80 * 20_000
                       + 4 * 1025 * 20_000) / 3.35e12
    assert t_ops == (64 * 20_000 + 1025 * 20_000) / (64 * 132 * 1.98e9)
