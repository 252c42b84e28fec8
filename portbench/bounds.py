"""The yardstick of the kernels' roofline shares: the H100's published
peaks and the least work a WGL search launch needs.

Frozen copies, made when this benchmark was added, of `chip_smoke.py`'s
peaks (lines 263-276: HBM_BYTES_PER_S, INT32_OPS_PER_S, STEP_OPS),
`bound` (K1, lines 391-400), SEARCH_STEP_BYTES (lines 569-573) and
`bound_search` (K2, lines 590-609), with the memo-key widths they read
from the port (`wgl_vec._nw`/`_key_words`, `wgl_search._nw`/
`key_words`) written out here, so that a later change to the program
cannot move the yardstick.

A bound is (seconds for the bytes, seconds for the operations); the
least time a launch can take is the larger of the two.
"""

from __future__ import annotations

# One H100 SXM (NVIDIA's data sheet; the card's power limit is read
# beside every figure): HBM3 bandwidth, and the int32 ALU rate (64 INT32
# lanes an SM x 132 SMs x the 1.98 GHz boost clock).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# int32 operations one search step does besides the memo key compare
# (decode the entry, step the model, hash, relink four list words, push
# or pop, bookkeeping), counted from wgl_vec.cu's step body
STEP_OPS = 64
# bytes one K2 step moves at the least: the node's map words (2), the
# entry's six columns, four list words read and four written (int32),
# and the 8 probe fingerprints (uint16)
SEARCH_STEP_BYTES = 4 * (2 + 6 + 4 + 4) + 2 * 8

SCALAR_MODELS = ("cas-register", "register", "mutex")


def bitset_words(n_pad: int) -> int:
    """int32 words of one lane's linearized bitset."""
    return max(1, (n_pad + 31) // 32)


def vec_key_words(model_name: str, n_pad: int, n_state: int) -> int:
    """Words of one K1 memo key: the bitset, and the state word of a
    scalar model (a fifo key keeps its live window)."""
    if model_name == "fifo-queue":
        return bitset_words(n_pad) + n_state - 8
    if model_name in SCALAR_MODELS:
        return bitset_words(n_pad) + 1
    return bitset_words(n_pad)


def bound_vec(packed_numel: int, width: int, n_pad: int, steps: int,
              key_words: int) -> tuple:
    """One K1 launch over a packed buffer of `packed_numel` int32 words
    and `width` lanes: the buffer and the step budgets read once, the
    5-row result block and the best stack written once, over HBM
    bandwidth; the steps the launch took times (STEP_OPS + one a key
    word), over the int32 rate."""
    nbytes = 4 * (packed_numel + width + 5 * width + n_pad * width)
    ops = steps * (key_words + STEP_OPS)
    return nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S


def search_key_words(model_name: str, state_in_key: bool, n_pad: int,
                     n_state: int) -> tuple:
    """(words of one K2 memo key, the words counted a key inserted): the
    bitset, then the state where the model keys on it; a fifo key is
    counted at its bitset and count words only."""
    nw = (n_pad + 31) // 32
    kw = nw + (n_state if state_in_key else 0)
    return kw, (nw + 1 if model_name == "fifo-queue" else kw)


def bound_search(packed_numel: int, lanes: int, steps: int, depth: int,
                 key_words_min: int) -> tuple:
    """One K2 launch: the packed lanes and the step budgets read once and
    the (3, lanes) result written once; SEARCH_STEP_BYTES a step the
    launch took; and a key a level of each lane's final depth (`depth`,
    summed over lanes) written once. Operations: STEP_OPS a step and one
    a word of those keys."""
    key_words = key_words_min * depth
    nbytes = (4 * (packed_numel + lanes + 3 * lanes)
              + SEARCH_STEP_BYTES * steps + 4 * key_words)
    ops = steps * STEP_OPS + key_words
    return nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
