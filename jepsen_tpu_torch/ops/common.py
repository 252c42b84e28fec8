"""Constants shared by the search engines (verdict codes, budgets)."""

from . import next_pow2 as _next_pow2  # noqa: F401  (re-exported)

# verdict codes, as the kernel writes them
RUNNING, VALID, INVALID, UNKNOWN = 0, 1, 2, 3

DEFAULT_MAX_STEPS = 2_000_000

# Conservative lower bound on search steps per second, used to turn a
# wall-clock budget into a step budget (a kernel loop cannot consult
# the wall clock). Underestimating only makes the search give up
# (unknown) earlier than the wall budget.
STEPS_PER_SEC_ESTIMATE = 50_000
