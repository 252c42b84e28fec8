"""Bank-transfer workload checkers (the port's copy of the checking half
of `jepsen_tpu/workloads/bank.py`; reference: jepsen/src/jepsen/tests/
bank.clj:46-178): concurrent transfers between accounts while readers
snapshot all balances; under snapshot isolation every read must show
the same non-negative total.

Test map options:
    accounts       collection of account identifiers
    total_amount   total amount allocated across accounts
    max_transfer   largest single transfer

The generator is not ported (the port has no `generator.py`).
"""

from __future__ import annotations

from ..checker import Checker, Compose
from ..checker.perf import load_pyplot, out_path
from ..history import ops as _ops
from ..util import nanos_to_secs


def err_badness(test, err) -> float:
    """Severity score for a bank error — bigger is worse (bank.clj:46-55)."""
    t = err["type"]
    if t == "unexpected-key":
        return len(err["unexpected"])
    if t == "nil-balance":
        return len(err["nils"])
    if t == "wrong-total":
        total_amount = test["total_amount"]
        return abs((err["total"] - total_amount) / total_amount)
    if t == "negative-value":
        return -sum(err["negative"])
    return 0.0


def check_op(accounts: set, total: int, op) -> dict | None:
    """Errors in a single read's balance snapshot (bank.clj:57-83)."""
    value = op.value or {}
    ks = list(value.keys())
    balances = list(value.values())
    unexpected = [k for k in ks if k not in accounts]
    if unexpected:
        return {"type": "unexpected-key", "unexpected": unexpected, "op": op}
    nils = {k: v for k, v in value.items() if v is None}
    if nils:
        return {"type": "nil-balance", "nils": nils, "op": op}
    if sum(balances) != total:
        return {"type": "wrong-total", "total": sum(balances), "op": op}
    negative = [b for b in balances if b < 0]
    if negative:
        return {"type": "negative-value", "negative": negative, "op": op}
    return None


class BankChecker(Checker):
    """Balances must be non-negative and sum to total_amount on every
    read (bank.clj:85-117)."""

    def check(self, test, history, opts=None) -> dict:
        accounts = set(test["accounts"])
        total = test["total_amount"]
        reads = [o for o in _ops(history) if o.is_ok and o.f == "read"]
        by_type: dict = {}
        for op in reads:
            err = check_op(accounts, total, op)
            if err is not None:
                by_type.setdefault(err["type"], []).append(err)
        first_error = None
        firsts = [errs[0] for errs in by_type.values()]
        if firsts:
            first_error = min(firsts, key=lambda e: e["op"].index)
        errors = {}
        for t, errs in by_type.items():
            entry = {
                "count": len(errs),
                "first": errs[0],
                "worst": max(errs, key=lambda e: err_badness(test, e)),
                "last": errs[-1],
            }
            if t == "wrong-total":
                entry["lowest"] = min(errs, key=lambda e: e["total"])
                entry["highest"] = max(errs, key=lambda e: e["total"])
            errors[t] = entry
        return {
            "valid": not errors,
            "read-count": len(reads),
            "error-count": sum(len(v) for v in by_type.values()),
            "first-error": first_error,
            "errors": errors,
        }


def checker() -> BankChecker:
    return BankChecker()


def by_node(test, history) -> dict:
    """Group client ops by the node their process maps to
    (bank.clj:119-128)."""
    nodes = test["nodes"]
    n = len(nodes)
    out: dict = {}
    for op in history:
        if isinstance(op.process, int):
            out.setdefault(nodes[op.process % n], []).append(op)
    return out


def points(history) -> list:
    """[time_secs, total-of-accounts] per ok read (bank.clj:130-139)."""
    return [
        (
            nanos_to_secs(op.time),
            sum(v for v in (op.value or {}).values() if v is not None),
        )
        for op in history
        if op.is_ok and op.f == "read"
    ]


class BankPlotter(Checker):
    """Scatter plot of per-node account totals over time → bank.png
    (bank.clj:141-167; matplotlib instead of gnuplot)."""

    def check(self, test, history, opts=None) -> dict:
        path = out_path(test, opts or {}, "bank.png")
        totals = {
            node: points(ops) for node, ops in by_node(test, _ops(history)).items()
        }
        if path is not None:
            plt = load_pyplot()
            fig, ax = plt.subplots(figsize=(9, 5))
            for node, pts in sorted(totals.items()):
                if pts:
                    xs, ys = zip(*pts)
                    ax.scatter(xs, ys, s=12, marker="x", label=str(node))
            ax.set_xlabel("time (s)")
            ax.set_ylabel("Total of all accounts")
            ax.set_title(f"{test.get('name', 'test')} bank")
            if totals:
                ax.legend(loc="best", fontsize=8)
            fig.savefig(path, dpi=100)
            plt.close(fig)
        return {"valid": True}


def plotter() -> BankPlotter:
    return BankPlotter()


def test(device=None) -> dict:
    """The partial test bundle's defaults and checkers (bank.clj:169-178),
    without the generator.

    The "cycle" entry runs the transactional cycle checker beside the
    SI total check, on `device` (None = CUDA, raising when it is absent
    and the graph has a cycle candidate; "cpu" the kernels' plain
    versions). Bank ops carry aggregate snapshots ({account: balance})
    rather than micro-op transactions, so dependency inference sees no
    attributable versions and the entry is vacuously true on this value
    shape; a client recording micro-op transfer txns gets
    G0/G1c/G-single/G2 classification with no further changes."""
    from ..checker import cycle

    return {
        "max_transfer": 5,
        "total_amount": 100,
        "accounts": list(range(8)),
        "checker": Compose({"SI": checker(), "plot": plotter(),
                            "cycle": cycle.checker(device=device)}),
    }
