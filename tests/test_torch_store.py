"""The port's store (`jepsen_tpu_torch/store.py`), analysis journal and
check artifacts, against the JAX package: the same calls write the same
bytes (results.edn, history.txt, linear.svg, timeline-cycle.html,
journal lines, atomic JSON with its .prev), a journal or WAL written by
either package reads in the other, and a journaled second analysis
checks no key and launches no closure. Exact (byte for byte)."""

import filecmp
import json
import os

import numpy as np
import pytest

from jepsen_tpu import history as jhist
from jepsen_tpu import independent as jind
from jepsen_tpu import models as jmodels
from jepsen_tpu import store as jstore
from jepsen_tpu.checker import cycle as jcycle
from jepsen_tpu.checker.linearizable import linearizable as jlinearizable
from jepsen_tpu.workloads import list_append as jla

from jepsen_tpu_torch import independent, store
from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.checker import cycle
from jepsen_tpu_torch.checker.cycle import anomalies
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.ops import closure
from jepsen_tpu_torch.workloads import list_append
from jepsen_tpu_torch.workloads.register import keyed_history

NAME, START = "store-parity", "20260101T000000.000"


def store_map(**kw):
    return {"name": NAME, "start_time": START, "store_dir": "store", **kw}


def jax_ops(hist):
    """The port's Ops (keyed values included) as the JAX package's."""
    out = []
    for o in hist:
        v = o.value
        if isinstance(v, independent.KVTuple):
            v = jind.KVTuple(v.key, v.value)
        out.append(jhist.Op.from_dict({**o.to_dict(), "value": v}))
    return out


def tree(root) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def normalise(d):
    d = json.loads(json.dumps(d, default=str))
    if isinstance(d, dict):
        d.pop("supervision", None)
    return d


VALUES = {
    "dict": {"valid": False, (1, 2): {3, 1, 2}, "np": np.int64(7),
             "np32": np.int32(-3), "npb": np.bool_(True), "kv": independent.KVTuple(1, [2, 3]),
             "b": b"x\xff", "f": 1.5, "none": None,
             "fs": frozenset({"b", "a"}), "nested": [(1, None), {"k": ()}]},
    "ops": {"op": thist.Op(0, "ok", "cas", (1, 2), time=5, index=3,
                           error="timeout", extra={"node": "n1"})},
}


@pytest.mark.parametrize("name", sorted(VALUES))
def test_write_json_bytes_match_jax(tmp_path, monkeypatch, name):
    """write_json / write_edn and atomic_write_json (with .prev
    rotation) write the JAX package's bytes for the same value (the
    port's Op and KVTuple where the JAX package has its own)."""
    v = VALUES[name]
    jv = {k: (jhist.Op.from_dict(x.to_dict()) if isinstance(x, thist.Op)
              else jind.KVTuple(*x) if isinstance(x, independent.KVTuple)
              else x) for k, x in v.items()}
    for pkg, val, sub in ((store, v, "t"), (jstore, jv, "j")):
        monkeypatch.chdir(tmp_path)
        os.makedirs(sub, exist_ok=True)
        monkeypatch.chdir(tmp_path / sub)
        pkg.write_edn(store_map(), ["a", "results.edn"], val)
        pkg.atomic_write_json("ckpt.json", {"round": 1})
        pkg.atomic_write_json("ckpt.json", val, rotate_prev=True)
    assert tree(tmp_path / "t") == tree(tmp_path / "j")
    assert os.path.exists(tmp_path / "t" / "ckpt.json.prev")
    assert store.read_json_dict(str(tmp_path / "t" / "ckpt.json.prev")) \
        == {"round": 1}


def test_time_str_and_paths_match_jax():
    import datetime

    t = datetime.datetime(2026, 3, 4, 5, 6, 7, 891011)
    assert store.time_str(t) == jstore.time_str(t) == "20260304T050607.891"
    m = store_map()
    assert store.path(m, ["independent", 3], None, "x.svg") == jstore.path(
        m, ["independent", 3], None, "x.svg")
    assert store.nonserializable_keys({"_j": 1, "nonserializable_keys":
                                       ["z"]}) == jstore.nonserializable_keys(
        {"_j": 1, "nonserializable_keys": ["z"]})


def test_history_files_and_tensor_round_trip(tmp_path, monkeypatch):
    """write_history (history.txt, history.jsonl, history.npz) gives the
    JAX package's text files and arrays; each package's npz decodes in
    the other to the same ops."""
    hist = keyed_history(3, 6, n_process=2, bad_every=0, seed=1)
    ops = [o.with_(value=o.value.value if isinstance(
        o.value, independent.KVTuple) else o.value) for o in hist]
    ops.append(thist.Op("nemesis", "info", "start", {"part": [1]}, time=9,
                        index=len(ops)))
    jops = [jhist.Op.from_dict(o.to_dict()) for o in ops]
    for pkg, h, sub in ((store, ops, "t"), (jstore, jops, "j")):
        monkeypatch.chdir(tmp_path)
        os.makedirs(sub, exist_ok=True)
        monkeypatch.chdir(tmp_path / sub)
        pkg.write_history(store_map(history=h, schema=(
            thist.REGISTER_SCHEMA if pkg is store else jhist.REGISTER_SCHEMA)))
    d = os.path.join("store", NAME, START)
    for f in ("history.txt", "history.jsonl"):
        assert filecmp.cmp(tmp_path / "t" / d / f, tmp_path / "j" / d / f,
                           shallow=False)
    th = thist.TensorHistory.load(str(tmp_path / "j" / d / "history.npz"))
    jh = jhist.TensorHistory.load(str(tmp_path / "t" / d / "history.npz"))
    for col in ("process", "type", "f", "value", "time", "index"):
        assert np.array_equal(getattr(th, col), getattr(jh, col))
    assert [o.to_dict() for o in th.decode()] == [
        o.to_dict() for o in jh.decode()]
    assert [o.to_dict() for o in th.decode()] == [o.to_dict() for o in ops]
    monkeypatch.chdir(tmp_path / "t")
    loaded = store.load(NAME, START, store_dir="store")
    assert [o.to_dict() for o in loaded["history"]] == normalise(
        [o.to_dict() for o in ops])  # history.jsonl: cas tuples as lists


def test_wal_and_follow_on_torn_tail(tmp_path, monkeypatch):
    """HistoryWAL lines are the JAX package's; a torn tail is dropped and
    terminated by the next session, and follow_wal / load_wal_history
    give the same ops in both packages."""
    ops = [thist.Op(p % 2, t, "write", p, time=p) for p, t in
           enumerate(["invoke", "ok", "invoke", "info"])]
    for pkg, sub in ((store, "t"), (jstore, "j")):
        monkeypatch.chdir(tmp_path)
        os.makedirs(sub, exist_ok=True)
        monkeypatch.chdir(tmp_path / sub)
        mk = (lambda o: o) if pkg is store else (
            lambda o: jhist.Op.from_dict(o.to_dict()))
        w = pkg.HistoryWAL(store_map(), fsync="close")
        for o in ops[:3]:
            w.append(mk(o))
        w.close()
        with open(pkg.path(store_map(), pkg.WAL_FILE), "a") as fh:
            fh.write('{"process": 1, "type": "ok", "f": "wr')  # torn
        w = pkg.HistoryWAL(store_map())
        assert w.epoch == 1
        w.append(mk(ops[3]))
        w.close()
    wal = os.path.join("store", NAME, START, store.WAL_FILE)
    assert filecmp.cmp(tmp_path / "t" / wal, tmp_path / "j" / wal,
                       shallow=False)
    tw = [o.to_dict() for o in store.follow_wal(str(tmp_path / "j" / wal))]
    jw = [o.to_dict() for o in jstore.follow_wal(str(tmp_path / "t" / wal))]
    assert tw == jw and len(tw) == 4
    assert [o["index"] for o in tw] == [0, 1, 2, 3]
    monkeypatch.chdir(tmp_path / "t")
    assert [o.to_dict() for o in store.load_wal_history(store_map())] == tw


def test_journal_reads_across_packages(tmp_path):
    """A journal written by either package reads in the other: the same
    entries, the same skip set; a torn tail line is dropped."""
    m = {"name": NAME, "start_time": START, "store_dir": str(tmp_path)}
    p = os.path.join(str(tmp_path), "j.jsonl")
    jj = jstore.AnalysisJournal(m, path=p)
    jj.record("independent-key", "1#4#ab", {"valid": True, "k": (1, 2)})
    jj.record("closure", "cd", {"n": 2, "bits": "c0"})
    jj.close()
    with open(p, "a") as fh:
        fh.write('{"kind": "independent-key", "key": "2#')
    tj = store.AnalysisJournal(m, path=p)
    assert len(tj) == 2
    assert tj.get("independent-key", "1#4#ab") == {"valid": True,
                                                   "k": [1, 2]}
    assert tj.contains("closure", "cd") and not tj.contains("closure", "x")
    tj.record("closure", "ef", {"n": 1, "bits": "80"})
    tj.close()
    back = jstore.AnalysisJournal(m, path=p)
    assert len(back) == 3 and back.get("closure", "ef") == {"n": 1,
                                                            "bits": "80"}
    back.close()
    assert tj.path == p


def _run(pkg_store, chk, hist, journal=True):
    m = store_map()
    if journal:
        m["_analysis_journal"] = pkg_store.AnalysisJournal(m)
    r = chk.check(m, hist, {})
    if journal:
        m["_analysis_journal"].close()
    return r


def test_register_artifacts_match_jax(tmp_path, monkeypatch):
    """64 keys through both packages' independent.checker(linearizable(
    m, "auto")) (the port on the CPU) with a store dir and a journal:
    identical file trees (results.edn and history.txt for every key,
    linear.svg for every invalid key, the journal lines). A second run
    with either package's journal checks no key and gives run 1's
    dict."""
    hist = keyed_history(64, 8, n_process=3, bad_every=8, seed=4)
    jh = jax_ops(hist)
    tchk = independent.checker(linearizable(tmodels.CASRegister(),
                                            device="cpu"))
    jchk = jind.checker(jlinearizable(jmodels.CASRegister()))
    monkeypatch.chdir(tmp_path)
    os.makedirs("t")
    os.makedirs("j")
    monkeypatch.chdir(tmp_path / "t")
    tr = _run(store, tchk, hist)
    monkeypatch.chdir(tmp_path / "j")
    jr = _run(jstore, jchk, jh)
    assert normalise(tr) == normalise(jr)
    assert tr["valid"] is False and len(tr["failures"]) == 8
    tt, jt = tree(tmp_path / "t"), tree(tmp_path / "j")
    assert tt == jt
    svgs = [p for p in tt if p.endswith("linear.svg")]
    assert len(svgs) == 8
    assert sum(p.endswith("results.edn") for p in tt) == 64
    assert sum(p.endswith("history.txt") for p in tt) == 64

    def no_check(*a, **kw):
        raise AssertionError("a journaled key was checked again")

    for pkg, chk, h, sub, first in ((store, tchk, hist, "j", tr),
                                    (jstore, jchk, jh, "t", jr)):
        # each package resumes from the OTHER package's journal
        monkeypatch.chdir(tmp_path / sub)
        monkeypatch.setattr(chk.checker, "check_batch", no_check)
        monkeypatch.setattr(chk.checker, "check", no_check)
        again = _run(pkg, chk, h)
        assert normalise(again) == normalise(first)
    assert tree(tmp_path / "t") == tt  # nothing rewritten


def test_cycle_journal_and_timeline_match_jax(tmp_path, monkeypatch):
    """A list-append history with injected cycles, checked with a journal
    in both packages (the port's plain closures on the CPU, the JAX
    package's host engine): identical timeline-cycle.html and journal
    lines; a second check with the journal launches no closure."""
    # times 2 ms apart, so every op gets a box of the timeline
    th = [o.with_(time=2_000_000 * i) for i, o in enumerate(
        list_append.simulate(120, seed=3, inject=("G1c", "G-single")))]
    jh = [o.with_(time=2_000_000 * i) for i, o in enumerate(
        jla.simulate(120, seed=3, inject=("G1c", "G-single")))]
    assert [o.to_dict() for o in th] == [o.to_dict() for o in jh]
    tchk = cycle.checker(device="cpu")
    jchk = jcycle.checker(engine="host")
    calls = []
    real = closure.closure_block

    def counted(words0, p):
        calls.append(p)
        return real(words0, p)

    monkeypatch.setattr(closure, "closure_block", counted)
    monkeypatch.chdir(tmp_path)
    os.makedirs("t")
    os.makedirs("j")
    results = {}
    for pkg, chk, h, sub in ((store, tchk, th, "t"), (jstore, jchk, jh, "j")):
        monkeypatch.chdir(tmp_path / sub)
        results[sub] = _run(pkg, chk, h)
    assert normalise(results["t"]) == normalise(results["j"])
    assert results["t"]["anomaly-types"] == ["G1c", "G-single"]
    assert calls
    tt = tree(tmp_path / "t")
    assert tt == tree(tmp_path / "j")
    page = os.path.join("store", NAME, START, "timeline-cycle.html")
    assert page in tt and b'class="witness"' in tt[page]
    journal = tt[os.path.join("store", NAME, START,
                              store.ANALYSIS_CKPT_FILE)].decode()
    assert all(json.loads(ln)["kind"] == "closure"
               for ln in journal.splitlines())
    calls.clear()
    monkeypatch.chdir(tmp_path / "j")  # the JAX package's journal
    again = _run(store, tchk, th)
    assert calls == []
    assert normalise(again) == normalise(results["t"])


def test_classify_journals_closures_before_a_deadline(monkeypatch):
    """Closures completed before the budget ran out are journaled, so a
    retry computes only the rest (the JAX package's resumable
    contract)."""
    h = list_append.simulate(300, seed=1, inject=("G1c",))
    g = cycle.checker(device="cpu").graph(h)

    class Journal(dict):
        def get(self, kind, key):
            return dict.get(self, (kind, key))

        def record(self, kind, key, result):
            self.setdefault((kind, key), result)

    j = Journal()
    real = closure.closure_block
    seen = []

    class Late:
        @staticmethod
        def monotonic():
            return 1e18

    def once_then_late(words0, p):
        seen.append(p)
        monkeypatch.setattr(closure, "time", Late)
        return real(words0, p)

    monkeypatch.setattr(closure, "closure_block", once_then_late)
    with pytest.raises(closure.DeadlineExpired):
        anomalies.classify(g, device="cpu", journal=j, budget=1e17)
    monkeypatch.undo()
    assert len(seen) == 1 and j
    n = len(j)
    full = anomalies.classify(g, device="cpu", journal=j)
    assert len(j) > n
    assert normalise(full) == normalise(anomalies.classify(g, device="cpu"))
