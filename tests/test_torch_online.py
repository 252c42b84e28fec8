"""The port's online checking (jepsen_tpu_torch.online) against the JAX
package's (jepsen_tpu.online) on the same seeded streams: CycleFrontier
and WGLFrontier verdicts on every prefix (the port on device="cpu", the
kernels' plain versions; the JAX package's cycle frontier on its host
engine, its register workload on "auto", which is its native engine on a
host without a TPU, as the port's "auto" is without a card), the EDN
and span-log adapters on the fixture corpus, verdict logs written by one
package and replayed by the other, stream sessions (resume, abort), the
run monitor, the `watch` CLI's lines and exit codes, and the queue
stream client. Every comparison is exact, apart from the JAX package's
supervision telemetry (the port has no supervisor). Also: a kernel
fault inside a frontier advance or the run monitor raises, and is never
read as "unknown"."""

import json
import os
import threading
import time

import pytest

from helpers import random_register_history
from jepsen_tpu import history as jhist
from jepsen_tpu import independent as jind
from jepsen_tpu.checker import cycle as jcycle
from jepsen_tpu.online import CycleFrontier as JCycleFrontier
from jepsen_tpu.online import StreamSession as JStreamSession
from jepsen_tpu.online import VerdictLog as JVerdictLog
from jepsen_tpu.online import WGLFrontier as JWGLFrontier
from jepsen_tpu.online import ingest as jingest
from jepsen_tpu.serve.registry import WORKLOAD_FACTORIES as JWORKLOADS
from jepsen_tpu.workloads import list_append as jla

from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch import independent, store
from jepsen_tpu_torch.checker import cycle
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.device import CudaUnavailable, KernelError
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.online import (CycleFrontier, StreamSession,
                                     VerdictLog, WGLFrontier, ingest)
from jepsen_tpu_torch.online.monitor import RunMonitor
from jepsen_tpu_torch.online.stream import frontier_for
from jepsen_tpu_torch.ops import closure, wgl_vec
from jepsen_tpu_torch.serve.registry import WORKLOAD_FACTORIES
from jepsen_tpu_torch.workloads import list_append

pytestmark = pytest.mark.online

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "edn")
with open(os.path.join(FIXTURES, "expected.json")) as _f:
    EXPECTED = json.load(_f)


def normalise(v):
    """A verdict as JSON carries it (ops by `to_dict`), without the JAX
    package's supervision telemetry."""
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(y) for k, y in x.items() if k != "supervision"}
        if isinstance(x, (list, tuple)):
            return [strip(y) for y in x]
        return x
    return strip(json.loads(json.dumps(
        store._json_keys(v),
        default=lambda o: o.to_dict() if hasattr(o, "to_dict") else str(o))))


def port_ops(jops):
    """The JAX package's Ops (keyed values included) as the port's."""
    out = []
    for o in jops:
        v = o.value
        if isinstance(v, jind.KVTuple):
            v = independent.KVTuple(v.key, v.value)
        out.append(thist.Op.from_dict({**o.to_dict(), "value": v}))
    return out


def sims(n, seed, inject=()):
    """list_append.simulate in both packages: (JAX Ops, port Ops)."""
    jh = jla.simulate(n, seed=seed, inject=inject)
    th = list_append.simulate(n, seed=seed, inject=inject)
    assert [o.to_dict() for o in jh] == [o.to_dict() for o in th]
    return jh, th


def keyed_register_history(keys=4, n_ops=10, corrupt_key=None, seed0=11):
    """The JAX package's test stream (tests/test_online.py): JAX Ops."""
    hist = []
    for k in range(keys):
        for o in random_register_history(
                n_process=3, n_ops=n_ops, n_values=3, cas=True,
                corrupt=(k == corrupt_key), seed=seed0 + k):
            hist.append(o.with_(value=jind.tuple_(k, o.value)))
    return jhist.index(hist)


def doomed(n=120, cut=60, seed=12):
    """A list-append stream with a G1c injected at op `cut` (the JAX
    package's abort fixture): (JAX Ops, port Ops)."""
    jbase, tbase = sims(n, seed)
    jh = list(jbase[:cut])
    jla.inject_g1c(jh, proc=7, key_a=101, key_b=102)
    jh = jhist.index(jh + list(jbase[cut:]))
    th = list(tbase[:cut])
    list_append.inject_g1c(th, proc=7, key_a=101, key_b=102)
    th = thist.index(th + list(tbase[cut:]))
    assert [o.to_dict() for o in jh] == [o.to_dict() for o in th]
    return jh, th


def gpu_vec_register(device="cpu"):
    """independent over linearizable on K1's engine (its plain version
    on the CPU)."""
    return independent.checker(linearizable(
        CASRegister(), algorithm="gpu_vec", device=device))


def kernel_fault(*a, **kw):
    raise KernelError("injected launch failure")


# ---------------------------------------------------------------------------
# CycleFrontier: the port equals the JAX package on every prefix


@pytest.mark.parametrize("seed,inject", [
    (3, ()), (5, ("G1c",)), (9, ("G1c", "G-single")),
])
def test_cycle_frontier_matches_jax_on_every_prefix(seed, inject):
    jh, th = sims(120, seed, inject)
    jf = JCycleFrontier(jcycle.checker(engine="host"))
    chk = cycle.checker(device="cpu")
    tf = CycleFrontier(chk)
    for cut in (1, 7, 30, 64, 65, 100, 120):
        jf.extend(jh[len(jf.ops):cut])
        tf.extend(th[len(tf.ops):cut])
        got = normalise(tf.advance())
        assert got == normalise(jf.advance()), f"prefix {cut}"
        assert got == normalise(chk.check({}, th[:cut], {})), f"prefix {cut}"


def test_cycle_frontier_unknown_prefix_matches_jax():
    """A prefix that cuts a txn mid-flight (read observed, append not yet
    landed) is uncheckable in both packages, and checkable again once
    the writer lands."""
    rows = [(0, [["append", 1, 10]]), (1, [["r", 1, [10, 11]]]),
            (2, [["append", 1, 11]])]
    jh = jhist.index([jhist.ok_op(p, "txn", v) for p, v in rows])
    th = thist.index([thist.ok_op(p, "txn", v) for p, v in rows])
    jf = JCycleFrontier(jcycle.checker(engine="host"))
    tf = CycleFrontier(cycle.checker(device="cpu"))
    for cut in (1, 2, 3):
        jf.extend(jh[len(jf.ops):cut])
        tf.extend(th[len(tf.ops):cut])
        assert normalise(tf.advance()) == normalise(jf.advance()), cut
    assert tf.verdict["valid"] is True


def test_cycle_frontier_reuses_clean_component_closures(monkeypatch):
    """Only dirty weakly-connected components are closed again: ops that
    touch fresh keys do not resubmit the untouched components' jobs."""
    from jepsen_tpu_torch.checker.cycle import anomalies

    def shift_keys(h, off):
        return [o.with_(value=[[m[0], m[1] + off, m[2]] for m in o.value])
                for o in h]

    h1 = list_append.simulate(60, seed=4)
    h2 = shift_keys(list_append.simulate(60, seed=5), 1000)
    h = thist.index(list(h1) + list(h2))
    sizes = []
    real = anomalies._closures

    def counting(mats, **kw):
        sizes.append(len(mats))
        return real(mats, **kw)

    monkeypatch.setattr(anomalies, "_closures", counting)
    f = CycleFrontier(cycle.checker(device="cpu"))
    f.extend(h[:len(h1)])
    f.advance()
    first = sum(sizes)
    del sizes[:]
    f.extend(h[len(h1):])
    f.advance()
    second = sum(sizes)
    del sizes[:]
    cold = CycleFrontier(cycle.checker(device="cpu"))
    cold.extend(h)
    cold.advance()
    assert first > 0 and second < sum(sizes)
    assert len(f.memo) > 0


def test_cycle_frontier_memo_survives_via_journal(tmp_path):
    """A journal-backed frontier reloads its closure memo across process
    lifetimes (a fresh frontier over the same journal path), with the
    same verdict and no closure launched."""
    _, h = sims(80, 6, ("G1c",))
    jp = str(tmp_path / "analysis.ckpt.jsonl")
    j1 = store.AnalysisJournal(None, path=jp)
    f1 = CycleFrontier(cycle.checker(device="cpu"), journal=j1)
    f1.extend(h)
    v1 = f1.advance()
    j1.close()
    j2 = store.AnalysisJournal(None, path=jp)
    assert len(j2) > 0
    f2 = CycleFrontier(cycle.checker(device="cpu"), journal=j2)
    f2.extend(h)
    closure.CAPTURE = []
    try:
        v2 = f2.advance()
        assert closure.CAPTURE == []
    finally:
        closure.CAPTURE = None
        j2.close()
    assert normalise(v1) == normalise(v2)


def test_cycle_frontier_kernel_fault_raises(monkeypatch):
    """A closure kernel that fails to launch raises from advance(): the
    frontier never reads it as "unknown"."""
    _, h = sims(60, 3)
    monkeypatch.setattr(closure, "reach_batch", kernel_fault)
    f = CycleFrontier(cycle.checker(device="cpu"))
    f.extend(h)
    with pytest.raises(KernelError):
        f.advance()


def test_cycle_frontier_default_device_is_the_card():
    """cycle.checker() runs on the card: without CUDA, advance raises."""
    _, h = sims(40, 3)
    f = CycleFrontier()
    f.extend(h)
    with pytest.raises(CudaUnavailable):
        f.advance()


# ---------------------------------------------------------------------------
# WGLFrontier: the port equals the JAX package on every prefix


def test_wgl_frontier_matches_jax_on_every_prefix():
    jh = keyed_register_history(keys=4, corrupt_key=2)
    th = port_ops(jh)
    jchk = JWORKLOADS["register"]()["checker"]
    chk = WORKLOAD_FACTORIES["register"](device="cpu")["checker"]
    test = {"name": "stream-parity"}
    jf = JWGLFrontier(jchk, test=test)
    tf = WGLFrontier(chk, test=test)
    for cut in (9, 25, 48, len(th)):
        jf.extend(jh[len(jf.ops):cut])
        tf.extend(th[len(tf.ops):cut])
        got = normalise(tf.advance())
        assert got == normalise(jf.advance()), f"prefix {cut}"
        assert got == normalise(chk.check(test, th[:cut], {})), \
            f"prefix {cut}"
    assert tf.verdict["valid"] is False
    assert tf.verdict["failures"] == [2]


def test_wgl_frontier_on_k1_matches_one_shot():
    """With "auto" steered to the card engines (every bar 1, the card
    present), each window's dirty keys go to K1 (its plain version here)
    and every prefix's verdict equals a one-shot check of that prefix."""
    import importlib

    lin = importlib.import_module("jepsen_tpu_torch.checker.linearizable")
    jh = keyed_register_history(keys=3, n_ops=12, corrupt_key=1, seed0=5)
    th = port_ops(jh)
    chk = WORKLOAD_FACTORIES["register"](device="cpu")["checker"]
    f = WGLFrontier(chk)
    saved = lin._card_present, lin.GPU_BATCH_MIN
    lin._card_present = lambda device: True
    lin.GPU_BATCH_MIN = {k: 1 for k in lin.GPU_BATCH_MIN}
    wgl_vec.CAPTURE = []
    try:
        for cut in (20, 41, len(th)):
            f.extend(th[len(f.ops):cut])
            assert normalise(f.advance()) == \
                normalise(chk.check({}, th[:cut], {})), cut
        assert wgl_vec.CAPTURE
    finally:
        wgl_vec.CAPTURE = None
        lin._card_present, lin.GPU_BATCH_MIN = saved
    assert f.verdict["failures"] == [1]


def test_wgl_frontier_rechecks_only_dirty_keys():
    th = port_ops(keyed_register_history(keys=3))
    sub0 = [o for o in th if independent.is_tuple(o.value)
            and o.value.key == 0]
    held_back = sub0[-4:]
    first = [o for o in th if o not in held_back]
    chk = WORKLOAD_FACTORIES["register"](device="cpu")["checker"]
    f = WGLFrontier(chk, test={"name": "dirty"})
    f.extend(first)
    f.advance()
    checked = []
    orig = f._check

    def spy(todo):
        checked.extend(k for k, *_ in todo)
        return orig(todo)

    f._check = spy
    f.extend(held_back)
    f.advance()
    assert checked == [0]


def torch_error(*a, **kw):
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


@pytest.mark.parametrize("keys,fault", [
    (1, kernel_fault), (3, kernel_fault), (1, torch_error), (3, torch_error),
], ids=["one-key", "batched", "one-key-torch-error", "batched-torch-error"])
def test_wgl_frontier_kernel_fault_raises(monkeypatch, keys, fault):
    """A K1 launch that fails, or a CUDA error torch raises at a sync,
    raises from advance(), through check_batch (several dirty keys: any
    exception, as IndependentChecker's batched call) and through
    check_safe (one key: checker.is_fault): no per-key fallback reads
    the fault as "unknown"."""
    th = port_ops(keyed_register_history(keys=keys))
    monkeypatch.setattr(wgl_vec, "search", fault)
    f = WGLFrontier(gpu_vec_register())
    f.extend(th)
    with pytest.raises((KernelError, RuntimeError)) as ei:
        f.advance()
    assert "illegal" in str(ei.value) or isinstance(ei.value, KernelError)
    assert f.verdict is None


def test_wgl_frontier_window_budget_retries_expired_keys():
    """A window budget that has already passed comes back "unknown:
    deadline" for every key (K1's engine checks the budget before its
    launch), which stays dirty and is checked again at the next
    advance."""
    th = port_ops(keyed_register_history(keys=2))
    chk = gpu_vec_register()
    f = WGLFrontier(chk, window_budget_s=-1.0)
    f.extend(th)
    v = f.advance()
    assert v["valid"] == "unknown"
    assert all(r["error"] == "deadline" for r in v["results"].values())
    f.window_budget_s = None
    assert normalise(f.advance()) == normalise(chk.check({}, th, {}))


def test_frontier_for_dispatch():
    assert isinstance(frontier_for(cycle.checker()), CycleFrontier)
    chk = WORKLOAD_FACTORIES["register"](device="cpu")["checker"]
    assert isinstance(frontier_for(chk), WGLFrontier)
    assert frontier_for(object()) is None


# ---------------------------------------------------------------------------
# ingest: the EDN and span-log adapters


def test_edn_reader_primitives():
    assert ingest.read_edn("nil") is None
    assert ingest.read_edn("true") is True
    assert ingest.read_edn("-42") == -42
    assert ingest.read_edn("1.5") == 1.5
    assert ingest.read_edn('"a\\"b"') == 'a"b'
    assert ingest.read_edn(":invoke") == "invoke"
    assert ingest.read_edn("[1 2, 3]") == [1, 2, 3]
    assert ingest.read_edn("{:f :txn :value [[:r 1 nil]]}") == \
        {"f": "txn", "value": [["r", 1, None]]}
    assert ingest.read_edn("#{1 2}") == [1, 2]
    assert ingest.read_edn('#inst "2024-01-01"') == "2024-01-01"
    assert ingest.read_edn("#jepsen.history.Op{:index 0}") == {"index": 0}
    assert ingest.read_edn("; comment\n7") == 7
    assert ingest.read_edn_all("1 2 3") == [1, 2, 3]
    with pytest.raises(ingest.EDNError):
        ingest.read_edn("[1 2")


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_edn_fixture_matches_jax_and_expected(name):
    """EDN → WAL schema: the same op dicts as the JAX package's reader;
    the trace's batch verdict on the workload's checker (on the CPU) is
    the fixture's expectation."""
    p = os.path.join(FIXTURES, name)
    with open(p) as f:
        text = f.read()
    assert ingest.edn_ops(text) == jingest.edn_ops(text)
    assert ingest.detect_format(p) == "edn"
    ops = list(ingest.iter_trace(p))
    assert [o.to_dict() for o in ops] == \
        [o.to_dict() for o in jingest.iter_trace(p)]
    exp = EXPECTED[name]
    spec = WORKLOAD_FACTORIES[exp["workload"]](device="cpu")
    if spec["rehydrate"]:
        ops = [spec["rehydrate"](o) for o in ops]
    r = spec["checker"].check({"name": "fixture"}, ops, {})
    assert r["valid"] == exp["valid"]
    assert (r.get("anomaly-types") or []) == exp["anomaly-types"]


SPANS = [
    {"name": "write", "startTimeUnixNano": 100, "endTimeUnixNano": 200,
     "status": {"code": "STATUS_CODE_OK"},
     "attributes": [
         {"key": "jepsen.process", "value": {"intValue": "0"}},
         {"key": "jepsen.value", "value": {"intValue": "3"}}]},
    {"name": "read", "startTimeUnixNano": 300, "endTimeUnixNano": 400,
     "status": {"code": "STATUS_CODE_OK"},
     "attributes": {"jepsen.process": 1, "jepsen.value": None,
                    "jepsen.value.ok": 3}},
    {"name": "read", "startTimeUnixNano": 150, "endTimeUnixNano": 500,
     "status": {"code": "STATUS_CODE_ERROR"},
     "attributes": {"jepsen.process": 2, "jepsen.error": "timeout"}},
    {"name": "cas", "startTimeUnixNano": 600, "endTimeUnixNano": 600,
     "attributes": {"jepsen.value": "[3, 4]"}, "spanId": "s4"},
]


def test_span_ops_match_jax(tmp_path):
    lines = [json.dumps(s) for s in SPANS]
    ops = ingest.span_ops(lines)
    assert ops == jingest.span_ops(lines)
    assert [(o["type"], o["f"]) for o in ops[:6]] == [
        ("invoke", "write"), ("invoke", "read"), ("ok", "write"),
        ("invoke", "read"), ("ok", "read"), ("fail", "read")]
    assert ops[4]["value"] == 3 and ops[5]["error"] == "timeout"
    assert ops[7]["type"] == "info" and ops[7]["value"] == [3, 4]
    p = tmp_path / "trace.jsonl"
    p.write_text("\n".join(lines) + "\n")
    assert ingest.detect_format(str(p)) == "spans"
    assert [o.to_dict() for o in ingest.iter_trace(str(p))] == \
        [o.to_dict() for o in jingest.iter_trace(str(p))]


def test_wal_trace_follows_through_store(tmp_path):
    """A native WAL is read (and tailed) through the port's
    store.follow_wal, indexed 0..n-1."""
    p = tmp_path / store.WAL_FILE
    recs = [{"process": 0, "type": "ok", "f": "txn",
             "value": [["append", 1, i]], "_epoch": 0} for i in range(3)]
    p.write_text("".join(json.dumps(r) + "\n" for r in recs))
    assert ingest.detect_format(str(p)) == "wal"
    stop = threading.Event()
    got = []
    for o in ingest.iter_trace(str(p), follow=True, poll_s=0.005,
                               stop=stop):
        got.append(o)
        if len(got) == 3:
            stop.set()
    assert [o.index for o in got] == [0, 1, 2]
    assert got[2].value == [["append", 1, 2]]


# ---------------------------------------------------------------------------
# Verdict logs and stream sessions


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_verdict_log_replays_across_packages(tmp_path, writer):
    """A verdicts.jsonl one package's session wrote replays in the
    other's: the same boundaries and digests, nothing re-emitted, the
    same final verdict."""
    jh, th = sims(100, 3, ("G1c",))
    path = str(tmp_path / "verdicts.jsonl")

    def jax_session(emitted):
        return JStreamSession(iter(jh), JCycleFrontier(
            jcycle.checker(engine="host")), window=32,
            verdict_log=JVerdictLog(path), emit=emitted.append)

    def port_session(emitted):
        return StreamSession(iter(th), CycleFrontier(
            cycle.checker(device="cpu")), window=32,
            verdict_log=VerdictLog(path), emit=emitted.append)

    first, then = ((jax_session, port_session) if writer == "jax"
                   else (port_session, jax_session))
    emitted, replayed = [], []
    s1 = first(emitted)
    final1 = s1.run()
    s1.verdict_log.close()
    s2 = then(replayed)
    final2 = s2.run()
    s2.verdict_log.close()
    assert [r["prefix"] for r in emitted] == [32, 64, 96, len(th)]
    assert replayed == []
    assert normalise(final2) == normalise(final1)
    assert final1["valid"] is False
    # the replaying session's digests are the writer's
    assert [(p, d) for p, d, _ in VerdictLog(path).entries()] == \
        [(r["prefix"], r["digest"]) for r in emitted]


def test_stream_session_resume_after_partial_run(tmp_path):
    """A session that stops mid-stream leaves a verdict log the resumed
    session extends: the union of emissions is the uninterrupted run's,
    with no duplicate."""
    _, h = sims(120, 8)
    log_path = str(tmp_path / "verdicts.jsonl")
    vlog = VerdictLog(log_path)
    StreamSession(iter(h), CycleFrontier(cycle.checker(device="cpu")),
                  window=24, verdict_log=vlog, max_ops=60).run()
    vlog.close()
    assert [p for p, _, _ in VerdictLog(log_path).entries()] == [24, 48, 60]
    vlog2 = VerdictLog(log_path)
    emitted = []
    StreamSession(iter(h), CycleFrontier(cycle.checker(device="cpu")),
                  window=24, verdict_log=vlog2, emit=emitted.append).run()
    assert [r["prefix"] for r in emitted] == [72, 96, 120]
    assert [p for p, _, _ in vlog2.entries()] == [24, 48, 60, 72, 96, 120]


def test_stream_session_aborts_where_jax_does():
    """An injected mid-stream G1c aborts before the end, at the JAX
    package's prefix, with its verdict, equal to the batch check of that
    prefix."""
    jh, th = doomed(200, 100)
    js = JStreamSession(iter(jh), JCycleFrontier(
        jcycle.checker(engine="host")), window=16, abort_on_invalid=True)
    jfinal = js.run()
    chk = cycle.checker(device="cpu")
    s = StreamSession(iter(th), CycleFrontier(chk), window=16,
                      abort_on_invalid=True)
    final = s.run()
    assert s.aborted and s.consumed < len(th)
    assert s.abort_info == js.abort_info
    assert "G1c" in s.abort_info["anomaly-types"]
    assert normalise(final) == normalise(jfinal)
    assert normalise(final) == normalise(
        chk.check({}, th[:s.abort_info["prefix"]], {}))


# ---------------------------------------------------------------------------
# The run monitor


def live_test(checker, window=16):
    return {"checker": checker,
            "online": {"window": window, "poll_s": 0.005},
            "_history": [], "_history_lock": threading.Lock(),
            "_drain": threading.Event()}


def feed(test, h):
    """Land the ops one by one, as a run does, until the drain gate
    closes."""
    for o in h:
        with test["_history_lock"]:
            test["_history"].append(o)
        if test["_drain"].is_set():
            break
        time.sleep(0.001)


def test_run_monitor_drains_doomed_run():
    _, h = doomed()
    test = live_test(cycle.checker(device="cpu"))
    mon = RunMonitor(test)
    assert mon.supported
    mon.start()
    try:
        feed(test, h)
        assert test["_drain"].wait(timeout=10)
    finally:
        mon.stop()
    assert mon.aborted and test["_preempted_by_monitor"]
    assert "G1c" in test["_online_abort"]["anomaly-types"]
    assert test["_online_abort"]["op-count"] < len(h)


def test_run_monitor_unsupported_checker_is_noop():
    test = live_test(object())
    mon = RunMonitor(test).start()
    mon.stop()
    assert not mon.supported and not mon.aborted


@pytest.mark.parametrize("fault,error", [
    (kernel_fault, KernelError), (torch_error, RuntimeError),
], ids=["kernel-error", "torch-error"])
def test_run_monitor_stop_raises_kernel_fault(monkeypatch, fault, error):
    """A fault of the card inside the monitor's advance (a failed
    launch, or a CUDA error torch raises at a sync) does not vanish: the
    monitor keeps it, does not drain the run, and stop() raises it."""
    monkeypatch.setattr(wgl_vec, "search", fault)
    test = live_test(gpu_vec_register(), window=8)
    mon = RunMonitor(test).start()
    feed(test, port_ops(keyed_register_history(keys=2)))
    mon._thread.join(timeout=10)
    assert not mon._thread.is_alive()
    with pytest.raises(error):
        mon.stop()
    assert not test["_drain"].is_set() and not mon.aborted


def test_run_monitor_ordinary_error_stays_advisory(monkeypatch):
    """An ordinary exception disables the monitor (as in the JAX
    package) and stop() returns."""
    def broken(self):
        raise ValueError("not a fault of the card")

    monkeypatch.setattr(CycleFrontier, "advance", broken)
    _, h = sims(40, 3)
    test = live_test(cycle.checker(device="cpu"), window=8)
    mon = RunMonitor(test).start()
    feed(test, h)
    mon._thread.join(timeout=10)
    mon.stop()
    assert mon.fault is None and not mon.aborted


# ---------------------------------------------------------------------------
# The watch CLI


def run_watch_cli(argv, jax=False):
    if jax:
        from jepsen_tpu.cli import run_cli, watch_cmd
    else:
        from jepsen_tpu_torch.cli import run_cli, watch_cmd
    return run_cli(watch_cmd(), ["watch"] + argv)


def lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_watch_cli_matches_jax(capsys, name):
    """The port's `watch` (on the CPU) prints the JAX package's lines
    (prefix, digest, verdict) and exits with its code: 1 iff the
    fixture is falsified."""
    exp = EXPECTED[name]
    argv = [os.path.join(FIXTURES, name), "--workload", exp["workload"],
            "--window", "16"]
    code = run_watch_cli(argv + ["--device", "cpu"])
    got = lines(capsys)
    assert code == (1 if exp["valid"] is False else 0)
    assert run_watch_cli(argv, jax=True) == code
    assert got and got == lines(capsys)
    assert got[-1]["valid"] == exp["valid"]


def test_watch_cli_state_dir_dedup(tmp_path, capsys):
    p = os.path.join(FIXTURES, "list_append_valid.edn")
    sd = str(tmp_path / "state")
    argv = [p, "--window", "16", "--state-dir", sd, "--device", "cpu"]
    assert run_watch_cli(argv) == 0
    assert lines(capsys)
    assert run_watch_cli(argv) == 0
    assert lines(capsys) == []
    assert os.path.exists(os.path.join(sd, "verdicts.jsonl"))


@pytest.mark.parametrize("argv,code", [
    (["/nonexistent", "--workload", "nope", "--device", "cpu"], 254),
    (["/nonexistent", "--windw", "3"], 254),
    ([os.path.join(FIXTURES, "list_append_valid.edn")], 255),
], ids=["unknown-workload", "bad-option", "no-card"])
def test_watch_cli_error_codes(argv, code):
    """A CLI error exits 254; the default device without a card is an
    internal error (255), never a verdict."""
    assert run_watch_cli(argv) == code


# ---------------------------------------------------------------------------
# The queue stream client


def test_queue_stream_client_packs_windows(tmp_path):
    from jepsen_tpu_torch.online.client import QueueStreamClient
    from jepsen_tpu_torch.serve.queue import DurableQueue

    hist = port_ops(keyed_register_history(keys=3, n_ops=8, corrupt_key=1))
    q = DurableQueue(str(tmp_path / "queue"))
    c = QueueStreamClient(q, "stream-a", "register", window=24)
    ids = c.stream(iter(hist))
    assert len(ids) == (len(hist) + 23) // 24
    assert c.consumed == len(hist)
    # drain the queue the daemon's way: rehydrate + pack_check
    spec = WORKLOAD_FACTORIES["register"](device="cpu")
    batch = q.take_batch()
    assert [j["id"] for j in batch] == ids
    jobs = [[spec["rehydrate"](thist.op(d)) for d in j["history"]]
            for j in batch]
    for j, v in zip(batch, independent.pack_check(
            spec["checker"], {"name": "q"}, jobs)):
        q.commit(j["id"], v)
    final = c.final_verdict(timeout=5)
    one_shot = spec["checker"].check({"name": "q"}, jobs[-1], {})
    assert normalise(final) == normalise(one_shot)
    assert final["valid"] is False and final["failures"] == [1]


def test_queue_stream_client_absorbs_queue_full(monkeypatch):
    from jepsen_tpu_torch.online import client as client_mod
    from jepsen_tpu_torch.serve.queue import QueueFull

    class RejectingQueue:
        def __init__(self, rejections):
            self.left = rejections
            self.submits = 0

        def submit(self, client, workload, history, weight=1, **kw):
            if self.left > 0:
                self.left -= 1
                raise QueueFull(pending=256, retry_after_s=2.0)
            self.submits += 1
            return f"job-{self.submits}"

    def backoffs(seed):
        slept = []
        monkeypatch.setattr(client_mod.time, "sleep", slept.append)
        c = client_mod.QueueStreamClient(
            RejectingQueue(3), "s", window=4, backoff_base_s=0.5,
            backoff_cap_s=8.0, seed=seed)
        assert c.submit_prefix([{"process": 0, "type": "invoke",
                                 "f": "read", "value": None}]) == "job-1"
        assert c.backoffs == 3
        return slept

    slept = backoffs(7)
    for i, d in enumerate(slept):
        base = min(8.0, max(2.0, 0.5 * (2 ** i)))
        assert base <= d < base * 1.5
    assert backoffs(7) == slept
