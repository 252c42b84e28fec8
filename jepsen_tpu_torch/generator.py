"""Op-scheduling DSL (reference: jepsen.generator, generator.clj).

A generator is asked for operations by worker threads: `op(test, process)`
returns an op dict (at minimum {"f": ..., "value": ...}) or None when
exhausted. Generators are shared, stateful, and thread-safe; blocking
inside op() is how time-based scheduling works (delays, staggering,
barriers) — exactly the reference's execution model (generator.clj:27-28).

Literal coercions (generator.clj:41-54): None is the void generator; a
dict emits itself forever; a callable is invoked as f(test, process) or
f(). Use once()/limit()/time_limit() to bound anything.

Thread routing: the dynamic *threads* binding (generator.clj:56-63) is a
per-worker-thread value set by the engine via with_threads(); on/reserve
and independent.concurrent_generator rebind it for sub-generators so
barriers synchronize over exactly the threads that can reach them.

The port's copy of `jepsen_tpu/generator.py`: it imports nothing of
`jepsen_tpu`.
"""

from __future__ import annotations

import inspect
import random
import threading
import time as _time
import weakref
from typing import Callable, Iterable, Sequence

from .history import Op

NEMESIS = "nemesis"

_local = threading.local()


def current_threads():
    """The ordered collection of threads executing the current generator
    (generator.clj *threads*)."""
    return getattr(_local, "threads", None)


class _ThreadsBinding:
    def __init__(self, threads):
        self.threads = list(threads) if threads is not None else None

    def __enter__(self):
        self.prev = getattr(_local, "threads", None)
        _local.threads = self.threads
        return self

    def __exit__(self, *exc):
        _local.threads = self.prev


def with_threads(threads):
    """Context manager binding *threads* (generator.clj:66-72)."""
    return _ThreadsBinding(threads)


def process_to_thread(test, process):
    """process -> thread id: integers wrap mod concurrency; names (e.g.
    "nemesis") pass through (generator.clj:74-79)."""
    if isinstance(process, int):
        return process % test["concurrency"]
    return process


def process_to_node(test, process):
    """The node this process is likely talking to (generator.clj:81-88)."""
    thread = process_to_thread(test, process)
    if isinstance(thread, int):
        nodes = test["nodes"]
        return nodes[thread % len(nodes)]
    return None


class Generator:
    def op(self, test, process):
        raise NotImplementedError


class Void(Generator):
    def op(self, test, process):
        return None


void = Void()


class Repeat(Generator):
    """A literal op emitted forever (the reference's Object impl,
    generator.clj:45-46)."""

    def __init__(self, op_map: dict):
        self.op_map = dict(op_map)

    def op(self, test, process):
        return dict(self.op_map)


class FnGen(Generator):
    """Callables generate ops as f(test, process) or f() — arity decided
    by signature inspection at wrap time so a TypeError raised *inside*
    the function propagates instead of triggering a masking retry
    (generator.clj:48-54)."""

    def __init__(self, f: Callable):
        self.f = f
        try:
            sig = inspect.signature(f)
            self.two_arg = len(sig.parameters) >= 2 or any(
                p.kind == inspect.Parameter.VAR_POSITIONAL
                for p in sig.parameters.values()
            )
        except (TypeError, ValueError):
            self.two_arg = True

    def op(self, test, process):
        return self.f(test, process) if self.two_arg else self.f()


def to_gen(x) -> Generator:
    """Coerce literals to generators (generator.clj:41-54)."""
    if x is None:
        return void
    if isinstance(x, Generator):
        return x
    if isinstance(x, dict):
        return Repeat(x)
    if isinstance(x, Op):
        return Repeat(x.to_dict())
    if callable(x):
        return FnGen(x)
    raise TypeError(f"can't coerce {x!r} to a generator")


def op(gen, test, process):
    return to_gen(gen).op(test, process)


class InvalidOp(Exception):
    pass


def op_and_validate(gen, test, process):
    """op(), validating the result is None or a dict
    (generator.clj:30-39)."""
    o = op(gen, test, process)
    if o is not None and not isinstance(o, dict):
        raise InvalidOp(f"generator {gen!r} yielded invalid op {o!r}")
    return o


# ---------------------------------------------------------------------------
# Combinators

class FMap(Generator):
    """Replace op :f values via a mapping (generator.clj:142-155)."""

    def __init__(self, f_map, gen):
        self.f_map = f_map
        self.gen = to_gen(gen)

    def op(self, test, process):
        o = self.gen.op(test, process)
        if o is None:
            return None
        o = dict(o)
        f = o.get("f")
        o["f"] = self.f_map(f) if callable(self.f_map) else self.f_map.get(f, f)
        return o


def f_map(mapping, gen) -> FMap:
    return FMap(mapping, gen)


class DelayFn(Generator):
    """Each op takes f() extra seconds (generator.clj:176-190)."""

    def __init__(self, f, gen):
        self.f = f
        self.gen = to_gen(gen)

    def op(self, test, process):
        _time.sleep(self.f())
        return self.gen.op(test, process)


def delay_fn(f, gen) -> DelayFn:
    return DelayFn(f, gen)


def delay(dt, gen) -> DelayFn:
    assert dt > 0
    return DelayFn(lambda: dt, gen)


def sleep(dt) -> DelayFn:
    """Sleeps dt seconds, then yields None (generator.clj:197-200)."""
    return delay(dt, void)


def stagger(dt, gen) -> DelayFn:
    """Uniform random delay in [0, 2*dt) — mean dt — before each op
    (generator.clj:202-207)."""
    assert dt > 0
    return DelayFn(lambda: random.random() * 2 * dt, gen)


class DelayTil(Generator):
    """Emit ops as close as possible to multiples of dt seconds from an
    epoch — aligned invocations provoke races (generator.clj:209-234)."""

    def __init__(self, dt, gen, precache=True):
        self.dt = dt
        self.gen = to_gen(gen)
        self.precache = precache
        self.anchor = _time.monotonic()

    def _sleep_til_tick(self):
        now = _time.monotonic()
        tick = now + (self.dt - ((now - self.anchor) % self.dt))
        while True:
            remaining = tick - _time.monotonic()
            if remaining <= 1e-5:
                return
            _time.sleep(remaining)

    def op(self, test, process):
        if self.precache:
            o = self.gen.op(test, process)
            self._sleep_til_tick()
            return o
        self._sleep_til_tick()
        return self.gen.op(test, process)


def delay_til(dt, gen, precache=True) -> DelayTil:
    return DelayTil(dt, gen, precache)


class Once(Generator):
    """Invoke the underlying generator only once, globally
    (generator.clj:236-246)."""

    def __init__(self, gen):
        self.gen = to_gen(gen)
        self._emitted = False
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            if self._emitted:
                return None
            self._emitted = True
        return self.gen.op(test, process)


def once(gen) -> Once:
    return Once(gen)


class Derefer(Generator):
    """Deref a thunk to a generator on every op request — build the
    generator *later* (generator.clj:248-264)."""

    def __init__(self, thunk):
        self.thunk = thunk

    def op(self, test, process):
        return to_gen(self.thunk()).op(test, process)


def derefer(thunk) -> Derefer:
    return Derefer(thunk)


class LogGen(Generator):
    def __init__(self, msg):
        self.msg = msg

    def op(self, test, process):
        import logging

        logging.getLogger("jepsen_tpu_torch").info(self.msg)
        return None


def log_star(msg) -> LogGen:
    return LogGen(msg)


def log(msg) -> Once:
    return once(LogGen(msg))


class Each(Generator):
    """A fresh copy of the underlying generator per process
    (generator.clj:283-306)."""

    def __init__(self, gen_fn):
        self.gen_fn = gen_fn
        self._gens: dict = {}
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            gen = self._gens.get(process)
            if gen is None:
                gen = to_gen(self.gen_fn())
                self._gens[process] = gen
        return gen.op(test, process)


def each(gen_fn) -> Each:
    return Each(gen_fn)


class SeqGen(Generator):
    """One op from each element in turn; a None op advances immediately;
    exhausted when the (possibly infinite) sequence ends
    (generator.clj:308-325)."""

    def __init__(self, coll: Iterable):
        self._it = iter(coll)
        self._lock = threading.Lock()
        self._done = False
        # draws so far — snapshot/restore replays this many next() calls
        # on a freshly-built identical iterator (drawing must therefore
        # be side-effect-free: elements act only when op() is called)
        self._n = 0

    def op(self, test, process):
        while True:
            with self._lock:
                if self._done:
                    return None
                try:
                    gen = next(self._it)
                    self._n += 1
                except StopIteration:
                    self._done = True
                    return None
            o = to_gen(gen).op(test, process)
            if o is not None:
                return o


def seq(coll) -> SeqGen:
    return SeqGen(coll)


def start_stop(t1, t2) -> SeqGen:
    """start after t1 seconds, stop after t2, forever
    (generator.clj:327-335)."""

    def cycle():
        while True:
            yield sleep(t1)
            yield {"type": "info", "f": "start"}
            yield sleep(t2)
            yield {"type": "info", "f": "stop"}

    return SeqGen(cycle())


class Mix(Generator):
    """Uniform random choice between generators (generator.clj:337-349).

    The draw happens inside op(), so a slow member (e.g. a delay/
    stagger wrapper that sleeps before yielding) blocks the calling
    worker and starves its siblings' share of a bounded time window.
    The reference has the same hazard — its mix also dispatches to the
    chosen generator synchronously — and we keep the semantics for
    parity; pace members with short intervals when mixing them under
    time_limit."""

    def __init__(self, gens: Sequence, rng: random.Random | None = None):
        self.gens = [to_gen(g) for g in gens]
        # seeded rng => reproducible interleaving (fault schedules)
        self.rng = rng or random

    def op(self, test, process):
        if not self.gens:
            return None
        return self.rng.choice(self.gens).op(test, process)


def mix(gens, rng: random.Random | None = None) -> Generator:
    return Mix(gens, rng=rng) if gens else void


class CasGen(Generator):
    """Random read/write/cas ops over a small integer field
    (generator.clj:352-365)."""

    def op(self, test, process):
        r = random.random()
        if r < 0.34:
            return {"type": "invoke", "f": "read", "value": None}
        if r < 0.67:
            return {"type": "invoke", "f": "write", "value": random.randrange(5)}
        return {
            "type": "invoke",
            "f": "cas",
            "value": (random.randrange(5), random.randrange(5)),
        }


cas = CasGen()


class QueueGen(Generator):
    """Random enqueue (consecutive ints) / dequeue mix
    (generator.clj:367-378)."""

    def __init__(self):
        self._i = -1
        self._lock = threading.Lock()

    def op(self, test, process):
        if random.random() < 0.5:
            with self._lock:
                self._i += 1
                v = self._i
            return {"type": "invoke", "f": "enqueue", "value": v}
        return {"type": "invoke", "f": "dequeue", "value": None}


def queue_gen() -> QueueGen:
    return QueueGen()


class DrainQueue(Generator):
    """After gen is exhausted, emit enough dequeues to match every
    attempted enqueue (generator.clj:380-396)."""

    def __init__(self, gen):
        self.gen = to_gen(gen)
        self._outstanding = 0
        self._lock = threading.Lock()

    def op(self, test, process):
        o = self.gen.op(test, process)
        if o is not None:
            if o.get("f") == "enqueue":
                with self._lock:
                    self._outstanding += 1
            return o
        with self._lock:
            self._outstanding -= 1
            remaining = self._outstanding
        if remaining >= 0:
            return {"type": "invoke", "f": "dequeue", "value": None}
        return None


def drain_queue(gen) -> DrainQueue:
    return DrainQueue(gen)


class Limit(Generator):
    """At most n ops, across all processes (generator.clj:398-407)."""

    def __init__(self, n, gen):
        self.gen = to_gen(gen)
        self._remaining = n
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            if self._remaining <= 0:
                return None
            self._remaining -= 1
        return self.gen.op(test, process)


def limit(n, gen) -> Limit:
    return Limit(n, gen)


DEADLINE_KEY = "_deadline"


class TimeLimit(Generator):
    """Ops until dt seconds after the first request. The reference bounds
    stuck *completions* too, by interrupting worker threads at the
    deadline (generator.clj:409-524); here every op emitted through the
    time limit carries the deadline (monotonic seconds) under
    DEADLINE_KEY, and the engine bounds that op's invoke wait by it
    (core.ClientWorker._invoke), abandoning the hung call and
    reincarnating the process on expiry. Attaching per-op keeps the bound
    scoped: ops drawn from sibling generators without a time limit are
    never capped by this one."""

    def __init__(self, dt, gen):
        self.dt = dt
        self.gen = to_gen(gen)
        self._deadline = None
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            if self._deadline is None:
                self._deadline = _time.monotonic() + self.dt
            deadline = self._deadline
        if _time.monotonic() >= deadline:
            return None
        r = self.gen.op(test, process)
        if r is None:
            return None
        r = dict(r)  # never mutate shared op literals
        prior = r.get(DEADLINE_KEY)
        r[DEADLINE_KEY] = deadline if prior is None else min(prior, deadline)
        return r


def time_limit(dt, gen) -> TimeLimit:
    return TimeLimit(dt, gen)


class Filter(Generator):
    """Only ops satisfying pred (generator.clj:526-540)."""

    def __init__(self, pred, gen):
        self.pred = pred
        self.gen = to_gen(gen)

    def op(self, test, process):
        while True:
            o = self.gen.op(test, process)
            if o is None:
                return None
            if self.pred(o):
                return o


def filter_gen(pred, gen) -> Filter:
    return Filter(pred, gen)


class On(Generator):
    """Forward to the source only for threads where pred(thread) is true;
    rebinds *threads* to the matching subset (generator.clj:542-552)."""

    def __init__(self, pred, gen):
        self.pred = pred
        self.gen = to_gen(gen)

    def op(self, test, process):
        if not self.pred(process_to_thread(test, process)):
            return None
        ts = current_threads()
        sub = [t for t in ts if self.pred(t)] if ts is not None else None
        with with_threads(sub):
            return self.gen.op(test, process)


def on(pred, gen) -> On:
    return On(pred, gen)


class Reserve(Generator):
    """reserve(n1, gen1, n2, gen2, ..., default): the first n1 threads of
    *threads* use gen1, the next n2 use gen2, ..., the rest use default.
    Rebinds *threads* per range (generator.clj:554-601)."""

    def __init__(self, *args):
        assert args, "reserve needs a default generator"
        *pairs, default = args
        assert len(pairs) % 2 == 0
        self.ranges = []
        lower = 0
        for i in range(0, len(pairs), 2):
            n, gen = pairs[i], pairs[i + 1]
            self.ranges.append((lower, lower + n, to_gen(gen)))
            lower += n
        self.default = to_gen(default)

    def op(self, test, process):
        threads = current_threads()
        if threads is None:
            threads = [NEMESIS] + list(range(test["concurrency"]))
        threads = list(threads)
        thread = process_to_thread(test, process)
        idx = threads.index(thread)
        for lower, upper, gen in self.ranges:
            if idx < upper:
                with with_threads(threads[lower:upper]):
                    return gen.op(test, process)
        lower = self.ranges[-1][1] if self.ranges else 0
        with with_threads(threads[lower:]):
            return self.default.op(test, process)


def reserve(*args) -> Reserve:
    return Reserve(*args)


class Concat(Generator):
    """First non-None op from each source in order, tracked per process
    (generator.clj:603-624)."""

    def __init__(self, *sources):
        self.sources = [to_gen(s) for s in sources]
        self._index: dict = {}
        self._lock = threading.Lock()

    def op(self, test, process):
        while True:
            with self._lock:
                i = self._index.get(process, 0)
            if i >= len(self.sources):
                return None
            o = self.sources[i].op(test, process)
            if o is not None:
                return o
            with self._lock:
                if self._index.get(process, 0) == i:
                    self._index[process] = i + 1


def concat(*sources) -> Concat:
    return Concat(*sources)


def nemesis(nemesis_gen, client_gen=None) -> Generator:
    """Route the nemesis to nemesis_gen; with client_gen, clients get that
    (generator.clj:626-635)."""
    if client_gen is None:
        return on(lambda t: t == NEMESIS, nemesis_gen)
    return concat(
        on(lambda t: t == NEMESIS, nemesis_gen),
        on(lambda t: t != NEMESIS, client_gen),
    )


def clients(client_gen) -> Generator:
    """Execute only on client threads (generator.clj:637-641)."""
    return on(lambda t: t != NEMESIS, client_gen)


class Await(Generator):
    """Block until fn completes (once, under a lock), then delegate
    (generator.clj:643-659)."""

    def __init__(self, f, gen=None):
        self.f = f
        self.gen = to_gen(gen)
        self._state = "waiting"
        self._lock = threading.Lock()

    def op(self, test, process):
        if self._state == "waiting":
            with self._lock:
                if self._state == "waiting":
                    self.f()
                    self._state = "ready"
        return self.gen.op(test, process)


def await_fn(f, gen=None) -> Await:
    return Await(f, gen)


_live_barriers = weakref.WeakSet()


def break_barriers() -> None:
    """Abort every live Synchronize barrier so workers blocked in a
    phases()/synchronize() wait wake up (with BrokenBarrierError) instead
    of deadlocking the run when another worker dies. Called from the
    engine's abort path (the reference interrupts the worker ThreadGroup
    instead, core.clj:232-237)."""
    for b in list(_live_barriers):
        try:
            b.abort()
        except Exception:  # noqa: BLE001
            pass


class Synchronize(Generator):
    """Block until every thread in *threads* is waiting on this generator,
    then proceed; synchronizes once (generator.clj:661-681)."""

    def __init__(self, gen):
        self.gen = to_gen(gen)
        self._barrier = None
        self._cleared = False
        self._lock = threading.Lock()

    def op(self, test, process):
        if not self._cleared:
            with self._lock:
                if self._barrier is None and not self._cleared:
                    threads = current_threads()
                    n = (
                        len(threads)
                        if threads is not None
                        else test["concurrency"] + 1
                    )
                    self._barrier = threading.Barrier(
                        n, action=self._clear
                    )
                    _live_barriers.add(self._barrier)
                barrier = self._barrier
            if barrier is not None and not self._cleared:
                barrier.wait()
        return self.gen.op(test, process)

    def _clear(self):
        self._cleared = True


def synchronize(gen) -> Synchronize:
    return Synchronize(gen)


def phases(*gens) -> Concat:
    """Like concat, but all threads must finish each phase before any
    moves on (generator.clj:683-687)."""
    return concat(*[synchronize(g) for g in gens])


def then(a, b):
    """b, synchronize, then a — backwards for pipeline composition
    (generator.clj:689-693)."""
    return concat(b, synchronize(a))


def barrier(gen):
    """When gen completes, synchronize, then None (generator.clj:700-703)."""
    return then(void, gen)


class SingleThreaded(Generator):
    """Exclusive lock around the underlying generator
    (generator.clj:695-698)."""

    def __init__(self, gen):
        self.gen = to_gen(gen)
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            return self.gen.op(test, process)


def singlethreaded(gen) -> SingleThreaded:
    return SingleThreaded(gen)


# ---------------------------------------------------------------------------
# Preemption: drain gate + checkpoint snapshot/restore

class Interruptible(Generator):
    """A drain gate: delegates until `event` is set, then yields None
    forever. core.prepare wraps the top-level generator in one so a
    SIGTERM (a preemption notice) can stop generation without
    touching workers — every thread sees exhaustion on its next draw
    and in-flight invokes drain through the normal timeout/:info path.
    Stateless, so it's a transparent node in checkpoint snapshots."""

    def __init__(self, gen, event: threading.Event):
        self.gen = to_gen(gen)
        self.event = event

    def op(self, test, process):
        if self.event.is_set():
            return None
        return self.gen.op(test, process)


def interruptible(gen, event: threading.Event) -> Interruptible:
    return Interruptible(gen, event)


def _children(g) -> list:
    """The sub-generators a combinator owns, in a fixed order (the
    snapshot/restore traversal spine)."""
    if isinstance(g, Mix):
        return list(g.gens)
    if isinstance(g, Concat):
        return list(g.sources)
    if isinstance(g, Reserve):
        return [gen for _, _, gen in g.ranges] + [g.default]
    sub = getattr(g, "gen", None)
    return [sub] if isinstance(sub, Generator) else []


def _state_of(g):
    """The JSON-serializable cursor state of one node, or None for
    stateless nodes (and unknown subclasses, which snapshot opaque)."""
    if isinstance(g, Once):
        return {"emitted": g._emitted}
    if isinstance(g, Limit):
        return {"remaining": g._remaining}
    if isinstance(g, TimeLimit):
        if g._deadline is None:
            return {"remaining": None}
        return {"remaining": max(0.0, g._deadline - _time.monotonic())}
    if isinstance(g, SeqGen):
        return {"n": g._n, "done": g._done}
    if isinstance(g, Concat):
        return {"index": [[p, i] for p, i in sorted(
            g._index.items(), key=lambda kv: str(kv[0]))]}
    if isinstance(g, Synchronize):
        return {"cleared": g._cleared}
    if isinstance(g, Mix):
        if isinstance(g.rng, random.Random):
            version, state, gauss = g.rng.getstate()
            return {"rng": [version, list(state), gauss]}
        return None
    if isinstance(g, QueueGen):
        return {"i": g._i}
    if isinstance(g, DrainQueue):
        return {"outstanding": g._outstanding}
    if isinstance(g, Await):
        return {"state": g._state}
    return None


def snapshot(gen) -> dict:
    """A JSON-serializable snapshot of a generator tree's cursors and
    rng states, for store.RunCheckpoint. Reads plain attributes under
    the GIL without taking generator locks, so it's safe from the
    checkpoint thread while workers run — a cursor may be at most one
    draw stale, and resume tolerates that: the WAL is the ground truth
    for which ops actually landed (at-least-once re-emission of the
    final in-flight draw is the documented contract).

    Unknown Generator subclasses become opaque leaves (type name only,
    no children): their state is not captured, and deterministic resume
    requires the schedule to be built from snapshot-aware combinators.
    Mix rng state is captured only for a private random.Random (the
    seeded-package case); the global `random` module is skipped."""
    g = to_gen(gen)
    node: dict = {"t": type(g).__name__}
    s = _state_of(g)
    if s is not None:
        node["s"] = s
    kids = _children(g)
    if kids:
        node["k"] = [snapshot(c) for c in kids]
    return node


def _restore_state(g, s) -> None:
    if s is None:
        return
    if isinstance(g, Once):
        g._emitted = bool(s["emitted"])
    elif isinstance(g, Limit):
        g._remaining = s["remaining"]
    elif isinstance(g, TimeLimit):
        rem = s.get("remaining")
        # remaining budget, not a fresh window: the run continues to
        # its ORIGINAL time limit
        g._deadline = None if rem is None else _time.monotonic() + rem
    elif isinstance(g, SeqGen):
        n = int(s.get("n", 0))
        for _ in range(n):
            try:
                next(g._it)
            except StopIteration:
                g._done = True
                break
        g._n = n
        g._done = g._done or bool(s.get("done"))
    elif isinstance(g, Concat):
        g._index = {p: i for p, i in s.get("index", [])}
    elif isinstance(g, Synchronize):
        g._cleared = bool(s["cleared"])
    elif isinstance(g, Mix):
        rng_s = s.get("rng")
        if rng_s is not None and isinstance(g.rng, random.Random):
            version, state, gauss = rng_s
            g.rng.setstate((version, tuple(state), gauss))
    elif isinstance(g, QueueGen):
        g._i = int(s["i"])
    elif isinstance(g, DrainQueue):
        g._outstanding = int(s["outstanding"])
    elif isinstance(g, Await):
        g._state = s["state"]


def restore(gen, node: dict) -> None:
    """Restore cursors saved by snapshot() into a structurally
    identical, freshly-rebuilt generator tree (same combinators in the
    same shape — i.e. reconstructed from the same seed/opts). SeqGen
    replays its draw count against the fresh iterator; TimeLimit gets
    its REMAINING budget, preserving the original deadline. Raises
    ValueError on any shape/type mismatch rather than silently
    resuming a different schedule."""
    g = to_gen(gen)
    if node.get("t") != type(g).__name__:
        raise ValueError(
            f"checkpoint shape mismatch: saved {node.get('t')!r}, "
            f"rebuilt {type(g).__name__!r}")
    _restore_state(g, node.get("s"))
    kids = _children(g)
    saved = node.get("k") or []
    if len(kids) != len(saved):
        raise ValueError(
            f"checkpoint shape mismatch under {node['t']}: "
            f"{len(saved)} saved children vs {len(kids)} rebuilt")
    for c, n in zip(kids, saved):
        restore(c, n)
