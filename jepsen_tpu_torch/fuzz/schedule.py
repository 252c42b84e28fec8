"""Fixed-shape array encoding of nemesis fault schedules.

A schedule is an int32 array of shape ``[F, 6]`` — ``F`` fault slots,
each ``(family, mask, t0, t1, p0, p1)``:

========  =====================================================
field     meaning
========  =====================================================
family    0 none | 1 partition | 2 clock | 3 kill | 4 pause |
          5 corruption | 6 packet
mask      node bitmask (bit ``n`` = node ``n`` affected)
t0, t1    fault window in txn-slot units, ``0 <= t0 < t1 <= T``
p0, p1    family parameters (see ``canonicalize``)
========  =====================================================

Family parameters:

* partition — unused; the mask IS the grudge (masked nodes are cut
  from unmasked nodes, both directions).
* clock — ``p0``: skew offset in mop-time units, ``[-2L, 2L]``;
  ``p1``: strobe amplitude in mop-time units, ``[0, L]``.
* kill — unused; masked nodes are down for the window (their
  coordinated txns fail; replication to them is redelivered at
  ``t1``).
* pause — ``p0``: split point ``[1, L-1]``; a paused coordinator
  executes mops ``[0, p0)`` at the txn's slot time and defers mops
  ``[p0, L)`` to the window's end.
* corruption — ``p0``: key index; ``p1``: rollback depth window in
  txn-slots ``[1, 8]``. At ``t0`` the masked replicas lose their
  tail of key ``p0``'s log received in the last ``p1`` slots and
  re-converge just after ``t0``.
* packet — ``p0``: drop rate in sixteenths ``[1, 16]``; ``p1``: max
  redelivery delay in txn-slots ``[1, 8]``. Dropped sends to/from
  masked nodes are retransmitted with a seeded delay.

Everything here is host-side numpy + ``random.Random`` (both
platform-stable); the arrays feed ``fuzz.sim`` verbatim. This is the
port's copy of ``jepsen_tpu/fuzz/schedule.py`` (the same schedules from
the same seeds); the rendering of a schedule as a nemesis schedule
document (``to_nemesis_doc``) is not ported.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random

import numpy as np

NONE = 0
PARTITION = 1
CLOCK = 2
KILL = 3
PAUSE = 4
CORRUPT = 5
PACKET = 6

FAMILIES = ("partition", "clock", "kill", "pause", "corruption", "packet")
FAMILY_CODE = {name: i + 1 for i, name in enumerate(FAMILIES)}
CODE_FAMILY = {i + 1: name for i, name in enumerate(FAMILIES)}

FIELDS = ("family", "mask", "t0", "t1", "p0", "p1")

# Bounds shared with fuzz.sim: redelivery / rollback windows never
# exceed MAX_SPAN txn-slots, so audit reads placed after
# 2*T + 2*MAX_SPAN slots observe every delivery.
MAX_SPAN = 8
MAX_SKEW_MOPS = 2  # clock skew bound, in units of L mop-times


@dataclasses.dataclass(frozen=True)
class SimSpec:
    """Static shape of one simulated cluster (compile-time constants)."""

    nodes: int = 5
    keys: int = 8
    txns: int = 24
    mops: int = 4
    faults: int = 8

    @property
    def audits(self) -> int:
        """Final audit read txns: enough read mops to cover every key."""
        return -(-self.keys // self.mops)

    @property
    def slots(self) -> int:
        """Total txn slots simulated: work txns + audit txns."""
        return self.txns + self.audits

    @property
    def audit_t0(self) -> int:
        """Slot time of the first audit txn — after every fault window,
        redelivery, and clock excursion can land."""
        return 2 * self.txns + 2 * MAX_SPAN

    def validate(self):
        if not (1 <= self.nodes <= 16):
            raise ValueError(f"nodes out of range: {self.nodes}")
        if self.mops < 2:
            raise ValueError("need >= 2 mops per txn")
        if self.txns < 2:
            raise ValueError("need >= 2 txn slots")
        if self.keys < 1 or self.faults < 1:
            raise ValueError("keys and faults must be positive")
        return self


DEFAULT_SPEC = SimSpec()


def _mix64(x: int) -> int:
    """splitmix64 finalizer — derive independent integer seeds without
    relying on hash() (PYTHONHASHSEED) or platform word size."""
    x &= 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def derive_seed(seed: int, *salts: int) -> int:
    """Stable sub-seed derivation: pure function of (seed, salts)."""
    x = _mix64(seed ^ 0x6A09E667F3BCC908)
    for s in salts:
        x = _mix64(x ^ _mix64(s ^ 0xBB67AE8584CAA73B))
    return x


def empty_schedule(spec: SimSpec = DEFAULT_SPEC) -> np.ndarray:
    return np.zeros((spec.faults, 6), dtype=np.int32)


def canonicalize(sched: np.ndarray, spec: SimSpec = DEFAULT_SPEC) -> np.ndarray:
    """Clamp a schedule into the legal envelope (idempotent).

    Mutations may push fields out of range; the simulator only accepts
    canonical schedules, so every generator/mutator funnels through
    here. Slots with family NONE or an empty mask are zeroed whole so
    byte-comparison of canonical schedules is meaningful.
    """
    s = np.array(sched, dtype=np.int32, copy=True)
    if s.shape != (spec.faults, 6):
        raise ValueError(f"schedule shape {s.shape} != {(spec.faults, 6)}")
    T, L = spec.txns, spec.mops
    full_mask = (1 << spec.nodes) - 1
    for i in range(spec.faults):
        fam, mask, t0, t1, p0, p1 = (int(v) for v in s[i])
        if fam < NONE or fam > PACKET:
            fam = NONE
        mask &= full_mask
        if fam == NONE or mask == 0:
            s[i] = 0
            continue
        t0 = max(0, min(int(t0), T - 1))
        t1 = max(t0 + 1, min(int(t1), T))
        if fam == PARTITION or fam == KILL:
            p0 = p1 = 0
        elif fam == CLOCK:
            p0 = max(-MAX_SKEW_MOPS * L, min(int(p0), MAX_SKEW_MOPS * L))
            p1 = max(0, min(int(p1), L))
        elif fam == PAUSE:
            p0 = max(1, min(int(p0), L - 1))
            p1 = 0
        elif fam == CORRUPT:
            p0 = int(p0) % spec.keys
            p1 = max(1, min(int(p1), MAX_SPAN))
        elif fam == PACKET:
            p0 = max(1, min(int(p0), 16))
            p1 = max(1, min(int(p1), MAX_SPAN))
        s[i] = (fam, mask, t0, t1, p0, p1)
    return s


def _random_slot(rng: random.Random, spec: SimSpec) -> tuple:
    fam = rng.randint(PARTITION, PACKET)
    mask = rng.randrange(1, 1 << spec.nodes)
    t0 = rng.randrange(spec.txns - 1)
    t1 = t0 + 1 + rng.randrange(max(1, spec.txns // 2))
    p0 = rng.randrange(-2 * spec.mops, 2 * spec.mops + 1)
    p1 = rng.randrange(0, MAX_SPAN + 1)
    return (fam, mask, t0, t1, p0, p1)


def random_schedule(seed: int, spec: SimSpec = DEFAULT_SPEC,
                    families=None) -> np.ndarray:
    """Seeded schedule generation — a pure function of ``seed``.

    ``families`` optionally restricts which fault families may appear
    (names from FAMILIES). Fault count is biased low so single-family
    causes stay attributable, but overlap is common enough to exercise
    fault interactions.
    """
    rng = random.Random(derive_seed(seed, 0x5C4ED))
    allowed = [FAMILY_CODE[f] for f in (families or FAMILIES)]
    sched = empty_schedule(spec)
    n = 1 + min(rng.randrange(spec.faults), rng.randrange(spec.faults))
    for i in range(n):
        slot = list(_random_slot(rng, spec))
        slot[0] = rng.choice(allowed)
        sched[i] = slot
    return canonicalize(sched, spec)


MUTATIONS = ("shift", "widen", "overlap", "retarget", "param", "splice",
             "add", "drop")


def mutate(sched: np.ndarray, seed: int, spec: SimSpec = DEFAULT_SPEC,
           donor: np.ndarray | None = None, families=None) -> np.ndarray:
    """Apply 1–3 seeded mutation operators and re-canonicalize.

    Operators: shift/widen a fault window, force two windows to
    overlap, retarget a node mask, perturb family parameters, splice a
    slot from a donor schedule (grudge splicing), add a fresh fault,
    drop one. A pure function of (sched, seed, donor).
    """
    rng = random.Random(derive_seed(seed, 0x3117A7E))
    s = np.array(sched, dtype=np.int32, copy=True)
    allowed = [FAMILY_CODE[f] for f in (families or FAMILIES)]
    for _ in range(rng.randint(1, 3)):
        active = [i for i in range(spec.faults) if s[i, 0] != NONE]
        op = rng.choice(MUTATIONS)
        if op in ("shift", "widen", "overlap", "retarget", "param",
                  "drop") and not active:
            op = "add"
        if op == "shift":
            i = rng.choice(active)
            d = rng.randint(-spec.txns // 4, spec.txns // 4)
            s[i, 2] += d
            s[i, 3] += d
        elif op == "widen":
            i = rng.choice(active)
            s[i, 2] -= rng.randint(0, spec.txns // 4)
            s[i, 3] += rng.randint(0, spec.txns // 4)
        elif op == "overlap":
            i = rng.choice(active)
            j = rng.choice(active)
            mid = (int(s[i, 2]) + int(s[i, 3])) // 2
            span = max(1, int(s[j, 3]) - int(s[j, 2]))
            s[j, 2] = mid - span // 2
            s[j, 3] = s[j, 2] + span
        elif op == "retarget":
            i = rng.choice(active)
            s[i, 1] = rng.randrange(1, 1 << spec.nodes)
        elif op == "param":
            i = rng.choice(active)
            s[i, rng.choice((4, 5))] += rng.randint(-2, 2)
        elif op == "splice" and donor is not None:
            donor_active = [i for i in range(spec.faults)
                            if donor[i, 0] != NONE]
            if donor_active:
                s[rng.randrange(spec.faults)] = donor[rng.choice(donor_active)]
        elif op == "add":
            free = [i for i in range(spec.faults) if s[i, 0] == NONE]
            i = rng.choice(free) if free else rng.randrange(spec.faults)
            slot = list(_random_slot(rng, spec))
            slot[0] = rng.choice(allowed)
            s[i] = slot
        elif op == "drop":
            s[rng.choice(active)] = 0
    return canonicalize(s, spec)


def fingerprint(sched: np.ndarray, wseed: int) -> str:
    """Content id of one cluster configuration (schedule + workload
    seed) — the corpus dedupe key; stable across processes."""
    h = hashlib.sha1()
    h.update(np.asarray(sched, dtype=np.int32).tobytes())
    h.update(int(wseed).to_bytes(8, "little", signed=False))
    return h.hexdigest()[:16]


def schedule_to_lists(sched: np.ndarray) -> list:
    return [[int(v) for v in row] for row in np.asarray(sched)]


def schedule_from_lists(rows, spec: SimSpec = DEFAULT_SPEC) -> np.ndarray:
    return canonicalize(np.array(rows, dtype=np.int32).reshape(-1, 6), spec)


def families_of(sched: np.ndarray) -> list:
    """Sorted fault-family names present in a schedule."""
    present = {int(f) for f in np.asarray(sched)[:, 0] if int(f) != NONE}
    return [CODE_FAMILY[c] for c in sorted(present)]


def overlap_signature(sched: np.ndarray) -> str:
    """Which fault-family pairs have overlapping windows — a coverage
    feature: fault *interactions* are where the interesting traces
    live, so the corpus keeps one representative per interaction set."""
    s = np.asarray(sched)
    pairs = set()
    active = [i for i in range(s.shape[0]) if int(s[i, 0]) != NONE]
    for a in active:
        for b in active:
            if a >= b:
                continue
            if int(s[a, 2]) < int(s[b, 3]) and int(s[b, 2]) < int(s[a, 3]):
                fa, fb = sorted((int(s[a, 0]), int(s[b, 0])))
                pairs.add((fa, fb))
    return ",".join(f"{a}+{b}" for a, b in sorted(pairs)) or "-"
