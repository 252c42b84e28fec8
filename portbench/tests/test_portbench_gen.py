"""The traffic generator: the shape of jepsen's linearizable-register test,
deterministic from the seed, linearizable unless planted, with its plant
where the traffic mix says."""

from __future__ import annotations

import json
import os

import pytest

from conftest import REPO
from portbench import gen, reference, run

SEEDS = (0, 7, 3_000_000_019, 2**31 + 11)


def keyed(keys=24, seed=0, **kw):
    return gen.linearizable_register(keys, info_rate=0.08, seed=seed, **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_sources_per_key_shape(seed):
    nodes, limit = 5, 128
    h = keyed(seed=seed, nodes=nodes, per_key_limit=limit)
    per_key: dict = {}
    for p, t, f, v, k in h:
        if t == "invoke":
            per_key.setdefault(k, []).append((p, f, v))
    assert sorted(per_key) == list(range(24))
    kinds = {"read": 0, "write": 0, "cas": 0}
    for invs in per_key.values():
        # gen/limit of (rand 0.1 + 0.9) x 128 invocations a key
        assert int(0.9 * limit) <= len(invs) <= limit
        for p, f, v in invs:
            kinds[f] += 1
            # a thread is p mod 2n: the first n only read
            assert (f == "read") == (p % (2 * nodes) < nodes)
            if f == "write":
                assert v in range(5)
            elif f == "cas":
                assert v[0] in range(5) and v[1] in range(5)
            else:
                assert v is None
    # write, cas, cas with equal odds on the other n threads
    assert 1.6 < kinds["cas"] / kinds["write"] < 2.5


def test_a_crashed_process_goes_on_as_a_new_one():
    h = keyed(keys=40, seed=5)
    seen, crashed = set(), set()
    for p, t, f, v, k in h:
        if t == "invoke":
            assert p not in crashed
            if p >= 10:
                assert p - 10 in crashed
            seen.add(p)
        elif t == "info":
            crashed.add(p)
    assert crashed and max(seen) >= 10


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_clean_keys_are_linearizable(seed):
    h = keyed(keys=12, seed=seed)
    for k, (valid, _) in reference.check_history(h).items():
        assert valid is True, k


def test_same_seed_same_pool_other_seed_other_pool():
    _, _, config, traffic = run.find_cell(REPO, "register_keyed.planted")
    config["history"].update(keys=8, per_key_limit=12)
    a = run.make_pool(config, traffic, 5)
    assert a == run.make_pool(config, traffic, 5)
    assert a != run.make_pool(config, traffic, 6)
    assert len(a) == traffic["pool"] and a[0] != a[1]


def test_the_plant_sits_at_the_first_read_of_every_eighth_key():
    with open(os.path.join(REPO, "portbench", "traffic",
                           "planted.json")) as fh:
        traffic = json.load(fh)
    assert traffic["plant"] == {"every": 8}
    n_keys = 32
    for seed in SEEDS:
        clean = keyed(n_keys, seed)
        h = gen.make_history(
            {"keys": n_keys, "info_rate": 0.08}, traffic, seed)
        assert len(h) == len(clean)
        changed = [i for i, (a, b) in enumerate(zip(clean, h)) if a != b]
        assert [h[i][4] for i in changed] == gen.planted_keys(n_keys, 8)
        for i in changed:
            p, t, f, v, k = h[i]
            assert (t, f, v) == ("ok", "read", 5)
            first = next(j for j, e in enumerate(clean)
                         if e[4] == k and e[1:3] == ("ok", "read"))
            assert i == first
        verdicts = reference.check_history(h)
        assert sorted(k for k, (ok, _) in verdicts.items()
                      if ok is False) == gen.planted_keys(n_keys, 8)
