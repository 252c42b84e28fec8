"""Recovery verification (the port's copy of
`jepsen_tpu/checker/recovery.py`; the OmniLink lesson): every
injected fault must be provably revoked before analysis, or checker
verdicts conflate system bugs with harness residue.

RecoveryChecker audits the history against the fault families recorded
by nemesis.combined (test["fault_families"], or the ctor arg): for each
family whose heals set is non-empty, the LAST fault op must be followed
by a heal op whose completion carries no error; and once the final heal
lands, the post-heal window must contain at least min_ok successful
client ops — proof the cluster actually served traffic again. Families
with an empty heals set (file corruption) are exempt from the healed
audit: their faults are not revocable by design.
"""

from __future__ import annotations

from . import Checker

NEMESIS_PROCESS = "nemesis"


class RecoveryChecker(Checker):
    def __init__(self, families: dict | None = None, min_ok: int = 1):
        self.families = families
        self.min_ok = min_ok

    def check(self, test, history, opts=None) -> dict:
        families = (self.families if self.families is not None
                    else test.get("fault_families") or {})
        history = list(history)
        # positions, not op.index: this must also work on histories that
        # were never run through index()
        nem = [(i, o) for i, o in enumerate(history)
               if o.process == NEMESIS_PROCESS]

        unhealed: dict = {}
        faults_seen: dict = {}
        heal_fs: set = set()
        audited_any = False
        for fam, spec in families.items():
            fault_set = set(spec.get("faults") or ())
            heals = set(spec.get("heals") or ())
            heal_fs |= heals
            fault_positions = [i for i, o in nem if o.f in fault_set]
            faults_seen[fam] = len(fault_positions)
            if not fault_positions:
                continue  # family never fired; nothing to audit
            if not heals:
                continue  # unrevokable by design (corruption)
            audited_any = True
            heal_entries = [(i, o) for i, o in nem if o.f in heals]
            if not heal_entries:
                unhealed[fam] = "no heal op in history"
                continue
            last_heal_i, last_heal = heal_entries[-1]
            if last_heal_i < fault_positions[-1]:
                unhealed[fam] = "fault op after the last heal"
            elif last_heal.error is not None:
                unhealed[fam] = f"final heal errored: {last_heal.error}"

        # the stability audit: ok client ops after the final heal of ANY
        # audited family (both journal entries of that heal)
        heal_positions = [i for i, o in nem if o.f in heal_fs]
        post_heal_ok = None
        if audited_any and heal_positions:
            cutoff = heal_positions[-1]
            post_heal_ok = sum(
                1 for o in history[cutoff + 1:]
                if isinstance(o.process, int) and o.is_ok)
            if post_heal_ok < self.min_ok:
                unhealed["stability"] = (
                    f"only {post_heal_ok} ok client ops after the final "
                    f"heal (need >= {self.min_ok})")

        return {
            "valid": not unhealed,
            "unhealed": unhealed,
            "faults_seen": faults_seen,
            "post_heal_ok_count": post_heal_ok,
        }


def recovery(families: dict | None = None, min_ok: int = 1
             ) -> RecoveryChecker:
    return RecoveryChecker(families=families, min_ok=min_ok)
