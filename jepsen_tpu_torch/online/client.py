"""A WAL stream as a serve-queue client (the port's copy of
`jepsen_tpu/online/client.py`).

The resident daemon's queue (serve/queue.py) doesn't care where a
history came from — so a live WAL (or a foreign trace) can act as just
another client: ``QueueStreamClient`` follows a stream and submits a
prefix snapshot every ``window`` ops. Each submission is a complete,
independently-checkable history (the daemon is stateless per job), and
because the daemon packs every batch through
``independent.pack_check``, window lanes from MANY concurrent streams
ride the same device launches — cross-stream packing for free, with
each stream's verdicts still bit-identical to one-shot checks
(P-compositionality).
"""

from __future__ import annotations

import logging
import random
import time

from ..history import Op

log = logging.getLogger("jepsen_tpu_torch.online.client")

__all__ = ["QueueStreamClient"]


class QueueStreamClient:
    """Submit prefix snapshots of an op stream to a DurableQueue.

    queue     a serve.DurableQueue (or anything with its submit())
    client    the client id submissions are attributed (and weighted)
              under
    workload  the daemon workload name that rehydrates + checks the
              ops ("register", "cycle", ...)
    window    ops per submission boundary
    weight    the client's weighted-round-robin share
    backoff_base_s / backoff_cap_s / seed
              QueueFull handling: a full queue mid-stream is
              backpressure, not an error — submission retries under
              capped exponential backoff with seeded jitter, never
              sleeping less than the queue's retry_after_s hint.
    """

    def __init__(self, queue, client: str, workload: str = "register", *,
                 window: int = 256, weight: int = 1,
                 backoff_base_s: float = 0.5,
                 backoff_cap_s: float = 30.0, seed: int = 0):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.queue = queue
        self.client = str(client)
        self.workload = workload
        self.window = window
        self.weight = weight
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.job_ids: list = []
        self.consumed = 0
        self.backoffs = 0  # QueueFull rejections absorbed
        self._rng = random.Random(seed)

    def submit_prefix(self, ops) -> str:
        """Submit one snapshot; returns its durable job id. A full
        queue is absorbed here: retry under capped expo backoff
        (honoring the daemon's retry_after_s hint, jittered UP so a
        fleet of streams doesn't re-converge on the same instant)
        rather than surfacing QueueFull mid-stream."""
        from ..serve.queue import QueueFull

        history = [o.to_dict() if isinstance(o, Op) else dict(o)
                   for o in ops]
        attempt = 0
        while True:
            try:
                job_id = self.queue.submit(self.client, self.workload,
                                           history, weight=self.weight)
                break
            except QueueFull as e:
                delay = min(self.backoff_cap_s,
                            max(e.retry_after_s,
                                self.backoff_base_s * (2 ** attempt)))
                delay *= 1.0 + 0.5 * self._rng.random()  # [1.0, 1.5)
                self.backoffs += 1
                attempt += 1
                log.warning("queue full (%d pending); stream %s "
                            "backing off %.2fs (attempt %d)",
                            e.pending, self.client, delay, attempt)
                time.sleep(delay)
        self.job_ids.append(job_id)
        return job_id

    def stream(self, source, *, max_ops=None) -> list:
        """Consume a stream, submitting at every window boundary and
        once at stream end; returns the submitted job ids in order.
        The LAST id's verdict is the stream's final verdict."""
        buf: list = []
        n = 0
        for op in source:
            buf.append(op)
            n += 1
            if n % self.window == 0:
                self.submit_prefix(buf)
            if max_ops is not None and n >= max_ops:
                break
        if n % self.window:
            self.submit_prefix(buf)
        self.consumed = n
        return self.job_ids

    def final_verdict(self, timeout: float | None = None):
        """Block for the last submission's verdict."""
        if not self.job_ids:
            return None
        return self.queue.wait_for_verdict(self.job_ids[-1],
                                           timeout=timeout)
