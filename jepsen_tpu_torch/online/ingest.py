"""Foreign trace ingest: map external history formats onto the WAL op
schema so traces from anywhere stream through the same checkers (the
port's copy of `jepsen_tpu/online/ingest.py`).

Two adapters (plus the native WAL):

* **Jepsen EDN histories** — the reference checker's on-disk format: a
  vector (or stream) of op maps, ``{:type :invoke, :f :txn, :value
  [[:append 9 1]], :process 0, :time ..., :index ...}``, possibly
  tagged ``#jepsen.history.Op{...}``. A small self-contained EDN
  reader handles the subset real histories use (nil/booleans/numbers/
  strings/keywords/symbols/vectors/lists/sets/maps/tagged literals/
  comments); keywords become plain strings, which lands ``:append`` /
  ``:r`` / ``:w`` exactly on this repo's ``txn`` micro-op constants
  and ``:invoke``/``:ok``/... on its op types.

* **OTLP-ish span-log JSONL** — one span per line with
  ``startTimeUnixNano``/``endTimeUnixNano``, a ``status.code``, and
  ``jepsen.*`` attributes (either OTLP's ``[{"key", "value":
  {"intValue": ...}}]`` list shape or a plain dict). Each span becomes
  an invoke at its start and a completion at its end (OK → ok, ERROR →
  fail, otherwise info), interleaved across spans by timestamp — trace
  validation of unmodified systems in the OmniLink spirit.

``iter_trace`` sniffs the format and yields ``history.Op`` records
reindexed 0..n-1, exactly as ``store.load_wal_history`` would index a
native WAL; ``--follow`` tailing is only meaningful for the native WAL
(foreign trace files are complete artifacts).
"""

from __future__ import annotations

import json
import logging

from ..history import Op

log = logging.getLogger("jepsen_tpu_torch.online.ingest")

__all__ = ["EDNError", "read_edn", "read_edn_all", "edn_ops", "span_ops",
           "detect_format", "iter_trace"]


# ---------------------------------------------------------------------------
# EDN reader

class EDNError(ValueError):
    """Malformed EDN input."""


_DELIMS = {"(": ")", "[": "]", "{": "}"}
_WS = " \t\n\r\f\v,"


class _EDNReader:
    def __init__(self, text: str):
        self.s = text
        self.i = 0
        self.n = len(text)

    def _skip_ws(self) -> None:
        while self.i < self.n:
            c = self.s[self.i]
            if c in _WS:
                self.i += 1
            elif c == ";":  # comment to end of line
                while self.i < self.n and self.s[self.i] != "\n":
                    self.i += 1
            else:
                return

    def at_end(self) -> bool:
        self._skip_ws()
        return self.i >= self.n

    def read(self):
        self._skip_ws()
        if self.i >= self.n:
            raise EDNError("unexpected end of input")
        c = self.s[self.i]
        if c in _DELIMS:
            return self._read_coll(c)
        if c == "}" or c == ")" or c == "]":
            raise EDNError(f"unexpected {c!r} at {self.i}")
        if c == '"':
            return self._read_string()
        if c == ":":
            self.i += 1
            return self._read_symbol_token()
        if c == "\\":
            return self._read_char()
        if c == "#":
            return self._read_dispatch()
        if c == "^":  # metadata: read and discard, return the value
            self.i += 1
            self.read()
            return self.read()
        return self._read_atom()

    def _read_coll(self, opener: str):
        closer = _DELIMS[opener]
        self.i += 1
        items = []
        while True:
            self._skip_ws()
            if self.i >= self.n:
                raise EDNError(f"unclosed {opener!r}")
            if self.s[self.i] == closer:
                self.i += 1
                break
            items.append(self.read())
        if opener == "{":
            if len(items) % 2:
                raise EDNError("map literal with odd number of forms")
            out = {}
            for k, v in zip(items[::2], items[1::2]):
                out[_freeze(k)] = v
            return out
        return items

    def _read_dispatch(self):
        self.i += 1
        if self.i < self.n and self.s[self.i] == "{":  # set
            return self._read_set()
        if self.i < self.n and self.s[self.i] == "_":  # discard form
            self.i += 1
            self.read()
            return self.read()
        # tagged literal: #inst "...", #jepsen.history.Op{...} — the
        # tag is dropped, the wrapped form is the value
        self._read_symbol_token()
        return self.read()

    def _read_set(self):
        items = []
        self.i += 1
        while True:
            self._skip_ws()
            if self.i >= self.n:
                raise EDNError("unclosed set literal")
            if self.s[self.i] == "}":
                self.i += 1
                return items
            items.append(self.read())

    def _read_string(self) -> str:
        self.i += 1
        out = []
        while self.i < self.n:
            c = self.s[self.i]
            if c == '"':
                self.i += 1
                return "".join(out)
            if c == "\\":
                self.i += 1
                if self.i >= self.n:
                    break
                e = self.s[self.i]
                out.append({"n": "\n", "t": "\t", "r": "\r",
                            '"': '"', "\\": "\\"}.get(e, e))
            else:
                out.append(c)
            self.i += 1
        raise EDNError("unclosed string")

    def _read_char(self) -> str:
        self.i += 1
        start = self.i
        while (self.i < self.n and self.s[self.i] not in _WS
               and self.s[self.i] not in "()[]{}\";"):
            self.i += 1
        name = self.s[start:self.i]
        return {"newline": "\n", "space": " ", "tab": "\t",
                "return": "\r"}.get(name, name[:1])

    def _read_symbol_token(self) -> str:
        start = self.i
        while (self.i < self.n and self.s[self.i] not in _WS
               and self.s[self.i] not in "()[]{}\";"):
            self.i += 1
        if self.i == start:
            raise EDNError(f"empty token at {start}")
        return self.s[start:self.i]

    def _read_atom(self):
        tok = self._read_symbol_token()
        if tok == "nil":
            return None
        if tok == "true":
            return True
        if tok == "false":
            return False
        try:
            return int(tok.rstrip("N"))
        except ValueError:
            pass
        try:
            return float(tok.rstrip("M"))
        except ValueError:
            pass
        return tok  # bare symbol


def _freeze(v):
    """Map keys must hash: EDN collection keys become tuples."""
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


def read_edn(text: str):
    """The first EDN form in ``text``."""
    return _EDNReader(text).read()


def read_edn_all(text: str) -> list:
    """Every top-level EDN form in ``text``."""
    r = _EDNReader(text)
    out = []
    while not r.at_end():
        out.append(r.read())
    return out


#: the op-map keys that survive into the WAL schema
_OP_KEYS = ("process", "type", "f", "value", "time", "index", "error")


def edn_ops(text: str) -> list[dict]:
    """A Jepsen EDN history as WAL-schema op dicts, in file order. The
    history may be one enclosing vector of op maps or a stream of
    top-level maps (one per line)."""
    forms = read_edn_all(text)
    if len(forms) == 1 and isinstance(forms[0], list):
        forms = forms[0]
    out = []
    for m in forms:
        if not isinstance(m, dict):
            raise EDNError(f"expected an op map, got {type(m).__name__}")
        out.append({k: m[k] for k in _OP_KEYS if m.get(k) is not None})
    return out


# ---------------------------------------------------------------------------
# OTLP-ish span logs

_STATUS_TYPES = {
    "STATUS_CODE_OK": "ok",
    "OK": "ok",
    "STATUS_CODE_ERROR": "fail",
    "ERROR": "fail",
}


def _span_attrs(span: dict) -> dict:
    """Span attributes as a flat dict, accepting both OTLP's
    ``[{"key", "value": {"intValue": ...}}]`` list shape and a plain
    mapping."""
    raw = span.get("attributes") or {}
    if isinstance(raw, dict):
        return dict(raw)
    out = {}
    for a in raw:
        v = a.get("value")
        if isinstance(v, dict):  # {"intValue": "3"} / {"stringValue": ..}
            for kind, x in v.items():
                v = int(x) if kind == "intValue" else x
                break
        out[a.get("key")] = v
    return out


def _attr_value(attrs: dict, key: str):
    """A jepsen.* attribute, JSON-decoding string payloads (span
    exporters stringify structured values)."""
    v = attrs.get(key)
    if isinstance(v, str):
        try:
            return json.loads(v)
        except ValueError:
            return v
    return v


def span_ops(lines) -> list[dict]:
    """An OTLP-ish span-log (an iterable of JSONL lines) as WAL-schema
    op dicts: every span contributes an invoke at its start and a
    completion at its end, ordered by timestamp (ties: completions
    after invocations, then span arrival order)."""
    events = []  # (time, phase, arrival, op-dict)
    for arrival, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            span = json.loads(line)
        except ValueError:
            log.warning("span log: dropping unparseable line %r", line[:80])
            continue
        attrs = _span_attrs(span)
        process = _attr_value(attrs, "jepsen.process")
        if process is None:
            process = span.get("spanId") or arrival
        f = _attr_value(attrs, "jepsen.f") or span.get("name")
        value = _attr_value(attrs, "jepsen.value")
        t0 = int(span.get("startTimeUnixNano") or 0)
        t1 = int(span.get("endTimeUnixNano") or t0)
        status = ((span.get("status") or {}).get("code")
                  or span.get("statusCode") or "")
        ctype = _STATUS_TYPES.get(str(status).upper(), "info")
        completion_value = _attr_value(attrs, "jepsen.value.ok")
        if completion_value is None:
            completion_value = value
        events.append((t0, 0, arrival, {
            "process": process, "type": "invoke", "f": f,
            "value": value, "time": t0}))
        completion = {"process": process, "type": ctype, "f": f,
                      "value": completion_value, "time": t1}
        err = _attr_value(attrs, "jepsen.error")
        if err is not None:
            completion["error"] = err
        events.append((t1, 1, arrival, completion))
    events.sort(key=lambda e: e[:3])
    return [e[3] for e in events]


# ---------------------------------------------------------------------------
# Format sniffing + the unified trace iterator

def detect_format(path: str) -> str:
    """"wal", "edn", or "spans", by extension then first-record
    shape."""
    if path.endswith(".edn"):
        return "edn"
    first = ""
    try:
        with open(path) as f:
            for line in f:
                if line.strip():
                    first = line.strip()
                    break
    except OSError:
        pass
    if first:
        try:
            rec = json.loads(first)
        except ValueError:
            return "edn"
        if isinstance(rec, dict):
            if "startTimeUnixNano" in rec or "spanId" in rec \
                    or "attributes" in rec:
                return "spans"
            if "type" in rec and "process" in rec:
                return "wal"
    return "wal"


def iter_trace(path: str, *, follow: bool = False, poll_s: float = 0.05,
               stop=None, fmt: str | None = None):
    """Yield ``Op`` records from a WAL file or foreign trace, indexed
    0..n-1 — the shape every batch checker and frontier consumes.
    ``follow`` tails native WALs; foreign formats are read whole (a
    follow request on them degrades to the batch read with a
    warning)."""
    fmt = fmt or detect_format(path)
    if fmt == "wal":
        from .. import store

        yield from store.follow_wal(path, follow=follow, poll_s=poll_s,
                                    stop=stop)
        return
    if follow:
        log.warning("--follow is only meaningful for native WALs; "
                    "reading %s trace %s whole", fmt, path)
    if fmt == "edn":
        with open(path) as f:
            dicts = edn_ops(f.read())
    elif fmt == "spans":
        with open(path) as f:
            dicts = span_ops(f)
    else:
        raise ValueError(f"unknown trace format {fmt!r}")
    for i, d in enumerate(dicts):
        yield Op.from_dict(dict(d)).with_(index=i)
