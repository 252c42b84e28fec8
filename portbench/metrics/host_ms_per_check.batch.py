"""Milliseconds of a keyed check in which the card ran nothing (the key
split, routing, encoding, copies, the native finish), mean over the
window's checks, from the profiler's trace."""

from portbench.readers import host_ms_per_check as read  # noqa: F401
