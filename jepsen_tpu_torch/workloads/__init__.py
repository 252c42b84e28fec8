"""Seeded workload generators of the port (register, queue and
list-append histories)."""
