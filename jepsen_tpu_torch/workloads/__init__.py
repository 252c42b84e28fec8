"""Seeded workload generators of the port (register histories)."""
