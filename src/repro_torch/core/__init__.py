"""core layer of the port (mirrors repro.core)."""
