"""utils layer of the port (mirrors repro.utils)."""
