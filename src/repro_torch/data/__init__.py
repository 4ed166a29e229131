"""data layer of the port (mirrors repro.data)."""
