"""fl layer of the port (mirrors repro.fl)."""
