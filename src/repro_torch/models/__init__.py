"""models layer of the port (mirrors repro.models)."""
