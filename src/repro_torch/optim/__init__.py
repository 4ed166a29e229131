"""optim layer of the port (mirrors repro.optim)."""
