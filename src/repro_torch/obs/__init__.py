"""obs layer of the port (mirrors repro.obs): stage timers."""
