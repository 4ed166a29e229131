"""The harness: cells and configurations found by name, traffic and
weights drawn from the seed, the timed window, the trace's reduction,
the frozen counts and peaks, and the comparison that decides
`correct`."""
