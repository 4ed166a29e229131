"""launch layer of the port (mirrors repro.launch): the step functions, the
serving and training entry points, and the one-card dry run with its
roofline, input specs and mesh shapes."""
