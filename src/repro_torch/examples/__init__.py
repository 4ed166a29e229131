"""The port's twins of the reference's `examples/` drivers, run as
`python -m repro_torch.examples.<name>`."""
