"""The port's twins of the reference's `tools/` scripts, run as
`python -m repro_torch.tools.<name>`."""
