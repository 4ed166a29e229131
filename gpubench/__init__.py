"""The benchmark of the PyTorch/CUDA port (`repro_torch`): federated
rounds timed on the card, checked against plain references. See
README.md."""
