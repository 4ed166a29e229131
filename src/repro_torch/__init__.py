"""PyTorch/CUDA port of the PFedDST reproduction (`src/repro/` is the JAX
reference it is held against).

The module layout mirrors the reference's, so each counterpart is easy to
find: `repro_torch.core.rounds` ports `repro.core.rounds`, and so on. The
port imports torch and numpy only, never jax and nothing of `repro`.

Entry points take `device=` and default to `"cuda"`; asking for CUDA on a
host without it raises (see `repro_torch.device`). The two Pallas kernels
on the PFedDST round's path are hand-written CUDA C++ (`csrc/`), built at
first use (`repro_torch.kernels.build`).
"""
