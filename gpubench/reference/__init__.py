"""Plain PyTorch references the benchmark holds the port to.

Everything here computes in float32 with TF32 off, from parameters stored
in the configuration's dtype, and imports nothing of the program under
test. `precision="fp8"` rounds both operands of every matrix product and
convolution to float8 e4m3 (per-tensor scale): the control, one step
below the bfloat16 the configurations state, which the comparison has to
reject.
"""
