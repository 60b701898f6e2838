"""Hand-written Hopper kernels of the port and their plain versions.

K1 `fingerprint` (csrc/fingerprint.cu) and K2 `flash_attention`
(csrc/flash_attention.cu); `_build` compiles them with nvcc at first use.
"""
