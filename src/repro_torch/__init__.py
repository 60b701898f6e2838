"""SEDAR on PyTorch and CUDA: the port of the JAX reference package `repro`
(which stays beside it, unchanged). Imports torch, never jax or repro."""
