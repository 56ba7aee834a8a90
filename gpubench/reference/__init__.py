"""The plain reference the benchmark holds the program to.

Plain PyTorch, computed in float32 with TF32 off (``precision.exact``). It
imports neither JAX nor anything of the package under test: it is a frozen
copy of the math of BrepGen's denoisers, VAEs, schedulers, dedup, training
step and point-cloud metrics, written against the weight tensors and inputs
that the benchmark makes from its seed. Every product goes through
``precision``, so the same code also computes the lower-precision control
(fp8 for a bf16 configuration, TF32 for an f32 one).
"""
