"""PyTorch/CUDA port of mingunivision_tpu for one NVIDIA H100.

Mirrors the JAX package's module paths (`ops/`, `ops/kernels/`, `models/`,
`engine/`, `utils/`) and keeps its parameter layouts at public functions, so
the JAX package serves as the reference in the tests. Imports `torch`, never
`jax`. Every kernel the JAX package wrote in Pallas for the TPU on this port's
path is a hand-written CUDA kernel under `csrc/`, built with `nvcc` at first use.
"""
