"""spnet_tpu_torch — the PyTorch and CUDA port of `spnet_tpu` for NVIDIA
Hopper (H100).

The port mirrors the JAX package's module names.  It covers the serving
path so far: checkpoint -> SPNet (colorizer stem + Xception + dense grid
head) -> batched predict -> denormalize -> metrics / CSV.  Every Xception
separable convolution runs through the hand-written CUDA kernel in
`csrc/sepconv.cu`.  The package imports torch and never jax; it reuses the
jax-free modules of `spnet_tpu` (config, grid, data.dataset, io.render).
"""

__version__ = "0.1.0"
