"""spnet_tpu_torch — the PyTorch and CUDA port of `spnet_tpu` for NVIDIA
Hopper (H100).

The port mirrors the JAX package's module names.  It covers the serving
path (checkpoint -> SPNet: colorizer stem + Xception + dense grid head ->
batched predict -> denormalize -> metrics / CSV), with every Xception
separable convolution of the eval-mode model in the hand-written CUDA
kernel of `csrc/sepconv.cu`, and the training path (device-resident
uint8 feed -> augmentation -> train-mode forward -> loss -> backward ->
Adam under the 1-cycle schedule), with the loss and its gradient in the
CUDA kernels of `csrc/loss.cu`.  The package imports torch and never
jax, and nothing of `spnet_tpu`: it keeps its own copy of the numpy layer
(config, grid, data, io.logs, io.render, and the native PNG decoder).
"""

__version__ = "0.1.0"
