"""PyTorch/CUDA port of rcmvsnet_tpu: DTU depth inference and the
unsupervised train step on an NVIDIA Hopper card, with hand-written kernels
on the main paths.

Importing the package imports nothing: the submodules pull in torch. The
port keeps its own copies of the framework-free I/O, data and fusion
modules and imports nothing of the JAX package.
"""
