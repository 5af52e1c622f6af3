"""PyTorch/CUDA port of rcmvsnet_tpu: DTU depth inference on an NVIDIA
Hopper card, with hand-written kernels on the main path.

Importing the package imports nothing: the submodules pull in torch, and
the framework-free modules of `rcmvsnet_tpu` (data, io, fusion) are shared
rather than forked.
"""
