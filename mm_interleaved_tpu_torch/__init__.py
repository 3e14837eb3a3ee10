"""PyTorch port of `mm_interleaved_tpu` for NVIDIA Hopper GPUs.

The package mirrors the JAX package's layout module for module and imports
no JAX.  Its deformable-attention op launches a CUDA kernel of its own
(`csrc/`) for CUDA tensors and runs a plain PyTorch version on the CPU.
Importing the package builds nothing: kernels compile at first use.
"""
