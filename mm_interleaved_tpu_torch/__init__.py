"""PyTorch port of `mm_interleaved_tpu` for NVIDIA Hopper GPUs.

The package mirrors the JAX package's layout module for module and imports
no JAX.  Each op with a TPU kernel in the JAX package (deformable
attention, the UNet's factorised MMFS, flash attention, GroupNorm+SiLU,
fused GEGLU, the v1 and v4 deformable formulations) launches a CUDA kernel
of its own (`csrc/`) for CUDA tensors and runs a plain PyTorch version on
the CPU.  Importing the package builds nothing: kernels compile at first
use.  Entry points: `generation.text.generate_texts`;
`MMInterleaved.generate_image_inputs` then
`generation.diffusion.generate_images`; `engine.trainer.Trainer`; and
`python -m mm_interleaved_tpu_torch.bench_deform_kernel`.
"""
