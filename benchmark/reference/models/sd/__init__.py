"""Stable Diffusion parts of the image decoder (counterpart of
`mm_interleaved_tpu/models/sd`)."""
