"""Compute ops: the megakernel (CUDA, with its plain PyTorch version)
and the builder that compiles the CUDA sources."""
