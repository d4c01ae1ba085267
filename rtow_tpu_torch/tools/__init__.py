"""Standalone probes with kernels of their own, run as modules:
``python -m rtow_tpu_torch.tools.mxu_probe`` (the sphere sweep's
CUDA-core and tensor-core forms, ``csrc/mxu_probe.cu``) and
``python -m rtow_tpu_torch.tools.repro_nb_slice`` (a block-by-block table
sum, ``csrc/nb_slice.cu``).  Neither is on a render path."""
