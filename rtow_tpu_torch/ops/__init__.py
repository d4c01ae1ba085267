"""Compute ops: a scene's tables (``tables``), the plain bounce that the
kernels' plain versions share (``bounce``), the kernels' wrappers
(``megakernel`` K1, ``flat_bounce`` K3, ``grad`` K4/K5, ``keys``), the
render loop of large meshes (``wavefront``) and the builder that compiles
the CUDA sources (``_cuda``)."""
