"""restir_tpu_torch — the ReSTIR renderer on PyTorch and CUDA.

The port of `restir_tpu` (JAX/Pallas on a TPU) to an NVIDIA Hopper card.
It carries the fused spatiotemporal ReSTIR DI frame with the EAW or SVGF
denoiser on scenes of any size, with env maps and textures, loaded from
scene files (`scene.loader`) or built procedurally; the fused DI + GI
frame (ReSTIR GI) on scenes of at most 1024 triangles; and the general
path (PT-direct, the full path tracer, the general ReSTIR DI and DI + GI
steps, the BVH heatmap, the G-buffer preview; EAW or SVGF; pcg4d or
Sobol; every intersector) at any triangle count: CUDA C++ kernels in
`csrc/` (the fused resident DI kernel for scenes of at most 1024
triangles; the MTBVH G-buffer and RIS + shadow-ray kernels above that;
the spatial merge + shade; one EAW or SVGF à-trous level; SVGF's
temporal accumulation and variance passes; the general path's primary
hit, closest / any hit and CDF RIS, the JAX package's MTBVH walk and
the heatmap; the GI path trace and GI resolve), each with a plain
PyTorch twin that CPU tensors take.

The package imports `torch` and never `jax`.
"""

__version__ = "0.1.0"

from .config import (  # noqa: E402,F401
    DenoiserType,
    RenderConfig,
    ReuseMode,
    ToneMapping,
    TracerType,
    mat_flags,
)
