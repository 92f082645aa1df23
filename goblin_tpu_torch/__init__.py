"""goblin_tpu_torch: the goblin_tpu renderer ported to PyTorch and CUDA.

The JAX package ``goblin_tpu`` is the reference; this package imports
neither it nor JAX. Sub-packages mirror ``goblin_tpu``'s names
(``core``, ``geometry``, ``accel``, ``ops``, ``scene``, ``shading``,
``lights``, ``camera``, ``integrators``, ``io``) so each function's
counterpart is found by name.

Ported so far: ``examples/bunny.json`` rendered with path tracing and
with SPPM, its own method: load/bake -> raygen -> BVH trace (CUDA kernels:
``csrc/trace_bvh8.cu`` at the default trace width 8, ``csrc/trace_bvh2.cu``
at width 1) -> shading, NEE and the photon walk -> film -> EXR. Scene
features outside those paths make the loader raise ``NotImplementedError``.
"""
