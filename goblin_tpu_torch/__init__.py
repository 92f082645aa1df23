"""goblin_tpu_torch: the goblin_tpu renderer ported to PyTorch and CUDA.

The JAX package ``goblin_tpu`` is the reference; this package imports
neither it nor JAX. Sub-packages mirror ``goblin_tpu``'s names
(``core``, ``geometry``, ``accel``, ``ops``, ``scene``, ``shading``,
``lights``, ``camera``, ``integrators``, ``io``) so each function's
counterpart is found by name.

It loads every scene ``goblin_tpu`` loads and renders it by its six
methods (path tracing, SPPM, AO, Whitted, light tracing, BDPT): load/bake
-> raygen -> BVH trace (CUDA kernels: ``csrc/trace_bvh8.cu`` at trace
widths 8 and 4, ``csrc/trace_bvh2.cu`` at width 1) -> shading, lights,
subsurface transport and media -> film -> EXR or PPM. On the card each
draw of the sample hash is one launch of ``csrc/rng_hash.cu``.
"""
