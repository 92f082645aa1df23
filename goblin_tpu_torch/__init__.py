"""goblin_tpu_torch: the goblin_tpu renderer ported to PyTorch and CUDA.

The JAX package ``goblin_tpu`` is the reference; this package imports
neither it nor JAX. Sub-packages mirror ``goblin_tpu``'s names
(``core``, ``geometry``, ``accel``, ``ops``, ``scene``, ``shading``,
``lights``, ``camera``, ``integrators``, ``io``) so each function's
counterpart is found by name.

The slice ported so far is the path-tracing main path of
``examples/bunny.json``: load/bake -> raygen -> BVH8 trace (a CUDA
kernel, ``csrc/trace_bvh8.cu``) -> shading and NEE -> film -> EXR.
Scene features outside that slice make the loader raise
``NotImplementedError``.
"""
