"""A plain PyTorch path tracer that the benchmark holds the program to.

It reads the scene files itself and shares no code, table or tensor with
the program under test: its own OBJ parser and scene placement
(scene.py), a brute-force intersector over clusters of triangles
(accel.py), and the path tracer with the film's filter splat
(pathtrace.py). It follows the program's estimator sample by sample (the
same counter-based sample streams, the same dimension layout), so the two
agree lane by lane up to rounding, and a lower precision does not.
"""
