"""A plain PyTorch SPPM renderer that the benchmark holds the program's
SPPM to.

It shares no code, table or tensor with the program under test. It reads
the scene through the path-tracing reference's reader (plainref.scene),
intersects through its brute-force clusters (plainref.accel) and draws its
hashed sample streams from plainref.pathtrace; the SPPM estimator is
sppm.py's, with a brute-force photon gather in place of a hash grid. It
follows the program's estimator sample by sample (the same streams and
dimension layout), so the two agree pixel by pixel up to rounding, and a
lower precision does not.
"""
