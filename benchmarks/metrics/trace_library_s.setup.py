"""Seconds the program took to load its trace kernels' libraries (its
`setup.trace_library` spans, summed): the build key's hash, nvcc where the
library is not built yet, and the library's load. 0 where no library
loaded (the CPU's plain versions)."""

from benchlib import stages


def read(rec):
    return stages.setup_seconds("setup.trace_library")
