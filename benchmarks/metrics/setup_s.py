"""Seconds from the process's start to the first timed pass: CUDA's start,
loading and baking the scene, loading (or building) the kernels, warm-up."""


def read(rec):
    return rec["setup_s"]
