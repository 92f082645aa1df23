"""Seconds of the harness's `load` span around the program's load_scene:
parsing, baking the tables and building the tree, on the host clock."""


def read(rec):
    return rec.get("load_s")
