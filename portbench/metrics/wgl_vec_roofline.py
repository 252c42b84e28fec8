"""K1's (csrc/wgl_vec.cu) share of its roofline over the window's first
pass over the pool: the least time its launches could take, by
portbench/bounds.py, over the time their CUDA events read."""

from portbench import readers


def read(run):
    return readers.roofline_share(run, "wgl_vec", readers.bound_vec)
