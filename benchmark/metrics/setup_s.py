"""setup_s: the process's start to the window's first dispatch (host
clock): imports, weights, the program's build, kernels loaded or built,
the warm-up of the cell's buckets."""


def read(rec):
    return rec['setup_s']
