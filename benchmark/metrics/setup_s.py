"""Set-up seconds, host clock: from the process start to the window's start
(imports, the network and its weights, the traffic, two requests of the
cell's shape, and on a checkout's first run the kernels' build)."""


def read(rec):
    return rec.setup_s
