"""Seconds from the process's start to the window's start: kernel
loading, weights, the engine and Packrat's phase profiles."""


def read(r):
    return r.setup_s
