"""setup_s (s, host clock): from the process's start to the window's start:
imports, inputs and weights made from the seed, the program built, its
kernels loaded (built in a checkout's first run) and every shape of the
cell's traffic warmed up."""


def read(data):
    return data["setup_s"]
