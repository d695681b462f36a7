"""Seconds from the process's start to the window's first call: imports,
the device, loading the kernel library, compiling the plan, the
potentials, the evidence pool and the warm-up calls.  The build of the
kernel library with nvcc, which only a checkout's first run makes, is left
out (the result line's ``build_s``)."""


def read(run):
    return run.setup_s
