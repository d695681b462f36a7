"""Host seconds of the program's compile phases during set-up: the sum of
``utils.timing.TIMERS`` totals whose names start with "compile."
(interning, triangulation, tree building)."""


def read(run):
    return sum(v for k, v in run.timers.items() if k.startswith("compile."))
