"""Host seconds of the program's own set-up phases before the window: the
``utils.timing.TIMERS`` totals of ``engine.*`` (potentials evaluated on the
host and uploaded), ``program.build`` (serving programs built on the first
calls) and ``k1.split`` (kernel K1's kept operand layouts made), as taken
after the warm-up calls.  What ``setup_s`` holds beyond it is the
process's: imports, the device, loading K1's library, the plan's compile
(``compile_s``), the evidence pool and the warm-up calls' device work."""

from portbench.spans import recorder


def read(run):
    if recorder() is None:
        return None
    return sum(v for k, v in run.timers.items()
               if k.startswith("engine.") or k in ("program.build", "k1.split"))
