"""One run of one benchmark cell, on the machine it is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Prints, as the last line of standard
output, one JSON object with ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and ``breakdown`` when traced), ``build_s`` (the
seconds of the kernel library's build, which ``setup_s`` leaves out; 0
where the checkout had it) and, last, ``checks``: each number compared
with the reference beside its limit, which also close standard error.  Exits non-zero, printing no result,
without the CUDA devices the cell needs or when JAX or the JAX package was
loaded.
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from portbench.core import main

    # set-up is timed from the process's start (t_start = 0 seconds in)
    sys.exit(main(sys.argv[1:], t_start=0.0))
