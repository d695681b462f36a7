"""Kernel K1's share of its roofline in the traced window: the sum over
the calls the big-clique route made of each call's least time (the larger
of its operations over 989 TFLOP/s, for every dtype, and its bytes over
3.35 TB/s; ``portbench.roofline.k1_call``) over the device time of K1's
kernels (names holding "factored_contract" or "split_pot")."""

from portbench.roofline import k1_call


def read(run):
    t = run.trace
    if t is None or not run.k1_calls:
        return None
    k1_s = sum(s for n, s in t.kernels
               if "factored_contract" in n or "split_pot" in n)
    if k1_s <= 0:
        return None
    bound = sum(k1_call(**c)[2] for c in run.k1_calls)
    return 100.0 * bound / k1_s
