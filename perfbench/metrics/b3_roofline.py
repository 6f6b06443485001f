"""Kernel B3's share of its roofline in a gradient step, in %: the
bound of the work its traced calls needed (``counts_grad.py``) over
the device time of its kernels in the trace, against the card's
published peaks. The note names the side that binds."""

from perfbench import roofline_grad

ENTRY = "B3"


def read(run):
    return roofline_grad.read(run, ENTRY)
