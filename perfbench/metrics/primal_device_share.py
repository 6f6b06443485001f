"""The primal render's share of the device's busy time in a decorrelated
gradient step, in %: B1's device seconds in the trace
(``mega_segment_kernel<false>``) times the program's B1p launches over
its B1 launches, plus the draws' (``uniform_kernel``) times RNGp over
RNG, over the traced window's busy seconds. It assumes a primal launch
and an adjoint launch take the same time: the same kernel over the same
lanes. In the decorrelated cell both ratios are 1/2 by construction,
so the reading is half of B1's and the draws' share: the trace does not
tell the primal's launches from the adjoint's. None from a program that
counts no primal launches. The note gives the counts and seconds."""

from perfbench import recorded_steps

KERNELS = {"B1": "mega_segment_kernel<false>", "RNG": "uniform_kernel"}


def read(run):
    rec = recorded_steps.record(run)
    if rec is None or run.trace.busy_s <= 0.0:
        return None
    launched = rec.get("launches", {})
    seconds, parts = 0.0, []
    for name, kernel in KERNELS.items():
        primal, every = launched.get(name + "p", 0), launched.get(name, 0)
        traced_n, traced_s = run.trace.kernel(kernel)
        if primal == 0 or every == 0 or traced_s <= 0.0:
            return None
        seconds += traced_s * primal / every
        parts.append(f"{name}p {primal} of {name} {every}, {traced_s!r} s in {traced_n} launches")
    parts.append("a primal launch taken to last as long as an adjoint one")
    return 100.0 * seconds / run.trace.busy_s, "; ".join(parts)
