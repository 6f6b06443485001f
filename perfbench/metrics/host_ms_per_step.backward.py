"""The host's time in a gradient step's ``backward()``: the program's
span ``mcpt.grad.backward`` (``diff/grad.py::value_and_grad``: autograd's
walk of the step's graph, each segment's row gather, vjp and row scatter
launched), summed over the traced window, over its steps, in ms."""

from perfbench import recorded_steps


def read(run):
    return recorded_steps.host_ms(run, "grad.backward")
