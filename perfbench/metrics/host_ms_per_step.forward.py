"""The host's time enqueuing a gradient step's forward: the program's
span ``mcpt.grad.forward`` (``diff/grad.py::value_and_grad``: the render
of the step's sample batches, a segment launch and a draw each segment,
and the loss), summed over the traced window, over its steps, in ms."""

from perfbench import recorded_steps


def read(run):
    return recorded_steps.host_ms(run, "grad.forward")
