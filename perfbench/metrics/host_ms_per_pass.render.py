"""The host's enqueue time of a pass: the benchmark's span around
``Renderer.render(1)``, up to the copy and synchronise, mean over the
window's passes, in ms."""


def read(run):
    if run.kind != "progressive":
        return None
    ev = run.window.events
    return sum(enq - start for start, enq, _ in ev) / len(ev) * 1e3
