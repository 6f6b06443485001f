"""Kernel B1rc's time after its work list ran dry, in %: on the card's
clock as the kernel keeps it, from the first block that found the list
spent to the last block's end, over the first block's start to the last
block's end, summed over the traced window's launches (as
``b1r_tail_share`` reads B1r). Read only where the window's launches
are the culled instance's. The note sets the in-kernel time a pass
beside the trace's time a launch."""

from perfbench import recorded


def read(run):
    rec = recorded.record(run)
    if rec is None or rec["kernel_ms"] <= 0.0 or not rec["launches"].get("B1rc") \
            or rec["launches"].get("B1r"):
        return None
    note = f"kernel_ms / passes {rec['kernel_ms'] / rec['passes']!r}"
    kernel = ((run.work or {}).get("B1rc") or {}).get("kernel")
    n, seconds = run.trace.kernel(kernel) if kernel else (0, 0.0)
    if n:
        note += f"; the trace's B1rc {seconds * 1e3 / n!r} ms a launch over {n}"
    return 100.0 * rec["tail_ms"] / rec["kernel_ms"], note
