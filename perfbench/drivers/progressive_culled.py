"""Progressive rendering as :mod:`.progressive` runs it, for a scene whose
regen pass the program culls (``chunk_cull``: the culled instance B1rc):
the same set-up, window, check and kind; only the pass's work, which a
traced run counts for B1rc's roofline, is :mod:`..counts_cull`'s."""

from __future__ import annotations

from .. import counts_cull
from ..harness import Context
from .progressive import KIND, check, estimator, release, setup, window  # noqa: F401


def work(ctx: Context) -> dict:
    return counts_cull.work(ctx, estimator(ctx))
