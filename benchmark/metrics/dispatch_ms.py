"""Host ms to enqueue one step: the median of the step calls timed on the
host's clock after the window, each on an idle card (``harness.dispatch_ms``)."""

import statistics


def read(rec):
    return statistics.median(rec.dispatch_ms) if rec.dispatch_ms else None
