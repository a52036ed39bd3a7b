"""device.idle_share: the share of the traced steps in which the card runs
nothing, in %, both terms from the profiler's device timeline: 1 - (the
union of the device operations' intervals) / (the first traced operation's
start to the last one's end). The host's stall as the profiler starts
falls before the traced steps (`benchmark/trace.py`)."""


def read(ctx):
    s = ctx["summary"]
    if s.busy_s <= 0 or s.span_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.span_s)
