"""gp_posterior_roofline: kernel 1's share of its roofline, the least time one H100
could take for a launch (`benchmark/bounds.py::bound_gp`, live points only)
over the device time of a launch in the traced window, in %."""

from benchmark.bounds import bound_gp


def read(ctx):
    launches, sec = ctx["layers"]["gp"]
    if not launches or sec <= 0:
        return None
    b = bound_gp(ctx["B"] * ctx["T"], ctx["live_points"], ctx["D"])
    return 100.0 * b.seconds / (sec / launches)
