"""ocp_ip_roofline: kernel 4's share of its roofline over a step, in %: the
least time one H100 could take (`benchmark/bounds.py::bound_qp`) for the
step's QP launches, over the kernel's device time a step in the traced
window. The bound counts the interior-point iterations that the plain
reference needed, summed over tiles and SQP iterations (never the count the
kernel reports), averaged over the run's checked steps inside episodes: one
drawn from the seed in each episode, from the program's carry, as the traced
steps run. The window's first step, an episode's start with a cold warm
start (1 step in an episode's 300), is left out."""

from benchmark.bounds import bound_qp


def read(ctx):
    launches, sec = ctx["layers"]["qp"]
    if not launches or sec <= 0 or not ctx["qp_tile_iterations"]:
        return None
    steps = ctx["summary"].steps
    n_tiles = ctx["B"] // ctx["tile"]
    b = bound_qp(ctx["qp_tile_iterations"], ctx["tile"], n_tiles, ctx["T"], ctx["nx"], ctx["nu"],
                 ctx["mehrotra"], launches=launches / steps)
    return 100.0 * b.seconds / (sec / steps)
