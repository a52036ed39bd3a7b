"""fused.capture_s: the host's seconds to capture and instantiate the CUDA
graphs of the run's fused window (`FusedWindow.stats`: capture_s +
instantiate_s over its graphs), part of the set-up."""


def read(ctx):
    return ctx["graph_s"] if ctx["graph_s"] > 0 else None
