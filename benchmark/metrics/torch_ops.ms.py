"""torch_ops.ms: device ms a step of everything in the traced window that is
none of the port's CUDA kernels: the SQP loop's KKT residuals and
bookkeeping, the plant, the fused window's copies and the resets."""


def read(ctx):
    sec = ctx["layers"]["other"][1]
    return 1e3 * sec / ctx["summary"].steps if sec > 0 else None
