"""linearize.kernel_ms: device ms a step of kernel 3, the SQP's
linearization of RK4 of the prior and the GP means, in the traced window."""


def read(ctx):
    sec = ctx["layers"]["linearize"][1]
    return 1e3 * sec / ctx["summary"].steps if sec > 0 else None
