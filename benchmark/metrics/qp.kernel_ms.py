"""qp.kernel_ms: device ms a step of kernel 4, the resident interior-point
QP kernel, over the SQP's launches, in the traced window."""


def read(ctx):
    sec = ctx["layers"]["qp"][1]
    return 1e3 * sec / ctx["summary"].steps if sec > 0 else None
