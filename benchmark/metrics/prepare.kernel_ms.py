"""prepare.kernel_ms: device ms a step of the step's first stage, kernel 1
(the GP variances) and kernel 2 (the tightening), in the traced window."""


def read(ctx):
    lay = ctx["layers"]
    sec = lay["gp"][1] + lay["tighten"][1]
    return 1e3 * sec / ctx["summary"].steps if sec > 0 else None
