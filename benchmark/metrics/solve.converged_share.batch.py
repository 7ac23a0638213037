"""The share of the window's scenario solves that exit converged (the
projected gradient under grad_tol): useful outcomes over attempts."""


def read(ctx):
    done, attempts = ctx.get("converged") or (None, 0)
    return None if done is None or not attempts else 100.0 * done / attempts
