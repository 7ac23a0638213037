from avoid_mpc_torch.solver.boxqp import boxqp  # noqa: F401
from avoid_mpc_torch.solver.ilqr import (  # noqa: F401
    MPCProblem,
    SolverHyper,
    SolverParams,
    SolveResult,
    hover_warm_start,
    solve,
    solve_batched,
    solve_plain,
)
