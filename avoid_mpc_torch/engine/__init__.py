from avoid_mpc_torch.engine.receding import (  # noqa: F401
    EngineHyper,
    EngineParams,
    EngineState,
    StepOutput,
    TASK_FORWARD,
    TASK_GLOBAL_GOAL,
    engine_init,
    receding_step,
)
