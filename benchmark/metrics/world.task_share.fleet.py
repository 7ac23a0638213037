"""The share of the profiled scenario-ticks whose mission was TASK
(``WorldDiag.mission``): the window is cruise alone when it reads 100."""


def read(ctx):
    share = ctx.get("task_share")
    return None if share is None else 100.0 * share
