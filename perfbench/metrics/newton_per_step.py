"""newton_per_step: Newton iterations of every try over accepted steps
(Timestepper.stats, solver/newton.py)."""


def read(run):
    n = run["accepted_steps"]
    return run["stats"].get("newton_iterations", 0) / n if n else None
