"""tries_per_step: timestep tries over accepted steps (Timestepper)."""


def read(run):
    n = run["accepted_steps"]
    return run["stats"].get("tries", 0) / n if n else None
