"""krylov_per_newton: linear iterations over Newton iterations
(Timestepper.stats; solver/krylov.py, solver/precond.py, ops/dia.py)."""


def read(run):
    its = run["stats"].get("newton_iterations", 0)
    return run["stats"].get("linear_iterations", 0) / its if its else None
