"""dof_steps_per_s: interior unknowns (interior cells x primary
variables) x accepted steps in the window, over the window's seconds
(host clock, ended by a device synchronise). Refused tries, output,
tracer solves and episode restarts all lie inside the window."""


def read(run):
    sz = run["sizes"]
    dof = sz["interior_cells"] * sz["primary_variables"]
    return dof * run["accepted_steps"] / run["window_s"]
