"""setup_s: process start to the window's opening, host clock: Python
and torch start-up, the JSON model, Simulation(model) on the card
(mesh, System, initial state), the kernels' builds on a first run, and
the warm-up steps that capture the step and tracer programs."""


def read(run):
    return run["setup_s"]
