"""Plain replay of Waiwera's step-size control for one episode: given
what each try of the program reported (converged or not, and its Newton
iterations), the step sizes the timestepper has to try, in order.

Covers what the benchmark's episodes use: backward Euler from one
initial size, fixed stepping (adapt off: the size holds until a
refusal switches the adaptor on) or the iteration adaptor (a converged
try with fewer than `minimum` iterations doubles the next size up to
maximum.size, more than `maximum` refuses it; a try that does not
converge is retried at `reduction` times its size), at most
maximum.tries tries a step and maximum.number accepted steps. No
checkpoints and no stop time (timestepper.F90:1233-1475)."""

from __future__ import annotations


def expected_sizes(episode: dict, outcomes) -> list:
    """The size of every try, given outcomes [(converged, iterations)]
    of the tries so far; one entry per outcome."""
    adapt = episode.get("adapt", {}) or {}
    adapt_on_input = bool(adapt.get("on", False))
    amin = float(adapt.get("minimum", 5.0))
    amax = float(adapt.get("maximum", 8.0))
    reduction = float(adapt.get("reduction", 0.2))
    amplification = float(adapt.get("amplification", 2.0))
    maximum = episode.get("maximum", {}) or {}
    max_size = float(maximum.get("size", 0.0) or 0.0)
    max_steps = int(maximum.get("number", 100))
    size = float(episode["size"])

    adaptor_on = False
    fixed = not adapt_on_input
    taken = 0
    nxt = size
    sizes = []
    for converged, its in outcomes:
        dt = nxt
        sizes.append(dt)
        final = max_steps <= taken + 1
        if converged:
            if final:
                status = "final"
            elif adaptor_on or not fixed:
                status = ("increase" if its < amin
                          else "reduce" if its > amax else "ok")
            else:
                status = "ok"
        else:
            status = "not converged"
        if adaptor_on or (status in ("reduce", "not converged")):
            adaptor_on = True
            if status == "increase":
                accepted, nxt = True, dt * amplification
                if max_size > 0:
                    nxt = min(nxt, max_size)
            elif status in ("reduce", "not converged"):
                accepted, nxt = False, dt * reduction
            else:
                accepted, nxt = True, dt
            if fixed and nxt >= size:
                adaptor_on, nxt = False, size
        elif fixed:
            accepted, nxt = True, size
        else:
            adaptor_on = True
            accepted, nxt = True, dt
            if status == "increase":
                nxt = dt * amplification
                if max_size > 0:
                    nxt = min(nxt, max_size)
        if accepted:
            taken += 1
    return sizes
