"""Adaptive implicit timestepper (counterpart of
waiwera_tpu/sim/timestepper.py).

Host-level state machine reproducing timestepper.F90: backward Euler /
BDF2 / direct steady state methods, fixed step-size sequences with
fall-over to adaptive stepping, iteration/change step-size monitors,
the retry ladder (dt x reduction on nonconvergence, up to max tries),
checkpoints at exact output times, and stop criteria. Each timestep try
is one call of the simulation's step function (Newton + Krylov +
transitions on the simulation's device); times and step sizes are
Python floats, in f64 and in the JAX package's order of operations, so
that the two packages take the same tries.

After each converged try the tracers' auxiliary linear problem is
solved (sim/tracer.py); with rock controls each try runs on the rock at
its end time (Simulation.rock_for).

The loop itself crosses to the host once per try (the residual norm and
its location for the log), once per accepted step under the `change`
monitor, and once per written output field; Timestepper.stats counts
these beside the step function's own syncs, and the tracer solves'
syncs, iterations and seconds. Under a profiler each try is the span
timestepper.try and each output record timestepper.output
(utils/spans.py).
"""

from __future__ import annotations

import time as _walltime
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from waiwera_tpu_torch.solver.newton import NewtonParams
from waiwera_tpu_torch.utils.logging import Logger
from waiwera_tpu_torch.utils.spans import span

# timestep statuses (timestepper.F90:33-44)
OK = "OK"
NOT_CONVERGED = "not converged"
TOO_SMALL = "increase"
TOO_BIG = "reduce"
ABORTED = "aborted"
FINAL = "final"
RESTORE = "restore"


def _identity(x):
    return x


@dataclass
class Checkpoints:
    """Exact output times (timestepper_checkpoints_type,
    timestepper.F90:95-113,863-968)."""

    times: Optional[np.ndarray] = None
    repeat: int = 1
    tolerance: float = 0.1
    start_time: float = 0.0
    index: int = 0
    repeat_index: int = 1
    repeat_shift: float = 0.0
    done: bool = True
    hit: bool = False
    next_time: float = 0.0
    restore_stepsize: float = 0.0

    def init(self):
        if self.times is None or len(self.times) == 0:
            self.done = True
            return
        self.done = False
        self.tolerance = max(self.tolerance, 1e-6)
        self.repeat_shift = self.times[-1]
        if self.repeat_shift > self.start_time:
            self.repeat_shift -= self.start_time
        self.index = 0
        self.repeat_index = 1
        self.next_time = self.times[0]
        while self.next_time < self.start_time and not self.done:
            self.update()
        self.hit = False

    def check(self, t_end: float, dt: float):
        if self.done:
            self.hit = False
        elif t_end + self.tolerance * dt >= self.next_time:
            self.hit = True
            self.restore_stepsize = dt
        else:
            self.hit = False

    def update(self):
        if not self.done:
            self.index += 1
            if self.index >= len(self.times):
                if 0 < self.repeat <= self.repeat_index:
                    self.done = True
                else:
                    self.repeat_index += 1
                    self.index = 0
            if not self.done:
                self.next_time = (
                    self.times[self.index]
                    + (self.repeat_index - 1) * self.repeat_shift
                )
        self.hit = False


class Timestepper:
    def __init__(self, config: dict, sim, output=None, logger=None):
        self.sim = sim
        self.output = output
        self.log = logger or Logger()
        tcfg = (config.get("time") or {})
        scfg = (tcfg.get("step") or {})

        self.method = str(scfg.get("method", "beuler")).lower()
        self.steady_state = self.method == "directss"

        # stop criteria
        self.stop_time = tcfg.get("stop", None)
        self.start_time = float(tcfg.get("start", 0.0))
        maximum = scfg.get("maximum", {}) or {}
        self.max_steps = maximum.get("number", 100)
        if self.max_steps is None:
            self.max_steps = -1
        self.max_stepsize = float(maximum.get("size", 0.0) or 0.0)
        self.max_tries = int(maximum.get("tries", 10))
        stop_cfg = (scfg.get("stop", {}) or {}).get("size", {}) or {}
        self.stop_min_stepsize = stop_cfg.get("minimum", -1.0) or -1.0
        self.stop_max_stepsize = stop_cfg.get("maximum", -1.0) or -1.0

        # step sizes
        size = scfg.get("size", 0.1)
        if isinstance(size, (list, tuple, np.ndarray)):
            self.sizes = [float(s) for s in size]
        else:
            self.sizes = [float(size)]

        # adaptor (timestepper.F90:77-93)
        acfg = scfg.get("adapt", {}) or {}
        self.adapt_on_input = bool(acfg.get("on", False))
        self.adapt_method = str(acfg.get("method", "iteration")).lower()
        self.adapt_min = float(acfg.get("minimum", 5.0))
        self.adapt_max = float(acfg.get("maximum", 8.0))
        self.adapt_reduction = float(acfg.get("reduction", 0.2))
        self.adapt_amplification = float(acfg.get("amplification", 2.0))

        # nonlinear solver params
        sol = (scfg.get("solver", {}) or {}).get("nonlinear", {}) or {}
        tol = sol.get("tolerance", {}) or {}
        ftol = tol.get("function", {}) or {}
        utol = tol.get("update", {}) or {}
        lin = (scfg.get("solver", {}) or {}).get("linear", {}) or {}
        def opt(d, key, default):
            v = d.get(key, default)
            return default if v is None else v

        self.newton_params = NewtonParams(
            max_iterations=int(
                opt(sol.get("maximum", {}) or {}, "iterations", 8)
            ),
            min_iterations=int(
                opt(sol.get("minimum", {}) or {}, "iterations", 0)
            ),
            function_rtol=float(opt(ftol, "relative", 1e-5)),
            function_atol=float(opt(ftol, "absolute", 1.0)),
            update_rtol=float(opt(utol, "relative", 1e-10)),
            update_atol=float(opt(utol, "absolute", 1.0)),
            linear_method=str(opt(lin, "type", "bcgs")).lower(),
            # default bjacobi, as in the JAX package and unlike the
            # reference's ASM/ILU(0) (timestepper.F90:2019-2022); the
            # bench's preconditioner sweep compares the others.
            # "asm"/"ilu"/"line"/"cpr" select those paths when
            # configured explicitly.
            linear_pc=str(
                opt(lin.get("preconditioner", {}) or {}, "type", "bjacobi")
            ).lower(),
            # linear tolerances / subspace options (reference JSON:
            # time.step.solver.linear.tolerance.relative,
            # .maximum.iterations, .options.gmres.restart —
            # timestepper.F90:1677-1700,1769-1789)
            linear_rtol=float(
                opt(lin.get("tolerance", {}) or {}, "relative", 1e-5)
            ),
            linear_max_iterations=int(
                opt(lin.get("maximum", {}) or {}, "iterations", 1000)
            ),
            linear_restart=int(
                opt(
                    (lin.get("options", {}) or {}).get("gmres", {}) or {},
                    "restart",
                    30,
                )
            ),
            # extension over the reference: precision of the inner
            # Krylov solve and of the Jacobian (the Newton loop stays
            # f64)
            linear_dtype=str(opt(lin, "dtype", "float64")).lower(),
            jacobian_dtype=str(
                opt(lin, "jacobian_dtype", "float64")
            ).lower(),
            # per-iteration monitor (-snes_monitor analogue)
            monitor=bool(opt(sol, "monitor", False)),
        )

        # output config
        ocfg = config.get("output", {}) or {}
        self.output_initial = bool(ocfg.get("initial", True))
        self.output_final = bool(ocfg.get("final", True))
        self.output_frequency = int(ocfg.get("frequency", 1))
        # Jacobian dump for debugging (output.jacobian: true or
        # {"filename": ...}; flow_simulation.F90:309-390 MatView
        # analogue — written at every output time, npz BSR instead of
        # PETSc binary)
        jac_cfg = ocfg.get("jacobian", False)
        self.jacobian_filename = None
        if jac_cfg:
            if isinstance(jac_cfg, dict):
                self.jacobian_filename = jac_cfg.get("filename")
            if not self.jacobian_filename:
                base = getattr(output, "filename", None) or config.get(
                    "title", "waiwera"
                )
                stem = str(base)
                if stem.endswith(".h5"):
                    stem = stem[:-3]
                self.jacobian_filename = stem + "_jacobian.npz"

        # checkpoints
        self.checkpoints = Checkpoints(start_time=self.start_time)
        ccfg = ocfg.get("checkpoint")
        if ccfg:
            rep = ccfg.get("repeat", 1)
            if isinstance(rep, bool):
                rep = -1 if rep else 1
            times = ccfg.get("time")
            if times is None and "step" in ccfg:
                steps = np.asarray(ccfg["step"], dtype=np.float64)
                times = self.start_time + np.cumsum(steps)
            self.checkpoints = Checkpoints(
                times=np.asarray(times, dtype=np.float64),
                repeat=int(rep),
                tolerance=float(ccfg.get("tolerance", 0.1)),
                start_time=self.start_time,
            )
        self.checkpoints.init()

        if self.steady_state:
            self.sizes = [0.0]
            self.max_steps = 1
            self.max_tries = 1
            self.adapt_on_input = False

        self.step_fn = sim.make_step_fn(self.newton_params, self.method)
        # reductions over the ranks of a distributed simulation (the
        # identity on one device), so that every rank takes the same
        # branch
        self._reduce_max = getattr(sim, "reduce_max", _identity)
        self._reduce_any = getattr(sim, "reduce_any", _identity)
        self.tracer_step_fn = (
            sim.make_tracer_step_fn()
            if getattr(sim, "tracers", None) is not None
            and not self.steady_state
            else None
        )

        # runtime state
        self.taken = 0
        self.output_index = 0
        self.stats = self._new_stats()

    @staticmethod
    def _new_stats() -> dict:
        """Counts of one run: tries, Newton and Krylov iterations,
        Krylov matvecs, host syncs inside the step function (`step`)
        and added by this loop (`timestepper`), seconds spent writing
        output, the host-clock seconds of each accepted step, its
        refused tries included, and of the tracer solves (`tracer_*`:
        solves, GMRES iterations of each, host syncs, seconds). The step
        program: "graph" (the try's pieces replayed as CUDA graphs) or
        "eager", chosen from the configuration before the first try
        (sim/simulation.py step_program_mode); the run's graph captures,
        their seconds and replays, the BiCGStab iterations run masked
        and the step's host syncs per try; the tracer step's program
        ("graph" or "eager", sim/simulation.py tracer_program_mode) and
        its graph captures, their seconds and replays (`tracer_graph_*`).
        """
        return {"tries": 0, "newton_iterations": 0, "linear_iterations": 0,
                "matvecs": 0, "masked_krylov_iterations": 0,
                "step_program": "eager", "graph_captures": 0,
                "graph_capture_seconds": 0.0, "graph_replays": 0,
                "host_syncs_per_try": 0.0, "host_syncs_step": 0,
                "host_syncs_timestepper": 0, "output_seconds": 0.0,
                "step_seconds": [], "tracer_iterations": [],
                "tracer_converged": [], "host_syncs_tracer": 0,
                "tracer_seconds": 0.0, "tracer_program": "eager",
                "tracer_graph_captures": 0,
                "tracer_graph_capture_seconds": 0.0,
                "tracer_graph_replays": 0}

    # ------------------------------------------------------------------

    def _monitor(self, num_iterations, lhs_new, lhs_last):
        """Adaptor monitor (timestepper.F90:277-310). The change
        monitor reduces on the device and transfers one scalar."""
        if self.adapt_method == "iteration":
            return float(num_iterations)
        eps = 1e-3
        self.stats["host_syncs_timestepper"] += 1
        return float(self._reduce_max(torch.max(
            torch.abs(lhs_new - lhs_last)
            / torch.clamp_min(torch.abs(lhs_last), eps)
        )))

    @staticmethod
    def _residual_report(res):
        """(max_residual, worst_cell, worst_equation) of a try as Python
        numbers: the three 0-d tensors cross to the host in one
        transfer."""
        vals = (res.max_residual, res.worst_cell, res.worst_equation)
        if all(isinstance(v, torch.Tensor) for v in vals):
            m, c, e = torch.stack(
                [v.to(torch.float64) for v in vals]
            ).cpu().tolist()
        else:
            m, c, e = (float(v) for v in vals)
        return m, int(c), int(e)

    def run(self, max_wall_seconds: Optional[float] = None):
        sim = self.sim
        log = self.log

        # state: last accepted step
        t = self.start_time
        y = sim.y0
        region = sim.region0
        lhs, fluid, err = sim.lhs_at(y, region)
        self.stats = stats_run = self._new_stats()
        stats_run["step_program"] = getattr(self.step_fn, "program_mode",
                                            "eager")
        step_stats = getattr(self.step_fn, "stats", dict)
        graphs0 = step_stats()
        tracer_stats = getattr(self.tracer_step_fn, "stats", dict)
        tracer0 = tracer_stats()
        stats_run["tracer_program"] = getattr(self.tracer_step_fn,
                                              "program_mode", "eager")
        stats_run["host_syncs_timestepper"] += 1
        if bool(self._reduce_any(torch.any(err & ~sim.mesh_dev.is_ghost))):
            raise RuntimeError(
                "initial fluid property evaluation failed (EOS out of "
                "range in some cells)"
            )
        temperature = fluid.temperature
        lhs_last2 = lhs
        # carried face fluxes at the last accepted state: with them
        # (plus lhs/fluid) the step function skips the initial f64 EOS
        # chain of every Newton solve (newton_solve initial=). Sims
        # without initial_fluxes (test doubles) take the classic path.
        fluxes_carr = (
            sim.initial_fluxes(y, region)
            if hasattr(sim, "initial_fluxes")
            else None
        )
        dt_last = self.sizes[0] if self.sizes[0] > 0 else 1.0
        if self.tracer_step_fn is not None:
            aux_x, aux_al = sim.initial_tracer_state()
            aux_x2, aux_al2 = aux_x, aux_al
        else:
            aux_x = None

        self.taken = 0
        self.output_index = 0
        self.tried = []  # (dt, converged) of every try
        self.accepted = []  # (size, time, status) of every accepted step
        since_output = 0
        # simulation statistics (flow_simulation.F90:712-741): DOF
        # distribution + Kumar imbalance, source network counts
        stats = getattr(sim, "dof_statistics", None)
        if stats is not None:
            log.write("info", "simulation", "dof", **stats())
        net = sim.sources
        if net is not None and net.num_sources:
            log.write("info", "simulation", "source",
                      count=net.num_sources)
            if getattr(net, "groups", None):
                log.write("info", "simulation", "network.group",
                          count=len(net.groups))
            if getattr(net, "reinjectors", None):
                log.write("info", "simulation", "network.reinject",
                          count=len(net.reinjectors))
        log.write("info", "timestepper", "start", time=t)
        wall0 = _walltime.time()

        # face fluxes for /face_fields stay on the device, in canonical
        # order, until an output is written
        flux_dev = None
        flux_out = self.output is not None and (
            getattr(self.output, "face_group", None) is not None
        )
        if self.output_initial and self.output is not None:
            if flux_out:
                flux_dev = (fluxes_carr if fluxes_carr is not None
                            else sim.initial_fluxes(y, region))
            self._write_output(t, fluid, t, dt_last, flux_dev, aux_x)

        # fixed-size sequence state (timestepper.F90:1381-1453)
        fixed_index = 0
        adaptor_on = False
        fixed = not self.adapt_on_input
        next_stepsize = self.sizes[0]
        finished = False

        aborted = False
        while not finished:
            # one timestep with retry ladder (timestepper_step :2316)
            accepted = False
            num_tries = 0
            status = OK
            step_wall0 = _walltime.time()
            while not (accepted or finished):
                dt = next_stepsize
                t_try = t + dt
                hit_this_try = False

                # checkpoints (:1282-1301)
                if not self.steady_state:
                    self.checkpoints.check(t_try, dt)
                    if self.checkpoints.hit:
                        dt = self.checkpoints.next_time - t
                        t_try = self.checkpoints.next_time
                        hit_this_try = True

                # check_finished (:1233-1274)
                if self.steady_state:
                    finished = self.taken == 1
                else:
                    if (
                        self.stop_time is not None
                        and t_try + self._termination_tol() * dt > self.stop_time
                    ):
                        dt = self.stop_time - t
                        t_try = self.stop_time
                        finished = True
                    elif (
                        self.stop_min_stepsize > 0
                        and dt <= self.stop_min_stepsize
                    ):
                        finished = True
                    elif (
                        self.stop_max_stepsize > 0
                        and dt >= self.stop_max_stepsize
                    ):
                        finished = True
                    if 0 <= self.max_steps <= self.taken + 1:
                        finished = True

                step_kwargs = {}
                if getattr(self.sim, "rock_controls", None):
                    # pre-try-timestep rock controls at the try's end
                    # time (flow_simulation.F90:2040-2094); the carried
                    # state was computed under the previous rock, so the
                    # fast initial residual is skipped
                    step_kwargs = dict(rock_in=self.sim.rock_for(t_try))
                elif fluxes_carr is not None:
                    step_kwargs = dict(
                        fluid_last=fluid, fluxes_last=fluxes_carr
                    )
                # one try under a profiler (utils/spans.py): the step
                # function, the tracer solve and the residual report
                with span("timestepper.try", lambda: (
                        f"step {self.taken} try {num_tries + 1} dt {dt!r}")):
                    res, new_fluid, lhs_new, fluxes = self.step_fn(
                        y,
                        region,
                        temperature,
                        lhs,
                        lhs_last2,
                        t,
                        dt,
                        dt_last,
                        1.0 if self.taken == 0 else 0.0,
                        **step_kwargs,
                    )
                    num_tries += 1
                    converged = bool(res.converged) and not bool(res.failed)
                    its = int(res.iterations)
                    tres = None
                    if converged and self.tracer_step_fn is not None:
                        # auxiliary (tracer) linear solve of this try
                        # (timestepper.F90:2347-2356); a failure retries the
                        # step like a nonlinear failure
                        tr_wall0 = _walltime.time()
                        tres = self.tracer_step_fn(
                            new_fluid, fluxes, aux_x, aux_al, aux_x2, aux_al2,
                            t, t_try, dt, dt_last,
                            1.0 if self.taken == 0 else 0.0,
                            self.method == "bdf2",
                        )
                        stats_run["tracer_seconds"] += (_walltime.time()
                                                        - tr_wall0)
                        stats_run["tracer_iterations"].append(tres.iterations)
                        stats_run["tracer_converged"].append(tres.converged)
                        stats_run["host_syncs_tracer"] += tres.host_syncs
                        if not tres.converged:
                            log.write("warn", "tracer_solver", "not_converged",
                                      iterations=int(tres.iterations))
                            converged = False
                    max_residual, worst_cell, worst_equation = (
                        self._residual_report(res)
                    )
                stats_run["tries"] += 1
                stats_run["newton_iterations"] += its
                stats_run["linear_iterations"] += int(res.linear_iterations)
                stats_run["matvecs"] += int(getattr(res, "matvecs", 0))
                stats_run["masked_krylov_iterations"] += int(
                    getattr(res, "masked_iterations", 0))
                stats_run["host_syncs_step"] += int(
                    getattr(res, "host_syncs", 0)
                )
                stats_run["host_syncs_timestepper"] += 1
                self.tried.append((float(dt), converged))
                log.write(
                    "info" if converged else "warn",
                    "nonlinear_solver",
                    "end",
                    converged=converged,
                    iterations=its,
                    linear_iterations=int(res.linear_iterations),
                    max_residual=max_residual,
                    # worst-residual location in natural cell order
                    # (SNES_monitor parity, timestepper.F90:1855-1894)
                    worst_cell=worst_cell,
                    worst_equation=worst_equation,
                )

                # set_current_status (:1305-1376)
                if self.steady_state:
                    status = FINAL if converged else ABORTED
                    finished = True
                    accepted = converged
                    if not converged:
                        aborted = True
                    break
                if converged:
                    if finished and status != ABORTED:
                        status = FINAL
                    elif hit_this_try:
                        status = RESTORE
                    else:
                        eta = self._monitor(its, lhs_new, lhs)
                        adapt_active = adaptor_on or (
                            fixed_index == len(self.sizes) - 1 and not fixed
                        )
                        if adapt_active:
                            if eta < self.adapt_min:
                                status = TOO_SMALL
                            elif eta > self.adapt_max:
                                status = TOO_BIG
                            else:
                                status = OK
                        else:
                            status = OK
                else:
                    if num_tries >= self.max_tries:
                        status = ABORTED
                        finished = True
                        aborted = True
                    else:
                        status = NOT_CONVERGED
                        finished = False
                    self.checkpoints.hit = False

                # set_next_stepsize (:1414-1453)
                if not self.steady_state and status != ABORTED:
                    accepted, next_stepsize, adaptor_on, fixed_index = (
                        self._next_stepsize(
                            status, dt, adaptor_on, fixed, fixed_index,
                            hit_this_try,
                        )
                    )
                elif status == ABORTED:
                    accepted = False
                if not accepted and status in (
                    NOT_CONVERGED,
                    TOO_BIG,
                ):
                    log.write(
                        "warn",
                        "timestep",
                        "reduction",
                        new_size=next_stepsize,
                    )
                if status == ABORTED:
                    log.write("warn", "timestep", "aborted",
                              num_tries=num_tries)
                    break

            if aborted and not accepted:
                break

            # commit step (timestepper_step :2365-2376)
            if accepted:
                self.taken += 1
                dt_last = float(t_try - t)
                t = float(t_try)
                y = res.y
                region = res.region
                lhs_last2 = lhs
                lhs = lhs_new
                fluid = new_fluid
                if fluxes_carr is not None:
                    fluxes_carr = fluxes
                temperature = new_fluid.temperature
                if tres is not None:
                    aux_x2, aux_al2 = aux_x, aux_al
                    aux_x, aux_al = tres.x, tres.al
                if flux_out:
                    flux_dev = fluxes
                since_output += 1
                self.accepted.append((dt_last, t, status))
                stats_run["step_seconds"].append(
                    _walltime.time() - step_wall0
                )
                log.write(
                    "info",
                    "timestep",
                    "end",
                    tries=num_tries,
                    size=dt_last,
                    time=t,
                    status=status,
                )
                if self.output is not None and (
                    self.checkpoints.hit
                    or since_output == self.output_frequency
                ):
                    self._write_output(t, fluid, t - dt_last, dt_last,
                                       flux_dev, aux_x)
                    self._dump_jacobian(y, region, lhs, t, dt_last)
                    if since_output == self.output_frequency:
                        since_output = 0
                if self.checkpoints.hit:
                    # advance past the hit checkpoint whether or not an
                    # output file is attached: a stale hit flag would
                    # clip every subsequent try to dt = 0
                    self.checkpoints.update()
                if status == FINAL:
                    finished = True

            if max_wall_seconds is not None and bool(self._reduce_any(
                torch.tensor(_walltime.time() - wall0 > max_wall_seconds)
            )):
                log.write("warn", "timestepper", "wall_time_limit")
                break

        if (
            self.output is not None
            and self.output_final
            and since_output > 0
        ):
            self._write_output(t, fluid, t, dt_last, flux_dev, aux_x)
            self._dump_jacobian(y, region, lhs, t, dt_last)
        for k, v in step_stats().items():
            stats_run[k] = v - graphs0[k]
        for k, v in tracer_stats().items():
            stats_run["tracer_" + k] = v - tracer0[k]
        stats_run["host_syncs_per_try"] = (
            stats_run["host_syncs_step"] / max(stats_run["tries"], 1))
        log.write(
            "info",
            "timestepper",
            "end",
            time=t,
            steps=self.taken,
            elapsed_seconds=_walltime.time() - wall0,
        )
        self.final_time = t
        self.final_y = y
        self.final_region = region
        self.final_fluid = fluid
        self.final_tracer = aux_x
        self.aborted = aborted
        return not aborted

    def _dump_jacobian(self, y, region, lhs, t, dt):
        """Binary Jacobian dump for debugging (output.jacobian;
        flow_simulation.F90:2989 MatView analogue). Written as an npz
        of the BSR arrays at the current solution, in natural cell
        order; load with numpy/scipy (sp.bsr_matrix((data, indices,
        indptr))).

        Note: the dump is always the BACKWARD-EULER Jacobian at the
        final (y, dt) — under BDF2/directss it is a diagnostic
        re-linearisation, not the exact matrix the solver last used
        (the BDF2 history weights differ by O(1) on the LHS term)."""
        if self.jacobian_filename is None or dt <= 0.0:
            return
        from waiwera_tpu_torch.solver.system import method_coeffs

        sim = self.sim
        base = getattr(sim, "base", sim)
        if hasattr(sim, "to_global"):
            y, region, lhs = (sim.to_global(a) for a in (y, region, lhs))
        coeffs = method_coeffs("beuler", dt, dt, 0.0, lhs, lhs)
        _, _, _, _, mat = base.system.residual_and_jacobian(
            y, region, base.rock, coeffs, t - dt, t,
        )
        st = mat.structure
        np.savez(
            self.jacobian_filename,
            data=mat.data.detach().cpu().numpy(),
            indices=np.asarray(st.indices),
            indptr=np.asarray(st.indptr),
            num_rows=st.num_rows,
            block_size=st.block_size,
            time=t,
        )

    def _termination_tol(self):
        return 1e-10

    def _next_stepsize(self, status, dt, adaptor_on, fixed, fixed_index,
                       checkpoint_hit):
        """set_next_stepsize + get_next_fixed_stepsize + adapt
        (timestepper.F90:1381-1475)."""

        def adapt(status, dt):
            if status == TOO_SMALL:
                ns = dt * self.adapt_amplification
                if self.max_stepsize > 0:
                    ns = min(ns, self.max_stepsize)
                return True, ns
            if status in (TOO_BIG, NOT_CONVERGED):
                return False, dt * self.adapt_reduction
            return True, dt

        if adaptor_on:
            if checkpoint_hit and status == RESTORE:
                accepted = True
                next_stepsize = self.checkpoints.restore_stepsize
            else:
                accepted, next_stepsize = adapt(status, dt)
            # switch back to fixed stepping if we reach the fixed sizes
            if fixed_index < len(self.sizes) - 1 or (
                fixed_index >= len(self.sizes) - 1 and fixed
            ):
                if next_stepsize >= self.sizes[fixed_index]:
                    adaptor_on = False
                    next_stepsize = self.sizes[fixed_index]
            return accepted, next_stepsize, adaptor_on, fixed_index

        if status in (TOO_BIG, NOT_CONVERGED):
            adaptor_on = True
            accepted, next_stepsize = adapt(status, dt)
            return accepted, next_stepsize, adaptor_on, fixed_index

        # fixed stepping: advance through the size list
        accepted = True
        fixed_index += 1
        if fixed_index < len(self.sizes):
            next_stepsize = self.sizes[fixed_index]
        else:
            fixed_index = len(self.sizes) - 1
            if fixed:
                next_stepsize = self.sizes[fixed_index]
            else:
                adaptor_on = True
                if checkpoint_hit and status == RESTORE:
                    next_stepsize = self.checkpoints.restore_stepsize
                else:
                    accepted, next_stepsize = adapt(status, dt)
        return accepted, next_stepsize, adaptor_on, fixed_index

    def _write_output(self, t, fluid, t0, dt, flux_dev, aux_x=None):
        """One output record at time t: the fluid fields, the tracers,
        the source and network fields over [t0, t0 + dt] and, where flux
        output is on, the face fluxes brought into the host mesh's face
        order."""
        with span("timestepper.output"):
            self._write_record(t, fluid, t0, dt, flux_dev, aux_x)

    def _write_record(self, t, fluid, t0, dt, flux_dev, aux_x):
        w0 = _walltime.time()
        tg = getattr(self.sim, "to_global", None)
        if tg is not None:
            # natural-order global state on every rank (collective)
            fluid = tg(fluid)
            aux_x = None if aux_x is None else tg(aux_x)
        flux_nat = None
        if flux_dev is not None:
            f2g = getattr(self.sim, "flux_to_global", None)
            flux_nat = f2g(flux_dev) if f2g is not None else flux_dev
        self.output.write(self.output_index, t, fluid,
                          self._source_output(fluid, t0, dt, aux_x),
                          tracer=aux_x, fluxes=flux_nat)
        self.output_index += 1
        self.stats["output_seconds"] += _walltime.time() - w0

    def _source_field_config(self):
        """Requested output field lists with reference defaults
        (setup_output.rst; hdf5io datasets named <vec>_<field>)."""
        cfg = (self.sim.config.get("output", {}) or {}).get(
            "fields", {}
        ) or {}
        aslist = lambda v: [v] if isinstance(v, str) else list(v or [])
        return {
            "source": aslist(
                cfg.get(
                    "source",
                    ["natural_cell_index", "component", "rate",
                     "enthalpy"],
                )
            ),
            "network_group": aslist(
                cfg.get(
                    "network_group",
                    ["rate", "enthalpy", "water_rate", "steam_rate"],
                )
            ),
            "network_reinject": aslist(
                cfg.get(
                    "network_reinject",
                    ["overflow_water_rate", "overflow_steam_rate"],
                )
            ),
        }

    def _source_output(self, fluid, t0, dt, aux_x=None):
        """Per-source, group and reinjector output fields
        (flow_simulation.F90:2966-2981: the source, network_group and
        network_reinject vectors viewed into /source_fields). The node
        fields cross to the host in one transfer each."""
        if self.sim.sources is None:
            return None
        from waiwera_tpu_torch.sim.sources import source_flows

        def host(a):
            return a.detach().cpu().numpy()

        net = self.sim.sources
        fields = self._source_field_config()
        src_f = fields["source"]
        collect = {}
        rate, enthalpy = net.flows(fluid, t0, t0 + dt, collect=collect)
        qw, hw, qs, hs = collect.get(
            "separated", (None, None, None, None)
        )
        eos = self.sim.eos
        out = {}
        if "rate" in src_f:
            out["source_rate"] = host(rate)
        if "enthalpy" in src_f:
            out["source_enthalpy"] = host(enthalpy)
        if qw is not None:
            qw, hw, qs, hs = (host(a) for a in (qw, hw, qs, hs))
            tot = np.abs(qw) + np.abs(qs)
            sf = np.where(tot > 0.0, np.abs(qs) / np.where(tot > 0, tot, 1.0), 0.0)
            for nm, v in (
                ("water_rate", qw), ("water_enthalpy", hw),
                ("steam_rate", qs), ("steam_enthalpy", hs),
                ("steam_fraction", sf),
            ):
                if nm in src_f:
                    out["source_" + nm] = v
        comp_wanted = [
            c for c in list(eos.component_names) + ["heat"]
            if f"{c}_flow" in src_f
        ]
        if comp_wanted:
            flow = host(source_flows(
                fluid, net.arrays, rate, enthalpy,
                eos.num_primary_variables, eos.num_components,
                eos.isothermal,
            ))
            names = list(eos.component_names)
            if not eos.isothermal:
                names.append("heat")
            for k, c in enumerate(names):
                if f"{c}_flow" in src_f:
                    out[f"source_{c}_flow"] = flow[:, k]
        if aux_x is not None and self.sim.tracers is not None:
            # tracer flows at sources (flow_simulation.F90
            # source_update_tracer_flow): production carries the cell's
            # tracer mass fraction by the tracer phase's flow fraction;
            # injection the specified injection rate
            tr = self.sim.tracers
            cells = net.arrays.cell
            pidx = tr._on(rate)[0]
            frac = fluid.phase_flow_fractions()[cells][:, pidx]
            q = rate[:, None]
            inj = net.tracer_injection(t0, t0 + dt, like=rate)
            out["source_tracer_flow"] = host(
                torch.where(q < 0, aux_x[cells] * frac * q, inj))
        # source network group and reinjector node fields
        groups = collect.get("group", {})
        if groups and getattr(net, "groups", None):
            gf = fields["network_group"]
            names = ("rate", "enthalpy", "water_rate", "water_enthalpy",
                     "steam_rate", "steam_enthalpy")
            vals = host(torch.stack([
                torch.stack([nf.q, nf.h, nf.qw, nf.hw, nf.qs, nf.hs])
                for nf in (groups[g.name] for g in net.groups)
            ]))  # [groups, 6]
            per = {nm: vals[:, k] for k, nm in enumerate(names)}
            tot = np.abs(per["water_rate"]) + np.abs(per["steam_rate"])
            per["steam_fraction"] = np.where(
                tot > 0, np.abs(per["steam_rate"]) / np.where(tot > 0, tot,
                                                              1.0), 0.0)
            for nm in gf:
                if nm in per:
                    out["network_group_" + nm] = per[nm]
        rein = collect.get("reinject", {})
        if rein and getattr(net, "reinjectors", None):
            rf = [nm for nm in fields["network_reinject"]
                  if nm in rein[net.reinjectors[0].name]]
            if rf:
                vals = host(torch.stack([
                    torch.stack([rein[r.name][nm] for nm in rf])
                    for r in net.reinjectors
                ]))  # [reinjectors, fields]
                for k, nm in enumerate(rf):
                    out["network_reinject_" + nm] = vals[:, k]
        return out
