"""The command line (counterpart of waiwera_tpu/cli.py and
waiwera.F90): reads a JSON model file, builds the simulation, runs the
timestepper, writes HDF5 output and a YAML log.

Usage: python -m waiwera_tpu_torch.cli model.json [--device cpu]
       [--devices N]

The run takes the CUDA device unless --device names another; without a
CUDA device and without --device it raises. --devices N runs the model
domain-decomposed over N ranks (the reference's mpiexec -np N): one
CUDA device per rank, or N CPU ranks with --device cpu. The HDF5
output is written by utils/hdf5.py (no h5py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _apply_overrides(config: dict, overrides):
    """Layer `path.to.key=value` command-line overrides onto the JSON
    config — the analogue of the reference's PETSc option database
    over JSON (waiwera.F90:75-84, SNES/KSPSetFromOptions). Values are
    parsed as JSON literals, falling back to strings."""
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"--set expects path=value, got {item!r}")
        path, _, raw = item.partition("=")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        keys = path.split(".")
        d = config
        for k in keys[:-1]:
            nxt = d.get(k)
            if not isinstance(nxt, dict):
                nxt = {}
                d[k] = nxt
            d = nxt
        d[keys[-1]] = value


def _profiled(run, profile_dir: str):
    """run() under torch.profiler (CPU and, where there is one, CUDA
    activity), with a Chrome trace written into profile_dir (the
    reference's -log_view analogue; open it in chrome://tracing or
    Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        run()
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def run_json(filename: str, echo_log: bool = False, device=None,
             num_devices: int = 0, overrides=None, profile_dir=None,
             devices=None):
    """Load a JSON model file and run it. Returns the Timestepper, or
    for a run over several ranks rank 0's RunSummary.

    device: None takes the CUDA device (an error where there is none),
    "cpu" runs on the CPU. num_devices > 1 (or config["parallel"]
    ["devices"] > 1 when num_devices is 0) runs domain-decomposed over
    that many ranks (parallel/launch.py): one CUDA card each, an error
    where there are fewer cards, or CPU ranks with device "cpu";
    devices= names each rank's device (a card may repeat). Rank 0
    writes the HDF5 output and the YAML log. overrides: list of
    "path.to.key=value" strings layered over the JSON before anything
    reads it.
    """
    config, out_filename, log_filename = _prepare(filename, overrides)
    cfg_devices = int((config.get("parallel", {}) or {}).get("devices", 1))
    eff_devices = num_devices if num_devices else cfg_devices
    if eff_devices > 1:
        from waiwera_tpu_torch.parallel import launch
        from waiwera_tpu_torch.parallel.comm import resolve_devices

        devs = resolve_devices(eff_devices, device, devices)
        return launch.run(_run_rank, devs, config, out_filename,
                          log_filename, echo_log, profile_dir)[0]
    return _run(config, out_filename, log_filename, echo_log, device,
                profile_dir)


def _prepare(filename: str, overrides):
    """(config, output file name, log file name or None) of a JSON model
    file, with the overrides applied and the mesh and restart file
    names made relative to the JSON file."""
    base = os.path.dirname(os.path.abspath(filename))
    with open(filename) as f:
        config = json.load(f)
    _apply_overrides(config, overrides)

    mesh_cfg = config.get("mesh")
    if isinstance(mesh_cfg, str):
        config["mesh"] = os.path.join(base, mesh_cfg)
    elif isinstance(mesh_cfg, dict) and "filename" in mesh_cfg:
        mesh_cfg["filename"] = os.path.join(base, mesh_cfg["filename"])
    ic = config.get("initial")
    if isinstance(ic, dict) and ic.get("filename"):
        ic["filename"] = os.path.join(base, ic["filename"])

    ocfg = config.get("output", {}) or {}
    out_filename = ocfg.get(
        "filename",
        os.path.splitext(os.path.basename(filename))[0] + ".h5",
    )
    if not os.path.isabs(out_filename):
        out_filename = os.path.join(os.getcwd(), out_filename)

    lcfg = config.get("logfile", {}) or {}
    log_filename = None
    if lcfg.get("filename") or lcfg == {}:
        log_filename = lcfg.get(
            "filename",
            os.path.splitext(out_filename)[0] + ".yaml",
        )
    return config, out_filename, log_filename


def _run(config, out_filename, log_filename, echo_log, device, profile_dir,
         comm=None):
    """Build the simulation of `config` and run its timestepper; over
    ranks (comm given) the global simulation is built on the CPU and
    run through DistributedSimulation, and ranks other than 0 write no
    output and no log."""
    from waiwera_tpu_torch.sim.output import HDF5Output
    from waiwera_tpu_torch.sim.simulation import Simulation
    from waiwera_tpu_torch.sim.timestepper import Timestepper
    from waiwera_tpu_torch.utils.config import TrackedConfig
    from waiwera_tpu_torch.utils.logging import Logger

    lcfg = config.get("logfile", {}) or {}
    writer = comm is None or comm.rank == 0
    # default-value tracking on every config read (fson_mpi.F90:18-56)
    config = TrackedConfig(config)
    if comm is None:
        sim = Simulation(config, device=device)
    else:
        from waiwera_tpu_torch.parallel.spmd import (
            DistributedSimulation,
            NullOutput,
        )

        sim = DistributedSimulation(Simulation(config, device="cpu"), comm)
    logger = Logger(
        filename=log_filename if writer else None,
        echo=writer and (echo_log or bool(lcfg.get("echo"))),
    )
    try:
        output = HDF5Output(out_filename, sim) if writer else NullOutput(sim)
        try:
            ts = Timestepper(config, sim, output=output, logger=logger)
            config.defaults.log_to(logger)
            if profile_dir:
                _profiled(ts.run, os.path.join(profile_dir, f"rank{comm.rank}")
                          if comm is not None else profile_dir)
            else:
                ts.run()
        finally:
            output.close()
    finally:
        logger.close()
    return ts


class RunSummary:
    """What a run over ranks returns to the caller: whether it aborted,
    its final time and steps, and rank 0's Timestepper counts."""

    def __init__(self, ts):
        self.aborted = ts.aborted
        self.final_time = ts.final_time
        self.taken = ts.taken
        self.stats = ts.stats


def _run_rank(comm, config, out_filename, log_filename, echo_log,
              profile_dir):
    ts = _run(config, out_filename, log_filename, echo_log, comm.device,
              profile_dir, comm=comm)
    return RunSummary(ts)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="waiwera-torch",
        description="Geothermal flow simulator on PyTorch and CUDA",
    )
    parser.add_argument("filename", help="JSON model input file")
    parser.add_argument(
        "-v", "--version", action="version",
        version="waiwera_tpu_torch 0.1.0",
    )
    parser.add_argument(
        "--echo-log", action="store_true", help="echo log to stdout"
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA device; cpu on request)",
    )
    parser.add_argument(
        "--devices", type=int, default=0,
        help="run domain-decomposed over N ranks (like mpiexec -np N): "
        "one CUDA device each, or N CPU ranks with --device cpu",
    )
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler Chrome trace of the run to "
        "DIR/trace.json (the -log_view analogue)",
    )
    parser.add_argument(
        "--set", action="append", default=[], metavar="PATH=VALUE",
        help="override a JSON config entry, e.g. "
        "--set time.step.size=1e4 (the PETSc command-line option "
        "layering analogue)",
    )
    args = parser.parse_args(argv)
    ts = run_json(args.filename, echo_log=args.echo_log,
                  device=args.device, num_devices=args.devices,
                  overrides=args.set, profile_dir=args.profile)
    return 0 if not ts.aborted else 1


if __name__ == "__main__":
    sys.exit(main())
