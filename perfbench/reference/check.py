"""The comparison that decides `correct`: the program's answers judged
by the plain reference of the cell's configuration.

The reference (the configuration's `reference(model, device, dtype)`,
perfbench/reference/flow.py for the wge box) is written from Waiwera's
formulation and imports nothing of the program. It builds its own
model from the same JSON and reads the program's accepted states, its
try sequence and its output files only to judge them. It cannot run
Newton on the cell's whole mesh, so it judges each sampled step from
the program's previous accepted state; the first step of the first
episode starts from the initial state that the reference builds
itself.

Numbers compared, each with its limit (the workload's `limits`):
- residual: the largest scaled backward-Euler residual
  max_i |r_i| / max(|L0_i|, 1) over the sampled accepted steps, where
  r = L(y1) - L(y0) - dt R(y1) per unit volume is the reference's at
  the program's states y0 and y1 (Newton's own test,
  timestepper.F90:1898-1951): thermodynamics, flows, sources and the
  accepted state that Newton-Krylov returned;
- records: the largest gap, relative to each dataset's largest
  magnitude, between what the output files hold and what the reference
  computes from the same states: the cell fields at each judged
  episode's end, and the source fields of that end and, where the cell
  writes them every step, of the sampled steps;
- steps: the tries whose step size differs from a plain replay of
  Waiwera's step-size control (reference/adaptor.py), plus every
  complete episode that did not accept its number of steps.

With `control`, the reference computed in float32 (the precision below
the float64 that the configuration states for the state and the
residual) stands in the program's place: float32 states and records.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from perfbench.reference import adaptor, hdf5

# integer datasets that name a source rather than measure it
ID_FIELDS = ("source_natural_cell_index", "source_component")
ATOL = 1.0  # Newton's function tolerance floor (timestepper.F90)


def _gap(prog, ref) -> float:
    prog = np.asarray(prog, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    if prog.shape != ref.shape or not np.all(np.isfinite(prog)):
        return math.inf
    if ref.size == 0:
        return 0.0
    scale = float(np.max(np.abs(ref)))
    diff = float(np.max(np.abs(prog - ref)))
    if scale == 0.0:
        return 0.0 if diff == 0.0 else math.inf
    return diff / scale


def _read_group(path, group) -> dict:
    with hdf5.File(path, "r") as f:
        if group not in f:
            return {}
        g = f[group]
        return {k: np.asarray(g[k][...]) for k in g.keys()
                if k not in ID_FIELDS}


class Judge:
    def __init__(self, cfg_mod, model: dict, device, control: bool):
        self.ref = cfg_mod.reference(model, device, torch.float64)
        self.low = (cfg_mod.reference(model, device, torch.float32)
                    if control else None)
        self.n = self.ref.n
        self.device = self.ref.device

    def _dev(self, a, dtype=None):
        return torch.as_tensor(a).to(device=self.device, dtype=dtype)

    def _state(self, y, region):
        y = self._dev(y, torch.float64)[:self.n]
        region = self._dev(region, torch.int64)[:self.n]
        if self.low is not None:
            y = y.to(torch.float32).to(torch.float64)
        return y, region

    def scaled_residual(self, s: dict) -> float:
        if s["first"]:
            y0, region0 = self.ref.initial_state()
        else:
            y0 = self._dev(s["y0"], torch.float64)[:self.n]
            region0 = self._dev(s["region0"], torch.int64)[:self.n]
        y1, region1 = self._state(s["y1"], s["region1"])
        r, L0, bad = self.ref.residual(y1, region1, y0, region0,
                                       float(s["dt"]))
        if bool(torch.any(bad)):
            return math.inf
        val = torch.max(torch.abs(r) / torch.clamp_min(torch.abs(L0), ATOL))
        return float(val) if bool(torch.isfinite(val)) else math.inf

    def records(self, kind: str, y, region) -> tuple:
        """(the reference's fields, the fields in the program's place
        under the control or None) of one state."""
        y64, region = self._state(y, region)
        want = getattr(self.ref, kind)(y64, region)
        if self.low is None:
            return want, None
        return want, getattr(self.low, kind)(y64.to(torch.float32), region)

    @staticmethod
    def compare(got: dict, want: dict, control: dict | None, row):
        """The largest gap over the datasets of a file, and how many;
        inf where the file lacks a dataset, or holds one that the
        reference cannot compute."""
        gap, count = 0.0, 0
        for name, values in got.items():
            if name not in want:
                return math.inf, count
            if values.ndim < 2 or values.shape[0] <= row:
                return math.inf, count
            exp = want[name].detach().cpu().numpy()
            prog = (values[row] if control is None
                    else control[name].detach().cpu().numpy())
            gap = max(gap, _gap(prog, exp))
            count += 1
        return gap, count


def judge(cfg_mod, model: dict, workload: dict, samples: list,
          episodes: list, device, control: bool = False, log=None) -> dict:
    """{name: (value, limit)} for the run."""
    limits = workload["limits"]
    j = Judge(cfg_mod, model, device, control)

    worst = 0.0
    for s in samples:
        worst = max(worst, j.scaled_residual(s))

    gap, compared = 0.0, 0
    for ep in episodes:
        if ep.get("end_file") is None:
            continue
        for group, kind in (("cell_fields", "cell_fields"),
                            ("source_fields", "source_fields")):
            got = _read_group(ep["end_file"], group)
            want, ctl = j.records(kind, ep["final_y"], ep["final_region"])
            if not got and any(v.numel() for v in want.values()):
                gap = math.inf  # the output left out what it holds
                continue
            g, c = j.compare(got, want, ctl, -1)
            gap, compared = max(gap, g), compared + c
    if workload["output"].get("source_fields") == "step":
        for s in samples:
            ep = episodes[s["episode"]]
            got = _read_group(ep["step_file"], "source_fields")
            want, ctl = j.records("source_fields", s["y1"], s["region1"])
            g, c = j.compare(got, want, ctl, s["step"])
            gap, compared = max(gap, g), compared + c

    wrong = 0
    steps = int(workload["episode"]["maximum"]["number"])
    for ep in episodes:
        sizes = adaptor.expected_sizes(workload["episode"], ep["outcomes"])
        wrong += sum(a != b for a, b in zip(sizes, ep["tried"]))
        wrong += len(sizes) != len(ep["tried"])
        if ep["aborted"] or (ep["complete"] and ep["taken"] != steps):
            wrong += 1
    if log is not None:
        log(f"compared: {len(samples)} accepted steps' residuals, "
            f"{compared} output datasets, "
            f"{sum(len(ep['tried']) for ep in episodes)} tries' sizes",
            file=sys.stderr)
    return {"residual": (worst, limits["residual"]),
            "records": (gap, limits["records"]),
            "steps": (wrong, limits["steps"])}
