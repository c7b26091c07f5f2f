"""Faults planted in the program on purpose, for the benchmark's tests and
the calibration of its limits: each must make ``correct`` come out false.

Serving (planted in the daemon's process):

* ``state_unchanged``: the broker's step returns the engine state it was
  given, so no session's history ever advances;
* ``half_batch``: the broker's step runs only the first half of its
  slots, the others get silence;
* ``altered_answer``: every served block has its first sample moved by
  0.25 where the session produces it.

Analysis (planted in this process):

* ``half_batch``: the search sweeps the first half of a batch's files and
  hands back nothing for the rest;
* ``altered_answer``: every chosen angle moves by 45 degrees where the
  selection produces it."""

from __future__ import annotations

from .trace import Patches

SERVING = ("state_unchanged", "half_batch", "altered_answer")
ANALYSIS = ("half_batch", "altered_answer")


def plant_serving(name: str, patches: Patches) -> None:
    from phaserotate_tpu_torch import bridge
    from phaserotate_tpu_torch.stream import broker

    step = broker._slot_step
    if name == "state_unchanged":
        def stuck(state, *a, **kw):
            return state, step(state, *a, **kw)[1]

        patches.set(broker, "_slot_step", stuck)
    elif name == "half_batch":
        def half(state, frames, targets, active, reset, geom):
            active = active.clone()
            active[active.shape[0] // 2 :] = False
            return step(state, frames, targets, active, reset, geom)

        patches.set(broker, "_slot_step", half)
    elif name == "altered_answer":
        process = bridge._Session.process

        def altered(self, *a, **kw):
            out, levels, states = process(self, *a, **kw)
            out = out.copy()
            out[0] += 0.25
            return out, levels, states

        patches.set(bridge._Session, "process", altered)
    else:
        raise ValueError(f"unknown serving fault {name!r}")


def plant_analysis(name: str, patches: Patches) -> None:
    import torch

    from phaserotate_tpu_torch import fleet
    from phaserotate_tpu_torch.search import minimize, sweep

    if name == "half_batch":
        impl = sweep._sweep_impl

        def half(x, geom, chunk):
            if x.dim() < 3:
                return impl(x, geom, chunk)
            k = max(1, x.shape[0] // 2)
            peaks, rot0 = impl(x[:k].contiguous(), geom, chunk)
            pad = (x.shape[0] - k,) + tuple(peaks.shape[1:])
            return (torch.cat([peaks, peaks.new_zeros(pad)]),
                    torch.cat([rot0, rot0.new_zeros(pad[:-1])]))

        patches.set(sweep, "_sweep_impl", half)
    elif name == "altered_answer":
        select = minimize.select_min_peak_angles_batch

        def altered(*a, **kw):
            res = select(*a, **kw)
            for r in res:
                r.angles_units = [u + 90 for u in r.angles_units]
            return res

        patches.set(fleet, "select_min_peak_angles_batch", altered)
        patches.set(minimize, "select_min_peak_angles_batch", altered)
    else:
        raise ValueError(f"unknown analysis fault {name!r}")
