"""The numbers that decide ``correct``, and their limits.

Analysis cells (the catalogue and the resident search):

* ``table_gap``: the widest gap between a peak table entry (or the
  "rotated by 0" aux value) of the program and of the reference, over
  every file, channel and angle the window analysed, as a share of the
  reference's largest entry for that channel;
* ``input_peak_gap``: the widest gap between the program's angle-0 table
  entry and the reference's, as a share of the reference's, over every
  file and channel.  That entry is the raw input peak (the CLI's
  ``cli/phase-rotate.cc:413-414``), an abs-max of samples that float32
  holds exactly at 16 and at 24 bits (each an integer over a power of
  two), so a program that reads the samples at the configuration's depth
  reads exactly 0.  The limit is 0, as for any exact comparison: one
  float32 step of the entry is 2^-24 of it or more, and a read one grid
  coarser (24-bit masters read as 16-bit) misses by up to 2^-16 of full
  scale, well inside ``table_gap``'s limit;
* ``angle_regret``: for every file and channel, how much higher the
  reference's peak is at the program's chosen angle than at its own
  choice, as a share of the latter; 1 where the two choose the same angle
  but unwrap it differently, or disagree on whether a minimum was found.

Serving cells:

* ``audio_gap``: the widest gap between a served sample and the
  reference's, over every block of every session, as a share of that
  session channel's reference peak;
* ``level_gap``: the widest gap between a meter level the daemon sent and
  the reference's, over every block, channel and field, as a share of
  that field's largest reference value in the session.

PERF.md gives the readings each limit was set from."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from reference.dsp import MAXSAMPLE

LIMITS = {
    "table_gap": 1e-4,
    "input_peak_gap": 0.0,
    "angle_regret": 1e-4,
    "audio_gap": 1e-4,
    "level_gap": 1e-4,
}


def checks(values: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": float(v), "limit": LIMITS[k]}
            for k, v in values.items()}


def passed(checked: Dict[str, dict]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checked.values())


def _worst(a: float, b: float) -> float:
    """The larger of two readings; a reading that is not a number is the
    worst of all."""
    return max(a, b) if np.isfinite(b) else np.inf


def analysis_numbers(rows: List[dict], ref: Dict[object, dict]
                     ) -> Dict[str, float]:
    """``rows``: the program's answers, each {key, table (C, A), rot0 (C,),
    units [C], found [C]}; ``ref``: the reference's per key."""
    gap = 0.0
    peak_gap = 0.0
    regret = 0.0
    for r in rows:
        R = ref[r["key"]]
        tp = np.asarray(r["table"], np.float64)
        tr = np.asarray(R["table"], np.float64)
        for c in range(tr.shape[0]):
            scale = max(float(tr[c].max()), 1e-30)
            d = float(np.max(np.abs(np.append(
                tp[c] - tr[c], float(r["rot0"][c]) - float(R["rot0"][c])))))
            gap = _worst(gap, d / scale)
            peak_gap = _worst(peak_gap, abs(float(tp[c, 0]) - float(
                tr[c, 0])) / max(float(tr[c, 0]), 1e-30))
            up, ur = int(r["units"][c]), int(R["units"][c])
            if bool(r["found"][c]) != bool(R["found"][c]):
                regret = max(regret, 1.0)
            elif up % MAXSAMPLE == ur % MAXSAMPLE:
                regret = max(regret, 0.0 if up == ur else 1.0)
            else:
                base = max(float(tr[c, ur % MAXSAMPLE]), 1e-30)
                regret = _worst(regret, abs(
                    float(tr[c, up % MAXSAMPLE]) - base) / base)
    return {"table_gap": gap, "input_peak_gap": peak_gap,
            "angle_regret": regret}


def serving_numbers(sessions: List[dict]) -> Dict[str, float]:
    """``sessions``: each {out (C, N) served, ref (C, N), levels (B, C, 9)
    received, ref_levels (B, C, 9)}."""
    audio = 0.0
    level = 0.0
    for s in sessions:
        out = np.asarray(s["out"], np.float64)
        ref = np.asarray(s["ref"], np.float64)
        for c in range(ref.shape[0]):
            scale = max(float(np.abs(ref[c]).max()), 1e-30)
            audio = _worst(audio, float(
                np.abs(out[c] - ref[c]).max()) / scale)
        lv = np.asarray(s["levels"], np.float64)
        lr = np.asarray(s["ref_levels"], np.float64)
        if lv.shape != lr.shape:
            level = np.inf
            continue
        scale = np.maximum(np.abs(lr).max(axis=0), 1e-30)  # (C, 9)
        level = _worst(level, float((np.abs(lv - lr) / scale).max()))
    return {"audio_gap": audio, "level_gap": level}
