"""The readings a cell's limits are set from, many seeds in one process:

    python3 -m port_bench.calibrate --workload <cell> --seeds 11,12,13 \
        [--mode program|control|<fault>] [--seconds 5]

``program`` runs the cell as ``port_bench.run`` does (a short window at the
cell's own load; the check as in every run); ``control`` puts the reference
in the program's place one precision down (the networks in fp8,
``reference.precision.FP8``; the flow held in bfloat16, ``reference.flow
.BF16``; the fusion in bfloat16); a fault name (the cell's model plug-in's
``FAULTS`` of the mix's kind) plants that fault in the program. Prints
one JSON line per seed with the numbers compared, then one with each
number's largest and smallest reading. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from .harness.core import execute, power_limit
from .harness.registry import Registry


def plant(registry: Registry, workload: str, mode: str):
    """``execute``'s (mode, fault) for ``--mode``: ``program`` and
    ``control`` as they are, a fault of the cell's model plug-in for the
    mix's kind planted in the program; any other name raises, naming the
    faults there are."""
    if mode in ("program", "control"):
        return mode, None
    w = registry.workload(workload)
    kind = registry.traffic(w["traffic"])["kind"]
    faults = getattr(registry.model_of(w["config"]), "FAULTS", {}).get(kind, {})
    if mode not in faults:
        raise ValueError(f"no fault {mode!r} for {workload} (kind {kind!r}); its model's "
                         f"faults are {sorted(faults)}, or give 'program' or 'control'")
    return "program", faults[mode]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    registry = Registry()
    mode, fault = plant(registry, args.workload, args.mode)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    readings = []
    print(json.dumps({"device": power_limit(), "workload": args.workload, "mode": args.mode}),
          flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = execute(registry, args.workload, seed, args.seconds, False, "cuda", t0,
                      mode=mode, fault=fault)
        rec = out["record"]
        readings.append(rec.numbers)
        print(json.dumps({"seed": seed, "numbers": rec.numbers, "done": rec.done,
                          "metrics": out["result"]["metrics"], "check_s": rec.check_s,
                          "notes": rec.notes,
                          "s": time.perf_counter() - t0}), flush=True)
        del out, rec
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    keys = readings[0].keys()
    print(json.dumps({"mode": args.mode,
                      "max": {k: max(r[k] for r in readings) for k in keys},
                      "min": {k: min(r[k] for r in readings) for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
