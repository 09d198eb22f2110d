"""The readings that set a cell's limits, on the chip at the cell's size.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 \\
        --control-seeds 11,12,13 --seconds <s>

For each seed, one run of the cell as ``run.py`` makes it (its own
weights and traffic, a window of ``--seconds``, the same sample) prints
the program's ``gap`` and ``logit_err``; for each control seed, also the
control's: the reference computed with float8 operands in the program's
place. All seeds run in one process, one JSON line each. The benchmark's
own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")   # as run.py
    import torch

    from bench import core, harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = core.Cell(core.load_spec(ROOT), args.workload, ROOT)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        result, checked, _, info = harness.run_cell(
            cell, seed, args.seconds, False, "cuda", time.time(),
            controls=("fp8",) if seed in controls else ())
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program": {k: v["value"] for k, v in checked.items()},
            "control": info["control"], "check_s": info["check_s"],
            "tasks": result["attempted"], "sample": info["sample"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "peak_bytes": result["device"]["memory_peak_bytes"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
