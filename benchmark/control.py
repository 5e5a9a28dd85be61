"""Readings of a cell's correctness checks on several seeds, for setting
their limits: the program as the cell runs it, the control (the program
or the reference a precision below: ``--variant int8`` for a serving
cell, ``fp8`` for a training cell) or a planted fault (``--fault``).
One JSON line a run; the benchmark's own runs never run this.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --seconds 10 \\
        [--variant int8|fp8] [--fault token|half_batch|no_update]
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--variant", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--trace", type=int, default=0)
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)  # the checkout, not the script's folder
    import torch

    from benchmark import harness

    devices = [torch.device("cuda", 0)] if torch.cuda.is_available() else [torch.device("cpu")]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        line, _ = harness.run_cell(args.workload, seed, args.seconds, bool(args.trace),
                                   root=ROOT, devices=devices, t_process=t,
                                   variant=args.variant, fault=args.fault)
        print(json.dumps({"seed": seed, "variant": args.variant, "fault": args.fault,
                          "s": time.perf_counter() - t, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
