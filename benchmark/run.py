"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a run with a profiled
sub-window.  The run needs as many CUDA cards as the cell asks for and
exits with code 2, printing no result, without them; with code 3 if JAX
or the JAX package was loaded.  Build and kernel caches stay inside the
checkout.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    nothing loads JAX through a library."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()
    sys.path[0] = str(ROOT)  # the checkout, not the script's folder
    import torch

    from benchmark import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    chips = harness.find_workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA card(s); torch sees {have}",
              file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(chips)]
    line, checks = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                    root=ROOT, devices=devices, t_process=T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False))  # a NaN is a broken run, not a number
    return 0


if __name__ == "__main__":
    sys.exit(main())
