"""The knee of an open-loop serving cell: the highest Poisson rate whose
backlog does not grow over the window.  Builds the cell's engine once,
then offers each rate for ``--seconds``, drains, and prints one JSON line
a rate: tokens/s, TTFT percentiles, and the requests waiting at each
quarter of the window.  The cell's traffic file then takes 0.8 of the
knee as a number; the benchmark's own runs never run this.

    python3 benchmark/knee.py --workload dense-chat --rates 4,6,8,10 --seconds 30
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)  # the checkout, not the script's folder
    import torch

    from benchmark import harness, traffic as tr, weights

    _, w, cell, config, traffic = harness.load_cell(ROOT, args.workload)
    run = harness.Run(name=args.workload, bench=w, cell=cell, config=config, traffic=traffic,
                      seed=args.seed, seconds=args.seconds, trace=False,
                      devices=[torch.device("cuda", 0)], t_process=time.perf_counter())
    serve = harness.load_module(ROOT / "benchmark" / "drivers" / "serve.py", "bench_knee_serve")
    m = run.model
    engine = serve.build_engine(run, weights.make_params(m, args.seed, run.device))
    for r in tr.requests(traffic, 1.0, args.seed + 1, m["vocab"])[:4]:
        engine.submit(list(r.prompt), min(r.budget, 4))
    engine.run()
    for i, rate in enumerate(float(x) for x in args.rates.split(",")):
        t = {**traffic, "arrivals": {"kind": "poisson", "rate_per_s": rate}}
        loop = serve.Loop(engine, tr.requests(t, args.seconds, args.seed + 10 + i, m["vocab"]),
                          t["arrivals"], detail=False)
        t0 = time.perf_counter()
        end = t0 + args.seconds
        depth, pending = [], []
        for q in (0.25, 0.5, 0.75, 1.0):
            loop.run(t0, t0 + q * args.seconds, None)
            depth.append(engine.queue_depth)
            pending.append(engine.pending)
        loop.drain(time.perf_counter() + 120)
        sent = loop.sent
        toks = sum(t <= end for _, q in sent for t in serve._token_times(q))
        ttft = [q.first_token_at - due for due, q in sent if q.tokens]
        admit = [tk for tk in loop.ticks]
        print(json.dumps({
            "rate": rate, "requests": len(sent), "tokens_per_s": toks / args.seconds,
            "ttft_p50_ms": tr.percentile(ttft, 50) * 1e3,
            "ttft_p95_ms": tr.percentile(ttft, 95) * 1e3,
            "tpot_p95_ms": tr.percentile(
                [(q.finished_at - q.first_token_at) / (len(q.tokens) - 1) for _, q in sent
                 if q.done and q.finished_at <= end and len(q.tokens) > 1], 95) * 1e3,
            "waiting_at_quarters": depth,
            "pending_at_quarters": pending,
            "ticks": len(admit),
            "tick_ms_mean": 1e3 * sum(x["end"] - x["start"] for x in admit) / max(1, len(admit)),
        }), flush=True)
    engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
