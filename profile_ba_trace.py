"""One-off: trace the global-scale BA LM step and print top device ops.
``python profile_ba_trace.py [--northstar] [report]``; the trace is
written under ``.traces/ba`` in the checkout."""

import glob
import gzip
import json
import os
import sys
from collections import defaultdict

LOGDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      ".traces", "ba")


def capture():
    import jax
    from ptam_cg_tpu.models import bundle
    from bench_ba import make_problem

    if "--northstar" in sys.argv:
        # The C=500/P=50k/M=500k scale (fewer steps).
        prob, cam = make_problem(500, 50000, 500000, seed=4,
                                 motion=(0.002, 0.0005))
        n_steps = 3
    else:
        prob, cam = make_problem(64, 4096, 16384, seed=3)
        n_steps = 10
    step = jax.jit(lambda s: bundle.lm_step(s, cam))
    state = bundle.init_lm(prob)
    state = step(state)
    state = step(state)
    int(state.iters)        # host read fences the warmup

    jax.profiler.start_trace(LOGDIR)
    for _ in range(n_steps):
        state = step(state)
    print("trace captured; iters:", int(state.iters))
    jax.profiler.stop_trace()


def report():
    files = sorted(glob.glob(LOGDIR + "/**/*.trace.json.gz",
                             recursive=True))
    with gzip.open(files[-1], "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", [])
    pid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = e["args"].get("name", "")
    dev_pids = {p for p, nm in pid_names.items()
                if nm.startswith("/device:")}
    tot = defaultdict(float)
    cnt = defaultdict(int)
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in dev_pids:
            continue
        tot[e.get("name", "?")] += float(e.get("dur", 0.0))
        cnt[e.get("name", "?")] += 1
    for name, d in sorted(tot.items(), key=lambda kv: -kv[1])[:35]:
        print(f"{d/1e3:9.3f} ms  x{cnt[name]:5d}  {name[:100]}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "report":
        report()
    else:
        capture()
        report()
