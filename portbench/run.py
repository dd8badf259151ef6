"""Run one cell of the benchmark of `pathtracer_tpu_torch` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with the card. It builds the cell's scene and
traffic from their files (`BENCHMARK.json` names them), warms up, measures
for `--seconds` seconds, checks what the window produced against the
plain reference, and prints as its last line one JSON object: `correct`,
`attempted`, `failed`, `metrics` (with `--trace 0` the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics), `device`, with `--trace
1` `breakdown`, and last `checks`, each number compared beside its limit
(also the last lines of standard error). A cell on several cards runs as
one process a card, this one rank 0 (`ranks.py`). Without a card, with
fewer cards than the cell asks for, with JAX or the JAX package loaded
once the window has closed (on any rank), or with a rank lost, it prints
no result and exits with another code than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json's workloads")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import ranks

    chips, job = ranks.window_job(args.workload, args.seed, args.seconds, ROOT)
    group = ranks.Ranks(chips, job, "cuda") if chips > 1 else None  # spawned before torch is imported here
    with group or contextlib.nullcontext():
        from portbench import harness

        try:
            result, lines = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                                        group=group)
        except harness.NoCard as e:
            print(e, file=sys.stderr)
            return 2
        except ranks.RankFailed as e:
            print(f"portbench: {e}", file=sys.stderr)
            return 3
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package is loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
