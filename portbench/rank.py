"""A rank other than 0 of a cell on several cards, as rank 0 spawns it
(`ranks.Ranks`):

    python3 portbench/rank.py '<job as JSON>'

The job names the cell, the seed, the rank, the world, the group's
address and what to run (`ranks.child`). It prints no result; its exit
code is 0, or another where it failed or loaded JAX.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    job = json.loads((argv or sys.argv[1:])[0])
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import ranks

    return ranks.child(job)


if __name__ == "__main__":
    raise SystemExit(main())
