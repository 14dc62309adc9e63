"""Read the comparison's numbers for the program and for its control on
several seeds, in one process, on the card.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

The control is the plain reference put in the program's place and
computed in TF32, the precision next below the configurations' float32:
for training its first three steps on the run's batches and masks, for
recognition its encoder states and the token it puts first at each
decision along the served tokens' alignment.  Each seed prints one JSON
line: the program's readings (``checks``) beside the control's
(``control``); with ``--fault`` the readings of the program with that
fault of ``benchmark/faults.py`` planted.  The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--fault", help="read a fault of benchmark/faults.py instead")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import faults, harness
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        undo = getattr(faults, args.fault)() if args.fault else None
        try:
            result = harness.run(args.workload, seed, args.seconds, False,
                                 control=undo is None)
        finally:
            if undo is not None:
                undo()
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": result["correct"],
                          "checks": {k: v["value"] for k, v in result["checks"].items()},
                          "control": result.get("control")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
