"""Run the float32 bench and the medium tier twice each, in fresh
processes on the card, with ``torch.backends.cudnn.deterministic = True``
set before the CLI starts, and say whether each repeats bit for bit.

    python -m vae_hmc_tpu_torch.tools.cudnn_witness --out DIR

The port leaves the flag off (parity mode runs cuDNN's nondeterministic
engines; with the flag on, the conv fit keeps cuDNN's heuristic pick and
times nothing), and over five runs ``tools/certify_goldens`` finds these two
keys spreading past its 1% rule.  If they repeat here, the nondeterministic
conv engines are the measured cause; if not, something else moves them.
The runs, their commands and the summary are ``certify_goldens``'s.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from vae_hmc_tpu_torch.tools import certify_goldens

KEYS = ("bench-parity", "medium")
RUNS = 2
LAUNCHER = ("-c", "import runpy, torch; "
            "torch.backends.cudnn.deterministic = True; "
            "torch.backends.cudnn.benchmark = False; "
            "runpy.run_module('vae_hmc_tpu_torch.cli', run_name='__main__', "
            "alter_sys=True)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)
    summary = certify_goldens.certify(args.out, KEYS, RUNS, LAUNCHER)
    certify_goldens.report(summary, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
