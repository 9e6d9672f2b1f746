"""Run every Hopper probe on the card, one line each, as the TPU scripts printed them:

    python -m oxylus_tpu_torch.probes [--device cpu]

Each probe is checked (against its plain version on CPU copies, or the
script's own bound) and raises on a mismatch; then timed as a CUDA graph of
its calls and call by call from the host.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from . import format_line, run_all


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m oxylus_tpu_torch.probes", description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu, to rehearse with the plain versions")
    args = ap.parse_args(argv)
    if args.device != "cpu" and torch.cuda.is_available():
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
        print(card[0] if card else torch.cuda.get_device_name(0), flush=True)
    for r in run_all(args.device):
        print(format_line(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
