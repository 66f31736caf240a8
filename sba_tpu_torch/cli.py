"""`colmap`-style command line of the port (global BA only so far).

    python -m sba_tpu_torch.cli bundle_adjuster --input_path sparse/0 \
        --output_path ba/ [--device cuda] [--BundleAdjustment.dtype float32]

Flags follow sba_tpu's dot-namespaced style. ``--device`` (default
"cuda") selects where the solve runs; with ``--BundleAdjustment.dtype
float32`` on CUDA it goes through the hand-written kernels and the
command prints their launch counts.
"""

from __future__ import annotations

import json
import os
import sys
from typing import List, Optional

from sba_tpu_torch.options import apply_flags, parse_flags


def _require(flags, *names):
    missing = [n for n in names if n not in flags]
    if missing:
        raise SystemExit(
            "missing required flags: " + " ".join(f"--{m}" for m in missing))
    return [flags[n] for n in names]


def run_bundle_adjuster(flags):
    """Global bundle adjustment of a COLMAP model."""
    from sba_tpu_torch.models.reconstruction import Reconstruction
    from sba_tpu_torch.ops import ba_kernels
    from sba_tpu_torch.optim.ba import BAOptions
    from sba_tpu_torch.sfm.controllers import adjust_bundle

    input_path, output_path = _require(flags, "input_path", "output_path")
    device = flags.get("device", "cuda")
    rec = Reconstruction.read(input_path)
    opt = apply_flags(BAOptions(), "BundleAdjustment", flags)
    out = adjust_bundle(rec, opt, device=device)
    s = out["summary"]
    os.makedirs(output_path, exist_ok=True)
    rec.write(output_path)
    print(f"BA: cost {float(s.initial_cost):.6g} -> "
          f"{float(s.final_cost):.6g} in {int(s.num_iterations)} iters")
    if device != "cpu":
        print("kernel launches: " + json.dumps(ba_kernels.LAUNCHES))


COMMANDS = {"bundle_adjuster": run_bundle_adjuster}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("usage: python -m sba_tpu_torch.cli <command> [--flags]\n")
        print("commands:")
        for name in sorted(COMMANDS):
            print(f"  {name}")
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; run with --help for the list")
        return 1
    flags, _ = parse_flags(argv[1:])
    COMMANDS[cmd](flags)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
