"""`python -m restir_tpu_torch.prof <probe> [<probe> ...]` runs the named
probes (module names, with or without the `prof_` prefix) on the card;
`all` runs every probe. `--cpu` runs the plain twins at a tiny size."""

import argparse
import importlib
import sys

from . import PROBES, _timing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m restir_tpu_torch.prof")
    ap.add_argument("probes", nargs="+", help=f"all, or of {PROBES}")
    ap.add_argument("--cpu", action="store_true",
                    help="plain twins on the CPU at a tiny size")
    args = ap.parse_args(argv)
    names = []
    for p in args.probes:
        if p == "all":
            names.extend(PROBES)
            continue
        name = p if p.startswith("prof_") else "prof_" + p
        if name not in PROBES:
            ap.error(f"unknown probe {p!r}; one of {PROBES} or all")
        names.append(name)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("restir_tpu_torch.prof: no CUDA device (--cpu runs the "
                  "plain twins)", file=sys.stderr)
            return 2
    print(_timing.card_line(device))
    for name in names:
        mod = importlib.import_module(f"{__package__}.{name}")
        mod.run(device=device, small=args.cpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
