"""The control of the correctness check: the plain reference put in the
program's place with the guarantee that the cell's configuration names
under `control` broken (its read gates off, each allele one read of its
group), judged by the same comparison as a run, on the loci a run of
that seed samples, at the cell's own size.

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3

Prints, for every seed, each compared number beside its limit, and
whether the control came out correct (it must not). Needs no card.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench import harness, reference, synth  # noqa: E402


def control_numbers(cfg, mix, seed):
    ds = synth.Dataset(cfg, mix, seed)
    params = harness.preset_params(cfg)
    ids = harness.sample_ids(ds, mix, seed)
    return reference.fold(
        reference.judge(ds, i, reference.control_record(ds, i, params),
                        params)
        for i, lc in enumerate(ds.loci) if lc.id in ids)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpubench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    _, _, cfg, mix = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control_numbers(cfg, mix, seed)
        passed = all(numbers[k] <= v for k, v in cfg["limits"].items())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": passed, **numbers}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
