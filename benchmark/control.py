"""The controls of ``correct``, and sound runs of many seeds, in one process.

    python3 -m benchmark.control --workload <cell> --seconds <s> --seeds 1,2,3 \
        [--control dedup|codec] [--sound]

A control is the program with one guarantee of the configuration broken by
a path of its own, and has to come out not correct:

- ``dedup``: every image converts on a new ``BatchConverter``, without the
  batch's growing chunk dict, so chunks of earlier images are stored again
  instead of referenced;
- ``codec``: the codec one step faster than the configuration states (zstd
  level 1 for 3, lz4 acceleration 2 for 1), the step that would tempt a
  later change: larger blobs for every node that pulls them.

``--sound`` runs the program as the benchmark does, for the readings of
sound runs over many seeds. One line per run: the seed, ``correct`` and
each number compared. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys

from benchmark import run


def fresh_dict_each_image(driver, image):
    from nydus_snapshotter_tpu_torch.converter import batch

    conv = batch.BatchConverter(driver.opt, device=driver.converter.device)
    return conv.convert_many([(image.name, image.tars)])[0]


@contextlib.contextmanager
def faster_codec(driver):
    """The program's codec one step faster than the configuration states."""
    from nydus_snapshotter_tpu_torch import constants

    conv, opt, level = driver.converter, driver.converter.opt, constants.ZSTD_LEVEL
    conv.opt = dataclasses.replace(opt, lz4_acceleration=opt.lz4_acceleration + 1)
    constants.ZSTD_LEVEL = level - 2
    try:
        yield
    finally:
        conv.opt, constants.ZSTD_LEVEL = opt, level


def faster_codec_each_image(driver, image):
    with faster_codec(driver):
        return driver.convert(image)


CONTROLS = {"dedup": fresh_dict_each_image, "codec": faster_codec_each_image}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", choices=sorted(CONTROLS), default="dedup")
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        one = run.parse(["--workload", args.workload, "--seed", str(seed),
                         "--seconds", str(args.seconds), "--trace", "0"])
        res = run.run(one, control=None if args.sound else CONTROLS[args.control])
        print(json.dumps({"control": None if args.sound else args.control, "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"], "metrics": res["metrics"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
