"""The readings behind each compared number's limit: ``python3
perfbench/control.py --workload <cell> --mode <mode> --seeds a,b,...
[--seconds s]``, all seeds in one process, one JSON line a seed with the
numbers and ``correct`` as the cell's limits judge them.

Modes: ``program``, sound runs of the program (the lower reading); the
controls, a step below the float32 GEMMs with TF32 off that the
configurations state (the upper reading): ``bf16``, the program with its
own ``-bf16`` path on (bfloat16 features and tensor-core GEMMs), and
``tf32``, the reference with TF32 GEMMs in the program's place;
``half`` (train cells), the reference in the program's place with half
of the train rows left out and the loss doubled over the rest, a planted
fault.  Train cells need no window; a serve cell runs a short window of
``--seconds`` at its own load."""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from perfbench import harness, inputs, reference, spec  # noqa: E402
from perfbench import serve_run, train_run  # noqa: E402
from perfbench.check import limits_for, train_numbers, verdict  # noqa: E402


def half_fault(cfg, traffic, seed, device, detail) -> dict:
    """The reference with half of the train rows left out, the loss
    doubled, against the whole reference."""
    steps = int(traffic["checked_steps"])
    inp = inputs.make(cfg, seed, device)
    ref = reference.train_steps(cfg, inp, steps, seed)
    train = torch.nonzero(inp.mask == inputs.MASK_TRAIN).squeeze(1)
    mask = inp.mask.clone()
    mask[train[::2]] = inputs.MASK_NONE
    bad = reference.train_steps(cfg, dataclasses.replace(inp, mask=mask),
                                steps, seed, loss_scale=2.0)
    detail.update(prog=bad, ref=ref)
    return train_numbers(bad, ref)


def readings(cell, mode, seed, seconds, device, detail) -> dict:
    if cell.traffic["kind"] == "train":
        if mode == "half":
            return half_fault(cell.config, cell.traffic, seed, device,
                              detail)
        return train_run.readings(cell.config, cell.traffic, seed, device,
                                  mode, detail)
    ctx = harness.Context(cell, seed, seconds, False, time.perf_counter(),
                          device)
    ctx.use_bf16 = mode == "bf16"
    ctx.control_tf32 = mode == "tf32"
    res = serve_run.run(ctx)
    return dict(res["numbers"], failed=res["failed"], **res["end_to_end"])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=("program", "bf16", "tf32", "half"),
                   required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    a = p.parse_args()
    cell = spec.cell(a.workload)
    limits = limits_for(cell.name)
    dev = torch.device("cuda", 0)
    for seed in [int(s) for s in a.seeds.split(",")]:
        t = time.perf_counter()
        detail = {}
        nums = readings(cell, a.mode, seed, a.seconds, dev, detail)
        ok = verdict(nums, limits)[0] and not nums.get("failed", 0)
        print(json.dumps({"workload": a.workload, "mode": a.mode,
                          "seed": seed, "correct": ok, "numbers": nums,
                          "seconds": time.perf_counter() - t,
                          "detail": detail}), flush=True)


if __name__ == "__main__":
    main()
