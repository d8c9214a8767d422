"""A cell's runs with its timed path switched to the control or broken by
a planted fault, through the cell's own driver, judge and limits: the
readings that a cell's limits are set from, and the proof that the
limits catch what they are for.

    python3 bench_port/control.py --workload <cell> --seeds 1 2 3 --seconds 3 [--plant NAME]

Each seed is one run of ``--seconds`` (untraced), in one process; one
JSON line a seed on standard output with ``correct`` and the numbers
compared, each beside its limit. Without ``--plant`` the program runs as
the benchmark runs it (the lower readings). ``--plant``:

- ``control``: the program's own bfloat16 path switched on where the
  configuration states float32, the reference kept at float32; it has to
  come out not correct;
- ``unchanged``: a train step that leaves the state as it was;
- ``half_batch``: the loss taken over half of the batch;
- ``altered``: each answer's first class changed where the program makes it.
"""

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness.runner import Run, execute, forbidden_modules, result_line  # noqa: E402


def _unchanged():
    import torch

    torch.optim.Adam.step = lambda self, closure=None: None


def _half_batch():
    from pointnet_like_pose_estimation_tpu_torch.models import losses

    def half(log_probs, labels):
        B = log_probs.shape[0] // 2
        return -log_probs[:B].gather(1, labels[:B, None].long()).mean()

    losses.nll_loss = half


def _altered():
    from pointnet_like_pose_estimation_tpu_torch.pipeline.infer import GraspPipeline

    infer = GraspPipeline._infer

    def altered(self, xyz):
        out = dict(infer(self, xyz))
        out["pred_class"] = out["pred_class"].clone()
        out["pred_class"][0] = (out["pred_class"][0] + 1) % self.cfg.num_classes
        return out

    GraspPipeline._infer = altered


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered}
CONTROL_DTYPE = {"float32": "bfloat16"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plant", choices=["control", *sorted(FAULTS)], default=None)
    args = ap.parse_args()
    import torch

    if args.plant in FAULTS:
        FAULTS[args.plant]()
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else args.device
    for seed in args.seeds:
        run = Run(args.workload, seed, args.seconds, False, device=args.device)
        if args.plant == "control":
            stated = (run.config.get("pipeline") or run.config["train"])["dtype"]
            run.program_dtype = CONTROL_DTYPE[stated]
        try:
            line = result_line(run, execute(run), name, run.cell["chips"], "")
        except Exception as exc:  # a control or fault that crashes has failed, and gives no number
            print(json.dumps({"workload": args.workload, "seed": seed, "plant": args.plant,
                              "crashed": repr(exc)}), flush=True)
            continue
        print(json.dumps({"workload": args.workload, "seed": seed, "plant": args.plant,
                          "correct": line["correct"], "compared": line["compared"]}), flush=True)
    found = forbidden_modules()
    if found:
        print(f"control: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
