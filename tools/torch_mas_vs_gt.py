#!/usr/bin/env python3
"""Does MAS train models as well as duration annotations do? (the port's
checkpoints)

Twin of tools/mas_vs_gt.py on the port: pairs of trainer checkpoints at
equal steps and otherwise identical flags, one trained with the dataset's
phone durations and one with ``--durations mas`` (the CUDA MAS kernel on a
GPU), are each evaluated by tools/torch_eval_copy_synthesis.py (in this
process: one evaluation per side, its checkpoints restored in turn), and
the MAS side's copy-synthesis mel-L1 must stay within ``--tolerance`` of
the ground-truth side's on every pair. Same flags and JSON keys as the JAX
tool, plus ``--device`` (default cuda).

Usage:
  python tools/torch_mas_vs_gt.py --gt-ckpt gt/step_2000.pt \
      --mas-ckpt mas/step_2000.pt --data-dir toy/npy [--nsf] \
      [--noise-scale 0] [--out artifacts/torch_mas_vs_gt.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os

TOOLS = os.path.dirname(os.path.abspath(__file__))


def _eval_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_eval_copy_synthesis",
        os.path.join(TOOLS, "torch_eval_copy_synthesis.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def compare(gt: list, mas: list, tolerance: float) -> dict:
    """The JAX tool's verdict over step pairs of eval results: each pair's
    MAS / GT mel-L1 ratio, their mean and max, and whether every pair is
    within the tolerance."""
    pairs = []
    for g, m in zip(gt, mas):
        gl, ml = float(g["mel_l1_trained"]), float(m["mel_l1_trained"])
        pairs.append({"gt_ckpt": g["ckpt"], "mas_ckpt": m["ckpt"],
                      "mel_l1_gt": gl, "mel_l1_mas": ml,
                      "ratio": round(ml / max(gl, 1e-9), 4)})
    mean_ratio = sum(x["ratio"] for x in pairs) / len(pairs)
    max_ratio = max(x["ratio"] for x in pairs)
    return {
        "pairs": pairs,
        "mean_mas_over_gt_ratio": round(mean_ratio, 4),
        "max_mas_over_gt_ratio": round(max_ratio, 4),
        "all_pairs_within_tolerance": bool(max_ratio <= 1.0 + tolerance),
        "tolerance": tolerance,
        "summary": (f"MAS-trained mel-L1 within "
                    f"{max(0.0, (max_ratio - 1.0)) * 100:.0f}% of "
                    f"ground-truth-duration training on every evaluated "
                    f"step pair"),
        "gt_eval": gt,
        "mas_eval": mas,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--gt-ckpt", required=True, nargs="+",
                   help="checkpoint(s) trained with dataset phone durations")
    p.add_argument("--mas-ckpt", required=True, nargs="+",
                   help="same-flags checkpoint(s) trained with --durations "
                        "mas, at the SAME steps (pairwise with --gt-ckpt)")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--nsf", action="store_true")
    p.add_argument("--noise-scale", type=float, default=0.0)
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--tolerance", type=float, default=0.10,
                   help="allowed relative mel-L1 excess of MAS over GT")
    p.add_argument("--out", default=None,
                   help="write the result JSON here (nothing is written "
                        "without it)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    if len(args.gt_ckpt) != len(args.mas_ckpt):
        p.error("--gt-ckpt and --mas-ckpt must pair up step for step")
    tool = _eval_tool()
    gt, mas = (tool.evaluate(ckpts, args.data_dir, args.tiny, args.n,
                             args.nsf, args.noise_scale, args.device)
               for ckpts in (args.gt_ckpt, args.mas_ckpt))
    result = compare(gt, mas, args.tolerance)
    print(json.dumps({k: v for k, v in result.items()
                      if not k.endswith("_eval")}))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
