"""A golden family's scores over init seeds, to decide its seed rule
(``tests/torch_golden_cases.py``'s ``GOLDEN_SEEDS``): the port's harness
(``tests/test_torch_golden_map.py::train_and_eval``) or, with
``--reference``, the JAX package's own (``tests/test_golden_map.py::
_train_and_eval``) trains the family's golden case from each seed on a fresh
``make_golden_coco`` set and prints one line a seed (mAP_50, mAP, mAP_75,
seconds), then the mean of the family's banded metrics and how many seeds
meet each band.

    JAX_PLATFORM_NAME=cpu python tests/golden_seed_sweep.py detr --seeds 0-7
    JAX_PLATFORM_NAME=cpu python tests/golden_seed_sweep.py detr --seeds 0-7 --reference

``--reference`` takes the families whose reference case needs no extra
init: the twelve dense and set families and Sparse R-CNN.
``--match-as-reference`` trains the port's DETR or Sparse R-CNN on the
reference's matching (R7: the reference's GIoU cost term is one scalar for
all pairs, which no assignment depends on, so it matches on the class and
L1 terms alone), to tell the matching rule from the rest of the training.
"""

import argparse
import dataclasses
import sys
import tempfile
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

from data_fixtures import make_golden_coco  # noqa: E402
from torch_golden_cases import (  # noqa: E402
    GOLDEN_CASES,
    GOLDEN_DENSE,
    GOLDEN_MODELS,
    golden_detection_cfg,
    mean_scores,
    write_golden_proposals,
)


def seed_range(text: str) -> list:
    """``0-7`` or ``0,3,5`` as a list of seeds."""
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def match_as_reference(name: str) -> None:
    """The port's ``matching_cost`` of DETR or Sparse R-CNN without its
    GIoU term, as the reference's cost orders the pairs (R7)."""
    from torch_detection_tpu_torch.models.detectors import detr, sparse_rcnn

    module = {"detr": detr, "sparse_rcnn": sparse_rcnn}.get(name)
    if module is None:
        raise SystemExit(f"--match-as-reference: {name} has no set matching")
    cost = module.matching_cost
    module.matching_cost = lambda cfg, *args: cost(dataclasses.replace(cfg, giou_weight=0.0),
                                                   *args)


def port_runner(name: str, golden, root: Path, reference_matching: bool):
    import torch
    from test_torch_golden_map import train_and_eval

    torch.set_num_threads(4)  # as the slow tests
    if reference_matching:
        match_as_reference(name)
    steps, kw, _ = GOLDEN_CASES[name]
    kw = dict(kw)
    proposal_file = (write_golden_proposals(golden[0], root / "golden_props.pkl")
                     if kw.pop("proposals", False) else None)
    return lambda seed: train_and_eval(golden, GOLDEN_MODELS[name], golden_detection_cfg(name),
                                       steps=steps, seed=seed, proposal_file=proposal_file, **kw)


def reference_runner(name: str, golden):
    if name not in GOLDEN_DENSE and name != "sparse_rcnn":
        raise SystemExit(f"--reference: {name}'s reference case needs its own extra init")
    import test_golden_map as reference
    from torch_detection_tpu import builder
    from torch_detection_tpu.models import detectors, heads
    from torch_detection_tpu.ops import anchors, assign

    steps = GOLDEN_CASES[name][0]
    model = builder.build_detector(GOLDEN_MODELS[name])
    cfg = golden_detection_cfg(name, detectors, heads, anchors, assign)
    return lambda seed: reference._train_and_eval(golden, model, cfg, steps=steps, lr=1e-3,
                                                  seed=seed)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("name", choices=sorted(GOLDEN_CASES))
    parser.add_argument("--seeds", default="0-7", help="e.g. 0-7 or 0,3,5")
    parser.add_argument("--reference", action="store_true", help="the JAX package's harness")
    parser.add_argument("--match-as-reference", action="store_true",
                        help="the port's DETR or Sparse R-CNN on the reference's matching (R7)")
    args = parser.parse_args(argv)
    band = GOLDEN_CASES[args.name][2]
    who = ("reference" if args.reference
           else "port (the reference's matching)" if args.match_as_reference else "port")
    with tempfile.TemporaryDirectory() as tmp:
        golden = make_golden_coco(tmp)
        run = (reference_runner(args.name, golden) if args.reference
               else port_runner(args.name, golden, Path(tmp), args.match_as_reference))
        results = []
        for seed in seed_range(args.seeds):
            t0 = time.perf_counter()
            res = {k: float(v) for k, v in run(seed).items()}
            results.append(res)
            print(f"{who} {args.name} seed {seed}: "
                  + ", ".join(f"{k} {res[k]:.4f}" for k in ("mAP_50", "mAP", "mAP_75"))
                  + f" in {time.perf_counter() - t0:.1f} s", flush=True)
    mean = mean_scores(results, band)
    print(f"{who} {args.name} mean over {len(results)} seeds: "
          + ", ".join(f"{k} {mean[k]:.4f} (band >= {v}; {sum(r[k] >= v for r in results)} "
                      f"seeds meet it)" for k, v in band.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
