"""Time the RoIAlign kernels K1 and K2 of one source tree at the Faster R-CNN
slice's shapes, to compare two revisions on one card.

    python3 torch_detection_tpu_torch/roi_align_bench.py [--tree DIR] [--label NAME]

DIR (default: the checkout this file is in) is the root of a checkout: its
``torch_detection_tpu_torch`` and ``chip_smoke.py`` are imported, its
kernels are built into ``DIR/build/kernels``, and the seeded inputs of its
``chip_smoke.slice_inputs`` go through its kernels. Run it for the parent
commit (unpacked with ``git archive`` into a directory that ``.gitignore``
lists) and for this checkout in turns (parent, change, change, parent) in
one call on one card, so that the two are compared there. Prints, as its last
line, one JSON object: the card's name and power limit, what ptxas reported
for each kernel, K1's ms at 128 to 1024 rois an image and K2's at 512 (the
device time by CUDA events, mean of many calls), each in float32 and bfloat16,
and the device memory one K2 call allocates. Exits with 2 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

K1_ROIS = (128, 256, 384, 512, 640, 768, 896, 1000, 1024)
SPIN_CYCLES = 60_000_000  # the host's head start, about 30 ms at 1.98 GHz


def device_ms(torch, fn, iters: int) -> float:
    """Mean device milliseconds per call over ``iters`` calls, by CUDA
    events, after two warm-up calls. The device first spins while the host
    queues the calls, so the events time the kernels, not the wrapper's host
    time. The same function times every tree."""
    fn()
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[0] = str(tree)  # the tree's package and chip_smoke, not this file's directory

    import torch

    if not torch.cuda.is_available():
        print("roi_align_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from torch_detection_tpu_torch import kernels
    from torch_detection_tpu_torch.ops import roi_align

    if not Path(roi_align.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {roi_align.__file__}, not the tree {tree}")
    kernels.build_all()
    result = dict(label=args.label, card=smoke.card_line(), k1_ms={}, k2_ms={},
                  ptxas={name: [line.strip() for line in text.splitlines()
                                if "registers" in line or "spill" in line]
                         for name, text in kernels.BUILD_LOGS.items()})
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    for rois_per_image in K1_ROIS:
        gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
        feats32, rois, levels = smoke.slice_inputs(gen, rois_per_image)
        for name, dtype in dtypes.items():
            feats = [f.to(dtype).contiguous() for f in feats32]
            result["k1_ms"][f"{rois_per_image} {name}"] = device_ms(
                torch, lambda: roi_align.multilevel_roi_align_cuda(feats, rois, levels, smoke.STRIDES),
                iters=50)

    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 4)
    feats32, rois, levels = smoke.slice_inputs(gen, smoke.TRAIN_ROIS)
    shapes = [tuple(f.shape[1:3]) for f in feats32]
    grad32 = torch.randn((smoke.BATCH, smoke.TRAIN_ROIS, smoke.OUT_SIZE, smoke.OUT_SIZE,
                          smoke.CHANNELS), generator=gen, device="cuda")
    for name, dtype in dtypes.items():
        grad_args = (grad32.to(dtype), rois, levels, shapes, smoke.STRIDES)
        kernel = roi_align.multilevel_roi_align_backward_cuda
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernel(*grad_args)
        torch.cuda.synchronize()
        result[f"k2_call_mb {name}"] = (torch.cuda.max_memory_allocated() - base) / 1e6
        result["k2_ms"][f"{smoke.TRAIN_ROIS} {name}"] = device_ms(torch, lambda: kernel(*grad_args),
                                                                   iters=20)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
