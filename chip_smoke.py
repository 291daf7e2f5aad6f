#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. environment: the card's name and power limit; TF32 off for the float32
   comparisons (cuDNN convolutions and matmuls in full float32);
2. build every CUDA source of the port (one nvcc per source, in parallel);
3. the RoIAlign kernel against its plain PyTorch version at the Faster
   R-CNN slice's shapes (P2-P5 of 4 x 800 x 1216 x 256, 1000 rois an image),
   in float32 and bfloat16, with its time, the plain version's time and the
   least time the card could take; then at small shapes with an odd channel
   count and other out sizes and sampling ratios;
4. Faster R-CNN R50-FPN (configs/faster_rcnn_r50_fpn_coco.py, seeded
   weights, bf16) answers batches of 4 seeded 800 x 1216 images through
   ``make_inference_fn``; the kernel's launches are counted over that run,
   and the kernel is held to the plain version on the run's own FPN levels
   and proposals; then the batch is timed stage by stage, and once under
   torch.profiler for the device's busy time and the operators that use it;
5. a small float32 input through the same path on the GPU and on the CPU,
   stage by stage, each GPU stage fed to its CPU counterpart.

The line before the last is the ``kernels`` JSON; the last line is the
device JSON. Without a GPU it exits with 2 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from torch_detection_tpu_torch import kernels
from torch_detection_tpu_torch.builder import build_detection_cfg, build_detector
from torch_detection_tpu_torch.engine import make_inference_fn
from torch_detection_tpu_torch.models.heads import generate_proposals
from torch_detection_tpu_torch.ops import nms as nms_ops
from torch_detection_tpu_torch.ops import roi_align
from torch_detection_tpu_torch.ops.boxes import clip_boxes, delta2bbox
from torch_detection_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "faster_rcnn_r50_fpn_coco.py"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
SEED = 0
F32_ATOL = 1e-5

# the slice's shapes
BATCH, CANVAS, CHANNELS, ROIS = 4, (800, 1216), 256, 1000
STRIDES = (4, 8, 16, 32)
OUT_SIZE, RATIO = 7, 2
WARMUP_BATCHES, TIMED_BATCHES = 2, 10


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bf16_within_one_ulp(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| <= F32_ATOL + one bf16 ulp of the larger magnitude.

    Both sides sum the same bf16 inputs in f32 and round once to bf16. The
    f32 sums run in another order and agree to F32_ATOL (the float32
    check); the rounding can then put a value near a midpoint on the
    neighbouring bf16 value, one ulp away. The absolute term covers values
    near zero, where the f32 difference exceeds a bf16 ulp of the value."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag))) * torch.finfo(torch.bfloat16).eps
    return (got - want).abs() <= F32_ATOL + ulp


def check_bf16(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    bad = int((~bf16_within_one_ulp(got, want)).sum())
    err = float((got.float() - want.float()).abs().max())
    log(f"{name}: max abs err {err:.3e}, {bad} elements beyond {F32_ATOL} + one bf16 ulp")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def check_f32(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Both sides sum the same float32 products in another order."""
    err = float((got - want).abs().max())
    log(f"{name}: max abs err {err:.3e} (limit {F32_ATOL})")
    if not err <= F32_ATOL:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(1, max |want|), on the CPU in float32."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def slice_rois(gen: torch.Generator, device) -> torch.Tensor:
    """(B, R, 4) rois over the canvas covering the four levels: log-uniform
    sizes from 8 to 900 px, most with aspect in [1/3, 3], some of 5:1 to
    8:1 (outside the TPU path's window contract), some all-zero boxes (padded
    proposals) and some crossing the border."""
    h, w = CANVAS
    n = (BATCH, ROIS)

    def u():
        return torch.rand(n, generator=gen, device=device)

    size = 8.0 * (900.0 / 8.0) ** u()
    aspect = 3.0 ** (u() * 2 - 1)
    wide = u() < 0.05
    aspect = torch.where(wide, 5.0 + 3.0 * u(), aspect)
    aspect = torch.where(wide & (u() < 0.5), 1.0 / aspect, aspect)
    bw, bh = size * aspect.sqrt(), size / aspect.sqrt()
    cx, cy = u() * w, u() * h
    rois = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1)
    clipped = clip_boxes(rois, torch.tensor([[h, w]] * BATCH, dtype=torch.float32, device=device))
    rois = torch.where((u() >= 0.03)[..., None], clipped, rois)
    zero = u() < 0.02
    return torch.where(zero[..., None], torch.zeros_like(rois), rois).contiguous()


def touched_bytes(feats, rois) -> int:
    """Bytes of the feature cells this run's rois read: every bilinear
    corner of every sample, each cell counted once."""
    levels = roi_align.map_rois_to_levels(rois, len(feats))
    total = 0
    for lvl, (f, stride) in enumerate(zip(feats, STRIDES)):
        bi, ri = torch.nonzero(levels == lvl, as_tuple=True)
        if bi.numel() == 0:
            continue
        b, h, w, c = f.shape
        box = rois[bi, ri]
        y0, y1, _ = roi_align.axis_samples(box[:, 1], box[:, 3], 1.0 / stride, h, OUT_SIZE, RATIO)
        x0, x1, _ = roi_align.axis_samples(box[:, 0], box[:, 2], 1.0 / stride, w, OUT_SIZE, RATIO)
        mark = torch.zeros((b, h, w), dtype=torch.bool, device=f.device)
        for ys in (y0, y1):
            for xs in (x0, x1):
                mark[bi[:, None, None], ys[:, :, None], xs[:, None, :]] = True
        total += int(mark.sum()) * c * f.element_size()
    return total


def phase_roi_align() -> dict:
    """The RoIAlign kernel vs its plain version at the slice's shapes."""
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED)
    h, w = CANVAS
    feats32 = [
        torch.randn((BATCH, h // s, w // s, CHANNELS), generator=gen, device=device)
        for s in STRIDES
    ]
    rois = slice_rois(gen, device)
    levels = roi_align.map_rois_to_levels(rois, len(STRIDES))
    per_level = [int((levels == lvl).sum()) for lvl in range(len(STRIDES))]
    log(f"rois per level {per_level}, zero boxes {int((rois.abs().sum(-1) == 0).sum())}")
    if min(per_level) == 0:
        raise AssertionError(f"the rois do not cover every level: {per_level}")

    kernel = roi_align.multilevel_roi_align_cuda
    plain = roi_align.multilevel_roi_align
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = f"roi_align {str(dtype).replace('torch.', '')}"
        feats = [f.to(dtype).contiguous() for f in feats32]
        got = kernel(feats, rois, STRIDES)
        want = plain(feats, rois, STRIDES)
        torch.cuda.synchronize()
        err = (check_f32 if dtype == torch.float32 else check_bf16)(name, got, want)
        ms = cuda_ms(lambda: kernel(feats, rois, STRIDES), iters=50)
        plain_ms = cuda_ms(lambda: plain(feats, rois, STRIDES), iters=3, warmup=1)
        out_bytes = got.numel() * got.element_size()
        in_bytes = touched_bytes(feats, rois) + rois.numel() * 4 + levels.numel() * 4
        flops = 2 * 4 * BATCH * ROIS * (OUT_SIZE * RATIO) ** 2 * CHANNELS  # 4 FMAs a sample, channel
        bytes_ms = (out_bytes + in_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS * 1e3
        result[dtype] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        )
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({(out_bytes + in_bytes) / 1e6:.1f} MB: {out_bytes / 1e6:.1f} written, "
            f"{in_bytes / 1e6:.1f} read; {flops / 1e9:.2f} GFLOP), library_ms none "
            f"(no PyTorch call computes this RoIAlign; torchvision is not used)")
    return result


def phase_roi_align_variants() -> None:
    """The kernel at shapes the slice does not use but the wrapper accepts:
    an odd channel count (one channel a thread instead of two), the mask
    head's out size 14, other sampling ratios; 2 images of 128 x 192."""
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    h, w = 128, 192
    xy = torch.rand((2, 64, 2), generator=gen, device=device) * torch.tensor([w, h], device=device)
    wh = 4.0 * 75.0 ** torch.rand((2, 64, 2), generator=gen, device=device)
    rois = torch.cat([xy, xy + wh], dim=-1)
    rois[:, :4] = 0.0  # padded proposals
    for c, out_size, ratio in ((5, 14, 2), (6, 4, 3), (130, 7, 1)):
        feats32 = [torch.randn((2, h // s, w // s, c), generator=gen, device=device)
                   for s in STRIDES]
        for dtype in (torch.float32, torch.bfloat16):
            feats = [f.to(dtype) for f in feats32]
            got = roi_align.multilevel_roi_align_cuda(feats, rois, STRIDES, out_size, ratio)
            want = roi_align.multilevel_roi_align(feats, rois, STRIDES, out_size, ratio)
            name = f"roi_align C={c} out={out_size} ratio={ratio} {str(dtype).replace('torch.', '')}"
            (check_f32 if dtype == torch.float32 else check_bf16)(name, got, want)


def load_model(dtype: str, device):
    cfg = Config.fromfile(CONFIG)
    model = build_detector(cfg.model, dtype, device=device, seed=SEED)
    return model, build_detection_cfg(cfg.detection)


def phase_model(card: str) -> dict:
    """Full-width Faster R-CNN R50-FPN b4 800x1216 bf16 through the entry
    points a user calls; the kernel's launches are counted over the run."""
    device = torch.device("cuda")
    model, det_cfg = load_model("bfloat16", device)
    infer = make_inference_fn(model, det_cfg)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    h, w = CANVAS
    images = [torch.randn((BATCH, h, w, 3), generator=gen, device=device, dtype=torch.bfloat16)
              for _ in range(WARMUP_BATCHES + TIMED_BATCHES)]
    img_shape = torch.tensor([[h, w]] * BATCH, dtype=torch.float32, device=device)
    scale = torch.ones(BATCH, device=device)

    for x in images[:WARMUP_BATCHES]:  # cuDNN plans, lazy module loads, the allocator's pool
        infer(x, img_shape, scale)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    roi_align.multilevel_roi_align_cuda.launches = 0
    syncs0 = nms_ops.suppress_syncs()
    seconds, results = [], []
    for x in images[WARMUP_BATCHES:]:
        t0 = time.perf_counter()
        res = infer(x, img_shape, scale)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        results.append(res)
    launches = roi_align.multilevel_roi_align_cuda.launches
    syncs = nms_ops.suppress_syncs() - syncs0

    log(f"main path: {TIMED_BATCHES} batches, RoIAlign kernel launches {launches}, "
        f"NMS fixpoint syncs {syncs / TIMED_BATCHES:.1f} a batch")
    if launches != TIMED_BATCHES:
        raise AssertionError(f"expected one RoIAlign launch a batch, got {launches}")
    for res in results:
        if res.boxes.shape != (BATCH, det_cfg.max_detections, 4):
            raise AssertionError(f"boxes shape {tuple(res.boxes.shape)}")
        for t in (res.scores, res.labels, res.valid, res.indices):
            if t.shape != (BATCH, det_cfg.max_detections):
                raise AssertionError(f"output shape {tuple(t.shape)}")
        if not (torch.isfinite(res.boxes).all() and torch.isfinite(res.scores).all()):
            raise AssertionError("non-finite detections")
        v = res.valid
        if not bool(v.any()):
            raise AssertionError("no detection above score_thr")
        lab, bx = res.labels[v], res.boxes[v]
        if not (bool((lab >= 0).all()) and bool((lab < det_cfg.num_classes).all())):
            raise AssertionError("labels out of range")
        if not (bool((bx >= 0).all()) and bool((bx[:, 0::2] <= w - 1).all())
                and bool((bx[:, 1::2] <= h - 1).all())):
            raise AssertionError("boxes outside the image")
        if not bool((res.scores[v] > det_cfg.score_thr).all()):
            raise AssertionError("a valid detection under score_thr")
    ms = [s * 1e3 for s in seconds]
    mean_ms = sum(ms) / len(ms)
    valid = [int(r.valid.sum()) for r in results]
    log(f"main path: ms a batch {[round(m, 3) for m in ms]}, mean {mean_ms:.3f} ms, "
        f"{BATCH / (mean_ms / 1e3):.2f} images/s, median {statistics.median(ms):.3f} ms "
        f"[{card}]; valid detections a batch {valid}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the kernel against the plain version on this run's FPN levels and proposals
    with torch.inference_mode():
        feats, rpn_s, rpn_d = model(images[1])
        props = generate_proposals(det_cfg.proposal_test, det_cfg.anchor_generator, rpn_s, rpn_d,
                                   img_shape)
        levels = list(feats[: len(det_cfg.roi_strides)])
        got = roi_align.multilevel_roi_align_cuda(levels, props.boxes, det_cfg.roi_strides)
        want = roi_align.multilevel_roi_align(levels, props.boxes, det_cfg.roi_strides)
        check_bf16("roi_align on the main path's levels and proposals", got, want)
    stage_breakdown(model, det_cfg, images[1], img_shape, card)
    device_profile(lambda: infer(images[1], img_shape, scale), mean_ms, card)
    return dict(launches=launches, ms_per_batch=mean_ms)


def device_profile(run_batch, batch_ms: float, card: str) -> None:
    """One batch under torch.profiler: the time in which the device ran a
    kernel, its share of an unprofiled batch (``batch_ms``), and the
    PyTorch operators whose kernels took most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_batch()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"device profile [{card}]: not measured (the profiler recorded no device events)")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:  # union of the kernels' intervals
        if e > end:
            busy_us += e - max(s, end)
            end = e
    ops = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
    top = sorted(ops, key=lambda op: -op[1])[:10]
    busy_ms = busy_us / 1e3
    log(f"device profile, one batch [{card}]: device busy {busy_ms:.3f} ms in {len(kernels)} "
        f"kernels, idle share of an unprofiled {batch_ms:.3f} ms batch {1 - busy_ms / batch_ms:.3f}; "
        "device ms by operator: "
        + "; ".join(f"{key} {us / 1e3:.3f} ({n} calls)" for key, us, n in top))


def stage_breakdown(model, det_cfg, images, img_shape, card: str, repeats: int = 5) -> None:
    """The batch stage by stage, a device sync between stages; the median
    host ms of each stage over ``repeats`` runs."""
    times = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    with torch.inference_mode():
        for _ in range(repeats):
            feats, rpn_s, rpn_d = stage("backbone+fpn+rpn_head", lambda: model(images))
            props = stage("proposals (top-k, decode, NMS)", lambda: generate_proposals(
                det_cfg.proposal_test, det_cfg.anchor_generator, rpn_s, rpn_d, img_shape))
            roi_feats = stage("roi_align kernel", lambda: roi_align.batched_multilevel_roi_align(
                list(feats[:4]), props.boxes, det_cfg.roi_strides, det_cfg.roi_size))
            cls, reg = stage("bbox_head", lambda: model.roi_forward(roi_feats))

            def decode_and_nms():
                probs = torch.softmax(cls.float(), dim=-1)[..., 1:]
                boxes = clip_boxes(delta2bbox(props.boxes, reg.float(), det_cfg.rcnn_target_means,
                                              det_cfg.rcnn_target_stds), img_shape)
                scores = torch.where(props.valid[..., None], probs, torch.zeros_like(probs))
                return nms_ops.multiclass_nms(boxes, scores, det_cfg.nms_iou_thr,
                                              det_cfg.score_thr, 1000, det_cfg.max_detections)

            stage("decode + multiclass NMS", decode_and_nms)
    median = {k: statistics.median(v) for k, v in times.items()}
    total = sum(median.values())
    log(f"stage breakdown, median of {repeats} batches [{card}]: " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / total:.1f}%)" for k, v in median.items()))


def phase_reference() -> None:
    """A small float32 input through the path on the GPU and on the CPU.
    Each GPU stage's output feeds the CPU counterpart of the next stage, so
    every stage is compared on equal inputs."""
    gpu, det_cfg = load_model("float32", "cuda")
    cpu, _ = load_model("float32", "cpu")
    gen = torch.Generator().manual_seed(SEED + 2)
    x = torch.randn((2, 256, 320, 3), generator=gen)
    shapes = torch.tensor([[256.0, 320.0], [240.0, 300.0]])
    checks = []

    def check(name, err, limit):
        checks.append(f"{name} {err:.2e} (limit {limit:g})")
        if not err <= limit:
            raise AssertionError(f"reference check {name}: {err} > {limit}")

    with torch.inference_mode():
        fg, sg, dg = gpu(x.cuda())
        fc, sc, dc = cpu(x)
        # cuDNN and the CPU pick other convolution algorithms and sum orders
        check("fpn levels", max(rel_err(g, c) for g, c in zip(fg, fc)), 1e-3)
        check("rpn outputs", max(rel_err(g, c) for g, c in zip(sg + dg, sc + dc)), 1e-3)
        pg = generate_proposals(det_cfg.proposal_test, det_cfg.anchor_generator, sg, dg, shapes.cuda())
        pc = generate_proposals(det_cfg.proposal_test, det_cfg.anchor_generator,
                                [s.cpu() for s in sg], [d.cpu() for d in dg], shapes)
        # exp and sigmoid may round differently on the two devices, and one
        # ulp can swap two near-equal proposals: compare counts and the
        # sorted scores, not rows
        check("proposal count difference",
              float((pg.valid.sum(1).cpu() - pc.valid.sum(1)).abs().max()), 0)
        check("proposal scores (sorted)", rel_err(pg.scores.sort(1).values, pc.scores.sort(1).values),
              1e-5)
        rg = roi_align.batched_multilevel_roi_align(list(fg[:4]), pg.boxes, det_cfg.roi_strides)
        rc = roi_align.batched_multilevel_roi_align([f.cpu() for f in fg[:4]], pg.boxes.cpu(),
                                                    det_cfg.roi_strides)
        check("roi features (kernel vs plain on the CPU)", rel_err(rg, rc), 1e-5)
        cg, _ = gpu.roi_forward(rg)
        cc, _ = cpu.roi_forward(rg.cpu())
        check("bbox head", rel_err(cg, cc), 1e-4)
        scores = torch.softmax(cg.float(), dim=-1)[..., 1:]
        boxes = pg.boxes[:, :, None, :].expand(-1, -1, scores.shape[-1], -1).contiguous()
        ng = nms_ops.multiclass_nms(boxes, scores, 0.5, 0.05, 1000, 100)
        nc = nms_ops.multiclass_nms(boxes.cpu(), scores.cpu(), 0.5, 0.05, 1000, 100)
        for field in ("valid", "labels", "indices"):
            check(f"multiclass_nms {field} mismatches",
                  float((getattr(ng, field).cpu() != getattr(nc, field)).sum()), 0)
        check("multiclass_nms scores", rel_err(ng.scores, nc.scores), 0)
    log("reference check, GPU vs CPU float32: " + "; ".join(checks))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = kernels.build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s (nvcc in parallel)")
    for name, text in kernels.BUILD_LOGS.items():
        log(f"ptxas {name}: " + " | ".join(
            line.strip() for line in text.splitlines() if "registers" in line or "spill" in line))

    roi = phase_roi_align()
    phase_roi_align_variants()
    main_path = phase_model(card)
    phase_reference()

    bf16 = roi[torch.bfloat16]
    line = {"kernels": [{
        "name": "roi_align_fwd",
        "route": "cuda",
        "source": "torch_detection_tpu_torch/csrc/roi_align_fwd.cu",
        "replaces": "torch_detection_tpu/ops/roi_align_pallas.py:65",
        "launches": main_path["launches"],
        "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["ms"],
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"],
        "library_ms": None,
    }]}
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
