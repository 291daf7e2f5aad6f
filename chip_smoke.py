#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. environment: the card's name and power limit; TF32 off for the float32
   comparisons (cuDNN convolutions and matmuls in full float32);
2. build every CUDA source of the port (one nvcc per source, in parallel);
3. the RoIAlign forward kernel (K1) against its plain PyTorch version at the
   Faster R-CNN slice's shapes (P2-P5 of 4 x 800 x 1216 x 256; 1000 rois an
   image as at serving, 512 as in training), in float32 and bfloat16, with
   its time, the plain version's time and the least time the card could
   take; then at small shapes with an odd channel count and other out sizes
   and sampling ratios;
4. the RoIAlign backward kernel (K2) against its plain version at the
   training shapes (512 rois an image, a seeded cotangent), in float32 and
   bfloat16, timed likewise; then at the small shapes;
5. serving: Faster R-CNN R50-FPN (configs/faster_rcnn_r50_fpn_coco.py,
   seeded weights, bf16) answers batches of 4 seeded 800 x 1216 images
   through ``make_inference_fn``; K1's launches are counted over that run,
   and K1 is held to the plain version on the run's own FPN levels and
   proposals; then the batch is timed stage by stage, and once under
   torch.profiler for the device's busy time and the operators that use it;
6. the GPU path against the CPU path for serving, float32, stage by stage,
   each GPU stage fed to its CPU counterpart;
7. training: the same detector built for training (float32 parameters,
   bf16 compute) takes seeded batches of 4 images on the 800 x 1216 canvas
   with 1-20 gt boxes an image through ``build_loss_fn``,
   ``build_train_objects`` (``make_optimizer``), ``make_train_step`` and
   ``Trainer.run``: 2 warm-up steps, then 10 timed steps over which K1's and
   K2's launches are counted; every loss finite, roi positives in every
   step, no step skipped, the trainable parameters moved and the frozen ones
   did not; ms a step, images/s, peak memory, one profiled step, and a step
   timed stage by stage; then K2 is held to the plain version on a step's
   own FPN levels, sampled rois and box-head cotangent;
8. the GPU training path against the CPU path, float32, stage by stage on a
   small canvas with the same sampling draws: RPN losses, assignment and
   sampling on the GPU's proposals, RoI losses, and the RoI stage's
   gradients into the FPN levels.

The line before the last is the ``kernels`` JSON; the last line is the
device JSON. Without a GPU it exits with 2 and prints no result.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from torch_detection_tpu_torch import kernels
from torch_detection_tpu_torch.builder import (
    build_detection_cfg,
    build_detector,
    build_loss_fn,
    build_train_objects,
)
from torch_detection_tpu_torch.engine import Trainer, make_inference_fn
from torch_detection_tpu_torch.models.detectors import sampling_noise
from torch_detection_tpu_torch.models.detectors.two_stage import (
    flatten_rpn_outputs,
    rcnn_losses,
    rpn_losses,
    sample_rois,
)
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

# the slice's shapes: 1000 proposals an image at serving, 512 sampled rois
# an image in training, gt padded to 100
BATCH, CANVAS, CHANNELS, ROIS, TRAIN_ROIS, MAX_GTS = 4, (800, 1216), 256, 1000, 512, 100
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


def check_f32_scaled(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """f32 atomics add in an order that changes from run to run: within
    F32_ATOL * max(1, max |want|)."""
    err = float((got - want).abs().max())
    limit = F32_ATOL * max(1.0, float(want.abs().max()))
    log(f"{name}: max abs err {err:.3e} (limit {limit:.3e})")
    if not err <= limit:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def check_grads(name: str, got, want, dtype) -> float:
    """Per-level gradients: f32 within the scaled tolerance, bf16 within
    F32_ATOL plus one bf16 ulp of the value."""
    check = check_f32_scaled if dtype == torch.float32 else check_bf16
    return max(check(f"{name} level {lvl}", g, w) for lvl, (g, w) in enumerate(zip(got, want)))


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(1, max |want|), on the CPU in float32."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def slice_rois(gen: torch.Generator, device, rois: int = ROIS) -> torch.Tensor:
    """(B, R, 4) rois over the canvas covering the four levels: log-uniform
    sizes from 8 to 900 px, most with aspect in [1/3, 3], some of 5:1 to
    8:1 (outside the TPU path's window contract), some all-zero boxes (padded
    proposals) and some crossing the border."""
    h, w = CANVAS
    n = (BATCH, rois)

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


def slice_inputs(gen: torch.Generator, rois_per_image: int):
    """Seeded float32 P2-P5 maps of the slice and rois that cover every
    level, with their routed levels."""
    device = torch.device("cuda")
    h, w = CANVAS
    feats32 = [
        torch.randn((BATCH, h // s, w // s, CHANNELS), generator=gen, device=device)
        for s in STRIDES
    ]
    rois = slice_rois(gen, device, rois_per_image)
    levels = roi_align.map_rois_to_levels(rois, len(STRIDES))
    per_level = [int((levels == lvl).sum()) for lvl in range(len(STRIDES))]
    log(f"{rois_per_image} rois an image: per level {per_level}, "
        f"zero boxes {int((rois.abs().sum(-1) == 0).sum())}")
    if min(per_level) == 0:
        raise AssertionError(f"the rois do not cover every level: {per_level}")
    return feats32, rois, levels


def bound(name: str, in_bytes: int, out_bytes: int, flops: int) -> dict:
    """The least time the card could take: bytes over the HBM rate or f32
    operations over the f32 rate, whichever is larger."""
    bytes_ms = (out_bytes + in_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    log(f"{name}: bound {max(bytes_ms, ops_ms):.4f} ms ({(out_bytes + in_bytes) / 1e6:.1f} MB: "
        f"{out_bytes / 1e6:.1f} written, {in_bytes / 1e6:.1f} read; {flops / 1e9:.2f} GFLOP)")
    return dict(bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def phase_roi_align(rois_per_image: int) -> dict:
    """K1 vs its plain version at the slice's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    feats32, rois, levels = slice_inputs(gen, rois_per_image)
    kernel = roi_align.multilevel_roi_align_cuda
    plain = roi_align.multilevel_roi_align
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = f"roi_align_fwd {rois_per_image} rois {str(dtype).replace('torch.', '')}"
        feats = [f.to(dtype).contiguous() for f in feats32]
        got = kernel(feats, rois, levels, STRIDES)
        want = plain(feats, rois, levels, STRIDES)
        torch.cuda.synchronize()
        err = (check_f32 if dtype == torch.float32 else check_bf16)(name, got, want)
        ms = cuda_ms(lambda: kernel(feats, rois, levels, STRIDES), iters=50)
        plain_ms = cuda_ms(lambda: plain(feats, rois, levels, STRIDES), iters=3, warmup=1)
        out_bytes = got.numel() * got.element_size()
        in_bytes = touched_bytes(feats, rois) + rois.numel() * 4 + levels.numel() * 4
        flops = 2 * 4 * rois.shape[0] * rois.shape[1] * (OUT_SIZE * RATIO) ** 2 * CHANNELS  # 4 FMAs a sample, channel
        result[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             **bound(name, in_bytes, out_bytes, flops))
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library_ms none "
            f"(no PyTorch call computes this RoIAlign; torchvision is not used)")
    return result


def phase_roi_align_bwd() -> dict:
    """K2 vs its plain version at the training shapes: the slice's P2-P5,
    512 rois an image, a seeded cotangent. The kernel's time is the
    wrapper's: the zero fill of the float32 accumulator, the kernel, and for
    bf16 the cast."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    feats32, rois, levels = slice_inputs(gen, TRAIN_ROIS)
    shapes = [tuple(f.shape[1:3]) for f in feats32]
    grad32 = torch.randn((BATCH, TRAIN_ROIS, OUT_SIZE, OUT_SIZE, CHANNELS), generator=gen,
                         device="cuda")
    kernel = roi_align.multilevel_roi_align_backward_cuda
    plain = roi_align.multilevel_roi_align_backward
    cells = sum(f.numel() for f in feats32)
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = f"roi_align_bwd {str(dtype).replace('torch.', '')}"
        grad = grad32.to(dtype)
        got = kernel(grad, rois, levels, shapes, STRIDES)
        want = plain(grad, rois, levels, shapes, STRIDES)
        torch.cuda.synchronize()
        err = check_grads(name, got, want, dtype)
        ms = cuda_ms(lambda: kernel(grad, rois, levels, shapes, STRIDES), iters=20)
        plain_ms = cuda_ms(lambda: plain(grad, rois, levels, shapes, STRIDES), iters=2, warmup=1)
        zero_ms = cuda_ms(lambda: torch.zeros(cells, dtype=torch.float32, device="cuda"), iters=20)
        acc = torch.zeros(cells, dtype=torch.float32, device="cuda")
        cast_ms = cuda_ms(lambda: acc.to(dtype), iters=20) if dtype != torch.float32 else 0.0
        in_bytes = grad.numel() * grad.element_size() + rois.numel() * 4 + levels.numel() * 4
        out_bytes = cells * grad.element_size()
        flops = 2 * 4 * BATCH * TRAIN_ROIS * (OUT_SIZE * RATIO) ** 2 * CHANNELS  # 4 corners a sample, channel
        result[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             **bound(name, in_bytes, out_bytes, flops))
        log(f"{name}: kernel (zero fill, atomics, cast) {ms:.4f} ms, of which the zero fill "
            f"alone {zero_ms:.4f} ms and the cast alone {cast_ms:.4f} ms; plain {plain_ms:.3f} ms, "
            "library_ms none (no PyTorch call computes this backward; torchvision is not used)")
    return result


def variant_inputs(gen: torch.Generator, c: int):
    """2 images of 128 x 192 with c channels, 64 rois an image from 4 to
    300 px, the first four padded."""
    device = torch.device("cuda")
    h, w = 128, 192
    xy = torch.rand((2, 64, 2), generator=gen, device=device) * torch.tensor([w, h], device=device)
    wh = 4.0 * 75.0 ** torch.rand((2, 64, 2), generator=gen, device=device)
    rois = torch.cat([xy, xy + wh], dim=-1)
    rois[:, :4] = 0.0  # padded proposals
    feats32 = [torch.randn((2, h // s, w // s, c), generator=gen, device=device) for s in STRIDES]
    return feats32, rois


VARIANTS = ((5, 14, 2), (6, 4, 3), (130, 7, 1))  # (channels, out size, sampling ratio)


def phase_roi_align_variants() -> None:
    """K1 at shapes the slice does not use but the wrapper accepts: an odd
    channel count (one channel a thread instead of two), the mask head's out
    size 14, other sampling ratios."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for c, out_size, ratio in VARIANTS:
        feats32, rois = variant_inputs(gen, c)
        levels = roi_align.map_rois_to_levels(rois, len(STRIDES))
        for dtype in (torch.float32, torch.bfloat16):
            feats = [f.to(dtype) for f in feats32]
            got = roi_align.multilevel_roi_align_cuda(feats, rois, levels, STRIDES, out_size, ratio)
            want = roi_align.multilevel_roi_align(feats, rois, levels, STRIDES, out_size, ratio)
            name = f"roi_align_fwd C={c} out={out_size} ratio={ratio} {str(dtype).replace('torch.', '')}"
            (check_f32 if dtype == torch.float32 else check_bf16)(name, got, want)


def phase_roi_align_bwd_variants() -> None:
    """K2 at the same small shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for c, out_size, ratio in VARIANTS:
        feats32, rois = variant_inputs(gen, c)
        levels = roi_align.map_rois_to_levels(rois, len(STRIDES))
        shapes = [tuple(f.shape[1:3]) for f in feats32]
        grad32 = torch.randn((*rois.shape[:2], out_size, out_size, c), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            grad = grad32.to(dtype)
            args = (grad, rois, levels, shapes, STRIDES, out_size, ratio)
            got = roi_align.multilevel_roi_align_backward_cuda(*args)
            want = roi_align.multilevel_roi_align_backward(*args)
            check_grads(f"roi_align_bwd C={c} out={out_size} ratio={ratio} "
                        f"{str(dtype).replace('torch.', '')}", got, want, dtype)


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
    roi_align.multilevel_roi_align_backward_cuda.launches = 0
    syncs0 = nms_ops.suppress_syncs()
    seconds, results = [], []
    for x in images[WARMUP_BATCHES:]:
        t0 = time.perf_counter()
        res = infer(x, img_shape, scale)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        results.append(res)
    launches = roi_align.multilevel_roi_align_cuda.launches
    bwd_launches = roi_align.multilevel_roi_align_backward_cuda.launches
    syncs = nms_ops.suppress_syncs() - syncs0

    log(f"serving path: {TIMED_BATCHES} batches, K1 launches {launches}, K2 launches "
        f"{bwd_launches}, NMS fixpoint syncs {syncs / TIMED_BATCHES:.1f} a batch")
    if launches != TIMED_BATCHES or bwd_launches != 0:
        raise AssertionError(f"expected one K1 launch a batch and no K2 launch, got {launches} "
                             f"and {bwd_launches}")
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
    log(f"serving path: ms a batch {[round(m, 3) for m in ms]}, mean {mean_ms:.3f} ms, "
        f"{BATCH / (mean_ms / 1e3):.2f} images/s, median {statistics.median(ms):.3f} ms "
        f"[{card}]; valid detections a batch {valid}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the kernel against the plain version on this run's FPN levels and proposals
    with torch.inference_mode():
        feats, rpn_s, rpn_d = model(images[1])
        props = generate_proposals(det_cfg.proposal_test, det_cfg.anchor_generator, rpn_s, rpn_d,
                                   img_shape)
        maps = list(feats[: len(det_cfg.roi_strides)])
        routed = roi_align.map_rois_to_levels(props.boxes, len(maps), det_cfg.finest_scale)
        got = roi_align.multilevel_roi_align_cuda(maps, props.boxes, routed, det_cfg.roi_strides)
        want = roi_align.multilevel_roi_align(maps, props.boxes, routed, det_cfg.roi_strides)
        check_bf16("roi_align on the main path's levels and proposals", got, want)
    stage_breakdown(model, det_cfg, images[1], img_shape, card)
    device_profile(lambda: infer(images[1], img_shape, scale), mean_ms, card)
    return dict(launches=launches, bwd_launches=bwd_launches, ms_per_batch=mean_ms)


def device_profile(run_batch, batch_ms: float, card: str, what: str = "batch") -> None:
    """One batch (or step) under torch.profiler: the time in which the
    device ran a kernel, its share of an unprofiled one (``batch_ms``), and
    the PyTorch operators whose kernels took most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_batch()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"device profile, one {what} [{card}]: not measured (the profiler recorded no device "
            "events)")
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
    log(f"device profile, one {what} [{card}]: device busy {busy_ms:.3f} ms in {len(kernels)} "
        f"kernels, idle share of an unprofiled {batch_ms:.3f} ms {what} {1 - busy_ms / batch_ms:.3f}; "
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


class Batches:
    """A loader over ready batches: what ``Trainer`` asks of a loader."""

    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch: int) -> None:
        pass

    def iter_batches(self):
        return (dict(b) for b in self.batches)

    def __len__(self) -> int:
        return len(self.batches)


def train_batch(gen: torch.Generator) -> dict:
    """4 seeded images on the 800 x 1216 canvas, two filling it and two of
    640 x 960 and 704 x 1088 with zeros outside, and 1-20 gt boxes an image
    (16-400 px, labels 1-80) inside each image, padded to 100."""
    device = torch.device("cuda")
    h, w = CANVAS
    shapes = torch.tensor([[h, w], [h, w], [640, 960], [704, 1088]], dtype=torch.float32,
                          device=device)
    image = torch.randn((BATCH, h, w, 3), generator=gen, device=device)
    inside = ((torch.arange(h, device=device)[None, :, None] < shapes[:, 0, None, None])
              & (torch.arange(w, device=device)[None, None, :] < shapes[:, 1, None, None]))
    image = image * inside[..., None]
    u = torch.rand((BATCH, MAX_GTS, 4), generator=gen, device=device)
    size = 16.0 * 25.0 ** u[..., 2:]
    xy = u[..., :2] * (shapes[:, None, [1, 0]] - 1 - size)
    num = torch.randint(1, 21, (BATCH, 1), generator=gen, device=device)
    valid = torch.arange(MAX_GTS, device=device)[None, :] < num
    boxes = torch.where(valid[..., None], torch.cat([xy, xy + size], dim=-1), 0.0)
    labels = torch.randint(1, 81, (BATCH, MAX_GTS), generator=gen, device=device)
    return dict(image=image, gt_boxes=boxes, gt_labels=torch.where(valid, labels, 0),
                gt_valid=valid, img_shape=shapes)


LOSS_KEYS = ("loss", "loss_rpn_cls", "loss_rpn_reg", "loss_rcnn_cls", "loss_rcnn_reg")


def phase_train(card: str) -> dict:
    """Full-width Faster R-CNN R50-FPN training, float32 parameters and bf16
    compute, b4 on the 800 x 1216 canvas, through the entry points a user
    calls; K1's and K2's launches are counted over the timed steps."""
    cfg = Config.fromfile(CONFIG)
    steps = WARMUP_BATCHES + TIMED_BATCHES
    model, det_cfg, optimizer = build_train_objects(cfg, steps, device="cuda", seed=SEED)
    loss_fn = build_loss_fn(model, det_cfg, rng_seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    batches = [train_batch(gen) for _ in range(steps)]
    Trainer(loss_fn, optimizer, Batches(batches[:WARMUP_BATCHES]), log_interval=1).run(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(loss_fn, optimizer, Batches(batches[WARMUP_BATCHES:]), log_interval=1)

    roi_align.multilevel_roi_align_cuda.launches = 0
    roi_align.multilevel_roi_align_backward_cuda.launches = 0
    t0 = time.perf_counter()
    history = trainer.run(1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1 = roi_align.multilevel_roi_align_cuda.launches
    k2 = roi_align.multilevel_roi_align_backward_cuda.launches

    log(f"training path: {TIMED_BATCHES} steps, K1 launches {k1}, K2 launches {k2}")
    if k1 != TIMED_BATCHES or k2 != TIMED_BATCHES:
        raise AssertionError(f"expected one K1 and one K2 launch a step, got {k1} and {k2}")
    if len(history) != TIMED_BATCHES or trainer.skipped_steps:
        raise AssertionError(f"{len(history)} steps logged, {trainer.skipped_steps} skipped")
    for h in history:
        if not all(torch.isfinite(torch.tensor(h[k])) for k in LOSS_KEYS):
            raise AssertionError(f"non-finite loss at step {h['step']}: {h}")
        if not h["num_pos_rois"] > 0:
            raise AssertionError(f"no positive roi at step {h['step']}")
    still = [n for n, p in model.named_parameters() if p.requires_grad and torch.equal(p, before[n])]
    moved = [n for n, p in model.named_parameters() if not p.requires_grad and not torch.equal(p, before[n])]
    frozen = sum(not p.requires_grad for p in model.parameters())
    if still or moved or not frozen:
        raise AssertionError(f"trainable parameters that did not move {still}; frozen ones that "
                             f"moved {moved}; {frozen} frozen")
    step_ms = [BATCH / h["images_per_sec"] * 1e3 for h in history]
    mean_ms = seconds / TIMED_BATCHES * 1e3
    log(f"training path: ms a step {[round(m, 3) for m in step_ms]}, mean {mean_ms:.3f} ms, "
        f"{BATCH / (mean_ms / 1e3):.2f} images/s, median {statistics.median(step_ms):.3f} ms [{card}]; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{len(before) - frozen} trainable and {frozen} frozen parameter tensors; losses first "
        + ", ".join(f"{k} {history[0][k]:.4f}" for k in LOSS_KEYS)
        + "; last " + ", ".join(f"{k} {history[-1][k]:.4f}" for k in LOSS_KEYS)
        + f"; positive rois a step {[int(h['num_pos_rois']) for h in history]}")
    device_profile(lambda: trainer.train_step(dict(batches[-1])), mean_ms, card, "step")
    train_stage_breakdown(model, det_cfg, optimizer, batches[-1], card)
    return dict(k1=k1, k2=k2, ms_per_step=mean_ms, model=model, det_cfg=det_cfg,
                batch=batches[-1])


def train_stage_breakdown(model, det_cfg, optimizer, batch, card: str, repeats: int = 5) -> None:
    """A training step stage by stage (the stages of
    ``two_stage._faster_rcnn_loss_core``, the backward and the optimizer), a
    device sync between stages; the median host ms of each over ``repeats``
    steps."""
    noise = functools.partial(sampling_noise, torch.Generator(device="cuda").manual_seed(SEED + 10))
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
    times = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    def rpn_stage(rpn_s, rpn_d):
        anchors = det_cfg.anchor_generator.flat_anchors([tuple(x.shape[1:3]) for x in rpn_s], "cuda")
        return rpn_losses(det_cfg, anchors, *flatten_rpn_outputs(rpn_s, rpn_d), *gt, noise)

    def roi_stage(feats, sampled):
        roi_feats = roi_align.batched_multilevel_roi_align(
            list(feats[: len(det_cfg.roi_strides)]), sampled.rois, det_cfg.roi_strides,
            det_cfg.roi_size)
        return rcnn_losses(det_cfg, *model.roi_forward(roi_feats), sampled)

    for _ in range(repeats):
        optimizer.zero_grad()
        feats, rpn_s, rpn_d = stage("backbone+fpn+rpn head", lambda: model(batch["image"]))
        rpn_l = stage("rpn assign, sample, losses", lambda: rpn_stage(rpn_s, rpn_d))
        props = stage("proposals (top-k, decode, NMS)", lambda: generate_proposals(
            det_cfg.proposal_train, det_cfg.anchor_generator, [x.detach() for x in rpn_s],
            [x.detach() for x in rpn_d], batch["img_shape"]))
        sampled = stage("roi assign and sample", lambda: sample_rois(det_cfg, props, *gt, noise))
        rcnn_l = stage("roi_align K1, box head, losses", lambda: roi_stage(feats, sampled))
        loss = rpn_l[0].mean() + rpn_l[1].mean() + rcnn_l[0] + rcnn_l[1]
        stage("backward (K2 in it)", loss.backward)
        stage("grad norm, clip, SGD", lambda: optimizer.apply(optimizer.global_norm()))
    optimizer.zero_grad()
    median = {k: statistics.median(v) for k, v in times.items()}
    total = sum(median.values())
    log(f"training stage breakdown, median of {repeats} steps [{card}]: " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / total:.1f}%)" for k, v in median.items()))


def phase_train_bwd_on_step_data(model, det_cfg, batch) -> None:
    """K2 against its plain version on a training step's own FPN levels,
    sampled rois and the box head's cotangent."""
    noise = functools.partial(sampling_noise, torch.Generator(device="cuda").manual_seed(SEED + 7))
    feats, rpn_s, rpn_d = model(batch["image"])
    props = generate_proposals(det_cfg.proposal_train, det_cfg.anchor_generator,
                               [s.detach() for s in rpn_s], [d.detach() for d in rpn_d],
                               batch["img_shape"])
    sampled = sample_rois(det_cfg, props, batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"],
                          noise)
    levels_in = list(feats[: len(det_cfg.roi_strides)])
    roi_feats = roi_align.batched_multilevel_roi_align(levels_in, sampled.rois, det_cfg.roi_strides,
                                                      det_cfg.roi_size)
    cls, reg = model.roi_forward(roi_feats)
    (cotangent,) = torch.autograd.grad(sum(rcnn_losses(det_cfg, cls, reg, sampled)), roi_feats)
    levels = roi_align.map_rois_to_levels(sampled.rois, len(levels_in))
    args = (cotangent, sampled.rois, levels, [tuple(f.shape[1:3]) for f in levels_in],
            det_cfg.roi_strides, det_cfg.roi_size)
    check_grads("roi_align_bwd on a training step's levels, sampled rois and box-head cotangent",
                roi_align.multilevel_roi_align_backward_cuda(*args),
                roi_align.multilevel_roi_align_backward(*args), cotangent.dtype)


def same_noise(seed: int, device):
    """A ``noise`` function whose draws come from a CPU generator of
    ``seed``, moved to ``device``: equal draws on both devices."""
    gen = torch.Generator().manual_seed(seed)
    return lambda shape: tuple(t.to(device) for t in sampling_noise(gen, shape))


def phase_train_reference() -> None:
    """The training path in float32 on the GPU and on the CPU, stage by
    stage on a small canvas with the same sampling draws. Each GPU stage's
    output feeds the CPU counterpart of the next stage."""
    cfg = Config.fromfile(CONFIG)
    det_cfg = build_detection_cfg(cfg.detection)
    gpu = build_detector(cfg.model, "float32", "cuda", seed=SEED).train()
    cpu = build_detector(cfg.model, "float32", "cpu", seed=SEED).train()
    gen = torch.Generator().manual_seed(SEED + 8)
    x = torch.randn((2, 256, 320, 3), generator=gen)
    gt = dict(
        gt_boxes=torch.tensor([[[16, 20, 120, 140], [150, 40, 300, 230], [60, 150, 110, 250], [0] * 4],
                               [[30, 30, 200, 180], [210, 100, 290, 200], [0] * 4, [0] * 4]],
                              dtype=torch.float32),
        gt_labels=torch.tensor([[3, 17, 80, 0], [1, 45, 0, 0]]),
        gt_valid=torch.tensor([[True, True, True, False], [True, True, False, False]]),
    )
    gt_gpu = {k: v.cuda() for k, v in gt.items()}
    shapes = torch.tensor([[256.0, 320.0], [240.0, 300.0]])
    noise_gpu, noise_cpu = same_noise(SEED + 9, "cuda"), same_noise(SEED + 9, "cpu")
    strides = det_cfg.roi_strides
    checks = []

    def check(name, err, limit):
        checks.append(f"{name} {err:.2e} (limit {limit:g})")
        if not err <= limit:
            raise AssertionError(f"training reference check {name}: {err} > {limit}")

    fg, sg, dg = gpu(x.cuda())
    with torch.no_grad():
        fc, sc, dc = cpu(x)
    # cuDNN and the CPU pick other convolution algorithms and sum orders
    check("fpn levels", max(rel_err(g, c) for g, c in zip(fg, fc)), 1e-3)
    check("rpn outputs", max(rel_err(g, c) for g, c in zip(sg + dg, sc + dc)), 1e-3)

    sizes = [tuple(s.shape[1:3]) for s in sg]
    flat_s, flat_d = flatten_rpn_outputs([s.detach() for s in sg], [d.detach() for d in dg])
    rpn_g = rpn_losses(det_cfg, det_cfg.anchor_generator.flat_anchors(sizes, "cuda"), flat_s, flat_d,
                       gt_gpu["gt_boxes"], gt_gpu["gt_labels"], gt_gpu["gt_valid"], noise_gpu)
    rpn_c = rpn_losses(det_cfg, det_cfg.anchor_generator.flat_anchors(sizes, "cpu"), flat_s.cpu(),
                       flat_d.cpu(), gt["gt_boxes"], gt["gt_labels"], gt["gt_valid"], noise_cpu)
    check("rpn losses", rel_err(torch.stack(rpn_g), torch.stack(rpn_c)), 1e-3)

    props = generate_proposals(det_cfg.proposal_train, det_cfg.anchor_generator,
                               [s.detach() for s in sg], [d.detach() for d in dg], shapes.cuda())
    sg_ = sample_rois(det_cfg, props, gt_gpu["gt_boxes"], gt_gpu["gt_labels"], gt_gpu["gt_valid"],
                      noise_gpu)
    sc_ = sample_rois(det_cfg, type(props)(*(t.cpu() for t in props)), gt["gt_boxes"],
                      gt["gt_labels"], gt["gt_valid"], noise_cpu)
    for field in ("rois", "labels", "is_pos", "is_valid"):
        check(f"sampled {field} mismatches",
              float((getattr(sg_, field).cpu() != getattr(sc_, field)).sum()), 0)
    check("regression targets", rel_err(sg_.reg_targets, sc_.reg_targets), 1e-5)
    if not bool(sg_.is_pos.any()):
        raise AssertionError("no positive roi in the reference batch")

    lg = [f.detach().requires_grad_() for f in fg[: len(strides)]]
    lc = [f.detach().cpu().requires_grad_() for f in fg[: len(strides)]]
    rg = roi_align.batched_multilevel_roi_align(lg, sg_.rois, strides)
    rc = roi_align.batched_multilevel_roi_align(lc, sc_.rois, strides)
    loss_g = rcnn_losses(det_cfg, *gpu.roi_forward(rg), sg_)
    loss_c = rcnn_losses(det_cfg, *cpu.roi_forward(rc), sc_)
    check("roi losses", rel_err(torch.stack(loss_g), torch.stack(loss_c)), 1e-3)
    grads_g = torch.autograd.grad(sum(loss_g), lg)
    grads_c = torch.autograd.grad(sum(loss_c), lc)
    check("roi stage gradients into the fpn levels (K2 vs plain on the CPU)",
          max(rel_err(g, c) for g, c in zip(grads_g, grads_c)), 1e-3)
    log("training reference check, GPU vs CPU float32: " + "; ".join(checks))


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

    fwd = phase_roi_align(ROIS)[torch.bfloat16]
    fwd_train = phase_roi_align(TRAIN_ROIS)[torch.bfloat16]
    phase_roi_align_variants()
    bwd = phase_roi_align_bwd()[torch.bfloat16]
    phase_roi_align_bwd_variants()
    serve = phase_model(card)
    phase_reference()
    train = phase_train(card)
    phase_train_bwd_on_step_data(train["model"], train["det_cfg"], train["batch"])
    del train["model"]
    phase_train_reference()

    def entry(name, replaces, launches, m, **extra):
        return {
            "name": name,
            "route": "cuda",
            "source": f"torch_detection_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            **{k: m[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            **extra,
        }

    line = {"kernels": [
        entry("roi_align_fwd", "torch_detection_tpu/ops/roi_align_pallas.py:65",
              {"serving": serve["launches"], "training": train["k1"]}, fwd,
              at_train_rois={k: fwd_train[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")}),
        entry("roi_align_bwd", "torch_detection_tpu/ops/roi_align_pallas.py:301",
              {"serving": serve["bwd_launches"], "training": train["k2"]}, bwd),
    ]}
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
