"""Every family of the port's ``build_loss_fn`` on a narrow model, and one
SGD step of each, for the data-parallel tests.

The models are the narrow ones of the families' parity and export tests
(``test_torch_export.py``: ResNet-18, FPN 32, one conv a tower), with
Fast R-CNN added and SSD on the same ResNet-18 and FPN (its SSDVGG trunk
has no width knob, and the loss is what the data-parallel step must
hold); the two-stage families sample as ``test_torch_train.py``'s. The
batch has 1, 3, 2 and 1 valid gts in its four images, so that each
rank's half counts differently. This module imports neither JAX nor the
JAX package: the 2-rank test spawns processes that import it.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import time
from typing import Dict, List
from unittest import mock

import numpy as np
import torch
from torch.distributed import barrier
from torch.distributed.fsdp._fully_shard import _fsdp_param as fsdp_param

from torch_detection_tpu_torch.builder import build_detector, build_loss_fn
from torch_detection_tpu_torch.engine import Trainer
from torch_detection_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from torch_detection_tpu_torch.models import detectors as d
from torch_detection_tpu_torch.models.heads import ProposalConfig
from torch_detection_tpu_torch.ops import anchors as a
from torch_detection_tpu_torch.parallel import make_optimizer, make_train_step
from torch_detection_tpu_torch.parallel.distributed import all_gather_objects, broadcast_object
from torch_detection_tpu_torch.parallel.mesh import full_tensor, unsharded

R18_P3 = dict(type="ResNet", depth=18, num_stages=4, out_indices=(1, 2, 3))
R18_P2 = dict(type="ResNet", depth=18, num_stages=4, out_indices=(0, 1, 2, 3))
FPN_P3 = dict(type="FPN", in_channels=(128, 256, 512), out_channels=32, num_outs=5,
              add_extra_convs=True, extra_convs_on_inputs=True, relu_before_extra_convs=True)
FPN_P2 = dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=32, num_outs=5)
RPN = dict(type="RPNHead", in_channels=32, feat_channels=32, num_base_anchors=3)
BBOX = dict(type="BBoxHead", num_classes=4, fc_channels=64)
FCN = dict(type="FCNMaskHead", num_classes=4, in_channels=32, conv_channels=16, num_convs=1)
RETINA_HEAD = dict(type="RetinaHead", num_classes=4, in_channels=32, feat_channels=32,
                   stacked_convs=1, num_base_anchors=9)
SAMPLES = dict(proposal_train=ProposalConfig(pre_nms_per_level=64, post_nms_top_k=32),
               rpn_num_samples=32, rcnn_num_samples=16)
MASKS = dict(mask_roi_size=7, mask_size=14)
RETINA_ANCHORS = a.AnchorGenerator(strides=(8, 16, 32, 64, 128), ratios=(0.5, 1.0, 2.0),
                                   octave_base_scale=4.0, scales_per_octave=3)
SQUARE_ANCHORS = a.AnchorGenerator(strides=(8, 16, 32, 64, 128), ratios=(1.0,),
                                   octave_base_scale=8.0, scales_per_octave=1)
CANVAS = (64, 64)
BATCH = 4  # the global batch: two images a rank
PROPOSALS = 24  # Fast R-CNN's slate


def _dense(head):
    return dict(type="SingleStageDetector", backbone=R18_P3, neck=FPN_P3, head=head)


def _tower(kind, **kw):
    return _dense(dict(type=kind, num_classes=4, in_channels=32, feat_channels=32,
                       stacked_convs=1, **kw))


# name: (model dict, detection config)
FAMILIES = {
    "faster_rcnn": (dict(type="TwoStageDetector", backbone=R18_P2, neck=FPN_P2, rpn_head=RPN,
                         bbox_head=BBOX),
                    d.FasterRCNNConfig(num_classes=4, **SAMPLES)),
    "mask_rcnn": (dict(type="MaskRCNN", backbone=R18_P2, neck=FPN_P2, rpn_head=RPN,
                       bbox_head=BBOX, mask_head=FCN),
                  d.MaskRCNNConfig(num_classes=4, **SAMPLES, **MASKS)),
    "cascade_rcnn": (dict(type="CascadeRCNN", backbone=R18_P2, neck=FPN_P2, rpn_head=RPN,
                          bbox_head=BBOX, num_stages=3),
                     d.CascadeRCNNConfig(num_classes=4, **SAMPLES)),
    "cascade_mask_rcnn": (dict(type="CascadeMaskRCNN", backbone=R18_P2, neck=FPN_P2,
                               rpn_head=RPN, bbox_head=BBOX, mask_head=FCN, num_stages=3),
                          d.CascadeMaskRCNNConfig(num_classes=4, **SAMPLES, **MASKS)),
    "fast_rcnn": (dict(type="FastRCNN", backbone=R18_P2, neck=FPN_P2, bbox_head=BBOX),
                  d.FastRCNNConfig(num_classes=4, rcnn_num_samples=16)),
    "sparse_rcnn": (dict(type="SparseRCNN", backbone=R18_P2,
                         neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=32,
                                   num_outs=4),
                         num_proposals=8, num_stages=2, num_classes=4, d_model=32, nhead=4,
                         dim_feedforward=64, dynamic_dim=16, roi_size=7,
                         roi_strides=(4, 8, 16, 32)),
                    d.SparseRCNNConfig(num_classes=4, num_proposals=8)),
    "detr": (dict(type="DETR", backbone=dict(type="ResNet", depth=18, num_stages=4,
                                             out_indices=(3,)),
                  num_classes=4, d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=2,
                  dim_feedforward=64, num_queries=8),
             d.DETRConfig(num_classes=4, num_queries=8)),
    "retina": (_dense(RETINA_HEAD), d.RetinaNetConfig(num_classes=4,
                                                      anchor_generator=RETINA_ANCHORS)),
    "free_anchor": (_dense(RETINA_HEAD), d.FreeAnchorConfig(num_classes=4,
                                                            anchor_generator=RETINA_ANCHORS)),
    "fcos": (_tower("FCOSHead"), d.FCOSConfig(num_classes=4)),
    "atss": (_tower("ATSSHead"), d.ATSSConfig(num_classes=4, anchor_generator=SQUARE_ANCHORS)),
    "gfl": (_tower("GFLHead", reg_max=8),
            d.GFLConfig(num_classes=4, reg_max=8, anchor_generator=SQUARE_ANCHORS)),
    "fovea": (_tower("FoveaHead"), d.FoveaConfig(num_classes=4)),
    "paa": (_tower("PAAHead"), d.PAAConfig(num_classes=4, anchor_generator=SQUARE_ANCHORS)),
    "ssd": (dict(type="SingleStageDetector", backbone=R18_P3,
                 neck=dict(FPN_P3, num_outs=6),
                 head=dict(type="SSDHead", num_classes=4, in_channels=(32,) * 6,
                           anchors_per_level=(4, 6, 6, 6, 4, 4))),
            d.SSDConfig(num_classes=4, anchor_generator=a.SSDAnchorGenerator())),
    "yolo": (dict(type="SingleStageDetector",
                  backbone=dict(type="Darknet", depth=53, stages=(1, 1, 1, 1, 1), base_channels=8,
                                out_indices=(2, 3, 4)),
                  neck=dict(type="YOLOV3Neck", in_channels=(64, 128, 256),
                            out_channels=(64, 32, 16)),
                  head=dict(type="YOLOV3Head", num_classes=4, anchors_per_level=1,
                            in_channels=(64, 32, 16), out_channels=(128, 64, 32))),
             d.YOLOV3Config(num_classes=4, anchor_generator=a.YOLOAnchorGenerator(
                 strides=(32, 16, 8),
                 base_sizes=(((48.0, 48.0),), ((24.0, 24.0),), ((12.0, 12.0),))))),
    "yolox": (dict(type="SingleStageDetector",
                   backbone=dict(type="CSPDarknet", deepen_factor=0.33, widen_factor=0.125,
                                 out_indices=(2, 3, 4)),
                   neck=dict(type="YOLOXPAFPN", in_channels=(32, 64, 128), out_channels=32,
                             num_csp_blocks=1),
                   head=dict(type="YOLOXHead", num_classes=4, in_channels=32, feat_channels=32,
                             stacked_convs=1)),
              d.YOLOXConfig(num_classes=4)),
    "centernet": (dict(type="SingleStageDetector",
                       backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(3,)),
                       neck=dict(type="CTResNetNeck", in_channels=512,
                                 num_deconv_filters=(32, 16, 16)),
                       head=dict(type="CenterNetHead", num_classes=4, in_channels=16,
                                 feat_channels=16)),
                  d.CenterNetConfig(num_classes=4)),
    "solov2": (dict(type="SOLOV2", backbone=R18_P2,
                    neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=16,
                              num_outs=5),
                    head=dict(type="SOLOV2Head", num_classes=4, in_channels=16, feat_channels=16,
                              kernel_channels=8, stacked_convs=1,
                              grid_numbers=(12, 10, 8, 6, 4), norm_groups=4),
                    mask_feat_head=dict(type="MaskFeatHead", in_channels=16, feat_channels=16,
                                        out_channels=8, num_inputs=4, norm_groups=4)),
               d.SOLOV2Config(num_classes=4, grid_numbers=(12, 10, 8, 6, 4),
                              scale_ranges=((1, 32), (16, 48), (32, 64), (48, 96), (64, 256)))),
}
FSDP_FAMILY = "faster_rcnn"
PREEMPT_FAMILY = "yolox"  # the quickest step
# the JAX package's 2-device mesh test model (tests/test_multihost_train.py), its weights handed in
R18_MODEL = dict(type="SingleStageDetector",
                 backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(1, 2, 3)),
                 neck=dict(type="FPN", in_channels=(128, 256, 512), out_channels=16, num_outs=5,
                           add_extra_convs=True),
                 head=dict(type="RetinaHead", num_classes=2, in_channels=16, feat_channels=16,
                           stacked_convs=1, num_base_anchors=9))
R18_CANVAS = (128, 128)
R18_INIT = "r18_init.pt"  # its state dict, in the directory the ranks write to
R18_DP = "r18_dp.pt"  # rank 0's parameters after its step
WAIT_S = 300.0  # how long a process waits for a file another writes
FSDP_CKPT = "fsdp_ckpt"  # the FSDP step's checkpoint, in the same directory
GTS = (1, 3, 2, 1)  # valid gts of each image of the global batch
LR, MOMENTUM, WD, CLIP = 0.01, 0.9, 1e-4, 1.0  # a clip the steps' gradient norms exceed
LOSS_RTOL = 2e-5
PARAM_TOL = dict(rtol=2e-4, atol=2e-6)
FSDP_TOL = dict(rtol=2e-3, atol=8e-6)  # the reference's FSDP tolerance


def global_batch(seed: int = 0, b: int = BATCH, canvas=CANVAS,
                 num_classes: int = 4) -> Dict[str, np.ndarray]:
    """``b`` seeded images with ``GTS[i]`` gt boxes of classes 1 to ``num_classes`` each,
    the second half smaller than the canvas, a filled ellipse mask inside
    each gt and Fast R-CNN's slate of ``PROPOSALS`` (jittered gts and random
    boxes, the last quarter invalid)."""
    rng = np.random.default_rng(seed)
    h, w = canvas
    g = max(GTS)
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for k in range(GTS[i % len(GTS)]):
            x1, y1 = rng.uniform(0, w * 0.6), rng.uniform(0, h * 0.6)
            bw, bh = rng.uniform(10, w * 0.4), rng.uniform(10, h * 0.4)
            boxes[i, k] = [x1, y1, min(x1 + bw, w - 1), min(y1 + bh, h - 1)]
            valid[i, k] = True
    labels = np.where(valid, rng.integers(1, num_classes + 1, (b, g)), 0).astype(np.int32)
    yy, xx = np.mgrid[:h, :w] + 0.5
    masks = np.zeros((b, g, h, w), np.uint8)
    for i, k in zip(*np.nonzero(valid)):
        x1, y1, x2, y2 = boxes[i, k]
        cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
        masks[i, k] = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
    n = PROPOSALS - PROPOSALS // 4
    props = np.zeros((b, PROPOSALS, 4), np.float32)
    for i in range(b):
        src = boxes[i][valid[i]][rng.integers(0, valid[i].sum(), n // 2)]
        wh = np.repeat(src[:, 2:] - src[:, :2], 2, axis=1)
        xy = rng.uniform(0, w - 16, (n - n // 2, 2))
        rand = np.concatenate([xy, xy + rng.uniform(4, 16, xy.shape)], axis=1)
        props[i, :n] = np.clip(np.concatenate([src + rng.uniform(-0.25, 0.25, src.shape) * wh,
                                               rand]), 0, w - 1)
    shapes = np.array([[h, w] if i < b // 2 else [h - 8, w - 12] for i in range(b)], np.float32)
    return dict(image=rng.normal(size=(b, h, w, 3)).astype(np.float32), gt_boxes=boxes,
                gt_labels=labels, gt_valid=valid, gt_masks=masks, img_shape=shapes,
                proposals=props, proposal_valid=np.arange(PROPOSALS)[None].repeat(b, 0) < n)


def family_batch(name: str, batch: Dict[str, np.ndarray], rows=slice(None)) -> Dict[str, torch.Tensor]:
    """The keys ``name``'s loss reads, rows ``rows``, as tensors."""
    keys = ["image", "gt_boxes", "gt_labels", "gt_valid", "img_shape"]
    if name in ("mask_rcnn", "cascade_mask_rcnn", "solov2"):
        keys.append("gt_masks")
    if name == "fast_rcnn":
        keys += ["proposals", "proposal_valid"]
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k][rows])) for k in keys}


def _wait_for(path: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)


def model_from(model_dict, state: Dict[str, torch.Tensor]):
    """The detector of ``model_dict`` in float32 on the CPU, in train mode,
    holding a copy of ``state``: built on the meta device and given the
    copy, since its own draw takes about a second for a ResNet-18."""
    with mock.patch("torch_detection_tpu_torch.builder.init_weights"):
        model = build_detector(model_dict, "float32", "meta")
    model.load_state_dict({k: v.clone() for k, v in state.items()}, strict=True, assign=True)
    return model.train()


def build(name: str, state: Dict[str, torch.Tensor], fsdp: bool = False):
    """(model, loss_fn, optimizer) of ``name`` from ``state``, the step's
    SGD with momentum, weight decay and a clip; with ``fsdp`` the model
    sharded over the group's ranks first."""
    model_dict, det_cfg = FAMILIES[name]
    model = model_from(model_dict, state)
    root = None
    if fsdp:
        from torch_detection_tpu_torch.parallel import make_mesh, shard_model

        root = shard_model(model, make_mesh(device_type="cpu"))
    optimizer = make_optimizer(model.parameters(), LR, MOMENTUM, WD, CLIP, fsdp_root=root)
    return model, build_loss_fn(model, det_cfg, rng_seed=5), optimizer


def state_of(model, optimizer) -> Dict[str, torch.Tensor]:
    """Every parameter and momentum buffer, whole (a gather under FSDP)."""
    out = {n: full_tensor(p).detach().clone() for n, p in model.named_parameters()}
    names = {id(p): n for n, p in model.named_parameters()}
    for p in optimizer.params:
        out["momentum." + names[id(p)]] = full_tensor(
            optimizer.torch_optimizer.state[p]["momentum_buffer"]).detach().clone()
    return out


def step(model, loss_fn, optimizer, batch) -> Dict[str, object]:
    """One ``make_train_step`` step: its metrics and the state after it
    (the global batch's step in a group of several ranks, else this
    process's)."""
    metrics = make_train_step(loss_fn, optimizer)(batch)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                state=state_of(model, optimizer))


def mismatches(got: Dict[str, object], want: Dict[str, object], rtol: float,
               atol: float) -> List[str]:
    """Where the step ``got`` departs from ``want``: the loss beyond
    ``LOSS_RTOL``, the skip decision, a parameter beyond ``rtol``/``atol``,
    a momentum buffer beyond ``1e-4`` of its largest entry (at least
    ``1e-8``, the rounding noise of a zero gradient, such as the attention
    key bias's)."""
    g, w = got["metrics"], want["metrics"]
    out = []
    if abs(g["loss"] - w["loss"]) > LOSS_RTOL * abs(w["loss"]):
        out.append(f"loss {g['loss']!r} vs {w['loss']!r}")
    if not g["skipped_nonfinite"] == w["skipped_nonfinite"] == 0.0:
        out.append(f"skipped {g['skipped_nonfinite']} vs {w['skipped_nonfinite']}")
    if set(got["state"]) != set(want["state"]):
        return out + ["the state's names"]
    for name, v in want["state"].items():
        r, a = ((0.0, max(1e-4 * float(v.abs().max()), 1e-8)) if name.startswith("momentum.")
                else (rtol, atol))
        x = got["state"][name]
        if not torch.allclose(x, v, rtol=r, atol=a):
            excess = float(((x - v).abs() - a - r * v.abs()).max())
            out.append(f"{name}: {excess:.3g} past rtol {r:g} atol {a:.3g}")
    return out


def digests(state: Dict[str, torch.Tensor]) -> Dict[str, str]:
    return {k: hashlib.sha256(v.contiguous().numpy().tobytes()).hexdigest()
            for k, v in state.items()}


def r18_batch(rows=slice(None)) -> Dict[str, torch.Tensor]:
    """The R18 case's global batch (2 classes on its 128 x 128 canvas), rows ``rows``."""
    return family_batch("retina", global_batch(seed=1, canvas=R18_CANVAS, num_classes=2), rows)


def r18_step(state: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]
             ) -> Dict[str, object]:
    """One step of the R18 RetinaNet from ``state`` with the reference
    test's ``optax.sgd(0.01, momentum=0.9)``: SGD, no decay, no clip."""
    model = model_from(R18_MODEL, state)
    optimizer = make_optimizer(model.parameters(), 0.01, 0.9, 0.0, None)
    loss_fn = build_loss_fn(model, d.RetinaNetConfig(num_classes=2,
                                                     anchor_generator=RETINA_ANCHORS))
    return step(model, loss_fn, optimizer, batch)


def _case(dp, single, tol) -> Dict[str, object]:
    """A case's report: the ranks' metrics, whether the replicas are equal
    bit for bit, and the departures from the one process."""
    replicas = all_gather_objects(digests(dp["state"]))
    return dict(metrics=dp["metrics"], replicas_equal=all(r == replicas[0] for r in replicas),
                single_metrics=single["metrics"] if single else None,
                mismatches=mismatches(dp, single, **tol) if single else None)


class _Batches:
    """A loader of ready batches; the rank that ``stop_at`` names asks its
    trainer to stop as it hands out that batch (a SIGTERM's handler does
    the same)."""

    def __init__(self, batch, n: int, stop_at=None):
        self.batch, self.n, self.stop_at, self.trainer = batch, n, stop_at, None

    def set_epoch(self, epoch: int) -> None:
        pass

    def iter_batches(self, skip_batches: int = 0):
        for i in range(skip_batches, self.n):
            if i == self.stop_at:
                self.trainer.request_preemption()
            yield dict(self.batch)

    def __len__(self) -> int:
        return self.n


def preempt_on_rank_1(rank: int, out_dir: str, init, batch) -> Dict[str, object]:
    """A ``Trainer`` of 4 steps on every rank, rank 1 alone asked to stop
    during step 2: every rank must stop after step 2, and rank 0 alone
    write ``step_2``."""
    model, loss_fn, optimizer = build(PREEMPT_FAMILY, init)
    loader = _Batches(batch, 4, stop_at=1 if rank == 1 else None)
    work = os.path.join(out_dir, f"preempt_r{rank}")
    trainer = Trainer(loss_fn, model, optimizer, loader, work_dir=work, log_interval=1)
    loader.trainer = trainer
    trainer.run(1)
    return dict(steps=optimizer.steps, preempted=trainer.preempted,
                wrote=sorted(os.listdir(work)) if os.path.isdir(work) else [])


def fsdp_validation_sees_the_step(model, root, image: torch.Tensor, init,
                                  state: Dict[str, torch.Tensor]) -> bool:
    """Whether the FSDP model's inference within ``unsharded`` (the
    trainer's validation) gives the features of a one-process model that
    holds ``init`` updated by the step's whole parameters ``state``, bit
    for bit. The first such inference caches each ``FrozenBatchNorm``'s
    fold; the next, after another step, must not reuse it."""
    with unsharded(root), torch.inference_mode():
        got = model(image)[0]
    plain = model_from(FAMILIES[FSDP_FAMILY][0], dict(init, **{
        k: v for k, v in state.items() if not k.startswith("momentum.")}))
    with torch.no_grad():  # the FSDP model's layout: FSDP shards contiguous tensors only
        for p in plain.parameters():
            p.data = p.data.contiguous()
    with torch.inference_mode():
        want = plain(image)[0]
    return all(torch.equal(g, w) for g, w in zip(got, want))


def rank_worker(rank: int, world: int, port: int, out_dir: str, names: List[str]) -> None:
    """One rank of a gloo CPU group. Before the group forms, each rank
    draws the initial weights of every ``world``-th family (its own) and
    takes the one-process step on the whole batch from them; rank 1 takes
    the R18 one from the parent's weights. Then, for every family, the
    drawing rank hands its weights round, each rank takes the data-parallel
    step on its shard of the global batch, and the drawing rank compares.
    Then the FSDP step, a validation, a second step and a validation, its
    checkpoint (loaded into a one-process model and resumed into a fresh
    sharded one), a ``Trainer`` that rank 1 alone is asked to stop, then
    the R18 step; rank 0 writes its R18 parameters for the parent. Each
    rank writes its report (no tensors) to ``out_dir/rank<rank>.pt``."""
    torch.set_num_threads(1)
    batch = global_batch()
    inits, singles = {}, {}
    for name in names[rank::world]:  # one process: the group does not exist yet
        inits[name] = build_detector(FAMILIES[name][0], "float32", "cpu", seed=0).state_dict()
        singles[name] = step(*build(name, inits[name]), family_batch(name, batch))
    r18_init = r18_single = None
    if rank == 1 % world:
        path = os.path.join(out_dir, R18_INIT)  # written by the parent while the ranks start
        _wait_for(path)
        r18_init = torch.load(path)
        r18_single = r18_step(r18_init, r18_batch())

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    from torch_detection_tpu_torch.parallel import init_distributed, shutdown_distributed

    info = init_distributed(device="cpu", timeout_s=300.0)
    b = BATCH // world
    rows = slice(rank * b, (rank + 1) * b)
    report = {}
    for first in range(0, len(names), world):
        for owner, name in enumerate(names[first: first + world]):
            init = broadcast_object(inits.get(name), src=owner)
            dp = step(*build(name, init), family_batch(name, batch, rows))
            report[name] = _case(dp, singles.get(name), PARAM_TOL)
            if name == FSDP_FAMILY:
                fsdp_init = init
            if name == PREEMPT_FAMILY:
                yolox_init = init

    # FSDP frees each whole parameter's storage between uses; a caching allocator (CUDA's) may
    # hand the same address back. Kept, as here, the address always comes back.
    with mock.patch.object(fsdp_param, "free_storage", lambda tensor: None):
        model, loss_fn, optimizer = build(FSDP_FAMILY, fsdp_init, fsdp=True)
        shard = family_batch(FSDP_FAMILY, batch, rows)
        dp = step(model, loss_fn, optimizer, shard)
        report["fsdp"] = _case(dp, singles.get(FSDP_FAMILY), FSDP_TOL)
        # a validation after each of two steps, as the trainer's after each epoch
        report["fsdp_validation"] = [fsdp_validation_sees_the_step(
            model, optimizer.fsdp_root, shard["image"], fsdp_init, dp["state"])]
        dp = step(model, loss_fn, optimizer, shard)
        report["fsdp_validation"].append(fsdp_validation_sees_the_step(
            model, optimizer.fsdp_root, shard["image"], fsdp_init, dp["state"]))
    # a whole checkpoint from the shards: one-process loadable, and resumed into a sharded model
    ckpt = os.path.join(out_dir, FSDP_CKPT)
    save_checkpoint(ckpt, model, optimizer, meta={"step": optimizer.steps})
    barrier()  # rank 0 has written it
    plain = model_from(FAMILIES[FSDP_FAMILY][0], fsdp_init)
    load_checkpoint(plain, ckpt, strict=True)
    model, _, optimizer = build(FSDP_FAMILY, fsdp_init, fsdp=True)
    load_checkpoint(model, ckpt, strict=True, optimizer=optimizer)
    resumed = state_of(model, optimizer)
    report["fsdp_checkpoint"] = dict(
        loads_whole=all(torch.equal(p.detach(), dp["state"][n])
                        for n, p in plain.named_parameters()),
        resumes=optimizer.steps == 2 and digests(resumed) == digests(dp["state"]))
    barrier()  # every rank has read it
    if rank == 0:
        shutil.rmtree(ckpt)

    report["preemption"] = preempt_on_rank_1(rank, out_dir, yolox_init,
                                             family_batch(PREEMPT_FAMILY, batch, rows))

    init = broadcast_object(r18_init, src=1 % world)
    dp = r18_step(init, r18_batch(rows))
    report["r18"] = _case(dp, r18_single, PARAM_TOL)
    if rank == 0:
        torch.save({k: v for k, v in dp["state"].items() if not k.startswith("momentum.")},
                   os.path.join(out_dir, R18_DP))
    torch.save(report, os.path.join(out_dir, f"rank{rank}.pt"))
    shutdown_distributed(info)
