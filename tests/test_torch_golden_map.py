"""Golden mAP of the port: a narrow model trained on the learnable synthetic
mini-COCO of ``data_fixtures.make_golden_coco`` (8 PNGs of 64 x 64, 1-2
bright squares of two classes an image) through the port's data tier, then
scored by the port's ``evaluate_detector``; each family's model, steps,
learning rate and band are the reference's (``tests/test_golden_map.py``),
not loosened.

The training cases are marked ``slow`` like the reference's file: they stay
outside Tier-1 (``TD_RUN_SLOW=1`` runs them). The reference's
``optax.adam(lr)`` is the port's AdamW with weight decay 0; the weights are
the port's own seeded init (the port builds every head when it constructs
the detector, so the reference's ``_two_stage_init`` has no counterpart),
so the scores are the port's, held to the reference's bands.

- SOLOv2 (``test_golden_map_solov2``): ResNet-18, FPN 32, 2-conv GN(8)
  towers, E = 16, grids (12, 10, 8, 6, 4), 400 steps; ``segm_mAP_50`` and
  ``mAP_50`` at least 0.3.
- The six RoI families, which run RoIAlign (K1 and K2 on the card) every
  step: Faster, Fast (on jittered-gt proposals from a pkl), Cascade,
  Cascade Mask, Mask and Sparse R-CNN, on ResNet-18 (``GOLDEN_ROI``).
  Sparse R-CNN is held to the mean of its scores over the init seeds 0-7
  (``GOLDEN_SEEDS``): one seed's score lies anywhere in 0.17-1.0. A slow
  case holds the reference's own golden Sparse R-CNN to the same mean at
  the same seeds, and another holds the port's losses and gradients to the
  reference's along the reference's golden training.

- The twelve dense and set families, which launch no RoIAlign (DETR runs
  the matcher every step): RetinaNet, FCOS, ATSS, YOLOv3, CenterNet, SSD,
  YOLOX, GFL, FoveaBox, DETR, FreeAnchor and PAA (``GOLDEN_DENSE``), each
  from seed 0.

One cheap case stays in Tier-1: each golden model builds, in float32 on the
CPU, with the JAX model's parameter count (``jax.eval_shape`` over its
``init`` and the extra RoI and mask inits, nothing compiled), so a typo in a
width does not show up only as a missed band.

The eighteen cases and the proposal writer are ``tests/torch_golden_cases.py``'s,
which ``chip_smoke.py`` reads too.
"""

import numpy as np
import pytest
import torch

from data_fixtures import make_golden_coco
from torch_detection_tpu_torch.builder import build_detector, build_loss_fn
from torch_detection_tpu_torch.data import build_dataloader, get_datasets
from torch_detection_tpu_torch.engine.validate import evaluate_detector
from torch_detection_tpu_torch.models.detectors import SOLOV2Config
from torch_detection_tpu_torch.parallel.train_step import make_optimizer, make_train_step
from torch_golden_cases import (
    CANVAS,
    GOLDEN_CASES,
    GOLDEN_DENSE,
    GOLDEN_MODELS,
    GOLDEN_ROI,
    data_cfg,
    golden_detection_cfg,
    golden_seeds,
    mean_scores,
    write_golden_proposals,
)

SOLOV2_MODEL = dict(
    type="SOLOV2",
    backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(0, 1, 2, 3)),
    neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=32, num_outs=5),
    head=dict(type="SOLOV2Head", num_classes=2, in_channels=32, feat_channels=32,
              kernel_channels=16, stacked_convs=2, grid_numbers=(12, 10, 8, 6, 4),
              norm_groups=8),
    mask_feat_head=dict(type="MaskFeatHead", in_channels=32, feat_channels=32, out_channels=16,
                        num_inputs=4, norm_groups=8),
)
SOLOV2_CFG = SOLOV2Config(
    num_classes=2, grid_numbers=(12, 10, 8, 6, 4),
    scale_ranges=((1, 32), (16, 48), (32, 64), (48, 96), (64, 256)),
    max_pos_cells=64, pre_nms_top_k=32, max_detections=10, mask_out_size=14, score_thr=0.05,
    update_thr=0.02,
)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    return make_golden_coco(str(tmp_path_factory.mktemp("golden")))


def train_and_eval(golden, model_cfg, det_cfg, with_mask: bool = False, steps: int = 80,
                   lr: float = 1e-3, batch: int = 4, seed: int = 0, proposal_file=None,
                   segm: bool = False) -> dict:
    """The reference's ``_train_and_eval`` on the port: the loader at seed 3
    with ``max_gts`` 4 on the 64 x 64 canvas (``max_proposals`` 16 with a
    proposal file), AdamW without weight decay, ``steps`` steps from the
    seeded init; the loss must fall; then
    ``evaluate_detector`` on the val split, with the mask metrics when
    ``segm`` (masks are read for training only when ``with_mask``, for
    validation only when ``segm``)."""
    loader = build_dataloader(get_datasets(data_cfg(golden, True, with_mask, proposal_file)),
                              sample_per_replica=batch, seed=3, max_gts=4, canvas=CANVAS,
                              prefetch=0, max_proposals=16 if proposal_file else None)
    model = build_detector(model_cfg, "float32", device="cpu", seed=seed).train()
    optimizer = make_optimizer(model.parameters(), lr, weight_decay=0.0, kind="adamw")
    step = make_train_step(build_loss_fn(model, det_cfg, rng_seed=seed), optimizer)
    losses, epoch = [], 0
    while len(losses) < steps:
        loader.set_epoch(epoch)
        epoch += 1
        for b in loader:
            metrics = step({k: torch.from_numpy(np.asarray(v)) for k, v in b.items()
                            if k != "img_meta"})
            losses.append(float(metrics["loss"]))
            if len(losses) >= steps:
                break
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0], (losses[0], losses[-1])
    model.eval()
    val = data_cfg(golden, False, proposal_file=proposal_file)
    val["with_mask"] = segm  # the annotations' gt masks for the mask-IoU metrics
    return evaluate_detector(model, det_cfg, get_datasets(val), batch=batch, canvas=CANVAS,
                             segm=segm)


@pytest.mark.slow
def test_golden_map_solov2(golden):
    torch.set_num_threads(4)
    res = train_and_eval(golden, SOLOV2_MODEL, SOLOV2_CFG, with_mask=True, steps=400, segm=True)
    # the reference's band: box mAP rides the stride-4 mask-extent boxes
    assert res["segm_mAP_50"] >= 0.3, res
    assert res["mAP_50"] >= 0.3, res


@pytest.mark.slow
@pytest.mark.parametrize("name", list(GOLDEN_ROI))
def test_golden_map_roi(golden, tmp_path, name):
    """Each family trained from each of its init seeds (``golden_seeds``:
    Sparse R-CNN's 0-7, the others' 0); the mean of each banded metric over
    the seeds meets the reference's band."""
    torch.set_num_threads(4)
    steps, kw, band = GOLDEN_ROI[name]
    kw = dict(kw)
    proposal_file = (write_golden_proposals(golden[0], tmp_path / "golden_props.pkl")
                     if kw.pop("proposals", False) else None)
    results = []
    for seed in golden_seeds(name):
        res = train_and_eval(golden, GOLDEN_MODELS[name], golden_detection_cfg(name),
                             steps=steps, seed=seed, proposal_file=proposal_file, **kw)
        print(name, "seed", seed, {k: res[k] for k in band})
        results.append(res)
    mean = mean_scores(results, band)
    print(name, "mean", mean)
    for key, floor in band.items():
        assert mean[key] >= floor, (key, mean, results)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(GOLDEN_DENSE))
def test_golden_map_dense(golden, name):
    """Each dense or set family trained from each of its init seeds
    (``golden_seeds``); the mean of each banded metric over the seeds meets
    the reference's band."""
    torch.set_num_threads(4)
    steps, kw, band = GOLDEN_DENSE[name]
    results = []
    for seed in golden_seeds(name):
        res = train_and_eval(golden, GOLDEN_MODELS[name], golden_detection_cfg(name),
                             steps=steps, seed=seed, **kw)
        print(name, "seed", seed, {k: res[k] for k in band})
        results.append(res)
    mean = mean_scores(results, band)
    print(name, "mean", mean)
    for key, floor in band.items():
        assert mean[key] >= floor, (key, mean, results)


@pytest.mark.slow
def test_reference_golden_sparse_rcnn_meets_its_band_over_the_same_seeds(golden):
    """The JAX package's golden Sparse R-CNN (``tests/test_golden_map.py:656-677``),
    trained by its own harness from the port's init seeds (``golden_seeds``),
    meets the band with the statistic the port is held to: the seeds and the
    mean do not favour the port."""
    import test_golden_map as reference
    from torch_detection_tpu import builder as jax_builder
    from torch_detection_tpu.models import detectors as jax_detectors
    from torch_detection_tpu.models import heads as jax_heads
    from torch_detection_tpu.ops import anchors as jax_anchors

    steps, _, band = GOLDEN_ROI["sparse_rcnn"]
    model = jax_builder.build_detector(GOLDEN_MODELS["sparse_rcnn"])
    cfg = golden_detection_cfg("sparse_rcnn", jax_detectors, jax_heads, jax_anchors)
    results = []
    for seed in golden_seeds("sparse_rcnn"):
        res = reference._train_and_eval(golden, model, cfg, steps=steps, lr=1e-3, seed=seed)
        print("reference sparse_rcnn seed", seed, {k: float(res[k]) for k in band})
        results.append(res)
    mean = mean_scores(results, band)
    print("reference sparse_rcnn mean", mean)
    for key, floor in band.items():
        assert mean[key] >= floor, (key, mean)


def _follow_the_reference_golden_training(golden, name, jax_loss, reference_matching,
                                          port_losses, rounding_only):
    """The golden case ``name`` trained by the JAX package's own harness
    (its loader, loss, ``optax.adam`` at 1e-3, the case's steps from seed
    0); at eight points of that training the port, given the same weights
    and batch and the reference's matching (``reference_matching(cfg, cls,
    box, batch)``, the col4row the port's ``port_losses(cfg, model, batch,
    col4row)`` takes), computes the same losses (rtol 1e-5) and the same
    gradient of every parameter (within 2e-2 in relative norm: float32 sums
    in another order, through a trunk fed 0-255 pixels). A parameter whose
    gradient is 0 in exact arithmetic (``rounding_only(name)``) has, on
    both sides, a gradient under 1e-6 of the largest one's norm."""
    import jax
    import jax.numpy as jnp
    import optax
    import test_golden_map as reference
    from torch_detection_tpu import builder as jax_builder
    from torch_detection_tpu.data import build_dataloader as jax_dataloader
    from torch_detection_tpu.data import get_datasets as jax_datasets
    from torch_detection_tpu.models import detectors as jax_detectors
    from torch_detection_tpu.models import heads as jax_heads
    from torch_detection_tpu.ops import anchors as jax_anchors
    from torch_detection_tpu.ops import assign as jax_assign
    from torch_detection_tpu.parallel import create_train_state
    from torch_detection_tpu.parallel import make_train_step as jax_train_step
    from torch_detection_tpu_torch.models import from_jax_variables

    torch.set_num_threads(4)
    steps = GOLDEN_CASES[name][0]
    model_dict = GOLDEN_MODELS[name]
    jax_model = jax_builder.build_detector(model_dict)
    jax_cfg = golden_detection_cfg(name, jax_detectors, jax_heads, jax_anchors, jax_assign)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((4, *CANVAS, 3)))
    stats = variables.get("batch_stats", {})
    tx = optax.adam(1e-3)
    state = create_train_state(variables["params"], tx, batch_stats=stats)
    train_step = jax_train_step(jax_builder.build_loss_fn(jax_model, jax_cfg, rng_seed=0), tx,
                                donate_state=False)

    @jax.jit
    def losses_and_grads(params, batch):
        def loss(p):
            cls, box = jax_model.apply({"params": p, "batch_stats": stats}, batch["image"],
                                       img_shapes=batch["img_shape"], train=True)
            out = jax_loss(jax_cfg, cls, box, batch["gt_boxes"], batch["gt_labels"],
                           batch["gt_valid"], batch["img_shape"])
            return out["loss"], (out, cls, box)
        return jax.value_and_grad(loss, has_aux=True)(params)

    port = build_detector(model_dict, "float32", device="cpu").train()
    port_cfg = golden_detection_cfg(name)
    loader = jax_dataloader(jax_datasets(reference._data_cfg(golden, train=True)),
                            sample_per_replica=4, seed=3, max_gts=4, canvas=CANVAS, prefetch=0)
    points, done, epoch = (0, 1, 10, 50, 100, 200, steps - 100, steps - 1), 0, 0
    while done < steps:
        loader.set_epoch(epoch)
        epoch += 1
        for b in loader:
            b.pop("img_meta", None)
            batch = {k: jnp.asarray(v) for k, v in b.items()}
            if done in points:
                (_, (want, cls, box)), grads = losses_and_grads(state.params, batch)
                col4row = reference_matching(jax_cfg, np.asarray(cls), np.asarray(box),
                                             {k: np.asarray(v) for k, v in b.items()})
                port.load_state_dict(from_jax_variables(
                    jax.device_get({"params": state.params, "batch_stats": stats}), port))
                port.zero_grad()
                got = port_losses(port_cfg, port,
                                  {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()},
                                  torch.from_numpy(col4row))
                for key in ("loss", "loss_cls", "loss_l1", "loss_giou"):
                    np.testing.assert_allclose(float(got[key].detach()), float(want[key]),
                                               rtol=1e-5, err_msg=f"step {done} {key}")
                got["loss"].backward()
                want_grads = from_jax_variables({"params": jax.device_get(grads)}, port)
                top = max(float(np.linalg.norm(w.numpy())) for w in want_grads.values())
                for pname, p in port.named_parameters():
                    w = want_grads[pname].numpy()
                    if p.grad is None:  # a frozen parameter: the reference's gradient is 0
                        assert not w.any(), (done, pname)
                        continue
                    if rounding_only(pname):
                        noise = max(np.linalg.norm(p.grad.numpy()), np.linalg.norm(w))
                        assert noise <= 1e-6 * top, (done, pname, noise, top)
                        continue
                    gap = np.linalg.norm(p.grad.numpy() - w) / max(np.linalg.norm(w), 1e-12)
                    assert gap <= 2e-2, (done, pname, gap)
            state, _ = train_step(state, batch)
            done += 1
            if done >= steps:
                break


@pytest.mark.slow
def test_sparse_rcnn_losses_follow_the_reference_along_its_golden_training(golden):
    """``_follow_the_reference_golden_training`` of the golden Sparse R-CNN
    (400 steps): so the golden score's spread over init seeds is the
    training's, not a fault of the port's targets or losses."""
    from test_torch_sparse_rcnn import _reference_matching
    from torch_detection_tpu.models.detectors import sparse_rcnn_loss as jax_loss
    from torch_detection_tpu_torch.models.detectors.sparse_rcnn import set_losses, set_targets

    def port_losses(cfg, port, tb, col4row):
        shapes = tb["img_shape"].float()
        p_cls, p_box = port(tb["image"], shapes)
        gt_xyxy, whwh = set_targets(tb["gt_boxes"], tb["gt_valid"], shapes)
        return set_losses(cfg, p_cls, p_box, gt_xyxy, tb["gt_labels"], tb["gt_valid"], whwh,
                          col4row)

    # softmax ignores the key projection's bias
    _follow_the_reference_golden_training(golden, "sparse_rcnn", jax_loss, _reference_matching,
                                          port_losses, lambda n: n.endswith("key.bias"))


@pytest.mark.slow
def test_detr_losses_follow_the_reference_along_its_golden_training(golden):
    """``_follow_the_reference_golden_training`` of the golden DETR (300
    steps, every decoder layer's losses): so the port's scores, lower than
    the reference's at every init seed 0-7 on the CPU but above the band at
    each, are not a fault of its targets or losses."""
    from test_torch_detr_train import _reference_matching
    from torch_detection_tpu.models.detectors import detr_loss as jax_loss
    from torch_detection_tpu_torch.models.detectors.detr import (
        gt_to_cxcywh,
        loss_layers,
        set_losses,
    )

    def port_losses(cfg, port, tb, col4row):
        shapes = tb["img_shape"].float()
        cls, box = loss_layers(cfg, *port(tb["image"], shapes))
        gt = gt_to_cxcywh(tb["gt_boxes"], tb["gt_valid"], shapes)
        return set_losses(cfg, cls, box, gt, tb["gt_labels"], tb["gt_valid"], col4row)

    def rounding_only(n):
        # softmax ignores the key projection's bias; the first decoder layer's self-attention
        # reads values that are all its value bias (the queries' content starts at 0), so its
        # output does not depend on its query and key projections
        return n.endswith("key.bias") or n.startswith(("decoder0.self_attn.query.",
                                                        "decoder0.self_attn.key."))

    _follow_the_reference_golden_training(golden, "detr", jax_loss, _reference_matching,
                                          port_losses, rounding_only)


@pytest.fixture
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the init's many small draws, beside other test workers
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(GOLDEN_MODELS))
def test_golden_model_has_the_reference_parameter_count(name, one_torch_thread):
    """Each golden model of the port, built in float32 on the CPU, has the
    JAX model's parameter count: ``jax.eval_shape`` over the reference's
    ``init_detector_variables`` (the image ``init`` and, for the RoI
    families, the RoI and mask heads' own inits), nothing compiled."""
    import jax
    import jax.numpy as jnp

    from torch_detection_tpu import builder as jax_builder
    from torch_detection_tpu.models import detectors as jax_detectors
    from torch_detection_tpu.models import heads as jax_heads
    from torch_detection_tpu.ops import anchors as jax_anchors
    from torch_detection_tpu.ops import assign as jax_assign

    model_dict = GOLDEN_MODELS[name]
    jax_model = jax_builder.build_detector(model_dict)
    jax_cfg = golden_detection_cfg(name, jax_detectors, jax_heads, jax_anchors, jax_assign)
    shapes = jax.eval_shape(
        lambda x: jax_builder.init_detector_variables(jax_model, jax_cfg, model_dict, x),
        jax.ShapeDtypeStruct((1, *CANVAS, 3), jnp.float32))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    model = build_detector(model_dict, "float32", device="cpu", seed=0)
    assert sum(p.numel() for p in model.parameters()) == want
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("name", ["fcos", "atss", "gfl", "paa"])
def test_golden_dense_head_takes_one_scale_a_neck_level(name, one_torch_thread):
    """The reference's golden FCOS, ATSS, GFL and PAA dicts name no
    ``num_levels``: flax sizes the heads' ``scales`` from the levels it is
    fed (3 from the FPN here), and the port's ``SingleStageDetector`` gives
    such a head its neck's ``num_outs``, so the dict builds a model that
    runs a 3-level forward."""
    model = build_detector(GOLDEN_MODELS[name], "float32", device="cpu", seed=0)
    assert model.head.scales.shape == (GOLDEN_MODELS[name]["neck"]["num_outs"],)
    with torch.no_grad():
        outs = model(torch.zeros(1, *CANVAS, 3))
    assert all(len(level_outs) == 3 for level_outs in outs)
