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
   bfloat16, timed likewise, and two launches bitwise equal; then at the
   small shapes; then K1 and K2 on edge rois at out 7 and 14 (one roi 512
   times, 512 rois in one 8 x 8-cell area, a NaN roi, a roi larger than
   P5);
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
   gradients into the FPN levels;
9. mask serving: Mask R-CNN R50-FPN (configs/mask_rcnn_r50_fpn_coco.py,
   seeded weights, bf16) answers batches of 4 seeded 800 x 1216 images
   through ``make_inference_fn(..., segm=True)``: K1's launches are counted
   (two a batch: out 7 for the boxes, out 14 for the masks), the mask
   probabilities lie in [0, 1] and are 0 on invalid slots, K1 is held to its
   plain version on the run's own levels and detections at out 14 and timed
   there; one batch profiled;
10. the mask branch on the GPU against the CPU, float32, stage by stage on a
   small canvas: mask roi features, mask logits, mask probabilities, and the
   mask targets (equal, except where the CPU's value before the threshold
   lies within one bf16 ulp of 0.5);
11. mask training: the Mask R-CNN training build takes seeded batches like
   phase 7's, each gt box with a seeded filled ellipse as its mask (gt
   masks uint8, their count bucketed as the collate does), through
   ``Trainer.run``: 2 warm-up and 10 timed steps, K1 and K2 counted (two
   each a step: the box slate and the mask slate), every ``loss_mask``
   finite and above 0, no step skipped, the mask head's parameters moved;
   ms a step, images/s, peak memory, one profiled step and a stage
   breakdown with the mask stages;
12. K1 and K2 held to their plain versions on a training step's own mask
   slate, levels and mask-head cotangent (scaled by a power of two to a
   largest value in [1, 2)) at out 14, and K2 on a slate of 128 positives
   an image piled onto the batch's gts (K2 twice bitwise equal on both),
   each timed against its bound there; the step's mask targets on the GPU
   against the CPU at full size;
13. RetinaNet serving: RetinaNet R50-FPN (configs/retinanet_r50_fpn_coco.py,
   seeded weights, bf16, ``cls_out``'s bias at 0 so that scores clear
   ``score_thr``) answers batches of 4 seeded uint8 800 x 1216 images, relaid
   2x2 space-to-depth on the host and put on the card once, through
   ``fused_normalize_pad_s2d`` and ``make_inference_fn``, as bench.py's timed
   batch: K1 and K2 counted (none expected), detections checked, a stage
   breakdown and one profiled batch; then batches of 48, bench.py's batch;
14. the stem finding: the folded 4x4 stem on the s2d wire against the 7x7
   stride-2 conv on the plain layout, cuDNN, bf16, b4;
15. the RetinaNet serving path on the GPU against the CPU, float32, stage by
   stage on a small canvas: preprocess (exactly), stem, FPN levels, head,
   preselection (exactly), decoded candidates, NMS on equal inputs
   (exactly), detections;
16. RetinaNet training: the training build (float32 parameters, bf16
   compute) takes seeded batches of 8 images on the 800 x 1216 canvas
   (``train_batch``'s images and gts, relaid space-to-depth) through
   ``Trainer.run``: 2 warm-up and 10 timed steps, K1 and K2 counted (none
   expected), finite losses, positives in every step, no step skipped; ms a
   step, images/s, peak memory, one profiled step, a stage breakdown and
   the assignment's peak memory;
17. the RetinaNet training path on the GPU against the CPU, float32, on a
   small canvas: the losses and every parameter's gradient;
18. Cascade R-CNN, Cascade Mask R-CNN and Fast R-CNN R50-FPN served and
   trained through the same entry points, K1 and K2 counted on each, K2 held
   to its plain version on a cascade step's stage-3 slates, and each
   family's stages against the CPU;
19. the Hungarian matcher kernel against its plain version, bit for bit,
   right after the RoIAlign edge phase: a training step's shape (48
   problems of 100 x 100, 1-20 valid rows), the full slate, integer costs
   full of ties, NaN and +-inf entries; totals against scipy's;
20. Sparse R-CNN R50-FPN (configs/sparse_rcnn_r50_fpn_coco.py) served like
   the cascade (K1 six times a batch, K2 and the matcher never), a stage
   breakdown for each of its six stages;
21. the Sparse R-CNN path on the GPU against the CPU, float32: each stage on
   equal inputs, the top-k decode, the losses under one matching and the
   gradients into the levels and both proposal parameters;
22. Sparse R-CNN training, b8 with the config's AdamW through ``Trainer``:
   K1 and K2 six times a step and the matcher once, every parameter group
   moved; then K2 on the step's stage-0 and stage-5 slates and the matcher
   on the step's own costs, each against its plain version and its bound.
23. DETR R50 (configs/detr_r50_coco.py) served b4 bf16 on its 800 x 1344
   canvas (1050 encoder tokens an image, two images in every four smaller
   than the canvas, so the key mask drops tokens): K1, K2 and the matcher
   never launched, a stage breakdown (C5, projection and encoding, each
   encoder and decoder layer, heads, decode) and one profiled batch;
24. the DETR path on the GPU against the CPU, float32: C5, the projection,
   the encoding and the key mask, each encoder and decoder layer and the
   heads on equal inputs, the top-k decode, the losses under one matching
   and the gradients into C5 and ``query_embed``;
25. DETR training, b8 with the config's AdamW and clip through ``Trainer``:
   the matcher once a step (all six decoder layers and eight images in one
   launch), K1 and K2 never, every parameter group moved; then the matcher
   on the step's own (48, 100, 100) costs against its plain version and its
   bound;
26. the system's own entry points on Faster R-CNN R50-FPN at full width: a
   seeded COCO folder under build/smoke_coco (64 train and 16 val PNGs at
   COCO's landscape and square sizes, 1-20 boxes an image over COCO's
   category ids, a crowd box in every fourth image), a config whose
   ``_base_`` is configs/faster_rcnn_r50_fpn_coco.py (b8 on its 800 x 1344
   canvas, ``score_thr`` 0 so that random weights leave detections);
   ``tools.train`` on a portrait image raises the R8 ``ValueError``;
   ``tools.train`` for two epochs (K1 and K2 once a step: twice the
   loader's length each), ``epoch_N/`` and ``metrics.jsonl`` checked; a
   resume from ``epoch_1`` (the state loads bit for bit, the step and the
   learning rate continue, the epoch-2 losses within 1e-3 relative);
   ``tools.test`` on the val set (K1 once a batch, its model equal to
   ``epoch_2``'s bit for bit, 12 finite metrics, a non-empty COCO results
   JSON inside each image, its detections matched to ``evaluate_detector``
   through the plain RoIAlign on the same model); the val gts as detections
   through the dump and ``eval_coco_map`` (mAP 1.0); K1 and K2 against
   their plain versions on a training batch, K1 on a ``tools.test`` batch's
   own levels and proposals; the host's ms to decode and prepare an image
   and to collate a batch, the trainer's wait on the loader, images/s over
   all of epoch 2 from the trainer's log, one profiled step fed by the
   loader, and peak memory;
27. the same entry points on Mask R-CNN R50-FPN at full width: a seeded
   COCO folder under build/smoke_coco_masks (64 train and 16 val PNGs,
   1-20 objects an image, each a filled polygon of 6-40 vertices, some
   concave, some of two parts; a few non-crowd masks as compressed RLE
   strings, a crowd with an uncompressed RLE in every fourth image), a seeded
   torchvision-named ResNet-50 ``.pth`` (with ``fc.*`` and
   ``num_batches_tracked``, in a ``{"state_dict": ...}`` envelope), a config
   whose ``_base_`` is configs/mask_rcnn_r50_fpn_coco.py; ``tools.train``
   for two epochs with ``--pretrained torch://`` (the log reports every
   backbone tensor loaded; the frozen stem and stage 1 of ``epoch_2`` equal
   the file's bit for bit; the losses, ``loss_mask`` among them, finite; K1
   and K2 twice a step each, once at out 7 and once at out 14);
   ``tools.test --segm`` (K1 twice a batch, 24 finite metrics, every RLE of
   ``results.segm.json`` at its image's original size); the masks of a
   ``tools.test`` batch pasted through K1 and through the plain RoIAlign on
   the same detections (at least 0.99 of their pixels agree, and 0.999 of
   the pixels either marks); the val gt
   masks through ``coco_segm_dump`` and ``eval_coco_segm_map`` (segm mAP
   1.0); K1 and K2 at out 14 on a training batch's mask slate and K1 at out
   14 on a ``tools.test`` batch's detections against their plain versions;
   the host's ms for a masked sample and collate, the masked batch's copy to
   the card, the trainer's wait on the loader, images/s, one profiled step
   fed by the loader, and peak memory;
28. the port's JPEG decoder, right after the build of phase 2:
   ``native/jpeg.cpp`` built by g++ (its seconds printed), every committed
   fixture under tests/torch_jpeg decoded to the shape and sha256 of
   ``cv2.imread``'s array in its manifest and each refused file refused by
   its kind, and ``img_read`` of a 640 x 480 4:2:0 fixture timed beside the
   port's PNG decode of the same pixels (median of 20, host clock);
29. RetinaNet R101-FPN on Pascal VOC through the entry points at full
   width (configs/retinanet_r101_fpn_voc.py, b8 on its 608 x 1024 canvas): a
   seeded VOC2007 folder under build/smoke_voc (32 trainval and 8 test
   images copied from the committed landscape fixtures, 1-20 objects an
   image over the 20 classes, every fifth difficult); ``tools.train`` on a
   375 x 500 portrait image raises R10's ``ValueError``; ``tools.train`` for
   two epochs with ``runtime.val_voc_metric`` (VOC validation after each
   epoch, K1 and K2 never launched); ``tools.test --voc-metric --out`` (a
   finite VOC07 mAP, equal to ``eval_voc_map`` on the dumped pkl to 1e-12);
   the test gts as detections score 1.0 under both VOC metrics; host ms to
   decode a JPEG and to prepare a sample, images/s over epoch 2, the wait on
   the loader, one profiled loader-fed step and peak memory;
30. the Fast R-CNN proposal workflow through the entry points at full
   width on a seeded COCO folder under build/smoke_coco_jpeg (32 train and
   8 val images copied from the committed fixtures at COCO's sizes, phase
   26's seeded boxes and crowds): ``tools.dump_proposals`` of phase 26's
   ``epoch_2`` over both splits (1000 an image, K1 and K2 never; each slate
   inside its frame, scores in order; the first 8 val images against a
   ``--device cpu`` dump, 0.95 matched each way at IoU 0.99);
   ``tools.train`` of configs/fast_rcnn_r50_fpn_coco.py (b8 on 800 x 1344)
   on the dumped pkls for two epochs (K1 and K2 once a step); ``tools.test``
   on the val pkl (K1 once a batch, K2 never, 12 finite metrics); K1 and K2
   against their plain versions on a step's own levels and sampled slate,
   K1 on a ``tools.test`` batch's levels and dumped proposals; the dump's ms
   an image, images/s over epoch 2, one profiled step and peak memory.

31. FCOS, ATSS and GFL R50-FPN (configs/fcos_r50_fpn_coco.py,
   atss_r50_fpn_coco.py and gfl_r50_fpn_coco.py, unchanged: the folded s2d
   stem, FrozenBN, FPN 256 x 5 with extra convs on the inputs, four GN towers
   of 256, 80 classes; ``cls_out``'s bias at 0 so that random weights score
   above ``score_thr``) each served b4 bf16 from the uint8 s2d wire through
   ``fused_normalize_pad_s2d`` and ``make_inference_fn`` (K1, K2 and the
   matcher never launched, a stage breakdown and one profiled batch); then
   the three against the CPU in float32 stage by stage on a small canvas
   (FPN levels, GroupNorm alone and the head to 1e-4, the targets exactly
   and the centerness within one ulp, the candidates, the NMS on equal
   inputs exactly, the losses to 1e-4 and every gradient to 1e-2 in
   relative norm); then each trained b8 (its config's ``sample_per_replica``)
   on the two-stage cells' canvas and gts, float32 parameters with bf16
   compute, SGD with clip 35, through ``build_train_objects`` and
   ``Trainer.run``: 2 warm-up and 10 timed steps, none launching K1, K2 or
   the matcher, finite losses and positives in every step, the losses and
   ``num_pos`` of the 10 steps, ms a step, images/s, peak memory, one
   profiled step and a stage breakdown;
32. FoveaBox, FreeAnchor and PAA R50-FPN (configs/foveabox_r50_fpn_coco.py,
   free_anchor_r50_fpn_coco.py and paa_r50_fpn_coco.py, unchanged; FoveaBox
   the GN towers without ``scales`` or centerness, FreeAnchor RetinaNet's
   graph, PAA ATSS's) through the same three phases as phase 31, after
   GFL's: served b4 (PAA's breakdown splits the NMS from the score voting),
   checked against the CPU in float32 (FoveaBox's labels exactly and its
   log-space targets within one ulp; FreeAnchor's bags on the GPU's IoUs
   exactly; PAA's MaxIoU assignment exactly, then on the GPU's candidate
   losses the slates exactly, the EM's means, variances and weights to
   1e-5 and the positives exactly except where a responsibility lies
   within 1e-6 of 0.5, and the score voting on equal inputs to 1e-3 px),
   and trained b8 (FreeAnchor's breakdown times the IoU and bag top-k, the
   negative and the positive term; PAA's the MaxIoU assignment, the
   candidate scores, the slates, the EM and the split); K1, K2 and the
   matcher never launched on the six paths;
33. multi-scale and flip evaluation: ``tools.test --tta --segm`` on phase
   27's ``epoch_2`` with a config whose val data has two
   ``img_expected_sizes`` (1333 x 800 and 1000 x 600) and flips, four
   augmentations an image, each bucketed at its size rounded up to 128 (K1
   twice a batch, out 7 and out 14, K2 never), 24 finite metrics, every RLE
   decoding to its image's original size; K1 held to its plain version at
   out 14 on a batch of one flipped augmentation's levels and detections,
   and that batch's masks pasted in the original frame through K1 and the
   plain RoIAlign agreeing;
34. SSD300, SSD512 and YOLOv3 Darknet-53 (configs/ssd300_vgg16_coco.py,
   ssd512_vgg16_coco.py and yolov3_d53_coco.py, unchanged; YOLOv3's
   objectness biases at 0 so that random weights score above ``score_thr``)
   each served bf16 at its config's batch and canvas (b32 on 300 x 300, b16
   on 512 x 512, b8 on 608 x 608) from a seeded uint8 batch of mixed aspect
   ratios through ``fused_normalize_pad`` (the config's means and stds) and
   ``make_inference_fn``: K1, K2 and the matcher never launched, a stage
   breakdown and one profiled batch;
35. SSD300 and a narrow YOLOv3 against the CPU in float32 on two images, one
   padded: trunk, neck and head to 1e-4 of each map's largest value; on equal
   inputs the assignments exactly, SSD's mined set exactly (from each
   device's own cross-entropy, and on inputs whose padding anchors tie
   exactly across the 3:1 cut, R11), YOLOv3's preselection exactly, the
   candidates to 1e-6 (scores) and 1e-3 px, the NMS exactly, the losses to
   1e-5; every
   gradient to 1e-2 in relative norm; then the three trained at their
   config's batch and canvas with its SGD (momentum 0.9, weight decay 5e-4,
   clip 35), float32 parameters and bf16 compute, through
   ``build_train_objects`` and ``Trainer.run``: 2 warm-up and 10 timed
   steps, finite losses and positives in every step, a profiled step and a
   breakdown that times the assignment and SSD's mining on their own;
36. SSD300 through the entry points: a seeded COCO folder under
   build/smoke_coco_ssd of the committed JPEG fixtures (landscape, square
   and portrait: the square canvas holds a portrait), a seeded
   torchvision-layout VGG16 ``.pth`` given as ``--pretrained file://``
   (copied into a cache under the folder; the log reports its 26 trunk
   tensors set), ``tools.train`` for one epoch of b32, ``tools.test`` on
   ``epoch_1`` (12 finite metrics, every result inside its frame) and the
   val gts' oracle (mAP 1.0);
37. YOLOX-S and CenterNet R18 (configs/yolox_s_coco.py and
   centernet_r18_coco.py, unchanged; YOLOX's ``cls_out`` and ``obj_out``
   biases at 0 for serving, so that random weights score above
   ``score_thr``) through phases 34 and 35 after YOLOv3: served b16 bf16
   (640 x 640 and 512 x 512; CenterNet's breakdown times its peaks and the
   stable sort of every image's 1 310 720 scores), a narrow YOLOX and a
   CenterNet R18 with narrow deconvolutions against the CPU in float32
   (maps to 1e-4; SimOTA's positive set and matched gts equal but where two
   costs lie within a few ulps, counted; the heat targets bit for bit; the
   top-k scores within 2 ulps, and on logits with plateaus the peaks, the
   top-k and the decode exactly; losses to 1e-5; gradients to 1e-2), and
   trained b8 with the configs' SGD (the breakdown times SimOTA and the
   heat targets on their own); K1, K2 and the matcher never launched;
38. YOLOX-S through the entry points: a seeded COCO folder of the committed
   JPEG fixtures under build/smoke_coco_yolox (landscape, square and
   portrait, every val image held keep-ratio by the 640 x 640 canvas),
   ``tools.train`` for 2 epochs of b8 and ``tools.test --out`` (12 finite
   metrics, a detection in every image inside its frame at ``score_thr``
   0), the val gts' oracle (mAP 1.0);
39. SOLOv2 R50-FPN (configs/solov2_r50_fpn_coco.py, unchanged; ``cls_out``'s
   bias at 0 for serving, so that random weights score above
   ``score_thr``): first the head's resize of a bf16 map (float32, rounded
   once) beside CUDA's bf16 antialiased kernel; served b4 bf16 on the
   config's 800 x 1344 canvas through ``make_inference_fn(..., segm=True)``
   and its box route (K1, K2 and the matcher never launched, a stage
   breakdown: trunk and FPN, head towers, mask features, candidates with
   the dynamic conv and rescoring, Matrix NMS, the top 100 with boxes and
   crops; one profiled batch); the full-width model against the CPU in
   float32 on a 256 x 384 canvas (maps to 1e-4, the pooled masks, targets
   and slate bit for bit, then on equal inputs the scores and the top 256
   within ulps, the logits to 1e-5, the masks, IoUs and decode exactly but
   where a near-tie is counted, the Matrix-NMS scores within 8 ulps, the
   losses to 1e-5, every gradient to 1e-2 in relative norm); trained b8
   with the config's SGD on seeded ellipse masks (a breakdown that times
   the targets and the loss on their own);
40. Soft-NMS: RetinaNet R50-FPN served b4 with ``nms_method="soft"``, the
   NMS stage timed beside the greedy NMS on the same candidates, and the
   picks held to the CPU's (equal until a tie within 8 ulps in the CPU's
   pool);
41. SOLOv2 through the entry points on the CLI mask path's PNG folders:
   ``tools.train`` for 2 epochs of b8 on 800 x 1344 with validation (box
   and segm mAP) after each, ``tools.test --segm --out`` on the trained
   model and on the seeded build with ``cls_out``'s bias at 0 saved as a
   checkpoint (24 finite metrics, every RLE at its image's original size;
   the seeded model's detections must reach the segm dump), the val gts
   as detections (box and segm mAP 1.0);
42. the golden SOLOv2: the narrow model of tests/test_golden_map.py trained
   400 steps of b4 on the card (AdamW, weight decay 0) on the seeded
   squares set of ``data_fixtures.make_golden_coco`` (written here by
   ``png_encode``), scored by ``evaluate_detector(segm=True)`` against the
   reference's band (``segm_mAP_50`` and ``mAP_50`` at least 0.3); its
   checkpoint and two ``tools.test`` configs (bf16, float32) are kept for
   phase 48; it runs in this process while phase 50's six spawned
   processes train;
43. RetinaNet MobileNetV2-FPN, ShuffleNetV2-FPN and PAFPN-R50
   (configs/retinanet_{mobilenetv2_fpn,shufflenetv2_fpn,pafpn_r50}_coco.py,
   unchanged; ``cls_out``'s bias at 0 for serving) after Soft-NMS: served
   b4 bf16 on 800 x 1216 (the two light ones from the plain uint8 canvas
   through ``fused_normalize_pad``, PAFPN-R50 from the s2d wire; a stage
   breakdown: preprocess, backbone, neck, head, candidates, NMS; one
   profiled batch); the seven zoo backbones at their published widths and
   each config's backbone, neck and head against the CPU in float32 (1e-4
   of each output's largest value), and its losses (1e-4) and every
   gradient (1e-2 in relative norm, float64 on the GPU the yardstick);
   trained b8 on 800 x 1344 with the configs' SGD; K1, K2 and the matcher
   never launched;
44. RetinaNet MobileNetV2-FPN through the entry points: a seeded JPEG COCO
   folder under build/smoke_coco_zoo, a seeded torchvision-layout
   MobileNetV2 ``.pth`` as ``--pretrained file://`` (the log's count of
   tensors set equal to the table's, all under ``backbone.``; the trained
   checkpoint keeps the file's FrozenBN statistics bit for bit),
   ``tools.train`` for 2 epochs of b8, ``tools.test --out`` and the val
   gts' oracle;
45. the profiler through the entry points, right after phase 27:
   ``tools.train --profile-dir`` on the Faster R-CNN smoke config for one
   epoch of two b8 steps from 16 PNGs written for it; the Chrome trace
   must hold one K1 and one K2 kernel event a step (by symbol name) and a
   ``train_step`` span of ``annotate`` a step, with K1 and K2 counted
   once a step; the trace's size and event count;
46. serving export, after phase 44: Faster R-CNN, Mask R-CNN and RetinaNet
   R50-FPN (RetinaNet from a checkpoint of its seeded build with
   ``cls_out``'s bias at 0) through ``tools.export --check`` at b4 on
   800 x 1216 in bf16 (RetinaNet on the s2d wire): export, save and load
   seconds, the artifact's MB, then the loaded artifact and the live module
   on the same 2 + 10 seeded uint8 batches, images/s of each, K1 counted by
   output size in each run (out 7 once a batch for Faster R-CNN, out 7 and
   out 14 for Mask R-CNN, never for RetinaNet), the artifact's outputs
   equal to the live module's bit for bit; meanwhile four spawned processes
   export, save, load and run every other family that ``make_serving_fn``
   handles on the narrow models of tests/test_torch_export.py (float32,
   each artifact equal to its live module, K1 once a stage in the cascade
   and Sparse R-CNN artifacts);
47. data-parallel training, after the golden SOLOv2: Faster R-CNN R50-FPN at
   full width through ``build_train_objects``, ``build_loss_fn`` and
   ``make_train_step`` in two spawned ranks under gloo sharing this card
   (NCCL refuses two ranks on one device): one float32 step of 2 images a
   rank on 800 x 1216 against this process's step on the same 4 images (the
   loss to 1e-4, each parameter's update to 1e-2 in relative norm, the
   replicas' parameters bit for bit, K1 and K2 once a step in each rank),
   then 2 + 10 bf16 steps of 4 images a rank, images/s beside this
   process's b8 (two ranks sharing one card, not scaling); with two cards
   or more the same under NCCL on two cards and FSDP's step, with the peak
   memory of each rank, else a line that they were not run;
48. ``tools.train`` as two torchrun ranks (gloo, this card) for one epoch on
   phase 26's folder and config with ``--dump-final`` (rank 0 alone writes
   its work directory, the ranks' parameters equal bit for bit, K1 and K2
   once a step in each rank), then ``tools.test --shard-eval`` on two ranks
   against ``tools.test`` in this process on the same checkpoint in float32
   (the 12 metrics to 1e-12, the COCO results dump the same), and on the
   golden SOLOv2's checkpoint with ``--segm``, whose metrics are not 0, in
   bf16 and in float32 (the 24 metrics to 1e-12 in both; the box and mask
   dumps the same in float32, their gap reported in bf16, where cuDNN's C5
   for an image moves with its place in the batch: the backbone's levels
   for a reversed b8 batch are compared in both dtypes). Each rank is
   ``python3 chip_smoke.py --cli-rank {train,test} LAUNCHES_JSON ARGS``,
   which runs the tool and writes its launch counts;
49. the training options through the entry points, right after phase 27:
   on 32 of phase 26's PNGs (4 steps of b8 on 800 x 1344) ``tools.train``
   for 2 epochs with ``accum_steps=2``, ``ema_decay=0.999``, the cosine
   schedule (``min_lr_ratio`` 0.01 over the 2 epochs) and class-specific
   box regression, validating the EMA each epoch; K1 and K2 twice a step
   (once a micro-batch), K1 once a validation batch; the EMA of four named
   tensors against a float64 recomputation from the parameters after each
   step (1e-6 of its largest value), every logged learning rate against the
   cosine's formula (1e-12 relative); one float32 step at
   ``accum_steps=2`` against two b4 forward-backwards by hand with the
   step's draws (the loss to 1e-6, every gradient to 1e-5 in relative
   norm); the class-specific RoI losses and their gradient into
   ``bbox_head.reg`` against the CPU (1e-3); the resume from ``epoch_1``
   (the optimizer's state and the EMA bit for bit); ``tools.test`` on
   ``epoch_2`` (K1 once a batch) with its 12 metrics from the C++ matcher
   against the plain Python one on the same detections (1e-12, each
   matcher's host ms); ``MaxIoUAssigner`` on RetinaNet's 182 403 anchors
   with ``gt_max_assign_all=False`` and ignore regions, the card's
   assignment equal to the CPU's; ``tools.visualize`` on 4 committed JPEGs
   and ``--segm`` on 4 more with phase 27's Mask R-CNN, each PNG at its
   image's size (K1 once an image, twice with masks; K2 never);
50. the golden RoI families: the reference's narrow Faster, Fast (on the
   reference's jittered-gt proposals, a pkl), Cascade, Cascade Mask, Mask
   and Sparse R-CNN (ResNet-18) of tests/test_golden_map.py, each trained
   300-400 steps of b4 on the squares set in float32 in one of six spawned
   processes on the card (shared with phase 52's runs), then scored by
   ``evaluate_detector`` against the reference's band (mAP_50 and mAP at
   least 0.5 and 0.3, segm_mAP_50 0.3 with masks; Sparse R-CNN 0.25 and
   0.12); K1/K2/matcher 1/1/0, 1/1/0,
   3/3/0, 6/6/0, 2/2/0 and 2/2/1 a step, all at out 7, K1 as each family's
   served batch (1, 1, 3, 4, 2, 2) and K2 never in the evaluation; a score
   under its band fails the run once phases 47 and 48 have run;
51. config formats, right after phase 49, on its options config and
   ``work_options/epoch_2``: the options config written by the port's
   ``Config.dump`` to json and yaml reads back to the ``.py`` file's tree;
   ``tools.train`` for one epoch (float32, ``accum_steps`` 1) from a
   ``.py``, a json child of the ``.py`` and, where PyYAML is present, a
   yaml child of the json dump: K1 and K2 once a step, every loss finite,
   each first loss within 1e-6 relative of the ``.py`` run's, the later
   ones beside a second run of the ``.py`` config's; then
   ``tools.test`` on ``epoch_2`` from each: the same detections and
   metrics (bit for bit, or every detection partnered and the metrics
   within 1e-6). Without PyYAML a yaml config must raise the named
   ``ImportError``;
52. the golden dense and set families, in phase 50's pool of six spawned
   processes (``phase_golden``, the longest runs first): the reference's
   narrow RetinaNet, FCOS, ATSS, YOLOv3, CenterNet, SSD, YOLOX, GFL,
   FoveaBox, DETR, FreeAnchor and PAA of tests/test_golden_map.py
   (``tests/torch_golden_cases.py``'s ``GOLDEN_DENSE``), each trained
   200-400 steps of b4 on the squares set in float32 from each of its init
   seeds, then scored by ``evaluate_detector``; each seed's scores and the
   mean over the family's seeds printed beside the reference's band
   (mAP_50 and mAP at least 0.5 and 0.15; YOLOX 0.5 and 0.3, GFL 0.8 and
   0.5, DETR 0.4 and 0.2); K1 and K2 never launched, the matcher once a
   DETR training step and never elsewhere; a launch count off raises at
   once, a mean under its band fails the run with phase 50's, once phases
   47 and 48 have run.

The line before the last is the ``kernels`` JSON (launches by path; times
and bounds at each path's shapes); the
last line is the device JSON. Without a GPU it exits with 2 and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import logging
import math
import multiprocessing
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import unittest.mock
import warnings
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from torch_detection_tpu_torch import kernels, native
from torch_detection_tpu_torch.builder import (
    build_detection_cfg,
    build_detector,
    build_loss_fn,
    build_train_loader,
    build_train_objects,
)
from torch_detection_tpu_torch.data import (
    VOC_CLASSES,
    build_dataloader,
    collate,
    get_datasets,
    prefetch_to_device,
)
from torch_detection_tpu_torch.data.collate import pick_canvas
from torch_detection_tpu_torch.data.ops.image import img_read, png_encode
from torch_detection_tpu_torch.data.ops.jpeg import jpeg_read
from torch_detection_tpu_torch.data.ops.mask import poly_to_mask, rle_decode, rle_encode, segm_to_mask
from torch_detection_tpu_torch.engine import (
    Trainer,
    export_serving,
    load_serving,
    make_inference_fn,
    make_serving_fn,
    save_serving,
)
from torch_detection_tpu_torch.engine.checkpoint import (
    META_FILE,
    load_checkpoint,
    load_checkpoint_file,
    optimizer_state,
    save_checkpoint,
)
from torch_detection_tpu_torch.engine import eval as eval_mod
from torch_detection_tpu_torch.engine import validate as validate_mod
from torch_detection_tpu_torch.engine.eval import eval_coco_map, eval_coco_segm_map, eval_voc_map
from torch_detection_tpu_torch.engine.profiling import TRACE_NAME
from torch_detection_tpu_torch.engine.tta import masks_to_original
from torch_detection_tpu_torch.engine.validate import (
    coco_detection_dump,
    coco_segm_dump,
    evaluate_detector,
)
from torch_detection_tpu_torch.models.backbones.mobilenet import MOBILENETV2_SETTINGS
from torch_detection_tpu_torch.models.backbones.resnet import space_to_depth_2x2
from torch_detection_tpu_torch.models.inits import init_weights
from torch_detection_tpu_torch.models.detectors import (
    CenterNetConfig,
    FastRCNNConfig,
    MaskRCNNConfig,
    YOLOV3Config,
    YOLOXConfig,
    centernet_loss,
    centernet_targets,
    decode_centernet,
    decode_detr,
    decode_solov2,
    decode_sparse_rcnn,
    sampling_noise,
    ssd_candidates,
    ssd_loss,
    simota_assign,
    solov2_loss,
    solov2_targets,
    yolo_candidates,
    yolo_loss,
    yolox_loss,
)
from torch_detection_tpu_torch.models.detectors import detr as detr_mod
from torch_detection_tpu_torch.models.detectors import yolox as yolox_mod
from torch_detection_tpu_torch.models.detectors.centernet import centernet_peaks
from torch_detection_tpu_torch.models.detectors.yolox import (
    INF as SIMOTA_INF,
    decode_boxes,
    flat_grid,
    flatten_yolox_outputs,
    yolox_candidates,
)
from torch_detection_tpu_torch.models.detectors.atss import (
    assign_and_match,
    atss_candidates,
    atss_loss,
    atss_targets,
    level_counts,
)
from torch_detection_tpu_torch.models.detectors.cascade_rcnn import (
    _cascade_rcnn_loss_core,
    next_candidates,
    refine,
)
from torch_detection_tpu_torch.models.detectors.single_stage import (
    decode_candidates,
    loss_weights,
    preselect,
    retina_targets,
)
from torch_detection_tpu_torch.models.detectors.fcos import (
    dense_nms,
    fcos_candidates,
    fcos_loss,
    fcos_targets,
    flat_points,
    flatten_outputs,
)
from torch_detection_tpu_torch.models.detectors.foveabox import (
    flat_geometry,
    fovea_candidates,
    fovea_loss,
    fovea_targets,
)
from torch_detection_tpu_torch.models.detectors.free_anchor import (
    flat_inputs,
    free_anchor_loss,
    negative_term,
    positive_term,
)
from torch_detection_tpu_torch.models.detectors.gfl import gfl_candidates, gfl_loss
from torch_detection_tpu_torch.models.detectors.paa import (
    candidate_losses,
    candidate_slates,
    initial_assignment,
    paa_candidates,
    paa_loss,
    paa_reassign,
    scatter_positives,
    score_voting,
    separate,
)
from torch_detection_tpu_torch.models.detectors.mask_rcnn import mask_frame, sample_mask_rois
from torch_detection_tpu_torch.models.detectors.sparse_rcnn import (
    match,
    matching_cost,
    set_losses,
    set_targets,
)
from torch_detection_tpu_torch.models.detectors.ssd import (
    cross_entropy,
    flatten_ssd_outputs,
    hard_negatives,
    ssd_targets,
)
from torch_detection_tpu_torch.models.detectors.yolov3 import preselect_yolo, yolo_targets
from torch_detection_tpu_torch.models.detectors.two_stage import (
    _faster_rcnn_inference_core,
    class_nms,
    flatten_rpn_outputs,
    rcnn_losses,
    roi_features,
    rpn_losses,
    sample_rois,
)
from torch_detection_tpu_torch.models.heads import flatten_head_outputs, generate_proposals, mask_loss
from torch_detection_tpu_torch.models.heads.mask_head import (
    mask_target_means,
    mask_targets_for_rois,
    select_class,
)
from torch_detection_tpu_torch.models.torch_import import (
    RESNET_KEY_RULES,
    convert_state_dict,
    detector_key_rules,
    prefixed_rules,
)
from torch_detection_tpu_torch.ops import hungarian
from torch_detection_tpu_torch.ops import nms as nms_ops
from torch_detection_tpu_torch.ops import roi_align
from torch_detection_tpu_torch.ops.assign import MaxIoUAssigner
from torch_detection_tpu_torch.ops.boxes import bbox_overlaps, clip_boxes, delta2bbox
from torch_detection_tpu_torch.ops.gmm import gmm_em_1d
from torch_detection_tpu_torch.ops.losses import sigmoid_focal_loss_sparse, smooth_l1_loss
from torch_detection_tpu_torch.ops.preprocess import (
    fused_normalize_pad,
    fused_normalize_pad_s2d,
    space_to_depth_2x2_np,
)
from torch_detection_tpu_torch.parallel.distributed import init_distributed, shutdown_distributed
from torch_detection_tpu_torch.parallel.mesh import (
    full_tensor,
    local_tensor,
    make_mesh,
    shard_batch,
)
from torch_detection_tpu_torch.parallel.tensor_parallel import tensor_parallel_plan
from torch_detection_tpu_torch.parallel.train_step import (
    ParamEMA,
    make_optimizer,
    make_train_step,
    micro_batch_parts,
    split_batch,
)
from torch_detection_tpu_torch.tools import dump_proposals as dump_cli
from torch_detection_tpu_torch.tools import export as export_cli
from torch_detection_tpu_torch.tools import test as test_cli
from torch_detection_tpu_torch.tools import train as train_cli
from torch_detection_tpu_torch.tools import visualize as visualize_cli
from torch_detection_tpu_torch.utils.config import Config, _to_plain
from torch_detection_tpu_torch.utils.file_handler import dump, load
from torch_detection_tpu_torch.utils.registry import BACKBONES, DETECTORS

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tests"))
import torch_golden_cases as golden_cases  # noqa: E402  the golden cases, defined once
CONFIG = ROOT / "configs" / "faster_rcnn_r50_fpn_coco.py"
MASK_CONFIG = ROOT / "configs" / "mask_rcnn_r50_fpn_coco.py"
RETINA_CONFIG = ROOT / "configs" / "retinanet_r50_fpn_coco.py"
CASCADE_CONFIG = ROOT / "configs" / "cascade_rcnn_r50_fpn_coco.py"
CASCADE_MASK_CONFIG = ROOT / "configs" / "cascade_mask_rcnn_r50_fpn_coco.py"
FAST_CONFIG = ROOT / "configs" / "fast_rcnn_r50_fpn_coco.py"
SPARSE_CONFIG = ROOT / "configs" / "sparse_rcnn_r50_fpn_coco.py"
DETR_CONFIG = ROOT / "configs" / "detr_r50_coco.py"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
SEED = 0
SPIN_CYCLES = 60_000_000  # cuda_ms's head start for the host, about 30 ms at 1.98 GHz
F32_ATOL = 1e-5

# the slice's shapes: 1000 proposals an image at serving, 512 sampled rois
# an image in training, gt padded to 100
BATCH, CANVAS, CHANNELS, ROIS, TRAIN_ROIS, MAX_GTS = 4, (800, 1216), 256, 1000, 512, 100
INNER_SHAPES = ((640, 960), (704, 1088))  # of every four images, two smaller than the canvas
STRIDES = (4, 8, 16, 32)
OUT_SIZE, RATIO = 7, 2
WARMUP_BATCHES, TIMED_BATCHES = 2, 10
BENCH_BATCH, BENCH_TIMED_BATCHES = 48, 5  # bench.py's serving batch
RETINA_TRAIN_BATCH = 8  # the RetinaNet config's sample_per_replica
SPARSE_TRAIN_BATCH = 8  # the Sparse R-CNN config's, inherited from the RetinaNet base


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events. The
    device first spins for about 30 ms while the host queues the calls, so
    that a call shorter than its wrapper's host time is timed on the device
    and not at the host's launch rate (a call that syncs with the host is
    timed with its syncs)."""
    for _ in range(warmup):
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
    """Gradients sum many products, in another order than the plain
    version's: within F32_ATOL * max(1, max |want|)."""
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


def touched_bytes(feats, rois, out_size: int = OUT_SIZE) -> int:
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
        y0, y1, _ = roi_align.axis_samples(box[:, 1], box[:, 3], 1.0 / stride, h, out_size, RATIO)
        x0, x1, _ = roi_align.axis_samples(box[:, 0], box[:, 2], 1.0 / stride, w, out_size, RATIO)
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


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits, NaN included."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(a.view(ints), b.view(ints))


def check_deterministic(name: str, kernel, args) -> None:
    """K2 sums in a fixed order: two launches on the same inputs give the
    same bits."""
    first, second = kernel(*args), kernel(*args)
    if not all(bitwise_equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    log(f"{name}: two launches bitwise equal")


def phase_roi_align_bwd() -> dict:
    """K2 vs its plain version at the training shapes: the slice's P2-P5,
    512 rois an image, a seeded cotangent. The kernel's time is the
    wrapper's: the empty allocation of the outputs and the one launch."""
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
        args = (grad, rois, levels, shapes, STRIDES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = kernel(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        want = plain(*args)
        torch.cuda.synchronize()
        err = check_grads(name, got, want, dtype)
        check_deterministic(name, kernel, args)
        ms = cuda_ms(lambda: kernel(*args), iters=20)
        plain_ms = cuda_ms(lambda: plain(*args), iters=2, warmup=1)
        in_bytes = grad.numel() * grad.element_size() + rois.numel() * 4 + levels.numel() * 4
        out_bytes = cells * grad.element_size()
        flops = 2 * 4 * BATCH * TRAIN_ROIS * (OUT_SIZE * RATIO) ** 2 * CHANNELS  # 4 corners a sample, channel
        result[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             **bound(name, in_bytes, out_bytes, flops))
        log(f"{name}: kernel (empty outputs, one launch) {ms:.4f} ms, device memory of one call "
            f"{peak / 1e6:.1f} MB (the gradients {out_bytes / 1e6:.1f} MB); plain {plain_ms:.3f} ms, "
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


def edge_inputs(gen: torch.Generator):
    """3 images on the slice's canvas with P2-P5 of 256 channels, 512 rois
    each: image 0 holds 512 copies of one roi (routed to P2, 24.5 x 24.5
    cells there, over 16 tiles of K2); image 1 512 rois of 14 x 14 px packed
    into one 8 x 8-cell area of P2 (32 x 32 px); image 2 the slice's random
    rois with a NaN roi and a roi larger than P5 in front. The rois of
    images 0 and 1 start on a grid of 1/4 cell with bins of 3.5 or 0.5 cells
    (halved at out 14), so every sample weight has few fraction bits: with
    the cotangent that ``edge_cotangent`` gives them, every f32 sum there is
    exact in any order, and the kernel must equal the plain version even
    where 512 rois add up on one cell."""
    device = torch.device("cuda")
    h, w = CANVAS
    feats32 = [torch.randn((3, h // s, w // s, CHANNELS), generator=gen, device=device)
               for s in STRIDES]
    one = torch.tensor([301.0, 201.0, 399.0, 299.0], device=device)
    corner = 600.0 + torch.randint(0, 19, (TRAIN_ROIS, 2), generator=gen, device=device).float()
    packed = torch.cat([corner, corner + 14.0], dim=-1)
    mixed = slice_rois(gen, device, TRAIN_ROIS)[0].clone()
    mixed[0] = float("nan")
    mixed[1] = torch.tensor([-600.0, -500.0, 2200.0, 1700.0], device=device)
    return feats32, torch.stack([one.expand(TRAIN_ROIS, 4), packed, mixed]).contiguous()


def edge_cotangent(gen: torch.Generator, rois: torch.Tensor, out_size: int) -> torch.Tensor:
    """A seeded cotangent for ``edge_inputs``: multiples of 1/16 in [-1, 1]
    for images 0 and 1 (exact in bf16, and exact f32 sums there), standard
    normal for image 2."""
    shape = (*rois.shape[:2], out_size, out_size, CHANNELS)
    dyadic = torch.randint(-16, 17, shape, generator=gen, device="cuda") / 16.0
    normal = torch.randn(shape, generator=gen, device="cuda")
    return torch.cat([dyadic[:2], normal[2:]])


def without_nans(name: str, got: torch.Tensor, want: torch.Tensor):
    """NaN at the same elements on both sides, as a NaN roi spreads it; both
    returned with those elements zeroed, and the NaN count."""
    got_nan, want_nan = torch.isnan(got), torch.isnan(want)
    if not torch.equal(got_nan, want_nan):
        raise AssertionError(f"{name}: NaN at {int((got_nan != want_nan).sum())} other elements")
    return got.masked_fill(got_nan, 0), want.masked_fill(want_nan, 0), int(got_nan.sum())


def phase_roi_align_edges() -> None:
    """K1 and K2 against their plain versions on ``edge_inputs``, out 7 and
    14, float32 and bf16: one roi 512 times (hot tiles for K2), 512 rois in
    one tile, a NaN roi (NaN where the plain version puts it) and a roi
    larger than its level. K2 must give the same bits twice; its time here
    shows what hot tiles cost."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    feats32, rois = edge_inputs(gen)
    levels = roi_align.map_rois_to_levels(rois, len(STRIDES))
    shapes = [tuple(f.shape[1:3]) for f in feats32]
    log(f"edge rois: levels of image 0 {sorted(set(levels[0].tolist()))}, image 1 "
        f"{sorted(set(levels[1].tolist()))}; the NaN roi at level {int(levels[2, 0])}, the large "
        f"one at {int(levels[2, 1])}")
    for out_size in (OUT_SIZE, 14):
        grad32 = edge_cotangent(gen, rois, out_size)
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"out={out_size} {str(dtype).replace('torch.', '')}"
            feats = [f.to(dtype) for f in feats32]
            got = roi_align.multilevel_roi_align_cuda(feats, rois, levels, STRIDES, out_size)
            want = roi_align.multilevel_roi_align(feats, rois, levels, STRIDES, out_size)
            got, want, nans = without_nans(f"roi_align_fwd edges {tag}", got, want)
            if nans != out_size * out_size * CHANNELS:
                raise AssertionError(f"roi_align_fwd edges {tag}: {nans} NaN, not one roi's")
            (check_f32 if dtype == torch.float32 else check_bf16)(
                f"roi_align_fwd edges {tag}", got, want)

            args = (grad32.to(dtype), rois, levels, shapes, STRIDES, out_size)
            got = roi_align.multilevel_roi_align_backward_cuda(*args)
            want = roi_align.multilevel_roi_align_backward(*args)
            pairs = [without_nans(f"roi_align_bwd edges {tag}", g, w) for g, w in zip(got, want)]
            nans = [n for _, _, n in pairs]
            if nans != [2 * 2 * CHANNELS, 0, 0, 0]:
                raise AssertionError(f"roi_align_bwd edges {tag}: NaN per level {nans}")
            check_grads(f"roi_align_bwd edges {tag}", [g for g, _, _ in pairs],
                        [w for _, w, _ in pairs], dtype)
            check_deterministic(f"roi_align_bwd edges {tag}",
                                roi_align.multilevel_roi_align_backward_cuda, args)
            ms = cuda_ms(lambda: roi_align.multilevel_roi_align_backward_cuda(*args), iters=10)
            log(f"roi_align_bwd edges {tag}: kernel {ms:.4f} ms")


def load_model(dtype: str, device, config: Path = CONFIG):
    cfg = Config.fromfile(config)
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

    reset_launches()
    syncs0 = nms_ops.suppress_syncs()
    timed = iter(images[WARMUP_BATCHES:])
    ms, results = timed_batches(lambda: infer(next(timed), img_shape, scale), TIMED_BATCHES)
    launches = roi_align.multilevel_roi_align_cuda.launches
    bwd_launches = roi_align.multilevel_roi_align_backward_cuda.launches
    matcher = hungarian.batched_linear_sum_assignment_cuda.launches
    syncs = nms_ops.suppress_syncs() - syncs0

    log(f"serving path: {TIMED_BATCHES} batches, K1 launches {launches}, K2 launches "
        f"{bwd_launches}, matcher launches {matcher}, NMS fixpoint syncs "
        f"{syncs / TIMED_BATCHES:.1f} a batch")
    if launches != TIMED_BATCHES or bwd_launches != 0 or matcher != 0:
        raise AssertionError(f"expected one K1 launch a batch and no K2 or matcher launch, got "
                             f"{launches}, {bwd_launches} and {matcher}")
    for res in results:
        check_detections(res, det_cfg, BATCH, h, w)
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
    return dict(launches=launches, bwd_launches=bwd_launches, matcher=matcher, ms_per_batch=mean_ms)


def check_detections(res, det_cfg, batch: int, h: int, w: int) -> None:
    """Shapes, finite values, a detection in every image, labels in range,
    boxes inside the image, scores above ``score_thr``."""
    if res.boxes.shape != (batch, det_cfg.max_detections, 4):
        raise AssertionError(f"boxes shape {tuple(res.boxes.shape)}")
    for t in (res.scores, res.labels, res.valid, res.indices):
        if t.shape != (batch, det_cfg.max_detections):
            raise AssertionError(f"output shape {tuple(t.shape)}")
    if not (torch.isfinite(res.boxes).all() and torch.isfinite(res.scores).all()):
        raise AssertionError("non-finite detections")
    v = res.valid
    if not bool(v.any(dim=1).all()):
        raise AssertionError("an image without a detection above score_thr")
    lab, bx = res.labels[v], res.boxes[v]
    if not (bool((lab >= 0).all()) and bool((lab < det_cfg.num_classes).all())):
        raise AssertionError("labels out of range")
    if not (bool((bx >= 0).all()) and bool((bx[:, 0::2] <= w - 1).all())
            and bool((bx[:, 1::2] <= h - 1).all())):
        raise AssertionError("boxes outside the image")
    if not bool((res.scores[v] > det_cfg.score_thr).all()):
        raise AssertionError("a valid detection under score_thr")


def timed_batches(run, n: int):
    """Host ms of ``n`` calls of ``run``, each ended by a device sync, and
    their results."""
    ms, results = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        results.append(run())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, results


def stage_timer(times: dict):
    """``stage(name, fn)``: ``fn()`` between two device syncs, its host ms
    appended to ``times[name]``."""
    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out
    return stage


def log_breakdown(title: str, times: dict, card: str) -> None:
    median = {k: statistics.median(v) for k, v in times.items()}
    total = sum(median.values())
    log(f"{title} [{card}]: " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / total:.1f}%)" for k, v in median.items()))


def device_profile(run_batch, batch_ms: float, card: str, what: str = "batch") -> dict:
    """One batch (or step) under torch.profiler: the time in which the
    device ran a kernel, its share of an unprofiled one (``batch_ms``), and
    the PyTorch operators whose kernels took most of it; returns the busy
    ms and the idle share (empty where the profiler saw no device event)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_batch()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"device profile, one {what} [{card}]: not measured (the profiler recorded no device "
            "events)")
        return {}
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
    roi = [(key, us, n) for key, us, n in ops if "RoIAlign" in key or "roi_align" in key]
    log(f"device profile, one {what} [{card}]: RoIAlign operators "
        + ("; ".join(f"{key} {us / 1e3:.3f} ms ({n} calls)" for key, us, n in roi) or "none"))
    return dict(busy_ms=busy_ms, idle=1 - busy_ms / batch_ms, kernels=len(kernels))


def stage_breakdown(model, det_cfg, images, img_shape, card: str, repeats: int = 5) -> None:
    """The batch stage by stage, a device sync between stages; the median
    host ms of each stage over ``repeats`` runs. A Mask R-CNN adds its mask
    branch on the detections."""
    times = {}
    stage = stage_timer(times)
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

            dets = stage("decode + multiclass NMS", decode_and_nms)
            if isinstance(det_cfg, MaskRCNNConfig):
                mask_feats = stage("mask roi_align K1 out 14", lambda: (
                    roi_align.batched_multilevel_roi_align(list(feats[:4]), dets.boxes,
                                                           det_cfg.roi_strides,
                                                           det_cfg.mask_roi_size)))
                logits = stage("mask head", lambda: model.mask_forward(mask_feats))
                stage("mask class select, sigmoid", lambda: torch.sigmoid(
                    select_class(logits, dets.labels).float()) * dets.valid[..., None, None])
    log_breakdown(f"stage breakdown, median of {repeats} batches", times, card)


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

    def iter_batches(self, skip_batches: int = 0):
        return (dict(b) for b in self.batches[skip_batches:])

    def __len__(self) -> int:
        return len(self.batches)


def padded_images(gen: torch.Generator, batch: int, canvas) -> tuple:
    """``batch`` (a multiple of 4) seeded float32 images on ``canvas``, of
    every four two filling it and two of ``INNER_SHAPES`` with zeros
    outside, and their (B, 2) (h, w)."""
    device = torch.device("cuda")
    h, w = canvas
    shapes = torch.tensor([[h, w], [h, w], *INNER_SHAPES] * (batch // 4),
                          dtype=torch.float32, device=device)
    image = torch.randn((batch, h, w, 3), generator=gen, device=device)
    inside = ((torch.arange(h, device=device)[None, :, None] < shapes[:, 0, None, None])
              & (torch.arange(w, device=device)[None, None, :] < shapes[:, 1, None, None]))
    return image * inside[..., None], shapes


def train_batch(gen: torch.Generator, batch: int = BATCH, canvas=CANVAS) -> dict:
    """``padded_images`` on ``canvas`` (default 800 x 1216) and 1-20 gt
    boxes an image (16-400 px, labels 1-80) inside each image, padded to
    100."""
    image, shapes = padded_images(gen, batch, canvas)
    boxes, labels, valid = seeded_gts(gen, shapes)
    return dict(image=image, gt_boxes=boxes, gt_labels=labels, gt_valid=valid, img_shape=shapes)


def seeded_gts(gen: torch.Generator, shapes: torch.Tensor):
    """1-20 gt boxes an image (16-400 px, labels 1-80) inside each (h, w)
    of ``shapes``, padded to 100: boxes, labels and validity."""
    device, batch = shapes.device, shapes.shape[0]
    u = torch.rand((batch, MAX_GTS, 4), generator=gen, device=device)
    size = 16.0 * 25.0 ** u[..., 2:]
    xy = u[..., :2] * (shapes[:, None, [1, 0]] - 1 - size)
    num = torch.randint(1, 21, (batch, 1), generator=gen, device=device)
    valid = torch.arange(MAX_GTS, device=device)[None, :] < num
    boxes = torch.where(valid[..., None], torch.cat([xy, xy + size], dim=-1), 0.0)
    labels = torch.randint(1, 81, (batch, MAX_GTS), generator=gen, device=device)
    return boxes, torch.where(valid, labels, 0), valid


LOSS_KEYS = ("loss", "loss_rpn_cls", "loss_rpn_reg", "loss_rcnn_cls", "loss_rcnn_reg")


def phase_train(card: str) -> dict:
    """Full-width Faster R-CNN R50-FPN training, float32 parameters and bf16
    compute, b4 on the 800 x 1216 canvas, through the entry points a user
    calls; K1's and K2's launches are counted over the timed steps."""
    cfg = Config.fromfile(CONFIG)
    steps = WARMUP_BATCHES + TIMED_BATCHES
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    batches = [train_batch(gen) for _ in range(steps)]
    model, det_cfg, _, optimizer = build_train_objects(cfg, "cuda", seed=SEED,
                                                       loader=Batches(batches))
    loss_fn = build_loss_fn(model, det_cfg, rng_seed=SEED)
    Trainer(loss_fn, model, optimizer, Batches(batches[:WARMUP_BATCHES]), log_interval=1).run(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(loss_fn, model, optimizer, Batches(batches[WARMUP_BATCHES:]), log_interval=1)

    reset_launches()
    t0 = time.perf_counter()
    history = trainer.run(1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1 = roi_align.multilevel_roi_align_cuda.launches
    k2 = roi_align.multilevel_roi_align_backward_cuda.launches
    matcher = hungarian.batched_linear_sum_assignment_cuda.launches

    log(f"training path: {TIMED_BATCHES} steps, K1 launches {k1}, K2 launches {k2}, matcher "
        f"launches {matcher}")
    if k1 != TIMED_BATCHES or k2 != TIMED_BATCHES or matcher != 0:
        raise AssertionError(f"expected one K1 and one K2 launch a step and no matcher launch, "
                             f"got {k1}, {k2} and {matcher}")
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
    profile = device_profile(lambda: trainer.train_step(dict(batches[-1])), mean_ms, card, "step")
    train_stage_breakdown(model, det_cfg, optimizer, batches[-1], card)
    return dict(k1=k1, k2=k2, matcher=matcher, ms_per_step=mean_ms, profile=profile, model=model,
                det_cfg=det_cfg, batch=batches[-1])


def train_stage_breakdown(model, det_cfg, optimizer, batch, card: str, repeats: int = 5) -> None:
    """A training step stage by stage (the stages of
    ``two_stage._faster_rcnn_loss_core``, for a Mask R-CNN those of
    ``mask_rcnn.mask_rcnn_loss``, the backward and the optimizer), a device
    sync between stages; the median host ms of each over ``repeats``
    steps."""
    noise = functools.partial(sampling_noise, torch.Generator(device="cuda").manual_seed(SEED + 10))
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
    times = {}
    stage = stage_timer(times)

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
        sampled = stage("roi assign and sample", lambda: sample_rois(
            det_cfg, props.boxes, props.valid, *gt, noise))
        rcnn_l = stage("roi_align K1, box head, losses", lambda: roi_stage(feats, sampled))
        loss = rpn_l[0].mean() + rpn_l[1].mean() + rcnn_l[0] + rcnn_l[1]
        if isinstance(det_cfg, MaskRCNNConfig):
            loss = loss + mask_stages(stage, model, det_cfg, batch, feats, props, noise)
        stage("backward (K2 in it)", loss.backward)
        stage("grad norm, clip, SGD", lambda: optimizer.apply(optimizer.global_norm()))
    optimizer.zero_grad()
    log_breakdown(f"training stage breakdown, median of {repeats} steps", times, card)


def mask_stages(stage, model, det_cfg, batch, feats, props, noise):
    """The mask branch of a training step, each part timed by ``stage``;
    returns the mask loss."""
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
    slate = stage("mask assign and sample", lambda: sample_mask_rois(det_cfg, props, *gt, noise))
    targets = stage("mask targets", lambda: mask_targets_for_rois(
        batch["gt_masks"], slate.rois, slate.matched, det_cfg.mask_size))
    roi_feats = stage("mask roi_align K1 out 14", lambda: roi_align.batched_multilevel_roi_align(
        list(feats[: len(det_cfg.roi_strides)]), slate.rois, det_cfg.roi_strides,
        det_cfg.mask_roi_size))
    logits = stage("mask head", lambda: model.mask_forward(roi_feats))
    return stage("mask loss", lambda: mask_loss(logits, targets, slate.labels, slate.is_pos))


def phase_train_bwd_on_step_data(model, det_cfg, batch) -> None:
    """K2 against its plain version on a training step's own FPN levels,
    sampled rois and the box head's cotangent."""
    noise = functools.partial(sampling_noise, torch.Generator(device="cuda").manual_seed(SEED + 7))
    feats, rpn_s, rpn_d = model(batch["image"])
    props = generate_proposals(det_cfg.proposal_train, det_cfg.anchor_generator,
                               [s.detach() for s in rpn_s], [d.detach() for d in rpn_d],
                               batch["img_shape"])
    sampled = sample_rois(det_cfg, props.boxes, props.valid, batch["gt_boxes"], batch["gt_labels"],
                          batch["gt_valid"], noise)
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
    sg_ = sample_rois(det_cfg, props.boxes, props.valid, gt_gpu["gt_boxes"], gt_gpu["gt_labels"],
                      gt_gpu["gt_valid"], noise_gpu)
    sc_ = sample_rois(det_cfg, props.boxes.cpu(), props.valid.cpu(), gt["gt_boxes"],
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


def reset_launches() -> None:
    for fn in (roi_align.multilevel_roi_align_cuda, roi_align.multilevel_roi_align_backward_cuda,
               hungarian.batched_linear_sum_assignment_cuda):
        fn.launches = 0


def read_launches() -> dict:
    return dict(k1=roi_align.multilevel_roi_align_cuda.launches,
                k2=roi_align.multilevel_roi_align_backward_cuda.launches,
                matcher=hungarian.batched_linear_sum_assignment_cuda.launches)


def expect_launches(path: str, got: dict, k1: int, k2: int, matcher: int = 0) -> None:
    if got != dict(k1=k1, k2=k2, matcher=matcher):
        raise AssertionError(f"{path}: launches {got}; expected K1 {k1}, K2 {k2} and the "
                             f"matcher {matcher}")


def kernel_at(name: str, kernel, plain, args, check, in_bytes: int, out_bytes: int,
              flops: int) -> dict:
    """A kernel against its plain version on ``args`` (``check``), its time,
    the plain version's time and the bound."""
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    err = check(name, got, want)
    ms = cuda_ms(lambda: kernel(*args), iters=20)
    plain_ms = cuda_ms(lambda: plain(*args), iters=2, warmup=1)
    result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound(name, in_bytes, out_bytes, flops))
    log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library_ms none")
    return result


def phase_mask_serving(card: str) -> dict:
    """Full-width Mask R-CNN R50-FPN b4 800x1216 bf16 through
    ``make_inference_fn(..., segm=True)``; K1's launches are counted over
    the run."""
    device = torch.device("cuda")
    model, det_cfg = load_model("bfloat16", device, MASK_CONFIG)
    infer = make_inference_fn(model, det_cfg, segm=True)
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    h, w = CANVAS
    images = [torch.randn((BATCH, h, w, 3), generator=gen, device=device, dtype=torch.bfloat16)
              for _ in range(WARMUP_BATCHES + TIMED_BATCHES)]
    img_shape = torch.tensor([[h, w]] * BATCH, dtype=torch.float32, device=device)
    scale = torch.ones(BATCH, device=device)
    for x in images[:WARMUP_BATCHES]:
        infer(x, img_shape, scale)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    timed = iter(images[WARMUP_BATCHES:])
    ms, results = timed_batches(lambda: infer(next(timed), img_shape, scale), TIMED_BATCHES)
    launches = read_launches()
    log(f"mask serving path: {TIMED_BATCHES} batches, launches {launches}")
    # one K1 launch for the boxes (out 7) and one for the masks (out 14)
    expect_launches("mask serving", launches, 2 * TIMED_BATCHES, 0)

    d = det_cfg.max_detections
    for res in results:
        check_mask_detections(res, det_cfg)
    mean_ms = sum(ms) / len(ms)
    last = results[-1]
    fg = float((last.mask_probs[last.valid] >= 0.5).float().mean())
    log(f"mask serving path: ms a batch {[round(t, 3) for t in ms]}, mean {mean_ms:.3f} ms, "
        f"{BATCH / (mean_ms / 1e3):.2f} images/s, median {statistics.median(ms):.3f} ms [{card}]; "
        f"valid detections a batch {[int(r.valid.sum()) for r in results]}; mask pixels >= 0.5 in "
        f"the last batch's valid masks {fg:.3f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # K1 against its plain version on this run's levels and detections, out 14
    stage_breakdown(model, det_cfg, images[1], img_shape, card)
    with torch.inference_mode():
        dets, feats = _faster_rcnn_inference_core(det_cfg, model, images[1], img_shape)
        maps = list(feats[: len(det_cfg.roi_strides)])
        routed = roi_align.map_rois_to_levels(dets.boxes, len(maps), det_cfg.finest_scale)
        log(f"mask serving detections per level {[int((routed == l).sum()) for l in range(4)]}")
        args = (maps, dets.boxes, routed, det_cfg.roi_strides, det_cfg.mask_roi_size)
        out_bytes = BATCH * d * det_cfg.mask_roi_size ** 2 * CHANNELS * maps[0].element_size()
        in_bytes = (touched_bytes(maps, dets.boxes, det_cfg.mask_roi_size) + dets.boxes.numel() * 4
                    + routed.numel() * 4)
        flops = 2 * 4 * BATCH * d * (det_cfg.mask_roi_size * RATIO) ** 2 * CHANNELS
        k1 = kernel_at("roi_align_fwd on the mask serving run's levels and detections, out 14",
                       roi_align.multilevel_roi_align_cuda, roi_align.multilevel_roi_align, args,
                       check_bf16, in_bytes, out_bytes, flops)
    device_profile(lambda: infer(images[1], img_shape, scale), mean_ms, card)
    return dict(launches=launches, ms_per_batch=mean_ms, k1=k1)


def check_mask_detections(res, det_cfg) -> None:
    """Shapes, a detection in the batch, finite boxes and masks, mask
    probabilities in [0, 1], 0 on invalid slots and not 0 everywhere."""
    d, m = det_cfg.max_detections, 2 * det_cfg.mask_roi_size
    if res.boxes.shape != (BATCH, d, 4) or res.mask_probs.shape != (BATCH, d, m, m):
        raise AssertionError(f"shapes {tuple(res.boxes.shape)}, {tuple(res.mask_probs.shape)}")
    probs, v = res.mask_probs, res.valid
    if not bool(v.any()):
        raise AssertionError("no detection above score_thr")
    if not (torch.isfinite(res.boxes).all() and torch.isfinite(probs).all()):
        raise AssertionError("non-finite detections or masks")
    if not (bool((probs >= 0).all()) and bool((probs <= 1).all())):
        raise AssertionError("mask probabilities outside [0, 1]")
    if bool(probs[~v].any()):
        raise AssertionError("a mask on an invalid slot")
    if not bool((probs[v] > 0).any()):
        raise AssertionError("every valid mask is 0")


def ellipse_masks(gen: torch.Generator, boxes: torch.Tensor, valid: torch.Tensor,
                  canvas) -> torch.Tensor:
    """(B, G, H, W) uint8 masks: a seeded filled ellipse inside each valid
    box (half axes 0.6 to 1 of the box's, the centre anywhere that keeps the
    ellipse inside), 0 elsewhere and for invalid boxes."""
    h, w = canvas
    device = boxes.device
    u = torch.rand((*boxes.shape[:2], 4), generator=gen, device=device)
    x1, y1, x2, y2 = boxes.unbind(-1)
    rx, ry = (x2 - x1) / 2 * (0.6 + 0.4 * u[..., 0]), (y2 - y1) / 2 * (0.6 + 0.4 * u[..., 1])
    cx = x1 + rx + (x2 - x1 - 2 * rx) * u[..., 2]
    cy = y1 + ry + (y2 - y1 - 2 * ry) * u[..., 3]
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None] + 0.5
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :] + 0.5
    masks = torch.zeros((*boxes.shape[:2], h, w), dtype=torch.uint8, device=device)
    for k in range(boxes.shape[1]):  # one gt channel at a time: (B, H, W) temporaries
        dx = (xx - cx[:, k, None, None]) / rx[:, k, None, None].clamp_min(0.5)
        dy = (yy - cy[:, k, None, None]) / ry[:, k, None, None].clamp_min(0.5)
        masks[:, k] = ((dx * dx + dy * dy <= 1) & valid[:, k, None, None]).to(torch.uint8)
    return masks


def mask_rows(valid: torch.Tensor) -> int:
    """The collate's bucket of gt mask rows: the smallest of 8, 16, 32, 64
    or ``MAX_GTS`` that holds every image's gts (the valid gts come first)."""
    n_max = int(valid.sum(1).max())
    return next((bk for bk in (8, 16, 32, 64) if n_max <= bk < MAX_GTS), MAX_GTS)


def mask_train_batch(gen: torch.Generator, batch: int = BATCH, canvas=CANVAS) -> dict:
    """``train_batch`` with ``gt_masks``: one seeded ellipse a gt, the rows
    cut to the collate's bucket (``mask_rows``)."""
    out = train_batch(gen, batch, canvas)
    g = mask_rows(out["gt_valid"])
    out["gt_masks"] = ellipse_masks(gen, out["gt_boxes"][:, :g], out["gt_valid"][:, :g], canvas)
    return out


def check_mask_targets(name: str, gt_masks, rois, matched, mask_size: int) -> None:
    """The mask targets on the GPU against the CPU: equal, except where the
    CPU's value before the threshold lies within one bf16 ulp of 0.5."""
    got = mask_target_means(gt_masks, rois, matched, mask_size).cpu()
    want = mask_target_means(gt_masks.cpu(), rois.cpu(), matched.cpu(), mask_size)
    flips = (got >= 0.5) != (want >= 0.5)
    near = (want - 0.5).abs() <= 2.0 ** -8
    far_flips = int((flips & ~near).sum())
    log(f"{name}: {want.numel()} target pixels, {float((want >= 0.5).float().mean()):.3f} of them 1; "
        f"{int(flips.sum())} differ, {far_flips} of them farther than one bf16 ulp from 0.5; "
        f"values before the threshold max abs diff {float((got - want).abs().max()):.3e}")
    if far_flips:
        raise AssertionError(f"{name}: the GPU's mask targets disagree with the CPU's")


def phase_mask_reference() -> None:
    """The mask branch in float32 on the GPU and on the CPU, stage by stage
    on a small canvas; each GPU stage's output feeds the CPU counterpart of
    the next stage. Then the mask targets of seeded masks and rois."""
    gpu, det_cfg = load_model("float32", "cuda", MASK_CONFIG)
    cpu, _ = load_model("float32", "cpu", MASK_CONFIG)
    gen = torch.Generator().manual_seed(SEED + 15)
    x = torch.randn((2, 256, 320, 3), generator=gen)
    shapes = torch.tensor([[256.0, 320.0], [240.0, 300.0]])
    strides, m = det_cfg.roi_strides, det_cfg.mask_roi_size
    checks = []

    def check(name, err, limit):
        checks.append(f"{name} {err:.2e} (limit {limit:g})")
        if not err <= limit:
            raise AssertionError(f"mask reference check {name}: {err} > {limit}")

    with torch.inference_mode():
        dets, feats = _faster_rcnn_inference_core(det_cfg, gpu, x.cuda(), shapes.cuda())
        maps = list(feats[: len(strides)])
        rg = roi_align.batched_multilevel_roi_align(maps, dets.boxes, strides, m)
        rc = roi_align.batched_multilevel_roi_align([f.cpu() for f in maps], dets.boxes.cpu(),
                                                    strides, m)
        check("mask roi features (K1 out 14 vs plain on the CPU)", rel_err(rg, rc), 1e-5)
        lg, lc = gpu.mask_forward(rg), cpu.mask_forward(rg.cpu())
        check("mask logits", rel_err(lg, lc), 1e-4)
        pg = torch.sigmoid(select_class(lg, dets.labels).float()) * dets.valid[..., None, None]
        pc = torch.sigmoid(select_class(lg.cpu(), dets.labels.cpu()).float()) * dets.valid.cpu()[
            ..., None, None]
        check("mask probabilities", rel_err(pg, pc), 1e-6)
    log(f"mask reference check, GPU vs CPU float32 ({int(dets.valid.sum())} detections): "
        + "; ".join(checks))

    # targets: 2 images of 300 x 400, 12 gts, 64 rois from 8 px to the whole
    # image around them, so that they route to every pyramid level
    g = torch.Generator(device="cuda").manual_seed(SEED + 16)
    size = 8.0 * 50.0 ** torch.rand((2, 12, 2), generator=g, device="cuda")
    xy = torch.rand((2, 12, 2), generator=g, device="cuda") * (torch.tensor([400.0, 300.0],
                                                                           device="cuda") - size)
    gt = torch.cat([xy, xy + size], dim=-1)
    masks = ellipse_masks(g, gt, torch.ones((2, 12), dtype=torch.bool, device="cuda"), (300, 400))
    matched = torch.randint(0, 12, (2, 64), generator=g, device="cuda")
    jitter = (torch.rand((2, 64, 4), generator=g, device="cuda") - 0.5) * 0.4
    box = gt.gather(1, matched[..., None].expand(-1, -1, 4))
    wh = (box[..., 2:] - box[..., :2]).repeat(1, 1, 2)
    check_mask_targets("mask targets on 2 x 300 x 400, 64 rois an image", masks,
                       box + jitter * wh, matched, det_cfg.mask_size)


def phase_mask_train(card: str) -> dict:
    """Full-width Mask R-CNN R50-FPN training, float32 parameters and bf16
    compute, b4 on the 800 x 1216 canvas with gt masks, through the entry
    points a user calls; K1's and K2's launches are counted over the timed
    steps."""
    cfg = Config.fromfile(MASK_CONFIG)
    steps = WARMUP_BATCHES + TIMED_BATCHES
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    batches = [mask_train_batch(gen) for _ in range(steps)]
    model, det_cfg, _, optimizer = build_train_objects(cfg, "cuda", seed=SEED,
                                                       loader=Batches(batches))
    loss_fn = build_loss_fn(model, det_cfg, rng_seed=SEED)
    log(f"mask training batches: gt mask rows {[b['gt_masks'].shape[1] for b in batches]}, gts an "
        f"image {[b['gt_valid'].sum(1).tolist() for b in batches[:3]]} ...")
    Trainer(loss_fn, model, optimizer, Batches(batches[:WARMUP_BATCHES]), log_interval=1).run(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(loss_fn, model, optimizer, Batches(batches[WARMUP_BATCHES:]), log_interval=1)

    reset_launches()
    t0 = time.perf_counter()
    history = trainer.run(1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    log(f"mask training path: {TIMED_BATCHES} steps, launches {launches}")
    # K1 and K2 once for the box slate (out 7), once for the mask slate (out 14)
    expect_launches("mask training", launches, 2 * TIMED_BATCHES, 2 * TIMED_BATCHES)
    if len(history) != TIMED_BATCHES or trainer.skipped_steps:
        raise AssertionError(f"{len(history)} steps logged, {trainer.skipped_steps} skipped")
    keys = LOSS_KEYS + ("loss_mask",)
    for h in history:
        if not all(torch.isfinite(torch.tensor(h[k])) for k in keys):
            raise AssertionError(f"non-finite loss at step {h['step']}: {h}")
        if not (h["loss_mask"] > 0 and h["num_pos_rois"] > 0):
            raise AssertionError(f"no mask loss or no positive roi at step {h['step']}: {h}")
    still = [n for n, p in model.named_parameters() if p.requires_grad and torch.equal(p, before[n])]
    moved = [n for n, p in model.named_parameters() if not p.requires_grad and not torch.equal(p, before[n])]
    mask_params = [n for n in before if n.startswith("mask_head.")]
    if still or moved or len(mask_params) != 2 * (model.mask_head.num_convs + 2):
        raise AssertionError(f"trainable parameters that did not move {still}; frozen ones that "
                             f"moved {moved}; mask head parameters {mask_params}")
    step_ms = [BATCH / h["images_per_sec"] * 1e3 for h in history]
    mean_ms = seconds / TIMED_BATCHES * 1e3
    log(f"mask training path: ms a step {[round(t, 3) for t in step_ms]}, mean {mean_ms:.3f} ms, "
        f"{BATCH / (mean_ms / 1e3):.2f} images/s, median {statistics.median(step_ms):.3f} ms [{card}]; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses first "
        + ", ".join(f"{k} {history[0][k]:.4f}" for k in keys)
        + "; last " + ", ".join(f"{k} {history[-1][k]:.4f}" for k in keys)
        + f"; positive rois a step {[int(h['num_pos_rois']) for h in history]}")
    device_profile(lambda: trainer.train_step(dict(batches[-1])), mean_ms, card, "step")
    train_stage_breakdown(model, det_cfg, optimizer, batches[-1], card)
    return dict(launches=launches, ms_per_step=mean_ms, model=model, det_cfg=det_cfg,
                batch=batches[-1])


def phase_mask_step_data(model, det_cfg, batch) -> dict:
    """K1 and K2 against their plain versions on a training step's own mask
    slate (positives first, 128 rois an image), FPN levels and mask-head
    cotangent at out 14, and K2 on a slate of positives only, each timed
    against its bound; the step's mask targets on the GPU against the
    CPU."""
    noise = functools.partial(sampling_noise, torch.Generator(device="cuda").manual_seed(SEED + 14))
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
    feats, rpn_s, rpn_d = model(batch["image"])
    props = generate_proposals(det_cfg.proposal_train, det_cfg.anchor_generator,
                               [s.detach() for s in rpn_s], [d.detach() for d in rpn_d],
                               batch["img_shape"])
    sample_rois(det_cfg, props.boxes, props.valid, *gt, noise)  # the box slate's draws come first, as in a step
    slate = sample_mask_rois(det_cfg, props, *gt, noise)
    pos = slate.is_pos
    hit = [len(set(slate.matched[i][pos[i]].tolist())) for i in range(BATCH)]
    log(f"mask slate: {slate.rois.shape[1]} rois an image, positives {pos.sum(1).tolist()} on "
        f"{hit} distinct gts")
    check_mask_targets(f"mask targets on a training step's slate, {CANVAS[0]} x {CANVAS[1]}",
                       batch["gt_masks"], slate.rois, slate.matched, det_cfg.mask_size)
    targets = mask_targets_for_rois(batch["gt_masks"], slate.rois, slate.matched, det_cfg.mask_size)
    levels_in = list(feats[: len(det_cfg.roi_strides)])
    m = det_cfg.mask_roi_size
    roi_feats = roi_align.batched_multilevel_roi_align(levels_in, slate.rois, det_cfg.roi_strides, m)
    logits = model.mask_forward(roi_feats)
    (cotangent,) = torch.autograd.grad(mask_loss(logits, targets, slate.labels, pos), roi_feats)
    # mask_loss divides by its positives' pixel count, so the level
    # gradients are about 1e-6, inside F32_ATOL, where even zeros would pass;
    # K2 is linear in the cotangent, so a power of two brings its largest
    # value into [1, 2) and leaves the step's own values otherwise as they were
    top = float(cotangent.abs().max())
    if not top > 0:
        raise AssertionError("the mask slate's cotangent is all zero")
    cotangent = cotangent * 2.0 ** -math.floor(math.log2(top))
    routed = roi_align.map_rois_to_levels(slate.rois, len(levels_in))
    maps = [f.detach() for f in levels_in]
    n = slate.rois.shape[1]
    flops = 2 * 4 * BATCH * n * (m * RATIO) ** 2 * CHANNELS
    small = slate.rois.numel() * 4 + routed.numel() * 4
    roi_bytes = BATCH * n * m * m * CHANNELS * cotangent.element_size()
    k1 = kernel_at("roi_align_fwd on a training step's mask slate, out 14",
                   roi_align.multilevel_roi_align_cuda, roi_align.multilevel_roi_align,
                   (maps, slate.rois, routed, det_cfg.roi_strides, m), check_bf16,
                   touched_bytes(maps, slate.rois, m) + small, roi_bytes, flops)
    args = (cotangent, slate.rois, routed, [tuple(f.shape[1:3]) for f in maps], det_cfg.roi_strides, m)
    name = "roi_align_bwd on a training step's mask slate and mask-head cotangent, out 14"
    check_deterministic(name, roi_align.multilevel_roi_align_backward_cuda, args)
    k2 = kernel_at(name, roi_align.multilevel_roi_align_backward_cuda,
                   roi_align.multilevel_roi_align_backward, args,
                   lambda nm, g, w: check_grads(nm, g, w, cotangent.dtype), roi_bytes + small,
                   sum(f.numel() for f in maps) * cotangent.element_size(), flops)

    # what a trained model's slate looks like: every roi a positive, piled
    # onto the batch's 1-20 gts. Its cotangent is positive, in [0.5, 1): a
    # cell sums thousands of terms here, and signed terms that cancel leave
    # no f32 order within a bf16 ulp of the other (the edge phase's finding),
    # while positive ones keep both sums far inside one
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    n_gt = batch["gt_valid"].sum(1)
    pick = (torch.rand((BATCH, n), generator=g, device="cuda") * n_gt[:, None]).long()
    box = batch["gt_boxes"].gather(1, pick[..., None].expand(-1, -1, 4))
    wh = (box[..., 2:] - box[..., :2]).repeat(1, 1, 2)
    hot = (box + (torch.rand((BATCH, n, 4), generator=g, device="cuda") - 0.5) * 0.2 * wh).contiguous()
    hot_cot = 0.5 + 0.5 * torch.rand(cotangent.shape, generator=g, device="cuda")
    hot_cot = hot_cot.to(cotangent.dtype)
    hot_routed = roi_align.map_rois_to_levels(hot, len(maps))
    hot_args = (hot_cot, hot, hot_routed, *args[3:])
    name = f"roi_align_bwd on {n} positives an image around {n_gt.tolist()} gts, out 14"
    check_deterministic(name, roi_align.multilevel_roi_align_backward_cuda, hot_args)
    k2_hot = kernel_at(name, roi_align.multilevel_roi_align_backward_cuda,
                       roi_align.multilevel_roi_align_backward, hot_args,
                       lambda nm, g, w: check_grads(nm, g, w, hot_cot.dtype),
                       roi_bytes + small, sum(f.numel() for f in maps) * hot_cot.element_size(), flops)
    log(f"{name}: kernel {k2_hot['ms']:.4f} ms (the step's own slate {k2['ms']:.4f} ms)")
    return dict(k1=k1, k2=k2, k2_hot=k2_hot)


def retina_wire(seed: int, batch: int):
    """Seeded uint8 images on the canvas relaid 2x2 space-to-depth on the
    host (the ``stem_s2d`` wire), put on the card once, and their (h, w)."""
    h, w = CANVAS
    u8 = np.random.default_rng(seed).integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    wire = torch.from_numpy(space_to_depth_2x2_np(u8)).cuda()
    return wire, torch.tensor([[h, w]] * batch, dtype=torch.float32, device="cuda")


def load_retina(dtype: str, device):
    """The RetinaNet build with ``cls_out``'s bias at 0. With the focal
    prior (-4.6) random weights score every pair near sigmoid(-4.6) = 0.01,
    under ``score_thr`` 0.05, and the NMS pool would be empty; at 0 the
    scores sit near 0.5, so every stage of the path, NMS included, works
    on a full pool."""
    model, det_cfg = load_model(dtype, device, RETINA_CONFIG)
    with torch.no_grad():
        model.head.cls_out.bias.zero_()
    return model, det_cfg


def serve_s2d(infer, wire, shapes):
    """bench.py's timed batch: the u8 s2d wire normalized on the card, then
    ``infer``."""
    scale = torch.ones(wire.shape[0], device=wire.device)

    def run():
        return infer(fused_normalize_pad_s2d(wire, shapes, out_dtype=torch.bfloat16), shapes, scale)

    return run


def phase_retina_serving(card: str) -> dict:
    """Full-width RetinaNet R50-FPN, bf16, b4 on the 800 x 1216 s2d wire
    through ``fused_normalize_pad_s2d`` and ``make_inference_fn``; K1 and
    K2 counted (none expected); then bench.py's batch, 48."""
    model, det_cfg = load_retina("bfloat16", "cuda")
    infer = make_inference_fn(model, det_cfg)
    h, w = CANVAS
    wire, shapes = retina_wire(SEED + 20, BATCH)
    run = serve_s2d(infer, wire, shapes)
    timed_batches(run, WARMUP_BATCHES)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    syncs0 = nms_ops.suppress_syncs()
    ms, results = timed_batches(run, TIMED_BATCHES)
    launches = read_launches()
    syncs = (nms_ops.suppress_syncs() - syncs0) / TIMED_BATCHES
    log(f"retina serving path: {TIMED_BATCHES} batches, launches {launches}, NMS fixpoint syncs "
        f"{syncs:.1f} a batch")
    expect_launches("retina serving", launches, 0, 0)
    for res in results:
        check_detections(res, det_cfg, BATCH, h, w)
    mean_ms = sum(ms) / len(ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.inference_mode():
        cls, _ = model(fused_normalize_pad_s2d(wire, shapes, out_dtype=torch.bfloat16))
        flat = torch.cat([c.reshape(BATCH, -1) for c in cls], dim=1).float()
        above = (torch.sigmoid(flat) > det_cfg.score_thr).sum(dim=1)
    log(f"retina serving path b{BATCH}: ms a batch {[round(m, 3) for m in ms]}, mean {mean_ms:.3f} ms, "
        f"{BATCH / (mean_ms / 1e3):.2f} images/s, median {statistics.median(ms):.3f} ms [{card}]; "
        f"(anchor, class) pairs above score_thr an image {above.tolist()} of {flat.shape[1]}; valid "
        f"detections an image {results[-1].valid.sum(1).tolist()}; peak memory {peak:.2f} GiB")
    retina_stage_breakdown(model, det_cfg, wire, shapes, card)
    device_profile(run, mean_ms, card)

    del results, cls, flat
    wire, shapes = retina_wire(SEED + 21, BENCH_BATCH)
    run = serve_s2d(infer, wire, shapes)
    timed_batches(run, WARMUP_BATCHES)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms48, results = timed_batches(run, BENCH_TIMED_BATCHES)
    expect_launches("retina serving b48", read_launches(), 0, 0)
    check_detections(results[-1], det_cfg, BENCH_BATCH, h, w)
    mean48 = sum(ms48) / len(ms48)
    log(f"retina serving path b{BENCH_BATCH} (bench.py's batch): ms a batch "
        f"{[round(m, 3) for m in ms48]}, mean {mean48:.3f} ms, {BENCH_BATCH / (mean48 / 1e3):.2f} "
        f"images/s, median {statistics.median(ms48):.3f} ms [{card}]; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    device_profile(run, mean48, card, f"b{BENCH_BATCH} batch")
    return dict(launches=launches, ms_per_batch=mean_ms, ms_per_batch_b48=mean48)


def retina_stage_breakdown(model, det_cfg, wire, shapes, card: str, repeats: int = 5) -> None:
    """A serving batch stage by stage, a device sync between stages; the
    median host ms of each over ``repeats`` batches."""
    times = {}
    stage = stage_timer(times)
    syncs = []
    with torch.inference_mode():
        for _ in range(repeats):
            x = stage("preprocess (u8 s2d wire)", lambda: fused_normalize_pad_s2d(
                wire, shapes, out_dtype=torch.bfloat16))
            feats = stage("backbone (folded stem, R50)", lambda: model.backbone(x))
            levels = stage("fpn", lambda: model.neck(feats))
            cls, reg = stage("retina head", lambda: model.head(levels))
            cand = stage("preselect", lambda: preselect(det_cfg, cls, reg))
            scores, boxes = stage("sigmoid, decode, clip", lambda: decode_candidates(
                det_cfg, cand, shapes))
            s0 = nms_ops.suppress_syncs()
            stage("multiclass NMS", lambda: nms_ops.multiclass_nms(
                boxes, scores, det_cfg.nms_iou_thr, det_cfg.score_thr, det_cfg.pre_nms_top_k,
                det_cfg.max_detections))
            syncs.append(nms_ops.suppress_syncs() - s0)
    log_breakdown(f"retina stage breakdown, median of {repeats} batches", times, card)
    log(f"retina NMS: {cand.logits.shape[1]} candidates an image, fixpoint syncs {syncs}")


def phase_retina_stem(card: str) -> None:
    """The folded 4x4 stem on the s2d wire against the 7x7 stride-2 conv on
    the same images in plain layout, cuDNN, bf16, b4 800 x 1216."""
    model, _ = load_model("bfloat16", "cuda", RETINA_CONFIG)
    conv = model.backbone.stem.conv
    h, w = CANVAS
    u8 = np.random.default_rng(SEED + 22).integers(0, 256, (BATCH, h, w, 3), dtype=np.uint8)
    shapes = torch.tensor([[h, w]] * BATCH, device="cuda")
    plain = fused_normalize_pad(torch.from_numpy(u8).cuda(), shapes).permute(0, 3, 1, 2)
    wire = fused_normalize_pad_s2d(torch.from_numpy(space_to_depth_2x2_np(u8)).cuda(), shapes)
    wire = wire.permute(0, 3, 1, 2)
    with torch.inference_mode():
        err = rel_err(conv(wire), F.conv2d(plain, conv.weight, stride=2, padding=3))
        folded_ms = cuda_ms(lambda: conv(wire), iters=20)
        plain_ms = cuda_ms(lambda: F.conv2d(plain, conv.weight, stride=2, padding=3), iters=20)
    flops = 2 * BATCH * (h // 2) * (w // 2) * 64 * 7 * 7 * 3
    log(f"stem finding [{card}]: folded 4x4 on the s2d wire (input pad and conv) {folded_ms:.4f} ms, "
        f"7x7 stride 2 on the plain layout {plain_ms:.4f} ms; cuDNN, bf16, b{BATCH} {h}x{w}, "
        f"{flops / 1e9:.1f} GFLOP of 7x7 taps; outputs differ by {err:.2e} (bf16 rounding)")
    if not err <= 0.05:
        raise AssertionError(f"the folded stem disagrees with the 7x7 conv: {err}")


def phase_retina_reference() -> None:
    """The serving path in float32 on the GPU and on the CPU, stage by
    stage on a small canvas; each GPU stage's output feeds the CPU
    counterpart of the next stage."""
    gpu, det_cfg = load_retina("float32", "cuda")
    cpu, _ = load_retina("float32", "cpu")
    u8 = np.random.default_rng(SEED + 23).integers(0, 256, (2, 256, 320, 3), dtype=np.uint8)
    wire = torch.from_numpy(space_to_depth_2x2_np(u8))
    shapes = torch.tensor([[256, 320], [237, 301]], dtype=torch.float32)
    checks = []

    def check(name, err, limit):
        checks.append(f"{name} {err:.2e} (limit {limit:g})")
        if not err <= limit:
            raise AssertionError(f"retina reference check {name}: {err} > {limit}")

    with torch.inference_mode():
        xg = fused_normalize_pad_s2d(wire.cuda(), shapes.cuda(), out_dtype=torch.float32)
        xc = fused_normalize_pad_s2d(wire, shapes, out_dtype=torch.float32)
        check("preprocess mismatches", float((xg.cpu() != xc).sum()), 0)
        # cuDNN and the CPU pick other convolution algorithms and sum orders
        check("stem", rel_err(gpu.backbone.stem(xg.permute(0, 3, 1, 2)),
                              cpu.backbone.stem(xc.permute(0, 3, 1, 2))), 1e-4)
        lg, lc = gpu.neck(gpu.backbone(xg)), cpu.neck(cpu.backbone(xc))
        check("fpn levels", max(rel_err(g, c) for g, c in zip(lg, lc)), 1e-3)
        cls_g, reg_g = gpu.head(lg)
        cls_c, reg_c = cpu.head([f.cpu() for f in lg])
        check("head logits and deltas",
              max(rel_err(g, c) for g, c in zip(cls_g + reg_g, cls_c + reg_c)), 1e-4)
        cls_h, reg_h = [c.cpu() for c in cls_g], [r.cpu() for r in reg_g]
        cand_g, cand_c = preselect(det_cfg, cls_g, reg_g), preselect(det_cfg, cls_h, reg_h)
        check("preselected logits, anchors, deltas mismatches",
              float(sum((g.cpu() != c).sum() for g, c in zip(cand_g, cand_c))), 0)
        sg, bg = decode_candidates(det_cfg, cand_g, shapes.cuda())
        sc, bc = decode_candidates(det_cfg, cand_c, shapes)
        # exp and sigmoid may round differently on the two devices, and one
        # ulp can swap two of the many near-equal scores, so NMS takes the
        # GPU's candidates on both devices
        check("candidate scores", float((sg.cpu() - sc).abs().max()), 1e-6)
        check("candidate boxes (px)", float((bg.cpu() - bc).abs().max()), 1e-3)
        nms_args = (det_cfg.nms_iou_thr, det_cfg.score_thr, det_cfg.pre_nms_top_k,
                    det_cfg.max_detections)
        ng = nms_ops.multiclass_nms(bg, sg, *nms_args)
        nc = nms_ops.multiclass_nms(bg.cpu(), sg.cpu(), *nms_args)
        for field in ("valid", "labels", "indices", "scores", "boxes"):
            check(f"multiclass_nms on equal inputs, {field} mismatches",
                  float((getattr(ng, field).cpu() != getattr(nc, field)).sum()), 0)
        if not bool(nc.valid.any(dim=1).all()):
            raise AssertionError("no detection in the reference batch")
    log(f"retina reference check, GPU vs CPU float32 ({nc.valid.sum(1).tolist()} detections): "
        + "; ".join(checks))


def retina_train_batch(gen: torch.Generator) -> dict:
    """``train_batch`` at b8 with its normalized images relaid 2x2
    space-to-depth, as the collate does for an ``stem_s2d`` backbone."""
    batch = train_batch(gen, RETINA_TRAIN_BATCH)
    batch["image"] = space_to_depth_2x2(batch["image"])
    return batch


RETINA_LOSS_KEYS = ("loss", "loss_cls", "loss_reg")


def phase_retina_train(card: str) -> dict:
    """Full-width RetinaNet R50-FPN training, float32 parameters and bf16
    compute, b8 on the 800 x 1216 canvas, through the entry points a user
    calls; K1 and K2 counted (none expected)."""
    cfg = Config.fromfile(RETINA_CONFIG)
    steps = WARMUP_BATCHES + TIMED_BATCHES
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    batches = [retina_train_batch(gen) for _ in range(steps)]
    model, det_cfg, _, optimizer = build_train_objects(cfg, "cuda", seed=SEED,
                                                       loader=Batches(batches))
    loss_fn = build_loss_fn(model, det_cfg, rng_seed=SEED)
    Trainer(loss_fn, model, optimizer, Batches(batches[:WARMUP_BATCHES]), log_interval=1).run(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(loss_fn, model, optimizer, Batches(batches[WARMUP_BATCHES:]), log_interval=1)

    reset_launches()
    t0 = time.perf_counter()
    history = trainer.run(1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    log(f"retina training path: {TIMED_BATCHES} steps, launches {launches}")
    expect_launches("retina training", launches, 0, 0)
    if len(history) != TIMED_BATCHES or trainer.skipped_steps:
        raise AssertionError(f"{len(history)} steps logged, {trainer.skipped_steps} skipped")
    for h in history:
        if not all(math.isfinite(h[k]) for k in RETINA_LOSS_KEYS) or not h["num_pos"] > 0:
            raise AssertionError(f"non-finite loss or no positive anchor at step {h['step']}: {h}")
    still = [n for n, p in model.named_parameters() if p.requires_grad and torch.equal(p, before[n])]
    moved = [n for n, p in model.named_parameters() if not p.requires_grad and not torch.equal(p, before[n])]
    frozen = sum(not p.requires_grad for p in model.parameters())
    if still or moved or not frozen:
        raise AssertionError(f"trainable parameters that did not move {still}; frozen ones that "
                             f"moved {moved}; {frozen} frozen")
    b = RETINA_TRAIN_BATCH
    step_ms = [b / h["images_per_sec"] * 1e3 for h in history]
    mean_ms = seconds / TIMED_BATCHES * 1e3
    keys = RETINA_LOSS_KEYS + ("num_pos",)
    log(f"retina training path b{b}: ms a step {[round(m, 3) for m in step_ms]}, mean "
        f"{mean_ms:.3f} ms, {b / (mean_ms / 1e3):.2f} images/s, median "
        f"{statistics.median(step_ms):.3f} ms [{card}]; skipped steps {trainer.skipped_steps}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; first "
        + ", ".join(f"{k} {history[0][k]:.4f}" for k in keys)
        + "; last " + ", ".join(f"{k} {history[-1][k]:.4f}" for k in keys))
    device_profile(lambda: trainer.train_step(dict(batches[-1])), mean_ms, card, "step")
    retina_train_stage_breakdown(model, det_cfg, optimizer, batches[-1], card)
    return dict(launches=launches, ms_per_step=mean_ms)


def retina_train_stage_breakdown(model, det_cfg, optimizer, batch, card: str,
                                 repeats: int = 5, what: str = "retina") -> None:
    """A training step stage by stage (the stages of ``retina_loss``, the
    backward and the optimizer), a device sync between stages; the median
    host ms of each over ``repeats`` steps, and the assignment's peak
    memory above what was allocated before it."""
    times = {}
    stage = stage_timer(times)
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])

    def assign(cls):
        anchors = det_cfg.anchor_generator.flat_anchors([tuple(c.shape[1:3]) for c in cls], "cuda")
        return retina_targets(det_cfg, anchors, *gt, batch["img_shape"])

    for _ in range(repeats):
        optimizer.zero_grad()
        cls, reg = stage("backbone+fpn+retina head", lambda: model(batch["image"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        targets = stage("anchors + assigner", lambda: assign(cls))
        assign_peak = torch.cuda.max_memory_allocated() - base
        flat_cls, flat_reg = flatten_head_outputs(cls, reg, det_cfg.num_classes)
        cls_w, reg_w = loss_weights(targets)
        loss_cls = stage("focal loss", lambda: sigmoid_focal_loss_sparse(
            flat_cls, targets.label0, cls_w, det_cfg.focal_gamma, det_cfg.focal_alpha))
        loss_reg = stage("smooth L1", lambda: smooth_l1_loss(
            flat_reg.float(), targets.reg_targets, reg_w, det_cfg.smooth_l1_beta))
        stage("backward", (loss_cls + loss_reg).backward)
        stage("grad norm, clip, SGD", lambda: optimizer.apply(optimizer.global_norm()))
    optimizer.zero_grad()
    log_breakdown(f"{what} training stage breakdown, median of {repeats} steps", times, card)
    log(f"{what} assignment: a ({RETINA_TRAIN_BATCH}, {targets.pos.shape[1]}, {MAX_GTS}) IoU, peak "
        f"memory above its inputs {assign_peak / 2**30:.2f} GiB; positives an image "
        f"{targets.pos.sum(1).tolist()}")


def stem_s2d(cfg) -> bool:
    """Whether a config's backbone takes the space-to-depth wire."""
    return bool(cfg["model"]["backbone"].get("stem_s2d", False))


def retina_reference_setup(config: Path = RETINA_CONFIG):
    """A RetinaNet config's training build in float32 on the GPU and on the
    CPU and in float64 on the GPU, on the same seeded weights, and a seeded
    batch of 2 x 256 x 320 images (on the s2d wire for an ``stem_s2d``
    backbone) with 3 and 2 gts: ``(det_cfg, gpu, cpu, f64, batch)``, the
    batch on the CPU."""
    cfg = Config.fromfile(config)
    det_cfg = build_detection_cfg(cfg.detection)
    gpu = build_detector(cfg.model, "float32", "cuda", seed=SEED).train()
    cpu = build_detector(cfg.model, "float32", "cpu", seed=SEED).train()
    f64 = DETECTORS.build(dict(cfg.model), dtype=torch.float64, device="cuda")
    f64 = init_weights(f64, torch.Generator().manual_seed(SEED)).train()  # build_detector's weights
    gen = torch.Generator().manual_seed(SEED + 25)
    image = torch.randn((2, 256, 320, 3), generator=gen)
    batch = dict(
        image=space_to_depth_2x2(image) if stem_s2d(cfg) else image,
        gt_boxes=torch.tensor([[[16, 20, 120, 140], [150, 40, 300, 230], [60, 150, 110, 250], [0] * 4],
                               [[30, 30, 200, 180], [210, 100, 290, 200], [0] * 4, [0] * 4]],
                              dtype=torch.float32),
        gt_labels=torch.tensor([[3, 17, 80, 0], [1, 45, 0, 0]]),
        gt_valid=torch.tensor([[True, True, True, False], [True, True, False, False]]),
        img_shape=torch.tensor([[256.0, 320.0], [240.0, 300.0]]),
    )
    return det_cfg, gpu, cpu, f64, batch


def phase_retina_train_reference(config: Path = RETINA_CONFIG, what: str = "retina") -> None:
    """A RetinaNet config's training path in float32 on the GPU and on the
    CPU on a small canvas: the losses and every parameter's gradient, with
    float64 on the GPU as the yardstick of float32's own rounding."""
    det_cfg, gpu, cpu, f64, batch = retina_reference_setup(config)
    on_gpu = {k: v.cuda() for k, v in batch.items()}
    parts = []
    for model, data in ((gpu, on_gpu), (cpu, batch), (f64, on_gpu)):
        loss, losses = build_loss_fn(model, det_cfg)(data)
        loss.backward()
        parts.append(losses)
    err = max(rel_err(parts[0][k], parts[1][k]) for k in ("loss_cls", "loss_reg"))
    if not err <= 1e-4 or float(parts[0]["num_pos"]) != float(parts[1]["num_pos"]):
        raise AssertionError(f"{what} training losses: {parts[0]} against {parts[1]}")

    def rel_norm(a, b):
        return float((a.cpu().double() - b.cpu().double()).norm() / b.cpu().double().norm().clamp_min(1e-300))

    # each gradient tensor against its norm, and float64 on the GPU as the
    # yardstick: float32's rounding flips a few of the batch's 38 M ReLU
    # decisions (inputs within it of zero; which ones depends on the
    # summation order, cuDNN's or the CPU's), and each flip moves the
    # gradients below it by up to 1e-3 of their norm (conv_precision.py)
    errs = {}
    for (name, g), (_, c), (_, r) in zip(gpu.named_parameters(), cpu.named_parameters(),
                                         f64.named_parameters()):
        if g.requires_grad:
            errs[name] = (rel_norm(g.grad, c.grad), rel_norm(g.grad, r.grad), rel_norm(c.grad, r.grad))

    def worst(i):
        name = max(errs, key=lambda n: errs[n][i])
        return f"{errs[name][i]:.2e} at {name}"

    log(f"{what} training reference check, GPU vs CPU float32 (positives an image "
        f"{float(parts[1]['num_pos']):.1f}): losses {err:.2e} (limit 1e-4); the {len(errs)} "
        f"gradients' relative norm of the difference: GPU vs CPU {worst(0)} (limit 1e-2); against "
        f"float64 on the GPU, GPU float32 {worst(1)} (limit 1e-2), CPU float32 {worst(2)}")
    bad = [n for n, e in errs.items() if not (e[0] <= 1e-2 and e[1] <= 1e-2)]
    if bad:
        raise AssertionError(f"{what} training gradients beyond 1e-2: "
                             f"{[(n, errs[n]) for n in bad]}")


def proposal_slate(gen: torch.Generator, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                   shapes: torch.Tensor, n: int = ROIS):
    """(B, n, 5) seeded proposals and their (B, n) validity, standing in for
    the pkl of ``tools/dump_proposals.py``: of each image's 0.9 n to n valid
    rows, the even ones are jittered copies of its gts (each side moved by
    up to 0.3 of the gt's size), the odd ones random boxes of 8-900 px inside
    the image, each with a random score in the fifth column; the tail is
    zero and invalid, as the collate pads a slate."""
    device, b = gt_boxes.device, gt_boxes.shape[0]

    def u(*shape):
        return torch.rand((b, n, *shape), generator=gen, device=device)

    pick = (u() * gt_valid.sum(1)[:, None]).long()
    src = gt_boxes.gather(1, pick[..., None].expand(-1, -1, 4))
    jittered = src + (u(4) - 0.5) * 0.6 * (src[..., 2:] - src[..., :2]).repeat(1, 1, 2)
    wh = shapes[:, None, [1, 0]] - 1
    size = torch.minimum(8.0 * (900.0 / 8.0) ** u(2), wh)
    xy = u(2) * (wh - size)
    even = (torch.arange(n, device=device) % 2 == 0)[None, :, None]
    boxes = clip_boxes(torch.where(even, jittered, torch.cat([xy, xy + size], dim=-1)), shapes)
    n_valid = torch.randint(n - n // 10, n + 1, (b, 1), generator=gen, device=device)
    valid = torch.arange(n, device=device)[None, :] < n_valid
    return torch.cat([boxes, u(1)], dim=-1) * valid[..., None], valid


def rcnn_serving_batches(gen: torch.Generator, proposals: bool):
    """Seeded bf16 b4 batches on the full 800 x 1216 canvas, as
    ``phase_model``'s: the arguments of ``infer``, with a proposal slate
    around seeded gts for Fast R-CNN."""
    h, w = CANVAS
    shape = torch.tensor([[h, w]] * BATCH, dtype=torch.float32, device="cuda")
    batches = []
    for _ in range(WARMUP_BATCHES + TIMED_BATCHES):
        args = [torch.randn((BATCH, h, w, 3), generator=gen, device="cuda", dtype=torch.bfloat16),
                shape, torch.ones(BATCH, device="cuda")]
        if proposals:
            boxes, _, valid = seeded_gts(gen, shape)
            args += proposal_slate(gen, boxes, valid, shape)
        batches.append(args)
    return batches


def phase_rcnn_serving(card: str, path: str, config: Path, segm: bool, k1: int, seed: int,
                       check, breakdown) -> dict:
    """Full-width serving of ``config``'s detector, b4 800x1216 bf16 through
    ``make_inference_fn``: 2 warm-up and 10 timed batches, K1 launched
    ``k1`` times a batch and K2 and the matcher never, each batch's results
    held to ``check(res, det_cfg)``, then ``breakdown(path, model, det_cfg,
    args, card)`` on the second batch (a stage breakdown; what it returns
    joins the result) and one profiled batch. Serves Cascade (Mask), Fast
    and Sparse R-CNN."""
    model, det_cfg = load_model("bfloat16", "cuda", config)
    infer = make_inference_fn(model, det_cfg, segm=segm)
    fast = isinstance(det_cfg, FastRCNNConfig)
    batches = rcnn_serving_batches(torch.Generator(device="cuda").manual_seed(seed), fast)
    for args in batches[:WARMUP_BATCHES]:
        infer(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    timed = iter(batches[WARMUP_BATCHES:])
    ms, results = timed_batches(lambda: infer(*next(timed)), TIMED_BATCHES)
    launches = read_launches()
    log(f"{path} path: {TIMED_BATCHES} batches, launches {launches}")
    expect_launches(path, launches, k1 * TIMED_BATCHES, 0)
    for res in results:
        check(res, det_cfg)
    mean_ms = sum(ms) / len(ms)
    log(f"{path} path: ms a batch {[round(t, 3) for t in ms]}, mean {mean_ms:.3f} ms, "
        f"{BATCH / (mean_ms / 1e3):.2f} images/s, median {statistics.median(ms):.3f} ms [{card}]; "
        f"valid detections an image {results[-1].valid.sum(1).tolist()}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    extra = breakdown(path, model, det_cfg, batches[1], card) or {}
    device_profile(lambda: infer(*batches[1]), mean_ms, card)
    return dict(launches=launches, ms_per_batch=mean_ms, **extra)


def check_box_detections(res, det_cfg) -> None:
    """``check_detections`` on a b4 batch of the full canvas."""
    check_detections(res, det_cfg, BATCH, *CANVAS)


def rcnn_stage_breakdown(path: str, model, det_cfg, args, card: str, segm: bool = False,
                         repeats: int = 5) -> None:
    """A Cascade (Mask) or Fast R-CNN serving batch stage by stage, a device
    sync between stages; the median host ms of each over ``repeats``."""
    images, img_shape = args[:2]
    fast = isinstance(det_cfg, FastRCNNConfig)
    times = {}
    stage = stage_timer(times)

    def decode(rois, reg):
        return clip_boxes(delta2bbox(rois, reg.float(), det_cfg.rcnn_target_means,
                                     det_cfg.rcnn_target_stds), img_shape)

    with torch.inference_mode():
        for _ in range(repeats):
            if fast:
                feats = stage("backbone+fpn", lambda: model(images))
                boxes, valid = args[3][..., :4].float(), args[4]
                roi_feats = stage("roi_align K1", lambda: roi_features(det_cfg, feats, boxes))
                cls, reg = stage("bbox_head", lambda: model.roi_forward(roi_feats))
                stage("decode + multiclass NMS", lambda: class_nms(
                    det_cfg, decode(boxes, reg), torch.softmax(cls.float(), dim=-1)[..., 1:], valid))
                continue
            feats, rpn_s, rpn_d = stage("backbone+fpn+rpn_head", lambda: model(images))
            props = stage("proposals (top-k, decode, NMS)", lambda: generate_proposals(
                det_cfg.proposal_test, det_cfg.anchor_generator, rpn_s, rpn_d, img_shape))
            boxes, probs = props.boxes, 0.0
            for t in range(det_cfg.num_stages):
                roi_feats = stage(f"stage {t} roi_align K1",
                                  lambda: roi_features(det_cfg, feats, boxes))
                cls, reg = stage(f"stage {t} bbox_head", lambda: model.roi_forward(roi_feats, t))
                probs = probs + torch.softmax(cls.float(), dim=-1)
                boxes = stage(f"stage {t} decode",
                              lambda: refine(det_cfg, t, boxes, reg, img_shape))
            dets = stage("scores + multiclass NMS", lambda: class_nms(
                det_cfg, boxes, (probs / det_cfg.num_stages)[..., 1:], props.valid))
            if segm:
                mask_feats = stage("mask roi_align K1 out 14", lambda: roi_features(
                    det_cfg, feats, dets.boxes, det_cfg.mask_roi_size))
                for t in range(det_cfg.num_stages):
                    stage(f"mask head {t}, class select, sigmoid", lambda: torch.sigmoid(
                        select_class(model.mask_forward(mask_feats, t), dets.labels).float()))
    log_breakdown(f"{path} stage breakdown, median of {repeats} batches", times, card)


def fast_train_batch(gen: torch.Generator) -> dict:
    """``train_batch`` with a proposal slate of 1000 an image around its
    gts (``proposal_slate``)."""
    batch = train_batch(gen)
    batch["proposals"], batch["proposal_valid"] = proposal_slate(
        gen, batch["gt_boxes"], batch["gt_valid"], batch["img_shape"])
    return batch


def phase_rcnn_train(card: str, path: str, config: Path, make_batch, k: int, seed: int) -> dict:
    """Full-width training of ``config``'s detector, float32 parameters and
    bf16 compute, b4 on the 800 x 1216 canvas, through the entry points a
    user calls: 2 warm-up and 10 timed steps, K1 and K2 each launched ``k``
    times a step, every loss finite, roi positives in every step, no step
    skipped, every trainable parameter moved and no frozen one; one profiled
    step."""
    cfg = Config.fromfile(config)
    steps = WARMUP_BATCHES + TIMED_BATCHES
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = [make_batch(gen) for _ in range(steps)]
    model, det_cfg, _, optimizer = build_train_objects(cfg, "cuda", seed=SEED,
                                                       loader=Batches(batches))
    loss_fn = build_loss_fn(model, det_cfg, rng_seed=SEED)
    Trainer(loss_fn, model, optimizer, Batches(batches[:WARMUP_BATCHES]), log_interval=1).run(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(loss_fn, model, optimizer, Batches(batches[WARMUP_BATCHES:]), log_interval=1)
    reset_launches()
    t0 = time.perf_counter()
    history = trainer.run(1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    log(f"{path} path: {TIMED_BATCHES} steps, launches {launches}")
    expect_launches(path, launches, k * TIMED_BATCHES, k * TIMED_BATCHES)
    if len(history) != TIMED_BATCHES or trainer.skipped_steps:
        raise AssertionError(f"{len(history)} steps logged, {trainer.skipped_steps} skipped")
    keys = [key for key in history[0] if key == "loss" or key.startswith("loss_")]
    for h in history:
        if not all(math.isfinite(h[key]) for key in keys):
            raise AssertionError(f"non-finite loss at step {h['step']}: {h}")
        if not (h["num_pos_rois"] > 0 and all(h[key] > 0 for key in keys if key.endswith("_mask"))):
            raise AssertionError(f"no positive roi or no mask loss at step {h['step']}: {h}")
    still = [n for n, p in model.named_parameters() if p.requires_grad and torch.equal(p, before[n])]
    moved = [n for n, p in model.named_parameters() if not p.requires_grad and not torch.equal(p, before[n])]
    if still or moved:
        raise AssertionError(f"trainable parameters that did not move {still}; frozen ones that "
                             f"moved {moved}")
    step_ms = [BATCH / h["images_per_sec"] * 1e3 for h in history]
    mean_ms = seconds / TIMED_BATCHES * 1e3
    log(f"{path} path: ms a step {[round(t, 3) for t in step_ms]}, mean {mean_ms:.3f} ms, "
        f"{BATCH / (mean_ms / 1e3):.2f} images/s, median {statistics.median(step_ms):.3f} ms [{card}]; "
        f"skipped steps {trainer.skipped_steps}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses first "
        + ", ".join(f"{key} {history[0][key]:.4f}" for key in keys)
        + "; last " + ", ".join(f"{key} {history[-1][key]:.4f}" for key in keys)
        + f"; positive rois a step (last stage) {[int(h['num_pos_rois']) for h in history]}")
    device_profile(lambda: trainer.train_step(dict(batches[-1])), mean_ms, card, "step")
    return dict(launches=launches, ms_per_step=mean_ms, model=model, det_cfg=det_cfg,
                batch=batches[-1])


def pile_up(slate) -> str:
    """How a slate's positives pile onto the gts: positives, distinct gts
    hit and the most positives on one gt, an image."""
    pos, parts = slate.is_pos, []
    for i in range(pos.shape[0]):
        hits = slate.matched[i][pos[i]]
        top = int(torch.bincount(hits).max()) if hits.numel() else 0
        parts.append(f"{int(pos[i].sum())} on {len(set(hits.tolist()))} gts (at most {top})")
    return "; ".join(parts)


def phase_cascade_stage3(model, det_cfg, batch, mask: bool) -> dict:
    """K2 against its plain version on a training step's last-stage slate:
    Cascade R-CNN's box slate at out 7, or Cascade Mask R-CNN's mask slate
    (the positives-first prefix of 128 an image) at out 14, the step's own
    FPN levels and the last head's cotangent scaled by a power of two to a
    largest value in [1, 2); timed against its bound. Logs how each stage's
    positives pile onto the gts."""
    noise = functools.partial(sampling_noise, torch.Generator(device="cuda").manual_seed(SEED + 30))
    _, feats, slates = _cascade_rcnn_loss_core(det_cfg, model, batch, noise)
    for t, slate in enumerate(slates):
        log(f"cascade{' mask' if mask else ''} step, stage {t} slate: positives an image "
            f"{pile_up(slate)}")
    last, t = slates[-1], det_cfg.num_stages - 1
    if mask:
        num = int(det_cfg.rcnn_num_samples * det_cfg.rcnn_pos_fraction)
        rois, m = last.rois[:, :num], det_cfg.mask_roi_size
        targets = mask_targets_for_rois(batch["gt_masks"], rois, last.matched[:, :num],
                                        det_cfg.mask_size)
        roi_feats = roi_features(det_cfg, feats, rois, m)
        loss = mask_loss(model.mask_forward(roi_feats, t), targets, last.labels[:, :num],
                         last.is_pos[:, :num])
    else:
        rois, m = last.rois, det_cfg.roi_size
        roi_feats = roi_features(det_cfg, feats, rois)
        loss = sum(rcnn_losses(det_cfg, *model.roi_forward(roi_feats, t), last))
    (cotangent,) = torch.autograd.grad(loss, roi_feats)
    top = float(cotangent.abs().max())
    if not top > 0:
        raise AssertionError("the stage-3 slate's cotangent is all zero")
    cotangent = cotangent * 2.0 ** -math.floor(math.log2(top))  # K2 is linear in it
    maps = [f.detach() for f in feats[: len(det_cfg.roi_strides)]]
    routed = roi_align.map_rois_to_levels(rois, len(maps))
    n = rois.shape[1]
    args = (cotangent, rois, routed, [tuple(f.shape[1:3]) for f in maps], det_cfg.roi_strides, m)
    name = (f"roi_align_bwd on a cascade{' mask' if mask else ''} step's stage-3 "
            f"{'mask ' if mask else ''}slate ({n} rois an image) and scaled cotangent, out {m}")
    check_deterministic(name, roi_align.multilevel_roi_align_backward_cuda, args)
    flops = 2 * 4 * BATCH * n * (m * RATIO) ** 2 * CHANNELS
    small = rois.numel() * 4 + routed.numel() * 4
    return kernel_at(name, roi_align.multilevel_roi_align_backward_cuda,
                     roi_align.multilevel_roi_align_backward, args,
                     lambda nm, g, w: check_grads(nm, g, w, cotangent.dtype),
                     BATCH * n * m * m * CHANNELS * cotangent.element_size() + small,
                     sum(f.numel() for f in maps) * cotangent.element_size(), flops)


def phase_cascade_reference() -> None:
    """Cascade Mask R-CNN serving in float32 on the GPU and on the CPU,
    stage by stage on a small canvas; each GPU stage's output feeds the CPU
    counterpart of the next stage, NMS gets equal inputs on both devices."""
    gpu, det_cfg = load_model("float32", "cuda", CASCADE_MASK_CONFIG)
    cpu, _ = load_model("float32", "cpu", CASCADE_MASK_CONFIG)
    gen = torch.Generator().manual_seed(SEED + 31)
    x = torch.randn((2, 256, 320, 3), generator=gen)
    shapes = torch.tensor([[256.0, 320.0], [240.0, 300.0]])
    checks = []

    def check(name, err, limit):
        checks.append(f"{name} {err:.2e} (limit {limit:g})")
        if not err <= limit:
            raise AssertionError(f"cascade reference check {name}: {err} > {limit}")

    with torch.inference_mode():
        fg, sg, dg = gpu(x.cuda())
        fc, _, _ = cpu(x)
        # cuDNN and the CPU pick other convolution algorithms and sum orders
        check("fpn levels", max(rel_err(g, c) for g, c in zip(fg, fc)), 1e-3)
        props = generate_proposals(det_cfg.proposal_test, det_cfg.anchor_generator, sg, dg,
                                   shapes.cuda())
        fcpu = [f.cpu() for f in fg]
        boxes, probs_g, probs_c = props.boxes, 0.0, 0.0
        for t in range(det_cfg.num_stages):
            rg = roi_features(det_cfg, fg, boxes)
            rc = roi_features(det_cfg, fcpu, boxes.cpu())
            check(f"stage {t} roi features (K1 vs plain on the CPU)", rel_err(rg, rc), 1e-5)
            (cg, regg), (cc, regc) = gpu.roi_forward(rg, t), cpu.roi_forward(rg.cpu(), t)
            check(f"stage {t} head", max(rel_err(cg, cc), rel_err(regg, regc)), 1e-4)
            probs_g = probs_g + torch.softmax(cg, dim=-1)
            probs_c = probs_c + torch.softmax(cg.cpu(), dim=-1)
            refined = refine(det_cfg, t, boxes, regg, shapes.cuda())
            check(f"stage {t} refined boxes",
                  rel_err(refined, refine(det_cfg, t, boxes.cpu(), regg.cpu(), shapes)), 1e-5)
            boxes = refined
        check("averaged scores", rel_err(probs_g, probs_c), 1e-6)
        probs = (probs_g / det_cfg.num_stages)[..., 1:]
        ng = class_nms(det_cfg, boxes, probs, props.valid)
        nc = class_nms(det_cfg, boxes.cpu(), probs.cpu(), props.valid.cpu())
        for field in ("valid", "labels", "indices"):
            check(f"multiclass_nms {field} mismatches",
                  float((getattr(ng, field).cpu() != getattr(nc, field)).sum()), 0)
        check("multiclass_nms scores", rel_err(ng.scores, nc.scores), 0)
        m = det_cfg.mask_roi_size
        mg = roi_features(det_cfg, fg, ng.boxes, m)
        check("mask roi features (K1 out 14 vs plain on the CPU)",
              rel_err(mg, roi_features(det_cfg, fcpu, ng.boxes.cpu(), m)), 1e-5)
        pg, pc = 0.0, 0.0
        for t in range(det_cfg.num_stages):
            lg, lc = gpu.mask_forward(mg, t), cpu.mask_forward(mg.cpu(), t)
            check(f"mask head {t} logits", rel_err(lg, lc), 1e-4)
            pg = pg + torch.sigmoid(select_class(lg, ng.labels))
            pc = pc + torch.sigmoid(select_class(lg.cpu(), ng.labels.cpu()))
        check("averaged mask probabilities", rel_err(pg, pc), 1e-6)
    log(f"cascade reference check, GPU vs CPU float32 ({int(ng.valid.sum())} detections): "
        + "; ".join(checks))


def phase_cascade_train_reference() -> None:
    """Cascade R-CNN training in float32 on the GPU and on the CPU, stage by
    stage on a small canvas with the same sampling draws: each stage's
    sampled slate on the same candidates, its losses, its gradients into the
    FPN levels (K2 against the plain backward on the CPU) and the next
    stage's candidates; each GPU stage's output feeds the CPU's next."""
    cfg = Config.fromfile(CASCADE_CONFIG)
    det_cfg = build_detection_cfg(cfg.detection)
    gpu = build_detector(cfg.model, "float32", "cuda", seed=SEED).train()
    cpu = build_detector(cfg.model, "float32", "cpu", seed=SEED).train()
    gen = torch.Generator().manual_seed(SEED + 32)
    x = torch.randn((2, 256, 320, 3), generator=gen)
    gt = (torch.tensor([[[16, 20, 120, 140], [150, 40, 300, 230], [60, 150, 110, 250], [0] * 4],
                        [[30, 30, 200, 180], [210, 100, 290, 200], [0] * 4, [0] * 4]],
                       dtype=torch.float32),
          torch.tensor([[3, 17, 80, 0], [1, 45, 0, 0]]),
          torch.tensor([[True, True, True, False], [True, True, False, False]]))
    gt_gpu = tuple(g.cuda() for g in gt)
    shapes = torch.tensor([[256.0, 320.0], [240.0, 300.0]])
    noise_gpu, noise_cpu = same_noise(SEED + 33, "cuda"), same_noise(SEED + 33, "cpu")
    checks = []

    def check(name, err, limit):
        checks.append(f"{name} {err:.2e} (limit {limit:g})")
        if not err <= limit:
            raise AssertionError(f"cascade training reference check {name}: {err} > {limit}")

    fg, sg, dg = gpu(x.cuda())
    props = generate_proposals(det_cfg.proposal_train, det_cfg.anchor_generator,
                               [s.detach() for s in sg], [d.detach() for d in dg], shapes.cuda())
    lg = [f.detach().requires_grad_() for f in fg[: len(det_cfg.roi_strides)]]
    lc = [f.detach().cpu().requires_grad_() for f in lg]
    boxes, valid = props.boxes, props.valid
    for t in range(det_cfg.num_stages):
        kw = dict(assigner=det_cfg.stage_assigner(t), target_stds=det_cfg.stage_target_stds[t])
        sgpu = sample_rois(det_cfg, boxes, valid, *gt_gpu, noise_gpu, **kw)
        scpu = sample_rois(det_cfg, boxes.cpu(), valid.cpu(), *gt, noise_cpu, **kw)
        for field in ("rois", "labels", "is_pos", "is_valid", "matched", "from_gt"):
            check(f"stage {t} sampled {field} mismatches",
                  float((getattr(sgpu, field).cpu() != getattr(scpu, field)).sum()), 0)
        check(f"stage {t} regression targets", rel_err(sgpu.reg_targets, scpu.reg_targets), 1e-5)
        if not bool(sgpu.is_pos.any()):
            raise AssertionError(f"no positive roi at stage {t} of the reference batch")
        cls, reg = gpu.roi_forward(roi_features(det_cfg, lg, sgpu.rois), t)
        loss_g = rcnn_losses(det_cfg, cls, reg, sgpu)
        loss_c = rcnn_losses(det_cfg, *cpu.roi_forward(roi_features(det_cfg, lc, scpu.rois), t),
                             scpu)
        check(f"stage {t} losses", rel_err(torch.stack(loss_g), torch.stack(loss_c)), 1e-3)
        grads_g = torch.autograd.grad(sum(loss_g), lg)
        grads_c = torch.autograd.grad(sum(loss_c), lc)
        check(f"stage {t} gradients into the fpn levels (K2 vs plain on the CPU)",
              max(rel_err(g, c) for g, c in zip(grads_g, grads_c)), 1e-3)
        nxt = next_candidates(det_cfg, t, sgpu, reg, shapes.cuda())
        nxt_c = next_candidates(det_cfg, t, type(sgpu)(*(f.cpu() for f in sgpu)), reg.cpu(), shapes)
        check(f"stage {t} next candidates", rel_err(nxt[0], nxt_c[0]), 1e-5)
        check(f"stage {t} next validity mismatches", float((nxt[1].cpu() != nxt_c[1]).sum()), 0)
        boxes, valid = nxt[0].detach(), nxt[1]
    log("cascade training reference check, GPU vs CPU float32: " + "; ".join(checks))


def phase_fast_reference() -> None:
    """Fast R-CNN serving in float32 on the GPU and on the CPU on a small
    canvas and a seeded proposal slate: roi features, head, decoded boxes,
    and NMS on equal inputs."""
    gpu, det_cfg = load_model("float32", "cuda", FAST_CONFIG)
    cpu, _ = load_model("float32", "cpu", FAST_CONFIG)
    gen = torch.Generator().manual_seed(SEED + 34)
    x = torch.randn((2, 256, 320, 3), generator=gen)
    shapes = torch.tensor([[256.0, 320.0], [240.0, 300.0]], device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 35)
    gt_boxes, _, gt_valid = seeded_gts(g, shapes)
    props, valid = proposal_slate(g, gt_boxes, gt_valid, shapes, n=300)
    rois = props[..., :4]
    checks = []

    def check(name, err, limit):
        checks.append(f"{name} {err:.2e} (limit {limit:g})")
        if not err <= limit:
            raise AssertionError(f"fast reference check {name}: {err} > {limit}")

    with torch.inference_mode():
        fg, fc = gpu(x.cuda()), cpu(x)
        check("fpn levels", max(rel_err(a, b) for a, b in zip(fg, fc)), 1e-3)
        rg = roi_features(det_cfg, fg, rois)
        check("roi features (K1 vs plain on the CPU)",
              rel_err(rg, roi_features(det_cfg, [f.cpu() for f in fg], rois.cpu())), 1e-5)
        (cg, regg), (cc, regc) = gpu.roi_forward(rg), cpu.roi_forward(rg.cpu())
        check("bbox head", max(rel_err(cg, cc), rel_err(regg, regc)), 1e-4)
        means, stds = det_cfg.rcnn_target_means, det_cfg.rcnn_target_stds
        bg = clip_boxes(delta2bbox(rois, regg, means, stds), shapes)
        check("decoded boxes",
              rel_err(bg, clip_boxes(delta2bbox(rois.cpu(), regg.cpu(), means, stds), shapes.cpu())),
              1e-5)
        probs = torch.softmax(cg, dim=-1)[..., 1:]
        ng = class_nms(det_cfg, bg, probs, valid)
        nc = class_nms(det_cfg, bg.cpu(), probs.cpu(), valid.cpu())
        for field in ("valid", "labels", "indices"):
            check(f"multiclass_nms {field} mismatches",
                  float((getattr(ng, field).cpu() != getattr(nc, field)).sum()), 0)
        check("multiclass_nms scores", rel_err(ng.scores, nc.scores), 0)
    log(f"fast reference check, GPU vs CPU float32 ({int(valid.sum())} valid proposals, "
        f"{int(ng.valid.sum())} detections): " + "; ".join(checks))


def matcher_inputs(gen: torch.Generator, kind: str, problems: int = 48, rows: int = MAX_GTS,
                   cols: int = 100):
    """Seeded (problems, rows, cols) float32 costs and (problems, rows) row
    validity for ``phase_hungarian``: ``step`` normal costs with 1-20 valid
    rows, ``full`` every row valid, ``ties`` integer costs 0-3 with 1-100
    valid rows, ``nonfinite`` normal costs with NaN and +-inf entries and
    rows made of them."""
    device = torch.device("cuda")
    shape = (problems, rows, cols)
    if kind == "ties":
        cost = torch.randint(0, 4, shape, generator=gen, device=device).float()
    else:
        cost = torch.randn(shape, generator=gen, device=device) * 3.0
    top = {"step": 21, "full": rows + 1, "ties": rows + 1, "nonfinite": 21}[kind]
    low = rows if kind == "full" else 1
    num = torch.randint(low, top, (problems, 1), generator=gen, device=device)
    valid = torch.arange(rows, device=device)[None, :] < num
    if kind == "nonfinite":
        u = torch.rand(shape, generator=gen, device=device)
        cost = torch.where(u < 0.02, float("nan"), cost)
        cost = torch.where((u >= 0.02) & (u < 0.04), float("inf"), cost)
        cost = torch.where((u >= 0.04) & (u < 0.05), float("-inf"), cost)
        cost[:, 1] = float("nan")  # a row of NaN, one of +inf, one of -inf
        cost[:, 2] = float("inf")
        cost[:, 3, : cols // 2] = float("-inf")
    return cost, valid


def scipy_totals(cost: torch.Tensor, valid: torch.Tensor, col4row: torch.Tensor):
    """Per problem, the total of ``col4row`` and scipy's optimal total on the
    valid rows (float64 sums of the float32 costs), and scipy's host ms for
    all the problems."""
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    cost, valid, col4row = cost.cpu().numpy(), valid.cpu().numpy(), col4row.cpu().numpy()
    ours, theirs, seconds = [], [], 0.0
    for c, v, cols in zip(cost, valid, col4row):
        sub = c[v].astype(np.float64)
        t0 = time.perf_counter()
        r, k = scipy_lsa(sub)
        seconds += time.perf_counter() - t0
        ours.append(sub[np.arange(len(sub)), cols[v]].sum())
        theirs.append(sub[r, k].sum())
    return np.array(ours), np.array(theirs), seconds * 1e3


def hungarian_at(name: str, cost: torch.Tensor, valid: torch.Tensor, time_plain: bool,
                 finite: bool = True) -> dict:
    """The matcher kernel against its plain version on the same (P, G, Q)
    costs (the plain version on the CPU copy, the same float32 adds and
    compares): ``col4row`` bit for bit; on finite costs each problem's total
    equal to scipy's optimum. The kernel's time, the plain version's on the
    card where ``time_plain``, scipy's host time for context, and the bound:
    the costs read once over the HBM rate, against the operations the data
    needs (5 a column a Dijkstra step, counted by the plain version)."""
    kernel = hungarian.batched_linear_sum_assignment_cuda
    plain = hungarian.linear_sum_assignment_plain
    got = kernel(cost, valid)
    torch.cuda.synchronize()
    steps0 = plain.dijkstra_steps
    want = plain(cost.cpu(), valid.cpu())
    steps = plain.dijkstra_steps - steps0
    bad = int((got.cpu() != want).any(dim=1).sum())
    if bad:
        raise AssertionError(f"{name}: col4row differs from the plain version in {bad} problems")
    col_err = float((got.cpu() - want).abs().max()) if want.numel() else 0.0
    rows = int(valid.sum())
    err = 0.0
    scipy_ms = None
    if finite:
        ours, theirs, scipy_ms = scipy_totals(cost, valid, got)
        err = float(np.abs(ours - theirs).max())
        limit = 1e-4 * max(1.0, float(np.abs(theirs).max()))
        if not err <= limit:
            raise AssertionError(f"{name}: totals differ from scipy's by {err} (limit {limit})")
    ms = cuda_ms(lambda: kernel(cost, valid), iters=20)
    plain_ms = cuda_ms(lambda: plain(cost, valid), iters=1, warmup=0) if time_plain else None
    p, g, q = cost.shape
    flops = 5 * q * steps + 3 * (g + q) * rows
    result = dict(max_abs_err=col_err, ms=ms, plain_ms=plain_ms,
                  **bound(name, cost.numel() * 4 + valid.numel(), got.numel() * 4, flops),
                  valid_rows=rows, dijkstra_steps=steps, scipy_host_ms=scipy_ms)
    log(f"{name}: {p} problems of {g} x {q}, {rows} valid rows, {steps} Dijkstra steps; col4row "
        f"equal to the plain version's in every problem"
        + (f", totals within {err:.2e} of scipy's" if finite else "")
        + f"; kernel {ms:.4f} ms, plain "
        + (f"{plain_ms:.1f} ms" if plain_ms is not None else "not timed")
        + (f", scipy on the host {scipy_ms:.2f} ms (context, not a yardstick)" if finite else "")
        + ", library_ms none")
    return result


def phase_hungarian() -> dict:
    """The matcher kernel against its plain version: a training step's shape
    (48 problems of 100 x 100, 1-20 valid gts), the full slate (100 valid
    gts, its worst case), integer costs full of ties, and NaN and +-inf
    entries and rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 45)
    out = {}
    for kind in ("step", "full", "ties", "nonfinite"):
        cost, valid = matcher_inputs(gen, kind)
        out[kind] = hungarian_at(f"hungarian, {kind} costs", cost, valid, time_plain=kind == "step",
                                 finite=kind != "nonfinite")
    # without row_valid every row is matched, the NaN and inf rows too
    got = hungarian.batched_linear_sum_assignment_cuda(cost)
    if not torch.equal(got.cpu(), hungarian.linear_sum_assignment_plain(cost.cpu())):
        raise AssertionError("hungarian without row_valid differs from the plain version")
    log("hungarian, nonfinite costs without row_valid: col4row equal to the plain version's")
    return out


def check_sparse_detections(res, det_cfg) -> None:
    """``check_detections``' checks, and at ``score_thr`` 0 every slot
    valid with a query id among the proposals."""
    h, w = CANVAS
    check_detections(res, det_cfg, BATCH, h, w)
    if not bool(res.valid.all()):
        raise AssertionError("an invalid detection at score_thr 0")
    if not bool(((res.indices >= 0) & (res.indices < det_cfg.num_proposals)).all()):
        raise AssertionError("a query id outside the proposals")


def sparse_stage_breakdown(path: str, model, det_cfg, args, card: str, repeats: int = 5) -> None:
    """A Sparse R-CNN serving batch stage by stage, a device sync between
    stages: the backbone and FPN, then for each stage K1, the attention, the
    dynamic conv, the FFN and heads and the box decode, then the top-k
    decode; the median host ms of each over ``repeats``. Returns the last
    repeat's levels and each stage's input boxes."""
    images, img_shape = args[:2]
    times = {}
    stage = stage_timer(times)
    with torch.inference_mode():
        for _ in range(repeats):
            feats = stage("backbone+fpn", lambda: model.features(images))
            boxes, obj = stage("initial slate", lambda: model.initial_slate(feats, img_shape))
            slates = []
            for t in range(model.num_stages):
                slates.append(boxes)
                head = model.get_submodule(f"stage{t}")
                roi = stage(f"stage {t} roi_align K1", lambda: model.roi_features(feats, boxes))
                with model._autocast(roi):
                    obj = stage(f"stage {t} attention", lambda: head.attention(obj))
                    obj = stage(f"stage {t} dynamic conv", lambda: head.interaction(roi, obj))
                    obj, cls, deltas = stage(f"stage {t} ffn and heads",
                                             lambda: head.ffn_and_heads(obj))
                boxes = stage(f"stage {t} box decode", lambda: model.refine(boxes, deltas))
            stage("top-k decode", lambda: decode_sparse_rcnn(det_cfg, cls[None], boxes[None],
                                                             img_shape, args[2]))
    log_breakdown(f"{path} stage breakdown, median of {repeats} batches", times, card)
    return feats, slates


def sparse_rois(what: str, model, boxes: torch.Tensor):
    """A Sparse R-CNN stage's continuous xyxy ``boxes`` (B, N, 4) as the
    inclusive rois ``roi_features`` gives the kernels, and their routed
    levels; logs how many land on each level."""
    rois = torch.cat([boxes[..., :2], boxes[..., 2:] - 1.0], dim=-1).detach().contiguous()
    routed = roi_align.map_rois_to_levels(rois, len(model.roi_strides), model.finest_scale)
    log(f"{what}: the batch's {routed.numel()} rois on P2-P5 "
        f"{[int((routed == l).sum()) for l in range(len(model.roi_strides))]}")
    return rois, routed


def sparse_k1_at(what: str, model, maps, rois: torch.Tensor, routed: torch.Tensor) -> dict:
    """K1 against its plain version on a Sparse R-CNN stage's rois and
    routed levels (``sparse_rois``) and the levels ``maps`` (bf16 within
    one ulp, float32 within F32_ATOL), timed against its bound."""
    b, n = rois.shape[:2]
    m = model.roi_size
    check = check_bf16 if maps[0].dtype == torch.bfloat16 else check_f32
    return kernel_at(f"roi_align_fwd on {what} ({n} rois an image), out {m}",
                     roi_align.multilevel_roi_align_cuda, roi_align.multilevel_roi_align,
                     (maps, rois, routed, model.roi_strides, m), check,
                     touched_bytes(maps, rois, m) + rois.numel() * 4 + routed.numel() * 4,
                     b * n * m * m * CHANNELS * maps[0].element_size(),
                     2 * 4 * b * n * (m * RATIO) ** 2 * CHANNELS)


def sparse_serving_breakdown(path: str, model, det_cfg, args, card: str) -> dict:
    """``sparse_stage_breakdown``, then K1 against its plain version on the
    batch's own bf16 levels and its stage-0 slate (every roi the whole
    image, so all on P5) and last-stage slate."""
    feats, slates = sparse_stage_breakdown(path, model, det_cfg, args, card)
    maps = list(feats[: len(model.roi_strides)])
    out = {}
    with torch.inference_mode():
        for t in (0, model.num_stages - 1):
            what = f"a sparse serving batch's stage-{t} slate"
            out[f"k1_stage{t}"] = sparse_k1_at(what, model, maps,
                                               *sparse_rois(what, model, slates[t]))
    return out


def sparse_train_forward(model, det_cfg, batch):
    """A Sparse R-CNN training forward stage by stage, as the model's:
    the FPN levels, each stage's input boxes and roi features (which keep
    their gradient), the stacked logits and boxes, and the losses."""
    shapes = batch["img_shape"]
    feats = model.features(batch["image"])
    boxes, obj = model.initial_slate(feats, shapes)
    slates, roi_feats, logits, outs = [], [], [], []
    for t in range(model.num_stages):
        if t:
            boxes = boxes.detach()
        roi = model.roi_features(feats, boxes)
        roi.retain_grad()
        obj, cls, deltas = model.stage_forward(t, roi, obj)
        slates.append(boxes.detach())
        roi_feats.append(roi)
        boxes = model.refine(boxes, deltas)
        logits.append(cls)
        outs.append(boxes)
    cls, boxes = torch.stack(logits), torch.stack(outs)
    gt_xyxy, whwh = set_targets(batch["gt_boxes"], batch["gt_valid"], shapes)
    cost = matching_cost(det_cfg, cls, boxes, gt_xyxy, batch["gt_labels"], whwh)
    col4row = match(cost, batch["gt_valid"])
    losses = set_losses(det_cfg, cls, boxes, gt_xyxy, batch["gt_labels"], batch["gt_valid"], whwh,
                        col4row)
    return feats, slates, roi_feats, cost, losses


def phase_sparse_train(card: str) -> dict:
    """Full-width Sparse R-CNN R50-FPN training, float32 parameters and bf16
    compute, b8 on the 800 x 1216 canvas, AdamW, through the entry points a
    user calls: 2 warm-up and 10 timed steps, K1 and K2 six times a step and
    the matcher once, finite losses, no step skipped, every parameter group
    moved (the proposal boxes among them) and no frozen parameter; one
    profiled step."""
    cfg = Config.fromfile(SPARSE_CONFIG)
    steps = WARMUP_BATCHES + TIMED_BATCHES
    gen = torch.Generator(device="cuda").manual_seed(SEED + 46)
    batches = [train_batch(gen, SPARSE_TRAIN_BATCH) for _ in range(steps)]
    model, det_cfg, _, optimizer = build_train_objects(cfg, "cuda", seed=SEED,
                                                       loader=Batches(batches))
    if not isinstance(optimizer.torch_optimizer, torch.optim.AdamW):
        raise AssertionError(f"the config's optimizer built {type(optimizer.torch_optimizer)}")
    loss_fn = build_loss_fn(model, det_cfg, rng_seed=SEED)
    Trainer(loss_fn, model, optimizer, Batches(batches[:WARMUP_BATCHES]), log_interval=1).run(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(loss_fn, model, optimizer, Batches(batches[WARMUP_BATCHES:]), log_interval=1)
    reset_launches()
    t0 = time.perf_counter()
    history = trainer.run(1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    log(f"sparse training path: {TIMED_BATCHES} steps, launches {launches}")
    s = model.num_stages
    expect_launches("sparse training", launches, s * TIMED_BATCHES, s * TIMED_BATCHES,
                    TIMED_BATCHES)
    if len(history) != TIMED_BATCHES or trainer.skipped_steps:
        raise AssertionError(f"{len(history)} steps logged, {trainer.skipped_steps} skipped")
    keys = ("loss", "loss_cls", "loss_l1", "loss_giou")
    for h in history:
        if not all(math.isfinite(h[k]) for k in keys) or not h["num_pos"] > 0:
            raise AssertionError(f"non-finite loss or no gt at step {h['step']}: {h}")
    moved = {n for n, p in model.named_parameters() if not torch.equal(p, before[n])}
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    groups = sorted({n.split(".")[0] for n in trainable})
    still_groups = [g for g in groups if not any(n.split(".")[0] == g for n in moved)]
    frozen_moved = [n for n, p in model.named_parameters() if not p.requires_grad and n in moved]
    still = [n for n in trainable if n not in moved]
    log(f"sparse training path: {len(moved)} of {len(trainable)} trainable parameter tensors moved "
        f"in the groups {groups}; those that did not: {still}")
    if still_groups or frozen_moved or "proposal_boxes" not in moved:
        raise AssertionError(f"groups that did not move {still_groups}; frozen parameters that "
                             f"moved {frozen_moved}")
    b = SPARSE_TRAIN_BATCH
    step_ms = [b / h["images_per_sec"] * 1e3 for h in history]
    mean_ms = seconds / TIMED_BATCHES * 1e3
    log(f"sparse training path b{b}: ms a step {[round(t, 3) for t in step_ms]}, mean "
        f"{mean_ms:.3f} ms, {b / (mean_ms / 1e3):.2f} images/s, median "
        f"{statistics.median(step_ms):.3f} ms [{card}]; skipped steps {trainer.skipped_steps}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses first "
        + ", ".join(f"{k} {history[0][k]:.4f}" for k in keys)
        + "; last " + ", ".join(f"{k} {history[-1][k]:.4f}" for k in keys)
        + f"; gts an image {history[0]['num_pos']:.2f}")
    device_profile(lambda: trainer.train_step(dict(batches[-1])), mean_ms, card, "step")
    return dict(launches=launches, ms_per_step=mean_ms, model=model, det_cfg=det_cfg,
                batch=batches[-1])


def phase_sparse_step_data(model, det_cfg, batch) -> dict:
    """K1 and K2 against their plain versions on a training step's own
    stage-0 slate (every roi the whole image, so all on P5) and its stage-5
    slate, on the step's bf16 levels; K2 with each stage's
    cotangent scaled by a power of two to a largest value in [1, 2), bitwise
    equal twice; and the matcher kernel against its plain version on the
    step's own (48, 100, 100) costs. Each timed against its bound."""
    feats, slates, roi_feats, cost, losses = sparse_train_forward(model, det_cfg, batch)
    losses["loss"].backward()
    maps = [f.detach() for f in feats[: len(model.roi_strides)]]
    shapes = [tuple(f.shape[1:3]) for f in maps]
    out = {}
    for t in (0, model.num_stages - 1):
        cotangent = roi_feats[t].grad
        top = float(cotangent.abs().max())
        if not top > 0:
            raise AssertionError(f"the stage-{t} slate's cotangent is all zero")
        cotangent = cotangent * 2.0 ** -math.floor(math.log2(top))  # K2 is linear in it
        what = f"a sparse training step's stage-{t} slate"
        rois, routed = sparse_rois(what, model, slates[t])
        out[f"k1_stage{t}"] = sparse_k1_at(what, model, maps, rois, routed)
        n = rois.shape[1]
        args = (cotangent, rois, routed, shapes, model.roi_strides, model.roi_size)
        name = (f"roi_align_bwd on a sparse step's stage-{t} slate ({n} rois an image) and scaled "
                f"cotangent, out {model.roi_size}")
        check_deterministic(name, roi_align.multilevel_roi_align_backward_cuda, args)
        flops = 2 * 4 * rois.shape[0] * n * (model.roi_size * RATIO) ** 2 * CHANNELS
        small = rois.numel() * 4 + routed.numel() * 4
        out[f"k2_stage{t}"] = kernel_at(
            name, roi_align.multilevel_roi_align_backward_cuda,
            roi_align.multilevel_roi_align_backward, args,
            lambda nm, g, w: check_grads(nm, g, w, cotangent.dtype),
            cotangent.numel() * cotangent.element_size() + small,
            sum(f.numel() for f in maps) * cotangent.element_size(), flops)
    s, b, g, q = cost.shape
    valid = batch["gt_valid"][None].expand(s, b, g).reshape(s * b, g)
    out["matcher"] = hungarian_at("hungarian on a sparse training step's own costs",
                                  cost.reshape(s * b, g, q), valid, time_plain=True)
    return out


def phase_sparse_reference() -> None:
    """Sparse R-CNN in float32 on the GPU and on the CPU on a small canvas.
    Serving, stage by stage on equal inputs (each GPU stage's output feeds
    the CPU counterpart of the next): roi features (K1 against the plain
    version on the CPU), the head's outputs, the refined boxes, the top-k
    decode. Training, each device its own chain from the same FPN levels
    and the same matching (the kernel's, itself held to the plain version
    on the GPU's costs, and from stage 1 on the GPU's input boxes, which the
    model detaches there anyway): the losses, and the gradients into the
    levels (K2 against the plain backward) and into both proposal
    parameters. The rois are the same on both devices, so a sample that
    lies within rounding of a cell's edge cannot move its gradient to the
    neighbouring cell on one device only."""
    cfg = Config.fromfile(SPARSE_CONFIG)
    det_cfg = build_detection_cfg(cfg.detection)
    gpu = build_detector(cfg.model, "float32", "cuda", seed=SEED).train()
    cpu = build_detector(cfg.model, "float32", "cpu", seed=SEED).train()
    gen = torch.Generator().manual_seed(SEED + 47)
    x = torch.randn((2, 256, 320, 3), generator=gen)
    shapes = torch.tensor([[256.0, 320.0], [240.0, 300.0]])
    checks = []

    def check(name, err, limit):
        checks.append(f"{name} {err:.2e} (limit {limit:g})")
        if not err <= limit:
            raise AssertionError(f"sparse reference check {name}: {err} > {limit}")

    with torch.no_grad():
        fg, fc = gpu.features(x.cuda()), cpu.features(x)
        # cuDNN and the CPU pick other convolution algorithms and sum orders
        check("fpn levels", max(rel_err(g, c) for g, c in zip(fg, fc)), 1e-3)
        fcpu = [f.cpu() for f in fg]
        boxes, obj = gpu.initial_slate(fg, shapes.cuda())
        logits = []
        for t in range(gpu.num_stages):
            rg = gpu.roi_features(fg, boxes)
            check(f"stage {t} roi features (K1 vs plain on the CPU)",
                  rel_err(rg, cpu.roi_features(fcpu, boxes.cpu())), 1e-5)
            og, cg, dg = gpu.stage_forward(t, rg, obj)
            oc, cc, dc = cpu.stage_forward(t, rg.cpu(), obj.cpu())
            check(f"stage {t} head (obj, logits, deltas)",
                  max(rel_err(og, oc), rel_err(cg, cc), rel_err(dg, dc)), 1e-4)
            refined = gpu.refine(boxes, dg)
            check(f"stage {t} boxes", rel_err(refined, cpu.refine(boxes.cpu(), dg.cpu())), 1e-5)
            boxes, obj = refined, og
            logits.append(cg)
        dets_g = decode_sparse_rcnn(det_cfg, logits[-1][None], boxes[None], shapes.cuda())
        dets_c = decode_sparse_rcnn(det_cfg, logits[-1][None].cpu(), boxes[None].cpu(), shapes)
        for field in ("valid", "labels", "indices"):
            check(f"top-k decode {field} mismatches",
                  float((getattr(dets_g, field).cpu() != getattr(dets_c, field)).sum()), 0)
        # the devices' sigmoids may differ by an ulp
        check("top-k decode scores", rel_err(dets_g.scores, dets_c.scores), 1e-6)
        check("top-k decode boxes", rel_err(dets_g.boxes, dets_c.boxes), 1e-6)

    gt = dict(gt_boxes=torch.tensor([[[16, 20, 120, 140], [150, 40, 300, 230], [60, 150, 110, 250]],
                                     [[30, 30, 200, 180], [210, 100, 290, 200], [0] * 4]],
                                    dtype=torch.float32),
              gt_labels=torch.tensor([[3, 17, 80], [1, 45, 0]]),
              gt_valid=torch.tensor([[True, True, True], [True, True, False]]))
    levels_g = [f.detach().requires_grad_() for f in fg[: len(gpu.roi_strides)]]
    levels_c = [f.detach().cpu().requires_grad_() for f in levels_g]
    col4row = None
    results, inputs = [], []
    for model, levels, device in ((gpu, levels_g, "cuda"), (cpu, levels_c, "cpu")):
        batch = {k: v.to(device) for k, v in gt.items()}
        boxes, obj = model.initial_slate(levels, shapes.to(device))
        cls_all, box_all = [], []
        for t in range(model.num_stages):
            if t:
                boxes = boxes.detach() if device == "cuda" else inputs[t].cpu()
            if device == "cuda":
                inputs.append(boxes.detach())
            obj, cls, deltas = model.stage_forward(t, model.roi_features(levels, boxes), obj)
            boxes = model.refine(boxes, deltas)
            cls_all.append(cls)
            box_all.append(boxes)
        cls, box = torch.stack(cls_all), torch.stack(box_all)
        gt_xyxy, whwh = set_targets(batch["gt_boxes"], batch["gt_valid"], shapes.to(device))
        if col4row is None:
            cost = matching_cost(det_cfg, cls, box, gt_xyxy, batch["gt_labels"], whwh)
            col4row = match(cost, batch["gt_valid"])  # the kernel
            check("matching: kernel vs plain on the GPU's costs, mismatches",
                  float((match(cost.cpu(), gt["gt_valid"]) != col4row.cpu()).sum()), 0)
        losses = set_losses(det_cfg, cls, box, gt_xyxy, batch["gt_labels"], batch["gt_valid"],
                            whwh, col4row.to(device))
        grads = torch.autograd.grad(losses["loss"], [*levels, model.proposal_boxes,
                                                     model.proposal_features])
        results.append((losses, grads))
    (lg, gg), (lc, gc) = results
    check("losses", max(rel_err(lg[k], lc[k]) for k in ("loss_cls", "loss_l1", "loss_giou")), 1e-4)
    check("gradients into the fpn levels (K2 vs plain on the CPU)",
          max(rel_err(g, c) for g, c in zip(gg[:-2], gc[:-2])), 1e-3)
    check("gradients into proposal_boxes", rel_err(gg[-2], gc[-2]), 1e-3)
    check("gradients into proposal_features", rel_err(gg[-1], gc[-1]), 1e-3)
    if not (float(gg[-2].abs().sum()) > 0 and float(gg[-1].abs().sum()) > 0):
        raise AssertionError("no gradient into the proposal parameters")
    log("sparse reference check, GPU vs CPU float32: " + "; ".join(checks))


def detr_config():
    """The DETR config, its canvas and its training batch."""
    cfg = Config.fromfile(DETR_CONFIG)
    return cfg, tuple(cfg.data["canvas"]), cfg.data["sample_per_replica"]


def detr_tokens(images, img_shape) -> str:
    """The encoder's tokens an image (C5 of the canvas, stride 32) and how
    many of them the key mask keeps."""
    c5_hw = [(s + 31) // 32 for s in images.shape[1:3]]
    valid = detr_mod.valid_cells(img_shape, images.shape[0], tuple(images.shape[1:3]),
                                 tuple(c5_hw), images.device)
    return (f"{c5_hw[0]} x {c5_hw[1]} = {c5_hw[0] * c5_hw[1]} encoder tokens an image, "
            f"{[int(v) for v in valid.sum((1, 2)).tolist()]} inside the images")


def check_detr_detections(res, det_cfg, img_shape) -> None:
    """Shapes, finite values, at ``score_thr`` 0 every slot valid with a
    query id among the queries and a label among the classes, and every box
    inside its own image."""
    b = img_shape.shape[0]
    if res.boxes.shape != (b, det_cfg.max_detections, 4):
        raise AssertionError(f"boxes shape {tuple(res.boxes.shape)}")
    if not (torch.isfinite(res.boxes).all() and torch.isfinite(res.scores).all()):
        raise AssertionError("non-finite detections")
    if not bool(res.valid.all()):
        raise AssertionError("an invalid detection at score_thr 0")
    if not bool(((res.indices >= 0) & (res.indices < det_cfg.num_queries)).all()):
        raise AssertionError("a query id outside the queries")
    if not bool(((res.labels >= 0) & (res.labels < det_cfg.num_classes)).all()):
        raise AssertionError("labels out of range")
    h, w = img_shape[:, 0, None], img_shape[:, 1, None]
    bx = res.boxes
    if not (bool((bx >= 0).all()) and bool((bx[..., 0::2] <= w[..., None] - 1).all())
            and bool((bx[..., 1::2] <= h[..., None] - 1).all())):
        raise AssertionError("boxes outside their image")


def detr_stage_breakdown(model, det_cfg, args, card: str, repeats: int = 5) -> None:
    """A DETR serving batch stage by stage, a device sync between stages:
    the backbone to C5, ``input_proj`` with the encoding and the key mask,
    each encoder layer, each decoder layer with ``decoder_norm``, the heads
    and the top-k decode; the median host ms of each over ``repeats``."""
    images, img_shape, scale = args
    canvas = tuple(images.shape[1:3])
    times = {}
    stage = stage_timer(times)
    with torch.inference_mode():
        for _ in range(repeats):
            c5 = stage("backbone C5", lambda: model.features(images))
            src, pos, mask = stage("input_proj, sine encoding, key mask",
                                   lambda: model.embed(c5, canvas, img_shape))
            memory = src
            for i in range(model.num_encoder_layers):
                memory = stage(f"encoder layer {i}",
                               lambda: model.encoder_layer(i, memory, pos, mask))
            tgt, qpos = model.queries(memory)
            outs = []
            for i in range(model.num_decoder_layers):
                tgt = stage(f"decoder layer {i}",
                            lambda: model.decoder_layer(i, tgt, qpos, memory, pos, mask))
                outs.append(stage(f"decoder_norm {i}", lambda: model.decoder_norm(tgt)))
            cls, box = stage("heads", lambda: model.heads(torch.stack(outs)))
            stage("top-k decode", lambda: decode_detr(det_cfg, cls, box, img_shape, scale))
    log_breakdown(f"detr serving stage breakdown, median of {repeats} batches", times, card)


def phase_detr_serving(card: str) -> dict:
    """Full-width DETR R50 serving, b4 bf16 on the config's canvas (800 x
    1344, 25 x 42 = 1050 encoder tokens an image), of every four images two
    smaller than the canvas (so the key mask drops tokens), through
    ``make_inference_fn``: 2 warm-up and 10 timed batches, K1, K2 and the
    matcher never launched, every batch's detections checked; a stage
    breakdown, one profiled batch and peak memory."""
    cfg, canvas, _ = detr_config()
    model = build_detector(cfg.model, "bfloat16", device="cuda", seed=SEED)
    det_cfg = build_detection_cfg(cfg.detection)
    infer = make_inference_fn(model, det_cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 49)
    batches = []
    for _ in range(WARMUP_BATCHES + TIMED_BATCHES):
        image, shapes = padded_images(gen, BATCH, canvas)
        batches.append((image.to(torch.bfloat16), shapes, torch.ones(BATCH, device="cuda")))
    log(f"detr serving: {detr_tokens(*batches[0][:2])}")
    for args in batches[:WARMUP_BATCHES]:
        infer(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    timed = iter(batches[WARMUP_BATCHES:])
    ms, results = timed_batches(lambda: infer(*next(timed)), TIMED_BATCHES)
    launches = read_launches()
    log(f"detr serving path: {TIMED_BATCHES} batches, launches {launches}")
    expect_launches("detr serving", launches, 0, 0, 0)
    for res, args in zip(results, batches[WARMUP_BATCHES:]):
        check_detr_detections(res, det_cfg, args[1])
    mean_ms = sum(ms) / len(ms)
    log(f"detr serving path: ms a batch {[round(t, 3) for t in ms]}, mean {mean_ms:.3f} ms, "
        f"{BATCH / (mean_ms / 1e3):.2f} images/s, median {statistics.median(ms):.3f} ms [{card}]; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    detr_stage_breakdown(model, det_cfg, batches[1], card)
    device_profile(lambda: infer(*batches[1]), mean_ms, card)
    return dict(launches=launches, ms_per_batch=mean_ms)


def detr_reference_gts(device) -> dict:
    """Three and two gts inside the reference phase's two images."""
    boxes = [[[16, 20, 120, 140], [150, 40, 300, 230], [60, 150, 110, 250]],
             [[30, 30, 200, 180], [210, 100, 250, 200], [0] * 4]]
    return dict(gt_boxes=torch.tensor(boxes, dtype=torch.float32, device=device),
                gt_labels=torch.tensor([[3, 17, 80], [1, 45, 0]], device=device),
                gt_valid=torch.tensor([[True, True, True], [True, True, False]], device=device))


def phase_detr_reference() -> None:
    """DETR in float32 on the GPU and on the CPU on a small canvas (2 x 256 x
    320, the second image 224 x 256 inside it). Serving, stage by stage on
    equal inputs (each GPU stage's output feeds the CPU counterpart of the
    next): C5, ``input_proj``, the encoding and the key mask, each encoder
    and decoder layer, the heads, the top-k decode. Training, each device
    its own chain from the same C5 and the same matching (the kernel's,
    itself held to the plain version on the GPU's costs): the losses and the
    gradients into C5 and ``query_embed``."""
    cfg, _, _ = detr_config()
    det_cfg = build_detection_cfg(cfg.detection)
    gpu = build_detector(cfg.model, "float32", "cuda", seed=SEED).train()
    cpu = build_detector(cfg.model, "float32", "cpu", seed=SEED).train()
    gen = torch.Generator().manual_seed(SEED + 50)
    x = torch.randn((2, 256, 320, 3), generator=gen)
    x[1, 224:], x[1, :, 256:] = 0.0, 0.0
    shapes = torch.tensor([[256.0, 320.0], [224.0, 256.0]])
    canvas = (256, 320)
    checks = []

    def check(name, err, limit):
        checks.append(f"{name} {err:.2e} (limit {limit:g})")
        if not err <= limit:
            raise AssertionError(f"detr reference check {name}: {err} > {limit}")

    with torch.no_grad():
        c5 = gpu.features(x.cuda())
        # cuDNN and the CPU pick other convolution algorithms and sum orders
        check("C5", rel_err(c5, cpu.features(x)), 1e-3)
        src, pos, mask = gpu.embed(c5, canvas, shapes.cuda())
        src_c, pos_c, mask_c = cpu.embed(c5.cpu(), canvas, shapes)
        check("input_proj", rel_err(src, src_c), 1e-5)
        check("sine encoding", rel_err(pos, pos_c), 1e-5)
        check("key mask mismatches", float((mask.cpu() != mask_c).sum()), 0)
        if bool(mask.all()) or not bool(mask[0].all()):
            raise AssertionError("the key mask should drop the second image's padding alone")
        memory = src
        for i in range(gpu.num_encoder_layers):
            out = gpu.encoder_layer(i, memory, pos, mask)
            check(f"encoder layer {i}", rel_err(out, cpu.encoder_layer(
                i, memory.cpu(), pos.cpu(), mask.cpu())), 1e-4)
            memory = out
        tgt, qpos = gpu.queries(memory)
        outs = []
        for i in range(gpu.num_decoder_layers):
            out = gpu.decoder_layer(i, tgt, qpos, memory, pos, mask)
            check(f"decoder layer {i}", rel_err(out, cpu.decoder_layer(
                i, tgt.cpu(), qpos.cpu(), memory.cpu(), pos.cpu(), mask.cpu())), 1e-4)
            tgt = out
            outs.append(gpu.decoder_norm(tgt))
        hs = torch.stack(outs)
        cls, box = gpu.heads(hs)
        cls_c, box_c = cpu.heads(hs.cpu())
        check("heads (logits, boxes)", max(rel_err(cls, cls_c), rel_err(box, box_c)), 1e-4)
        dets_g = decode_detr(det_cfg, cls, box, shapes.cuda())
        dets_c = decode_detr(det_cfg, cls.cpu(), box.cpu(), shapes)
        for field in ("valid", "labels", "indices"):
            check(f"top-k decode {field} mismatches",
                  float((getattr(dets_g, field).cpu() != getattr(dets_c, field)).sum()), 0)
        # the devices' softmax may differ by an ulp
        check("top-k decode scores", rel_err(dets_g.scores, dets_c.scores), 1e-6)
        check("top-k decode boxes", rel_err(dets_g.boxes, dets_c.boxes), 1e-6)

    gt = detr_reference_gts("cpu")
    c5_g = c5.detach().requires_grad_()
    c5_c = c5.detach().cpu().requires_grad_()
    col4row, results = None, []
    for model, leaf, device in ((gpu, c5_g, "cuda"), (cpu, c5_c, "cpu")):
        batch = {k: v.to(device) for k, v in gt.items()}
        outputs = model.predict(leaf, canvas, shapes.to(device))
        cls, box = detr_mod.loss_layers(det_cfg, *outputs)
        gt_c = detr_mod.gt_to_cxcywh(batch["gt_boxes"], batch["gt_valid"], shapes.to(device))
        if col4row is None:
            cost = detr_mod.matching_cost(det_cfg, cls, box, gt_c, batch["gt_labels"])
            col4row = detr_mod.match(cost, batch["gt_valid"])  # the kernel
            check("matching: kernel vs plain on the GPU's costs, mismatches",
                  float((detr_mod.match(cost.cpu(), gt["gt_valid"]) != col4row.cpu()).sum()), 0)
        losses = detr_mod.set_losses(det_cfg, cls, box, gt_c, batch["gt_labels"],
                                     batch["gt_valid"], col4row.to(device))
        results.append((losses, torch.autograd.grad(losses["loss"], [leaf, model.query_embed])))
    (lg, gg), (lc, gc) = results
    check("losses", max(rel_err(lg[k], lc[k]) for k in ("loss_cls", "loss_l1", "loss_giou")), 1e-4)
    check("gradients into C5", rel_err(gg[0], gc[0]), 1e-3)
    check("gradients into query_embed", rel_err(gg[1], gc[1]), 1e-3)
    if not (float(gg[0].abs().sum()) > 0 and float(gg[1].abs().sum()) > 0):
        raise AssertionError("no gradient into C5 or query_embed")
    log("detr reference check, GPU vs CPU float32: " + "; ".join(checks))


def phase_detr_train(card: str) -> dict:
    """Full-width DETR R50 training, float32 parameters and bf16 compute, b8
    (the config's ``sample_per_replica``) on its 800 x 1344 canvas, two
    images of 640 x 960 and 704 x 1088 in every four, 1-20 gts an image
    padded to 100, the config's AdamW and clip, through the entry points a
    user calls: 2 warm-up and 10 timed steps, K1 and K2 never and the
    matcher once a step, finite losses, no step skipped, every parameter
    group moved and no frozen parameter; one profiled step."""
    cfg, canvas, b = detr_config()
    steps = WARMUP_BATCHES + TIMED_BATCHES
    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    batches = [train_batch(gen, b, canvas) for _ in range(steps)]
    model, det_cfg, _, optimizer = build_train_objects(cfg, "cuda", seed=SEED,
                                                       loader=Batches(batches))
    if not isinstance(optimizer.torch_optimizer, torch.optim.AdamW):
        raise AssertionError(f"the config's optimizer built {type(optimizer.torch_optimizer)}")
    loss_fn = build_loss_fn(model, det_cfg, rng_seed=SEED)
    log(f"detr training: {detr_tokens(batches[0]['image'], batches[0]['img_shape'])}")
    Trainer(loss_fn, model, optimizer, Batches(batches[:WARMUP_BATCHES]), log_interval=1).run(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(loss_fn, model, optimizer, Batches(batches[WARMUP_BATCHES:]), log_interval=1)
    reset_launches()
    t0 = time.perf_counter()
    history = trainer.run(1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    log(f"detr training path: {TIMED_BATCHES} steps, launches {launches}")
    expect_launches("detr training", launches, 0, 0, TIMED_BATCHES)
    if len(history) != TIMED_BATCHES or trainer.skipped_steps:
        raise AssertionError(f"{len(history)} steps logged, {trainer.skipped_steps} skipped")
    keys = ("loss", "loss_cls", "loss_l1", "loss_giou")
    for h in history:
        if not all(math.isfinite(h[k]) for k in keys) or not h["num_pos"] > 0:
            raise AssertionError(f"non-finite loss or no gt at step {h['step']}: {h}")
    moved = {n for n, p in model.named_parameters() if not torch.equal(p, before[n])}
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    groups = sorted({n.split(".")[0] for n in trainable})
    still_groups = [g for g in groups if not any(n.split(".")[0] == g for n in moved)]
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    frozen_moved = [n for n in frozen if n in moved]
    still = [n for n in trainable if n not in moved]
    log(f"detr training path: {len(moved)} of {len(trainable)} trainable parameter tensors moved "
        f"in the groups {groups}; those that did not: {still}; {len(frozen)} frozen (the stem "
        "and stage 1)")
    if (still_groups or frozen_moved or "query_embed" not in moved
            or not all(n.startswith(("backbone.stem.", "backbone.layer1_")) for n in frozen)):
        raise AssertionError(f"groups that did not move {still_groups}; frozen parameters that "
                             f"moved {frozen_moved}")
    step_ms = [b / h["images_per_sec"] * 1e3 for h in history]
    mean_ms = seconds / TIMED_BATCHES * 1e3
    log(f"detr training path b{b}: ms a step {[round(t, 3) for t in step_ms]}, mean "
        f"{mean_ms:.3f} ms, {b / (mean_ms / 1e3):.2f} images/s, median "
        f"{statistics.median(step_ms):.3f} ms [{card}]; skipped steps {trainer.skipped_steps}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses first "
        + ", ".join(f"{k} {history[0][k]:.4f}" for k in keys)
        + "; last " + ", ".join(f"{k} {history[-1][k]:.4f}" for k in keys)
        + f"; gts an image {history[0]['num_pos']:.2f}")
    device_profile(lambda: trainer.train_step(dict(batches[-1])), mean_ms, card, "step")
    return dict(launches=launches, ms_per_step=mean_ms, model=model, det_cfg=det_cfg,
                batch=batches[-1])


def phase_detr_step_data(model, det_cfg, batch) -> dict:
    """The matcher kernel against its plain version on a DETR training
    step's own costs: every decoder layer and image, (48, 100, 100) at b8,
    softmax probabilities, L1 of the normalised boxes x 5 and per-pair GIoU
    x 2; timed against its bound."""
    with torch.no_grad():
        cls, box = detr_mod.loss_layers(det_cfg, *model(batch["image"], batch["img_shape"]))
        gt = detr_mod.gt_to_cxcywh(batch["gt_boxes"], batch["gt_valid"], batch["img_shape"])
        cost = detr_mod.matching_cost(det_cfg, cls, box, gt, batch["gt_labels"])
    layers, b, g, q = cost.shape
    valid = batch["gt_valid"][None].expand(layers, b, g).reshape(layers * b, g)
    return hungarian_at("hungarian on a DETR training step's own costs",
                        cost.reshape(layers * b, g, q), valid, time_plain=True)


# ---------------------------------------------------------------- the system's own entry points
# COCO's 80 category ids (1-90 with ten gaps) and its usual landscape and
# square image sizes (w, h): the config's fixed canvas (800, 1344) holds no
# portrait image at (1333, 800), in the reference as in the port (R8), so
# the portrait size goes to a folder of its own that training must refuse
COCO_CATEGORY_IDS = tuple(i for i in range(1, 91)
                          if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
CLI_SIZES = ((640, 480), (640, 427), (500, 375), (612, 612))
CLI_PORTRAIT = ((480, 640),)
CLI_TRAIN_IMAGES, CLI_VAL_IMAGES, CLI_EPOCHS = 64, 16, 2
SMOKE_COCO = ROOT / "build" / "smoke_coco"


def write_smoke_coco(split: str, n: int, seed: int, sizes=CLI_SIZES) -> Path:
    """``n`` seeded PNGs of ``sizes`` (noise with filled rectangles) under
    ``SMOKE_COCO/split`` and their instances JSON: 1-20 boxes an image over
    COCO's category ids, and one crowd box in every fourth image."""
    rng = np.random.default_rng(seed)
    img_dir = SMOKE_COCO / split
    img_dir.mkdir(parents=True, exist_ok=True)
    images, annotations = [], []
    for i in range(n):
        w, h = sizes[i % len(sizes)]
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        boxes = int(rng.integers(1, 21))
        for j in range(boxes + (i % 4 == 3)):
            bw, bh = int(rng.integers(16, w // 2)), int(rng.integers(16, h // 2))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            img[y:y + bh, x:x + bw] = rng.integers(0, 256, 3, dtype=np.uint8)
            annotations.append(dict(id=len(annotations) + 1, image_id=i + 1,
                                    category_id=int(rng.choice(COCO_CATEGORY_IDS)),
                                    bbox=[x, y, bw, bh], area=bw * bh, iscrowd=int(j == boxes)))
        name = f"{i + 1:012d}.png"
        (img_dir / name).write_bytes(png_encode(img))
        images.append(dict(id=i + 1, file_name=name, width=w, height=h))
    ann_file = SMOKE_COCO / f"instances_{split}.json"
    ann_file.write_text(json.dumps(dict(
        images=images, annotations=annotations,
        categories=[dict(id=c, name=f"category_{c}") for c in COCO_CATEGORY_IDS])))
    return ann_file


def write_smoke_config(train_ann: Path, val_ann: Path) -> Path:
    """A config whose ``_base_`` is the Faster R-CNN R50-FPN config, with
    only the data paths, the work dir, the warmup, the log interval and
    ``score_thr`` overridden: at 0 every valid proposal's class scores
    compete for the 100 detections an image, so a model with random weights
    still writes detections for ``tools.test`` to check."""
    path = SMOKE_COCO / "faster_rcnn_r50_fpn_smoke.py"
    path.write_text(
        f"_base_ = {str(CONFIG)!r}\n"
        f"data = dict(train=dict(ann_file={str(train_ann)!r}, img_prefix={str(SMOKE_COCO / 'train')!r}),\n"
        f"            val=dict(ann_file={str(val_ann)!r}, img_prefix={str(SMOKE_COCO / 'val')!r}))\n"
        "detection = dict(score_thr=0.0)\n"
        "schedule = dict(warmup_steps=100)\n"
        f"runtime = dict(work_dir={str(SMOKE_COCO / 'work')!r}, log_interval=1)\n")
    return path


def write_portrait_config(base: Path, train_ann: Path) -> Path:
    """The smoke config with a training set of portrait images."""
    path = SMOKE_COCO / "faster_rcnn_r50_fpn_smoke_portrait.py"
    path.write_text(
        f"_base_ = {str(base)!r}\n"
        f"data = dict(train=dict(ann_file={str(train_ann)!r}, "
        f"img_prefix={str(SMOKE_COCO / 'portrait')!r}))\n")
    return path


def host_data_costs(cfg, card: str, what: str = "cli") -> dict:
    """Host ms an image to read and decode, and to prepare a training
    sample (decode, normalise, resize, flip, pad; with the config's masks,
    rasterise, resize, flip and pad them), and ms a batch to collate, on the
    training set's first 16 images and two batches."""
    dataset = get_datasets(dict(cfg["data"]["train"]))
    paths = [str(Path(dataset.img_prefix) / info["filename"]) for info in dataset.img_infos[:16]]
    t0 = time.perf_counter()
    for p in paths:
        img_read(p)
    decode_ms = (time.perf_counter() - t0) / len(paths) * 1e3
    t0 = time.perf_counter()
    samples = [dataset[i] for i in range(16)]
    sample_ms = (time.perf_counter() - t0) / len(samples) * 1e3
    batch = cfg["data"]["sample_per_replica"]
    t0 = time.perf_counter()
    for k in range(0, 16, batch):
        collate(samples[k:k + batch], max_gts=cfg["data"]["max_gts"],
                canvas=tuple(cfg["data"]["canvas"]))
    collate_ms = (time.perf_counter() - t0) / (16 // batch) * 1e3
    log(f"{what} host data path [{card}, host clock]: read and decode {decode_ms:.2f} ms an image, "
        f"a training sample (decode, normalise, resize, flip, pad) {sample_ms:.2f} ms an image, "
        f"collate {collate_ms:.2f} ms a batch of {batch} on {tuple(cfg['data']['canvas'])}")
    return dict(decode_ms=decode_ms, sample_ms=sample_ms, collate_ms=collate_ms)


def equal_state(what: str, got: dict, want: dict) -> None:
    """Every tensor of ``got`` (on any device) equals ``want``'s bit for bit."""
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: keys differ")
    for k in got:
        a, b = got[k], want[k]
        if isinstance(a, dict):
            equal_state(f"{what} {k}", a, b)
        elif isinstance(a, torch.Tensor):
            if not torch.equal(a.detach().cpu(), b.detach().cpu()):
                raise AssertionError(f"{what}: {k} differs")
        elif a != b:
            raise AssertionError(f"{what}: {k} is {a}, saved {b}")


def cli_kernels(model, det_cfg, batch) -> dict:
    """K1 and K2 against their plain versions on one CLI training batch's
    own FPN levels and sampled rois (512 an image)."""
    noise = functools.partial(sampling_noise, torch.Generator(device="cuda").manual_seed(SEED + 60))
    feats, rpn_s, rpn_d = model(batch["image"])
    props = generate_proposals(det_cfg.proposal_train, det_cfg.anchor_generator,
                               [s.detach() for s in rpn_s], [d.detach() for d in rpn_d],
                               batch["img_shape"])
    sampled = sample_rois(det_cfg, props.boxes, props.valid, batch["gt_boxes"], batch["gt_labels"],
                          batch["gt_valid"], noise)
    return slate_kernels("a CLI training batch", model, det_cfg, feats, sampled)


def slate_kernels(what: str, model, det_cfg, feats, sampled) -> dict:
    """K1 and K2 against their plain versions on a training batch's own FPN
    levels and sampled slate, K2 on the box head's cotangent scaled by a
    power of two to a largest value in [1, 2) and twice bitwise equal; each
    timed against its bound."""
    maps = [f.detach() for f in feats[: len(det_cfg.roi_strides)]]
    rois = sampled.rois
    routed = roi_align.map_rois_to_levels(rois, len(maps), det_cfg.finest_scale)
    b, n = rois.shape[:2]
    c = maps[0].shape[-1]
    flops = 2 * 4 * b * n * (OUT_SIZE * RATIO) ** 2 * c
    small = rois.numel() * 4 + routed.numel() * 4
    out_bytes = b * n * OUT_SIZE * OUT_SIZE * c * maps[0].element_size()
    name = f"roi_align_fwd on {what}'s levels and sampled rois ({n} an image)"
    k1 = kernel_at(name, roi_align.multilevel_roi_align_cuda, roi_align.multilevel_roi_align,
                   (maps, rois, routed, det_cfg.roi_strides), check_bf16,
                   touched_bytes(maps, rois) + small, out_bytes, flops)
    leaves = [m.requires_grad_() for m in maps]
    roi_feats = roi_align.batched_multilevel_roi_align(leaves, rois, det_cfg.roi_strides,
                                                      det_cfg.roi_size)
    (cotangent,) = torch.autograd.grad(
        sum(rcnn_losses(det_cfg, *model.roi_forward(roi_feats), sampled)), roi_feats)
    top = float(cotangent.abs().max())
    if not top > 0:
        raise AssertionError(f"{what}: the box-head cotangent is all zero")
    cotangent = cotangent * 2.0 ** -math.floor(math.log2(top))  # K2 is linear in it
    args = (cotangent.detach(), rois, routed, [tuple(f.shape[1:3]) for f in maps],
            det_cfg.roi_strides, det_cfg.roi_size)
    name = f"roi_align_bwd on {what}'s levels, sampled rois and scaled cotangent"
    check_deterministic(name, roi_align.multilevel_roi_align_backward_cuda, args)
    k2 = kernel_at(name, roi_align.multilevel_roi_align_backward_cuda,
                   roi_align.multilevel_roi_align_backward, args,
                   lambda nm, g, w: check_grads(nm, g, w, cotangent.dtype),
                   cotangent.numel() * cotangent.element_size() + small,
                   sum(m.numel() for m in maps) * cotangent.element_size(), flops)
    return dict(k1=k1, k2=k2)


def cli_test_kernel(model, det_cfg, image, img_shape) -> dict:
    """K1 against its plain version on one ``tools.test`` batch's own FPN
    levels and test proposals, timed against its bound."""
    with torch.inference_mode():
        feats, rpn_s, rpn_d = model(image)
        props = generate_proposals(det_cfg.proposal_test, det_cfg.anchor_generator, rpn_s, rpn_d,
                                   img_shape)
        return test_slate_kernel("a tools.test batch's levels and proposals", det_cfg, image,
                                 feats, props.boxes)


def test_slate_kernel(what: str, det_cfg, image, feats, rois) -> dict:
    """K1 against its plain version on a test batch's FPN levels and its
    (B, R, 4) slate as the path feeds it, timed against its bound."""
    maps = list(feats[: len(det_cfg.roi_strides)])
    routed = roi_align.map_rois_to_levels(rois, len(maps), det_cfg.finest_scale)
    b, n = rois.shape[:2]
    c = maps[0].shape[-1]
    name = f"roi_align_fwd on {what} (b{b} on {tuple(image.shape[1:3])}, {n} an image)"
    return kernel_at(name, roi_align.multilevel_roi_align_cuda, roi_align.multilevel_roi_align,
                     (maps, rois, routed, det_cfg.roi_strides), check_bf16,
                     touched_bytes(maps, rois) + rois.numel() * 4 + routed.numel() * 4,
                     b * n * OUT_SIZE * OUT_SIZE * c * maps[0].element_size(),
                     2 * 4 * b * n * (OUT_SIZE * RATIO) ** 2 * c)


@contextlib.contextmanager
def recorded_evaluation():
    """``tools.test``'s evaluation, with its model, detection config,
    dataset, keyword arguments, first inference batch (``batch``, the
    inference function's arguments) and every batch's canvas (``canvases``)
    kept in the yielded dict."""
    seen = {}

    def recorded_evaluate(model, det_cfg, dataset, **kwargs):
        infer = make_inference_fn(model, det_cfg, segm=kwargs.get("segm", False))

        def recorded_infer(*args):
            seen.setdefault("batch", args)
            seen.setdefault("canvases", []).append(tuple(args[0].shape[1:3]))
            return infer(*args)

        seen.update(model=model, det_cfg=det_cfg, dataset=dataset, kwargs=kwargs)
        return evaluate_detector(model, det_cfg, dataset, infer=recorded_infer, **kwargs)

    test_cli.evaluate_detector = recorded_evaluate
    try:
        yield seen
    finally:
        test_cli.evaluate_detector = evaluate_detector


@contextlib.contextmanager
def plain_roi_align():
    """RoIAlign's plain PyTorch forward on CUDA tensors in place of K1."""
    kernel = roi_align.multilevel_roi_align_cuda
    roi_align.multilevel_roi_align_cuda = roi_align.multilevel_roi_align
    try:
        yield
    finally:
        roi_align.multilevel_roi_align_cuda = kernel


def match_detections(got: list, want: list, box_px: float = 1.0, score_rel: float = 0.02) -> tuple:
    """The share of ``got``'s COCO result records with a partner in
    ``want`` (same image and category, every xywh value within ``box_px``,
    the score within ``score_rel`` relative), and of ``want``'s in ``got``.
    K1 and the plain RoIAlign part by at most one bf16 ulp, which moves the
    scores and boxes by little but may swap near-tied candidates at the
    top-k's cut."""

    def share(a_all: list, b_all: list) -> float:
        by_key = {}
        for r in b_all:
            by_key.setdefault((r["image_id"], r["category_id"]), []).append(r)
        hits = 0
        for r in a_all:
            hits += any(max(abs(u - v) for u, v in zip(r["bbox"], o["bbox"])) <= box_px
                        and abs(r["score"] - o["score"]) <= score_rel * abs(r["score"])
                        for o in by_key.get((r["image_id"], r["category_id"]), ()))
        return hits / max(len(a_all), 1)

    return share(got, want), share(want, got)


def epoch_rate(records: list, epoch: int, batch_size: int) -> tuple:
    """(images/s over all of ``epoch`` from the trainer's log, its steps'
    ms): with log_interval 1 each step record's window runs from the
    previous record (or the epoch's start) to its metrics read."""
    step_ms = [batch_size / r["images_per_sec"] * 1e3 for r in records
               if "loss" in r and r["epoch"] == epoch]
    return batch_size * len(step_ms) / (sum(step_ms) / 1e3), step_ms


def loader_fed_profile(trainer, epoch: int, step_ms: float, card: str, what: str) -> dict:
    """One step fed by the trainer's own loader through the device prefetch,
    under the profiler: its busy ms and idle share, and (``batch``) the batch
    of the step before it, on the device, for the kernel checks."""
    loader = trainer.dataloader
    loader.set_epoch(epoch)
    batches = prefetch_to_device(loader.iter_batches(), 2, "cuda")
    first = next(batches)
    first.pop("img_meta")
    trainer.train_step(first)

    def loader_step():
        batch = next(batches)
        batch.pop("img_meta")
        trainer.train_step(batch)

    profile = device_profile(loader_step, step_ms, card, f"{what} (the next loader batch, then "
                                                         "the step)")
    batches.close()
    return dict(profile, batch=first)


def phase_cli(card: str, seeded_train: dict) -> dict:
    """The system's own entry points at full width: a seeded PNG COCO
    folder, ``tools.train`` refusing a portrait image (R8), two epochs of
    Faster R-CNN R50-FPN (b8 on 800 x 1344, the config's), a resume from
    ``epoch_1``, ``tools.test`` on the val set against the same evaluation
    through the plain RoIAlign, the gt oracle through the evaluator, and K1
    and K2 on the paths' own batches."""
    shutil.rmtree(SMOKE_COCO, ignore_errors=True)
    t0 = time.perf_counter()
    train_ann = write_smoke_coco("train", CLI_TRAIN_IMAGES, SEED + 70)
    val_ann = write_smoke_coco("val", CLI_VAL_IMAGES, SEED + 71)
    portrait_ann = write_smoke_coco("portrait", 1, SEED + 72, CLI_PORTRAIT)
    config = write_smoke_config(train_ann, val_ann)
    cfg = Config.fromfile(config)
    log(f"cli: wrote {CLI_TRAIN_IMAGES} train and {CLI_VAL_IMAGES} val PNGs of {CLI_SIZES}, one "
        f"of {CLI_PORTRAIT} and their instances JSONs in {time.perf_counter() - t0:.1f} s; "
        f"config {config.name}")
    host_data_costs(cfg, card)

    # R8 pinned: the config's fixed canvas holds no portrait image, so training refuses one
    portrait = write_portrait_config(config, portrait_ann)
    try:
        train_cli.main([str(portrait), "--epochs", "1", "--work-dir", str(SMOKE_COCO / "work_portrait")])
    except ValueError as e:
        if "canvas" not in str(e):
            raise
        log(f"cli training on a {CLI_PORTRAIT[0][0]}x{CLI_PORTRAIT[0][1]} portrait image (R8): "
            f"refused as expected: {e}")
    else:
        raise AssertionError("cli training on a portrait image: no R8 ValueError; if the canvas "
                             "now holds it, R8 is repaired and this pin goes")

    # the straight run: two epochs through tools.train, launches counted over it
    work = SMOKE_COCO / "work"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer = train_cli.main([str(config), "--epochs", str(CLI_EPOCHS), "--work-dir", str(work)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = len(trainer.dataloader)
    expect_launches("cli training", launches, CLI_EPOCHS * steps, CLI_EPOCHS * steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    if len(records) != CLI_EPOCHS * steps or not all(
            math.isfinite(r["loss"]) for r in records) or records[-1]["skipped_steps"]:
        raise AssertionError(f"cli training: {len(records)} records for {CLI_EPOCHS * steps} "
                             f"steps, or a non-finite loss, or a skipped step: {records[-1]}")
    for name in (f"epoch_{e + 1}" for e in range(CLI_EPOCHS)):
        if not (work / name / "model.pt").is_file() or not (work / name / "optimizer.pt").is_file():
            raise AssertionError(f"cli training: no checkpoint {name}")
    batch_size = cfg["data"]["sample_per_replica"]
    epoch_ips, step_ms = epoch_rate(records, CLI_EPOCHS - 1, batch_size)
    wait_ms = trainer.loader_wait_s / len(records) * 1e3
    log(f"cli training [{card}]: {steps} steps an epoch at b{batch_size} on "
        f"{tuple(cfg['data']['canvas'])}, {CLI_EPOCHS} epochs in {wall:.1f} s (the build and "
        f"checkpoints included); launches {launches}; epoch {CLI_EPOCHS} ms a step "
        f"{[round(m, 1) for m in step_ms]}, median {statistics.median(step_ms):.1f} ms; images/s "
        f"over all of epoch {CLI_EPOCHS} from the trainer's log: {epoch_ips:.2f} "
        f"({batch_size * len(step_ms)} images in {sum(step_ms) / 1e3:.3f} s), a step's median "
        f"{batch_size / statistics.median(step_ms) * 1e3:.2f}; the trainer's wait on the loader "
        f"{wait_ms:.1f} ms a step over both epochs; peak memory {peak:.2f} GiB; losses first "
        + ", ".join(f"{k} {records[0][k]:.4f}" for k in LOSS_KEYS)
        + "; last " + ", ".join(f"{k} {records[-1][k]:.4f}" for k in LOSS_KEYS))

    det_cfg = build_detection_cfg(cfg["detection"])
    cli_profile = loader_fed_profile(trainer, CLI_EPOCHS, statistics.median(step_ms), card,
                                     "CLI training step")
    first = cli_profile.pop("batch")
    seeded = seeded_train["profile"]
    log(f"cli training [{card}]: a step fed by the loader, b8 on "
        f"{tuple(cfg['data']['canvas'])}: {statistics.median(step_ms):.3f} ms, device busy "
        f"{cli_profile.get('busy_ms', float('nan')):.3f} ms, idle "
        f"{cli_profile.get('idle', float('nan')):.3f}; the seeded-batch step of this run, b{BATCH} on "
        f"{CANVAS}: {seeded_train['ms_per_step']:.3f} ms, device busy "
        f"{seeded.get('busy_ms', float('nan')):.3f} ms, idle {seeded.get('idle', float('nan')):.3f}")
    kernel_checks = cli_kernels(trainer.model, det_cfg, first)
    del trainer, first

    # resume from epoch_1 into another work dir: the state loads bit for bit, the run continues
    saved = load_checkpoint_file(str(work / "epoch_1"))
    model, _, _, optimizer = build_train_objects(cfg, "cuda", seed=SEED)
    meta = load_checkpoint(model, str(work / "epoch_1"), strict=True, optimizer=optimizer)
    equal_state("the resumed model", model.state_dict(), saved["model"])
    equal_state("the resumed optimizer", optimizer_state(model, optimizer), saved["optimizer"])
    del model, optimizer
    resumed = train_cli.main([str(config), "--epochs", str(CLI_EPOCHS), "--work-dir",
                              str(SMOKE_COCO / "work_resumed"), "--resume", str(work / "epoch_1")])
    got = resumed.history
    want = records[steps:]
    if [r["step"] for r in got] != [r["step"] for r in want] or got[0]["step"] != meta["step"] + 1:
        raise AssertionError(f"resumed steps {[r['step'] for r in got]}")
    if any(abs(g["lr"] - w["lr"]) > 1e-12 for g, w in zip(got, want)):
        raise AssertionError("the resumed learning rate does not continue the straight run's")
    rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-6) for g, w in zip(got, want)
              for k in LOSS_KEYS)
    log(f"cli resume from epoch_1: the model and optimizer state loaded bit for bit; steps "
        f"{got[0]['step']}-{got[-1]['step']}, lr {got[0]['lr']:.6g} continued; epoch-2 losses "
        f"within {rel:.2e} relative of the straight run's (limit 1e-3)")
    if not rel <= 1e-3:
        raise AssertionError(f"resumed losses {rel} relative from the straight run's")
    del resumed

    # tools.test on the val set, K1 counted over it; the model, the dataset
    # and the first batch that the CLI's evaluation used are kept for checks
    out = SMOKE_COCO / "results.json"
    reset_launches()
    t0 = time.perf_counter()
    with recorded_evaluation() as seen:
        metrics = test_cli.main([str(config), str(work / f"epoch_{CLI_EPOCHS}"), "--out", str(out)])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = read_launches()
    batches_test = -(-CLI_VAL_IMAGES // 8)
    expect_launches("cli test", test_launches, batches_test, 0)
    # the serving model keeps its convolutions and linears in the compute
    # dtype: loading rounds the float32 checkpoint to it, as load_state_dict casts
    served = seen["model"].state_dict()
    equal_state(f"the tools.test model against epoch_{CLI_EPOCHS}", served,
                {k: v.to(served[k].dtype) if k in served else v for k, v in
                 load_checkpoint_file(str(work / f"epoch_{CLI_EPOCHS}"))["model"].items()})
    if len(metrics) != 12 or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"cli test metrics {metrics}")
    results = json.loads(out.read_text())
    frames = {img["id"]: (img["width"], img["height"])
              for img in json.loads(val_ann.read_text())["images"]}
    if not isinstance(results, list) or not results:
        raise AssertionError(f"cli test results JSON holds no detection: {str(results)[:200]}")
    for r in results:  # COCO ids; xywh (inclusive +1 pixel widths) in the original frame, within
        x, y, w, h = r["bbox"]  # 1% of its edge for the resize's rounding
        fw, fh = frames.get(r["image_id"], (0, 0))
        if not (r["category_id"] in COCO_CATEGORY_IDS and w > 0 and h > 0 and x >= 0 and y >= 0
                and x + w <= (fw + 1) * 1.01 and y + h <= (fh + 1) * 1.01):
            raise AssertionError(f"cli test result outside its image or category ids: {r}")
    log(f"cli test [{card}]: {CLI_VAL_IMAGES} images in {test_s:.1f} s (the build included), "
        f"launches {test_launches}; the model equals epoch_{CLI_EPOCHS}'s bit for bit (its "
        f"{sorted({str(v.dtype)[6:] for v in served.values()})} tensors, the checkpoint cast to "
        f"them); "
        f"{len(results)} detections in the COCO results JSON over "
        f"{len({r['image_id'] for r in results})} images, each inside its original frame; "
        + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))

    # the same evaluation through the plain RoIAlign on the card, and K1 on the CLI's first batch
    with plain_roi_align():
        plain_metrics, plain_dets = evaluate_detector(seen["model"], seen["det_cfg"],
                                                      seen["dataset"], **seen["kwargs"])
    plain_results = coco_detection_dump(seen["dataset"], plain_dets)
    kept, found = match_detections(results, plain_results)
    metric_err = max(abs(metrics[k] - plain_metrics[k]) for k in metrics)
    log(f"cli test against evaluate_detector through the plain RoIAlign on the same model: "
        f"{len(results)} and {len(plain_results)} "
        f"detections; {kept:.4f} of the CLI's have a partner in the plain run's and {found:.4f} "
        f"the other way (same label, boxes within 1 px, scores within 2%; limit 0.95); the 12 "
        f"metrics within {metric_err:.2e} (limit 0.01)")
    if not (kept >= 0.95 and found >= 0.95 and metric_err <= 0.01):
        raise AssertionError("tools.test's detections part from the plain RoIAlign's")
    image, img_shape = seen["batch"][:2]
    k1_test = cli_test_kernel(seen["model"], seen["det_cfg"], image, img_shape)
    del seen

    # the oracle: each val image's own gts as detections of score 1
    val = get_datasets(dict(cfg["data"]["val"]))
    anns = [val.get_ann_info(i) for i in range(len(val))]
    dets = [dict(boxes=a["bboxes"], scores=np.ones(len(a["bboxes"])), labels=a["labels"])
            for a in anns]
    oracle = eval_coco_map(dets, anns, det_cfg.num_classes)
    dumped = sorted((r["image_id"], r["category_id"], tuple(r["bbox"]))
                    for r in coco_detection_dump(val, dets))
    source = json.loads(val_ann.read_text())["annotations"]
    want_dump = sorted((a["image_id"], a["category_id"], tuple(float(v) for v in a["bbox"]))
                       for a in source if not a["iscrowd"])
    crowds = sum(a["iscrowd"] for a in source)
    log(f"cli oracle: the val gts as detections give mAP {oracle['mAP']:.6f}, AR_100 "
        f"{oracle['AR_100']:.6f}; the dump gives back the {len(want_dump)} non-crowd annotations "
        f"({crowds} crowds as ignore regions): {dumped == want_dump}")
    if abs(oracle["mAP"] - 1.0) > 1e-12 or dumped != want_dump:
        raise AssertionError("the gt oracle does not score 1.0 or the dump does not invert the "
                             "dataset")
    return dict(training=launches, test=test_launches, k1_test=k1_test, **kernel_checks)

# ---------------------------------------------------------------- the entry points on Mask R-CNN
CLI_MASK_TRAIN_IMAGES, CLI_MASK_VAL_IMAGES, CLI_MASK_EPOCHS = 64, 16, 2
SMOKE_COCO_MASKS = ROOT / "build" / "smoke_coco_masks"
MASK_OUT = 14  # the mask branch's RoIAlign size, configs/mask_rcnn_r50_fpn_coco.py's


def smoke_object(rng, w: int, h: int, two_parts: bool):
    """One object's COCO polygons: 6-40 vertices around a centre, every
    other one concave; with ``two_parts`` a second, smaller part beside it.
    Vertices lie inside the image."""
    parts = []
    cx, cy = rng.uniform(0.2 * w, 0.8 * w), rng.uniform(0.2 * h, 0.8 * h)
    r = rng.uniform(12, min(w, h) / 4)
    for k in range(2 if two_parts else 1):
        n = int(rng.integers(6, 41))
        angles = np.sort(rng.uniform(0, 2 * np.pi, n))
        radii = r * (1 - (0.6 if rng.random() < 0.5 else 0.0) * rng.uniform(0, 1, n)) / (k + 1)
        ox = cx + (1.6 * r if k else 0.0)
        pts = np.stack([ox + radii * np.cos(angles), cy + radii * np.sin(angles)], 1)
        parts.append(np.clip(pts, 0, [w - 1, h - 1]).round(2).reshape(-1).tolist())
    return parts


def write_smoke_coco_masks(split: str, n: int, seed: int) -> Path:
    """``n`` seeded PNGs at COCO's landscape and square sizes under
    ``SMOKE_COCO_MASKS/split`` and their instances JSON: 1-20 objects an
    image over COCO's category ids, each a filled polygon of 6-40 vertices
    (some concave, every fifth of two parts); every seventh non-crowd object
    carries its mask as a compressed RLE string, and every fourth image a
    crowd with an uncompressed RLE."""
    rng = np.random.default_rng(seed)
    img_dir = SMOKE_COCO_MASKS / split
    img_dir.mkdir(parents=True, exist_ok=True)
    images, annotations = [], []
    for i in range(n):
        w, h = CLI_SIZES[i % len(CLI_SIZES)]
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        objects = int(rng.integers(1, 21))
        for j in range(objects + (i % 4 == 3)):
            crowd = j == objects
            polys = smoke_object(rng, w, h, two_parts=len(annotations) % 5 == 4)
            m = poly_to_mask(polys, h, w)
            if crowd:
                segm = rle_encode(m, compress=False)
                segm["counts"] = [int(c) for c in segm["counts"]]
            elif len(annotations) % 7 == 6:
                segm = rle_encode(m)
                segm["counts"] = segm["counts"].decode("ascii")
            else:
                segm = polys
            img[m.astype(bool)] = rng.integers(0, 256, 3, dtype=np.uint8)
            ys, xs = np.nonzero(m)
            bbox = [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                    int(ys.max() - ys.min() + 1)]
            annotations.append(dict(id=len(annotations) + 1, image_id=i + 1,
                                    category_id=int(rng.choice(COCO_CATEGORY_IDS)), bbox=bbox,
                                    area=int(m.sum()), iscrowd=int(crowd), segmentation=segm))
        name = f"{i + 1:012d}.png"
        (img_dir / name).write_bytes(png_encode(img))
        images.append(dict(id=i + 1, file_name=name, width=w, height=h))
    ann_file = SMOKE_COCO_MASKS / f"instances_{split}.json"
    ann_file.write_text(json.dumps(dict(
        images=images, annotations=annotations,
        categories=[dict(id=c, name=f"category_{c}") for c in COCO_CATEGORY_IDS])))
    return ann_file


def write_smoke_mask_config(train_ann: Path, val_ann: Path) -> Path:
    """The Mask R-CNN R50-FPN config with what ``write_smoke_config``
    overrides and nothing else."""
    path = SMOKE_COCO_MASKS / "mask_rcnn_r50_fpn_smoke.py"
    path.write_text(
        f"_base_ = {str(MASK_CONFIG)!r}\n"
        f"data = dict(train=dict(ann_file={str(train_ann)!r}, img_prefix={str(SMOKE_COCO_MASKS / 'train')!r}),\n"
        f"            val=dict(ann_file={str(val_ann)!r}, img_prefix={str(SMOKE_COCO_MASKS / 'val')!r}))\n"
        "detection = dict(score_thr=0.0)\n"
        "schedule = dict(warmup_steps=100)\n"
        f"runtime = dict(work_dir={str(SMOKE_COCO_MASKS / 'work')!r}, log_interval=1)\n")
    return path


def write_torchvision_resnet50(path: Path, seed: int) -> dict:
    """A seeded ResNet-50 ``state_dict`` under torchvision's names (with the
    classifier ``fc.*`` and every BatchNorm's ``num_batches_tracked``),
    saved in a ``{"state_dict": ...}`` envelope; returns the state. Each
    residual branch's last BatchNorm scales by about 0.15, so that the
    random features keep a moderate size through the 16 blocks."""
    g = torch.Generator().manual_seed(seed)

    def conv(cout, cin, k):
        return torch.randn((cout, cin, k, k), generator=g) * (2.0 / (cin * k * k)) ** 0.5

    def bn(prefix, c, scale=1.0):
        return {f"{prefix}.weight": scale * (0.5 + 0.5 * torch.rand(c, generator=g)),
                f"{prefix}.bias": 0.1 * torch.randn(c, generator=g),
                f"{prefix}.running_mean": 0.1 * torch.randn(c, generator=g),
                f"{prefix}.running_var": 0.5 + torch.rand(c, generator=g),
                f"{prefix}.num_batches_tracked": torch.tensor(1000)}

    state = {"conv1.weight": conv(64, 3, 7), **bn("bn1", 64)}
    inplanes = 64
    for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3)), start=1):
        for j in range(blocks):
            p = f"layer{i}.{j}"
            state.update({f"{p}.conv1.weight": conv(planes, inplanes, 1), **bn(f"{p}.bn1", planes),
                          f"{p}.conv2.weight": conv(planes, planes, 3), **bn(f"{p}.bn2", planes),
                          f"{p}.conv3.weight": conv(planes * 4, planes, 1),
                          **bn(f"{p}.bn3", planes * 4, 0.2)})
            if j == 0:
                state.update({f"{p}.downsample.0.weight": conv(planes * 4, inplanes, 1),
                              **bn(f"{p}.downsample.1", planes * 4, 0.5)})
            inplanes = planes * 4
    state.update({"fc.weight": 0.01 * torch.randn((1000, 2048), generator=g),
                  "fc.bias": torch.zeros(1000)})
    torch.save({"state_dict": state}, str(path))
    return state


class LaunchSizes:
    """Stands in for a kernel wrapper in ``ops.roi_align`` and counts its
    calls by RoIAlign output size (``size_of`` reads it from the call); the
    wrapper's own ``launches`` count stays where it is, and this object's
    ``launches`` reads and writes it."""

    def __init__(self, fn, size_of):
        self.fn, self.size_of, self.sizes = fn, size_of, collections.Counter()

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.sizes[self.size_of(args, out)] += 1
        return out

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value


@contextlib.contextmanager
def launches_by_out_size():
    """K1's and K2's launches by output size while the block runs."""
    k1, k2 = roi_align.multilevel_roi_align_cuda, roi_align.multilevel_roi_align_backward_cuda
    fwd = LaunchSizes(k1, lambda args, out: int(out.shape[2]))
    bwd = LaunchSizes(k2, lambda args, out: int(args[0].shape[2]))
    roi_align.multilevel_roi_align_cuda, roi_align.multilevel_roi_align_backward_cuda = fwd, bwd
    sizes = dict(k1=fwd.sizes, k2=bwd.sizes)
    try:
        yield sizes
    finally:
        roi_align.multilevel_roi_align_cuda, roi_align.multilevel_roi_align_backward_cuda = k1, k2


class LogLines(logging.Handler):
    """The root logger's INFO records while it is attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@contextlib.contextmanager
def logged_lines():
    """The INFO lines logged while the block runs."""
    root, lines = logging.getLogger(), LogLines()
    level = root.level
    root.setLevel(min(level, logging.INFO))
    root.addHandler(lines)
    try:
        yield lines.lines
    finally:
        root.removeHandler(lines)
        root.setLevel(level)


def staged_batch_ms(batch: dict, card: str) -> None:
    """The pinned, side-stream copy of one collated masked batch to the card
    (``prefetch_to_device``), its bytes by key and its rate."""
    sizes = {k: v.nbytes for k, v in batch.items() if isinstance(v, np.ndarray)}
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = next(prefetch_to_device(iter([batch]), 1, "cuda"))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del staged
    total = sum(sizes.values())
    log(f"cli mask batch to the card [{card}, host clock, pinned copy on a side stream]: "
        f"{total / 1e6:.1f} MB (gt_masks {sizes['gt_masks'] / 1e6:.1f} MB, "
        f"{tuple(batch['gt_masks'].shape)} uint8; image {sizes['image'] / 1e6:.1f} MB float32), "
        f"{[round(t, 2) for t in times]} ms, {total / 1e6 / min(times):.2f} GB/s at best")


def cli_mask_kernels(model, det_cfg, batch) -> dict:
    """K1 and K2 against their plain versions at out 14 on one CLI training
    batch's own mask slate (positives first, 128 rois an image), FPN levels
    and mask-head cotangent, scaled by a power of two to a largest value in
    [1, 2); each timed against its bound."""
    noise = functools.partial(sampling_noise, torch.Generator(device="cuda").manual_seed(SEED + 80))
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
    feats, rpn_s, rpn_d = model(batch["image"])
    props = generate_proposals(det_cfg.proposal_train, det_cfg.anchor_generator,
                               [s.detach() for s in rpn_s], [d.detach() for d in rpn_d],
                               batch["img_shape"])
    sample_rois(det_cfg, props.boxes, props.valid, *gt, noise)  # the box slate's draws first
    slate = sample_mask_rois(det_cfg, props, *gt, noise)
    b = slate.rois.shape[0]
    log(f"cli mask slate: {slate.rois.shape[1]} rois an image, positives "
        f"{slate.is_pos.sum(1).tolist()}; gt_masks {tuple(batch['gt_masks'].shape)}")
    targets = mask_targets_for_rois(batch["gt_masks"], slate.rois, slate.matched, det_cfg.mask_size)
    levels_in = list(feats[: len(det_cfg.roi_strides)])
    m = det_cfg.mask_roi_size
    roi_feats = roi_align.batched_multilevel_roi_align(levels_in, slate.rois, det_cfg.roi_strides, m)
    logits = model.mask_forward(roi_feats)
    (cotangent,) = torch.autograd.grad(mask_loss(logits, targets, slate.labels, slate.is_pos),
                                       roi_feats)
    top = float(cotangent.abs().max())
    if not top > 0:
        raise AssertionError("the CLI mask slate's cotangent is all zero")
    cotangent = cotangent * 2.0 ** -math.floor(math.log2(top))  # K2 is linear in it
    routed = roi_align.map_rois_to_levels(slate.rois, len(levels_in))
    maps = [f.detach() for f in levels_in]
    n = slate.rois.shape[1]
    c = maps[0].shape[-1]
    flops = 2 * 4 * b * n * (m * RATIO) ** 2 * c
    small = slate.rois.numel() * 4 + routed.numel() * 4
    roi_bytes = b * n * m * m * c * cotangent.element_size()
    k1 = kernel_at(f"roi_align_fwd on a CLI training batch's mask slate, out {m}",
                   roi_align.multilevel_roi_align_cuda, roi_align.multilevel_roi_align,
                   (maps, slate.rois, routed, det_cfg.roi_strides, m), check_bf16,
                   touched_bytes(maps, slate.rois, m) + small, roi_bytes, flops)
    args = (cotangent, slate.rois, routed, [tuple(f.shape[1:3]) for f in maps], det_cfg.roi_strides, m)
    name = f"roi_align_bwd on a CLI training batch's mask slate and scaled cotangent, out {m}"
    check_deterministic(name, roi_align.multilevel_roi_align_backward_cuda, args)
    k2 = kernel_at(name, roi_align.multilevel_roi_align_backward_cuda,
                   roi_align.multilevel_roi_align_backward, args,
                   lambda nm, g, w: check_grads(nm, g, w, cotangent.dtype), roi_bytes + small,
                   sum(f.numel() for f in maps) * cotangent.element_size(), flops)
    return dict(k1=k1, k2=k2)


def mask_probs_of(model, det_cfg, feats, dets, roi_boxes) -> torch.Tensor:
    """The mask branch of ``mask_rcnn_inference`` on given detections."""
    logits = select_class(model.mask_forward(roi_features(det_cfg, feats, roi_boxes,
                                                          det_cfg.mask_roi_size)), dets.labels)
    return torch.sigmoid(logits.float()) * dets.valid[..., None, None]


def cli_mask_test_checks(model, det_cfg, image, img_shape, metas, card: str) -> dict:
    """On one ``tools.test --segm`` batch: K1 at out 14 on its detections
    against the plain version and its bound; and the batch's masks pasted in
    the original frame through K1 and through the plain RoIAlign, on the
    same detections, pixel for pixel."""
    with torch.inference_mode():
        dets, feats = _faster_rcnn_inference_core(det_cfg, model, image, img_shape)
        ones = torch.ones(image.shape[0], device=image.device)
        dets, roi_boxes = mask_frame(dets, ones)
        maps = list(feats[: len(det_cfg.roi_strides)])
        routed = roi_align.map_rois_to_levels(roi_boxes, len(maps), det_cfg.finest_scale)
        b, n = roi_boxes.shape[:2]
        c, m = maps[0].shape[-1], det_cfg.mask_roi_size
        k1 = kernel_at(f"roi_align_fwd on a tools.test batch's detections (b{b}, {n} an image), "
                       f"out {m}", roi_align.multilevel_roi_align_cuda,
                       roi_align.multilevel_roi_align, (maps, roi_boxes, routed, det_cfg.roi_strides, m),
                       check_bf16, touched_bytes(maps, roi_boxes, m) + roi_boxes.numel() * 4
                       + routed.numel() * 4, b * n * m * m * c * maps[0].element_size(),
                       2 * 4 * b * n * (m * RATIO) ** 2 * c)
        kernel_probs = mask_probs_of(model, det_cfg, feats, dets, roi_boxes)
        with plain_roi_align():
            plain_probs = mask_probs_of(model, det_cfg, feats, dets, roi_boxes)
    same = total = fg_same = fg = 0
    valid, boxes = dets.valid.cpu().numpy(), dets.boxes.float().cpu().numpy()
    for j, meta in enumerate(metas):
        v = valid[j]
        got, _ = masks_to_original(kernel_probs[j].cpu().numpy()[v], boxes[j][v], meta)
        want, _ = masks_to_original(plain_probs[j].cpu().numpy()[v], boxes[j][v], meta)
        same, total = same + int((got == want).sum()), total + got.size
        fg_same, fg = fg_same + int((got & want).sum()), fg + int((got | want).sum())
    share, fg_share = same / max(total, 1), fg_same / max(fg, 1)
    log(f"cli test --segm masks of one batch pasted in the original frame through K1 and through "
        f"the plain RoIAlign on the same {int(valid.sum())} detections: {share:.6f} of their "
        f"{total} pixels agree (limit 0.99); {fg_share:.6f} of the {fg} pixels either "
        f"marks agree (limit 0.999); max |prob difference| "
        f"{float((kernel_probs - plain_probs).abs().max()):.3e}")
    if not (share >= 0.99 and fg > 0 and fg_share >= 0.999):
        raise AssertionError("the pasted masks part from the plain RoIAlign's")
    return k1


def phase_cli_mask(card: str) -> dict:
    """The system's own entry points on Mask R-CNN R50-FPN at full width: a
    seeded PNG COCO folder with polygon and RLE masks, ``tools.train`` from a
    seeded torchvision-named ResNet-50 ``.pth`` (``--pretrained torch://``)
    for two epochs, ``tools.test --segm``, the gt masks' oracle, and K1 and
    K2 at out 14 on the paths' own batches."""
    shutil.rmtree(SMOKE_COCO_MASKS, ignore_errors=True)
    t0 = time.perf_counter()
    train_ann = write_smoke_coco_masks("train", CLI_MASK_TRAIN_IMAGES, SEED + 90)
    val_ann = write_smoke_coco_masks("val", CLI_MASK_VAL_IMAGES, SEED + 91)
    config = write_smoke_mask_config(train_ann, val_ann)
    pth = SMOKE_COCO_MASKS / "resnet50_torchvision.pth"
    state = write_torchvision_resnet50(pth, SEED + 92)
    cfg = Config.fromfile(config)
    source = json.loads(train_ann.read_text())["annotations"]
    kinds = collections.Counter("crowd" if a["iscrowd"] else "rle" if isinstance(
        a["segmentation"], dict) else f"polygon of {len(a['segmentation'])}" for a in source)
    log(f"cli mask: wrote {CLI_MASK_TRAIN_IMAGES} train and {CLI_MASK_VAL_IMAGES} val PNGs of "
        f"{CLI_SIZES}, their instances JSONs ({dict(sorted(kinds.items()))} in training) and a "
        f"torchvision-named ResNet-50 .pth of {len(state)} tensors in "
        f"{time.perf_counter() - t0:.1f} s; config {config.name}")
    host = host_data_costs(cfg, card, "cli mask")
    dataset = get_datasets(dict(cfg["data"]["train"]))
    samples = [dataset[i] for i in range(cfg["data"]["sample_per_replica"])]
    staged_batch_ms(collate(samples, max_gts=cfg["data"]["max_gts"],
                            canvas=tuple(cfg["data"]["canvas"])), card)
    del dataset, samples

    # two epochs through tools.train from the .pth, launches counted by output size
    work = SMOKE_COCO_MASKS / "work"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with logged_lines() as lines, launches_by_out_size() as sizes:
        trainer = train_cli.main([str(config), "--epochs", str(CLI_MASK_EPOCHS), "--work-dir",
                                  str(work), "--pretrained", f"torch://{pth}"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = len(trainer.dataloader)
    n = CLI_MASK_EPOCHS * steps
    expect_launches("cli mask training", launches, 2 * n, 2 * n)
    if sizes != dict(k1={OUT_SIZE: n, MASK_OUT: n}, k2={OUT_SIZE: n, MASK_OUT: n}):
        raise AssertionError(f"cli mask training: launches by out size {sizes}; expected one at "
                             f"out {OUT_SIZE} and one at out {MASK_OUT} a step, each kernel")
    peak = torch.cuda.max_memory_allocated() / 2**30
    backbone = [k for k in trainer.model.state_dict() if k.startswith("backbone.")]
    loaded = [line for line in lines if line.startswith("loaded ") and str(pth) in line]
    want_line = f", {len(backbone)} of the backbone's {len(backbone)}"
    log(f"cli mask training: the loader's report: {loaded}")
    if len(loaded) != 1 or want_line not in loaded[0]:
        raise AssertionError(f"the .pth did not set every backbone tensor: {loaded}")
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    keys = LOSS_KEYS + ("loss_mask",)
    if len(records) != n or not all(math.isfinite(r[k]) for r in records for k in keys) or \
            records[-1]["skipped_steps"]:
        raise AssertionError(f"cli mask training: {len(records)} records for {n} steps, or a "
                             f"non-finite loss, or a skipped step: {records[-1]}")
    batch_size = cfg["data"]["sample_per_replica"]
    epoch_ips, step_ms = epoch_rate(records, CLI_MASK_EPOCHS - 1, batch_size)
    wait_ms = trainer.loader_wait_s / len(records) * 1e3
    log(f"cli mask training [{card}]: {steps} steps an epoch at b{batch_size} on "
        f"{tuple(cfg['data']['canvas'])}, {CLI_MASK_EPOCHS} epochs in {wall:.1f} s (the build, the "
        f".pth and checkpoints included); launches {launches}, by out size "
        f"{ {k: dict(v) for k, v in sizes.items()} }; epoch {CLI_MASK_EPOCHS} ms a step "
        f"{[round(m, 1) for m in step_ms]}, median {statistics.median(step_ms):.1f} ms; images/s "
        f"over all of epoch {CLI_MASK_EPOCHS}: {epoch_ips:.2f}, a step's median "
        f"{batch_size / statistics.median(step_ms) * 1e3:.2f}; the trainer's wait on the loader "
        f"{wait_ms:.1f} ms a step; peak memory {peak:.2f} GiB; losses first "
        + ", ".join(f"{k} {records[0][k]:.4f}" for k in keys)
        + "; last " + ", ".join(f"{k} {records[-1][k]:.4f}" for k in keys))

    # the frozen stem and stage 1 (frozen_stages=1) keep the .pth's values through training
    converted, _ = convert_state_dict(trainer.model, state,
                                      prefixed_rules(RESNET_KEY_RULES, "", "backbone."))
    saved = load_checkpoint_file(str(work / f"epoch_{CLI_MASK_EPOCHS}"))["model"]
    frozen = [k for k in converted if k.startswith(("backbone.stem.", "backbone.layer1_"))]
    moved = [k for k in frozen if not torch.equal(saved[k].cpu(), converted[k])]
    trained = [k for k in converted if k.startswith("backbone.layer2_")
               and not torch.equal(saved[k].cpu(), converted[k])]
    log(f"cli mask training: epoch_{CLI_MASK_EPOCHS}'s frozen stem and stage 1 equal the .pth's "
        f"{len(frozen) - len(moved)} of {len(frozen)} tensors bit for bit; stage 2 moved in "
        f"{len(trained)} tensors")
    if moved or not frozen or not trained:
        raise AssertionError(f"frozen tensors moved {moved[:4]}, or stage 2 did not train")

    det_cfg = build_detection_cfg(cfg["detection"])
    profile = loader_fed_profile(trainer, CLI_MASK_EPOCHS, statistics.median(step_ms), card,
                                 "CLI mask training step")
    first = profile.pop("batch")
    kernel_checks = cli_mask_kernels(trainer.model, det_cfg, first)
    del trainer, first

    # tools.test --segm on the val set, K1 counted by output size
    out = SMOKE_COCO_MASKS / "results.json"
    reset_launches()
    t0 = time.perf_counter()
    with recorded_evaluation() as seen, launches_by_out_size() as test_sizes:
        metrics = test_cli.main([str(config), str(work / f"epoch_{CLI_MASK_EPOCHS}"), "--segm",
                                 "--out", str(out)])
        torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = read_launches()
    batches_test = -(-CLI_MASK_VAL_IMAGES // 8)
    expect_launches("cli mask test", test_launches, 2 * batches_test, 0)
    if test_sizes != dict(k1={OUT_SIZE: batches_test, MASK_OUT: batches_test}, k2={}):
        raise AssertionError(f"cli mask test: launches by out size {test_sizes}")
    if len(metrics) != 24 or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"cli mask test metrics {metrics}")
    segm_path = SMOKE_COCO_MASKS / "results.segm.json"
    segm = json.loads(segm_path.read_text())
    frames = {img["id"]: (img["height"], img["width"])
              for img in json.loads(val_ann.read_text())["images"]}
    if not segm or len(segm) != len(json.loads(out.read_text())):
        raise AssertionError(f"cli mask test: {len(segm)} segm records")
    for r in segm:
        decoded = rle_decode(r["segmentation"])
        if decoded.shape != frames[r["image_id"]] or r["category_id"] not in COCO_CATEGORY_IDS:
            raise AssertionError(f"a segm record of shape {decoded.shape} for image "
                                 f"{r['image_id']} of {frames[r['image_id']]}")
    log(f"cli test --segm [{card}]: {CLI_MASK_VAL_IMAGES} images in {test_s:.1f} s (the build "
        f"included), launches {test_launches}, by out size "
        f"{ {k: dict(v) for k, v in test_sizes.items()} }; {len(segm)} segm records, each RLE "
        f"decoding to its image's original size; "
        + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    image, img_shape = seen["batch"][:2]
    metas = [seen["dataset"][i]["img_meta"][0].data for i in range(image.shape[0])]
    k1_test = cli_mask_test_checks(seen["model"], seen["det_cfg"], image, img_shape, metas, card)
    del seen

    # the oracle: each val image's own gt masks as detections of score 1
    _, oracle, inverted = segm_oracle(get_datasets(dict(cfg["data"]["val"], with_mask=True)),
                                      val_ann, det_cfg.num_classes)
    log(f"cli mask oracle: the val gt masks as detections give segm mAP {oracle['mAP']:.6f}, "
        f"AR_100 {oracle['AR_100']:.6f}; the segm dump gives back the non-crowd masks: "
        f"{inverted}")
    if abs(oracle["mAP"] - 1.0) > 1e-12 or not inverted:
        raise AssertionError("the segm oracle does not score 1.0 or the dump does not invert the "
                             "dataset's masks")
    return dict(training=launches, test=test_launches, k1_test=k1_test, host=host,
                profile=profile, **kernel_checks)


# ---------------------------------------------------------------- JPEG, VOC and the Fast R-CNN workflow
# ---------------------------------------------------------------- the training options
OPTIONS_TRAIN_IMAGES, OPTIONS_EPOCHS, OPTIONS_ACCUM, OPTIONS_EMA = 32, 2, 2, 0.999
OPTIONS_WARMUP, OPTIONS_MIN_LR_RATIO = 2, 0.01
EMA_TRACKED = ("backbone.layer4_0.block1.conv.weight", "neck.fpn0.conv.weight",
               "rpn.rpn_conv.weight", "bbox_head.reg.weight")
VIS_FIXTURES = ("landscape_640x480_0.jpg", "landscape_640x427_0.jpg", "landscape_612x612_0.jpg",
                "landscape_500x333_0.jpg")
VIS_SEGM_FIXTURES = tuple(name.replace("_0.jpg", "_1.jpg") for name in VIS_FIXTURES)
RETINA_ANCHOR_COUNT = 182_403  # 9 anchors at each cell of P3-P7 of 800 x 1216


def write_options_configs(train_ann: Path, base: Path) -> tuple:
    """The smoke config with the four training options, its training set
    ``train_ann``, validation each epoch and its own work dir; and the same
    in float32 (for the accumulation check)."""
    path = SMOKE_COCO / "faster_rcnn_r50_fpn_options.py"
    path.write_text(
        f"_base_ = {str(base)!r}\n"
        f"data = dict(train=dict(ann_file={str(train_ann)!r}))\n"
        "model = dict(bbox_head=dict(reg_class_agnostic=False))\n"
        f"schedule = dict(policy='cosine', min_lr_ratio={OPTIONS_MIN_LR_RATIO}, "
        f"warmup_steps={OPTIONS_WARMUP}, total_epochs={OPTIONS_EPOCHS})\n"
        f"runtime = dict(accum_steps={OPTIONS_ACCUM}, ema_decay={OPTIONS_EMA}, "
        f"val_interval_epochs=1, work_dir={str(SMOKE_COCO / 'work_options')!r})\n")
    f32 = SMOKE_COCO / "faster_rcnn_r50_fpn_options_f32.py"
    f32.write_text(f"_base_ = {str(path)!r}\nruntime = dict(compute_dtype='float32')\n")
    return path, f32


def cosine_lr(step: int, base_lr: float, total: int) -> float:
    """The schedule of the options config, written out: linear warmup from a
    third of ``base_lr``, then the cosine to ``OPTIONS_MIN_LR_RATIO`` of it
    over ``total`` steps."""
    if step < OPTIONS_WARMUP:
        return base_lr * (1 / 3 + (2 / 3) * step / OPTIONS_WARMUP)
    floor = OPTIONS_MIN_LR_RATIO * base_lr
    return floor + (base_lr - floor) * 0.5 * (1 + math.cos(math.pi * min(step / total, 1.0)))


@contextlib.contextmanager
def recorded_ema():
    """Every ``ParamEMA.update`` while the block runs: the step, the rate,
    and each ``EMA_TRACKED`` tensor's parameter and average (float64 on the
    host) after it, with the averages before the first update; and at each
    ``applied`` (validation) whether the model then holds the averages."""
    update, applied = ParamEMA.update, ParamEMA.applied
    records = dict(updates=[], start=None, validations=[])

    def tracked(ema, tensors):
        index = {n: i for i, n in enumerate(ema.names)}
        return {n: tensors[index[n]].detach().double().cpu() for n in EMA_TRACKED}

    def recording_update(ema, step):
        if records["start"] is None:
            records["start"] = tracked(ema, ema.tensors)
        update(ema, step)
        records["updates"].append(dict(step=step, rate=ema.rate(step),
                                       params=tracked(ema, ema.params),
                                       ema=tracked(ema, ema.tensors)))

    @contextlib.contextmanager
    def recording_applied(ema):
        with applied(ema):
            params = dict(zip(ema.names, ema.params))
            records["validations"].append(all(
                torch.equal(params[n], e) for n, e in zip(ema.names, ema.tensors)))
            yield

    ParamEMA.update, ParamEMA.applied = recording_update, recording_applied
    try:
        yield records
    finally:
        ParamEMA.update, ParamEMA.applied = update, applied


def ema_recomputation_error(records: dict) -> float:
    """The largest gap of the tracked averages from their float64
    recomputation ``d * e + (1 - d) * p`` chained over the updates, over
    each tensor's largest value."""
    e64 = dict(records["start"])
    worst = 0.0
    for r in records["updates"]:
        d = r["rate"]
        for n in EMA_TRACKED:
            e64[n] = d * e64[n] + (1 - d) * r["params"][n]
            worst = max(worst, float((r["ema"][n] - e64[n]).abs().max() / e64[n].abs().max()))
    return worst


def accumulated_step_check(f32_config: Path) -> str:
    """One float32 step at ``accum_steps=2`` on a b8 loader batch against two
    b4 forward-backwards by hand with the step's draws, averaged: the loss to
    1e-6 relative, every gradient to 1e-5 in relative norm."""
    cfg = Config.fromfile(f32_config)
    model, det_cfg, loader, optimizer = build_train_objects(cfg, "cuda", seed=SEED)
    loss_fn = build_loss_fn(model, det_cfg, rng_seed=SEED)
    batches = prefetch_to_device(loader.iter_batches(), 1, "cuda")
    batch = next(batches)
    batches.close()
    batch.pop("img_meta")
    captured = {}

    def capture(grad_norm):  # in place of the update: the averaged gradients
        captured["grads"] = [p.grad.detach().clone() for p in optimizer.params]

    optimizer.apply = capture
    metrics = make_train_step(loss_fn, optimizer, accum_steps=OPTIONS_ACCUM)(batch)
    if "grads" not in captured:
        raise AssertionError(f"the float32 accumulated step was skipped: {metrics}")
    optimizer.zero_grad()
    losses = []
    for half in split_batch(batch, OPTIONS_ACCUM):
        loss, _ = loss_fn(half, step=0)
        loss.backward()
        losses.append(loss.detach())
    by_hand = (losses[0] + losses[1]) * 0.5
    loss_err = abs(float(metrics["loss"]) - float(by_hand)) / abs(float(by_hand))
    grad_err = 0.0
    for p, g in zip(optimizer.params, captured["grads"]):
        want = p.grad * 0.5
        norm = float(want.norm())
        gap = float((g - want).norm())
        grad_err = max(grad_err, gap / norm if norm else (0.0 if gap == 0 else math.inf))
    text = (f"one float32 b8 step at accum_steps={OPTIONS_ACCUM} against two b4 forward-backwards "
            f"by hand with the step's draws: loss {float(metrics['loss']):.6f}, {loss_err:.2e} "
            f"relative (limit 1e-6); every gradient within {grad_err:.2e} in relative norm (limit "
            f"1e-5)")
    if not (loss_err <= 1e-6 and grad_err <= 1e-5):
        raise AssertionError(text)
    return text


def class_specific_reference(model) -> str:
    """The class-specific RoI losses and their gradient into
    ``bbox_head.reg`` on the card and on the CPU in float32, on the same
    levels and sampled rois (phase 8's small canvas and gts)."""
    det_cfg = build_detection_cfg(Config.fromfile(CONFIG).detection)
    cpu = class_specific_build("meta")  # then the card's weights, not a draw of its own
    cpu.load_state_dict({k: v.detach().cpu() for k, v in model.state_dict().items()},
                        assign=True)
    gen = torch.Generator().manual_seed(SEED + 11)
    x = torch.randn((2, 256, 320, 3), generator=gen)
    gt = dict(gt_boxes=torch.tensor([[[16, 20, 120, 140], [150, 40, 300, 230], [60, 150, 110, 250]],
                                     [[30, 30, 200, 180], [210, 100, 290, 200], [0, 0, 0, 0]]],
                                    dtype=torch.float32),
              gt_labels=torch.tensor([[3, 17, 80], [1, 45, 0]]),
              gt_valid=torch.tensor([[True, True, True], [True, True, False]]))
    with torch.no_grad():
        feats, scores, deltas = model(x.cuda())
    props = generate_proposals(det_cfg.proposal_train, det_cfg.anchor_generator, scores, deltas,
                               torch.tensor([[256.0, 320.0], [240.0, 300.0]], device="cuda"))
    sampled = sample_rois(det_cfg, props.boxes, props.valid, *(v.cuda() for v in gt.values()),
                          same_noise(SEED + 12, "cuda"))
    positives = sampled.labels[sampled.is_pos]
    if len(set(positives.tolist())) < 2:
        raise AssertionError(f"the class-specific check's positives cover only "
                             f"{set(positives.tolist())}")
    strides = det_cfg.roi_strides
    out = {}
    for name, net, device in (("gpu", model, "cuda"), ("cpu", cpu, "cpu")):
        levels = [f.detach().to(device) for f in feats[: len(strides)]]
        s = type(sampled)(*(t.to(device) for t in sampled))
        rois = roi_align.batched_multilevel_roi_align(levels, s.rois, strides)
        cls_l, reg_l = rcnn_losses(det_cfg, *net.roi_forward(rois), s)
        reg = net.bbox_head.reg
        grads = torch.autograd.grad(cls_l + reg_l, [reg.weight, reg.bias])
        out[name] = (torch.stack([cls_l, reg_l]).detach(), grads)
    loss_err = rel_err(out["gpu"][0], out["cpu"][0])
    grad_err = max(rel_err(g, c) for g, c in zip(out["gpu"][1], out["cpu"][1]))
    outputs = model.bbox_head.reg.out_features
    text = (f"class-specific RoI losses (cls, reg) {out['gpu'][0].tolist()} within {loss_err:.2e} "
            f"of the CPU's (limit 1e-3), their gradient into bbox_head.reg ({outputs} outputs) "
            f"within {grad_err:.2e} (limit 1e-3); positives of classes "
            f"{sorted(set(positives.tolist()))}")
    if not (loss_err <= 1e-3 and grad_err <= 1e-3):
        raise AssertionError(text)
    return text


def assigner_on_retina_anchors(card: str) -> str:
    """``MaxIoUAssigner`` with ``gt_max_assign_all=False`` and ignore regions
    (``ignore_iof_thr`` 0.5), and with both rules' other forms, on
    RetinaNet's anchors of 800 x 1216 for 4 images of 20 seeded gts (some
    padding, some copies of one anchor so that gts share a best anchor) and
    5 ignore regions: the card's assignment and labels equal the CPU's."""
    det_cfg = build_detection_cfg(Config.fromfile(RETINA_CONFIG).detection)
    sizes = [(-(-CANVAS[0] // s), -(-CANVAS[1] // s)) for s in det_cfg.anchor_generator.strides]
    anchors = det_cfg.anchor_generator.flat_anchors(sizes, "cpu")
    if anchors.shape[0] != RETINA_ANCHOR_COUNT:
        raise AssertionError(f"{anchors.shape[0]} RetinaNet anchors, expected "
                             f"{RETINA_ANCHOR_COUNT}")
    gen = torch.Generator().manual_seed(SEED + 13)
    b, g = 4, 20
    xy = torch.rand((b, g, 2), generator=gen) * torch.tensor([1100.0, 700.0])
    wh = 16 + torch.rand((b, g, 2), generator=gen) * 300
    gt = torch.cat([xy, xy + wh], -1)
    gt[:, :3] = anchors[torch.randint(0, anchors.shape[0], (b, 1), generator=gen)] + \
        torch.tensor([0.0, 0.0, 2.0, 1.0]) * torch.arange(3.0)[None, :, None]
    valid = torch.arange(g)[None] < torch.tensor([[20], [15], [9], [1]])
    gt = torch.where(valid[..., None], gt, torch.zeros_like(gt))
    labels = torch.where(valid, torch.randint(1, 81, (b, g), generator=gen), 0)
    ig_xy = torch.rand((b, 5, 2), generator=gen) * torch.tensor([1000.0, 600.0])
    ignore = torch.cat([ig_xy, ig_xy + 50 + torch.rand((b, 5, 2), generator=gen) * 150], -1)
    ignore_valid = torch.arange(5)[None].expand(b, 5) < 4
    parts = []
    for assign_all, iof in ((False, 0.5), (True, 0.5), (False, -1.0)):
        assigner = MaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.3,
                                  gt_max_assign_all=assign_all, ignore_iof_thr=iof)
        t0 = time.perf_counter()
        want = assigner(anchors, gt, valid, labels, gt_boxes_ignore=ignore,
                        gt_ignore_valid=ignore_valid)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        args = [t.cuda() for t in (anchors, gt, valid, labels)]
        got = assigner(*args, gt_boxes_ignore=ignore.cuda(), gt_ignore_valid=ignore_valid.cuda())
        gpu_ms = cuda_ms(lambda: assigner(*args, gt_boxes_ignore=ignore.cuda(),
                                          gt_ignore_valid=ignore_valid.cuda()), 5)
        for field in ("assigned_gt_inds", "labels", "max_overlaps"):
            if not torch.equal(getattr(got, field).cpu(), getattr(want, field)):
                raise AssertionError(f"assigner (gt_max_assign_all={assign_all}, ignore_iof_thr="
                                     f"{iof}): the card's {field} differs from the CPU's")
        inds = want.assigned_gt_inds
        counts = [int(n.sum()) for n in (inds > 0, inds == 0, inds < 0)]
        parts.append(f"gt_max_assign_all={assign_all} ignore_iof_thr={iof}: {counts[0]} positive, "
                     f"{counts[1]} negative, {counts[2]} ignored anchors, equal on both; card "
                     f"{gpu_ms:.3f} ms, CPU {cpu_ms:.1f} ms")
    return (f"MaxIoUAssigner on {RETINA_ANCHOR_COUNT} RetinaNet anchors x 4 images x {g} gts "
            f"[{card}]: " + "; ".join(parts))


def matcher_comparison(seen: dict, detections: list, metrics: dict, card: str) -> str:
    """``tools.test``'s scoring of its own detections through the C++
    matchers and through the plain Python ones: the 12 metrics to 1e-12,
    both equal to what ``tools.test`` reported; each matcher's host ms."""
    dataset, num_classes = seen["dataset"], seen["det_cfg"].num_classes
    t0 = time.perf_counter()
    cxx = validate_mod._score(dataset, detections, num_classes, False, False)
    cxx_ms = (time.perf_counter() - t0) * 1e3
    fast = eval_mod._coco_match_img
    eval_mod._coco_match_img = eval_mod._coco_match_img_plain
    try:
        t0 = time.perf_counter()
        plain = validate_mod._score(dataset, detections, num_classes, False, False)
        plain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        eval_mod._coco_match_img = fast
    gap = max(abs(cxx[k] - plain[k]) for k in cxx)
    reported = max(abs(cxx[k] - metrics[k]) for k in metrics)
    text = (f"tools.test's 12 metrics through the C++ matcher and the plain Python one on its "
            f"{sum(len(d['scores']) for d in detections)} detections: within {gap:.1e} of each "
            f"other, {reported:.1e} of the CLI's (limit 1e-12); scoring host ms [{card}, host "
            f"clock]: C++ {cxx_ms:.1f}, Python {plain_ms:.1f}")
    if set(cxx) != set(metrics) or len(cxx) != 12 or not (gap <= 1e-12 and reported <= 1e-12):
        raise AssertionError(text)
    return text


def visualize_check(config: Path, checkpoint: Path, fixtures: tuple, out_dir: Path,
                    segm: bool) -> dict:
    """``tools.visualize`` on ``fixtures``: one PNG an image at its size,
    drawn on; K1 once an image (twice with the masks), K2 never."""
    paths = [str(JPEG_FIXTURES / name) for name in fixtures]
    reset_launches()
    t0 = time.perf_counter()
    written = visualize_cli.main([str(config), str(checkpoint), *paths, "--out-dir", str(out_dir),
                                  "--score-thr", "0"] + (["--segm"] if segm else []))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    expect_launches(f"tools.visualize{' --segm' if segm else ''}", launches,
                    len(paths) * (2 if segm else 1), 0)
    for src, out in zip(paths, written):
        raw, drawn = img_read(src), img_read(out)
        if drawn.shape != raw.shape or not (drawn != raw).any():
            raise AssertionError(f"tools.visualize: {out} is {drawn.shape} for {raw.shape}, or "
                                 "nothing was drawn")
    return dict(launches=launches, wall=wall, files=[Path(p).name for p in written])


def phase_cli_options(card: str) -> dict:
    """The training options through ``tools.train`` on phase 26's folder,
    then ``tools.test`` and ``tools.visualize`` (module docstring, phase
    49)."""
    t_phase = time.perf_counter()
    base = SMOKE_COCO / "faster_rcnn_r50_fpn_smoke.py"
    source = json.loads((SMOKE_COCO / "instances_train.json").read_text())
    keep = {img["id"] for img in source["images"][:OPTIONS_TRAIN_IMAGES]}
    train_ann = SMOKE_COCO / "instances_train_options.json"
    train_ann.write_text(json.dumps(dict(
        source, images=[i for i in source["images"] if i["id"] in keep],
        annotations=[a for a in source["annotations"] if a["image_id"] in keep])))
    config, f32_config = write_options_configs(train_ann, base)
    cfg = Config.fromfile(config)
    work = SMOKE_COCO / "work_options"
    shutil.rmtree(work, ignore_errors=True)

    reset_launches()
    t0 = time.perf_counter()
    with recorded_ema() as ema_records:
        trainer = train_cli.main([str(config)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = len(trainer.dataloader)
    val_batches = -(-CLI_VAL_IMAGES // int(cfg["runtime"].get("val_batch", 8)))
    expect_launches("options training (and its validations)", launches,
                    OPTIONS_EPOCHS * (OPTIONS_ACCUM * steps + val_batches),
                    OPTIONS_EPOCHS * OPTIONS_ACCUM * steps)
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    logged = [r for r in records if "loss" in r]
    vals = [r for r in records if "val_mAP" in r]
    if (len(logged) != OPTIONS_EPOCHS * steps or not all(math.isfinite(r["loss"]) for r in logged)
            or logged[-1]["skipped_steps"] or len(vals) != OPTIONS_EPOCHS):
        raise AssertionError(f"options training: {len(logged)} step records, {len(vals)} "
                             f"validations, or a non-finite loss or a skipped step")
    if ema_records["validations"] != [True] * OPTIONS_EPOCHS:
        raise AssertionError(f"validation did not see the EMA: {ema_records['validations']}")
    ema_err = ema_recomputation_error(ema_records)
    total = OPTIONS_EPOCHS * steps
    lr_err = max(abs(r["lr"] - cosine_lr(r["step"], cfg["optimizer"]["lr"], total))
                 / cosine_lr(r["step"], cfg["optimizer"]["lr"], total) for r in logged)
    if not (ema_err <= 1e-6 and lr_err <= 1e-12):
        raise AssertionError(f"options training: the EMA {ema_err} from its float64 "
                             f"recomputation, or the learning rate {lr_err} from the cosine")
    reg = trainer.model.bbox_head.reg
    ms = [cfg["data"]["sample_per_replica"] / r["images_per_sec"] * 1e3 for r in logged]
    log(f"cli options training [{card}]: {steps} steps an epoch of b"
        f"{cfg['data']['sample_per_replica']} on {tuple(cfg['data']['canvas'])} at accum_steps="
        f"{OPTIONS_ACCUM} (two b4 micro-batches a step), ema_decay {OPTIONS_EMA}, cosine to "
        f"{OPTIONS_MIN_LR_RATIO} over {total} steps, class-specific regression ({reg.out_features} "
        f"outputs); {OPTIONS_EPOCHS} epochs in {wall:.1f} s with a validation of the EMA each "
        f"epoch; launches {launches} (K1 and K2 {OPTIONS_ACCUM} a step, K1 {val_batches} a "
        f"validation); ms a step {[round(m, 1) for m in ms]}; learning rates "
        f"{[round(r['lr'], 8) for r in logged]} within {lr_err:.1e} of the cosine (limit 1e-12); "
        f"the EMA of {len(EMA_TRACKED)} tensors over {len(ema_records['updates'])} updates within "
        f"{ema_err:.1e} of its float64 recomputation (limit 1e-6); val mAP "
        f"{[r['val_mAP'] for r in vals]}; losses first {logged[0]['loss']:.4f}, last "
        f"{logged[-1]['loss']:.4f}")
    log(class_specific_reference(_f32_copy(trainer.model)))
    del trainer
    log(accumulated_step_check(f32_config))

    # the resume from epoch_1: the optimizer's state and the EMA load bit for bit, the run goes on
    saved = load_checkpoint_file(str(work / "epoch_1"))
    model, _, _, optimizer = build_train_objects(cfg, "cuda", seed=SEED)
    optimizer.ema = ParamEMA(model, OPTIONS_EMA)
    meta = load_checkpoint(model, str(work / "epoch_1"), strict=True, optimizer=optimizer)
    equal_state("the resumed optimizer", optimizer_state(model, optimizer), saved["optimizer"])
    equal_state("the resumed EMA", optimizer.ema.state_dict(), saved["ema"])
    del model, optimizer
    resumed = train_cli.main([str(config), "--work-dir", str(SMOKE_COCO / "work_options_resumed"),
                              "--resume", str(work / "epoch_1")])
    got_steps, want_steps = [r for r in resumed.history if "loss" in r], logged[steps:]
    if [r["step"] for r in got_steps] != [r["step"] for r in want_steps] or \
            got_steps[0]["step"] != meta["step"] + 1:
        raise AssertionError(f"options resume: steps {[r['step'] for r in got_steps]}")
    rel = max(abs(g["loss"] - w["loss"]) / abs(w["loss"]) for g, w in zip(got_steps, want_steps))
    if any(g["lr"] != w["lr"] for g, w in zip(got_steps, want_steps)) or not rel <= 1e-3:
        raise AssertionError(f"options resume: learning rates or losses ({rel}) part from the "
                             "straight run's")
    log(f"cli options resume from epoch_1: the optimizer's state and the EMA loaded bit for bit; "
        f"steps {got_steps[0]['step']}-{got_steps[-1]['step']} at the straight run's learning "
        f"rates; losses within {rel:.2e} relative (limit 1e-3)")
    del resumed

    # tools.test on epoch_2 (the parameters, not the EMA), the matchers on its detections
    out = SMOKE_COCO / "results_options.pkl"
    reset_launches()
    with recorded_evaluation() as seen:
        metrics = test_cli.main([str(config), str(work / f"epoch_{OPTIONS_EPOCHS}"),
                                 "--out", str(out)])
    torch.cuda.synchronize()
    test_launches = read_launches()
    expect_launches("options test", test_launches, -(-CLI_VAL_IMAGES // 8), 0)
    served = seen["model"].state_dict()
    equal_state(f"the tools.test model against epoch_{OPTIONS_EPOCHS}'s parameters", served,
                {k: v.to(served[k].dtype) for k, v in load_checkpoint_file(
                    str(work / f"epoch_{OPTIONS_EPOCHS}"))["model"].items()})
    log(matcher_comparison(seen, load(str(out)), metrics, card))
    del seen

    log(assigner_on_retina_anchors(card))

    vis = visualize_check(config, work / f"epoch_{OPTIONS_EPOCHS}", VIS_FIXTURES,
                          SMOKE_COCO / "vis", segm=False)
    vis_segm = visualize_check(SMOKE_COCO_MASKS / "mask_rcnn_r50_fpn_smoke.py",
                               SMOKE_COCO_MASKS / "work" / f"epoch_{CLI_MASK_EPOCHS}",
                               VIS_SEGM_FIXTURES, SMOKE_COCO_MASKS / "vis", segm=True)
    log(f"tools.visualize [{card}]: {vis['files']} in {vis['wall']:.1f} s, launches "
        f"{vis['launches']}; --segm (Mask R-CNN, phase 27's epoch_{CLI_MASK_EPOCHS}) "
        f"{vis_segm['files']} in {vis_segm['wall']:.1f} s, launches {vis_segm['launches']}; each "
        f"PNG decodes at its image's size, drawn on")
    log(f"cli options phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(training=launches, test=test_launches, visualize=vis["launches"],
                visualize_segm=vis_segm["launches"])


def yaml_present() -> bool:
    """Whether PyYAML imports here."""
    try:
        import yaml  # noqa: F401
    except ImportError:
        return False
    return True


def format_children(options: Path, dumps: dict) -> dict:
    """One epoch's config in each format over the options config: float32,
    ``accum_steps`` 1, no validation, its own work dir. The ``.py`` and json
    children take the options ``.py`` file as ``_base_``; the yaml child,
    where PyYAML is present, takes the options json dump."""
    def runtime(fmt: str) -> dict:
        return dict(compute_dtype="float32", accum_steps=1, val_interval_epochs=0,
                    work_dir=str(SMOKE_COCO / f"work_formats_{fmt}"))

    children = {"py": SMOKE_COCO / "faster_rcnn_r50_fpn_formats.py",
                "json": SMOKE_COCO / "faster_rcnn_r50_fpn_formats.json"}
    children["py"].write_text(f"_base_ = {str(options)!r}\nruntime = {runtime('py')!r}\n")
    dump({"_base_": str(options), "runtime": runtime("json")}, str(children["json"]))
    if "yaml" in dumps:
        children["yaml"] = SMOKE_COCO / "faster_rcnn_r50_fpn_formats.yaml"
        dump({"_base_": str(dumps["json"]), "runtime": runtime("yaml")}, str(children["yaml"]))
    return children


def phase_cli_config_formats(card: str) -> dict:
    """Full-width Faster R-CNN R50-FPN through the CLIs from json and yaml
    configs (module docstring, phase 51), on phase 49's options config and
    its ``work_options/epoch_2``."""
    t_phase = time.perf_counter()
    options = SMOKE_COCO / "faster_rcnn_r50_fpn_options.py"
    cfg = Config.fromfile(options)
    have_yaml = yaml_present()
    dumps = {}
    for fmt in ("json", "yaml"):
        path = SMOKE_COCO / f"faster_rcnn_r50_fpn_options.{fmt}"
        if fmt == "yaml" and not have_yaml:
            path.write_text("a: 1\n")
            try:
                Config.fromfile(path)
            except ImportError as e:
                if "PyYAML" not in str(e) or path.name not in str(e):
                    raise
                log(f"cli formats: PyYAML does not import; Config.fromfile of a yaml "
                    f"file raises the named ImportError: {e}")
                continue
            raise AssertionError("a yaml config loaded without PyYAML")
        cfg.dump(path)
        if _to_plain(Config.fromfile(path)) != _to_plain(cfg):
            raise AssertionError(f"cli formats: the {fmt} dump of the options config reads back "
                                 "to another tree")
        dumps[fmt] = path
    log(f"cli formats: PyYAML {'present' if have_yaml else 'absent'}; the options config "
        f"dumped to {sorted(dumps)} reads back to the .py file's tree as plain dicts")

    # one epoch of tools.train from each format's child config, and from the
    # .py one again: its later losses against the first .py run's are the
    # card's own run-to-run spread, beside which the formats' are read
    children = format_children(options, dumps)
    trained = {}
    for fmt, path in [*children.items(), ("py again", children["py"])]:
        again = ["--work-dir", str(SMOKE_COCO / "work_formats_py_again")] if " " in fmt else []
        reset_launches()
        t0 = time.perf_counter()
        trainer = train_cli.main([str(path), "--epochs", "1", *again])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        steps = len(trainer.dataloader)
        expect_launches(f"cli formats training from {fmt}", launches, steps, steps)
        losses = [r["loss"] for r in trainer.history if "loss" in r]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"cli formats training from {fmt}: losses {losses}")
        trained[fmt] = dict(launches=launches, losses=losses, wall=wall, steps=steps)
        del trainer
    want = trained["py"]["losses"]
    gaps = {fmt: abs(t["losses"][0] - want[0]) / abs(want[0]) for fmt, t in trained.items()}
    for fmt, t in trained.items():
        later = max(abs(g - w) / abs(w) for g, w in zip(t["losses"][1:], want[1:]))
        log(f"cli formats training from the {fmt} config [{card}]: {t['steps']} steps of b"
            f"{cfg['data']['sample_per_replica']} in {t['wall']:.1f} s (the build and checkpoint "
            f"included), float32, launches {t['launches']} (K1 and K2 once a step); losses "
            f"{[round(v, 6) for v in t['losses']]}; first loss {gaps[fmt]:.1e} relative from the "
            f".py run's (limit 1e-6), later losses up to {later:.1e}")
    if not all(gap <= 1e-6 for gap in gaps.values()):
        raise AssertionError(f"cli formats: first losses part from the .py run's: {gaps}")

    # tools.test on epoch_2 of the options run from each format, float32
    checkpoint = SMOKE_COCO / "work_options" / f"epoch_{OPTIONS_EPOCHS}"
    tested = {}
    for fmt, path in children.items():
        out = SMOKE_COCO / f"results_formats_{fmt}.json"
        reset_launches()
        metrics = test_cli.main([str(path), str(checkpoint), "--out", str(out)])
        torch.cuda.synchronize()
        launches = read_launches()
        expect_launches(f"cli formats test from {fmt}", launches, -(-CLI_VAL_IMAGES // 8), 0)
        tested[fmt] = dict(metrics=metrics, results=load(str(out)), launches=launches)
    want = tested["py"]
    for fmt, t in tested.items():
        same = t["results"] == want["results"] and t["metrics"] == want["metrics"]
        metric_gap = max(abs(t["metrics"][k] - want["metrics"][k]) for k in want["metrics"])
        kept, found = match_detections(t["results"], want["results"])
        log(f"cli formats test from {children[fmt].name} [{card}]: {len(t['results'])} "
            f"detections, launches {t['launches']}; "
            + ("detections and metrics bit for bit the .py run's" if same else
               f"{kept:.4f} of its detections have a partner in the .py run's and {found:.4f} "
               f"the other way (boxes within 1 px, scores within 2%), the 12 metrics within "
               f"{metric_gap:.2e}")
            + f"; mAP {t['metrics']['mAP']:.6f}")
        if not (same or (kept == 1.0 and found == 1.0 and metric_gap <= 1e-6)):
            raise AssertionError(f"cli formats: tools.test from {fmt} gives other detections")
    log(f"cli formats phase: {time.perf_counter() - t_phase:.1f} s")
    trained = {fmt.replace(" ", "_"): t for fmt, t in trained.items()}
    return dict(yaml=have_yaml, **{f"training_{fmt}": t["launches"] for fmt, t in trained.items()},
                **{f"test_{fmt}": t["launches"] for fmt, t in tested.items()})


def class_specific_build(device):
    """The slice's detector with a class-specific box head, float32, in
    train mode, its weights not drawn (``load_state_dict(assign=True)``
    gives it some)."""
    cfg = Config.fromfile(CONFIG)
    with unittest.mock.patch("torch_detection_tpu_torch.builder.init_weights"):
        return build_detector(dict(cfg.model, bbox_head=dict(cfg.model["bbox_head"],
                                                             reg_class_agnostic=False)),
                              "float32", device).train()


def _f32_copy(model):
    """A float32-compute copy of a training build (float32 parameters) on
    the card, for the class-specific check against the CPU."""
    copy = class_specific_build("meta")
    copy.load_state_dict({k: v.detach().clone() for k, v in model.state_dict().items()},
                         assign=True)
    return copy


JPEG_FIXTURES = ROOT / "tests" / "torch_jpeg"
JPEG_TIMED = "landscape_640x480_0.jpg"  # 4:2:0, cv2's default sampling
VOC_CONFIG = ROOT / "configs" / "retinanet_r101_fpn_voc.py"
VOC_SIZES = CLI_SIZES + ((500, 333),)  # COCO's landscape and square sizes, and VOC's
SMOKE_VOC = ROOT / "build" / "smoke_voc"
VOC_TRAIN_IMAGES, VOC_TEST_IMAGES, VOC_EPOCHS = 32, 8, 2
SMOKE_COCO_JPEG = ROOT / "build" / "smoke_coco_jpeg"
FAST_TRAIN_IMAGES, FAST_VAL_IMAGES, FAST_EPOCHS, FAST_TOP_K = 32, 8, 2, 1000
# 612 x 612 images of a training split: square images form an aspect group
# of their own, so eight of them fill one batch and the split 4 batches of 8
SQUARES = 8


def median_ms(fn, n: int = 20) -> float:
    """Median host milliseconds of ``n`` calls after one warm-up call."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_jpeg(card: str) -> dict:
    """The port's JPEG decoder: built with g++ from ``native/jpeg.cpp``,
    every committed fixture decoded to the shape and sha256 of cv2's array
    in the manifest (each refused file refused by its kind), and a 640 x 480
    4:2:0 file's decode timed beside the port's PNG decode of its pixels."""
    t0 = time.perf_counter()
    native.build("jpeg")
    build_s = time.perf_counter() - t0
    manifest = json.loads((JPEG_FIXTURES / "manifest.json").read_text())
    refused = {}
    for name, entry in sorted(manifest.items()):
        path = str(JPEG_FIXTURES / name)
        if entry["refused"]:
            try:
                jpeg_read(path)
            except ValueError as e:
                if entry["refused"] not in str(e):
                    raise AssertionError(f"jpeg {name}: refused as {e!r}, not as {entry['refused']}")
                refused[name] = str(e)
                continue
            raise AssertionError(f"jpeg {name}: decoded; its manifest says {entry['refused']}")
        img = jpeg_read(path)
        if (list(img.shape) != entry["shape"]
                or hashlib.sha256(img.tobytes()).hexdigest() != entry["sha256"]):
            raise AssertionError(f"jpeg {name}: shape {img.shape} or sha256 differs from cv2's")
    log(f"jpeg: native/jpeg.cpp built by g++ in {build_s:.2f} s "
        f"({'built now' if 'jpeg' in native.BUILD_SECONDS else 'already built'}); "
        f"{len(manifest) - len(refused)} committed fixtures decoded to cv2's shape and sha256; "
        f"{len(refused)} refused by kind: " + "; ".join(f"{k}: {v}" for k, v in refused.items()))
    path = JPEG_FIXTURES / JPEG_TIMED
    rgb = img_read(str(path))
    png = ROOT / "build" / "smoke_jpeg_timed.png"
    png.write_bytes(png_encode(rgb))
    if not np.array_equal(img_read(str(png)), rgb):
        raise AssertionError("the PNG of the timed JPEG's pixels does not decode to them")
    jpeg_ms = median_ms(lambda: img_read(str(path)))
    png_ms = median_ms(lambda: img_read(str(png)))
    log(f"jpeg decode [{card}, host clock, img_read from the file, median of 20]: {JPEG_TIMED} "
        f"({rgb.shape[1]}x{rgb.shape[0]}, 4:2:0, {path.stat().st_size} bytes) {jpeg_ms:.3f} ms an "
        f"image; the port's PNG decode of the same pixels ({png.stat().st_size} bytes, zlib "
        f"level 1, filter 0) {png_ms:.3f} ms")
    return dict(build_s=build_s, decode_ms=jpeg_ms, png_ms=png_ms)


def fixture_size(path: Path) -> tuple:
    """(w, h) from a committed fixture's name, ``<kind>_<w>x<h>[_<i>].jpg``."""
    w, h = path.stem.split("_")[1].split("x")
    return int(w), int(h)


def pick_fixtures(rng, sizes, n: int, squares: int) -> list:
    """``n`` committed landscape fixtures of ``sizes`` in a seeded order,
    ``squares`` of them 612 x 612, the rest drawn from the other sizes."""
    square = sorted(JPEG_FIXTURES.glob("landscape_612x612_*.jpg"))
    others = sorted(p for w, h in sizes if (w, h) != (612, 612)
                    for p in JPEG_FIXTURES.glob(f"landscape_{w}x{h}_*.jpg"))
    picks = ([square[i % len(square)] for i in range(squares)]
             + [others[int(i)] for i in rng.integers(0, len(others), n - squares)])
    return [picks[int(i)] for i in rng.permutation(n)]


def seeded_boxes(rng, w: int, h: int, n: int) -> list:
    """``n`` (x, y, bw, bh) boxes inside a w x h frame, 16 pixels to half
    the frame on a side."""
    out = []
    for _ in range(n):
        bw, bh = int(rng.integers(16, w // 2)), int(rng.integers(16, h // 2))
        out.append((int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh)), bw, bh))
    return out


def write_smoke_voc(root: Path, picks: list, n_train: int, seed: int) -> dict:
    """A VOC2007 folder: ``picks`` copied into ``JPEGImages/`` under seeded
    names, ``Annotations/*.xml`` with 1-20 objects over the 20 classes (every
    fifth difficult, 1-based pixel indices), the first ``n_train`` listed in
    ``ImageSets/Main/trainval.txt`` and the rest in ``test.txt``; returns the
    objects' counts."""
    rng = np.random.default_rng(seed)
    for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    names = [f"{int(i):06d}" for i in rng.choice(1_000_000, len(picks), replace=False)]
    counts = collections.Counter()
    for name, src in zip(names, picks):
        shutil.copyfile(src, root / "JPEGImages" / f"{name}.jpg")
        w, h = fixture_size(src)
        objects = []
        for x, y, bw, bh in seeded_boxes(rng, w, h, int(rng.integers(1, 21))):
            difficult = sum(counts.values()) % 5 == 4
            counts["difficult" if difficult else "objects"] += 1
            objects.append(f"<object><name>{VOC_CLASSES[int(rng.integers(0, 20))]}</name>"
                           f"<difficult>{int(difficult)}</difficult><bndbox><xmin>{x + 1}</xmin>"
                           f"<ymin>{y + 1}</ymin><xmax>{x + bw}</xmax><ymax>{y + bh}</ymax>"
                           "</bndbox></object>")
        (root / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><filename>{name}.jpg</filename><size><width>{w}</width><height>{h}"
            f"</height><depth>3</depth></size>{''.join(objects)}</annotation>")
    (root / "ImageSets/Main/trainval.txt").write_text("\n".join(names[:n_train]) + "\n")
    (root / "ImageSets/Main/test.txt").write_text("\n".join(names[n_train:]) + "\n")
    return dict(counts)


def write_smoke_voc_config(root: Path, name: str, **runtime) -> Path:
    """A config whose ``_base_`` is the RetinaNet R101-FPN VOC config, with
    the dataset root, the cache dir, the work dir, the warmup, the log
    interval and ``score_thr`` (0, so that random weights leave detections)
    overridden, and ``runtime`` added."""
    path = SMOKE_VOC / f"{name}.py"
    data = dict(dataset_root=f"{root}/", cache_dir=str(root / "cache"))
    runtime = dict(work_dir=str(SMOKE_VOC / "work"), log_interval=1, **runtime)
    path.write_text(f"_base_ = {str(VOC_CONFIG)!r}\n"
                    f"data = dict(train=dict(**{data!r}), val=dict(**{data!r}))\n"
                    "detection = dict(score_thr=0.0)\n"
                    "schedule = dict(warmup_steps=100)\n"
                    f"runtime = dict(**{runtime!r})\n")
    return path


def phase_cli_voc(card: str) -> dict:
    """RetinaNet R101-FPN on Pascal VOC through the entry points at full
    width: a seeded VOC2007 folder of the committed JPEG fixtures,
    ``tools.train`` refusing a portrait VOC image (R10), two epochs with VOC
    validation after each (``runtime.val_voc_metric``), ``tools.test
    --voc-metric --out``, and the gt oracle under both VOC metrics."""
    shutil.rmtree(SMOKE_VOC, ignore_errors=True)
    rng = np.random.default_rng(SEED + 110)
    root = SMOKE_VOC / "VOC2007"
    picks = (pick_fixtures(rng, VOC_SIZES, VOC_TRAIN_IMAGES, SQUARES)
             + pick_fixtures(rng, VOC_SIZES, VOC_TEST_IMAGES, 2))
    counts = write_smoke_voc(root, picks, VOC_TRAIN_IMAGES, SEED + 111)
    config = write_smoke_voc_config(root, "retinanet_r101_fpn_voc_smoke", val_interval_epochs=1,
                                    val_voc_metric=True)
    cfg = Config.fromfile(config)
    log(f"cli voc: {VOC_TRAIN_IMAGES} trainval and {VOC_TEST_IMAGES} test JPEGs from the committed "
        f"fixtures of {VOC_SIZES} in {root}, objects {counts}; config {config.name}")
    host = host_data_costs(cfg, card, "cli voc")

    # R10 pinned: the VOC config's canvas holds no portrait VOC image
    portrait_root = SMOKE_VOC / "portrait" / "VOC2007"
    write_smoke_voc(portrait_root, [JPEG_FIXTURES / "portrait_375x500.jpg"] * 2, 1, SEED + 112)
    portrait = write_smoke_voc_config(portrait_root, "retinanet_r101_fpn_voc_smoke_portrait")
    try:
        train_cli.main([str(portrait), "--epochs", "1", "--work-dir", str(SMOKE_VOC / "work_portrait")])
    except ValueError as e:
        if "canvas" not in str(e):
            raise
        log(f"cli voc training on a 375x500 portrait VOC image (R10): refused as expected: {e}")
    else:
        raise AssertionError("cli voc training on a portrait image: no R10 ValueError; if the "
                             "canvas now holds it, R10 is repaired and this pin goes")

    work = SMOKE_VOC / "work"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer = train_cli.main([str(config), "--epochs", str(VOC_EPOCHS), "--work-dir", str(work)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    expect_launches("cli voc training and validation", launches, 0, 0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = len(trainer.dataloader)
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    step_records = [r for r in records if "loss" in r]
    vals = [r for r in records if "val_mAP" in r]
    if (steps != VOC_TRAIN_IMAGES // 8 or len(step_records) != VOC_EPOCHS * steps
            or not all(math.isfinite(r["loss"]) for r in step_records)
            or step_records[-1]["skipped_steps"]):
        raise AssertionError(f"cli voc training: {steps} steps an epoch, {len(step_records)} step "
                             f"records, or a non-finite loss or a skipped step")
    if (len(vals) != VOC_EPOCHS or not all(math.isfinite(r["val_mAP"]) for r in vals)
            or any(k.startswith("val_AP") for r in vals for k in r)):
        raise AssertionError(f"cli voc validation records {vals}")
    batch_size = cfg["data"]["sample_per_replica"]
    ips, step_ms = epoch_rate(records, VOC_EPOCHS - 1, batch_size)
    wait_ms = trainer.loader_wait_s / len(step_records) * 1e3
    log(f"cli voc training [{card}]: {steps} steps an epoch at b{batch_size} on "
        f"{tuple(cfg['data']['canvas'])}, {VOC_EPOCHS} epochs with VOC validation after each in "
        f"{wall:.1f} s (the build, checkpoints and validation included); launches {launches}; "
        f"epoch {VOC_EPOCHS} ms a step {[round(m, 1) for m in step_ms]}; images/s over all of "
        f"epoch {VOC_EPOCHS} from the trainer's log {ips:.2f}; the trainer's wait on the loader "
        f"{wait_ms:.1f} ms a step; peak memory {peak:.2f} GiB; validation "
        + ", ".join(f"epoch {int(r['epoch']) + 1} VOC07 mAP {r['val_mAP']:.6f}" for r in vals)
        + "; losses first " + ", ".join(f"{k} {step_records[0][k]:.4f}" for k in RETINA_LOSS_KEYS)
        + "; last " + ", ".join(f"{k} {step_records[-1][k]:.4f}" for k in RETINA_LOSS_KEYS))
    profile = loader_fed_profile(trainer, VOC_EPOCHS, statistics.median(step_ms), card,
                                 "CLI VOC training step")
    del trainer, profile["batch"]

    out = SMOKE_VOC / "detections.pkl"
    reset_launches()
    t0 = time.perf_counter()
    metrics = test_cli.main([str(config), str(work / f"epoch_{VOC_EPOCHS}"), "--voc-metric",
                             "--out", str(out)])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = read_launches()
    expect_launches("cli voc test", test_launches, 0, 0)
    if set(metrics) != {"mAP"} or not math.isfinite(metrics["mAP"]):
        raise AssertionError(f"cli voc test metrics {metrics}")
    val = get_datasets(dict(cfg["data"]["val"]))
    anns = [val.get_ann_info(i) for i in range(len(val))]
    dets = load(str(out))
    again = eval_voc_map(dets, anns, len(VOC_CLASSES), use_07_metric=True)["mAP"]
    oracle = [dict(boxes=a["bboxes"], scores=np.ones(len(a["bboxes"])), labels=a["labels"])
              for a in anns]
    oracle_maps = [eval_voc_map(oracle, anns, len(VOC_CLASSES), use_07_metric=m)["mAP"]
                   for m in (True, False)]
    log(f"cli voc test --voc-metric [{card}]: {len(dets)} images in {test_s:.1f} s (the build "
        f"included), launches {test_launches}, {sum(len(d['boxes']) for d in dets)} detections; "
        f"VOC07 mAP {metrics['mAP']:.6f}, eval_voc_map on the dumped pkl {again:.6f} (difference "
        f"{abs(again - metrics['mAP']):.1e}, limit 1e-12); the test gts as detections: 11-point "
        f"mAP {oracle_maps[0]:.6f}, all-point {oracle_maps[1]:.6f}, "
        f"{sum(len(a['bboxes_ignore']) for a in anns)} difficult objects ignored")
    if abs(again - metrics["mAP"]) > 1e-12 or any(abs(m - 1.0) > 1e-12 for m in oracle_maps):
        raise AssertionError("the dumped VOC detections do not give the CLI's mAP, or the gt "
                             "oracle does not score 1.0")
    return dict(training=launches, test=test_launches, images_per_s=ips, wait_ms=wait_ms,
                peak_gib=peak, host=host, profile=profile)


def write_smoke_coco_jpeg(split: str, picks: list, seed: int) -> Path:
    """The committed fixtures ``picks`` under ``SMOKE_COCO_JPEG/split`` and
    their instances JSON with the CLI path's seeded annotations: 1-20 boxes
    an image over COCO's category ids, a crowd box in every fourth image."""
    rng = np.random.default_rng(seed)
    img_dir = SMOKE_COCO_JPEG / split
    img_dir.mkdir(parents=True, exist_ok=True)
    images, annotations = [], []
    for i, src in enumerate(picks):
        w, h = fixture_size(src)
        name = f"{i + 1:012d}.jpg"
        shutil.copyfile(src, img_dir / name)
        boxes = int(rng.integers(1, 21))
        for j, (x, y, bw, bh) in enumerate(seeded_boxes(rng, w, h, boxes + (i % 4 == 3))):
            annotations.append(dict(id=len(annotations) + 1, image_id=i + 1,
                                    category_id=int(rng.choice(COCO_CATEGORY_IDS)),
                                    bbox=[x, y, bw, bh], area=bw * bh, iscrowd=int(j == boxes)))
        images.append(dict(id=i + 1, file_name=name, width=w, height=h))
    ann_file = SMOKE_COCO_JPEG / f"instances_{split}.json"
    ann_file.write_text(json.dumps(dict(
        images=images, annotations=annotations,
        categories=[dict(id=c, name=f"category_{c}") for c in COCO_CATEGORY_IDS])))
    return ann_file


def write_smoke_fast_configs(train_ann: Path, val_ann: Path, pkls: dict) -> tuple:
    """The Faster R-CNN config on the JPEG folder (its data paths alone
    overridden), and the Fast R-CNN config on the same folder with the
    dumped proposals, ``score_thr`` 0, the warmup and the log interval."""
    data = {split: dict(ann_file=str(ann), img_prefix=str(SMOKE_COCO_JPEG / split))
            for split, ann in (("train", train_ann), ("val", val_ann))}
    faster = SMOKE_COCO_JPEG / "faster_rcnn_r50_fpn_jpeg.py"
    faster.write_text(f"_base_ = {str(CONFIG)!r}\ndata = dict(**{data!r})\n")
    fast = SMOKE_COCO_JPEG / "fast_rcnn_r50_fpn_jpeg.py"
    fast_data = {split: dict(d, proposal_file=str(pkls[split])) for split, d in data.items()}
    fast.write_text(f"_base_ = {str(FAST_CONFIG)!r}\ndata = dict(**{fast_data!r})\n"
                    "detection = dict(score_thr=0.0)\n"
                    "schedule = dict(warmup_steps=100)\n"
                    f"runtime = dict(work_dir={str(SMOKE_COCO_JPEG / 'work')!r}, log_interval=1)\n")
    return faster, fast


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, M) IoU of xyxy boxes with the inclusive +1 pixel rule."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    inter = np.prod(np.clip(rb - lt + 1, 0, None), axis=-1)
    area = lambda x: (x[:, 2] - x[:, 0] + 1) * (x[:, 3] - x[:, 1] + 1)
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def check_proposals(split: str, props: list, ann_file: Path) -> None:
    """Each image's proposals: (n, 5) float32 with 0 < n <= the top-k, inside
    the original frame, scores in non-increasing order."""
    frames = [(img["width"], img["height"]) for img in
              sorted(json.loads(ann_file.read_text())["images"], key=lambda i: i["id"])]
    if len(props) != len(frames):
        raise AssertionError(f"cli fast dump {split}: {len(props)} images of {len(frames)}")
    for p, (w, h) in zip(props, frames):
        if not (p.dtype == np.float32 and p.ndim == 2 and p.shape[1] == 5
                and 0 < len(p) <= FAST_TOP_K and (p[:, :4] >= 0).all()
                and (p[:, [0, 2]] <= w).all() and (p[:, [1, 3]] <= h).all()
                and (np.diff(p[:, 4]) <= 0).all()):
            raise AssertionError(f"cli fast dump {split}: a slate of shape {p.shape} outside its "
                                 f"{w}x{h} frame or out of order")


def dump_agreement(faster: Path, checkpoint: Path, card_bf16: list, card: str) -> dict:
    """The card's dump of the first 8 val images against a ``--device cpu``
    dump of the same checkpoint, in the config's bf16 and in float32 on both
    devices: for each, the share of the card's proposals with a CPU partner
    at IoU >= 0.99 and the share the other way. The bf16 dumps part further:
    the two devices' bf16 convolutions round apart, and the top-k and NMS
    cuts carry a score's rounding into which boxes are kept, so the float32
    pair is the one held to 0.95, as every GPU-against-CPU check of this
    script runs in float32."""
    faster32 = SMOKE_COCO_JPEG / "faster_rcnn_r50_fpn_jpeg_float32.py"
    faster32.write_text(f"_base_ = {str(faster)!r}\nruntime = dict(compute_dtype='float32')\n")
    shares, seconds = {}, {}
    for dtype, config in (("bfloat16", faster), ("float32", faster32)):
        argv = [str(config), str(checkpoint), "--split", "val", "--top-k", str(FAST_TOP_K),
                "--max-images", "8"]
        got = card_bf16 if dtype == "bfloat16" else dump_cli.main(
            argv + ["--out", str(SMOKE_COCO_JPEG / f"proposals_val_{dtype}.pkl")])
        t0 = time.perf_counter()
        cpu = dump_cli.main(argv + ["--out", str(SMOKE_COCO_JPEG / f"proposals_val_{dtype}_cpu.pkl"),
                                    "--device", "cpu"])
        seconds[dtype] = time.perf_counter() - t0
        hits, totals = np.zeros(2), np.zeros(2)
        for card_p, cpu_p in zip(got, cpu, strict=True):
            iou = box_iou(card_p[:, :4].astype(np.float64), cpu_p[:, :4].astype(np.float64))
            hits += [(iou.max(1) >= 0.99).sum(), (iou.max(0) >= 0.99).sum()]
            totals += iou.shape
        shares[dtype] = hits / totals
    log(f"cli fast dump against a CPU dump of the first 8 val images [{card}]: "
        + "; ".join(f"{dtype} on both ({seconds[dtype]:.1f} s on the CPU): {sh[0]:.4f} of the "
                    f"card's proposals have a CPU partner at IoU >= 0.99 and {sh[1]:.4f} the "
                    "other way" for dtype, sh in shares.items())
        + " (limit 0.95 in float32)")
    return shares


def cli_fast_kernels(model, det_cfg, batch) -> dict:
    """K1 and K2 on one Fast R-CNN training batch's own levels and its slate
    sampled from the dumped proposals (512 an image)."""
    noise = functools.partial(sampling_noise, torch.Generator(device="cuda").manual_seed(SEED + 61))
    feats = model(batch["image"])
    sampled = sample_rois(det_cfg, batch["proposals"][..., :4].float(), batch["proposal_valid"],
                          batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"], noise)
    return slate_kernels("a CLI Fast R-CNN training batch", model, det_cfg, feats, sampled)


def phase_cli_fast(card: str, checkpoint: Path) -> dict:
    """The Fast R-CNN proposal workflow through the entry points at full
    width, on a seeded COCO folder of the committed JPEG fixtures:
    ``tools.dump_proposals`` of a Faster R-CNN checkpoint (``phase_cli``'s
    ``epoch_2``) over both splits, the card's dump against a CPU dump, two
    epochs of Fast R-CNN R50-FPN on the dumped proposals, ``tools.test`` on
    the val pkl, and K1 and K2 on the path's own batches."""
    shutil.rmtree(SMOKE_COCO_JPEG, ignore_errors=True)
    rng = np.random.default_rng(SEED + 120)
    train_ann = write_smoke_coco_jpeg("train", pick_fixtures(rng, CLI_SIZES, FAST_TRAIN_IMAGES,
                                                             SQUARES), SEED + 121)
    val_ann = write_smoke_coco_jpeg("val", pick_fixtures(rng, CLI_SIZES, FAST_VAL_IMAGES, 2),
                                    SEED + 122)
    pkls = {split: SMOKE_COCO_JPEG / f"proposals_{split}.pkl" for split in ("train", "val")}
    faster, fast = write_smoke_fast_configs(train_ann, val_ann, pkls)
    log(f"cli fast: {FAST_TRAIN_IMAGES} train and {FAST_VAL_IMAGES} val JPEGs from the committed "
        f"fixtures of {CLI_SIZES} with their instances JSONs; configs {faster.name}, {fast.name}")

    dump_s, dumps = {}, {}
    reset_launches()
    for split, ann in (("val", val_ann), ("train", train_ann)):
        t0 = time.perf_counter()
        dumps[split] = dump_cli.main([str(faster), str(checkpoint), "--split", split, "--out",
                                      str(pkls[split]), "--top-k", str(FAST_TOP_K)])
        torch.cuda.synchronize()
        dump_s[split] = time.perf_counter() - t0
        check_proposals(split, dumps[split], ann)
    dump_launches = read_launches()
    expect_launches("cli fast dumps", dump_launches, 0, 0)
    # the build and the checkpoint's load cancel in the difference of the two runs
    dump_ms = (dump_s["train"] - dump_s["val"]) / (FAST_TRAIN_IMAGES - FAST_VAL_IMAGES) * 1e3
    counts = [len(p) for p in dumps["train"] + dumps["val"]]
    log(f"cli fast dump_proposals [{card}]: val {FAST_VAL_IMAGES} images in {dump_s['val']:.1f} s, "
        f"train {FAST_TRAIN_IMAGES} in {dump_s['train']:.1f} s (the build and the checkpoint's "
        f"load included), {dump_ms:.1f} ms an image from their difference; proposals an image "
        f"min {min(counts)} max {max(counts)}, each slate inside its frame with scores in order; "
        f"launches {dump_launches}")
    shares = dump_agreement(faster, checkpoint, dumps["val"][:8], card)
    if not (shares["float32"] >= 0.95).all():
        raise AssertionError("the card's float32 proposals part from the CPU's")

    cfg = Config.fromfile(fast)
    det_cfg = build_detection_cfg(cfg["detection"])
    work = SMOKE_COCO_JPEG / "work"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer = train_cli.main([str(fast), "--epochs", str(FAST_EPOCHS), "--work-dir", str(work)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = len(trainer.dataloader)
    if steps != FAST_TRAIN_IMAGES // 8:
        raise AssertionError(f"cli fast training: {steps} steps an epoch")
    expect_launches("cli fast training", launches, FAST_EPOCHS * steps, FAST_EPOCHS * steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    if len(records) != FAST_EPOCHS * steps or not all(math.isfinite(r["loss"]) for r in records):
        raise AssertionError(f"cli fast training: {len(records)} records or a non-finite loss")
    batch_size = cfg["data"]["sample_per_replica"]
    ips, step_ms = epoch_rate(records, FAST_EPOCHS - 1, batch_size)
    wait_ms = trainer.loader_wait_s / len(records) * 1e3
    keys = ("loss", "loss_rcnn_cls", "loss_rcnn_reg")
    log(f"cli fast training [{card}]: {steps} steps an epoch at b{batch_size} on "
        f"{tuple(cfg['data']['canvas'])}, {cfg['data']['max_proposals']} dumped proposals an "
        f"image, {FAST_EPOCHS} epochs in {wall:.1f} s; launches {launches}; epoch {FAST_EPOCHS} ms "
        f"a step {[round(m, 1) for m in step_ms]}; images/s over all of epoch {FAST_EPOCHS} from "
        f"the trainer's log {ips:.2f}; the trainer's wait on the loader {wait_ms:.1f} ms a step; "
        f"peak memory {peak:.2f} GiB; losses first "
        + ", ".join(f"{k} {records[0][k]:.4f}" for k in keys)
        + "; last " + ", ".join(f"{k} {records[-1][k]:.4f}" for k in keys))
    profile = loader_fed_profile(trainer, FAST_EPOCHS, statistics.median(step_ms), card,
                                 "CLI Fast R-CNN training step")
    kernel_checks = cli_fast_kernels(trainer.model, det_cfg, profile.pop("batch"))
    del trainer

    reset_launches()
    t0 = time.perf_counter()
    with recorded_evaluation() as seen:
        metrics = test_cli.main([str(fast), str(work / f"epoch_{FAST_EPOCHS}")])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = read_launches()
    expect_launches("cli fast test", test_launches, -(-FAST_VAL_IMAGES // 8), 0)
    if len(metrics) != 12 or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"cli fast test metrics {metrics}")
    log(f"cli fast test [{card}]: {FAST_VAL_IMAGES} images on the dumped val proposals in "
        f"{test_s:.1f} s (the build included), launches {test_launches}; "
        + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    image, _, _, proposals, _ = seen["batch"]
    with torch.inference_mode():
        k1_test = test_slate_kernel("a tools.test batch's levels and dumped proposals",
                                    seen["det_cfg"], image, seen["model"](image),
                                    proposals[..., :4].float())
    del seen
    return dict(dump=dump_launches, training=launches, test=test_launches,
                k1_test=k1_test, images_per_s=ips, wait_ms=wait_ms, peak_gib=peak,
                dump_ms=dump_ms, profile=profile, **kernel_checks)


# ---------------------------------------------------------------- FCOS, ATSS and GFL; TTA
FCOS_CONFIG = ROOT / "configs" / "fcos_r50_fpn_coco.py"
ATSS_CONFIG = ROOT / "configs" / "atss_r50_fpn_coco.py"
GFL_CONFIG = ROOT / "configs" / "gfl_r50_fpn_coco.py"
FOVEA_CONFIG = ROOT / "configs" / "foveabox_r50_fpn_coco.py"
FREE_ANCHOR_CONFIG = ROOT / "configs" / "free_anchor_r50_fpn_coco.py"
PAA_CONFIG = ROOT / "configs" / "paa_r50_fpn_coco.py"
DENSE = (("fcos", FCOS_CONFIG), ("atss", ATSS_CONFIG), ("gfl", GFL_CONFIG),
         ("fovea", FOVEA_CONFIG), ("free_anchor", FREE_ANCHOR_CONFIG), ("paa", PAA_CONFIG))
DENSE_LOSS_KEYS = {"fcos": ("loss", "loss_cls", "loss_reg", "loss_centerness"),
                   "atss": ("loss", "loss_cls", "loss_reg", "loss_centerness"),
                   "gfl": ("loss", "loss_qfl", "loss_giou", "loss_dfl"),
                   "fovea": ("loss", "loss_cls", "loss_reg"),
                   "free_anchor": ("loss", "loss_pos", "loss_neg"),
                   "paa": ("loss", "loss_cls", "loss_reg", "loss_iou")}


def retina_candidates(det_cfg, cls_scores, bbox_preds, img_shape):
    """FreeAnchor's serving candidates: RetinaNet's preselection and decode."""
    return decode_candidates(det_cfg, preselect(det_cfg, cls_scores, bbox_preds), img_shape)


DENSE_CANDIDATES = {"fcos": fcos_candidates, "atss": atss_candidates, "gfl": gfl_candidates,
                    "fovea": fovea_candidates, "free_anchor": retina_candidates,
                    "paa": paa_candidates}
TTA_SIZES = ((1333, 800), (1000, 600))  # two of COCO's test scales, each flipped too


def load_dense(config: Path, dtype: str, device):
    """A single-stage build (FCOS, ATSS, GFL, FoveaBox, FreeAnchor, PAA)
    with ``cls_out``'s bias at 0, as
    ``load_retina``: the focal prior would put every score under
    ``score_thr`` on random weights."""
    model, det_cfg = load_model(dtype, device, config)
    with torch.no_grad():
        model.head.cls_out.bias.zero_()
    return model, det_cfg


def dense_stage_breakdown(name: str, model, det_cfg, wire, shapes, card: str,
                          repeats: int = 5) -> None:
    """A serving batch stage by stage, a device sync between stages; the
    median host ms of each over ``repeats`` batches."""
    times = {}
    stage = stage_timer(times)
    with torch.inference_mode():
        for _ in range(repeats):
            x = stage("preprocess (u8 s2d wire)", lambda: fused_normalize_pad_s2d(
                wire, shapes, out_dtype=torch.bfloat16))
            feats = stage("backbone (folded stem, R50)", lambda: model.backbone(x))
            levels = stage("fpn", lambda: model.neck(feats))
            outs = stage(f"{name} head" + ("" if name == "free_anchor" else " (GN towers)"),
                         lambda: model.head(levels))
            scores, boxes = stage("preselect, sigmoid, decode, clip", lambda: DENSE_CANDIDATES[name](
                det_cfg, *outs, shapes))
            dets = stage("multiclass NMS", lambda: dense_nms(det_cfg, scores, boxes))
            if name == "paa":
                stage("score voting", lambda: score_voting(det_cfg, dets, boxes, scores))
    log_breakdown(f"{name} stage breakdown, median of {repeats} batches", times, card)


def phase_dense_serving(card: str, name: str, config: Path, seed: int) -> dict:
    """Full-width FCOS, ATSS, GFL, FoveaBox, FreeAnchor or PAA R50-FPN,
    bf16, b4 on the 800 x 1216 s2d wire through ``fused_normalize_pad_s2d``
    and ``make_inference_fn``; K1, K2 and the matcher counted (none
    expected)."""
    model, det_cfg = load_dense(config, "bfloat16", "cuda")
    infer = make_inference_fn(model, det_cfg)
    h, w = CANVAS
    wire, shapes = retina_wire(seed, BATCH)
    run = serve_s2d(infer, wire, shapes)
    timed_batches(run, WARMUP_BATCHES)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms, results = timed_batches(run, TIMED_BATCHES)
    launches = read_launches()
    expect_launches(f"{name} serving", launches, 0, 0)
    for res in results:
        check_detections(res, det_cfg, BATCH, h, w)
    mean_ms = sum(ms) / len(ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{name} serving path b{BATCH}: ms a batch {[round(m, 3) for m in ms]}, mean {mean_ms:.3f} "
        f"ms, {BATCH / (mean_ms / 1e3):.2f} images/s, median {statistics.median(ms):.3f} ms "
        f"[{card}]; launches {launches}; valid detections an image "
        f"{results[-1].valid.sum(1).tolist()}; peak memory {peak:.2f} GiB")
    dense_stage_breakdown(name, model, det_cfg, wire, shapes, card)
    profile = device_profile(run, mean_ms, card)
    return dict(launches=launches, ms_per_batch=mean_ms, profile=profile, peak_gib=peak)


def dense_loss_stages(name: str, det_cfg, outs, batch):
    """The (label, fn) parts of the family's loss that the training
    breakdown times on their own, each without autograd: the targets of
    FCOS, ATSS, GFL and FoveaBox; FreeAnchor's IoU and bag top-k, its
    negative and its positive term; PAA's MaxIoU assignment, candidate
    scores and the three parts of its reassignment (the EM alone)."""
    gts = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
    if name == "free_anchor":
        flat = flat_inputs(det_cfg, *outs, batch["gt_boxes"], batch["gt_labels"])
        anchors, _, _, boxes, _ = flat
        held = {}

        def bags():
            held["bags"] = nms_ops.top_k_stable(bbox_overlaps(boxes, anchors),
                                                det_cfg.pre_anchor_topk)[1]

        return [("IoU and bag top-k", bags),
                ("negative term (forward)", lambda: negative_term(det_cfg, *flat, gts[2])),
                ("positive term (forward)", lambda: positive_term(det_cfg, *flat, gts[2],
                                                                  held["bags"]))]
    if name == "paa":
        held = {}
        sizes = [tuple(c.shape[1:3]) for c in outs[0]]
        anchors = det_cfg.anchor_generator.flat_anchors(sizes, batch["image"].device)
        counts = level_counts(det_cfg.anchor_generator, sizes)
        fc, fr, _ = flatten_outputs(det_cfg.num_classes, *outs)

        def assign():
            held["assign"] = initial_assignment(det_cfg, anchors, *gts, batch["img_shape"])

        def scores():
            _, matched, label0 = held["assign"]
            held["loss"] = candidate_losses(det_cfg, anchors, fc, fr, matched, label0)

        def slates():
            held["slates"] = candidate_slates(det_cfg, held["loss"], held["assign"][0], gts[2],
                                              counts)

        def em():
            held["gmm"] = gmm_em_1d(held["slates"].loss, held["slates"].valid,
                                    n_iter=det_cfg.gmm_iters)

        return [("MaxIoU assignment", assign), ("candidate scores", scores),
                ("reassignment: slates (top-k, sort)", slates),
                (f"reassignment: EM ({det_cfg.gmm_iters} iterations)", em),
                ("reassignment: split, scatter", lambda: scatter_positives(
                    held["slates"], separate(held["slates"], held["gmm"]), anchors.shape[0]))]
    return [("targets (assignment)", lambda: dense_targets(name, det_cfg, outs, *gts,
                                                           batch["img_shape"]))]


def dense_train_stage_breakdown(name: str, model, det_cfg, optimizer, batch, card: str,
                                repeats: int = 5) -> None:
    """A training step stage by stage: the forward, the parts of the loss
    (``dense_loss_stages``), the whole loss (its parts included), the
    backward and the optimizer; the median host ms of each over
    ``repeats`` steps."""
    times = {}
    stage = stage_timer(times)
    for _ in range(repeats):
        optimizer.zero_grad()
        outs = stage("backbone+fpn+head", lambda: model(batch["image"]))
        with torch.no_grad():
            for label, fn in dense_loss_stages(name, det_cfg, outs, batch):
                stage(label, fn)
        loss, _ = stage("targets + losses", lambda: dense_losses(name, det_cfg, outs, batch))
        stage("backward", loss.backward)
        stage("grad norm, clip, SGD", lambda: optimizer.apply(optimizer.global_norm()))
    optimizer.zero_grad()
    log_breakdown(f"{name} training stage breakdown, median of {repeats} steps", times, card)


def dense_losses(name: str, det_cfg, outs, batch):
    """The family's loss dict on the head's outputs, as ``build_loss_fn``'s."""
    gts = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
    if name == "fcos":
        out = fcos_loss(det_cfg, *outs, *gts)
    elif name == "atss":
        out = atss_loss(det_cfg, *outs, *gts, img_shapes=batch["img_shape"])
    elif name == "gfl":
        out = gfl_loss(det_cfg, *outs, *gts, img_shapes=batch["img_shape"])
    elif name == "fovea":
        out = fovea_loss(det_cfg, *outs, *gts)
    elif name == "free_anchor":
        out = free_anchor_loss(det_cfg, *outs, *gts)
    else:
        out = paa_loss(det_cfg, *outs, *gts, img_shapes=batch["img_shape"])
    return out["loss"], out


def dense_targets(name: str, det_cfg, outs, gt_boxes, gt_labels, gt_valid, img_shape) -> dict:
    """The family's per-anchor targets by name, those that a rounding of
    a square root or a log may move by one float32 ulp marked so: FCOS's
    labels, ltrb and centerness; ATSS's labels, matched gts and centerness;
    GFL's labels and matched gts; FoveaBox's labels and log-space targets;
    PAA's MaxIoU assignment, matched gts and labels (the candidate pools);
    FreeAnchor's bags of the top-k anchors by IoU."""
    sizes = [tuple(c.shape[1:3]) for c in outs[0]]
    device = gt_boxes.device
    gts = (gt_boxes, gt_labels, gt_valid)
    if name == "fcos":
        points, ranges = flat_points(det_cfg, sizes, device)
        return dict(zip(("labels", "ltrb distances", "centerness (one ulp)"),
                        fcos_targets(det_cfg, points, ranges, *gts)))
    if name == "fovea":
        return dict(zip(("labels", "log-space targets (one ulp)"),
                        fovea_targets(det_cfg, *flat_geometry(det_cfg, sizes, device), *gts)))
    anchors = det_cfg.anchor_generator.flat_anchors(sizes, device)
    if name == "free_anchor":
        return {"bags": nms_ops.top_k_stable(bbox_overlaps(gt_boxes.float(), anchors),
                                             det_cfg.pre_anchor_topk)[1]}
    if name == "paa":
        return dict(zip(("MaxIoU assigned gts", "matched boxes", "labels"),
                        initial_assignment(det_cfg, anchors, *gts, img_shape)))
    counts = level_counts(det_cfg.anchor_generator, sizes)
    if name == "atss":
        return dict(zip(("labels", "matched boxes", "centerness (one ulp)"),
                        atss_targets(det_cfg, anchors, counts, *gts, img_shape)))
    return dict(zip(("labels", "matched boxes"),
                    assign_and_match(det_cfg.assigner, anchors, counts, *gts, img_shape)))


def phase_dense_train(card: str, name: str, config: Path, seed: int) -> dict:
    """Full-width FCOS, ATSS, GFL, FoveaBox, FreeAnchor or PAA R50-FPN
    training, float32 parameters and bf16 compute, b8 (the configs' ``sample_per_replica``) on the 800 x 1216
    canvas of the two-stage cells with their gts, SGD with clip 35, through
    ``build_train_objects``, ``build_loss_fn`` and ``Trainer.run``; K1, K2
    and the matcher counted (none expected)."""
    cfg = Config.fromfile(config)
    steps = WARMUP_BATCHES + TIMED_BATCHES
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = [retina_train_batch(gen) for _ in range(steps)]
    model, det_cfg, _, optimizer = build_train_objects(cfg, "cuda", seed=SEED,
                                                       loader=Batches(batches))
    if optimizer.grad_clip_norm != 35.0 or cfg["data"]["sample_per_replica"] != RETINA_TRAIN_BATCH:
        raise AssertionError(f"{name}: clip {optimizer.grad_clip_norm}, batch "
                             f"{cfg['data']['sample_per_replica']}")
    loss_fn = build_loss_fn(model, det_cfg, rng_seed=SEED)
    Trainer(loss_fn, model, optimizer, Batches(batches[:WARMUP_BATCHES]), log_interval=1).run(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(loss_fn, model, optimizer, Batches(batches[WARMUP_BATCHES:]), log_interval=1)
    reset_launches()
    t0 = time.perf_counter()
    history = trainer.run(1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    expect_launches(f"{name} training", launches, 0, 0)
    keys = DENSE_LOSS_KEYS[name]
    if len(history) != TIMED_BATCHES or trainer.skipped_steps:
        raise AssertionError(f"{name}: {len(history)} steps logged, {trainer.skipped_steps} skipped")
    for h in history:
        if not all(math.isfinite(h[k]) for k in keys) or not h["num_pos"] > 0:
            raise AssertionError(f"{name}: non-finite loss or no positive at step {h['step']}: {h}")
    still = [n for n, p in model.named_parameters() if p.requires_grad and torch.equal(p, before[n])]
    moved = [n for n, p in model.named_parameters()
             if not p.requires_grad and not torch.equal(p, before[n])]
    tower = "head.cls_conv0." if name == "free_anchor" else "head.cls_tower0.norm."
    if still or moved or not any(n.startswith(tower) for n in before):
        raise AssertionError(f"{name}: trainable parameters that did not move {still}; frozen "
                             f"ones that moved {moved}")
    b = RETINA_TRAIN_BATCH
    step_ms = [b / h["images_per_sec"] * 1e3 for h in history]
    mean_ms = seconds / TIMED_BATCHES * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{name} training path b{b}: ms a step {[round(m, 3) for m in step_ms]}, mean "
        f"{mean_ms:.3f} ms, {b / (mean_ms / 1e3):.2f} images/s, median "
        f"{statistics.median(step_ms):.3f} ms [{card}]; launches {launches}; skipped steps "
        f"{trainer.skipped_steps}; peak memory {peak:.2f} GiB; over the {TIMED_BATCHES} steps "
        + "; ".join(f"{k} {[round(h[k], 4) for h in history]}" for k in keys + ("num_pos",)))
    profile = device_profile(lambda: trainer.train_step(dict(batches[-1])), mean_ms, card, "step")
    dense_train_stage_breakdown(name, model, det_cfg, optimizer, batches[-1], card)
    return dict(launches=launches, ms_per_step=mean_ms, profile=profile, peak_gib=peak)


def dense_reference_batch() -> dict:
    """Two seeded 256 x 320 images on the s2d wire, the second smaller than
    its canvas, with 3 and 2 gts (``retina_reference_setup``'s), and a
    duplicate of one gt."""
    gen = torch.Generator().manual_seed(SEED + 120)
    return dict(
        image=space_to_depth_2x2(torch.randn((2, 256, 320, 3), generator=gen)),
        gt_boxes=torch.tensor([[[16, 20, 120, 140], [150, 40, 300, 230], [60, 150, 110, 250],
                                [16, 20, 120, 140]],
                               [[30, 30, 200, 180], [210, 100, 290, 200], [0] * 4, [0] * 4]],
                              dtype=torch.float32),
        gt_labels=torch.tensor([[3, 17, 80, 5], [1, 45, 0, 0]]),
        gt_valid=torch.tensor([[True, True, True, True], [True, True, False, False]]),
        img_shape=torch.tensor([[256.0, 320.0], [240.0, 300.0]]),
    )


def paa_reference_checks(det_cfg, outs_g, on_gpu, check) -> tuple:
    """PAA's reassignment on equal inputs: the GPU's candidate losses and
    MaxIoU assignment fed to both devices. The slates must agree exactly,
    the GMM's means, variances and weights to 1e-5 of max(1, |want|), and
    the positives exactly, except where a responsibility lies within 1e-6
    of 0.5 (such flips are counted and reported). Returns the positives'
    count and the counts of slates and flips, as text."""
    sizes = [tuple(c.shape[1:3]) for c in outs_g[0]]
    anchors = det_cfg.anchor_generator.flat_anchors(sizes, "cuda")
    counts = level_counts(det_cfg.anchor_generator, sizes)
    fc, fr, _ = flatten_outputs(det_cfg.num_classes, *outs_g)
    gts = tuple(on_gpu[k] for k in ("gt_boxes", "gt_labels", "gt_valid"))
    assigned, matched, label0 = initial_assignment(det_cfg, anchors, *gts, on_gpu["img_shape"])
    loss = candidate_losses(det_cfg, anchors, fc, fr, matched, label0)
    sl_g = candidate_slates(det_cfg, loss, assigned, gts[2], counts)
    sl_c = candidate_slates(det_cfg, loss.cpu(), assigned.cpu(), gts[2].cpu(), counts)
    for field in ("loss", "index", "valid"):
        check(f"slates on equal inputs, {field} mismatches",
              float((getattr(sl_g, field).cpu() != getattr(sl_c, field)).sum()), 0)
    res_g = gmm_em_1d(sl_g.loss, sl_g.valid, n_iter=det_cfg.gmm_iters)
    res_c = gmm_em_1d(sl_c.loss, sl_c.valid, n_iter=det_cfg.gmm_iters)
    live = sl_c.valid.any(-1)  # the gts with candidates
    for field in ("means", "variances", "weights"):
        g, c = getattr(res_g, field).cpu()[live], getattr(res_c, field)[live]
        check(f"GMM {field}", float(((g - c).abs() / c.abs().clamp_min(1.0)).max()), 1e-5)
    def low_component(res, slates):
        lo = res.means.argmin(-1)
        r = torch.gather(res.resp, -1, lo[..., None, None].expand(*res.resp.shape[:-1], 1))[..., 0]
        return r, (r >= 0.5) & slates.valid

    r_c, comp_c = low_component(res_c, sl_c)
    comp_g = low_component(res_g, sl_g)[1].cpu()
    flips = comp_g != comp_c
    near = (r_c - 0.5).abs() <= 1e-6
    check("component flips where the responsibility is not within 1e-6 of 0.5",
          float((flips & ~near).sum()), 0)
    agree = ~flips.any(-1, keepdim=True)  # the slates whose components agree
    check("positives mismatches in those slates",
          float(((separate(sl_g, res_g).cpu() != separate(sl_c, res_c)) & agree).sum()), 0)
    got = paa_reassign(det_cfg, loss, assigned, gts[2], counts).cpu()
    want = paa_reassign(det_cfg, loss.cpu(), assigned.cpu(), gts[2].cpu(), counts)
    if not bool(flips.any()):
        check("reassignment on equal inputs mismatches", float((got != want).sum()), 0)
    return (f"{int((got > 0).sum())} positives of {int((assigned > 0).sum())} candidates",
            f"{int(live.sum())} slates, {int(flips.sum())} component flips within 1e-6 of 0.5")


def phase_dense_reference() -> None:
    """FCOS, ATSS, GFL, FoveaBox, FreeAnchor and PAA in float32 on the GPU
    and on the CPU, stage by stage on a small canvas, each GPU stage fed to
    its CPU counterpart: the FPN levels, GroupNorm alone, the head, the
    targets (FreeAnchor's bags on the GPU's IoUs; PAA's MaxIoU assignment,
    then its reassignment and EM on the GPU's candidate losses), the
    candidates, the NMS on equal inputs (and PAA's score voting), the
    losses on equal inputs, and every parameter's gradient through the
    whole model."""
    batch = dense_reference_batch()
    on_gpu = {k: v.cuda() for k, v in batch.items()}
    for name, config in DENSE:
        gpu, det_cfg = load_dense(config, "float32", "cuda")
        cpu, _ = load_dense(config, "float32", "cpu")
        checks = []

        def check(what, err, limit):
            checks.append(f"{what} {err:.2e} (limit {limit:g})")
            if not err <= limit:
                raise AssertionError(f"{name} reference check {what}: {err} > {limit}")

        with torch.inference_mode():
            xg, xc = on_gpu["image"], batch["image"]
            lg, lc = gpu.neck(gpu.backbone(xg)), cpu.neck(cpu.backbone(xc))
            check("fpn levels", max(rel_err(g, c) for g, c in zip(lg, lc)), 1e-3)
            lh = [f.cpu() for f in lg]
            if name != "free_anchor":  # RetinaHead's towers have no norm
                conv_g = gpu.head.cls_tower0.conv(lg[0].permute(0, 3, 1, 2))
                check("GroupNorm", rel_err(gpu.head.cls_tower0.norm(conv_g),
                                           cpu.head.cls_tower0.norm(conv_g.cpu())), 1e-4)
            outs_g, outs_c = gpu.head(lg), cpu.head(lh)
            check("head outputs", max(rel_err(g, c) for og, oc in zip(outs_g, outs_c)
                                      for g, c in zip(og, oc)), 1e-4)
            outs_h = tuple(tuple(t.cpu() for t in o) for o in outs_g)
            gts = ("gt_boxes", "gt_labels", "gt_valid")
            tg = dense_targets(name, det_cfg, outs_g, *(on_gpu[k] for k in gts), on_gpu["img_shape"])
            if name == "free_anchor":  # the bags on equal IoUs
                sizes = [tuple(c.shape[1:3]) for c in outs_g[0]]
                iou = bbox_overlaps(on_gpu["gt_boxes"],
                                    det_cfg.anchor_generator.flat_anchors(sizes, "cuda"))
                tc = {"bags on the GPU's IoUs": nms_ops.top_k_stable(iou.cpu(),
                                                                     det_cfg.pre_anchor_topk)[1]}
                tg = {"bags on the GPU's IoUs": tg["bags"]}
            else:
                tc = dense_targets(name, det_cfg, outs_h, *(batch[k] for k in gts),
                                   batch["img_shape"])
            for what, t in tc.items():
                g = tg[what].cpu()
                if what.endswith(" (one ulp)"):  # a square root or a log
                    ulp = torch.finfo(torch.float32).eps * t.abs().clamp_min(1e-30)
                    check(f"{what[:-len(' (one ulp)')]} beyond one ulp",
                          float(((g - t).abs() > ulp).sum()), 0)
                else:
                    check(f"{what} mismatches", float((g != t).sum()), 0)
            extra = ""
            if name == "free_anchor":
                positives = f"{int(batch['gt_valid'].sum()) * det_cfg.pre_anchor_topk} bag members"
            elif name == "paa":
                positives, extra = paa_reference_checks(det_cfg, outs_g, on_gpu, check)
            else:
                positives = f"{int((tc['labels'] >= 0).sum())} positives"
            sg, bg = DENSE_CANDIDATES[name](det_cfg, *outs_g, on_gpu["img_shape"])
            sc, bc = DENSE_CANDIDATES[name](det_cfg, *outs_h, batch["img_shape"])
            check("candidate scores", float((sg.cpu() - sc).abs().max()), 1e-6)
            check("candidate boxes (px)", float((bg.cpu() - bc).abs().max()), 1e-3)
            # one ulp can swap two of the many near-equal scores, so the NMS
            # takes the GPU's candidates on both devices
            ng, nc = dense_nms(det_cfg, sg, bg), dense_nms(det_cfg, sg.cpu(), bg.cpu())
            for field in ("valid", "labels", "indices", "scores", "boxes"):
                check(f"NMS on equal inputs, {field} mismatches",
                      float((getattr(ng, field).cpu() != getattr(nc, field)).sum()), 0)
            if not bool(nc.valid.any(dim=1).all()):
                raise AssertionError(f"{name}: no detection in the reference batch")
            if name == "paa":
                vg = score_voting(det_cfg, ng, bg, sg)
                vc = score_voting(det_cfg, nc, bg.cpu(), sg.cpu())
                check("voted boxes on equal inputs (px)", float((vg.cpu() - vc).abs().max()), 1e-3)
                moved = int(((vg != ng.boxes).any(-1) & ng.valid).sum())
                extra += f", the voting moved {moved} of {int(ng.valid.sum())} boxes"
        with torch.no_grad():
            _, lossg = dense_losses(name, det_cfg, outs_g, on_gpu)
            _, lossc = dense_losses(name, det_cfg, outs_h, batch)
        check("losses on equal inputs", max(rel_err(lossg[k], lossc[k])
                                            for k in DENSE_LOSS_KEYS[name]), 1e-4)
        check("num_pos mismatches", abs(float(lossg["num_pos"]) - float(lossc["num_pos"])), 0)
        gpu.train(), cpu.train()
        for model, data in ((gpu, on_gpu), (cpu, batch)):
            loss, _ = build_loss_fn(model, det_cfg)(data)
            loss.backward()

        def rel_norm(a, b):
            a, b = a.cpu().double(), b.cpu().double()
            return float((a - b).norm() / b.norm().clamp_min(1e-300))

        errs = {n: rel_norm(g.grad, c.grad) for (n, g), (_, c) in
                zip(gpu.named_parameters(), cpu.named_parameters()) if g.requires_grad}
        worst = max(errs, key=errs.get)
        check(f"gradients' relative norm of the difference (worst at {worst})", errs[worst], 1e-2)
        log(f"{name} reference check, GPU vs CPU float32 ({positives}, "
            f"{nc.valid.sum(1).tolist()} detections, {len(errs)} gradients"
            + (f"; {extra}" if extra else "") + "): " + "; ".join(checks))
        del gpu, cpu


def phase_cli_tta(card: str) -> dict:
    """``tools.test --tta --segm`` on ``phase_cli_mask``'s ``epoch_2``, with a
    config derived from its own whose val data has two
    ``img_expected_sizes`` and flips: four augmentations an image, each at
    its size rounded up to 128, fused by class-wise NMS in the original
    frame, each mask from its source detection. K1 is counted by output
    size (twice a batch, out 7 and out 14, K2 never) and held to its plain
    version at out 14 on one flipped augmentation's levels and detections."""
    base = SMOKE_COCO_MASKS / "mask_rcnn_r50_fpn_smoke.py"
    config = SMOKE_COCO_MASKS / "mask_rcnn_r50_fpn_smoke_tta.py"
    config.write_text(f"_base_ = {str(base)!r}\n"
                      f"data = dict(val=dict(img_expected_sizes={list(TTA_SIZES)!r}, "
                      "flip_ratio=0.5))\n")
    checkpoint = SMOKE_COCO_MASKS / "work" / f"epoch_{CLI_MASK_EPOCHS}"
    out = SMOKE_COCO_MASKS / "results_tta.json"
    reset_launches()
    t0 = time.perf_counter()
    with recorded_evaluation() as seen, launches_by_out_size() as sizes:
        metrics = test_cli.main([str(config), str(checkpoint), "--tta", "--segm", "--out",
                                 str(out)])
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    calls = seen["canvases"]
    n = len(calls)
    dataset, kwargs = seen["dataset"], seen["kwargs"]
    augs = len(dataset[0]["img"])
    if not kwargs.get("tta") or augs != 2 * len(TTA_SIZES):
        raise AssertionError(f"cli test --tta: tta {kwargs.get('tta')}, {augs} augmentations")
    expect_launches("cli test --tta --segm", launches, 2 * n, 0)
    if sizes != dict(k1={OUT_SIZE: n, MASK_OUT: n}, k2={}):
        raise AssertionError(f"cli test --tta: launches by out size {sizes} for {n} batches")
    if len(metrics) != 24 or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"cli test --tta metrics {metrics}")
    val_ann = Path(Config.fromfile(config)["data"]["val"]["ann_file"])
    frames = {img["id"]: (img["height"], img["width"])
              for img in json.loads(val_ann.read_text())["images"]}
    segm = json.loads((SMOKE_COCO_MASKS / "results_tta.segm.json").read_text())
    if not segm or len(segm) != len(json.loads(out.read_text())):
        raise AssertionError(f"cli test --tta: {len(segm)} segm records")
    for r in segm:
        if rle_decode(r["segmentation"]).shape != frames[r["image_id"]]:
            raise AssertionError(f"a segm record for image {r['image_id']} of the wrong size")
    log(f"cli test --tta --segm [{card}]: {len(dataset)} images x {augs} augmentations "
        f"({TTA_SIZES}, flipped and not) in {n} batches at {sorted(collections.Counter(calls).items())} "
        f"in {seconds:.1f} s (the build included), launches {launches}, by out size "
        f"{ {k: dict(v) for k, v in sizes.items()} }; {len(segm)} segm records, each RLE decoding "
        f"to its image's original size; " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))

    # K1 at out 14 on the flipped augmentation of the larger size, one batch
    aug = 1
    items = [(dataset[i]["img"][aug], dataset[i]["img_meta"][aug].data) for i in range(8)]
    bucket = pick_canvas([img.shape[:2] for img, _ in items[:1]], size_divisor=128)
    items = [(img, meta) for img, meta in items
             if pick_canvas([img.shape[:2]], size_divisor=128) == bucket]
    image = np.zeros((len(items), *bucket, 3), np.float32)
    for j, (img, _) in enumerate(items):
        image[j, : img.shape[0], : img.shape[1]] = img
    shapes = torch.tensor([meta["img_shape"][:2] for _, meta in items], dtype=torch.float32,
                          device="cuda")
    metas = [meta for _, meta in items]
    if not all(m["flipped_flag"] for m in metas):
        raise AssertionError("the checked augmentation is not a flipped one")
    model = seen["model"]
    k1 = cli_mask_test_checks(model, seen["det_cfg"],
                              torch.from_numpy(image).cuda().to(next(model.parameters()).dtype),
                              shapes, metas, card)
    del seen
    return dict(test=launches, k1_test=k1, batches=n, metrics=metrics)


# ---------------------------------------------------------------- SSD300, SSD512, YOLOv3, YOLOX-S
# and CenterNet R18
SSD300_CONFIG = ROOT / "configs" / "ssd300_vgg16_coco.py"
SSD512_CONFIG = ROOT / "configs" / "ssd512_vgg16_coco.py"
YOLO_CONFIG = ROOT / "configs" / "yolov3_d53_coco.py"
YOLOX_CONFIG = ROOT / "configs" / "yolox_s_coco.py"
CENTERNET_CONFIG = ROOT / "configs" / "centernet_r18_coco.py"
SINGLE = (("ssd300", SSD300_CONFIG), ("ssd512", SSD512_CONFIG), ("yolov3", YOLO_CONFIG),
          ("yolox", YOLOX_CONFIG), ("centernet", CENTERNET_CONFIG))
SINGLE_LOSS_KEYS = {"ssd300": ("loss", "loss_cls", "loss_reg"),
                    "ssd512": ("loss", "loss_cls", "loss_reg"),
                    "yolov3": ("loss", "loss_xy", "loss_wh", "loss_conf", "loss_cls"),
                    "yolox": ("loss", "loss_cls", "loss_reg", "loss_obj"),
                    "centernet": ("loss", "loss_heatmap", "loss_wh", "loss_offset")}
# the serving batch where it is not the config's training batch
SINGLE_SERVE_BATCH = {"yolox": 16, "centernet": 16}
# of every four images on a square canvas, keep-ratio resized onto it: a square, a 4:3
# landscape, a 2:3 portrait and a 3:2 landscape (their (h, w) as fractions of the side)
ASPECTS = ((1.0, 1.0), (0.75, 1.0), (1.0, 2 / 3), (2 / 3, 1.0))
# the reference checks' narrow YOLOv3: Darknet with (1, 1, 2, 2, 1) blocks from 16 channels
YOLO_NARROW = dict(
    type="SingleStageDetector",
    backbone=dict(type="Darknet", depth=53, stages=(1, 1, 2, 2, 1), base_channels=16,
                  out_indices=(2, 3, 4)),
    neck=dict(type="YOLOV3Neck", in_channels=(128, 256, 512), out_channels=(128, 64, 32)),
    head=dict(type="YOLOV3Head", num_classes=80, in_channels=(128, 64, 32),
              out_channels=(256, 128, 64)),
)


# the reference checks' narrow YOLOX (CSPDarknet at widen 0.25: 16 to 256 channels) and
# CenterNet (ResNet-18, the deconvolutions (128, 64, 32)), both at 80 classes
YOLOX_NARROW = dict(
    type="SingleStageDetector",
    backbone=dict(type="CSPDarknet", deepen_factor=0.33, widen_factor=0.25, out_indices=(2, 3, 4)),
    neck=dict(type="YOLOXPAFPN", in_channels=(64, 128, 256), out_channels=64),
    head=dict(type="YOLOXHead", num_classes=80, in_channels=64, feat_channels=64),
)
CENTERNET_NARROW = dict(
    type="SingleStageDetector",
    backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(3,)),
    neck=dict(type="CTResNetNeck", in_channels=512, num_deconv_filters=(128, 64, 32)),
    head=dict(type="CenterNetHead", num_classes=80, in_channels=32, feat_channels=32),
)


def single_setup(config: Path) -> tuple:
    """(config, batch, canvas, means, stds) of an SSD, YOLOv3, YOLOX or
    CenterNet config."""
    cfg = Config.fromfile(config)
    data = cfg["data"]
    return (cfg, data["sample_per_replica"], tuple(data["canvas"]), tuple(data["val"]["img_means"]),
            tuple(data["val"]["img_stds"]))


def single_shapes(batch: int, canvas, device="cuda") -> torch.Tensor:
    """(B, 2) (h, w) of ``batch`` images (a multiple of 4) of ``ASPECTS`` on
    the square ``canvas``."""
    h, w = canvas
    return torch.tensor([[round(fh * h), round(fw * w)] for fh, fw in ASPECTS] * (batch // 4),
                        dtype=torch.float32, device=device)


def load_single(config: Path, dtype: str, device):
    """An SSD, YOLOv3, YOLOX or CenterNet build. YOLOv3's objectness biases
    are set to 0: with the 0.01 prior every score of random weights is
    sigmoid(cls) * 0.01, under ``score_thr`` 0.05, and the NMS pool would be
    empty; at 0 the objectness sits near 0.5. YOLOX's ``cls_out`` and
    ``obj_out`` biases are set to 0 for the same reason (at the 0.01 priors
    every score is about 1e-4, under ``score_thr`` 0.01). SSD's softmax
    needs nothing: its seeded weights leave about a tenth of the pairs above
    its ``score_thr``; nor does CenterNet's 0.1 prior, whose peaks score
    near 0.1, above its 0.05."""
    model, det_cfg = load_model(dtype, device, config)
    if isinstance(det_cfg, YOLOV3Config):
        zero_objectness(model, det_cfg)
    if isinstance(det_cfg, YOLOXConfig):
        zero_yolox_priors(model, det_cfg)
    return model, det_cfg


def zero_objectness(model, det_cfg) -> None:
    """YOLOv3's objectness biases (channel 4 of each anchor's 5 + C) at 0."""
    with torch.no_grad():
        for lvl in range(det_cfg.anchor_generator.num_levels):
            getattr(model.head, f"pred{lvl}").bias[4::5 + det_cfg.num_classes] = 0.0


def zero_yolox_priors(model, det_cfg) -> None:
    """YOLOX's ``cls_out{l}`` and ``obj_out{l}`` biases at 0."""
    with torch.no_grad():
        for lvl in range(len(det_cfg.strides)):
            getattr(model.head, f"cls_out{lvl}").bias.zero_()
            getattr(model.head, f"obj_out{lvl}").bias.zero_()


def check_single_detections(res, det_cfg, shapes: torch.Tensor) -> None:
    """``check_detections`` with each image's boxes inside its own (h, w)."""
    h, w = int(shapes[:, 0].max()), int(shapes[:, 1].max())
    check_detections(res, det_cfg, shapes.shape[0], h, w)
    inside = ((res.boxes[..., 0::2] <= shapes[:, None, 1:2] - 1).all(-1)
              & (res.boxes[..., 1::2] <= shapes[:, None, 0:1] - 1).all(-1))
    if not bool(inside[res.valid].all()):
        raise AssertionError("a box outside its image")


def single_candidates(det_cfg, outs, img_shape):
    """The family's serving candidates: (B, M, C) scores and (B, M, 4) boxes."""
    if isinstance(det_cfg, YOLOV3Config):
        return yolo_candidates(det_cfg, outs, img_shape)
    if isinstance(det_cfg, YOLOXConfig):
        return yolox_candidates(det_cfg, *outs, img_shape)
    return ssd_candidates(det_cfg, *outs, img_shape)


def single_stage_breakdown(name: str, model, det_cfg, run_pre, shapes, card: str,
                           repeats: int = 5) -> None:
    """A serving batch stage by stage, a device sync between stages; the
    median host ms of each over ``repeats`` batches. CenterNet's decode is
    its peaks, the stable sort of every image's H * W * C scores, and the
    whole decode (both again, and the boxes)."""
    times = {}
    stage = stage_timer(times)
    trunk = type(model.backbone).__name__
    with torch.inference_mode():
        for _ in range(repeats):
            x = stage("preprocess (u8 NHWC, normalise, pad)", run_pre)
            feats = stage(f"backbone ({trunk})", lambda: model.backbone(x))
            if model.neck is not None:
                feats = stage(f"neck ({type(model.neck).__name__})", lambda: model.neck(feats))
            outs = stage("head", lambda: model.head(feats))
            if isinstance(det_cfg, CenterNetConfig):
                peaks = stage("peaks (sigmoid, 3 x 3 max-pool, compare)",
                              lambda: centernet_peaks(outs[0]))
                stage(f"stable sort of {peaks.shape[0]} x {peaks.shape[1]} scores, top "
                      f"{det_cfg.max_detections}",
                      lambda: nms_ops.top_k_stable(peaks, det_cfg.max_detections))
                stage("whole decode (peaks, sort, boxes, clip)",
                      lambda: decode_centernet(det_cfg, *outs, shapes))
                continue
            scores, boxes = stage("candidates (softmax or preselect, decode, clip)",
                                  lambda: single_candidates(det_cfg, outs, shapes))
            stage("multiclass NMS", lambda: dense_nms(det_cfg, scores, boxes))
    log_breakdown(f"{name} stage breakdown, median of {repeats} batches", times, card)


def phase_single_serving(card: str, name: str, config: Path, seed: int) -> dict:
    """Full-width SSD300 (b32 on 300 x 300), SSD512 (b16 on 512 x 512),
    YOLOv3 (b8 on 608 x 608), YOLOX-S (b16 on 640 x 640) or CenterNet R18
    (b16 on 512 x 512), bf16: a seeded uint8 batch of mixed aspect ratios,
    put on the card once, through ``fused_normalize_pad`` (the config's
    means and stds) and ``make_inference_fn``; K1, K2 and the matcher
    counted (none expected)."""
    _, b, canvas, mean, std = single_setup(config)
    b = SINGLE_SERVE_BATCH.get(name, b)
    model, det_cfg = load_single(config, "bfloat16", "cuda")
    if isinstance(det_cfg, YOLOV3Config):
        log(f"{name}: the objectness biases set to 0 for serving (random weights score under "
            "score_thr at the 0.01 prior)")
    if isinstance(det_cfg, YOLOXConfig):
        log(f"{name}: the cls_out and obj_out biases set to 0 for serving (random weights score "
            "about 1e-4, under score_thr 0.01, at the 0.01 priors)")
    infer = make_inference_fn(model, det_cfg)
    shapes = single_shapes(b, canvas)
    u8 = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (b, *canvas, 3), dtype=np.uint8)).cuda()
    scale = torch.ones(b, device="cuda")

    def pre():
        return fused_normalize_pad(u8, shapes, mean, std, out_dtype=torch.bfloat16)

    def run():
        return infer(pre(), shapes, scale)

    timed_batches(run, WARMUP_BATCHES)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms, results = timed_batches(run, TIMED_BATCHES)
    launches = read_launches()
    expect_launches(f"{name} serving", launches, 0, 0)
    for res in results:
        check_single_detections(res, det_cfg, shapes)
    mean_ms = sum(ms) / len(ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    sizes = sorted({tuple(map(int, s)) for s in shapes.tolist()})
    log(f"{name} serving path b{b} on {canvas} (images {sizes}): "
        f"ms a batch {[round(m, 3) for m in ms]}, mean {mean_ms:.3f} ms, "
        f"{b / (mean_ms / 1e3):.2f} images/s, median {statistics.median(ms):.3f} ms [{card}]; "
        f"launches {launches}; valid detections an image {results[-1].valid.sum(1).tolist()}; "
        f"peak memory {peak:.2f} GiB")
    single_stage_breakdown(name, model, det_cfg, pre, shapes, card)
    profile = device_profile(run, mean_ms, card)
    return dict(launches=launches, ms_per_batch=mean_ms, profile=profile, peak_gib=peak)


def single_gts(gen: torch.Generator, shapes: torch.Tensor):
    """1-20 gt boxes an image (16 px to 0.9 of the image's shorter side on
    a side, log-uniform; labels 1-80) inside each (h, w), padded to 100."""
    device, batch = shapes.device, shapes.shape[0]
    u = torch.rand((batch, MAX_GTS, 4), generator=gen, device=device)
    top = 0.9 * shapes.min(dim=1).values[:, None, None] / 16.0
    size = 16.0 * top ** u[..., 2:]
    xy = u[..., :2] * (shapes[:, None, [1, 0]] - 1 - size)
    num = torch.randint(1, 21, (batch, 1), generator=gen, device=device)
    valid = torch.arange(MAX_GTS, device=device)[None, :] < num
    boxes = torch.where(valid[..., None], torch.cat([xy, xy + size], dim=-1), 0.0)
    labels = torch.randint(1, 81, (batch, MAX_GTS), generator=gen, device=device)
    return boxes, torch.where(valid, labels, 0), valid


def single_train_batch(gen: torch.Generator, batch: int, canvas) -> dict:
    """Seeded normalised images of ``ASPECTS`` on the square canvas (zero
    outside each image) and ``single_gts``."""
    shapes = single_shapes(batch, canvas)
    h, w = canvas
    image = torch.randn((batch, h, w, 3), generator=gen, device="cuda")
    inside = ((torch.arange(h, device="cuda")[None, :, None] < shapes[:, 0, None, None])
              & (torch.arange(w, device="cuda")[None, None, :] < shapes[:, 1, None, None]))
    boxes, labels, valid = single_gts(gen, shapes)
    return dict(image=image * inside[..., None], gt_boxes=boxes, gt_labels=labels, gt_valid=valid,
                img_shape=shapes)


def yolox_assign(det_cfg, outs, gt_boxes, gt_labels, gt_valid):
    """SimOTA on YOLOX head outputs, as ``yolox_loss`` runs it."""
    grid, strides = flat_grid(det_cfg, [tuple(s.shape[1:3]) for s in outs[0]], gt_boxes.device)
    fc, fr, fo = flatten_yolox_outputs(det_cfg, *outs)
    return simota_assign(det_cfg, fc, fo, decode_boxes(fr, grid, strides), grid, strides,
                         gt_boxes, gt_labels, gt_valid)


def single_loss_stages(det_cfg, outs, batch):
    """The (label, fn) parts of the loss that the training breakdown times
    on their own, without autograd: SSD's assignment and mining, YOLOv3's
    assignment (responsible flags, grid assigner, box coding), YOLOX's
    SimOTA, CenterNet's targets."""
    gts = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
    if isinstance(det_cfg, YOLOXConfig):
        return [("SimOTA (costs, dynamic k, conflicts)", lambda: yolox_assign(det_cfg, outs, *gts))]
    if isinstance(det_cfg, CenterNetConfig):
        return [("targets (Gaussian windows, scatter amax)",
                 lambda: centernet_targets(det_cfg, tuple(outs[0].shape[1:3]), *gts))]
    if isinstance(det_cfg, YOLOV3Config):
        sizes = [tuple(p.shape[1:3]) for p in outs]
        return [("assignment (responsible flags, grid assigner, encode)",
                 lambda: yolo_targets(det_cfg, sizes, *gts, batch["img_shape"]))]
    sizes = [tuple(s.shape[1:3]) for s in outs[0]]
    anchors = det_cfg.anchor_generator.flat_anchors(sizes, batch["image"].device)
    held = {}

    def assign():
        held["t"] = ssd_targets(det_cfg, anchors, *gts)

    def mine():
        t = held["t"]
        flat_c, _ = flatten_ssd_outputs(det_cfg, *outs)
        hard_negatives(det_cfg, cross_entropy(flat_c, t.labels), t.pos, t.neg)

    return [("assignment (MaxIoU, encode)", assign),
            ("mining (cross-entropy, stable sort, rank)", mine)]


def single_losses(det_cfg, outs, batch) -> dict:
    """The family's loss dict on the head's outputs, as ``build_loss_fn``'s:
    YOLOv3's takes the batch's ``img_shape``, SSD's (R11), YOLOX's and
    CenterNet's none."""
    gts = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
    if isinstance(det_cfg, YOLOXConfig):
        return yolox_loss(det_cfg, *outs, *gts)
    if isinstance(det_cfg, CenterNetConfig):
        return centernet_loss(det_cfg, *outs, *gts)
    if isinstance(det_cfg, YOLOV3Config):
        return yolo_loss(det_cfg, outs, *gts, img_shapes=batch["img_shape"])
    return ssd_loss(det_cfg, *outs, *gts)


def single_train_stage_breakdown(name: str, model, det_cfg, optimizer, batch, card: str,
                                 repeats: int = 5) -> None:
    """A training step stage by stage: the forward, the loss's parts on
    their own (``single_loss_stages``), the whole loss (its parts included),
    the backward and the optimizer; the median host ms of each over
    ``repeats`` steps."""
    times = {}
    stage = stage_timer(times)
    for _ in range(repeats):
        optimizer.zero_grad()
        outs = stage("forward (trunk, neck, head)", lambda: model(batch["image"]))
        with torch.no_grad():
            for label, fn in single_loss_stages(det_cfg, outs, batch):
                stage(label, fn)
        loss = stage("targets + losses", lambda: single_losses(det_cfg, outs, batch)["loss"])
        stage("backward", loss.backward)
        stage("grad norm, clip, SGD", lambda: optimizer.apply(optimizer.global_norm()))
    optimizer.zero_grad()
    log_breakdown(f"{name} training stage breakdown, median of {repeats} steps", times, card)


def phase_single_train(card: str, name: str, config: Path, seed: int) -> dict:
    """Full-width SSD300 (b32), SSD512 (b16), YOLOv3, YOLOX-S or CenterNet
    R18 (b8) training on the config's canvas, float32 parameters and bf16
    compute, with the config's SGD (its momentum, weight decay and clip:
    0.9, 5e-4 and 35, CenterNet's weight decay the base's 1e-4), through
    ``build_train_objects``, ``build_loss_fn`` and ``Trainer.run``: 2
    warm-up and 10 timed steps; K1, K2 and the matcher counted (none
    expected)."""
    cfg, b, canvas, _, _ = single_setup(config)
    steps = WARMUP_BATCHES + TIMED_BATCHES
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = [single_train_batch(gen, b, canvas) for _ in range(steps)]
    model, det_cfg, _, optimizer = build_train_objects(cfg, "cuda", seed=SEED,
                                                       loader=Batches(batches))
    group = optimizer.torch_optimizer.param_groups[0]
    opt = cfg["optimizer"]
    if (optimizer.grad_clip_norm, group["momentum"], group["weight_decay"]) != (
            opt["grad_clip_norm"], opt["momentum"], opt["weight_decay"]) or opt.get(
            "type", "sgd") != "sgd" or opt["grad_clip_norm"] != 35.0:
        raise AssertionError(f"{name}: clip {optimizer.grad_clip_norm}, {group}, config {opt}")
    loss_fn = build_loss_fn(model, det_cfg, rng_seed=SEED)
    Trainer(loss_fn, model, optimizer, Batches(batches[:WARMUP_BATCHES]), log_interval=1).run(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(loss_fn, model, optimizer, Batches(batches[WARMUP_BATCHES:]), log_interval=1)
    reset_launches()
    t0 = time.perf_counter()
    history = trainer.run(1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    expect_launches(f"{name} training", launches, 0, 0)
    keys = SINGLE_LOSS_KEYS[name]
    if len(history) != TIMED_BATCHES or trainer.skipped_steps:
        raise AssertionError(f"{name}: {len(history)} steps logged, "
                             f"{trainer.skipped_steps} skipped")
    for h in history:
        if not all(math.isfinite(h[k]) for k in keys) or not h["num_pos"] > 0:
            raise AssertionError(f"{name}: non-finite loss or no positive at step {h['step']}: {h}")
    # every kernel decays with the weight decay; a bias moves where a gradient reached it
    still = [n for n, p in model.named_parameters() if torch.equal(p, before[n])]
    if [n for n in still if before[n].dim() > 1] or not model.training:
        raise AssertionError(f"{name}: kernels that did not move: {still}")
    step_ms = [b / h["images_per_sec"] * 1e3 for h in history]
    mean_ms = seconds / TIMED_BATCHES * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{name} training path b{b} on {canvas}: ms a step {[round(m, 3) for m in step_ms]}, mean "
        f"{mean_ms:.3f} ms, {b / (mean_ms / 1e3):.2f} images/s, median "
        f"{statistics.median(step_ms):.3f} ms [{card}]; launches {launches}; skipped steps "
        f"{trainer.skipped_steps}; peak memory {peak:.2f} GiB; parameters that did not move "
        f"(biases no gradient reached) {still}; over the {TIMED_BATCHES} steps "
        + "; ".join(f"{k} {[round(h[k], 4) for h in history]}" for k in keys + ("num_pos",)))
    profile = device_profile(lambda: trainer.train_step(dict(batches[-1])), mean_ms, card, "step")
    single_train_stage_breakdown(name, model, det_cfg, optimizer, batches[-1], card)
    return dict(launches=launches, ms_per_step=mean_ms, profile=profile, peak_gib=peak)


def rel_to_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, on the CPU in float32."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def ulp_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise |a - b| in float32 ulps of the larger magnitude (CPU)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag))) * torch.finfo(torch.float32).eps
    return (a - b).abs() / ulp


def ulps_apart(got: torch.Tensor, want: torch.Tensor) -> int:
    """The most float32 ulps (of the larger magnitude) between two tensors."""
    return int(ulp_gap(got, want).ceil().max())


def single_reference_batch(name: str) -> dict:
    """Two seeded images on the CPU: for SSD on the 300 canvas, image 1 a
    640 x 480 picture resized (75 rows of zero padding, R11); for YOLOv3,
    YOLOX and CenterNet on 320 x 320, image 1 a 3:2 landscape (107 rows of
    padding); gts from
    ``single_gts``, and in image 0's last slot a 291 x 291 box, which the
    coarsest levels' anchors match."""
    gen = torch.Generator().manual_seed(SEED + 150)
    side = 300 if name == "ssd" else 320
    shapes = torch.tensor([[side, side], [225.0 if name == "ssd" else 213.0, side]])
    image = torch.randn((2, side, side, 3), generator=gen)
    image[1, int(shapes[1, 0]):] = 0.0
    boxes, labels, valid = single_gts(gen, shapes)
    boxes[0, -1] = torch.tensor([4.0, 4.0, 294.0, 294.0])
    labels[0, -1], valid[0, -1] = 1, True
    return dict(image=image, gt_boxes=boxes, gt_labels=labels, gt_valid=valid, img_shape=shapes)


def single_reference_models(name: str):
    """The float32 builds on the card and on the CPU: SSD300 (its trunk has
    no width knob), YOLOv3 narrow (``YOLO_NARROW``, the objectness biases at
    0 as ``load_single``'s), YOLOX narrow (``YOLOX_NARROW``, the class and
    objectness biases at 0 as ``load_single``'s), CenterNet R18 with narrow
    deconvolutions (``CENTERNET_NARROW``)."""
    if name == "ssd":
        return load_model("float32", "cuda", SSD300_CONFIG)[0], load_model(
            "float32", "cpu", SSD300_CONFIG)
    if name in ("yolox", "centernet"):
        config, narrow = {"yolox": (YOLOX_CONFIG, YOLOX_NARROW),
                          "centernet": (CENTERNET_CONFIG, CENTERNET_NARROW)}[name]
        det_cfg = build_detection_cfg(Config.fromfile(config).detection)
        gpu, cpu = (build_detector(narrow, "float32", device=d, seed=SEED) for d in ("cuda", "cpu"))
        if name == "yolox":
            for model in (gpu, cpu):
                zero_yolox_priors(model, det_cfg)
        return gpu, (cpu, det_cfg)
    det_cfg = build_detection_cfg(Config.fromfile(YOLO_CONFIG).detection)
    gpu, cpu = (build_detector(YOLO_NARROW, "float32", device=d, seed=SEED)
                for d in ("cuda", "cpu"))
    for model in (gpu, cpu):
        zero_objectness(model, det_cfg)
    return gpu, (cpu, det_cfg)


# float32 ulps between two devices' box coding (its log, then one division)
DECODE_ULPS = 2


def head_maps(outs) -> list:
    """The head's output maps in one list: YOLOv3's prediction maps, SSD's
    class maps then box maps."""
    return list(outs) if isinstance(outs[0], torch.Tensor) else [t for o in outs for t in o]


def tie_padding(outs, det_cfg, padded_from: float):
    """SSD head outputs (CPU) with image 1's level-0 anchors whose centre
    lies at or below row ``padded_from`` given one output vector an anchor
    kind (that of the last of them), its background logit lowered by 8 so
    that they lead the negatives' ranking: the exact ties of a conv over a
    blank region."""
    cls, reg = [list(branch) for branch in outs]
    stride = det_cfg.anchor_generator.strides[0]
    rows = (torch.arange(cls[0].shape[1]) + 0.5) * stride >= float(padded_from)
    c0 = cls[0].clone()
    vector = c0[1, -1, -1].clone()
    vector[0::det_cfg.num_classes + 1] -= 8.0
    c0[1, rows] = vector
    cls[0] = c0
    return tuple(cls), tuple(reg)


def phase_single_reference() -> None:
    """SSD300 and a narrow YOLOv3 in float32 on the GPU and on the CPU, on
    ``single_reference_batch``: the trunk features and the head outputs
    (1e-4 of each map's largest value); then on equal inputs (the CPU's
    head outputs fed to both): the assignment exactly (SSD's positives,
    negatives and labels, YOLOv3's responsible flags, assigned gts and
    labels) and the encoded targets within ``DECODE_ULPS`` ulps; SSD's
    mined set exactly, from each device's own cross-entropy and on inputs
    whose padding anchors tie exactly across the cut (R11); YOLOv3's
    preselection exactly; the candidates' scores to 1e-6 and boxes to
    1e-3 px (the softmax sums in another order on each device), the NMS
    exactly, the losses to 1e-5; then every parameter's gradient through
    the whole model to 1e-2 in relative norm."""
    for name in ("ssd", "yolov3"):
        batch = single_reference_batch(name)
        on_gpu = {k: v.cuda() for k, v in batch.items()}
        gpu, (cpu, det_cfg) = single_reference_models(name)
        checks = []

        def check(what, err, limit):
            checks.append(f"{what} {err:.2e} (limit {limit:g})")
            if not err <= limit:
                raise AssertionError(f"{name} reference check {what}: {err} > {limit}")

        gts = ("gt_boxes", "gt_labels", "gt_valid")
        with torch.inference_mode():
            fg, fc = gpu.backbone(on_gpu["image"]), cpu.backbone(batch["image"])
            check("trunk features", max(rel_to_max(g, c) for g, c in zip(fg, fc)), 1e-4)
            if gpu.neck is not None:
                fg, fc = gpu.neck(fg), cpu.neck(fc)
                check("neck outputs", max(rel_to_max(g, c) for g, c in zip(fg, fc)), 1e-4)
            og, oc = gpu.head(fg), cpu.head(fc)
            check("head outputs", max(rel_to_max(g, c) for g, c in zip(head_maps(og),
                                                                         head_maps(oc))), 1e-4)
            # equal inputs from here: the CPU's head outputs on both devices
            oh = (tuple(t.cuda() for t in oc) if name == "yolov3"
                  else tuple(tuple(t.cuda() for t in branch) for branch in oc))
            if name == "ssd":
                sizes = [tuple(s.shape[1:3]) for s in oc[0]]
                anchors = det_cfg.anchor_generator.flat_anchors(sizes)
                tg = ssd_targets(det_cfg, anchors.cuda(), *(on_gpu[k] for k in gts))
                tc = ssd_targets(det_cfg, anchors, *(batch[k] for k in gts))
                for field in ("pos", "neg", "labels"):
                    check(f"assignment {field} mismatches",
                          float((getattr(tg, field).cpu() != getattr(tc, field)).sum()), 0)
                check("encoded targets (ulps)", ulps_apart(tg.reg_targets, tc.reg_targets),
                      DECODE_ULPS)
                padded = (anchors[:, 1] + anchors[:, 3]) * 0.5 >= batch["img_shape"][1, 0]
                ce = cross_entropy(flatten_ssd_outputs(det_cfg, *oc)[0], tc.labels)
                mined = hard_negatives(det_cfg, ce, tc.pos, tc.neg)
                natural = ce[1][padded & tc.neg[1]]
                ties = int((natural[:, None] == natural[None]).sum(1).gt(1).sum())
                extra = (f"image 1: {int(mined[1].sum())} mined, {int((mined[1] & padded).sum())} "
                         f"of them over the padding (R11); {ties} of its {len(natural)} padding "
                         "negatives tie another's loss")
                mined_own = hard_negatives(det_cfg, cross_entropy(flatten_ssd_outputs(
                    det_cfg, *oh)[0], tg.labels), tg.pos, tg.neg)
                check("mined set from each device's own cross-entropy, mismatches",
                      float((mined_own.cpu() != mined).sum()), 0)
                # the exact ties a conv over a large blank region gives: image 1's padding
                # anchors of level 0 take one output vector an anchor kind, on both devices
                tied = tie_padding(oc, det_cfg, batch["img_shape"][1, 0])
                ce_t = cross_entropy(flatten_ssd_outputs(det_cfg, *tied)[0], tc.labels)
                kc = hard_negatives(det_cfg, ce_t, tc.pos, tc.neg)
                kg = hard_negatives(det_cfg, cross_entropy(flatten_ssd_outputs(det_cfg, *(
                    tuple(t.cuda() for t in branch) for branch in tied))[0], tg.labels),
                    tg.pos, tg.neg)
                check("mined set on tied inputs, mismatches", float((kg.cpu() != kc).sum()), 0)
                top = ce_t[1][tc.neg[1]].max()
                group = tc.neg[1] & (ce_t[1] == top)
                straddle = int((kc[1] & group).sum())
                first = torch.nonzero(group)[:straddle, 0]
                if not 0 < straddle < int(group.sum()) or not bool(kc[1][first].all()):
                    raise AssertionError(f"ssd: the tied group of {int(group.sum())} has "
                                         f"{straddle} mined: the cut is not inside it, or "
                                         "not at its lowest indices")
                extra += (f"; on tied inputs the cut falls inside a group of {int(group.sum())} "
                          f"equal losses ({straddle} mined, the lowest indices)")
            else:
                sizes = [tuple(p.shape[1:3]) for p in oc]
                gen = det_cfg.anchor_generator
                rg = gen.responsible_flags(sizes, on_gpu["gt_boxes"], on_gpu["gt_valid"])
                rc = gen.responsible_flags(sizes, batch["gt_boxes"], batch["gt_valid"])
                check("responsible flag mismatches", float((rg.cpu() != rc).sum()), 0)
                tg = yolo_targets(det_cfg, sizes, *(on_gpu[k] for k in gts), on_gpu["img_shape"])
                tc = yolo_targets(det_cfg, sizes, *(batch[k] for k in gts), batch["img_shape"])
                for field in ("pos", "neg", "label0"):
                    check(f"assignment {field} mismatches",
                          float((getattr(tg, field).cpu() != getattr(tc, field)).sum()), 0)
                check("encoded targets (ulps)", ulps_apart(tg.box_targets, tc.box_targets),
                      DECODE_ULPS)
                pg, pc = preselect_yolo(det_cfg, oh), preselect_yolo(det_cfg, oc)
                check("preselection mismatches", float((pg.pred.cpu() != pc.pred).sum()
                                                       + (pg.anchors.cpu() != pc.anchors).sum()), 0)
                extra = (f"{int(rc.sum())} responsible anchors, {int(tc.pos.sum())} positives, "
                         f"{int((tc.neg == 0).sum() - tc.pos.sum())} ignored")
            sg, bg = single_candidates(det_cfg, oh, on_gpu["img_shape"])
            sc, bc = single_candidates(det_cfg, oc, batch["img_shape"])
            # the softmax's sum over C + 1 logits runs in another order on each device
            check("candidate scores", float((sg.cpu() - sc).abs().max()), 1e-6)
            check("candidate boxes (px)", float((bg.cpu() - bc).abs().max()), 1e-3)
            exact = (f"{int((sg.cpu() != sc).sum() + (bg.cpu() != bc).sum())} candidate values not "
                     f"bit-equal, at most {ulps_apart(sg, sc)} and {ulps_apart(bg, bc)} ulps apart")
            ng, nc = dense_nms(det_cfg, sc.cuda(), bc.cuda()), dense_nms(det_cfg, sc, bc)
            for field in ("valid", "labels", "indices", "scores", "boxes"):
                check(f"NMS on equal inputs, {field} mismatches",
                      float((getattr(ng, field).cpu() != getattr(nc, field)).sum()), 0)
            if not bool(nc.valid.any(dim=1).all()):
                raise AssertionError(f"{name}: no detection in the reference batch")
            lossg, lossc = single_losses(det_cfg, oh, on_gpu), single_losses(det_cfg, oc, batch)
        keys = SINGLE_LOSS_KEYS["yolov3" if name == "yolov3" else "ssd300"]
        check("losses on equal inputs", max(abs(float(lossg[k]) - float(lossc[k]))
                                            / abs(float(lossc[k])) for k in keys), 1e-5)
        check("num_pos mismatches", abs(float(lossg["num_pos"]) - float(lossc["num_pos"])), 0)
        gpu.train(), cpu.train()
        for model, data in ((gpu, on_gpu), (cpu, batch)):
            loss, _ = build_loss_fn(model, det_cfg)(data)
            loss.backward()

        def rel_norm(a, b):
            a, b = a.cpu().double(), b.cpu().double()
            return float((a - b).norm() / b.norm().clamp_min(1e-300))

        errs = {n: rel_norm(g.grad, c.grad) for (n, g), (_, c) in
                zip(gpu.named_parameters(), cpu.named_parameters())
                if g.requires_grad and c.grad is not None and c.grad.abs().max() > 0}
        worst = max(errs, key=errs.get)
        check(f"gradients' relative norm of the difference (worst at {worst})", errs[worst], 1e-2)
        log(f"{name} reference check, GPU vs CPU float32 ({extra}; {nc.valid.sum(1).tolist()} "
            f"detections; {exact}; {len(errs)} gradients): "
            + "; ".join(checks))
        del gpu, cpu
    for name in ("yolox", "centernet"):
        point_reference(name)


def to_device(outs, device):
    """A nest of tuples of tensors on ``device``."""
    if isinstance(outs, torch.Tensor):
        return outs.to(device)
    return tuple(to_device(o, device) for o in outs)


# float32 ulps within which two SimOTA costs (a sum over 80 classes in another order on each
# device, then + 3 -log IoU + 1e5) count as one
SIMOTA_ULPS = 4


def simota_differences(ag, ac) -> tuple:
    """The GPU's and the CPU's SimOTA on equal inputs: (selections that
    differ, of them unexplained, conflicts resolved to another gt, of them
    unexplained). A selection is explained where the CPU's cost lies within
    ``SIMOTA_ULPS`` of its gt's k_g-th smallest cost, a conflict where the
    CPU's costs of the two gts lie within ``SIMOTA_ULPS`` of each other."""
    cost, kth = ac.cost, ac.kth
    sel_c = (cost <= kth[:, None, :]) & (cost < SIMOTA_INF)
    sel_g = ((ag.cost <= ag.kth[:, None, :]) & (ag.cost < SIMOTA_INF)).cpu()
    diff = torch.nonzero(sel_g != sel_c)
    near = [float(ulp_gap(cost[b, n, g], kth[b, g])) <= SIMOTA_ULPS for b, n, g in diff.tolist()]
    both = ac.fg & ag.fg.cpu() & (ac.matched != ag.matched.cpu())
    swaps = torch.nonzero(both)
    tied = [float(ulp_gap(cost[b, n, ac.matched[b, n]], cost[b, n, ag.matched.cpu()[b, n]]))
            <= SIMOTA_ULPS for b, n in swaps.tolist()]
    return len(near), near.count(False), len(tied), tied.count(False)


@contextlib.contextmanager
def fixed_simota(assignment):
    """``yolox_loss`` with SimOTA's result replaced by ``assignment``, moved
    to the device of each call: the losses and gradients of two devices
    under one assignment."""
    def assigned(cfg, cls_logits, *args):
        return yolox_mod.SimOTA(*(t.to(cls_logits.device) for t in assignment))

    plain = yolox_mod.simota_assign
    yolox_mod.simota_assign = assigned
    try:
        yield
    finally:
        yolox_mod.simota_assign = plain


def plateau_heat(gen: torch.Generator, shape) -> torch.Tensor:
    """(B, H, W, C) CPU logits on a grid of quarters (many equal scores)
    with 3 x 3 and 2 x 4 blocks of one high logit (plateaus) in each image."""
    heat = torch.round(torch.randn(shape, generator=gen) * 6 - 4) / 4
    for i in range(shape[0]):
        heat[i, 5 + i:8 + i, 9:12, 2 + i] = 6.0
        heat[i, 20:22, 3 + i:7 + i, 50] = 6.0
    return heat


def point_reference(name: str) -> None:
    """A narrow YOLOX or CenterNet R18 (narrow deconvolutions) in float32 on
    the GPU and on the CPU, on ``single_reference_batch``: trunk, neck and
    head to 1e-4 of each map's largest value; then on equal inputs (the
    CPU's head outputs on both): YOLOX's SimOTA positive set and matched
    gts equal but where two costs lie within ``SIMOTA_ULPS`` (the count is
    logged), its candidates to 1e-6 and 1e-3 px and the NMS exactly;
    CenterNet's targets bit for bit, the top-k scores within 2 ulps, and on
    logits with plateaus the peak set, the top-k and the decode's indices,
    labels and validity exactly and its boxes to 1e-3 px; the losses to
    1e-5 and every gradient through the whole model to 1e-2 in relative
    norm, YOLOX's under the CPU's SimOTA on both devices (costs of 1e5 plus
    a few tens tie at float32's 0.008 steps, and the devices' sums over 80
    classes round such a tie apart, which moves a positive)."""
    batch = single_reference_batch(name)
    on_gpu = {k: v.cuda() for k, v in batch.items()}
    gpu, (cpu, det_cfg) = single_reference_models(name)
    checks, extra = [], []

    def check(what, err, limit):
        checks.append(f"{what} {err:.2e} (limit {limit:g})")
        if not err <= limit:
            raise AssertionError(f"{name} reference check {what}: {err} > {limit}")

    gts = ("gt_boxes", "gt_labels", "gt_valid")
    one_assignment = contextlib.nullcontext
    with torch.inference_mode():
        fg, fc = gpu.backbone(on_gpu["image"]), cpu.backbone(batch["image"])
        check("trunk features", max(rel_to_max(g, c) for g, c in zip(fg, fc)), 1e-4)
        fg, fc = gpu.neck(fg), cpu.neck(fc)
        check("neck outputs", max(rel_to_max(g, c) for g, c in zip(fg, fc)), 1e-4)
        og, oc = gpu.head(fg), cpu.head(fc)
        check("head outputs", max(rel_to_max(g, c) for g, c in zip(head_maps(og), head_maps(oc))),
              1e-4)
        oh = to_device(oc, "cuda")  # equal inputs from here
        if name == "yolox":
            ag = yolox_assign(det_cfg, oh, *(on_gpu[k] for k in gts))
            ac = yolox_assign(det_cfg, oc, *(batch[k] for k in gts))
            sel, sel_bad, swaps, swap_bad = simota_differences(ag, ac)
            check("SimOTA selections that differ beyond the cost ulps", sel_bad, 0)
            check("SimOTA conflicts resolved otherwise beyond the cost ulps", swap_bad, 0)
            extra.append(f"{int(ac.fg.sum())} positives, {sel} selections and {swaps} conflicts "
                         f"differing between the devices where two costs lie within {SIMOTA_ULPS} "
                         "ulps")
            one_assignment = functools.partial(fixed_simota, ac)
            sg, bg = single_candidates(det_cfg, oh, on_gpu["img_shape"])
            sc, bc = single_candidates(det_cfg, oc, batch["img_shape"])
            check("candidate scores", float((sg.cpu() - sc).abs().max()), 1e-6)
            check("candidate boxes (px)", float((bg.cpu() - bc).abs().max()), 1e-3)
            ng, nc = dense_nms(det_cfg, sc.cuda(), bc.cuda()), dense_nms(det_cfg, sc, bc)
            for field in ("valid", "labels", "indices", "scores", "boxes"):
                check(f"NMS on equal inputs, {field} mismatches",
                      float((getattr(ng, field).cpu() != getattr(nc, field)).sum()), 0)
            if not bool(nc.valid.any(dim=1).all()):
                raise AssertionError(f"{name}: no detection in the reference batch")
            extra.append(f"{nc.valid.sum(1).tolist()} detections")
        else:
            size = tuple(oc[0].shape[1:3])
            tg = centernet_targets(det_cfg, size, *(on_gpu[k] for k in gts))
            tc = centernet_targets(det_cfg, size, *(batch[k] for k in gts))
            for field in ("heat", "wh", "offset", "ind", "mask"):
                check(f"targets' {field}, values not bit-equal",
                      float((getattr(tg, field).cpu() != getattr(tc, field)).sum()), 0)
            extra.append(f"{int(tc.mask.sum())} valid gts, {int((tc.heat > 0).sum())} heat "
                         "cells above 0")
            k = det_cfg.max_detections
            top_g = nms_ops.top_k_stable(centernet_peaks(oh[0]), k)
            top_c = nms_ops.top_k_stable(centernet_peaks(oc[0]), k)
            check("top-k scores (ulps)", float(ulp_gap(top_g[0], top_c[0]).max()), 2)
            extra.append(f"{int((top_g[1].cpu() != top_c[1]).sum())} of the top-k indices "
                         "differ on the head's own outputs")
            heat = plateau_heat(torch.Generator().manual_seed(SEED + 151), oc[0].shape)
            pg, pc = centernet_peaks(heat.cuda()), centernet_peaks(heat)
            check("plateau peak set mismatches", float(((pg.cpu() > 0) != (pc > 0)).sum()), 0)
            dg = decode_centernet(det_cfg, heat.cuda(), oh[1], oh[2], on_gpu["img_shape"])
            dc = decode_centernet(det_cfg, heat, oc[1], oc[2], batch["img_shape"])
            for field in ("valid", "labels", "indices"):
                check(f"plateau decode {field} mismatches",
                      float((getattr(dg, field).cpu() != getattr(dc, field)).sum()), 0)
            check("plateau decode boxes (px)", float((dg.boxes.cpu() - dc.boxes).abs().max()), 1e-3)
            ties = int((pc.sort(dim=1, descending=True).values[:, k - 1:k + 1].diff() == 0).sum())
            kept = pc.reshape(heat.shape) > 0
            whole = all(bool(kept[i, 5 + i:8 + i, 9:12, 2 + i].all())
                        and bool(kept[i, 20:22, 3 + i:7 + i, 50].all()) for i in range(2))
            if not ties or not whole:
                raise AssertionError(f"{name}: the plateau input has no tie at the top-k cut "
                                     f"({ties}) or a plateau cell was not kept ({whole})")
            extra.append(f"plateau input: {int((pc > 0).sum())} peaks, the cut inside a tie in "
                         f"{ties} of 2 images")
        with one_assignment():
            lossg, lossc = single_losses(det_cfg, oh, on_gpu), single_losses(det_cfg, oc, batch)
    keys = SINGLE_LOSS_KEYS[name]
    check("losses on equal inputs", max(abs(float(lossg[k]) - float(lossc[k]))
                                        / abs(float(lossc[k])) for k in keys), 1e-5)
    check("num_pos mismatches", abs(float(lossg["num_pos"]) - float(lossc["num_pos"])), 0)
    gpu.train(), cpu.train()
    with one_assignment():
        for model, data in ((gpu, on_gpu), (cpu, batch)):
            loss, _ = build_loss_fn(model, det_cfg)(data)
            loss.backward()

    def rel_norm(a, b):
        a, b = a.cpu().double(), b.cpu().double()
        return float((a - b).norm() / b.norm().clamp_min(1e-300))

    errs = {n: rel_norm(g.grad, c.grad) for (n, g), (_, c) in
            zip(gpu.named_parameters(), cpu.named_parameters())
            if g.requires_grad and c.grad is not None and c.grad.abs().max() > 0}
    worst = max(errs, key=errs.get)
    check(f"gradients' relative norm of the difference (worst at {worst})", errs[worst], 1e-2)
    log(f"{name} reference check, GPU vs CPU float32 ({'; '.join(extra)}; {len(errs)} "
        "gradients): " + "; ".join(checks))


# ---------------------------------------------------------------- the entry points on SSD300
SMOKE_COCO_SSD = ROOT / "build" / "smoke_coco_ssd"
SSD_CLI_LANDSCAPE, SSD_CLI_PORTRAIT, SSD_CLI_VAL = 40, 8, 12
PORTRAIT_FIXTURES = ("portrait_375x500.jpg", "odd_333x501.jpg")
VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)  # torchvision's features indices


def write_smoke_coco_ssd(split: str, n_landscape: int, n_portrait: int, seed: int,
                         root: Path = SMOKE_COCO_SSD) -> Path:
    """Committed JPEG fixtures under ``root/split``: ``n_landscape``
    of COCO's landscape and square sizes and ``n_portrait`` portraits
    (375 x 500 and 333 x 501), in a seeded order, with 1-20 seeded boxes an
    image over COCO's category ids and a crowd box in every fourth."""
    rng = np.random.default_rng(seed)
    picks = pick_fixtures(rng, CLI_SIZES, n_landscape, 2)
    picks += [JPEG_FIXTURES / PORTRAIT_FIXTURES[i % 2] for i in range(n_portrait)]
    picks = [picks[int(i)] for i in rng.permutation(len(picks))]
    img_dir = root / split
    img_dir.mkdir(parents=True, exist_ok=True)
    images, annotations = [], []
    for i, src in enumerate(picks):
        w, h = fixture_size(src)
        name = f"{i + 1:012d}.jpg"
        shutil.copyfile(src, img_dir / name)
        boxes = int(rng.integers(1, 21))
        for j, (x, y, bw, bh) in enumerate(seeded_boxes(rng, w, h, boxes + (i % 4 == 3))):
            annotations.append(dict(id=len(annotations) + 1, image_id=i + 1,
                                    category_id=int(rng.choice(COCO_CATEGORY_IDS)),
                                    bbox=[x, y, bw, bh], area=bw * bh, iscrowd=int(j == boxes)))
        images.append(dict(id=i + 1, file_name=name, width=w, height=h))
    ann_file = root / f"instances_{split}.json"
    ann_file.write_text(json.dumps(dict(
        images=images, annotations=annotations,
        categories=[dict(id=c, name=f"category_{c}") for c in COCO_CATEGORY_IDS])))
    return ann_file


def write_torchvision_vgg16(path: Path, seed: int) -> dict:
    """A seeded state dict in torchvision's VGG16 layout: the 13 convs as
    ``features.{k}.weight`` and ``.bias`` at their shapes (normal kernels of
    variance 2 / fan_in, biases normal(0, 0.01)), and ``classifier.{0,3,6}``
    under their names at small shapes (the importer drops them by name)."""
    gen = torch.Generator().manual_seed(seed)
    state, cin = {}, 3
    for k, width in zip(VGG16_CONVS, (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512,
                                      512)):
        state[f"features.{k}.weight"] = torch.randn((width, cin, 3, 3), generator=gen) * math.sqrt(
            2.0 / (9 * cin))
        state[f"features.{k}.bias"] = torch.randn((width,), generator=gen) * 0.01
        cin = width
    for k in (0, 3, 6):
        state[f"classifier.{k}.weight"] = torch.zeros((8, 8))
        state[f"classifier.{k}.bias"] = torch.zeros((8,))
    torch.save(state, str(path))
    return state


def phase_cli_ssd(card: str) -> dict:
    """SSD300 through the entry points at full width: a seeded JPEG COCO
    folder under build/smoke_coco_ssd (landscape, square and portrait
    images; the square canvas holds a portrait, unlike R8's), a seeded
    torchvision-layout VGG16 ``.pth`` given as ``--pretrained file://``
    (copied into a cache under the folder), ``tools.train`` for one epoch of
    the config's b32 (the log reports the 26 trunk tensors set; epoch_1's
    trunk near the file's), ``tools.test`` on ``epoch_1`` (12 finite
    metrics, a results JSON inside each frame), and the val gts' oracle.
    K1, K2 and the matcher never launch."""
    shutil.rmtree(SMOKE_COCO_SSD, ignore_errors=True)
    train_ann = write_smoke_coco_ssd("train", SSD_CLI_LANDSCAPE, SSD_CLI_PORTRAIT, SEED + 160)
    val_ann = write_smoke_coco_ssd("val", SSD_CLI_VAL - 4, 4, SEED + 161)
    pth = SMOKE_COCO_SSD / "vgg16.pth"
    vgg = write_torchvision_vgg16(pth, SEED + 162)
    config = SMOKE_COCO_SSD / "ssd300_vgg16_smoke.py"
    work = SMOKE_COCO_SSD / "work"
    data = {split: dict(ann_file=str(ann), img_prefix=str(SMOKE_COCO_SSD / split))
            for split, ann in (("train", train_ann), ("val", val_ann))}
    config.write_text(
        f"_base_ = {str(SSD300_CONFIG)!r}\n"
        f"data = dict(**{data!r})\n"
        "detection = dict(score_thr=0.0)\n"
        "schedule = dict(warmup_steps=100)\n"
        f"runtime = dict(work_dir={str(work)!r}, log_interval=1)\n")
    cfg = Config.fromfile(config)
    det_cfg = build_detection_cfg(cfg["detection"])
    cache = os.environ.get("XDG_CACHE_HOME")
    os.environ["XDG_CACHE_HOME"] = str(SMOKE_COCO_SSD / "cache")
    try:
        reset_launches()
        t0 = time.perf_counter()
        with logged_lines() as lines:
            trainer = train_cli.main([str(config), "--epochs", "1", "--work-dir", str(work),
                                      "--pretrained", f"file://{pth}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if cache is None:
            os.environ.pop("XDG_CACHE_HOME")
        else:
            os.environ["XDG_CACHE_HOME"] = cache
    launches = read_launches()
    expect_launches("cli ssd training", launches, 0, 0)
    loaded = [line for line in lines if line.startswith("loaded ") and "vgg16.pth" in line]
    if len(loaded) != 1 or not loaded[0].startswith("loaded 26 tensors") or \
            "26 of the backbone's 47" not in loaded[0]:
        raise AssertionError(f"cli ssd: the import logged {loaded}")
    if not (SMOKE_COCO_SSD / "cache" / "torch_detection_tpu" / "checkpoints"
            / "vgg16.pth").exists():
        raise AssertionError("cli ssd: file:// did not go through the cache")
    steps = len(trainer.dataloader)
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    keys = SINGLE_LOSS_KEYS["ssd300"]
    if len(records) != steps or not all(math.isfinite(r[k]) for r in records for k in keys):
        raise AssertionError(f"cli ssd training: {len(records)} records for {steps} steps, or a "
                             "non-finite loss")
    saved = load_checkpoint_file(str(work / "epoch_1"))["model"]
    drift = max(float((saved[f"backbone.layer{s}.conv.weight"].float()
                       - vgg[f"features.{k}.weight"]).norm() / vgg[f"features.{k}.weight"].norm())
                for s, k in zip(("1_0", "3_2", "5_2"), (0, 14, 28)))
    if not drift < 0.05:
        raise AssertionError(f"cli ssd: epoch_1's trunk is {drift} (relative norm) from the file's")
    log(f"cli ssd training [{card}]: {SSD_CLI_LANDSCAPE} landscape and square and "
        f"{SSD_CLI_PORTRAIT} portrait JPEGs, {steps} steps of b{cfg['data']['sample_per_replica']} "
        f"on {tuple(cfg['data']['canvas'])} in {wall:.1f} s (the build and the import included); "
        f"{loaded[0]!r}; epoch_1's trunk convs within {drift:.4f} of the file's (relative norm); "
        f"launches {launches}; losses " + "; ".join(
            f"{k} {[round(r[k], 4) for r in records]}" for k in keys))
    del trainer

    out = SMOKE_COCO_SSD / "results.json"
    reset_launches()
    t0 = time.perf_counter()
    metrics = test_cli.main([str(config), str(work / "epoch_1"), "--out", str(out)])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = read_launches()
    expect_launches("cli ssd test", test_launches, 0, 0)
    frames, results, oracle = check_cli_results("cli ssd", metrics, out, val_ann, cfg, det_cfg)
    log(f"cli ssd test [{card}]: {len(frames)} images ({sum(h > w for w, h in frames.values())} "
        f"portrait) in {test_s:.1f} s (the build included), launches {test_launches}; "
        f"{len(results)} detections in the COCO results JSON, each inside its original frame; "
        f"mAP {metrics['mAP']:.6f} (random weights after one epoch), the val gts as detections "
        f"give mAP {oracle:.6f}; " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    return dict(training=launches, test=test_launches, mAP=metrics["mAP"])


SMOKE_COCO_YOLOX = ROOT / "build" / "smoke_coco_yolox"
YOLOX_CLI_LANDSCAPE, YOLOX_CLI_PORTRAIT, YOLOX_CLI_VAL, YOLOX_CLI_EPOCHS = 24, 8, 12, 2


def check_cli_results(what: str, metrics: dict, out: Path, val_ann: Path, cfg, det_cfg) -> tuple:
    """12 finite metrics, a results JSON with a detection in every image and
    each inside its original frame, and the val gts as detections scoring
    mAP 1.0; returns (frames, results, oracle mAP)."""
    if len(metrics) != 12 or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{what} test metrics {metrics}")
    frames = {img["id"]: (img["width"], img["height"])
              for img in json.loads(val_ann.read_text())["images"]}
    results = json.loads(out.read_text())
    if not results or {r["image_id"] for r in results} != set(frames):
        raise AssertionError(f"{what} test: {len(results)} results over "
                             f"{len({r['image_id'] for r in results})} of {len(frames)} images")
    for r in results:
        x, y, w, h = r["bbox"]
        fw, fh = frames[r["image_id"]]
        if not (w >= 0 and h >= 0 and x >= 0 and y >= 0 and x + w <= (fw + 1) * 1.01
                and y + h <= (fh + 1) * 1.01):
            raise AssertionError(f"{what} test result outside its image: {r}")
    val = get_datasets(dict(cfg["data"]["val"]))
    anns = [val.get_ann_info(i) for i in range(len(val))]
    oracle = eval_coco_map([dict(boxes=a["bboxes"], scores=np.ones(len(a["bboxes"])),
                                 labels=a["labels"]) for a in anns], anns, det_cfg.num_classes)
    if abs(oracle["mAP"] - 1.0) > 1e-12:
        raise AssertionError(f"{what}: the gt oracle scores {oracle['mAP']}")
    return frames, results, oracle["mAP"]


def phase_cli_yolox(card: str) -> dict:
    """YOLOX-S through the entry points at full width: a seeded COCO folder
    of the committed JPEG fixtures under build/smoke_coco_yolox (landscape,
    square and portrait; every val image, portraits among them, resized
    keep-ratio inside the 640 x 640 canvas), ``tools.train`` for 2 epochs of
    the config's b8 from the seeded init, ``tools.test --out`` on the last
    epoch (12 finite metrics, every image with a detection inside its
    frame) and the val gts' oracle; K1, K2 and the matcher never launch.
    The config sets ``score_thr`` 0, so the random weights leave
    detections for the evaluator; the 0.01 priors stay (``tools.train``
    builds and trains the model itself, and at ``score_thr`` 0 their
    scores of about 1e-4 pass)."""
    shutil.rmtree(SMOKE_COCO_YOLOX, ignore_errors=True)
    train_ann = write_smoke_coco_ssd("train", YOLOX_CLI_LANDSCAPE, YOLOX_CLI_PORTRAIT, SEED + 190,
                                     SMOKE_COCO_YOLOX)
    val_ann = write_smoke_coco_ssd("val", YOLOX_CLI_VAL - 4, 4, SEED + 191, SMOKE_COCO_YOLOX)
    config = SMOKE_COCO_YOLOX / "yolox_s_smoke.py"
    work = SMOKE_COCO_YOLOX / "work"
    data = {split: dict(ann_file=str(ann), img_prefix=str(SMOKE_COCO_YOLOX / split))
            for split, ann in (("train", train_ann), ("val", val_ann))}
    config.write_text(
        f"_base_ = {str(YOLOX_CONFIG)!r}\n"
        f"data = dict(**{data!r})\n"
        "detection = dict(score_thr=0.0)\n"
        "schedule = dict(warmup_steps=4)\n"
        f"runtime = dict(work_dir={str(work)!r}, log_interval=1)\n")
    cfg = Config.fromfile(config)
    det_cfg = build_detection_cfg(cfg["detection"])
    canvas = tuple(cfg["data"]["canvas"])
    val = get_datasets(dict(cfg["data"]["val"]))
    held = []
    for i in range(len(val)):
        h, w = val[i]["img_meta"][0].data["img_shape"][:2]
        if h > canvas[0] or w > canvas[1] or max(h, w) < canvas[0] - 1:
            raise AssertionError(f"cli yolox: val image {i} resized to {(h, w)}, not held by "
                                 f"the {canvas} canvas at its longer side")
        held.append(h > w)
    if sum(held) < 2:
        raise AssertionError(f"cli yolox: {sum(held)} portrait val images")
    reset_launches()
    t0 = time.perf_counter()
    trainer = train_cli.main([str(config), "--epochs", str(YOLOX_CLI_EPOCHS), "--work-dir",
                              str(work)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    expect_launches("cli yolox training", launches, 0, 0)
    steps = len(trainer.dataloader)
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    keys = SINGLE_LOSS_KEYS["yolox"]
    if len(records) != steps * YOLOX_CLI_EPOCHS or not all(
            math.isfinite(r[k]) for r in records for k in keys) or not all(
            r["num_pos"] > 0 for r in records):
        raise AssertionError(f"cli yolox training: {len(records)} records for "
                             f"{YOLOX_CLI_EPOCHS} x {steps} steps, or a non-finite loss or no "
                             "positive")
    log(f"cli yolox training [{card}]: {YOLOX_CLI_LANDSCAPE} landscape and square and "
        f"{YOLOX_CLI_PORTRAIT} portrait JPEGs, {YOLOX_CLI_EPOCHS} epochs of {steps} steps of "
        f"b{cfg['data']['sample_per_replica']} on {canvas} in {wall:.1f} s (the build included); "
        f"the {len(held)} val images held keep-ratio by the canvas ({sum(held)} portrait); "
        f"launches {launches}; " + "; ".join(
            f"{k} {[round(r[k], 4) for r in records]}" for k in keys + ("num_pos",)))
    del trainer

    out = SMOKE_COCO_YOLOX / "results.json"
    reset_launches()
    t0 = time.perf_counter()
    metrics = test_cli.main([str(config), str(work / f"epoch_{YOLOX_CLI_EPOCHS}"), "--out",
                             str(out)])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = read_launches()
    expect_launches("cli yolox test", test_launches, 0, 0)
    frames, results, oracle = check_cli_results("cli yolox", metrics, out, val_ann, cfg, det_cfg)
    log(f"cli yolox test [{card}]: {len(frames)} images ({sum(h > w for w, h in frames.values())} "
        f"portrait) in {test_s:.1f} s (the build included), launches {test_launches}; "
        f"{len(results)} detections in the COCO results JSON, each inside its original frame; "
        f"mAP {metrics['mAP']:.6f} (random weights after {YOLOX_CLI_EPOCHS} epochs), the val gts "
        f"as detections give mAP {oracle:.6f}; "
        + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    return dict(training=launches, test=test_launches, mAP=metrics["mAP"])


# ---------------------------------------------------------------- SOLOv2, Soft-NMS and the golden set
SOLOV2_CONFIG = ROOT / "configs" / "solov2_r50_fpn_coco.py"
SOLOV2_SERVE_BATCH = 4
SOLOV2_LOSS_KEYS = ("loss", "loss_cls", "loss_mask")
SOLOV2_REF_CANVAS = (256, 384)  # the CPU side's full-width model at a small canvas
SMOKE_COCO_SOLOV2 = ROOT / "build" / "smoke_coco_solov2"
SOLOV2_CLI_EPOCHS = 2
SOFT_ULPS = 8  # float32 ulps between the devices' sigmoids and decayed scores (an exp each)
GOLDEN_COCO = ROOT / "build" / "golden_coco"
GOLDEN_PROPOSALS = GOLDEN_COCO / "golden_props.pkl"
GOLDEN_CANVAS, GOLDEN_STEPS, GOLDEN_BATCH = golden_cases.CANVAS, 400, 4
GOLDEN_BAND = {"segm_mAP_50": 0.3, "mAP_50": 0.3}  # tests/test_golden_map.py's SOLOv2 band
GOLDEN_SOLOV2_MODEL = dict(
    type="SOLOV2",
    backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(0, 1, 2, 3)),
    neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=32, num_outs=5),
    head=dict(type="SOLOV2Head", num_classes=2, in_channels=32, feat_channels=32,
              kernel_channels=16, stacked_convs=2, grid_numbers=(12, 10, 8, 6, 4),
              norm_groups=8),
    mask_feat_head=dict(type="MaskFeatHead", in_channels=32, feat_channels=32, out_channels=16,
                        num_inputs=4, norm_groups=8),
)
GOLDEN_SOLOV2_DETECTION = dict(
    style="solov2", num_classes=2, grid_numbers=(12, 10, 8, 6, 4),
    scale_ranges=((1, 32), (16, 48), (32, 64), (48, 96), (64, 256)), max_pos_cells=64,
    pre_nms_top_k=32, max_detections=10, mask_out_size=14, score_thr=0.05, update_thr=0.02)


def load_solov2(dtype: str, device):
    """The SOLOv2 build with ``cls_out``'s bias at 0: at the 0.01 prior
    every class score of random weights is about 0.01, under ``score_thr``
    0.1, and the decode would keep nothing; at 0 the scores sit near 0.5,
    and each candidate's rescored score is that times its maskness."""
    model, det_cfg = load_model(dtype, device, SOLOV2_CONFIG)
    with torch.no_grad():
        model.head.cls_out.bias.zero_()
    return model, det_cfg


def check_solov2_detections(res, det_cfg, shapes: torch.Tensor) -> None:
    """Shapes, a detection in every image above ``update_thr``, finite
    boxes inside each image, labels in range, patches in [0, 1] and 0 on
    invalid slots."""
    b, d, m = shapes.shape[0], det_cfg.max_detections, det_cfg.mask_out_size
    if res.boxes.shape != (b, d, 4) or res.mask_probs.shape != (b, d, m, m):
        raise AssertionError(f"shapes {tuple(res.boxes.shape)}, {tuple(res.mask_probs.shape)}")
    v = res.valid
    if not bool(v.any(dim=1).all()):
        raise AssertionError("an image without a detection")
    if not (torch.isfinite(res.boxes).all() and torch.isfinite(res.mask_probs).all()):
        raise AssertionError("non-finite detections or patches")
    lab, bx = res.labels[v], res.boxes[v]
    if not (bool((lab >= 0).all()) and bool((lab < det_cfg.num_classes).all())):
        raise AssertionError("labels out of range")
    inside = ((res.boxes[..., 0::2] <= shapes[:, None, 1:2] - 1).all(-1)
              & (res.boxes[..., 1::2] <= shapes[:, None, 0:1] - 1).all(-1) & (res.boxes >= 0).all(-1))
    if not bool(inside[v].all()) or not bool((bx[:, 2:] >= bx[:, :2]).all()):
        raise AssertionError("a box outside its image")
    if not bool((res.scores[v] > det_cfg.update_thr).all()):
        raise AssertionError("a valid detection under update_thr")
    probs = res.mask_probs
    if not (bool((probs >= 0).all()) and bool((probs <= 1).all())) or bool(probs[~v].any()):
        raise AssertionError("patches outside [0, 1] or on an invalid slot")


def resize_bf16_probe(card: str) -> None:
    """The head's resize of a bf16 map (P2 at b4 to its 40 x 40 grid):
    ``resize_bilinear`` runs in float32 and rounds once, forward and
    backward in bf16 out; beside it CUDA's own bf16 antialiased kernel, its
    values beyond one bf16 ulp of the float32 resize and both times."""
    from torch_detection_tpu_torch.models.heads.solov2_head import resize_bilinear

    gen = torch.Generator(device="cuda").manual_seed(SEED + 200)
    x = torch.randn((4, 258, 200, 336), generator=gen, device="cuda").to(
        memory_format=torch.channels_last).bfloat16().requires_grad_()
    out = resize_bilinear(x, (40, 40))
    out.float().square().sum().backward()
    resize = functools.partial(F.interpolate, size=(40, 40), mode="bilinear", align_corners=False,
                               antialias=True)
    want = resize(x.detach().float())
    if out.dtype != torch.bfloat16 or x.grad.dtype != torch.bfloat16 or not torch.equal(
            out, want.bfloat16()):
        raise AssertionError("the resize is not the float32 resize rounded once to bf16")
    native = resize(x.detach())
    bad = int((~bf16_within_one_ulp(native, want)).sum())
    ms = cuda_ms(lambda: resize_bilinear(x.detach(), (40, 40)), iters=20)
    native_ms = cuda_ms(lambda: resize(x.detach()), iters=20)
    log(f"solov2 resize, P2 b4 to 40 x 40 [{card}]: in float32, rounded once to bf16, "
        f"{ms:.4f} ms; CUDA's bf16 antialiased kernel {native_ms:.4f} ms, {bad} of {want.numel()} "
        "values beyond one bf16 ulp of the float32 resize")


def solov2_stage_breakdown(model, det_cfg, image, shapes, card: str, repeats: int = 5) -> None:
    """A serving batch stage by stage, a device sync between stages; the
    median host ms of each over ``repeats`` batches."""
    from torch_detection_tpu_torch.models.detectors.solov2 import (
        solov2_candidates,
        solov2_detections,
    )

    times = {}
    stage = stage_timer(times)
    with torch.inference_mode():
        for _ in range(repeats):
            feats = stage("trunk + FPN", lambda: model.features(image))
            cls, kern = stage("head towers (resize to the grids, GN towers, outputs)",
                              lambda: model.head(feats))
            mfeat = stage("mask features (laterals, upsample, out_conv)",
                          lambda: model.mask_feat_head(feats))
            cand = stage("candidates: top 256 of the cell-class scores, dynamic conv, rescoring",
                         lambda: solov2_candidates(det_cfg, cls, kern, mfeat))
            decayed = stage("Matrix NMS", lambda: nms_ops.matrix_nms(
                cand.binary, cand.labels, cand.scores, cand.scores > det_cfg.score_thr,
                det_cfg.nms_method, det_cfg.nms_sigma))
            stage("top 100, extent boxes, crop", lambda: solov2_detections(
                det_cfg, cand, decayed, tuple(mfeat.shape[1:3]), shapes))
    log_breakdown(f"solov2 stage breakdown, median of {repeats} batches", times, card)


def phase_solov2_serving(card: str) -> dict:
    """Full-width SOLOv2 R50-FPN (configs/solov2_r50_fpn_coco.py, bf16,
    ``cls_out``'s bias at 0) answers seeded b4 batches on the config's 800 x
    1344 canvas (two images in every four smaller) through
    ``make_inference_fn(..., segm=True)``, then its box route; K1, K2 and the
    matcher counted (none expected)."""
    resize_bf16_probe(card)
    cfg = Config.fromfile(SOLOV2_CONFIG)
    canvas, b = tuple(cfg["data"]["canvas"]), SOLOV2_SERVE_BATCH
    model, det_cfg = load_solov2("bfloat16", "cuda")
    count = sum(p.numel() for p in model.parameters())
    log(f"solov2: cls_out's bias set to 0 for serving (random weights at the 0.01 prior score "
        f"under score_thr {det_cfg.score_thr}); {count} parameters, {det_cfg.num_cells} cells "
        f"and {det_cfg.num_cells * det_cfg.num_classes} cell-class pairs an image")
    infer = make_inference_fn(model, det_cfg, segm=True)
    image, shapes = padded_images(torch.Generator(device="cuda").manual_seed(SEED + 201), b,
                                  canvas)
    scale = torch.ones(b, device="cuda")

    def run():
        return infer(image, shapes, scale)

    timed_batches(run, WARMUP_BATCHES)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms, results = timed_batches(run, TIMED_BATCHES)
    launches = read_launches()
    expect_launches("solov2 serving", launches, 0, 0)
    for res in results:
        check_solov2_detections(res, det_cfg, shapes)
    mean_ms = sum(ms) / len(ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"solov2 serving path b{b} on {canvas} (segm): ms a batch {[round(m, 3) for m in ms]}, "
        f"mean {mean_ms:.3f} ms, {b / (mean_ms / 1e3):.2f} images/s, median "
        f"{statistics.median(ms):.3f} ms [{card}]; launches {launches}; valid detections an image "
        f"{results[-1].valid.sum(1).tolist()}; peak memory {peak:.2f} GiB")
    box_infer = make_inference_fn(model, det_cfg)
    reset_launches()
    box_ms, box_results = timed_batches(lambda: box_infer(image, shapes, scale), 3)
    expect_launches("solov2 serving, box route", read_launches(), 0, 0)
    for field in ("boxes", "scores", "labels", "valid"):
        if not torch.equal(getattr(box_results[-1], field), getattr(results[-1], field)):
            raise AssertionError(f"solov2: the box route's {field} part from the segm route's")
    log(f"solov2 serving, box route: ms a batch {[round(m, 3) for m in box_ms]}, its detections "
        "those of the segm route")
    solov2_stage_breakdown(model, det_cfg, image, shapes, card)
    profile = device_profile(run, mean_ms, card)
    return dict(launches=launches, ms_per_batch=mean_ms, profile=profile, peak_gib=peak)


def solov2_train_stage_breakdown(model, det_cfg, optimizer, batch, card: str,
                                 repeats: int = 5) -> None:
    """A training step stage by stage: trunk and FPN, the heads, the targets
    on their own (the pooled masks and the cell assignment), the whole loss
    (the targets included), the backward and the optimizer."""
    from torch_detection_tpu_torch.models.detectors.solov2 import downsample_masks

    times = {}
    stage = stage_timer(times)
    g = batch["gt_masks"].shape[1]
    gts = tuple(batch[k][:, :g] for k in ("gt_boxes", "gt_labels", "gt_valid"))
    for _ in range(repeats):
        optimizer.zero_grad()
        feats = stage("trunk + FPN", lambda: model.features(batch["image"]))
        outs = stage("heads (towers, mask features)", lambda: model.heads(feats))
        with torch.no_grad():
            stage("targets (pooled masks, cell assignment)", lambda: solov2_targets(
                det_cfg, *gts, downsample_masks(batch["gt_masks"], det_cfg.mask_stride),
                tuple(batch["image"].shape[1:3])))
        loss = stage("targets + focal + slate, dynamic conv, dice", lambda: solov2_loss(
            det_cfg, *outs, *(batch[k] for k in ("gt_boxes", "gt_labels", "gt_valid",
                                                 "gt_masks")))["loss"])
        stage("backward", loss.backward)
        stage("grad norm, clip, SGD", lambda: optimizer.apply(optimizer.global_norm()))
    optimizer.zero_grad()
    log_breakdown(f"solov2 training stage breakdown, median of {repeats} steps", times, card)


def phase_solov2_train(card: str) -> dict:
    """Full-width SOLOv2 training at the config's b8 on its 800 x 1344
    canvas (``train_batch``'s images and gts, a seeded ellipse mask each),
    float32 parameters and bf16 compute, the config's SGD (momentum 0.9,
    weight decay 1e-4, clip 35), through ``build_train_objects``,
    ``build_loss_fn`` and ``Trainer.run``: 2 warm-up and 10 timed steps;
    K1, K2 and the matcher counted (none expected)."""
    cfg = Config.fromfile(SOLOV2_CONFIG)
    canvas, b = tuple(cfg["data"]["canvas"]), cfg["data"]["sample_per_replica"]
    steps = WARMUP_BATCHES + TIMED_BATCHES
    gen = torch.Generator(device="cuda").manual_seed(SEED + 202)
    batches = [mask_train_batch(gen, b, canvas) for _ in range(steps)]
    model, det_cfg, _, optimizer = build_train_objects(cfg, "cuda", seed=SEED,
                                                       loader=Batches(batches))
    group = optimizer.torch_optimizer.param_groups[0]
    opt = cfg["optimizer"]
    if (optimizer.grad_clip_norm, group["momentum"], group["weight_decay"]) != (
            opt["grad_clip_norm"], opt["momentum"], opt["weight_decay"]):
        raise AssertionError(f"solov2: clip {optimizer.grad_clip_norm}, {group}, config {opt}")
    loss_fn = build_loss_fn(model, det_cfg, rng_seed=SEED)
    Trainer(loss_fn, model, optimizer, Batches(batches[:WARMUP_BATCHES]), log_interval=1).run(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(loss_fn, model, optimizer, Batches(batches[WARMUP_BATCHES:]), log_interval=1)
    reset_launches()
    t0 = time.perf_counter()
    history = trainer.run(1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    expect_launches("solov2 training", launches, 0, 0)
    if len(history) != TIMED_BATCHES or trainer.skipped_steps:
        raise AssertionError(f"solov2: {len(history)} steps logged, {trainer.skipped_steps} skipped")
    for h in history:
        if not all(math.isfinite(h[k]) for k in SOLOV2_LOSS_KEYS) or not h["num_pos"] > 0 or \
                not h["loss_mask"] > 0:
            raise AssertionError(f"solov2: a non-finite loss, no positive or no mask loss: {h}")
    still = [n for n, p in model.named_parameters() if p.requires_grad and torch.equal(p, before[n])]
    if still:
        raise AssertionError(f"solov2: trainable parameters that did not move: {still}")
    step_ms = [b / h["images_per_sec"] * 1e3 for h in history]
    mean_ms = seconds / TIMED_BATCHES * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    masks = [tuple(x["gt_masks"].shape[1:2]) for x in batches]
    log(f"solov2 training path b{b} on {canvas}: ms a step {[round(m, 3) for m in step_ms]}, mean "
        f"{mean_ms:.3f} ms, {b / (mean_ms / 1e3):.2f} images/s, median "
        f"{statistics.median(step_ms):.3f} ms [{card}]; launches {launches}; skipped steps "
        f"{trainer.skipped_steps}; peak memory {peak:.2f} GiB; gt mask rows a batch {masks}; over "
        f"the {TIMED_BATCHES} steps " + "; ".join(
            f"{k} {[round(h[k], 4) for h in history]}" for k in SOLOV2_LOSS_KEYS + ("num_pos",)))
    profile = device_profile(lambda: trainer.train_step(dict(batches[-1])), mean_ms, card, "step")
    solov2_train_stage_breakdown(model, det_cfg, optimizer, batches[-1], card)
    return dict(launches=launches, ms_per_step=mean_ms, profile=profile, peak_gib=peak)


def solov2_reference_batch() -> dict:
    """Two seeded images filling ``SOLOV2_REF_CANVAS`` on the card, 1-20 gts
    an image (``single_gts``: 16 px to 0.9 of the shorter side), a seeded
    ellipse mask each, the mask rows cut to the collate's bucket."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 203)
    h, w = SOLOV2_REF_CANVAS
    shapes = torch.tensor([[h, w]] * 2, dtype=torch.float32, device="cuda")
    boxes, labels, valid = single_gts(gen, shapes)
    g = mask_rows(valid)
    return dict(image=torch.randn((2, h, w, 3), generator=gen, device="cuda"), gt_boxes=boxes,
                gt_labels=labels, gt_valid=valid, img_shape=shapes,
                gt_masks=ellipse_masks(gen, boxes[:, :g], valid[:, :g], (h, w)))


def phase_solov2_reference() -> None:
    """Full-width SOLOv2 in float32 on the GPU and on the CPU (the same
    seeded weights, ``cls_out``'s bias at 0) on ``solov2_reference_batch``:
    the trunk, FPN, head and mask-feature maps (1e-4 of each map's largest
    value); on the same gts the pooled masks, the targets and the loss's
    slate bit for bit. Then on equal inputs (the GPU's maps on both
    devices): the cell-class scores within ``SOFT_ULPS`` ulps (each device's
    sigmoid rounds its own way) and the flat top 256 equal but at ranks
    whose two scores lie within as many; on the CPU's top 256
    the dynamic-conv logits (1e-5) and their masks equal but where a logit
    lies within 1e-6 of the threshold's; on the CPU's candidates the mask
    IoUs bit for bit, the Matrix-NMS scores within ``SOFT_ULPS`` ulps and the
    top 100, extent boxes and crops (validity, labels and boxes exactly,
    scores and patches to 1e-5); each device's whole decode equal to the
    other's in the same way where neither of the two near-ties occurred (the
    count is logged); the losses to 1e-5 and every gradient through the
    whole model to 1e-2 in relative norm."""
    from torch_detection_tpu_torch.models.detectors.solov2 import (
        downsample_masks,
        flatten_levels,
        solov2_candidates,
        solov2_detections,
    )
    from torch_detection_tpu_torch.ops.matmul import float32_matmul

    on_gpu = solov2_reference_batch()
    batch = {k: v.cpu() for k, v in on_gpu.items()}
    (gpu, det_cfg), (cpu, _) = load_solov2("float32", "cuda"), load_solov2("float32", "cpu")
    checks, extra, failed = [], [], []

    def check(what, err, limit):
        # every check runs and is logged; a failed one fails the phase at its end
        checks.append(f"{what} {err:.2e} (limit {limit:g})")
        if not err <= limit:
            failed.append(f"{what}: {err} > {limit}")

    def same(what, got, want):
        check(f"{what}, values not bit-equal", float((got.cpu() != want).sum()), 0)

    def mask_matrix(m):
        return m.float().reshape(m.shape[0], -1, m.shape[-1]).transpose(1, 2)

    def take(x, idx):
        return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]

    with torch.inference_mode():
        tg, tc = gpu.backbone(on_gpu["image"]), cpu.backbone(batch["image"])
        check("trunk C2-C5", max(rel_to_max(g, c) for g, c in zip(tg, tc)), 1e-4)
        fg, fc = gpu.neck(tg), cpu.neck(tc)
        check("FPN P2-P6", max(rel_to_max(g, c) for g, c in zip(fg, fc)), 1e-4)
        (cg, kg, mg), (cc, kc, mc) = gpu.heads(fg), cpu.heads(fc)
        check("class logits", max(rel_to_max(g, c) for g, c in zip(cg, cc)), 1e-4)
        check("kernels", max(rel_to_max(g, c) for g, c in zip(kg, kc)), 1e-4)
        check("mask features", rel_to_max(mg, mc), 1e-4)

        g = batch["gt_masks"].shape[1]
        gts = [tuple(d[k][:, :g] for k in ("gt_boxes", "gt_labels", "gt_valid"))
               for d in (on_gpu, batch)]
        dsg = downsample_masks(on_gpu["gt_masks"], det_cfg.mask_stride)
        dsc = downsample_masks(batch["gt_masks"], det_cfg.mask_stride)
        same("pooled masks", dsg, dsc)
        lg, ig = solov2_targets(det_cfg, *gts[0], dsg, SOLOV2_REF_CANVAS)
        lc, ic = solov2_targets(det_cfg, *gts[1], dsc, SOLOV2_REF_CANVAS)
        same("targets' labels", lg, lc)
        same("targets' matched gts", ig, ic)
        same("slate", nms_ops.top_k_stable((lg >= 0).float(), det_cfg.max_pos_cells)[1],
             nms_ops.top_k_stable((lc >= 0).float(), det_cfg.max_pos_cells)[1])
        extra.append(f"positives an image {(lc >= 0).sum(1).tolist()} over "
                     f"{batch['gt_valid'].sum(1).tolist()} gts")

        # equal inputs from here: the GPU's maps on both devices
        oc = ([c.cpu() for c in cg], [k.cpu() for k in kg], mg.cpu())
        (fcg, fkg), (fcc, fkc) = flatten_levels(cg, kg), flatten_levels(*oc[:2])
        k, c = det_cfg.pre_nms_top_k, det_cfg.num_classes
        sg = torch.sigmoid(fcg.float()).reshape(2, -1)
        sc = torch.sigmoid(fcc.float()).reshape(2, -1)
        check("cell-class scores (ulps)", float(ulp_gap(sg, sc).max()), SOFT_ULPS)
        top_g, top_c = nms_ops.top_k_stable(sg, k)[1].cpu(), nms_ops.top_k_stable(sc, k)[1]
        diff = top_g != top_c
        tied = int(diff.sum())
        check(f"top-256 ranks held by scores more than {SOFT_ULPS} ulps apart",
              float((ulp_gap(sc.gather(1, top_g), sc.gather(1, top_c)) > SOFT_ULPS)[diff].sum()),
              0)
        logits_g = float32_matmul(take(fkg, top_c.cuda() // c), mask_matrix(mg))
        logits_c = float32_matmul(take(fkc, top_c // c), mask_matrix(oc[2]))
        check("dynamic-conv logits", rel_err(logits_g, logits_c), 1e-5)
        flips = (torch.sigmoid(logits_g).cpu() > det_cfg.mask_thr) != (
            torch.sigmoid(logits_c) > det_cfg.mask_thr)
        check("mask pixels flipped with a logit beyond 1e-6",
              float((flips & (logits_c.abs() > 1e-6)).sum()), 0)
        cand = solov2_candidates(det_cfg, *oc)
        cand_g = type(cand)(*(t.cuda() for t in cand))
        same("mask IoUs", nms_ops.mask_iou_matrix(cand_g.binary), nms_ops.mask_iou_matrix(
            cand.binary))
        valid = cand.scores > det_cfg.score_thr
        dec_g = nms_ops.matrix_nms(cand_g.binary, cand_g.labels, cand_g.scores, valid.cuda(),
                                   det_cfg.nms_method, det_cfg.nms_sigma)
        dec_c = nms_ops.matrix_nms(cand.binary, cand.labels, cand.scores, valid,
                                   det_cfg.nms_method, det_cfg.nms_sigma)
        check("Matrix-NMS scores (ulps)", float(ulp_gap(dec_g, dec_c).max()), SOFT_ULPS)
        shapes = torch.tensor([[SOLOV2_REF_CANVAS[0], SOLOV2_REF_CANVAS[1]],
                               [SOLOV2_REF_CANVAS[0] - 64, SOLOV2_REF_CANVAS[1] - 96]])
        hw = tuple(oc[2].shape[1:3])
        det_g = solov2_detections(det_cfg, cand_g, dec_c.cuda(), hw, shapes.cuda())
        det_c = solov2_detections(det_cfg, cand, dec_c, hw, shapes)

        def same_detections(what, a, b):
            for field in ("valid", "labels", "boxes"):
                same(f"{what} {field}", getattr(a, field), getattr(b, field))
            check(f"{what} scores", rel_err(a.scores, b.scores), 1e-5)
            check(f"{what} patches", rel_err(a.mask_probs, b.mask_probs), 1e-5)

        same_detections("top 100, boxes and crops", det_g, det_c)
        check("images without a detection", float((~det_c.valid.any(dim=1)).sum()), 0)
        whole_g = decode_solov2(det_cfg, cg, kg, mg, shapes.cuda())
        whole_c = decode_solov2(det_cfg, *oc, shapes)
        if tied or bool(flips.any()):
            extra.append(f"whole decode not compared: {tied} top-256 and {int(flips.sum())} mask "
                         "near-ties")
        else:
            same_detections("whole decode", whole_g, whole_c)
        extra.append(f"{whole_c.valid.sum(1).tolist()} detections, {int(valid.sum())} "
                     "candidates over score_thr")
        lossg = solov2_loss(det_cfg, cg, kg, mg, *(on_gpu[k] for k in (
            "gt_boxes", "gt_labels", "gt_valid", "gt_masks")))
        lossc = solov2_loss(det_cfg, *oc, *(batch[k] for k in (
            "gt_boxes", "gt_labels", "gt_valid", "gt_masks")))
    check("losses on equal inputs", max(abs(float(lossg[k]) - float(lossc[k]))
                                        / abs(float(lossc[k])) for k in SOLOV2_LOSS_KEYS), 1e-5)
    check("num_pos mismatches", abs(float(lossg["num_pos"]) - float(lossc["num_pos"])), 0)
    gpu.train(), cpu.train()
    for model, data in ((gpu, on_gpu), (cpu, batch)):
        loss, _ = build_loss_fn(model, det_cfg)(data)
        loss.backward()

    def rel_norm(a, b):
        a, b = a.cpu().double(), b.cpu().double()
        return float((a - b).norm() / b.norm().clamp_min(1e-300))

    errs = {n: rel_norm(g.grad, c.grad) for (n, g), (_, c) in
            zip(gpu.named_parameters(), cpu.named_parameters())
            if g.requires_grad and c.grad is not None and c.grad.abs().max() > 0}
    worst = max(errs, key=errs.get)
    check(f"gradients' relative norm of the difference (worst at {worst})", errs[worst], 1e-2)
    log(f"solov2 reference check, GPU vs CPU float32 on {SOLOV2_REF_CANVAS} "
        f"({'; '.join(extra)}; {len(errs)} gradients): " + "; ".join(checks))
    if failed:
        raise AssertionError("solov2 reference checks failed: " + "; ".join(failed))


def soft_pool_after(decay: torch.Tensor, scores: torch.Tensor, picks) -> torch.Tensor:
    """The Soft-NMS pool (one image, on the CPU) after ``picks``: each pick
    multiplies the pool by its decay row and leaves it at -inf."""
    w = scores.clone()
    for p in picks:
        w = w * decay[p]
        w[p] = -math.inf
    return w


def soft_picks_against_cpu(det_cfg, scores: torch.Tensor, boxes: torch.Tensor) -> str:
    """``multiclass_soft_nms`` on the card against the CPU on the same
    candidates (float32 (B, M, C) scores and (B, M, 4) boxes on the CPU):
    each image's picks equal until a step where the card's pick and the
    CPU's lie within ``SOFT_ULPS`` of each other in the CPU's pool (the
    decay's exp rounds apart by an ulp on each device), their scores to
    1e-5 relative before it; a divergence any further apart fails."""
    kw = dict(sigma=det_cfg.soft_sigma, iou_thr=det_cfg.nms_iou_thr,
              score_thr=det_cfg.score_thr, pre_nms_top_k=det_cfg.pre_nms_top_k,
              max_out=det_cfg.max_detections)
    got = nms_ops.multiclass_soft_nms(boxes.cuda(), scores.cuda(), **kw)
    want = nms_ops.multiclass_soft_nms(boxes, scores, **kw)
    c = scores.shape[-1]
    notes = []
    for b in range(scores.shape[0]):
        flat = scores[b].reshape(-1)
        flat = torch.where(flat > det_cfg.score_thr, flat, -1.0)
        top_s, top_flat = nms_ops.top_k_stable(flat, min(flat.numel(), det_cfg.pre_nms_top_k))
        pos = {int(f): p for p, f in enumerate(top_flat.tolist())}
        cand = boxes[b][top_flat // c]
        shift = ((top_flat % c).float() * (cand.abs().max() + 1.0 + 1.0))[:, None]
        decay = nms_ops._soft_decay(bbox_overlaps(cand + shift, cand + shift), "gaussian",
                                    det_cfg.soft_sigma, det_cfg.nms_iou_thr)
        keys = [[pos[int(i) * c + int(lab)] for i, lab, v in zip(r.indices[b], r.labels[b],
                                                                  r.valid[b]) if v]
                for r in (got, want)]
        n = next((t for t, (a, z) in enumerate(zip(*keys)) if a != z), min(map(len, keys)))
        if n:
            err = rel_err(got.scores[b, :n], want.scores[b, :n])
            if err > 1e-5:
                raise AssertionError(f"soft-NMS image {b}: picked scores {err} apart")
        if n == len(keys[0]) == len(keys[1]):
            notes.append(f"image {b}: {n} picks equal")
            continue
        pool = soft_pool_after(decay, top_s, keys[1][:n])
        at = [pool[k[n]] if n < len(k) else torch.tensor(det_cfg.score_thr) for k in keys]
        gap = float(ulp_gap(*at).max())
        if gap > SOFT_ULPS:
            raise AssertionError(f"soft-NMS image {b}: the picks part at step {n}, the card's "
                                 f"and the CPU's {gap:.1f} ulps apart in the CPU's pool")
        notes.append(f"image {b}: {n} picks equal, then a tie within {gap:.1f} ulps")
    return "; ".join(notes)


def phase_soft_nms(card: str) -> dict:
    """RetinaNet R50-FPN served with ``nms_method="soft"`` (gaussian,
    ``soft_sigma`` 0.5), bf16, b4 on the 800 x 1216 s2d wire, ``cls_out``'s
    bias at 0 (``load_retina``): K1, K2 and the matcher counted (none
    expected), the detections checked; the NMS stage timed (synced host ms
    and device ms) beside the greedy NMS on the same candidates; the picks
    against the CPU's (``soft_picks_against_cpu``)."""
    model, hard_cfg = load_retina("bfloat16", "cuda")
    det_cfg = dataclasses.replace(hard_cfg, nms_method="soft")
    infer = make_inference_fn(model, det_cfg)
    h, w = CANVAS
    wire, shapes = retina_wire(SEED + 204, BATCH)
    run = serve_s2d(infer, wire, shapes)
    timed_batches(run, WARMUP_BATCHES)
    reset_launches()
    ms, results = timed_batches(run, TIMED_BATCHES)
    launches = read_launches()
    expect_launches("retina soft-NMS serving", launches, 0, 0)
    for res in results:
        check_detections(res, det_cfg, BATCH, h, w)
    mean_ms = sum(ms) / len(ms)
    with torch.inference_mode():
        outs = model(fused_normalize_pad_s2d(wire, shapes, out_dtype=torch.bfloat16))
        scores, boxes = decode_candidates(det_cfg, preselect(det_cfg, *outs), shapes)
    nms_args = dict(iou_thr=det_cfg.nms_iou_thr, score_thr=det_cfg.score_thr,
                    pre_nms_top_k=det_cfg.pre_nms_top_k, max_out=det_cfg.max_detections)
    soft = functools.partial(nms_ops.multiclass_soft_nms, boxes, scores,
                             sigma=det_cfg.soft_sigma, **nms_args)
    hard = functools.partial(nms_ops.multiclass_nms, boxes, scores, **nms_args)
    times = {}
    stage = stage_timer(times)
    for _ in range(5):
        stage("soft-NMS", soft)
        stage("greedy NMS", hard)
    soft_dev, hard_dev = cuda_ms(soft, iters=10), cuda_ms(hard, iters=10)
    picks = soft_picks_against_cpu(det_cfg, scores.cpu(), boxes.cpu())
    log(f"retina soft-NMS serving path b{BATCH}: ms a batch {[round(m, 3) for m in ms]}, mean "
        f"{mean_ms:.3f} ms, {BATCH / (mean_ms / 1e3):.2f} images/s [{card}]; launches {launches}; "
        f"valid detections an image {results[-1].valid.sum(1).tolist()}; the NMS stage on "
        f"{tuple(scores.shape)} candidates, {det_cfg.max_detections} steps over a pool of "
        f"{det_cfg.pre_nms_top_k}: soft {statistics.median(times['soft-NMS']):.3f} ms synced, "
        f"{soft_dev:.3f} ms device; greedy {statistics.median(times['greedy NMS']):.3f} ms "
        f"synced, {hard_dev:.3f} ms device; the picks against the CPU: {picks}")
    return dict(launches=launches, ms_per_batch=mean_ms, soft_ms=soft_dev, hard_ms=hard_dev)


def write_solov2_cli_config() -> Path:
    """configs/solov2_r50_fpn_coco.py on the CLI mask path's folders (their
    landscape and square PNGs with polygon and RLE masks, R8), validation
    with the mask metrics (the config's ``runtime.val_segm``) after each
    epoch, and ``score_thr`` and ``update_thr`` at 0 so that the random
    weights leave detections for the evaluators."""
    SMOKE_COCO_SOLOV2.mkdir(parents=True, exist_ok=True)
    data = {split: dict(ann_file=str(SMOKE_COCO_MASKS / f"instances_{split}.json"),
                        img_prefix=str(SMOKE_COCO_MASKS / split)) for split in ("train", "val")}
    path = SMOKE_COCO_SOLOV2 / "solov2_r50_fpn_smoke.py"
    path.write_text(
        f"_base_ = {str(SOLOV2_CONFIG)!r}\n"
        f"data = dict(**{data!r})\n"
        "detection = dict(score_thr=0.0, update_thr=0.0)\n"
        "schedule = dict(warmup_steps=100)\n"
        f"runtime = dict(work_dir={str(SMOKE_COCO_SOLOV2 / 'work')!r}, log_interval=1, "
        "val_interval_epochs=1)\n")
    return path


def segm_oracle(val, val_ann: Path, num_classes: int) -> tuple:
    """The val gt masks as detections of score 1: (box mAP, the segm
    metrics, whether the segm dump gives back the non-crowd masks)."""
    frames = {img["id"]: (img["height"], img["width"])
              for img in json.loads(val_ann.read_text())["images"]}
    anns, dets = [], []
    for i in range(len(val)):
        a = val.get_ann_info(i)
        a = dict(a, masks=[rle_encode(m) for m in a["masks"]],
                 masks_ignore=[rle_encode(m) for m in a["masks_ignore"]])
        anns.append(a)
        dets.append(dict(boxes=a["bboxes"], scores=np.ones(len(a["bboxes"])), labels=a["labels"],
                         masks=a["masks"]))
    dumped = coco_segm_dump(val, dets)
    source = [a for a in json.loads(val_ann.read_text())["annotations"] if not a["iscrowd"]]
    inverted = len(dumped) == len(source) and all(
        r["image_id"] == a["image_id"] and r["category_id"] == a["category_id"]
        and np.array_equal(rle_decode(r["segmentation"]),
                           segm_to_mask(a["segmentation"], *frames[a["image_id"]]))
        for r, a in zip(dumped, source))
    return (eval_coco_map(dets, anns, num_classes)["mAP"],
            eval_coco_segm_map(dets, anns, num_classes), inverted)


def phase_cli_solov2(card: str) -> dict:
    """SOLOv2 R50-FPN through the entry points at full width on the CLI mask
    path's seeded PNG folders (written by ``phase_cli_mask``; here again if
    missing): ``tools.train`` for 2 epochs of the config's b8 on 800 x 1344
    (validation with box and segm mAP after each), ``tools.test --segm
    --out`` on the last epoch (24 finite metrics, every RLE at its image's
    original size) and on the seeded build with ``cls_out``'s bias at 0
    (saved as a checkpoint: its detections must reach the segm dump, which
    the trained model's need not: from random weights at the config's lr
    its masks may collapse), the val gts as detections (box and segm mAP
    1.0); K1, K2 and the matcher never launch."""
    if not (SMOKE_COCO_MASKS / "instances_val.json").exists():
        write_smoke_coco_masks("train", CLI_MASK_TRAIN_IMAGES, SEED + 90)
        write_smoke_coco_masks("val", CLI_MASK_VAL_IMAGES, SEED + 91)
    shutil.rmtree(SMOKE_COCO_SOLOV2, ignore_errors=True)
    config = write_solov2_cli_config()
    cfg = Config.fromfile(config)
    det_cfg = build_detection_cfg(cfg["detection"])
    work = SMOKE_COCO_SOLOV2 / "work"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer = train_cli.main([str(config), "--epochs", str(SOLOV2_CLI_EPOCHS), "--work-dir",
                              str(work)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    expect_launches("cli solov2 training", launches, 0, 0)
    steps = len(trainer.dataloader)
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    losses = [r for r in records if "loss" in r]
    vals = [r for r in records if "val_mAP" in r]
    if len(losses) != steps * SOLOV2_CLI_EPOCHS or not all(
            math.isfinite(r[k]) for r in losses for k in SOLOV2_LOSS_KEYS) or not all(
            r["num_pos"] > 0 for r in losses) or len(vals) != SOLOV2_CLI_EPOCHS or not all(
            math.isfinite(v) for r in vals for v in r.values()) or "val_segm_mAP" not in vals[-1]:
        raise AssertionError(f"cli solov2 training: {len(losses)} records for "
                             f"{SOLOV2_CLI_EPOCHS} x {steps} steps, {len(vals)} validations, or "
                             "a non-finite value or no positive")
    batch_size = cfg["data"]["sample_per_replica"]
    epoch_ips, step_ms = epoch_rate(losses, SOLOV2_CLI_EPOCHS - 1, batch_size)
    log(f"cli solov2 training [{card}]: {CLI_MASK_TRAIN_IMAGES} PNGs, {SOLOV2_CLI_EPOCHS} epochs "
        f"of {steps} steps of b{batch_size} on {tuple(cfg['data']['canvas'])} in {wall:.1f} s "
        f"(the build, validation and checkpoints included); launches {launches}; images/s over "
        f"epoch {SOLOV2_CLI_EPOCHS}: {epoch_ips:.2f}, a step's median "
        f"{batch_size / statistics.median(step_ms) * 1e3:.2f}; the trainer's wait on the loader "
        f"{trainer.loader_wait_s / len(losses) * 1e3:.1f} ms a step; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        + "; ".join(f"{k} {[round(r[k], 4) for r in losses]}" for k in SOLOV2_LOSS_KEYS
                    + ("num_pos",))
        + f"; validation box mAP {[r['val_mAP'] for r in vals]}, segm mAP "
        f"{[r['val_segm_mAP'] for r in vals]}")
    del trainer

    val_ann = SMOKE_COCO_MASKS / "instances_val.json"
    frames = {img["id"]: (img["height"], img["width"])
              for img in json.loads(val_ann.read_text())["images"]}
    collapsed = losses[-1]["loss_mask"] >= det_cfg.dice_weight * (1 - 1e-3)
    # the trained model, then the seeded build with cls_out's bias at 0 (whose
    # masks cannot have collapsed), each through tools.test --segm
    seeded = SMOKE_COCO_SOLOV2 / "seeded"
    save_checkpoint(str(seeded), load_solov2("float32", "cpu")[0])
    results = {}
    for what, checkpoint in (("trained", work / f"epoch_{SOLOV2_CLI_EPOCHS}"), ("seeded", seeded)):
        out = SMOKE_COCO_SOLOV2 / f"results_{what}.json"
        reset_launches()
        t0 = time.perf_counter()
        metrics = test_cli.main([str(config), str(checkpoint), "--segm", "--out", str(out)])
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        test_launches = read_launches()
        expect_launches(f"cli solov2 test ({what})", test_launches, 0, 0)
        if len(metrics) != 24 or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"cli solov2 test ({what}) metrics {metrics}")
        segm = json.loads(out.with_name(f"results_{what}.segm.json").read_text())
        if len(segm) != len(json.loads(out.read_text())) or any(
                rle_decode(r["segmentation"]).shape != frames[r["image_id"]] for r in segm):
            raise AssertionError(f"cli solov2 test ({what}): {len(segm)} segm records, or one "
                                 "off its frame")
        if what == "seeded" and not segm:
            raise AssertionError("cli solov2 test (seeded): no segm record")
        results[what] = dict(test=test_launches, mAP=metrics["mAP"], segm_mAP=metrics["segm_mAP"])
        log(f"cli solov2 test --segm, the {what} model [{card}]: {len(frames)} images in "
            f"{test_s:.1f} s (the build included), launches {test_launches}; {len(segm)} segm "
            f"records, each RLE at its image's original size"
            + ("; the trained masks collapsed (loss_mask at its ceiling, dice_weight): no "
               "detection" if what == "trained" and collapsed else "")
            + "; " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    box_oracle, segm_metrics, inverted = segm_oracle(
        get_datasets(dict(cfg["data"]["val"], with_mask=True)), val_ann, det_cfg.num_classes)
    log(f"cli solov2 oracle: the val gts as detections give box mAP {box_oracle:.6f} and segm "
        f"mAP {segm_metrics['mAP']:.6f}, the dump inverting the masks: {inverted}")
    if abs(box_oracle - 1.0) > 1e-12 or abs(segm_metrics["mAP"] - 1.0) > 1e-12 or not inverted:
        raise AssertionError("cli solov2: the oracle does not score 1.0")
    return dict(training=launches, **results["trained"], seeded=results["seeded"])


def write_golden_coco(root: Path, n_images: int = 8, size: int = 64, seed: int = 7) -> tuple:
    """``tests/data_fixtures.py::make_golden_coco`` without OpenCV: the same
    seeded draws (1-2 bright squares of two classes on dark noise an image),
    the PNGs written by ``png_encode`` (lossless: the same pixels)."""
    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    for i in range(n_images):
        img = rng.integers(0, 40, (size, size, 3), np.uint8)
        for _ in range(1 + i % 2):
            s = int(rng.integers(16, 28))
            x = int(rng.integers(2, size - s - 2))
            y = int(rng.integers(2, size - s - 2))
            cls = int(rng.integers(1, 3))
            img[y:y + s, x:x + s, cls - 1] = 220
            annotations.append({"id": len(annotations) + 1, "image_id": i + 1,
                                "category_id": cls, "iscrowd": 0, "bbox": [x, y, s, s],
                                "area": s * s,
                                "segmentation": [[x, y, x + s, y, x + s, y + s, x, y + s]]})
        # cv2.imwrite writes BGR: the file holds the channels reversed
        (img_dir / f"g{i}.png").write_bytes(png_encode(np.ascontiguousarray(img[..., ::-1])))
        images.append({"id": i + 1, "file_name": f"g{i}.png", "height": size, "width": size})
    ann_file = root / "golden.json"
    ann_file.write_text(json.dumps({"images": images, "annotations": annotations,
                                    "categories": [{"id": 1, "name": "red"},
                                                   {"id": 2, "name": "green"}]}))
    return ann_file, img_dir


def write_golden_set() -> None:
    """``GOLDEN_COCO`` written afresh: the squares set and the Fast R-CNN
    proposals (``golden_cases.write_golden_proposals``)."""
    shutil.rmtree(GOLDEN_COCO, ignore_errors=True)
    ann_file, _ = write_golden_coco(GOLDEN_COCO)
    golden_cases.write_golden_proposals(ann_file, GOLDEN_PROPOSALS)


def golden_data(train: bool, with_mask: bool, segm: bool, proposals: bool) -> dict:
    """``golden_cases.data_cfg`` on ``GOLDEN_COCO``: masks read in training
    with ``with_mask``, in validation with ``segm``; 16 proposals an image
    from ``GOLDEN_PROPOSALS`` with ``proposals``."""
    cfg = golden_cases.data_cfg((str(GOLDEN_COCO / "golden.json"), str(GOLDEN_COCO / "images")),
                                train, with_mask,
                                str(GOLDEN_PROPOSALS) if proposals else None)
    if not train:
        cfg["with_mask"] = segm
    return cfg


def golden_train_eval(model_cfg: dict, det_cfg, steps: int, lr: float = 1e-3,
                      with_mask: bool = False, segm: bool = False,
                      proposals: bool = False, seed: int = SEED) -> dict:
    """The golden harness on the card (``tests/test_torch_golden_map.py::
    train_and_eval``): ``steps`` steps of b4 in float32 from the init of
    ``seed`` on ``GOLDEN_COCO``
    through the port's data tier (the loader at seed 3, ``max_gts`` 4, the
    64 x 64 canvas, ``max_proposals`` 16 with proposals) with AdamW at
    ``lr`` and weight decay 0 (the reference's ``optax.adam``), then
    ``evaluate_detector`` on the val split; the launches of each part and
    K1's and K2's training launches by output size."""
    loader = build_dataloader(get_datasets(golden_data(True, with_mask, segm, proposals)),
                              sample_per_replica=GOLDEN_BATCH, seed=3, max_gts=4,
                              canvas=GOLDEN_CANVAS, prefetch=0,
                              max_proposals=16 if proposals else None)
    model = build_detector(model_cfg, "float32", device="cuda", seed=seed).train()
    optimizer = make_optimizer(model.parameters(), lr, weight_decay=0.0, kind="adamw")
    step = make_train_step(build_loss_fn(model, det_cfg, rng_seed=seed), optimizer)
    losses, epoch = [], 0
    reset_launches()
    t0 = time.perf_counter()
    with launches_by_out_size() as sizes:
        while len(losses) < steps:
            loader.set_epoch(epoch)
            epoch += 1
            for b in prefetch_to_device(iter(loader), device="cuda"):
                losses.append(step(b)["loss"])
                if len(losses) >= steps:
                    break
        losses = [float(x) for x in losses]
    train_s = time.perf_counter() - t0
    launches = read_launches()
    if not (math.isfinite(losses[-1]) and losses[-1] < losses[0]):
        raise AssertionError(f"golden training: loss {losses[0]} -> {losses[-1]}")
    model.eval()
    reset_launches()
    t0 = time.perf_counter()
    res = evaluate_detector(model, det_cfg,
                            get_datasets(golden_data(False, with_mask, segm, proposals)),
                            batch=GOLDEN_BATCH, canvas=GOLDEN_CANVAS, segm=segm)
    torch.cuda.synchronize()
    return dict(model=model, res=res, first=losses[0], last=losses[-1], train_s=train_s,
                eval_s=time.perf_counter() - t0, launches=launches,
                eval_launches=read_launches(),
                sizes={k: dict(sorted(v.items())) for k, v in sizes.items()})


def phase_golden_solov2(card: str) -> dict:
    """The golden SOLOv2 (``tests/test_golden_map.py::test_golden_map_solov2``
    and ``tests/test_torch_golden_map.py``): ``golden_train_eval`` of the
    narrow model for 400 steps at lr 1e-3 with masks, on ``write_golden_set``'s
    files, scored with the mask metrics; the scores must meet the
    reference's band (``segm_mAP_50`` and ``mAP_50`` at least 0.3)."""
    det_cfg = build_detection_cfg(GOLDEN_SOLOV2_DETECTION)
    run = golden_train_eval(GOLDEN_SOLOV2_MODEL, det_cfg, GOLDEN_STEPS, with_mask=True, segm=True)
    model, res, launches = run["model"], run["res"], run["launches"]
    expect_launches("golden solov2", launches, 0, 0)
    log(f"golden solov2 [{card}]: {GOLDEN_STEPS} steps of b{GOLDEN_BATCH} in {run['train_s']:.1f} "
        f"s, loss {run['first']:.4f} -> {run['last']:.4f}, launches {launches}; evaluated in "
        f"{run['eval_s']:.1f} s: "
        + ", ".join(f"{k} {res[k]:.4f} (band >= {v})" for k, v in GOLDEN_BAND.items())
        + f"; box mAP {res['mAP']:.4f}, segm mAP {res['segm_mAP']:.4f}")
    for k, v in GOLDEN_BAND.items():
        if not res[k] >= v:
            raise AssertionError(f"golden solov2: {k} {res[k]} under the reference's band {v}")
    save_checkpoint(str(GOLDEN_COCO / "ckpt"), model, meta={"step": GOLDEN_STEPS})
    val = golden_data(False, True, True, False)
    for dtype, name in (("bfloat16", "bf16"), ("float32", "f32")):  # configs for tools.test
        (GOLDEN_COCO / f"golden_solov2_{name}.py").write_text(
            f"model = {GOLDEN_SOLOV2_MODEL!r}\ndetection = {GOLDEN_SOLOV2_DETECTION!r}\n"
            f"data = dict(val={val!r}, canvas={GOLDEN_CANVAS!r})\n"
            f"runtime = dict(compute_dtype={dtype!r})\n")
    return dict(launches=launches, **{k: res[k] for k in GOLDEN_BAND})


# K1, K2 and the matcher a training step, and K1 a served batch, of each
# golden family of ``golden_cases.GOLDEN_CASES``: the dense families launch none, DETR
# the matcher once a training step
GOLDEN_LAUNCHES = {**{name: ((0, 0, 0), 0) for name in golden_cases.GOLDEN_DENSE},
                   "detr": ((0, 0, 1), 0),
                   "faster_rcnn": ((1, 1, 0), 1), "fast_rcnn": ((1, 1, 0), 1),
                   "cascade_rcnn": ((3, 3, 0), 3), "cascade_mask_rcnn": ((6, 6, 0), 4),
                   "mask_rcnn": ((2, 2, 0), 2), "sparse_rcnn": ((2, 2, 1), 2)}
# the families in the order their runs start: the longest first (chip runs of
# ``phase_golden``), so that the pool's last runs are short
GOLDEN_ORDER = ("cascade_mask_rcnn", "cascade_rcnn", "mask_rcnn", "sparse_rcnn", "faster_rcnn",
                "detr", "yolox", "centernet", "fast_rcnn", "free_anchor", "paa", "yolov3", "gfl",
                "atss", "fcos", "retinanet", "foveabox", "ssd")
GOLDEN_PROCESSES = 6


def golden_case(name: str) -> tuple:
    """Golden family ``name`` (``golden_cases``: the reference's
    tests/test_golden_map.py:124-262 and :499-707): its model dict,
    detection config, steps, ``golden_train_eval`` keywords and band."""
    steps, kw, band = golden_cases.GOLDEN_CASES[name]
    return (golden_cases.GOLDEN_MODELS[name], golden_cases.golden_detection_cfg(name), steps,
            dict(kw), band)


def golden_worker(task: tuple) -> dict:
    """Golden family ``name`` from the init of ``seed`` (``task``) on the
    card, in a worker process, with deterministic algorithms (cuDNN's and
    cuBLAS's, the deterministic scatter and index kernels), so that a
    family's score is the same every run as the reference's XLA runs are;
    the operators that have no deterministic CUDA form are returned by
    name."""
    name, seed = task
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # before the first cuBLAS call
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.set_num_threads(1)
    model_cfg, det_cfg, steps, kw, _ = golden_case(name)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run = golden_train_eval(model_cfg, det_cfg, steps, seed=seed, **kw)
    del run["model"]
    loose = sorted({str(w.message).split(" does not have a deterministic")[0] for w in caught
                    if "does not have a deterministic" in str(w.message)})
    return dict(name=name, seed=seed, nondeterministic=loose, **run)


def phase_golden(card: str, alongside=None) -> dict:
    """Phases 50 and 52: the golden families of ``GOLDEN_ORDER``
    (``golden_case``), each trained and scored by ``golden_train_eval`` from each of its init
    seeds (``golden_cases.golden_seeds``) in ``GOLDEN_PROCESSES`` spawned
    processes on the card, the longest runs first, while ``alongside()``
    runs in this one; then each run's launches: K1, K2 and the matcher as a
    training step and a served batch take them, by step and batch, K1 and K2
    at out 7 only (``GOLDEN_LAUNCHES``); and each family's scores, the mean
    over its seeds, against the reference's band. Raises on a launch count;
    a mean under its band is returned in ``under``, on which ``main`` raises
    once phases 47 and 48 have run on the SOLOv2 trained alongside."""
    t_phase = time.perf_counter()
    write_golden_set()
    tasks = [(name, seed) for name in GOLDEN_ORDER
             for seed in golden_cases.golden_seeds(name)]
    with multiprocessing.get_context("spawn").Pool(GOLDEN_PROCESSES) as pool:
        pending = pool.map_async(golden_worker, tasks, chunksize=1)
        side = alongside() if alongside is not None else None
        runs = pending.get(timeout=900)
    val_batches = -(-len(json.loads((GOLDEN_COCO / "golden.json").read_text())["images"])
                    // GOLDEN_BATCH)
    paths, under = {}, []
    for name in GOLDEN_ORDER:
        _, _, steps, _, band = golden_case(name)
        (k1, k2, matcher), k1_batch = GOLDEN_LAUNCHES[name]
        mine = [run for run in runs if run["name"] == name]
        for run in mine:
            res = run["res"]
            log(f"golden {name} seed {run['seed']} [{card}]: {steps} steps of b{GOLDEN_BATCH} in "
                f"{run['train_s']:.1f} s, loss {run['first']:.4f} -> {run['last']:.4f}; evaluated "
                f"in {run['eval_s']:.1f} s: "
                + ", ".join(f"{k} {res[k]:.4f} (band >= {v})" for k, v in band.items())
                + f"; launches in training {run['launches']} ({k1}/{k2}/{matcher} a step "
                f"expected), K1/K2 by out size {run['sizes']}, in evaluation "
                f"{run['eval_launches']} ({k1_batch} a batch of {val_batches} expected); "
                f"operators without a deterministic CUDA form: "
                f"{run['nondeterministic'] or 'none'}")
            what = f"golden {name} seed {run['seed']}"
            expect_launches(f"{what} training", run["launches"], k1 * steps, k2 * steps,
                            matcher * steps)
            expect_launches(f"{what} evaluation", run["eval_launches"], k1_batch * val_batches, 0)
            if k1 and (set(run["sizes"]["k1"]) != {OUT_SIZE}
                       or set(run["sizes"]["k2"]) != {OUT_SIZE}):
                raise AssertionError(f"{what}: K1 or K2 launched at another out size than 7")
        mean = golden_cases.mean_scores([run["res"] for run in mine], band)
        log(f"golden {name} [{card}]: the mean over init seeds "
            f"{[run['seed'] for run in mine]}: "
            + ", ".join(f"{k} {mean[k]:.4f} (band >= {v})" for k, v in band.items()))
        under += [f"{name} {k} {mean[k]} (the mean over {len(mine)} init seeds) under the "
                  f"reference's band {v}" for k, v in band.items() if not mean[k] >= v]
        for path, part in (("training", "launches"), ("evaluation", "eval_launches")):
            paths[f"golden_{name}_{path}"] = {k: sum(run[part][k] for run in mine)
                                              for k in mine[0][part]}
    log(f"golden phase: {time.perf_counter() - t_phase:.1f} s for {len(runs)} runs of "
        f"{len(GOLDEN_ORDER)} families in {GOLDEN_PROCESSES} processes [{card}]")
    return dict(paths=paths, alongside=side, under=under)


# ---------------------------------------------------------------- the backbone zoo and PAFPN
MOBILENETV2_RETINA_CONFIG = ROOT / "configs" / "retinanet_mobilenetv2_fpn_coco.py"
SHUFFLENETV2_RETINA_CONFIG = ROOT / "configs" / "retinanet_shufflenetv2_fpn_coco.py"
PAFPN_RETINA_CONFIG = ROOT / "configs" / "retinanet_pafpn_r50_coco.py"
ZOO = (("mobilenetv2", MOBILENETV2_RETINA_CONFIG), ("shufflenetv2", SHUFFLENETV2_RETINA_CONFIG),
       ("pafpn_r50", PAFPN_RETINA_CONFIG))
ZOO_PARAMS = {"mobilenetv2": 11_488_244, "shufflenetv2": 12_788_696,
              "pafpn_r50": 40_329_012}  # the JAX builder's counts (jax.eval_shape)
ZOO_TRAIN_CANVAS = (800, 1344)  # the RetinaNet configs' data canvas
ZOO_BACKBONES = (("ResNeXt", dict(depth=50)), ("SEResNet", dict(depth=50)),
                 ("SEResNeXt", dict(depth=50)), ("MobileNet", dict(width_multi=1.0)),
                 ("MobileNetV2", dict(with_last_conv=True)), ("ShuffleNet", dict(groups=3)),
                 ("ShuffleNetV2", dict(width_mult=1.0)))  # each at its published width
SMOKE_COCO_ZOO = ROOT / "build" / "smoke_coco_zoo"
ZOO_CLI_TRAIN, ZOO_CLI_VAL, ZOO_CLI_EPOCHS = 16, 8, 2


def zoo_serving_input(cfg, seed: int):
    """``(pre, shapes, wire)``: seeded uint8 images on the 800 x 1216 canvas
    put on the card once, and ``pre()``, which normalizes them in bf16:
    relaid 2x2 space-to-depth on the host and through
    ``fused_normalize_pad_s2d`` for an ``stem_s2d`` backbone, else plain
    NHWC through ``fused_normalize_pad`` with the config's means and
    stds."""
    h, w = CANVAS
    u8 = np.random.default_rng(seed).integers(0, 256, (BATCH, h, w, 3), dtype=np.uint8)
    shapes = torch.tensor([[h, w]] * BATCH, dtype=torch.float32, device="cuda")
    if stem_s2d(cfg):
        wire = torch.from_numpy(space_to_depth_2x2_np(u8)).cuda()
        return (lambda: fused_normalize_pad_s2d(wire, shapes, out_dtype=torch.bfloat16), shapes,
                "u8 s2d wire")
    val = cfg["data"]["val"]
    mean, std = tuple(val["img_means"]), tuple(val["img_stds"])
    canvas = torch.from_numpy(u8).cuda()
    return (lambda: fused_normalize_pad(canvas, shapes, mean, std, out_dtype=torch.bfloat16),
            shapes, "u8 NHWC")


def zoo_stage_breakdown(name: str, model, det_cfg, pre, wire: str, shapes, card: str,
                        repeats: int = 5) -> None:
    """A serving batch stage by stage, a device sync between stages; the
    median host ms of each over ``repeats`` batches."""
    times = {}
    stage = stage_timer(times)
    with torch.inference_mode():
        for _ in range(repeats):
            x = stage(f"preprocess ({wire})", pre)
            feats = stage(f"backbone ({type(model.backbone).__name__})",
                          lambda: model.backbone(x))
            levels = stage(f"neck ({type(model.neck).__name__})", lambda: model.neck(feats))
            cls, reg = stage("retina head", lambda: model.head(levels))
            scores, boxes = stage("candidates (preselect, sigmoid, decode, clip)",
                                  lambda: retina_candidates(det_cfg, cls, reg, shapes))
            stage("multiclass NMS", lambda: dense_nms(det_cfg, scores, boxes))
    log_breakdown(f"{name} stage breakdown, median of {repeats} batches", times, card)


def conv_kind(conv: torch.nn.Conv2d) -> str:
    """depthwise (as many groups as input channels), grouped, the folded
    stem, or dense with its window."""
    if conv.groups > 1:
        return "depthwise" if conv.groups == conv.in_channels else "grouped"
    if type(conv) is not torch.nn.Conv2d:
        return type(conv).__name__
    return "dense " + "x".join(map(str, conv.kernel_size))


def backbone_conv_kinds(name: str, model, x, card: str) -> dict:
    """Device ms of the backbone's convs by kind (depthwise: as many groups
    as input channels; grouped; dense 1x1; dense k x k), each conv timed
    alone by CUDA events on its input from the batch, beside the whole
    backbone's forward; the convs' cuDNN kernels without their norms and
    activations."""
    inputs = {}
    hooks = [m.register_forward_pre_hook(lambda mod, args: inputs.setdefault(mod, args[0]))
             for m in model.backbone.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.inference_mode():
        model.backbone(x)
        for hook in hooks:
            hook.remove()
        kinds, count = collections.Counter(), collections.Counter()
        for conv, inp in inputs.items():
            kind = conv_kind(conv)
            kinds[kind] += cuda_ms(lambda: conv(inp), iters=20)
            count[kind] += 1
        # one call, so that the device's head start covers the host's queueing
        whole = cuda_ms(lambda: model.backbone(x), iters=1)
    log(f"{name} backbone convs by kind, device ms each alone on the batch's inputs [{card}]: "
        + ", ".join(f"{k} {v:.3f} ({count[k]} convs)" for k, v in sorted(kinds.items()))
        + f"; the whole backbone {whole:.3f} ms (convs {sum(kinds.values()):.3f}, the rest its "
        "norms, activations, adds, shuffles and pools)")
    return dict(kinds, backbone=whole)


def phase_zoo_serving(card: str, name: str, config: Path, seed: int) -> dict:
    """Full-width RetinaNet MobileNetV2-FPN, ShuffleNetV2-FPN or PAFPN-R50,
    bf16, b4 on the 800 x 1216 canvas (``cls_out``'s bias at 0, as
    ``load_retina``): ``zoo_serving_input``'s wire through
    ``make_inference_fn``; K1, K2 and the matcher counted (none expected)."""
    cfg = Config.fromfile(config)
    model, det_cfg = load_dense(config, "bfloat16", "cuda")
    params = sum(p.numel() for p in model.parameters())
    if params != ZOO_PARAMS[name]:
        raise AssertionError(f"{name}: {params} parameters, the reference has {ZOO_PARAMS[name]}")
    infer = make_inference_fn(model, det_cfg)
    pre, shapes, wire = zoo_serving_input(cfg, seed)
    scale = torch.ones(BATCH, device="cuda")

    def run():
        return infer(pre(), shapes, scale)

    timed_batches(run, WARMUP_BATCHES)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms, results = timed_batches(run, TIMED_BATCHES)
    launches = read_launches()
    expect_launches(f"{name} serving", launches, 0, 0)
    h, w = CANVAS
    for res in results:
        check_detections(res, det_cfg, BATCH, h, w)
    mean_ms = sum(ms) / len(ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{name} serving path b{BATCH} {h}x{w} from the {wire} ({params} parameters, "
        f"{type(model.backbone).__name__} and {type(model.neck).__name__} to C5 "
        f"{model.backbone.out_channels[-1]} channels): ms a batch {[round(m, 3) for m in ms]}, "
        f"mean {mean_ms:.3f} ms, {BATCH / (mean_ms / 1e3):.2f} images/s, median "
        f"{statistics.median(ms):.3f} ms [{card}]; launches {launches}; valid detections an "
        f"image {results[-1].valid.sum(1).tolist()}; peak memory {peak:.2f} GiB")
    zoo_stage_breakdown(name, model, det_cfg, pre, wire, shapes, card)
    profile = device_profile(run, mean_ms, card)
    convs = backbone_conv_kinds(name, model, pre(), card)
    return dict(launches=launches, ms_per_batch=mean_ms, profile=profile, peak_gib=peak,
                convs=convs)


def zoo_train_batch(gen: torch.Generator, s2d: bool) -> dict:
    """``train_batch`` at b8 on the configs' 800 x 1344 canvas, its images
    relaid 2x2 space-to-depth for an ``stem_s2d`` backbone, as the collate
    does."""
    batch = train_batch(gen, RETINA_TRAIN_BATCH, ZOO_TRAIN_CANVAS)
    if s2d:
        batch["image"] = space_to_depth_2x2(batch["image"])
    return batch


def phase_zoo_train(card: str, name: str, config: Path, seed: int) -> dict:
    """Full-width RetinaNet MobileNetV2-FPN, ShuffleNetV2-FPN or PAFPN-R50
    training, float32 parameters and bf16 compute, b8 (the configs'
    ``sample_per_replica``) on 800 x 1344 with the two-stage cells' image
    layout and gts, the configs' SGD (momentum 0.9, weight decay 1e-4,
    clip 35), through ``build_train_objects``, ``build_loss_fn`` and
    ``Trainer.run``; K1, K2 and the matcher counted (none expected)."""
    cfg = Config.fromfile(config)
    steps = WARMUP_BATCHES + TIMED_BATCHES
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = [zoo_train_batch(gen, stem_s2d(cfg)) for _ in range(steps)]
    model, det_cfg, _, optimizer = build_train_objects(cfg, "cuda", seed=SEED,
                                                       loader=Batches(batches))
    if optimizer.grad_clip_norm != 35.0 or cfg["data"]["sample_per_replica"] != RETINA_TRAIN_BATCH:
        raise AssertionError(f"{name}: clip {optimizer.grad_clip_norm}, batch "
                             f"{cfg['data']['sample_per_replica']}")
    loss_fn = build_loss_fn(model, det_cfg, rng_seed=SEED)
    Trainer(loss_fn, model, optimizer, Batches(batches[:WARMUP_BATCHES]), log_interval=1).run(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(loss_fn, model, optimizer, Batches(batches[WARMUP_BATCHES:]), log_interval=1)
    reset_launches()
    t0 = time.perf_counter()
    history = trainer.run(1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    expect_launches(f"{name} training", launches, 0, 0)
    if len(history) != TIMED_BATCHES or trainer.skipped_steps:
        raise AssertionError(f"{name}: {len(history)} steps logged, {trainer.skipped_steps} skipped")
    for h in history:
        if not all(math.isfinite(h[k]) for k in RETINA_LOSS_KEYS) or not h["num_pos"] > 0:
            raise AssertionError(f"{name}: non-finite loss or no positive at step {h['step']}: {h}")
    still = [n for n, p in model.named_parameters() if p.requires_grad and torch.equal(p, before[n])]
    moved = [n for n, p in model.named_parameters()
             if not p.requires_grad and not torch.equal(p, before[n])]
    frozen = sum(not p.requires_grad for p in model.parameters())
    if still or moved:
        raise AssertionError(f"{name}: trainable parameters that did not move {still}; frozen "
                             f"ones that moved {moved}")
    b = RETINA_TRAIN_BATCH
    step_ms = [b / h["images_per_sec"] * 1e3 for h in history]
    mean_ms = seconds / TIMED_BATCHES * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{name} training path b{b} on {ZOO_TRAIN_CANVAS}: ms a step "
        f"{[round(m, 3) for m in step_ms]}, mean {mean_ms:.3f} ms, {b / (mean_ms / 1e3):.2f} "
        f"images/s, median {statistics.median(step_ms):.3f} ms [{card}]; launches {launches}; "
        f"{frozen} frozen parameter tensors; skipped steps {trainer.skipped_steps}; peak memory "
        f"{peak:.2f} GiB; over the {TIMED_BATCHES} steps "
        + "; ".join(f"{k} {[round(h[k], 4) for h in history]}"
                    for k in RETINA_LOSS_KEYS + ("num_pos",)))
    profile = device_profile(lambda: trainer.train_step(dict(batches[-1])), mean_ms, card, "step")
    retina_train_stage_breakdown(model, det_cfg, optimizer, batches[-1], card, what=name)
    return dict(launches=launches, ms_per_step=mean_ms, profile=profile, peak_gib=peak)


def phase_zoo_reference() -> None:
    """The backbone zoo and the three configs in float32 on the GPU against
    the CPU (TF32 off): each of the seven backbones at its published width
    on the same seeded weights, on two 256 x 320 images; then for each
    config the backbone's outputs, the neck's levels, and on equal inputs
    (the GPU's levels) the head's outputs; then its losses and every
    parameter's gradient through the whole model
    (``phase_retina_train_reference``, float64 on the GPU the yardstick)."""
    checks = []

    def check(what, err, limit):
        checks.append(f"{what} {err:.2e} (limit {limit:g})")
        if not err <= limit:
            raise AssertionError(f"zoo reference check {what}: {err} > {limit}")

    image = torch.randn((2, 256, 320, 3), generator=torch.Generator().manual_seed(SEED + 220))
    for name, kwargs in ZOO_BACKBONES:
        nets = [init_weights(BACKBONES.build(dict(kwargs, type=name), device=device),
                             torch.Generator().manual_seed(SEED)).to(
                                 memory_format=torch.channels_last).eval()
                for device in ("cuda", "cpu")]
        with torch.inference_mode():
            outs = [net(image.to(device)) for net, device in zip(nets, ("cuda", "cpu"))]
        # cuDNN and the CPU sum in other orders (grouped and depthwise too)
        check(f"{name} outputs", max(rel_to_max(g, c) for g, c in zip(*outs)), 1e-4)
    log("zoo reference check, the seven backbones at their published widths, GPU vs CPU "
        "float32, relative to each output's largest value: " + "; ".join(checks))
    for name, config in ZOO:
        checks.clear()
        cfg = Config.fromfile(config)
        gpu, cpu = (build_detector(cfg.model, "float32", device, seed=SEED)
                    for device in ("cuda", "cpu"))
        x = space_to_depth_2x2(image) if stem_s2d(cfg) else image
        with torch.inference_mode():
            fg, fc = gpu.backbone(x.cuda()), cpu.backbone(x)
            check("backbone outputs", max(rel_to_max(g, c) for g, c in zip(fg, fc)), 1e-4)
            lg, lc = gpu.neck(fg), cpu.neck([f.cpu() for f in fg])
            check(f"{type(gpu.neck).__name__} levels on equal inputs",
                  max(rel_to_max(g, c) for g, c in zip(lg, lc)), 1e-4)
            cls_g, reg_g = gpu.head(lg)
            cls_c, reg_c = cpu.head([f.cpu() for f in lg])
            check("head logits and deltas on equal inputs",
                  max(rel_to_max(g, c) for g, c in zip(cls_g + reg_g, cls_c + reg_c)), 1e-4)
        log(f"{name} reference check, GPU vs CPU float32 on 2 x 256 x 320, relative to each "
            "output's largest value: " + "; ".join(checks))
    for name, config in ZOO:
        phase_retina_train_reference(config, name)


def write_torchvision_mobilenet_v2(path: Path, seed: int) -> dict:
    """A seeded state dict in torchvision's MobileNetV2 layout: the stem
    (``features.0``), the 17 inverted residuals (``features.1``-``17``, each
    ``conv`` a Sequential of conv-BN-ReLU6 triples and a bare conv and BN),
    the last 1x1 to 1280 (``features.18``) and ``classifier.1`` at a small
    shape; kernels normal of variance 2 / fan_in, BN weights 1 and biases 0,
    running means normal(0, 0.1) and variances in [0.5, 1.5]."""
    gen = torch.Generator().manual_seed(seed)
    state = {}

    def conv(key: str, cout: int, cin: int, k: int) -> None:
        state[f"{key}.weight"] = torch.randn((cout, cin, k, k), generator=gen) * math.sqrt(
            2.0 / (cin * k * k))

    def bn(key: str, c: int) -> None:
        state.update({f"{key}.weight": torch.ones(c), f"{key}.bias": torch.zeros(c),
                      f"{key}.running_mean": torch.randn((c,), generator=gen) * 0.1,
                      f"{key}.running_var": 0.5 + torch.rand((c,), generator=gen),
                      f"{key}.num_batches_tracked": torch.tensor(0)})

    conv("features.0.0", 32, 3, 3)
    bn("features.0.1", 32)
    cin, feat = 32, 1
    for expansion, planes, blocks, _, _ in MOBILENETV2_SETTINGS:
        for _ in range(blocks):
            hidden, base, k = cin * expansion, f"features.{feat}.conv", 0
            if expansion != 1:
                conv(f"{base}.0.0", hidden, cin, 1)
                bn(f"{base}.0.1", hidden)
                k = 1
            conv(f"{base}.{k}.0", hidden, 1, 3)  # depthwise: one input channel a group
            bn(f"{base}.{k}.1", hidden)
            conv(f"{base}.{k + 1}", planes, hidden, 1)
            bn(f"{base}.{k + 2}", planes)
            cin, feat = planes, feat + 1
    conv("features.18.0", 1280, cin, 1)
    bn("features.18.1", 1280)
    state["classifier.1.weight"], state["classifier.1.bias"] = torch.zeros((8, 1280)), torch.zeros(8)
    torch.save(state, str(path))
    return state


def phase_cli_zoo(card: str) -> dict:
    """RetinaNet MobileNetV2-FPN through the entry points at full width: a
    seeded COCO folder of the committed JPEG fixtures under
    build/smoke_coco_zoo (landscape and square: the config's fixed canvas
    holds no portrait, R8), a seeded torchvision-layout MobileNetV2 ``.pth``
    given as ``--pretrained file://`` (copied into a cache under the
    folder), ``tools.train`` for 2 epochs of the config's b8, then
    ``tools.test`` on the last epoch and the val gts' oracle. The importer
    must set as many tensors as its table predicts (five a conv of the
    backbone: the conv and its FrozenBN's four), all under ``backbone.``
    (the reference loads none, R9), and the trained checkpoint keeps the
    file's FrozenBN statistics bit for bit. K1, K2 and the matcher never
    launch."""
    shutil.rmtree(SMOKE_COCO_ZOO, ignore_errors=True)
    train_ann = write_smoke_coco_ssd("train", ZOO_CLI_TRAIN, 0, SEED + 230, SMOKE_COCO_ZOO)
    val_ann = write_smoke_coco_ssd("val", ZOO_CLI_VAL, 0, SEED + 231, SMOKE_COCO_ZOO)
    pth = SMOKE_COCO_ZOO / "mobilenet_v2.pth"
    state = write_torchvision_mobilenet_v2(pth, SEED + 232)
    convs = 1 + sum(blocks * (2 if expansion == 1 else 3)
                    for expansion, _, blocks, _, _ in MOBILENETV2_SETTINGS)
    predicted = 5 * convs
    config = SMOKE_COCO_ZOO / "retinanet_mobilenetv2_smoke.py"
    work = SMOKE_COCO_ZOO / "work"
    data = {split: dict(ann_file=str(ann), img_prefix=str(SMOKE_COCO_ZOO / split))
            for split, ann in (("train", train_ann), ("val", val_ann))}
    config.write_text(
        f"_base_ = {str(MOBILENETV2_RETINA_CONFIG)!r}\n"
        f"data = dict(**{data!r})\n"
        "detection = dict(score_thr=0.0)\n"
        "schedule = dict(warmup_steps=100)\n"
        f"runtime = dict(work_dir={str(work)!r}, log_interval=1)\n")
    cfg = Config.fromfile(config)
    det_cfg = build_detection_cfg(cfg["detection"])
    cache = os.environ.get("XDG_CACHE_HOME")
    os.environ["XDG_CACHE_HOME"] = str(SMOKE_COCO_ZOO / "cache")
    try:
        reset_launches()
        t0 = time.perf_counter()
        with logged_lines() as lines:
            trainer = train_cli.main([str(config), "--epochs", str(ZOO_CLI_EPOCHS), "--work-dir",
                                      str(work), "--pretrained", f"file://{pth}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if cache is None:
            os.environ.pop("XDG_CACHE_HOME")
        else:
            os.environ["XDG_CACHE_HOME"] = cache
    launches = read_launches()
    expect_launches("cli zoo training", launches, 0, 0)
    backbone = sum(k.startswith("backbone.") for k in trainer.model.state_dict())
    loaded = [line for line in lines if line.startswith("loaded ") and "mobilenet_v2.pth" in line]
    if len(loaded) != 1 or not loaded[0].startswith(f"loaded {predicted} tensors") or \
            f"{predicted} of the backbone's {backbone}" not in loaded[0] or predicted != backbone:
        raise AssertionError(f"cli zoo: the import logged {loaded}; the table predicts "
                             f"{predicted} of the backbone's {backbone}")
    steps = len(trainer.dataloader)
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    if len(records) != steps * ZOO_CLI_EPOCHS or not all(
            math.isfinite(r[k]) for r in records for k in RETINA_LOSS_KEYS):
        raise AssertionError(f"cli zoo training: {len(records)} records for {ZOO_CLI_EPOCHS} x "
                             f"{steps} steps, or a non-finite loss")
    saved = load_checkpoint_file(str(work / f"epoch_{ZOO_CLI_EPOCHS}"))["model"]
    mapped, _ = convert_state_dict(trainer.model, state, detector_key_rules(trainer.model, state))
    stats = [k for k in mapped if k.endswith((".mean", ".var"))]
    kept = [k for k in stats if torch.equal(saved[k].cpu(), mapped[k])]
    weights = [k for k in mapped if k.endswith(".conv.weight")]
    drift = max(float((saved[k].float().cpu() - mapped[k]).norm() / mapped[k].norm())
                for k in weights)
    # a conv drawn afresh would sit about sqrt(2) from the file's
    if len(kept) != len(stats) or len(stats) != 2 * convs or not drift < 0.5:
        raise AssertionError(f"cli zoo: epoch_{ZOO_CLI_EPOCHS} keeps {len(kept)} of the file's "
                             f"{len(stats)} FrozenBN statistics; its convs within {drift} of the "
                             "file's")
    log(f"cli zoo training [{card}]: {ZOO_CLI_TRAIN} landscape and square JPEGs, "
        f"{ZOO_CLI_EPOCHS} epochs of {steps} steps of b{cfg['data']['sample_per_replica']} on "
        f"{tuple(cfg['data']['canvas'])} in {wall:.1f} s (the build and the import included); "
        f"{loaded[0]!r}, the table predicts {predicted} ({convs} convs and their FrozenBN); "
        f"epoch_{ZOO_CLI_EPOCHS} keeps the file's {len(stats)} FrozenBN statistics bit for bit, "
        f"its {len(weights)} backbone convs within {drift:.4f} of the file's (relative norm); "
        f"launches {launches}; losses " + "; ".join(
            f"{k} {[round(r[k], 4) for r in records]}" for k in RETINA_LOSS_KEYS + ("num_pos",)))
    del trainer

    out = SMOKE_COCO_ZOO / "results.json"
    reset_launches()
    t0 = time.perf_counter()
    metrics = test_cli.main([str(config), str(work / f"epoch_{ZOO_CLI_EPOCHS}"), "--out",
                             str(out)])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = read_launches()
    expect_launches("cli zoo test", test_launches, 0, 0)
    frames, results, oracle = check_cli_results("cli zoo", metrics, out, val_ann, cfg, det_cfg)
    log(f"cli zoo test [{card}]: {len(frames)} images in {test_s:.1f} s (the build included), "
        f"launches {test_launches}; {len(results)} detections in the COCO results JSON, each "
        f"inside its original frame; mAP {metrics['mAP']:.6f} (random heads after "
        f"{ZOO_CLI_EPOCHS} epochs), the val gts as detections give mAP {oracle:.6f}; "
        + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    return dict(training=launches, test=test_launches, loaded=predicted, mAP=metrics["mAP"])


# ---------------------------------------------------------------- serving export and profiling
EXPORT_DIR = ROOT / "build" / "export"
# (name, config, K1's output sizes in a batch): the full-width artifacts through
# tools.export --check
EXPORT_FULL = (("faster_rcnn", CONFIG, (7,)), ("mask_rcnn", MASK_CONFIG, (7, 14)),
               ("retina", RETINA_CONFIG, ()))
EXPORT_WORKERS = 4  # processes exporting the narrow families while the main one exports the full
EXPORT_ROUNDING = 0.0  # artifact against live module: the same kernels on the same inputs


def narrow_exports() -> dict:
    """The narrow models of the CPU export tests (tests/test_torch_export.py)
    for the families served only there: name -> (model dict, config,
    canvas, batch, K1 launches a batch)."""
    from torch_detection_tpu_torch.models import detectors as d
    from torch_detection_tpu_torch.ops.anchors import (
        AnchorGenerator,
        SSDAnchorGenerator,
        YOLOAnchorGenerator,
    )

    r18_p3 = dict(type="ResNet", depth=18, num_stages=4, out_indices=(1, 2, 3))
    r18_p2 = dict(type="ResNet", depth=18, num_stages=4, out_indices=(0, 1, 2, 3))
    fpn_p3 = dict(type="FPN", in_channels=(128, 256, 512), out_channels=32, num_outs=5,
                  add_extra_convs=True, extra_convs_on_inputs=True, relu_before_extra_convs=True)
    fpn_p2 = dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=32, num_outs=5)
    rpn = dict(type="RPNHead", in_channels=32, feat_channels=32, num_base_anchors=3)
    bbox = dict(type="BBoxHead", num_classes=4, fc_channels=64)
    fcn = dict(type="FCNMaskHead", num_classes=4, in_channels=32, conv_channels=16, num_convs=1)
    top = dict(max_detections=10, pre_nms_top_k=64, score_thr=0.0)
    retina_anchors = AnchorGenerator(strides=(8, 16, 32, 64, 128), ratios=(0.5, 1.0, 2.0),
                                     octave_base_scale=4.0, scales_per_octave=3)
    square_anchors = AnchorGenerator(strides=(8, 16, 32, 64, 128), ratios=(1.0,),
                                     octave_base_scale=8.0, scales_per_octave=1)

    def dense(kind, **kw):
        head = dict(type=kind, num_classes=4, in_channels=32, feat_channels=32, stacked_convs=1,
                    **kw)
        return dict(type="SingleStageDetector", backbone=r18_p3, neck=fpn_p3, head=head)

    small = (64, 64)
    return {
        "cascade_rcnn": (dict(type="CascadeRCNN", backbone=r18_p2, neck=fpn_p2, rpn_head=rpn,
                              bbox_head=bbox, num_stages=3),
                         d.CascadeRCNNConfig(num_classes=4, max_detections=8, score_thr=0.0),
                         small, 1, 3),
        "cascade_mask_rcnn": (dict(type="CascadeMaskRCNN", backbone=r18_p2, neck=fpn_p2,
                                   rpn_head=rpn, bbox_head=bbox, mask_head=fcn, num_stages=3),
                              d.CascadeMaskRCNNConfig(num_classes=4, max_detections=8,
                                                      score_thr=0.0, mask_roi_size=7,
                                                      mask_size=14), small, 1, 4),
        "sparse_rcnn": (dict(type="SparseRCNN", backbone=r18_p2,
                             neck=dict(type="FPN", in_channels=(64, 128, 256, 512),
                                       out_channels=32, num_outs=4),
                             num_proposals=8, num_stages=2, num_classes=3, d_model=32, nhead=4,
                             dim_feedforward=64, dynamic_dim=16, roi_size=7,
                             roi_strides=(4, 8, 16, 32)),
                        d.SparseRCNNConfig(num_classes=3, num_proposals=8, max_detections=8,
                                           score_thr=0.0), small, 1, 2),
        "detr": (dict(type="DETR", backbone=dict(type="ResNet", depth=18, num_stages=4,
                                                 out_indices=(3,)),
                      num_classes=3, d_model=32, nhead=4, num_encoder_layers=2,
                      num_decoder_layers=2, dim_feedforward=64, num_queries=8),
                 d.DETRConfig(num_classes=3, num_queries=8, max_detections=8, score_thr=0.0),
                 small, 1, 0),
        "fcos": (dense("FCOSHead"), d.FCOSConfig(num_classes=4, **top), small, 1, 0),
        "atss": (dense("ATSSHead"), d.ATSSConfig(num_classes=4, anchor_generator=square_anchors,
                                                 **top), small, 1, 0),
        "gfl": (dense("GFLHead", reg_max=8),
                d.GFLConfig(num_classes=4, reg_max=8, anchor_generator=square_anchors, **top),
                small, 1, 0),
        "fovea": (dense("FoveaHead"), d.FoveaConfig(num_classes=4, **top), small, 1, 0),
        "free_anchor": (dense("RetinaHead", num_base_anchors=9),
                        d.FreeAnchorConfig(num_classes=4, anchor_generator=retina_anchors,
                                           max_detections=10, pre_nms_top_k=100, score_thr=0.0),
                        small, 2, 0),
        "paa": (dense("PAAHead"), d.PAAConfig(num_classes=4, anchor_generator=square_anchors,
                                              max_detections=10, pre_nms_top_k=100,
                                              score_thr=0.0), small, 1, 0),
        "ssd": (dict(type="SingleStageDetector", backbone=dict(type="SSDVGG", depth=16),
                     neck=None,
                     head=dict(type="SSDHead", num_classes=4,
                               in_channels=(512, 1024, 512, 256, 256, 256),
                               anchors_per_level=(4, 6, 6, 6, 4, 4))),
                d.SSDConfig(num_classes=4, anchor_generator=SSDAnchorGenerator(),
                            max_detections=10, pre_nms_top_k=100, score_thr=0.0),
                (300, 300), 1, 0),
        "yolo": (dict(type="SingleStageDetector",
                      backbone=dict(type="Darknet", depth=53, stages=(1, 1, 1, 1, 1),
                                    base_channels=8, out_indices=(2, 3, 4)),
                      neck=dict(type="YOLOV3Neck", in_channels=(64, 128, 256),
                                out_channels=(64, 32, 16)),
                      head=dict(type="YOLOV3Head", num_classes=4, anchors_per_level=1,
                                in_channels=(64, 32, 16), out_channels=(128, 64, 32))),
                 d.YOLOV3Config(num_classes=4, anchor_generator=YOLOAnchorGenerator(
                     strides=(32, 16, 8),
                     base_sizes=(((48.0, 48.0),), ((24.0, 24.0),), ((12.0, 12.0),))),
                     max_detections=10, pre_nms_top_k=100, score_thr=0.0, conf_thr=0.0,
                     pre_select_per_level=50), small, 2, 0),
        "yolox": (dict(type="SingleStageDetector",
                       backbone=dict(type="CSPDarknet", deepen_factor=0.33, widen_factor=0.125,
                                     out_indices=(2, 3, 4)),
                       neck=dict(type="YOLOXPAFPN", in_channels=(32, 64, 128), out_channels=32,
                                 num_csp_blocks=1),
                       head=dict(type="YOLOXHead", num_classes=4, in_channels=32,
                                 feat_channels=32, stacked_convs=1)),
                  d.YOLOXConfig(num_classes=4, max_detections=8, pre_nms_top_k=64,
                                score_thr=0.0), small, 1, 0),
        "centernet": (dict(type="SingleStageDetector",
                           backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(3,)),
                           neck=dict(type="CTResNetNeck", in_channels=512,
                                     num_deconv_filters=(32, 16, 16)),
                           head=dict(type="CenterNetHead", num_classes=4, in_channels=16,
                                     feat_channels=16)),
                      d.CenterNetConfig(num_classes=4, max_detections=10, score_thr=0.0),
                      small, 2, 0),
        "solov2": (dict(type="SOLOV2", backbone=r18_p2,
                        neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=16,
                                  num_outs=5),
                        head=dict(type="SOLOV2Head", num_classes=4, in_channels=16,
                                  feat_channels=16, kernel_channels=8, stacked_convs=1,
                                  grid_numbers=(12, 10, 8, 6, 4), norm_groups=4),
                        mask_feat_head=dict(type="MaskFeatHead", in_channels=16, feat_channels=16,
                                            out_channels=8, num_inputs=4, norm_groups=4)),
                   d.SOLOV2Config(num_classes=4, grid_numbers=(12, 10, 8, 6, 4),
                                  scale_ranges=((1, 32), (16, 48), (32, 64), (48, 96), (64, 256)),
                                  pre_nms_top_k=16, max_detections=8, mask_out_size=14,
                                  score_thr=0.0, update_thr=0.0), small, 1, 0),
        "retina_soft_nms": (dense("RetinaHead", num_base_anchors=9),
                            d.RetinaNetConfig(num_classes=4, anchor_generator=retina_anchors,
                                              max_detections=10, pre_nms_top_k=100,
                                              score_thr=0.0, nms_method="soft"), small, 2, 0),
    }


def export_inputs(seed: int, batch: int, canvas, s2d: bool = False, device="cuda"):
    """A seeded uint8 batch on ``device``: every four images two fill the
    canvas and two are ``INNER_SHAPES`` (narrower canvases: the first full,
    the rest 9 x 13 pixels smaller), zero beyond each image; on the s2d
    wire relaid on the host; int32 (h, w) and scale factors 1, 2, ..."""
    h, w = canvas
    rng = np.random.default_rng(seed)
    if canvas == CANVAS:
        shapes = [(h, w), INNER_SHAPES[0], (h, w), INNER_SHAPES[1]] * (batch // 4 + 1)
    else:
        shapes = [(h, w)] + [(h - 9, w - 13)] * batch
    shapes = np.array(shapes[:batch], np.int32)
    images = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    for img, (ih, iw) in zip(images, shapes):
        img[ih:], img[:, iw:] = 0, 0
    if s2d:
        images = space_to_depth_2x2_np(images)
    return (torch.from_numpy(images).to(device), torch.from_numpy(shapes).to(device),
            torch.arange(1, batch + 1, dtype=torch.float32, device=device))


def graph_ops(program) -> collections.Counter:
    """The call_function targets of an exported program's graph, counted."""
    return collections.Counter(str(n.target) for n in program.graph.nodes
                               if n.op == "call_function")


def export_narrow(name: str) -> dict:
    """One narrow family on the card, in a worker process: export, save to
    memory, load, then the artifact and the live module on one seeded
    batch; K1 counted over each run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model_dict, det_cfg, canvas, batch, k1 = narrow_exports()[name]
    model = build_detector(model_dict, "float32", device="cuda", seed=SEED)
    t0 = time.perf_counter()
    program = export_serving(model, det_cfg, batch, canvas)
    export_s = time.perf_counter() - t0
    ops = graph_ops(program)
    buffer = io.BytesIO()
    t0 = time.perf_counter()
    save_serving(program, buffer)
    save_s = time.perf_counter() - t0
    buffer.seek(0)
    t0 = time.perf_counter()
    loaded = load_serving(buffer)
    load_s = time.perf_counter() - t0
    inputs = export_inputs(SEED + 230, batch, canvas)
    reset_launches()
    got = loaded(*inputs)
    torch.cuda.synchronize()
    artifact = read_launches()
    reset_launches()
    want = make_serving_fn(model, det_cfg)(*inputs)
    torch.cuda.synchronize()
    live = read_launches()
    return dict(name=name, export_s=export_s, save_s=save_s, load_s=load_s,
                mb=buffer.getbuffer().nbytes / 1e6, keys=sorted(got), expected_k1=k1,
                equal={k: bool(torch.equal(got[k], want[k])) for k in want},
                valid=int(got["valid"].sum()), artifact=artifact, live=live,
                roi_align_nodes=ops["torch_detection_tpu_torch.roi_align.default"],
                while_loops=sum(n for t, n in ops.items() if "while_loop" in t))


def check_served(what: str, out: dict, det_cfg, shapes: torch.Tensor) -> int:
    """Shapes, finite values, a detection in every image, labels in range,
    boxes inside each image, valid scores above ``score_thr``; returns the
    valid detections."""
    b, d = shapes.shape[0], det_cfg.max_detections
    if out["boxes"].shape != (b, d, 4) or any(out[k].shape != (b, d)
                                                for k in ("scores", "labels", "valid")):
        raise AssertionError(f"{what}: output shapes {[tuple(v.shape) for v in out.values()]}")
    if not (torch.isfinite(out["boxes"]).all() and torch.isfinite(out["scores"]).all()):
        raise AssertionError(f"{what}: non-finite detections")
    v = out["valid"]
    if not bool(v.any(dim=1).all()):
        raise AssertionError(f"{what}: an image without a detection above score_thr")
    lab = out["labels"][v]
    if not (bool((lab >= 0).all()) and bool((lab < det_cfg.num_classes).all())):
        raise AssertionError(f"{what}: labels out of range")
    limit = torch.stack([shapes[:, 1], shapes[:, 0]] * 2, dim=-1)[:, None].float() - 1
    if not (bool((out["boxes"][v] >= 0).all())
            and bool((out["boxes"] <= limit + 1e-3)[v].all())):
        raise AssertionError(f"{what}: boxes outside their image")
    if not bool((out["scores"][v] > det_cfg.score_thr).all()):
        raise AssertionError(f"{what}: a valid detection under score_thr")
    if "mask_probs" in out:
        m = out["mask_probs"]
        if not (bool(torch.isfinite(m).all()) and float(m.min()) >= 0 and float(m.max()) <= 1
                and not bool(m[~v].any())):
            raise AssertionError(f"{what}: mask probabilities outside [0, 1] or on invalid slots")
    return int(v.sum())


def export_full(name: str, config: Path) -> dict:
    """``tools.export --check`` at full width: b4 on 800 x 1216 in the
    config's dtype; RetinaNet from a checkpoint of its seeded build with
    ``cls_out``'s bias at 0 (``load_retina``), so that NMS works on a full
    pool."""
    argv = [str(config), "--out", str(EXPORT_DIR / f"{name}.pt2"), "--batch", str(BATCH),
            "--canvas", f"{CANVAS[0]}x{CANVAS[1]}", "--check"]
    if name == "retina":
        model, _ = load_retina("bfloat16", torch.device("cuda"))
        save_checkpoint(str(EXPORT_DIR / "retina_seeded"), model)
        del model
        argv += ["--checkpoint", str(EXPORT_DIR / "retina_seeded")]
    t0 = time.perf_counter()
    result = export_cli.main(argv)
    result["cli_s"] = time.perf_counter() - t0
    return result


def time_export(card: str, name: str, out_sizes: tuple, result: dict, seed: int) -> dict:
    """The loaded artifact and the live module on the same seeded batches:
    2 warm-up, then 10 timed each (artifact first), K1 counted by output
    size over each run (once a batch at each of ``out_sizes``), every
    output of the artifact equal to the live module's; then one batch of
    each under the profiler."""
    k1 = len(out_sizes)
    det_cfg = result["serving"].det_cfg
    batches = [export_inputs(seed + i, BATCH, CANVAS, result["s2d_wire"])
               for i in range(WARMUP_BATCHES + TIMED_BATCHES)]
    runs = {"artifact": result["loaded"], "live": result["serving"]}
    outs, rates, launches = {}, {}, {}
    for what, run in runs.items():
        for args in batches[:WARMUP_BATCHES]:
            run(*args)
        torch.cuda.synchronize()
        reset_launches()
        timed = iter(batches[WARMUP_BATCHES:])
        with launches_by_out_size() as sizes:
            ms, outs[what] = timed_batches(lambda: run(*next(timed)), TIMED_BATCHES)
        launches[what] = dict(read_launches(), k1_by_out_size=dict(sizes["k1"]))
        expect_launches(f"export {name} {what}", {k: launches[what][k] for k in
                                                  ("k1", "k2", "matcher")}, k1 * TIMED_BATCHES, 0)
        if launches[what]["k1_by_out_size"] != {size: TIMED_BATCHES for size in out_sizes}:
            raise AssertionError(f"export {name} {what}: K1 by output size "
                                 f"{launches[what]['k1_by_out_size']}, expected {out_sizes} "
                                 "once a batch")
        rates[what] = dict(ms=sum(ms) / len(ms), images_per_s=BATCH / (sum(ms) / len(ms) / 1e3),
                           median_ms=statistics.median(ms))
    gaps = {k: max(float((a[k].double() - b[k].double()).abs().max())
                   for a, b in zip(outs["artifact"], outs["live"]))
            for k in outs["live"][0]}
    if any(gap > EXPORT_ROUNDING for gap in gaps.values()):
        raise AssertionError(f"export {name}: the artifact parts from the live module by {gaps} "
                             f"(limit {EXPORT_ROUNDING})")
    valid = [check_served(f"export {name}", o, det_cfg, b[1])
             for o, b in zip(outs["artifact"], batches[WARMUP_BATCHES:])]
    profiles = {what: device_profile(lambda: run(*batches[-1]), rates[what]["ms"], card,
                                     f"{name} {what} batch")
                for what, run in runs.items()}
    log(f"export {name} [{card}]: tools.export --check in {result['cli_s']:.1f} s (export "
        f"{result['export_s']:.1f} s, save {result['save_s']:.1f} s, load {result['load_s']:.1f} "
        f"s), artifact {result['mb']:.1f} MB, the CLI's check gaps {result['max_diff']}; over "
        f"{TIMED_BATCHES} batches of b{BATCH} on {CANVAS} ({'s2d' if result['s2d_wire'] else 'rgb'}"
        f" uint8 wire): artifact {rates['artifact']['ms']:.3f} ms a batch, "
        f"{rates['artifact']['images_per_s']:.2f} images/s (median "
        f"{rates['artifact']['median_ms']:.3f} ms), live module {rates['live']['ms']:.3f} ms, "
        f"{rates['live']['images_per_s']:.2f} images/s (median {rates['live']['median_ms']:.3f} "
        f"ms); K1 launches in the artifact's runs {launches['artifact']} (expected out "
        f"{out_sizes} once a batch), "
        f"in the live runs {launches['live']}; largest gap artifact - live {gaps} (limit "
        f"{EXPORT_ROUNDING}); valid detections a batch {valid}")
    return dict(launches=launches["artifact"], live_launches=launches["live"], rates=rates,
                gaps=gaps, profiles=profiles, seconds={k: result[k] for k in ("export_s", "save_s", "load_s",
                                                           "cli_s")}, mb=result["mb"])


def phase_export(card: str) -> dict:
    """Serving export on the card: the three full-width artifacts through
    ``tools.export --check`` in this process while ``EXPORT_WORKERS`` spawned
    processes export, round-trip and check every other family that
    ``make_serving_fn`` handles on its narrow CPU-test model; then, the
    workers done, each full-width artifact timed beside its live module."""
    t_phase = time.perf_counter()
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    EXPORT_DIR.mkdir(parents=True)
    names = list(narrow_exports())
    with multiprocessing.get_context("spawn").Pool(EXPORT_WORKERS) as pool:
        pending = pool.map_async(export_narrow, names)
        full = {name: export_full(name, config) for name, config, _ in EXPORT_FULL}
        narrow = pending.get(timeout=900)
    torch.cuda.synchronize()
    for r in narrow:
        ok = (all(r["equal"].values()) and r["valid"] > 0
              and r["artifact"] == dict(k1=r["expected_k1"], k2=0, matcher=0)
              and r["live"] == r["artifact"]
              and (r["roi_align_nodes"] > 0) == (r["expected_k1"] > 0))
        log(f"export {r['name']} (narrow, float32) [{card}]: export {r['export_s']:.1f} s, save "
            f"{r['save_s']:.1f} s, load {r['load_s']:.1f} s, {r['mb']:.1f} MB; outputs "
            f"{r['keys']} equal to the live module's {r['equal']}; {r['valid']} valid; "
            f"roi_align nodes {r['roi_align_nodes']}, while_loop nodes {r['while_loops']}; "
            f"launches artifact {r['artifact']}, live {r['live']} (K1 expected "
            f"{r['expected_k1']})")
        if not ok:
            raise AssertionError(f"export {r['name']}: {r}")
    timed = {name: time_export(card, name, sizes, full.pop(name), SEED + 240 + 20 * i)
             for i, (name, _, sizes) in enumerate(EXPORT_FULL)}
    log(f"export phase wall time {time.perf_counter() - t_phase:.1f} s [{card}]")
    paths = {f"export_{name}_artifact": {k: t["launches"][k] for k in ("k1", "k2", "matcher")}
             for name, t in timed.items()}
    paths.update({f"export_{r['name']}_artifact": r["artifact"] for r in narrow})
    return dict(paths=paths, full=timed, narrow={r["name"]: r for r in narrow})


PROFILE_TRAIN_IMAGES = 16  # two steps of the smoke config's b8


def phase_cli_profile(card: str) -> dict:
    """``tools.train --profile-dir`` on the Faster R-CNN smoke config (one
    epoch of two b8 steps on 800 x 1344 from PNGs written for it): the
    trace must hold K1's and K2's kernels, one by symbol name a step, and
    the trainer's ``train_step`` spans from ``annotate``, and K1 and K2
    must count one launch a step."""
    t0 = time.perf_counter()
    ann = write_smoke_coco("profile", PROFILE_TRAIN_IMAGES, SEED + 76)
    config = SMOKE_COCO / "faster_rcnn_r50_fpn_profile.py"
    config.write_text(
        f"_base_ = {str(SMOKE_COCO / 'faster_rcnn_r50_fpn_smoke.py')!r}\n"
        f"data = dict(train=dict(ann_file={str(ann)!r}, "
        f"img_prefix={str(SMOKE_COCO / 'profile')!r}))\n")
    trace_dir = SMOKE_COCO / "profile_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    reset_launches()
    trainer = train_cli.main([str(config), "--epochs", "1", "--work-dir",
                              str(SMOKE_COCO / "work_profile"), "--profile-dir", str(trace_dir)])
    torch.cuda.synchronize()
    launches = read_launches()
    steps = trainer.optimizer.steps
    expect_launches("cli profile training", launches, steps, steps)
    path = trace_dir / TRACE_NAME
    events = json.loads(path.read_text())["traceEvents"]
    kinds = collections.Counter((e.get("cat", ""), e.get("name", "")) for e in events
                                if e.get("ph") == "X")
    k1 = sum(n for (cat, k), n in kinds.items() if cat == "kernel" and "roi_align_fwd_kernel" in k)
    k2 = sum(n for (cat, k), n in kinds.items() if cat == "kernel" and "roi_align_bwd_kernel" in k)
    spans = kinds["user_annotation", "train_step"]
    log(f"cli profile [{card}]: tools.train --profile-dir, {steps} steps of b8 in "
        f"{time.perf_counter() - t0:.1f} s; {path.name} {path.stat().st_size / 1e6:.1f} MB, "
        f"{len(events)} events; K1 kernel events {k1}, K2 kernel events {k2}, train_step spans "
        f"{spans} (and {kinds['gpu_user_annotation', 'train_step']} on the device's timeline), data "
        f"spans {kinds['user_annotation', 'data']}; launches {launches}")
    if not (k1 == k2 == spans == steps):
        raise AssertionError(f"cli profile: the trace holds {k1} K1 and {k2} K2 kernel events "
                             f"and {spans} train_step spans for {steps} steps")
    return dict(training=launches, trace_mb=path.stat().st_size / 1e6, events=len(events))


DP_WORLD = 2
DP_PARITY_IMAGES = 2  # a rank's share of the float32 parity step: 4 images in all
DP_TIMED_BATCH = 4  # a rank's images a timed bf16 step
DP_ONE_BATCH = 8  # the one process's, the two ranks' together
DP_WARMUP, DP_TIMED = 2, 10
DP_LOSS_RTOL, DP_UPDATE_RTOL = 1e-4, 1e-2
DP_DIR = ROOT / "build" / "dp"
DP_TIMEOUT_S = 600


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_config(compute_dtype: str, fsdp: bool = False) -> dict:
    """The Faster R-CNN R50-FPN config at full width, its compute dtype and
    FSDP switch set."""
    cfg = Config.fromfile(CONFIG)
    return dict(cfg, runtime=dict(cfg.get("runtime", {}), compute_dtype=compute_dtype, fsdp=fsdp))


def dp_parity_batch(device) -> dict:
    """The parity step's global batch: ``DP_WORLD * DP_PARITY_IMAGES``
    seeded images on the 800 x 1216 canvas with their gts."""
    gen = torch.Generator(device=device).manual_seed(SEED + 300)
    return train_batch(gen, DP_WORLD * DP_PARITY_IMAGES)


def whole_params(model) -> dict:
    """Every parameter whole (gathered from an FSDP model's shards)."""
    return {n: full_tensor(p).detach().clone() for n, p in model.named_parameters()}


def param_digest(params: dict) -> str:
    h = hashlib.sha256()
    for n in sorted(params):
        h.update(n.encode() + params[n].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_rank(rank: int, world: int, port: int, backend: str, mode: str, device: str) -> None:
    """One rank of ``phase_dp_step``, a spawned process. ``mode`` ``ddp``
    or ``fsdp``; ``device`` ``cuda`` (each rank its ``cuda:LOCAL_RANK``) or
    ``cuda:0`` (both ranks share it, under gloo). One
    float32 step on its two images of the parity batch (rank 0 writes its
    parameters' update), then ``DP_WARMUP`` + ``DP_TIMED`` bf16 steps of
    ``DP_TIMED_BATCH`` images of its own; K1's and K2's launches counted
    in this process. Writes its report to ``DP_DIR/<mode>_<backend>_rank<rank>.pt``."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = init_distributed(backend, device, timeout_s=DP_TIMEOUT_S)
    device = info["device"]
    fsdp = mode == "fsdp"
    out = dict(rank=rank, device=str(device), backend=info["backend"])

    batch = dp_parity_batch(device)
    rows = slice(rank * DP_PARITY_IMAGES, (rank + 1) * DP_PARITY_IMAGES)
    model, det_cfg, _, optimizer = build_train_objects(dp_config("float32", fsdp), device,
                                                       seed=SEED, loader=Batches([None]))
    step = make_train_step(build_loss_fn(model, det_cfg, rng_seed=SEED), optimizer)
    before = whole_params(model)
    reset_launches()
    metrics = step({k: v[rows] for k, v in batch.items()})
    torch.cuda.synchronize()
    out["parity_launches"] = read_launches()
    after = whole_params(model)
    out["parity_metrics"] = {k: float(v) for k, v in metrics.items()}
    out["digest"] = param_digest(after)
    if rank == 0:
        torch.save({n: (after[n] - before[n]).cpu() for n, p in model.named_parameters()
                    if p.requires_grad}, DP_DIR / f"{mode}_{backend}_update.pt")
    del model, optimizer, step, before, after
    torch.cuda.empty_cache()

    model, det_cfg, _, optimizer = build_train_objects(dp_config("bfloat16", fsdp), device,
                                                       seed=SEED, loader=Batches([None]))
    step = make_train_step(build_loss_fn(model, det_cfg, rng_seed=SEED), optimizer)
    gen = torch.Generator(device=device).manual_seed(SEED + 310 + rank)
    batches = [train_batch(gen, DP_TIMED_BATCH) for _ in range(DP_WARMUP + DP_TIMED)]
    reset_launches()
    for b in batches[:DP_WARMUP]:
        step(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    torch.distributed.barrier()
    t0 = time.perf_counter()
    losses = [float(step(b)["loss"]) for b in batches[DP_WARMUP:]]
    torch.cuda.synchronize()
    out["timed_s"] = time.perf_counter() - t0
    out["timed_launches"] = read_launches()
    out["timed_losses"] = losses
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    out["timed_digest"] = param_digest(whole_params(model))
    if not fsdp:  # the gradients' all-reduce alone (zeros, the same bytes), synced
        torch.distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            optimizer.reduce_gradients()
        torch.cuda.synchronize()
        out["allreduce_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        optimizer.zero_grad()
    torch.save(out, DP_DIR / f"{mode}_{backend}_rank{rank}.pt")
    shutdown_distributed(info)


def run_ranks(backend: str, mode: str, device: str = "cuda") -> list:
    """``DP_WORLD`` spawned ``dp_rank`` processes; their reports."""
    ctx = torch.multiprocessing.start_processes(dp_rank,
                                                args=(DP_WORLD, free_port(), backend, mode, device),
                                                nprocs=DP_WORLD, join=False, start_method="spawn")
    deadline = time.perf_counter() + DP_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.perf_counter() > deadline:
                raise AssertionError(f"dp {mode} {backend}: the ranks did not finish")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(DP_DIR / f"{mode}_{backend}_rank{r}.pt") for r in range(DP_WORLD)]


def check_dp_run(what: str, ranks: list, one: dict, card: str,
                 update_rtol: float = DP_UPDATE_RTOL) -> dict:
    """A run's ranks against the one process on the parity batch: the loss
    to ``DP_LOSS_RTOL``, each parameter's update to ``update_rtol`` in
    relative norm, the replicas bit for bit after the parity step and after
    the timed steps, K1 and K2 once a step in each rank."""
    mode, backend = what.split()
    losses = [r["parity_metrics"]["loss"] for r in ranks]
    loss_err = abs(losses[0] - one["loss"]) / abs(one["loss"])
    update = torch.load(DP_DIR / f"{mode}_{backend}_update.pt")

    def rel_norm(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))

    errs = {n: rel_norm(u, one["update"][n]) for n, u in update.items()}
    worst = max(errs, key=errs.get)
    steps = DP_WARMUP + DP_TIMED
    launches = {f"rank{r['rank']}": dict(parity=r["parity_launches"], timed=r["timed_launches"])
                for r in ranks}
    log(f"dp {what} [{card}]: parity loss {losses} against one process {one['loss']!r} (rel {loss_err:.2e}, "
        f"limit {DP_LOSS_RTOL}); the {len(errs)} updates' relative norm of the difference, worst "
        f"{errs[worst]:.2e} at {worst} (limit {update_rtol}); skipped "
        f"{[r['parity_metrics']['skipped_nonfinite'] for r in ranks]}; launches {launches}; "
        f"peak memory a rank {[round(r['peak_gib'], 2) for r in ranks]} GiB")
    if not (loss_err <= DP_LOSS_RTOL and len(set(losses)) == 1):
        raise AssertionError(f"dp {what}: parity losses {losses} against {one['loss']}")
    bad = {n: e for n, e in errs.items() if not e <= update_rtol}
    if bad or set(errs) != set(one["update"]):
        raise AssertionError(f"dp {what}: updates beyond {update_rtol}: {bad}")
    for key in ("digest", "timed_digest"):
        if len({r[key] for r in ranks}) != 1:
            raise AssertionError(f"dp {what}: the replicas differ ({key})")
    for r in ranks:
        expect_launches(f"dp {what} rank {r['rank']} parity", r["parity_launches"], 1, 1)
        expect_launches(f"dp {what} rank {r['rank']} timed", r["timed_launches"], steps, steps)
        if not all(math.isfinite(x) for x in r["timed_losses"]):
            raise AssertionError(f"dp {what} rank {r['rank']}: non-finite loss")
    seconds = max(r["timed_s"] for r in ranks)
    if "allreduce_ms" in ranks[0]:
        log(f"dp {what} [{card}]: the gradients' all-reduce alone (one bucket of "
            f"{sum(u.numel() for u in update.values()) * 4 / 1e6:.1f} MB float32) "
            f"{[round(r['allreduce_ms'], 2) for r in ranks]} ms a rank, synced")
    return dict(loss_err=loss_err, update_err=errs[worst], launches=launches,
                images_per_sec=DP_WORLD * DP_TIMED_BATCH * DP_TIMED / seconds,
                ms_per_step=seconds / DP_TIMED * 1e3, peak_gib=[r["peak_gib"] for r in ranks])


def phase_dp_step(card: str) -> dict:
    """Data-parallel training of Faster R-CNN R50-FPN at full width through
    ``build_train_objects``, ``build_loss_fn`` and ``make_train_step`` in
    spawned ranks: two gloo ranks sharing this card (NCCL refuses two
    ranks on one device), against this process on the same 4 images in
    float32, then timed in bf16 beside this process's b8; with two cards or
    more, the same under NCCL on two cards and FSDP's step."""
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the one process on the whole parity batch, float32
    model, det_cfg, _, optimizer = build_train_objects(dp_config("float32"), "cuda", seed=SEED,
                                                       loader=Batches([None]))
    before = whole_params(model)
    metrics = make_train_step(build_loss_fn(model, det_cfg, rng_seed=SEED), optimizer)(
        dp_parity_batch("cuda"))
    one = dict(loss=float(metrics["loss"]),
               update={n: (p.detach() - before[n]).cpu() for n, p in model.named_parameters()
                       if p.requires_grad})
    del model, optimizer, before
    torch.cuda.empty_cache()

    runs = {"ddp gloo": check_dp_run("ddp gloo", run_ranks("gloo", "ddp", "cuda:0"), one, card)}
    two_cards = torch.cuda.device_count() >= 2
    if two_cards:
        runs["ddp nccl"] = check_dp_run("ddp nccl", run_ranks("nccl", "ddp"), one, card)
        runs["fsdp nccl"] = check_dp_run("fsdp nccl", run_ranks("nccl", "fsdp"), one, card)

    # this process alone at b8: the images of the two ranks' step
    model, det_cfg, _, optimizer = build_train_objects(dp_config("bfloat16"), "cuda", seed=SEED,
                                                       loader=Batches([None]))
    step = make_train_step(build_loss_fn(model, det_cfg, rng_seed=SEED), optimizer)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 320)
    batches = [train_batch(gen, DP_ONE_BATCH) for _ in range(DP_WARMUP + DP_TIMED)]
    for b in batches[:DP_WARMUP]:
        step(b)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for b in batches[DP_WARMUP:]:
        step(b)
    torch.cuda.synchronize()
    one_ips = DP_ONE_BATCH * DP_TIMED / (time.perf_counter() - t1)
    del model, optimizer, step, batches
    torch.cuda.empty_cache()

    gloo = runs["ddp gloo"]
    log(f"dp step [{card}]: two gloo ranks sharing one card, b{DP_TIMED_BATCH} a rank, bf16: "
        f"{gloo['images_per_sec']:.2f} images/s ({gloo['ms_per_step']:.1f} ms a step of "
        f"{DP_WORLD * DP_TIMED_BATCH} images), against one process at b{DP_ONE_BATCH}: "
        f"{one_ips:.2f} images/s; two ranks sharing one card, not scaling")
    if two_cards:
        for what in ("ddp nccl", "fsdp nccl"):
            r = runs[what]
            log(f"dp step [{card}]: {what} on two cards, b{DP_TIMED_BATCH} a rank, bf16: "
                f"{r['images_per_sec']:.2f} images/s ({r['ms_per_step']:.1f} ms a step), peak "
                f"memory a rank {[round(g, 2) for g in r['peak_gib']]} GiB")
    else:
        log(f"dp step [{card}]: NCCL and FSDP were not run on this machine: it has "
            f"{torch.cuda.device_count()} GPU (the CPU tests run FSDP under gloo)")
    log(f"dp step [{card}]: {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(DP_DIR, ignore_errors=True)
    launches = {f"dp_{what.replace(' ', '_')}_{rank}_{part}": n
                for what, r in runs.items() for rank, parts in r["launches"].items()
                for part, n in parts.items()}
    return dict(runs={k: {x: v[x] for x in ("loss_err", "update_err", "images_per_sec",
                                             "peak_gib")} for k, v in runs.items()},
                one_images_per_sec=one_ips, launches=launches)


def batch_position_gaps(card: str) -> dict:
    """How far Faster R-CNN's backbone levels for an image move when the
    image takes another place in its b8 batch (the batch reversed), in
    bf16 and in float32: the sharded evaluation's images sit elsewhere in
    their batches than in one process's."""
    gaps = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 330)
    images, _ = padded_images(gen, 8, (800, 1344))
    perm = torch.arange(7, -1, -1, device="cuda")
    for dtype in ("bfloat16", "float32"):
        model, _ = load_model(dtype, "cuda")
        with torch.inference_mode():
            x = images.to(model.dtype).contiguous()
            a, b = model.backbone(x), model.backbone(x[perm].contiguous())
            gaps[dtype] = [float((p.float() - q[perm].float()).abs().max()) for p, q in zip(a, b)]
        del model
    torch.cuda.empty_cache()
    log(f"batch position [{card}]: the backbone's C2-C5 for the same images in a reversed b8 "
        f"batch differ by at most {gaps['bfloat16']} in bf16 and {gaps['float32']} in float32")
    return gaps


def dump_gap(got: list, want: list) -> str:
    """How two COCO results dumps differ: records, images whose records
    differ, and over the images with as many records in each, the largest
    score and box differences and the records whose category differs."""
    def by_image(dump):
        out = collections.defaultdict(list)
        for r in dump:
            out[r["image_id"]].append(r)
        return out

    g, w = by_image(got), by_image(want)
    differ = [i for i in set(g) | set(w) if g.get(i) != w.get(i)]
    score = box = 0.0
    labels = uneven = 0
    for i in differ:
        a, b = g.get(i, []), w.get(i, [])
        if len(a) != len(b):
            uneven += 1
            continue
        for x, y in zip(a, b):
            score = max(score, abs(x["score"] - y["score"]))
            box = max(box, max(abs(p - q) for p, q in zip(x["bbox"], y["bbox"])))
            labels += x["category_id"] != y["category_id"]
    if not differ and len(got) == len(want):
        return f"the same ({len(got)} records)"
    return (f"{len(got)} against {len(want)} records; {len(differ)} images differ ({uneven} in "
            f"their count); largest score gap {score:.3e}, box gap {box:.3e} px, {labels} "
            f"categories differ")


def cli_rank(argv) -> int:
    """``python3 chip_smoke.py --cli-rank {train,test} LAUNCHES_JSON ARGS...``:
    one rank of a torchrun launch of ``tools.train`` or ``tools.test``,
    run in this process with K1's, K2's and the matcher's launches counted
    and written to LAUNCHES_JSON, so that ``phase_cli_dp`` reads each
    rank's."""
    tool, launches_out, args = argv[0], argv[1], argv[2:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if os.environ.get("CHIP_SMOKE_DETERMINISTIC") == "1":  # the mesh phases' ranks
        torch.use_deterministic_algorithms(True, warn_only=True)
    record = os.environ.get("CHIP_SMOKE_RECORD")  # the mesh phases' ranks: their batches kept
    if record and tool == "train":
        build = train_cli.build_train_objects

        def recorded(*a, **kw):
            model, det_cfg, loader, optimizer = build(*a, **kw)
            return model, det_cfg, Recording(loader, Path(record), int(os.environ["RANK"])), \
                optimizer

        train_cli.build_train_objects = recorded
    reset_launches()
    result = (train_cli if tool == "train" else test_cli).main(args)
    torch.cuda.synchronize()
    extra = ({"steps": result.optimizer.steps,
              "held_bytes": sum(local_tensor(p).numel() * p.element_size()
                                for p in result.model.parameters()),
              "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}
             if tool == "train" else {"metrics": result})
    Path(launches_out).write_text(json.dumps(dict(read_launches(), **extra)))
    return 0


def torchrun(ranks: int, command: str) -> subprocess.CompletedProcess:
    """``command`` (a shell line that may read ``$RANK``) as ``ranks``
    processes of a standalone torchrun launch."""
    env = dict(os.environ, OMP_NUM_THREADS="4", PYTHONPATH=str(ROOT))
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(ranks), "--no-python", "sh", "-c", command],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
    if run.returncode != 0:
        raise AssertionError(f"torchrun {command!r} failed:\n{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    return run


def start_shard_eval(cfg_path: Path, ckpt: Path, out: Path, extra: str = ""):
    """The torchrun launch of ``tools.test --shard-eval`` on two ranks, in
    the background."""
    me = f"{sys.executable} {ROOT / 'chip_smoke.py'} --cli-rank"
    return launch_ranks(f"{me} test {out}_r$RANK.json {cfg_path} {ckpt} --shard-eval "
                        f"--out {out}_shard.json --dist-backend gloo {extra}", deterministic=False)


def shard_eval(card: str, what: str, cfg_path: Path, ckpt: Path, out: Path,
               extra: str = "", run=None) -> dict:
    """``tools.test --shard-eval`` of ``ckpt`` on two ranks against this
    process's ``tools.test`` of it: every metric to 1e-12, K1 launched in
    the ranks at least as often as in the one process and K2 never.
    ``{shard: each rank's launches, same: whether the dumps are equal,
    gap: how they differ, one: the one process's metrics}``. This process's
    test runs while the ranks do (``run``: their launch, if started already)."""
    run = run or start_shard_eval(cfg_path, ckpt, out, extra)
    reset_launches()
    one = test_cli.main([str(cfg_path), str(ckpt), "--out", f"{out}_one.json", *extra.split()])
    torch.cuda.synchronize()
    one_launches = read_launches()
    finish_ranks(run, f"cli dp: {what} --shard-eval")
    shard_s = time.perf_counter() - run.started
    shard = [json.loads(Path(f"{out}_r{r}.json").read_text()) for r in range(DP_WORLD)]
    errs = {k: abs(shard[0]["metrics"][k] - v) for k, v in one.items()}
    dump_shard, dump_one = (json.loads(Path(f"{out}_{n}.json").read_text())
                            for n in ("shard", "one"))
    gap = dump_gap(dump_shard, dump_one)
    log(f"cli dp [{card}]: tools.test --shard-eval, {what}, on {DP_WORLD} ranks in "
        f"{shard_s:.1f} s, K1 launches a rank {[s['k1'] for s in shard]} (one process: "
        f"{one_launches}); metrics' largest difference from one process "
        f"{max(errs.values()):.1e} (limit 1e-12), mAP {one['mAP']:.6f}"
        + (f", segm mAP {one['segm_mAP']:.6f}" if "segm_mAP" in one else "")
        + f"; dump against one process's: {gap}")
    if set(errs) != set(shard[0]["metrics"]) or max(errs.values()) > 1e-12:
        raise AssertionError(f"cli dp: {what} --shard-eval metrics {shard[0]['metrics']} "
                             f"against {one}")
    if shard[0]["metrics"] != shard[1]["metrics"] or not dump_one:
        raise AssertionError(f"cli dp: {what}: the ranks' metrics differ, or the dump is empty")
    if sum(s["k1"] for s in shard) < one_launches["k1"] or any(s["k2"] for s in shard):
        raise AssertionError(f"cli dp: {what} test launches {shard} against one process's "
                             f"{one_launches}")
    same = dump_shard == dump_one
    if "--segm" in extra:  # the masks' RLE dumps too
        same = same and (Path(f"{out}_shard.segm.json").read_text()
                         == Path(f"{out}_one.segm.json").read_text())
    return dict(shard=shard, same=same, gap=gap, one=one)


def phase_cli_dp(card: str) -> dict:
    """``tools.train`` as two gloo ranks (torchrun; on one card they share it), one
    epoch of ``phase_cli``'s folder and config (each rank b8, so half the
    one process's steps), ``--dump-final``; only rank 0 writes its work
    directory, the replicas' parameters are equal bit for bit, K1 and K2
    launch once a step in each rank. Then ``tools.test --shard-eval`` on
    two ranks against this process's ``tools.test`` of the same
    checkpoint (``shard_eval``): of that checkpoint in float32, its dump
    the same; and of the golden SOLOv2's (``phase_golden_solov2``), whose
    scores lie well above 0, with ``--segm`` in bf16 and in float32, so
    that its 24 metrics to 1e-12 compare numbers that can differ. In bf16
    an image's place in its batch moves its C5 (``batch_position_gaps``),
    so a bf16 dump's gap is reported."""
    t0 = time.perf_counter()
    config = SMOKE_COCO / "faster_rcnn_r50_fpn_smoke.py"
    root = SMOKE_COCO / "dp"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    me = f"{sys.executable} {ROOT / 'chip_smoke.py'} --cli-rank"
    cards = min(torch.cuda.device_count(), DP_WORLD)  # the ranks' cards: cuda:LOCAL_RANK mod count
    torchrun(DP_WORLD, f"{me} train {root}/train_r$RANK.json {config} --epochs 1 "
                       f"--work-dir {root}/work_r$RANK --dump-final {root}/final "
                       f"--dist-backend gloo")
    train_s = time.perf_counter() - t0
    ranks = [json.loads((root / f"train_r{r}.json").read_text()) for r in range(DP_WORLD)]
    work0, work1 = root / "work_r0", root / "work_r1"
    wrote = sorted(p.name for p in work0.iterdir())
    if "epoch_1" not in wrote or "metrics.jsonl" not in wrote or (
            work1.exists() and any(work1.iterdir())):
        raise AssertionError(f"cli dp: rank 0 wrote {wrote}; rank 1 "
                             f"{sorted(p.name for p in work1.iterdir()) if work1.exists() else []}")
    records = [json.loads(line) for line in (work0 / "metrics.jsonl").read_text().splitlines()]
    finals = [np.load(root / f"final.rank{r}.npz") for r in range(DP_WORLD)]
    differ = [k for k in finals[0].files if not np.array_equal(finals[0][k], finals[1][k])]
    if differ or set(finals[0].files) != set(finals[1].files):
        raise AssertionError(f"cli dp: the replicas differ in {differ}")
    for r, n in enumerate(ranks):
        expect_launches(f"cli dp training rank {r}", {k: n[k] for k in ("k1", "k2", "matcher")},
                        n["steps"], n["steps"])
    log(f"cli dp [{card}]: tools.train as {DP_WORLD} gloo ranks on {cards} card(s), one epoch of "
        f"{ranks[0]['steps']} steps of b8 a rank in {train_s:.1f} s (torchrun and start-up "
        f"included); rank 0 wrote {wrote}, rank 1 nothing; images/s "
        f"{[round(r['images_per_sec'], 2) for r in records if 'images_per_sec' in r]} (both ranks' "
        f"images); {len(finals[0].files)} final parameters equal bit for bit; launches a rank "
        f"{ranks}")

    f32 = SMOKE_COCO / "faster_rcnn_r50_fpn_smoke_f32.py"
    f32.write_text(f"_base_ = {str(config)!r}\nruntime = dict(compute_dtype='float32')\n")
    tests = {"f32": shard_eval(card, "Faster R-CNN float32", f32, work0 / "epoch_1", root / "f32")}
    golden = {dtype: (GOLDEN_COCO / f"golden_solov2_{dtype}.py", GOLDEN_COCO / "ckpt",
                      root / f"golden_{dtype}", f"--segm --batch {GOLDEN_BATCH}")
              for dtype in ("bf16", "f32")}
    runs = {dtype: start_shard_eval(*args) for dtype, args in golden.items()}  # two at once
    for dtype, args in golden.items():
        tests[f"golden_{dtype}"] = shard_eval(card, f"golden SOLOv2 {dtype}", *args,
                                              run=runs[dtype])
        one = tests[f"golden_{dtype}"]["one"]
        if not (one["mAP_50"] > 0 and one["segm_mAP_50"] > 0):
            raise AssertionError(f"cli dp: the golden SOLOv2 scores {one}")
    # float32 keeps each image's detections whatever its batch-mates: the dumps must be equal.
    # bf16 does not (batch_position_gaps): near-tied scores may turn its ulps into other picks.
    for what in ("f32", "golden_f32"):
        if not tests[what]["same"]:
            raise AssertionError(f"cli dp: the {what} sharded dump differs from one process's")
    batch_position_gaps(card)
    return dict(training={f"rank{r}": {k: n[k] for k in ("k1", "k2", "matcher")}
                          for r, n in enumerate(ranks)},
                test={f"{what}_rank{r}": {k: s[k] for k in ("k1", "k2", "matcher")}
                      for what, t in tests.items() for r, s in enumerate(t["shard"])})


MESH_DIR = ROOT / "build" / "mesh"
MESH_LOSS_RTOL, MESH_UPDATE_RTOL = 1e-4, 1e-2  # as phase_dp_step's; written in PERF.md first
MESH_ACCUM, MESH_ACCUM_ROWS = 3, 3  # accum_steps and images a rank: micro-batch 1 spans the ranks
MESH_ROWS_BATCH, MESH_ROWS_CANVAS = 4, (800, 1344)


def coco_subset(src: Path, n: int, out: Path) -> Path:
    """The first ``n`` landscape images of the COCO file ``src`` and their
    annotations, written to ``out``: one aspect group, so the grouped
    samplers cut no partial batch."""
    data = json.loads(src.read_text())
    images = [im for im in data["images"] if im["width"] > im["height"]][:n]
    keep = {im["id"] for im in images}
    out.write_text(json.dumps(dict(data, images=images, annotations=[
        a for a in data["annotations"] if a["image_id"] in keep])))
    return out


def write_mesh_configs() -> dict:
    """The float32 smoke configs of the three mesh runs: ``accum``
    (``accum_steps=3``, 3 images a rank, 12 images: 2 steps on two ranks),
    ``tp`` (``mesh.model=2``, 2 images a step, 4 images, validation on 4
    val images) and its one-process twins: ``tp_one`` without the
    validation, ``tp_resume`` with it."""
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    base = SMOKE_COCO / "faster_rcnn_r50_fpn_smoke.py"
    train12 = coco_subset(SMOKE_COCO / "instances_train.json", 12, MESH_DIR / "train12.json")
    train4 = coco_subset(SMOKE_COCO / "instances_train.json", 4, MESH_DIR / "train4.json")
    paths = {}
    for name, text in (
            ("accum", f"data = dict(train=dict(ann_file={str(train12)!r}), "
                      f"sample_per_replica={MESH_ACCUM_ROWS})\n"
                      f"runtime = dict(compute_dtype='float32', accum_steps={MESH_ACCUM}, "
                      "checkpoint_interval_steps=1, checkpoint_interval_epochs=100)\n"),
            ("tp", f"data = dict(train=dict(ann_file={str(train4)!r}), sample_per_replica=2)\n"
                   "runtime = dict(compute_dtype='float32', mesh=dict(model=2), "
                   "val_interval_epochs=1, val_max_images=4, val_batch=2, "
                   "checkpoint_interval_steps=1, checkpoint_interval_epochs=100)\n"),
            ("tp_one", "runtime = dict(mesh=dict(model=1), val_interval_epochs=0)\n"),
            ("tp_resume", "runtime = dict(mesh=dict(model=1))\n")):
        parent = paths["tp"] if name.startswith("tp_") else base
        paths[name] = MESH_DIR / f"{name}.py"
        paths[name].write_text(f"_base_ = {str(parent)!r}\n{text}")
    return paths


def concat_batches(per_rank: list) -> list:
    """Each step's batches of the ranks, concatenated in rank order: the
    global batch."""
    out = []
    for parts in zip(*per_rank):
        out.append({k: (sum((p[k] for p in parts), []) if isinstance(parts[0][k], list)
                        else np.concatenate([p[k] for p in parts])) for k in parts[0]})
    return out


@contextlib.contextmanager
def deterministic():
    """Within: deterministic CUDA algorithms (a warning where an operator
    has none), as the mesh ranks run, so that a comparison with them reads
    the partitioning and not the atomics' summation order."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def launch_ranks(command: str, deterministic: bool = True) -> subprocess.Popen:
    """``command`` as ``DP_WORLD`` processes of a standalone torchrun launch,
    started in the background (``started``: when), with deterministic CUDA
    algorithms unless told otherwise."""
    env = dict(os.environ, OMP_NUM_THREADS="4", PYTHONPATH=str(ROOT))
    if deterministic:
        env.update(CUBLAS_WORKSPACE_CONFIG=":4096:8", CHIP_SMOKE_DETERMINISTIC="1")
    output = tempfile.TemporaryFile("w+")  # not a pipe: a full pipe would stall the ranks
    run = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(DP_WORLD), "--no-python", "sh", "-c", command],
        cwd=str(ROOT), env=env, stdout=output, stderr=subprocess.STDOUT, text=True)
    run.started, run.output = time.perf_counter(), output
    return run


def finish_ranks(run: subprocess.Popen, what: str) -> None:
    """Wait for ``launch_ranks``' launch ``run``; its output's end if it failed."""
    try:
        run.wait(timeout=max(DP_TIMEOUT_S - (time.perf_counter() - run.started), 1))
    finally:
        if run.poll() is None:
            run.kill()
            run.wait()
    with run.output:
        if run.returncode != 0:
            run.output.seek(0)
            raise AssertionError(f"{what}: torchrun failed:\n{run.output.read()[-6000:]}")


class Recording:
    """A rank's train loader that writes each batch of an epoch to
    ``where/b{k}.rank{rank}.pt`` before the first step takes one (each file
    written whole, then renamed), so that a reference in another process
    trains on the very batches the rank trained on."""

    def __init__(self, loader, where: Path, rank: int):
        self.loader, self.where, self.rank = loader, where, rank
        where.mkdir(parents=True, exist_ok=True)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __len__(self) -> int:
        return len(self.loader)

    def iter_batches(self, skip_batches: int = 0):
        batches = list(self.loader.iter_batches(skip_batches))
        for k, batch in enumerate(batches, start=skip_batches):
            path = self.where / f"b{k}.rank{self.rank}.pt"
            torch.save(batch, f"{path}.tmp")
            os.replace(f"{path}.tmp", path)
        return iter(batches)


@contextlib.contextmanager
def fed(batches: list):
    """Within: ``tools.train`` in this process trains on ``batches``
    instead of its loader's."""
    build = train_cli.build_train_objects
    train_cli.build_train_objects = lambda *a, **kw: build(*a, **dict(kw, loader=Batches(batches)))
    try:
        yield
    finally:
        train_cli.build_train_objects = build


def wait_files(paths: list, run: subprocess.Popen, what: str) -> None:
    """Wait until every one of ``paths`` exists, while ``launch_ranks``'
    launch ``run`` goes on; its output's end if it failed first."""
    while not all(p.exists() for p in paths):
        if run.poll() is not None:
            finish_ranks(run, what)
            if not all(p.exists() for p in paths):
                raise AssertionError(f"{what}: the ranks ended without writing {paths}")
        if time.perf_counter() - run.started > DP_TIMEOUT_S:
            raise AssertionError(f"{what}: no {paths} after {DP_TIMEOUT_S} s")
        time.sleep(0.5)


def recorded_batches(where: Path, steps: int, run: subprocess.Popen, what: str) -> list:
    """Each rank's ``steps`` batches, as its ``Recording`` wrote them."""
    paths = [[where / f"b{k}.rank{r}.pt" for k in range(steps)] for r in range(DP_WORLD)]
    wait_files([p for rank in paths for p in rank], run, what)
    return [[torch.load(p, weights_only=False) for p in rank] for rank in paths]


def leaves_gap(a, b, at: str = "batch") -> float:
    """The largest absolute difference between the arrays of two nested
    batches; raises where their structure, a shape or another leaf
    differs."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()):
            raise AssertionError(f"{at}: keys differ")
        return max((leaves_gap(a[k], b[k], f"{at}[{k!r}]") for k in a), default=0.0)
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            raise AssertionError(f"{at}: lengths differ")
        return max((leaves_gap(x, y, f"{at}[{i}]") for i, (x, y) in enumerate(zip(a, b))),
                   default=0.0)
    if isinstance(a, (np.ndarray, torch.Tensor)):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{at}: {a.shape} {a.dtype} against {b.shape} {b.dtype}")
        return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max(initial=0.0))
    if a != b:
        raise AssertionError(f"{at}: {a!r} against {b!r}")
    return 0.0


def update_gaps(got: dict, before: dict, after: dict) -> tuple:
    """Each trained parameter's update from ``before`` (``got`` the ranks'
    parameters, ``after`` one process's): the relative norm of the
    difference, each and all together."""
    gaps, sizes = {}, {}
    for n, a in after.items():
        want = (a - before[n]).double()
        delta = torch.as_tensor(got[n]).double() - before[n].double()
        gaps[n], sizes[n] = float((delta - want).norm()), float(want.norm())
    errs = {n: gaps[n] / max(sizes[n], 1e-300) for n in gaps}
    whole = (math.sqrt(sum(g * g for g in gaps.values()))
             / math.sqrt(sum(v * v for v in sizes.values())))
    return errs, whole


def check_mesh_step(what: str, losses: list, want_losses: list, got: dict, before: dict,
                    after: dict, card: str) -> dict:
    """The ranks against one process from the same state ``before``: each
    step's loss to ``MESH_LOSS_RTOL``, each trained parameter's update
    (``got`` the ranks', ``after`` the one process's) to
    ``MESH_UPDATE_RTOL`` in relative norm of the difference."""
    errs = [abs(g - w) / abs(w) for g, w in zip(losses, want_losses)]
    errs_t, whole = update_gaps(got, before, after)
    worst = max(errs_t, key=errs_t.get)
    log(f"{what} [{card}]: losses {losses} against one process {want_losses} (rel "
        f"{[f'{e:.2e}' for e in errs]}, limit {MESH_LOSS_RTOL}); the {len(errs_t)} trained "
        f"parameters' updates, worst relative norm of the difference {errs_t[worst]:.2e} at "
        f"{worst}, all together {whole:.2e} (limit {MESH_UPDATE_RTOL} each)")
    if len(losses) != len(want_losses) or not all(e <= MESH_LOSS_RTOL for e in errs):
        raise AssertionError(f"{what}: losses {losses} against {want_losses}")
    bad = {n: e for n, e in errs_t.items() if not e <= MESH_UPDATE_RTOL}
    if bad:
        raise AssertionError(f"{what}: updates beyond {MESH_UPDATE_RTOL}: {bad}")
    return dict(loss_err=max(errs), update_err=errs_t[worst], update_err_all=whole)


def replicas_equal(what: str, finals: list) -> None:
    differ = [k for k in finals[0].files if not np.array_equal(finals[0][k], finals[1][k])]
    if differ:
        raise AssertionError(f"{what}: the ranks' parameters differ: {differ}")


def train_losses(work: Path) -> list:
    return [r["loss"] for r in (json.loads(line) for line in
                                (work / "metrics.jsonl").read_text().splitlines()) if "loss" in r]


def trained(model) -> dict:
    return {n: full_tensor(p).detach().cpu().clone() for n, p in model.named_parameters()
            if p.requires_grad}


def start_mesh_ranks(what: str, configs: dict) -> subprocess.Popen:
    """The torchrun launch of ``tools.train`` for the mesh phase ``what``
    (``accum`` or ``tp``), its directory made anew, each rank's batches
    recorded under ``batches/``."""
    root = MESH_DIR / what
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    me = f"CHIP_SMOKE_RECORD={root / 'batches'} {sys.executable} {ROOT / 'chip_smoke.py'} --cli-rank"
    return launch_ranks(f"{me} train {root}/r$RANK.json {configs[what]} --epochs 1 "
                        f"--work-dir {root}/work --dump-final {root}/final --dist-backend gloo")


def accum_reference(cfg, batches: list, work: Path, resume: Path = None) -> tuple:
    """This process's ``accum_steps=3`` training on ``batches`` (each step's
    global batch) from the seed's weights, or from the checkpoint
    ``resume`` at its batch, writing a checkpoint a step into ``work``:
    the losses and the trained parameters after it."""
    model, det_cfg, loader, optimizer = build_train_objects(cfg, "cuda", seed=0,
                                                            loader=Batches(batches))
    skip = 0
    if resume is not None:
        skip = int(load_checkpoint(model, str(resume), strict=True,
                                   optimizer=optimizer).get("batches_done", 0))
    trainer = Trainer(build_loss_fn(model, det_cfg, rng_seed=0), model, optimizer, loader,
                      work_dir=str(work), log_interval=1, accum_steps=MESH_ACCUM,
                      checkpoint_interval_steps=1, checkpoint_interval_epochs=100)
    with deterministic():
        trainer.run(1, skip_batches=skip)
    losses = [r["loss"] for r in trainer.history if "loss" in r]
    after = trained(model)
    del model, optimizer, trainer
    torch.cuda.empty_cache()
    return losses, after


def phase_mesh_accum(card: str, configs: dict, run=None) -> dict:
    """``tools.train`` as two gloo ranks sharing the card, ``accum_steps=3``
    and 3 images a rank, 2 steps (micro-batch 1 spans the ranks: rank 0
    runs micro-batch 0 and the first row of 1, rank 1 the second row of 1
    and micro-batch 2), against this process taking the same steps on the
    batches the ranks took, concatenated, in float32, each step from the
    ranks' state before it (``check_mesh_step``): step 1 from the seed's
    weights, step 2 resumed from the ranks' ``step_1`` checkpoint. This
    process's own step 2, which starts from its step 1 and not the ranks',
    is logged beside them. The ranks' batches are the shards this process's
    loader cuts, their images' difference logged."""
    t0 = time.perf_counter()
    root = MESH_DIR / "accum"
    run = run or start_mesh_ranks("accum", configs)
    cfg = Config.fromfile(configs["accum"])
    own = [list(build_train_loader(cfg, dist=True, num_replicas=DP_WORLD, rank=r).iter_batches())
           for r in range(DP_WORLD)]
    got = recorded_batches(root / "batches", len(own[0]), run, "mesh accum")
    input_gap = max(leaves_gap(g, w, f"rank {r}") for r, (g, w) in enumerate(zip(got, own)))
    log(f"mesh accum [{card}]: the ranks' batches are this process's loader's shards, their "
        f"images {input_gap:.3e} apart at most")
    batches = concat_batches(got)
    finish_ranks(run, "mesh accum")
    free_b, total_b = torch.cuda.mem_get_info()
    log(f"mesh accum [{card}]: the card's memory free before the references "
        f"{free_b / 2**30:.2f} of {total_b / 2**30:.2f} GiB")
    model, _, _, _ = build_train_objects(cfg, "cuda", seed=0, loader=Batches([None]))
    before = trained(model)
    del model
    free_losses, free = accum_reference(cfg, batches, root / "one")
    losses2, after = accum_reference(cfg, batches, root / "two", resume=root / "work" / "step_1")
    ranks = [json.loads((root / f"r{r}.json").read_text()) for r in range(DP_WORLD)]
    finals = [np.load(root / f"final.rank{r}.npz") for r in range(DP_WORLD)]
    replicas_equal("mesh accum", finals)
    step1 = {who: {n: t for n, t in torch.load(root / who / "step_1" / "model.pt",
                                               map_location="cpu").items() if n in before}
             for who in ("work", "one")}
    losses = train_losses(root / "work")
    out1 = check_mesh_step("mesh accum step 1", losses[:1], free_losses[:1], step1["work"],
                           before, step1["one"], card)
    out2 = check_mesh_step("mesh accum step 2", losses[1:], losses2, finals[0], step1["work"],
                           after, card)
    free_loss = abs(losses[1] - free_losses[1]) / abs(free_losses[1])
    _, free_all = update_gaps(finals[0], before, free)
    log(f"mesh accum [{card}]: two free-running steps (not held), step 2's loss "
        f"{free_loss:.2e} apart, the two steps' updates all together {free_all:.2e}")
    parts = [len(micro_batch_parts(MESH_ACCUM, DP_WORLD, MESH_ACCUM_ROWS, r))
             for r in range(DP_WORLD)]
    for r, n in enumerate(ranks):
        steps = n["steps"]
        expect_launches(f"mesh accum rank {r}", {k: n[k] for k in ("k1", "k2", "matcher")},
                        steps * parts[r], steps * parts[r])
    seconds = time.perf_counter() - t0
    log(f"mesh accum [{card}]: {DP_WORLD} ranks, accum_steps={MESH_ACCUM}, "
        f"{MESH_ACCUM_ROWS} images a rank, parts a step {parts}; launches {ranks}; "
        f"{seconds:.1f} s")
    return dict(loss_err=max(out1["loss_err"], out2["loss_err"]),
                update_err=max(out1["update_err"], out2["update_err"]),
                step1=out1, step2=out2, free_loss_err=free_loss, free_update_err_all=free_all,
                input_gap=input_gap, seconds=seconds,
                launches={f"rank{r}": {k: n[k] for k in ("k1", "k2", "matcher")}
                          for r, n in enumerate(ranks)})


def phase_mesh_tp(card: str, configs: dict, run=None) -> dict:
    """``tools.train`` as two gloo ranks sharing the card with
    ``runtime.mesh.model=2`` (tensor parallelism, one data rank), 2 steps
    and the in-training validation, against this process's ``tools.train``
    at ``model=1`` on the batches the ranks took, in float32, each step
    from the ranks' state before it (``check_mesh_step``): step 1 from the
    seed's weights (``tp_one``, whose ``step_1`` checkpoint is compared),
    step 2 and the validation resumed from the ranks' ``step_1`` checkpoint
    (``tp_resume``). ``tp_one``'s own step 2, which starts from its step 1
    and not the ranks', is logged beside them. Each rank's parameter bytes
    against the reference's rule."""
    t0 = time.perf_counter()
    root = MESH_DIR / "tp"
    run = run or start_mesh_ranks("tp", configs)
    cfg = Config.fromfile(configs["tp_one"])
    model, _, _, _ = build_train_objects(cfg, "cuda", seed=0, loader=Batches([None]))
    before = trained(model)
    plan = tensor_parallel_plan(model, 2)
    predicted = sum(p.numel() // (2 if n in plan else 1) * p.element_size()
                    for n, p in model.named_parameters())
    whole = sum(p.numel() * p.element_size() for p in model.parameters())
    del model
    got = recorded_batches(root / "batches", 2, run, "mesh tp")
    if leaves_gap(got[0], got[1], "the model group's batches"):
        raise AssertionError("mesh tp: the model group's ranks took different images")
    with deterministic(), fed(got[0]):
        trainer = train_cli.main([str(configs["tp_one"]), "--epochs", "1", "--work-dir",
                                  str(root / "one")])
    free = trained(trainer.model)
    del trainer
    ranks_step1 = root / "work" / "step_1"
    wait_files([ranks_step1 / META_FILE], run, "mesh tp")
    with deterministic(), fed(got[0]):
        trainer = train_cli.main([str(configs["tp_resume"]), "--epochs", "1", "--work-dir",
                                  str(root / "two"), "--resume", str(ranks_step1)])
    after = trained(trainer.model)
    one_val = [r for r in trainer.history if "val_mAP" in r]
    del trainer
    torch.cuda.empty_cache()
    finish_ranks(run, "mesh tp")
    ranks = [json.loads((root / f"r{r}.json").read_text()) for r in range(DP_WORLD)]
    finals = [np.load(root / f"final.rank{r}.npz") for r in range(DP_WORLD)]
    replicas_equal("mesh tp", finals)
    step1 = {who: {n: t for n, t in torch.load(root / who / "step_1" / "model.pt",
                                               map_location="cpu").items() if n in before}
             for who in ("work", "one")}
    losses, one_losses = train_losses(root / "work"), train_losses(root / "one")
    out1 = check_mesh_step("mesh tp step 1", losses[:1], one_losses[:1], step1["work"], before,
                           step1["one"], card)
    out2 = check_mesh_step("mesh tp step 2", losses[1:], train_losses(root / "two"), finals[0],
                           step1["work"], after, card)
    free_loss = abs(losses[1] - one_losses[1]) / abs(one_losses[1])
    _, free_all = update_gaps(finals[0], before, free)
    log(f"mesh tp [{card}]: two free-running steps (not held: step 1's rounding moves step 2's "
        f"proposals), step 2's loss {free_loss:.2e} apart, the two steps' updates all together "
        f"{free_all:.2e}")
    records = [json.loads(line)
               for line in (root / "work" / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in records if "val_mAP" in r]
    val_gap = max(abs(val[0][k] - one_val[0][k]) for k in one_val[0] if k.startswith("val_"))
    held = [n["held_bytes"] for n in ranks]
    log(f"mesh tp [{card}]: {len(plan)} sharded parameters; each rank holds {held} bytes of "
        f"parameters against the rule's {predicted} ({whole} whole); validation mAP "
        f"{val[0]['val_mAP']!r} against one process's {one_val[0]['val_mAP']!r} (largest metric "
        f"gap {val_gap:.2e}); launches {ranks}")
    if held != [predicted] * DP_WORLD:
        raise AssertionError(f"mesh tp: ranks hold {held} bytes, the rule {predicted}")
    if val_gap > 1e-3:
        raise AssertionError(f"mesh tp: validation {val[0]} against {one_val[0]}")
    for r, n in enumerate(ranks):
        steps = n["steps"]
        if n["k2"] != steps or n["k1"] < steps + 1 or n["matcher"]:
            raise AssertionError(f"mesh tp rank {r}: launches {n} for {steps} steps and a "
                                 "validation")
    seconds = time.perf_counter() - t0
    log(f"mesh tp [{card}]: {seconds:.1f} s")
    return dict(loss_err=max(out1["loss_err"], out2["loss_err"]),
                update_err=max(out1["update_err"], out2["update_err"]),
                step1=out1, step2=out2, free_loss_err=free_loss, free_update_err_all=free_all,
                seconds=seconds, held=held, predicted=predicted, whole=whole,
                launches={f"rank{r}": {k: n[k] for k in ("k1", "k2", "matcher")}
                          for r, n in enumerate(ranks)})


def rows_batch(device) -> dict:
    gen = torch.Generator(device=device).manual_seed(SEED + 340)
    return train_batch(gen, MESH_ROWS_BATCH, MESH_ROWS_CANVAS)


def rows_step(model, det_cfg, optimizer, batch) -> tuple:
    """One step: its loss, the trained parameters' update, the C2 rows the
    backbone gave, the peak memory in GiB."""
    seen = []
    hook = model.backbone.register_forward_hook(lambda m, i, o: seen.append(o[0].shape[1]))
    before = trained(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    metrics = make_train_step(build_loss_fn(model, det_cfg, rng_seed=SEED), optimizer)(batch)
    torch.cuda.synchronize()
    launches = read_launches()
    hook.remove()
    after = trained(model)
    return (float(metrics["loss"]), {n: after[n] - before[n] for n in after}, seen[0],
            torch.cuda.max_memory_allocated() / 2**30, launches)


def rows_rank(rank: int, world: int, port: int) -> None:
    """One rank of ``phase_mesh_rows``, a spawned process: a (1, 2) mesh,
    the float32 Faster R-CNN's step on its band of the batch's rows."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      CUBLAS_WORKSPACE_CONFIG=":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    info = init_distributed("gloo", "cuda:0", timeout_s=DP_TIMEOUT_S)
    model, det_cfg, _, optimizer = build_train_objects(dp_config("float32"), info["device"],
                                                       seed=SEED, loader=Batches([None]))
    mesh = make_mesh(data=1, model=world)
    batch = shard_batch(mesh, rows_batch(info["device"]), spatial=True)
    loss, update, c2, peak, launches = rows_step(model, det_cfg, optimizer, batch)
    if rank == 0:
        torch.save({n: u.cpu() for n, u in update.items()}, MESH_DIR / "rows_update.pt")
    torch.save(dict(loss=loss, c2=c2, peak=peak, launches=launches,
                    image_rows=batch["image"].shape[1],
                    digest=param_digest(whole_params(model))), MESH_DIR / f"rows_r{rank}.pt")
    shutdown_distributed(info)


def start_rows_ranks():
    for f in MESH_DIR.glob("rows_*"):
        f.unlink()
    return torch.multiprocessing.start_processes(rows_rank, args=(DP_WORLD, free_port()),
                                                 nprocs=DP_WORLD, join=False, start_method="spawn")


def phase_mesh_rows(card: str, ctx=None) -> dict:
    """Image rows over two gloo ranks sharing the card (``model=2``,
    ``shard_batch(spatial=True)``): one training step of the float32 Faster
    R-CNN on 4 images of 800 x 1344, each rank its band of 400 rows (C5's
    25 rows 12 and 13, P6's 13 rows 6 and 7), against this process's step
    on the whole images; each rank's C2 rows and peak memory beside the
    one process's."""
    t0 = time.perf_counter()
    ctx = ctx or start_rows_ranks()
    try:
        model, det_cfg, _, optimizer = build_train_objects(dp_config("float32"), "cuda",
                                                           seed=SEED, loader=Batches([None]))
        with deterministic():
            loss, update, c2, peak, launches = rows_step(model, det_cfg, optimizer,
                                                         rows_batch("cuda"))
        del model, optimizer
        torch.cuda.empty_cache()
        deadline = time.perf_counter() + DP_TIMEOUT_S
        while not ctx.join(timeout=1):
            if time.perf_counter() > deadline:
                raise AssertionError("mesh rows: the ranks did not finish")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(MESH_DIR / f"rows_r{r}.pt") for r in range(DP_WORLD)]
    got = torch.load(MESH_DIR / "rows_update.pt")
    errs = {n: float((got[n].double() - u.cpu().double()).norm()
                     / u.cpu().double().norm().clamp_min(1e-300)) for n, u in update.items()}
    worst = max(errs, key=errs.get)
    loss_err = max(abs(r["loss"] - loss) / abs(loss) for r in ranks)
    log(f"mesh rows [{card}]: losses {[r['loss'] for r in ranks]} against one process {loss!r} "
        f"(rel {loss_err:.2e}, limit {MESH_LOSS_RTOL}); updates' worst relative norm "
        f"{errs[worst]:.2e} at {worst} (limit {MESH_UPDATE_RTOL}); image rows a rank "
        f"{[r['image_rows'] for r in ranks]}, C2 rows a rank {[r['c2'] for r in ranks]} against "
        f"{c2}; peak memory a rank {[round(r['peak'], 3) for r in ranks]} GiB against "
        f"{peak:.3f}; launches {[r['launches'] for r in ranks]} (one process {launches})")
    if not loss_err <= MESH_LOSS_RTOL or errs[worst] > MESH_UPDATE_RTOL:
        raise AssertionError(f"mesh rows: loss {loss_err}, updates {errs[worst]} at {worst}")
    if len({r["digest"] for r in ranks}) != 1 or [r["c2"] for r in ranks] != [c2 // 2] * 2:
        raise AssertionError(f"mesh rows: replicas or C2 bands {[r['c2'] for r in ranks]}")
    for r, n in enumerate(ranks):
        expect_launches(f"mesh rows rank {r}", n["launches"], 1, 1)
    seconds = time.perf_counter() - t0
    log(f"mesh rows [{card}]: {seconds:.1f} s")
    return dict(loss_err=loss_err, update_err=errs[worst], seconds=seconds,
                c2=[r["c2"] for r in ranks], one_c2=c2, peak=[r["peak"] for r in ranks],
                one_peak=peak, launches={f"rank{r}": n["launches"] for r, n in enumerate(ranks)})


def phase_mesh(card: str) -> dict:
    """The mesh's three phases, (a), (b) and (c): accumulation over ranks that do
    not divide it, tensor parallelism and row partitioning, each its K1 and
    K2 launches and seconds (their ranks overlap, so a phase's seconds
    include its wait for the card and the host beside the others')."""
    t0 = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    configs = write_mesh_configs()
    # the three phases' ranks start together: their start-up (imports, the model's build, the
    # first CUDA calls) overlaps, and this process's references run meanwhile
    runs = {what: start_mesh_ranks(what, configs) for what in ("accum", "tp")}
    rows = start_rows_ranks()
    # (a)'s references last, when the other launches have given the card's memory back
    out = dict(tp=phase_mesh_tp(card, configs, runs["tp"]), rows=phase_mesh_rows(card, rows),
               accum=phase_mesh_accum(card, configs, runs["accum"]))
    log(f"mesh [{card}]: the three phases {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    started = time.perf_counter()
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
    phase_jpeg(card)

    fwd = phase_roi_align(ROIS)[torch.bfloat16]
    fwd_train = phase_roi_align(TRAIN_ROIS)[torch.bfloat16]
    phase_roi_align_variants()
    bwd = phase_roi_align_bwd()[torch.bfloat16]
    phase_roi_align_bwd_variants()
    phase_roi_align_edges()
    matcher_edges = phase_hungarian()
    serve = phase_model(card)
    phase_reference()
    train = phase_train(card)
    phase_train_bwd_on_step_data(train["model"], train["det_cfg"], train["batch"])
    del train["model"]
    phase_train_reference()
    mask_serve = phase_mask_serving(card)
    phase_mask_reference()
    mask_train = phase_mask_train(card)
    mask_step = phase_mask_step_data(mask_train.pop("model"), mask_train["det_cfg"],
                                     mask_train["batch"])
    del mask_train["det_cfg"], mask_train["batch"]
    retina_serve = phase_retina_serving(card)
    phase_retina_stem(card)
    phase_retina_reference()
    retina_train = phase_retina_train(card)
    phase_retina_train_reference()
    cascade_serve = phase_rcnn_serving(card, "cascade serving", CASCADE_CONFIG, False, 3, SEED + 36,
                                       check_box_detections, rcnn_stage_breakdown)
    cascade_mask_serve = phase_rcnn_serving(card, "cascade mask serving", CASCADE_MASK_CONFIG, True,
                                            4, SEED + 37, check_mask_detections,
                                            functools.partial(rcnn_stage_breakdown, segm=True))
    fast_serve = phase_rcnn_serving(card, "fast serving", FAST_CONFIG, False, 1, SEED + 38,
                                    check_box_detections, rcnn_stage_breakdown)
    phase_cascade_reference()
    phase_cascade_train_reference()
    phase_fast_reference()
    cascade_train = phase_rcnn_train(card, "cascade training", CASCADE_CONFIG, train_batch, 3,
                                     SEED + 39)
    cascade_k2 = phase_cascade_stage3(cascade_train.pop("model"), cascade_train.pop("det_cfg"),
                                      cascade_train.pop("batch"), mask=False)
    cascade_mask_train = phase_rcnn_train(card, "cascade mask training", CASCADE_MASK_CONFIG,
                                          mask_train_batch, 6, SEED + 40)
    cascade_mask_k2 = phase_cascade_stage3(cascade_mask_train.pop("model"),
                                           cascade_mask_train.pop("det_cfg"),
                                           cascade_mask_train.pop("batch"), mask=True)
    fast_train = phase_rcnn_train(card, "fast training", FAST_CONFIG, fast_train_batch, 1,
                                  SEED + 41)
    del fast_train["model"], fast_train["det_cfg"], fast_train["batch"]
    sparse_serve = phase_rcnn_serving(card, "sparse serving", SPARSE_CONFIG, False, 6, SEED + 48,
                                      check_sparse_detections, sparse_serving_breakdown)
    phase_sparse_reference()
    sparse_train = phase_sparse_train(card)
    sparse_step = phase_sparse_step_data(sparse_train.pop("model"), sparse_train.pop("det_cfg"),
                                         sparse_train.pop("batch"))
    detr_serve = phase_detr_serving(card)
    phase_detr_reference()
    detr_train = phase_detr_train(card)
    detr_step = phase_detr_step_data(detr_train.pop("model"), detr_train.pop("det_cfg"),
                                     detr_train.pop("batch"))
    dense_serve = {name: phase_dense_serving(card, name, config, SEED + 130 + i)
                   for i, (name, config) in enumerate(DENSE)}
    phase_dense_reference()
    dense_train = {name: phase_dense_train(card, name, config, SEED + 140 + i)
                   for i, (name, config) in enumerate(DENSE)}
    single_serve = {name: phase_single_serving(card, name, config, SEED + 170 + i)
                    for i, (name, config) in enumerate(SINGLE)}
    phase_single_reference()
    single_train = {name: phase_single_train(card, name, config, SEED + 180 + i)
                    for i, (name, config) in enumerate(SINGLE)}
    solov2_serve = phase_solov2_serving(card)
    phase_solov2_reference()
    solov2_train = phase_solov2_train(card)
    soft_nms = phase_soft_nms(card)
    zoo_serve = {name: phase_zoo_serving(card, name, config, SEED + 200 + i)
                 for i, (name, config) in enumerate(ZOO)}
    phase_zoo_reference()
    zoo_train = {name: phase_zoo_train(card, name, config, SEED + 210 + i)
                 for i, (name, config) in enumerate(ZOO)}
    cli = phase_cli(card, train)
    cli_profile = phase_cli_profile(card)
    cli_mask = phase_cli_mask(card)
    cli_options = phase_cli_options(card)
    cli_formats = phase_cli_config_formats(card)
    cli_tta = phase_cli_tta(card)
    cli_voc = phase_cli_voc(card)
    cli_fast = phase_cli_fast(card, SMOKE_COCO / "work" / f"epoch_{CLI_EPOCHS}")
    cli_ssd = phase_cli_ssd(card)
    cli_yolox = phase_cli_yolox(card)
    cli_solov2 = phase_cli_solov2(card)
    cli_zoo = phase_cli_zoo(card)
    export = phase_export(card)
    # this process is idle while the golden pool trains; the mesh's six ranks come after the
    # pool, which leaves too little of the card's memory to start them beside it
    golden_all = phase_golden(card, alongside=functools.partial(phase_golden_solov2, card))
    golden = golden_all["alongside"]
    torch.cuda.empty_cache()
    mesh = phase_mesh(card)
    dp_step = phase_dp_step(card)
    cli_dp = phase_cli_dp(card)
    if golden_all["under"]:  # phases 50's and 52's verdict, after the phases that read its SOLOv2
        raise AssertionError("golden families: " + "; ".join(golden_all["under"]))

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

    mask_paths = {"mask_serving": mask_serve["launches"], "mask_training": mask_train["launches"]}
    retina_paths = {"retina_serving": retina_serve["launches"],
                    "retina_training": retina_train["launches"]}
    slice6_paths = {"cascade_serving": cascade_serve["launches"],
                    "cascade_training": cascade_train["launches"],
                    "cascade_mask_serving": cascade_mask_serve["launches"],
                    "cascade_mask_training": cascade_mask_train["launches"],
                    "fast_serving": fast_serve["launches"],
                    "fast_training": fast_train["launches"]}
    slice7_paths = {"sparse_serving": sparse_serve["launches"],
                    "sparse_training": sparse_train["launches"]}
    slice8_paths = {"detr_serving": detr_serve["launches"],
                    "detr_training": detr_train["launches"]}
    cli_paths = {"cli_training": cli["training"], "cli_test": cli["test"],
                 "cli_mask_training": cli_mask["training"], "cli_mask_test": cli_mask["test"],
                 "cli_voc_training": cli_voc["training"], "cli_voc_test": cli_voc["test"],
                 "cli_fast_dump": cli_fast["dump"], "cli_fast_training": cli_fast["training"],
                 "cli_fast_test": cli_fast["test"], "cli_tta_test": cli_tta["test"],
                 "cli_ssd_training": cli_ssd["training"], "cli_ssd_test": cli_ssd["test"],
                 "cli_yolox_training": cli_yolox["training"], "cli_yolox_test": cli_yolox["test"]}
    slice20_paths = {f"cli_options_{what}": cli_options[what]
                     for what in ("training", "test", "visualize", "visualize_segm")}
    log(f"the training options' and the visualiser's launches of K1, K2 and the matcher: "
        f"{slice20_paths}")
    dense_paths = {f"{name}_{mode}": runs[name]["launches"] for name, _ in DENSE
                   for mode, runs in (("serving", dense_serve), ("training", dense_train))}
    single_paths = {f"{name}_{mode}": runs[name]["launches"] for name, _ in SINGLE
                    for mode, runs in (("serving", single_serve), ("training", single_train))}
    slice15_paths = {"solov2_serving": solov2_serve["launches"],
                     "solov2_training": solov2_train["launches"],
                     "retina_soft_nms_serving": soft_nms["launches"],
                     "cli_solov2_training": cli_solov2["training"],
                     "cli_solov2_test": cli_solov2["test"],
                     "cli_solov2_test_seeded": cli_solov2["seeded"]["test"],
                     "golden_solov2_training": golden["launches"]}
    slice16_paths = {**{f"{name}_{mode}": runs[name]["launches"] for name, _ in ZOO
                        for mode, runs in (("serving", zoo_serve), ("training", zoo_train))},
                     "cli_zoo_training": cli_zoo["training"], "cli_zoo_test": cli_zoo["test"]}
    log(f"the backbone zoo and PAFPN paths' launches of K1, K2 and the matcher: {slice16_paths}")
    slice18_paths = {**export["paths"], "cli_profile_training": cli_profile["training"]}
    log(f"the export and profile paths' launches of K1, K2 and the matcher: {slice18_paths}")
    slice19_paths = {**dp_step["launches"],
                     **{f"cli_dp_{what}_{rank}": n for what in ("training", "test")
                        for rank, n in cli_dp[what].items()}}
    log(f"the data-parallel paths' launches of K1, K2 and the matcher, each rank's: {slice19_paths}")
    slice21_paths = {**{f"golden_{name}_{path}": golden_all["paths"][f"golden_{name}_{path}"]
                        for name in golden_cases.GOLDEN_ROI
                        for path in ("training", "evaluation")},
                     **{f"cli_formats_{k}": v for k, v in cli_formats.items() if k != "yaml"}}
    log(f"the golden RoI families' and the config formats' launches of K1, K2 and the matcher: "
        f"{slice21_paths}")
    slice22_paths = {f"golden_{name}_{path}": golden_all["paths"][f"golden_{name}_{path}"]
                     for name in golden_cases.GOLDEN_DENSE for path in ("training", "evaluation")}
    log(f"the golden dense and set families' launches of K1, K2 and the matcher: {slice22_paths}")
    mesh_paths = {f"mesh_{what}_{rank}": n for what in ("accum", "tp", "rows")
                     for rank, n in mesh[what]["launches"].items()}
    log(f"the mesh paths' launches of K1, K2 and the matcher, each rank's: {mesh_paths}")
    later_paths = {**mask_paths, **retina_paths, **slice6_paths, **slice7_paths, **slice8_paths,
                   **dense_paths, **single_paths, **cli_paths, **slice15_paths, **slice16_paths,
                   **slice18_paths, **slice19_paths, **slice20_paths, **slice21_paths,
                   **slice22_paths, **mesh_paths}
    line = {"kernels": [
        entry("roi_align_fwd", "torch_detection_tpu/ops/roi_align_pallas.py:65",
              {"serving": serve["launches"], "training": train["k1"],
               **{path: n["k1"] for path, n in later_paths.items()}}, fwd,
              at_train_rois={k: fwd_train[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")},
              at_mask_serving=mask_serve["k1"], at_mask_training=mask_step["k1"],
              at_sparse_serving_stage0=sparse_serve["k1_stage0"],
              at_sparse_serving_stage5=sparse_serve["k1_stage5"],
              at_sparse_training_stage0=sparse_step["k1_stage0"],
              at_sparse_training_stage5=sparse_step["k1_stage5"], at_cli_training=cli["k1"],
              at_cli_test=cli["k1_test"], at_cli_mask_training=cli_mask["k1"],
              at_cli_mask_test=cli_mask["k1_test"], at_cli_fast_training=cli_fast["k1"],
              at_cli_fast_test=cli_fast["k1_test"], at_cli_tta_test=cli_tta["k1_test"]),
        entry("roi_align_bwd", "torch_detection_tpu/ops/roi_align_pallas.py:301",
              {"serving": serve["bwd_launches"], "training": train["k2"],
               **{path: n["k2"] for path, n in later_paths.items()}}, bwd,
              at_mask_training=mask_step["k2"], at_mask_positives_only=mask_step["k2_hot"],
              at_cascade_stage3=cascade_k2, at_cascade_mask_stage3=cascade_mask_k2,
              at_sparse_stage0=sparse_step["k2_stage0"], at_sparse_stage5=sparse_step["k2_stage5"],
              at_cli_training=cli["k2"], at_cli_mask_training=cli_mask["k2"],
              at_cli_fast_training=cli_fast["k2"]),
        entry("hungarian", "torch_detection_tpu/ops/hungarian.py:38",
              {"serving": serve["matcher"], "training": train["matcher"],
               **{path: n["matcher"] for path, n in later_paths.items()}}, sparse_step["matcher"],
              note="replaces a lax.while_loop (the reference's on-device matcher), not a Pallas "
                   "kernel", at_edge_sets=matcher_edges, at_detr_training=detr_step),
    ]}
    log("each phase's wall seconds: " + json.dumps(
        {k: round(v, 1) for k, v in sorted(PHASE_SECONDS.items(), key=lambda kv: -kv[1])}))
    log(f"chip_smoke wall time {time.perf_counter() - started:.1f} s (the kernels' build included)")
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


PHASE_SECONDS: dict = {}  # each phase's wall seconds in this run, summed over its calls


def _timed(phase):
    @functools.wraps(phase)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return phase(*args, **kwargs)
        finally:
            PHASE_SECONDS[phase.__name__] = (PHASE_SECONDS.get(phase.__name__, 0.0)
                                             + time.perf_counter() - t0)
    return run


for _name, _phase in list(globals().items()):
    if _name.startswith("phase_") and callable(_phase):
        globals()[_name] = _timed(_phase)


if __name__ == "__main__":
    sys.exit(cli_rank(sys.argv[2:]) if sys.argv[1:2] == ["--cli-rank"] else main())
