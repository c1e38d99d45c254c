#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (or one per kernel):

0. device: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions; exits 1 without a CUDA device (it never falls back to the CPU);
1. build: ``nvcc`` over ``pets_face_recognition_tpu_torch/csrc``, one process a
   source, all started together, then one link;
2. kernel: K1 warp (B = 8 and 32), K2 NMS and K3 RoIAlign at the serving
   path's shapes (B = 8); then K2 at the training budget (80 groups of 2000
   boxes), the two K5 entry points over the same kernels, and K3 and K4
   (RoIAlign forward and backward) at the training step's shapes (16 images
   of 640 x 640, 8192 box RoIs at 7 x 7 and 2048 keypoint RoIs at 14 x 14).
   Each is held against its plain PyTorch version on the card and timed with
   CUDA events (median after warm-up) beside the plain version, the one
   library call that computes the same function where there is one, and its
   bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32), and (but K4's
   pre-pass) with its kernels' device time per call from ``torch.profiler``
   (for K2 and K5 the sum of K2's two kernels; null where the profiler lost
   their launches, as it now and then does: the reading gates nothing), K1
   also beside the library's whole route from the maps (inverse, grid, ``grid_sample``,
   permutes), and against ``grid_sample`` alone in paired rounds (the two
   timed one after the other, in alternating order); K1's bfloat16 and int8
   modes likewise at B = 8 and 32, each bit for bit equal to its plain
   version, then on stress maps (rotations of 90 and 180 degrees, scales 0.25
   and 4, a denominator changing sign, a NaN map, a crop off the image, C =
   1, 2, 4, a 223 x 97 crop, a bfloat16 output, unaligned rows and base, a
   shrunk int8 box) that together take each branch of the int8 instance's
   tiles (staged boxes, pixels that miss the box, tiles that stage
   nothing). K4 must give the same bits in two launches on the same inputs,
   and its pre-pass the same
   integers as its plain twin; last, K2 and K3 at edge shapes (ragged and
   long groups, narrow channels, a non-square output, 2 levels, sampling
   ratios 1 and 3) against their plain versions;
3. e2e: ``build_serving_models`` at full ResNet-50 width with seeded random
   weights, ``EmbeddingService.embed_batch`` (``warp_dtype=torch.float32``,
   as every phase that holds the card to the CPU in float32) on seeded uint8
   320x320 images at B = 8 with the launch counts read around it, checks
   against the same models on the CPU on a B = 2 input, then crops/s at
   B = 32; bf16_serve: the same cell at the JAX package's accelerator
   defaults (both models at ``dtype=bfloat16``, K1 in its bfloat16 mode, the
   service's default): K1-bf16 1, K2 1 and K3-bf16 2 launches a batch, the
   card against the CPU on the same bfloat16 models within twice bfloat16's
   own move from float32 (decisions forced where random weights put them at
   near-ties, and counted), one batch with K1 in int8 and one ``Preproc3``
   batch under ``PFR_INPUT_DTYPE=bfloat16``, each gated on its launches and
   its crops; embedding drift, landmarks moved and crops/s in paired rounds
   against the float32 service on the same weights, and peak memory (no
   speed is gated);
4. tsv: the head-only retrieval chain of ``generate_tsv`` over the committed
   kashtanka corpus (``pets_face_recognition_tpu_torch/testdata``, 32 JPEGs
   of 320 x 320) and over 16 camera-sized JPEGs (1280 x 960, 960 x 1280,
   4032 x 3024) that the script writes with PIL from a seed under the
   git-ignored ``smoke_out/photos``: first the native decode's route (libjpeg
   or nvJPEG, by what is installed), what the machine has (g++, libjpeg,
   nvJPEG, PIL, cv2, pandas) and the native decode's pixel difference from
   PIL's libjpeg; then, on each set, the chain at full width with seeded
   random weights and the detection threshold 0 (decode, letterbox, detect,
   K1 on each kept photo at its own shape, the dog or cat embedder, centroid
   scores, top 100, a tsv under ``smoke_out/tsv``) on the card, with the
   launch counts read around it (K1 once per kept photo, K2 and K3
   launched), images/s and each step's ms a photo by photo size, timed inside
   the chain's own pass; and the same chain on the CPU from the same weights:
   the same kept photos and rounded landmarks, crops within 1e-3 on [0, 1],
   embeddings within 1e-5 relative, scores within 1e-6 and rank flips only
   across gaps below that, finite values, at least one scored query. Two
   planted faults on the camera photos (the dog and cat embedders swapped, the
   map moved one pixel) must each break that agreement. K1 at B = 1 on a 12
   MP and a portrait photo is held against its plain version and timed;
   jpeg_stream: crops/s from JPEG files, ``EmbeddingService.stream`` at B = 32
   over 1024 corpus paths and over the camera photos of each size, decoding
   overlapped, through the native route and through PIL (the port's fallback,
   as a measurement), and one photo's decode by each; retrieval:
   ``calc_scores`` ms for 1000 query cards against 10000 gallery cards of
   1-4 images;
5. train: keypoint R-CNN ResNet-50-FPN training steps at full width with the
   training defaults (RPN 2000/2000, 512 box samples at 0.25, keypoint head on
   128 positives an image) and the keypoint config's SGD (lr 5e-3, momentum
   0.9, weight decay 1e-4), on a seeded synthetic batch of 16 images of
   640 x 640 with 4 boxes each: 1 warm-up and 3 timed steps, with the launch
   counts read around them (K2, K3 and K4 must have run), the loss dict of
   every step (finite), step ms, images/s and peak memory; then two steps
   from one saved state on the same batch and noise, with the count of
   parameter gradients that differ bitwise (reported, not held), by default,
   with deterministic cuDNN (the arm that tells cuDNN's share apart: the
   port's step code has no nondeterministic index op), with deterministic
   cuDNN picking its fastest deterministic algorithms (``cudnn.benchmark``)
   and with ``torch.use_deterministic_algorithms`` (every warning's text
   kept), and each arm's step time against the default in 3 rounds of
   rotating order (ROADMAP fault 2; ``mask_train_repro`` does the same for
   the Mask R-CNN step);
6. train_vs_cpu: one step of the same model at 256 x 256, B = 2, reduced
   sampler budgets, from the same weights and sampler noise on the card and on
   the CPU: losses within 1e-3 relative, every gradient within 5e-3 relative
   in norm.

The MobileNetV3-Large keypoint R-CNN (the JAX package's default serving
detector: p4, p5 and a max-pool p6, 15 anchors a location) has phases of its
own: mobile_kernel, K3 (7 x 7, 14 x 14), K4 and K4's pre-pass on p4 and p5
(strides 16 and 32, ``min_level`` 4) at the training step's RoI counts, each
against its plain version (K4 also bit-identical across two launches);
mobile_e2e, serving as in phase 3 with ``detector_kind="mobile"``, timed at
B = 32 and at B = 128 (the JAX ``bench.py`` default), with peak memory;
mobile_tsv, the chain with ``PFR_KEYPOINT_ARCH=mobile`` over the committed
corpus on the card and on the CPU under ``tsv``'s gates; mobile_train, the
keypoint config's ``arch="mobile"`` steps (live BatchNorm, momentum 0.9) as
in phase 5, whose running statistics must move in every step; and
mobile_train_vs_cpu, a reduced live-BN step on the card and on the CPU:
losses within 1e-3, running statistics within 1e-4, and gradients within
5e-3 relative in norm or within twice the card's own spread when its input
is rounded differently (the step is ill-conditioned in float32).

Last, keypoint_fit: the port's training path from data. The keypoint
config (``build_keypoint_config``, production width, B = 16 at 640 x 640,
8 loader threads) over the committed CAT miniature
(``pets_face_recognition_tpu_torch/testdata/CAT_DATASET``, 40 photos: 2
steps an epoch and 1 validation batch of 8), written as a config file and
run as ``main()`` runs one: ``configure_trainer(config, logger).fit(
KeyPointsController(config=config))`` for 2 epochs, with the launch counts
read around it (K2, K3, K4 and the pre-pass must have run) and finite
losses; the loader alone in images/s; checkpoints ``epoch=0-step=2`` and
``epoch=1-step=4``, one save and one load timed, the loaded state bit-equal
to the trained one (parameters, buffers, momentum, step, epoch); a new
trainer with 3 epochs resumes at epoch 2 and step 4; ``eval_landmark``'s
``evaluate`` on the last checkpoint with the counts read around it (K2 and
K3 launched, K4 not), and the same checkpoint's detections and metrics on
the card against the CPU over the validation batch (scores within 1e-3,
boxes within 1e-3 of the image side, metrics within 1e-3, relative for the
pixel errors). The fit is not bit-reproducible, so its checkpoint differs
from run to run, and now and then a rounding-size difference moves a
discrete step: a proposal that top-k or NMS keeps, or the one-detection
pick. So the comparison also runs with the CPU held to the card's decisions
(``fit_eval_vs_cpu``): the RPN's outputs within 1e-3 of their largest
magnitude, the card's proposals kept again by the CPU from the card's RPN
outputs, and the forced detections within the same gates. The end-to-end
gates are waived only when a move is counted. The mobile arch for 1 epoch
(``keypoint_fit_mobile``); and ``python -m pets_face_recognition_tpu_torch.main_keypoints --config
pets_face_recognition_tpu_torch/configs/keypoint_smoke.py`` in a subprocess,
which must exit 0. Step ms (the first apart), each epoch's ``data_time_s``
and ``step_time_s``, eval ms a batch, the validation metrics, checkpoint
bytes and peak memory are printed. Everything the phase writes is under the
git-ignored ``smoke_out/fit`` and deleted after it.

Then the feature extractor's path, under the git-ignored ``smoke_out/fe``
(deleted after it). fe_transform: seeded ``data_25`` and petfinder-extras
layouts (``smoke_data``: 20 JPEGs and 16 PNGs of 320 x 320); ``python -m
pets_face_recognition_tpu_torch.transform_dataset --pipeline head --thr 0``
with the detector a corpus rebuild loads, a port checkpoint named by
``PFR_KEYPOINT_CKPT`` (seeded random weights; the full-width detector at
its 1000-proposal test budgets) at B = 8, on the card (launch counts around
it: K1 once per kept photo, K2, K3) and on the CPU: the same files under the
same names, the crops before encoding within 1e-3 on [0, 1]; the card's
JPEG files (nvJPEG) against PIL's libjpeg on the CPU's crops: the same
quantisation tables, 4:2:0 chroma, and the decoded pixels within
``JPEG_GAP`` (largest and mean), with the gap taken apart (grey crops,
2 x 2 chroma blocks, each YCbCr channel); then ``transform_reproduce``'s
head route on the card over both layouts with the same detector (its walks
and exclusion lists; K1-K3 launched). fe_fit:
``build_fe_config`` at production width (ResNet-50 -> 512 with live
BatchNorm, ArcFace s 64 m 0.5, B = 64 at 224 x 224, 8 loader threads) over
``smoke_data.make_fe`` (64 identities of 6 crops; 32 train: 3 steps an
epoch with 4 petfinder-extras identities; 500 pairs), run as ``main()``
runs it: SGD for 2 epochs (checkpoints ``epoch=0-step=3``,
``epoch=1-step=6``, one save and one load timed, a bit-equal restore), a
resume into a third epoch (epoch 2, step 9), AdamW for 1 epoch; no
hand-written kernel may launch in FE training; the loader alone (reads,
``FETrainAug`` and collate apart); ``eval_fe`` on the last checkpoint, and
on the card against the CPU the validation embeddings of that checkpoint
and of the fit's initial weights with the ``fc`` bias moved by minus the
mean validation embedding (within 1e-4 relative), and the latter's metrics
within 1e-3 (random-weight embeddings all but share one direction, more so
after a few steps; centred, their pair cosines spread around 0); one
reduced step (full
ResNet-50, B = 8 at 128 x 128) on the card against the CPU (loss 1e-3,
running statistics 1e-4, gradients 5e-3 or twice the card's own spread under
1e-6 input rounding); ``python -m pets_face_recognition_tpu_torch.main
--config pets_face_recognition_tpu_torch/configs/fe_smoke.py`` in a
subprocess, which must exit 0. Step ms (the first apart), peak memory, each
epoch's ``data_time_s`` and ``step_time_s``, the step alone and beside a
running loader, eval ms a batch and the metrics' ms (pairs, verification,
Recall@K apart), checkpoint bytes and save / load ms are printed.

Then Mask R-CNN's serving paths, under the git-ignored ``smoke_out/mask``
(deleted after them). mask_serve: ``pipelines.mask_detector`` (full-width
ResNet-50-FPN Mask R-CNN, 3 detections, RPN 1000/1000, box NMS 0.5, score
threshold 0.05, seeded random weights) at B = 8 on 320 x 320: one call's
launches by call site (K2 in the RPN and in the box NMS, K3 on box and mask
RoIs: one each), the same batch on the CPU (boxes within 1e-4 of the side,
scores 1e-5, masks 1e-4, labels and validity equal), K2 on the call's own
(8, 1000) box-NMS groups (keep masks equal) and K3 on its 24 mask RoIs at
14 x 14 (1e-4) against their plain versions, timed beside their bounds, a
warm call's ms and peak memory. body_tsv: ``generate_tsv --body`` over the
committed corpus with the threshold 0 on the card and on the CPU: the same
kept photos and body boxes, the 256 x 256 body crops equal where the boxes
agree, head and body embeddings within 1e-5 relative, scores within 1e-6,
the same tsv rows; images/s and ms a photo in decode, ``Preproc3``,
``Preproc4``, ``resize_with_padding`` and the embedders. masked_transform:
``transform_dataset --pipeline body --masked --mask-thr 0.7 --thr 0`` on
seeded layouts through a ``PFR_MASK_CKPT`` checkpoint (random weights, mask
logits spread by ``MASK_LOGIT_SPREAD``) on the card and on the CPU (the
same files and tightened boxes, crops within 1e-3 but at pixels whose pasted
masks both lie within 1e-4 of the threshold, counted; the card's JPEGs
against libjpeg), ``prepare_tables`` on both (rows, landmarks and boxes
byte for byte, scores within 1e-5) and ``transform_reproduce``'s masked route
on the card, each with its launch counts and photos/s.

Then Mask R-CNN's training, under the git-ignored ``smoke_out/mask_train``
(deleted after it), from the port's Oxford-IIIT Pet miniature
(``smoke_data.make_oxford``, 40 photos of 320 x 320 with trimaps). mask_train:
the mask config's full-width model (``build_mask_config``: RPN 2000/2000, 512
box samples an image at 25% positive, 128 mask positives an image) on one
batch of B = 8 letterboxed with its masks to 640 x 640 by
``DetectionCollate(with_masks=True)``: a warm-up and 5 timed steps (median
and range in ms, peak GiB), the launches by call site (K2 once a step in the
RPN; K3, K4 and K4's pre-pass each once on the 7 x 7 box RoIs and once on the
14 x 14 mask positives), ``loss_mask`` of the first step within 0.2 of
ln 2, and K4 on the step's own mask-branch gradient against its plain
version (the kernels line's ``_masktrain`` row; two launches bit-equal).
mask_train_vs_cpu: one reduced step (B = 2, 256 x 256, budgets 256/128/16)
on the card and on the CPU from the same weights and sampler noise: each
loss term within 1e-3 relative, the mask head's gradients within 5e-3
relative in norm, the gradients that are 0 by construction (the background
class's mask logits and box deltas) within 1e-5, and every other gradient
within 5e-3 at the median and at the worst within 5e-3 more than the
card's own largest move under 1e-7 input rounding (flat image regions flip
trunk ReLUs at the last bit). mask_fit:
``python -m pets_face_recognition_tpu_torch.main_detection --config
pets_face_recognition_tpu_torch/configs/mask_smoke.py`` for 1 epoch in a
subprocess (exit 0, one ``epoch=0-step=8`` checkpoint), a restore of the
checkpoint bit-equal to the file, and ``eval_detection`` on it on the card
and on the CPU: AP 50/70/90, Mean/Median IoU and ``Masks Mean IoU`` within
1e-3, the 28 x 28 mask probabilities and the pasted masks within 1e-4, a
mask pixel on either side of 0.5 allowed only inside a 1e-4 band about it
(counted), the device paste 1e-6 from the CPU's on the card's own masks and
boxes, with the CPU held to the card's proposals and its picks where its
own are near-ties (a smoke epoch piles the scores about the 0.05 threshold;
the moves are counted, the CPU's post-process on the card's candidates must
pick the card's, and end to end the images that did not move are held to
the same gates, the metrics too when none moved), and ``eval_detection``'s
metrics within 1e-3 of the card's detections there;
the same on the fit's initial weights, which must give detections
(one smoke epoch can teach random weights to find none), their masks held
in the card's boxes (random boxes are slivers a fraction of a pixel high,
where the boxes' float32 rounding moves the paste's rows).

Then int8 serving (everything under the git-ignored ``smoke_out/int8``,
deleted after). int8_conv: every distinct ``QuantConv`` input shape of the
full-width keypoint R-CNN (scope ``rpn`` and the keypoint head) at B = 32 x
320 and of the embedder at B = 32 x 224, on a calibrated int8 forward's
activations: the card's int32 accumulators of the first two images equal to
the CPU's bit for bit, the dequantized outputs within 1e-6, and each shape's
int8 ms (im2col, ``torch._int_mm``, epilogue, whole) beside the float32
convolution's, reported. int8_serve: the detector calibrated on 4 seeded
batches of 32 and the embedder on the crops it keeps (the calibrate passes
within 1e-5 of the float models), then ``embed_batch`` int8 against float:
K1-K3 launches equal, crops/s of both in 5 paired rounds, one call's peak
memory of each taken alike beside each model set's size, the drift max(1 -
cos); the card against the CPU at B = 2 over the card's carried state (at
the first activation point that differs, under 0.1% of the quantized
values and by one step; the embeddings within the card's own spread under
1e-7 input rounding plus 1e-4 relative; the keypoints reported beside
their spread) and the scales of both calibrated on the same two images within
1e-5. int8_chain: ``generate_tsv`` in subprocesses with the head
embedders' ``fc`` bias centred: float with a scores dump, int8 without a
state file (nonzero, with JAX's message), calibrate with ``--body`` (the
state written at exit), int8 ``--body``, int8 on the embedder alone and
int8 on the default components, each with a dump; ``near_tie`` holds the
float and embedder-only int8 dumps to no flip across a float gap of 5e-4
or more and a drift under 0.65 (the card's reading with 4x headroom), the
default-components pair reported (ROADMAP note 24), with the near-tie
share. ``masked_transform`` also runs the port's
``score_detection`` and ``score_landmark`` over ``prepare_tables``' card and
CPU tables against one seeded annotation pickle: equal printed lines.

Then the alternate detector families (alt_rcnn): the five factories
``swin_tiny_keypoint_rcnn`` (Swin-T, 448 x 448), ``fasterrcnn_resnet50_fpn``,
``mobile_net_v3_large_rcnn``, ``convnetx_tiny_rcnn`` and
``convnext_tiny_keypoint_rcnn`` (320 x 320) at full width and their own
default budgets, seeded random weights, B = 2: ``drive_alt_factories.drive``
(an eval forward, two training steps, three timed eval forwards) with K2-K4
and the pre-pass counted from 0 around it and held to the expected counts,
the warm eval and step ms and peak memory; each factory's eval on the card
against the CPU on one set of weights (validity, labels, scores 1e-5, boxes
and keypoints 1e-4 of the side; an argmax that moves is counted and allowed
only between picks whose scores lie within 1e-5); the Swin step at 224 x 224
against the CPU (losses 1e-4; the gradients within 1e-3 plus the card's
own move under 1e-7 input rounding, three draws, except the keypoint head's
and predictor's, within 1e-3 plus twice the largest move either device's own
step makes in them under 1e-6 rounding, six draws on the card and three on
the CPU); and K3 and K4 at the Swin detector's 448 x 448 training shapes
against their plain versions (rows ``_alt``).

Reduced precision in training and int8 (the JAX package's bfloat16
defaults): the kernel row ``multilevel_roi_align_backward_bf16``, K4 with
bfloat16 operands at the training step's shapes, its float32 sums within
1e-5 of the scale of its plain version's (K4 in float32 beyond that) and
its result bit-identical across two launches, timed beside K4 in float32
on the same RoIs. fe_fit's configs pin ``compute_dtype="float32"`` (the
card held to the CPU in float32); bf16_fe runs ``build_fe_config``'s
default (bfloat16 on the card): the B = 64 step beside float32's, a
reduced step card against CPU in bfloat16 within twice bfloat16's own
move (the CPU's bfloat16 step's distance from the card's float32 one: the
card's bfloat16 result is in no bound) plus the float32 gates, and
``eval_fe`` from a bfloat16-trained checkpoint. bf16_train: the keypoint
R-CNN (B = 16 x 640) and Mask R-CNN (B = 8 x 640) steps with the models at
``dtype=bfloat16``, launches a step K2 1, K3-bf16 2, K4-bf16 2, pre-pass 2,
ms and peak memory beside the float32 steps; a reduced step of each card
against CPU, the CPU given the card's proposals over bfloat16 near-ties
(counted), within twice bfloat16's own move; fault 2's bitwise count on
the bfloat16 keypoint step. int8_bf16_serve: the bfloat16 service with the
int8 twins at JAX's bench components (launches K1-bf16 1, K2 1, K3-bf16 2),
crops/s beside the bfloat16 float service, every ``QuantConv``'s int32 sums
bit-equal card against CPU, and the forced values card against CPU within
twice bfloat16's own move (the CPU's from the card's float32 int8 twin).
alt_bf16: the Swin-T and ConvNeXt-T keypoint R-CNNs at ``dtype=bfloat16``,
an eval and a step each, card against CPU likewise. Each of these gates
must reject a planted fault on the card, a kernel wrapper's result scaled
(``planted_fault``): K4's level gradients x 2 in a step, K3's pooled values
x 1.1 in an eval; in bf16_fe the cotangent of the trunk's last stage x 2.

Then data parallelism (ddp): ``parallel.init_distributed`` over NCCL from
the env names (``COORDINATOR_ADDRESS=localhost:<free port>``,
``NUM_PROCESSES=1``, ``PROCESS_ID=0``), a world of one with ``device_info``;
through the mesh path at full width, each from the same state as the plain
path and both under deterministic algorithms: an FE step (B = 64 x 224,
1000 classes), a keypoint R-CNN step (B = 16 x 640) and a Mask R-CNN step (B
= 8 x 640), each expected equal bit for bit (otherwise the gap is printed
and held to twice the card's own move under 1e-7 input rounding, at least
1e-6); ``EmbeddingService(mesh=...)`` at B = 32 against the plain service,
both at threshold 0 (validity equal, NaN rows where the plain service's
are, finite embeddings within 1e-5); ``sharded_topk_scores`` over a
65536 x 512 gallery against ``topk_rows`` (indices equal, scores 1e-6);
each mesh path's K1-K4 launches, counted from 0 around it (paths
``ddp_*``). tuners: ``find_max_batch_size`` on the full-width FE step from
16 (the largest batch that fits, the peak memory, the memory left
allocated, held under 256 MiB above where it started) and a 20-step
``find_optimal_init_lr`` at B = 16. dog_fixture: the keypoint config with
seeded dog pickles over ``smoke_data.make_data25`` photos beside the CAT
miniature, B = 16 x 640 without loader threads: its first batch equal to a
second read, one step on it and one on a batch of dog items alone, finite
losses, K2-K4 launched. quality: the quality instrument over
``smoke_data.make_kashtanka_hard`` cut in depth to 16 identities (120
photos; every model at full width) on a seeded keypoint R-CNN checkpoint
(``PFR_KEYPOINT_CKPT``, RPN 1000 / 1000), the centred head embedders and,
for the mobile row, ``configs/keypoint_mobile_smoke.py`` fitted for one
epoch and recalibrated by ``recalibrate_bn``: five rows and an ensemble row
in concurrent subprocesses, ``diff_tsv_ranks``, and one float pass in this
process with its launches counted (path ``quality``; gates in
``quality_phase``). ``python3 chip_smoke.py --quality-full`` runs only the
build and the instrument's eight rows over the whole hard corpus (1272
photos), one pass after another, printing each pass's seconds.

Then a ``kernels`` JSON line (K1-K5 and K4's pre-pass; K1's bfloat16 and
int8 modes at the served batch, B = 32, and K3 on bfloat16 levels at the
serving shapes, timed in the kernel phase, each bit-equal to its plain
version expected, their launches
the reduced-precision serving paths'; and K3, K4 and the
pre-pass again on the mobile pyramid, ``_mobile``, and K2 and K3 at Mask
R-CNN's shapes, ``_mask``, and K4 on Mask R-CNN's training gradient,
``_masktrain``, and K3 and K4 at Swin's shapes, ``_alt``, and K4 with
bfloat16 operands, ``_bf16``, whose launches are the bfloat16 training
paths'; ``max_abs_err`` is each
row's largest absolute difference from its plain version on the card, 0 or 1
for a keep mask, an integer for the pre-pass; ``launches`` sums every path's
counts, the ``_mobile`` rows the mobile paths' alone, the ``_mask`` rows the
Mask R-CNN paths', the ``_masktrain`` row mask_train's, the ``_alt`` rows the
alternate families' paths), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``, printed only if every phase passed. The
script leaves torch's TF32 defaults as they are: the entry points
(``embed_batch``, ``train_step``) turn TF32 off inside themselves, a forward
pre-hook records the switches their models see (the run fails if TF32 was on
there, or if the switches were not restored after), and models called
directly run under ``float32_matmuls``. Every number is float32 but in the
reduced-precision phases, which say so. Each phase line carries ``t_s``, the
seconds since the script began. A hang becomes a traceback and exit 1
through ``faulthandler``.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
F32_FLOP_PER_S = 67e12             # H100 SXM float32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12        # H100 SXM bfloat16 on the tensor cores, dense
B_KERNELS = 8                      # batch of the kernel phase
B_TIMED = 32                       # batch of the end-to-end timing
B_BENCH = 128                      # the JAX bench.py's --batch-size default
IMAGE = 320
CROP = 224
B_TRAIN = 16                       # keypoint config: train_batch_size
IMAGE_TRAIN = 640                  # keypoint config: image_size
MAX_BOXES = 4                      # keypoint config: max_boxes
K2_KERNELS = "nms_keep_sorted_batch_"  # K2's two kernels: the IoU words, the sweep
T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line for ``phase``, with ``t_s``: seconds since the script began."""
    print(json.dumps({"phase": phase, "t_s": round(time.perf_counter() - T_START, 2), **kw}),
          flush=True)


@contextlib.contextmanager
def background(cmd: list[str], cwd: Path, env: dict, timeout: float = 300):
    """Start ``cmd`` now and yield ``wait() -> (CompletedProcess, seconds)``:
    an entry point checked in its own process runs beside the phase's work
    that shares nothing with it (its CPU reference passes). The process is
    killed if the block is left before it ends."""
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    def wait():
        out, err = proc.communicate(timeout=timeout)
        return (subprocess.CompletedProcess(cmd, proc.returncode, out, err),
                time.perf_counter() - t)

    try:
        yield wait
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def kernel_us(fn, kernel_name: str, **kw) -> float | None:
    """``kernel_ab.device_us``: the kernels' device time per call from
    ``torch.profiler``, or None (written as null, not measured) when the
    profiler lost launches in every window it took. It is a reading beside
    the CUDA-event ``ms``, never a gate: the launch counts come from the
    wrappers' own counters, not from the profiler."""
    from pets_face_recognition_tpu_torch.kernel_ab import device_us

    return device_us(fn, kernel_name, strict=False, **kw)


def grid_sample_route(images, Hs):
    """The library's whole route for K1's function: NHWC images and maps in,
    NHWC crops out, through ``grid_sample``."""
    import torch
    from pets_face_recognition_tpu_torch.kernel_ab import grid_sample_grid

    grid = grid_sample_grid(Hs, (IMAGE, IMAGE), (CROP, CROP))
    out = torch.nn.functional.grid_sample(images.permute(0, 3, 1, 2), grid,
                                          padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1).contiguous()


def paired_ms(fn_a, fn_b, rounds: int = 7) -> list[tuple[float, float]]:
    """``(cuda_ms(fn_a), cuda_ms(fn_b))`` for each of ``rounds`` rounds, ``fn_a``
    timed first in even rounds and second in odd ones."""
    from pets_face_recognition_tpu_torch.kernel_ab import cuda_ms

    out = []
    for r in range(rounds):
        if r % 2 == 0:
            a = cuda_ms(fn_a)
            b = cuda_ms(fn_b)
        else:
            b = cuda_ms(fn_b)
            a = cuda_ms(fn_a)
        out.append((a, b))
    return out


def host_us(fn, iters: int = 200) -> float:
    """``kernel_ab.host_us``: host time per call of ``fn()`` in us, back to
    back after warm-up, without waiting for the device inside the loop."""
    from pets_face_recognition_tpu_torch.kernel_ab import host_us as timed

    return timed(fn, iters, warmup=10)


def bound_ms(n_bytes: float, n_flops: float, n_tc_flops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take: the bytes over the memory rate, or
    the operations over the peak rate of their type (``n_flops`` float32 on
    the CUDA cores, ``n_tc_flops`` bfloat16 on the tensor cores, which issue
    at the same time), whichever is longest."""
    from pets_face_recognition_tpu_torch.kernel_ab import HBM_BYTES_PER_S

    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_flops / F32_FLOP_PER_S, n_tc_flops / BF16_TC_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def kernel_phase(dev) -> dict[str, dict]:
    """Phase 2, serving: K1-K3 against their plain versions at serving shapes."""
    import torch
    from pets_face_recognition_tpu_torch.kernel_ab import (cuda_ms, grid_sample_grid, random_rois,
                                                           similarity_landmarks, warp_read_bytes)
    from pets_face_recognition_tpu_torch.ops import homography, nms, roi_align
    from pets_face_recognition_tpu_torch.profile_serving import nms_work

    g = torch.Generator().manual_seed(0)
    rows = {}

    # K1: (B, 320, 320, 3) -> (B, 224, 224, 3) at the kernel phase's B = 8 and
    # the timed serving batch's B = 32; the row keeps B = 8
    for B in (B_KERNELS, B_TIMED):
        gb = g if B == B_KERNELS else torch.Generator().manual_seed(4)
        images = torch.rand(B, IMAGE, IMAGE, 3, generator=gb).to(dev)
        base = torch.tensor([[70.0, 92.0], [154.0, 92.0], [112.0, 160.0]])
        lms = similarity_landmarks(gb, B, base, IMAGE).to(dev)
        Hs = homography.alignment_homographies(lms, base.to(dev))
        got = homography.warp_perspective_batch_cuda(images, Hs, (CROP, CROP))
        want = homography.warp_perspective_batch(images, Hs, (CROP, CROP))
        torch.cuda.synchronize()
        err, tol = max_err(got, want), 1e-4
        k1 = lambda: homography.warp_perspective_batch_cuda(  # noqa: E731
            images, Hs, (CROP, CROP))
        k1_us = kernel_us(k1, "warp_perspective_kernel")
        plain = cuda_ms(lambda: homography.warp_perspective_batch(images, Hs, (CROP, CROP)))
        # the library: grid_sample (zero padding) on a grid from H^-1, alone on a
        # grid built beforehand, and as the whole route from Hs (inverse, grid,
        # grid_sample, layout permutes), which is what the K1 wrapper replaces
        route = lambda: grid_sample_route(images, Hs)  # noqa: E731
        lib_out = route()
        lib_err = max_err(lib_out, want)
        grid = grid_sample_grid(Hs, (IMAGE, IMAGE), (CROP, CROP))
        nchw = images.permute(0, 3, 1, 2)
        lib_call = lambda: torch.nn.functional.grid_sample(  # noqa: E731
            nchw, grid, padding_mode="zeros", align_corners=True)
        # the wrapper against grid_sample alone, in paired rounds; the medians
        # are the row's ms and library_ms
        pairs = paired_ms(k1, lib_call)
        ms = statistics.median(a for a, _ in pairs)
        lib_ms = statistics.median(b for _, b in pairs)
        lib_us = kernel_us(lib_call, "")
        # the wrapper's and the library call's host time: with one small
        # kernel each, the single-call times above are mostly host work
        wrap_host = host_us(k1)
        lib_host = host_us(lib_call)
        route_ms = cuda_ms(route)
        # bytes: the source pixels the taps read, the maps, the crops
        src_bytes = warp_read_bytes(images, Hs, (CROP, CROP))
        n_bytes = src_bytes + Hs.numel() * 4 + got.numel() * 4
        n_flops = B * CROP * CROP * (24 + 7 * 3)
        b, by = bound_ms(n_bytes, n_flops)
        emit("kernel", name="K1 warp_perspective_batch", shape=list(images.shape),
             max_abs_err=err, atol=tol, ms=ms, kernel_device_us=k1_us, plain_ms=plain,
             wrapper_host_us=wrap_host, library_ms=lib_ms, library_device_us=lib_us,
             library_host_us=lib_host,
             library="grid_sample(zeros, align_corners=True) alone, "
             "on a grid built beforehand", paired_ms=pairs,
             rounds_k1_not_slower=sum(a <= b for a, b in pairs), library_route_ms=route_ms,
             library_route="inv + grid from H^-1 + grid_sample + NHWC permutes, from Hs",
             library_max_abs_err=lib_err, bound_ms=b, bound_by=by,
             source_bytes_read=src_bytes, source_bytes_total=images.numel() * 4)
        if not err <= tol:
            raise AssertionError(f"K1 disagrees with its plain version: {err} > {tol}")
        if B == B_KERNELS:
            rows["warp_perspective_batch"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                                  bound_ms=b, bound_by=by, library_ms=lib_ms)

    # K2: G = 5 levels x 8 images, K = 128 score-sorted boxes, thr 0.7
    G, K = 5 * B_KERNELS, 128
    xy = torch.rand(G, K, 2, generator=g) * 280
    wh = 8 + torch.rand(G, K, 2, generator=g) * 120
    boxes = torch.cat([xy, xy + wh], -1).to(dev)
    valid = (torch.rand(G, K, generator=g) > 0.1).to(dev)
    got = nms.nms_keep_sorted_batch_cuda(boxes, valid, 0.7)
    want = nms.nms_keep_sorted_batch(boxes, valid, 0.7)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    ms = cuda_ms(lambda: nms.nms_keep_sorted_batch_cuda(boxes, valid, 0.7))
    k2_us = kernel_us(lambda: nms.nms_keep_sorted_batch_cuda(boxes, valid, 0.7), K2_KERNELS)
    # at this size the call is mostly host work
    k2_host = host_us(lambda: nms.nms_keep_sorted_batch_cuda(boxes, valid, 0.7))
    plain = cuda_ms(lambda: nms.nms_keep_sorted_batch(boxes, valid, 0.7), iters=5)
    # IoUs this data needs: each live pivot against the live boxes after it
    n_iou = int(nms_work(boxes, valid, want, 0.7)["ious"].sum())
    n_bytes = boxes.numel() * 4 + valid.numel() + got.numel()
    b, by = bound_ms(n_bytes, n_iou * 13)
    emit("kernel", name="K2 nms_keep_sorted_batch", shape=[G, K, 4], mismatches=n_diff,
         kept=int(got.sum()), ms=ms, kernel_device_us=k2_us, wrapper_host_us=k2_host,
         plain_ms=plain, library_ms=None,
         library="none (no torchvision)", bound_ms=b, bound_by=by, ious=n_iou,
         sequential_steps=K)
    if n_diff:
        raise AssertionError(f"K2 keep mask differs from the plain version in {n_diff}")
    rows["nms_keep_sorted_batch"] = dict(max_abs_err=max_err(got, want), ms=ms, plain_ms=plain,
                                         bound_ms=b, bound_by=by, library_ms=None)

    # K3: p2..p5 of a 320 image, C = 256; box RoIs 16/image at 7x7, keypoint
    # RoIs 1/image at 14x14. Boxes include ones overhanging the image and wide
    # ones (5:1) that the TPU kernel's fixed windows would clamp.
    C = 256
    levels = [torch.randn(B_KERNELS, s, s, C, generator=g).to(dev) for s in (80, 40, 20, 10)]
    strides = (4, 8, 16, 32)

    k3_ms = k3_plain = k3_bound_b = k3_flops = 0.0
    k3_err = 0.0
    for n_per, out in ((16, 7), (1, 14)):
        rois = random_rois(g, B_KERNELS * n_per, IMAGE, 4.5).to(dev)
        bidx = torch.arange(B_KERNELS, device=dev).repeat_interleave(n_per).to(torch.int32)
        args = (levels, rois, bidx, (out, out), strides)
        got = roi_align.multilevel_roi_align_cuda(*args)
        want = roi_align.multilevel_roi_align(*args)
        torch.cuda.synchronize()
        err, tol = max_err(got, want), 1e-4
        k3_err = max(k3_err, err)
        ms = cuda_ms(lambda: roi_align.multilevel_roi_align_cuda(*args))
        us = kernel_us(lambda: roi_align.multilevel_roi_align_cuda(*args),
                       "multilevel_roi_align_kernel")
        plain = cuda_ms(lambda: roi_align.multilevel_roi_align(*args))
        cells = touched_cells(levels, rois, bidx, (out, out), strides)
        n_bytes = cells * C * 4 + rois.numel() * 4 + bidx.numel() * 4 + got.numel() * 4
        n_flops = got.numel() * (8 * 4 + 1)
        b, by = bound_ms(n_bytes, n_flops)
        emit("kernel", name=f"K3 multilevel_roi_align {out}x{out}", rois=rois.shape[0],
             max_abs_err=err, atol=tol, ms=ms, kernel_device_us=us, plain_ms=plain,
             library_ms=None, library="none (no torchvision)", bound_ms=b, bound_by=by,
             touched_cells=cells)
        if not err <= tol:
            raise AssertionError(f"K3 {out}x{out} disagrees: {err} > {tol}")
        k3_ms += ms
        k3_plain += plain
        k3_bound_b += n_bytes
        k3_flops += n_flops
    b, by = bound_ms(k3_bound_b, k3_flops)
    rows["multilevel_roi_align"] = dict(max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain,
                                        bound_ms=b, bound_by=by, library_ms=None)
    return rows


# K1's reduced-precision modes against float32 crops on [0, 1] pixels: bf16
# rounds pixels (2^-9 relative) and tents (one bf16 step, ~4e-3 of a pixel);
# int8 is JAX's own bound (tests/test_pallas_warp.py:88)
K1_MODE_DRIFT = {"bfloat16": 8e-3, "int8": 1.2e-2}


def same_bits(a, b) -> bool:
    """``a`` and ``b`` hold the same bits, NaN payloads aside (NaN where the
    other is NaN)."""
    import torch

    nan = a.isnan()
    if not torch.equal(nan, b.isnan()):
        return False
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(a.view(ints)[~nan], b.view(ints)[~nan])


def k1_stress_cases(dev):
    """``(label, images, Hs, crop, kwargs)`` for K1's bfloat16 and int8
    instances on maps and shapes that serving does not give them: rotations
    of 90 and 180 degrees, scales 0.25 and 4 (source pixels a crop pixel), a
    denominator that changes sign inside the crop, a NaN map, a crop wholly
    off the image, C = 1, 2 and 4, a 223 x 97 crop, a bfloat16 output, an
    image whose rows are not 16-byte aligned and one whose base is not, and
    the served map with the int8 instance's boxes shrunk by 3 pixels
    (``slack`` -3, set through the kernel's test hook, so that taps fall
    outside their tile's box and read global memory). Each takes 2 images."""
    import torch

    def crop_map(scale, deg, shift=(0.0, 0.0), persp=(0.0, 0.0), crop=(CROP, CROP),
                 hw=(IMAGE, IMAGE)):
        # H^-1 takes crop pixels about the crop's centre to the image's centre
        # plus shift, rotated by deg and scaled; persp is its third row's x, y
        th = math.radians(deg)
        a = torch.tensor([[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]],
                         dtype=torch.float64) * scale
        c = torch.tensor([(crop[1] - 1) / 2, (crop[0] - 1) / 2], dtype=torch.float64)
        t = torch.tensor([(hw[1] - 1) / 2 + shift[0], (hw[0] - 1) / 2 + shift[1]],
                         dtype=torch.float64) - a @ c
        hinv = torch.eye(3, dtype=torch.float64)
        hinv[:2, :2], hinv[:2, 2] = a, t
        hinv[2, :2] = torch.tensor(persp, dtype=torch.float64)
        return torch.linalg.inv(hinv).float().expand(2, 3, 3).contiguous().to(dev)

    g = torch.Generator().manual_seed(7)

    def imgs(C=3, hw=(IMAGE, IMAGE)):
        return torch.rand(2, *hw, C, generator=g).to(dev)

    served = crop_map(1.2, 12.0, (9.0, -14.0), (2e-4, -1e-4))
    flat = torch.rand(2 * IMAGE * IMAGE * 3 + 1, generator=g).to(dev)
    return [
        ("rotation 90", imgs(), crop_map(1.0, 90.0), (CROP, CROP), {}),
        ("rotation 180", imgs(), crop_map(1.0, 180.0), (CROP, CROP), {}),
        ("scale 0.25", imgs(), crop_map(0.25, 7.0), (CROP, CROP), {}),
        ("scale 4", imgs(), crop_map(4.0, 20.0), (CROP, CROP), {}),
        ("sign change", imgs(), crop_map(1.0, 0.0, persp=(-1.0 / 101.5, 0.0)), (CROP, CROP), {}),
        ("nan map", imgs(), torch.full((2, 3, 3), math.nan, device=dev), (CROP, CROP), {}),
        ("off the image", imgs(), crop_map(1.0, 5.0, (900.0, 40.0)), (CROP, CROP), {}),
        ("C = 1", imgs(1), served, (CROP, CROP), {}),
        ("C = 2", imgs(2), served, (CROP, CROP), {}),
        ("C = 4", imgs(4), served, (CROP, CROP), {}),
        ("223 x 97 crop", imgs(), crop_map(0.9, -8.0, crop=(223, 97)), (223, 97), {}),
        ("bfloat16 out", imgs(), served, (CROP, CROP), {"out_dtype": torch.bfloat16}),
        ("rows unaligned", imgs(3, (301, 333)), crop_map(1.1, 9.0, hw=(301, 333)),
         (CROP, CROP), {}),
        ("base unaligned", flat[1:].view(2, IMAGE, IMAGE, 3), served, (CROP, CROP), {}),
        ("box shrunk", imgs(), served, (CROP, CROP), {"slack": -3}),
    ]


def k1_stress_lines(dev) -> None:
    """K1-bf16 and K1-int8 on ``k1_stress_cases``, each bit-equal to its plain
    version (NaN where it is NaN), with where the int8 instance reads its taps
    by ``homography.warp_tap_sources``; together the cases must take each of
    its branches: staged boxes, taps outside a staged box read from global
    memory, and tiles that stage nothing (a sign change or NaN, a box over
    the budget). Raises on a difference or a branch not taken."""
    import torch
    from pets_face_recognition_tpu_torch import kernels
    from pets_face_recognition_tpu_torch.ops import homography

    set_slack = kernels.library().pfr_warp_int8_test_box_slack
    totals, lines = {}, []
    for label, images, Hs, crop, kw in k1_stress_cases(dev):
        out_dtype = kw.get("out_dtype", torch.float32)
        slack = kw.get("slack", homography.K1_BOX_SLACK)
        line = {"case": label, "shape": list(images.shape), "crop": list(crop)}
        for cd, mode in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
            set_slack(slack if cd == torch.int8 else homography.K1_BOX_SLACK)
            try:
                got = homography.warp_perspective_batch_cuda(images, Hs, crop, cd, out_dtype)
                want = homography.warp_perspective_batch(images, Hs, crop, cd, out_dtype)
                torch.cuda.synchronize()
            finally:
                set_slack(homography.K1_BOX_SLACK)
            line[mode] = dict(bits_equal=same_bits(got, want), nan=int(want.isnan().sum()))
        tap = homography.warp_tap_sources(Hs, crop, tuple(images.shape[1:3]), slack)
        for k, v in tap.items():
            totals[k] = totals.get(k, 0) + v
        line["int8"].update(tap)
        lines.append(line)
        emit("kernel", name="K1 reduced stress", **line)
    bad = [(ln["case"], m) for ln in lines for m in ("bf16", "int8")
           if not ln[m]["bits_equal"]]
    missing = [k for k in ("staged_taps", "box_miss_taps", "tile_global_taps",
                           "unsafe_tiles", "budget_tiles") if totals[k] == 0]
    emit("kernel", name="K1-int8 stress branches", **totals, cases=len(lines),
         differ=bad, branches_not_taken=missing)
    if bad:
        raise AssertionError(f"K1 reduced instances differ from their plain versions: {bad}")
    if missing:
        raise AssertionError(f"K1 stress maps take no {missing}")


def reduced_kernel_rows(dev) -> dict[str, dict]:
    """Phase 2, the JAX package's reduced precision at the serving shapes:
    K1's bfloat16 and int8 modes (320 x 320 -> 224 x 224, float32 out) at
    B = 8 and at the served batch, B = 32 (the ``kernels`` row), then on
    ``k1_stress_lines``' maps, and K3 on bfloat16 levels (p2..p5 of a 320
    image, C = 256, 16 box RoIs an image at 7 x 7 and one keypoint RoI at 14 x
    14), each against its plain version on the card (bit-equal expected: the
    plain versions round at the kernels' points and sum in their order; K1
    held bit for bit, K3 to 1e-4 of the value scale) and timed beside it and
    its bound. K1's modes are timed as K1's float32 row is (wrapper against
    ``grid_sample`` in float32 on a grid built beforehand in 7 paired rounds,
    device us, host us a call); ``grid_sample`` on bfloat16 images and grid
    (not the mode's function: its bfloat16 grid moves crops by half a pixel)
    is a side reading with its distance from float32. K3-bf16
    also: its bfloat16 output (``out_dtype``) equal to its float32 output
    rounded, bit for bit, and within the same 1e-4 of the scale (plus one
    bfloat16 step of it) of the plain version's bfloat16 output; the wrapper's
    host time a call; and the levels that K3 and K4's pre-pass map in the
    kernel equal to ``roi_levels`` on the card, on RoIs whose sides sit
    within a few float32 steps of each level boundary (``boundary_rois``)."""
    import torch
    from pets_face_recognition_tpu_torch.kernel_ab import (cuda_ms, grid_sample_grid, random_rois,
                                                           similarity_landmarks, warp_read_bytes)
    from pets_face_recognition_tpu_torch.ops import homography, roi_align

    g = torch.Generator().manual_seed(0)
    rows = {}
    base = torch.tensor([[70.0, 92.0], [154.0, 92.0], [112.0, 160.0]])
    for B in (B_KERNELS, B_TIMED):
        gb = g if B == B_KERNELS else torch.Generator().manual_seed(5)
        images = torch.rand(B, IMAGE, IMAGE, 3, generator=gb).to(dev)
        Hs = homography.alignment_homographies(
            similarity_landmarks(gb, B, base, IMAGE).to(dev), base.to(dev))
        f32 = homography.warp_perspective_batch(images, Hs, (CROP, CROP))
        nchw = images.permute(0, 3, 1, 2)
        grid = grid_sample_grid(Hs, (IMAGE, IMAGE), (CROP, CROP))
        lib_call = lambda: torch.nn.functional.grid_sample(  # noqa: E731
            nchw, grid, padding_mode="zeros", align_corners=True)
        lib_err = max_err(lib_call().permute(0, 2, 3, 1), f32)
        lib_us, lib_host = kernel_us(lib_call, ""), host_us(lib_call)
        nchw_b, grid_b = nchw.to(torch.bfloat16), grid.to(torch.bfloat16)
        lib_b = lambda: torch.nn.functional.grid_sample(  # noqa: E731
            nchw_b, grid_b, padding_mode="zeros", align_corners=True)
        lib_b_ms, lib_b_err = cuda_ms(lib_b), max_err(lib_b().permute(0, 2, 3, 1), f32)
        src_bytes = warp_read_bytes(images, Hs, (CROP, CROP))
        for cd, label in ((torch.bfloat16, "bfloat16"), (torch.int8, "int8")):
            k1 = lambda cd=cd: homography.warp_perspective_batch_cuda(  # noqa: E731
                images, Hs, (CROP, CROP), cd)
            got = k1()
            want = homography.warp_perspective_batch(images, Hs, (CROP, CROP), cd)
            torch.cuda.synchronize()
            err, exact = max_err(got, want), same_bits(got, want)
            drift = max_err(got, f32)
            pairs = paired_ms(k1, lib_call)
            ms = statistics.median(a for a, _ in pairs)
            lib_ms = statistics.median(b for _, b in pairs)
            us = kernel_us(k1, "warp_perspective_")
            plain = cuda_ms(lambda cd=cd: homography.warp_perspective_batch(
                images, Hs, (CROP, CROP), cd))
            n_bytes = src_bytes + Hs.numel() * 4 + got.numel() * 4
            b, by = bound_ms(n_bytes, B * CROP * CROP * (24 + 9 * 3))
            name = f"warp_perspective_batch_{'bf16' if cd == torch.bfloat16 else 'int8'}"
            side = dict(bf16_grid_library_ms=lib_b_ms,
                        bf16_grid_library_distance_from_float32=lib_b_err) \
                if cd == torch.bfloat16 else {}
            emit("kernel", name=f"K1 {name}", shape=list(images.shape), max_abs_err=err,
                 exact=exact, distance_from_float32=drift,
                 distance_tolerance=K1_MODE_DRIFT[label], ms=ms, kernel_device_us=us,
                 wrapper_host_us=host_us(k1), plain_ms=plain, library_ms=lib_ms,
                 library_device_us=lib_us, library_host_us=lib_host,
                 library="grid_sample(zeros, align_corners=True) in float32 alone, on a "
                 "grid built beforehand", library_distance_from_float32=lib_err,
                 paired_ms=pairs, rounds_k1_not_slower=sum(a <= b for a, b in pairs),
                 bound_ms=b, bound_by=by, **side)
            if not exact:
                raise AssertionError(f"K1 {label} at B = {B} differs from its plain version "
                                     f"({err})")
            if not drift <= K1_MODE_DRIFT[label]:
                raise AssertionError(f"K1 {label} moves crops by {drift} from float32")
            if B == B_TIMED:
                rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                                  bound_by=by, library_ms=lib_ms)
        del images, nchw, nchw_b, grid, grid_b, f32
    k1_stress_lines(dev)

    B = B_KERNELS
    C, strides = 256, (4, 8, 16, 32)
    levels = [torch.randn(B, s_, s_, C, generator=g).to(dev).to(torch.bfloat16)
              for s_ in (80, 40, 20, 10)]
    tot = dict(ms=0.0, plain_ms=0.0, bytes=0.0, flops=0.0, err=0.0)
    for n_per, out in ((16, 7), (1, 14)):
        rois = random_rois(g, B * n_per, IMAGE, 4.5).to(dev)
        bidx = torch.arange(B, device=dev).repeat_interleave(n_per).to(torch.int32)
        args = (levels, rois, bidx, (out, out), strides)
        got = roi_align.multilevel_roi_align_cuda(*args)
        want = roi_align.multilevel_roi_align_bf16(*args)
        got_b = roi_align.multilevel_roi_align_cuda(*args, out_dtype=torch.bfloat16)
        want_b = roi_align.multilevel_roi_align_bf16(*args, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err, tol = max_err(got, want), 1e-4 * scale
        err_b, tol_b = max_err(got_b, want_b), tol + 2.0 ** -8 * scale
        rounded = bool(torch.equal(got_b.view(torch.int16),
                                   got.to(torch.bfloat16).view(torch.int16)))
        k3 = lambda: roi_align.multilevel_roi_align_cuda(*args)  # noqa: E731
        k3_b = lambda: roi_align.multilevel_roi_align_cuda(  # noqa: E731
            *args, out_dtype=torch.bfloat16)
        ms, ms_b = cuda_ms(k3), cuda_ms(k3_b)
        us = kernel_us(k3, "multilevel_roi_align_kernel")
        us_b = kernel_us(k3_b, "multilevel_roi_align_kernel")
        plain = cuda_ms(lambda: roi_align.multilevel_roi_align_bf16(*args))
        cells = touched_cells(levels, rois, bidx, (out, out), strides)
        n_bytes = cells * C * 2 + rois.numel() * 4 + bidx.numel() * 4 + got.numel() * 4
        n_flops = got.numel() * (6 * 4 + 1)
        b, by = bound_ms(n_bytes, n_flops)
        emit("kernel", name=f"K3 multilevel_roi_align_bf16 {out}x{out}", rois=rois.shape[0],
             max_abs_err=err, atol=tol, value_scale=scale, exact=err == 0.0, ms=ms,
             kernel_device_us=us, host_us=host_us(k3), plain_ms=plain, library_ms=None,
             library="none (no torchvision)", bound_ms=b, bound_by=by, touched_cells=cells,
             bf16_out_ms=ms_b, bf16_out_kernel_device_us=us_b, bf16_out_host_us=host_us(k3_b),
             bf16_out_max_abs_err=err_b, bf16_out_atol=tol_b,
             bf16_out_is_float32_rounded=rounded,
             bf16_out_bound_ms=bound_ms(n_bytes - got.numel() * 2, n_flops)[0])
        if not err <= tol:
            raise AssertionError(f"K3 bf16 {out}x{out} disagrees: {err} > {tol}")
        if not (rounded and err_b <= tol_b):
            raise AssertionError(f"K3 bf16 {out}x{out}: bfloat16 output off (rounded "
                                 f"{rounded}, {err_b} > {tol_b})")
        tot = dict(ms=tot["ms"] + ms, plain_ms=tot["plain_ms"] + plain,
                   bytes=tot["bytes"] + n_bytes, flops=tot["flops"] + n_flops,
                   err=max(tot["err"], err))
    b, by = bound_ms(tot["bytes"], tot["flops"])
    rows["multilevel_roi_align_bf16"] = dict(max_abs_err=tot["err"], ms=tot["ms"],
                                             plain_ms=tot["plain_ms"], bound_ms=b, bound_by=by,
                                             library_ms=None)
    level_map_check(dev, g, levels)
    return rows


def boundary_rois(g, n_per: int = 48):
    """RoIs whose sides sit within a few float32 steps of the canonical
    mapper's level boundaries: sqrt(area) near 56, 112, 224 and 448 (the
    edges of p2..p5 and below), and near each times 2^-1e-6, where the
    mapper's +1e-6 moves the edge; each ``n_per`` of them 6e-8 apart
    (about one float32 step), with aspect ratios in [1, 1.3] and random
    corners, so that the rounding of the area, its square root and its log2
    decide their level."""
    import torch

    sides = torch.tensor([c * (1 + i * 6e-8) for b in (56.0, 112.0, 224.0, 448.0)
                          for c in (b, b * 2.0 ** -1e-6)
                          for i in range(-n_per // 2, n_per // 2 + 1)])
    n = len(sides)
    aspect = (1 + 0.3 * torch.rand(n, generator=g)).sqrt()
    x1, y1 = torch.rand(n, generator=g) * 100, torch.rand(n, generator=g) * 100
    return torch.stack([x1, y1, x1 + sides * aspect, y1 + sides / aspect], 1)


def level_map_check(dev, g, levels) -> None:
    """The levels that K4's pre-pass maps in the kernel (its keys) against
    ``roi_levels`` on the card over ``boundary_rois``, and K3, which maps them
    with the same ``pfr_roi::roi_level``, on those RoIs against its plain
    version (a wrong level pools another level's values); both sides of every
    boundary must be met. Raises on any difference."""
    import torch
    from pets_face_recognition_tpu_torch.ops import roi_align

    rois = boundary_rois(g).to(dev)
    n, B = rois.shape[0], levels[0].shape[0]
    bidx = (torch.arange(n, device=dev) % B).to(torch.int32)
    strides = (4, 8, 16, 32)
    want = roi_align.roi_levels(rois, 2, 5)
    got = roi_align.multilevel_roi_align_cuda(levels, rois, bidx, (7, 7), strides)
    key, _ = roi_align.roi_footprints_cuda([tuple(f.shape) for f in levels], rois, bidx,
                                           (7, 7), strides)
    pre_levels = torch.div(key, B, rounding_mode="floor")
    plain = roi_align.multilevel_roi_align_bf16(levels, rois, bidx, (7, 7), strides)
    torch.cuda.synchronize()
    per_level = torch.bincount(want.long(), minlength=4).tolist()
    pre_diff = int((pre_levels != want).sum())
    err, tol = max_err(got, plain), 1e-4 * float(plain.abs().max())
    emit("kernel", name="K3 multilevel_roi_align_bf16 levels", rois=n,
         rois_per_level=per_level,
         prepass_levels_differ=pre_diff, k3_max_abs_err=err, k3_atol=tol,
         cpu_levels_differ=int((roi_align.roi_levels(rois.cpu(), 2, 5) != want.cpu()).sum()))
    if pre_diff or not err <= tol or min(per_level) == 0:
        raise AssertionError(f"in-kernel levels differ from roi_levels: pre-pass {pre_diff} "
                             f"of {n} ({per_level}); K3 {err} > {tol}")


def train_kernel_phase(dev) -> dict[str, dict]:
    """Phase 2, training: K2 at the training budget, K5, and K3/K4 at the
    training step's shapes, each against its plain version."""
    import torch
    from pets_face_recognition_tpu_torch.kernel_ab import cuda_ms, random_rois
    from pets_face_recognition_tpu_torch.ops import nms, roi_align
    from pets_face_recognition_tpu_torch.profile_serving import nms_work

    g = torch.Generator().manual_seed(3)
    rows = {}

    # K2 / K5: 16 images x 5 levels, 2000 score-sorted boxes each, thr 0.7
    G, K, thr = B_TRAIN * 5, 2000, 0.7
    boxes = random_rois(g, G * K, IMAGE_TRAIN, 4.0).reshape(G, K, 4).contiguous().to(dev)
    valid = (torch.rand(G, K, generator=g) > 0.1).to(dev)
    want = nms.nms_keep_sorted_batch(boxes, valid, thr)
    n_iou = int(nms_work(boxes, valid, want, thr)["ious"].sum())
    n_bytes = boxes.numel() * 4 + valid.numel() * 2
    entries = (
        ("K2 nms_keep_sorted_batch", "nms_keep_sorted_batch",
         lambda: nms.nms_keep_sorted_batch_cuda(boxes, valid, thr),
         lambda: nms.nms_keep_sorted_batch(boxes, valid, thr), want, n_iou, n_bytes, G),
        ("K5 nms_keep_sorted_grid", "nms_keep_sorted_grid",
         lambda: nms.nms_keep_sorted_grid(boxes, valid, thr),
         lambda: nms.nms_keep_sorted_batch(boxes, valid, thr), want, n_iou, n_bytes, G),
        ("K5 nms_keep_sorted", "nms_keep_sorted",
         lambda: nms.nms_keep_sorted(boxes[0], valid[0], thr),
         lambda: nms.nms_keep_sorted_batch(boxes[:1], valid[:1], thr)[0], want[0],
         int(nms_work(boxes[:1], valid[:1], want[:1], thr)["ious"].sum()), n_bytes // G, 1),
    )
    for label, name, fn, plain_fn, ref, ious, nb, groups in entries:
        got = fn()
        torch.cuda.synchronize()
        n_diff = int((got != ref).sum())
        ms = cuda_ms(fn, warmup=2, iters=10)
        us = kernel_us(fn, K2_KERNELS)
        plain = cuda_ms(plain_fn, warmup=1, iters=3)
        b, by = bound_ms(nb, ious * 13)
        emit("kernel", name=label, groups=groups, boxes_per_group=K, mismatches=n_diff,
             kept=int(got.sum()), ms=ms, kernel_device_us=us, plain_ms=plain, library_ms=None,
             library="none (no torchvision)", bound_ms=b, bound_by=by, ious=ious,
             sequential_steps=K)
        if n_diff:
            raise AssertionError(f"{label} keep mask differs from the plain version in {n_diff}")
        rows[name] = dict(max_abs_err=max_err(got, ref), ms=ms, plain_ms=plain, bound_ms=b,
                          bound_by=by, library_ms=None)
    del boxes, valid, want

    # K3 / K4: p2..p5 of 16 images of 640 x 640, C = 256; 512 box RoIs an image
    # at 7 x 7 and 128 keypoint RoIs an image at 14 x 14, over every level,
    # with RoIs off the image's edges and 5:1 ones
    rows.update(roi_kernel_rows(dev, g, (4, 8, 16, 32), 2, 5))
    # K5 is one row: the grid entry point at the training shapes; the
    # single-group entry point's numbers are in its own phase line
    single = rows.pop("nms_keep_sorted")
    rows["nms_keep_sorted_grid"]["max_abs_err"] = max(rows["nms_keep_sorted_grid"]["max_abs_err"],
                                                      single["max_abs_err"])
    return rows


def roi_kernel_rows(dev, g, strides, min_level: int, max_level: int, label: str = "",
                    batch: int = B_TRAIN, image: int = IMAGE_TRAIN) -> dict[str, dict]:
    """K3, K4 and K4's pre-pass on the levels ``p{min_level}..p{max_level}``
    (``strides``) of ``batch`` images of ``image`` x ``image``, C = 256, at
    the training step's RoI counts (512 box RoIs an image at 7 x 7, 128
    keypoint RoIs at 14 x 14, off the edges and 5:1 ones among them), each
    against its plain version and timed: rows ``multilevel_roi_align``,
    ``multilevel_roi_align_backward`` and ``roi_footprints``, each summed
    over the two RoI sets."""
    import torch
    from pets_face_recognition_tpu_torch.kernel_ab import cuda_ms, random_rois
    from pets_face_recognition_tpu_torch.ops import roi_align

    C, n_levels = 256, len(strides)
    levels = [torch.randn(batch, image // st, image // st, C, generator=g).to(dev)
              for st in strides]
    shapes = [tuple(f.shape) for f in levels]
    level_bytes = sum(f.numel() for f in levels) * 4
    span = dict(min_level=min_level, max_level=max_level)
    fwd = dict(ms=0.0, plain=0.0, bytes=0.0, flops=0.0, err=0.0)
    bwd = dict(ms=0.0, plain=0.0, bytes=0.0, flops=0.0, err=0.0)
    pre = dict(ms=0.0, plain=0.0, bytes=0.0, flops=0.0, err=0.0)
    for n_per, out in ((512, 7), (128, 14)):
        n = batch * n_per
        rois = random_rois(g, n, image, 5.0).to(dev)
        bidx = torch.arange(batch, device=dev).repeat_interleave(n_per).to(torch.int32)
        lvl = roi_align.roi_levels(rois, min_level, max_level)
        per_level = torch.bincount(lvl.long(), minlength=n_levels)
        if not bool((per_level > 0).all()):
            raise AssertionError(f"RoIs miss a level: {per_level.tolist()}")
        args = (levels, rois, bidx, (out, out), strides)
        got = roi_align.multilevel_roi_align_cuda(*args, **span)
        want = roi_align.multilevel_roi_align(*args, **span)
        torch.cuda.synchronize()
        err_f = max_err(got, want)
        del want
        grad = torch.randn(n, out, out, C, generator=g).to(dev)
        bargs = (grad, shapes, rois, bidx, (out, out), strides)
        # K4's pre-pass kernel against its plain twin: the same integers
        pargs = (shapes, rois, bidx, (out, out), strides)
        key, fp = roi_align.roi_footprints_cuda(*pargs, **span)
        b64 = bidx.long()
        want_key = torch.where((b64 >= 0) & (b64 < batch), lvl.long() * batch + b64,
                               torch.full_like(b64, n_levels * batch))
        plain_pre = lambda: (want_key.to(torch.int32),  # noqa: E731
                             roi_align.roi_footprints(shapes, rois, lvl, (out, out), strides))
        want_fp = plain_pre()[1]
        pre_diff = int((key != want_key).sum()) + int((fp != want_fp).sum())
        pre_err = max(max_err(key, want_key), max_err(fp, want_fp))
        tp = dict(ms=cuda_ms(lambda: roi_align.roi_footprints_cuda(*pargs, **span)),
                  plain=cuda_ms(plain_pre))
        p_bytes = n * (16 + 4 + 4 + 4 + 16)
        b, by = bound_ms(p_bytes, n * 2 * 12)
        emit("kernel", name=f"K4 pre-pass roi_footprints {out}x{out}{label}", rois=n,
             levels=[min_level, max_level], mismatches=pre_diff, max_abs_err=pre_err,
             ms=tp["ms"], plain_ms=tp["plain"], library_ms=None, library="none",
             bound_ms=b, bound_by=by)
        if pre_diff:
            raise AssertionError(f"K4 pre-pass {out}x{out}{label} differs from its plain twin "
                                 f"in {pre_diff} integers")
        pre["ms"] += tp["ms"]
        pre["plain"] += tp["plain"]
        pre["bytes"] += p_bytes
        pre["flops"] += n * 2 * 12
        pre["err"] = max(pre["err"], pre_err)
        got_b = roi_align.multilevel_roi_align_backward_cuda(*bargs, **span)
        again_b = roi_align.multilevel_roi_align_backward_cuda(*bargs, **span)
        want_b = roi_align.multilevel_roi_align_backward(*bargs, **span)
        torch.cuda.synchronize()
        err_b = max(max_err(a, w) for a, w in zip(got_b, want_b))
        scale_b = max(float(w.abs().max()) for w in want_b)
        # K4 owns each output element and sums in a fixed order: two launches
        # on the same inputs must agree to the bit
        bit_diff = sum(int((a != r).sum()) for a, r in zip(got_b, again_b))
        del got_b, again_b, want_b
        # float32 rounding of sums of up to a few hundred contributions, in
        # another order than the plain version's, hence 1e-4 absolute
        tol_f, tol_b = 1e-4, 1e-4
        t = dict(ms=cuda_ms(lambda: roi_align.multilevel_roi_align_cuda(*args, **span),
                            iters=10),
                 plain=cuda_ms(lambda: roi_align.multilevel_roi_align(*args, **span), warmup=1,
                               iters=3),
                 us=kernel_us(lambda: roi_align.multilevel_roi_align_cuda(*args, **span),
                              "multilevel_roi_align_kernel", iters=5))
        tb = dict(ms=cuda_ms(lambda: roi_align.multilevel_roi_align_backward_cuda(
                      *bargs, **span), iters=10),
                  plain=cuda_ms(lambda: roi_align.multilevel_roi_align_backward(*bargs, **span),
                                warmup=1, iters=3),
                  us=kernel_us(lambda: roi_align.multilevel_roi_align_backward_cuda(
                      *bargs, **span), "multilevel_roi_align_backward_kernel", iters=5))
        cells = touched_cells(levels, rois, bidx, (out, out), strides, min_level=min_level,
                              max_level=max_level)
        out_bytes = n * out * out * C * 4
        io_bytes = rois.numel() * 4 + bidx.numel() * 4
        f_bytes, f_flops = cells * C * 4 + io_bytes + out_bytes, n * out * out * C * (8 * 4 + 1)
        b_bytes, b_flops = out_bytes + io_bytes + level_bytes, n * out * out * C * (8 * 4 + 1)
        for name, tm, nb, nf, err, tol in (
                (f"K3 multilevel_roi_align {out}x{out}{label}", t, f_bytes, f_flops, err_f,
                 tol_f),
                (f"K4 multilevel_roi_align_backward {out}x{out}{label}", tb, b_bytes, b_flops,
                 err_b, tol_b)):
            b, by = bound_ms(nb, nf)
            emit("kernel", name=name, rois=n, shape=[batch, image, image, C],
                 levels=[min_level, max_level], rois_per_level=per_level.tolist(),
                 max_abs_err=err, atol=tol, ms=tm["ms"], kernel_device_us=tm["us"],
                 plain_ms=tm["plain"], library_ms=None, library="none (no torchvision)",
                 bound_ms=b, bound_by=by,
                 **({"grad_max_abs": scale_b, "second_launch_bits_differ": bit_diff}
                    if "K4" in name else {"touched_cells": cells}))
            if not err <= tol:
                raise AssertionError(f"{name} disagrees with its plain version: {err} > {tol}")
        if bit_diff:
            raise AssertionError(f"K4 {out}x{out}{label}: two launches on the same inputs "
                                 f"differ in {bit_diff} elements")
        for acc, tm, nb, nf, err in ((fwd, t, f_bytes, f_flops, err_f),
                                     (bwd, tb, b_bytes, b_flops, err_b)):
            acc["ms"] += tm["ms"]
            acc["plain"] += tm["plain"]
            acc["bytes"] += nb
            acc["flops"] += nf
            acc["err"] = max(acc["err"], err)
    rows = {}
    for name, acc in (("multilevel_roi_align", fwd), ("multilevel_roi_align_backward", bwd),
                      ("roi_footprints", pre)):
        b, by = bound_ms(acc["bytes"], acc["flops"])
        rows[name] = dict(max_abs_err=acc["err"], ms=acc["ms"], plain_ms=acc["plain"],
                          bound_ms=b, bound_by=by, library_ms=None)
    return rows


def mobile_kernel_phase(dev) -> dict[str, dict]:
    """Phase mobile_kernel: K3 (7 x 7 and 14 x 14), K4 and K4's pre-pass on
    the MobileNetV3 detector's pooled pyramid, p4 and p5 (strides 16 and 32,
    ``min_level`` 4) of 16 images of 640 x 640, at the training step's RoI
    counts, each against its plain version: rows with the suffix
    ``_mobile``."""
    import torch

    rows = roi_kernel_rows(dev, torch.Generator().manual_seed(9), (16, 32), 4, 5,
                           label=" mobile p4-p5")
    return {f"{name}_mobile": row for name, row in rows.items()}


def edge_phase(dev) -> None:
    """Phase 2, edges: K2 and K3 at shapes no path of the port gives them yet,
    each against its plain version: K2 at K = 1, 65 (a ragged last word),
    2049 (two words a lane) and 5000 (past the default 48 KB of shared
    memory), and at threshold 0 (outside the IoU test's division-free
    range); K3 with C = 12 (channel groups that do not fill a warp), a 7 x 5
    output, 2 levels and sampling ratios 1 and 3 (the kernel's generic S, a
    mean that is not a power of two)."""
    import torch
    from pets_face_recognition_tpu_torch.kernel_ab import random_rois
    from pets_face_recognition_tpu_torch.ops import nms, roi_align

    g = torch.Generator().manual_seed(5)
    k2 = {}
    for K, thr in ((1, 0.7), (65, 0.7), (65, 0.0), (2049, 0.5), (5000, 0.7)):
        boxes = random_rois(g, 3 * K, IMAGE_TRAIN, 4.0).reshape(3, K, 4).contiguous().to(dev)
        valid = (torch.rand(3, K, generator=g) > 0.1).to(dev)
        got = nms.nms_keep_sorted_batch_cuda(boxes, valid, thr)
        k2[f"K={K} thr={thr}"] = int((got != nms.nms_keep_sorted_batch(boxes, valid, thr)).sum())
    levels = [torch.randn(2, s, s, 12, generator=g).to(dev) for s in (40, 20)]
    rois = random_rois(g, 40, IMAGE, 3.0).to(dev)
    bidx = (torch.arange(40) % 2).to(torch.int32).to(dev)
    k3 = {}
    for S in (1, 3):
        args = (levels, rois, bidx, (7, 5), (8, 16), S, 224.0, 4, 3, 4)
        k3[S] = max_err(roi_align.multilevel_roi_align_cuda(*args),
                        roi_align.multilevel_roi_align(*args))
    torch.cuda.synchronize()
    emit("edge", k2_mismatches=k2, k3_max_abs_err=k3, k3_atol=1e-4)
    if any(k2.values()):
        raise AssertionError(f"K2 keep masks differ from the plain version: {k2}")
    if not all(e <= 1e-4 for e in k3.values()):
        raise AssertionError(f"K3 disagrees with its plain version: {k3}")


def touched_cells(levels, rois, bidx, output_size, strides, s: int = 2, min_level: int = 2,
                  max_level: int = 5) -> int:
    """Distinct (image, level, y, x) cells that the bilinear taps read."""
    import torch
    from pets_face_recognition_tpu_torch.ops.roi_align import _sample_offsets, roi_levels

    oh, ow = output_size
    lvl = roi_levels(rois, min_level, max_level).long()
    keys = []
    for li, f in enumerate(levels):
        sel = lvl == li
        if not sel.any():
            continue
        H, W = f.shape[1], f.shape[2]
        r = rois[sel] / strides[li]
        roi_w = (r[:, 2] - r[:, 0]).clamp(min=1.0)
        roi_h = (r[:, 3] - r[:, 1]).clamp(min=1.0)
        ys = r[:, 1:2] + _sample_offsets(oh, s, f.device)[None] * (roi_h / oh)[:, None]
        xs = r[:, 0:1] + _sample_offsets(ow, s, f.device)[None] * (roi_w / ow)[:, None]
        yy, xx = ys[:, :, None].expand(-1, -1, ow * s), xs[:, None, :].expand(-1, oh * s, -1)
        ok = ~((yy <= -1) | (yy >= H) | (xx <= -1) | (xx >= W))
        y0 = yy.clamp(min=0).floor().clamp(max=H - 1).long()
        x0 = xx.clamp(min=0).floor().clamp(max=W - 1).long()
        bb = bidx[sel].long()[:, None, None].expand_as(y0)
        for dy in (0, 1):
            for dx in (0, 1):
                yi = (y0 + dy).clamp(max=H - 1)
                xi = (x0 + dx).clamp(max=W - 1)
                keys.append((((bb * 4 + li) * 4096 + yi) * 4096 + xi)[ok])
    return int(torch.unique(torch.cat(keys)).numel()) if keys else 0


@contextlib.contextmanager
def tf32_watch(model):
    """Record the TF32 switches that ``model``'s forward sees (a forward
    pre-hook) while the block calls an entry point; raise if TF32 was on in
    any call, or if the caller's switches were not back afterwards."""
    from pets_face_recognition_tpu_torch.device import float32_flags, tf32_flags

    seen = []
    caller = tf32_flags()
    handle = model.register_forward_pre_hook(lambda m, a: seen.append(tf32_flags()))
    record = {"caller": caller, "inside": seen}
    try:
        yield record
    finally:
        handle.remove()
    record["after"] = tf32_flags()
    record["inside"] = seen[0] if seen else None
    if not seen or any(s != float32_flags() for s in seen):
        raise AssertionError(f"TF32 switches inside the entry point: {seen[:1]}, "
                             f"expected {float32_flags()}")
    if record["after"] != caller:
        raise AssertionError(f"TF32 switches not restored: {record['after']} != {caller}")


def e2e_phase(dev, kernels_mod, smi: str, kind: str = "resnet50", phase: str = "e2e",
              timed_batches: tuple[int, ...] = (B_TIMED,)) -> dict:
    """Phase 3: the serving path at full width (``detector_kind`` ``kind``),
    its launch counts and checks, then crops/s at each of ``timed_batches``."""
    import torch
    from pets_face_recognition_tpu_torch.device import float32_matmuls
    from pets_face_recognition_tpu_torch.kernel_ab import similarity_landmarks
    from pets_face_recognition_tpu_torch.ops.homography import align_crop
    from pets_face_recognition_tpu_torch.serving import EmbeddingService, build_serving_models

    t0 = time.perf_counter()
    detector, embedder, base = build_serving_models(device=dev, seed=0, detector_kind=kind)
    service = EmbeddingService(detector, embedder, base, device=dev, warp_dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    imgs8 = torch.randint(0, 256, (B_KERNELS, IMAGE, IMAGE, 3), generator=g,
                          dtype=torch.uint8).to(dev)
    ok8 = torch.ones(B_KERNELS, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    with tf32_watch(detector) as flags:
        kernels_mod.reset_launch_counts()
        emb, valid = service.embed_batch(imgs8, ok8)
        torch.cuda.synchronize()
        launches = kernels_mod.launch_counts()
    if emb.shape != (B_KERNELS, 512) or valid.shape != (B_KERNELS,):
        raise AssertionError(f"bad shapes {tuple(emb.shape)} {tuple(valid.shape)}")
    if not bool(torch.isfinite(emb[valid]).all()):
        raise AssertionError("non-finite embeddings on valid rows")
    missing = [k for k in ("warp_perspective_batch", "nms_keep_sorted_batch",
                           "multilevel_roi_align") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: {missing}")
    if detector.training or any(m.training for m in detector.modules()):
        raise AssertionError("the serving detector is not in eval mode")
    emit(phase, detector=kind, batch=B_KERNELS, launches=launches, valid_rows=int(valid.sum()),
         model_build_s=build_s, tf32_flags=flags)

    # reference: the same seeded models on the CPU (plain versions), B = 2
    det_cpu, emb_cpu, base_cpu = build_serving_models(device="cpu", seed=0, detector_kind=kind)
    x = imgs8[:2].float() / 255.0
    # the models called directly, not through an entry point: float32 as there
    with torch.inference_mode(), float32_matmuls():
        d_gpu = detector(x)
        d_cpu = det_cpu(x.cpu())
        feats_gpu = detector.backbone(x.permute(0, 3, 1, 2))
        feats_cpu = det_cpu.backbone(x.cpu().permute(0, 3, 1, 2))
        pyr_rel = max(max_err(feats_gpu[k].cpu(), feats_cpu[k])
                      / float(feats_cpu[k].abs().max()) for k in feats_cpu)
        score_err = max_err(d_gpu["scores"].cpu(), d_cpu["scores"])
        lms = similarity_landmarks(torch.Generator().manual_seed(2), 2, base_cpu, IMAGE)
        crops_gpu = align_crop(x, lms.to(dev), base, (CROP, CROP))
        crops_cpu = align_crop(x.cpu(), lms, base_cpu, (CROP, CROP))
        crop_err = max_err(crops_gpu.cpu(), crops_cpu)
        e_gpu, e_cpu = embedder(crops_gpu).cpu(), emb_cpu(crops_cpu)
        emb_rel = max_err(e_gpu, e_cpu) / float(e_cpu.abs().max())
        box_err = max_err(d_gpu["boxes"].cpu(), d_cpu["boxes"])
        kp_err = max_err(d_gpu["keypoints"].cpu(), d_cpu["keypoints"])
    # crops: the CPU and the card solve the 8x8 homography system with other
    # float32 LU codes; ~1e-6 relative in H moves corner samples by up to
    # ~1e-3 px on a [0, 1] noise image, hence 1e-3 (as the CPU parity test)
    checks = dict(pyramid_rel_err=pyr_rel, top_score_abs_err=score_err,
                  crop_abs_err=crop_err, embedding_rel_err=emb_rel)
    emit(f"{phase}_reference", batch=2, **checks, tolerances=dict(
        pyramid_rel_err=1e-3, top_score_abs_err=1e-3, crop_abs_err=1e-3,
        embedding_rel_err=1e-3), top_box_abs_err_px=box_err,
        keypoint_abs_err_px=kp_err,
        note="boxes and keypoints are argmax picks and are reported, not held: "
             "a near-tie may pick another candidate")
    for name, tol in (("pyramid_rel_err", 1e-3), ("top_score_abs_err", 1e-3),
                      ("crop_abs_err", 1e-3), ("embedding_rel_err", 1e-3)):
        if not checks[name] <= tol:
            raise AssertionError(f"{name} {checks[name]} > {tol}")

    del det_cpu, emb_cpu
    for B in timed_batches:
        imgs = torch.randint(0, 256, (B, IMAGE, IMAGE, 3), generator=g,
                             dtype=torch.uint8).to(dev)
        ok = torch.ones(B, dtype=torch.bool, device=dev)
        service.embed_batch(imgs, ok)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t = time.perf_counter()
            emb, valid = service.embed_batch(imgs, ok)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        if not bool(torch.isfinite(emb[valid]).all()):
            raise AssertionError(f"non-finite embeddings on valid rows at B={B}")
        step = statistics.median(times)
        emit(f"{phase}_timed", detector=kind, batch=B, step_ms=step * 1e3,
             step_ms_all=[t * 1e3 for t in times], crops_per_s=B / step,
             valid_rows=int(valid.sum()), card=smi,
             precision="float32: TF32 off inside embed_batch, torch's defaults outside",
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del imgs, emb, valid
    del detector, embedder, service
    torch.cuda.empty_cache()
    return launches


# bf16_serve: the card against the CPU on the same bfloat16 models, relative
# to the largest magnitude (the pyramid, the RPN logits, the box logits and
# keypoint heatmaps on the CPU's top boxes with the decisions forced, and the
# embeddings of shared crops), each within this many times bfloat16's own
# move from float32 (the CPU's float32 models against its bfloat16 ones): the
# two devices round the same float32 sums of other orders to bfloat16, each
# such rounding a whole bfloat16 step, as far as float32 is from bfloat16
BF16_SPREAD_FACTOR = 2.0
# the kernels of one served batch at JAX's accelerator defaults
BF16_SERVE_LAUNCHES = {"warp_perspective_batch_bf16": 1, "nms_keep_sorted_batch": 1,
                       "multilevel_roi_align_bf16": 2}


def heads_on(det, x, boxes) -> dict:
    """``det``'s values behind its discrete decisions on NHWC ``x``, with the
    decisions forced: the pyramid levels, the RPN logits, and the box
    logits and keypoint heatmaps of one given box an image (``boxes (B, 4)``),
    pooled from ``det``'s own pyramid."""
    import torch

    feats = det.backbone(x.permute(0, 3, 1, 2))
    names = sorted(feats, key=lambda n: int(n[1:]))
    objectness, _ = det.rpn([feats[n] for n in names])
    strides = [x.shape[1] // feats[n].shape[2] for n in names]
    pool = (names[:-1], [feats[n].permute(0, 2, 3, 1).contiguous() for n in names[:-1]])
    bidx = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    heads = det.roi_heads
    logits, _ = heads.box_predictor(heads.box_head(
        det._roi_align(pool, strides, boxes, bidx, (7, 7))))
    heat = heads.keypoint_predictor(heads.keypoint_head(
        det._roi_align(pool, strides, boxes, bidx, (14, 14)).permute(0, 3, 1, 2)))
    out = {f"pyramid_{n}_rel_err": feats[n] for n in names}
    out.update(rpn_logits_rel_err=objectness, box_logits_rel_err=logits,
               heatmaps_rel_err=heat)
    return out


def moved_detections(d_a: dict, d_b: dict) -> list[bool]:
    """Images whose top detection differs between two runs: its box by more
    than 1 px or its landmarks, rounded to the pixel grid as the service
    rounds them. Such an image took another discrete decision (a near-tie of
    bfloat16 logits in a top-k or an argmax), which moves its score and
    landmarks by whole steps; the decision is counted, not held."""
    import torch

    box = (d_a["boxes"][:, 0].float().cpu() - d_b["boxes"][:, 0].float().cpu()).abs().amax(-1)
    kp = torch.round(d_a["keypoints"][:, 0, :, :2].cpu()) != torch.round(
        d_b["keypoints"][:, 0, :, :2].cpu())
    return [bool(m) for m in (box > 1.0) | kp.flatten(1).any(1)]


def bf16_serve_phase(dev, kernels_mod, smi: str) -> dict[str, dict]:
    """Phase bf16_serve: the served cell at the JAX package's accelerator
    defaults, the keypoint R-CNN ResNet-50-FPN and the ResNet-50 -> 512
    embedder at ``dtype=bfloat16`` and ``EmbeddingService``'s default
    ``warp_dtype`` (bfloat16), B = 32 x 320 x 320, seeded random weights.
    Gates: one batch's launches (K1-bf16 1, K2 1, K3-bf16 2), and finite
    embeddings of its kept rows whose crops are finite (a kept row's crop is
    NaN where its rounded landmarks are collinear); the card against
    the CPU on the same bfloat16 models (B = 2: the top detections' moved
    decisions counted; the pyramid, the RPN logits, and the box logits and
    keypoint heatmaps on the CPU's top boxes, the decisions forced; the
    embeddings of shared crops; each relative to its largest magnitude and
    held within twice bfloat16's own move from float32 on the CPU); one batch at
    ``warp_dtype=torch.int8`` (its launches, and its crops within JAX's 1.2e-2
    of the float32 warp's on the same landmarks); ``Preproc3`` on 8 photos with
    ``PFR_INPUT_DTYPE=bfloat16`` (its launches, and, the bfloat16 detector's
    first layer rounding its input to bfloat16 anyway, the same landmarks and
    bit-equal crops as with float32 input, both under deterministic cuDNN). Reports, against the float32
    service on the same weights and batch: embedding drift max(1 - cos),
    landmarks moved, and crops/s in paired rounds; and the peak memory. It
    gates no speed and claims no gain."""
    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch.device import float32_matmuls
    from pets_face_recognition_tpu_torch.kernel_ab import similarity_landmarks
    from pets_face_recognition_tpu_torch.ops.homography import align_crop
    from pets_face_recognition_tpu_torch.preprocessor import Preproc3
    from pets_face_recognition_tpu_torch.serving import EmbeddingService, build_serving_models

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    det16, emb16, base = build_serving_models(device=dev, seed=0, dtype=bf16)
    det32, emb32, _ = build_serving_models(device=dev, seed=0)
    svc16 = EmbeddingService(det16, emb16, base, device=dev, score_thr=0.0)
    svc32 = EmbeddingService(det32, emb32, base, device=dev, score_thr=0.0,
                             warp_dtype=torch.float32)
    g = torch.Generator().manual_seed(5)
    imgs = torch.randint(0, 256, (B_TIMED, IMAGE, IMAGE, 3), generator=g,
                         dtype=torch.uint8).to(dev)
    ok = torch.ones(B_TIMED, dtype=torch.bool, device=dev)
    svc16.embed_batch(imgs, ok)   # warm-up: cuDNN's first bf16 use
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tf32_watch(det16) as flags:
        kernels_mod.reset_launch_counts()
        e16, v16 = svc16.embed_batch(imgs, ok)
        torch.cuda.synchronize()
        launches = kernels_mod.launch_counts()
    peak16 = torch.cuda.max_memory_allocated() / 2 ** 30
    if {k: v for k, v in launches.items() if v} != BF16_SERVE_LAUNCHES:
        raise AssertionError(f"bf16 serving launches {launches}, expected {BF16_SERVE_LAUNCHES}")
    if e16.dtype != torch.float32:
        raise AssertionError(f"bf16 service: float32 embeddings expected, got {e16.dtype}")
    torch.cuda.reset_peak_memory_stats()
    e32, v32 = svc32.embed_batch(imgs, ok)
    torch.cuda.synchronize()
    peak32 = torch.cuda.max_memory_allocated() / 2 ** 30
    x = imgs.float() / 255.0
    with torch.inference_mode(), float32_matmuls():
        d16, d32 = det16(x), det32(x)
    # rows both keep whose embeddings are finite in both (a kept row's crop is
    # NaN where its rounded landmarks are collinear)
    finite16, finite32 = torch.isfinite(e16).all(1), torch.isfinite(e32).all(1)
    both = v16 & v32 & finite16 & finite32
    cos = torch.nn.functional.cosine_similarity(e16[both], e32[both], dim=-1)
    moved_vs_f32 = moved_detections(d16, d32)
    kp_px = float((d16["keypoints"][:, 0, :, :2] - d32["keypoints"][:, 0, :, :2]).abs().max())
    def wall_ms(svc) -> float:
        """Median host-clock ms of 3 synchronised ``embed_batch`` calls."""
        times = []
        for _ in range(3):
            t = time.perf_counter()
            svc.embed_batch(imgs, ok)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    # float32 and bfloat16 services in alternating order, 5 rounds
    pairs = [(wall_ms(svc32), wall_ms(svc16)) if r % 2 == 0
             else tuple(reversed((wall_ms(svc16), wall_ms(svc32)))) for r in range(5)]
    f32_ms = statistics.median(a for a, _ in pairs)
    bf16_ms = statistics.median(b for _, b in pairs)

    # the card against the CPU, the same bfloat16 models (plain versions); the
    # CPU's float32 models give bfloat16's own move for each quantity
    det_c, emb_c, base_c = build_serving_models(device="cpu", seed=0, dtype=bf16)
    det_c32, emb_c32, _ = build_serving_models(device="cpu", seed=0)
    xc = x[:2].cpu()

    def rel(a, b) -> float:
        return max_err(a.cpu(), b) / float(b.float().abs().max())

    with torch.inference_mode(), float32_matmuls():
        dg, dc = det16(x[:2]), det_c(xc)
        moved = moved_detections(dg, dc)
        # the values behind each discrete decision, with the decisions forced
        # to the CPU's: the pyramid, the RPN logits, and the box logits and
        # keypoint heatmaps on the CPU's top boxes
        boxes = dc["boxes"][:, 0].contiguous()
        forced_g = heads_on(det16, x[:2], boxes.to(dev))
        forced_c = heads_on(det_c, xc, boxes)
        forced_32 = heads_on(det_c32, xc, boxes)
        lms = similarity_landmarks(torch.Generator().manual_seed(2), 2, base_c, IMAGE)
        crops_c = align_crop(xc, lms, base_c, (CROP, CROP))
        crops_g = align_crop(x[:2], lms.to(dev), base, (CROP, CROP), compute_dtype=bf16)
        crop_drift = max_err(crops_g.cpu(), crops_c)
        forced_g["embedding_rel_err"] = emb16(crops_c.to(dev))
        forced_c["embedding_rel_err"] = emb_c(crops_c)
        forced_32["embedding_rel_err"] = emb_c32(crops_c)
    checks = {k: rel(forced_g[k], forced_c[k]) for k in forced_c}
    spread = {k: rel(forced_32[k], forced_c[k]) for k in forced_c}
    del det_c, emb_c, det_c32, emb_c32

    # one batch with K1 in int8, against the float32 warp on the same landmarks
    svc8 = EmbeddingService(det16, emb16, base, device=dev, score_thr=0.0,
                            warp_dtype=torch.int8)
    kernels_mod.reset_launch_counts()
    _, v8 = svc8.embed_batch(imgs, ok)
    torch.cuda.synchronize()
    launches_int8 = kernels_mod.launch_counts()
    want_int8 = dict(BF16_SERVE_LAUNCHES, warp_perspective_batch_int8=1)
    del want_int8["warp_perspective_batch_bf16"]
    kps = torch.round(d16["keypoints"][:, 0, :, :2])
    with torch.inference_mode():
        crops = {cd: align_crop(x, kps, base, (CROP, CROP), compute_dtype=cd)
                 for cd in (torch.float32, torch.bfloat16, torch.int8)}
    fin = torch.isfinite(crops[torch.float32]).flatten(1).all(1) & v16
    drift = {str(cd).split(".")[-1]: max_err(crops[cd][fin], crops[torch.float32][fin])
             for cd in (torch.bfloat16, torch.int8)}
    # the embedder leaves no finite crop of a kept row non-finite
    crop16_ok = torch.isfinite(crops[torch.bfloat16]).flatten(1).all(1)
    bad_rows = int((v16 & crop16_ok & ~finite16).sum())

    # PFR_INPUT_DTYPE=bfloat16 through Preproc3 with the bfloat16 detector
    photos = list(imgs[:B_KERNELS].cpu().numpy())
    pre = Preproc3(det16, thr=0.0, device=dev)
    saved_env = os.environ.pop("PFR_INPUT_DTYPE", None)
    try:
        # deterministic cuDNN for both runs: cuDNN's default algorithm for the
        # keypoint predictor's transposed conv sums in a run-dependent order,
        # which moves heatmap values (and, at near-ties, landmarks) by rounding
        with deterministic_cudnn():
            a32, ok32, raw32 = pre.batch(photos)
            os.environ["PFR_INPUT_DTYPE"] = "bfloat16"
            kernels_mod.reset_launch_counts()
            a16, ok16, raw16 = pre.batch(photos)
            torch.cuda.synchronize()
            launches_input = kernels_mod.launch_counts()
    finally:
        os.environ.pop("PFR_INPUT_DTYPE", None)
        if saved_env is not None:
            os.environ["PFR_INPUT_DTYPE"] = saved_env
    want_input = {"nms_keep_sorted_batch": 1, "multilevel_roi_align_bf16": 2,
                  "warp_perspective_batch": int(ok16.sum())}
    # NaN crops (collinear landmarks) count as equal to NaN
    input_same = (bool((ok32 == ok16).all())
                  and bool(np.array_equal(raw32["keypoints"], raw16["keypoints"]))
                  and bool(((a32 == a16) | (a32.isnan() & a16.isnan())).all()))

    gates = dict(launches=launches, launches_int8=launches_int8,
                 launches_input_bf16=launches_input,
                 **checks, crop_drift_card_bf16_vs_cpu_f32=crop_drift,
                 crop_drift_from_float32=drift, input_bf16_same_as_float32=input_same)
    emit("bf16_serve", card=smi, batch=B_TIMED, image=IMAGE, dtype="bfloat16",
         warp_dtype="bfloat16", gates=gates,
         tolerances=dict(card_vs_cpu_within=f"{BF16_SPREAD_FACTOR} x bfloat16's own move "
                         "from float32 on the CPU", bfloat16_own_move=spread,
                         crop_drift_from_float32=K1_MODE_DRIFT),
         card_vs_cpu=dict(batch=2, moved_decisions=sum(moved), moved=moved,
                          top_box_abs_err_px=max_err(dg["boxes"].cpu(), dc["boxes"]),
                          keypoint_abs_err_px=max_err(dg["keypoints"].cpu(), dc["keypoints"])),
         vs_float32_service=dict(valid_both=int(both.sum()), valid_bf16=int(v16.sum()),
                                 valid_f32=int(v32.sum()),
                                 embedding_drift_max_1_minus_cos=float((1 - cos).max())
                                 if len(cos) else None,
                                 detections_moved=sum(moved_vs_f32),
                                 keypoint_max_abs_px=kp_px,
                                 crops_per_s_f32=B_TIMED * 1e3 / f32_ms,
                                 crops_per_s_bf16=B_TIMED * 1e3 / bf16_ms,
                                 step_ms_f32=f32_ms, step_ms_bf16=bf16_ms, paired_ms=pairs,
                                 peak_mem_gib_bf16=peak16, peak_mem_gib_f32=peak32),
         kept_not_finite=dict(bf16=int((v16 & ~finite16).sum()),
                              f32=int((v32 & ~finite32).sum()),
                              bf16_with_finite_crop=bad_rows),
         int8_valid=int(v8.sum()), input_bf16_valid=int(ok16.sum()),
         tf32_flags=flags, seconds=time.perf_counter() - t0)
    for name, value in checks.items():
        if not value <= BF16_SPREAD_FACTOR * spread[name]:
            raise AssertionError(f"bf16_serve {name} {value} > {BF16_SPREAD_FACTOR} x "
                                 f"bfloat16's own move {spread[name]}")
    if not crop_drift <= K1_MODE_DRIFT["bfloat16"]:
        raise AssertionError(f"bf16_serve: K1-bf16 crops {crop_drift} from the CPU's float32")
    if {k: v for k, v in launches_int8.items() if v} != want_int8:
        raise AssertionError(f"int8 warp launches {launches_int8}, expected {want_int8}")
    if {k: v for k, v in launches_input.items() if v} != {k: v for k, v in want_input.items()
                                                          if v}:
        raise AssertionError(f"PFR_INPUT_DTYPE launches {launches_input}, expected {want_input}")
    for label, d in drift.items():
        if not d <= K1_MODE_DRIFT[label]:
            raise AssertionError(f"bf16_serve: {label} warp moves crops by {d} from float32")
    if not input_same:
        raise AssertionError("PFR_INPUT_DTYPE=bfloat16 changed the bfloat16 detector's output")
    if bad_rows:
        raise AssertionError(f"bf16 service: {bad_rows} kept rows with finite crops embed "
                             "to non-finite values")
    del det16, emb16, det32, emb32, svc16, svc32, svc8
    torch.cuda.empty_cache()
    return {"bf16_serve": launches, "bf16_serve_int8": launches_int8,
            "bf16_serve_input": launches_input}


CORPUS = REPO / "pets_face_recognition_tpu_torch" / "testdata" / "kashtanka_test"
VARIANTS = REPO / "pets_face_recognition_tpu_torch" / "testdata" / "jpeg_variants"
OUT_DIR = REPO / "smoke_out" / "tsv"        # git-ignored
PHOTOS = REPO / "smoke_out" / "photos"      # git-ignored: written at run time
# camera photos (width, height): 4:3 at 1.2 MP, landscape and portrait, and a
# 12 MP phone photo
PHOTO_SIZES = ((1280, 960), (960, 1280), (4032, 3024))
B_STREAM, N_STREAM = 32, 512       # crops/s from JPEG files: batch, paths of the corpus
N_STREAM_PHOTOS = {(1280, 960): 64, (960, 1280): 64, (4032, 3024): 32}
# paths through PIL, for each set: one fallback run that measures the route
N_STREAM_PIL = {"320x320": 64, "1280x960": 32, "960x1280": 32, "4032x3024": 32}
Q_RETRIEVAL, G_RETRIEVAL, D_EMB = 1000, 10000, 512
# card against CPU on the same photos: aligned crops on [0, 1], embeddings
# relative to their largest magnitude, and scores (the gap across which a
# rank may flip is held to the score budget too)
CROP_DRIFT, EMB_DRIFT, SCORE_DRIFT = 1e-3, 1e-5, 1e-6


def probe_host() -> dict:
    """What this machine offers the native decode: the compiler, libjpeg's
    header and library, nvJPEG's header and library, PIL, cv2 and pandas."""
    import importlib.util

    from pets_face_recognition_tpu_torch import native

    def run(cmd):
        try:
            return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"{type(e).__name__}: {e}"

    root = native.cuda_root()
    return {
        "g++": run(["g++", "--version"]).splitlines()[:1],
        "jpeglib.h": [str(d / "jpeglib.h") for d in native._include_dirs()
                      if (d / "jpeglib.h").is_file()],
        "ldconfig_jpeg": [line.strip() for line in run(["ldconfig", "-p"]).splitlines()
                          if "jpeg" in line],
        "nvjpeg.h": str(root / "include" / "nvjpeg.h") if root and (
            root / "include" / "nvjpeg.h").is_file() else None,
        "python_modules": {m: importlib.util.find_spec(m) is not None
                           for m in ("PIL", "cv2", "pandas")},
    }


def pil_decode(path):
    from PIL import Image
    import numpy as np

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def decode_vs_pil(paths) -> dict | None:
    """Pixel difference of this machine's native decode from PIL's libjpeg,
    where PIL is installed (a measurement, not a gate)."""
    import numpy as np

    from pets_face_recognition_tpu_torch import native

    try:
        import PIL  # noqa: F401
    except ImportError:
        return None
    diffs, failed = [], []
    for p in paths:
        ref = pil_decode(p).astype(np.int16)
        got = native.decode_single(p)
        if got is None or got.shape != ref.shape:
            failed.append(p.name)
            continue
        diffs.append(np.abs(got.astype(np.int16) - ref).ravel())
    d = np.concatenate(diffs) if diffs else np.zeros(1, np.int16)
    return {"images": len(paths), "failed": failed, "max_abs": int(d.max()),
            "mean_abs": float(d.mean()), "share_differing": float((d > 0).mean())}


def make_photo_corpus(root: Path, seed: int = 7) -> Path:
    """Write a kashtanka-layout test split of camera-sized JPEGs with PIL, from
    ``seed``: on each side 2 query and 2 gallery cards (a dog and a cat each),
    2 photos a card, their sizes cycling through ``PHOTO_SIZES``. A photo is a
    smooth random colour field with a darker ellipse and per-pixel noise of
    +-10 levels, saved at quality 90 with 4:2:0 chroma (a 12 MP one is ~3 MB,
    as a phone's). Returns ``root``."""
    import shutil

    import numpy as np
    from PIL import Image, ImageDraw

    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.RandomState(seed)
    k = 0
    for side, prefix in (("found", "rf"), ("lost", "rl")):
        for j, sub in enumerate((side, f"extra_{side}")):
            for i in range(2):
                card = root / side / sub / f"{prefix}9{j}{i:04d}"
                card.mkdir(parents=True)
                (card / "card.json").write_text('{"animal": %d}' % (1 + i))
                for n in range(2):
                    w, h = PHOTO_SIZES[k % len(PHOTO_SIZES)]
                    k += 1
                    field = rng.uniform(40, 215, (3, 4, 3)).astype(np.uint8)
                    img = Image.fromarray(field).resize((w, h), Image.BICUBIC)
                    cx, cy = rng.uniform(0.3, 0.7) * w, rng.uniform(0.3, 0.7) * h
                    r = rng.uniform(0.15, 0.3) * min(w, h)
                    fill = tuple(int(v) for v in rng.uniform(20, 90, 3))
                    ImageDraw.Draw(img).ellipse((cx - r, cy - 0.8 * r, cx + r, cy + 0.8 * r),
                                                fill=fill)
                    px = np.asarray(img, np.int16) + rng.randint(-10, 11, (h, w, 3),
                                                                 dtype=np.int16)
                    Image.fromarray(np.clip(px, 0, 255).astype(np.uint8)).save(
                        card / f"{n}.jpg", quality=90, subsampling=2)
    return root


def photo_sizes() -> dict:
    """``{path: (width, height)}`` of the camera photos, from their headers."""
    from PIL import Image

    sizes = {}
    for p in sorted(PHOTOS.rglob("*.jpg")):
        with Image.open(p) as im:
            sizes[p] = im.size
    return sizes


@contextlib.contextmanager
def chain_probe(sync):
    """Record each photo's steps inside ``generate_tsv.prepare_data`` in the
    order it reads them: the photo's (width, height), the seconds of its decode
    (``read_image``), of ``Preproc3`` (``Preproc3.batch``, the device
    synchronised after it) and of the whole head pipeline call, and what they
    gave (valid, rounded landmarks, the aligned crop, the vector). The timers
    wrap the chain's own calls, so the steps are timed in the pass whose total
    is the chain's time. Yields ``(records, wrap)``: ``wrap(head)`` is the head
    pipeline with its timer."""
    from pets_face_recognition_tpu_torch import generate_tsv
    from pets_face_recognition_tpu_torch.preprocessor import Preproc3

    rec: list[dict] = []
    read, batch = generate_tsv.read_image, Preproc3.batch

    def timed_read(path):
        t = time.perf_counter()
        img = read(path)
        rec.append(dict(size=(img.shape[1], img.shape[0]), decode=time.perf_counter() - t))
        return img

    def timed_batch(self, images):
        t = time.perf_counter()
        aligned, valid, raw = batch(self, images)
        sync()
        rec[-1].update(preproc3=time.perf_counter() - t, valid=bool(valid[0]),
                       kps=raw["keypoints"][0], crop=aligned[0])
        return aligned, valid, raw

    def wrap(head):
        def timed_head(img, animal):
            t = time.perf_counter()
            v = head(img, animal)
            rec[-1].update(head=time.perf_counter() - t, vec=v)
            return v
        return timed_head

    generate_tsv.read_image, Preproc3.batch = timed_read, timed_batch
    try:
        yield rec, wrap
    finally:
        generate_tsv.read_image, Preproc3.batch = read, batch


def run_chain(root: Path, device, head, kernels_mod, label: str) -> dict:
    """``generate_tsv``'s steps over ``root`` with the head pipeline ``head``
    (the launch counts read around them), its tsv and score dump under
    ``OUT_DIR``, and each photo's record (``chain_probe``)."""
    import torch
    from pets_face_recognition_tpu_torch import generate_tsv, retrieval

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:   # first calls at each photo size: cuDNN's and the allocator's set-up
        firsts = {}
        for p in sorted(root.rglob("*.jpg")):
            img = generate_tsv.read_image(p)
            firsts.setdefault(img.shape, img)
        for img in firsts.values():
            for animal in (1, 2):
                head(img, animal)
        sync()
    kernels_mod.reset_launch_counts()
    with chain_probe(sync) as (rec, wrap):
        t = time.perf_counter()
        db = generate_tsv.prepare_data(root, wrap(head))
        sync()
        chain_s = time.perf_counter() - t
    launches = kernels_mod.launch_counts()
    for r in rec:
        r["crop"] = r["crop"].cpu() / 255.0
    dump = {}
    rows = retrieval.create_table(db, device, dump)
    retrieval.write_tsv(rows, OUT_DIR / f"pred_scores_test2_{label}.tsv")
    retrieval.write_scores_dump(dump, OUT_DIR / f"scores_{label}.npz")
    return dict(db=db, rows=rows, dump=dump, chain_s=chain_s, launches=launches, rec=rec)


def chain_diff(run, ref) -> dict:
    """How far ``run`` is from ``ref`` on the same photos: kept photos, rounded
    landmarks, crops, embeddings, the score dumps' near-tie report, and which
    budget each breaks."""
    import numpy as np
    from pets_face_recognition_tpu_torch import retrieval

    a, b = run["rec"], ref["rec"]
    if [r["size"] for r in a] != [r["size"] for r in b]:
        raise AssertionError("the two runs read other photos")
    both = [(x, y) for x, y in zip(a, b) if x["valid"] and y["valid"]]
    crop = max((max_err(x["crop"], y["crop"]) for x, y in both), default=0.0)
    emb = max((float(np.abs(x["vec"] - y["vec"]).max() / np.abs(y["vec"]).max())
               for x, y in both), default=0.0)
    report = retrieval.near_tie_report(ref["dump"], run["dump"])
    finite = all(np.isfinite(x["vec"]).all() for x in a if x["valid"]) and all(
        np.isfinite(row["scores"][row["include"]]).all() for row in run["dump"].values())
    d = dict(valid_differ=sum(x["valid"] != y["valid"] for x, y in zip(a, b)),
             landmarks_differ=sum(bool((x["kps"] != y["kps"]).any()) for x, y in both),
             max_crop_err=crop, max_embedding_rel_err=emb,
             max_score_drift=report["max_score_drift"],
             max_flip_gap=report["max_flip_float_gap"],
             other_cards=bool(report["only_a"] or report["only_b"] or report["gallery_only_a"]
                              or report["gallery_only_b"]))
    d["breaks"] = [k for k, bad in (
        ("finite", not finite), ("valid", d["valid_differ"] > 0), ("landmarks", d["landmarks_differ"] > 0),
        ("crops", not crop <= CROP_DRIFT), ("embeddings", not emb <= EMB_DRIFT),
        ("scores", not report["max_score_drift"] <= SCORE_DRIFT),
        ("flips", not report["max_flip_float_gap"] <= SCORE_DRIFT),
        ("cards", d["other_cards"])) if bad]
    return d | dict(near_tie=report)


def split_by_size(run) -> dict:
    """Per photo size: photos, kept photos, and the mean ms of each step inside
    the chain (decode, ``Preproc3``, the embedder: the head call less
    ``Preproc3``, on kept photos), and photos/s over decode + head calls."""
    import numpy as np

    out = {}
    for size in sorted({r["size"] for r in run["rec"]}):
        rs = [r for r in run["rec"] if r["size"] == size]
        kept = [r for r in rs if r["valid"]]
        total = sum(r["decode"] + r["head"] for r in rs)
        out["x".join(map(str, size))] = dict(
            photos=len(rs), kept=len(kept),
            decode_ms=float(np.mean([r["decode"] for r in rs])) * 1e3,
            preproc3_ms=float(np.mean([r["preproc3"] for r in rs])) * 1e3,
            embed_ms=float(np.mean([r["head"] - r["preproc3"] for r in kept])) * 1e3
            if kept else None,
            photos_per_s=len(rs) / total)
    return out


def shifted_head(detector, dog, cat, dev):
    """A planted fault for the chain's gate: the head pipeline with each map
    moved one pixel to the right in the crop."""
    import torch
    from pets_face_recognition_tpu_torch.device import float32_matmuls
    from pets_face_recognition_tpu_torch.ops.homography import (alignment_homographies,
                                                                warp_perspective_batch_cuda)
    from pets_face_recognition_tpu_torch.preprocessor import DEFAULT_BASE_PTS, Preproc3

    shift = torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], device=dev)
    base = torch.from_numpy(DEFAULT_BASE_PTS).to(dev)

    class Shifted(Preproc3):
        def batch(self, images):
            aligned, valid, raw = super().batch(images)
            if valid[0]:
                photo = torch.as_tensor(images[0]).to(dev).float()[None].contiguous()
                H = shift @ alignment_homographies(
                    torch.from_numpy(raw["keypoints"][:1]).to(dev), base)
                aligned[0] = warp_perspective_batch_cuda(photo, H.contiguous(), (CROP, CROP))[0]
            return aligned, valid, raw

    pre = Shifted(detector, thr=0.0, device=dev)
    scale = torch.full((), 255.0, device=dev)

    @torch.inference_mode()
    @float32_matmuls()
    def head(img, animal):
        try:
            aligned = pre(img)
        except (AssertionError, ValueError, OSError):
            return None
        fe = dog if animal == 1 else cat
        return fe(aligned[None] / scale)[0].cpu().numpy()

    return head


def k1_photo_rows(dev, paths) -> list[dict]:
    """K1 at B = 1 on camera photos at their own shape, as ``Preproc3`` launches
    it: held against its plain version on the card (values on [0, 1], 1e-4 as
    in the kernel phase) and timed beside it and ``grid_sample``."""
    import torch
    from pets_face_recognition_tpu_torch import native
    from pets_face_recognition_tpu_torch.kernel_ab import (cuda_ms, grid_sample_grid,
                                                           warp_read_bytes)
    from pets_face_recognition_tpu_torch.ops import homography

    base = torch.tensor([[70.0, 92.0], [154.0, 92.0], [112.0, 160.0]])
    rows = []
    for p in paths:
        img = torch.from_numpy(native.decode_single(p)).to(dev).float()[None] / 255.0
        _, H, W, _ = img.shape
        # a head a fifth of the short side wide, turned 10 degrees, off centre
        th = math.radians(10.0)
        rot = torch.tensor([[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]])
        lms = (base - base.mean(0)) * (min(H, W) / 5 / 84) @ rot.T \
            + torch.tensor([W * 0.4, H * 0.6])
        Hs = homography.alignment_homographies(lms[None].to(dev), base.to(dev))
        k1 = lambda: homography.warp_perspective_batch_cuda(img, Hs, (CROP, CROP))  # noqa: E731
        got = k1()
        want = homography.warp_perspective_batch(img, Hs, (CROP, CROP))
        err = max_err(got, want)
        grid = grid_sample_grid(Hs, (H, W), (CROP, CROP))
        nchw = img.permute(0, 3, 1, 2)
        lib = lambda: torch.nn.functional.grid_sample(  # noqa: E731
            nchw, grid, padding_mode="zeros", align_corners=True)
        lib_err = max_err(lib().permute(0, 2, 3, 1), want)
        # as the K1 row: the source pixels the taps read, the map, the crop
        b_ms, by = bound_ms(warp_read_bytes(img, Hs, (CROP, CROP)) + 9 * 4 + CROP * CROP * 3 * 4,
                            CROP * CROP * (24 + 7 * 3))
        rows.append(dict(photo=f"{W}x{H}", max_abs_err=err, tolerance=1e-4,
                         grid_sample_abs_err=lib_err, ms=cuda_ms(k1),
                         plain_ms=cuda_ms(lambda: homography.warp_perspective_batch(
                             img, Hs, (CROP, CROP))),
                         library_ms=cuda_ms(lib), bound_ms=b_ms, bound_by=by))
        if not err <= 1e-4:
            raise AssertionError(f"K1 on a {W}x{H} photo differs from its plain version: {err}")
    return rows


def tsv_phase(dev, kernels_mod, smi: str) -> tuple[dict, tuple]:
    """Phase 4: the head-only retrieval chain: ``generate_tsv``'s steps over the
    committed kashtanka corpus (320 x 320) and over camera-sized photos written
    at run time, each on the card (the launch counts read around them) and on
    the CPU from the same weights, and their agreement; two planted faults
    that the agreement must catch; K1 at B = 1 on camera photos against its
    plain version. Returns the launch counts of both card runs and the card's
    models."""
    import torch
    from pets_face_recognition_tpu_torch import native
    from pets_face_recognition_tpu_torch.pipelines import (build_head_pipeline,
                                                           build_retrieval_models)

    t = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t
    paths = sorted(CORPUS.rglob("*.jpg"))
    variants = sorted(VARIANTS.glob("*.jpg"))
    t = time.perf_counter()
    make_photo_corpus(PHOTOS)
    photo_paths = sorted(PHOTOS.rglob("*.jpg"))
    emit("tsv_probe", route=native.route(), native_library=lib.name, native_build_s=build_s,
         probe=probe_host(), photos_written_s=time.perf_counter() - t,
         photo_mb=[round(p.stat().st_size / 2 ** 20, 3) for p in photo_paths],
         decode_vs_pil_libjpeg={
             "corpus": decode_vs_pil(paths), "photos": decode_vs_pil(photo_paths),
             **{p.stem: decode_vs_pil([p]) for p in variants}}, card=smi)

    # random weights rarely score above the reference's 0.9
    os.environ["PFR_RETRIEVAL_THR"] = "0.0"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cpu = torch.device("cpu")
    models = {"card": build_retrieval_models(dev, seed=0), "cpu": build_retrieval_models(cpu, 0)}
    heads = {"card": build_head_pipeline(*models["card"], device=dev),
             "cpu": build_head_pipeline(*models["cpu"], device=cpu)}
    total = {k: 0 for k in kernels_mod.launch_counts()}
    refs = {}
    for name, root in (("corpus", CORPUS), ("photos", PHOTOS)):
        gpu = run_chain(root, dev, heads["card"], kernels_mod, f"{name}_gpu")
        ref = refs[name] = run_chain(root, cpu, heads["cpu"], kernels_mod, f"{name}_cpu")
        diff = chain_diff(gpu, ref)
        k = gpu["launches"]
        n = len(gpu["rec"])
        n_valid = sum(r["valid"] for r in gpu["rec"])
        emit("tsv", corpus=name, images=n, valid_images=n_valid, queries=len(gpu["rows"]),
             chain_s=gpu["chain_s"], images_per_s=n / gpu["chain_s"],
             chain_s_cpu=ref["chain_s"], launches=k, card=smi,
             by_size=split_by_size(gpu),
             loop_rest_ms_per_image=(gpu["chain_s"] - sum(r["decode"] + r["head"]
                                                          for r in gpu["rec"])) / n * 1e3,
             vs_cpu=diff, budget=dict(max_crop_err=CROP_DRIFT, max_embedding_rel_err=EMB_DRIFT,
                                      max_score_drift=SCORE_DRIFT, max_flip_gap=SCORE_DRIFT),
             same_queries=[r[0] for r in gpu["rows"]] == [r[0] for r in ref["rows"]],
             same_answers=[r[4] for r in gpu["rows"]] == [r[4] for r in ref["rows"]],
             tsv=str(OUT_DIR / f"pred_scores_test2_{name}_gpu.tsv"),
             rows=[list(r[:4]) for r in gpu["rows"]])
        if diff["breaks"]:
            raise AssertionError(f"{name}: the card's chain differs from the CPU's in "
                                 f"{diff['breaks']}: {diff}")
        if not gpu["rows"]:
            raise AssertionError(f"{name}: no query was scored")
        if k["warp_perspective_batch"] != n_valid:
            raise AssertionError(f"{name}: K1 launched {k['warp_perspective_batch']} times "
                                 f"for {n_valid} valid images")
        if not (k["nms_keep_sorted_batch"] and k["multilevel_roi_align"]):
            raise AssertionError(f"{name}: K2 or K3 not launched on the chain: {k}")
        total = {key: total[key] + k[key] for key in total}

    # the gate against planted faults, on the camera photos: each must break it
    det, dog, cat = models["card"]
    faults = {}
    for fault, head in (("embedders_swapped", build_head_pipeline(det, cat, dog, device=dev)),
                        ("map_shifted_1px", shifted_head(det, dog, cat, dev))):
        faults[fault] = chain_diff(run_chain(PHOTOS, dev, head, kernels_mod, fault),
                                   refs["photos"])
        faults[fault].pop("near_tie")
    emit("tsv_faults", corpus="photos", faults=faults)
    missed = [f for f, d in faults.items() if not d["breaks"]]
    if missed:
        raise AssertionError(f"the card-against-CPU gate misses planted faults: {missed}")

    first = {}
    for p, size in photo_sizes().items():
        first.setdefault(size, p)
    emit("k1_photo", rows=k1_photo_rows(dev, [first[(4032, 3024)], first[(960, 1280)]]),
         card=smi)
    return total, models["card"]


@contextlib.contextmanager
def pil_route():
    """Decode through PIL (the port's fallback for hosts without a native
    route) instead of the native route, to measure the two."""
    from pets_face_recognition_tpu_torch import native

    is_available = native.is_available
    native.is_available = lambda: False
    try:
        yield
    finally:
        native.is_available = is_available


def stream_rate(service, paths, windows: int) -> dict:
    """``windows`` passes of ``service.stream`` over ``paths``: crops/s over all
    of them (every path over the whole time), and each pass's."""
    times, n = [], 0
    for _ in range(windows):
        t = time.perf_counter()
        for chunk, _, _ in service.stream(paths):
            n += len(chunk)
        times.append(time.perf_counter() - t)
    if n != windows * len(paths):
        raise AssertionError(f"stream returned {n} of {windows * len(paths)} paths")
    return dict(paths=len(paths), windows=windows, crops_per_s=n / sum(times),
                crops_per_s_each=[len(paths) / x for x in times])


def jpeg_stream_phase(dev, smi: str, detector, embedder) -> None:
    """Crops/s from JPEG files: ``EmbeddingService.stream`` at B = 32 over the
    committed corpus repeated to 512 paths and over camera photos of each
    size, decoding overlapped on its producer thread, through the native
    route and through PIL; beside them, each route's decode of one photo and
    the native decode of one batch alone."""
    import torch
    from pets_face_recognition_tpu_torch import native
    from pets_face_recognition_tpu_torch.serving import EmbeddingService

    corpus = sorted(CORPUS.rglob("*.jpg"))
    sets = {"320x320": (corpus * (N_STREAM // len(corpus) + 1))[:N_STREAM]}
    photos = {}
    for p, size in photo_sizes().items():
        photos.setdefault(size, []).append(p)
    for size, ps in photos.items():
        sets["x".join(map(str, size))] = (ps * (N_STREAM_PHOTOS[size] // len(ps) + 1)
                                          )[:N_STREAM_PHOTOS[size]]
    service = EmbeddingService(detector, embedder, device=dev, batch_size=B_STREAM,
                               warp_dtype=torch.float32)
    for _ in service.stream(corpus[:B_STREAM]):
        pass
    torch.cuda.synchronize()
    decode_ms = []
    for _ in range(5):
        t = time.perf_counter()
        native.decode_batch(corpus[:B_STREAM], service.input_size)
        decode_ms.append((time.perf_counter() - t) * 1e3)
    single_ms = {}
    for name, ps in sets.items():
        one = {}
        for route, fn in ((native.route(), native.decode_single), ("pil", pil_decode)):
            ts = []
            for p in ps[:4]:
                t = time.perf_counter()
                fn(p)
                ts.append((time.perf_counter() - t) * 1e3)
            one[route] = statistics.median(ts)
        single_ms[name] = one
    batch_ms = {}
    for name, ps in sets.items():
        t = time.perf_counter()
        native.decode_batch(ps[:B_STREAM], service.input_size)
        batch_ms[name] = (time.perf_counter() - t) * 1e3
    # one pass of the corpus paths; two of the shorter camera sets
    rates = {name: stream_rate(service, ps, 1 if len(ps) >= N_STREAM else 2)
             for name, ps in sets.items()}
    with pil_route():
        rates_pil = {name: stream_rate(service, ps[:N_STREAM_PIL[name]], 1)
                     for name, ps in sets.items()}
    emit("jpeg_stream", batch=B_STREAM, route=native.route(), crops_per_s={
        name: r["crops_per_s"] for name, r in rates.items()}, by_size=rates,
        pil_route=rates_pil, decode_one_photo_ms=single_ms,
        decode_batch_ms=statistics.median(decode_ms), decode_batch_ms_by_size=batch_ms,
        card=smi,
        precision="float32: TF32 off inside embed_batch")


def retrieval_phase(dev, smi: str) -> None:
    """Retrieval ms: ``calc_scores`` on seeded vectors, 1000 query cards
    against 10000 gallery cards of 1-4 images each (types 1 and 2 at random),
    and the centroid product alone (CUDA events)."""
    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch import retrieval
    from pets_face_recognition_tpu_torch.device import float32_matmuls
    from pets_face_recognition_tpu_torch.kernel_ab import cuda_ms

    rng = np.random.RandomState(0)

    def cards(prefix, n):
        sizes = rng.randint(1, 5, n)
        types = rng.randint(1, 3, n)
        vecs = rng.randn(int(sizes.sum()), D_EMB).astype(np.float32)
        ends = np.cumsum(sizes)
        return [retrieval.CardRecord(f"{prefix}{i}", int(types[i]), vecs[e - s:e],
                                     np.zeros((0, D_EMB), np.float32))
                for i, (s, e) in enumerate(zip(sizes, ends))]

    queries, gallery = cards("q", Q_RETRIEVAL), cards("g", G_RETRIEVAL)
    retrieval.calc_scores(queries[:10], gallery[:100], dev)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t = time.perf_counter()
        rows = retrieval.calc_scores(queries, gallery, dev)
        times.append((time.perf_counter() - t) * 1e3)
    if len(rows) != Q_RETRIEVAL or not all(len(r[4].split(",")) == 100 for r in rows):
        raise AssertionError("retrieval did not rank 100 cards for every query")
    q = torch.from_numpy(retrieval.build_card_matrix(queries, D_EMB)[0]).to(dev)
    g = torch.from_numpy(retrieval.build_card_matrix(gallery, D_EMB)[0]).to(dev)
    with float32_matmuls():
        product_ms = cuda_ms(lambda: torch.matmul(q, g.T))
    emit("retrieval", queries=Q_RETRIEVAL, gallery=G_RETRIEVAL, dim=D_EMB,
         gallery_images=sum(len(c.head_vectors) for c in gallery), calc_scores_ms=times,
         ms=statistics.median(times), product_all_cards_ms=product_ms,
         product_flops=2 * Q_RETRIEVAL * G_RETRIEVAL * D_EMB, card=smi,
         note="calc_scores splits by animal type: two products of about half the "
              "queries by half the gallery, head and body each (body centroids are zero)")


def train_phase(dev, kernels_mod, smi: str, arch: str = "resnet50", phase: str = "train"
                ) -> dict:
    """Phase 4: full-width training steps of the keypoint config's ``arch``
    model on one synthetic batch; for ``mobile`` the live norms' running
    statistics must move in every step."""
    import torch
    from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
    from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController

    ctl = KeyPointsController(arch=arch)
    B = B_TRAIN
    while True:
        state = ctl.init_state(seed=0, device=dev)
        stats = [{n: b.clone() for n, b in state.model.named_buffers()}]
        batch = synthetic_keypoint_batch(B, IMAGE_TRAIN, IMAGE_TRAIN, MAX_BOXES, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels_mod.reset_launch_counts()
        try:
            steps = []
            with tf32_watch(state.model) as flags:
                for _ in range(4):
                    t = time.perf_counter()
                    metrics = ctl.train_step(state, batch)
                    torch.cuda.synchronize()
                    steps.append((time.perf_counter() - t, metrics))
                    if arch == "mobile":
                        stats.append({n: b.clone() for n, b in state.model.named_buffers()})
            break
        except torch.cuda.OutOfMemoryError:
            if B == 1:
                raise
            del state
            torch.cuda.empty_cache()
            emit("train_cut", batch_from=B, batch_to=B // 2,
                 reason="torch.cuda.OutOfMemoryError at the keypoint config's batch")
            B //= 2
    launches = kernels_mod.launch_counts()
    for i, (_, m) in enumerate(steps):
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite loss at step {i}: {m}")
    missing = [k for k in ("nms_keep_sorted_batch", "multilevel_roi_align", "roi_footprints",
                           "multilevel_roi_align_backward") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched in the training steps: {missing}")
    stats_moved = None
    if arch == "mobile":
        # each step moves every running statistic of the live norms once
        stats_moved = [sum(not torch.equal(a[n], b[n]) for n in a)
                       for a, b in zip(stats, stats[1:])]
        if not stats[0] or any(k != len(stats[0]) for k in stats_moved):
            raise AssertionError(f"running statistics did not move in every step: "
                                 f"{stats_moved} of {len(stats[0])}")
    timed = [t for t, _ in steps[1:]]
    step = statistics.median(timed)
    F32_STEPS[phase] = (step * 1e3, torch.cuda.max_memory_allocated() / 2 ** 30)
    emit(phase, arch=arch, batch=B, image=IMAGE_TRAIN, max_boxes=MAX_BOXES, cut=B != B_TRAIN,
         steps=len(steps), warmup_steps=1, step_ms=step * 1e3,
         step_ms_all=[t * 1e3 for t, _ in steps], images_per_s=B / step,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         losses=[m for _, m in steps], launches=launches,
         launches_per_step={k: v / len(steps) for k, v in launches.items()}, card=smi,
         precision="float32: TF32 off inside train_step, torch's defaults outside",
         tf32_flags=flags, running_stats=len(stats[0]), running_stats_moved_per_step=stats_moved)
    if arch == "resnet50":
        repro_phase(ctl, state, batch, B)
    del state
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` and
    deterministic cuDNN inside the block; the caller's settings back after."""
    import torch

    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]


@contextlib.contextmanager
def deterministic_cudnn():
    """Deterministic cuDNN algorithms alone inside the block."""
    import torch

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


@contextlib.contextmanager
def deterministic_cudnn_benchmark():
    """Deterministic cuDNN algorithms inside the block, the fastest of them
    for each shape timed at first use (``cudnn.benchmark``)."""
    import torch

    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        with deterministic_cudnn():
            yield
    finally:
        torch.backends.cudnn.benchmark = saved


REPRO_MODES = {"default": contextlib.nullcontext, "cudnn_deterministic": deterministic_cudnn,
               "cudnn_deterministic_benchmark": deterministic_cudnn_benchmark,
               "deterministic_algorithms": deterministic_algorithms}


def repro_phase(ctl, state, batch, B: int, n_gt: int = MAX_BOXES,
                phase: str = "train_repro", modes: tuple[str, ...] = tuple(REPRO_MODES),
                rounds: int = 1) -> None:
    """Phase 4b (ROADMAP fault 2): two training steps from one saved state on
    the same batch and sampler noise; reports how many parameter gradients
    differ bitwise (a reported number, not a gate), in three arms, each with
    the text of every warning the steps raised: by default; with
    deterministic cuDNN algorithms alone, the arm that tells the rest of the
    step apart (the port's own step code has no nondeterministic index op
    left: the keypoint heatmaps' 2x upsample has a backward that sums in a
    fixed order, ``roi_heads.upsample_bilinear_2x``); with deterministic
    cuDNN picking the fastest of its deterministic algorithms by timing them
    at first use (``cudnn.benchmark``); and under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` as well.
    Last, what each costs a step: ``rounds`` rounds of one step in each arm,
    the arms' order rotating from round to round, and each arm's median step
    time over the default's in the same round. ``modes`` picks the arms."""
    import copy
    import warnings

    import torch

    model = state.model
    n_anchors = 3 * sum((IMAGE_TRAIN // st) ** 2 for st in (4, 8, 16, 32, 64))
    noise = model.draw_sampler_noise(B, n_anchors, n_gt, torch.Generator().manual_seed(2))
    saved = (copy.deepcopy(model.state_dict()), copy.deepcopy(state.optimizer.state_dict()),
             state.step)

    def step():
        model.load_state_dict(saved[0])
        state.optimizer.load_state_dict(saved[1])
        state.step = saved[2]
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses = ctl.train_step(state, batch, sampler_noise=noise)
        torch.cuda.synchronize()
        return losses, (time.perf_counter() - t) * 1e3

    def two_steps():
        runs = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                losses, ms = step()
                runs.append((losses, ms, {n: p.grad.detach().clone()
                                          for n, p in model.named_parameters()
                                          if p.grad is not None}))
        (l1, ms1, g1), (l2, ms2, g2) = runs
        differ = sorted(n for n in g1 if not torch.equal(g1[n], g2[n]))
        worst = max((float((g1[n] - g2[n]).abs().max() / g1[n].abs().max().clamp(min=1e-30)),
                     n) for n in differ) if differ else (0.0, None)
        return dict(grads=len(g1), grads_bitwise_different=len(differ),
                    grads_different=differ[:16],
                    grads_bitwise_equal=sorted(set(g1) - set(differ))[:32], worst_rel_diff=worst[0],
                    worst=worst[1], losses_bitwise_equal=l1 == l2, step_ms=[ms1, ms2],
                    warnings=sorted({str(w.message)[:400] for w in caught}))

    arms = {}
    for mode in modes:
        with REPRO_MODES[mode]():
            arms[mode] = two_steps()
    names = list(modes)
    timed = []
    for r in range(rounds):
        pair = {}
        for mode in names[r % len(names):] + names[:r % len(names)]:
            with REPRO_MODES[mode](), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                pair[mode] = step()[1]
        timed.append(pair)
    cost = {f"{m}_cost_median": statistics.median(p[m] / p["default"] - 1 for p in timed)
            for m in names[1:]} if timed else {}
    emit(phase, batch=B, **arms, step_ms_rounds=timed, **cost)


# softmax CE over a heatmap's positions has a gradient that sums to 0, the 2x
# bilinear upsample weighs every output 1 in all, so this bias's gradient is 0
# in exact arithmetic and only rounding is left on either side
ZERO_BY_CONSTRUCTION = ("roi_heads.keypoint_predictor.kps_score_lowres.bias",)


def train_vs_cpu_phase(dev) -> None:
    """Phase 5: one reduced step on the card and on the CPU, same weights and
    noise."""
    import copy

    import torch
    from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
    from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
    from pets_face_recognition_tpu_torch.models.rcnn import keypointrcnn_resnet50_fpn
    from pets_face_recognition_tpu_torch.weights import init_random_

    B, image = 2, 256
    budgets = dict(rpn_pre_nms_top_n_train=256, rpn_post_nms_top_n_train=128,
                   box_batch_size_per_image=16)
    cpu_model = init_random_(keypointrcnn_resnet50_fpn(**budgets), 1)
    gpu_model = copy.deepcopy(cpu_model)
    batch = synthetic_keypoint_batch(B, image, image, MAX_BOXES, seed=1)
    n_anchors = 3 * sum((image // st) ** 2 for st in (4, 8, 16, 32, 64))
    noise = cpu_model.draw_sampler_noise(B, n_anchors, MAX_BOXES,
                                         torch.Generator().manual_seed(1))
    ctl = KeyPointsController()
    out = {}
    for name, model, device in (("gpu", gpu_model, dev), ("cpu", cpu_model, "cpu")):
        state = ctl.init_state(0, device, model=model)
        t = time.perf_counter()
        losses = ctl.train_step(state, batch, sampler_noise=noise)
        if name == "gpu":
            torch.cuda.synchronize()
        out[name] = (losses, {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                     time.perf_counter() - t)
    (l_gpu, g_gpu, t_gpu), (l_cpu, g_cpu, t_cpu) = out["gpu"], out["cpu"]
    loss_rel = {k: abs(l_gpu[k] - l_cpu[k]) / abs(l_cpu[k]) for k in l_cpu}
    zero_abs = max(max(float(g_gpu[n].abs().max()), float(g_cpu[n].abs().max()))
                   for n in ZERO_BY_CONSTRUCTION)
    grad_rel = {n: float((g_gpu[n] - g_cpu[n]).norm() / g_cpu[n].norm())
                for n in g_cpu if n not in ZERO_BY_CONSTRUCTION}
    worst = max(grad_rel, key=grad_rel.get)
    emit("train_vs_cpu", batch=B, image=image, budgets=budgets, losses_gpu=l_gpu,
         losses_cpu=l_cpu, loss_rel_err=loss_rel, grad_rel_err_max=grad_rel[worst],
         grad_rel_err_worst=worst, zero_by_construction_abs=zero_abs,
         grad_tensors=len(grad_rel), step_s_gpu=t_gpu, step_s_cpu=t_cpu,
         tolerances=dict(loss_rel=1e-3, grad_rel_norm=5e-3, zero_by_construction_abs=1e-5))
    # the card and the CPU run other convolution algorithms and sum in other
    # orders (K4 too); both see the same samples. Gradients: the
    # worst tensor measured 9.5e-4 on an H100 (a trunk BN bias, which sums a
    # whole feature map), held at 5e-3 for other cuDNN algorithm choices
    bad = {k: v for k, v in loss_rel.items() if not v <= 1e-3}
    if bad:
        raise AssertionError(f"losses differ from the CPU step: {bad}")
    if not grad_rel[worst] <= 5e-3:
        raise AssertionError(f"gradient {worst} differs from the CPU step: {grad_rel[worst]}")
    if not zero_abs <= 1e-5:
        raise AssertionError(f"zero-by-construction gradient is {zero_abs}")


# a per-channel shift of these MobileNetV3 outputs reaches only the inputs of
# live norms (through the residual adds up to block 10's expand conv; c2 and
# c3 are not pooled), whose batch mean removes it: 0 in exact arithmetic
SHIFTS_REMOVED_BY_LIVE_BN = tuple(f"backbone.body.blocks.{i}.bn_project.bias"
                                  for i in range(10))


def mobile_train_vs_cpu_phase(dev) -> None:
    """Phase mobile_train_vs_cpu: one reduced live-BN step of the MobileNetV3
    keypoint R-CNN (B = 2, 256 x 256, momentum 0.9) from the same weights and
    sampler noise on the card and on the CPU: losses within 1e-3 relative,
    running statistics within 1e-4 relative in norm, gradients 0 by
    construction within 1e-5, and every other gradient within 5e-3 relative
    in norm, or within twice what the card's own step moves when its input
    images are rounded differently (1e-7 relative; the middle of three
    draws, worst tensor and median tensor alike): live BatchNorm over a few
    dozen values a channel makes this step ill-conditioned in float32, in
    the JAX package too (``tests/test_torch_port_mobile_train.py``); on the
    card the spread also holds cuDNN's run-to-run summation order."""
    import copy

    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
    from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
    from pets_face_recognition_tpu_torch.models.rcnn import mobile_net_v3_large_keypoint_rcnn
    from pets_face_recognition_tpu_torch.weights import init_random_

    B, image = 2, 256
    budgets = dict(rpn_pre_nms_top_n_train=256, rpn_post_nms_top_n_train=128,
                   box_batch_size_per_image=16)
    cpu_model = init_random_(mobile_net_v3_large_keypoint_rcnn(
        frozen_stats=False, bn_momentum=0.9, **budgets), 1)
    batch = synthetic_keypoint_batch(B, image, image, MAX_BOXES, seed=1)
    n_anchors = 15 * sum((image // st) ** 2 for st in (16, 32, 64))
    noise = cpu_model.draw_sampler_noise(B, n_anchors, MAX_BOXES,
                                         torch.Generator().manual_seed(1))
    runs = [("gpu", copy.deepcopy(cpu_model), dev, batch)]
    for s in (1, 2, 3):
        jitter = 1 + np.random.RandomState(s).randn(*batch["images"].shape) * 1e-7
        runs.append((f"gpu_rounded_{s}", copy.deepcopy(cpu_model), dev,
                     dict(batch, images=(batch["images"] * jitter).astype(np.float32))))
    runs.append(("cpu", cpu_model, "cpu", batch))
    ctl = KeyPointsController(arch="mobile")
    out = {}
    for name, model, device, b in runs:
        state = ctl.init_state(0, device, model=model)
        t = time.perf_counter()
        losses = ctl.train_step(state, b, sampler_noise=noise)
        if device != "cpu":
            torch.cuda.synchronize()
        out[name] = (losses, {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                     {n: v.detach().cpu() for n, v in model.named_buffers()},
                     time.perf_counter() - t)
    (l_gpu, g_gpu, s_gpu, t_gpu), (l_cpu, g_cpu, s_cpu, t_cpu) = out["gpu"], out["cpu"]

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))

    zero = ZERO_BY_CONSTRUCTION + SHIFTS_REMOVED_BY_LIVE_BN
    zero_abs = max(max(float(g_gpu[n].norm()), float(g_cpu[n].norm())) for n in zero)
    names = [n for n in g_cpu if n not in zero]
    grad_rel = {n: rel(g_gpu[n], g_cpu[n]) for n in names}
    spreads = [[rel(out[f"gpu_rounded_{s}"][1][n], g_gpu[n]) for n in names] for s in (1, 2, 3)]
    # card against CPU compares two runs that each carry the rounding, hence
    # twice the card's own spread (a wrong gradient is off by far more)
    worst_bound = max(5e-3, 2 * statistics.median(max(x) for x in spreads))
    median_bound = max(5e-3, 2 * statistics.median(statistics.median(x) for x in spreads))
    worst = max(grad_rel, key=grad_rel.get)
    grad_median = statistics.median(grad_rel.values())
    loss_rel = {k: abs(l_gpu[k] - l_cpu[k]) / abs(l_cpu[k]) for k in l_cpu}
    stat_rel = {n: rel(s_gpu[n], s_cpu[n]) for n in s_cpu}
    stat_worst = max(stat_rel, key=stat_rel.get)
    emit("mobile_train_vs_cpu", batch=B, image=image, budgets=budgets, losses_gpu=l_gpu,
         losses_cpu=l_cpu, loss_rel_err=loss_rel, grad_rel_err_max=grad_rel[worst],
         grad_rel_err_worst=worst, grad_rel_err_median=grad_median,
         card_rounding_spread={"worst": [max(x) for x in spreads],
                               "median": [statistics.median(x) for x in spreads]},
         grad_bounds={"worst": worst_bound, "median": median_bound},
         zero_by_construction_abs=zero_abs, running_stats=len(stat_rel),
         running_stats_rel_err_max=stat_rel[stat_worst], running_stats_worst=stat_worst,
         step_s_gpu=t_gpu, step_s_cpu=t_cpu,
         tolerances=dict(loss_rel=1e-3, grad_rel_norm=5e-3, running_stats_rel_norm=1e-4,
                         zero_by_construction_abs=1e-5))
    bad = {k: v for k, v in loss_rel.items() if not v <= 1e-3}
    if bad:
        raise AssertionError(f"mobile losses differ from the CPU step: {bad}")
    if not (grad_rel[worst] <= worst_bound and grad_median <= median_bound):
        raise AssertionError(f"mobile gradient {worst} differs from the CPU step: "
                             f"{grad_rel[worst]} (median {grad_median}); bounds "
                             f"{worst_bound}, {median_bound}")
    if not zero_abs <= 1e-5:
        raise AssertionError(f"mobile zero-by-construction gradient is {zero_abs}")
    if not stat_rel[stat_worst] <= 1e-4:
        raise AssertionError(f"running statistic {stat_worst} differs from the CPU step: "
                             f"{stat_rel[stat_worst]}")


def mobile_tsv_phase(dev, kernels_mod, smi: str) -> dict:
    """Phase mobile_tsv: the head-only retrieval chain with
    ``PFR_KEYPOINT_ARCH=mobile`` over the committed corpus, on the card (the
    launch counts read around it) and on the CPU from the same weights, held
    to each other by ``tsv``'s gates. Returns the card run's launch counts."""
    import torch
    from pets_face_recognition_tpu_torch.pipelines import (build_head_pipeline,
                                                           build_retrieval_models, keypoint_arch)

    os.environ["PFR_RETRIEVAL_THR"] = "0.0"
    saved = os.environ.get("PFR_KEYPOINT_ARCH")
    os.environ["PFR_KEYPOINT_ARCH"] = "mobile"
    try:
        arch = keypoint_arch()
    finally:
        if saved is None:
            os.environ.pop("PFR_KEYPOINT_ARCH")
        else:
            os.environ["PFR_KEYPOINT_ARCH"] = saved
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cpu = torch.device("cpu")
    heads = {name: build_head_pipeline(*build_retrieval_models(d, 0, arch), device=d)
             for name, d in (("card", dev), ("cpu", cpu))}
    gpu = run_chain(CORPUS, dev, heads["card"], kernels_mod, "mobile_corpus_gpu")
    ref = run_chain(CORPUS, cpu, heads["cpu"], kernels_mod, "mobile_corpus_cpu")
    diff = chain_diff(gpu, ref)
    k = gpu["launches"]
    n = len(gpu["rec"])
    n_valid = sum(r["valid"] for r in gpu["rec"])
    emit("mobile_tsv", arch=arch, corpus="corpus", images=n, valid_images=n_valid,
         queries=len(gpu["rows"]), chain_s=gpu["chain_s"], images_per_s=n / gpu["chain_s"],
         chain_s_cpu=ref["chain_s"], launches=k, card=smi, by_size=split_by_size(gpu),
         vs_cpu=diff, budget=dict(max_crop_err=CROP_DRIFT, max_embedding_rel_err=EMB_DRIFT,
                                  max_score_drift=SCORE_DRIFT, max_flip_gap=SCORE_DRIFT),
         same_queries=[r[0] for r in gpu["rows"]] == [r[0] for r in ref["rows"]],
         tsv=str(OUT_DIR / "pred_scores_test2_mobile_corpus_gpu.tsv"))
    if diff["breaks"]:
        raise AssertionError(f"mobile chain: the card differs from the CPU in {diff['breaks']}")
    if not gpu["rows"]:
        raise AssertionError("mobile chain: no query was scored")
    if k["warp_perspective_batch"] != n_valid:
        raise AssertionError(f"mobile chain: K1 launched {k['warp_perspective_batch']} times "
                             f"for {n_valid} valid images")
    if not (k["nms_keep_sorted_batch"] and k["multilevel_roi_align"]):
        raise AssertionError(f"mobile chain: K2 or K3 not launched: {k}")
    return k


MINIATURE = REPO / "pets_face_recognition_tpu_torch" / "testdata"   # the CAT miniature
FIT_OUT = REPO / "smoke_out" / "fit"        # git-ignored; deleted after the phase
FIT_KERNELS = ("nms_keep_sorted_batch", "multilevel_roi_align", "roi_footprints",
               "multilevel_roi_align_backward")
FIT_CONFIG = """from pets_face_recognition_tpu_torch.config_presets import build_keypoint_config

globals().update(build_keypoint_config(data_root={data!r}, n_epochs={epochs}, num_workers=8,
                                       output={out!r}, arch={arch!r}))
"""
# card against CPU on the validation batch: boxes as a share of the image side;
# the RPN's logits and deltas as a share of their largest magnitude
FIT_GATES = dict(score_abs=1e-3, box_rel_to_side=1e-3, metric=1e-3, rpn_rel=1e-3)


def fit_config(arch: str, epochs: int):
    """The keypoint config at production width over the committed miniature,
    written as a config file and read back as ``main()`` reads one."""
    from pets_face_recognition_tpu_torch.utils import get_config

    out = FIT_OUT / arch
    out.mkdir(parents=True, exist_ok=True)
    path = out / "keypoint_fit.py"
    path.write_text(FIT_CONFIG.format(data=str(MINIATURE), epochs=epochs, out=str(out),
                                      arch=arch))
    return path, get_config(path)


def timed_controller(config):
    """The port's controller with each train step and eval batch timed."""
    from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController

    class Timed(KeyPointsController):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.step_s, self.eval_s, self.losses = [], [], []

        def train_step(self, state, batch, sampler_noise=None):
            t = time.perf_counter()
            m = super().train_step(state, batch, sampler_noise)   # floats: synchronised
            self.step_s.append(time.perf_counter() - t)
            self.losses.append(m)
            return m

        def init_state(self, *args, **kw):
            t = time.perf_counter()
            state = super().init_state(*args, **kw)
            self.init_s = time.perf_counter() - t
            return state

        def run_eval_batch(self, eval_step, state, batch):
            t = time.perf_counter()
            out = super().run_eval_batch(eval_step, state, batch)  # numpy: synchronised
            self.eval_s.append(time.perf_counter() - t)
            return out

    return Timed(config=config)


def fit_run(config, dev, kernels_mod, logdir: Path, **overrides):
    """``configure_trainer(config, logger).fit(controller)`` with the launch
    counts read around it; the finite-loss and launch gates."""
    import torch
    from pets_face_recognition_tpu_torch.engine.logging import MetricsLogger
    from pets_face_recognition_tpu_torch.engine.trainer import configure_trainer

    ctl = timed_controller(config)
    trainer = configure_trainer(config, MetricsLogger(logdir), device=dev, **overrides)
    torch.cuda.synchronize()
    kernels_mod.reset_launch_counts()
    t = time.perf_counter()
    trainer.fit(ctl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = kernels_mod.launch_counts()
    bad = [m for m in ctl.losses if not all(math.isfinite(v) for v in m.values())]
    if bad or not ctl.losses:
        raise AssertionError(f"non-finite or no losses in the fit: {bad or ctl.losses}")
    missing = [k for k in FIT_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched in the fit: {missing}")
    recs = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    epochs = [{k: r[k] for k in ("step", "epoch_loss", "data_time_s", "step_time_s",
                                 "epoch_time_s")} for r in recs if "epoch_time_s" in r]
    val = [{k: v for k, v in r.items() if k != "time"} for r in recs
           if any(k.startswith("val ") for k in r)]
    return trainer, ctl, launches, wall, epochs, val


def loader_rate(config, epochs: int = 2) -> dict:
    """The training loader alone (decode, rot90, letterbox to 640 x 640,
    collate; 8 threads): images/s over ``epochs`` epochs after one warm-up;
    then its two parts apart on one batch: the 16 reads on the loader's
    thread pool, and the collate in one thread, as the producer runs it."""
    from concurrent.futures import ThreadPoolExecutor

    loader = config.train_dataloader()
    for _ in loader:
        pass
    t = time.perf_counter()
    n = sum(b["images"].shape[0] for _ in range(epochs) for b in loader)
    s = time.perf_counter() - t
    idx = list(range(loader.batch_size))
    with ThreadPoolExecutor(loader.num_workers) as pool:
        t = time.perf_counter()
        samples = list(pool.map(loader.dataset.__getitem__, idx))
        read_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    loader.collate_fn(samples)
    collate_ms = (time.perf_counter() - t) * 1e3
    return dict(images=n, seconds=s, images_per_s=n / s, threads=loader.num_workers,
                batch=loader.batch_size, read_ms_per_batch=read_ms,
                collate_ms_per_batch=collate_ms)


def state_snapshot(state) -> dict:
    return {"model": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
            "momentum": [state.optimizer.state[p]["momentum_buffer"].detach().cpu().clone()
                         for g in state.optimizer.param_groups for p in g["params"]],
            "step": state.step}


def predictions(config, ckpt: Path, device, controller_cls=None) -> tuple[object, list[dict]]:
    """The checkpoint's detections over the validation loader on ``device``,
    and the controller (by default the keypoint one) that made them."""
    from pets_face_recognition_tpu_torch.engine.checkpoint import load_params, merge_params
    from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
    from pets_face_recognition_tpu_torch.engine.trainer import Trainer

    ctl = (controller_cls or KeyPointsController)(config=config)
    state = ctl.init_state(0, device)
    merge_params(state.model, load_params(ckpt, device))
    outputs = Trainer(config, enable_checkpointing=False, device=device).predict(ctl, state)
    return ctl, outputs


@contextlib.contextmanager
def recorded_decisions(force: list[dict] | None = None):
    """The two discrete steps of each eval forward while the block runs, one
    record a forward, on the host: the RPN's outputs, the arguments of
    ``generate_proposals`` and the proposals it keeps, and the candidates
    that the post-process picks (one an image, or with more detections an
    image, :func:`picked_candidates` and the candidates themselves). Both
    steps are discontinuous: on a random detector a rounding-size move of
    the RPN's outputs can keep another proposal, and one of the scores can
    pick another candidate.

    With ``force`` (the card's records of the same forwards), each forward
    takes the card's proposals for its own, and the card's pick where its own
    is a near-tie. One detection an image: its own scores of the two
    candidates within the score gate, ``FIT_GATES["score_abs"]``. More: the
    post-process replayed here on the card's candidates picks the card's
    (``pick_replay_differs`` counts the images where it does not), and its
    own scores and boxes of every candidate that either picks are within the
    card's by the score and box gates; the gap is then the largest
    difference of its own scores slot by slot, the score threshold standing
    for an empty slot. Its own proposals and pick are still recorded, with
    ``pick_moved`` (a flag an image) and the gaps of the picks that
    differ."""
    import torch
    from pets_face_recognition_tpu_torch.models import rcnn
    from pets_face_recognition_tpu_torch.models import roi_heads as rh

    seen, gen, post = [], rcnn.generate_proposals, rh.postprocess_detections_batch

    def proposals(objectness, deltas, anchors, counts, image_size, *args):
        own = gen(objectness, deltas, anchors, counts, image_size, *args)
        seen.append(dict(objectness=objectness.cpu(), deltas=deltas.cpu(),
                         anchors=anchors.cpu(), args=(list(counts), tuple(image_size), *args),
                         proposals=own[0].cpu(), valid=own[1].cpu(),
                         pick_moved=[False] * objectness.shape[0], pick_gaps=[]))
        if force is None:
            return own
        card = force[len(seen) - 1]
        return card["proposals"].to(objectness.device), card["valid"].to(objectness.device)

    def pick(class_logits, box_deltas, props, prop_valid, image_size, score_thresh,
             nms_thresh, detections_per_img):
        out = post(class_logits, box_deltas, props, prop_valid, image_size, score_thresh,
                   nms_thresh, detections_per_img)
        cand = rh.detection_candidates(class_logits, box_deltas, props, prop_valid,
                                       image_size, score_thresh)
        if detections_per_img != 1:
            return pick_many(out, cand, (class_logits, box_deltas, props, prop_valid,
                                         image_size, score_thresh, nms_thresh,
                                         detections_per_img))
        boxes, labels, scores, valid = cand
        masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
        own = masked.argmax(1)
        rec = seen[-1]
        rec["pick"] = own.cpu()
        if force is None:
            return out
        card = force[len(seen) - 1]["pick"].to(own.device)
        gap = (masked.gather(1, own[:, None]) - masked.gather(1, card[:, None]))[:, 0]
        moved = (own != card) & (gap <= FIT_GATES["score_abs"])
        rec["pick_moved"], rec["pick_gaps"] = moved.tolist(), gap[own != card].tolist()
        take = torch.where(moved, card, own)[:, None]
        top = masked.gather(1, take)
        ok = top > float("-inf")
        return (boxes.gather(1, take[..., None].expand(-1, 1, 4)), labels[take],
                torch.where(ok, top, torch.zeros_like(top)), ok)

    def pick_many(out, cand, args):
        own, unmatched = picked_candidates(out, cand)
        rec = seen[-1]
        rec.update(pick=own.cpu(), candidates=[t.cpu() for t in cand], unmatched=unmatched,
                   pick_replay_differs=0)
        if force is None:
            return out
        card_rec = force[len(seen) - 1]
        dev = own.device
        card_cand = [t.to(dev) for t in card_rec["candidates"]]
        card = card_rec["pick"].to(dev)
        # this device's sort, NMS and top-k on the card's candidates
        saved = rh.detection_candidates
        rh.detection_candidates = lambda *a, **k: tuple(card_cand)
        try:
            replay = picked_candidates(post(*args), card_cand)[0]
        finally:
            rh.detection_candidates = saved
        boxes, labels, scores, _ = cand
        score_gap = (scores - card_cand[2]).abs()
        box_gap = (boxes - card_cand[0]).abs().amax(-1)
        thresh, box_tol = args[5], FIT_GATES["box_rel_to_side"] * max(args[4])
        differ = (own != card).any(1).tolist()
        replayed = (replay == card).all(1).tolist()
        moved, gaps = [], []
        for b, row in enumerate(torch.cat([own, card], 1).tolist()):
            near = all(float(score_gap[b, i]) <= FIT_GATES["score_abs"]
                       and float(box_gap[b, i]) <= box_tol for i in set(row) if i >= 0)
            moved.append(differ[b] and replayed[b] and near)
            if differ[b]:
                slot = [[float(scores[b, i]) if i >= 0 else thresh for i in (o, c)]
                        for o, c in zip(own[b].tolist(), card[b].tolist())]
                gaps.append(max(abs(o - c) for o, c in slot))
        rec.update(pick_moved=moved, pick_gaps=gaps,
                   pick_replay_differs=sum(not r for r in replayed))
        take = torch.where(torch.tensor(moved, device=dev)[:, None], card, own)
        ok, t = take >= 0, take.clamp(min=0)
        return (torch.where(ok[..., None], boxes.gather(1, t[..., None].expand(-1, -1, 4)),
                            out[0]),
                torch.where(ok, labels[t], out[1]),
                torch.where(ok, scores.gather(1, t), torch.zeros_like(out[2])), ok)

    rcnn.generate_proposals, rh.postprocess_detections_batch = proposals, pick
    try:
        yield seen
    finally:
        rcnn.generate_proposals, rh.postprocess_detections_batch = gen, post


def picked_candidates(out, cand) -> tuple:
    """Each detection slot's index among the post-process's candidates
    (``detection_candidates``), -1 where the slot is empty: the candidate of
    the slot's score, label and box, which the post-process copies. Returns
    the indices ``(B, D)`` and the count of filled slots that match no
    candidate."""
    import torch

    boxes, labels, scores, valid = out
    c_boxes, c_labels, c_scores, _ = cand
    same = ((c_scores[:, None, :] == scores[:, :, None])
            & (c_labels[None, None, :] == labels[:, :, None])
            & (c_boxes[:, None] == boxes[:, :, None]).all(-1))
    idx = torch.where(valid, same.float().argmax(-1), torch.full_like(labels, -1))
    return idx, int((valid & ~same.any(-1)).sum())


def detections_apart(out_a, out_b, metrics_a, metrics_b, side: int, keep=None) -> dict:
    """Two devices' eval batches and metrics apart: validity, scores, boxes
    as a share of ``side`` and keypoints in pixels over the images that
    ``keep`` (one boolean list a batch) holds, by default all, gated in
    ``failed``; each metric (relative for the pixel errors), gated apart in
    ``metrics_failed``."""
    import numpy as np

    r = dict(images=0, valid_equal=True, score_abs=0.0, box_rel_to_side=0.0,
             keypoint_abs_px=0.0)
    for i, (a, b) in enumerate(zip(out_a, out_b)):
        k = np.ones(len(a["pred"]["valid"]), bool) if keep is None else np.asarray(keep[i])
        pa, pb = ({n: v[k] for n, v in x["pred"].items()} for x in (a, b))
        r["images"] += int(k.sum())
        r["valid_equal"] &= bool((pa["valid"] == pb["valid"]).all())
        r["score_abs"] = max(r["score_abs"], float(
            np.abs(pa["scores"] - pb["scores"]).max(initial=0)))
        r["box_rel_to_side"] = max(r["box_rel_to_side"], float(
            np.abs(pa["boxes"] - pb["boxes"]).max(initial=0) / side))
        r["keypoint_abs_px"] = max(r["keypoint_abs_px"], float(np.abs(
            pa["keypoints"][..., :2] - pb["keypoints"][..., :2]).max(initial=0)))
    r["metric"] = {m: abs(v - metrics_b[m]) / (abs(metrics_b[m]) if m in ("MAE", "MSE") else 1.0)
                   for m, v in metrics_a.items()}
    bad = [n for n in ("score_abs", "box_rel_to_side") if not r[n] <= FIT_GATES[n]]
    bad += ["valid_equal"] * (not r["valid_equal"])
    r["metrics_failed"] = [m for m, v in r["metric"].items()
                           if not (v <= FIT_GATES["metric"] or (math.isnan(metrics_a[m])
                                                                and math.isnan(metrics_b[m])))]
    r["metrics_failed"] += ["metric names"] * (list(metrics_a) != list(metrics_b))
    return dict(r, failed=bad)


def rpn_apart(card: list[dict], cpu: list[dict]) -> float:
    """The RPN's outputs of the same forwards apart: the largest difference
    of the objectness logits and of the box deltas, each over the largest
    magnitude of the CPU's."""
    return max(float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(1e-30))
               for a, b in zip(card, cpu) for k in ("objectness", "deltas"))


def proposals_apart(a: dict, b: dict, side: int, as_sets: bool = False) -> list[bool]:
    """For each image, whether two records' proposals differ by more than
    the box gate, ``FIT_GATES["box_rel_to_side"]``: slot by slot (validity,
    or a valid box), or ``as_sets``, where a valid box of either has no
    valid box of the other within the gate (the order of near-equal scores
    is not a move)."""
    tol = FIT_GATES["box_rel_to_side"] * side
    if not as_sets:
        far = (a["proposals"] - b["proposals"]).abs().amax(-1) > tol
        return ((a["valid"] != b["valid"]) | (far & a["valid"])).any(1).tolist()
    moved = []
    for pa, va, pb, vb in zip(a["proposals"], a["valid"], b["proposals"], b["valid"]):
        near = (pa[va][:, None] - pb[vb][None]).abs().amax(-1) <= tol
        moved.append(bool(int(va.sum()) != int(vb.sum()) or not near.any(1).all()
                          or not near.any(0).all()))
    return moved


def fit_eval_vs_cpu(config, ckpt: Path, dev, metrics_landmark: dict) -> dict:
    """The checkpoint's validation detections on the card against the CPU's,
    end to end and with the CPU held to the card's discrete decisions;
    ``metrics_landmark``, ``eval_landmark``'s metrics on the card, must be
    those of the card's detections here within ``FIT_GATES["metric"]``.

    Held with the CPU forced to the card's decisions (always):

    - the RPN's outputs agree within ``FIT_GATES["rpn_rel"]``;
    - the CPU's ``generate_proposals`` on the card's RPN outputs keeps the
      card's proposals slot by slot (so K2 and the top-k took the card's
      decisions from the card's numbers);
    - the CPU's forward with the card's proposals, and the card's pick where
      its own is a near-tie (scores within ``FIT_GATES["score_abs"]``), gives
      the card's scores, boxes and metrics within ``FIT_GATES``.

    End to end, each device on its own: the images whose proposals (as
    sets) and pick did not move (:func:`recorded_decisions`) must agree
    within ``FIT_GATES``, and the metrics too when no image moved. The
    moves are counted and reported."""
    import torch
    from pets_face_recognition_tpu_torch.models.rpn import generate_proposals

    side = max(config.image_size)
    with recorded_decisions() as rec_card:
        t = time.perf_counter()
        ctl_card, out_card = predictions(config, ckpt, dev)
        t_card = time.perf_counter() - t
    metrics_card = ctl_card.evaluate([out_card])["val"]
    with recorded_decisions() as rec_cpu:
        t = time.perf_counter()
        ctl_cpu, out_cpu = predictions(config, ckpt, "cpu")
        t_cpu = time.perf_counter() - t
    metrics_cpu = ctl_cpu.evaluate([out_cpu])["val"]
    with recorded_decisions(rec_card) as rec_forced:
        ctl_forced, out_forced = predictions(config, ckpt, "cpu")
    metrics_forced = ctl_forced.evaluate([out_forced])["val"]

    moved = [[p or k for p, k in zip(proposals_apart(c, f, side, as_sets=True), f["pick_moved"])]
             for c, f in zip(rec_card, rec_forced)]
    end_to_end = detections_apart(out_card, out_cpu, metrics_card, metrics_cpu, side,
                                  keep=[[not m for m in b] for b in moved])
    forced = detections_apart(out_card, out_forced, metrics_card, metrics_forced, side)
    landmark = {m: abs(v - metrics_card[m]) for m, v in metrics_landmark.items()}
    replayed = []
    with torch.no_grad():
        for rec in rec_card:
            props, valid = generate_proposals(rec["objectness"], rec["deltas"], rec["anchors"],
                                              *rec["args"])
            replayed += proposals_apart(rec, dict(proposals=props, valid=valid), side)
    r = dict(end_to_end=end_to_end, forced=forced, rpn_rel=rpn_apart(rec_card, rec_cpu),
             replay_differs=sum(replayed), moved_images=sum(map(sum, moved)),
             proposal_moves=sum(sum(proposals_apart(c, f, side, as_sets=True))
                                for c, f in zip(rec_card, rec_forced)),
             proposal_slot_moves=sum(sum(proposals_apart(c, f, side))
                                     for c, f in zip(rec_card, rec_forced)),
             pick_moves=sum(sum(rec["pick_moved"]) for rec in rec_forced),
             pick_gaps=[g for rec in rec_forced for g in rec["pick_gaps"]],
             landmark_vs_predict=landmark, test_cpu={"val": metrics_cpu},
             test_cpu_forced={"val": metrics_forced},
             predict_s_card=t_card, predict_s_cpu=t_cpu)
    bad = [f"forced {n}" for n in forced["failed"] + forced["metrics_failed"]]
    bad += ["rpn_rel"] * (not r["rpn_rel"] <= FIT_GATES["rpn_rel"])
    bad += ["replay_differs"] * bool(r["replay_differs"])
    bad += [f"eval_landmark {m}" for m, d in landmark.items()
            if not (d <= FIT_GATES["metric"] or (math.isnan(metrics_landmark[m])
                                                 and math.isnan(metrics_card[m])))]
    bad += ["eval_landmark metric names"] * (list(metrics_landmark) != list(metrics_card))
    bad += [f"end to end {n}" for n in end_to_end["failed"]]
    if not r["moved_images"]:
        bad += [f"end to end {n}" for n in end_to_end["metrics_failed"]]
    return dict(r, failed=bad)


def keypoint_fit_phase(dev, kernels_mod, smi: str) -> dict[str, dict]:
    """Phase keypoint_fit: the keypoint config at production width trained
    from the committed CAT miniature through the port's trainer (2 epochs,
    validation, checkpoints), resumed for a third epoch, and its last
    checkpoint evaluated by ``eval_landmark`` on the card and on the CPU; the
    mobile arch for one epoch; ``main_keypoints`` on the smoke config in a
    subprocess. The card against the CPU is ``fit_eval_vs_cpu``. Returns the
    launch counts of each path."""
    import shutil

    import torch
    from pets_face_recognition_tpu_torch import eval_landmark
    from pets_face_recognition_tpu_torch.engine.checkpoint import (
        latest_checkpoint, restore_checkpoint, save_checkpoint)

    shutil.rmtree(FIT_OUT, ignore_errors=True)
    paths = {}
    try:
        cfg_path, config = fit_config("resnet50", 2)
        root = Path(config.output)
        loader = loader_rate(config)
        torch.cuda.reset_peak_memory_stats()
        trainer, ctl, paths["keypoint_fit"], wall, epochs, val = fit_run(
            config, dev, kernels_mod, root / "log_fit")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ckpts = sorted(p.name for p in (root / "checkpoints").iterdir())
        if ckpts != ["epoch=0-step=2", "epoch=1-step=4"]:
            raise AssertionError(f"checkpoints after 2 epochs: {ckpts}")
        saved = state_snapshot(trainer.state)
        # a save and a load of the same state, timed on their own
        torch.cuda.synchronize()
        t = time.perf_counter()
        probe = save_checkpoint(FIT_OUT / "timing", trainer.state, 1)
        save_ms = (time.perf_counter() - t) * 1e3
        ckpt_bytes = probe.stat().st_size
        del trainer
        fresh = ctl.init_state(0, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        epoch = restore_checkpoint(fresh, latest_checkpoint(root / "checkpoints"))
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t) * 1e3
        got = state_snapshot(fresh)
        differ = [k for k, v in got["model"].items() if not torch.equal(v, saved["model"][k])]
        differ += [f"momentum {i}" for i, (a, b) in enumerate(zip(got["momentum"],
                                                                 saved["momentum"]))
                   if not torch.equal(a, b)]
        if differ or got["step"] != 4 or epoch + 1 != 2 or len(got["momentum"]) != len(
                saved["momentum"]):
            raise AssertionError(f"restored state differs: step {got['step']}, epoch {epoch}, "
                                 f"tensors {differ[:5]}")
        del fresh, got, saved

        resumed, ctl2, launches2, wall2, epochs2, val2 = fit_run(
            config, dev, kernels_mod, root / "log_resume", max_epochs=3)
        if resumed.start_epoch != 2 or resumed.state.step != 6 or not (
                root / "checkpoints" / "epoch=2-step=6").exists():
            raise AssertionError(f"resume: start epoch {resumed.start_epoch}, step "
                                 f"{resumed.state.step}")
        del resumed
        torch.cuda.empty_cache()
        paths["keypoint_fit"] = {k: v + launches2[k] for k, v in paths["keypoint_fit"].items()}

        last = latest_checkpoint(root / "checkpoints")
        kernels_mod.reset_launch_counts()
        t = time.perf_counter()
        metrics_card = eval_landmark.evaluate(cfg_path, last, device=dev)
        torch.cuda.synchronize()
        eval_wall = time.perf_counter() - t
        paths["keypoint_eval"] = kernels_mod.launch_counts()
        k = paths["keypoint_eval"]
        if not (k["nms_keep_sorted_batch"] and k["multilevel_roi_align"]) or (
                k["multilevel_roi_align_backward"] or k["roi_footprints"]):
            raise AssertionError(f"eval launches: {k}")
        # the same checkpoint on the CPU over the same validation batch, with
        # main_keypoints on the smoke config in its own process beside it
        main_dir = FIT_OUT / "main"
        main_dir.mkdir(parents=True)
        smoke_cfg = REPO / "pets_face_recognition_tpu_torch" / "configs" / "keypoint_smoke.py"
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
        with background([sys.executable, "-m", "pets_face_recognition_tpu_torch.main_keypoints",
                         "--config", str(smoke_cfg)], main_dir, env) as wait_main:
            vs_cpu = fit_eval_vs_cpu(config, last, dev, metrics_card["val"])
            proc, main_s = wait_main()
        emit("keypoint_fit", arch="resnet50", card=smi, data=str(MINIATURE.relative_to(REPO)),
             batch=config.train_batch_size, image=list(config.image_size),
             steps=len(ctl.step_s) + len(ctl2.step_s), first_step_ms=ctl.step_s[0] * 1e3,
             step_ms=statistics.median(ctl.step_s[1:] + ctl2.step_s) * 1e3,
             step_ms_all=[s * 1e3 for s in ctl.step_s + ctl2.step_s],
             epochs=epochs + epochs2, loader=loader, fit_s=wall, resume_fit_s=wall2,
             eval_ms_per_batch=[s * 1e3 for s in ctl.eval_s + ctl2.eval_s],
             eval_landmark_s=eval_wall, predict_s_card=vs_cpu.pop("predict_s_card"),
             predict_s_cpu=vs_cpu.pop("predict_s_cpu"),
             state_init_s=[ctl.init_s, ctl2.init_s], validation=val + val2,
             test_card=metrics_card, test_cpu=vs_cpu.pop("test_cpu"),
             test_cpu_forced=vs_cpu.pop("test_cpu_forced"), vs_cpu=vs_cpu, gates=FIT_GATES,
             checkpoint_bytes=ckpt_bytes, save_ms=save_ms, load_ms=load_ms,
             peak_mem_gib=peak, checkpoints=ckpts + ["epoch=2-step=6"],
             launches_fit=paths["keypoint_fit"], launches_resume=launches2,
             launches_eval=paths["keypoint_eval"],
             precision="float32: TF32 off inside fit and the eval step")
        if vs_cpu["failed"]:
            raise AssertionError(f"the checkpoint's eval on the card differs from the CPU: "
                                 f"{vs_cpu['failed']} {vs_cpu}")

        _, mconfig = fit_config("mobile", 1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mtrainer, mctl, paths["mobile_fit"], mwall, mepochs, mval = fit_run(
            mconfig, dev, kernels_mod, Path(mconfig.output) / "log_fit")
        if not (Path(mconfig.output) / "checkpoints" / "epoch=0-step=2").exists():
            raise AssertionError("mobile fit: no epoch=0-step=2 checkpoint")
        emit("keypoint_fit_mobile", arch="mobile", card=smi, steps=len(mctl.step_s),
             first_step_ms=mctl.step_s[0] * 1e3, step_ms_all=[s * 1e3 for s in mctl.step_s],
             epochs=mepochs, validation=mval, eval_ms_per_batch=[s * 1e3 for s in mctl.eval_s],
             fit_s=mwall, peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             launches=paths["mobile_fit"])
        del mtrainer
        torch.cuda.empty_cache()

        made = sorted(p.name for p in main_dir.glob("results_smoke/*/checkpoints/*"))
        emit("main_keypoints", config=str(smoke_cfg.relative_to(REPO)), returncode=proc.returncode,
             seconds=main_s, checkpoints=made, stdout_tail=proc.stdout[-600:],
             stderr_tail=proc.stderr[-600:])
        if proc.returncode != 0 or "Completed!" not in proc.stdout or made != ["epoch=0-step=8"]:
            raise AssertionError(f"main_keypoints failed ({proc.returncode}): {proc.stderr[-2000:]}")
    finally:
        shutil.rmtree(FIT_OUT, ignore_errors=True)   # ~0.47 GB a ResNet checkpoint
    return paths


FE_OUT = REPO / "smoke_out" / "fe"          # git-ignored; deleted after the phases
FE_KERNELS = ("warp_perspective_batch", "nms_keep_sorted_batch", "multilevel_roi_align")
FE_TRANSFORM_BATCH = 8
FE_GATES = dict(crop_abs_01=1e-3, fe_loss_rel=1e-3, fe_stats_rel_norm=1e-4,
                fe_grad_rel_norm=5e-3, eval_emb_rel_norm=1e-4, eval_metric_abs=1e-3)
# The card's JPEG encoder (nvJPEG) against PIL's libjpeg on the transform's
# 18 kept crops, in levels of the decoded pixels, largest and mean: the
# reading on an H100 80GB HBM3 was 23 and 1.0002 (the same crops give the
# same bytes in every run); the limits leave one level and 5% above it.
JPEG_GAP = dict(max=24, mean=1.05)


@contextlib.contextmanager
def recorded_preproc3():
    """Each ``Preproc3.batch`` call's photos and results, and its seconds
    (device work synchronised), while the block runs."""
    import torch
    from pets_face_recognition_tpu_torch.preprocessor import Preproc3

    calls, batch = [], Preproc3.batch

    def recording(self, images):
        t = time.perf_counter()
        out = batch(self, images)
        if out[0].is_cuda:
            torch.cuda.synchronize()
        calls.append((images, out, time.perf_counter() - t))
        return out

    Preproc3.batch = recording
    try:
        yield calls
    finally:
        Preproc3.batch = batch


def pil_jpeg(img) -> bytes:
    """``img`` as PIL's ``save`` writes a JPEG: quality 75, 4:2:0 chroma."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    return buf.getvalue()


def pil_open(data: bytes):
    import io

    from PIL import Image

    return Image.open(io.BytesIO(data))


def jfif_ycc(rgb):
    """JFIF's RGB -> YCbCr, in float64."""
    import numpy as np

    m = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                  [0.5, -0.418688, -0.081312]])
    return rgb.astype(np.float64) @ m.T + np.array([0.0, 128.0, 128.0])


def jfif_rgb(ycc):
    """JFIF's YCbCr -> RGB, rounded and clipped to uint8."""
    import numpy as np

    m = np.array([[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]])
    return np.clip(np.rint((ycc - np.array([0.0, 128.0, 128.0])) @ m.T), 0, 255).astype(np.uint8)


def jpeg_gap(card_files: list[bytes], crops: list) -> dict:
    """The card's JPEG files against what PIL's libjpeg writes from the same
    crops (quality 75, 4:2:0: PIL's ``save`` defaults, which the JAX
    transform writes with), both decoded by PIL: the largest and the mean
    pixel difference in levels, the quantisation tables and the chroma
    sampling of each (measurement only: PIL is not on the port's path). To
    say where the gap comes from, the same on three variants of the crops
    through ``native.encode_jpeg``: grey (R = G = B, so no chroma: the luma
    DCT and its rounding alone), with each 2 x 2 block's Cb and Cr averaged
    (so that any 4:2:0 downsampling filter gives the same chroma planes);
    and each channel's largest difference in YCbCr, and each encoder's mean
    difference from the crops."""
    import numpy as np
    from PIL import JpegImagePlugin
    from pets_face_recognition_tpu_torch import native

    def decoded(data):
        return np.asarray(pil_open(data).convert("RGB"), np.int16)

    def gap(ours: list[bytes], theirs: list[bytes]) -> dict:
        d = [np.abs(decoded(a) - decoded(b)) for a, b in zip(ours, theirs)]
        return dict(max=int(max(x.max() for x in d)), mean=float(np.mean([x.mean() for x in d])))

    def tables(data):
        q = pil_open(data).quantization
        return {k: list(v) for k, v in sorted(q.items())}

    libjpeg = [pil_jpeg(c) for c in crops]
    grey = [np.repeat(np.rint(jfif_ycc(c)[..., :1]).clip(0, 255).astype(np.uint8), 3, -1)
            for c in crops]
    blocks = []
    for c in crops:
        ycc = jfif_ycc(c)
        h, w = (s - s % 2 for s in ycc.shape[:2])
        chroma = ycc[:h, :w, 1:].reshape(h // 2, 2, w // 2, 2, 2).mean((1, 3))
        ycc[:h, :w, 1:] = chroma.repeat(2, 0).repeat(2, 1)
        blocks.append(jfif_rgb(ycc))
    ycc_diff = np.max([np.abs(jfif_ycc(decoded(a)) - jfif_ycc(decoded(b))).reshape(-1, 3).max(0)
                       for a, b in zip(card_files, libjpeg)], 0)
    return dict(
        files=gap(card_files, libjpeg),
        tables_equal=all(tables(a) == tables(b) for a, b in zip(card_files, libjpeg)),
        sampling={"card": sorted({JpegImagePlugin.get_sampling(pil_open(a)) for a in card_files}),
                  "libjpeg": sorted({JpegImagePlugin.get_sampling(pil_open(b))
                                     for b in libjpeg})},
        grey=gap([native.encode_jpeg(g) for g in grey], [pil_jpeg(g) for g in grey]),
        chroma_2x2=gap([native.encode_jpeg(b) for b in blocks], [pil_jpeg(b) for b in blocks]),
        ycc_max_diff=dict(zip(("Y", "Cb", "Cr"), map(float, ycc_diff))),
        mean_from_crop={"card": float(np.mean([np.abs(decoded(a) - c).mean()
                                               for a, c in zip(card_files, crops)])),
                        "libjpeg": float(np.mean([np.abs(decoded(b) - c).mean()
                                                  for b, c in zip(libjpeg, crops)]))})


def fe_transform_phase(dev, kernels_mod, smi: str) -> dict[str, dict]:
    """Phase fe_transform: the aligned-corpus transform on seeded ``data_25``
    and petfinder-extras layouts (``smoke_data``: 20 JPEG and 16 PNG photos
    of 320 x 320) through the detector route a corpus rebuild takes: a port
    checkpoint named by ``PFR_KEYPOINT_CKPT`` (the serving detector's seeded
    random weights, saved as ``epoch=0-step=0``), loaded into the full-width
    ResNet-50-FPN at ``RCNNConfig``'s test budgets (1000 proposals a level
    into K2), threshold 0. ``transform_dataset --pipeline head`` on the card
    (launch counts around it: K1 once per kept photo, K2 and K3) and on the
    CPU: the same files under the same names, the crops before encoding
    within 1e-3 on [0, 1]; the card's files against PIL's libjpeg on the
    CPU's crops (:func:`jpeg_gap`): the same quantisation tables, 4:2:0, and
    the decoded pixels within ``JPEG_GAP``. Then ``transform_reproduce``'s
    head route (``aligned``) on the card over the whole layout (its walks and
    exclusion lists) with the same detector."""
    from unittest import mock

    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch import (native, smoke_data, transform_dataset,
                                                 transform_reproduce)
    from pets_face_recognition_tpu_torch.pipelines import keypoint_detector
    from pets_face_recognition_tpu_torch.preprocessor import Preproc3
    from pets_face_recognition_tpu_torch.serving import serving_detector

    root = FE_OUT / "transform"
    t_phase = time.perf_counter()
    smoke_data.make_data25(root)
    smoke_data.make_petfinder_extras(root)
    ckpts = root / "keypoint" / "checkpoints"
    ckpts.mkdir(parents=True)
    torch.save({"model": serving_detector("cpu", 0).state_dict()}, ckpts / "epoch=0-step=0")
    photos = sorted((root / "data_25").glob("*/*.jpg"))
    argv = ["--input", str(root / "data_25"), "--thr", "0.0", "--batch-size",
            str(FE_TRANSFORM_BATCH)]
    paths, runs = {}, {}
    with mock.patch.dict(os.environ, PFR_KEYPOINT_CKPT=str(ckpts)):
        os.environ.pop("PFR_KEYPOINT_ARCH", None)
        for label, device in (("card", str(dev)), ("cpu", "cpu")):
            out = root / f"out_{label}"
            with recorded_preproc3() as calls:
                if label == "card":
                    torch.cuda.synchronize()
                    kernels_mod.reset_launch_counts()
                t = time.perf_counter()
                written = transform_dataset.main(argv + ["--output", str(out), "--device",
                                                         device])
                if label == "card":
                    torch.cuda.synchronize()
                    paths["fe_transform"] = kernels_mod.launch_counts()
                runs[label] = dict(seconds=time.perf_counter() - t, calls=calls, out=out,
                                   written=written,
                                   files=sorted(str(p.relative_to(out)) for p in written))
        pre3 = Preproc3(keypoint_detector(dev), thr=0.0, base_pts=transform_reproduce.BASE_PTS,
                        dsize=(224, 224, 3), serve_batch=FE_TRANSFORM_BATCH, device=dev)
    kernels_mod.reset_launch_counts()
    t = time.perf_counter()
    reproduced = transform_reproduce.aligned(pre3, root)
    torch.cuda.synchronize()
    reproduce_s = time.perf_counter() - t
    paths["fe_reproduce"] = kernels_mod.launch_counts()
    card, cpu = runs["card"], runs["cpu"]
    kept = sum(int(v.sum()) for _, (_, v, _), _ in card["calls"])
    crop_err, valid_equal, crops = 0.0, True, []
    for (_, (c_gpu, v_gpu, _), _), (_, (c_cpu, v_cpu, _), _) in zip(card["calls"],
                                                                   cpu["calls"]):
        valid_equal &= bool((v_gpu == v_cpu).all())
        a, b = c_gpu.cpu().numpy(), c_cpu.numpy()
        both = np.isfinite(a) & np.isfinite(b)
        valid_equal &= bool((np.isfinite(a) == np.isfinite(b)).all())
        if both.any():
            crop_err = max(crop_err, float(np.abs(a[both] - b[both]).max()) / 255.0)
        # the CPU's crops as transform_reproduce._save truncates them
        crops += [np.clip(np.nan_to_num(b[i], nan=0.0), 0, 255).astype(np.uint8)
                  for i in np.nonzero(v_cpu)[0]]
    same_files = card["files"] == cpu["files"] and len(card["files"]) == len(crops) > 0
    jpeg = jpeg_gap([p.read_bytes() for p in card["written"]], crops) if same_files else None
    reproduced_rel = sorted(str(p.relative_to(root)) for p in reproduced)
    excluded = [p for p in reproduced_rel if any(s in p for s in (
        "216319", "660074", "48683845", "45528036", "48009947/3.png", "24355557/4.png"))]
    k = paths["fe_transform"]
    emit("fe_transform", card=smi, photos=len(photos), batch=FE_TRANSFORM_BATCH,
         detector=dict(checkpoint=str(ckpts.relative_to(root)),
                       rpn_pre_nms_top_n_test=pre3.model.cfg.rpn_pre_nms_top_n_test,
                       rpn_post_nms_top_n_test=pre3.model.cfg.rpn_post_nms_top_n_test),
         route=native.route(), kept=kept, files=len(card["files"]),
         seconds_card=card["seconds"], seconds_cpu=cpu["seconds"],
         preproc3_s_card=[c[2] for c in card["calls"]],
         preproc3_s_cpu=[c[2] for c in cpu["calls"]],
         photos_per_s_card=len(photos) / card["seconds"], crop_abs_err_01=crop_err,
         valid_equal=valid_equal, same_files=same_files, jpeg=jpeg,
         launches=k, reproduce=dict(seconds=reproduce_s, files=len(reproduced),
                                    launches=paths["fe_reproduce"],
                                    outputs=sorted({p.split("/")[0] for p in reproduced_rel})),
         gates=dict(crop_abs_01=FE_GATES["crop_abs_01"], jpeg_gap=JPEG_GAP),
         seconds=time.perf_counter() - t_phase)
    if not (k["warp_perspective_batch"] == kept > 0 and k["nms_keep_sorted_batch"]
            and k["multilevel_roi_align"]):
        raise AssertionError(f"fe_transform launches {k} for {kept} kept photos")
    if not (valid_equal and same_files):
        raise AssertionError("fe_transform: the card and the CPU kept other photos")
    if not crop_err <= FE_GATES["crop_abs_01"]:
        raise AssertionError(f"fe_transform: crops {crop_err} apart")
    if not (jpeg["tables_equal"] and jpeg["sampling"]["card"] == [2]
            and jpeg["files"]["max"] <= JPEG_GAP["max"]
            and jpeg["files"]["mean"] <= JPEG_GAP["mean"]):
        raise AssertionError(f"fe_transform: the card's JPEGs against libjpeg: {jpeg}")
    r = paths["fe_reproduce"]
    if excluded or len(reproduced_rel) < 4 or not all(r[n] for n in FE_KERNELS):
        raise AssertionError(f"transform_reproduce: {reproduced_rel} excluded {excluded}, {r}")
    return paths


FE_CONFIG = """from pets_face_recognition_tpu_torch.config_presets import build_fe_config

globals().update(build_fe_config(dataset_dir={data!r}, extra_dataset_dir={extra!r},
                                 n_epochs={epochs}, num_workers=8, output={out!r},
                                 n_pairs=500, optimizer_kind={kind!r}{dtype}))
img_dir = {img!r}
"""
# fe_fit holds the card to the CPU in float32 (embeddings 1e-4, metrics
# 1e-3), and build_fe_config's default trains in bfloat16 on the card and in
# float32 on the CPU: its configs pin float32 on both sides; bf16_fe runs the
# default
FE_FLOAT32 = ', compute_dtype="float32"'


def fe_config(root: Path, name: str, epochs: int, kind: str, dtype: str = FE_FLOAT32):
    """The production FE config over the fit corpus, written as a config file
    and read back as ``main()`` reads one; ``dtype`` is the text of its
    ``compute_dtype`` argument (``FE_FLOAT32``, or "" for the default)."""
    from pets_face_recognition_tpu_torch.utils import get_config

    out = root / name
    out.mkdir(parents=True, exist_ok=True)
    path = out / "fe_fit.py"
    path.write_text(FE_CONFIG.format(data=str(root / "smoke_fe_cats"),
                                     extra=str(root / "petfinder_extra_cats"), epochs=epochs,
                                     out=str(out), kind=kind, img=str(out / "img"),
                                     dtype=dtype))
    return path, get_config(path)


def fe_timed_controller(config):
    from pets_face_recognition_tpu_torch.engine.controller import Controller

    class Timed(Controller):
        def __init__(self, config):
            super().__init__(config)
            self.step_s, self.eval_s, self.metrics, self.reserved_growth = [], [], [], []

        def train_step(self, state, batch):
            import torch

            reserved = torch.cuda.memory_reserved()
            t = time.perf_counter()
            m = super().train_step(state, batch)     # floats: synchronised
            self.step_s.append(time.perf_counter() - t)
            self.metrics.append(m)
            # the caching allocator's growth in this step (GiB): a step that
            # must allocate anew pays for it in time
            self.reserved_growth.append((torch.cuda.memory_reserved() - reserved) / 2 ** 30)
            return m

        def run_eval_batch(self, eval_step, state, batch):
            t = time.perf_counter()
            out = super().run_eval_batch(eval_step, state, batch)
            self.eval_s.append(time.perf_counter() - t)
            return out

        def evaluate(self, outputs, logger=None, epoch=0, prefix=""):
            t = time.perf_counter()
            out = super().evaluate(outputs, logger, epoch, prefix)
            self.evaluate_s = time.perf_counter() - t
            return out

    return Timed(config)


def fe_fit_run(config, dev, logdir: Path, **overrides):
    import torch
    from pets_face_recognition_tpu_torch.engine.logging import MetricsLogger
    from pets_face_recognition_tpu_torch.engine.trainer import configure_trainer

    ctl = fe_timed_controller(config)
    trainer = configure_trainer(config, MetricsLogger(logdir), device=dev, **overrides)
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.fit(ctl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    bad = [m for m in ctl.metrics if not all(math.isfinite(v) for v in m.values())]
    if bad or not ctl.metrics:
        raise AssertionError(f"non-finite or no FE losses: {bad or ctl.metrics}")
    recs = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    epochs = [{k: r[k] for k in ("step", "epoch_loss", "data_time_s", "step_time_s",
                                 "epoch_time_s")} for r in recs if "epoch_time_s" in r]
    return trainer, ctl, wall, epochs


def fe_loader_rate(config, epochs: int = 2) -> dict:
    """The training loader alone (8 threads: read, ``FETrainAug``, collate of
    64 crops): images/s over ``epochs`` epochs after one warm-up; then a
    batch's parts apart: the 64 reads on the loader's thread pool, the 64
    augmentations on it, and the collate."""
    from concurrent.futures import ThreadPoolExecutor

    from pets_face_recognition_tpu_torch.data_loading.dataset import read_image

    loader = config.train_dataloader()
    for _ in loader:
        pass
    t = time.perf_counter()
    n = sum(b["x"].shape[0] for _ in range(epochs) for b in loader)
    s = time.perf_counter() - t
    subset = loader.dataset.datasets[0]             # RecSubset of the corpus
    idx = list(range(loader.batch_size))
    paths = [subset.dataset.index_to_path[subset.indices[i]] for i in idx]
    with ThreadPoolExecutor(loader.num_workers) as pool:
        t = time.perf_counter()
        imgs = list(pool.map(read_image, paths))
        read_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        xs = list(pool.map(subset.transform, imgs))
        aug_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    loader.collate_fn([{"x": x, "label": 0, "index": i} for i, x in enumerate(xs)])
    collate_ms = (time.perf_counter() - t) * 1e3
    return dict(images=n, seconds=s, images_per_s=n / s, threads=loader.num_workers,
                batch=loader.batch_size, read_ms_per_batch=read_ms,
                fe_train_aug_ms_per_batch=aug_ms, collate_ms_per_batch=collate_ms)


def fe_snapshot(state) -> dict:
    return {"model": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
            "momentum": [state.optimizer.state[p]["momentum_buffer"].detach().cpu().clone()
                         for g in state.optimizer.param_groups for p in g["params"]],
            "step": state.step}


def fe_step_vs_cpu(dev) -> dict:
    """One reduced FE step (full ResNet-50 -> 512 depth and width, B = 8 at
    128 x 128, 64 classes, the FE SGD) from the same weights on the card and
    on the CPU: loss within 1e-3 relative, running statistics within 1e-4
    relative in norm, gradients within 5e-3 relative in norm or twice what
    the card's own step moves under 1e-6 input rounding (the largest of
    three draws, worst and median tensor; the live-BN step is
    ill-conditioned in float32, ROADMAP §3 note 9)."""
    import copy
    from functools import partial

    import numpy as np
    from pets_face_recognition_tpu_torch.engine.controller import Controller
    from pets_face_recognition_tpu_torch.losses import SoftmaxBasedMetricLearning
    from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
    from pets_face_recognition_tpu_torch.utils import DictWrapper
    from pets_face_recognition_tpu_torch.utils.optim import fe_sgd_optimizer
    from pets_face_recognition_tpu_torch.weights import init_random_

    B, image, C = 8, 128, 64
    rng = np.random.RandomState(2)
    batch = {"x": rng.rand(B, image, image, 3).astype(np.float32),
             "label": rng.randint(0, C, B), "index": np.arange(B)}
    cpu_model = init_random_(SoftmaxBasedMetricLearning(resnet50_embedder(512), 512, C), 3)
    ctl = Controller(DictWrapper({"optimizer": lambda c: partial(fe_sgd_optimizer, lr=1e-2)}))
    runs = [("gpu", dev, batch)] + [
        (f"gpu_rounded_{s}", dev, dict(batch, x=(batch["x"] * (1 + np.random.RandomState(
            s).randn(*batch["x"].shape) * 1e-6)).astype(np.float32))) for s in (1, 2, 3)]
    runs.append(("cpu", "cpu", batch))
    out = {}
    for name, device, b in runs:
        model = cpu_model if device == "cpu" else copy.deepcopy(cpu_model)
        state = ctl.init_state(0, device, model=model)
        t = time.perf_counter()
        m = ctl.train_step(state, b)
        out[name] = (m, {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                     {n: v.detach().cpu() for n, v in model.named_buffers()},
                     time.perf_counter() - t)

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))

    (m_gpu, g_gpu, s_gpu, t_gpu), (m_cpu, g_cpu, s_cpu, t_cpu) = out["gpu"], out["cpu"]
    grad_rel = {n: rel(g_gpu[n], g_cpu[n]) for n in g_cpu}
    spreads = [[rel(out[f"gpu_rounded_{s}"][1][n], g_gpu[n]) for n in g_cpu] for s in (1, 2, 3)]
    worst_bound = max(FE_GATES["fe_grad_rel_norm"], 2 * max(max(x) for x in spreads))
    median_bound = max(FE_GATES["fe_grad_rel_norm"],
                       2 * max(statistics.median(x) for x in spreads))
    worst = max(grad_rel, key=grad_rel.get)
    stat_rel = {n: rel(s_gpu[n], s_cpu[n]) for n in s_cpu}
    stat_worst = max(stat_rel, key=stat_rel.get)
    res = dict(batch=B, image=image, classes=C, loss_gpu=m_gpu["loss"], loss_cpu=m_cpu["loss"],
               loss_rel_err=abs(m_gpu["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"]),
               train_acc=[m_gpu["train_acc"], m_cpu["train_acc"]],
               grad_rel_err_max=grad_rel[worst], grad_rel_err_worst=worst,
               grad_rel_err_median=statistics.median(grad_rel.values()),
               card_rounding_spread={"worst": [max(x) for x in spreads],
                                     "median": [statistics.median(x) for x in spreads]},
               grad_bounds={"worst": worst_bound, "median": median_bound},
               running_stats_rel_err_max=stat_rel[stat_worst], running_stats_worst=stat_worst,
               step_s_gpu=t_gpu, step_s_cpu=t_cpu)
    if not (res["loss_rel_err"] <= FE_GATES["fe_loss_rel"]
            and grad_rel[worst] <= worst_bound and res["grad_rel_err_median"] <= median_bound
            and stat_rel[stat_worst] <= FE_GATES["fe_stats_rel_norm"]):
        raise AssertionError(f"the FE step on the card differs from the CPU: {res}")
    return res


def fe_metric_ms(ctl, outputs) -> dict[str, float]:
    """``evaluate``'s parts apart on one validation pass, ms each: the pair
    similarities, ``verification_metrics`` and Recall@K (host numpy and
    torch on the CPU, as ``evaluate`` runs them)."""
    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch.engine.metrics import (cosine_pair_scores, recall_at_k,
                                                                verification_metrics)

    order = np.argsort(np.concatenate([b["index"] for b in outputs]))
    emb = np.concatenate([b["emb"] for b in outputs])[order]
    classes = np.concatenate([b["label"] for b in outputs])[order]
    gen = ctl.config.pair_generator(0)[1]
    pairs, labels = np.asarray(gen.corrected_indices), np.asarray(gen.labels)
    t = time.perf_counter()
    scores = cosine_pair_scores(torch.from_numpy(emb), pairs).numpy()
    t1 = time.perf_counter()
    verification_metrics(scores, labels, thrs=tuple(ctl.config.thrs),
                         far_thrs=tuple(ctl.config.far_thr))
    t2 = time.perf_counter()
    recall_at_k(emb, classes, tuple(ctl.config.k))
    t3 = time.perf_counter()
    return dict(pairs=(t1 - t) * 1e3, verification=(t2 - t1) * 1e3, recall_at_k=(t3 - t2) * 1e3,
                n_pairs=len(pairs), n_embeddings=len(emb))


def sorted_embeddings(outputs):
    import numpy as np

    e = np.concatenate([b["emb"] for b in outputs])
    return e[np.argsort(np.concatenate([b["index"] for b in outputs]))]


def mean_pair_cosine(e) -> float:
    import numpy as np

    unit = e / np.linalg.norm(e, axis=1, keepdims=True)
    cos = unit @ unit.T
    return float(cos[~np.eye(len(cos), dtype=bool)].mean())


def fe_eval_pair(cfg_path: Path, ckpt: Path, dev) -> tuple[dict, tuple, dict]:
    """``eval_fe.predict`` of ``ckpt`` on the card and on the CPU: the
    validation embeddings' relative difference in norm, each metric's
    difference, the card's metrics and the mean pair cosine; the card's
    controller and outputs; the differences by metric."""
    import numpy as np
    from pets_face_recognition_tpu_torch import eval_fe

    (ctl_card, out_card), (ctl_cpu, out_cpu) = (eval_fe.predict(cfg_path, ckpt, device)
                                                for device in (dev, "cpu"))
    e_card, e_cpu = sorted_embeddings(out_card), sorted_embeddings(out_cpu)
    m_card = ctl_card.evaluate([out_card])["Val"]
    m_cpu = ctl_cpu.evaluate([out_cpu])["Val"]
    diff = {k: abs(m_card[k] - m_cpu[k]) for k in m_cpu if k in m_card}
    res = dict(emb_rel_err=float(np.linalg.norm(e_card - e_cpu) / np.linalg.norm(e_cpu)),
               same_names=list(m_card) == list(m_cpu), metric_max_diff=max(diff.values()),
               metric_diff={k: v for k, v in diff.items() if v}, metrics_card=m_card,
               mean_pair_cosine=mean_pair_cosine(e_cpu))
    return res, (ctl_card, out_card), diff


def fe_eval_vs_cpu(cfg_path: Path, last: Path, dev) -> dict:
    """``eval_fe``'s evaluation on the card against the CPU, twice.
    ``trained``: the fit's last checkpoint, the validation embeddings within
    1e-4 relative in norm; its metrics are printed, not held: a few steps
    from random weights map every crop near one direction (mean pair cosine
    ~0.9998), where float32 resolves few distinct pair scores, so a
    last-bit difference moves a metric by whole pairs. ``centred``: the
    fit's seeded initial weights with the embedder's ``fc`` bias moved by
    minus the card's mean validation embedding (the last layer's bias alone
    changes; pair cosines then spread around 0), embeddings within 1e-4 and
    every metric within 1e-3."""
    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch import eval_fe
    from pets_face_recognition_tpu_torch.engine.controller import Controller
    from pets_face_recognition_tpu_torch.utils import get_config

    trained, _, _ = fe_eval_pair(cfg_path, last, dev)
    model = Controller(get_config(cfg_path)).init_state(0, "cpu").model.state_dict()
    initial = FE_OUT / "centred" / "initial"
    initial.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": model}, initial)
    _, raw = eval_fe.predict(cfg_path, initial, dev)
    model["model.fc.bias"] = model["model.fc.bias"] - torch.from_numpy(
        np.concatenate([b["emb"] for b in raw]).mean(0))
    torch.save({"model": model}, initial)
    centred, card, diff = fe_eval_pair(cfg_path, initial, dev)
    centred["mean_pair_cosine_uncentred"] = mean_pair_cosine(sorted_embeddings(raw))
    bad = {k: v for k, v in diff.items() if not v <= FE_GATES["eval_metric_abs"]}
    ok = (trained["same_names"] and centred["same_names"] and not bad
          and max(trained["emb_rel_err"], centred["emb_rel_err"]) <= FE_GATES[
              "eval_emb_rel_norm"])
    return dict(ok=ok, bad=bad, trained=trained, centred=centred,
                metric_ms=fe_metric_ms(*card))


def fe_step_contention(config, dev, reps: int = 5) -> dict:
    """The FE step on one fixed batch, alone and while the training loader
    runs in a background thread as it does during an epoch (8 threads of
    numpy ``FETrainAug`` beside the step's own Python): ms a step each way."""
    import threading

    import torch
    from pets_face_recognition_tpu_torch.engine.controller import Controller

    ctl = Controller(config)
    state = ctl.init_state(1, dev)
    loader = config.train_dataloader()
    batch = next(iter(loader))

    def steps() -> list[float]:
        out = []
        for _ in range(reps):
            t = time.perf_counter()
            ctl.train_step(state, batch)               # floats: synchronised
            out.append((time.perf_counter() - t) * 1e3)
        return out

    steps()                                            # warm-up
    alone = steps()
    stop, served = threading.Event(), [0]

    def churn():
        while not stop.is_set():
            for b in loader:
                served[0] += len(b["x"])
                if stop.is_set():
                    break

    thread = threading.Thread(target=churn, daemon=True)
    thread.start()
    time.sleep(0.5)                                    # the workers under way
    t = time.perf_counter()
    n0 = served[0]
    busy = steps()
    loader_rate = (served[0] - n0) / (time.perf_counter() - t)
    stop.set()
    thread.join()
    del state
    torch.cuda.empty_cache()
    return dict(step_ms_alone=alone, step_ms_with_loader=busy,
                loader_images_per_s_meanwhile=loader_rate)


def fe_fit_phase(dev, kernels_mod, smi: str) -> dict[str, dict]:
    """Phase fe_fit: the feature extractor trained from data at production
    width (``build_fe_config``: ResNet-50 -> 512, ArcFace s 64 m 0.5, B = 64
    at 224 x 224, 8 loader threads) over a seeded aligned-crop corpus
    (``smoke_data.make_fe``: 64 identities of 6 crops, 32 for training: 3
    steps an epoch with the petfinder-extras corpus; 10 validation batches
    of 20; 500 pairs): SGD for 2 epochs, a resume into a third, AdamW for 1;
    checkpoints, a bit-equal restore; the loader alone; ``main`` on the smoke
    config in a subprocess; ``eval_fe`` on the last checkpoint, on the card
    against the CPU for that checkpoint and for the initial weights with a
    centred ``fc`` bias (:func:`fe_eval_vs_cpu`: embeddings 1e-4, the
    latter's metrics 1e-3); one reduced step on the card against the CPU. FE training runs no hand-written kernel: the path's
    launch counts are read and must be 0."""
    import torch
    from pets_face_recognition_tpu_torch import eval_fe, smoke_data
    from pets_face_recognition_tpu_torch.engine.checkpoint import (
        latest_checkpoint, restore_checkpoint, save_checkpoint)

    root = FE_OUT / "fit"
    t = t_phase = time.perf_counter()
    smoke_data.make_fe(root, n_ids=64, n_imgs=6, size=224)
    smoke_data.make_petfinder_extras(root, n_cards=4, n_imgs=3)
    corpus_s = time.perf_counter() - t
    cfg_path, config = fe_config(root, "sgd", 2, "sgd")
    out = Path(config.output)
    loader = fe_loader_rate(config)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launch_counts()
    trainer, ctl, wall, epochs = fe_fit_run(config, dev, out / "log_fit")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = len(config.train_dataloader())             # 3 steps an epoch
    ckpts = sorted(p.name for p in (out / "checkpoints").iterdir())
    if ckpts != [f"epoch=0-step={n}", f"epoch=1-step={2 * n}"]:
        raise AssertionError(f"FE checkpoints after 2 epochs: {ckpts}")
    saved = fe_snapshot(trainer.state)
    torch.cuda.synchronize()
    t = time.perf_counter()
    probe = save_checkpoint(FE_OUT / "timing", trainer.state, 1)
    save_ms = (time.perf_counter() - t) * 1e3
    ckpt_bytes = probe.stat().st_size
    del trainer
    fresh = ctl.init_state(0, dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    epoch = restore_checkpoint(fresh, latest_checkpoint(out / "checkpoints"))
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t) * 1e3
    got = fe_snapshot(fresh)
    differ = [k for k, v in got["model"].items() if not torch.equal(v, saved["model"][k])]
    differ += [f"momentum {i}" for i, (a, b) in enumerate(zip(got["momentum"],
                                                             saved["momentum"]))
               if not torch.equal(a, b)]
    if differ or got["step"] != 2 * n or epoch != 1 or len(got["momentum"]) != len(
            saved["momentum"]):
        raise AssertionError(f"restored FE state differs: step {got['step']}, epoch {epoch}, "
                             f"{differ[:5]}")
    del fresh, got, saved
    resumed, ctl2, wall2, epochs2 = fe_fit_run(config, dev, out / "log_resume", max_epochs=3)
    if resumed.start_epoch != 2 or resumed.state.step != 3 * n or not (
            out / "checkpoints" / f"epoch=2-step={3 * n}").exists():
        raise AssertionError(f"FE resume: start epoch {resumed.start_epoch}, step "
                             f"{resumed.state.step}")
    del resumed
    paths = {"fe_fit": kernels_mod.launch_counts()}
    if any(paths["fe_fit"].values()):
        raise AssertionError(f"FE training launched a hand-written kernel: {paths['fe_fit']}")
    torch.cuda.empty_cache()

    _, aconfig = fe_config(root, "adamw", 1, "adamw")
    atrainer, actl, awall, aepochs = fe_fit_run(aconfig, dev, Path(aconfig.output) / "log_fit")
    if not isinstance(atrainer.state.optimizer, torch.optim.AdamW) or not (
            Path(aconfig.output) / "checkpoints" / f"epoch=0-step={n}").exists():
        raise AssertionError(f"FE AdamW fit: no AdamW state or no epoch=0-step={n}")
    del atrainer
    torch.cuda.empty_cache()

    last = latest_checkpoint(out / "checkpoints")
    t = time.perf_counter()
    m_entry = eval_fe.main(["--config", str(cfg_path), "--ckpt", str(last), "--device",
                            str(dev)])["Val"]
    eval_fe_s = time.perf_counter() - t
    contention = fe_step_contention(config, dev)

    # main on the smoke config in its own process, beside the CPU references
    main_dir = FE_OUT / "main"
    main_dir.mkdir(parents=True)
    smoke_cfg = REPO / "pets_face_recognition_tpu_torch" / "configs" / "fe_smoke.py"
    env = dict(os.environ, PFR_SMOKE_ROOT=str(main_dir / "data"), PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    with background([sys.executable, "-m", "pets_face_recognition_tpu_torch.main", "--config",
                     str(smoke_cfg)], main_dir, env) as wait_main:
        cmp = fe_eval_vs_cpu(cfg_path, last, dev)
        step_cpu = fe_step_vs_cpu(dev)
        proc, main_s = wait_main()
    made = sorted(p.name for p in main_dir.glob("results_smoke/*/checkpoints/*"))

    emit("fe_fit", card=smi, corpus=dict(identities=64, crops=384, train_crops=len(
        config.train_dataloader().dataset), extras_identities=config.num_classes - len(
        config.dataset.get_users()) // 2,
        seconds=corpus_s), batch=config.train_batch_size, image=224, classes=config.num_classes,
         steps=len(ctl.step_s) + len(ctl2.step_s), first_step_ms=ctl.step_s[0] * 1e3,
         step_ms=statistics.median(ctl.step_s[1:] + ctl2.step_s) * 1e3,
         step_ms_all=[s * 1e3 for s in ctl.step_s + ctl2.step_s],
         reserved_growth_gib=ctl.reserved_growth + ctl2.reserved_growth,
         adamw_step_ms_all=[s * 1e3 for s in actl.step_s], peak_mem_gib=peak,
         epochs=epochs + epochs2, adamw_epochs=aepochs, loader=loader, fit_s=wall,
         resume_fit_s=wall2, adamw_fit_s=awall,
         eval_ms_per_batch=statistics.median(ctl.eval_s + ctl2.eval_s) * 1e3,
         eval_batches_per_epoch=len(ctl.eval_s) // 2, evaluate_ms=ctl.evaluate_s * 1e3,
         losses=[m["loss"] for m in ctl.metrics + ctl2.metrics],
         train_acc=[m["train_acc"] for m in ctl.metrics + ctl2.metrics],
         checkpoints=ckpts + [f"epoch=2-step={3 * n}"], checkpoint_bytes=ckpt_bytes,
         save_ms=save_ms, load_ms=load_ms, launches=paths["fe_fit"],
         eval_fe_s=eval_fe_s, eval_fe=m_entry, eval_vs_cpu=cmp, step_vs_cpu=step_cpu,
         contention=contention, seconds=time.perf_counter() - t_phase,
         gates=FE_GATES, precision="float32: TF32 off inside fit, the steps and eval")
    emit("main_fe", config=str(smoke_cfg.relative_to(REPO)), returncode=proc.returncode,
         seconds=main_s, checkpoints=made, stdout_tail=proc.stdout[-400:],
         stderr_tail=proc.stderr[-600:])
    if not cmp["ok"]:
        raise AssertionError(f"eval_fe on the card differs from the CPU: {cmp}")
    if proc.returncode != 0 or "Completed!" not in proc.stdout or made != [
            "epoch=0-step=3", "epoch=1-step=6"]:
        raise AssertionError(f"main (FE) failed ({proc.returncode}): {proc.stderr[-2000:]}")
    return paths


def fe_phases(dev, kernels_mod, smi: str) -> dict[str, dict]:
    """fe_transform, fe_fit and bf16_fe, everything under the git-ignored
    ``smoke_out/fe``, deleted after them."""
    import shutil

    shutil.rmtree(FE_OUT, ignore_errors=True)
    try:
        paths = fe_transform_phase(dev, kernels_mod, smi)
        paths.update(fe_fit_phase(dev, kernels_mod, smi))
        paths.update(bf16_fe_phase(dev, smi))          # over fe_fit's corpus
    finally:
        shutil.rmtree(FE_OUT, ignore_errors=True)   # ~0.2 GB an FE checkpoint
    return paths


MASK_OUT = REPO / "smoke_out" / "mask"      # git-ignored; deleted after the phases
# the Mask R-CNN paths: their launches make the kernels line's "_mask" rows
MASK_PATHS = ("mask_serve", "body_tsv", "masked_transform", "masked_reproduce",
              "prepare_tables", "mask_train", "mask_eval")
MASK_GATES = dict(box_rel_to_side=1e-4, score_abs=1e-5, mask_abs=1e-4, k3_abs=1e-4,
                  crop_abs_01=1e-3, table_score_abs=1e-5, threshold_band=1e-4)
MASK_TRANSFORM_BATCH = 8
# random mask logits sit near 0 (probabilities 0.5 +- 0.05 at full width):
# the masked smoke's checkpoint scales the logits' 1 x 1 conv by this, so
# that the route's 0.7 threshold cuts inside the masks
MASK_LOGIT_SPREAD = 10.0


@contextlib.contextmanager
def mask_call_sites():
    """Mask R-CNN's K2 and K3 calls on CUDA tensors by call site while the
    block runs: K2 in the RPN and in the box NMS, K3 on the box and on the
    mask RoIs; with copies of the last box NMS's and mask RoIAlign's inputs.
    Yields ``(tally, last)``."""
    from pets_face_recognition_tpu_torch.models import rcnn, roi_heads, rpn

    tally = dict(k2_rpn=0, k2_box=0, k3_box=0, k3_mask=0)
    last = {}
    rpn_nms, box_nms = rpn.nms_keep_sorted_batch_cuda, roi_heads.nms_keep_sorted_batch_cuda
    roi_align = rcnn.GeneralizedRCNN._roi_align

    def counted(fn, key):
        def call(boxes, valid, thr):
            if boxes.is_cuda:
                tally[key] += 1
                last[key] = (boxes.clone(), valid.clone(), thr)
            return fn(boxes, valid, thr)
        return call

    def pooled(self, pool, strides, boxes_flat, batch_idx, output_size, *head):
        if boxes_flat.is_cuda:
            key = "k3_mask" if tuple(output_size) == (self.cfg.mask_roi_size,) * 2 else "k3_box"
            tally[key] += 1
            last[key] = ([f.clone() for f in pool[1]], boxes_flat.clone(), batch_idx.clone(),
                         tuple(strides[:len(pool[1])]))
        return roi_align(self, pool, strides, boxes_flat, batch_idx, output_size, *head)

    rpn.nms_keep_sorted_batch_cuda = counted(rpn_nms, "k2_rpn")
    roi_heads.nms_keep_sorted_batch_cuda = counted(box_nms, "k2_box")
    rcnn.GeneralizedRCNN._roi_align = pooled
    try:
        yield tally, last
    finally:
        rpn.nms_keep_sorted_batch_cuda, roi_heads.nms_keep_sorted_batch_cuda = rpn_nms, box_nms
        rcnn.GeneralizedRCNN._roi_align = roi_align


def mask_serve_phase(dev, kernels_mod, smi: str) -> tuple[dict, dict]:
    """Phase mask_serve: ``pipelines.mask_detector`` (the full-width
    ResNet-50-FPN Mask R-CNN, 3 detections, RPN 1000/1000, box NMS 0.5,
    score threshold 0.05; seeded random weights) on a seeded B = 8 batch of
    320 x 320: the launch counts of one call by call site, the same batch on
    the CPU (boxes within 1e-4 of the image side, scores 1e-5, masks 1e-4,
    labels and validity equal), K2 on the call's own (8, 1000) box NMS input
    and K3 on its 24 mask RoIs at 14 x 14 against their plain versions, each
    timed beside its bound, a warm call's ms and peak memory. Returns the
    path's launch counts and the two kernel rows."""
    import torch
    from pets_face_recognition_tpu_torch.device import float32_matmuls
    from pets_face_recognition_tpu_torch.kernel_ab import cuda_ms
    from pets_face_recognition_tpu_torch.ops import nms, roi_align
    from pets_face_recognition_tpu_torch.pipelines import mask_detector
    from pets_face_recognition_tpu_torch.profile_serving import nms_work

    t_phase = time.perf_counter()
    det = mask_detector(dev, 0)
    g = torch.Generator().manual_seed(11)
    x = torch.randint(0, 256, (B_KERNELS, IMAGE, IMAGE, 3), generator=g,
                      dtype=torch.uint8).float() / 255.0
    xd = x.to(dev)
    with torch.inference_mode(), float32_matmuls():
        det(xd)                                  # cuDNN's and the allocator's set-up
        torch.cuda.synchronize()
        with mask_call_sites() as (tally, last):
            kernels_mod.reset_launch_counts()
            out = det(xd)
            torch.cuda.synchronize()
            launches = kernels_mod.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(10):
            t = time.perf_counter()
            det(xd)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        det_cpu = mask_detector("cpu", 0)
        t = time.perf_counter()
        ref = det_cpu(x)
        cpu_s = time.perf_counter() - t
    del det_cpu
    got = {k: v.cpu() for k, v in out.items()}
    checks = dict(
        valid_equal=bool(torch.equal(got["valid"], ref["valid"])),
        labels_equal=bool(torch.equal(got["labels"], ref["labels"])),
        box_rel_to_side=max_err(got["boxes"], ref["boxes"]) / IMAGE,
        score_abs=max_err(got["scores"], ref["scores"]),
        mask_abs=max_err(got["masks"], ref["masks"]),
        finite=all(bool(torch.isfinite(v.float()).all()) for v in got.values()))

    # K2 on the box NMS's own input: (B, N * (C - 1)) = (8, 1000) sorted groups
    boxes, valid, thr = last["k2_box"]
    k2 = lambda: nms.nms_keep_sorted_batch_cuda(boxes, valid, thr)  # noqa: E731
    keep, want = k2(), nms.nms_keep_sorted_batch(boxes, valid, thr)
    torch.cuda.synchronize()
    n_iou = int(nms_work(boxes, valid, want, thr)["ious"].sum())
    b, by = bound_ms(boxes.numel() * 4 + valid.numel() + keep.numel(), n_iou * 13)
    k2_row = dict(max_abs_err=max_err(keep, want), ms=cuda_ms(k2),
                  plain_ms=cuda_ms(lambda: nms.nms_keep_sorted_batch(boxes, valid, thr),
                                   iters=5),
                  bound_ms=b, bound_by=by, library_ms=None)
    emit("kernel", name="K2 nms_keep_sorted_batch (box NMS)", shape=list(boxes.shape),
         mismatches=int((keep != want).sum()), valid=int(valid.sum()), kept=int(keep.sum()),
         ious=n_iou, kernel_device_us=kernel_us(k2, K2_KERNELS), card=smi,
         library="none (no torchvision)", **k2_row)

    # K3 on the mask RoIs: B * D = 24 detections at 14 x 14 on p2..p5
    feats, rois, bidx, strides = last["k3_mask"]
    r = det.cfg.mask_roi_size
    args = (feats, rois, bidx, (r, r), strides)
    k3 = lambda: roi_align.multilevel_roi_align_cuda(*args)  # noqa: E731
    pooled, plain = k3(), roi_align.multilevel_roi_align(*args)
    torch.cuda.synchronize()
    C = feats[0].shape[-1]
    cells = touched_cells(feats, rois, bidx, (r, r), strides)
    b, by = bound_ms(cells * C * 4 + rois.numel() * 4 + bidx.numel() * 4 + pooled.numel() * 4,
                     pooled.numel() * (8 * 4 + 1))
    k3_row = dict(max_abs_err=max_err(pooled, plain), ms=cuda_ms(k3),
                  plain_ms=cuda_ms(lambda: roi_align.multilevel_roi_align(*args)),
                  bound_ms=b, bound_by=by, library_ms=None)
    emit("kernel", name=f"K3 multilevel_roi_align {r}x{r} (mask RoIs)", rois=rois.shape[0],
         atol=MASK_GATES["k3_abs"], touched_cells=cells, card=smi,
         kernel_device_us=kernel_us(k3, "multilevel_roi_align_kernel"),
         library="none (no torchvision)", **k3_row)
    emit("mask_serve", card=smi, batch=B_KERNELS, image=IMAGE,
         config=dict(rpn_pre_nms_top_n_test=det.cfg.rpn_pre_nms_top_n_test,
                     rpn_post_nms_top_n_test=det.cfg.rpn_post_nms_top_n_test,
                     box_nms_thresh=det.cfg.box_nms_thresh,
                     box_score_thresh=det.cfg.box_score_thresh,
                     box_detections_per_img=det.cfg.box_detections_per_img),
         launches=launches, launches_by_call_site=tally, box_nms_shape=list(boxes.shape),
         detections=int(got["valid"].sum()), ms_median=statistics.median(times),
         ms_min=min(times), ms_max=max(times), ms_all=times, images_per_s=B_KERNELS * 1e3
         / statistics.median(times), peak_mem_gib=peak, cpu_forward_s=cpu_s,
         vs_cpu=checks, gates=MASK_GATES, seconds=time.perf_counter() - t_phase)
    if tally != dict(k2_rpn=1, k2_box=1, k3_box=1, k3_mask=1) or launches[
            "nms_keep_sorted_batch"] != 2 or launches["multilevel_roi_align"] != 2:
        raise AssertionError(f"mask_serve launches {launches}, by call site {tally}")
    if tuple(boxes.shape) != (B_KERNELS, 1000, 4) or tuple(rois.shape) != (B_KERNELS * 3, 4):
        raise AssertionError(f"mask_serve shapes: box NMS {tuple(boxes.shape)}, "
                             f"mask RoIs {tuple(rois.shape)}")
    if not (checks["valid_equal"] and checks["labels_equal"] and checks["finite"]
            and checks["box_rel_to_side"] <= MASK_GATES["box_rel_to_side"]
            and checks["score_abs"] <= MASK_GATES["score_abs"]
            and checks["mask_abs"] <= MASK_GATES["mask_abs"]):
        raise AssertionError(f"mask_serve: the card against the CPU: {checks}")
    if k2_row["max_abs_err"] or not k3_row["max_abs_err"] <= MASK_GATES["k3_abs"]:
        raise AssertionError(f"mask kernels against their plain versions: K2 {k2_row}, "
                             f"K3 {k3_row}")
    del det, out, last
    torch.cuda.empty_cache()
    return {"mask_serve": launches}, {"nms_keep_sorted_batch_mask": k2_row,
                                      "multilevel_roi_align_mask": k3_row}


@contextlib.contextmanager
def body_probe(sync):
    """Record each photo's steps inside ``generate_tsv``'s walk with the
    body: its (width, height) and seconds of decode, ``Preproc3``,
    ``Preproc4`` and ``resize_with_padding`` (the device synchronised after
    each), of each pipeline call, and what they gave (validity, the body box,
    the 256 x 256 letterboxed crop, the two vectors). Yields ``(rec,
    wrap_head, wrap_body)``."""
    from pets_face_recognition_tpu_torch import generate_tsv, pipelines
    from pets_face_recognition_tpu_torch.preprocessor import Preproc3, Preproc4

    rec: list[dict] = []
    read, b3, b4 = generate_tsv.read_image, Preproc3.batch, Preproc4.batch
    resize = pipelines.resize_with_padding

    def timed(fn, key, what):
        def call(*a):
            t = time.perf_counter()
            out = fn(*a)
            sync()
            rec[-1][key] = time.perf_counter() - t
            rec[-1].update(what(out))
            return out
        return call

    def timed_read(path):
        t = time.perf_counter()
        img = read(path)
        rec.append(dict(size=(img.shape[1], img.shape[0]), decode=time.perf_counter() - t,
                        head_valid=False, body_valid=False, vec=None, body_vec=None))
        return img

    generate_tsv.read_image = timed_read
    Preproc3.batch = timed(b3, "preproc3", lambda o: dict(head_valid=bool(o[1][0])))
    Preproc4.batch = timed(b4, "preproc4", lambda o: dict(body_valid=bool(o[1][0]),
                                                          box=o[2]["boxes"][0].copy()))
    pipelines.resize_with_padding = timed(resize, "resize", lambda o: dict(padded=o))
    wrap_head = lambda fn: timed(fn, "head", lambda v: dict(vec=v))  # noqa: E731
    wrap_body = lambda fn: timed(fn, "body", lambda v: dict(body_vec=v))  # noqa: E731
    try:
        yield rec, wrap_head, wrap_body
    finally:
        generate_tsv.read_image, Preproc3.batch, Preproc4.batch = read, b3, b4
        pipelines.resize_with_padding = resize


def run_body_chain(device, kernels_mod, label: str) -> dict:
    """``generate_tsv --body`` over the committed corpus on ``device``
    (``PFR_RETRIEVAL_THR=0``), its tsv and score dump under ``OUT_DIR``, with
    the launch counts and each photo's record (``body_probe``) of its walk;
    on the card, each photo size's first photo goes through both pipelines
    once before the walk (cuDNN's and the allocator's set-up)."""
    from unittest import mock

    import torch
    from pets_face_recognition_tpu_torch import generate_tsv, retrieval

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tsv, dump = OUT_DIR / f"pred_scores_test1_{label}.tsv", OUT_DIR / f"scores1_{label}.npz"
    run = {}
    walk = generate_tsv.prepare_data

    def timed_walk(path, head, cache=None, body_pipeline=None):
        if cuda:
            firsts = {}
            for p in sorted(path.rglob("*.jpg")):
                img = generate_tsv.read_image(p)
                firsts.setdefault(img.shape, img)
            for img in firsts.values():
                for animal in (1, 2):
                    head(img, animal)
                    body_pipeline(img, animal)
            sync()
        with body_probe(sync) as (rec, wrap_head, wrap_body):
            kernels_mod.reset_launch_counts()
            t = time.perf_counter()
            db = walk(path, wrap_head(head), cache, wrap_body(body_pipeline))
            sync()
            run.update(chain_s=time.perf_counter() - t, launches=kernels_mod.launch_counts(),
                       rec=rec, db=db)
        return db

    with mock.patch.dict(os.environ, PFR_RETRIEVAL_THR="0.0", PFR_SCORES_DUMP=str(dump)), \
            mock.patch.object(generate_tsv, "prepare_data", timed_walk):
        os.environ.pop("PFR_MASK_CKPT", None)
        rc = generate_tsv.main(["--data", str(CORPUS), "--body", "--output", str(tsv),
                                "--device", str(device)])
    if rc != 0:
        raise AssertionError(f"generate_tsv --body on {device} returned {rc}")
    return dict(run, rows=retrieval.read_tsv(tsv), dump=retrieval.load_scores_dump(dump))


def body_tsv_phase(dev, kernels_mod, smi: str) -> dict:
    """Phase body_tsv: ``generate_tsv --body`` (the head+body ensemble) over
    the committed kashtanka corpus on the card and on the CPU, with seeded
    random weights and the detection threshold 0: the same kept photos, the
    same body boxes, the letterboxed body crops equal where the boxes agree,
    head and body embeddings within 1e-5 relative, scores within 1e-6 (rank
    flips only across gaps below that), the same tsv rows (numbers within
    1e-6); the launch counts of the card's walk (K1 once per kept head, K2
    and K3 launched); images/s and each step's ms a photo."""
    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch import retrieval

    t_phase = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    card = run_body_chain(dev, kernels_mod, "card")
    cpu = run_body_chain(torch.device("cpu"), kernels_mod, "cpu")
    a, b = card["rec"], cpu["rec"]
    if [r["size"] for r in a] != [r["size"] for r in b]:
        raise AssertionError("body_tsv: the two runs read other photos")

    def rel(x, y):
        return float(np.abs(x - y).max() / np.abs(y).max())

    heads = [(x, y) for x, y in zip(a, b) if x["head_valid"] and y["head_valid"]]
    bodies = [(x, y) for x, y in zip(a, b) if x["body_valid"] and y["body_valid"]]
    same_box = [(x, y) for x, y in bodies if (np.round(x["box"]) == np.round(y["box"])).all()]
    report = retrieval.near_tie_report(cpu["dump"], card["dump"])
    rows_a, rows_b = card["rows"], cpu["rows"]
    numbers = max((abs(p - q) for ra, rb in zip(rows_a, rows_b) for p, q in zip(ra[1:4], rb[1:4])
                   if p is not None and q is not None), default=0.0)
    d = dict(photos=len(a), head_kept=len(heads), body_kept=len(bodies),
             head_valid_differ=sum(x["head_valid"] != y["head_valid"] for x, y in zip(a, b)),
             body_valid_differ=sum(x["body_valid"] != y["body_valid"] for x, y in zip(a, b)),
             body_boxes_differ=len(bodies) - len(same_box),
             body_crops_differ=sum(not np.array_equal(x["padded"], y["padded"])
                                   for x, y in same_box),
             head_emb_rel=max((rel(x["vec"], y["vec"]) for x, y in heads), default=0.0),
             body_emb_rel=max((rel(x["body_vec"], y["body_vec"]) for x, y in same_box),
                              default=0.0),
             max_score_drift=report["max_score_drift"],
             max_flip_gap=report["max_flip_float_gap"],
             same_queries=[r[0] for r in rows_a] == [r[0] for r in rows_b],
             same_answers=[r[4] for r in rows_a] == [r[4] for r in rows_b],
             max_row_number_diff=numbers)

    def steps(run):
        rs = run["rec"]
        mean = lambda xs: float(np.mean(xs)) * 1e3 if xs else None  # noqa: E731
        return dict(
            photos_per_s=len(rs) / run["chain_s"], chain_s=run["chain_s"],
            decode_ms=mean([r["decode"] for r in rs]),
            preproc3_ms=mean([r["preproc3"] for r in rs]),
            preproc4_ms=mean([r["preproc4"] for r in rs]),
            resize_with_padding_ms=mean([r["resize"] for r in rs if "resize" in r]),
            head_embed_ms=mean([r["head"] - r["preproc3"] for r in rs if r["head_valid"]]),
            body_embed_ms=mean([r["body"] - r["preproc4"] - r["resize"] for r in rs
                                if r["body_valid"]]))

    k = card["launches"]
    emit("body_tsv", card=smi, corpus=str(CORPUS.relative_to(REPO)), steps_card=steps(card),
         steps_cpu=steps(cpu), launches=k, rows=len(rows_a), vs_cpu=d,
         budget=dict(emb_rel=EMB_DRIFT, score=SCORE_DRIFT),
         near_tie=report, seconds=time.perf_counter() - t_phase)
    if not (k["warp_perspective_batch"] == len([r for r in a if r["head_valid"]])
            and k["nms_keep_sorted_batch"] and k["multilevel_roi_align"]):
        raise AssertionError(f"body_tsv launches {k}")
    finite = all(np.isfinite(r[v]).all() for r in a for v in ("vec", "body_vec")
                 if r[v] is not None)
    if not (finite and d["body_kept"] and rows_a and d["same_queries"]
            and d["head_valid_differ"] == 0 and d["body_valid_differ"] == 0
            and d["body_crops_differ"] == 0 and d["head_emb_rel"] <= EMB_DRIFT
            and d["body_emb_rel"] <= EMB_DRIFT and d["max_score_drift"] <= SCORE_DRIFT
            and d["max_flip_gap"] <= SCORE_DRIFT and d["max_row_number_diff"] <= SCORE_DRIFT
            and (d["same_answers"] or report["n_flipped_pairs"])):
        raise AssertionError(f"body_tsv: the card against the CPU: {d}")
    return k


@contextlib.contextmanager
def recorded_preproc4():
    """Each ``Preproc4.batch`` call's results and each mask it pasted (on the
    CPU), while the block runs."""
    import torch
    from pets_face_recognition_tpu_torch import preprocessor
    from pets_face_recognition_tpu_torch.preprocessor import Preproc4

    calls, pastes, batch, paste = [], [], Preproc4.batch, preprocessor.paste_mask

    def recording(self, images):
        out = batch(self, images)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        calls.append(([None if c is None else c.cpu() for c in out[0]], out[1], out[2]))
        return out

    def pasting(*a, **k):
        full = paste(*a, **k)
        pastes.append(full.cpu())
        return full

    Preproc4.batch, preprocessor.paste_mask = recording, pasting
    try:
        yield calls, pastes
    finally:
        Preproc4.batch, preprocessor.paste_mask = batch, paste


def score_tables(tables: dict, out: Path) -> dict:
    """The port's offline scorers over ``prepare_tables``' card and CPU
    tables: an annotation pickle in the Label-Studio schema is written for
    the card tables' photos (320 x 320; alternate photos dog and cat; each
    ground truth a seeded jitter of the card's detection or landmarks, or a
    seeded box where there is none), then ``score_detection`` (``Head`` on
    ``detected_head.tsv``, ``Animal`` on ``detected_body.tsv``) and
    ``score_landmark`` print their lines for each side. Returns both sides'
    lines and whether they are equal."""
    import contextlib as _cl
    import io
    import pickle

    import numpy as np
    from pets_face_recognition_tpu_torch import score_detection, score_landmark

    side = float(IMAGE)
    rng = np.random.RandomState(17)
    card = {p.name: score_detection.read_tsv(p)[1] for p in tables["card"]["paths"]}
    names = sorted({r["query"] for rows in card.values() for r in rows})
    by_name = {f: {r["query"]: r for r in rows} for f, rows in card.items()}
    db = [{}, {}]
    for i, name in enumerate(names):
        entry = {"resolution": (IMAGE, IMAGE)}
        for mode, table in (("Head", "detected_head.tsv"), ("Animal", "detected_body.tsv")):
            row = by_name[table].get(name)
            box = (np.asarray(json.loads(row["detections"])[0], float) + rng.randint(-6, 7, 4)
                   if row else np.sort(rng.uniform(0, side, (2, 2)), 0).T.ravel()[[0, 2, 1, 3]])
            x0, y0, x1, y1 = np.clip(box, 0, side)
            entry[mode] = {"x": x0 / side * 100, "y": y0 / side * 100,
                           "width": max(x1 - x0, 1) / side * 100,
                           "height": max(y1 - y0, 1) / side * 100}
        row = by_name["landmark.tsv"].get(name)
        for k, label in enumerate(("Left eye", "Right eye", "Nose")):
            pt = (np.asarray(json.loads(row[label]), float) + rng.randint(-4, 5, 2) if row
                  else rng.uniform(0, side, 2) + k)
            entry[label] = {"x": float(pt[0]) / side * 100, "y": float(pt[1]) / side * 100}
        db[i % 2][name] = [entry]
    anno = out / "data_25_anno.pickle"
    anno.parent.mkdir(parents=True, exist_ok=True)
    anno.write_bytes(pickle.dumps(db))
    lines = {}
    for label in ("card", "cpu"):
        tables_by_name = {p.name: p for p in tables[label]["paths"]}
        buf = io.StringIO()
        with _cl.redirect_stdout(buf):
            for mode, table in (("Head", "detected_head.tsv"), ("Animal", "detected_body.tsv")):
                score_detection.main(str(tables_by_name[table]), "data_25", mode, str(anno))
            score_landmark.main(str(tables_by_name["landmark.tsv"]), "data_25", str(anno))
        lines[label] = buf.getvalue().splitlines()
    return dict(equal=lines["card"] == lines["cpu"], card=lines["card"], cpu=lines["cpu"],
                photos=len(names))


def masked_transform_phase(dev, kernels_mod, smi: str) -> dict[str, dict]:
    """Phase masked_transform, under the git-ignored ``smoke_out/mask``:
    seeded ``data_25`` and petfinder-extras layouts (``smoke_data``, 320 x
    320) and a Mask R-CNN checkpoint named by ``PFR_MASK_CKPT`` (seeded
    random weights, the mask logits spread by ``MASK_LOGIT_SPREAD``).
    ``transform_dataset --pipeline body --masked --mask-thr 0.7 --thr 0`` on
    the card (launch counts around it) and on the CPU: the same files under
    the same names, the same tightened boxes, the crops before encoding
    within 1e-3 on [0, 1] but at pixels whose pasted mask lies within 1e-4 of
    the threshold on both sides (counted), the card's JPEGs against PIL's
    libjpeg on the CPU's crops (``jpeg_gap``); ``prepare_tables --thr 0`` on
    both: the same rows, landmarks and boxes byte for byte, scores within
    1e-5 (float32 sums differ in the last bits between cuDNN and the CPU);
    ``transform_reproduce``'s masked route on the card over the whole layout.
    Photos/s of each."""
    from unittest import mock

    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch import (prepare_tables, smoke_data, transform_dataset,
                                                 transform_reproduce)
    from pets_face_recognition_tpu_torch.pipelines import mask_detector
    from pets_face_recognition_tpu_torch.preprocessor import Preproc4

    t_phase = time.perf_counter()
    root, tables_root = MASK_OUT / "transform", MASK_OUT / "labeled"
    smoke_data.make_data25(root, n_cards=4, n_imgs=2)
    smoke_data.make_petfinder_extras(root, n_cards=2, n_imgs=1)
    smoke_data.make_data25(tables_root, n_cards=3, n_imgs=1, seed=13)
    smoke_data.make_petfinder_extras(tables_root, n_cards=1, n_imgs=1, seed=14)
    ckpts = MASK_OUT / "mask" / "checkpoints"
    ckpts.mkdir(parents=True)
    model = mask_detector("cpu", 0)
    with torch.no_grad():
        model.roi_heads.mask_predictor.mask_fcn_logits.weight.mul_(MASK_LOGIT_SPREAD)
    torch.save({"model": model.state_dict()}, ckpts / "epoch=0-step=0")
    del model
    photos = sorted((root / "data_25").glob("*/*.jpg"))
    argv = ["--input", str(root / "data_25"), "--pipeline", "body", "--masked", "--mask-thr",
            str(transform_reproduce.MASK_THR), "--thr", "0.0", "--batch-size",
            str(MASK_TRANSFORM_BATCH)]
    paths, runs, tables = {}, {}, {}
    with mock.patch.dict(os.environ, PFR_MASK_CKPT=str(ckpts)):
        os.environ.pop("PFR_KEYPOINT_CKPT", None)
        for label, device in (("card", str(dev)), ("cpu", "cpu")):
            out = MASK_OUT / f"out_{label}"
            with recorded_preproc4() as (calls, pastes):
                if label == "card":
                    torch.cuda.synchronize()
                    kernels_mod.reset_launch_counts()
                t = time.perf_counter()
                written = transform_dataset.main(argv + ["--output", str(out), "--device",
                                                         device])
                if label == "card":
                    torch.cuda.synchronize()
                    paths["masked_transform"] = kernels_mod.launch_counts()
                runs[label] = dict(seconds=time.perf_counter() - t, calls=calls, pastes=pastes,
                                   written=written,
                                   files=sorted(str(p.relative_to(out)) for p in written))
            if label == "card":
                kernels_mod.reset_launch_counts()
            t = time.perf_counter()
            tables[label] = dict(paths=prepare_tables.main(
                ["--data", str(tables_root), "--thr", "0.0", "--out-dir",
                 str(MASK_OUT / f"tables_{label}"), "--device", device]))
            if label == "card":
                torch.cuda.synchronize()
                paths["prepare_tables"] = kernels_mod.launch_counts()
            tables[label]["seconds"] = time.perf_counter() - t
        pre4 = Preproc4(mask_detector(dev), thr=0.0, use_mask=True,
                        mask_thr=transform_reproduce.MASK_THR,
                        serve_batch=MASK_TRANSFORM_BATCH, device=dev)
    n_inputs = len([p for d in ("data_25", "petfinder_extra_dogs", "petfinder_extra_cats")
                    for p in (root / d).glob("*/*.*") if p.suffix in (".jpg", ".png")])
    kernels_mod.reset_launch_counts()
    t = time.perf_counter()
    reproduced = transform_reproduce.masked(pre4, root)
    torch.cuda.synchronize()
    reproduce_s = time.perf_counter() - t
    paths["masked_reproduce"] = kernels_mod.launch_counts()

    # the card's crops against the CPU's: equal boxes, and pixels apart only
    # where both pasted masks lie within the band around the threshold
    card, cpu = runs["card"], runs["cpu"]
    thr, band = transform_reproduce.MASK_THR, MASK_GATES["threshold_band"]
    valid_equal = len(card["calls"]) == len(cpu["calls"])
    boxes_differ = crop_err = 0
    near, crops, pastes = 0, [], iter(zip(card["pastes"], cpu["pastes"]))
    for (c_gpu, v_gpu, r_gpu), (c_cpu, v_cpu, r_cpu) in zip(card["calls"], cpu["calls"]):
        valid_equal &= bool((v_gpu == v_cpu).all())
        for i in range(len(v_cpu)):
            # each detection that reached the paste pasted once on each side
            if not (r_gpu["all_scores"][i, 0] > 0.0 and r_cpu["all_scores"][i, 0] > 0.0):
                continue
            p_gpu, p_cpu = next(pastes)
            if not (v_gpu[i] and v_cpu[i]):
                continue
            if not np.array_equal(r_gpu["boxes"][i], r_cpu["boxes"][i]):
                boxes_differ += 1
                continue
            x1, y1 = (max(int(v), 0) for v in r_cpu["boxes"][i][:2])
            band_px = ((p_gpu - thr).abs() <= band) & ((p_cpu - thr).abs() <= band)
            band_px = band_px[y1:y1 + c_cpu[i].shape[0], x1:x1 + c_cpu[i].shape[1]]
            diff = (c_gpu[i] - c_cpu[i]).abs().amax(-1)
            near += int(((diff > 0) & band_px).sum())
            if diff.numel():
                crop_err = max(crop_err, float(torch.where(band_px, 0.0, diff).max()) / 255.0)
            crops.append(np.clip(c_cpu[i].numpy(), 0, 255).astype(np.uint8))
    same_files = card["files"] == cpu["files"] and len(card["files"]) == len(crops) > 0
    jpeg = jpeg_gap([p.read_bytes() for p in card["written"]], crops) if same_files else None

    def read(path):
        with open(path, newline="") as f:
            return [line.split("\t") for line in f.read().splitlines()]

    table_diff = {}
    for p_gpu, p_cpu in zip(tables["card"]["paths"], tables["cpu"]["paths"]):
        a, b = read(p_gpu), read(p_cpu)
        exact = [(x[:2] if p_gpu.name != "landmark.tsv" else x) for x in a] == \
            [(y[:2] if p_cpu.name != "landmark.tsv" else y) for y in b]
        scores = max((abs(s - q) for x, y in zip(a[1:], b[1:]) if p_gpu.name != "landmark.tsv"
                      for s, q in zip(json.loads(x[2]), json.loads(y[2]))), default=0.0)
        table_diff[p_gpu.name] = dict(rows=len(a) - 1, equal_but_scores=exact,
                                      bytes_equal=p_gpu.read_bytes() == p_cpu.read_bytes(),
                                      max_score_diff=scores)
    scorers = score_tables(tables, MASK_OUT / "scorers")
    reproduced_rel = sorted(str(p.relative_to(root)) for p in reproduced)
    k, kt, kr = paths["masked_transform"], paths["prepare_tables"], paths["masked_reproduce"]
    emit("masked_transform", card=smi, photos=len(photos), batch=MASK_TRANSFORM_BATCH,
         mask_thr=thr, logit_spread=MASK_LOGIT_SPREAD, files=len(card["files"]),
         seconds_card=card["seconds"], seconds_cpu=cpu["seconds"],
         photos_per_s_card=len(photos) / card["seconds"],
         photos_per_s_cpu=len(photos) / cpu["seconds"], crop_abs_err_01=crop_err,
         threshold_band_pixels_apart=near, boxes_differ=boxes_differ, valid_equal=valid_equal,
         same_files=same_files, jpeg=jpeg, launches=k,
         tables=dict(diff=table_diff, launches=kt, seconds_card=tables["card"]["seconds"],
                     seconds_cpu=tables["cpu"]["seconds"]),
         scorers=scorers,
         reproduce=dict(seconds=reproduce_s, files=len(reproduced), launches=kr,
                        photos=n_inputs, photos_per_s=n_inputs / reproduce_s,
                        outputs=sorted({p.split("/")[0] for p in reproduced_rel})),
         gates=dict(crop_abs_01=MASK_GATES["crop_abs_01"], jpeg_gap=JPEG_GAP,
                    table_score_abs=MASK_GATES["table_score_abs"], threshold_band=band),
         seconds=time.perf_counter() - t_phase)
    for name, counts in (("masked_transform", k), ("prepare_tables", kt),
                         ("masked_reproduce", kr)):
        if not (counts["nms_keep_sorted_batch"] and counts["multilevel_roi_align"]):
            raise AssertionError(f"{name} launches {counts}")
    if not (valid_equal and same_files and boxes_differ == 0):
        raise AssertionError(f"masked_transform: the card and the CPU kept other crops "
                             f"({boxes_differ} boxes apart)")
    if not crop_err <= MASK_GATES["crop_abs_01"]:
        raise AssertionError(f"masked_transform: crops {crop_err} apart")
    if not (jpeg["tables_equal"] and jpeg["files"]["max"] <= JPEG_GAP["max"]
            and jpeg["files"]["mean"] <= JPEG_GAP["mean"]):
        raise AssertionError(f"masked_transform: the card's JPEGs against libjpeg: {jpeg}")
    if not all(d["rows"] and d["equal_but_scores"]
               and d["max_score_diff"] <= MASK_GATES["table_score_abs"]
               for d in table_diff.values()):
        raise AssertionError(f"prepare_tables: the card against the CPU: {table_diff}")
    if not (scorers["equal"] and scorers["card"]):
        raise AssertionError(f"scorers: the card's lines against the CPU's: {scorers}")
    outputs = {p.split("/")[0] for p in reproduced_rel}
    if len(reproduced_rel) < 4 or not outputs <= {f"{d}_transformed_v4_masked_{s}"
                                                   for d, s in (("data_25", "dogs"),
                                                                ("data_25", "cats"))} | {
            f"petfinder_extra_{s}_transformed_v4_masked" for s in ("dogs", "cats")}:
        raise AssertionError(f"transform_reproduce --stages masked wrote {reproduced_rel}")
    return paths


def mask_phases(dev, kernels_mod, smi: str) -> tuple[dict, dict]:
    """mask_serve, body_tsv and masked_transform; everything written under
    the git-ignored ``smoke_out/mask`` is deleted after them."""
    import shutil

    shutil.rmtree(MASK_OUT, ignore_errors=True)
    try:
        paths, rows = mask_serve_phase(dev, kernels_mod, smi)
        paths["body_tsv"] = body_tsv_phase(dev, kernels_mod, smi)
        paths.update(masked_transform_phase(dev, kernels_mod, smi))
    finally:
        shutil.rmtree(MASK_OUT, ignore_errors=True)
    return paths, rows


MASK_TRAIN_OUT = REPO / "smoke_out" / "mask_train"   # git-ignored; deleted after the phases
B_MASK = 8                                          # mask config: train_batch_size
MASK_BOXES = 4                                      # mask config: max_boxes
MASK_STEPS = 6                                      # one warm-up and five timed
# each step: K2 once (the RPN), K3, K4 and its pre-pass once at each RoI size
MASK_STEP_SITES = {"nms_keep_sorted_batch": 1, "multilevel_roi_align 7x7": 1,
                   "multilevel_roi_align 14x14": 1, "multilevel_roi_align_backward 7x7": 1,
                   "multilevel_roi_align_backward 14x14": 1, "roi_footprints 7x7": 1,
                   "roi_footprints 14x14": 1}
MASK_FIT_GATES = dict(metric=1e-3, mask_abs=1e-4, threshold_band=1e-4, score_abs=1e-3,
                      box_rel_to_side=1e-3, paste_abs=1e-6)
# the background class's rows: the mask loss reads the target class's logits
# and the box loss the target class's deltas, and every positive is class 1,
# so these gradients are 0 exactly
MASK_ZERO_ROWS = (("roi_heads.mask_predictor.mask_fcn_logits.weight", slice(0, 1)),
                  ("roi_heads.mask_predictor.mask_fcn_logits.bias", slice(0, 1)),
                  ("roi_heads.box_predictor.bbox_pred.weight", slice(0, 4)),
                  ("roi_heads.box_predictor.bbox_pred.bias", slice(0, 4)))


def oxford_miniature() -> Path:
    """The port's Oxford-IIIT Pet miniature under ``MASK_TRAIN_OUT``."""
    from pets_face_recognition_tpu_torch.smoke_data import make_oxford

    root = MASK_TRAIN_OUT / "oxford"
    if not (root / "oxford-iiit-pet").exists():
        make_oxford(root)
    return root


def mask_batch(B: int, image: int) -> dict:
    """The first batch of the mask config's training loader over the
    miniature: B photos and their trimap masks letterboxed to image x image."""
    from pets_face_recognition_tpu_torch.config_presets import build_mask_config

    cfg = build_mask_config(data_root=str(oxford_miniature()), train_batch_size=B,
                            image_size=(image, image), max_boxes=MASK_BOXES, num_workers=8,
                            output=str(MASK_TRAIN_OUT / "out"))
    batch = next(iter(cfg["train_dataloader"]()))
    m = batch["masks"]
    if m.shape != (B, MASK_BOXES, image, image) or not batch["valid"][:, 0].all() or not (
            m[:, 0].reshape(B, -1).max(axis=1) == 1.0).all() or m.min() < 0 or m.max() > 1:
        raise AssertionError(f"mask batch: {m.shape}, valid {batch['valid'].tolist()}")
    return batch


@contextlib.contextmanager
def mask_train_sites(kernels_mod):
    """K3's, K4's and the pre-pass's launches by output size while the block
    runs, and a copy of the arguments of the first 14 x 14 K4 launch (the
    mask branch's). Yields ``(sites, k4_args)``."""
    import collections

    import torch
    from pets_face_recognition_tpu_torch.ops import roi_align

    sites, k4_args = collections.Counter(), []
    wrapped = (("multilevel_roi_align_cuda", "multilevel_roi_align", 3),
               ("multilevel_roi_align_backward_cuda", "multilevel_roi_align_backward", 4),
               ("roi_footprints_cuda", "roi_footprints", 3))
    saved = {fn: getattr(roi_align, fn) for fn, _, _ in wrapped}

    def site(fn_name, kernel, pos):
        orig = saved[fn_name]

        def call(*args, **kw):
            size = tuple(args[pos] if len(args) > pos else kw["output_size"])
            before = kernels_mod.launch_counts()[kernel]
            out = orig(*args, **kw)
            sites[f"{kernel} {size[0]}x{size[1]}"] += kernels_mod.launch_counts()[kernel] - before
            if (kernel == "multilevel_roi_align_backward" and size == (14, 14) and not k4_args
                    and args[0].is_cuda):
                k4_args.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return out
        return call

    for fn_name, kernel, pos in wrapped:
        setattr(roi_align, fn_name, site(fn_name, kernel, pos))
    try:
        yield sites, k4_args
    finally:
        for fn_name, fn in saved.items():
            setattr(roi_align, fn_name, fn)


def mask_train_phase(dev, kernels_mod, smi: str) -> tuple[dict, tuple]:
    """Phase mask_train: full-width training steps of the mask config's model
    on one batch of the miniature at B = 8 x 640 x 640. Returns the path's
    launch counts and the arguments of the mask branch's K4 launch."""
    import torch
    from pets_face_recognition_tpu_torch.engine.detector_controller import DetectionController

    batch = mask_batch(B_MASK, IMAGE_TRAIN)
    ctl = DetectionController()
    state = ctl.init_state(seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launch_counts()
    steps = []
    with mask_train_sites(kernels_mod) as (sites, k4_args), tf32_watch(state.model) as flags:
        for _ in range(MASK_STEPS):
            t = time.perf_counter()
            metrics = ctl.train_step(state, batch)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t, metrics))
    launches = kernels_mod.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timed = [t * 1e3 for t, _ in steps[1:]]
    by_site = dict(sites, nms_keep_sorted_batch=launches["nms_keep_sorted_batch"])
    first_mask = steps[0][1]["loss_mask"]
    F32_STEPS["mask_train"] = (statistics.median(timed), peak)
    emit("mask_train", card=smi, batch=B_MASK, image=IMAGE_TRAIN, max_boxes=MASK_BOXES,
         masks_shape=list(batch["masks"].shape), steps=len(steps), warmup_steps=1,
         step_ms=statistics.median(timed), step_ms_min=min(timed), step_ms_max=max(timed),
         step_ms_all=[t * 1e3 for t, _ in steps], images_per_s=B_MASK * 1e3 / statistics.median(timed),
         peak_mem_gib=peak, losses=[m for _, m in steps], launches=launches,
         launches_by_site=by_site, first_loss_mask=first_mask, ln2=math.log(2),
         precision="float32: TF32 off inside train_step", tf32_flags=flags)
    bad = [i for i, (_, m) in enumerate(steps) if not all(math.isfinite(v) for v in m.values())]
    if bad:
        raise AssertionError(f"non-finite losses at steps {bad}")
    if not abs(first_mask - math.log(2)) <= 0.2:
        raise AssertionError(f"first loss_mask {first_mask} is not within 0.2 of ln 2")
    want = {k: n * len(steps) for k, n in MASK_STEP_SITES.items()}
    if {k: by_site.get(k, 0) for k in want} != want or sum(by_site.values()) != sum(
            want.values()):
        raise AssertionError(f"launches by call site {by_site}, expected {want}")
    repro_phase(ctl, state, batch, B_MASK, MASK_BOXES, "mask_train_repro")
    del state
    torch.cuda.empty_cache()
    return launches, k4_args[0]


def masktrain_k4_row(dev, args: tuple) -> dict:
    """K4 on the mask branch's own backward: its dense 14 x 14 gradient of
    B x 128 positives onto the 4 levels of the B x 640 x 640 pyramid, against
    its plain version on the same inputs, two launches compared bitwise,
    timed beside its bound."""
    import torch
    from pets_face_recognition_tpu_torch.kernel_ab import cuda_ms
    from pets_face_recognition_tpu_torch.ops import roi_align

    grad, shapes, rois, bidx = args[:4]
    out = tuple(args[4])
    got = roi_align.multilevel_roi_align_backward_cuda(*args)
    again = roi_align.multilevel_roi_align_backward_cuda(*args)
    want = roi_align.multilevel_roi_align_backward(*args)
    torch.cuda.synchronize()
    err = max(max_err(a, w) for a, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    bit_diff = sum(int((a != r).sum()) for a, r in zip(got, again))
    del got, again, want
    # float32 sums of a few hundred contributions in another order than the
    # plain version's: 1e-4 of the largest gradient element
    tol = 1e-4 * scale
    ms = cuda_ms(lambda: roi_align.multilevel_roi_align_backward_cuda(*args), iters=10)
    plain = cuda_ms(lambda: roi_align.multilevel_roi_align_backward(*args), warmup=1, iters=3)
    us = kernel_us(lambda: roi_align.multilevel_roi_align_backward_cuda(*args),
                   "multilevel_roi_align_backward_kernel", iters=5)
    n, C = rois.shape[0], grad.shape[-1]
    level_bytes = sum(math.prod(sh) for sh in shapes) * 4
    n_bytes = grad.numel() * 4 + rois.numel() * 4 + bidx.numel() * 4 + level_bytes
    n_flops = n * out[0] * out[1] * C * (8 * 4 + 1)
    b, by = bound_ms(n_bytes, n_flops)
    nonzero = int((grad.reshape(n, -1).abs().amax(dim=1) > 0).sum())
    emit("kernel", name="K4 multilevel_roi_align_backward 14x14 mask train", rois=n,
         rois_with_gradient=nonzero, levels=[list(sh) for sh in shapes], max_abs_err=err,
         atol=tol, grad_max_abs=scale, second_launch_bits_differ=bit_diff, ms=ms,
         kernel_device_us=us, plain_ms=plain, library_ms=None,
         library="none (no torchvision)", bound_ms=b, bound_by=by)
    if not err <= tol:
        raise AssertionError(f"K4 on the mask branch disagrees with its plain version: "
                             f"{err} > {tol}")
    if bit_diff:
        raise AssertionError(f"K4 on the mask branch: two launches differ in {bit_diff}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None)


def mask_train_vs_cpu_phase(dev) -> None:
    """Phase mask_train_vs_cpu: one reduced Mask R-CNN step (B = 2 photos of
    the miniature at 256 x 256, budgets 256/128/16) on the card and on the
    CPU, same weights and sampler noise: each loss term within 1e-3
    relative; the mask head's gradients within 5e-3 relative in norm; the
    background rows' gradients, 0 by construction, within 1e-5; every other
    gradient within 5e-3 at the median tensor, and at the worst within 5e-3
    more than the card's own step moves when its input images are rounded
    differently (1e-7 relative, the largest of three draws): the photos'
    flat blobs give the trunk whole regions of equal pre-activations, and
    one that sits within rounding of 0 flips its ReLU over the region, in
    float32 on either device (one draw flips the same one as the CPU and
    moves ``layer2.3.conv1.weight`` by 9.70e-3, as card against CPU)."""
    import copy

    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch.engine.detector_controller import DetectionController
    from pets_face_recognition_tpu_torch.models.rcnn import maskrcnn_resnet50_fpn
    from pets_face_recognition_tpu_torch.weights import init_random_

    B, image = 2, 256
    budgets = dict(rpn_pre_nms_top_n_train=256, rpn_post_nms_top_n_train=128,
                   box_batch_size_per_image=16)
    cpu_model = init_random_(maskrcnn_resnet50_fpn(**budgets), 1)
    batch = mask_batch(B, image)
    n_anchors = 3 * sum((image // st) ** 2 for st in (4, 8, 16, 32, 64))
    noise = cpu_model.draw_sampler_noise(B, n_anchors, MASK_BOXES,
                                         torch.Generator().manual_seed(1))
    runs = [("gpu", copy.deepcopy(cpu_model), dev, batch)]
    for s in (1, 2, 3):
        jitter = 1 + np.random.RandomState(s).randn(*batch["images"].shape) * 1e-7
        runs.append((f"gpu_rounded_{s}", copy.deepcopy(cpu_model), dev,
                     dict(batch, images=(batch["images"] * jitter).astype(np.float32))))
    runs.append(("cpu", cpu_model, "cpu", batch))
    ctl = DetectionController()
    out = {}
    for name, model, device, b in runs:
        state = ctl.init_state(0, device, model=model)
        t = time.perf_counter()
        losses = ctl.train_step(state, b, sampler_noise=noise)
        if device != "cpu":
            torch.cuda.synchronize()
        out[name] = (losses, {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                     time.perf_counter() - t)
    (l_gpu, g_gpu, t_gpu), (l_cpu, g_cpu, t_cpu) = out["gpu"], out["cpu"]

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))

    loss_rel = {k: abs(l_gpu[k] - l_cpu[k]) / abs(l_cpu[k]) for k in l_cpu}
    zero_abs = max(max(float(g_gpu[n][rows].abs().max()), float(g_cpu[n][rows].abs().max()))
                   for n, rows in MASK_ZERO_ROWS)
    grad_rel = {n: rel(g_gpu[n], g_cpu[n]) for n in g_cpu}
    head = {n: v for n, v in grad_rel.items() if ".mask_" in n}
    names = [n for n in g_cpu if n not in head]
    spreads = [[rel(out[f"gpu_rounded_{s}"][1][n], g_gpu[n]) for n in names] for s in (1, 2, 3)]
    # a ReLU flipped at the last bit moves some tensors by what the card's
    # own rounding moves them; the rest of the comparison is held at 5e-3
    # (a wrong gradient is off by far more)
    worst_bound = 5e-3 + max(max(x) for x in spreads)
    median_bound = 5e-3
    worst = max(names, key=grad_rel.get)
    grad_median = statistics.median(grad_rel[n] for n in names)
    head_worst = max(head, key=head.get)
    emit("mask_train_vs_cpu", batch=B, image=image, budgets=budgets, losses_gpu=l_gpu,
         losses_cpu=l_cpu, loss_rel_err=loss_rel, grad_rel_err_max=grad_rel[worst],
         grad_rel_err_worst=worst, grad_rel_err_median=grad_median,
         grad_rel_err_mask_head=head, card_rounding_spread={
             "worst": [max(x) for x in spreads], "worst_tensor": [
                 names[int(np.argmax(x))] for x in spreads],
             "median": [statistics.median(x) for x in spreads]},
         grad_bounds={"worst": worst_bound, "median": median_bound, "mask_head": 5e-3},
         zero_by_construction_abs=zero_abs,
         zero_by_construction=[f"{n}[{r.start}:{r.stop}]" for n, r in MASK_ZERO_ROWS],
         grad_tensors=len(grad_rel), step_s_gpu=t_gpu, step_s_cpu=t_cpu,
         tolerances=dict(loss_rel=1e-3, grad_rel_norm=5e-3, zero_by_construction_abs=1e-5))
    if sorted(l_cpu) != sorted(l_gpu) or "loss_mask" not in l_cpu:
        raise AssertionError(f"loss terms: {sorted(l_gpu)} against {sorted(l_cpu)}")
    bad = {k: v for k, v in loss_rel.items() if not v <= 1e-3}
    if bad:
        raise AssertionError(f"losses differ from the CPU step: {bad}")
    if not head[head_worst] <= 5e-3:
        raise AssertionError(f"mask head gradient {head_worst} differs from the CPU step: "
                             f"{head[head_worst]}")
    if not (grad_rel[worst] <= worst_bound and grad_median <= median_bound):
        raise AssertionError(f"gradient {worst} differs from the CPU step: {grad_rel[worst]} "
                             f"(median {grad_median}); bounds {worst_bound}, {median_bound}")
    if not zero_abs <= 1e-5:
        raise AssertionError(f"zero-by-construction gradient is {zero_abs}")


@contextlib.contextmanager
def raw_masks():
    """The eval step's 28 x 28 mask probabilities and boxes, batch by batch
    on the host, as the block's eval steps paste them. Yields the list of
    ``(masks, boxes, image_size)``."""
    from pets_face_recognition_tpu_torch.engine import detector_controller

    seen, paste = [], detector_controller.paste_masks

    def record(masks, boxes, image_size):
        seen.append((masks.detach().cpu(), boxes.detach().cpu(), image_size))
        return paste(masks, boxes, image_size)

    detector_controller.paste_masks = record
    try:
        yield seen
    finally:
        detector_controller.paste_masks = paste


@contextlib.contextmanager
def smoke_env(root: Path, cwd: Path):
    """``PFR_SMOKE_ROOT`` set to ``root`` and ``cwd`` the working directory
    while the block runs (the smoke config reads both)."""
    saved = (os.environ.get("PFR_SMOKE_ROOT"), os.getcwd())
    os.environ["PFR_SMOKE_ROOT"] = str(root)
    os.chdir(cwd)
    try:
        yield
    finally:
        os.chdir(saved[1])
        if saved[0] is None:
            os.environ.pop("PFR_SMOKE_ROOT", None)
        else:
            os.environ["PFR_SMOKE_ROOT"] = saved[0]


def masks_apart(out_a, out_b, raw_a, raw_b, metrics_a, metrics_b, side: int,
                end_to_end: bool = True, keep=None) -> dict:
    """Two devices' Mask R-CNN eval batches apart (``a`` the card) over the
    images that ``keep`` (one boolean list a batch) holds, by default all:
    validity, scores, boxes as a share of ``side``, the 28 x 28 mask
    probabilities and the pasted masks (pixels cut differently at 0.5
    counted inside and outside the threshold band), and ``a``'s paste
    against the CPU's on ``a``'s own masks and boxes; the pasted masks as
    each device pasted them (``end_to_end``), or with ``b``'s masks pasted
    into ``a``'s boxes. Gated in ``failed``; each metric's difference, gated
    apart in ``metrics_failed``."""
    import numpy as np
    from pets_face_recognition_tpu_torch.ops.masks import paste_masks

    band = MASK_FIT_GATES["threshold_band"]
    r = dict(images=0, valid_equal=True, detections=0, score_abs=0.0, box_rel_to_side=0.0,
             mask_abs=0.0, mask_abs_end_to_end=0.0, raw_mask_abs=0.0, paste_abs=0.0,
             pasted_mask_max=0.0, threshold_band_pixels_apart=0, pixels_apart_outside_band=0,
             masks_pasted_into="each device's own boxes" if end_to_end else "the card's boxes")
    for i, (ba, bb, ra, rb) in enumerate(zip(out_a, out_b, raw_a, raw_b)):
        pa, pb = ba["pred"], bb["pred"]
        k = np.ones(len(pa["valid"]), bool) if keep is None else np.asarray(keep[i])
        r["images"] += int(k.sum())
        r["valid_equal"] &= bool((pa["valid"] == pb["valid"])[k].all())
        v = pa["valid"] & pb["valid"] & k[:, None]
        r["detections"] += int(v.sum())
        r["score_abs"] = max(r["score_abs"],
                             float(np.abs(pa["scores"] - pb["scores"])[v].max(initial=0)))
        r["box_rel_to_side"] = max(r["box_rel_to_side"], float(
            np.abs(pa["boxes"] - pb["boxes"])[v].max(initial=0)) / side)
        r["raw_mask_abs"] = max(r["raw_mask_abs"],
                                float((ra[0] - rb[0]).abs().numpy()[v].max(initial=0)))
        # the device paste alone: the CPU's paste of the card's inputs
        r["paste_abs"] = max(r["paste_abs"], float(np.abs(
            paste_masks(*ra).numpy() - pa["masks"]).max(initial=0)))
        ma, mb = pa["masks"][v], pb["masks"][v]
        r["mask_abs_end_to_end"] = max(r["mask_abs_end_to_end"],
                                       float(np.abs(ma - mb).max(initial=0)))
        if not end_to_end:
            mb = paste_masks(rb[0], ra[1], ra[2]).numpy()[v]
        r["mask_abs"] = max(r["mask_abs"], float(np.abs(ma - mb).max(initial=0)))
        r["pasted_mask_max"] = max(r["pasted_mask_max"], float(ma.max(initial=0)))
        flip = (ma >= 0.5) != (mb >= 0.5)
        inside = (np.abs(ma - 0.5) <= band) & (np.abs(mb - 0.5) <= band)
        r["threshold_band_pixels_apart"] += int((flip & inside).sum())
        r["pixels_apart_outside_band"] += int((flip & ~inside).sum())
    r["metric_abs_diff"] = {m: abs(v - metrics_b[m]) for m, v in metrics_a.items()}
    bad = [n for n in ("score_abs", "box_rel_to_side", "mask_abs") if not r[n] <= MASK_FIT_GATES[n]]
    bad += ["raw_mask_abs"] * (not r["raw_mask_abs"] <= MASK_FIT_GATES["mask_abs"])
    bad += ["paste_abs"] * (not r["paste_abs"] <= MASK_FIT_GATES["paste_abs"])
    bad += ["pixels_apart_outside_band"] * bool(r["pixels_apart_outside_band"])
    bad += ["valid_equal"] * (not r["valid_equal"])
    r["metrics_failed"] = [m for m, d in r["metric_abs_diff"].items()
                           if not (d <= MASK_FIT_GATES["metric"] or (math.isnan(metrics_a[m])
                                                                     and math.isnan(metrics_b[m])))]
    r["metrics_failed"] += ["metric names"] * (list(metrics_a) != list(metrics_b))
    return dict(r, failed=bad)


def eval_card_vs_cpu(config, ckpt: Path, dev, end_to_end: bool = True) -> dict:
    """A Mask R-CNN checkpoint's validation detections on the card against
    the CPU's (:func:`masks_apart`, the pasted masks as ``end_to_end``
    says: on a box a fraction of a pixel high, its coordinates' float32
    rounding, within the box gate, moves the paste's sample rows by a good
    part of a mask cell), end to end and with the CPU held to the card's
    discrete decisions (:func:`recorded_decisions`): a smoke epoch leaves
    the classifier's scores piled about the 0.05 threshold, where a score
    within rounding of it is kept on one device and not on the other.

    Held with the CPU forced to the card's decisions (always): the RPN's
    outputs within ``FIT_GATES["rpn_rel"]``; the CPU's ``generate_proposals``
    on the card's RPN outputs keeps the card's proposals, and its
    post-process on the card's candidates picks the card's (so K2 and the
    top-k took the card's decisions from the card's numbers); every filled
    slot is a candidate; the CPU's forward with the card's proposals, and the
    card's picks where its own are near-ties, gives the card's detections,
    masks and metrics within ``MASK_FIT_GATES``.

    End to end, each device on its own: the images whose proposals (as
    sets) and picks did not move must agree within ``MASK_FIT_GATES``, and
    the metrics too when no image moved. The moves are counted and
    reported."""
    import torch
    from pets_face_recognition_tpu_torch.engine.detector_controller import DetectionController
    from pets_face_recognition_tpu_torch.models.rpn import generate_proposals

    side = max(config.image_size)
    with raw_masks() as raw_card, recorded_decisions() as rec_card:
        t = time.perf_counter()
        ctl_card, out_card = predictions(config, ckpt, dev, DetectionController)
        t_card = time.perf_counter() - t
    with raw_masks() as raw_cpu, recorded_decisions() as rec_cpu:
        t = time.perf_counter()
        ctl_cpu, out_cpu = predictions(config, ckpt, "cpu", DetectionController)
        t_cpu = time.perf_counter() - t
    with raw_masks() as raw_forced, recorded_decisions(rec_card) as rec_forced:
        ctl_forced, out_forced = predictions(config, ckpt, "cpu", DetectionController)
    m_card, m_cpu, m_forced = (c.evaluate([o])["val"] for c, o in (
        (ctl_card, out_card), (ctl_cpu, out_cpu), (ctl_forced, out_forced)))

    moved = [[p or k for p, k in zip(proposals_apart(c, f, side, as_sets=True), f["pick_moved"])]
             for c, f in zip(rec_card, rec_forced)]
    forced = masks_apart(out_card, out_forced, raw_card, raw_forced, m_card, m_forced, side,
                         end_to_end)
    e2e = masks_apart(out_card, out_cpu, raw_card, raw_cpu, m_card, m_cpu, side, end_to_end,
                      keep=[[not m for m in b] for b in moved])
    replayed = []
    with torch.no_grad():
        for rec in rec_card:
            props, valid = generate_proposals(rec["objectness"], rec["deltas"], rec["anchors"],
                                              *rec["args"])
            replayed += proposals_apart(rec, dict(proposals=props, valid=valid), side)
    r = dict(forced=forced, end_to_end=e2e, detections=forced["detections"],
             rpn_rel=rpn_apart(rec_card, rec_cpu), replay_differs=sum(replayed),
             pick_replay_differs=sum(rec["pick_replay_differs"] for rec in rec_forced),
             unmatched_slots=sum(rec["unmatched"] for rec in rec_card + rec_cpu + rec_forced),
             moved_images=sum(map(sum, moved)),
             proposal_moves=sum(sum(proposals_apart(c, f, side, as_sets=True))
                                for c, f in zip(rec_card, rec_forced)),
             pick_moves=sum(sum(rec["pick_moved"]) for rec in rec_forced),
             pick_gaps=[g for rec in rec_forced for g in rec["pick_gaps"]],
             test_card={"val": m_card}, test_cpu={"val": m_cpu},
             test_cpu_forced={"val": m_forced}, predict_s_card=t_card, predict_s_cpu=t_cpu)
    bad = [f"forced {n}" for n in forced["failed"] + forced["metrics_failed"]]
    bad += ["rpn_rel"] * (not r["rpn_rel"] <= FIT_GATES["rpn_rel"])
    bad += [n for n in ("replay_differs", "pick_replay_differs", "unmatched_slots") if r[n]]
    bad += [f"end to end {n}" for n in e2e["failed"]]
    if not r["moved_images"]:
        bad += [f"end to end {n}" for n in e2e["metrics_failed"]]
    return dict(r, failed=bad)


def mask_fit_phase(dev, kernels_mod, smi: str) -> dict[str, dict]:
    """Phase mask_fit: ``main_detection`` on the mask smoke config in a
    subprocess on the card, a restore of its checkpoint, and
    ``eval_detection`` on it on the card (the path ``mask_eval``) and on the
    CPU. One smoke epoch may teach random weights to find nothing (no
    detection above the 0.05 score); the same comparison then also runs on
    the fit's initial weights (the config's seed), where it must see
    detections, with the masks compared in the card's boxes (random boxes
    are slivers; see ``eval_card_vs_cpu``). Returns the eval's launch
    counts."""
    import torch
    from pets_face_recognition_tpu_torch import eval_detection
    from pets_face_recognition_tpu_torch.engine.checkpoint import (load_checkpoint,
                                                                   restore_checkpoint)
    from pets_face_recognition_tpu_torch.engine.detector_controller import DetectionController
    from pets_face_recognition_tpu_torch.utils import get_config

    work = MASK_TRAIN_OUT / "fit"
    work.mkdir(parents=True)
    smoke_cfg = REPO / "pets_face_recognition_tpu_torch" / "configs" / "mask_smoke.py"
    data = work / "oxford"
    env = dict(os.environ, PFR_SMOKE_ROOT=str(data), PFR_SMOKE_EPOCHS="1",
               PYTHONPATH=os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH"))
                                          if p))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pets_face_recognition_tpu_torch.main_detection",
                           "--config", str(smoke_cfg)], cwd=work, env=env,
                          capture_output=True, text=True, timeout=300)
    main_s = time.perf_counter() - t
    made = sorted(work.glob("results_smoke/*/checkpoints/*"))
    if proc.returncode != 0 or "Completed!" not in proc.stdout or [
            p.name for p in made] != ["epoch=0-step=8"]:
        raise AssertionError(f"main_detection failed ({proc.returncode}, {made}): "
                             f"{proc.stderr[-2000:]}")
    ckpt = made[0]
    recs = [json.loads(line) for line in (ckpt.parent.parent / "metrics.jsonl")
            .read_text().splitlines()]
    with smoke_env(data, work):
        config = get_config(smoke_cfg)
        # the restore against the file, tensor by tensor
        fresh = DetectionController(config=config).init_state(0, dev)
        epoch = restore_checkpoint(fresh, ckpt)
        payload = load_checkpoint(ckpt)
        got = state_snapshot(fresh)
        differ = [k for k, v in got["model"].items() if not torch.equal(v, payload["model"][k])]
        moms = [payload["optimizer"]["state"][i]["momentum_buffer"]
                for i in range(len(got["momentum"]))]
        differ += [f"momentum {i}" for i, (a, b) in enumerate(zip(got["momentum"], moms))
                   if not torch.equal(a, b)]
        if differ or got["step"] != 8 or epoch != 0 or len(got["model"]) != len(payload["model"]):
            raise AssertionError(f"restore of {ckpt.name}: step {got['step']}, epoch {epoch}, "
                                 f"tensors {differ[:5]}")
        del fresh, got, payload
        torch.cuda.empty_cache()

        kernels_mod.reset_launch_counts()
        t = time.perf_counter()
        metrics_card = eval_detection.evaluate(smoke_cfg, ckpt, device=dev)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
        launches = kernels_mod.launch_counts()
        trained = eval_card_vs_cpu(config, ckpt, dev)
        # the fit's initial weights, as the trainer draws them
        init = DetectionController(config=config).init_state(int(config.seed), "cpu").model
        torch.save({"model": init.state_dict()}, work / "initial")
        del init
        initial = eval_card_vs_cpu(config, work / "initial", dev, end_to_end=False)
    if not (launches["nms_keep_sorted_batch"] and launches["multilevel_roi_align"]) or (
            launches["multilevel_roi_align_backward"] or launches["roi_footprints"]):
        raise AssertionError(f"eval launches: {launches}")
    # eval_detection's own numbers against the card's detections here, and
    # so against the CPU's (forced, and end to end where nothing moved)
    trained["failed"] += [f"eval_detection {m}" for m, v in metrics_card["val"].items()
                          if not (abs(v - trained["test_card"]["val"][m]) <= MASK_FIT_GATES["metric"]
                                  or (math.isnan(v)
                                      and math.isnan(trained["test_card"]["val"][m])))]
    trained["failed"] += ["eval_detection metric names"] * (
        list(metrics_card["val"]) != list(trained["test_card"]["val"]))
    emit("mask_fit", card=smi, config=str(smoke_cfg.relative_to(REPO)), main_detection_s=main_s,
         checkpoints=[p.name for p in made], train_records=[r for r in recs if "epoch_time_s" in r],
         validation=[{k: v for k, v in r.items() if k != "time"} for r in recs
                     if any(k.startswith("val ") for k in r)],
         eval_detection_s=eval_s, eval_detection=metrics_card, checkpoint_card_vs_cpu=trained,
         initial_weights_card_vs_cpu=initial,
         launches_eval=launches, gates=MASK_FIT_GATES, stdout_tail=proc.stdout[-600:])
    if trained["failed"] or initial["failed"] or not initial["detections"]:
        raise AssertionError(f"eval_detection on the card differs from the CPU: checkpoint "
                             f"{trained['failed']}, initial weights {initial['failed']} "
                             f"({initial['detections']} detections); images moved "
                             f"{trained['moved_images']}, {initial['moved_images']}")
    return {"mask_eval": launches}


def mask_train_phases(dev, kernels_mod, smi: str) -> tuple[dict, dict]:
    """mask_train, mask_train_vs_cpu, mask_fit and bf16_train; everything
    written under the git-ignored ``smoke_out/mask_train`` is deleted after
    them. Returns the paths' launch counts and the ``_masktrain`` kernel
    row."""
    import shutil

    shutil.rmtree(MASK_TRAIN_OUT, ignore_errors=True)
    try:
        launches, k4_args = mask_train_phase(dev, kernels_mod, smi)
        paths = {"mask_train": launches}
        rows = {"multilevel_roi_align_backward_masktrain": masktrain_k4_row(dev, k4_args)}
        del k4_args
        mask_train_vs_cpu_phase(dev)
        paths.update(mask_fit_phase(dev, kernels_mod, smi))
        paths.update(bf16_train_phase(dev, kernels_mod, smi))   # reads the miniature too
    finally:
        shutil.rmtree(MASK_TRAIN_OUT, ignore_errors=True)
    return paths, rows


INT8_OUT = REPO / "smoke_out" / "int8"      # git-ignored; deleted after the phases
# int8_conv: the card's int32 accumulators equal the CPU's; the dequantized
# outputs within 1e-6 of their largest magnitude. int8_serve: calibrated
# scales within 1e-5 relative of the CPU's; card against CPU over one carried
# state: at the first activation point where the quantized values differ at
# all, under 0.1% of them and by one step (as the CPU tests against JAX:
# float epilogues that differ at rounding level move a value within rounding
# of a step, and that flip then cascades), and the embeddings within the
# card's own spread under 1e-7 input rounding plus 1e-4 relative. The
# keypoints are reported beside their spread, not gated by it: on random
# weights one flip moves a heatmap's argmax across the map, and the card's
# own spread under 1e-7 rounding reads 187 px of 320 on an H100 80GB HBM3,
# so the detector's flip gate holds them. int8_chain: the centred embedders,
# int8 on the embedder alone, flip no pair across a float gap of 5e-4 or
# more, and their score drift stays under 0.65: an H100 80GB HBM3 at 700 W
# read 0.1607, and 0.65 is 4x that, as the JAX package pins its random-init
# budget (tests/test_int8_rank_contract.py)
INT8_GATES = dict(dequant_rel=1e-6, scale_rel=1e-5, emb_rel=1e-4, first_flip_share=1e-3,
                  first_flip_steps=1, flip_budget=5e-4, chain_drift=0.65)
INT8_ROUNDINGS = (1e-7,) * 6
INT8_CALIB_BATCHES = 4


def int8_models(dev, dtype=None):
    """The serving detector (scope ``rpn`` and the keypoint head) and the
    head embedder as int8 twins over the seeded weights of
    ``build_serving_models(seed=0)``, computing in ``dtype`` (float32 by
    default), each behind a ``PTQServing``."""
    import torch
    from pets_face_recognition_tpu_torch.models import ptq
    from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
    from pets_face_recognition_tpu_torch.serving import serving_detector
    from pets_face_recognition_tpu_torch.weights import init_random_

    dtype = dtype or torch.float32
    det = serving_detector(dev, 0, "resnet50", quant="calibrate", quant_kp="calibrate",
                           dtype=dtype)
    emb = init_random_(resnet50_embedder(512, quant="calibrate", dtype=dtype), 1)
    emb = emb.eval().requires_grad_(False).to(dev)
    return (ptq.PTQServing("det_keypoint_prod", det), ptq.PTQServing("fe_dog_head", emb))


@contextlib.contextmanager
def quant_records(model, cls_name: str):
    """Each ``cls_name`` module's inputs (``QuantConv``: the first call of
    each input shape, by ``(name, shape)``) or last int8 output
    (``ActQuant``, by name) of the forwards run in the block."""
    from pets_face_recognition_tpu_torch.models import quant

    cls = getattr(quant, cls_name)
    rec, hooks = {}, []

    def record(name):
        def hook(mod, inp, out):          # returns None: the output is kept
            if cls is quant.QuantConv:    # each input shape once (the RPN's levels)
                rec.setdefault((name, tuple(inp[0].shape)), (mod, inp))
            else:
                rec[name] = out[0].clone()
        return hook

    for name, m in model.named_modules():
        if isinstance(m, cls):
            hooks.append(m.register_forward_hook(record(name)))
    try:
        yield rec
    finally:
        for h in hooks:
            h.remove()


def int8_conv_phase(dev, smi: str) -> None:
    """Phase int8_conv: every distinct ``QuantConv`` shape of the full-width
    keypoint R-CNN (scope ``rpn`` and the keypoint head) at B = 32 x 320 and
    of the embedder at B = 32 x 224, on the activations of a calibrated int8
    forward: the int32 accumulators of the first two images on the card
    against the CPU's, bit for bit; the dequantized outputs within 1e-6;
    the int8 route's ms (im2col, ``torch._int_mm``, the float32 epilogue,
    and the whole ``QuantConv`` call) beside the float32 convolution's
    (cuDNN, TF32 off) on the dequantized input, reported, not held."""
    import copy

    import torch
    import torch.nn.functional as F
    from pets_face_recognition_tpu_torch.device import float32_matmuls
    from pets_face_recognition_tpu_torch.kernel_ab import cuda_ms
    from pets_face_recognition_tpu_torch.models.quant import (dequantize, im2col, int_mm,
                                                              int8_conv2d_acc)

    t0 = time.perf_counter()
    det, emb = int8_models(dev)
    g = torch.Generator().manual_seed(21)
    imgs = torch.rand(B_TIMED, IMAGE, IMAGE, 3, generator=g).to(dev)
    crops = torch.rand(B_TIMED, CROP, CROP, 3, generator=g).to(dev)
    shapes = {}
    for runner, x, model_name in ((det, imgs, "detector"), (emb, crops, "embedder")):
        runner.calibrate(x)
        with quant_records(runner.model, "QuantConv") as rec:
            runner.serve(x)
        for (name, _), (mod, (xq, s_x)) in rec.items():
            key = (model_name, mod.in_channels, mod.out_channels, mod.kernel_size[0],
                   mod.stride[0], tuple(xq.shape))
            shapes.setdefault(key, (name, mod, xq, s_x))
    rows, acc_bad, worst_rel = [], [], 0.0
    with torch.inference_mode(), float32_matmuls():
        for (model_name, cin, cout, k, stride, xshape), (name, mod, xq, s_x) in shapes.items():
            acc = int8_conv2d_acc(xq, mod.weight_q, mod.stride, mod.padding)
            cpu_mod = copy.deepcopy(mod).cpu()
            acc_cpu = int8_conv2d_acc(xq[:2].cpu(), cpu_mod.weight_q, mod.stride, mod.padding)
            equal = torch.equal(acc[:2].cpu(), acc_cpu)
            y, y_cpu = mod(xq, s_x), cpu_mod(xq[:2].cpu(), s_x.cpu())
            rel = max_err(y[:2].cpu(), y_cpu) / max(float(y_cpu.abs().max()), 1e-30)
            worst_rel = max(worst_rel, rel)
            if not equal:
                acc_bad.append(name)
            cols, _, _ = im2col(xq, mod.kernel_size, mod.stride, mod.padding)
            wmat = mod.weight_q.reshape(cout, -1)
            acc2 = int_mm(cols, wmat)
            scale = (s_x * mod.w_scale) * (1.0 / (127.0 * 127.0))
            bias = mod.bias if mod.bias is not None else torch.zeros_like(mod.w_scale)
            x_f = dequantize(xq, s_x).contiguous()
            M, K = cols.shape
            rows.append(dict(
                model=model_name, module=name, cin=cin, cout=cout, kernel=k, stride=stride,
                input=list(xshape), M=M, K=K, N=cout, acc_equal=equal, dequant_rel_err=rel,
                im2col_ms=cuda_ms(lambda: im2col(xq, mod.kernel_size, mod.stride,
                                                 mod.padding)),
                int_mm_ms=cuda_ms(lambda: int_mm(cols, wmat)),
                epilogue_ms=cuda_ms(lambda: acc2.float() * scale + bias),
                int8_ms=cuda_ms(lambda: mod(xq, s_x)),
                float_ms=cuda_ms(lambda: F.conv2d(x_f, mod.weight, mod.bias, mod.stride,
                                                  mod.padding))))
    total_int8 = sum(r["int8_ms"] for r in rows)
    total_float = sum(r["float_ms"] for r in rows)
    emit("int8_conv", card=smi, shapes=len(rows), rows=rows, acc_not_equal=acc_bad,
         worst_dequant_rel_err=worst_rel, sum_int8_ms=total_int8, sum_float_ms=total_float,
         gates=dict(acc="bit-equal", dequant_rel=INT8_GATES["dequant_rel"]),
         note="times are one call of each shape, not weighted by its calls a forward",
         seconds=time.perf_counter() - t0)
    if acc_bad:
        raise AssertionError(f"int8_conv: int32 accumulators differ from the CPU's: {acc_bad}")
    if not worst_rel <= INT8_GATES["dequant_rel"]:
        raise AssertionError(f"int8_conv: dequantized outputs {worst_rel} apart")
    del det, emb, shapes, imgs, crops
    torch.cuda.empty_cache()


def flip_counts(a: dict, b: dict) -> dict:
    """Quantized activations that differ between two records of the same
    forward (``ActQuant`` outputs in the order the forward reached them): in
    all, by more than one step, the most steps anywhere, and at the first
    point that differs at all, its name, share and most steps."""
    total = flipped = beyond = most = 0
    first = None
    for name, x in a.items():
        d = (x.cpu().int() - b[name].cpu().int()).abs()
        total += d.numel()
        flipped += int((d > 0).sum())
        beyond += int((d > 1).sum())
        most = max(most, int(d.max()))
        if first is None and bool(d.any()):
            first = dict(point=name, share=float((d > 0).float().mean()), steps=int(d.max()))
    return dict(values=total, differ=flipped, differ_by_more_than_1=beyond, most_steps=most,
                first=first)


def flips_held(flips: dict) -> bool:
    """The first point that differs (if any) differs in under
    ``first_flip_share`` of its values and by ``first_flip_steps``."""
    f = flips["first"]
    return f is None or (f["share"] <= INT8_GATES["first_flip_share"]
                         and f["steps"] <= INT8_GATES["first_flip_steps"])


def model_gib(*models) -> float:
    """The parameters and buffers that ``models`` hold on the card."""
    return sum(t.numel() * t.element_size() for m in models
               for t in list(m.parameters()) + list(m.buffers())) / 2 ** 30


def int8_serve_phase(dev, kernels_mod, smi: str) -> dict:
    """Phase int8_serve: the keypoint R-CNN (scope ``rpn`` and the keypoint
    head) -> K1 -> the int8 embedder through ``EmbeddingService.embed_batch``
    at B = 32 x 320: calibrated on 4 seeded batches (the calibrate pass's
    embeddings against the float models'), then served int8, with the launch
    counts of K1-K3 read around one int8 call and one float call (equal);
    crops/s of float and int8 in 5 paired rounds; the peak memory of one
    call of each, taken alike with both model sets on the card, beside each
    set's own size; the int8 drift from float as max(1 - cos) over the rows
    both keep. Then the card against the CPU at B = 2 over the card's
    carried state: the quantized activations that differ (held at the first
    point that differs: ``flips_held``), the embedder's output on crops
    aligned by seeded similarity landmarks within the card's own spread
    under 1e-7 input rounding plus ``INT8_GATES``, the detector's keypoints
    beside their spread (reported); and the scales of a calibration of both
    on the same two images within 1e-5 relative."""
    import torch
    from pets_face_recognition_tpu_torch.device import float32_matmuls
    from pets_face_recognition_tpu_torch.kernel_ab import similarity_landmarks
    from pets_face_recognition_tpu_torch.models import ptq
    from pets_face_recognition_tpu_torch.ops.homography import align_crop
    from pets_face_recognition_tpu_torch.serving import (MIN_LANDMARK_DISTANCE,
                                                         EmbeddingService, build_serving_models)

    MIN_LANDMARKS = MIN_LANDMARK_DISTANCE
    t0 = time.perf_counter()
    det, emb = int8_models(dev)
    fn_det, fn_emb = ptq.PTQModelFn(det, "calibrate"), ptq.PTQModelFn(emb, "calibrate")
    f_det, f_emb, base = build_serving_models(dev, 0)
    # threshold 0: random detectors score about 0.5, and the drift needs rows
    service_q = EmbeddingService(fn_det, fn_emb, base, device=dev, score_thr=0.0,
                                 warp_dtype=torch.float32)
    service_f = EmbeddingService(f_det, f_emb, base, device=dev, score_thr=0.0,
                                 warp_dtype=torch.float32)
    g = torch.Generator().manual_seed(31)
    batches = [torch.randint(0, 256, (B_TIMED, IMAGE, IMAGE, 3), generator=g,
                             dtype=torch.uint8).to(dev) for _ in range(INT8_CALIB_BATCHES)]
    ok = torch.ones(B_TIMED, dtype=torch.bool, device=dev)
    # calibration as the chain runs it: the detector on the batch, the
    # embedder on the crops it keeps (a rejected row's crop can be NaN, and
    # NaN would poison a running max, in JAX as here)
    calib_rel = 0.0
    with torch.inference_mode(), float32_matmuls():
        for imgs in batches:
            x = imgs.float() / 255.0
            d_c, d_f = det.calibrate(x), f_det(x)
            calib_rel = max(calib_rel, max_err(d_c["scores"], d_f["scores"]),
                            max_err(d_c["keypoints"], d_f["keypoints"]) / IMAGE)
            kps = torch.round(d_c["keypoints"][:, 0, :, :2])
            crops = align_crop(x, kps, base, (CROP, CROP))
            keep = d_c["valid"][:, 0] & (torch.cdist(kps, kps) + torch.eye(3, device=dev)
                                         * 1e9).amin((1, 2)).gt(MIN_LANDMARKS)
            keep &= torch.isfinite(crops).flatten(1).all(1)
            if bool(keep.any()):
                e_c, e_f = emb.calibrate(crops[keep]), f_emb(crops[keep])
                calib_rel = max(calib_rel, max_err(e_c, e_f) / float(e_f.abs().max()))
    fn_det.mode = fn_emb.mode = "int8"
    imgs = torch.randint(0, 256, (B_TIMED, IMAGE, IMAGE, 3), generator=g,
                         dtype=torch.uint8).to(dev)
    launches = {}
    for label, service in (("int8", service_q), ("float", service_f)):
        service.embed_batch(imgs, ok)
        torch.cuda.synchronize()
        kernels_mod.reset_launch_counts()
        emb_out, valid = service.embed_batch(imgs, ok)
        torch.cuda.synchronize()
        launches[label] = kernels_mod.launch_counts()
        if label == "int8":
            e8, v8 = emb_out, valid
        else:
            ef, vf = emb_out, valid
    # rows both keep whose embeddings are finite in both (a kept row's crop
    # can still be NaN where its rounded landmarks are collinear, and int8
    # moves random landmarks)
    finite8, finitef = torch.isfinite(e8).all(1), torch.isfinite(ef).all(1)
    both = v8 & vf & finite8 & finitef
    cos = torch.nn.functional.cosine_similarity(e8[both], ef[both]) if bool(both.any()) else None
    drift = float((1 - cos).max()) if cos is not None else None
    k13 = ("warp_perspective_batch", "nms_keep_sorted_batch", "multilevel_roi_align")
    launches_ok = all(launches["int8"][k] == launches["float"][k] and launches["int8"][k]
                      for k in k13)

    def timed(service):
        t = time.perf_counter()
        service.embed_batch(imgs, ok)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    # one call's peak of each, with the same models and inputs on the card
    del batches
    torch.cuda.empty_cache()
    peak, call = {}, {}
    for label, service in (("float", service_f), ("int8", service_q)):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        timed(service)
        peak[label] = torch.cuda.max_memory_allocated() / 2 ** 30
        call[label] = peak[label] - held / 2 ** 30
    sizes = dict(float=model_gib(f_det, f_emb), int8=model_gib(det.model, emb.model))
    f_ms, q_ms = [], []
    for r in range(5):                # paired rounds, float first in even ones
        for label in (("float", "int8") if r % 2 == 0 else ("int8", "float")):
            if label == "float":
                f_ms.append(timed(service_f) * 1e3)
            else:
                q_ms.append(timed(service_q) * 1e3)

    # the card against the CPU at B = 2, over the card's carried state
    cpu_det, cpu_emb = int8_models("cpu")
    cpu_det.load_quant(det.quant_numpy())
    cpu_emb.load_quant(emb.quant_numpy())
    x2 = imgs[:2].float() / 255.0
    with quant_records(det.model, "ActQuant") as rec_card:
        d_card = det.serve(x2)
    with quant_records(cpu_det.model, "ActQuant") as rec_cpu:
        d_cpu = cpu_det.serve(x2.cpu())
    # the embedder on well-formed crops (seeded similarity landmarks), as e2e
    lms = similarity_landmarks(torch.Generator().manual_seed(2), 2, base.cpu(), IMAGE)
    crops = align_crop(x2, lms.to(dev), base, (CROP, CROP))
    with quant_records(emb.model, "ActQuant") as rec_card_e:
        o_card = emb.serve(crops)
    with quant_records(cpu_emb.model, "ActQuant") as rec_cpu_e:
        o_cpu = cpu_emb.serve(crops.cpu())
    spread_kp, spread_emb = [], []
    for s, eps in enumerate(INT8_ROUNDINGS):
        noise = torch.randn(x2.shape, generator=torch.Generator().manual_seed(s)).to(dev)
        spread_kp.append(max_err(det.serve(x2 * (1 + noise * eps))["keypoints"],
                                 d_card["keypoints"]))
        noise = torch.randn(crops.shape, generator=torch.Generator().manual_seed(s)).to(dev)
        spread_emb.append(max_err(emb.serve(crops * (1 + noise * eps)), o_card))
    kp_err = max_err(d_card["keypoints"].cpu(), d_cpu["keypoints"])
    emb_err = max_err(o_card.cpu(), o_cpu)
    emb_scale = float(o_cpu.abs().max())
    # calibration of both on the same two images: the scales
    cal_card, cal_cpu = int8_models(dev), int8_models("cpu")
    for r_card, r_cpu, x in ((cal_card[0], cal_cpu[0], x2), (cal_card[1], cal_cpu[1], crops)):
        r_card.calibrate(x)
        r_cpu.calibrate(x.cpu())
    scale_rel, worst_scale = 0.0, None
    for r_card, r_cpu in zip(cal_card, cal_cpu):
        a, b = r_card.quant_numpy(), r_cpu.quant_numpy()
        for k in b:
            if k.endswith(".scale"):
                rel = abs(float(a[k]) - float(b[k])) / float(b[k])
                if rel >= scale_rel:
                    scale_rel, worst_scale = rel, f"{r_card.name}:{k}"
    flips = dict(detector=flip_counts(rec_card, rec_cpu), embedder=flip_counts(rec_card_e, rec_cpu_e))
    gates = dict(emb_abs=max(spread_emb) + INT8_GATES["emb_rel"] * emb_scale,
                 scale_rel=INT8_GATES["scale_rel"],
                 first_flip_share=INT8_GATES["first_flip_share"],
                 first_flip_steps=INT8_GATES["first_flip_steps"])
    emit("int8_serve", card=smi, batch=B_TIMED, calibration_batches=INT8_CALIB_BATCHES,
         calibrate_vs_float_rel_err=calib_rel, launches=launches,
         float_ms=f_ms, int8_ms=q_ms, float_crops_per_s=B_TIMED / (statistics.median(f_ms) / 1e3),
         int8_crops_per_s=B_TIMED / (statistics.median(q_ms) / 1e3),
         peak_mem_gib=peak, call_mem_gib=call, model_gib=sizes,
         rows_kept=dict(int8=int(v8.sum()), float=int(vf.sum()), both_finite=int(both.sum()),
                        int8_kept_not_finite=int((v8 & ~finite8).sum()),
                        float_kept_not_finite=int((vf & ~finitef).sum())),
         drift_max_1_minus_cos=drift,
         vs_cpu=dict(batch=2, keypoint_abs_err_px=kp_err, card_keypoint_spread_px=spread_kp,
                     embedding_abs_err=emb_err, card_embedding_spread=spread_emb,
                     embedding_scale=emb_scale, flips=flips, calibrated_scale_rel_err=scale_rel,
                     worst_scale=worst_scale, roundings=list(INT8_ROUNDINGS)),
         gates=gates, seconds=time.perf_counter() - t0)
    if not launches_ok:
        raise AssertionError(f"int8_serve: K1-K3 launches {launches}")
    if drift is None:
        raise AssertionError("int8_serve: no row kept by both int8 and float")
    if not calib_rel <= 1e-5:
        raise AssertionError(f"int8_serve: the calibrate pass is {calib_rel} from float")
    if not all(math.isfinite(v) for v in (kp_err, emb_err, scale_rel)):
        raise AssertionError("int8_serve: non-finite card against CPU differences")
    if not (emb_err <= gates["emb_abs"]
            and scale_rel <= gates["scale_rel"] and all(map(flips_held, flips.values()))):
        raise AssertionError(f"int8_serve: card against CPU: keypoints {kp_err}, embeddings "
                             f"{emb_err}, scales {scale_rel}, flips {flips} against {gates}")
    del det, emb, f_det, f_emb, service_q, service_f, cal_card
    torch.cuda.empty_cache()
    return launches["int8"]


def centred_embedder_ckpts(dev, out: Path) -> dict[str, str]:
    """FE checkpoints of the head embedders (``build_retrieval_models``' seeds
    1 and 2) with the ``fc`` bias moved by minus their mean embedding of the
    corpus' aligned crops (as ``fe_eval_vs_cpu`` centres it: pair cosines
    spread around 0 instead of near 1), named by the variables that
    ``pipelines.embedder`` reads."""
    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch import generate_tsv, native
    from pets_face_recognition_tpu_torch.pipelines import FE_CKPTS, build_retrieval_models
    from pets_face_recognition_tpu_torch.serving import EmbeddingService

    det, dog, cat = build_retrieval_models(dev, 0)
    service = EmbeddingService(det, dog, device=dev, score_thr=0.0, warp_dtype=torch.float32)
    paths = sorted(CORPUS.rglob("*.jpg"))
    imgs, ok, _, _ = native.decode_batch([str(p) for p in paths], (IMAGE, IMAGE))
    env = {}
    for name, model in (("fe_dog_head", dog), ("fe_cat_head", cat)):
        service.embedder = model
        e, v = service.embed_batch(torch.from_numpy(imgs).to(dev), torch.from_numpy(ok).to(dev))
        sd = {k: t.cpu() for k, t in model.state_dict().items()}
        sd["fc.bias"] = sd["fc.bias"] - e[v].mean(0).cpu()
        folder = out / name
        folder.mkdir(parents=True, exist_ok=True)
        torch.save({"model": sd}, folder / "epoch=0-step=0")
        env[FE_CKPTS[name][0]] = str(folder)
    del det, dog, cat, service
    return env


def near_tie_share(dump: Path, budget: float) -> tuple[float | None, int]:
    """The share of a dump's scored pairs (two gallery cards of one query)
    whose float scores lie closer than ``budget``, and the pair count."""
    import numpy as np
    from pets_face_recognition_tpu_torch import retrieval

    near = pairs = 0
    for d in retrieval.load_scores_dump(dump).values():
        s = d["scores"][d["include"]].astype(np.float64)
        iu = np.triu_indices(len(s), 1)
        pairs += len(iu[0])
        near += int((np.abs(s[iu[0]] - s[iu[1]]) < budget).sum())
    return (near / pairs if pairs else None), pairs


def int8_chain_phase(dev, smi: str) -> None:
    """Phase int8_chain: ``generate_tsv`` in subprocesses over the committed
    corpus (``PFR_RETRIEVAL_THR=0``) with the head embedders' ``fc`` bias
    centred (``centred_embedder_ckpts``: pair cosines spread around 0, where
    the seeded embedders' all sit near 1 and every pair is a near-tie; the
    trunks, and so the quant state, are the seeded ones): float with
    ``PFR_SCORES_DUMP``; ``PFR_QUANT_MODE=int8`` without a state file, which
    must exit nonzero with JAX's message; ``calibrate`` with ``--body`` (the
    state of all six models, written at exit); ``int8 --body``; int8 on the
    embedder alone (``PFR_QUANT_COMPONENTS=embedder``: the detector stays
    float, so the crops are the float run's and only the embedder's int8
    error shows) and int8 on the default components, each with a dump. The
    runs go in two rounds of concurrent processes: the float, the stateless
    (given a state path that does not exist) and the calibrate one; then the
    three int8 ones, which read the calibrated state.
    Every run but the one without state exits 0 and every tsv query has its
    dump row. ``near_tie`` holds the float and embedder-only int8 dumps to
    the contract: no rank flip across a float gap of ``flip_budget`` or more
    and a drift under ``chain_drift``. The default-components pair (the int8
    detector moves the random landmarks, so the crops differ) is reported,
    with the share of the float run's pairs that are near-ties."""
    from pets_face_recognition_tpu_torch import near_tie, retrieval

    t0 = time.perf_counter()
    INT8_OUT.mkdir(parents=True, exist_ok=True)
    state = INT8_OUT / "quant_state.pkl"
    env = {k: v for k, v in os.environ.items() if not k.startswith("PFR_")}
    env.update(PFR_RETRIEVAL_THR="0.0", PFR_QUANT_STATE=str(state),
               PYTHONPATH=os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]))
    centred = centred_embedder_ckpts(dev, INT8_OUT / "fe")
    runs, procs = {}, {}

    def start(stack, label, mode, body=False, dump=False, extra=None):
        e = dict(env, PFR_QUANT_MODE=mode, **(extra or {}))
        if dump:
            e["PFR_SCORES_DUMP"] = str(INT8_OUT / f"{label}.npz")
        cmd = [sys.executable, "-m", "pets_face_recognition_tpu_torch.generate_tsv", "--data",
               str(CORPUS), "--device", str(dev), "--output", str(INT8_OUT / f"{label}.tsv")]
        procs[label] = stack.enter_context(background(cmd + (["--body"] if body else []),
                                                      INT8_OUT, e))

    def finish(label):
        proc, seconds = procs[label]()
        runs[label] = dict(rc=proc.returncode, seconds=seconds,
                           ptq=[ln for ln in proc.stdout.splitlines() if ln.startswith("PTQ:")],
                           stderr_tail=proc.stderr[-300:] if proc.returncode else "")
        return proc

    with contextlib.ExitStack() as stack:
        start(stack, "float", "", dump=True, extra=centred)
        start(stack, "int8_no_state", "int8",
              extra=dict(centred, PFR_QUANT_STATE=str(INT8_OUT / "no_state" / "absent.pkl")))
        start(stack, "calibrate_body", "calibrate", body=True, extra=centred)
        finish("float")
        missing = finish("int8_no_state")
        finish("calibrate_body")
        start(stack, "int8_body", "int8", body=True, extra=centred)
        start(stack, "int8_embedder", "int8", dump=True,
              extra=dict(centred, PFR_QUANT_COMPONENTS="embedder"))
        start(stack, "int8", "int8", dump=True, extra=centred)
        for label in ("int8_body", "int8_embedder", "int8"):
            finish(label)
    expected_rc = {k: (v["rc"] != 0 if k == "int8_no_state" else v["rc"] == 0)
                   for k, v in runs.items()}
    message = "PFR_QUANT_MODE=int8 requires a calibrated quant state at" in missing.stderr
    if not (all(expected_rc.values()) and message):
        emit("int8_chain", card=smi, runs=runs, missing_state_message=message)
        raise AssertionError(f"int8_chain: runs {runs}")
    labels = ("float", "int8_embedder", "int8")
    rows = {k: len((INT8_OUT / f"{k}.tsv").read_text().splitlines()) - 1 for k in labels}
    dumps = {k: len(retrieval.load_scores_dump(INT8_OUT / f"{k}.npz")) for k in labels}
    budget, drift = INT8_GATES["flip_budget"], INT8_GATES["chain_drift"]
    reports = {f"float/{b}": near_tie.check(INT8_OUT / "float.npz", INT8_OUT / f"{b}.npz", drift,
                                            budget) for b in ("int8_embedder", "int8")}
    held = reports["float/int8_embedder"]
    share, pairs = near_tie_share(INT8_OUT / "float.npz", budget)
    emit("int8_chain", card=smi, runs=runs, missing_state_message=message,
         tsv_rows=rows, dump_queries=dumps, near_tie=reports,
         near_tie_pair_share=share, float_pairs=pairs,
         gates=dict(flip_budget=budget, drift=drift,
                    held="float/int8_embedder; float/int8 is reported"),
         seconds=time.perf_counter() - t0)
    if rows != dumps or not rows["float"]:
        raise AssertionError(f"int8_chain: tsv rows {rows} against dumped queries {dumps}")
    if held["contract"] != "NEAR-TIE-SAFE":
        raise AssertionError(f"int8_chain: near-tie contract violated: {held}")


def int8_phases(dev, kernels_mod, smi: str) -> dict[str, dict]:
    """int8_conv, int8_serve and int8_chain; everything written under the
    git-ignored ``smoke_out/int8`` is deleted after them."""
    import shutil

    shutil.rmtree(INT8_OUT, ignore_errors=True)
    try:
        int8_conv_phase(dev, smi)
        paths = {"int8_serve": int8_serve_phase(dev, kernels_mod, smi)}
        int8_chain_phase(dev, smi)
    finally:
        shutil.rmtree(INT8_OUT, ignore_errors=True)
    return paths


# the alternate detector families, each at its own default budgets: (factory,
# image side; Swin's sides must be multiples of 7 x 32)
ALT_FACTORIES = (("swin_tiny_keypoint_rcnn", 448), ("fasterrcnn_resnet50_fpn", 320),
                 ("mobile_net_v3_large_rcnn", 320), ("convnetx_tiny_rcnn", 320),
                 ("convnext_tiny_keypoint_rcnn", 320))
ALT_STEPS = 2                     # the first step warms cuDNN up; the second is timed
ALT_EVALS = 4                     # the checked eval forward and 3 timed ones
# card against CPU: the mask phases' eval gates; an argmax that moves is
# allowed only where the two picks' scores lie within the band (a near-tie)
ALT_GATES = dict(score_abs=1e-5, box_rel_to_side=1e-4, keypoint_rel_to_side=1e-4,
                 score_band=1e-5, keypoint_score_band_rel=1e-4, loss_rel=1e-4, grad_rel=1e-3)
# the Swin step's tensors whose gate also allows their own moves under 1e-6 rounding
ALT_KP_GROUPS = ("roi_heads.keypoint_head.", "roi_heads.keypoint_predictor.")


def alt_expected_launches(name: str) -> dict[str, int]:
    """Launches of one drive (``ALT_EVALS`` eval forwards, ``ALT_STEPS``
    steps): K2 once an eval in the RPN and once more in the box NMS of the
    100-detection factory, once a step; K3 once an eval and a step on box
    RoIs and once more on keypoint RoIs; K4 and its pre-pass once a step a
    RoI size."""
    kp = "keypoint" in name
    faster = name.startswith("faster")
    return {"nms_keep_sorted_batch": ALT_EVALS * (1 + faster) + ALT_STEPS,
            "multilevel_roi_align": (ALT_EVALS + ALT_STEPS) * (1 + kp),
            "multilevel_roi_align_backward": ALT_STEPS * (1 + kp),
            "roi_footprints": ALT_STEPS * (1 + kp)}


def alt_eval_diff(d_gpu: dict, d_cpu: dict, side: int) -> dict:
    """The card's detections against the CPU's: validity equal except at the
    score threshold's band; on valid slots labels, scores, boxes and
    keypoints within ``ALT_GATES``. A slot whose box (or keypoint) differs
    by more is an argmax that moved: counted, and allowed only if the two
    picks' scores lie within the band. Returns the errors and counts, with
    ``bad``: the slots that break the gates."""
    import torch

    g = ALT_GATES
    ok_g, ok_c = d_gpu["valid"], d_cpu["valid"]
    thr_band = ((d_cpu["scores"] - 0.05).abs() <= g["score_band"]) | (
        (d_gpu["scores"] - 0.05).abs() <= g["score_band"])
    bad = int(((ok_g != ok_c) & ~thr_band).sum())
    both = ok_g & ok_c
    s_err = (d_gpu["scores"] - d_cpu["scores"]).abs()
    b_err = (d_gpu["boxes"] - d_cpu["boxes"]).abs().amax(-1)
    moved = both & (b_err > g["box_rel_to_side"] * side)
    bad += int((moved & (s_err > g["score_band"])).sum())
    held = both & ~moved
    bad += int((held & ((s_err > g["score_abs"]) | (d_gpu["labels"] != d_cpu["labels"]))).sum())
    out = dict(valid_gpu=int(ok_g.sum()), valid_cpu=int(ok_c.sum()),
               validity_in_threshold_band=int(((ok_g != ok_c) & thr_band).sum()),
               argmax_moved=int(moved.sum()),
               score_abs_err=float(s_err[held].max()) if held.any() else 0.0,
               box_abs_err_px=float(b_err[held].max()) if held.any() else 0.0)
    if "keypoints" in d_cpu:
        k_err = (d_gpu["keypoints"][..., :2] - d_cpu["keypoints"][..., :2]).abs().amax(-1)
        ks_g, ks_c = d_gpu["keypoints_scores"], d_cpu["keypoints_scores"]
        k_moved = held[..., None] & (k_err > g["keypoint_rel_to_side"] * side)
        band = g["keypoint_score_band_rel"] * ks_c.abs().clamp(min=1.0)
        bad += int((k_moved & ((ks_g - ks_c).abs() > band)).sum())
        k_held = held[..., None] & ~k_moved
        bad += int((k_held & ((ks_g - ks_c).abs() > band)).sum())
        out.update(keypoint_argmax_moved=int(k_moved.sum()),
                   keypoint_abs_err_px=float(k_err[k_held].max()) if k_held.any() else 0.0,
                   keypoint_score_abs_err=float((ks_g - ks_c).abs()[k_held].max())
                   if k_held.any() else 0.0)
    out["bad"] = bad
    return out


def alt_train_vs_cpu(dev) -> tuple[dict, list[str]]:
    """The Swin keypoint R-CNN's step at full width (Swin-T, B = 2 at 224 x
    224, the JAX tool's small budgets and targets) on the card and on the
    CPU from one set of weights and one draw of sampler noise, and each
    device's own step again on images rounded differently: on the card three
    draws at 1e-7 and six at 1e-6 relative, on the CPU three at 1e-6. Each
    loss term within 1e-4 relative. Every gradient outside the keypoint head
    and predictor within 1e-3 plus the card's own move under 1e-7 rounding,
    relative in norm (worst tensor; the median tensor likewise with the
    median moves). The keypoint head's and predictor's gradients within 1e-3
    plus twice the largest move either device's own step makes in them under
    1e-6 rounding. The step is ill-conditioned in float32 (ROADMAP notes 9,
    16 and 21): with random weights the keypoint loss has few sources (the
    ground-truth boxes' visible keypoints), so one ReLU of the keypoint head
    that sits within rounding of 0 and flips moves all 16 of its tensors by
    ~5e-3; 1e-7 rounding flips nothing on the card, 1e-6 does on either
    device. Returns the record and the failures."""
    import copy

    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch.device import float32_matmuls
    from pets_face_recognition_tpu_torch.drive_alt_factories import SMALL, batch
    from pets_face_recognition_tpu_torch.losses.losses import sum_detection_loss
    from pets_face_recognition_tpu_torch.models import rcnn
    from pets_face_recognition_tpu_torch.weights import init_random_

    size = 224
    cpu_model = init_random_(rcnn.swin_tiny_keypoint_rcnn(**SMALL), 2)
    images, targets = batch(size, True, np.random.RandomState(3))
    # p2..p5 and the max-pool p6, which rounds up (7 -> 4 at 224)
    n_anchors = cpu_model.num_anchors * sum((-(-size // st)) ** 2 for st in (4, 8, 16, 32, 64))
    noise = cpu_model.draw_sampler_noise(2, n_anchors, 2, torch.Generator().manual_seed(4))

    def rounded(seed, amp):
        jitter = 1 + np.random.RandomState(seed).randn(*images.shape) * amp
        return (images * jitter).astype(np.float32)

    runs = [("gpu", dev, images), ("cpu", "cpu", images)]
    runs += [(f"gpu_{amp:g}_{s}", dev, rounded(s, amp)) for amp, n in ((1e-7, 3), (1e-6, 6))
             for s in range(1, n + 1)]
    runs += [(f"cpu_1e-06_{s}", "cpu", rounded(s, 1e-6)) for s in (1, 2, 3)]
    out = {}
    with float32_matmuls():
        for name, device, x in runs:
            model = copy.deepcopy(cpu_model).to(device)
            t = time.perf_counter()
            losses = sum_detection_loss(model(
                torch.from_numpy(x).to(device),
                {k: torch.from_numpy(v).to(device) for k, v in targets.items()},
                sampler_noise=noise))
            losses["loss"].backward()
            elapsed = time.perf_counter() - t
            out[name] = ({k: float(v.detach()) for k, v in losses.items()},
                         {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                         elapsed)
            del model

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))

    (l_gpu, g_gpu, t_gpu), (l_cpu, g_cpu, t_cpu) = out["gpu"], out["cpu"]
    # the keypoint predictor's bias: 0 by construction on both sides
    names = [n for n in g_gpu if n != "roi_heads.keypoint_predictor.kps_score_lowres.bias"]

    def errs(a, b):
        return [rel(a[n], b[n]) for n in names]

    def by_group(e):
        groups = {}
        for n, v in zip(names, e):
            groups.setdefault(".".join(n.split(".")[:2]), []).append(v)
        return {k: [statistics.median(v), max(v)] for k, v in groups.items()}

    spreads = {r: errs(out[r][1], (g_gpu if r.startswith("gpu") else g_cpu)) for r in out
               if r not in ("gpu", "cpu")}
    direct = errs(g_cpu, g_gpu)
    # (tensors, the draws whose moves widen the gate, their weight)
    kp = [n.startswith(ALT_KP_GROUPS) for n in names]
    families = {"keypoint_head": ([i for i, k in enumerate(kp) if k], "1e-06", 2),
                "rest": ([i for i, k in enumerate(kp) if not k], "gpu_1e-07", 1)}
    bounds, failures = {}, []
    for fam, (idx, draws, weight) in families.items():
        moves = [[x[i] for i in idx] for r, x in spreads.items() if draws in r]
        bounds[fam] = {"worst": ALT_GATES["grad_rel"] + weight * max(max(m) for m in moves),
                       "median": ALT_GATES["grad_rel"] + weight * max(
                           statistics.median(m) for m in moves)}
        err = [direct[i] for i in idx]
        if not (max(err) <= bounds[fam]["worst"]
                and statistics.median(err) <= bounds[fam]["median"]):
            worst = names[idx[err.index(max(err))]]
            failures.append(f"Swin step gradient {worst} differs from the CPU's: {max(err)} "
                            f"(median of the {fam} tensors {statistics.median(err)}; "
                            f"bounds {bounds[fam]})")
    worst = names[direct.index(max(direct))]
    loss_rel = {k: abs(l_gpu[k] - l_cpu[k]) / abs(l_cpu[k]) for k in l_cpu}
    rec = dict(image=size, batch=2, budgets=SMALL, losses_gpu=l_gpu, losses_cpu=l_cpu,
               loss_rel_err=loss_rel, grad_rel_err_max=max(direct), grad_rel_err_worst=worst,
               grad_rel_err_median=statistics.median(direct), grad_by_group=by_group(direct),
               own_rounding_moves={r: [max(x), statistics.median(x), by_group(x)]
                                   for r, x in spreads.items()},
               grad_bounds=bounds, grad_tensors=len(names), step_s_gpu=t_gpu, step_s_cpu=t_cpu)
    bad = {k: v for k, v in loss_rel.items() if not v <= ALT_GATES["loss_rel"]}
    if bad:
        failures.append(f"Swin step losses differ from the CPU's: {bad}")
    return rec, failures


def alt_rcnn_phase(dev, kernels_mod, smi: str) -> tuple[dict, dict]:
    """Phase alt_rcnn: the five alternate factories at full width (Swin-T,
    ResNet-50, MobileNetV3-Large, ConvNeXt-T) and their own default budgets,
    with seeded random weights: ``drive_alt_factories.drive`` at B = 2 (Swin
    at 448 x 448, the others at 320 x 320) runs the eval forward, two
    training steps (the second timed warm) and three timed eval forwards,
    with the launches of K2, K3, K4 and the pre-pass counted from 0 around
    it (each must equal ``alt_expected_launches``) and its peak memory; then
    the same weights' eval forward on the card against the CPU on a fresh
    batch (``alt_eval_diff``), and the Swin step against the CPU
    (``alt_train_vs_cpu``). Last, K3 and K4 at the Swin detector's 448 x 448
    training shapes (p2-p5 of 2 images, 1024 box RoIs at 7 x 7 and 256
    keypoint RoIs at 14 x 14) against their plain versions: the kernel rows
    ``_alt``. Returns the paths' launch counts (``alt_<factory>``) and the
    rows."""
    import copy

    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch.device import float32_matmuls
    from pets_face_recognition_tpu_torch.drive_alt_factories import drive
    from pets_face_recognition_tpu_torch.models import rcnn
    from pets_face_recognition_tpu_torch.weights import init_random_

    t_phase = time.perf_counter()
    paths, failures = {}, []
    for i, (name, size) in enumerate(ALT_FACTORIES):
        kp = "keypoint" in name
        model = init_random_(getattr(rcnn, name)(), 10 + i)
        cpu_model = copy.deepcopy(model)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels_mod.reset_launch_counts()
        rec = drive(name, lambda: model, size, kp, dev, seed=i, steps=ALT_STEPS,
                    eval_repeats=ALT_EVALS - 1)
        launches = kernels_mod.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        paths[f"alt_{name}"] = launches
        want = alt_expected_launches(name)
        got = {k: launches[k] for k in want}
        x = torch.from_numpy(np.random.RandomState(100 + i).rand(2, size, size, 3)
                             .astype(np.float32))
        with torch.no_grad(), float32_matmuls():
            d_gpu = {k: v.cpu() for k, v in model.eval()(x.to(dev)).items()}
            t = time.perf_counter()
            d_cpu = cpu_model.eval()(x)
            cpu_s = time.perf_counter() - t
        diff = alt_eval_diff(d_gpu, d_cpu, size)
        emit("alt_rcnn", factory=name, card=smi, image=size, batch=2,
             detections_per_img=model.cfg.box_detections_per_img,
             rpn_test=[model.cfg.rpn_pre_nms_top_n_test, model.cfg.rpn_post_nms_top_n_test],
             rpn_train=[model.cfg.rpn_pre_nms_top_n_train, model.cfg.rpn_post_nms_top_n_train],
             eval_ms=rec["eval_ms"], eval_first_s=rec["eval_first_s"],
             step_ms=rec["step_ms"][-1], step_ms_all=rec["step_ms"], peak_mem_gib=peak,
             launches=got, launches_expected=want, eval_dets=rec["eval_dets"],
             train_losses=rec["train_losses"], grad_abs_sum=rec["grad_abs_sum"],
             vs_cpu=diff, cpu_eval_s=cpu_s, tolerances=ALT_GATES,
             precision="float32: TF32 off inside drive and the comparison")
        if got != want:
            failures.append(f"{name}: launches {got}, expected {want}")
        if diff["bad"]:
            failures.append(f"{name}: card against CPU breaks the gates: {diff}")
        del model, cpu_model
    torch.cuda.empty_cache()
    rec, train_failures = alt_train_vs_cpu(dev)
    emit("alt_rcnn_train_vs_cpu", factory="swin_tiny_keypoint_rcnn", **rec, tolerances=ALT_GATES)
    failures += train_failures
    if failures:
        raise AssertionError("; ".join(failures))
    rows = roi_kernel_rows(dev, torch.Generator().manual_seed(15), (4, 8, 16, 32), 2, 5,
                           label=" swin 448", batch=2, image=448)
    emit("alt_rcnn_done", seconds=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return paths, {"multilevel_roi_align_alt": rows["multilevel_roi_align"],
                   "multilevel_roi_align_backward_alt": rows["multilevel_roi_align_backward"]}


# ---- reduced precision training and int8 in bfloat16 ----------------------
# each bfloat16 detector step: K2 once (the RPN), K3's and K4's bfloat16
# instances and K4's pre-pass once at each RoI size (box 7 x 7, and keypoint
# or mask 14 x 14)
BF16_TRAIN_LAUNCHES = {"nms_keep_sorted_batch": 1, "multilevel_roi_align_bf16": 2,
                       "multilevel_roi_align_backward_bf16": 2, "roi_footprints": 2}
BF16_EVAL_LAUNCHES = {"nms_keep_sorted_batch": 1, "multilevel_roi_align_bf16": 2}
BF16_TRAIN_STEPS = 4              # one warm-up and three timed
# the reduced steps' float32 gates (train_vs_cpu, fe_step_vs_cpu), added to
# twice bfloat16's own move: statistics relative, gradients relative in norm;
# a loss's is the largest error of one bfloat16 rounding of its value, 2^-8
# (above the float32 gate's 1e-3): a scalar's own move can land near 0 in
# every draw (ConvNeXt-T's classifier loss: the card's bfloat16 1.3e-3 from
# float32, the CPU's 1.5e-4 at most over two draws, of 0.498)
BF16_STEP_FLOOR = dict(loss_rel=2.0 ** -8, grad_rel_norm=5e-3, stats_rel_norm=1e-4)
# bfloat16's own move on the CPU is the largest over the input and
# BF16_DRAWS copies of it with each value jittered by up to BF16_JITTER
# relative, below bfloat16's resolution (tests/test_torch_port_bf16_train.py)
BF16_DRAWS, BF16_JITTER = 1, 2.0 ** -9
# float32 step ms and peak GiB of `train` and `mask_train`, read by bf16_train
F32_STEPS: dict[str, tuple[float, float]] = {}


def k4_bf16_work(shapes, rois, out: int, strides, s: int = 2) -> tuple[float, float]:
    """The operations that K4-bf16's two contractions need on these RoIs,
    ``(tensor-core flops, float32 flops)``: for each RoI on its level, the
    first, ``T[y, pw, c] = sum_sy Wy[sy, y] G[sy, pw, c]``, costs 2 C flops
    for each nonzero ``Wy`` entry (a sample row's in-bounds taps) and each
    bin column with an in-bounds sample; the second, ``out[y, x, c] =
    sum_pw Ax[x, pw] T[y, pw, c]``, 2 C for each footprint row and each
    distinct nonzero (bin column, cell) entry of ``Ax``."""
    import torch
    from pets_face_recognition_tpu_torch.ops.roi_align import _sample_offsets, roi_levels

    lvl = roi_levels(rois, 2, len(shapes) + 1).long()
    tc = fma = 0.0
    for li, (_, H, W, C) in enumerate(shapes):
        sel = lvl == li
        if not sel.any():
            continue
        r = rois[sel] * (1.0 / strides[li])
        taps = []
        for lo, hi, lim in ((r[:, 1], r[:, 3], H), (r[:, 0], r[:, 2], W)):
            pos = lo[:, None] + _sample_offsets(out, s, rois.device)[None] * (
                (hi - lo).clamp(min=1.0) / out)[:, None]
            ok = (pos > -1) & (pos < lim)
            c = pos.clamp(min=0)
            low = c.floor().clamp(max=lim - 1)
            high_live = ok & (low < lim - 1) & (c > low)
            taps.append((ok, low, high_live))
        (ok_y, low_y, hi_y), (ok_x, low_x, hi_x) = taps
        n_wy = ok_y.sum(1) + hi_y.sum(1)
        rows = torch.where(ok_y, low_y + hi_y.float(), -1.0).amax(1) - torch.where(
            ok_y, low_y, float(H)).amin(1) + 1
        pw = torch.arange(out, device=rois.device).repeat_interleave(s)[None].expand_as(low_x)
        n = r.shape[0]
        k = torch.arange(n, device=rois.device)[:, None].expand_as(low_x)
        keys = torch.cat([((k * out + pw) * W + low_x.long())[ok_x],
                          ((k * out + pw) * W + low_x.long() + 1)[hi_x]])
        n_ax = torch.bincount(torch.unique(keys) // (out * W), minlength=n)
        n_pw = ok_x.reshape(n, out, s).any(2).sum(1)
        tc += float((2 * C * n_wy * n_pw).sum())
        fma += float((2 * C * rows.clamp(min=0) * n_ax).sum())
    return tc, fma


def bf16_backward_kernel_row(dev) -> dict[str, dict]:
    """Kernel row ``multilevel_roi_align_backward_bf16``: K4 with bfloat16
    operands at the training step's shapes (p2..p5 of 16 images of 640 x 640,
    C = 256, bfloat16 levels; 8192 box RoIs at 7 x 7 and 2048 keypoint RoIs at
    14 x 14), its float32 sums (the float32-output instance) against its plain
    version's within 1e-5 of the scale (the two sum in other orders, the first
    contraction on the tensor cores), where K4 in float32 on the same inputs
    must lie beyond that (its operands are not rounded to bfloat16); its
    bfloat16 result equal to those sums rounded, bit for bit, and
    bit-identical across two launches; with a bfloat16 cotangent (the
    float32 one rounded) equal to its result on that cotangent's float32
    copy. The row's times and bound are those of the bfloat16 cotangent, the
    one a bfloat16 training step gives it (the float32 cotangent's beside
    them): timed with CUDA events beside K4 in float32 on the same RoIs (and
    the float32 cotangent), the plain version and the bound (bytes: the
    cotangent in its type and the RoIs read, the bfloat16 level gradients
    written once; operations: ``k4_bf16_work``), with each kernel's device
    us. ``odd_sampling_lines`` holds the instance for other sampling ratios
    on a smaller pyramid. K3-bf16 at
    the same shapes on the same RoIs (the step's forward) rides along:
    against its plain version within 1e-4 of the scale, its bfloat16 output
    equal to its float32 output rounded, timed beside its plain version."""
    import torch
    from pets_face_recognition_tpu_torch.kernel_ab import cuda_ms, random_rois
    from pets_face_recognition_tpu_torch.ops import roi_align

    g = torch.Generator().manual_seed(17)
    C, strides, bf16 = 256, (4, 8, 16, 32), torch.bfloat16
    shapes = [(B_TRAIN, IMAGE_TRAIN // st, IMAGE_TRAIN // st, C) for st in strides]
    level_elems = sum(math.prod(s) for s in shapes)
    levels = [torch.randn(*sh, generator=g).to(dev).to(bf16) for sh in shapes]
    acc = dict(ms=0.0, plain=0.0, bytes=0.0, flops=0.0, tc_flops=0.0, err=0.0)
    bits16 = lambda t: t.view(torch.int16)  # noqa: E731
    for n_per, out in ((512, 7), (128, 14)):
        n = B_TRAIN * n_per
        rois = random_rois(g, n, IMAGE_TRAIN, 5.0).to(dev)
        bidx = torch.arange(B_TRAIN, device=dev).repeat_interleave(n_per).to(torch.int32)
        k3_train_line(levels, rois, bidx, out, strides)
        grad = torch.randn(n, out, out, C, generator=g).to(dev)
        args = (grad, shapes, rois, bidx, (out, out), strides)
        got = roi_align.multilevel_roi_align_backward_cuda(*args, dtype=bf16)
        again = roi_align.multilevel_roi_align_backward_cuda(*args, dtype=bf16)
        sums = roi_align.multilevel_roi_align_backward_cuda(*args, dtype=bf16,
                                                            out_dtype=torch.float32)
        torch.cuda.synchronize()
        bit_diff = sum(int((bits16(a) != bits16(b)).sum()) for a, b in zip(got, again))
        round_diff = sum(int((bits16(a) != bits16(s_.to(bf16))).sum())
                         for a, s_ in zip(got, sums))
        del got, again
        want = roi_align.multilevel_roi_align_backward_bf16(*args)
        scale = max(float(w.abs().max()) for w in want)
        err = max(max_err(a, w) for a, w in zip(sums, want))
        del sums
        f32_gap = max(max_err(a, w) for a, w in zip(
            roi_align.multilevel_roi_align_backward_cuda(*args), want))
        del want
        # a bfloat16 cotangent, read as it comes: the same bits as its float32 copy
        grad_b = grad.to(bf16)
        bargs = (grad_b,) + args[1:]
        cot_diff = sum(int((bits16(a) != bits16(b)).sum()) for a, b in zip(
            roi_align.multilevel_roi_align_backward_cuda(*bargs, dtype=bf16),
            roi_align.multilevel_roi_align_backward_cuda(grad_b.float(), *args[1:],
                                                         dtype=bf16)))
        k4 = lambda: roi_align.multilevel_roi_align_backward_cuda(*args, dtype=bf16)  # noqa
        k4_b = lambda: roi_align.multilevel_roi_align_backward_cuda(  # noqa: E731
            *bargs, dtype=bf16)
        k4_32 = lambda: roi_align.multilevel_roi_align_backward_cuda(*args)  # noqa: E731
        ms, ms_b, f32_ms = (cuda_ms(k4, iters=10), cuda_ms(k4_b, iters=10),
                            cuda_ms(k4_32, iters=10))
        plain = cuda_ms(lambda: roi_align.multilevel_roi_align_backward_bf16(*bargs),
                        warmup=1, iters=3)
        mma = "multilevel_roi_align_backward_bf16_mma_kernel"
        us, us_b = kernel_us(k4, mma, iters=5), kernel_us(k4_b, mma, iters=5)
        us32 = kernel_us(k4_32, "multilevel_roi_align_backward_kernel", iters=5)
        tc, nf = k4_bf16_work(shapes, rois, out, strides)
        io = rois.numel() * 4 + bidx.numel() * 4 + level_elems * 2
        nb = grad.numel() * 4 + io
        b, by = bound_ms(nb, nf, tc)
        b_b, by_b = bound_ms(grad.numel() * 2 + io, nf, tc)
        name = f"K4-bf16 multilevel_roi_align_backward_bf16 {out}x{out}"
        emit("kernel", name=name, rois=n, shape=[B_TRAIN, IMAGE_TRAIN, IMAGE_TRAIN, C],
             levels=[2, 5], level_dtype="bfloat16", kernel=mma, max_abs_err=err,
             grad_max_abs=scale, atol=1e-5 * scale, float32_instance_max_abs_err=f32_gap,
             second_launch_bits_differ=bit_diff, rounded_sums_bits_differ=round_diff,
             bf16_cotangent_bits_differ=cot_diff, cotangent_dtype="bfloat16", ms=ms_b,
             kernel_device_us=us_b, float32_cotangent_ms=ms, float32_cotangent_kernel_device_us=us,
             float32_cotangent_bound_ms=b, float32_cotangent_bound_by=by, float32_ms=f32_ms,
             float32_kernel_device_us=us32, plain_ms=plain, library_ms=None,
             library="none (no torchvision)", bound_ms=b_b, bound_by=by_b,
             tensor_core_flops=tc, float32_flops=nf)
        if not err <= 1e-5 * scale < f32_gap:
            raise AssertionError(f"{name}: float32 sums {err} from the plain version, K4 in "
                                 f"float32 {f32_gap}, the scale {scale}")
        if bit_diff or round_diff or cot_diff:
            raise AssertionError(f"{name}: {bit_diff} elements differ across two launches, "
                                 f"{round_diff} from the float32 sums rounded, {cot_diff} "
                                 "with a bfloat16 cotangent")
        acc["ms"] += ms_b
        acc["plain"] += plain
        acc["bytes"] += grad.numel() * 2 + io
        acc["flops"] += nf
        acc["tc_flops"] += tc
        acc["err"] = max(acc["err"], err)
        del grad, grad_b
    del levels
    torch.cuda.empty_cache()
    odd_sampling_lines(dev, g)
    b, by = bound_ms(acc["bytes"], acc["flops"], acc["tc_flops"])
    return {"multilevel_roi_align_backward_bf16": dict(
        max_abs_err=acc["err"], ms=acc["ms"], plain_ms=acc["plain"], bound_ms=b, bound_by=by,
        library_ms=None)}


def odd_sampling_lines(dev, g) -> None:
    """K4-bf16's instance for sampling ratios other than 2 (the models use 2):
    S = 1 and 3 at 7 x 7 and S = 3 at 14 x 14 (42 sample rows, an odd first
    sample row wherever the first bin that meets a tile is odd), on p2..p5 of
    two 320 x 320 images, C = 256, bfloat16 levels: its float32 sums within
    1e-5 of the scale of its plain version, its bfloat16 result those sums
    rounded, bit for bit, and with a bfloat16 cotangent its result on that
    cotangent's float32 copy. One line each; raises on a disagreement."""
    import torch
    from pets_face_recognition_tpu_torch.kernel_ab import random_rois
    from pets_face_recognition_tpu_torch.ops import roi_align

    B, image, C, strides, bf16 = 2, 320, 256, (4, 8, 16, 32), torch.bfloat16
    shapes = [(B, image // st, image // st, C) for st in strides]
    bits16 = lambda t: t.view(torch.int16)  # noqa: E731
    for s, out in ((1, 7), (3, 7), (3, 14)):
        n = B * 128
        rois = random_rois(g, n, image, 5.0).to(dev)
        bidx = torch.arange(B, device=dev).repeat_interleave(n // B).to(torch.int32)
        grad = torch.randn(n, out, out, C, generator=g).to(dev).to(bf16)
        args = (grad, shapes, rois, bidx, (out, out), strides)
        kw = dict(sampling_ratio=s, dtype=bf16)
        got = roi_align.multilevel_roi_align_backward_cuda(*args, **kw)
        sums = roi_align.multilevel_roi_align_backward_cuda(*args, **kw, out_dtype=torch.float32)
        from_f32 = roi_align.multilevel_roi_align_backward_cuda(grad.float(), *args[1:], **kw)
        want = roi_align.multilevel_roi_align_backward_bf16(*args, sampling_ratio=s)
        torch.cuda.synchronize()
        scale = max(float(w.abs().max()) for w in want)
        err = max(max_err(a, w) for a, w in zip(sums, want))
        round_diff = sum(int((bits16(a) != bits16(b.to(bf16))).sum()) for a, b in zip(got, sums))
        cot_diff = sum(int((bits16(a) != bits16(b)).sum()) for a, b in zip(got, from_f32))
        name = f"K4-bf16 multilevel_roi_align_backward_bf16 {out}x{out} S={s}"
        emit("kernel", name=name, rois=n, shape=[B, image, image, C], sampling_ratio=s,
             max_abs_err=err, grad_max_abs=scale, atol=1e-5 * scale,
             rounded_sums_bits_differ=round_diff, bf16_cotangent_bits_differ=cot_diff)
        if not err <= 1e-5 * scale or round_diff or cot_diff:
            raise AssertionError(f"{name}: float32 sums {err} from the plain version (scale "
                                 f"{scale}), {round_diff} elements from the sums rounded, "
                                 f"{cot_diff} with the float32 cotangent")


def k3_train_line(levels, rois, bidx, out: int, strides) -> None:
    """K3-bf16 at the training step's shapes (``bf16_backward_kernel_row``'s
    levels and RoIs): its float32 output against its plain version within
    1e-4 of the scale, its bfloat16 output equal to the float32 one rounded;
    wrapper ms, device us and bound of each output, the plain version's ms.
    One phase line; raises on a disagreement."""
    import torch
    from pets_face_recognition_tpu_torch.kernel_ab import cuda_ms
    from pets_face_recognition_tpu_torch.ops import roi_align

    args = (levels, rois, bidx, (out, out), strides)
    got = roi_align.multilevel_roi_align_cuda(*args)
    got_b = roi_align.multilevel_roi_align_cuda(*args, out_dtype=torch.bfloat16)
    want = roi_align.multilevel_roi_align_bf16(*args)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err, tol = max_err(got, want), 1e-4 * scale
    del want
    rounded = bool(torch.equal(got_b.view(torch.int16), got.to(torch.bfloat16).view(torch.int16)))
    k3 = lambda: roi_align.multilevel_roi_align_cuda(*args)  # noqa: E731
    k3_b = lambda: roi_align.multilevel_roi_align_cuda(*args, out_dtype=torch.bfloat16)  # noqa
    plain = cuda_ms(lambda: roi_align.multilevel_roi_align_bf16(*args), warmup=1, iters=3)
    C = levels[0].shape[3]
    cells = touched_cells(levels, rois, bidx, (out, out), strides)
    n_in = cells * C * 2 + rois.numel() * 4 + bidx.numel() * 4
    n_flops = got.numel() * (6 * 4 + 1)
    b, by = bound_ms(n_in + got.numel() * 4, n_flops)
    b_b, by_b = bound_ms(n_in + got.numel() * 2, n_flops)
    emit("kernel", name=f"K3-bf16 multilevel_roi_align_bf16 {out}x{out} train",
         rois=rois.shape[0], shape=list(levels[0].shape), max_abs_err=err, atol=tol,
         value_scale=scale, bf16_out_is_float32_rounded=rounded, ms=cuda_ms(k3, iters=10),
         kernel_device_us=kernel_us(k3, "multilevel_roi_align_kernel", iters=5),
         bf16_out_ms=cuda_ms(k3_b, iters=10),
         bf16_out_kernel_device_us=kernel_us(k3_b, "multilevel_roi_align_kernel", iters=5),
         plain_ms=plain, library_ms=None, library="none (no torchvision)", bound_ms=b,
         bound_by=by, bf16_out_bound_ms=b_b, bf16_out_bound_by=by_b, touched_cells=cells)
    if not (err <= tol and rounded):
        raise AssertionError(f"K3-bf16 {out}x{out} train: {err} > {tol} or the bfloat16 "
                             f"output is not the float32 one rounded ({rounded})")


@contextlib.contextmanager
def carried_proposals(record: list, force: list | None = None):
    """``rcnn.generate_proposals`` while the block runs: each call's boxes
    and validity appended to ``record`` (host copies); or, with ``force``,
    each call answered with the next of ``force`` (a run on the other device
    takes the card's proposals over near-ties of bfloat16 logits) and the
    count of its own proposals that differ from them (by over 0.5 px, or in
    validity) appended to ``record``."""
    from pets_face_recognition_tpu_torch.models import rcnn

    real = rcnn.generate_proposals
    given = iter(force or ())

    def call(*args, **kw):
        boxes, valid = real(*args, **kw)
        if force is None:
            record.append((boxes.detach().cpu(), valid.cpu()))
            return boxes, valid
        fb, fv = next(given)
        moved = ((boxes.detach().cpu() - fb).abs().amax(-1) > 0.5) | (valid.cpu() != fv)
        record.append(int(moved.sum()))
        return fb.to(boxes.device), fv.to(valid.device)

    rcnn.generate_proposals = call
    try:
        yield record
    finally:
        rcnn.generate_proposals = real


def dist(a, b) -> float:
    """The L2 distance of two values or tensors, in float64 on the host."""
    import torch

    return float((torch.as_tensor(a).double().cpu() - torch.as_tensor(b).double().cpu()).norm())


def own_moves(draws: list[tuple]) -> dict:
    """bfloat16's own move on the CPU for each key: the largest over the
    draws of the distance of the CPU's bfloat16 value from the card's
    float32 one; ``draws`` holds ``(cpu, f32)`` dicts, one pair a draw."""
    return {k: max(dist(cpu[k], f32[k]) for cpu, f32 in draws) for k in draws[0][0]}


def own_move_ratio(card, cpu, move: float, floor: float) -> float:
    """``|card - cpu|`` over twice bfloat16's own move ``move`` (the CPU's,
    ``own_moves``: the card's bfloat16 value stays out of its own bound)
    plus ``floor`` of the CPU's magnitude and 1e-6 (float32 rounding where
    a value is 0 by construction): at most 1 passes. Norms for tensors."""
    import torch

    return dist(card, cpu) / (BF16_SPREAD_FACTOR * move + floor * float(
        torch.as_tensor(cpu).double().norm()) + 1e-6)


def jittered(x, seed: int):
    """``x`` (a tensor or a numpy array) with each value times 1 + u, u
    uniform in [-BF16_JITTER, BF16_JITTER] from ``seed``: another draw of
    bfloat16's rounding on the same input."""
    import numpy as np
    import torch

    u = np.random.RandomState(seed).uniform(-1, 1, tuple(x.shape)).astype(np.float32)
    if isinstance(x, np.ndarray):
        return (x * (1 + BF16_JITTER * u)).astype(np.float32)
    return x * (1 + BF16_JITTER * torch.from_numpy(u)).to(x.device)


@contextlib.contextmanager
def planted_fault(name: str, scale: float):
    """A planted card fault that a gate must reject: while the block runs,
    ``ops.roi_align.<name>`` (a kernel's wrapper) returns its result times
    ``scale``, every level of it."""
    from pets_face_recognition_tpu_torch.ops import roi_align

    real = getattr(roi_align, name)

    def faulty(*args, **kw):
        out = real(*args, **kw)
        return [o * scale for o in out] if isinstance(out, list) else out * scale

    setattr(roi_align, name, faulty)
    try:
        yield
    finally:
        setattr(roi_align, name, real)


# each gate of the card against the CPU in bfloat16 must reject its planted
# fault: K4's level gradients doubled in a step, K3's pooled values x 1.1 in
# an eval, the cotangent of the FE trunk's last stage doubled
K4_FAULT, K3_FAULT, FE_FAULT = 2.0, 1.1, 2.0


def bf16_step_vs_cpu(label: str, make_model, ctl, batch: dict, n_gt: int, dev,
                     seed: int) -> tuple[dict, list[str]]:
    """One training step of ``make_model(dtype)`` from one set of float32
    weights and one draw of sampler noise: in bfloat16 on the card and on the
    CPU, and in float32 on the card; the CPU and the float32 step take the
    card's bfloat16 proposals (``carried_proposals``: the CPU's own that
    differ are counted); on ``BF16_DRAWS`` jittered copies of the batch the
    CPU's bfloat16 step takes the card's float32 step's proposals. Each loss
    term and every gradient of the card within twice bfloat16's own move of
    the CPU's (``own_moves``) plus the float32 gates (``own_move_ratio``,
    ``BF16_STEP_FLOOR``); a gradient that is 0 on both sides passes. The gate must reject a planted fault: the card's bfloat16
    step again with K4's level gradients times ``K4_FAULT``. Returns the
    record (with the card's bfloat16 step's launch counts) and the
    failures."""
    import torch
    from pets_face_recognition_tpu_torch import kernels
    from pets_face_recognition_tpu_torch.weights import init_random_

    model32 = init_random_(make_model(torch.float32), seed)
    sd = model32.state_dict()
    B, image = batch["images"].shape[:2]
    n_anchors = model32.num_anchors * sum((-(-image // st)) ** 2 for st in (4, 8, 16, 32, 64))
    noise = model32.draw_sampler_noise(B, n_anchors, n_gt, torch.Generator().manual_seed(seed))
    del model32
    runs = {}
    # (name, dtype, device, batch, proposals recorded into, proposals forced from)
    plan = [("card", torch.bfloat16, dev, batch, "card", None),
            ("card_f32", torch.float32, dev, batch, None, "card"),
            ("cpu", torch.bfloat16, "cpu", batch, None, "card"),
            ("fault", torch.bfloat16, dev, batch, None, "card")]
    for r in range(1, BF16_DRAWS + 1):
        b = dict(batch, images=jittered(batch["images"], seed + r))
        plan += [(f"card_f32_{r}", torch.float32, dev, b, f"card_f32_{r}", None),
                 (f"cpu_{r}", torch.bfloat16, "cpu", b, None, f"card_f32_{r}")]
    proposals = {}
    for name, dtype, device, b, record, force in plan:
        model = make_model(dtype)
        model.load_state_dict(sd)
        state = ctl.init_state(0, device, model=model)
        moved = proposals.setdefault(record, []) if record else []
        kernels.reset_launch_counts()
        with carried_proposals(moved, proposals[force] if force else None), (
                planted_fault("multilevel_roi_align_backward_cuda", K4_FAULT)
                if name == "fault" else contextlib.nullcontext()):
            t = time.perf_counter()
            losses = ctl.train_step(state, b, sampler_noise=noise)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
        if name == "card":
            launches = {k: v for k, v in kernels.launch_counts().items() if v}
        runs[name] = (losses, {n: p.grad.detach().float().cpu()
                               for n, p in model.named_parameters()},
                      time.perf_counter() - t, moved)
        del state, model
    (l_g, g_g, t_g, _), (l_c, g_c, t_c, moved) = runs["card"], runs["cpu"]
    pairs = [(runs["cpu"], runs["card_f32"])] + [
        (runs[f"cpu_{r}"], runs[f"card_f32_{r}"]) for r in range(1, BF16_DRAWS + 1)]
    loss_move = own_moves([(c[0], f[0]) for c, f in pairs])
    grad_move = own_moves([(c[1], f[1]) for c, f in pairs])

    def ratios(losses, grads):
        return ({k: own_move_ratio(losses[k], l_c[k], loss_move[k], BF16_STEP_FLOOR["loss_rel"])
                 for k in l_c},
                {n: own_move_ratio(grads[n], g_c[n], grad_move[n],
                                   BF16_STEP_FLOOR["grad_rel_norm"])
                 for n in g_c if float(grads[n].abs().max()) or float(g_c[n].abs().max())})

    loss_ratio, grad_ratio = ratios(l_g, g_g)
    worst = max(grad_ratio, key=grad_ratio.get)
    fault_ratio = ratios(*runs["fault"][:2])[1]
    fault_worst = max(fault_ratio, key=fault_ratio.get)
    rec = dict(label=label, batch=int(B), image=int(image), losses_card=l_g, losses_cpu=l_c,
               losses_card_f32=runs["card_f32"][0], loss_own_move=loss_move,
               loss_ratio=loss_ratio, grad_ratio_max=grad_ratio[worst],
               grad_ratio_worst=worst,
               grad_ratio_median=statistics.median(grad_ratio.values()),
               grad_tensors=len(grad_ratio), cpu_proposals_moved=moved, card_launches=launches,
               planted_fault=dict(fault=f"K4 level gradients x {K4_FAULT}",
                                  grad_ratio_max=fault_ratio[fault_worst],
                                  grad_ratio_worst=fault_worst,
                                  tensors_rejected=sum(v > 1.0 for v in fault_ratio.values())),
               step_s_card=t_g, step_s_cpu=t_c)
    failures = [f"{label}: loss {k} {v} x the bound" for k, v in loss_ratio.items()
                if not v <= 1.0]
    if not grad_ratio[worst] <= 1.0:
        failures.append(f"{label}: gradient {worst} {grad_ratio[worst]} x the bound")
    if not fault_ratio[fault_worst] > 1.0:
        failures.append(f"{label}: the gate misses K4's gradients x {K4_FAULT}")
    return rec, failures


def bf16_full_steps(ctl, batch: dict, dev, kernels_mod) -> tuple[object, dict, dict]:
    """``BF16_TRAIN_STEPS`` full-width steps of ``ctl``'s model from seeded
    weights, its launch counts from 0 and its peak memory. Returns the state,
    the record and the launch counts; raises on a non-finite loss or launches other than
    ``BF16_TRAIN_LAUNCHES`` a step."""
    import torch

    state = ctl.init_state(seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launch_counts()
    steps = []
    with tf32_watch(state.model) as flags:
        for _ in range(BF16_TRAIN_STEPS):
            t = time.perf_counter()
            metrics = ctl.train_step(state, batch)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t, metrics))
    launches = kernels_mod.launch_counts()
    want = {k: v * BF16_TRAIN_STEPS for k, v in BF16_TRAIN_LAUNCHES.items()}
    rec = dict(steps=len(steps), warmup_steps=1,
               step_ms=statistics.median(t * 1e3 for t, _ in steps[1:]),
               step_ms_all=[t * 1e3 for t, _ in steps],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               losses=[m for _, m in steps], launches={k: v for k, v in launches.items() if v},
               tf32_flags=flags, parameters_dtype=sorted({str(p.dtype) for p in
                                                          state.model.parameters()}))
    bad = [i for i, (_, m) in enumerate(steps) if not all(math.isfinite(v) for v in m.values())]
    if bad:
        raise AssertionError(f"bf16_train: non-finite losses at steps {bad}")
    if rec["launches"] != want:
        raise AssertionError(f"bf16_train: launches {rec['launches']}, expected {want}")
    if rec["parameters_dtype"] != ["torch.float32"]:
        raise AssertionError(f"bf16_train: parameters {rec['parameters_dtype']}")
    return state, rec, launches


def bf16_train_phase(dev, kernels_mod, smi: str) -> dict[str, dict]:
    """Phase bf16_train: the keypoint R-CNN (B = 16 x 640 x 640) and the Mask
    R-CNN (B = 8 on the miniature's first batch) ResNet-50-FPN training steps
    of their configs with the model built at ``dtype=bfloat16`` (JAX's
    training bench: trunk, FPN, RPN and heads in bfloat16; losses,
    parameters and SGD in float32), 1 warm-up and 3 timed steps each: losses
    finite, launches a step K2 1, K3-bf16 2, K4-bf16 2, pre-pass 2, step ms
    and peak memory beside the float32 steps of ``train`` and ``mask_train``
    from the same run. Then a reduced step of each (B = 2 at 256 x 256, the
    budgets of ``train_vs_cpu``) on the card against the CPU
    (``bf16_step_vs_cpu``). Last, fault 2 on the bfloat16 keypoint step:
    the gradients that differ bitwise between two steps from one state, by
    default and under deterministic cuDNN, reported and not held."""
    from functools import partial

    import torch
    from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
    from pets_face_recognition_tpu_torch.engine.detector_controller import (
        DetectionController, KeyPointsController, keypoint_model, mask_model)
    from pets_face_recognition_tpu_torch.models.rcnn import (keypointrcnn_resnet50_fpn,
                                                             maskrcnn_resnet50_fpn)

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    paths, failures = {}, []
    kp_ctl = KeyPointsController(model_fn=partial(keypoint_model, "resnet50", bf16))
    kp_batch = synthetic_keypoint_batch(B_TRAIN, IMAGE_TRAIN, IMAGE_TRAIN, MAX_BOXES, seed=0)
    kp_state, kp_rec, paths["bf16_train_keypoint"] = bf16_full_steps(kp_ctl, kp_batch, dev,
                                                                     kernels_mod)
    f32_ms, f32_peak = F32_STEPS.get("train", (None, None))
    emit("bf16_train", model="keypointrcnn_resnet50_fpn", card=smi, batch=B_TRAIN,
         image=IMAGE_TRAIN, dtype="bfloat16", **kp_rec, float32_step_ms=f32_ms,
         float32_peak_mem_gib=f32_peak)
    repro_phase(kp_ctl, kp_state, kp_batch, B_TRAIN, phase="bf16_train_repro",
                modes=("default", "cudnn_deterministic"), rounds=0)
    del kp_state, kp_batch
    torch.cuda.empty_cache()
    m_ctl = DetectionController(model_fn=partial(mask_model, bf16))
    m_batch = mask_batch(B_MASK, IMAGE_TRAIN)
    m_state, m_rec, paths["bf16_train_mask"] = bf16_full_steps(m_ctl, m_batch, dev, kernels_mod)
    f32_ms, f32_peak = F32_STEPS.get("mask_train", (None, None))
    emit("bf16_train", model="maskrcnn_resnet50_fpn", card=smi, batch=B_MASK,
         image=IMAGE_TRAIN, dtype="bfloat16", **m_rec, float32_step_ms=f32_ms,
         float32_peak_mem_gib=f32_peak)
    del m_state, m_batch
    torch.cuda.empty_cache()

    budgets = dict(rpn_pre_nms_top_n_train=256, rpn_post_nms_top_n_train=128,
                   box_batch_size_per_image=16)
    for label, make, ctl, batch in (
            ("keypoint", lambda dt: keypointrcnn_resnet50_fpn(dtype=dt, **budgets),
             KeyPointsController(), synthetic_keypoint_batch(2, 256, 256, MAX_BOXES, seed=1)),
            ("mask", lambda dt: maskrcnn_resnet50_fpn(dtype=dt, **budgets),
             DetectionController(), mask_batch(2, 256))):
        rec, bad = bf16_step_vs_cpu(label, make, ctl, batch, MAX_BOXES, dev, 1)
        emit("bf16_train_vs_cpu", card=smi, budgets=budgets, **rec,
             tolerances=dict(within=f"{BF16_SPREAD_FACTOR} x bfloat16's own move on the CPU",
                             **BF16_STEP_FLOOR))
        failures += bad
    emit("bf16_train_done", seconds=time.perf_counter() - t0)
    if failures:
        raise AssertionError("; ".join(failures))
    torch.cuda.empty_cache()
    return paths


FE_DEFAULT_DTYPE = ""               # build_fe_config's own compute_dtype: "auto"


def bf16_fe_phase(dev, smi: str) -> dict[str, dict]:
    """Phase bf16_fe: the FE step through ``build_fe_config()``'s default
    (``compute_dtype="auto"``: bfloat16 on the card) over ``fe_fit``'s
    corpus, against the same config at ``compute_dtype="float32"``: the
    trunk's compute dtype of each, float32
    parameters, optimiser state and statistics, and ms a step at B = 64 x
    224 x 224 (1 warm-up, then 3 paired rounds of one step each) and peak
    memory of each. A reduced step (``fe_step_vs_cpu``'s shapes: B = 8 at 128
    x 128, 64 classes) in bfloat16 on the card and on the CPU, and in float32
    on the card: loss, gradients and running statistics within twice
    bfloat16's own move on the CPU (``own_moves``, over the batch and
    ``BF16_DRAWS`` jittered copies) plus the float32 gates, and the gate must
    reject a planted fault (the card's bfloat16 step again with the
    cotangent of the trunk's last stage doubled). Last, ``eval_fe`` on the
    card from a checkpoint of one bfloat16 step of the default config: a
    bfloat16 embedder, finite embeddings, float32 tensors in the checkpoint.
    FE training launches no hand-written kernel: the launches are read and
    must be 0."""
    import copy
    from functools import partial

    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch import eval_fe, kernels
    from pets_face_recognition_tpu_torch.engine.checkpoint import save_checkpoint
    from pets_face_recognition_tpu_torch.engine.controller import Controller
    from pets_face_recognition_tpu_torch.losses import SoftmaxBasedMetricLearning
    from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
    from pets_face_recognition_tpu_torch.utils import DictWrapper
    from pets_face_recognition_tpu_torch.utils.optim import fe_sgd_optimizer
    from pets_face_recognition_tpu_torch.weights import init_random_

    t0 = time.perf_counter()
    root = FE_OUT / "fit"
    cfg_path, config16 = fe_config(root, "bf16", 1, "sgd", FE_DEFAULT_DTYPE)
    _, config32 = fe_config(root, "f32", 1, "sgd")
    kernels.reset_launch_counts()
    rng = np.random.RandomState(4)
    batch = {"x": rng.rand(B_FE, CROP, CROP, 3).astype(np.float32),
             "label": rng.randint(0, config16.num_classes, B_FE), "index": np.arange(B_FE)}
    runs, dtypes = {}, {}
    for label, cfg in (("bf16", config16), ("f32", config32)):
        ctl = Controller(cfg)
        state = ctl.init_state(0, dev)
        ctl.train_step(state, batch)                    # warm-up
        model = state.model.model
        dtypes[label] = dict(
            trunk=str(model.conv1.compute_dtype), fc=str(model.fc.compute_dtype),
            tensors=sorted({str(t.dtype) for t in list(state.model.parameters())
                            + list(state.model.buffers())
                            + [v for s in state.optimizer.state.values() for v in s.values()
                               if torch.is_tensor(v)]}))
        runs[label] = (ctl, state)
    peak, step_ms = {}, {"bf16": [], "f32": []}
    for r in range(3):
        for label in (("f32", "bf16") if r % 2 == 0 else ("bf16", "f32")):
            ctl, state = runs[label]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            m = ctl.train_step(state, batch)            # floats: synchronised
            step_ms[label].append((time.perf_counter() - t) * 1e3)
            peak[label] = max(peak.get(label, 0.0), torch.cuda.max_memory_allocated() / 2 ** 30)
            if not math.isfinite(m["loss"]):
                raise AssertionError(f"bf16_fe: non-finite {label} loss {m}")
    del runs
    torch.cuda.empty_cache()

    # the reduced step, card and CPU in bfloat16, the card in float32
    B, image, C = 8, 128, 64
    rng = np.random.RandomState(2)
    small = {"x": rng.rand(B, image, image, 3).astype(np.float32),
             "label": rng.randint(0, C, B), "index": np.arange(B)}
    base = init_random_(SoftmaxBasedMetricLearning(resnet50_embedder(512), 512, C), 3)
    ctl = Controller(DictWrapper({"optimizer": lambda c: partial(fe_sgd_optimizer, lr=1e-2)}))
    out = {}

    def fe_fault(mod, inp, y):
        """The planted fault: the cotangent of the trunk's last stage scaled."""
        if y.requires_grad:
            y.register_hook(lambda g: g * FE_FAULT)

    plan = [("card", torch.bfloat16, dev, small), ("card_f32", torch.float32, dev, small),
            ("cpu", torch.bfloat16, "cpu", small), ("fault", torch.bfloat16, dev, small)]
    for r in range(1, BF16_DRAWS + 1):
        b = dict(small, x=jittered(small["x"], 2 + r))
        plan += [(f"card_f32_{r}", torch.float32, dev, b), (f"cpu_{r}", torch.bfloat16, "cpu", b)]
    for name, dtype, device, b in plan:
        model = SoftmaxBasedMetricLearning(resnet50_embedder(512, dtype=dtype), 512, C)
        model.load_state_dict(copy.deepcopy(base.state_dict()))
        state = ctl.init_state(0, device, model=model)
        hook = (model.model.layer4.register_forward_hook(fe_fault) if name == "fault"
                else None)
        t = time.perf_counter()
        m = ctl.train_step(state, b)
        out[name] = (m, {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                     {n: v.detach().cpu() for n, v in model.named_buffers()},
                     time.perf_counter() - t)
        if hook is not None:
            hook.remove()
    (m_g, g_g, s_g, t_g), (m_c, g_c, s_c, t_c) = out["card"], out["cpu"]
    pairs = [(out["cpu"], out["card_f32"])] + [
        (out[f"cpu_{r}"], out[f"card_f32_{r}"]) for r in range(1, BF16_DRAWS + 1)]
    m_32 = out["card_f32"][0]
    loss_move = own_moves([({"loss": c[0]["loss"]}, {"loss": f[0]["loss"]}) for c, f in pairs])
    grad_move, stat_move = (own_moves([(c[i], f[i]) for c, f in pairs]) for i in (1, 2))
    loss_ratio = own_move_ratio(m_g["loss"], m_c["loss"], loss_move["loss"],
                                BF16_STEP_FLOOR["loss_rel"])

    def grad_ratios(grads):
        return {n: own_move_ratio(grads[n], g_c[n], grad_move[n],
                                  BF16_STEP_FLOOR["grad_rel_norm"]) for n in g_c}

    grad_ratio, fault_ratio = grad_ratios(g_g), grad_ratios(out["fault"][1])
    stat_ratio = {n: own_move_ratio(s_g[n], s_c[n], stat_move[n],
                                    BF16_STEP_FLOOR["stats_rel_norm"]) for n in s_c}
    g_worst, s_worst = max(grad_ratio, key=grad_ratio.get), max(stat_ratio, key=stat_ratio.get)
    f_worst = max(fault_ratio, key=fault_ratio.get)

    # eval_fe on the card from a checkpoint of one bfloat16 step
    ctl16 = Controller(config16)
    state = ctl16.init_state(0, dev)
    ctl16.train_step(state, next(iter(config16.train_dataloader())))
    ckpt = save_checkpoint(root / "bf16" / "ckpt", state, 0)
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)["model"]
    ckpt_dtypes = sorted({str(v.dtype) for v in saved.values() if v.is_floating_point()})
    del state
    t = time.perf_counter()
    ectl, outputs = eval_fe.predict(cfg_path, ckpt, dev)
    eval_s = time.perf_counter() - t
    emb = np.concatenate([o["emb"] for o in outputs])
    eval_dtype = str(ectl.build_model(dev).model.conv1.compute_dtype)
    metrics = ectl.evaluate([outputs])["Val"]
    launches = kernels.launch_counts()
    emit("bf16_fe", card=smi, batch=B_FE, image=CROP, classes=config16.num_classes,
         compute_dtype=dtypes, step_ms=step_ms,
         step_ms_median={k: statistics.median(v) for k, v in step_ms.items()},
         peak_mem_gib=peak,
         step_vs_cpu=dict(batch=B, image=image, classes=C, loss_card=m_g["loss"],
                          loss_cpu=m_c["loss"], loss_card_f32=m_32["loss"],
                          loss_ratio=loss_ratio, grad_ratio_max=grad_ratio[g_worst],
                          grad_ratio_worst=g_worst,
                          grad_ratio_median=statistics.median(grad_ratio.values()),
                          stats_ratio_max=stat_ratio[s_worst], stats_ratio_worst=s_worst,
                          planted_fault=dict(
                              fault=f"the trunk's layer4 cotangent x {FE_FAULT}",
                              grad_ratio_max=fault_ratio[f_worst], grad_ratio_worst=f_worst,
                              tensors_rejected=sum(v > 1.0 for v in fault_ratio.values())),
                          train_acc=[m_g["train_acc"], m_c["train_acc"]],
                          step_s_card=t_g, step_s_cpu=t_c),
         eval_fe=dict(seconds=eval_s, embeddings=list(emb.shape),
                      finite=bool(np.isfinite(emb).all()), embedder_dtype=eval_dtype,
                      checkpoint_dtypes=ckpt_dtypes, metrics=metrics),
         launches={k: v for k, v in launches.items() if v},
         tolerances=dict(within=f"{BF16_SPREAD_FACTOR} x bfloat16's own move on the CPU",
                         **BF16_STEP_FLOOR), seconds=time.perf_counter() - t0)
    want_dtypes = {"bf16": "torch.bfloat16", "f32": "torch.float32"}
    if any(dtypes[k]["trunk"] != v or dtypes[k]["fc"] != "torch.float32"
           or dtypes[k]["tensors"] != ["torch.float32"] for k, v in want_dtypes.items()):
        raise AssertionError(f"bf16_fe: compute dtypes {dtypes}")
    if not (loss_ratio <= 1.0 and grad_ratio[g_worst] <= 1.0 and stat_ratio[s_worst] <= 1.0):
        raise AssertionError(f"bf16_fe: the card's bfloat16 step differs from the CPU's: loss "
                             f"{loss_ratio}, {g_worst} {grad_ratio[g_worst]}, {s_worst} "
                             f"{stat_ratio[s_worst]} x the bound")
    if not fault_ratio[f_worst] > 1.0:
        raise AssertionError(f"bf16_fe: the gate misses the trunk's cotangent x {FE_FAULT}")
    if eval_dtype != "torch.bfloat16" or ckpt_dtypes != ["torch.float32"] or not np.isfinite(
            emb).all():
        raise AssertionError(f"bf16_fe: eval_fe {eval_dtype}, checkpoint {ckpt_dtypes}")
    if any(launches.values()):
        raise AssertionError(f"bf16_fe launched a hand-written kernel: {launches}")
    torch.cuda.empty_cache()
    return {"bf16_fe": launches}


def int8_bf16_serve_phase(dev, kernels_mod, smi: str) -> dict[str, dict]:
    """Phase int8_bf16_serve: the bfloat16 service with the int8 twins at
    JAX's bench components (the keypoint head, and the trunk and RPN at scope
    ``rpn`` and the embedder trunk, as ``int8_serve`` quantizes them),
    calibrated in bfloat16 on 4 seeded batches, then one B = 32 batch served
    int8 through ``EmbeddingService`` at its default ``warp_dtype``: launches
    K1-bf16 1, K2 1, K3-bf16 2. Crops/s beside the bfloat16 float service in
    3 paired rounds, and the peak memory of one call of each. Then, at B = 2
    over the card's carried state: every ``QuantConv``'s int32 sums of its
    card input, computed on the card and on the CPU, bit-equal; the card
    against the CPU (both in bfloat16) within twice bfloat16's own move (the
    CPU's from the card's float32 int8 twin over the same state, the larger
    over the batch and ``BF16_DRAWS`` jittered copies), for the
    values behind each decision with the decisions forced to the CPU's
    (``heads_on``: the pyramid, the RPN logits, the box logits and heatmaps on
    the CPU's top boxes) and for the embeddings of shared crops; the gate
    must reject a planted fault (the card's heads again with K3's pooled
    values times ``K3_FAULT``). No speed is gated."""
    import torch
    from pets_face_recognition_tpu_torch.device import float32_matmuls
    from pets_face_recognition_tpu_torch.kernel_ab import similarity_landmarks
    from pets_face_recognition_tpu_torch.models import ptq
    from pets_face_recognition_tpu_torch.models.quant import int8_conv2d_acc, set_quant_mode
    from pets_face_recognition_tpu_torch.ops.homography import align_crop
    from pets_face_recognition_tpu_torch.serving import (MIN_LANDMARK_DISTANCE,
                                                         EmbeddingService, build_serving_models)

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    det, emb = int8_models(dev, bf16)
    fn_det, fn_emb = ptq.PTQModelFn(det, "calibrate"), ptq.PTQModelFn(emb, "calibrate")
    f_det, f_emb, base = build_serving_models(dev, 0, dtype=bf16)
    service_q = EmbeddingService(fn_det, fn_emb, base, device=dev, score_thr=0.0)
    service_f = EmbeddingService(f_det, f_emb, base, device=dev, score_thr=0.0)
    g = torch.Generator().manual_seed(37)
    with torch.inference_mode(), float32_matmuls():
        for _ in range(INT8_CALIB_BATCHES):
            x = torch.randint(0, 256, (B_TIMED, IMAGE, IMAGE, 3), generator=g,
                              dtype=torch.uint8).to(dev).float() / 255.0
            d = det.calibrate(x)
            kps = torch.round(d["keypoints"][:, 0, :, :2])
            crops = align_crop(x, kps, base, (CROP, CROP))
            keep = d["valid"][:, 0] & (torch.cdist(kps, kps) + torch.eye(3, device=dev)
                                       * 1e9).amin((1, 2)).gt(MIN_LANDMARK_DISTANCE)
            keep &= torch.isfinite(crops).flatten(1).all(1)
            if bool(keep.any()):
                emb.calibrate(crops[keep])
    fn_det.mode = fn_emb.mode = "int8"
    imgs = torch.randint(0, 256, (B_TIMED, IMAGE, IMAGE, 3), generator=g,
                         dtype=torch.uint8).to(dev)
    ok = torch.ones(B_TIMED, dtype=torch.bool, device=dev)
    service_q.embed_batch(imgs, ok)                   # warm-up
    torch.cuda.synchronize()
    kernels_mod.reset_launch_counts()
    e8, v8 = service_q.embed_batch(imgs, ok)
    torch.cuda.synchronize()
    launches = kernels_mod.launch_counts()

    def timed(service):
        t = time.perf_counter()
        service.embed_batch(imgs, ok)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    peak = {}
    for label, service in (("bf16", service_f), ("int8_bf16", service_q)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed(service)
        peak[label] = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = {"bf16": [], "int8_bf16": []}
    for r in range(3):
        for label in (("bf16", "int8_bf16") if r % 2 == 0 else ("int8_bf16", "bf16")):
            ms[label].append(timed(service_f if label == "bf16" else service_q))

    # B = 2 over the card's carried state: the card's float32 int8 twin, the
    # CPU's bfloat16 one
    state_det, state_emb = det.quant_numpy(), emb.quant_numpy()
    twins = {}
    for label, device, dtype in (("f32", dev, torch.float32), ("cpu", "cpu", bf16)):
        d_t, e_t = int8_models(device, dtype)
        d_t.load_quant(state_det)
        e_t.load_quant(state_emb)
        twins[label] = (set_quant_mode(d_t.model, "int8"), set_quant_mode(e_t.model, "int8"))
    x2 = imgs[:2].float() / 255.0
    xc = x2.cpu()
    with quant_records(det.model, "QuantConv") as rec_det, quant_records(
            emb.model, "QuantConv") as rec_emb:
        d_card = det.serve(x2)
        lms = similarity_landmarks(torch.Generator().manual_seed(2), 2, base.cpu(), IMAGE)
        crops_c = align_crop(xc, lms, base.cpu(), (CROP, CROP))
        emb.serve(crops_c.to(dev))
    sums, sums_differ = 0, 0
    for (name, _), (mod, inp) in list(rec_det.items()) + list(rec_emb.items()):
        xq = inp[0]
        a = int8_conv2d_acc(xq, mod.weight_q, mod.stride, mod.padding)
        b = int8_conv2d_acc(xq.cpu(), mod.weight_q.cpu(), mod.stride, mod.padding)
        sums += 1
        sums_differ += int((a.cpu() != b).sum())
    del rec_det, rec_emb

    def rel(a, b) -> float:
        return max_err(a.cpu(), b.cpu()) / float(b.float().abs().max())

    with torch.inference_mode(), float32_matmuls():
        d_cpu = twins["cpu"][0](xc)
        moved = moved_detections(d_card, d_cpu)
        boxes = d_cpu["boxes"][:, 0].contiguous()
        forced = {"card": heads_on(det.model, x2, boxes.to(dev)),
                  "cpu": heads_on(twins["cpu"][0], xc, boxes),
                  "f32": heads_on(twins["f32"][0], x2, boxes.to(dev))}
        with planted_fault("multilevel_roi_align_cuda", K3_FAULT):
            forced["fault"] = heads_on(det.model, x2, boxes.to(dev))
        forced["card"]["embedding_rel_err"] = emb.model(crops_c.to(dev))
        forced["cpu"]["embedding_rel_err"] = twins["cpu"][1](crops_c)
        forced["f32"]["embedding_rel_err"] = twins["f32"][1](crops_c.to(dev))
        # bfloat16's own move on the CPU, also over jittered copies
        draws = [(forced["cpu"], forced["f32"])]
        for r in range(1, BF16_DRAWS + 1):
            xr, cr = jittered(xc, 40 + r), jittered(crops_c, 50 + r)
            cpu_r = heads_on(twins["cpu"][0], xr, boxes)
            f32_r = heads_on(twins["f32"][0], xr.to(dev), boxes.to(dev))
            cpu_r["embedding_rel_err"] = twins["cpu"][1](cr)
            f32_r["embedding_rel_err"] = twins["f32"][1](cr.to(dev))
            draws.append((cpu_r, f32_r))
    checks = {k: rel(forced["card"][k], forced["cpu"][k]) for k in forced["cpu"]}
    spread = {k: max(rel(f[k], c[k]) for c, f in draws) for k in forced["cpu"]}
    fault = {k: rel(forced["fault"][k], forced["cpu"][k]) for k in forced["fault"]}
    rejected = [k for k, v in fault.items() if not v <= BF16_SPREAD_FACTOR * spread[k]]
    emit("int8_bf16_serve", card=smi, batch=B_TIMED, dtype="bfloat16", warp_dtype="bfloat16",
         components=dict(detector="trunk and RPN (scope rpn)", kp_head=True, embedder=True),
         launches={k: v for k, v in launches.items() if v},
         ms=ms, crops_per_s={k: B_TIMED * 1e3 / statistics.median(v) for k, v in ms.items()},
         peak_mem_gib=peak, rows_kept=int(v8.sum()),
         finite_kept=int((v8 & torch.isfinite(e8).all(1)).sum()),
         int32_sums=dict(convolutions=sums, elements_differ=sums_differ),
         card_vs_cpu=dict(batch=2, moved_decisions=sum(moved), moved=moved, **checks),
         tolerances=dict(within=f"{BF16_SPREAD_FACTOR} x bfloat16's own move on the CPU "
                         "from the card's float32 int8 twin", bfloat16_own_move=spread),
         planted_fault=dict(fault=f"K3 pooled values x {K3_FAULT}", card_vs_cpu=fault,
                            rejected_by=rejected),
         seconds=time.perf_counter() - t0)
    if {k: v for k, v in launches.items() if v} != BF16_SERVE_LAUNCHES:
        raise AssertionError(f"int8_bf16_serve launches {launches}, expected "
                             f"{BF16_SERVE_LAUNCHES}")
    if sums_differ:
        raise AssertionError(f"int8_bf16_serve: int32 sums differ card against CPU in "
                             f"{sums_differ} elements")
    for name, value in checks.items():
        if not value <= BF16_SPREAD_FACTOR * spread[name]:
            raise AssertionError(f"int8_bf16_serve {name} {value} > {BF16_SPREAD_FACTOR} x "
                                 f"bfloat16's own move {spread[name]}")
    if not rejected:
        raise AssertionError(f"int8_bf16_serve: the gate misses K3's values x {K3_FAULT}")
    del det, emb, f_det, f_emb, service_q, service_f, twins
    torch.cuda.empty_cache()
    return {"int8_bf16_serve": launches}


ALT_BF16 = (("swin_tiny_keypoint_rcnn", 224), ("convnext_tiny_keypoint_rcnn", 224))


def alt_bf16_phase(dev, kernels_mod, smi: str) -> dict[str, dict]:
    """Phase alt_bf16: the Swin-T and ConvNeXt-T keypoint R-CNNs built at
    ``dtype=bfloat16`` (the factories' trunk, FPN and model, as JAX's
    ``clone(dtype=...)``), full width, B = 2 at 224 x 224, the drive tool's
    small budgets, seeded weights: one eval forward on the card (launches K2
    1, K3-bf16 2) against the CPU's in bfloat16, the values behind each
    decision with the decisions forced to the CPU's (``heads_on``) within
    twice bfloat16's own move (the CPU's from the card's float32 model, over
    the input and ``BF16_DRAWS`` jittered copies), a
    planted fault rejected (K3's pooled values times ``K3_FAULT``); and one
    training step (launches a step as ``bf16_train``) against the CPU's
    (``bf16_step_vs_cpu``)."""
    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
    from pets_face_recognition_tpu_torch.device import float32_matmuls
    from pets_face_recognition_tpu_torch.drive_alt_factories import SMALL
    from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
    from pets_face_recognition_tpu_torch.models import rcnn
    from pets_face_recognition_tpu_torch.weights import init_random_

    paths, failures = {}, []
    for i, (name, size) in enumerate(ALT_BF16):
        t0 = time.perf_counter()

        def make(dtype, name=name):
            return getattr(rcnn, name)(dtype=dtype, **SMALL)

        sd = init_random_(make(torch.float32), 30 + i).state_dict()
        models = {}
        for label, dtype, device in (("card", torch.bfloat16, dev),
                                     ("f32", torch.float32, dev), ("cpu", torch.bfloat16, "cpu")):
            m = make(dtype)
            m.load_state_dict(sd)
            models[label] = m.eval().requires_grad_(False).to(device)
        x = torch.from_numpy(np.random.RandomState(40 + i).rand(2, size, size, 3)
                             .astype(np.float32))
        with torch.no_grad(), float32_matmuls():
            models["card"](x.to(dev))                       # warm-up
            torch.cuda.synchronize()
            kernels_mod.reset_launch_counts()
            t = time.perf_counter()
            d_card = models["card"](x.to(dev))
            torch.cuda.synchronize()
            eval_ms = (time.perf_counter() - t) * 1e3
            eval_launches = {k: v for k, v in kernels_mod.launch_counts().items() if v}
            d_cpu = models["cpu"](x)
            moved = moved_detections(d_card, d_cpu)
            boxes = d_cpu["boxes"][:, 0].contiguous()
            forced = {"card": heads_on(models["card"], x.to(dev), boxes.to(dev)),
                      "cpu": heads_on(models["cpu"], x, boxes),
                      "f32": heads_on(models["f32"], x.to(dev), boxes.to(dev))}
            with planted_fault("multilevel_roi_align_cuda", K3_FAULT):
                forced["fault"] = heads_on(models["card"], x.to(dev), boxes.to(dev))
            # bfloat16's own move on the CPU, also over jittered copies
            draws = [(forced["cpu"], forced["f32"])] + [
                (heads_on(models["cpu"], xr, boxes),
                 heads_on(models["f32"], xr.to(dev), boxes.to(dev)))
                for xr in (jittered(x, 40 + i + r) for r in range(1, BF16_DRAWS + 1))]

        def rel(a, b) -> float:
            return max_err(a.cpu(), b.cpu()) / float(b.float().abs().max())

        checks = {k: rel(forced["card"][k], forced["cpu"][k]) for k in forced["cpu"]}
        spread = {k: max(rel(f[k], c[k]) for c, f in draws) for k in forced["cpu"]}
        fault = {k: rel(forced["fault"][k], forced["cpu"][k]) for k in forced["cpu"]}
        rejected = [k for k, v in fault.items() if not v <= BF16_SPREAD_FACTOR * spread[k]]
        del models, forced, draws
        torch.cuda.empty_cache()
        ctl = KeyPointsController()
        batch = synthetic_keypoint_batch(2, size, size, 2, seed=50 + i)
        rec, bad = bf16_step_vs_cpu(name, make, ctl, batch, 2, dev, 60 + i)
        step_launches = rec["card_launches"]
        paths[f"alt_bf16_{name}"] = {k: eval_launches.get(k, 0) + step_launches.get(k, 0)
                                     for k in kernels_mod.KERNELS}
        emit("alt_bf16", factory=name, card=smi, image=size, batch=2, dtype="bfloat16",
             eval_ms=eval_ms, eval_launches=eval_launches,
             eval_vs_cpu=dict(moved_decisions=sum(moved), moved=moved, **checks),
             eval_own_move=spread, eval_planted_fault=dict(
                 fault=f"K3 pooled values x {K3_FAULT}", card_vs_cpu=fault,
                 rejected_by=rejected), step_launches=step_launches, step_vs_cpu=rec,
             tolerances=dict(within=f"{BF16_SPREAD_FACTOR} x bfloat16's own move on the CPU",
                             **BF16_STEP_FLOOR), seconds=time.perf_counter() - t0)
        if eval_launches != BF16_EVAL_LAUNCHES:
            failures.append(f"{name}: eval launches {eval_launches}, expected "
                            f"{BF16_EVAL_LAUNCHES}")
        if step_launches != BF16_TRAIN_LAUNCHES:
            failures.append(f"{name}: step launches {step_launches}, expected "
                            f"{BF16_TRAIN_LAUNCHES}")
        failures += [f"{name} eval {k} {v} > {BF16_SPREAD_FACTOR} x {spread[k]}"
                     for k, v in checks.items() if not v <= BF16_SPREAD_FACTOR * spread[k]]
        if not rejected:
            failures.append(f"{name}: the eval gate misses K3's values x {K3_FAULT}")
        failures += bad
    if failures:
        raise AssertionError("; ".join(failures))
    torch.cuda.empty_cache()
    return paths


KERNEL_ROWS = (
    ("warp_perspective_batch", ("warp_perspective_batch",), "csrc/warp.cu",
     "pets_face_recognition_tpu/ops/pallas_warp.py:152"),
    # K1's bfloat16 and int8 modes (JAX compute_dtype) and K3 on bfloat16
    # levels: their launches are the paths that serve in reduced precision
    ("warp_perspective_batch_bf16", ("warp_perspective_batch_bf16",), "csrc/warp.cu",
     "pets_face_recognition_tpu/ops/pallas_warp.py:152"),
    ("warp_perspective_batch_int8", ("warp_perspective_batch_int8",), "csrc/warp.cu",
     "pets_face_recognition_tpu/ops/pallas_warp.py:152"),
    ("multilevel_roi_align_bf16", ("multilevel_roi_align_bf16",), "csrc/roi_align.cu",
     "pets_face_recognition_tpu/ops/pallas_roi_align.py:120"),
    ("nms_keep_sorted_batch", ("nms_keep_sorted_batch",), "csrc/nms.cu",
     "pets_face_recognition_tpu/ops/pallas_nms.py:153"),
    ("multilevel_roi_align", ("multilevel_roi_align",), "csrc/roi_align.cu",
     "pets_face_recognition_tpu/ops/pallas_roi_align.py:120"),
    ("multilevel_roi_align_backward", ("multilevel_roi_align_backward",),
     "csrc/roi_align_backward.cu", "pets_face_recognition_tpu/ops/pallas_roi_align.py:362"),
    # K4 with bfloat16 operands: its launches are the bfloat16 training paths'
    ("multilevel_roi_align_backward_bf16", ("multilevel_roi_align_backward_bf16",),
     "csrc/roi_align_backward.cu", "pets_face_recognition_tpu/ops/pallas_roi_align.py:362"),
    # K4's pre-pass (sort keys and footprints), part of the same port of _roi_backward
    ("roi_footprints", ("roi_footprints",), "csrc/roi_align_backward.cu",
     "pets_face_recognition_tpu/ops/pallas_roi_align.py:362"),
    ("nms_keep_sorted_grid", ("nms_keep_sorted", "nms_keep_sorted_grid"), "csrc/nms.cu",
     "pets_face_recognition_tpu/ops/pallas_nms.py:75,191"),
    # the same kernels on the MobileNetV3 detector's 2-level pyramid (p4, p5);
    # their launches are the mobile paths' alone
    ("multilevel_roi_align_mobile", ("multilevel_roi_align",), "csrc/roi_align.cu",
     "pets_face_recognition_tpu/ops/pallas_roi_align.py:120"),
    ("multilevel_roi_align_backward_mobile", ("multilevel_roi_align_backward",),
     "csrc/roi_align_backward.cu", "pets_face_recognition_tpu/ops/pallas_roi_align.py:362"),
    ("roi_footprints_mobile", ("roi_footprints",), "csrc/roi_align_backward.cu",
     "pets_face_recognition_tpu/ops/pallas_roi_align.py:362"),
    # the same kernels on Mask R-CNN's paths, timed at its new shapes (K2 on
    # the box NMS's (8, 1000) groups, K3 on 24 mask RoIs at 14 x 14); their
    # launches are the Mask R-CNN paths' alone (MASK_PATHS; body_tsv and
    # prepare_tables also run the keypoint detector, whose launches they count)
    ("nms_keep_sorted_batch_mask", ("nms_keep_sorted_batch",), "csrc/nms.cu",
     "pets_face_recognition_tpu/ops/pallas_nms.py:153"),
    ("multilevel_roi_align_mask", ("multilevel_roi_align",), "csrc/roi_align.cu",
     "pets_face_recognition_tpu/ops/pallas_roi_align.py:120"),
    # K4 timed on Mask R-CNN's training gradient (the mask branch's dense
    # 14 x 14 one); its launches are the mask_train path's
    ("multilevel_roi_align_backward_masktrain", ("multilevel_roi_align_backward",),
     "csrc/roi_align_backward.cu", "pets_face_recognition_tpu/ops/pallas_roi_align.py:362"),
    # K3 and K4 at the Swin keypoint R-CNN's 448 x 448 training shapes; their
    # launches are the alternate families' paths (alt_rcnn)
    ("multilevel_roi_align_alt", ("multilevel_roi_align",), "csrc/roi_align.cu",
     "pets_face_recognition_tpu/ops/pallas_roi_align.py:120"),
    ("multilevel_roi_align_backward_alt", ("multilevel_roi_align_backward",),
     "csrc/roi_align_backward.cu", "pets_face_recognition_tpu/ops/pallas_roi_align.py:362"),
)


B_FE = 64                                   # FE config: train_batch_size
FE_CLASSES = 1000                           # the margin head's default width
# a world of one through the mesh path against the plain step from the same
# state, both under deterministic algorithms: equal bit for bit is expected
# (every collective of one rank is the identity); where a tensor is not, the
# gap is printed and held to twice the card's own move under 1e-7 input
# rounding (ROADMAP fault 2, note 9), at least 1e-6
DDP_ROUNDING = 1e-7
DDP_TOPK = dict(gallery=65536, dim=512, queries=128, k=100)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rel_gaps(a: dict, b: dict) -> dict[str, float]:
    """Each tensor's relative difference in norm, where it is not bit-equal."""
    import torch

    return {n: float((a[n].double() - b[n].double()).norm() / b[n].double().norm().clamp(
        min=1e-30)) for n in b if not torch.equal(a[n], b[n])}


def grads_of(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def step_pair(name: str, make_ctl, make_state, batch, rounded_batch, kernels_mod, mesh,
              expect: tuple[str, ...]) -> dict:
    """One step through ``make_ctl(mesh)`` and one through ``make_ctl(None)``
    from the same initial state, after a plain warm-up step, all under
    deterministic algorithms; the mesh step's launches (counts set to 0 just
    before it), its ms and the plain step's, and the gaps (see
    ``DDP_ROUNDING``)."""
    import torch

    out = {}
    with deterministic_algorithms():
        for label, m in (("warm-up", None), ("plain", None), ("mesh", mesh)):
            ctl = make_ctl(m)
            state = make_state(ctl)
            torch.cuda.synchronize()
            if label == "mesh":
                kernels_mod.reset_launch_counts()
            t = time.perf_counter()
            with tf32_watch(state.model) as flags:
                metrics = ctl.train_step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            if label == "warm-up":
                out[label] = dict(ms=ms)
                del state
                continue
            launches = kernels_mod.launch_counts() if label == "mesh" else None
            out[label] = dict(metrics=metrics, ms=ms, flags=flags, launches=launches,
                              grads=grads_of(state.model),
                              buffers={n: b.detach().clone()
                                       for n, b in state.model.named_buffers()})
            del state
        grad_gap = rel_gaps(out["mesh"]["grads"], out["plain"]["grads"])
        buf_gap = rel_gaps(out["mesh"]["buffers"], out["plain"]["buffers"])
        move = None
        if grad_gap or buf_gap or out["mesh"]["metrics"] != out["plain"]["metrics"]:
            ctl = make_ctl(None)
            state = make_state(ctl)
            ctl.train_step(state, rounded_batch)
            move = max(rel_gaps(grads_of(state.model), out["plain"]["grads"]).values(),
                       default=0.0)
            del state
    torch.cuda.empty_cache()
    launches = out["mesh"]["launches"]
    res = dict(loss_mesh=out["mesh"]["metrics"]["loss"], loss_plain=out["plain"]["metrics"]["loss"],
               bitwise_equal=not grad_gap and not buf_gap
               and out["mesh"]["metrics"] == out["plain"]["metrics"],
               grads=len(out["plain"]["grads"]), grads_differ=len(grad_gap),
               grad_gap_max=max(grad_gap.values(), default=0.0),
               buffers_differ=len(buf_gap), buffer_gap_max=max(buf_gap.values(), default=0.0),
               card_rounding_move=move, step_ms_warm_up=out["warm-up"]["ms"],
               step_ms_mesh=out["mesh"]["ms"], step_ms_plain=out["plain"]["ms"],
               launches=launches)
    if not all(math.isfinite(v) for v in out["mesh"]["metrics"].values()):
        raise AssertionError(f"{name}: non-finite loss {out['mesh']['metrics']}")
    if not res["bitwise_equal"]:
        bound = max(1e-6, 2 * move)
        loss_rel = abs(res["loss_mesh"] - res["loss_plain"]) / abs(res["loss_plain"])
        if max(res["grad_gap_max"], res["buffer_gap_max"], loss_rel) > bound:
            raise AssertionError(f"{name}: the mesh step differs from the plain one: {res}")
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels not launched on the mesh path: {missing}")
    return res


def ddp_phase(dev, kernels_mod, smi: str) -> dict[str, dict]:
    """Phase ddp: ``init_distributed`` over NCCL from the env names
    (``COORDINATOR_ADDRESS=localhost:<free port>``, ``NUM_PROCESSES=1``,
    ``PROCESS_ID=0``), a world of one; then at full width through the mesh
    path, each against the plain path from the same state: an FE step (B =
    64 x 224), a keypoint R-CNN step (B = 16 x 640), a Mask R-CNN step (B =
    8 x 640), ``EmbeddingService(mesh=...)`` at B = 32, and
    ``sharded_topk_scores`` over a 65536 x 512 gallery against ``topk_rows``.
    Returns each path's launch counts."""
    import copy
    import shutil
    from functools import partial

    import numpy as np
    import torch
    import torch.distributed as dist
    from pets_face_recognition_tpu_torch import parallel, retrieval
    from pets_face_recognition_tpu_torch.data import synthetic_keypoint_batch
    from pets_face_recognition_tpu_torch.engine.controller import Controller
    from pets_face_recognition_tpu_torch.engine.detector_controller import (DetectionController,
                                                                            KeyPointsController)
    from pets_face_recognition_tpu_torch.losses import SoftmaxBasedMetricLearning
    from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
    from pets_face_recognition_tpu_torch.serving import EmbeddingService, build_serving_models
    from pets_face_recognition_tpu_torch.utils import DictWrapper
    from pets_face_recognition_tpu_torch.utils.optim import fe_sgd_optimizer
    from pets_face_recognition_tpu_torch.weights import init_random_

    env = dict(COORDINATOR_ADDRESS=f"localhost:{free_port()}", NUM_PROCESSES="1", PROCESS_ID="0")
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    t = time.perf_counter()
    try:
        grouped = parallel.init_distributed(device=dev)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    init_s = time.perf_counter() - t
    info = parallel.device_info()
    if not grouped or dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"init_distributed: group {grouped}, backend "
                             f"{dist.get_backend() if grouped else None}")
    if (info["process_count"], info["global_device_count"], info["platform"]) != (1, 1, "gpu"):
        raise AssertionError(f"device_info {info}")
    mesh = parallel.create_mesh(device=dev)
    paths, res = {}, {}
    try:
        def rounded(batch, key):
            x = batch[key]
            return dict(batch, **{key: (x * (1 + np.random.RandomState(1).randn(*x.shape)
                                             * DDP_ROUNDING)).astype(np.float32)})

        # the FE step
        rng = np.random.RandomState(5)
        fe = {"x": rng.rand(B_FE, CROP, CROP, 3).astype(np.float32),
              "label": rng.randint(0, FE_CLASSES, B_FE), "index": np.arange(B_FE)}
        fe_model = init_random_(SoftmaxBasedMetricLearning(resnet50_embedder(512), 512,
                                                           FE_CLASSES), 3)
        fe_cfg = DictWrapper({"optimizer": lambda c: partial(fe_sgd_optimizer, lr=1e-2)})
        res["fe"] = step_pair(
            "ddp fe", lambda m: Controller(fe_cfg, mesh=m),
            lambda ctl: ctl.init_state(0, dev, model=copy.deepcopy(fe_model)), fe,
            rounded(fe, "x"), kernels_mod, mesh, ())
        paths["ddp_fe"] = res["fe"].pop("launches")
        del fe_model

        # the keypoint and Mask R-CNN steps: noise from each step's generator
        kp = synthetic_keypoint_batch(B_TRAIN, IMAGE_TRAIN, IMAGE_TRAIN, MAX_BOXES, seed=0)
        det_kernels = ("nms_keep_sorted_batch", "multilevel_roi_align", "roi_footprints",
                       "multilevel_roi_align_backward")
        res["keypoint"] = step_pair(
            "ddp keypoint", lambda m: KeyPointsController(arch="resnet50", mesh=m),
            lambda ctl: ctl.init_state(seed=0, device=dev), kp, rounded(kp, "images"),
            kernels_mod, mesh, det_kernels)
        paths["ddp_keypoint"] = res["keypoint"].pop("launches")
        mask = mask_batch(B_MASK, IMAGE_TRAIN)
        res["mask"] = step_pair(
            "ddp mask", lambda m: DetectionController(mesh=m),
            lambda ctl: ctl.init_state(seed=0, device=dev), mask, rounded(mask, "images"),
            kernels_mod, mesh, det_kernels)
        paths["ddp_mask"] = res["mask"].pop("launches")

        # batch-sharded serving
        detector, embedder, base = build_serving_models(device=dev, seed=0)
        g = torch.Generator().manual_seed(6)
        imgs = torch.randint(0, 256, (B_TIMED, IMAGE, IMAGE, 3), generator=g,
                             dtype=torch.uint8).to(dev)
        ok = torch.ones(B_TIMED, dtype=torch.bool, device=dev)
        # threshold 0 as in the chain's checks: random weights score below 0.9
        plain = EmbeddingService(detector, embedder, base, score_thr=0.0, device=dev,
                                 batch_size=B_TIMED, warp_dtype=torch.float32)
        served = EmbeddingService(detector, embedder, base, score_thr=0.0, device=dev,
                                  batch_size=B_TIMED, mesh=mesh, warp_dtype=torch.float32)
        want_emb, want_valid = plain.embed_batch(imgs, ok)
        kernels_mod.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        emb, valid = served.embed_batch(imgs, ok)
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t) * 1e3
        paths["ddp_serve"] = kernels_mod.launch_counts()
        # random landmarks can be collinear yet 5 px apart, which the
        # reference's rule lets through: their crop, and so their row, is NaN
        # on both paths, valid or not; NaN must meet NaN, and the finite
        # values are compared
        nan = want_emb.isnan()
        finite = ~nan
        gap = float((emb[finite] - want_emb[finite]).abs().max()) if finite.any() else 0.0
        res["serve"] = dict(batch=B_TIMED, score_thr=0.0,
                            bitwise_equal=bool(torch.equal(nan, emb.isnan()) and gap == 0.0),
                            emb_gap_max=gap, nan_rows=int(nan.any(1).sum()),
                            nan_valid_rows=int((nan.any(1) & want_valid).sum()),
                            valid_equal=bool(torch.equal(valid, want_valid)),
                            valid=int(valid.sum()), ms=serve_ms)
        scale = float(want_emb[finite].abs().max()) if finite.any() else 1.0
        if (not res["serve"]["valid_equal"] or not torch.equal(nan, emb.isnan())
                or not gap <= 1e-5 * scale):
            raise AssertionError(f"ddp serve: the mesh service differs: {res['serve']}")
        missing = [k for k in ("warp_perspective_batch", "nms_keep_sorted_batch",
                               "multilevel_roi_align") if paths["ddp_serve"][k] == 0]
        if missing:
            raise AssertionError(f"ddp serve: kernels not launched: {missing}")
        del detector, embedder, plain, served

        # the sharded top-k against topk_rows
        c = DDP_TOPK
        rng = np.random.RandomState(8)
        gal = rng.randn(c["gallery"], c["dim"]).astype(np.float32)
        gal /= np.linalg.norm(gal, axis=1, keepdims=True)
        q = gal[rng.choice(c["gallery"], c["queries"], replace=False)] + rng.randn(
            c["queries"], c["dim"]).astype(np.float32) * 0.05
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        retrieval.sharded_topk_scores(q, gal, c["k"], mesh)          # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        top_s, top_i = retrieval.sharded_topk_scores(q, gal, c["k"], mesh)
        topk_ms = (time.perf_counter() - t) * 1e3
        scores = retrieval.pairwise_card_scores(q, gal, dev)
        names = [str(i) for i in range(c["gallery"])]
        rows = retrieval.topk_rows(scores, np.ones_like(scores, bool), names, c["k"])
        want_i = np.array([[int(x) for x in r[3].split(",")] for r in rows])
        want_s = np.take_along_axis(scores, want_i, 1)
        res["topk"] = dict(c, ms=topk_ms, indices_equal=bool((top_i == want_i).all()),
                           score_gap_max=float(np.abs(top_s - want_s).max()))
        if not res["topk"]["indices_equal"] or res["topk"]["score_gap_max"] > 1e-6:
            raise AssertionError(f"ddp topk: {res['topk']}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(MASK_TRAIN_OUT, ignore_errors=True)
        torch.cuda.empty_cache()
    emit("ddp", card=smi, backend="nccl", world=1, init_s=init_s, device_info=info,
         deterministic_algorithms=True, **res, launches=paths,
         precision="float32: TF32 off inside the entry points")
    return paths


def tuners_phase(dev, smi: str) -> None:
    """Phase tuners: ``find_max_batch_size`` on the full-width FE step (224 x
    224, from 16 doubling, 8 trials: the largest batch that fits, the peak
    memory, what is allocated after) and a 20-step ``find_optimal_init_lr`` at
    B = 16; the card's memory freed after both."""
    import gc
    from functools import partial

    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch.engine.controller import Controller
    from pets_face_recognition_tpu_torch.losses import SoftmaxBasedMetricLearning
    from pets_face_recognition_tpu_torch.models.embedder import resnet50_embedder
    from pets_face_recognition_tpu_torch.utils import DictWrapper, tuners
    from pets_face_recognition_tpu_torch.utils.optim import fe_sgd_optimizer

    cfg = DictWrapper({"model": lambda device: resnet50_embedder(512),
                       "loss": lambda c, m: SoftmaxBasedMetricLearning(m, 512, FE_CLASSES),
                       "optimizer": lambda c: partial(fe_sgd_optimizer, lr=1e-2)})
    ctl = Controller(cfg)
    rng = np.random.RandomState(9)
    sample = {"x": rng.rand(1, CROP, CROP, 3).astype(np.float32), "label": np.array([3]),
              "index": np.array([0])}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    best = tuners.find_max_batch_size(ctl, sample, device=dev)
    search_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    after_search = torch.cuda.memory_allocated()
    batches = [{"x": rng.rand(16, CROP, CROP, 3).astype(np.float32),
                "label": rng.randint(0, FE_CLASSES, 16), "index": np.arange(16)}
               for _ in range(4)]
    history = []

    class Recording(Controller):
        """Each sweep step's rate and loss."""

        def train_step(self, state, batch):
            metrics = super().train_step(state, batch)
            history.append((state.optimizer.param_groups[0]["lr"], metrics["loss"]))
            return metrics

    t = time.perf_counter()
    lr = tuners.find_optimal_init_lr(Recording(cfg), batches, num_steps=20, device=dev)
    lr_s = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    emit("tuners", card=smi, image=CROP, classes=FE_CLASSES, start=16, max_trials=8,
         max_batch=best, search_s=search_s, peak_mem_gib=peak / 2 ** 30,
         allocated_before_gib=base / 2 ** 30, allocated_after_search_gib=after_search / 2 ** 30,
         lr=lr, lr_steps=len(history), lr_history=history, lr_search_s=lr_s,
         allocated_after_gib=after / 2 ** 30)
    if best < B_FE or len(history) < 5 or not any(
            abs(lr - rate / 10) <= 1e-12 * rate for rate, _ in history):
        raise AssertionError(f"tuners: max batch {best}, lr {lr}, {len(history)} steps")
    if after_search > base + 2 ** 28 or after > base + 2 ** 28:
        raise AssertionError(f"tuners: {after_search - base} / {after - base} bytes left "
                             "allocated after the searches")


DOG_OUT = REPO / "smoke_out" / "dog_fixture"    # git-ignored; deleted after the phase


def dog_tables(root: Path, seed: int) -> tuple[list, list]:
    """Seeded ``paths`` / ``others`` tables over the photos of ``root/data_25``
    (Windows separators in half the paths, one or two boxes a photo)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    photos = sorted(p.relative_to(root / "data_25") for p in (root / "data_25").rglob("*.jpg"))
    paths, others = [], []
    for i, rel in enumerate(photos):
        paths.append(str(rel).replace("/", "\\") if i % 2 else str(rel))
        n = 1 + i % 2
        x1, y1 = rng.uniform(0, 200, (2, n))
        w, h = rng.uniform(40, 110, (2, n))
        boxes = np.stack([x1, y1, x1 + w, y1 + h], 1).round().astype(int)
        kps = np.stack([x1[:, None] + rng.uniform(0.1, 0.9, (n, 3)) * w[:, None],
                        y1[:, None] + rng.uniform(0.1, 0.9, (n, 3)) * h[:, None],
                        np.ones((n, 3))], -1)
        others.append({"boxes": boxes.tolist(), "labels": [0] * n, "keypoints": kps.tolist()})
    return paths, others


def dog_fixture_phase(dev, kernels_mod, smi: str) -> dict:
    """Phase dog_fixture: the keypoint config with seeded dog pickles over
    ``smoke_data.make_data25`` photos beside the committed CAT miniature, at
    the recipe's B = 16 x 640: the loader's first batch (no worker threads)
    equal to a second read of a config built alike on the CPU, and one step
    on it on the card; then one step on a batch of the dog items alone. Both
    losses finite. Returns the path's launch counts."""
    import pickle
    import shutil

    import numpy as np
    import torch
    from pets_face_recognition_tpu_torch.config_presets import build_keypoint_config
    from pets_face_recognition_tpu_torch.data_loading import ConcatDataset, SimpleDataset
    from pets_face_recognition_tpu_torch.engine.detector_controller import KeyPointsController
    from pets_face_recognition_tpu_torch.smoke_data import make_data25
    from pets_face_recognition_tpu_torch.utils import DictWrapper
    from pets_face_recognition_tpu_torch.utils.collate import DetectionCollate

    shutil.rmtree(DOG_OUT, ignore_errors=True)
    DOG_OUT.mkdir(parents=True)
    try:
        (DOG_OUT / "CAT_DATASET").symlink_to(
            REPO / "pets_face_recognition_tpu_torch" / "testdata" / "CAT_DATASET",
            target_is_directory=True)
        make_data25(DOG_OUT, n_cards=8, n_imgs=4)
        for suffix, seed in (("", 1), ("2", 2)):
            paths, others = dog_tables(DOG_OUT, seed)
            (DOG_OUT / f"paths{suffix}.pickle").write_bytes(pickle.dumps(paths))
            (DOG_OUT / f"others{suffix}.pickle").write_bytes(pickle.dumps(others))

        def config(name):
            return DictWrapper(build_keypoint_config(data_root=str(DOG_OUT), fixtures_dir=str(DOG_OUT),
                                         train_batch_size=B_TRAIN,
                                         image_size=(IMAGE_TRAIN, IMAGE_TRAIN),
                                         max_boxes=MAX_BOXES, num_workers=0,
                                         output=str(DOG_OUT / name)))

        cfg = config("card")
        train = cfg["train_dataloader"]()
        ds = train.dataset
        if not (isinstance(ds, ConcatDataset) and len(ds.datasets) == 3
                and all(isinstance(d, SimpleDataset) for d in ds.datasets[1:])):
            raise AssertionError(f"dog fixtures not concatenated: {type(ds)}")
        t = time.perf_counter()
        batch = next(iter(train))
        read_s = time.perf_counter() - t
        again = next(iter(config("cpu")["train_dataloader"]()))
        same = sorted(batch) == sorted(again) and all(
            np.array_equal(np.asarray(batch[k]), np.asarray(again[k])) for k in batch)
        dog_items = [ds.datasets[1][i] for i in range(B_TRAIN)]
        dog_batch = DetectionCollate((IMAGE_TRAIN, IMAGE_TRAIN), max_boxes=MAX_BOXES,
                                     num_keypoints=3)(dog_items)
        ctl = KeyPointsController(config=cfg)
        state = ctl.init_state(seed=0, device=dev)
        kernels_mod.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses = ctl.train_step(state, batch)
        dog_losses = ctl.train_step(state, dog_batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        launches = kernels_mod.launch_counts()
        del state
    finally:
        shutil.rmtree(DOG_OUT, ignore_errors=True)
        torch.cuda.empty_cache()
    emit("dog_fixture", card=smi, parts=[len(d) for d in ds.datasets], batch=B_TRAIN,
         image=IMAGE_TRAIN, images_shape=list(np.asarray(batch["images"]).shape),
         batch_equal_cpu_read=same, read_s=read_s, losses=losses, dog_losses=dog_losses,
         dog_valid_boxes=int(np.asarray(dog_batch["valid"]).sum()), steps_s=step_s,
         launches=launches)
    if not same:
        raise AssertionError("dog_fixture: the loader's batch differs from the CPU's read")
    if not all(math.isfinite(v) for v in (*losses.values(), *dog_losses.values())):
        raise AssertionError(f"dog_fixture: non-finite losses {losses} {dog_losses}")
    missing = [k for k in ("nms_keep_sorted_batch", "multilevel_roi_align",
                           "multilevel_roi_align_backward") if launches[k] == 0]
    if missing:
        raise AssertionError(f"dog_fixture: kernels not launched: {missing}")
    return launches


QUALITY_OUT = REPO / "smoke_out" / "quality"   # git-ignored; deleted after the phase
# the hard corpus cut in depth only (the generator's defaults are 120
# identities in 12 clusters, 180 distractors, 3 photos a card: 1272 photos);
# every model runs at full width
QUALITY_CORPUS = dict(n_ids=16, n_clusters=4, n_distractors=24, n_imgs=2)
QUALITY_RECAL_REL = 1e-4     # card against CPU, of each statistic tensor's largest magnitude
MOBILE_SMOKE = REPO / "pets_face_recognition_tpu_torch" / "configs" / "keypoint_mobile_smoke.py"


def quality_checkpoints(dev, work: Path) -> dict[str, str]:
    """The instrument's checkpoint variables: the seeded ResNet-50-FPN
    keypoint R-CNN (``serving.serving_detector``'s weights) and a seeded Mask
    R-CNN saved as port checkpoints, the centred head embedders
    (``centred_embedder_ckpts``), the body embedders' variables set empty
    (explicit, naming none: seeded weights) and the threshold at 0."""
    import torch
    from pets_face_recognition_tpu_torch.models.rcnn import maskrcnn_resnet50_fpn
    from pets_face_recognition_tpu_torch.serving import serving_detector
    from pets_face_recognition_tpu_torch.weights import init_random_

    env = dict(PFR_RETRIEVAL_THR="0.0", PFR_DOG_BODY_FE_CKPT="", PFR_CAT_BODY_FE_CKPT="")
    for var, name, model in (
            ("PFR_KEYPOINT_CKPT", "keypoint", serving_detector("cpu", 0)),
            ("PFR_MASK_CKPT", "mask", init_random_(maskrcnn_resnet50_fpn(
                num_classes=2, box_detections_per_img=3), 3))):
        folder = work / name
        folder.mkdir(parents=True)
        torch.save({"model": model.state_dict()}, folder / "epoch=0-step=0")
        env[var] = str(folder)
    env.update(centred_embedder_ckpts(dev, work / "fe"))
    return env


def quality_subprocess_env() -> dict[str, str]:
    """The environment without any ``PFR_*`` variable, the checkout on the path."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PFR_")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH"))
                                        if p)
    return env


def recalibration_check(ckpt_dir: Path) -> dict:
    """``recalibrate_bn``'s sibling of the fit's ``epoch=0-step=8`` against the
    source and against the same 24 passes on the CPU
    (``recalibrate_bn.recalibrated_stats``)."""
    import torch
    from pets_face_recognition_tpu_torch import recalibrate_bn
    from pets_face_recognition_tpu_torch.engine.checkpoint import (latest_checkpoint,
                                                                   load_checkpoint)

    src = ckpt_dir / "epoch=0-step=8"
    sibling = ckpt_dir / "epoch=0-step=9"
    old, new = load_checkpoint(src)["model"], load_checkpoint(sibling)["model"]
    stats = [k for k in new if k.endswith(recalibrate_bn.STATS)]
    t = time.perf_counter()
    cpu = recalibrate_bn.recalibrated_stats(old, recalibrate_bn.DEFAULT_DATA, device="cpu")
    cpu_s = time.perf_counter() - t
    rel = {k: ((new[k] - cpu[k]).abs().max() / cpu[k].abs().max().clamp_min(1e-30)).item()
           for k in stats}
    worst = max(rel, key=rel.get)
    return dict(sibling=sibling.name, latest=latest_checkpoint(ckpt_dir).name,
                n_stats=len(stats), same_keys=set(new) == set(old),
                params_equal=all(torch.equal(new[k], old[k]) for k in old if k not in stats),
                finite=all(bool(torch.isfinite(new[k]).all()) for k in stats),
                moved=sum(not torch.equal(new[k], old[k]) for k in stats),
                worst_rel_vs_cpu=rel[worst], worst_stat=worst, cpu_s=cpu_s,
                gate=QUALITY_RECAL_REL)


def quant_entries(path: Path) -> set[tuple[str, str]]:
    """``(model, buffer)`` of a calibrated quant state file."""
    import pickle

    with open(path, "rb") as f:
        return {(m, k) for m, d in pickle.load(f).items() for k in d}


def quality_phase(dev, kernels_mod, smi: str) -> dict:
    """Phase quality: the quality instrument over the hard corpus on the card.
    ``smoke_data.make_kashtanka_hard`` at ``QUALITY_CORPUS`` (16 identities in
    4 clusters, 24 distractors, 2 photos a card: 120 photos of 320 x 320;
    the generator's defaults give 1272, so the cut is depth only and every
    model runs at full width); the checkpoints of ``quality_checkpoints``;
    ``main_keypoints`` on ``configs/keypoint_mobile_smoke.py`` (one epoch, 8
    steps of B = 4) in a subprocess, then ``recalibrate_bn`` at its defaults
    on its checkpoint. ``quality_instrument`` runs in concurrent
    subprocesses at ``PFR_RETRIEVAL_THR=0``: ``float_resnet50_f32`` with
    ``float_resnet50_bf16in``, ``int8ship_resnet50_f32``,
    ``int8_resnet50_f32``, ``--ensemble`` ``float_resnet50_f32`` (the seeded
    Mask R-CNN under ``PFR_MASK_CKPT``), and once the fit is recalibrated
    ``float_mobile_f32`` (``--mobile-ckpt``); ``diff_tsv_ranks`` of the float
    tsv against itself and against the int8ship one. One float pass also
    runs in this process through ``generate_tsv.main``, its launch counts
    read around it, before the subprocesses start (the mobile fit beside
    it). Gates: every subprocess exits 0; each table has its rows, 16
    queries, candR@1 <= @10 <= @100 in [0, 1]; the two int8 rows' quant
    states differ in exactly the detector's trunk and RPN entries (scope
    ``rpn``; pinned components, not inherited); the float tsv against itself
    ``RANK-SAFE``; the in-process pass's detector holds the checkpoint's
    ``state_dict`` at 1000 / 1000 proposals and launches K1, K2 and K3; the
    fit's checkpoint exists, and its sibling ``epoch=0-step=9`` is the one
    ``latest_checkpoint`` picks, with the parameters bit-equal, every running
    statistic finite, at least one moved, and each within
    ``QUALITY_RECAL_REL`` (1e-4) of the same 24 passes on the CPU, relative
    to the tensor's largest magnitude. The float against the int8ship tsv is
    reported, not gated: random weights cannot certify ranks. Returns the
    in-process pass's launch counts."""
    import json as _json
    import shutil
    from unittest import mock

    import torch
    from pets_face_recognition_tpu_torch import generate_tsv, smoke_data
    from pets_face_recognition_tpu_torch.engine.checkpoint import load_params
    from pets_face_recognition_tpu_torch.quality_instrument import photo_count

    t0 = time.perf_counter()
    shutil.rmtree(QUALITY_OUT, ignore_errors=True)
    (QUALITY_OUT / "mobile").mkdir(parents=True)
    base = quality_subprocess_env()
    procs, runs = {}, {}
    try:
        with contextlib.ExitStack() as stack:
            def start(label, args, cwd=QUALITY_OUT, env=None):
                procs[label] = stack.enter_context(background(
                    [sys.executable, "-m", *args], cwd, env or base))

            def finish(label):
                proc, seconds = procs.pop(label)()
                runs[label] = dict(rc=proc.returncode, seconds=seconds,
                                   stderr_tail=proc.stderr[-1500:] if proc.returncode else "")
                return proc

            start("mobile_fit", ["pets_face_recognition_tpu_torch.main_keypoints", "--config",
                                 str(MOBILE_SMOKE), "--device", dev.type], QUALITY_OUT / "mobile")
            data = smoke_data.make_kashtanka_hard(QUALITY_OUT / "corpus", **QUALITY_CORPUS)
            gt = QUALITY_OUT / "corpus" / "hard_gt.json"
            photos = photo_count(data)
            pfr = quality_checkpoints(dev, QUALITY_OUT / "ckpt")
            env = dict(base, **pfr)

            # one float pass in this process, counted
            built = []
            real_build = generate_tsv.build_retrieval_models

            def build(*args, **kw):
                built.append(real_build(*args, **kw))
                return built[-1]

            tsv_here = QUALITY_OUT / "inprocess.tsv"
            with mock.patch.dict(os.environ, pfr), mock.patch.object(
                    generate_tsv, "build_retrieval_models", build):
                for k in [k for k in os.environ if k.startswith("PFR_") and k not in pfr]:
                    del os.environ[k]
                torch.cuda.synchronize()
                kernels_mod.reset_launch_counts()
                t = time.perf_counter()
                rc_here = generate_tsv.main(["--data", str(data), "--output", str(tsv_here),
                                             "--stock-preds", str(QUALITY_OUT / "none.tsv"),
                                             "--device", str(dev)])
                torch.cuda.synchronize()
                float_s = time.perf_counter() - t
                launches = kernels_mod.launch_counts()
            det = built[0][0]
            want = load_params(Path(pfr["PFR_KEYPOINT_CKPT"]) / "epoch=0-step=0")
            got = det.state_dict()
            inprocess = dict(rc=rc_here, seconds=float_s, photos_per_s=photos / float_s,
                             same_state_dict=set(got) == set(want) and all(
                                 torch.equal(got[k].cpu(), v) for k, v in want.items()),
                             budgets=[det.cfg.rpn_pre_nms_top_n_test,
                                      det.cfg.rpn_post_nms_top_n_test,
                                      det.cfg.box_detections_per_img],
                             launches=launches, beside="the mobile fit's subprocess")
            del built, det, got
            torch.cuda.empty_cache()

            def instrument(label, *args):
                start(label, ["pets_face_recognition_tpu_torch.quality_instrument", "--data",
                              str(data), "--gt", str(gt), "--out", str(QUALITY_OUT / label),
                              "--device", dev.type, *args], env=env)

            instrument("float", "--configs", "float_resnet50_f32", "float_resnet50_bf16in")
            instrument("int8ship", "--configs", "int8ship_resnet50_f32")
            instrument("int8", "--configs", "int8_resnet50_f32")
            instrument("ensemble", "--ensemble", "--configs", "float_resnet50_f32")
            finish("mobile_fit")
            fit_dirs = sorted((QUALITY_OUT / "mobile").glob("results_smoke/*/checkpoints"))
            fit_ckpts = sorted(p.name for d in fit_dirs for p in d.iterdir())
            if runs["mobile_fit"]["rc"] != 0 or fit_ckpts != ["epoch=0-step=8"]:
                raise AssertionError(f"quality: the mobile smoke fit failed: "
                                     f"{runs['mobile_fit']} {fit_ckpts}")
            start("recalibrate_bn", ["pets_face_recognition_tpu_torch.recalibrate_bn", "--ckpt",
                                     str(fit_dirs[0]), "--device", dev.type])
            finish("recalibrate_bn")
            instrument("mobile", "--configs", "float_mobile_f32", "--mobile-ckpt",
                       str(fit_dirs[0]))
            recal = recalibration_check(fit_dirs[0]) if runs["recalibrate_bn"]["rc"] == 0 else {}
            for label in ("float", "int8ship", "int8", "ensemble", "mobile"):
                finish(label)
            float_tsv = QUALITY_OUT / "float" / "tsv_float_resnet50_f32.tsv"
            diff_out = {}
            for label, other, tol in (("diff_self", float_tsv, "1e-6"), (
                    "diff_int8ship", QUALITY_OUT / "int8ship" / "tsv_int8ship_resnet50_f32.tsv",
                    "1e-3")):
                start(label, ["pets_face_recognition_tpu_torch.diff_tsv_ranks", str(float_tsv),
                              str(other), "--score-tol", tol])
            for label in ("diff_self", "diff_int8ship"):
                diff_out[label] = finish(label).stdout.splitlines()
        tables, passes = {}, {}
        for label in ("float", "int8ship", "int8", "ensemble", "mobile"):
            for name, store in (("quality_table.json", tables), ("quality_passes.json", passes)):
                path = QUALITY_OUT / label / name
                store[label] = _json.loads(path.read_text()) if path.exists() else None
        ship = quant_entries(QUALITY_OUT / "int8ship" / "quant_int8ship_resnet50_f32.pkl")
        full = quant_entries(QUALITY_OUT / "int8" / "quant_int8_resnet50_f32.pkl")
        same_tsv = float_tsv.read_bytes() == tsv_here.read_bytes()
    finally:
        shutil.rmtree(QUALITY_OUT, ignore_errors=True)
        torch.cuda.empty_cache()
    extra = full - ship
    pinned = bool(extra) and ship <= full and all(
        m == "det_keypoint_prod" and k.split(".", 1)[0] in ("backbone", "rpn")
        for m, k in extra) and {k.split(".", 1)[0] for _, k in extra} == {"backbone", "rpn"}
    expected = {"float": ["float_resnet50_f32", "float_resnet50_bf16in"],
                "int8ship": ["int8ship_resnet50_f32"], "int8": ["int8_resnet50_f32"],
                "ensemble": ["float_resnet50_f32"], "mobile": ["float_mobile_f32"]}
    bad_rows = {label: tables[label] for label, names in expected.items()
                if tables[label] is None or sorted(tables[label]) != sorted(names) or not all(
                    r["queries_total"] == QUALITY_CORPUS["n_ids"]
                    and 0.0 <= r["candR@1"] <= r["candR@10"] <= r["candR@100"] <= 1.0
                    for r in tables[label].values())}
    emit("quality", card=smi, corpus=dict(QUALITY_CORPUS, photos=photos), rows=tables,
         passes=passes, invocations={k: {"rc": v["rc"], "seconds": v["seconds"]}
                                     for k, v in runs.items()},
         inprocess=dict(inprocess, same_tsv_as_subprocess=same_tsv),
         quant_state=dict(int8_entries=len(full), int8ship_entries=len(ship),
                          only_int8=len(extra), pinned=pinned,
                          only_int8_tops=sorted({(m, k.split(".", 1)[0]) for m, k in extra})),
         diff_self=diff_out["diff_self"][-1], diff_int8ship=diff_out["diff_int8ship"],
         recalibrate_bn=recal, seconds=time.perf_counter() - t0)
    # the float against the int8ship tsv is reported: its verdict is not a gate
    failed = {k: v for k, v in runs.items() if v["rc"] != 0 and k != "diff_int8ship"}
    if failed:
        raise AssertionError(f"quality: subprocesses failed: {failed}")
    if bad_rows:
        raise AssertionError(f"quality: tables without their rows or out of order: {bad_rows}")
    if not pinned:
        raise AssertionError(f"quality: the int8 rows' quant states differ by {sorted(extra)[:8]}")
    if diff_out["diff_self"][-1] != "RANK-SAFE":
        raise AssertionError(f"quality: the float tsv against itself: {diff_out['diff_self']}")
    if not (rc_here == 0 and inprocess["same_state_dict"]
            and inprocess["budgets"] == [1000, 1000, 1]):
        raise AssertionError(f"quality: the in-process pass's detector: {inprocess}")
    missing = [k for k in ("warp_perspective_batch", "nms_keep_sorted_batch",
                           "multilevel_roi_align") if launches[k] == 0]
    if missing:
        raise AssertionError(f"quality: kernels not launched in the float pass: {missing}")
    if not (recal and recal["latest"] == recal["sibling"] == "epoch=0-step=9"
            and recal["same_keys"] and recal["params_equal"] and recal["finite"]
            and recal["moved"] and recal["worst_rel_vs_cpu"] <= QUALITY_RECAL_REL):
        raise AssertionError(f"quality: recalibrate_bn: {recal}")
    return launches


def quality_full(dev, smi: str) -> None:
    """``python3 chip_smoke.py --quality-full``: the quality instrument over
    the whole hard corpus (``make_kashtanka_hard`` at its defaults, 1272
    photos) on ``quality_phase``'s checkpoints, its four default ResNet-50
    rows and, on the recalibrated mobile smoke fit, its two mobile rows, one
    pass after another in one invocation; prints the table, each pass's
    seconds and photos/s, and the card."""
    import json as _json
    import shutil

    from pets_face_recognition_tpu_torch import smoke_data

    work = QUALITY_OUT / "full"
    shutil.rmtree(QUALITY_OUT, ignore_errors=True)
    (work / "mobile").mkdir(parents=True)
    base = quality_subprocess_env()
    try:
        t = time.perf_counter()
        data = smoke_data.make_kashtanka_hard(work / "corpus")
        env = dict(base, **quality_checkpoints(dev, work / "ckpt"))
        subprocess.run([sys.executable, "-m", "pets_face_recognition_tpu_torch.main_keypoints",
                        "--config", str(MOBILE_SMOKE)], cwd=work / "mobile", env=base,
                       check=True, capture_output=True, text=True, timeout=600)
        ckpt = next((work / "mobile").glob("results_smoke/*/checkpoints"))
        subprocess.run([sys.executable, "-m", "pets_face_recognition_tpu_torch.recalibrate_bn",
                        "--ckpt", str(ckpt)], cwd=work, env=base, check=True,
                       capture_output=True, text=True, timeout=600)
        setup_s = time.perf_counter() - t
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pets_face_recognition_tpu_torch.quality_instrument",
             "--data", str(data), "--gt", str(work / "corpus" / "hard_gt.json"), "--out",
             str(work / "out"), "--mobile-ckpt", str(ckpt), "--device", "cuda"], cwd=work,
            env=env, capture_output=True, text=True, timeout=3000)
        seconds = time.perf_counter() - t
        out = work / "out"
        emit("quality_full", card=smi, rc=proc.returncode, setup_s=setup_s, seconds=seconds,
             recalibrated=sorted(p.name for p in ckpt.iterdir()),
             table=_json.loads((out / "quality_table.json").read_text())
             if proc.returncode == 0 else None,
             passes=_json.loads((out / "quality_passes.json").read_text())
             if proc.returncode == 0 else None,
             markdown=[ln for ln in proc.stdout.splitlines() if ln.startswith("|")],
             stderr_tail=proc.stderr[-2000:] if proc.returncode else "")
        if proc.returncode != 0:
            raise AssertionError("quality_full: the instrument failed")
    finally:
        shutil.rmtree(QUALITY_OUT, ignore_errors=True)


def row_paths(name: str, paths: dict) -> list[str]:
    """The paths whose launches a kernel row sums: the mobile paths for a
    ``_mobile`` row, the Mask R-CNN paths for a ``_mask`` row, mask_train for
    the ``_masktrain`` row, the alternate families' paths for an ``_alt`` row,
    every path for the others."""
    if name.endswith("_masktrain"):
        return ["mask_train"]
    if name.endswith("_alt"):
        return [p for p in paths if p.startswith("alt_") and not p.startswith("alt_bf16_")]
    if name.endswith("_mobile"):
        return [p for p in paths if p.startswith("mobile_")]
    if name.endswith("_mask"):
        return [p for p in paths if p in MASK_PATHS]
    return list(paths)


def main() -> int:
    faulthandler.dump_traceback_later(1100, exit=True)
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from pets_face_recognition_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())

    t = time.perf_counter()
    path = kernels.build()
    kernels.library()
    emit("build", seconds=time.perf_counter() - t, library=str(path))
    if sys.argv[1:] == ["--quality-full"]:
        faulthandler.dump_traceback_later(3300, exit=True)   # nine passes over 1272 photos
        quality_full(dev, smi)
        print(smi, flush=True)
        faulthandler.cancel_dump_traceback_later()
        return 0

    rows = kernel_phase(dev)
    rows.update(reduced_kernel_rows(dev))  # K1-bf16, K1-int8, K3-bf16
    rows.update(train_kernel_phase(dev))   # K2 and K3 at the training shapes, K4, K5
    rows.update(bf16_backward_kernel_row(dev))   # K4-bf16 at the training shapes
    rows.update(mobile_kernel_phase(dev))  # K3, K4 and the pre-pass on p4, p5
    edge_phase(dev)
    # each path's launch counts, set to 0 just before it and read just after
    paths = {"e2e": e2e_phase(dev, kernels, smi)}
    paths["mobile_e2e"] = e2e_phase(dev, kernels, smi, "mobile", "mobile_e2e",
                                    (B_TIMED, B_BENCH))
    paths.update(bf16_serve_phase(dev, kernels, smi))  # JAX's accelerator precision
    paths["tsv"], (detector, dog, _) = tsv_phase(dev, kernels, smi)
    jpeg_stream_phase(dev, smi, detector, dog)
    del detector, dog
    paths["mobile_tsv"] = mobile_tsv_phase(dev, kernels, smi)
    retrieval_phase(dev, smi)
    paths["train"] = train_phase(dev, kernels, smi)
    paths["mobile_train"] = train_phase(dev, kernels, smi, "mobile", "mobile_train")
    train_vs_cpu_phase(dev)
    mobile_train_vs_cpu_phase(dev)
    paths.update(keypoint_fit_phase(dev, kernels, smi))
    paths.update(fe_phases(dev, kernels, smi))   # fe_transform, fe_reproduce, fe_fit
    mask_paths, mask_rows = mask_phases(dev, kernels, smi)
    paths.update(mask_paths)
    rows.update(mask_rows)
    mask_paths, mask_rows = mask_train_phases(dev, kernels, smi)
    paths.update(mask_paths)
    rows.update(mask_rows)
    paths.update(int8_phases(dev, kernels, smi))   # int8_conv, int8_serve, int8_chain
    paths.update(int8_bf16_serve_phase(dev, kernels, smi))
    alt_paths, alt_rows = alt_rcnn_phase(dev, kernels, smi)   # the five alternate factories
    paths.update(alt_paths)
    rows.update(alt_rows)
    paths.update(alt_bf16_phase(dev, kernels, smi))   # Swin-T, ConvNeXt-T in bfloat16
    paths.update(ddp_phase(dev, kernels, smi))    # ddp_fe, ddp_keypoint, ddp_mask, ddp_serve
    tuners_phase(dev, smi)
    paths["dog_fixture"] = dog_fixture_phase(dev, kernels, smi)
    paths["quality"] = quality_phase(dev, kernels, smi)   # the instrument over the hard corpus
    table = []
    for name, counted, src, replaces in KERNEL_ROWS:
        table.append(dict(rows[name], name=name, route="cuda",
                          source=f"pets_face_recognition_tpu_torch/{src}", replaces=replaces,
                          launches=sum(paths[p][k] for p in row_paths(name, paths)
                                       for k in counted)))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in table]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
