"""Drive the PyTorch port's paths on one NVIDIA card and hold each of its
CUDA kernels against the kernel's plain PyTorch version.

    python3 chip_smoke.py

Phases; a failure in any of them ends the run with a non-zero exit code:

  1. the card's name and power limit; build the kernels (one nvcc per
     source, all started together) and print the build seconds, each
     kernel's registers, and K4's bf16 and f32 tile plans at the backbone
     stages with their dynamic shared memory;
  2. K1, the pillar encode, against its plain version at three inputs of
     the flagship vehicle call's shapes (3 maps x 20,000 points, 704 x 200
     grid, C = 64): the ``make_scene`` call itself, a dense uniform cloud
     and a hot cell; f32 and bf16 output, TF32 off, every empty cell +0.0
     bits; per input its valid points and occupied cells, device times of
     kernel and plain, the bytes bound and the share of it, the device time
     of each of K1's launches, and the time of zero_() on a tensor of the
     output's size, the write alone;
  3. K2, the rotated-quad IoU, against its plain version at 512 x 512, full
     and triangular, on the corners of decoded boxes around the scene's
     objects plus random quads; times of both, the prefilter's survivor
     share, the all-pairs bound and the bound of the work the input needs;
  3a. K3, the pillar reduce, at the flagship vehicle call (m = 3,
     n = 20,000, 140,800 cells): maxima exact, sums within 1e-4 relative;
     times of kernel and plain, and the bytes bound;
  3b. K4, the fused 3x3 conv (K4a grid over maps, K4b all maps), at each
     flagship backbone stage (6 maps of 100x352x64, 50x176x128,
     25x88x256), bf16 and f32 with TF32 off, against its plain version;
     times of both forms, the plain version and the library call for the
     same function (the ``auto``-mode ConvBNReLU: cuDNN conv, BN, ReLU),
     and the bound per launch (f32: the smaller of the FMA and the 3xTF32
     tensor-core bounds); per stage and type, each form's share of the
     bound and ratio to the library time, and the host microseconds of one
     ``conv3x3_same`` call beside one cuDNN ``ConvBNReLU`` call; per scene
     of 32 launches in both types;
  4. the tiny configs on the card against the same weights on the CPU (the
     plain versions, which the CPU tests hold against the JAX package):
     det under ``auto`` and under ``pallas``, and seg;
  4c. the tiny camera configs (tests/test_camera.py's camera block: every
     type camera only, and the vehicles LiDAR + camera with gt depth) on
     the card against the same weights on the CPU, f32, TF32 off,
     deterministic cuDNN, with the frustum points' smallest distance to a
     cell boundary;
  4d. the tiny V2X-ViT det and seg configs (the tiny config with
     tests/test_torch_v2xvit.py's transformer block: three windows, split
     attention) on the card against the same weights on the CPU, f32, TF32
     off, pinned cuDNN, in ``auto`` and ``pallas``, on a scene with
     perturbed poses (up to 5 degrees and 3 m) and delays (0-3), with the
     ROI samples' smallest distance from the 0.5 threshold;
  4f. the tiny intermediate-family configs (``TINY_FAMILY``: the tiny
     config with tests/test_model_zoo.py's fusion blocks), det for all six
     registered names and seg for CoBEVT / V2VNet / When2com, on the card
     against the same weights on the CPU, f32, TF32 off, pinned cuDNN, in
     ``auto`` and ``pallas``, on a scene with an absent agent and perturbed
     ``pairwise_t_full``: outputs within TINY_TOL x (1 + scale), equal keep
     sets, K1 3 / K4a 3 (``pallas``) / K2 1 (det) launches, the V2VNet ROI
     and NMS margins bounded;
  4e. the tiny SCOPE config (tests/test_temporal.py's fusion block over the
     tiny point-pillar config, ``TINY_SCOPE_ARGS``), ResNet and plain
     backbone, on the card against the same weights on the CPU, f32, TF32
     off, pinned cuDNN, on two distinct frames with perturbed history and
     ego-row poses: outputs, comm masks, query cells and keep sets, K1 2 /
     K2 1 launches, and the margins at the comm threshold, the query cut and
     the NMS threshold;
  4a. one flagship scene at full width in f32 with TF32 off: the ``pallas``
     conv backend against ``auto`` on the single-agent confidence of all
     agents and on the outputs of the scene with only the ego agent;
  5. the full flagship Where2comm det path (vehicle 3 / rsu 2 / drone 1,
     20,000 points per agent, bf16, seeded random weights, top_k 512) on
     8 scenes, timed N_RUNS (1) times after a warm-up: forward, decode and rotated
     NMS per scene; median ms/scene and scenes/s, median per-stage ms, peak
     memory, kept detections, NMS passes, and the kernels' launch counts
     during the timed runs (K1 3x, K2 1x per scene), and the kept
     detections of two more passes under each of three settings (cuDNN's
     autotuner; cuDNN pinned: no autotuner, deterministic algorithms; pinned
     with ``torch.use_deterministic_algorithms``); then the same under
     ``AIRV2X_CONV_KERNEL=pallas`` (K4a 32x per scene); then K2 checked
     and timed as in phase 3 on scene 0's own NMS input (the top-512
     corners ``decode_detections`` passes to ``rotated_nms``, caught in one
     more run outside the counted ones);
  6. a torch.profiler window over PROFILED_SCENES (1) more scene: device time by kernel,
     K1's kernels summed, and the device's idle share, with the SM clock
     and power draw after it;
  7. the LiDAR BEV-segmentation path (the seg config cut as in phase 5,
     the same 8 scenes, bf16) in ``auto`` and in ``pallas`` mode: ms/scene,
     stage times, peak memory, the decoded maps' class histograms, launch
     counts, and a profile window of each;
  10. (run after phase 7) the camera-LSS det path at full width
     (``hypes_yaml/airv2x/camera/det/where2comm.yaml``, max_cav cut as in
     phase 5, cameras 6 / 4 / 1 at 256 x 352, bf16, seeded random weights),
     8 scenes resident on the card (``make_scene``, then
     ``add_camera_inputs``), in ``auto`` and in ``pallas`` mode, timed as
     phase 5: the convolutions' operations per scene, ms/scene, stage times
     (trunks + heads, lift + voxel pooling, BEV encoder, backbone + shrink +
     confidence, fusion + heads, decode + NMS), peak memory, kept
     detections (and under the settings of phase 5), launch counts (K2 1x,
     K4a 32x in ``pallas``, K1 never) and a profile window with each
     stage's device busy time; a ``camera`` JSON line;
  11. (run after phase 10) the V2X-ViT LiDAR path at full width
     (``hypes_yaml/airv2x/lidar/{det,seg}/v2xvit.yaml``, cut as phase 5,
     the same 8 scenes, bf16, seeded random weights), det then seg, in
     ``auto`` and in ``pallas`` mode: the transformer's operations per scene
     (Linears and attention products, from the configuration's shapes: the
     work its function needs, the floor, and the work the code executes)
     and their time at the dense bf16 peak; ms/scene, stage times (encoder,
     backbone + shrink, transformer, heads, decode), peak memory, launch
     counts (K1 3x, K2 1x per det scene, K4a 16x in ``pallas``: one
     backbone pass), a profile window, kept detections or class
     histograms; then one det scene with perturbed poses and delays: finite
     outputs, the ROI mask on the card equal to the CPU's, and the f32
     model at one layer per backbone stage and one transformer block
     (``shallow_hypes``) with its fused map and psm / rm / obj on the card
     against the CPU's (TINY_TOL x (1 + scale)); a ``v2xvit`` JSON line;
  12. (run after phase 11) the SCOPE temporal det path at full width
     (``hypes_yaml/opv2v/opv2v_scope.yaml``, nothing cut: 5 vehicles, 2
     frames, 20,000 points per agent, bf16, seeded random weights), 8
     scenes built as ``tools/bench_workloads.py`` builds ``temporal_det``
     (one ``make_scene`` frame repeated, identity history), in ``auto`` and
     in ``pallas`` mode: the convolutions' and Linears' operations per scene
     from the configuration's shapes (``scope_ops``) and their time at the
     dense bf16 peak; ms/scene, stage times (encoder + backbone + shrink of
     both frames, temporal, collaboration, late fusion + heads, decode),
     peak memory, launch counts (K1 2, K2 1, K4a 0 per scene), a profile
     window with the device busy by stage and the idle share, kept
     detections and NMS passes; then one scene with perturbed poses
     through the f32 model on the card and on the CPU (psm, rm and the
     late-fused map within TINY_TOL x (1 + scale), comm masks and query
     cells equal); a ``scope`` JSON line;
  15. (run after phase 12) the intermediate family at full width
     (``hypes_yaml/airv2x/lidar/det/{att_fusion,max_fusion,cobevt,v2vnet,
     when2com}.yaml`` and ``seg/{cobevt,v2vnet,when2com}.yaml``, cut and
     scened as phase 5, bf16, seeded random weights drawn on the card;
     ``intermediate.yaml`` only built: the class of att_fusion), each path
     in ``auto`` and ``pallas``, FAMILY_RUNS timed runs after a warm-up:
     the fusion's operations per scene from the configuration's shapes
     (``family_ops``: the work its function needs and the work the code
     executes) at the dense bf16 peak and its weights' bytes; ms/scene,
     stage times (encoder, backbone + shrink, fusion, heads, decode), peak
     memory, launch counts (K1 3, K2 1 per det scene, K4a 16 in ``pallas``),
     a ``pallas`` profile window of one scene with the busy by stage and the idle share,
     kept detections or class histograms; one perturbed det scene per
     fusion kind (cobevt, v2vnet, when2com) through the f32 model at one
     layer per backbone stage and one fusion block or round
     (``shallow_hypes``) on the card and on the CPU (TINY_TOL x (1 +
     scale), V2VNet's ROI mask card == CPU); and
     phase 13's on-disk scenario scored once by the V2VNet det model
     through ``inference_multi_scenario`` in ``pallas`` (a finite AP table,
     K1 3, K4a 16, K2 at least 2 launches per scene); a ``family`` JSON line;
  13. (run after phase 15) the evaluation entry points at full width: an
     on-disk AirV2X scenario (``write_scenario``: 8 timestamps, 3 vehicles,
     2 RSUs and 1 drone in range, ``make_scene`` clouds of 20,000 points
     asked per agent, 12 objects, the seg maps) read by the port's
     ``AirV2XDataset`` (host ms per ``__getitem__``); one batch loaded by
     ``RealDataLoader`` for the card against the CPU's (every array equal,
     the anchor targets within BATCH_TARGET_TOL); phase 5's seeded random
     weights saved as a run dir (the cut det and seg configs in bf16), then
     the port's ``inference_multi_scenario`` and ``inference_airv2x`` (det)
     and ``inference_airv2x_seg`` (seg) on the card in ``auto`` and in
     ``pallas``, each after a warm-up run: ms/scene (load + forward +
     decode + metrics, host clock), the AP / mAP / mIoU table (finite), and
     the launches per scene (K1 3, K4a 32 in ``pallas``, K2 at least 2 per
     det scene: NMS and AP, asserted); K2 on the (det, gt) corners the AP
     received in the counted det runs, with a zero-width and a point quad
     on a gt appended to the dets, against its plain version (K2_TOL; the
     two degenerate rows exactly 0 on both sides); a profile window of 3 det scenes
     split into load, forward + decode and AP; then 3 steps of the train
     CLI on the scenario (``RealDataLoader``, 2 workers, batch 2), finite;
  14. the port's AP gate (``tools/chip_ap_gate.py``) at its default recipe:
     the tiny config trained 20 epochs x 20 steps on the card, 16 synthetic
     eval scenes; the card's f32 COMBINED AP table must equal the CPU's
     within 5e-3 (the gate), and every AP of the two, per scenario and
     COMBINED, must be equal (this phase: at this recipe's AP the 5e-3
     cannot fail), as must the same weights' f32 table in ``pallas`` mode
     (K4); the bf16 table is printed beside them; an ``eval`` JSON line
     with phases 13 and 14;
  16. (run after phase 14) the camera configs on disk at full width: an
     on-disk scenario with cameras (``write_scenario`` with
     ``camera_hw``: 3 timestamps, phase 5's agents, 6 / 4 / 1 smooth seeded
     720 x 1280 PNGs per vehicle / RSU / drone, the bytes printed), the ten
     camera YAMLs of ported models (``CAMERA_PATHS``) cut as phase 5 with
     the AirV2X augmentation keys supplied (``camera_hypes``), the K4a bf16
     plans at the LSS backbone's one map asserted to be instantiated; the
     dataset's host ms per ``__getitem__``; one loaded batch card vs CPU
     (every camera array equal); per config, bf16, seeded random weights
     drawn on the card, in ``auto`` and ``pallas``: ms/scene, stage times,
     peak memory, a profile window of one scene (busy, idle share, busy by stage), the
     launches asserted per scene (K1 0; K4a the config's ConvBNReLU count x
     its backbone passes in ``pallas``, 0 in ``auto``; K2 1 per det scene),
     kept detections or class histograms; the tiny compositions
     (``TINY_COMPOSITIONS``) card vs CPU, camera only in ``pallas`` and
     LiDAR + camera in ``auto``, f32, TF32 off, pinned cuDNN, within
     TINY_TOL x (1 + scale), keep sets equal, launches and margins
     asserted; then the Where2comm det and seg configs through
     ``inference_multi_scenario`` and ``inference_airv2x_seg`` on the
     scenario in ``pallas`` (tables printed; K1 0, K4a 32, K2 at least 2
     per det scene); a ``camera_disk`` JSON line and the phase's seconds;
  18. (run after phase 16) OPV2V and DAIR-V2X on disk (``phase_disk``): an
     OPV2V split written beside ``write_scenario``'s (DISK_CAVS: 5 vehicles
     and one beyond the 70 m gate, DISK_STAMPS stamps, DISK_POINTS points
     per cloud, DISK_OBJECTS vehicles) and a normalized DAIR split (vehicle
     and roadside unit, DISK_STAMPS frames) with one raw frame, read
     directly and converted by ``tools/dair_convert.py``, both against the
     normalized frame; the 18 OPV2V / DAIR YAMLs of the flat family and
     SCOPE (DISK_CONFIGS, whole, bf16, seeded random weights, batch 1)
     through their dataset and ``RealDataLoader``: forward, decode and the
     AP's accumulation, DISK_RUNS timed runs per mode after a warm-up
     (ms/scene, peak memory, kept detections), the launches asserted per
     scene (K1 once per frame, K4a 16 in ``pallas`` on the plain backbone,
     0 on the ResNet one, K2 for the NMS and for the AP where it had
     detections and gt), a ``pallas`` profile window of one scene (busy, idle); the
     K1 / K4a / K2 inputs each config's ``pallas`` warm-up handed the
     kernels (``recorded_kernel_inputs``: 5 OPV2V and 2 DAIR maps, the
     NMS and AP quads), each new one held to its plain version before the
     counted runs (``check_kernel_inputs``); one loaded OPV2V temporal batch
     card against CPU; a ``disk`` JSON line with those checks; and, after
     phase 17 (``phase_disk_train``), DISK_TRAIN's OPV2V configs trained on
     the split as phase 17 trains, each evaluated after, its f32 kernel
     inputs held to their plain versions the same way;
  19. HEAL, STAMP and SiCP. (a) (run after phase 16) the tiny models
     (``TINY_HETERO``), det and seg, on the card against the same weights on
     the CPU, f32, TF32 off, pinned cuDNN, ``auto`` (and ``pallas`` for
     SiCP, whose spine holds ConvBNReLUs), on phase 4f's scene: outputs
     within TINY_TOL x (1 + scale), equal keep sets, K1 3 / K4a 3 (SiCP
     ``pallas``) / K2 1 (det) launches, the NMS and warp-footprint margins
     bounded (``hetero_footprint_margin``); (b) the ten serving configs
     (``HETERO_PATHS``: HEAL and STAMP collab LiDAR det and seg and camera
     det, the four SiCP YAMLs), cut as phase 5, bf16, seeded random weights
     drawn on the card, LiDAR on HETERO_SCENES perturbed ``make_scene``
     scenes and camera on phase 16's on-disk scenes, each in ``auto`` and
     ``pallas``: the ``pallas`` warm-up's K1 / K4a / K2 inputs held to
     their plain versions, HETERO_RUNS timed runs (ms/scene, stage times,
     peak memory; launches asserted per scene: K1 3 per LiDAR scene, 0 per
     camera scene, K4a 16 per SiCP ``pallas`` scene and 0 for HEAL /
     STAMP, K2 1 per det scene), a ``pallas`` profile window of one scene (busy, idle),
     kept detections or class histograms; a ``hetero`` JSON line; (c) (run
     after phase 18's training) the multi-stage recipe of HEAL and STAMP
     (LiDAR det: the three ``single/*.yaml`` MULTI_STAGE_STEPS steps each
     through ``tools/train.py``, then ``tools/train_multi_stage.py`` on the
     cut collab config with ``backbone_fix: true``: the three loads and the
     freeze printed, the frozen tensors equal to the vehicle run's, the
     pyramid trained) with the stage-2 weights evaluated through K1 / K2
     and their kernel inputs held to the plain versions, and SiCP's LiDAR
     det config trained as phase 17 trains and evaluated; a
     ``hetero_train`` JSON line;
  20. early fusion and BM2CP (run after phase 18's serving, on its splits
     and on phase 16's scenario, which phase 16 leaves for it): (a) the
     tiny early, DiscoNet teacher, AirV2X BM2CP (det, seg) and flat BM2CP
     models (``tiny_early_hypes``, ``tiny_bm2cp_hypes``) on the card
     against the CPU, f32, pinned cuDNN, both modes: outputs within
     TINY_TOL, equal keep sets, launches asserted, the NMS and BM2CP
     communication margins (``bm2cp_comm_margin``) bounded; (b) the ten
     EB_PATHS YAMLs at full width, bf16, seeded random weights (BM2CP's BN
     statistics from one scene): AirV2X early and LiDAR BM2CP on
     ``make_scene`` scenes (BM2CP with one camera per slot), BM2CP camera
     det and seg on phase 16's scenario through the BM2CP dataset (the
     LiDAR projected into every camera), OPV2V / DAIR early, teacher and
     BM2CP on phase 18's splits (cameras written in for BM2CP,
     ``add_disk_cameras``; all-unobserved depth maps, which no loader
     builds: ROADMAP §3), each in ``auto`` and ``pallas``: the ``pallas``
     warm-up's K1 / K4a / K2 inputs held to their plain versions (K1 on
     the merged early cloud among them), EB_RUNS timed runs with the
     launches asserted per scene (K1 1, 0 on AirV2X BM2CP's classic path;
     K4a 16 on the early models in ``pallas``, 0 on BM2CP's ResNet; K2 1
     per det scene, + 1 where the on-disk AP matched), a ``pallas``
     profile window of one scene, kept detections, class histograms or
     AP; an ``early_bm2cp`` JSON line; (c) (after phase 19's training)
     ``airv2x_early`` and BM2CP LiDAR det trained as phase 17 trains,
     EB_TRAIN_STEPS timed steps and the repeated-batch check; an
     ``early_bm2cp_train`` JSON line;
  21. the flat family's rest and late fusion (run after phase 20's serving,
     on phase 18's splits): (a0) the tiny DiscoNet, How2comm (T = 2) and
     CoAlign models (``tiny_flat_rest_hypes``) on the card against the CPU,
     f32, pinned cuDNN, both modes: outputs within TINY_TOL, equal keep
     sets, the NMS margin bounded, launches asserted; (a) the six FLAT_REST YAMLs
     (``{opv2v,dair}_{disconet,how2comm,coalign}``) at full width, bf16,
     seeded random weights (How2comm's BN statistics from one scene,
     ``calibrate_bn_``), batch 1, through their datasets (How2comm on
     OPV2V's 2-frame samples; on DAIR, whose loader has no frames, on
     2-frame batches built from consecutive loaded frames,
     ``dair_frame_pairs``), each in ``auto`` and ``pallas`` as phase 18
     runs its configs: the ``pallas`` warm-up's kernel inputs held to their
     plain versions, FLAT_REST_RUNS timed runs with the launches asserted
     per scene (K1 once per frame, K4a 16 on DiscoNet's plain backbone in
     ``pallas``, 0 on the ResNet ones, K2 1 + 1 where the AP matched), a
     ``pallas`` profile window, the AP; (b) the inference CLI's late
     fusion (``--fusion_method late``) on the cut flagship over LATE_SCENES
     synthetic scenes in both modes, a warm-up run's kernel inputs held to
     their plain versions, the counted run's launches asserted (K1 3, K4a
     32 in ``pallas``, K2 1 + 1 where the AP matched, per scene), ms/scene
     and the AP table; a ``flat_rest`` JSON line; (c) (after phase 20's
     training) ``train_w_kd``: a teacher run dir from the train CLI (one
     step of ``opv2v_disconet_teacher``), then KD_STEPS steps of the
     OPV2V DiscoNet student under ``point_pillar_disconet_loss`` (the
     teacher's K1 launch per step, its inputs held to the plain version),
     and CoAlign trained COALIGN_STEPS steps at batch 2 on the OPV2V split
     with the anchor grid in the labels (the IoU term finite); ms/step and
     peak memory; a ``flat_rest_train`` JSON line;
  22. V2X-R (``phase_v2xr``, ``phase_v2xr_train``): phase 18's OPV2V split
     written again with a ``<stamp>_radar.pcd`` per cav (every 16th LiDAR
     point, jittered by 0.15 m: ~3,100 points, a few thousand in range);
     the 27 in-scope V2X-R YAMLs (``V2XR_YAMLS``: all but RTNH and MDD)
     whole at full width, bf16, batch 1, random weights, through
     ``OPV2VDataset(use_radar=True)``: the new model classes
     (``V2XR_TIMED``: SpatialCooper on LiDAR and on radar, PFA-Net, flat
     SiCP, the eight ``_lrf`` twins, L4DR, InterF with its pillar cap cut
     to INTERF_VOXELS, AttResNet on the LiDAR CoAlign YAML) timed on the 4
     loaded scenes as phase 18 times its configs, with a one-scene profile
     window; the other YAMLs (the LiDAR and 4DRadar twins of ported
     models, SCOPE) on one loaded scene in ``pallas``; every config's
     kernel inputs held to the plain versions (K1 on the radar clouds, K4a
     on each of L4DR's three stacks), its launches per scene asserted
     (``v2xr_per_scene``: K1 2 per frame on an ``_lrf`` twin, 1 on L4DR, 0
     on InterF; K4a 16, 48 on L4DR, 0 on the ResNet backbones; K2 for the
     NMS and the AP) and its outputs finite; then L4DR and the LiDAR +
     radar AttFusion twin trained at batch 2 on the split with the
     repeated-batch check; ``v2xr`` and ``v2xr_train`` JSON lines; the
     split's LiDAR clouds carry V2X-R's weather label (V2XR_WEATHER_NOISE
     of the points noise);
  23. RTNH, MDD and HEAL's AlignNet (``phase_tiny_alignnet``,
     ``phase_rtnh_mdd``, ``phase_alignnet`` after phase 22's serving,
     ``phase_rtnh_mdd_train`` after its training): the tiny HEAL with each
     of AlignNet's seven methods on the card against the CPU (keep sets,
     NMS decision margins, K1 3 / K2 1); RTNH and MDD whole at full width
     on 2 loaded scenes of phase 22's split in both modes (launches per
     scene asserted: RTNH K1 0 / K4a 0, MDD K1 2 / K4a ``mdd_k4a`` (the
     gate's count, 16), K2 for the NMS and the AP; every ``pallas`` kernel
     input held to its plain version; a one-scene profile window); HEAL's
     LiDAR det YAML with a deformable ``resnet3x3`` and an ``sdta``
     AlignNet at full width on phase 19's scenes (K1 3 / K4a 0 / K2 1);
     RTNH and MDD trained at batch 2 (labels' ``epoch`` 1; MDD's batches
     with the clean-point mask, its loss with ``diff_loss``); an
     ``rtnh_mdd_alignnet`` and an ``rtnh_mdd_train`` JSON line;
  4b. (run after phase 16, like the other training phases) one train step of
     the tiny configs, det and seg, on the card against the same step on
     the CPU: the same weights (copied), batch and keep fraction u, f32 with
     TF32 off and deterministic cuDNN; max|card - CPU| of the loss parts,
     every gradient, the updated parameters and the BN running statistics,
     each within its stated tolerance;
  8. training the flagship det model at full width (the cut of phase 5,
     batch 2 = ``train_params.batch_size``, 20,000 points per agent, 12
     objects, labels from ``make_batch``), bf16 autocast over f32 master
     weights, flax-like initialisation: after a warm-up, 10 timed steps
     (median ms/step and train scenes/s on the host clock with
     synchronize() on both ends, peak memory, every step's loss parts,
     all finite, a profile window of 3 steps), then one batch 20 times
     at a tenth of the lr, whose total loss must fall (``loss_fell``);
     then eval with the
     trained weights in f32: the single-agent confidence of ``pallas``
     against ``auto`` as phase 4a checks it (the folds were cached before
     training), and the det path (decode included) in ``pallas`` mode with
     its K1 / K4a / K2 launches counted;
  9. the same training run for the LiDAR seg model (512 x 512 labels), with
     no decode check;
  17. training beyond the flagship (``phase_train_models``): the V2X-ViT,
     AttFusion, Max, CoBEVT, V2VNet and When2com LiDAR det configs, the
     V2X-ViT seg config and the camera Where2comm and LSS det configs
     (``TRAIN_MODEL_PATHS``), cut as phase 5, batch 2, bf16 autocast over
      f32 master weights, cuDNN on its heuristics (no autotuning: the camera
     trunks' many shapes took minutes of it), in the order of phases 8-9:
     2 warm-up steps, TRAIN_MODEL_STEPS timed steps (ms/step, train
     scenes/s, peak memory), a profile window of one step (busy, idle;
     processing a longer window took a minute on the camera configs), then
     one batch TRAIN_MODEL_REPEATS times (``loss_fell``); finite loss
     parts, no kernel launch while training; the trained f32
     weights evaluated in ``auto`` and ``pallas`` with their K1 / K4a / K2
     launches asserted; then 2 steps of the train CLI on the camera LSS
     config over an on-disk scenario with cameras; a ``train_models`` JSON
     line.

The repeated-batch check of every training phase (``repeated_batch_check``):
after the timed steps, one batch is taken again and again at
REPEAT_LR_SCALE of the schedule's lr (Adam's moments carried over),
Where2comm's keep fraction held at REPEAT_KEEP; the batch is learned
(``loss_fell``) when the median of the second half of the repeats lies at
least REPEAT_DROP below the least of the first three. When it is not, the
next of up to REPEAT_BATCHES batches is taken the same way, and the
training fails when it learned none (``learned_a_batch``).

Launch counts are reset just before each timed path run (phases 5, 7, 10,
11, 12, 15, 16 and 18-23), each counted CLI run of phases 13, 15, 16 and 21,
each evaluation of phases 17, 18 and 19 and each single run of phase 22,
and read just after; the ``kernels`` line sums them over those runs. Every profile window
gives each kernel, copy and memset PyTorch launched to the one stage whose
host range holds its launch (``launch_ranges``), counts the port's own
kernels (K1 / K2 / K4, launched through ctypes) apart, and requires the
two together to stay within the window's device busy time. Its K4 times are per scene: the
32 launches of one scene at their stages, in
bf16 as the main path runs them and, under ``f32``, the f32 kernel; K2's
row adds the prefilter's survivor share and the scene input's numbers.
Phases 8, 9 and 17 print the card's name and power limit on every line of
numbers and their results as the ``training`` and ``train_models`` JSON
lines. It then prints
the seconds of each group of phases (a ``phase_seconds`` JSON line), the
kernels' JSON line and, last, the device JSON line.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import bisect
import contextlib
import copy
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(REPO, "hypes_yaml/airv2x/lidar/det/where2comm.yaml")
SEG = os.path.join(REPO, "hypes_yaml/airv2x/lidar/seg/where2comm.yaml")
CAMERA = os.path.join(REPO, "hypes_yaml/airv2x/camera/det/where2comm.yaml")
TINY = os.path.join(REPO, "hypes_yaml/test/tiny_where2comm.yaml")
V2XVIT = os.path.join(REPO, "hypes_yaml/airv2x/lidar/det/v2xvit.yaml")
V2XVIT_SEG = os.path.join(REPO, "hypes_yaml/airv2x/lidar/seg/v2xvit.yaml")
SCOPE = os.path.join(REPO, "hypes_yaml/opv2v/opv2v_scope.yaml")
NUM_AGENTS = {"vehicle": 3, "rsu": 2, "drone": 1}
NCAM = {"vehicle": 6, "rsu": 4, "drone": 1}  # the reference's camera rigs
POINTS_PER_AGENT = 20000
N_SCENES = 8
N_RUNS = 1  # timed runs over the scenes
# scenes in each profile window of the serving phases 6, 7, 10-12, 15, 16,
# 18 and 19 (3, or 4 in phase 18, until PR 14): processing a window's trace
# takes seconds per scene it holds
PROFILED_SCENES = 1
TOP_K = 512
DET_STAGES = ("encoder", "backbone+shrink+psm head", "fusion+heads",
              "decode+NMS")
SEG_STAGES = ("encoder", "backbone+shrink+crop", "fusion+seg head",
              "decode")
V2XVIT_STAGES = ("encoder", "backbone+shrink", "transformer", "heads")
FAMILY_STAGES = ("encoder", "backbone+shrink", "fusion", "heads")
# a camera frustum point this close to a cell boundary (in cell widths)
# could fall in another cell on the card than on the CPU
CELL_MARGIN = 1e-4
# the camera block of tests/test_camera.py's tiny model
TINY_CAM = {
    "grid_conf": {"xbound": [-19.2, 19.2, 0.4], "ybound": [-19.2, 19.2, 0.4],
                  "zbound": [-10, 10, 20.0], "ddiscr": [2, 50, 8],
                  "mode": "LID"},
    "data_aug_conf": {"final_dim": [64, 96]}, "img_downsample": 8,
    "img_features": 16, "bevout_feature": 16, "camera_encoder": "EfficientNet",
    "use_depth_gt": True, "depth_supervision": False,
}

# an ROI sample (a bilinear sample of the warped ones canvas) this close to
# the 0.5 threshold could fall on the other side of it on the card
ROI_MARGIN = 1e-4
# the tiny V2X-ViT transformer: dim 64, heads 4, dim_head 16, depth 1,
# windows 2 / 4 / 4 with split attention, at the tiny backbone's feature
# stride 2. The one copy: tests/torch_port_helpers.py (the CPU tests) and
# tests/test_torch_kernels_gpu.py (the card tests) load it from here.
TINY_V2XVIT_ENCODER = {
    "num_blocks": 1, "depth": 1, "use_roi_mask": True, "use_RTE": True,
    "RTE_ratio": 2,
    "cav_att_config": {"dim": 64, "use_hetero": True, "use_RTE": True,
                       "RTE_ratio": 2, "heads": 4, "dim_head": 16,
                       "dropout": 0.0},
    "pwindow_att_config": {"dim": 64, "heads": [4, 2, 1],
                           "dim_head": [16, 32, 64], "window_size": [2, 4, 4],
                           "relative_pos_embedding": True,
                           "fusion_method": "split_attn", "dropout": 0.0},
    "feed_forward": {"mlp_dim": 64, "dropout": 0.0},
    "sttf": {"voxel_size": [0.4, 0.4, 4], "downsample_rate": 2},
}

# SCOPE's tiny config: tests/test_temporal.py's fusion block over
# tests/test_point_pillar_family.py's tiny point-pillar config (3 slots,
# 64 x 64 grid, 16 / 32 channels, a 1x1 shrink), with the ResNet or the
# plain backbone, and the anchors and thresholds decode reads. The one copy:
# tests/torch_port_helpers.py and tests/test_torch_kernels_gpu.py load it.
TINY_SCOPE_ARGS = {
    "max_cav": 3, "anchor_number": 2,
    "pillar_vfe": {"use_norm": True, "with_distance": False,
                   "use_absolute_xyz": True, "num_filters": [16]},
    "base_bev_backbone": {"layer_nums": [1, 1], "layer_strides": [2, 2],
                          "num_filters": [16, 32], "upsample_strides": [1, 2],
                          "num_upsample_filter": [16, 16]},
    "shrink_header": {"use": True, "input_dim": 32, "dim": [32],
                      "kernal_size": [1], "stride": [1], "padding": [0]},
    "compression": 0,
    "fusion_args": {
        "voxel_size": [0.4, 0.4, 4], "downsample_rate": 1,
        "communication": {"thre": 0.01,
                          "gaussian_smooth": {"k_size": 5, "c_sigma": 1.0}},
        "agg_operator": {"mode": "Deform"}, "multi_scale": True, "frame": 2,
        "num_queries": 64, "layer_nums": [1, 1], "num_filters": [16, 32],
        "temporal_fusion": {"channel": 32, "height": 32, "width": 32}},
}
TINY_SCOPE_RANGE = [-12.8, -12.8, -3, 12.8, 12.8, 1]

# the intermediate-fusion family's tiny fusion blocks, patched into the tiny
# config: tests/test_model_zoo.py's variants (48 x 48 maps at 64 channels).
# The one copy: tests/test_torch_intermediate.py and phase 4f load it.
TINY_FAMILY = {
    "airv2x_attfusion": {},
    "airv2x_intermediate": {},
    "airv2x_maxfusion": {},
    "airv2x_cobevt": {"fax_fusion": {
        "input_dim": 64, "mlp_dim": 64, "window_size": 4, "dim_head": 16,
        "drop_out": 0.0, "depth": 1, "mask": True}},
    "airv2x_v2vnet": {"v2vfusion": {
        "voxel_size": [0.4, 0.4, 4], "downsample_rate": 4, "num_iteration": 1,
        "in_channels": 64, "gru_flag": True, "agg_operator": "avg",
        "conv_gru": {"H": 48, "W": 48, "kernel_size": [3, 3],
                     "num_layers": 1}}},
    "airv2x_when2com": {"when2com_fusion": {
        "voxel_size": [0.4, 0.4, 4], "downsample_rate": 4, "num_iteration": 2,
        "in_channels": 64, "query_size": 8, "key_size": 32, "mode": "softmax",
        "H": 48, "W": 48}},
}
# the family members with a seg config
FAMILY_SEG = ("airv2x_cobevt", "airv2x_v2vnet", "airv2x_when2com")
# phase 19's tiny HEAL / STAMP / SiCP blocks over the tiny config
# (tests/test_model_zoo.py's variants): a single-stage ResNet of 16 channels
# at stride 2, a ResNeXt pyramid of 32 / 64 channels with two deblocks and a
# 3x3 shrink to 64, the vehicle's ConvNeXt adapter (STAMP), SiCP's gate at
# 64 channels
_TINY_PYRAMID = {
    "in_head": 64,
    "fusion_backbone": {
        "resnext": True, "layer_nums": [2, 2], "layer_strides": [1, 2],
        "num_filters": [32, 64], "upsample_strides": [1, 2],
        "num_upsample_filter": [32, 32], "inplanes": 16},
    "modality_fusion": {
        "base_bev_backbone": {
            "layer_nums": [1], "layer_strides": [2], "num_filters": [16],
            "upsample_strides": [], "num_upsample_filter": []},
        "shrink_header": {"use": True, "input_dim": 64, "dim": [64],
                          "kernal_size": [3], "stride": [1], "padding": [1]},
        "compression": 0}}
TINY_ADAPTER = {
    "core_method": "adapterconvnext",
    "args": {"in_channels": 16, "out_channels": 16,
             "in_cav_lidar_range": [-19.2, -19.2, -3, 19.2, 19.2, 1],
             "out_cav_lidar_range": [-19.2, -19.2, -3, 19.2, 19.2, 1],
             "in_feature_shape": [48, 48], "out_feature_shape": [48, 48],
             "submodule_args": {"dim": 16, "depth": 1}}}
TINY_HETERO = {
    "airv2x_heal": _TINY_PYRAMID,
    "airv2x_stamp": dict(_TINY_PYRAMID, vehicle={"adapter": TINY_ADAPTER}),
    "airv2x_sicp": {"sicp_fusion": {"voxel_size": [0.4, 0.4, 4],
                                    "downsample_rate": 4, "in_channels": 64,
                                    "out_channels": 64}},
}


# phase 20's tiny BM2CP over the tiny config: 16-channel pillars and camera
# context, six LID depth bins, images of 64 x 96,
# the ResNet backbone at 16 / 32 / 64 with three deblocks and a 3x3 shrink
# to 64; the veh / rsu blocks BM2CP's (img_params + pc_params), the drone's
# a flat LSS conf
_TINY_BM2CP_GRID = {"xbound": [-19.2, 19.2, 0.4], "ybound": [-19.2, 19.2, 0.4],
                    "zbound": [-10, 10, 20.0], "ddiscr": [2, 50, 6],
                    "mode": "LID"}
TINY_BM2CP_IMG = {"grid_conf": _TINY_BM2CP_GRID,
                  "data_aug_conf": {"final_dim": [64, 96]}, "img_downsample": 8,
                  "bev_dim": 16, "use_depth_gt": False, "depth_supervision": True}
TINY_BM2CP_PC = {"voxel_size": [0.4, 0.4, 4],
                 "lidar_range": [-19.2, -19.2, -3, 19.2, 19.2, 1],
                 "pillar_vfe": {"use_norm": True, "with_distance": False,
                                "use_absolute_xyz": True, "num_filters": [16]},
                 "point_pillar_scatter": {"num_features": 16}}
TINY_BM2CP = {
    "vehicle": {"img_params": TINY_BM2CP_IMG, "pc_params": TINY_BM2CP_PC},
    "rsu": {"img_params": TINY_BM2CP_IMG, "pc_params": TINY_BM2CP_PC},
    "drone": {"grid_conf": _TINY_BM2CP_GRID,
              "data_aug_conf": {"final_dim": [64, 96]}, "img_downsample": 8,
              "img_features": 16, "bevout_feature": 16, "bev_dim": 16,
              "camera_encoder": "EfficientNet", "use_depth_gt": False,
              "depth_supervision": False},
    "modality_fusion": {
        "bev_backbone": {"layer_nums": [1, 1, 1], "layer_strides": [2, 2, 2],
                         "num_filters": [16, 32, 64],
                         "upsample_strides": [1, 2, 4],
                         "num_upsample_filter": [32, 32, 32]},
        "shrink_header": {"use": True, "input_dim": 96, "dim": [64],
                          "kernal_size": [3], "stride": [1], "padding": [1]},
        "compression": 0},
    "collaborative_fusion": {"voxel_size": [0.4, 0.4, 4], "downsample_rate": 1,
                             "multi_scale": True},
}
BM2CP_MARGIN = 1e-4  # a confidence's least distance from its threshold


def tiny_bm2cp_hypes(hypes: dict, name: str = "airv2x_bm2cp",
                     task: str = "det") -> dict:
    """The tiny config (``hypes``, loaded by either package) as the AirV2X
    BM2CP model (TINY_BM2CP; ``task`` det or seg) or, for
    ``point_pillar_bm2cp``, the flat model over its four slots (vehicle
    img_params / pc_params at the top, binary heads, ``point_pillar_loss``,
    ``supervise_single``)."""
    hypes = copy.deepcopy(hypes)
    args = hypes["model"]["args"]
    hypes["model"]["core_method"] = name
    hypes["fusion"]["core_method"] = "IntermediateFusionDatasetAirv2xBM2CP"
    for key in ("vehicle", "rsu", "drone", "modality_fusion", "where2com_fusion"):
        args.pop(key, None)
    args.update(copy.deepcopy(TINY_BM2CP))
    if name == "point_pillar_bm2cp":
        for key in ("vehicle", "rsu", "drone"):
            del args[key]
        args.update(img_params=copy.deepcopy(TINY_BM2CP_IMG),
                    pc_params=copy.deepcopy(TINY_BM2CP_PC), num_class=1,
                    supervise_single=True)
        hypes["loss"] = {"core_method": "point_pillar_loss",
                         "args": {"cls_weight": 1.0, "reg": 2.0}}
        hypes["num_class"] = 1
    hypes["task"] = args["task"] = task
    return hypes


def tiny_early_hypes(hypes: dict, name: str = "airv2x_early") -> dict:
    """The tiny config (``hypes``, loaded by either package) as early fusion
    (``airv2x_early`` / ``point_pillar_early``, multiclass heads) or the
    DiscoNet teacher (binary heads and ``point_pillar_loss``, as its OPV2V
    YAML): the vehicle's PFN layer, the tiny backbone and shrink as the flat
    model's blocks over the four slots."""
    hypes = copy.deepcopy(hypes)
    args = hypes["model"]["args"]
    hypes["model"]["core_method"] = name
    if name == "point_pillar_disconet_teacher":
        hypes["num_class"] = args["num_class"] = 1
        hypes["loss"] = {"core_method": "point_pillar_loss",
                         "args": {"cls_weight": 1.0, "reg": 2.0}}
    args["pillar_vfe"] = copy.deepcopy(args["vehicle"]["lidar"]["pillar_vfe"])
    args["base_bev_backbone"] = copy.deepcopy(
        args["modality_fusion"]["base_bev_backbone"])
    args["shrink_header"] = copy.deepcopy(args["modality_fusion"]["shrink_header"])
    return hypes


def bm2cp_comm_margin(model, batch) -> float:
    """The least distance of a present odd slot's confidence from its
    threshold map (resized as AttenComm resizes it), at which the
    communication mask of a BM2CP model is decided (the even slots always
    send); computed in the model's dtype on ``batch``."""
    from airv2x_tpu_torch.models.bm2cp_model import Airv2xBM2CP
    from airv2x_tpu_torch.models.fusion.where2comm import resize_comm_mask

    b, l = batch["agent_mask"].shape
    airv2x = isinstance(model, Airv2xBM2CP)
    with torch.inference_mode():
        if airv2x:
            x, thres, _ = model.encode_agents(batch)
            x = x.flatten(0, 1)
        else:
            x, thres, _ = model.modal_maps(batch)
            thres = thres.unflatten(0, (b, l))
        f2d, _ = model.backbone(x.permute(0, 3, 1, 2).to(model.compute_dtype))
        if model.shrink_conv is not None:
            f2d = model.shrink_conv(f2d)
        if airv2x and model.task == "seg":
            conf = model.seg_head.crop(f2d)
        else:
            conf = (model.heads.cls_head if airv2x else model.cls_head)(f2d)
        conf = torch.sigmoid(conf.float()).amax(1).unflatten(0, (b, l))
        th = thres[..., 0]
        if th.shape[-2:] != conf.shape[-2:]:
            th = resize_comm_mask(th, conf.shape[-2:])
    odd = (torch.arange(l, device=conf.device) % 2 == 1)[None, :]
    sel = (odd & batch["agent_mask"].bool())[..., None, None].expand_as(conf)
    return float((conf.double() - th.double()).abs()[sel].min()) if sel.any() else float("inf")


def deep_merge(dst: dict, src: dict) -> dict:
    """``src`` merged into ``dst`` in place, dicts key by key."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def warp_footprint_margin(aff, h: int, w: int, align_corners=False) -> float:
    """The smallest distance, in source pixels, at which the samples of the
    normalized warps ``aff`` (..., 2, 3) of an (h, w) map decide whether
    they touch the source canvas: a sample inside (-1, w) x (-1, h), whose
    bilinear taps reach the canvas, counts its distance to that box's edge,
    one outside the larger of its coordinates' distances outside it. Below
    it a rounding of the sample coordinates could move a pixel across a
    warped footprint's edge, where HEAL's weighted fuse (a score exactly 0)
    and SiCP's overlap (> 0) decide. Computed in float64 from the f32
    affines, with the warp's own grid."""
    ms = aff.reshape(-1, 2, 3).double()
    if not len(ms):
        return float("inf")
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=ms.device),
        torch.arange(w, dtype=torch.float64, device=ms.device), indexing="ij")
    if align_corners:
        gx, gy = 2 * xs / max(w - 1, 1) - 1, 2 * ys / max(h - 1, 1) - 1
    else:
        gx, gy = (2 * xs + 1) / w - 1, (2 * ys + 1) / h - 1
    m = [[ms[:, r, c][:, None, None] for c in range(3)] for r in range(2)]
    sxn = m[0][0] * gx + m[0][1] * gy + m[0][2]
    syn = m[1][0] * gx + m[1][1] * gy + m[1][2]
    if align_corners:
        sx, sy = (sxn + 1) * 0.5 * (w - 1), (syn + 1) * 0.5 * (h - 1)
    else:
        sx, sy = ((sxn + 1) * w - 1) * 0.5, ((syn + 1) * h - 1) * 0.5
    dx = torch.minimum((sx + 1).abs(), (sx - w).abs())
    dy = torch.minimum((sy + 1).abs(), (sy - h).abs())
    in_x, in_y = (sx > -1) & (sx < w), (sy > -1) & (sy < h)
    zero = torch.zeros_like(dx)
    outside = torch.maximum(torch.where(in_x, zero, dx),
                            torch.where(in_y, zero, dy))
    return float(torch.where(in_x & in_y, torch.minimum(dx, dy), outside).min())


def hetero_footprint_margin(model, batch) -> float:
    """``warp_footprint_margin`` of every warp a HEAL / STAMP (each pyramid
    level, each present agent) or SiCP (each present sender into the ego,
    at the fused map) model makes on ``batch``."""
    from airv2x_tpu_torch.ops.warp import normalized_pairwise_affine

    with torch.inference_mode():
        feats = model.backbone(model.encode(batch))
    h, w = feats.shape[-2:]
    mask = batch["agent_mask"]
    margins = []
    if hasattr(model, "pyramid"):
        ds = model.grid_h // h
        ac = model.pyramid.align_corners
        for s in model.args["fusion_backbone"]["layer_strides"]:
            h, w = -(-h // s), -(-w // s)
            aff = normalized_pairwise_affine(batch["pairwise_t"], h, w,
                                             model.discrete_ratio, ds)
            margins.append(warp_footprint_margin(aff[mask], h, w, ac))
    else:
        cfg = model.sicp_cfg
        aff = normalized_pairwise_affine(
            batch["pairwise_t_full"][:, 0, 1:], h, w,
            cfg.get("voxel_size", [0.4])[0], cfg.get("downsample_rate", 2))
        margins.append(warp_footprint_margin(aff[mask[:, 1:]], h, w))
    return min(margins)


def tiny_hetero_hypes(hypes: dict, name: str, task: str = "det") -> dict:
    """The tiny config (``hypes``, loaded by either package) as the HEAL /
    STAMP / SiCP model ``name`` (TINY_HETERO) for ``task``, det or seg."""
    hypes = copy.deepcopy(hypes)
    hypes["model"]["core_method"] = name
    deep_merge(hypes["model"]["args"], TINY_HETERO[name])
    hypes["task"] = hypes["model"]["args"]["task"] = task
    return hypes


def tiny_family_hypes(hypes: dict, name: str, task: str = "det") -> dict:
    """The tiny config (``hypes``, loaded by either package) as the family
    model ``name`` (TINY_FAMILY) for ``task``, det or seg."""
    hypes = copy.deepcopy(hypes)
    hypes["model"]["core_method"] = name
    hypes["model"]["args"].update(copy.deepcopy(TINY_FAMILY[name]))
    hypes["task"] = hypes["model"]["args"]["task"] = task
    return hypes


def tiny_scope_hypes(resnet: bool = True, mode: str = "Deform") -> dict:
    """The tiny SCOPE config (TINY_SCOPE_ARGS) as ``load_yaml`` would give
    it: ``resnet`` picks the backbone, ``mode`` the aggregation."""
    args = copy.deepcopy(TINY_SCOPE_ARGS)
    args["base_bev_backbone"]["resnet"] = resnet
    args["fusion_args"]["agg_operator"]["mode"] = mode
    return {
        "model": {"core_method": "point_pillar_scope", "args": args},
        "preprocess": {"cav_lidar_range": list(TINY_SCOPE_RANGE),
                       "args": {"voxel_size": [0.4, 0.4, 4],
                                "max_voxel_train": 512,
                                "max_points_per_voxel": 8}},
        "postprocess": {
            "anchor_args": {"cav_lidar_range": list(TINY_SCOPE_RANGE),
                            "l": 3.9, "w": 1.6, "h": 1.56, "r": [0, 90],
                            "feature_stride": 2, "num": 2, "vw": 0.4,
                            "vh": 0.4, "vd": 4, "W": 64, "H": 64, "D": 1},
            "target_args": {"score_threshold": 0.2, "obj_threshold": 0.2},
            "nms_thresh": 0.15, "max_num": 20},
    }


def scope_scene(rng, layout, frames, lidar_range, pose_rng=None, **scene_kw):
    """One SCOPE scene, numpy, batch 1: points / points_mask / agent_mask /
    pairwise_t_full stacked on a time axis (the last frame current) and
    history_t (1, frames, 4, 4). ``scene_kw`` goes to ``make_scene``.

    Without ``pose_rng`` as ``tools/bench_workloads.py`` builds
    ``temporal_det``: one ``make_scene`` frame repeated, identity history.
    With it, ``frames`` distinct ``make_scene`` draws from ``rng`` (their
    poses are the identity) and, from ``pose_rng``, each earlier frame's
    ``history_t`` and every frame's ego row of ``pairwise_t_full`` (slots
    1..) a rotation about z of up to PERTURB_MAX_DEG degrees and an xy shift
    of up to PERTURB_MAX_SHIFT metres, so that both warps move features."""
    from airv2x_tpu_torch.data.synthetic import (
        PERTURB_MAX_DEG, PERTURB_MAX_SHIFT, make_scene)

    def pose():
        yaw = np.deg2rad(pose_rng.uniform(-PERTURB_MAX_DEG, PERTURB_MAX_DEG))
        m = np.eye(4, dtype=np.float32)
        m[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        m[:2, 3] = pose_rng.uniform(-PERTURB_MAX_SHIFT, PERTURB_MAX_SHIFT, 2)
        return m

    draws = [make_scene(rng, layout, lidar_range=lidar_range, **scene_kw)[0]
             for _ in range(1 if pose_rng is None else frames)]
    draws = draws * (frames // len(draws))
    keys = ("points", "points_mask", "agent_mask", "pairwise_t_full")
    batch = {k: np.stack([d[k] for d in draws])[None] for k in keys}
    batch["history_t"] = np.broadcast_to(
        np.eye(4, dtype=np.float32), (1, frames, 4, 4)).copy()
    if pose_rng is not None:
        for t in range(frames - 1):
            batch["history_t"][0, t] = pose()
        for t in range(frames):
            for j in range(1, layout.total):
                batch["pairwise_t_full"][0, t, 0, j] = pose()
    return batch


def scope_margins(model, batch):
    """One run of a SCOPE ``model`` on ``batch`` with hooks on its comm and
    deformable fusion -> (margins, {"masks": the comm masks, "queries": each
    level's query cells}, outputs). Margins: "comm",
    the smallest distance of a thresholded slot's smoothed confidence (the
    odd slots present; the even ones send their whole map) from the comm
    threshold; "topk", the smallest gap between the K-th and (K+1)-th query
    score of any level over the level's largest |score|. Either could
    decide the two sides of a comparison apart when it is small."""
    comm, scores = {}, []
    hooks = [model.naive_communication.register_forward_hook(
        lambda mod, args, out: comm.update(args=args, out=out))]
    hooks += [m.register_forward_hook(
        lambda mod, args, out: scores.append((mod.num_queries, args[1])))
        for m in model.fuse_modules]
    try:
        with torch.inference_mode():
            out = model(batch)
    finally:
        for h in hooks:
            h.remove()
    agent_mask = comm["args"][1]
    masks, _, smooth = comm["out"]
    dist = (smooth.float() - model.naive_communication.thre).abs()[:, 1::2]
    present = agent_mask[:, 1::2]
    margins = {"comm": float(dist[present].min()) if present.any() else 1.0,
               "topk": 1.0}
    queries = []
    for nq, psm in scores:
        s, order = torch.sort(psm.sum(1).flatten(1), dim=1, descending=True,
                              stable=True)
        queries.append(order[:, :nq])
        if nq < s.shape[1]:
            s = s.float()
            gap = (s[:, nq - 1] - s[:, nq]) / s.abs().amax(1)
            margins["topk"] = min(margins["topk"], float(gap.min()))
    return margins, {"masks": masks, "queries": queries}, out


def _conv_ops(maps, hw_out, cin, cout, k):
    return 2 * maps * hw_out[0] * hw_out[1] * cout * cin * k * k


def _down(hw, stride):
    """Output size of a 3x3 (padding 1) or 1x1 conv of ``stride``."""
    return tuple((v - 1) // stride + 1 for v in hw)


def scope_ops(hypes, n_points: int) -> dict:
    """Operations (2 per multiply-add) of one SCOPE scene's convolutions and
    Linears, by part, from the configuration's shapes: ``max_cav`` agents,
    ``fusion_args.frame`` frames, ``n_points`` point slots per cloud (the
    PFN's Linear runs on every slot), batch 1. The backbone part counts each frame's
    pass and the collaboration's rerun of the stages on the current frame.
    The bilinear sampling, the BatchNorms and the elementwise work are
    left out."""
    args = hypes["model"]["args"]
    fa, pv = args["fusion_args"], args["pillar_vfe"]
    bb, shrink = args["base_bev_backbone"], args["shrink_header"]
    pre = hypes["preprocess"]
    lr, vs = pre["cav_lidar_range"], pre["args"]["voxel_size"]
    grid = (int(round((lr[4] - lr[1]) / vs[1])), int(round((lr[3] - lr[0]) / vs[0])))
    l, t = int(args["max_cav"]), int(fa["frame"])
    c0 = int(pv["num_filters"][0])
    parts = dict.fromkeys(("pillar PFN", "backbone", "shrink", "temporal LSTM",
                           "deformable attention", "heads"), 0)
    # every point slot, and the zero row of the padding floor, per frame
    parts["pillar PFN"] = 2 * t * (l * n_points + 1) * 10 * c0

    def stage_ops(maps, hw, cin, f, n, s):
        """(operations, output size) of one backbone stage."""
        out = _down(hw, s)
        if bb.get("resnet"):
            ops = _conv_ops(maps, out, cin, f, 3) + _conv_ops(maps, out, f, f, 3)
            if s != 1 or cin != f:
                ops += _conv_ops(maps, out, cin, f, 1)
            ops += (n - 1) * 2 * _conv_ops(maps, out, f, f, 3)
        else:
            ops = _conv_ops(maps, out, cin, f, 3) + n * _conv_ops(maps, out, f, f, 3)
        return ops, out

    levels, hw, cin = [], grid, int(bb.get("inplanes", c0))
    for f, n, s, uf, us in zip(bb["num_filters"], bb["layer_nums"],
                               bb["layer_strides"], bb["num_upsample_filter"],
                               bb["upsample_strides"]):
        ops, hw = stage_ops(1, hw, cin, f, n, s)
        deblock = 2 * hw[0] * hw[1] * f * uf * us * us
        parts["backbone"] += (t * l + l) * ops + (t * l + 1) * deblock
        levels.append((f, hw))
        cin = f
    hw2 = (levels[0][1][0] * bb["upsample_strides"][0],
           levels[0][1][1] * bb["upsample_strides"][0])
    cin = sum(bb["num_upsample_filter"])
    for d, k, s in zip(shrink["dim"], shrink["kernal_size"], shrink["stride"]):
        hw2 = _down(hw2, s)
        parts["shrink"] += (t * l + 1) * (_conv_ops(1, hw2, cin, d, k)
                                          + _conv_ops(1, hw2, d, d, 3))
        cin = d
    a = int(args["anchor_number"]) * int(args.get("num_class", 1))
    reg = 7 * int(args["anchor_number"])
    # the slots' cls and reg, the temporal and cross cls, the final cls + reg
    parts["heads"] = (_conv_ops(l + 1, hw2, cin, a + reg, 1)
                      + _conv_ops(2, hw2, cin, a, 1))

    tf = fa["temporal_fusion"]
    c, cs = int(tf["channel"]), 64
    r = max(1, int((c / cs) ** 0.5))
    lstm = _conv_ops(1, hw2, 2, 1, 7)
    if cs != c:
        lstm += _conv_ops(t, hw2, c, r * cs, 3) + _conv_ops(t, hw2, r * cs, cs, 3)
        lstm += _conv_ops(1, hw2, cs, r * cs, 3) + _conv_ops(1, hw2, r * cs, c, 3)
    h1, h2 = _down(hw2, 2), _down(_down(hw2, 2), 2)
    stpn = (_conv_ops(1, h1, cs, 2 * cs, 3) + _conv_ops(1, h1, 2 * cs, 2 * cs, 3)
            + _conv_ops(1, h2, 2 * cs, 4 * cs, 3) + _conv_ops(1, h2, 4 * cs, 4 * cs, 3)
            + _conv_ops(1, h1, 6 * cs, 2 * cs, 3) + _conv_ops(1, h1, 2 * cs, 2 * cs, 3)
            + _conv_ops(1, hw2, 3 * cs, cs, 3) + _conv_ops(1, hw2, cs, cs, 3))
    parts["temporal LSTM"] = lstm + 8 * (t - 1) * stpn

    if fa["agg_operator"]["mode"] == "Deform":
        nq, heads, pts, dh = int(fa.get("num_queries", 500)), 8, 9, 64
        for f, (h, w) in levels:
            k = min(nq, h * w)
            parts["deformable attention"] += 2 * (
                l * h * w * f * heads * dh  # value_proj
                + k * f * heads * l * pts * 3  # sampling offsets, weights
                + k * heads * dh * f + k * 2 * f  # output_proj, pos_embedding
                + 2 * k * f * 256)  # the feed-forward
    return parts


# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 and TF32
# tensor-core and non-tensor-core f32 operations/s.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
F32_OPS_PER_S = 67e12
# f32 operations per (i, j) pair in csrc/quad_iou.cu, counted from the
# source on its cheapest (entering) branch, a division counted as one:
# centring 16, two signed areas 32, signs / abs / tolerance 9, two clip sums
# of 4 edges x (5 + 4 half-planes x 17 + 9) = 656, the IoU 9.
K2_OPS_PER_PAIR = 722
# f32 operations of K2's prefilter per pair (csrc/quad_iou.cu:separated):
# the gap 7, tol2 4, the margin 9, the test 3
K2_PREFILTER_OPS = 23
# the flagship backbone's stride-1 layer shapes (6 maps, NHWC)
K4_STAGES = ((6, 100, 352, 64), (6, 50, 176, 128), (6, 25, 88, 256))

# csrc/pillar_encode.cu's kernels, by name in a profile
K1_KERNELS = ("k1_leader_kernel", "k1_scatter_kernel", "k1_epilogue_kernel")
# the port's kernels on the serving paths (K1, K2, K4), launched through
# ctypes: by name in a profile
PORT_KERNELS = K1_KERNELS + ("quad_iou_kernel", "conv3x3_wgmma_kernel")
K1_TOL = 1e-4  # f32: only the order of the atomic residual sums differs
# bf16 output, absolute plus relative: one bf16 rounding (2^-8 relative)
# of values that agree in f32 to K1_TOL
K1_TOL_BF16 = 1e-2
K2_TOL = 2e-5  # as tests/test_pallas_iou.py
K3_TOL = 1e-4  # relative, the sums: only the order of the atomic adds
K4_TOL = 1e-4  # x (1 + scale), f32: sums in another order, no TF32
K4_TOL_BF16 = 2e-2  # abs + rel, as tests/test_pallas_conv.py
TINY_TOL = 1e-4  # whole-model outputs through ~40 conv layers, f32
# phase 13, one loaded batch card against CPU: the anchor targets are logs
# and quotients of boxes whose corners come from sin / cos, which the card's
# math library may round apart from the CPU's in the last bit
BATCH_TARGET_TOL = 1e-6
# phase 4b, card against CPU, f32: the port's f32 gradients lie within
# 1.1e-5 of a leaf's scale (its largest |g|) from float64 on the CPU tests;
# the bound allows 2e-3 of the leaf's scale plus 2e-4 of the step's largest
# gradient. Loss parts 1e-5 relative; BN statistics 1e-5 x (1 + |v|); the
# first Adam step moves each parameter by about +-lr: 1e-6 x (1 + |p|)
# where the CPU gradient clears twice the gradient bound, else 2 lr.
STEP_LOSS_TOL = 1e-5
STEP_GRAD_TOL, STEP_GRAD_FLOOR = 2e-3, 2e-4
# the tiny When2com's train step in float64, one package against the other
# or the card against the CPU: its warp's sample grid is an f32 island in
# both, and a one-ulp change there moves the model's float64 gradients by
# 2.2e-2 of a leaf's scale (tests/train_reference_probes.py); the bound is
# 5e-2 of the leaf's scale plus 1e-9 of the step's largest gradient (the
# conv biases that a train-mode BN follows, and the key net's last bias,
# have exact gradient 0 and read rounding noise)
WHEN2COM_F64_GRAD_TOL, WHEN2COM_F64_GRAD_FLOOR = 5e-2, 1e-9
TRAIN_BATCH = 2  # train_params.batch_size of both flagship YAMLs
N_TRAIN_BATCHES = 4  # distinct batches the timed steps cycle through
TRAIN_STEPS = 10  # timed, after a warm-up of 2
REPEAT_STEPS = 20  # one batch, for the falling loss (``loss_fell``)
# the repeats' lr over the schedule's: at the YAMLs' own (Adam, lr 0.002,
# eps 1e-10) a sound full-width model's loss on one batch can rise for 16
# steps (When2com in f32: 7.50 -> 9.84 with its gradients checked against
# the loss); at a tenth every config fell (tests/train_card_probes.py)
REPEAT_LR_SCALE = 0.1
REPEAT_DROP = 0.05  # the second half's median below the least of the first 3
REPEAT_BATCHES = 2  # batches the repeated-batch check may take, one by one
REPEAT_KEEP = 0.5  # Where2comm's keep fraction on every repeat


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls. A spin
    kernel holds the card while the host enqueues the calls, so the events
    time the device's work and not the host's launch cost (which can exceed
    a short kernel's run time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda._sleep(int(2e9 * (1.5 * iters * host_s + 1e-3)))  # ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


@contextlib.contextmanager
def conv_mode(mode: str):
    """Run the block under ``AIRV2X_CONV_KERNEL=mode``."""
    old = os.environ.get("AIRV2X_CONV_KERNEL")
    os.environ["AIRV2X_CONV_KERNEL"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["AIRV2X_CONV_KERNEL"]
        else:
            os.environ["AIRV2X_CONV_KERNEL"] = old


def host_us(fn, iters: int = 50) -> float:
    """Host microseconds per call of ``fn`` (launch cost: no sync inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def phase_build():
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.ops.conv3x3 import conv3x3_plan

    print(smi("name,power.limit"))
    print(f"device {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; host {os.cpu_count()} CPUs, torch "
          f"{torch.get_num_threads()} threads (the full-width CPU forwards of "
          "phases 11, 12 and 15)")
    t0 = time.perf_counter()
    logs = kernels.build_all()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(logs)}")
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                # conv3x3_wgmma_kernel<F32, WG, MR, BN>: ..ILb1ELi2ELi1ELi64EE..
                if "wgmma_kernel" in entry:
                    args = entry.split("wgmma_kernelI", 1)[1].split("EE")[0]
                    args = args.replace("Lb0", "bf16E").replace("Lb1", "f32E")
                    entry = "conv3x3_wgmma_kernel<%s>" % ", ".join(
                        a for a in args.replace("Li", "").split("E") if a)
            if "Used" in line:
                print(f"  {name}: {entry[:60]}: {line.strip()}")
    for shape, dt, allmaps in itertools.product(
            K4_STAGES, (torch.bfloat16, torch.float32), (False, True)):
        b, h, w, c = shape
        p = conv3x3_plan(b, h, w, c, c, dt, allmaps)
        name = "bf16" if dt == torch.bfloat16 else "f32"
        print(f"  K4{'b' if allmaps else 'a'} {name} plan {shape}: "
              f"{p.maps} map(s) x {p.tile_h}x{p.tile_w} pixels x "
              f"{p.block_n} outputs, kernel <{p.wgs}, {p.mr}, "
              f"{p.block_n}>, rings A {p.a_stages} / B {p.b_stages}, "
              f"{p.n_blocks} blocks, {p.smem_bytes} B dynamic smem")


def cut_hypes(path: str) -> dict:
    """A config with ``max_cav`` cut to the benchmarked scene."""
    from airv2x_tpu_torch.config import load_yaml

    hypes = load_yaml(path)
    hypes["model"]["args"]["max_cav"] = dict(NUM_AGENTS)
    hypes["train_params"]["max_cav"] = dict(NUM_AGENTS)
    return hypes


def shallow_hypes(hypes: dict) -> dict:
    """A copy of a full-width config at one layer per backbone stage, one
    transformer block and one fusion round (``layer_nums``, ``depth``,
    ``num_iteration`` anywhere in the model args), its widths unchanged:
    the card-vs-CPU comparisons of phases 11 and 15 run it, since the CPU's
    forward of the whole depth left the card idle for over a minute."""
    import copy

    hypes = copy.deepcopy(hypes)

    def walk(d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "layer_nums":
                d[k] = [1] * len(v)
            elif k in ("depth", "num_iteration") and isinstance(v, int):
                d[k] = 1

    walk(hypes["model"]["args"])
    return hypes


def lidar_scenes(hypes, layout):
    """The N_SCENES ``make_scene`` scenes of the LiDAR paths (seed 0, 12
    objects, POINTS_PER_AGENT points per agent) on the card, and their
    ground truth."""
    from airv2x_tpu_torch.data.synthetic import batch_to_torch, make_scene

    rng = np.random.default_rng(0)
    scenes, gts = [], []
    for _ in range(N_SCENES):
        b, gt = make_scene(rng, layout, num_objects=12,
                           num_agents=NUM_AGENTS,
                           points_per_agent=POINTS_PER_AGENT,
                           lidar_range=hypes["preprocess"]["cav_lidar_range"],
                           pts_per_box=100)
        scenes.append(batch_to_torch({k: v[None] for k, v in b.items()}, "cuda"))
        gts.append(gt)
    return scenes, gts


def flagship_setup():
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    hypes = cut_hypes(FLAGSHIP)
    model = init_random_(build_model(hypes, device="cuda"), seed=0)
    scenes, gts = lidar_scenes(hypes, model.layout)
    return hypes, model, scenes, gts


def k1_cases(ids, feat, aux, cells):
    """K1's three inputs at the vehicle call's shapes: the ``make_scene``
    call itself, a dense uniform cloud (every slot valid, ids uniform over
    the cells) and a hot cell (every point of a map in one cell). The two
    made-up clouds reuse the scene's valid point rows (features, weight and
    residuals), drawn with replacement."""
    rng = np.random.default_rng(5)
    m, n = ids.shape
    keep = (aux[..., 0] > 0).reshape(-1)
    src_feat = feat.reshape(m * n, -1)[keep]
    src_aux = aux.reshape(m * n, 4)[keep]
    pick = torch.from_numpy(rng.integers(0, len(src_feat), (m, n))).cuda()
    dense_feat = src_feat[pick].contiguous()
    dense_aux = src_aux[pick].contiguous()
    uniform = torch.from_numpy(
        rng.integers(0, cells, (m, n)).astype(np.int32)).cuda()
    hot = torch.from_numpy(np.repeat(
        rng.integers(0, cells, (m, 1)).astype(np.int32), n, axis=1)).cuda()
    return {"make_scene": (ids, feat, aux), "dense": (uniform, dense_feat,
                                                      dense_aux),
            "hot cell": (hot, dense_feat, dense_aux)}


def k1_bytes(ids, feat, aux, params, out_dtype, cells):
    """(bytes this input needs, bytes of every input tensor), each with the
    output written once. The first reads the feature and aux rows of the
    valid points only: a skipped point's id is all that must be read."""
    m, n = ids.shape
    c = feat.shape[-1]
    out = m * cells * c * torch.empty((), dtype=out_dtype).element_size()
    valid = int(((ids >= 0) & (ids < cells)).sum())
    fixed = ids.numel() * 4 + params.numel() * 4 + out
    return fixed + valid * (c + 4) * 4, fixed + m * n * (c + 4) * 4


def device_us_by_kernel(fn, iters: int = 20) -> dict:
    """Device microseconds per call of each kernel (and memset) that ``fn``
    launches, from a torch.profiler window over ``iters`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us > 0:
            name = e.key.removeprefix("void ").replace(
                "(anonymous namespace)::", "")
            out[name.split("(")[0].strip()] = round(us / iters, 2)
    return out


def phase_k1(model, scene):
    """K1 against its plain version at three inputs of the vehicle call's
    shapes, f32 and bf16 output: the values within tolerance, every empty
    cell +0.0 bits; device times of both, the bound and the share of it."""
    from airv2x_tpu_torch.ops.pillar_encode import (
        pillar_encode, pillar_encode_plain)

    set_tf32(False)
    enc = model.encoder.vehicle_pillar_vfe  # f32 weights at this point
    sl = model.layout.slots("vehicle")
    with torch.inference_mode():
        ids, feat, aux, params, kw = enc.kernel_inputs(
            scene["points"][:, sl], scene["points_mask"][:, sl])
    m, n = ids.shape
    c, cells = feat.shape[-1], kw["cells"]
    assert (m, n, c, cells) == (3, POINTS_PER_AGENT, 64, 140800), (m, n, c, cells)
    res = {}
    for case, (cid, cfeat, caux) in k1_cases(ids, feat, aux, cells).items():
        valid = (cid >= 0) & (cid < cells)
        flat = (cid.long() + torch.arange(m, device="cuda")[:, None] * cells)
        occupied = torch.zeros(m * cells, dtype=torch.bool, device="cuda")
        occupied[flat[valid]] = True
        occupied = occupied.view(m, cells)
        for dt in (torch.float32, torch.bfloat16):
            kw["out_dtype"] = dt
            args = (cid, cfeat, caux, params)
            got = pillar_encode(*args, **kw)
            ref = pillar_encode_plain(*args, **kw)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs()
            err = float(diff.max())
            if dt == torch.float32:
                ok = err <= K1_TOL
            else:
                ok = bool((diff <= K1_TOL_BF16 * (1 + ref.float().abs())).all())
            bits = got.view(torch.int32 if dt == torch.float32 else torch.int16)
            nonzero_empty = int((bits[~occupied] != 0).sum())
            tol = (f"{K1_TOL}" if dt == torch.float32
                   else f"{K1_TOL_BF16} x (1 + |plain|)")
            print(f"phase 2 K1 {case} out {dt}: max|kernel - plain| = "
                  f"{err:.3e} (tol {tol}); {int(valid.sum())} valid points, "
                  f"{int(occupied.sum())} occupied cells of {m * cells}; "
                  f"{nonzero_empty} empty-cell outputs not +0.0")
            if not ok or nonzero_empty:
                raise AssertionError(f"K1 {case} {dt} disagrees with its "
                                     f"plain version: {err}, "
                                     f"{nonzero_empty} empty-cell outputs")
            ms = cuda_ms(lambda: pillar_encode(*args, **kw), 50)
            plain_ms = cuda_ms(lambda: pillar_encode_plain(*args, **kw), 10)
            need, whole = k1_bytes(cid, cfeat, caux, params, dt, cells)
            bound_ms = need / HBM_BYTES_PER_S * 1e3
            whole_ms = whole / HBM_BYTES_PER_S * 1e3
            print(f"phase 2 K1 {case} out {dt}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({need} bytes: "
                  f"ids, params, the valid points' rows, the output), share "
                  f"{bound_ms / ms:.3f}; bound of every input tensor read "
                  f"whole {whole_ms:.4f} ms, share {whole_ms / ms:.3f}")
            print(f"phase 2 K1 {case} out {dt}: device us per call by kernel "
                  "(torch.profiler, 20 calls): " + json.dumps(
                      device_us_by_kernel(lambda: pillar_encode(*args, **kw))))
            if case == "make_scene":  # the output's bytes written alone
                fill_ms = cuda_ms(lambda: got.zero_(), 50)
                print(f"phase 2 K1 out {dt}: zero_() of an output-sized tensor "
                      f"{fill_ms:.4f} ms")
            res[(case, dt)] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms)
    return res


def k2_quads(hypes, gts):
    """Corners of decoded boxes around the scenes' objects, plus random
    quads: 512 rows, overlapping in clusters as NMS candidates do."""
    from airv2x_tpu_torch.ops import geometry as geo
    from airv2x_tpu_torch.ops.anchors import generate_anchor_grid
    from airv2x_tpu_torch.ops.boxes import decode_boxes

    rng = np.random.default_rng(1)
    anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    lr = hypes["preprocess"]["cav_lidar_range"]
    h, w = anchors.shape[:2]
    centres = np.concatenate([g["boxes"][g["mask"]][:, :2] for g in gts])
    rows = []
    for cx, cy in centres:  # anchors at and around each object
        iy = int(np.clip((cy - lr[1]) / (lr[4] - lr[1]) * h, 0, h - 1))
        ix = int(np.clip((cx - lr[0]) / (lr[3] - lr[0]) * w, 0, w - 1))
        for dy, dx in ((0, 0), (0, 1), (1, 0)):
            rows.append(anchors[min(iy + dy, h - 1), min(ix + dx, w - 1)])
    anc = np.concatenate(rows)[:400]
    deltas = rng.normal(0, 0.05, anc.shape).astype(np.float32)
    boxes = decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anc))
    rand = np.stack([
        rng.uniform(lr[0], lr[3], 512), rng.uniform(lr[1], lr[4], 512),
        np.full(512, -1.0), rng.uniform(1.4, 1.8, 512),
        rng.uniform(1.5, 1.9, 512), rng.uniform(3.5, 4.5, 512),
        rng.uniform(-np.pi, np.pi, 512)], -1).astype(np.float32)
    boxes = torch.cat([boxes, torch.from_numpy(rand)])[:TOP_K]
    boxes[1] = boxes[0]  # an identical pair
    quads = geo.boxes_to_corners_3d(boxes)[:, :4, :2].contiguous()
    return quads[torch.from_numpy(rng.permutation(TOP_K))].contiguous().cuda()


def k2_check(label, q):
    """K2 on the (K, 4, 2) quads ``q`` against its plain version, full and
    triangular, then the times of both modes and of the plain version, the
    prefilter's survivor share and the bounds."""
    from airv2x_tpu_torch.ops.quad_iou import (
        _separated, quad_iou, quad_iou_plain)

    k = q.shape[0]
    ref = quad_iou_plain(q, q)
    full = quad_iou(q, q)
    tri = quad_iou(q, q, triangular=True)
    torch.cuda.synchronize()
    iu = torch.triu_indices(k, k, offset=1, device=q.device)
    err_full = float((full - ref).abs().max())
    err_tri = float((tri - ref)[iu[0], iu[1]].abs().max())
    overl = int((ref[iu[0], iu[1]] > 0).sum())
    pairs = iu.shape[1]  # the upper triangle NMS reads
    survivors = int((~_separated(q, q))[iu[0], iu[1]].sum())
    print(f"{label}: max|kernel - plain| full {err_full:.3e}, triangular "
          f"(i < j) {err_tri:.3e} (tol {K2_TOL}); {overl} overlapping pairs "
          f"of {pairs}; prefilter survivors {survivors} of {pairs} (share "
          f"{survivors / pairs:.4f})")
    err = max(err_full, err_tri)
    if not err <= K2_TOL:
        raise AssertionError(f"{label}: K2 disagrees with its plain version: "
                             f"{err}")
    ms = cuda_ms(lambda: quad_iou(q, q, triangular=True), 200)
    ms_full = cuda_ms(lambda: quad_iou(q, q), 200)
    plain_ms = cuda_ms(lambda: quad_iou_plain(q, q), 20)
    ops_ms = pairs * K2_OPS_PER_PAIR / F32_OPS_PER_S * 1e3
    bytes_ms = (2 * q.numel() * 4 + k * k * 4) / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    need_ms = max((pairs * K2_PREFILTER_OPS + survivors * K2_OPS_PER_PAIR)
                  / F32_OPS_PER_S * 1e3, bytes_ms)
    print(f"{label}: kernel triangular {ms:.4f} ms, full {ms_full:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms (every pair "
          f"clipped: operations {ops_ms:.5f} ms, bytes {bytes_ms:.5f} ms), "
          f"share {bound_ms / ms:.3f}; bound of the work this input needs "
          f"(the prefilter on every pair, the clip on the survivors, at "
          f"least the bytes) {need_ms:.5f} ms, share {need_ms / ms:.3f}")
    return dict(err=err, ms=ms, ms_full=ms_full, plain_ms=plain_ms,
                bound_ms=bound_ms, need_ms=need_ms,
                survivor_share=survivors / pairs,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def phase_k2(hypes, gts):
    return k2_check("phase 3 K2", k2_quads(hypes, gts))


def phase_k2_scene(run, scene):
    """K2 on the quads NMS hands it in one det scene: the top-512 corners
    ``decode_detections`` passes to ``rotated_nms``, caught on their way
    to ``quad_iou`` in one more run of ``scene``."""
    from airv2x_tpu_torch.ops import nms

    caught = []

    def catch(c1, c2, **kw):
        caught.append(c1.clone())
        return real(c1, c2, **kw)

    real = nms.quad_iou
    nms.quad_iou = catch
    try:
        run(scene, no_mark)
    finally:
        nms.quad_iou = real
    torch.cuda.synchronize()
    (q,) = caught
    return k2_check("phase 5 K2 on scene 0's NMS input", q)


def degenerate_quads(g):
    """A zero-width quad (two coincident corner pairs, 4 m long) and a
    point quad, both at the centre of the quad ``g`` (4, 2)."""
    c = g.mean(0)
    ends = torch.stack([c - g.new_tensor([2.0, 0.0]), c + g.new_tensor([2.0, 0.0])])
    return torch.stack([ends[[0, 1, 1, 0]], c.expand(4, 2)])


def phase_ap_k2(label, caught):
    """K2 on the (det, gt) corners ``eval/ap.py`` handed ``quad_iou`` in
    phase 13's counted runs (kept dets x valid gts: rectangular, ragged
    against the tile), each with a zero-width and a point quad on its first
    gt appended to the dets, against its plain version: within K2_TOL, and
    those two rows exactly 0 on both sides. Then the kernel's and the plain
    version's times at the largest pair."""
    from airv2x_tpu_torch.ops.quad_iou import quad_iou, quad_iou_plain

    if not caught:
        raise AssertionError(f"{label}: the AP handed K2 nothing")
    err = 0.0
    for det, gt in caught:
        d = torch.cat([det, degenerate_quads(gt[0])]).contiguous()
        got, ref = quad_iou(d, gt), quad_iou_plain(d, gt)
        err = max(err, float((got - ref).abs().max()))
        if (got[-2:] != 0).any() or (ref[-2:] != 0).any():
            raise AssertionError(f"{label}: a degenerate quad overlaps a gt: "
                                 f"kernel {got[-2:]}, plain {ref[-2:]}")
    rows = [d.shape[0] for d, _ in caught]
    cols = [g.shape[0] for _, g in caught]
    det, gt = max(caught, key=lambda p: p[0].shape[0] * p[1].shape[0])
    ms = cuda_ms(lambda: quad_iou(det, gt), 50)
    plain_ms = cuda_ms(lambda: quad_iou_plain(det, gt), 10)
    print(f"{label}: {len(caught)} (det, gt) pairs, dets {min(rows)}-{max(rows)}, "
          f"gts {min(cols)}-{max(cols)}, each with 2 degenerate dets (rows 0 "
          f"on both sides); max|kernel - plain| {err:.3e} (tol {K2_TOL}); at "
          f"the largest, {det.shape[0]} x {gt.shape[0]}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    if not err <= K2_TOL:
        raise AssertionError(f"{label}: K2 disagrees with its plain version: "
                             f"{err}")
    return dict(pairs=len(caught), err=err, largest=[det.shape[0], gt.shape[0]],
                ms=ms, plain_ms=plain_ms)


def phase_k3():
    """K3 at the flagship vehicle call, on random ids that include the dump
    row and values with a share of maxima at -1e9 (as
    tests/test_fast_pillars.py builds them)."""
    from airv2x_tpu_torch.ops.pillar_reduce import (
        FEAT, LANES, NEG, pillar_reduce, pillar_reduce_plain)

    m, n, cells = 3, POINTS_PER_AGENT, 140800
    rng = np.random.default_rng(3)
    ids = rng.integers(0, cells + 1, (m, n)).astype(np.int32)
    vals = rng.normal(size=(m, n, LANES)).astype(np.float32)
    vals[..., :FEAT] = np.where(rng.uniform(size=(m, n, 1)) > 0.2,
                                vals[..., :FEAT], NEG)
    ids, vals = torch.from_numpy(ids).cuda(), torch.from_numpy(vals).cuda()
    got = pillar_reduce(ids, vals, cells)
    ref = pillar_reduce_plain(ids, vals, cells)
    torch.cuda.synchronize()
    max_exact = bool(torch.equal(got[..., :FEAT], ref[..., :FEAT]))
    sums = (got[..., FEAT:] - ref[..., FEAT:]).abs()
    err = float(sums.max())
    rel = float((sums / (1 + ref[..., FEAT:].abs())).max())
    print(f"phase 3a K3: max lanes exact {max_exact}; sum lanes max|kernel - "
          f"plain| {err:.3e}, relative {rel:.3e} (tol {K3_TOL}); "
          f"{int((got[:, :cells, FEAT] > 0).sum())} occupied rows")
    if not (max_exact and rel <= K3_TOL):
        raise AssertionError(f"K3 disagrees with its plain version: {rel}")
    ms = cuda_ms(lambda: pillar_reduce(ids, vals, cells), 50)
    plain_ms = cuda_ms(lambda: pillar_reduce_plain(ids, vals, cells), 10)
    in_bytes = ids.numel() * 4 + vals.numel() * 4
    out_bytes = got.numel() * 4
    bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"phase 3a K3: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms (bytes: {in_bytes} in + {out_bytes} out)")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)


def k4_bound(shape, cout, dtype):
    """(bound ms, ops ms, bytes ms) of one launch: each input read once,
    the output written once; 2 * 9 * Cin operations per output. In f32 the
    operations bound is the smaller of the FMA bound (67 TFLOP/s) and the
    3xTF32 tensor-core bound (3 products at 495 TFLOP/s), which the kernel
    runs."""
    b, h, w, c = shape
    item = torch.empty((), dtype=dtype).element_size()
    ops = 2.0 * b * h * w * 9 * c * cout
    nbytes = (b * h * w * (c + cout) + 9 * c * cout) * item + 8 * cout
    if dtype == torch.bfloat16:
        ops_ms = ops / BF16_OPS_PER_S * 1e3
    else:
        ops_ms = min(ops / F32_OPS_PER_S, 3 * ops / TF32_OPS_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms


def phase_k4(launches_per_stage):
    """K4a and K4b at each flagship backbone stage against the plain
    version, with the library call for the same function: the auto-mode
    ConvBNReLU (cuDNN conv, then BN and ReLU) holding the same weights."""
    from airv2x_tpu_torch.models.nn import ConvBNReLU
    from airv2x_tpu_torch.ops.conv3x3 import conv3x3_same, conv3x3_same_plain
    from airv2x_tpu_torch.utils.weights import cast_weights_, init_random_

    torch.backends.cudnn.benchmark = True
    rng = np.random.default_rng(4)
    res = {}
    for si, shape in enumerate(K4_STAGES):
        b, h, w, c = shape
        x32 = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
        for dt in (torch.bfloat16, torch.float32):
            set_tf32(False)
            blk = init_random_(ConvBNReLU(c, c), seed=10 + si).cuda().eval()
            blk.requires_grad_(False)
            cast_weights_(blk, dt)
            x = x32.to(dt)
            wk, sc, bi, packed = blk._fold(dt)
            args = (x, wk, sc, bi)
            kw = dict(relu=True, packed=packed)  # as ConvBNReLU calls it
            ref = conv3x3_same_plain(*args, relu=True)
            scale = float(ref.float().abs().max())
            errs = {}
            for allmaps in (False, True):
                got = conv3x3_same(*args, allmaps=allmaps, **kw)
                torch.cuda.synchronize()
                d = (got.float() - ref.float()).abs()
                errs[allmaps] = float(d.max())
                if dt == torch.float32:
                    ok = errs[allmaps] <= K4_TOL * (1 + scale)
                else:
                    ok = bool((d <= K4_TOL_BF16 * (1 + ref.float().abs())).all())
                if not ok:
                    raise AssertionError(
                        f"K4 (allmaps={allmaps}) {shape} {dt} disagrees with "
                        f"its plain version: {errs[allmaps]}")
            xl = x.permute(0, 3, 1, 2)  # NCHW, channels_last in memory
            with torch.inference_mode(), conv_mode("auto"):
                lib_err = float((blk(xl).permute(0, 2, 3, 1).float()
                                 - ref.float()).abs().max())
                lib_ms = cuda_ms(lambda: blk(xl), 20)
            ms_a = cuda_ms(lambda: conv3x3_same(*args, **kw), 20)
            ms_b = cuda_ms(lambda: conv3x3_same(*args, allmaps=True, **kw), 20)
            plain_ms = cuda_ms(lambda: conv3x3_same_plain(*args, relu=True), 10)
            bound_ms, ops_ms, bytes_ms = k4_bound(shape, c, dt)
            name = "bf16" if dt == torch.bfloat16 else "f32"
            print(f"phase 3b K4 {shape} {dt}: max|kernel - plain| K4a "
                  f"{errs[False]:.3e}, K4b {errs[True]:.3e} (scale {scale:.3f}; "
                  f"library - plain {lib_err:.3e}); ms K4a {ms_a:.4f}, K4b "
                  f"{ms_b:.4f}, plain {plain_ms:.4f}, library {lib_ms:.4f}, "
                  f"bound {bound_ms:.4f} (operations {ops_ms:.4f}, bytes "
                  f"{bytes_ms:.4f})")
            if dt == torch.float32:
                fma_ms = 2.0 * b * h * w * 9 * c * c / F32_OPS_PER_S * 1e3
                print(f"phase 3b K4 {shape} f32: bound without tensor cores "
                      f"(FMA) {fma_ms:.4f} ms, share K4a {fma_ms / ms_a:.3f}, "
                      f"K4b {fma_ms / ms_b:.3f}")
            us = host_us(lambda: conv3x3_same(*args, **kw))
            with torch.inference_mode(), conv_mode("auto"):
                lib_us = host_us(lambda: blk(xl))
            print(f"phase 3b K4 {shape} {name}: share of bound K4a "
                  f"{bound_ms / ms_a:.3f}, K4b {bound_ms / ms_b:.3f}; "
                  f"time / library K4a {ms_a / lib_ms:.3f}, K4b "
                  f"{ms_b / lib_ms:.3f}; host us per call: conv3x3_same "
                  f"{us:.1f}, cuDNN ConvBNReLU {lib_us:.1f}")
            res[(si, dt)] = dict(err_a=errs[False], err_b=errs[True],
                                 ms_a=ms_a, ms_b=ms_b, plain_ms=plain_ms,
                                 lib_ms=lib_ms, bound_ms=bound_ms,
                                 ops_ms=ops_ms, bytes_ms=bytes_ms)
            del blk, x, args, ref
    # per scene of 32 launches at launches_per_stage launches per stage: the
    # bf16 main path in pallas mode, and the f32 parity path of phase 4a
    out = {}
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        per_scene = {}
        for key in ("ms_a", "ms_b", "plain_ms", "lib_ms", "bound_ms",
                    "ops_ms", "bytes_ms"):
            per_scene[key] = sum(n * res[(si, dt)][key]
                                 for si, n in enumerate(launches_per_stage))
        print(f"phase 3b K4 per scene of {sum(launches_per_stage)} launches "
              f"at {list(launches_per_stage)} per stage, {name}, ms: "
              + json.dumps({k: round(v, 4) for k, v in per_scene.items()}))
        print(f"phase 3b K4 per scene, {name}: share of bound K4a "
              f"{per_scene['bound_ms'] / per_scene['ms_a']:.3f}, K4b "
              f"{per_scene['bound_ms'] / per_scene['ms_b']:.3f}; time / "
              f"library K4a {per_scene['ms_a'] / per_scene['lib_ms']:.3f}, "
              f"K4b {per_scene['ms_b'] / per_scene['lib_ms']:.3f}")
        per_scene["err_a"] = max(res[(si, dt)]["err_a"] for si in range(3))
        per_scene["err_b"] = max(res[(si, dt)]["err_b"] for si in range(3))
        out[name] = per_scene
    return out


def staged(model, batch, psm=None):
    """encode / single_psm / fuse of one batch; ``psm`` replaces this
    model's single-agent confidence so that two backends fuse with the same
    comm mask (a confidence within rounding of the 0.01 threshold would
    otherwise decide the comparison)."""
    with torch.inference_mode():
        x = model.encode(batch)
        own = model.single_psm(x)
        use = own if psm is None else psm.to(own.device, own.dtype)
        out = model.fuse(x, use, batch["agent_mask"])
    return own, out


def compare(label, got, want, keys, tol=TINY_TOL):
    errs, scales = {}, {}
    for k in keys:
        g, w = got[k].detach().cpu().double(), want[k].detach().cpu().double()
        errs[k] = float((g - w).abs().max())
        scales[k] = float(w.abs().max())
        lim = tol * (1 + scales[k])
        if not (bool(torch.isfinite(g).all()) and errs[k] <= lim):
            raise AssertionError(f"{label} {k}: {errs[k]} > {lim}")
    print(f"{label}: max abs err {errs} (tol {tol} x (1 + scale); scale "
          f"{scales})")
    return errs


def phase_tiny():
    """The tiny configs on the card against the same weights on the CPU."""
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import batch_to_torch, make_scene
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.models.base import SlotLayout
    from airv2x_tpu_torch.utils.weights import init_random_

    set_tf32(False)
    det = load_yaml(TINY)
    seg = copy.deepcopy(det)
    seg["task"] = seg["model"]["args"]["task"] = "seg"
    b, _ = make_scene(np.random.default_rng(2),
                      SlotLayout.from_args(det["model"]["args"]),
                      num_objects=6, points_per_agent=2048, pts_per_box=60,
                      lidar_range=det["preprocess"]["cav_lidar_range"])
    batch = {d: batch_to_torch({k: v[None] for k, v in b.items()}, d)
             for d in ("cpu", "cuda")}
    for name, hypes, mode, keys in (
            ("det auto", det, "auto", ("psm", "rm", "obj", "comm_rate")),
            ("det pallas", det, "pallas", ("psm", "rm", "obj", "comm_rate")),
            ("seg auto", seg, "auto",
             ("dynamic_seg", "static_seg", "comm_rate")),
            ("seg pallas", seg, "pallas",
             ("dynamic_seg", "static_seg", "comm_rate"))):
        models = {d: init_random_(build_model(hypes, device=d), seed=3)
                  for d in ("cpu", "cuda")}
        kernels.reset_launch_counts()
        with conv_mode(mode):
            psm_cpu, want = staged(models["cpu"], batch["cpu"])
            psm_card, got = staged(models["cuda"], batch["cuda"], psm_cpu)
        torch.cuda.synchronize()
        convs = kernels.LAUNCHES["conv3x3"]
        if (convs > 0) != (mode == "pallas"):
            raise AssertionError(f"tiny {name}: {convs} conv3x3 launches")
        compare(f"phase 4 tiny {name} card vs CPU ({convs} conv3x3 launches)",
                {"single": psm_card, **got}, {"single": psm_cpu, **want},
                ("single",) + keys)


def phase_f32_pallas(model, batch):
    """One flagship scene, f32 with TF32 off: ``pallas`` against ``auto``.

    cuDNN picks its f32 algorithms by its fixed heuristics here, not by
    timing, so the reference rounds the same way in every run. Checked:
    the single-agent confidence of all six agents (16 K4a launches on the
    scene's data), and psm / rm / obj of the scene with only the ego agent
    in ``agent_mask`` (32 launches), where the ego attention is the
    identity. With every agent present the attention's softmax over large
    random-weight scores amplifies any rounding difference: the fused
    outputs of ``pallas``, of ``im2col`` (the same BN fold, no kernel) and
    of ``auto`` with timing-picked algorithms are printed beside it, not
    checked. Both fusions take auto's confidence, so the comm mask is the
    same."""
    from airv2x_tpu_torch import kernels

    set_tf32(False)
    ego = dict(batch)
    ego["agent_mask"] = batch["agent_mask"].clone()
    ego["agent_mask"][:, 1:] = False
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        with conv_mode("auto"):
            psm_auto, want = staged(model, batch)
            _, want_ego = staged(model, ego)
        fused = {}
        for mode in ("pallas", "im2col"):
            kernels.reset_launch_counts()
            with conv_mode(mode):
                psm_mode, fused[mode] = staged(model, batch, psm_auto)
            if mode == "pallas":
                psm_kernel = psm_mode
                kernels.reset_launch_counts()
                with conv_mode(mode):
                    _, got_ego = staged(model, ego)
                torch.cuda.synchronize()
                n = kernels.LAUNCHES["conv3x3"]
        cudnn.benchmark, cudnn.deterministic = True, False
        with conv_mode("auto"):
            _, fused["auto, timing-picked algorithms"] = staged(
                model, batch, psm_auto)
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    print("phase 4a flagship f32, all agents, fused outputs against auto, "
          "max abs err (not checked): " + json.dumps(
              {name: {k: float((out[k] - want[k]).abs().max())
                      for k in ("psm", "rm", "obj")}
               for name, out in fused.items()}))
    compare("phase 4a flagship f32 pallas vs auto, all agents, single-agent "
            "confidence", {"single_psm": psm_kernel},
            {"single_psm": psm_auto}, ("single_psm",))
    compare(f"phase 4a flagship f32 pallas vs auto, ego agent only ({n} "
            "conv3x3 launches)", got_ego, want_ego, ("psm", "rm", "obj"))
    return n


class Marks:
    """Stage boundaries of one scene, for ``step(batch, mark)``: ``mark(name)``
    records a CUDA event and the host clock at the end of stage ``name``
    (the first point is the scene's start). A stage met more than once (the
    camera encoder's, once per agent type) sums its intervals."""

    def __init__(self):
        self.points = []
        self("start")

    def __call__(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.points.append((name, ev, time.perf_counter()))

    def stages(self):
        """({stage: device ms}, {stage: host ms}) after a synchronize."""
        dev, host = {}, {}
        for (_, e0, h0), (name, e1, h1) in zip(self.points, self.points[1:]):
            dev[name] = dev.get(name, 0.0) + e0.elapsed_time(e1)
            host[name] = host.get(name, 0.0) + (h1 - h0) * 1e3
        return dev, host


def no_mark(name):
    """The ``mark`` of an untimed run."""


def time_path(label, step, scenes, want, runs=N_RUNS):
    """Warm-up, then ``runs`` timed runs over ``scenes``. ``step(batch,
    mark)`` runs one scene and calls ``mark`` at its stage boundaries.
    Launch counts are reset just before the timed runs and must equal
    ``want`` (per scene) times the scenes run."""
    from airv2x_tpu_torch import kernels

    for batch in scenes:  # warm-up: allocator, cuDNN algorithm choice
        step(batch, no_mark)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    marks, run_ms = [], []
    kernels.reset_launch_counts()
    for r in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = []
        for batch in scenes:
            marks.append(Marks())
            outs.append(step(batch, marks[-1]))
        torch.cuda.synchronize()
        run_ms.append((time.perf_counter() - t0) / len(scenes) * 1e3)
        if r == 0:
            results = outs  # checked by the caller
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    per = [m.stages() for m in marks]
    stage_ms = {s: statistics.median(p[0][s] for p in per) for s in per[0][0]}
    host_ms = {s: statistics.median(p[1][s] for p in per) for s in per[0][1]}
    ms = statistics.median(run_ms)
    print(f"{label}: {ms:.3f} ms/scene, {1e3 / ms:.3f} scenes/s "
          f"(median of {runs} runs of {len(scenes)} scenes; ms/scene of each "
          f"run {[round(r, 3) for r in run_ms]})")
    print(f"{label} stage ms/scene, median of {len(marks)} scenes, device clock: "
          + json.dumps({k: round(v, 4) for k, v in stage_ms.items()}))
    print(f"{label} stage ms/scene, median, host clock (launch, no sync): "
          + json.dumps({k: round(v, 4) for k, v in host_ms.items()}))
    print(f"{label} peak memory {peak / 2**20:.1f} MiB")
    print(f"{label} launches during the timed runs: {launches}")
    n = runs * len(scenes)
    expect = {k: want.get(k, 0) * n for k in launches}
    if launches != expect:
        raise AssertionError(f"{label}: launch counts {launches}, expected "
                             f"{expect}")
    return dict(ms=ms, run_ms=run_ms, launches=launches, results=results,
                stage_ms=stage_ms, peak_mib=peak / 2**20)


def det_step(hypes, model):
    """One det scene: forward, decode and rotated NMS. A camera encoder
    marks its own stages (trunks + heads, lift + voxel pooling, BEV
    encoder, per agent type); the hetero encoder's concat and agent mask
    then join the BEV encoder stage."""
    decode, hw = det_decoder(hypes)
    camera = any("cam" in m for _, m in model.encoder.types)
    encoder_stage = "BEV encoder" if camera else DET_STAGES[0]

    def run(batch, mark):
        with torch.inference_mode():
            x = model.encode(batch, mark)
            mark(encoder_stage)
            psm = model.single_psm(x)
            mark(DET_STAGES[1])
            out = model.fuse(x, psm, batch["agent_mask"])
            mark(DET_STAGES[2])
            det = decode(out)
            mark(DET_STAGES[3])
        return out, det

    return run, hw


def det_decoder(hypes, device="cuda", top_k=TOP_K):
    """(decode, anchor grid (H, W)): ``decode(out)`` runs
    ``decode_detections`` (rotated NMS) on sample 0 of a det model's
    outputs on ``device``. A model without an objectness head (the binary
    point-pillar family, SCOPE) scores by psm, as the JAX package's
    inference tools pass ``out.get("obj", out["psm"])``, with one class."""
    from airv2x_tpu_torch.data.postprocess import decode_detections
    from airv2x_tpu_torch.ops.anchors import generate_anchor_grid

    anchors = torch.from_numpy(
        generate_anchor_grid(hypes["postprocess"]["anchor_args"])).to(device)
    lidar_range = torch.tensor(hypes["preprocess"]["cav_lidar_range"],
                               dtype=torch.float32, device=device)
    eye = torch.eye(4, device=device)
    tgt = hypes["postprocess"]["target_args"]

    def decode(out):
        return decode_detections(
            out["psm"][0], out["rm"][0], out.get("obj", out["psm"])[0],
            anchors, eye, lidar_range, num_class=int(hypes.get("num_class", 1)),
            obj_threshold=tgt["obj_threshold"],
            nms_thresh=hypes["postprocess"]["nms_thresh"], top_k=top_k)

    return decode, anchors.shape[:2]


# the det heads' channels: AirV2X's multiclass layout (7 classes x 2
# anchors, an objectness head) and SCOPE's binary one (no objectness head)
AIRV2X_HEADS = {"psm": 14, "rm": 14, "obj": 2}
SCOPE_HEADS = {"psm": 2, "rm": 14}


def check_det(label, results, hw, heads=AIRV2X_HEADS):
    """Each scene's head outputs (1, H, W, ``heads[k]``) finite, comm_rate in
    [0, 1], the kept boxes finite, and some box kept; prints the kept
    detections, NMS passes and comm rates per scene."""
    h, w = hw
    kept, passes, rates = [], [], []
    for out, det in results:
        for k, c in heads.items():
            assert tuple(out[k].shape) == (1, h, w, c), (k, out[k].shape)
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"non-finite {k}")
        rate = float(out["comm_rate"])
        if not 0.0 <= rate <= 1.0:
            raise AssertionError(f"comm_rate {rate}")
        if not bool(torch.isfinite(det.boxes[det.mask]).all()):
            raise AssertionError("non-finite kept boxes")
        kept.append(int(det.mask.sum()))
        passes.append(det.nms_passes)
        rates.append(round(rate, 4))
    print(f"{label} kept detections per scene {kept}; NMS passes per scene "
          f"{passes}; comm_rate per scene {rates}")
    if not any(kept):
        raise AssertionError("no detection survived decode")
    return kept


# cuDNN and PyTorch settings the kept detections are read under: (cuDNN's
# autotuner, cuDNN deterministic, torch.use_deterministic_algorithms, which
# makes index_add_ sum in a fixed order)
KEPT_VARIANTS = {"autotuned": (True, False, False),
                 "pinned": (False, True, False),
                 "pinned, deterministic index_add_": (False, True, True)}


def kept_variants(label, run, scenes, timed):
    """Kept detections per scene in two untimed passes under each of
    KEPT_VARIANTS, beside ``timed``, the timed run's: which setting makes
    them move (the open question of PERF.md section 7); and how far scene
    0's outputs lie apart in the two passes of each setting."""
    cudnn = torch.backends.cudnn
    out, apart = {"timed": timed}, {}
    try:
        for name, (bench, det, alg) in KEPT_VARIANTS.items():
            cudnn.benchmark, cudnn.deterministic = bench, det
            torch.use_deterministic_algorithms(alg, warn_only=True)
            passes = [[run(b, no_mark) for b in scenes] for _ in range(2)]
            out[name] = [[int(d.mask.sum()) for _, d in p] for p in passes]
            (a, _), (b, _) = passes[0][0], passes[1][0]
            apart[name] = {k: [float((a[k].float() - b[k].float()).abs().max()),
                               float(a[k].float().abs().max())]
                           for k in ("psm", "rm", "obj")}
    finally:
        cudnn.benchmark, cudnn.deterministic = True, False
        torch.use_deterministic_algorithms(False)
    print(f"{label} kept detections per scene, timed run and two passes per "
          "setting: " + json.dumps(out))
    print(f"{label} scene 0, [max|pass 1 - pass 2|, max|pass 1|] per setting: "
          + json.dumps(apart))
    return out


def phase_flagship(hypes, model, scenes, convs_per_scene):
    """Phase 5: the det path under ``auto`` (as slice 1), then ``pallas``."""
    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults for bf16
    torch.backends.cudnn.benchmark = True  # fixed shapes: pick conv algos once
    run, hw = det_step(hypes, model)
    res = {}
    for mode in ("auto", "pallas"):
        want = {"pillar_encode": 3, "quad_iou": 1}
        if mode == "pallas":
            want["conv3x3"] = convs_per_scene
        label = "phase 5 flagship" + (" pallas" if mode == "pallas" else "")
        with conv_mode(mode):
            res[mode] = time_path(label, run, scenes, want)
            kept = check_det(label, res[mode]["results"], hw)
            res[mode]["kept"] = kept_variants(label, run, scenes, kept)
    a, p = (res[m]["results"][0][0] for m in ("auto", "pallas"))
    print("phase 5 scene 0, bf16, [max|pallas - auto|, max|auto|]: "
          + json.dumps({k: [float((p[k].float() - a[k].float()).abs().max()),
                            float(a[k].float().abs().max())]
                        for k in ("psm", "rm", "obj")}))
    return res, run


def seg_step(model):
    from airv2x_tpu_torch.data.postprocess import decode_segmentation

    def run(batch, mark):
        with torch.inference_mode():
            x = model.encode(batch)
            mark(SEG_STAGES[0])
            conf = model.single_psm(x)
            mark(SEG_STAGES[1])
            out = model.fuse(x, conf, batch["agent_mask"])
            mark(SEG_STAGES[2])
            maps = decode_segmentation(out["dynamic_seg"], out["static_seg"])
            mark(SEG_STAGES[3])
        return out, maps

    return run


def phase_seg(scenes, convs_per_scene):
    """Phase 7: the LiDAR BEV-segmentation path in both conv modes."""
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import cast_weights_, init_random_

    hypes = cut_hypes(SEG)
    args = hypes["model"]["args"]
    model = init_random_(build_model(hypes, device="cuda"), seed=0)
    cast_weights_(model, torch.bfloat16)
    run = seg_step(model)
    res = {}
    for mode in ("auto", "pallas"):
        want = {"pillar_encode": 3}
        if mode == "pallas":
            want["conv3x3"] = convs_per_scene
        label = f"phase 7 seg {mode}"
        with conv_mode(mode):
            res[mode] = time_path(label, run, scenes, want)
            phase_profile(label, run, scenes, top=10, n=PROFILED_SCENES)
        check_seg(label, res[mode]["results"], args)
    return res


def check_seg(label, results, args):
    """Each scene's logits of shape (1, seg_hw, seg_hw, classes) and finite,
    its class maps (1, seg_hw, seg_hw), comm_rate in [0, 1]; prints the
    maps' class histograms."""
    hw, ncls = args["seg_hw"], (args["dynamic_class"], args["static_class"])
    hists = []
    for out, maps in results:
        for key, m, c in zip(("dynamic_seg", "static_seg"), maps, ncls):
            if tuple(out[key].shape) != (1, hw, hw, c) or not bool(
                    torch.isfinite(out[key]).all()):
                raise AssertionError(f"{label} {key}: shape "
                                     f"{tuple(out[key].shape)} or non-finite")
            if tuple(m.shape) != (1, hw, hw):
                raise AssertionError(f"{label} map {tuple(m.shape)}")
        if not 0.0 <= float(out["comm_rate"]) <= 1.0:
            raise AssertionError(f"comm_rate {float(out['comm_rate'])}")
        hists.append([np.bincount(m.cpu().numpy().ravel(), minlength=c).tolist()
                      for m, c in zip(maps, ncls)])
    print(f"{label} class histograms per scene [dynamic, static]: "
          + json.dumps(hists))
    return hists


def with_lead(scene):
    """A scene's arrays (nested camera dicts included) with a batch axis."""
    return {k: ({kk: vv[None] for kk, vv in v.items()} if isinstance(v, dict)
                else v[None]) for k, v in scene.items()}


def frustum_margin(model, batch):
    """Smallest distance, in cell widths, of a frustum point of ``batch``'s
    camera inputs to a cell boundary, over every camera type of ``model``
    (its geometry on the CPU, in float64 from the f32 points)."""
    from airv2x_tpu_torch.models.camera.lss import get_geometry

    margin = np.inf
    for t, modalities in model.encoder.types:
        if "cam" not in modalities:
            continue
        enc = model.encoder.get_submodule(f"{t}_lss")
        sl = model.layout.slots(t)
        cam = {k: v[:, sl].flatten(0, 1).cpu().float()
               for k, v in batch[f"cam_{t}"].items()}
        geom = get_geometry(enc.frustum.cpu(), *(cam[k] for k in (
            "rots", "trans", "intrinsics", "post_rots", "post_trans")))
        u = (geom.double() - enc.lo.cpu().double()) / enc.dx.cpu().double()
        margin = min(margin, float((u - u.round()).abs().min()))
    return margin


def tiny_camera_hypes(kind, hypes=None):
    """The tiny config (``hypes``, loaded by either package; by default the
    port's load of TINY) with cameras, built as tests/test_camera.py builds
    it: ``lidar+cam`` gives the vehicles both modalities and gt depth;
    ``cam`` gives every type the camera alone, depth from the softmax
    head."""
    from airv2x_tpu_torch.config import load_yaml

    hypes = copy.deepcopy(load_yaml(TINY) if hypes is None else hypes)
    args = hypes["model"]["args"]
    for t in (("vehicle", "rsu", "drone") if kind == "cam" else ("vehicle",)):
        args[t]["modalities"] = ["cam"] if kind == "cam" else ["lidar", "cam"]
        args[t]["cam"] = dict(TINY_CAM, use_depth_gt=kind != "cam")
    return hypes


# the camera configurations of phase 16: (task, YAML name) under
# hypes_yaml/airv2x/camera, and each one's model name
CAMERA_DIR = os.path.join(REPO, "hypes_yaml/airv2x/camera")
CAMERA_PATHS = (("det", "where2comm"), ("det", "v2xvit"), ("det", "cobevt"),
                ("det", "when2com"), ("det", "lss"), ("seg", "where2comm"),
                ("seg", "v2xvit"), ("seg", "cobevt"), ("seg", "v2vnet"),
                ("seg", "when2com"))
# the tiny compositions of phase 4g and the CPU tests: (model name, task),
# every one that camera configs name besides phase 4c's Where2comm det
TINY_COMPOSITIONS = (
    ("airv2x_where2comm", "seg"), ("airv2x_v2xvit", "det"),
    ("airv2x_v2xvit", "seg"), ("airv2x_cobevt", "det"), ("airv2x_cobevt", "seg"),
    ("airv2x_when2com", "det"), ("airv2x_when2com", "seg"),
    ("airv2x_v2vnet", "seg"), ("lift_splat_shoot_airv2x", "det"),
    ("lift_splat_shoot_airv2x", "seg"))


def tiny_composition_hypes(hypes, name, task, kind="cam"):
    """The tiny config (``hypes``, loaded by either package) as the model
    ``name`` for ``task`` (the family's fusion blocks of TINY_FAMILY, the
    V2X-ViT transformer of TINY_V2XVIT_ENCODER), with cameras as
    ``tiny_camera_hypes`` gives them for ``kind``."""
    hypes = copy.deepcopy(hypes)
    if name in TINY_FAMILY:
        hypes = tiny_family_hypes(hypes, name, task)
    else:
        hypes["model"]["core_method"] = name
        if name == "airv2x_v2xvit":
            hypes["model"]["args"]["transformer"] = {
                "encoder": copy.deepcopy(TINY_V2XVIT_ENCODER)}
        hypes["task"] = hypes["model"]["args"]["task"] = task
    return tiny_camera_hypes(kind, hypes)


def phase_tiny_camera():
    """Phase 4c: the tiny camera configs on the card against the same weights
    on the CPU, f32 with TF32 off and deterministic cuDNN; the card fuses
    with the CPU's single-agent confidence (the same comm mask)."""
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.data.synthetic import (
        add_camera_inputs, batch_to_torch, make_scene)
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    set_tf32(False)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        for kind in ("cam", "lidar+cam"):
            hypes = tiny_camera_hypes(kind)
            models = {d: init_random_(build_model(hypes, device=d), seed=3)
                      for d in ("cpu", "cuda")}
            rng = np.random.default_rng(3)  # the scene of the CPU tests
            b, _ = make_scene(rng, models["cpu"].layout, num_objects=6,
                              points_per_agent=1024, pts_per_box=60,
                              lidar_range=hypes["preprocess"]["cav_lidar_range"],
                              num_agents={"vehicle": 2, "rsu": 1, "drone": 1})
            add_camera_inputs(b, models["cpu"].layout, rng, img_hw=(64, 96),
                              ncam={"vehicle": 2, "rsu": 1, "drone": 1})
            batch = {d: batch_to_torch(with_lead(b), d) for d in models}
            margin = frustum_margin(models["cpu"], batch["cpu"])
            kernels.reset_launch_counts()
            psm_cpu, want = staged(models["cpu"], batch["cpu"])
            psm_card, got = staged(models["cuda"], batch["cuda"], psm_cpu)
            torch.cuda.synchronize()
            k1 = kernels.LAUNCHES["pillar_encode"]
            if k1 != (0 if kind == "cam" else 3):
                raise AssertionError(f"tiny camera {kind}: {k1} K1 launches")
            compare(f"phase 4c tiny camera {kind} card vs CPU ({k1} K1 "
                    f"launches; frustum margin {margin:.3e} cell widths, "
                    f"limit {CELL_MARGIN})",
                    {"single": psm_card, **got}, {"single": psm_cpu, **want},
                    ("single", "psm", "rm", "obj", "comm_rate"))
            if margin <= CELL_MARGIN:
                raise AssertionError(f"tiny camera {kind}: a frustum point "
                                     f"lies {margin} from a cell boundary")
    finally:
        cudnn.benchmark, cudnn.deterministic = flags


def tiny_v2xvit_hypes(task):
    """The tiny config as the V2X-ViT model (TINY_V2XVIT_ENCODER), patched
    as tests/test_torch_v2xvit.py patches it; ``task`` det or seg."""
    from airv2x_tpu_torch.config import load_yaml

    hypes = copy.deepcopy(load_yaml(TINY))
    hypes["model"]["core_method"] = "airv2x_v2xvit"
    hypes["model"]["args"]["transformer"] = {
        "encoder": copy.deepcopy(TINY_V2XVIT_ENCODER)}
    hypes["task"] = hypes["model"]["args"]["task"] = task
    return hypes


def roi_samples(hypes, pairwise_t, hw):
    """The V2X-ViT ROI samples (the warped ones canvas, which the mask
    thresholds at 0.5) of ``pairwise_t`` on its device, at the fused map's
    (H, W)."""
    from airv2x_tpu_torch.ops.warp import rotated_roi_weights

    sttf = hypes["model"]["args"]["transformer"]["encoder"]["sttf"]
    return rotated_roi_weights(hw, pairwise_t, sttf["voxel_size"][0],
                               sttf["downsample_rate"])


def phase_tiny_v2xvit():
    """Phase 4d: the tiny V2X-ViT det and seg configs on the card against the
    same weights on the CPU, f32 with TF32 off and pinned cuDNN, in ``auto``
    and ``pallas``, on a scene with perturbed poses and delays; the ROI
    samples' smallest distance from 0.5 is printed and bounded."""
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.data.synthetic import (
        batch_to_torch, make_scene, perturb_poses)
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    set_tf32(False)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        for task, keys in (("det", ("psm", "rm", "obj", "comm_rate")),
                           ("seg", ("dynamic_seg", "static_seg", "comm_rate"))):
            hypes = tiny_v2xvit_hypes(task)
            models = {d: init_random_(build_model(hypes, device=d), seed=3)
                      for d in ("cpu", "cuda")}
            b, _ = make_scene(np.random.default_rng(2), models["cpu"].layout,
                              num_objects=6, points_per_agent=2048,
                              pts_per_box=60,
                              lidar_range=hypes["preprocess"]["cav_lidar_range"])
            scene = perturb_poses(with_lead(b), np.random.default_rng(1))
            batch = {d: batch_to_torch(scene, d) for d in models}
            margin = float((roi_samples(hypes, batch["cpu"]["pairwise_t"],
                                        (48, 48)) - 0.5).abs().min())
            per_pass = sum(hypes["model"]["args"]["modality_fusion"][
                "base_bev_backbone"]["layer_nums"])
            for mode in ("auto", "pallas"):
                kernels.reset_launch_counts()
                with conv_mode(mode), torch.inference_mode():
                    want = models["cpu"](batch["cpu"])
                    got = models["cuda"](batch["cuda"])
                torch.cuda.synchronize()
                n = dict(kernels.LAUNCHES)
                convs = per_pass if mode == "pallas" else 0
                if n["conv3x3"] != convs or n["pillar_encode"] != 3:
                    raise AssertionError(f"tiny V2X-ViT {task} {mode}: {n}")
                compare(f"phase 4d tiny V2X-ViT {task} {mode} card vs CPU "
                        f"({n['pillar_encode']} K1, {n['conv3x3']} K4a "
                        f"launches; ROI margin {margin:.3e}, limit "
                        f"{ROI_MARGIN})", got, want, keys)
            if margin <= ROI_MARGIN:
                raise AssertionError(f"tiny V2X-ViT {task}: an ROI sample "
                                     f"lies {margin} from 0.5")
    finally:
        cudnn.benchmark, cudnn.deterministic = flags


def camera_setup():
    """The camera det model at full width (bf16 serving cast, seeded random
    weights) and N_SCENES scenes resident on the card: ``make_scene`` as
    phase 5, then ``add_camera_inputs`` at the configs' 256 x 352."""
    from airv2x_tpu_torch.data.synthetic import (
        add_camera_inputs, batch_to_torch, make_scene)
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import cast_weights_, init_random_

    hypes = cut_hypes(CAMERA)
    model = init_random_(build_model(hypes, device="cuda"), seed=0)
    cast_weights_(model, torch.bfloat16)
    hw = tuple(hypes["model"]["args"]["vehicle"]["cam"]["data_aug_conf"][
        "final_dim"])
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    scenes = []
    for _ in range(N_SCENES):
        b, _ = make_scene(rng, model.layout, num_objects=12,
                          num_agents=NUM_AGENTS,
                          points_per_agent=POINTS_PER_AGENT,
                          lidar_range=hypes["preprocess"]["cav_lidar_range"],
                          pts_per_box=100)
        add_camera_inputs(b, model.layout, rng, img_hw=hw, ncam=NCAM)
        scenes.append(batch_to_torch(with_lead(b), "cuda"))
    torch.cuda.synchronize()
    mib = sum(v.numel() * v.element_size() for s in scenes
              for k, d in s.items() if k.startswith("cam_")
              for v in d.values()) / 2**20
    print(f"phase 10 camera: {N_SCENES} scenes made in "
          f"{time.perf_counter() - t0:.2f} s, camera inputs {mib:.1f} MiB "
          "resident on the card")
    return hypes, model, scenes


def conv_flops(model, run, batch):
    """Operations (2 per multiply-add) of every convolution of one run of
    ``batch`` under ``auto``, by part of the model, from forward hooks: a
    conv's output elements times its input channels per group times its
    taps."""
    parts = {}

    def hook(name):
        part = ("trunks+heads" if ".camencode." in name else
                "BEV encoder" if ".bevencode." in name else
                "backbone, shrink, fusion, heads")

        def count(mod, args, out):
            taps = mod.kernel_size[0] * mod.kernel_size[1]
            cin = (mod.in_channels // mod.groups
                   if isinstance(mod, torch.nn.Conv2d) else mod.out_channels)
            parts[part] = parts.get(part, 0) + 2 * out.numel() * cin * taps
        return count

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        with conv_mode("auto"):
            run(batch, no_mark)
    finally:
        for h in handles:
            h.remove()
    return parts


def phase_camera(card, convs_per_scene):
    """Phase 10: the camera-LSS det path at full width in ``auto`` and in
    ``pallas`` mode: timed runs, stage times, peak memory, kept detections,
    launch counts (K2 once per scene, K4a 32 times in ``pallas``, K1 never),
    a profile window, and the kept detections under each of KEPT_VARIANTS;
    first, the convolutions' operations per scene and their time at the
    card's dense bf16 peak."""
    hypes, model, scenes = camera_setup()
    run, hw = det_step(hypes, model)
    flops = conv_flops(model, run, scenes[0])
    with torch.inference_mode():  # the voxel pooling's atomic order
        x = [model.encode(scenes[0]) for _ in range(2)]
    print(f"phase 10 camera [{card}] scene 0, two encodes (bf16 BEV maps): "
          f"max|encode 1 - encode 2| {float((x[0] - x[1]).float().abs().max())}"
          f" of max|encode 1| {float(x[0].float().abs().max())}; "
          f"{int((x[0] != x[1]).sum())} of {x[0].numel()} values differ")
    del x
    total = sum(flops.values())
    print(f"phase 10 camera [{card}] convolution operations per scene: "
          f"{total / 1e12:.4f} T ({json.dumps({k: round(v / 1e12, 4) for k, v in flops.items()})}); "
          f"at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s of dense bf16 "
          f"{total / BF16_OPS_PER_S * 1e3:.4f} ms")
    set_tf32(False)
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32 = True  # PyTorch's defaults for bf16
    cudnn.benchmark, cudnn.deterministic = True, False
    res = {}
    # both modes' timed runs before this phase's profile windows: the
    # camera pallas runs read slower than auto when a window ran between
    # them, in host launch time of code that is the same in both modes
    for mode in ("auto", "pallas"):
        want = {"quad_iou": 1}
        if mode == "pallas":
            want["conv3x3"] = convs_per_scene
        with conv_mode(mode):
            res[mode] = time_path(f"phase 10 camera {mode} [{card}]", run,
                                  scenes, want)
    for mode in ("auto", "pallas"):
        label = f"phase 10 camera {mode} [{card}]"
        with conv_mode(mode):
            res[mode]["profile"] = phase_profile(label, run, scenes,
                                                 n=PROFILED_SCENES)
            kept = check_det(label, res[mode].pop("results"), hw)
            res[mode]["kept"] = kept_variants(label, run, scenes, kept)
    return res, {"conv_tflop": {k: v / 1e12 for k, v in flops.items()},
                 "flop_floor_ms": total / BF16_OPS_PER_S * 1e3}


def staged_step(hypes, model, stages=V2XVIT_STAGES):
    """One scene of a model with the stage methods ``encode`` / ``backbone``
    / ``fuse`` / ``heads`` (V2X-ViT, the intermediate family), det (decode
    and rotated NMS) or seg (class maps), with its stages marked by
    ``stages`` (encoder, backbone + shrink, fusion, heads) and decode."""
    from airv2x_tpu_torch.data.postprocess import decode_segmentation

    if model.task == "det":
        decode, _ = det_decoder(hypes)
        last = DET_STAGES[3]
    else:
        def decode(out):
            return decode_segmentation(out["dynamic_seg"], out["static_seg"])
        last = SEG_STAGES[3]

    def run(batch, mark):
        with torch.inference_mode():
            x = model.encode(batch, mark)
            mark(stages[0])
            feats = model.backbone(x)
            mark(stages[1])
            fused = model.fuse(feats, batch)
            mark(stages[2])
            out = model.heads(fused)
            mark(stages[3])
            res = decode(out)
            mark(last)
        return out, res

    return run


def transformer_ops(enc, batch, hw, needed):
    """Operations (2 per multiply-add) of the V2X-ViT transformer on one
    scene, by part, from the configuration's shapes (``enc``, its
    ``transformer.encoder`` block, with HGT agent attention) and the
    scene's agents, types and ROI mask, at the fused map's (H, W) ``hw``.

    ``needed``: the work the function needs. Each present agent runs its
    own type's q / k / v / output Linears; the relation products q W and
    m W run once per type present; the score and message products run only
    for the (pixel, agent pair)s the mask keeps; and at the last depth only
    the ego slot's queries, windows and FFN count, since the transformer
    returns slot 0. Otherwise, the work the port (and the JAX package)
    executes: both types' Linears and every type's products on every slot
    and column at every depth. Softmax, LayerNorm, the warp and the
    elementwise passes are not counted by either."""
    from airv2x_tpu_torch.ops.warp import rotated_roi_mask

    cav, pw = enc["cav_att_config"], enc["pwindow_att_config"]
    assert cav["use_hetero"] and cav["use_RTE"], cav
    c, mlp, depth = cav["dim"], enc["feed_forward"]["mlp_dim"], enc["depth"]
    heads, dh, nt = cav["heads"], cav["dim_head"], 2
    inner = heads * dh
    agents = batch["agent_mask"].cpu()
    b, l = agents.shape
    p = hw[0] * hw[1]
    types = batch["prior_encoding"][..., 2].long().cpu()
    roi = rotated_roi_mask(hw, batch["pairwise_t"].cpu(), enc["sttf"][
        "voxel_size"][0], enc["sttf"]["downsample_rate"])
    cols = (roi & agents[:, :, None, None]).flatten(1).sum(1)  # per scene
    parts = {}

    def add(part, ops):
        parts[part] = parts.get(part, 0) + int(ops)

    # slots whose output is read, per scene: (all depths but the last, last)
    if needed:
        present = [int(agents[i].sum()) for i in range(b)]
        slots = [(n, 1) for n in present]
        n_types = [len(set(types[i][agents[i]].tolist())) for i in range(b)]
        typed = 1
    else:
        slots, n_types, typed = [(l, l)] * b, [nt] * b, nt
    add("RTE Linear", 2 * sum(n for n, _ in slots) * c * c)
    for d in range(depth):
        for i in range(b):
            kv = slots[i][0] if needed else l
            nq = slots[i][d == depth - 1]
            # q and output for the read slots, k and v for every present one
            add("HGT Linear", 2 * p * typed * (2 * nq + 2 * kv) * c * inner)
            # q W and m W per type; q k and a v per (pixel, column) kept
            pairs = int(cols[i]) if needed else nt * l * p
            add("HGT attention", 2 * heads * nq * (
                2 * n_types[i] * dh * dh * p + 2 * dh * pairs))
            for h, d_h, ws in zip(pw["heads"], pw["dim_head"],
                                  pw["window_size"]):
                tok = nq * p
                add("window pyramid Linear", 2 * tok * 4 * c * h * d_h)
                add("window attention", 2 * 2 * tok * h * ws * ws * d_h)
            if pw["fusion_method"] == "split_attn":
                add("window pyramid Linear", 2 * nq * 4 * c * c)
            add("FFN Linear", 2 * 2 * nq * p * c * mlp)
    return parts


def family_ops(hypes, batch, shape, needed):
    """Operations (2 per multiply-add) of an intermediate-family fusion on
    one batch, by part, from the configuration (``hypes``), the batch's
    agents and poses and the agents' map ``shape`` (C, H, W).

    ``needed``: the work the function needs. Only present agents' maps are
    read (as V2VNet senders, When2com keys and summands, CoBEVT keys under
    ``mask``, max and attention summands); V2VNet's last round needs only
    the ego receiver, each of its messages only where the ROI keeps the
    pixel, and its GRU, run from a zero hidden state, only the input half of
    each conv; When2com's query only the ego. Otherwise, the work the port
    (and the JAX package) executes: every slot, receiver and pixel, and both
    halves of each GRU conv. The warps, softmax, LayerNorm, BatchNorm and
    the elementwise passes are not counted by either."""
    from airv2x_tpu_torch.ops.warp import (
        normalized_pairwise_affine, warp_affine_normalized)

    args = hypes["model"]["args"]
    name = hypes["model"]["core_method"]
    c, h, w = shape
    p = h * w
    agents = batch["agent_mask"].cpu()
    b, l = agents.shape
    present = [int(n) for n in agents.sum(1)] if needed else [l] * b
    parts = {}

    def add(part, ops):
        parts[part] = parts.get(part, 0) + int(ops)

    if name in ("airv2x_attfusion", "airv2x_intermediate"):
        for n in present:  # the ego's scores and the weighted sum
            add("ego attention", 2 * 2 * n * p * c)
    elif name == "airv2x_maxfusion":
        for n in present:
            add("max", n * p * c)
    elif name == "airv2x_cobevt":
        fax = args["fax_fusion"]
        mlp, ws, dh = int(fax["mlp_dim"]), int(fax["window_size"]), int(fax["dim_head"])
        heads, tokens = c // dh, l * p
        for i in range(b):
            keys = present[i] if fax.get("mask") else l
            for _ in range(2 * int(fax["depth"])):  # window and grid passes
                add("window Linears", 2 * tokens * 4 * c * c)
                add("feed-forward Linears", 2 * 2 * tokens * c * mlp)
                # per window: (L ws^2 queries) x (keys ws^2) scores, then
                # the weighted values
                add("window attention", 2 * 2 * (p // (ws * ws)) * heads
                    * (l * ws * ws) * (keys * ws * ws) * dh)
            add("output Linear", 2 * p * c * c)
    elif name == "airv2x_v2vnet":
        v2v = args["v2vfusion"]
        iters = int(v2v["num_iteration"])
        ks = v2v["conv_gru"]["kernel_size"]
        ks = ks[0] if isinstance(ks[0], (list, tuple)) else ks
        taps = int(ks[0]) * int(ks[1])
        gru = bool(v2v.get("gru_flag", True))
        pix = torch.full((b, l, l), p, dtype=torch.int64)  # per (i, j) pair
        if needed:
            aff = normalized_pairwise_affine(
                batch["pairwise_t_full"].cpu(), h, w, v2v["voxel_size"][0],
                v2v["downsample_rate"]).reshape(-1, 2, 3)
            ones = torch.ones((1, h, w, 1))
            roi = warp_affine_normalized(ones, aff, torch.zeros(
                len(aff), dtype=torch.int64)) > 0.5
            pix = roi.reshape(b, l, l, -1).sum(-1) * agents[:, None, :]
        for r in range(iters):
            last = r == iters - 1
            for i in range(b):
                if not needed:
                    receivers = range(l)
                else:  # present receivers, only the ego in the last round
                    receivers = [0] if last else [
                        k for k in range(l) if agents[i, k]]
                for k in receivers:
                    add("message conv", 2 * int(pix[i, k].sum()) * 2 * c * c * 9)
                    if gru:
                        cin = 2 * c if needed else 3 * c
                        add("GRU convs", 2 * p * cin * 3 * c * taps)
        add("output Linear", 2 * b * p * c * c)
    elif name == "airv2x_when2com":
        from airv2x_tpu_torch.models.fusion.when2com import POLICY_PLAN

        wc = args["when2com_fusion"]
        key, query = int(wc["key_size"]), int(wc["query_size"])
        hh, ww, cin, conv = h, w, c, 0
        for filters, stride in POLICY_PLAN:
            hh, ww = _down((hh, ww), stride)
            conv += _conv_ops(1, (hh, ww), cin, filters, 3)
            cin = filters
        flat = hh * ww * cin

        def mlp(out):
            return 2 * (flat * 256 + 256 * 128 + 128 * out)

        for n in present:
            add("policy convs", n * conv)
            add("key and query MLPs", n * mlp(key) + mlp(query) + 2 * query * key)
            add("agent attention", 2 * n * key + 2 * n * p * c)
    else:
        raise ValueError(f"no operation count for {name}")
    return parts


def transformer_busy(model, run, scenes, n=3):
    """Device ms per scene of the V2X-ViT transformer's parts over a
    profile window of ``n`` scenes: each part's forward runs inside a
    profiler range opened and closed by module hooks, and a range's device
    time is that of the kernels launched inside it. What no part holds
    (the ROI mask, the GELU and the FFN's residual add, the permutes at the
    transformer's entry and exit) is the transformer stage's rest; each
    kernel goes to the innermost range around its launch
    (``launch_ranges``)."""
    from torch.profiler import ProfilerActivity, profile

    from airv2x_tpu_torch.models.fusion.v2xvit import (
        RTE, STTF, CavAttention, HGTCavAttention, LayerNorm,
        PyramidWindowAttention)

    part = {RTE: "RTE", STTF: "STTF warp", HGTCavAttention: "agent attention",
            CavAttention: "agent attention",
            PyramidWindowAttention: "window pyramid", LayerNorm: "LayerNorm"}
    enc = model.fusion_net.encoder
    mods = [(m, part[type(m)]) for name, m in enc.named_modules()
            if type(m) in part and ".split_attn." not in name]
    mods += [(m, "FFN Linear") for m in enc.ffn]
    open_ranges = []

    def enter(label):
        def pre(mod, args):
            r = torch.profiler.record_function(f"v2xvit {label}")
            r.__enter__()
            open_ranges.append(r)
        return pre

    def leave(mod, args, out):
        open_ranges.pop().__exit__(None, None, None)

    handles = [h for m, label in mods for h in (
        m.register_forward_pre_hook(enter(label)), m.register_forward_hook(leave))]
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for batch in scenes[:n]:
                marks = RangeMarks()
                run(batch, marks)
                marks.close()
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    busy = {}
    stage = f"stage {V2XVIT_STAGES.index('transformer')}"
    for key, us in launch_ranges(prof, ("v2xvit ", "stage ")).items():
        if key.startswith("v2xvit ") or key == stage:
            part = key.removeprefix("v2xvit ") if key != stage else "rest"
            busy[part] = busy.get(part, 0.0) + us / 1e3 / n
    return {k: round(v, 4) for k, v in busy.items()}


def v2xvit_model(path):
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import cast_weights_, init_random_

    hypes = cut_hypes(path)
    model = init_random_(build_model(hypes, device="cuda"), seed=0)
    return hypes, cast_weights_(model, torch.bfloat16)


def phase_v2xvit(card):
    """Phase 11: the V2X-ViT LiDAR det path at full width (the cut and the
    8 scenes of phase 5, bf16, seeded random weights) in ``auto`` and
    ``pallas``: the transformer's operations per scene, those its function
    needs (the floor) and those the code executes, and their times at the
    dense bf16 peak; timed runs (K1 3, K2 1 and, in ``pallas``, K4a 16
    launches per scene, asserted), stage times, peak memory, a profile
    window, kept detections; the seg task the same way; then one det scene
    with perturbed poses and delays: finite outputs, the ROI mask on the
    card equal to the CPU's, and the f32 model's outputs on the card
    against the CPU's."""
    hypes, model = v2xvit_model(V2XVIT)
    scenes, _ = lidar_scenes(hypes, model.layout)
    per_pass = sum(hypes["model"]["args"]["modality_fusion"][
        "base_bev_backbone"]["layer_nums"])
    assert per_pass == 16, per_pass
    run = staged_step(hypes, model)
    enc = hypes["model"]["args"]["transformer"]["encoder"]
    ops = {kind: transformer_ops(enc, scenes[0], det_decoder(hypes)[1],
                                 needed=kind == "needed")
           for kind in ("needed", "executed")}
    ms = {kind: sum(o.values()) / BF16_OPS_PER_S * 1e3 for kind, o in ops.items()}
    for kind, o in ops.items():
        print(f"phase 11 V2X-ViT [{card}] transformer operations per scene, "
              f"{kind}: {sum(o.values()) / 1e12:.4f} T ("
              + json.dumps({k: round(v / 1e12, 4) for k, v in o.items()})
              + f"); at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s of dense bf16 "
              f"{ms[kind]:.4f} ms")
    floor_ms = ms["needed"]
    set_tf32(False)
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32 = True  # PyTorch's defaults for bf16
    cudnn.benchmark, cudnn.deterministic = True, False
    out = {"card": card,
           "transformer_tflop": {kind: {k: v / 1e12 for k, v in o.items()}
                                 for kind, o in ops.items()},
           "transformer_floor_ms": floor_ms,
           "transformer_executed_ms_at_peak": ms["executed"]}
    for task, path in (("det", V2XVIT), ("seg", V2XVIT_SEG)):
        if task == "seg":  # the det model went before the f32 check
            hypes, model = v2xvit_model(path)
            run = staged_step(hypes, model)
        res = {}
        # both modes' timed runs before the profile windows, as phase 10
        for mode in ("auto", "pallas"):
            want = {"pillar_encode": 3}
            if task == "det":
                want["quad_iou"] = 1
            if mode == "pallas":
                want["conv3x3"] = per_pass
            with conv_mode(mode):
                res[mode] = time_path(f"phase 11 V2X-ViT {task} {mode} [{card}]",
                                      run, scenes, want)
            res[mode]["launches_per_scene"] = want
        for mode in ("auto", "pallas"):
            label = f"phase 11 V2X-ViT {task} {mode} [{card}]"
            with conv_mode(mode):
                res[mode]["profile"] = phase_profile(label, run, scenes, top=12,
                                                     n=PROFILED_SCENES)
                if task == "det" and mode == "auto":
                    parts = transformer_busy(model, run, scenes,
                                             n=PROFILED_SCENES)
                    out["transformer_busy_ms"] = parts
                    print(f"{label} transformer device busy ms/scene by part "
                          f"({sum(parts.values()):.3f} in all, "
                          f"{sum(parts.values()) / floor_ms:.1f}x the floor): "
                          + json.dumps(parts))
            results = res[mode].pop("results")
            if task == "det":
                res[mode]["kept"] = check_det(label, results,
                                              det_decoder(hypes)[1])
            else:
                check_seg(label, results, hypes["model"]["args"])
        out[task] = res
        if task == "det":
            out["perturbed"] = v2xvit_perturbed(card, hypes, model, run)
            del model, run
            torch.cuda.empty_cache()
            out["perturbed_f32_card_vs_cpu"] = v2xvit_f32_vs_cpu(card, hypes)
    del model, run, scenes
    torch.cuda.empty_cache()
    return out


def perturbed_scene(hypes, layout):
    """One full-width scene (numpy, batch 1) with perturbed poses (up to 5
    degrees and 3 m) and delays (0-3)."""
    from airv2x_tpu_torch.data.synthetic import make_scene, perturb_poses

    b, _ = make_scene(np.random.default_rng(8), layout, num_objects=12,
                      num_agents=NUM_AGENTS, points_per_agent=POINTS_PER_AGENT,
                      lidar_range=hypes["preprocess"]["cav_lidar_range"],
                      pts_per_box=100)
    return perturb_poses(with_lead(b), np.random.default_rng(9))


def v2xvit_perturbed(card, hypes, model, run):
    """The perturbed det scene through the bf16 model: finite outputs, and
    the ROI mask on the card equal to the CPU's, with its samples' smallest
    distance from 0.5."""
    from airv2x_tpu_torch.data.synthetic import batch_to_torch

    batch = batch_to_torch(perturbed_scene(hypes, model.layout), "cuda")
    with conv_mode("auto"):
        out, det = run(batch, no_mark)
    hw = tuple(out["psm"].shape[1:3])
    for k in ("psm", "rm", "obj"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"phase 11 perturbed scene: non-finite {k}")
    card_w = roi_samples(hypes, batch["pairwise_t"], hw)
    cpu_w = roi_samples(hypes, batch["pairwise_t"].cpu(), hw)
    equal = bool(torch.equal(card_w.cpu() > 0.5, cpu_w > 0.5))
    margin = float((cpu_w - 0.5).abs().min())
    kept = int(det.mask.sum())
    print(f"phase 11 V2X-ViT perturbed det scene [{card}]: outputs finite, "
          f"{kept} kept detections; ROI mask card == CPU: {equal} "
          f"({int((cpu_w <= 0.5).sum())} of {cpu_w.numel()} pixels masked, "
          f"samples' smallest distance from 0.5 {margin:.3e}; card and CPU "
          f"samples max|diff| {float((card_w.cpu() - cpu_w).abs().max())})")
    if not equal:
        raise AssertionError("phase 11: the ROI mask differs on the card")
    return {"kept": kept, "roi_equal": equal, "roi_margin": margin}


def v2xvit_f32_vs_cpu(card, hypes):
    """The perturbed det scene through the full-width f32 model at one
    layer per backbone stage and one transformer block (``shallow_hypes``;
    seeded random weights, TF32 off, pinned cuDNN, ``auto``) on the card
    and on the CPU: the fused ego map and psm / rm / obj within TINY_TOL x
    (1 + scale)."""
    from airv2x_tpu_torch.data.synthetic import batch_to_torch
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    hypes = shallow_hypes(hypes)
    models = {d: init_random_(build_model(hypes, device=d), seed=0)
              for d in ("cpu", "cuda")}
    scene = perturbed_scene(hypes, models["cpu"].layout)
    set_tf32(False)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    outs, secs = {}, {}
    try:
        for d, model in models.items():
            batch = batch_to_torch(scene, d)
            t0 = time.perf_counter()
            with conv_mode("auto"), torch.inference_mode():
                fused = model.fuse(model.backbone(model.encode(batch)), batch)
                outs[d] = dict(model.heads(fused), fused=fused)
            torch.cuda.synchronize()
            secs[d] = time.perf_counter() - t0
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    keys = ("fused", "psm", "rm", "obj")
    errs = {k: float((outs["cuda"][k].cpu().double()
                      - outs["cpu"][k].double()).abs().max()) for k in keys}
    scales = {k: float(outs["cpu"][k].abs().max()) for k in keys}
    compare(f"phase 11 V2X-ViT perturbed det scene, f32, card vs CPU [{card}] "
            f"(CPU {secs['cpu']:.1f} s, card {secs['cuda']:.2f} s)",
            outs["cuda"], outs["cpu"], keys)
    del models, outs
    torch.cuda.empty_cache()
    return {"max_abs_err": errs, "scale": scales, "tol": TINY_TOL}


def tiny_scope_batch(hypes, frames=2):
    """The tiny SCOPE scene of phase 4e and the CPU tests (numpy, batch 1):
    ``frames`` distinct ``make_scene`` frames of two vehicles in three slots,
    with perturbed history and ego-row poses (``scope_scene``'s
    ``pose_rng``)."""
    from airv2x_tpu_torch.models.base import SlotLayout

    return scope_scene(np.random.default_rng(0),
                       SlotLayout.from_args(hypes["model"]["args"]), frames,
                       hypes["preprocess"]["cav_lidar_range"],
                       pose_rng=np.random.default_rng(1), num_objects=6,
                       points_per_agent=1024, pts_per_box=60,
                       num_agents={"vehicle": 2})


def nms_margin(det, nms_thresh):
    """The smallest distance of a pairwise IoU of the decoded candidates'
    corners (plain version, on the CPU) from the NMS threshold."""
    from airv2x_tpu_torch.ops.quad_iou import quad_iou_plain

    live = det.corners[:, :4, :2].float().cpu().contiguous()
    iou = quad_iou_plain(live, live)
    i, j = torch.triu_indices(len(iou), len(iou), offset=1)
    return float((iou[i, j] - nms_thresh).abs().min())


# the tiny SCOPE models' random-weight seed (init_random_): the first from 0
# up whose comm, query and NMS margins on phase 4e's scene (decoded with
# top_k TINY_SCOPE_TOP_K, as the CPU tests decode) all exceed SCOPE_MARGIN
# on the CPU with either backbone
TINY_SCOPE_SEED = 4
TINY_SCOPE_TOP_K = 256
SCOPE_MARGIN = 1e-4


def phase_tiny_scope():
    """Phase 4e: the tiny SCOPE config, ResNet then plain backbone, on the
    card against the same weights on the CPU, f32 with TF32 off and pinned
    cuDNN, on the perturbed 2-frame scene: the outputs within TINY_TOL x
    (1 + scale), the comm masks, the query cells and the kept detections
    equal; K1 2 and K2 1 launches; the margins at the comm threshold, the
    query cut and the NMS threshold printed and bounded."""
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.data.synthetic import batch_to_torch
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    set_tf32(False)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    out = {}
    try:
        for resnet in (True, False):
            name = "ResNet" if resnet else "plain"
            hypes = tiny_scope_hypes(resnet)
            scene = tiny_scope_batch(hypes)
            res, keys = {}, ("psm", "rm", "psm_single_v", "rm_single_v",
                             "psm_single_i", "rm_single_i")
            for d in ("cpu", "cuda"):
                model = init_random_(build_model(hypes, device=d),
                                     seed=TINY_SCOPE_SEED)
                decode, _ = det_decoder(hypes, d, TINY_SCOPE_TOP_K)
                kernels.reset_launch_counts()
                margins, caught, outs = scope_margins(model, batch_to_torch(scene, d))
                with torch.inference_mode():
                    det = decode(outs)
                if d == "cuda":
                    torch.cuda.synchronize()
                res[d] = dict(margins=margins, caught=caught, outs=outs, det=det,
                              launches=dict(kernels.LAUNCHES))
            n = res["cuda"]["launches"]
            if (n["pillar_encode"], n["quad_iou"], n["conv3x3"]) != (2, 1, 0):
                raise AssertionError(f"tiny SCOPE {name}: launches {n}")
            margins = dict(res["cpu"]["margins"],
                           nms=nms_margin(res["cpu"]["det"], 0.15))
            compare(f"phase 4e tiny SCOPE {name} card vs CPU ({n['pillar_encode']} "
                    f"K1, {n['quad_iou']} K2 launches; margins comm "
                    f"{margins['comm']:.3e}, query cut {margins['topk']:.3e}, "
                    f"NMS {margins['nms']:.3e}, limit {SCOPE_MARGIN})",
                    res["cuda"]["outs"], res["cpu"]["outs"], keys)
            same = scope_same_decisions(res["cuda"], res["cpu"])
            kept = [int(res[d]["det"].mask.sum()) for d in ("cuda", "cpu")]
            print(f"phase 4e tiny SCOPE {name}: card against CPU {same}; kept "
                  f"{kept}")
            if (not (same["comm masks equal"] and same["keep sets equal"])
                    or same["query cells differing"]
                    or min(margins.values()) <= SCOPE_MARGIN):
                raise AssertionError(f"tiny SCOPE {name}: {same}, {margins}")
            out[name] = {"margins": margins, "kept": kept[1]}
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    return out


def scope_same_decisions(card, cpu):
    """The card's decisions against the CPU's (each a dict with the
    ``caught`` of ``scope_margins`` and, optionally, ``det``): whether the
    comm masks are equal, how many query cells the card picks that the CPU
    does not (over every level; the order within a level does not matter:
    each query writes its own cell), and whether the keep sets are equal."""
    a, b = card["caught"], cpu["caught"]
    same = {"comm masks equal": bool(torch.equal(a["masks"].cpu(), b["masks"])),
            "query cells differing": sum(
                int((~torch.isin(x.cpu(), y)).sum())
                for x, y in zip(a["queries"], b["queries"]))}
    if "det" in card:
        same["keep sets equal"] = bool(torch.equal(card["det"].mask.cpu(),
                                                   cpu["det"].mask))
    return same


# init_random_'s weights (He-normal convolutions, random BN statistics) grow
# SCOPE's activations through the ResNet blocks and the unnormalised shrink
# (mean ~310, at most ~5,800 on a phase-12 scene): the cls logits reach
# +-3,800 and saturate the sigmoid at 1.0 over half of the anchors, where
# the query cut and NMS would rank ties by index and decode keeps nothing
# inside the range. Phase 12 scales the cls head's weights by this factor
# (logits within +-40, 1.6% saturated; NVIDIA H100, f32).
SCOPE_CLS_SCALE = 0.01


def scope_model(hypes, device, dtype=torch.float32):
    """The full-width SCOPE model with phase 12's seeded random weights
    (``init_random_`` seed 0, the cls head scaled by SCOPE_CLS_SCALE), cast
    to ``dtype`` for serving."""
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import cast_weights_, init_random_

    model = init_random_(build_model(hypes, device=device), seed=0)
    with torch.no_grad():
        model.cls_head.weight.mul_(SCOPE_CLS_SCALE)
    return model if dtype == torch.float32 else cast_weights_(model, dtype)


def scope_setup(card):
    """The SCOPE det model at full width (``hypes_yaml/opv2v/opv2v_scope.yaml``,
    nothing cut: 5 vehicles, 2 frames, bf16 serving cast, seeded random
    weights) and N_SCENES scenes on the card, built as
    ``tools/bench_workloads.py`` builds ``temporal_det``."""
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import batch_to_torch

    hypes = load_yaml(SCOPE)
    model = scope_model(hypes, "cuda", torch.bfloat16)
    frames = int(hypes["model"]["args"]["fusion_args"]["frame"])
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    scenes = [batch_to_torch(scope_scene(
        rng, model.layout, frames, hypes["preprocess"]["cav_lidar_range"],
        num_objects=12, num_agents={"vehicle": model.layout.total},
        points_per_agent=POINTS_PER_AGENT, pts_per_box=100), "cuda")
        for _ in range(N_SCENES)]
    print(f"phase 12 SCOPE [{card}]: {N_SCENES} scenes of {frames} frames x "
          f"{model.layout.total} vehicles made in {time.perf_counter() - t0:.2f} s")
    return hypes, model, scenes


def scope_step(hypes, model):
    """One SCOPE scene: the model's four stages (each marked by the model)
    and decode + rotated NMS."""
    decode, _ = det_decoder(hypes)

    def run(batch, mark):
        with torch.inference_mode():
            out = model(batch, mark)
            det = decode(out)
            mark(DET_STAGES[3])
        return out, det

    return run


def phase_scope(card):
    """Phase 12: the SCOPE det path at full width in ``auto`` and, to show
    that no K4 runs on it, ``pallas`` mode: the convolutions' and Linears'
    operations per scene from the configuration's shapes and their time at
    the dense bf16 peak; timed runs (K1 2, K2 1, K4a 0 launches per scene,
    asserted), stage times, peak memory, a profile window with each
    stage's device busy and the idle share, kept detections and NMS passes;
    then one perturbed scene through the f32 model on the card and on the
    CPU."""
    hypes, model, scenes = scope_setup(card)
    run = scope_step(hypes, model)
    ops = scope_ops(hypes, POINTS_PER_AGENT)
    floor_ms = sum(ops.values()) / BF16_OPS_PER_S * 1e3
    print(f"phase 12 SCOPE [{card}] operations per scene (convolutions and "
          f"Linears, from the configuration's shapes): "
          f"{sum(ops.values()) / 1e12:.4f} T ("
          + json.dumps({k: round(v / 1e12, 4) for k, v in ops.items()})
          + f"); at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s of dense bf16 "
          f"{floor_ms:.4f} ms")
    set_tf32(False)
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32 = True  # PyTorch's defaults for bf16
    cudnn.benchmark, cudnn.deterministic = True, False
    want = {"pillar_encode": 2, "quad_iou": 1}
    res = {}
    for mode in ("auto", "pallas"):  # K4a 0 in both: SCOPE has no ConvBNReLU
        with conv_mode(mode):
            res[mode] = time_path(f"phase 12 SCOPE {mode} [{card}]", run,
                                  scenes, want)
        res[mode]["launches_per_scene"] = dict(want, conv3x3=0)
    _, hw = det_decoder(hypes)
    for mode in ("auto", "pallas"):
        label = f"phase 12 SCOPE {mode} [{card}]"
        with conv_mode(mode):
            prof = phase_profile(label, run, scenes, top=12, n=PROFILED_SCENES)
        res[mode]["profile"] = prof
        if prof:
            print(f"{label} device busy {prof['busy_ms']:.3f} ms/scene, "
                  f"{prof['busy_ms'] / floor_ms:.1f}x the {floor_ms:.3f} ms "
                  "the operations take at the bf16 peak")
        results = res[mode].pop("results")
        res[mode]["kept"] = check_det(label, results, hw, SCOPE_HEADS)
        res[mode]["nms_passes"] = [det.nms_passes for _, det in results]
    del model, run, scenes
    torch.cuda.empty_cache()
    out = {"card": card, "tflop": {k: v / 1e12 for k, v in ops.items()},
           "ops_ms_at_peak": floor_ms, **res}
    out["perturbed_f32_card_vs_cpu"] = scope_f32_vs_cpu(card, hypes)
    return out


def scope_f32_vs_cpu(card, hypes):
    """One full-width scene with perturbed history and ego-row poses through
    the f32 model (``scope_model``, TF32 off, pinned cuDNN) on the card and
    on the CPU: psm, rm and the late-fused map within TINY_TOL x (1 +
    scale); the comm masks and query cells equal, with the margins at the
    comm threshold and the query cut."""
    from airv2x_tpu_torch.data.synthetic import batch_to_torch

    models = {d: scope_model(hypes, d) for d in ("cpu", "cuda")}
    layout = models["cpu"].layout
    scene = scope_scene(np.random.default_rng(8), layout,
                        int(hypes["model"]["args"]["fusion_args"]["frame"]),
                        hypes["preprocess"]["cav_lidar_range"],
                        pose_rng=np.random.default_rng(9), num_objects=12,
                        num_agents={"vehicle": layout.total},
                        points_per_agent=POINTS_PER_AGENT, pts_per_box=100)
    set_tf32(False)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    res, secs = {}, {}
    try:
        for d, model in models.items():
            fused = []
            hook = model.late_fusion.register_forward_hook(
                lambda mod, args, o: fused.append(o))
            t0 = time.perf_counter()
            try:
                margins, caught, outs = scope_margins(model, batch_to_torch(scene, d))
            finally:
                hook.remove()
            if d == "cuda":
                torch.cuda.synchronize()
            secs[d] = time.perf_counter() - t0
            res[d] = dict(margins=margins, caught=caught,
                          outs=dict(outs, late_fused=fused[0]))
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    keys = ("psm", "rm", "late_fused")
    margins = res["cpu"]["margins"]
    same = scope_same_decisions(res["cuda"], res["cpu"])
    errs = {k: float((res["cuda"]["outs"][k].cpu().double()
                      - res["cpu"]["outs"][k].double()).abs().max()) for k in keys}
    scales = {k: float(res["cpu"]["outs"][k].abs().max()) for k in keys}
    print(f"phase 12 SCOPE perturbed scene, f32 [{card}]: card against CPU "
          f"{same}; margins comm {margins['comm']:.3e}, query cut "
          f"{margins['topk']:.3e} (CPU {secs['cpu']:.1f} s, card "
          f"{secs['cuda']:.2f} s)")
    compare(f"phase 12 SCOPE perturbed scene, f32, card vs CPU [{card}]",
            res["cuda"]["outs"], res["cpu"]["outs"], keys)
    if not same["comm masks equal"]:
        raise AssertionError(f"phase 12 perturbed scene: {same}")
    del models, res
    torch.cuda.empty_cache()
    return {"max_abs_err": errs, "scale": scales, "tol": TINY_TOL,
            "margins": margins, "same": same, "cpu_s": secs["cpu"]}


# phase 15's configurations: (task, YAML name) under hypes_yaml/airv2x/lidar;
# intermediate.yaml names the class of att_fusion.yaml and is only built
FAMILY_DIR = os.path.join(REPO, "hypes_yaml/airv2x/lidar")
FAMILY_PATHS = (("det", "att_fusion"), ("det", "max_fusion"), ("det", "cobevt"),
                ("det", "v2vnet"), ("det", "when2com"), ("seg", "cobevt"),
                ("seg", "v2vnet"), ("seg", "when2com"))
FAMILY_RUNS = 1  # timed runs per path and mode, after a warm-up (2 until PR 14)
# phase 4f: the poses seed of the tiny family's scene, the first from 1 up
# whose V2VNet ROI samples lie more than ROI_MARGIN from 0.5 (1: 1.49e-5),
# and init_random_'s seed of its models, the first from 3 up whose decoded
# IoUs on the CPU lie more than ROI_MARGIN from the NMS threshold in every
# det model and conv mode
TINY_FAMILY_SEED = 3
TINY_FAMILY_POSES = 2


def family_path(task, name):
    return os.path.join(FAMILY_DIR, task, f"{name}.yaml")


def tiny_family_scene(hypes):
    """Phase 4f's scene (numpy, batch 1): the tiny config's ``make_scene``
    with its drone slot absent, perturbed poses and ``pairwise_t_full``."""
    from airv2x_tpu_torch.data.synthetic import make_scene, perturb_poses
    from airv2x_tpu_torch.models.base import SlotLayout

    b, _ = make_scene(np.random.default_rng(2),
                      SlotLayout.from_args(hypes["model"]["args"]),
                      num_objects=6, points_per_agent=2048, pts_per_box=60,
                      lidar_range=hypes["preprocess"]["cav_lidar_range"],
                      num_agents={"vehicle": 2, "rsu": 1, "drone": 0})
    return perturb_poses(with_lead(b), np.random.default_rng(TINY_FAMILY_POSES))


def v2vnet_roi_samples(hypes, pairwise_t_full):
    """V2VNet's ROI samples (the ones canvas warped by every (receiver,
    sender) affine, which its mask thresholds at 0.5) on
    ``pairwise_t_full``'s device, at the agents' map size (the config's
    ``conv_gru`` H x W)."""
    from airv2x_tpu_torch.ops.warp import (
        normalized_pairwise_affine, warp_affine_normalized)

    v2v = hypes["model"]["args"]["v2vfusion"]
    hw = int(v2v["conv_gru"]["H"]), int(v2v["conv_gru"]["W"])
    aff = normalized_pairwise_affine(pairwise_t_full, hw[0], hw[1],
                                     v2v["voxel_size"][0],
                                     v2v["downsample_rate"]).reshape(-1, 2, 3)
    ones = torch.ones((1,) + tuple(hw) + (1,), device=aff.device)
    idx = torch.zeros(len(aff), dtype=torch.int64, device=aff.device)
    return warp_affine_normalized(ones, aff, idx)


def v2vnet_roi_margin(hypes, pairwise_t_full):
    """The ROI samples' smallest distance from 0.5."""
    return float((v2vnet_roi_samples(hypes, pairwise_t_full) - 0.5).abs().min())


def phase_tiny_family():
    """Phase 4f: the tiny intermediate-family models (TINY_FAMILY), det for
    every registered name and seg for FAMILY_SEG, on the card against the
    same weights on the CPU, f32 with TF32 off and pinned cuDNN, in ``auto``
    and ``pallas``, on a scene with an absent agent and perturbed
    ``pairwise_t_full``: outputs within TINY_TOL x (1 + scale), equal keep
    sets, K1 3 / K4a 3 (``pallas``; the tiny backbone's 3 layers) / K2 1
    (det) launches asserted, and the ROI and NMS margins bounded."""
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import batch_to_torch
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    set_tf32(False)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    base = load_yaml(TINY)
    scene = tiny_family_scene(base)
    batch = {d: batch_to_torch(scene, d) for d in ("cpu", "cuda")}
    per_pass = sum(base["model"]["args"]["modality_fusion"][
        "base_bev_backbone"]["layer_nums"])
    out = {}
    try:
        for name, task in ([(n, "det") for n in TINY_FAMILY]
                           + [(n, "seg") for n in FAMILY_SEG]):
            hypes = tiny_family_hypes(base, name, task)
            det = task == "det"
            keys = (("psm", "rm", "obj") if det
                    else ("dynamic_seg", "static_seg")) + ("comm_rate",)
            models = {d: init_random_(build_model(hypes, device=d),
                                      seed=TINY_FAMILY_SEED)
                      for d in ("cpu", "cuda")}
            for mode in ("auto", "pallas"):
                res = {}
                for d, model in models.items():
                    decode, _ = det_decoder(hypes, d, TINY_SCOPE_TOP_K)
                    kernels.reset_launch_counts()
                    with conv_mode(mode), torch.inference_mode():
                        o = model(batch[d])
                        dets = decode(o) if det else None
                    if d == "cuda":
                        torch.cuda.synchronize()
                    res[d] = (o, dets, dict(kernels.LAUNCHES))
                n = res["cuda"][2]
                want = {"pillar_encode": 3, "quad_iou": int(det),
                        "conv3x3": per_pass if mode == "pallas" else 0}
                if n != {k: want.get(k, 0) for k in n}:
                    raise AssertionError(f"tiny {name} {task} {mode}: {n}")
                margins = {}
                if det:
                    margins["nms"] = nms_margin(res["cpu"][1],
                                                hypes["postprocess"]["nms_thresh"])
                if name == "airv2x_v2vnet":
                    margins["roi"] = v2vnet_roi_margin(
                        hypes, batch["cpu"]["pairwise_t_full"])
                label = (f"phase 4f tiny {name} {task} {mode} card vs CPU "
                         f"({n['pillar_encode']} K1, {n['conv3x3']} K4a, "
                         f"{n['quad_iou']} K2 launches; margins "
                         + json.dumps({k: float(f"{v:.3e}") for k, v in margins.items()})
                         + f", limit {ROI_MARGIN})")
                compare(label, res["cuda"][0], res["cpu"][0], keys)
                kept = None
                if det:
                    same = bool(torch.equal(res["cuda"][1].mask.cpu(),
                                            res["cpu"][1].mask))
                    kept = int(res["cpu"][1].mask.sum())
                    print(f"phase 4f tiny {name} {mode}: keep sets card == CPU "
                          f"{same}, {kept} kept")
                    if not same or not kept:
                        raise AssertionError(f"tiny {name} {mode}: keep sets "
                                             f"{same}, {kept} kept")
                if margins and min(margins.values()) <= ROI_MARGIN:
                    raise AssertionError(f"tiny {name} {task}: margins {margins}")
                out[f"{name} {task} {mode}"] = {"margins": margins, "kept": kept}
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    return out


def family_model(path, device="cuda"):
    """The cut config at ``path`` and its f32 model with phase 15's seeded
    random weights (``init_random_`` seed 0, drawn on ``device``)."""
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    hypes = cut_hypes(path)
    model = build_model(hypes, device=device)
    return hypes, init_random_(model, seed=0, device=device)


def phase_family(card):
    """Phase 15: the intermediate family at full width (FAMILY_PATHS, cut
    and scened as phase 5, bf16, seeded random weights drawn on the card),
    each path in ``auto`` and ``pallas``, FAMILY_RUNS timed runs after a
    warm-up: the fusion's operations per scene (the work its function
    needs and the work the code executes, from the configuration's shapes,
    ``family_ops``) and their time at the dense bf16 peak; ms/scene, stage
    times (encoder, backbone + shrink, fusion, heads, decode), peak memory,
    launch counts (K1 3, K2 1 per det scene, K4a 16 in ``pallas``,
    asserted), a ``pallas`` profile window with the device busy per stage
    and the idle share, kept detections or class histograms; then one
    perturbed det scene per fusion kind (cobevt, v2vnet, when2com) through
    the f32 model on the card and on the CPU, and V2VNet scoring phase 13's
    on-disk scenario through ``inference_multi_scenario`` in ``pallas``."""
    from airv2x_tpu_torch.models.intermediate_models import Airv2xAttFusion
    from airv2x_tpu_torch.utils.weights import cast_weights_

    hypes, model = family_model(family_path("det", "intermediate"))
    if type(model) is not Airv2xAttFusion:
        raise AssertionError(f"intermediate.yaml built {type(model)}")
    per_pass = sum(hypes["model"]["args"]["modality_fusion"][
        "base_bev_backbone"]["layer_nums"])
    scenes, _ = lidar_scenes(hypes, model.layout)
    del model
    set_tf32(False)
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32 = True  # PyTorch's defaults for bf16
    cudnn.benchmark, cudnn.deterministic = True, False
    out = {"card": card}
    for task, name in FAMILY_PATHS:
        hypes, model = family_model(family_path(task, name))
        cast_weights_(model, torch.bfloat16)
        label = f"phase 15 {task}/{name}"
        with torch.inference_mode():
            shape = tuple(model.backbone(model.encode(scenes[0])).shape[2:])
        ops = {kind: family_ops(hypes, scenes[0], shape, needed=kind == "needed")
               for kind in ("needed", "executed")}
        at_peak = {kind: sum(o.values()) / BF16_OPS_PER_S * 1e3
                   for kind, o in ops.items()}
        for kind, o in ops.items():
            print(f"{label} [{card}] fusion operations per scene, {kind}: "
                  f"{sum(o.values()) / 1e12:.4f} T ("
                  + json.dumps({k: round(v / 1e12, 4) for k, v in o.items()})
                  + f"); at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s of dense bf16 "
                  f"{at_peak[kind]:.4f} ms")
        weights = sum(p.numel() * p.element_size()
                      for p in (model.fusion_net or torch.nn.Module()).parameters())
        print(f"{label} [{card}] fusion weights {weights / 1e6:.1f} MB, read "
              f"once per scene: {weights / HBM_BYTES_PER_S * 1e3:.4f} ms at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
        run = staged_step(hypes, model, FAMILY_STAGES)
        res = {}
        for mode in ("auto", "pallas"):
            want = {"pillar_encode": 3}
            if task == "det":
                want["quad_iou"] = 1
            if mode == "pallas":
                want["conv3x3"] = per_pass
            with conv_mode(mode):
                res[mode] = time_path(f"{label} {mode} [{card}]", run, scenes,
                                      want, runs=FAMILY_RUNS)
            res[mode]["launches_per_scene"] = want
        with conv_mode("pallas"):
            res["pallas"]["profile"] = phase_profile(
                f"{label} pallas [{card}]", run, scenes, top=10, n=PROFILED_SCENES)
        for mode in ("auto", "pallas"):
            results = res[mode].pop("results")
            if task == "det":
                res[mode]["kept"] = check_det(f"{label} {mode}", results,
                                              det_decoder(hypes)[1])
            else:
                res[mode]["class_hist"] = check_seg(f"{label} {mode}", results,
                                                    hypes["model"]["args"])
        res["fusion_tflop"] = {kind: {k: v / 1e12 for k, v in o.items()}
                               for kind, o in ops.items()}
        res["fusion_floor_ms"] = at_peak["needed"]
        res["fusion_weight_mb"] = weights / 1e6
        res["fusion_executed_ms_at_peak"] = at_peak["executed"]
        out[f"{task}/{name}"] = res
        del model, run
        torch.cuda.empty_cache()
    del scenes
    torch.cuda.empty_cache()
    out["perturbed_f32_card_vs_cpu"] = {
        name: family_f32_vs_cpu(card, name) for name in ("cobevt", "v2vnet",
                                                         "when2com")}
    out["on_disk_v2vnet"] = family_on_disk(card)
    return out


def family_f32_vs_cpu(card, name):
    """One perturbed det scene (``perturbed_scene``: perturbed poses and
    ``pairwise_t_full``) through the full-width f32 ``name`` model at one
    layer per backbone stage and one fusion block or round
    (``shallow_hypes``; seeded random weights drawn on the card, copied to
    the CPU; TF32 off, pinned cuDNN, ``auto``) on the card and on the CPU:
    the fused ego map and psm / rm / obj within TINY_TOL x (1 + scale);
    V2VNet's ROI mask on the card equal to the CPU's (at full width some of
    its 1.27 M samples lie within 1e-5 of 0.5, or on it: the two compute
    the sample coordinates bit for bit)."""
    from airv2x_tpu_torch.data.synthetic import batch_to_torch
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    hypes = shallow_hypes(cut_hypes(family_path("det", name)))
    card_model = init_random_(build_model(hypes, device="cuda"), seed=0,
                              device="cuda")
    models = {"cpu": build_model(hypes, device="cpu"), "cuda": card_model}
    models["cpu"].load_state_dict(card_model.state_dict())
    scene = perturbed_scene(hypes, card_model.layout)
    set_tf32(False)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    outs, secs, roi = {}, {}, {}
    try:
        for d, model in models.items():
            batch = batch_to_torch(scene, d)
            t0 = time.perf_counter()
            with conv_mode("auto"), torch.inference_mode():
                fused = model.fuse(model.backbone(model.encode(batch)), batch)
                outs[d] = dict(model.heads(fused), fused=fused)
            torch.cuda.synchronize()
            secs[d] = time.perf_counter() - t0
            if name == "v2vnet":
                roi[d] = v2vnet_roi_samples(hypes, batch["pairwise_t_full"]).cpu()
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    keys = ("fused", "psm", "rm", "obj")
    errs = {k: float((outs["cuda"][k].cpu().double()
                      - outs["cpu"][k].double()).abs().max()) for k in keys}
    scales = {k: float(outs["cpu"][k].abs().max()) for k in keys}
    note, margin = "", None
    if roi:
        margin = float((roi["cpu"] - 0.5).abs().min())
        same = bool(torch.equal(roi["cuda"] > 0.5, roi["cpu"] > 0.5))
        note = (f"; ROI mask card == CPU: {same}, samples' smallest distance "
                f"from 0.5 {margin:.3e}, max|card - CPU| "
                f"{float((roi['cuda'] - roi['cpu']).abs().max())}")
        if not same:
            raise AssertionError(f"phase 15 {name}: the ROI mask differs on "
                                 "the card")
    compare(f"phase 15 {name} perturbed det scene, f32, card vs CPU [{card}] "
            f"(CPU {secs['cpu']:.1f} s, card {secs['cuda']:.2f} s{note})",
            outs["cuda"], outs["cpu"], keys)
    del models, card_model, outs
    torch.cuda.empty_cache()
    return {"max_abs_err": errs, "scale": scales, "tol": TINY_TOL,
            "cpu_s": secs["cpu"], "roi_margin": margin}


def family_on_disk(card):
    """Phase 13's on-disk scenario (``write_scenario``) scored once by the
    V2VNet det model (phase 5's cut, bf16, ``eval_run_dir``'s seeded
    weights) through ``inference_multi_scenario`` in ``pallas``: a finite
    AP table, and K1 3, K4a 16 and K2 at least 2 (NMS and the AP) launches
    per scene."""
    import shutil

    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.models.base import SlotLayout
    from airv2x_tpu_torch.tools import inference_multi_scenario

    work = scratch_dir("chip_smoke_family_")
    try:
        root = os.path.join(work, "test")
        hypes, run_dir = eval_run_dir(family_path("det", "v2vnet"), root, work)
        args = hypes["model"]["args"]
        write_scenario(root, SlotLayout.from_args(args),
                       hypes["preprocess"]["cav_lidar_range"],
                       seg_hw=int(args["seg_hw"]), seg_res=float(args["seg_res"]))
        n = SCENARIO_STAMPS
        with conv_mode("pallas"):
            kernels.reset_launch_counts()
            res = inference_multi_scenario.main(
                ["--model_dir", run_dir, "--device", "cuda"])
            torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        per = {k: v / n for k, v in launches.items()}
        label = f"phase 15 v2vnet on disk, pallas [{card}]"
        print(f"{label}: {res['ms_per_scene']:.3f} ms/scene (load + forward + "
              f"decode + AP, one run, cold), launches per scene {per}; "
              + json.dumps(eval_table("det", res)))
        if not (launches["pillar_encode"] == 3 * n and launches["conv3x3"] == 16 * n
                and launches["quad_iou"] >= 2 * n):
            raise AssertionError(f"{label}: launches {launches} over {n} scenes")
        if not all(np.isfinite(list(_numbers(res)))):
            raise AssertionError(f"{label}: a non-finite metric: {res}")
        return {"table": eval_table("det", res), "ms_per_scene": res["ms_per_scene"],
                "launches": launches, "launches_per_scene": per}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# Phase 13's on-disk scenario, in the layout tests/fixture_utils.py:make_fixture
# writes: carriers' world poses and the lidar mount as the AirV2X metadata
# gives them (x, y, z in m; roll, yaw, pitch in degrees)
SCENARIO_EGO_POSE = (100.0, 50.0, 0.0, 0.0, 30.0, 0.0)
SCENARIO_MOUNT = (0.0, 0.0, 1.9, 0.0, 0.0, 0.0)
SCENARIO_HEIGHT = {"vehicle": 0.0, "rsu": 4.0, "drone": 60.0}
SCENARIO_NAME = "2025_01_02_00_00_00"
SCENARIO_STAMPS = 8


def _write_seg_layers(adir, files, label):
    """One PNG mask per layer, such that ``data/camera.py:load_seg_labels``
    reads ``label`` back (it transposes, flips the columns and lets the last
    layer win)."""
    from PIL import Image

    img = np.ascontiguousarray(label[:, ::-1].T)
    for k, name in enumerate(files):
        Image.fromarray(np.where(img == k, 255, 0).astype(np.uint8)).save(
            os.path.join(adir, name))


# each camera's yaw about the carrier's z axis (degrees; None: looking
# straight down) and its mount (x, y, z in m from the lidar), by metadata key
CAMERA_RIG = {
    "front_camera": (0.0, (1.5, 0.0, 0.0)),
    "front_left_camera": (55.0, (1.2, 0.8, 0.0)),
    "front_right_camera": (-55.0, (1.2, -0.8, 0.0)),
    "rear_camera": (180.0, (-1.8, 0.0, 0.0)),
    "rear_left_camera": (110.0, (-1.0, 0.8, 0.0)),
    "rear_right_camera": (-110.0, (-1.0, -0.8, 0.0)),
    "back_camera": (180.0, (-0.3, 0.0, 0.0)),
    "left_camera": (90.0, (0.0, 0.3, 0.0)),
    "right_camera": (-90.0, (0.0, -0.3, 0.0)),
    "bev_camera": (None, (0.0, 0.0, -0.5)),
}
CAMERA_HW = (720, 1280)  # the AirV2X camera images' H x W
# the AirV2X camera augmentation values hypes_yaml/airv2x/lidar/det/bm2cp.yaml
# records; the shipped camera YAMLs give data_aug_conf only final_dim
AIRV2X_AUG = {"H": 720, "W": 1280, "resize_lim": [0.65, 0.7],
              "bot_pct_lim": [0.0, 0.05], "rot_lim": [0, 0], "rand_flip": False}


def camera_to_lidar(key):
    """The LSS-axes camera -> lidar matrix of CAMERA_RIG[key] (x right, y
    down, z along the view)."""
    yaw, mount = CAMERA_RIG[key]
    m = np.eye(4, dtype=np.float32)
    if yaw is None:  # looking down, image up along the carrier's +x
        m[:3, :3] = [[0, -1, 0], [-1, 0, 0], [0, 0, -1]]
    else:
        c, s = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
        m[:3, :3] = [[s, 0, c], [-c, 0, s], [0, -1, 0]]
    m[:3, 3] = mount
    return m


def smooth_image(rng, hw):
    """A seeded (H, W, 3) uint8 image of two gradients and a few discs and
    boxes: smooth, so that it compresses, and not constant."""
    h, w = hw
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    a, b, c = (rng.uniform(0, 255, 3).astype(np.float32) for _ in range(3))
    img = a + (b - a) * y + (c - a) * x * 0.5
    yy, xx = np.arange(h)[:, None], np.arange(w)[None, :]
    for _ in range(4):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(0.05, 0.2) * h
        color = rng.uniform(0, 255, 3).astype(np.float32)
        if rng.uniform() < 0.5:
            inside = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        else:
            inside = (np.abs(yy - cy) < r) & (np.abs(xx - cx) < 1.5 * r)
        img = np.where(inside[..., None], color, img)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_cameras(adir, agent_type, rng, hw=CAMERA_HW):
    """Every camera of ``agent_type`` (``CAM_KEYS``) into ``adir``: a
    ``smooth_image`` PNG per camera and the metadata entries (the intrinsic
    of a 90-degree horizontal view, the UE4 extrinsic of
    ``camera_to_lidar``); no depth PNG, which no camera config of a ported
    model reads. Returns the metadata entries."""
    from PIL import Image

    from airv2x_tpu_torch.data.camera import CAM_KEYS, lss_to_ue4

    h, w = hw
    f = w / 2.0
    meta = {}
    for key in CAM_KEYS[agent_type]:
        Image.fromarray(smooth_image(rng, hw)).save(
            os.path.join(adir, key + ".png"), compress_level=1)
        meta[key] = {"intrinsic": np.array([[f, 0, w / 2], [0, f, h / 2],
                                            [0, 0, 1]], np.float32),
                     "extrinsic": lss_to_ue4(camera_to_lidar(key))}
    return meta


def write_scenario(root, layout, lidar_range, *, stamps=SCENARIO_STAMPS,
                   num_agents=NUM_AGENTS, points_per_agent=POINTS_PER_AGENT,
                   num_objects=12, seg_hw=0, seg_res=0.25, seed=0,
                   camera_hw=None):
    """Write one AirV2X scenario under ``root``: ``stamps`` timestamps of
    the agents of ``num_agents`` (ids 1, 2, ...: vehicles, RSUs, drones; the
    ego is agent 1), each with ``metadata.pkl`` and ``lidar.pcd``, and an
    ``objects.pkl`` per timestamp. Each timestamp is one ``make_scene`` draw
    (``points_per_agent`` points per agent, ``num_objects`` objects, in the
    ego-lidar frame), placed in the world at the ego's pose; every other
    agent stands within 67 m of the ego with a random yaw and gets its
    slot's cloud in its own lidar frame. With ``seg_hw``, every agent dir
    also holds the 7 dynamic layers (the objects rasterized at ``seg_res``
    m/px) and the 3 static ones (lanes and a road band) as PNGs. With
    ``camera_hw``, every agent dir also holds its type's cameras
    (``write_cameras``: images of that H x W), drawn from a generator of
    their own so that the rest is the same.
    Returns ``root``."""
    import pickle

    from airv2x_tpu_torch.data.camera import DYNAMIC_SEG_FILES, STATIC_SEG_FILES
    from airv2x_tpu_torch.data.pcd import write_pcd
    from airv2x_tpu_torch.data.synthetic import make_scene, rasterize_seg_labels
    from airv2x_tpu_torch.models.base import AGENT_TYPES
    from airv2x_tpu_torch.utils.transforms import pose_a_to_b, pose_to_world

    rng = np.random.default_rng(seed)
    cam_rng = np.random.default_rng((seed, 1))
    types = [t for t in AGENT_TYPES for _ in range(num_agents.get(t, 0))]
    c, s = np.cos(np.radians(SCENARIO_EGO_POSE[4])), np.sin(
        np.radians(SCENARIO_EGO_POSE[4]))
    poses = [list(SCENARIO_EGO_POSE)]
    for t in types[1:]:
        dx, dy = rng.uniform(-60, 60), rng.uniform(-30, 30)
        poses.append([SCENARIO_EGO_POSE[0] + c * dx - s * dy,
                      SCENARIO_EGO_POSE[1] + s * dx + c * dy,
                      SCENARIO_HEIGHT[t], 0.0, float(rng.uniform(-180, 180)), 0.0])
    lidar = [[p + m for p, m in zip(pose, SCENARIO_MOUNT)] for pose in poses]
    world_from_ego = pose_to_world(lidar[0])
    # each agent's slot: its index among the agents of its type
    slots = [layout.slots(t).start + types[:i].count(t) for i, t in enumerate(types)]
    static = np.zeros((seg_hw, seg_hw), np.int32)
    static[np.arange(seg_hw) % 32 < 2] = 1  # lanes
    static[:, seg_hw * 3 // 8:seg_hw * 5 // 8] = 2  # a road band
    for ts in range(stamps):
        batch, gt = make_scene(rng, layout, num_objects=num_objects,
                               num_agents=num_agents,
                               points_per_agent=points_per_agent,
                               lidar_range=lidar_range, pts_per_box=100)
        tdir = os.path.join(root, SCENARIO_NAME, f"timestamp_{ts:06d}")
        if seg_hw:
            dynamic = rasterize_seg_labels(gt["boxes"], gt["mask"],
                                           gt["classes"], seg_hw, seg_res)
        for aid, (t, pose, slot) in enumerate(zip(types, poses, slots), 1):
            adir = os.path.join(tdir, f"agent_{aid:06d}")
            os.makedirs(adir, exist_ok=True)
            meta = {"agent_type": t,
                    "odometry": {"ego_pos": pose,
                                 "ego_speed": 0.0 if t == "rsu" else 10.0},
                    "lidar": {"lidar_pose": list(SCENARIO_MOUNT)}}
            if camera_hw:
                meta.update(write_cameras(adir, t, cam_rng, camera_hw))
            with open(os.path.join(adir, "metadata.pkl"), "wb") as f:
                pickle.dump(meta, f)
            agent_from_ego = np.linalg.inv(pose_a_to_b(lidar[aid - 1], lidar[0]))
            pts = batch["points"][slot][batch["points_mask"][slot]].astype(np.float64)
            pts[:, :3] = pts[:, :3] @ agent_from_ego[:3, :3].T + agent_from_ego[:3, 3]
            write_pcd(os.path.join(adir, "lidar.pcd"), pts)
            if seg_hw:
                _write_seg_layers(adir, DYNAMIC_SEG_FILES, dynamic)
                _write_seg_layers(adir, STATIC_SEG_FILES, static)
        objects = {}
        for i in np.nonzero(gt["mask"])[0]:
            x, y, z, h, w, l, yaw = gt["boxes"][i].astype(np.float64)
            wx, wy, wz = world_from_ego[:3, :3] @ [x, y, z] + world_from_ego[:3, 3]
            objects[1000 + int(i)] = {
                "class": int(gt["classes"][i]),
                "location": [wx, wy, wz, 0.0, lidar[0][4] + np.degrees(yaw), 0.0],
                "center": [0.0, 0.0, 0.0], "extent": [l / 2, w / 2, h / 2]}
        with open(os.path.join(tdir, "objects.pkl"), "wb") as f:
            pickle.dump(objects, f)
    return root


def eval_run_dir(path, root, work, cut=None):
    """A run dir under ``work`` for the config at ``path``, cut as phase 5
    (or by ``cut``, a function of the path), computing in bf16 and reading
    the scenario at ``root`` (its train and test dir), holding phase 5's
    seeded random weights as epoch 1."""
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.parallel.train import TrainState
    from airv2x_tpu_torch.utils.checkpoint import save_checkpoint, setup_train_dir
    from airv2x_tpu_torch.utils.weights import init_random_

    hypes = (cut or cut_hypes)(path)
    hypes["model"]["args"]["dtype"] = "bf16"
    hypes["root_dir"] = hypes["test_dir"] = root
    hypes["validate_dir"] = ""
    run_dir = setup_train_dir(hypes, work)
    model = init_random_(build_model(hypes, device="cuda"), seed=0)
    save_checkpoint(run_dir, 1, TrainState(
        model, torch.optim.SGD(model.parameters(), lr=0.0)))
    return hypes, run_dir


def same_batch(card, cpu):
    """{key: max |card - CPU|} over every tensor of two loader batches (the
    labels' too); the shapes and dtypes must agree."""
    out = {}
    for k, v in card.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": d for kk, d in same_batch(v, cpu[k]).items()})
            continue
        w = cpu[k]
        if v.shape != w.shape or v.dtype != w.dtype:
            raise AssertionError(f"phase 13 batch {k}: {v.shape} {v.dtype} on "
                                 f"the card, {w.shape} {w.dtype} on the CPU")
        out[k] = float((v.cpu().double() - w.double()).abs().max()) if v.numel() else 0.0
    return out


def _numbers(obj):
    """Every number in a nested dict / list of a CLI's result."""
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _numbers(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _numbers(v)
    elif isinstance(obj, (int, float)):
        yield obj


def eval_table(name, out):
    """The headline numbers of an evaluation CLI's result: the COMBINED AP
    row (det), the mAP row (multiclass), the mIoUs (seg)."""
    if name == "det":
        return out["COMBINED"]
    if name == "multiclass":
        return {k: out[k] for k in ("map_30", "map_50", "map_70", "comm_rate")}
    return {"combined_miou": out["combined_miou"],
            "dynamic_miou": out["dynamic"]["mean_iou"],
            "static_miou": out["static"]["mean_iou"], "comm_rate": out["comm_rate"]}


def eval_train(card, hypes, work):
    """3 steps of the train CLI on ``hypes``' ``root_dir`` (a config of
    ``eval_run_dir``: the cut flagship det config in bf16), through
    ``RealDataLoader`` with 2 workers, batch 2; the loss parts must be
    finite."""
    import re

    from airv2x_tpu_torch.config import save_yaml
    from airv2x_tpu_torch.tools import train

    cfg = os.path.join(work, "train.yaml")
    save_yaml(hypes, cfg)
    t0 = time.perf_counter()
    run_dir = train.main(["--hypes_yaml", cfg, "--log_dir", work, "--epochs", "1",
                          "--steps_per_epoch", "3", "--batch_size", "2",
                          "--num_workers", "2", "--device", "cuda"])
    seconds = time.perf_counter() - t0
    with open(os.path.join(run_dir, "train_loss.txt")) as f:
        line = f.read().splitlines()[-1]
    parts = {k: float(v) for k, v in re.findall(r"(\w+): (\S+)", line)}
    print(f"phase 13 train CLI on the scenario [{card}]: 3 steps of batch 2 in "
          f"{seconds:.2f} s (model build and workers included): {line}")
    if not parts or not all(np.isfinite(list(parts.values()))):
        raise AssertionError(f"phase 13 training: a non-finite loss: {line}")
    return {"seconds": seconds, "loss_parts": parts}


def scratch_dir(prefix):
    """A fresh directory under the checkout's git-ignored ``logs/``."""
    import tempfile

    os.makedirs(os.path.join(REPO, "logs"), exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=os.path.join(REPO, "logs"))


def phase_ap_gate(card):
    """Phase 14: ``tools/chip_ap_gate.py`` at its default recipe (the tiny
    config trained 20 epochs x 20 steps on the card, 16 synthetic eval
    scenes). The gate requires the card's f32 AP table to equal the CPU's
    within 5e-3; at this recipe's AP (0.0005-0.02) that tolerance cannot
    fail, so this phase requires every AP of the two tables, per scenario
    and COMBINED, to be equal, and the same weights' f32 table in ``pallas``
    mode (K4, the rest at the gate's pinned precision) to equal the card's
    ``auto`` table. The bf16 table is printed, not checked."""
    import shutil

    from airv2x_tpu_torch.tools import chip_ap_gate

    work = scratch_dir("chip_smoke_gate_")
    try:
        t0 = time.perf_counter()
        art = chip_ap_gate.main(["--log_dir", work])
        seconds = time.perf_counter() - t0
        opt = chip_ap_gate.parse_args([])
        with conv_mode("pallas"), chip_ap_gate.pinned_precision():
            pallas = chip_ap_gate.infer(art["run_dir"], opt.num_scenes,
                                        opt.eval_seed, "cuda")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    auto = dict(art["per_scenario_card"], COMBINED=art["ap_card"])
    pallas_equal = chip_ap_gate.ap_rows(pallas) == chip_ap_gate.ap_rows(auto)
    print(f"phase 14 AP gate [{card}] in {seconds:.1f} s: card f32 "
          f"{art['ap_card']}, CPU f32 {art['ap_cpu']}, |diff| {art['abs_diff']} "
          f"(tol {art['tol']}): {art['gate']}; every AP equal: "
          f"{art['identical']}; card bf16, not checked, {art['ap_card_bf16']}")
    print(f"phase 14 [{card}] the same weights in pallas mode (K4), f32: "
          f"{pallas['COMBINED']}; every AP equal to auto's: {pallas_equal}")
    if art["gate"] != "PASS" or not art["identical"]:
        raise AssertionError(f"phase 14: the card's AP table differs from the "
                             f"CPU's: {art}")
    if not pallas_equal:
        raise AssertionError(f"phase 14: the pallas table differs from auto's: "
                             f"{pallas} against {auto}")
    return dict({k: art[k] for k in ("ap_card", "ap_cpu", "abs_diff", "identical",
                                     "ap_card_bf16", "tol", "gate")},
                pallas_f32=pallas["COMBINED"], seconds=seconds)


def phase_eval(card):
    """Phase 13: the evaluation entry points at full width on an on-disk
    scenario (``write_scenario``): the dataset's host ms per sample, one
    batch loaded for the card against the CPU's, the port's
    ``inference_multi_scenario`` and ``inference_airv2x`` (det, ``auto`` and
    ``pallas``) and ``inference_airv2x_seg`` (seg, both modes) on the card
    from phase 5's seeded random weights, each run after a warm-up run with
    its launches counted (K1 3, K4a 32 in ``pallas``, K2 at least 2 per det
    scene: NMS and AP) and the AP's (det, gt) corners caught for
    ``phase_ap_k2``, a profile window of 3 det scenes (load, forward +
    decode, AP), then 3 steps of the train CLI on the scenario."""
    import shutil

    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.data.airv2x_dataset import AirV2XDataset
    from airv2x_tpu_torch.data.loader import RealDataLoader
    from airv2x_tpu_torch.eval import ap
    from airv2x_tpu_torch.eval.ap import accumulate_scene, new_result_stat
    from airv2x_tpu_torch.ops.quad_iou import quad_iou
    from airv2x_tpu_torch.models.base import SlotLayout
    from airv2x_tpu_torch.tools import (
        inference, inference_airv2x, inference_airv2x_seg,
        inference_multi_scenario)

    work = scratch_dir("chip_smoke_eval_")
    try:
        root = os.path.join(work, "test")
        hypes, det_dir = eval_run_dir(FLAGSHIP, root, work)
        seg_hypes, seg_dir = eval_run_dir(SEG, root, work)
        t0 = time.perf_counter()
        write_scenario(root, SlotLayout.from_args(hypes["model"]["args"]),
                       hypes["preprocess"]["cav_lidar_range"],
                       seg_hw=int(seg_hypes["seg_hw"]),
                       seg_res=float(seg_hypes["seg_res"]))
        print(f"phase 13 [{card}]: scenario of {SCENARIO_STAMPS} timestamps, "
              f"{sum(NUM_AGENTS.values())} agents x {POINTS_PER_AGENT} points, "
              f"seg maps {seg_hypes['seg_hw']}^2, written in "
              f"{time.perf_counter() - t0:.2f} s")

        ds = AirV2XDataset(hypes, root, train=False)
        load_ms = []
        for i in range(len(ds)):
            t0 = time.perf_counter()
            batch, gt = ds[i]
            load_ms.append((time.perf_counter() - t0) * 1e3)
        counts = batch["points_mask"].sum(1).tolist()
        print(f"phase 13 [{card}] dataset: {len(ds)} samples, host ms per "
              f"__getitem__ {[round(v, 3) for v in load_ms]} (median "
              f"{statistics.median(load_ms):.3f}); points per slot of the "
              f"last sample {counts} of {batch['points'].shape[1]}, "
              f"{int(gt['mask'].sum())} objects")
        loaded = {dev: next(RealDataLoader(ds, hypes, 1, train=False, num_workers=1,
                                           device=dev).batches())
                  for dev in ("cuda", "cpu")}
        batch_err = same_batch(loaded["cuda"], loaded["cpu"])
        print(f"phase 13 [{card}] one loaded batch, card against CPU, max abs "
              "err per key: " + json.dumps(batch_err))
        bad = {k: v for k, v in batch_err.items()
               if v > (BATCH_TARGET_TOL if k == "labels.targets" else 0.0)}
        if bad:
            raise AssertionError(f"phase 13: the card's batch differs: {bad}")

        res = {"getitem_ms": load_ms, "batch_card_vs_cpu": batch_err}
        n = len(ds)
        runs = (("det", inference_multi_scenario, det_dir),
                ("multiclass", inference_airv2x, det_dir),
                ("seg", inference_airv2x_seg, seg_dir))
        total = dict.fromkeys(kernels.LAUNCHES, 0)
        caught = []  # the AP's (det, gt) corners in the counted runs

        def catch(det, gt, **kw):
            caught.append((det.clone(), gt.clone()))
            return quad_iou(det, gt, **kw)

        for mode in ("auto", "pallas"):
            for name, cli, run_dir in runs:
                label = f"phase 13 {name} {mode} [{card}]"
                argv = ["--model_dir", run_dir, "--device", "cuda"]
                with conv_mode(mode):
                    cli.main(argv)  # warm-up: allocator, cuDNN's choices
                    kernels.reset_launch_counts()
                    ap.quad_iou = catch
                    try:
                        out = cli.main(argv)
                    finally:
                        ap.quad_iou = quad_iou
                    torch.cuda.synchronize()
                launches = dict(kernels.LAUNCHES)
                per = {k: v / n for k, v in launches.items()}
                print(f"{label}: {out['ms_per_scene']:.3f} ms/scene, launches "
                      f"per scene {per}")
                k4 = 32 if mode == "pallas" else 0
                ok = (launches["pillar_encode"] == 3 * n
                      and launches["conv3x3"] == k4 * n
                      and launches["conv3x3_allmaps"] == launches["pillar_reduce"] == 0
                      and (launches["quad_iou"] >= 2 * n if name != "seg"
                           else launches["quad_iou"] == 0))
                if not ok:
                    raise AssertionError(f"{label}: launches {launches} over {n} "
                                         "scenes")
                if not all(np.isfinite(list(_numbers(out)))):
                    raise AssertionError(f"{label}: a non-finite metric: {out}")
                for k, v in launches.items():
                    total[k] += v
                res.setdefault(name, {})[mode] = dict(
                    table=eval_table(name, out), ms_per_scene=out["ms_per_scene"],
                    launches_per_scene=per)

        res["ap_k2"] = phase_ap_k2(f"phase 13 K2 on the AP's input [{card}]",
                                   caught)
        del caught

        # the device's share of one det scene: load, forward + decode, AP
        _, model, _ = inference.load_run(det_dir, "cuda")
        step = inference.det_step(hypes, model, "cuda")
        stat = new_result_stat()

        def run(i, mark):
            scene, gt = ds[i]
            mark("load")
            d = step(scene, gt)
            mark("forward + decode")
            accumulate_scene(d.corners, d.scores, d.gt_corners, stat)
            mark("AP")

        for mode in ("auto", "pallas"):
            with conv_mode(mode):
                res["det"][mode]["profile"] = phase_profile(
                    f"phase 13 det {mode} [{card}]", run, list(range(n)), top=8)
        del model, step

        res["train"] = eval_train(card, hypes, work)
        res["launches"] = total
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


# Phase 16: the camera configs on disk. CAMERA_SCENES timestamps of
# write_scenario's scenario with cameras, each a timed scene, CAMERA_RUNS
# timed runs per path and mode after a warm-up
CAMERA_SCENES = 2
CAMERA_RUNS = 1  # 2 until PR 14
# the tiny camera scene of phase 16 and tests/test_torch_camera_models.py:
# tests/test_torch_camera.py's two scenes (seed 3: every frustum point more
# than CELL_MARGIN of a cell from a boundary) with perturbed poses (seed 2)
TINY_CAMERA_NCAM = {"vehicle": 2, "rsu": 1, "drone": 1}
TINY_CAMERA_POSES = 2
# init_random_'s seed of phase 16's tiny det compositions (3 where absent):
# the first from 3 up whose CPU outputs keep some boxes and lie more than
# ROI_MARGIN from every decision of decode (the objectness gate, the
# candidate pool's cut, the NMS threshold: ``anchor_keep``, ``nms_margin``)
TINY_CAMERA_SEEDS = {("airv2x_v2xvit", "det", "cam"): 4,
                     ("airv2x_v2xvit", "det", "lidar+cam"): 8,
                     ("airv2x_cobevt", "det", "cam"): 6,
                     ("airv2x_when2com", "det", "cam"): 6,
                     ("airv2x_when2com", "det", "lidar+cam"): 17,
                     ("lift_splat_shoot_airv2x", "det", "cam"): 6,
                     ("lift_splat_shoot_airv2x", "det", "lidar+cam"): 6}


def camera_path(task, name):
    return os.path.join(CAMERA_DIR, task, f"{name}.yaml")


def camera_hypes(path):
    """A shipped camera config cut as phase 5, with the AirV2X camera
    augmentation keys (AIRV2X_AUG) its ``data_aug_conf`` lacks."""
    from airv2x_tpu_torch.models.base import AGENT_TYPES

    hypes = cut_hypes(path)
    for t in AGENT_TYPES:
        hypes["model"]["args"][t]["cam"]["data_aug_conf"].update(AIRV2X_AUG)
    return hypes


def tiny_camera_scene(hypes):
    """The tiny camera scene (numpy, batch 2): ``make_scene`` and
    ``add_camera_inputs`` from seed 3 (all agents, then no drone), its poses
    perturbed (``perturb_poses``, seed TINY_CAMERA_POSES)."""
    from airv2x_tpu_torch.data.synthetic import (
        add_camera_inputs, make_scene, perturb_poses)
    from airv2x_tpu_torch.models.base import SlotLayout

    layout = SlotLayout.from_args(hypes["model"]["args"])
    rng = np.random.default_rng(3)
    scenes = []
    for na in ({"vehicle": 2, "rsu": 1, "drone": 1},
               {"vehicle": 2, "rsu": 1, "drone": 0}):
        b, _ = make_scene(rng, layout, num_objects=6, points_per_agent=1024,
                          lidar_range=hypes["preprocess"]["cav_lidar_range"],
                          pts_per_box=60, num_agents=na)
        add_camera_inputs(b, layout, rng, img_hw=(64, 96), ncam=TINY_CAMERA_NCAM)
        scenes.append(b)
    batch = {k: ({kk: np.stack([s[k][kk] for s in scenes]) for kk in scenes[0][k]}
                 if isinstance(scenes[0][k], dict)
                 else np.stack([s[k] for s in scenes])) for k in scenes[0]}
    return perturb_poses(batch, np.random.default_rng(TINY_CAMERA_POSES))


# a camera grid's offset (m) for card-vs-CPU and port-vs-JAX comparisons of
# on-disk camera scenes: the fixture's and write_scenario's symmetric rigs
# put frustum points on the unshifted grid's cell boundaries
GRID_SHIFT = 0.0123


def shift_camera_grid(hypes):
    """``hypes`` with every camera type's grid moved by GRID_SHIFT m on each
    axis (the same cell counts), in place."""
    from airv2x_tpu_torch.models.base import AGENT_TYPES

    for t in AGENT_TYPES:
        cam = hypes["model"]["args"][t].get("cam")
        if cam is None:
            continue
        for axis in ("xbound", "ybound", "zbound"):
            lo, hi, step = cam["grid_conf"][axis]
            cam["grid_conf"][axis] = [lo + GRID_SHIFT, hi + GRID_SHIFT, step]
    return hypes


def camera_frustum_margin(hypes, batch):
    """Smallest distance, in cell widths, of a frustum point of a numpy
    batch's present agents' cameras to a cell boundary, over every camera
    type of ``hypes`` (the geometry on the CPU, in float64 from the f32
    points). An absent agent's map is zeroed after the encoder."""
    from airv2x_tpu_torch.models.base import AGENT_TYPES
    from airv2x_tpu_torch.models.camera.lss import (
        create_frustum, gen_dx_bx, get_geometry)

    margin = np.inf
    for t in AGENT_TYPES:
        args = hypes["model"]["args"][t]
        if "cam" not in args.get("modalities", []) or f"cam_{t}" not in batch:
            continue
        cfg = args["cam"]
        grid = cfg["grid_conf"]
        frustum = create_frustum(cfg["data_aug_conf"]["final_dim"],
                                 cfg["img_downsample"], grid["ddiscr"],
                                 grid["mode"])
        mask = np.asarray(batch["agent_mask"], bool)
        cam = {k: np.asarray(v)[mask] for k, v in batch[f"cam_{t}"].items()}
        geom = get_geometry(torch.from_numpy(frustum), *(
            torch.from_numpy(cam[k]) for k in ("rots", "trans", "intrinsics",
                                               "post_rots", "post_trans")))
        dx, bx, _ = gen_dx_bx(grid["xbound"], grid["ybound"], grid["zbound"])
        u = (geom.double().numpy() - (bx - dx / 2.0)) / dx
        margin = min(margin, float(np.abs(u - np.round(u)).min()))
    return margin


def backbone_convs(hypes):
    """ConvBNReLU layers (K4a launches in ``pallas``) of one backbone pass;
    0 for HEAL and STAMP, whose modality backbone and pyramid are ResNet
    blocks."""
    args = hypes["model"]["args"]
    if hypes["model"]["core_method"] in RESNET_MODELS:
        return 0
    return sum((args.get("modality_fusion") or args)["base_bev_backbone"][
        "layer_nums"])


def backbone_passes(name):
    """Backbone passes per scene: Where2comm runs the stages for its
    single-agent confidence and again in its multi-scale fusion."""
    return 2 if name == "airv2x_where2comm" else 1


def k4_one_map(layer_nums):
    """K4a bf16 at the LSS backbone's stages (one map of K4_STAGES' sizes)
    against its plain version and cuDNN's ConvBNReLU: per stage the device
    ms of each and the bound; per scene at ``layer_nums`` launches per
    stage (one backbone pass)."""
    from airv2x_tpu_torch.models.nn import ConvBNReLU
    from airv2x_tpu_torch.ops.conv3x3 import conv3x3_same, conv3x3_same_plain
    from airv2x_tpu_torch.utils.weights import cast_weights_, init_random_

    rng = np.random.default_rng(5)
    dt = torch.bfloat16
    per = {k: 0.0 for k in ("ms", "plain_ms", "lib_ms", "bound_ms")}
    err = 0.0
    for si, (n, shape) in enumerate(zip(layer_nums, K4_STAGES)):
        shape = (1,) + shape[1:]
        c = shape[3]
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dt)
        blk = init_random_(ConvBNReLU(c, c), seed=20 + si).cuda().eval()
        blk.requires_grad_(False)
        cast_weights_(blk, dt)
        wk, sc, bi, packed = blk._fold(dt)
        args = (x, wk, sc, bi)
        ref = conv3x3_same_plain(*args, relu=True)
        got = conv3x3_same(*args, relu=True, packed=packed)
        d = (got.float() - ref.float()).abs()
        if not bool((d <= K4_TOL_BF16 * (1 + ref.float().abs())).all()):
            raise AssertionError(f"phase 16 K4a {shape}: {float(d.max())}")
        err = max(err, float(d.max()))
        xl = x.permute(0, 3, 1, 2)
        with torch.inference_mode(), conv_mode("auto"):
            lib = cuda_ms(lambda: blk(xl), 20)
        row = {"ms": cuda_ms(lambda: conv3x3_same(*args, relu=True, packed=packed), 20),
               "plain_ms": cuda_ms(lambda: conv3x3_same_plain(*args, relu=True), 10),
               "lib_ms": lib, "bound_ms": k4_bound(shape, c, dt)[0]}
        print(f"phase 16 K4a bf16 at {shape}: " + json.dumps(
            {k: round(v, 4) for k, v in row.items()}))
        for k, v in row.items():
            per[k] += n * v
    print(f"phase 16 K4a bf16 per LSS scene ({sum(layer_nums)} launches at one "
          f"map), ms: " + json.dumps({k: round(v, 4) for k, v in per.items()})
          + f"; share of bound {per['bound_ms'] / per['ms']:.3f}, time / cuDNN "
          f"{per['ms'] / per['lib_ms']:.3f}; max|kernel - plain| {err:.3e}")
    return dict(per, max_abs_err=err)


def camera_step(hypes, model):
    """One scene of a camera config: the stages of its model (Where2comm:
    encoder, backbone + shrink + confidence, fusion + heads; the family and
    V2X-ViT: encoder, backbone + shrink, fusion, heads; LSS: encoder,
    backbone + shrink, heads), then decode (NMS) or the class maps. The
    camera encoder marks its own stages first."""
    from airv2x_tpu_torch.data.postprocess import decode_segmentation

    det = model.task == "det"
    if det:
        decode, _ = det_decoder(hypes)
    else:
        def decode(out):
            return decode_segmentation(out["dynamic_seg"], out["static_seg"])
    last = DET_STAGES[3] if det else SEG_STAGES[3]

    def run(batch, mark):
        with torch.inference_mode():
            x = model.encode(batch, mark)
            mark("BEV encoder")
            if hasattr(model, "single_psm"):
                conf = model.single_psm(x)
                mark("backbone+shrink+confidence")
                out = model.fuse(x, conf, batch["agent_mask"])
                mark("fusion+heads")
            else:
                feats = model.backbone(x)
                mark("backbone+shrink")
                if hasattr(model, "fuse"):
                    feats = model.fuse(feats, batch)
                    mark("fusion")
                out = model.heads(feats)
                mark("heads")
            res = decode(out)
            mark(last)
        return out, res

    return run


def anchor_keep(out, det, top_k, obj_threshold):
    """(keep mask over the anchors of sample 0, margins): ``det``'s kept
    candidates placed at their anchors (the candidate order may swap
    scores that tie within rounding), and the smallest distances of an
    objectness from the gate (``gate``) and between the last candidate and
    the next anchor (``pool``) - either could pick other candidates."""
    objness = torch.sigmoid(out["obj"][0].float()).reshape(-1).cpu()
    gated = torch.where(objness > obj_threshold, objness,
                        torch.full_like(objness, -torch.inf))
    s, idx = torch.sort(gated, descending=True, stable=True)
    p = min(2 * top_k, len(s))
    keep = torch.zeros(len(s), dtype=torch.bool)
    keep[idx[:p]] = det.mask.cpu()
    margins = {"gate": float((objness - obj_threshold).abs().min())}
    if p < len(s) and bool(torch.isfinite(s[p])):
        margins["pool"] = float(s[p - 1] - s[p])
    return keep, margins


def tiny_camera_compositions(card):
    """Each tiny composition (TINY_COMPOSITIONS) on the card against the
    same weights on the CPU, f32 with TF32 off and pinned cuDNN, on the tiny
    camera scene: camera only in ``pallas``, and the vehicles LiDAR + camera
    (gt depth) in ``auto``; outputs within TINY_TOL x (1 + scale), equal
    keep sets (det), K1 0 / 3, K4a per pass x passes in ``pallas`` and K2 1
    (det) launches asserted, the frustum, ROI and NMS margins bounded."""
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import batch_to_torch
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    set_tf32(False)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    base = load_yaml(TINY)
    out = {}
    try:
        for (name, task), (kind, mode) in itertools.product(
                TINY_COMPOSITIONS, (("cam", "pallas"), ("lidar+cam", "auto"))):
            hypes = tiny_composition_hypes(base, name, task, kind)
            scene = tiny_camera_scene(hypes)
            batch = {d: batch_to_torch(scene, d) for d in ("cpu", "cuda")}
            seed = TINY_CAMERA_SEEDS.get((name, task, kind), 3)
            models = {d: init_random_(build_model(hypes, device=d), seed=seed)
                      for d in ("cpu", "cuda")}
            det = task == "det"
            res = {}
            for d, model in models.items():
                decode, _ = det_decoder(hypes, d, TINY_SCOPE_TOP_K)
                kernels.reset_launch_counts()
                with conv_mode(mode), torch.inference_mode():
                    if hasattr(model, "single_psm"):  # fused with the CPU's
                        x = model.encode(batch[d])   # confidence: one comm mask
                        single = model.single_psm(x)
                        conf = single if d == "cpu" else res["cpu"][0]["single"].to(d)
                        o = dict(model.fuse(x, conf, batch[d]["agent_mask"]),
                                 single=single)
                    else:
                        o = model(batch[d])
                    dets = decode(o) if det else None
                if d == "cuda":
                    torch.cuda.synchronize()
                res[d] = (o, dets, dict(kernels.LAUNCHES))
            n = res["cuda"][2]
            lidar = kind != "cam" and name != "lift_splat_shoot_airv2x"
            want = {"pillar_encode": 3 if lidar else 0, "quad_iou": int(det),
                    "conv3x3": (backbone_convs(hypes) * backbone_passes(name)
                                if mode == "pallas" else 0)}
            if n != {k: want.get(k, 0) for k in n}:
                raise AssertionError(f"tiny {name} {task} {kind}: launches {n}, "
                                     f"expected {want}")
            margins = {"frustum": camera_frustum_margin(hypes, scene)}
            if det:
                margins["nms"] = nms_margin(res["cpu"][1],
                                            hypes["postprocess"]["nms_thresh"])
                thr = hypes["postprocess"]["target_args"]["obj_threshold"]
                keeps = {}
                for d in res:
                    keeps[d], m = anchor_keep(res[d][0], res[d][1],
                                              TINY_SCOPE_TOP_K, thr)
                    if d == "cpu":
                        margins.update(m)
            if name == "airv2x_v2xvit":
                margins["roi"] = float((roi_samples(
                    hypes, batch["cpu"]["pairwise_t"], (48, 48)) - 0.5).abs().min())
            if name == "airv2x_v2vnet":
                margins["roi"] = v2vnet_roi_margin(hypes,
                                                   batch["cpu"]["pairwise_t_full"])
            keys = ((("psm", "rm", "obj") if det else ("dynamic_seg", "static_seg"))
                    + ("comm_rate",) + (("single",) if "single" in res["cpu"][0]
                                        else ()))
            label = (f"phase 16 tiny {name} {task} {kind} {mode} card vs CPU "
                     f"[{card}] ({n['pillar_encode']} K1, {n['conv3x3']} K4a, "
                     f"{n['quad_iou']} K2 launches; margins "
                     + json.dumps({k: float(f"{v:.3e}") for k, v in margins.items()})
                     + f", limit {ROI_MARGIN})")
            compare(label, res["cuda"][0], res["cpu"][0], keys)
            kept = None
            if det:
                same = bool(torch.equal(keeps["cuda"], keeps["cpu"]))
                kept = int(keeps["cpu"].sum())
                print(f"phase 16 tiny {name} {kind}: keep sets by anchor card == "
                      f"CPU {same}, {kept} kept (card {int(keeps['cuda'].sum())})")
                if not same or not kept:
                    raise AssertionError(f"tiny {name} {kind}: keep sets {same}, "
                                         f"{kept} kept")
            if min(margins.values()) <= ROI_MARGIN:
                raise AssertionError(f"tiny {name} {task} {kind}: margins {margins}")
            out[f"{name} {task} {kind} {mode}"] = {"margins": margins, "kept": kept}
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    return out


def phase_camera_disk(card, work):
    """Phase 16: the camera configs on disk at full width. An on-disk
    scenario with cameras (``write_scenario``: CAMERA_SCENES timestamps,
    phase 5's agents, 6 / 4 / 1 cameras at 720 x 1280 per vehicle / RSU /
    drone), the shipped camera configs cut as phase 5 with the AirV2X
    augmentation keys supplied (``camera_hypes``); the dataset's host ms per
    ``__getitem__``; one loaded batch card vs CPU (every array equal); the
    scenes loaded once and kept on the card; then per config
    (CAMERA_PATHS), bf16 with seeded random weights drawn on the card, in
    ``auto`` and ``pallas``: CAMERA_RUNS timed runs after a warm-up
    (ms/scene, stage times, peak memory), a profile window (device busy,
    idle share, busy by stage), the launches asserted (K1 0; K4a the
    config's ConvBNReLU count x its backbone passes in ``pallas``, 0 in
    ``auto``; K2 1 per det scene), kept detections or class histograms;
    the tiny compositions card vs CPU (``tiny_camera_compositions``); and
    the Where2comm det and seg configs through ``inference_multi_scenario``
    and ``inference_airv2x_seg`` on the scenario in ``pallas``, with their
    tables and launches (K1 0, K4a 32, K2 at least 2 per det scene, 0 per
    seg scene). The scenario stays under ``work``, whose caller removes it
    after phase 20 has read it again."""

    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.data.airv2x_dataset import AirV2XDataset
    from airv2x_tpu_torch.data.loader import RealDataLoader
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.models.base import SlotLayout
    from airv2x_tpu_torch.ops.conv3x3 import KERNELS, conv3x3_plan
    from airv2x_tpu_torch.tools import inference_airv2x_seg, inference_multi_scenario
    from airv2x_tpu_torch.tools.inference import model_batch
    from airv2x_tpu_torch.utils.weights import cast_weights_, init_random_

    t_phase = time.perf_counter()
    res = {"card": card}
    # K4a's tile plans at the LSS backbone's one map: instantiated kernels
    plans = {}
    for shape in K4_STAGES:
        p = conv3x3_plan(1, *shape[1:], shape[3], torch.bfloat16)
        if (p.wgs, p.mr, p.block_n) not in KERNELS:
            raise AssertionError(f"phase 16: no K4 kernel for the plan {p}")
        plans[str((1,) + shape[1:])] = (f"{p.tile_h}x{p.tile_w} pixels x "
                                        f"{p.block_n} outputs, {p.n_blocks} blocks")
    print(f"phase 16 K4a bf16 plans at the LSS backbone's stages: {json.dumps(plans)}")
    res["k4a_lss"] = k4_one_map(cut_hypes(camera_path("det", "lss"))["model"][
        "args"]["modality_fusion"]["base_bev_backbone"]["layer_nums"])

    root = os.path.join(work, "test")
    hypes = camera_hypes(camera_path("det", "where2comm"))
    args = hypes["model"]["args"]
    t0 = time.perf_counter()
    write_scenario(root, SlotLayout.from_args(args),
                   hypes["preprocess"]["cav_lidar_range"],
                   stamps=CAMERA_SCENES, seg_hw=int(args["seg_hw"]),
                   seg_res=float(args["seg_res"]), camera_hw=CAMERA_HW)
    png = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root)
              for f in fs if f.endswith("camera.png"))
    print(f"phase 16 [{card}]: scenario of {CAMERA_SCENES} timestamps with "
          f"{sum(NCAM[t] * n for t, n in NUM_AGENTS.items())} cameras each at "
          f"{CAMERA_HW[0]} x {CAMERA_HW[1]}, written in "
          f"{time.perf_counter() - t0:.2f} s; camera PNGs {png} bytes")

    ds = AirV2XDataset(hypes, root, train=False)
    load_ms, scenes = [], []
    for i in range(len(ds)):
        t0 = time.perf_counter()
        sample, _ = ds[i]
        load_ms.append((time.perf_counter() - t0) * 1e3)
        scenes.append(model_batch(sample, "cuda"))
    torch.cuda.synchronize()
    mib = sum(v.numel() * v.element_size() for sc in scenes
              for k, d in sc.items() if k.startswith("cam_")
              for v in d.values()) / 2**20
    print(f"phase 16 [{card}] dataset: host ms per __getitem__ "
          f"{[round(v, 3) for v in load_ms]} (median "
          f"{statistics.median(load_ms):.3f}); camera inputs {mib:.1f} MiB "
          f"for {len(scenes)} scenes resident on the card; blocks "
          + json.dumps({k: list(sample[k]["imgs"].shape) for k in sample
                        if k.startswith("cam_")}))
    res["getitem_ms"] = load_ms
    loaded = {d: next(RealDataLoader(ds, hypes, 1, train=False, num_workers=1,
                                     device=d).batches())
              for d in ("cuda", "cpu")}
    err = same_batch(loaded["cuda"], loaded["cpu"])
    cams = {k: v for k, v in err.items() if k.startswith("cam_")}
    print(f"phase 16 [{card}] one loaded batch, card against CPU: camera "
          f"arrays max abs err {json.dumps(cams)}")
    bad = {k: v for k, v in err.items()
           if v > (BATCH_TARGET_TOL if k == "labels.targets" else 0.0)}
    if bad or len(cams) != 18:
        raise AssertionError(f"phase 16: the card's batch differs: {bad}, "
                             f"{sorted(cams)}")
    del loaded

    set_tf32(False)
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32 = True  # PyTorch's defaults for bf16
    cudnn.benchmark, cudnn.deterministic = True, False
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    for task, yaml_name in CAMERA_PATHS:
        t0 = time.perf_counter()
        h = camera_hypes(camera_path(task, yaml_name))
        name = h["model"]["core_method"]
        model = init_random_(build_model(h, device="cuda"), seed=0,
                             device="cuda")
        cast_weights_(model, torch.bfloat16)
        run = camera_step(h, model)
        label = f"phase 16 {task}/{yaml_name}"
        convs = backbone_convs(h) * backbone_passes(name)
        r = {}
        for mode in ("auto", "pallas"):
            want = {"pillar_encode": 0, "quad_iou": int(task == "det"),
                    "conv3x3": convs if mode == "pallas" else 0}
            with conv_mode(mode):
                r[mode] = time_path(f"{label} {mode} [{card}]", run, scenes,
                                    want, runs=CAMERA_RUNS)
            r[mode]["launches_per_scene"] = want
            for k, v in r[mode]["launches"].items():
                total[k] += v
        # one profile window, in ``pallas`` (phase 15's): the whole
        # script stays well inside its time limit
        with conv_mode("pallas"):
            r["pallas"]["profile"] = phase_profile(
                f"{label} pallas [{card}]", run, scenes, top=8,
                n=PROFILED_SCENES)
        for mode in ("auto", "pallas"):
            results = r[mode].pop("results")
            if task == "det":
                r[mode]["kept"] = check_det(f"{label} {mode}", results,
                                            det_decoder(h)[1])
            else:
                r[mode]["class_hist"] = check_seg(f"{label} {mode}", results,
                                                  h["model"]["args"])
        r["seconds"] = time.perf_counter() - t0
        print(f"{label} [{card}]: both modes, timed and profiled, in "
              f"{r['seconds']:.1f} s")
        res[f"{task}/{yaml_name}"] = r
        del model, run
        torch.cuda.empty_cache()
    res["scenes"] = scenes  # phase 19's camera configs read them too
    del scenes

    t0 = time.perf_counter()
    res["tiny_card_vs_cpu"] = tiny_camera_compositions(card)
    print(f"phase 16 tiny compositions in {time.perf_counter() - t0:.1f} s")

    n = len(ds)
    for task, cli in (("det", inference_multi_scenario),
                      ("seg", inference_airv2x_seg)):
        h, run_dir = eval_run_dir(camera_path(task, "where2comm"), root, work,
                                  cut=camera_hypes)
        with conv_mode("pallas"):
            kernels.reset_launch_counts()
            out = cli.main(["--model_dir", run_dir, "--device", "cuda"])
            torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        label = f"phase 16 {task}/where2comm CLI on disk, pallas [{card}]"
        table = eval_table(task, out)
        print(f"{label}: {out['ms_per_scene']:.3f} ms/scene (load + forward "
              f"+ decode + metrics, one run, cold), launches per scene "
              f"{ {k: v / n for k, v in launches.items()} }; "
              + json.dumps(table))
        k2 = launches["quad_iou"]
        if not (launches["pillar_encode"] == 0 and launches["conv3x3"] == 32 * n
                and (k2 >= 2 * n if task == "det" else k2 == 0)):
            raise AssertionError(f"{label}: launches {launches} over {n} scenes")
        if not all(np.isfinite(list(_numbers(out)))):
            raise AssertionError(f"{label}: a non-finite metric: {out}")
        res[f"cli {task}"] = {"table": table, "ms_per_scene": out["ms_per_scene"],
                              "launches": launches}
    res["launches"] = total
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 16 [{card}] in {res['seconds']:.1f} s; launches over its timed "
          f"runs and CLI runs: {total}")
    return res


class RangeMarks:
    """The ``mark`` of a profiled run: each stage runs inside a profiler
    range named ``stage <i>`` (its index in the scene), and ``names`` maps
    the index to the name that ``mark`` gives when the stage ends."""

    def __init__(self):
        self.names = []
        self._open()

    def _open(self):
        self.range = torch.profiler.record_function(f"stage {len(self.names)}")
        self.range.__enter__()

    def __call__(self, name):
        self.range.__exit__(None, None, None)
        self.names.append(name)
        self._open()

    def close(self):
        self.range.__exit__(None, None, None)


def port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def launch_ranges(prof, prefixes):
    """Device microseconds by profiler range: every kernel, copy and memset
    that PyTorch launched goes to the one range, among those whose name
    starts with one of ``prefixes``, that holds its launch: the innermost
    range open at the runtime call (cudaLaunchKernel, cudaMemsetAsync, ...)
    whose correlation id the device event carries. Read from the profiler's
    raw events, each device event once. The ranges' own spans on the
    device's timeline and the port's kernels (PORT_KERNELS, launched
    through ctypes) are left out."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    ranges, launches = [], {}
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        if e.name().startswith(prefixes):
            ranges.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.linked_correlation_id() > 0:  # a runtime call: its own
            launches[e.correlation_id()] = e.start_ns()  # id is its launch's
    ranges.sort()
    starts = [r[0] for r in ranges]
    out = {}
    for d in events:
        if (d.device_type() != DeviceType.CUDA or d.name().startswith(prefixes)
                or port_kernel(d.name())
                or d.correlation_id() not in launches):
            continue
        t = launches[d.correlation_id()]
        # the latest-opened range still open at t: the innermost (the
        # ranges of one thread nest)
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ranges[i][1] < t:
            i -= 1
        if i >= 0:
            name = ranges[i][2]
            out[name] = out.get(name, 0.0) + (d.end_ns() - d.start_ns()) / 1e3
    return out


def phase_profile(label, run, scenes, top=15, unit="scene", n=3,
                  device_only=False):
    """Device time by kernel over ``n`` scenes (or train steps: ``unit``)
    of a path, the device's idle share of that window (torch.profiler /
    CUPTI), and the device time of the kernels launched in each stage.
    ``device_only`` records the device's activity alone (no host ranges,
    so no stages: a train step's window, whose host events are many and
    were most of the window's processing time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CUDA] if device_only
            else [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in scenes[:n]:
            marks = RangeMarks()
            run(batch, marks)
            marks.close()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stage_busy = {}
    for key, us in ({} if device_only else
                    launch_ranges(prof, ("stage ",))).items():
        i = int(key.split()[1])
        if i < len(marks.names):
            name = marks.names[i]
            stage_busy[name] = stage_busy.get(name, 0.0) + us / 1e3 / n
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("stage "):
            continue  # kernels, memcpy and memset only
        # per scene; the attribute's name differs between releases
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3 / n, e.count / n, e.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        print(f"{label} profile: no device time recorded (not measured)")
        return None
    print(f"{label} profile over {n} {unit}s: device busy {busy:.3f} ms/{unit} "
          f"of {wall_ms / n:.3f} ms/{unit} wall under the profiler, idle share "
          f"{1 - busy / (wall_ms / n):.3f}; "
          f"{sum(r[1] for r in rows):.0f} kernels, copies and memsets/{unit}")
    port_ms = sum(r[0] for r in rows if port_kernel(r[2]))
    if stage_busy:
        print(f"{label} device busy ms/{unit} by stage (the kernels PyTorch "
              f"launched in it; {sum(stage_busy.values()):.3f} in all, and "
              f"{port_ms:.3f} of the port's own kernels, K1 / K2 / K4, "
              "launched through ctypes, counted apart): " + json.dumps(
                  {k: round(v, 4) for k, v in stage_busy.items()}))
    if sum(stage_busy.values()) + port_ms > busy * (1 + 1e-6) + 1e-6:
        raise AssertionError(
            f"{label}: the stages' busy {sum(stage_busy.values())} and the "
            f"port's kernels' {port_ms} exceed the window's {busy} ms")
    k1 = [r for r in rows if any(k in r[2] for k in K1_KERNELS)]
    print(f"{label} K1 kernels: {sum(r[0] for r in k1):.4f} ms/{unit} over "
          f"{sum(r[1] for r in k1):.1f} launches/{unit} (its table memset "
          "is counted with the other memsets)")
    for ms, count, name in sorted(rows, reverse=True)[:top]:
        print(f"  {ms:8.4f} ms/{unit} {count:6.1f}x/{unit}  {name[:100]}")
    print(f"{label} clocks.sm, power.draw: {smi('clocks.sm,power.draw')}")
    return dict(busy_ms=busy, idle_share=1 - busy / (wall_ms / n),
                device_ops=sum(r[1] for r in rows), stage_busy_ms=stage_busy,
                port_kernels_ms=port_ms)


def comm_cut_gaps(model, batch):
    """Per sample and per k, the smallest relative gap, over the present
    agents, between the k-th and (k+1)-th largest train-mode confidence of
    ``model`` (a copy runs the forward, so the model's BN statistics stay
    as they are)."""
    from airv2x_tpu_torch.models.fusion.where2comm import gaussian_smooth

    twin = copy.deepcopy(model).train()
    with torch.no_grad():
        psm = twin.single_psm(twin.encode(batch)).double()
    b = batch["agent_mask"].shape[0]
    conf = gaussian_smooth(torch.sigmoid(psm).amax(1), 5, 1.0)
    conf = conf.reshape(b, -1, conf.shape[-2] * conf.shape[-1])
    srt = conf.sort(-1, descending=True)[0]
    gap = (srt[..., :-1] - srt[..., 1:]) / srt[..., :-1].abs().clamp_min(1e-30)
    gap = torch.where(batch["agent_mask"][..., None], gap, torch.inf)
    return gap.amin(1).cpu().numpy()


def clean_keep_fraction(model, batch, target):
    """A keep fraction u near ``target`` whose cut k = floor(u * H * W) lies
    on a relative confidence gap of at least 1e-5 in every present agent:
    tied confidences are common, and two devices' rounding may order the
    ties of exact arithmetic apart."""
    gaps = comm_cut_gaps(model, batch).min(0)
    hw = gaps.shape[0] + 1
    ks = np.nonzero(gaps > 1e-5)[0] + 1
    k = ks[np.argmin(np.abs(ks - target * hw))]
    return float(np.float32((k + 0.5) / hw))


def phase_tiny_train(card):
    """Phase 4b: one det and one seg train step of the tiny configs, card
    against CPU, from the same weights, batch and keep fraction."""
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import batch_to_torch, make_batch
    from airv2x_tpu_torch.loss import build_loss
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.ops.anchors import (
        anchor_standup_boxes, generate_anchor_grid)
    from airv2x_tpu_torch.parallel.train import (
        TrainState, make_optimizer, make_train_step)
    from airv2x_tpu_torch.utils.weights import init_random_

    set_tf32(False)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    det = load_yaml(TINY)
    seg = copy.deepcopy(det)
    seg["task"] = seg["model"]["args"]["task"] = "seg"
    anchors = generate_anchor_grid(det["postprocess"]["anchor_args"])
    out = {}
    try:
        for name, hypes in (("det", det), ("seg", seg)):
            models = {"cpu": init_random_(
                build_model(hypes, device="cpu", train=True), seed=3)}
            models["cuda"] = build_model(hypes, device="cuda", train=True)
            models["cuda"].load_state_dict(models["cpu"].state_dict())
            batch, _ = make_batch(
                np.random.default_rng(2), models["cpu"].layout, TRAIN_BATCH,
                anchors=anchors, anchor_standup=anchor_standup_boxes(anchors),
                target_args=hypes["postprocess"]["target_args"],
                seg_hw=hypes["seg_hw"] if name == "seg" else 0, device="cpu",
                num_objects=6, points_per_agent=2048, pts_per_box=60,
                lidar_range=hypes["preprocess"]["cav_lidar_range"],
                max_boxes=hypes["postprocess"]["max_num"])
            u = clean_keep_fraction(models["cpu"], batch_to_torch(batch, "cpu"),
                                    0.6)
            parts = {}
            for d, model in models.items():
                opt, sched = make_optimizer(hypes, model.parameters(), 10)
                step = make_train_step(build_loss(hypes), sched)
                parts[d] = step(TrainState(model, opt), batch_to_torch(batch, d),
                                comm_u=torch.full((TRAIN_BATCH,), u))
            torch.cuda.synchronize()
            lr = sched(0)
            errs = {k: abs(float(parts["cuda"][k]) - float(parts["cpu"][k]))
                    for k in parts["cpu"]}
            bad = [k for k in errs
                   if errs[k] > STEP_LOSS_TOL * abs(float(parts["cpu"][k])) + 1e-6]
            cpu_p = dict(models["cpu"].named_parameters())
            top = max(float(p.grad.abs().max()) for p in cpu_p.values())
            grad_err = param_err = 0.0
            for pname, p in models["cuda"].named_parameters():
                q = cpu_p[pname]
                g, gq = p.grad.cpu(), q.grad
                e = float((g - gq).abs().max())
                bound = STEP_GRAD_TOL * float(gq.abs().max()) + STEP_GRAD_FLOOR * top
                grad_err = max(grad_err, e / max(bound, 1e-30))
                if e > bound:
                    bad.append(f"grad {pname}: {e:.3e} > {bound:.3e}")
                d = (p.detach().cpu() - q.detach()).abs()
                sure = gq.abs() > 2 * bound
                pe = float(d[sure].max()) if bool(sure.any()) else 0.0
                param_err = max(param_err, pe)
                if pe > 1e-6 * (1 + float(q.detach().abs().max())) or \
                        float(d.max()) > 2 * lr + 1e-6:
                    bad.append(f"param {pname}: {pe:.3e} / {float(d.max()):.3e}")
            cpu_b = dict(models["cpu"].named_buffers())
            stat_err = 0.0
            for bname, b in models["cuda"].named_buffers():
                if bname.endswith("num_batches_tracked"):
                    continue
                e = (b.cpu() - cpu_b[bname]).abs()
                stat_err = max(stat_err, float(e.max()))
                if bool((e > 1e-5 * (1 + cpu_b[bname].abs())).any()):
                    bad.append(f"stat {bname}: {float(e.max()):.3e}")
            print(f"phase 4b [{card}] tiny {name} train step card vs CPU (u "
                  f"{u:.6f}): max|card - CPU| loss parts {json.dumps(errs)} "
                  f"(tol {STEP_LOSS_TOL} relative); gradients at "
                  f"{grad_err:.3e} of their bound ({STEP_GRAD_TOL} x leaf scale "
                  f"+ {STEP_GRAD_FLOOR} x {top:.3e}); parameters where the "
                  f"gradient is clear {param_err:.3e} (tol 1e-6 x (1 + |p|), "
                  f"elsewhere 2 lr = {2 * lr}); BN statistics {stat_err:.3e} "
                  "(tol 1e-5 x (1 + |v|))")
            if bad:
                raise AssertionError(f"phase 4b tiny {name}: {bad[:5]}")
            out[name] = dict(loss_err=max(errs.values()), grad_bound_share=grad_err,
                             param_err=param_err, stat_err=stat_err)
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    return out


def train_setup(hypes, n_batches=N_TRAIN_BATCHES):
    """A trainable full-width model of ``hypes`` (bf16 compute, flax-like
    weights) and ``n_batches`` labelled batches of TRAIN_BATCH on the card:
    ``make_batch`` (seg labels for a seg config), then, for a camera config,
    each sample's camera stacks (``add_camera_inputs``, NCAM cameras per
    agent at the config's final_dim), drawn after the scenes as the train
    CLI draws them."""
    from airv2x_tpu_torch.data.synthetic import (
        add_camera_batch, batch_to_torch, camera_types, make_batch)
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.ops.anchors import (
        anchor_standup_boxes, generate_anchor_grid)
    from airv2x_tpu_torch.utils.weights import init_flax_like_

    hypes["model"]["args"]["dtype"] = "bf16"
    assert int(hypes["train_params"]["batch_size"]) == TRAIN_BATCH
    model = init_flax_like_(build_model(hypes, device="cuda", train=True), seed=0)
    kw = dict(target_args=hypes["postprocess"]["target_args"])
    if hypes["task"] == "seg":
        kw.update(seg_hw=int(hypes["seg_hw"]), seg_res=float(hypes["seg_res"]))
    else:
        anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
        kw.update(anchors=anchors, anchor_standup=anchor_standup_boxes(anchors))
    cams = camera_types(hypes)
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    batches = []
    for _ in range(n_batches):
        b = make_batch(
            rng, model.layout, TRAIN_BATCH, device="cuda", num_objects=12,
            num_agents=NUM_AGENTS, points_per_agent=POINTS_PER_AGENT,
            lidar_range=hypes["preprocess"]["cav_lidar_range"],
            max_boxes=hypes["postprocess"]["max_num"], pts_per_box=100, **kw)[0]
        add_camera_batch(b, hypes, model.layout, rng, ncam=NCAM)
        batches.append(batch_to_torch(b, "cuda"))
    torch.cuda.synchronize()
    print(f"{n_batches} batches of {TRAIN_BATCH} made in "
          f"{time.perf_counter() - t0:.2f} s" + (f" (with cameras: {cams})"
                                                 if cams else ""))
    return hypes, model, batches


def loss_fell(repeated) -> bool:
    """Whether a training learned one batch it took ``repeated`` times (the
    total loss of each step, at REPEAT_LR_SCALE of the schedule's lr): every
    loss finite, and the median of the second half at least REPEAT_DROP
    below the least of the first three. The median absorbs a single
    overshoot late in the run; the least of the first three holds a run
    that climbs and only partly comes back (or wanders about a plateau
    above its start) to failing, as it does a training that does not learn
    and repeats one loss (the keep fraction is held fixed)."""
    if not all(np.isfinite(repeated)):
        return False
    second = statistics.median(repeated[len(repeated) // 2:])
    return second <= (1 - REPEAT_DROP) * min(repeated[:3])


def learned_a_batch(runs) -> bool:
    """The repeated-batch check over several batches: ``runs`` holds one
    ``loss_fell`` sequence per batch (at most REPEAT_BATCHES, taken one
    after another from the same training state), and the training passes
    when it learned one of them. A training that does not learn fails every
    batch; a sound step fails one batch now and then, because training on
    the card is not bit-reproducible and a model's own discontinuities (a
    When2com handshake that flips) can lift one batch's loss for good. Each
    run keeps ``loss_fell``'s 5% margin."""
    return 0 < len(runs) <= REPEAT_BATCHES and any(loss_fell(r) for r in runs)


def repeated_batch_check(label, card, repeat_step, state, batches, repeats,
                         **kw):
    """Up to REPEAT_BATCHES batches, each ``repeats`` times through
    ``repeat_step`` until one is learned (``learned_a_batch``); raises when
    none is. Returns the total losses, one list per batch taken."""
    runs = []
    for i in range(REPEAT_BATCHES):
        runs.append([float(repeat_step(state, batches[i % len(batches)],
                                       **kw)["total_loss"])
                     for _ in range(repeats)])
        print(f"{label} [{card}] batch {i} {repeats} times at "
              f"{REPEAT_LR_SCALE} of the lr, total loss: "
              + json.dumps([round(v, 5) for v in runs[-1]]))
        if loss_fell(runs[-1]):
            break
    if not learned_a_batch(runs):
        raise AssertionError(
            f"{label}: the loss fell on none of {len(runs)} repeated batches: "
            "the medians of the second halves "
            f"{[statistics.median(r[repeats // 2:]) for r in runs]} against "
            f"the least of the first three {[min(r[:3]) for r in runs]} "
            f"(needed {1 - REPEAT_DROP} of it)")
    return runs


def phase_train(label, card, hypes, model, batches, steps=TRAIN_STEPS,
                repeats=REPEAT_STEPS, autotune=True, profiled=3):
    """Two warm-up steps, ``steps`` timed steps, a profile window of
    ``profiled`` steps (none at 0), then one batch ``repeats`` times at REPEAT_LR_SCALE
    of the schedule's lr (``loss_fell``; a Where2comm model keeps the keep
    fraction REPEAT_KEEP on every repeat); the kernels must not launch (the
    train path has no TPU-kernel counterpart). ``autotune`` lets cuDNN time
    its algorithms per shape (``cudnn.benchmark``); without it cuDNN takes
    its heuristics' choice."""
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.loss import build_loss
    from airv2x_tpu_torch.models.registry import compute_dtype
    from airv2x_tpu_torch.parallel.train import (
        TrainState, make_optimizer, make_train_step)

    torch.backends.cudnn.benchmark = autotune
    torch.backends.cudnn.deterministic = False
    opt, sched = make_optimizer(hypes, model.parameters(), 50)
    state = TrainState(model, opt)
    loss_fn, dtype = build_loss(hypes), compute_dtype(hypes)
    step = make_train_step(loss_fn, sched, compute_dtype=dtype, seed=0)
    repeat_step = make_train_step(loss_fn, lambda s: REPEAT_LR_SCALE * sched(s),
                                  compute_dtype=dtype, seed=0)
    kernels.reset_launch_counts()
    for b in batches[:2]:  # warm-up: allocator, cuDNN algorithm choice
        step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for i in range(steps):
        b = batches[i % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts = step(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in parts.items()})
    peak = torch.cuda.max_memory_allocated() / 2**20
    med = statistics.median(ms)
    print(f"{label} [{card}]: {med:.3f} ms/step median of {steps} "
          f"({[round(t, 3) for t in ms]}), {TRAIN_BATCH * 1e3 / med:.3f} train "
          f"scenes/s, peak memory {peak:.1f} MiB")
    print(f"{label} loss parts per step: " + json.dumps(
        [{k: round(v, 5) for k, v in p.items()} for p in losses]))
    if not all(np.isfinite(v) for p in losses for v in p.values()):
        raise AssertionError(f"{label}: a non-finite loss part")
    window = [batches[i % len(batches)] for i in range(profiled)]
    prof = (phase_profile(f"{label} [{card}]", lambda b, mark: step(state, b),
                          window, top=10, unit="step", n=profiled,
                          device_only=True)
            if profiled else None)
    kw = {}
    if getattr(model, "DRAWS_KEEP_FRACTION", False):
        kw["comm_u"] = torch.full((TRAIN_BATCH,), REPEAT_KEEP)
    repeated = repeated_batch_check(label, card, repeat_step, state, batches,
                                    repeats, **kw)
    torch.cuda.synchronize()
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"{label}: kernels launched in training: "
                             f"{kernels.LAUNCHES}")
    return dict(ms_per_step=med, ms_runs=ms, scenes_per_s=TRAIN_BATCH * 1e3 / med,
                peak_mib=peak, losses=losses, repeated=repeated,
                profile=prof, steps=state.step)


def phase_train_det(card):
    """Phase 8: full-width det training, then eval with the trained weights
    through K1, K4a and K2."""
    from airv2x_tpu_torch import kernels

    hypes, model, batches = train_setup(cut_hypes(FLAGSHIP))
    scene = {k: v[:1] for k, v in batches[0].items() if k != "labels"}
    set_tf32(False)
    cudnn = torch.backends.cudnn
    model.eval()
    with conv_mode("pallas"):  # folds of the initial weights, cached
        staged(model, scene)
    res = phase_train("phase 8 det training", card, hypes, model, batches)
    model.eval()  # f32 master weights
    set_tf32(False)
    cudnn.benchmark, cudnn.deterministic = False, True
    with conv_mode("auto"):
        psm_auto, _ = staged(model, scene)
    with conv_mode("pallas"):
        psm_pallas, _ = staged(model, scene)
    compare(f"phase 8 [{card}] trained f32 pallas vs auto, single-agent "
            "confidence", {"single_psm": psm_pallas}, {"single_psm": psm_auto},
            ("single_psm",))
    run, hw = det_step(hypes, model)
    launches = {}
    for mode in ("auto", "pallas"):
        kernels.reset_launch_counts()
        with conv_mode(mode):
            out, det = run(scene, no_mark)
        torch.cuda.synchronize()
        launches[mode] = dict(kernels.LAUNCHES)
        for k in ("psm", "rm", "obj"):
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"phase 8 eval {mode}: non-finite {k}")
        print(f"phase 8 [{card}] eval of the trained det model, {mode}: "
              f"{int(det.mask.sum())} kept detections, {det.nms_passes} NMS "
              f"passes, comm_rate {float(out['comm_rate']):.4f}; launches "
              f"{launches[mode]}")
    want = {"pillar_encode": 3, "conv3x3": 32, "quad_iou": 1}
    got = {k: launches["pallas"].get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"phase 8 pallas eval launches {got}, expected {want}")
    res["eval_launches"] = launches
    res["eval_psm_err"] = float((psm_pallas - psm_auto).abs().max())
    cudnn.deterministic = False
    del model, batches
    torch.cuda.empty_cache()
    return res


def phase_train_seg(card):
    """Phase 9: full-width seg training (512 x 512 labels)."""
    hypes, model, batches = train_setup(cut_hypes(SEG))
    res = phase_train("phase 9 seg training", card, hypes, model, batches)
    del model, batches
    torch.cuda.empty_cache()
    return res


# phase 17, training beyond the flagship: (group, task, YAML name) under
# hypes_yaml/airv2x, cut as phase 5; the camera configs get the AirV2X aug
# keys (``camera_hypes``)
TRAIN_MODEL_PATHS = (
    ("lidar", "det", "v2xvit"), ("lidar", "det", "att_fusion"),
    ("lidar", "det", "max_fusion"), ("lidar", "det", "cobevt"),
    ("lidar", "det", "v2vnet"), ("lidar", "det", "when2com"),
    ("lidar", "seg", "v2xvit"), ("camera", "det", "where2comm"),
    ("camera", "det", "lss"))
TRAIN_MODEL_STEPS = 2  # timed, after a warm-up of 2
TRAIN_MODEL_REPEATS = 16
TRAIN_MODEL_BATCHES = 2
CLI_CAMERA_STAMPS = 2  # the camera train CLI's on-disk scenario


def first_scene(batch):
    """Sample 0 of a batch, camera blocks included, without its labels."""
    return {k: ({kk: vv[:1] for kk, vv in v.items()} if isinstance(v, dict)
                else v[:1]) for k, v in batch.items() if k != "labels"}


def trained_eval(label, card, hypes, model, scene):
    """The trained f32 weights in ``auto`` and ``pallas`` on one scene
    (deterministic cuDNN, TF32 off): finite outputs, and the launches of
    each mode asserted (K1 3 per LiDAR scene, 0 per camera scene; K4a the
    backbone's ConvBNReLUs x its passes in ``pallas``, 0 in ``auto``; K2 1
    per det scene: its NMS)."""
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.data.synthetic import camera_types

    set_tf32(False)
    cudnn = torch.backends.cudnn
    cudnn.benchmark, cudnn.deterministic = False, True
    model.eval()  # f32 master weights
    run = camera_step(hypes, model)
    det = model.task == "det"
    k1 = 0 if camera_types(hypes) else 3
    convs = backbone_convs(hypes) * backbone_passes(hypes["model"]["core_method"])
    launches = {}
    for mode in ("auto", "pallas"):
        want = {"pillar_encode": k1, "conv3x3": convs if mode == "pallas" else 0,
                "quad_iou": int(det)}
        kernels.reset_launch_counts()
        with conv_mode(mode):
            out, res = run(scene, no_mark)
        torch.cuda.synchronize()
        launches[mode] = dict(kernels.LAUNCHES)
        got = {k: launches[mode].get(k, 0) for k in want}
        keys = ("psm", "rm", "obj") if det else ("dynamic_seg", "static_seg")
        for k in keys:
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"{label} eval {mode}: non-finite {k}")
        kept = int(res.mask.sum()) if det else None
        print(f"{label} [{card}] eval of the trained weights, f32, {mode}: "
              + (f"{kept} kept detections, " if det else "")
              + f"launches {got} (expected {want})")
        if got != want:
            raise AssertionError(f"{label} eval {mode}: launches {got}, "
                                 f"expected {want}")
    cudnn.deterministic = False
    return launches


def camera_train_cli(card):
    """2 steps of the train CLI on the camera LSS det config (cut as phase
    5, the AirV2X aug keys supplied) over a ``write_scenario`` scenario of
    CLI_CAMERA_STAMPS timestamps with cameras at CAMERA_HW, on disk:
    ``AirV2XDataset`` / ``RealDataLoader`` in train mode, batch 1; the loss
    parts must be finite."""
    import re
    import shutil

    from airv2x_tpu_torch.config import save_yaml
    from airv2x_tpu_torch.models.base import SlotLayout
    from airv2x_tpu_torch.tools import train

    work = scratch_dir("chip_smoke_train_cli_")
    try:
        root = os.path.join(work, "train")
        hypes = camera_hypes(camera_path("det", "lss"))
        write_scenario(root, SlotLayout.from_args(hypes["model"]["args"]),
                       hypes["preprocess"]["cav_lidar_range"],
                       stamps=CLI_CAMERA_STAMPS, camera_hw=CAMERA_HW)
        hypes["root_dir"] = hypes["validate_dir"] = root
        cfg = os.path.join(work, "train.yaml")
        save_yaml(hypes, cfg)
        torch.backends.cudnn.benchmark = False
        t0 = time.perf_counter()
        run_dir = train.main(["--hypes_yaml", cfg, "--log_dir", work,
                              "--epochs", "1", "--steps_per_epoch", "2",
                              "--batch_size", "1", "--num_workers", "2",
                              "--device", "cuda"])
        seconds = time.perf_counter() - t0
        with open(os.path.join(run_dir, "train_loss.txt")) as f:
            line = f.read().splitlines()[-1]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    parts = {k: float(v) for k, v in re.findall(r"(\w+): (\S+)", line)}
    print(f"phase 17 camera train CLI on disk [{card}]: camera/det/lss.yaml, 2 "
          f"steps of batch 1 in {seconds:.2f} s (scenario load, model build and "
          f"workers included): {line}")
    if not parts or not all(np.isfinite(list(parts.values()))):
        raise AssertionError(f"phase 17 camera train CLI: a non-finite loss: {line}")
    return {"seconds": seconds, "loss_parts": parts}


def phase_train_models(card):
    """Phase 17: training beyond the flagship. Per config of
    TRAIN_MODEL_PATHS at full width (cut to 3 / 2 / 1 agents, batch 2, bf16
    autocast over f32 master weights, flax-like initialisation), in the
    order of phases 8-9 (``phase_train``): 2 warm-up steps,
    TRAIN_MODEL_STEPS timed steps, a profile window of one step, then one
    batch TRAIN_MODEL_REPEATS times at REPEAT_LR_SCALE of the lr
    (``loss_fell``); finite loss parts, no kernel launch in training,
    cuDNN on its heuristics; then the
    trained weights evaluated in both modes (``trained_eval``). Then the
    camera train CLI on disk."""
    t_phase = time.perf_counter()
    res = {"card": card, "configs": {}}
    launches = {}
    for group, task, name in TRAIN_MODEL_PATHS:
        t0 = time.perf_counter()
        key = f"{group}/{task}/{name}"
        path = os.path.join(REPO, "hypes_yaml/airv2x", group, task, f"{name}.yaml")
        hypes = camera_hypes(path) if group == "camera" else cut_hypes(path)
        hypes, model, batches = train_setup(hypes, TRAIN_MODEL_BATCHES)
        t1 = time.perf_counter()
        label = f"phase 17 {key} training"
        r = phase_train(label, card, hypes, model, batches,
                        steps=TRAIN_MODEL_STEPS, repeats=TRAIN_MODEL_REPEATS,
                        autotune=False, profiled=1)
        r.pop("losses")
        t2 = time.perf_counter()
        r["eval_launches"] = trained_eval(f"phase 17 {key}", card, hypes, model,
                                          first_scene(batches[0]))
        r["setup_s"], r["train_s"] = t1 - t0, t2 - t1
        r["eval_s"] = time.perf_counter() - t2
        for mode in ("auto", "pallas"):
            for k, v in r["eval_launches"][mode].items():
                launches[k] = launches.get(k, 0) + v
        r["seconds"] = time.perf_counter() - t0
        print(f"phase 17 {key} [{card}]: trained and evaluated in "
              f"{r['seconds']:.1f} s (model and batches {r['setup_s']:.1f}, "
              f"training {r['train_s']:.1f}, evaluation {r['eval_s']:.1f})")
        res["configs"][key] = r
        del model, batches
        torch.cuda.empty_cache()
    res["cli_camera_on_disk"] = camera_train_cli(card)
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 17 [{card}] in {res['seconds']:.1f} s; launches in its "
          f"evaluations: {launches}")
    return res


# ---------------------------------------------------------------------------
# Phase 18: OPV2V and DAIR-V2X on disk

# the configurations: (dataset, name) of hypes_yaml/opv2v/opv2v_<name>.yaml
# and hypes_yaml/dair-v2x/dair_<name>.yaml, read whole (nothing cut)
DISK_YAMLS = {"opv2v": "hypes_yaml/opv2v/opv2v_{}.yaml",
              "dair": "hypes_yaml/dair-v2x/dair_{}.yaml"}
DISK_CONFIGS = tuple(("opv2v", n) for n in (
    "single", "attfuse", "fcooper", "where2comm", "v2xvit", "cobevt", "v2vnet",
    "when2com", "baseline_multiscale", "scope")) + tuple(("dair", n) for n in (
        "single", "attfuse", "fcooper", "where2comm", "v2xvit", "cobevt",
        "v2vnet", "when2com"))
DISK_TRAIN = ("attfuse", "where2comm", "v2vnet", "scope")  # OPV2V, batch 2
DISK_RUNS = 1  # timed runs per config and mode, after a warm-up (2 until PR 14)
DISK_STAMPS = 4  # OPV2V timestamps, DAIR frames
DISK_POINTS = 50000  # points written per cloud (max_points 60,000)
DISK_OBJECTS = 20
DISK_LIDAR_Z = 1.9  # the vehicles' lidar height over the ground (m)
# the OPV2V cavs: (dx, dy) from the ego (m) and yaw (degrees); cav 105 lies
# beyond the 70 m communication range, which the dataset's gate drops
DISK_CAVS = {"100": (0.0, 0.0, 0.0), "101": (18.0, 6.0, 10.0),
             "102": (-24.0, -9.0, -5.0), "103": (41.0, 14.0, 0.0),
             "104": (-48.0, 16.0, 15.0), "105": (115.0, 2.0, 0.0)}
DISK_SCENARIO = "2021_08_20_00_00_00"
# DAIR: the vehicle's pose at frame 0 (x, y, z, yaw) and the roadside unit's
# lidar pose; the raw frame's system error offset
DAIR_VEHICLE = (100.0, 50.0, 1.9, 30.0)
DAIR_INFRA = (112.0, 62.0, 6.0, -60.0)
DAIR_OFFSET = {"delta_x": 0.5, "delta_y": -0.25}


def disk_hypes(dataset, name):
    """A phase-18 YAML as ``load_yaml`` gives it, bf16. SCOPE's YAML names
    its frame count ``fusion_args.frame``, which neither package's dataset
    reads (ROADMAP §3): it goes to ``fusion.args.num_sweep_frames``."""
    from airv2x_tpu_torch.config import load_yaml

    hypes = load_yaml(os.path.join(REPO, DISK_YAMLS[dataset].format(name)))
    hypes["model"]["args"]["dtype"] = "bf16"
    fa = hypes["model"]["args"].get("fusion_args")
    if fa and "frame" in fa:
        hypes.setdefault("fusion", {}).setdefault("args", {})[
            "num_sweep_frames"] = int(fa["frame"])
    return hypes


def disk_objects(rng, centre):
    """DISK_OBJECTS vehicles around the world point ``centre``: world xy
    (n, 2), yaw (n,) in degrees, half extents (n, 3)."""
    n = DISK_OBJECTS
    xy = np.asarray(centre, np.float64) + rng.uniform([-60, -30], [60, 30], (n, 2))
    ext = np.stack([rng.uniform(1.9, 2.5, n), rng.uniform(0.85, 1.05, n),
                    rng.uniform(0.7, 0.9, n)], 1)
    return xy, rng.uniform(-180, 180, n), ext


def disk_cloud(rng, sensor_pose, objects):
    """DISK_POINTS points in the sensor's frame: a fifth inside the boxes of
    the objects within 70 m of it, the rest on the ground over 140 x 80 m
    around it (not within 2.5 m, its carrier); intensity in [0, 1)."""
    from airv2x_tpu_torch.utils import transforms as tf

    xy, yaw, ext = objects
    near = np.hypot(*(xy - np.asarray(sensor_pose[:2])).T) < 70.0
    n_obj = DISK_POINTS // 5 if near.any() else 0
    n_ground = DISK_POINTS - n_obj
    g = rng.uniform([-70.0, -40.0], [70.0, 40.0], (2 * n_ground, 2))
    g = g[(np.abs(g) >= 2.5).any(1)][:n_ground]
    ground = np.column_stack([g, rng.normal(-sensor_pose[2], 0.03, len(g))])
    idx = rng.choice(np.nonzero(near)[0], n_obj) if n_obj else np.zeros(0, int)
    local = rng.uniform(-1.0, 1.0, (n_obj, 3)) * ext[idx]
    c, s = np.cos(np.radians(yaw[idx])), np.sin(np.radians(yaw[idx]))
    world = np.column_stack([xy[idx, 0] + c * local[:, 0] - s * local[:, 1],
                             xy[idx, 1] + s * local[:, 0] + c * local[:, 1],
                             ext[idx, 2] + local[:, 2]])
    to_sensor = np.linalg.inv(tf.pose_to_world(sensor_pose))
    obj = world @ to_sensor[:3, :3].T + to_sensor[:3, 3]
    pts = np.vstack([ground, obj])
    return np.column_stack([pts, rng.uniform(0, 1, len(pts))]).astype(np.float32)


def write_opv2v_split(root, rng):
    """An OPV2V split: one scenario of DISK_STAMPS timestamps, the cavs of
    DISK_CAVS around an ego moving 2 m per stamp, each with its yaml
    (``lidar_pose``, ``ego_speed``, the ``vehicles`` within 100 m of it)
    and a cloud of DISK_POINTS points; DISK_OBJECTS vehicles."""
    import yaml

    from airv2x_tpu_torch.data.pcd import write_pcd

    objects = disk_objects(rng, (0.0, 0.0))
    xy, yaw, ext = objects
    scen = os.path.join(root, DISK_SCENARIO)
    for t in range(DISK_STAMPS):
        for cav, (dx, dy, dyaw) in DISK_CAVS.items():
            pose = [2.0 * t + dx, dy, DISK_LIDAR_Z, 0.0, dyaw, 0.0]
            cdir = os.path.join(scen, cav)
            os.makedirs(cdir, exist_ok=True)
            near = np.hypot(*(xy - pose[:2]).T) < 100.0
            meta = {"lidar_pose": pose, "ego_speed": 7.2,
                    "vehicles": {1000 + int(i): {
                        "location": [float(xy[i, 0]), float(xy[i, 1]), 0.0],
                        "angle": [0.0, float(yaw[i]), 0.0],
                        "center": [0.0, 0.0, float(ext[i, 2])],
                        "extent": [float(v) for v in ext[i]]}
                        for i in np.nonzero(near)[0]}}
            with open(os.path.join(cdir, f"{t:06d}.yaml"), "w") as f:
                yaml.safe_dump(meta, f)
            write_pcd(os.path.join(cdir, f"{t:06d}.pcd"),
                      disk_cloud(rng, pose, objects))


def _box_corners(xy, yaw_deg, ext):
    """World corners (8, 3) of one box in the reference's template order
    (bottom face first; edge 0-3 along the length)."""
    from airv2x_tpu_torch.data.airv2x_dataset import _CORNER_SIGNS

    local = _CORNER_SIGNS * ext
    c, s = np.cos(np.radians(yaw_deg)), np.sin(np.radians(yaw_deg))
    return np.column_stack([xy[0] + c * local[:, 0] - s * local[:, 1],
                            xy[1] + s * local[:, 0] + c * local[:, 1],
                            ext[2] + local[:, 2]])


def write_dair_split(root, raw_root, rng):
    """A normalized DAIR split of DISK_STAMPS frames (the vehicle moving 2 m
    per frame, the roadside unit fixed; DISK_POINTS points per cloud;
    DISK_OBJECTS world-frame labels) under ``root``, and its frame 0 in the
    raw release's layout under ``raw_root``: the calib chain (lidar ->
    novatel -> world, virtuallidar -> world less the system error offset)
    and ``world_8_points`` labels."""
    import json
    import shutil

    from airv2x_tpu_torch.data.pcd import write_pcd
    from airv2x_tpu_torch.utils import transforms as tf

    def dump(base, rel, obj):
        path = os.path.join(base, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f)

    vx, vy, vz, vyaw = DAIR_VEHICLE
    ix, iy, iz, iyaw = DAIR_INFRA
    objects = disk_objects(rng, (vx, vy))
    xy, yaw, ext = objects
    infos = []
    for i in range(DISK_STAMPS):
        veh = [vx + 2.0 * i, vy, vz, 0.0, vyaw, 0.0]
        inf = [ix, iy, iz, 0.0, iyaw, 0.0]
        for side, pose in (("veh", veh), ("inf", inf)):
            path = os.path.join(root, "velodyne", f"{side}_{i:06d}.pcd")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_pcd(path, disk_cloud(rng, pose, objects))
        dump(root, f"cooperative/label_{i:06d}.json", [
            {"location": [float(xy[k, 0]), float(xy[k, 1]), float(ext[k, 2])],
             "rotation": float(np.radians(yaw[k])),
             "extent": [float(v) for v in ext[k]]} for k in range(len(xy))])
        infos.append({
            "vehicle_pointcloud_path": f"velodyne/veh_{i:06d}.pcd",
            "infrastructure_pointcloud_path": f"velodyne/inf_{i:06d}.pcd",
            "vehicle_lidar_pose": veh, "infrastructure_lidar_pose": inf,
            "cooperative_label_path": f"cooperative/label_{i:06d}.json"})
    dump(root, "cooperative/data_info.json", infos)

    veh_w = tf.pose_to_world(infos[0]["vehicle_lidar_pose"])
    inf_w = tf.pose_to_world(infos[0]["infrastructure_lidar_pose"])
    dump(raw_root, "vehicle-side/calib/lidar_to_novatel/veh_000000.json",
         {"transform": {"rotation": np.eye(3).tolist(),
                        "translation": [[0.0], [0.0], [0.0]]}})
    dump(raw_root, "vehicle-side/calib/novatel_to_world/veh_000000.json",
         {"rotation": veh_w[:3, :3].tolist(),
          "translation": veh_w[:3, 3:].tolist()})
    t_inf = inf_w[:3, 3] - [DAIR_OFFSET["delta_x"], DAIR_OFFSET["delta_y"], 0.0]
    dump(raw_root, "infrastructure-side/calib/virtuallidar_to_world/"
         "inf_000000.json", {"rotation": inf_w[:3, :3].tolist(),
                             "translation": t_inf[:, None].tolist()})
    dump(raw_root, "cooperative/raw_label_000000.json", [
        {"world_8_points": _box_corners(xy[k], yaw[k], ext[k]).tolist()}
        for k in range(len(xy))])
    dump(raw_root, "cooperative/data_info.json", [{
        "vehicle_pointcloud_path": "velodyne/veh_000000.pcd",
        "infrastructure_pointcloud_path": "velodyne/inf_000000.pcd",
        "cooperative_label_path": "cooperative/raw_label_000000.json",
        "system_error_offset": dict(DAIR_OFFSET)}])
    shutil.copytree(os.path.join(root, "velodyne"),
                    os.path.join(raw_root, "velodyne"))


def bev_rectangles(boxes):
    """hwl boxes (N, 7) -> their sorted BEV corners (N, 4, 2), equal for two
    parametrisations of one rectangle (length and width swapped, the yaw a
    quarter turn apart)."""
    out = []
    for x, y, _, _, w, l, yaw in np.asarray(boxes, np.float64):
        c, s = np.cos(yaw), np.sin(yaw)
        out.append(sorted((x + c * dx - s * dy, y + s * dx + c * dy)
                          for dx, dy in ((l / 2, w / 2), (l / 2, -w / 2),
                                         (-l / 2, w / 2), (-l / 2, -w / 2))))
    return np.array(out)


def dair_raw_check(card, hypes, root, raw_root, work):
    """The raw frame read directly and converted by the port's
    ``dair_convert`` against the normalized frame 0: the same points and
    masks, the same boxes (as rectangles: the converter takes corner edge
    0-1 as the length, ROADMAP §3)."""
    from airv2x_tpu_torch.data.dair_dataset import DAIRDataset
    from airv2x_tpu_torch.tools import dair_convert

    conv = os.path.join(work, "dair_converted")
    if dair_convert.convert(raw_root, conv) != 1:
        raise AssertionError("phase 18 dair_convert converted no frame")
    os.symlink(os.path.join(raw_root, "velodyne"), os.path.join(conv, "velodyne"))
    want = DAIRDataset(hypes, root, train=False)[0]
    out = {}
    for kind, path in (("raw", raw_root), ("converted", conv)):
        got = DAIRDataset(hypes, path, train=False)[0]
        b, g = got[0], got[1]
        if not (np.array_equal(b["points_mask"], want[0]["points_mask"])
                and np.array_equal(g["mask"], want[1]["mask"])):
            raise AssertionError(f"phase 18 DAIR {kind} frame: masks differ")
        m = g["mask"]
        err = {"points": float(np.abs(b["points"] - want[0]["points"]).max()),
               "box_centres": float(np.abs(g["boxes"][m][:, :4]
                                           - want[1]["boxes"][m][:, :4]).max()),
               "box_rectangles": float(np.abs(
                   bev_rectangles(g["boxes"][m])
                   - bev_rectangles(want[1]["boxes"][m])).max())}
        print(f"phase 18 DAIR {kind} frame 0 against the normalized one [{card}]: "
              f"{int(b['points_mask'].sum())} points, {int(m.sum())} boxes, max "
              "abs differences " + json.dumps(err))
        if max(err.values()) > 1e-3:
            raise AssertionError(f"phase 18 DAIR {kind} frame differs: {err}")
        out[kind] = err
    return out


def disk_items(hypes, dataset, root, use_radar=False, limit=None):
    """Every sample (the first ``limit``) of the split through the config's
    dataset and ``RealDataLoader`` (batch 1, eval) on the card: (batch, gt
    quads) pairs. OPV2V batches come from the loader's iterator (one sample
    only: its collate); DAIR samples through its collate (its
    ``__getitem__`` takes no epoch: ROADMAP §3). ``use_radar`` reads the
    V2X-R radar clouds too. A temporal batch gets its pairwise transforms
    repeated over the frames (``pairwise_over_frames``)."""
    from airv2x_tpu_torch.data.dair_dataset import DAIRDataset
    from airv2x_tpu_torch.data.loader import RealDataLoader
    from airv2x_tpu_torch.data.opv2v_dataset import (
        OPV2VDataset, pairwise_over_frames)
    from airv2x_tpu_torch.ops import geometry as geo

    if dataset == "opv2v" and limit == 1:
        ds = OPV2VDataset(hypes, root, train=False, use_radar=use_radar)
        loader = RealDataLoader(ds, hypes, 1, train=False, device="cuda")
        pairs = [loader._collate([ds[0]])]
    elif dataset == "opv2v":
        ds = OPV2VDataset(hypes, root, train=False, use_radar=use_radar)
        loader = RealDataLoader(ds, hypes, 1, train=False, num_workers=2,
                                device="cuda")
        pairs = list(loader.batches(0, with_gt=True))[:limit]
    else:
        ds = DAIRDataset(hypes, root, train=False)
        loader = RealDataLoader(ds, hypes, 1, train=False, device="cuda")
        pairs = [loader._collate([ds[i]]) for i in range(len(ds))]
    items = []
    for batch, gt in pairs:
        m = gt["mask"][0]
        quads = geo.boxes_to_corners_bev(
            torch.from_numpy(gt["boxes"][0][m]).to("cuda"), order="hwl")
        items.append((pairwise_over_frames(batch), quads))
    return items


def disk_model(hypes, calibrate_on=None):
    """The config's model on the card with seeded random weights
    (``init_random_`` seed 0, drawn on the card; SCOPE's cls head scaled by
    SCOPE_CLS_SCALE as in phase 12), its BatchNorm statistics set from the
    batch ``calibrate_on`` where given (``calibrate_bn_``), cast to bf16."""
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import cast_weights_, init_random_

    model = init_random_(build_model(hypes, device="cuda"), seed=0,
                         device="cuda")
    if hypes["model"]["core_method"].startswith("point_pillar_scope"):
        with torch.no_grad():
            model.cls_head.weight.mul_(SCOPE_CLS_SCALE)
    if calibrate_on is not None:
        calibrate_bn_(model, calibrate_on)
    return cast_weights_(model, torch.bfloat16)


def disk_step(hypes, model, stat):
    """One scene: forward, decode (rotated NMS, K2) and the AP's
    accumulation (one det x gt IoU, K2, where both are non-empty) into
    ``stat``; returns (outputs, kept, whether the AP launched K2)."""
    from airv2x_tpu_torch.eval.ap import accumulate_scene

    decode, _ = det_decoder(hypes)

    def run(item, mark):
        batch, gt_quads = item
        with torch.inference_mode():
            out = model(batch)
            mark("forward")
            det = decode(out)
            keep = det.mask
            kept = int(keep.sum())
            accumulate_scene(det.corners[keep][:, :4, :2],
                             det.scores[keep].float().cpu().numpy(), gt_quads,
                             stat)
            mark("decode+AP")
        return out, kept, bool(kept and gt_quads.shape[0])

    return run


def disk_convs(hypes):
    """K4a launches per scene in ``pallas``: the plain backbone's stride-1
    ConvBNReLUs, one pass (0 on the ResNet backbone)."""
    bb = hypes["model"]["args"].get("base_bev_backbone")
    return 0 if not bb or bb.get("resnet") else sum(bb["layer_nums"])


# where the port's modules call the wrappers of K1, K4a and K2
KERNEL_CALL_SITES = (("airv2x_tpu_torch.ops.fast_pillars", "pillar_encode"),
                     ("airv2x_tpu_torch.models.nn", "conv3x3_same"),
                     ("airv2x_tpu_torch.ops.nms", "quad_iou"),
                     ("airv2x_tpu_torch.eval.ap", "quad_iou"))


@contextlib.contextmanager
def recorded_kernel_inputs(seen: dict, every: bool = False):
    """Within the block every call of a KERNEL_CALL_SITES wrapper passes
    through, and the first call of each wrapper and input (shapes, types,
    options) leaves its arguments in ``seen``; with ``every``, each call
    does (inputs of one shape from several modules, as L4DR's three conv
    stacks give)."""
    import importlib

    calls = itertools.count()
    saved = []
    for mod_name, attr in KERNEL_CALL_SITES:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def call(*args, _fn=fn, _name=attr, **kw):
            key = (_name,) + tuple(
                (tuple(a.shape), str(a.dtype)) for a in args
                if torch.is_tensor(a)) + tuple(sorted(
                    (k, str(v)) for k, v in kw.items()
                    if not torch.is_tensor(v) and v is not None))
            if every:
                key += (next(calls),)
            seen.setdefault(key, (args, kw))
            return _fn(*args, **kw)

        setattr(mod, attr, call)
    try:
        yield seen
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def check_kernel_inputs(label, seen: dict, done: set) -> list:
    """Each input of ``seen`` not in ``done`` through its kernel and the
    kernel's plain version (TF32 off), within the tolerances of phases 2-4:
    K1 K1_TOL (f32) or K1_TOL_BF16 x (1 + |plain|) (bf16), K4a K4_TOL x
    (1 + scale) (f32) or K4_TOL_BF16 x (1 + |plain|) (bf16), K2 K2_TOL on
    the pairs its caller reads (i < j for NMS). Returns one row per input."""
    from airv2x_tpu_torch.ops.conv3x3 import conv3x3_same, conv3x3_same_plain
    from airv2x_tpu_torch.ops.pillar_encode import (
        pillar_encode, pillar_encode_plain)
    from airv2x_tpu_torch.ops.quad_iou import quad_iou, quad_iou_plain

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    set_tf32(False)
    rows = []
    for key, (args, kw) in seen.items():
        if key in done:
            continue
        done.add(key)
        name = key[0]
        with torch.inference_mode():
            if name == "pillar_encode":
                got = pillar_encode(*args, **kw)
                ref = pillar_encode_plain(*args, **kw)
                bf16 = kw["out_dtype"] == torch.bfloat16
                tol = K1_TOL_BF16 if bf16 else K1_TOL
            elif name == "conv3x3_same":
                got = conv3x3_same(*args, **kw)
                ref = conv3x3_same_plain(*args, relu=kw.get("relu", False))
                bf16 = args[0].dtype == torch.bfloat16
                tol = (K4_TOL_BF16 if bf16
                       else K4_TOL * (1 + float(ref.float().abs().max())))
            else:
                if not min(a.shape[0] for a in args):
                    continue
                got = quad_iou(*args, **kw)
                ref = quad_iou_plain(*args)
                # pairs of finite quads (a decoded box of an overflowed
                # regression is not; NMS never keeps it), and for NMS the
                # pairs i < j it reads; a NaN IoU (a finite quad too large
                # for f32 areas) as both callers read it: no overlap
                fin = [torch.isfinite(a).flatten(1).all(1) for a in args]
                pairs = fin[0][:, None] & fin[1][None, :]
                if kw.get("triangular"):
                    pairs = pairs.triu(1)
                got, ref = got[pairs], ref[pairs]
                nonfinite = sum(int((~f).sum()) for f in fin)
                nan_pairs = [int(t.isnan().sum()) for t in (got, ref)]
                got, ref = got.nan_to_num(nan=0.0), ref.nan_to_num(nan=0.0)
                bf16, tol = False, K2_TOL
            torch.cuda.synchronize()
            d = (got.float() - ref.float()).abs()
            err = float(d.max()) if d.numel() else 0.0
            ok = (bool((d <= tol * (1 + ref.float().abs())).all()) if bf16
                  else err <= tol)
        row = {"kernel": {"pillar_encode": "K1", "conv3x3_same": "K4a",
                          "quad_iou": "K2"}[name],
               "shapes": [list(a.shape) for a in args if torch.is_tensor(a)],
               "dtype": str((kw.get("out_dtype") if name == "pillar_encode"
                             else args[0].dtype)).removeprefix("torch."),
               "max_abs_err": err,
               "tol": f"{tol} x (1 + |plain|)" if bf16 else tol}
        if name == "quad_iou":
            row.update(triangular=bool(kw.get("triangular")),
                       nonfinite_quads=nonfinite, nan_pairs=nan_pairs)
        print(f"{label}: {row['kernel']} at the path's input {row['shapes']} "
              f"{row['dtype']}: max|kernel - plain| {err:.3e} (tol "
              f"{row['tol']})" + (
                  f"; {nonfinite} non-finite quads left out, NaN IoUs "
                  f"(kernel, plain) {nan_pairs} read as 0"
                  if name == "quad_iou" and (nonfinite or any(nan_pairs))
                  else ""))
        if not ok:
            raise AssertionError(f"{label}: {row['kernel']} disagrees with its "
                                 f"plain version at {row['shapes']}: {err}")
        rows.append(row)
    seen.clear()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return rows


def time_disk(label, run, items, hypes, mode, checked=None, per_scene=None):
    """Warm-up, then DISK_RUNS timed runs over ``items``: ms/scene, peak
    memory, kept detections, and the launches asserted per scene (K1 once
    per frame, K4a ``disk_convs`` in ``pallas``, K2 once for the NMS and
    once more where the AP had detections and gt to match). Where
    ``checked`` is given, the warm-up's kernel inputs not in it are held to
    the plain versions before the counts and the peak are reset
    (``check_kernel_inputs``; its rows under "kernel_checks").
    ``per_scene`` gives other K1 / K4a (``pallas``) launches per scene."""
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.data.opv2v_dataset import temporal_frames

    seen = {}
    with (recorded_kernel_inputs(seen) if checked is not None
          else contextlib.nullcontext()):
        for item in items:
            run(item, no_mark)
    checks = (check_kernel_inputs(label, seen, checked)
              if checked is not None else [])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    run_ms, kept, ap = [], [], 0
    for _ in range(DISK_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for item in items:
            out, k, a = run(item, no_mark)
            kept.append(k)
            ap += a
        torch.cuda.synchronize()
        run_ms.append((time.perf_counter() - t0) / len(items) * 1e3)
    launches = dict(kernels.LAUNCHES)
    n = DISK_RUNS * len(items)
    k1, k4 = per_scene or (temporal_frames(hypes), disk_convs(hypes))
    want = {"pillar_encode": k1 * n, "conv3x3": k4 * n if mode == "pallas" else 0,
            "quad_iou": n + ap}
    got = {k: launches.get(k, 0) for k in want}
    if got != want or launches.get("pillar_reduce", 0):
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    for k in ("psm", "rm"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{label}: non-finite {k}")
    return dict(ms=statistics.median(run_ms), run_ms=run_ms,
                peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                kept=kept[:len(items)], launches=launches,
                launches_per_scene={k: v / n for k, v in want.items()},
                kernel_checks=checks)


def phase_disk(card, work):
    """Phase 18 (a) and (b): the OPV2V split (DISK_CAVS: 5 vehicles and one
    beyond 70 m, DISK_STAMPS stamps, DISK_POINTS points per cloud,
    DISK_OBJECTS vehicles) and the DAIR split (DISK_STAMPS frames, vehicle
    and roadside unit, one raw frame converted by ``dair_convert`` and
    checked against its normalized twin) written under ``work``; every
    DISK_CONFIGS YAML at full width (bf16, seeded random weights, batch 1)
    through its dataset and ``RealDataLoader``, forward + decode + AP, in
    ``auto`` and ``pallas`` (DISK_RUNS timed runs, launches asserted per
    scene, a ``pallas`` profile window: busy and idle; the kernel inputs
    of each ``pallas`` warm-up held to their plain versions before the
    counted runs); then one loaded OPV2V temporal batch card against CPU."""
    from airv2x_tpu_torch.data.loader import RealDataLoader
    from airv2x_tpu_torch.data.opv2v_dataset import OPV2VDataset, temporal_frames
    from airv2x_tpu_torch.eval.ap import eval_final_results, new_result_stat

    t_phase = time.perf_counter()
    rng = np.random.default_rng(18)
    roots = {"opv2v": os.path.join(work, "opv2v"),
             "dair": os.path.join(work, "dair")}
    raw_root = os.path.join(work, "dair_raw")
    t0 = time.perf_counter()
    write_opv2v_split(roots["opv2v"], rng)
    write_dair_split(roots["dair"], raw_root, rng)
    print(f"phase 18 [{card}]: OPV2V split ({len(DISK_CAVS)} cavs x "
          f"{DISK_STAMPS} stamps) and DAIR split ({DISK_STAMPS} frames, one "
          f"raw) of {DISK_POINTS} points per cloud written in "
          f"{time.perf_counter() - t0:.2f} s")
    res = {"card": card, "configs": {}, "kernel_checks": []}
    checked = set()  # the kernel inputs already held to their plain versions
    res["dair_raw_frame"] = dair_raw_check(card, disk_hypes("dair", "single"),
                                           roots["dair"], raw_root, work)
    set_tf32(False)
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32 = True  # PyTorch's defaults for bf16
    cudnn.benchmark, cudnn.deterministic = False, False  # heuristics: 18 configs
    cache, launches = {}, {}
    for dataset, name in DISK_CONFIGS:
        t_cfg = time.perf_counter()
        hypes = disk_hypes(dataset, name)
        key = (dataset, temporal_frames(hypes))
        if key not in cache:
            t0 = time.perf_counter()
            cache[key] = disk_items(hypes, dataset, roots[dataset])
            torch.cuda.synchronize()
            print(f"phase 18 {dataset} loader [{card}]: {len(cache[key])} "
                  f"batches of {key[1]} frame(s) on the card in "
                  f"{(time.perf_counter() - t0) * 1e3 / len(cache[key]):.1f} ms "
                  "each (read, project, crop, collate, anchor targets)")
        items = cache[key]
        model = disk_model(hypes)
        label = f"phase 18 {dataset}_{name}"
        r = {}
        for mode in ("auto", "pallas"):
            stat = new_result_stat()
            run = disk_step(hypes, model, stat)
            with conv_mode(mode):
                r[mode] = time_disk(f"{label} {mode} [{card}]", run, items,
                                    hypes, mode,
                                    checked if mode == "pallas" else None)
            res["kernel_checks"] += r[mode].pop("kernel_checks")
            r[mode]["ap"] = eval_final_results(stat)
            for k, v in r[mode]["launches"].items():
                launches[k] = launches.get(k, 0) + v
        with conv_mode("pallas"):
            r["profile"] = phase_profile(
                f"{label} pallas [{card}]", disk_step(hypes, model,
                                                      new_result_stat()),
                items, top=6, n=PROFILED_SCENES)
        prof = r["profile"] or {}
        r["seconds"] = time.perf_counter() - t_cfg
        print(f"{label} [{card}]: ms/scene auto {r['auto']['ms']:.3f} "
              f"{[round(v, 3) for v in r['auto']['run_ms']]}, pallas "
              f"{r['pallas']['ms']:.3f} "
              f"{[round(v, 3) for v in r['pallas']['run_ms']]}; busy "
              f"{prof.get('busy_ms', float('nan')):.3f} ms/scene, idle "
              f"{prof.get('idle_share', float('nan')):.3f} (pallas); peak "
              f"{max(r[m]['peak_mib'] for m in ('auto', 'pallas')):.1f} MiB; "
              f"launches per scene {r['pallas']['launches_per_scene']}; kept "
              f"{r['pallas']['kept']}; AP {r['pallas']['ap']}; "
              f"{r['seconds']:.1f} s")
        res["configs"][f"{dataset}_{name}"] = r
        del model
        torch.cuda.empty_cache()
    del cache
    # (b) one loaded temporal batch, card against CPU
    hypes = disk_hypes("opv2v", "scope")
    batches = {}
    for dev in ("cuda", "cpu"):
        loader = RealDataLoader(OPV2VDataset(hypes, roots["opv2v"], train=True,
                                             seed=3), hypes, 2, seed=3,
                                num_workers=2, device=dev)
        batches[dev] = next(iter(loader.batches(0)))
    diff = same_batch(batches["cuda"], batches["cpu"])
    bad = {k: v for k, v in diff.items()
           if v > (BATCH_TARGET_TOL if k == "labels.targets" else 0.0)}
    print(f"phase 18 one loaded OPV2V temporal batch of 2 (points "
          f"{tuple(batches['cuda']['points'].shape)}), card against CPU, max "
          f"abs difference per key [{card}]: " + json.dumps(diff))
    if bad:
        raise AssertionError(f"phase 18: the card's batch differs: {bad}")
    res["batch_card_vs_cpu"] = diff
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 18 serving [{card}] in {res['seconds']:.1f} s; launches: "
          f"{launches}")
    return res


def disk_trained_eval(label, card, hypes, model, item, checked):
    """The trained f32 weights on one loaded scene in ``auto`` and
    ``pallas`` (deterministic cuDNN, TF32 off): finite outputs and the
    launches of each mode asserted (K1 once per frame, K4a ``disk_convs``
    in ``pallas``, K2 for the NMS and the AP); then the ``pallas`` run's
    kernel inputs not in ``checked`` held to their plain versions. Returns
    (launches per mode, ``check_kernel_inputs`` rows)."""
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.data.opv2v_dataset import temporal_frames
    from airv2x_tpu_torch.eval.ap import new_result_stat

    set_tf32(False)
    cudnn = torch.backends.cudnn
    cudnn.benchmark, cudnn.deterministic = False, True
    model.eval()
    run = disk_step(hypes, model, new_result_stat())
    launches, seen = {}, {}
    for mode in ("auto", "pallas"):
        kernels.reset_launch_counts()
        with conv_mode(mode), (recorded_kernel_inputs(seen) if mode == "pallas"
                               else contextlib.nullcontext()):
            out, kept, ap = run(item, no_mark)
        torch.cuda.synchronize()
        launches[mode] = dict(kernels.LAUNCHES)
        want = {"pillar_encode": temporal_frames(hypes),
                "conv3x3": disk_convs(hypes) if mode == "pallas" else 0,
                "quad_iou": 1 + int(ap)}
        got = {k: launches[mode].get(k, 0) for k in want}
        finite = all(bool(torch.isfinite(out[k]).all()) for k in ("psm", "rm"))
        print(f"{label} [{card}] eval of the trained weights, f32, {mode}: "
              f"{kept} kept detections, launches {got} (expected {want})")
        if got != want or not finite:
            raise AssertionError(f"{label} eval {mode}: launches {got}, "
                                 f"expected {want}, finite {finite}")
    rows = check_kernel_inputs(f"{label} [{card}] trained, f32", seen, checked)
    cudnn.deterministic = False
    return launches, rows


def phase_disk_train(card, work):
    """Phase 18 (c): DISK_TRAIN's OPV2V configs trained at full width on the
    written split (batch 2 through ``RealDataLoader`` in train mode, bf16
    autocast over f32 master weights, flax-like initialisation), as phase
    17 trains (``phase_train``: 2 warm-up steps, TRAIN_MODEL_STEPS timed,
    a one-step profile window, one batch TRAIN_MODEL_REPEATS times at
    REPEAT_LR_SCALE of the lr with its loss falling); then the trained
    weights evaluated through K1 / K4a / K2, their f32 kernel inputs held
    to the plain versions."""
    from airv2x_tpu_torch.data.loader import RealDataLoader
    from airv2x_tpu_torch.data.opv2v_dataset import (
        OPV2VDataset, pairwise_over_frames)
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_flax_like_

    t_phase = time.perf_counter()
    root = os.path.join(work, "opv2v")
    res = {"card": card, "configs": {}, "kernel_checks": []}
    launches, checked = {}, set()
    for name in DISK_TRAIN:
        t0 = time.perf_counter()
        hypes = disk_hypes("opv2v", name)
        assert int(hypes["train_params"]["batch_size"]) == TRAIN_BATCH
        loader = RealDataLoader(OPV2VDataset(hypes, root, train=True, seed=0),
                                hypes, TRAIN_BATCH, seed=0, num_workers=2,
                                device="cuda")
        batches = [pairwise_over_frames(b) for b in loader.batches(0)]
        model = init_flax_like_(build_model(hypes, device="cuda", train=True),
                                seed=0)
        t1 = time.perf_counter()
        label = f"phase 18 opv2v_{name} training"
        r = phase_train(label, card, hypes, model, batches,
                        steps=TRAIN_MODEL_STEPS, repeats=TRAIN_MODEL_REPEATS,
                        autotune=False, profiled=1)
        r.pop("losses")
        t2 = time.perf_counter()
        item = next(iter(disk_items(hypes, "opv2v", root)))
        r["eval_launches"], checks = disk_trained_eval(
            f"phase 18 opv2v_{name}", card, hypes, model, item, checked)
        res["kernel_checks"] += checks
        for mode in ("auto", "pallas"):
            for k, v in r["eval_launches"][mode].items():
                launches[k] = launches.get(k, 0) + v
        r["setup_s"], r["train_s"] = t1 - t0, t2 - t1
        r["seconds"] = time.perf_counter() - t0
        print(f"phase 18 opv2v_{name} [{card}]: trained and evaluated in "
              f"{r['seconds']:.1f} s (loader and model {r['setup_s']:.1f}, "
              f"training {r['train_s']:.1f})")
        res["configs"][name] = r
        del model, batches
        torch.cuda.empty_cache()
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 18 training [{card}] in {res['seconds']:.1f} s; launches in "
          f"its evaluations: {launches}")
    return res


# ---------------------------------------------------------------------------
# Phase 19: HEAL, STAMP and SiCP

RESNET_MODELS = ("airv2x_heal", "airv2x_stamp")  # no ConvBNReLU: no K4a
# (modality, task, YAML under hypes_yaml/airv2x/<modality>/<task>/)
HETERO_PATHS = tuple(
    (m, t, f"{n}/collab") for n in ("airv2x_heal", "airv2x_stamp")
    for m, t in (("lidar", "det"), ("lidar", "seg"), ("camera", "det"))
) + (("lidar", "det", "sicp"), ("lidar", "seg", "sicp"),
     ("camera", "det", "sicp"), ("camera", "seg", "sicp"))
HETERO_SCENES = 2  # LiDAR scenes with perturbed poses (camera: phase 16's)
HETERO_RUNS = 1  # timed runs per config and mode, after a warm-up
# phase 19's tiny models: init_random_'s seed, the first from 3 up whose
# decoded IoUs on the CPU lie more than 10 x ROI_MARGIN from the NMS
# threshold in every det model and conv mode, on phase 4f's scene (seed 6
# is the first past ROI_MARGIN itself, HEAL's by 4e-6)
TINY_HETERO_SEED = 14
MULTI_STAGE = ("airv2x_heal", "airv2x_stamp")  # LiDAR det, stage 1 and 2
MULTI_STAGE_STEPS = 2  # train steps of batch TRAIN_BATCH per stage run


def hetero_path(modality, task, name):
    return os.path.join(REPO, "hypes_yaml/airv2x", modality, task, f"{name}.yaml")


def hetero_hypes(modality, task, name):
    path = hetero_path(modality, task, name)
    return camera_hypes(path) if modality == "camera" else cut_hypes(path)


def phase_tiny_hetero(card):
    """Phase 19 (a): the tiny HEAL / STAMP / SiCP models (TINY_HETERO), det
    and seg, on the card against the same weights on the CPU, f32 with TF32
    off and pinned cuDNN, on phase 4f's scene (an absent drone, perturbed
    poses), in ``auto`` and, for SiCP, ``pallas`` (HEAL and STAMP hold no
    ConvBNReLU): outputs within TINY_TOL x (1 + scale), equal keep sets,
    K1 3 / K4a 3 (SiCP ``pallas``) or 0 / K2 1 (det) launches asserted, and
    the NMS and warp-footprint margins bounded."""
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import batch_to_torch
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    set_tf32(False)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    base = load_yaml(TINY)
    scene = tiny_family_scene(base)
    batch = {d: batch_to_torch(scene, d) for d in ("cpu", "cuda")}
    out = {}
    try:
        for name in TINY_HETERO:
            for task in ("det", "seg"):
                hypes = tiny_hetero_hypes(base, name, task)
                det = task == "det"
                keys = (("psm", "rm", "obj") if det
                        else ("dynamic_seg", "static_seg")) + ("comm_rate",)
                models = {d: init_random_(build_model(hypes, device=d),
                                          seed=TINY_HETERO_SEED)
                          for d in ("cpu", "cuda")}
                footprint = hetero_footprint_margin(models["cpu"], batch["cpu"])
                modes = ("auto",) if name in RESNET_MODELS else ("auto", "pallas")
                for mode in modes:
                    res = {}
                    for d, model in models.items():
                        decode, _ = det_decoder(hypes, d, TINY_SCOPE_TOP_K)
                        kernels.reset_launch_counts()
                        with conv_mode(mode), torch.inference_mode():
                            o = model(batch[d])
                            dets = decode(o) if det else None
                        if d == "cuda":
                            torch.cuda.synchronize()
                        res[d] = (o, dets, dict(kernels.LAUNCHES))
                    n = res["cuda"][2]
                    want = {"pillar_encode": 3, "quad_iou": int(det),
                            "conv3x3": backbone_convs(hypes)
                            if mode == "pallas" else 0}
                    if n != {k: want.get(k, 0) for k in n}:
                        raise AssertionError(f"tiny {name} {task} {mode}: {n}")
                    margins = {"footprint": footprint}
                    if det:
                        margins["nms"] = nms_margin(
                            res["cpu"][1], hypes["postprocess"]["nms_thresh"])
                    label = (f"phase 19 tiny {name} {task} {mode} card vs CPU "
                             f"[{card}] ({n['pillar_encode']} K1, {n['conv3x3']} "
                             f"K4a, {n['quad_iou']} K2 launches; margins "
                             + json.dumps({k: float(f"{v:.3e}")
                                           for k, v in margins.items()})
                             + f", limit {ROI_MARGIN})")
                    errs = compare(label, res["cuda"][0], res["cpu"][0], keys)
                    kept = None
                    if det:
                        same = bool(torch.equal(res["cuda"][1].mask.cpu(),
                                                res["cpu"][1].mask))
                        kept = int(res["cpu"][1].mask.sum())
                        print(f"phase 19 tiny {name} {mode}: keep sets card == "
                              f"CPU {same}, {kept} kept")
                        if not same or not kept:
                            raise AssertionError(f"tiny {name} {mode}: keep sets "
                                                 f"{same}, {kept} kept")
                    if min(margins.values()) <= ROI_MARGIN:
                        raise AssertionError(f"tiny {name} {task}: margins "
                                             f"{margins}")
                    out[f"{name} {task} {mode}"] = {"margins": margins,
                                                    "kept": kept,
                                                    "max_abs_err": errs}
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    return out


def hetero_scenes(hypes, layout):
    """HETERO_SCENES of phase 5's ``make_scene`` scenes (seed 19) with
    perturbed poses (seed 20), on the card: identity poses would leave
    every warp of the three models trivial."""
    from airv2x_tpu_torch.data.synthetic import (
        batch_to_torch, make_scene, perturb_poses)

    rng, poses = np.random.default_rng(19), np.random.default_rng(20)
    scenes = []
    for _ in range(HETERO_SCENES):
        b, _ = make_scene(rng, layout, num_objects=12, num_agents=NUM_AGENTS,
                          points_per_agent=POINTS_PER_AGENT,
                          lidar_range=hypes["preprocess"]["cav_lidar_range"],
                          pts_per_box=100)
        scenes.append(batch_to_torch(perturb_poses(with_lead(b), poses), "cuda"))
    return scenes


def calibrate_bn_(model, batch):
    """Set every BatchNorm's running statistics after the encoder (of a
    model that has one; BM2CP's: all) to its batch statistics on ``batch``
    (one train-mode pass, the encoder in eval mode, whose running-average
    update copies the batch's), then eval mode.
    HEAL's and STAMP's random serving weights need it: under
    ``init_random_``'s statistics, which are not their maps' own, their ~20
    residual blocks grow the maps until the decoded boxes overflow f32
    (phase 19's first call kept no detection: 630 of 1,024 NMS quads
    non-finite)."""
    import airv2x_tpu_torch.models.nn as tnn

    ema = tnn._ema_
    tnn._ema_ = lambda running, stat, momentum=None: running.copy_(stat)
    try:
        model.train()
        if hasattr(model, "encoder"):
            model.encoder.eval()
        with torch.no_grad():
            model(batch)
    finally:
        tnn._ema_ = ema
        model.eval()
    return model


def phase_hetero(card, camera_scenes):
    """Phase 19 (b): the ten serving configs of HETERO_PATHS at full width
    (cut as phase 5, bf16, seeded random weights drawn on the card, batch
    1): LiDAR on HETERO_SCENES perturbed ``make_scene`` scenes, camera on
    phase 16's on-disk scenes (``camera_scenes``), each in ``auto`` and
    ``pallas``: the ``pallas`` warm-up's kernel inputs held to their plain
    versions (``check_kernel_inputs``), then HETERO_RUNS timed runs
    (ms/scene, stage times, peak memory; launches asserted per scene: K1
    one per LiDAR type present, 0 on camera configs; K4a 16 per SiCP
    ``pallas`` scene, 0 for HEAL / STAMP; K2 1 per det scene), a ``pallas``
    profile window (busy, idle), kept detections or class histograms, and
    the perturbed scenes' smallest warp-footprint margin."""
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.models.base import SlotLayout
    from airv2x_tpu_torch.utils.weights import cast_weights_, init_random_

    t_phase = time.perf_counter()
    hypes = hetero_hypes("lidar", "det", "sicp")
    lidar = hetero_scenes(hypes, SlotLayout.from_args(hypes["model"]["args"]))
    set_tf32(False)
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32 = True  # PyTorch's defaults for bf16
    cudnn.benchmark, cudnn.deterministic = False, False  # heuristics
    res = {"card": card, "configs": {}, "kernel_checks": []}
    checked, launches = set(), {}
    for modality, task, name in HETERO_PATHS:
        t0 = time.perf_counter()
        h = hetero_hypes(modality, task, name)
        model = init_random_(build_model(h, device="cuda"), seed=0, device="cuda")
        scenes = camera_scenes if modality == "camera" else lidar
        if h["model"]["core_method"] in RESNET_MODELS:
            calibrate_bn_(model, scenes[0])
        margin = (hetero_footprint_margin(model, scenes[0])
                  if modality == "lidar" else None)
        cast_weights_(model, torch.bfloat16)
        run = camera_step(h, model)
        label = f"phase 19 {modality}/{task}/{name}"
        r = {"footprint_margin": margin}
        for mode in ("auto", "pallas"):
            want = {"pillar_encode": 3 if modality == "lidar" else 0,
                    "quad_iou": int(task == "det"),
                    "conv3x3": backbone_convs(h) if mode == "pallas" else 0}
            with conv_mode(mode):
                if mode == "pallas":
                    seen = {}
                    with recorded_kernel_inputs(seen):
                        for b in scenes:
                            run(b, no_mark)
                    res["kernel_checks"] += check_kernel_inputs(
                        f"{label} [{card}]", seen, checked)
                r[mode] = time_path(f"{label} {mode} [{card}]", run, scenes,
                                    want, runs=HETERO_RUNS)
            r[mode]["launches_per_scene"] = want
            for k, v in r[mode]["launches"].items():
                launches[k] = launches.get(k, 0) + v
        with conv_mode("pallas"):
            r["profile"] = phase_profile(f"{label} pallas [{card}]", run, scenes,
                                         top=6, n=PROFILED_SCENES)
        for mode in ("auto", "pallas"):
            results = r[mode].pop("results")
            if task == "det":
                r[mode]["kept"] = check_det(f"{label} {mode}", results,
                                            det_decoder(h)[1])
            else:
                r[mode]["class_hist"] = check_seg(f"{label} {mode}", results,
                                                  h["model"]["args"])
        prof = r["profile"] or {}
        r["seconds"] = time.perf_counter() - t0
        print(f"{label} [{card}]: ms/scene auto {r['auto']['ms']:.3f}, pallas "
              f"{r['pallas']['ms']:.3f}; busy "
              f"{prof.get('busy_ms', float('nan')):.3f} ms/scene, idle "
              f"{prof.get('idle_share', float('nan')):.3f} (pallas); peak "
              f"{max(r[m]['peak_mib'] for m in ('auto', 'pallas')):.1f} MiB; "
              f"launches per scene {r['pallas']['launches_per_scene']}; "
              + (f"footprint margin {margin:.3e}; " if margin is not None else "")
              + f"{r['seconds']:.1f} s")
        if margin is not None and margin <= ROI_MARGIN:
            raise AssertionError(f"{label}: a warp sample lies {margin} from its "
                                 "footprint's edge")
        res["configs"][f"{modality}/{task}/{name}"] = r
        del model, run
        torch.cuda.empty_cache()
    del lidar
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 19 serving [{card}] in {res['seconds']:.1f} s; launches: "
          f"{launches}")
    return res


def stage2_eval(label, card, hypes, run_dir, scene, checked):
    """A run dir's weights at its best epoch in an f32 eval model through
    ``trained_eval`` (K1 3 / K4a / K2 1 per scene asserted), its kernel
    inputs held to the plain versions."""
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.checkpoint import (
        find_best_epoch, load_model_weights)

    model = build_model(hypes, device="cuda")
    load_model_weights(run_dir, find_best_epoch(run_dir), model)
    seen = {}
    with recorded_kernel_inputs(seen):
        launches = trained_eval(label, card, hypes, model, scene)
    return launches, check_kernel_inputs(f"{label} [{card}] trained, f32", seen,
                                         checked)


def multi_stage(card, name, work, checked):
    """The multi-stage recipe of ``name`` on the LiDAR det YAMLs: stage 1,
    each ``single/{vehicle,rsu,drone}.yaml`` MULTI_STAGE_STEPS train steps of
    batch TRAIN_BATCH through ``tools/train.py`` (synthetic scenes, a run
    dir each); stage 2, ``tools/train_multi_stage.py`` on ``collab.yaml``
    (cut as phase 5, ``backbone_fix: true``) merging the three run dirs
    (drone, rsu, vehicle) and training MULTI_STAGE_STEPS steps; the frozen
    tensors must equal the vehicle run's, bit for bit; then the stage-2
    weights evaluated through K1 / K2 (``stage2_eval``)."""
    import io

    from airv2x_tpu_torch.config import save_yaml
    from airv2x_tpu_torch.data.synthetic import batch_to_torch, perturb_poses
    from airv2x_tpu_torch.models.base import SlotLayout
    from airv2x_tpu_torch.tools import train, train_multi_stage

    t0 = time.perf_counter()
    steps = ["--epochs", "1", "--steps_per_epoch", str(MULTI_STAGE_STEPS),
             "--batch_size", str(TRAIN_BATCH), "--device", "cuda",
             "--log_dir", work]
    runs, r = {}, {"stage1_s": {}}
    for t in ("vehicle", "rsu", "drone"):
        t1 = time.perf_counter()
        path = hetero_path("lidar", "det", f"{name}/single/{t}")
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            runs[t] = train.main(["--hypes_yaml", path, "--synthetic"] + steps)
        r["stage1_s"][t] = time.perf_counter() - t1
        print(f"phase 19 {name} stage 1 {t} [{card}]: {MULTI_STAGE_STEPS} steps "
              f"in {r['stage1_s'][t]:.1f} s: "
              + " | ".join(line for line in log.getvalue().splitlines()
                           if line.startswith("epoch")))
    hypes = hetero_hypes("lidar", "det", f"{name}/collab")
    hypes["model"]["args"]["backbone_fix"] = True
    collab = os.path.join(work, f"{name}_collab.yaml")
    save_yaml(hypes, collab)
    t1 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        run_dir = train_multi_stage.main(
            ["--hypes_yaml", collab] + [a for t in ("vehicle", "rsu", "drone")
                                        for a in (f"--{t}_dir", runs[t])] + steps)
    r["stage2_s"] = time.perf_counter() - t1
    lines = log.getvalue().splitlines()
    print(f"phase 19 {name} stage 2 [{card}] in {r['stage2_s']:.1f} s: "
          + " | ".join(lines[:-1]))
    loaded = [line for line in lines if line.startswith("loaded ")]
    if len(loaded) != 3 or not any(line.startswith("freezing") for line in lines):
        raise AssertionError(f"phase 19 {name} stage 2: {lines}")
    trained = torch.load(os.path.join(run_dir, "net_epoch1"), map_location="cpu",
                         weights_only=True)["model"]
    vehicle = torch.load(os.path.join(runs["vehicle"], "net_epoch1"),
                         map_location="cpu", weights_only=True)["model"]
    frozen = ("encoder.vehicle_pillar_vfe.dense.weight",
              "modality_backbone.stages.0.blocks.0.conv0.weight",
              "shrink_conv.blocks.0.conv1.weight", "det_heads.cls_head.weight")
    moved = "pyramid.resnet.stages.0.blocks.0.conv1.weight"
    same = all(torch.equal(trained[k], vehicle[k]) for k in frozen)
    print(f"phase 19 {name} stage 2 [{card}]: frozen tensors equal the vehicle "
          f"run's {same}; the pyramid trained "
          f"{not torch.equal(trained[moved], vehicle[moved])}")
    if not same or torch.equal(trained[moved], vehicle[moved]):
        raise AssertionError(f"phase 19 {name} stage 2: frozen or trained "
                             "tensors wrong")
    scene = perturbed_scene(hypes, SlotLayout.from_args(hypes["model"]["args"]))
    r["eval_launches"], r["kernel_checks"] = stage2_eval(
        f"phase 19 {name} stage 2", card, hypes, run_dir,
        batch_to_torch(scene, "cuda"), checked)
    r["loaded"] = loaded
    r["seconds"] = time.perf_counter() - t0
    return r


def phase_hetero_train(card):
    """Phase 19 (c): the multi-stage recipe (``multi_stage``) of HEAL and
    STAMP, then SiCP's LiDAR det config trained as phase 17 trains
    (``phase_train``: batch 2, bf16 autocast over f32 master weights, the
    repeated-batch check) and its trained weights evaluated through K1 /
    K4a / K2."""
    import shutil

    t_phase = time.perf_counter()
    res = {"card": card, "configs": {}, "kernel_checks": []}
    checked, launches = set(), {}
    work = scratch_dir("chip_smoke_hetero_")
    try:
        for name in MULTI_STAGE:
            r = multi_stage(card, name, work, checked)
            res["kernel_checks"] += r.pop("kernel_checks")
            res["configs"][f"{name} multi-stage"] = r
            for mode in ("auto", "pallas"):
                for k, v in r["eval_launches"][mode].items():
                    launches[k] = launches.get(k, 0) + v
            print(f"phase 19 {name} multi-stage [{card}] in {r['seconds']:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    hypes, model, batches = train_setup(hetero_hypes("lidar", "det", "sicp"),
                                        TRAIN_MODEL_BATCHES)
    label = "phase 19 lidar/det/sicp training"
    r = phase_train(label, card, hypes, model, batches, steps=TRAIN_MODEL_STEPS,
                    repeats=TRAIN_MODEL_REPEATS, autotune=False, profiled=1)
    r.pop("losses")
    r["eval_launches"] = trained_eval("phase 19 lidar/det/sicp", card, hypes,
                                      model, first_scene(batches[0]))
    for mode in ("auto", "pallas"):
        for k, v in r["eval_launches"][mode].items():
            launches[k] = launches.get(k, 0) + v
    r["seconds"] = time.perf_counter() - t0
    res["configs"]["sicp training"] = r
    del model, batches
    torch.cuda.empty_cache()
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 19 training [{card}] in {res['seconds']:.1f} s; launches in "
          f"its evaluations: {launches}")
    return res


# ---------------------------------------------------------------------------
# Phase 20: early fusion and BM2CP

# (dataset, YAML, scenes): AirV2X YAMLs under hypes_yaml/airv2x/, cut as
# phase 5, on make_scene scenes ("lidar") or on phase 16's written scenario
# ("camera"); OPV2V / DAIR names on phase 18's splits
EB_PATHS = (("airv2x", "lidar/det/early", "lidar"),
            ("airv2x", "camera/det/early", "lidar"),
            ("airv2x", "lidar/det/bm2cp", "lidar"),
            ("airv2x", "camera/det/bm2cp", "camera"),
            ("airv2x", "lidar/seg/bm2cp", "camera"),
            ("opv2v", "early", "disk"), ("opv2v", "disconet_teacher", "disk"),
            ("dair", "early", "disk"), ("opv2v", "bm2cp", "disk"),
            ("dair", "bm2cp", "disk"))
EB_SCENES = 2  # make_scene scenes and stamps of the camera scenario timed
EB_RUNS = 1  # timed runs per config and mode, after a warm-up
EB_TRAIN = ("lidar/det/early", "lidar/det/bm2cp")  # batch 2, 2 steps
EB_TRAIN_STEPS = 2
OPV2V_CAMERA_HW = (600, 800)  # OPV2V's camera images
DAIR_CAMERA_HW = (1080, 1920)  # DAIR-V2X's
# the tiny models' random-weight seed (init_random_): the first from 0 up
# whose NMS margin (det) and BM2CP communication margin on the tiny scene
# exceed ROI_MARGIN and BM2CP_MARGIN on the CPU
TINY_EB_SEED = 0
TINY_EB = (("airv2x_early", "det"), ("point_pillar_disconet_teacher", "det"),
           ("airv2x_bm2cp", "det"), ("airv2x_bm2cp", "seg"),
           ("point_pillar_bm2cp", "det"))


def eb_hypes(dataset, path):
    """A phase-20 config: an AirV2X YAML cut as phase 5 (BM2CP's camera
    blocks given the AirV2X augmentation keys, AIRV2X_AUG, as phase 16's),
    or a phase-18 YAML (``disk_hypes``); a ``*_bm2cp`` OPV2V / DAIR config
    gets its camera block where its dataset reads one (``vehicle.cam``;
    ROADMAP §3: the shipped YAML's ``img_params`` is read by neither
    package's loader)."""
    if dataset != "airv2x":
        hypes = disk_hypes(dataset, path)
        if path == "bm2cp":
            final = hypes["model"]["args"]["img_params"]["data_aug_conf"]["final_dim"]
            h, w = OPV2V_CAMERA_HW
            aug = {"H": h, "W": w, "final_dim": list(final),
                   "resize_lim": [0.6, 0.65], "bot_pct_lim": [0.0, 0.0],
                   "rot_lim": [0.0, 0.0], "rand_flip": False}
            hypes["model"]["args"]["vehicle"] = (
                {"modalities": ["lidar", "cam"], "cam": {"data_aug_conf": aug}}
                if dataset == "opv2v" else {"cam": {"data_aug_conf": aug}})
        return hypes
    hypes = cut_hypes(os.path.join(REPO, "hypes_yaml/airv2x", path + ".yaml"))
    hypes.setdefault("task", hypes["model"]["args"].get("task", "det"))
    args = hypes["model"]["args"]
    if hypes["model"]["core_method"] == "airv2x_bm2cp":
        for conf in (args["vehicle"]["img_params"], args["rsu"]["img_params"],
                     args["drone"]):
            conf["data_aug_conf"].update(AIRV2X_AUG)
    return hypes


def add_disk_cameras(roots, rng):
    """Cameras into phase 18's splits for the ``*_bm2cp`` configs: four per
    OPV2V cav frame (``<stamp>_camera{i}.png`` at OPV2V_CAMERA_HW, looking
    forward, right, back and left, with each one's ``cords`` and
    ``intrinsic`` in the frame's yaml) and one per DAIR frame and side (a
    JPEG at DAIR_CAMERA_HW, its camera -> lidar matrix and ``cam_K`` in
    ``data_info.json``). Each camera's image is encoded once and copied to
    every frame."""
    import json
    import shutil

    import yaml
    from PIL import Image

    def encoded(path, hw, **kw):
        Image.fromarray(smooth_image(rng, hw)).save(path, **kw)
        return path

    h, w = OPV2V_CAMERA_HW
    intr = [[w / 2.0, 0.0, w / 2.0], [0.0, w / 2.0, h / 2.0], [0.0, 0.0, 1.0]]
    scen = os.path.join(roots["opv2v"], DISK_SCENARIO)
    imgs = [encoded(os.path.join(roots["opv2v"], f"camera{i}.png"),
                    OPV2V_CAMERA_HW, compress_level=1) for i in range(4)]
    for cav in sorted(os.listdir(scen)):
        for t in range(DISK_STAMPS):
            ypath = os.path.join(scen, cav, f"{t:06d}.yaml")
            with open(ypath) as f:
                meta = yaml.safe_load(f)
            for i in range(4):
                shutil.copyfile(imgs[i], os.path.join(scen, cav,
                                                      f"{t:06d}_camera{i}.png"))
                pose = list(meta["lidar_pose"])
                pose[2] += 0.3
                pose[4] += 90.0 * i
                meta[f"camera{i}"] = {"cords": pose, "intrinsic": intr}
            with open(ypath, "w") as f:
                yaml.safe_dump(meta, f)
    h, w = DAIR_CAMERA_HW
    cam_k = [[w / 2.0, 0.0, w / 2.0], [0.0, w / 2.0, h / 2.0], [0.0, 0.0, 1.0]]
    c2l = np.eye(4)
    c2l[:3, :3] = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]  # LSS axes, forward
    info_path = os.path.join(roots["dair"], "cooperative", "data_info.json")
    with open(info_path) as f:
        infos = json.load(f)
    os.makedirs(os.path.join(roots["dair"], "image"), exist_ok=True)
    sides = {side: encoded(os.path.join(roots["dair"], "image", f"{side}.jpg"),
                           DAIR_CAMERA_HW, quality=90) for side in ("veh", "inf")}
    for i, info in enumerate(infos):
        for side, key in (("veh", "vehicle"), ("inf", "infrastructure")):
            rel = f"image/{side}_{i:06d}.jpg"
            shutil.copyfile(sides[side], os.path.join(roots["dair"], rel))
            c2l[:3, 3] = [0.5, 0.0, 1.2] if side == "veh" else [0.0, 0.0, 5.0]
            info.update({f"{key}_image_path": rel,
                         f"{key}_camera2lidar": c2l.tolist(),
                         f"{key}_cam_k": cam_k})
    with open(info_path, "w") as f:
        json.dump(infos, f)


def unobserved_depth(batch):
    """``depth_maps`` of -1 (no LiDAR return) beside a loaded OPV2V / DAIR
    camera block, on its device: neither package's loader projects the
    LiDAR into those cameras (ROADMAP §3), so BM2CP's predicted depth fills
    every pixel, as the reference does where no return lands."""
    cam = batch["cam_vehicle"]
    b, l, n, h, w = cam["imgs"].shape[:5]
    cam["depth_maps"] = torch.full((b, l, n, h, w), -1.0,
                                   device=cam["imgs"].device)
    return batch


def eb_lidar_scenes(hypes):
    """EB_SCENES of phase 5's ``make_scene`` scenes (seed 0) on the card;
    a BM2CP config's camera blocks (one camera per slot at its final_dim,
    ``bm2cp_airv2x_batch``, seed 1: vehicle and rsu depth maps in bin
    units) beside them."""
    from airv2x_tpu_torch.data.synthetic import (
        batch_to_torch, bm2cp_airv2x_batch, make_scene)
    from airv2x_tpu_torch.models.base import SlotLayout

    layout = SlotLayout.from_args(hypes["model"]["args"])
    rng, cam_rng = np.random.default_rng(0), np.random.default_rng(1)
    scenes = []
    for _ in range(EB_SCENES):
        b, _ = make_scene(rng, layout, num_objects=12, num_agents=NUM_AGENTS,
                          points_per_agent=POINTS_PER_AGENT,
                          lidar_range=hypes["preprocess"]["cav_lidar_range"],
                          pts_per_box=100)
        b = with_lead(b)
        if hypes["model"]["core_method"] == "airv2x_bm2cp":
            cams = bm2cp_airv2x_batch(hypes, cam_rng)
            b.update({k: v for k, v in cams.items() if k.startswith("cam_")})
        scenes.append(batch_to_torch(b, "cuda"))
    return scenes


def eb_step(hypes, model):
    """One AirV2X scene: the model's forward, then decode (NMS) or the seg
    class maps."""
    from airv2x_tpu_torch.data.postprocess import decode_segmentation

    if hypes["task"] == "det":
        decode, _ = det_decoder(hypes)
    else:
        def decode(out):
            return decode_segmentation(out["dynamic_seg"], out["static_seg"])

    def run(batch, mark):
        with torch.inference_mode():
            out = model(batch)
            mark("forward")
            res = decode(out)
            mark("decode")
        return out, res

    return run


def eb_launches(hypes, mode):
    """K1 / K4a / K2 launches per scene: K1 once on the merged early cloud
    and on the flat BM2CP's clouds, none on AirV2X BM2CP (the classic path);
    K4a the early models' plain 3 / 5 / 8 backbone in ``pallas`` (BM2CP's
    ResNet holds no ConvBNReLU); K2 once per det scene."""
    core = hypes["model"]["core_method"]
    bb = hypes["model"]["args"].get("base_bev_backbone")
    return {"pillar_encode": int(core != "airv2x_bm2cp"),
            "conv3x3": sum(bb["layer_nums"]) if bb and mode == "pallas" else 0,
            "quad_iou": int(hypes["task"] == "det")}


def eb_model(hypes, calibrate_on=None):
    """The config's model on the card with seeded random weights drawn on
    the card; a BM2CP model's BatchNorm statistics set from one scene
    (``calibrate_bn_``); then the bf16 serving cast."""
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import cast_weights_, init_random_

    model = init_random_(build_model(hypes, device="cuda"), seed=0, device="cuda")
    if "bm2cp" in hypes["model"]["core_method"] and calibrate_on is not None:
        calibrate_bn_(model, calibrate_on)
    return cast_weights_(model, torch.bfloat16)


def phase_tiny_early_bm2cp(card, device="cuda"):
    """Phase 20 (a): the tiny early, teacher, AirV2X BM2CP (det, seg) and
    flat BM2CP models (``tiny_early_hypes``, ``tiny_bm2cp_hypes``) on the
    card against the same weights on the CPU, f32 with TF32 off and pinned
    cuDNN, on phase 4f's scene (an absent drone, perturbed poses) with the
    tiny BM2CP cameras, in ``auto`` and ``pallas``: outputs within TINY_TOL
    x (1 + scale), equal keep sets, the launches asserted (K1 1 / 0 on
    AirV2X BM2CP, K4a 3 on the early models in ``pallas``, K2 1 per det),
    and the NMS and communication margins bounded. ``device`` "cpu" runs
    the CPU against itself (the margins, without a card)."""
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import batch_to_torch, bm2cp_airv2x_batch
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    set_tf32(False)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    base = load_yaml(TINY)
    scene = tiny_family_scene(base)
    cams = bm2cp_airv2x_batch(tiny_bm2cp_hypes(base), np.random.default_rng(1))
    scenes = {"airv2x": dict(scene, **{k: v for k, v in cams.items()
                                       if k.startswith("cam_")}),
              "flat": dict(scene, cam_vehicle={
                  k: np.concatenate([v[:, :3], v[:, :1]], axis=1)
                  for k, v in cams["cam_vehicle"].items()})}
    out = {}
    try:
        for name, task in TINY_EB:
            hypes = (tiny_early_hypes(base, name) if "bm2cp" not in name
                     else tiny_bm2cp_hypes(base, name, task))
            hypes.setdefault("task", task)
            sc = scenes["flat" if name == "point_pillar_bm2cp" else "airv2x"]
            batch = {d: batch_to_torch(sc, d) for d in ("cpu", device)}
            det = task == "det"
            keys = ({"point_pillar_bm2cp": ("psm", "rm", "psm_single_v",
                                            "psm_single_i"),
                     "point_pillar_disconet_teacher": ("psm", "rm",
                                                       "teacher_feature")}.get(
                name, ("psm", "rm", "obj")) if det
                else ("dynamic_seg", "static_seg")) + ("comm_rate",)
            models = {d: init_random_(build_model(hypes, device=d),
                                      seed=TINY_EB_SEED) for d in ("cpu", device)}
            margins = {}
            if "bm2cp" in name:
                margins["comm"] = bm2cp_comm_margin(models["cpu"], batch["cpu"])
            for mode in ("auto", "pallas"):
                res = {}
                for d in ("cpu", device):
                    decode, _ = det_decoder(hypes, d, TINY_SCOPE_TOP_K)
                    kernels.reset_launch_counts()
                    with conv_mode(mode), torch.inference_mode():
                        o = models[d](batch[d])
                        dets = decode(o) if det else None
                    if d == "cuda":
                        torch.cuda.synchronize()
                    res[d] = (o, dets, dict(kernels.LAUNCHES))
                if device == "cuda":
                    n = res["cuda"][2]
                    want = eb_launches(hypes, mode)
                    if n != {k: want.get(k, 0) for k in n}:
                        raise AssertionError(f"tiny {name} {task} {mode}: {n}")
                if det:
                    margins["nms"] = nms_margin(
                        res["cpu"][1], hypes["postprocess"]["nms_thresh"])
                label = (f"phase 20 tiny {name} {task} {mode} card vs CPU [{card}] "
                         f"(margins " + json.dumps(
                             {k: float(f"{v:.3e}") for k, v in margins.items()})
                         + f", limits nms {ROI_MARGIN}, comm {BM2CP_MARGIN})")
                errs = compare(label, res[device][0], res["cpu"][0], keys)
                kept = None
                if det:
                    same = bool(torch.equal(res[device][1].mask.cpu(),
                                            res["cpu"][1].mask))
                    kept = int(res["cpu"][1].mask.sum())
                    print(f"phase 20 tiny {name} {mode}: keep sets card == CPU "
                          f"{same}, {kept} kept")
                    if not same or not kept:
                        raise AssertionError(f"tiny {name} {mode}: keep sets "
                                             f"{same}, {kept} kept")
                if margins.get("nms", 1.0) <= ROI_MARGIN or margins.get(
                        "comm", 1.0) <= BM2CP_MARGIN:
                    raise AssertionError(f"tiny {name} {task}: margins {margins}")
                out[f"{name} {task} {mode}"] = {"margins": dict(margins),
                                                "kept": kept, "max_abs_err": errs}
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    return out


def phase_early_bm2cp(card, camera_root, disk_roots):
    """Phase 20 (b): the ten EB_PATHS configs at full width (AirV2X cut as
    phase 5; bf16, seeded random weights drawn on the card, BM2CP's BN
    statistics from one scene, batch 1): AirV2X early and LiDAR BM2CP on
    EB_SCENES ``make_scene`` scenes, BM2CP camera det and seg on phase
    16's written scenario through the BM2CP dataset (the LiDAR projected
    into each camera on the host; loaded once, the seg config reading the
    det config's samples, whose camera blocks are the same), the OPV2V / DAIR configs on phase 18's
    splits (cameras written into them for ``*_bm2cp``, ``add_disk_cameras``)
    through their datasets and ``RealDataLoader``; each in ``auto`` and
    ``pallas``: the ``pallas`` warm-up's kernel inputs held to their plain
    versions (``check_kernel_inputs``), then EB_RUNS timed runs (ms/scene,
    peak memory, K1 / K4a / K2 launches per scene asserted), a ``pallas``
    profile window (busy, idle), kept detections or class histograms, the
    OPV2V / DAIR AP."""
    from airv2x_tpu_torch.data.airv2x_dataset import AirV2XDataset
    from airv2x_tpu_torch.eval.ap import eval_final_results, new_result_stat
    from airv2x_tpu_torch.tools.inference import model_batch

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    add_disk_cameras(disk_roots, np.random.default_rng(20))
    print(f"phase 20 [{card}]: cameras written into phase 18's splits in "
          f"{time.perf_counter() - t0:.2f} s")
    set_tf32(False)
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32 = True  # PyTorch's defaults for bf16
    cudnn.benchmark, cudnn.deterministic = False, False  # heuristics
    res = {"card": card, "configs": {}, "kernel_checks": []}
    checked, launches, camera_scenes = set(), {}, None
    for dataset, path, kind in EB_PATHS:
        t_cfg = time.perf_counter()
        hypes = eb_hypes(dataset, path)
        label = f"phase 20 {dataset}/{path}"
        r = {}
        if kind == "disk":
            t0 = time.perf_counter()
            items = disk_items(hypes, dataset, disk_roots[dataset])
            if path == "bm2cp":
                items = [(unobserved_depth(b), q) for b, q in items]
            torch.cuda.synchronize()
            r["load_ms"] = (time.perf_counter() - t0) * 1e3 / len(items)
            model = eb_model(hypes, items[0][0])
            for mode in ("auto", "pallas"):
                stat = new_result_stat()
                with conv_mode(mode):
                    r[mode] = time_disk(f"{label} {mode} [{card}]",
                                        disk_step(hypes, model, stat), items,
                                        hypes, mode,
                                        checked if mode == "pallas" else None)
                res["kernel_checks"] += r[mode].pop("kernel_checks")
                r[mode]["ap"] = eval_final_results(stat)
            scenes, run = items, disk_step(hypes, model, new_result_stat())
        else:
            t0 = time.perf_counter()
            if kind == "lidar":
                scenes = eb_lidar_scenes(hypes)
            elif camera_scenes:  # the seg config reads the det config's
                scenes = camera_scenes
            else:
                ds = AirV2XDataset(hypes, camera_root, train=False)
                scenes = camera_scenes = [model_batch(ds[i][0], "cuda")
                                          for i in range(min(EB_SCENES, len(ds)))]
            torch.cuda.synchronize()
            r["load_ms"] = (time.perf_counter() - t0) * 1e3 / len(scenes)
            model = eb_model(hypes, scenes[0])
            run = eb_step(hypes, model)
            for mode in ("auto", "pallas"):
                want = eb_launches(hypes, mode)
                with conv_mode(mode):
                    if mode == "pallas":
                        seen = {}
                        with recorded_kernel_inputs(seen):
                            for b in scenes:
                                run(b, no_mark)
                        res["kernel_checks"] += check_kernel_inputs(
                            f"{label} [{card}]", seen, checked)
                    r[mode] = time_path(f"{label} {mode} [{card}]", run, scenes,
                                        want, runs=EB_RUNS)
                r[mode]["launches_per_scene"] = want
                results = r[mode].pop("results")
                if hypes["task"] == "det":
                    r[mode]["kept"] = check_det(f"{label} {mode}", results,
                                                det_decoder(hypes)[1])
                else:
                    r[mode]["class_hist"] = check_seg(f"{label} {mode}", results,
                                                      hypes["model"]["args"])
        for mode in ("auto", "pallas"):
            for k, v in r[mode]["launches"].items():
                launches[k] = launches.get(k, 0) + v
        with conv_mode("pallas"):
            r["profile"] = phase_profile(f"{label} pallas [{card}]", run, scenes,
                                         top=6, n=PROFILED_SCENES)
        prof = r["profile"] or {}
        r["seconds"] = time.perf_counter() - t_cfg
        print(f"{label} [{card}]: ms/scene auto {r['auto']['ms']:.3f}, pallas "
              f"{r['pallas']['ms']:.3f}; busy "
              f"{prof.get('busy_ms', float('nan')):.3f} ms/scene, idle "
              f"{prof.get('idle_share', float('nan')):.3f} (pallas); peak "
              f"{max(r[m]['peak_mib'] for m in ('auto', 'pallas')):.1f} MiB; "
              f"launches per scene {r['pallas']['launches_per_scene']}; load "
              f"{r['load_ms']:.1f} ms/scene; {r['seconds']:.1f} s")
        res["configs"][f"{dataset}/{path}"] = r
        del model, run, scenes
        torch.cuda.empty_cache()
    del camera_scenes
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 20 serving [{card}] in {res['seconds']:.1f} s; launches: "
          f"{launches}")
    return res


def phase_early_bm2cp_train(card):
    """Phase 20 (c): ``airv2x_early`` and AirV2X BM2CP LiDAR det trained as
    phase 17 trains (``phase_train``: batch 2, bf16 autocast over f32
    master weights, EB_TRAIN_STEPS timed steps, the repeated-batch check;
    no profile window, whose processing of BM2CP's ~18,000 kernels per step
    the phase's time cannot pay); BM2CP's batches carry one camera per slot
    (``bm2cp_airv2x_batch``)."""
    from airv2x_tpu_torch.data.synthetic import batch_to_torch, bm2cp_airv2x_batch

    t_phase = time.perf_counter()
    res = {"card": card, "configs": {}}
    for path in EB_TRAIN:
        t0 = time.perf_counter()
        hypes, model, batches = train_setup(eb_hypes("airv2x", path),
                                            TRAIN_MODEL_BATCHES)
        if hypes["model"]["core_method"] == "airv2x_bm2cp":
            rng = np.random.default_rng(8)
            for b in batches:
                cams = bm2cp_airv2x_batch(hypes, rng, batch_size=TRAIN_BATCH)
                b.update(batch_to_torch({k: v for k, v in cams.items()
                                         if k.startswith("cam_")}, "cuda"))
        r = phase_train(f"phase 20 {path} training", card, hypes, model, batches,
                        steps=EB_TRAIN_STEPS, repeats=TRAIN_MODEL_REPEATS,
                        autotune=False, profiled=0)
        r.pop("losses")
        r["seconds"] = time.perf_counter() - t0
        res["configs"][path] = r
        del model, batches
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 20 training [{card}] in {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 21: DiscoNet, How2comm, CoAlign and late fusion
# ---------------------------------------------------------------------------

FLAT_REST = tuple((d, n) for d in ("opv2v", "dair")
                  for n in ("disconet", "how2comm", "coalign"))
FLAT_REST_RUNS = 1  # timed runs per config and mode, after a warm-up
LATE_SCENES = 2  # synthetic scenes of each counted late-fusion CLI run
KD_STEPS = 3  # train_w_kd steps of the OPV2V DiscoNet student, batch 2
COALIGN_STEPS = 2  # timed CoAlign steps at batch 2, after one warm-up step


# the tiny models' random-weight seed (init_random_): the first from 0 up
# whose NMS margin on the tiny scene exceeds ROI_MARGIN in every model on
# the CPU (``phase_tiny_flat_rest("cpu", device="cpu")``)
TINY_FLAT_REST_SEED = 0
TINY_FLAT_REST = ("point_pillar_disconet", "point_pillar_how2comm",
                  "point_pillar_coalign")


def tiny_flat_rest_hypes(name):
    """SCOPE's tiny config (``tiny_scope_hypes``, 3 slots, 64 x 64 grid,
    16 / 32 channels) as DiscoNet (plain backbone), How2comm (ResNet, a
    query budget of every cell, so no query cut decides the outputs) or
    CoAlign (ResNet under ``res_bev_backbone``, no shrink)."""
    hypes = tiny_scope_hypes(resnet=name != "point_pillar_disconet")
    hypes["model"]["core_method"] = name
    args = hypes["model"]["args"]
    fa = args.pop("fusion_args")
    if name == "point_pillar_how2comm":
        args.update(flow_flag=True, delay=1, fusion_args={
            "voxel_size": fa["voxel_size"], "downsample_rate": 1,
            "communication": dict(fa["communication"], request_flag=True),
            "communication_flag": True, "num_queries": 32 * 32,
            "layer_nums": fa["layer_nums"], "num_filters": fa["num_filters"]})
    elif name == "point_pillar_coalign":
        args["res_bev_backbone"] = args.pop("base_bev_backbone")
        del args["shrink_header"]
        args["voxel_size"] = fa["voxel_size"]
    return hypes


def tiny_flat_rest_scene(name):
    """Two frames of ``scope_scene`` (distinct draws, perturbed history and
    poses, seeds 0 / 1), the third slot absent: the temporal batch for
    How2comm, its current frame for the others."""
    from airv2x_tpu_torch.models.base import SlotLayout

    b = scope_scene(np.random.default_rng(0), SlotLayout(counts=(3, 0, 0)), 2,
                    TINY_SCOPE_RANGE, pose_rng=np.random.default_rng(1),
                    points_per_agent=512)
    b["agent_mask"][:, :, 2] = False
    b["points_mask"][:, :, 2] = False
    if name == "point_pillar_how2comm":
        return b
    return {k: v[:, -1] for k, v in b.items() if k != "history_t"}


def phase_tiny_flat_rest(card, device="cuda"):
    """Phase 21 (a0): the tiny DiscoNet, How2comm and CoAlign models
    (``tiny_flat_rest_hypes``) on the card against the same weights on the
    CPU, f32, TF32 off, pinned cuDNN, in ``auto`` and ``pallas``: outputs
    within TINY_TOL x (1 + scale), keep sets equal, the NMS margin bounded,
    launches asserted (K1 1, How2comm 2; K4a 2 on DiscoNet's plain
    backbone in ``pallas``; K2 1). ``device`` "cpu" runs the CPU against
    itself (the margins, without a card)."""
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.data.synthetic import batch_to_torch
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    set_tf32(False)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    out = {}
    try:
        for name in TINY_FLAT_REST:
            hypes = tiny_flat_rest_hypes(name)
            scene = tiny_flat_rest_scene(name)
            batch = {d: batch_to_torch(scene, d) for d in ("cpu", device)}
            models = {d: init_random_(build_model(hypes, device=d),
                                      seed=TINY_FLAT_REST_SEED)
                      for d in ("cpu", device)}
            keys = ("psm", "rm", "comm_rate") + {
                "point_pillar_disconet": ("student_feature",),
                "point_pillar_how2comm": ("offset_loss", "commu_loss")}.get(
                    name, ())
            for mode in ("auto", "pallas"):
                res = {}
                for d in ("cpu", device):
                    decode, _ = det_decoder(hypes, d, TINY_SCOPE_TOP_K)
                    kernels.reset_launch_counts()
                    with conv_mode(mode), torch.inference_mode():
                        o = models[d](batch[d])
                        dets = decode(o)
                    if d == "cuda":
                        torch.cuda.synchronize()
                    res[d] = (o, dets, dict(kernels.LAUNCHES))
                if device == "cuda":
                    want = {"pillar_encode": 2 if "how2comm" in name else 1,
                            "conv3x3": 2 if "disconet" in name and mode == "pallas"
                            else 0, "quad_iou": 1}
                    n = res["cuda"][2]
                    if n != {k: want.get(k, 0) for k in n}:
                        raise AssertionError(f"tiny {name} {mode}: launches {n}")
                margin = nms_decision_margin(res["cpu"][1], hypes, TINY_SCOPE_TOP_K)
                label = (f"phase 21 tiny {name} {mode} card vs CPU [{card}] "
                         f"(NMS margin {margin:.3e}, limit {ROI_MARGIN})")
                errs = compare(label, res[device][0], res["cpu"][0], keys)
                same = bool(torch.equal(res[device][1].mask.cpu(),
                                        res["cpu"][1].mask))
                kept = int(res["cpu"][1].mask.sum())
                print(f"phase 21 tiny {name} {mode}: keep sets card == CPU "
                      f"{same}, {kept} kept")
                if not same or not kept or margin <= ROI_MARGIN:
                    raise AssertionError(f"tiny {name} {mode}: keep sets {same}, "
                                         f"{kept} kept, NMS margin {margin}")
                out[f"{name} {mode}"] = {"nms_margin": margin, "kept": kept,
                                         "max_abs_err": errs}
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    return out


def dair_frame_pairs(items):
    """DAIR's loaded one-frame batches as How2comm's 2-frame batches: frame
    i current, frame i - 1 its history (frame 0 its own), each frame's
    points, masks and ``pairwise_t_full`` stacked on a time axis; the gt of
    the current frame."""
    out = []
    for i, (cur, quads) in enumerate(items):
        prev = items[max(i - 1, 0)][0]
        batch = dict(cur)
        for k in ("points", "points_mask", "agent_mask", "pairwise_t_full"):
            batch[k] = torch.stack([prev[k], cur[k]], dim=1)
        out.append((batch, quads))
    return out


def phase_flat_rest(card, disk_roots):
    """Phase 21 (a): the FLAT_REST YAMLs at full width on phase 18's
    splits, each config as phase 18 runs its own (``time_disk``), every
    config's ``pallas`` kernel inputs held to the plain versions (not only
    shapes no earlier config gave)."""
    from airv2x_tpu_torch.eval.ap import eval_final_results, new_result_stat

    t_phase = time.perf_counter()
    set_tf32(False)
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32 = True  # PyTorch's defaults for bf16
    cudnn.benchmark, cudnn.deterministic = False, False  # heuristics
    res = {"card": card, "configs": {}, "kernel_checks": []}
    launches = {}
    for dataset, name in FLAT_REST:
        t_cfg = time.perf_counter()
        hypes = disk_hypes(dataset, name)
        label = f"phase 21 {dataset}_{name}"
        checked = set()  # each config's own kernel inputs, equal shapes too
        t0 = time.perf_counter()
        items = disk_items(hypes, dataset, disk_roots[dataset])
        if dataset == "dair" and name == "how2comm":
            items = dair_frame_pairs(items)
        torch.cuda.synchronize()
        r = {"load_ms": (time.perf_counter() - t0) * 1e3 / len(items),
             "frames": tuple(items[0][0]["points"].shape[:-2])}
        # How2comm's ~24 random residual blocks (its ResNet's and the flow
        # backbone's) push every logit far below the score threshold under
        # init_random_'s statistics: its decode kept nothing
        model = disk_model(hypes, items[0][0] if name == "how2comm" else None)
        for mode in ("auto", "pallas"):
            stat = new_result_stat()
            with conv_mode(mode):
                r[mode] = time_disk(f"{label} {mode} [{card}]",
                                    disk_step(hypes, model, stat), items, hypes,
                                    mode, checked if mode == "pallas" else None)
            res["kernel_checks"] += r[mode].pop("kernel_checks")
            r[mode]["ap"] = eval_final_results(stat)
            for k, v in r[mode]["launches"].items():
                launches[k] = launches.get(k, 0) + v
        with conv_mode("pallas"):
            r["profile"] = phase_profile(
                f"{label} pallas [{card}]", disk_step(hypes, model,
                                                      new_result_stat()),
                items, top=6, n=PROFILED_SCENES)
        prof = r["profile"] or {}
        r["seconds"] = time.perf_counter() - t_cfg
        print(f"{label} [{card}]: batch {r['frames']}; ms/scene auto "
              f"{r['auto']['ms']:.3f}, pallas {r['pallas']['ms']:.3f}; busy "
              f"{prof.get('busy_ms', float('nan')):.3f} ms/scene, idle "
              f"{prof.get('idle_share', float('nan')):.3f} (pallas); peak "
              f"{max(r[m]['peak_mib'] for m in ('auto', 'pallas')):.1f} MiB; "
              f"launches per scene {r['pallas']['launches_per_scene']}; kept "
              f"{r['pallas']['kept']}; AP {r['pallas']['ap']}; load "
              f"{r['load_ms']:.1f} ms/scene; {r['seconds']:.1f} s")
        res["configs"][f"{dataset}_{name}"] = r
        del model, items
        torch.cuda.empty_cache()
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 21 serving [{card}] in {res['seconds']:.1f} s; launches: "
          f"{launches}")
    return res


def phase_late(card):
    """Phase 21 (b): ``inference --fusion_method late`` on the cut flagship
    (phase 5's seeded weights as a run dir's epoch 1) over LATE_SCENES
    synthetic scenes in ``auto`` and ``pallas``: a warm-up run of one scene
    (in ``pallas`` its kernel inputs held to their plain versions), then
    the counted run with its launches asserted."""
    import shutil

    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.tools import inference

    t_phase = time.perf_counter()
    work = scratch_dir("chip_smoke_late_")
    res = {"card": card, "kernel_checks": [], "launches": {}}
    try:
        hypes, run_dir = eval_run_dir(FLAGSHIP, os.path.join(work, "none"), work)
        convs = 2 * sum(hypes["model"]["args"]["modality_fusion"][
            "base_bev_backbone"]["layer_nums"])
        argv = ["--model_dir", run_dir, "--fusion_method", "late", "--seed", "21"]
        checked = set()
        for mode in ("auto", "pallas"):
            seen = {}
            with conv_mode(mode), (recorded_kernel_inputs(seen) if mode == "pallas"
                                   else contextlib.nullcontext()):
                inference.main(argv + ["--num_scenes", "1"])
            res["kernel_checks"] += check_kernel_inputs(
                f"phase 21 late {mode} [{card}]", seen, checked)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with conv_mode(mode):
                out = inference.main(argv + ["--num_scenes", str(LATE_SCENES)])
            torch.cuda.synchronize()
            got = dict(kernels.LAUNCHES)
            n = LATE_SCENES
            want = {"pillar_encode": 3 * n,
                    "conv3x3": convs * n if mode == "pallas" else 0}
            k2 = got.get("quad_iou", 0)
            if ({k: got.get(k, 0) for k in want} != want or not n <= k2 <= 2 * n
                    or got.get("pillar_reduce", 0)):
                raise AssertionError(f"phase 21 late {mode}: launches {got}, "
                                     f"expected {want} and K2 {n}-{2 * n}")
            for k, v in got.items():
                res["launches"][k] = res["launches"].get(k, 0) + v
            res[mode] = dict(ms=out["ms_per_scene"], launches=got,
                             ap={k: out[k] for k in ("ap_30", "ap_50", "ap_70")},
                             comm_rate=out["comm_rate"])
            print(f"phase 21 late fusion {mode} [{card}]: "
                  f"{out['ms_per_scene']:.3f} ms/scene (load + the "
                  f"{sum(NUM_AGENTS.values())} replicas' forward + decode + AP, "
                  f"host clock), AP "
                  f"{res[mode]['ap']}, launches {got} over {n} scenes")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    return res


def timed_steps(label, card, step, state, batches, steps):
    """A warm-up step per batch (at most two), then ``steps`` timed ones:
    ms/step, peak memory and every step's loss parts (all finite)."""
    for b in batches[:2]:
        step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, parts = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts.append({k: float(v) for k, v in
                      step(state, batches[i % len(batches)]).items()})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"{label} [{card}]: {statistics.median(ms):.3f} ms/step median of "
          f"{steps} ({[round(t, 3) for t in ms]}), peak memory {peak:.1f} MiB; "
          "loss parts per step: " + json.dumps(
              [{k: round(v, 5) for k, v in p.items()} for p in parts]))
    if not all(np.isfinite(v) for p in parts for v in p.values()):
        raise AssertionError(f"{label}: a non-finite loss part")
    return dict(ms_per_step=statistics.median(ms), ms_runs=ms, peak_mib=peak,
                parts=parts)


def phase_flat_rest_train(card, disk_roots):
    """Phase 21 (c): KD training through ``train_w_kd`` from a teacher run
    dir of the train CLI, and CoAlign training on the OPV2V split with its
    IoU term."""
    import shutil

    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.config import save_yaml
    from airv2x_tpu_torch.data.loader import RealDataLoader
    from airv2x_tpu_torch.data.opv2v_dataset import OPV2VDataset
    from airv2x_tpu_torch.loss import build_loss
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.models.registry import compute_dtype
    from airv2x_tpu_torch.ops.anchors import generate_anchor_grid
    from airv2x_tpu_torch.parallel.train import (
        TrainState, make_optimizer, make_train_step)
    from airv2x_tpu_torch.tools import train, train_w_kd
    from airv2x_tpu_torch.utils.weights import init_flax_like_

    t_phase = time.perf_counter()
    set_tf32(False)
    torch.backends.cudnn.benchmark = torch.backends.cudnn.deterministic = False
    res = {"card": card, "kernel_checks": []}
    work = scratch_dir("chip_smoke_kd_")
    try:
        t0 = time.perf_counter()
        paths = {}
        for name in ("disconet_teacher", "disconet"):
            hypes = disk_hypes("opv2v", name)
            if name == "disconet":  # the KD term applies (ROADMAP §3)
                hypes["loss"]["core_method"] = "point_pillar_disconet_loss"
            paths[name] = os.path.join(work, f"opv2v_{name}.yaml")
            save_yaml(hypes, paths[name])
        teacher_dir = train.main(["--hypes_yaml", paths["disconet_teacher"],
                                  "--epochs", "1", "--steps_per_epoch", "1",
                                  "--synthetic", "--log_dir", work])
        t1 = time.perf_counter()
        seen = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with recorded_kernel_inputs(seen):
            kd = train_w_kd.main(["--hypes_yaml", paths["disconet"],
                                  "--teacher_dir", teacher_dir, "--epochs", "1",
                                  "--steps_per_epoch", str(KD_STEPS),
                                  "--log_dir", work])
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**20
        res["kernel_checks"] += check_kernel_inputs(
            f"phase 21 train_w_kd teacher [{card}]", seen, set())
        kd_losses = [p["kd_loss"] for p in kd["parts"]]
        if (not all(np.isfinite(v) for p in kd["parts"] for v in p.values())
                or not min(kd_losses) > 0
                or launches.get("pillar_encode", 0) != KD_STEPS
                or launches.get("quad_iou", 0) or launches.get("conv3x3", 0)):
            raise AssertionError(f"phase 21 train_w_kd: parts {kd['parts']}, "
                                 f"launches {launches}")
        res["train_w_kd"] = dict(
            ms_per_step=statistics.median(kd["step_ms"]), ms_runs=kd["step_ms"],
            peak_mib=peak, parts=kd["parts"], launches=launches,
            teacher_cli_s=t1 - t0, seconds=time.perf_counter() - t1)
        res["launches"] = launches
        print(f"phase 21 train_w_kd [{card}]: teacher run dir by the train CLI "
              f"in {t1 - t0:.1f} s; {KD_STEPS} student steps of batch "
              f"{TRAIN_BATCH}: {[round(t, 3) for t in kd['step_ms']]} ms (the "
              f"first with the warm-up), peak {peak:.1f} MiB, kd_loss "
              f"{[round(v, 6) for v in kd_losses]}, total "
              f"{[round(p['total_loss'], 4) for p in kd['parts']]}; the "
              f"teacher's launches {launches}")

        t0 = time.perf_counter()
        hypes = disk_hypes("opv2v", "coalign")
        loader = RealDataLoader(OPV2VDataset(hypes, disk_roots["opv2v"],
                                             train=True, seed=0),
                                hypes, TRAIN_BATCH, seed=0, num_workers=2,
                                device="cuda")
        anchors = torch.from_numpy(generate_anchor_grid(
            hypes["postprocess"]["anchor_args"])).to("cuda")
        batches = []
        for b in loader.batches(0):
            b["labels"]["anchors"] = anchors  # the IoU term's (ROADMAP §3)
            batches.append(b)
        model = init_flax_like_(build_model(hypes, device="cuda", train=True),
                                seed=0)
        opt, sched = make_optimizer(hypes, model.parameters(), 50)
        step = make_train_step(build_loss(hypes), sched,
                               compute_dtype=compute_dtype(hypes), seed=0)
        kernels.reset_launch_counts()
        r = timed_steps("phase 21 opv2v_coalign training", card, step,
                        TrainState(model, opt), batches, COALIGN_STEPS)
        if any(kernels.LAUNCHES.values()) or not all(
                0 < p["iou_loss"] <= 1 for p in r["parts"]):
            raise AssertionError(f"phase 21 CoAlign training: {r['parts']}, "
                                 f"launches {kernels.LAUNCHES}")
        r["seconds"] = time.perf_counter() - t0
        res["coalign"] = r
        del model, batches
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 21 training [{card}] in {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 22: V2X-R (LiDAR, 4D radar and LiDAR + radar fusion)

V2XR_DIR = "hypes_yaml/V2X-R"
# the 27 YAMLs phase 22 serves (RTNH and MDD: phase 23)
V2XR_YAMLS = tuple(f"LiDAR/V2XR_{n}.yaml" for n in (
    "adafusion", "attfuse", "coalign", "cobevt", "scope", "sicp", "v2xvit",
    "where2comm")) + tuple(f"4DRadar/V2XR_{n}.yaml" for n in (
        "PFA_net", "adafusion", "attfuse", "coalign", "cobevt", "scope", "sicp",
        "v2xvit", "where2comm")) + tuple(f"L_4DR_Fusion/V2XR_{n}.yaml" for n in (
            "AdaFusion", "AttFuse", "CoAlign", "Cobevt", "InterFusion", "L4DR",
            "Scope", "Sicp", "V2XViT", "where2comm"))
# the new model classes, timed: (name, YAML, core_method in its place or
# None); AttResNet and SCOPE's LRF twin have no YAML of their own
V2XR_TIMED = (
    ("spatialcooper", "LiDAR/V2XR_adafusion.yaml", None),
    ("spatialcooper radar", "4DRadar/V2XR_adafusion.yaml", None),
    ("pfa_net", "4DRadar/V2XR_PFA_net.yaml", None),
    ("sicp", "LiDAR/V2XR_sicp.yaml", None),
    ("intermediate_lrf", "L_4DR_Fusion/V2XR_AttFuse.yaml", None),
    ("v2xvit_lrf", "L_4DR_Fusion/V2XR_V2XViT.yaml", None),
    ("cobevt_lrf", "L_4DR_Fusion/V2XR_Cobevt.yaml", None),
    ("where2comm_lrf", "L_4DR_Fusion/V2XR_where2comm.yaml", None),
    ("coalign_lrf", "L_4DR_Fusion/V2XR_CoAlign.yaml", None),
    ("spatialcooper_lrf", "L_4DR_Fusion/V2XR_AdaFusion.yaml", None),
    ("sicp_lrf", "L_4DR_Fusion/V2XR_Sicp.yaml", None),
    ("scope_lrf", "L_4DR_Fusion/V2XR_Scope.yaml", "point_pillar_scope_lrf"),
    ("l4dr", "L_4DR_Fusion/V2XR_L4DR.yaml", None),
    ("interf", "L_4DR_Fusion/V2XR_InterFusion.yaml", None),
    ("attresnet", "LiDAR/V2XR_coalign.yaml", "point_pillar_attresnet"))
V2XR_TRAIN = ("L_4DR_Fusion/V2XR_L4DR.yaml", "L_4DR_Fusion/V2XR_AttFuse.yaml")
V2XR_RADAR_EVERY = 16  # the radar cloud: every 16th LiDAR point (~3,100)
V2XR_RADAR_NOISE = 0.15  # m, on x, y and z
V2XR_WEATHER_NOISE = 0.1  # the share of each LiDAR cloud labelled weather noise
# InterF's pillar cap per agent, cut from its YAML's 32,000: its attention
# energy is (B, 32, N, N) with N = 5 agents x the cap (ROADMAP §3); at 4,000
# one point slot's (1, N, N) is 0.8 GB in bf16
INTERF_VOXELS = 4000


def write_v2xr_split(root, rng):
    """A V2X-R split: phase 18's OPV2V split (``write_opv2v_split``) plus a
    ``<stamp>_radar.pcd`` per cav and stamp, every V2XR_RADAR_EVERY-th
    point of its LiDAR cloud jittered by N(0, V2XR_RADAR_NOISE) m; each
    LiDAR cloud rewritten with V2X-R's weather label, V2XR_WEATHER_NOISE of
    its points marked noise (MDD's clean-point mask: phase 23)."""
    from airv2x_tpu_torch.data.pcd import read_pcd, write_pcd

    write_opv2v_split(root, rng)
    scen = os.path.join(root, DISK_SCENARIO)
    for cav in sorted(os.listdir(scen)):
        for t in range(DISK_STAMPS):
            path = os.path.join(scen, cav, f"{t:06d}.pcd")
            pts = read_pcd(path)
            radar = pts[::V2XR_RADAR_EVERY].copy()
            radar[:, :3] += rng.normal(0, V2XR_RADAR_NOISE, (len(radar), 3))
            write_pcd(os.path.join(scen, cav, f"{t:06d}_radar.pcd"), radar)
            write_pcd(path, pts, label=(rng.uniform(size=len(pts))
                                        < V2XR_WEATHER_NOISE).astype(np.float32))


def v2xr_hypes(path, core=None):
    """A V2X-R YAML as ``disk_hypes`` reads an OPV2V one (bf16; SCOPE's
    ``fusion_args.frame`` as ``num_sweep_frames``), ``core`` in place of
    its model's core_method, InterF's pillar cap cut to INTERF_VOXELS."""
    from airv2x_tpu_torch.config import load_yaml

    hypes = load_yaml(os.path.join(REPO, V2XR_DIR, path))
    args = hypes["model"]["args"]
    args["dtype"] = "bf16"
    fa = args.get("fusion_args")
    if fa and "frame" in fa:
        hypes.setdefault("fusion", {}).setdefault("args", {})[
            "num_sweep_frames"] = int(fa["frame"])
    if core:
        hypes["model"]["core_method"] = core
    if "interf" in hypes["model"]["core_method"]:
        hypes["preprocess"]["args"]["max_voxel_train"] = INTERF_VOXELS
    return hypes


def v2xr_per_scene(hypes):
    """(K1, K4a in ``pallas``) launches per scene, from the code: a K1 per
    frame for each ``FastPillarBEV`` the model calls (the ``_lrf`` twins'
    LiDAR and radar; L4DR's LiDAR only, its radar on the classic path;
    none for InterF, whose attention reads the pillars' points); K4a the
    plain backbone's stride-1 ConvBNReLUs, three stacks in L4DR's MGF."""
    from airv2x_tpu_torch.data.opv2v_dataset import temporal_frames

    core = hypes["model"]["core_method"].lower()
    clouds = 0 if "interf" in core else 2 if "lrf" in core else 1
    return (clouds * temporal_frames(hypes),
            disk_convs(hypes) * (3 if "l4dr" in core else 1))


def radar_over_frames(items):
    """Loaded temporal batches with the current frame's radar cloud (the
    dataset reads no other) repeated on a time axis after the batch axis,
    where SCOPE's LRF twin takes frame i's as ``radar_points[:, i]``."""
    out = []
    for batch, quads in items:
        t = batch["points"].shape[1]
        batch = dict(batch)
        for k in ("radar_points", "radar_points_mask"):
            v = batch[k][:, None]
            batch[k] = v.expand((v.shape[0], t) + v.shape[2:]).contiguous()
        out.append((batch, quads))
    return out


def v2xr_once(label, card, hypes, item, checked):
    """One loaded scene through the whole config in ``pallas`` (bf16,
    random weights): its launches asserted (``v2xr_per_scene``, K2 for the
    NMS and the AP), finite psm / rm, and every kernel input held to its
    plain version (L4DR's every conv call: its three stacks give inputs of
    equal shapes)."""
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.eval.ap import new_result_stat

    model = disk_model(hypes)
    run = disk_step(hypes, model, new_result_stat())
    seen = {}
    every = "l4dr" in hypes["model"]["core_method"]
    kernels.reset_launch_counts()
    with conv_mode("pallas"), recorded_kernel_inputs(seen, every=every):
        out, kept, ap = run(item, no_mark)
    torch.cuda.synchronize()
    got = dict(kernels.LAUNCHES)
    k1, k4 = v2xr_per_scene(hypes)
    want = {"pillar_encode": k1, "conv3x3": k4, "quad_iou": 1 + int(ap)}
    finite = all(bool(torch.isfinite(out[k]).all()) for k in ("psm", "rm"))
    if {k: got.get(k, 0) for k in want} != want or not finite:
        raise AssertionError(f"{label}: launches {got}, expected {want}, "
                             f"finite {finite}")
    rows = check_kernel_inputs(f"{label} [{card}]", seen, checked)
    print(f"{label} [{card}]: one loaded scene in pallas, {kept} kept, "
          f"launches {want}, {len(rows)} kernel inputs held to the plain "
          "versions")
    del model
    return got, rows


def phase_v2xr(card, work):
    """Phase 22 (a) and (b): a V2X-R split (``write_v2xr_split``) under
    ``work``; every V2XR_YAMLS config whole at full width (5 vehicles,
    704 x 200, a 60,000-point LiDAR and a 15,000-point radar buffer per
    agent), bf16, batch 1, random weights: the V2XR_TIMED classes on every
    loaded scene as phase 18 runs its configs (``time_disk``: both modes,
    every ``pallas`` kernel input held to the plain versions, a one-scene
    profile window), the others once (``v2xr_once``)."""
    from airv2x_tpu_torch.eval.ap import eval_final_results, new_result_stat

    t_phase = time.perf_counter()
    set_tf32(False)
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32 = True  # PyTorch's defaults for bf16
    cudnn.benchmark, cudnn.deterministic = False, False  # heuristics
    root = os.path.join(work, "v2xr")
    t0 = time.perf_counter()
    write_v2xr_split(root, np.random.default_rng(22))
    res = {"card": card, "split_s": time.perf_counter() - t0, "configs": {},
           "once": {}, "kernel_checks": [], "interf_voxels": INTERF_VOXELS}
    print(f"phase 22 [{card}]: V2X-R split ({len(DISK_CAVS)} cavs x "
          f"{DISK_STAMPS} stamps, {DISK_POINTS} LiDAR points and every "
          f"{V2XR_RADAR_EVERY}th as radar per cloud) written in "
          f"{res['split_s']:.2f} s; InterF's pillar cap cut to "
          f"{INTERF_VOXELS} per agent (its YAML: 32000)")
    launches = {}
    timed_paths = {p for _, p, core in V2XR_TIMED if core is None}
    for path in V2XR_YAMLS:
        if path in timed_paths:
            continue
        hypes = v2xr_hypes(path)
        item = disk_items(hypes, "opv2v", root, use_radar=True, limit=1)[0]
        got, rows = v2xr_once(f"phase 22 {path}", card, hypes, item, set())
        res["once"][path] = got
        res["kernel_checks"] += rows
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
    for name, path, core in V2XR_TIMED:
        t_cfg = time.perf_counter()
        hypes = v2xr_hypes(path, core)
        label = f"phase 22 {name} ({path})"
        items = disk_items(hypes, "opv2v", root, use_radar=True)
        if name == "scope_lrf":
            items = radar_over_frames(items)
        r = {"yaml": path, "core_method": hypes["model"]["core_method"],
             "radar_points": [int(b["radar_points_mask"].sum()) for b, _ in items]}
        model = disk_model(hypes)
        checked = set()
        for mode in ("auto", "pallas"):
            stat = new_result_stat()
            with conv_mode(mode):
                r[mode] = time_disk(f"{label} {mode} [{card}]",
                                    disk_step(hypes, model, stat), items, hypes,
                                    mode, checked if mode == "pallas" else None,
                                    per_scene=v2xr_per_scene(hypes))
            res["kernel_checks"] += r[mode].pop("kernel_checks")
            r[mode]["ap"] = eval_final_results(stat)
            for k, v in r[mode]["launches"].items():
                launches[k] = launches.get(k, 0) + v
        with conv_mode("pallas"):
            r["profile"] = phase_profile(
                f"{label} pallas [{card}]", disk_step(hypes, model,
                                                      new_result_stat()),
                items, top=6, n=PROFILED_SCENES)
        prof = r["profile"] or {}
        r["seconds"] = time.perf_counter() - t_cfg
        print(f"{label} [{card}]: ms/scene auto {r['auto']['ms']:.3f}, pallas "
              f"{r['pallas']['ms']:.3f}; busy "
              f"{prof.get('busy_ms', float('nan')):.3f} ms/scene, idle "
              f"{prof.get('idle_share', float('nan')):.3f} (pallas); peak "
              f"{max(r[m]['peak_mib'] for m in ('auto', 'pallas')):.1f} MiB; "
              f"launches per scene {r['pallas']['launches_per_scene']}; radar "
              f"points {r['radar_points']}; kept {r['pallas']['kept']}; "
              f"{r['seconds']:.1f} s")
        res["configs"][name] = r
        del model, items
        torch.cuda.empty_cache()
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 22 serving [{card}] in {res['seconds']:.1f} s; launches: "
          f"{launches}")
    return res


def phase_v2xr_train(card, work):
    """Phase 22 (c): V2XR_TRAIN (L4DR, the LiDAR + radar AttFusion twin)
    trained at full width on phase 22's split, batch 2 through
    ``RealDataLoader`` with the radar clouds, as phase 21 trains
    (``phase_train``: 2 warm-up steps, TRAIN_MODEL_STEPS timed, no profile
    window, the repeated-batch check; no kernel launches in training)."""
    from airv2x_tpu_torch.data.loader import RealDataLoader
    from airv2x_tpu_torch.data.opv2v_dataset import OPV2VDataset
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_flax_like_

    t_phase = time.perf_counter()
    root = os.path.join(work, "v2xr")
    res = {"card": card, "configs": {}}
    for path in V2XR_TRAIN:
        t0 = time.perf_counter()
        hypes = v2xr_hypes(path)
        assert int(hypes["train_params"]["batch_size"]) == TRAIN_BATCH
        loader = RealDataLoader(OPV2VDataset(hypes, root, train=True, seed=0,
                                             use_radar=True),
                                hypes, TRAIN_BATCH, seed=0, num_workers=2,
                                device="cuda")
        batches = list(loader.batches(0))
        model = init_flax_like_(build_model(hypes, device="cuda", train=True),
                                seed=0)
        t1 = time.perf_counter()
        r = phase_train(f"phase 22 {path} training", card, hypes, model, batches,
                        steps=TRAIN_MODEL_STEPS, repeats=TRAIN_MODEL_REPEATS,
                        autotune=False, profiled=0)
        r.pop("losses")
        r["setup_s"], r["seconds"] = t1 - t0, time.perf_counter() - t0
        print(f"phase 22 {path} [{card}]: trained in {r['seconds']:.1f} s "
              f"(loader and model {r['setup_s']:.1f})")
        res["configs"][path] = r
        del model, batches
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 22 training [{card}] in {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 23: V2X-R finished (RTNH, MDD) and HEAL's AlignNet

RTNH_MDD = (("rtnh", "4DRadar/V2XR_RTNH.yaml"),
           ("mdd", "L_4DR_Fusion_with_MDD/V2XR_AttFuse.yaml"))
RTNH_MDD_SCENES = 2  # loaded scenes of phase 22's split timed per config
# AlignNet's methods with the args the tiny models take (the card's tiny
# HEAL and tests/test_torch_alignnet.py)
ALIGNNET_METHODS = {
    "identity": {}, "scaligner": {"num_of_blocks": 2, "num_of_layers": 2},
    "resnet1x1": {"num_of_blocks": 1},
    "resnet3x3": {"num_of_blocks": 1, "deform": True},
    "cbam": {"num_of_blocks": 2}, "convnext": {"num_of_blocks": 2},
    "sdta": {"num_of_blocks": 2}}
# the full-width HEAL copies: no shipped YAML sets an alignnet key
HEAL_ALIGNNET = (("resnet3x3_deform", {"core_method": "resnet3x3", "args": {
    "num_of_blocks": 1, "deform": True}}),
                 ("sdta", {"core_method": "sdta", "args": {"num_of_blocks": 1}}))
HEAL_LIDAR = ("lidar", "det", "airv2x_heal/collab")
# the tiny AlignNet models' init_random_ seed: the first from TINY_HETERO_SEED
# (14) up whose every NMS decision on the CPU lies more than 10 x ROI_MARGIN
# from the threshold for all seven methods (seed 14's: 3.4e-4)
TINY_ALIGNNET_SEED = 19


def alignnet_hypes(hypes, cfg):
    """A copy of ``hypes`` with ``cfg`` under the model args' alignnet key."""
    import copy

    hypes = copy.deepcopy(hypes)
    hypes["model"]["args"]["alignnet"] = copy.deepcopy(cfg)
    return hypes


def mdd_k4a(hypes):
    """K4a launches per MDD scene in ``pallas``: the stride-1 ConvBNReLUs of
    each backbone stage whose NHWC input the support gate admits in bf16
    (``ops/conv3x3.py:supports_conv3x3``), printed with each stage's
    estimate of the grid form's block against the gate's budget."""
    from airv2x_tpu_torch.ops import conv3x3 as k4
    from airv2x_tpu_torch.ops.voxelize import pillar_kwargs

    nx, ny, _ = pillar_kwargs(hypes["preprocess"])["grid_size"]
    bb = hypes["model"]["args"]["base_bev_backbone"]
    maps = int(hypes["train_params"]["max_cav"])
    count, h, w = 0, ny, nx
    for n, stride, c in zip(bb["layer_nums"], bb["layer_strides"],
                            bb["num_filters"]):
        h, w = h // int(stride), w // int(stride)
        shape = (maps, h, w, c)
        est = k4.grid_block_bytes(shape, torch.bfloat16, c)
        ok = k4.supports_conv3x3(shape, torch.bfloat16, c)
        print(f"MDD backbone stage at {shape} bf16: the grid "
              f"form's blocks {est / 1e6:.1f} MB of the gate's "
              f"{k4.VMEM_BUDGET / 1e6:.1f} MB: admitted {ok}")
        count += int(n) if ok else 0
    return count


def phase_rtnh_mdd(card, work):
    """Phase 23 (a): RTNH and MDD whole at full width on phase 22's V2X-R
    split (5 vehicles, RTNH's 8 x 200 x 704 radar grid, MDD's 704 x 200
    pillars with its radar-conditioned chain of 3 UNet passes), bf16, batch
    1, random weights (RTNH's BatchNorm statistics from one scene), the
    radar read (``use_radar``), RTNH_MDD_SCENES loaded scenes in ``auto`` and
    ``pallas`` (``time_disk``: launches asserted per scene, RTNH K1 0 / K4a
    0 / K2 1 + the AP's, MDD K1 2 / K4a ``mdd_k4a`` / K2 1 + the AP's; every
    ``pallas`` kernel input held to its plain version, K2 on RTNH's boxes
    and K4a at MDD's 512-wide stage among them), a one-scene profile."""
    from airv2x_tpu_torch.eval.ap import eval_final_results, new_result_stat

    t_phase = time.perf_counter()
    set_tf32(False)
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32 = True  # PyTorch's defaults for bf16
    cudnn.benchmark, cudnn.deterministic = False, False
    root = os.path.join(work, "v2xr")
    res = {"card": card, "configs": {}, "kernel_checks": []}
    launches = {}
    for name, path in RTNH_MDD:
        t0 = time.perf_counter()
        hypes = v2xr_hypes(path)
        items = disk_items(hypes, "opv2v", root, use_radar=True,
                           limit=RTNH_MDD_SCENES)
        if name == "rtnh":
            per_scene = (0, 0)
            model = disk_model(hypes, calibrate_on=items[0][0])
        else:
            per_scene = (2, mdd_k4a(hypes))
            if per_scene[1] != disk_convs(hypes):
                raise AssertionError(f"MDD: the gate admits {per_scene[1]} of "
                                     f"{disk_convs(hypes)} convs (pallas raises)")
            model = disk_model(hypes)
        label = f"phase 23 {name} ({path})"
        r = {"yaml": path, "radar_points": [int(b["radar_points_mask"].sum())
                                            for b, _ in items]}
        checked = set()
        for mode in ("auto", "pallas"):
            stat = new_result_stat()
            with conv_mode(mode):
                r[mode] = time_disk(f"{label} {mode} [{card}]",
                                    disk_step(hypes, model, stat), items, hypes,
                                    mode, checked if mode == "pallas" else None,
                                    per_scene=per_scene)
            res["kernel_checks"] += r[mode].pop("kernel_checks")
            r[mode]["ap"] = eval_final_results(stat)
            for k, v in r[mode]["launches"].items():
                launches[k] = launches.get(k, 0) + v
        with conv_mode("pallas"):
            r["profile"] = phase_profile(
                f"{label} pallas [{card}]", disk_step(hypes, model,
                                                      new_result_stat()),
                items, top=6, n=PROFILED_SCENES)
        prof = r["profile"] or {}
        r["seconds"] = time.perf_counter() - t0
        print(f"{label} [{card}]: ms/scene auto {r['auto']['ms']:.3f}, pallas "
              f"{r['pallas']['ms']:.3f}; busy "
              f"{prof.get('busy_ms', float('nan')):.3f} ms/scene, idle "
              f"{prof.get('idle_share', float('nan')):.3f} (pallas); peak "
              f"{max(r[m]['peak_mib'] for m in ('auto', 'pallas')):.1f} MiB; "
              f"launches per scene {r['pallas']['launches_per_scene']}; radar "
              f"points {r['radar_points']}; kept {r['pallas']['kept']}; "
              f"{r['seconds']:.1f} s")
        res["configs"][name] = r
        del model, items
        torch.cuda.empty_cache()
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    return res


def nms_decision_margin(det, hypes, top_k):
    """The smallest distance from the NMS threshold of any NMS decision of
    a decode (on the CPU, plain IoU): each candidate's largest IoU with a
    kept candidate ranked above it decides whether it is suppressed, so IoUs
    that move by less than this leave the keep set as it is (with many
    candidates, some pair that decides nothing lies near the threshold)."""
    from airv2x_tpu_torch.ops import geometry as geo
    from airv2x_tpu_torch.ops.nms import rotated_nms
    from airv2x_tpu_torch.ops.quad_iou import quad_iou_plain

    lr, thr = hypes["preprocess"]["cav_lidar_range"], hypes["postprocess"]["nms_thresh"]
    corners, scores = det.corners.float().cpu(), det.scores.float().cpu()
    valid = (scores > 0) & geo.keep_reasonable_boxes(corners, z_min=float(lr[2]),
                                                      z_max=float(lr[5]))
    quads = corners[:, :4, :2].contiguous()
    keep, _ = rotated_nms(quads, scores, valid, thr, top_k=top_k)
    idx = torch.nonzero(valid).flatten()  # the pool is in score order
    if len(idx) < 2:
        return 1.0
    iou = quad_iou_plain(quads[idx], quads[idx]).triu(1) * keep[idx][:, None]
    return float((iou[:, 1:].amax(0) - thr).abs().min())


def phase_tiny_alignnet(card, device="cuda"):
    """Phase 23 (b): the tiny HEAL (TINY_HETERO) with each ALIGNNET_METHODS
    AlignNet, ``init_random_`` weights (TINY_ALIGNNET_SEED; the deformable
    convs' offsets random, so their taps move off the grid), on phase 4f's
    scene on ``device`` against the CPU, f32, TF32 off, pinned cuDNN:
    psm / rm / obj within TINY_TOL x (1 + scale), equal keep sets, K1 3 /
    K4a 0 / K2 1 launches asserted, every NMS decision's margin bounded
    (``nms_decision_margin``).
    ``phase_tiny_alignnet("cpu", device="cpu")`` runs it on the CPU."""
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import batch_to_torch
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    set_tf32(False)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    base = load_yaml(TINY)
    scene = tiny_family_scene(base)
    devices = ("cpu", device)
    batch = {d: batch_to_torch(scene, d) for d in devices}
    out = {}
    try:
        for method, args in ALIGNNET_METHODS.items():
            hypes = alignnet_hypes(tiny_hetero_hypes(base, "airv2x_heal"),
                                   {"core_method": method, "args": args})
            res = {}
            for d in dict.fromkeys(devices):
                model = init_random_(build_model(hypes, device=d),
                                     seed=TINY_ALIGNNET_SEED)
                decode, _ = det_decoder(hypes, d, TINY_SCOPE_TOP_K)
                kernels.reset_launch_counts()
                with torch.inference_mode():
                    o = model(batch[d])
                    dets = decode(o)
                res[d] = (o, dets, dict(kernels.LAUNCHES))
            want = ({"pillar_encode": 3, "quad_iou": 1} if device == "cuda"
                    else {})
            n = {k: v for k, v in res[device][2].items() if v}
            margin = nms_decision_margin(res["cpu"][1], hypes, TINY_SCOPE_TOP_K)
            label = (f"phase 23 tiny HEAL + AlignNet {method} [{card}] ({n}; NMS "
                     f"margin {margin:.3e}, limit {ROI_MARGIN})")
            errs = compare(label, res[device][0], res["cpu"][0],
                           ("psm", "rm", "obj", "comm_rate"))
            same = bool(torch.equal(res[device][1].mask.cpu(), res["cpu"][1].mask))
            kept = int(res["cpu"][1].mask.sum())
            print(f"{label}: keep sets equal {same}, {kept} kept")
            if n != want or not same or not kept or margin <= ROI_MARGIN:
                raise AssertionError(f"{label}: launches {n} (want {want}), keep "
                                     f"sets equal {same}, {kept} kept")
            out[method] = {"kept": kept, "nms_margin": margin,
                           "max_abs_err": errs}
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    return out


def phase_alignnet(card):
    """Phase 23 (c): HEAL's LiDAR det YAML (cut as phase 5) with each
    HEAL_ALIGNNET AlignNet at full width (64 channels at 100 x 352 over 6
    agents), bf16, random weights with phase 19's BatchNorm calibration, on
    phase 19's perturbed LiDAR scenes in ``auto`` and ``pallas``
    (``time_path``: K1 3 / K4a 0 / K2 1 per scene asserted, the ``pallas``
    warm-up's kernel inputs held to their plain versions), a one-scene
    profile, the kept detections checked."""
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.models.base import SlotLayout
    from airv2x_tpu_torch.utils.weights import cast_weights_, init_random_

    t_phase = time.perf_counter()
    base = hetero_hypes(*HEAL_LIDAR)
    lidar = hetero_scenes(base, SlotLayout.from_args(base["model"]["args"]))
    res = {"card": card, "configs": {}, "kernel_checks": []}
    checked, launches = set(), {}
    want = {"pillar_encode": 3, "quad_iou": 1, "conv3x3": 0}
    for name, cfg in HEAL_ALIGNNET:
        t0 = time.perf_counter()
        h = alignnet_hypes(base, cfg)
        model = init_random_(build_model(h, device="cuda"), seed=0, device="cuda")
        calibrate_bn_(model, lidar[0])
        cast_weights_(model, torch.bfloat16)
        run = camera_step(h, model)
        label = f"phase 23 HEAL + AlignNet {name}"
        r = {}
        for mode in ("auto", "pallas"):
            with conv_mode(mode):
                if mode == "pallas":
                    seen = {}
                    with recorded_kernel_inputs(seen):
                        for b in lidar:
                            run(b, no_mark)
                    res["kernel_checks"] += check_kernel_inputs(
                        f"{label} [{card}]", seen, checked)
                r[mode] = time_path(f"{label} {mode} [{card}]", run, lidar, want,
                                    runs=HETERO_RUNS)
            r[mode]["launches_per_scene"] = want
            r[mode]["kept"] = check_det(f"{label} {mode}", r[mode].pop("results"),
                                        det_decoder(h)[1])
            for k, v in r[mode]["launches"].items():
                launches[k] = launches.get(k, 0) + v
        with conv_mode("pallas"):
            r["profile"] = phase_profile(f"{label} pallas [{card}]", run, lidar,
                                         top=6, n=PROFILED_SCENES)
        prof = r["profile"] or {}
        r["seconds"] = time.perf_counter() - t0
        print(f"{label} [{card}]: ms/scene auto {r['auto']['ms']:.3f}, pallas "
              f"{r['pallas']['ms']:.3f}; busy "
              f"{prof.get('busy_ms', float('nan')):.3f} ms/scene, idle "
              f"{prof.get('idle_share', float('nan')):.3f} (pallas); peak "
              f"{max(r[m]['peak_mib'] for m in ('auto', 'pallas')):.1f} MiB; "
              f"launches per scene {want}; {r['seconds']:.1f} s")
        res["configs"][name] = r
        del model, run
        torch.cuda.empty_cache()
    del lidar
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    return res


def phase_rtnh_mdd_train(card, work):
    """Phase 23 (d): RTNH and MDD trained at full width on phase 22's split,
    batch 2 through ``RealDataLoader`` with the radar clouds, every batch's
    labels carrying ``epoch`` 1 as the train CLI sets it; MDD's batches
    carry the clean-point mask (``de_points_mask``, the LiDAR points whose
    weather label is 0: V2XR_WEATHER_NOISE of them are not) and its loss
    the ``diff_loss`` term. As phase 22 trains (``phase_train``: 2 warm-up
    steps, TRAIN_MODEL_STEPS timed, the repeated-batch check; no kernel
    launches in training)."""
    from airv2x_tpu_torch.data.loader import RealDataLoader
    from airv2x_tpu_torch.data.opv2v_dataset import OPV2VDataset
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_flax_like_

    t_phase = time.perf_counter()
    root = os.path.join(work, "v2xr")
    res = {"card": card, "configs": {}}
    for name, path in RTNH_MDD:
        t0 = time.perf_counter()
        hypes = v2xr_hypes(path)
        assert int(hypes["train_params"]["batch_size"]) == TRAIN_BATCH
        loader = RealDataLoader(OPV2VDataset(hypes, root, train=True, seed=0,
                                             use_radar=True),
                                hypes, TRAIN_BATCH, seed=0, num_workers=2,
                                device="cuda")
        batches = list(loader.batches(0))
        for b in batches:
            b["labels"]["epoch"] = 1.0
        r = {}
        if name == "mdd":
            r["clean_share"] = [float(b["de_points_mask"].sum()
                                      / b["points_mask"].sum()) for b in batches]
            if not all(0.85 < v < 0.95 for v in r["clean_share"]):
                raise AssertionError(f"MDD's clean-point share {r['clean_share']}")
        model = init_flax_like_(build_model(hypes, device="cuda", train=True),
                                seed=0)
        t1 = time.perf_counter()
        r.update(phase_train(f"phase 23 {path} training", card, hypes, model,
                             batches, steps=TRAIN_MODEL_STEPS,
                             repeats=TRAIN_MODEL_REPEATS, autotune=False,
                             profiled=0))
        losses = r.pop("losses")
        if name == "mdd" and not all(p["diff_loss"] > 0 for p in losses):
            raise AssertionError(f"MDD training without its diff_loss: {losses}")
        r["setup_s"], r["seconds"] = t1 - t0, time.perf_counter() - t0
        print(f"phase 23 {path} [{card}]: trained in {r['seconds']:.1f} s "
              f"(loader and model {r['setup_s']:.1f})" + (
                  f"; clean-point share {r['clean_share']}" if name == "mdd"
                  else ""))
        res["configs"][name] = r
        del model, batches
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    return res


def k4_row(name, launches, k4, form):
    """The kernels-line row of K4a (``form`` "a") or K4b ("b"): per scene
    of 32 launches, bf16 as the main path runs it, and f32 beside it."""
    def numbers(r):
        return {"max_abs_err": r[f"err_{form}"], "ms": r[f"ms_{form}"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": ("operations" if r["ops_ms"] >= r["bytes_ms"]
                             else "bytes"),
                "library_ms": r["lib_ms"]}

    row = {"name": name, "route": "cuda",
           "source": "airv2x_tpu_torch/csrc/conv3x3.cu",
           "replaces": ("airv2x_tpu/ops/pallas_conv.py:99" if form == "a"
                        else "airv2x_tpu/ops/pallas_conv.py:113"),
           "launches": launches}
    row.update(numbers(k4["bf16"]))
    row["max_abs_err"] = k4["f32"][f"err_{form}"]  # f32: no bf16 rounding
    row["f32"] = numbers(k4["f32"])
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import shutil

    from airv2x_tpu_torch.utils.weights import cast_weights_

    t_start = time.perf_counter()
    marks = {}

    def mark(name, since):
        marks[name] = time.perf_counter() - since
        return time.perf_counter()

    phase_build()
    hypes, model, scenes, gts = flagship_setup()
    layer_nums = hypes["model"]["args"]["modality_fusion"][
        "base_bev_backbone"]["layer_nums"]
    # every stride-1 ConvBNReLU runs once in single_psm and once in the fusion
    per_stage = tuple(2 * n for n in layer_nums)
    convs = sum(per_stage)
    assert convs == 32, layer_nums
    k1 = phase_k1(model, scenes[0])
    k2 = phase_k2(hypes, gts)
    k3 = phase_k3()
    k4 = phase_k4(per_stage)
    t0 = mark("phases 1-3b (build, kernels)", t_start)
    phase_tiny()
    phase_tiny_camera()
    phase_tiny_v2xvit()
    tiny_scope = phase_tiny_scope()
    tiny_family = phase_tiny_family()
    t0 = mark("phases 4, 4c-4f (tiny)", t0)
    n_f32 = phase_f32_pallas(model, scenes[0])
    if n_f32 != convs:
        raise AssertionError(f"f32 pallas scene ran {n_f32} conv3x3 launches")
    cast_weights_(model, torch.bfloat16)  # BatchNorm2d stays f32
    det, run = phase_flagship(hypes, model, scenes, convs)
    with conv_mode("auto"):
        k2_scene = phase_k2_scene(run, scenes[0])
    with conv_mode("auto"):
        phase_profile("phase 6 flagship auto", run, scenes, n=PROFILED_SCENES)
    with conv_mode("pallas"):
        phase_profile("phase 6 flagship pallas", run, scenes, top=10,
                      n=PROFILED_SCENES)
    seg = phase_seg(scenes, convs)
    t0 = mark("phases 4a, 5-7", t0)
    del model, scenes
    torch.cuda.empty_cache()
    card = smi("name,power.limit")
    cam, cam_flops = phase_camera(card, convs)
    print(json.dumps({"camera": {"card": card, **cam_flops, **{
        mode: {k: v for k, v in r.items() if k != "launches"}
        for mode, r in cam.items()}}}))
    for res in (det, seg):  # checked outputs: off the card before phase 11
        for r in res.values():
            r.pop("results", None)
    torch.cuda.empty_cache()
    t0 = mark("phase 10", t0)
    v2x = phase_v2xvit(card)
    print(json.dumps({"v2xvit": {
        k: ({mode: {kk: vv for kk, vv in r.items() if kk != "launches"}
             for mode, r in v.items()} if k in ("det", "seg") else v)
        for k, v in v2x.items()}}))
    t0 = mark("phase 11", t0)
    scope = phase_scope(card)
    print(json.dumps({"scope": dict(
        {k: ({kk: vv for kk, vv in v.items() if kk != "launches"}
             if k in ("auto", "pallas") else v) for k, v in scope.items()},
        tiny_card_vs_cpu=tiny_scope)}))
    t0 = mark("phase 12", t0)
    family = phase_family(card)
    t0 = mark("phase 15", t0)
    ev = phase_eval(card)
    gate = phase_ap_gate(card)
    mark("phases 13-14", t0)
    print(json.dumps({"eval": {"card": card, **{k: v for k, v in ev.items()
                                               if k != "launches"},
                               "ap_gate": gate}}))
    cam_work = scratch_dir("chip_smoke_camera_")  # phase 20 reads it again
    cam_disk = phase_camera_disk(card, cam_work)
    marks["phase 16"] = cam_disk["seconds"]
    t0 = time.perf_counter()
    tiny_hetero = phase_tiny_hetero(card)
    hetero = phase_hetero(card, cam_disk.pop("scenes"))
    torch.cuda.empty_cache()
    marks["phase 19 tiny and serving"] = time.perf_counter() - t0
    print(json.dumps({"hetero": dict(
        {k: ({name: {m: ({kk: vv for kk, vv in r.items() if kk != "launches"}
                         if m in ("auto", "pallas") else r) for m, r in c.items()}
              for name, c in v.items()} if k == "configs" else v)
         for k, v in hetero.items()}, tiny_card_vs_cpu=tiny_hetero)}))
    print(json.dumps({"camera_disk": {
        k: ({mode: ({kk: vv for kk, vv in r.items() if kk != "launches"}
                    if isinstance(r, dict) else r) for mode, r in v.items()}
            if "/" in k and not k.startswith("cli") else v)
        for k, v in cam_disk.items()}}))
    disk_work = scratch_dir("chip_smoke_disk_")
    try:
        t0 = time.perf_counter()
        disk = phase_disk(card, disk_work)
        marks["phase 18 serving"] = time.perf_counter() - t0
        print(json.dumps({"disk": {k: ({name: {m: ({kk: vv for kk, vv in r.items()
                                                    if kk != "launches"}
                                                   if m in ("auto", "pallas")
                                                   else r) for m, r in c.items()}
                                        for name, c in v.items()}
                                       if k == "configs" else v)
                                   for k, v in disk.items()}}))
        t0 = time.perf_counter()
        tiny_eb = phase_tiny_early_bm2cp(card)
        eb = phase_early_bm2cp(card, os.path.join(cam_work, "test"), {
            d: os.path.join(disk_work, d) for d in ("opv2v", "dair")})
        marks["phase 20 tiny and serving"] = time.perf_counter() - t0
        print(json.dumps({"early_bm2cp": dict(
            {k: ({name: {m: ({kk: vv for kk, vv in r.items() if kk != "launches"}
                             if m in ("auto", "pallas") else r)
                         for m, r in c.items()} for name, c in v.items()}
                 if k == "configs" else v) for k, v in eb.items()},
            tiny_card_vs_cpu=tiny_eb)}))
        t0 = time.perf_counter()
        tiny_flat_rest = phase_tiny_flat_rest(card)
        flat_rest = phase_flat_rest(card, {d: os.path.join(disk_work, d)
                                           for d in ("opv2v", "dair")})
        late = phase_late(card)
        marks["phase 21 serving and late"] = time.perf_counter() - t0
        print(json.dumps({"flat_rest": dict(
            {k: ({name: {m: ({kk: vv for kk, vv in r.items() if kk != "launches"}
                             if m in ("auto", "pallas") else r)
                         for m, r in c.items()} for name, c in v.items()}
                 if k == "configs" else v) for k, v in flat_rest.items()},
            late=late, tiny_card_vs_cpu=tiny_flat_rest)}))
        t0 = time.perf_counter()
        v2xr = phase_v2xr(card, disk_work)
        marks["phase 22 serving"] = time.perf_counter() - t0
        print(json.dumps({"v2xr": dict(
            {k: ({name: {m: ({kk: vv for kk, vv in r.items() if kk != "launches"}
                             if m in ("auto", "pallas") else r)
                         for m, r in c.items()} for name, c in v.items()}
                 if k == "configs" else v) for k, v in v2xr.items()})}))
        t0 = time.perf_counter()
        tiny_align = phase_tiny_alignnet(card)
        rtnh_mdd = phase_rtnh_mdd(card, disk_work)
        align = phase_alignnet(card)
        marks["phase 23 serving"] = time.perf_counter() - t0
        print(json.dumps({"rtnh_mdd_alignnet": {
            "tiny_alignnet_card_vs_cpu": tiny_align, **{
                part: dict({k: ({name: {m: ({kk: vv for kk, vv in r.items()
                                             if kk != "launches"}
                                            if m in ("auto", "pallas") else r)
                                        for m, r in c.items()}
                                 for name, c in v.items()}
                                if k == "configs" else v)
                            for k, v in res.items()})
                for part, res in (("rtnh_mdd", rtnh_mdd), ("alignnet", align))}}}))
        # the training phases run after every serving phase, so that nothing
        # they leave on the card shows in the serving paths' peak memory
        t0 = time.perf_counter()
        tiny_train = phase_tiny_train(card)
        train_det = phase_train_det(card)
        train_seg = phase_train_seg(card)
        print(json.dumps({"training": {
            "card": card, "tiny_card_vs_cpu": tiny_train,
            "det": {k: v for k, v in train_det.items() if k != "losses"},
            "seg": {k: v for k, v in train_seg.items() if k != "losses"}}}))
        marks["phases 4b, 8, 9"] = time.perf_counter() - t0
        train_models = phase_train_models(card)
        marks["phase 17"] = train_models["seconds"]
        print(json.dumps({"train_models": train_models}))
        disk_train = phase_disk_train(card, disk_work)
        marks["phase 18 training"] = disk_train["seconds"]
        print(json.dumps({"disk_train": disk_train}))
        hetero_train = phase_hetero_train(card)
        marks["phase 19 training"] = hetero_train["seconds"]
        print(json.dumps({"hetero_train": hetero_train}))
        eb_train = phase_early_bm2cp_train(card)
        marks["phase 20 training"] = eb_train["seconds"]
        print(json.dumps({"early_bm2cp_train": eb_train}))
        flat_train = phase_flat_rest_train(card, {
            d: os.path.join(disk_work, d) for d in ("opv2v", "dair")})
        marks["phase 21 training"] = flat_train["seconds"]
        marks["phase 21"] = (marks["phase 21 serving and late"]
                             + flat_train["seconds"])
        print(json.dumps({"flat_rest_train": flat_train}))
        v2xr_train = phase_v2xr_train(card, disk_work)
        marks["phase 22 training"] = v2xr_train["seconds"]
        marks["phase 22"] = marks["phase 22 serving"] + v2xr_train["seconds"]
        print(json.dumps({"v2xr_train": v2xr_train}))
        rtnh_mdd_train = phase_rtnh_mdd_train(card, disk_work)
        marks["phase 23 training"] = rtnh_mdd_train["seconds"]
        marks["phase 23"] = marks["phase 23 serving"] + rtnh_mdd_train["seconds"]
        print(json.dumps({"rtnh_mdd_train": rtnh_mdd_train}))
    finally:
        shutil.rmtree(disk_work, ignore_errors=True)
        shutil.rmtree(cam_work, ignore_errors=True)
    print(json.dumps({"family": dict(family, tiny_card_vs_cpu=tiny_family)}))
    runs = {"det": det, "seg": seg, "camera": cam, "v2xvit det": v2x["det"],
            "v2xvit seg": v2x["seg"],
            "scope": {mode: scope[mode] for mode in ("auto", "pallas")}}
    runs.update({f"family {path}": {mode: family[path][mode]
                                    for mode in ("auto", "pallas")}
                 for path in (f"{t}/{n}" for t, n in FAMILY_PATHS)})
    for path, res in runs.items():
        for mode, r in res.items():
            print(f"launches in the timed {path} {mode} runs: {r['launches']}")
    v2v_disk = family["on_disk_v2vnet"]["launches"]
    launches = {k: sum(r["launches"][k] for res in runs.values()
                       for r in res.values()) + ev["launches"][k] + v2v_disk[k]
                + cam_disk["launches"][k] + train_models["launches"].get(k, 0)
                + disk["launches"].get(k, 0) + disk_train["launches"].get(k, 0)
                + hetero["launches"].get(k, 0) + hetero_train["launches"].get(k, 0)
                + eb["launches"].get(k, 0) + flat_rest["launches"].get(k, 0)
                + late["launches"].get(k, 0) + flat_train["launches"].get(k, 0)
                + v2xr["launches"].get(k, 0) + rtnh_mdd["launches"].get(k, 0)
                + align["launches"].get(k, 0)
                for k in det["auto"]["launches"]}
    print(f"launches in the counted phase 13 runs: {ev['launches']}; in phase "
          f"15's on-disk V2VNet run: {v2v_disk}; in phase 16's timed and CLI "
          f"runs: {cam_disk['launches']}; in phase 17's evaluations of the "
          f"trained models: {train_models['launches']}; in phase 18's timed "
          f"runs: {disk['launches']}; in phase 18's evaluations of the trained "
          f"models: {disk_train['launches']}; in phase 19's timed runs: "
          f"{hetero['launches']}; in phase 19's evaluations of the trained "
          f"models: {hetero_train['launches']}; in phase 20's timed runs: "
          f"{eb['launches']}; in phase 21's timed runs: "
          f"{flat_rest['launches']}, its counted late-fusion CLI runs: "
          f"{late['launches']} and its KD teacher's forwards: "
          f"{flat_train['launches']}; in phase 22's timed and single runs: "
          f"{v2xr['launches']}; in phase 23's timed runs: RTNH and MDD "
          f"{rtnh_mdd['launches']}, HEAL + AlignNet {align['launches']}")
    print("launches over the timed main-path runs (phases 5, 7, 10, 11, 12, 15, "
          "16, 18, 19, 20, 21, 22 and 23), the counted phase 13, 15, 16 and 21 CLI "
          "runs, phase 17's, 18's and 19's evaluations, phase 21's KD teacher "
          f"and phase 22's single runs: {launches}")
    marks["whole script"] = time.perf_counter() - t_start
    print(json.dumps({"phase_seconds": {k: round(v, 1) for k, v in marks.items()}}))
    k1_main = k1[("make_scene", torch.bfloat16)]  # the main path writes bf16
    print(json.dumps({"kernels": [
        {"name": "pillar_encode", "route": "cuda",
         "source": "airv2x_tpu_torch/csrc/pillar_encode.cu",
         "replaces": "airv2x_tpu/ops/pallas_pillars.py:203",
         "launches": launches["pillar_encode"],
         "max_abs_err": k1[("make_scene", torch.float32)]["err"],
         "ms": k1_main["ms"],
         "plain_ms": k1_main["plain_ms"], "bound_ms": k1_main["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "quad_iou", "route": "cuda",
         "source": "airv2x_tpu_torch/csrc/quad_iou.cu",
         "replaces": "airv2x_tpu/ops/pallas_iou.py:60",
         "launches": launches["quad_iou"],
         "max_abs_err": max(k2["err"], k2_scene["err"]),
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None, "need_bound_ms": k2["need_ms"],
         "survivor_share": k2["survivor_share"],
         "scene_nms_input": {key: k2_scene[key] for key in (
             "err", "ms", "ms_full", "plain_ms", "bound_ms", "need_ms",
             "survivor_share")}},
        {"name": "pillar_reduce", "route": "cuda",
         "source": "airv2x_tpu_torch/csrc/pillar_reduce.cu",
         "replaces": "airv2x_tpu/ops/pallas_pillars.py:69",
         "launches": launches["pillar_reduce"], "max_abs_err": k3["err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
    ] + [k4_row(name, launches[name], k4, form) for name, form in (
        ("conv3x3", "a"), ("conv3x3_allmaps", "b"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
