"""Chip smoke test of the PyTorch port (``primia_tpu_torch``) on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed N] [--profile_out PATH]

Phases, each reported on its own line; any failure exits nonzero:

1. build          compile every ``primia_tpu_torch/csrc/*.cu`` with nvcc
                  (all at once) and report the seconds.
2-3. clahe       K3, CLAHE as one kernel (a thread-block cluster a plane),
                  against its plain composite (LUTs, apply, / 255) on the
                  card, bit for bit, at the serving path's shape (16, 224,
                  224), at (64, 224, 224), at the train path's (200, 224,
                  224), at a ragged (3, 60, 60) and on low-entropy planes (all
                  zero, 90% one value, a smooth ramp, and 200 planes of
                  those); its LUTs (``luts_out``) equal the plain LUTs; two
                  calls give the same bits. For each case: kernel_ms
                  (device time per launch, torch.profiler), call_ms (the
                  wrapper's time per call in a loop, CUDA events), plain_ms,
                  and bound_ms (each pixel read once and its float32 result
                  written once, 5 bytes a pixel at 3.35 TB/s, or the f32
                  operations at 67 TFLOP/s, whichever is larger); then the
                  cluster shape, shared memory a CTA and the clusters the
                  card holds at once, and the kernels' registers, shared
                  memory and spills (cuobjdump -res-usage).
3b. clahe_lab     the 3-channel CLAHE as one kernel (RGB -> LAB, K3's
                  LUTs and apply on L, back to RGB) against the plain
                  composition on the card, bit for bit, at the train steps'
                  (200 and 64 contiguous NCHW images of 224x224), the
                  serving batch and a ragged 3 x 60 x 60 in the predict
                  step's layout (NHWC seen as NCHW), and on the low-entropy
                  planes as 200 grey images; one launch a call and no K3,
                  the input's layout, the same bits on a second call; the
                  times as above beside the bound (24 bytes a pixel), the
                  plain composition's device operations and K3's time on
                  the same planes; its cluster plan.
4. tent_rows      K1 against its plain version, bit for bit, at the
                  canonical train shape (200 images x 3 channels of 224x224)
                  for each of the train step's four passes (the affine warp's
                  row and column pass from real ``_affine_mats`` draws, the
                  dense warp's column and row pass from real elastic + grid
                  displacement fields), at a ragged (3 x 2 planes of 60x72)
                  and at 2 x 1 planes of 37x45 with positions up to 4 planes
                  past either edge; the same times as above, and library_ms, the time
                  of ``F.grid_sample(bilinear, zeros, align_corners=True)``
                  computing the same function (a yardstick the port never
                  calls).
5. tent_bilinear  K2 likewise (max |d| <= 1e-6), at the canonical shape (the
                  dense warp's and the affine warp's gather coordinates) and
                  the two others.
6. serve          slice 1's main path: the canonical recipe
                  (configs/torch/pneumonia-resnet-pretrained.ini: ResNet-18,
                  3 channels, 224 px, CLAHE on) with seeded random weights,
                  saved as a checkpoint; 64 synthetic 224x224 DICOMs; the
                  inference CLI on cuda at batch 16, with the launch counters
                  set to 0 just before and read just after (the CLAHE kernel
                  once per batch); the card's logits for 4 images against the
                  same predict step on the CPU; images per second; a profile.
7. train          slice 2's main path: the canonical INI with epochs = 1 on a
                  synthetic 3-class set of 600 train and 60 test DICOMs;
                  ``python -m primia_tpu_torch.cli.train`` in-process on cuda,
                  counters set to 0 just before and read just after (K1 four
                  times per train step, K2 never, the CLAHE kernel once);
                  then 24 timed train steps at batch 200 (p50/p75, img/s,
                  device ms by category, idle share, a profile); 2 steps under
                  PRIMIA_WARP_TWOPASS=0 (K2 once per step); and one float32
                  step with augmentation and mixup off on the card against
                  the CPU from the same params and batch (loss within 1e-4
                  relative, BN running statistics within 1e-4).
8. dcf_sign       K4, the FSS sign kernel, against its plain version on the
                  card, bit for bit, at N = 802,816 (the largest call of a
                  224 px ResNet forward at batch 1: the stem max-pool's first
                  round), at N = 3,211,264 (VGG-16's first ReLU at batch 1),
                  at a ragged N = 300 and at five boundary points;
                  the share sums equal (1 - 2c) * 1{x < alpha}. kernel_ms,
                  call_ms, plain_ms as above; bound_ms from the integer
                  operations (the rotations and xors of the Threefry blocks
                  these inputs need, which only the INT32 lanes run: 12
                  blocks a level over 31 levels, and 3 more a level past the
                  first level where x and alpha differ; at 132 SMs x 64
                  INT32 lanes a clock at the maximum SM clock nvidia-smi
                  reports) or the bytes, whichever is larger; no PyTorch
                  call computes a DCF. Then the kernel's SASS opcode counts
                  (cuobjdump -sass; the level loop is not unrolled).
9. wgrad          K7, the 3x3/s1/p1 weight gradient of the opt-in train path,
                  against its plain version (within 1e-3 of max |dW|) at the
                  train step's two shapes (layer2: 200 x 128 x 28 x 28, layer3:
                  200 x 256 x 14 x 14), the DP ghost step's, VGG-16's three
                  at batch 64 (128 -> 128 at 112^2, 128 -> 256 and 256 -> 256
                  at 56^2) and two ragged ones, and bit-identical
                  over two calls; times as above, bound from the bf16
                  tensor-core operations at 989 TFLOP/s or the bytes,
                  library_ms ``torch.nn.grad.conv2d_weight`` (cuDNN); each
                  shape's plan (``cuda_wgrad.card_plan``) and TFLOP/s; the
                  library's registers, shared memory and spills (cuobjdump
                  -res-usage) and the kernel's SASS opcode counts, which must
                  hold HGMMA and UTMALDG (wgmma fed by TMA).
10. bn            the switched batch norm's six launches (three a
                  direction) against their plain versions on the same inputs,
                  at the stem's 200 x 64 x 112 x 112, layer3's 200 x 256 x 14
                  x 14, layer4's 200 x 512 x 7 x 7, SimpleConv@224's 4 x 8 x
                  111 x 111, 4 x 32 x 54 x 54 and 4 x 128 x 12 x 12 and a
                  ragged shape: K8's
                  sums and gradient sums (their partials' sum within 1e-5 of
                  the sums of absolute values); the two finalizes (their sums
                  within 1e-6 of the partials' absolute sums; mean, var, the
                  coefficients and the running statistics within 1e-6 of
                  their largest |value|); apply and dx (y and dx within one
                  bfloat16 ulp); every launch bit-identical over two calls.
                  Times and bounds per launch; library_ms
                  ``torch.batch_norm_stats`` (sums), ``batch_norm_elemt``
                  (apply), ``batch_norm_backward_reduce`` (gradient sums) and
                  ``batch_norm_backward_elemt`` (dx), none for the
                  finalizes; and a whole ``bn_train`` forward + backward
                  beside ``F.batch_norm``'s.
11. noise         K5, the Gaussian-noise kernel, on its own path: the JAX
                  package calls it from no entry point, so its path is one
                  call at the canonical train batch (200 x 3 x 224 x 224 f32)
                  with the counters set to 0 around it; there, at an
                  unaligned f32 case (7 x 3 x 37 x 45: rows of 4,995) and a
                  ragged bf16 case, its uniforms bit for bit against the
                  plain version's, the output within 1e-5 (f32) or one bf16
                  ulp, the same bits over two calls; the noise's moments at
                  30.1 M samples (mean, std, the correlation of each pair's
                  cosine and sine elements, the share beyond 3 sigma, the
                  excess kurtosis). Times as above, library_ms
                  ``torch.normal(x, sigma)``, a copy of the same bytes as
                  the achievable rate (not the bound); bound from the bytes,
                  the Philox multiplies, the special-function unit or the
                  issued instructions, whichever is largest; the SASS opcode
                  counts (checked against the bound's counts) and registers.
11b. window_attention  Swin's window attention on the port's kernel pair
                  (``ops/cuda_attention.py``): the source's nvcc seconds
                  (a build into an empty directory) and the kernels'
                  registers and spills (cuobjdump -res-usage); at Swin-B's
                  stage-1 (4,096 windows, 4 heads) and stage-3 (256, 16)
                  shapes, L 144, bf16 views of a qkv output, regular and
                  shifted: o and the four gradients against float64, the
                  same bits over two backward calls; forward and backward
                  each: device and call ms beside its own least time, the
                  plain version's and the memory-efficient SDPA's (a
                  yardstick), and both together beside the least time of
                  ``benchmark/attention.py``; the float32 build at the
                  stage-3 shape.
11c. swin_train   one Swin-B train step at the cell swin_b384.train's
                  shapes (batch 64, 384 px) after a warm-up step, its
                  launch counters counted from zero: 24 forward and 24
                  backward window-attention launches, one each a block;
                  53 forward and 53 backward layer-norm launches (48 block
                  norms, 3 merge norms, the embedding's and the final
                  norm); then one more step under the profiler: no roll
                  and no PyTorch layer-norm kernel among its device
                  operations, its device ms by category and its largest
                  kernels.
11d. swin_norm    Swin's fused layer norms (``ops/cuda_swin_norm.py``): the
                  kernels' registers and spills (cuobjdump -res-usage); at
                  Swin-B's stage-1 (64 x 96² x 128, a float32 stream) and
                  stage-3 (64 x 24² x 512, a bf16 stream) maps, shifted
                  (window 12, shift 6), norm1 (y bf16 at the block's
                  window order) and norm2 (the bf16 branch read at that
                  order, the sum and y in natural order): the sum the same
                  bits as the plain add, y within one bf16 ulp of the
                  float64 layer norm (plus 8 float32 ulps of the terms
                  float32 rounds),
                  dx and the branch's gradient within
                  the test file's gaps of the plain version, the same bits
                  over two backward calls; each direction's device and
                  call ms beside its least bytes at 3.35 TB/s (stage 1: 6,
                  12, 14 and 16 bytes an element) and the plain
                  composition's ms.
12. ring          the card's byte-limb ring conv (int8 torch._int_mm) against
                  the CPU's native int64 conv, bit for bit, at the stem conv
                  at 224 px, batch 1 (3->64, 7x7, stride 2, pad 3) and a
                  layer4 3x3 conv (512->512 at 7x7); both times.
13. encrypt       slice 3's main path: the inference CLI with
                  --encrypted_inference --protocol fss on cuda, in-process, on
                  8 of the serve phase's DICOMs with its checkpoint at
                  --batch_size 4, counters set to 0 just before and read just
                  after (K4 21 times per forward, the CLAHE kernel once per
                  batch); the encrypted logits against the card's plain
                  predict step (max |d| <= max(0.02, 1e-3 * max |logit|),
                  argmax equal wherever the plain top-two margin exceeds
                  that); once more with --mpc_batch_tile 2; the encrypted
                  predict timed at batch 1 and 4 (p50/p75 over 5 batches
                  after 1 warm-up, s per image, peak memory; device busy ms,
                  idle share, device operations and device ms by category
                  from the profiler over one batch).
13b. encrypt_snn  slice 3b's path (a): the same with --protocol snn
                  (SecureNN, plain tensor ops): CLAHE once a batch and K4
                  never; the same checks and timings, beside phase 13's.
13c. encrypt_group slice 3b's path (b): a group-norm ResNet-18 at 224 px with
                  the DP INI's settings (max pool, no CLAHE), seeded He
                  weights and an N(0, 0.1) head, under --protocol fss (K4 21
                  times a forward, nothing else: private group norm compares
                  nothing) and snn (no launch); the same checks and timings.
14. train_optin  slice 2b's main path: the train CLI as in phase 7 under the
                  JAX package's switches PRIMIA_PALLAS_WGRAD/BN/AUGMENT=1,
                  counters set to 0 just before and read just after (K7 6
                  times a step, each of the BN's six launches 20 times, K1
                  and CLAHE as in phase 7); the wrappers' layout copies; 24
                  timed steps of the switched step beside 24 of the default
                  one (p50, idle share, K7's and the BN kernels' device ms a
                  step, the CPU-side aten:: ops a step from the profiler, and
                  the device ms a step the switched step spends beyond the
                  default, by category); one bf16
                  step with augmentation and mixup off, switched against
                  default from the same weights and batch (loss within 1e-2
                  relative; the fc's gradients within 2e-2 of max; K7's conv
                  weight gradients within 2e-2 of max; under all three
                  switches the BN running statistics within 2e-2, and the
                  conv and BN gamma/beta gradients no further from an f32
                  step's than 1.5 times the default bf16 step's).
15. federated     slice 4's main path: the train CLI with --train_federated on
                  the canonical federated INI (configs/torch/pneumonia-resnet-
                  pretrained-federated.ini: ResNet-18 at 224 px, batch 200 a
                  node, mixup, CLAHE, the full augmentation chain; epochs = 5
                  with repetitions_dataset = 5 is one epoch) on cuda, from the
                  repository root (configs/websetting/config.csv names alice,
                  bob and charlie), on synthetic DICOM shards of 400, 300 and
                  200 images and 60 validation images: 10 federated steps, 25
                  node steps, 4 secure aggregations; counters set to 0 just
                  before and read just after (K1 four times and CLAHE once a
                  node step, nothing else); one node-stacked tree aggregated
                  on the card and on the CPU (int64 reveals equal from
                  different shares, floats equal, within N * 2^-(f+1) of the
                  plain average); p50 of a federated step (3 node steps at
                  batch 200), of a secure and a plain aggregation of the whole
                  model and of a FedAvg round (3 steps and one aggregation),
                  busy ms and idle share from the profiler, peak memory.
16. dp            slice 5's main path, DP-SGD: K1 against its plain version,
                  bit for bit, at the DP step's shape (the affine warp's two
                  passes over 2048 x 3 planes of 224 x 224: batch 512 times 4
                  views); the train CLI on configs/torch/pneumonia-resnet-
                  dp.ini (ResNet-18 with group norm at 224 px, batch 512,
                  augment_multiplicity 4, SGD with momentum, EMA 0.99, sigma
                  2.0; epochs 60 -> 1 and test_interval 2 -> 1) on 1,024
                  synthetic DICOMs (2 steps) and 60 test ones, from the He
                  init (no ImageNet file visible), counters set to 0 just
                  before and read just after (K1 twice a step, nothing else);
                  its epsilon line against the accountant; its EMA checkpoint
                  (raw parameters beside it) through the evaluate CLI on the
                  card; 6 microbatched steps at batch 512 after 2 warm-up
                  steps (p50/p75, examples/s, views/s, the microbatch, peak
                  memory; busy ms, idle share, device ms by category and aten
                  ops from the profiler over one step); the ghost-norm step
                  (K = 1) timed the same way, and again under
                  PRIMIA_PALLAS_WGRAD=1 (K7 three times a step: layer3's
                  stride-1 convs at 512 x 256 x 14 x 14), whose clipped sum at
                  sigma = 0 is held to the default ghost step's (2e-2 of each
                  leaf's max); the microbatched step (K = 4, bfloat16) on 64
                  examples under PRIMIA_PALLAS_WGRAD=1, K7 through its vmap
                  rule once an example for each of layer2's and layer3's
                  stride-1 convs (384 launches), its clipped sum at sigma = 0
                  held to the unswitched step's (2e-2), both steps' p50 over
                  2; at sigma = 0 in float32 with augmentation off,
                  the ghost and microbatched clipped sums on the card (16
                  examples) and the card's microbatched step against the
                  CPU's (4 examples), each within 1e-4 of a leaf's max; the
                  noise: one step at sigma = 2 minus one at sigma = 0, scaled
                  by denom / (lr sigma C), has mean and std within 3 standard
                  errors of 0 and 1 over the model's 11.2 M values; then the
                  federated DP CLI (configs/torch/pneumonia-resnet-dp-
                  federated.ini with --train_federated, epochs 60 -> 1 and
                  test_interval 2 -> 1) on 3 nodes of 512 images (one step
                  each, secure aggregation): K1 twice a node step and nothing
                  else, the EMA checkpoint with kept optimizers; the
                  federated step's p50 (3 node steps at batch 512) and a
                  round's (a step and a secure aggregation).
17. vgg           slice 6a: VGG-16 (configs/torch/pneumonia-vgg.ini: 224 px,
                  3 channels, CLAHE, mixup, batch 64; its pretrained = yes
                  finds no weights file and keeps the He init, as the JAX
                  package does) from seeded weights with an N(0, 0.05)
                  classifier (its own N(0, 0.01) leaves logits near 1e-3,
                  too small for the checks to bite; SimpleConv's
                  checkpoints get an N(0, 0.1) head): the inference CLI at
                  batch 16 on phase 6's DICOMs (CLAHE once a batch), the
                  card's logits for 4 images against the CPU's; the train
                  CLI for one epoch on phase 7's 600 DICOMs (K1 four times
                  and CLAHE once a step); 12 timed steps at batch 64 beside 12
                  under PRIMIA_PALLAS_WGRAD=1 (K7 four times a step: the JAX
                  rule keeps the library's weight gradient at 512 channels),
                  one bf16 step switched against default (loss within 1e-2
                  relative, the convs' and the head's gradients within 2e-2
                  of max: the switch moves no forward bit); one f32
                  step on noise images card against CPU (loss within 1e-4
                  relative, classifier gradients within 1e-3 of max); the
                  encrypted CLI on 4 DICOMs at batch 1 with --mpc_batch_tile
                  1 under fss (K4 25 times a forward: 15 ReLUs, 5 pools of 2
                  rounds) and snn, logits as phase 13, timed at batch 1 (p50
                  of 3, peak memory, device operations).
18. simpleconv    slice 6a: SimpleConv@224 (configs/torch/pneumonia-conv.ini:
                  1 channel, batch norm, CLAHE, mixup, batch 4) the same way:
                  served, trained (K1 four times and CLAHE once a step), 24
                  timed steps beside 24 under PRIMIA_PALLAS_BN=1 (each of the
                  BN's six launches 3 times a step: C = 8, 32, 128 on 111^2,
                  54^2, 12^2 maps; one step switched against default: loss,
                  the head's gradients and the running statistics within
                  2e-2), card against CPU, encrypted at batch 4
                  under fss (K4 20 times a forward) and snn; then
                  configs/torch/mnist.ini (SimpleConv@28) through the train CLI
                  with --data_dir mnist on a synthetic 10-class IDX set of 640
                  and 100 digits under $MNIST_DIR, one epoch (K1 twice a
                  step, nothing else).
19. conv_dp       slice 6a: configs/torch/pneumonia-conv-dp.ini (SimpleConv@224,
                  group norm, batch 512, K = 4, sigma 2.0, SGD, EMA; epochs
                  60 -> 1, test_interval 2 -> 1) through the train CLI on
                  phase 16's 1,024 DICOMs (2 steps, K1 twice a step over the
                  2,048 views), its epsilon line against the accountant, 2
                  timed microbatched steps (p50, examples/s, peak memory);
                  its group-norm model with an N(0, 0.1) head served
                  encrypted at batch 4 under fss (K4 20 times a forward) and
                  snn; then configs/torch/pneumonia-conv-dp-federated.ini
                  (K = 16, sigma 3.0) with --train_federated on phase 16's 3
                  nodes of 512 images: one step a node and one secure
                  aggregation (K1 twice a node step).
20. grid          slice 7, the grid: port nodes (``serve/node.py``) served in
                  process on cuda on localhost ports. A data_owner node
                  hosting 16 of the serve phase's DICOMs serves its
                  checkpoint (``GridNetwork.serve_model``): remote plain
                  requests at batch 16 over ws and over HTTP, their logits
                  bit for bit the local predict step's, CLAHE once a request;
                  get_data_shares reconstructing to encode(x) mod 2^64; the
                  inference CLI with --websockets_config (and
                  --http_protocol) predicting what it predicts on the local
                  files; one encrypted request under fss at batch 1 (K4 21
                  times, within phase 13's limit of plain). Then the train
                  CLI with --train_federated --websockets on the canonical
                  federated INI (epochs 40 -> 5: one epoch of 2 rounds of 3
                  steps a node) against three nodes of 200 DICOMs and a
                  crypto provider named by a config.csv in a work directory
                  (K1 four times and CLAHE once a node step, nothing else),
                  its checkpoint through the evaluate CLI; one node started
                  as a process (``python -m primia_tpu_torch.serve.node``)
                  answering one remote request as the in-process node does.
                  Times: a request's p50 over each transport split into node
                  compute, pack/unpack and transport; each of the CLI's
                  rounds, timed while it runs, by frame bytes, pack and
                  unpack seconds on both sides, node seconds, fan-out and
                  aggregation; the device busy ms and idle share of a round
                  from its three node rounds and aggregation rerun once
                  under the profiler; the transport that carried each verb
                  (a frame over 1 MiB is refused on ws and goes by HTTP) and
                  whether the native library loaded.
22. hpo           slice 8's main path, the hyperparameter search: the
                  find_config CLI in process on cuda at its own widths
                  (ResNet-18, 224 px, batch 200, pretrained = yes with no
                  ImageNet file: the He init), each trial a full train run
                  from a study file seeded with five finished trials whose
                  objective at step 5 is 100. Locally on phase 7's DICOMs (3
                  steps an epoch): a 5-epoch trial pruned at step 5 through
                  the loop's hook, a 1-epoch trial, a 1-epoch trial whose
                  categoricals all answer True (all 17 augmentation flags
                  and mixup on; every loss finite); then one --federated
                  trial with secure aggregation on phase 15's shards, from a
                  work directory whose configs/websetting/config.csv names a
                  crypto provider. Counters set to 0 around each trial: K1,
                  K2 and CLAHE exactly as the trial's recorded draws ask
                  (two K1 passes for a two-pass-safe affine range, else one
                  K2 gather; two K1 passes for the dense warp; CLAHE once a
                  step). Each trial's state, value, seconds and launches; a
                  failed trial fails the phase.
23. warm          the warm CLI on the canonical train INI and phase 7's data
                  into a fresh build directory: the six libraries built at
                  once, one train step at batch 200 and one eval step, each
                  line's seconds; then, with nvcc barred, a train step on a
                  new model loads its libraries from that directory.
24. profile       utils.profile around 5 of phase 7's train steps at batch
                  200, then profiler over the trace: the top ops' table
                  (``.roofline`` beside --profile_out), total_ms, floor_ms
                  and efficiency against the card's roofs, the share of
                  device time under an aten op, each step's device window
                  and the gaps; the parser's device total within 2% of the
                  profiler's key_averages() total over the same steps.
25. enc_train     slice 9: encrypted training (mpc/autograd.py) on phase
                  18's synthetic IDX digits at batch 64, one-hot targets,
                  mse_loss: the 784-128-64-10 ReLU MLP of PySyft's "Part 12
                  bis" tutorial, 10 SGD steps under fss and 3 under snn;
                  a conv net (3x3/s1/p1 1->16 with a bias, ReLU, avg pool
                  2, linear 3,136->10), 3 steps under fss (its ReLU is one
                  K4 call at N = 802,816, its weight gradient contracts
                  over 50,176). After each step the loss and gradients are
                  revealed and held to the float64 plain step from the same
                  revealed parameters (ENC_ATOL, ENC_RTOL, ENC_ULPS); the
                  MLP's fss loss falls; counters read around each step: K4
                  2 a MLP step and 1 a conv step under fss, 0 under snn.
                  Step p50, the last step profiled (busy ms, idle share,
                  device operations), peak memory.
26. enc_rnn       slice 9: an LSTM (input 28, hidden 128, one layer, batch
                  first) over 8 digits' 28 rows, one encrypted forward
                  under fss and one under snn, each within RNN_TOL of the
                  plain forward on the card; K4's launches equal the sign
                  batches the same forward counts on the CPU (fss: K4's
                  plain version); ms and device operations.
27. crypto        slice 9's library: the DPF at N = 2^20 (31 bits), keys
                  and both parties' shares equal on the card and the CPU;
                  msb(gen_compare) equal to K4's sign_shares at N =
                  802,816; replicated mul, matmul and truncate at 256 x 256
                  against plaintext (truncation within 1 unit of the exact
                  shift); a BFV relinearised product at the default
                  parameters equal on the card and the CPU and decrypting
                  right; Paillier 1,024-bit keygen, 16 values encrypted and
                  decrypted on the host. Times of each.
28. data_parallel slice 10: the canonical INI's train step (ResNet-18 @ 224,
                  global batch 200, CLAHE, MixUp, the noise) data parallel
                  over ranks of torch.distributed (parallel/launch.py
                  spawns them, a deadline each): 2 ranks on cuda:0 over
                  gloo on a one-card machine, a rank a card over NCCL
                  otherwise. The 2-rank float32 step against the
                  one-process step on the card (loss 1e-5 relative, fc
                  gradients 1e-4 of their largest, BN statistics 1e-5);
                  K1 4 and CLAHE 1 a step on every rank; the bf16 step's
                  p50 of 12, idle share, the gradient all-reduce's ms and
                  bytes, the noise field drawn whole against a rank's rows;
                  3 steps under PRIMIA_PALLAS_BN=1 PRIMIA_PALLAS_WGRAD=1
                  (K7 6, each BN launch 20 a step on every rank) held to
                  the unswitched steps (losses within 2e-2).
29. multihost     one secure FedAvg round across the ranks (a node a rank)
                  of ResNet-18 trees: bit for bit the one-process
                  secure_fedavg on the card.
30. party         party_devices: the encrypted ResNet-18 @ 224 at batch 4
                  under fss and snn on ("cuda:0", "cuda:0"), SimpleConv @
                  28 with party 1 on the CPU (and on cuda:1 with a second
                  card), a secure FedAvg with party 1 on the CPU: each bit
                  for bit the unsplit result; K4 21 and CLAHE 1 a split fss
                  forward; split and unsplit p50.
31. tf_export     whether TensorFlow imports; when it does, phase 7's
                  checkpoint exported as a SavedModel, its logits within
                  1e-4 of the card's eval logits.
32. figures       cli/figure_lambda.py and cli/figure_sigma.py over two
                  values for one epoch each, their CSVs under
                  build/chip_smoke/figures.
21. kernels       one JSON line with each kernel's error, times, bound and
                  launches, counted on the path that runs it (the train CLI
                  for K1 and the 3-channel CLAHE, SimpleConv's 1-channel
                  train CLI for K3, the PRIMIA_WARP_TWOPASS=0 steps for K2,
                  the encrypted CLI for K4, the switched train CLI for K7 and
                  K8, the noise phase for K5; every path's counts beside
                  them, K1 and CLAHE also on the federated and hpo paths, CLAHE on the
                  snn encrypted CLI, K4 on the group model's fss CLI, K1 on
                  the DP and federated DP CLIs, K7 on the switched ghost and
                  microbatched steps; K1, CLAHE, K4, K7 and the BN launches
                  on phases 17-19's paths, K4 on phases 25-26's; and
                  a kernel launched no time on any of its paths fails the
                  run), the card's name and power limit, and as the last line
                  {"ok": true, "device": {...}}.

Nothing here imports JAX or the JAX package. Work files go to
``build/chip_smoke/``, and the profile tables to ``--profile_out`` (default
``build/chip_smoke/profile.txt``; the train step's, the encrypted
predict's under each protocol and model, the default and switched steps
of phase 14 and the federated step beside it, the DP steps', with
``.train``, ``.encrypt``, ``.encrypt_snn``, ``.encrypt_group_{fss,snn}``,
``.train_optin.{default,switched}``, ``.federated`` or
``.dp_{microbatched,ghost,ghost_optin}`` before the suffix).
Phases run in the order 1-5, 8-12, 6, 13, 13b, 13c, 7, 14, 15, 16, 17, 18, 19, 20,
22, 23, 24, 25, 26, 27, 28-29, 30, 31, 32, and 21's line last.
Earlier phases run shallower to make room for 17-19: phases 7 and 14 time 12
steps (24 before), phase 16's DP steps 3 after 1 warm-up (6 after 2).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "torch" / "pneumonia-resnet-pretrained.ini"
N_IMAGES = 64
BATCH = 16
RES = 224
TRAIN_PER_CLASS, TEST_PER_CLASS = 200, 20
TRAIN_BATCH = 200
TIMED_STEPS = 12
CLASSES = ("bacterial pneumonia", "normal", "viral pneumonia")
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
KERNELS = {
    # K3: both TPU kernels (the LUTs, their apply) and the / 255 after them.
    # "path" is the path whose count the kernels line reports; "also" names
    # the other paths that must launch the kernel (the federated nodes' steps).
    # 3-channel images take clahe_lab; K3 serves 1-channel ones (SimpleConv's
    # INI: pretrained = no)
    "clahe": {"replaces": "primia_tpu/ops/pallas_clahe.py:83,148", "path": "conv_train",
              "also": ("conv_serve", "conv_encrypt", "conv_encrypt_snn"),
              "kernel": ("clahe_kernel",),
              "source": "primia_tpu_torch/csrc/clahe.cu"},
    # the 3-channel CLAHE: K3's two TPU kernels and the RGB -> LAB -> RGB
    # conversion that XLA fuses around them (image.py:clahe)
    "clahe_lab": {"replaces": "primia_tpu/ops/pallas_clahe.py:83,148 + primia_tpu/ops/image.py:617",
                  "path": "train",
                  "also": ("federated", "encrypt_snn", "vgg_serve", "vgg_train", "vgg_encrypt",
                           "vgg_encrypt_snn", "grid_serve", "grid_federated", "hpo",
                           "data_parallel", "data_parallel_switched", "party"),
                  "kernel": ("clahe_lab_kernel",),
                  "source": "primia_tpu_torch/csrc/clahe.cu"},
    "tent_rows": {"replaces": "primia_tpu/ops/pallas_tent.py:191", "path": "train",
                  "also": ("federated", "dp", "dp_federated", "vgg_train", "conv_train",
                           "mnist", "conv_dp", "conv_dp_federated", "grid_federated", "hpo",
                           "data_parallel", "data_parallel_switched"),
                  "kernel": ("tent_rows_kernel",),
                  "source": "primia_tpu_torch/csrc/tent.cu"},
    # K2 is on the train path when the dense warp is the joint gather
    # (PRIMIA_WARP_TWOPASS=0) or the affine ranges are not two-pass safe
    "tent_bilinear": {"replaces": "primia_tpu/ops/pallas_tent.py:54",
                      "path": "train_twopass0", "kernel": ("tent_bilinear_kernel",),
                      "source": "primia_tpu_torch/csrc/tent.cu"},
    "dcf_sign": {"replaces": "primia_tpu/ops/pallas_dcf.py:115", "path": "encrypt",
                 "also": ("encrypt_group", "vgg_encrypt", "conv_encrypt", "conv_group_encrypt",
                          "grid_encrypt", "enc_train", "enc_rnn", "party"),
                 "kernel": ("dcf_sign_kernel",),
                 "source": "primia_tpu_torch/csrc/dcf.cu"},
    # slice 2b: the train step under PRIMIA_PALLAS_WGRAD/BN/AUGMENT=1; a
    # function's time counts each kernel named here (K7's second, reducing
    # pass included)
    "conv3x3_wgrad": {"replaces": "primia_tpu/ops/pallas_wgrad.py:122", "path": "train_optin",
                      "also": ("dp_ghost_optin", "dp_micro_optin", "vgg_optin",
                               "data_parallel_switched"),
                      "kernel": ("conv3x3_wgrad_kernel", "conv3x3_wgrad_reduce_kernel"),
                      "source": "primia_tpu_torch/csrc/wgrad.cu"},
    # the switched batch norm, three launches a direction: K8's sums, and the
    # finalize and elementwise passes that bn_train's custom_vjp leaves to
    # XLA on the TPU (their "replaces" names those lines)
    "bn_sums": {"replaces": "primia_tpu/ops/pallas_bn.py:59", "path": "train_optin",
                "also": ("conv_optin", "data_parallel_switched"), "kernel": ("bn_sums_kernel",),
                "source": "primia_tpu_torch/csrc/bn.cu"},
    "bn_finalize": {"replaces": "primia_tpu/ops/pallas_bn.py:254", "path": "train_optin",
                    "also": ("conv_optin", "data_parallel_switched"), "kernel": ("bn_finalize_kernel",),
                    "source": "primia_tpu_torch/csrc/bn.cu"},
    "bn_apply": {"replaces": "primia_tpu/ops/pallas_bn.py:261", "path": "train_optin",
                 "also": ("conv_optin", "data_parallel_switched"), "kernel": ("bn_apply_kernel",),
                 "source": "primia_tpu_torch/csrc/bn.cu"},
    "bn_grad_sums": {"replaces": "primia_tpu/ops/pallas_bn.py:75", "path": "train_optin",
                     "also": ("conv_optin", "data_parallel_switched"), "kernel": ("bn_grad_sums_kernel",),
                     "source": "primia_tpu_torch/csrc/bn.cu"},
    "bn_grad_finalize": {"replaces": "primia_tpu/ops/pallas_bn.py:276", "path": "train_optin",
                         "also": ("conv_optin", "data_parallel_switched"), "kernel": ("bn_grad_finalize_kernel",),
                         "source": "primia_tpu_torch/csrc/bn.cu"},
    "bn_dx": {"replaces": "primia_tpu/ops/pallas_bn.py:285", "path": "train_optin",
              "also": ("conv_optin", "data_parallel_switched"), "kernel": ("bn_dx_kernel",),
              "source": "primia_tpu_torch/csrc/bn.cu"},
    # K5 is on no path of either package (only the JAX package's own test
    # calls it), so its path is its own phase: one call at the canonical
    # train batch, as the augmentation's GaussNoise would make it
    "gaussian_noise": {"replaces": "primia_tpu/ops/pallas_kernels.py:145", "path": "noise",
                       "kernel": ("gaussian_noise_kernel",),
                       "source": "primia_tpu_torch/csrc/noise.cu"},
    # Swin's window attention replaces no TPU kernel (the JAX package has
    # no Swin): PyTorch's fused attention, which the port does not call.
    # Its path is one Swin-B train step at the cell swin_b384.train's
    # shapes; the backward's time counts its finalize
    "window_attention_fwd": {"replaces": "none: F.scaled_dot_product_attention (no Swin in JAX)",
                             "path": "swin_train", "kernel": ("fmha_cutlassF_window_kernel",),
                             "source": "primia_tpu_torch/csrc/window_attention.cu"},
    "window_attention_bwd": {"replaces": "none: F.scaled_dot_product_attention (no Swin in JAX)",
                             "path": "swin_train",
                             "kernel": ("fmha_cutlassB_window_kernel",
                                        "fmha_cutlassB_window_bias_grad_kernel"),
                             "source": "primia_tpu_torch/csrc/window_attention.cu"},
    # Swin's layer norms replace no TPU kernel either: F.layer_norm with the
    # roll, window partition and reverse, residual add and casts around it.
    # Path: one Swin-B train step; the backward's time counts its finalize
    "swin_norm_fwd": {"replaces": "none: F.layer_norm, roll, window partition, add, cast "
                                  "(no Swin in JAX)",
                      "path": "swin_train", "kernel": ("swin_norm_fwd_kernel",),
                      "source": "primia_tpu_torch/csrc/swin_norm.cu"},
    "swin_norm_bwd": {"replaces": "none: F.layer_norm, roll, window partition, add, cast "
                                  "(no Swin in JAX)",
                      "path": "swin_train",
                      "kernel": ("swin_norm_bwd_kernel", "swin_norm_finalize_kernel"),
                      "source": "primia_tpu_torch/csrc/swin_norm.cu"},
}
KERNEL_NAMES = sorted({k for meta in KERNELS.values() for k in meta["kernel"]}, key=len,
                      reverse=True)
# K4's work (csrc/dcf.cu): a Threefry-2x32-20 block's 20 rotations (funnel
# shifts) and 20 xors issue only on an SM's 64 INT32 lanes; its adds may
# also issue on the FMA pipe as IMAD, so they do not raise the least time.
# The blocks of one seed share the counter's second word, so their first
# rotation is one. A level's key walk runs both children of both parties'
# seeds (2 x 6 blocks); past the first level where x and alpha differ, the
# merged evaluation walk runs 3 blocks of one seed. 44 bytes in (8 seed
# words, alpha, c, x) and 16 out, an element.
DCF_LEVELS = 31
DCF_KEY_OPS_PER_LEVEL = 2 * (6 * 40 - 5)
DCF_EVAL_OPS_PER_LEVEL = 3 * 40 - 2
DCF_BYTES_PER_ELEMENT = 60
INT32_LANES = 132 * 64  # H100 SXM: 132 SMs x 64 INT32 lanes a clock
ENCRYPT_IMAGES, ENCRYPT_BATCH = 8, 4
SIGNS_PER_FORWARD = 21  # 17 ReLUs + 4 max-pool rounds of ResNet-18


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def say(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def cuda_ms(torch, fn, iters, warmup=3):
    """Milliseconds per call of ``fn``: CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def p50_ms(torch, np, fn, n):
    """p50 of the host clock around ``n`` synchronised calls of ``fn``,
    after one warm-up call, in ms."""
    fn()
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(ms, 50))


def trace(torch, fn, iters):
    """Run ``fn`` ``iters`` times under torch.profiler; returns the
    profiler."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof


def profile(torch, fn, iters):
    """The key_averages of :func:`trace`'s window."""
    return trace(torch, fn, iters).key_averages()


def device_rows(avgs):
    """The device-side rows of profiler averages (kernels, copies, sets),
    without the device ranges that a profiler records beside them for
    ``record_function`` spans (the train path's ``utils.span``s)."""
    from torch.autograd import DeviceType

    spans = {e.key for e in avgs if getattr(e, "is_user_annotation", False)}
    return [e for e in avgs if e.device_type == DeviceType.CUDA and e.key not in spans]


def device_ms_by_category(avgs, iters):
    """Device milliseconds per call of the profiled function, summed over
    the device-side rows (kernels and copies) by the benchmark's category
    (``benchmark/trace.py:category``: the port's kernels k1 ... k8,
    convolution, memcpy, elementwise)."""
    from benchmark.trace import category

    cats = collections.defaultdict(float)
    for e in device_rows(avgs):
        cats[category(e.key)] += e.self_device_time_total * 1e-3 / iters
    return dict(cats)


def function_device_ms(avgs, kernel_names, calls):
    """Device milliseconds per call of a function whose ``calls`` calls
    launched the kernels named in ``kernel_names`` (its kernel and any
    second pass), from profiler averages; None where the trace has no
    device time for them."""
    total = sum(e.device_time_total for e in avgs
                if e.count and any(n in e.key for n in kernel_names))
    return total / calls * 1e-3 if total > 0 else None


def bound(nbytes, nops, peak_ops=PEAK_F32_OPS_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_launches():
    from primia_tpu_torch.ops import _build

    _build.reset_launches()


def read_launches():
    from primia_tpu_torch.ops import _build

    return _build.read_launches()


def idle_launches(**nonzero):
    """Every counter at 0 but those given."""
    return {**{k: 0 for k in read_launches()}, **nonzero}


def clahe_counter(n_channels):
    """The launch counter of CLAHE on images of ``n_channels``: the
    3-channel kernel, or K3 plane by plane."""
    return "clahe_lab" if n_channels == 3 else "clahe"


def phase_build():
    from primia_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    secs = time.perf_counter() - t0
    for name in ("clahe", "tent", "dcf", "wgrad", "bn", "noise", "window_attention", "swin_norm"):
        check(name in libs and libs[name].is_file(), f"{name}.cu did not build")
    say("build", seconds=f"{secs:.3f}", libraries=",".join(sorted(libs)))


def low_entropy_planes(torch, n, H, W, g):
    """Planes whose histograms pile into few bins, as the flat regions of a
    chest X-ray do: all zero, 90% one value, a smooth ramp, in turn."""
    dev = g.device
    rand = torch.randint(0, 256, (H, W), dtype=torch.uint8, device=dev, generator=g)
    mostly = torch.where(torch.rand((H, W), device=dev, generator=g) < 0.9,
                         torch.full_like(rand, 200), rand)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    ramp = ((ys + xs) * 255 // max(H + W - 2, 1)).to(torch.uint8)
    kinds = [torch.zeros_like(rand), mostly, ramp]
    return torch.stack([kinds[i % 3] for i in range(n)])


def phase_kernels(torch, seed):
    """Phases 2-3: K3 against its plain composite on the card, bit for bit,
    then clahe_lab against the plain 3-channel composition. Returns both
    records, with the times at the train step's 200 planes and images."""
    from primia_tpu_torch.ops import cuda_clahe as cc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rec = {"max_abs_err": 0.0}
    k3 = {}
    cases = [(f"{n}x{h}x{w}", torch.randint(0, 256, (n, h, w), dtype=torch.uint8, device=dev,
                                            generator=g))
             for n, h, w in [(BATCH, RES, RES), (64, RES, RES), (TRAIN_BATCH, RES, RES),
                             (3, 60, 60)]]
    low = low_entropy_planes(torch, TRAIN_BATCH, RES, RES, g)
    cases += [("zero", low[0:1]), ("mostly_one_value", low[1:2]), ("ramp", low[2:3]),
              (f"low_entropy_{TRAIN_BATCH}x{RES}x{RES}", low)]
    for name, planes in cases:
        N, H, W = planes.shape
        T = 8
        luts = torch.full((N, T * T, 256), -1.0, device=dev)
        out = cc.clahe_planes(planes, luts_out=luts)
        torch.cuda.synchronize()
        want = cc.clahe_planes_plain(planes)
        err = float((out - want).abs().max())
        check(torch.equal(out, want), f"clahe differs from its plain composite at {name}: "
              f"max |d| {err}")
        check(torch.equal(luts, cc.clahe_luts_plain(planes)),
              f"clahe's LUTs differ from the plain LUTs at {name}")
        check(torch.equal(cc.clahe_planes(planes), out),
              f"clahe gives other bits on a second call at {name}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)

        px = N * H * W
        # 5 bytes a pixel; about 12 f32 operations a pixel (the mix and the
        # quotient), 8 a LUT entry (clip, spread, scan, scale)
        r = timed_record(torch, "clahe", lambda: cc.clahe_planes(planes),
                         lambda: cc.clahe_planes_plain(planes), None,
                         bound(5 * px, 12 * px + 8 * N * T * T * 256), iters=100,
                         plain_iters=20)
        _say_times("clahe", r, case=name, max_abs_err=err, deterministic="yes")
        k3[name] = r
        if name == f"{TRAIN_BATCH}x{RES}x{RES}":
            rec.update(r)
    for H, W in ((RES, RES), (60, 60)):
        plan = cc.cluster_plan(H, W)
        check(plan["max_active_clusters"] > 0, f"clahe: no cluster fits at {H}x{W}: {plan}")
        say("clahe", plane=f"{H}x{W}", plan=json.dumps(plan))
    rec_lab = phase_clahe_lab(torch, g, low, k3)
    res = resource_usage("clahe")
    say("clahe", resource_usage="not available" if res is None else json.dumps(res))
    return rec, rec_lab


def phase_clahe_lab(torch, g, low, k3):
    """Phase 3b: clahe_lab, the 3-channel CLAHE in one launch, against the
    plain composition (RGB -> LAB, K3 on L, back) on the card, bit for bit:
    at the train steps' batches (200 and 64 contiguous NCHW images), the
    serving batch and a ragged one as the predict step hands them (NHWC
    seen as NCHW), and on the low-entropy planes as grey images (three
    equal channels, as the configurations' X-rays). One launch a call, no
    K3; the same bits on a second call; the input's layout. Times beside
    the bound (24 bytes a pixel: three float32 read and written), the plain
    composition's (and its device operations) and K3's on the same
    planes."""
    from primia_tpu_torch.ops import cuda_clahe as cc

    dev = torch.device("cuda")
    rec = {"max_abs_err": 0.0}

    def rgb(n, h, w, nhwc):
        x = torch.rand((n, h, w, 3), generator=g, device=dev).permute(0, 3, 1, 2)
        return x if nhwc else x.contiguous()

    grey = low.float().div(255.0)[:, None].expand(-1, 3, -1, -1).contiguous()
    cases = [(f"{TRAIN_BATCH}x3x{RES}x{RES}", rgb(TRAIN_BATCH, RES, RES, False)),
             (f"64x3x{RES}x{RES}", rgb(64, RES, RES, False)),
             (f"{BATCH}x3x{RES}x{RES}_nhwc", rgb(BATCH, RES, RES, True)),
             ("3x3x60x60_nhwc", rgb(3, 60, 60, True)),
             (f"low_entropy_grey_{TRAIN_BATCH}x3x{RES}x{RES}", grey)]
    for name, x in cases:
        B, _, H, W = x.shape
        before = read_launches()
        out = cc.clahe_rgb(x)
        torch.cuda.synchronize()
        after = read_launches()
        check(after["clahe_lab"] == before["clahe_lab"] + 1 and after["clahe"] == before["clahe"],
              f"clahe_lab at {name}: one launch a call and no K3, got {before} -> {after}")
        check(out.stride() == x.stride(), f"clahe_lab at {name}: strides {out.stride()} "
              f"for an input's {x.stride()}")
        want = cc.clahe_rgb_plain(x)
        d = (out - want).abs()
        err = float(d.max())
        check(torch.equal(out, want), f"clahe_lab differs from the plain composition at {name}: "
              f"{int((d > 0).sum())} of {d.numel()} values, up to {err * 255.0} levels")
        check(torch.equal(cc.clahe_rgb(x), out), f"clahe_lab gives other bits on a second "
              f"call at {name}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        r = timed_record(torch, "clahe_lab", lambda: cc.clahe_rgb(x),
                         lambda: cc.clahe_rgb_plain(x), None, bound(24 * B * H * W, 0),
                         iters=50, plain_iters=10)
        plain = profile(torch, lambda: cc.clahe_rgb_plain(x), 1)
        plain_ops = sum(e.count for e in device_rows(plain))
        k3_ms = k3.get(f"{B}x{H}x{W}", {}).get("ms")
        _say_times("clahe_lab", r, case=name, max_abs_err=err, deterministic="yes",
                   plain_device_operations=plain_ops,
                   k3_ms="none" if k3_ms is None else f"{k3_ms:.6f}")
        if name == f"{TRAIN_BATCH}x3x{RES}x{RES}":
            rec.update(r)
    for H, W in ((RES, RES), (60, 60)):
        plan = cc.cluster_plan(H, W, lab=True)
        check(plan["max_active_clusters"] > 0, f"clahe_lab: no cluster fits at {H}x{W}: {plan}")
        say("clahe_lab", image=f"{H}x{W}", plan=json.dumps(plan))
    return rec


def grid_for(torch, ys, xs, H, W):
    """``grid_sample``'s normalised (x, y) grid for absolute positions,
    ``align_corners=True``: -1 and 1 are the first and last pixel centres."""
    return torch.stack([xs * (2.0 / (W - 1)) - 1.0, ys * (2.0 / (H - 1)) - 1.0], dim=-1)


def tent_cases(torch, seed):
    """(shape name, canonical?, planes, [(case, tent_rows coords, axis)],
    [(case, tent_bilinear ys, xs)]) at the canonical train shape, with
    coordinates from real augmentation draws, and at a ragged shape."""
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.ops import augment as A
    from primia_tpu_torch.ops import image as I

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    cfg = A.AugmentConfig.from_args(Arguments.from_ini(CONFIG))
    B, C, H, W = TRAIN_BATCH, 3, RES, RES
    planes = torch.rand((B * C, H, W), generator=g, device=dev)
    mats = A._affine_mats(g, cfg, B)
    q, p = I.twopass_coords(mats, H, W)
    fy, fx = A._coarse_field(g, B, H, W, H // 8, A._uniform(g, (B,), 0.0, 2.0))
    gy, gx = A._coarse_field(g, B, H, W, 6, A._uniform(g, (B,), 0.0, 0.06 * H))
    rr, cc = I.pixel_grid(H, W, dev)
    sy, sx = I.affine_coords(mats, H, W)
    yield (f"{B}x{C}x{H}x{W}", True, planes,
           [("affine_rows", q, 2), ("affine_cols", p, 1),
            ("dense_cols", rr + fy + gy, 1), ("dense_rows", cc + fx + gx, 2)],
           [("dense_gather", rr + fy + gy, cc + fx + gx), ("affine_gather", sy, sx)])
    B, C, H, W = 3, 2, 60, 72
    planes = torch.rand((B * C, H, W), generator=g, device=dev)
    ys = torch.rand((B, H, W), generator=g, device=dev) * (H + 5.0) - 3.0
    xs = torch.rand((B, H, W), generator=g, device=dev) * (W + 5.0) - 3.0
    yield (f"{B}x{C}x{H}x{W}", False, planes, [("rows", xs, 2), ("cols", ys, 1)], [("gather", ys, xs)])
    # one plane an image, a pixel count no multiple of a block's 512, and
    # positions up to 4 planes past either edge
    B, C, H, W = 2, 1, 37, 45
    planes = torch.rand((B * C, H, W), generator=g, device=dev)
    ys = torch.rand((B, H, W), generator=g, device=dev) * (9.0 * H) - 4.0 * H
    xs = torch.rand((B, H, W), generator=g, device=dev) * (9.0 * W) - 4.0 * W
    yield (f"{B}x{C}x{H}x{W}", False, planes, [("rows_far", xs, 2), ("cols_far", ys, 1)],
           [("gather_far", ys, xs)])


def phase_tent(torch, seed):
    """Phases 4 and 5: K1 (bit for bit) and K2 (max |d| <= 1e-6) against
    their plain versions on the card. Returns their records: at the
    canonical shape, the mean over the train step's four K1 passes, and K2
    at the dense warp's coordinates."""
    import torch.nn.functional as F

    from primia_tpu_torch.ops import cuda_tent as ct

    rec = {"tent_rows": {"max_abs_err": 0.0, "times": []},
           "tent_bilinear": {"max_abs_err": 0.0, "times": []}}
    for shape, canonical, planes, row_cases, gather_cases in tent_cases(torch, seed):
        N, H, W = planes.shape
        B = gather_cases[0][1].shape[0]
        px = N * H * W
        runs = []
        for case, coords, axis in row_cases:
            rr = torch.arange(H, dtype=torch.float32, device=planes.device)[:, None]
            cc = torch.arange(W, dtype=torch.float32, device=planes.device)[None, :]
            ys, xs = (rr.expand(B, H, W), coords) if axis == 2 else (coords, cc.expand(B, H, W))
            runs.append(("tent_rows", case,
                         lambda c=coords, a=axis: ct.tent_rows(planes, c, axis=a),
                         lambda c=coords, a=axis: ct.tent_rows_plain(planes, c, axis=a),
                         grid_for(torch, ys, xs, H, W),
                         bound(4 * (2 * px + B * H * W), 6 * px)))
        for case, ys, xs in gather_cases:
            runs.append(("tent_bilinear", case,
                         lambda y=ys, x=xs: ct.tent_bilinear(planes, y, x),
                         lambda y=ys, x=xs: ct.tent_bilinear_plain(planes, y, x),
                         grid_for(torch, ys, xs, H, W),
                         bound(4 * (2 * px + 2 * B * H * W), 14 * px)))
        for name, case, kern, plain, grid, (bound_ms, bound_by) in runs:
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            err = float((got - want).abs().max())
            check(err <= 1e-6 and (name != "tent_rows" or torch.equal(got, want)),
                  f"{name} differs from plain at {shape} {case}: {err}")
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
            img = planes.reshape(B, N // B, H, W)
            lib = lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                        align_corners=True)
            lib_diff = float((lib().reshape(N, H, W) - got).abs().max())
            call_ms = cuda_ms(torch, kern, 50)
            plain_ms = cuda_ms(torch, plain, 5)
            library_ms = cuda_ms(torch, lib, 50)
            dev_ms = function_device_ms(profile(torch, kern, 20), KERNELS[name]["kernel"], 20)
            say(name, shape=shape, case=case, max_abs_err=err,
                kernel_ms="not measured" if dev_ms is None else f"{dev_ms:.6f}",
                call_ms=f"{call_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
                library_ms=f"{library_ms:.6f}", bound_ms=f"{bound_ms:.6f}", bound_by=bound_by,
                library_max_abs_diff=lib_diff)
            if canonical and case != "affine_gather":
                rec[name]["times"].append(dict(
                    ms=call_ms if dev_ms is None else dev_ms, call_ms=call_ms,
                    plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                    bound_by=bound_by))
    for r in rec.values():
        times = r.pop("times")
        for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms"):
            r[k] = sum(t[k] for t in times) / len(times)
        r["bound_by"] = times[0]["bound_by"]
    return rec


def dcf_int32_ops(torch, alpha, x):
    """INT32-lane operations K4 needs for these inputs: the key walk's at
    every level, the merged evaluation's past the first level where x and
    alpha differ (as many levels as the bit length of alpha ^ x, less
    one)."""
    diff = (alpha.long() ^ x.long()) & 0xFFFFFFFF
    bit_length = torch.frexp(diff.double()).exponent.long()  # 0 where equal
    past = int((bit_length - 1).clamp(min=0).sum())
    return alpha.shape[0] * DCF_LEVELS * DCF_KEY_OPS_PER_LEVEL + past * DCF_EVAL_OPS_PER_LEVEL


def _cuobjdump():
    from primia_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    return tool if tool.is_file() else None


def _sass_function(library, kernel):
    """``cuobjdump -sass`` of the one function of the built ``library`` (a
    ``csrc`` name) whose mangled name holds ``kernel``; None where
    cuobjdump is missing."""
    from primia_tpu_torch.ops import _build

    tool = _cuobjdump()
    if tool is None:
        return None
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path(library))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    funcs = [f for f in sass.split("Function : ")[1:] if kernel in f.split()[0]]
    check(len(funcs) == 1, f"cuobjdump shows no single {kernel}")
    return funcs[0]


_SASS_OP = r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)"


def sass_opcodes(library, kernel, modifiers=False):
    """Opcode counts (by mnemonic before the first dot, or with its
    modifiers) of the one function whose mangled name holds ``kernel``,
    from ``cuobjdump -sass`` of the built ``library``: a loop that is not
    unrolled counts once. None where cuobjdump is missing."""
    import re

    func = _sass_function(library, kernel)
    if func is None:
        return None
    counts = {}
    for m in re.finditer(_SASS_OP, func):
        op = m.group(2) + (m.group(3) if modifiers else "")
        counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def sass_loop_instructions(library, kernel):
    """Instructions of the outermost loop of the function (from the target
    of its widest backward branch to that branch), or None where cuobjdump
    is missing or no branch names its target as an address."""
    import re

    func = _sass_function(library, kernel)
    if func is None:
        return None
    addrs = [int(m.group(1), 16) for m in re.finditer(_SASS_OP, func)]
    loops = [(int(t, 16), int(a, 16)) for a, t in
             re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?BRA\S*\s+0x([0-9a-f]+)", func)
             if int(t, 16) < int(a, 16)]
    if not loops:
        return None
    head, tail = max(loops, key=lambda ht: ht[1] - ht[0])
    return sum(head <= a <= tail for a in addrs)


def resource_usage(library, mangled=False):
    """{kernel: {"REG": n, "SHARED": bytes, "LOCAL": bytes, ...}} of every
    kernel in the built ``library`` (``cuobjdump -res-usage``): registers a
    thread, static shared memory, and local memory (spills). Kernels are
    keyed by their name in ``KERNELS``, or by their mangled names (one
    each for a template's instantiations). None where cuobjdump is
    missing."""
    import re

    from primia_tpu_torch.ops import _build

    tool = _cuobjdump()
    if tool is None:
        return None
    text = subprocess.run([str(tool), "-res-usage", str(_build.library_path(library))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    out = {}
    for m in re.finditer(r"Function ([^\s:]+):\s*\n\s*([^\n]+)", text):
        name = m.group(1)
        if not mangled:
            name = next((k for k in KERNEL_NAMES if k in name), name)
        out[name] = {k: int(v) for k, v in re.findall(r"(\w+(?:\[\d+\])?):(\d+)", m.group(2))}
    return out


def phase_dcf(torch, seed, sm_max_mhz):
    """Phase 8: K4 against its plain version on the card, bit for bit.
    Returns its record, with the times at the largest call of a forward
    at batch 1."""
    from primia_tpu_torch.ops import cuda_dcf as cd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def words(n, high):
        return torch.randint(0, high, (n,), dtype=torch.int32, device=dev, generator=g)

    def random_case(n):
        seeds = torch.randint(-(1 << 31), 1 << 31, (2, n, 4), dtype=torch.int32, device=dev,
                              generator=g)
        return seeds, words(n, 1 << 31), words(n, 2), words(n, 1 << 31)

    boundary = (random_case(5)[0],
                torch.tensor([5, 0, (1 << 31) - 1, 7, 7], dtype=torch.int32, device=dev),
                torch.tensor([0, 1, 0, 1, 0], dtype=torch.int32, device=dev),
                torch.tensor([5, 0, 0, 6, 8], dtype=torch.int32, device=dev))
    peak_int_ops = INT32_LANES * sm_max_mhz * 1e6
    rec = {"max_abs_err": 0.0}
    # the ResNet forward's largest call at batch 1, VGG-16's (its first
    # ReLU: 64 x 224^2), a ragged one and the boundary points
    for name, ops in (("802816", random_case(802_816)), ("3211264", random_case(3_211_264)),
                      ("300", random_case(300)), ("boundary", boundary)):
        seeds, alpha, c, x = ops
        n = alpha.shape[0]
        got = cd.dcf_sign(*ops)
        torch.cuda.synchronize()
        plain = cd.dcf_sign_plain(*ops)
        err = 0.0 if torch.equal(got, plain) else float((got - plain).abs().max())
        check(err == 0.0, f"dcf_sign differs from plain at {name}: {err}")
        want = torch.where(x.long() < alpha.long(), 1 - 2 * c.long(), torch.zeros_like(x.long()))
        check(torch.equal(got.sum(0), want), f"dcf_sign breaks the DCF contract at {name}")
        if name == "boundary":
            check(got.sum(0).tolist() == [0, 0, 1, -1, 0], "dcf_sign boundary points")
        int_ops = dcf_int32_ops(torch, alpha, x)
        t_ops = int_ops / peak_int_ops * 1e3
        t_bytes = n * DCF_BYTES_PER_ELEMENT / PEAK_BYTES_PER_S * 1e3
        bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        call_ms = cuda_ms(torch, lambda: cd.dcf_sign(*ops), 20)
        plain_ms = cuda_ms(torch, lambda: cd.dcf_sign_plain(*ops), 3, warmup=1)
        dev_ms = function_device_ms(profile(torch, lambda: cd.dcf_sign(*ops), 10),
                                    KERNELS["dcf_sign"]["kernel"], 10)
        say("dcf_sign", n=n, case=name, max_abs_err=err,
            kernel_ms="not measured" if dev_ms is None else f"{dev_ms:.6f}",
            call_ms=f"{call_ms:.6f}", plain_ms=f"{plain_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
            bound_by=f"{bound_by} (int32)" if bound_by == "operations" else bound_by,
            int32_lane_ops=int_ops, bytes=n * DCF_BYTES_PER_ELEMENT, library_ms="none")
        if name == "802816":
            rec.update(ms=call_ms if dev_ms is None else dev_ms, call_ms=call_ms,
                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=None)
    sass = sass_opcodes("dcf", "dcf_sign_kernel")
    say("dcf_sign", sass_opcodes="not available" if sass is None else json.dumps(sass))
    return rec


def timed_record(torch, name, kern, plain, library, bnd, iters=20, plain_iters=5):
    """Times of ``kern`` (one call of the port's function), its plain
    version and the library yardstick (None: there is none), beside the
    bound ``bnd`` = (bound ms, "bytes" or "operations"): kernel ms
    (profiler, every kernel the call launches), call ms (CUDA events),
    plain ms, library ms."""
    call_ms = cuda_ms(torch, kern, iters)
    plain_ms = cuda_ms(torch, plain, plain_iters, warmup=1)
    library_ms = None if library is None else cuda_ms(torch, library, iters)
    dev_ms = function_device_ms(profile(torch, kern, 10), KERNELS[name]["kernel"], 10)
    bound_ms, bound_by = bnd
    return dict(ms=call_ms if dev_ms is None else dev_ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                kernel_ms="not measured" if dev_ms is None else dev_ms)


def _say_times(name, r, **kw):
    fmt = lambda v: v if isinstance(v, str) else ("none" if v is None else f"{v:.6f}")  # noqa: E731
    say(name, **kw, **{k: fmt(r[k]) for k in ("kernel_ms", "call_ms", "plain_ms", "library_ms",
                                               "bound_ms")}, bound_by=r["bound_by"],
        x_bound=f"{r['ms'] / r['bound_ms']:.3f}")


def mean_record(records):
    out = {k: sum(r[k] for r in records) / len(records)
           for k in ("ms", "call_ms", "plain_ms", "bound_ms")}
    libs = [r["library_ms"] for r in records]
    out["library_ms"] = None if None in libs else sum(libs) / len(libs)
    out["bound_by"] = records[0]["bound_by"]
    return out


def phase_wgrad(torch, seed):
    """Phase 9: K7 against its plain version on the card, at the train step's two
    shapes (layer2's 128 channels at 28x28 and layer3's 256 at 14x14, batch
    200) and ragged ones (channels not multiples of the 64-channel box, H
    not of the box's rows, W not of 16). Within 1e-3 of max |dW| (the JAX
    tests' limit): both sum the same bf16 products in float32, in other
    orders. Two calls on the same operands must give the same bits. Also
    prints each shape's plan and achieved TFLOP/s, the wgrad library's
    registers, shared memory and spills (cuobjdump -res-usage), and the SASS
    opcode counts of conv3x3_wgrad_kernel, which must hold HGMMA (wgmma) and
    UTMALDG (TMA loads). Returns the record: the mean of the two train-step
    shapes."""
    from primia_tpu_torch.ops import cuda_wgrad as cw

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's float32 products
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def operand(*shape):
        t = torch.randn(shape, generator=g, device=dev)
        return t.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)

    records, worst = [], 0.0
    # the train step's two shapes, the DP ghost step's layer3 at batch 512,
    # VGG-16's four at batch 64 (the 112^2 one twice the largest map so far),
    # and two ragged ones
    for B, ci, co, H, W in ((TRAIN_BATCH, 128, 128, 28, 28), (TRAIN_BATCH, 256, 256, 14, 14),
                            (DP_BATCH, 256, 256, 14, 14), *VGG_K7_SHAPES, (3, 64, 512, 9, 11),
                            (2, 72, 136, 13, 28)):
        x, gy = operand(B, ci, H, W), operand(B, co, H, W)
        got = cw.conv3x3_wgrad(x, gy)
        torch.cuda.synchronize()
        want = cw.conv3x3_wgrad_plain(x, gy)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        check(err <= 1e-3 * scale, f"conv3x3_wgrad differs from plain at {(B, ci, co, H, W)}: "
              f"max |d| {err}, max |dW| {scale}")
        check(torch.equal(cw.conv3x3_wgrad(x, gy), got),
              f"conv3x3_wgrad gives other bits on a second call at {(B, ci, co, H, W)}")
        worst = max(worst, err)
        lib = lambda: torch.nn.grad.conv2d_weight(x, (co, ci, 3, 3), gy, padding=1)  # noqa: E731
        lib_err = float((lib().float() - want).abs().max())
        flops = 2 * 9 * ci * co * B * H * W
        r = timed_record(torch, "conv3x3_wgrad", lambda: cw.conv3x3_wgrad(x, gy),
                         lambda: cw.conv3x3_wgrad_plain(x, gy), lib,
                         bound(2 * (x.numel() + gy.numel()) + 4 * co * ci * 9, flops,
                               PEAK_BF16_TENSOR_OPS_PER_S))
        plan = cw.card_plan(dev, B, ci, co, H, W)
        check(plan.blocks <= plan.wave, f"conv3x3_wgrad's plan at {(B, ci, co, H, W)} is "
              f"{plan.blocks} blocks, past one wave of {plan.wave}")
        _say_times("conv3x3_wgrad", r, shape=f"B{B}:ci{ci}:co{co}:{H}x{W}", max_abs_err=err,
                   max_abs_dw=scale, library_max_abs_diff=lib_err, gflop=flops / 1e9,
                   tflop_per_s=f"{flops / (r['ms'] * 1e-3) / 1e12:.2f}",
                   library_tflop_per_s=f"{flops / (r['library_ms'] * 1e-3) / 1e12:.2f}",
                   deterministic="yes", blocks=plan.blocks,
                   plan=json.dumps(dataclasses.asdict(plan), separators=(",", ":")))
        if B == TRAIN_BATCH:
            records.append(r)
    res = resource_usage("wgrad")
    say("conv3x3_wgrad", resource_usage="not available" if res is None else json.dumps(res))
    sass = sass_opcodes("wgrad", "conv3x3_wgrad_kernel")
    say("conv3x3_wgrad", sass_opcodes="not available" if sass is None else json.dumps(sass))
    check(sass is not None and sass.get("HGMMA", 0) > 0 and sass.get("UTMALDG", 0) > 0,
          f"conv3x3_wgrad_kernel's SASS lacks HGMMA or UTMALDG: {sass}")
    return {**mean_record(records), "max_abs_err": worst}


BN_TRAIN_SHAPES = {"stem": (TRAIN_BATCH, 64, 112, 112), "layer3": (TRAIN_BATCH, 256, 14, 14),
                   "layer4": (TRAIN_BATCH, 512, 7, 7)}
BN_EPS, BN_MOMENTUM = 1e-5, 0.1
BN_LAUNCHES = ("bn_sums", "bn_finalize", "bn_apply", "bn_grad_sums", "bn_grad_finalize", "bn_dx")


def _bf16_ulp(torch, t):
    """The spacing of bfloat16 values at each |t| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(t.float().abs().clamp_min(2.0 ** -126))) - 7)


def phase_bn(torch, seed):
    """Phase 10: the switched batch norm's six launches against their plain
    versions on the same inputs, at the train step's stem, layer3 and
    layer4 BN activations (batch 200) and a ragged (3, 24, 5, 7). K8's sums
    and gradient sums: their partials summed within 1e-5 of the same sums
    of absolute values (float32 sums of the same bf16 values in other
    orders). The finalizes: their own sums within 1e-6 of the partials'
    absolute sums; from those sums mean, var, r, inv, off, the running
    statistics, dgamma, A, B and D within 1e-6 of each row's largest
    |value| (the same roundings; rsqrt may differ in its last bit). apply
    and dx: y and dx within one bf16 ulp. Every output bit-identical over
    two calls. Times per launch beside its bound and its library
    yardstick, and a whole forward + backward beside F.batch_norm's.
    Returns the six records, each the mean of the three train shapes."""
    import torch.nn.functional as F

    from primia_tpu_torch.ops import cuda_bn as cb

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def operand(shape, scale, shift):
        t = torch.randn(shape, generator=g, device=dev) * scale + shift
        return t.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def vec(C, lo, hi):
        return torch.rand(C, generator=g, device=dev) * (hi - lo) + lo

    records = {n: [] for n in BN_LAUNCHES}
    worst = {n: 0.0 for n in BN_LAUNCHES}
    for label, shape in [*BN_TRAIN_SHAPES.items(), *CONV_BN_SHAPES.items(),
                         ("ragged", (3, 24, 5, 7))]:
        x, gy = operand(shape, 1.0, 0.5), operand(shape, 0.1, 0.05)
        C = shape[1]
        n = x.numel() // C
        gamma, beta, rm, rv = vec(C, 0.5, 1.5), vec(C, -0.2, 0.2), vec(C, -0.1, 0.1), vec(C, 0.5, 1.5)
        rm_k, rv_k, rm_p, rv_p = rm.clone(), rv.clone(), rm.clone(), rv.clone()

        part = cb.channel_partials(x)
        stats = cb.bn_finalize(part, gamma, beta, n, BN_EPS, rm_k, rv_k, BN_MOMENTUM)
        _, _, mean, var, r, inv, off = stats.unbind(0)
        y = cb.bn_apply(x, inv, off)
        gpart = cb.grad_channel_partials(gy, x)
        coef = cb.bn_grad_finalize(gpart, gamma, mean, r, n)
        A, B, D = coef[3], coef[4], coef[5]
        dx = cb.bn_dx(gy, x, A, B, D)
        torch.cuda.synchronize()

        def rel(got, want):
            return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                       for a, b in zip(got.reshape(-1, C), want.reshape(-1, C)))

        errs = {}
        for name, p, plain, mag in (
                ("bn_sums", part, cb.channel_sums_plain(x), cb.channel_sums_plain(x.abs())),
                ("bn_grad_sums", gpart, cb.grad_channel_sums_plain(gy, x),
                 cb.grad_channel_sums_plain(gy.abs(), x.abs()))):
            d = (p.sum(0) - torch.stack(plain)).abs()
            check(bool((d <= 1e-5 * torch.stack(mag) + 1e-6).all()),
                  f"{name} differs from plain at {shape}: max |d| {float(d.max())}")
            errs[name] = float(d.max())
        for name, got, p in (("bn_finalize", stats, part), ("bn_grad_finalize", coef, gpart)):
            d = (got[:2] - p.sum(0)).abs()
            check(bool((d <= 1e-6 * p.abs().sum(0) + 1e-9).all()),
                  f"{name}'s sums differ from the partials' at {shape}: max |d| {float(d.max())}")
        want = cb.bn_finalize_plain(stats[:2], gamma, beta, n, BN_EPS, rm_p, rv_p, BN_MOMENTUM)
        want_g = cb.bn_grad_finalize_plain(coef[:2], gamma, mean, r, n)
        errs["bn_finalize"] = max(rel(stats[2:], want[2:]), rel(rm_k, rm_p), rel(rv_k, rv_p))
        errs["bn_grad_finalize"] = rel(coef[2:], want_g[2:])
        for name in ("bn_finalize", "bn_grad_finalize"):
            check(errs[name] <= 1e-6, f"{name} differs from plain at {shape}: {errs[name]} "
                  "of a row's max")
        for name, got, ref in (("bn_apply", y, cb.bn_apply_plain(x, inv, off)),
                               ("bn_dx", dx, cb.bn_dx_plain(gy, x, A, B, D))):
            d = (got.float() - ref.float()).abs()
            check(got.is_contiguous(memory_format=torch.channels_last)
                  and bool((d <= _bf16_ulp(torch, ref)).all()),
                  f"{name} differs from plain at {shape} by more than a bf16 ulp: {float(d.max())}")
            errs[name] = float(d.max())
        again = (cb.channel_partials(x), cb.bn_finalize(part, gamma, beta, n, BN_EPS),
                 cb.bn_apply(x, inv, off), cb.grad_channel_partials(gy, x),
                 cb.bn_grad_finalize(gpart, gamma, mean, r, n), cb.bn_dx(gy, x, A, B, D))
        first = (part, stats, y, gpart, coef, dx)
        check(all(torch.equal(a, b) for a, b in zip(again, first)),
              f"the BN launches give other bits on a second call at {shape}")
        for k, v in errs.items():
            worst[k] = max(worst[k], v)

        # times; the library yardsticks compute the same functions in PyTorch
        # (the port never calls them): batch_norm_stats the sums and the
        # finalize's mean and invstd, backward_reduce the gradient sums and
        # the gradients of gamma and beta
        invstd = torch.rsqrt(var + BN_EPS)
        sum_dy, sum_dy_xmu = coef[0].clone(), (coef[1] - mean * coef[0]).contiguous()
        count = torch.full((1,), n, dtype=torch.int32, device=dev)
        pb, vb = 4 * part.numel(), 4 * C
        cases = (
            ("bn_sums", lambda: cb.channel_partials(x), lambda: cb.channel_sums_plain(x),
             lambda: torch.batch_norm_stats(x, BN_EPS), bound(2 * x.numel() + 8 * C, 3 * x.numel())),
            ("bn_finalize",
             lambda: cb.bn_finalize(part, gamma, beta, n, BN_EPS, rm_k, rv_k, BN_MOMENTUM),
             lambda: cb.bn_finalize_plain(part.sum(0), gamma, beta, n, BN_EPS, rm_p, rv_p,
                                          BN_MOMENTUM),
             None, bound(pb + 7 * vb + 6 * vb, part.numel() + 12 * C)),
            ("bn_apply", lambda: cb.bn_apply(x, inv, off), lambda: cb.bn_apply_plain(x, inv, off),
             lambda: torch.batch_norm_elemt(x, gamma, beta, mean, invstd, BN_EPS),
             bound(4 * x.numel() + 2 * vb, 2 * x.numel())),
            ("bn_grad_sums", lambda: cb.grad_channel_partials(gy, x),
             lambda: cb.grad_channel_sums_plain(gy, x),
             lambda: torch.batch_norm_backward_reduce(gy, x, mean, invstd, gamma, True, True,
                                                      True),
             bound(4 * x.numel() + 8 * C, 3 * x.numel())),
            ("bn_grad_finalize", lambda: cb.bn_grad_finalize(gpart, gamma, mean, r, n),
             lambda: cb.bn_grad_finalize_plain(gpart.sum(0), gamma, mean, r, n), None,
             bound(4 * gpart.numel() + 6 * vb + 3 * vb, gpart.numel() + 12 * C)),
            ("bn_dx", lambda: cb.bn_dx(gy, x, A, B, D), lambda: cb.bn_dx_plain(gy, x, A, B, D),
             lambda: torch.batch_norm_backward_elemt(gy, x, mean, invstd, gamma, sum_dy,
                                                     sum_dy_xmu, count),
             bound(6 * x.numel() + 3 * vb, 4 * x.numel())))
        for name, kern, plain, lib, bnd in cases:
            try:  # a yardstick PyTorch refuses at these operands is none
                lib is None or lib()
            except (RuntimeError, TypeError) as e:
                say(name, shape="x".join(map(str, shape)), library="refused",
                    error=json.dumps(str(e).splitlines()[0]))
                lib = None
            rt = timed_record(torch, name, kern, plain, lib, bnd)
            _say_times(name, rt, shape="x".join(map(str, shape)), layer=label,
                       max_abs_err=errs[name], deterministic="yes")
            if label in BN_TRAIN_SHAPES:
                records[name].append(rt)

        # a whole forward + backward: the port's six launches, and F.batch_norm
        # (cuDNN's or PyTorch's own kernels) on the same operands
        xg, gg, bg = (t.detach().clone().requires_grad_(True) for t in (x, gamma, beta))

        def port():
            yy, _, _ = cb.bn_train(xg, gg, bg, BN_EPS, rm_k, rv_k, BN_MOMENTUM)
            return torch.autograd.grad(yy, (xg, gg, bg), gy)

        def library():
            yy = F.batch_norm(xg, rm_p, rv_p, gg, bg, training=True, momentum=BN_MOMENTUM,
                              eps=BN_EPS)
            return torch.autograd.grad(yy, (xg, gg, bg), gy)

        port_ms, lib_ms = cuda_ms(torch, port, 20), cuda_ms(torch, library, 20)
        whole_bound = bound(16 * x.numel(), 0)[0]
        say("bn_train", shape="x".join(map(str, shape)), layer=label,
            forward_backward_ms=f"{port_ms:.6f}", f_batch_norm_ms=f"{lib_ms:.6f}",
            bound_ms=f"{whole_bound:.6f}", bound_by="bytes")
    return {k: {**mean_record(rs), "max_abs_err": worst[k]} for k, rs in records.items()}


# K5's work an element besides its 8 bytes (csrc/noise.cu). A Philox-4x32-10
# block serves four elements: its 10 rounds make 19 32x32->64-bit products
# (round 0's second multiplies a zero word), 38 results of the INT32
# multiplier (64 a clock an SM), 9.5 an element, which the SASS must hold as
# at least 19 IMAD.WIDE.U32. A pair (two elements) issues two operations to
# the 16-a-clock unit of special functions and conversions: sqrtf's MUFU.RSQ
# and the F2I of sincosf's quadrant (logf and sincosf are otherwise
# polynomials on the FMA pipe). NOISE_ISSUE_PER_ELEMENT: the instructions
# the vector path of the grid-stride loop issues for a group of four (the
# loads and stores of 16 bytes, sincosf's short reduction, sqrtf's common
# branch), counted on the SASS listing of gaussian_noise_kernel<float, 0>,
# over 4; the loop's SASS must hold at least as many. An SM issues 4 x 32 a
# clock.
NOISE_IMUL_PER_ELEMENT = 9.5
NOISE_MUFU_PER_ELEMENT = 1.0
NOISE_ISSUE_PER_ELEMENT = 66.25  # 265 a group
NOISE_KERNEL_F32 = "gaussian_noise_kernelIfLi0EE"  # the float32 noise instantiation
NOISE_UNALIGNED = (7, 3, 37, 45)  # rows of 4,995: off the 16-byte grid, a ragged last group
NOISE_RAGGED_BF16 = (5, 7, 13)  # rows of 91 bfloat16


def _noise_bound(nel, sm_max_mhz):
    """K5's least time at ``nel`` float32 elements: the largest of its
    bytes (8 an element at 3.35 TB/s), its multiplier results, its MUFU
    operations and its issued instructions at the card's maximum SM clock;
    ((ms, "bytes" or "operations"), {term: ms})."""
    clock = sm_max_mhz * 1e6
    terms = {"bytes": 8 * nel / PEAK_BYTES_PER_S * 1e3,
             "imul": nel * NOISE_IMUL_PER_ELEMENT / (132 * 64 * clock) * 1e3,
             "mufu": nel * NOISE_MUFU_PER_ELEMENT / (132 * 16 * clock) * 1e3,
             "issue": nel * NOISE_ISSUE_PER_ELEMENT / (132 * 4 * 32 * clock) * 1e3}
    t_ops = max(terms["imul"], terms["mufu"], terms["issue"])
    return ((terms["bytes"], "bytes") if terms["bytes"] >= t_ops else (t_ops, "operations")), terms


def _noise_stats(torch, out, x, sigma):
    """Moments of the noise (out - x) / sigma over every element: mean,
    std, the correlation of each pair's two elements (its cosine and sine
    branch; rows of even length, so pairs are consecutive), the share
    beyond 3 sigma and the excess kurtosis."""
    z = ((out - x) / sigma).double().reshape(-1)
    zc = z - z.mean()
    var = float(zc.square().mean())
    pairs = zc.reshape(-1, 2)
    return dict(mean=float(z.mean()), std=float(z.std()),
                pair_corr=float((pairs[:, 0] * pairs[:, 1]).mean()) / var,
                tail_3sigma=float((z.abs() > 3.0).double().mean()),
                excess_kurtosis=float(zc.pow(4).mean()) / var ** 2 - 3.0)


def phase_noise(torch, seed, sm_max_mhz):
    """Phase 11: K5 on its own path and against its plain version on the card:
    one call at the canonical train batch (200 x 3 x 224 x 224 float32) with
    the counters set to 0 around it; there, at an unaligned float32 case
    (rows of 4,995) and at a ragged bfloat16 case, the uniforms bit for bit,
    the output within 1e-5 (float32; sigma 0.1: the two differ at most in the
    last bits of log, sin, cos and sqrt) or one bf16 ulp, the same bits over
    two calls; the noise's moments at 30.1 M samples (mean and std within
    0.01, the pair correlation under 0.002, the share beyond 3 sigma 0.0027
    +- 0.0002, the excess kurtosis within 0.02), rows distinct. Times beside
    the four-term bound, ``torch.normal`` as the library call and a copy of
    the same bytes as the card's achievable rate; the SASS counts and
    registers. Returns (record, launches)."""
    from primia_tpu_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    sigma, key = 0.1, seed + 0x5EED
    x = torch.rand((TRAIN_BATCH, 3, RES, RES), generator=g, device=dev)
    reset_launches()
    out = ck.add_gaussian_noise(x, key, sigma)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches == idle_launches(gaussian_noise=1), f"noise path launches {launches}")
    cases = [(x, out), (torch.rand(NOISE_UNALIGNED, generator=g, device=dev), None),
             (torch.rand(NOISE_RAGGED_BF16, generator=g, device=dev).to(torch.bfloat16), None)]
    errs = {}
    for xc, oc in cases:
        name = "x".join(map(str, xc.shape)) + ("" if xc.dtype == torch.float32 else "_bf16")
        oc = ck.add_gaussian_noise(xc, key, sigma) if oc is None else oc
        torch.cuda.synchronize()
        B, n = xc.shape[0], xc.numel() // xc.shape[0]
        got, want = ck.noise_uniforms(xc, key), ck.noise_uniforms_plain(B, n, key, dev)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"K5's uniforms differ from plain at {name}")
        plain = ck.add_gaussian_noise_plain(xc, key, sigma).float()
        d = (oc.float() - plain).abs()
        errs[name] = float(d.max())
        if xc.dtype == torch.float32:
            check(errs[name] <= 1e-5, f"gaussian_noise differs from plain at {name}: {errs[name]}")
        else:
            check(bool((d <= 2.0 ** -7 * oc.float().abs() + 1e-6).all()),
                  f"gaussian_noise ({name}) more than 1 ulp from plain: {errs[name]}")
        check(torch.equal(oc, ck.add_gaussian_noise(xc, key, sigma)),
              f"gaussian_noise gives other bits on a second call at {name}")
    st = _noise_stats(torch, out, x, sigma)
    check(abs(st["mean"]) < 0.01 and abs(st["std"] - 1.0) < 0.01
          and abs(st["pair_corr"]) < 0.002 and abs(st["tail_3sigma"] - 0.0027) < 0.0002
          and abs(st["excess_kurtosis"]) < 0.02 and not torch.equal(out[0], out[1]),
          f"gaussian_noise: moments {st} off, or rows equal")
    nel = x.numel()
    bnd, terms = _noise_bound(nel, sm_max_mhz)
    lib_g = torch.Generator(device=dev).manual_seed(seed)
    r = timed_record(torch, "gaussian_noise", lambda: ck.add_gaussian_noise(x, key, sigma),
                     lambda: ck.add_gaussian_noise_plain(x, key, sigma),
                     lambda: torch.normal(x, sigma, generator=lib_g), bnd, plain_iters=2)
    dst = torch.empty_like(x)
    copy_ms = cuda_ms(torch, lambda: dst.copy_(x), 20)
    _say_times("gaussian_noise", r, shape="x".join(map(str, x.shape)), max_abs_err=errs,
               uniforms_equal=True, **{k: f"{v:.6f}" for k, v in st.items()},
               **{f"{k}_bound_ms": f"{v:.6f}" for k, v in terms.items()},
               library="torch.normal")
    say("gaussian_noise", reference="copy_ (not the bound)", bytes=8 * nel,
        copy_ms=f"{copy_ms:.6f}", copy_tb_per_s=f"{8 * nel / copy_ms / 1e9:.4f}",
        kernel_over_copy=f"{r['ms'] / copy_ms:.4f}")
    sass = sass_opcodes("noise", NOISE_KERNEL_F32, modifiers=True)
    loop = sass_loop_instructions("noise", NOISE_KERNEL_F32)
    res = resource_usage("noise", mangled=True)
    say("gaussian_noise", sass_opcodes="not available" if sass is None else json.dumps(sass),
        loop_instructions=loop, resources=json.dumps(res))
    if sass is not None:
        wide = sum(v for k, v in sass.items() if k.startswith("IMAD.WIDE.U32"))
        xu = sum(v for k, v in sass.items() if k.startswith(("MUFU.RSQ", "F2I.NTZ")))
        check(2 * wide >= 4 * NOISE_IMUL_PER_ELEMENT and xu >= 4 * NOISE_MUFU_PER_ELEMENT,
              f"K5's SASS holds {wide} IMAD.WIDE.U32 and {xu} MUFU.RSQ and F2I.NTZ, fewer "
              "than its bound counts")
        check(loop is None or loop >= 4 * NOISE_ISSUE_PER_ELEMENT,
              f"K5's loop holds {loop} instructions, fewer than its bound counts")
    return {**r, "max_abs_err": max(errs.values())}, launches


def attention_least(Bw, h, L, d, itemsize, masked):
    """The least time of each of the window-attention kernel pair's two
    calls, from what its design must move and compute: the forward reads
    q, k, v, the float32 bias (and, masked, the (nW, L) int32 region ids,
    ``masked`` windows) and writes o and the rows' float32 log-sum-exp; the
    backward reads q, k, v, dO, the bias, the ids and the log-sum-exp and
    writes dq, dk, dv and the float32 bias gradient (it never reads o).
    FLOPs 4 Bw h L^2 d forward and 8 backward at the dense bf16 peak (P's
    recompute not counted). ``benchmark/attention.py:least_seconds``
    counts o again in the backward and the bias in q's dtype."""
    t, lse, b = itemsize * Bw * h * L * d, 4 * Bw * h * L, 4 * h * L * L
    ids, mma = 4 * masked * L, Bw * h * L * L * d
    return (bound(4 * t + lse + b + ids, 4 * mma, PEAK_BF16_TENSOR_OPS_PER_S),
            bound(7 * t + lse + 2 * b + ids, 8 * mma, PEAK_BF16_TENSOR_OPS_PER_S))


def _kernel_label(mangled):
    """``fmha_..._kernel<NT>`` from a kernel's mangled name."""
    import re

    m = re.search(r"(fmha_[A-Za-z0-9_]*?_kernel)(?:ILi(\d+)E)?", mangled)
    if m is None:
        return mangled
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def phase_window_attention(torch, seed):
    """Phase 11b: Swin's window attention on the port's kernels
    (``ops/cuda_attention.py``, ``csrc/window_attention.cu``): the source's
    nvcc seconds (a build into an empty directory) and each kernel's
    registers and spills (cuobjdump); then at Swin-B's stage-1 shape (Bw
    4096 = 64 images x 64 windows, h 4) and stage-3 shape (Bw 256, h 16), L
    144, d 32, bf16 operands laid out as the model hands them (strided
    views of the qkv output), unshifted and shifted: o and the four
    gradients against the plain version in float64 (norms' gaps under
    1e-2, 2e-2 for dq and dk, 1e-4 for the bias gradient: P and dS are
    rounded to bf16 before their products), the same bits over two
    backward calls; each direction's device ms (profiler, every kernel the
    call launches) and call ms (CUDA events) beside its own least time
    (:func:`attention_least`), the plain version's ms and, as library_ms,
    ``F.scaled_dot_product_attention`` on the memory-efficient backend with
    the bias (and mask) summed and cast as the port used to (a yardstick
    the port no longer calls); both directions together beside
    ``benchmark/attention.py:least_seconds``; forward and backward of the
    float32 build at the stage-3 shape, masked, within 1e-5 of float64.
    Returns the records of ``window_attention_fwd`` and ``_bwd`` at the
    unshifted stage-1 shape, the train step's largest call."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from benchmark import attention
    from primia_tpu_torch.nn import swin
    from primia_tpu_torch.ops import _build
    from primia_tpu_torch.ops import cuda_attention as ca

    built, _build.BUILD_DIR = _build.BUILD_DIR, ROOT / "build" / "chip_smoke" / "nvcc"
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        _build.build(["window_attention"])
        say("window_attention", nvcc_seconds=f"{time.perf_counter() - t0:.3f}")
    finally:
        _build.BUILD_DIR = built
    usage = resource_usage("window_attention", mangled=True)
    for mangled, res in sorted((usage or {}).items()):
        say("window_attention", kernel=_kernel_label(mangled),
            **{k.lower(): res[k] for k in ("REG", "STACK", "LOCAL", "SHARED") if k in res})
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    L, d = 144, 32

    def operands(B, nW, h, shifted, dtype):
        qkv = torch.randn((B, nW, L, 3 * h * d), generator=g, device=dev).to(dtype)
        q, k, v = (t.transpose(2, 3) for t in qkv.reshape(B, nW, L, 3, h, d).unbind(3))
        table = torch.randn(((2 * 12 - 1) ** 2, h), generator=g, device=dev) * 0.02
        bias = table[swin.relative_position_index(12).to(dev)].permute(2, 0, 1)
        side = int(nW ** 0.5) * 12
        regions = swin.shift_regions(side, 12, 6).to(dev) if shifted else None
        do = torch.randn((B, nW, L, h, d), generator=g, device=dev).to(dtype)
        return q, k, v, bias, regions, do.permute(0, 1, 3, 2, 4)

    def gaps(q, k, v, bias, regions, do):
        """Each output's relative norm gap and largest absolute gap from
        float64."""
        leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
        o = ca.window_attention(*leaves, regions)
        got = (o, *torch.autograd.grad(o, leaves, do))
        ref = [t.detach().double().requires_grad_() for t in (q, k, v, bias)]
        want = ca.window_attention_plain(*ref, regions)
        want = (want, *torch.autograd.grad(want, ref, do.double()))
        diffs = {n: (a.detach().double() - b.detach(), b.detach())
                 for n, a, b in zip(("o", "dq", "dk", "dv", "dbias"), got, want)}
        return ({n: float(e.norm() / b.norm()) for n, (e, b) in diffs.items()},
                {n: float(e.abs().max()) for n, (e, _) in diffs.items()})

    def library(q, k, v, bias, regions):
        B, nW, h = q.shape[:3]
        q, k, v = (t.contiguous() for t in (q, k, v))
        if regions is None:
            attn, shape = bias.unsqueeze(0), (B * nW, h, L, d)
        else:
            mask = ca.region_mask(regions)
            attn = (bias.unsqueeze(0) + torch.where(mask.unsqueeze(1), ca.MASK_VALUE, 0.0)
                    ).reshape(1, nW * h, L, L)
            shape = (B, nW * h, L, d)
        q, k, v = (t.reshape(shape).requires_grad_() for t in (q, k, v))
        attn = attn.to(q.dtype).contiguous().requires_grad_()
        return q, k, v, attn

    def backward_ms(fn, leaves, grad):
        """ms of the backward alone: one forward kept, its graph retained."""
        out = fn()
        return cuda_ms(torch, lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True),
                       3, warmup=1)

    tol = {"o": 1e-2, "dq": 2e-2, "dk": 2e-2, "dv": 1e-2, "dbias": 1e-4}
    rec = {}
    for stage, B, nW, h in (("stage1", 64, 64, 4), ("stage3", 64, 4, 16)):
        for shifted in (False, True):
            case = f"{stage}_{'shifted' if shifted else 'regular'}"
            q, k, v, bias, regions, do = operands(B, nW, h, shifted, torch.bfloat16)
            gap, err = gaps(q, k, v, bias, regions, do)
            check(all(gap[n] < tol[n] for n in gap), f"window attention at {case}: {gap}")
            b32 = bias.float()
            _, lse = ca.forward(q, k, v, b32, regions)
            first = ca.backward(q, k, v, do, b32, regions, lse)
            check(all(torch.equal(a, b) for a, b in
                      zip(first, ca.backward(q, k, v, do, b32, regions, lse))),
                  f"window attention's backward gives other bits on a second call at {case}")
            calls = {"fwd": lambda: ca.forward(q, k, v, b32, regions),
                     "bwd": lambda: ca.backward(q, k, v, do, b32, regions, lse)}
            leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
            lib = library(q, k, v, bias, regions)

            def plain_fwd():
                return ca.window_attention_plain(*leaves, regions)

            def library_fwd():
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    return F.scaled_dot_product_attention(*lib[:3], attn_mask=lib[3])

            lib_grad = library_fwd().detach()
            plain_ms = {"fwd": cuda_ms(torch, plain_fwd, 3, warmup=1),
                        "bwd": backward_ms(plain_fwd, leaves, do)}
            library_ms = {"fwd": cuda_ms(torch, library_fwd, 10),
                          "bwd": backward_ms(library_fwd, lib, lib_grad)}
            least = dict(zip(("fwd", "bwd"),
                             attention_least(B * nW, h, L, d, 2, nW if shifted else 0)))
            for way, fn in calls.items():
                name = f"window_attention_{way}"
                call_ms = cuda_ms(torch, fn, 20)
                dev_ms = function_device_ms(profile(torch, fn, 10), KERNELS[name]["kernel"], 10)
                r = dict(ms=call_ms if dev_ms is None else dev_ms, call_ms=call_ms,
                         kernel_ms="not measured" if dev_ms is None else dev_ms,
                         plain_ms=plain_ms[way], library_ms=library_ms[way],
                         bound_ms=least[way][0], bound_by=least[way][1],
                         max_abs_err=err["o"] if way == "fwd" else
                         max(err[n] for n in ("dq", "dk", "dv", "dbias")))
                _say_times(name, r, case=case, Bw=B * nW, heads=h)
                if case == "stage1_regular":
                    rec[name] = r
                rec[f"{case}_{way}"] = r
            pair = rec[f"{case}_fwd"]["ms"] + rec[f"{case}_bwd"]["ms"]
            bench_ms = attention.least_seconds(B * nW, h, L, d, 2, nW if shifted else 0) * 1e3
            own_ms = least["fwd"][0] + least["bwd"][0]
            say("window_attention", case=case, pair_ms=f"{pair:.6f}",
                benchmark_least_ms=f"{bench_ms:.6f}", x_benchmark_least=f"{pair / bench_ms:.3f}",
                own_least_ms=f"{own_ms:.6f}", x_own_least=f"{pair / own_ms:.3f}",
                **{f"gap_{n}": f"{v:.3g}" for n, v in gap.items()}, deterministic="yes")
    q, k, v, bias, regions, do = operands(64, 4, 16, True, torch.float32)
    gap, _ = gaps(q, k, v, bias, regions, do)
    check(all(x < 1e-5 for x in gap.values()), f"window attention, float32 build: {gap}")
    fwd32 = cuda_ms(torch, lambda: ca.forward(q, k, v, bias.float(), regions), 5)
    say("window_attention", case="stage3_shifted_f32", call_ms_forward=f"{fwd32:.6f}",
        **{f"gap_{n}": f"{v:.3g}" for n, v in gap.items()})
    return rec["window_attention_fwd"], rec["window_attention_bwd"]


def phase_swin_train(torch, seed):
    """Phase 11c: one Swin-B train step at the cell swin_b384.train's shapes
    (``benchmark/configs/swin_b384.json``: batch 64, 384 px) after a
    warm-up step, its launch counters reset right before it. Returns those
    counters, the path ``swin_train``: 24 forward and 24 backward
    window-attention launches, one each a block, and 53 forward and 53
    backward layer-norm launches. Then one more step under the profiler:
    no roll and no PyTorch layer-norm kernel among its device operations;
    its device ms by category and its 16 largest kernels."""
    import warnings

    from benchmark import common
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.train.optim import make_optimizer
    from primia_tpu_torch.train.steps import build_train_step

    dev = torch.device("cuda")
    cfg = common.load_json(common.BENCH_DIR / "configs" / "swin_b384.json")
    args = Arguments.from_dict(cfg["args"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no pretrained Swin weights: a random start
        model = create_model(args, num_classes=cfg["architecture"]["num_classes"], device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    imgs, labels = common.make_images(g, args.batch_size, args.train_resolution)
    mean, std = common.mean_std(imgs)
    step = build_train_step(model, make_optimizer(args, model), args, mean, std, device=dev)
    mask = torch.ones(args.batch_size)
    step(g, imgs, labels, mask, args.lr)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    step(g, imgs, labels, mask, args.lr)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    want = {"window_attention_fwd": 24, "window_attention_bwd": 24, "swin_norm_fwd": 53,
            "swin_norm_bwd": 53}
    check(all(launches[n] == c for n, c in want.items()),
          f"a Swin-B train step launched {launches}, expected {want}")
    say("swin_train", batch=args.batch_size, resolution=args.train_resolution,
        step_seconds=f"{secs:.6f}", launches=json.dumps(launches))
    avgs = profile(torch, lambda: step(g, imgs, labels, mask, args.lr), 1)
    rows = device_rows(avgs)
    banned = [e.key for e in rows
              if any(t in e.key for t in ("roll_cuda_kernel", "layer_norm", "LayerNorm",
                                          "GammaBeta"))]
    check(not banned, f"a Swin-B train step still launches {banned}")
    norms = [e for e in rows if "swin_norm_" in e.key]
    say("swin_train", device_ms=f"{sum(e.self_device_time_total for e in rows) * 1e-3:.3f}",
        operations=sum(e.count for e in rows),
        swin_norm_ms=f"{sum(e.self_device_time_total for e in norms) * 1e-3:.3f}",
        swin_norm_launches=sum(e.count for e in norms),
        **{k: f"{v:.3f}" for k, v in sorted(device_ms_by_category(avgs, 1).items())})
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:16]:
        say("swin_train", kernel=e.key[:90].replace(" ", ""), count=e.count,
            device_ms=f"{e.self_device_time_total * 1e-3:.3f}")
    del model, step
    torch.cuda.empty_cache()
    return launches


SWIN_NORM_EPS = 1e-5


def phase_swin_norm(torch, seed):
    """Phase 11d: Swin's fused layer norms on the port's kernels
    (``ops/cuda_swin_norm.py``, ``csrc/swin_norm.cu``): each kernel's
    registers and spills (cuobjdump); then at Swin-B's stage-1 map (64 x
    96² x 128, the train step's float32 stream) and stage-3 map (64 x 24² x
    512, its bf16 stream), the shifted order (12, 6): norm1 (no branch, y
    bf16 at the order) and norm2 (the bf16 branch at the order, the sum and
    y natural). Checks the sum's bits against the plain add, y within one
    bf16 ulp of the float64 layer norm plus 8 float32 ulps of the terms
    float32 rounds, (|s| + |mean|) rstd |gamma| + |beta| (PyTorch's float32
    layer norm is itself off by more; its reading is printed beside), dx and the branch's gradient within
    4e-3 (bf16) or 1e-5 (float32) of the plain version's norm, and the same
    bits over two backward calls. Each direction's device ms (profiler,
    every kernel the call launches) and call ms (CUDA events) beside its
    least bytes at 3.35 TB/s (each operand read once, each output written
    once: at stage 1, 6 and 12 bytes an element forward, 14 and 16
    backward) and the plain composition's ms (a yardstick the port no
    longer runs). Returns the records of ``swin_norm_fwd`` and ``_bwd`` at
    the stage-1 norm1 call."""
    from primia_tpu_torch.ops import cuda_swin_norm as csn

    usage = resource_usage("swin_norm", mangled=True)
    for mangled, res in sorted((usage or {}).items()):
        say("swin_norm", kernel=mangled,
            **{k.lower(): res[k] for k in ("REG", "STACK", "LOCAL", "SHARED") if k in res})
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    B, order, bf = 64, (12, 6), torch.bfloat16
    rec = {}
    for stage, side, C, stream in (("stage1", 96, 128, torch.float32),
                                   ("stage3", 24, 512, torch.bfloat16)):
        x = (torch.randn((B, side, side, C), generator=g, device=dev) * 2 + 0.5).to(stream)
        br = torch.randn((B, (side // 12) ** 2, 144, C), generator=g, device=dev).to(bf)
        w = 1.0 + 0.1 * torch.randn(C, generator=g, device=dev)
        b = 0.1 * torch.randn(C, generator=g, device=dev)
        for call in ("norm1", "norm2"):
            case = f"{stage}_{call}"
            branch = br if call == "norm2" else None
            bo, oo = (order, None) if branch is not None else (None, order)
            kw = dict(branch=branch, branch_order=bo, out_order=oo, out_dtype=bf)
            y, s, stats = csn.forward(x, w, b, SWIN_NORM_EPS, branch, bo, oo, bf)
            saved = x if s is None else s
            dy = torch.randn(y.shape, generator=g, device=dev).to(bf)
            ds = torch.randn(saved.shape, generator=g, device=dev).to(saved.dtype)
            bdt = None if branch is None else branch.dtype
            got = csn.backward(dy, ds, saved, stats, w, x.dtype, bdt, bo, oo)
            check(all(torch.equal(p, q) for p, q in zip(
                got, csn.backward(dy, ds, saved, stats, w, x.dtype, bdt, bo, oo))
                if p is not None), f"swin_norm's backward gives other bits twice at {case}")
            leaves = [t.detach().requires_grad_() for t in (x, w, b)]
            pbr = None if branch is None else branch.detach().requires_grad_()
            ps, py = csn.add_norm_plain(*leaves, SWIN_NORM_EPS, **dict(kw, branch=pbr))
            wrt = leaves + ([] if pbr is None else [pbr])
            pgrads = torch.autograd.grad((ps, py), wrt, (ds, dy), retain_graph=True)
            if s is not None:
                check(torch.equal(s, ps), f"swin_norm's sum differs from the plain add at {case}")
            # y against the float64 layer norm: one bf16 ulp, plus 8 float32 ulps
            # of the terms float32 rounds, (|s| + |mean|) rstd |gamma| + |beta|
            # (tests/test_torch_swin_norm.py:_y_reference; PyTorch's float32
            # layer norm is itself off by more)
            s64 = ps.detach().double()
            mean = s64.mean(-1, keepdim=True)
            rstd = (s64.var(-1, unbiased=False, keepdim=True) + SWIN_NORM_EPS).rsqrt()
            y64 = csn.to_order((s64 - mean) * rstd * w.double() + b.double(), oo)
            terms = (s64.abs() + mean.abs()) * rstd * w.double().abs() + b.double().abs()
            tol = _bf16_ulp(torch, y64) + 2.0 ** -21 * csn.to_order(terms, oo)
            ulps = float(((y.double() - y64).abs() / tol).max())
            plain_ulps = float(((py.detach().double() - y64).abs() / tol).max())
            check(ulps <= 1.0, f"swin_norm's y is {ulps} of its tolerance off at {case}")
            del s64, mean, rstd, y64, terms, tol
            gaps = {"dx": (got[0], pgrads[0])}
            if pbr is not None:
                gaps["dbranch"] = (got[1], pgrads[3])
            gaps = {n: float((a.double() - r.double()).norm() / r.double().norm())
                    for n, (a, r) in gaps.items()}
            for n, (a, r) in (("dgamma", (got[2], pgrads[1])), ("dbeta", (got[3], pgrads[2]))):
                gaps[n] = float((a.double() - r.double()).norm() / r.double().norm())
            tol = {"dx": 4e-3 if x.dtype == bf else 1e-5, "dbranch": 4e-3, "dgamma": 1e-5,
                   "dbeta": 1e-5}
            check(all(gaps[n] < tol[n] for n in gaps), f"swin_norm at {case}: {gaps}")
            n_el, isz = x.numel(), (lambda t: t.element_size())
            fwd_b = isz(x) + isz(y) + (0 if s is None else isz(branch) + isz(s))
            bwd_b = isz(dy) + isz(saved) + isz(ds) + isz(got[0]) + (
                0 if got[1] is None else isz(got[1]))
            plain_fwd = lambda: csn.add_norm_plain(x, w, b, SWIN_NORM_EPS, **kw)  # noqa: E731

            def plain_bwd():
                return torch.autograd.grad((ps, py), wrt, (ds, dy), retain_graph=True)

            calls = {"fwd": (lambda: csn.forward(x, w, b, SWIN_NORM_EPS, branch, bo, oo, bf),
                             plain_fwd, fwd_b, ulps),
                     "bwd": (lambda: csn.backward(dy, ds, saved, stats, w, x.dtype, bdt, bo, oo),
                             plain_bwd, bwd_b, max(gaps.values()))}
            for way, (fn, plain, per_el, err) in calls.items():
                name = f"swin_norm_{way}"
                call_ms = cuda_ms(torch, fn, 20)
                dev_ms = function_device_ms(profile(torch, fn, 10), KERNELS[name]["kernel"], 10)
                bound_ms, bound_by = bound(per_el * n_el, 0)
                r = dict(ms=call_ms if dev_ms is None else dev_ms, call_ms=call_ms,
                         kernel_ms="not measured" if dev_ms is None else dev_ms,
                         plain_ms=cuda_ms(torch, plain, 5, warmup=1), library_ms=None,
                         bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
                _say_times(name, r, case=case, bytes_per_element=per_el)
                rec[f"{case}_{way}"] = r
            say("swin_norm", case=case, deterministic="yes", y_of_tolerance=f"{ulps:.3f}",
                plain_y_of_tolerance=f"{plain_ulps:.3f}",
                **{f"gap_{n}": f"{v:.3g}" for n, v in gaps.items()})
    return rec["stage1_norm1_fwd"], rec["stage1_norm1_bwd"]


def phase_ring(torch, seed):
    """Phase 12: the card's byte-limb ring conv against the CPU's int64."""
    from primia_tpu_torch.mpc import ring_ops
    from primia_tpu_torch.mpc.shares import rand_ring

    g = torch.Generator().manual_seed(seed)
    for name, xs, ws, stride, pad in (("stem", (1, 3, RES, RES), (64, 3, 7, 7), 2, 3),
                                      ("layer4", (1, 512, 7, 7), (512, 512, 3, 3), 1, 1)):
        x, w = rand_ring(g, xs), rand_ring(g, ws)
        t0 = time.perf_counter()
        ref = ring_ops.ring_conv2d(x, w, stride, pad)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        xc, wc = x.cuda(), w.cuda()
        got = ring_ops.ring_conv2d(xc, wc, stride, pad).cpu()
        check(torch.equal(got, ref), f"limb ring conv differs from the CPU's int64 at {name}")
        card_ms = cuda_ms(torch, lambda: ring_ops.ring_conv2d(xc, wc, stride, pad), 10)
        say("ring", case=name, x=xs, w=ws, stride=stride, padding=pad, equal=True,
            card_limb_ms=f"{card_ms:.6f}", cpu_int64_ms=f"{cpu_ms:.3f}")


def encrypt_ms_by_category(avgs, gemm_kernels):
    """Device milliseconds of the profiled window by category, with K4 and
    the int8 limb GEMMs (``gemm_kernels``: the kernels ``aten::_int_mm``
    launched) split out."""
    cats = {"dcf_kernel": 0.0, "int8_gemm": 0.0, "clahe_kernels": 0.0, "memcpy": 0.0,
            "other": 0.0}
    for e in device_rows(avgs):
        k = e.key
        if "dcf_sign" in k:
            cat = "dcf_kernel"
        elif k in gemm_kernels:
            cat = "int8_gemm"
        elif "clahe" in k:
            cat = "clahe_kernels"
        elif "Memcpy" in k or "Memset" in k:
            cat = "memcpy"
        else:
            cat = "other"
        cats[cat] += e.self_device_time_total * 1e-3
    return cats


def encrypted_cli(torch, data, weights, extra, n_images=ENCRYPT_IMAGES, batch=ENCRYPT_BATCH):
    """The inference CLI with --encrypted_inference on cuda, in-process, at
    ``batch``, the counters set to 0 just before and read just after.
    Returns its predictions, launches and seconds."""
    from primia_tpu_torch.cli import inference

    argv = ["--data_dir", str(data), "--model_weights", str(weights), "--batch_size",
            str(batch), "--device", "cuda", "--encrypted_inference", *extra]
    out, err = io.StringIO(), io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = inference.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    lines = out.getvalue().splitlines()
    check(json.loads(lines[0]) == json.loads(json.dumps(result))
          and lines[-1].startswith("Took "), "encrypted CLI output contract broken")
    preds = result["Inference Results"]
    check(len(preds) == n_images, f"bad encrypted results: {str(preds)[:200]}")
    return [preds[i] for i in range(n_images)], launches, secs


def encrypted_case(torch, work, weights, subdir, n_images=ENCRYPT_IMAGES, batch=ENCRYPT_BATCH):
    """``n_images`` of the serve phase's DICOMs in their own directory, the
    checkpoint's model on the card, its plain logits for them at ``batch``,
    their limit (max(0.02, 1e-3 max |logit|), phase 13's) and where the
    plain top-two margin exceeds it."""
    from primia_tpu_torch.data import PathDataset
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.nn.jax_params import from_jax_tree
    from primia_tpu_torch.train import checkpoint as ckpt
    from primia_tpu_torch.train.steps import build_predict_step

    data = work / subdir
    data.mkdir()
    for f in sorted((work / "images").glob("*.dcm"))[:n_images]:
        shutil.copy(f, data / f.name)
    state = ckpt.load_model(weights)
    args = state["args"]
    mean, std = state["val_mean_std"]
    msd = state["model_state_dict"]
    model = create_model(args, num_classes=3, device="cuda")
    model.load_state_dict(from_jax_tree(msd["params"], msd["state"]))
    imgs, _ = PathDataset(data, channels=3 if args.pretrained else 1).materialize(RES)
    chunks = [imgs[i:i + batch] for i in range(0, n_images, batch)]
    plain = build_predict_step(model, args, mean, std, "cuda")
    want = torch.cat([plain(c) for c in chunks]).float().cpu()
    limit = max(0.02, 1e-3 * float(want.abs().max()))
    top2 = want.topk(2, dim=1).values
    sure = (top2[:, 0] - top2[:, 1]) > limit
    return dict(weights=weights, data=data, args=args, mean=mean, std=std, model=model,
                imgs=imgs, chunks=chunks, want=want, limit=limit, sure=sure, n=n_images,
                batch=batch)


def check_encrypted(torch, phase, case, protocol, expect_per_forward, tile=None):
    """The encrypted CLI (``--protocol``, ``--mpc_batch_tile``) with its
    exact launches (``expect_per_forward`` times the forwards) and the
    encrypted predict's logits against the plain step's. Returns the
    launches, the predict and the CLI's seconds."""
    from primia_tpu_torch.mpc.inference import build_encrypted_predict

    extra = ["--protocol", protocol] + ([] if tile is None else ["--mpc_batch_tile", str(tile)])
    preds, launches, cli_s = encrypted_cli(torch, case["data"], case["weights"], extra,
                                           case["n"], case["batch"])
    forwards = case["n"] // case["batch"] * (1 if tile is None else -(-case["batch"] // tile))
    expect = idle_launches(**{k: n * forwards for k, n in expect_per_forward.items()})
    check(launches == expect, f"{phase}: encrypted CLI ({protocol}, tile {tile}) launches "
          f"{launches}, expected {expect}")
    args = case["args"]
    enc = build_encrypted_predict(case["model"], args, case["mean"], case["std"], "cuda",
                                  precision_fractional=args.precision_fractional or 16,
                                  protocol=protocol, batch_tile=tile)
    got = torch.cat([enc(c) for c in case["chunks"]]).cpu()
    want, limit, sure = case["want"], case["limit"], case["sure"]
    dl = float((got - want).abs().max())
    check(got.shape == want.shape and bool(torch.isfinite(got).all()) and dl <= limit,
          f"{phase}: encrypted logits ({protocol}, tile {tile}) off the plain step: max |d| "
          f"{dl} > {limit}")
    check(bool((got.argmax(1) == want.argmax(1))[sure].all()),
          f"{phase}: encrypted argmax ({protocol}, tile {tile}) differs where the plain margin "
          f"exceeds {limit}")
    check(preds == got.argmax(1).tolist(), f"{phase}: CLI predictions ({protocol}, tile "
          f"{tile}) {preds} are not the encrypted logits' argmax {got.argmax(1).tolist()}")
    say(phase, protocol=protocol, mpc_batch_tile=tile, cli_seconds=f"{cli_s:.4f}",
        launches=json.dumps(launches), max_abs_dlogit=dl, limit=limit,
        max_abs_logit=float(want.abs().max()),
        argmax_equal=int((got.argmax(1) == want.argmax(1)).sum()),
        margin_above_limit=int(sure.sum()), predictions=preds)
    return launches, enc, cli_s


def time_encrypted(torch, np, phase, protocol, enc, imgs, profile_out, tag,
                   batches=(1, ENCRYPT_BATCH), n_timed=5):
    """The encrypted predict at each of ``batches``: p50/p75 over
    ``n_timed`` batches after one warm-up, s per image and peak memory;
    then one batch of each under the profiler: device busy ms, idle share
    against the p50, device operations a forward, device ms by category
    (the table of the last batch size goes to ``profile_out`` with
    ``tag``)."""
    for B in batches:
        x = imgs[:B]
        enc(x)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        batch_ms = []
        for _ in range(n_timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc(x)
            torch.cuda.synchronize()
            batch_ms.append((time.perf_counter() - t0) * 1e3)
        q = np.percentile(batch_ms, [50, 75])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prof = trace(torch, lambda: enc(x), 1)
        avgs = prof.key_averages()
        gemm_kernels = {k.name for e in prof.events() if e.name == "aten::_int_mm"
                        for k in e.kernels}
        check(gemm_kernels, f"{phase}: the profile links no kernel to aten::_int_mm")
        cats = encrypt_ms_by_category(avgs, gemm_kernels)
        busy = sum(cats.values())
        launched = sum(e.count for e in device_rows(avgs))
        idle = f"{1.0 - busy / q[0]:.4f}" if busy > 0 else "not measured"
        say(phase, protocol=protocol, batch=B, batches_timed=len(batch_ms),
            batch_ms_p50=f"{q[0]:.4f}", batch_ms_p75=f"{q[1]:.4f}",
            s_per_image_p50=f"{q[0] * 1e-3 / B:.6f}", peak_memory_gb=f"{peak_gb:.3f}",
            device_busy_ms_per_batch=f"{busy:.4f}", idle_share=idle,
            device_ops_per_forward=launched)
        say(phase, protocol=protocol, batch=B,
            device_ms_per_batch=json.dumps({k: round(v, 6) for k, v in cats.items()}))
    path = profile_out.with_name(profile_out.stem + tag + profile_out.suffix)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(avgs.table(sort_by="self_cuda_time_total", row_limit=40))


def phase_encrypt(torch, seed, work, profile_out):
    """Phase 13: the encrypted inference CLI (FSS) on the card, its logits
    against the plain predict step, the tiled form, and timings. Returns
    the launch counts of the CLI's run."""
    import numpy as np

    case = encrypted_case(torch, work, work / "resnet18-canonical.pt", "encrypt_images")
    say("encrypt", images=ENCRYPT_IMAGES, batch=ENCRYPT_BATCH, protocol="fss",
        weights=case["weights"].relative_to(ROOT))
    results = {tile: check_encrypted(torch, "encrypt", case, "fss",
                                     {"dcf_sign": SIGNS_PER_FORWARD, "clahe_lab": 1}, tile)
               for tile in (None, 2)}
    time_encrypted(torch, np, "encrypt", "fss", results[None][1], case["imgs"], profile_out,
                   ".encrypt")
    return results[None][0]


def phase_encrypt_snn(torch, seed, work, profile_out):
    """Phase 13b, slice 3b's path (a): the encrypted CLI with --protocol snn
    (SecureNN) on the canonical checkpoint (batch norm folded, CLAHE, max
    pool): CLAHE once a forward and no K4; logits against the plain step;
    timed as phase 13, whose FSS numbers are beside these in this call.
    Returns the CLI's launch counts."""
    import numpy as np

    case = encrypted_case(torch, work, work / "resnet18-canonical.pt", "encrypt_snn_images")
    say("encrypt_snn", images=ENCRYPT_IMAGES, batch=ENCRYPT_BATCH, protocol="snn",
        weights=case["weights"].relative_to(ROOT))
    launches, enc, _ = check_encrypted(torch, "encrypt_snn", case, "snn", {"clahe_lab": 1})
    time_encrypted(torch, np, "encrypt_snn", "snn", enc, case["imgs"], profile_out,
                   ".encrypt_snn")
    return launches


def phase_encrypt_group(torch, seed, work, profile_out):
    """Phase 13c, slice 3b's path (b): a group-norm ResNet-18 at 224 px
    with the DP recipe's settings (configs/torch/pneumonia-resnet-dp.ini:
    group norm, max pool, no CLAHE), seeded He weights and an N(0, 0.1)
    head (the init's zero fc would make every logit 0), served encrypted
    under FSS (K4 21 times a forward: 17 ReLUs and 4 max-pool rounds; group
    norm compares nothing) and under SecureNN (no kernel); logits against
    the plain step; both timed. Returns the FSS CLI's launch counts."""
    import numpy as np

    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.train import checkpoint as ckpt

    os.environ.pop("PRIMIA_PRETRAINED", None)
    args = Arguments.from_ini(DP_CONFIG)
    check(args.normalization == "group" and args.pooling_type == "max" and not args.clahe
          and args.train_resolution == RES, f"unexpected DP config: {DP_CONFIG}")
    torch.manual_seed(seed + 5)
    model = create_model(args, num_classes=3, device="cpu")
    torch.nn.init.normal_(model.fc.weight, std=0.1)
    weights = work / "resnet18-group.pt"
    ckpt.save_model(weights, epoch=0, model=model, args=args,
                    val_mean_std=(np.full(3, 0.45), np.full(3, 0.25)))
    case = encrypted_case(torch, work, weights, "encrypt_group_images")
    say("encrypt_group", config=DP_CONFIG.relative_to(ROOT), images=ENCRYPT_IMAGES,
        batch=ENCRYPT_BATCH, weights=weights.relative_to(ROOT), head_std=0.1)
    by_protocol = {}
    for protocol, per_forward in (("fss", {"dcf_sign": SIGNS_PER_FORWARD}), ("snn", {})):
        launches, enc, _ = check_encrypted(torch, "encrypt_group", case, protocol, per_forward)
        time_encrypted(torch, np, "encrypt_group", protocol, enc, case["imgs"], profile_out,
                       f".encrypt_group_{protocol}")
        by_protocol[protocol] = launches
    return by_protocol["fss"]


def synthetic_xrays(np, rng, n):
    """uint8 224x224 images: a bright blob on a dark field, with noise."""
    yy, xx = np.mgrid[0:RES, 0:RES].astype(np.float32)
    out = np.empty((n, RES, RES), np.uint8)
    for i in range(n):
        cy, cx = rng.uniform(60, 164, 2)
        r = rng.uniform(30, 80)
        img = 40 + 150 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        img += rng.normal(0, 12, img.shape)
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def phase_serve(torch, seed, work, profile_out):
    import numpy as np

    from primia_tpu_torch.cli import inference
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.data import PathDataset, write_dicom
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.nn.jax_params import from_jax_tree
    from primia_tpu_torch.train import checkpoint as ckpt
    from primia_tpu_torch.train.steps import build_predict_step

    args = Arguments.from_ini(CONFIG)
    data = work / "images"
    check(args.model == "resnet-18" and args.pretrained and args.clahe
          and args.inference_resolution == RES, f"unexpected canonical config: {CONFIG}")
    rng = np.random.default_rng(seed)
    imgs = synthetic_xrays(np, rng, N_IMAGES)
    data.mkdir(parents=True)
    for i, a in enumerate(imgs):
        write_dicom(data / f"xray_{i:03d}.dcm", a)
    f = imgs.astype(np.float64) / 255.0
    mean_std = (np.full(3, f.mean()), np.full(3, f.std(ddof=1)))

    torch.manual_seed(seed)
    model = create_model(args, num_classes=3, device="cpu")
    weights = work / "resnet18-canonical.pt"
    ckpt.save_model(weights, epoch=0, model=model, args=args, val_mean_std=mean_std)
    say("serve", config=CONFIG.relative_to(ROOT), weights=weights.relative_to(ROOT),
        images=N_IMAGES, batch=BATCH)

    argv = ["--data_dir", str(data), "--model_weights", str(weights),
            "--batch_size", str(BATCH), "--device", "cuda"]
    out, err = io.StringIO(), io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = inference.main(argv)
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    n_batches = -(-N_IMAGES // BATCH)
    preds = result["Inference Results"]
    check(len(preds) == N_IMAGES and set(preds.values()) <= {0, 1, 2},
          f"bad inference results: {str(preds)[:200]}")
    lines = out.getvalue().splitlines()
    check(json.loads(lines[0]) == json.loads(json.dumps(result))
          and lines[-1].startswith("Took "), "inference CLI output contract broken")
    check(launches["clahe_lab"] == n_batches,
          f"clahe_lab launched {launches['clahe_lab']} times for {n_batches} batches")
    check(launches == idle_launches(clahe_lab=n_batches),
          f"the serving path launched a kernel other than CLAHE's: {launches}")
    say("serve", cli_seconds=f"{cli_s:.4f}", cli_img_per_s=f"{N_IMAGES / cli_s:.2f}",
        launches=json.dumps(launches), predictions=lines[1])

    # the CLI's predict step, rebuilt for timing and for the CPU comparison
    state = ckpt.load_model(weights)
    msd = state["model_state_dict"]
    sd = from_jax_tree(msd["params"], msd["state"])
    batches, _ = PathDataset(data, channels=3).materialize(RES)
    gpu_model = create_model(args, num_classes=3, device="cuda")
    gpu_model.load_state_dict(sd)
    predict = build_predict_step(gpu_model, args, *mean_std, "cuda")
    chunks = [batches[i:i + BATCH] for i in range(0, N_IMAGES, BATCH)]
    logits = predict(chunks[0]).float().cpu()
    check(logits.shape == (BATCH, 3) and bool(torch.isfinite(logits).all()),
          f"bad logits {tuple(logits.shape)}")
    cpu_model = create_model(args, num_classes=3, device="cpu")
    cpu_model.load_state_dict(sd)
    ref = build_predict_step(cpu_model, args, *mean_std, "cpu")(chunks[0][:4])
    dl = float((logits[:4] - ref).abs().max())
    scale = float(ref.abs().max())
    check(torch.equal(logits[:4].argmax(1), ref.argmax(1)) and dl <= 1e-3 * scale,
          f"card vs CPU logits: max |d| {dl} against max |logit| {scale}")
    say("serve", cpu_check="ok", max_abs_dlogit=dl, max_abs_logit=scale)

    def one_pass():
        for c in chunks:
            predict(c)

    one_pass()  # warm-up: cuDNN's first-call set-up
    batch_ms = []
    for _ in range(10):
        for c in chunks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predict(c)
            torch.cuda.synchronize()
            batch_ms.append((time.perf_counter() - t0) * 1e3)
    q = np.percentile(batch_ms, [50, 75])
    nb = len(chunks)
    avgs = profile(torch, one_pass, 3)
    profile_out.parent.mkdir(parents=True, exist_ok=True)
    profile_out.write_text(avgs.table(sort_by="self_cuda_time_total", row_limit=40))
    cats = {k: v / nb for k, v in device_ms_by_category(avgs, 3).items()}
    busy = sum(cats.values())
    idle = f"{1.0 - busy / q[0]:.4f}" if busy > 0 else "not measured"
    say("serve", batch=BATCH, batches_timed=len(batch_ms), batch_ms_p50=f"{q[0]:.4f}",
        batch_ms_p75=f"{q[1]:.4f}", img_per_s_p50=f"{BATCH / (q[0] * 1e-3):.2f}",
        device_busy_ms_per_batch=f"{busy:.4f}", idle_share=idle)
    say("serve", device_ms_per_batch=json.dumps({k: round(v, 6) for k, v in cats.items()}))
    return launches


def write_classes(np, rng, root, counts):
    """``root/<class>/`` synthetic DICOMs, ``counts`` a class, each class a
    little brighter."""
    from primia_tpu_torch.data import write_dicom

    for ci, (cls, n) in enumerate(zip(CLASSES, counts)):
        d = root / cls
        d.mkdir(parents=True)
        imgs = np.clip(synthetic_xrays(np, rng, n).astype(np.int16) + 12 * ci, 0, 255)
        for i, a in enumerate(imgs.astype(np.uint8)):
            write_dicom(d / f"xray_{i:04d}.dcm", a)


def write_dataset(np, rng, root):
    """The synthetic 3-class set: ``root/train/<class>/`` and
    ``root/test/<class>/`` DICOMs."""
    for split, n in (("train", TRAIN_PER_CLASS), ("test", TEST_PER_CLASS)):
        write_classes(np, rng, root / split, (n,) * len(CLASSES))


def time_steps(torch, np, run, phase, profile_out, tag, batch=TRAIN_BATCH, steps=TIMED_STEPS,
               warmup=3, n_prof=3, **extra):
    """``steps`` train steps ``run(i)`` at ``batch`` after ``warmup`` steps:
    p50 and p75 of the host clock around each synchronised step, img/s,
    peak memory, and from the profiler over ``n_prof`` steps the device ms
    a step by category, the idle share and the CPU-side ``aten::`` ops a
    step (every call, nested ones included; the table goes beside
    ``profile_out`` with ``tag`` before the suffix); ``extra`` joins the
    printed line. Returns (p50 ms, device ms by category, aten ops a step,
    idle share)."""
    for i in range(warmup):
        run(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_losses = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_losses.append(run(i))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(bool(torch.isfinite(l)) for l in step_losses), f"{phase}: non-finite train loss")
    q = np.percentile(step_ms, [50, 75])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    avgs = profile(torch, lambda: [run(i) for i in range(n_prof)], 1)
    path = profile_out.with_name(profile_out.stem + tag + profile_out.suffix)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(avgs.table(sort_by="self_cuda_time_total", row_limit=60))
    cats = {k: v / n_prof for k, v in device_ms_by_category(avgs, 1).items()}
    aten_ops = sum(e.count for e in avgs if e.key.startswith("aten::")) / n_prof
    busy = sum(cats.values())
    idle = f"{1.0 - busy / q[0]:.4f}" if busy > 0 else "not measured"
    say(phase, batch=batch, steps_timed=len(step_ms), step_ms_p50=f"{q[0]:.4f}",
        step_ms_p75=f"{q[1]:.4f}", img_per_s_p50=f"{batch / (q[0] * 1e-3):.2f}",
        device_busy_ms_per_step=f"{busy:.4f}", idle_share=idle,
        aten_ops_per_step=f"{aten_ops:.1f}", peak_memory_gb=f"{peak_gb:.3f}",
        compute_dtype="bfloat16", **extra)
    say(phase, device_ms_per_step=json.dumps({k: round(v, 6) for k, v in cats.items()}))
    return q[0], cats, aten_ops, idle


def phase_train(torch, seed, work, profile_out):
    """Phase 7: the train CLI on the card, timed train steps, K2 on the
    train path, and one float32 step on the card against the CPU.
    Returns the launch counts of the CLI's run and of the
    PRIMIA_WARP_TWOPASS=0 steps."""
    import numpy as np

    from primia_tpu_torch.cli import train as train_cli
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.data import (BatchLoader, ImageFolderDataset, calc_mean_std,
                                       to_device_resident)
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.train import checkpoint as ckpt
    from primia_tpu_torch.train.optim import make_optimizer
    from primia_tpu_torch.train.steps import build_train_step

    root = work / "xray"
    write_dataset(np, np.random.default_rng(seed + 1), root)
    text = CONFIG.read_text()
    check("epochs = 40" in text, f"unexpected canonical config: {CONFIG}")
    ini = work / "train.ini"
    ini.write_text(text.replace("epochs = 40", "epochs = 1"))
    args = Arguments.from_ini(ini)
    check(args.batch_size == TRAIN_BATCH and args.mixup and args.clahe and args.elastic,
          f"unexpected canonical config: {CONFIG}")
    n_train = TRAIN_PER_CLASS * len(CLASSES)
    steps = -(-n_train // TRAIN_BATCH)
    say("train", config=CONFIG.relative_to(ROOT), epochs=1, train_images=n_train,
        test_images=TEST_PER_CLASS * len(CLASSES), batch=TRAIN_BATCH, steps=steps)

    # the main path: the train CLI, in-process, on cuda
    argv = ["--config", str(ini), "--data_dir", str(root / "train"), "--device", "cuda"]
    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        reset_launches()
        torch.manual_seed(seed)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            best = train_cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        os.chdir(cwd)
    (work / "train_cli.log").write_text(out.getvalue())
    want = idle_launches(tent_rows=4 * steps, clahe_lab=steps)
    check(launches == want, f"train CLI launches {launches}, expected {want}")
    finals = sorted((work / "model_weights").glob("final_*.pt"))
    check(len(finals) == 1, f"train CLI wrote {len(finals)} final checkpoints")
    state = ckpt.load_model(finals[0])
    check(state["epoch"] == 1 and int(state["optim_state_dict"].step) == steps,
          "final checkpoint has the wrong epoch or optimizer step")
    losses = [float(line.split()[-1]) for line in out.getvalue().splitlines()
              if line.startswith("Train Epoch:")]
    check(len(losses) == 1 and np.isfinite(losses[0]), f"train losses {losses}")
    check(np.isfinite(best), f"best objective {best}")
    say("train", cli_seconds=f"{cli_s:.4f}", launches=json.dumps(launches),
        epoch_loss=losses[0], best_mcc_percent=best)

    # timed steps at batch 200, on a model and data set up as the loop does
    ds = ImageFolderDataset(root / "train", channels=3)
    imgs, labels = ds.materialize(RES)
    mean, std = calc_mean_std(imgs)
    dev = torch.device("cuda")
    torch.manual_seed(seed)
    model = create_model(args, num_classes=3, device="cpu").to(dev)
    opt = make_optimizer(args, model)
    step = build_train_step(model, opt, args, mean, std, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    loader = BatchLoader(to_device_resident(imgs, dev), labels, TRAIN_BATCH, seed=seed,
                         pad_final=False)
    batches = [b for b in loader]

    def run(i):
        b = batches[i % len(batches)]
        return step(gen, b.images, b.labels, b.mask, 1e-4)

    time_steps(torch, np, run, "train", profile_out, ".train")

    # K2 on the train path: the dense warp as the joint bilinear gather
    os.environ["PRIMIA_WARP_TWOPASS"] = "0"
    try:
        reset_launches()
        k2_losses = [float(run(i)) for i in range(2)]
        torch.cuda.synchronize()
        k2 = read_launches()
    finally:
        os.environ.pop("PRIMIA_WARP_TWOPASS")
    check(k2["tent_bilinear"] == 2 and k2["tent_rows"] == 2 * 2
          and all(np.isfinite(k2_losses)),
          f"PRIMIA_WARP_TWOPASS=0 steps: launches {k2}, losses {k2_losses}")
    say("train", warp_twopass=0, steps=2, launches=json.dumps(k2), losses=k2_losses)

    # one float32 step, augmentation and mixup off: the card against the CPU
    f32 = Arguments.from_ini(ini)
    f32.compute_dtype = "float32"
    f32.rotation = f32.translate = f32.scale = f32.shear = 0.0
    f32.albu_prob = f32.noise_prob = 0.0
    f32.clahe = f32.mixup = False
    torch.manual_seed(seed)
    sd = create_model(f32, num_classes=3, device="cpu").state_dict()
    x4, y4, m4 = imgs[:4], labels[:4], np.ones(4, np.float32)
    results = {}
    for where in ("cuda", "cpu"):
        m = create_model(f32, num_classes=3, device=where)
        m.load_state_dict(sd)
        st = build_train_step(m, make_optimizer(f32, m), f32, mean, std, device=where)
        loss = float(st(torch.Generator(device=where).manual_seed(0), x4, y4, m4, 1e-4))
        stats = torch.cat([t.detach().float().cpu().reshape(-1) for n, t in m.state_dict().items()
                           if n.endswith(("running_mean", "running_var"))])
        results[where] = (loss, stats)
    (lg, sg), (lc, sc) = results["cuda"], results["cpu"]
    rel = abs(lg - lc) / abs(lc)
    dstat = float((sg - sc).abs().max())
    check(rel <= 1e-4 and dstat <= 1e-4,
          f"card vs CPU f32 step: loss {lg} vs {lc} (rel {rel}), BN stats max |d| {dstat}")
    say("train", cpu_check="ok", loss_cuda=lg, loss_cpu=lc, loss_rel_diff=rel,
        bn_stats_max_abs_diff=dstat)
    ctx = dict(ini=ini, root=root, run=run, imgs=imgs, labels=labels, mean=mean, std=std,
               steps=steps, final=finals[0])
    return launches, k2, ctx


SWITCHES = ("PRIMIA_PALLAS_WGRAD", "PRIMIA_PALLAS_BN", "PRIMIA_PALLAS_AUGMENT")
K7_PER_STEP, K8_PER_STEP = 6, 20  # layer2's and layer3's s1 convs; every BN


@contextlib.contextmanager
def switches(*names):
    """The JAX package's opt-in kernel switches: those named set to 1,
    the others unset, for the block."""
    old = {k: os.environ.pop(k, None) for k in SWITCHES}
    os.environ.update({k: "1" for k in names})
    try:
        yield
    finally:
        for k in SWITCHES:
            os.environ.pop(k, None)
        os.environ.update({k: v for k, v in old.items() if v is not None})


class _GradRecorder:
    """Stands in for the optimizer: keeps the gradients it is given."""

    def __init__(self, model):
        self.names, self.params = zip(*model.named_parameters())

    def update(self, grads, lr):
        self.grads = {n: g.detach().float().cpu() for n, g in zip(self.names, grads)}


def phase_train_optin(torch, seed, work, profile_out, ctx):
    """Phase 14: slice 2b's main path, the train step under the JAX
    package's switches PRIMIA_PALLAS_WGRAD/BN/AUGMENT=1: the train CLI as
    in phase 7, counters set to 0 just before and read just after (K7 6
    times a step, each of the BN's six launches 20 times, K1 and CLAHE as
    before, K2 never: the canonical affine ranges are two-pass safe, so the
    one-pass warp is not reached); the layout copies the wrappers made; 24
    timed steps of the switched step beside 24 of the default one, on one
    model, with their aten ops a step and the device ms the switched step
    spends beyond the default by category; then
    one bfloat16 step with augmentation and mixup off from the same
    weights and batch of 200, switched against default (loss within 1e-2
    relative; the fc's weight and bias gradients within 2e-2 of their max;
    under PRIMIA_PALLAS_WGRAD alone every conv weight gradient within 2e-2
    of its max |dW|; under all three the BN running statistics within 2e-2
    of their max). Under the BN switch the conv and BN gamma/beta
    gradients are held to a float32 step's instead: no further from it, by
    the largest share of a tensor's max |value| and by the l2 share, than
    1.5 times the default bfloat16 step's distance from it. The BN
    backward's dx differs from cuDNN's in its last bits, and a conv's
    weight gradient in front of a BN is the small remainder of large
    opposite sums, which such bits move by a large share (PERF.md, section
    6); the float32 step separates that share from the switched path's own
    error. Returns the CLI run's launch counts."""
    import numpy as np

    from primia_tpu_torch.cli import train as train_cli
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.ops import cuda_bn, cuda_wgrad
    from primia_tpu_torch.train.steps import build_train_step

    steps = ctx["steps"]
    cli_dir = work / "optin"
    cli_dir.mkdir()
    argv = ["--config", str(ctx["ini"]), "--data_dir", str(ctx["root"] / "train"),
            "--device", "cuda"]
    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(cli_dir)
    copies = (cuda_wgrad.layout_copies, cuda_bn.layout_copies)
    try:
        with switches(*SWITCHES):
            reset_launches()
            for c in copies:
                c.update({k: 0 for k in c})
            torch.manual_seed(seed)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
                best = train_cli.main(argv)
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches = read_launches()
    finally:
        os.chdir(cwd)
    (work / "train_optin_cli.log").write_text(out.getvalue())
    want = idle_launches(tent_rows=4 * steps, clahe_lab=steps,
                         conv3x3_wgrad=K7_PER_STEP * steps,
                         **{k: K8_PER_STEP * steps for k in BN_LAUNCHES})
    check(launches == want, f"switched train CLI launches {launches}, expected {want}")
    check(len(list((cli_dir / "model_weights").glob("final_*.pt"))) == 1 and np.isfinite(best),
          f"switched train CLI: best objective {best}, or no final checkpoint")
    layout = {**{f"wgrad.{k}": v for k, v in copies[0].items()},
              **{f"bn.{k}": v for k, v in copies[1].items()}}
    say("train_optin", switches=",".join(SWITCHES), cli_seconds=f"{cli_s:.4f}",
        launches=json.dumps(launches), layout_copies=json.dumps(layout), best_mcc_percent=best)

    # the switched step beside the default one, on the same model, in turns
    times = {}
    for label, on in (("default", ()), ("switched", SWITCHES)):
        with switches(*on):
            times[label] = time_steps(torch, np, ctx["run"], f"train_optin.{label}",
                                      profile_out, f".train_optin.{label}")
    (p_s, cats_s, ops_s, idle_s), (p_d, cats_d, ops_d, idle_d) = times["switched"], times["default"]
    say("train_optin", switched_over_default_p50=f"{p_s / p_d:.4f}",
        switched_step_ms_p50=f"{p_s:.4f}", default_step_ms_p50=f"{p_d:.4f}",
        switched_idle_share=idle_s, default_idle_share=idle_d,
        k7_device_ms_per_step=f"{cats_s.get('k7', 0.0):.6f}",
        bn_device_ms_per_step=f"{cats_s.get('k8', 0.0):.6f}",
        switched_aten_ops_per_step=f"{ops_s:.1f}", default_aten_ops_per_step=f"{ops_d:.1f}",
        switched_minus_default_device_ms=json.dumps(
            {k: round(cats_s.get(k, 0.0) - cats_d.get(k, 0.0), 6) for k in {**cats_d, **cats_s}}))

    # one bfloat16 step, augmentation and mixup off, from the same weights and batch
    args = Arguments.from_ini(ctx["ini"])
    args.compute_dtype = "bfloat16"
    args.rotation = args.translate = args.scale = args.shear = 0.0
    args.albu_prob = args.noise_prob = 0.0
    args.clahe = args.mixup = args.elastic = False
    torch.manual_seed(seed)
    sd = create_model(args, num_classes=3, device="cpu").state_dict()
    x, y, m = ctx["imgs"][:TRAIN_BATCH], ctx["labels"][:TRAIN_BATCH], np.ones(TRAIN_BATCH,
                                                                              np.float32)
    f32 = dataclasses.replace(args, compute_dtype="float32")
    res = {}
    for label, on in (("default", ()), ("wgrad", SWITCHES[:1]), ("all", SWITCHES),
                      ("float32", ())):
        if label == "float32":
            args = f32
        model = create_model(args, num_classes=3, device="cuda")
        model.load_state_dict(sd)
        rec = _GradRecorder(model)
        step = build_train_step(model, rec, args, ctx["mean"], ctx["std"], device="cuda")
        with switches(*on):
            reset_launches()
            loss = float(step(torch.Generator(device="cuda").manual_seed(0), x, y, m, 1e-4))
            torch.cuda.synchronize()
            n = read_launches()
        stats = {k: v.detach().float().cpu() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        res[label] = (loss, rec.grads, stats, n)
    loss_d, grads_d, stats_d, _ = res["default"]
    loss_f, grads_f, _, _ = res["float32"]
    groups = {"conv": [k for k in grads_d if grads_d[k].dim() == 4],
              "bn_param": [k for k in grads_d if grads_d[k].dim() == 1 and not k.startswith("fc.")],
              "fc": ["fc.weight", "fc.bias"]}

    def rel(a, b, keys):
        return max(float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-30)
                   for k in keys)

    def l2(a, b, keys):
        return max(float((a[k] - b[k]).norm()) / max(float(b[k].norm()), 1e-30) for k in keys)

    def distances(a, b):
        return {f"{g}_grad_{m.__name__}": m(a, b, keys) for g, keys in groups.items()
                for m in (rel, l2)}

    noise = distances(grads_d, grads_f)  # the default bfloat16 step's own distance
    say("train_optin", step="default_vs_float32", loss_float32=loss_f,
        loss_rel_diff=abs(loss_d - loss_f) / abs(loss_f), **noise)
    for label, (k7, k8) in (("wgrad", (K7_PER_STEP, 0)), ("all", (K7_PER_STEP, K8_PER_STEP))):
        loss, grads, stats, n = res[label]
        check(n["conv3x3_wgrad"] == k7 and all(n[k] == k8 for k in BN_LAUNCHES),
              f"one {label} step launched {n}")
        lrel = abs(loss - loss_d) / abs(loss_d)
        check(np.isfinite(loss) and lrel <= 1e-2, f"{label} step loss {loss} vs default {loss_d}")
        off_d, off_f = distances(grads, grads_d), distances(grads, grads_f)
        stat_rel = rel(stats, stats_d, stats_d)
        check(off_d["fc_grad_rel"] <= 2e-2, f"{label} step: fc gradients "
              f"{off_d['fc_grad_rel']} of max off default")
        if label == "wgrad":
            check(off_d["conv_grad_rel"] <= 2e-2, f"K7's conv weight gradients "
                  f"{off_d['conv_grad_rel']} of max off default")
        else:
            check(stat_rel <= 2e-2, f"switched step: BN running statistics {stat_rel} of max "
                  f"off default")
            # the switched backward's own error, apart from bfloat16's: no
            # further from the float32 step than 1.5 times the default step
            for k, v in off_f.items():
                if not k.startswith("fc"):
                    check(v <= 1.5 * noise[k], f"switched step: {k} {v} from float32, over "
                          f"1.5 x the default step's {noise[k]}")
        say("train_optin", step=label, loss=loss, loss_default=loss_d, loss_rel_diff=lrel,
            bn_stats_max_rel=stat_rel, launches=json.dumps(n),
            **{f"{k}_vs_default": v for k, v in off_d.items()},
            **{f"{k}_vs_float32": v for k, v in off_f.items()})
    return launches


FED_CONFIG = ROOT / "configs" / "torch" / "pneumonia-resnet-pretrained-federated.ini"
# uneven shards, so a node whose shard has run out sits out (masking):
# 400, 300 and 200 images, each split over the three classes
FED_PER_CLASS = ((134, 133, 133), (100, 100, 100), (67, 67, 66))
FED_TIMED_STEPS, FED_TIMED_AGGREGATIONS, FED_TIMED_ROUNDS = 12, 8, 4


def write_federated_dataset(np, rng, root, per_class=FED_PER_CLASS):
    """``root/worker1..N/<class>/`` (``per_class``, a node's counts a
    class) and ``root/validation/<class>/`` DICOMs: the server-simulation
    layout of ``data/distribute.py``."""
    shards = [(f"worker{w + 1}", n) for w, n in enumerate(per_class)]
    for folder, counts in shards + [("validation", (TEST_PER_CLASS,) * len(CLASSES))]:
        write_classes(np, rng, root / folder, counts)


def phase_federated(torch, seed, work, profile_out):
    """Phase 15: slice 4's main path, FedAvg with secure aggregation over 3
    simulated hospital nodes on the card. The train CLI with
    ``--train_federated`` on the canonical federated INI (ResNet-18 at 224
    px, batch 200 a node, mixup, CLAHE, the full augmentation chain; only
    the epochs cut: 5 with ``repetitions_dataset = 5`` is one epoch),
    run from the repository root, so ``configs/websetting/config.csv``
    names the workers alice, bob and charlie; uneven shards of 400, 300
    and 200 images give 10 federated steps of 2 + 2 + 1 batches a pass, 25
    node steps and 4 aggregations (``sync_every_n_batch = 3`` and the
    epoch's end). Counters set to 0 just before and read just after: K1
    four times and CLAHE once a node step (the eval step runs no CLAHE,
    as the JAX package's). Then, on the nodes as the CLI builds them: the
    same node-stacked tree aggregated on the card and on the CPU reveals
    the same int64 ring sums from different shares and the same floats,
    within N * 2^-(f+1) (plus half a float32 ulp) of the plain average;
    and the times: a federated step (3 node steps at batch 200, in node
    order on one stream), a secure and a plain aggregation of the whole
    ResNet-18, a FedAvg round (``sync_every_n_batch`` steps and one secure
    aggregation), the device's busy time and idle share over 3 steps and
    over 2 aggregations from the profiler, and peak memory. Returns the
    CLI run's launch counts."""
    import numpy as np

    from primia_tpu_torch.cli import train as train_cli
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.data import BatchLoader, to_device_resident
    from primia_tpu_torch.mpc import fixed
    from primia_tpu_torch.mpc import shares as S
    from primia_tpu_torch.mpc.aggregation import (AShareSumNodes, _is_count_leaf, _leaf_key,
                                                  map_with_path, plain_fedavg, secure_fedavg)
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.nn.jax_params import to_jax_tree
    from primia_tpu_torch.parallel.federated import FederatedNodes, setup_federated
    from primia_tpu_torch.train import checkpoint as ckpt

    root = work / "federated"
    write_federated_dataset(np, np.random.default_rng(seed + 2), root)
    text = FED_CONFIG.read_text()
    check("epochs = 40" in text, f"unexpected federated config: {FED_CONFIG}")
    ini = work / "federated.ini"
    ini.write_text(text.replace("epochs = 40", "epochs = 5"))
    args = Arguments.from_ini(ini, cmd_args=argparse.Namespace(data_dir=str(root),
                                                               train_federated=True))
    check(args.epochs == 1 and args.batch_size == TRAIN_BATCH and args.repetitions_dataset == 5
          and args.sync_every_n_batch == 3 and args.weighted_averaging and args.mixup
          and args.clahe and args.elastic and not args.unencrypted_aggregation,
          f"unexpected federated config: {FED_CONFIG}")
    per_pass = [-(-sum(n) // TRAIN_BATCH) for n in FED_PER_CLASS]
    num_batches = [b * args.repetitions_dataset for b in per_pass]
    fed_steps = max(num_batches)
    node_steps = sum(num_batches)
    aggregations = (fed_steps - 1) // args.sync_every_n_batch + 1
    say("federated", config=FED_CONFIG.relative_to(ROOT), epochs=1,
        shards=json.dumps([sum(n) for n in FED_PER_CLASS]), batch=TRAIN_BATCH,
        federated_steps=fed_steps, node_steps=node_steps, aggregations=aggregations)

    # the main path: the train CLI, in-process, on cuda, from the repo root
    weights_dir = ROOT / "model_weights"
    had_weights_dir = weights_dir.exists()
    before = set(weights_dir.glob("final_federated_*.pt")) if had_weights_dir else set()
    argv = ["--config", str(ini), "--data_dir", str(root), "--train_federated",
            "--save_file", str(work / "federated_runs.csv"), "--device", "cuda"]
    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        reset_launches()
        torch.manual_seed(seed)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            best = train_cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        os.chdir(cwd)
        finals = sorted(set(weights_dir.glob("final_federated_*.pt")) - before)
        for f in finals:
            shutil.move(str(f), str(work / f.name))
        if not had_weights_dir:
            shutil.rmtree(weights_dir, ignore_errors=True)
    (work / "federated_cli.log").write_text(out.getvalue())
    want = idle_launches(tent_rows=4 * node_steps, clahe_lab=node_steps)
    check(launches == want, f"federated CLI launches {launches}, expected {want}")
    check(len(finals) == 1 and np.isfinite(best),
          f"federated CLI: best objective {best}, {len(finals)} final checkpoints")
    state = ckpt.load_model(work / finals[0].name)
    osd = state["optim_state_dict"]
    check(state["epoch"] == 1 and state["args"].train_federated
          and sorted(osd) == ["alice", "bob", "charlie"]
          and all(int(osd[w].step) == 0 for w in osd),
          f"federated checkpoint: epoch {state['epoch']}, optimizer states "
          f"{ {w: int(s.step) for w, s in osd.items()} }")
    losses = [float(line.split()[-1]) for line in out.getvalue().splitlines()
              if line.startswith("Train Epoch:")]
    check(len(losses) == 1 and np.isfinite(losses[0]), f"federated train losses {losses}")
    say("federated", cli_seconds=f"{cli_s:.4f}", launches=json.dumps(launches),
        tent_rows_per_node_step=launches["tent_rows"] / node_steps,
        clahe_lab_per_node_step=launches["clahe_lab"] / node_steps, eval_clahe_lab_launches=0,
        workers=",".join(sorted(osd)), epoch_loss=losses[0], best_mcc_percent=best)

    # the nodes as the CLI builds them, for the checks and the times
    dev = torch.device("cuda")
    os.chdir(ROOT)
    try:
        (names, node_imgs, node_labels, _, _, mean, std,
         _) = setup_federated(args, verbose=False, device=dev)
    finally:
        os.chdir(cwd)
    torch.manual_seed(seed)
    model = create_model(args, num_classes=3, device="cpu").to(dev)
    nodes = FederatedNodes(args, model, len(names), mean, std, None, dev)
    loaders = [BatchLoader(to_device_resident(x, dev), y, TRAIN_BATCH, seed=seed + i)
               for i, (x, y) in enumerate(zip(node_imgs, node_labels))]
    batches = [list(loader) for loader in loaders]
    weights = np.array(num_batches) / node_steps
    lr = 1e-4

    def fed_step(i):
        losses = nodes.step([b[i % len(b)] for b in batches], lr)
        return torch.stack(losses).mean()

    for i in range(3):
        fed_step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(FED_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = fed_step(i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(loss)), f"federated step {i}: loss {float(loss)}")
    avgs = profile(torch, lambda: [fed_step(i) for i in range(3)], 1)
    path = profile_out.with_name(profile_out.stem + ".federated" + profile_out.suffix)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(avgs.table(sort_by="self_cuda_time_total", row_limit=60))
    cats = {k: v / 3 for k, v in device_ms_by_category(avgs, 1).items()}

    # one node-stacked tree, aggregated on the card and on the CPU
    trees = [dict(zip(("params", "state"), to_jax_tree(m))) for m in nodes.models]
    stacked = {d: map_with_path(lambda p, _, d=d: torch.from_numpy(
        np.stack([_leaf(t, p) for t in trees])).to(d), trees[0]) for d in ("cuda", "cpu")}
    key, frac = (seed, 777, 1), args.precision_fractional
    on = {d: secure_fedavg(key, stacked[d], weights, frac) for d in stacked}
    plain = plain_fedavg(stacked["cpu"], weights)
    n_nodes, same_reveal, shares_differ, max_off_plain, n_leaves = len(names), True, 0, 0.0, 0
    flat = []
    map_with_path(lambda p, leaf: flat.append((p, leaf)), stacked["cpu"])
    for path, leaf in flat:
        if _is_count_leaf(path):
            continue
        n_leaves += 1
        w = torch.from_numpy(weights).reshape((-1,) + (1,) * (leaf.dim() - 1))
        reveal, share0 = {}, {}
        for d in ("cuda", "cpu"):
            ring = fixed.encode(_leaf(stacked[d], path).double() * w.to(d), frac)
            sh = S.share(S.stream(torch.device(d), *key, _leaf_key(path)), ring)
            reveal[d] = S.reconstruct(AShareSumNodes(sh)).cpu()
            share0[d] = sh.data[0].cpu()
        same_reveal &= torch.equal(reveal["cuda"], reveal["cpu"])
        shares_differ += not torch.equal(share0["cuda"], share0["cpu"])
        got, ref = _leaf(on["cuda"], path).cpu(), _leaf(on["cpu"], path)
        check(got.dtype == ref.dtype and torch.equal(got, ref),
              f"secure aggregate of {path}: the card's floats differ from the CPU's")
        exact = (leaf.double() * w).sum(0)
        bound = n_nodes * 2.0 ** -(frac + 1) + exact.abs() * 2.0 ** -24
        off = (ref.double() - exact).abs()
        check(bool((off <= bound).all()), f"secure aggregate of {path}: {float(off.max())} from "
              f"the plain average, over N * 2^-(f+1)")
        max_off_plain = max(max_off_plain, float((ref - _leaf(plain, path)).abs().max()))
    check(same_reveal, "the card's and the CPU's int64 reveals differ")
    check(shares_differ == n_leaves, f"the card's and the CPU's shares agree on "
          f"{n_leaves - shares_differ} of {n_leaves} leaves: the check does not cover the shares")
    say("federated", card_vs_cpu="bit-equal", leaves=n_leaves, reveals_int64="equal",
        shares="differ", max_abs_secure_minus_plain=max_off_plain,
        bound=n_nodes * 2.0 ** -(frac + 1))

    # the aggregations and the round
    rounds = iter(range(2, 10 ** 6))
    secure = lambda: nodes.aggregate(weights, (seed, 777, next(rounds)))  # noqa: E731
    secure_ms = p50_ms(torch, np, secure, FED_TIMED_AGGREGATIONS)
    plain_ms = p50_ms(torch, np, lambda: nodes.aggregate(weights, None),
                      FED_TIMED_AGGREGATIONS)
    agg_avgs = profile(torch, lambda: [secure() for _ in range(2)], 1)
    agg_busy = sum(device_ms_by_category(agg_avgs, 2).values())
    agg_ops = sum(e.count for e in agg_avgs if e.key.startswith("aten::")) / 2

    def fed_round():
        for i in range(args.sync_every_n_batch):
            fed_step(i)
        secure()
        nodes.reset_optimizers()

    round_ms = p50_ms(torch, np, fed_round, FED_TIMED_ROUNDS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    q = np.percentile(step_ms, [50, 75])
    busy = sum(cats.values())
    imgs = n_nodes * TRAIN_BATCH
    say("federated", nodes=n_nodes, batch_per_node=TRAIN_BATCH, steps_timed=len(step_ms),
        fed_step_ms_p50=f"{q[0]:.4f}", fed_step_ms_p75=f"{q[1]:.4f}",
        img_per_s_p50=f"{imgs / (q[0] * 1e-3):.2f}", device_busy_ms_per_step=f"{busy:.4f}",
        idle_share=f"{1.0 - busy / q[0]:.4f}" if busy > 0 else "not measured",
        secure_agg_ms_p50=f"{secure_ms:.4f}", plain_agg_ms_p50=f"{plain_ms:.4f}",
        secure_agg_busy_ms=f"{agg_busy:.4f}", secure_agg_aten_ops=f"{agg_ops:.1f}",
        secure_agg_idle_share=f"{1.0 - agg_busy / secure_ms:.4f}" if agg_busy > 0
        else "not measured",
        round_s_p50=f"{round_ms * 1e-3:.4f}", round_steps=args.sync_every_n_batch,
        peak_memory_gb=f"{peak_gb:.3f}", cli_seconds=f"{cli_s:.4f}")
    say("federated", device_ms_per_step=json.dumps({k: round(v, 6) for k, v in cats.items()}))
    return launches


DP_CONFIG = ROOT / "configs" / "torch" / "pneumonia-resnet-dp.ini"
DP_FED_CONFIG = ROOT / "configs" / "torch" / "pneumonia-resnet-dp-federated.ini"
DP_BATCH = 512
DP_TRAIN_PER_CLASS = (342, 341, 341)  # 1,024 images: 2 steps at batch 512
DP_FED_PER_CLASS = (171, 171, 170)  # 512 images a node: one step each
DP_TIMED_STEPS, DP_WARMUP = 3, 1
DP_FED_TIMED_STEPS, DP_FED_TIMED_ROUNDS = 2, 2
K7_PER_GHOST_STEP = 3  # layer3's three stride-1 256 -> 256 convs (T = 196, the gram form)
DP_G1_BATCH = 64  # the microbatched step under PRIMIA_PALLAS_WGRAD=1, cut from 512


def run_cli(torch, cli, argv, cwd, log):
    """``cli.main(argv)`` in-process from ``cwd`` with its output to
    ``log``, the launch counters set to 0 just before and read just after.
    Returns (result, output, seconds, launches)."""
    out = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            result = cli.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
    finally:
        os.chdir(old)
    log.write_text(out.getvalue())
    return result, out.getvalue(), secs, launches


def eps_line(text):
    lines = [line for line in text.splitlines() if line.startswith("(eps = ")]
    check(len(lines) == 1, f"expected one epsilon line, got {lines}")
    return lines[0]


def leaf_gap(torch, got, want, rel):
    """The largest |got - want| over the leaves relative to each leaf's
    max |want|, and its leaf; fails past ``rel``."""
    worst, where = 0.0, None
    for n, w in want.items():
        scale = float(w.abs().max())
        gap = float((got[n] - w).abs().max()) / scale if scale > 0 else float(got[n].abs().max())
        if gap >= worst:
            worst, where = gap, n
    return worst, where, worst <= rel


def k1_at_dp_shape(torch, seed, args):
    """K1 against its plain version, bit for bit, at the DP step's shape: the
    affine warp's two passes over the K x B stacked views (2048 x 3 planes of
    224 x 224 from the DP INI's own affine draws), with times, bound and
    ``grid_sample`` as library_ms."""
    import torch.nn.functional as F

    from primia_tpu_torch.ops import augment as A
    from primia_tpu_torch.ops import cuda_tent as ct
    from primia_tpu_torch.ops import image as I

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    B, C, H, W = DP_BATCH * args.augment_multiplicity, 3, RES, RES
    cfg = A.AugmentConfig.from_args(args)
    check(I.twopass_safe(cfg.rotation, cfg.shear, cfg.scale), "the DP INI's affine ranges "
          "are not two-pass safe: K1 would not run")
    planes = torch.rand((B * C, H, W), generator=g, device=dev)
    q, p = I.twopass_coords(A._affine_mats(g, cfg, B), H, W)
    rr, cc = I.pixel_grid(H, W, dev)
    px = B * C * H * W
    for case, coords, axis in (("affine_rows", q, 2), ("affine_cols", p, 1)):
        got = ct.tent_rows(planes, coords, axis=axis)
        torch.cuda.synchronize()
        check(torch.equal(got, ct.tent_rows_plain(planes, coords, axis=axis)),
              f"tent_rows differs from plain at the DP shape, {case}")
        ys, xs = (rr.expand(B, H, W), coords) if axis == 2 else (coords, cc.expand(B, H, W))
        grid = grid_for(torch, ys, xs, H, W)
        img = planes.reshape(B, C, H, W)
        r = timed_record(torch, "tent_rows", lambda: ct.tent_rows(planes, coords, axis=axis),
                         lambda: ct.tent_rows_plain(planes, coords, axis=axis),
                         lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                               align_corners=True),
                         bound(4 * (2 * px + B * H * W), 6 * px), iters=10, plain_iters=2)
        kern_events = sum(e.count for e in profile(
            torch, lambda: ct.tent_rows(planes, coords, axis=axis), 4)
            if "tent_rows_kernel" in e.key) / 4
        _say_times("dp", r, kernel="tent_rows", shape=f"{B}x{C}x{H}x{W}", case=case,
                   max_abs_err=0.0, kernel_events_per_call=kern_events)
        del got, grid


def phase_dp(torch, seed, work, profile_out):
    """Phase 16: slice 5's main path, DP-SGD on ResNet-18 with group norm at
    224 px (configs/torch/pneumonia-resnet-dp.ini: batch 512, augmentation
    multiplicity 4, SGD with momentum, EMA 0.99, sigma 2.0; only ``epochs``
    (60 -> 1) and ``test_interval`` (2 -> 1) cut), from the He init with the
    zero fc (no ImageNet file visible). Returns the launch counts of the DP
    CLI, the switched ghost steps and the federated DP CLI."""
    import numpy as np

    from primia_tpu_torch.cli import evaluate as eval_cli
    from primia_tpu_torch.cli import train as train_cli
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.data import (BatchLoader, ImageFolderDataset, calc_mean_std,
                                       to_device_resident)
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.parallel.federated import FederatedNodes, setup_federated
    from primia_tpu_torch.train import checkpoint as ckpt
    from primia_tpu_torch.train import dp
    from primia_tpu_torch.train.optim import make_optimizer

    os.environ.pop("PRIMIA_PRETRAINED", None)
    root = work / "dp"
    rng = np.random.default_rng(seed + 3)
    write_classes(np, rng, root / "train", DP_TRAIN_PER_CLASS)
    write_classes(np, rng, root / "test", (TEST_PER_CLASS,) * len(CLASSES))
    check(not (root / "model_weights" / "resnet-18-imagenet.pt").exists(),
          "an ImageNet file is visible to the DP run")
    text = DP_CONFIG.read_text()
    check("epochs = 60" in text and "test_interval = 2" in text,
          f"unexpected DP config: {DP_CONFIG}")
    ini = work / "dp.ini"
    ini.write_text(text.replace("epochs = 60", "epochs = 1").replace("test_interval = 2",
                                                                     "test_interval = 1"))
    args = Arguments.from_ini(ini)
    K = args.augment_multiplicity
    check(args.batch_size == DP_BATCH and K == 4 and args.normalization == "group"
          and args.optimizer == "SGD" and args.momentum and args.weight_decay == 0.0
          and args.parameter_ema == 0.99 and args.noise_multiplier == 2.0
          and args.differentially_private and not args.clahe,
          f"unexpected DP config: {DP_CONFIG}")
    n_train = sum(DP_TRAIN_PER_CLASS)
    steps = -(-n_train // DP_BATCH)
    say("dp", config=DP_CONFIG.relative_to(ROOT), epochs=1, test_interval=1,
        train_images=n_train, test_images=TEST_PER_CLASS * len(CLASSES), batch=DP_BATCH,
        augment_multiplicity=K, steps=steps, microbatch=int(os.environ.get(
            "PRIMIA_DP_MICROBATCH", 8)))
    k1_at_dp_shape(torch, seed, args)

    # the main path: the DP train CLI, in-process, on cuda
    _, out, cli_s, launches = run_cli(torch, train_cli, [
        "--config", str(ini), "--data_dir", str(root / "train"), "--device", "cuda"],
        root, work / "dp_cli.log")
    want = idle_launches(tent_rows=2 * steps)
    check(launches == want, f"DP CLI launches {launches}, expected {want}")
    finals = sorted((root / "model_weights").glob("final_*.pt"))
    check(len(finals) == 1, f"DP CLI wrote {len(finals)} final checkpoints")
    state = ckpt.load_model(finals[0])
    check(state["epoch"] == 1 and int(state["optim_state_dict"].step) == steps
          and "raw_params" in state and state["args"].differentially_private,
          "the DP checkpoint lacks its epoch, optimizer step or raw parameters")
    eps, alpha = dp.rdp_epsilon(noise_multiplier=2.0, sample_rate=DP_BATCH / n_train,
                                steps=steps, delta=args.target_delta)
    line = eps_line(out)
    check(line == f"(eps = {eps:.2f}, delta = {args.target_delta}) at alpha = {alpha}",
          f"epsilon line {line!r}")
    m, _, eval_s, eval_launches = run_cli(torch, eval_cli, [
        "--model_weights", str(finals[0]), "--data_dir", str(root / "test"), "--device", "cuda"],
        root, work / "dp_evaluate.log")
    check(int(np.asarray(m["conf_matrix"]).sum()) == TEST_PER_CLASS * len(CLASSES)
          and eval_launches == idle_launches(), f"evaluate CLI on the EMA checkpoint: {m}")
    say("dp", cli_seconds=f"{cli_s:.4f}", launches=json.dumps(launches),
        tent_rows_per_step=launches["tent_rows"] / steps, epsilon_line=json.dumps(line),
        checkpoint="ema_with_raw_params", evaluate_cli_seconds=f"{eval_s:.4f}",
        evaluate_mcc=m["matthews_coeff"])

    # timed steps on a model and data set up as the loop does
    dev = torch.device("cuda")
    ds = ImageFolderDataset(root / "train", channels=3)
    imgs, labels = ds.materialize(RES)
    mean, std = calc_mean_std(imgs)
    loader = BatchLoader(to_device_resident(imgs, dev), labels, DP_BATCH, seed=seed,
                         pad_final=False)
    batches = list(loader)

    def fresh(a, fc_std=0.0):
        torch.manual_seed(seed)
        model = create_model(a, num_classes=3, device="cpu").to(dev)
        if fc_std:  # every layer gets a gradient from the first step
            torch.nn.init.normal_(model.fc.weight, std=fc_std)
        return model

    def stepper(a, model, opt=None):
        step = dp.select_train_step(model, opt or make_optimizer(a, model), a, mean, std,
                                    None, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return lambda i: step(gen, batches[i % len(batches)].images,
                              batches[i % len(batches)].labels, batches[i % len(batches)].mask,
                              a.lr)

    mb = int(os.environ.get("PRIMIA_DP_MICROBATCH", 8))
    p50 = time_steps(torch, np, stepper(args, fresh(args)), "dp.microbatched", profile_out,
                     ".dp_microbatched", batch=DP_BATCH, steps=DP_TIMED_STEPS,
                     warmup=DP_WARMUP, n_prof=1, augment_multiplicity=K, microbatch=mb)[0]
    say("dp.microbatched", examples_per_s_p50=f"{DP_BATCH / (p50 * 1e-3):.2f}",
        views_per_s_p50=f"{K * DP_BATCH / (p50 * 1e-3):.2f}")
    # the host's share: the same step in chunks of 32 examples
    old = os.environ.get("PRIMIA_DP_MICROBATCH")
    os.environ["PRIMIA_DP_MICROBATCH"] = "32"
    try:
        run = stepper(args, fresh(args))
        mb32_ms = p50_ms(torch, np, lambda: run(0), 2)
    finally:
        os.environ.pop("PRIMIA_DP_MICROBATCH")
        if old is not None:
            os.environ["PRIMIA_DP_MICROBATCH"] = old
    say("dp.microbatched", microbatch=32, steps_timed=2, step_ms_p50=f"{mb32_ms:.4f}",
        examples_per_s_p50=f"{DP_BATCH / (mb32_ms * 1e-3):.2f}")
    ghost = Arguments.from_ini(ini)
    ghost.augment_multiplicity = 1
    time_steps(torch, np, stepper(ghost, fresh(ghost)), "dp.ghost", profile_out, ".dp_ghost",
               batch=DP_BATCH, steps=DP_TIMED_STEPS, warmup=DP_WARMUP, n_prof=1,
               augment_multiplicity=1)
    with switches("PRIMIA_PALLAS_WGRAD"):
        run = stepper(ghost, fresh(ghost))
        run(0)
        reset_launches()
        for i in range(2):
            run(i)
        torch.cuda.synchronize()
        ghost_launches = read_launches()
        want = idle_launches(tent_rows=2 * 2, conv3x3_wgrad=2 * K7_PER_GHOST_STEP)
        check(ghost_launches == want,
              f"switched ghost steps: launches {ghost_launches}, expected {want}")
        time_steps(torch, np, run, "dp.ghost_optin", profile_out, ".dp_ghost_optin",
                   batch=DP_BATCH, steps=DP_TIMED_STEPS, warmup=1, n_prof=1,
                   conv3x3_wgrad_per_step=K7_PER_GHOST_STEP)

    # the switched ghost step's clipped sum at sigma = 0 against the default's
    quiet = Arguments.from_ini(ini)
    quiet.augment_multiplicity, quiet.noise_multiplier = 1, 0.0
    grads = {}
    for label, names in (("default", ()), ("switched", ("PRIMIA_PALLAS_WGRAD",))):
        with switches(*names):
            model = fresh(quiet, fc_std=0.05)
            rec = _GradRecorder(model)
            stepper(quiet, model, rec)(0)
            grads[label] = rec.grads
    gap, leaf, ok = leaf_gap(torch, grads["switched"], grads["default"], 2e-2)
    check(ok, f"switched ghost step's clipped sum vs the default's: {gap} of {leaf}'s max")
    say("dp", ghost_optin_vs_default="ok", max_gap_of_leaf_max=gap, leaf=leaf, limit=2e-2)

    # K7 under vmap: the microbatched step (K = 4, bfloat16) under
    # PRIMIA_PALLAS_WGRAD=1 on DP_G1_BATCH examples, K7 once an example for
    # each of layer2's and layer3's stride-1 convs; at sigma = 0 its clipped
    # sum against the unswitched step's within the switched ghost step's 2e-2
    g1 = Arguments.from_ini(ini)
    g1.noise_multiplier = 0.0
    part = [t[:DP_G1_BATCH] for t in (batches[0].images, batches[0].labels, batches[0].mask)]
    grads, g1_ms, g1_launches = {}, {}, {}
    for label, names in (("default", ()), ("switched", ("PRIMIA_PALLAS_WGRAD",))):
        with switches(*names):
            model = fresh(g1, fc_std=0.05)
            rec = _GradRecorder(model)
            step = dp.build_dp_train_step(model, rec, g1, mean, std, None, dev)

            def run_g1():
                step(torch.Generator(device=dev).manual_seed(seed), *part, g1.lr)

            reset_launches()
            run_g1()
            torch.cuda.synchronize()
            g1_launches[label] = read_launches()
            grads[label] = rec.grads
            g1_ms[label] = p50_ms(torch, np, run_g1, 2)
    want = idle_launches(tent_rows=2, conv3x3_wgrad=DP_G1_BATCH * K7_PER_STEP)
    check(g1_launches["switched"] == want, f"switched microbatched step: launches "
          f"{g1_launches['switched']}, expected {want}")
    check(g1_launches["default"] == idle_launches(tent_rows=2),
          f"default microbatched step: launches {g1_launches['default']}")
    gap, leaf, ok = leaf_gap(torch, grads["switched"], grads["default"], 2e-2)
    check(ok, f"switched microbatched step's clipped sum vs the default's: {gap} of {leaf}'s max")
    say("dp.micro_optin", batch=DP_G1_BATCH, augment_multiplicity=g1.augment_multiplicity,
        launches=json.dumps(g1_launches["switched"]), max_gap_of_leaf_max=gap, leaf=leaf,
        limit=2e-2, switched_step_ms_p50=f"{g1_ms['switched']:.4f}",
        default_step_ms_p50=f"{g1_ms['default']:.4f}", steps_timed=2)

    # sigma = 0, float32, augmentation off: ghost against microbatched on the
    # card on the data set's images, and the card's microbatched step against
    # the CPU's on uniform noise images: the synthetic X-rays' saturated flat
    # regions tie in the stem's max pool, and the card's and the CPU's
    # kernels break ties apart, which moves the stem's gradient
    f32 = Arguments.from_ini(ini)
    f32.compute_dtype, f32.noise_multiplier, f32.augment_multiplicity = "float32", 0.0, 1
    f32.rotation = f32.translate = f32.scale = f32.shear = 0.0
    f32.albu_prob = 0.0
    torch.manual_seed(seed)
    sd = create_model(f32, num_classes=3, device="cpu").state_dict()
    sd["fc.weight"].normal_(0, 0.05)

    def clipped_sum(where, make_step, images, microbatch=None):
        model = create_model(f32, num_classes=3, device=where)
        model.load_state_dict(sd)
        rec = _GradRecorder(model)
        kw = {} if microbatch is None else {"microbatch": microbatch}
        step = make_step(model, rec, f32, mean, std, None, where, **kw)
        n = images.shape[0]
        b = batches[0]
        loss = float(step(torch.Generator(device=where).manual_seed(0),
                          torch.as_tensor(images).to(where), b.labels[:n], b.mask[:n], 1.0))
        return loss, rec.grads

    _, g_ghost = clipped_sum("cuda", dp.build_ghost_dp_train_step, batches[0].images[:16])
    _, g_micro = clipped_sum("cuda", dp.build_dp_train_step, batches[0].images[:16])
    gap, leaf, ok = leaf_gap(torch, g_ghost, g_micro, 1e-4)
    check(ok, f"ghost vs microbatched clipped sum on the card: {gap} of {leaf}'s max")
    say("dp", ghost_vs_microbatched="ok", examples=16, max_gap_of_leaf_max=gap, leaf=leaf,
        limit=1e-4)
    noise_imgs = torch.from_numpy(np.random.default_rng(seed + 4).integers(
        0, 256, (4, RES, RES, 3), dtype=np.uint8))
    l_card, g_card = clipped_sum("cuda", dp.build_dp_train_step, noise_imgs, microbatch=4)
    l_cpu, g_cpu = clipped_sum("cpu", dp.build_dp_train_step, noise_imgs, microbatch=4)
    gap, leaf, ok = leaf_gap(torch, g_card, g_cpu, 1e-4)
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    check(ok and rel <= 1e-4, f"card vs CPU microbatched step: clipped sum {gap} of {leaf}'s "
          f"max, loss {l_card} vs {l_cpu}")
    say("dp", cpu_check="ok", examples=4, images="uniform noise", max_gap_of_leaf_max=gap,
        leaf=leaf, loss_rel_diff=rel, limit=1e-4)

    # the noise: one step from a fresh optimizer at sigma = 2 against sigma = 0
    after = {}
    for sigma in (0.0, args.noise_multiplier):
        a = Arguments.from_ini(ini)
        a.augment_multiplicity, a.noise_multiplier = 1, sigma
        model = fresh(a, fc_std=0.05)
        stepper(a, model)(0)
        after[sigma] = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).double()
    denom = float(batches[0].mask.sum())
    z = (after[0.0] - after[args.noise_multiplier]) * denom / (
        args.lr * args.noise_multiplier * args.max_grad_norm)
    n = z.numel()
    zm, zs = float(z.mean()), float(z.std())
    check(abs(zm) <= 3 / n ** 0.5 and abs(zs - 1.0) <= 3 / (2 * n) ** 0.5,
          f"DP noise: mean {zm}, std {zs} over {n} values")
    say("dp", noise="ok", values=n, mean=zm, std=zs, mean_limit=3 / n ** 0.5,
        std_limit=3 / (2 * n) ** 0.5)

    # the federated DP CLI: 3 nodes of 512 images, one step each, secure
    # aggregation, workers worker1..3 (no websetting CSV in the cwd)
    froot = work / "dp_federated"
    write_federated_dataset(np, rng, froot, (DP_FED_PER_CLASS,) * 3)
    text = DP_FED_CONFIG.read_text()
    check("epochs = 60" in text and "test_interval = 2" in text,
          f"unexpected federated DP config: {DP_FED_CONFIG}")
    fini = work / "dp_federated.ini"
    fini.write_text(text.replace("epochs = 60", "epochs = 1").replace("test_interval = 2",
                                                                      "test_interval = 1"))
    fargs = Arguments.from_ini(fini, cmd_args=argparse.Namespace(data_dir=str(froot),
                                                                 train_federated=True))
    check(fargs.batch_size == DP_BATCH and fargs.sync_every_n_batch == 1
          and fargs.keep_optim_dict and fargs.augment_multiplicity == 4 and fargs.epochs == 1
          and not fargs.unencrypted_aggregation and fargs.noise_multiplier == 3.0,
          f"unexpected federated DP config: {DP_FED_CONFIG}")
    node_steps = 3
    _, out, fed_cli_s, fed_launches = run_cli(torch, train_cli, [
        "--config", str(fini), "--data_dir", str(froot), "--train_federated",
        "--device", "cuda"], froot, work / "dp_federated_cli.log")
    want = idle_launches(tent_rows=2 * node_steps)
    check(fed_launches == want, f"federated DP CLI launches {fed_launches}, expected {want}")
    finals = sorted((froot / "model_weights").glob("final_federated_*.pt"))
    check(len(finals) == 1, f"federated DP CLI wrote {len(finals)} final checkpoints")
    state = ckpt.load_model(finals[0])
    osd = state["optim_state_dict"]
    check(state["epoch"] == 1 and "raw_params" in state
          and sorted(osd) == ["worker1", "worker2", "worker3"]
          and all(int(osd[w].step) == 1 for w in osd),
          "the federated DP checkpoint lacks its epoch, raw parameters or kept optimizers")
    line = eps_line(out)
    check("[worst node: " in line, f"federated epsilon line {line!r}")
    say("dp_federated", config=DP_FED_CONFIG.relative_to(ROOT), epochs=1, nodes=3,
        batch_per_node=DP_BATCH, cli_seconds=f"{fed_cli_s:.4f}",
        launches=json.dumps(fed_launches),
        tent_rows_per_node_step=fed_launches["tent_rows"] / node_steps,
        epsilon_line=json.dumps(line), checkpoint="ema_with_raw_params")

    # the federated step and round, on the nodes as the CLI builds them
    cwd = os.getcwd()
    os.chdir(froot)
    try:
        names, node_imgs, node_labels, _, _, fmean, fstd, _ = setup_federated(
            fargs, verbose=False, device=dev)
    finally:
        os.chdir(cwd)
    torch.manual_seed(seed)
    nodes = FederatedNodes(fargs, create_model(fargs, num_classes=3, device="cpu").to(dev),
                           len(names), fmean, fstd, None, dev)
    node_batches = [next(iter(BatchLoader(to_device_resident(x, dev), y, DP_BATCH,
                                          seed=seed + i)))
                    for i, (x, y) in enumerate(zip(node_imgs, node_labels))]
    weights = np.full(len(names), 1.0 / len(names))
    rounds = iter(range(1, 10 ** 6))

    def fed_step():
        nodes.step(node_batches, fargs.lr)

    def fed_round():  # sync_every_n_batch = 1: a step and a secure aggregation
        fed_step()
        nodes.aggregate(weights, (seed, 777, next(rounds)))

    torch.cuda.reset_peak_memory_stats()
    step_ms = p50_ms(torch, np, fed_step, DP_FED_TIMED_STEPS)
    round_ms = p50_ms(torch, np, fed_round, DP_FED_TIMED_ROUNDS)
    say("dp_federated", fed_step_ms_p50=f"{step_ms:.4f}", steps_timed=DP_FED_TIMED_STEPS,
        round_s_p50=f"{round_ms * 1e-3:.4f}", rounds_timed=DP_FED_TIMED_ROUNDS,
        round_steps=fargs.sync_every_n_batch,
        examples_per_s_p50=f"{3 * DP_BATCH / (step_ms * 1e-3):.2f}",
        peak_memory_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    return {"dp": launches, "dp_ghost_optin": ghost_launches,
            "dp_micro_optin": g1_launches["switched"], "dp_federated": fed_launches}


# ---------------------------------------------------------------- slice 6a
VGG_CONFIG = ROOT / "configs" / "torch" / "pneumonia-vgg.ini"
CONV_CONFIG = ROOT / "configs" / "torch" / "pneumonia-conv.ini"
MNIST_CONFIG = ROOT / "configs" / "torch" / "mnist.ini"
CONV_DP_CONFIG = ROOT / "configs" / "torch" / "pneumonia-conv-dp.ini"
CONV_DP_FED_CONFIG = ROOT / "configs" / "torch" / "pneumonia-conv-dp-federated.ini"
VGG_BATCH, CONV_BATCH = 64, 4
VGG_TIMED_STEPS, CONV_TIMED_STEPS = 12, 24
# K7 on VGG-16: features.3-6 (128 -> 128 at 112^2, 128 -> 256 and 256 -> 256 at
# 56^2): the ten convs with at least 128 channels in and out take
# conv3x3_s1p1, and the JAX rule (pallas_wgrad.py:_bwd) keeps the library's
# weight gradient where max(ci, co) = 512
K7_PER_VGG_STEP = 4
VGG_K7_SHAPES = ((VGG_BATCH, 128, 128, 112, 112), (VGG_BATCH, 128, 256, 56, 56),
                 (VGG_BATCH, 256, 256, 56, 56))
# SimpleConv@224's three batch norms at train batch 4: C = 8, 32, 128 after
# pools 1, 2 and 4
CONV_BN_SHAPES = {"conv_bn0": (CONV_BATCH, 8, 111, 111), "conv_bn1": (CONV_BATCH, 32, 54, 54),
                  "conv_bn3": (CONV_BATCH, 128, 12, 12)}
# comparisons a forward under fss: ReLUs + 2 rounds a 2x2 max pool
SIGNS_VGG, SIGNS_CONV224, SIGNS_CONV28 = 15 + 5 * 2, 8 + 6 * 2, 8 + 3 * 2
VGG_ENCRYPT_IMAGES = 4
# live_head's (std, layers): VGG-16's whole classifier, SimpleConv's head
VGG_HEAD, CONV_HEAD = (0.05, 3), (0.1, 1)
MNIST_TRAIN, MNIST_TEST = 640, 100


def quiet_model(create_model, args, **kw):
    """``create_model`` without the warning of ``pretrained = yes`` with no
    weights file (VGG-16 keeps its He init, as the JAX package's)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return create_model(args, num_classes=3, **kw)


def cut_ini(work, src, cuts):
    """``src`` with each (old, new) replaced, written under ``work``."""
    text = src.read_text()
    for old, new in cuts:
        check(old in text, f"unexpected config {src}: no {old!r}")
        text = text.replace(old, new)
    ini = work / src.name
    ini.write_text(text)
    return ini


def serve_family(torch, np, phase, args, model, weights, work, data, n_channels):
    """The inference CLI on the serve phase's 64 DICOMs at batch 16 (CLAHE
    once a batch), the card's logits for 4 images against the CPU's
    predict step, and the predict step's p50 at batch 16."""
    from primia_tpu_torch.cli import inference
    from primia_tpu_torch.data import PathDataset
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.train.steps import build_predict_step

    mean_std = (np.full(n_channels, 0.45), np.full(n_channels, 0.25))
    result, out, cli_s, launches = run_cli(torch, inference, [
        "--data_dir", str(data), "--model_weights", str(weights), "--batch_size", str(BATCH),
        "--device", "cuda"], work, work / f"{phase}_serve_cli.log")
    n_batches = -(-N_IMAGES // BATCH)
    preds = result["Inference Results"]
    check(len(preds) == N_IMAGES and set(preds.values()) <= {0, 1, 2},
          f"{phase}: bad inference results {str(preds)[:200]}")
    want = idle_launches(**{clahe_counter(n_channels): n_batches if args.clahe else 0})
    check(launches == want, f"{phase}: serving launches {launches}, expected {want}")
    imgs, _ = PathDataset(data, channels=n_channels).materialize(args.inference_resolution)
    chunks = [imgs[i:i + BATCH] for i in range(0, N_IMAGES, BATCH)]
    gpu = quiet_model(create_model, args, device="cuda")
    gpu.load_state_dict(model.state_dict())
    predict = build_predict_step(gpu, args, *mean_std, "cuda")
    logits = predict(chunks[0]).float().cpu()
    cpu = quiet_model(create_model, args, device="cpu")
    cpu.load_state_dict(model.state_dict())
    ref = build_predict_step(cpu, args, *mean_std, "cpu")(chunks[0][:4])
    dl, scale = float((logits[:4] - ref).abs().max()), float(ref.abs().max())
    check(bool(torch.isfinite(logits).all()) and torch.equal(logits[:4].argmax(1), ref.argmax(1))
          and dl <= 1e-3 * scale, f"{phase}: card vs CPU logits max |d| {dl}, max |logit| {scale}")
    batch_ms = p50_ms(torch, np, lambda: predict(chunks[1]), 12)
    say(phase, path="serve", cli_seconds=f"{cli_s:.4f}", launches=json.dumps(launches),
        cpu_check="ok", max_abs_dlogit=dl, max_abs_logit=scale, batch=BATCH,
        batch_ms_p50=f"{batch_ms:.4f}", img_per_s_p50=f"{BATCH / (batch_ms * 1e-3):.2f}")
    return launches


def train_family(torch, np, phase, ini, args, data_root, work, per_step):
    """The train CLI for one epoch on ``data_root/train`` on cuda, counters
    set to 0 just before and read just after (``per_step`` launches a
    step). Returns the launches and the CLI's seconds."""
    from primia_tpu_torch.cli import train as train_cli
    from primia_tpu_torch.train import checkpoint as ckpt

    n_train = sum(1 for _ in (data_root / "train").rglob("*.dcm"))
    steps = -(-n_train // args.batch_size)
    run_dir = work / f"{phase}_run"
    run_dir.mkdir()
    best, out, cli_s, launches = run_cli(torch, train_cli, [
        "--config", str(ini), "--data_dir", str(data_root / "train"), "--device", "cuda"],
        run_dir, work / f"{phase}_train_cli.log")
    want = idle_launches(**{k: n * steps for k, n in per_step.items()})
    check(launches == want, f"{phase}: train CLI launches {launches}, expected {want}")
    finals = sorted((run_dir / "model_weights").glob("final_*.pt"))
    check(len(finals) == 1 and np.isfinite(best), f"{phase}: train CLI: {finals}, best {best}")
    state = ckpt.load_model(finals[0])
    check(state["epoch"] == 1 and int(state["optim_state_dict"].step) == steps,
          f"{phase}: final checkpoint has the wrong epoch or optimizer step")
    say(phase, path="train", epochs=1, train_images=n_train, batch=args.batch_size, steps=steps,
        cli_seconds=f"{cli_s:.4f}", launches=json.dumps(launches), best_mcc_percent=best)
    return launches, out


def family_steps(torch, args, data_root, seed, n_channels):
    """(model factory, the loop's batches on the card, mean, std) of
    ``data_root/train`` at ``args.batch_size``."""
    from primia_tpu_torch.data import (BatchLoader, ImageFolderDataset, calc_mean_std,
                                       to_device_resident)
    from primia_tpu_torch.nn import create_model

    dev = torch.device("cuda")
    imgs, labels = ImageFolderDataset(data_root / "train", channels=n_channels).materialize(
        args.inference_resolution)
    mean, std = calc_mean_std(imgs)
    batches = list(BatchLoader(to_device_resident(imgs, dev), labels, args.batch_size,
                               seed=seed, pad_final=False))

    def fresh(a):
        torch.manual_seed(seed)
        return quiet_model(create_model, a, device="cpu").to(dev)

    return fresh, batches, mean, std


def stepper(torch, step, batches, seed, lr=1e-4):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    full = [b for b in batches if bool(b.mask.all())]

    def run(i):
        b = full[i % len(full)]
        return step(gen, b.images, b.labels, b.mask, lr)

    return run


def switched_against_default(torch, np, phase, args, fresh, batches, mean, std, switch,
                             per_step, profile_out, steps, compare, head):
    """Two steps under ``switch`` with their exact launches, ``steps`` timed
    steps switched and default in one call, and one bfloat16 step with
    augmentation and mixup off, switched against default from the same
    weights (:func:`live_head` ``head``) and batch: the loss within 1e-2
    relative, the gradients of the parameters whose names start with one of
    ``compare`` within 2e-2 of their max |g|, and any BN running statistics
    within 2e-2 of their max.
    (Hidden layers' gradients behind a ReLU are not compared where the
    switch moves the forward's last bits: a unit near 0 that flips moves
    a whole row of the next weight's gradient.)"""
    from primia_tpu_torch.train.optim import make_optimizer
    from primia_tpu_torch.train.steps import build_train_step

    timed = {}
    for label, names in (("default", ()), ("switched", (switch,))):
        with switches(*names):
            model = fresh(args)
            run = stepper(torch, build_train_step(model, make_optimizer(args, model), args,
                                                  mean, std, device="cuda"), batches, seed=1)
            if names:
                run(0)
                reset_launches()
                for i in range(2):
                    run(i)
                torch.cuda.synchronize()
                launches = read_launches()
                want = idle_launches(**{k: 2 * n for k, n in per_step.items()})
                check(launches == want, f"{phase}: switched steps launch {launches}, "
                      f"expected {want}")
            timed[label] = time_steps(torch, np, run, f"{phase}.{label}", profile_out,
                                      f".{phase}_{label}", batch=args.batch_size, steps=steps,
                                      warmup=2, n_prof=2)
    say(phase, switch=switch,
        switched_over_default_p50=f"{timed['switched'][0] / timed['default'][0]:.4f}")
    quiet = dataclasses.replace(args)
    quiet.rotation = quiet.translate = quiet.scale = quiet.shear = 0.0
    quiet.albu_prob = quiet.noise_prob = 0.0
    quiet.clahe = quiet.mixup = quiet.elastic = False
    b = batches[0]
    res = {}
    for label, names in (("default", ()), ("switched", (switch,))):
        with switches(*names):
            model = live_head(torch, fresh(quiet), *head)
            rec = _GradRecorder(model)
            loss = float(build_train_step(model, rec, quiet, mean, std, device="cuda")(
                torch.Generator(device="cuda").manual_seed(0), b.images, b.labels, b.mask, 1e-4))
            seen = {n: g for n, g in rec.grads.items() if n.startswith(compare)}
            seen.update({n: t.detach().float().cpu() for n, t in model.named_buffers()
                         if n.endswith(("running_mean", "running_var"))})
            res[label] = (loss, seen)
    (ls, gs), (ld, gd) = res["switched"], res["default"]
    gap, leaf, ok = leaf_gap(torch, gs, gd, 2e-2)
    check(abs(ls - ld) <= 1e-2 * abs(ld) and ok, f"{phase}: switched vs default bf16 step: "
          f"loss {ls} vs {ld}, {gap} of {leaf}'s max")
    say(phase, switched_vs_default="ok", loss_switched=ls, loss_default=ld,
        max_gap_of_leaf_max=gap, leaf=leaf, limit=2e-2)
    return launches


def live_head(torch, model, std, layers=1):
    """The last ``layers`` classifier linears' weights N(0, ``std``): a
    group-norm model's zero head leaves every logit 0, VGG-16's N(0, 0.01)
    init (all three) leaves them near 1e-3, and a comparison of logits or
    of a loss at ln 3 then shows nothing."""
    with torch.no_grad():
        for lin in model.classifier[-layers:]:
            lin.weight.normal_(0, std)
    return model


def f32_step_card_vs_cpu(torch, np, phase, args, n_channels, compare, seed, head):
    """One float32 step, augmentation and mixup off, on uniform noise images
    (flat X-rays tie in the max pools, which the card and the CPU break
    apart): the card against the CPU from the same weights, the loss within
    1e-4 relative and the parameters named by ``compare`` within 1e-3 of
    their max |g|."""
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.train.steps import build_train_step

    f32 = dataclasses.replace(args)
    f32.compute_dtype = "float32"
    f32.rotation = f32.translate = f32.scale = f32.shear = 0.0
    f32.albu_prob = f32.noise_prob = 0.0
    f32.clahe = f32.mixup = f32.elastic = False
    torch.manual_seed(seed)
    sd = live_head(torch, quiet_model(create_model, f32, device="cpu"), *head).state_dict()
    R = args.inference_resolution
    x = np.random.default_rng(seed).integers(0, 256, (2, R, R, n_channels), dtype=np.uint8)
    y, m = np.array([0, 2], np.int32), np.ones(2, np.float32)
    mean, std = np.full(n_channels, 0.45), np.full(n_channels, 0.25)
    res = {}
    for where in ("cuda", "cpu"):
        model = quiet_model(create_model, f32, device=where)
        model.load_state_dict(sd)
        rec = _GradRecorder(model)
        loss = float(build_train_step(model, rec, f32, mean, std, device=where)(
            torch.Generator(device=where).manual_seed(0), x, y, m, 1e-4))
        res[where] = (loss, {n: g for n, g in rec.grads.items() if n.startswith(compare)})
    (lg, gg), (lc, gc) = res["cuda"], res["cpu"]
    gap, leaf, ok = leaf_gap(torch, gg, gc, 1e-3)
    rel = abs(lg - lc) / abs(lc)
    check(rel <= 1e-4 and ok, f"{phase}: card vs CPU f32 step: loss {lg} vs {lc}, {gap} of "
          f"{leaf}'s max")
    say(phase, cpu_check="ok", loss_rel_diff=rel, max_gap_of_leaf_max=gap, leaf=leaf)


def family_checkpoint(torch, np, args, work, name, seed, n_channels, head):
    """Seeded weights of ``args``'s model, saved as a checkpoint, with
    :func:`live_head` ``(std, layers)`` = ``head``."""
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.train import checkpoint as ckpt

    torch.manual_seed(seed)
    model = live_head(torch, quiet_model(create_model, args, device="cpu"), *head)
    weights = work / f"{name}.pt"
    ckpt.save_model(weights, epoch=0, model=model, args=args,
                    val_mean_std=(np.full(n_channels, 0.45), np.full(n_channels, 0.25)))
    return model, weights


def encrypt_family(torch, np, phase, work, weights, protocols, signs, clahe, n_images, batch,
                   tile, profile_out):
    """The encrypted CLI under each protocol with its exact launches (K4
    ``signs`` a forward under fss, none under snn; CLAHE once a forward
    tile's batch, on the counter ``clahe`` names, None where it is off),
    its logits against the plain step, and the predict timed at ``batch``.
    Returns the launches by protocol."""
    case = encrypted_case(torch, work, weights, f"{phase}_encrypt_images", n_images, batch)
    out = {}
    for protocol in protocols:
        per = {"dcf_sign": signs} if protocol == "fss" else {}
        if clahe:
            per[clahe] = 1 if tile is None else -(-batch // tile)
        launches, enc, _ = check_encrypted(torch, phase, case, protocol, per, tile)
        time_encrypted(torch, np, phase, protocol, enc, case["imgs"], profile_out,
                       f".{phase}_{protocol}", batches=(batch,), n_timed=3)
        out[protocol] = launches
    return out


def phase_vgg(torch, seed, work, profile_out, ctx):
    """Phase 17, slice 6a: VGG-16 of configs/torch/pneumonia-vgg.ini (224 px,
    3 channels, CLAHE, mixup, batch 64; pretrained = yes with no weights
    file keeps the He init, as the JAX package does): served (CLAHE once a
    batch), the train CLI for one epoch on phase 7's 600 DICOMs (K1 four
    times and CLAHE once a step), timed steps at batch 64, the steps under
    PRIMIA_PALLAS_WGRAD=1 (K7 four times a step) against the default ones,
    one f32 step card against CPU, and served encrypted at batch 1 with
    --mpc_batch_tile 1 under fss (K4 25 times a forward) and snn."""
    import numpy as np

    from primia_tpu_torch.config import Arguments

    ini = cut_ini(work, VGG_CONFIG, (("epochs = 40", "epochs = 1"),))
    args = Arguments.from_ini(ini)
    check(args.model == "vgg16" and args.pretrained and args.clahe and args.mixup
          and args.batch_size == VGG_BATCH and args.inference_resolution == RES,
          f"unexpected VGG config: {VGG_CONFIG}")
    os.environ.pop("PRIMIA_PRETRAINED", None)
    model, weights = family_checkpoint(torch, np, args, work, "vgg16", seed + 11, 3,
                                       VGG_HEAD)
    say("vgg", config=VGG_CONFIG.relative_to(ROOT), parameters=sum(
        p.numel() for p in model.parameters()), weights=weights.relative_to(ROOT))
    by_path = {"vgg_serve": serve_family(torch, np, "vgg", args, model, weights, work,
                                         work / "images", 3)}
    by_path["vgg_train"], _ = train_family(torch, np, "vgg", ini, args, ctx["root"], work,
                                           {"tent_rows": 4, "clahe_lab": 1})
    fresh, batches, mean, std = family_steps(torch, args, ctx["root"], seed, 3)
    by_path["vgg_optin"] = switched_against_default(
        torch, np, "vgg", args, fresh, batches, mean, std, "PRIMIA_PALLAS_WGRAD",
        {"tent_rows": 4, "clahe_lab": 1, "conv3x3_wgrad": K7_PER_VGG_STEP}, profile_out,
        VGG_TIMED_STEPS, ("features.", "classifier.2."), VGG_HEAD)
    f32_step_card_vs_cpu(torch, np, "vgg", args, 3, ("classifier.",), seed, VGG_HEAD)
    enc = encrypt_family(torch, np, "vgg_encrypt", work, weights, ("fss", "snn"), SIGNS_VGG,
                         clahe_counter(3), VGG_ENCRYPT_IMAGES, 1, 1, profile_out)
    by_path["vgg_encrypt"], by_path["vgg_encrypt_snn"] = enc["fss"], enc["snn"]
    return by_path


def write_mnist(np, root, n_train, n_test, seed):
    """A synthetic 10-class MNIST in IDX files: each digit a bright square
    at its own place on a noisy field."""
    from primia_tpu_torch.data.mnist import write_idx

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    for split, n in (("train", n_train), ("t10k", n_test)):
        labels = (np.arange(n) % 10).astype(np.uint8)
        imgs = rng.integers(0, 60, (n, 28, 28), dtype=np.uint8)
        for i, d in enumerate(labels):
            r, c = 2 + 5 * (d // 5), 2 + 5 * (d % 5)
            imgs[i, r:r + 8, c:c + 8] = 255
        write_idx(root / f"{split}-images-idx3-ubyte", imgs)
        write_idx(root / f"{split}-labels-idx1-ubyte", labels)


def phase_simpleconv(torch, seed, work, profile_out, ctx):
    """Phase 18, slice 6a: SimpleConv@224 of configs/torch/pneumonia-conv.ini
    (1 channel, batch norm, CLAHE, mixup, batch 4): served, the train CLI
    for one epoch on phase 7's DICOMs, timed steps, the steps under
    PRIMIA_PALLAS_BN=1 (each of the six BN launches 3 times a step) against
    the default ones, one f32 step card against CPU, served encrypted at
    batch 4 under fss (K4 20 times a forward) and snn; then mnist.ini
    (SimpleConv@28) through ``--data_dir mnist`` on a synthetic IDX set
    under ``$MNIST_DIR`` for one epoch (K1 twice a step)."""
    import numpy as np

    from primia_tpu_torch.config import Arguments

    ini = cut_ini(work, CONV_CONFIG, (("epochs = 1", "epochs = 1"),))
    args = Arguments.from_ini(ini)
    check(args.model == "simpleconv" and not args.pretrained and args.clahe and args.mixup
          and args.batch_size == CONV_BATCH and args.train_resolution == RES
          and args.normalization == "batch", f"unexpected SimpleConv config: {CONV_CONFIG}")
    model, weights = family_checkpoint(torch, np, args, work, "simpleconv224", seed + 12, 1,
                                       CONV_HEAD)
    say("simpleconv", config=CONV_CONFIG.relative_to(ROOT), parameters=sum(
        p.numel() for p in model.parameters()), weights=weights.relative_to(ROOT))
    by_path = {"conv_serve": serve_family(torch, np, "simpleconv", args, model, weights, work,
                                          work / "images", 1)}
    by_path["conv_train"], _ = train_family(torch, np, "simpleconv", ini, args, ctx["root"],
                                            work, {"tent_rows": 4, "clahe": 1})
    fresh, batches, mean, std = family_steps(torch, args, ctx["root"], seed, 1)
    per_bn = {k: len(CONV_BN_SHAPES) for k in BN_LAUNCHES}
    by_path["conv_optin"] = switched_against_default(
        torch, np, "simpleconv", args, fresh, batches, mean, std, "PRIMIA_PALLAS_BN",
        {"tent_rows": 4, "clahe": 1, **per_bn}, profile_out, CONV_TIMED_STEPS,
        ("classifier.2.",), CONV_HEAD)
    f32_step_card_vs_cpu(torch, np, "simpleconv", args, 1, ("classifier.",), seed, CONV_HEAD)
    enc = encrypt_family(torch, np, "conv_encrypt", work, weights, ("fss", "snn"),
                         SIGNS_CONV224, clahe_counter(1), ENCRYPT_IMAGES, ENCRYPT_BATCH, None,
                         profile_out)
    by_path["conv_encrypt"], by_path["conv_encrypt_snn"] = enc["fss"], enc["snn"]

    # MNIST: SimpleConv@28 through --data_dir mnist
    from primia_tpu_torch.cli import train as train_cli

    write_mnist(np, work / "mnist_idx", MNIST_TRAIN, MNIST_TEST, seed + 13)
    mini = cut_ini(work, MNIST_CONFIG, (("epochs = 10", "epochs = 1"),))
    margs = Arguments.from_ini(mini)
    check(margs.model == "simpleconv" and margs.train_resolution == 28 and not margs.clahe,
          f"unexpected MNIST config: {MNIST_CONFIG}")
    steps = -(-MNIST_TRAIN // margs.batch_size)
    run_dir = work / "mnist_run"
    run_dir.mkdir()
    os.environ["MNIST_DIR"] = str(work / "mnist_idx")
    try:
        best, out, cli_s, launches = run_cli(torch, train_cli, [
            "--config", str(mini), "--data_dir", "mnist", "--device", "cuda"], run_dir,
            work / "mnist_train_cli.log")
    finally:
        os.environ.pop("MNIST_DIR")
    want = idle_launches(tent_rows=2 * steps)
    check(launches == want and np.isfinite(best), f"MNIST train CLI launches {launches}, "
          f"expected {want}; best {best}")
    check(all(f"│ {d} " in out for d in "0123456789"), "MNIST stats table lacks a digit")
    say("mnist", config=MNIST_CONFIG.relative_to(ROOT), train_digits=MNIST_TRAIN,
        test_digits=MNIST_TEST, batch=margs.batch_size, steps=steps, cli_seconds=f"{cli_s:.4f}",
        launches=json.dumps(launches), best_mcc_percent=best)
    by_path["mnist"] = launches
    return by_path


def phase_conv_dp(torch, seed, work, profile_out):
    """Phase 19, slice 6a: the DP recipe that trains from scratch,
    configs/torch/pneumonia-conv-dp.ini (SimpleConv@224 with group norm,
    batch 512, K = 4, sigma 2.0, SGD, EMA 0.99; epochs 60 -> 1 and
    test_interval 2 -> 1) on phase 16's 1,024 DICOMs: the train CLI (2 steps,
    K1 twice a step over the 2,048 views), its epsilon line, 2 timed
    microbatched steps; its group-norm model with an N(0, 0.1) head served
    encrypted at batch 4 under fss (K4 20 times a forward) and snn; then
    configs/torch/pneumonia-conv-dp-federated.ini (K = 16, sigma 3.0) with
    --train_federated on phase 16's 3 nodes of 512: one step a node and one
    secure aggregation (K1 twice a node step)."""
    import numpy as np

    from primia_tpu_torch.cli import train as train_cli
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.train import dp
    from primia_tpu_torch.train.optim import make_optimizer

    root = work / "dp"
    ini = cut_ini(work, CONV_DP_CONFIG, (("epochs = 60", "epochs = 1"),
                                         ("test_interval = 2", "test_interval = 1")))
    args = Arguments.from_ini(ini)
    K = args.augment_multiplicity
    check(args.model == "simpleconv" and args.normalization == "group" and K == 4
          and args.batch_size == DP_BATCH and args.differentially_private
          and args.noise_multiplier == 2.0 and args.parameter_ema == 0.99,
          f"unexpected conv DP config: {CONV_DP_CONFIG}")
    n_train = sum(DP_TRAIN_PER_CLASS)
    steps = -(-n_train // DP_BATCH)
    run_dir = work / "conv_dp_run"
    run_dir.mkdir()
    _, out, cli_s, launches = run_cli(torch, train_cli, [
        "--config", str(ini), "--data_dir", str(root / "train"), "--device", "cuda"],
        run_dir, work / "conv_dp_cli.log")
    want = idle_launches(tent_rows=2 * steps)
    check(launches == want, f"conv DP CLI launches {launches}, expected {want}")
    eps, alpha = dp.rdp_epsilon(noise_multiplier=args.noise_multiplier,
                                sample_rate=DP_BATCH / n_train, steps=steps,
                                delta=args.target_delta)
    line = eps_line(out)
    check(line == f"(eps = {eps:.2f}, delta = {args.target_delta}) at alpha = {alpha}",
          f"conv DP epsilon line {line!r}")
    say("conv_dp", config=CONV_DP_CONFIG.relative_to(ROOT), train_images=n_train,
        batch=DP_BATCH, augment_multiplicity=K, steps=steps, cli_seconds=f"{cli_s:.4f}",
        launches=json.dumps(launches), epsilon_line=json.dumps(line))
    fresh, batches, mean, std = family_steps(torch, args, root, seed, 1)
    model = fresh(args)
    step = dp.select_train_step(model, make_optimizer(args, model), args, mean, std, None,
                                "cuda")
    p50 = time_steps(torch, np, stepper(torch, step, batches, seed, args.lr), "conv_dp",
                     profile_out, ".conv_dp", batch=DP_BATCH, steps=2, warmup=1, n_prof=1,
                     augment_multiplicity=K)[0]
    say("conv_dp", examples_per_s_p50=f"{DP_BATCH / (p50 * 1e-3):.2f}",
        views_per_s_p50=f"{K * DP_BATCH / (p50 * 1e-3):.2f}")

    _, weights = family_checkpoint(torch, np, args, work, "simpleconv224-group", seed + 14, 1,
                                   CONV_HEAD)
    enc = encrypt_family(torch, np, "conv_group_encrypt", work, weights, ("fss", "snn"),
                         SIGNS_CONV224, None, ENCRYPT_IMAGES, ENCRYPT_BATCH, None, profile_out)

    froot = work / "dp_federated"
    fini = cut_ini(work, CONV_DP_FED_CONFIG, (("epochs = 60", "epochs = 1"),
                                              ("test_interval = 2", "test_interval = 1")))
    fargs = Arguments.from_ini(fini, cmd_args=argparse.Namespace(data_dir=str(froot),
                                                                 train_federated=True))
    check(fargs.model == "simpleconv" and fargs.augment_multiplicity == 16
          and fargs.sync_every_n_batch == 1 and fargs.batch_size == DP_BATCH,
          f"unexpected conv federated DP config: {CONV_DP_FED_CONFIG}")
    frun = work / "conv_dp_federated_run"
    frun.mkdir()
    (frun / "data").symlink_to(froot, target_is_directory=True)
    _, out, fcli_s, flaunches = run_cli(torch, train_cli, [
        "--config", str(fini), "--data_dir", str(frun / "data"), "--train_federated",
        "--device", "cuda"], frun, work / "conv_dp_federated_cli.log")
    want = idle_launches(tent_rows=2 * 3)
    check(flaunches == want, f"conv federated DP CLI launches {flaunches}, expected {want}")
    fline = eps_line(out)
    check("[worst node: " in fline, f"conv federated epsilon line {fline!r}")
    say("conv_dp_federated", config=CONV_DP_FED_CONFIG.relative_to(ROOT), nodes=3,
        batch_per_node=DP_BATCH, augment_multiplicity=fargs.augment_multiplicity,
        cli_seconds=f"{fcli_s:.4f}", launches=json.dumps(flaunches),
        epsilon_line=json.dumps(fline))
    return {"conv_dp": launches, "conv_group_encrypt": enc["fss"],
            "conv_dp_federated": flaunches}

GRID_REQUESTS = 10  # timed remote requests a transport
GRID_PER_CLASS = ((67, 67, 66),) * 3  # 200 DICOMs a node: one batch of 200
GRID_NODE_TIMEOUT_S = 60.0


def _free_port():
    """A port free for ws whose port + 1000 (the node's HTTP) is free too."""
    import socket

    while True:
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            port = a.getsockname()[1]
        if port + 1000 > 65535:
            continue
        with socket.socket() as b:
            try:
                b.bind(("127.0.0.1", port + 1000))
            except OSError:
                continue
        return port


def _seconds_p50(np, fn, n):
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return float(np.percentile(out, 50))


class RoundParts:
    """Times the parts of the federated ws CLI's own rounds while it runs:
    each ``train_round`` RPC (``NodeClient.send``, with its transport), the
    client's and the node's pack and unpack of its frames (bytes, seconds),
    each node's ``GridNode._train_round`` and each ``aggregate_wire``. Keeps
    the last round's request and replies for a profiled rerun."""

    def __init__(self):
        self.events = []  # (kind, start, end, extra)
        self.lock = threading.Lock()
        self.last_msg, self.last_replies = None, {}

    def _add(self, kind, t0, extra=None):
        with self.lock:
            self.events.append((kind, t0, time.perf_counter(), extra))

    def __enter__(self):
        from primia_tpu_torch.parallel import federated
        from primia_tpu_torch.serve import client, node

        rec, self._undo = self, []

        def patch(owner, name, make):
            orig = getattr(owner, name)
            self._undo.append((owner, name, orig))
            setattr(owner, name, make(orig))

        def send(orig):
            def wrapped(c, msg):
                t0 = time.perf_counter()
                out = orig(c, msg)
                if msg.get("type") == "train_round":
                    rec._add("send", t0, c.last_transport)
                    rec.last_msg = msg
                    rec.last_replies[c.id] = out
                return out
            return wrapped

        def frames(side):
            def make(orig):
                def wrapped(x):
                    t0 = time.perf_counter()
                    out = orig(x)
                    msg = out if isinstance(out, dict) else x
                    if msg.get("type") == "train_round" or "n_batches" in msg:
                        frame = x if isinstance(x, bytes) else out
                        rec._add(side + ("_unpack" if isinstance(x, bytes) else "_pack"), t0,
                                 len(frame))
                    return out
                return wrapped
            return make

        def timed(kind):
            def make(orig):
                def wrapped(*a, **k):
                    t0 = time.perf_counter()
                    out = orig(*a, **k)
                    rec._add(kind, t0)
                    return out
                return wrapped
            return make

        patch(client.NodeClient, "send", send)
        for mod, side in ((client, "client"), (node, "node")):
            patch(mod, "pack", frames(side))
            patch(mod, "unpack", frames(side))
        patch(node.GridNode, "_train_round", timed("node"))
        patch(federated, "aggregate_wire", timed("aggregate"))
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)

    def rounds(self):
        """Per aggregation: the round's seconds (first send to the end of
        the aggregation), its fan-out (first send to last reply), the nodes'
        train_round seconds, the aggregation's seconds and the frames'
        bytes and pack/unpack seconds."""
        ev = sorted(self.events, key=lambda e: e[1])
        out, begin = [], 0.0
        for _, a0, a1, _ in (e for e in ev if e[0] == "aggregate"):
            part = [e for e in ev if begin <= e[1] < a1]
            sends = [e for e in part if e[0] == "send"]
            row = {"round_seconds": a1 - min(e[1] for e in sends),
                   "fan_out_seconds": max(e[2] for e in sends) - min(e[1] for e in sends),
                   "aggregation_seconds": a1 - a0,
                   "node_round_seconds": [e[2] - e[1] for e in part if e[0] == "node"],
                   "transports": sorted({e[3] for e in sends})}
            for kind in ("client_pack", "client_unpack", "node_pack", "node_unpack"):
                fr = [e for e in part if e[0] == kind]
                row[kind] = {"frames": len(fr), "bytes": sorted({e[3] for e in fr}),
                             "seconds": [round(e[2] - e[1], 4) for e in fr]}
            out.append(row)
            begin = a1
        return out


def phase_grid(torch, seed, work):
    """Phase 20, slice 7: the grid's main path on the card (see the module
    docstring). Returns the launch counts of the remote plain request, the
    encrypted request and the federated ws CLI."""
    import numpy as np

    from primia_tpu_torch import native
    from primia_tpu_torch.cli import evaluate as evaluate_cli
    from primia_tpu_torch.cli import inference as inference_cli
    from primia_tpu_torch.cli import train as train_cli
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.data import PathDataset
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.nn.jax_params import from_jax_tree, jax_leaf_paths, to_jax_tree
    from primia_tpu_torch.parallel.federated import aggregate_wire
    from primia_tpu_torch.serve import GridNetwork, GridNode, NodeClient, NodeServer
    from primia_tpu_torch.serve.node import _flatten
    from primia_tpu_torch.serve.protocol import pack, unpack
    from primia_tpu_torch.train import checkpoint as ckpt
    from primia_tpu_torch.train.steps import build_predict_step

    root = work / "grid"
    owner_dir = root / "owner"
    owner_dir.mkdir(parents=True)
    for f in sorted((work / "images").iterdir())[:BATCH]:
        shutil.copy(f, owner_dir / f.name)
    weights = work / "resnet18-canonical.pt"
    state = ckpt.load_model(weights)
    args, (mean, std) = state["args"], state["val_mean_std"]
    msd = state["model_state_dict"]
    model = create_model(args, num_classes=3, device="cuda")
    model.load_state_dict(from_jax_tree(msd["params"], msd["state"]))
    imgs, _ = PathDataset(owner_dir, channels=3).materialize(RES)
    local = build_predict_step(model, args, mean, std, "cuda")(imgs).float().cpu().numpy()
    say("grid", native_library=native.available(), images=len(imgs), batch=BATCH,
        weights=weights.relative_to(ROOT))

    servers, transports = [], {}
    proc = None
    try:
        # ---------------------------------------------------- remote serving
        owner = GridNode("data_owner", data_directory=str(owner_dir), config=str(CONFIG),
                         device="cuda")
        port = _free_port()
        servers.append(NodeServer(owner, port=port).start())
        check(owner.store["#inference_data"].tobytes() == imgs.tobytes(),
              "the data owner's hosted images differ from the local files")
        ws = NodeClient("data_owner", "127.0.0.1", port, timeout=GRID_NODE_TIMEOUT_S)
        http = NodeClient("data_owner", "127.0.0.1", port, http_only=True,
                          timeout=GRID_NODE_TIMEOUT_S)
        grid, grid_http = GridNetwork([ws]), GridNetwork([http])
        host_msg_bytes = len(pack({"params": _flatten(to_jax_tree(model)[0])}))
        out = grid.serve_model("data_owner", name="resnet18", params=model,
                               args_json=args.to_json(), mean=mean, std=std)
        check(out.get("ok"), f"host_model: {out}")
        transports["host_model"] = ws.last_transport
        req = {"type": "run_inference", "name": "resnet18", "encrypted": False,
               "protocol": "snn"}
        by_path = {}
        for name, g, c in (("ws", grid, ws), ("http", grid_http, http)):
            reset_launches()
            got = g.run_remote_inference("data_owner", name="resnet18")
            torch.cuda.synchronize()
            launches = read_launches()
            check(launches == idle_launches(clahe_lab=1),
                  f"remote plain request over {name}: launches {launches}")
            check(got["logits"].tobytes() == local.tobytes(),
                  f"remote plain logits over {name} differ from the local predict step's: "
                  f"max |d| {float(np.abs(got['logits'] - local).max())}")
            check(c.last_transport == name, f"run_inference went by {c.last_transport}")
            by_path["grid_serve"] = launches
        transports["run_inference"] = ws.last_transport
        reply = owner.handle(req)
        pack_s = _seconds_p50(np, lambda: (unpack(pack(req)), unpack(pack(reply))),
                              GRID_REQUESTS)
        compute_s = _seconds_p50(np, lambda: owner.handle(req), GRID_REQUESTS)
        for name, g in (("ws", grid), ("http", grid_http)):
            total_s = _seconds_p50(
                np, lambda: g.run_remote_inference("data_owner", name="resnet18"),
                GRID_REQUESTS)
            say("grid", transport=name, batch=BATCH, requests=GRID_REQUESTS,
                request_ms_p50=f"{total_s * 1e3:.4f}", node_compute_ms_p50=f"{compute_s * 1e3:.4f}",
                pack_unpack_ms_p50=f"{pack_s * 1e3:.4f}",
                transport_ms=f"{(total_s - compute_s - pack_s) * 1e3:.4f}",
                img_per_s=f"{BATCH / total_s:.2f}")

        shares = ws.send({"type": "get_data_shares", "tag": "#inference_data", "party": -1,
                          "seed": 7})
        transports["get_data_shares"] = ws.last_transport
        s0, s1 = shares["shares"]
        x = imgs.astype(np.float32) / 255.0
        enc = np.round(x.astype(np.float64) * (1 << 16)).astype(np.int64)
        check(np.array_equal((s0.view(np.uint64) + s1.view(np.uint64)).view(np.int64), enc),
              "get_data_shares does not reconstruct to encode(x)")

        csv = root / "remote.csv"
        csv.write_text(f"id,data_owner\nhost,127.0.0.1\nport,{port}\n")
        base = ["--model_weights", str(weights), "--batch_size", str(BATCH), "--device", "cuda"]
        want, _, _, local_launches = run_cli(torch, inference_cli,
                                             base + ["--data_dir", str(owner_dir)], root,
                                             root / "local_cli.log")
        for extra in ([], ["--http_protocol"]):
            res, _, cli_s, launches = run_cli(
                torch, inference_cli, base + ["--websockets_config", str(csv)] + extra, root,
                root / f"remote_cli{'_http' if extra else ''}.log")
            check(res == want, f"the inference CLI over the grid {extra} predicts "
                  f"{res['Inference Results']}, locally {want['Inference Results']}")
            check(launches == local_launches == idle_launches(clahe_lab=1),
                  f"remote inference CLI launches {launches}")
            say("grid", inference_cli="--websockets_config " + " ".join(extra),
                cli_seconds=f"{cli_s:.4f}", predictions_equal_local=True)

        reset_launches()
        t0 = time.perf_counter()
        got = grid.run_remote_inference("data_owner", name="resnet18", images=imgs[:1],
                                        encrypted=True, protocol="fss")
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        launches = read_launches()
        check(launches == idle_launches(clahe_lab=1, dcf_sign=SIGNS_PER_FORWARD),
              f"remote encrypted request launches {launches}")
        limit = max(0.02, 1e-3 * float(np.abs(local[:1]).max()))
        d = float(np.abs(got["logits"] - local[:1]).max())
        check(d <= limit, f"remote encrypted logits off plain by {d} (limit {limit})")
        by_path["grid_encrypt"] = launches
        say("grid", encrypted="fss", batch=1, seconds_first_request=f"{enc_s:.4f}",
            max_abs_dlogit=d, limit=limit, launches=json.dumps(launches))

        # ------------------------------------------ federated over live nodes
        fed = root / "federated"
        write_federated_dataset(np, np.random.default_rng(seed + 20), fed, GRID_PER_CLASS)
        ini = cut_ini(root, FED_CONFIG, (("epochs = 40", "epochs = 5"),))
        fargs = Arguments.from_ini(ini, cmd_args=argparse.Namespace(
            data_dir=str(fed), train_federated=True, websockets=True))
        check(fargs.epochs == 1 and fargs.batch_size == TRAIN_BATCH
              and fargs.sync_every_n_batch == 3 and fargs.repetitions_dataset == 5,
              f"unexpected federated config: {FED_CONFIG}")
        rows = {"id": [], "host": [], "port": []}
        nodes = {}
        for i, w in enumerate(("alice", "bob", "charlie", "crypto_provider")):
            nodes[w] = GridNode(w, data_directory=(None if w == "crypto_provider"
                                                   else str(fed / f"worker{i + 1}")),
                                config=str(ini), device="cuda")
            p = _free_port()
            servers.append(NodeServer(nodes[w], port=p).start())
            rows["id"].append(w)
            rows["host"].append("127.0.0.1")
            rows["port"].append(str(p))
        run_dir = root / "federated_run"
        (run_dir / "configs" / "websetting").mkdir(parents=True)
        (run_dir / "configs" / "websetting" / "config.csv").write_text(
            "\n".join(",".join([k] + rows[k]) for k in ("id", "host", "port")) + "\n")
        steps_round = fargs.sync_every_n_batch
        rounds = -(-fargs.repetitions_dataset // steps_round)  # one batch a pass a node
        node_steps = 3 * rounds * steps_round
        torch.manual_seed(seed)
        with RoundParts() as parts:
            best, out, cli_s, launches = run_cli(torch, train_cli, [
                "--config", str(ini), "--data_dir", str(fed), "--train_federated",
                "--websockets", "--save_file", str(root / "runs.csv"), "--device", "cuda"],
                run_dir, root / "federated_ws_cli.log")
        want = idle_launches(tent_rows=4 * node_steps, clahe_lab=node_steps)
        check(launches == want, f"federated ws CLI launches {launches}, expected {want}")
        finals = sorted((run_dir / "model_weights").glob("final_federated_*.pt"))
        check(len(finals) == 1 and np.isfinite(best), f"federated ws CLI: best {best}, "
              f"{len(finals)} final checkpoints")
        fstate = ckpt.load_model(finals[0])
        check(fstate["args"].websockets and sorted(fstate["optim_state_dict"])
              == ["alice", "bob", "charlie"], "federated ws checkpoint")
        by_path["grid_federated"] = launches
        stats, _, eval_s, _ = run_cli(torch, evaluate_cli, [
            "--data_dir", str(fed / "validation"), "--model_weights", str(finals[0]),
            "--device", "cuda"], root, root / "federated_ws_eval.log")
        check(np.asarray(stats["conf_matrix"]).sum() == 3 * TEST_PER_CLASS,
              f"evaluate CLI on the federated ws checkpoint: {stats['conf_matrix']}")
        say("grid", federated_ws_cli_seconds=f"{cli_s:.4f}", nodes=3, images_per_node=200,
            batch=TRAIN_BATCH, rounds=rounds, steps_per_round=steps_round,
            node_steps=node_steps, launches=json.dumps(launches),
            tent_rows_per_node_step=launches["tent_rows"] / node_steps,
            clahe_lab_per_node_step=launches["clahe_lab"] / node_steps, best_mcc_percent=best,
            evaluate_seconds=f"{eval_s:.4f}", matthews=stats["matthews_coeff"])

        # the CLI's rounds by parts; the device's share of a round from one
        # profiled rerun of the last round's three node rounds and aggregation
        rounds_by_parts = parts.rounds()
        check(len(rounds_by_parts) == rounds, f"{len(rounds_by_parts)} rounds timed")
        for i, row in enumerate(rounds_by_parts):
            say("grid", federated_round=i + 1, **{k: json.dumps(v) if isinstance(v, (list, dict))
                                                   else f"{v:.4f}" for k, v in row.items()})
        transports["train_round"] = rounds_by_parts[-1]["transports"]
        node_busy = []
        for w in rows["id"][:3]:
            prof = trace(torch, lambda w=w: nodes[w].handle(parts.last_msg), 1)
            node_busy.append(sum(device_ms_by_category(prof.key_averages(), 1).values()))
        leaves = jax_leaf_paths(create_model(fargs, num_classes=3, device="cuda"))
        prof = trace(torch, lambda: aggregate_wire(
            parts.last_replies, rows["id"][:3], leaves, np.full(3, 1 / 3),
            (seed, 777, 1), fargs.precision_fractional, torch.device("cuda")), 1)
        agg_busy = sum(device_ms_by_category(prof.key_averages(), 1).values())
        busy = sum(node_busy) + agg_busy
        round_ms = rounds_by_parts[-1]["round_seconds"] * 1e3
        for c in (ws, http):
            c.close()
        say("grid", raw_param_bytes=sum(v.nbytes for v in parts.last_msg["params"].values()),
            host_model_frame_bytes=host_msg_bytes, ws_frame_limit_bytes=1 << 20,
            node_device_busy_ms=json.dumps([round(b, 4) for b in node_busy]),
            aggregation_device_busy_ms=f"{agg_busy:.4f}",
            round_device_busy_ms=f"{busy:.4f}", round_ms=f"{round_ms:.4f}",
            idle_share=f"{1.0 - busy / round_ms:.4f}" if busy > 0 else "not measured")
        say("grid", transports=json.dumps(transports))

        # ------------------------------------------------ one node, a process
        pport = _free_port()
        log = open(root / "node_process.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "primia_tpu_torch.serve.node", "--id", "data_owner",
             "--port", str(pport), "--data_directory", str(owner_dir), "--config",
             str(CONFIG)], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        pc = NodeClient("data_owner", "127.0.0.1", pport, timeout=GRID_NODE_TIMEOUT_S)
        t0 = time.perf_counter()
        while True:
            try:
                check(pc.status()["id"] == "data_owner", "node process status")
                break
            except (OSError, ConnectionError):
                check(proc.poll() is None and time.perf_counter() - t0 < 180,
                      f"the node process did not come up: {(root / 'node_process.log').read_text()}")
                time.sleep(1.0)
        up_s = time.perf_counter() - t0
        pgrid = GridNetwork([pc])
        check(pgrid.serve_model("data_owner", name="resnet18", params=model,
                                args_json=args.to_json(), mean=mean, std=std).get("ok"),
              "host_model on the node process")
        got = pgrid.run_remote_inference("data_owner", name="resnet18")["logits"]
        pc.close()
        d = float(np.abs(got - local).max())
        check(d <= 1e-5 * float(np.abs(local).max()),
              f"the node process's logits off the in-process node's by {d}")
        say("grid", node_process_seconds_to_serve=f"{up_s:.4f}", max_abs_dlogit=d,
            bit_equal=got.tobytes() == local.tobytes())
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for s in servers:
            s.stop()
    return by_path



HPO_SEEDED_STEP = 5  # the pruner's default warm-up (train/hpo.py: n_warmup_steps)


def hpo_launches(args, steps):
    """The warp and CLAHE launches of ``steps`` train steps of a trial's
    config (``ops/augment.py``): RandomAffine two K1 passes when
    ``twopass_safe`` holds for its ranges, else one K2 gather; the fused
    dense warp two K1 passes when a distortion flag is on; CLAHE once."""
    from primia_tpu_torch.ops.image import twopass_safe

    affine = bool(args.rotation or args.translate or args.scale or args.shear)
    safe = twopass_safe(args.rotation, args.shear, args.scale)
    dense = args.elastic or args.optical_distortion or args.grid_distortion
    return idle_launches(tent_rows=steps * (2 * (affine and safe) + 2 * dense),
                         tent_bilinear=steps * (affine and not safe),
                         clahe_lab=steps * bool(args.clahe))


def phase_hpo(torch, seed, work, ctx):
    """Phase 22: slice 8's main path, the hyperparameter search
    (``python -m primia_tpu_torch.cli.find_config``) on the card at the
    CLI's widths: ResNet-18 at 224 px, batch 200, pretrained = yes (no
    ImageNet file: the He init, 3 channels), each trial a full train run.
    Locally on phase 7's 600 + 60 DICOMs (3 steps an epoch), from a study
    file seeded with five finished trials whose objective at step 5 is
    100: the first trial (5 epochs) is pruned there through the loop's
    hook, the second (1 epoch) completes; then a trial whose categoricals
    all answer True (every augmentation flag and mixup on), its losses
    finite; then one --federated trial with secure aggregation on phase
    15's shards from a work directory whose configs/websetting/config.csv
    names the crypto provider. Counters set to 0 around each trial: K1, K2
    and CLAHE as the trial's draws ask (``hpo_launches``). Any trial not
    complete or pruned fails the phase. Returns the launches summed."""
    import functools

    import numpy as np

    from primia_tpu_torch.cli import find_config
    from primia_tpu_torch.train import loop
    from primia_tpu_torch.train.hpo import Study, Trial, TrialRecord

    class AllOn(Trial):
        def suggest_categorical(self, name, choices):
            return self._suggest(name, lambda rng, base=None: True)

    class AllOnStudy(Study):
        def ask(self):
            return AllOn(self, super().ask()._rec)

    hpo = work / "hpo"
    (hpo / "configs" / "websetting").mkdir(parents=True)
    shutil.copy(ROOT / "configs" / "websetting" / "config.csv",
                hpo / "configs" / "websetting" / "config.csv")
    storage = hpo / "study.json"
    storage.write_text(json.dumps({"trials": [
        {"number": i, "params": {}, "intermediate": {str(HPO_SEEDED_STEP): 100.0},
         "value": 100.0, "state": "complete"} for i in range(5)]}))
    # the CLI's defaults, spelt out
    common = ["--storage", str(storage), "--resolution", str(RES), "--batch_size",
              str(TRAIN_BATCH), "--device", "cuda"]
    local = ["--data_dir", str(ctx["root"] / "train"), *common]
    runs = [("pruned", Study, local + ["--epochs", str(HPO_SEEDED_STEP)]),
            ("complete", Study, local + ["--epochs", "1"]),
            ("all_flags", AllOnStudy, local + ["--epochs", "1"]),
            ("federated", Study, ["--federated", "--epochs", "3", "--data_dir",
                                  str(work / "federated"), *common])]
    steps_per_epoch = ctx["steps"]
    node_batches = [-(-sum(n) // TRAIN_BATCH) for n in FED_PER_CLASS]
    losses = []
    select = loop.select_train_step

    def recording_select(*a, **kw):
        step = select(*a, **kw)

        def run(*b):
            loss = step(*b)
            losses.append(loss)
            return loss

        return run

    total = idle_launches()
    say("hpo", model="resnet-18", resolution=RES, batch=TRAIN_BATCH, trials=len(runs),
        seeded_trials=5, seeded_step=HPO_SEEDED_STEP)
    for i, (name, study_cls, argv) in enumerate(runs):
        find_config.Study = functools.partial(study_cls, seed=seed + i)
        loop.select_train_step = recording_select
        losses.clear()
        try:
            _, _, secs, launches = run_cli(torch, find_config, ["--n_trials", "1", *argv], hpo,
                                           work / f"hpo_{name}.log")
        finally:
            find_config.Study, loop.select_train_step = Study, select
        rec = json.loads(storage.read_text())["trials"][-1]
        check(rec["state"] in ("complete", "pruned"), f"hpo {name}: trial {rec}")
        # the trial's Arguments, replayed from its recorded draws
        args = find_config.build_args(Trial(None, TrialRecord(rec["number"], rec["params"])),
                                      find_config.build_parser().parse_args(argv))
        if name == "federated":
            reps = args.repetitions_dataset
            steps = args.epochs * reps * sum(node_batches)
            check(args.epochs >= 1 and not args.unencrypted_aggregation,
                  f"hpo federated: {args.epochs} epochs, secure {not args.unencrypted_aggregation}")
        else:
            epochs = len(rec["intermediate"])
            steps = epochs * steps_per_epoch
            check(all(bool(torch.isfinite(l)) for l in losses) and len(losses) == steps,
                  f"hpo {name}: {len(losses)} losses for {steps} steps, finite "
                  f"{[bool(torch.isfinite(l)) for l in losses]}")
        want = hpo_launches(args, steps)
        check(launches == want, f"hpo {name}: launches {launches}, expected {want}")
        if name == "pruned":
            check(rec["state"] == "pruned" and epochs == HPO_SEEDED_STEP,
                  f"hpo: the seeded study did not prune: {rec}")
        if name == "all_flags":
            flags = [getattr(args, f) for f in find_config.ALBU_FLAGS]
            check(all(flags) and args.mixup and launches["clahe_lab"] == steps,
                  f"hpo all_flags: flags {flags}, mixup {args.mixup}")
        for k, v in launches.items():
            total[k] += v
        say("hpo", trial=name, state=rec["state"], value=rec["value"], seconds=f"{secs:.4f}",
            steps=steps, epochs=args.epochs, repetitions=args.repetitions_dataset,
            intermediate=json.dumps(rec["intermediate"]),
            k1=launches["tent_rows"], k2=launches["tent_bilinear"], clahe_lab=launches["clahe_lab"])
    states = [t["state"] for t in json.loads(storage.read_text())["trials"][5:]]
    check(states.count("failed") == 0 and "pruned" in states, f"hpo states {states}")
    say("hpo", states=json.dumps(states), launches=json.dumps(total))
    return total


def phase_warm(torch, seed, work, ctx):
    """Phase 23: ``python -m primia_tpu_torch.cli.warm`` on the canonical
    train INI and phase 7's data, in process, into a fresh build directory:
    the six libraries built at once, one train step at batch 200 and one
    eval step at batch 64, each line's seconds. Then, with nvcc barred, a
    train step on a new model finds every library already built there."""
    import numpy as np

    from primia_tpu_torch.cli import warm
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.ops import _build
    from primia_tpu_torch.train.optim import make_optimizer
    from primia_tpu_torch.train.steps import build_train_step

    fresh = work / "warm_build"
    saved_dir, saved_loaded = _build.BUILD_DIR, dict(_build._loaded)

    nvcc_path = _build.nvcc_path
    try:
        _build.BUILD_DIR = fresh
        _build._loaded.clear()
        _, out, secs, _ = run_cli(torch, warm, ["--config", str(CONFIG), "--data_dir",
                                                str(ctx["root"] / "train")], work,
                                  work / "warm.log")
        lines = out.strip().splitlines()
        say("warm", config=CONFIG.relative_to(ROOT), build_dir=fresh.relative_to(ROOT),
            seconds=f"{secs:.4f}", lines=json.dumps(lines[-4:]))
        check(lines[-1] == f"warm: {len(_build.source_names())} kernel libraries built, "
              "2 programs run", f"warm printed {lines}")
        built = {n: _build.library_path(n) for n in _build.source_names()}
        check(all(p.is_file() for p in built.values()), f"warm left {built} unbuilt")
        _build._loaded.clear()

        def barred(*a, **kw):
            raise PhaseError("a library was built again after warm")

        _build.nvcc_path = barred
        args = Arguments.from_ini(ctx["ini"])
        torch.manual_seed(seed)
        dev = torch.device("cuda")
        model = create_model(args, num_classes=3, device="cpu").to(dev)
        step = build_train_step(model, make_optimizer(args, model), args, ctx["mean"],
                                ctx["std"], device=dev)
        x, y = ctx["imgs"][:TRAIN_BATCH], ctx["labels"][:TRAIN_BATCH]
        loss = float(step(torch.Generator(device=dev).manual_seed(seed), x, y,
                          np.ones(len(y), np.float32), 1e-4))
        loaded = {n: Path(lib._name).parent == fresh for n, lib in _build._loaded.items()}
        check(loaded and all(loaded.values()) and "tent" in loaded and "clahe" in loaded,
              f"train step after warm loaded {loaded}")
        check(loss == loss, f"train step after warm: loss {loss}")
        say("warm", after="train_step", loss=loss, loaded_from_warm=json.dumps(loaded))
    finally:
        _build.nvcc_path = nvcc_path
        _build.BUILD_DIR = saved_dir
        _build._loaded.clear()
        _build._loaded.update(saved_loaded)


def phase_profile(torch, seed, work, profile_out, ctx, card):
    """Phase 24: ``utils.profile`` around 5 of phase 7's train steps at
    batch 200, each in a ``record_function`` range, then ``profiler`` over
    the trace: the top ops' table (beside ``profile_out`` as
    ``.roofline``), total_ms, floor_ms and efficiency against the card's
    roofs (``profiler.device_roofs``), each step's device window and the
    gaps between them. The parser's device total must be within 2% of the
    ``key_averages()`` device total (``device_ms_by_category``, phase 7's
    sum) over the same steps."""
    from primia_tpu_torch import profiler, utils

    run = ctx["run"]
    for i in range(2):
        run(i)  # warm
    logdir = work / "trace"
    with contextlib.redirect_stdout(io.StringIO()):
        with utils.profile(str(logdir)) as prof:
            for i in range(5):
                with torch.profiler.record_function(f"step#{i}"):
                    run(i)
    trace = str(logdir / utils.TRACE_FILE)
    avgs = [e for e in prof.key_averages() if not e.key.startswith("step#")]
    ka_total = sum(device_ms_by_category(avgs, 1).values())
    ops = profiler.parse_trace(trace)
    total = sum(o.total_ms for o in ops)
    check(ka_total > 0 and abs(total - ka_total) <= 0.02 * ka_total,
          f"profile: parser device total {total} ms, key_averages {ka_total} ms")
    hbm, tflops = profiler.device_roofs(torch.cuda.get_device_name(0))
    r = profiler.roofline(ops, hbm_gbs=hbm, mxu_tflops=tflops, top=30)
    path = profile_out.with_name(profile_out.stem + ".roofline" + profile_out.suffix)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(r["table"] + "\n")
    windows = profiler.module_executions(trace, "step#")
    check(len(windows) == 5, f"profile: {len(windows)} step windows")
    gaps = [b[1] - (a[1] + a[2]) for a, b in zip(windows, windows[1:])]
    under_aten = sum(o.total_ms for o in ops if o.name.startswith("aten::")) / total
    say("profile", card=json.dumps(card), steps=5, batch=TRAIN_BATCH,
        total_ms=f"{r['total_ms']:.4f}", floor_ms=f"{r['floor_ms']:.4f}",
        efficiency=f"{r['efficiency']:.4f}", conv_tflop=f"{r['conv_tflops']:.4f}",
        key_averages_ms=f"{ka_total:.4f}", rel_diff=f"{abs(total - ka_total) / ka_total:.6f}",
        roofs=json.dumps([hbm, tflops]), ops=len(ops),
        share_under_an_aten_op=f"{under_aten:.4f}")
    say("profile", step_windows_ms=json.dumps([round(w[2], 4) for w in windows]),
        gaps_ms=json.dumps([round(g, 4) for g in gaps]))
    print("\n".join(r["table"].splitlines()[:16]), flush=True)


# ------------------------------------------------------------ slice 9

ENC_BATCH = 64
ENC_LR = {"mlp": 0.2, "conv": 0.02}  # the conv net's 3,136-wide head takes a smaller step
MLP_STEPS = {"fss": 10, "snn": 3}
CONV_STEPS = 3
# a revealed value against the float64 plain step from the same revealed
# parameters: |d| <= ENC_ATOL + ENC_RTOL * max |plain| of the tensor +
# ENC_ULPS * sqrt(D) ulps, D the depth of the contraction that sums the
# gradient (the loss: 1). A truncation leaves up to an ulp (2^-16) of
# error in each term, of either sign, so a sum of D terms drifts as
# sqrt(D): the conv's weight and bias gradients sum 64 x 28 x 28 terms
# whose plain values are below an ulp each.
ENC_ATOL, ENC_RTOL, ENC_ULPS = 2e-3, 2e-2, 4
RNN_BATCH, RNN_HIDDEN = 8, 128
RNN_TOL = 5e-3  # max |encrypted - plain| of the LSTM's outputs (tests/test_rnn.py's)
K4_PER_STEP = {"mlp": 2, "conv": 1}  # one sign batch a ReLU; the backward reuses it


def mnist_batches(torch, np, work, seed, dev):
    """Phase 18's synthetic IDX digits (written here if the phase has not
    run) as ``ENC_BATCH`` batches: (1, 28, 28) images under MNIST's
    normalisation and one-hot float64 targets, on ``dev``."""
    from primia_tpu_torch.data.mnist import load_mnist

    root = work / "mnist_idx"
    if not root.is_dir():
        write_mnist(np, root, MNIST_TRAIN, MNIST_TEST, seed + 13)
    imgs, labels, _, _ = load_mnist(str(root))
    x = (torch.from_numpy(imgs[..., 0].astype(np.float64)) / 255.0 - 0.1307) / 0.3081
    y = torch.nn.functional.one_hot(torch.from_numpy(labels).long(), 10).double()
    n = len(x) // ENC_BATCH
    return [(x[i * ENC_BATCH:(i + 1) * ENC_BATCH, None].to(dev),
             y[i * ENC_BATCH:(i + 1) * ENC_BATCH].to(dev)) for i in range(n)]


def enc_models(torch, dev, seed):
    """The two models of phase 25 in float64, PyTorch's default init drawn
    from a seeded generator: (name, params, plain forward, share-space
    forward, each gradient's contraction depth). Linear weights are (out,
    in), conv weights OIHW."""
    from primia_tpu_torch.mpc import autograd as ag

    g = torch.Generator(device=dev).manual_seed(seed)

    def uniform(fan_in, *shape):
        b = fan_in ** -0.5
        return torch.rand(shape, generator=g, device=dev, dtype=torch.float64) * (2 * b) - b

    mlp = {"w1": uniform(784, 128, 784), "b1": uniform(784, 128),
           "w2": uniform(128, 64, 128), "b2": uniform(128, 64),
           "w3": uniform(64, 10, 64), "b3": uniform(64, 10)}
    conv = {"w": uniform(9, 16, 1, 3, 3), "cb": uniform(9, 16),
            "wf": uniform(3136, 10, 3136), "bf": uniform(3136, 10)}
    F = torch.nn.functional

    def mlp_plain(p, x, y):
        h = F.relu(F.linear(x.flatten(1), p["w1"], p["b1"]))
        h = F.relu(F.linear(h, p["w2"], p["b2"]))
        return ((F.linear(h, p["w3"], p["b3"]) - y) ** 2).mean()

    def mlp_enc(ctx, p, xs, ys):
        h = ag.relu(ctx, ag.linear(ctx, ag.flatten(ag.Var(xs)), p["w1"], p["b1"]))
        h = ag.relu(ctx, ag.linear(ctx, h, p["w2"], p["b2"]))
        return ag.mse_loss(ctx, ag.linear(ctx, h, p["w3"], p["b3"]), ys)

    def conv_plain(p, x, y):
        h = F.relu(F.conv2d(x, p["w"], p["cb"], padding=1))
        h = h.reshape(*h.shape[:2], 14, 2, 14, 2).sum((3, 5)) / 4  # avg pool 2
        return ((F.linear(h.flatten(1), p["wf"], p["bf"]) - y) ** 2).mean()

    def conv_enc(ctx, p, xs, ys):
        h = ag.conv2d(ctx, ag.Var(xs), p["w"], stride=1, padding=1)
        h = ag.avg_pool(ctx, ag.relu(ctx, ag.bias_add(h, p["cb"])), 2)
        return ag.mse_loss(ctx, ag.linear(ctx, ag.flatten(h), p["wf"], p["bf"]), ys)

    pixels = ENC_BATCH * 28 * 28
    return (("mlp", mlp, mlp_plain, mlp_enc, dict.fromkeys(mlp, ENC_BATCH)),
            ("conv", conv, conv_plain, conv_enc,
             {"w": pixels, "cb": pixels, "wf": ENC_BATCH, "bf": ENC_BATCH}))


def enc_train_run(torch, np, dev, batches, model, protocol, steps, seed, on_step=None,
                  profile_last=False):
    """``steps`` encrypted SGD steps of ``model`` under ``protocol`` on
    ``dev``: each batch shared, ``autograd.value_and_grad``, the update in
    share space. After each step the loss, the gradients and the
    parameters before it are revealed, and the float64 plain step from
    those parameters on the same batch gives the loss and gradients they
    are held to. ``on_step(i)`` runs before each timed step (the launch
    counters). Returns per-step records: ms (host clock around the
    synchronised step), loss, plain loss, the worst |d| over |limit|."""
    from primia_tpu_torch.mpc import autograd as ag
    from primia_tpu_torch.mpc import fixed
    from primia_tpu_torch.mpc import shares as S
    from primia_tpu_torch.mpc.engine import MpcContext, encode_and_share, reveal_and_decode

    name, params, plain, enc, depth = model
    gen = torch.Generator(device=dev).manual_seed(seed)
    ctx = MpcContext(gen, protocol=protocol)
    ps = encode_and_share(gen, params)
    vag = ag.value_and_grad(enc)
    out = []
    for i in range(steps):
        x, y = batches[i % len(batches)]
        xs, ys = S.share(gen, fixed.encode(x)), S.share(gen, fixed.encode(y))
        if on_step:
            on_step(i)
        prof = device_profiler(torch) if profile_last and i == steps - 1 else None
        with prof or contextlib.nullcontext():
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = vag(ctx, ps, xs, ys)
            new = {k: ag.sgd_update(v, grads[k], ENC_LR[name], ctx.frac_bits)
                   for k, v in ps.items()}
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        now = {k: reveal_and_decode(v).requires_grad_() for k, v in ps.items()}
        ref = plain(now, x, y)
        ref_grads = torch.autograd.grad(ref, list(now.values()))
        worst, rel = 0.0, {}
        pairs = [("loss", reveal_and_decode(loss), ref.detach(), 1)] + [
            (k, reveal_and_decode(grads[k]), rg, depth[k]) for k, rg in zip(now, ref_grads)]
        for k, got, want, d in pairs:
            top, err = float(want.abs().max()), float((got - want).abs().max())
            lim = ENC_ATOL + ENC_RTOL * top + ENC_ULPS * d ** 0.5 / (1 << ctx.frac_bits)
            worst = max(worst, err / lim)
            rel[k] = (err / top, top)
        out.append({"ms": ms, "loss": float(reveal_and_decode(loss)),
                    "plain_loss": float(ref.detach()), "worst": worst, "rel": rel, "prof": prof})
        ps = new
    return out


def device_profiler(torch):
    """A profiler of the card's activity alone: kernels, copies and the
    runtime calls that launch them, without the CPU side's op records,
    which cost seconds over a forward of 100,000 launches."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    return tprofile(activities=[ProfilerActivity.CUDA])


def _profile_line(prof, ms):
    """(busy ms, idle share against ``ms``, device operations) of one
    profiled step; "not measured" where the trace holds no device time."""
    rows = device_rows(prof.key_averages())
    busy = sum(e.self_device_time_total for e in rows) * 1e-3
    ops = sum(e.count for e in rows)
    if busy <= 0:
        return "not measured", "not measured", "not measured"
    return f"{busy:.4f}", f"{1.0 - busy / ms:.4f}", ops


def phase_enc_train(torch, seed, work):
    """Phase 25, slice 9: encrypted training (``mpc/autograd.py``) on the
    card. Returns the launches of its fss runs."""
    import numpy as np

    from primia_tpu_torch.mpc import autograd as ag
    from primia_tpu_torch.mpc import shares as S

    dev = torch.device("cuda")
    # the conv step's two gradient convs on random ring values: the card's
    # limb GEMMs (the weight gradient's depth in chunks) against the CPU's
    # int64 convs, bit for bit
    g = torch.Generator(device=dev).manual_seed(seed + 250)
    shapes = (ENC_BATCH, 1, 28, 28), (16, 1, 3, 3), (ENC_BATCH, 16, 28, 28)
    x, w, gy = (S.rand_ring(g, s) for s in shapes)
    f_gx, f_gw = ag.conv_vjp_fns(shapes[0], shapes[1], 1, 1)
    for what, f, a, b in (("input", f_gx, gy, w), ("weight", f_gw, x, gy)):
        check(torch.equal(f(a, b).cpu(), f(a.cpu(), b.cpu())),
              f"enc_train: the card's {what} gradient conv differs from the CPU's")
    say("enc_train", gradient_convs="card equals CPU bit for bit",
        weight_gradient_depth=ENC_BATCH * 28 * 28)
    batches = mnist_batches(torch, np, work, seed, dev)
    mlp, conv = enc_models(torch, dev, seed + 25)
    total = idle_launches()
    for model, protocol, steps in ((mlp, "fss", MLP_STEPS["fss"]),
                                   (mlp, "snn", MLP_STEPS["snn"]), (conv, "fss", CONV_STEPS)):
        name = model[0]
        per_step = []

        def on_step(i):
            if i:
                per_step.append(read_launches())
            reset_launches()

        torch.cuda.reset_peak_memory_stats()
        recs = enc_train_run(torch, np, dev, batches, model, protocol, steps, seed,
                             on_step=on_step, profile_last=True)
        per_step.append(read_launches())
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = K4_PER_STEP[name] if protocol == "fss" else 0
        for i, (n, r) in enumerate(zip(per_step, recs)):
            check(n == idle_launches(dcf_sign=want),
                  f"enc_train: {name} {protocol} step {i} launched {n}, want K4 {want}")
            check(r["worst"] <= 1.0,
                  f"enc_train: {name} {protocol} step {i} off the plain step: "
                  f"{r['worst']:.3f} of the limit")
            if protocol == "fss":
                total = {k: total[k] + n[k] for k in total}
        if name == "mlp" and protocol == "fss":
            check(recs[-1]["loss"] < recs[0]["loss"],
                  f"enc_train: the MLP's loss did not fall: {[r['loss'] for r in recs]}")
        # the first step pays first use (library loads, allocator), the
        # last runs under the profiler: the p50 is of the steps between
        p50 = float(np.percentile([r["ms"] for r in recs[1:-1]], 50))
        busy, idle, ops = _profile_line(recs[-1]["prof"], recs[-1]["ms"])
        say("enc_train", model=name, protocol=protocol, batch=ENC_BATCH, steps=steps,
            lr=ENC_LR[name], step_ms_p50=f"{p50:.4f}", profiled_step_ms=f"{recs[-1]['ms']:.4f}",
            device_busy_ms_per_step=busy, idle_share=idle,
            device_ops_per_step=ops, peak_memory_gb=f"{peak_gb:.3f}",
            k4_per_step=want, worst_of_limit=f"{max(r['worst'] for r in recs):.4f}",
            limit=f"{ENC_ATOL}+{ENC_RTOL}*max|plain|+{ENC_ULPS}*sqrt(depth)*2^-16")
        say("enc_train", model=name, protocol=protocol,
            max_rel_err=json.dumps({k: round(max(r["rel"][k][0] for r in recs), 6)
                                    for k in recs[0]["rel"]}),
            min_max_abs_plain=json.dumps({k: round(min(r["rel"][k][1] for r in recs), 6)
                                          for k in recs[0]["rel"]}),
            losses=json.dumps([round(r["loss"], 6) for r in recs]),
            plain_losses=json.dumps([round(r["plain_loss"], 6) for r in recs]),
            step_ms=json.dumps([round(r["ms"], 4) for r in recs]))
    return total


def counting_context(gen, protocol):
    """An ``MpcContext`` that counts its sign batches (``ctx.signs``): K4's
    launches on the card, its plain version's calls on the CPU."""
    from primia_tpu_torch.mpc.engine import MpcContext

    class Counting(MpcContext):
        signs = 0

        def sign_shares(self, x):
            self.signs += 1
            return super().sign_shares(x)

    return Counting(gen, protocol=protocol)


def rnn_forward(torch, np, dev, params, x, protocol, seed):
    """One encrypted LSTM forward (``nn/rnn.py`` over ``MpcEngine``) of
    ``x`` (B, T, F) batch first: (revealed output, sign batches, ms)."""
    from primia_tpu_torch.mpc import fixed
    from primia_tpu_torch.mpc import shares as S
    from primia_tpu_torch.mpc.engine import MpcEngine, encode_and_share, reveal_and_decode
    from primia_tpu_torch.nn import rnn as R

    gen = torch.Generator(device=dev).manual_seed(seed)
    ctx = counting_context(gen, protocol)
    ps = {d: [encode_and_share(gen, c) for c in cells] for d, cells in params.items()}
    xs = S.share(gen, fixed.encode(x))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = R.rnn_apply(MpcEngine(ctx), ps, xs, kind="lstm", batch_first=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return reveal_and_decode(out), ctx.signs, (time.perf_counter() - t0) * 1e3


def phase_enc_rnn(torch, seed, work):
    """Phase 26, slice 9: an encrypted LSTM forward on the card. Returns
    the launches of its fss forward."""
    import numpy as np

    from primia_tpu_torch.nn import rnn as R

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    params = R.rnn_init(torch.Generator(device=dev).manual_seed(seed + 26), 28, RNN_HIDDEN,
                        kind="lstm", dtype=torch.float64)
    x = mnist_batches(torch, np, work, seed, dev)[0][0][:RNN_BATCH, 0]  # rows as steps
    want, _ = R.rnn_apply(R.PLAIN, params, x, kind="lstm", batch_first=True)
    cpu_params = {d: [{k: v.cpu() for k, v in c.items()} for c in cells]
                  for d, cells in params.items()}
    # the same fss forward on the CPU, K4's plain version, counts the sign
    # batches the card's K4 must launch
    _, cpu_signs, cpu_ms = rnn_forward(torch, np, cpu, cpu_params, x.cpu(), "fss", seed)
    launches = None
    for protocol in ("fss", "snn"):
        reset_launches()
        got, signs, ms = rnn_forward(torch, np, dev, params, x, protocol, seed)
        n = read_launches()
        want_k4 = cpu_signs if protocol == "fss" else 0
        check(signs == cpu_signs and n == idle_launches(dcf_sign=want_k4),
              f"enc_rnn: {protocol} launched {n} ({signs} sign batches), the CPU's fss run "
              f"{cpu_signs} sign batches")
        err = float((got - want).abs().max())
        check(err <= RNN_TOL, f"enc_rnn: {protocol} output off plain by {err}")
        with device_profiler(torch) as prof:
            rnn_forward(torch, np, dev, params, x, protocol, seed)
        busy, _, ops = _profile_line(prof, ms)
        say("enc_rnn", protocol=protocol, batch=RNN_BATCH, steps=28, hidden=RNN_HIDDEN,
            forward_ms=f"{ms:.4f}", device_busy_ms_with_sharing=busy, device_ops=ops,
            k4_launches=n["dcf_sign"], cpu_sign_batches=cpu_signs,
            cpu_fss_forward_ms=f"{cpu_ms:.1f}", max_abs_err=f"{err:.6f}", limit=RNN_TOL)
        if protocol == "fss":
            launches = n
    return launches


DPF_N, DPF_BITS = 1 << 20, 31
CMP_N = 802_816  # the conv step's ReLU: 64 x 16 x 28 x 28
REP_SHAPE = (256, 256)
PAILLIER_BITS, PAILLIER_VALUES = 1024, 16


def _timed(torch, dev, fn):
    """(fn(), ms on the host clock, synchronised on the card)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_crypto(torch, seed):
    """Phase 27, slice 9: the share-space crypto library on the card."""
    import numpy as np

    from primia_tpu_torch.mpc import bfv, compare, dcf, fixed, paillier, replicated, ring_ops
    from primia_tpu_torch.mpc import shares as S

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    g = torch.Generator(device=dev).manual_seed(seed + 27)

    # the DPF: keys and both parties' shares, card against CPU
    alpha = torch.randint(0, 1 << DPF_BITS, (DPF_N,), generator=g, device=dev)
    beta = S.rand_ring(g, (DPF_N,))
    seeds = torch.randint(0, 1 << 32, (2, DPF_N, 4), generator=g, device=dev)
    x = torch.randint(0, 1 << DPF_BITS, (DPF_N,), generator=g, device=dev)
    x[::2] = alpha[::2]  # half the points on alpha

    def dpf(seeds, alpha, beta, x):
        keys = dcf.dpf_gen_from_seeds(seeds, alpha, beta, DPF_BITS)
        return keys, [dcf.dpf_eval(p, keys, x, DPF_BITS) for p in (0, 1)]

    (keys, ev), dpf_ms = _timed(torch, dev, lambda: dpf(seeds, alpha, beta, x))
    (ckeys, cev), dpf_cpu_ms = _timed(torch, cpu, lambda: dpf(
        *(t.cpu() for t in (seeds, alpha, beta, x))))
    check(all(torch.equal(a.cpu(), b) for a, b in zip((*keys, *ev), (*ckeys, *cev))),
          "crypto: the card's DPF keys or shares differ from the CPU's")
    check(torch.equal(ev[0] + ev[1], torch.where(x == alpha, beta, torch.zeros_like(beta))),
          "crypto: the DPF does not open to beta at alpha and 0 elsewhere")
    say("crypto", dpf_n=DPF_N, n_bits=DPF_BITS, card_ms=f"{dpf_ms:.4f}",
        cpu_ms=f"{dpf_cpu_ms:.4f}", bit_for_bit=True)
    del keys, ev, ckeys, cev

    # the comparison split into dealer and online phases, against K4's
    v = torch.randint(-(1 << 30), 1 << 30, (CMP_N,), generator=g, device=dev)
    xs = S.share(g, v)
    fused, fused_ms = _timed(torch, dev, lambda: compare.sign_shares(
        torch.Generator(device=dev).manual_seed(seed), xs))
    split, split_ms = _timed(torch, dev, lambda: compare.msb(xs, compare.gen_compare(
        torch.Generator(device=dev).manual_seed(seed), CMP_N)))
    check(torch.equal(fused.data, split.data), "crypto: msb(gen_compare) differs from K4's")
    check(torch.equal(S.reconstruct(split), (v < 0).long()), "crypto: msb opens wrong")
    say("crypto", compare_n=CMP_N, sign_shares_k4_ms=f"{fused_ms:.4f}",
        gen_compare_msb_ms=f"{split_ms:.4f}", bit_for_bit=True)
    del fused, split

    # replicated 3-party sharing: products and truncation against plaintext
    a = torch.rand(REP_SHAPE, generator=g, device=dev, dtype=torch.float64) * 8 - 4
    b = torch.rand(REP_SHAPE, generator=g, device=dev, dtype=torch.float64) * 8 - 4
    ea, eb = fixed.encode(a), fixed.encode(b)
    ra, rb = replicated.share(g, ea), replicated.share(g, eb)
    R = replicated.reconstruct
    z, mul_ms = _timed(torch, dev, lambda: replicated.mul(g, ra, rb))
    m, mm_ms = _timed(torch, dev, lambda: replicated.matmul(g, ra, rb))
    tz, tr_ms = _timed(torch, dev, lambda: replicated.truncate(g, z))
    tm = replicated.truncate(g, m)
    exact_mm = ring_ops.ring_matmul(ea.cpu(), eb.cpu())
    check(torch.equal(R(z), ea * eb), "crypto: replicated mul differs from the ring product")
    check(torch.equal(R(m).cpu(), exact_mm), "crypto: replicated matmul differs")
    for got, exact in ((R(tz).cpu(), (ea * eb).cpu()), (R(tm).cpu(), exact_mm)):
        off = int((got - (exact >> fixed.DEFAULT_FRAC_BITS)).abs().max())
        check(off <= 1, f"crypto: replicated truncate off by {off} units")
    say("crypto", replicated_shape=json.dumps(REP_SHAPE), mul_ms=f"{mul_ms:.4f}",
        matmul_ms=f"{mm_ms:.4f}", truncate_ms=f"{tr_ms:.4f}", truncate_within_ulps=1)

    # BFV: one relinearised ciphertext product, card against CPU
    rng = np.random.default_rng(seed)
    u, w = (rng.integers(-100, 101, 2048) for _ in range(2))
    res = []
    for d in (dev, cpu):
        (ctx, sk, pk, rk), setup_ms = _timed(torch, d, lambda: (
            lambda c: (c, *bfv.KeyGenerator(c, seed=seed).keygen()))(
            bfv.Context(device=d.type)))
        enc, ev = bfv.BatchEncoder(ctx), bfv.Evaluator(ctx)
        e = bfv.Encryptor(ctx, pk, seed=seed + 1)
        ca, cb = e.encrypt(enc.encode(u)), e.encrypt(enc.encode(w))
        prod, mul_ms = _timed(torch, d, lambda: ev.mul(ca, cb, rk))
        out = enc.decode(bfv.Decryptor(ctx, sk).decrypt(prod)).cpu().numpy()
        res.append((prod, mul_ms, setup_ms, out))
    (card, card_ms, setup_ms, out), (host, host_ms, _, _) = res
    check(all(torch.equal(p.cpu(), q) for p, q in zip(card.parts, host.parts)),
          "crypto: the card's BFV product differs from the CPU's")
    check(np.array_equal(out, u * w), "crypto: BFV decrypts the product wrongly")
    say("crypto", bfv_n=2048, bfv_mul_relin_card_ms=f"{card_ms:.4f}",
        bfv_mul_relin_cpu_ms=f"{host_ms:.4f}", bfv_context_keygen_card_ms=f"{setup_ms:.4f}",
        bit_for_bit=True)

    # Paillier on the host
    t0 = time.perf_counter()
    sk = paillier.keygen(PAILLIER_BITS)
    t1 = time.perf_counter()
    vals = rng.uniform(-100, 100, PAILLIER_VALUES)
    ct = paillier.encrypt(sk.public, vals)
    t2 = time.perf_counter()
    back = paillier.decrypt(sk, ct).numpy()
    t3 = time.perf_counter()
    check(np.allclose(back, vals, atol=1e-4), "crypto: Paillier round trip")
    say("crypto", paillier_bits=PAILLIER_BITS, values=PAILLIER_VALUES,
        keygen_s=f"{t1 - t0:.4f}", encrypt_ms=f"{(t2 - t1) * 1e3:.4f}",
        decrypt_ms=f"{(t3 - t2) * 1e3:.4f}", on="host")


# ------------------------------------------------------------- slice 10

DP_RANKS_ONE_CARD = 2  # ranks sharing cuda:0 over gloo on a one-card machine
DP_TIMED_STEPS, DP_SWITCHED_STEPS = 12, 3
RANK_TIMEOUT_S = 600.0
PARTY_BATCH = 4
FIG_FED_PER_CLASS = ((20, 20, 20), (15, 15, 15), (10, 10, 10))


def _host_p50(torch, np, fn, n, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(ms, 50))


def _bn_stats(model):
    return {n: t.detach().float().cpu().clone() for n, t in model.state_dict().items()
            if n.endswith(("running_mean", "running_var"))}


def parallel_rank(payload):
    """The rank program of phases 28-29, run by ``parallel/launch.py`` on
    every rank: (a) one float32 data-parallel step (augmentation, CLAHE,
    MixUp on) with a recording optimizer: the loss, the fc gradients, the
    BN running statistics, the launches; (b) the bf16 step timed (p50 of
    DP_TIMED_STEPS after 3 warm-up steps, 3 profiled: busy ms and idle
    share), its launches; (c) the gradient all-reduce alone and the noise
    field drawn whole against half; (d) DP_SWITCHED_STEPS steps under
    PRIMIA_PALLAS_BN=1 PRIMIA_PALLAS_WGRAD=1 and as many unswitched from
    the same start, with the switched launches; (e) one secure FedAvg
    round over the node axis (a node a rank)."""
    import numpy as np
    import torch

    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.parallel import launch, multihost
    from primia_tpu_torch.parallel.data_parallel import data_parallel_mesh, shard_train_step
    from primia_tpu_torch.train.optim import make_optimizer

    dev = multihost.rank_device("cuda")
    torch.cuda.set_device(dev)
    mesh = data_parallel_mesh()
    B = TRAIN_BATCH
    imgs, labels = payload["imgs"], payload["labels"]
    batches = [(imgs[i:i + B], labels[i:i + B], np.ones(B, np.float32))
               for i in range(0, len(imgs) - B + 1, B)]
    seed = payload["seed"]
    out = {"device": str(dev), "backend": multihost.backend(),
           "topology": multihost.slice_topology()}

    def fresh(args, record=False):
        m = create_model(args, num_classes=3, device="cpu")
        m.load_state_dict(payload["state_dict"])
        m = m.to(dev, memory_format=torch.channels_last)
        opt = launch.GradRecorder(m) if record else make_optimizer(args, m)
        return m, opt, shard_train_step(m, opt, args, payload["mean"], payload["std"],
                                        mesh=mesh, device=dev)

    # (a) float32, TF32 off
    m, rec, step = fresh(payload["f32_args"], record=True)
    reset_launches()
    loss = float(step(torch.Generator(device=dev).manual_seed(seed), *batches[0], 1e-4))
    torch.cuda.synchronize()
    out["f32"] = {"loss": loss, "launches": read_launches(), "stats": _bn_stats(m),
                  "fc": {k: v for k, v in rec.grads.items() if k.startswith("fc.")}}

    # (b) bf16, timed
    args = payload["args"]
    m, opt, step = fresh(args)
    gen = torch.Generator(device=dev).manual_seed(seed)
    it = iter(range(1 << 30))

    def run():
        i = next(it)
        return step(gen, *batches[i % len(batches)], 1e-4)

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    reset_launches()
    step_ms, losses = [], []
    for _ in range(DP_TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(float(run()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    timed_launches = read_launches()
    avgs = profile(torch, lambda: [run() for _ in range(3)], 1)
    cats = {k: v / 3 for k, v in device_ms_by_category(avgs, 1).items()}
    p50 = float(np.percentile(step_ms, 50))
    out["bf16"] = {"step_ms": step_ms, "p50": p50, "losses": losses,
                   "launches": timed_launches, "busy_ms": sum(cats.values()), "cats": cats,
                   "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}

    # (c) the step's collectives alone: the flat gradient all-reduce,
    # MixUp's gather of the augmented rows, a batch norm's (2, 512) sum;
    # then the noise field drawn whole and for a rank's rows, on rank 0
    # while the others wait (they share its card)
    import torch.distributed as dist

    from primia_tpu_torch.parallel.data_parallel import _gather_rows

    n_params = sum(p.numel() for p in opt.params)
    flat = torch.zeros(n_params + 1, device=dev)
    out["all_reduce_ms"] = _host_p50(torch, np, lambda: multihost.all_reduce_(flat), 10, 2)
    out["all_reduce_bytes"] = flat.numel() * 4
    rows = torch.zeros((B // mesh.size, 3, RES, RES), device=dev).contiguous(
        memory_format=torch.channels_last)
    out["gather_ms"] = _host_p50(torch, np, lambda: _gather_rows(rows, mesh.group("data")), 5, 1)
    small = torch.zeros((2, 512), device=dev)
    out["bn_sum_ms"] = _host_p50(torch, np, lambda: multihost.all_reduce_(small), 20, 2)
    dist.barrier()
    if mesh.index("data") == 0:
        g = torch.Generator(device=dev).manual_seed(seed)
        for rows_drawn, key in ((B, "noise_whole_ms"), (B // mesh.size, "noise_half_ms")):
            out[key] = cuda_ms(torch, lambda: torch.randn((rows_drawn, 3, RES, RES),
                                                          generator=g, device=dev), 20)
    dist.barrier()

    # (d) the switched step against the unswitched one, from the same start
    def three(switched):
        names = ("PRIMIA_PALLAS_BN", "PRIMIA_PALLAS_WGRAD")
        for k in names:
            os.environ[k] = "1" if switched else "0"
        try:
            _, _, st = fresh(args)
            gg = torch.Generator(device=dev).manual_seed(seed)
            reset_launches()
            ls = [float(st(gg, *batches[i % len(batches)], 1e-4))
                  for i in range(DP_SWITCHED_STEPS)]
            torch.cuda.synchronize()
            return ls, read_launches()
        finally:
            for k in names:
                os.environ.pop(k)

    out["switched"], out["switched_launches"] = three(True)
    out["unswitched"], _ = three(False)

    # (e) secure FedAvg over the node axis: a node a rank
    fmesh = multihost.federated_mesh(mesh.size)
    lo = fmesh.index("node")
    local = {k: torch.from_numpy(np.array(v[lo:lo + 1])).to(dev)
             for k, v in payload["fed_stacked"].items()}
    t0 = time.perf_counter()
    agg = multihost.secure_fedavg(payload["fed_key"], local, payload["fed_weights"], fmesh)
    torch.cuda.synchronize()
    out["fedavg_ms"] = (time.perf_counter() - t0) * 1e3
    out["fedavg"] = {k: v.cpu() for k, v in agg.items()}
    return out


def phase_data_parallel(torch, seed, work, ctx):
    """Phases 28-29, slice 10 on ranks of ``torch.distributed``: the
    canonical INI's train step (ResNet-18 @ 224, global batch 200, CLAHE,
    MixUp, the noise) data parallel over 2 ranks on cuda:0 over gloo on a
    one-card machine, or a rank a card over NCCL, spawned by
    ``parallel/launch.py`` with a deadline each. ``data_parallel``: the
    2-rank float32 step against the one-process step on the card (loss
    within 1e-5 relative, fc gradients within 1e-4 of their largest,
    BN statistics within 1e-5), K1 4 and CLAHE 1 a step on every rank; the
    bf16 step's p50, the all-reduce ms and bytes, the idle share; the
    switched step (K7 6, each BN launch 20 a step on every rank) held to
    the unswitched one. ``multihost``: one secure FedAvg round across the
    ranks (a node a rank) of two ResNet-18 trees, bit for bit the
    one-process ``secure_fedavg``. Returns the launch counts by path,
    summed over the ranks."""
    import numpy as np

    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.mpc.aggregation import secure_fedavg
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.nn.jax_params import to_jax_tree
    from primia_tpu_torch.parallel import launch
    from primia_tpu_torch.train.steps import build_train_step

    n_cards = torch.cuda.device_count()
    world = n_cards if n_cards > 1 else DP_RANKS_ONE_CARD
    backend = "nccl" if n_cards > 1 else "gloo"
    args = Arguments.from_ini(ctx["ini"])
    f32 = Arguments.from_ini(ctx["ini"])
    f32.compute_dtype = "float32"
    check(args.mixup and args.clahe and args.noise_std > 0 and args.batch_size == TRAIN_BATCH,
          "unexpected canonical config")
    torch.manual_seed(seed + 28)
    sd = create_model(args, num_classes=3, device="cpu").state_dict()
    imgs, labels = ctx["imgs"], ctx["labels"].astype(np.int64)
    mean, std = ctx["mean"], ctx["std"]

    # the one-process float32 step on the card, from the same weights
    dev = torch.device("cuda")
    m = create_model(f32, num_classes=3, device="cpu")
    m.load_state_dict(sd)
    m = m.to(dev, memory_format=torch.channels_last)
    rec = launch.GradRecorder(m)
    step = build_train_step(m, rec, f32, mean, std, device=dev)
    ref_loss = float(step(torch.Generator(device=dev).manual_seed(seed),
                          imgs[:TRAIN_BATCH], labels[:TRAIN_BATCH],
                          np.ones(TRAIN_BATCH, np.float32), 1e-4))
    ref_stats, ref_fc = _bn_stats(m), {k: v for k, v in rec.grads.items() if k.startswith("fc.")}
    del m, rec, step

    # two nodes' ResNet-18 trees for the FedAvg round, leaves flattened by path
    trees = []
    for k in range(world):
        torch.manual_seed(seed + 100 + k)
        params = to_jax_tree(create_model(args, num_classes=3, device="cpu"))[0]
        trees.append(_flat_tree(params))
    fed = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    fed_w = np.linspace(1.0, 2.0, world) / np.linspace(1.0, 2.0, world).sum()
    fed_key = (seed, 777, 1)

    say("data_parallel", ranks=world, backend=backend, devices=n_cards,
        config=CONFIG.relative_to(ROOT), global_batch=TRAIN_BATCH)
    t0 = time.perf_counter()
    got = launch.spawn(f"{ROOT / 'chip_smoke.py'}:parallel_rank", world,
                       {"seed": seed, "imgs": imgs[:3 * TRAIN_BATCH],
                        "labels": labels[:3 * TRAIN_BATCH], "mean": mean, "std": std,
                        "args": args, "f32_args": f32, "state_dict": sd, "fed_stacked": fed,
                        "fed_weights": fed_w, "fed_key": fed_key},
                       device="cuda", timeout=RANK_TIMEOUT_S, workdir=work / "ranks")
    spawn_s = time.perf_counter() - t0
    res = [r.result for r in got]
    for r in res:
        check(r["backend"] == backend, f"rank backend {r['backend']}, expected {backend}")
    # (a) float32 against the one process
    worst = {}
    for i, r in enumerate(res):
        a = r["f32"]
        rel = abs(a["loss"] - ref_loss) / abs(ref_loss)
        dfc = max(float((a["fc"][k] - ref_fc[k]).abs().max() / ref_fc[k].abs().max())
                  for k in ref_fc)
        dst = max(float((a["stats"][k] - ref_stats[k]).abs().max()) for k in ref_stats)
        check(rel <= 1e-5 and dfc <= 1e-4 and dst <= 1e-5,
              f"rank {i} f32 step: loss {a['loss']} vs {ref_loss} (rel {rel}), fc rel {dfc}, "
              f"BN stats {dst}")
        check(a["launches"]["tent_rows"] == 4 and a["launches"]["clahe_lab"] == 1,
              f"rank {i} f32 step launches {a['launches']}")
        worst = {"loss_rel": max(worst.get("loss_rel", 0), rel),
                 "fc_rel": max(worst.get("fc_rel", 0), dfc),
                 "bn_stats_abs": max(worst.get("bn_stats_abs", 0), dst)}
    say("data_parallel", f32_check="ok", loss_one_process=ref_loss,
        loss_ranks=[r["f32"]["loss"] for r in res], **{k: f"{v:.3g}" for k, v in worst.items()})
    # (b)-(c) bf16 timing
    for i, r in enumerate(res):
        b = r["bf16"]
        want = idle_launches(tent_rows=4 * DP_TIMED_STEPS, clahe_lab=DP_TIMED_STEPS)
        check(b["launches"] == want, f"rank {i} bf16 launches {b['launches']}, expected {want}")
        check(all(np.isfinite(b["losses"])), f"rank {i} bf16 losses {b['losses']}")
        check(b["losses"] == res[0]["bf16"]["losses"], "the ranks report different losses")
        idle = 1.0 - b["busy_ms"] / b["p50"]
        say("data_parallel", rank=i, device=r["device"], compute_dtype="bfloat16",
            steps_timed=DP_TIMED_STEPS, step_ms_p50=f"{b['p50']:.4f}",
            img_per_s_p50=f"{TRAIN_BATCH / (b['p50'] * 1e-3):.2f}",
            device_busy_ms_per_step=f"{b['busy_ms']:.4f}", idle_share=f"{idle:.4f}",
            peak_memory_gb=f"{b['peak_gb']:.3f}", all_reduce_ms_p50=f"{r['all_reduce_ms']:.4f}",
            all_reduce_bytes=r["all_reduce_bytes"], mixup_gather_ms_p50=f"{r['gather_ms']:.4f}",
            bn_sum_ms_p50=f"{r['bn_sum_ms']:.4f}")
        say("data_parallel", rank=i,
            device_ms_per_step=json.dumps({k: round(v, 6) for k, v in b["cats"].items()}))
    busy = sum(r["bf16"]["busy_ms"] for r in res)
    p50 = max(r["bf16"]["p50"] for r in res)
    say("data_parallel", ranks_share_a_card=n_cards == 1,
        card_busy_ms_per_step=f"{busy:.4f}" if n_cards == 1 else "per rank above",
        card_idle_share=f"{1.0 - busy / p50:.4f}" if n_cards == 1 else "per rank above",
        noise_draw_ms_whole_batch=f"{res[0]['noise_whole_ms']:.6f}",
        noise_draw_ms_rank_rows=f"{res[0]['noise_half_ms']:.6f}")
    # (d) switched
    for i, r in enumerate(res):
        want = idle_launches(tent_rows=4 * DP_SWITCHED_STEPS, clahe_lab=DP_SWITCHED_STEPS,
                             conv3x3_wgrad=6 * DP_SWITCHED_STEPS,
                             **{k: 20 * DP_SWITCHED_STEPS for k in BN_LAUNCHES})
        check(r["switched_launches"] == want,
              f"rank {i} switched launches {r['switched_launches']}, expected {want}")
        rel = [abs(a - b) / abs(b) for a, b in zip(r["switched"], r["unswitched"])]
        check(max(rel) <= 2e-2 and all(np.isfinite(r["switched"])),
              f"rank {i} switched losses {r['switched']} vs unswitched {r['unswitched']}")
        say("data_parallel", rank=i, switched_steps=DP_SWITCHED_STEPS,
            switched_losses=r["switched"], unswitched_losses=r["unswitched"],
            max_loss_rel_diff=f"{max(rel):.3g}")
    # (e) multihost: the FedAvg round
    ref = secure_fedavg(fed_key, {k: torch.from_numpy(v).to(dev) for k, v in fed.items()}, fed_w)
    for i, r in enumerate(res):
        bad = [k for k in ref if not torch.equal(r["fedavg"][k], ref[k].cpu())]
        check(not bad, f"rank {i} secure FedAvg differs from one process at {bad[:3]}")
    say("multihost", ranks=world, backend=backend, leaves=len(ref),
        values=sum(v[0].size for v in fed.values()), bit_for_bit="yes",
        round_ms=[f"{r['fedavg_ms']:.4f}" for r in res], spawn_seconds=f"{spawn_s:.1f}",
        rank_seconds=[f"{x.seconds:.1f}" for x in got])

    def summed(counts):
        return {k: sum(c[k] for c in counts) for k in counts[0]}

    return {"data_parallel": summed([r["bf16"]["launches"] for r in res]),
            "data_parallel_switched": summed([r["switched_launches"] for r in res])}


def _flat_tree(tree, prefix=""):
    """A nested dict/list tree as {"a/0/b": numpy leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def phase_party(torch, seed, work, ctx):
    """Phase 30, slice 10's ``party_devices``: the encrypted predict with
    each party's shares on its own device, bit for bit the unsplit predict
    of the same seed: ResNet-18 @ 224 at batch 4 under fss and snn on
    ("cuda:0", "cuda:0") (timed beside the unsplit), SimpleConv @ 28 with
    party 1 on the CPU (shares cross devices at every opening), and
    ("cuda:0", "cuda:1") where a second card exists; a secure FedAvg of
    two ResNet-18 trees with party 1 on the CPU. K4's launches counted on
    the split fss forward (21). Returns the launches of the split ResNet
    fss forwards."""
    import numpy as np

    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.mpc.aggregation import secure_fedavg
    from primia_tpu_torch.mpc.inference import build_encrypted_predict
    from primia_tpu_torch.nn import create_model

    dev = torch.device("cuda")
    args = Arguments.from_ini(ctx["ini"])
    torch.manual_seed(seed + 30)
    model = create_model(args, num_classes=3, device="cuda")
    x = ctx["imgs"][:PARTY_BATCH]
    mean, std = ctx["mean"], ctx["std"]
    launches = None
    for protocol in ("fss", "snn"):
        def pred(parties):
            return build_encrypted_predict(model, args, mean, std, dev, protocol=protocol,
                                           seed=seed + 1, party_devices=parties)
        ref = pred(None)(x)
        reset_launches()
        got = pred(("cuda:0", "cuda:0"))(x)
        torch.cuda.synchronize()
        n = read_launches()
        check(torch.equal(got, ref), f"party-split ResNet-18 {protocol} logits differ")
        check(bool(torch.isfinite(got).all()), f"{protocol}: non-finite logits")
        want = idle_launches(clahe_lab=1, dcf_sign=SIGNS_PER_FORWARD if protocol == "fss" else 0)
        check(n == want, f"split {protocol} forward launches {n}, expected {want}")
        if protocol == "fss":
            launches = n
        unsplit = pred(None)
        split = pred(("cuda:0", "cuda:0"))
        ms_u = _host_p50(torch, np, lambda: unsplit(x), 3)
        ms_s = _host_p50(torch, np, lambda: split(x), 3)
        say("party", model="resnet-18", protocol=protocol, batch=PARTY_BATCH,
            party_devices="cuda:0,cuda:0", bit_for_bit="yes", launches=json.dumps(n),
            unsplit_ms_p50=f"{ms_u:.4f}", split_ms_p50=f"{ms_s:.4f}",
            split_over_unsplit=f"{ms_s / ms_u:.3f}")

    pairs = [("cuda:0", "cpu")] + ([("cuda:0", "cuda:1")] if torch.cuda.device_count() > 1
                                   else [])
    cargs = Arguments(model="simpleconv", train_resolution=28, inference_resolution=28,
                      pooling_type="max")
    torch.manual_seed(seed + 31)
    conv = create_model(cargs, num_classes=3, device="cuda")
    cx = np.random.default_rng(seed).integers(0, 256, (PARTY_BATCH, 28, 28, 1), dtype=np.uint8)
    for parties in pairs:
        for protocol in ("fss", "snn"):
            def cpred(p):
                return build_encrypted_predict(conv, cargs, [0.5], [0.25], dev,
                                               protocol=protocol, seed=seed + 2, party_devices=p)
            ref = cpred(None)(cx)
            split = cpred(parties)
            t0 = time.perf_counter()
            got = split(cx)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            check(torch.equal(got, ref),
                  f"party-split SimpleConv {protocol} on {parties} differs from the unsplit")
            say("party", model="simpleconv@28", protocol=protocol, batch=PARTY_BATCH,
                party_devices=",".join(parties), bit_for_bit="yes", split_ms=f"{ms:.4f}")
    # secure FedAvg with party 1 on the CPU
    trees = []
    for k in range(2):
        torch.manual_seed(seed + 40 + k)
        trees.append({n: p.detach() for n, p in
                      create_model(args, num_classes=3, device="cuda").named_parameters()})
    stacked = {n: torch.stack([t[n] for t in trees]) for n in trees[0]}
    ref = secure_fedavg((seed, 5), stacked, [0.25, 0.75])
    t0 = time.perf_counter()
    got = secure_fedavg((seed, 5), stacked, [0.25, 0.75], party_devices=("cuda:0", "cpu"))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check(all(torch.equal(got[n], ref[n]) for n in ref), "party-split secure FedAvg differs")
    say("party", what="secure_fedavg resnet-18 x 2 nodes", party_devices="cuda:0,cpu",
        bit_for_bit="yes", ms=f"{ms:.4f}")
    return launches


def phase_tf_export(torch, seed, work, ctx):
    """Phase 31: the TF SavedModel bridge (``nn/tf_export.py``): whether
    TensorFlow imports here; when it does, the train CLI's card-trained
    ResNet-18 checkpoint exported (TF on the host) and its SavedModel's
    logits held to the card's eval logits within 1e-4."""
    import numpy as np

    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.nn.jax_params import from_jax_tree
    from primia_tpu_torch.nn.tf_export import export_checkpoint, load_saved_model, tf_available
    from primia_tpu_torch.train import checkpoint as ckpt
    from primia_tpu_torch.train.steps import build_eval_step

    if not tf_available():
        say("tf_export", tf_available=False, note="TensorFlow does not import here; skipped")
        return
    import tensorflow as tf

    tf.config.set_visible_devices([], "GPU")  # the SavedModel runs on the host
    state = ckpt.load_model(ctx["final"])
    args = state["args"]
    mean, std = state["val_mean_std"]
    model = create_model(args, num_classes=3, device="cuda")
    msd = state["model_state_dict"]
    model.load_state_dict(from_jax_tree(msd["params"], msd["state"]))
    x = ctx["imgs"][:4]
    _, want = build_eval_step(model, args, mean, std, device="cuda")(
        x, np.zeros(4, np.int64), np.ones(4, np.float32))
    t0 = time.perf_counter()
    path = export_checkpoint(str(ctx["final"]), str(work / "savedmodel"))
    export_s = time.perf_counter() - t0
    got = load_saved_model(path)(x)
    err = float(np.abs(got - want.cpu().numpy()).max())
    check(err <= 1e-4, f"SavedModel logits {err} from the card's eval logits")
    say("tf_export", tf_available=True, tf=tf.__version__, max_abs_err=err,
        export_seconds=f"{export_s:.1f}")


def phase_figures(torch, seed, work, ctx):
    """Phase 32: the paper-figure sweeps on the card, each over two values
    for one epoch: ``cli/figure_lambda.py`` on the synthetic train set and
    ``cli/figure_sigma.py`` on three small federated shards, each writing
    its CSV under ``build/chip_smoke/figures``; the CSV's header and one
    finite row checked."""
    import csv

    import numpy as np

    from primia_tpu_torch.cli import figure_lambda, figure_sigma

    figs = work / "figures"
    fed = figs / "fed"
    write_federated_dataset(np, np.random.default_rng(seed + 32), fed, FIG_FED_PER_CLASS)
    cwd = os.getcwd()
    os.chdir(figs)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            t0 = time.perf_counter()
            figure_lambda.main(["--lambdas", "0.5", "0.9", "--epochs", "1", "--data_dir",
                                str(ctx["root"] / "train"), "--device", "cuda"])
            t1 = time.perf_counter()
            figure_sigma.main(["--sigmas", "1", "2", "--epochs", "1", "--data_dir", str(fed),
                               "--device", "cuda"])
            t2 = time.perf_counter()
    finally:
        os.chdir(cwd)
    (work / "figures.log").write_text(out.getvalue())
    for name, heads in (("lambda_results.csv", ["0.5", "0.9"]), ("sigma_results.csv", ["1", "2"])):
        with open(figs / name, newline="") as f:
            rows = list(csv.reader(f))
        check(len(rows) == 2 and rows[0] == heads and all(np.isfinite(float(v)) for v in rows[1]),
              f"{name}: {rows}")
        say("figures", csv=str((figs / name).relative_to(ROOT)), header=rows[0], row=rows[1])
    say("figures", lambda_seconds=f"{t1 - t0:.1f}", sigma_seconds=f"{t2 - t1:.1f}")


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_out", type=Path,
                        default=ROOT / "build" / "chip_smoke" / "profile.txt",
                        help="where to write the profiler table of the predict step "
                        "(the train step's goes beside it)")
    opts = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "primia_tpu_torch" / "csrc").is_dir() or not CONFIG.is_file():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    os.environ["PRIMIA_MATERIALIZE_CACHE"] = "0"
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else ""
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        check(card, f"nvidia-smi failed: {smi.stderr.strip()}")
        check(clk.returncode == 0 and clk.stdout.strip(),
              f"nvidia-smi clocks failed: {clk.stderr.strip()}")
        sm_max_mhz, sm_mhz = (float(v) for v in clk.stdout.splitlines()[0].split(","))
        say("device", name=torch.cuda.get_device_name(0),
            capability=torch.cuda.get_device_capability(0), torch=torch.__version__,
            cuda=torch.version.cuda, sm_clock_max_mhz=sm_max_mhz, sm_clock_mhz=sm_mhz)
        seconds, t0 = {}, time.perf_counter()

        def lap(name):
            nonlocal t0
            seconds[name] = round(time.perf_counter() - t0, 1)
            t0 = time.perf_counter()

        phase_build()
        lap("build")
        rec = {}
        rec["clahe"], rec["clahe_lab"] = phase_kernels(torch, opts.seed)
        rec.update(phase_tent(torch, opts.seed))
        lap("clahe_tent")
        rec["dcf_sign"] = phase_dcf(torch, opts.seed, sm_max_mhz)
        rec["conv3x3_wgrad"] = phase_wgrad(torch, opts.seed)
        rec.update(phase_bn(torch, opts.seed))
        rec["gaussian_noise"], noise_launches = phase_noise(torch, opts.seed, sm_max_mhz)
        rec["window_attention_fwd"], rec["window_attention_bwd"] = phase_window_attention(
            torch, opts.seed)
        swin_launches = phase_swin_train(torch, opts.seed)
        rec["swin_norm_fwd"], rec["swin_norm_bwd"] = phase_swin_norm(torch, opts.seed)
        phase_ring(torch, opts.seed)
        lap("dcf_wgrad_bn_noise_attention_swin_ring")
        profile_out = opts.profile_out.resolve()
        by_path = {"noise": noise_launches, "swin_train": swin_launches,
                   "serve": phase_serve(torch, opts.seed, work, profile_out)}
        lap("serve")
        by_path["encrypt"] = phase_encrypt(torch, opts.seed, work, profile_out)
        by_path["encrypt_snn"] = phase_encrypt_snn(torch, opts.seed, work, profile_out)
        by_path["encrypt_group"] = phase_encrypt_group(torch, opts.seed, work, profile_out)
        lap("encrypt")
        by_path["train"], by_path["train_twopass0"], ctx = phase_train(torch, opts.seed, work,
                                                                       profile_out)
        lap("train")
        by_path["train_optin"] = phase_train_optin(torch, opts.seed, work, profile_out, ctx)
        lap("train_optin")
        by_path["federated"] = phase_federated(torch, opts.seed, work, profile_out)
        lap("federated")
        by_path.update(phase_dp(torch, opts.seed, work, profile_out))
        lap("dp")
        by_path.update(phase_vgg(torch, opts.seed, work, profile_out, ctx))
        lap("vgg")
        by_path.update(phase_simpleconv(torch, opts.seed, work, profile_out, ctx))
        lap("simpleconv")
        by_path.update(phase_conv_dp(torch, opts.seed, work, profile_out))
        lap("conv_dp")
        by_path.update(phase_grid(torch, opts.seed, work))
        lap("grid")
        by_path["hpo"] = phase_hpo(torch, opts.seed, work, ctx)
        lap("hpo")
        phase_warm(torch, opts.seed, work, ctx)
        lap("warm")
        phase_profile(torch, opts.seed, work, profile_out, ctx, card)
        lap("profile")
        by_path["enc_train"] = phase_enc_train(torch, opts.seed, work)
        lap("enc_train")
        by_path["enc_rnn"] = phase_enc_rnn(torch, opts.seed, work)
        lap("enc_rnn")
        phase_crypto(torch, opts.seed)
        lap("crypto")
        by_path.update(phase_data_parallel(torch, opts.seed, work, ctx))
        lap("data_parallel")
        by_path["party"] = phase_party(torch, opts.seed, work, ctx)
        lap("party")
        phase_tf_export(torch, opts.seed, work, ctx)
        lap("tf_export")
        phase_figures(torch, opts.seed, work, ctx)
        lap("figures")
        say("seconds", **seconds, total=round(sum(seconds.values()), 1))
        for name, meta in KERNELS.items():
            for path in (meta["path"], *meta.get("also", ())):
                check(by_path[path][name] > 0,
                      f"{name} was not launched on its path {path}: {by_path}")
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    say("kernels", checked=json.dumps(list(KERNELS)), launches=json.dumps(by_path))
    line = []
    for name, meta in KERNELS.items():
        r = rec[name]
        line.append({"name": name, "route": "cuda", "source": meta["source"],
                     "replaces": meta["replaces"], "launches": by_path[meta["path"]][name],
                     "paths": [meta["path"], *meta.get("also", ())],
                     "launches_by_path": {p: n[name] for p, n in by_path.items()},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                     "call_ms": r["call_ms"]})
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
