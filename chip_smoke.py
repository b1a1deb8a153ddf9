#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc); it builds every
kernel from the sources in this checkout.  Phases, each fatal:

1. environment: card, power limit, versions, TF32 off, kernel build;
2. the paged-decode kernel against its plain PyTorch version on the
   card, at the shapes the serving path gives it (table widths 1, 8 and
   64 pages, GQA, bf16, and the decode anatomy's 8 slots at 600), two
   runs bit for bit, with times, bounds and the cluster size;
3. a small serving model on the card against the same model on the CPU,
   and the GPT ``760m`` widths (head dim 96) at 2 layers, served on the
   card by the plain paged attention (no kernel instance, no launch)
   against the CPU, then 4 requests through the engine;
4. full-width serving: ``PagedDecoderLM`` at the GPT ``1b`` widths of
   ``bench.py`` (vocab 50257, hidden 1792, 24 layers, 14 heads, ffn
   7168; random weights from a seed) behind ``GenerationEngine`` and
   ``ServingServer``, answering 16 ``/generate`` requests over HTTP;
5. anatomy of one full-width decode step (8 slots at context 600): its
   time on the host's clock, and the card's busy time by kernel from
   ``torch.profiler``;
6. the three flash-attention kernels (forward, dQ, dK/dV) against their
   plain versions through the autograd Function: every head dim (32,
   64, 96, 128), f32 and bf16, causal and not, dropout 0 and 0.1, at
   BERT-base's attention shape (D 64) and smaller ones, the GPT shapes
   and a ragged case; the dropout mask's kept fraction; times beside the
   bound, the plain version and one SDPA call at BERT-base's shape
   (bf16), the GPT 760m preset's (D 96, bf16) and the static step's
   (f32, against SDPA's memory-efficient backend), each with its share
   of the bound; the f32 forward and backward bitwise across two runs,
   and the kernels SDPA's f32 forward and backward run, by name;
7. a small BERT (``bench_bert``'s CPU widths, f32, dropout 0) trained 3
   ``TrainStep``s on the card and on the CPU from the same weights;
8. full-width training: ``bench_bert``'s chip config (BERT-base, batch
   64, seq 512, dropout 0.1, O2 bf16 with f32 master weights, AdamW,
   global-norm clip) for 2 warm-up and 10 timed steps;
9. anatomy of one training step from ``torch.profiler``;
10. the fused matmul-epilogue kernels (forward; backward as two
    launches) against their plain versions at the three chains of a
    BERT-base layer (M 8192), f32 and bf16, three small recipes, and
    layer_norm recipes at N 640, 1152 and 1536 (the f32 forward's
    clusters of 5, 9 and 12 blocks), two backward runs bit for bit; the
    f32 forward with a zero bias bit for bit against K6's f32 product;
    the f32 backward's g with bias + relu bit for bit dy where the
    forward's output is positive; the fused Adam kernel against
    its plain version over the static BERT's parameters for 5 steps;
    times beside the bound, the plain version and a library call where
    one computes the same function, at f32 (the main path's) and, for
    K2f and K2b, at bf16 beside cuBLAS's bf16 products;
11. a small static BERT (``bench.build_bert_static`` at bench_pallas's
    CPU widths) trained 3 ``Executor.run``s on the card and on the CPU
    from the same weights;
12. the full-width static BERT (bench_pallas's chip config: BERT-base,
    seq 512, batch 16, f32, Adam) through ``static.Executor``: 2 warm-up
    and 8 timed runs, asserting every kernel's launches per step;
13. anatomy of one static training step from ``torch.profiler``, its
    f32 kernels named with their launches a step;
14. the chunk matmul kernel (K6) against its plain version at the chunk
    shapes of the full-width hybrid step, three ragged shapes at the
    gate's edges (M 8, M 1000, K 96) and a row-strided x written into a
    column block of a wider out, f32 and bf16; its column blocks bitwise
    equal to K6 on the whole weight; times of one layer's six products
    beside the bound, the plain version and ``torch.matmul``;
15. the flash kernels through ``flash_attention_block``, forward and
    backward with a nonzero lse cotangent, at the ring's four offset
    cases (diagonal, visible, fully masked, non-causal), f32 and bf16,
    at every head dim;
    the ring's rounds and merges composed over 2 and 4 virtual shards
    against ``flash_attention`` on the whole sequence; times;
16. one rank over a process group with gloo (CPU) and NCCL (card): the
    small hybrid GPT trained 3 ``SpmdTrainStep``s on the card and on the
    CPU from the same weights;
17. the hybrid GPT at the ``1b`` widths (bench.py:318; batch 8, seq
    1024, dropout 0.1, O2 bf16, AdamW, global-norm clip) at world size
    1 over NCCL: 2 warm-up and 8 timed steps asserting 144 K6 launches
    and 24 of each flash kernel (block entry) a step, then its anatomy
    (the host-clocked steps beside the timed ones);
18. with two cards or more, NCCL ranks on {"mp": 2, "sp": n / 2} train
    2 layers at the ``1b`` widths against a world-size-1 run; on one
    card it prints that it did not run and why;
19. ``build_gpt`` (``bench.build_gpt``, per-block recompute) at
    ``bench_gpt``'s CPU widths, f32, dropout 0, trained 3 ``TrainStep``s
    on the card and on the CPU from the same weights, phase 7's
    tolerances;
20. the same small GPT at dropout 0.1 and O2 bf16: one forward and
    backward with recompute and one without, from one seed and one set
    of weights, loss and gradients within bf16 tolerance, and whether
    they are equal bit for bit (the recomputed forward regenerates the
    flash kernels' dropout mask from the replayed seed);
21. ``bench_gpt``'s chip config: the ``760m`` preset (head dim 96),
    batch 16, seq 1024, dropout 0.1, O2 bf16, AdamW, global-norm clip,
    per-block recompute, 2 warm-up and 8 timed steps asserting 48 flash
    forwards and 24 of each backward a step; then 2 + 3 steps without
    recompute asserting 24 of each and a higher peak memory;
22. anatomy of one 760m step, its flash launches by kernel name, with
    the host-clocked steps beside the timed ones;
23. the eager core: ``vision.models.LeNet`` from seeded numpy weights
    (through ``state_dict_from_paddle_tpu``) on the card and on the CPU,
    3 eager steps (``loss.backward(); opt.step(); opt.clear_grad()``)
    with each of Adam(1e-3), SGD(0.01) and Momentum(0.01, 0.9, L2Decay
    1e-4) at batch 64, losses within rtol 1e-4 (cuDNN sums in another
    order than the CPU), every parameter and gradient a paddle Tensor on
    the card;
24. ``bench_lenet_dygraph``'s training half uncut (``paddle.seed(0)``,
    ``LeNet()``, Adam 1e-3, batch 64 x 1 x 28 x 28, 3 warm-up and 30
    timed steps each ending in ``float(loss)``): step ms, steps/s, the
    final loss, the host's enqueue ms a step, the paddle ops and torch
    ops dispatched a step, and the anatomy (device-busy share) from
    ``torch.profiler``; it launches none of the hand-written kernels;
25. the verify recipe's eager linear regression on the card
    (``to_tensor``, ``matmul``, ``mean``, ``backward``, SGD) reaching the
    known w and b within 1e-3;
26. ``paddle.save``/``paddle.load`` on the card: a Layer's and an
    optimizer's ``state_dict`` saved, loaded back onto the card (load
    follows ``set_device``) and equal;
27. ``vision.models.resnet18`` (10 classes, f32, TF32 off) from seeded
    weights trained 3 ``TrainStep`` Momentum steps on the card and on
    the CPU at batch 8 of 3 x 32 x 32: losses, the 20 batch norms'
    running statistics (all moved and finite) and the eval outputs
    within 1e-4, printed beside the CPU's own spread under a one-ulp
    input change; the card model's O2 bf16 eval forward against its
    f32 one;
28. ``bench_resnet50``'s chip config uncut (``resnet50``, NCHW, batch
    128, 224 px, bf16 O2, Momentum(0.1, 0.9) with f32 master weights,
    ``F.cross_entropy``, ``TrainStep``): 2 warm-up and 10 timed steps
    (images/s, step p50 and mean, MFU against 3 x 4.089 GF an image
    over 989 TFLOP/s, peak memory, first and last loss, the cuDNN
    ``benchmark`` setting), a first loss near ln(1000) and no
    hand-written kernel launched; then a few steps with
    ``cudnn.benchmark`` on, and of the NHWC model;
29. anatomy of one ResNet-50 step: device ms by group (convolution
    forward and backward, batch norm, elementwise and casts, GEMM,
    Momentum's update, copies), the idle share, the top kernels, and
    the batch-norm kernels torch ran, by name; then one batch norm's
    forward and backward at ResNet-50's largest, the port's route
    against ``torch.batch_norm`` (cuDNN where it takes the call), with
    the kernels each ran;
30. ``build_gpt_static`` (``bench.build_gpt_static``) at bench_pallas's
    CPU widths, 3 ``Executor.run``s on the card and on the CPU from the
    same weights and constant: the same realized kernel lists (fc1 +
    gelu a layer, the residual adds of proj and fc2, the last with the
    final layer norm, fused Adam), losses within rtol 1e-5, parameters
    within phase 11's atol (the key projections' biases within lr a
    step), every kernel's launches by name;
31. every kernel instance the static GPT and ``bench_static``'s MLP put
    on a main path, against its plain version and timed beside its
    bound and a library call: the f32 flash kernels causal at D 64 (B 8,
    L 1024, H 16; SDPA's memory-efficient backend), K2f and K2b at the
    GPT's chains (M 8192: fc1 + gelu, proj and fc2 + residual add, the
    last fc2 + add + layer_norm) and the MLP's bias + relu (M 256),
    ``torch._addmm_activation`` or ``torch.addmm`` beside the forward,
    and K3 over the GPT's ~2.0e8 trained parameters beside
    ``torch._fused_adam_``;
32. bench_pallas's static GPT at its chip config, uncut (vocab 50257,
    hidden 1024, 8 layers, 16 heads, ffn 4096, seq 1024, batch 8, f32,
    Adam 1e-4): 2 warm-up and 8 timed runs; step p50 and mean, tokens/s,
    MFU from ``Program.analyze``'s ``flops_train`` over 67 TFLOP/s (the
    PaLM count beside it), peak memory beside analyze's prediction, one
    build, and every kernel's launches a step by name (24 fused chains,
    8 of each f32 flash kernel, 1 fused Adam);
33. anatomy of one static GPT step: device ms by group, the idle share
    and the named f32 kernels' launches a step;
34. ``bench_static``'s two entries at its chip config (the static MLP:
    hidden 1024, depth 8, batch 256, 3 rounds of 100 runs; the static
    LeNet: batch 256, 50 runs; device feeds, ``return_numpy=False``):
    steps/s, step ms, ``compile_count`` 1 and ``host_feed_converts`` 0
    (asserted), every kernel's launches, and the analyzer block with
    the predicted GFLOP/s beside the achieved; the legacy loop and the
    anomaly sentry are named as cut;
35. the PTB LSTM language model of Zaremba et al. (arXiv:1409.2329,
    section 4.1) at small widths (vocab 200, hidden 32, 2 layers, 8
    steps, batch 4, dropout 0) on the card against the CPU from the same
    numpy weights: 3 steps of sparse SGD with a global-norm clip of 10,
    then 3 of ``Adam(lazy_mode=True)``; losses and touched embedding
    rows within ``TOL``, untouched rows bitwise as they were on both
    sides, lazy Adam's moments on the touched rows only;
36. its large config at full width (vocab 10000, embedding and hidden
    1500, 2 LSTM layers, 35 steps x batch 20, dropout 0.65, U(-0.04,
    0.04), SGD lr 1 with clip 10, f32 with TF32 off, Zipf-drawn ids,
    truncated BPTT): 2 warm-up and 10 timed steps (step p50 and mean,
    tokens/s, peak memory), a first loss within 2 % of ln 10000, and a
    few steps with a dense embedding gradient and of the per-step cell
    path beside; no hand-written kernel launched;
37. anatomy of one PTB-large step: device ms by kernel group, the idle
    share and top kernels; device ms by part of the step (the recurrent
    op, the head's GEMMs, softmax and cross entropy, the embedding's
    lookup and gradient, its merge and scatter update, the clip, the
    dense update); the host syncs a step (torch's sync debug mode);
38. an eager ``paddle.while_loop`` greedy decode of 64 tokens for batch
    20 through two LSTMCells sharing phase 36's weights (tokens/s, host
    syncs a token) and at phase 35's widths card against CPU (tokens
    equal, logits within ``TOL``); ``cond``, ``case`` and
    ``switch_case`` eagerly; a static Program with ``static.nn.cond``
    and ``static.nn.while_loop`` (the dynamic decode) through
    ``Executor.run``, card against CPU; the sequence ops and the IMDB
    LSTM classifier's ``sequence_pool`` card against CPU.

39. the translation model (``testing.models.TransformerNMT``: Vaswani
    et al.'s encoder-decoder with a shared, tied embedding and label
    smoothing) at small widths (2 + 2 layers, d 64, 4 heads, vocab 500,
    dropout 0) on the card against the CPU from the same weights: a
    greedy decode (ids equal), one forward and backward (gradients) and
    3 ``TrainStep``s of Adam under NoamDecay (losses), within ``TOL``,
    and the flash launches of the unmasked attentions only;
40. the f32 flash kernels at Transformer-base's attention shape (B 64,
    Lq = Lk = 64, H 8, D 64, dropout 0.1) against their plain versions,
    timed beside the bound and SDPA's memory-efficient backend, and the
    forward at one query against 1, 37 and 64 keys (decoding);
41. Transformer-base training (6 + 6 layers, d_model 512, 8 heads, FFN
    2048, dropout 0.1, vocab 37000 tied, label smoothing 0.1, Adam
    (0.9, 0.98, 1e-9) under NoamDecay(512, 4000), 64 pairs of 64 + 64
    Zipf-drawn tokens, f32 with TF32 off): 2 warm-up and 10 timed steps
    (step p50 and mean, target tokens/s, MFU by the model's FLOP count
    over 67 TFLOP/s, peak memory), a first loss near ln(vocab), and 12
    flash forwards, 12 dQ and 12 dK/dV a step (the encoder's
    self-attentions and the cross-attentions; none from the decoder's
    masked self-attention);
42. anatomy of one Transformer-base step: busy ms by kernel group, the
    idle share and the flash launches a step from the trace; busy ms by
    part (GEMMs, flash, the unfused masked attention, the head and
    loss, Adam, the rest);
43. greedy incremental decoding of Transformer-base, batch 64 for 64
    steps: ms a token, tokens/s, host syncs and flash launches a token,
    and the incremental logits against the full masked forward's at
    every position (``NMT_DECODE_TOL``);
44. beam search (``dynamic_decode``, ``BeamSearchDecoder``, beam 4)
    over phase 36's PTB-large model (its LSTM layers as cells, the
    embedding and head as ``embedding_fn``/``output_fn``), batch 20, 35
    steps: tokens/s and host syncs a step, each beam's score re-read
    along its backtracked tokens; at phase 35's widths the card's ids,
    lengths and scores against the CPU's; ``gather_tree`` on the card
    against a host backtrack;
45. each function and layer of ``nn.functional``'s and ``nn``'s tail
    (resampling, grid sampling, the losses, the in-place activations,
    the padding, upsampling, distance and loss layers, ``Bilinear``,
    ``weight_norm``) on the card against the CPU, forward and backward,
    and the random ones (channel and alpha dropout, gumbel softmax) by
    statistics on the card;
46. each tail optimizer (Adamax, Adagrad, Adadelta, RMSProp plain and
    centered, Lamb, LarsMomentum, Ftrl at ``lr_power`` -0.5 and -0.3,
    Dpsgd, ProximalGD, ProximalAdagrad, DecayedAdagrad) and EMA,
    ModelAverage and Lookahead, 5 steps on the tests' small MLP, card
    against CPU: f32 eager with a global-norm clip, O2 bf16 from the
    same fixed gradients (parameters and f32 masters), and O2 bf16
    inside ``TrainStep`` under a ``GradScaler``, at the CPU tests'
    tolerances; Dpsgd on injected draws, and its own draws on the card
    by statistics;
47. LAMB BERT-base: phase 8's config (``bench_bert``'s chip config) with
    ``Lamb(1e-4, lamb_weight_decay=0.01, 0.9, 0.999, 1e-6)`` in AdamW's
    place (You et al. 2019): 2 warm-up and 10 timed steps, step p50 and
    mean, tokens/s, peak memory, the update's device ms beside AdamW's,
    the trust ratios' min, median and max (finite and positive), a
    first loss near ln(vocab), 12 launches of each flash kernel a step;
48. LARS ResNet-50: phase 28's config with ``LarsMomentum(0.1, 0.9,
    lars_coeff=0.001, lars_weight_decay=5e-4)`` in Momentum's place
    (You et al. 2017): 2 + 10 steps, images/s, step p50, peak memory,
    the update's device ms beside Momentum's, a first loss near
    ln(1000), no hand kernel launched;
49. second derivatives: the double-backward cases and a WGAN-GP critic
    (5 Adam steps), card against CPU; ``create_graph=True`` through
    ``MultiHeadAttention`` at D 64 raises on the card (fault C9: the
    flash kernels have no second derivative), and on the CPU equals
    plain attention's;
50. the top level: flags set and put back (an XLA flag refuses another
    value); ``get_/set_cuda_rng_state`` replaying a dropout-0.1 small
    BERT step bit for bit; ``create_parameter`` and ``flops`` on the
    card; the card's ``device_count``, ``is_compiled_with_cuda`` and
    ``get_cudnn_version``;
51. the public ``paged_attention`` at phase 2's shapes: one K4 launch a
    call, equal to the plain version, with a function registered and
    after ``None`` as before;
52. each ``ops.pallas`` entry on CUDA tensors at a small shape: its
    kernel launched once (``kernel_selections``) and equal to its plain
    version; ``interpret=True`` on the card raises;
53. R1: ``bench_bert``'s model (BERT-base, f32, eval) saved by
    ``jit.save`` with ``InputSpec([None, 512], "int64")`` (the flash
    forward a custom-op node of the graph) and served by
    ``inference.create_predictor`` at batches 1, 8 and 32: 12 flash
    forwards a run and no other kernel, the output against the model
    run eagerly with ``use_pallas_kernels`` off, latency a run, save
    and load seconds, 3 variants, a batch-32 run's anatomy; the f32
    flash forward at the batch-32 shape beside its bound, plain version
    and SDPA; a small BERT saved on the CPU (the plain versions under
    the custom ops) launching the flash forward when the Predictor
    serves it from the card;
54. R2: bench_pallas's static BERT (B 16, L 512, f32) saved by
    ``static.save_inference_model`` with the MLM logits as the fetch
    variable (the fusion pass's 36 chains and 12 flash calls custom-op
    nodes of the graph) and served: 36 fused-epilogue and 12 flash
    forwards a run, the logits against the Executor's eager replay with
    ``use_pallas_kernels`` off, latency a run, a run's anatomy, and 5
    rows padded to the program's batch of 16 and sliced back;
55. R3: the predictor half of ``bench_lenet_dygraph``
    (``predictor_latency_ms_bs1``, ``predictor_recompiles``) and the
    sequential half of ``bench_serving`` (the 64-128-128-32 MLP on 240
    ragged requests of 1-4 rows under pad-to-bucket: requests/s and
    ``num_compiled_variants()`` flat after warm-up), outputs against the
    eager models;
56. R4: a ``to_static`` function with a tensor ``if`` and one with a
    tensor ``while`` saved, loaded and run on the card at inputs that
    take the other branch and other trip counts than the example, each
    equal to the eager ``to_static`` call and each graph holding
    torch's ``cond`` / ``while_loop``;
57. ``bench_serving`` whole: the 64-128-128-32 MLP, 240 ragged requests
    of 1-4 rows, 3 rounds of the sequential Predictor interleaved with 3
    of the ``InferenceEngine`` (``max_batch_size`` 32, 2 ms) under 8
    closed-loop clients each keeping 8 in flight: requests/s, the
    speedup, occupancy, requests a batch, padding waste, latency
    p50/p95/p99; no variant after warm-up, every response within 1e-5
    of the request run alone;
58. R1 (phase 53's saved BERT-base) behind the ``InferenceEngine``,
    bench_serving's traffic cut to 96 requests of 1-4 rows x 512 tokens
    and 2 rounds: requests/s, rows/s, tokens/s, the speedup over
    sequential ``Predictor.run``, occupancy, latency; 12 K1f launches
    for every batch dispatched and no other hand kernel; every response
    within ``FLASH_TOL`` of the request alone; one batch's anatomy;
59. a ``ServingServer`` over a ``ModelRegistry``: BERT-base and the MLP
    loaded through ``POST /admin/models``, ``/healthz`` 503 before
    ``mark_ready`` and 200 after, 16 ``/predict`` requests a model from
    4 clients (BERT's as ``.npy`` bodies) against each model's engine,
    an unknown model's 404, an ``unload`` that drains;
60. the C ABI built with ``g++``: ``CPredictor`` over R1 at batches 1
    and 8 (12 K1f a run, within ``FLASH_TOL`` of ``Predictor.run``, its
    latency beside ``Predictor.run``'s), and a C program compiled with
    ``gcc`` driving a small BERT saved on the card in its own embedded
    interpreter (checksums within 1e-4 of the Predictor's);
61. ``bench_generation`` whole: ``PagedDecoderLM(1024, 256, 2 layers, 8
    heads, ffn 2048)``, 48 requests generated alone by
    ``nn.dynamic_decode`` over ``make_cell``'s dense cache of 512 rows
    against the paged ``GenerationEngine``, 2 rounds: tokens/s, the
    speedup (bench.py's >= 3x gate printed), p99s and
    ``latency_bound_ms``; every baseline sequence ends in EOS after its
    budget; the cell's logits card vs CPU over 8 steps within ``TOL``;
62. hot swap under live traffic (``chaos.swap_main(supervised=False)``'s
    gate): R1 behind ``ModelRegistry.load(weights_dir=...)`` and the
    paged engine at GPT `1b` widths cut to 2 layers under one
    ``WeightWatcher``, 8 ``/predict`` and 3 streaming ``/generate``
    clients over HTTP while versions 1-3 are published and version 4
    (one byte flipped) is rejected, then the rollback case; every
    answer within ``FLASH_TOL`` of one version's answer alone, versions
    never going back, generations inside one version equal to its
    serial tokens, the swap counters, ``/healthz``, no new variant, 12
    K1f a dispatched batch or prewarm run, 2 K4 a decode step, the page
    pool, memory at rest; the swap windows' p50/p99 beside steady state,
    publish to commit, the peak with two predictors, and a replica's
    cold start by part in a fresh process;
63. the tracer, perf and an SLO monitor over phase 62's stack: the
    Prometheus text parses with every family typed once, ``/perf``'s
    sampled dispatch anatomy (device ms by CUDA events),
    ``device_memory()`` against ``torch.cuda.memory_allocated``, one
    request's spans joined client to engine batch, two spooling
    exporters and ``/admin/fleet`` over two servers, the flight
    recorder's one dump for one injected fault, and the cost of the
    tracer and perf on R1's requests/s and the eager LeNet step;
64. an ``ElasticityController`` over R1 with a ``ReplicaSet`` of R1
    replicas on the card: scale up to 2, shed (503) with ``/healthz``
    503 ``degraded``, then recover and scale down once the objective
    is raised.

Phases 65-73 (fleet, the grad_comm stage, the pipelined GPT, LocalSGD,
the sharded embedding, the supervised static BERT, the supervised swap,
shardcheck) are described at their functions.  74: BERT-base fitted by
``paddle.Model`` from a seeded corpus tokenized by the native WordPiece
tokenizer in 4 DataLoader worker processes, held to a hand-written
``TrainStep`` loop, with the Checkpoint, MetricsDump and LRScheduler
callbacks, ``evaluate``, ``predict``, ``save``/``load`` and
``summary``; 75: ResNet-50 fitted by ``paddle.Model`` from
``DatasetFolder`` images through the vision transforms in 2 workers.
76: R1 made int8 (``PTQ``, ``convert_to_int8``: ``torch._int_mm``) and
served by the Predictor (12 K1f a run, 72 int8 graph nodes, equal to
the eager int8 model, the artifact under 0.45x R1's), a run's anatomy,
the batch-32 runs under ``paddle.profiler``, and a QAT leg (3 f32
``TrainStep``s of phase 8's BERT-base with its encoder quantised);
77: ResNet-50 through ``paddle.onnx.export`` rerun node by node on the
card against its forward; 78: ``roi_align`` at Faster R-CNN R50-C4's
box head and ``yolo_box`` + ``multiclass_nms`` at YOLOv3's COCO shapes
on ResNet-50's features, each against its reference.
``python3 chip_smoke.py --phases 76,77,78`` runs the named phases of
this list alone, after the environment.

Phases 46-64 each log their number and name, print every compared
quantity beside its limit, put back in a ``finally`` the global state
they may touch (flags, dygraph mode, default dtype and device, the RNG
state, the registered paged kernel, print options, the profiler hook,
the observability hooks) and assert that a snapshot of it equals the
one taken at their start; phases 57-64 also close their engines,
servers and clients in a ``finally`` and assert that every thread they
started has ended.

The last lines are the kernels JSON object, the card's name and power
limit as ``nvidia-smi`` reports them, and ``{"ok": true, ...}``.
``python3 chip_smoke.py --phase7-runs N`` runs phase 7 alone N times
(its reproducibility, ROADMAP §C).  Any
failure prints a traceback and exits 1 without the result line.
"""
import gc
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

from paddle_tpu_torch.testing import kernel_times
from paddle_tpu_torch.testing.kernel_times import cuda_ms

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_OPS = {"float32": 67e12,       # CUDA-core f32
            "bfloat16": 989e12}     # dense tensor-core bf16
GPT_1B = dict(vocab_size=50257, hidden=1792, num_layers=24, num_heads=14,
              ffn=7168)
PAGE, SLOTS, MAX_CONTEXT = 16, 8, 1024
PROMPT_BUCKETS = [32, 64, 128, 256, 512]
TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# bench.py:159-168, bench_bert's chip and CPU configurations
BERT_CHIP = dict(vocab=30522, hidden=768, layers=12, heads=12, ffn=3072,
                 seq=512, batch=64, dropout=0.1)
BERT_CPU = dict(vocab=1000, hidden=128, layers=2, heads=4, ffn=512,
                seq=128, batch=8, dropout=0.0)
FLASH = "paddle_tpu/ops/pallas/flash_attention.py"
FLASH_KERNELS = {"flash_attention_fwd": f"{FLASH}:128",      # _fwd_kernel
                 "flash_attention_bwd_dq": f"{FLASH}:220",   # _bwd_dq_kernel
                 "flash_attention_bwd_dkv": f"{FLASH}:255"}  # _bwd_dkv_kernel
# kernel vs plain, as max |a - b| / max(1, max |b|): f32 sums taken in
# another order; bf16 probabilities and dS rounded to bf16 before the
# tensor-core products (the TPU kernel rounds them the same way)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# small BERT, card vs CPU, after 3 AdamW steps at lr 1e-4: Adam's step
# is lr * m / (sqrt(v) + eps), so the two sides agree to lr times the
# gradients' relative difference (f32 sums in other orders); 2e-5 is a
# fifth of one step.  The key projections' biases are held apart: their
# gradient is zero but for rounding (softmax ignores a shift shared by
# every key), so Adam moves them by up to lr a step on either side
BERT_PARAM_ATOL = 2e-5
# bench.py:1108-1109 and :1114-1115, bench_pallas's static BERT
STATIC_CHIP = dict(vocab=30522, hidden=768, layers=12, heads=12, ffn=3072,
                   seq=512, batch=16)
STATIC_CPU = dict(vocab=1000, hidden=128, layers=2, heads=4, ffn=512,
                  seq=128, batch=8)
EPI = "paddle_tpu/ops/pallas/fused_epilogue.py"
EPI_KERNELS = {"fused_epilogue_fwd": f"{EPI}:195",         # _fwd
               "fused_epilogue_bwd": f"{EPI}:284",         # _bwd_call
               "fused_epilogue_bwd_grads": f"{EPI}:284"}
EPI_LIBRARY_CALLS = {
    "fused_epilogue_fwd": "torch._addmm_activation(bias, x, w, "
                          "use_gelu=True), fc1 chain only",
    "fused_epilogue_bwd": "torch.matmul(x, w): the product only",
    "fused_epilogue_bwd_grads": "torch.matmul(g, w.t()) + "
                                "torch.matmul(x.t(), g)"}
ADAM_SITE = "paddle_tpu/ops/pallas/fused_adam.py:65"     # fused_adam_update
# kernel vs plain, as max |a - b| / max(1, max |b|): f32 products and
# row sums taken in another order (K up to 3072, dw over 8192 rows);
# bf16 outputs and g rounded to bf16 on both sides, one rounding apart
EPI_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ADAM_TOL = 1e-6
# per static step at BERT-base: 3 fused chains a layer, one flash call a
# layer, one Adam launch
ROOT = os.path.dirname(os.path.abspath(__file__))
# bench.py:318-319 (_GPT_PRESETS["1b"]) at batch 8, and the tests' small
# widths of the same model
GPT_TRAIN = dict(vocab=50257, hidden=1792, layers=24, heads=14, ffn=7168,
                 seq=1024, batch=8, dropout=0.1)
# bench.py:317 (_GPT_PRESETS["760m"]): head dim 96
GPT_760M = dict(vocab=50257, hidden=1536, layers=24, heads=16, ffn=6144,
                seq=1024, dropout=0.1)
GPT_SMALL = dict(vocab=1000, hidden=128, layers=2, heads=4, ffn=512,
                 seq=64, batch=4, dropout=0.0)
# bench.py:341-343 and :334-336: bench_gpt's CPU config (at dropout 0)
# and its chip config (the 760m preset at batch 16)
GPT_BENCH_CPU = dict(vocab=1000, hidden=128, layers=2, heads=4, ffn=512,
                     seq=128, batch=4, dropout=0.0)
GPT_760M_TRAIN = dict(GPT_760M, batch=16)
# per 760m step: one attention call a layer, its forward run again by
# the block's recompute; without recompute once
GPT760_PER_STEP = {"flash_attention_fwd": 48, "flash_attention_bwd_dq": 24,
                   "flash_attention_bwd_dkv": 24}
GPT760_PLAIN_PER_STEP = {k: 24 for k in GPT760_PER_STEP}
CMM_SITE = "paddle_tpu/ops/pallas/collective_matmul.py:44"  # _mm_kernel
K4 = "paged_attention"      # K4's name in ops.cuda.support.launch_counts
# K6 vs plain, as max |a - b| / max(1, max |b|), outputs ~N(0, 1): f32
# sums over K taken in another order; bf16 rounded once on either side
CMM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# per hybrid GPT step at world size 1: six chunk products a layer (q, k,
# v, proj, fc1, fc2) and one attention call a layer
GPT_PER_STEP = {"chunk_matmul": 144, "flash_attention_fwd": 24,
                "flash_attention_bwd_dq": 24, "flash_attention_bwd_dkv": 24}
STATIC_PER_STEP = {"fused_epilogue_fwd": 36, "fused_epilogue_bwd": 36,
                   "fused_epilogue_bwd_grads": 36, "fused_adam": 1,
                   "flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
                   "flash_attention_bwd_dkv": 12}


def log(*a):
    print(*a, flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def _kernel_name(key):
    """A flash or fused-epilogue kernel's name in a profiler key (mangled
    or not), without namespace, template arguments and parameters."""
    import re
    m = re.search(r"(flash_(fwd|bwd_dq|bwd_dkv)(_wgmma|_f32)?|"
                  r"epilogue_\w*?)_kernel", key)
    return m.group(0) if m else key[:80]


def _assert_wgmma_flash(flash):
    """A bf16 step's flash launches ran the wgmma + TMA kernels: the
    profiler names these three and no other flash kernel."""
    names = sorted(flash)
    want = ["flash_bwd_dkv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
            "flash_fwd_wgmma_kernel"]
    if names != want:
        raise AssertionError(f"flash kernels seen {names}, want {want}")


# ---------------------------------------------------------------- phase 1
def phase_environment():
    import torch
    from paddle_tpu_torch.ops.cuda import support
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    support.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [l.strip() for l in support.build_info["nvcc_log"].splitlines()
             if "registers" in l or "spill" in l]
    for line in ptxas:
        log("ptxas:", line)
    env = {"nvidia_smi": nvidia_smi(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "python": sys.version.split()[0],
           "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
           "kernel_build_s": round(build_s, 3),
           "nvcc_s": round(support.build_info["build_seconds"], 3)}
    log("ENV " + json.dumps(env))


# ---------------------------------------------------------------- phase 2
def _paged_bound(S, H, Hkv, D, lengths, es, dtype_name):
    live = sum(lengths)
    pages = sum(-(-n // PAGE) for n in lengths)
    nbytes = (2 * S * H * D * es            # q in, out
              + live * Hkv * D * 2 * es     # live K and V rows
              + pages * 4 + S * 4)          # live table entries, lengths
    ops = 4 * live * H * D                  # q.k and p.v multiply-adds
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


def phase_kernels():
    """paged_attention_decode vs paged_attention_reference on the card,
    two runs bit for bit, then timed beside its bound and the plain
    version; the last case is the decode anatomy's shape (phase 5)."""
    import torch
    from paddle_tpu_torch.ops.attention import paged_attention_reference
    from paddle_tpu_torch.ops.cuda import paged_attention_decode
    from paddle_tpu_torch.ops.cuda.paged_attention import (cluster_blocks,
                                                          clusters_for)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    L, D = kernel_times.LAYERS, kernel_times.HEAD_DIM
    results = []
    for label, H, Hkv, P, dtype, lens in kernel_times.paged_cases(gen):
        q, k, v, table, lengths = kernel_times.paged_inputs(gen, H, Hkv, P,
                                                            dtype, lens)
        scale = 1.0 / math.sqrt(D)
        err = 0.0
        for layer in (0, L // 2, L - 1):
            got = paged_attention_decode(q, k, v, table, lengths,
                                         scale=scale, layer=layer)
            ref = paged_attention_reference(q, k, v, table, lengths,
                                            scale=scale, layer=layer)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{label} P={P}: non-finite output")
            err = max(err, (got.float() - ref.float()).abs().max().item())
        dname = str(dtype).replace("torch.", "")
        if not err <= TOL[dname]:
            raise AssertionError(f"paged_attention {label} P={P} {dname}: "
                                 f"max abs err {err} > {TOL[dname]}")
        # no atomics: the cluster's partials merge in rank order
        a, b = (paged_attention_decode(q, k, v, table, lengths, scale=scale,
                                       layer=L // 2) for _ in range(2))
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"paged_attention {label} P={P} {dname}: "
                                 f"two runs differ")
        # event time, as every kernel's ms; the device time beside it
        # (the wrapper's host time bounds the event time of short calls)
        ms, dev_ms = kernel_times.time_paged(paged_attention_decode, q, k, v,
                                             table, lengths, scale)
        plain_ms = cuda_ms(lambda i: paged_attention_reference(
            q, k, v, table, lengths, scale=scale, layer=i % L), 12)
        bound_ms, bound_by, nbytes = _paged_bound(
            SLOTS, H, Hkv, D, lens, q.element_size(), dname)
        row = {"case": f"{label} S={SLOTS} H={H} Hkv={Hkv} D={D} "
                       f"page={PAGE} P={P} L={L} {dname}",
               "lengths": lens, "max_abs_err": err, "tol": TOL[dname],
               "bitwise_repeat": True, "split": clusters_for(q, k),
               "clusters": cluster_blocks(clusters_for(q, k), P, PAGE),
               "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
               "device_share_of_bound": bound_ms / dev_ms,
               "bound_by": bound_by, "bytes": nbytes,
               "achieved_GBps": nbytes / (ms * 1e-3) / 1e9,
               "library_ms": None}
        log("KERNEL " + json.dumps(row))
        results.append(row)
        del q, k, v, table, lengths, a, b
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------- phase 3
def _card_vs_cpu_logits(torch, geom, head_dim):
    """The same PagedDecoderLM (weights from the CPU copy) on the card
    and on the CPU: prefill of 37 tokens and three decode steps; the
    logits of every call, as f32 CPU tensors, per device."""
    from paddle_tpu_torch.serving import KVCacheConfig, PagedDecoderLM
    from paddle_tpu_torch.serving.kv_cache import PagePool
    cpu = PagedDecoderLM(device="cpu", **geom)
    gpu = PagedDecoderLM(device="cuda", **geom)
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()})
    outs = {}
    for dev, lm in (("cpu", cpu), ("cuda", gpu)):
        cfg = KVCacheConfig(geom["num_layers"], geom["num_kv_heads"],
                            head_dim, page_size=PAGE, num_pages=16,
                            max_context=128)
        kv = PagePool(cfg, device=dev).kv
        toks = (torch.arange(40, dtype=torch.int32, device=dev) * 7
                % geom["vocab_size"])
        table = torch.arange(1, 9, dtype=torch.int32, device=dev)
        logits, _ = lm.prefill(toks, 37, kv, table)
        seq = [logits]
        tables = torch.stack([table, table * 0]).contiguous()
        for pos in (37, 38, 39):
            tok = torch.tensor([pos * 3, 0], dtype=torch.int32, device=dev)
            positions = torch.tensor([pos, 0], dtype=torch.int32,
                                     device=dev)
            logits, _ = lm.decode(tok, positions, kv, tables)
            seq.append(logits[0])
        outs[dev] = [t.float().cpu() for t in seq]
    return outs, gpu


def phase_small_model_parity():
    """The same small model (head_dim 128, GQA 4/2) on the card and on
    the CPU: prefill and three decode steps, logits rtol/atol 1e-4 (f32
    products summed in other orders by cuBLAS, the kernel and the CPU).
    Then the GPT 760m preset's widths (bench.py:317: vocab 50257, hidden
    1536, 16 heads of 96, ffn 6144) at 2 layers: no paged-decode kernel
    is built for head dim 96, so the gate serves it by the plain version
    on the card, as the JAX package's gate serves it by its reference:
    card vs CPU logits (max |a - b| / max(1, max |b|) <= 1e-4), then 4
    requests through GenerationEngine on the card, every one finished,
    with no paged_attention launch."""
    import torch
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.serving import GenerationEngine
    outs, _ = _card_vs_cpu_logits(torch, dict(
        vocab_size=512, hidden=512, num_layers=2, num_heads=4,
        num_kv_heads=2, seed=5), 128)
    err = max((a - b).abs().max().item()
              for a, b in zip(outs["cpu"], outs["cuda"]))
    for a, b in zip(outs["cpu"], outs["cuda"]):
        if not torch.allclose(b, a, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"small model: card vs CPU err {err}")
    geom = dict(vocab_size=GPT_760M["vocab"], hidden=GPT_760M["hidden"],
                num_layers=2, num_heads=GPT_760M["heads"],
                num_kv_heads=GPT_760M["heads"], ffn=GPT_760M["ffn"], seed=7)
    support.reset_launch_counts()
    outs, gpu = _card_vs_cpu_logits(torch, geom, 96)
    err96 = max(((a - b).abs().max() / a.abs().max().clamp_min(1.0)).item()
                for a, b in zip(outs["cpu"], outs["cuda"]))
    if not err96 <= 1e-4:
        raise AssertionError(f"760m widths: card vs CPU err {err96}")
    eng = GenerationEngine(gpu, num_slots=4, page_size=PAGE,
                           max_context=256, prompt_buckets=[64],
                           device="cuda")
    try:
        rng = __import__("numpy").random.RandomState(96)
        reqs = [dict(prompt=rng.randint(0, geom["vocab_size"],
                                        int(rng.randint(8, 65))).tolist(),
                     max_new_tokens=12, seed=i) for i in range(4)]
        streams = [eng.generate(**r) for r in reqs]
        toks = [st.result(600) for st in streams]
    finally:
        eng.close()
    launches = support.launch_counts.get("paged_attention", 0)
    if any(len(t) != r["max_new_tokens"] for t, r in zip(toks, reqs)):
        raise AssertionError(f"760m widths: tokens {[len(t) for t in toks]}")
    if launches != 0:
        raise AssertionError(f"760m widths (head dim 96): {launches} "
                             f"paged_attention launches, want 0")
    log("PARITY " + json.dumps({
        "small_model_max_abs_err": err, "rtol": 1e-4, "atol": 1e-4,
        "gpt_760m_2_layers_max_rel_err": err96, "rel_tol": 1e-4,
        "gpt_760m_2_layers_requests_finished": len(toks),
        "gpt_760m_2_layers_paged_attention_launches": launches}))
    del gpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4
def _requests():
    import numpy as np
    rng = np.random.RandomState(1234)
    reqs = []
    for i in range(16):
        n = int(rng.randint(16, 513))
        reqs.append(dict(prompt=rng.randint(0, GPT_1B["vocab_size"],
                                            n).tolist(),
                         max_new_tokens=int(rng.randint(32, 65)),
                         temperature=0.8 if i % 4 == 3 else 0.0,
                         seed=1000 + i))
    return reqs


def phase_serving():
    import torch
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.serving import (Client, GenerationEngine,
                                          PagedDecoderLM, ServingServer)
    t0 = time.perf_counter()
    model = PagedDecoderLM(seed=0, device="cuda", **GPT_1B)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    eng = GenerationEngine(model, num_slots=SLOTS, page_size=PAGE,
                           max_context=MAX_CONTEXT,
                           prompt_buckets=PROMPT_BUCKETS, device="cuda")
    srv = None
    try:
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng.warmup()
        warmup_s = time.perf_counter() - t0
        srv = ServingServer(eng, port=0).start()
        reqs = _requests()
        results = [None] * len(reqs)
        errors = []

        def run(i):
            try:
                with Client(srv.url, timeout=600) as c:
                    r = reqs[i]
                    results[i] = (list(c.generate_stream(**r)) if i % 2
                                  else c.generate(**r))
            except BaseException as e:     # noqa: BLE001 - re-raised below
                errors.append(e)

        steps0 = eng.stats()["counters"]["decode_steps"]
        support.reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall_s = time.perf_counter() - t0
        if errors:
            raise errors[0]
        # batch independence: a greedy prompt alone gives the tokens it
        # got inside the batch
        solo_i = 0
        with Client(srv.url, timeout=600) as c:
            solo = c.generate(**reqs[solo_i])
        launches = support.launch_counts.get("paged_attention", 0)
        st = eng.stats()
        steps = st["counters"]["decode_steps"] - steps0
    finally:
        if srv is not None:
            srv.close()
        eng.close()
    for i, (r, toks) in enumerate(zip(reqs, results)):
        if toks is None or len(toks) != r["max_new_tokens"]:
            raise AssertionError(f"request {i}: {None if toks is None else len(toks)} "
                                 f"tokens, wanted {r['max_new_tokens']}")
        if not all(0 <= t < GPT_1B["vocab_size"] for t in toks):
            raise AssertionError(f"request {i}: token out of range")
    if solo != results[solo_i]:
        raise AssertionError("greedy tokens differ alone and in the batch")
    if st["page_pool"]["in_use"] != 0:
        raise AssertionError(f"page pool did not drain: {st['page_pool']}")
    if launches != steps * GPT_1B["num_layers"]:
        raise AssertionError(f"paged_attention launched {launches} times "
                             f"in {steps} decode steps (want "
                             f"{steps * GPT_1B['num_layers']})")
    if st["recompiles_after_warmup"] != 0:
        raise AssertionError(f"variants after warmup: {st}")
    gen_tokens = sum(len(t) for t in results)
    out = {"params": n_params, "weight_bytes": weight_bytes,
           "model_setup_s": setup_s, "warmup_s": warmup_s,
           "requests": len(reqs), "greedy": sum(r["temperature"] == 0
                                                for r in reqs),
           "prompt_tokens": sum(len(r["prompt"]) for r in reqs),
           "generated_tokens": gen_tokens, "wall_s": wall_s,
           "tokens_per_s": gen_tokens / wall_s,
           "decode_steps": steps, "kernel_launches": launches,
           "step_ms_p50": st["step_ms"]["p50"],
           "step_ms_p99": st["step_ms"]["p99"],
           "step_ms_mean": st["step_ms"]["mean"],
           "ttft_ms_p50": st["ttft_ms"]["p50"],
           "ttft_ms_p99": st["ttft_ms"]["p99"],
           "mean_slot_occupancy": st["mean_slot_occupancy"],
           "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
           "batch_independent": True}
    log("SERVING " + json.dumps(out))
    return launches, model, eng.page_pool.kv


# ---------------------------------------------------------------- phase 5
def phase_anatomy(model, kv):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    S, P, ctx, steps = SLOTS, 64, 600, 5
    tables = (torch.arange(S * P, dtype=torch.int32, device="cuda")
              .reshape(S, P) + 1)
    toks = torch.arange(S, dtype=torch.int32, device="cuda") * 11
    pos = torch.full((S,), ctx, dtype=torch.int32, device="cuda")
    step_ms = cuda_ms(lambda i: model.decode(toks, pos, kv, tables), 20)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            model.decode(toks, pos, kv, tables)
        torch.cuda.synchronize()
    groups = {"paged_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        name = e.key.lower()
        g = ("paged_attention" if "paged_decode" in name else
             "gemm" if "gemm" in name or "splitk" in name else "other")
        groups[g] += e.self_device_time_total / 1e3 / steps
    busy = sum(groups.values())
    if not busy > 0:
        raise AssertionError("the profiler saw no device time")
    out = {"slots": S, "context": ctx, "table_pages": P,
           "step_ms_host": step_ms, "device_busy_ms": busy,
           "device_idle_share": max(0.0, 1.0 - busy / step_ms),
           "device_ms_by_group": groups}
    log("ANATOMY " + json.dumps(out))


# ---------------------------------------------------------------- phase 6
def _flash_bound(B, H, Lq, Lk, D, es, dtype_name, causal, kernel):
    """Least time for one flash kernel: each input read once, each
    output written once; the tensor-core products over the visible
    (query, key) pairs (2 D operations per pair and product)."""
    if causal:
        pairs = sum(min(Lk, i + 1) for i in range(Lq))
    else:
        pairs = Lq * Lk
    q_bytes, k_bytes = B * H * Lq * D * es, B * H * Lk * D * es
    row_bytes = B * H * Lq * 4                   # lse or delta, f32
    nbytes, products = {
        # q k v -> out lse
        "flash_attention_fwd": (2 * q_bytes + 2 * k_bytes + row_bytes, 2),
        # q k v do lse delta -> dq: S, dP, dQ
        "flash_attention_bwd_dq": (3 * q_bytes + 2 * k_bytes
                                   + 2 * row_bytes, 3),
        # q k v do lse delta -> dk dv: S, dP, dV, dK
        "flash_attention_bwd_dkv": (2 * q_bytes + 4 * k_bytes
                                    + 2 * row_bytes, 4),
    }[kernel]
    ops = 2 * D * pairs * B * H * products
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def _flash_case(torch, gen, B, L, H, D, dtype, causal, p, seed, plain_b):
    """Forward and the three gradients through the autograd Function on
    the card, against the plain versions on the first ``plain_b``
    batch rows; errors as max |a - b| / max(1, max |b|)."""
    from paddle_tpu_torch.ops.cuda import flash_attention_fwd
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference_bwd,
        flash_attention_reference_fwd)
    q, k, v, do = (torch.randn((B, L, H, D), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    scale = 1.0 / math.sqrt(D)
    out = flash_attention(qg, kg, vg, causal=causal, dropout_p=p, seed=seed)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    _, lse = flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                 dropout_p=p, seed=seed)
    torch.cuda.synchronize()
    t = lambda x: x[:plain_b].transpose(1, 2)            # noqa: E731
    kw = dict(causal=causal, scale=scale, dropout_p=p, seed=seed)
    ro, rlse = flash_attention_reference_fwd(t(q), t(k), t(v), **kw)
    refs = flash_attention_reference_bwd(t(q), t(k), t(v), ro, rlse, t(do),
                                         **kw)
    errs = {}
    for name, got, ref in [("out", t(out), ro), ("lse", lse[:plain_b], rlse),
                           ("dq", t(grads[0]), refs[0]),
                           ("dk", t(grads[1]), refs[1]),
                           ("dv", t(grads[2]), refs[2])]:
        got, ref = got.float(), ref.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash {name}: non-finite values")
        errs[name] = ((got - ref).abs().max()
                      / ref.abs().max().clamp_min(1.0)).item()
    return errs


def _sdpa_ms(torch, q, k, v, do, p, causal, backend=None):
    """One PyTorch SDPA backend (flash by default; the memory-efficient
    one for f32, which flash refuses) on the same inputs ([B, H, L, D]
    copies): ms of the forward, of one autograd backward (dq, dk, dv
    together), and of forward + backward."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    with sdpa_kernel(backend or SDPBackend.FLASH_ATTENTION):
        fwd = cuda_ms(lambda i: sdpa(qt, kt, vt, dropout_p=p,
                                     is_causal=causal), 20)
        qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
        out = sdpa(qg, kg, vg, dropout_p=p, is_causal=causal)
        bwd = cuda_ms(lambda i: torch.autograd.grad(
            out, (qg, kg, vg), dot, retain_graph=True), 20)
        both = cuda_ms(lambda i: torch.autograd.grad(
            sdpa(qg, kg, vg, dropout_p=p, is_causal=causal), (qg, kg, vg),
            dot), 20)
    return fwd, bwd, both


def _flash_time_rows(torch, gen, B, L, H, D, dtype, causal, p, seed,
                     entry="flash_attention"):
    """The three flash kernels timed at one shape, each beside its bound,
    the plain version and one SDPA call (flash backend at bf16, the
    memory-efficient one at f32): {kernel: row}."""
    from torch.nn.attention import SDPBackend
    from paddle_tpu_torch.ops.cuda import (flash_attention_bwd_dkv,
                                           flash_attention_bwd_dq,
                                           flash_attention_fwd)
    from paddle_tpu_torch.ops.flash_attention import (
        attention_delta, flash_attention_reference_bwd,
        flash_attention_reference_fwd)
    dname = str(dtype).replace("torch.", "")
    q, k, v, do = (torch.randn((B, L, H, D), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    kw = dict(scale=scale, causal=causal, dropout_p=p)
    out, lse = flash_attention_fwd(q, k, v, seed=seed, **kw)
    delta = attention_delta(do.transpose(1, 2), out.transpose(1, 2))
    ms = {
        "flash_attention_fwd": cuda_ms(lambda i: flash_attention_fwd(
            q, k, v, seed=i, **kw), 20),
        "flash_attention_bwd_dq": cuda_ms(lambda i: flash_attention_bwd_dq(
            q, k, v, do, lse, delta, seed=seed, **kw), 20),
        "flash_attention_bwd_dkv": cuda_ms(
            lambda i: flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                              seed=seed, **kw), 20)}
    tq, tk, tv, tdo = (x.transpose(1, 2) for x in (q, k, v, do))
    pkw = dict(causal=causal, scale=scale, dropout_p=p, seed=seed)
    plain_fwd = cuda_ms(lambda i: flash_attention_reference_fwd(
        tq, tk, tv, **pkw), 2, warmup=1)
    plain_bwd = cuda_ms(lambda i: flash_attention_reference_bwd(
        tq, tk, tv, out.transpose(1, 2), lse, tdo, **pkw), 2, warmup=1)
    torch.cuda.empty_cache()
    f32 = dtype == torch.float32
    backend = SDPBackend.EFFICIENT_ATTENTION if f32 else None
    lib_fwd, lib_bwd, lib_both = _sdpa_ms(torch, q, k, v, do, p, causal,
                                          backend)
    lib_name = ("scaled_dot_product_attention, memory-efficient backend"
                if f32 else "scaled_dot_product_attention, flash backend")
    case = (f"B={B} L={L} H={H} D={D} {dname} causal={causal} "
            f"dropout={p}")
    rows = {}
    for name in FLASH_KERNELS:
        bound_ms, bound_by, nbytes, ops = _flash_bound(
            B, H, L, L, D, q.element_size(), dname, causal, name)
        fwd = name == "flash_attention_fwd"
        row = {"kernel": name, "entry": entry, "case": case,
               "ms": ms[name], "plain_ms": plain_fwd if fwd else plain_bwd,
               "bound_ms": bound_ms, "share_of_bound": bound_ms / ms[name],
               "bound_by": bound_by, "bytes": nbytes,
               "operations": ops,
               "library_ms": lib_fwd if fwd else lib_bwd,
               "library_call": lib_name if fwd else
               f"autograd backward of {lib_name} (dq, dk, dv together)",
               "library_fwd_bwd_ms": lib_both}
        if not fwd:
            row["plain_computes"] = "dq, dk and dv together"
        log("KERNEL " + json.dumps(row))
        rows[name] = row
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    return rows


def _flash_f32_bitwise(torch, gen, B, L, H, D):
    """Two runs of the f32 kernels (forward out and lse, dQ, dK/dV) agree
    bit for bit, with dropout, causal and not: no atomics, fixed sum
    orders."""
    from paddle_tpu_torch.ops.cuda import (flash_attention_bwd_dkv,
                                           flash_attention_bwd_dq,
                                           flash_attention_fwd)
    from paddle_tpu_torch.ops.flash_attention import attention_delta
    q, k, v, do = (torch.randn((B, L, H, D), generator=gen, device="cuda")
                   for _ in range(4))
    out = {}
    for causal in (False, True):
        kw = dict(scale=1.0 / math.sqrt(D), causal=causal, dropout_p=0.1,
                  seed=7)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        delta = attention_delta(do.transpose(1, 2), o.transpose(1, 2))
        runs = [(*flash_attention_fwd(q, k, v, **kw),
                 flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
                 *flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
                for _ in range(2)]
        torch.cuda.synchronize()
        out[f"causal={causal}"] = all(torch.equal(a, b)
                                      for a, b in zip(*runs))
    log("FLASH_F32_BITWISE " + json.dumps({
        "case": f"B={B} L={L} H={H} D={D} float32 dropout=0.1", **out}))
    if not all(out.values()):
        raise AssertionError(f"two f32 flash runs differ: {out}")


def _sdpa_f32_kernels(torch, gen, B, L, H, D):
    """The kernels SDPA's memory-efficient backend runs for one f32
    forward, and for the backward after it, by name from the profiler
    (does its f32 run on the tensor cores, as 3xTF32?)."""
    from torch.autograd import DeviceType
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile
    q, k, v, do = (torch.randn((B, H, L, D), generator=gen, device="cuda")
                   for _ in range(4))
    qg, kg, vg = (x.requires_grad_() for x in (q, k, v))

    def traced(fn):
        """fn's result and the CUDA kernels it ran, by name; a trace
        that caught no kernel (the tracer at times misses a whole
        session) is taken again, up to three times."""
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                res = fn()
                torch.cuda.synchronize()
            names = sorted({e.key[:160] for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA})
            if names:
                break
        return res, names

    names = {}
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out, names["forward"] = traced(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qg, kg, vg))
        _, names["backward"] = traced(
            lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                        retain_graph=True))
    log("SDPA_F32_KERNELS " + json.dumps({
        "case": f"B={B} L={L} H={H} D={D} float32", **names}))


def phase_flash_kernels():
    """The flash kernels against their plain versions on the card at
    every head dim they are built for (32, 64, 96, 128), f32 and bf16,
    causal and not, dropout 0 and 0.1; then timed at the training path's
    shape (BERT-base attention: B 64, H 12, L 512, D 64, bf16, dropout
    0.1, not causal), at the GPT 760m preset's (B 16, L 1024, H 16, D
    96, bf16, causal, dropout 0.1) and at the static BERT step's (B 16,
    L 512, H 12, D 64, f32)."""
    import torch
    from paddle_tpu_torch.core.rng import dropout_threshold
    from paddle_tpu_torch.ops.cuda.flash_attention import SUPPORTED_HEAD_DIMS
    from paddle_tpu_torch.ops.flash_attention import (dropout_keep_mask,
                                                      flash_attention)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, H, L = BERT_CHIP["batch"], BERT_CHIP["heads"], BERT_CHIP["seq"]
    D = BERT_CHIP["hidden"] // H
    seed = 1234
    # BERT-base's shape at its head dim, a smaller ragged one at the others
    cases = [(B, L, H, d, dt, causal, p, 8) if d == D else
             (4, 320, 6, d, dt, causal, p, 4)
             for d in SUPPORTED_HEAD_DIMS
             for dt in (torch.float32, torch.bfloat16)
             for causal in (False, True) for p in (0.0, 0.1)]
    cases += [(4, 512, 14, 128, torch.bfloat16, True, 0.1, 4),   # GPT 1b
              (2, 1024, 16, 96, torch.bfloat16, True, 0.1, 2),   # GPT 760m
              (3, 200, 5, 32, torch.float32, True, 0.1, 3),      # ragged
              (3, 200, 5, 32, torch.bfloat16, False, 0.1, 3)]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for (b, l, h, d, dt, causal, p, plain_b) in cases:
        dname = str(dt).replace("torch.", "")
        errs = _flash_case(torch, gen, b, l, h, d, dt, causal, p, seed,
                           plain_b)
        err = max(errs.values())
        worst[dname] = max(worst[dname], err)
        row = {"case": f"B={b} L={l} H={h} D={d} {dname} causal={causal} "
                       f"dropout={p}", "errors": errs,
               "tol": FLASH_TOL[dname]}
        log("FLASH_CHECK " + json.dumps(row))
        if not err <= FLASH_TOL[dname]:
            raise AssertionError(f"flash kernels disagree with the plain "
                                 f"version: {row}")
    # the mask itself: kept fraction within 4 sigma of 1 - p, and two
    # seeds give other masks
    p = BERT_CHIP["dropout"]
    t, _ = dropout_threshold(p)
    keep = dropout_keep_mask(seed, 8, H, L, L, p, "cuda")
    other = dropout_keep_mask(seed + 1, 8, H, L, L, p, "cuda")
    n = keep.numel()
    kept = keep.float().mean().item()
    want = 1.0 - t / 65536.0
    sigma = math.sqrt(want * (1.0 - want) / n)
    differ = (keep != other).float().mean().item()
    mask = {"elements": n, "kept": kept, "expected": want, "sigma": sigma,
            "differ_across_seeds": differ}
    log("FLASH_MASK " + json.dumps(mask))
    if abs(kept - want) > 4 * sigma or differ < 0.1:
        raise AssertionError(f"dropout mask: {mask}")
    del keep, other
    # times at the training path's shape, forward + backward beside SDPA
    rows = _flash_time_rows(torch, gen, B, L, H, D, torch.bfloat16, False,
                            p, seed)
    q, k, v, do = (torch.randn((B, L, H, D), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    ours_both = cuda_ms(lambda i: torch.autograd.grad(
        flash_attention(qg, kg, vg, dropout_p=p, seed=i), (qg, kg, vg), do),
        20)
    log("FLASH_FWD_BWD " + json.dumps({
        "case": f"B={B} L={L} H={H} D={D} bfloat16 dropout={p}",
        "kernels_ms": ours_both,
        "sdpa_flash_ms": rows["flash_attention_fwd"]["library_fwd_bwd_ms"]}))
    del q, k, v, do, qg, kg, vg
    torch.cuda.empty_cache()
    g = GPT_760M
    d96 = _flash_time_rows(torch, gen, 16, g["seq"], g["heads"],
                           g["hidden"] // g["heads"], torch.bfloat16, True,
                           g["dropout"], seed)
    s = STATIC_CHIP
    static = _flash_time_rows(torch, gen, s["batch"], s["seq"], s["heads"],
                              s["hidden"] // s["heads"], torch.float32,
                              False, 0.0, seed)
    fwd = static["flash_attention_fwd"]
    log("FLASH_F32_FWD " + json.dumps({k: fwd[k] for k in (
        "case", "ms", "bound_ms", "share_of_bound", "library_ms",
        "library_call")}))
    _flash_f32_bitwise(torch, gen, s["batch"], s["seq"], s["heads"],
                       s["hidden"] // s["heads"])
    _sdpa_f32_kernels(torch, gen, s["batch"], s["seq"], s["heads"],
                      s["hidden"] // s["heads"])
    for name, row in rows.items():
        row["max_abs_err"] = worst["float32"]
        row["max_abs_err_bf16"] = worst["bfloat16"]
        row["gpt_760m"] = d96[name]
        row["static_f32"] = static[name]
    return rows


# ---------------------------------------------------------------- phase 7
def _bert_trainer(torch, cfg, device, bf16):
    from paddle_tpu_torch import amp, jit, optimizer
    from paddle_tpu_torch.testing.models import build_model, mlm_loss
    model = build_model(cfg["vocab"], cfg["hidden"], cfg["layers"],
                        cfg["heads"], cfg["ffn"], cfg["seq"],
                        cfg["dropout"], device=device)
    opt = optimizer.AdamW(learning_rate=1e-4,
                          parameters=model.parameters(), weight_decay=0.01,
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0),
                          multi_precision=bf16)
    if bf16:
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    return model, jit.TrainStep(model, mlm_loss(model), opt, n_inputs=1,
                                donate=True)


def _bench_batch(torch, cfg, device):
    """bench.py:197-201 (and :365-368 for the GPT): ids and labels from
    RandomState(0)."""
    import numpy as np
    rng = np.random.RandomState(0)
    shape = (cfg["batch"], cfg["seq"])
    x = rng.randint(0, cfg["vocab"], shape, dtype=np.int32)
    y = rng.randint(0, cfg["vocab"], shape, dtype=np.int32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def phase_small_bert_parity():
    """bench_bert's CPU config (f32, dropout 0) trained 3 steps on the
    card and on the CPU from the same weights: losses within rtol 1e-5,
    every parameter within BERT_PARAM_ATOL, and the flash kernels
    launched once per layer and step on the card."""
    import torch
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.ops.cuda import support
    cfg, steps = BERT_CPU, 3
    seed(7)
    cpu, cpu_step = _bert_trainer(torch, cfg, "cpu", False)
    gpu, gpu_step = _bert_trainer(torch, cfg, "cuda", False)
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()})
    losses = {}
    for dev, step in (("cpu", cpu_step), ("cuda", gpu_step)):
        x, y = _bench_batch(torch, cfg, dev)
        support.reset_launch_counts()
        losses[dev] = [float(step(x, y)) for _ in range(steps)]
        counts = dict(support.launch_counts)
        if dev == "cuda":
            want = cfg["layers"] * steps
            if any(counts.get(n, 0) != want for n in FLASH_KERNELS):
                raise AssertionError(f"small BERT: launches {counts}, "
                                     f"want {want} of each flash kernel")
    gp = dict(gpu.named_parameters())
    diffs = {n: (gp[n].detach().cpu() - p.detach()).abs().max().item()
             for n, p in cpu.named_parameters()}
    k_bias = {n: d for n, d in diffs.items()
              if n.endswith("self_attn.k_proj.bias")}
    rest = {n: d for n, d in diffs.items() if n not in k_bias}
    worst = max(rest, key=rest.get)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    # each side's final parameters bit for bit, to tell runs apart
    prints = {}
    for side, model in (("cpu", cpu), ("cuda", gpu)):
        h = hashlib.sha256()
        for n, p in sorted(model.named_parameters()):
            h.update(p.detach().cpu().numpy().tobytes())
        prints[side] = h.hexdigest()[:16]
    out = {"losses_cpu": losses["cpu"], "losses_cuda": losses["cuda"],
           "loss_max_rel_err": loss_err, "param_max_abs_err": rest[worst],
           "param_worst": worst, "k_proj_bias_max_abs_err":
           max(k_bias.values()), "loss_rtol": 1e-5,
           "param_atol": BERT_PARAM_ATOL, "k_proj_bias_atol": 2e-4 * steps,
           "param_fingerprints": prints}
    log("BERT_PARITY " + json.dumps(out))
    if (not loss_err <= 1e-5 or not rest[worst] <= BERT_PARAM_ATOL
            or not max(k_bias.values()) <= 2e-4 * steps):
        raise AssertionError(f"small BERT card vs CPU: {out}")


# ---------------------------------------------------------------- phase 8
def _clocked_step(torch, one_step):
    """``one_step()`` run to a synchronise: its result and its ms on the
    host clock."""
    t0 = time.perf_counter()
    out = one_step()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _train_steps(torch, step, batch, n):
    """``n`` steps, each clocked by :func:`_clocked_step`: losses, step
    ms and the launches counted over them."""
    from paddle_tpu_torch.ops.cuda import support
    x, y = batch
    support.reset_launch_counts()
    runs = [_clocked_step(torch, lambda: step(x, y)) for _ in range(n)]
    return ([float(loss) for loss, _ in runs], [ms for _, ms in runs],
            dict(support.launch_counts))


def phase_bert_training(warmup=2, steps=10):
    """bench_bert's chip config on the card: every loss finite, the
    first near ln(vocab), each flash kernel launched 12 times a step."""
    import numpy as np
    import torch
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.testing.models import bench_flops_per_step
    cfg = BERT_CHIP
    seed(2024)
    t0 = time.perf_counter()
    model, step = _bert_trainer(torch, cfg, "cuda", True)
    x, y = _bench_batch(torch, cfg, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, counts = _train_steps(torch, step, (x, y),
                                                   warmup + steps)
    counts = {n: counts.get(n, 0) for n in FLASH_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    timed = step_ms[warmup:]
    flops = bench_flops_per_step(model, cfg["vocab"], cfg["hidden"],
                                 cfg["layers"], cfg["seq"], cfg["batch"])
    mean_ms = sum(timed) / len(timed)
    tokens = cfg["batch"] * cfg["seq"]
    out = {"config": cfg, "dtype": "bfloat16 O2, f32 master weights",
           "params": sum(p.numel() for p in model.parameters()),
           "setup_s": setup_s, "warmup_steps": warmup, "timed_steps": steps,
           "losses": losses, "step_ms": timed,
           "step_ms_p50": float(np.median(timed)), "step_ms_mean": mean_ms,
           "first_steps_ms": step_ms[:warmup],
           "tokens_per_s": tokens / (mean_ms / 1e3),
           "model_flops_per_step": flops,
           "mfu": flops / (mean_ms / 1e3) / PEAK_OPS["bfloat16"],
           "peak_bound_ms": flops / PEAK_OPS["bfloat16"] * 1e3,
           "max_memory_allocated": peak, "flash_launches": counts}
    log("TRAIN " + json.dumps(out))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(cfg["vocab"])) > 0.5:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln({cfg['vocab']}) = "
                             f"{math.log(cfg['vocab'])}")
    want = cfg["layers"] * (warmup + steps)
    if any(c != want for c in counts.values()):
        raise AssertionError(f"flash launches {counts}, want {want} each")
    return counts, model, step, (x, y)


# ---------------------------------------------------------------- phase 9
def _step_anatomy(tag, one_step, steps, classify, wgmma_flash=False,
                  timed_ms=None):
    """One training step's anatomy: its time (CUDA events over 3
    back-to-back steps, ``step_ms_host``), then 3 steps each on the host
    clock (:func:`_clocked_step`) with the ms Python's cyclic GC paused
    each, printed beside the training phase's timed steps
    (``timed_ms``), then ``torch.profiler`` over ``steps`` steps after
    one warm-up step: device ms a step by ``classify``'s groups (a
    function of the lower-case kernel name), the flash kernels by name,
    the top kernels and the device's idle share.  With ``wgmma_flash``
    the flash launches must have run the wgmma + TMA kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    step_ms = cuda_ms(lambda i: one_step(), 3, warmup=1)
    pause = {"s": 0.0, "t0": None}

    def on_gc(phase, info):
        if phase == "start":
            pause["t0"] = time.perf_counter()
        elif pause["t0"] is not None:
            pause["s"] += time.perf_counter() - pause["t0"]
            pause["t0"] = None

    clocked, gc_ms = [], []
    gc.callbacks.append(on_gc)
    try:
        for _ in range(3):
            s0 = pause["s"]
            clocked.append(_clocked_step(torch, one_step)[1])
            gc_ms.append((pause["s"] - s0) * 1e3)
    finally:
        gc.callbacks.remove(on_gc)
    # each trace starts with one step the profiler collects and throws
    # away (the schedule's warm-up): late in a long run a session has
    # lost the records of one or a few of its first hand-kernel
    # launches in every trace, the counters showing them launched.
    # Every step launches the same kernels, so a trace with no device
    # time, or a named kernel's count that is no whole multiple of
    # ``steps``, means the tracer dropped records all the same: it is
    # taken again, up to six times.  The tracer only ever drops a
    # record, so each named kernel's launches are the most any trace saw
    most = {}
    for attempt in range(6):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=steps,
                                       repeat=1)) as prof:
            for _ in range(1 + steps):
                one_step()
                torch.cuda.synchronize()
                prof.step()
        groups, top, flash, epi, launches = {}, [], {}, {}, {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.is_user_annotation:
                continue
            name = e.key.lower()
            ms = e.self_device_time_total / 1e3 / steps
            g = classify(name)
            groups[g] = groups.get(g, 0.0) + ms
            top.append((ms, e.key[:80]))
            if "flash_" in name or "epilogue_" in name:
                k = _kernel_name(e.key)
                named = flash if "flash_" in name else epi
                named[k] = named.get(k, 0.0) + ms
                launches[k] = launches.get(k, 0) + e.count / steps
        del prof
        gc.collect()
        for k, n in launches.items():
            most[k] = max(most.get(k, 0), n)
        launches = dict(most)
        if groups and all(float(n).is_integer() for n in launches.values()):
            break
    busy = sum(groups.values())
    if not busy > 0:
        raise AssertionError("the profiler saw no device time")
    top.sort(reverse=True)
    out = {"step_ms_host": step_ms,
           "host_clocked_steps_ms": clocked, "host_clocked_gc_ms": gc_ms,
           "timed_steps_ms": timed_ms, "device_busy_ms": busy,
           "device_idle_share": max(0.0, 1.0 - busy / step_ms),
           "device_ms_by_group": groups, "flash_kernels_ms": flash,
           "epilogue_kernels_ms": epi, "launches_per_step": launches,
           "trace_attempts": attempt + 1,
           "top_kernels_ms": [[round(m, 4), n] for m, n in top[:24]]}
    log(tag + " " + json.dumps(out))
    if wgmma_flash:
        _assert_wgmma_flash(flash)
    return launches


def _is_gemm(name):
    return any(w in name for w in ("gemm", "xmma", "cutlass", "splitk",
                                   "nvjet"))


def phase_train_anatomy(step, batch, steps=2):
    x, y = batch
    _step_anatomy("TRAIN_ANATOMY", lambda: step(x, y), steps, lambda n: (
        "flash_fwd" if "flash_fwd_" in n else
        "flash_bwd" if "flash_bwd_" in n else
        "gemm" if _is_gemm(n) else "other"), wgmma_flash=True)


# --------------------------------------------------------------- phase 10
def _epi_chains(cfg):
    """The three fused chains of a BERT-base layer: (label, K, N,
    stages after the bias, residual?)."""
    h, f = cfg["hidden"], cfg["ffn"]
    ln = ("layer_norm", 1e-5, True, True)
    return [("proj", h, h, (("add",), ln)),
            ("fc1", h, f, (("gelu", True),)),
            ("fc2", f, h, (("add",), ln))]


def _epi_case(torch, gen, M, K, N, stages, dtype):
    """x, w and the operands (bias first, as fused_linear_epilogue lays
    them out) and dy, on the card."""
    from paddle_tpu_torch.ops.fused_epilogue import ops_per_stage
    r = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                   device="cuda")
    x = r(M, K)
    w = r(K, N) * math.sqrt(2.0 / (K + N))
    ops = [r(1, N) * 0.1]
    for st in stages:
        if st[0] == "add":
            ops.append(r(M, N))
        elif st[0] == "layer_norm":
            ops += [1.0 + 0.1 * r(1, N), 0.1 * r(1, N)][:ops_per_stage(st)]
    dy = r(M, N)
    return [t.to(dtype) for t in (x, w, dy)] + [[o.to(dtype) for o in ops]]


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    if not bool(got.isfinite().all()):
        raise AssertionError("non-finite kernel output")
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1.0)).item()


def _epi_bounds(M, K, N, stages, es, dtype_name):
    """Least times of the three launches of one chain (each input read
    once, each output written once; the products' 2 M K N operations a
    product at the dtype's peak)."""
    n_res = sum(st[0] == "add" for st in stages)
    n_vec = 1 + sum(2 for st in stages if st[0] == "layer_norm")
    mk, kn, mn = M * K * es, K * N * es, M * N * es
    vec = n_vec * N * es
    ops1 = 2 * M * K * N
    launches = {
        # x w ops -> out
        "fused_epilogue_fwd": (mk + kn + vec + n_res * mn + mn, ops1),
        # x w dy ops -> g, d-residual, partial sums (one row per
        # 128-row block at f32)
        "fused_epilogue_bwd": (mk + kn + 2 * mn + vec + 2 * n_res * mn
                               + math.ceil(M / 128) * n_vec * N * 4, ops1),
        # x w g partials -> dx dw(f32) dvec
        "fused_epilogue_bwd_grads": (2 * mk + kn + mn + K * N * 4
                                     + math.ceil(M / 128) * n_vec * N * 4
                                     + n_vec * N * 4, 2 * ops1)}
    out = {}
    for name, (nbytes, ops) in launches.items():
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = ops / PEAK_OPS[dtype_name] * 1e3
        out[name] = (max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
                     nbytes, ops)
    return out


def _epi_check(torch, x, w, dy, ops, stages):
    """K2f and K2b against the plain versions on the same inputs: the
    error of each output."""
    from paddle_tpu_torch.ops.cuda import fused_epilogue as cuda_epi
    from paddle_tpu_torch.ops.fused_epilogue import (
        epilogue_backward_reference, epilogue_forward_reference)
    full = (("bias",),) + tuple(stages)
    out = cuda_epi.fused_epilogue_fwd(x, w, ops, full)
    dx, dw, dops = cuda_epi.fused_epilogue_bwd(x, w, ops, full, dy)
    torch.cuda.synchronize()
    ref = epilogue_forward_reference(x, w, ops, full)
    rdx, rdw, rdops = epilogue_backward_reference(x, w, ops, full, dy)
    errs = {"out": _rel_err(out, ref), "dx": _rel_err(dx, rdx),
            "dw": _rel_err(dw, rdw)}
    names = ["d_bias"]
    for st in stages:
        if st[0] == "add":
            names.append("d_residual")
        elif st[0] == "layer_norm":
            names += ["d_ln_weight", "d_ln_bias"]
    for name, a, b in zip(names, dops, rdops):
        errs[name] = _rel_err(a, b)
    # determinism: a second backward agrees bit for bit, g included
    dx2, dw2, dops2 = cuda_epi.fused_epilogue_bwd(x, w, ops, full, dy)
    g1 = cuda_epi.fused_epilogue_bwd_rows(x, w, ops, full, dy)[0]
    g2 = cuda_epi.fused_epilogue_bwd_rows(x, w, ops, full, dy)[0]
    same = (torch.equal(dx, dx2) and torch.equal(dw, dw2)
            and torch.equal(g1, g2)
            and all(torch.equal(a, b) for a, b in zip(dops, dops2)))
    if not same:
        raise AssertionError("two fused_epilogue_bwd runs differ")
    return errs


def _epi_relu_replay(torch, gen):
    """K2b at f32 replays K2f's accumulator bit for bit: with bias + relu
    its g is dy where K2f's output is positive and 0 elsewhere, exactly
    (ragged rows and depth, a cluster-free grid of 5 column blocks)."""
    from paddle_tpu_torch.ops.cuda import fused_epilogue as cuda_epi
    stages = (("bias",), ("relu",))
    x, w, dy, ops = _epi_case(torch, gen, 1000, 264, 640, (("relu",),),
                              torch.float32)
    out = cuda_epi.fused_epilogue_fwd(x, w, ops, stages)
    g, _, _ = cuda_epi.fused_epilogue_bwd_rows(x, w, ops, stages, dy)
    torch.cuda.synchronize()
    equal = torch.equal(g, torch.where(out > 0, dy, torch.zeros_like(dy)))
    log("EPILOGUE_RELU_REPLAY " + json.dumps({
        "case": "bias+relu M=1000 K=264 N=640 float32",
        "g_equals_dy_where_out_positive": equal}))
    if not equal:
        raise AssertionError("K2b's g differs from dy * (K2f's out > 0)")


def _epi_bitwise_k6(torch, gen, M):
    """K2f at f32 with a zero bias equals K6's f32 product bit for bit:
    both sum every element as one FMA chain over k in order (fc1's
    shape)."""
    from paddle_tpu_torch.ops.cuda import chunk_matmul as k6
    from paddle_tpu_torch.ops.cuda import fused_epilogue as cuda_epi
    K, N = STATIC_CHIP["hidden"], STATIC_CHIP["ffn"]
    x = torch.randn((M, K), generator=gen, device="cuda")
    w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
    zero = torch.zeros((1, N), device="cuda")
    out = cuda_epi.fused_epilogue_fwd(x, w, [zero], (("bias",),))
    ref = k6.chunk_matmul(x, w)
    torch.cuda.synchronize()
    equal = torch.equal(out, ref)
    log("EPILOGUE_BITWISE_K6 " + json.dumps({
        "case": f"bias 0, M={M} K={K} N={N} float32", "equal": equal}))
    if not equal:
        raise AssertionError("K2f f32 with a zero bias differs from K6's "
                             "f32 product")


def _static_param_shapes(cfg):
    """program.parameters() of build_bert_static, in order."""
    h, f, v = cfg["hidden"], cfg["ffn"], cfg["vocab"]
    layer = [(h, h), (h,)] * 4 + [(h,), (h,), (h, f), (f,), (f, h), (h,),
                                  (h,), (h,)]
    return [(v, h)] + layer * cfg["layers"] + [(h, v), (v,)]


def _adam_skip_check(torch, kern, sides, lr, step):
    """The anomaly sentry's skip flag on K3: a flagged launch (a device
    int 1) against the plain version with the same flag: p, m and v of
    both bitwise unchanged; then an unflagged one (a device int 0)
    against the plain version, within ADAM_TOL; the flagged and the
    flag-0 launch timed beside the flagless one."""
    from paddle_tpu_torch.ops.fused_adam import fused_adam_reference_
    one = torch.ones((), dtype=torch.int32, device="cuda")
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    held = [t for side in ("kernel", "plain") for i in (0, 2, 3)
            for t in sides[side][i]]
    before = [t.clone() for t in held]
    kern(lr, step, skip=one)
    fused_adam_reference_(*sides["plain"], lr, step, skip=one)
    torch.cuda.synchronize()
    unchanged = all(torch.equal(a, b) for a, b in zip(held, before))
    del before
    kern(lr, step, skip=zero)
    fused_adam_reference_(*sides["plain"], lr, step, skip=zero)
    torch.cuda.synchronize()
    err = max(max((a - b).abs().max().item() for a, b in zip(la, lb))
              for la, lb in zip(sides["kernel"], sides["plain"]))
    out = {"flagged_unchanged": unchanged, "flag0_max_abs_err": err,
           "tol": ADAM_TOL,
           "flagged_ms": cuda_ms(lambda i: kern(lr, step, skip=one), 20),
           "flag0_ms": cuda_ms(lambda i: kern(lr, step, skip=zero), 20)}
    log("ADAM_SKIP_CHECK " + json.dumps(out))
    if not unchanged or not err <= ADAM_TOL:
        raise AssertionError(f"fused_adam skip flag: {out}")
    return out


def _adam_phase(torch, gen, shapes=None):
    """K3 over ``shapes`` (default: the full-width static BERT's
    parameters): 5 steps against the plain version, then times;
    torch._fused_adam_ timed beside it."""
    from paddle_tpu_torch.ops.fused_adam import (FusedAdam,
                                                 fused_adam_reference_)
    default_shapes = shapes is None
    shapes = shapes or _static_param_shapes(STATIC_CHIP)
    numel = sum(math.prod(s) for s in shapes)
    ps = [torch.randn(s, generator=gen, device="cuda") * 0.02
          for s in shapes]
    sides = {}
    for side in ("kernel", "plain"):
        sides[side] = ([p.clone() for p in ps],
                       [torch.zeros_like(p) for p in ps],
                       [torch.zeros_like(p) for p in ps],
                       [torch.zeros_like(p) for p in ps])
    lr = torch.full((), 1e-4, device="cuda")
    step = torch.zeros((), device="cuda")
    kern = FusedAdam(*sides["kernel"])
    for _ in range(5):
        step += 1
        grads = [torch.randn(s, generator=gen, device="cuda")
                 for s in shapes]
        for side in ("kernel", "plain"):
            torch._foreach_copy_(sides[side][1], grads)
        kern(lr, step)
        fused_adam_reference_(*sides["plain"], lr, step)
    torch.cuda.synchronize()
    err = max(max((a - b).abs().max().item() for a, b in zip(la, lb))
              for la, lb in zip(sides["kernel"], sides["plain"]))
    if not err <= ADAM_TOL:
        raise AssertionError(f"fused_adam: max abs err {err} > {ADAM_TOL}")
    flagged = _adam_skip_check(torch, kern, sides, lr, step) \
        if default_shapes else None
    ms = cuda_ms(lambda i: kern(lr, step), 20)
    plain_ms = cuda_ms(lambda i: fused_adam_reference_(*sides["plain"], lr,
                                                        step), 5)
    lp, lg, lm, lv = sides["plain"]
    steps = [torch.full((), 6.0, device="cuda") for _ in lp]
    lib_ms = cuda_ms(lambda i: torch._fused_adam_(
        lp, lg, lm, lv, [], steps, lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False), 20)
    nbytes = 28 * numel
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = 15 * numel / PEAK_OPS["float32"] * 1e3
    row = {"kernel": "fused_adam", "tensors": len(shapes), "numel": numel,
           "max_abs_err": err, "tol": ADAM_TOL, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_b, t_o),
           "bound_by": "bytes" if t_b >= t_o else "operations",
           "bytes": nbytes, "achieved_GBps": nbytes / (ms * 1e-3) / 1e9,
           "library_ms": lib_ms,
           "library_call": "torch._fused_adam_ over the same lists"}
    if flagged is not None:
        row["skip_flag"] = flagged
    log("KERNEL " + json.dumps(row))
    del sides, ps, grads, steps, kern
    torch.cuda.empty_cache()
    return row


def _epi_bf16_times(torch, gen, M):
    """The bf16 instances of K2f and K2b (on no main path) timed over
    the three BERT-base chains, beside the bound, their plain versions
    (the whole backward for both backward launches, as at f32) and
    cuBLAS's bf16 products: {kernel: row}."""
    from paddle_tpu_torch.ops.cuda import fused_epilogue as cuda_epi
    from paddle_tpu_torch.ops.fused_epilogue import (
        epilogue_backward_reference, epilogue_forward_reference)
    rows = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "library_ms": 0.0, "chains": {}} for name in EPI_KERNELS}
    calls = {"fused_epilogue_fwd": "torch.matmul(x, w): the product only",
             "fused_epilogue_bwd": "torch.matmul(x, w): the product only",
             "fused_epilogue_bwd_grads": EPI_LIBRARY_CALLS[
                 "fused_epilogue_bwd_grads"]}
    for label, K, N, stages in _epi_chains(STATIC_CHIP):
        x, w, dy, ops = _epi_case(torch, gen, M, K, N, stages,
                                  torch.bfloat16)
        full = (("bias",),) + tuple(stages)
        g, partial, _ = cuda_epi.fused_epilogue_bwd_rows(x, w, ops, full, dy)
        ms = {"fused_epilogue_fwd": cuda_ms(
                  lambda i: cuda_epi.fused_epilogue_fwd(x, w, ops, full), 10),
              "fused_epilogue_bwd": cuda_ms(
                  lambda i: cuda_epi.fused_epilogue_bwd_rows(x, w, ops, full,
                                                             dy), 10),
              "fused_epilogue_bwd_grads": cuda_ms(
                  lambda i: cuda_epi.fused_epilogue_bwd_grads(x, w, ops, g,
                                                              partial), 10)}
        plain_fwd = cuda_ms(lambda i: epilogue_forward_reference(
            x, w, ops, full), 5)
        plain_bwd = cuda_ms(lambda i: epilogue_backward_reference(
            x, w, ops, full, dy), 5)
        product = cuda_ms(lambda i: torch.matmul(x, w), 10)
        lib = {"fused_epilogue_fwd": product, "fused_epilogue_bwd": product,
               "fused_epilogue_bwd_grads": cuda_ms(
                   lambda i: (torch.matmul(g, w.t()),
                              torch.matmul(x.t(), g)), 10)}
        bounds = _epi_bounds(M, K, N, stages, 2, "bfloat16")
        for name in EPI_KERNELS:
            b_ms, b_by, _, _ = bounds[name]
            rows[name]["chains"][label] = {
                "ms": ms[name], "bound_ms": b_ms, "bound_by": b_by,
                "plain_ms": (plain_fwd if name == "fused_epilogue_fwd"
                             else plain_bwd),
                "library_ms": lib[name]}
            for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                rows[name][key] += rows[name]["chains"][label][key]
        del x, w, dy, ops, g, partial
        torch.cuda.empty_cache()
    for name, row in rows.items():
        row["bound_by"] = ("bytes" if all(c["bound_by"] == "bytes"
                                          for c in row["chains"].values())
                           else "operations")
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["library_call"] = calls[name]
        row["case"] = (f"one BERT-base layer: proj, fc1 and fc2 chains at "
                       f"M={M}, bfloat16, times summed")
        log("KERNEL_BF16 " + json.dumps(dict(kernel=name, **row)))
    return rows


def _epi_chain_times(torch, gen, M, K, N, stages, fwd_call, fwd_call_name):
    """The three launches of one f32 chain timed at (M, K, N), each beside
    its bound, the plain version (the forward, or the whole backward) and
    a library yardstick, f32 with TF32 off: ``fwd_call(x, w, ops)()``
    (``fwd_call`` makes, outside the timing, a call computing the same
    forward; None where there is none) for the forward, the product it
    replays (x . w) for the first backward launch, the two products it
    computes (dx = g . w^T, dw = x^T . g) for the second: {kernel: chain
    row}."""
    from paddle_tpu_torch.ops.cuda import fused_epilogue as cuda_epi
    from paddle_tpu_torch.ops.fused_epilogue import (
        epilogue_backward_reference, epilogue_forward_reference)
    x, w, dy, ops = _epi_case(torch, gen, M, K, N, stages, torch.float32)
    full = (("bias",),) + tuple(stages)
    g, partial, _ = cuda_epi.fused_epilogue_bwd_rows(x, w, ops, full, dy)
    ms = {"fused_epilogue_fwd": cuda_ms(
              lambda i: cuda_epi.fused_epilogue_fwd(x, w, ops, full), 10),
          "fused_epilogue_bwd": cuda_ms(
              lambda i: cuda_epi.fused_epilogue_bwd_rows(x, w, ops, full,
                                                         dy), 10),
          "fused_epilogue_bwd_grads": cuda_ms(
              lambda i: cuda_epi.fused_epilogue_bwd_grads(x, w, ops, g,
                                                          partial), 10)}
    plain_fwd = cuda_ms(lambda i: epilogue_forward_reference(
        x, w, ops, full), 5)
    plain_bwd = cuda_ms(lambda i: epilogue_backward_reference(
        x, w, ops, full, dy), 5)
    lib = {"fused_epilogue_fwd": None if fwd_call is None else cuda_ms(
               lambda i, call=fwd_call(x, w, ops): call(), 10),
           "fused_epilogue_bwd": cuda_ms(lambda i: torch.matmul(x, w), 10),
           "fused_epilogue_bwd_grads": cuda_ms(
               lambda i: (torch.matmul(g, w.t()),
                          torch.matmul(x.t(), g)), 10)}
    calls = dict(EPI_LIBRARY_CALLS, fused_epilogue_fwd=fwd_call_name)
    bounds = _epi_bounds(M, K, N, stages, 4, "float32")
    out = {}
    for name in EPI_KERNELS:
        b_ms, b_by, nbytes, nops = bounds[name]
        fwd = name == "fused_epilogue_fwd"
        out[name] = {"ms": ms[name], "plain_ms": plain_fwd if fwd
                     else plain_bwd, "bound_ms": b_ms, "bound_by": b_by,
                     "bytes": nbytes, "operations": nops,
                     "library_ms": lib[name], "library_call": calls[name]}
    del x, w, dy, ops, g, partial
    torch.cuda.empty_cache()
    return out


def phase_epilogue_adam_kernels():
    """K2f and K2b against their plain versions: the three BERT-base
    chains at M 8192 in f32 and bf16, three small recipes (bias only,
    relu, gelu-erf) at a ragged shape, layer_norm recipes over clusters
    of 5, 9 and 12 blocks; K2f bitwise against K6 at f32; times of the
    f32 chains (the main path's dtype); then K3."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    M = STATIC_CHIP["batch"] * STATIC_CHIP["seq"]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(label, M, K, N, st, dt)
             for label, K, N, st in _epi_chains(STATIC_CHIP)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(name, 200, 72, 256, st, dt)
              for name, st in (("bias_only", ()), ("relu", (("relu",),)),
                               ("gelu_erf", (("gelu", False),)))
              for dt in (torch.float32, torch.bfloat16)]
    # layer_norm rows joined over clusters of 5, 9 and 12 blocks (the f32
    # forward), at a depth off the 128 tile and rows off the 128 tile
    ln = ("layer_norm", 1e-5, True, True)
    cases += [(f"add+layer_norm cluster {n // 128}", 1000, 264, n,
               (("add",), ln), dt)
              for n in (640, 1152, 1536)
              for dt in (torch.float32, torch.bfloat16)]
    for label, m, k, n, stages, dt in cases:
        dname = str(dt).replace("torch.", "")
        x, w, dy, ops = _epi_case(torch, gen, m, k, n, stages, dt)
        errs = _epi_check(torch, x, w, dy, ops, stages)
        err = max(errs.values())
        worst[dname] = max(worst[dname], err)
        row = {"case": f"{label} M={m} K={k} N={n} {dname}",
               "errors": errs, "tol": EPI_TOL[dname]}
        log("EPILOGUE_CHECK " + json.dumps(row))
        if not err <= EPI_TOL[dname]:
            raise AssertionError(f"fused epilogue kernels disagree with "
                                 f"the plain versions: {row}")
        del x, w, dy, ops
    _epi_bitwise_k6(torch, gen, M)
    _epi_relu_replay(torch, gen)
    # times at the main path's shapes, f32
    rows = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bytes": 0, "operations": 0, "chains": {}}
            for name in EPI_KERNELS}
    for label, K, N, stages in _epi_chains(STATIC_CHIP):
        fwd_call = (lambda x, w, ops: lambda: torch._addmm_activation(
            ops[0][0], x, w, use_gelu=True)) if label == "fc1" else None
        chains = _epi_chain_times(torch, gen, M, K, N, stages, fwd_call,
                                  EPI_LIBRARY_CALLS["fused_epilogue_fwd"])
        for name in EPI_KERNELS:
            chain = chains[name]
            fwd = name == "fused_epilogue_fwd"
            rows[name]["chains"][label] = chain
            for key in ("ms", "bound_ms", "bytes", "operations"):
                rows[name][key] += chain[key]
            if not fwd:
                rows[name]["library_ms"] = (rows[name].get("library_ms", 0.0)
                                            + chain["library_ms"])
            rows[name]["plain_ms"] += chain["plain_ms"]
            log("KERNEL " + json.dumps(dict(
                kernel=name, case=f"{label} M={M} K={K} N={N} float32",
                **chain)))
    for name, row in rows.items():
        row.setdefault("library_ms", None)
        row["library_call"] = EPI_LIBRARY_CALLS[name]
        row["bound_by"] = ("bytes" if all(c["bound_by"] == "bytes"
                                          for c in row["chains"].values())
                           else "operations")
        row["max_abs_err"] = worst["float32"]
        row["max_abs_err_bf16"] = worst["bfloat16"]
        row["case"] = (f"one BERT-base layer: proj, fc1 and fc2 chains at "
                       f"M={M}, float32, times summed")
        if name != "fused_epilogue_fwd":
            row["plain_computes"] = "the whole backward of the chain"
        log("KERNEL_LAYER " + json.dumps(dict(kernel=name, **row)))
    for name, row in _epi_bf16_times(torch, gen, M).items():
        rows[name]["bf16"] = row
    rows["fused_adam"] = _adam_phase(torch, gen)
    return rows


# --------------------------------------------------------------- phase 11
def phase_static_small_parity():
    """bench_pallas's CPU widths, 3 runs on the CPU and on the card from
    the same weights and constants: losses within rtol 1e-5, parameters
    within BERT_PARAM_ATOL (the key projections' biases within lr a
    step), the same realized kernels, and the kernels' launches on the
    card."""
    import numpy as np
    import torch
    from paddle_tpu_torch import static
    from paddle_tpu_torch.framework_io import program_state_from_paddle_tpu
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import build_bert_static
    cfg, runs = STATIC_CPU, 3
    built = {dev: build_bert_static(**cfg, device=dev)
             for dev in ("cpu", "cuda")}
    cpu_main = built["cpu"][0]
    program_state_from_paddle_tpu(
        built["cuda"][0], [p.detach().numpy() for p in cpu_main.parameters()],
        [v.numpy() for node in cpu_main.nodes for tag, v in node.in_specs
         if tag == "c"])
    losses, kernels = {}, {}
    for dev, (main, loss, feeds) in built.items():
        exe = static.Executor(dev)
        feed = {k: torch.from_numpy(v).to(dev)
                for k, v in feeds(np.random.RandomState(0)).items()}
        support.reset_launch_counts()
        losses[dev] = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                       for _ in range(runs)]
        kernels[dev] = next(iter(exe._cache.values())).kernels
    counts = dict(support.launch_counts)
    want = {k: v // STATIC_CHIP["layers"] * cfg["layers"] * runs
            for k, v in STATIC_PER_STEP.items() if k != "fused_adam"}
    want["fused_adam"] = runs
    if any(counts.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"small static BERT launches {counts}, want "
                             f"{want}")
    if (kernels["cpu"] != kernels["cuda"]
            or len(kernels["cuda"]) != 3 * cfg["layers"] + 1):
        raise AssertionError(f"realized kernels differ: {kernels}")
    diffs = [(p.detach().cpu() - q.detach()).abs().max().item()
             for p, q in zip(built["cuda"][0].parameters(),
                             cpu_main.parameters())]
    # parameters: tok, then 16 a layer (wq.w, wq.b, wk.w, wk.b, ...)
    k_bias = {1 + 16 * layer + 3 for layer in range(cfg["layers"])}
    rest = max(d for i, d in enumerate(diffs) if i not in k_bias)
    kb = max(diffs[i] for i in k_bias)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    out = {"losses_cpu": losses["cpu"], "losses_cuda": losses["cuda"],
           "loss_max_rel_err": loss_err, "param_max_abs_err": rest,
           "k_proj_bias_max_abs_err": kb, "loss_rtol": 1e-5,
           "param_atol": BERT_PARAM_ATOL, "k_proj_bias_atol": 2e-4 * runs,
           "kernels": kernels["cuda"], "launches": counts}
    log("STATIC_PARITY " + json.dumps(out))
    if (not loss_err <= 1e-5 or not rest <= BERT_PARAM_ATOL
            or not kb <= 2e-4 * runs):
        raise AssertionError(f"small static BERT card vs CPU: {out}")


# --------------------------------------------------------------- phase 12
def phase_static_training(warmup=2, steps=8):
    """bench_pallas's static BERT at its chip config on the card: losses
    finite and near ln(vocab), every kernel launched as often a step as
    the program has chains, flash calls and optimizers."""
    import numpy as np
    import torch
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import (build_bert_static,
                                                 palm_flops_per_step)
    cfg = STATIC_CHIP
    t0 = time.perf_counter()
    main, loss, feeds = build_bert_static(**cfg, device="cuda")
    exe = static.Executor("cuda")
    feed = {k: torch.from_numpy(v).cuda()
            for k, v in feeds(np.random.RandomState(0)).items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    support.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[0]))
    counts = dict(support.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in main.parameters())
    timed = step_ms[warmup:]
    mean_ms = sum(timed) / len(timed)
    tokens = cfg["batch"] * cfg["seq"]
    # the PaLM count; the token embedding is a lookup and the position
    # embedding a constant of the program
    flops = palm_flops_per_step(n_params - cfg["vocab"] * cfg["hidden"],
                                cfg["layers"], cfg["seq"], cfg["batch"],
                                cfg["hidden"])
    kernels = next(iter(exe._cache.values())).kernels
    out = {"config": cfg, "dtype": "float32", "optimizer": "Adam(1e-4)",
           "params_trained": n_params, "setup_s": setup_s,
           "warmup_runs": warmup, "timed_runs": steps, "losses": losses,
           "step_ms": timed, "step_ms_p50": float(np.median(timed)),
           "step_ms_mean": mean_ms, "first_runs_ms": step_ms[:warmup],
           "tokens_per_s": tokens / (mean_ms / 1e3),
           "model_flops_per_step": flops,
           "mfu_f32": flops / (mean_ms / 1e3) / PEAK_OPS["float32"],
           "mfu_peak": "67 TFLOP/s, f32 on the CUDA cores",
           "peak_bound_ms": flops / PEAK_OPS["float32"] * 1e3,
           "max_memory_allocated": peak, "launches": counts,
           "realized_kernels": kernels, "compile_count": exe.compile_count}
    log("STATIC_TRAIN " + json.dumps(out))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(cfg["vocab"])) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln({cfg['vocab']}) = "
                             f"{math.log(cfg['vocab'])}")
    runs = warmup + steps
    want = {k: v * runs for k, v in STATIC_PER_STEP.items()}
    if any(counts.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"static launches {counts}, want {want}")
    if exe.compile_count != 1:
        raise AssertionError(f"{exe.compile_count} builds, want 1")
    return counts, (exe, main, loss, feed)


# --------------------------------------------------------------- phase 13
# the f32 static step's kernels by name, and their launches a step: the
# register-tiled kernels of K2 and K1 (forward and backward)
STATIC_NAMED = {"epilogue_fwd_f32_kernel": 36,
                "epilogue_bwd_f32_kernel": 36,
                "epilogue_grads_f32_kernel": 36, "flash_fwd_f32_kernel": 12,
                "flash_bwd_dq_f32_kernel": 12, "flash_bwd_dkv_f32_kernel": 12}


def phase_static_anatomy(run, steps=2):
    exe, main, loss, feed = run
    launches = _step_anatomy("STATIC_ANATOMY", lambda: exe.run(
        main, feed=feed, fetch_list=[loss], return_numpy=False), steps,
        lambda n: ("fused_epilogue" if "epilogue_" in n else
                   "fused_adam" if "adam_kernel" in n else
                   "flash" if "flash_" in n else
                   "cublas" if _is_gemm(n) else "other"))
    seen = {k: launches.get(k, 0) for k in STATIC_NAMED}
    if seen != STATIC_NAMED:
        raise AssertionError(f"static step kernels {seen}, want "
                             f"{STATIC_NAMED}")


# --------------------------------------------------------------- phase 14
def _cmm_bound(M, K, N, es, dtype_name):
    """Least time of one chunk product: x, w read once, out written
    once; 2 M K N operations at the dtype's peak."""
    nbytes = (M * K + K * N + M * N) * es
    ops = 2 * M * K * N
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS[dtype_name] * 1e3
    return (max(t_b, t_o), "bytes" if t_b >= t_o else "operations", nbytes,
            ops)


def _gpt_layer_chunks(cfg):
    """The six chunk products of one hybrid GPT layer at world size 1:
    (label, K, N)."""
    h, f = cfg["hidden"], cfg["ffn"]
    return [("q", h, h), ("k", h, h), ("v", h, h), ("proj", h, h),
            ("fc1", h, f), ("fc2", f, h)]


def phase_chunk_matmul():
    """K6 against its plain version: the chunk shapes of the full-width
    step (M 8192; K, N from 1792 and 7168 and their halves, the shards of
    mp 2), three ragged shapes at the gate's edges and strided views,
    f32 and bf16; the column blocks bitwise against K6 on the whole
    weight; times of one
    layer's six products at bf16 (the main path's dtype) beside the
    bound, the plain version and torch.matmul."""
    import torch
    from paddle_tpu_torch.ops.chunk_matmul import chunk_matmul_reference
    from paddle_tpu_torch.ops.cuda import chunk_matmul as k6
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    cfg = GPT_TRAIN
    M, h, f = cfg["batch"] * cfg["seq"], cfg["hidden"], cfg["ffn"]
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    shapes = [(M, K, N) for K, N in ((h, h), (h, f), (f, h), (h, h // 2),
                                     (h, f // 2), (h // 2, h), (f // 2, h))]
    # the gate's edges: the smallest M; an M off the 128-row tile; a K
    # off the 64-deep tile
    shapes += [(8, 128, 128), (1000, 384, 640), (1000, 96, 640)]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for m, k, n in shapes:
        x, w = r(m, k), r(k, n) / math.sqrt(k)
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).replace("torch.", "")
            xd, wd = x.to(dt), w.to(dt)
            err = _rel_err(k6.chunk_matmul(xd, wd),
                           chunk_matmul_reference(xd, wd))
            worst[dname] = max(worst[dname], err)
            row = {"case": f"M={m} K={k} N={n} {dname}", "error": err,
                   "tol": CMM_TOL[dname]}
            log("CHUNK_MATMUL_CHECK " + json.dumps(row))
            if not err <= CMM_TOL[dname]:
                raise AssertionError(f"chunk_matmul disagrees with the "
                                     f"plain version: {row}")
        del x, w, xd, wd
    # x a row-strided view (ldx > K) and out a column block (ldo > N)
    xw, w = r(1000, 384), r(96, 640) / math.sqrt(96)
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).replace("torch.", "")
        xs, wd = xw.to(dt)[:, 64:160], w.to(dt)
        out = torch.full((1000, 1280), float("nan"), device="cuda", dtype=dt)
        k6.chunk_matmul(xs, wd, out[:, 640:])
        torch.cuda.synchronize()
        err = _rel_err(out[:, 640:], chunk_matmul_reference(xs, wd))
        worst[dname] = max(worst[dname], err)
        row = {"case": f"M=1000 K=96 N=640 ldx=384 ldo=1280 {dname}",
               "error": err, "tol": CMM_TOL[dname]}
        log("CHUNK_MATMUL_CHECK " + json.dumps(row))
        if not err <= CMM_TOL[dname] or not bool(
                out[:, :640].float().isnan().all()):
            raise AssertionError(f"chunk_matmul on strided views: {row}")
    del xw, w, xs, wd, out
    # the column blocks of the ring form: each chunk written in place
    # into its block equals K6 on the whole weight, bit for bit
    x, w = r(M, h), r(h, f) / math.sqrt(h)
    for dt in (torch.float32, torch.bfloat16):
        xd, wd = x.to(dt), w.to(dt)
        whole = k6.chunk_matmul(xd, wd)
        out = torch.full_like(whole, float("nan"))
        for j in range(f // h):
            k6.chunk_matmul(xd, wd[:, j * h:(j + 1) * h].contiguous(),
                            out[:, j * h:(j + 1) * h])
        torch.cuda.synchronize()
        if not torch.equal(out, whole):
            raise AssertionError(f"chunk_matmul column blocks differ from "
                                 f"the whole product ({dt})")
    log("CHUNK_MATMUL_BITWISE " + json.dumps({
        "case": f"M={M} K={h} N={f}: {f // h} chunks of {h} columns",
        "dtypes": ["float32", "bfloat16"], "equal": True}))
    del x, w, xd, wd, whole, out
    # times at the main path's shapes: one layer's six products, bf16
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
             "bytes": 0, "operations": 0}
    chunks = {}
    for label, K, N in _gpt_layer_chunks(cfg):
        x = r(M, K).to(torch.bfloat16)
        w = (r(K, N) / math.sqrt(K)).to(torch.bfloat16)
        out = torch.empty(M, N, device="cuda", dtype=torch.bfloat16)
        ms = cuda_ms(lambda i: k6.chunk_matmul(x, w, out), 20)
        plain = cuda_ms(lambda i: chunk_matmul_reference(x, w), 5)
        lib = cuda_ms(lambda i: torch.matmul(x, w, out=out), 20)
        b_ms, b_by, nbytes, ops = _cmm_bound(M, K, N, 2, "bfloat16")
        c = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib, "bytes": nbytes, "operations": ops,
             "tflops": ops / (ms * 1e-3) / 1e12}
        chunks[label] = c
        for key in total:
            total[key] += c[key]
        log("KERNEL " + json.dumps(dict(kernel="chunk_matmul",
                                        case=f"{label} M={M} K={K} N={N} "
                                             f"bfloat16", **c)))
        del x, w, out
    # f32 at one shape, for the record (no f32 chunk on the main path)
    x, w = r(M, h), r(h, h) / math.sqrt(h)
    f32 = {"ms": cuda_ms(lambda i: k6.chunk_matmul(x, w), 10),
           "library_ms": cuda_ms(lambda i: torch.matmul(x, w), 10),
           "bound_ms": _cmm_bound(M, h, h, 4, "float32")[0]}
    log("KERNEL " + json.dumps(dict(kernel="chunk_matmul",
                                    case=f"M={M} K={h} N={h} float32",
                                    **f32)))
    del x, w
    torch.cuda.empty_cache()
    row = dict(total, bound_by="operations" if all(
        c["bound_by"] == "operations" for c in chunks.values()) else "bytes",
        case=f"one GPT-1b layer's six chunk products (q, k, v, proj, fc1, "
             f"fc2) at M={M}, bfloat16, times summed",
        max_abs_err=worst["float32"], max_abs_err_bf16=worst["bfloat16"],
        library_call="torch.matmul (cuBLAS), bf16", chunks=chunks,
        float32_1792=f32)
    log("KERNEL_LAYER " + json.dumps(dict(kernel="chunk_matmul", **row)))
    return row


# --------------------------------------------------------------- phase 15
def phase_flash_block():
    """flash_attention_block against the plain version, forward and
    backward with a nonzero dlse, at the ring's four offset cases (f32
    and bf16, D 128, the 1b step's shard at sp 2: L 512, H 14; and at L
    192 for every other head dim the kernels are built for) and at
    the main path's call (B 8, L 1024, H 14, D 128, causal at offsets 0,
    the one call phase 17 makes at world size 1); the per-round merge
    composed over S = 2 and 4 virtual shards in one process against
    flash_attention over the whole sequence; times of the main path's
    call at bf16 beside the bound, the plain version and SDPA."""
    import torch
    from paddle_tpu_torch.ops.cuda.flash_attention import SUPPORTED_HEAD_DIMS
    from paddle_tpu_torch.ops.flash_attention import (
        NEG_INF, flash_attention, flash_attention_block,
        flash_attention_reference_bwd, flash_attention_reference_fwd)
    from paddle_tpu_torch.parallel.ring_attention import merge_blocks
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    cfg = GPT_TRAIN
    H = cfg["heads"]
    D = cfg["hidden"] // H
    Ls, B = cfg["seq"] // 2, 2
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    t = lambda x: x.transpose(1, 2)                              # noqa: E731
    L, Bt = cfg["seq"], cfg["batch"]
    # name: (batch, block length, q_off, k_off, causal)
    cases = {"diagonal": (B, Ls, Ls, Ls, True),
             "visible": (B, Ls, Ls, 0, True),
             "masked": (B, Ls, 0, Ls, True),
             "noncausal": (B, Ls, Ls, 0, False),
             "main_path": (Bt, L, 0, 0, True)}
    # the ring's cases at every other head dim, smaller
    for d in SUPPORTED_HEAD_DIMS:
        if d != D:
            cases.update({f"{name} D={d}": (B, 192, 192 * o_q // Ls,
                                             192 * o_k // Ls, c, d)
                          for name, (_, _, o_q, o_k, c) in list(
                              cases.items())[:4]})
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).replace("torch.", "")
        for name, case in cases.items():
            Bc, Lc, q_off, k_off, causal = case[:5]
            Dc = case[5] if len(case) > 5 else D
            q, k, v, do = (r(Bc, Lc, H, Dc).to(dt) for _ in range(4))
            dlse = r(Bc, H, Lc)
            a = [x.clone().requires_grad_() for x in (q, k, v)]
            out, lse = flash_attention_block(*a, q_off, k_off, None, causal)
            grads = torch.autograd.grad((out, lse), a, (do, dlse))
            kw = dict(causal=causal, q_off=q_off, k_off=k_off)
            ro, rlse = flash_attention_reference_fwd(t(q), t(k), t(v), **kw)
            refs = flash_attention_reference_bwd(t(q), t(k), t(v), ro, rlse,
                                                 t(do), dlse, **kw)
            torch.cuda.synchronize()
            errs = {n: _rel_err(g, ref) for n, g, ref in [
                ("out", t(out), ro), ("lse", lse, rlse),
                ("dq", t(grads[0]), refs[0]), ("dk", t(grads[1]), refs[1]),
                ("dv", t(grads[2]), refs[2])]}
            err = max(errs.values())
            worst[dname] = max(worst[dname], err)
            row = {"case": f"{name} B={Bc} L={Lc} H={H} D={Dc} {dname} "
                           f"q_off={q_off} k_off={k_off} causal={causal}",
                   "errors": errs, "tol": FLASH_TOL[dname]}
            if name.startswith("masked"):
                row["masked_rows_zero"] = bool(
                    (lse == NEG_INF).all() and (out == 0).all()
                    and all((g == 0).all() for g in grads))
                if not row["masked_rows_zero"]:
                    raise AssertionError(f"fully masked block: {row}")
            log("FLASH_BLOCK_CHECK " + json.dumps(row))
            if not err <= FLASH_TOL[dname]:
                raise AssertionError(f"flash block entry disagrees with the "
                                     f"plain version: {row}")
            del q, k, v, do, dlse, a, out, lse, grads, ro, rlse, refs
        torch.cuda.empty_cache()
    # the ring's rounds and merges, S virtual shards in one process
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).replace("torch.", "")
        q, k, v, w = (r(B, L, H, D).to(dt) for _ in range(4))
        b = [x.clone().requires_grad_() for x in (q, k, v)]
        ref = flash_attention(*b, causal=True)
        rgrads = torch.autograd.grad((ref.float() * w.float()).sum(), b)
        for S in (2, 4):
            n = L // S
            a = [x.clone().requires_grad_() for x in (q, k, v)]
            outs = []
            for my in range(S):
                o = lse = None
                for rnd in range(S):
                    src = (my - rnd) % S
                    o_b, lse_b = flash_attention_block(
                        a[0][:, my * n:(my + 1) * n],
                        a[1][:, src * n:(src + 1) * n],
                        a[2][:, src * n:(src + 1) * n], my * n, src * n,
                        None, True)
                    if o is None:
                        o, lse = o_b.float(), lse_b
                    else:
                        o, lse = merge_blocks(o, lse, o_b, lse_b)
                outs.append(o.to(dt))
            out = torch.cat(outs, dim=1)
            grads = torch.autograd.grad((out.float() * w.float()).sum(), a)
            torch.cuda.synchronize()
            errs = {n_: _rel_err(g, rr) for n_, g, rr in [
                ("out", out, ref), ("dq", grads[0], rgrads[0]),
                ("dk", grads[1], rgrads[1]), ("dv", grads[2], rgrads[2])]}
            row = {"case": f"S={S} virtual shards of L={L}, B={B} H={H} "
                           f"D={D} {dname} causal", "errors": errs,
                   "tol": FLASH_TOL[dname]}
            log("RING_COMPOSE_CHECK " + json.dumps(row))
            if not max(errs.values()) <= FLASH_TOL[dname]:
                raise AssertionError(f"composed ring rounds disagree with "
                                     f"flash_attention: {row}")
        del q, k, v, w, b, ref, rgrads, a, out, grads
    torch.cuda.empty_cache()
    # times at the main path's call
    rows = _flash_time_rows(torch, gen, Bt, L, H, D, torch.bfloat16, True,
                            0.0, 0, entry="flash_attention_block")
    for row in rows.values():
        row["max_abs_err"] = worst["float32"]
        row["max_abs_err_bf16"] = worst["bfloat16"]
    return rows


# --------------------------------------------------------------- phase 16
def phase_small_gpt_parity(steps=3):
    """One rank over a process group that carries both backends (gloo
    for CPU tensors, NCCL for CUDA tensors); the small hybrid GPT (the
    tests' widths, f32, dropout 0) trained 3 SpmdTrainSteps on the card
    and on the CPU from the same weights: losses rtol 1e-5, parameters
    within BERT_PARAM_ATOL (the key projections' biases within lr a
    step, as phase 7), and K6 and the flash block entry launched as
    often as the model has chunk products and attention calls."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import build_gpt_hybrid
    from paddle_tpu_torch.testing.parallel_cases import gpt_run
    init_parallel_env(backend="cpu:gloo,cuda:nccl")
    for dev in ("cpu", "cuda"):           # both backends answer
        one = torch.ones(1, device=dev)
        dist.all_reduce(one)
        if one.item() != 1.0:
            raise AssertionError(f"one-rank all_reduce on {dev}: {one}")
    cfg = GPT_SMALL
    rng.seed(7)
    state = {k: v.numpy() for k, v in build_gpt_hybrid(
        cfg["vocab"], cfg["hidden"], cfg["layers"], cfg["heads"],
        cfg["ffn"], cfg["seq"], 0.0, device="cpu").state_dict().items()}
    data = np.random.RandomState(0)
    batch = tuple(data.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]))
                  for _ in range(2))
    losses, models = {}, {}
    for dev in ("cpu", "cuda"):
        support.reset_launch_counts()
        losses[dev], models[dev] = gpt_run(cfg, state, batch, steps,
                                           {"dp": 1}, dev)
        counts = dict(support.launch_counts)
    # ring attention reaches the flash kernels only through the block
    # entry, so every flash launch here is one of its
    want = {"chunk_matmul": 6 * cfg["layers"] * steps}
    want.update({k: cfg["layers"] * steps for k in FLASH_KERNELS})
    if any(counts.get(k, 0) != n for k, n in want.items()):
        raise AssertionError(f"small GPT launches {counts}, want {want}")
    gp = dict(models["cuda"].named_parameters())
    diffs = {n: (gp[n].detach().cpu() - p.detach()).abs().max().item()
             for n, p in models["cpu"].named_parameters()}
    k_bias = {n: d for n, d in diffs.items() if n.endswith(".k.bias")}
    rest = {n: d for n, d in diffs.items() if n not in k_bias}
    worst = max(rest, key=rest.get)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    out = {"config": cfg, "losses_cpu": losses["cpu"],
           "losses_cuda": losses["cuda"], "loss_max_rel_err": loss_err,
           "param_max_abs_err": rest[worst], "param_worst": worst,
           "k_bias_max_abs_err": max(k_bias.values()), "loss_rtol": 1e-5,
           "param_atol": BERT_PARAM_ATOL, "k_bias_atol": 2e-4 * steps,
           "launches": counts, "backend": dist.get_backend()}
    log("GPT_PARITY " + json.dumps(out))
    if (not loss_err <= 1e-5 or not rest[worst] <= BERT_PARAM_ATOL
            or not max(k_bias.values()) <= 2e-4 * steps):
        raise AssertionError(f"small hybrid GPT card vs CPU: {out}")


# --------------------------------------------------------------- phase 17
def phase_gpt_training(warmup=2, steps=8):
    """The hybrid GPT at the 1b widths, uncut (batch 8, seq 1024,
    dropout 0.1, O2 bf16 with f32 masters, AdamW, global-norm clip 1.0)
    through SpmdTrainStep at world size 1: losses finite, the first near
    ln(vocab), and per step 144 K6 launches (6 a layer) and 24 of each
    flash kernel, all through the block entry."""
    import numpy as np
    import torch
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.distributed import init_mesh
    from paddle_tpu_torch.parallel import SpmdTrainStep
    from paddle_tpu_torch.testing.models import (build_gpt_hybrid, gpt_loss,
                                                 gpt_flops_per_step)
    cfg = GPT_TRAIN
    t0 = time.perf_counter()
    mesh = init_mesh({"dp": 1})
    rng.seed(2024)
    model = build_gpt_hybrid(cfg["vocab"], cfg["hidden"], cfg["layers"],
                             cfg["heads"], cfg["ffn"], cfg["seq"],
                             cfg["dropout"], device="cuda")
    opt = optimizer.AdamW(learning_rate=2e-4, parameters=model.parameters(),
                          weight_decay=0.01,
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0),
                          multi_precision=True)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = SpmdTrainStep(model, gpt_loss(model), opt, mesh=mesh)
    data = np.random.RandomState(0)
    x, y = (torch.from_numpy(data.randint(0, cfg["vocab"],
                                          (cfg["batch"], cfg["seq"])))
            .cuda() for _ in range(2))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, counts = _train_steps(torch, step, (x, y),
                                                   warmup + steps)
    peak = torch.cuda.max_memory_allocated()
    timed = step_ms[warmup:]
    mean_ms = sum(timed) / len(timed)
    tokens = cfg["batch"] * cfg["seq"]
    flops = gpt_flops_per_step(cfg["vocab"], cfg["hidden"], cfg["layers"],
                               cfg["seq"], cfg["batch"], cfg["ffn"])
    out = {"config": cfg, "mesh": mesh.shape,
           "dtype": "bfloat16 O2, f32 master weights",
           "params": sum(p.numel() for p in model.parameters()),
           "setup_s": setup_s, "warmup_steps": warmup, "timed_steps": steps,
           "losses": losses, "step_ms": timed,
           "step_ms_p50": float(np.median(timed)), "step_ms_mean": mean_ms,
           "first_steps_ms": step_ms[:warmup],
           "tokens_per_s": tokens / (mean_ms / 1e3),
           "model_flops_per_step": flops,
           "mfu": flops / (mean_ms / 1e3) / PEAK_OPS["bfloat16"],
           "peak_bound_ms": flops / PEAK_OPS["bfloat16"] * 1e3,
           "max_memory_allocated": peak, "launches": counts}
    log("GPT_TRAIN " + json.dumps(out))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(cfg["vocab"])) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln({cfg['vocab']}) = "
                             f"{math.log(cfg['vocab'])}")
    runs = warmup + steps
    want = {k: n * runs for k, n in GPT_PER_STEP.items()}
    if any(counts.get(k, 0) != n for k, n in want.items()):
        raise AssertionError(f"hybrid GPT launches {counts}, want {want}")
    return counts, step, (x, y), timed


def phase_gpt_anatomy(step, batch, timed_ms, steps=2):
    x, y = batch
    _step_anatomy("GPT_ANATOMY", lambda: step(x, y), steps, lambda n: (
        "chunk_matmul" if "chunk_mm" in n else
        "flash_fwd" if "flash_fwd_" in n else
        "flash_bwd" if "flash_bwd_" in n else
        "nccl" if "nccl" in n else
        "cublas" if _is_gemm(n) else "other"), wgmma_flash=True,
        timed_ms=timed_ms)


# --------------------------------------------------------------- phase 18
def phase_multicard(steps=3):
    """Where the machine shows two cards or more: min(4, count) NCCL
    ranks (spawned, one card each) on {"mp": 2, "sp": n / 2} (or {"sp":
    2} on two cards) train the hybrid GPT at the 1b widths with 2 layers
    (f32, dropout 0, batch 4) for 3 steps from seeded weights; their
    losses against a world-size-1 run of the same model and weights on
    this process's card, rtol 1e-4 (f32 sums over shards in other
    orders, then 3 AdamW steps).  On four cards it then runs the fleet
    leg (:func:`_multicard_fleet`) and the pipeline and hybrid {dp, mp}
    legs (:func:`_multicard_pipeline_hybrid`).  On one card it says it
    did not run."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed.launch import free_port, spawn
    from paddle_tpu_torch.testing import parallel_cases
    count = torch.cuda.device_count()
    if count < 2:
        log("MULTICARD " + json.dumps({
            "ran": False, "device_count": count,
            "why": "needs two CUDA devices or more: NCCL refuses two ranks "
                   "on one card (Duplicate GPU detected)"}))
        return None
    n = 4 if count >= 4 else 2
    shape = {"mp": 2, "sp": n // 2} if n == 4 else {"sp": 2}
    cfg = dict(GPT_TRAIN, layers=2, dropout=0.0, batch=4)
    outdir = os.path.join(ROOT, "build", "chip_smoke_multicard")
    os.makedirs(outdir, exist_ok=True)
    data = np.random.RandomState(18)
    gx, gy = (data.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]))
              for _ in range(2))
    inputs = {f"cfg.{k}": np.asarray(cfg[k]) for k in
              ("vocab", "hidden", "layers", "heads", "ffn", "seq")}
    inputs.update(mesh_axes=np.asarray(",".join(shape)),
                  mesh_sizes=np.asarray(list(shape.values())), gx=gx, gy=gy,
                  steps=np.asarray(steps))
    np.savez(os.path.join(outdir, "inputs.npz"), **inputs)
    t0 = time.perf_counter()
    spawn(parallel_cases.run, (outdir, ["gpt_multicard"], "cuda"),
          nprocs=n, init_method=f"tcp://localhost:{free_port()}",
          timeout=600)
    spawn_s = time.perf_counter() - t0
    ref, _ = parallel_cases.gpt_run(cfg, None, (gx, gy), steps, {"dp": 1},
                                    "cuda")
    ranks = [np.load(os.path.join(outdir, f"rank{r}.npz"))[
        "gpt_multicard/losses"].tolist() for r in range(n)]
    err = max(abs(a - b) / abs(b) for lr in ranks for a, b in zip(lr, ref))
    out = {"ran": True, "ranks": n, "mesh": shape, "config": cfg,
           "losses_world_1": ref, "losses_by_rank": ranks,
           "loss_max_rel_err": err, "rtol": 1e-4, "spawn_s": spawn_s}
    log("MULTICARD " + json.dumps(out))
    if not err <= 1e-4:
        raise AssertionError(f"multi-card losses disagree: {out}")
    torch.cuda.empty_cache()
    if n == 4:
        out["fleet"] = _multicard_fleet(n)
        out["a5b"] = _multicard_pipeline_hybrid(n)
        out["sentry"] = _multicard_sentry(n)
    return out


def _multicard_pipeline_hybrid(n, steps=3):
    """Four NCCL ranks, one world (``testing.pipeline_cases``): the
    pipelined GPT at the 1b widths on {pp: 4} (2 blocks a stage, f32,
    dropout 0, 8 microbatches, 3 AdamW steps) against the same model as
    one stage at world size 1 on this card, losses at rtol 1e-4, each
    rank holding one stage's block, its two Adam moments and, once the
    stages it built are dropped, no more device memory than the block,
    the replicated embedding and head and the batch; then comm_smoke's
    hybrid {dp: 2, mp: 2} rows on GPT-tiny through fleet and the static
    Executor (every 2-D weight cut over 'mp'; fp32, int8 auto and none)
    with comm_smoke's gates: int8 wire under 0.35x fp32's, measured ==
    predicted bytes on each axis and for the mp gathers, int8 losses
    within 2e-3 of fp32's, a rank's params at the per-shard price, the
    ranks' params equal; and the overlap flip of an mp-cut fc weight one
    rebuild named new_sharding."""
    import numpy as np
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.launch import free_port, spawn
    from paddle_tpu_torch.testing import pipeline_cases as pc
    from paddle_tpu_torch.testing import sharding_cases as sc
    import paddle_tpu_torch as pt
    cfg = MULTI_PIPE
    outdir = os.path.join(ROOT, "build", "chip_smoke_a5b")
    os.makedirs(outdir, exist_ok=True)
    r = np.random.RandomState(18)
    ids, labels = (r.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]))
                   .astype(np.int64) for _ in range(2))
    data = pc.p1b_inputs(cfg, ids, labels, steps)
    pt.enable_static()
    try:
        main, _ = sc.build_gpt_tiny()
        shapes = [tuple(p.shape) for p in main.parameters()]
    finally:
        pt.disable_static()
    r = np.random.RandomState(65)
    data.update({f"w{i}": (0.05 * r.standard_normal(sh)).astype(np.float32)
                 for i, sh in enumerate(shapes)})
    data.update(n_weights=len(shapes), n_constants=0, **sc.gpt_feeds())
    r = np.random.RandomState(1)
    xs = r.standard_normal((64, 8)).astype(np.float32)
    data.update(fc_x=xs, fc_y=(xs @ r.standard_normal((8, 1))).astype(
        np.float32))
    np.savez(os.path.join(outdir, "inputs.npz"), **data)
    t0 = time.perf_counter()
    spawn(pc.run, (outdir, ["pipeline_1b", "hybrid"], "cuda"), nprocs=n,
          init_method=f"tcp://localhost:{free_port()}", timeout=900)
    spawn_s = time.perf_counter() - t0
    res = [dict(np.load(os.path.join(outdir, f"rank{i}.npz")))
           for i in range(n)]
    prev_mesh = dist.get_mesh()
    dist.init_mesh({"pp": 1})
    try:
        one = pc.pipeline_gpt_train(cfg, torch.from_numpy(ids).cuda(),
                                    torch.from_numpy(labels).cuda(), steps)
    finally:
        dist.set_mesh(prev_mesh)
    torch.cuda.empty_cache()
    g = lambda k, i=0: res[i][k]  # noqa: E731
    pipe = {"config": cfg, "losses_world_1": one["losses"].tolist(),
            "losses_by_rank": [g("pipeline_1b/losses", i).tolist()
                               for i in range(n)],
            **{k: [int(g(f"pipeline_1b/{k}", i)) for i in range(n)]
               for k in ("stage_param_bytes", "block_param_bytes",
                         "block_slot_bytes", "replicated_param_bytes",
                         "allocated_after_drop")},
            "world_1_stage_param_bytes": int(one["stage_param_bytes"]),
            "spawn_s": spawn_s}
    log("MULTICARD_PIPELINE " + json.dumps(pipe))
    rel = max(abs(a - b) / abs(b) for lr in pipe["losses_by_rank"]
              for a, b in zip(lr, pipe["losses_world_1"]))
    batch_bytes = 2 * ids.size * 8
    slack = 16 << 20
    q = {"loss_rel_err": (rel, PIPE_RTOL)}
    for i in range(n):
        stage = pipe["stage_param_bytes"][i]
        q[f"rank{i}.block_minus_stage"] = (abs(
            pipe["block_param_bytes"][i] - stage), 0)
        q[f"rank{i}.slots_minus_two_moments"] = (abs(
            pipe["block_slot_bytes"][i] - 2 * stage), 0)
        q[f"rank{i}.stages_times_4_minus_world_1"] = (abs(
            n * stage - pipe["world_1_stage_param_bytes"]), 0)
        q[f"rank{i}.allocated_over_block_and_replicated"] = (
            pipe["allocated_after_drop"][i] - stage
            - pipe["replicated_param_bytes"][i] - batch_bytes, slack)
    _check("MULTICARD_PIPELINE_CHECK", q)
    h = lambda k, i=0: res[i]["hybrid/" + k]  # noqa: E731
    tags = ("fp32", "int8_auto", "int8_none")
    hyb = {t: {k: (h(f"{t}.{k}").tolist()
                   if np.asarray(h(f"{t}.{k}")).ndim else
                   float(h(f"{t}.{k}")))
               for k in ("losses", "wire_bytes_per_step",
                         "predicted_wire_bytes", "axis_dp_wire_bytes",
                         "predicted_axis_dp", "axis_mp_wire_bytes",
                         "predicted_axis_mp", "gather_wire_bytes_per_step",
                         "predicted_gather_wire_bytes",
                         "resident_param_bytes", "predicted_param_bytes",
                         "compiles")}
           for t in tags}
    hyb["matrix"] = {"compiles": [int(h("matrix.compiles0")),
                                  int(h("matrix.compiles1"))],
                     "cause": str(h("matrix.cause"))}
    log("MULTICARD_HYBRID " + json.dumps(hyb))
    fp32 = np.asarray(hyb["fp32"]["losses"])
    q = {"int8_wire_over_fp32": (hyb["int8_auto"]["wire_bytes_per_step"]
                                 / hyb["fp32"]["wire_bytes_per_step"],
                                 0.35 - 1e-9),
         "matrix_rebuilds_off": (abs(hyb["matrix"]["compiles"][1] - 2), 0),
         "matrix_cause_not_new_sharding": (
             int(hyb["matrix"]["cause"] != "new_sharding"), 0)}
    for t in tags:
        v = hyb[t]
        for a, b in (("wire_bytes_per_step", "predicted_wire_bytes"),
                     ("axis_dp_wire_bytes", "predicted_axis_dp"),
                     ("axis_mp_wire_bytes", "predicted_axis_mp"),
                     ("gather_wire_bytes_per_step",
                      "predicted_gather_wire_bytes"),
                     ("resident_param_bytes", "predicted_param_bytes")):
            q[f"{t}.{a}_off"] = (abs(v[a] - v[b]), 0)
        q[f"{t}.no_mp_traffic"] = (int(v["axis_mp_wire_bytes"] <= 0), 0)
        q[f"{t}.builds_off"] = (abs(v["compiles"] - 1), 0)
        if t != "fp32":
            q[f"{t}.loss_vs_fp32"] = (float(np.abs(
                np.asarray(v["losses"]) - fp32).max()), 2e-3)
        q[f"{t}.ranks_params_differ"] = (sum(
            int(not np.array_equal(res[i][f"hybrid/{t}.params"],
                                   h(f"{t}.params"))) for i in range(n)), 0)
    _check("MULTICARD_HYBRID_CHECK", q)
    return {"pipeline": pipe, "hybrid": hyb}


def _multicard_fleet(n, steps=4):
    """Four NCCL ranks train ``tools/comm_smoke.py``'s GPT-tiny (hidden
    32, vocab 128, 2 layers; seeded weights) through fleet and the
    static Executor: fp32, int8 under each overlap mode, ZeRO-3 int8,
    bf16 and no grad_comm (``testing.sharding_cases``'s ``comm`` case).
    comm_smoke's gates: int8 wire bytes under 0.35x fp32's, measured
    ``comm.wire_bytes`` == the cost model's prediction in every mode
    (per axis and the gather leg too), int8 losses within 2e-3 of fp32's
    after every step, the ranks' params bitwise equal; and the param
    bytes a rank holds between runs == ``analyze(sharding=)``'s per-shard
    price (a quarter of each ZeRO-3 param)."""
    import numpy as np
    from paddle_tpu_torch.distributed.launch import free_port, spawn
    from paddle_tpu_torch.testing import sharding_cases as sc
    import paddle_tpu_torch as pt
    outdir = os.path.join(ROOT, "build", "chip_smoke_fleet")
    os.makedirs(outdir, exist_ok=True)
    pt.enable_static()
    try:
        main, _ = sc.build_gpt_tiny()
        shapes = [tuple(p.shape) for p in main.parameters()]
    finally:
        pt.disable_static()
    r = np.random.RandomState(65)
    data = {f"w{i}": (0.05 * r.standard_normal(s)).astype(np.float32)
            for i, s in enumerate(shapes)}
    data.update(n_weights=len(shapes), n_constants=0, steps=steps,
                **sc.gpt_feeds())
    np.savez(os.path.join(outdir, "inputs.npz"), **data)
    t0 = time.perf_counter()
    spawn(sc.run, (outdir, ["comm"], "cuda"), nprocs=n,
          init_method=f"tcp://localhost:{free_port()}", timeout=600)
    res = [dict(np.load(os.path.join(outdir, f"rank{i}.npz")))
           for i in range(n)]
    g = lambda k: res[0]["comm/" + k]  # noqa: E731
    tags = ("fp32", "int8_auto", "int8_none", "int8_ring", "z3_auto",
            "z3_none", "bf16")
    fp32 = g("fp32.losses")
    out = {"ranks": n, "spawn_s": time.perf_counter() - t0,
           "wire_ratio_int8": float(g("int8_auto.wire_bytes_per_step")
                                    / g("fp32.wire_bytes_per_step")),
           **{t: {"losses": g(f"{t}.losses").tolist(),
                  "wire_bytes_per_step": float(g(f"{t}.wire_bytes_per_step")),
                  "predicted_wire_bytes": int(g(f"{t}.predicted_wire_bytes")),
                  "gather_wire_bytes_per_step":
                      float(g(f"{t}.gather_wire_bytes_per_step")),
                  "resident_param_bytes": int(g(f"{t}.resident_param_bytes")),
                  "predicted_param_bytes":
                      int(g(f"{t}.predicted_param_bytes"))}
              for t in tags}}
    log("MULTICARD_FLEET " + json.dumps(out))
    if not out["wire_ratio_int8"] < 0.35:
        raise AssertionError(f"int8 wire ratio {out['wire_ratio_int8']}")
    for t in tags:
        for a, b in (("wire_bytes_per_step", "predicted_wire_bytes"),
                     ("axis_dp_wire_bytes", "predicted_axis_dp"),
                     ("gather_wire_bytes_per_step",
                      "predicted_gather_wire_bytes")):
            if g(f"{t}.{a}") != g(f"{t}.{b}"):
                raise AssertionError(f"{t}: measured {a} {g(f'{t}.{a}')} "
                                     f"!= predicted {g(f'{t}.{b}')}")
        # between runs a rank holds what the cost model prices per shard
        # (ZeRO-3: its rows of each dp-sharded param)
        if g(f"{t}.resident_param_bytes") != g(f"{t}.predicted_param_bytes"):
            raise AssertionError(
                f"{t}: resident param bytes {g(f'{t}.resident_param_bytes')}"
                f" != per-shard price {g(f'{t}.predicted_param_bytes')}")
        if t != "fp32" and not np.abs(g(f"{t}.losses") - fp32).max() \
                <= 2e-3:
            raise AssertionError(f"{t} losses {g(f'{t}.losses')} vs fp32 "
                                 f"{fp32}")
        for rr in res[1:]:
            if not np.array_equal(rr[f"comm/{t}.params"], g(f"{t}.params")):
                raise AssertionError(f"{t}: the ranks' params differ")
    return out


# --------------------------------------------------------------- phase 19
def _gpt_trainer(torch, cfg, device, bf16, lr):
    """``bench_gpt``'s trainer (bench.py:345-363): ``build_gpt`` with
    per-block recompute, AdamW (wd 0.01) with global-norm clip 1.0, O2
    bf16 with f32 masters when ``bf16``, the tied head's loss."""
    from paddle_tpu_torch import amp, jit, optimizer
    from paddle_tpu_torch.testing.models import build_gpt, gpt_pretrain_loss
    model = build_gpt(cfg["vocab"], cfg["hidden"], cfg["layers"],
                      cfg["heads"], cfg["ffn"], cfg["seq"], cfg["dropout"],
                      device=device)
    opt = optimizer.AdamW(learning_rate=lr, parameters=model.parameters(),
                          weight_decay=0.01,
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0),
                          multi_precision=bf16)
    if bf16:
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    return model, jit.TrainStep(model, gpt_pretrain_loss(model,
                                                         cfg["vocab"]),
                                opt, n_inputs=1, donate=True)


def phase_small_gpt_recompute_parity(steps=3):
    """``build_gpt`` at bench_gpt's CPU config (f32, dropout 0, per-block
    recompute) trained 3 steps on the card and on the CPU from the same
    weights at phase 7's lr (1e-4) and tolerances: losses rtol 1e-5,
    parameters within BERT_PARAM_ATOL, the key projections' biases
    within lr a step either way; the flash forward launched twice per
    layer and step on the card (once recomputed), each backward once."""
    import torch
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.ops.cuda import support
    cfg = GPT_BENCH_CPU
    seed(7)
    cpu, cpu_step = _gpt_trainer(torch, cfg, "cpu", False, 1e-4)
    gpu, gpu_step = _gpt_trainer(torch, cfg, "cuda", False, 1e-4)
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()})
    losses = {}
    for dev, step in (("cpu", cpu_step), ("cuda", gpu_step)):
        x, y = _bench_batch(torch, cfg, dev)
        support.reset_launch_counts()
        losses[dev] = [float(step(x, y)) for _ in range(steps)]
        counts = dict(support.launch_counts)
    want = {k: cfg["layers"] * steps * n
            for k, n in zip(FLASH_KERNELS, (2, 1, 1))}
    if any(counts.get(k, 0) != n for k, n in want.items()):
        raise AssertionError(f"small GPT launches {counts}, want {want}")
    gp = dict(gpu.named_parameters())
    diffs = {n: (gp[n].detach().cpu() - p.detach()).abs().max().item()
             for n, p in cpu.named_parameters()}
    k_bias = {n: d for n, d in diffs.items() if n.endswith(".k.bias")}
    rest = {n: d for n, d in diffs.items() if n not in k_bias}
    worst = max(rest, key=rest.get)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    out = {"config": cfg, "recompute": "per block", "losses_cpu":
           losses["cpu"], "losses_cuda": losses["cuda"],
           "loss_max_rel_err": loss_err, "param_max_abs_err": rest[worst],
           "param_worst": worst, "k_bias_max_abs_err": max(k_bias.values()),
           "loss_rtol": 1e-5, "param_atol": BERT_PARAM_ATOL,
           "k_bias_atol": 2e-4 * steps, "launches": counts}
    log("GPT1_PARITY " + json.dumps(out))
    if (not loss_err <= 1e-5 or not rest[worst] <= BERT_PARAM_ATOL
            or not max(k_bias.values()) <= 2e-4 * steps):
        raise AssertionError(f"small GPT card vs CPU: {out}")


# --------------------------------------------------------------- phase 20
def _own_rel_err(got, ref):
    """max |got - ref| over ref's own max |ref| (not floored at 1)."""
    got, ref = got.float(), ref.float()
    if not bool(got.isfinite().all()):
        raise AssertionError("non-finite gradient or loss")
    return ((got - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


def phase_gpt_recompute_masks():
    """The small GPT at dropout 0.1, O2 bf16, on the card: one forward
    and backward with per-block recompute and one without, from the same
    seed and weights.  The recomputed forward must draw the first one's
    masks (the flash kernels' seeds, ``F.dropout``'s device generator).
    The loss comes from the first forward either way; the recomputed
    one feeds only the gradients, so every gradient must agree within
    TOL["bfloat16"] of its own largest entry and be equal bit for bit
    (the same kernels on the same inputs and masks; a wrong mask can
    move a gradient by less than the tolerance).  It prints the flash
    launches of each (the forward twice a layer under recompute)."""
    import torch
    from paddle_tpu_torch import amp, seed
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import build_gpt, gpt_pretrain_loss
    cfg = dict(GPT_BENCH_CPU, dropout=0.1)
    seed(11)
    model = build_gpt(cfg["vocab"], cfg["hidden"], cfg["layers"],
                      cfg["heads"], cfg["ffn"], cfg["seq"], cfg["dropout"],
                      device="cuda")
    amp.decorate(model, level="O2", dtype="bfloat16")
    params = list(model.parameters())
    loss_fn = gpt_pretrain_loss(model, cfg["vocab"])
    x, y = _bench_batch(torch, cfg, "cuda")
    runs, launches = {}, {}
    for rc in (True, False):
        model.recompute = rc
        seed(5)
        support.reset_launch_counts()
        loss = loss_fn(model(x), y)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        launches[rc] = {k: support.launch_counts.get(k, 0)
                        for k in FLASH_KERNELS}
        runs[rc] = (loss.detach(), grads)
    (l_rc, g_rc), (l_off, g_off) = runs[True], runs[False]
    names = [n for n, _ in model.named_parameters()]
    errs = {n: _own_rel_err(a, b) for n, a, b in zip(names, g_rc, g_off)}
    worst = max(errs, key=errs.get)
    out = {"config": cfg, "dtype": "bfloat16 O2",
           "loss_recompute": l_rc.item(), "loss_plain": l_off.item(),
           "loss_rel_err": _own_rel_err(l_rc, l_off),
           "grad_max_rel_err": errs[worst], "grad_worst": worst,
           "tol": TOL["bfloat16"],
           "loss_bitwise": bool(torch.equal(l_rc, l_off)),
           "grads_bitwise": all(torch.equal(a, b)
                                for a, b in zip(g_rc, g_off)),
           "launches_recompute": launches[True],
           "launches_plain": launches[False]}
    log("GPT_RECOMPUTE_MASKS " + json.dumps(out))
    want_rc = {k: cfg["layers"] * n for k, n in zip(FLASH_KERNELS,
                                                     (2, 1, 1))}
    want_off = {k: cfg["layers"] for k in FLASH_KERNELS}
    if launches[True] != want_rc or launches[False] != want_off:
        raise AssertionError(f"recompute launches {launches}, want "
                             f"{want_rc} and {want_off}")
    if not (out["loss_rel_err"] <= TOL["bfloat16"]
            and errs[worst] <= TOL["bfloat16"]
            and out["loss_bitwise"] and out["grads_bitwise"]):
        raise AssertionError(f"recompute changed the step: {out}")


# --------------------------------------------------------------- phase 21
def _fwd_bwd_peak(torch, step, batch):
    """Peak bytes one forward and backward of ``step``'s model and loss
    allocate above what was allocated before it (the activations and
    the gradients, without the optimizer's update)."""
    x, y = batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss = step.loss_fn(step.model(x), y)
    grads = torch.autograd.grad(loss, step._params)
    torch.cuda.synchronize()
    del loss, grads
    return torch.cuda.max_memory_allocated() - base


def phase_gpt760_training(warmup=2, steps=8, plain_warmup=2, plain_steps=3):
    """``bench_gpt``'s chip config: ``build_gpt`` at the ``760m`` preset
    (bench.py:317), batch 16, seq 1024, dropout 0.1, O2 bf16 with f32
    masters, AdamW(2e-4, wd 0.01), global-norm clip 1.0, per-block
    recompute: 2 warm-up and 8 timed steps, every loss finite, the first
    near ln(vocab), and per step 48 flash forwards (24 + 24 recomputed)
    and 24 of each backward.  Then 2 + 3 steps with recompute off: 24
    of each a step, and a higher peak memory than with it, over the
    steps and over one forward and backward alone (no update)."""
    import numpy as np
    import torch
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.testing.models import gpt_flops_per_step
    cfg = GPT_760M_TRAIN
    t0 = time.perf_counter()
    seed(2024)
    model, step = _gpt_trainer(torch, cfg, "cuda", True, 2e-4)
    batch = _bench_batch(torch, cfg, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, counts = _train_steps(torch, step, batch,
                                                   warmup + steps)
    peak_rc = torch.cuda.max_memory_allocated()
    model.recompute = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plain_losses, plain_ms, plain_counts = _train_steps(
        torch, step, batch, plain_warmup + plain_steps)
    peak_plain = torch.cuda.max_memory_allocated()
    fwd_bwd_plain = _fwd_bwd_peak(torch, step, batch)
    model.recompute = True
    fwd_bwd_rc = _fwd_bwd_peak(torch, step, batch)
    timed = step_ms[warmup:]
    mean_ms = sum(timed) / len(timed)
    tokens = cfg["batch"] * cfg["seq"]
    flops = gpt_flops_per_step(cfg["vocab"], cfg["hidden"], cfg["layers"],
                               cfg["seq"], cfg["batch"], cfg["ffn"])
    plain_timed = plain_ms[plain_warmup:]
    out = {"config": cfg, "dtype": "bfloat16 O2, f32 master weights",
           "recompute": "per block",
           "params": sum(p.numel() for p in model.parameters()),
           "setup_s": setup_s, "warmup_steps": warmup, "timed_steps": steps,
           "losses": losses, "step_ms": timed,
           "step_ms_p50": float(np.median(timed)), "step_ms_mean": mean_ms,
           "first_steps_ms": step_ms[:warmup],
           "tokens_per_s": tokens / (mean_ms / 1e3),
           "model_flops_per_step": flops,
           "mfu": flops / (mean_ms / 1e3) / PEAK_OPS["bfloat16"],
           "peak_bound_ms": flops / PEAK_OPS["bfloat16"] * 1e3,
           "max_memory_allocated": peak_rc,
           "fwd_bwd_peak_above_base": fwd_bwd_rc, "launches": counts,
           "no_recompute": {
               "losses": plain_losses, "step_ms": plain_timed,
               "step_ms_mean": sum(plain_timed) / len(plain_timed),
               "first_steps_ms": plain_ms[:plain_warmup],
               "max_memory_allocated": peak_plain,
               "fwd_bwd_peak_above_base": fwd_bwd_plain,
               "launches": plain_counts}}
    log("GPT760_TRAIN " + json.dumps(out))
    every = losses + plain_losses
    if not all(math.isfinite(v) for v in every):
        raise AssertionError(f"non-finite loss: {every}")
    if abs(losses[0] - math.log(cfg["vocab"])) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln({cfg['vocab']}) = "
                             f"{math.log(cfg['vocab'])}")
    for got, per_step, n in ((counts, GPT760_PER_STEP, warmup + steps),
                             (plain_counts, GPT760_PLAIN_PER_STEP,
                              plain_warmup + plain_steps)):
        want = {k: v * n for k, v in per_step.items()}
        if any(got.get(k, 0) != v for k, v in want.items()):
            raise AssertionError(f"760m launches {got}, want {want}")
    if not (peak_rc < peak_plain and fwd_bwd_rc < fwd_bwd_plain):
        raise AssertionError(
            f"peak memory with recompute {peak_rc} (forward and backward "
            f"{fwd_bwd_rc}) is not below the peak without it {peak_plain} "
            f"({fwd_bwd_plain})")
    return {k: counts[k] for k in FLASH_KERNELS}, step, batch, timed


# --------------------------------------------------------------- phase 22
def phase_gpt760_anatomy(step, batch, timed_ms, steps=2):
    """The 760m step's anatomy, its flash launches by kernel name: the
    wgmma forward 48 a step, each backward 24."""
    x, y = batch
    launches = _step_anatomy(
        "GPT760_ANATOMY", lambda: step(x, y), steps, lambda n: (
            "flash_fwd" if "flash_fwd_" in n else
            "flash_bwd" if "flash_bwd_" in n else
            "gemm" if _is_gemm(n) else "other"), wgmma_flash=True,
        timed_ms=timed_ms)
    flash = {k: v for k, v in launches.items() if k.startswith("flash_")}
    want = {"flash_fwd_wgmma_kernel": 48, "flash_bwd_dq_wgmma_kernel": 24,
            "flash_bwd_dkv_wgmma_kernel": 24}
    if flash != want:
        raise AssertionError(f"760m anatomy flash launches a step {flash}, "
                             f"want {want}")


# --------------------------------------------------------------- phase 23
LENET_BATCH = 64
LENET_RTOL = 1e-4


def _lenet_batch(np):
    rs = np.random.RandomState(0)
    return (rs.randn(LENET_BATCH, 1, 28, 28).astype("float32"),
            rs.randint(0, 10, (LENET_BATCH,)).astype("int64"))


def _lenet_on(paddle, where, weights):
    """A LeNet made under ``set_device(where)`` holding ``weights``."""
    from paddle_tpu_torch.vision.models import LeNet
    return _model_on(paddle, where, weights, LeNet)


def _model_on(paddle, where, weights, make):
    """``make()`` under ``set_device(where)``, holding ``weights`` (its
    state dict as numpy arrays)."""
    from paddle_tpu_torch.core import placement
    from paddle_tpu_torch.framework_io import state_dict_from_paddle_tpu
    prev = placement.default()
    paddle.set_device(where)
    try:
        model = make()
        model.set_state_dict(state_dict_from_paddle_tpu(
            weights, device=where.replace("gpu", "cuda"), model=model))
    finally:
        placement.set_default(prev)
    return model


def _lenet_steps(paddle, model, opt, x, y, steps):
    import paddle_tpu_torch.nn.functional as F
    losses = []
    for _ in range(steps):
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        if not losses:
            grads = {n: p.grad for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, grads


def phase_lenet_card_vs_cpu(steps=3):
    """LeNet on the card against the CPU from one set of seeded numpy
    weights, 3 eager steps of each optimizer."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import LeNet
    paddle.set_device("cpu")
    shapes = {k: tuple(v.shape) for k, v in LeNet().state_dict().items()}
    paddle.core.placement.set_default(None)
    rs = np.random.RandomState(23)
    # a conv kernel is [out, in, k, k], a linear weight [in, out]: scale
    # by the fan-in; biases at 0.1
    fan_in = {4: lambda s: s[1] * s[2] * s[3], 2: lambda s: s[0],
              1: lambda s: 100}
    weights = {k: (rs.randn(*s) / math.sqrt(fan_in[len(s)](s))).astype(
        "float32") for k, s in shapes.items()}
    xv, yv = _lenet_batch(np)
    makers = {
        "adam": lambda ps: paddle.optimizer.Adam(1e-3, parameters=ps),
        "sgd": lambda ps: paddle.optimizer.SGD(0.01, parameters=ps),
        "momentum_l2": lambda ps: paddle.optimizer.Momentum(
            0.01, 0.9, parameters=ps,
            weight_decay=paddle.regularizer.L2Decay(1e-4))}
    out = {}
    for name, make in makers.items():
        runs = {}
        for where in ("cpu", "gpu"):
            model = _lenet_on(paddle, where, weights)
            dev = "cpu" if where == "cpu" else "cuda"
            x = paddle.to_tensor(xv, place=dev)
            y = paddle.to_tensor(yv, place=dev)
            losses, grads = _lenet_steps(paddle, model, make(
                model.parameters()), x, y, steps)
            runs[where] = (losses, model, grads)
        (lc, mc, _), (lg, mg, gg) = runs["cpu"], runs["gpu"]
        rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
        pdiff = max(float((p.detach().cpu() - q.detach()).abs().max())
                    for p, q in zip(mg.parameters(), mc.parameters()))
        out[name] = {"losses_cpu": lc, "losses_card": lg,
                     "loss_max_rel_err": rel, "param_max_abs_diff": pdiff}
        if not rel <= LENET_RTOL:
            raise AssertionError(f"{name}: card losses {lg} vs CPU {lc}, "
                                 f"rel {rel} > {LENET_RTOL}")
        for n, p in mg.named_parameters():
            if not (isinstance(p, paddle.Parameter)
                    and p.device.type == "cuda"):
                raise AssertionError(f"{n}: {type(p)} on {p.device}")
            g = gg[n]
            if not (isinstance(g, paddle.Tensor) and g.device.type == "cuda"):
                raise AssertionError(f"{n}.grad: {type(g)} on "
                                     f"{getattr(g, 'device', None)}")
    torch.cuda.synchronize()
    log("LENET_PARITY " + json.dumps({"batch": LENET_BATCH, "steps": steps,
                                      "rtol": LENET_RTOL,
                                      "optimizers": out}))


# --------------------------------------------------------------- phase 24
def _count_paddle_ops(fn):
    """(paddle ops, torch ops) one call of ``fn`` dispatches: calls of
    ``core.dispatch.apply`` and of the paddle Tensor's operators, counted
    with ``sys.setprofile``; aten ops from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    import paddle_tpu_torch.core.dispatch as D
    from paddle_tpu_torch.core.tensor import Tensor
    codes = {D.apply.__code__}
    for k, v in vars(Tensor).items():
        if k.startswith("__") and callable(v) and hasattr(v, "__code__") \
                and v.__code__.co_filename.endswith("ops/__init__.py"):
            codes.add(v.__code__)
    seen = [0]

    def prof(frame, event, arg):
        if event == "call" and frame.f_code in codes:
            seen[0] += 1
    sys.setprofile(prof)
    try:
        fn()
    finally:
        sys.setprofile(None)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        fn()
    aten = sum(e.count for e in p.key_averages()
               if e.key.startswith("aten::"))
    return seen[0], aten


def phase_lenet_bench(warmup=3, steps=30):
    """bench_lenet_dygraph's training half at its own size on the card."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.vision.models import LeNet
    paddle.seed(0)
    model = LeNet()
    opt = optimizer.Adam(learning_rate=1e-3, parameters=model.parameters())
    xv, yv = _lenet_batch(np)
    x, y = paddle.to_tensor(xv), paddle.to_tensor(yv)
    enqueue_ms = []

    def one_step():
        t = time.perf_counter()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        enqueue_ms.append((time.perf_counter() - t) * 1e3)
        return float(loss)

    support.reset_launch_counts()
    for _ in range(warmup):
        one_step()
    step_ms, losses = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(one_step())
        step_ms.append((time.perf_counter() - t) * 1e3)
    launched = dict(support.launch_counts)
    timed_enqueue = enqueue_ms[warmup:]
    paddle_ops, aten_ops = _count_paddle_ops(one_step)
    mean = sum(step_ms) / len(step_ms)
    out = {"config": {"batch": LENET_BATCH, "input": [1, 28, 28],
                      "optimizer": "Adam(1e-3)", "warmup": warmup,
                      "timed_steps": steps},
           "step_ms_p50": float(np.median(step_ms)), "step_ms_mean": mean,
           "steps_per_s": 1e3 / mean, "final_loss": losses[-1],
           "losses_first_last": [losses[0], losses[-1]],
           "host_enqueue_ms_p50": float(np.median(timed_enqueue)),
           "host_enqueue_share": float(np.median(timed_enqueue))
           / float(np.median(step_ms)),
           "paddle_ops_per_step": paddle_ops,
           "torch_ops_per_step": aten_ops,
           "hand_kernel_launches": launched}
    log("LENET_BENCH " + json.dumps(out))
    if not all(math.isfinite(v) for v in losses) or not (
            losses[-1] < losses[0]):
        raise AssertionError(f"losses {losses}")
    if any(launched.values()):
        raise AssertionError(f"the eager LeNet step launched hand kernels "
                             f"{launched}; this path has none")
    _step_anatomy("LENET_ANATOMY", one_step, 5, lambda n: (
        "conv" if "conv" in n or "implicit" in n or "winograd" in n
        or "fft" in n else
        "pool" if "pool" in n else
        "gemm" if _is_gemm(n) else
        "optimizer" if "foreach" in n or "multi_tensor" in n else
        "softmax/ce" if "softmax" in n or "nll" in n or "log_" in n else
        "other"), timed_ms=step_ms)
    return out


# --------------------------------------------------------------- phase 25
def phase_linear_regression(steps=300):
    """The verify recipe's eager flow on the card."""
    import numpy as np
    import paddle_tpu_torch as paddle
    rs = np.random.RandomState(1)
    xv = rs.rand(256, 3).astype("float32")
    true_w = np.array([[2.0], [-3.4], [1.7]], "float32")
    x = paddle.to_tensor(xv)
    y = paddle.to_tensor(xv @ true_w + 4.2)
    w = paddle.to_tensor(np.zeros((3, 1), "float32"), stop_gradient=False)
    b = paddle.to_tensor(np.zeros((1,), "float32"), stop_gradient=False)
    opt = paddle.optimizer.SGD(learning_rate=0.5, parameters=[w, b])
    for _ in range(steps):
        loss = paddle.mean((paddle.matmul(x, w) + b - y) ** 2)
        loss.backward()
        opt.step()
        opt.clear_grad()
    got_w, got_b = w.numpy()[:, 0], float(b.numpy()[0])
    err = max(float(np.abs(got_w - true_w[:, 0]).max()), abs(got_b - 4.2))
    out = {"steps": steps, "w": got_w.tolist(), "b": got_b,
           "final_loss": float(loss), "max_abs_err": err,
           "device": str(w.device)}
    log("LINREG " + json.dumps(out))
    if not (err <= 1e-3 and w.device.type == "cuda"):
        raise AssertionError(f"linear regression: {out}")


# --------------------------------------------------------------- phase 26
def phase_save_load():
    """A Layer's and an optimizer's state saved and loaded on the card."""
    import tempfile
    import numpy as np
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.vision.models import LeNet
    paddle.set_device("gpu")
    try:
        model = LeNet()
        opt = paddle.optimizer.Adam(1e-3, parameters=model.parameters())
        xv, yv = _lenet_batch(np)
        F.cross_entropy(model(paddle.to_tensor(xv)),
                        paddle.to_tensor(yv)).backward()
        opt.step()
        with tempfile.TemporaryDirectory() as d:
            paddle.save(model.state_dict(), os.path.join(d, "m.pdparams"))
            paddle.save(opt.state_dict(), os.path.join(d, "m.pdopt"))
            sd = paddle.load(os.path.join(d, "m.pdparams"))
            osd = paddle.load(os.path.join(d, "m.pdopt"))
        model2 = LeNet()
        missing, unexpected = model2.set_state_dict(sd)
        opt2 = paddle.optimizer.Adam(1e-3, parameters=model2.parameters())
        opt2.set_state_dict(osd)
        loaded = list(sd.values()) + [t for s in osd["slots"].values()
                                      for t in s.values()]
        on_card = all(t.device.type == "cuda" for t in loaded)
        same = all(bool((a == b).all()) for a, b in zip(
            model.state_dict().values(), model2.state_dict().values()))
        a, b = opt.state_dict(), opt2.state_dict()
        same_opt = a["step"] == b["step"] and all(
            bool((a["slots"][i][k] == b["slots"][i][k]).all())
            for i in a["slots"] for k in a["slots"][i])
    finally:
        paddle.core.placement.set_default(None)
    out = {"tensors": len(loaded), "all_on_card": on_card,
           "layer_equal": same, "optimizer_equal": same_opt,
           "missing": missing, "unexpected": unexpected}
    log("SAVE_LOAD " + json.dumps(out))
    if not (on_card and same and same_opt and not missing
            and not unexpected):
        raise AssertionError(f"save/load: {out}")


# --------------------------------------------------------------- phase 27
# resnet18 card vs CPU: batch 8 of 3 x 32 x 32, 3 Momentum(lr, 0.9)
# steps through TrainStep.  The lr is 1e-3 because the comparison only
# holds where rounding does not steer the trajectory: at 32 px layer4's
# batch norm sees 8 values a channel, and at lr 0.1 or 0.01 the CPU run
# against itself, with its input moved by one ulp, already parts by
# more than the tolerance (the phase prints that spread beside the
# card's difference).  Losses as relative errors, running statistics and
# eval outputs as max |a - b| / max |b| a tensor.
RESNET_SMALL = dict(batch=8, hw=32, num_classes=10, lr=1e-3, momentum=0.9)
RESNET_RTOL = 1e-4
# the O2 (bf16 weights, statistics and input) eval forward against the
# f32 one: max |a - b| / max |f32 logits|; bf16 keeps 8 bits, and 20
# convolutions and batch norms round in turn
RESNET_BF16_TOL = 5e-2
# bench.py:540-571, bench_resnet50's chip config, and bench.py:42's
# forward FLOPs an image (a training step counts 3 forwards)
RESNET50_CHIP = dict(batch=128, hw=224, data_format="NCHW",
                     dtype="bfloat16", lr=0.1, momentum=0.9)
RESNET50_FWD_FLOPS = 4.089e9


def _one_ulp(np, x):
    """``x`` with every element moved by one ulp, up or down at random."""
    up = np.random.RandomState(5).rand(*x.shape) > 0.5
    return np.nextafter(x, np.where(up, np.float32(np.inf),
                                    np.float32(-np.inf))).astype(np.float32)


def _bn_buffers(model):
    return {k: v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()
            if k.endswith(("._mean", "._variance"))}


def _scale_err(a, b):
    return float(abs(a - b).max() / max(abs(b).max(), 1e-30))


def phase_resnet_card_vs_cpu(steps=3):
    """resnet18 trained 3 TrainStep Momentum steps on the card and on the
    CPU from one set of seeded weights; then eval outputs and the O2
    bf16 forward against the f32 one."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.vision.models import resnet18
    cfg = RESNET_SMALL
    if (torch.backends.cudnn.allow_tf32
            or torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("TF32 is on; this phase compares f32")
    paddle.set_device("cpu")
    paddle.seed(27)
    weights = {k: v.numpy() for k, v in resnet18(
        num_classes=cfg["num_classes"]).state_dict().items()}
    paddle.core.placement.set_default(None)
    rs = np.random.RandomState(27)
    xv = rs.standard_normal((cfg["batch"], 3, cfg["hw"], cfg["hw"])).astype(
        np.float32)
    yv = rs.randint(0, cfg["num_classes"], (cfg["batch"],)).astype(np.int64)
    make = lambda: resnet18(num_classes=cfg["num_classes"])  # noqa: E731
    runs = {}
    for label, where, x_np in (("cpu", "cpu", xv), ("card", "gpu", xv),
                               ("cpu_one_ulp", "cpu", _one_ulp(np, xv))):
        model = _model_on(paddle, where, weights, make)
        dev = "cpu" if where == "cpu" else "cuda"
        x = paddle.to_tensor(x_np, place=dev)
        y = paddle.to_tensor(yv, place=dev)
        opt = paddle.optimizer.Momentum(cfg["lr"], cfg["momentum"],
                                        parameters=model.parameters())
        step = paddle.jit.TrainStep(model, lambda out, lab: F.cross_entropy(
            out, lab), opt)
        losses = [float(step(x, y)) for _ in range(steps)]
        model.eval()
        with paddle.no_grad():
            logits = model(x).detach().float().cpu().numpy()
        runs[label] = (losses, _bn_buffers(model), logits, model, x)
    (lc, bc, oc, _, _), (lg, bg, og, card, xg) = runs["cpu"], runs["card"]
    lu, bu = runs["cpu_one_ulp"][:2]
    init = {k: weights[k] for k in bc}
    out = {"config": cfg, "steps": steps, "rtol": RESNET_RTOL,
           "losses_cpu": lc, "losses_card": lg,
           "loss_max_rel_err": max(abs(a - b) / abs(a)
                                   for a, b in zip(lc, lg)),
           "stats_max_err": max(_scale_err(bg[k], bc[k]) for k in bc),
           "eval_max_err": _scale_err(og, oc),
           "cpu_one_ulp_loss_max_rel_err": max(abs(a - b) / abs(a)
                                               for a, b in zip(lc, lu)),
           "cpu_one_ulp_stats_max_err": max(_scale_err(bu[k], bc[k])
                                            for k in bc),
           "bn_layers": len(bc) // 2}
    moved = [k for k in bg if np.isfinite(bg[k]).all()
             and not np.array_equal(bg[k], init[k])]
    out["bn_buffers_moved_finite"] = len(moved)
    # the card model in eval, its f32 logits against O2's bf16 ones
    amp.decorate(card, level="O2", dtype="bfloat16")
    if card.bn1._mean.dtype != torch.bfloat16:
        raise AssertionError("O2 left batch norm's statistics in "
                             f"{card.bn1._mean.dtype}")
    with paddle.no_grad():
        bf16 = card(xg.astype("bfloat16")).float().cpu().numpy()
    out["o2_vs_f32_err"] = _scale_err(bf16, og)
    out["o2_tol"] = RESNET_BF16_TOL
    torch.cuda.synchronize()
    log("RESNET_PARITY " + json.dumps(out))
    if out["bn_layers"] != 20 or len(moved) != 40:
        raise AssertionError(f"{out['bn_layers']} batch norms, {len(moved)} "
                             "of their buffers moved and finite; want 20, 40")
    for key in ("loss_max_rel_err", "stats_max_err", "eval_max_err"):
        if not out[key] <= RESNET_RTOL:
            raise AssertionError(f"resnet18 card vs CPU: {key} {out[key]} "
                                 f"> {RESNET_RTOL}")
    if not out["o2_vs_f32_err"] <= RESNET_BF16_TOL:
        raise AssertionError(f"O2 forward vs f32: {out['o2_vs_f32_err']}")


# --------------------------------------------------------------- phase 28
def _resnet50_trainer(data_format):
    """bench_resnet50's chip config: (model, TrainStep, (x, y))."""
    import numpy as np
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.vision.models import resnet50
    cfg = RESNET50_CHIP
    paddle.seed(2024)
    model = resnet50(data_format=data_format)
    opt = optimizer.Momentum(learning_rate=cfg["lr"],
                             momentum=cfg["momentum"],
                             parameters=model.parameters(),
                             multi_precision=True)
    model, opt = amp.decorate(model, opt, level="O2", dtype=cfg["dtype"])
    step = TrainStep(model, lambda out, labels: F.cross_entropy(out, labels),
                     opt, n_inputs=1, donate=True)
    rng = np.random.RandomState(0)
    b, hw = cfg["batch"], cfg["hw"]
    shape = (b, hw, hw, 3) if data_format == "NHWC" else (b, 3, hw, hw)
    x = paddle.to_tensor(rng.standard_normal(shape).astype(
        np.float32)).astype(cfg["dtype"])
    y = paddle.to_tensor(rng.randint(0, 1000, (b,), dtype=np.int64))
    return model, step, (x, y)


def _images_per_s(torch, step, batch, warmup, steps):
    losses, step_ms, counts = _train_steps(torch, step, batch,
                                           warmup + steps)
    timed = step_ms[warmup:]
    return (RESNET50_CHIP["batch"] / (sum(timed) / len(timed) / 1e3),
            losses, step_ms, counts)


def phase_resnet50_training(warmup=2, steps=10, side_steps=4):
    """bench_resnet50's chip config uncut (224 px, batch 128, bf16 O2,
    NCHW): 2 warm-up and 10 timed steps; then the same steps with
    cuDNN's autotuner on, and the NHWC model, a few steps each."""
    import numpy as np
    import torch
    cfg = RESNET50_CHIP
    bench_default = torch.backends.cudnn.benchmark
    t0 = time.perf_counter()
    model, step, batch = _resnet50_trainer(cfg["data_format"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ips, losses, step_ms, counts = _images_per_s(torch, step, batch,
                                                 warmup, steps)
    peak = torch.cuda.max_memory_allocated()
    timed = step_ms[warmup:]
    mean_ms = sum(timed) / len(timed)
    flops = 3 * RESNET50_FWD_FLOPS * cfg["batch"]
    out = {"config": cfg, "params": sum(p.numel()
                                        for p in model.parameters()),
           "dtype": "bfloat16 O2, f32 master weights",
           "setup_s": setup_s, "warmup_steps": warmup, "timed_steps": steps,
           "losses": losses, "first_loss": losses[0],
           "last_loss": losses[-1], "step_ms": timed,
           "step_ms_p50": float(np.median(timed)), "step_ms_mean": mean_ms,
           "first_steps_ms": step_ms[:warmup], "images_per_s": ips,
           "model_flops_per_step": flops,
           "mfu": flops / (mean_ms / 1e3) / PEAK_OPS["bfloat16"],
           "peak_bound_ms": flops / PEAK_OPS["bfloat16"] * 1e3,
           "max_memory_allocated": peak,
           "cudnn_benchmark": bench_default,
           "hand_kernel_launches": counts}
    # cuDNN's autotuner, which the port leaves at torch's default
    torch.backends.cudnn.benchmark = True
    try:
        tuned = _images_per_s(torch, step, batch, 2, side_steps)
    finally:
        torch.backends.cudnn.benchmark = bench_default
    out["cudnn_benchmark_true"] = {"images_per_s": tuned[0],
                                   "step_ms": tuned[2]}
    nhwc_model, nhwc_step, nhwc_batch = _resnet50_trainer("NHWC")
    nhwc = _images_per_s(torch, nhwc_step, nhwc_batch, 2, side_steps)
    out["nhwc"] = {"images_per_s": nhwc[0], "losses": nhwc[1],
                   "step_ms": nhwc[2], "hand_kernel_launches": nhwc[3]}
    del nhwc_model, nhwc_step, nhwc_batch
    out["nvidia_smi"] = nvidia_smi()
    log("RESNET50_TRAIN " + json.dumps(out))
    if not (math.isfinite(losses[0])
            and abs(losses[0] - math.log(1000)) < 3.0):
        # the fc's XavierNormal init gives logits of std ~1-2, which put
        # the first cross entropy a little above ln(1000)
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln(1000) = {math.log(1000)}")
    for what, c in (("NCHW", counts), ("cudnn.benchmark", tuned[3]),
                    ("NHWC", nhwc[3])):
        if any(c.values()):
            raise AssertionError(f"the {what} ResNet-50 step launched hand "
                                 f"kernels {c}; this path has none")
    return model, step, batch, timed


# --------------------------------------------------------------- phase 29
def _resnet_group(name, bn_names):
    """A ResNet step kernel's group, by its lower-case name; batch norm's
    kernels are collected in ``bn_names``."""
    conv = ("fprop", "dgrad", "wgrad", "conv", "implicit", "winograd",
            "fft", "nchwtonhwc", "nhwctonchw")
    if "batch_norm" in name or "batchnorm" in name or "bn_" in name:
        bn_names.add(name[:120])
        return "batch_norm"
    if any(w in name for w in conv):
        return ("conv_backward" if "dgrad" in name or "wgrad" in name
                or "bwd" in name or "backward" in name else "conv_forward")
    if _is_gemm(name):
        return "gemm"
    if "multi_tensor" in name or "foreach" in name:
        return "momentum_update"
    if "copy" in name or "memcpy" in name or "memset" in name:
        return "copies"
    if "elementwise" in name or "vectorized" in name or "unrolled" in name:
        return "elementwise_and_casts"
    if "pool" in name:
        return "pooling"
    if "softmax" in name or "nll" in name or "cross" in name:
        return "loss"
    if "reduce" in name:
        return "reductions"
    return "other"


def _bn_routes(torch, n=128, c=256, hw=56):
    """One training batch norm, forward and backward, at ResNet-50's
    largest (layer1's output, bf16): the port's route
    (``aten.native_batch_norm`` without running buffers, NCHW and
    channels-last) against ``torch.batch_norm`` with running buffers,
    which hands the call to cuDNN where cuDNN takes it (with bf16 and
    with f32 weight and bias): CUDA-event ms a call, and the kernels
    each ran by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    x0 = torch.randn((n, c, hw, hw), device="cuda", generator=gen,
                     dtype=torch.bfloat16)
    g = torch.randn(x0.shape, device="cuda", generator=gen,
                    dtype=torch.bfloat16)

    def case(fmt, wdt, fn):
        x = (x0.contiguous(memory_format=torch.channels_last)
             if fmt == "channels_last" else x0.clone()).requires_grad_()
        w = torch.ones(c, device="cuda", dtype=wdt, requires_grad=True)
        b = torch.zeros(c, device="cuda", dtype=wdt, requires_grad=True)
        rm = torch.zeros(c, device="cuda", dtype=wdt)
        rv = torch.ones(c, device="cuda", dtype=wdt)

        def call(i):
            out = fn(x, w, b, rm, rv)
            torch.autograd.grad(out, (x, w, b), g)
        ms = cuda_ms(call, 10)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call(0)
            torch.cuda.synchronize()
        names = sorted({e.key[:90] for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA})
        return {"ms": ms, "kernels": names}

    native = lambda x, w, b, rm, rv: torch.ops.aten.native_batch_norm(  # noqa
        x, w, b, None, None, True, 0.0, 1e-5)[0]
    aten = lambda x, w, b, rm, rv: torch.batch_norm(  # noqa: E731
        x, w, b, rm, rv, True, 0.1, 1e-5, torch.backends.cudnn.enabled)
    out = {"shape": [n, c, hw, hw], "dtype": "bfloat16",
           "port_nchw": case("nchw", torch.bfloat16, native),
           "port_channels_last": case("channels_last", torch.bfloat16,
                                      native),
           "torch_batch_norm_bf16_weights": case("nchw", torch.bfloat16,
                                                 aten),
           "torch_batch_norm_f32_weights": case("nchw", torch.float32, aten)}
    # x read and the output written forward; x and g read and dx
    # written backward
    out["bound_ms"] = 5 * x0.numel() * 2 / HBM_BYTES_PER_S * 1e3
    return out


def phase_resnet50_anatomy(step, batch, timed_ms, steps=2):
    import torch
    x, y = batch
    bn_names = set()
    _step_anatomy("RESNET50_ANATOMY", lambda: step(x, y), steps,
                  lambda n: _resnet_group(n, bn_names), timed_ms=timed_ms)
    log("RESNET50_BN_KERNELS " + json.dumps(sorted(bn_names)))
    if not bn_names:
        raise AssertionError("no batch-norm kernel in the ResNet-50 trace")
    log("RESNET50_BN_ROUTES " + json.dumps(_bn_routes(torch)))


# --------------------------------------------------------------- phase 30
# bench.py:1110-1111 and :1116-1117, bench_pallas's static GPT (its chip
# and CPU configurations)
GPT_STATIC_CHIP = dict(vocab=50257, hidden=1024, layers=8, heads=16,
                       ffn=4096, seq=1024, batch=8)
GPT_STATIC_CPU = dict(vocab=1000, hidden=128, layers=2, heads=4, ffn=512,
                      seq=128, batch=4)
# bench.py:630-632, bench_static's chip config
STATIC_MLP_CHIP = dict(hidden=1024, depth=8, batch=256, steps=100, rounds=3)
STATIC_LENET_CHIP = dict(batch=256, steps=50)


_PHASE32: dict = {}


def _gpt_static_kernels(layers):
    """The static GPT's realized kernels, in the fusion pass's order: a
    layer's fc1 + gelu chains first (the largest saving), then the last
    fc2's residual add, which takes the final layer norm with it (its
    only reader), then the other residual adds, then fused Adam."""
    return (["fused_epilogue[matmul+bias+gelu]"] * layers
            + ["fused_epilogue[matmul+bias+add+layer_norm]"]
            + ["fused_epilogue[matmul+bias+add]"] * (2 * layers - 1)
            + ["fused_adam"])


def _gpt_static_per_step(kernels, layers):
    """Each kernel's launches a static GPT step, from a realized list:
    every fused chain launches K2f and K2b's two kernels once, every
    layer's attention the three f32 flash kernels once."""
    chains = sum(k.startswith("fused_epilogue") for k in kernels)
    return {"fused_epilogue_fwd": chains, "fused_epilogue_bwd": chains,
            "fused_epilogue_bwd_grads": chains,
            "fused_adam": kernels.count("fused_adam"),
            "flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers}


def phase_static_gpt_parity():
    """``build_gpt_static`` at bench_pallas's CPU widths, 3 runs on the
    CPU and on the card from the same weights and constant: the same
    realized kernels (the list ``_gpt_static_kernels`` gives), losses
    within rtol 1e-5, parameters within BERT_PARAM_ATOL (the key
    projections' biases within lr a step), and the kernels' launches on
    the card, by name.  Returns the CPU's realized list."""
    import numpy as np
    import torch
    from paddle_tpu_torch import static
    from paddle_tpu_torch.framework_io import program_state_from_paddle_tpu
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import build_gpt_static
    cfg, runs = GPT_STATIC_CPU, 3
    built = {dev: build_gpt_static(**cfg, device=dev)
             for dev in ("cpu", "cuda")}
    cpu_main = built["cpu"][0]
    program_state_from_paddle_tpu(
        built["cuda"][0], [p.detach().numpy() for p in cpu_main.parameters()],
        [v.numpy() for node in cpu_main.nodes for tag, v in node.in_specs
         if tag == "c"])
    losses, kernels = {}, {}
    for dev, (main, loss, feeds) in built.items():
        exe = static.Executor(dev)
        feed = {k: torch.from_numpy(v).to(dev)
                for k, v in feeds(np.random.RandomState(0)).items()}
        support.reset_launch_counts()
        losses[dev] = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                       for _ in range(runs)]
        kernels[dev] = next(iter(exe._cache.values())).kernels
    counts = dict(support.launch_counts)
    want = {k: v * runs for k, v in _gpt_static_per_step(
        kernels["cpu"], cfg["layers"]).items()}
    if counts != want:
        raise AssertionError(f"small static GPT launches {counts}, want "
                             f"{want}")
    if not (kernels["cpu"] == kernels["cuda"]
            == _gpt_static_kernels(cfg["layers"])):
        raise AssertionError(f"realized kernels differ: {kernels}")
    diffs = [(p.detach().cpu() - q.detach()).abs().max().item()
             for p, q in zip(built["cuda"][0].parameters(),
                             cpu_main.parameters())]
    # parameters: tok, then 16 a layer (ln1.w, ln1.b, wq.w, wq.b, wk.w,
    # wk.b, ...)
    k_bias = {1 + 16 * layer + 5 for layer in range(cfg["layers"])}
    rest = max(d for i, d in enumerate(diffs) if i not in k_bias)
    kb = max(diffs[i] for i in k_bias)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    out = {"config": cfg, "losses_cpu": losses["cpu"],
           "losses_cuda": losses["cuda"], "loss_max_rel_err": loss_err,
           "param_max_abs_err": rest, "k_proj_bias_max_abs_err": kb,
           "loss_rtol": 1e-5, "param_atol": BERT_PARAM_ATOL,
           "k_proj_bias_atol": 1e-4 * runs * 1.01,
           "kernels": kernels["cuda"], "launches": counts}
    log("STATIC_GPT_PARITY " + json.dumps(out))
    if (not loss_err <= 1e-5 or not rest <= BERT_PARAM_ATOL
            or not kb <= 1e-4 * runs * 1.01):
        raise AssertionError(f"small static GPT card vs CPU: {out}")
    return kernels["cpu"]


# --------------------------------------------------------------- phase 31
def _gpt_static_chains(cfg):
    """The static GPT's fused chains at the chip config, and the static
    MLP's: (label, M, K, N, stages after the bias, library forward call
    and its name)."""
    import torch
    h, f = cfg["hidden"], cfg["ffn"]
    M = cfg["batch"] * cfg["seq"]
    ln = ("layer_norm", 1e-5, True, True)

    def addmm_act(gelu):
        return lambda x, w, ops: lambda: torch._addmm_activation(
            ops[0][0], x, w, use_gelu=gelu)

    def addmm_res(x, w, ops):
        c = ops[0] + ops[1]                    # bias + residual, once
        return lambda: torch.addmm(c, x, w)

    act = "torch._addmm_activation(bias, x, w, use_gelu={})"
    res = "torch.addmm(bias + residual, x, w), the sum made beforehand"
    mlp = STATIC_MLP_CHIP
    return [("fc1", M, h, f, (("gelu", True),), addmm_act(True),
             act.format(True)),
            ("proj", M, h, h, (("add",),), addmm_res, res),
            ("fc2", M, f, h, (("add",),), addmm_res, res),
            ("fc2 last layer", M, f, h, (("add",), ln), None, None),
            ("static MLP fc", mlp["batch"], mlp["hidden"], mlp["hidden"],
             (("relu",),), addmm_act(False), act.format(False))]


def _gpt_static_param_shapes(cfg):
    """program.parameters() of build_gpt_static, in order."""
    h, f, v = cfg["hidden"], cfg["ffn"], cfg["vocab"]
    layer = [(h,), (h,)] + [(h, h), (h,)] * 4 + [(h,), (h,), (h, f), (f,),
                                                 (f, h), (h,)]
    return [(v, h)] + layer * cfg["layers"] + [(h,), (h,), (h, v), (v,)]


def phase_static_gpt_kernels():
    """Every kernel instance the static GPT and the static MLP put on a
    main path, held to its plain version on the card and timed beside its
    bound and a library call: the f32 flash kernels causal at D 64 (B 8,
    L 1024, H 16; SDPA's memory-efficient backend, causal); K2f and K2b
    at the GPT's chains (M 8192: fc1 + gelu, the residual adds of proj
    and fc2, the last fc2's add + layer_norm) and the MLP's bias + relu
    (M 256); K3 over the GPT's trained parameters (``torch._fused_adam_``
    beside it).  Returns {kernel: row}."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    cfg = GPT_STATIC_CHIP
    B, L, H = cfg["batch"], cfg["seq"], cfg["heads"]
    D = cfg["hidden"] // H
    errs = _flash_case(torch, gen, B, L, H, D, torch.float32, True, 0.0, 3,
                       plain_b=1)
    err = max(errs.values())
    log("STATIC_GPT_FLASH_CHECK " + json.dumps({
        "case": f"B={B} L={L} H={H} D={D} float32 causal=True (plain on "
                f"batch row 0)", "errors": errs, "tol": FLASH_TOL["float32"]}))
    if not err <= FLASH_TOL["float32"]:
        raise AssertionError(f"flash f32 causal D {D}: {errs}")
    rows = _flash_time_rows(torch, gen, B, L, H, D, torch.float32, True,
                            0.0, 3)
    for row in rows.values():
        row["max_abs_err"] = err
    epi = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "library_ms": 0.0, "max_abs_err": 0.0, "chains": {}}
           for name in EPI_KERNELS}
    for label, M, K, N, stages, fwd_call, fwd_name in _gpt_static_chains(
            cfg):
        x, w, dy, ops = _epi_case(torch, gen, M, K, N, stages, torch.float32)
        errs = _epi_check(torch, x, w, dy, ops, stages)
        err = max(errs.values())
        check = {"case": f"{label} M={M} K={K} N={N} float32",
                 "errors": errs, "tol": EPI_TOL["float32"]}
        log("EPILOGUE_CHECK " + json.dumps(check))
        if not err <= EPI_TOL["float32"]:
            raise AssertionError(f"fused epilogue kernels disagree with the "
                                 f"plain versions: {check}")
        del x, w, dy, ops
        chains = _epi_chain_times(torch, gen, M, K, N, stages, fwd_call,
                                  fwd_name)
        for name, chain in chains.items():
            chain["max_abs_err"] = err
            log("KERNEL " + json.dumps(dict(kernel=name, **check, **chain)))
            epi[name]["chains"][label] = chain
            epi[name]["max_abs_err"] = max(epi[name]["max_abs_err"], err)
            if label in ("fc1", "proj", "fc2"):
                for key in ("ms", "plain_ms", "bound_ms"):
                    epi[name][key] += chain[key]
                epi[name]["library_ms"] += chain["library_ms"]
    for name, row in epi.items():
        layer = [row["chains"][k] for k in ("fc1", "proj", "fc2")]
        row["bound_by"] = ("bytes" if all(c["bound_by"] == "bytes"
                                          for c in layer) else "operations")
        row["library_call"] = "; ".join(sorted({c["library_call"]
                                                for c in layer}))
        row["case"] = (f"one static GPT layer: fc1, proj and fc2 chains at "
                       f"M={B * L}, float32, times summed")
        log("KERNEL_LAYER " + json.dumps(dict(kernel=name, **row)))
        rows[name] = row
    shapes = _gpt_static_param_shapes(cfg)
    rows["fused_adam"] = _adam_phase(torch, gen, shapes)
    rows["fused_adam"]["case"] = (f"the static GPT's {len(shapes)} trained "
                                  f"tensors, {rows['fused_adam']['numel']} "
                                  f"float32 elements")
    return rows


# --------------------------------------------------------------- phase 32
def phase_static_gpt_training(cpu_kernels, warmup=2, steps=8):
    """bench_pallas's static GPT at its chip config on the card, uncut:
    losses finite, the first near ln(vocab), one build, the realized
    kernels those of the CPU's list (phase 30) at this depth, and each
    kernel launched as often a step as that list says.  MFU from the
    port's own ``Program.analyze`` count (bench_pallas's) over 67 TFLOP/s,
    the PaLM count beside it; peak memory beside analyze's prediction."""
    import numpy as np
    import torch
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import (build_gpt_static,
                                                 palm_flops_per_step)
    cfg = GPT_STATIC_CHIP
    t0 = time.perf_counter()
    main, loss, feeds = build_gpt_static(**cfg, device="cuda")
    exe = static.Executor("cuda")
    feed = {k: torch.from_numpy(v).cuda()
            for k, v in feeds(np.random.RandomState(0)).items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    support.reset_launch_counts()
    losses, step_ms = [], []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[0]))
    counts = dict(support.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    rep = main.analyze(fetch_list=[loss], chip="h100", top_k=None)
    analyze_s = time.perf_counter() - t0
    step = next(iter(exe._cache.values()))
    n_params = sum(p.numel() for p in main.parameters())
    timed = step_ms[warmup:]
    mean_ms = sum(timed) / len(timed)
    flops = rep.totals["flops_train"]
    palm = palm_flops_per_step(n_params - cfg["vocab"] * cfg["hidden"],
                               cfg["layers"], cfg["seq"], cfg["batch"],
                               cfg["hidden"])
    kernels = step.kernels
    want_kernels = _gpt_static_kernels(cfg["layers"])
    per_step = _gpt_static_per_step(kernels, cfg["layers"])
    out = {"config": cfg, "dtype": "float32", "optimizer": "Adam(1e-4)",
           "params_trained": n_params, "setup_s": setup_s,
           "warmup_runs": warmup, "timed_runs": steps, "losses": losses,
           "step_ms": timed, "step_ms_p50": float(np.median(timed)),
           "step_ms_mean": mean_ms, "first_runs_ms": step_ms[:warmup],
           "tokens_per_s": cfg["batch"] * cfg["seq"] / (mean_ms / 1e3),
           "analyze_flops_train": flops,
           "analyze_flops_fwd": rep.totals["flops_fwd"],
           "analyze_unmodeled_ops": rep.totals["unmodeled"]["count"],
           "mfu_f32": flops / (mean_ms / 1e3) / PEAK_OPS["float32"],
           "palm_flops_per_step": palm,
           "mfu_f32_palm": palm / (mean_ms / 1e3) / PEAK_OPS["float32"],
           "mfu_peak": "67 TFLOP/s, f32 on the CUDA cores",
           "max_memory_allocated": peak,
           "analyze_peak_bytes_donated": rep.memory.peak_bytes_donated,
           "analyze_peak_bytes_no_donation":
               rep.memory.peak_bytes_no_donation,
           "analyze_s": analyze_s, "predicted": step.predicted,
           "fusion_candidates_realized":
               f"{sum(1 for c in rep.fusion_candidates if c['realized'])}"
               f"/{len(rep.fusion_candidates)}",
           "launches": counts, "launches_per_step_want": per_step,
           "realized_kernels": kernels, "compile_count": exe.compile_count}
    log("STATIC_GPT_TRAIN " + json.dumps(out))
    # phase 65 holds the same model through fleet to these numbers
    _PHASE32.update(losses=losses, step_ms_p50=out["step_ms_p50"],
                    max_memory_allocated=peak)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(cfg["vocab"])) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near "
                             f"ln({cfg['vocab']}) = "
                             f"{math.log(cfg['vocab'])}")
    if exe.compile_count != 1:
        raise AssertionError(f"{exe.compile_count} builds, want 1")
    if kernels != want_kernels or (
            cpu_kernels != _gpt_static_kernels(GPT_STATIC_CPU["layers"])):
        raise AssertionError(f"realized kernels {kernels}, want "
                             f"{want_kernels} (the CPU's list at "
                             f"{cfg['layers']} layers)")
    if per_step["fused_epilogue_fwd"] != 3 * cfg["layers"]:
        raise AssertionError(f"{per_step} fused chains, want 3 a layer")
    runs = warmup + steps
    want = {k: v * runs for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"static GPT launches {counts}, want {want}")
    return counts, (exe, main, loss, feed), timed


# --------------------------------------------------------------- phase 33
def phase_static_gpt_anatomy(run, timed_ms, steps=2):
    """Anatomy of one static GPT step: device ms by group (fused
    epilogue, flash, fused Adam, cuBLAS, other), the idle share, and the
    named f32 kernels' launches a step."""
    exe, main, loss, feed = run
    layers = GPT_STATIC_CHIP["layers"]
    launches = _step_anatomy("STATIC_GPT_ANATOMY", lambda: exe.run(
        main, feed=feed, fetch_list=[loss], return_numpy=False), steps,
        lambda n: ("fused_epilogue" if "epilogue_" in n else
                   "fused_adam" if "adam_kernel" in n else
                   "flash" if "flash_" in n else
                   "cublas" if _is_gemm(n) else "other"),
        timed_ms=timed_ms)
    want = {"epilogue_fwd_f32_kernel": 3 * layers,
            "epilogue_bwd_f32_kernel": 3 * layers,
            "epilogue_grads_f32_kernel": 3 * layers,
            "flash_fwd_f32_kernel": layers,
            "flash_bwd_dq_f32_kernel": layers,
            "flash_bwd_dkv_f32_kernel": layers}
    seen = {k: launches.get(k, 0) for k in want}
    if seen != want:
        raise AssertionError(f"static GPT step kernels {seen}, want {want}")


# --------------------------------------------------------------- phase 34
def _analyzer(main, loss, batch, steps, seconds):
    """bench_static's ``analyzer`` block (bench.py:765-780), with the
    h100 row's predicted GFLOP/s beside the achieved."""
    rep = main.analyze(fetch_list=[loss], batch_size=batch, chip="h100")
    m, r = rep.memory, rep.roofline["h100"]
    train = rep.totals["flops_train"]
    return {"fwd_gflops_per_step": rep.totals["flops_fwd"] / 1e9,
            "train_gflops_per_step": train / 1e9,
            "peak_mib_donated": m.peak_bytes_donated / 2 ** 20,
            "peak_mib_no_donation": m.peak_bytes_no_donation / 2 ** 20,
            "arithmetic_intensity": rep.totals["arithmetic_intensity"],
            "unmodeled_ops": rep.totals["unmodeled"]["count"],
            "fusion_candidates": len(rep.fusion_candidates),
            "predicted_step_ms_h100": r["predicted_step_s"] * 1e3,
            "predicted_bound_h100": r["bound"],
            "predicted_gflops_per_sec": train / r["predicted_step_s"] / 1e9,
            "achieved_gflops_per_sec": train * steps / seconds / 1e9}


def _static_sentry_micro(main, loss, exe, feed, build, mc):
    """``bench_static``'s sentry micro (bench.py:701-745): the static MLP
    with ``FLAGS_anomaly_sentry`` built in (a second program of the same
    build) timed against the sentry-less one, round for round, one sync
    a round; its device ``skipped_steps`` must stay 0 on clean data.
    The micro is the sentry's worst case: host and small device work
    dominate the step."""
    from paddle_tpu_torch import set_flags, static
    main3, loss3 = build(mc["hidden"], mc["depth"])
    exe3 = static.Executor("cuda")
    set_flags({"anomaly_sentry": True})
    try:
        for _ in range(3):
            last3 = exe3.run(main3, feed=feed, fetch_list=[loss3],
                             return_numpy=False)[0]
        float(last3)
    finally:
        set_flags({"anomaly_sentry": False})
    dt_on = dt_off = 0.0
    rounds, steps = mc["rounds"], mc["steps"]
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(steps):
            last = exe.run(main, feed=feed, fetch_list=[loss],
                           return_numpy=False)[0]
        float(last)
        dt_off += time.perf_counter() - t0
        set_flags({"anomaly_sentry": True})
        try:
            t0 = time.perf_counter()
            for _ in range(steps):
                last3 = exe3.run(main3, feed=feed, fetch_list=[loss3],
                                 return_numpy=False)[0]
            float(last3)
            dt_on += time.perf_counter() - t0
        finally:
            set_flags({"anomaly_sentry": False})
    out = {"skipped_steps": exe3.sentry_stats(main3)["skipped_steps"],
           "overhead_pct": 100.0 * (dt_on / dt_off - 1.0),
           "step_time_ms_on": 1e3 * dt_on / (rounds * steps),
           "step_time_ms_off": 1e3 * dt_off / (rounds * steps),
           "rounds": rounds, "steps_a_round": steps,
           "builds_on": exe3.compile_count}
    exe3.close()
    return out


def phase_static_bench():
    """``bench_static``'s two entries at its chip config: the static MLP
    (hidden 1024, depth 8, batch 256; 3 warm-up runs, then 3 rounds of
    100 runs with ``return_numpy=False`` and one sync a round) and the
    static LeNet (batch 256; 3 warm-up and 50 runs, one sync at the end),
    device feeds.  Prints steps/s, step ms, ``compile_count`` and
    ``host_feed_converts`` (asserted 1 and 0 each) and the analyzer block;
    returns each program's launches."""
    import numpy as np
    import torch
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import (build_static_lenet,
                                                 build_static_mlp)
    mc, lc = STATIC_MLP_CHIP, STATIC_LENET_CHIP
    rng = np.random.RandomState(0)
    xs = rng.standard_normal((mc["batch"], mc["hidden"])).astype(np.float32)
    ys = rng.standard_normal((mc["batch"], 1)).astype(np.float32)
    lx = rng.standard_normal((lc["batch"], 1, 28, 28)).astype(np.float32)
    ly = rng.randint(0, 10, (lc["batch"],), dtype=np.int64)
    out, launches = {}, {}
    for name in ("mlp", "lenet"):
        if name == "mlp":
            main, loss = build_static_mlp(mc["hidden"], mc["depth"])
            feed = {"x": torch.from_numpy(xs).cuda(),
                    "y": torch.from_numpy(ys).cuda()}
            rounds, steps, batch = mc["rounds"], mc["steps"], mc["batch"]
        else:
            main, loss = build_static_lenet()
            feed = {"x": torch.from_numpy(lx).cuda(),
                    "y": torch.from_numpy(ly).cuda()}
            rounds, steps, batch = 1, lc["steps"], lc["batch"]
        exe = static.Executor("cuda")
        support.reset_launch_counts()
        for _ in range(3):
            last = exe.run(main, feed=feed, fetch_list=[loss],
                           return_numpy=False)[0]
        first = float(last)
        dt = 0.0
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(steps):
                last = exe.run(main, feed=feed, fetch_list=[loss],
                               return_numpy=False)[0]
            final = float(last)                    # one sync a round
            dt += time.perf_counter() - t0
        launches[name] = dict(support.launch_counts)
        if name == "mlp":
            out["sentry"] = _static_sentry_micro(
                main, loss, exe, feed, build_static_mlp, mc)
        n = rounds * steps
        out[name] = {"steps_per_sec": n / dt, "step_time_ms": 1e3 * dt / n,
                     "timed_runs": n, "batch": batch,
                     "loss_after_warmup": first, "final_loss": final,
                     "compile_count": exe.compile_count,
                     "host_feed_converts": exe.host_feed_converts,
                     "realized_kernels": next(iter(
                         exe._cache.values())).kernels,
                     "launches": launches[name],
                     "analyzer": _analyzer(main, loss, batch, n, dt)}
        exe.close()
    out["config"] = {"mlp": mc, "lenet": lc, "optimizer": "Adam(1e-3)",
                     "feeds": "torch tensors on the card"}
    out["cut"] = {
        "speedup_vs_legacy_executor": "Executor._run_legacy is the JAX "
        "package's loop from before its donated fast path; the port has "
        "no earlier loop"}
    log("STATIC_BENCH " + json.dumps(out))
    sen = out["sentry"]
    log("SENTRY_MICRO_CHECK " + json.dumps(
        {"skipped_steps": sen["skipped_steps"], "want": 0}))
    if sen["skipped_steps"] != 0:
        raise AssertionError(f"the sentry skipped clean runs: {sen}")
    for name in ("mlp", "lenet"):
        r = out[name]
        if r["compile_count"] != 1 or r["host_feed_converts"] != 0:
            raise AssertionError(f"static {name}: {r['compile_count']} "
                                 f"builds, {r['host_feed_converts']} feed "
                                 f"conversions; want 1 and 0")
        if not (math.isfinite(r["final_loss"])
                and r["final_loss"] < r["loss_after_warmup"]):
            raise AssertionError(f"static {name} did not train: {r}")
    want = {"mlp": {"fused_epilogue_fwd": mc["depth"],
                    "fused_epilogue_bwd": mc["depth"],
                    "fused_epilogue_bwd_grads": mc["depth"],
                    "fused_adam": 1},
            "lenet": {"fused_adam": 1}}
    for name, per in want.items():
        runs = 3 + out[name]["timed_runs"]
        got = launches[name]
        if got != {k: v * runs for k, v in per.items()}:
            raise AssertionError(f"static {name} launches {got}, want "
                                 f"{per} a run")
    return launches


# --------------------------------------------------------------- phase 35
# Zaremba, Sutskever & Vinyals 2014 (arXiv:1409.2329, section 4.1; the
# TensorFlow PTB tutorial's LargeConfig): vocab 10000, embedding and
# hidden 1500, 2 LSTM layers, 35 steps unrolled, batch 20, dropout 0.65
# on the non-recurrent connections, U(-0.04, 0.04), SGD lr 1.0 with a
# global-norm clip of 10, f32.  The ids are synthetic: the PTB text is
# not in the repository.
PTB_LARGE = dict(vocab=10000, hidden=1500, steps=35, batch=20,
                 dropout=0.65, init=0.04, lr=1.0, clip=10.0)
PTB_SMALL = dict(vocab=200, hidden=32, steps=8, batch=4, dropout=0.0,
                 init=0.04, lr=1.0, clip=10.0)
PTB_ADAM_LR = 1e-3


class _PTBLM:
    """The PTB LM from the port's public nn API: a sparse embedding, two
    separate LSTM layers (so that dropout sits between them; the
    layers' own ``dropout=`` is ignored, as in paddle_tpu), a Linear
    head and the mean cross entropy over the tokens."""

    def __init__(self, paddle, cfg, sparse=True):
        nn, H, V = paddle.nn, cfg["hidden"], cfg["vocab"]
        self.paddle, self.cfg = paddle, cfg
        self.embedding = nn.Embedding(V, H, sparse=sparse)
        self.lstm1 = nn.LSTM(H, H)
        self.lstm2 = nn.LSTM(H, H)
        self.head = nn.Linear(H, V)
        self.drops = [nn.Dropout(cfg["dropout"]) for _ in range(3)]

    def layers(self):
        return [self.embedding, self.lstm1, self.lstm2, self.head]

    def parameters(self):
        return [p for layer in self.layers() for p in layer.parameters()]

    def zero_states(self, device):
        import torch
        z = torch.zeros((1, self.cfg["batch"], self.cfg["hidden"]),
                        device=device)
        z = self.paddle.to_tensor(z, place=device)
        return [(z, z)] * 2

    def __call__(self, x, y, states):
        F = self.paddle.nn.functional
        h = self.drops[0](self.embedding(x))
        h, s1 = self.lstm1(h, states[0])
        h, s2 = self.lstm2(self.drops[1](h), states[1])
        logits = self.head(self.drops[2](h))
        loss = F.cross_entropy(logits.reshape([-1, self.cfg["vocab"]]),
                               y.reshape([-1]))
        # truncated BPTT: the next step starts from these states, detached
        return loss, [(a.detach(), b.detach()) for a, b in (s1, s2)]


def _ptb_weights(np, model, seed):
    """U(-init, init) numpy weights, one array a parameter, in
    ``model.parameters()`` order."""
    rs = np.random.RandomState(seed)
    a = model.cfg["init"]
    return [rs.uniform(-a, a, tuple(p.shape)).astype(np.float32)
            for p in model.parameters()]


def _ptb_on(paddle, where, cfg, weights, sparse=True):
    from paddle_tpu_torch.core import placement
    prev = placement.default()
    paddle.set_device(where)
    try:
        model = _PTBLM(paddle, cfg, sparse)
        for p, w in zip(model.parameters(), weights):
            p.set_value(w)
    finally:
        placement.set_default(prev)
    return model


def _zipf_ids(np, seed, cfg, n):
    """``n`` batches of ``[batch, steps + 1]`` ids with p proportional to
    1 / rank: at 10000 words a batch touches a few hundred rows, as PTB
    text does."""
    p = 1.0 / np.arange(1, cfg["vocab"] + 1)
    return np.random.RandomState(seed).choice(
        cfg["vocab"], size=(n, cfg["batch"], cfg["steps"] + 1),
        p=p / p.sum()).astype(np.int64)


def _ptb_opts(paddle, model, cfg):
    return (paddle.optimizer.SGD(
                learning_rate=cfg["lr"], parameters=model.parameters(),
                grad_clip=paddle.nn.ClipGradByGlobalNorm(cfg["clip"])),
            paddle.optimizer.Adam(learning_rate=PTB_ADAM_LR, lazy_mode=True,
                                  parameters=model.parameters()))


def phase_ptb_small_parity(steps=3):
    """The small PTB LM on the card against the CPU from the same numpy
    weights: 3 steps of sparse SGD with clip 10, then 3 of lazy Adam."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.cuda import support
    cfg = PTB_SMALL
    paddle.set_device("cpu")
    weights = _ptb_weights(np, _PTBLM(paddle, cfg), 35)
    paddle.core.placement.set_default(None)
    ids = _zipf_ids(np, 350, cfg, 2 * steps)
    runs = {}
    support.reset_launch_counts()
    for where, dev in (("cpu", "cpu"), ("gpu", "cuda")):
        model = _ptb_on(paddle, where, cfg, weights)
        sgd, adam = _ptb_opts(paddle, model, cfg)
        states = model.zero_states(dev)
        losses = []
        for k in range(2 * steps):
            x = paddle.to_tensor(ids[k][:, :-1], place=dev)
            y = paddle.to_tensor(ids[k][:, 1:], place=dev)
            loss, states = model(x, y, states)
            loss.backward()
            opt = sgd if k < steps else adam
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        m = adam._states[id(model.embedding.weight)]["m"]
        runs[where] = (losses, model.embedding.weight.numpy(),
                       m.detach().cpu().numpy(),
                       [p.numpy() for p in model.parameters()])
    (lc, ec, mc, pc), (lg, eg, mg, pg) = runs["cpu"], runs["gpu"]
    tol = TOL["float32"]
    loss_err = max(abs(a - b) / max(1.0, abs(a)) for a, b in zip(lc, lg))
    touched = np.zeros(cfg["vocab"], bool)
    touched[ids[:, :, :-1].ravel()] = True
    adam_rows = np.zeros(cfg["vocab"], bool)
    adam_rows[ids[steps:, :, :-1].ravel()] = True
    emb0 = weights[0]
    row_err = float(np.abs(eg[touched] - ec[touched]).max())
    param_err = max(float(np.abs(a - b).max()) for a, b in zip(pg, pc))
    out = {"config": cfg, "adam_lr": PTB_ADAM_LR, "tol": tol,
           "losses_cpu": lc, "losses_card": lg, "loss_max_rel_err": loss_err,
           "touched_rows": int(touched.sum()),
           "touched_row_max_abs_err": row_err,
           "param_max_abs_err": param_err,
           "adam_moment_rows": int((np.abs(mg).sum(1) > 0).sum()),
           "hand_kernel_launches": dict(support.launch_counts)}
    log("PTB_SMALL_PARITY " + json.dumps(out))
    if not loss_err <= tol:
        raise AssertionError(f"PTB losses card {lg} vs CPU {lc}")
    for side, e in (("card", eg), ("cpu", ec)):
        if not np.array_equal(e[~touched], emb0[~touched]):
            raise AssertionError(f"{side}: untouched embedding rows moved")
    if not (row_err <= tol and param_err <= tol):
        raise AssertionError(f"touched rows {row_err}, parameters "
                             f"{param_err} > {tol}")
    for side, m in (("card", mg), ("cpu", mc)):
        if np.abs(m[~adam_rows]).sum() != 0 or not np.all(
                np.abs(m[adam_rows]).sum(1) > 0):
            raise AssertionError(f"{side}: lazy Adam's moments are not "
                                 f"those of the touched rows")
    if any(support.launch_counts.values()):
        raise AssertionError(f"hand kernels launched: "
                             f"{support.launch_counts}")
    torch.cuda.synchronize()
    return weights


# --------------------------------------------------------------- phase 36
def _ptb_step_fn(paddle, model, opt, batches, states_box):
    """One training step a call, through the batches in turn (truncated
    BPTT over the states in ``states_box``); returns the loss tensor."""
    it = {"k": 0}

    def one_step():
        x, y = batches[it["k"] % len(batches)]
        it["k"] += 1
        loss, states_box[0] = model(x, y, states_box[0])
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return one_step


def _ptb_batches(np, paddle, ids):
    return [(paddle.to_tensor(b[:, :-1], place="cuda"),
             paddle.to_tensor(b[:, 1:], place="cuda")) for b in ids]


def _ptb_timed(torch, one_step, warmup, steps):
    from paddle_tpu_torch.ops.cuda import support
    support.reset_launch_counts()
    runs = [_clocked_step(torch, one_step) for _ in range(warmup + steps)]
    losses = [float(loss) for loss, _ in runs]
    return losses, [ms for _, ms in runs], dict(support.launch_counts)


def phase_ptb_training(warmup=2, steps=10, side_steps=4):
    """PTB-large at full width on the card: 2 warm-up and 10 timed steps
    of sparse SGD with clip 10; then a few steps with a dense embedding
    gradient, and of the per-step cell path."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    cfg = PTB_LARGE
    tokens = cfg["batch"] * cfg["steps"]
    t0 = time.perf_counter()
    paddle.set_device("gpu")
    model = _PTBLM(paddle, cfg)
    weights = _ptb_weights(np, model, 36)
    for p, w in zip(model.parameters(), weights):
        p.set_value(w)
    paddle.core.placement.set_default(None)
    sgd, _ = _ptb_opts(paddle, model, cfg)
    ids = _zipf_ids(np, 360, cfg, warmup + steps)
    batches = _ptb_batches(np, paddle, ids)
    box = [model.zero_states("cuda")]
    one_step = _ptb_step_fn(paddle, model, sgd, batches, box)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, counts = _ptb_timed(torch, one_step, warmup, steps)
    peak = torch.cuda.max_memory_allocated()
    timed = step_ms[warmup:]
    mean = sum(timed) / len(timed)
    out = {"config": cfg, "params": sum(p.numel()
                                        for p in model.parameters()),
           "dtype": "float32, TF32 off", "setup_s": setup_s,
           "warmup_steps": warmup, "timed_steps": steps,
           "tokens_per_step": tokens,
           "unique_rows_per_step": [int(np.unique(b[:, :-1]).size)
                                    for b in ids],
           "losses": losses, "step_ms": timed,
           "step_ms_p50": float(np.median(timed)), "step_ms_mean": mean,
           "first_steps_ms": step_ms[:warmup],
           "tokens_per_s": tokens / (mean / 1e3),
           "max_memory_allocated": peak, "hand_kernel_launches": counts}
    first_ok = abs(losses[0] - math.log(cfg["vocab"])) <= 0.02 * math.log(
        cfg["vocab"])
    # the dense embedding gradient beside the sparse one: the same
    # weights and batches, a model whose Embedding has sparse=False
    dense = _PTBLM(paddle, cfg, sparse=False)
    for p, w in zip(dense.parameters(), weights):
        p.set_value(w)
    dsgd, _ = _ptb_opts(paddle, dense, cfg)
    dstep = _ptb_step_fn(paddle, dense, dsgd, batches,
                         [dense.zero_states("cuda")])
    d = _ptb_timed(torch, dstep, 2, side_steps)
    del dense, dsgd, dstep
    out["dense_embedding_grad"] = {
        "step_ms": d[1][2:], "step_ms_p50": float(np.median(d[1][2:])),
        "losses": d[0], "hand_kernel_launches": d[2]}
    # the per-step cell path (the recurrent op's plain version)
    for lstm in (model.lstm1, model.lstm2):
        lstm.fused = False
    c = _ptb_timed(torch, one_step, 1, side_steps)
    for lstm in (model.lstm1, model.lstm2):
        lstm.fused = True
    out["per_step_cells"] = {
        "step_ms": c[1][1:], "step_ms_p50": float(np.median(c[1][1:])),
        "losses": c[0], "hand_kernel_launches": c[2]}
    out["sparse_over_dense"] = (out["step_ms_p50"]
                                / out["dense_embedding_grad"]["step_ms_p50"])
    out["per_step_over_fused"] = (out["per_step_cells"]["step_ms_p50"]
                                  / out["step_ms_p50"])
    out["nvidia_smi"] = nvidia_smi()
    log("PTB_TRAIN " + json.dumps(out))
    if not (first_ok and all(math.isfinite(v) for v in losses + d[0]
                             + c[0])):
        raise AssertionError(f"PTB losses {losses}; the first is not "
                             f"within 2 % of ln({cfg['vocab']})")
    for what, n in (("sparse", counts), ("dense", d[2]), ("per-step", c[2])):
        if any(n.values()):
            raise AssertionError(f"the {what} PTB step launched hand "
                                 f"kernels {n}; this path has none")
    return model, one_step, timed


# --------------------------------------------------------------- phase 37
def _ptb_op_group(scope, name):
    """A PTB step's group for an aten op that launched kernels, by the
    part of the step it ran in (``scope``: forward, backward or the
    optimizer's step) and its name."""
    n = name.replace("aten::", "")
    if "cudnn_rnn" in n or n in ("lstm", "rnn_tanh", "gru"):
        return "recurrent"
    if n in ("mm", "addmm", "matmul", "bmm", "linear"):
        return "head_gemm"
    if "softmax" in n or "nll_loss" in n or "cross_entropy" in n:
        return "softmax_cross_entropy"
    if scope == "optimizer":
        if n.startswith("_foreach_norm") or n in (
                "linalg_vector_norm", "stack", "clamp", "clamp_min",
                "sqrt", "div", "reciprocal", "mul"):
            return "clip"
        if n.startswith("_foreach"):
            return "dense_update"
        return "embedding_merge_and_scatter_update"
    if n in ("embedding", "index_select", "embedding_dense_backward",
             "index_add_", "_sparse_coo_tensor_with_dims_and_tensors"):
        return "embedding_lookup_and_gradient"
    if scope == "forward" and n in ("randint", "ge", "mul", "where",
                                    "_to_copy", "lt", "div"):
        return "dropout"
    return f"{scope}_other"


def _ptb_groups(prof, steps):
    """Device ms a step by :func:`_ptb_op_group`, from the aten ops of a
    profile whose step parts are ``record_function`` ranges; a kernel
    is its launching op's (the autograd engine's ops are the
    backward's)."""
    groups = {}
    for e in prof.events():
        if e.device_type.name != "CPU" or e.self_device_time_total <= 0:
            continue
        scope, p = None, e.cpu_parent
        while p is not None:
            if p.name.startswith("ptb."):
                scope = p.name[4:]
                break
            if p.name.startswith("autograd::engine"):
                scope = "backward"
            p = p.cpu_parent
        g = _ptb_op_group(scope or "backward", e.name)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / steps
    return groups


def _host_syncs(torch, fn):
    """Device-to-host synchronisations one call of ``fn`` makes, counted
    by torch's sync debug mode (one warning a synchronising call)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message)[:120] for w in caught
            if "called a synchronizing" in str(w.message)]


def phase_ptb_anatomy(model, one_step, timed_ms, steps=2):
    """Anatomy of one PTB-large step: device ms by part (the recurrent
    op, the head's GEMMs, softmax and cross entropy, the embedding's
    lookup, gradient, merge and scatter update, the clip, the dense
    update), the idle share and top kernels, and the host syncs a
    step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cfg = model.cfg
    _step_anatomy("PTB_ANATOMY", lambda: one_step(), steps, lambda n: (
        "recurrent" if "rnn" in n or "lstm" in n or "persist" in n else
        "gemm" if _is_gemm(n) else
        "softmax_ce" if "softmax" in n or "nll" in n else
        "index_scatter" if "index" in n or "scatter" in n or "unique" in n
        or "sort" in n or "radix" in n else
        "foreach" if "foreach" in n or "multi_tensor" in n else
        "other"), timed_ms=timed_ms)
    paddle = model.paddle
    sgd, _ = _ptb_opts(paddle, model, cfg)
    x = paddle.to_tensor(torch.randint(0, cfg["vocab"],
                                       (cfg["batch"], cfg["steps"]),
                                       device="cuda"))
    y = paddle.to_tensor(torch.randint(0, cfg["vocab"],
                                       (cfg["batch"], cfg["steps"]),
                                       device="cuda"))
    box = [model.zero_states("cuda")]

    def parts():
        with record_function("ptb.forward"):
            loss, box[0] = model(x, y, box[0])
        with record_function("ptb.backward"):
            loss.backward()
        with record_function("ptb.optimizer"):
            sgd.step()
            sgd.clear_grad()
        return loss

    parts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            parts()
        torch.cuda.synchronize()
    groups = _ptb_groups(prof, steps)
    del prof
    gc.collect()
    syncs = _host_syncs(torch, lambda: float(parts()))
    out = {"device_ms_by_part": groups,
           "device_ms_total": sum(groups.values()),
           "host_syncs_per_step": len(syncs),
           "host_sync_calls": syncs,
           "note": "float(loss) is one of the syncs counted",
           "nvidia_smi": nvidia_smi()}
    log("PTB_ANATOMY_PARTS " + json.dumps(out))
    if not groups.get("recurrent", 0) > 0:
        raise AssertionError("no recurrent kernel in the PTB trace")


# --------------------------------------------------------------- phase 38
def _ptb_decoder(paddle, model):
    """Greedy decoding through two LSTMCells that share the model's
    layers' weights: ``decode(first_tokens, n)`` runs ``paddle.
    while_loop`` eagerly and returns (tokens [B, n], logits [n, B, V])."""
    H = model.cfg["hidden"]
    cells = []
    for lstm in (model.lstm1, model.lstm2):
        cell = paddle.nn.LSTMCell(H, H)
        for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            setattr(cell, k, getattr(lstm, f"{k}_l0"))
        cells.append(cell)

    def decode(first, n, states):
        (h1, c1), (h2, c2) = [(h[0], c[0]) for h, c in states]

        def cond(t, tok, h1, c1, h2, c2, toks, logits):
            return t < n

        def body(t, tok, h1, c1, h2, c2, toks, logits):
            e = model.embedding(tok)
            o1, (h1, c1) = cells[0](e, (h1, c1))
            o2, (h2, c2) = cells[1](o1, (h2, c2))
            lg = model.head(o2)
            nxt = paddle.argmax(lg, axis=-1)
            return (t + 1, nxt, h1, c1, h2, c2, toks + [nxt],
                    logits + [lg])

        t0 = paddle.zeros([], dtype="int64")
        out = paddle.while_loop(cond, body,
                                [t0, first, h1, c1, h2, c2, [], []])
        return paddle.stack(out[6], axis=1), paddle.stack(out[7], axis=0)
    return decode


def phase_control_flow_and_sequence(model, weights_small, n_tokens=64):
    """An eager ``paddle.while_loop`` greedy decode from phase 36's
    model (tokens/s, host syncs a token) and at phase 35's widths card
    against CPU; ``cond``, ``case``, ``switch_case`` eagerly; a static
    Program with ``static.nn.cond`` and ``static.nn.while_loop`` (the
    dynamic decode) through ``Executor.run``, card against CPU; the
    sequence ops and the LSTM classifier's ``sequence_pool``, card
    against CPU."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import sequence as SEQ
    from paddle_tpu_torch.ops.cuda import support
    support.reset_launch_counts()
    out = {}
    tol = TOL["float32"]
    # greedy decode at full width
    cfg = model.cfg
    decode = _ptb_decoder(paddle, model)
    first = paddle.to_tensor(torch.arange(cfg["batch"], device="cuda"))
    states = model.zero_states("cuda")
    with torch.no_grad():
        decode(first, 4, states)
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks, _ = decode(first, n_tokens, states)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        syncs = _host_syncs(torch, lambda: decode(first, 8, states))
    out["decode_full_width"] = {
        "batch": cfg["batch"], "tokens": n_tokens, "seconds": dt,
        "tokens_per_s": cfg["batch"] * n_tokens / dt,
        "host_syncs_per_token": len(syncs) / 8,
        "tokens_shape": list(toks.shape)}
    # the small widths, card against CPU
    res = {}
    for where, dev in (("cpu", "cpu"), ("gpu", "cuda")):
        m = _ptb_on(paddle, where, PTB_SMALL, weights_small)
        prev = paddle.core.placement.default()
        paddle.set_device(where)
        try:
            dec = _ptb_decoder(paddle, m)
            with torch.no_grad():
                tk, lg = dec(paddle.to_tensor(np.arange(PTB_SMALL["batch"])),
                             16, m.zero_states(dev))
        finally:
            paddle.core.placement.set_default(prev)
        res[where] = (tk.numpy(), lg.numpy())
    logit_err = float(np.abs(res["gpu"][1] - res["cpu"][1]).max())
    out["decode_small_card_vs_cpu"] = {
        "tokens_equal": bool(np.array_equal(res["gpu"][0], res["cpu"][0])),
        "logits_max_abs_err": logit_err}
    if not (out["decode_small_card_vs_cpu"]["tokens_equal"]
            and logit_err <= tol):
        raise AssertionError(f"decode card vs CPU: {out}")
    # cond, case, switch_case eagerly on the card
    a = paddle.to_tensor(torch.tensor([1.0, 2.0], device="cuda"))
    got = [paddle.cond(a.sum() > 2, lambda: a * 2, lambda: a - 1),
           paddle.case([(a.sum() < 0, lambda: a - 10),
                        (a.sum() < 10, lambda: a * 3)],
                       default=lambda: a + 100),
           paddle.switch_case(paddle.to_tensor(torch.tensor(3,
                                                            device="cuda")),
                              {1: lambda: a * 10, 3: lambda: a * 30},
                              default=lambda: -a)]
    want = [[2.0, 4.0], [3.0, 6.0], [30.0, 60.0]]
    out["eager_cond_case_switch"] = [g.numpy().tolist() for g in got]
    if out["eager_cond_case_switch"] != want or any(
            g.device.type != "cuda" for g in got):
        raise AssertionError(f"eager control flow {out}")
    # a static Program with cond and while_loop, card against CPU
    fetched = {}
    for where in ("cpu", "gpu"):
        paddle.set_device(where)
        try:
            fetched[where] = _static_decode_runs(paddle)
        finally:
            paddle.core.placement.set_default(None)
    out["static_decode"] = {k: [[np.asarray(f).tolist() for f in run]
                                for run in v] for k, v in fetched.items()}
    for rc, rg in zip(fetched["cpu"], fetched["gpu"]):
        for u, v in zip(rc, rg):
            if not np.array_equal(u, v):
                raise AssertionError(f"static control flow card vs CPU: "
                                     f"{out['static_decode']}")
    # the sequence ops, card against CPU
    out["sequence_ops_max_err"] = _sequence_card_vs_cpu(np, torch, paddle,
                                                        SEQ)
    bad = {k: v for k, v in out["sequence_ops_max_err"].items()
           if not v <= tol}
    out["hand_kernel_launches"] = dict(support.launch_counts)
    log("CONTROL_FLOW_SEQUENCE " + json.dumps(out))
    if bad:
        raise AssertionError(f"sequence ops card vs CPU: {bad}")
    if any(support.launch_counts.values()):
        raise AssertionError(f"hand kernels launched: "
                             f"{support.launch_counts}")


def _static_decode_runs(paddle, eos=0, maxlen=8):
    """tests/test_control_flow.py's dynamic decode as a static program
    (the start token from a feed, so the loop is a node) and a cond on a
    feed's sum, run by one Executor for three feeds."""
    import numpy as np
    paddle.enable_static()
    try:
        main = paddle.static.Program()
        with paddle.static.program_guard(main):
            seed = paddle.static.data("seed", [], "int64")
            x = paddle.static.data("x", [None, 4], "float32")

            def cond(t, tok, out):
                return paddle.logical_and(t < maxlen,
                                          paddle.logical_not(tok == eos))

            def body(t, tok, out):
                nxt = paddle.mod(tok * 3 + seed,
                                 paddle.full([], 5, dtype="int64"))
                out = paddle.scatter(out, t.reshape([1]),
                                     nxt.reshape([1, 1]).astype("float32"))
                return t + 1, nxt, out

            t, _, buf = paddle.static.nn.while_loop(
                cond, body, [paddle.zeros([], dtype="int64"), seed * 0 + 3,
                             paddle.full([maxlen, 1], -1.0)])
            y = paddle.static.nn.cond(x.sum() > 0, lambda: x * 2,
                                      lambda: x - 1)
    finally:
        paddle.disable_static()
    exe = paddle.static.Executor()
    return [exe.run(main, feed={"seed": np.array(s, np.int64),
                                "x": sign * np.ones((3, 4), np.float32)},
                    fetch_list=[t, buf, y])
            for s, sign in ((1, 1.0), (2, -1.0), (4, 1.0))]


def _sequence_card_vs_cpu(np, torch, paddle, SEQ):
    """Each sequence op, and the LSTM classifier (test_text_e2e.py's:
    an LSTM over embeddings averaged by ``sequence_pool``), on the card
    and on the CPU: max |card - CPU| / max(1, max |CPU|)."""
    rs = np.random.RandomState(38)
    x = rs.randn(4, 6, 3).astype(np.float32)
    lens = np.array([3, 6, 1, 0], np.int64)
    flat = rs.randn(10, 3).astype(np.float32)
    ids = rs.randint(0, 9, (4, 6)).astype(np.int64)
    w = rs.randn(9, 5).astype(np.float32)
    cases = {
        **{f"pool_{m}": (lambda m: lambda t, S: S.sequence_pool(
            t(x), t(lens), m))(m) for m in ("sum", "average", "sqrt", "max",
                                              "first", "last")},
        "pad": lambda t, S: S.sequence_pad(t(flat), t(np.array([3, 6, 1])),
                                           maxlen=6)[0],
        "softmax": lambda t, S: S.sequence_softmax(t(x[:, :, 0]), t(lens)),
        "reverse": lambda t, S: S.sequence_reverse(t(x), t(lens)),
        "expand_as": lambda t, S: S.sequence_expand_as(t(x[:, 0]), t(lens),
                                                       5),
        "concat": lambda t, S: S.sequence_concat([t(x), t(x)],
                                                 [t(lens), t(lens)])[0],
        "slice": lambda t, S: S.sequence_slice(t(x), t(np.array([1, 0, 0,
                                                                  0])),
                                               t(np.array([2, 3, 1, 0])))[0],
        "erase": lambda t, S: S.sequence_erase(t(ids), [2, 5], t(lens))[0],
        "enumerate": lambda t, S: S.sequence_enumerate(t(ids), 3, -1,
                                                       t(lens)),
        "conv": lambda t, S: S.sequence_conv(t(x), t(lens), t(w)),
        "mask": lambda t, S: S.sequence_mask(t(lens), 6),
    }
    out = {}
    for name, fn in cases.items():
        got = [fn(lambda a, d=d: paddle.to_tensor(a, place=d), SEQ).numpy()
               .astype(np.float64) for d in ("cpu", "cuda")]
        out[name] = float(np.abs(got[1] - got[0]).max()
                          / max(1.0, np.abs(got[0]).max()))
    # the IMDB LSTM classifier's forward
    rs = np.random.RandomState(39)
    vocab, emb, hidden = 50, 32, 32
    params = None
    logits = []
    for where, dev in (("cpu", "cpu"), ("gpu", "cuda")):
        prev = paddle.core.placement.default()
        paddle.set_device(where)
        try:
            layers = [paddle.nn.Embedding(vocab, emb),
                      paddle.nn.LSTM(emb, hidden),
                      paddle.nn.Linear(hidden, 2)]
        finally:
            paddle.core.placement.set_default(prev)
        flat_params = [p for layer in layers for p in layer.parameters()]
        if params is None:
            params = [rs.uniform(-0.2, 0.2, tuple(p.shape)).astype(
                np.float32) for p in flat_params]
        for p, v in zip(flat_params, params):
            p.set_value(v)
        tok = paddle.to_tensor(ids, place=dev)
        o, _ = layers[1](layers[0](tok))
        full = paddle.to_tensor(np.full((4,), 6, np.int64), place=dev)
        logits.append(layers[2](SEQ.sequence_pool(o, full, "average"))
                      .numpy())
    out["lstm_classifier"] = float(np.abs(logits[1] - logits[0]).max()
                                   / max(1.0, np.abs(logits[0]).max()))
    return out


# --------------------------------------------------------------- phase 39
NMT_CHIP = dict(vocab=37000, d_model=512, heads=8, enc_layers=6,
                dec_layers=6, ffn=2048, dropout=0.1, batch=64, src_len=64,
                tgt_len=64, warmup_steps=4000, epsilon=0.1)
NMT_SMALL = dict(vocab=500, d_model=64, heads=4, enc_layers=2,
                 dec_layers=2, ffn=256, dropout=0.0, batch=8, src_len=12,
                 tgt_len=10, warmup_steps=4, epsilon=0.1)
NMT_BOS = 1
# incremental logits (flash at one query over the caches) against the
# full forward's (the unfused masked self-attention), f32, relative to
# max(1, max |logit|)
NMT_DECODE_TOL = 1e-4
BEAM = dict(beam=4, batch=20, steps=35, small_steps=16)


def _nmt_model(cfg, device):
    from paddle_tpu_torch.testing.models import TransformerNMT
    return TransformerNMT(cfg["vocab"], cfg["d_model"], cfg["heads"],
                          cfg["enc_layers"], cfg["dec_layers"], cfg["ffn"],
                          cfg["dropout"],
                          max_len=max(cfg["src_len"], cfg["tgt_len"]),
                          device=device)


def _nmt_step(paddle, model, cfg):
    """One training step a call: ``TrainStep`` of Adam (beta 0.9 / 0.98,
    epsilon 1e-9) under ``NoamDecay(d_model, warmup_steps)``, with the
    label-smoothed cross entropy; the schedule steps after each."""
    from paddle_tpu_torch.testing.models import nmt_loss
    sched = paddle.optimizer.lr.NoamDecay(cfg["d_model"],
                                          cfg["warmup_steps"], 1.0)
    opt = paddle.optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                                epsilon=1e-9, parameters=model.parameters())
    step = paddle.jit.TrainStep(model, nmt_loss(cfg["vocab"],
                                                cfg["epsilon"]),
                                opt, n_inputs=2)

    def one_step(src, tgt_in, tgt_out):
        loss = step(src, tgt_in, tgt_out)
        sched.step()
        return loss
    return one_step


def _nmt_batches(np, paddle, cfg, n, seed, device):
    """``n`` (src, tgt_in, tgt_out) batches of Zipf-drawn ids (p
    proportional to 1 / rank) over the shared vocabulary, no padding."""
    V = cfg["vocab"]
    p = 1.0 / np.arange(1, V + 1)
    p /= p.sum()
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        src = rs.choice(V, size=(cfg["batch"], cfg["src_len"]), p=p)
        tgt = rs.choice(V, size=(cfg["batch"], cfg["tgt_len"] + 1), p=p)
        out.append(tuple(paddle.to_tensor(a.astype(np.int64), place=device)
                         for a in (src, tgt[:, :-1], tgt[:, 1:])))
    return out


def phase_nmt_small_parity(steps=3):
    """The small translation model (2 + 2 layers, d 64, 4 heads, vocab
    500, dropout 0) on the card against the CPU from the same weights: a
    greedy decode (ids equal, logits within ``TOL``), one forward and
    backward (every gradient within ``TOL`` of the largest), then 3
    ``TrainStep``s (losses within ``TOL``).  Its head dim, 16, is not
    one the flash kernels are built for, so the gate sends every
    attention to the unfused path on both sides: no launch (phases 40,
    41 and 43 hold the kernels at the model's own shapes)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import greedy_decode, nmt_loss
    cfg = NMT_SMALL
    paddle.seed(39)
    cpu_model = _nmt_model(cfg, "cpu")
    weights = {k: v.detach().clone()
               for k, v in cpu_model.state_dict().items()}
    res = {}
    support.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        model = cpu_model if dev == "cpu" else _nmt_model(cfg, "cuda")
        if dev == "cuda":
            model.set_state_dict({k: v.to("cuda")
                                  for k, v in weights.items()})
        batches = _nmt_batches(np, paddle, cfg, steps, 390, dev)
        toks, logits = greedy_decode(model, batches[0][0], cfg["tgt_len"],
                                     NMT_BOS)
        src, tgt_in, tgt_out = batches[0]
        nmt_loss(cfg["vocab"])(model(src, tgt_in), tgt_out).backward()
        grads = {k: p.grad.detach().cpu().numpy()
                 for k, p in model.named_parameters()}
        model.clear_gradients()
        one_step = _nmt_step(paddle, model, cfg)
        losses = [float(one_step(*b)) for b in batches]
        res[dev] = (toks.numpy(), logits.numpy(), grads, losses)
    torch.cuda.synchronize()
    launches = dict(support.launch_counts)
    (tc, lc, gc_, sc), (tg, lg, gg, sg) = res["cpu"], res["cuda"]
    tol = TOL["float32"]
    g_scale = max(float(np.abs(g).max()) for g in gc_.values())
    grad_err = max(float(np.abs(gg[k] - gc_[k]).max()) for k in gc_) / g_scale
    logit_err = float(np.abs(lg - lc).max()) / max(1.0, float(
        np.abs(lc).max()))
    loss_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(sg, sc))
    out = {"config": cfg, "tol": tol, "tokens_equal": bool(
        np.array_equal(tg, tc)), "logits_max_rel_err": logit_err,
        "grad_max_err_over_largest": grad_err, "losses_cpu": sc,
        "losses_card": sg, "loss_max_rel_err": loss_err,
        "flash_launches": launches}
    log("NMT_SMALL_PARITY " + json.dumps(out))
    if not (out["tokens_equal"] and logit_err <= tol and grad_err <= tol
            and loss_err <= tol):
        raise AssertionError(f"translation model card vs CPU: {out}")
    if launches:                     # head dim 16: outside the kernels' set
        raise AssertionError(f"flash launches {launches}, want none")


# --------------------------------------------------------------- phase 40
def _device_ms_per_launch(torch, fn, iters, match):
    """Mean device time (ms) of the launches of kernels named ``match``
    that a profile of ``iters`` calls of ``fn`` recorded (the tracer may
    drop some; None when it caught none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and match in e.key:
            total += e.self_device_time_total
            count += e.count
    del prof
    gc.collect()
    return total / count / 1e3 if count else None


def _flash_decode_rows(torch, gen, B, H, D, lks):
    """The f32 flash forward at one query against ``Lk`` keys (an
    incremental decode's attention), no dropout: against the plain
    version, timed beside its bound and SDPA's memory-efficient
    backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from paddle_tpu_torch.ops.cuda import flash_attention_fwd
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_reference_fwd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = 1.0 / math.sqrt(D)
    rows = []
    for lk in lks:
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda")
        k, v = (torch.randn((B, lk, H, D), generator=gen, device="cuda")
                for _ in range(2))
        out, lse = flash_attention_fwd(q, k, v, scale=scale)
        t = lambda x: x.transpose(1, 2)                  # noqa: E731
        ro, rlse = flash_attention_reference_fwd(t(q), t(k), t(v),
                                                 scale=scale)
        err = max(float((t(out) - ro).abs().max()
                        / ro.abs().max().clamp_min(1.0)),
                  float((lse - rlse).abs().max()
                        / rlse.abs().max().clamp_min(1.0)))
        ms = cuda_ms(lambda i: flash_attention_fwd(q, k, v, scale=scale),
                     50)
        plain = cuda_ms(lambda i: flash_attention_reference_fwd(
            t(q), t(k), t(v), scale=scale), 20)
        qt, kt, vt = (t(x).contiguous() for x in (q, k, v))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            lib = cuda_ms(lambda i: sdpa(qt, kt, vt), 50)
        dev_ms = _device_ms_per_launch(
            torch, lambda: flash_attention_fwd(q, k, v, scale=scale), 20,
            "flash_fwd")
        bound_ms, bound_by, nbytes, ops = _flash_bound(
            B, H, 1, lk, D, 4, "float32", False, "flash_attention_fwd")
        row = {"kernel": "flash_attention_fwd", "case": f"B={B} Lq=1 "
               f"Lk={lk} H={H} D={D} float32", "max_abs_err": err,
               "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
               "bound_ms": bound_ms,
               "bound_by": bound_by, "share_of_bound": bound_ms / ms,
               "share_of_bound_by_device_ms": (bound_ms / dev_ms
                                               if dev_ms else None),
               "library_ms": lib, "library_call":
                   "scaled_dot_product_attention, memory-efficient "
                   "backend"}
        log("KERNEL " + json.dumps(row))
        if not err <= FLASH_TOL["float32"]:
            raise AssertionError(f"flash forward at Lq 1: {row}")
        rows.append(row)
    return rows


def phase_nmt_flash_kernels():
    """K1f and K1b at Transformer-base's training shape (B 64, Lq = Lk
    = 64, H 8, D 64, f32, dropout 0.1; the encoder's self-attention and
    the cross-attention) against their plain versions and timed beside
    SDPA; K1f at one query against 1, 37 and 64 keys (decoding)."""
    import torch
    cfg = NMT_CHIP
    gen = torch.Generator(device="cuda")
    gen.manual_seed(40)
    B, L, H = cfg["batch"], cfg["src_len"], cfg["heads"]
    D = cfg["d_model"] // H
    errs = _flash_case(torch, gen, B, L, H, D, torch.float32, False,
                       cfg["dropout"], 4040, B)
    log("FLASH_CHECK " + json.dumps({
        "case": f"B={B} L={L} H={H} D={D} float32 dropout="
                f"{cfg['dropout']}", "errors": errs,
        "tol": FLASH_TOL["float32"]}))
    if not max(errs.values()) <= FLASH_TOL["float32"]:
        raise AssertionError(f"flash kernels at the NMT shape: {errs}")
    rows = _flash_time_rows(torch, gen, B, L, H, D, torch.float32, False,
                            cfg["dropout"], 4040)
    for row in rows.values():
        row["max_abs_err"] = max(errs.values())
    decode = _flash_decode_rows(torch, gen, B, H, D, (1, 37, 64))
    torch.cuda.empty_cache()
    return rows, decode


# --------------------------------------------------------------- phase 41
def phase_nmt_training(warmup=2, steps=10):
    """Transformer-base (Vaswani et al. 2017, Table 3 "base"): 6 + 6
    layers, d_model 512, 8 heads, FFN 2048, dropout 0.1, shared vocab
    37000 with the tied head, label smoothing 0.1, Adam (0.9, 0.98,
    1e-9) under NoamDecay(512, 4000), 64 pairs of 64 + 64 Zipf-drawn
    tokens, f32 with TF32 off: 2 warm-up and 10 timed steps, every loss
    finite, the first near ln(vocab), and per step 12 flash forwards, 12
    dQ and 12 dK/dV (6 encoder self-attentions and 6 cross-attentions;
    the decoder's masked self-attention takes the unfused path)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import nmt_flops_per_step
    cfg = NMT_CHIP
    paddle.seed(41)
    t0 = time.perf_counter()
    model = _nmt_model(cfg, "cuda")
    one_step = _nmt_step(paddle, model, cfg)
    batches = _nmt_batches(np, paddle, cfg, warmup + steps, 410, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    support.reset_launch_counts()
    runs = [_clocked_step(torch, lambda b=b: one_step(*b)) for b in batches]
    losses = [float(loss) for loss, _ in runs]
    step_ms = [ms for _, ms in runs]
    counts = {n: support.launch_counts.get(n, 0) for n in FLASH_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    timed = step_ms[warmup:]
    mean = sum(timed) / len(timed)
    flops = nmt_flops_per_step(cfg["vocab"], cfg["d_model"],
                               cfg["enc_layers"], cfg["dec_layers"],
                               cfg["ffn"], cfg["batch"], cfg["src_len"],
                               cfg["tgt_len"])
    uniform = math.log(cfg["vocab"])
    out = {"config": cfg, "dtype": "float32, TF32 off",
           "params": sum(p.numel() for p in model.parameters()),
           "setup_s": setup_s, "warmup_steps": warmup, "timed_steps": steps,
           "losses": losses, "smoothed_uniform_loss": uniform,
           "step_ms": timed, "step_ms_p50": float(np.median(timed)),
           "step_ms_mean": mean, "first_steps_ms": step_ms[:warmup],
           "target_tokens_per_s": cfg["batch"] * cfg["tgt_len"]
           / (mean / 1e3),
           "model_flops_per_step": flops,
           "mfu": flops / (mean / 1e3) / PEAK_OPS["float32"],
           "peak_bound_ms": flops / PEAK_OPS["float32"] * 1e3,
           "max_memory_allocated": peak, "flash_launches": counts,
           "nvidia_smi": nvidia_smi()}
    log("NMT_TRAIN " + json.dumps(out))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    # the tied head's logits start with unit variance: ln V + 1/2 expected
    if abs(losses[0] - uniform) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not near the "
                             f"smoothed uniform loss {uniform}")
    want = (cfg["enc_layers"] + cfg["dec_layers"]) * len(runs)
    if any(c != want for c in counts.values()):
        raise AssertionError(f"flash launches {counts}, want {want} each "
                             f"(the encoder's and the cross-attentions)")
    return model, one_step, batches, timed, counts


# --------------------------------------------------------------- phase 42
def _nmt_is_attention(e, heads):
    """A forward op of the unfused masked attention: inside an einsum,
    a softmax, or an op on the [B, H, Lq, Lk] scores."""
    p = e
    while p is not None:
        if p.name == "aten::einsum":
            return True
        p = p.cpu_parent
    if "softmax" in e.name:
        return True
    return any(len(s) == 4 and s[1] == heads and s[2] == s[3]
               for s in (e.input_shapes or []) if isinstance(s, list))


def _nmt_scope(e):
    p = e
    while p is not None:
        if p.name.startswith("nmt."):
            return p.name[4:]
        p = p.cpu_parent
    return None


def _nmt_parts(prof, steps, heads):
    """Device ms a step by part, kernel by kernel: the flash kernels;
    the unfused masked attention and the head and loss, forward and
    backward (a backward node's kernels go to the part of the forward op
    with its sequence number); the other GEMMs; Adam; the rest."""
    events = prof.events()
    fwd = {}
    for e in events:
        scope = _nmt_scope(e)
        if e.sequence_nr < 0 or scope not in ("forward", "head_loss"):
            continue
        part = ("head_and_loss" if scope == "head_loss" else
                "masked_attention" if _nmt_is_attention(e, heads) else None)
        if part is not None or e.sequence_nr not in fwd:
            fwd[e.sequence_nr] = part or fwd.get(e.sequence_nr)
    groups = {}
    for e in events:
        for k in e.kernels:
            name = k.name.lower()
            scope = _nmt_scope(e)
            if "flash_" in name:
                part = "flash"
            elif scope == "optimizer":
                part = "adam"
            elif scope in ("forward", "head_loss"):
                part = ("head_and_loss" if scope == "head_loss" else
                        "masked_attention" if _nmt_is_attention(e, heads)
                        else None)
            else:
                p, part = e, None
                while p is not None and part is None:
                    if "Backward" in p.name and p.sequence_nr >= 0:
                        part = fwd.get(p.sequence_nr)
                        break
                    p = p.cpu_parent
            if part is None:
                part = "gemm" if _is_gemm(name) else "other"
            groups[part] = groups.get(part, 0.0) + k.duration / 1e3 / steps
    return groups


def phase_nmt_anatomy(model, one_step, batches, timed_ms, steps=2):
    """Anatomy of one Transformer-base step: busy ms by kernel group, the
    idle share and the flash launches a step by name from the trace (12
    of each f32 kernel); then busy ms by part (cuBLAS GEMMs, flash, the
    unfused masked attention, the head and loss, Adam's foreach, the
    rest) over a step run in ``record_function`` parts."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.testing.models import nmt_loss
    cfg = NMT_CHIP
    b = batches[0]
    launches = _step_anatomy("NMT_ANATOMY", lambda: one_step(*b), steps,
                             lambda n: (
        "flash_fwd" if "flash_fwd_" in n else
        "flash_bwd" if "flash_bwd_" in n else
        "gemm" if _is_gemm(n) else
        "adam_foreach" if "foreach" in n or "multi_tensor" in n else
        "softmax" if "softmax" in n else "other"), timed_ms=timed_ms)
    flash = {k: v for k, v in launches.items() if k.startswith("flash_")}
    unmasked = cfg["enc_layers"] + cfg["dec_layers"]
    want = {"flash_fwd_f32_kernel": unmasked,
            "flash_bwd_dq_f32_kernel": unmasked,
            "flash_bwd_dkv_f32_kernel": unmasked}
    if flash != want:
        raise AssertionError(f"flash launches a step in the trace {flash}, "
                             f"want {want}")
    opt = paddle.optimizer.Adam(learning_rate=1e-9, beta1=0.9, beta2=0.98,
                                epsilon=1e-9, parameters=model.parameters())
    loss_fn = nmt_loss(cfg["vocab"], cfg["epsilon"])
    src, tgt_in, tgt_out = b
    mask = paddle.nn.Transformer.generate_square_subsequent_mask(
        cfg["tgt_len"], device="cuda")

    def parts():
        with record_function("nmt.forward"):
            h = model.transformer(model.embed(src), model.embed(tgt_in),
                                  tgt_mask=mask)
        with record_function("nmt.head_loss"):
            loss = loss_fn(model.logits(h), tgt_out)
        with record_function("nmt.backward"):
            loss.backward()
        with record_function("nmt.optimizer"):
            opt.step()
            opt.clear_grad()

    parts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(steps):
            parts()
        torch.cuda.synchronize()
    groups = _nmt_parts(prof, steps, cfg["heads"])
    del prof, opt
    gc.collect()
    torch.cuda.empty_cache()
    out = {"device_ms_by_part": groups,
           "device_ms_total": sum(groups.values()),
           "flash_launches_per_step": flash, "nvidia_smi": nvidia_smi()}
    log("NMT_ANATOMY_PARTS " + json.dumps(out))
    if not groups.get("masked_attention", 0) > 0:
        raise AssertionError("no unfused masked attention in the trace")


# --------------------------------------------------------------- phase 43
def phase_nmt_decode(model, n_tokens=64):
    """Greedy incremental decoding of Transformer-base for 64 source
    sentences of 64 tokens, 64 steps: ms a token (a decode step of the
    batch), tokens/s, host syncs and flash launches a token (two a
    decoder layer: the self-attention at one query over its cache, the
    cross-attention over the source); the incremental logits against the
    full forward's at every position (``NMT_DECODE_TOL``)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import greedy_decode
    cfg = NMT_CHIP
    src = _nmt_batches(np, paddle, cfg, 1, 430, "cuda")[0][0]
    greedy_decode(model, src, 4, NMT_BOS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks, logits = greedy_decode(model, src, n_tokens, NMT_BOS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    syncs = _host_syncs(torch, lambda: greedy_decode(model, src, 8,
                                                     NMT_BOS))
    support.reset_launch_counts()
    greedy_decode(model, src, 8, NMT_BOS)
    torch.cuda.synchronize()
    counts = dict(support.launch_counts)
    per_token = (counts.get("flash_attention_fwd", 0)
                 - cfg["enc_layers"]) / 8
    tgt_in = paddle.concat([paddle.zeros_like(src[:, :1]) + NMT_BOS,
                            toks[:, :-1]], axis=1)
    model.eval()
    with torch.no_grad():
        full = model(src, tgt_in)
    model.train()
    err = float((logits - full).abs().max()) / max(1.0, float(
        full.abs().max()))
    agree = float((full.argmax(-1) == toks).float().mean())
    out = {"batch": cfg["batch"], "tokens": n_tokens, "seconds": dt,
           "ms_per_token": dt / n_tokens * 1e3,
           "tokens_per_s": cfg["batch"] * n_tokens / dt,
           "host_syncs_per_token": len(syncs) / 8,
           "flash_fwd_launches_per_token": per_token,
           "launches_8_tokens": counts,
           "incremental_vs_full_max_rel_err": err, "tol": NMT_DECODE_TOL,
           "argmax_of_full_equals_tokens": agree,
           "nvidia_smi": nvidia_smi()}
    log("NMT_DECODE " + json.dumps(out))
    del logits, full
    torch.cuda.empty_cache()
    if not err <= NMT_DECODE_TOL:
        raise AssertionError(f"incremental logits vs full forward: {out}")
    if per_token != 2 * cfg["dec_layers"] or set(counts) != {
            "flash_attention_fwd"}:
        raise AssertionError(f"decode launches {counts}")
    return counts.get("flash_attention_fwd", 0)


# --------------------------------------------------------------- phase 44
def _ptb_beam_decoder(paddle, model, start, end, beam):
    """``BeamSearchDecoder`` over the PTB LM: its two LSTM layers as one
    cell (LSTMCells sharing their weights; states ``[(h1, c1), (h2,
    c2)]``), the embedding as ``embedding_fn`` and the head as
    ``output_fn``."""
    H = model.cfg["hidden"]
    cells = []
    for lstm in (model.lstm1, model.lstm2):
        cell = paddle.nn.LSTMCell(H, H, device=lstm.weight_ih_l0.device)
        for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            setattr(cell, k, getattr(lstm, f"{k}_l0"))
        cells.append(cell)

    def cell(inp, states):
        (h1, c1), (h2, c2) = states
        o1, (h1, c1) = cells[0](inp, (h1, c1))
        o2, (h2, c2) = cells[1](o1, (h2, c2))
        return o2, [(h1, c1), (h2, c2)]

    return paddle.nn.BeamSearchDecoder(cell, start, end, beam,
                                       embedding_fn=model.embedding,
                                       output_fn=model.head)


def _beam_inits(torch, paddle, B, H, device):
    z = paddle.to_tensor(torch.zeros((B, H)), place=device)
    return [(z, z), (z, z)]


def _rescore(torch, paddle, dec, inits, seq, lens):
    """Each returned beam's log-probability, re-read by feeding its
    backtracked tokens through ``cell_step``: a beam's score if the
    backtrack is right."""
    B, K, T = seq.shape
    states = [(torch.repeat_interleave(h, K, 0),
               torch.repeat_interleave(c, K, 0)) for h, c in inits]
    flat, n = torch.reshape(seq, (B * K, T)), torch.reshape(lens, (-1,))
    tok = torch.full((B * K,), dec.start_token, dtype=torch.int64,
                     device=seq.device)
    total = torch.zeros(B * K, device=seq.device)
    for t in range(T):
        logp, states = paddle.nn.cell_step(dec, tok, states)
        pick = torch.gather(logp, 1, flat[:, t:t + 1])[:, 0]
        total = total + torch.where(t < n, pick, torch.zeros_like(pick))
        tok = flat[:, t]
    return torch.reshape(total, (B, K))


def phase_ptb_beam_search(model, weights_small):
    """``dynamic_decode`` with ``BeamSearchDecoder`` (beam 4) over phase
    36's PTB-large model, batch 20, 35 steps: tokens/s and host syncs a
    step; at phase 35's small widths the card's ids, lengths and scores
    against the CPU's, each beam's score re-read along its backtracked
    tokens, and ``gather_tree`` on a random trellis against a host
    backtrack."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.cuda import support
    support.reset_launch_counts()
    cfg, K = model.cfg, BEAM["beam"]
    B, T, H = BEAM["batch"], BEAM["steps"], cfg["hidden"]
    dec = _ptb_beam_decoder(paddle, model, 1, cfg["vocab"] - 1, K)
    inits = _beam_inits(torch, paddle, B, H, "cuda")
    paddle.nn.dynamic_decode(dec, inits, max_step_num=4)
    torch.cuda.synchronize()
    t = time.perf_counter()
    seq, scores, lens = paddle.nn.dynamic_decode(dec, inits, max_step_num=T,
                                                 return_length=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    steps_run = int(lens.max())
    syncs = _host_syncs(torch, lambda: paddle.nn.dynamic_decode(
        dec, inits, max_step_num=8))
    with torch.no_grad():
        rescored = _rescore(torch, paddle, dec, inits, seq, lens)
    full = {"batch": B, "beam": K, "max_steps": T, "steps_run": steps_run,
            "seconds": dt, "steps_per_s": steps_run / dt,
            "tokens_per_s": B * steps_run / dt,
            "beam_tokens_per_s": B * K * steps_run / dt,
            "host_syncs_per_step": len(syncs) / 8,
            "shape": list(seq.shape),
            "rescored_max_abs_err": float((rescored - scores).abs().max()),
            "scores_sorted": bool((scores[:, :-1] >= scores[:, 1:]).all())}
    # the small widths, card against CPU
    res = {}
    for where, dev in (("cpu", "cpu"), ("gpu", "cuda")):
        m = _ptb_on(paddle, where, PTB_SMALL, weights_small)
        d = _ptb_beam_decoder(paddle, m, 1, 0, K)
        ini = _beam_inits(torch, paddle, PTB_SMALL["batch"],
                          PTB_SMALL["hidden"], dev)
        s, sc, ln = paddle.nn.dynamic_decode(
            d, ini, max_step_num=BEAM["small_steps"], return_length=True)
        with torch.no_grad():
            rs_ = _rescore(torch, paddle, d, ini, s, ln)
        res[where] = (s.numpy(), sc.numpy(), ln.numpy(), rs_.cpu().numpy())
    (sc_, scc, lc, rc), (sg, scg, lg, rg) = res["cpu"], res["gpu"]
    small = {"ids_equal": bool(np.array_equal(sg, sc_)),
             "lengths_equal": bool(np.array_equal(lg, lc)),
             "scores_max_abs_err": float(np.abs(scg - scc).max()),
             "rescored_max_abs_err": float(np.abs(rg - scg).max()),
             "finished_beams": int((lg < BEAM["small_steps"]).sum())}
    # gather_tree on the card against a host backtrack
    rs = np.random.RandomState(44)
    Tt, Bt, Kt = 9, 5, 4
    ids = rs.randint(0, 100, (Tt, Bt, Kt)).astype(np.int64)
    par = rs.randint(0, Kt, (Tt, Bt, Kt)).astype(np.int64)
    got = paddle.nn.gather_tree(paddle.to_tensor(ids, place="cuda"),
                                paddle.to_tensor(par, place="cuda")).numpy()
    ref = np.zeros_like(ids)
    for b in range(Bt):
        for k in range(Kt):
            beam = k
            for t in range(Tt - 1, -1, -1):
                ref[t, b, k] = ids[t, b, beam]
                beam = par[t, b, beam]
    small["gather_tree_equal"] = bool(np.array_equal(got, ref))
    out = {"full_width": full, "small_card_vs_cpu": small,
           "hand_kernel_launches": dict(support.launch_counts),
           "nvidia_smi": nvidia_smi()}
    log("PTB_BEAM_SEARCH " + json.dumps(out))
    tol = 1e-4
    if not (full["scores_sorted"] and full["rescored_max_abs_err"] <= tol
            and list(seq.shape) == [B, K, T]):
        raise AssertionError(f"beam search at full width: {full}")
    if not (small["ids_equal"] and small["lengths_equal"]
            and small["scores_max_abs_err"] <= tol
            and small["rescored_max_abs_err"] <= tol
            and small["gather_tree_equal"]):
        raise AssertionError(f"beam search card vs CPU: {small}")
    if any(support.launch_counts.values()):
        raise AssertionError(f"hand kernels launched: "
                             f"{support.launch_counts}")


# --------------------------------------------------------------- phase 45
def _tail_run(np, paddle, dev, fn, inputs, grad, params):
    """``fn(paddle, *tensors)`` on ``dev``: its output and the gradients
    of ``sum(out * w)`` (fixed w) for the inputs at ``grad`` and for
    ``params``."""
    ts = [paddle.to_tensor(a, place=dev, stop_gradient=i not in grad)
          for i, a in enumerate(inputs)]
    out = fn(paddle, *ts)
    res = [out.numpy()]
    if grad or params:
        w = np.asarray(np.random.RandomState(7).randn(*res[0].shape),
                       np.float32)
        (out * paddle.to_tensor(w, place=dev)).sum().backward()
        res += [ts[i].grad.numpy() for i in grad]
        res += [p.grad.numpy() for p in params]
    return res


def phase_nn_tail():
    """Each case of ``testing.nn_tail_cases`` (the functions and layers
    of ``nn.functional``'s and ``nn``'s tail, the CPU tests' parity
    cases) once on the card against the CPU, forward and backward,
    within ``TOL`` of the largest value (CTC 1e-4: its CUDA backward
    sums with atomics); the random ones on the card by statistics
    (whole channels dropped, alpha dropout's unit moments, gumbel rows
    summing to 1 and a hard one-hot)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import placement
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.nn_tail_cases import (function_cases,
                                                        layer_cases)
    support.reset_launch_counts()
    errs = {}
    cases = [(n, fn, x, g, None) for n, fn, x, g in function_cases()]
    cases += [(n, None, x, g, make) for n, make, x, g in layer_cases()]
    for name, fn, inputs, grad, make in cases:
        res, sd = {}, None
        for where, dev in (("cpu", "cpu"), ("gpu", "cuda")):
            prev = placement.default()
            paddle.set_device(where)
            try:
                params = []
                if make is not None:
                    lyr = make(paddle.nn)
                    if sd is None:
                        sd = {k: v.detach().clone()
                              for k, v in lyr.state_dict().items()}
                    else:
                        lyr.set_state_dict({k: v.to(dev)
                                            for k, v in sd.items()})
                    params = [p for _, p in sorted(lyr.named_parameters())]
                    fn = (lambda lyr: lambda p, *t: lyr(*t))(lyr)
                res[where] = _tail_run(np, paddle, dev, fn, inputs, grad,
                                       params)
            finally:
                placement.set_default(prev)
        scale = max(1.0, max(float(np.abs(r).max()) for r in res["cpu"]
                             if r.size))
        errs[name] = max(float(np.abs(a - b).max()) if a.size else 0.0
                         for a, b in zip(res["gpu"], res["cpu"])) / scale
    tol = {n: 1e-4 if "CTC" in n or "ctc" in n else TOL["float32"]
           for n in errs}
    F = paddle.nn.functional
    stats = {}
    x = paddle.to_tensor(torch.ones((64, 32, 3, 4), device="cuda"))
    ch = F.dropout2d(x, 0.25).reshape([64, 32, -1])
    stats["dropout2d_whole_channels"] = bool(
        (ch.amax(-1) == ch.amin(-1)).all())
    stats["dropout2d_kept"] = float((ch[..., 0] != 0).float().mean())
    ch3 = F.dropout3d(paddle.to_tensor(torch.ones((16, 8, 2, 3, 4),
                                                  device="cuda")),
                      0.5).reshape([16, 8, -1])
    stats["dropout3d_whole_channels"] = bool(
        (ch3.amax(-1) == ch3.amin(-1)).all())
    g = torch.Generator(device="cuda")
    g.manual_seed(45)
    z = paddle.to_tensor(torch.randn((200, 500), generator=g,
                                     device="cuda"))
    a = F.alpha_dropout(z, 0.2)
    stats["alpha_dropout_mean"] = float(a.mean())
    stats["alpha_dropout_var"] = float(a.var())
    soft = F.gumbel_softmax(paddle.to_tensor(torch.zeros((1000, 4),
                                                         device="cuda")))
    hard = F.gumbel_softmax(paddle.to_tensor(torch.zeros((1000, 4),
                                                         device="cuda")),
                            hard=True)
    stats["gumbel_rows_sum_to_1"] = float((soft.sum(-1) - 1).abs().max())
    stats["gumbel_hard_one_hot"] = bool(((hard == 0) | (hard == 1)).all()
                                        and (hard.sum(-1) == 1).all())
    helpers = F.np_asarray(z[:1, :2]).shape == (1, 2) and (
        type(F.as_array(z)) is torch.Tensor) and isinstance(F.next_key(),
                                                            int)
    out = {"max_err_over_largest": errs, "tol": tol, "random": stats,
           "helpers_ok": helpers, "cases": len(errs),
           "hand_kernel_launches": dict(support.launch_counts)}
    log("NN_TAIL " + json.dumps(out))
    bad = {n: e for n, e in errs.items() if not e <= tol[n]}
    if bad:
        raise AssertionError(f"card vs CPU: {bad}")
    if not (stats["dropout2d_whole_channels"]
            and stats["dropout3d_whole_channels"]
            and abs(stats["dropout2d_kept"] - 0.75) < 0.05
            and abs(stats["alpha_dropout_mean"]) < 0.02
            and abs(stats["alpha_dropout_var"] - 1) < 0.03
            and stats["gumbel_rows_sum_to_1"] < 1e-5
            and stats["gumbel_hard_one_hot"] and helpers):
        raise AssertionError(f"random functions on the card: {stats}")


# ----------------------------------------------------------- phases 46-52
# the global state phases 46-52 may touch, snapshotted at each one's start
# and restored in a ``finally``; the snapshot taken after must equal it
def _global_state():
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import framework_compat
    from paddle_tpu_torch.core import placement, profiler_hook, rng
    from paddle_tpu_torch.ops import attention
    return {"flags": paddle.get_flags(),
            "dygraph": framework_compat.in_dygraph_mode(),
            "static_mode": paddle._static_mode,
            "default_dtype": paddle.get_default_dtype(),
            "placement": placement.default(),
            "rng": rng.get_rng_state(),
            "paged_kernel": attention.registered_kernel(),
            "printoptions": _printoptions(np),
            "profiler_hook": profiler_hook.current(),
            "tf32": (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32),
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "obs": _obs_state()}


def _obs_state():
    """The observability hooks a phase may install (tracer, perf,
    crash handler, exporter, SLO monitor, flight recorder) and the
    process hooks the recorder chains to."""
    import signal
    from paddle_tpu_torch.core import obs_hook
    from paddle_tpu_torch.observability import flight, slo
    return (obs_hook._tracer, obs_hook._perf, obs_hook._crash,
            obs_hook._export, slo.get_slo_monitor(),
            flight.flight_recorder_path(),
            signal.getsignal(signal.SIGTERM), sys.excepthook)


def _restore_obs_state(st):
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.core import obs_hook
    obs.uninstall_flight_recorder()
    if obs_hook._export is not None and obs_hook._export is not st[3]:
        obs.uninstall_exporter()
    if obs.get_slo_monitor() is not st[4]:
        if st[4] is None:
            obs.uninstall_slo_monitor()
        else:
            obs.install_slo_monitor(st[4])
    obs_hook.set_tracer(st[0])
    obs_hook.set_perf(st[1])
    obs_hook.set_crash_handler(st[2])
    obs_hook.set_export(st[3])


def _printoptions(np):
    """numpy's print options that ``np.set_printoptions`` takes back."""
    import inspect
    keys = inspect.signature(np.set_printoptions).parameters
    return {k: v for k, v in np.get_printoptions().items() if k in keys}


def _restore_global_state(s):
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import framework_compat
    from paddle_tpu_torch.core import placement, profiler_hook, rng
    from paddle_tpu_torch.ops import attention
    paddle.set_flags(s["flags"])
    (framework_compat.enable_dygraph if s["dygraph"]
     else framework_compat.disable_dygraph)()
    paddle._static_mode = s["static_mode"]
    paddle.set_default_dtype(s["default_dtype"])
    placement.set_default(s["placement"])
    rng.set_rng_state(s["rng"])
    attention.register_paged_attention_kernel(s["paged_kernel"])
    np.set_printoptions(**s["printoptions"])
    profiler_hook.set_active(s["profiler_hook"])
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = s["tf32"]
    torch.backends.cudnn.benchmark = s["cudnn_benchmark"]
    _restore_obs_state(s["obs"])


def _same_state(a, b):
    """Whether two :func:`_global_state` snapshots agree (generator
    states compared by value)."""
    import torch

    def same(x, y):
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            return (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                    and torch.equal(x, y))
        if isinstance(x, dict) and isinstance(y, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (tuple, list)) and isinstance(y, (tuple, list)):
            return len(x) == len(y) and all(map(same, x, y))
        return x is y or x == y
    return {k: same(a[k], b[k]) for k in a}


def _keeps_global_state(fn):
    """Phases 46-61: log the phase's number and name at its start, put
    back every global state it may touch in a ``finally``, and assert
    the snapshot after equals the one before."""
    import functools

    @functools.wraps(fn)
    def phase(*args, **kwargs):
        log(f"PHASE {fn.__doc__.split(':')[0].strip()}")
        before = _global_state()
        try:
            out = fn(*args, **kwargs)
        finally:
            _restore_global_state(before)
        same = _same_state(before, _global_state())
        if not all(same.values()):
            raise AssertionError(f"{fn.__name__} left global state changed: "
                                 f"{sorted(k for k, v in same.items() if not v)}")
        return out
    return phase


def _check(tag, quantities):
    """Print every compared quantity beside its limit, then check:
    ``quantities`` is ``{name: (value, limit)}``, each value at most its
    limit."""
    log(tag + " " + json.dumps({k: {"value": v, "limit": lim}
                                for k, (v, lim) in quantities.items()}))
    bad = {k: (v, lim) for k, (v, lim) in quantities.items()
           if not (isinstance(v, (int, float)) and v <= lim)}
    if bad:
        raise AssertionError(f"{tag}: over the limit: {bad}")


# the CPU tests' tolerances (tests/test_torch_optimizer_tail.py)
OPT_F32_ATOL = 1e-5
OPT_O2_RTOL = 2 ** -7
OPT_O2_STEP_ATOL = 1e-2
TAIL_OPTIMIZERS = {
    "Adamax": ("Adamax", dict(learning_rate=0.01)),
    "Adagrad": ("Adagrad", dict(learning_rate=0.05)),
    "Adadelta": ("Adadelta", dict(learning_rate=1.0)),
    "RMSProp": ("RMSProp", dict(learning_rate=0.01, momentum=0.5)),
    "RMSProp-centered": ("RMSProp", dict(learning_rate=0.01,
                                         centered=True)),
    "Lamb": ("Lamb", dict(learning_rate=0.01)),
    "LarsMomentum": ("LarsMomentum", dict(learning_rate=0.1)),
    "Ftrl": ("Ftrl", dict(learning_rate=0.1, l1=0.01, l2=0.01)),
    "Ftrl-lr_power": ("Ftrl", dict(learning_rate=0.1, l1=0.01,
                                   lr_power=-0.3)),
    "Dpsgd": ("Dpsgd", dict(learning_rate=0.05, clip=0.5, sigma=0.3,
                            batch_size=4.0, seed=3)),
    "ProximalGD": ("ProximalGD", dict(learning_rate=0.05, l1=0.01,
                                      l2=0.01)),
    "ProximalAdagrad": ("ProximalAdagrad", dict(learning_rate=0.05,
                                                l1=0.01, l2=0.01)),
    "DecayedAdagrad": ("DecayedAdagrad", dict(learning_rate=0.05)),
}
OPT_STEPS = 5


def _mlp_pair(paddle, torch):
    """The tests' 6 -> 8 -> 3 tanh MLP on the CPU and on the card, from
    the same seeded weights."""
    paddle.seed(1)
    cpu = paddle.nn.Sequential(paddle.nn.Linear(6, 8), paddle.nn.Tanh(),
                               paddle.nn.Linear(8, 3)).to("cpu")
    gpu = paddle.nn.Sequential(paddle.nn.Linear(6, 8), paddle.nn.Tanh(),
                               paddle.nn.Linear(8, 3)).to("cuda")
    gpu.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()})
    return cpu, gpu


def _mlp_batch(np):
    rs = np.random.RandomState(0)
    return (rs.randn(16, 6).astype(np.float32),
            rs.randn(16, 3).astype(np.float32))


def _fixed_draws(step, n, device):
    """Dpsgd's draws for the card-against-CPU runs: the same numbers on
    both sides (the card's Philox and the CPU's generator differ)."""
    import numpy as np
    import torch
    st = int(step) if not isinstance(step, torch.Tensor) else 0
    rs = np.random.RandomState(1000 + st)
    return torch.from_numpy(rs.randn(n).astype(np.float32)).to(device)


def _tail_opt(paddle, case, params, clip):
    cls, kw = TAIL_OPTIMIZERS[case]
    kw = dict(kw)
    if clip and cls != "Dpsgd":
        kw["grad_clip"] = paddle.optimizer.ClipGradByGlobalNorm(0.5)
    opt = getattr(paddle.optimizer, cls)(parameters=params, **kw)
    if cls == "Dpsgd":
        opt._draw = _fixed_draws
    return opt


def _weights_np(model):
    """The model's weights as f32 numpy copies (a CPU tensor's
    ``numpy()`` would share the parameter's memory)."""
    return {k: v.detach().float().cpu().clone().numpy()
            for k, v in model.state_dict().items()}


def _max_diff(a, b):
    return max(float(abs(a[k] - b[k]).max()) for k in a)


def _dpsgd_draw_stats(paddle, torch):
    """The card's own Dpsgd draws: 64 tensors x 40 steps of sigma 1,
    batch 1, lr 1 from zero gradients; mean, deviation and the mean
    |correlation| between two tensors' draws."""
    import numpy as np
    ps = [torch.zeros(2, device="cuda", requires_grad=True)
          for _ in range(64)]
    opt = paddle.optimizer.Dpsgd(learning_rate=1.0, clip=100.0,
                                 batch_size=1.0, sigma=1.0, seed=5,
                                 parameters=ps)
    draws = []
    for _ in range(40):
        before = torch.stack([p.detach()[0] for p in ps]).clone()
        for p in ps:
            p.grad = torch.zeros(2, device="cuda")
        opt.step()
        draws.append((before - torch.stack([p.detach()[0] for p in ps])))
    d = torch.stack(draws).cpu().numpy()
    corr = np.corrcoef(d.T)
    return {"mean": float(d.mean()), "std": float(d.std()),
            "mean_abs_corr": float(np.abs(corr[~np.eye(64, dtype=bool)])
                                   .mean())}


@_keeps_global_state
def phase_tail_optimizers():
    """46 tail_optimizers: each tail optimizer (and EMA, ModelAverage,
    Lookahead) 5 steps on the tests' MLP, card against CPU: f32 eager
    with a global-norm clip; O2 bf16 (f32 masters) from the same fixed
    bf16 gradients; O2 bf16 inside ``TrainStep`` under a ``GradScaler``
    (the step a device tensor).  The CPU tests' tolerances; Dpsgd's
    parity on the same injected draws, its own draws on the card by
    statistics."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    x, y = _mlp_batch(np)
    rows, quantities = {}, {}
    for case in TAIL_OPTIMIZERS:
        # f32, eager, clipped
        out = {}
        for dev, m in zip(("cpu", "cuda"), _mlp_pair(paddle, torch)):
            opt = _tail_opt(paddle, case, m.parameters(), clip=True)
            xs, ys = (torch.from_numpy(a).to(dev) for a in (x, y))
            for _ in range(OPT_STEPS):
                loss = ((m(xs) - ys) ** 2).mean()
                loss.backward()
                opt.step()
                opt.clear_grad()
            out[dev] = _weights_np(m)
        f32 = _max_diff(out["cuda"], out["cpu"])
        # O2 from fixed bf16 gradients: parameters and masters
        rs = np.random.RandomState(5)
        shapes = [tuple(v.shape) for v in out["cpu"].values()]
        grads = [[(0.3 * rs.randn(*s)).astype(np.float32) for s in shapes]
                 for _ in range(OPT_STEPS)]
        o2 = {}
        for dev, m in zip(("cpu", "cuda"), _mlp_pair(paddle, torch)):
            opt = _tail_opt(paddle, case, m.parameters(), clip=False)
            m, opt = paddle.amp.decorate(m, opt, level="O2",
                                         dtype="bfloat16")
            params = list(m.parameters())
            for gs in grads:
                for p, g in zip(params, gs):
                    p.grad = torch.from_numpy(g).to(dev, torch.bfloat16)
                opt.step()
                opt.clear_grad()
            o2[dev] = (_weights_np(m), [opt._states[id(p)]["master"].cpu()
                                        .numpy() for p in params])
        o2_rel = max(float((abs(o2["cuda"][0][k] - o2["cpu"][0][k])
                            / (abs(o2["cpu"][0][k]) + 1e-6 / OPT_O2_RTOL))
                           .max()) for k in o2["cpu"][0])
        o2_master = max(float(abs(a - b).max())
                        for a, b in zip(o2["cuda"][1], o2["cpu"][1]))
        # O2 inside TrainStep under a GradScaler
        ts = {}
        for dev, m in zip(("cpu", "cuda"), _mlp_pair(paddle, torch)):
            opt = _tail_opt(paddle, case, m.parameters(), clip=True)
            m, opt = paddle.amp.decorate(m, opt, level="O2",
                                         dtype="bfloat16")
            step = paddle.jit.TrainStep(
                m, lambda o, lab: ((o.astype("float32") - lab) ** 2).mean(),
                opt, scaler=paddle.amp.GradScaler(init_loss_scaling=1024.0))
            xs = torch.from_numpy(x).to(dev, torch.bfloat16)
            ys = torch.from_numpy(y).to(dev)
            losses = [float(step(xs, ys)) for _ in range(OPT_STEPS)]
            if not isinstance(step._scaler_state["step"], torch.Tensor):
                raise AssertionError(f"{case}: the scaled step's count is "
                                     f"not a device tensor")
            ts[dev] = (_weights_np(m), losses, opt)
        o2_step = _max_diff(ts["cuda"][0], ts["cpu"][0])
        loss_diff = max(abs(a - b) for a, b in zip(ts["cuda"][1],
                                                   ts["cpu"][1]))
        rows[case] = {"f32_max_abs": f32, "o2_fixed_grads_max_rel": o2_rel,
                      "o2_master_max_abs": o2_master,
                      "o2_train_step_max_abs": o2_step,
                      "o2_train_step_loss_max_abs": loss_diff}
        quantities.update({
            f"{case} f32": (f32, OPT_F32_ATOL),
            f"{case} O2 params (rel)": (o2_rel, OPT_O2_RTOL),
            f"{case} O2 masters": (o2_master, OPT_F32_ATOL),
            f"{case} O2 TrainStep": (o2_step, OPT_O2_STEP_ATOL)})
        if case == "Lamb":
            tr = ts["cuda"][2].trust_ratios
            quantities["Lamb O2 trust ratios finite and positive (0/1)"] = (
                0.0 if bool(torch.isfinite(tr).all() and (tr > 0).all())
                else 1.0, 0.0)
    # EMA, ModelAverage, Lookahead over SGD / Adam, f32
    ext = {}
    for dev, m in zip(("cpu", "cuda"), _mlp_pair(paddle, torch)):
        xs, ys = (torch.from_numpy(a).to(dev) for a in (x, y))
        ema = paddle.optimizer.ExponentialMovingAverage(
            0.9, thres_steps=1, parameters=m.parameters())
        ma = paddle.optimizer.ModelAverage(0.15, parameters=m.parameters(),
                                           min_average_window=2,
                                           max_average_window=3)
        look = paddle.optimizer.Lookahead(paddle.optimizer.Adam(
            learning_rate=0.01, parameters=m.parameters()), alpha=0.5, k=3)
        for _ in range(7):
            loss = ((m(xs) - ys) ** 2).mean()
            loss.backward()
            look.step()
            look.clear_grad()
            ema.update()
            ma.step()
        trained = _weights_np(m)
        with ema.apply():
            shadow = _weights_np(m)
        with ma.apply():
            avg = _weights_np(m)
        if _max_diff(_weights_np(m), trained) != 0.0:
            raise AssertionError("EMA/ModelAverage apply did not restore")
        ext[dev] = (trained, shadow, avg)
    for i, what in enumerate(("Lookahead", "EMA", "ModelAverage")):
        d = _max_diff(ext["cuda"][i], ext["cpu"][i])
        rows[what] = {"f32_max_abs": d}
        quantities[f"{what} f32"] = (d, OPT_F32_ATOL)
    stats = _dpsgd_draw_stats(paddle, torch)
    quantities.update({
        "Dpsgd card draws |mean|": (abs(stats["mean"]), 0.1),
        "Dpsgd card draws |std - 1|": (abs(stats["std"] - 1.0), 0.1),
        "Dpsgd card draws mean |corr|": (stats["mean_abs_corr"], 0.2)})
    log("TAIL_OPTIMIZERS " + json.dumps({"cases": rows,
                                         "dpsgd_card_draws": stats}))
    _check("TAIL_OPTIMIZERS_CHECK", quantities)


def _device_ms(torch, fn, iters=5):
    """Device ms of one ``fn()``: the kernels' own device time in a
    ``torch.profiler`` trace of ``iters`` calls, over ``iters``.  A trace
    with no device time is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation)
        del prof
        gc.collect()
        if total > 0:
            return total / 1e3 / iters
    raise AssertionError("the profiler saw no device time")


def _update_ms(torch, opt, model, lr):
    """One ``functional_update`` over the model's parameters (f32
    masters under O2), from gradients of the parameters' shapes: its
    CUDA-event ms over back-to-back calls (which the host's launches
    bound when they outlast the kernels) and its device ms (the
    kernels' own time, from the profiler)."""
    params = [p.detach() for p in model.parameters()]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    grads = [1e-3 * torch.randn(p.shape, generator=gen, device="cuda",
                                dtype=p.dtype) for p in params]
    states = opt.functional_init(params)
    step = torch.tensor(1, dtype=torch.int32, device="cuda")
    meta = list(model.parameters())

    def update(i=0):
        with torch.no_grad():
            return opt.functional_update(params, grads, states, lr, step,
                                         params_meta=meta)
    return {"event_ms": cuda_ms(update, 10, warmup=2),
            "device_ms": _device_ms(torch, update)}


# bench.py:159-190 (bench_bert's chip config) with You et al. 2019's LAMB
# (arXiv:1904.00962) at bench_bert's learning rate
LAMB = dict(learning_rate=1e-4, lamb_weight_decay=0.01, beta1=0.9,
            beta2=0.999, epsilon=1e-6)


@_keeps_global_state
def phase_lamb_bert(warmup=2, steps=10):
    """47 lamb_bert: bench_bert's chip config (BERT-base, batch 64, seq
    512, dropout 0.1, O2 bf16 with f32 masters, global-norm clip 1.0)
    with Lamb in AdamW's place: 2 warm-up and 10 timed steps; step p50
    and mean, tokens/s, peak memory; the update's device ms beside
    AdamW's on the same parameters; the trust ratios' min, median and
    max; 12 launches of each flash kernel a step."""
    import numpy as np
    import torch
    from paddle_tpu_torch import amp, jit, optimizer, seed
    from paddle_tpu_torch.testing.models import build_model, mlm_loss
    cfg = BERT_CHIP
    seed(2024)
    t0 = time.perf_counter()
    model = build_model(cfg["vocab"], cfg["hidden"], cfg["layers"],
                        cfg["heads"], cfg["ffn"], cfg["seq"],
                        cfg["dropout"], device="cuda")
    opt = optimizer.Lamb(parameters=model.parameters(),
                         grad_clip=optimizer.ClipGradByGlobalNorm(1.0),
                         **LAMB)
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    step = jit.TrainStep(model, mlm_loss(model), opt, n_inputs=1,
                         donate=True)
    x, y = _bench_batch(torch, cfg, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, counts = _train_steps(torch, step, (x, y),
                                           warmup + steps)
    counts = {n: counts.get(n, 0) for n in FLASH_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    trust = opt.trust_ratios.float().cpu().numpy()
    names = [n for n, _ in model.named_parameters()]   # TrainStep's order
    timed = step_ms[warmup:]
    mean_ms = sum(timed) / len(timed)
    lamb_ms = _update_ms(torch, opt, model, LAMB["learning_rate"])
    adamw = optimizer.AdamW(learning_rate=1e-4,
                            parameters=model.parameters(), weight_decay=0.01,
                            grad_clip=optimizer.ClipGradByGlobalNorm(1.0),
                            multi_precision=True)
    adamw_ms = _update_ms(torch, adamw, model, 1e-4)
    out = {"config": cfg, "optimizer": dict(LAMB, name="Lamb",
                                            grad_clip="global norm 1.0"),
           "dtype": "bfloat16 O2, f32 master weights",
           "params": sum(p.numel() for p in model.parameters()),
           "setup_s": setup_s, "warmup_steps": warmup, "timed_steps": steps,
           "losses": losses, "step_ms": timed,
           "step_ms_p50": float(np.median(timed)), "step_ms_mean": mean_ms,
           "first_steps_ms": step_ms[:warmup],
           "tokens_per_s": cfg["batch"] * cfg["seq"] / (mean_ms / 1e3),
           "max_memory_allocated": peak,
           "update_ms_lamb": lamb_ms, "update_ms_adamw": adamw_ms,
           "trust_ratio": {"min": float(trust.min()),
                           "median": float(np.median(trust)),
                           "max": float(trust.max()), "n": int(trust.size),
                           "min_of": names[int(trust.argmin())],
                           "max_of": names[int(trust.argmax())]},
           "flash_launches": counts, "nvidia_smi": nvidia_smi()}
    log("LAMB_BERT " + json.dumps(out))
    want = cfg["layers"] * (warmup + steps)
    _check("LAMB_BERT_CHECK", {
        "|first loss - ln(vocab)|": (abs(losses[0]
                                         - math.log(cfg["vocab"])), 0.5),
        "non-finite losses": (sum(not math.isfinite(v) for v in losses), 0),
        "non-finite or non-positive trust ratios": (
            int((~np.isfinite(trust) | (trust <= 0)).sum()), 0),
        **{f"|{n} launches - {want}|": (abs(c - want), 0)
           for n, c in counts.items()}})
    del model, step, opt, adamw
    torch.cuda.empty_cache()
    return counts


# You et al. 2017's LARS (arXiv:1708.03888) in place of bench_resnet50's
# Momentum
LARS = dict(learning_rate=0.1, momentum=0.9, lars_coeff=0.001,
            lars_weight_decay=5e-4)


@_keeps_global_state
def phase_lars_resnet50(warmup=2, steps=10):
    """48 lars_resnet50: bench_resnet50's chip config (batch 128, 224
    px, NCHW, O2 bf16, f32 masters) with LarsMomentum in Momentum's
    place: 2 warm-up and 10 timed steps; images/s, step p50, peak
    memory, the update's device ms beside Momentum's; a first loss near
    ln(1000) and no hand kernel launched."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.vision.models import resnet50
    cfg = RESNET50_CHIP
    paddle.seed(2024)
    t0 = time.perf_counter()
    model = resnet50(data_format=cfg["data_format"])
    opt = optimizer.LarsMomentum(parameters=model.parameters(), **LARS)
    model, opt = amp.decorate(model, opt, level="O2", dtype=cfg["dtype"])
    step = TrainStep(model, lambda out, labels: F.cross_entropy(out, labels),
                     opt, n_inputs=1, donate=True)
    rng = np.random.RandomState(0)
    b, hw = cfg["batch"], cfg["hw"]
    x = paddle.to_tensor(rng.standard_normal((b, 3, hw, hw)).astype(
        np.float32)).astype(cfg["dtype"])
    y = paddle.to_tensor(rng.randint(0, 1000, (b,), dtype=np.int64))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, counts = _train_steps(torch, step, (x, y),
                                           warmup + steps)
    peak = torch.cuda.max_memory_allocated()
    timed = step_ms[warmup:]
    mean_ms = sum(timed) / len(timed)
    lars_ms = _update_ms(torch, opt, model, LARS["learning_rate"])
    momentum = optimizer.Momentum(learning_rate=cfg["lr"],
                                  momentum=cfg["momentum"],
                                  parameters=model.parameters(),
                                  multi_precision=True)
    momentum_ms = _update_ms(torch, momentum, model, cfg["lr"])
    out = {"config": cfg, "optimizer": dict(LARS, name="LarsMomentum"),
           "dtype": "bfloat16 O2, f32 master weights",
           "params": sum(p.numel() for p in model.parameters()),
           "setup_s": setup_s, "warmup_steps": warmup, "timed_steps": steps,
           "losses": losses, "step_ms": timed,
           "step_ms_p50": float(np.median(timed)), "step_ms_mean": mean_ms,
           "first_steps_ms": step_ms[:warmup],
           "images_per_s": b / (mean_ms / 1e3),
           "max_memory_allocated": peak, "update_ms_lars": lars_ms,
           "update_ms_momentum": momentum_ms,
           "hand_kernel_launches": counts, "nvidia_smi": nvidia_smi()}
    log("LARS_RESNET50 " + json.dumps(out))
    _check("LARS_RESNET50_CHECK", {
        "|first loss - ln(1000)|": (abs(losses[0] - math.log(1000)), 3.0),
        "non-finite losses": (sum(not math.isfinite(v) for v in losses), 0),
        "hand kernel launches": (sum(counts.values()), 0)})
    del model, step, opt, momentum
    torch.cuda.empty_cache()


def _second_order_cases(paddle, torch, dev):
    """The double-backward cases of tests/test_torch_double_backward.py
    on ``dev``: their results as floats and arrays."""
    import numpy as np
    out = {}
    x = torch.tensor(3.0, device=dev, requires_grad=True)
    g1, = paddle.grad(x * x * x, [x], create_graph=True)
    g2, = paddle.grad(g1, [x])
    out["x^3"] = np.array([float(g1), float(g2)])
    paddle.seed(0)
    lin = paddle.nn.Linear(4, 1).to("cpu")
    w0 = {k: v.clone() for k, v in lin.state_dict().items()}
    lin = paddle.nn.Linear(4, 1).to(dev)
    lin.load_state_dict({k: v.to(dev) for k, v in w0.items()})
    xs = torch.from_numpy(np.random.RandomState(0).randn(8, 4).astype(
        np.float32)).to(dev).requires_grad_()
    gx, = paddle.grad(paddle.nn.functional.tanh(lin(xs)).sum(), [xs],
                      create_graph=True)
    gw, = paddle.grad((gx * gx).sum(), [lin.weight])
    out["grad of grad"] = gw.detach().cpu().numpy()
    a = torch.from_numpy(np.random.RandomState(0).randn(6).astype(
        np.float32)).to(dev).requires_grad_()
    g1, = paddle.grad((a.sin() * a).sum(), [a], create_graph=True)
    (g1 * g1).sum().backward()
    out["sin oracle"] = a.grad.cpu().numpy()
    b = torch.tensor([2.0], device=dev, requires_grad=True)
    yb = (b * b).to(torch.bfloat16).float().sum()
    g1, = paddle.grad(yb, [b], create_graph=True)
    g2, = paddle.grad(g1.sum(), [b])
    out["bf16 intermediate"] = np.array([float(g1), float(g2)])
    return out


def _wgan_gp(paddle, torch, dev, weights, xs):
    critic = paddle.nn.Sequential(paddle.nn.Linear(4, 16), paddle.nn.Tanh(),
                                  paddle.nn.Linear(16, 1)).to(dev)
    critic.load_state_dict({k: v.to(dev) for k, v in weights.items()})
    opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                parameters=critic.parameters())
    losses = []
    for xb in xs:
        x = torch.from_numpy(xb).to(dev).requires_grad_()
        score = critic(x).sum()
        gx, = paddle.grad(score, [x], create_graph=True)
        norm = (gx * gx).sum(axis=1).sqrt()
        loss = -score / 16.0 + ((norm - 1.0) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, _weights_np(critic)


def _mha_penalty(paddle, torch, layer, x):
    t = x.clone().requires_grad_()
    out = layer(t, t, t)
    g, = paddle.grad((out * out).sum(), [t], create_graph=True)
    (g * g).sum().backward()
    return t.grad


@_keeps_global_state
def phase_double_backward():
    """49 double_backward: the double-backward cases and a WGAN-GP
    critic (an MLP: no hand kernel), 5 steps, card against CPU;
    ``create_graph=True`` through ``MultiHeadAttention`` at D 64 on the
    card raises C9's error; on the CPU its value through the flash
    Function equals the plain attention's (the flag off)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.cuda import support
    quantities = {}
    cpu = _second_order_cases(paddle, torch, "cpu")
    gpu = _second_order_cases(paddle, torch, "cuda")
    for k in cpu:
        quantities[f"{k} rel"] = (float(abs(gpu[k] - cpu[k]).max()
                                        / max(1.0, abs(cpu[k]).max())), 1e-5)
    paddle.seed(1)
    critic = paddle.nn.Sequential(paddle.nn.Linear(4, 16), paddle.nn.Tanh(),
                                  paddle.nn.Linear(16, 1)).to("cpu")
    w0 = {k: v.clone() for k, v in critic.state_dict().items()}
    rs = np.random.RandomState(1)
    xs = [rs.randn(16, 4).astype(np.float32) for _ in range(5)]
    lc, wc = _wgan_gp(paddle, torch, "cpu", w0, xs)
    lg, wg = _wgan_gp(paddle, torch, "cuda", w0, xs)
    quantities["WGAN-GP losses rel"] = (
        max(abs(a - b) / abs(b) for a, b in zip(lg, lc)), 1e-5)
    quantities["WGAN-GP params"] = (_max_diff(wg, wc), 1e-5)
    # C9 on the card: the flash Function refuses a second derivative
    paddle.seed(3)
    mha = paddle.nn.MultiHeadAttention(128, 2).to("cpu")
    mha.eval()
    w_mha = {k: v.clone() for k, v in mha.state_dict().items()}
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 5, 128).astype(
        np.float32))
    gpu_mha = paddle.nn.MultiHeadAttention(128, 2).to("cuda")
    gpu_mha.load_state_dict({k: v.cuda() for k, v in w_mha.items()})
    gpu_mha.eval()
    support.reset_launch_counts()
    try:
        _mha_penalty(paddle, torch, gpu_mha, x.cuda())
        raised = "nothing"
    except NotImplementedError as e:
        raised = str(e)
    torch.cuda.synchronize()
    launched = support.launch_counts.get("flash_attention_fwd", 0)
    # C9 on the CPU: through the Function, against plain attention
    flash = _mha_penalty(paddle, torch, mha, x)
    paddle.set_flags({"use_pallas_kernels": False})
    plain = _mha_penalty(paddle, torch, mha, x)
    paddle.set_flags({"use_pallas_kernels": True})
    c9 = float((flash - plain).abs().max() / plain.abs().max())
    log("DOUBLE_BACKWARD " + json.dumps({
        "cases_cpu": {k: v.tolist() for k, v in cpu.items()},
        "wgan_gp_losses_cpu": lc, "wgan_gp_losses_cuda": lg,
        "card_mha_create_graph": raised, "card_flash_fwd_launches": launched,
        "cpu_penalty_scale": float(plain.abs().max()),
        "cpu_flash_vs_plain_rel": c9}))
    quantities.update({
        "card raised C9's error (0/1)": (
            0.0 if "no second derivative" in raised else 1.0, 0.0),
        "card K1f launched before the refusal (0/1)": (
            0.0 if launched == 1 else 1.0, 0.0),
        "CPU penalty, flash Function vs plain, rel": (c9, 1e-5)})
    _check("DOUBLE_BACKWARD_CHECK", quantities)


@_keeps_global_state
def phase_top_level():
    """50 top_level: flags set and put back; ``get_/set_cuda_rng_state``
    replaying a dropout-0.1 small BERT step bit for bit; ``create_
    parameter`` and ``flops`` on the card; the card's ``device_count``,
    ``is_compiled_with_cuda`` and ``get_cudnn_version``."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import flags
    quantities = {}
    paddle.set_flags({"FLAGS_perf_sample_every": 4, "check_nan_inf": True})
    set_ok = paddle.get_flags(["perf_sample_every", "check_nan_inf"]) == {
        "perf_sample_every": 4, "check_nan_inf": True}
    try:
        paddle.set_flags({"xla_latency_hiding": True})
        card_less_raised = False
    except ValueError:
        card_less_raised = True
    quantities["flags set (0/1)"] = (0.0 if set_ok else 1.0, 0.0)
    quantities["an XLA flag raised (0/1)"] = (0.0 if card_less_raised
                                              else 1.0, 0.0)
    quantities["flags registered"] = (abs(len(flags._registry) - 47), 0)
    # the rng state replays a dropout-0.1 step: three models from the
    # same weights; a and b step from the same state, c from where a's
    # step left the stream
    cfg = dict(BERT_CPU, dropout=0.1)
    paddle.seed(7)
    a, a_step = _bert_trainer(torch, cfg, "cuda", False)
    b, b_step = _bert_trainer(torch, cfg, "cuda", False)
    c, c_step = _bert_trainer(torch, cfg, "cuda", False)
    b.load_state_dict(a.state_dict())
    c.load_state_dict(a.state_dict())
    x, y = _bench_batch(torch, cfg, "cuda")
    state = paddle.get_cuda_rng_state()
    la = float(a_step(x, y))
    lc = float(c_step(x, y))
    paddle.set_cuda_rng_state(state)
    lb = float(b_step(x, y))
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    param_diff = max(float((pa[k] - pb[k]).abs().max()) for k in pa)
    del a, b, c, a_step, b_step, c_step
    # create_parameter and flops on the card
    w = paddle.create_parameter([64, 32], "float32", name="w_card")
    bias = paddle.create_parameter([32], "float32", is_bias=True)
    lenet = paddle.vision.models.LeNet().to("cuda")
    r18 = paddle.vision.models.resnet18().to("cuda")
    lenet_flops = paddle.flops(lenet, [1, 1, 28, 28])
    r18_flops = paddle.flops(r18, [1, 3, 224, 224])
    lenet_cpu = paddle.flops(paddle.vision.models.LeNet().to("cpu"),
                             [1, 1, 28, 28])
    r18_cpu = paddle.flops(paddle.vision.models.resnet18().to("cpu"),
                           [1, 3, 224, 224])
    device = {"device_count": paddle.device_count(),
              "is_compiled_with_cuda": paddle.is_compiled_with_cuda(),
              "get_cudnn_version": paddle.get_cudnn_version(),
              "get_all_devices": paddle.device.get_all_devices()}
    log("TOP_LEVEL " + json.dumps({
        "rng_replay_losses": [la, lb], "stream_continued_loss": lc,
        "rng_replay_param_max_abs": param_diff,
        "create_parameter": [str(w.device), list(w.shape),
                             float(w.detach().std()),
                             float(bias.detach().abs().max())],
        "flops": {"lenet": lenet_flops, "resnet18_224": r18_flops},
        "device": device}))
    quantities.update({
        "replayed loss |a - b|": (abs(la - lb), 0.0),
        "replayed step params max |a - b|": (param_diff, 1e-6),
        "the stream's next draw gave another loss (0/1)": (
            0.0 if lc != la else 1.0, 0.0),
        "create_parameter on the card (0/1)": (
            0.0 if w.is_cuda and tuple(w.shape) == (64, 32)
            and w.param_name == "w_card" and not bias.detach().any()
            else 1.0, 0.0),
        "LeNet flops card vs CPU": (abs(lenet_flops - lenet_cpu), 0),
        "resnet18 flops card vs CPU": (abs(r18_flops - r18_cpu), 0),
        "device_count >= 1 (0/1)": (0.0 if device["device_count"] >= 1
                                    else 1.0, 0.0),
        "is_compiled_with_cuda (0/1)": (
            0.0 if device["is_compiled_with_cuda"] else 1.0, 0.0),
        "cudnn version is an int (0/1)": (
            0.0 if isinstance(device["get_cudnn_version"], int) else 1.0,
            0.0)})
    _check("TOP_LEVEL_CHECK", quantities)
    del lenet, r18
    torch.cuda.empty_cache()


@_keeps_global_state
def phase_public_paged_attention():
    """51 public_paged_attention: ``paged_attention`` on the card at phase
    2's shapes launches K4 once a call and equals its plain version;
    registering a function, and then ``None``, leaves K4's launches as
    they were."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.attention import paged_attention_reference
    from paddle_tpu_torch.ops.cuda import support
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    calls, errs, quantities = [], {}, {}

    def registered(q, k_pool, v_pool, page_table, lengths, scale,
                   layer=None):
        calls.append(tuple(q.shape))
        return paged_attention_reference(q, k_pool, v_pool, page_table,
                                         lengths, scale=scale, layer=layer)

    launches = {}
    for label, H, Hkv, P, dtype, lens in kernel_times.paged_cases(gen):
        q, k, v, table, lengths = kernel_times.paged_inputs(gen, H, Hkv, P,
                                                            dtype, lens)
        dname = str(dtype).replace("torch.", "")
        name = f"{label} H={H} Hkv={Hkv} P={P} {dname}"
        ref = paged_attention_reference(q, k, v, table, lengths,
                                        scale=1 / math.sqrt(q.shape[-1]),
                                        layer=0)
        for when, fn in (("none", None), ("registered", registered),
                         ("cleared", None)):
            paddle.register_paged_attention_kernel(fn)
            support.reset_launch_counts()
            got = paddle.paged_attention(q, k, v, table, lengths, layer=0)
            torch.cuda.synchronize()
            n = support.launch_counts.get(K4, 0)
            launches[f"{name} {when}"] = n
            quantities[f"{name} {when}: |K4 launches - 1|"] = (abs(n - 1), 0)
            errs[f"{name} {when}"] = (got.float() - ref.float()).abs().max(
            ).item()
            quantities[f"{name} {when}: max abs err"] = (
                errs[f"{name} {when}"], TOL[dname])
        del q, k, v, table, lengths
    paddle.register_paged_attention_kernel(None)
    quantities["registered function calls on K4's shapes"] = (len(calls), 0)
    log("PUBLIC_PAGED " + json.dumps({"launches": launches,
                                      "max_abs_err": errs}))
    _check("PUBLIC_PAGED_CHECK", quantities)
    return sum(launches.values())


@_keeps_global_state
def phase_ops_pallas():
    """52 ops_pallas: each ``ops.pallas`` entry on CUDA tensors at a small
    shape launches its kernel (counted in ``kernel_selections``) and
    equals its plain version; ``interpret=True`` on the card raises."""
    import torch
    from paddle_tpu_torch.ops import fused_adam as fa
    from paddle_tpu_torch.ops import pallas
    from paddle_tpu_torch.ops.attention import paged_attention_reference
    from paddle_tpu_torch.ops.cuda import support
    gen = torch.Generator(device="cuda")
    gen.manual_seed(52)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1))

    quantities, launches = {}, {}
    support.reset_launch_counts()
    # flash attention, forward and backward (K1f, K1b)
    q, k, v, do = (rand(2, 128, 2, 64) for _ in range(4))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = pallas.flash_attention(qg, kg, vg, causal=True, block_q=128,
                                 block_k=128)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    ref = pallas.mha_reference(qr, kr, vr, causal=True)
    rgrads = torch.autograd.grad(ref, (qr, kr, vr), do)
    quantities["flash_attention out rel"] = (rel(out, ref), FLASH_TOL[
        "float32"])
    for n, a, b in zip(("dq", "dk", "dv"), grads, rgrads):
        quantities[f"flash_attention {n} rel"] = (rel(a, b), FLASH_TOL[
            "float32"])
    # fused epilogue, forward and backward (K2f, K2b)
    stages = (("gelu", True), ("add",))
    x, w, bias = rand(64, 128), rand(128, 256, scale=0.1), rand(256)
    res, dy = rand(64, 256), rand(64, 256)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = pallas.fused_linear_epilogue(xg, wg, bias, stages, (res,))
    gx, gw = torch.autograd.grad(y, (xg, wg), dy)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    yr = pallas.reference_epilogue(xr, wr, bias, stages, (res,))
    rx, rw = torch.autograd.grad(yr, (xr, wr), dy)
    quantities["fused_linear_epilogue out rel"] = (rel(y, yr),
                                                   EPI_TOL["float32"])
    quantities["fused_linear_epilogue dx rel"] = (rel(gx, rx),
                                                  EPI_TOL["float32"])
    quantities["fused_linear_epilogue dw rel"] = (rel(gw, rw),
                                                  EPI_TOL["float32"])
    # fused Adam (K3)
    p, g, m = rand(1000), rand(1000), rand(1000)
    vv = rand(1000).abs()
    got = pallas.fused_adam_update(p, g, m, vv, 1e-3, 4.0)
    pp, mm, v2 = p.clone(), m.clone(), vv.clone()
    fa.fused_adam_reference_([pp], [g], [mm], [v2],
                             torch.tensor(1e-3, device="cuda"),
                             torch.tensor(4.0, device="cuda"))
    quantities["fused_adam_update max abs"] = (max(
        float((a - b).abs().max()) for a, b in zip(got, (pp, mm, v2))),
        ADAM_TOL)
    # paged decode (K4)
    case = kernel_times.paged_cases(gen)[3]
    qp, kp, vp, table, lengths = kernel_times.paged_inputs(gen, *case[1:])
    got = pallas.paged_attention_decode(qp, kp, vp, table, lengths,
                                        layer=1)
    ref = paged_attention_reference(qp, kp, vp, table, lengths,
                                    scale=1 / math.sqrt(qp.shape[-1]),
                                    layer=1)
    quantities["paged_attention_decode max abs"] = (
        float((got - ref).abs().max()), TOL["float32"])
    torch.cuda.synchronize()
    launches = dict(pallas.kernel_selections)
    for n in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv", "fused_epilogue_fwd",
              "fused_epilogue_bwd", "fused_epilogue_bwd_grads",
              "fused_adam", K4):
        quantities[f"|{n} launches - 1|"] = (abs(launches.get(n, 0) - 1), 0)
    raised = []
    for name, call in (
            ("fused_adam_update", lambda: pallas.fused_adam_update(
                p, g, m, vv, 1e-3, 4.0, interpret=True)),
            ("fused_linear_epilogue", lambda: pallas.fused_linear_epilogue(
                x, w, bias, stages, (res,), interpret=True)),
            ("paged_attention_decode", lambda: pallas.paged_attention_decode(
                qp, kp, vp, table, lengths, layer=1, interpret=True))):
        try:
            call()
        except ValueError:
            raised.append(name)
    quantities["entries that did not refuse interpret=True"] = (
        3 - len(raised), 0)
    log("OPS_PALLAS " + json.dumps({"launches": launches,
                                    "interpret_refused": raised}))
    _check("OPS_PALLAS_CHECK", quantities)
    return launches


# ---------------------------------------------------------- phases 53-56
# R1: BERT-base f32 exported by jit.save and served at these batches
PRED_BERT_BATCHES = (1, 8, 32)
PRED_BERT_RUNS = {1: 20, 8: 8, 32: 4}
# R3: bench_serving's sequential half (bench.py:817-863)
SERVING_MLP = (64, 128, 128, 32)
SERVING_REQUESTS, SERVING_REPS = 240, 3


def _serve_ms(np, pred, x, runs):
    """bench.py's Predictor latency: one warm-up run, then ``runs`` runs
    back to back and the last output read to the host; ms a run."""
    pred.run([x])
    t0 = time.perf_counter()
    for _ in range(runs):
        outs = pred.run([x])
    float(np.asarray(outs[0]).sum())
    return (time.perf_counter() - t0) / runs * 1e3


def _file_bytes(prefix):
    from paddle_tpu_torch.jit.save_load import SUFFIX_MODEL, SUFFIX_PARAMS
    return {s: os.path.getsize(prefix + s)
            for s in (SUFFIX_MODEL, SUFFIX_PARAMS)}


def _flash_fwd_row(torch, B, L, H, D):
    """K1f at one of the Predictor's shapes (f32, no mask): its time
    beside the plain version, the bound and SDPA's time."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_fwd_op, flash_attention_reference_fwd)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(53)
    q, k, v = (torch.randn((B, L, H, D), generator=gen, device="cuda")
               for _ in range(3))
    scale = 1.0 / math.sqrt(D)
    out, _ = flash_attention_fwd_op(q, k, v, False, scale, 0.0, 0, 0, 0)
    t = [x.transpose(1, 2) for x in (q, k, v)]
    plain, _ = flash_attention_reference_fwd(*t, scale=scale)
    err = _rel_err(out, plain.transpose(1, 2))
    ms = cuda_ms(lambda i: flash_attention_fwd_op(q, k, v, False, scale,
                                                  0.0, 0, 0, 0), 10)
    plain_ms = cuda_ms(lambda i: flash_attention_reference_fwd(
        *t, scale=scale), 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda i: sdpa(*t, scale=scale), 10)
    bound_ms, bound_by, _, _ = _flash_bound(B, H, L, L, D, 4, "float32",
                                            False, "flash_attention_fwd")
    return {"case": f"B={B} L={L} H={H} D={D} float32", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_call": "torch.nn.functional.scaled_dot_product_"
                            "attention (f32)",
            "max_abs_err": err}


def _cpu_saved_on_card(np, torch):
    """A small BERT (``bench_bert``'s CPU widths, D 32) built and saved
    on the CPU, where the custom ops ran their plain versions, then
    served from the card: its flash launches and its output against the
    CPU model's."""
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.core import placement
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import build_model
    c = BERT_CPU
    prev = placement.default()
    paddle.set_device("cpu")
    try:
        paddle.seed(7)
        model = build_model(c["vocab"], c["hidden"], c["layers"], c["heads"],
                            c["ffn"], c["seq"], c["dropout"], device="cpu")
        model.eval()
        ids = np.random.RandomState(7).randint(0, c["vocab"],
                                               (3, c["seq"]))
        with torch.no_grad():
            want = model(torch.from_numpy(ids))
        with tempfile.TemporaryDirectory() as d:
            prefix = os.path.join(d, "small")
            jit.save(model, prefix, input_spec=[
                jit.InputSpec([None, c["seq"]], "int64")])
            config = inference.Config(prefix)
            config.enable_use_gpu()
            pred = inference.create_predictor(config)
    finally:
        placement.set_default(prev)
    support.reset_launch_counts()
    out, = pred.run([ids])
    torch.cuda.synchronize()
    return {"config": c, "saved_on": "cpu", "served_on": str(out.device),
            "launches": dict(support.launch_counts),
            "graph_kernels": pred._meta["kernels"],
            "rel_err_vs_cpu": _rel_err(out.cpu(), want)}


def _predictor_group(n):
    return ("flash_fwd" if "flash_fwd_" in n else
            "fused_epilogue" if "epilogue_" in n else
            "gemm" if _is_gemm(n) else
            "layer_norm" if "layer_norm" in n else
            "copies" if "copy" in n or "memcpy" in n else "other")


@_keeps_global_state
def phase_predictor_bert(artifacts):
    """53 predictor_bert: R1, ``bench_bert``'s model (BERT-base, f32)
    in eval saved by ``jit.save`` with ``InputSpec([None, 512],
    "int64")`` into ``artifacts`` (phases 58-60 serve it again), served
    by ``create_predictor`` at batches 1, 8 and 32: 12 K1f launches a
    run and nothing else, the output against the same model run eagerly
    with ``use_pallas_kernels`` off, latency a run, save and load
    seconds, and K1f at the batch-32 shape beside its bound, plain
    version and SDPA."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import build_model
    cfg = BERT_CHIP
    paddle.seed(2024)
    model = build_model(cfg["vocab"], cfg["hidden"], cfg["layers"],
                        cfg["heads"], cfg["ffn"], cfg["seq"],
                        cfg["dropout"], device="cuda")
    rs = np.random.RandomState(53)
    rows, quantities = {}, {}
    prefix = os.path.join(artifacts, "bert")
    t0 = time.perf_counter()
    jit.save(model, prefix, input_spec=[
        jit.InputSpec([None, cfg["seq"]], "int64")])
    save_s = time.perf_counter() - t0
    sizes = _file_bytes(prefix)
    t0 = time.perf_counter()
    pred = inference.create_predictor(inference.Config(prefix))
    load_s = time.perf_counter() - t0
    graph_kernels = pred._meta["kernels"]
    model.eval()
    for b in PRED_BERT_BATCHES:
        ids = rs.randint(0, cfg["vocab"], (b, cfg["seq"])).astype(np.int64)
        support.reset_launch_counts()
        out, = pred.run([ids])
        torch.cuda.synchronize()
        counts = dict(support.launch_counts)
        paddle.set_flags({"use_pallas_kernels": False})
        try:
            with torch.no_grad():
                plain = model(torch.from_numpy(ids).cuda())
        finally:
            paddle.set_flags({"use_pallas_kernels": True})
        err = _rel_err(out, plain)
        ms = _serve_ms(np, pred, ids, PRED_BERT_RUNS[b])
        rows[b] = {"latency_ms": ms, "runs": PRED_BERT_RUNS[b],
                   "tokens_per_s": b * cfg["seq"] / (ms / 1e3),
                   "launches": counts, "rel_err_vs_plain": err,
                   "output_shape": list(out.shape),
                   "output_device": str(out.device)}
        quantities[f"batch {b}: |flash_attention_fwd launches - 12|"] = (
            abs(counts.get("flash_attention_fwd", 0) - cfg["layers"]), 0)
        quantities[f"batch {b}: other kernels launched"] = (
            sum(n for k, n in counts.items()
                if k != "flash_attention_fwd"), 0)
        quantities[f"batch {b}: rel err vs plain"] = (err,
                                                      FLASH_TOL["float32"])
        quantities[f"batch {b}: non-finite outputs"] = (
            int((~torch.isfinite(out)).sum()), 0)
    ids = torch.from_numpy(rs.randint(0, cfg["vocab"], (
        PRED_BERT_BATCHES[-1], cfg["seq"]))).cuda()
    _step_anatomy("PREDICTOR_BERT_ANATOMY", lambda: pred.run([ids]), 2,
                  _predictor_group)
    cpu_saved = _cpu_saved_on_card(np, torch)
    quantities["CPU-saved small BERT on the card: |flash launches - 2|"] = (
        abs(cpu_saved["launches"].get("flash_attention_fwd", 0) - 2), 0)
    quantities["CPU-saved small BERT on the card: other kernels"] = (
        sum(n for k, n in cpu_saved["launches"].items()
            if k != "flash_attention_fwd"), 0)
    quantities["CPU-saved small BERT on the card: rel err vs CPU"] = (
        cpu_saved["rel_err_vs_cpu"], FLASH_TOL["float32"])
    k1f = _flash_fwd_row(torch, 32, cfg["seq"], cfg["heads"],
                         cfg["hidden"] // cfg["heads"])
    quantities["K1f at batch 32: rel err vs plain"] = (
        k1f["max_abs_err"], FLASH_TOL["float32"])
    quantities["|graph's flash_attention_fwd nodes - 12|"] = (abs(
        graph_kernels.get("paddle_tpu_torch::flash_attention_fwd", 0)
        - cfg["layers"]), 0)
    quantities["|variants - 3|"] = (abs(pred.num_compiled_variants() - 3),
                                    0)
    launches = sum(r["launches"].get("flash_attention_fwd", 0)
                   for r in rows.values())
    out = {"config": dict(cfg, dtype="float32", mode="eval"),
           "save_s": save_s, "load_s": load_s, "artifact_bytes": sizes,
           "graph_kernels": graph_kernels, "batches": rows,
           "variants": pred.num_compiled_variants(), "k1f": k1f,
           "cpu_saved_small_bert": cpu_saved, "nvidia_smi": nvidia_smi()}
    log("PREDICTOR_BERT " + json.dumps(out))
    _check("PREDICTOR_BERT_CHECK", quantities)
    del model, pred
    torch.cuda.empty_cache()
    r1 = {"artifact_bytes": sizes,
          "latency_ms": {b: r["latency_ms"] for b, r in rows.items()}}
    return {"flash_attention_fwd": launches}, k1f, prefix, r1


def _static_forward(torch, main, feed_var, fetch_var, ids):
    """The Executor's eager replay of the program's slice that computes
    ``fetch_var``, with the live parameters."""
    from paddle_tpu_torch.static.executor import _interp
    from paddle_tpu_torch.static.io import _prune
    nodes = _prune(main.nodes, [fetch_var])
    with torch.no_grad():
        env = _interp(nodes, {id(feed_var): ids},
                      {id(p): p for p in main.parameters()})
    return env[id(fetch_var)]


@_keeps_global_state
def phase_predictor_static_bert():
    """54 predictor_static_bert: R2, bench_pallas's static BERT
    (``build_bert_static`` at its chip config: BERT-base, B 16, L 512,
    f32) saved by ``static.save_inference_model`` with the MLM logits as
    the fetch variable and served by the Predictor: 36 K2f and 12 K1f
    launches a run, the logits against the Executor's eager replay of
    the program with ``use_pallas_kernels`` off, latency a run, a run's
    anatomy, and one padded batch (5 rows padded to 16 and sliced
    back)."""
    import tempfile
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference, static
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import build_bert_static
    cfg = STATIC_CHIP
    main, _, feeds = build_bert_static(**cfg, device="cuda")
    ids_var = main.feed_vars["ids"]
    logits = [n for n in main.nodes if n.op_name == "linear"][-1].out_vars[0]
    quantities, rows = {}, {}
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "static_bert")
        t0 = time.perf_counter()
        static.save_inference_model(prefix, [ids_var], [logits],
                                    program=main)
        save_s = time.perf_counter() - t0
        sizes = _file_bytes(prefix)
        t0 = time.perf_counter()
        pred = inference.create_predictor(inference.Config(prefix))
        load_s = time.perf_counter() - t0
    graph_kernels = pred._meta["kernels"]
    want = {"fused_epilogue_fwd": STATIC_PER_STEP["fused_epilogue_fwd"],
            "flash_attention_fwd": STATIC_PER_STEP["flash_attention_fwd"]}
    ids = feeds(np.random.RandomState(54))["ids"]
    paddle.set_flags({"use_pallas_kernels": False})
    try:
        plain = _static_forward(torch, main, ids_var, logits,
                                torch.from_numpy(ids).cuda())
    finally:
        paddle.set_flags({"use_pallas_kernels": True})
    for name, x in (("full", ids), ("padded 5 of 16", ids[:5])):
        support.reset_launch_counts()
        out, = pred.run([x])
        torch.cuda.synchronize()
        counts = dict(support.launch_counts)
        err = _rel_err(out, plain[:x.shape[0]])
        rows[name] = {"launches": counts, "rel_err_vs_plain": err,
                      "output_shape": list(out.shape)}
        for k, n in want.items():
            quantities[f"{name}: |{k} launches - {n}|"] = (
                abs(counts.get(k, 0) - n), 0)
        quantities[f"{name}: other kernels launched"] = (
            sum(n for k, n in counts.items() if k not in want), 0)
        quantities[f"{name}: rel err vs plain"] = (err, EPI_TOL["float32"])
        quantities[f"{name}: |output rows - {x.shape[0]}|"] = (
            abs(out.shape[0] - x.shape[0]), 0)
        del out
    del plain
    ms = _serve_ms(np, pred, ids, 4)
    ids_dev = torch.from_numpy(ids).cuda()
    _step_anatomy("PREDICTOR_STATIC_BERT_ANATOMY",
                  lambda: pred.run([ids_dev]), 2, _predictor_group)
    rows["full"].update(latency_ms=ms, runs=4,
                        tokens_per_s=cfg["batch"] * cfg["seq"] / (ms / 1e3))
    quantities["variants after the padded run (want 1)"] = (
        pred.num_compiled_variants(), 1)
    quantities["|graph's fused_linear_epilogue_fwd nodes - 36|"] = (abs(
        graph_kernels.get("paddle_tpu_torch::fused_linear_epilogue_fwd", 0)
        - 36), 0)
    out = {"config": dict(cfg, dtype="float32", fetch="MLM logits"),
           "save_s": save_s, "load_s": load_s, "artifact_bytes": sizes,
           "graph_kernels": graph_kernels, "runs": rows,
           "variants": pred.num_compiled_variants(),
           "nvidia_smi": nvidia_smi()}
    log("PREDICTOR_STATIC_BERT " + json.dumps(out))
    _check("PREDICTOR_STATIC_BERT_CHECK", quantities)
    launches = {k: sum(rows[r]["launches"].get(k, 0)
                       for r in ("full", "padded 5 of 16")) for k in want}
    del main, pred
    torch.cuda.empty_cache()
    return launches


@_keeps_global_state
def phase_predictor_benches():
    """55 predictor_benches: R3, the predictor half of
    ``bench_lenet_dygraph`` (bench.py:1310-1326: LeNet saved with
    ``InputSpec([None, 1, 28, 28])``, 50 runs at batch 1:
    ``predictor_latency_ms_bs1``, ``predictor_recompiles``) and the
    sequential half of ``bench_serving`` (bench.py:817-863: the
    64-128-128-32 MLP, 240 ragged requests of 1-4 rows, 3 rounds, under
    pad-to-bucket: requests/s, ``num_compiled_variants()`` flat after
    warm-up); outputs against the eager models."""
    import tempfile
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference, jit, nn
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.vision.models import LeNet
    quantities = {}
    with tempfile.TemporaryDirectory() as d:
        paddle.seed(0)
        lenet = LeNet()
        lenet.eval()
        pfx = os.path.join(d, "m")
        jit.save(lenet, pfx, input_spec=[
            jit.InputSpec([None, 1, 28, 28], "float32")])
        pred = inference.create_predictor(inference.Config(pfx))
        xi = np.zeros((1, 1, 28, 28), "float32")
        support.reset_launch_counts()
        infer_ms = _serve_ms(np, pred, xi, 50)
        lenet_launches = dict(support.launch_counts)
        recompiles = pred.num_compiled_variants()
        xr = np.random.RandomState(55).standard_normal(
            (3, 1, 28, 28)).astype("float32")
        with torch.no_grad():
            lenet_err = _rel_err(pred.run([xr])[0],
                             lenet(torch.from_numpy(xr).cuda()))
        lenet_out = {"predictor_latency_ms_bs1": infer_ms,
                     "predictor_recompiles": recompiles,
                     "rel_err_vs_eager": lenet_err,
                     "hand_kernel_launches": lenet_launches}

        paddle.seed(2024)
        sizes = SERVING_MLP
        layers = []
        for a, b in zip(sizes[:-1], sizes[1:]):
            layers += [nn.Linear(a, b), nn.ReLU()]
        mlp = nn.Sequential(*layers[:-1])
        mlp.eval()
        pfx = os.path.join(d, "mlp")
        jit.save(mlp, pfx, input_spec=[
            jit.InputSpec([None, sizes[0]], "float32")])
        spred = inference.create_predictor(inference.Config(pfx))
    rng = np.random.RandomState(0)
    reqs = [rng.standard_normal((int(rng.randint(1, 5)), sizes[0]))
            .astype(np.float32) for _ in range(SERVING_REQUESTS)]
    for n in sorted({r.shape[0] for r in reqs}):
        np.asarray(spred.run([np.zeros((n, sizes[0]), np.float32)])[0])
    warm = spred.num_compiled_variants()
    dt, outs = 0.0, []
    for _ in range(SERVING_REPS):
        t0 = time.perf_counter()
        outs = [np.asarray(spred.run([r])[0]) for r in reqs]
        dt += time.perf_counter() - t0
    with torch.no_grad():
        mlp_err = max(_rel_err(torch.from_numpy(o).cuda(),
                           mlp(torch.from_numpy(r).cuda()))
                      for r, o in zip(reqs, outs))
    n_req = SERVING_REQUESTS * SERVING_REPS
    rows_total = sum(r.shape[0] for r in reqs) * SERVING_REPS
    serving_out = {"sequential_requests_per_sec": n_req / dt,
                   "rows_per_sec": rows_total / dt,
                   "ms_per_request": dt / n_req * 1e3,
                   "compiled_variants_sequential_warm": warm,
                   "variants_after": spred.num_compiled_variants(),
                   "rel_err_vs_eager": mlp_err,
                   "config": {"model": "mlp 64-128-128-32",
                              "ragged_rows": "1-4",
                              "requests": SERVING_REQUESTS,
                              "rounds": SERVING_REPS}}
    log("PREDICTOR_BENCHES " + json.dumps({
        "lenet": lenet_out, "serving_sequential": serving_out,
        "nvidia_smi": nvidia_smi()}))
    quantities["lenet: rel err vs eager"] = (lenet_err, TOL["float32"])
    quantities["lenet: predictor_recompiles (want 1)"] = (recompiles, 1)
    quantities["lenet: hand kernels launched"] = (
        sum(lenet_launches.values()), 0)
    quantities["serving: rel err vs eager"] = (mlp_err, TOL["float32"])
    quantities["serving: variants added after warm-up"] = (
        spred.num_compiled_variants() - warm, 0)
    quantities["serving: |warm variants - 3|"] = (abs(warm - 3), 0)
    _check("PREDICTOR_BENCHES_CHECK", quantities)
    return lenet_out, serving_out


def _d2s_if(x):
    if x.sum() > 0:
        y = x * 2
    else:
        y = x - 1
    return y + 10


def _d2s_while(x):
    s = x * 0
    while s.sum() < 10:
        s = s + x
    return s


@_keeps_global_state
def phase_dy2static_export():
    """56 dy2static_export: R4, a ``to_static`` function with a tensor
    ``if`` and one with a tensor ``while`` (``tests/test_dy2static.py``)
    saved on the card with a zero example, loaded, and fed inputs that
    take the other branch and other trip counts: each answer equals the
    eager ``to_static`` call's, and each graph holds torch's ``cond`` /
    ``while_loop``."""
    import tempfile
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import jit
    paddle.set_device("gpu")
    quantities, out = {}, {}
    with tempfile.TemporaryDirectory() as d:
        for name, fn, inputs in (
                ("if", _d2s_if, ([1.0, 2.0], [-1.0, -2.0], [-4.0, 1.0])),
                ("while", _d2s_while, ([1.0, 1.0], [2.0, 2.0],
                                       [4.5, 4.5]))):
            sf = jit.to_static(fn)
            path = os.path.join(d, name)
            jit.save(sf, path, input_spec=[jit.InputSpec([2], "float32")])
            loaded = jit.load(path)
            hops = sorted({n.target.name() for n in
                           loaded.program.graph.nodes
                           if n.op == "call_function" and isinstance(
                               n.target, torch._ops.HigherOrderOperator)})
            got, want = [], []
            for v in inputs:
                x = paddle.to_tensor(np.array(v, np.float32))
                got.append(loaded(x).numpy().tolist())
                want.append(sf(x).numpy().tolist())
            out[name] = {"graph_control_flow": hops, "inputs": inputs,
                         "loaded": got, "eager_to_static": want,
                         "device": str(loaded.device)}
            quantities[f"{name}: max |loaded - eager|"] = (float(np.abs(
                np.array(got) - np.array(want)).max()), 0.0)
            quantities[f"{name}: control-flow node missing"] = (
                int(("cond" if name == "if" else "while_loop")
                    not in hops), 0)
    log("DY2STATIC_EXPORT " + json.dumps(out))
    _check("DY2STATIC_EXPORT_CHECK", quantities)


# ----------------------------------------------------------- phases 57-61
ENGINE_BERT_REQUESTS, ENGINE_BERT_REPS = 96, 2     # cut from 240 and 3
SERVING_CLIENTS, SERVING_WINDOW, SERVING_MAX_BATCH = 8, 8, 32
HTTP_REQUESTS, HTTP_CLIENTS = 16, 4
CAPI_BATCHES, CAPI_RUNS = (1, 8), {1: 10, 8: 4}
GEN_BASELINE = dict(vocab_size=1024, hidden=256, num_layers=2, num_heads=8,
                    ffn=2048, seed=7)
GEN_REQUESTS, GEN_REPS, GEN_SLOTS, GEN_T_MAX = 48, 2, 8, 512
GEN_PROMPT_LENGTHS, GEN_BUDGETS = [4, 6, 8, 12, 16, 24, 32], (16, 48)


class _ServingScope:
    """Phases 57-61's own state: every thread started inside the block
    (dispatchers, HTTP servers and their handlers, clients) must have
    ended within a few seconds of the block's end, after its engines and
    servers were closed in the block's ``finally``."""

    def __enter__(self):
        self._before = {t.ident for t in threading.enumerate()}
        return self

    def __exit__(self, *exc):
        deadline = time.monotonic() + 15.0
        while True:
            left = [t.name for t in threading.enumerate()
                    if t.ident not in self._before and t.is_alive()]
            if not left or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        if left and exc[0] is None:
            raise AssertionError(f"threads still running after the phase: "
                                 f"{left}")
        return False


def _closed_loop(engine, reqs, clients, window):
    """bench.py's clients: ``clients`` threads, each keeping up to
    ``window`` requests in flight; returns the outputs in request order
    and the wall seconds."""
    outs, errors = [None] * len(reqs), []

    def client(idx):
        try:
            pending = []
            for i in range(idx, len(reqs), clients):
                pending.append((i, engine.infer([reqs[i]])))
                while len(pending) >= window:
                    j, f = pending.pop(0)
                    outs[j] = f.result(300)[0]
            for j, f in pending:
                outs[j] = f.result(300)[0]
        except BaseException as e:     # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}")
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return outs, wall


def _np_rel_err(np, got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if not np.isfinite(got).all():
        raise AssertionError("non-finite output")
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def _engine_stats_row(st):
    return {"mean_batch_occupancy": st["mean_batch_occupancy"],
            "requests_per_batch": st["requests_per_batch"],
            "padding_waste": st["padding_waste"],
            "latency_ms_p50": st["latency_ms"]["p50"],
            "latency_ms_p95": st["latency_ms"]["p95"],
            "latency_ms_p99": st["latency_ms"]["p99"],
            "batches": st["counters"]["batches"],
            "recompiles_after_warmup": st["recompiles_after_warmup"],
            "buckets": st["buckets"]}


def _serving_mlp(paddle, nn):
    paddle.seed(2024)
    layers = []
    for a, b in zip(SERVING_MLP[:-1], SERVING_MLP[1:]):
        layers += [nn.Linear(a, b), nn.ReLU()]
    mlp = nn.Sequential(*layers[:-1])
    mlp.eval()
    return mlp


@_keeps_global_state
def phase_engine_mlp(artifacts):
    """57 engine_mlp: ``bench_serving`` whole (bench.py:817-927): the
    64-128-128-32 MLP saved into ``artifacts`` (phase 59 loads it), 240
    ragged requests of 1-4 rows, 3 rounds of the sequential Predictor
    interleaved with 3 of the ``InferenceEngine`` (``max_batch_size``
    32, 2 ms ``batch_timeout_ms``) under 8 closed-loop clients each
    keeping 8 in flight: requests/s, the speedup, occupancy, requests a
    batch, padding waste, latency p50/p95/p99; no variant after warm-up
    and every response within 1e-5 of that request run alone."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference, jit, nn, serving
    prefix = os.path.join(artifacts, "mlp")
    jit.save(_serving_mlp(paddle, nn), prefix, input_spec=[
        jit.InputSpec([None, SERVING_MLP[0]], "float32")])
    pred = inference.create_predictor(inference.Config(prefix))
    rng = np.random.RandomState(0)
    reqs = [rng.standard_normal((int(rng.randint(1, 5)), SERVING_MLP[0]))
            .astype(np.float32) for _ in range(SERVING_REQUESTS)]
    rows = sum(r.shape[0] for r in reqs)
    for n in sorted({r.shape[0] for r in reqs}):
        np.asarray(pred.run([np.zeros((n, SERVING_MLP[0]), np.float32)])[0])
    seq_variants = pred.num_compiled_variants()
    with _ServingScope():
        eng = serving.InferenceEngine(pred, max_batch_size=SERVING_MAX_BATCH,
                                      batch_timeout_ms=2.0,
                                      max_queue=4 * SERVING_REQUESTS)
        try:
            eng.warmup()
            dt_seq = dt_conc = 0.0
            for _ in range(SERVING_REPS):
                t0 = time.perf_counter()
                alone = [np.asarray(pred.run([r])[0]) for r in reqs]
                dt_seq += time.perf_counter() - t0
                outs, wall = _closed_loop(eng, reqs, SERVING_CLIENTS,
                                          SERVING_WINDOW)
                dt_conc += wall
            st = eng.stats()
        finally:
            eng.close()
    err = max(_np_rel_err(np, o, a) for o, a in zip(outs, alone))
    n_req = SERVING_REQUESTS * SERVING_REPS
    out = {"requests_per_sec": n_req / dt_conc,
           "sequential_requests_per_sec": n_req / dt_seq,
           "speedup_vs_sequential_predictor": dt_seq / dt_conc,
           "rows_per_sec": rows * SERVING_REPS / dt_conc,
           **_engine_stats_row(st),
           "compiled_variants_sequential_warm": seq_variants,
           "max_rel_err_vs_alone": err, "nvidia_smi": nvidia_smi(),
           "config": {"model": "mlp 64-128-128-32", "requests":
                      SERVING_REQUESTS, "rounds": SERVING_REPS,
                      "clients": SERVING_CLIENTS,
                      "pipeline_depth": SERVING_WINDOW,
                      "max_batch_size": SERVING_MAX_BATCH,
                      "batch_timeout_ms": 2.0, "ragged_rows": "1-4"}}
    log("ENGINE_MLP " + json.dumps(out))
    _check("ENGINE_MLP_CHECK", {
        "recompiles_after_warmup": (st["recompiles_after_warmup"], 0),
        "max rel err vs the request alone": (err, 1e-5),
        "responses missing": (n_req - st["counters"]["responses"], 0)})
    return prefix


def _one_engine_batch(engine, reqs):
    """One dispatched batch's worth of requests (rows summing to the
    largest bucket), submitted together and waited for."""
    futs = [engine.infer([r]) for r in reqs]
    for f in futs:
        f.result(300)


@_keeps_global_state
def phase_engine_bert(prefix):
    """58 engine_bert: R1 (phase 53's saved BERT-base, f32 eval) behind
    the ``InferenceEngine`` (``max_batch_size`` 32, 2 ms), bench_serving's
    traffic cut to 96 ragged requests of 1-4 rows x 512 tokens and 2
    rounds, the sequential ``Predictor.run`` interleaved: requests/s,
    rows/s and tokens/s, the speedup, occupancy, latency p50/p95/p99; 12
    K1f launches for every batch dispatched and no other hand kernel; no
    variant after warm-up; every response within ``FLASH_TOL`` of that
    request run alone; one dispatched batch's anatomy."""
    import numpy as np
    import torch
    from paddle_tpu_torch import inference, serving
    from paddle_tpu_torch.ops.cuda import support
    cfg = BERT_CHIP
    pred = inference.create_predictor(inference.Config(prefix))
    rng = np.random.RandomState(58)
    reqs = [rng.randint(0, cfg["vocab"], (int(rng.randint(1, 5)),
                                          cfg["seq"])).astype(np.int64)
            for _ in range(ENGINE_BERT_REQUESTS)]
    rows = sum(r.shape[0] for r in reqs)
    for n in sorted({r.shape[0] for r in reqs}):
        np.asarray(pred.run([np.zeros((n, cfg["seq"]), np.int64)])[0])
    launches, seq_launches, batches = {}, {}, 0
    with _ServingScope():
        eng = serving.InferenceEngine(pred, max_batch_size=SERVING_MAX_BATCH,
                                      batch_timeout_ms=2.0,
                                      max_queue=4 * ENGINE_BERT_REQUESTS)
        try:
            t0 = time.perf_counter()
            eng.warmup()
            torch.cuda.synchronize()
            warmup_s = time.perf_counter() - t0
            dt_seq = dt_conc = 0.0
            err = 0.0
            for _ in range(ENGINE_BERT_REPS):
                support.reset_launch_counts()
                t0 = time.perf_counter()
                alone = [np.asarray(pred.run([r])[0]) for r in reqs]
                dt_seq += time.perf_counter() - t0
                for k, n in support.launch_counts.items():
                    seq_launches[k] = seq_launches.get(k, 0) + n
                b0 = eng.stats()["counters"]["batches"]
                support.reset_launch_counts()
                outs, wall = _closed_loop(eng, reqs, SERVING_CLIENTS,
                                          SERVING_WINDOW)
                for k, n in support.launch_counts.items():
                    launches[k] = launches.get(k, 0) + n
                batches += eng.stats()["counters"]["batches"] - b0
                dt_conc += wall
                err = max([err] + [_np_rel_err(np, o, a)
                                   for o, a in zip(outs, alone)])
                del outs, alone
            st = eng.stats()
            batch = [np.zeros((4, cfg["seq"]), np.int64)] * (
                SERVING_MAX_BATCH // 4)
            anatomy_launches = _step_anatomy(
                "ENGINE_BERT_ANATOMY", lambda: _one_engine_batch(eng, batch),
                2, _predictor_group)
        finally:
            eng.close()
    n_req = ENGINE_BERT_REQUESTS * ENGINE_BERT_REPS
    out = {"requests_per_sec": n_req / dt_conc,
           "rows_per_sec": rows * ENGINE_BERT_REPS / dt_conc,
           "tokens_per_sec": rows * ENGINE_BERT_REPS * cfg["seq"] / dt_conc,
           "sequential_requests_per_sec": n_req / dt_seq,
           "sequential_rows_per_sec": rows * ENGINE_BERT_REPS / dt_seq,
           "speedup_vs_sequential_predictor": dt_seq / dt_conc,
           **_engine_stats_row(st), "warmup_s": warmup_s,
           "batches_timed": batches, "launches": launches,
           "sequential_launches": seq_launches,
           "anatomy_launches_per_batch": anatomy_launches,
           "max_rel_err_vs_alone": err, "nvidia_smi": nvidia_smi(),
           "config": dict(cfg, dtype="float32", mode="eval",
                          requests=ENGINE_BERT_REQUESTS,
                          rounds=ENGINE_BERT_REPS, ragged_rows="1-4",
                          clients=SERVING_CLIENTS,
                          pipeline_depth=SERVING_WINDOW,
                          max_batch_size=SERVING_MAX_BATCH,
                          batch_timeout_ms=2.0,
                          cut="96 requests x 2 rounds (bench.py: 240 x 3)")}
    log("ENGINE_BERT " + json.dumps(out))
    _check("ENGINE_BERT_CHECK", {
        "|K1f launches - 12 x batches|": (abs(
            launches.get("flash_attention_fwd", 0)
            - cfg["layers"] * batches), 0),
        "other hand kernels launched": (sum(
            n for k, n in launches.items() if k != "flash_attention_fwd"), 0),
        "|sequential K1f launches - 12 x requests|": (abs(
            seq_launches.get("flash_attention_fwd", 0)
            - cfg["layers"] * n_req), 0),
        "recompiles_after_warmup": (st["recompiles_after_warmup"], 0),
        "max rel err vs the request alone": (err, FLASH_TOL["float32"])})
    del pred
    torch.cuda.empty_cache()
    return {"flash_attention_fwd": launches.get("flash_attention_fwd", 0)}


@_keeps_global_state
def phase_http_registry(bert_prefix, mlp_prefix):
    """59 http_registry: a ``ServingServer`` over a ``ModelRegistry``
    bound not ready; R1's BERT-base and phase 57's MLP loaded through
    ``POST /admin/models``; ``/healthz`` 503 before ``mark_ready`` and
    200 after; 16 ``/predict`` requests a model from 4 clients routed by
    ``"model"`` (BERT's as ``.npy`` bodies), each against the model's
    engine answering the same request directly; an unknown model's 404;
    an ``unload`` that drains."""
    import http.client
    import numpy as np
    import torch
    from paddle_tpu_torch import serving
    cfg = BERT_CHIP
    rng = np.random.RandomState(59)
    reqs = {"bert": [rng.randint(0, cfg["vocab"], (int(rng.randint(1, 3)),
                                                   cfg["seq"]))
                     for _ in range(HTTP_REQUESTS)],
            "mlp": [rng.standard_normal((int(rng.randint(1, 5)),
                                         SERVING_MLP[0])).astype(np.float32)
                    for _ in range(HTTP_REQUESTS)]}
    quantities, codes, timings = {}, {}, {}
    with _ServingScope():
        reg = serving.ModelRegistry()
        srv = serving.ServingServer(registry=reg, port=0, ready=False,
                                    request_timeout=300).start()
        try:
            client = serving.Client(srv.url, timeout=600)
            codes["healthz before load"] = client.healthz()["status"]
            for name, prefix in (("bert", bert_prefix), ("mlp", mlp_prefix)):
                t0 = time.perf_counter()
                r = client.load_model(name, prefix, engine_kwargs={
                    "max_batch_size": SERVING_MAX_BATCH,
                    "batch_timeout_ms": 2.0})
                timings[f"load {name} s"] = time.perf_counter() - t0
                if r != {"loaded": name, "state": "ready"}:
                    raise AssertionError(f"load {name}: {r}")
            h = client.healthz()
            quantities["healthz ready before mark_ready"] = (int(h["ready"]),
                                                             0)
            srv.mark_ready()
            quantities["healthz not ready after mark_ready"] = (
                int(not client.healthz()["ready"]), 0)
            got, errors = {"bert": {}, "mlp": {}}, []

            def worker(c):
                cl = serving.Client(srv.url, timeout=600)
                try:
                    for i in range(c, HTTP_REQUESTS, HTTP_CLIENTS):
                        got["bert"][i] = cl.predict_npy(reqs["bert"][i],
                                                        model="bert")
                        got["mlp"][i] = cl.predict(reqs["mlp"][i],
                                                   model="mlp")[0]
                except BaseException as e:   # noqa: BLE001 - re-raised
                    errors.append(e)
                finally:
                    cl.close()

            threads = [threading.Thread(target=worker, args=(c,),
                                        name=f"http-client-{c}")
                       for c in range(HTTP_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            timings["predict wall s"] = time.perf_counter() - t0
            if errors:
                raise errors[0]
            for name, tol in (("bert", FLASH_TOL["float32"]), ("mlp", 1e-5)):
                eng = reg.resolve(name).engine
                err = max(_np_rel_err(np, got[name][i], eng.infer_sync(
                    [reqs[name][i]], timeout=300)[0])
                    for i in range(HTTP_REQUESTS))
                quantities[f"{name}: max rel err vs its engine"] = (err, tol)
                quantities[f"{name}: answers missing"] = (
                    HTTP_REQUESTS - len(got[name]), 0)
            conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
            conn.request("POST", "/predict", json.dumps(
                {"inputs": [reqs["mlp"][0].tolist()], "model": "nope"}),
                {"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            conn.close()
            quantities["|unknown model status - 404|"] = (
                abs(resp.status - 404), 0)
            metrics = client.metrics()
            desc = client.admin_models()
            t0 = time.perf_counter()
            summary = client.unload_model("bert")
            timings["unload bert s"] = time.perf_counter() - t0
            quantities["unload did not drain"] = (
                int(summary != {"model": "bert", "engine_drained": True}), 0)
            quantities["models left (want 1)"] = (len(reg.models()), 1)
            client.close()
        finally:
            srv.close()
            reg.close()
    out = {"healthz": codes, "timings": timings,
           "registry": metrics["registry"], "models": desc["models"],
           "unload": summary, "nvidia_smi": nvidia_smi()}
    log("HTTP_REGISTRY " + json.dumps(out))
    _check("HTTP_REGISTRY_CHECK", quantities)
    torch.cuda.empty_cache()


_CAPI_C_MAIN = r"""
#include <stdio.h>
#include <stdlib.h>
#include "paddle_tpu_capi.h"

int main(int argc, char** argv) {
  int64_t batch = atoll(argv[2]), seq = atoll(argv[3]), vocab = atoll(argv[4]);
  PT_Predictor* p = PT_NewPredictor(argv[1]);
  if (!p) { printf("FAIL new\n"); return 1; }
  float* ids = (float*)malloc(sizeof(float) * batch * seq);
  for (int64_t i = 0; i < batch * seq; ++i) ids[i] = (float)((i * 7) % vocab);
  const float* inputs[1] = {ids};
  int64_t shape[2] = {batch, seq};
  const int64_t* shapes[1] = {shape};
  int32_t ndims[1] = {2};
  int32_t n = PT_PredictorRun(p, inputs, shapes, ndims, 1);
  if (n != 1) { printf("FAIL run %d\n", n); return 1; }
  PT_Output out;
  if (PT_GetOutput(p, 0, &out) != 0) { printf("FAIL out\n"); return 1; }
  double sum = 0, asum = 0;
  for (int64_t i = 0; i < out.numel; ++i) {
    sum += out.data[i];
    asum += out.data[i] < 0 ? -out.data[i] : out.data[i];
  }
  printf("OK numel=%lld sum=%.9e abs=%.9e\n", (long long)out.numel, sum, asum);
  PT_FreeOutput(&out);
  PT_DeletePredictor(p);
  free(ids);
  return 0;
}
"""


def _capi_ms(np, fn, runs):
    """ms a run of ``fn()`` (whose result is read to the host) over
    ``runs`` runs after one warm-up run."""
    fn()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    return (time.perf_counter() - t0) / runs * 1e3


@_keeps_global_state
def phase_capi(bert_prefix, artifacts):
    """60 capi: the C ABI built with ``g++`` from the checkout
    (``load_capi``): ``CPredictor`` over R1 at batches 1 and 8 (ids as
    float32), 12 K1f launches a run and the output within ``FLASH_TOL``
    of ``Predictor.run``'s, its latency a run beside ``Predictor.run``'s
    (both read to the host); then a C program compiled with ``gcc``
    drives a small BERT (bench.py:167's widths) saved on the card in its
    own embedded interpreter, its checksum within 1e-4 relative of the
    in-process Predictor's."""
    import site
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.inference import capi
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import build_model
    cfg = BERT_CHIP
    prev_env = os.environ.pop(capi.DEVICE_ENV, None)
    quantities, rows, launches = {}, {}, 0
    try:
        t0 = time.perf_counter()
        capi.load_capi()
        build_s = time.perf_counter() - t0
        pred = inference.create_predictor(inference.Config(bert_prefix))
        rs = np.random.RandomState(60)
        with capi.CPredictor(bert_prefix) as cp:
            for b in CAPI_BATCHES:
                ids = rs.randint(0, cfg["vocab"], (b, cfg["seq"]))
                idf = ids.astype(np.float32)
                support.reset_launch_counts()
                got, = cp.run([idf])
                counts = dict(support.launch_counts)
                launches += counts.get("flash_attention_fwd", 0)
                want = np.asarray(pred.run([ids])[0])
                err = _np_rel_err(np, got, want)
                c_ms = _capi_ms(np, lambda: cp.run([idf]), CAPI_RUNS[b])
                p_ms = _capi_ms(np, lambda: np.asarray(pred.run([ids])[0]),
                                CAPI_RUNS[b])
                rows[b] = {"capi_ms": c_ms, "predictor_ms": p_ms,
                           "runs": CAPI_RUNS[b], "launches": counts,
                           "rel_err_vs_predictor": err,
                           "output_shape": list(got.shape)}
                quantities[f"batch {b}: |K1f launches - 12|"] = (abs(
                    counts.get("flash_attention_fwd", 0) - cfg["layers"]), 0)
                quantities[f"batch {b}: other kernels launched"] = (sum(
                    n for k, n in counts.items()
                    if k != "flash_attention_fwd"), 0)
                quantities[f"batch {b}: rel err vs Predictor.run"] = (
                    err, FLASH_TOL["float32"])
        del pred
        torch.cuda.empty_cache()
        c = BERT_CPU
        paddle.seed(60)
        small = build_model(c["vocab"], c["hidden"], c["layers"], c["heads"],
                            c["ffn"], c["seq"], 0.0, device="cuda")
        small.eval()
        spfx = os.path.join(artifacts, "small_bert")
        jit.save(small, spfx, input_spec=[jit.InputSpec([None, c["seq"]],
                                                        "int64")])
        del small
        B = 2
        ids = (np.arange(B * c["seq"]) * 7 % c["vocab"]).reshape(
            B, c["seq"])
        want = np.asarray(inference.create_predictor(inference.Config(
            spfx)).run([ids])[0]).astype(np.float64)
        src = os.path.join(artifacts, "capi_main.c")
        exe = os.path.join(artifacts, "capi_main")
        with open(src, "w") as f:
            f.write(_CAPI_C_MAIN)
        so = capi.load_capi()._name
        subprocess.run(["gcc", src, f"-I{capi.CSRC}", "-o", exe, so,
                        f"-Wl,-rpath,{os.path.dirname(so)}",
                        *capi.python_link_flags()],
                       check=True, capture_output=True, text=True)
        env = {k: v for k, v in os.environ.items() if k != capi.DEVICE_ENV}
        env["PYTHONPATH"] = os.pathsep.join([ROOT] + site.getsitepackages())
        t0 = time.perf_counter()
        r = subprocess.run([exe, spfx, str(B), str(c["seq"]),
                            str(c["vocab"])], capture_output=True, text=True,
                           env=env, timeout=600)
        c_prog_s = time.perf_counter() - t0
        if r.returncode != 0 or not r.stdout.startswith("OK"):
            raise AssertionError(f"C program failed ({r.returncode}): "
                                 f"{r.stdout} {r.stderr[-3000:]}")
        fields = dict(kv.split("=") for kv in r.stdout.split()[1:])
        sums = {"sum": float(fields["sum"]), "abs": float(fields["abs"])}
        quantities["C program: |numel - B x L x H|"] = (abs(
            int(fields["numel"]) - B * c["seq"] * c["hidden"]), 0)
        abs_sum = float(np.abs(want).sum())
        quantities["C program: abs-sum rel err"] = (
            abs(sums["abs"] - abs_sum) / abs_sum, 1e-4)
        # the hidden states are layer-normed rows: their plain sum is
        # near 0, so its error is taken relative to the abs-sum
        quantities["C program: sum err / abs-sum"] = (
            abs(sums["sum"] - float(want.sum())) / abs_sum, 1e-4)
    finally:
        if prev_env is not None:
            os.environ[capi.DEVICE_ENV] = prev_env
    out = {"build_s": build_s, "library": so, "batches": rows,
           "c_program": {"config": c, "batch": B, "seconds": c_prog_s,
                         "checksums": sums, "predictor_sum": float(
                             want.sum()),
                         "predictor_abs_sum": float(np.abs(want).sum())},
           "nvidia_smi": nvidia_smi()}
    log("CAPI " + json.dumps(out))
    _check("CAPI_CHECK", quantities)
    return {"flash_attention_fwd": launches}


@_keeps_global_state
def phase_generation_baseline():
    """61 generation_baseline: ``bench_generation`` whole
    (bench.py:930-1086): ``PagedDecoderLM(1024, 256, 2 layers, 8 heads,
    ffn 2048)`` on the card, 48 requests (prompts of 4-32, budgets
    16-48), each generated alone by ``nn.dynamic_decode`` over
    ``make_cell``'s dense cache of 512 rows (beam 1), against the paged
    ``GenerationEngine`` (8 slots, pages of 8, 128 pages), 2 rounds
    interleaved: tokens/s of both, the speedup, both p99s and
    ``latency_bound_ms`` (bench.py's >= 3x gate printed, not asserted);
    every baseline sequence ends in EOS after its budget, the engine
    gives every budget, no variant after warm-up; the cell's logits on
    the card within ``TOL`` of the CPU's over one request's first 8
    steps."""
    import numpy as np
    import torch
    from paddle_tpu_torch import nn, serving
    model = serving.PagedDecoderLM(**GEN_BASELINE, device="cuda")
    EOS = model.vocab_size - 1
    rng = np.random.RandomState(42)
    prompts = [rng.randint(0, 128, rng.choice(GEN_PROMPT_LENGTHS)).tolist()
               for _ in range(GEN_REQUESTS)]
    budgets = [int(rng.randint(GEN_BUDGETS[0], GEN_BUDGETS[1] + 1))
               for _ in range(GEN_REQUESTS)]
    t_decode_max = GEN_BUDGETS[1] + 1
    dec = nn.BeamSearchDecoder(model.make_cell(EOS), start_token=0,
                               end_token=EOS, beam_size=1)

    def gen_one(prompt, limit):
        st = model.init_cell_state(prompt, GEN_T_MAX)
        st["limit"] = np.full((1,), limit, np.int32)
        dec.start_token = int(prompt[-1])
        seq, _, lens = nn.dynamic_decode(dec, st, max_step_num=t_decode_max,
                                         return_length=True, cache=True)
        n = int(np.asarray(lens.numpy())[0, 0])
        return np.asarray(seq.numpy())[0, 0, :n]

    for L in sorted({len(p) for p in prompts}):
        gen_one(list(range(1, L + 1)), 2)
    errors, conc_lat, seq_lat = [], [], []
    with _ServingScope():
        engine = serving.GenerationEngine(
            model, num_slots=GEN_SLOTS, page_size=8, max_context=GEN_T_MAX,
            num_pages=128, prompt_buckets=[8, 16, 32],
            max_queue=4 * GEN_REQUESTS, device="cuda")
        try:
            engine.warmup()

            def client(idx):
                try:
                    for i in range(idx, GEN_REQUESTS, GEN_SLOTS):
                        t0 = time.perf_counter()
                        out = engine.generate_sync(prompts[i], timeout=300,
                                                   max_new_tokens=budgets[i])
                        conc_lat.append(time.perf_counter() - t0)
                        if len(out) != budgets[i]:
                            errors.append(f"engine request {i}: {len(out)} "
                                          f"tokens, budget {budgets[i]}")
                except BaseException as e:   # noqa: BLE001 - gated below
                    errors.append(f"{type(e).__name__}: {e}")

            dt_seq = dt_conc = 0.0
            for _ in range(GEN_REPS):
                t0 = time.perf_counter()
                for p, b in zip(prompts, budgets):
                    t1 = time.perf_counter()
                    out = gen_one(p, b)
                    seq_lat.append(time.perf_counter() - t1)
                    if len(out) != b + 1 or out[-1] != EOS:
                        errors.append(f"baseline: {len(out)} tokens for "
                                      f"budget {b}")
                dt_seq += time.perf_counter() - t0
                threads = [threading.Thread(target=client, args=(c,),
                                            name=f"gen-client-{c}")
                           for c in range(GEN_SLOTS)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(600)
                dt_conc += time.perf_counter() - t0
            st = engine.stats()
        finally:
            engine.close()
    # the cell on the card against the same weights on the CPU
    cpu_model = serving.PagedDecoderLM(**GEN_BASELINE, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    cell_err, tok = 0.0, prompts[0][-1]
    states = {d: m.init_cell_state(prompts[0], GEN_T_MAX)
              for d, m in (("cuda", model), ("cpu", cpu_model))}
    cells = {"cuda": model.make_cell(EOS), "cpu": cpu_model.make_cell(EOS)}
    for d in states:
        states[d]["limit"] = torch.full((1,), budgets[0], dtype=torch.int32,
                                        device=d)
    for _ in range(8):
        logits = {}
        for d in ("cuda", "cpu"):
            logits[d], states[d] = cells[d](
                torch.tensor([tok], device=d), states[d])
        cell_err = max(cell_err, _rel_err(logits["cuda"].cpu(),
                                          logits["cpu"]))
        tok = int(logits["cpu"].argmax())

    def p99(lat):
        return float(np.percentile(np.asarray(lat) * 1000.0, 99))

    toks = sum(budgets) * GEN_REPS
    bound_ms = max(900.0, 3.5 * p99(seq_lat))
    speedup = dt_seq / dt_conc
    out = {"tokens_per_sec": toks / dt_conc,
           "dynamic_decode_tokens_per_sec": toks / dt_seq,
           "speedup_vs_dynamic_decode": speedup,
           "gate_3x_met": speedup >= 3.0,
           "latency_bound_ms": bound_ms,
           "p99_latency_ms": p99(conc_lat),
           "p99_latency_ms_baseline": p99(seq_lat),
           "p99_within_bound": p99(conc_lat) <= bound_ms,
           "ttft_ms_p95": st["ttft_ms"]["p95"],
           "mean_slot_occupancy": st["mean_slot_occupancy"],
           "decode_steps": st["counters"]["decode_steps"],
           "recompiles_after_warmup": st["recompiles_after_warmup"],
           "cell_logits_rel_err_card_vs_cpu": cell_err,
           "requests": GEN_REQUESTS * GEN_REPS, "nvidia_smi": nvidia_smi(),
           "config": dict(GEN_BASELINE, t_max=GEN_T_MAX, beam=1,
                          slots=GEN_SLOTS, page_size=8, num_pages=128,
                          prompt_lengths=GEN_PROMPT_LENGTHS,
                          budgets=list(GEN_BUDGETS), rounds=GEN_REPS)}
    log("GENERATION_BASELINE " + json.dumps(out))
    _check("GENERATION_BASELINE_CHECK", {
        "sequences off their budget or EOS": (len(errors), 0),
        "recompiles_after_warmup": (st["recompiles_after_warmup"], 0),
        "cell logits rel err card vs CPU": (cell_err, TOL["float32"])})
    del model, cpu_model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phases 62-64
# GPT `1b` widths (bench.py:318) at 2 of its 24 layers: each published
# version of its parameters stays well under 1 GB
HOTSWAP_GPT = dict(GPT_1B, num_layers=2)
HOTSWAP_CLIENTS, HOTSWAP_GEN_CLIENTS, HOTSWAP_POOL = 8, 3, 12
HOTSWAP_PROMPTS = 6
HOTSWAP_VERSIONS = (1, 2, 3)
HOTSWAP_WINDOW_S = 1.5          # traffic on each version between swaps
ELASTIC_WINDOW_S = 2.0
PROM_LINE = r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.eE+naif]+$"


def _mem(torch, dev):
    """``(allocated, peak)`` bytes on ``dev`` (0, 0 off the card)."""
    if torch.device(dev).type != "cuda":
        return 0, 0
    return torch.cuda.memory_allocated(dev), torch.cuda.max_memory_allocated(
        dev)


def _version_factors(np, names, version):
    """A seeded per-tensor factor in [0.9, 1.1] for every floating
    parameter of one published version (version 0: the weights as they
    are)."""
    rs = np.random.RandomState(620 + version)
    return {n: (1.0 if version == 0 else float(rs.uniform(0.9, 1.1)))
            for n in sorted(names)}


def _bert_versions(np, prefix, workdir, versions):
    """R1's artifact with every floating weight scaled by its version's
    factors: one ``jit.save`` prefix a version (the program file is the
    same; ``.pdiparams`` carries the weights)."""
    import torch
    from paddle_tpu_torch import framework_io
    from paddle_tpu_torch.jit.save_load import SUFFIX_MODEL, SUFFIX_PARAMS
    with open(prefix + SUFFIX_PARAMS, "rb") as f:
        state = framework_io.loads(f.read(), device="cpu")
    base = {k: v.numpy() for k, v in state.items()}
    out = {0: prefix}
    for v in versions:
        fac = _version_factors(np, [k for k, a in base.items()
                                    if a.dtype.kind == "f"], v)
        new = {k: torch.from_numpy(a * np.asarray(fac[k], a.dtype)
                                   if k in fac else a)
               for k, a in base.items()}
        p = os.path.join(workdir, f"bert_v{v}")
        shutil.copyfile(prefix + SUFFIX_MODEL, p + SUFFIX_MODEL)
        framework_io.save(new, p + SUFFIX_PARAMS)
        out[v] = p
    return out


def _gpt_versions(np, model, versions):
    """The GPT's parameters by version in paddle_tpu's layout (numpy by
    paddle_tpu's names), version 0 the model's own."""
    base = {k: v.detach().cpu().numpy() for k, v in model.params.items()}
    out = {0: base}
    for v in versions:
        fac = _version_factors(np, base, v)
        out[v] = {k: a * np.asarray(fac[k], a.dtype)
                  for k, a in base.items()}
    return out


def _hotswap_requests(np, cfg, n):
    rs = np.random.RandomState(62)
    return [rs.randint(0, cfg["vocab"], (int(rs.randint(1, 5)),
                                          cfg["seq"])).astype(np.int64)
            for _ in range(n)]


def _hotswap_prompts(np, vocab, n):
    rs = np.random.RandomState(621)
    return [dict(prompt=rs.randint(0, vocab, int(rs.randint(16, 49))).tolist(),
                 max_new_tokens=int(rs.randint(8, 17)))
            for _ in range(n)]


def _match_version(np, got, refs, i, tol):
    """The versions whose answer to request ``i`` (run alone) ``got``
    is within ``tol`` of, and the errors by version."""
    errs = {v: _np_rel_err(np, got, r[i]) for v, r in refs.items()}
    return [v for v, e in errs.items() if e <= tol], errs


def _pctl(np, xs, q):
    return float(np.percentile(xs, q)) if len(xs) else None


def _time_swap_stages(watcher, store, engine, gen):
    """Time the watcher's stages by version (the payloads' read, digest
    check and decode; the replacement predictor's load; its prewarm;
    the inference commit; the GPT parameters' upload and commit) by
    wrapping them on these instances; returns ``{version: {stage:
    seconds}}``, filled as swaps run."""
    stages, current = {}, {"v": None}

    def wrap(obj, attr, stage):
        fn = getattr(obj, attr)

        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                v = current["v"]
                stages.setdefault(v, {})[stage] = round(
                    stages.get(v, {}).get(stage, 0.0)
                    + time.perf_counter() - t, 4)
        setattr(obj, attr, timed)

    snap_fn = store.latest_snapshot

    def latest():
        snap = snap_fn()
        if snap is not None:
            current["v"] = int(snap.get("step") or 0)
        return snap
    store.latest_snapshot = latest
    wrap(store, "load_payloads", "read, verify and decode payloads")
    wrap(engine, "prewarm_predictor", "prewarm the replacement")
    wrap(watcher, "_build_predictor", "load and prewarm the replacement")
    wrap(engine, "swap_predictor", "inference commit")
    wrap(gen, "swap_weights", "GPT upload and commit")
    return stages


def _hotswap_stack(bert_prefix, store_dir, gpt_model, dev, poll_s=0.05):
    """R1 behind a registry (``load(weights_dir=store_dir)``), the paged
    GPT engine under the same watcher, one HTTP server over both."""
    from paddle_tpu_torch import serving
    reg = serving.ModelRegistry()
    entry = reg.load("bert", bert_prefix, weights_dir=store_dir,
                     weights_poll_s=poll_s, engine_kwargs={
                         "max_batch_size": SERVING_MAX_BATCH,
                         "batch_timeout_ms": 2.0, "max_queue": 256})
    gen = serving.GenerationEngine(gpt_model, num_slots=SLOTS,
                                   page_size=PAGE, max_context=MAX_CONTEXT,
                                   prompt_buckets=[32, 64], device=dev,
                                   name="gpt")
    gen.warmup()
    reg.register("gpt", generation=gen)
    # one watcher swaps both engines: the registry's, given the engine
    entry.watcher.generation = gen
    srv = serving.ServingServer(entry.engine, generation=gen, registry=reg,
                                port=0, request_timeout=300).start()
    return reg, entry, gen, srv


def _close_stack(reg, gen, srv):
    srv.close()
    reg.close(timeout=60)
    gen.close()


def _cold_start_parts(prefix):
    """A BERT-base replica's cold start in a fresh process, by part:
    the interpreter with torch and the port, the CUDA context, the
    import of ``torch.export``'s deserializer, the ``torch.export``
    load, the weights onto the card, the program's
    move onto the card, the kernel library (built once a source hash
    under ``build/``; here a cache hit), a second ``torch.export`` load
    (the deserialization alone, the first one's imports done), each
    bucket's first run, and the first request after them."""
    code = r"""
import json, sys, time
t0 = time.perf_counter()
import numpy as np, torch
import paddle_tpu_torch as paddle
from paddle_tpu_torch import framework_io
from paddle_tpu_torch.jit import save_load
from paddle_tpu_torch.ops.cuda import support
parts = {"import torch and the port": time.perf_counter() - t0}
def part(name, fn):
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    parts[name] = time.perf_counter() - t
    return out
prefix = sys.argv[1]
part("CUDA context", lambda: torch.zeros(1, device="cuda"))
import importlib
part("import torch.export's deserializer",
     lambda: importlib.import_module("torch._export.serde.serialize"))
meta, program = part("torch.export load", lambda: save_load.read_artifact(prefix))
state = part("weights onto the card", lambda: framework_io.loads(
    open(prefix + save_load.SUFFIX_PARAMS, "rb").read(), device="cuda"))
layer = part("program onto the card", lambda: save_load.TranslatedLayer(
    meta, program, state, torch.device("cuda")))
part("kernel library (cached build)", support.load_library)
part("torch.export load, again (deserialization alone)",
     lambda: save_load.read_artifact(prefix))
seq = meta["in_shapes"][0][1]
for b in (1, 2, 4, 8, 16, 32):
    x = torch.zeros((b, seq), dtype=torch.int64, device="cuda")
    part(f"bucket {b}", lambda: layer.run_flat([x]))
x = np.random.RandomState(0).randint(0, 1000, (4, seq)).astype(np.int64)
part("first request (4 rows, read to the host)",
     lambda: np.asarray(layer.run_flat([torch.from_numpy(x).cuda()])[0].cpu()))
parts["total"] = time.perf_counter() - t0
print("COLD " + json.dumps(parts))
"""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code, prefix], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("COLD ")]
    if out.returncode != 0 or not line:
        raise AssertionError(f"cold start probe failed: {out.stderr[-2000:]}")
    parts = json.loads(line[0][5:])
    parts["process wall"] = wall
    return parts


def _hotswap_clients(cfg_path):
    """The client process of phase 62: closed-loop ``/predict`` clients
    (each answer matched, here, against every version's answer to that
    request run alone), streaming ``/generate`` clients (the generation
    engine's version read from ``/metrics`` before and after each) and
    a ``/healthz`` prober, until the parent creates ``stop``; the
    results go to ``results.json``.  Times are ``time.monotonic()``,
    the clock the parent stamps its swap windows with."""
    import numpy as np
    from paddle_tpu_torch import serving
    deadline = time.monotonic() + 900
    while not os.path.exists(cfg_path):     # the parent writes it once
        if time.monotonic() > deadline:     # its server is up
            raise SystemExit("no client configuration came")
        time.sleep(0.05)
    with open(cfg_path) as f:
        cfg = json.load(f)
    d = cfg["dir"]
    with np.load(os.path.join(d, "reqs.npz")) as z:
        reqs = [z[f"r{i}"] for i in range(len(z.files))]
    refs = {}
    with np.load(os.path.join(d, "refs.npz")) as z:
        for k in z.files:
            v, i = (int(x) for x in k[1:].split("_"))
            refs.setdefault(v, {})[i] = z[k]
    stop = os.path.join(d, "stop")
    answers, gens, probes, errors = [], [], [], []
    t_start = time.monotonic()

    def predict_client(c):
        cl = serving.Client(cfg["url"], timeout=600)
        k = c
        try:
            while not os.path.exists(stop):
                i = k % len(reqs)
                k += cfg["predict"]
                t0 = time.monotonic()
                got = cl.predict_npy(reqs[i], model="bert")
                t1 = time.monotonic()
                vs, errs = _match_version(np, got, refs, i, cfg["tol"])
                answers.append((c, i, t0, t1, vs,
                                errs[vs[0]] if vs else None))
                if len(answers) == 1:
                    open(os.path.join(d, "ready"), "w").close()
        except BaseException as e:      # noqa: BLE001 - reported
            errors.append(("predict", repr(e)))
        finally:
            cl.close()

    def gen_version(cl):
        return int(cl.metrics()["generation"]["weights_version"])

    def gen_client(c):
        cl = serving.Client(cfg["url"], timeout=600)
        k = c
        try:
            while not os.path.exists(stop):
                i = k % len(cfg["prompts"])
                k += cfg["generate"]
                v0 = gen_version(cl)
                toks = list(cl.generate_stream(model="gpt",
                                               **cfg["prompts"][i]))
                gens.append((i, v0, gen_version(cl), toks))
        except BaseException as e:      # noqa: BLE001 - reported
            errors.append(("generate", repr(e)))
        finally:
            cl.close()

    def prober():
        cl = serving.Client(cfg["url"], timeout=600)
        try:
            while not os.path.exists(stop):
                h = cl.healthz()
                probes.append((h.get("ready"), h.get("status"),
                               h.get("weights_version")))
                time.sleep(0.02)
        except BaseException as e:      # noqa: BLE001 - reported
            errors.append(("healthz", repr(e)))
        finally:
            cl.close()

    threads = ([threading.Thread(target=predict_client, args=(c,))
                for c in range(cfg["predict"])]
               + [threading.Thread(target=gen_client, args=(c,))
                  for c in range(cfg["generate"])]
               + [threading.Thread(target=prober)])
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with open(os.path.join(d, "results.json.tmp"), "w") as f:
        json.dump({"answers": answers, "generations": gens,
                   "probes": probes, "errors": errors,
                   "seconds": time.monotonic() - t_start}, f)
    os.replace(os.path.join(d, "results.json.tmp"),
               os.path.join(d, "results.json"))


def _spawn_hotswap_clients(d):
    """Start :func:`_hotswap_clients` in a process of its own early (its
    interpreter and torch import while the parent builds the versions
    and the server); it waits for :func:`_configure_hotswap_clients`."""
    os.makedirs(d)
    cfg = os.path.join(d, "cfg.json")
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            f"chip_smoke._hotswap_clients({cfg!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _configure_hotswap_clients(np, proc, d, url, reqs, refs, prompts, tol):
    """Hand the client process its server, requests, answers by version
    and prompts, and wait (a poll with a deadline) for its first
    answer."""
    np.savez(os.path.join(d, "reqs.npz"),
             **{f"r{i}": r for i, r in enumerate(reqs)})
    np.savez(os.path.join(d, "refs.npz"),
             **{f"v{v}_{i}": a for v, rs in refs.items()
                for i, a in enumerate(rs)})
    cfg = os.path.join(d, "cfg.json")
    with open(cfg + ".tmp", "w") as f:
        json.dump({"url": url, "dir": d, "predict": HOTSWAP_CLIENTS,
                   "generate": HOTSWAP_GEN_CLIENTS, "prompts": prompts,
                   "tol": tol}, f)
    os.replace(cfg + ".tmp", cfg)
    deadline = time.monotonic() + 300
    while not os.path.exists(os.path.join(d, "ready")):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            raise AssertionError(f"the client process did not start: "
                                 f"{proc.communicate()[0][-3000:]}")
        time.sleep(0.05)


def _stop_hotswap_clients(proc, d):
    open(os.path.join(d, "stop"), "w").close()
    try:
        out, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    path = os.path.join(d, "results.json")
    if proc.returncode != 0 or not os.path.exists(path):
        raise AssertionError(f"the client process failed "
                             f"(rc {proc.returncode}): {out[-3000:]}")
    with open(path) as f:
        return json.load(f)


@_keeps_global_state
def phase_hotswap_serving(bert_prefix, dev="cuda"):
    """62 hotswap_serving: ``chaos.swap_main(supervised=False)``'s gate
    on the card.  R1 behind ``ModelRegistry.load(weights_dir=...)`` on a
    ``SnapshotStore`` and the paged ``GenerationEngine`` at GPT `1b`
    widths cut to 2 layers (8 slots) under the same ``WeightWatcher``,
    one ``ServingServer`` over both; 8 closed-loop ``/predict`` clients
    (1-4 rows x 512 tokens) and 3 streaming ``/generate`` clients while
    versions 1-3 (seeded per-tensor factors) are published, then version
    4 with one byte of its payload flipped; then the rollback case (the
    generation apply fails after the inference commit).  Asserts every
    answer against each version's answer run alone, versions never
    going back, generations inside one version against that version's
    serial tokens, the swap counters, readiness, no new variant, K1f
    12 a dispatched batch (and a prewarm run), K4 2 a decode step, the
    page pool, and memory back at rest after the swaps; prints the
    swap windows' p50/p99 beside steady state, publish to commit, the
    peak with two predictors resident, and the cold start by part."""
    import gc
    import re
    import warnings
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference, serving
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.serving.hotswap import (PARAMS_PAYLOAD,
                                                  publish_weights)
    from paddle_tpu_torch.serving.models import params_from_paddle_tpu
    from paddle_tpu_torch.utils import monitor
    from paddle_tpu_torch.utils.checkpoint import SnapshotStore
    cfg = BERT_CHIP
    tol = FLASH_TOL["float32"]
    work = tempfile.mkdtemp(prefix="chip_smoke_hotswap_")
    quantities, out, proc = {}, {}, None
    try:
        # the clients run in a process of their own, as a server's
        # clients do (their Python does not share this process's
        # interpreter lock with the engines); it starts now and waits
        cdir = os.path.join(work, "clients")
        proc = _spawn_hotswap_clients(cdir)
        t0 = time.perf_counter()
        bert = _bert_versions(np, bert_prefix, work, HOTSWAP_VERSIONS)
        out["bert versions written s"] = time.perf_counter() - t0
        reqs = _hotswap_requests(np, cfg, HOTSWAP_POOL)
        refs = {}
        for v, p in bert.items():
            pred = inference.create_predictor(inference.Config(p))
            refs[v] = [np.asarray(pred.run([r])[0]) for r in reqs]
            del pred
        gc.collect()
        distinct = min(_np_rel_err(np, refs[a][0], refs[b][0])
                       for a in refs for b in refs if a < b)
        quantities["versions' answers too close (min rel diff < 100 tol)"] = (
            int(distinct < 100 * tol), 0)
        paddle.seed(62)
        gpt = serving.PagedDecoderLM(seed=62, device=dev, **HOTSWAP_GPT)
        gparams = _gpt_versions(np, gpt, HOTSWAP_VERSIONS)
        gpt_bytes = sum(a.nbytes for a in gparams[0].values())
        prompts = _hotswap_prompts(np, HOTSWAP_GPT["vocab_size"],
                                   HOTSWAP_PROMPTS)
        # serial references: one engine swapped through the versions idle
        ref_model = serving.PagedDecoderLM(seed=62, device=dev,
                                           **HOTSWAP_GPT)
        ref_gen = serving.GenerationEngine(
            ref_model, num_slots=2, page_size=PAGE, max_context=MAX_CONTEXT,
            prompt_buckets=[32, 64], device=dev)
        ref_gen.warmup()
        gen_refs = {}
        try:
            for v in sorted(gparams):
                if v:
                    ref_gen.swap_weights(params_from_paddle_tpu(
                        gparams[v], device=dev), v)
                gen_refs[v] = [ref_gen.generate_sync(timeout=300, **p)
                               for p in prompts]
        finally:
            ref_gen.close()
        del ref_gen, ref_model
        gc.collect()
        store_dir = os.path.join(work, "weights")
        store = SnapshotStore(store_dir)
        swap0 = {k: monitor.get_stat(f"serving.swap.{k}")
                 for k in ("applied", "rejected", "rolled_back")}
        with _ServingScope():
            reg, entry, gen, srv = _hotswap_stack(bert_prefix, store_dir,
                                                  gpt, dev)
            eng, watcher = entry.engine, entry.watcher
            try:
                gc.collect()
                mem_idle_before = _mem(torch, dev)[0]
                stages = _time_swap_stages(watcher, watcher.store, eng, gen)
                b0 = eng.stats()["counters"]["batches"]
                d0 = gen.stats()["counters"]["decode_steps"]
                support.reset_launch_counts()
                _configure_hotswap_clients(np, proc, cdir, srv.url, reqs,
                                           refs, prompts, tol)
                windows, swaps = [], []
                try:
                    time.sleep(2 * HOTSWAP_WINDOW_S)
                    for v in HOTSWAP_VERSIONS:
                        if dev == "cuda":
                            torch.cuda.reset_peak_memory_stats(dev)
                        t_pub0 = time.monotonic()
                        publish_weights(store, v, artifact_prefix=bert[v],
                                        params=gparams[v])
                        t_pub1 = time.monotonic()
                        deadline = time.monotonic() + 300
                        while (watcher.version < v
                               and time.monotonic() < deadline):
                            time.sleep(0.005)
                        t_commit = time.monotonic()
                        if watcher.version != v:
                            raise AssertionError(
                                f"version {v} not applied: "
                                f"{watcher.last_error}")
                        windows.append((t_pub0, t_commit))
                        swaps.append({"version": v,
                                      "publish_s": t_pub1 - t_pub0,
                                      "publish_to_commit_s":
                                          t_commit - t_pub0,
                                      "commit_after_publish_s":
                                          t_commit - t_pub1,
                                      "peak_allocated_bytes":
                                          _mem(torch, dev)[1],
                                      "stages_s": stages.pop(v, {})})
                        time.sleep(HOTSWAP_WINDOW_S)
                    # the corrupted version 4: the poller stops first so
                    # the flip is seen by the digest check, not by timing
                    watcher.stop()
                    snap = publish_weights(store, 4, artifact_prefix=bert[3],
                                           params=gparams[3])
                    path = os.path.join(store.dir, snap["dir"],
                                        f"{PARAMS_PAYLOAD}.pdparams")
                    with open(path, "r+b") as f:
                        f.seek(20)
                        byte = f.read(1)
                        f.seek(20)
                        f.write(bytes([byte[0] ^ 0xFF]))
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        got4 = watcher.check_once()
                    time.sleep(0.5)
                finally:
                    client_out = _stop_hotswap_clients(proc, cdir)
                launches = dict(support.launch_counts)
                batches = eng.stats()["counters"]["batches"] - b0
                steps = gen.stats()["counters"]["decode_steps"] - d0
                after4 = {k: monitor.get_stat(f"serving.swap.{k}") - swap0[k]
                          for k in swap0}
                st_inf, st_gen = eng.stats(), gen.stats()
                gc.collect()
                mem_idle_after = _mem(torch, dev)[0]
                # the rollback case: the inference commit happens, then
                # the generation apply fails (a parameter's shape)
                bad = dict(gparams[1])
                k0 = sorted(bad)[0]
                bad[k0] = bad[k0].reshape(-1)
                publish_weights(store, 5, artifact_prefix=bert[1],
                                params=bad)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    got5 = watcher.check_once()
                rolled = {k: monitor.get_stat(f"serving.swap.{k}") - swap0[k]
                          for k in swap0}
                x_after = eng.infer_sync([reqs[0]], timeout=300)[0]
                gen_after = gen.generate_sync(timeout=300, **prompts[0])
            finally:
                watcher.stop()
                _close_stack(reg, gen, srv)
        # -- checks ----------------------------------------------------
        buckets = len(eng.buckets)
        answers, gens = client_out["answers"], client_out["generations"]
        probes, errors = client_out["probes"], client_out["errors"]
        quantities["failed or stranded requests"] = (
            len(errors) + st_inf["counters"].get("failed", 0)
            + st_inf["counters"].get("closed_stranded", 0)
            + st_gen["counters"].get("failed", 0), 0)
        matched, unmatched, ambiguous, worst = {}, 0, 0, 0.0
        last_by_client, backwards = {}, 0
        for c, i, t0, t1, vs, err in answers:
            if not vs:
                unmatched += 1
                continue
            if len(vs) > 1:
                ambiguous += 1
            v = vs[0]
            worst = max(worst, err)
            matched[v] = matched.get(v, 0) + 1
            if v < last_by_client.get(c, 0):
                backwards += 1
            last_by_client[c] = v
        quantities["/predict answers matching no version"] = (unmatched, 0)
        quantities["/predict answers matching two versions"] = (ambiguous,
                                                               0)
        quantities["max rel err vs the version's answer alone"] = (worst, tol)
        quantities["versions going back for a client"] = (backwards, 0)
        stable = [g for g in gens if g[1] == g[2]]
        quantities["stable generations unlike their version's serial "
                   "tokens"] = (sum(toks != gen_refs[v0][i]
                                    for i, v0, _, toks in stable), 0)
        quantities["no generation inside one version"] = (int(not stable), 0)
        versions_seen = [p[2] for p in probes]
        quantities["/healthz not ready"] = (
            sum(1 for r, s, _ in probes if not r or s != "running"), 0)
        quantities["/healthz weights_version going back"] = (sum(
            1 for a, b in zip(versions_seen, versions_seen[1:]) if b < a), 0)
        quantities["|/healthz last weights_version - 3|"] = (
            abs((versions_seen or [0])[-1] - 3), 0)
        quantities["|serving.swap.applied - 3|"] = (abs(after4["applied"]
                                                        - 3), 0)
        quantities["|serving.swap.rejected - 1| (after version 4)"] = (
            abs(after4["rejected"] - 1), 0)
        quantities["version 4 applied"] = (int(got4 is not None), 0)
        quantities["|engines' version after 4 - 3|"] = (
            abs(st_inf["weights_version"] - 3)
            + abs(st_gen.get("weights_version", gen.weights_version) - 3), 0)
        quantities["recompiles_after_warmup (inference)"] = (
            st_inf["recompiles_after_warmup"], 0)
        quantities["recompiles_after_warmup (generation)"] = (
            st_gen["recompiles_after_warmup"], 0)
        k1f = launches.get("flash_attention_fwd", 0)
        k4 = launches.get("paged_attention", 0)
        prewarm_runs = len(HOTSWAP_VERSIONS) * buckets
        quantities["|K1f - 12 x (batches + prewarm runs)|"] = (abs(
            k1f - cfg["layers"] * (batches + prewarm_runs)), 0)
        quantities["|K4 - 2 x decode steps|"] = (
            abs(k4 - HOTSWAP_GPT["num_layers"] * steps), 0)
        quantities["other hand kernels launched"] = (sum(
            n for k, n in launches.items()
            if k not in ("flash_attention_fwd", "paged_attention")), 0)
        quantities["pages in use at the end"] = (
            st_gen["page_pool"]["in_use"], 0)
        quantities["|pages allocated - freed|"] = (abs(
            st_gen["counters"]["pages_allocated"]
            - st_gen["counters"]["pages_freed"]), 0)
        # at rest after the swaps: the replaced predictors are gone; the
        # GPT model object still holds its own (version 0) parameters
        # while the engine serves the swapped dict, one version more
        quantities["|allocated at rest after - before - one GPT version| "
                   "(MB)"] = (abs(mem_idle_after - mem_idle_before
                                  - gpt_bytes) / 2 ** 20, 64.0)
        quantities["|serving.swap.rolled_back - 1|"] = (
            abs(rolled["rolled_back"] - 1), 0)
        quantities["rollback case applied"] = (int(got5 is not None), 0)
        quantities["rel err after the rollback vs version 3 alone"] = (
            _np_rel_err(np, x_after, refs[3][0]), tol)
        quantities["generation after the rollback unlike version 3"] = (
            int(gen_after != gen_refs[3][0]), 0)
        lat = [(a[2], a[3]) for a in answers]
        in_win = [t1 - t0 for t0, t1 in lat
                  if any(t0 < w1 and t1 > w0 for w0, w1 in windows)]
        steady = [t1 - t0 for t0, t1 in lat
                  if not any(t0 < w1 and t1 > w0 for w0, w1 in windows)]
        cold = _cold_start_parts(bert_prefix)
        out.update({
            "config": {"bert": dict(cfg, dtype="float32", mode="eval"),
                       "gpt": dict(HOTSWAP_GPT, slots=SLOTS, page=PAGE,
                                   cut="2 of 24 layers"),
                       "clients": HOTSWAP_CLIENTS,
                       "generate_clients": HOTSWAP_GEN_CLIENTS,
                       "request_pool": HOTSWAP_POOL},
            "gpt_version_bytes": gpt_bytes,
            "requests": len(answers), "generations": len(gens),
            "stable_generations": len(stable), "probes": len(probes),
            "answers_by_version": matched, "swaps": swaps,
            "client_process_s": client_out["seconds"],
            "steady_ms": {"n": len(steady),
                          "p50": _pctl(np, steady, 50) * 1e3,
                          "p99": _pctl(np, steady, 99) * 1e3},
            "swap_window_ms": {"n": len(in_win),
                               "p50": (_pctl(np, in_win, 50) or 0) * 1e3,
                               "p99": (_pctl(np, in_win, 99) or 0) * 1e3},
            "allocated_at_rest_bytes": [mem_idle_before, mem_idle_after],
            "batches": batches, "decode_steps": steps,
            "launches": launches, "prewarm_runs": prewarm_runs,
            "swap_counters_after_v4": after4,
            "swap_counters_after_rollback": rolled,
            "cold_start_s": cold, "nvidia_smi": nvidia_smi()})
        log("HOTSWAP_SERVING " + json.dumps(out))
        _check("HOTSWAP_SERVING_CHECK", quantities)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.communicate()
        shutil.rmtree(work, ignore_errors=True)
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"flash_attention_fwd": k1f, "paged_attention": k4}


def _prom_families(re, text):
    """Problems with a Prometheus exposition: lines the grammar
    rejects, families typed more than once, samples outside their
    family's block."""
    bad, typed, order, current = [], {}, [], None
    line_re = re.compile(PROM_LINE)
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("# TYPE "):
            name = ln.split()[2]
            typed[name] = typed.get(name, 0) + 1
            current = name
            order.append(name)
            continue
        if ln.startswith("#"):
            continue
        if not line_re.match(ln):
            bad.append(ln)
            continue
        fam = re.split(r"[{ ]", ln, 1)[0]
        if current is None or not (fam == current or fam.startswith(
                current + "_")):
            bad.append(ln)
    return bad, [n for n, k in typed.items() if k > 1]


OBS_COST_WINDOW_S = 3.0      # one timed window of a mode
# off/on pairs, the order alternating (two keep the alternation; each
# pair more costs 12 s of the script's time limit)
OBS_COST_PAIRS = 2


def _paired_cost(measure, np, pairs=OBS_COST_PAIRS):
    """``measure(on)`` over ``pairs`` pairs of windows, off first in the
    even pairs and on first in the odd ones, after one discarded pair
    of warm-up.  Returns each mode's readings in order, and each pair's
    on/off ratio with its median and range."""
    measure(False)
    measure(True)
    got = {"off": [], "on": []}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            got["on" if on else "off"].append(measure(on))
    ratio = [a / b for a, b in zip(got["on"], got["off"])]
    got.update(on_over_off=ratio,
               on_over_off_median=float(np.median(ratio)),
               on_over_off_range=[min(ratio), max(ratio)],
               window_s=OBS_COST_WINDOW_S)
    return got


@_keeps_global_state
def phase_observability(bert_prefix, dev="cuda"):
    """63 observability: the tracer, the performance observatory and an
    SLO monitor over phase 62's stack (R1 under the registry, the paged
    GPT, one server): the Prometheus exposition parses with every
    family typed once and carries ``weights_version``; ``/perf`` has a
    sampled dispatch anatomy (host ms, device ms by CUDA events) and
    ``device_memory()`` is within 1 MB of ``torch.cuda.memory_allocated``;
    ``/admin/trace`` and ``assemble_trace`` join one request's spans
    from the client through the server to the engine's batch; two
    in-process exporters spool and ``/admin/fleet`` aggregates two
    servers; the flight recorder dumps once on a fault injected into
    the engine; and the cost of the tracer and perf on R1's requests/s
    and on the eager LeNet step."""
    import re
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import observability as obs, optimizer, serving
    from paddle_tpu_torch.core.enforce import UnavailableError
    from paddle_tpu_torch.observability import fleet
    from paddle_tpu_torch.testing import fault
    from paddle_tpu_torch.utils import monitor
    from paddle_tpu_torch.vision.models import LeNet
    cfg = BERT_CHIP
    quantities, out = {}, {}
    work = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    spool = os.path.join(work, "spool")
    reqs = _hotswap_requests(np, cfg, 32)
    old_flags = paddle.get_flags(["obs_spool_dir", "obs_role",
                                  "obs_export_interval_s"])
    try:
        paddle.seed(62)
        gpt = serving.PagedDecoderLM(seed=62, device=dev, **HOTSWAP_GPT)
        with _ServingScope():
            reg, entry, gen, srv = _hotswap_stack(
                bert_prefix, os.path.join(work, "weights"), gpt, dev)
            eng = entry.engine
            srv_b = client = None
            try:
                # the cost first: windows of several seconds, off and
                # on in pairs whose order alternates (off-on, on-off, ..)
                # so drift falls on both modes alike
                def hooks(on):
                    obs.disable()
                    obs.disable_perf()
                    if on:
                        obs.enable(capacity=65536)
                        obs.enable_perf(sample_every=4)

                def rate(on):
                    hooks(on)
                    n, wall = 0, 0.0
                    while wall < OBS_COST_WINDOW_S:
                        _, w = _closed_loop(eng, reqs, HOTSWAP_CLIENTS, 1)
                        n, wall = n + len(reqs), wall + w
                    hooks(False)
                    return n / wall
                out["r1_requests_per_s"] = _paired_cost(rate, np)
                paddle.seed(0)
                lenet = LeNet()
                opt = optimizer.Adam(learning_rate=1e-3,
                                     parameters=lenet.parameters())
                xv, yv = _lenet_batch(np)
                x, y = paddle.to_tensor(xv), paddle.to_tensor(yv)

                def lenet_step():
                    loss = F.cross_entropy(lenet(x), y)
                    loss.backward()
                    opt.step()
                    opt.clear_grad()
                    float(loss)

                def lenet_ms(on):
                    hooks(on)
                    n, t0 = 0, time.perf_counter()
                    while time.perf_counter() - t0 < OBS_COST_WINDOW_S:
                        lenet_step()
                        n += 1
                    ms = (time.perf_counter() - t0) * 1e3 / n
                    hooks(False)
                    return ms
                lenet_step()                    # Adam's state made
                trc = obs.enable(capacity=65536)
                e0 = trc.emitted
                lenet_step()
                out["lenet_op_events_a_step"] = trc.emitted - e0
                obs.disable()
                out["lenet_step_ms"] = _paired_cost(lenet_ms, np)
                del lenet, opt
                # now observe the served stack
                trc = obs.enable(capacity=65536)
                perf = obs.enable_perf(sample_every=2)
                rule = obs.SLORule("serving.engine.bert.latency_ms", 60000.0,
                                   window=30.0, quantile=0.99, min_count=1,
                                   name="bert_p99_latency_ms")
                obs.install_slo_monitor([rule])
                paddle.set_flags({"obs_spool_dir": spool,
                                  "obs_role": "replica-a",
                                  "obs_export_interval_s": 60.0})
                exp_a = obs.install_exporter()
                client = serving.Client(srv.url, trace_id="chip-63",
                                        timeout=600)
                _closed_loop(eng, reqs, HOTSWAP_CLIENTS, 1)
                got = client.predict_npy(reqs[0], model="bert")
                toks = client.generate([1, 2, 3], max_new_tokens=4,
                                       model="gpt")
                h = client.healthz()
                quantities["/healthz not ready with the SLO monitor"] = (
                    int(not h.get("ready") or h.get("slo") != "ok"), 0)
                text = client.metrics_text()
                bad, twice = _prom_families(re, text)
                quantities["exposition lines the grammar rejects"] = (
                    len(bad), 0)
                quantities["families typed twice"] = (len(twice), 0)
                quantities["exposition without weights_version"] = (int(
                    "paddle_tpu_serving_weights_version" not in text), 0)
                rep = client.perf()
                anat = rep["perf"].get("serving", {}).get(
                    "bert.dispatch", {})
                quantities["no sampled dispatch on /perf"] = (
                    int(not anat.get("sampled")), 0)
                quantities["dispatch device ms missing"] = (
                    int(not anat.get("device_ms_p50")), 0)
                torch.cuda.synchronize()
                dm = obs.device_memory()
                quantities["|device_memory - memory_allocated| (MB)"] = (
                    abs(dm["cuda:0"]["live_bytes"]
                        - torch.cuda.memory_allocated(0)) / 2 ** 20, 1.0)
                raw = client._post("/admin/trace?secs=0", b"",
                                   {"Content-Type": "application/json"})
                merged = json.loads(raw)
                quantities["no chrome event of the traced request"] = (
                    int(not any((e.get("args") or {}).get("trace")
                                == "chip-63"
                                for e in merged["traceEvents"])), 0)
                exp_a.flush()
                procs = fleet._merge_self(fleet.read_spool(spool))
                asm = fleet.assemble_trace(procs, "chip-63")
                quantities["trace not connected"] = (
                    int(not asm["connected"]), 0)
                need = {"client.predict", "http.predict", "enqueue",
                        "dispatch"}
                quantities["spans missing from the assembled trace"] = (
                    len(need - set(asm["names"])), 0)
                # a second replica: its own server and spool
                srv_b = serving.ServingServer(eng, port=0).start()
                paddle.set_flags({"obs_role": "replica-b"})
                obs.install_exporter()
                fv = fleet.FleetView(timeout_s=30.0)
                fv.register("bert", urls=[srv.url, srv_b.url])
                srv.attach_fleet(fv)
                snap = client._get_json("/admin/fleet")
                bert_fleet = snap["fleet"]["bert"]
                quantities["|fleet replicas ready - 2|"] = (
                    abs(bert_fleet["ready"] - 2), 0)
                quantities["|spooled processes - 2|"] = (
                    abs(len(fleet.read_spool(spool)) - 2), 0)
                # the flight recorder: one dump for one injected fault
                flight = os.path.join(work, "flight.json")
                obs.install_flight_recorder(path=flight)
                d0 = monitor.get_stat("flight.dumps")
                with fault.inject([fault.Rule(pattern="serving.dispatch",
                                              count=1,
                                              exc=UnavailableError)]):
                    eng.infer_sync([reqs[1]], timeout=300)
                dumps = monitor.get_stat("flight.dumps") - d0
                box = json.load(open(flight))
                quantities["|flight dumps - 1|"] = (abs(dumps - 1), 0)
                quantities["flight dump without the fault event"] = (int(
                    not any(e.get("kind") == "fault" for e in box["events"])),
                    0)
                out.update({
                    "exposition_lines": len(text.splitlines()),
                    "perf_dispatch_anatomy": anat,
                    "perf_identities": rep["perf"]["totals"],
                    "device_memory": dm,
                    "assembled_trace": asm,
                    "fleet": {"replicas": bert_fleet["count"],
                              "ready": bert_fleet["ready"],
                              "spooled": [p["label"] for p in
                                          fleet.read_spool(spool)]},
                    "flight": {"reason": box["reason"], "dumps": dumps},
                    "tracer": trc.ring_stats(), "answer_shape": list(
                        got.shape), "tokens": toks})
            finally:
                if client is not None:
                    client.close()
                obs.uninstall_flight_recorder()
                obs.uninstall_exporter()
                obs.uninstall_slo_monitor()
                obs.disable_perf()
                obs.disable()
                if srv_b is not None:
                    srv_b.close()
                _close_stack(reg, gen, srv)
    finally:
        paddle.set_flags(old_flags)
        shutil.rmtree(work, ignore_errors=True)
    out["nvidia_smi"] = nvidia_smi()
    log("OBSERVABILITY " + json.dumps(out))
    _check("OBSERVABILITY_CHECK", quantities)
    torch.cuda.empty_cache()


class _BertReplica:
    """One more R1 replica on the card for a ``ReplicaSet``: its own
    Predictor, engine and HTTP server, warmed before it reports ready,
    serving until :meth:`stop`."""

    def __init__(self, prefix, index):
        self.prefix, self.name = prefix, f"bert-replica-{index}"
        self.ready = False
        self.health_url = None
        self.exit_history = []
        self._stop = threading.Event()

    def run(self):
        from paddle_tpu_torch import inference, serving
        pred = inference.create_predictor(inference.Config(self.prefix))
        eng = serving.InferenceEngine(pred, max_batch_size=SERVING_MAX_BATCH,
                                      batch_timeout_ms=2.0, name=self.name)
        srv = serving.ServingServer(eng, port=0, ready=False).start()
        try:
            eng.warmup()
            srv.mark_ready()
            self.health_url = srv.url + "/healthz"
            self.ready = True
            self._stop.wait()
        finally:
            self.ready = False
            srv.close()
            eng.close()

    def stop(self):
        self._stop.set()


@_keeps_global_state
def phase_elasticity(bert_prefix, dev="cuda"):
    """64 elasticity: an ``ElasticityController`` over R1 behind the
    registry, its scaler a ``ReplicaSet`` of R1 replicas on the one card.
    With the objective below the p99 measured under 8 clients it scales
    up to ``max_replicas`` 2 and then sheds (``QueueFull``; 503 over
    HTTP) while ``/healthz`` answers 503 ``degraded``; with the
    objective raised it recovers and scales down.  Asserts the
    ``elasticity.*`` counters and the replica count."""
    import http.client
    import numpy as np
    import torch
    from paddle_tpu_torch import observability as obs, serving
    from paddle_tpu_torch.utils import monitor
    cfg = BERT_CHIP
    reqs = _hotswap_requests(np, cfg, 16)
    quantities, out = {}, {}
    names = ("scale_up", "scale_down", "shed", "recover")
    c0 = {k: monitor.get_stat(f"elasticity.{k}") for k in names}
    with _ServingScope():
        reg = serving.ModelRegistry()
        entry = reg.load("bert", bert_prefix, engine_kwargs={
            "max_batch_size": SERVING_MAX_BATCH, "batch_timeout_ms": 2.0,
            "max_queue": 256})
        srv = serving.ServingServer(entry.engine, registry=reg,
                                    port=0).start()
        rs = serving.ReplicaSet(lambda i: _BertReplica(bert_prefix, i),
                                name="bert")
        stop = threading.Event()
        shed, served, errors = [0], [0], []

        def client(c):
            k = c
            while not stop.is_set():
                try:
                    reg.infer_sync("bert", [reqs[k % len(reqs)]],
                                   timeout=300)
                    served[0] += 1
                except serving.QueueFull:
                    shed[0] += 1
                    time.sleep(0.01)
                except BaseException as e:   # noqa: BLE001 - checked
                    errors.append(repr(e))
                    return
                k += HOTSWAP_CLIENTS

        def health():
            conn = http.client.HTTPConnection(srv.host, srv.port,
                                              timeout=120)
            try:
                conn.request("GET", "/healthz")
                r = conn.getresponse()
                return r.status, json.loads(r.read() or b"{}")
            finally:
                conn.close()

        def predict_status():
            conn = http.client.HTTPConnection(srv.host, srv.port,
                                              timeout=300)
            try:
                conn.request("POST", "/predict", json.dumps(
                    {"inputs": [reqs[0].tolist()], "model": "bert"}),
                    {"Content-Type": "application/json"})
                r = conn.getresponse()
                r.read()
                return r.status
            finally:
                conn.close()

        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"elastic-client-{c}")
                   for c in range(HOTSWAP_CLIENTS)]
        ctl = None
        try:
            h0 = monitor.histogram_raw("serving.engine.bert.latency_ms")
            for t in threads:
                t.start()
            time.sleep(ELASTIC_WINDOW_S)
            # this phase's own window (earlier phases' engines shared
            # the name)
            h1 = monitor.histogram_raw("serving.engine.bert.latency_ms")
            counts = [a - (h0["counts"][j] if h0 else 0)
                      for j, a in enumerate(h1["counts"])]
            p99 = monitor.quantile_from_counts(
                counts, h1["count"] - (h0["count"] if h0 else 0), 0.99)
            rule = obs.SLORule("serving.engine.bert.latency_ms", 0.5 * p99,
                               window=ELASTIC_WINDOW_S, quantile=0.99,
                               min_count=8, name="bert_p99_latency_ms")
            obs.install_slo_monitor([rule])
            obs.slo_status()                # the window's first snapshot
            ctl = serving.ElasticityController(
                reg, rules_for=lambda name: [rule],
                scaler=lambda name, n: rs.scale_to(n - 1),
                min_replicas=1, max_replicas=2, breach_polls=1,
                clear_polls=1, cooldown_s=0.0)
            timeline = [("baseline", ctl.poll())]
            state = {}
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                time.sleep(ELASTIC_WINDOW_S / 2)
                r = ctl.poll()["bert"]
                timeline.append(("breach", r))
                if r["shedding"]:
                    state["healthz"] = health()
                    state["predict_status"] = predict_status()
                    break
            replicas_up = rs.count
            rule.objective = 1e7            # the objective raised
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                time.sleep(ELASTIC_WINDOW_S / 2)
                r = ctl.poll()["bert"]
                timeline.append(("raised", r))
                if not r["shedding"] and r["desired"] == 1:
                    break
            state["healthz_after"] = health()
        finally:
            stop.set()
            for t in threads:
                t.join(300)
            rs.stop()
            obs.uninstall_slo_monitor()
            srv.close()
            reg.close(timeout=60)
    c1 = {k: monitor.get_stat(f"elasticity.{k}") - c0[k] for k in names}
    quantities["client errors"] = (len(errors), 0)
    quantities["|replicas at the shed - 1 (2 in all)|"] = (
        abs(replicas_up - 1), 0)
    quantities["replicas left after recovery"] = (rs.count, 0)
    for k in names:
        quantities[f"elasticity.{k} missing"] = (int(c1[k] < 1), 0)
    quantities["no request shed with QueueFull"] = (int(shed[0] < 1), 0)
    quantities["|/predict status while shedding - 503|"] = (
        abs(state.get("predict_status", 0) - 503), 0)
    hz = state.get("healthz", (0, {}))
    quantities["/healthz while breached not 503 degraded"] = (
        int(hz[0] != 503 or hz[1].get("status") != "degraded"), 0)
    hz2 = state.get("healthz_after", (0, {}))
    quantities["/healthz after recovery not 200"] = (int(hz2[0] != 200), 0)
    out.update({"measured_p99_ms": p99, "objective_ms": 0.5 * p99,
                "counters": c1, "served": served[0], "shed": shed[0],
                "timeline": [(tag, {k: r[k] for k in ("burn", "desired",
                                                       "shedding")})
                             for tag, r in timeline[1:]],
                "healthz_while_breached": hz, "healthz_after": hz2,
                "nvidia_smi": nvidia_smi()})
    log("ELASTICITY " + json.dumps(out, default=str))
    _check("ELASTICITY_CHECK", quantities)
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phases 65-66
# phase 65's losses against phase 32's (the same model, seed and feed):
# phase 32 runs Adam with the kernel tier on, phase 65 AdamW (weight
# decay 0.01) through fleet with the tier off under the plan, as the
# reference routes it.  The decay moves a parameter by lr * 0.01 * |p|
# a step (1e-6 relative at lr 1e-4) and the unfused f32 products sum in
# another order (~1e-5 relative in the logits), so over 10 runs the
# losses (~10.8) stay within 2e-3 of each other
FLEET_LOSS_ATOL = 2e-3
# comm_smoke's grad_comm knobs (tools/comm_smoke.py:104-108): the fuse
# budget of bench_multichip's run, int8 blocks of 256
FLEET_GC = {"dtype": "int8", "block_size": 256, "error_feedback": True,
            "scatter_threshold_KB": 4.0, "overlap": "auto"}
FLEET_FUSE_MB = 0.05


def phase_fleet_static_gpt(warmup=2, steps=8):
    """bench_pallas's static GPT at its chip config, uncut, through
    ``fleet.init`` / ``distributed_optimizer(AdamW(1e-4))`` with ZeRO-3
    (``strategy.sharding`` stage 3) and comm_smoke's int8 ``grad_comm``,
    at world size 1 over NCCL, 2 + 8 runs: the plan's grad_comm status
    is ``off`` at dp 1; the kernel tier is off under the plan (0 K2, 0
    K3) and attention runs K1f and both K1b kernels once a layer a step;
    losses finite and within FLEET_LOSS_ATOL of phase 32's; the step p50
    and peak memory beside phase 32's and ``analyze(sharding=plan)``'s
    per-shard peak."""
    import numpy as np
    import torch
    from paddle_tpu_torch import distributed as dist, optimizer, static
    from paddle_tpu_torch.distributed import grad_comm as gc
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import build_gpt_static
    cfg = GPT_STATIC_CHIP
    t0 = time.perf_counter()
    strategy = dist.DistributedStrategy()
    strategy.sharding = True
    strategy.sharding_configs = {"stage": 3}
    strategy.fuse_grad_size_in_MB = FLEET_FUSE_MB
    strategy.grad_comm = dict(FLEET_GC)
    dist.fleet.init(is_collective=True, strategy=strategy)

    def minimize(loss):
        opt = dist.fleet.distributed_optimizer(
            optimizer.AdamW(learning_rate=1e-4))
        opt.minimize(loss)

    main, loss, feeds = build_gpt_static(**cfg, device="cuda",
                                         minimize=minimize)
    exe = static.Executor("cuda")
    feed = {k: torch.from_numpy(v).cuda()
            for k, v in feeds(np.random.RandomState(0)).items()}
    plan = exe._plan_for(main, main.parameters())
    status = gc.plan_status(plan)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    support.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(warmup + steps):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[0]))
    counts = dict(support.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    rep = main.analyze(fetch_list=[loss], chip="h100", sharding=plan)
    step = next(iter(exe._cache.values()))
    runs = warmup + steps
    per_step = _gpt_static_per_step([], cfg["layers"])
    want = {k: v * runs for k, v in per_step.items() if v}
    ref = _PHASE32.get("losses")
    err = (max(abs(a - b) for a, b in zip(losses, ref))
           if ref is not None else None)
    timed = step_ms[warmup:]
    out = {"config": cfg, "dtype": "float32", "optimizer": "AdamW(1e-4)",
           "strategy": {"sharding_stage": 3, "grad_comm": FLEET_GC,
                        "fuse_grad_size_in_MB": FLEET_FUSE_MB},
           "mesh": dict(plan.mesh.shape), "plan_status": status[0],
           "specs_dp": sum(1 for s in plan.param_specs if "dp" in s),
           "params": len(plan.param_specs),
           "setup_s": setup_s, "losses": losses,
           "phase32_losses": ref, "loss_max_abs_diff": err,
           "loss_atol": FLEET_LOSS_ATOL,
           "step_ms": timed, "step_ms_p50": float(np.median(timed)),
           "phase32_step_ms_p50": _PHASE32.get("step_ms_p50"),
           "max_memory_allocated": peak,
           "phase32_max_memory_allocated":
               _PHASE32.get("max_memory_allocated"),
           "analyze_peak_bytes_per_shard":
               rep.memory_per_shard.peak_bytes_donated,
           "analyze_peak_bytes_donated": rep.memory.peak_bytes_donated,
           "realized_kernels": step.kernels,
           "compile_count": exe.compile_count, "launches": counts,
           "launches_want": want, "device": nvidia_smi()}
    log("FLEET_STATIC_GPT " + json.dumps(out))
    if status[0] != "off":
        raise AssertionError(f"plan_status {status} at dp 1, want off")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if exe.compile_count != 1 or step.kernels:
        raise AssertionError(f"{exe.compile_count} builds, kernels "
                             f"{step.kernels}: want 1 and none")
    if counts != want:
        raise AssertionError(f"fleet static GPT launches {counts}, want "
                             f"{want}")
    if err is None or not err <= FLEET_LOSS_ATOL:
        raise AssertionError(f"losses {losses} vs phase 32's {ref}")
    exe.close()
    del main, exe, step
    torch.cuda.empty_cache()
    return counts


def _gpt_static_param_shapes(cfg):
    """``build_gpt_static``'s trainable parameters in program order: the
    token embedding, per layer ln1, q, k, v, proj, ln2, fc1, fc2 (weight
    and bias each), the final layer norm and the head (the position
    embedding is a recorded constant)."""
    V, H, F = cfg["vocab"], cfg["hidden"], cfg["ffn"]
    layer = [(H,), (H,), (H, H), (H,), (H, H), (H,), (H, H), (H,), (H, H),
             (H,), (H,), (H,), (H, F), (F,), (F, H), (H,)]
    return [(V, H)] + layer * cfg["layers"] + [(H,), (H,), (H, V), (V,)]


def _stage_ms(torch, fn, iters=5):
    """Device ms of ``fn()`` by CUDA events, after one untimed call."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def phase_grad_comm_stage(dp=4):
    """The grad_comm stage's own device work on CUDA tensors, at the
    static GPT's gradient sizes (phase 65's parameters, seeded values)
    and comm_smoke's fuse budget and block: the int8 block quantize and
    dequantize of every bucket, and the bucket flatten/unflatten, plain
    (the plan at dp 4) and FSDP (every dim-0-divisible gradient in
    shard-major rows), each held bitwise to the CPU and timed in ms a
    step (the sum over the plan's buckets)."""
    import torch
    from paddle_tpu_torch.distributed import grad_comm as gc
    shapes = _gpt_static_param_shapes(GPT_STATIC_CHIP)
    gen = torch.Generator(device="cuda").manual_seed(66)
    grads = [torch.randn(s, device="cuda", generator=gen) * 1e-3
             for s in shapes]
    cpu = [g.cpu() for g in grads]
    spec = gc.CommSpec("int8", FLEET_GC["block_size"], True,
                       FLEET_GC["scatter_threshold_KB"], FLEET_FUSE_MB,
                       "grad_comm")
    plain = gc.plan_reduction(shapes, dp=dp, cfg=spec)
    fsdp_idx = tuple(i for i, s in enumerate(shapes) if s[0] % dp == 0)
    fsdp = gc.plan_reduction(shapes, dp=dp, cfg=spec, fsdp=fsdp_idx)
    rows = {}
    block = spec.block_size

    def check(name, got, want):
        for a, b in zip(got, want):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"grad_comm stage {name}: card and "
                                     f"CPU differ")

    flats = [gc.flatten_bucket(grads, b) for b in plain.buckets]
    cflats = [gc.flatten_bucket(cpu, b) for b in plain.buckets]
    check("flatten", flats, cflats)
    back = [t for b, f in zip(plain.buckets, flats)
            for _, t in gc.unflatten_bucket(f, b, grads)]
    cback = [t for b, f in zip(plain.buckets, cflats)
             for _, t in gc.unflatten_bucket(f, b, cpu)]
    check("unflatten", back, cback)
    qs = [gc.quantize_int8_blocks(f, block) for f in flats]
    cqs = [gc.quantize_int8_blocks(f, block) for f in cflats]
    check("quantize", [t for q in qs for t in q], [t for q in cqs for t in q])
    deq = [gc.dequantize_int8_blocks(q, s, f.numel())
           for (q, s), f in zip(qs, flats)]
    cdeq = [gc.dequantize_int8_blocks(q, s, f.numel())
            for (q, s), f in zip(cqs, cflats)]
    check("dequantize", deq, cdeq)
    fb = [b for b in fsdp.buckets if b.algorithm == "rscatter"]
    ff = [gc.flatten_bucket_fsdp(grads, b, dp, block) for b in fb]
    cff = [gc.flatten_bucket_fsdp(cpu, b, dp, block) for b in fb]
    check("flatten_fsdp", ff, cff)
    fu = [t for b, f in zip(fb, ff)
          for _, t in gc.unflatten_bucket_fsdp(f.reshape(dp, -1)[1], b, dp,
                                               grads)]
    cfu = [t for b, f in zip(fb, cff)
           for _, t in gc.unflatten_bucket_fsdp(f.reshape(dp, -1)[1], b, dp,
                                                cpu)]
    check("unflatten_fsdp", fu, cfu)
    rows["flatten_ms"] = _stage_ms(torch, lambda: [
        gc.flatten_bucket(grads, b) for b in plain.buckets])
    rows["unflatten_ms"] = _stage_ms(torch, lambda: [
        gc.unflatten_bucket(f, b, grads)
        for b, f in zip(plain.buckets, flats)])
    rows["quantize_ms"] = _stage_ms(torch, lambda: [
        gc.quantize_int8_blocks(f, block) for f in flats])
    rows["dequantize_ms"] = _stage_ms(torch, lambda: [
        gc.dequantize_int8_blocks(q, s, f.numel())
        for (q, s), f in zip(qs, flats)])
    rows["flatten_fsdp_ms"] = _stage_ms(torch, lambda: [
        gc.flatten_bucket_fsdp(grads, b, dp, block) for b in fb])
    rows["unflatten_fsdp_ms"] = _stage_ms(torch, lambda: [
        gc.unflatten_bucket_fsdp(f.reshape(dp, -1)[1], b, dp, grads)
        for b, f in zip(fb, ff)])
    numel = sum(g.numel() for g in grads)
    out = {"gradients": len(shapes), "numel": numel, "dp": dp,
           "block": block, "fuse_grad_size_in_MB": FLEET_FUSE_MB,
           "buckets": len(plain.buckets), "fsdp_buckets": len(fb),
           "algorithms": plain.algo_counts(),
           "wire_bytes_per_step_dp4": plain.wire_bytes_per_step,
           "fp32_wire_bytes_per_step_dp4": plain.fp32_wire_bytes_per_step,
           "bitwise_vs_cpu": True, **rows, "device": nvidia_smi()}
    log("GRAD_COMM_STAGE " + json.dumps(out))
    del grads, flats, qs, deq, ff
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 67
# bench.py:318 (_GPT_PRESETS["1b"]) cut into a pipeline: batch 16 as 4
# microbatches (bench_gpt's chip batch), and the 2-layer f32 parity cut
PIPE_GPT = dict(vocab=50257, hidden=1792, layers=24, heads=14, ffn=7168,
                seq=1024, dropout=0.1, batch=16, microbatches=4)
PIPE_GPT_PARITY = dict(PIPE_GPT, layers=2, dropout=0.0, batch=2,
                       microbatches=2)
PIPE_RTOL = 1e-4
# the pipeline leg of phase 18: the 1b widths, 2 blocks a stage over 4
# cards, f32, dropout 0, batch 8 as 8 microbatches of one row
MULTI_PIPE = dict(PIPE_GPT, layers=8, dropout=0.0, batch=8, microbatches=8)


def _pipe_layers(torch, cfg, device, seed=67):
    """``build_gpt_pipeline`` at ``cfg`` from ``seed``: (stage, embed,
    head)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.testing.models import build_gpt_pipeline
    pt.seed(seed)
    return build_gpt_pipeline(cfg["vocab"], cfg["hidden"], cfg["layers"],
                              cfg["heads"], cfg["ffn"], cfg["seq"],
                              cfg["dropout"], device=device)


def _pipe_trainer(torch, layers, cfg, lr, clip=False, bf16=False):
    """The slice's entry points: ``stack_stage_params`` ->
    ``pipeline_train_fn`` (pp 1, ``cfg["microbatches"]``, remat on) and
    AdamW over the stack, the embedding and the head; returns
    ``step(ids, labels) -> loss`` and the parameters it trains.  The
    stage's own module is dropped: the stack holds its weights."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.parallel import pipeline_train_fn, \
        stack_stage_params
    from paddle_tpu_torch.testing.models import gpt_pipeline_loss
    stage, embed, head = layers
    stacked, _ = stack_stage_params([stage])
    fn = pipeline_train_fn(stage, gpt_pipeline_loss(cfg["vocab"]), 1,
                           cfg["microbatches"], embed_layer=embed,
                           head_layer=head, remat=True)
    layers[0] = None
    del stage
    ep, hp = list(embed.parameters()), list(head.parameters())
    params = list(stacked) + ep + hp
    opt = optimizer.AdamW(
        learning_rate=lr, parameters=params, weight_decay=0.01,
        grad_clip=optimizer.ClipGradByGlobalNorm(1.0) if clip else None,
        multi_precision=bf16)

    def step(ids, labels):
        loss = fn(stacked, ids, labels, ep, hp)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()
    return step, params, opt


@_keeps_global_state
def phase_pipeline_gpt_parity(steps=2):
    """67 pipeline_gpt_parity: the pipelined GPT at the 1b widths cut to
    2 layers (f32, dropout 0, batch 2 as 2 microbatches, remat on), 2
    AdamW steps through ``stack_stage_params`` / ``pipeline_train_fn``
    on the card, against the same model unpipelined through
    ``jit.TrainStep`` on the card and against the pipeline on the CPU,
    losses at rtol 1e-4; K1f launched twice a layer and microbatch a
    step (once recomputed), each K1b once."""
    import torch
    from paddle_tpu_torch import distributed as dist, jit, optimizer
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import gpt_pipeline_loss
    cfg = PIPE_GPT_PARITY
    prev_mesh = dist.get_mesh()
    dist.init_mesh({"pp": 1})
    try:
        t0 = time.perf_counter()
        state = [{k: v.detach().clone() for k, v in m.state_dict().items()}
                 for m in _pipe_layers(torch, cfg, "cpu")]
        losses, counts = {}, {}
        for dev in ("cpu", "cuda"):
            layers = list(_pipe_layers(torch, cfg, dev))
            for m, sd in zip(layers, state):
                m.load_state_dict({k: v.to(dev) for k, v in sd.items()})
            step, _, _ = _pipe_trainer(torch, layers, cfg, 1e-4)
            x, y = _bench_batch(torch, cfg, dev)
            x, y = x.long(), y.long()
            support.reset_launch_counts()
            losses[dev] = [float(step(x, y)) for _ in range(steps)]
            counts[dev] = dict(support.launch_counts)
            del step, layers
        # the same model unpipelined: embed -> blocks -> head in one
        # TrainStep on the card
        stage, embed, head = _pipe_layers(torch, cfg, "cuda")
        for m, sd in zip((stage, embed, head), state):
            m.load_state_dict({k: v.cuda() for k, v in sd.items()})
        whole = torch.nn.Sequential(embed, stage, head)
        ts = jit.TrainStep(whole, gpt_pipeline_loss(cfg["vocab"]),
                           optimizer.AdamW(learning_rate=1e-4,
                                           parameters=whole.parameters(),
                                           weight_decay=0.01))
        x, y = _bench_batch(torch, cfg, "cuda")
        x, y = x.long(), y.long()
        losses["train_step"] = [float(ts(x, y)) for _ in range(steps)]
        del whole, ts, stage, embed, head
        torch.cuda.empty_cache()
        rel = lambda a, b: max(abs(u - v) / abs(v)  # noqa: E731
                               for u, v in zip(a, b))
        per = cfg["layers"] * cfg["microbatches"] * steps
        want = dict(zip(FLASH_KERNELS, (2 * per, per, per)))
        out = {"config": cfg, "losses": losses,
               "launches": counts["cuda"], "launches_want": want,
               "seconds": time.perf_counter() - t0}
        log("PIPELINE_GPT_PARITY " + json.dumps(out))
        _check("PIPELINE_GPT_PARITY_CHECK", {
            "card_vs_train_step_rel": (rel(losses["cuda"],
                                           losses["train_step"]), PIPE_RTOL),
            "card_vs_cpu_rel": (rel(losses["cuda"], losses["cpu"]),
                                PIPE_RTOL),
            **{f"launches_off.{k}": (abs(counts["cuda"].get(k, 0) - n), 0)
               for k, n in want.items()}})
    finally:
        dist.set_mesh(prev_mesh)


# ------------------------------------------------------------ phase 68
def _resident_bytes(params, opt):
    slots = sum(t.numel() * t.element_size()
                for st in (opt._states or {}).values() for t in st.values()
                if hasattr(t, "numel"))
    return sum(p.numel() * p.element_size() for p in params), slots


@_keeps_global_state
def phase_pipeline_gpt_training(warmup=2, steps=6):
    """68 pipeline_gpt_training: the pipelined GPT at the 1b widths,
    uncut (24 blocks as one stage, the embedding first, an untied head
    last; batch 16 as 4 microbatches of 4, seq 1024, dropout 0.1, remat
    on), O2 bf16 with f32 masters, AdamW(2e-4, wd 0.01) with a
    global-norm clip 1.0, at world size 1 (pp 1): 2 warm-up and 6 timed
    steps, every loss finite, the first near ln(vocab), per step 192 K1f
    launches (24 blocks x 4 microbatches, doubled by the recompute) and
    96 of each K1b; the step p50, the peak memory and the bytes the
    trainer holds.  Then K1f and K1b at the microbatch's attention shape
    (B 4, L 1024, H 14, D 128, bf16, causal, dropout 0.1) against the
    plain version, and timed beside their bound and SDPA's."""
    import numpy as np
    import torch
    from paddle_tpu_torch import amp, distributed as dist
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import gpt_flops_per_step
    cfg = PIPE_GPT
    prev_mesh = dist.get_mesh()
    dist.init_mesh({"pp": 1})
    try:
        t0 = time.perf_counter()
        layers = list(_pipe_layers(torch, cfg, "cuda", seed=2024))
        amp.decorate(layers, level="O2", dtype="bfloat16")
        step, params, opt = _pipe_trainer(torch, layers, cfg, 2e-4,
                                          clip=True, bf16=True)
        batch = tuple(t.long() for t in _bench_batch(torch, cfg, "cuda"))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, counts = _train_steps(torch, step, batch,
                                               warmup + steps)
        peak = torch.cuda.max_memory_allocated()
        param_bytes, slot_bytes = _resident_bytes(params, opt)
        allocated = torch.cuda.memory_allocated()
        timed = step_ms[warmup:]
        mean_ms = sum(timed) / len(timed)
        tokens = cfg["batch"] * cfg["seq"]
        flops = gpt_flops_per_step(cfg["vocab"], cfg["hidden"],
                                   cfg["layers"], cfg["seq"], cfg["batch"],
                                   cfg["ffn"])
        runs = warmup + steps
        per = cfg["layers"] * cfg["microbatches"]
        want = dict(zip(FLASH_KERNELS, (2 * per * runs, per * runs,
                                        per * runs)))
        out = {"config": cfg, "dtype": "bfloat16 O2, f32 master weights",
               "pipeline": f"pp 1: {cfg['layers']} blocks one stage, "
                           f"embedding first, untied head last, "
                           f"{cfg['microbatches']} microbatches, remat",
               "params": sum(p.numel() for p in params),
               "setup_s": setup_s, "warmup_steps": warmup,
               "timed_steps": steps, "losses": losses, "step_ms": timed,
               "step_ms_p50": float(np.median(timed)),
               "step_ms_mean": mean_ms, "first_steps_ms": step_ms[:warmup],
               "tokens_per_s": tokens / (mean_ms / 1e3),
               "model_flops_per_step": flops,
               "mfu": flops / (mean_ms / 1e3) / PEAK_OPS["bfloat16"],
               "max_memory_allocated": peak,
               "memory_allocated_after": allocated,
               "param_bytes": param_bytes, "slot_bytes": slot_bytes,
               "launches": counts, "launches_want": want,
               "device": nvidia_smi()}
        log("PIPELINE_GPT_TRAIN " + json.dumps(out))
        _check("PIPELINE_GPT_TRAIN_CHECK", {
            "non_finite_losses": (sum(not math.isfinite(v)
                                      for v in losses), 0),
            "first_loss_from_ln_vocab": (abs(losses[0] - math.log(
                cfg["vocab"])), 1.0),
            **{f"launches_off.{k}": (abs(counts.get(k, 0) - n), 0)
               for k, n in want.items()}})
        x, y = batch
        per_step = {k: n // runs for k, n in want.items()}
        anatomy = _step_anatomy(
            "PIPELINE_GPT_ANATOMY", lambda: step(x, y), 2, lambda n: (
                "flash_fwd" if "flash_fwd_" in n else
                "flash_bwd" if "flash_bwd_" in n else
                "gemm" if _is_gemm(n) else
                "loss" if ("softmax" in n or "nll" in n) else
                "optimizer" if ("foreach" in n or "multi_tensor" in n)
                else "other"), wgmma_flash=True, timed_ms=timed)
        flash = {k: v for k, v in anatomy.items() if k.startswith("flash_")}
        wgmma = {"flash_fwd_wgmma_kernel": per_step["flash_attention_fwd"],
                 "flash_bwd_dq_wgmma_kernel":
                     per_step["flash_attention_bwd_dq"],
                 "flash_bwd_dkv_wgmma_kernel":
                     per_step["flash_attention_bwd_dkv"]}
        _check("PIPELINE_GPT_ANATOMY_CHECK", {
            f"{k}_launches_off": (abs(flash.get(k, 0) - n), 0)
            for k, n in wgmma.items()})
        del step, params, opt, layers
        torch.cuda.empty_cache()
        # the flash entry at the microbatch's attention shape
        mb = cfg["batch"] // cfg["microbatches"]
        H = cfg["heads"]
        D = cfg["hidden"] // H
        gen = torch.Generator(device="cuda")
        gen.manual_seed(68)
        errs = _flash_case(torch, gen, mb, cfg["seq"], H, D, torch.bfloat16,
                           True, cfg["dropout"], 1234, 1)
        log("FLASH_CHECK " + json.dumps({
            "case": f"B={mb} L={cfg['seq']} H={H} D={D} bfloat16 "
                    f"causal=True dropout={cfg['dropout']}",
            "errors": errs, "tol": FLASH_TOL["bfloat16"]}))
        _check("PIPELINE_FLASH_CHECK", {
            f"{k}_rel_err": (v, FLASH_TOL["bfloat16"])
            for k, v in errs.items()})
        rows = _flash_time_rows(torch, gen, mb, cfg["seq"], H, D,
                                torch.bfloat16, True, cfg["dropout"], 1234)
        for name, row in rows.items():
            row["launches_per_step"] = want[name] // runs
            row["max_abs_err_bf16"] = max(errs.values())
        return {k: counts.get(k, 0) for k in FLASH_KERNELS}, rows
    finally:
        dist.set_mesh(prev_mesh)


# ------------------------------------------------------------ phase 69
@_keeps_global_state
def phase_localsgd_bert(steps=3):
    """69 localsgd_bert: LocalSGD (k 2, begin 1) through
    ``fleet.get_train_step`` on bench_bert's CPU widths (bench.py:167,
    f32, dropout 0) at world size 1, on the card: one replica, so its
    losses are ``jit.TrainStep``'s from the same weights (rtol 1e-5),
    and each attention call launches K1f and both K1b kernels."""
    import torch
    from paddle_tpu_torch import distributed as dist, jit, optimizer
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.parallel import LocalSGDTrainStep
    from paddle_tpu_torch.testing.models import build_model, mlm_loss
    cfg = BERT_CPU
    prev_mesh = dist.get_mesh()
    dist.init_mesh({"dp": 1})
    try:
        import paddle_tpu_torch as pt
        pt.seed(69)
        models = [build_model(cfg["vocab"], cfg["hidden"], cfg["layers"],
                              cfg["heads"], cfg["ffn"], cfg["seq"], 0.0,
                              device="cuda") for _ in range(2)]
        models[1].load_state_dict(models[0].state_dict())
        x, y = _bench_batch(torch, cfg, "cuda")
        f = dist.Fleet()
        s = dist.DistributedStrategy()
        s.localsgd = True
        s.localsgd_configs = {"k_steps": 2, "begin_step": 1}
        f.init(strategy=s)
        f.distributed_optimizer(optimizer.AdamW(
            learning_rate=1e-4, parameters=models[0].parameters(),
            weight_decay=0.01))
        local = f.get_train_step(models[0], mlm_loss(models[0]))
        support.reset_launch_counts()
        got = [float(local(x, y)) for _ in range(steps)]
        counts = dict(support.launch_counts)
        base = jit.TrainStep(models[1], mlm_loss(models[1]), optimizer.AdamW(
            learning_rate=1e-4, parameters=models[1].parameters(),
            weight_decay=0.01))
        want = [float(base(x, y)) for _ in range(steps)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        per = cfg["layers"] * steps
        out = {"config": dict(cfg, dropout=0.0), "kind": type(local).__name__,
               "losses_localsgd": got, "losses_train_step": want,
               "launches": counts}
        log("LOCALSGD_BERT " + json.dumps(out))
        _check("LOCALSGD_BERT_CHECK", {
            "not_localsgd": (int(not isinstance(local, LocalSGDTrainStep)),
                             0),
            "loss_rel_err": (rel, 1e-5),
            **{f"launches_off.{k}": (abs(counts.get(k, 0) - per), 0)
               for k in FLASH_KERNELS}})
        return {k: counts.get(k, 0) for k in FLASH_KERNELS}
    finally:
        dist.set_mesh(prev_mesh)


# ------------------------------------------------------------ phase 70
@_keeps_global_state
def phase_sharded_embedding(steps=2):
    """70 sharded_embedding: part D of the dryrun at world size 1 on the
    card: ``ShardedEmbedding(4096, 32)`` and a Linear(32, 8) head under
    ``SpmdTrainStep`` (Adam 0.1), 2 steps on ids in [0, 256): losses
    finite, the rows no id reached unchanged bit for bit, the touched
    ones moved."""
    import numpy as np
    import torch
    from paddle_tpu_torch import distributed as dist, nn, optimizer
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.parallel import ShardedEmbedding, SpmdTrainStep
    prev_mesh = dist.get_mesh()
    mesh = dist.init_mesh({"dp": 1})
    try:
        import paddle_tpu_torch as pt
        pt.seed(77)

        class EmbNet(nn.Layer):
            def __init__(self):
                super().__init__()
                self.emb = ShardedEmbedding(4096, 32, axis="dp",
                                            device="cuda")
                self.head = nn.Linear(32, 8, device="cuda")

            def forward(self, ids):
                return self.head(self.emb(ids).mean(axis=1))

        net = EmbNet()
        before = net.emb.weight.detach().clone()
        step = SpmdTrainStep(net, lambda o, l: F.cross_entropy(o, l),
                             optimizer.Adam(learning_rate=0.1,
                                            parameters=net.parameters()),
                             mesh=mesh)
        r = np.random.RandomState(11)
        ids = torch.from_numpy(r.randint(0, 256, (8, 16))).cuda()
        lab = torch.from_numpy(np.random.RandomState(12).randint(
            0, 8, (8,))).cuda()
        losses = [float(step(ids, lab)) for _ in range(steps)]
        after = net.emb.weight.detach()
        hit = torch.zeros(4096, dtype=torch.bool, device="cuda")
        hit[ids.reshape(-1)] = True
        changed_untouched = int((after[~hit] != before[~hit]).any(
            dim=1).sum())
        moved = int((after[hit] != before[hit]).any(dim=1).sum())
        out = {"losses": losses, "touched_rows": int(hit.sum()),
               "touched_rows_moved": moved,
               "untouched_rows_changed": changed_untouched}
        log("SHARDED_EMBEDDING " + json.dumps(out))
        _check("SHARDED_EMBEDDING_CHECK", {
            "non_finite_losses": (sum(not math.isfinite(v)
                                      for v in losses), 0),
            "untouched_rows_changed": (changed_untouched, 0),
            "touched_rows_not_moved": (int(hit.sum()) - moved, 0)})
    finally:
        dist.set_mesh(prev_mesh)


def _instance_row(row):
    """One instance of a kernel (a path's shape), for the kernels
    line."""
    return {k: row[k] for k in (
        "case", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "library_call", "max_abs_err", "chains") if k in row}


# --------------------------------------------------------------- phase 71
# the supervised static BERT: bench_pallas's static BERT (bench.py:1108,
# f32) trained by a TrainingSupervisor child with the anomaly sentry on
# and an AnomalyPolicy installed, snapshots every 2 steps; the first
# child takes a NaN in its gradients at run 3 and hangs at run 6, the
# second crashes after 2 runs.  The watchdog's floor is 10 s: a
# snapshot's capture (the 1.6 GB of parameters and Adam slots) lies
# between two beats.
SUPERVISED_BERT = dict(steps=8, save_every=2, nan_run=3, hang_run=6,
                       crash_after=2, min_deadline_s=10.0)
SENTRY_OVERHEAD_PAIRS = 4


def phase_static_sentry_overhead(run, pairs=SENTRY_OVERHEAD_PAIRS, runs=3):
    """Phase 12's static BERT step with the anomaly sentry built in
    against without, on phase 12's Executor: ``pairs`` rounds of
    ``runs`` runs each way in turns (off first), each run ending in a
    synchronize; the first round (the sentry step's build) is left out.
    The sentry must skip nothing on clean data."""
    import numpy as np
    import torch
    from paddle_tpu_torch import set_flags
    exe, main, loss, feed = run
    ms = {False: [], True: []}
    try:
        for i in range(pairs + 1):
            for on in (False, True):
                set_flags({"anomaly_sentry": on})
                for _ in range(runs):
                    t0 = time.perf_counter()
                    exe.run(main, feed=feed, fetch_list=[loss],
                            return_numpy=False)
                    torch.cuda.synchronize()
                    if i:
                        ms[on].append((time.perf_counter() - t0) * 1e3)
    finally:
        set_flags({"anomaly_sentry": False})
    off, on = (float(np.median(ms[k])) for k in (False, True))
    out = {"step_ms_off_p50": off, "step_ms_on_p50": on,
           "overhead_pct": 100.0 * (on / off - 1.0),
           "runs_each": len(ms[True]),
           "skipped_steps": exe.sentry_stats(main)["skipped_steps"],
           "builds": exe.compile_count}
    log("SENTRY_BERT " + json.dumps(out))
    if out["skipped_steps"] != 0 or out["builds"] != 2:
        raise AssertionError(f"static BERT sentry overhead run: {out}")
    return out


def phase_supervised_static_bert():
    """The slice's main path: ``testing.chaos.supervise_main`` with the
    static BERT on the card.  Checks: the NaN run was skipped (the
    sentry's counter 1, the policy's 'skip', parameters, slots and the
    update counter bitwise unchanged), the watchdog killed the hang and
    the supervisor restarted after it and after the crash, the assembled
    losses equal the uninterrupted run's bit for bit, and every run of
    every child launched K2f, K2b, K1f, K1b and K3 the static step's
    count.  Returns the children's launches."""
    import torch
    from paddle_tpu_torch.testing import chaos
    res = {}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_supervised_")
    t0 = time.perf_counter()
    try:
        rc = chaos.supervise_main(model="bert_static", device="cuda",
                                  workdir=workdir, result=res,
                                  **SUPERVISED_BERT)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    flagged = res.get("flagged_runs", [])
    sen = (flagged[0].get("sentry") or {}) if flagged else {}
    checks = {
        "SUPERVISED_SKIP_CHECK": {
            "flagged_runs": len(flagged), "want": 1,
            "skipped_steps": sen.get("skipped_steps"),
            "last_nonfinite": sen.get("last_nonfinite"),
            "bitwise_noop": bool(flagged and flagged[0]["noop"]),
            "policy_action": flagged[0]["action"] if flagged else None},
        "SUPERVISED_WATCHDOG_CHECK": {
            "deadline_s": res.get("watchdog_deadline_s"),
            "predicted_step_s": res.get("predicted_step_s"),
            "multiplier": 8.0,
            "min_deadline_s": SUPERVISED_BERT["min_deadline_s"]},
        "SUPERVISED_EXITS_CHECK": {
            "exit_history": [{k: r[k] for k in ("attempt", "exit_code",
                                                "reason", "last_step",
                                                "runtime_s")}
                             for r in res.get("exit_history", [])],
            "want": ["hang", "crash(exit=7)"],
            "supervisor_stats": res.get("supervisor_stats")},
        "SUPERVISED_LOSS_CHECK": {
            "losses": res.get("losses"),
            "uninterrupted": res.get("reference_losses"),
            "bitwise_equal": res.get("losses_equal")},
        "SUPERVISED_LAUNCH_CHECK": {
            "runs": res.get("runs"), "launches": res.get("launches"),
            "want": res.get("launches_want"),
            "per_run": res.get("launches_per_run"),
            "per_run_want": STATIC_PER_STEP},
        "SUPERVISED_RESTART": {
            "parts": res.get("restart_parts"),
            "reference_s": res.get("reference_s"),
            "supervised_s": res.get("supervised_s"), "seconds": seconds}}
    for name, body in checks.items():
        log(name + " " + json.dumps(body, default=str))
    problems = list(res.get("problems", []))
    if res.get("launches_per_run") != STATIC_PER_STEP:
        problems.append("a reference run did not launch the static step's "
                        "kernels")
    if rc != 0 or problems:
        raise AssertionError(f"supervised static BERT: {problems}")
    return res["launches"]


# --------------------------------------------------------------- phase 72
def phase_swap_supervised():
    """``testing.chaos.swap_main`` with the dyadic model on the card:
    three live swaps under traffic and a rejected corrupted snapshot,
    then a ``ServingSupervisor`` replica (a child serving the version-0
    artifact on this card) killed mid-traffic, restarted, ready again,
    every answer bitwise one version's."""
    from paddle_tpu_torch.testing import chaos
    from paddle_tpu_torch.utils import monitor
    t0 = time.perf_counter()
    rc = chaos.swap_main(requests=8, clients=2, supervised=True)
    out = {"rc": rc, "seconds": time.perf_counter() - t0, **{
        k: monitor.get_stat(k) for k in (
            "supervisor.serving.starts", "supervisor.serving.restarts",
            "supervisor.serving.ready_up", "client.reconnects",
            "serving.swap.applied", "serving.swap.rejected")}}
    log("SWAP_SUPERVISED_CHECK " + json.dumps(out))
    if rc != 0:
        raise AssertionError(f"supervised swap drill failed: {out}")


# --------------------------------------------------------------- phase 73
def phase_shardcheck_gpt():
    """Shardcheck on phase 65's program (the static GPT through fleet,
    ZeRO-3 and the int8 grad_comm) at an abstract {dp: 4, mp: 2} mesh:
    ``Program.verify(sharding=plan)`` finds no error, and the wire
    audit's independent bytes equal ``analyze(sharding=plan)``'s
    prediction."""
    import torch
    from paddle_tpu_torch import distributed as dist, optimizer, static
    from paddle_tpu_torch.static.analysis import AbstractMesh
    from paddle_tpu_torch.static.analysis.shardcheck import (
        _derive_gplan, audit_wire_bytes)
    from paddle_tpu_torch.testing.models import build_gpt_static
    t0 = time.perf_counter()
    strategy = dist.DistributedStrategy()
    strategy.sharding = True
    strategy.sharding_configs = {"stage": 3}
    strategy.fuse_grad_size_in_MB = FLEET_FUSE_MB
    strategy.grad_comm = dict(FLEET_GC)
    dist.fleet.init(is_collective=True, strategy=strategy)

    def minimize(loss):
        opt = dist.fleet.distributed_optimizer(
            optimizer.AdamW(learning_rate=1e-4))
        opt.minimize(loss)

    main, loss, _ = build_gpt_static(**GPT_STATIC_CHIP, device="cuda",
                                     minimize=minimize)
    prev = dist.get_mesh()
    shape = {"dp": 4, "mp": 2}
    dist.set_mesh(AbstractMesh(shape))
    try:
        plan = static.Executor("cuda")._plan_for(main, main.parameters())
        diags = main.verify(fetch_list=[loss], sharding=plan,
                            raise_on_error=False)
        audit = audit_wire_bytes(_derive_gplan(main, plan))
        comm = main.analyze(fetch_list=[loss], chip="h100",
                            sharding=plan).totals["comm"]
    finally:
        dist.set_mesh(prev)
    # shardcheck's own verdicts; the hazard passes' (the causal mask
    # baked in as a constant) are listed beside them
    errors = [str(d) for d in diags if d.severity == "error"
              and d.pass_name.startswith("shard-")]
    out = {"mesh": shape, "params": len(main.parameters()),
           "errors": errors,
           "diagnostics": sorted({(d.pass_name, d.severity)
                                  for d in diags}),
           "audit_wire_bytes_per_step": audit["wire_bytes_per_step"],
           "analyze_wire_bytes_per_step": comm["wire_bytes_per_step"],
           "audit_collectives": audit["collectives_per_step"],
           "analyze_collectives": comm["collectives_per_step"],
           "audit_axis_wire_bytes": audit["axis_wire_bytes"],
           "seconds": time.perf_counter() - t0}
    log("SHARDCHECK_CHECK " + json.dumps(out))
    del main, loss
    torch.cuda.empty_cache()
    if errors or (out["audit_wire_bytes_per_step"]
                  != out["analyze_wire_bytes_per_step"]) or (
            out["audit_collectives"] != out["analyze_collectives"]):
        raise AssertionError(f"shardcheck on the static GPT: {out}")


# ---------------------------------------------------------- phases 74-75
# bench_bert's chip config (bench.py:155-200) fitted by hapi.Model from a
# tokenized corpus through DataLoader worker processes: 768 documents are
# one epoch of 12 batches of 64, the first 2 steps the warm-up
HAPI_BERT = dict(BERT_CHIP, docs=768, warmup=2, workers=4, eval_batches=2,
                 seed=2024, corpus_seed=0)
# the vision leg: ResNet-50 at batch 32 on 224 x 224 crops of seeded .npy
# images (the card's machine has no PIL), 3 steps through 2 workers
HAPI_VISION = dict(batch=32, steps=3, hw=224, resize=256, workers=2,
                   classes=2, lr=1e-3, momentum=0.9, seed=2024)


def _fit_clock(torch, Callback):
    """A callback that clocks every ``fit`` step: host time from batch
    begin to batch end (``train_batch`` reads the loss, so the step's
    work is done), the wait on the loader before it (the previous end to
    this begin), CUDA events at both ends on the step's stream, and the
    loss."""

    class FitClock(Callback):
        def __init__(self):
            super().__init__()
            self.begin, self.end, self.events, self.losses = [], [], [], []

        def on_train_batch_begin(self, step, logs=None):
            self.begin.append(time.perf_counter())
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append([ev, None])

        def on_train_batch_end(self, step, logs=None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[-1][1] = ev
            self.end.append(time.perf_counter())
            self.losses.append(logs["loss"])

        def summary(self, np, warmup):
            torch.cuda.synchronize()
            step = [(e - b) * 1e3 for b, e in zip(self.begin, self.end)]
            wait = [(b - e) * 1e3 for b, e in zip(self.begin[1:],
                                                  self.end[:-1])]
            span = [a.elapsed_time(b) for a, b in self.events]
            timed = step[warmup:]
            wall = (self.end[-1] - self.end[warmup - 1]) * 1e3
            return {"step_ms": timed, "step_ms_p50": float(np.median(timed)),
                    "step_ms_mean": float(np.mean(timed)),
                    "first_steps_ms": step[:warmup],
                    "loader_wait_ms": wait[warmup - 1:],
                    "loader_wait_ms_mean": float(np.mean(wait[warmup - 1:])),
                    "device_span_ms": span[warmup:],
                    "timed_wall_ms": wall,
                    "device_idle_share": max(
                        0.0, 1.0 - sum(span[warmup:]) / wall)}

    return FitClock()


def _batch_digest(np, batch):
    h = hashlib.sha256()
    for t in batch:
        a = t.numpy()
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _flash_ms_per_launch(torch, one_step, layers, steps=2):
    """Device ms a launch of each flash kernel (profiler kernel time)
    over ``steps`` calls of ``one_step`` after one untraced call: a trace
    that caught fewer than ``layers`` launches a step of a kernel is
    taken again (the tracer at times drops records), up to three
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    one_step()
    torch.cuda.synchronize()
    names = {"flash_attention_fwd": "flash_fwd_",
             "flash_attention_bwd_dq": "flash_bwd_dq_",
             "flash_attention_bwd_dkv": "flash_bwd_dkv_"}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                one_step()
            torch.cuda.synchronize()
        tot = {n: [0.0, 0] for n in names}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            for n, m in names.items():
                if m in e.key:
                    tot[n][0] += e.self_device_time_total
                    tot[n][1] += e.count
        del prof
        gc.collect()
        if all(c == layers * steps for _, c in tot.values()):
            break
    return {n: (t / c / 1e3 if c else None) for n, (t, c) in tot.items()}


def _hapi_bert_model(paddle, cfg):
    """bench_bert's chip model and optimizer, O2, with a PiecewiseDecay
    that holds lr 1e-4 over the run (so the LRScheduler callback has a
    scheduler to step)."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.testing.models import build_model, mlm_loss
    paddle.seed(cfg["seed"])
    net = build_model(cfg["vocab"], cfg["hidden"], cfg["layers"],
                      cfg["heads"], cfg["ffn"], cfg["seq"], cfg["dropout"])
    sched = optimizer.lr.PiecewiseDecay([10 ** 6], [1e-4, 1e-5])
    opt = optimizer.AdamW(learning_rate=sched, parameters=net.parameters(),
                          weight_decay=0.01,
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0),
                          multi_precision=True)
    net, opt = amp.decorate(net, opt, level="O2", dtype="bfloat16")
    return net, opt, sched, mlm_loss(net)


def phase_hapi_bert():
    """74. BERT-base (bench_bert's chip config, bf16 O2, AdamW 1e-4,
    global-norm clip 1.0, the fused linear cross entropy) fitted by
    ``paddle.Model`` from a seeded synthetic corpus tokenized by the
    native WordPiece tokenizer in 4 DataLoader worker processes: (a)
    every loss finite, the first near ln(vocab); (b) the losses those of
    a hand-written ``jit.TrainStep`` loop over the same batches from the
    same seed; (c) every batch of the 4-worker loader the synchronous
    loader's, by checksum; (d) no worker made a CUDA context; (e) the
    tokenizer native; (f) ``Model.save``/``load`` keep the ``evaluate``
    loss; with Checkpoint, MetricsDump and LRScheduler callbacks, then
    ``evaluate``, ``predict`` and ``summary``.  12 K1f and 12 of each
    K1b launches a fit step.  Times: the step p50 and mean, the loader
    wait, tokens/s and the card's idle share (CUDA events against the
    host clock)."""
    import contextlib
    import functools
    import io as _io

    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import io, jit
    from paddle_tpu_torch.hapi import (Callback, Checkpoint, LRScheduler,
                                       MetricsDump)
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing import corpus
    cfg = HAPI_BERT
    steps = cfg["docs"] // cfg["batch"]
    work = tempfile.mkdtemp(prefix="chip_smoke_hapi_")
    try:
        t0 = time.perf_counter()
        probe = os.path.join(work, "probe")
        os.makedirs(probe)
        vocab, docs = corpus.write_corpus(work, cfg["docs"], cfg["vocab"],
                                          seed=cfg["corpus_seed"])
        ds = corpus.MaskedLMCorpus(vocab, docs, cfg["seq"], probe_dir=probe)
        if not ds.tokenizer().is_native:                          # (e)
            raise AssertionError("the WordPiece tokenizer is not native")
        if len(ds.tokenizer()) != cfg["vocab"]:
            raise AssertionError(f"vocab {len(ds.tokenizer())}")
        data_s = time.perf_counter() - t0
        init = functools.partial(corpus.report_worker, probe)

        def loader(shuffle, workers):
            return io.DataLoader(ds, batch_size=cfg["batch"],
                                 shuffle=shuffle, num_workers=workers,
                                 worker_init_fn=init if workers else None)

        # (c): the worker path against the synchronous one, over the
        # order one seed draws; the worker loader's pool (made here, its
        # start timed to the first batch) serves fit and the reference
        # loop too
        fit_loader = loader(True, cfg["workers"])
        paddle.seed(cfg["seed"])
        t0 = time.perf_counter()
        it = iter(fit_loader)
        mp = [_batch_digest(np, next(it))]
        pool_s = time.perf_counter() - t0
        mp += [_batch_digest(np, b) for b in it]
        mp_epoch_s = time.perf_counter() - t0
        paddle.seed(cfg["seed"])
        t0 = time.perf_counter()
        sync = [_batch_digest(np, b) for b in loader(True, 0)]
        sync_epoch_s = time.perf_counter() - t0
        if sync != mp or len(sync) != steps:
            raise AssertionError(f"worker batches differ from the "
                                 f"synchronous loader's: {sync} {mp}")
        first = next(iter(loader(False, 0)))
        if (first[0].dtype != torch.int32 or first[1].dtype != torch.int64
                or list(first[0].shape) != [cfg["batch"], cfg["seq"]]):
            raise AssertionError(f"batch {first[0].dtype} "
                                 f"{first[1].dtype} {first[0].shape}")

        # the hapi path
        net, opt, sched, loss_fn = _hapi_bert_model(paddle, cfg)
        model = paddle.Model(net)
        model.prepare(opt, loss_fn)
        clock = _fit_clock(torch, Callback)
        ckpt_dir = os.path.join(work, "ckpt")
        dump = os.path.join(work, "metrics.jsonl")
        gc.collect()
        torch.cuda.synchronize()
        support.reset_launch_counts()
        t0 = time.perf_counter()
        model.fit(fit_loader, epochs=1, log_freq=1, verbose=0,
                  callbacks=[clock, Checkpoint(ckpt_dir,
                                               keep_checkpoint_max=1),
                             MetricsDump(dump), LRScheduler()])
        fit_s = time.perf_counter() - t0
        launches = {n: support.launch_counts.get(n, 0)
                    for n in FLASH_KERNELS}
        others = {n: c for n, c in support.launch_counts.items()
                  if n not in FLASH_KERNELS and c}
        times = clock.summary(np, cfg["warmup"])
        losses = clock.losses
        # the flash kernels' device ms a launch on this path (more
        # train_batch steps on the first batch, before evaluate and save)
        ids, labels = first
        per_launch = _flash_ms_per_launch(
            torch, lambda: model.train_batch([ids], [labels]),
            cfg["layers"])
        meta = json.load(open(os.path.join(ckpt_dir, "range_meta.json")))
        dumped = open(dump).read().splitlines()

        # evaluate, predict, save/load, summary
        evald = io.Subset(ds, range(cfg["eval_batches"] * cfg["batch"]))
        eval_loader = io.DataLoader(evald, batch_size=cfg["batch"])
        support.reset_launch_counts()
        ev = model.evaluate(eval_loader, verbose=0)
        preds = model.predict(io.DataLoader(evald, batch_size=cfg["batch"]))
        eval_launches = {n: support.launch_counts.get(n, 0)
                         for n in FLASH_KERNELS}
        pred_ok = all(list(p.shape) == [cfg["batch"], cfg["seq"],
                                        cfg["hidden"]]
                      and bool(torch.isfinite(p.float()).all())
                      for p in preds)
        t0 = time.perf_counter()
        path = os.path.join(work, "bert")
        model.save(path)
        save_s = time.perf_counter() - t0
        state = {k: v.detach().float().cpu()
                 for k, v in net.state_dict().items()}
        del model, net, opt, preds
        torch.cuda.empty_cache()
        net2, opt2, _, loss2 = _hapi_bert_model(paddle, dict(cfg, seed=7))
        m2 = paddle.Model(net2)
        m2.prepare(opt2, loss2)
        m2.load(path)
        ev2 = m2.evaluate(eval_loader, verbose=0)
        same_state = all(torch.equal(state[k], v.detach().float().cpu())
                         for k, v in net2.state_dict().items())
        with contextlib.redirect_stdout(_io.StringIO()) as text:
            info = paddle.summary(net2)
        del m2, net2, opt2, state
        torch.cuda.empty_cache()

        # (b): a hand-written TrainStep loop over the same batches
        net3, opt3, sched3, loss3 = _hapi_bert_model(paddle, cfg)
        step = jit.TrainStep(net3, loss3, opt3, n_inputs=1)
        ref = []
        for ids, labels in fit_loader:
            ref.append(float(step(ids, labels)))
            sched3.step()
        fit_loader._mp_pool.close()
        del net3, opt3, step
        torch.cuda.empty_cache()
        # the workers' reports (this process serves the synchronous
        # loader's samples, on a machine whose card it uses)
        reports = [(n, r) for n, r in corpus.worker_reports(probe)
                   if r["pid"] != os.getpid()]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    worker_cuda = sorted({(n.split("-")[0], r["cuda_initialized"])
                          for n, r in reports})
    diff = max(abs(a - b) for a, b in zip(losses, ref))
    tokens = cfg["batch"] * cfg["seq"]
    out = {"config": cfg, "steps": steps, "losses": losses,
           "reference_losses": ref, "bitwise_equal_to_train_step":
           losses == ref, "max_abs_loss_diff": diff,
           **times,
           "tokens_per_s": tokens / (times["step_ms_mean"] / 1e3),
           "tokens_per_s_with_loader_wait": tokens / (
               (times["step_ms_mean"] + times["loader_wait_ms_mean"]) / 1e3),
           "flash_launches": launches, "other_launches": others,
           "flash_device_ms_per_launch": per_launch,
           "eval_predict_flash_launches": eval_launches,
           "evaluate": ev, "evaluate_after_load": ev2,
           "state_round_trip_equal": same_state,
           "predict_outputs_ok": pred_ok,
           "summary_total_params": info["total_params"],
           "summary_lines": len(text.getvalue().splitlines()),
           "checkpoint_snapshots": [s["dir"] for s in meta["snapshots"]],
           "metrics_dump_lines": len(dumped),
           "batch_digests": sync[:3], "worker_probe": worker_cuda,
           "workers_reported": len({r["pid"] for _, r in reports}),
           "seconds": {"data": data_s, "pool_start_to_first_batch":
                       pool_s, "worker_epoch": mp_epoch_s,
                       "synchronous_epoch": sync_epoch_s,
                       "fit": fit_s, "save": save_s}}
    log("HAPI_BERT " + json.dumps(out))
    want = cfg["layers"] * steps
    problems = []
    if not all(math.isfinite(v) for v in losses + ref):             # (a)
        problems.append("non-finite loss")
    if abs(losses[0] - math.log(cfg["vocab"])) > 0.5:
        problems.append(f"first loss {losses[0]} not near ln(vocab)")
    if len(losses) != steps or diff > 0.0:                          # (b)
        problems.append(f"fit losses differ from TrainStep's by {diff}")
    if any(cuda for _, cuda in worker_cuda) or not reports:         # (d)
        problems.append(f"worker CUDA contexts: {worker_cuda}")
    if ev.get("loss") != ev2.get("loss") or not same_state:         # (f)
        problems.append(f"save/load: {ev} against {ev2}")
    if any(c != want for c in launches.values()) or others:
        problems.append(f"launches {launches} {others}, want {want} "
                        f"of each flash kernel")
    if not pred_ok or len(dumped) != 2 or len(meta["snapshots"]) != 1:
        problems.append("predict, MetricsDump or Checkpoint")
    if problems:
        raise AssertionError(f"hapi BERT: {problems}")
    return {n: launches[n] + eval_launches[n] for n in FLASH_KERNELS}


def phase_hapi_vision():
    """75. ResNet-50 fitted by ``paddle.Model`` for 3 steps at batch 32
    from ``vision.datasets.DatasetFolder`` over seeded 224 x 224 x 3
    uint8 ``.npy`` images through ``Resize``, ``RandomCrop``,
    ``Normalize`` and ``Transpose`` in 2 DataLoader workers: losses
    finite, ``ImageFolder`` sees every image, and no hand kernel
    launched."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import io, optimizer
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.datasets import DatasetFolder, ImageFolder
    from paddle_tpu_torch.vision.models import resnet50
    cfg = HAPI_VISION
    n = cfg["batch"] * cfg["steps"]
    root = tempfile.mkdtemp(prefix="chip_smoke_images_")
    try:
        rng = np.random.RandomState(cfg["seed"])
        for c in range(cfg["classes"]):
            d = os.path.join(root, f"class{c}")
            os.makedirs(d)
            for i in range(n // cfg["classes"]):
                np.save(os.path.join(d, f"{i}.npy"),
                        rng.randint(0, 256, (cfg["hw"], cfg["hw"], 3),
                                    dtype=np.uint8))
        tf = T.Compose([T.Resize(cfg["resize"]), T.RandomCrop(cfg["hw"]),
                        T.Normalize(mean=[123.675, 116.28, 103.53],
                                    std=[58.395, 57.12, 57.375],
                                    data_format="HWC"),
                        T.Transpose()])
        ds = DatasetFolder(root, transform=tf)
        flat = len(ImageFolder(root))
        x0, y0 = ds[0]
        loader = io.DataLoader(ds, batch_size=cfg["batch"], shuffle=True,
                               num_workers=cfg["workers"], drop_last=True)
        paddle.seed(cfg["seed"])
        net = resnet50(num_classes=cfg["classes"])
        model = paddle.Model(net)
        model.prepare(optimizer.Momentum(
            learning_rate=cfg["lr"], momentum=cfg["momentum"],
            parameters=net.parameters()), F.cross_entropy)
        losses = []

        class Losses(paddle.hapi.Callback):
            def on_train_batch_end(self, step, logs=None):
                losses.append(logs["loss"])

        support.reset_launch_counts()
        t0 = time.perf_counter()
        model.fit(loader, epochs=1, log_freq=1, verbose=0,
                  callbacks=[Losses()])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {k: c for k, c in support.launch_counts.items() if c}
        loader._mp_pool.close()
        del model, net
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"config": cfg, "images": n, "image_folder_len": flat,
           "sample": [list(x0.shape), str(x0.dtype), int(y0)],
           "losses": losses, "fit_s": fit_s, "hand_kernel_launches":
           launches}
    log("HAPI_VISION " + json.dumps(out))
    if (len(losses) != cfg["steps"]
            or not all(math.isfinite(v) for v in losses) or flat != n
            or list(x0.shape) != [3, cfg["hw"], cfg["hw"]]
            or x0.dtype != np.float32 or launches):
        raise AssertionError(f"hapi vision: {out}")


# ------------------------------------------------------------ phases 76-78
# 76: R1 made int8 (PTQ on 4 seeded batches of 8 x 512, then
# convert_to_int8) and served at phase 53's batches; runs a batch
QUANT_CALIB_BATCHES, QUANT_CALIB_ROWS = 4, 8
QUANT_PRED_RUNS = {1: 10, 8: 4, 32: 3}
# the JAX file's Predictor-vs-eager tolerance (tests/test_quantization.py)
QUANT_PRED_RTOL, QUANT_PRED_ATOL = 2e-3, 1e-3
# int8 encoder and f32 embeddings: ~0.39x R1 with the unused head saved
QUANT_ARTIFACT_RATIO = 0.45
# the QAT leg: its first loss against the plain attention's; looser than
# FLASH_TOL: a fake-quant level that flips between the two attentions
# moves the loss by more than the attention's own error
QUANT_QAT_STEPS, QUANT_QAT_RTOL = 3, 1e-3
# BERT-base's fc1 product at batch 32 x 512 tokens: M, K, N
FC1_SHAPE = (16384, 768, 3072)
INT8_PEAK_OPS = 1979e12      # dense int8 tensor-core ops/s (H100 SXM)
# 78: Faster R-CNN R50-C4's box head on layer3 (stride 16) of a batch of
# 2 at 800 x 1344; YOLOv3 heads on C3-C5 at 608 x 608, batch 8, COCO
DET_RCNN = dict(batch=2, h=800, w=1344, rois=512, bins=14, sampling=2,
                scale=1.0 / 16)
DET_YOLO = dict(batch=8, size=608, classes=80, conf_thresh=0.005,
                score_threshold=0.01, nms_top_k=1000, keep_top_k=100,
                nms_threshold=0.45)
# COCO anchors by the head's stride (yolov3.cfg's masks 0-2, 3-5, 6-8)
YOLO_ANCHORS = {8: [10, 13, 16, 30, 33, 23], 16: [30, 61, 62, 45, 59, 119],
                32: [116, 90, 156, 198, 373, 326]}
YOLO_LOGIT_STD = 2.0
DET_TOL = 1e-5


def _quant_group(n):
    return ("int8_gemm" if any(w in n for w in ("s8", "i8", "imma",
                                                "int8")) else
            _predictor_group(n))


def _int8_graph_nodes(torch, prefix):
    """``aten._int_mm`` nodes of a saved program."""
    from paddle_tpu_torch.jit.save_load import _graph_modules, read_artifact
    _, ep = read_artifact(prefix)
    return sum(1 for gm in _graph_modules(ep) for n in gm.graph.nodes
               if n.op == "call_function"
               and n.target is torch.ops.aten._int_mm.default)


def _int8_matmul_row(torch):
    """``torch._int_mm`` at BERT-base's fc1 shape beside the f32
    ``torch.matmul`` (TF32 off) of the same shape."""
    M, K, N = FC1_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(76)
    a8 = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                       dtype=torch.int8)
    w8 = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                       dtype=torch.int8)
    a32, w32 = a8.float(), w8.float()
    exact = torch.equal(torch._int_mm(a8, w8).double(),
                        (a32.double() @ w32.double()))
    ms = cuda_ms(lambda i: torch._int_mm(a8, w8), 10)
    f32_ms = cuda_ms(lambda i: torch.matmul(a32, w32), 5)
    nbytes = M * K + K * N + 4 * M * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * K * N / INT8_PEAK_OPS * 1e3
    return {"case": f"M={M} K={K} N={N}", "int_mm_ms": ms,
            "f32_matmul_ms": f32_ms, "speedup": f32_ms / ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "int32_exact": exact}


def _profiled_runs(np, paddle, pred, ids, runs, base_ms):
    """The timed batch-32 runs again under ``paddle.profiler.Profiler``
    (a ``torch.profiler`` session written as a Chrome trace) with each
    run in ``RecordEvent("predictor.run")``: the trace names K1f's CUDA
    kernel, the summary's top rows, and the profiler's cost a run."""
    from paddle_tpu_torch import profiler
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_profiler_")
    try:
        prof = profiler.Profiler(trace_dir=trace_dir)
        pred.run([ids])
        prof.start()
        t0 = time.perf_counter()
        for _ in range(runs):
            with profiler.RecordEvent("predictor.run"):
                outs = pred.run([ids])
        float(np.asarray(outs[0]).sum())
        traced_ms = (time.perf_counter() - t0) / runs * 1e3
        prof.stop()
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
        kernels = sorted({_kernel_name(e["name"]) for e in events
                          if e.get("cat") == "kernel"
                          and "flash_fwd" in e.get("name", "")})
        text = prof.summary(top_k=8)
        return {"trace_bytes": os.path.getsize(prof.trace_path),
                "trace_events": len(events), "flash_kernels": kernels,
                "spans": prof._span_stats["predictor.run"][0],
                "traced_ms_a_run": traced_ms, "plain_ms_a_run": base_ms,
                "overhead_ms_a_run": traced_ms - base_ms,
                "device_top": [[n[:60], c, round(ms, 4)] for n, c, ms
                               in prof.device_table()[:8]],
                "summary_lines": text.splitlines()[:24]}
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)


def _qat_leg(np, torch, paddle):
    """Phase 8's BERT-base (batch 64 x 512) trained 3 f32 TrainSteps
    with ``QAT().quantize(model.encoder)`` (the encoder only:
    ``mlm_loss`` reads ``model.head.weight``, which a wrapper does not
    expose): 12 K1f and 12 of each K1b a step, finite losses, and the
    first loss against the same step's forward with
    ``use_pallas_kernels`` off.  Dropout 0, so both attentions see the
    same (no) masks."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.testing.models import build_model, mlm_loss
    cfg = dict(BERT_CHIP, dropout=0.0)
    paddle.seed(2024)
    model = build_model(cfg["vocab"], cfg["hidden"], cfg["layers"],
                        cfg["heads"], cfg["ffn"], cfg["seq"],
                        cfg["dropout"], device="cuda")
    Q.QAT().quantize(model.encoder)
    opt = optimizer.AdamW(learning_rate=1e-4,
                          parameters=model.parameters(), weight_decay=0.01,
                          grad_clip=optimizer.ClipGradByGlobalNorm(1.0))
    step = jit.TrainStep(model, mlm_loss(model), opt, n_inputs=1,
                         donate=True)
    wrapped = sum(isinstance(m, Q.QuantizedLinear)
                  for m in model.encoder.sublayers())
    x, y = _bench_batch(torch, cfg, "cuda")
    model.train()
    paddle.set_flags({"use_pallas_kernels": False})
    try:
        with torch.no_grad():
            plain = float(mlm_loss(model)(model(x), y))
    finally:
        paddle.set_flags({"use_pallas_kernels": True})
    torch.cuda.empty_cache()
    losses, step_ms, counts = _train_steps(torch, step, (x, y),
                                           QUANT_QAT_STEPS)
    del model, step
    torch.cuda.empty_cache()
    return {"config": cfg, "wrapped_linears": wrapped, "losses": losses,
            "step_ms": step_ms, "plain_first_loss": plain,
            "first_loss_rel_gap": abs(losses[0] - plain) / abs(plain),
            "launches": {k: counts.get(k, 0) for k in FLASH_KERNELS},
            "other_launches": sum(n for k, n in counts.items()
                                  if k not in FLASH_KERNELS)}


@_keeps_global_state
def phase_quant_bert(r1=None):
    """76 quant_bert: R1 (phase 53's BERT-base, f32, eval, seed 2024) made
    int8 by ``PTQ().quantize`` (4 seeded calibration batches of 8 x
    512), ``PTQ.convert`` and ``convert_to_int8``, saved by ``jit.save``
    with ``InputSpec([None, 512], "int64")`` and served by the Predictor
    at batches 1, 8 and 32: 12 K1f a run and no other hand kernel, the
    graph's ``_int_mm`` nodes equal to the int8 linears the forward
    calls (72), the Predictor against the same int8 model run eagerly on
    the card, no non-finite output, the artifact at most 0.45x R1's;
    printed: the error against the float R1 and against the eager run
    with ``use_pallas_kernels`` off, each batch's latency beside phase
    53's, a run's anatomy, ``_int_mm`` at fc1's shape beside the f32
    product, and the batch-32 runs again under ``paddle.profiler``.
    Then the QAT leg (:func:`_qat_leg`).  ``r1``: phase 53's artifact
    bytes and latencies, when it ran."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing.models import build_model
    cfg = BERT_CHIP
    paddle.seed(2024)
    model = build_model(cfg["vocab"], cfg["hidden"], cfg["layers"],
                        cfg["heads"], cfg["ffn"], cfg["seq"],
                        cfg["dropout"], device="cuda")
    model.eval()
    rs = np.random.RandomState(76)
    ids = {b: rs.randint(0, cfg["vocab"], (b, cfg["seq"])).astype(np.int64)
           for b in PRED_BERT_BATCHES}
    dev_ids = {b: torch.from_numpy(v).cuda() for b, v in ids.items()}
    with torch.no_grad():
        ref = {b: model(v) for b, v in dev_ids.items()}
    work = tempfile.mkdtemp(prefix="chip_smoke_quant_")
    try:
        if r1 is None:
            jit.save(model, os.path.join(work, "r1"), input_spec=[
                jit.InputSpec([None, cfg["seq"]], "int64")])
            r1 = {"artifact_bytes": _file_bytes(os.path.join(work, "r1")),
                  "latency_ms": {}}
        t0 = time.perf_counter()
        Q.PTQ().quantize(model)
        with torch.no_grad():
            for _ in range(QUANT_CALIB_BATCHES):
                model(torch.from_numpy(rs.randint(0, cfg["vocab"], (
                    QUANT_CALIB_ROWS, cfg["seq"]))).cuda())
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        Q.PTQ.convert(model)
        Q.convert_to_int8(model)
        int8 = [m for m in model.sublayers() if isinstance(m, Q.Int8Linear)]
        called = set()
        hooks = [m.register_forward_hook(
            lambda mod, i, o: called.add(id(mod))) for m in int8]
        with torch.no_grad():
            model(dev_ids[1])
        for h in hooks:
            h.remove()
        prefix = os.path.join(work, "int8")
        t0 = time.perf_counter()
        jit.save(model, prefix, input_spec=[
            jit.InputSpec([None, cfg["seq"]], "int64")])
        save_s = time.perf_counter() - t0
        sizes = _file_bytes(prefix)
        nodes = _int8_graph_nodes(torch, prefix)
        pred = inference.create_predictor(inference.Config(prefix))
        rows, quantities = {}, {}
        for b in PRED_BERT_BATCHES:
            support.reset_launch_counts()
            out, = pred.run([ids[b]])
            torch.cuda.synchronize()
            counts = dict(support.launch_counts)
            with torch.no_grad():
                eager = model(dev_ids[b])
            paddle.set_flags({"use_pallas_kernels": False})
            try:
                with torch.no_grad():
                    plain = model(dev_ids[b])
            finally:
                paddle.set_flags({"use_pallas_kernels": True})
            over = ((out - eager).abs() - QUANT_PRED_ATOL
                    - QUANT_PRED_RTOL * eager.abs()).max().item()
            ms = _serve_ms(np, pred, ids[b], QUANT_PRED_RUNS[b])
            rows[b] = {"latency_ms": ms, "runs": QUANT_PRED_RUNS[b],
                       "r1_latency_ms": r1["latency_ms"].get(b),
                       "tokens_per_s": b * cfg["seq"] / (ms / 1e3),
                       "launches": counts,
                       "max_abs_vs_eager": (out - eager).abs().max().item(),
                       "rel_err_vs_eager_plain": _rel_err(out, plain),
                       "rel_err_vs_float_r1": _rel_err(out, ref[b]),
                       "output_shape": list(out.shape)}
            quantities[f"batch {b}: |flash_attention_fwd launches - 12|"] = (
                abs(counts.get("flash_attention_fwd", 0) - cfg["layers"]), 0)
            quantities[f"batch {b}: other kernels launched"] = (
                sum(n for k, n in counts.items()
                    if k != "flash_attention_fwd"), 0)
            quantities[f"batch {b}: max(|pred - eager| - atol - rtol "
                       f"|eager|)"] = (over, 0.0)
            quantities[f"batch {b}: non-finite outputs"] = (
                int((~torch.isfinite(out)).sum()), 0)
        quantities["|int8 graph nodes - int8 linears called|"] = (
            abs(nodes - len(called)), 0)
        quantities["|int8 linears called - 72|"] = (
            abs(len(called) - 6 * cfg["layers"]), 0)
        r1_bytes = sum(r1["artifact_bytes"].values())
        ratio = sum(sizes.values()) / r1_bytes
        quantities["artifact bytes / R1's"] = (ratio, QUANT_ARTIFACT_RATIO)
        _step_anatomy("QUANT_BERT_ANATOMY",
                      lambda: pred.run([dev_ids[PRED_BERT_BATCHES[-1]]]), 2,
                      _quant_group)
        mm = _int8_matmul_row(torch)
        quantities["_int_mm at fc1's shape: int32 not exact"] = (
            int(not mm["int32_exact"]), 0)
        last = PRED_BERT_BATCHES[-1]
        prof = _profiled_runs(np, paddle, pred, dev_ids[last],
                              QUANT_PRED_RUNS[last], rows[last]["latency_ms"])
        quantities["profiler: K1f's kernel missing from the trace"] = (
            int(not prof["flash_kernels"]), 0)
        quantities["profiler: |predictor.run spans - runs|"] = (
            abs(prof["spans"] - QUANT_PRED_RUNS[last]), 0)
        del pred
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del model, ref, eager, plain
    torch.cuda.empty_cache()
    qat = _qat_leg(np, torch, paddle)
    for k in FLASH_KERNELS:
        quantities[f"QAT: |{k} launches - 12 a step|"] = (
            abs(qat["launches"][k] - cfg["layers"] * QUANT_QAT_STEPS), 0)
    quantities["QAT: other kernels launched"] = (qat["other_launches"], 0)
    quantities["QAT: non-finite losses"] = (
        sum(not math.isfinite(v) for v in qat["losses"]), 0)
    quantities["QAT: first loss vs plain, relative"] = (
        qat["first_loss_rel_gap"], QUANT_QAT_RTOL)
    out = {"config": dict(cfg, dtype="int8 encoder, f32 embeddings",
                          mode="eval"),
           "calibration": {"batches": QUANT_CALIB_BATCHES,
                           "rows": QUANT_CALIB_ROWS, "seconds": calib_s},
           "int8_linears": len(int8), "int8_linears_called": len(called),
           "graph_int_mm_nodes": nodes, "save_s": save_s,
           "artifact_bytes": sizes, "r1_artifact_bytes": r1["artifact_bytes"],
           "artifact_ratio": ratio, "batches": rows, "int_mm_fc1": mm,
           "profiler": prof, "qat": qat, "nvidia_smi": nvidia_smi()}
    log("QUANT_BERT " + json.dumps(out))
    _check("QUANT_BERT_CHECK", quantities)
    return {"flash_attention_fwd": sum(
        r["launches"].get("flash_attention_fwd", 0) for r in rows.values())
        + qat["launches"]["flash_attention_fwd"],
        "flash_attention_bwd_dq": qat["launches"]["flash_attention_bwd_dq"],
        "flash_attention_bwd_dkv":
            qat["launches"]["flash_attention_bwd_dkv"]}


@_keeps_global_state
def phase_onnx_resnet50():
    """77 onnx_resnet50: ``vision.models.resnet50`` (seeded weights, on
    the card, eval) exported by ``paddle.onnx.export`` with
    ``InputSpec([1, 3, 224, 224])``, the graph rerun node by node with
    torch ops on the card (``testing.onnx_eval``): its output against
    the model's forward within 1e-4 relative, every weight's bytes among
    the initializers, no hand kernel launched; the node histogram, the
    file's bytes and the export's seconds."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import onnx
    from paddle_tpu_torch.jit import InputSpec
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.testing import onnx_eval
    from paddle_tpu_torch.vision.models import resnet50
    paddle.seed(77)
    model = resnet50()
    model.eval()
    x = torch.from_numpy(np.random.RandomState(77).randn(
        1, 3, 224, 224).astype(np.float32)).cuda()
    with torch.no_grad():
        want = model(x)
    work = tempfile.mkdtemp(prefix="chip_smoke_onnx_")
    try:
        support.reset_launch_counts()
        t0 = time.perf_counter()
        path = onnx.export(model, os.path.join(work, "resnet50"),
                           input_spec=[InputSpec([1, 3, 224, 224])])
        export_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        graph = onnx_eval.load(path)
        got, = onnx_eval.run(graph, [x])
        torch.cuda.synchronize()
        launches = dict(support.launch_counts)
        eval_ms = cuda_ms(lambda i: onnx_eval.run(graph, [x]), 3, warmup=1)
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda i: model(x), 5)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    init = {a.tobytes() for a in graph["initializers"].values()}
    state = list(model.named_parameters()) + list(model.named_buffers())
    missing = [n for n, t in state
               if t.detach().cpu().numpy().tobytes() not in init]
    rel = ((got - want).abs().max() / want.abs().max()).item()
    out = {"model": "resnet50", "input": [1, 3, 224, 224],
           "export_s": export_s, "file_bytes": nbytes,
           "nodes": len(graph["nodes"]),
           "histogram": onnx_eval.histogram(graph),
           "initializers": len(graph["initializers"]),
           "weights": len(state), "rel_err_vs_forward": rel,
           "onnx_eval_ms": eval_ms, "forward_ms": fwd_ms,
           "hand_kernel_launches": launches}
    log("ONNX_RESNET50 " + json.dumps(out))
    _check("ONNX_RESNET50_CHECK", {
        "rel err vs the forward": (rel, 1e-4),
        "weights whose bytes no initializer holds": (len(missing), 0),
        "hand kernel launches": (sum(launches.values()), 0),
        "non-finite outputs": (int((~torch.isfinite(got)).sum()), 0)})
    del model
    torch.cuda.empty_cache()


def _host_cpus():
    """CPUs this process may use: the cgroup's quota (``cpu.max``) when
    one is set, else its affinity mask."""
    n = len(os.sched_getaffinity(0))
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota, period = f.read().split()
        if quota != "max":
            n = min(n, max(1, int(int(quota) // int(period))))
    except (OSError, ValueError):
        pass
    return n


def _roi_align_gather(torch, x, boxes, batch_idx, ph, pw, scale, S,
                      chunk=16):
    """paddle_tpu's ``_roi_align_fn`` (vision/ops.py:150-206, aligned)
    transcribed in torch: rows gathered at the two taps along y, then
    the two taps along x, averaged over the S x S samples; ``chunk``
    RoIs at a time (the whole gather is ~10 GB at the R50-C4 head)."""
    R = boxes.shape[0]
    C, H, W = x.shape[1:]
    b = boxes * scale
    x1, y1 = b[:, 0] - 0.5, b[:, 1] - 0.5
    bin_w, bin_h = (b[:, 2] - b[:, 0]) / pw, (b[:, 3] - b[:, 1]) / ph
    sub = (torch.arange(S, device=x.device) + 0.5) / S
    iy = torch.arange(ph, device=x.device)[:, None] + sub[None, :]
    ix = torch.arange(pw, device=x.device)[:, None] + sub[None, :]
    ys = y1[:, None, None] + iy[None] * bin_h[:, None, None]
    xs = x1[:, None, None] + ix[None] * bin_w[:, None, None]

    def taps(coord, size):
        c = coord.clamp(0.0, size - 1.0)
        lo = c.floor().long().clamp(0, size - 1)
        hi = (lo + 1).clamp(max=size - 1)
        return lo, hi, c - lo, ((coord >= -1.0) & (coord <= size)).float()

    ylo, yhi, fy, vy = taps(ys, H)
    xlo, xhi, fx, vx = taps(xs, W)
    outs = []
    for r0 in range(0, R, chunk):
        r = slice(r0, min(R, r0 + chunk))
        k = r.stop - r.start
        bi = batch_idx[r][:, None, None]
        top, bot = x[bi, :, ylo[r], :], x[bi, :, yhi[r], :]
        rows = (top + (bot - top) * fy[r][..., None, None]) \
            * vy[r][..., None, None]                      # [k,ph,S,C,W]

        def along_x(idx):
            i = idx[r].reshape(k, 1, 1, 1, pw * S).expand(k, ph, S, C,
                                                           pw * S)
            return torch.gather(rows, 4, i).reshape(k, ph, S, C, pw, S)

        left, right = along_x(xlo), along_x(xhi)
        vals = (left + (right - left) * fx[r][:, None, None, None]) \
            * vx[r][:, None, None, None]
        outs.append(vals.mean(dim=(2, 5)).permute(0, 2, 1, 3))
    return torch.cat(outs)


@_keeps_global_state
def phase_detection_ops():
    """78 detection_ops: ResNet-50's features at published detection
    shapes.  ``roi_align`` at Faster R-CNN R50-C4's box head (layer3,
    1024 channels, of a batch of 2 at 800 x 1344; 512 seeded RoIs an
    image, 14 x 14 bins, sampling 2, scale 1/16) against a chunked
    transcription of paddle_tpu's gather formula on the card;
    ``yolo_box`` and ``multiclass_nms`` at YOLOv3's COCO shapes (three
    1 x 1 heads of 255 channels on C3, C4 and C5 at 608 x 608, batch 8,
    COCO's anchors): ``yolo_box`` against the port's CPU run of the same
    head outputs, ``multiclass_nms`` index for index against its CPU run
    on the card's boxes and scores; each op's time."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.cuda import support
    from paddle_tpu_torch.vision import ops as V
    from paddle_tpu_torch.vision.models import resnet50
    paddle.seed(78)
    net = resnet50()
    net.eval()
    rs = np.random.RandomState(78)
    quantities, out = {}, {}
    support.reset_launch_counts()

    def stem(x):
        return net.layer1(net.maxpool(net.relu(net.bn1(net.conv1(x)))))

    c = DET_RCNN
    with torch.no_grad():
        img = torch.from_numpy(rs.randn(c["batch"], 3, c["h"], c["w"])
                               .astype(np.float32)).cuda()
        feat = net.layer3(net.layer2(stem(img)))
        del img
    n = c["rois"]
    xy = rs.rand(c["batch"] * n, 2) * [c["w"] - 16, c["h"] - 16]
    wh = rs.rand(c["batch"] * n, 2) * [c["w"] / 2, c["h"] / 2] + 16
    boxes = torch.from_numpy(np.concatenate(
        [xy, np.minimum(xy + wh, [c["w"], c["h"]])], 1).astype(
            np.float32)).cuda()
    num = torch.full((c["batch"],), n, dtype=torch.int64, device="cuda")
    with torch.no_grad():
        got = V.roi_align(feat, boxes, num, c["bins"],
                          spatial_scale=c["scale"],
                          sampling_ratio=c["sampling"])
        batch_idx = torch.arange(c["batch"],
                                 device="cuda").repeat_interleave(n)
        want = _roi_align_gather(torch, feat, boxes, batch_idx, c["bins"],
                                 c["bins"], c["scale"], c["sampling"])
        ms = cuda_ms(lambda i: V.roi_align(
            feat, boxes, num, c["bins"], spatial_scale=c["scale"],
            sampling_ratio=c["sampling"]), 3, warmup=1)
        gather_ms = cuda_ms(lambda i: _roi_align_gather(
            torch, feat, boxes, batch_idx, c["bins"], c["bins"], c["scale"],
            c["sampling"]), 1, warmup=0)
    err = _rel_err(got, want)
    out["roi_align"] = {"feature": list(feat.shape), "rois": list(
        boxes.shape), "output": list(got.shape), "ms": ms,
        "gather_formula_ms": gather_ms, "rel_err": err}
    quantities["roi_align vs the gather formula"] = (err, DET_TOL)
    del feat, got, want
    torch.cuda.empty_cache()

    y = DET_YOLO
    with torch.no_grad():
        img = torch.from_numpy(rs.randn(y["batch"], 3, y["size"], y["size"])
                               .astype(np.float32)).cuda()
        c3 = net.layer2(stem(img))
        c4 = net.layer3(c3)
        c5 = net.layer4(c4)
        del img
    heads = {8: (c3, paddle.nn.Conv2D(512, 255, 1)),
             16: (c4, paddle.nn.Conv2D(1024, 255, 1)),
             32: (c5, paddle.nn.Conv2D(2048, 255, 1))}
    size = torch.full((y["batch"], 2), y["size"], dtype=torch.int64,
                      device="cuda")
    boxes, scores, yolo_err, yolo_ms = [], [], 0.0, 0.0
    with torch.no_grad():
        for stride, (f, conv) in sorted(heads.items(), reverse=True):
            # the seeded head scaled so its logits have std 2, a trained
            # head's range: at its Kaiming init on untrained features they
            # reach std ~2000, every sigmoid saturates, and the 1.0 scores
            # tied at the top-k cut keep ~11,000 candidates a class
            h = conv(f)
            scale = YOLO_LOGIT_STD / h.std()
            conv.weight.mul_(scale)
            conv.bias.mul_(scale)
            h = conv(f)
            args = (YOLO_ANCHORS[stride], y["classes"], y["conf_thresh"],
                    stride)
            b, s = V.yolo_box(h, size, *args)
            yolo_ms += cuda_ms(lambda i: V.yolo_box(h, size, *args), 3)
            cb, cs = V.yolo_box(h.cpu(), size.cpu(), *args)
            yolo_err = max(yolo_err, _rel_err(b.cpu(), cb),
                           _rel_err(s.cpu(), cs))
            boxes.append(b)
            scores.append(s)
        del c3, c4, c5
        boxes = torch.cat(boxes, 1)
        scores = torch.cat(scores, 1).transpose(1, 2).contiguous()
        kw = {k: y[k] for k in ("score_threshold", "nms_top_k",
                                "keep_top_k", "nms_threshold")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = V.multiclass_nms(boxes, scores, **kw)
        torch.cuda.synchronize()
        nms_ms = (time.perf_counter() - t0) * 1e3
        # the host reference with one thread a CPU of this process's
        # share: torch's default pool (one a core of the whole host)
        # oversubscribes a machine whose cgroup grants fewer
        threads = torch.get_num_threads()
        torch.set_num_threads(_host_cpus())
        try:
            t0 = time.perf_counter()
            host = V.multiclass_nms(boxes.cpu(), scores.cpu(), **kw)
            host_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.set_num_threads(threads)
    same_index = torch.equal(card[1].cpu(), host[1])
    same_rows = torch.equal(card[0].cpu(), host[0])
    kept = card[2].cpu().tolist()
    out["yolo"] = {"config": y, "boxes": list(boxes.shape),
                   "scores": list(scores.shape),
                   "yolo_box_ms_three_heads": yolo_ms,
                   "yolo_box_rel_err_vs_cpu": yolo_err,
                   "multiclass_nms_ms": nms_ms,
                   "multiclass_nms_cpu_ms": host_ms,
                   "cpu_threads": {"default": threads, "host_cpus":
                                   _host_cpus(), "os_cpu_count":
                                   os.cpu_count()}, "kept": kept,
                   "positive_scores": int((scores > y["score_threshold"])
                                          .sum()),
                   "head_logit_std": YOLO_LOGIT_STD}
    quantities["yolo_box vs its CPU run"] = (yolo_err, DET_TOL)
    quantities["multiclass_nms index differs from its CPU run"] = (
        int(not same_index), 0)
    quantities["multiclass_nms rows differ from its CPU run"] = (
        int(not same_rows), 0)
    quantities["images with nothing kept"] = (sum(k == 0 for k in kept), 0)
    out["hand_kernel_launches"] = dict(support.launch_counts)
    quantities["hand kernel launches"] = (
        sum(support.launch_counts.values()), 0)
    log("DETECTION_OPS " + json.dumps(out))
    _check("DETECTION_OPS_CHECK", quantities)
    del net, boxes, scores
    torch.cuda.empty_cache()


def _multicard_sentry(n):
    """Four NCCL ranks started by the port's launch CLI (``python -m
    paddle_tpu_torch.distributed.launch``, each rank this script with
    ``--sentry-rank``): ``testing.anomaly_cases``' mesh agreement (one
    rank's NaN row makes all four skip, bitwise), the int8
    error-feedback skip oracle, the corrupted wire scale and the
    gradients poisoned on the overlapped path, over NCCL."""
    import numpy as np
    from paddle_tpu_torch.distributed.launch import free_port
    from paddle_tpu_torch.testing import anomaly_cases
    outdir = os.path.join(ROOT, "build", "chip_smoke_sentry")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    rng = np.random.RandomState(23)
    data = {f"p{i}": (rng.standard_normal(s) * 0.3).astype(np.float32)
            for i, s in enumerate(((8, 8), (8,), (8, 1), (1,)))}
    for name, seed in (("b1", 3), ("b2", 4), ("m", 1), ("r", 5)):
        x, y = anomaly_cases.int8_feed(np.random.RandomState(seed))
        data[name + "x"], data[name + "y"] = x, y
    np.savez(os.path.join(outdir, "inputs.npz"), **data)
    cases = ["mesh_nan", "ef_oracle", "wire", "grads"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", str(n), "--master_port", str(free_port()),
         "--log_dir", os.path.join(outdir, "logs"), "--timeout", "300",
         os.path.abspath(__file__), "--sentry-rank", outdir,
         ",".join(cases)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), timeout=400)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        logs = "".join(open(os.path.join(outdir, "logs", f)).read()[-2000:]
                       for f in sorted(os.listdir(os.path.join(outdir,
                                                               "logs"))))
        raise AssertionError(f"sentry ranks exited {proc.returncode}: "
                             f"{logs}")
    res = [dict(np.load(os.path.join(outdir, f"rank{r}.npz")))
           for r in range(n)]

    def same(r, case, a, b):
        keys = sorted(k for k in r if k.startswith(f"{case}/{a}."))
        return all(np.array_equal(r[k], r[k.replace(f"/{a}.", f"/{b}.")])
                   for k in keys if not k.endswith((".skipped",
                                                    ".losses")))

    out = {"ranks": n, "seconds": seconds, "by_rank": [{
        "mesh_nan_skipped": int(r["mesh_nan/skipped"]),
        "mesh_nan_noop": bool(same(r, "mesh_nan", "before", "after")
                              and int(r["mesh_nan/step_before"])
                              == int(r["mesh_nan/step_after"])),
        "ef_oracle_skipped": int(r["ef_oracle/got.skipped"]),
        "ef_oracle_bitwise": bool(same(r, "ef_oracle", "got", "ref")),
        "wire_skipped": int(r["wire/skipped"]),
        "wire_noop": bool(int(r["wire/noop"])),
        "grads_skipped": int(r["grads/skipped"]),
        "grads_noop": bool(int(r["grads/noop"]))} for r in res]}
    out["params_equal_across_ranks"] = all(
        np.array_equal(r[k], res[0][k]) for r in res for k in res[0]
        if k.startswith("mesh_nan/after.p"))
    log("MULTICARD_SENTRY_CHECK " + json.dumps(out))
    ok = out["params_equal_across_ranks"] and all(
        b["mesh_nan_skipped"] == 1 and b["mesh_nan_noop"]
        and b["ef_oracle_skipped"] == 1 and b["ef_oracle_bitwise"]
        and b["wire_skipped"] == 1 and b["wire_noop"]
        and b["grads_skipped"] == 1 and b["grads_noop"]
        for b in out["by_rank"])
    if not ok:
        raise AssertionError(f"multi-card sentry: {out}")
    return out


def main_sentry_rank(outdir, cases):
    """``--sentry-rank OUTDIR CASES``: one rank of
    :func:`_multicard_sentry`'s job (the launch CLI set its rendezvous
    environment)."""
    from paddle_tpu_torch.testing import anomaly_cases
    anomaly_cases.run(outdir, cases.split(","), device="cuda")
    return 0


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    seconds = {}
    t0 = time.perf_counter()

    def timed(name, fn, *args):
        # reclaim the cyclic garbage earlier phases left (a profiler
        # trace's event trees): a full collection pauses the host for
        # up to a second, and a step that pays it is stalled by as much
        gc.collect()
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    timed("environment", phase_environment)
    kernel_rows = timed("paged_kernel", phase_kernels)
    timed("small_model", phase_small_model_parity)
    launches, model, kv = timed("serving", phase_serving)
    timed("decode_anatomy", phase_anatomy, model, kv)
    del model, kv
    torch.cuda.empty_cache()
    flash_rows = timed("flash_kernels", phase_flash_kernels)
    timed("small_bert", phase_small_bert_parity)
    flash_launches, bert, step, batch = timed("bert_training",
                                              phase_bert_training)
    timed("train_anatomy", phase_train_anatomy, step, batch)
    del bert, step, batch
    torch.cuda.empty_cache()
    epi_rows = timed("epilogue_adam_kernels", phase_epilogue_adam_kernels)
    timed("static_small", phase_static_small_parity)
    static_launches, run = timed("static_training", phase_static_training)
    timed("static_anatomy", phase_static_anatomy, run)
    timed("static_sentry_overhead", phase_static_sentry_overhead, run)
    del run
    torch.cuda.empty_cache()
    cmm_row = timed("chunk_matmul_kernel", phase_chunk_matmul)
    block_rows = timed("flash_block", phase_flash_block)
    timed("small_gpt", phase_small_gpt_parity)
    gpt_launches, gstep, gbatch, gtimed = timed("gpt_training",
                                                phase_gpt_training)
    timed("gpt_anatomy", phase_gpt_anatomy, gstep, gbatch, gtimed)
    del gstep, gbatch
    torch.cuda.empty_cache()
    timed("multicard", phase_multicard)
    timed("small_gpt_recompute", phase_small_gpt_recompute_parity)
    timed("gpt_recompute_masks", phase_gpt_recompute_masks)
    gpt760_launches, g7step, g7batch, g7timed = timed(
        "gpt760_training", phase_gpt760_training)
    timed("gpt760_anatomy", phase_gpt760_anatomy, g7step, g7batch, g7timed)
    del g7step, g7batch
    torch.cuda.empty_cache()
    timed("lenet_parity", phase_lenet_card_vs_cpu)
    timed("lenet_bench", phase_lenet_bench)
    timed("linear_regression", phase_linear_regression)
    timed("save_load", phase_save_load)
    timed("resnet_parity", phase_resnet_card_vs_cpu)
    r50, r50_step, r50_batch, r50_timed = timed("resnet50_training",
                                                phase_resnet50_training)
    timed("resnet50_anatomy", phase_resnet50_anatomy, r50_step, r50_batch,
          r50_timed)
    del r50, r50_step, r50_batch
    torch.cuda.empty_cache()
    sgpt_cpu_kernels = timed("static_gpt_parity", phase_static_gpt_parity)
    sgpt_rows = timed("static_gpt_kernels", phase_static_gpt_kernels)
    torch.cuda.empty_cache()
    sgpt_launches, sgpt_run, sgpt_timed = timed(
        "static_gpt_training", phase_static_gpt_training, sgpt_cpu_kernels)
    timed("static_gpt_anatomy", phase_static_gpt_anatomy, sgpt_run,
          sgpt_timed)
    del sgpt_run
    torch.cuda.empty_cache()
    bench_launches = timed("static_bench", phase_static_bench)
    ptb_small = timed("ptb_small_parity", phase_ptb_small_parity)
    ptb_model, ptb_step, ptb_ms = timed("ptb_training", phase_ptb_training)
    timed("ptb_anatomy", phase_ptb_anatomy, ptb_model, ptb_step, ptb_ms)
    timed("control_flow_sequence", phase_control_flow_and_sequence,
          ptb_model, ptb_small)
    del ptb_step
    torch.cuda.empty_cache()
    timed("nmt_small_parity", phase_nmt_small_parity)
    nmt_rows, nmt_decode_rows = timed("nmt_flash_kernels",
                                      phase_nmt_flash_kernels)
    nmt, nmt_step, nmt_batches, nmt_timed, nmt_launches = timed(
        "nmt_training", phase_nmt_training)
    timed("nmt_anatomy", phase_nmt_anatomy, nmt, nmt_step, nmt_batches,
          nmt_timed)
    nmt_decode_fwd = timed("nmt_decode", phase_nmt_decode, nmt)
    del nmt, nmt_step, nmt_batches
    torch.cuda.empty_cache()
    timed("ptb_beam_search", phase_ptb_beam_search, ptb_model, ptb_small)
    del ptb_model
    torch.cuda.empty_cache()
    timed("nn_tail", phase_nn_tail)
    timed("tail_optimizers", phase_tail_optimizers)
    lamb_launches = timed("lamb_bert", phase_lamb_bert)
    timed("lars_resnet50", phase_lars_resnet50)
    timed("double_backward", phase_double_backward)
    timed("top_level", phase_top_level)
    public_paged = timed("public_paged_attention",
                         phase_public_paged_attention)
    pallas_launches = timed("ops_pallas", phase_ops_pallas)
    artifacts = tempfile.mkdtemp(prefix="chip_smoke_artifacts_")
    try:
        pred_bert, pred_k1f, bert_prefix, r1 = timed(
            "predictor_bert", phase_predictor_bert, artifacts)
        pred_static = timed("predictor_static_bert",
                            phase_predictor_static_bert)
        timed("predictor_benches", phase_predictor_benches)
        timed("dy2static_export", phase_dy2static_export)
        mlp_prefix = timed("engine_mlp", phase_engine_mlp, artifacts)
        engine_bert = timed("engine_bert", phase_engine_bert, bert_prefix)
        timed("http_registry", phase_http_registry, bert_prefix, mlp_prefix)
        capi_bert = timed("capi", phase_capi, bert_prefix, artifacts)
        timed("generation_baseline", phase_generation_baseline)
        hot = timed("hotswap_serving", phase_hotswap_serving, bert_prefix)
        timed("observability", phase_observability, bert_prefix)
        timed("elasticity", phase_elasticity, bert_prefix)
    finally:
        shutil.rmtree(artifacts, ignore_errors=True)
    fleet_launches = timed("fleet_static_gpt", phase_fleet_static_gpt)
    timed("grad_comm_stage", phase_grad_comm_stage)
    timed("pipeline_gpt_parity", phase_pipeline_gpt_parity)
    pipe_launches, pipe_rows = timed("pipeline_gpt_training",
                                     phase_pipeline_gpt_training)
    lsgd_launches = timed("localsgd_bert", phase_localsgd_bert)
    timed("sharded_embedding", phase_sharded_embedding)
    sup_launches = timed("supervised_static_bert",
                         phase_supervised_static_bert)
    timed("swap_supervised", phase_swap_supervised)
    timed("shardcheck_gpt", phase_shardcheck_gpt)
    hapi_launches = timed("hapi_bert", phase_hapi_bert)
    timed("hapi_vision", phase_hapi_vision)
    quant_launches = timed("quant_bert", phase_quant_bert, r1)
    timed("onnx_resnet50", phase_onnx_resnet50)
    timed("detection_ops", phase_detection_ops)
    seconds["total"] = time.perf_counter() - t0
    log("PHASE_SECONDS " + json.dumps(seconds))
    f32_err = max(r["max_abs_err"] for r in kernel_rows
                  if r["case"].endswith("float32"))
    head = next(r for r in kernel_rows
                if r["case"].endswith("P=64 L=24 float32"))
    kernels = [{
        "name": "paged_attention_decode", "route": "cuda",
        "source": "paddle_tpu_torch/ops/cuda/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:63",
        "launches": (launches + public_paged + pallas_launches[K4]
                     + hot["paged_attention"]),
        "launches_by_entry": {
            "serving decode": launches, "paged_attention": public_paged,
            "ops.pallas.paged_attention_decode": pallas_launches[K4]},
        "launches_by_path": {"hotswap generation": hot["paged_attention"]},
        "max_abs_err": f32_err, "max_err": f32_err,
        "max_abs_err_bf16": max(r["max_abs_err"] for r in kernel_rows
                                if r["case"].endswith("bfloat16")),
        "shape": head["case"], "split": head["split"],
        "clusters": head["clusters"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "device_ms": head["device_ms"],
        "other_cases": [{k: r[k] for k in ("case", "split", "clusters",
                                           "ms", "device_ms", "bound_ms",
                                           "plain_ms")}
                        for r in kernel_rows if r is not head]}]
    for name, site in FLASH_KERNELS.items():
        r, b = flash_rows[name], block_rows[name]
        decode_launches = (nmt_decode_fwd if name == "flash_attention_fwd"
                           else 0)
        by_path = {"predictor bert": pred_bert.get(name, 0),
                   "predictor static bert": pred_static.get(name, 0),
                   "inference engine bert": engine_bert.get(name, 0),
                   "capi bert": capi_bert.get(name, 0),
                   "hotswap bert": hot.get(name, 0),
                   "fleet static gpt (ZeRO-3)":
                       fleet_launches.get(name, 0),
                   "supervised static bert (children)":
                       sup_launches.get(name, 0),
                   "hapi Model bert (fit, evaluate, predict)":
                       hapi_launches[name],
                   "int8 bert (Predictor runs, QAT steps)":
                       quant_launches[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/cuda/csrc/flash_attention.cu",
            "replaces": site,
            "launches": (flash_launches[name] + gpt_launches[name]
                         + gpt760_launches[name] + sgpt_launches[name]
                         + nmt_launches[name] + decode_launches
                         + lamb_launches[name] + pallas_launches[name]
                         + pipe_launches[name] + lsgd_launches[name]
                         + sum(by_path.values())),
            "launches_by_entry": {"flash_attention": flash_launches[name],
                                  "flash_attention_block":
                                      gpt_launches[name],
                                  "flash_attention (gpt)":
                                      gpt760_launches[name],
                                  "flash_attention (static gpt)":
                                      sgpt_launches[name],
                                  "flash_attention (translation "
                                  "training)": nmt_launches[name],
                                  "flash_attention (translation decode, "
                                  "8 tokens)": decode_launches,
                                  "flash_attention (LAMB bert)":
                                      lamb_launches[name],
                                  "flash_attention (pipelined gpt 1b)":
                                      pipe_launches[name],
                                  "flash_attention (LocalSGD bert)":
                                      lsgd_launches[name],
                                  "ops.pallas.flash_attention":
                                      pallas_launches[name]},
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"],
            "max_abs_err_bf16": r["max_abs_err_bf16"], "shape": r["case"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "block_entry": {k: b[k] for k in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "max_abs_err_bf16")},
            **{extra: {k: r[extra][k] for k in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_call")}
               for extra in ("gpt_760m", "static_f32")},
            "static_gpt": _instance_row(sgpt_rows[name]),
            "translation": _instance_row(nmt_rows[name]),
            "pipeline_gpt_1b": dict(
                _instance_row(pipe_rows[name]),
                launches_per_step=pipe_rows[name]["launches_per_step"]),
            **({"translation_decode": [_instance_row(d)
                                       for d in nmt_decode_rows],
                "predictor_bert": _instance_row(pred_k1f)}
               if name == "flash_attention_fwd" else {})})
    for name, site in list(EPI_KERNELS.items()) + [("fused_adam",
                                                    ADAM_SITE)]:
        r = epi_rows[name]
        src = ("fused_adam.cu" if name == "fused_adam"
               else "fused_epilogue.cu")
        by_path = {"static bert": static_launches.get(name, 0),
                   "static gpt": sgpt_launches.get(name, 0),
                   **{f"static {p}": n.get(name, 0)
                      for p, n in bench_launches.items()},
                   "ops.pallas": pallas_launches.get(name, 0),
                   "predictor bert": pred_bert.get(name, 0),
                   "predictor static bert": pred_static.get(name, 0),
                   "supervised static bert (children)":
                       sup_launches.get(name, 0)}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"paddle_tpu_torch/ops/cuda/csrc/{src}",
            "replaces": site, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "static_gpt": _instance_row(sgpt_rows[name]),
            "max_abs_err": r["max_abs_err"],
            "max_abs_err_bf16": r.get("max_abs_err_bf16"),
            "shape": r.get("case", f"{r.get('tensors')} tensors, "
                                   f"{r.get('numel')} elements, float32"),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_call": r.get("library_call"),
            **({"bf16": {k: r["bf16"][k] for k in (
                "case", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_call")}} if "bf16" in r else {})})
    kernels.append({
        "name": "chunk_matmul", "route": "cuda",
        "source": "paddle_tpu_torch/ops/cuda/csrc/chunk_matmul.cu",
        "replaces": CMM_SITE, "launches": gpt_launches["chunk_matmul"],
        "max_abs_err": cmm_row["max_abs_err"],
        "max_abs_err_bf16": cmm_row["max_abs_err_bf16"],
        "shape": cmm_row["case"], "ms": cmm_row["ms"],
        "plain_ms": cmm_row["plain_ms"], "bound_ms": cmm_row["bound_ms"],
        "bound_by": cmm_row["bound_by"],
        "library_ms": cmm_row["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    torch.distributed.destroy_process_group()
    return 0


def main_phases(names):
    """``--phases 76,77,78``: the environment, then the named phases of
    this slice alone (phase 76 saves its own float R1 for the artifact
    ratio, with no phase 53 latencies beside its own)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    phases = {"76": phase_quant_bert, "77": phase_onnx_resnet50,
              "78": phase_detection_ops}
    phase_environment()
    seconds = {}
    for name in names.split(","):
        t = time.perf_counter()
        phases[name]()
        seconds[name] = time.perf_counter() - t
    log("PHASE_SECONDS " + json.dumps(seconds))
    log(nvidia_smi())
    return 0


def main_phase7(runs):
    """``--phase7-runs N``: phase 7 alone, N times in this process (each
    run's ``BERT_PARITY`` line carries both sides' parameter
    fingerprints): run the command in several processes to see whether
    the card and the CPU give the same bits run to run."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    phase_environment()
    for _ in range(runs):
        phase_small_bert_parity()
    log(nvidia_smi())
    return 0


def main_multicard():
    """``--multicard``: phase 18 alone (the hybrid GPT and, on four
    cards, the fleet, pipeline and hybrid {dp, mp} legs) on every card
    the machine shows: the one path of this script that spans cards,
    without the single-card phases."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    phase_environment()
    out = phase_multicard()
    log(nvidia_smi())
    return 0 if out is not None else 1


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        if sys.argv[1:2] == ["--phase7-runs"]:
            sys.exit(main_phase7(int(sys.argv[2])))
        if sys.argv[1:2] == ["--phases"]:
            sys.exit(main_phases(sys.argv[2]))
        if sys.argv[1:2] == ["--multicard"]:
            sys.exit(main_multicard())
        if sys.argv[1:2] == ["--sentry-rank"]:
            sys.exit(main_sentry_rank(sys.argv[2], sys.argv[3]))
        code = main()
    except Exception:                  # noqa: BLE001 - report, exit 1
        import traceback
        traceback.print_exc()
        code = 1
    sys.exit(code)
