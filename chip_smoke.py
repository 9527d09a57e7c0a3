#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tmr_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a Hopper GPU and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port, compiled from ``tmr_tpu_torch/csrc``; then the
   toolchain probe ``add1`` runs, before any other kernel, and its event-bracketed time
   is printed beside its profiled device time and the host's cost per launch (through
   the registered op ``tmr::add1``, its CUDA kernel called bare, and the bare launch);
3. kernels: each kernel at the main path's shapes against its plain PyTorch version on
   the same inputs, with the tolerance stated, timed beside its plain version, a
   PyTorch library call computing the same function (timed here, never used by the
   port) and its bound (bytes or operations over the card's peak); each attention
   kernel is one launch that makes its own bias projections (kernel = wrapper), timed
   beside SDPA with the bias mask precomputed and, printed with it, what SDPA's time
   leaves out: ``bias_projections`` and the mask build; the global kernel, with and
   without the bias, is also held to its plain version on 24x40, 96x96 (one image),
   20x20, 28x28, 5x7 and 7x64 token grids, the windowed kernel at 7x7 and 16x16 windows;
   both attention kernels again at head dim 80 (SAM ViT-H: the global kernel at 64x64
   with BH 64, with and without the bias, and at 24x40, 5x7 and 7x64; the windowed kernel,
   whose windows up to 16x16 take the persistent ``wgmma`` kernel, at 14x14 with BH 1600
   and with the persistent loop's tails at BH 7 and 133, 7x7 and 16x16, and at 20x12 and
   4x32, which keep ``window_attn_kernel<80, 2 | 4>``),
   with ``-Xptxas -v`` of every attention instantiation; the f32 attention kernels
   (``csrc/attn_f32.cu``, 3xTF32 ``wgmma``) against their plain version in f32 (per
   element 2e-5 x max|want|) at the main paths' shapes (global 64x64 at BH 48 and, at head
   dim 80, 64, with and without the bias; windowed 14x14 at BH 1200 and 1600), the 1536
   bucket's 96^2 tokens (BH 48) and 4 x 49 windows, 24x40, 5x7 and 7x64 grids and 7x7 and
   16x16 windows at both head dims, and without the bias on 14x14 windows (BH 1200: the
   windowed blocks of ``Attention(use_rel_pos=False)``), 5x7 and 24x40, each beside SDPA in
   f32 (with the mask precomputed) and its bound at a third of the TF32 peak; then each of
   the six main-path instantiations with a NaN in q, an infinity in k and a -infinity in v
   (no output the plain version makes non-finite may come out finite, the rest within the
   tier), and ``-Xptxas -v`` of the eight instantiations; the f32 correlation at T = 1 to 65
   on the matcher's map with its 3xTF32 tensor bound and its f32 bound, and on 96^2 and 64^2
   maps, a ragged map, a bf16-valued feature, the multi path's 12 rows and a feature with
   non-finite values planted; the int8 correlation at T = 1 to 65 on the matcher's map,
   timed in turns with the CUDA-core kernel it replaced, beside the function's bound and the
   band's, and on two ragged maps, a map of -128/-127/127 only and the multi path's 12 rows
   (0 mismatches everywhere); the int8 matmul at the heads' shape for 4 and 12 rows, a tap's
   and a ragged one (its library yardstick ``torch._int_mm`` times the scales, the heads'
   N = 5 padded to 8); greedy NMS (an IoU bitmask and a block scan, two launches a call) on 4
   x 2000 boxes with planted ties at IoU 0.5 and 0.15 (keep masks equal to the plain
   version's on the card and on the CPU), timed in turns with the sequential kernel it
   replaced, its launches split by the profiler, beside the function's bound and the
   design's, with both kernels' ``-Xptxas -v``, and on a ragged 2 x 2001, 1 x 63, 1 x 65, 1
   x 12000 (past the old 9000-box cap), an all-invalid batch, 2000 identical boxes and a
   chain of 2000 (0 mismatches), and on the unions of the multi-exemplar path, 4 x 6000 (k
   3) and 1 x 16000 (k bucket 8), each timed beside its bound (0 mismatches); the fused int8
   3x3 layer at the int8 tail's shape, a ragged one and the multi path's 12 rows, timed in
   turns with the per-tap composition it replaces, beside the bare ``torch._int_mm`` of the
   im2col'd product and its ``-Xptxas -v``; and the 1536 bucket's shapes: the global
   kernel on 96^2 tokens at batch 4 (BH 48, the plain version in chunks; one 96-key tile
   a grid row) and at head dim 80 (ViT-H's BH 64), the windowed kernel on 4 x 49
   windows, the f32 correlation on 4 x 512 x 192^2 at T = 9, 17, 33 and on the multi
   path's 3 x 512 x 192^2 at T = 9, each beside its bound and library call;
   the f32 correlation on the default detector's 4 x 512 x 64^2 map at T = 1 (prototype
   templates), 9, 17 and 33, each beside its bound and the grouped ``F.conv2d``; and its
   backward (``cuda_xcorr.xcorr_backward``, one more launch of the kernel for d_feature)
   at T = 1 and 9 on that map against ``torch.autograd.grad`` through ``xcorr_plain`` in
   f32 (2e-5 x each gradient's max), beside its bound and the autograd of the grouped
   ``F.conv2d``;
4. main path: ``Predictor(preset("TMR_FSCD147"))`` (SAM ViT-B at 1024, batch 4, bf16)
   with seeded random weights answers 3 batches of 4 synthetic images whose exemplars
   hit the 9/17/33 template buckets; every kernel's launch count over those batches
   must be > 0 (``window_attn`` exactly 24: one per windowed block; the head dim 80
   counters and the int8 kernels' 0), nothing may call
   ``bias_projections`` (both attention kernels make their own projections), batch 0's
   keep mask must equal the plain version's on the same detections, and image 0's
   objectness map must agree with an f32 CPU run of the same port and weights;
4b. the int8 path: the same preset with ``quant="int8", quant_storage="int8",
   quant_kernel="int8"`` and phase 4's weights (stored as int8) answers the same 3
   batches; its launch counts must be exactly those of its path; its decoder tail on
   one ``f_cat`` must equal the same tail run with the int8 kernels' plain versions on
   the card; the activation quantization passes are timed on that ``f_cat``; the int8
   tail must lie within the JAX package's output tier (5e-2) of the
   exact tail on that tier's inputs at the production geometry, and the stored-weight
   path with the dequant arm within it of phase 4's objectness map; the int8 path's
   objectness is printed beside phase 4's and held to a bound on gross faults (its
   difference over both maps, the tier's measure, is printed too), and so are the
   statistics of image 0's ``f_cat`` and the int8 tail's error on it;
4c. the ViT-H path: ``Predictor(preset("TMR_FSCD147", backbone="sam_vit_h"))`` (SAM
   ViT-H at 1024: 32 blocks of 1280 over 16 heads of 80, global at 7/15/23/31, batch 4,
   bf16) with seeded random weights answers the same 3 batches; its launches must be
   exactly ``global_attn_d80`` 12, ``window_attn_d80`` 84, ``xcorr`` 3, ``nms`` 3 and 0
   for every other kernel, nothing may call ``bias_projections``, batch 0's keep mask
   must equal the plain version's, and image 0's objectness must agree with an f32 CPU
   run of the same port and weights (its seconds printed); printed beside it, the same
   map from the bf16 network with its attention through ``attention_plain`` on the card
   (a yardstick of this script, never a path of the port), which separates bf16 drift
   over 32 blocks from kernel error;
4d. the multi-exemplar path (run after 4b, on phase 4's and 4b's predictors): the same
   images, each carrying 3 exemplars (phase 4's first, then two more squares of its
   size; k bucket 3, real rows (3, 3, 2, 1), padded with the last real row), through
   ``predict_multi_batch``: its launches over the 3 batches must be exactly global 12,
   window 24, xcorr 3, nms 3 and 0 else (the encoder once per image); each batch's union
   keep mask must equal the plain version's on the same merged detections; row
   (image b, exemplar 0)'s objectness must lie within 1e-2 x the max of phase 4's map
   for image b, and every real row within 1e-2 x max of ``predict_multi_exemplar`` on
   image b alone; ``_get_heads_fn(cap, 1024)(_get_backbone_fn()(images), exemplars)``
   must equal ``pred(images, exemplars)`` bit for bit (backbone and heads timed apart);
   ``decode_tail="device"`` must give the host tail's per-image lists; and one batch on
   the int8 path must launch exactly int8_conv 1, int8_mm 1, xcorr_int8 1, global 4,
   window 8 and nms 1, with its union keep mask equal to the plain version's. Its ms
   per batch of 4 images x 3 exemplars is printed beside phase 4's;
5. eval (run after 4d, on phase 4's weights, before 4c):
   ``tmr_tpu_torch.train.loop.Trainer.test(params=...)`` over a synthetic FSCD-147-layout
   test split of 12 images of 384 x 512 (annotation files written to a temporary
   directory, the images kept in memory and handed over by the reader's decode step):
   8 with objects of 30-46 px (the 1024 bucket) and 4 with objects of 12-16 px, which
   the small-object rule sends to the 1536 bucket (96^2 tokens, 7 x 7 windows after
   padding to 98, 192^2 matcher maps); at ``num_exemplars=1``, ``eval_batch_size=4``
   and at ``num_exemplars=3`` (one image a batch), each twice (cold, then warm). Printed:
   the loader's host ms per image in each bucket, the metrics, and per bucket the
   images, the program's ms per batch and images/s beside phase 4's. Checks: every
   batch launches exactly global 4, window 8, xcorr 1, nms 1 and nothing else; its
   detections equal ``Predictor.__call__`` (or ``predict_multi_exemplar``) on the same
   tensors bit for bit; its losses equal ``compute_losses`` on the same model outputs
   and are finite; MAE and RMSE equal those of the detection counts; the 1536 batch
   takes the template bucket phase 3 checks on 192^2 maps; and image 0 of the 1536
   batch has its objectness within 5e-2 x max of an f32 CPU run (made on a thread beside
   phase 5c's CLI runs, where the card idles, and compared after them); then once at
   ``compute_dtype="float32"`` (num_exemplars 1, both buckets) with the same checks and
   the f32 attention kernels' launches (4 / 8 a batch, none of the bf16 ones);
5b. training (run after 5, on phase 4's weights): first each attention Function's
   backward (PyTorch, recomputing the scores in query bands) at main-path shapes, the
   global one at BH 48 on 64x64 tokens with and without the bias and the windowed one at
   BH 1200 on 14x14, both again at head dim 80 (BH 64 and 1600): dq, dk, dv and the
   compact tables' gradients against ``torch.autograd.grad`` of ``attention_plain`` in
   f32 on the card, each within 2^-7 (the tables' 1e-4) of its largest element, the
   backward's ms printed
   beside the kernel forward's and its bound (2.5x the forward's operations); then
   ``Trainer.fit`` of ``preset("TMR_FSCD147")`` (SAM ViT-B at 1024, batch 4, bf16, frozen
   backbone) from phase 4's weights on a synthetic FSCD-147-layout split of 8 train and
   4 val images, 3 epochs in one run and 2 then a resumed 1 in another. Checks: every
   train step launches exactly global 4 and window 8 and no correlation (its template
   capacity is 191, the FFT route), NMS or int8 kernel; each validation batch phase 5's
   launches; the loss is finite and no step skipped; the backbone is phase 4's bit for
   bit while the head moves; the resumed run's head within 1e-2 of what the run moved it
   from the uninterrupted run's; the gradient's global norm within 2e-2 of the same step
   through ``attention_plain`` on the card (a yardstick of this script, never a path of
   the port); 8 steps on one batch lower its loss; a non-finite gradient is discarded;
   ``xcorr`` on a tensor that requires grad raises. Printed: ms per step warm, images/s,
   peak device memory, and a ``{"train": ..., "backward": [...]}`` JSON line; beside each
   backward, the autograd of SDPA with its mask built from the tables in the graph (the
   library yardstick) and whether the memory-efficient backend alone returns the mask's
   gradient. At ``compute_dtype="float32"``: the same Functions on f32 inputs at the
   bias cases' shapes, every gradient within 1e-4 of its largest element, and one epoch
   of ``Trainer.fit`` (2 steps, each launching exactly the f32 kernels' 4 / 8, finite
   losses, none skipped; its validation batch 4 / 8 / 1 / 1), ms per step and peak memory
   printed beside the bf16 run's;
5c. the map phase (run after 5b, on phase 4's encoder): kernels 1 and 4 against their
   plain versions at batch 8's shapes (BH 96 and 2400); 3 synthetic tar shards of 10
   PNGs of 480 x 640 (``Easy_0``, ``Normal_0``, ``Hard_0``: a batch of 8 and a padded
   tail of 2 each) and a tar cut inside its first member, written with ``zlib`` and
   ``struct``; the encoder saved as a SAM checkpoint; ``python -m
   tmr_tpu_torch.parallel.mapreduce map ... | tee ... | ... reduce`` in subprocesses with
   the native and the ``tarfile`` loader, with a transient ``tar.open`` fault on shard 1
   (``TMR_FAULTS``), and cut at shard 2 then ``--resume``d; in this process the same map
   through ``run_stream_native`` with CUDA events around each batch, then through
   ``run_stream`` with the attention through ``attention_plain``; and ``extract_feature``
   at batch 1 on a 720 x 1280 image. Where PIL is missing, the PNGs are decoded by this
   script's reader (it says which). Checks: each batch of 8 launches exactly global 4,
   window 8 and nothing else, ``extract_feature`` the same; stdout of ``map`` is records
   only and ``reduce``'s table is theirs; the corrupt tar is quarantined on its first
   attempt; the two loaders', the fault run's and the resumed run's records are equal
   byte for byte; one (64, 64, 256) float32 feature file per counted image; features and
   table within 5e-2 of the ``attention_plain`` run (the table's sums relative to its std
   sums); the ``(1, 64, 64, 256)`` dump and its statistics likewise. Printed: the
   loader's host ms per image (decode, resize), images/s, the encoder's device ms per
   batch of 8, the device's busy share (events around each batch over the wall) and
   ``extract_feature``'s ms, with the card, and a ``{"map": ...}`` JSON line;
5g. the elastic map phase (run after 5c, on phase 4's encoder saved as 5c saves it):
   6 synthetic tar shards of 10 PNGs of 480 x 640 (Easy, Normal, Hard; 5c's writer); the
   single-host ``mapreduce map | reduce`` CLI over them is the reference table and feature
   tree. The worker payload (``utils/package.py``) is zipped, unpacked into a temporary
   directory and its ``attn.cu`` built from its own ``csrc`` beside the reference run.
   Clean run: ``ElasticCoordinator`` in this process; two ``python -m
   tmr_tpu_torch.elastic_map worker --device cuda`` processes on the card, one from the
   unpacked payload with phase 5h's encoder artifact (``--artifact``) in place of the
   checkpoint; once both said hello, a third worker as a thread of this process,
   whose every batch of 8 must launch exactly global 4 and window 8 and nothing else
   (launch counts zeroed before the run, read after); every worker must commit a shard.
   Fault run (TTL 3 s; the worker processes paced by ``TMR_FAULTS=tar.open:latency=1.0``):
   once both worker processes hold fresh leases, the one holding the lower shard is
   kill -9'd (a ``worker_exit`` reassignment) and the other SIGSTOPped until its lease is
   revoked as ``stale_heartbeat``, then SIGCONTed (at least one fenced rejection); a
   thread worker finishes the run. Resume: the coordinator CLI is kill -9'd once 3 shards
   hold a valid marker, then ``--resume`` with one worker must fold exactly the marked
   shards and re-encode only the others. Each run's table (its records) and feature tree
   must equal the reference byte for byte and its ``elastic_report/v1`` validate, with a
   cause from the closed list on every reassignment. Every wait and process is bounded
   (180 s). Printed: images/s of the reference and of the clean run, each shard's seconds
   by worker, shards committed per worker, reassignments by cause, fenced rejections, the
   phase's wall seconds with the card, and an ``{"elastic": ...}`` JSON line;
5h. the ``torch.export`` artifacts (run after 5c and before 5g, on phase 4's weights;
   ``tmr_tpu_torch/utils/export.py``, every kernel wrapper a registered ``tmr::`` op): the
   bf16 ViT-B encoder traced on the card with a symbolic batch, saved and loaded back
   (seconds of each step and the file's MB printed); at batch 8 on 5c's images its
   features and statistics against ``make_encode_stats_fn``, and at batches 1 and 3
   against the eager encoder; the same encoder traced on the CPU (fake tensors) and
   loaded onto the card (``move_to_device_pass``) against the card's export; ``map
   --artifact`` (CLI, no checkpoint read, run beside the rest of the phase) on 5c's shard
   Easy_0 and the corrupt tar against 5c's in-process record of that category,
   and the same map through the artifact in this process, timed (images/s beside 5c's);
   ``extract_feature --artifact`` at batch 1 against the run without it; the detector
   artifact at batch 4 and capacity 33 on phase 4's bucket-33 batch against
   ``Predictor.__call__`` (ms per batch beside the eager call's and phase 4's); a
   multi-exemplar artifact of 3 rows on phase 4d's image 0 at k_real 3 (against
   ``predict_multi_exemplar``) and 2 (against ``predict_multi_batch`` at the same bucket,
   and ``predict_multi_exemplar``'s lists); phase 4b's int8 predictor at batch 4 and
   capacity 33 against its eager call; ``export_sam_decoder`` on seeded ``Sam`` weights at
   1 and 5 prompts against ``SamDeployDecoder.__call__``; and ``torch.library.opcheck`` of
   every ``tmr::`` op on the card. Every comparison is bit for bit; each encoder batch of
   8 launches exactly global 4 and window 8, each detector call 4 / 8 / 1 / 1 and the int8
   one global 4, window 8, xcorr_int8 1, int8_mm 1, int8_conv 1, nms 1. Printed: the
   phase's wall seconds and an ``{"export": ...}`` JSON line;
5d. SAM box refinement (run after 5c, on phase 4's weights and ``build_refiner`` with
   seed 0; the refiner is f32 PyTorch and launches none of the port's kernels): batch 2
   of phase 4 (bucket 33) through ``Predictor.__call__`` with ``refine_box`` must launch
   exactly global 4, window 8, xcorr 1, nms 1 and nothing else, its NMS keep mask on the
   refined boxes must equal the plain version's, and its ms are taken in turns with the
   unrefined call (plain, refined, refined, plain); the refiner on that batch against an
   f32 CPU run of the same refiner on image 0's first 32 valid slots: thresholded mask
   pixels equal except where the CPU's logit lies within 1e-4 of its mask's largest
   |logit|, boxes of slots whose masks agree within 1e-6, scores within 1e-5 of the
   largest score, invalid slots unchanged bit for bit and refs the box centres; one
   chunk of 50 prompts timed whole and in parts (prompt encoder and two-way transformer,
   upscaling and masks, the full-size resize and boxes) beside its bound (its operations,
   ``decoder_flops``, at the f32 peak); ``predict_multi_batch`` with the refiner on batch
   0 of phase 4d (launches exactly a third of phase 4d's; the device tail's lists equal
   the host tail's) and ``_get_heads_fn`` on the backbone's features equal to the fused
   call bit for bit; ``Trainer.test`` with the refiner on phase 5's split at
   num_exemplars 1, and at 3 on 4 images made as phase 5's, 2 in each size bucket (a depth
   cut; phase 5's checks: launches per batch, detections equal to the
   refining Predictor's bit for bit, losses, MAE/RMSE), its images/s beside phase 5's
   warm runs; then the segment-anything surface on phase 4's encoder and the refiner's
   decoder: ``SamPredictor.set_image`` on a 720 x 1280 image must launch exactly global 4
   and window 8, a box and a point prompt each give a mask of the original size, and
   ``SamAutomaticMaskGenerator.generate`` (8^2 points, quality filters open) launches
   NMS once through the port's kernel. Printed: ms per batch with and without
   refinement, a chunk's ms and its parts, eval images/s, ``set_image`` and ``predict``
   ms, the mask generator's seconds per image, and a ``{"refine": ...}`` JSON line;
5f. the serving engine (run after 5d, on phase 4's predictor):
   ``tmr_tpu_torch.serve.ServeEngine`` (batch bound 4, ``max_wait_ms`` 10, default caches)
   fed by 4 client threads with 48 requests in 3 waves: the 12 single-exemplar requests
   of phase 4's batches (buckets 9, 17, 33) and the 12 multi-exemplar ones of phase 4d;
   then every other one of them again (result-cache hits) and 8 of the images with a new
   exemplar (the second sighting: promotion, the heads path with the encoder for the
   fill); then 4 of those with a third exemplar (feature-cache hits). Checks: every future
   resolves; no error, fallback or rejection; the counters reconcile exactly with the
   batches the engine finished (submitted, completed, batches, riders and result-cache
   hits, coalesced, padded slots, heads batches, fills); the launches are exactly global
   4, window 8, xcorr 1, nms 1 per executed fused batch, xcorr 1 and nms 1 per heads batch
   (the encoder's 4 and 8 only where it fills) and nothing for a cache hit; each served
   result equals the same ``Predictor`` program on the engine's own padded stack bit for
   bit (and each fill's features the encoder on the staged images). Measured and
   printed, not held: how many distinct requests differ from a sequential B = 1 call, by
   how much, and the first module whose row-0 output differs between a batch of 4 and
   the image alone. Then a second engine with an in-flight bound of 4 (``TMR_ADMIT``'s
   controller) takes a burst of 20 and is closed at once: every future resolves, the
   rejections equal the counters by cause, and ``close()`` keeps its drain bound; one
   request under ``TMR_TRACE=1`` carries all seven spans (submit, queue_wait,
   batch_assemble, stage, execute, postprocess, resolve); ``health()`` passes the port's
   ``validate_health_report`` and its ``compile`` section lists this run's ``nvcc``
   builds. Printed: requests/s, latency p50/p95/p99 (client side, and the engine's
   histogram), batches, mean fill, padded slots, cache hit rates, the spans' ms, beside
   phase 4's sequential ms per batch, and a ``{"serve": ...}`` JSON line; ``--profile``
   adds a torch.profiler table and the busy share of one served burst of 24 requests;
5i. the gallery tier and the demo (run after 5f, on phase 4's predictor): bank A, 12
   patterns of 3 boxes in template bucket 17 (one group: n_bucket 16, k_bucket 3, 48
   rows), searched three times on one frame: the fused arm (cold), the features arm (the
   second sighting fills the feature cache) and a cache hit, launching exactly 4 / 8 / 1 /
   1, 4 / 8 / 1 / 1 and 0 / 0 / 1 / 1; the three arms' results equal bit for bit; the
   fused tail's NMS equal to its plain version; each entry's decoded scores before NMS
   within 1e-2 x max of the N-loop's (12 ``predict_multi_exemplar`` calls). Bank B, 32
   patterns of 1-3 boxes in buckets 9, 17, 33 (nine groups), with the prefilter's top-k
   8, on the linear scan and through the sketch index: the encoder once a frame, 24
   entries skipped with ``degrade_steps: ["prefilter"]``, the index's results equal to
   the scan's bit for bit, both fallback counters 0; the coarse scores (kernel 5 on 96 x
   32 planes of 32^2 at T 31) within 2e-5 x max of the same call through ``xcorr_plain``,
   with the same top-k. ``ServeEngine.search_gallery`` on a bank sharing the engine's
   feature cache equals bank A's results bit for bit and counts
   ``serve.gallery.searches``. ``map --features_out tcp://`` on 5c's shard Easy_0 into a
   ``FeatureSinkServer``: every feature equal to 5c's ``.npy`` byte for byte, the journal
   marker absent when ``sync`` arrives. ``python -m tmr_tpu_torch.demo`` (seeded ViT-B at
   1024, emb 512) with and without ``--refine_box``: a 1024-wide PNG, its count equal to
   ``DemoEngine.infer``'s in process, which equals ``predict_multi_exemplar`` bit for bit
   and launches 4 / 8 / 1 / 1. Printed: ms per fused frame beside the N-loop's, per
   features-arm, cache-hit and prefilter-on frame and per prefilter call, frames/s, the
   subprocesses' seconds and the peak memory at 48 rows;
5j. stream sessions and the feature tier (run after 5f, on phase 4's predictor): 3
   streams of 8 frames of 1024² (each a static synthetic scene with fresh noise of std
   0.01 a frame, cut to a new scene at frame 4), a client thread a stream, first through
   ``ServeEngine.submit`` (batch bound 1, caches off: the frame-independent baseline),
   then through ``StreamRouter(engine, reuse=True)`` over an engine of the same settings:
   the router's counters exactly 3 first, 3 changed and 18 reused frames and 6 local
   fills; each full-path frame's result equal to its baseline result bit for bit; every
   reused result labelled ``["temporal_reuse"]`` and no full-path one; no reused result
   equal to a result of another stream; the router's encoder launches at most 4 / 8 x
   (full-path frames + fills); each heads batch exactly xcorr 1 and nms 1. Then a
   ``FeatureTier`` (size 1024) in this process, a ``FeatureWorker`` in a child process on
   the card (phase 4's preset and seed, so its stamp is the script's; it runs one extract
   before it leases), and ``ServeEngine(pred, feature_client=tier.client(predictor=
   pred))``: a clean run of 12 distinct frames in 3 waves of 4 (remote frames 12; cold,
   fallback and stamp mismatches 0; no attention launch in this process; the worker's 4 /
   8 an extract; each result equal to its heads program on the fetched features, and
   those equal to this process's encoder at batch 1, bit for bit), then a fault run of 8
   frames whose first fetch kill -9s the worker (every future resolves; all 8 counted
   cold or fallback and run here through the encoder's kernels, each equal to its program
   on its inputs bit for bit). Printed: frames/s and latency p50 / p95 both ways, a
   frame's parts (signature, digest, fused, encoder, heads), ms per remote frame against
   a local fused frame, a fetch's round trip, the wire's MB a frame, pack / unpack ms,
   and a ``{"streams": ...}`` JSON line;
4f. ``compute_dtype="float32"`` (run after 4d on phase 4's weights, and for ViT-H after
   4c on its weights): ``Predictor(preset("TMR_FSCD147", compute_dtype="float32"))`` on
   phase 4's 3 batches and one ``predict_multi_batch`` of phase 4d's, then ViT-H at f32 on
   phase 4's batch 0; PyTorch's TF32 settings are kept at their defaults and printed (the
   linears cuBLAS SGEMM, TF32 off; the convolutions cuDNN, TF32 on). Each batch must
   launch exactly the f32 attention kernels' 4 global and 8 windowed blocks (ViT-H: 4 and
   28 at head dim 80), one correlation and one NMS, and no bf16 attention kernel; nothing
   may call ``bias_projections``; the keep mask must equal the plain version's; image 0's
   objectness must lie within 2e-2 x max of the f32 CPU run of phase 4 (4c), printed
   beside the bf16 network's figure (``--profile``: a torch.profiler table of ViT-B's third
   batch). Then one global block (4 x 64^2 tokens) and one windowed block (100 windows of
   14^2) of ``Attention(use_rel_pos=False)`` at ViT-B's width, in f32 and bf16: exactly 2
   ``global_attn_f32`` and 2 ``global_attn`` launches (the windowed blocks take the global
   kernel without tables) and nothing else, image 0 within 1e-4 (f32) or 5e-2 (bf16) x max
   of an f32 CPU run of the same weights. Then ``tmr_tpu_torch.main --eval --compute_dtype
   float32 --visualize`` in process on phase 5's split from a Lightning checkpoint of
   phase 4's weights: 4 / 8 / 1 / 1 a batch, finite metrics, and a triptych PNG (3 x 512 x
   384) of each of the 12 images. Printed: ms per batch, images/s and peak memory beside
   the bf16 figures of the same call, and a ``{"f32": ...}`` JSON line;
4e. the JAX ``main.py`` default detector (run after 4c, on its own seeded weights):
   ``Predictor(Config())`` (ResNet-50 with DC5 in f32 under the caller's cuDNN TF32
   setting, 1024^2, emb_dim 512, no fusion, no upsample, roi_align, NMS 0.1 / 0.15, bf16
   heads) answers 3 batches of 4 synthetic images whose exemplars hit buckets 9, 17 and
   33 on its 64^2 map; each batch must launch exactly xcorr 1 and nms 1 and nothing else
   of the port's; batch 0's keep mask must equal the plain version's; image 0's
   objectness must lie within 5e-2 x max of an f32 CPU run (its ResNet feature's drift
   printed beside it); image 0's seeded feature must be finite with a std in [1e-2,
   1e2]; the split programs and the device tail must equal the fused call bit for bit;
   then the same 3 batches with ``template_type="prototype"``: xcorr 1 a batch, every
   call at T = 1. Printed: ms per batch, the ResNet's share of it, the device time of a
   batch split into ResNet, heads, kernel 5 and NMS, and image 0's feature std;
5e. the default detector's eval and training (run after 4e, on its weights):
   ``Trainer.test`` on phase 5's split at num_exemplars 1 and 3 with phase 5's checks
   (each batch xcorr 1, nms 1 and nothing else); ``Trainer.fit`` of ``Config()`` (the
   backbone trains at ``lr_backbone`` 1e-5, roi_align at capacity 191 through the FFT)
   on phase 5b's split for 2 epochs of 2 steps: every step launches none of the port's
   kernels, the losses are finite and none skipped, the backbone moves and its batch
   norm statistics do not, and ``test()`` reads back the best ``.ckpt`` it wrote (a
   ResNet encoder in the Lightning layout); then one prototype train step through
   ``cuda_xcorr.XCorr``: exactly 2 launches of kernel 5 (the forward and d_feature), and
   the Function's gradients at the step's own inputs equal to ``torch.autograd`` through
   ``xcorr_plain`` in f32 within 2e-5 x each gradient's max. Printed: ms per step, peak
   device memory, and a ``{"default": ...}`` JSON line;
6. a ``{"kernels": [...]}`` JSON line (``global_attn_1536``: kernel 1 on the 1536 bucket's
   96^2 tokens, phase 3's numbers and phase 5's launches; phase 5j's launches, this
   process's and its feature worker's, counted in those of kernels 1, 4, 5 and 6), then
   the card line, then the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or ``tmr_tpu``. Exits non-zero without a result when there is
no CUDA device or when the port's sources are not beside this file.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

#: published peaks of one H100 SXM (dense): bf16, TF32 and int8 tensor cores, f32 CUDA
#: cores, HBM. An int8 x int8 -> int32 sum is bounded at the int8 rate whatever
#: instruction a kernel uses for it
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# attention, per element: |got - want| <= ATTN_REL_TOL |want| + ATTN_ABS_TOL max|want|
# (one bf16 ulp of the element, plus a floor for the noise of p's bf16 rounding on
# elements that cancel to near zero: p and the output round to bf16 at different
# points of the two softmaxes); and mean |got - want| <= ATTN_MEAN_TOL mean |want|
ATTN_REL_TOL = 2.0 ** -7
ATTN_ABS_TOL = 2.0 ** -9
ATTN_MEAN_TOL = 2.0 ** -8
#: the f32 attention kernels (3xTF32, about 2^-21 per product) vs their plain version's
#: exact f32 products summed in another order, per element relative to max|want|: the
#: correlation's f32 tier (one TF32 pass would miss it)
ATTN_F32_TOL = 2e-5
#: the rate an f32 product runs at as 3xTF32: three TF32 products
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
#: the f32 correlation (3xTF32 on the tensor cores, about 2^-21 per product) vs its
#: plain version's f32 sums of T^2 products in another order, relative to max|want|
XCORR_REL_TOL = 2e-5
#: templates the f32 correlation is held at on the matcher's map; the main path takes
#: 9, 17 and 33, the direct path every odd T up to 65
XCORR_TS = (1, 3, 9, 17, 33, 65)
#: other maps, (B, C, H, W, templates, feature rounded to bf16): the 768 and 512 inputs'
#: 96^2 and 64^2 maps, a ragged map with 7 planes, the main path's bf16 feature
#: (``fp.float()`` of a bf16 map, exact in tf32), the multi-exemplar path's 12 rows
#: (4 images x 3 exemplars), and the gallery prefilter's 96 rows (a rung of 32 entries x
#: k 3) of 32 sketch planes on the 32^2 coarse grid at its capacity, T = 31
XCORR_MAPS = ((4, 512, 96, 96, (9, 17, 33, 65), False),
              (4, 512, 64, 64, (9, 17, 33, 65), False),
              (1, 7, 100, 76, XCORR_TS, False),
              (4, 512, 128, 128, (9, 33, 65), True),
              (12, 512, 128, 128, (33,), True),
              (96, 32, 32, 32, (31,), False))
OBJ_REL_TOL = 5e-2  # bf16 network vs f32 CPU network, relative to the map's max
#: tmr_tpu/ops/quant.py OUTPUT_TIER_REL: the int8 tail vs the exact tail on the JAX
#: package's own tier inputs (quant_int8dot_ok), and the stored-weight (dequant) path's
#: objectness vs the bf16 path's
QUANT_TIER_REL = 5e-2
#: the int8 path's objectness vs the bf16 path's, relative to the objectness map's own
#: max: a bound on faults of the composition (a wrong scale or layout moves the map by
#: its whole size), not a tier. The int8 arm's one activation scale per image is set by
#: f_cat's per-channel offsets and outliers, and the map follows the channels' small
#: spatial variation, so the JAX function itself reads ~0.1 on this measure here (and
#: within 5e-2 on its tier's, both maps; tests/test_torch_quant.py, PERF.md)
INT8_PATH_OBJ_BOUND = 0.25
#: launches of the int8 path over its 3 batches: one fused 3x3 layer and one head
#: matmul, one int8 correlation, 4 global and 8 windowed attention blocks, one NMS per
#: batch
#: the f32 attention kernels' counters (``compute_dtype="float32"``), none launched on
#: the bf16 paths
F32_ZERO = {"global_attn_f32": 0, "window_attn_f32": 0, "global_attn_f32_d80": 0,
            "window_attn_f32_d80": 0}
QUANT_LAUNCHES = {"global_attn": 12, "window_attn": 24, "xcorr": 0, "nms": 3,
                  "xcorr_int8": 3, "int8_mm": 3, "int8_conv": 3, "add1": 0,
                  "global_attn_d80": 0, "window_attn_d80": 0, **F32_ZERO}
#: launches of the ViT-H path over its 3 batches: 4 global and 28 windowed attention
#: blocks at head dim 80, one f32 correlation and one NMS per batch
VIT_H_LAUNCHES = {"global_attn": 0, "window_attn": 0, "xcorr": 3, "nms": 3,
                  "xcorr_int8": 0, "int8_mm": 0, "int8_conv": 0, "add1": 0,
                  "global_attn_d80": 12, "window_attn_d80": 84, **F32_ZERO}
#: the multi-exemplar path (phase 4d): real exemplar rows of the 4 images of a batch, in
#: k bucket 3; its launches over the 3 batches (the encoder once per image, the heads,
#: correlation and NMS once per batch); the int8 path's over one batch; the bound on each
#: row's objectness against the same row run another way (phase 4's batch of 4, or
#: ``predict_multi_exemplar`` alone), relative to that map's max: the heads run at 12
#: rows against 4 or k, so cuDNN and cuBLAS may pick other algorithms under bf16 rounding
MULTI_K_REAL = (3, 3, 2, 1)
MULTI_LAUNCHES = {"global_attn": 12, "window_attn": 24, "xcorr": 3, "nms": 3,
                  "xcorr_int8": 0, "int8_mm": 0, "int8_conv": 0, "add1": 0,
                  "global_attn_d80": 0, "window_attn_d80": 0, **F32_ZERO}
MULTI_INT8_LAUNCHES = {name: n // 3 for name, n in QUANT_LAUNCHES.items()}
MULTI_ROW_TOL = 1e-2
#: the NMS kernel at the multi-exemplar path's unions (images, slots): k 3 at batch 4,
#: and one image at k bucket 8
NMS_UNIONS = ((4, 6000), (1, 16000))
#: the fused int8 3x3 layer's shapes (B, H, W, C_in, N): the int8 tail's (4 x 128^2,
#: 1024 -> 2048 [objectness | bbox]), a ragged one (W past no tile edge, N not a
#: multiple of 8, C_in not of 128), and the multi-exemplar path's 12 rows
INT8_CONV_SHAPES = ((4, 128, 128, 1024, 2048), (1, 37, 53, 48, 20),
                    (12, 128, 128, 1024, 2048))
#: the f32 correlation on the default detector's map (ResNet-50 DC5 at 1024: 4 images x
#: 512 channels on 64^2), at the prototype's T = 1 and the buckets its exemplars take; its
#: backward at the prototype's T and one more
XCORR_64 = ((4, 512, 64, 64), (1, 9, 17, 33))
XCORR_BWD_TS = (1, 9)
BUCKET_SIDES_PX = {9: 56, 17: 120, 33: 240}  # exemplar sides that land in each bucket
SEED = 0  # weights, images and kernel inputs are all drawn from it


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def exact_f32(torch):
    """TF32 off for the kernel checks' f32 products and library yardsticks, restored
    after, so the main path runs under the settings a caller of the port has."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def call_count(module, name: str):
    """Records the calls of ``module.name`` made through the module while the block runs,
    as (args, kwargs), in order."""
    calls = []
    orig = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


#: heads of the SAM ViT with each head dim the kernels take: ViT-B 12 x 64, ViT-H 16 x 80
VIT_HEADS = {64: 12, 80: 16}


def check_attention(torch, F, cuda_attn, windowed: bool, has_bias: bool, seed: int,
                    grid=(64, 64), bh=None, d: int = 64, chunk=None, f32: bool = False):
    """One attention kernel vs its plain version at head dim ``d``, by default at the
    batch of the ViT with that head dim (4 images of 12 heads for ViT-B, 16 for ViT-H;
    windowed: 25 windows each). The global kernel takes compact (2g - 1, d) tables, the
    windowed kernel expanded (g, g, d) ones; the plain version and the yardstick use the
    expanded tables. Times, on the same inputs: the kernel (one launch, projections
    inside), ``bias_projections`` alone, the mask built from the projections, and SDPA
    with that mask precomputed. With ``chunk``, the plain version runs over that many
    rows of BH at a time (its dense f32 scores of a 96^2 grid at BH 48 would take 16 GB),
    its time the sum of the chunks'. ``f32``: the f32 kernels (``compute_dtype=
    "float32"``) on f32 inputs, held to ATTN_F32_TOL x max|want| per element, SDPA in f32,
    the bound at the 3xTF32 rate (a third of the TF32 peak)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gh, gw = grid
    bh = bh or (4 * VIT_HEADS[d] * (25 if windowed else 1))
    s = gh * gw
    dtype = torch.float32 if f32 else torch.bfloat16
    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    tab = rh = rw = None
    if has_bias and windowed:
        rh = torch.randn(gh, gh, d, generator=gen, device="cuda") * 0.1
        rw = torch.randn(gw, gw, d, generator=gen, device="cuda") * 0.1
        tab = rh, rw
    elif has_bias:
        tab = (torch.randn(2 * gh - 1, d, generator=gen, device="cuda") * 0.1,
               torch.randn(2 * gw - 1, d, generator=gen, device="cuda") * 0.1)
        rh, rw = (cuda_attn.get_rel_pos(g, g, t) for g, t in zip(grid, tab))
    tab = tab or (None, None)
    scale = d ** -0.5
    fn = cuda_attn.window_attention if windowed else cuda_attn.global_attention
    rel = cuda_attn.bias_projections(q, rh, rw, (gh, gw)) if has_bias else (None, None)
    got = fn(q, k, v, *tab, (gh, gw), scale)
    chunk = chunk or bh
    parts = [slice(i, i + chunk) for i in range(0, bh, chunk)]

    def plain(part):
        return cuda_attn.attention_plain(q[part], k[part], v[part],
                                         *(None if r is None else r[part] for r in rel),
                                         (gh, gw), scale)

    want = torch.cat([plain(part) for part in parts])
    torch.cuda.synchronize()
    diff, ref = (got.float() - want.float()).abs(), want.float().abs()
    limit = (ATTN_F32_TOL * ref.max() if f32
             else ATTN_REL_TOL * ref + ATTN_ABS_TOL * ref.max())
    acc = dict(max_abs_err=diff.max().item(), mean_abs_err=diff.mean().item(),
               mean_abs_want=ref.mean().item(), max_abs_want=ref.max().item(),
               worst_err_over_limit=(diff / limit).max().item(), f32=f32)
    acc["ok"] = acc["worst_err_over_limit"] <= 1.0 and (
        f32 or acc["mean_abs_err"] <= ATTN_MEAN_TOL * acc["mean_abs_want"])
    t = dict(ms=cuda_ms(lambda: fn(q, k, v, *tab, (gh, gw), scale)))
    del want, diff, ref, limit
    t["plain_ms"] = sum(cuda_ms(lambda: plain(part), reps=3 if len(parts) == 1 else 1,
                                warmup=1 if len(parts) == 1 else 0) for part in parts)
    mask = None
    if has_bias:
        t["proj_ms"] = cuda_ms(lambda: cuda_attn.bias_projections(q, rh, rw, (gh, gw)))

        def build_mask():
            m = (rel[0][..., :, None] + rel[1][..., None, :]).reshape(bh, s, s)
            return m.to(dtype)[None]

        t["mask_ms"] = cuda_ms(build_mask, reps=5, warmup=1)
        mask = build_mask()
    t["lib_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[None], k[None], v[None], attn_mask=mask, scale=scale), reps=5, warmup=1)
    flops = 4.0 * bh * s * s * d
    # q, k, v read and out written once, and the tables the kernel reads (the windowed
    # kernel's expanded ones, the global kernel's compact ones)
    nbytes = (4 * bh * s * d * q.element_size()
              + (sum(t.numel() for t in tab) * 4 if has_bias else 0))
    return acc, t, bound(flops, nbytes, PEAK_3XTF32_FLOPS if f32 else PEAK_BF16_FLOPS)


#: windowed kernel off the main path, (head dim, window, BH or None for the ViT's)
WINDOW_GRIDS = ((64, (7, 7), None), (64, (16, 16), None), (80, (7, 7), None),
                (80, (16, 16), None), (80, (14, 14), 7), (80, (14, 14), 133),
                (80, (20, 12), None), (80, (4, 32), None))
#: instantiations of the head-dim-80 wgmma windowed kernel (slots, gwp)
WG_INSTANCES = ((224, 16), (256, 16))
#: token grids off the main path, each with and without the bias, (gh, gw, batch*heads):
#: rows that are not one key tile (24x40), the 1536 bucket at one image (the plain
#: version's dense f32 scores take 4 GB), the 320^2 and 448^2 inputs' grids whose token
#: counts are not multiples of 64 (20x20, 28x28), one partial tile (5x7), and 64-token
#: rows in an odd count (7x64: the main path's 128-key tiles end half empty)
GLOBAL_GRIDS = ((24, 40, 48), (96, 96, 12), (20, 20, 48), (28, 28, 48), (5, 7, 48),
                (7, 64, 48))
#: the same at head dim 80 (ViT-H's 16 heads of 4 images)
GLOBAL_GRIDS_D80 = ((24, 40, 64), (5, 7, 64), (7, 64, 64))


def check_global_grids(torch, F, cuda_attn, d: int = 64, grids=GLOBAL_GRIDS) -> None:
    """The global kernel at head dim ``d`` against its plain version on ``grids``."""
    for gh, gw, bh in grids:
        for has_bias in (True, False):
            acc, t, (bms, bby) = check_attention(torch, F, cuda_attn, False, has_bias, SEED,
                                                 (gh, gw), bh, d)
            what = (f"global_attn{'' if has_bias else '_nobias'}{'' if d == 64 else f'_d{d}'}"
                    f" {gh}x{gw} grid, BH={bh}")
            print(f"kernel {what}: {attn_accuracy(acc)} {attn_times(t)} bound_ms "
                  f"{bms:.4f} ({bby})", flush=True)
            if not acc["ok"]:
                fail(f"{what} disagrees with its plain version: {acc}")


#: the f32 attention kernels (``compute_dtype="float32"``) at the main paths' shapes, the
#: kernels line's entries: (counter, windowed, bias, grid, head dim), at the batch of the
#: ViT with that head dim (ViT-B BH 48 and 1200, ViT-H 64 and 1600); the global kernel
#: without the bias is ``Attention(use_rel_pos=False)``'s, its launches counted under
#: ``global_attn_f32`` (``_d80``) as the bf16 ones are under ``global_attn``
ATTN_F32_MAIN = (("global_attn_f32", False, True, (64, 64), 64),
                 ("global_attn_nobias_f32", False, False, (64, 64), 64),
                 ("global_attn_f32_d80", False, True, (64, 64), 80),
                 ("global_attn_nobias_f32_d80", False, False, (64, 64), 80),
                 ("window_attn_f32", True, True, (14, 14), 64),
                 ("window_attn_f32_d80", True, True, (14, 14), 80))
#: and off them, (windowed, bias, grid, BH or None for the ViT's, head dim, plain
#: version's BH chunk): the 1536 bucket's 96^2 tokens at batch 4 and its 4 x 49 windows,
#: rows that are not one key tile (24x40), one partial tile (5x7), 64-token rows in an odd
#: count (7x64), 7x7 and 16x16 windows, at both head dims; without the bias the windowed
#: blocks of ``Attention(use_rel_pos=False)`` (14x14 tokens, BH 1200, through the global
#: kernel), 5x7 and 24x40
ATTN_F32_GRIDS = ((False, True, (96, 96), 48, 64, 12),
                  (True, True, (14, 14), 4 * 12 * 49, 64, None),
                  (False, True, (24, 40), 48, 64, None), (False, True, (5, 7), 48, 64, None),
                  (False, True, (7, 64), 48, 64, None), (False, True, (24, 40), 64, 80, None),
                  (False, True, (5, 7), 64, 80, None), (False, True, (7, 64), 64, 80, None),
                  (True, True, (7, 7), None, 64, None), (True, True, (16, 16), None, 64, None),
                  (True, True, (7, 7), None, 80, None), (True, True, (16, 16), None, 80, None),
                  (False, False, (14, 14), 4 * 12 * 25, 64, None),
                  (False, False, (5, 7), 48, 64, None), (False, False, (24, 40), 64, 80, None))
#: ``csrc/attn_f32.cu`` instantiations ``attn_f32_kernel<D, BIAS, ROW_TILE>``: no bias,
#: compact tables on whole-tile grid rows, compact tables elsewhere, expanded tables
ATTN_F32_INSTANCES = ((0, 0, "no bias"), (1, 1, "compact tables, whole-tile rows"),
                      (1, 0, "compact tables"), (2, 0, "expanded tables"))


def check_attention_f32(torch, F, cuda_attn, _build) -> dict:
    """The f32 attention kernels (``csrc/attn_f32.cu``) against their plain version at
    :data:`ATTN_F32_MAIN` and :data:`ATTN_F32_GRIDS`, then with non-finite inputs, with
    ``-Xptxas -v`` of each instantiation; returns the kernels line's entries."""
    entries = {}
    log = _build.LOGS.get("attn_f32")
    for d in (64, 80):
        for bias, row_tile, what in ATTN_F32_INSTANCES:
            print(f"ptxas attn_f32_kernel<{d}, {bias}, {bool(row_tile)}> ({what}): "
                  f"{ptxas_info(log, f'attn_f32_kernelILi{d}ELi{bias}ELb{row_tile}E')}",
                  flush=True)
    cases = [(name, windowed, bias, grid, None, d, None)
             for name, windowed, bias, grid, d in ATTN_F32_MAIN]
    cases += [(None, *case) for case in ATTN_F32_GRIDS]
    for name, windowed, bias, grid, bh, d, chunk in cases:
        acc, t, (bms, bby) = check_attention(torch, F, cuda_attn, windowed, bias, SEED,
                                             grid, bh, d, chunk, f32=True)
        what = name or (f"{'window' if windowed else 'global'}_attn"
                        f"{'' if bias else '_nobias'}_f32{'' if d == 64 else f'_d{d}'} "
                        f"{grid[0]}x{grid[1]} {'windows' if windowed else 'grid'}"
                        + (f", BH={bh}" if bh else ""))
        print(f"kernel {what}: {attn_accuracy(acc)} {attn_times(t)} bound_ms {bms:.4f} "
              f"({bby}, 3xTF32 at a third of the TF32 peak)", flush=True)
        if not acc["ok"]:
            fail(f"{what} disagrees with its plain version: {acc}")
        if name:
            entries[name] = dict(max_abs_err=acc["max_abs_err"], ms=t["ms"],
                                 plain_ms=t["plain_ms"], bound_ms=bms, bound_by=bby,
                                 library_ms=t["lib_ms"])
        torch.cuda.empty_cache()
    for name, windowed, bias, grid, d in ATTN_F32_MAIN:
        check_attention_f32_nonfinite(torch, cuda_attn, name, windowed, bias, grid, d)
    return entries


def check_attention_f32_nonfinite(torch, cuda_attn, name, windowed, has_bias, grid, d):
    """One f32 instantiation with a NaN planted in q, an infinity in k and a -infinity in v
    (heads 0, 1 and 2 of BH 6): every output the plain version makes non-finite must be
    non-finite from the kernel too (the 3xTF32 split turns a non-finite word into a NaN lo,
    so the kernel may make more outputs non-finite: an infinite score the plain softmax
    drops becomes a NaN), and where both are finite they agree within ATTN_F32_TOL x the
    finite max."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    gh, gw = grid
    bh, s, scale = 6, gh * gw, d ** -0.5
    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda") for _ in range(3))
    q[0, 5, 3], k[1, s - 3, d - 1], v[2, s // 2, 0] = math.nan, math.inf, -math.inf
    tab = (None, None)
    rel = (None, None)
    if has_bias and windowed:
        tab = tuple(torch.randn(g, g, d, generator=gen, device="cuda") * 0.1 for g in grid)
        rel = cuda_attn.bias_projections(q, *tab, grid)
    elif has_bias:
        tab = tuple(torch.randn(2 * g - 1, d, generator=gen, device="cuda") * 0.1
                    for g in grid)
        rel = cuda_attn.bias_projections(
            q, *(cuda_attn.get_rel_pos(g, g, t) for g, t in zip(grid, tab)), grid)
    fn = cuda_attn.window_attention if windowed else cuda_attn.global_attention
    got = fn(q, k, v, *tab, grid, scale)
    want = cuda_attn.attention_plain(q, k, v, *rel, grid, scale)
    torch.cuda.synchronize()
    lost = int((~want.isfinite() & got.isfinite()).sum().item())
    both = got.isfinite() & want.isfinite()
    err = (got - want)[both].abs().max().item()
    tol = ATTN_F32_TOL * want[both].abs().max().item()
    print(f"kernel {name} {gh}x{gw}, BH {bh}, a NaN in q, +inf in k, -inf in v: non-finite "
          f"outputs {int((~want.isfinite()).sum())} plain, {int((~got.isfinite()).sum())} "
          f"kernel, {lost} lost (must be 0); max_err where both are finite {err:.3e} tol "
          f"{tol:.3e}", flush=True)
    if lost or not err <= tol:
        fail(f"{name} loses a non-finite output or disagrees beside one")


def attn_times(t: dict) -> str:
    extra = (f" bias_projections_ms {t['proj_ms']:.4f} mask_build_ms {t['mask_ms']:.4f}"
             if "proj_ms" in t else "")
    return (f"kernel_ms {t['ms']:.4f} (one launch) plain_ms "
            f"{t['plain_ms']:.4f} library_ms {t['lib_ms']:.4f} (SDPA, mask precomputed)"
            + extra)


def attn_accuracy(acc: dict) -> str:
    limit = (f"limit {ATTN_F32_TOL:g} max|want| per element" if acc["f32"] else
             f"limit {ATTN_REL_TOL:g}|want| + {ATTN_ABS_TOL:g} max|want| per element, "
             f"mean_err <= {ATTN_MEAN_TOL:g} mean|want|")
    return (f"max_err {acc['max_abs_err']:.3e} mean_err {acc['mean_abs_err']:.3e} "
            f"({limit}; mean|want| "
            f"{acc['mean_abs_want']:.3e}, max|want| {acc['max_abs_want']:.3e}, worst "
            f"err/limit {acc['worst_err_over_limit']:.3f})")


def check_xcorr(torch, F, cuda_xcorr, t: int, seed: int, shape=(4, 512, 128, 128),
                bf16: bool = False, yardsticks: bool = True) -> dict:
    """The f32 correlation vs its plain version on one map; its time, and with
    ``yardsticks`` the plain version's and a grouped ``F.conv2d``'s. Bounds of the
    useful products: 3xTF32 at the TF32 tensor peak (the kernel's) and f32 at the CUDA
    cores' peak, each against the bytes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, c, h, w = shape
    feat = torch.randn(b, c, h, w, generator=gen, device="cuda")
    if bf16:
        feat = feat.bfloat16().float()
    tmpl = torch.randn(b, c, t, t, generator=gen, device="cuda")
    got = cuda_xcorr.xcorr(feat, tmpl)
    want = cuda_xcorr.xcorr_plain(feat, tmpl)
    torch.cuda.synchronize()
    r = dict(err=(got - want).abs().max().item(),
             tol=XCORR_REL_TOL * want.abs().max().item(),
             ms=cuda_ms(lambda: cuda_xcorr.xcorr(feat, tmpl)), plain_ms=None, lib_ms=None)
    if yardsticks:
        r["plain_ms"] = cuda_ms(lambda: cuda_xcorr.xcorr_plain(feat, tmpl), reps=1,
                                warmup=0)
        r["lib_ms"] = cuda_ms(lambda: F.conv2d(feat.view(1, b * c, h, w),
                                               tmpl.view(b * c, 1, t, t), padding=t // 2,
                                               groups=b * c))
    flops = 2.0 * b * c * h * w * t * t
    nbytes = (2 * b * c * h * w + b * c * t * t) * 4
    r["tensor_bound"] = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    r["f32_bound"] = bound(flops, nbytes, PEAK_F32_FLOPS)
    return r


def check_xcorr_maps(torch, F, cuda_xcorr) -> None:
    """The f32 correlation against its plain version on XCORR_MAPS."""
    for b, c, h, w, ts, bf16 in XCORR_MAPS:
        for t in ts:
            r = check_xcorr(torch, F, cuda_xcorr, t, SEED, (b, c, h, w), bf16, False)
            what = f"xcorr {b}x{c}x{h}x{w}{' bf16 feature' if bf16 else ''} T={t}"
            print(f"kernel {what}: max_err {r['err']:.3e} tol {r['tol']:.3e} kernel_ms "
                  f"{r['ms']:.4f} bound_ms {r['tensor_bound'][0]:.4f} (3xTF32)", flush=True)
            if not r["err"] <= r["tol"]:
                fail(f"{what} disagrees with its plain version: {r['err']} > {r['tol']}")
    # non-finite inputs: every output the plain version makes non-finite is NaN or
    # infinite from the kernel too (which spreads them over the band), the rest agree
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    feat = torch.randn(1, 7, 100, 76, generator=gen, device="cuda")
    feat[0, 1, 40, 30], feat[0, 4, 3, 70], feat[0, 6, 99, 0] = math.nan, math.inf, -math.inf
    tmpl = torch.randn(1, 7, 9, 9, generator=gen, device="cuda")
    got, want = cuda_xcorr.xcorr(feat, tmpl), cuda_xcorr.xcorr_plain(feat, tmpl)
    lost = int((~want.isfinite() & got.isfinite()).sum().item())
    both = got.isfinite() & want.isfinite()
    err = (got - want)[both].abs().max().item()
    tol = XCORR_REL_TOL * want[both].abs().max().item()
    print(f"kernel xcorr 1x7x100x76 T=9, a NaN and two infinities planted: non-finite "
          f"outputs {int((~want.isfinite()).sum())} plain, {int((~got.isfinite()).sum())} "
          f"kernel, {lost} lost (must be 0); max_err where both are finite {err:.3e} tol "
          f"{tol:.3e}", flush=True)
    if lost or not err <= tol:
        fail("xcorr loses a non-finite output or disagrees beside one")


#: the 1536 bucket (phase 5's test images with objects under 25 px): the global kernel
#: on 96^2 tokens at batch 4 (BH 48; the plain version in chunks of BH 12), its one
#: 96-key tile a grid row, and again at head dim 80 (ViT-H's BH 64, in chunks of 16), the
#: windowed kernel on 4 x 49 windows (96 tokens padded to 98) of 12 heads and of ViT-H's
#: 16 (BH 3136, the persistent wgmma kernel's longest walk), and the
#: correlation on 192^2 maps, at 4 images and at the multi path's 3 rows of one image, for
#: the bucket phase 5's 1536 images take (:data:`EVAL_1536_BUCKETS`) and, for the band
#: maths at W = 192, the larger ones of the direct path. (name, windowed, grid, BH, chunk,
#: head dim)
ATTN_1536 = (("global_attn", False, (96, 96), 48, 12, 64),
             ("global_attn_d80", False, (96, 96), 64, 16, 80),
             ("window_attn", True, (14, 14), 4 * 12 * 49, None, 64),
             ("window_attn_d80", True, (14, 14), 4 * 16 * 49, None, 80))
XCORR_1536 = (((4, 512, 192, 192), (9, 17, 33)), ((3, 512, 192, 192), (9,)))


def check_1536(torch, F, cuda_attn, cuda_xcorr) -> dict:
    """Kernels 1, 1-H, 4, 4-H and 5 at the 1536 bucket's shapes against their plain versions,
    each beside its bound and the library call; returns the kernels line's entry of kernel
    1 there (``global_attn_1536``)."""
    entries = {}
    for name, windowed, grid, bh, chunk, d in ATTN_1536:
        acc, t, (bms, bby) = check_attention(torch, F, cuda_attn, windowed, True, SEED,
                                             grid, bh, d, chunk)
        what = (f"{name} 1536 bucket, {grid[0]}x{grid[1]} "
                f"{'windows' if windowed else 'grid'}, BH={bh}")
        print(f"kernel {what}: {attn_accuracy(acc)} {attn_times(t)} bound_ms {bms:.4f} "
              f"({bby})", flush=True)
        if not acc["ok"]:
            fail(f"{what} disagrees with its plain version: {acc}")
        if name == "global_attn":
            entries["global_attn_1536"] = dict(
                max_abs_err=acc["max_abs_err"], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=bms, bound_by=bby, library_ms=t["lib_ms"])
        torch.cuda.empty_cache()
    for shape, ts in XCORR_1536:
        for t in ts:
            r = check_xcorr(torch, F, cuda_xcorr, t, SEED, shape)
            (bms, bby), (f32ms, f32by) = r["tensor_bound"], r["f32_bound"]
            what = f"xcorr 1536 bucket {'x'.join(map(str, shape))} T={t}"
            print(f"kernel {what}: max_err {r['err']:.3e} tol {r['tol']:.3e} kernel_ms "
                  f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
                  f"{r['lib_ms']:.4f} (grouped F.conv2d) bound_ms {bms:.4f} ({bby}, "
                  f"3xTF32 at the TF32 peak) f32_bound_ms {f32ms:.4f} ({f32by})", flush=True)
            if not r["err"] <= r["tol"]:
                fail(f"{what} disagrees with its plain version: {r['err']} > {r['tol']}")
    return entries


def check_xcorr_64(torch, F, cuda_xcorr) -> None:
    """Kernel 5 on the default detector's map at :data:`XCORR_64`, each beside its bound
    and the grouped ``F.conv2d``; then its backward at :data:`XCORR_BWD_TS`."""
    shape, ts = XCORR_64
    for t in ts:
        r = check_xcorr(torch, F, cuda_xcorr, t, SEED, shape)
        (bms, bby), (f32ms, f32by) = r["tensor_bound"], r["f32_bound"]
        what = f"xcorr default detector {'x'.join(map(str, shape))} T={t}"
        print(f"kernel {what}: max_err {r['err']:.3e} tol {r['tol']:.3e} kernel_ms "
              f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms {r['lib_ms']:.4f} "
              f"(grouped F.conv2d) bound_ms {bms:.4f} ({bby}, 3xTF32 at the TF32 peak) "
              f"f32_bound_ms {f32ms:.4f} ({f32by})", flush=True)
        if not r["err"] <= r["tol"]:
            fail(f"{what} disagrees with its plain version: {r['err']} > {r['tol']}")
    for t in XCORR_BWD_TS:
        check_xcorr_backward(torch, F, cuda_xcorr, t, shape)


def grads_err(got, want) -> list:
    """(max |got - want|, max |want|) of each gradient."""
    return [((a - b).abs().max().item(), b.abs().max().item()) for a, b in zip(got, want)]


def check_xcorr_backward(torch, F, cuda_xcorr, t: int, shape) -> dict:
    """The f32 correlation's backward (``xcorr_backward``: d_feature by the kernel on the
    flipped template, d_template by T^2 plain products) against ``torch.autograd.grad``
    through ``xcorr_plain`` in f32 on the same inputs, each gradient within
    XCORR_REL_TOL x its max; timed beside that autograd (the plain version's backward),
    the autograd of the grouped ``F.conv2d`` (the library call) and its bound: the bytes
    of f, t and g read and both gradients written, or the 2 x 2 B C H W T^2 f32
    operations at the CUDA cores' peak."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + t)
    b, c, h, w = shape
    feat = torch.randn(b, c, h, w, generator=gen, device="cuda")
    tmpl = torch.randn(b, c, t, t, generator=gen, device="cuda")
    g = torch.randn(b, c, h, w, generator=gen, device="cuda")
    got = cuda_xcorr.xcorr_backward(feat, tmpl, g)
    fr, tr = feat.clone().requires_grad_(), tmpl.clone().requires_grad_()
    out = cuda_xcorr.xcorr_plain(fr, tr)
    want = torch.autograd.grad(out, (fr, tr), g, retain_graph=True)
    errs = grads_err(got, want)
    ms = cuda_ms(lambda: cuda_xcorr.xcorr_backward(feat, tmpl, g))
    plain_ms = cuda_ms(lambda: torch.autograd.grad(out, (fr, tr), g, retain_graph=True),
                       reps=1, warmup=0)
    lib_out = F.conv2d(fr.view(1, b * c, h, w), tr.view(b * c, 1, t, t), padding=t // 2,
                       groups=b * c)
    lib_g = g.view(1, b * c, h, w)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (fr, tr), lib_g,
                                                 retain_graph=True))
    bms, bby = bound(4.0 * b * c * h * w * t * t, (3 * b * c * h * w + 2 * b * c * t * t) * 4,
                     PEAK_F32_FLOPS)
    print(f"kernel xcorr backward {b}x{c}x{h}x{w} T={t}: d_feature max_err "
          f"{errs[0][0]:.3e} tol {XCORR_REL_TOL * errs[0][1]:.3e}, d_template max_err "
          f"{errs[1][0]:.3e} tol {XCORR_REL_TOL * errs[1][1]:.3e}; backward_ms {ms:.4f} "
          f"(1 launch of kernel 5) plain_ms {plain_ms:.4f} (autograd of xcorr_plain) "
          f"library_ms {lib_ms:.4f} (autograd of the grouped F.conv2d) bound_ms "
          f"{bms:.4f} ({bby})", flush=True)
    if not all(e <= XCORR_REL_TOL * m for e, m in errs):
        fail(f"xcorr backward at T={t} disagrees with the autograd of xcorr_plain: {errs}")
    return dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound_ms=bms, bound_by=bby)


def int8_xcorr_inputs(torch, shape, t: int, seed: int, extreme: bool = False):
    """(feature, template, f_scale, t_scale) of the int8 correlation: int8 values drawn
    over [-128, 127], or with ``extreme`` from {-128, -127, 127} only (full magnitude of
    both signs; -128 never comes from the quantizer but the kernel takes any int8)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, c, h, w = shape

    def i8(*dims):
        if extreme:
            vals = torch.tensor([-128, -127, 127], dtype=torch.int8, device="cuda")
            return vals[torch.randint(0, 3, dims, generator=gen, device="cuda")]
        return torch.randint(-128, 128, dims, generator=gen, device="cuda",
                             dtype=torch.int8)

    feat, tmpl = i8(b, c, h, w), i8(b, c, t, t)
    fs = torch.rand(b, c, 1, 1, generator=gen, device="cuda") * 0.01 + 1e-4
    ts = torch.rand(b, c, 1, 1, generator=gen, device="cuda") * 0.01 + 1e-4
    return feat, tmpl, fs, ts


def check_xcorr_int8(torch, F, cuda_xcorr, _build, t: int, seed: int,
                     shape=(4, 512, 128, 128), extreme: bool = False,
                     yardsticks: bool = True) -> dict:
    """The int8 correlation vs its int32 plain version: the sums are exact in both, so
    the f32 results must be equal (0 mismatches). With ``yardsticks``: timed in turns
    with the CUDA-core kernel it replaced (``tmr_xcorr_int8_cuda_cores``, same inputs,
    its mismatches counted too), beside the plain version and the library yardstick, a
    float64 grouped ``F.conv2d`` of the int8 values (the sums stay below 2^53, so it is
    exact too) and the same epilogue. Bounds: the function's (the map in and out once,
    the useful products at the int8 peak) and the band's (the products the kernel
    performs, the band's depth per output and template row)."""
    b, c, h, w = shape
    feat, tmpl, fs, ts = int8_xcorr_inputs(torch, shape, t, seed, extreme)
    got = cuda_xcorr.xcorr_int8(feat, tmpl, fs, ts)
    want = cuda_xcorr.xcorr_int8_plain(feat, tmpl, fs, ts)
    torch.cuda.synchronize()
    r = dict(mism=int((got != want).sum().item()), err=(got - want).abs().max().item())
    del want
    kernel = lambda: cuda_xcorr.xcorr_int8(feat, tmpl, fs, ts)  # noqa: E731
    if not yardsticks:
        r["ms"] = cuda_ms(kernel)
        return r
    old_fn = _build.lib("xcorr").tmr_xcorr_int8_cuda_cores
    stream = _build.stream_of(feat)

    def old():
        out = torch.empty(feat.shape, dtype=torch.float32, device="cuda")
        rc = old_fn(feat.data_ptr(), tmpl.data_ptr(), fs.data_ptr(), ts.data_ptr(),
                    out.data_ptr(), b * c, h, w, t, stream)
        if rc:
            fail(f"tmr_xcorr_int8_cuda_cores: CUDA error {rc} at launch")
        return out

    r["old_mism"] = int((old() != got).sum().item())
    ms, old_ms = [], []
    for fn, dst in ((kernel, ms), (old, old_ms), (old, old_ms), (kernel, ms)):
        dst.append(cuda_ms(fn))
    r.update(ms=min(ms), ms_turns=ms, old_ms=min(old_ms), old_turns=old_ms)
    r["plain_ms"] = cuda_ms(lambda: cuda_xcorr.xcorr_int8_plain(feat, tmpl, fs, ts), reps=1,
                            warmup=0)

    def library():
        acc = F.conv2d(feat.view(1, b * c, h, w).double(),
                       tmpl.view(b * c, 1, t, t).double(), padding=t // 2, groups=b * c)
        return acc.view(b, c, h, w).float() * (fs * ts)

    r["lib_mism"] = int((library() != got).sum().item())
    r["lib_ms"] = cuda_ms(library, reps=3, warmup=1)
    depth = cuda_xcorr.int8_geometry(t)["depth"]
    nbytes = b * c * h * w * (1 + 4) + b * c * t * t + 2 * b * c * 4
    r["bound"] = bound(2.0 * b * c * h * w * t * t, nbytes, PEAK_INT8_OPS)
    r["band_bound"] = bound(2.0 * b * c * h * w * depth * t, nbytes, PEAK_INT8_OPS)
    return r


#: other maps of the int8 correlation, (B, C, H, W, extreme values): ragged maps whose
#: rows are not 16-byte aligned (staged bytewise), and a map of -128/-127/127 only
XCORR_INT8_MAPS = ((1, 7, 100, 76, False), (1, 3, 37, 53, False), (2, 4, 64, 64, True))
#: the int8 correlation at the multi-exemplar path's 12 rows (4 images x 3 exemplars)
XCORR_INT8_MULTI = (12, 512, 128, 128)


def int8_mm_inputs(torch, kind: str, seed: int):
    """(x_q, w_q, x_scale, w_scale) of one int8_mm shape: a 3x3 tap
    of the stacks' first layer (its shifted window of the padded activation, as the tail
    passes it), the block-diagonal heads, or a ragged shape."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(*shape, generator=gen, device="cuda") * 0.01 + 1e-4

    if kind == "tap":  # M = 4 * 128^2, K = 1024, N = 2048
        x = i8(4, 130, 130, 1024)[:, 1:129, 2:130, :]
        sx = scales(4)[:, None, None].expand(4, 128, 128).contiguous()
        w, sw = i8(2048, 1024), scales(2048)
    elif kind in ("head", "head12"):  # M = B * 128^2, K = 2048, N = 5
        b = 4 if kind == "head" else 12  # 12: the multi path's rows
        x = i8(b, 128, 128, 2048)
        sx = scales(b)[:, None, None].expand(b, 128, 128).contiguous()
        w, sw = i8(5, 2048), scales(5)
    else:  # ragged M, N and a K that is not a multiple of 16
        x, sx, w, sw = i8(1000, 1000), scales(1000), i8(200, 1000), scales(200)
    return x, w, sx, sw


def check_int8_mm(torch, cuda_int8, kind: str, seed: int):
    """int8_mm vs its plain version (exact int32 sums, the same epilogue): equal bit for
    bit. The library yardstick is ``torch._int_mm`` times the broadcast row and column
    scales, on a contiguous copy of x (it takes no strided rows); the bare ``_int_mm``
    (int32 out) is timed beside it. Its shape rules want N a multiple of 8: the heads'
    N = 5 is padded with zero rows of w (made once, outside the timing) and the product
    cut back to N, which computes the same function. None where K is not a multiple of 8."""
    x, w, sx, sw = int8_mm_inputs(torch, kind, seed)
    got = cuda_int8.int8_mm(x, w, sx, sw)
    want = cuda_int8.int8_mm_plain(x, w, sx, sw)
    torch.cuda.synchronize()
    mism = int((got != want).sum().item())
    err = (got - want).abs().max().item()
    ms = cuda_ms(lambda: cuda_int8.int8_mm(x, w, sx, sw))
    plain_ms = cuda_ms(lambda: cuda_int8.int8_mm_plain(x, w, sx, sw), reps=1, warmup=0)
    n, k = w.shape
    m = sx.numel()
    lib_ms = bare_ms = None
    if k % 8 == 0 and m > 16:
        n8 = -(-n // 8) * 8
        wp = torch.zeros(n8, k, dtype=w.dtype, device=w.device)
        wp[:n] = w
        x2, wt = x.reshape(m, k).contiguous(), wp.t()
        sx2, sw2 = sx.reshape(m, 1), sw.reshape(1, n)
        lib_ms = cuda_ms(lambda: torch._int_mm(x2, wt)[:, :n] * sx2 * sw2)
        bare_ms = cuda_ms(lambda: torch._int_mm(x2, wt))
    ops = 2.0 * m * n * k
    nbytes = m * k + n * k + 4 * (m + n) + 4 * m * n
    return ((m, n, k), mism, err, ms, plain_ms, lib_ms, bare_ms,
            bound(ops, nbytes, PEAK_INT8_OPS))


def sass_opcodes(lib_path, kernel: str, opcode: str):
    """{function: count} of the SASS instructions starting with ``opcode`` in each function
    of the library whose name contains ``kernel`` (``cuobjdump -sass``), or None where the
    toolkit has no ``cuobjdump``."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        if kernel in name:
            # an instruction line: /*addr*/ [@predicate] OPCODE.modifiers operands ; /*code*/
            counts[name.strip()] = sum(
                1 for line in body.splitlines()
                if re.match(rf"\s*/\*[0-9a-f]+\*/\s*(@!?U?P\w+\s+)?{opcode}\b", line))
    return counts


def ptxas_info(log, kernel: str) -> str:
    """Registers, shared memory and spills that ``-Xptxas -v`` reported for ``kernel``."""
    if not log:
        return "not rebuilt in this run"
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            return " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                              if "bytes" in x or "Used" in x)
    return "not in the log"


def check_int8_conv(torch, F, cuda_int8, shape, seed: int) -> dict:
    """The fused 3x3 layer vs its plain version on random int8 operands: exact int32
    sums and the same f32 steps, so equal bit for bit (0 mismatches). Timed in turns
    with the composition it replaces on the int8 path (9 ``int8_mm`` launches on the
    zero-padded activation, the f32 tap adds, the bias and ``leaky_relu``; its
    mismatches against the kernel are counted too). The rate yardstick is the bare
    ``torch._int_mm`` of the im2col'd product, (B H W x 9 C_in) . (9 C_in x N): not the
    same function (no per-tap scales), None where its shape rules refuse."""
    b, h, w, c, n = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xq = torch.randint(-127, 128, (b, h, w, c), generator=gen, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3, n, c), generator=gen, device="cuda",
                       dtype=torch.int8)
    sx = torch.rand(b, generator=gen, device="cuda") * 0.01 + 1e-4
    sw = torch.rand(3, 3, n, generator=gen, device="cuda") * 0.01 + 1e-4
    bias = torch.randn(n, generator=gen, device="cuda") * 0.1
    slope = 0.01

    def kernel():
        return cuda_int8.int8_conv3x3(xq, sx, wq, sw, bias, slope)

    def composition():
        xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
        rows = sx[:, None, None].expand(b, h, w).contiguous()
        acc = None
        for dy in range(3):
            for dx in range(3):
                tap = cuda_int8.int8_mm(xp[:, dy:dy + h, dx:dx + w], wq[dy, dx], rows,
                                        sw[dy, dx])
                acc = tap if acc is None else acc.add_(tap)
        return F.leaky_relu(acc + bias, slope)

    got = kernel()
    want = cuda_int8.int8_conv3x3_plain(xq, sx, wq, sw, bias, slope)
    comp = composition()
    torch.cuda.synchronize()
    r = dict(mism=int((got != want).sum().item()), err=(got - want).abs().max().item(),
             comp_mism=int((comp != got).sum().item()), negative=(got < 0).float().mean()
             .item())
    reps = 10 if b * h * w > 4096 else 50
    ms, comp_ms = [], []
    for fn, dst in ((kernel, ms), (composition, comp_ms), (composition, comp_ms),
                    (kernel, ms)):
        dst.append(cuda_ms(fn, reps=reps))
    r.update(ms=min(ms), ms_turns=ms, comp_ms=min(comp_ms), comp_turns=comp_ms,
             plain_ms=cuda_ms(lambda: cuda_int8.int8_conv3x3_plain(xq, sx, wq, sw, bias,
                                                                   slope), reps=1, warmup=0))
    m = b * h * w
    r["bare_ms"] = None
    if n % 8 == 0 and c % 8 == 0 and m > 16:
        xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
        cols = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                         dim=-1).reshape(m, 9 * c)
        wt = wq.permute(2, 0, 1, 3).reshape(n, 9 * c).t()
        r["bare_ms"] = cuda_ms(lambda: torch._int_mm(cols, wt))
        del cols
    ops = 2.0 * m * n * 9 * c
    nbytes = m * c + 9 * n * c + 4 * (b + 9 * n + n) + 4 * m * n
    r["bound"] = bound(ops, nbytes, PEAK_INT8_OPS)
    return r


def nms_inputs(torch, seed: int, b: int = 4, n: int = 2000):
    """Dense overlapping boxes with planted ties: identical boxes with tied scores, and
    pairs at IoU exactly 0.5 (kept: the rule is strict); 10% invalid."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0.2, 0.5, (b, n, 2))
    wh = rng.uniform(0.02, 0.15, (b, n, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0.3, 1.0, (b, n)).astype(np.float32)
    s = min(50, n // 6)  # the planted runs' length: 50 from n = 300 on
    boxes[:, 2 * s:3 * s] = boxes[:, s:2 * s]  # identical boxes ...
    scores[:, 2 * s:3 * s] = scores[:, s:2 * s]  # ... with tied scores
    boxes[:, 4 * s:5 * s] = np.array([0.0, 0.0, 0.5, 0.25], np.float32)  # area 1/8
    boxes[:, 5 * s:6 * s] = np.array([0.0, 0.0, 0.25, 0.25], np.float32)  # IoU 0.5 with it
    valid = rng.uniform(size=(b, n)) > 0.1
    return (torch.as_tensor(boxes), torch.as_tensor(scores), torch.as_tensor(valid))


def nms_sorted(torch, boxes, scores, valid):
    """The order ``ops/nms.py`` sorts by (descending score, invalid last, ties by index),
    and the sorted boxes and valid flags."""
    order = torch.sort(torch.where(valid, scores, torch.full_like(scores, -math.inf)),
                       dim=1, descending=True, stable=True).indices
    return (order, torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
            torch.gather(valid, 1, order))


#: the NMS kernel's other inputs, name -> (images, boxes, how they are made): a ragged
#: batch, the word edges, a count past the sequential kernel's shared-memory cap (9000),
#: an all-invalid batch, identical boxes with tied scores (the first suppresses all), and
#: a chain of boxes sliding by 0.3 of their width (greedy keeps every other box, and the
#: scan's fixed point runs out of passes in every block)
NMS_CASES = (("2x2001", 2, 2001, "random"), ("1x63", 1, 63, "random"),
             ("1x65", 1, 65, "random"), ("1x12000", 1, 12000, "random"),
             ("4x2000 all invalid", 4, 2000, "invalid"),
             ("1x2000 identical", 1, 2000, "identical"), ("1x2000 chain", 1, 2000, "chain"))


def nms_sequential(torch, _build, sb, sv, thr: float):
    """The sequential kernel the bitmask design replaced (``tmr_nms_sequential``), called
    as the port called it before: int32 valid and keep flags, converted each call."""
    valid_i = sv.to(torch.int32).contiguous()
    keep = torch.empty_like(valid_i)
    rc = _build.lib("nms").tmr_nms_sequential(sb.data_ptr(), valid_i.data_ptr(),
                                              keep.data_ptr(), sb.shape[0], sb.shape[1],
                                              thr, _build.stream_of(sb))
    if rc:
        fail(f"tmr_nms_sequential: CUDA error {rc} at launch")
    return keep.bool()


def nms_bounds(b: int, n: int, keep) -> tuple:
    """The function's bound (one ~12-flop IoU per (kept i, later j) pair that this data
    needs; boxes and valid flags in, keep flags out) and the design's (every pair j > i of
    each image, and the bitmask written and read once)."""
    keep = keep.cpu().numpy()
    pairs = sum(int((n - 1 - keep_i.nonzero()[0]).sum()) for keep_i in keep)
    nbytes = b * n * (16 + 1 + 1)  # the boxes, the valid and keep flags (one byte each)
    mask_bytes = 2 * b * n * ((n + 63) // 64) * 8
    return (bound(12.0 * pairs, nbytes, PEAK_F32_FLOPS),
            bound(12.0 * b * n * (n - 1) / 2, nbytes + mask_bytes, PEAK_F32_FLOPS))


def check_nms(torch, cuda_nms, _build, thr: float, seed: int) -> dict:
    """The NMS kernel vs its plain version (on the card, and on the CPU) on 4 x 2000
    boxes: keep masks equal; timed in turns with the sequential kernel it replaced (whose
    masks must be equal too), its two launches split by the profiler."""
    boxes, scores, valid = nms_inputs(torch, seed)
    _, sb, sv = (t.cuda() for t in nms_sorted(torch, boxes, scores, valid))
    got = cuda_nms.greedy_keep_sorted(sb, sv, thr)
    want = cuda_nms.greedy_keep_sorted_plain(sb, sv, thr)
    want_cpu = cuda_nms.greedy_keep_sorted_plain(sb.cpu(), sv.cpu(), thr)
    old = nms_sequential(torch, _build, sb, sv, thr)
    torch.cuda.synchronize()
    r = dict(mism=int((got != want).sum().item()) + int((got.cpu() != want_cpu).sum().item()),
             old_mism=int((old != want).sum().item()), kept=int(want_cpu.sum()))
    kernel = lambda: cuda_nms.greedy_keep_sorted(sb, sv, thr)  # noqa: E731
    sequential = lambda: nms_sequential(torch, _build, sb, sv, thr)  # noqa: E731
    ms, old_ms = [], []
    for fn, dst in ((kernel, ms), (sequential, old_ms), (sequential, old_ms), (kernel, ms)):
        dst.append(cuda_ms(fn))
    r.update(ms=min(ms), ms_turns=ms, old_ms=min(old_ms), old_turns=old_ms)
    r["plain_ms"] = cuda_ms(lambda: cuda_nms.greedy_keep_sorted_plain(sb, sv, thr), reps=1,
                            warmup=0)
    phases = {}
    for name, kernel_ms in profiled_kernels_ms(torch, kernel).items():
        key = next((k for k in ("nms_mask_kernel", "nms_scan_kernel") if k in name),
                   "other")
        phases[key] = phases.get(key, 0.0) + kernel_ms
    r["phases"] = phases
    r["bound"], r["design_bound"] = nms_bounds(*sb.shape[:2], want)
    return r


def check_nms_cases(torch, cuda_nms, thr: float, seed: int) -> None:
    """The NMS kernel vs its plain version on the card on :data:`NMS_CASES`: 0
    mismatches."""
    for name, b, n, kind in NMS_CASES:
        boxes, scores, valid = nms_inputs(torch, seed, b, n)
        if kind == "invalid":
            valid = torch.zeros_like(valid)
        elif kind == "identical":
            boxes[:] = torch.tensor([0.1, 0.2, 0.4, 0.6])
            scores[:] = 0.5
            valid[:] = True
        elif kind == "chain":
            x = torch.arange(n, dtype=torch.float64)[None, :, None] * 0.3
            boxes = torch.cat([x, torch.zeros_like(x), x + 1.0, torch.ones_like(x)],
                              -1).float().expand(b, -1, -1).contiguous()
            scores = torch.linspace(1.0, 0.5, n).expand(b, -1).contiguous()
            valid[:] = True
        _, sb, sv = (t.cuda() for t in nms_sorted(torch, boxes, scores, valid))
        got = cuda_nms.greedy_keep_sorted(sb, sv, thr)
        want = cuda_nms.greedy_keep_sorted_plain(sb, sv, thr)
        torch.cuda.synchronize()
        mism = int((got != want).sum().item())
        ms = cuda_ms(lambda: cuda_nms.greedy_keep_sorted(sb, sv, thr))
        print(f"kernel nms {name} IoU {thr}: keep mismatches {mism} (must be 0), kept "
              f"{int(want.sum())} of {int(sv.sum())} valid, kernel_ms {ms:.4f}", flush=True)
        if mism:
            fail(f"nms {name} keep masks differ from the plain version in {mism} slots")


def check_nms_unions(torch, cuda_nms, thr: float, seed: int) -> None:
    """The NMS kernel vs its plain version on the card at :data:`NMS_UNIONS`, the
    multi-exemplar path's slot counts: 0 mismatches; timed beside the plain version and
    both bounds."""
    for b, n in NMS_UNIONS:
        boxes, scores, valid = nms_inputs(torch, seed, b, n)
        _, sb, sv = (t.cuda() for t in nms_sorted(torch, boxes, scores, valid))
        got = cuda_nms.greedy_keep_sorted(sb, sv, thr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = cuda_nms.greedy_keep_sorted_plain(sb, sv, thr)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        mism = int((got != want).sum().item())
        ms = cuda_ms(lambda: cuda_nms.greedy_keep_sorted(sb, sv, thr))
        (bms, bby), (dms, dby) = nms_bounds(b, n, want)
        print(f"kernel nms union {b}x{n} IoU {thr}: keep mismatches {mism} (must be 0), "
              f"kept {int(want.sum())} of {int(sv.sum())} valid, kernel_ms {ms:.4f} "
              f"plain_ms {plain_ms:.1f} bound_ms {bms:.6f} ({bby}, the pairs this data "
              f"needs) design_bound_ms {dms:.6f} ({dby}, every pair and the bitmask), "
              f"workspace {b * n * cuda_nms.mask_words(n) * 8} bytes", flush=True)
        if mism:
            fail(f"nms union {b}x{n} keep masks differ from the plain version in {mism} "
                 f"slots")


#: ``nms_topk`` on the gallery tail's union: one row per bank entry of a rung of 16, k 3
NMS_TOPK = (16, 6000)


def check_nms_topk(torch, cuda_nms, thr: float, seed: int) -> None:
    """``ops/nms.nms_topk`` on the card (kernel 6, then a stable sort) against the same
    function through the plain version of the keep mask on the same tensors, at
    :data:`NMS_TOPK`, with tied scores (``nms_inputs``'s identical boxes and rounded
    scores): count, index, boxes and scores equal bit for bit."""
    from tmr_tpu_torch.ops import nms as nms_mod
    from tmr_tpu_torch.ops.nms import nms_topk

    b, n = NMS_TOPK
    boxes, scores, valid = nms_inputs(torch, seed, b, n)
    scores = (scores * 64).round() / 64  # many ties across slots
    boxes, scores, valid = boxes.cuda(), scores.cuda(), valid.cuda()
    got = nms_topk(boxes, scores, thr, valid, k=n // 2)
    with swapped(nms_mod, "greedy_keep_sorted", cuda_nms.greedy_keep_sorted_plain):
        want = nms_topk(boxes, scores, thr, valid, k=n // 2)
    same = {f: torch.equal(got[f], want[f]) for f in ("count", "index", "boxes", "scores")}
    ms = cuda_ms(lambda: nms_topk(boxes, scores, thr, valid, k=n // 2))
    print(f"kernel nms_topk {b}x{n} k {n // 2} IoU {thr}, tied scores: equal to the plain "
          f"version {json.dumps(same)}; counts {want['count'].tolist()}; ms {ms:.4f} "
          f"(kernel 6 and the sorts)", flush=True)
    if not all(same.values()):
        fail(f"nms_topk differs from its plain version: {same}")


def synthetic_batch(np, rng, side_px: int, b: int = 4, size: int = 1024, k: int = 1):
    """Dark noisy images with bright squares of ``side_px``; exemplars = the first k
    squares (the draws do not depend on k)."""
    imgs = rng.normal(-1.0, 0.1, (b, size, size, 3)).astype(np.float32)
    exemplars = np.zeros((b, k, 4), np.float32)
    cells = (size - side_px) // 8
    for i in range(b):
        for j in range(6):
            y, x = (rng.integers(0, cells, 2) * 8).tolist()
            imgs[i, y:y + side_px, x:x + side_px] = 2.0
            if j < k:
                exemplars[i, j] = [x / size, y / size, (x + side_px) / size,
                                   (y + side_px) / size]
    return imgs, exemplars


def pad_exemplar_rows(ex, k_real):
    """(B, k, 4) exemplars with rows past each image's k_real set to its last real row,
    as ``predict_multi_exemplar`` pads them."""
    out = ex.copy()
    for i, k in enumerate(k_real):
        out[i, k:] = ex[i, k - 1]
    return out


def profile_batch(torch, run, path: str, what: str = "one batch of 4, bucket 33") -> None:
    """torch.profiler over one batch, ``run()``: device time by kernel name (the top 25 and
    the NMS kernels) and the device's busy share of the batch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    print(f"profile {path} ({what}): wall {wall_ms:.1f} ms, device kernel "
          f"time {busy_ms:.1f} ms, busy share {busy_ms / wall_ms:.3f}", flush=True)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the top 25, and the NMS kernels wherever they rank
    for rank, (name, (ms, count)) in enumerate(ranked):
        if rank < 25 or "nms_" in name:
            print(f"profile  {ms:9.3f} ms  x{count:<5d} {name[:110]}", flush=True)


def check_kernels(torch, F, cuda_attn, cuda_xcorr, cuda_nms, cuda_int8,
                  thr: float) -> dict:
    """Each kernel at the main path's shapes against its plain version; returns the
    kernels line's entries (all but the launch counts)."""
    from tmr_tpu_torch.ops import _build

    entries = {}
    for name, windowed, has_bias, grid, d in (
            ("global_attn", False, True, (64, 64), 64),
            ("global_attn_nobias", False, False, (64, 64), 64),
            ("window_attn", True, True, (14, 14), 64),
            ("global_attn_d80", False, True, (64, 64), 80),
            ("global_attn_nobias_d80", False, False, (64, 64), 80),
            ("window_attn_d80", True, True, (14, 14), 80)):
        acc, t, (bms, bby) = check_attention(torch, F, cuda_attn, windowed, has_bias, SEED,
                                             grid, d=d)
        print(f"kernel {name}: {attn_accuracy(acc)} {attn_times(t)} bound_ms {bms:.4f} "
              f"({bby})", flush=True)
        if not acc["ok"]:
            fail(f"{name} disagrees with its plain version: {acc}")
        entries[name] = dict(max_abs_err=acc["max_abs_err"], ms=t["ms"],
                             plain_ms=t["plain_ms"], bound_ms=bms, bound_by=bby,
                             library_ms=t["lib_ms"])
    entries.update(check_attention_f32(torch, F, cuda_attn, _build))
    check_global_grids(torch, F, cuda_attn)
    check_global_grids(torch, F, cuda_attn, 80, GLOBAL_GRIDS_D80)
    # the windowed kernel at 7x7 windows (at head dim 64 8-slot key rows, a pad key row, 64
    # query rows; at 80 the 224-slot wgmma kernel, half its slots pad) and 16x16 (full
    # 16-slot key rows; at 80 the 256-slot wgmma kernel), at both head dims; at 80 also the
    # persistent loop's tails (BH 7: fewer window-heads than SMs; 133: one SM takes two)
    # and two windows that keep window_attn_kernel<80, ntw> (20x12: over 16 rows; 4x32)
    for d, grid, bh in WINDOW_GRIDS:
        acc, t, (bms, _) = check_attention(torch, F, cuda_attn, True, True, SEED, grid, bh,
                                           d=d)
        what = (f"window_attn{'' if d == 64 else f'_d{d}'} {grid[0]}x{grid[1]} windows, "
                f"BH={bh or 4 * VIT_HEADS[d] * 25} ({cuda_attn.window_kernel(*grid, d)})")
        print(f"kernel {what}: {attn_accuracy(acc)} {attn_times(t)} bound_ms {bms:.4f}",
              flush=True)
        if not acc["ok"]:
            fail(f"{what} disagrees with its plain version: {acc}")
    # -Xptxas -v of every attention instantiation <D, BK, bias, GW>: registers and spills
    log = _build.LOGS.get("attn")
    for d in (64, 80):
        for bias, gw, tiles in ((1, 64, 128), (1, 96, 96), (1, 0, 64), (0, 0, 64)):
            inst = f"global_attn_kernelILi{d}ELi{tiles}ELb{bias}ELi{gw}E"
            print(f"ptxas global_attn_kernel<{d}, {tiles}, {bool(bias)}, {gw}>: "
                  f"{ptxas_info(log, inst)}", flush=True)
        for ntw in (1, 2, 4, 8):
            print(f"ptxas window_attn_kernel<{d}, {ntw}>: "
                  f"{ptxas_info(log, f'window_attn_kernelILi{d}ELi{ntw}E')}", flush=True)
    for slots, gwp in WG_INSTANCES:
        print(f"ptxas window_attn_kernel_wg<{slots}, {gwp}>: "
              f"{ptxas_info(log, f'window_attn_kernel_wgILi{slots}ELi{gwp}E')}", flush=True)
    for t in XCORR_TS:
        r = check_xcorr(torch, F, cuda_xcorr, t, SEED)
        (bms, bby), (f32ms, f32by) = r["tensor_bound"], r["f32_bound"]
        print(f"kernel xcorr T={t}: max_err {r['err']:.3e} tol {r['tol']:.3e} kernel_ms "
              f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms {r['lib_ms']:.4f} "
              f"(grouped F.conv2d) bound_ms {bms:.4f} ({bby}, 3xTF32 at the TF32 peak) "
              f"f32_bound_ms {f32ms:.4f} ({f32by}, f32 CUDA cores)", flush=True)
        if not r["err"] <= r["tol"]:
            fail(f"xcorr T={t} disagrees with its plain version: {r['err']} > {r['tol']}")
        if t == 33:
            entries["xcorr"] = dict(max_abs_err=r["err"], ms=r["ms"],
                                    plain_ms=r["plain_ms"], bound_ms=bms, bound_by=bby,
                                    library_ms=r["lib_ms"])
    check_xcorr_maps(torch, F, cuda_xcorr)
    entries.update(check_1536(torch, F, cuda_attn, cuda_xcorr))
    check_xcorr_64(torch, F, cuda_xcorr)
    print(f"ptxas nms_mask_kernel: {ptxas_info(_build.LOGS.get('nms'), 'nms_mask_kernel')}",
          flush=True)
    print(f"ptxas nms_scan_kernel: {ptxas_info(_build.LOGS.get('nms'), 'nms_scan_kernel')}",
          flush=True)
    for nms_thr in (thr, 0.15):
        r = check_nms(torch, cuda_nms, _build, nms_thr, SEED)
        (bms, bby), (dms, dby) = r["bound"], r["design_bound"]
        turns = lambda v: " ".join(f"{x:.4f}" for x in v)  # noqa: E731
        phases = ", ".join(f"{k} {v:.4f}" for k, v in r["phases"].items()) or "not measured"
        print(f"kernel nms 4x2000 IoU {nms_thr}: keep mismatches {r['mism']} (must be 0), "
              f"kept {r['kept']} of 4x2000, kernel_ms {r['ms']:.4f} (turns "
              f"{turns(r['ms_turns'])}; 2 launches, device ms per call by the profiler: "
              f"{phases}) replaced sequential kernel_ms {r['old_ms']:.4f} (turns "
              f"{turns(r['old_turns'])}; {r['old_mism']} mismatches; "
              f"{r['old_ms'] / r['ms']:.1f}x the kernel's) plain_ms "
              f"{r['plain_ms']:.4f} library_ms null bound_ms {bms:.6f} ({bby}, the pairs "
              f"this data needs) design_bound_ms {dms:.6f} ({dby}, every pair and the "
              f"bitmask)", flush=True)
        if r["mism"] or r["old_mism"]:
            fail(f"nms keep masks differ from the plain version in {r['mism']} slots and "
                 f"the sequential kernel's in {r['old_mism']}")
        if nms_thr == thr:
            entries["nms"] = dict(max_abs_err=0.0, ms=r["ms"], plain_ms=r["plain_ms"],
                                  bound_ms=bms, bound_by=bby, library_ms=None)
    check_nms_cases(torch, cuda_nms, thr, SEED)
    check_nms_unions(torch, cuda_nms, thr, SEED)
    check_nms_topk(torch, cuda_nms, thr, SEED)
    for kb in (1, 2, 3):
        for k16 in (0, 1):
            info = ptxas_info(_build.LOGS.get("xcorr"), f"xcorr_int8_kernelILi{kb}ELb{k16}E")
            print(f"ptxas xcorr_int8_kernel<{kb}, {bool(k16)}>: {info}", flush=True)
    # the products are tensor-core s8 MMAs: IMMA in the SASS of every instantiation
    imma = sass_opcodes(_build._lib_path("xcorr"), "xcorr_int8_kernel", "IMMA")
    if imma is None:
        print("sass xcorr_int8_kernel: cuobjdump not found, IMMA not counted", flush=True)
    else:
        print(f"sass xcorr_int8_kernel IMMA per instantiation: "
              f"{json.dumps(sorted(imma.values()))}", flush=True)
        if len(imma) != 6 or not all(imma.values()):
            fail(f"xcorr_int8_kernel: expected IMMA in all 6 instantiations, got {imma}")
    for t in XCORR_TS:
        r = check_xcorr_int8(torch, F, cuda_xcorr, _build, t, SEED)
        (bms, bby), (band_ms, band_by) = r["bound"], r["band_bound"]
        turns = lambda v: " ".join(f"{x:.4f}" for x in v)  # noqa: E731
        print(f"kernel xcorr_int8 T={t}: mismatches {r['mism']} (must be 0), max_err "
              f"{r['err']:.3e} kernel_ms {r['ms']:.4f} (turns {turns(r['ms_turns'])}) "
              f"replaced CUDA-core kernel_ms {r['old_ms']:.4f} (turns "
              f"{turns(r['old_turns'])}; {r['old_mism']} mismatches; "
              f"{r['old_ms'] / r['ms']:.1f}x the kernel's) plain_ms "
              f"{r['plain_ms']:.4f} library_ms {r['lib_ms']:.4f} (float64 grouped F.conv2d "
              f"+ scales, {r['lib_mism']} mismatches) bound_ms {bms:.4f} ({bby}, int8 peak) "
              f"band_bound_ms {band_ms:.4f} ({band_by}, the band's performed products)",
              flush=True)
        if r["mism"] or r["old_mism"]:
            fail(f"xcorr_int8 T={t} differs from its plain version in {r['mism']} outputs "
                 f"and from the replaced kernel in {r['old_mism']}")
        if t == 33:
            entries["xcorr_int8"] = dict(max_abs_err=r["err"], ms=r["ms"],
                                         plain_ms=r["plain_ms"], bound_ms=bms, bound_by=bby,
                                         library_ms=r["lib_ms"])
    for b, c, h, w, extreme in XCORR_INT8_MAPS:
        for t in XCORR_TS:
            r = check_xcorr_int8(torch, F, cuda_xcorr, _build, t, SEED, (b, c, h, w),
                                 extreme, False)
            what = f"xcorr_int8 {b}x{c}x{h}x{w}{' -128/-127/127 only' if extreme else ''} T={t}"
            print(f"kernel {what}: mismatches {r['mism']} (must be 0), max_err "
                  f"{r['err']:.3e} kernel_ms {r['ms']:.4f}", flush=True)
            if r["mism"]:
                fail(f"{what} differs from its plain version in {r['mism']} outputs")
    r = check_xcorr_int8(torch, F, cuda_xcorr, _build, 33, SEED, XCORR_INT8_MULTI,
                         yardsticks=False)
    shape = "x".join(map(str, XCORR_INT8_MULTI))
    print(f"kernel xcorr_int8 {shape} (the multi path's rows) T=33: mismatches {r['mism']} (must be 0), kernel_ms {r['ms']:.4f}", flush=True)
    if r["mism"]:
        fail(f"xcorr_int8 at the multi path's rows differs in {r['mism']} outputs")
    for kind in ("tap", "head", "head12", "ragged"):
        (m, n, k), mism, err, ms, plain_ms, lib_ms, bare_ms, (bms, bby) = check_int8_mm(
            torch, cuda_int8, kind, SEED)
        lib, bare = ("null" if v is None else f"{v:.4f}" for v in (lib_ms, bare_ms))
        print(f"kernel int8_mm {kind} M={m} N={n} K={k}: mismatches {mism} (must be 0), "
              f"max_err {err:.3e} kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {lib} (torch._int_mm x scales{', N padded to 8' if n % 8 else ''}"
              f"; bare _int_mm {bare}) "
              f"bound_ms {bms:.4f} ({bby})", flush=True)
        if mism:
            fail(f"int8_mm {kind} differs from its plain version in {mism} outputs")
        if kind == "head":  # the int8 path's one launch of it per batch
            entries["int8_mm"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bms, bound_by=bby, library_ms=lib_ms)
    print(f"ptxas int8_conv3x3_kernel: {ptxas_info(_build.LOGS.get('int8_mm'), 'int8_conv')}",
          flush=True)
    for shape in INT8_CONV_SHAPES:
        r = check_int8_conv(torch, F, cuda_int8, shape, SEED)
        (bms, bby), bare = r["bound"], r["bare_ms"]
        turns = lambda v: " ".join(f"{x:.4f}" for x in v)  # noqa: E731
        print(f"kernel int8_conv3x3 {'x'.join(map(str, shape[:4]))} -> {shape[4]}: "
              f"mismatches {r['mism']} (must be 0), max_err {r['err']:.3e}, negative share "
              f"{r['negative']:.3f}; kernel_ms {r['ms']:.4f} (turns {turns(r['ms_turns'])}) "
              f"replaced composition_ms {r['comp_ms']:.4f} (turns {turns(r['comp_turns'])}; "
              f"9 int8_mm + f32 adds + bias + leaky_relu, {r['comp_mism']} mismatches) "
              f"plain_ms {r['plain_ms']:.4f} bare _int_mm over the im2col'd product "
              f"{'null' if bare is None else f'{bare:.4f}'} (not the same function: no "
              f"per-tap scales) bound_ms {bms:.4f} ({bby}, int8 peak)", flush=True)
        if r["mism"] or r["comp_mism"]:
            fail(f"int8_conv3x3 at {shape} differs from its plain version in {r['mism']} "
                 f"outputs and from the composition in {r['comp_mism']}")
        if shape == INT8_CONV_SHAPES[0]:
            entries["int8_conv"] = dict(max_abs_err=r["err"], ms=r["ms"],
                                        plain_ms=r["plain_ms"], bound_ms=bms, bound_by=bby,
                                        library_ms=None)
    return entries


def profiled_kernels_ms(torch, fn, reps: int = 20) -> dict:
    """Device time per call of ``fn`` by kernel name from torch.profiler's kernel records
    (empty when the profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return {k: v for k, v in by_name.items() if v > 0}


def profiled_device_ms(torch, fn, reps: int = 20):
    """Device time per call of ``fn`` from torch.profiler's kernel records, or None when
    the profiler records no device time."""
    return sum(profiled_kernels_ms(torch, fn, reps).values()) or None


def host_us(torch, fn, reps: int = 200) -> float:
    """Host time per call of ``fn`` (its enqueue: no synchronize inside the window)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def run_probe(torch, probe, _build) -> dict:
    """The toolchain probe: add1 on a 256^2 f32 block, the first kernel of the run. Its
    event-bracketed time (10 launches back to back) is printed beside its device time
    from the profiler and the host's cost per launch, its own and torch.add's, so the
    gap to torch.add reads as host or device time."""
    _build.reset_launches()
    x = torch.zeros(256, 256, device="cuda")
    y = probe.add1(x)
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["add1"]
    mism = int((y != probe.add1_plain(x)).sum().item())
    if mism or launches != 1:
        fail(f"add1 probe: {mism} mismatches, {launches} launches")
    ms = cuda_ms(lambda: probe.add1(x))
    plain_ms = cuda_ms(lambda: probe.add1_plain(x))
    lib_ms = cuda_ms(lambda: torch.add(x, 1.0))
    out = torch.empty_like(x)
    args = (x.data_ptr(), out.data_ptr(), x.numel(), _build.stream_of(x))

    def unbound():  # each launch looks its C function up again, under lib()'s lock
        _build._FNS.clear()
        probe.add1(x)

    # host cost per call, in turns over 3 rounds (median): the wrapper (through the
    # registered op tmr::add1 and the dispatcher), the wrapper with the lookup of the C
    # function each launch, the op's CUDA kernel called bare (no dispatch), torch.add, and
    # the kernel's parts
    calls = {"wrapper": lambda: probe.add1(x), "wrapper_lookup_each": unbound,
             "op_kernel_bare": lambda: probe._add1_cuda(x),
             "torch_add": lambda: torch.add(x, 1.0),
             "stream_lookup": lambda: _build.stream_of(x),
             "empty_like": lambda: torch.empty_like(x),
             "c_call": lambda: _build.launch("add1", "probe", "tmr_add1", *args)}
    rounds = {name: [] for name in calls}
    for _ in range(3):
        for name, fn in calls.items():
            rounds[name].append(host_us(torch, fn))
    host = {name: sorted(v)[1] for name, v in rounds.items()}
    dev, lib_dev = (profiled_device_ms(torch, fn)
                    for fn in (lambda: probe.add1(x), lambda: torch.add(x, 1.0)))
    bms, bby = bound(float(x.numel()), 2.0 * x.numel() * 4, PEAK_F32_FLOPS)
    dev_s, lib_dev_s = ("not measured" if v is None else f"{v:.4f}" for v in (dev, lib_dev))
    print(f"probe add1 256x256: mismatches 0, kernel_ms {ms:.4f} (events, 10 launches back "
          f"to back) device_ms {dev_s} (profiler) plain_ms {plain_ms:.4f} library_ms "
          f"{lib_ms:.4f} (torch.add; device_ms {lib_dev_s}) bound_ms {bms:.6f} ({bby})",
          flush=True)
    print("probe host_us per call (median of 3 rounds in turns): "
          + ", ".join(f"{name} {us:.2f}" for name, us in host.items()), flush=True)
    print(f"probe: the op dispatch (wrapper through tmr::add1 less the bare CUDA kernel) "
          f"{host['wrapper'] - host['op_kernel_bare']:.2f} us per call; the bare launch "
          f"(c_call) {host['c_call']:.2f} us", flush=True)
    return dict(launches=launches, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=bby, library_ms=lib_ms)


def check_main_path_nms(torch, run, cuda_nms, name: str = "main path batch 0") -> dict:
    """A batch once more through a path, ``run()``, its detections caught on their way
    into ``batched_nms``: the keep mask the kernel gave must equal the plain version's on
    the card on the same detections. Returns the path's output."""
    from tmr_tpu_torch import inference

    with call_count(inference, "batched_nms") as calls:
        out = run()
    (dets, thr), _ = calls[0]
    order, sb, sv = nms_sorted(torch, dets["boxes"].float(), dets["scores"], dets["valid"])
    keep = torch.zeros_like(sv).scatter(
        1, order, cuda_nms.greedy_keep_sorted_plain(sb, sv, thr))
    want = dets["valid"] & keep
    mism = int((out["valid"] != want).sum().item())
    print(f"{name} NMS, {tuple(sv.shape)} slots at IoU {thr}: valid "
          f"{sv.sum(1).tolist()}, kept {want.sum(1).tolist()}, keep mismatches vs the "
          f"plain version {mism} (must be 0)", flush=True)
    if mism:
        fail(f"the {name}'s NMS differs from the plain version in {mism} slots")
    return out


def run_batches(torch, pred, batches, detections_to_numpy, _build):
    """One warm-up batch, then the launch counts reset and the batches timed."""
    pred(*batches[0])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    _build.reset_launches()
    times, outs = [], []
    for imgs, ex in batches:
        t0 = time.perf_counter()
        dets = pred(imgs, ex)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(detections_to_numpy(dets))
    return times, outs, dict(_build.LAUNCHES)


def report_batches(np, name, caps, times, outs, card):
    for i, per_img in enumerate(outs):
        counts = [len(d["boxes"]) for d in per_img]
        print(f"{name} batch {i} (bucket {caps[i]}): detections per image {counts}, "
              f"{times[i]:.1f} ms, {4e3 / times[i]:.2f} img/s [{card}]", flush=True)
        for d in per_img:
            if not (np.isfinite(d["boxes"]).all() and np.isfinite(d["scores"]).all()):
                fail(f"{name}: non-finite detections")
    print(f"{name}: {sum(times) / len(times):.1f} ms per batch of 4 "
          f"(mean of 3), {4e3 * len(times) / sum(times):.2f} img/s, "
          f"steady (batches 1-2) {sum(times[1:]) / 2:.1f} ms [{card}]", flush=True)


def int8_tier(torch, np, fused_heads, h: int = 128, c: int = 1024) -> float:
    """The output tier of the int8 arm as ``tmr_tpu/ops/quant.py`` quant_int8dot_ok
    defines it, at the production geometry: the stored-int8 tail with the int8 kernels
    vs the exact fused tail, max abs error over both maps / their max."""
    from tmr_tpu_torch.ops.quant import quantize_conv

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, h, h, c)).astype(np.float32))
    x = x.cuda().bfloat16()

    def kernel(*shape):  # HWIO draws, as the JAX tier makes them, then OIHW
        w = (rng.standard_normal(shape) * 0.01).astype(np.float32)
        return torch.from_numpy(w).permute(3, 2, 0, 1).contiguous().cuda()

    wo, wb, w1, w4 = kernel(3, 3, c, c), kernel(3, 3, c, c), kernel(1, 1, c, 1), kernel(
        1, 1, c, 4)
    exact, stored = [], []
    for w, n in zip((wo, wb, w1, w4), (c, c, 1, 4)):
        bias = torch.zeros(n, device="cuda")
        q, scale = quantize_conv(w)
        exact.append((w, bias))
        stored.append((q, bias, scale))
    with torch.inference_mode():
        oe, re = fused_heads.fused_decoder_heads(x, [exact[0]], [exact[1]], exact[2],
                                                 exact[3], dtype=torch.bfloat16)
        oq, rq = fused_heads.fused_decoder_heads(x, [stored[0]], [stored[1]], stored[2],
                                                 stored[3], dtype=torch.bfloat16,
                                                 quant="stored", kernel_arm="int8")
    scale = max(oe.abs().max().item(), re.abs().max().item())
    return max((oq - oe).abs().max().item(), (rq - re).abs().max().item()) / scale


def int8_arm_on_fcat(torch, pred, qpred, f_cat, fused_heads) -> None:
    """The int8 arm on image 0 of this run's ``f_cat``: the statistics of each half (the
    per-image int8 step is amax / 127), and the int8 tail vs the exact fused tail of
    phase 4's f32 weights, on the objectness map alone and over both maps (the tier's
    measure). Printed, not held to a limit: the JAX function reads the same on such
    inputs (tests/test_torch_quant.py)."""
    x = f_cat[:1].permute(0, 2, 3, 1)
    xf = x.float()
    half = xf.shape[-1] // 2
    for name, v in (("projection", xf[..., :half]), ("matcher", xf[..., half:])):
        sd = v.std(dim=(0, 1, 2))
        print(f"f_cat image 0, {name} half: amax {v.abs().max().item():.3f}, amax/std "
              f"{(v.abs().max() / v.std()).item():.2f}, channel offsets rms "
              f"{v.mean(dim=(0, 1, 2)).pow(2).mean().sqrt().item():.3f}, spatial std per "
              f"channel mean {sd.mean().item():.3f} max {sd.max().item():.3f}", flush=True)
    with torch.inference_mode():
        oe, re = fused_heads.fused_decoder_heads(x, *pred.model._tail_params(),
                                                 dtype=pred.model.compute_dtype)
        q = qpred.model.heads(f_cat[:1])
    d_obj = (q["objectness"] - oe[..., 0]).abs().max().item()
    d_reg = (q["regressions"] - re).abs().max().item()
    obj_max = oe.abs().max().item()
    both = max(d_obj, d_reg) / max(obj_max, re.abs().max().item())
    print(f"int8 tail vs the exact fused tail on that f_cat, same weights: objectness map "
          f"{d_obj / obj_max:.4f} of its max, both maps {both:.4f} (the tier's measure)",
          flush=True)


def check_quant_path(torch, np, pred, batches, caps, obj, reg, card, modules) -> dict:
    """Phase 4b: the int8-storage path on phase 4's weights."""
    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.inference import Predictor, detections_to_numpy

    _build, cuda_int8, fused_heads = modules
    qcfg = preset("TMR_FSCD147", quant="int8", quant_storage="int8", quant_kernel="int8")
    qpred = Predictor(qcfg, device="cuda")
    qpred.load_state_dict(pred.model.state_dict())
    stamp = qpred.quant_stamp()
    print(f"int8 storage: {stamp['quantized_leaves']} kernels, {stamp['weight_bytes']} "
          f"int8 bytes for {stamp['f32_weight_bytes']} f32 bytes", flush=True)
    times, outs, launches = run_batches(torch, qpred, batches, detections_to_numpy, _build)
    report_batches(np, "int8 path", caps, times, outs, card)
    print(f"int8 path launches over the 3 batches: {json.dumps(launches)}", flush=True)
    if launches != QUANT_LAUNCHES:
        fail(f"int8 path launches {launches}, expected {QUANT_LAUNCHES}")

    imgs, ex = batches[0]
    scale = obj.abs().max().item()
    qout = qpred.forward(imgs, ex)
    qobj = qout["objectness"][0].float().cpu()
    rel = (qobj - obj).abs().max().item() / scale
    both = max((qobj - obj).abs().max().item(),
               (qout["regressions"][0].float().cpu() - reg).abs().max().item())
    both /= max(scale, reg.abs().max().item())
    dcfg = preset("TMR_FSCD147", quant="int8", quant_storage="int8")
    dpred = Predictor(dcfg, device="cuda")
    dpred.load_state_dict(pred.model.state_dict())
    drel = (dpred.forward(imgs, ex)["objectness"][0].float().cpu() - obj).abs().max().item()
    drel /= scale
    del dpred
    print(f"objectness image 0 vs the bf16 path, max_abs_diff / map max {scale:.4e}: int8 "
          f"path {rel:.4f} (bound {INT8_PATH_OBJ_BOUND}; over both maps, the tier's "
          f"measure, {both:.4f}), stored weights with the dequant arm {drel:.4f} (tier "
          f"{QUANT_TIER_REL})", flush=True)
    if not (torch.isfinite(qobj).all() and qobj.shape == (128, 128)
            and rel <= INT8_PATH_OBJ_BOUND):
        fail("int8 path objectness map is not finite or far from the bf16 path's")
    if not drel <= QUANT_TIER_REL:
        fail("the stored-weight path's objectness is outside the output tier")
    tier = int8_tier(torch, np, fused_heads)
    print(f"int8 tail vs the exact tail on the tier's inputs (quant_int8dot_ok: 1 x 128^2 x "
          f"1024 normal bf16 input, N(0, 0.01) weights): rel {tier:.4f} (tier "
          f"{QUANT_TIER_REL})", flush=True)
    if not 0 < tier < QUANT_TIER_REL:
        fail("the int8 tail is outside the output tier at the production geometry")

    with torch.inference_mode():
        image, exemplars, cap = qpred._inputs(imgs, ex)
        f_cat = qpred.model.match(image, exemplars, cap)
        got = qpred.model.heads(f_cat)
        want = fused_heads.fused_decoder_heads(
            f_cat.permute(0, 2, 3, 1), *qpred.model._tail_params(),
            dtype=qpred.model.compute_dtype, quant="stored", kernel_arm="int8",
            int8_matmul=cuda_int8.int8_mm_plain, int8_conv=cuda_int8.int8_conv3x3_plain)
        torch.cuda.synchronize()
    tail_diff = max((got["objectness"] - want[0][..., 0]).abs().max().item(),
                    (got["regressions"] - want[1]).abs().max().item())
    print(f"int8 tail on one f_cat {tuple(f_cat.shape)}, kernels vs plain versions on the "
          f"card: max_abs_diff {tail_diff:.3e} (tol 0: exact int32 sums, the same "
          f"epilogue and tap order)", flush=True)
    if tail_diff != 0.0:
        fail(f"int8 tail with the kernels differs from the plain tail: {tail_diff}")
    with torch.inference_mode():
        x = f_cat.permute(0, 2, 3, 1)
        act = torch.randn(*x.shape[:3], 2 * x.shape[3], device="cuda")
        q_in = cuda_ms(lambda: fused_heads._quant_act(x.to(qpred.model.compute_dtype)))
        q_head = cuda_ms(lambda: fused_heads._quant_act(act))
    print(f"int8 tail's activation quantization (_quant_act) per batch: the layer's input "
          f"{tuple(x.shape)} {x.dtype} {q_in:.4f} ms, the heads' input {tuple(act.shape)} "
          f"f32 {q_head:.4f} ms", flush=True)
    int8_arm_on_fcat(torch, pred, qpred, f_cat, fused_heads)
    return launches, qpred


def max_rel(torch, got, want) -> float:
    """max |got - want| over want's max |.|, both moved to the CPU as f32."""
    got, want = got.float().cpu(), want.float().cpu()
    return (got - want).abs().max().item() / want.abs().max().item()


def lists_equal(np, a, b) -> bool:
    """Per-image detection lists equal bit for bit."""
    return len(a) == len(b) and all(
        np.array_equal(x[name], y[name]) for x, y in zip(a, b)
        for name in ("boxes", "scores", "refs"))


def check_multi_path(torch, np, pred, qpred, multi_batches, caps, phase4_ms, card,
                     modules) -> None:
    """Phase 4d: ``predict_multi_batch`` on phase 4's weights over the same images with 3
    exemplars each (k bucket 3, real rows :data:`MULTI_K_REAL`); its launches, union
    keep masks, rows against phase 4 and ``predict_multi_exemplar``, the split programs,
    the device tail, and one batch on phase 4b's int8 predictor."""
    import dataclasses

    from tmr_tpu_torch.inference import Predictor, detections_to_numpy

    _build, cuda_nms = modules
    k_real = np.array(MULTI_K_REAL, np.int32)
    size = multi_batches[0][0].shape[1]
    mcaps = [pred.pick_capacity(ex, size) for _, ex in multi_batches]
    if mcaps != caps:
        fail(f"multi path: exemplars picked buckets {mcaps}, expected {caps}")
    pred.predict_multi_batch(*multi_batches[0], k_real)  # warm-up: cuDNN plans at 12 rows
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    times, outs = [], []
    for imgs, ex in multi_batches:
        t0 = time.perf_counter()
        dets = pred.predict_multi_batch(imgs, ex, k_real)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(detections_to_numpy(dets))
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, per_img in enumerate(outs):
        counts = [len(d["boxes"]) for d in per_img]
        print(f"multi path batch {i} (bucket {caps[i]}, k_real {MULTI_K_REAL}): detections "
              f"per image {counts}, {times[i]:.1f} ms [{card}]", flush=True)
        for d in per_img:
            if not (np.isfinite(d["boxes"]).all() and np.isfinite(d["scores"]).all()):
                fail("multi path: non-finite detections")
    mean = sum(times) / len(times)
    print(f"multi path: {mean:.1f} ms per batch of 4 images x 3 exemplars (mean of 3; "
          f"steady, batches 1-2, {sum(times[1:]) / 2:.1f}) beside phase 4's "
          f"{phase4_ms:.1f} ms per batch of 4 ({mean / phase4_ms:.2f}x); peak device memory {peak_gb:.2f} "
          f"GB [{card}]", flush=True)
    print(f"multi path launches over the 3 batches: {json.dumps(launches)}", flush=True)
    if launches != MULTI_LAUNCHES:
        fail(f"multi path launches {launches}, expected {MULTI_LAUNCHES}")

    # union keep masks, row 0 against phase 4, every real row against
    # predict_multi_exemplar on its image alone
    worst0 = worst1 = 0.0
    for i, (imgs, ex) in enumerate(multi_batches):
        with call_count(Predictor, "_decode") as dec:
            out = check_main_path_nms(
                torch, lambda: pred.predict_multi_batch(imgs, ex, k_real), cuda_nms,
                f"multi path batch {i}")
        obj = dec[0][0][1]["objectness"]
        obj = obj.reshape(4, 3, *obj.shape[1:])
        ref = pred.forward(imgs, ex[:, :1])["objectness"]
        row0 = [max_rel(torch, obj[b, 0], ref[b]) for b in range(4)]
        alone, counts = [], []
        for b in range(4):
            with call_count(Predictor, "_decode") as dec1:
                one = pred.predict_multi_exemplar(imgs[b:b + 1], ex[b], k_real=k_real[b])
            one_obj = dec1[0][0][1]["objectness"]
            alone.append(max(max_rel(torch, obj[b, j], one_obj[j])
                             for j in range(k_real[b])))
            counts.append((int(one["valid"].sum()), int(out["valid"][b].sum())))
        worst0, worst1 = max(worst0, *row0), max(worst1, *alone)
        print(f"multi path batch {i}: row (b, exemplar 0) objectness vs phase 4's map for "
              f"image b, max_abs_diff / max: {' '.join(f'{v:.2e}' for v in row0)}; real "
              f"rows vs predict_multi_exemplar on image b alone: "
              f"{' '.join(f'{v:.2e}' for v in alone)} (tol {MULTI_ROW_TOL}); valid "
              f"detections alone / in the batch: {counts}", flush=True)
    if not worst0 <= MULTI_ROW_TOL or not worst1 <= MULTI_ROW_TOL:
        fail(f"multi path rows disagree: vs phase 4 {worst0:.3e}, vs "
             f"predict_multi_exemplar {worst1:.3e}, tol {MULTI_ROW_TOL}")

    # the split programs on batch 0, phase 4's exemplars
    imgs, ex = multi_batches[0]
    ex1 = ex[:, :1].copy()
    cap = pred.pick_capacity(ex1, size)
    backbone, heads = pred._get_backbone_fn(), pred._get_heads_fn(cap, size)
    feats = backbone(imgs)
    split, fused = heads(feats, ex1), pred(imgs, ex1)
    torch.cuda.synchronize()
    diff = [name for name in ("boxes", "scores", "refs", "valid")
            if not torch.equal(split[name], fused[name])]
    img_dev = torch.as_tensor(imgs, device="cuda")
    backbone_ms = cuda_ms(lambda: backbone(img_dev))
    heads_ms = cuda_ms(lambda: heads(feats, ex1))
    fused_ms = cuda_ms(lambda: pred(img_dev, ex1))
    print(f"split programs, batch 0 (features {tuple(feats.shape)} {feats.dtype}): heads "
          f"on the backbone's features vs the fused call, fields that differ bit for bit: "
          f"{diff or 'none'} (must be none); backbone {backbone_ms:.2f} ms, heads (a "
          f"feature-cache hit) {heads_ms:.2f} ms, fused {fused_ms:.2f} ms per batch of 4, "
          f"images on the card [{card}]", flush=True)
    if diff:
        fail(f"the split programs differ from the fused call in {diff}")

    # the device tail on the same model
    dpred = Predictor(dataclasses.replace(pred.cfg, decode_tail="device"), device="cuda",
                      model=pred.model)
    for name, run in (("__call__", lambda p: p(imgs, ex1)),
                      ("predict_multi_batch",
                       lambda p: p.predict_multi_batch(imgs, ex, k_real))):
        host, dev = run(pred), run(dpred)
        same = lists_equal(np, detections_to_numpy(host), detections_to_numpy(dev))
        print(f"device tail, {name} batch 0: count {dev['count'].tolist()}, per-image "
              f"lists equal to the host tail's: {same}", flush=True)
        if not same:
            fail(f"the device tail's lists differ from the host tail's ({name})")

    # one batch on the int8 path: 12 rows through the int8 kernels
    _build.reset_launches()
    check_main_path_nms(torch, lambda: qpred.predict_multi_batch(imgs, ex, k_real),
                        cuda_nms, "int8 multi path batch 0")
    qlaunches = dict(_build.LAUNCHES)
    print(f"int8 multi path launches over one batch: {json.dumps(qlaunches)}", flush=True)
    if qlaunches != MULTI_INT8_LAUNCHES:
        fail(f"int8 multi path launches {qlaunches}, expected {MULTI_INT8_LAUNCHES}")


#: phase 5's synthetic FSCD-147-layout test split: images of FSC-147's 384-px height,
#: EVAL_OBJECTS squares each, on a 64-px cell grid so none overlap; object sides of the
#: images that stay at 1024 (>= 25 px; template bucket 17 or 9 on the 128^2 map) and of
#: those the small-object rule sends to 1536 (< 25 px in both sides; bucket 9 on the
#: 192^2 map), interleaved so the loader fills a batch of 4 in each bucket
EVAL_HW = (384, 512)
EVAL_OBJECTS = 8
EVAL_SIDES = (30, 38, 12, 46, 34, 14, 42, 30, 16, 38, 46, 16)
EVAL_1536_BUCKETS = (9,)  # checked in phase 3 on 192^2 maps (XCORR_1536)
#: launches of one eval batch (4 images at eval_batch_size 4, or one image with its 3
#: exemplars at num_exemplars 3): the encoder's 4 global and 8 windowed blocks, one
#: correlation, one NMS
EVAL_LAUNCHES = {"global_attn": 4, "window_attn": 8, "xcorr": 1, "nms": 1,
                 "xcorr_int8": 0, "int8_mm": 0, "int8_conv": 0, "add1": 0,
                 "global_attn_d80": 0, "window_attn_d80": 0, **F32_ZERO}
#: the same at ``compute_dtype="float32"``: the encoder's blocks through the f32 kernels
F32_EVAL_LAUNCHES = dict(EVAL_LAUNCHES, global_attn=0, window_attn=0, global_attn_f32=4,
                         window_attn_f32=8)


def eval_split(np, root: str, sides=EVAL_SIDES, n_train: int = 0) -> dict:
    """Write phase 5's annotation files (FSCD-147 layout: the exemplar json, the split
    json and COCO instances for every split) under ``root``, an image for each object
    side in ``sides``; returns the images, by name, as (H, W, 3) uint8 arrays kept in
    memory. Every split holds every image, or with ``n_train`` the first ``n_train``
    images are the train split and the rest the val and test splits (phase 5b)."""
    import os

    rng = np.random.default_rng(SEED + 5)
    h, w = EVAL_HW
    cells = [(y, x) for y in range(0, h, 64) for x in range(0, w, 64)]
    images, annos, instances = {}, {}, []
    for i, side in enumerate(sides):
        name = f"eval{i:02d}.jpg"
        arr = rng.uniform(0, 40, (h, w, 3)).astype(np.uint8)
        boxes = []
        for c in rng.choice(len(cells), EVAL_OBJECTS, replace=False):
            y, x = (v + int(o) for v, o in zip(cells[c], rng.integers(0, 64 - side, 2)))
            arr[y:y + side, x:x + side] = 220
            boxes.append([x, y, side, side])
        images[name] = arr
        annos[name] = {"box_examples_coordinates": [
            [[x, y], [x, y + bh], [x + bw, y + bh], [x + bw, y]]
            for x, y, bw, bh in boxes[:3]]}
        instances += [{"id": len(instances) + 1, "image_id": i, "bbox": b} for b in boxes]
    os.makedirs(os.path.join(root, "annotations"))
    names = sorted(images)

    def dump(name, obj):
        with open(os.path.join(root, "annotations", name), "w") as f:
            json.dump(obj, f)

    dump("annotation_FSC147_384.json", annos)
    held_out = names[n_train:] if n_train else names
    dump("Train_Test_Val_FSC_147.json", {"train": names[:n_train] if n_train else names,
                                         "val": held_out, "test": held_out})
    for split in ("train", "val", "test"):
        dump(f"instances_{split}.json", {
            "images": [{"id": i, "file_name": n} for i, n in enumerate(names)],
            "annotations": instances})
    return images


@contextlib.contextmanager
def in_memory_images(images: dict):
    """While the block runs, the port's registry builds its FSCD-147 reader as a
    subclass whose decode step returns the image kept in memory (no image library on
    the card's machine); the annotation JSON, ``_item``, the resize, the size bucket and
    the loader are the port's own code."""
    import os

    from tmr_tpu_torch.data import datasets

    base = datasets.FSCD147Dataset

    class InMemoryFSCD147(base):
        def decode(self, img_url):
            return images[os.path.basename(img_url)]

    datasets.FSCD147Dataset = InMemoryFSCD147
    try:
        yield
    finally:
        datasets.FSCD147Dataset = base


def run_eval(torch, cfg, model, state_dict, _build, device, refiner=None):
    """``Trainer.test(params=state_dict)`` with each eval batch recorded: the batch, its
    losses and detections, its launches and its time (synchronized around the batch's
    program); ``refiner`` goes to the Trainer (phase 5d). Returns (metrics, records,
    (wall seconds of the whole eval, of its end: the COCO files merged and the metrics
    computed), the trainer)."""
    from tmr_tpu_torch.train.loop import Trainer

    records, finish_s = [], []

    class RecordingTrainer(Trainer):
        def _eval_batch(self, batch):
            torch.cuda.synchronize()
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            losses, dets = super()._eval_batch(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
            records.append(dict(batch=batch, losses=losses, dets=dets, ms=ms,
                                launches=launches))
            return losses, dets

        def _finish_eval(self, stage, sums, n):
            t0 = time.perf_counter()
            out = super()._finish_eval(stage, sums, n)
            finish_s.append(time.perf_counter() - t0)
            return out

    tr = RecordingTrainer(cfg, device=device, model=model, refiner=refiner)
    t0 = time.perf_counter()
    metrics = tr.test(params=state_dict)
    return metrics, records, (time.perf_counter() - t0, finish_s[0]), tr


def check_eval_path(torch, np, pred, card, phase4_ms, modules, profile=False) -> dict:
    """Phase 5: ``Trainer.test(params=...)`` on phase 4's weights over a synthetic
    FSCD-147-layout test split of 12 images, 8 at 1024 and 4 escalated to 1536, at
    num_exemplars 1 (eval_batch_size 4) and 3 (forced to 1), each twice: the first run
    pays the first calls at the eval's shapes (cold), the second is timed warm. With
    ``profile``, a torch.profiler breakdown of the 1536 batch's program. Then one run at
    ``compute_dtype="float32"`` (num_exemplars 1, both buckets) with the same checks and
    the f32 kernels' launches. Returns the warm runs' images/s end to end by
    num_exemplars, and the f32 run's under ``"f32"``; the global kernel's launches in
    the warm num_exemplars=1 run's 1536 batches (its 96-token-row instantiation); and the
    1536 objectness check's (run, finish) (:func:`check_1536_objectness`)."""
    import dataclasses
    import os
    import tempfile

    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.data import datasets
    from tmr_tpu_torch.inference import Predictor, detections_to_numpy
    from tmr_tpu_torch.train.loop import Trainer
    from tmr_tpu_torch.train.state import compute_losses

    _build, = modules
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        images = eval_split(np, os.path.join(tmp, "fsc"))
        base = preset("TMR_FSCD147", datapath=os.path.join(tmp, "fsc"), eval=True,
                      num_workers=4)
        state_dict = pred.model.state_dict()
        with in_memory_images(images):
            # the loader's host cost per image, decode excluded (the images are in memory)
            ds = datasets.build_dataset(base, "test")
            host = {}
            for i in range(len(ds)):
                t0 = time.perf_counter()
                item = ds[i]
                host.setdefault(item["image"].shape[0], []).append(
                    (time.perf_counter() - t0) * 1e3)
            print("eval loader host ms per image (384x512 source, decode excluded: the "
                  "images are in memory): " + ", ".join(
                      f"-> {s}: {sum(v) / len(v):.1f} ms (mean of {len(v)})"
                      for s, v in sorted(host.items())), flush=True)
            if sorted(host) != [1024, 1536] or len(host[1536]) != 4:
                fail(f"eval split: images per bucket {({k: len(v) for k, v in host.items()})}"
                     ", expected 8 at 1024 and 4 at 1536")
            for k, run in ((1, "cold"), (1, "warm"), (3, "cold"), (3, "warm")):
                cfg = dataclasses.replace(base, logpath=os.path.join(tmp, f"log{k}{run}"),
                                          num_exemplars=k, eval_batch_size=4)
                torch.cuda.reset_peak_memory_stats()
                metrics, records, wall, tr = run_eval(torch, cfg, pred.model,
                                                      state_dict, _build, pred.device)
                name = f"eval num_exemplars={k} ({run})"
                print(f"{name}: peak device memory "
                      f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]",
                      flush=True)
                rate = check_eval_run(torch, np, pred, tr, name, metrics, records, wall,
                                      phase4_ms, card, compute_losses,
                                      detections_to_numpy)
                if run == "warm":
                    rates[k] = rate
                if k == 1:  # the 1536 batch of 4, for the objectness check below
                    big = next(r["batch"] for r in records
                               if r["batch"]["image"].shape[1] == 1536)
                    launches_1536 = sum(r["launches"]["global_attn"] for r in records
                                        if r["batch"]["image"].shape[1] == 1536)
                    if profile and run == "warm":
                        profile_batch(torch, lambda: Trainer._eval_batch(tr, big),
                                      "eval 1536 bucket", "one batch of 4 with its losses, "
                                      "bucket 9")
                del records, tr
            # compute_dtype="float32" at num_exemplars 1: the f32 attention kernels in both
            # buckets (the 1536 one on 96^2 tokens); the Trainer builds its f32 model
            cfg = dataclasses.replace(base, logpath=os.path.join(tmp, "log_f32"),
                                      num_exemplars=1, eval_batch_size=4,
                                      compute_dtype="float32")
            torch.cuda.reset_peak_memory_stats()
            metrics, records, wall, tr = run_eval(torch, cfg, None, state_dict, _build,
                                                  pred.device)
            name = "eval num_exemplars=1 compute_dtype=float32"
            print(f"{name}: peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]", flush=True)
            rates["f32"] = check_eval_run(torch, np, tr.predictor, tr, name, metrics,
                                          records, wall, phase4_ms, card, compute_losses,
                                          detections_to_numpy, F32_EVAL_LAUNCHES)
            del records, tr
            torch.cuda.empty_cache()
    # the 1536 bucket's objectness against an f32 CPU run (phase 4's measure)
    return rates, launches_1536, check_1536_objectness(torch, pred, Predictor, big["image"],
                                                       big["exemplars"])


def check_eval_run(torch, np, pred, tr, name, metrics, records, wall, phase4_ms, card,
                   compute_losses, detections_to_numpy,
                   want_launches=EVAL_LAUNCHES) -> float:
    """The checks of one eval run: launches per batch, detections equal to the port
    Predictor's on the same tensors, losses equal to ``compute_losses`` on the same
    model outputs and finite, MAE/RMSE equal to those of the detection counts. Returns
    the run's images/s end to end."""
    cfg = tr.cfg
    k = cfg.num_exemplars
    print(f"{name}: metrics {json.dumps(metrics)}", flush=True)
    n_img = sum(r["batch"]["image"].shape[0] for r in records)
    wall, finish = wall
    prog = sum(r["ms"] for r in records) / 1e3
    print(f"{name}: {n_img} images in {wall:.2f} s end to end, {n_img / wall:.2f} img/s: "
          f"the programs {prog:.2f} s, the end (COCO files merged, AP and MAE/RMSE) "
          f"{finish:.2f} s, the rest (loader waits, per-image JSONs) "
          f"{wall - prog - finish:.2f} s [{card}]", flush=True)
    by_size = {}
    for r in records:
        by_size.setdefault(r["batch"]["image"].shape[1], []).append(r)
    for size, rs in sorted(by_size.items()):
        imgs = sum(r["batch"]["image"].shape[0] for r in rs)
        ms = [r["ms"] for r in rs]
        print(f"{name} bucket {size}: {imgs} images in {len(rs)} batches of "
              f"{rs[0]['batch']['image'].shape[0]}, program ms per batch "
              f"{' '.join(f'{v:.1f}' for v in ms)} (losses and detections, synchronized), "
              f"{imgs * 1e3 / sum(ms):.2f} img/s; phase 4's {phase4_ms:.1f} ms per batch "
              f"of 4 at 1024 [{card}]", flush=True)
    if sorted(by_size) != [1024, 1536]:
        fail(f"{name}: buckets {sorted(by_size)}, expected [1024, 1536]")
    counts = []
    for i, r in enumerate(records):
        batch, b = r["batch"], r["batch"]["image"].shape[0]
        if r["launches"] != want_launches:
            fail(f"{name} batch {i} ({b} x {batch['image'].shape[1]}^2): launches "
                 f"{r['launches']}, expected {want_launches}")
        extra = (batch["gt_boxes"], batch["gt_valid"])
        thr = (cfg.positive_threshold, cfg.negative_threshold)
        if k == 1:
            cap = pred.pick_capacity(batch["exemplars"], batch["image"].shape[1])
            if batch["image"].shape[1] == 1536 and cap not in EVAL_1536_BUCKETS:
                fail(f"{name}: a 1536 batch took bucket {cap}, phase 3 checks "
                     f"{EVAL_1536_BUCKETS}")
            want = pred(batch["image"], batch["exemplars"])
            out = pred.forward(batch["image"], batch["exemplars"])
            loss = compute_losses(out, {"exemplars": batch["exemplars"],
                                        "gt_boxes": extra[0], "gt_valid": extra[1]}, *thr)
        else:
            meta = batch["meta"][0]
            ex = meta["orig_exemplars"] / np.array(meta["img_size"].tolist() * 2, np.float32)
            want = pred.predict_multi_exemplar(batch["image"], ex)
            cap = pred.pick_capacity(ex, batch["image"].shape[1])
            if batch["image"].shape[1] == 1536 and cap not in EVAL_1536_BUCKETS:
                fail(f"{name}: a 1536 image took bucket {cap}, phase 3 checks "
                     f"{EVAL_1536_BUCKETS}")
            _, out, rows = pred._multi(batch["image"], ex[None], [len(ex)], cap)
            per_row = [compute_losses({n: v[j:j + 1] for n, v in out.items()},
                                      {"exemplars": rows[j:j + 1, None],
                                       "gt_boxes": extra[0], "gt_valid": extra[1]}, *thr)
                       for j in range(len(ex))]
            loss = {n: torch.stack([p[n] for p in per_row]).sum() for n in per_row[0]}
        diff = [f for f in ("boxes", "scores", "refs", "valid")
                if not torch.equal(r["dets"][f], want[f])]
        bad_loss = [n for n in loss if not (torch.equal(loss[n], r["losses"][n])
                                            and torch.isfinite(loss[n]))]
        if diff or bad_loss:
            fail(f"{name} batch {i}: detections differ from the Predictor's in {diff}, "
                 f"losses differ from compute_losses (or are not finite) in {bad_loss}")
        for meta, d in zip(batch["meta"], detections_to_numpy(r["dets"])):
            counts.append((len(meta["orig_boxes"]), max(len(d["boxes"]), 1)))
    err = np.array([g - p for g, p in counts], np.float64)
    mae, rmse = float(np.abs(err).mean()), float(np.sqrt((err ** 2).mean()))
    print(f"{name}: {len(records)} batches, launches each {json.dumps(want_launches)}, "
          f"detections equal to the Predictor's bit for bit, losses equal to "
          f"compute_losses; (GT, detections) per image {counts}; MAE {mae:.4f} RMSE "
          f"{rmse:.4f} from the counts vs {metrics['test/MAE']:.4f} "
          f"{metrics['test/RMSE']:.4f} from the COCO files", flush=True)
    if abs(mae - metrics["test/MAE"]) > 1e-9 or abs(rmse - metrics["test/RMSE"]) > 1e-9:
        fail(f"{name}: MAE/RMSE of the COCO files differ from the detection counts'")
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"{name}: non-finite metrics {metrics}")
    return n_img / wall


#: phase 5b's attention backward against ``torch.autograd.grad`` of ``attention_plain``
#: in f32 on the same card, per element of each gradient relative to that gradient's
#: largest element: dq, dk and dv within one bf16 ulp (the port rounds them to bf16, up
#: to 2^-8 of an element, and its dv takes the forward's bf16-rounded p, where the f32
#: reference rounds nothing); the tables' gradients, f32 on both sides, within 1e-4 (f32
#: sums over BH x S in another order)
BWD_TOL = 2.0 ** -7
BWD_TABLE_TOL = 1e-4
#: the backward checks at main-path shapes: (windowed, bias, head dim, grid, BH): the 4
#: global blocks and the 8 windowed blocks of a batch of 4 at 1024 (ViT-B 12 heads of 64,
#: ViT-H 16 of 80; 25 windows of 14x14 an image), the global kernel also without its bias
BWD_CASES = ((False, True, 64, (64, 64), 48), (False, False, 64, (64, 64), 48),
             (True, True, 64, (14, 14), 1200), (False, True, 80, (64, 64), 64),
             (False, False, 80, (64, 64), 64), (True, True, 80, (14, 14), 1600))
#: the same Functions at ``compute_dtype="float32"`` (the f32 kernels forward), at the
#: main paths' shapes with the bias, against the f32 autograd of ``attention_plain``: every
#: gradient within BWD_F32_TOL of its largest element (f32 on both sides, sums in another
#: order)
BWD_F32_CASES = ((False, True, 64, (64, 64), 48), (True, True, 64, (14, 14), 1200),
                 (False, True, 80, (64, 64), 64), (True, True, 80, (14, 14), 1600))
BWD_F32_TOL = 1e-4
#: phase 5b's synthetic train split: 8 train images, then 4 val images, objects of 30-46
#: px on FSC-147's 384 x 512 (all at 1024: training takes no small-object bucket)
TRAIN_SIDES = (30, 38, 46, 34, 42, 30, 38, 46, 32, 40, 44, 36)
TRAIN_IMAGES = 8
#: launches of one train step of 4 images: the encoder's 4 global and 8 windowed blocks
#: forward (the backward is PyTorch), and no correlation (the train forward's template
#: capacity is 191, the FFT route), NMS or int8 kernel
TRAIN_STEP_LAUNCHES = {"global_attn": 4, "window_attn": 8, "xcorr": 0, "nms": 0,
                       "xcorr_int8": 0, "int8_mm": 0, "int8_conv": 0, "add1": 0,
                       "global_attn_d80": 0, "window_attn_d80": 0, **F32_ZERO}
F32_TRAIN_STEP_LAUNCHES = dict(TRAIN_STEP_LAUNCHES, global_attn=0, window_attn=0,
                               global_attn_f32=4, window_attn_f32=8)
#: the gradient's global norm through the kernels against the same step with the
#: attention through ``attention_plain`` on the card, relative: both are bf16 networks
#: (12 blocks of bf16 activations; the two attentions round p at other points)
GRAD_NORM_TOL = 2e-2
#: a resumed run (2 epochs, then 1) against 3 uninterrupted epochs: ||p_R - p_U|| over
#: the head's parameters relative to ||p_U - p_0||, what the run moved them. The card's
#: atomics (the gathers' and the interpolations' backward, cuDNN's weight gradients) sum
#: in a varying order, and Adam's first updates are +-lr for any gradient above eps, so
#: a gradient near 0 can flip an element's step; the bulk must agree
RESUME_TOL = 1e-2


def check_attention_backward(torch, cuda_attn, windowed: bool, has_bias: bool, d: int,
                             grid, bh: int, seed: int, f32: bool = False) -> dict:
    """One attention Function's backward (``attention_backward``, PyTorch on the card)
    at a main-path shape against ``torch.autograd.grad`` of ``attention_plain`` in f32 on
    the same inputs: dq, dk, dv and the gradients of the compact (2g - 1, d) tables
    (through ``get_rel_pos``, as the ViT passes them), each within BWD_TOL of its
    largest element. Times the kernel forward, the backward and the f32 reference's
    backward; the bound is the backward's operations, 2.5x the forward's (the scores
    recomputed, dp, dv, dq and dk: five products of the forward's two), at the bf16
    peak, and the same at the f32 peak of the f32 products it performs. ``f32``: f32
    q, k, v and output gradient (``compute_dtype="float32"``), every gradient held to
    BWD_F32_TOL."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gh, gw = grid
    s = gh * gw
    scale = d ** -0.5
    dtype = torch.float32 if f32 else torch.bfloat16
    q, k, v, g = (torch.randn(bh, s, d, generator=gen, device="cuda").to(dtype)
                  for _ in range(4))
    tabs = [torch.randn(2 * n - 1, d, generator=gen, device="cuda") * 0.1
            for n in grid] if has_bias else []
    leaves = [t.requires_grad_() for t in (q, k, v, *tabs)]
    ref = [t.detach().float().requires_grad_() for t in leaves]

    def run(qkv, tables, plain=False):
        rel = [cuda_attn.get_rel_pos(n, n, t) for n, t in zip(grid, tables)]
        if plain:
            proj = cuda_attn.bias_projections(qkv[0], *rel, grid) if rel else (None, None)
            return cuda_attn.attention_plain(*qkv, *proj, grid, scale)
        if windowed:
            return cuda_attn.window_attention(*qkv, *rel, grid, scale)
        return cuda_attn.global_attention(*qkv, *(tables or (None, None)), grid, scale)

    out = run(leaves[:3], leaves[3:])
    got = torch.autograd.grad(out, leaves, g, retain_graph=True)
    want_out = run(ref[:3], ref[3:], plain=True)
    want = torch.autograd.grad(want_out, ref, g.float(), retain_graph=True)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "d_rel_pos_h", "d_rel_pos_w")
    errs = {}
    for name, a, b in zip(names, got, want):
        errs[name] = ((a.float() - b).abs().max() / b.abs().max()).item()
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: run(leaves[:3], leaves[3:]), reps=5, warmup=1)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True),
                     reps=5, warmup=1)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(want_out, ref, g.float(),
                                                   retain_graph=True), reps=3, warmup=1)
    del out, want_out, got, want
    torch.cuda.empty_cache()
    lib = sdpa_backward(torch, cuda_attn, [t.detach() for t in leaves], g, grid, scale)
    flops = 2.5 * 4.0 * bh * s * s * d
    nbytes = 7 * bh * s * d * q.element_size() + sum(t.numel() for t in tabs) * 4 * 2
    ok = all(e <= (BWD_F32_TOL if f32 else BWD_TOL if n in names[:3] else BWD_TABLE_TOL)
             for n, e in errs.items())
    return dict(errs=errs, ok=ok, fwd_ms=fwd_ms,
                bwd_ms=bwd_ms, plain_bwd_ms=plain_ms, **lib,
                bound=bound(flops, nbytes, PEAK_BF16_FLOPS),
                bound_f32=bound(flops, nbytes, PEAK_F32_FLOPS))


def sdpa_backward(torch, cuda_attn, tensors, g, grid, scale) -> dict:
    """The library yardstick of an attention backward: ``torch.autograd.grad`` of SDPA
    with its bf16 mask built inside the graph from the compact tables (the tables'
    lookup, q's projections, the broadcast add), on the same q, k, v, tables and output
    gradient. Returns the backward's ms under PyTorch's own choice of SDPA backend
    (``library_bwd_ms``, None if it raised, with the error), and whether the
    memory-efficient backend alone returns the mask's gradient (``efficient``: "ok" or
    its error)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q = tensors[0]
    bh, s, _ = q.shape
    leaves = [t.clone().requires_grad_() for t in tensors]

    def forward():
        mask = None
        if len(leaves) > 3:
            rel = [cuda_attn.get_rel_pos(n, n, t) for n, t in zip(grid, leaves[3:])]
            rh, rw = cuda_attn.bias_projections(leaves[0], *rel, grid)
            mask = (rh[..., :, None] + rw[..., None, :]).reshape(bh, s, s).to(q.dtype)[None]
        return F.scaled_dot_product_attention(*(t[None] for t in leaves[:3]),
                                              attn_mask=mask, scale=scale)[0]

    def error(e) -> str:
        return f"{type(e).__name__}: {str(e).splitlines()[0][:240]}"

    out = dict(library_bwd_ms=None, library_error=None, efficient="ok")
    try:
        y = forward()
        out["library_bwd_ms"] = cuda_ms(
            lambda: torch.autograd.grad(y, leaves, g, retain_graph=True), reps=5, warmup=1)
        del y
    except RuntimeError as e:  # an out-of-memory error too
        out["library_error"] = error(e)
    torch.cuda.empty_cache()
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            torch.autograd.grad(forward(), leaves, g)
        torch.cuda.synchronize()
    except RuntimeError as e:  # an out-of-memory error too
        out["efficient"] = error(e)
    torch.cuda.empty_cache()
    return out


def check_backward_kernels(torch, cuda_attn, card) -> list:
    """Phase 5b, first part: every BWD_CASES backward, then every BWD_F32_CASES one at
    f32; returns their records."""
    records = []
    cases = [(*c, False) for c in BWD_CASES] + [(*c, True) for c in BWD_F32_CASES]
    for i, (windowed, has_bias, d, grid, bh, f32) in enumerate(cases):
        r = check_attention_backward(torch, cuda_attn, windowed, has_bias, d, grid, bh,
                                     SEED + 50 + i, f32)
        name = (f"{'window' if windowed else 'global'}_attn"
                f"{'' if has_bias else '_nobias'}{'_f32' if f32 else ''}"
                f"{'' if d == 64 else f'_d{d}'}")
        (b_ms, by), (f32_ms, _) = r["bound"], r["bound_f32"]
        lib = (f"{r['library_bwd_ms']:.4f} ms" if r["library_bwd_ms"] is not None
               else f"raised {r['library_error']}")
        print(f"backward {name} BH {bh}, {grid[0]}x{grid[1]}, D {d}: backward "
              f"{r['bwd_ms']:.4f} ms beside the kernel forward {r['fwd_ms']:.4f} ms; bound "
              f"{b_ms:.4f} ms ({by}, bf16 peak; {f32_ms:.4f} ms at the f32 peak of its f32 "
              f"products); f32 autograd of attention_plain {r['plain_bwd_ms']:.4f} ms; "
              f"library (autograd of SDPA, mask built from the tables in the graph) {lib}; "
              f"memory-efficient SDPA alone: {r['efficient']}; "
              "error / max: " + ", ".join(f"{k} {v:.3e}" for k, v in r["errs"].items())
              + (f" (tol {BWD_F32_TOL:.0e}, all five)" if f32 else
                 f" (tol {BWD_TOL:.3e}; tables {BWD_TABLE_TOL:.0e})") + f" [{card}]",
              flush=True)
        if not r["ok"]:
            fail(f"the {name} backward disagrees with the f32 autograd of attention_plain")
        records.append(dict(name=name, route="pytorch", source="tmr_tpu_torch/ops/cuda_attn.py",
                            bh=bh, grid=list(grid), d=d, bwd_ms=r["bwd_ms"],
                            fwd_ms=r["fwd_ms"], plain_bwd_ms=r["plain_bwd_ms"],
                            library_bwd_ms=r["library_bwd_ms"],
                            library_error=r["library_error"], efficient=r["efficient"],
                            bound_ms=b_ms, bound_by=by, bound_f32_ms=f32_ms,
                            max_rel_err=max(r["errs"].values())))
    return records


def head_diff(torch, a: dict, b: dict, names) -> float:
    """||a - b|| over ``names``."""
    return math.sqrt(sum((a[n].float() - b[n].float()).pow(2).sum().item() for n in names))


def grad_norm(torch, model, batch, cfg, capacity: int) -> float:
    """The global norm of the loss's gradient over every parameter, frozen included."""
    from tmr_tpu_torch.train.state import compute_losses

    model.zero_grad(set_to_none=True)
    dev = next(model.parameters()).device
    ex = torch.as_tensor(batch["exemplars"], device=dev)
    out = model(torch.as_tensor(batch["image"], device=dev), ex, capacity)
    loss = compute_losses(out, {"exemplars": ex, "gt_boxes": batch["gt_boxes"],
                                "gt_valid": batch["gt_valid"]},
                          cfg.positive_threshold, cfg.negative_threshold)["loss"]
    loss.backward()
    norm = math.sqrt(sum(p.grad.float().pow(2).sum().item() for p in model.parameters()
                         if p.grad is not None))
    model.zero_grad(set_to_none=True)
    return norm


def step_parts(torch, ts, model, cfg, batch, capacity: int, reps: int = 3) -> dict:
    """One train step cut in three, each synchronized: the forward with the losses, the
    backward, the optimizer (``apply_gradients``: the finite check, the clip, AdamW);
    mean ms over ``reps`` steps on ``batch``."""
    from tmr_tpu_torch.train.state import compute_losses

    dev = next(model.parameters()).device
    img = torch.as_tensor(batch["image"], device=dev)
    ex = torch.as_tensor(batch["exemplars"], device=dev)
    t = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    for _ in range(reps):
        for p in ts.params.values():
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(img, ex, capacity)
        loss = compute_losses(out, {"exemplars": ex, "gt_boxes": batch["gt_boxes"],
                                    "gt_valid": batch["gt_valid"]},
                              cfg.positive_threshold, cfg.negative_threshold)["loss"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ts.apply_gradients({n: torch.zeros_like(p) if p.grad is None else p.grad
                            for n, p in ts.params.items()}, loss)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(t, (t1 - t0, t2 - t1, t3 - t2)):
            t[key] += dt * 1e3 / reps
    for p in ts.params.values():
        p.grad = None
    return t


def check_train_path(torch, np, pred, card, modules, backward=(), profile=False) -> dict:
    """Phase 5b, second part: ``Trainer.fit`` of ``preset("TMR_FSCD147")`` (SAM ViT-B at
    1024, batch 4, bf16, frozen backbone) from phase 4's weights on a synthetic
    FSCD-147-layout train split of 8 images (2 steps an epoch) with 4 val images: 3
    epochs in one run, and 2 epochs then a resumed run to 3. Every step must launch
    exactly TRAIN_STEP_LAUNCHES and every validation batch EVAL_LAUNCHES; the backbone
    must stay bit for bit phase 4's while the head moves; the resumed run must reach the
    uninterrupted one's parameters within RESUME_TOL; the gradient's norm must agree
    with the same step through ``attention_plain``; 8 steps on one batch must lower its
    loss; ``xcorr`` on a tensor that requires grad must raise, and a non-finite gradient
    must be discarded. Returns the numbers PERF.md keeps."""
    import dataclasses
    import os
    import tempfile

    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.train import loop
    from tmr_tpu_torch.train.state import TrainState

    _build, cuda_attn, cuda_xcorr = modules
    p4 = {k: v.detach().clone() for k, v in pred.model.state_dict().items()}
    steps, evals = [], []
    make_step = loop.make_train_step

    def recording_make_step(model, cfg):
        step = make_step(model, cfg)

        def run(state, batch):
            torch.cuda.synchronize()
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            losses = step(state, batch)
            torch.cuda.synchronize()
            steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                              launches={k: v - before[k] for k, v in _build.LAUNCHES.items()},
                              loss=float(losses["loss"]),
                              skipped=float(losses["skipped_nonfinite"])))
            return losses

        return run

    class RecordingTrainer(loop.Trainer):
        def _eval_batch(self, batch):
            torch.cuda.synchronize()
            before = dict(_build.LAUNCHES)
            out = super()._eval_batch(batch)
            torch.cuda.synchronize()
            evals.append({k: v - before[k] for k, v in _build.LAUNCHES.items()})
            return out

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        images = eval_split(np, os.path.join(tmp, "fsc"), TRAIN_SIDES, TRAIN_IMAGES)
        base = preset("TMR_FSCD147", datapath=os.path.join(tmp, "fsc"), num_workers=4,
                      seed=SEED, eval_batch_size=4, nowandb=True)

        def fit(tag, epochs, resume=False, **kw):
            cfg = dataclasses.replace(base, logpath=os.path.join(tmp, tag),
                                      max_epochs=epochs, resume=resume, **kw)
            tr = RecordingTrainer(cfg, device="cuda")
            n0 = len(steps)
            t0 = time.perf_counter()
            tr.fit(params=p4)
            return tr, steps[n0:], time.perf_counter() - t0

        loop.make_train_step = recording_make_step
        try:
            with in_memory_images(images):
                torch.cuda.reset_peak_memory_stats()
                _build.reset_launches()
                whole, w_steps, w_s = fit("whole", 3)
                launches = dict(_build.LAUNCHES)
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                part, p_steps, _ = fit("part", 2)
                del part
                resumed, r_steps, _ = fit("part", 3, resume=True)
                it = iter(whole._loaders()[0])
                batch = next(it)
                it.close()
                # compute_dtype="float32": one epoch (2 steps and a validation batch)
                n_evals = len(evals)
                torch.cuda.reset_peak_memory_stats()
                f32_tr, f32_steps, f32_s = fit("f32", 1, compute_dtype="float32")
                f32_peak_gb = torch.cuda.max_memory_allocated() / 1e9
                f32_evals = evals[n_evals:]
                del evals[n_evals:], f32_tr
        finally:
            loop.make_train_step = make_step
    all_steps = w_steps + p_steps + r_steps
    print(f"train path launches over the uninterrupted run ({len(w_steps)} steps, one "
          f"validation batch): {json.dumps(launches)}", flush=True)
    bad = [i for i, r in enumerate(all_steps) if r["launches"] != TRAIN_STEP_LAUNCHES]
    if bad or len(all_steps) != 12:
        fail(f"train steps {bad} of {len(all_steps)} launched other than "
             f"{TRAIN_STEP_LAUNCHES}: {[all_steps[i]['launches'] for i in bad]}")
    if len(evals) != 2 or any(e != EVAL_LAUNCHES for e in evals):
        fail(f"validation batches launched {evals}, expected 2 x {EVAL_LAUNCHES}")
    losses = [r["loss"] for r in all_steps]
    if not all(math.isfinite(x) for x in losses) or any(r["skipped"] for r in all_steps):
        fail(f"train losses {losses}, skipped {[r['skipped'] for r in all_steps]}")
    warm = [r["ms"] for r in w_steps[1:]]
    ms = sum(warm) / len(warm)
    out.update(step_ms=ms, first_step_ms=w_steps[0]["ms"], images_per_s=4e3 / ms,
               peak_gb=peak_gb, fit_s=w_s, losses=losses)
    f32_losses = [r["loss"] for r in f32_steps]
    f32_ms = ", ".join(f"{r['ms']:.1f}" for r in f32_steps)
    print(f"train path at compute_dtype=float32: {len(f32_steps)} steps of 4 images at "
          f"1024, ms {f32_ms} (the bf16 run's warm "
          f"{ms:.1f}), {4e3 / f32_steps[-1]['ms']:.2f} images/s at the last step; peak "
          f"device memory {f32_peak_gb:.2f} GB (bf16 {peak_gb:.2f}); losses "
          f"{', '.join(f'{x:.4f}' for x in f32_losses)}; launches a step "
          f"{json.dumps(f32_steps[0]['launches'] if f32_steps else None)}, validation "
          f"{json.dumps(f32_evals)}; the epoch with validation {f32_s:.1f} s [{card}]",
          flush=True)
    if (len(f32_steps) != 2
            or any(r["launches"] != F32_TRAIN_STEP_LAUNCHES for r in f32_steps)
            or f32_evals != [F32_EVAL_LAUNCHES]
            or not all(math.isfinite(x) for x in f32_losses)
            or any(r["skipped"] for r in f32_steps)):
        fail(f"f32 train steps {f32_steps} (expected 2 of {F32_TRAIN_STEP_LAUNCHES}, "
             f"finite, none skipped), validation {f32_evals}")
    out["f32"] = dict(step_ms=[r["ms"] for r in f32_steps], peak_gb=f32_peak_gb,
                      losses=f32_losses, fit_s=f32_s)
    print(f"train path: ms per step of 4 images at 1024 (warm, the uninterrupted run's "
          f"steps 1-5): {ms:.1f} (steps {', '.join(f'{x:.1f}' for x in warm)}; first "
          f"{w_steps[0]['ms']:.1f}) = {4e3 / ms:.2f} images/s; peak device memory "
          f"{peak_gb:.2f} GB; 3 epochs with validation at epoch 0 {w_s:.1f} s; losses "
          f"{', '.join(f'{x:.3f}' for x in losses[:6])} [{card}]", flush=True)

    # the frozen backbone bit for bit, the head moved
    got = {k: v.detach() for k, v in whole.model.state_dict().items()}
    head = [n for n, lab in whole.state.labels.items() if lab == "head"]
    frozen = [n for n, lab in whole.state.labels.items() if lab == "frozen"]
    moved_bb = [n for n in frozen if not torch.equal(got[n], p4[n])]
    moved = [n for n in head if not torch.equal(got[n], p4[n])]
    print(f"train path: {len(frozen)} backbone tensors, {len(moved_bb)} moved; {len(head)} "
          f"head tensors, {len(moved)} moved; {whole.state.count} updates", flush=True)
    if moved_bb or len(moved) < len(head) // 2 or not frozen:
        fail(f"frozen backbone moved ({moved_bb[:3]}) or head did not ({len(moved)})")

    # resume against the uninterrupted run
    res = {k: v.detach() for k, v in resumed.model.state_dict().items()}
    span = head_diff(torch, got, p4, head)
    diff = head_diff(torch, res, got, head)
    worst = max((res[n].float() - got[n].float()).abs().max().item() for n in head)
    lr = whole.cfg.lr
    print(f"train path resume: ||resumed - whole|| over the head {diff:.4e} = "
          f"{diff / span:.4e} of ||whole - phase 4|| ({span:.4e}), tol {RESUME_TOL}; largest "
          f"element {worst:.3e} ({worst / lr:.3f} lr)", flush=True)
    if diff > RESUME_TOL * span or any(not torch.equal(res[n], p4[n]) for n in frozen):
        fail("the resumed run does not reach the uninterrupted run's parameters")
    out.update(resume_rel=diff / span)
    del resumed

    # the gradient through the kernels against attention_plain on the card
    model = whole.model
    model.load_state_dict(p4)
    cap = max(whole.cfg.template_buckets)
    norm = grad_norm(torch, model, batch, whole.cfg, cap)
    with plain_attention(cuda_attn):
        plain_norm = grad_norm(torch, model, batch, whole.cfg, cap)
    torch.cuda.empty_cache()
    print(f"train path gradient global norm (phase 4's weights, one batch of 4): kernels "
          f"{norm:.6e}, attention_plain on the card {plain_norm:.6e}, relative "
          f"{abs(norm - plain_norm) / plain_norm:.3e} (tol {GRAD_NORM_TOL})", flush=True)
    if not (math.isfinite(norm) and abs(norm - plain_norm) <= GRAD_NORM_TOL * plain_norm):
        fail("the train step's gradient norm disagrees with attention_plain's")
    out.update(grad_norm=norm, plain_grad_norm=plain_norm)

    # 8 steps on one batch lower its loss; a non-finite gradient moves nothing
    ts = TrainState(model, whole.cfg, steps_per_epoch=100)
    step = make_step(model, whole.cfg)
    fixed = [float(step(ts, batch)["loss"]) for _ in range(8)]
    print(f"train path, 8 steps on one batch: losses {', '.join(f'{x:.4f}' for x in fixed)}",
          flush=True)
    if not (all(math.isfinite(x) for x in fixed) and fixed[-1] < fixed[0]):
        fail("8 steps on one batch did not lower its loss")
    before = {n: p.detach().clone() for n, p in ts.params.items() if ts.labels[n] == "head"}
    nan = {n: torch.full_like(p, float("nan")) if i == 0 else torch.zeros_like(p)
           for i, (n, p) in enumerate(ts.params.items())}
    if ts.apply_gradients(nan) or ts.count != 8 or any(
            not torch.equal(ts.params[n], p) for n, p in before.items()):
        fail("a non-finite gradient was not discarded")

    # where a step's time goes: forward, backward (the attention's share from the
    # backward checks at the same shapes), optimizer
    parts = step_parts(torch, ts, model, whole.cfg, batch, cap)
    per_call = {r["name"]: r["bwd_ms"] for r in backward}
    attn_bwd = 4 * per_call.get("global_attn", 0.0) + 8 * per_call.get("window_attn", 0.0)
    total = sum(parts.values())
    print(f"train path step parts (one batch of 4, synchronized, mean of 3): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in parts.items())
          + f"; backward share {parts['backward'] / total:.3f}; the attention backward "
          f"(4 global + 8 windowed calls at phase 5b's per-call times) {attn_bwd:.1f} ms = "
          f"{attn_bwd / parts['backward']:.3f} of the backward [{card}]", flush=True)
    out.update(parts_ms=parts, attn_bwd_ms=attn_bwd)
    if profile:
        profile_batch(torch, lambda: step(ts, batch), "train path",
                      "one train step of 4 images at 1024, bucket 191 (FFT)")

    # a kernel without a backward refuses an input that requires grad
    f = torch.randn(1, 2, 16, 16, device="cuda", requires_grad=True)
    try:
        cuda_xcorr.xcorr(f, torch.randn(1, 2, 3, 3, device="cuda"))
    except RuntimeError as e:
        print(f"train path: xcorr on a tensor that requires grad raises: {e}", flush=True)
    else:
        fail("xcorr took a tensor that requires grad and cut the graph")
    del whole, model, ts
    torch.cuda.empty_cache()
    return out


def check_1536_objectness(torch, pred, Predictor, imgs, ex):
    """Image 0 of a 1536 batch of 4: its objectness on the card (taken now) against an f32
    CPU run of the same port and weights, within OBJ_REL_TOL of the map's max. Returns
    (run, finish): ``run()`` makes the CPU run (on any thread: phase 5c calls it beside its
    CLI runs, where the card idles), ``finish()`` makes it if it was not made, compares
    and fails (on the main thread)."""
    from tmr_tpu_torch.config import preset

    obj = pred.forward(imgs, ex)["objectness"][0].float().cpu()
    ref = Predictor(preset("TMR_FSCD147", compute_dtype="float32"), device="cpu")
    ref.model.load_state_dict({k: v.cpu() for k, v in pred.model.state_dict().items()})
    done = {}

    def run() -> None:
        t0 = time.perf_counter()
        done["obj"] = ref.forward(imgs[:1], ex[:1])["objectness"][0]
        done["s"] = time.perf_counter() - t0

    def finish() -> None:
        if "obj" not in done:
            run()
        ref_obj = done["obj"]
        diff = (obj - ref_obj).abs().max().item()
        scale = ref_obj.abs().max().item()
        print(f"eval 1536 bucket objectness image 0 vs f32 CPU run: shape "
              f"{tuple(obj.shape)}, max_abs_diff {diff:.4e}, map max {scale:.4e}, "
              f"{diff / scale:.4f} of the max, tol {OBJ_REL_TOL} ({done['s']:.1f} s on "
              f"the CPU)", flush=True)
        if not (torch.isfinite(obj).all() and obj.shape == (192, 192)
                and diff <= OBJ_REL_TOL * scale):
            fail("the 1536 bucket's objectness map disagrees with the f32 CPU reference")

    return run, finish


@contextlib.contextmanager
def plain_attention(cuda_attn):
    """While the block runs, the ViT's attention blocks call ``attention_plain`` on the
    card (projections by ``bias_projections``, dense f32 scores) in place of the kernels:
    a yardstick of this script, never a path of the port."""
    from tmr_tpu_torch.models import vit

    def plain(q, k, v, rh, rw, grid, scale, expand):
        if expand:  # the global blocks pass the compact tables
            rh, rw = (cuda_attn.get_rel_pos(g, g, t) for g, t in zip(grid, (rh, rw)))
        rel = cuda_attn.bias_projections(q, rh, rw, grid)
        return cuda_attn.attention_plain(q, k, v, *rel, grid, scale)

    saved = vit.global_attention, vit.window_attention
    vit.global_attention = lambda *a: plain(*a, expand=True)
    vit.window_attention = lambda *a: plain(*a, expand=False)
    try:
        yield
    finally:
        vit.global_attention, vit.window_attention = saved


def check_vit_h_path(torch, np, batches, caps, card, modules):
    """Phase 4c: ``preset("TMR_FSCD147", backbone="sam_vit_h")`` (SAM ViT-H at 1024, 32
    blocks of 1280 over 16 heads of 80, batch 4, bf16) with seeded random weights on the
    phase 4 batches; returns its launches and the predictor."""
    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.inference import Predictor, detections_to_numpy

    _build, cuda_attn, cuda_nms = modules
    t0 = time.perf_counter()
    hpred = Predictor(preset("TMR_FSCD147", backbone="sam_vit_h"), device="cuda")
    hpred.init_params(SEED)
    torch.cuda.synchronize()
    n_enc = sum(p.numel() for p in hpred.model.backbone.parameters())
    n_all = sum(p.numel() for p in hpred.model.parameters())
    print(f"ViT-H path: {n_enc} encoder parameters ({n_all} in all), built and initialized "
          f"on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    hcaps = [hpred.pick_capacity(ex, 1024) for _, ex in batches]
    if hcaps != caps:
        fail(f"ViT-H path: exemplars picked buckets {hcaps}, expected {caps}")
    with call_count(cuda_attn, "bias_projections") as proj_calls:
        times, outs, launches = run_batches(torch, hpred, batches, detections_to_numpy,
                                            _build)
    report_batches(np, "ViT-H path", caps, times, outs, card)
    print(f"ViT-H path launches over the 3 batches: {json.dumps(launches)}", flush=True)
    print(f"ViT-H path bias_projections calls over the warm-up and 3 batches: "
          f"{len(proj_calls)} (expected 0)", flush=True)
    if proj_calls:
        fail(f"bias_projections ran {len(proj_calls)} times on the ViT-H path, expected 0")
    if launches != VIT_H_LAUNCHES:
        fail(f"ViT-H path launches {launches}, expected {VIT_H_LAUNCHES}")
    check_main_path_nms(torch, lambda: hpred(*batches[0]), cuda_nms, "ViT-H path batch 0")

    imgs, ex = batches[0]
    obj = hpred.forward(imgs, ex)["objectness"][0].float().cpu()
    with plain_attention(cuda_attn), torch.inference_mode():
        plain_obj = hpred.forward(imgs[:1], ex[:1])["objectness"][0].float().cpu()
    torch.cuda.empty_cache()
    ref = Predictor(preset("TMR_FSCD147", backbone="sam_vit_h", compute_dtype="float32"),
                    device="cpu")
    ref.model.load_state_dict({k: v.cpu() for k, v in hpred.model.state_dict().items()})
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref_obj = ref.forward(imgs[:1], ex[:1])["objectness"][0]
    cpu_s = time.perf_counter() - t0
    del ref
    scale = ref_obj.abs().max().item()
    diff = (obj - ref_obj).abs().max().item()
    plain_diff = (plain_obj - ref_obj).abs().max().item()
    kernel_plain = (obj - plain_obj).abs().max().item()
    print(f"ViT-H objectness image 0 vs an f32 CPU run ({cpu_s:.1f} s on the CPU), map max "
          f"{scale:.4e}: kernels (bf16, batch of 4) max_abs_diff {diff:.4e} = "
          f"{diff / scale:.4f} of the max, tol {OBJ_REL_TOL}; the same bf16 network with "
          f"the attention through attention_plain on the card (image 0 alone) "
          f"{plain_diff:.4e} = {plain_diff / scale:.4f}; kernels vs that run "
          f"{kernel_plain:.4e} = {kernel_plain / scale:.4f}", flush=True)
    if not (torch.isfinite(obj).all() and obj.shape == (128, 128)
            and diff <= OBJ_REL_TOL * scale):
        fail("ViT-H objectness map disagrees with the f32 CPU reference")
    return launches, hpred, (ref_obj, diff / scale, sum(times) / len(times))


#: phase 4f: image 0's objectness at ``compute_dtype="float32"`` on the card against the
#: f32 CPU run of the same weights (phase 4's, 4c's), relative to the map's max: two f32
#: networks, the card's with its convolutions in TF32 (cuDNN's default, kept) and its
#: attention in 3xTF32
F32_OBJ_TOL = 2e-2
#: launches of one ViT-H batch of 4 at f32: 4 global and 28 windowed blocks at head dim 80
F32_VIT_H_LAUNCHES = dict(VIT_H_LAUNCHES, xcorr=1, nms=1, global_attn_d80=0,
                          window_attn_d80=0, global_attn_f32_d80=4, window_attn_f32_d80=28)


def tf32_settings(torch) -> str:
    """PyTorch's TF32 switches: the f32 network's linears and convolutions run under them."""
    return (f"torch.backends.cuda.matmul.allow_tf32 "
            f"{torch.backends.cuda.matmul.allow_tf32} (cuBLAS SGEMM), "
            f"torch.backends.cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32} (cuDNN "
            f"convolutions), float32_matmul_precision "
            f"{torch.get_float32_matmul_precision()!r}")


def check_f32_objectness(torch, name, fpred, imgs, ex, ref_obj, bf16_rel) -> float:
    """Image 0's objectness of ``fpred`` (f32 on the card) against ``ref_obj``, the f32 CPU
    run of the same weights, within F32_OBJ_TOL of the map's max; printed beside the bf16
    network's figure from the same call. Returns the relative difference."""
    obj = fpred.forward(imgs, ex)["objectness"][0].float().cpu()
    scale = ref_obj.abs().max().item()
    diff = (obj - ref_obj).abs().max().item()
    print(f"{name} objectness image 0 vs the f32 CPU run: max_abs_diff {diff:.4e}, map max "
          f"{scale:.4e}, {diff / scale:.4e} of the max (tol {F32_OBJ_TOL}); the bf16 "
          f"network's in this call {bf16_rel:.4e}", flush=True)
    if not (torch.isfinite(obj).all() and obj.shape == ref_obj.shape
            and diff <= F32_OBJ_TOL * scale):
        fail(f"{name}: objectness disagrees with the f32 CPU reference")
    return diff / scale


def check_f32_path(torch, np, pred, batches, multi_batches, caps, ref, card, modules,
                   profile=False):
    """Phase 4f, ViT-B: ``Predictor(preset("TMR_FSCD147", compute_dtype="float32"))`` on
    phase 4's weights over phase 4's 3 batches (buckets 9, 17, 33), then one
    ``predict_multi_batch`` of phase 4d's. Each batch must launch exactly the f32 attention
    kernels' 4 global and 8 windowed blocks, one correlation and one NMS, and no bf16
    attention kernel; nothing may call ``bias_projections``; batch 0's keep mask must
    equal the plain version's; image 0's objectness must lie within F32_OBJ_TOL of phase
    4's f32 CPU run. ``ref`` is (that run's map, the bf16 path's relative difference from
    it, phase 4's ms per batch). Returns the launches over the 3 batches and the numbers
    PERF.md keeps."""
    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.inference import Predictor, detections_to_numpy

    _build, cuda_attn, cuda_nms = modules
    ref_obj, bf16_rel, bf16_ms = ref
    print(f"f32 path: PyTorch's defaults, kept: {tf32_settings(torch)}", flush=True)
    fpred = Predictor(preset("TMR_FSCD147", compute_dtype="float32"), device="cuda")
    fpred.model.load_state_dict(pred.model.state_dict())
    torch.cuda.reset_peak_memory_stats()
    with call_count(cuda_attn, "bias_projections") as proj_calls:
        times, outs, launches = run_batches(torch, fpred, batches, detections_to_numpy,
                                            _build)
    peak = torch.cuda.max_memory_allocated() / 1e9
    report_batches(np, "f32 path", caps, times, outs, card)
    want = {k: 3 * v for k, v in F32_EVAL_LAUNCHES.items()}
    print(f"f32 path launches over the 3 batches: {json.dumps(launches)}; bias_projections "
          f"calls {len(proj_calls)} (expected 0)", flush=True)
    if launches != want or proj_calls:
        fail(f"f32 path launches {launches} (expected {want}), bias_projections calls "
             f"{len(proj_calls)}")
    ms = sum(times) / len(times)
    print(f"f32 path: {ms:.1f} ms per batch of 4, {4e3 / ms:.2f} img/s, peak device memory "
          f"{peak:.2f} GB; the bf16 path (phase 4) {bf16_ms:.1f} ms, {4e3 / bf16_ms:.2f} "
          f"img/s [{card}]", flush=True)
    check_main_path_nms(torch, lambda: fpred(*batches[0]), cuda_nms, "f32 path batch 0")
    imgs, ex = batches[0]
    rel = check_f32_objectness(torch, "f32 path", fpred, imgs, ex, ref_obj, bf16_rel)
    if profile:
        profile_batch(torch, lambda: fpred(*batches[2]), "f32 path")

    imgs, ex = multi_batches[0]
    k_real = np.array(MULTI_K_REAL, np.int32)
    fpred.predict_multi_batch(imgs, ex, k_real)  # warm-up at the multi shapes
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    dets = fpred.predict_multi_batch(imgs, ex, k_real)
    torch.cuda.synchronize()
    multi_ms = (time.perf_counter() - t0) * 1e3
    mlaunches = dict(_build.LAUNCHES)
    lists = detections_to_numpy(dets)
    print(f"f32 multi path, one batch of 4 images x 3 exemplars (real rows "
          f"{list(MULTI_K_REAL)}): {multi_ms:.1f} ms, detections per image "
          f"{[len(d['boxes']) for d in lists]}, launches {json.dumps(mlaunches)} [{card}]",
          flush=True)
    if mlaunches != F32_EVAL_LAUNCHES or not all(
            np.isfinite(d["boxes"]).all() and np.isfinite(d["scores"]).all() for d in lists):
        fail(f"f32 multi path: launches {mlaunches} (expected {F32_EVAL_LAUNCHES}) or "
             "non-finite detections")
    del fpred
    torch.cuda.empty_cache()
    return launches, dict(ms=ms, images_per_s=4e3 / ms, peak_gb=peak, obj_rel=rel,
                          bf16_ms=bf16_ms, multi_ms=multi_ms)


#: phase 4f, ``Attention(use_rel_pos=False)`` at ViT-B's width (768 channels, 12 heads of
#: 64) on the card against the f32 CPU run of the same weights, relative to the output's
#: max: f32 (3xTF32 attention within 2e-5 of its max, the two f32 linears' sums of 768
#: products in another order) and bf16 (the linears' operands and p rounded to bf16: the
#: bf16 networks' tier)
NOBIAS_F32_TOL = 1e-4
NOBIAS_BF16_TOL = OBJ_REL_TOL
#: one batch of 4 images through one global block (64^2 tokens) and one windowed block (25
#: windows of 14^2 an image), in f32 then bf16: the global kernel without tables, counted
#: under its dtype's global counter (the windowed blocks take it over each window)
NOBIAS_LAUNCHES = {**{k: 0 for k in EVAL_LAUNCHES}, "global_attn": 2,
                   "global_attn_f32": 2}


def check_nobias_blocks(torch, card, modules):
    """Phase 4f: one global and one windowed ``models.vit.Attention(use_rel_pos=False)``
    block at ViT-B's width (seeded weights, the same for both dtypes), on a batch of 4 at
    1024^2 (4 x 64^2 tokens; 100 windows of 14^2), in f32 and bf16, each once after a
    warm-up; the launches of those 4 runs must be exactly :data:`NOBIAS_LAUNCHES` (no
    windowed kernel: a window without the bias is the global function over its tokens),
    and image 0's outputs must agree with an f32 CPU run of the same weights. Returns the
    launches and the ms of each run."""
    from tmr_tpu_torch.models.vit import Attention
    from tmr_tpu_torch.utils.weights import init_params

    (_build,) = modules
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    inputs = {False: torch.randn(4, 64, 64, 768, generator=gen, device="cuda"),
              True: torch.randn(100, 14, 14, 768, generator=gen, device="cuda")}
    blocks = {}
    for windowed in (False, True):
        ref = Attention(768, 12, (14, 14) if windowed else (64, 64), windowed,
                        torch.float32, use_rel_pos=False)
        init_params(ref, SEED + 12 + windowed)
        for dt in (torch.float32, torch.bfloat16):
            blk = Attention(768, 12, (14, 14) if windowed else (64, 64), windowed, dt,
                            use_rel_pos=False).cuda()
            blk.load_state_dict(ref.state_dict())
            blocks[windowed, dt] = blk
        blocks[windowed, "cpu"] = ref
    outs, ms = {}, {}
    with torch.inference_mode():
        for key, blk in blocks.items():
            if key[1] != "cpu":
                blk(inputs[key[0]])  # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        for key, blk in blocks.items():
            if key[1] == "cpu":
                continue
            t0 = time.perf_counter()
            outs[key] = blk(inputs[key[0]])
            torch.cuda.synchronize()
            ms[key] = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.LAUNCHES)
        result = {}
        for windowed in (False, True):
            x0 = inputs[windowed][:25 if windowed else 1].cpu()
            want = blocks[windowed, "cpu"](x0)
            scale = want.abs().max().item()
            for dt, tol in ((torch.float32, NOBIAS_F32_TOL), (torch.bfloat16, NOBIAS_BF16_TOL)):
                got = outs[windowed, dt][:x0.shape[0]].float().cpu()
                rel = (got - want).abs().max().item() / scale
                name = (f"Attention(use_rel_pos=False) {'windowed' if windowed else 'global'} "
                        f"{str(dt).split('.')[-1]}")
                print(f"{name}: batch of 4 at 1024^2 {ms[windowed, dt]:.3f} ms; image 0 vs "
                      f"the f32 CPU run {rel:.3e} of the max (tol {tol:g}) [{card}]",
                      flush=True)
                if not (torch.isfinite(got).all() and rel <= tol):
                    fail(f"{name} disagrees with the f32 CPU run: {rel} > {tol}")
                result[name] = dict(ms=ms[windowed, dt], rel=rel)
    print(f"Attention(use_rel_pos=False) launches over the 4 runs: {json.dumps(launches)}",
          flush=True)
    if launches != NOBIAS_LAUNCHES:
        fail(f"Attention(use_rel_pos=False) launches {launches}, expected {NOBIAS_LAUNCHES}")
    return launches, result


def check_f32_vit_h(torch, np, hpred, batches, caps, ref, card, modules):
    """Phase 4f, ViT-H: ``backbone="sam_vit_h"`` at ``compute_dtype="float32"`` on phase
    4c's weights, one batch of 4 (phase 4's batch 0) after a warm-up: exactly 4 global and
    28 windowed f32 blocks at head dim 80, one correlation, one NMS; the keep mask equal to
    the plain version's; image 0's objectness within F32_OBJ_TOL of phase 4c's f32 CPU run
    (``ref``: that map, the bf16 network's relative difference, 4c's ms per batch).
    Returns the batch's launches and the numbers PERF.md keeps."""
    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.inference import Predictor, detections_to_numpy

    _build, cuda_attn, cuda_nms = modules
    ref_obj, bf16_rel, bf16_ms = ref
    fh = Predictor(preset("TMR_FSCD147", backbone="sam_vit_h", compute_dtype="float32"),
                   device="cuda")
    fh.model.load_state_dict(hpred.model.state_dict())
    torch.cuda.reset_peak_memory_stats()
    with call_count(cuda_attn, "bias_projections") as proj_calls:
        times, outs, launches = run_batches(torch, fh, batches[:1], detections_to_numpy,
                                            _build)
    peak = torch.cuda.max_memory_allocated() / 1e9
    counts = [len(d["boxes"]) for d in outs[0]]
    if not all(np.isfinite(d["boxes"]).all() and np.isfinite(d["scores"]).all()
               for d in outs[0]):
        fail("f32 ViT-H path: non-finite detections")
    print(f"f32 ViT-H path batch 0 (bucket {caps[0]}): detections per image {counts}; "
          f"launches over the batch: {json.dumps(launches)}; "
          f"bias_projections calls {len(proj_calls)} (expected 0); {times[0]:.1f} ms per "
          f"batch of 4, {4e3 / times[0]:.2f} img/s, peak device memory {peak:.2f} GB; the "
          f"bf16 ViT-H path (phase 4c) {bf16_ms:.1f} ms [{card}]", flush=True)
    if launches != F32_VIT_H_LAUNCHES or proj_calls:
        fail(f"f32 ViT-H path launches {launches} (expected {F32_VIT_H_LAUNCHES}), "
             f"bias_projections calls {len(proj_calls)}")
    check_main_path_nms(torch, lambda: fh(*batches[0]), cuda_nms, "f32 ViT-H path batch 0")
    imgs, ex = batches[0]
    rel = check_f32_objectness(torch, "f32 ViT-H path", fh, imgs, ex, ref_obj, bf16_rel)
    del fh
    torch.cuda.empty_cache()
    return launches, dict(ms=times[0], images_per_s=4e3 / times[0], peak_gb=peak,
                          obj_rel=rel, bf16_ms=bf16_ms)


def check_f32_cli(torch, np, pred, card, modules) -> dict:
    """Phase 4f, the CLI: ``tmr_tpu_torch.main --eval --compute_dtype float32
    --visualize`` (in process, the flags of ``preset("TMR_FSCD147")``) on phase 5's
    synthetic split, reading phase 4's weights from a Lightning ``best_model.ckpt``: its 3
    eval batches (2 at 1024, 1 at 1536) must launch exactly the f32 kernels' 4 / 8 and one
    correlation and one NMS each, the metrics must be finite, and a triptych of each of
    the 12 images must be written (3 panels of the 384 x 512 image)."""
    import os
    import tempfile

    from tmr_tpu_torch import main as cli
    from tmr_tpu_torch.utils.convert import lightning_state_dict

    _build, = modules
    with tempfile.TemporaryDirectory() as tmp:
        images = eval_split(np, os.path.join(tmp, "fsc"))
        log = os.path.join(tmp, "log")
        os.makedirs(log)
        torch.save({"state_dict": lightning_state_dict(pred.model.state_dict())},
                   os.path.join(log, "best_model.ckpt"))
        argv = ["--eval", "--compute_dtype", "float32", "--visualize", "--dataset",
                "FSCD147", "--datapath", os.path.join(tmp, "fsc"), "--logpath", log,
                "--backbone", "sam_vit_b", "--emb_dim", "512", "--fusion",
                "--feature_upsample", "--positive_threshold", "0.5",
                "--negative_threshold", "0.5", "--NMS_cls_threshold", "0.25",
                "--NMS_iou_threshold", "0.5", "--eval_batch_size", "4", "--num_workers",
                "4", "--nowandb"]
        with in_memory_images(images):
            _build.reset_launches()
            t0 = time.perf_counter()
            metrics = cli.main(argv)
            wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        out = Path(log) / "visualizations" / "test"
        trips = sorted(out.glob("*_triptych.png"))
        sizes = {png_size(path.read_bytes()) for path in trips}
    want = {k: 3 * v for k, v in F32_EVAL_LAUNCHES.items()}
    print(f"f32 CLI (main --eval --compute_dtype float32 --visualize): {wall:.2f} s for 12 "
          f"images (checkpoint load, loader, 3 batches, metrics, triptychs), launches "
          f"{json.dumps(launches)}; metrics {json.dumps(metrics)}; {len(trips)} triptychs, "
          f"sizes {sorted(sizes)} [{card}]", flush=True)
    if launches != want or not all(math.isfinite(v) for v in metrics.values()):
        fail(f"f32 CLI: launches {launches} (expected {want}) or non-finite metrics")
    if len(trips) != len(images) or sizes - {(3 * EVAL_HW[1], EVAL_HW[0])}:
        fail(f"f32 CLI --visualize wrote {len(trips)} triptychs of sizes {sizes}, expected "
             f"{len(images)} of {3 * EVAL_HW[1]}x{EVAL_HW[0]}")
    return dict(cli_s=wall, triptychs=len(trips))


#: phase 5c's synthetic shards: 10 PNGs of 480 x 640 in each category (one batch of 8
#: and a tail of 2, padded), then a tar cut short inside its first member's payload
MAP_SHARDS = ("Easy_0", "Normal_0", "Hard_0")
MAP_IMAGES = 10
MAP_HW = (480, 640)
MAP_SIZE = 1024
MAP_BATCH = 8
#: launches of one batch of 8 through the encoder: its 4 global and 8 windowed blocks
MAP_BATCH_LAUNCHES = dict({k: 0 for k in TRAIN_STEP_LAUNCHES}, global_attn=4,
                          window_attn=8)
#: the map phase against the same run with the attention through ``attention_plain`` on
#: the card, both bf16 networks (the two attentions round p at other points; phase 4c's
#: bf16 tier): each feature file within 5e-2 x its largest |value|, each of the table's
#: four sums within 5e-2 x its category's std sum (the features' scale: their mean is
#: ~0 after the neck's LayerNorm, so a relative bound on it would mean nothing)
MAP_REL_TOL = 5e-2
#: the transient fault and the cut of phase 5c's CLI runs (shard indices of the list)
MAP_FAULT = "tar.open:shard=1:attempts=1:raise=OSError"
MAP_CUT = "tar.open:shard=2:raise=KeyboardInterrupt"
EXTRACT_HW = (720, 1280)
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def write_png(np, path, img) -> None:
    """An 8-bit RGB PNG (every row filter 0), made with ``zlib`` and ``struct`` alone
    (``tmr_tpu_torch.chaos_probe.png_bytes``)."""
    from tmr_tpu_torch.chaos_probe import png_bytes

    Path(path).write_bytes(png_bytes(img))


def read_png(data: bytes):
    """The reader of :func:`write_png`'s files (8-bit RGB, filter 0), for a machine
    without PIL: swapped in for ``transforms.decode_image``; anything else raises, as an
    undecodable image does."""
    import struct
    import zlib

    import numpy as np

    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, head = 8, [], None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            head = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if head is None or head[2:] != (8, 2):
        raise ValueError("only 8-bit RGB PNGs are read")
    w, h = head[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("only filter 0 is read")
    return rows[:, 1:].reshape(h, w, 3).copy()


def png_size(data: bytes):
    """(width, height) from a PNG's IHDR chunk."""
    import struct

    if data[:8] != PNG_SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError("not a PNG")
    return struct.unpack(">II", data[16:24])


def use_png_reader() -> None:
    """Swap the map phase's decode for :func:`read_png` (a machine without PIL)."""
    from tmr_tpu_torch.data import transforms

    transforms.decode_image = read_png


def has_pil() -> bool:
    import importlib.util

    return importlib.util.find_spec("PIL") is not None


def map_shards(np, root: Path, rng, names=MAP_SHARDS, corrupt: bool = True) -> list:
    """Phase 5c's shards under ``root`` (phase 5g's with its ``names`` and no corrupt
    tar): smooth colour fields with noise, as PNGs."""
    import io
    import tarfile

    paths = []
    yy, xx = np.mgrid[0:MAP_HW[0], 0:MAP_HW[1]].astype(np.float32)
    for name in names:
        path = root / f"{name}.tar"
        with tarfile.open(path, "w") as tar:
            for i in range(MAP_IMAGES):
                f = rng.uniform(0.005, 0.05, (3, 2))
                img = np.stack([127 + 100 * np.sin(yy * a + xx * b + i) for a, b in f], -1)
                img = np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)
                write_png(np, root / "img.png", img)
                tar.add(root / "img.png", arcname=f"{name.lower()}_{i}.png")
        paths.append(path)
    if not corrupt:
        return paths
    # a tar cut inside its first member: tarfile and the native reader both fail it
    whole = io.BytesIO()
    with tarfile.open(fileobj=whole, mode="w") as tar:
        tar.add(root / "img.png", arcname="cut_0.png")
    (root / "corrupt.tar").write_bytes(whole.getvalue()[:512 + 4096])
    paths.append(root / "corrupt.tar")
    return paths


def sam_checkpoint(torch, backbone, path) -> None:
    """The encoder's weights as a SAM checkpoint (``image_encoder.*`` keys, f32), the
    inverse of ``utils.convert.sam_vit_state_dict``'s renames."""
    renames = (("patch_embed.", "patch_embed.proj."), ("neck_0.", "neck.0."),
               ("neck_1.", "neck.1."), ("neck_2.", "neck.2."), ("neck_3.", "neck.3."))
    sd = {}
    for key, val in backbone.state_dict().items():
        for mine, theirs in renames:
            if key.startswith(mine):
                key = theirs + key[len(mine):]
        sd["image_encoder." + key] = val.detach().float().cpu()
    torch.save(sd, path)


def map_cli(root: Path, tmp: Path, tag: str, extra=(), env=None, names=None):
    """``map ... | tee records | reduce`` in a subprocess, as a user runs it (with the
    PNG reader swapped in where PIL is missing), over phase 5c's shards or ``names``.
    Returns (popen, paths)."""
    import os
    import shlex

    prog = ([sys.executable, "-m", "tmr_tpu_torch.parallel.mapreduce"] if has_pil() else
            [sys.executable, "-c", "import runpy, sys; sys.path.insert(0, sys.argv.pop(1)); "
             "import chip_smoke; chip_smoke.use_png_reader(); runpy.run_module("
             "'tmr_tpu_torch.parallel.mapreduce', run_name='__main__')", str(root)])
    out = {k: tmp / f"{tag}.{k}" for k in ("records", "table", "stderr", "report")}
    feats = tmp / f"features_{tag}"
    argv = prog + ["map", "--data_dir", str(tmp), "--checkpoint", str(tmp / "vit_b.pth"),
                   "--features_out", str(feats), "--report_out", str(out["report"]),
                   "--image_size", str(MAP_SIZE), "--backoff_base", "0.05", *extra]
    reduce = prog + ["reduce"]
    names = names or [p + ".tar" for p in MAP_SHARDS] + ["corrupt.tar"]
    cmd = (f"set -o pipefail; printf '%s\\n' {' '.join(names)} "
           f"| {shlex.join(argv)} 2>{shlex.quote(str(out['stderr']))} "
           f"| tee {shlex.quote(str(out['records']))} | {shlex.join(reduce)} "
           f"> {shlex.quote(str(out['table']))}")
    proc = subprocess.Popen(["bash", "-c", cmd], cwd=root,
                            env=dict(os.environ, **(env or {}),
                                     PYTHONPATH=str(root)))
    return proc, dict(out, features=feats)


def wait_cli(proc, out, tag: str, want_rc=0, timeout=300):
    rc = proc.wait(timeout=timeout)
    if (rc == 0) != (want_rc == 0):
        tail = out["stderr"].read_text()[-3000:] if out["stderr"].exists() else ""
        fail(f"map CLI run {tag}: exit code {rc}, expected "
             f"{'0' if want_rc == 0 else 'non-zero'}; stderr tail:\n{tail}")
    return rc


def cli_result(np, out, tag: str) -> dict:
    """The records, table and report of a finished CLI run, checked: stdout carries
    records only, the table is ``format_stats_table`` of them, the corrupt tar was
    quarantined on its first attempt."""
    from tmr_tpu_torch.parallel import mapreduce as mr

    records = out["records"].read_text()
    lines = records.splitlines()
    rec = re.compile(r"^(Easy|Normal|Hard|Unknown)\t[^,\s]+(,[^,\s]+){3},\d+$")
    if not lines or not all(rec.match(line) for line in lines):
        fail(f"map CLI run {tag}: stdout is not records only: {records[:500]!r}")
    table = out["table"].read_text()
    if table != mr.format_stats_table(mr.reduce_lines(lines)) + "\n":
        fail(f"map CLI run {tag}: reduce's table is not the records' table")
    report = json.loads(out["report"].read_text())
    bad = [r for r in report["shards"] if r["shard"] == "corrupt.tar"
           and (r["status"], r["attempts"]) != ("quarantined", 1)]
    if report["quarantined"] != ["corrupt.tar"] or bad:
        fail(f"map CLI run {tag}: the corrupt tar was not quarantined on its first "
             f"attempt: {report['shards']}")
    return dict(records=records, table=table, report=report)


def feature_files(np, root: Path) -> dict:
    return {str(p.relative_to(root)): np.load(p) for p in sorted(root.rglob("*.npy"))}


def check_map_path(torch, np, pred, card, modules, beside_clis=None) -> tuple:
    """Phase 5c: the map phase (``tmr_tpu_torch.parallel.mapreduce``) and
    ``extract_feature`` on phase 4's ViT-B weights (bf16, 1024^2, batch 8);
    ``beside_clis()`` runs on a thread while the CLI runs do, and nothing here is timed
    until it has ended. Returns the
    numbers PERF.md keeps, the in-process run's records (phase 5h's reference), and shard
    Easy_0's bytes with the CLI's features of it (phase 5i's reference)."""
    import contextlib as ctx
    import io
    import tempfile

    import torch.nn.functional as F

    from tmr_tpu_torch import extract_feature
    from tmr_tpu_torch.data import native_io, transforms
    from tmr_tpu_torch.parallel import mapreduce as mr
    from tmr_tpu_torch.parallel.journal import ShardJournal

    _build, cuda_attn = modules
    backbone = pred.model.backbone.eval()
    decode = "PIL" if has_pil() else "the PNG reader of chip_smoke.py (no PIL here)"
    print(f"map path: decode by {decode}; native reader "
          f"{'built' if native_io.available() else 'UNAVAILABLE'}", flush=True)
    if not native_io.available():
        fail("the native tar reader did not build (g++ and native/tmr_io.cc)")
    out = {"decode": "PIL" if has_pil() else "png_reader"}

    # kernels 1 and 4 at the batch-8 shapes (BH 96 and 2400)
    for name, windowed, grid, bh in (("global_attn", False, (64, 64), 96),
                                     ("window_attn", True, (14, 14), 2400)):
        acc, t, (bms, bby) = check_attention(torch, F, cuda_attn, windowed, True, SEED + 70,
                                             grid, bh)
        print(f"map path kernel {name} BH {bh}: {attn_accuracy(acc)} {attn_times(t)} "
              f"bound_ms {bms:.4f} ({bby}) [{card}]", flush=True)
        if not acc["ok"]:
            fail(f"{name} at the map path's BH {bh} disagrees with its plain version")
        out[f"{name}_bh{bh}"] = dict(ms=t["ms"], plain_ms=t["plain_ms"],
                                     library_ms=t["lib_ms"], bound_ms=bms,
                                     max_abs_err=acc["max_abs_err"])
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmpdir, ctx.ExitStack() as stack:
        tmp = Path(tmpdir)
        if not has_pil():
            stack.enter_context(swapped(transforms, "decode_image", read_png))
        root = Path(__file__).resolve().parent
        shards = map_shards(np, tmp, np.random.default_rng(SEED + 71))
        sam_checkpoint(torch, backbone, tmp / "vit_b.pth")

        # the loader's host time per image, one thread, before the CLI runs start
        datas = [m for m in _tar_payloads(shards[0])]
        t_dec = t_res = 0.0
        for data in datas:
            a = time.perf_counter()
            img = transforms.decode_image(data)
            b = time.perf_counter()
            transforms.resize_bicubic_u8(img, MAP_SIZE, MAP_SIZE)
            t_res += time.perf_counter() - b
            t_dec += b - a
        n = len(datas)
        out["loader_ms_per_image"] = dict(decode=t_dec * 1e3 / n, resize=t_res * 1e3 / n)
        print(f"map path loader, host ms per image (one thread, {MAP_HW[0]}x{MAP_HW[1]} PNG "
              f"-> {MAP_SIZE}^2 BICUBIC): decode {t_dec * 1e3 / n:.1f}, "
              f"resize {t_res * 1e3 / n:.1f}, total {(t_dec + t_res) * 1e3 / n:.1f} "
              f"[{card}]", flush=True)

        # the CLI, in subprocesses: both loaders, the transient fault and the cut, at once
        t0 = time.perf_counter()
        runs = {"native": map_cli(root, tmp, "native"),
                "tarfile": map_cli(root, tmp, "tarfile", ["--no_native"]),
                "fault": map_cli(root, tmp, "fault", env={"TMR_FAULTS": MAP_FAULT}),
                "cut": map_cli(root, tmp, "cut", env={"TMR_FAULTS": MAP_CUT})}
        beside = threading.Thread(target=beside_clis or (lambda: None), daemon=True)
        beside.start()

        # the resume starts as soon as the cut run has died, beside the others
        wait_cli(*runs["cut"], "cut", want_rc=1)
        journal = ShardJournal(str(runs["cut"][1]["features"] / "_journal"))
        if sorted(journal.load_all()) != ["Easy_0.tar", "Normal_0.tar"]:
            fail(f"the cut run journaled {sorted(journal.load_all())}, expected shards 0-1")
        runs["resume"] = map_cli(root, tmp, "cut", ["--resume"])
        results = {}
        for tag in ("native", "tarfile", "fault", "resume"):
            wait_cli(*runs[tag], tag)
            results[tag] = cli_result(np, runs[tag][1], tag)
        cli_s = time.perf_counter() - t0
        beside.join()
        base = results["native"]
        print(f"map path CLI (map | tee | reduce: 4 runs at once, the resume once the cut "
              f"run has died: "
              f"{cli_s:.1f} s):\n{base['table']}", end="", flush=True)
        for tag, what in (("tarfile", "the tarfile loader's"), ("fault", "the fault run's"),
                          ("resume", "the resumed run's")):
            same = results[tag]["records"] == base["records"]
            print(f"map path: {what} records {'equal' if same else 'DIFFER from'} the "
                  f"native loader's uninterrupted run, byte for byte", flush=True)
            if not same:
                fail(f"map path: {what} records differ: {results[tag]['records']!r} vs "
                     f"{base['records']!r}")
        fault = results["fault"]["report"]["shards"][1]
        if (fault["status"], fault["attempts"]) != ("ok", 2):
            fail(f"map path: the transient fault was not retried to success: {fault}")
        resumed = results["resume"]["report"]["resumed"]
        if resumed != ["Easy_0.tar", "Normal_0.tar"]:
            fail(f"map path: the resume took {resumed} from the journal")
        files = feature_files(np, runs["native"][1]["features"])
        counted = int(base["report"]["totals"]["images"])
        side = MAP_SIZE // 16
        wrong = [k for k, v in files.items() if v.shape != (side, side, 256)
                 or v.dtype != np.float32 or not np.isfinite(v).all()]
        if len(files) != counted or counted != 3 * MAP_IMAGES or wrong:
            fail(f"map path: {len(files)} feature files for {counted} counted images, "
                 f"{len(wrong)} not finite ({side}, {side}, 256) float32")
        print(f"map path: {len(files)} feature files, ({side}, {side}, 256) float32, one per "
              f"counted image; the corrupt tar quarantined on its first attempt in every "
              f"run", flush=True)

        # in this process: the launches per batch, the encoder's device time, the busy
        # share and the images/s, on the native loader as the CLI runs it
        enc = mr.make_encode_stats_fn(backbone)
        enc(np.zeros((MAP_BATCH, MAP_SIZE, MAP_SIZE, 3), np.uint8))  # the batch-8 shapes, warm
        torch.cuda.synchronize()
        batches = []

        def timed(images):
            before = dict(_build.LAUNCHES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            res = enc(images)
            end.record()
            batches.append((start, end, {k: v - before[k] for k, v in
                                         _build.LAUNCHES.items()}))
            return res

        save, cleanup, sync = mr.make_feature_sinks(str(tmp / "features_timed"))
        _build.reset_launches()
        t0 = time.perf_counter()
        timed_acc = mr.run_stream_native([str(p) for p in shards], timed, MAP_BATCH, MAP_SIZE,
                                         save, 4, retry=mr.RetryPolicy(),
                                         cleanup_features=cleanup, sync_features=sync)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        dev = [a.elapsed_time(b) for a, b, _ in batches]
        wrong = [d for _, _, d in batches if d != MAP_BATCH_LAUNCHES]
        print(f"map path launches over {len(batches)} batches of {MAP_BATCH}: "
              f"{json.dumps(launches)} (per batch expected {json.dumps(MAP_BATCH_LAUNCHES)})",
              flush=True)
        if wrong or len(batches) != 2 * len(MAP_SHARDS):
            fail(f"map path: batches launched {wrong or len(batches)}, expected "
                 f"{MAP_BATCH_LAUNCHES} each over {2 * len(MAP_SHARDS)} batches")
        images = int(timed_acc.table[:, 4].sum())
        out.update(images=images, batches=len(batches), wall_s=wall,
                   images_per_s=images / wall, device_ms_per_batch=sum(dev) / len(dev),
                   device_ms_batches=dev, busy_share=sum(dev) / 1e3 / wall,
                   launches=launches, cli_s=cli_s)
        print(f"map path, in this process (native loader, 4 feeder threads, features "
              f"saved): {images} images in {wall:.3f} s = {images / wall:.2f} images/s; "
              f"encoder device ms per batch of {MAP_BATCH} (CUDA events) "
              f"{', '.join(f'{x:.2f}' for x in dev)}, mean {sum(dev) / len(dev):.2f}; "
              f"device busy share (events around each batch / wall) "
              f"{sum(dev) / 1e3 / wall:.3f} [{card}]", flush=True)
        if timed_acc.emit_lines() != base["records"].splitlines():
            print("map path: this process's records differ from the CLI's (another "
                  "process's encoder on the checkpoint's weights)", flush=True)

        # the same run with the attention through attention_plain on the card
        psave = mr.make_feature_sinks(str(tmp / "features_plain"))[0]
        with plain_attention(cuda_attn):
            plain_acc = mr.run_stream([str(p) for p in shards[:3]],
                                      mr.make_encode_stats_fn(backbone), MAP_BATCH, MAP_SIZE,
                                      psave, 4)
        got, want = feature_files(np, tmp / "features_timed"), feature_files(
            np, tmp / "features_plain")
        if sorted(got) != sorted(want):
            fail("map path: the attention_plain run wrote other feature files")
        worst = max(float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
                    for k in want)
        scale = plain_acc.table[:3, 1:2]
        table_err = float((np.abs(timed_acc.table[:3, :4] - plain_acc.table[:3, :4])
                           / scale).max())
        print(f"map path vs the same run with attention_plain on the card: features "
              f"worst max|diff| / max|plain| {worst:.4e}, table sums worst |diff| / std sum "
              f"{table_err:.4e} (tol {MAP_REL_TOL}); counts "
              f"{'equal' if np.array_equal(timed_acc.table[:, 4], plain_acc.table[:, 4]) else 'DIFFER'}",
              flush=True)
        if (worst > MAP_REL_TOL or table_err > MAP_REL_TOL
                or not np.array_equal(timed_acc.table[:3, 4], plain_acc.table[:3, 4])):
            fail("map path disagrees with the attention_plain run")
        out.update(features_vs_plain=worst, table_vs_plain=table_err)

        # extract_feature at batch 1 on a 720 x 1280 image
        rng = np.random.default_rng(SEED + 72)
        write_png(np, tmp / "wide.png", rng.integers(0, 256, EXTRACT_HW + (3,), np.uint8))
        times = []
        for i in range(2):
            _build.reset_launches()
            t0 = time.perf_counter()
            with ctx.redirect_stdout(io.StringIO()) as printed:
                stats = extract_feature.run_extraction_and_analyze(
                    str(tmp / "wide.png"), str(tmp / f"extract_{i}"), model=backbone,
                    image_size=MAP_SIZE)
            times.append((time.perf_counter() - t0) * 1e3)
            elaunch = dict(_build.LAUNCHES)
            if elaunch != MAP_BATCH_LAUNCHES:
                fail(f"extract_feature launched {elaunch}, expected {MAP_BATCH_LAUNCHES}")
        dump = np.load(stats["save_path"])
        if dump.shape != (1, side, side, 256) or dump.dtype != np.float32:
            fail(f"extract_feature dumped {dump.shape} {dump.dtype}")
        with plain_attention(cuda_attn), ctx.redirect_stdout(io.StringIO()):
            pstats = extract_feature.run_extraction_and_analyze(
                str(tmp / "wide.png"), str(tmp / "extract_plain"), model=backbone,
                image_size=MAP_SIZE)
        err = max(abs(stats[k] - pstats[k]) for k in ("mean", "std", "max", "sparsity"))
        print(f"extract_feature (batch 1, 720x1280 -> {MAP_SIZE}^2): {times[0]:.1f} ms cold, "
              f"{times[1]:.1f} ms warm (wall: preprocess, encoder, stats, .npy); launches "
              f"{json.dumps(elaunch)}; dump {dump.shape} {dump.dtype}; stats "
              f"{json.dumps({k: stats[k] for k in ('mean', 'std', 'max', 'sparsity')})}, "
              f"worst |diff| from the attention_plain run {err:.4e} (tol {MAP_REL_TOL} x "
              f"std {stats['std']:.4f}) [{card}]", flush=True)
        print(printed.getvalue(), end="", flush=True)
        if err > MAP_REL_TOL * stats["std"]:
            fail("extract_feature disagrees with the attention_plain run")
        out.update(extract_ms=times, extract_vs_plain=err)
        # what phase 5i's tcp:// run needs: shard Easy_0 and the CLI's features of it
        kit = {"shard": shards[0].read_bytes(),
               "features": {k: v for k, v in files.items()
                            if k.startswith("Easy/Easy_0/")}}
    torch.cuda.empty_cache()
    return out, timed_acc.emit_lines(), kit


#: phase 5h: each artifact call of the detector launches what one eval batch does; the
#: int8 artifact's the int8 path's batch (QUANT_LAUNCHES over its 3 batches, a third)
EXPORT_INT8_LAUNCHES = dict(EVAL_LAUNCHES, xcorr=0, xcorr_int8=1, int8_mm=1, int8_conv=1)
#: the SAM decoder artifact's prompt counts and the original size its masks take
EXPORT_DECODER_PROMPTS = (1, 5)
EXPORT_DECODER_HW = (720, 1280)


def export_op_samples(torch) -> dict:
    """One CUDA sample per ``tmr::`` op at a small shape its kernel takes (nothing
    requires grad), for ``torch.library.opcheck``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)

    def f32(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    bf = torch.bfloat16
    corner = f32(2, 40, 2).abs() * 4
    boxes = torch.cat([corner, corner + f32(2, 40, 2).abs() + 0.5], dim=-1)
    boxes = boxes[:, torch.argsort(f32(40))]
    return {
        "global_attn": (f32(4, 35, 64, dtype=bf), f32(4, 35, 64, dtype=bf),
                        f32(4, 35, 64, dtype=bf), f32(9, 64), f32(13, 64), 5, 7, 0.125),
        "window_attn": (f32(4, 49, 64, dtype=bf), f32(4, 49, 64, dtype=bf),
                        f32(4, 49, 64, dtype=bf), f32(7, 7, 64), f32(7, 7, 64), 7, 7,
                        0.125),
        "xcorr": (f32(2, 3, 24, 20), f32(2, 3, 5, 5)),
        "xcorr_int8": (i8(2, 3, 24, 20), i8(2, 3, 5, 5), f32(2, 3, 1, 1).abs() * 0.01,
                       f32(2, 3, 1, 1).abs() * 0.01),
        "nms": (boxes.contiguous(), torch.rand(2, 40, generator=gen, device="cuda") < 0.8,
                0.5),
        "int8_mm": (i8(6, 32), i8(5, 32), f32(6).abs(), f32(5).abs()),
        "int8_conv3x3": (i8(1, 5, 4, 16), f32(1).abs(), i8(3, 3, 6, 16),
                         f32(3, 3, 6).abs(), f32(6), 0.01),
        "add1": (f32(8, 8),),
    }


def timed_launches(torch, _build, fn, *args):
    """(output, ms of the call, launches of the call), the call bracketed by a
    synchronize."""
    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, {k: v - before[k] for k, v in _build.LAUNCHES.items()}


def all_equal(torch, got, want) -> bool:
    return len(got) == len(want) and all(
        g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
        for g, w in zip(got, want))


def check_export_path(torch, np, pred, batches, multi_batches, map_records, phase4_ms,
                      card, modules, export_dir: Path) -> dict:
    """Phase 5h: the port's ``torch.export`` artifacts (``utils/export.py``) on phase 4's
    weights. The encoder artifact (bf16 ViT-B, symbolic batch) traced on the card, saved
    and loaded back, against ``make_encode_stats_fn`` at batch 8 and the eager encoder at
    batches 1 and 3, and against the same encoder traced on the CPU and moved to the card;
    ``map --artifact`` (CLI) on shard Easy_0 against 5c's in-process record and the
    same map in this process timed; ``extract_feature --artifact``; the detector at batch
    4 and capacity 33, the multi-exemplar program (3 rows) on phase 4d's image 0 and the
    int8 detector, each against its eager call; the SAM decoder at 1 and 5 prompts; and
    ``torch.library.opcheck`` of every ``tmr::`` op on the card. Every comparison is bit
    for bit. The encoder artifact stays in ``export_dir`` for phase 5g's payload worker.
    Returns the numbers PERF.md keeps."""
    import contextlib as ctx
    import copy
    import io
    import os
    import tempfile

    from tmr_tpu_torch import extract_feature
    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.data import transforms
    from tmr_tpu_torch.inference import Predictor, detections_to_numpy
    from tmr_tpu_torch.models.vit import nhwc_features
    from tmr_tpu_torch.parallel import mapreduce as mr
    from tmr_tpu_torch.sam import Sam, SamDeployDecoder
    from tmr_tpu_torch.utils import export as ex

    (_build,) = modules
    t_phase = time.perf_counter()
    backbone = pred.model.backbone.eval()
    out = {}
    artifact = export_dir / "sam_vit_b_encoder.pt2"

    # ---- the encoder: traced on the card, saved, loaded back
    t0 = time.perf_counter()
    program = ex.export_encoder(backbone, image_size=MAP_SIZE)
    t1 = time.perf_counter()
    ex.save_exported(program, str(artifact))
    t2 = time.perf_counter()
    encode = ex.load_exported(str(artifact), "cuda")
    t3 = time.perf_counter()
    del program
    spec = ex.exported_input_spec(str(artifact))
    out["encoder"] = dict(export_s=t1 - t0, save_s=t2 - t1, load_s=t3 - t2,
                          mb=artifact.stat().st_size / 1e6)
    print(f"export path: encoder artifact (bf16 ViT-B, input {spec}) traced in "
          f"{t1 - t0:.1f} s, saved in {t2 - t1:.1f} s ({out['encoder']['mb']:.1f} MB), "
          f"loaded in {t3 - t2:.1f} s [{card}]", flush=True)
    if spec != (("b", MAP_SIZE, MAP_SIZE, 3), torch.float32):
        fail(f"the encoder artifact's input spec is {spec}")

    # map --artifact: the CLI (no checkpoint is read: the path holds none) over shard Easy_0
    # and the corrupt tar, in a directory of its own, beside the rest of this phase (whose
    # timings share the host with it); waited for at the end, killed if the phase fails
    cli_dir = tempfile.TemporaryDirectory()
    map_shards(np, Path(cli_dir.name), np.random.default_rng(SEED + 71), names=("Easy_0",))
    t_cli = time.perf_counter()
    proc, outs = map_cli(Path(__file__).resolve().parent, Path(cli_dir.name), "artifact",
                         ["--artifact", str(artifact)], names=["Easy_0.tar", "corrupt.tar"])
    atexit.register(lambda: proc.poll() is None and proc.kill())

    with tempfile.TemporaryDirectory() as tmpdir, ctx.ExitStack() as stack:
        tmp = Path(tmpdir)
        if not has_pil():
            stack.enter_context(swapped(transforms, "decode_image", read_png))
        shards = map_shards(np, tmp, np.random.default_rng(SEED + 71))
        payloads = _tar_payloads(shards[0])
        images = np.stack([mr.preprocess_image(d, MAP_SIZE) for d in payloads[:MAP_BATCH]])
        art_fn = mr.make_encode_stats_fn_from_artifact(str(artifact), "cuda")
        enc_fn = mr.make_encode_stats_fn(backbone)
        enc_fn(images)
        got, ms, launches = timed_launches(torch, _build, art_fn, images)
        want = enc_fn(images)
        print(f"export path: encoder artifact at batch {MAP_BATCH} on 5c's images vs "
              f"make_encode_stats_fn: features and statistics "
              f"{'equal' if all_equal(torch, got, want) else 'DIFFER'} bit for bit; "
              f"launches {json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
        if not all_equal(torch, got, want):
            fail("the encoder artifact's features or statistics differ from "
                 "make_encode_stats_fn's")
        if launches != MAP_BATCH_LAUNCHES:
            fail(f"the encoder artifact launched {launches}, expected {MAP_BATCH_LAUNCHES}")
        for b in (1, 3):
            x = torch.from_numpy(images[:b]).cuda().float() / 255.0
            with torch.inference_mode():
                eager = nhwc_features(backbone, x)
            same = torch.equal(encode(x), eager)
            print(f"export path: encoder artifact at batch {b} vs the eager encoder: "
                  f"{'equal' if same else 'DIFFER'} bit for bit", flush=True)
            if not same:
                fail(f"the encoder artifact differs from the eager encoder at batch {b}")

        # the same encoder traced on the CPU (fake tensors: no CPU arithmetic), moved
        t0 = time.perf_counter()
        cpu_program = ex.export_encoder(copy.deepcopy(backbone).cpu(), image_size=MAP_SIZE)
        cpu_s = time.perf_counter() - t0
        ex.save_exported(cpu_program, str(tmp / "encoder_cpu.pt2"))
        del cpu_program
        t0 = time.perf_counter()
        moved = ex.load_exported(str(tmp / "encoder_cpu.pt2"), "cuda")
        move_s = time.perf_counter() - t0
        x = torch.from_numpy(images).cuda().float() / 255.0
        same = torch.equal(moved(x), encode(x))
        print(f"export path: the encoder traced on the CPU in {cpu_s:.1f} s, loaded onto the "
              f"card in {move_s:.1f} s (move_to_device_pass): batch {MAP_BATCH} features "
              f"{'equal' if same else 'DIFFER from'} the card export's, bit for bit",
              flush=True)
        if not same:
            fail("the encoder traced on the CPU and moved gives other features")
        out["encoder"].update(cpu_export_s=cpu_s, cpu_load_move_s=move_s)
        del moved, x

        # the same map through the artifact in this process, timed as 5c times it
        dev = []

        def timed(images):
            before = dict(_build.LAUNCHES)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            res = art_fn(images)
            end.record()
            dev.append((start, end, {k: v - before[k] for k, v in _build.LAUNCHES.items()}))
            return res

        save, cleanup, sync = mr.make_feature_sinks(str(tmp / "features_artifact"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = mr.run_stream_native([str(p) for p in shards], timed, MAP_BATCH, MAP_SIZE,
                                   save, 4, retry=mr.RetryPolicy(),
                                   cleanup_features=cleanup, sync_features=sync)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = int(acc.table[:, 4].sum())
        dms = [a.elapsed_time(b) for a, b, _ in dev]
        wrong = [d for _, _, d in dev if d != MAP_BATCH_LAUNCHES]
        out["map"] = dict(images=n, wall_s=wall, images_per_s=n / wall,
                          device_ms_per_batch=sum(dms) / len(dms))
        print(f"export path: map through the artifact in this process (native loader, 4 "
              f"feeder threads, features saved): {n} images in {wall:.3f} s = "
              f"{n / wall:.2f} images/s; device ms per batch of {MAP_BATCH} "
              f"{', '.join(f'{v:.2f}' for v in dms)} [{card}]", flush=True)
        if wrong or acc.emit_lines() != map_records:
            fail(f"map through the artifact: launches {wrong}, records "
                 f"{acc.emit_lines()} vs {map_records}")

        # extract_feature --artifact at batch 1
        write_png(np, tmp / "wide.png", np.random.default_rng(SEED + 72).integers(
            0, 256, EXTRACT_HW + (3,), np.uint8))
        runs = {}
        for tag, kw in (("model", dict(model=backbone)), ("artifact", dict(
                artifact=str(artifact), device="cuda"))):
            with ctx.redirect_stdout(io.StringIO()):
                stats, ms, launches = timed_launches(
                    torch, _build, lambda: extract_feature.run_extraction_and_analyze(
                        str(tmp / "wide.png"), str(tmp / f"extract_{tag}"),
                        image_size=MAP_SIZE, **kw))
            runs[tag] = (stats, np.load(stats["save_path"]), launches, ms)
        same = (np.array_equal(runs["model"][1], runs["artifact"][1])
                and all(runs["model"][0][k] == runs["artifact"][0][k]
                        for k in ("mean", "std", "max", "sparsity")))
        print(f"export path: extract_feature --artifact (batch 1, {runs['artifact'][3]:.1f} "
              f"ms with the load) dump and statistics "
              f"{'equal' if same else 'DIFFER from'} the run without it, bit for bit; "
              f"launches {json.dumps({k: v for k, v in runs['artifact'][2].items() if v})}",
              flush=True)
        if not same or runs["artifact"][2] != MAP_BATCH_LAUNCHES:
            fail("extract_feature --artifact differs from the run without it")
    del encode, art_fn, enc_fn
    torch.cuda.empty_cache()

    # ---- the detector at batch 4, capacity 33, on phase 4's bucket-33 batch
    imgs, exs = batches[2]
    cap = pred.pick_capacity(exs, MAP_SIZE)
    t0 = time.perf_counter()
    det_path = export_dir / "detector.pt2"
    ex.save_exported(ex.export_detector(pred, cap, image_size=MAP_SIZE, batch=4),
                     str(det_path))
    det = ex.load_exported_detector(str(det_path), "cuda")
    det_s = time.perf_counter() - t0
    ti, te = torch.from_numpy(imgs).cuda(), torch.from_numpy(exs).cuda()
    det(ti, te)  # warm
    got, ms, launches = timed_launches(torch, _build, det, ti, te)
    want = pred(imgs, exs)
    same = all_equal(torch, got, [want[k] for k in ("boxes", "scores", "valid")])
    # in turns, both on the same device tensors (the eager call from numpy would time
    # its 50 MB upload too)
    times, eager = [], []
    for _ in range(3):
        times.append(timed_launches(torch, _build, det, ti, te)[1])
        eager.append(timed_launches(torch, _build, pred, ti, te)[1])
    out["detector"] = dict(capacity=cap, export_save_load_s=det_s,
                           mb=det_path.stat().st_size / 1e6, ms=times, eager_ms=eager,
                           launches=launches)
    print(f"export path: detector artifact (batch 4, capacity {cap}; traced, saved "
          f"{out['detector']['mb']:.1f} MB and loaded in {det_s:.1f} s): boxes, scores, valid "
          f"{'equal' if same else 'DIFFER from'} Predictor.__call__ bit for bit; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; ms per batch "
          f"{', '.join(f'{v:.1f}' for v in times)} beside the eager call's on the same device "
          f"tensors, in turns, {', '.join(f'{v:.1f}' for v in eager)} and phase 4's (from "
          f"numpy) {phase4_ms:.1f} [{card}]",
          flush=True)
    if not same or launches != EVAL_LAUNCHES or cap != 33:
        fail(f"the detector artifact differs from Predictor.__call__ or launched {launches}")
    det_path.unlink()
    del det

    # ---- the multi-exemplar program: 3 rows on phase 4d's image 0, k_real 3 and 2
    image0 = multi_batches[0][0][:1]
    rows = multi_batches[0][1][0]
    mcap = pred.pick_capacity(rows, MAP_SIZE)
    if pred.pick_capacity(rows[:2], MAP_SIZE) != mcap:
        fail("phase 4d's image 0 rows pick other buckets at 2 and 3 rows")
    mpath = export_dir / "detector_multi.pt2"
    ex.save_exported(ex.export_detector(pred, mcap, image_size=MAP_SIZE, n_exemplars=3),
                     str(mpath))
    mdet = ex.load_exported_detector(str(mpath), "cuda")
    for k in (3, 2):
        padded = np.concatenate([rows[:k], np.repeat(rows[k - 1:k], 3 - k, 0)])
        got, _, launches = timed_launches(
            torch, _build, mdet, torch.from_numpy(image0).cuda(),
            torch.from_numpy(padded).cuda(), torch.tensor(k, dtype=torch.int32,
                                                          device="cuda"))
        live = pred.predict_multi_exemplar(image0, padded, k_real=k)
        slot = live if k == 3 else pred.predict_multi_batch(image0, padded[None], [k])
        same = all_equal(torch, got, [slot[n] for n in ("boxes", "scores", "valid")])
        lists = detections_to_numpy({"boxes": got[0], "scores": got[1], "valid": got[2],
                                     "refs": slot["refs"]})
        same_lists = lists_equal(np, lists, detections_to_numpy(live))
        print(f"export path: multi-exemplar artifact (3 rows, capacity {mcap}) at k_real {k}: "
              f"{'equal' if same else 'DIFFERS from'} "
              f"{'predict_multi_exemplar' if k == 3 else 'predict_multi_batch at the same bucket'}"
              f" bit for bit, its lists {'equal' if same_lists else 'DIFFER from'} "
              f"predict_multi_exemplar's; launches "
              f"{json.dumps({n: v for n, v in launches.items() if v})}", flush=True)
        if not (same and same_lists) or launches != EVAL_LAUNCHES:
            fail(f"the multi-exemplar artifact differs at k_real {k}")
    mpath.unlink()
    del mdet

    # ---- the int8 detector (phase 4b's predictor on phase 4's weights)
    qpred = Predictor(preset("TMR_FSCD147", quant="int8", quant_storage="int8",
                             quant_kernel="int8"), device="cuda")
    qpred.load_state_dict(pred.model.state_dict())
    qpath = export_dir / "detector_int8.pt2"
    ex.save_exported(ex.export_detector(qpred, cap, image_size=MAP_SIZE, batch=4),
                     str(qpath))
    qdet = ex.load_exported_detector(str(qpath), "cuda")
    qdet(ti, te)
    got, _, launches = timed_launches(torch, _build, qdet, ti, te)
    want = qpred(imgs, exs)
    same = all_equal(torch, got, [want[k] for k in ("boxes", "scores", "valid")])
    qtimes, qeager = [], []
    for _ in range(3):
        qtimes.append(timed_launches(torch, _build, qdet, ti, te)[1])
        qeager.append(timed_launches(torch, _build, qpred, ti, te)[1])
    out["int8_detector"] = dict(ms=qtimes, eager_ms=qeager, mb=qpath.stat().st_size / 1e6,
                                launches=launches)
    print(f"export path: int8 detector artifact (batch 4, capacity {cap}, "
          f"{out['int8_detector']['mb']:.1f} MB): {'equal' if same else 'DIFFERS from'} its "
          f"eager call bit for bit; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; ms per batch "
          f"{', '.join(f'{v:.1f}' for v in qtimes)} beside the eager call's in turns "
          f"{', '.join(f'{v:.1f}' for v in qeager)} [{card}]", flush=True)
    if not same or launches != EXPORT_INT8_LAUNCHES:
        fail(f"the int8 detector artifact differs from its eager call or launched {launches}")
    qpath.unlink()
    del qdet, qpred
    torch.cuda.empty_cache()

    # ---- the SAM decoder on seeded Sam weights, n symbolic
    sam = Sam("vit_b", device="cuda").init_random(SEED)
    deploy = SamDeployDecoder(sam, return_single_mask=True)
    dpath = export_dir / "sam_decoder.pt2"
    ex.save_exported(ex.export_sam_decoder(deploy, (64, 64), num_points=2,
                                           orig_im_size=EXPORT_DECODER_HW), str(dpath))
    dec = ex.load_exported_decoder(str(dpath), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 91)
    emb = torch.randn(1, 64, 64, 256, generator=gen, device="cuda")
    for n in EXPORT_DECODER_PROMPTS:
        pts = torch.rand(n, 2, 2, generator=gen, device="cuda") * MAP_SIZE
        labels = torch.tensor([[1, -1]] * n, dtype=torch.int32, device="cuda")
        mask_in = torch.randn(n, 256, 256, 1, generator=gen, device="cuda")
        has = (torch.arange(n, device="cuda") % 2).float()
        got = dec(emb, pts, labels, mask_in, has)
        want = deploy(emb, pts, labels, mask_in, has, EXPORT_DECODER_HW)
        same = all_equal(torch, got, want)
        print(f"export path: SAM decoder artifact at {n} prompt(s): "
              f"{'equal' if same else 'DIFFERS from'} SamDeployDecoder.__call__ bit for bit "
              f"(masks {tuple(got[0].shape)})", flush=True)
        if not same:
            fail(f"the SAM decoder artifact differs at {n} prompts")
    dpath.unlink()
    del dec, deploy, sam

    # ---- opcheck of every tmr:: op on the card
    checked = []
    for name, args in export_op_samples(torch).items():
        torch.library.opcheck(getattr(torch.ops.tmr, name).default, args)
        checked.append(name)
    print(f"export path: torch.library.opcheck passed on the card for {checked}", flush=True)
    torch.cuda.empty_cache()

    wait_cli(proc, outs, "artifact")
    cli_s = out["map"]["cli_s"] = time.perf_counter() - t_cli
    res = cli_result(np, outs, "artifact")
    cli_dir.cleanup()
    want_rec = [r for r in map_records if r.startswith("Easy\t")]
    same = res["records"].splitlines() == want_rec
    print(f"export path: map --artifact (CLI over Easy_0 and the corrupt tar, {cli_s:.1f} s "
          f"from its start, beside the rest of the phase) records "
          f"{'equal' if same else 'DIFFER from'} phase 5c's in-process run's, byte for byte",
          flush=True)
    if not same:
        fail(f"map --artifact records differ: {res['records']!r} vs {want_rec!r}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"export path: phase wall {out['phase_s']:.1f} s [{card}]", flush=True)
    return out


#: phase 5g, the elastic map phase: 6 synthetic shards (a depth cut from the JAX elastic
#: gauntlet's 8) of 10 PNGs of 480 x 640, leased to workers that encode them at batch 8 on
#: the card
ELASTIC_SHARDS = ("Easy_0", "Easy_1", "Normal_0", "Normal_1", "Hard_0", "Hard_1")
#: lease knobs of the clean and resume runs (no straggler duplicates: a real encoder's
#: shard times spread with the host's load) and of the fault run (a TTL short enough that
#: a SIGSTOPped worker's lease goes stale within seconds)
ELASTIC_CLEAN = dict(lease_ttl_s=10.0, hb_interval_s=0.5, check_interval_s=0.1,
                     straggler_factor=0.0)
ELASTIC_FAULT = dict(ELASTIC_CLEAN, lease_ttl_s=3.0)
#: the fault run's subprocess workers pace each shard by 1 s at ``tar.open`` (a drill's
#: latency: no value changes), so that a lease picked while fresh is still held when the
#: signal lands
ELASTIC_PACE = "tar.open:latency=1.0"
#: a fresh lease: at most this many heartbeats in (0.5 s apart)
ELASTIC_FRESH_HB = 1
#: the resume run's coordinator is cut once this many shards hold a valid marker
ELASTIC_CUT_AFTER = 3
ELASTIC_WAIT_S = 180.0  # the bound of every wait of phase 5g


def log_tail(path: Path, n: int = 3000) -> str:
    return path.read_text(errors="replace")[-n:] if path.exists() else "(no log)"


def elastic_prog(root: Path, module: str) -> list:
    """``python -m module``, with the PNG reader swapped in where PIL is missing (the
    repo's root is appended to sys.path, so a payload on PYTHONPATH still wins)."""
    if has_pil():
        return [sys.executable, "-m", module]
    return [sys.executable, "-c", "import runpy, sys; sys.path.append(sys.argv.pop(1)); "
            "import chip_smoke; chip_smoke.use_png_reader(); runpy.run_module("
            f"{module!r}, run_name='__main__')", str(root)]


def elastic_worker(root: Path, address, wid: str, ckpt: Path, log: Path, pythonpath,
                   faults_spec: str = "", artifact: Path = None):
    """``python -m tmr_tpu_torch.elastic_map worker --device cuda`` in a subprocess, its
    output into ``log``; run from ``pythonpath`` (the checkout or an unpacked payload),
    with the checkpoint's weights or, given ``artifact``, the exported encoder in their
    place."""
    import os

    env = dict(os.environ, PYTHONPATH=str(pythonpath))
    env.pop("TMR_FAULTS", None)
    if faults_spec:
        env["TMR_FAULTS"] = faults_spec
    argv = elastic_prog(root, "tmr_tpu_torch.elastic_map") + [
        "worker", "--coordinator", f"{address[0]}:{address[1]}", "--worker_id", wid,
        *(["--artifact", str(artifact)] if artifact else ["--checkpoint", str(ckpt)]),
        "--device", "cuda", "--max_idle_s", "120"]
    with open(log, "w") as f:
        return subprocess.Popen(argv, cwd=str(pythonpath), env=env, stdout=f,
                                stderr=subprocess.STDOUT)


def elastic_coordinator_cli(root: Path, tmp: Path, features: Path, tag: str,
                            extra=()) -> tuple:
    """``python -m tmr_tpu_torch.elastic_map coordinator`` in a subprocess, the shard
    names on its stdin; returns (popen, address, stdout path, stderr path) once it says
    where it listens."""
    import os

    from tmr_tpu_torch.chaos_probe import poll

    names = tmp / "elastic_shards.txt"
    names.write_text("".join(f"{n}.tar\n" for n in ELASTIC_SHARDS))
    out, err = tmp / f"{tag}.records", tmp / f"{tag}.stderr"
    argv = elastic_prog(root, "tmr_tpu_torch.elastic_map") + [
        "coordinator", "--data_dir", str(tmp), "--features_out", str(features),
        "--image_size", str(MAP_SIZE), "--batch_size", str(MAP_BATCH), "--report_out",
        str(tmp / f"{tag}.report"), "--wait_timeout_s", str(ELASTIC_WAIT_S), *extra]
    env = dict(os.environ, PYTHONPATH=str(root), TMR_ELASTIC_TTL_S="10",
               TMR_ELASTIC_HB_S="0.5", TMR_ELASTIC_CHECK_S="0.1",
               TMR_ELASTIC_STRAGGLER_FACTOR="0")
    env.pop("TMR_FAULTS", None)
    with open(names) as stdin, open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(argv, cwd=str(root), env=env, stdin=stdin, stdout=fo,
                                stderr=fe)
    pattern = re.compile(r"shards at ([\d.]+):(\d+)")
    found = poll(lambda: pattern.search(err.read_text()) or proc.poll() is not None,
                 ELASTIC_WAIT_S, 0.05)
    if not isinstance(found, re.Match):
        proc.kill()
        fail(f"elastic {tag}: the coordinator CLI never said where it listens:\n"
             f"{log_tail(err)}")
    return proc, (found.group(1), int(found.group(2))), out, err


def elastic_thread(run_worker, address, wid: str, fn, retry, results: dict):
    """``run_worker`` on a thread of this process; its summary (or exception) lands in
    ``results[wid]``."""
    import threading

    def body():
        try:
            results[wid] = run_worker(address, wid, fn, retry=retry, max_idle_s=120.0)
        except BaseException as e:  # noqa: BLE001 - reported by the caller
            results[wid] = e

    t = threading.Thread(target=body, name=f"elastic-{wid}", daemon=True)
    t.start()
    return t


def join_thread(t, results: dict, wid: str) -> dict:
    t.join(timeout=ELASTIC_WAIT_S)
    got = results.get(wid)
    if t.is_alive() or not isinstance(got, dict):
        fail(f"elastic worker thread {wid} did not finish cleanly: "
             f"{'still running' if t.is_alive() else repr(got)}")
    return got


def wait_proc(proc, what: str, log: Path, want_rc=0) -> int:
    try:
        rc = proc.wait(timeout=ELASTIC_WAIT_S)
    except subprocess.TimeoutExpired:
        fail(f"{what} did not exit within {ELASTIC_WAIT_S} s:\n{log_tail(log)}")
    if want_rc is not None and rc != want_rc:
        fail(f"{what} exited with {rc}, expected {want_rc}:\n{log_tail(log)}")
    return rc


def elastic_records(mr, table) -> str:
    acc = mr.StatAccumulator()
    acc.table = table
    return "".join(line + "\n" for line in acc.emit_lines())


def check_elastic_doc(validate, doc: dict, tag: str, causes) -> None:
    problems = validate(doc)
    if problems:
        fail(f"elastic {tag}: elastic_report/v1 does not validate: {problems}")
    t = doc["totals"]
    if t["committed"] + t["resumed"] != len(ELASTIC_SHARDS) or t["quarantined"]:
        fail(f"elastic {tag}: not every shard committed or resumed: {t}")
    bad = [r for r in doc["reassignments"] if r.get("cause") not in causes]
    if bad:
        fail(f"elastic {tag}: reassignments without a cause of the closed list: {bad}")


def check_elastic_path(torch, np, pred, card, modules, artifact: Path) -> dict:
    """Phase 5g: the elastic map phase on phase 4's ViT-B weights (the SAM checkpoint
    phase 5c writes), bf16, 1024^2, batch 8, over 6 synthetic shards: the single-host
    CLI's table and feature tree first, then a clean run (the coordinator and one worker
    in this process, two worker processes, one of them from the payload zip with phase
    5h's encoder ``artifact`` in place of weights), a fault run (kill -9 and SIGSTOP) and
    a resume after a cut coordinator. Returns the numbers PERF.md keeps."""
    import contextlib as ctx
    import os
    import signal
    import tempfile

    from tmr_tpu_torch.chaos_probe import held_leases, poll
    from tmr_tpu_torch.chaos_probe import manifest as tree_digests
    from tmr_tpu_torch.data import transforms
    from tmr_tpu_torch.diagnostics import MAP_REASSIGN_CAUSES, validate_elastic_report
    from tmr_tpu_torch.models import build_sam_encoder
    from tmr_tpu_torch.parallel import mapreduce as mr
    from tmr_tpu_torch.parallel.elastic import ElasticCoordinator, ElasticPolicy, run_worker
    from tmr_tpu_torch.parallel.journal import ShardJournal
    from tmr_tpu_torch.utils.package import package_modules, payload_members, unpack_payload

    (_build,) = modules
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    out = {"shards": len(ELASTIC_SHARDS), "images_per_shard": MAP_IMAGES}
    procs = []  # every process this phase starts, stopped in the finally
    with tempfile.TemporaryDirectory() as tmpdir, ctx.ExitStack() as stack:
        tmp = Path(tmpdir)
        if not has_pil():
            stack.enter_context(swapped(transforms, "decode_image", read_png))
        try:
            # the payload zip, unpacked; its kernels built from its own csrc beside the
            # shards and the reference run
            zip_path = Path(package_modules(str(tmp / "Package_Modules.zip")))
            payload = Path(unpack_payload(str(zip_path), str(tmp / "payload")))
            build_log = tmp / "payload_build.log"
            with open(build_log, "w") as f:
                payload_build = subprocess.Popen(
                    [sys.executable, "-c", "from tmr_tpu_torch.ops import _build; "
                     "print(_build.build(('attn',)), _build.BUILD_DIR)"],
                    cwd=str(payload), env=dict(os.environ, PYTHONPATH=str(payload)),
                    stdout=f, stderr=subprocess.STDOUT)
            procs.append(payload_build)
            paths = [str(p) for p in map_shards(np, tmp, np.random.default_rng(SEED + 80),
                                                ELASTIC_SHARDS, corrupt=False)]
            ckpt = tmp / "vit_b.pth"
            sam_checkpoint(torch, pred.model.backbone, ckpt)

            # the reference: the single-host CLI over the same shards
            ref_proc, ref_out = map_cli(root, tmp, "single",
                                        names=[f"{n}.tar" for n in ELASTIC_SHARDS])
            procs.append(ref_proc)
            wait_cli(ref_proc, ref_out, "single", timeout=ELASTIC_WAIT_S)
            ref_records = ref_out["records"].read_text()
            ref_report = json.loads(ref_out["report"].read_text())
            ref_tree = tree_digests(ref_out["features"])
            ref_images = int(ref_report["totals"]["images"])
            if (ref_report["totals"]["ok"] != len(ELASTIC_SHARDS)
                    or ref_images != len(ELASTIC_SHARDS) * MAP_IMAGES
                    or len(ref_tree) != ref_images
                    or mr.format_stats_table(mr.reduce_lines(ref_records.splitlines()))
                    + "\n" != ref_out["table"].read_text()):
                fail(f"elastic path: the single-host reference run is not whole: "
                     f"{ref_report['totals']}, {len(ref_tree)} feature files")
            single_s = sum(r["wall_s"] for r in ref_report["shards"])
            wait_proc(payload_build, "the payload's kernel build", build_log)
            built = build_log.read_text().split()
            out["payload"] = dict(files=len(payload_members()),
                                  zip_kb=zip_path.stat().st_size / 1e3,
                                  attn_build_s=float(built[0]))
            print(f"elastic map path: payload zip {out['payload']['files']} files, "
                  f"{out['payload']['zip_kb']:.0f} kB, unpacked; attn.cu built from the "
                  f"payload's csrc into {built[1]} in {float(built[0]):.1f} s (beside the "
                  f"single-host run)", flush=True)

            # this process's worker: the checkpoint's encoder, each batch's launches
            enc = mr.make_encode_stats_fn(build_sam_encoder("vit_b", str(ckpt),
                                                            device="cuda"))
            batch_launches = []

            def counted(images):
                before = dict(_build.LAUNCHES)
                res = enc(images)
                batch_launches.append({k: v - before[k] for k, v in _build.LAUNCHES.items()})
                return res

            results = {}

            # ---- clean run: the coordinator and a worker here, two worker processes
            feats = tmp / "clean" / "features"
            coord = ElasticCoordinator(paths, str(feats / "_journal"), features_out=str(feats),
                                       image_size=MAP_SIZE, batch_size=MAP_BATCH,
                                       policy=ElasticPolicy(**ELASTIC_CLEAN))
            address = coord.start()
            logs = {w: tmp / f"{w}.log" for w in ("sub0", "payload1")}
            subs = {"sub0": elastic_worker(root, address, "sub0", ckpt, logs["sub0"], root),
                    "payload1": elastic_worker(root, address, "payload1", ckpt,
                                               logs["payload1"], payload,
                                               artifact=artifact)}
            procs.extend(subs.values())
            if not poll(lambda: set(subs) <= set(coord.state()["workers"]), ELASTIC_WAIT_S,
                        0.05):
                fail("elastic clean run: the worker processes never said hello:\n"
                     + "\n".join(f"{w}: {log_tail(p)}" for w, p in logs.items()))
            _build.reset_launches()
            t = elastic_thread(run_worker, address, "thread", counted, mr.RetryPolicy(),
                               results)
            if not coord.wait(timeout=ELASTIC_WAIT_S):
                fail(f"elastic clean run did not settle: {coord.state()}")
            t_settle = time.monotonic()
            torch.cuda.synchronize()
            clean_launches = dict(_build.LAUNCHES)
            summary = join_thread(t, results, "thread")
            for w, p in subs.items():
                wait_proc(p, f"elastic clean run worker {w}", logs[w])
            doc = coord.report()
            table = coord.table()
            first = min(s.first_granted_at for s in coord._shards if s.first_granted_at)
            coord.stop()
            check_elastic_doc(validate_elastic_report, doc, "clean run", MAP_REASSIGN_CAUSES)
            committed = {w: r["committed"] for w, r in doc["workers"].items()}
            walls = {w: [round(r["wall_s"], 3) for r in doc["shards"] if r["worker"] == w]
                     for w in committed}
            images = int(table[:, 4].sum())
            clean_s = t_settle - first
            print(f"elastic map path: single-host map (CLI, native loader, 4 feeder "
                  f"threads) {ref_images} images in {single_s:.3f} s of shard time = "
                  f"{ref_images / single_s:.2f} images/s; elastic clean run (3 workers: "
                  f"one thread here, sub0, payload1 from the payload zip with the encoder "
                  f"artifact; tarfile loader, "
                  f"one feeder each) {images} images in {clean_s:.3f} s from the first grant "
                  f"to the last commit = {images / clean_s:.2f} images/s [{card}]",
                  flush=True)
            print(f"elastic clean run: shards committed per worker {json.dumps(committed)}, "
                  f"each shard's s from grant to commit {json.dumps(walls)}; "
                  f"reassignments {len(doc['reassignments'])}; this process's worker "
                  f"launched {json.dumps(clean_launches)} over {len(batch_launches)} "
                  f"batches of {MAP_BATCH} (per batch expected "
                  f"{json.dumps(MAP_BATCH_LAUNCHES)})", flush=True)
            wrong = [b for b in batch_launches if b != MAP_BATCH_LAUNCHES]
            if (wrong or not batch_launches or len(batch_launches) != 2 * summary["leases"]
                    or clean_launches["global_attn"] <= 0
                    or clean_launches["window_attn"] <= 0):
                fail(f"elastic clean run: this process's worker launched {wrong or clean_launches} "
                     f"over {len(batch_launches)} batches for {summary['leases']} leases")
            idle = [w for w in ("thread", *subs) if committed.get(w, 0) < 1]
            if idle:
                fail(f"elastic clean run: workers {idle} committed no shard: {committed}")
            if elastic_records(mr, table) != ref_records:
                fail("elastic clean run: the table differs from the single-host table")
            if tree_digests(feats) != ref_tree:
                fail("elastic clean run: the feature tree differs from the single-host one")
            out["single_host"] = dict(images=ref_images, shard_s=single_s,
                                      images_per_s=ref_images / single_s)
            out["clean"] = dict(images=images, seconds=clean_s, images_per_s=images / clean_s,
                                committed=committed, shard_s=walls, launches=clean_launches,
                                batches=len(batch_launches),
                                reassignments=len(doc["reassignments"]))
            print("elastic clean run: the table and the feature tree equal the single-host "
                  "run's byte for byte; elastic_report/v1 valid", flush=True)

            # ---- fault run: kill -9 one worker process, SIGSTOP the other past the TTL
            feats = tmp / "fault" / "features"
            coord = ElasticCoordinator(paths, str(feats / "_journal"), features_out=str(feats),
                                       image_size=MAP_SIZE, batch_size=MAP_BATCH,
                                       policy=ElasticPolicy(**ELASTIC_FAULT))
            address = coord.start()
            flogs = {w: tmp / f"{w}.log" for w in ("fault0", "fault1")}
            fsubs = {w: elastic_worker(root, address, w, ckpt, flogs[w], root, ELASTIC_PACE)
                     for w in flogs}
            procs.extend(fsubs.values())

            def both_fresh():
                held = held_leases(coord)
                return held if all(w in held and held[w][2] <= ELASTIC_FRESH_HB
                                   for w in fsubs) else None

            held = poll(both_fresh, ELASTIC_WAIT_S)
            if not held:
                fail("elastic fault run: the two worker processes never held fresh leases "
                     "at once:\n" + "\n".join(f"{w}: {log_tail(p)}" for w, p in flogs.items()))
            # the victims by the leases they hold: the lower shard index is killed
            kill_wid, stop_wid = sorted(fsubs, key=lambda w: held[w][0])
            os.kill(fsubs[kill_wid].pid, signal.SIGKILL)
            os.kill(fsubs[stop_wid].pid, signal.SIGSTOP)
            t_stop = time.monotonic()
            t = elastic_thread(run_worker, address, "thread_f", enc, mr.RetryPolicy(),
                               results)

            def cause_for(index, cause, wid):
                return lambda: any(r["index"] == index and r["cause"] == cause
                                   and r["worker"] == wid
                                   for r in coord.state()["reassignments"])

            if not poll(cause_for(held[kill_wid][0], "worker_exit", kill_wid),
                        ELASTIC_WAIT_S):
                fail(f"elastic fault run: kill -9 of {kill_wid} brought no worker_exit "
                     f"reassignment: {coord.state()['reassignments']}")
            if not poll(cause_for(held[stop_wid][0], "stale_heartbeat", stop_wid),
                        ELASTIC_WAIT_S):
                fail(f"elastic fault run: the SIGSTOPped {stop_wid}'s lease was not revoked "
                     f"as stale_heartbeat: {coord.state()['reassignments']}")
            stopped_s = time.monotonic() - t_stop
            os.kill(fsubs[stop_wid].pid, signal.SIGCONT)
            if not poll(lambda: coord.state()["fenced_rejections"], ELASTIC_WAIT_S):
                fail(f"elastic fault run: the resumed {stop_wid} was never fenced:\n"
                     f"{log_tail(flogs[stop_wid])}")
            if not coord.wait(timeout=ELASTIC_WAIT_S):
                fail(f"elastic fault run did not settle: {coord.state()}")
            join_thread(t, results, "thread_f")
            wait_proc(fsubs[kill_wid], f"the killed {kill_wid}", flogs[kill_wid],
                      want_rc=-signal.SIGKILL)
            wait_proc(fsubs[stop_wid], f"the resumed {stop_wid}", flogs[stop_wid])
            doc = coord.report()
            table = coord.table()
            coord.stop()
            check_elastic_doc(validate_elastic_report, doc, "fault run", MAP_REASSIGN_CAUSES)
            causes = {}
            for r in doc["reassignments"]:
                causes[r["cause"]] = causes.get(r["cause"], 0) + 1
            fenced = doc["fenced_rejections"]
            committed = {w: r["committed"] for w, r in doc["workers"].items()}
            killed_rec = doc["shards"][held[kill_wid][0]]
            print(f"elastic fault run: kill -9 {kill_wid} holding shard {held[kill_wid][0]} "
                  f"(epoch {held[kill_wid][1]}); SIGSTOP {stop_wid} holding shard "
                  f"{held[stop_wid][0]} for {stopped_s:.2f} s (TTL "
                  f"{ELASTIC_FAULT['lease_ttl_s']} s), then SIGCONT; reassignments by cause "
                  f"{json.dumps(causes)}; fenced rejections {len(fenced)} "
                  f"{json.dumps([(r['worker'], r['shard'], r['epoch'], r['op']) for r in fenced])}; "
                  f"shards committed per worker {json.dumps(committed)}; the killed "
                  f"worker's shard committed by {killed_rec['worker']} at epoch "
                  f"{killed_rec['epoch']}", flush=True)
            if not fenced or killed_rec["worker"] == kill_wid \
                    or killed_rec["status"] != "committed":
                fail("elastic fault run: no fenced rejection, or the killed worker's shard "
                     "was not committed by another worker")
            if elastic_records(mr, table) != ref_records:
                fail("elastic fault run: the table differs from the single-host table")
            if tree_digests(feats) != ref_tree:
                fail("elastic fault run: the feature tree differs from the single-host one")
            out["fault"] = dict(reassignments=causes, fenced=len(fenced), committed=committed,
                                stopped_s=stopped_s, killed=kill_wid, stopped=stop_wid)
            print("elastic fault run: the table and the feature tree equal the single-host "
                  "run's byte for byte; every reassignment carries a cause", flush=True)

            # ---- resume: a coordinator CLI cut (kill -9) after some commits, then
            # --resume with one worker
            feats = tmp / "resume" / "features"
            journal = ShardJournal(str(feats / "_journal"))
            cproc, address, _, cerr = elastic_coordinator_cli(root, tmp, feats, "cut")
            procs.append(cproc)
            t = elastic_thread(run_worker, address, "thread_r1", enc,
                               mr.RetryPolicy(max_attempts=1), results)
            if not poll(lambda: len(journal.load_all()) >= ELASTIC_CUT_AFTER,
                        ELASTIC_WAIT_S):
                fail(f"elastic resume: no {ELASTIC_CUT_AFTER} markers before the cut:\n"
                     f"{log_tail(cerr)}")
            os.kill(cproc.pid, signal.SIGKILL)
            wait_proc(cproc, "the cut coordinator", cerr, want_rc=-signal.SIGKILL)
            join_thread(t, results, "thread_r1")
            marked = sorted(journal.load_all())
            if not ELASTIC_CUT_AFTER <= len(marked) < len(ELASTIC_SHARDS):
                fail(f"elastic resume: {len(marked)} shards marked at the cut")
            seen = set()

            def recorded(images):  # run_worker sets recorded.context to the leased shard
                seen.add(recorded.context)
                return enc(images)

            recorded.context = ""
            rproc, address, records, rerr = elastic_coordinator_cli(root, tmp, feats,
                                                                     "resume", ["--resume"])
            procs.append(rproc)
            t = elastic_thread(run_worker, address, "thread_r2", recorded, mr.RetryPolicy(),
                               results)
            wait_proc(rproc, "the resumed coordinator", rerr)
            join_thread(t, results, "thread_r2")
            rdoc = json.loads((tmp / "resume.report").read_text())
            check_elastic_doc(validate_elastic_report, rdoc, "resume", MAP_REASSIGN_CAUSES)
            unmarked = sorted({f"{n}.tar" for n in ELASTIC_SHARDS} - set(marked))
            print(f"elastic resume: coordinator cut (kill -9) with {len(marked)} shards "
                  f"marked {marked}; --resume with one worker: resumed "
                  f"{rdoc['resumed']}, re-encoded {sorted(seen)}", flush=True)
            if sorted(rdoc["resumed"]) != marked or sorted(seen) != unmarked:
                fail(f"elastic resume: resumed {rdoc['resumed']} and re-encoded "
                     f"{sorted(seen)}; expected {marked} and {unmarked}")
            if records.read_text() != ref_records:
                fail("elastic resume: the records differ from the single-host run's")
            if tree_digests(feats) != ref_tree:
                fail("elastic resume: the feature tree differs from the single-host one")
            out["resume"] = dict(marked=len(marked), reencoded=len(seen))
            print("elastic resume: the records and the feature tree equal the single-host "
                  "run's byte for byte", flush=True)
        finally:
            for p in procs:
                if p.poll() is None:
                    with ctx.suppress(OSError):
                        os.kill(p.pid, signal.SIGCONT)
                    p.kill()
                    p.wait(timeout=30)
    del enc
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"elastic map path: phase wall {out['phase_s']:.1f} s [{card}]", flush=True)
    return out


#: phase 5d: the refiner launches no kernel of the port's, so a refined batch launches
#: what one of phase 5's eval batches does; ``set_image`` the encoder's blocks alone
REFINE_LAUNCHES = EVAL_LAUNCHES
SAM_ENCODER_LAUNCHES = dict(EVAL_LAUNCHES, xcorr=0, nms=0)
#: the card's refinement against an f32 CPU run of the same refiner on the first
#: REFINE_CPU_SLOTS valid slots of image 0: a thresholded mask pixel may differ only where
#: the CPU's logit lies within REFINE_PIXEL_REL of its mask's largest |logit| (f32 sums in
#: another order); the boxes of slots whose masks agree within REFINE_BOX_TOL (normalized:
#: the boxes of equal masks are equal); scores within REFINE_SCORE_REL of the largest
REFINE_CPU_SLOTS = 32
#: the refined eval at num_exemplars 3 runs on 4 images made as phase 5's, 2 in each size
#: bucket (a depth cut: at 3 exemplars each refined image is its own batch, 0.6-3.8 s)
REFINE_K3_SIDES = (30, 12, 38, 14)
REFINE_PIXEL_REL = 1e-4
REFINE_BOX_TOL = 1e-6
REFINE_SCORE_REL = 1e-5
SAM_IMAGE_HW = (720, 1280)
#: the mask generator's point grid: 8 x 8 points, one decode batch of 64, quality
#: filters open (the weights are random, so predicted IoUs say nothing)
AMG_POINTS_PER_SIDE = 8


def decoder_flops(h: int, w: int, d: int = 256, mlp: int = 2048, tokens: int = 7,
                  depth: int = 2, mask_tokens: int = 4) -> float:
    """Multiply-adds x 2 of one box prompt through the mask decoder on an h x w grid:
    the two-way blocks (token self-attention, both cross-attentions at d / 2, the token
    MLP), the final attention, the two transposed convs, the hypernetworks and the mask
    product (``models/sam_decoder.py``)."""
    n, di = h * w, d // 2
    self_attn = 4 * 2 * tokens * d * d + 2 * 2 * tokens * tokens * d
    t2i = 2 * tokens * d * di + 2 * 2 * n * d * di + 2 * 2 * tokens * n * di \
        + 2 * tokens * di * d
    i2t = 2 * n * d * di + 2 * 2 * tokens * d * di + 2 * 2 * n * tokens * di \
        + 2 * n * di * d
    block = self_attn + t2i + 2 * 2 * tokens * d * mlp + i2t
    upscale = 2 * n * d * d + 2 * (4 * n) * (d // 4) * (d // 8 * 4)
    hyper = mask_tokens * 2 * (2 * d * d + d * d // 8)
    masks = 2 * mask_tokens * (16 * n) * (d // 8)
    return float(depth * block + t2i + upscale + hyper + masks)


def full_logits(torch, refiner, feature, boxes_px, size: int, step: int = 16):
    """The full-size mask logits (M, size, size) of box prompts, ``step`` at a time."""
    from tmr_tpu_torch.models.sam_decoder import resize_align_corners

    with torch.inference_mode():
        pe = refiner.prompt_encoder.dense_pe(feature.shape[1:3])
        return torch.cat([resize_align_corners(
            refiner._decode(feature, pe, boxes_px[s:s + step], (size, size))[0],
            (size, size)) for s in range(0, boxes_px.shape[0], step)])


def check_refine_vs_cpu(torch, refiner, dets0, feature, card, size: int) -> dict:
    """The card's ``refine`` of a batch (``card``, from ``dets0`` and ``feature``)
    against an f32 CPU run of the same refiner on image 0's first REFINE_CPU_SLOTS valid
    slots; invalid slots unchanged bit for bit and refs the box centres on every image."""
    import copy

    inv = ~dets0["valid"]
    same_inv = (torch.equal(card["boxes"][inv], dets0["boxes"][inv])
                and torch.equal(card["scores"][inv], dets0["scores"][inv]))
    b = card["boxes"]
    centres = torch.equal(card["refs"], torch.stack([(b[..., 0] + b[..., 2]) / 2,
                                                     (b[..., 1] + b[..., 3]) / 2], -1))
    idx = torch.nonzero(dets0["valid"][0])[:REFINE_CPU_SLOTS, 0]
    if idx.numel() < REFINE_CPU_SLOTS:
        fail(f"refine: image 0 has {idx.numel()} valid slots, the check takes "
             f"{REFINE_CPU_SLOTS}")
    cpu_ref = copy.deepcopy(refiner).cpu()
    sub = {k: dets0[k][:1].cpu().clone() for k in ("boxes", "scores", "refs", "valid")}
    sub["valid"][:] = False
    sub["valid"][0, idx.cpu()] = True
    feat0 = feature[:1].float().cpu()
    t0 = time.perf_counter()
    cpu_out = cpu_ref.refine(feat0, sub, (size, size))
    cpu_s = time.perf_counter() - t0
    got_b, want_b = card["boxes"][0, idx].cpu(), cpu_out["boxes"][0, idx.cpu()]
    got_s, want_s = card["scores"][0, idx].cpu(), cpu_out["scores"][0, idx.cpu()]
    px = dets0["boxes"][0, idx].float() * size
    lg_card = full_logits(torch, refiner, feature[:1].float(), px, size).cpu()
    lg_cpu = full_logits(torch, cpu_ref, feat0, px.cpu(), size)
    near = lg_cpu.abs() < REFINE_PIXEL_REL * lg_cpu.abs().flatten(1).amax(1)[:, None, None]
    differ = (lg_card > 0) != (lg_cpu > 0)
    agree = ~differ.flatten(1).any(1)
    out = {
        "slots": int(idx.numel()),
        "pixels_differ": int(differ.sum()),
        "pixels_differ_outside_band": int((differ & ~near).sum()),
        "masks_agree": int(agree.sum()),
        "box_max_abs_diff": float((got_b - want_b).abs()[agree].max()) if agree.any()
        else 0.0,
        "score_max_diff_rel": float((got_s - want_s).abs().max() / want_s.abs().max()),
        "logit_max_abs_diff_rel": float(((lg_card - lg_cpu).abs().flatten(1).amax(1)
                                         / lg_cpu.abs().flatten(1).amax(1)).max()),
        "invalid_unchanged": same_inv, "refs_are_centres": centres,
        "cpu_s": cpu_s}
    print(f"refine vs an f32 CPU run, image 0's first {out['slots']} valid slots at "
          f"{size}^2: mask pixels that differ {out['pixels_differ']} of "
          f"{differ.numel()}, outside the |logit| < {REFINE_PIXEL_REL} x max band "
          f"{out['pixels_differ_outside_band']} (must be 0); masks equal "
          f"{out['masks_agree']}; their boxes' max_abs_diff {out['box_max_abs_diff']:.3e} "
          f"(tol {REFINE_BOX_TOL}); scores {out['score_max_diff_rel']:.3e} of the max "
          f"(tol {REFINE_SCORE_REL}); logits {out['logit_max_abs_diff_rel']:.3e} of each "
          f"mask's max; invalid slots unchanged {same_inv}, refs the centres {centres} "
          f"({cpu_s:.1f} s on the CPU)", flush=True)
    if (out["pixels_differ_outside_band"] or out["box_max_abs_diff"] > REFINE_BOX_TOL
            or out["score_max_diff_rel"] > REFINE_SCORE_REL or not same_inv
            or not centres):
        fail("the card's refinement disagrees with the f32 CPU run")
    return out


def refine_parts_ms(torch, refiner, feature, boxes_px, size: int) -> dict:
    """One chunk of ``refiner.chunk`` box prompts on image 0, by CUDA events: the whole
    ``_decode_chunk``, the prompt encoder and two-way transformer, the whole decoder,
    beside the chunk's bound (its operations at the f32 peak)."""
    md, pe_mod = refiner.mask_decoder, refiner.prompt_encoder
    hw = tuple(feature.shape[1:3])
    with torch.inference_mode():
        pe = pe_mod.dense_pe(hw)
        sparse, dense = pe_mod(boxes_px, (size, size), hw)
        n = boxes_px.shape[0]
        tokens = torch.cat([torch.cat([md.iou_token, md.mask_tokens])[None].expand(
            n, -1, -1), sparse], 1)
        src = feature.expand(n, -1, -1, -1) + dense
        pos = pe[None].expand(src.shape)
        out = {
            "chunk_ms": cuda_ms(lambda: refiner._decode_chunk(
                feature, pe, boxes_px, (size, size), (size, size)), reps=5),
            "decoder_ms": cuda_ms(lambda: refiner._decode(feature, pe, boxes_px,
                                                          (size, size)), reps=5),
            "transformer_ms": cuda_ms(lambda: md.transformer(src, pos, tokens), reps=5),
        }
    out["upscale_ms"] = out["decoder_ms"] - out["transformer_ms"]
    out["resize_boxes_ms"] = out["chunk_ms"] - out["decoder_ms"]
    flops = decoder_flops(*hw) * n
    out["bound_ms"], out["bound_by"] = bound(flops, feature.numel() * 4, PEAK_F32_FLOPS)
    out["prompts"] = n
    return out


def check_refine_path(torch, np, pred, batches, multi_batches, card, phase4_ms,
                      eval_rates, modules, profile=False) -> dict:
    """Phase 5d: SAM box refinement (``build_refiner`` with seed 0) on phase 4's weights:
    one batch of phase 4 through ``Predictor.__call__`` with ``refine_box`` (launches,
    ms with and without refinement in turns, the NMS keep mask on refined boxes, the
    refiner against an f32 CPU run, a chunk's parts), ``predict_multi_batch`` on a batch
    of phase 4d (launches; the device tail's lists), ``_get_heads_fn`` against the fused
    call, ``Trainer.test`` with the refiner (num_exemplars 1 on phase 5's split, 3 on
    :data:`REFINE_K3_SIDES`), and the segment-anything surface on phase 4's encoder and
    the refiner's decoder."""
    import dataclasses
    import os
    import tempfile

    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.inference import Predictor, detections_to_numpy
    from tmr_tpu_torch.refine import build_refiner
    from tmr_tpu_torch.train.state import compute_losses

    _build, cuda_nms = modules
    cfg = dataclasses.replace(pred.cfg, refine_box=True)
    refiner = build_refiner(cfg, seed=SEED, device="cuda")
    rpred = Predictor(cfg, device="cuda", model=pred.model, refiner=refiner)
    imgs, ex = batches[2]
    size = imgs.shape[1]
    cap = rpred.pick_capacity(ex, size)
    out = {"chunk": refiner.chunk}

    # one refined batch: its launches and prompts, then ms with and without, in turns
    rpred(imgs, ex)
    torch.cuda.synchronize()
    _build.reset_launches()
    with call_count(refiner, "_decode") as decodes:
        fused = rpred(imgs, ex)
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    prompts = sum(int(args[2].shape[0]) for args, _ in decodes)
    print(f"refined batch (bucket {cap}): launches {json.dumps(launches)} (the refiner "
          f"launches none of the port's kernels); {prompts} box prompts in "
          f"{len(decodes)} chunks of <= {refiner.chunk}", flush=True)
    if launches != REFINE_LAUNCHES:
        fail(f"refined batch launches {launches}, expected {REFINE_LAUNCHES}")
    turns = {"plain": [], "refined": []}
    for name, p in (("plain", pred), ("refined", rpred), ("refined", rpred),
                    ("plain", pred)):
        t0 = time.perf_counter()
        p(imgs, ex)
        torch.cuda.synchronize()
        turns[name].append((time.perf_counter() - t0) * 1e3)
    plain_ms, refined_ms = (sum(v) / 2 for v in (turns["plain"], turns["refined"]))
    out.update(prompts=prompts, chunks=len(decodes), plain_ms=plain_ms,
               refined_ms=refined_ms, refine_ms=refined_ms - plain_ms,
               ms_per_prompt=(refined_ms - plain_ms) / prompts)
    print(f"refined batch of 4 at 1024, in turns (plain, refined, refined, plain): "
          f"{refined_ms:.1f} ms with refinement, {plain_ms:.1f} ms without "
          f"({' '.join(f'{v:.1f}' for v in turns['refined'])} / "
          f"{' '.join(f'{v:.1f}' for v in turns['plain'])}); the refinement "
          f"{out['refine_ms']:.1f} ms, {out['ms_per_prompt'] * 1e3:.1f} us a prompt "
          f"[{card}]", flush=True)
    check_main_path_nms(torch, lambda: rpred(imgs, ex), cuda_nms, "refined batch")

    # the refiner alone on the card against the CPU, and a chunk's parts
    with torch.inference_mode():
        img_dev = torch.as_tensor(imgs, device="cuda")
        ex_dev = torch.as_tensor(ex, device="cuda")
        mout = pred.model(img_dev, ex_dev, cap)
        dets0 = pred._decode(mout, ex_dev[:, 0, :])
        feature = mout["backbone_feature"]
        card_out = refiner.refine(feature, dets0, (size, size))
    out["cpu_check"] = check_refine_vs_cpu(torch, refiner, dets0, feature, card_out, size)
    idx = torch.nonzero(dets0["valid"][0])[:refiner.chunk, 0]
    parts = refine_parts_ms(torch, refiner, feature[:1].float().contiguous(),
                            dets0["boxes"][0, idx] * size, size)
    out["chunk_parts"] = parts
    print(f"refiner, one chunk of {parts['prompts']} box prompts on a 64^2 grid at "
          f"{size}^2: {parts['chunk_ms']:.3f} ms (prompt encoder + two-way transformer "
          f"{parts['transformer_ms']:.3f}, upscaling and masks "
          f"{parts['upscale_ms']:.3f}, full-size resize, threshold and boxes "
          f"{parts['resize_boxes_ms']:.3f}); bound {parts['bound_ms']:.3f} ms "
          f"({parts['bound_by']}, f32 peak) [{card}]", flush=True)
    if profile:
        profile_batch(torch, lambda: rpred(imgs, ex), "refined path")

    # the multi and split programs with the refiner
    mimgs, mex = multi_batches[0]
    k_real = np.array(MULTI_K_REAL, np.int32)
    _build.reset_launches()
    t0 = time.perf_counter()
    multi = rpred.predict_multi_batch(mimgs, mex, k_real)
    torch.cuda.synchronize()
    out["multi_ms"] = (time.perf_counter() - t0) * 1e3
    mlaunches = dict(_build.LAUNCHES)
    want_launches = {k: v // 3 for k, v in MULTI_LAUNCHES.items()}
    dpred = Predictor(dataclasses.replace(cfg, decode_tail="device"), device="cuda",
                      model=pred.model, refiner=refiner)
    same_tail = lists_equal(np, detections_to_numpy(multi),
                            detections_to_numpy(dpred.predict_multi_batch(mimgs, mex,
                                                                          k_real)))
    feats = rpred._get_backbone_fn()(imgs)
    split = rpred._get_heads_fn(cap, size)(feats, ex)
    torch.cuda.synchronize()
    diff = [f for f in ("boxes", "scores", "refs", "valid")
            if not torch.equal(split[f], fused[f])]
    print(f"refined multi batch (4 images x 3 exemplars, k_real {MULTI_K_REAL}, "
          f"{multi['valid'].shape[1]} union slots an image): {out['multi_ms']:.1f} ms "
          f"[{card}]; launches {json.dumps(mlaunches)}; the device tail's lists equal the "
          f"host tail's: {same_tail}; heads on the backbone's features vs the fused call, "
          f"fields that differ bit for bit: {diff or 'none'}", flush=True)
    if mlaunches != want_launches:
        fail(f"refined multi batch launches {mlaunches}, expected {want_launches}")
    if not same_tail or diff:
        fail("refined multi or split programs differ from the call made another way")

    # eval with refinement on phase 5's split
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        splits = {1: eval_split(np, os.path.join(tmp, "fsc1")),
                  3: eval_split(np, os.path.join(tmp, "fsc3"), REFINE_K3_SIDES)}
        base = preset("TMR_FSCD147", eval=True, num_workers=4, refine_box=True)
        state_dict = pred.model.state_dict()
        for k, images in splits.items():
            with in_memory_images(images):
                kcfg = dataclasses.replace(base, logpath=os.path.join(tmp, f"log{k}"),
                                           datapath=os.path.join(tmp, f"fsc{k}"),
                                           num_exemplars=k, eval_batch_size=4)
                metrics, records, wall, tr = run_eval(torch, kcfg, pred.model, state_dict,
                                                      _build, pred.device, refiner)
                name = f"eval with refinement num_exemplars={k}"
                rates[k] = check_eval_run(torch, np, tr.predictor, tr, name, metrics,
                                          records, wall, phase4_ms, card, compute_losses,
                                          detections_to_numpy)
                print(f"{name}: {rates[k]:.2f} img/s end to end beside phase 5's "
                      f"{eval_rates[k]:.2f} (warm, without refinement) [{card}]",
                      flush=True)
                del records, tr
    out["eval_img_s"] = rates
    out["phase5_eval_img_s"] = dict(eval_rates)
    out["sam"] = check_sam_surface(torch, np, pred, refiner, card, _build)
    return out


def check_sam_surface(torch, np, pred, refiner, card, _build) -> dict:
    """The segment-anything surface on phase 4's ViT-B encoder and the refiner's prompt
    encoder and mask decoder: ``SamPredictor`` on one 720 x 1280 image (``set_image``
    launches global 4 and window 8, nothing else; a box and a point prompt each give a
    mask of the original size), then ``SamAutomaticMaskGenerator.generate`` (its NMS
    through the port's kernel)."""
    from tmr_tpu_torch.sam import Sam, SamAutomaticMaskGenerator, SamPredictor

    sam = Sam("vit_b", device="cuda")
    state = {"image_encoder." + k: v for k, v in pred.model.backbone.state_dict().items()}
    state.update(refiner.state_dict())
    sam.load_state_dict(state)
    rng = np.random.default_rng(SEED + 17)
    h, w = SAM_IMAGE_HW
    img = rng.uniform(0, 60, (h, w, 3)).astype(np.uint8)
    for y, x, side in ((100, 200, 160), (400, 700, 120), (250, 1000, 200)):
        img[y:y + side, x:x + side] = (200, 180, 40)
    sp = SamPredictor(sam)
    sp.set_image(img)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    sp.set_image(img)
    torch.cuda.synchronize()
    set_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.LAUNCHES)
    masks = {}
    prompts = {"box": dict(box=np.array([190.0, 90.0, 370.0, 270.0], np.float32)),
               "point": dict(point_coords=np.array([[760.0, 460.0]], np.float32),
                             point_labels=np.array([1], np.int32))}
    predict_ms = {}
    for name, kw in prompts.items():
        sp.predict(**kw)  # warm-up
        t0 = time.perf_counter()
        masks[name] = sp.predict(**kw)
        predict_ms[name] = (time.perf_counter() - t0) * 1e3
    ok = all(m.shape == (h, w) and m.dtype == bool and math.isfinite(iou)
             for m, iou in masks.values())
    print(f"SamPredictor on {h} x {w}: set_image {set_ms:.1f} ms, launches "
          f"{json.dumps(launches)}; predict (host clock, the resize to the original on the "
          f"host included) box {predict_ms['box']:.1f} ms, point "
          f"{predict_ms['point']:.1f} ms; masks {[m.shape for m, _ in masks.values()]}, "
          f"pixels {[int(m.sum()) for m, _ in masks.values()]}, IoU "
          f"{[round(i, 4) for _, i in masks.values()]} [{card}]", flush=True)
    if launches != SAM_ENCODER_LAUNCHES or not ok:
        fail(f"SamPredictor: launches {launches} (expected {SAM_ENCODER_LAUNCHES}) or "
             "masks not of the original size")
    amg = SamAutomaticMaskGenerator(sam, points_per_side=AMG_POINTS_PER_SIDE,
                                    points_per_batch=64, pred_iou_thresh=-1e9,
                                    stability_score_thresh=-1.0)
    _build.reset_launches()
    t0 = time.perf_counter()
    records = amg.generate(img)
    torch.cuda.synchronize()
    amg_s = time.perf_counter() - t0
    alaunches = dict(_build.LAUNCHES)
    ok = bool(records) and all(r["segmentation"].shape == (h, w) for r in records)
    print(f"SamAutomaticMaskGenerator ({AMG_POINTS_PER_SIDE}^2 points, quality filters "
          f"open): {len(records)} masks in {amg_s:.2f} s per image, launches "
          f"{json.dumps(alaunches)} [{card}]", flush=True)
    want = dict(SAM_ENCODER_LAUNCHES, nms=1)
    if alaunches != want or not ok:
        fail(f"mask generator: launches {alaunches} (expected {want}) or no mask of the "
             "image's size")
    return {"set_image_ms": set_ms, "predict_ms": predict_ms, "amg_s": amg_s,
            "amg_masks": len(records)}


#: phase 4e: exemplar sides that land in buckets 9, 17 and 33 on the default detector's
#: 64^2 map (16 px a cell); the launches of one of its batches (the ResNet is cuDNN's:
#: one correlation and one NMS); the range the seeded ResNet-50 feature's std must lie in
DEFAULT_SIDES_PX = {9: 112, 17: 240, 33: 480}
DEFAULT_LAUNCHES = dict(EVAL_LAUNCHES, global_attn=0, window_attn=0)
FEATURE_STD_RANGE = (1e-2, 1e2)
#: phase 5e: epochs of ``Trainer.fit`` on phase 5b's split (2 steps of 4 images each), and
#: the launches of a prototype train step: kernel 5 forward and its d_feature backward
DEFAULT_TRAIN_EPOCHS = 2
PROTOTYPE_STEP_LAUNCHES = dict(DEFAULT_LAUNCHES, xcorr=2, nms=0)


def check_default_path(torch, np, card, modules, profile=False):
    """Phase 4e: the JAX ``main.py`` default detector, ``Predictor(Config())``, on seeded
    weights over 3 batches of 4 hitting buckets 9, 17 and 33 on its 64^2 map, then the
    same with prototype templates. Returns (the numbers PERF.md keeps, the predictor,
    the prototype predictor on the same weights)."""
    import dataclasses

    from tmr_tpu_torch.config import Config
    from tmr_tpu_torch.inference import Predictor, detections_to_numpy

    _build, cuda_nms, cuda_xcorr = modules
    cfg = Config()
    pred = Predictor(cfg, device="cuda")
    pred.init_params(SEED)
    rng = np.random.default_rng(SEED + 20)
    batches = [synthetic_batch(np, rng, DEFAULT_SIDES_PX[b]) for b in (9, 17, 33)]
    caps = [pred.pick_capacity(ex, 1024) for _, ex in batches]
    if caps != [9, 17, 33] or pred.feature_hw(1024) != 64:
        fail(f"default detector: buckets {caps} on a {pred.feature_hw(1024)}^2 map, "
             "expected [9, 17, 33] on 64^2")
    times, outs, launches = run_batches(torch, pred, batches, detections_to_numpy, _build)
    report_batches(np, "default path", caps, times, outs, card)
    want = {k: 3 * v for k, v in DEFAULT_LAUNCHES.items()}
    print(f"default path launches over the 3 batches: {json.dumps(launches)}", flush=True)
    if launches != want:
        fail(f"default path launches {launches}, expected {want}")
    check_main_path_nms(torch, lambda: pred(*batches[0]), cuda_nms, "default path batch 0")

    # image 0 against an f32 CPU run: the ResNet's feature (f32 on cuDNN under the
    # caller's TF32 setting) and the objectness (bf16 heads)
    imgs, ex = batches[0]
    out = pred.forward(imgs, ex)
    feat = out["backbone_feature"][0].float().cpu()
    obj = out["objectness"][0].float().cpu()
    std = feat.std().item()
    ref = Predictor(dataclasses.replace(cfg, compute_dtype="float32"), device="cpu")
    ref.model.load_state_dict({k: v.cpu() for k, v in pred.model.state_dict().items()})
    t0 = time.perf_counter()
    ref_out = ref.forward(imgs[:1], ex[:1])
    cpu_s = time.perf_counter() - t0
    ref_feat, ref_obj = ref_out["backbone_feature"][0], ref_out["objectness"][0]
    feat_diff = (feat - ref_feat).abs().max().item()
    feat_rms = ((feat - ref_feat).pow(2).mean().sqrt() / ref_feat.pow(2).mean().sqrt()).item()
    obj_diff, scale = (obj - ref_obj).abs().max().item(), ref_obj.abs().max().item()
    tf32 = torch.backends.cudnn.allow_tf32
    print(f"default path image 0 vs an f32 CPU run ({cpu_s:.1f} s on the CPU): ResNet-50 "
          f"feature {tuple(feat.shape)} std {std:.4f} (finite: "
          f"{bool(torch.isfinite(feat).all())}, range {FEATURE_STD_RANGE}), max_abs_diff "
          f"{feat_diff:.4e} = {feat_diff / ref_feat.abs().max().item():.4e} of its max, "
          f"relative rms {feat_rms:.4e}, cuDNN TF32 convolutions allowed: {tf32}; "
          f"objectness max_abs_diff {obj_diff:.4e}, map max {scale:.4e}, tol {OBJ_REL_TOL} "
          f"x max [{card}]", flush=True)
    lo, hi = FEATURE_STD_RANGE
    if not (torch.isfinite(feat).all() and lo <= std <= hi):
        fail(f"the seeded ResNet-50 feature is not finite or its std {std} is out of range")
    if not (torch.isfinite(obj).all() and obj.shape == (64, 64)
            and obj_diff <= OBJ_REL_TOL * scale):
        fail("default path objectness disagrees with the f32 CPU reference")
    del ref

    # the split programs and the device tail against the fused call
    backbone, heads = pred._get_backbone_fn(), pred._get_heads_fn(caps[0], 1024)
    feats = backbone(imgs)
    split, fused = heads(feats, ex), pred(imgs, ex)
    dpred = Predictor(dataclasses.replace(cfg, decode_tail="device"), device="cuda",
                      model=pred.model)
    dev = dpred(imgs, ex)
    torch.cuda.synchronize()
    diff = [f for f in ("boxes", "scores", "refs", "valid")
            if not torch.equal(split[f], fused[f])]
    same_tail = lists_equal(np, detections_to_numpy(fused), detections_to_numpy(dev))
    print(f"default path split programs (features {tuple(feats.shape)}): fields that "
          f"differ from the fused call bit for bit {diff or 'none'}; the device tail's "
          f"lists equal the host tail's: {same_tail}", flush=True)
    if diff or not same_tail:
        fail("the default path's split programs or device tail differ from the fused call")

    # where a batch's time goes: the ResNet alone, and the rest by kernel
    img_dev = torch.as_tensor(imgs, device="cuda")
    batch_ms = cuda_ms(lambda: pred(img_dev, ex))
    resnet_ms = cuda_ms(lambda: backbone(img_dev))
    dev_resnet = profiled_device_ms(torch, lambda: backbone(img_dev), reps=5)
    by_kernel = profiled_kernels_ms(torch, lambda: heads(feats, ex), reps=5)
    k5 = sum(v for k, v in by_kernel.items() if "xcorr" in k)
    nms = sum(v for k, v in by_kernel.items() if "nms_" in k)
    rest = sum(by_kernel.values()) - k5 - nms
    print(f"default path batch 0 (bucket 9), images on the card: {batch_ms:.2f} ms per "
          f"batch, the ResNet alone {resnet_ms:.2f} ms = {resnet_ms / batch_ms:.3f} of it; "
          f"device ms by the profiler: ResNet "
          f"{'not measured' if dev_resnet is None else f'{dev_resnet:.3f}'}, heads "
          f"(input_proj, matcher, decoders, decode) {rest:.3f}, kernel 5 {k5:.4f}, NMS "
          f"{nms:.4f} [{card}]", flush=True)
    if profile:
        profile_batch(torch, lambda: pred(*batches[2]), "default path")

    # the same batches with prototype templates: kernel 5 at T = 1 every call
    ppred = Predictor(dataclasses.replace(cfg, template_type="prototype"), device="cuda")
    ppred.load_state_dict(pred.model.state_dict())
    with call_count(cuda_xcorr, "xcorr") as calls:
        ptimes, pouts, plaunches = run_batches(torch, ppred, batches, detections_to_numpy,
                                               _build)
    report_batches(np, "default path, prototype templates", caps, ptimes, pouts, card)
    sizes = sorted({tuple(args[1].shape[-2:]) for args, _ in calls})
    print(f"default path, prototype templates: launches over the 3 batches "
          f"{json.dumps(plaunches)}; template sizes handed to kernel 5 {sizes}",
          flush=True)
    if plaunches != want or sizes != [(1, 1)]:
        fail(f"prototype launches {plaunches} (expected {want}) or templates {sizes} "
             "(expected only 1 x 1)")
    out = dict(ms=sum(times) / 3, batch_ms=times, resnet_ms=resnet_ms,
               resnet_share=resnet_ms / batch_ms, device_resnet_ms=dev_resnet,
               device_heads_ms=rest, device_xcorr_ms=k5, device_nms_ms=nms,
               feature_std=std, feature_rel_rms=feat_rms, cudnn_tf32=tf32,
               obj_rel=obj_diff / scale, prototype_ms=sum(ptimes) / 3)
    return out, pred, ppred


def check_default_train_eval(torch, np, pred, ppred, card, phase4e_ms, modules) -> dict:
    """Phase 5e: ``Trainer.test`` of the default detector on phase 5's split, then
    ``Trainer.fit`` of ``Config()`` from its weights, then one prototype train step
    through kernel 5's Function against the plain version's autograd."""
    import dataclasses
    import os
    import tempfile

    from tmr_tpu_torch.config import Config
    from tmr_tpu_torch.inference import detections_to_numpy
    from tmr_tpu_torch.ops import xcorr as xcorr_ops
    from tmr_tpu_torch.train import loop
    from tmr_tpu_torch.train.state import TrainState, compute_losses
    from tmr_tpu_torch.utils.checkpoint import best_checkpoint
    from tmr_tpu_torch.utils.convert import load_matching_net

    _build, cuda_xcorr = modules
    out = {}
    state_dict = {k: v.detach().clone() for k, v in pred.model.state_dict().items()}
    with tempfile.TemporaryDirectory() as tmp:
        images = eval_split(np, os.path.join(tmp, "fsc"))
        base = Config(dataset="FSCD147", datapath=os.path.join(tmp, "fsc"), eval=True,
                      num_workers=4, eval_batch_size=4)
        rates = {}
        with in_memory_images(images):
            for k in (1, 3):
                cfg = dataclasses.replace(base, logpath=os.path.join(tmp, f"log{k}"),
                                          num_exemplars=k)
                metrics, records, wall, tr = run_eval(torch, cfg, pred.model, state_dict,
                                                      _build, pred.device)
                rates[k] = check_eval_run(torch, np, pred, tr, f"default eval "
                                          f"num_exemplars={k}", metrics, records, wall,
                                          phase4e_ms, card, compute_losses,
                                          detections_to_numpy, DEFAULT_LAUNCHES)
                del records, tr
    out["eval_img_s"] = rates

    # Trainer.fit: the backbone trains at lr_backbone, roi_align at capacity 191 (FFT)
    steps, evals = [], []
    make_step = loop.make_train_step

    def recording_make_step(model, cfg):
        step = make_step(model, cfg)

        def run(state, batch):
            torch.cuda.synchronize()
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            losses = step(state, batch)
            torch.cuda.synchronize()
            steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                              launches={k: v - before[k] for k, v in _build.LAUNCHES.items()},
                              loss=float(losses["loss"]),
                              skipped=float(losses["skipped_nonfinite"])))
            return losses

        return run

    class RecordingTrainer(loop.Trainer):
        def _eval_batch(self, batch):
            before = dict(_build.LAUNCHES)
            res = super()._eval_batch(batch)
            evals.append({k: v - before[k] for k, v in _build.LAUNCHES.items()})
            return res

    with tempfile.TemporaryDirectory() as tmp:
        images = eval_split(np, os.path.join(tmp, "fsc"), TRAIN_SIDES, TRAIN_IMAGES)
        cfg = Config(dataset="FSCD147", datapath=os.path.join(tmp, "fsc"), num_workers=4,
                     seed=SEED, batch_size=4, eval_batch_size=4,
                     max_epochs=DEFAULT_TRAIN_EPOCHS, logpath=os.path.join(tmp, "fit"))
        loop.make_train_step = recording_make_step
        try:
            with in_memory_images(images):
                torch.cuda.reset_peak_memory_stats()
                tr = RecordingTrainer(cfg, device="cuda", model=pred.model)
                t0 = time.perf_counter()
                tr.fit(params=state_dict)
                fit_s = time.perf_counter() - t0
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                it = iter(tr._loaders()[0])
                batch = next(it)
                it.close()
                # main's order: fit, then test() on the best checkpoint fit wrote, read
                # back through the Lightning loader (a ResNet encoder's keys)
                best = best_checkpoint(cfg.logpath)
                n_resnet = sum(k.startswith("backbone.layer")
                               for k in load_matching_net(best))
                ckpt_metrics = tr.test()
        finally:
            loop.make_train_step = make_step
    zero = dict(DEFAULT_LAUNCHES, xcorr=0, nms=0)
    losses = [r["loss"] for r in steps]
    labels = tr.state.labels
    got = dict(pred.model.named_parameters())
    moved = {lab: sum(not torch.equal(got[n], state_dict[n]) for n in got if labels[n] == lab)
             for lab in ("backbone", "frozen", "head")}
    counts = {lab: sum(v == lab for v in labels.values()) for lab in moved}
    warm = [r["ms"] for r in steps[1:]]
    each = ", ".join(f"{r['ms']:.1f}" for r in steps)
    print(f"default train path: {len(steps)} steps of 4 images at 1024, ms per step "
          f"{each} (warm mean "
          f"{sum(warm) / len(warm):.1f}, {4e3 * len(warm) / sum(warm):.2f} images/s); "
          f"peak device memory {peak_gb:.2f} GB; fit {fit_s:.1f} s with validation at "
          f"epoch 0; losses {', '.join(f'{x:.4f}' for x in losses)}; tensors moved by "
          f"group {json.dumps(moved)} of {json.dumps(counts)}; step launches "
          f"{steps[0]['launches']}, validation launches {evals[0] if evals else None} "
          f"[{card}]", flush=True)
    if any(r["launches"] != zero for r in steps) or len(steps) != 2 * DEFAULT_TRAIN_EPOCHS:
        fail(f"default train steps launched {[r['launches'] for r in steps]}, expected "
             f"{2 * DEFAULT_TRAIN_EPOCHS} x none")
    if not evals or any(e != DEFAULT_LAUNCHES for e in evals):
        fail(f"default validation batches launched {evals}, expected {DEFAULT_LAUNCHES}")
    if not all(math.isfinite(x) for x in losses) or any(r["skipped"] for r in steps):
        fail(f"default train losses {losses}, skipped {[r['skipped'] for r in steps]}")
    if moved["frozen"] or moved["backbone"] < counts["backbone"] // 2 or not moved["head"]:
        fail(f"the backbone did not train, or its batch norm statistics moved: {moved}")
    print(f"default train path: test() on {os.path.basename(best)} ({n_resnet} ResNet "
          f"tensors read by the Lightning loader): {json.dumps(ckpt_metrics)}", flush=True)
    if not n_resnet or not all(math.isfinite(v) for v in ckpt_metrics.values()):
        fail(f"test() after fit: {n_resnet} ResNet tensors, metrics {ckpt_metrics}")
    out.update(step_ms=steps, warm_step_ms=sum(warm) / len(warm), peak_gb=peak_gb,
               fit_s=fit_s, losses=losses)

    # one prototype train step through kernel 5's Function; its gradients at the step's
    # own inputs against the autograd of the plain version in f32
    seen = {}

    class RecordingXCorr:
        @staticmethod
        def apply(feature, template):
            res = cuda_xcorr.XCorr.apply(feature, template)
            seen.update(feature=feature.detach().clone(), template=template.detach().clone())
            res.register_hook(lambda g: seen.__setitem__("g", g.detach().clone()))
            return res

    pcfg = dataclasses.replace(cfg, template_type="prototype", eval=False)
    ts = TrainState(ppred.model, pcfg, steps_per_epoch=100)
    step = loop.make_train_step(ppred.model, pcfg)
    with swapped(xcorr_ops, "XCorr", RecordingXCorr):
        step(ts, batch)  # first call: allocator and cuDNN plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        losses = step(ts, batch)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
    plaunches = dict(_build.LAUNCHES)
    ppeak = torch.cuda.max_memory_allocated() / 1e9
    f, t, g = seen["feature"], seen["template"], seen["g"]
    grads = cuda_xcorr.xcorr_backward(f, t, g)
    fr, tr_ = f.clone().requires_grad_(), t.clone().requires_grad_()
    want = torch.autograd.grad(cuda_xcorr.xcorr_plain(fr, tr_), (fr, tr_), g)
    errs = grads_err(grads, want)
    print(f"default prototype train step: {pms:.1f} ms for 4 images at 1024 (warm), peak "
          f"device memory {ppeak:.2f} GB, loss {float(losses['loss']):.4f}; launches "
          f"{json.dumps(plaunches)}; kernel 5 at {tuple(f.shape)} T={t.shape[-1]}: "
          f"d_feature max_err {errs[0][0]:.3e} of max {errs[0][1]:.3e}, d_template "
          f"max_err {errs[1][0]:.3e} of max {errs[1][1]:.3e} (tol {XCORR_REL_TOL} x max) "
          f"[{card}]", flush=True)
    if plaunches != PROTOTYPE_STEP_LAUNCHES or t.shape[-1] != 1:
        fail(f"prototype train step launches {plaunches} at T={t.shape[-1]}, expected "
             f"{PROTOTYPE_STEP_LAUNCHES} at T=1")
    if not (math.isfinite(float(losses["loss"])) and float(losses["skipped_nonfinite"]) == 0
            and all(e <= XCORR_REL_TOL * m for e, m in errs)):
        fail(f"prototype train step: loss {float(losses['loss'])} or kernel 5's gradients "
             f"{errs} disagree with the plain version's autograd")
    out.update(prototype_step_ms=pms, prototype_peak_gb=ppeak, prototype_grad_err=errs)
    return out


#: phase 5f: the serving engine's batch bound and latency bound (the JAX engine's
#: defaults), its client threads, and the overload engine's in-flight bound with a burst
#: of 5x it
SERVE_BATCH = 4
SERVE_MAX_WAIT_MS = 10.0
SERVE_CLIENTS = 4
SERVE_ADMIT = 4
SERVE_BURST = 5 * SERVE_ADMIT
SERVE_DRAIN_S = 120.0  # close()'s drain bound in phase 5f
SERVE_WAIT_S = 300.0  # every future's timeout
#: the seven pipeline stages a traced request carries (the JAX TRACE_SERVE_STAGES)
SERVE_STAGES = ("serve.submit", "serve.queue_wait", "serve.batch_assemble", "serve.stage",
                "serve.execute", "serve.postprocess", "serve.resolve")


def serve_waves(batches, multi_batches):
    """Phase 5f's traffic, three waves of (image, exemplars, submit kwargs): (A) the 12
    single-exemplar requests of phase 4's batches (buckets 9, 17, 33) and the 12
    multi-exemplar ones of phase 4d (k 3, real rows 3, 3, 2, 1); (B) every other request
    of A again (result-cache hits) and 8 of A's single images with a new exemplar (row 1
    of phase 4d's, same bucket: the second sighting, which promotes the image and runs
    the heads path with a fill); (C) 4 of those images with a third exemplar (row 2:
    feature-cache hits, the heads path without the encoder)."""
    singles = [(imgs[i], ex[i], {}) for imgs, ex in batches for i in range(4)]
    multis = [(imgs[i], ex[i], dict(multi=True, k_real=int(MULTI_K_REAL[i])))
              for imgs, ex in multi_batches for i in range(4)]
    second = [(imgs[i], ex[i, 1:2], {}) for imgs, ex in multi_batches for i in range(4)
              if MULTI_K_REAL[i] > 1][:8]
    third = [(imgs[i], ex[i, 2:3], {}) for imgs, ex in multi_batches[:2] for i in range(4)
             if MULTI_K_REAL[i] > 2]
    return [singles + multis, singles[::2] + multis[::2] + second, third]


def serve_clients(engine, requests, latencies=None, clients=SERVE_CLIENTS):
    """``requests`` submitted by ``clients`` threads (round-robin shares, each submitted
    back to back); returns the futures in request order. ``latencies`` collects each
    future's submit-to-resolve seconds (a done callback: taken when it resolves)."""
    import threading

    futs = [None] * len(requests)

    def client(idx):
        for i in idx:
            img, ex, kw = requests[i]
            t0 = time.perf_counter()
            futs[i] = engine.submit(img, ex, **kw)
            if latencies is not None:
                futs[i].add_done_callback(
                    lambda f, t0=t0: latencies.append(time.perf_counter() - t0))

    threads = [threading.Thread(target=client, args=(range(c, len(requests), clients),))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return futs


def capture_serving(pred, engine):
    """Record what the engine's dispatch thread hands the ``Predictor``'s programs
    (``_get_fn``, ``_get_multi_batched_fn``, ``_get_heads_fn``: the name, the key and the
    input tensors of each call, in dispatch order) and what its completion thread
    finishes (each batch's bucket, requests, fill rows and staged images, in the same
    order). Returns (calls, finished, restore)."""
    calls, finished = [], []

    def wrap(name):
        getter = getattr(type(pred), name)

        def get(*key):
            prog = getter(pred, *key)

            def run(*args):
                calls.append((name, key, args))
                return prog(*args)
            return run
        return get

    for name in ("_get_fn", "_get_multi_batched_fn", "_get_heads_fn"):
        setattr(pred, name, wrap(name))
    finish = engine._finish

    def finishing(staged, *rest):
        finished.append((staged.bucket, list(staged.requests), list(staged.fill_index),
                         staged.images))
        return finish(staged, *rest)

    engine._finish = finishing

    def restore():
        for name in ("_get_fn", "_get_multi_batched_fn", "_get_heads_fn"):
            delattr(pred, name)
        del engine._finish
    return calls, finished, restore


def quantiles_ms(vals) -> dict:
    s = sorted(vals)
    pick = lambda q: s[min(len(s) - 1, int(math.ceil(q * len(s))) - 1)] * 1e3  # noqa: E731
    return {"p50": pick(0.50), "p95": pick(0.95), "p99": pick(0.99)}


def first_variant_module(torch, model, run_batch, run_one):
    """The first module, in execution order, whose output for row 0 differs bit for bit
    between a batched forward and the same row alone, with its class; None when none."""
    records = {}

    def hook(name):
        def fn(mod, _inp, out):
            out = out[0] if isinstance(out, (tuple, list)) else out
            if torch.is_tensor(out):
                records.setdefault(name, (type(mod).__name__, []))[1].append(
                    out[:1].clone())
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n]
    try:
        with torch.inference_mode():
            run_batch()
            order = list(records)
            run_one()
    finally:
        for h in handles:
            h.remove()
    for name in order:
        cls, (a, *rest) = records[name]
        if rest and a.shape == rest[-1].shape and not torch.equal(a, rest[-1]):
            return f"{name} ({cls})"
    return None


def check_serve_path(torch, np, pred, batches, multi_batches, card, phase4_ms, modules,
                     profile=False) -> dict:
    """Phase 5f: ``tmr_tpu_torch.serve.ServeEngine`` on phase 4's ViT-B predictor at 1024:
    clean traffic from 4 client threads (launches per executed batch, served results
    against the same program on the engine's padded stack and against sequential B = 1
    calls, counters), a burst of 5x an admission bound, one traced request's seven
    spans, and ``health()``."""
    from tmr_tpu_torch import obs
    from tmr_tpu_torch.diagnostics import validate_health_report
    from tmr_tpu_torch.obs import tracing
    from tmr_tpu_torch.serve import AdmissionController, RejectedError, ServeEngine
    from tmr_tpu_torch.serve.staging import _pad_to

    (_build,) = modules
    fields = ("boxes", "scores", "refs", "valid")
    waves = serve_waves(batches, multi_batches)
    n_req = sum(len(w) for w in waves)
    out = {"requests": n_req, "batch": SERVE_BATCH, "max_wait_ms": SERVE_MAX_WAIT_MS,
           "clients": SERVE_CLIENTS}

    # clean traffic
    t0 = time.perf_counter()
    engine = ServeEngine(pred, batch=SERVE_BATCH, max_wait_ms=SERVE_MAX_WAIT_MS)
    out["engine_start_s"] = time.perf_counter() - t0  # the weights' digest, once
    calls, finished, restore = capture_serving(pred, engine)
    torch.cuda.synchronize()
    _build.reset_launches()
    latencies, futs = [], []
    t0 = time.perf_counter()
    for wave in waves:
        wave_futs = serve_clients(engine, wave, latencies)
        for f in wave_futs:
            f.result(timeout=SERVE_WAIT_S)
        futs += wave_futs
    wall = time.perf_counter() - t0
    restore()
    launches = dict(_build.LAUNCHES)
    c, stats = engine.counters, engine.stats()
    hist = engine.metrics_snapshot()["histograms"]["serve.request_latency_s"]
    health = engine.health()
    # one traced request on the warm engine (a new image): all seven stages
    rng = np.random.default_rng(SEED + 5)
    size = batches[0][0].shape[1]
    timg, tex = synthetic_batch(np, rng, BUCKET_SIDES_PX[17] * size // 1024, b=1,
                                size=size)
    tracing.clear()
    tracing.configure(enabled=True)
    try:
        engine.submit(timg[0], tex[0]).result(timeout=SERVE_WAIT_S)
    finally:
        tracing.configure(enabled=False)
    spans = tracing.spans()
    tid = next(s["trace"] for s in spans if s["name"] == "serve.submit")
    stage_ms = {s["name"]: s["dur"] * 1e3 for s in spans if s["trace"] == tid}
    missing = [s for s in SERVE_STAGES if s not in stage_ms]
    print("serving spans of one traced request: " + ", ".join(
        f"{s[6:]} {stage_ms[s]:.2f} ms" for s in SERVE_STAGES if s in stage_ms)
        + f"; missing {missing or 'none'}", flush=True)
    if missing:
        fail(f"a traced request lacks the spans {missing}")
    tracing.clear()
    out["spans_ms"] = stage_ms
    engine.close(timeout=SERVE_DRAIN_S)
    print(f"serving, clean traffic: {n_req} requests from {SERVE_CLIENTS} client threads "
          f"in 3 waves; counters {json.dumps(c)}", flush=True)
    if c["errors"] or c["batch_fallbacks"] or c["rejected"]:
        fail(f"serving: errors {c['errors']}, batch fallbacks {c['batch_fallbacks']}, "
             f"rejected {c['rejected']} in clean traffic (0 expected)")

    # the counters reconcile with the batches the engine finished
    kinds = [b[0][0] for b in finished]
    riders = sum(len(r.futures) for b in finished for r in b[1])
    rows = sum(len(b[1]) for b in finished)
    padded = sum(_pad_to(len(b[1]), SERVE_BATCH) - len(b[1]) for b in finished)
    hits = stats["result_cache"]["hits"]
    fills = sum(len(b[2]) for b in finished)
    checks = {
        "submitted": (c["submitted"], n_req),
        "completed": (c["completed"], n_req),
        "batches": (c["batches"], len(finished)),
        "program calls": (len(calls), len(finished)),
        "riders + result-cache hits": (riders + hits, n_req),
        "coalesced": (c["coalesced"], riders - rows),
        "padded_slots": (c["padded_slots"], padded),
        "heads_batches": (c["heads_batches"], kinds.count("heads")),
        "feature_fills": (c["feature_fills"], fills),
    }
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if c["submitted"] != c["completed"] + c["rejected"] + c["errors"] or bad:
        fail(f"serving counters do not reconcile: {bad}")
    fused = kinds.count("single") + kinds.count("multi")
    filled = sum(1 for b in finished if b[0][0] == "heads" and b[2])
    want = {name: 0 for name in _build.LAUNCHES}
    want.update(global_attn=4 * (fused + filled), window_attn=8 * (fused + filled),
                xcorr=len(finished), nms=len(finished))
    print(f"serving launches {json.dumps(launches)}; expected from {fused} fused batches "
          f"(4 / 8 / 1 / 1 each), {kinds.count('heads')} heads batches (xcorr 1, nms 1; "
          f"the encoder's 4 / 8 in the {filled} with fills), 0 for {hits} result-cache "
          f"hits", flush=True)
    if launches != want:
        fail(f"serving launches {launches}, expected {want}")

    # each served result against the same program on the engine's padded stack
    mism = []
    for (name, key, args), (bucket, reqs, fill, images) in zip(calls, finished):
        with torch.inference_mode():
            again = getattr(type(pred), name)(pred, *key)(*args)
            if fill:
                feats = type(pred)._get_backbone_fn(pred)(images)
                if not torch.equal(feats[:len(fill)], args[0][fill]):
                    mism.append((bucket, "fill features"))
        for i, r in enumerate(reqs):
            got = r.futures[0].result(timeout=SERVE_WAIT_S)
            for f in fields:
                if not np.array_equal(got[f], again[f][i:i + 1].cpu().numpy()):
                    mism.append((bucket, i, f))
    print(f"serving: every served result vs the same program on the engine's padded "
          f"stack ({len(finished)} batches), fields that differ bit for bit: "
          f"{len(mism)} (must be 0)", flush=True)
    if mism:
        fail(f"served results differ from their programs on the padded stack: {mism[:5]}")

    # batch invariance, measured: every request that reached the card against a
    # sequential B = 1 call of the Predictor (a heads request against the fused call)
    def sequential(r):
        if r.bucket[0] == "multi":
            return pred.predict_multi_exemplar(np.stack([r.image]), r.exemplars,
                                               k_real=r.k_real)
        return pred(np.stack([r.image]), np.stack([r.exemplars]))

    inv = {"requests": 0, "differ": 0, "valid_mismatch": 0, "max_score_diff": 0.0,
           "max_box_diff": 0.0, "differing": []}
    firsts = {}  # the first differing row of each (kind, batch size, with a fill)
    for (name, key, args), (bucket, reqs, fill, _) in zip(calls, finished):
        for i, r in enumerate(reqs):
            got = r.futures[0].result(timeout=SERVE_WAIT_S)
            one = {k: v.cpu().numpy() for k, v in sequential(r).items() if k in fields}
            inv["requests"] += 1
            if all(np.array_equal(got[k], one[k]) for k in fields):
                continue
            inv["differ"] += 1
            both = got["valid"] & one["valid"]
            inv["valid_mismatch"] += int((got["valid"] != one["valid"]).sum())
            inv["max_score_diff"] = max(inv["max_score_diff"], float(
                np.abs(got["scores"] - one["scores"])[both].max(initial=0.0)))
            inv["max_box_diff"] = max(inv["max_box_diff"], float(
                np.abs(got["boxes"] - one["boxes"])[both].max(initial=0.0)))
            size = int(args[0].shape[0])
            inv["differing"].append(f"{bucket[0]} cap {bucket[2]} k {bucket[3]}: row {i} "
                                    f"of {size}")
            group = f"{bucket[0]} at B = {size}" + (" with a fill" if fill else "")
            firsts.setdefault(group, (name, key, args, i, r))
    # the module that first breaks the equality, per group: the request's batch with its
    # row moved to the front (the same program at the same size) against the B = 1 call
    inv["first_variant_layer"] = {}
    for group, (name, key, args, i, r) in firsts.items():
        perm = torch.tensor([i] + [j for j in range(int(args[0].shape[0])) if j != i],
                            device=pred.device)
        prog = getattr(type(pred), name)(pred, *key)
        inv["first_variant_layer"][group] = first_variant_module(
            torch, pred.model, lambda: prog(*[a[perm] for a in args]),
            lambda: sequential(r)) or "none of the model's modules: the decode and NMS tail"
    out["batch_invariance"] = inv
    print(f"serving batch invariance: {inv['differ']} of {inv['requests']} requests on "
          f"the card differ from a sequential B = 1 call (valid slots that flip "
          f"{inv['valid_mismatch']}, largest score difference {inv['max_score_diff']:.3e},"
          f" box {inv['max_box_diff']:.3e} over slots valid in both): {inv['differing']}; "
          f"first module to break the equality: {inv['first_variant_layer'] or 'none'}",
          flush=True)

    occupancy = {int(k): v for k, v in stats["batch_occupancy"].items()}
    lat = quantiles_ms(latencies)
    out.update(
        wall_s=wall, requests_per_s=n_req / wall, latency_ms=lat,
        engine_latency_ms={q: hist[q] * 1e3 for q in ("p50", "p95", "p99")},
        batches=len(finished), batch_kinds={k: kinds.count(k) for k in set(kinds)},
        mean_fill=rows / len(finished), padded_slots=c["padded_slots"],
        occupancy=occupancy, result_cache=stats["result_cache"],
        feature_cache=stats["feature_cache"], coalesced=c["coalesced"],
        launches=launches, phase4_ms_per_batch=phase4_ms,
        phase4_img_s=4e3 / phase4_ms)
    print(f"serving: {out['requests_per_s']:.2f} requests/s ({n_req} in {wall:.2f} s), "
          f"latency p50 {lat['p50']:.1f} / p95 {lat['p95']:.1f} / p99 {lat['p99']:.1f} ms "
          f"(the engine's histogram {out['engine_latency_ms']['p50']:.1f} / "
          f"{out['engine_latency_ms']['p95']:.1f} / {out['engine_latency_ms']['p99']:.1f});"
          f" {len(finished)} batches ({out['batch_kinds']}), mean fill "
          f"{out['mean_fill']:.2f} of {SERVE_BATCH}, padded slots {c['padded_slots']}, "
          f"occupancy {occupancy}; result cache hit rate "
          f"{stats['result_cache']['hit_rate']:.3f}, feature cache "
          f"{stats['feature_cache']['hit_rate']:.3f}; beside phase 4's sequential "
          f"{phase4_ms:.1f} ms per batch of 4 ({4e3 / phase4_ms:.2f} img/s) [{card}]",
          flush=True)

    del calls, finished

    # health: valid, its compile section the kernel builds of this run
    problems = validate_health_report(health)
    events = obs.compile_events()
    built = sorted(e["kind"] for e in events)
    recent = sorted(e["kind"] for e in health["compile"]["recent"])
    print(f"serving health: problems {problems or 'none'}; compile section total "
          f"{health['compile']['total']}, recent {recent}; builds of this run {built}; "
          f"anomalies {[a['anomaly'] for a in health['anomalies']]}", flush=True)
    if problems or recent != sorted(e["kind"] for e in events[-8:]) \
            or health["compile"]["total"] != len(events):
        fail("serving health report is invalid or its compile section is not this run's")
    out["health"] = {"compile": health["compile"]["total"], "recent": recent,
                     "anomalies": [a["anomaly"] for a in health["anomalies"]]}

    # overload: a burst of 5x an in-flight bound, then close() while it drains
    burst = waves[0][:SERVE_BURST]
    oeng = ServeEngine(pred, batch=SERVE_BATCH, max_wait_ms=SERVE_MAX_WAIT_MS,
                       exemplar_cache=0, feature_cache=0,
                       admission=AdmissionController(enabled=True, max_pending=SERVE_ADMIT))
    ofuts = serve_clients(oeng, burst)
    t0 = time.perf_counter()
    oeng.close(timeout=SERVE_DRAIN_S)
    close_s = time.perf_counter() - t0
    causes, served, retry = {}, 0, []
    for f in ofuts:
        if not f.done():
            fail("serving overload: a future is unresolved after close()")
        exc = f.exception()
        if exc is None:
            served += 1
        elif isinstance(exc, RejectedError):
            causes[exc.cause] = causes.get(exc.cause, 0) + 1
            retry.append(exc.retry_after_s)
        else:
            fail(f"serving overload: a request failed: {exc!r}")
    oc, ov, ostats = oeng.counters, oeng.overload_counters(), oeng.stats()
    rejected = sum(causes.values())
    print(f"serving overload: a burst of {len(burst)} against an in-flight bound of "
          f"{SERVE_ADMIT}: served {served}, rejected {rejected} by cause {causes} "
          f"(retry_after_s {min(retry, default=0):.3f}-{max(retry, default=0):.3f}); "
          f"counters admit_rejected {ov['admit_rejected']}, submitted {oc['submitted']}, "
          f"completed {oc['completed']}; close() {close_s:.2f} s (bound {SERVE_DRAIN_S} s,"
          f" drain timed out {ostats['overload']['drain_timed_out']})", flush=True)
    if (served + rejected != len(burst) or rejected != ov["admit_rejected"]
            or any(ov.get(f"admit_rejected.{k}") != v for k, v in causes.items())
            or oc["submitted"] != served or oc["completed"] != served or oc["errors"]
            or not rejected or close_s > SERVE_DRAIN_S
            or ostats["overload"]["drain_timed_out"]):
        fail("serving overload is not accounted exactly or close() overran its bound")
    out["overload"] = {"burst": len(burst), "bound": SERVE_ADMIT, "served": served,
                       "rejected": causes, "close_s": close_s}

    if profile:
        peng = ServeEngine(pred, batch=SERVE_BATCH, max_wait_ms=SERVE_MAX_WAIT_MS,
                           exemplar_cache=0, feature_cache=0)

        def burst_run():
            for f in serve_clients(peng, waves[0]):
                f.result(timeout=SERVE_WAIT_S)

        try:
            profile_batch(torch, burst_run, "serving",
                          f"one burst of {len(waves[0])} requests, 12 single and 12 multi")
        finally:
            peng.close(timeout=SERVE_DRAIN_S)
    return out



#: phase 5i, the gallery tier on phase 4's predictor: bank A is 12 patterns of 3 boxes
#: of 120 px (template bucket 17, so one group: n_bucket 16, k_bucket 3, 48 rows); bank
#: B is 32 patterns of 1-3 boxes of 56, 120 and 240 px (buckets 9, 17 and 33 by k
#: buckets 1, 2 and 3: nine groups), searched with the prefilter's top-k 8. A cold frame
#: or a feature fill launches what an eval batch does, a cache hit the tail's 1 / 1
GALLERY_A = (12, 3, 120)
GALLERY_B_SIDES = (56, 120, 240)
GALLERY_B = 32
GALLERY_TOPK = 8
GALLERY_FRAME_LAUNCHES = EVAL_LAUNCHES
GALLERY_HIT_LAUNCHES = dict(EVAL_LAUNCHES, global_attn=0, window_attn=0)
#: each entry's decoded scores against the N-loop's, relative to their max: the heads
#: run at 48 rows against 3, so cuDNN may pick other bf16 algorithms (phase 4d's tier)
GALLERY_ROW_TOL = MULTI_ROW_TOL
GALLERY_TIMED = 3  # cold frames timed per arm
#: the demo's query image (H, W) and its exemplar boxes (pixel xyxy, 120-px squares)
DEMO_HW = (768, 1024)
DEMO_SIZE = 1024  # the demo model's input size (demo_config's --image_size)
#: the demo's --NMS_cls_threshold here: the seeded (untrained) detector's objectness stays
#: under the demo's default 0.7, so every peak is kept, to give the counts something to
#: count
DEMO_CLS_THRESHOLD = 0.0
DEMO_EXEMPLARS = ((104, 96, 224, 216), (600, 400, 720, 520))


def gallery_boxes(np, rng, n: int, ks, sides, size: int = 1024):
    """``n`` patterns: pattern i has ``ks[i]`` boxes of ``sides[i]`` px of a 1024 frame
    (scaled to ``size``) at random 8-px-aligned places, normalized xyxy (k, 4)."""
    out = []
    for i in range(n):
        side = max(sides[i] * size // 1024, 8)
        xy = rng.integers(0, (size - side) // 8, (ks[i], 2)) * 8
        out.append(np.concatenate([xy, xy + side], 1).astype(np.float32) / size)
    return out


def gallery_frame(np, rng, patterns, size: int = 1024):
    """A dark noisy frame with a bright square under every pattern box."""
    img = rng.normal(-1.0, 0.1, (size, size, 3)).astype(np.float32)
    for boxes in patterns:
        for x1, y1, x2, y2 in (boxes * size).astype(int):
            img[y1:y2, x1:x2] = 2.0
    return img


def results_equal(np, a: dict, b: dict) -> bool:
    """Two ``search`` results: the same entries, each field bit for bit, the same
    degrade labels."""
    return set(a) == set(b) and all(
        set(a[n]) == set(b[n]) and all(
            np.array_equal(a[n][f], b[n][f]) if isinstance(a[n][f], np.ndarray)
            else a[n][f] == b[n][f] for f in a[n]) for n in a)


def demo_cli(root: Path, tmp: Path, tag: str, extra=()):
    """``python -m tmr_tpu_torch.demo`` headless on the query image (the PNG reader of
    this script swapped in where PIL is missing). Returns (popen, stdout path, stderr
    path)."""
    import os

    prog = ([sys.executable, "-m", "tmr_tpu_torch.demo"] if has_pil() else
            [sys.executable, "-c", "import runpy, sys; sys.path.insert(0, sys.argv.pop(1)); "
             "import chip_smoke; chip_smoke.use_png_reader(); runpy.run_module("
             "'tmr_tpu_torch.demo', run_name='__main__')", str(root)])
    ex = [f"{x1},{y1},{x2},{y2}" for x1, y1, x2, y2 in DEMO_EXEMPLARS]
    argv = prog + ["--image", str(tmp / "q.png"), "--out", str(tmp / f"{tag}.png"),
                   "--image_size", str(DEMO_SIZE),
                   "--NMS_cls_threshold", str(DEMO_CLS_THRESHOLD),
                   *[a for e in ex for a in ("--exemplar", e)], *extra]
    out, err = tmp / f"{tag}.stdout", tmp / f"{tag}.stderr"
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(argv, cwd=root, stdout=fo, stderr=fe,
                                env=dict(os.environ, PYTHONPATH=str(root)))
    return proc, out, err



def demo_image(np, rng):
    """The demo's query image: uint8 noise with 120-px squares, two of them the
    exemplars."""
    h, w = DEMO_HW
    img = rng.integers(20, 60, (h, w, 3)).astype(np.uint8)
    for x1, y1, x2, y2 in DEMO_EXEMPLARS:
        img[y1:y2, x1:x2] = 220
    for _ in range(6):
        y, x = rng.integers(0, h - 120), rng.integers(0, w - 120)
        img[y:y + 120, x:x + 120] = 220
    return img


def wait_demo(proc, out, err, tag: str) -> tuple:
    """The CLI's exit, its detection count and its seconds-free stdout."""
    rc = proc.wait(timeout=300)
    text = out.read_text()
    m = re.search(r"^(\d+) detections -> ", text, re.M)
    if rc != 0 or m is None:
        fail(f"demo CLI {tag}: exit code {rc}, stdout {text[-500:]!r}, stderr "
             f"{err.read_text()[-3000:]}")
    return int(m.group(1))


def check_gallery_path(torch, np, pred, card, map_kit, modules) -> dict:
    """Phase 5i: the gallery tier on phase 4's ViT-B predictor (bf16, 1024^2): bank A's
    fused, features and cache-hit arms against each other and the N-loop, bank B's
    prefilter on the linear scan and through the sketch index, ``ServeEngine``'s
    ``search_gallery`` on a shared feature cache, ``map --features_out tcp://`` into a
    ``FeatureSinkServer`` against 5c's features, and the demo CLI and ``DemoEngine``."""
    import types

    from tmr_tpu_torch import demo as demo_mod
    from tmr_tpu_torch.data.transforms import resize_normalize
    from tmr_tpu_torch.ops import cuda_xcorr
    from tmr_tpu_torch.ops import xcorr as xcorr_mod
    from tmr_tpu_torch.ops.nms import batched_keep_mask
    from tmr_tpu_torch.parallel.journal import ShardJournal
    from tmr_tpu_torch.serve import FeatureSinkServer, GalleryBank, ServeEngine
    from tmr_tpu_torch.diagnostics import gate_refusals
    from tmr_tpu_torch.serve.gallery import _topk_flat, gallery_fused_ok

    (_build,) = modules
    out = {}
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 90)
    size = pred.cfg.image_size
    n_a, k_a, side_a = GALLERY_A
    pats_a = gallery_boxes(np, rng, n_a, [k_a] * n_a, [side_a] * n_a, size)
    ks_b = [1 + i % 3 for i in range(GALLERY_B)]
    sides_b = [GALLERY_B_SIDES[(i // 3) % 3] for i in range(GALLERY_B)]
    pats_b = gallery_boxes(np, rng, GALLERY_B, ks_b, sides_b, size)
    frames = [gallery_frame(np, rng, pats_a[:6] + pats_b[:6], size) for _ in range(
        3 + 2 * GALLERY_TIMED)]

    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        root = Path(__file__).resolve().parent
        # the subprocesses first, so that their start overlaps the in-process checks
        # (nothing is timed until they are done)
        (tmp / "Easy_0.tar").write_bytes(map_kit["shard"])
        sam_checkpoint(torch, pred.model.backbone, tmp / "vit_b.pth")
        received, order = {}, []
        journal_dir = tmp / "journal"

        def on_feature(shard, name, arr):
            received[(shard, name)] = arr

        sink = FeatureSinkServer(on_feature=on_feature)
        dispatch = sink._dispatch

        def watched(doc, state):
            if doc.get("op") == "sync":
                order.append(("sync", sorted(ShardJournal(str(journal_dir)).load_all())))
            return dispatch(doc, state)

        sink._dispatch = watched
        host, port = sink.start()
        t_cli = time.perf_counter()
        tcp_run = map_cli(root, tmp, "tcp", ["--features_out", f"tcp://{host}:{port}",
                                             "--journal_dir", str(journal_dir)],
                          names=["Easy_0.tar"])
        drng = np.random.default_rng(SEED + 91)
        qimg = demo_image(np, drng)
        write_png(np, tmp / "q.png", qimg)
        demo_runs = {"demo": demo_cli(root, tmp, "demo"),
                     "demo_refine": demo_cli(root, tmp, "demo_refine", ["--refine_box"])}

        # ---- bank A: the fused arm, the features arm, a cache hit, the N-loop
        bank_a = GalleryBank(pred, feature_cache=4)
        for i, b in enumerate(pats_a):
            bank_a.register(f"a{i:02d}", b)
        groups = bank_a.stats()["groups"]
        if [(g["capacity"], g["k_bucket"], g["n_real"], g["n_bucket"]) for g in groups] \
                != [(17, 3, 12, 16)]:
            fail(f"gallery bank A: groups {groups}, expected one (17, 3, 12, 16)")
        frame = frames[0]
        # the gate's trace (FakeTensorMode, no launch), cached per geometry: before the spy
        # below, which would record its fake tensors
        t0 = time.perf_counter()
        gate = gallery_fused_ok(pred, groups[0]["capacity"], groups[0]["n_bucket"],
                                groups[0]["k_bucket"])
        out["gate_s"] = time.perf_counter() - t0
        print(f"gallery gate (the fused program traced under FakeTensorMode at bank A's "
              f"geometry): {'admitted' if gate else 'REFUSED'} in "
              f"{out['gate_s']:.2f} s; refusals {gate_refusals()}", flush=True)
        if not gate:
            fail("the gallery gate refused the fused program")
        captured = []
        refine_nms = pred._refine_nms

        def spy(dets, feature, image_hw):
            captured.append({k: v.clone() for k, v in dets.items()})
            return refine_nms(dets, feature, image_hw)

        arms, launches = {}, {}
        pred._refine_nms = spy
        try:
            for arm in ("fused", "features", "hit"):
                torch.cuda.synchronize()
                _build.reset_launches()
                arms[arm] = bank_a.search(frame)
                launches[arm] = dict(_build.LAUNCHES)
            nloop = [pred.predict_multi_exemplar(frame[None], b) for b in pats_a]
        finally:
            del pred._refine_nms
        c = bank_a.counters
        print(f"gallery bank A (12 patterns x 3 boxes, one group: capacity 17, n_bucket 16, "
              f"k_bucket 3, 48 rows): launches fused {json.dumps(launches['fused'])}, "
              f"features {json.dumps(launches['features'])}, hit "
              f"{json.dumps(launches['hit'])}; counters fused_frames {c['fused_frames']} "
              f"heads_frames {c['heads_frames']} backbone_fills {c['backbone_fills']}",
              flush=True)
        want = {"fused": GALLERY_FRAME_LAUNCHES, "features": GALLERY_FRAME_LAUNCHES,
                "hit": GALLERY_HIT_LAUNCHES}
        for arm, w in want.items():
            if launches[arm] != w:
                fail(f"gallery {arm} frame launched {launches[arm]}, expected {w}")
        if (c["fused_frames"], c["heads_frames"], c["backbone_fills"]) != (1, 2, 1):
            fail(f"gallery bank A took other arms: {c}")
        for arm in ("features", "hit"):
            same = results_equal(np, arms[arm], arms["fused"])
            print(f"gallery bank A: the {arm} arm's results "
                  f"{'equal' if same else 'DIFFER from'} the fused arm's, bit for bit",
                  flush=True)
            if not same:
                fail(f"gallery {arm} arm differs from the fused arm")
        # the tail's NMS (the fused call's union per entry) against its plain version
        pre = captured[0]
        keep = batched_keep_mask(pre["boxes"], pre["scores"], pred.cfg.NMS_iou_threshold,
                                 pre["valid"])
        plain = batched_keep_mask(*(pre[k].cpu() for k in ("boxes", "scores")),
                                  pred.cfg.NMS_iou_threshold, pre["valid"].cpu())
        mism = int((keep.cpu() != plain).sum())
        print(f"gallery fused tail NMS over {tuple(pre['valid'].shape)} slots: keep "
              f"mismatches against the plain version {mism} (must be 0)", flush=True)
        if mism:
            fail(f"gallery tail NMS differs from its plain version in {mism} slots")
        worst, kept = 0.0, []
        for i, one in enumerate(captured[3:]):
            got = pre["scores"][i:i + 1].float()
            ref = one["scores"].float()
            worst = max(worst, (got - ref).abs().max().item() / ref.abs().max().item())
            kept.append((int(arms["fused"][f"a{i:02d}"]["valid"].sum()),
                         int(nloop[i]["valid"].sum())))
        print(f"gallery fused vs the N-loop (12 predict_multi_exemplar calls): decoded "
              f"scores before NMS worst |diff| / max {worst:.3e} (tol {GALLERY_ROW_TOL}); "
              f"kept per entry (gallery, N-loop) {kept}", flush=True)
        if worst > GALLERY_ROW_TOL:
            fail("gallery fused arm's decoded scores disagree with the N-loop's")
        out.update(kept=kept, scores_vs_nloop=worst, launches=launches)

        # ---- bank B: the prefilter, on the linear scan and through the index
        banks = {"linear": GalleryBank(pred, feature_cache=0, index=False),
                 "index": GalleryBank(pred, feature_cache=0, index=True, index_min_n=16)}
        for bank in banks.values():
            for i, b in enumerate(pats_b):
                bank.register(f"b{i:02d}", b)
        nb_groups = len(banks["linear"].stats()["groups"])
        res_b, launches_b = {}, {}
        for name, bank in banks.items():
            for j, f in enumerate(frames[1:3]):
                _build.reset_launches()
                res_b[name, j] = bank.search(f, prefilter_topk=GALLERY_TOPK)
                launches_b[name, j] = dict(_build.LAUNCHES)
        for (name, j), res in res_b.items():
            skipped = sorted(n for n, r in res.items() if r.get("degrade_steps"))
            ok = all(res[n]["degrade_steps"] == ["prefilter"] and res[n]["valid"].size == 0
                     for n in skipped)
            print(f"gallery bank B ({GALLERY_B} patterns, {nb_groups} groups) {name} frame "
                  f"{j}: {GALLERY_B - len(skipped)} matched, {len(skipped)} skipped with "
                  f"degrade_steps ['prefilter']; launches {json.dumps(launches_b[name, j])}",
                  flush=True)
            lb = launches_b[name, j]
            if (lb["global_attn"], lb["window_attn"]) != (4, 8) or not ok \
                    or len(skipped) != GALLERY_B - GALLERY_TOPK:
                fail(f"gallery bank B {name} frame {j}: the encoder ran other than once or "
                     f"the skipped entries are not labelled")
        for j in range(2):
            if not results_equal(np, res_b["index", j], res_b["linear", j]):
                fail(f"gallery: the indexed selection differs from the linear scan's on "
                     f"frame {j}")
        print("gallery bank B: the indexed selection and results equal the linear scan's "
              "on both frames, bit for bit", flush=True)
        cb = {n: b.counters for n, b in banks.items()}
        fallbacks = {n: (c["nloop_fallback_frames"], c["index_fallbacks"])
                     for n, c in cb.items()}
        fallbacks["A"] = (bank_a.counters["nloop_fallback_frames"],
                          bank_a.counters["index_fallbacks"])
        print(f"gallery fallbacks (nloop_fallback_frames, index_fallbacks): "
              f"{json.dumps(fallbacks)} (must be 0); index queries "
              f"{cb['index']['index_queries']}, candidates {cb['index']['index_candidates']}, "
              f"rebuilds {cb['index']['index_rebuilds']}", flush=True)
        if any(v != (0, 0) for v in fallbacks.values()) or cb["index"]["index_queries"] != 2:
            fail(f"gallery fallbacks moved or the index was not queried: {fallbacks}")
        # the coarse scores on the card against the same function through xcorr_plain
        feats = pred._get_backbone_fn()(frames[1][None])
        ex = np.stack([np.concatenate([b, np.tile(b[-1:], (3 - len(b), 1))])
                       for b in pats_b])
        kr = np.array(ks_b, np.int32)
        pre_fn = pred._get_gallery_prefilter_fn(GALLERY_B, 3)
        _build.reset_launches()
        s_card = pre_fn(feats, ex, kr, GALLERY_B)
        pre_launches = dict(_build.LAUNCHES)
        plain_corr = types.SimpleNamespace(apply=cuda_xcorr.xcorr_plain)
        with swapped(xcorr_mod, "XCorr", plain_corr):
            s_plain = pre_fn(feats, ex, kr, GALLERY_B)
        s_card, s_plain = s_card.cpu().numpy(), s_plain.cpu().numpy()
        err = float(np.abs(s_card - s_plain).max())
        tol = XCORR_REL_TOL * float(np.abs(s_plain).max())
        same_top = sorted(_topk_flat(s_card, GALLERY_TOPK)) == sorted(
            _topk_flat(s_plain, GALLERY_TOPK))
        print(f"gallery prefilter ({GALLERY_B} entries x kpad 3 = 96 rows x 32 sketch "
              f"planes of 32^2, T 31): max_err {err:.3e} tol {tol:.3e} against xcorr_plain, "
              f"top-{GALLERY_TOPK} {'equal' if same_top else 'DIFFERS'}; launches "
              f"{json.dumps(pre_launches)}", flush=True)
        if not err <= tol or not same_top or pre_launches["xcorr"] != 1:
            fail("gallery prefilter disagrees with its plain version")

        # ---- the engine, sharing its feature cache
        with ServeEngine(pred, batch=1, max_wait_ms=5) as engine:
            shared = GalleryBank(pred, feature_cache=engine.feature_cache)
            for i, b in enumerate(pats_a):
                shared.register(f"a{i:02d}", b)
            engine.attach_gallery(shared)
            got = [engine.search_gallery(frame) for _ in range(2)]
            n_calls = engine.metrics.counter("serve.gallery.searches").value
            cached = len(engine.feature_cache)
        same = all(results_equal(np, g, arms["fused"]) for g in got)
        print(f"gallery through ServeEngine.search_gallery (shared feature cache): results "
              f"{'equal' if same else 'DIFFER from'} bank A's bit for bit; "
              f"serve.gallery.searches {n_calls}; engine feature cache entries {cached}",
              flush=True)
        if not same or n_calls != 2 or cached != 1:
            fail("search_gallery differs from bank A or did not count or share")

        # ---- the subprocesses: map --features_out tcp://, the demo CLI
        rc = tcp_run[0].wait(timeout=300)
        cli_s = time.perf_counter() - t_cli
        if rc != 0:
            fail(f"map --features_out tcp:// exited {rc}: "
                 f"{tcp_run[1]['stderr'].read_text()[-3000:]}")
        want_f = map_kit["features"]
        got_f = {f"Easy/Easy_0/{n}.npy": a for (s, n), a in received.items()}
        same = sorted(got_f) == sorted(want_f) and all(
            got_f[k].dtype == want_f[k].dtype and got_f[k].shape == want_f[k].shape
            and got_f[k].tobytes() == want_f[k].tobytes() for k in want_f)
        marked = sorted(ShardJournal(str(journal_dir)).load_all())
        print(f"map --features_out tcp:// (Easy_0, {len(received)} features into a "
              f"FeatureSinkServer): {'equal' if same else 'DIFFER from'} 5c's .npy byte for "
              f"byte; journal at each sync {order}, after the run {marked}; sink "
              f"{json.dumps(sink.counters())}", flush=True)
        sink.close()
        if not same or not order or order[0][1] or marked != ["Easy_0.tar"]:
            fail("the tcp:// feature sink run lost features or committed before the ack")
        counts = {tag: wait_demo(*run, tag) for tag, run in demo_runs.items()}
        demo_s = time.perf_counter() - t_cli
        png = (tmp / "demo.png").read_bytes()
        width = int.from_bytes(png[16:20], "big")
        dargs = types.SimpleNamespace(backbone="sam_vit_b", image_size=DEMO_SIZE,
                                      NMS_cls_threshold=DEMO_CLS_THRESHOLD,
                                      NMS_iou_threshold=0.5)
        dengine = demo_mod.DemoEngine(demo_mod.demo_config(dargs), device="cuda")
        dengine.init_params()
        _build.reset_launches()
        drawn, boxes, scores = dengine.infer(qimg, DEMO_EXEMPLARS)
        dl = dict(_build.LAUNCHES)
        h, w = DEMO_HW
        exn = np.asarray(DEMO_EXEMPLARS, np.float32) / np.array([w, h, w, h], np.float32)
        dets = dengine.predictor.predict_multi_exemplar(
            resize_normalize(qimg, DEMO_SIZE)[None], exn)
        v = dets["valid"][0].cpu().numpy()
        same = (np.array_equal(dets["boxes"][0].cpu().numpy()[v], boxes)
                and np.array_equal(dets["scores"][0].cpu().numpy()[v], scores))
        dengine.attach_refiner()
        _, rboxes, _ = dengine.infer(qimg, DEMO_EXEMPLARS, refine=True)
        print(f"demo CLI (python -m tmr_tpu_torch.demo, seeded ViT-B at 1024, emb 512): "
              f"{counts['demo']} detections, PNG {width} wide; DemoEngine.infer "
              f"{len(boxes)} detections, {'equal' if same else 'DIFFERENT'} to "
              f"predict_multi_exemplar bit for bit, launches {json.dumps(dl)}; with "
              f"--refine_box: CLI {counts['demo_refine']}, in process {len(rboxes)}; the "
              f"map and demo subprocesses {demo_s:.1f} s from their start [{card}]",
              flush=True)
        if (width != 1024 or counts["demo"] != len(boxes) or not same or not len(boxes)
                or dl != GALLERY_FRAME_LAUNCHES or counts["demo_refine"] != len(rboxes)
                or drawn.shape != (768, 1024, 3)):
            fail("the demo disagrees with DemoEngine.infer or predict_multi_exemplar")
        del dengine
        out.update(demo_detections=counts, tcp_map_s=cli_s, demo_cli_s=demo_s)

    # ---- times (nothing else runs now); cold frames are new images
    def timed(fn, reps=GALLERY_TIMED):
        ms = []
        for i in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    bank_t = GalleryBank(pred, feature_cache=0)
    for i, b in enumerate(pats_a):
        bank_t.register(f"a{i:02d}", b)
    bank_t.search(frames[0])  # warm (a cold frame for this bank): cuDNN plans at 48 rows
    torch.cuda.reset_peak_memory_stats()
    fused = timed(lambda i: bank_t.search(frames[3 + i]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loop = timed(lambda i: [{k: v.cpu() for k, v in pred.predict_multi_exemplar(
        frames[3 + i][None], b).items()} for b in pats_a])
    # the same frames again: second sightings, so the features arm (no feature cache)
    feats_ms = timed(lambda i: bank_t.search(frames[3 + i]))
    hit = timed(lambda i: bank_a.search(frame))
    pre_on = timed(lambda i: banks["linear"].search(frames[3 + GALLERY_TIMED + i],
                                                    prefilter_topk=GALLERY_TOPK))
    pre_call = timed(lambda i: pre_fn(feats, ex, kr, GALLERY_B).cpu(), reps=10)
    ct = bank_t.counters
    if (ct["fused_frames"], ct["heads_frames"]) != (1 + GALLERY_TIMED, GALLERY_TIMED):
        fail(f"gallery timing: the arms ran other frames than timed: {ct}")
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    out.update(fused_ms=fused, nloop_ms=loop, features_ms=feats_ms, hit_ms=hit,
               prefilter_frame_ms=pre_on, prefilter_call_ms=pre_call, peak_gb=peak_gb,
               frames_per_s=1e3 / med(fused), wall_s=time.perf_counter() - t_phase)
    print(f"gallery times, ms per frame of 12 patterns (median of {GALLERY_TIMED} new "
          f"frames; wall, host digest and copies included): fused {med(fused):.1f} "
          f"({', '.join(f'{x:.1f}' for x in fused)}) against the N-loop's {med(loop):.1f} "
          f"({', '.join(f'{x:.1f}' for x in loop)}; {med(loop) / med(fused):.2f}x); "
          f"features arm (encoder program + tail) {med(feats_ms):.1f}; cache hit "
          f"{med(hit):.1f}; bank B with the prefilter on (32 patterns, top-8) "
          f"{med(pre_on):.1f}; one prefilter call over bank B {med(pre_call):.2f}; fused "
          f"frames/s {1e3 / med(fused):.2f}; peak device memory at 48 rows {peak_gb:.2f} GB; "
          f"phase wall {out['wall_s']:.1f} s [{card}]", flush=True)
    torch.cuda.empty_cache()
    return out


#: phase 5j, stream sessions on phase 4's predictor: 3 streams of 8 frames of 1024², each
#: a static synthetic scene (phase 4's generator, squares of 120 px) with fresh noise of
#: this std on every frame (its 8 x 8 block means move ~1e-4, far under the 0.02 delta),
#: cut to a new scene at frame 4: 6 full-path frames (first or changed) and 18 reused
STREAMS = 3
STREAM_FRAMES = 8
SIZE_5J = 1024  # the frames' side
STREAM_CUT = 4
STREAM_NOISE = 0.01
#: both engines of the stream runs take one request a batch: a full-path frame then runs
#: the program it runs in the baseline at the same batch size, so the two are held bit
#: for bit (on the card the encoder's ``neck_2`` convolution differs between batch sizes,
#: PERF.md)
STREAM_BATCH = 1
#: the feature tier's runs: a clean run of 3 waves of 4 distinct frames, then a fault run
#: of 2 waves of 4 whose first fetch kill -9s the worker
TIER_WAVES = 3
TIER_WAVE = 4
TIER_FAULT_WAVES = 2
TIER_WAIT_S = 180.0  # the worker's start, and every future
#: the feature worker in a child process on the same card: phase 4's preset and seed, so
#: its weights (and its stamp, a digest of them) are the script's. It runs one extract
#: before it leases (a process's first encoder call sets up the libraries; the worker
#: takes frames only once warm), prints its stamp once it holds a lease, and each
#: extract's launches and milliseconds
TIER_WORKER = r"""
import json, sys, threading, time
import numpy as np
import torch
from tmr_tpu_torch.config import preset
from tmr_tpu_torch.inference import Predictor
from tmr_tpu_torch.ops import _build
from tmr_tpu_torch.serve.feature_tier import FeatureWorker

host, port, seed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
pred = Predictor(preset("TMR_FSCD147"), device="cuda")
pred.init_params(seed)
worker = FeatureWorker((host, port), "card-worker", pred)
extract, lock = worker._extract, threading.Lock()
extract(np.zeros((1024, 1024, 3), np.float32))


def counted(image):
    with lock:
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        feats = extract(image)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
    print("extract " + json.dumps({"launches": launched, "ms": ms}), flush=True)
    return feats


worker._extract = counted
worker.start()
while not worker.held:
    time.sleep(0.05)
print("worker " + json.dumps({"stamp": list(pred.feature_stamp())}), flush=True)
threading.Event().wait()
"""


def stream_frames(np, rng):
    """Phase 5j's streams: {stream id: [(frame, exemplars (1, 4))] x 8}; frames before
    ``STREAM_CUT`` show scene 0 and the rest scene 1 (each scene with its own exemplar),
    every frame with noise of its own."""
    streams = {}
    for s in range(STREAMS):
        scenes, exs = synthetic_batch(np, rng, 120 * SIZE_5J // 1024, b=2, size=SIZE_5J)
        frames = []
        for t in range(STREAM_FRAMES):
            k = int(t >= STREAM_CUT)
            noise = rng.standard_normal(scenes[k].shape, dtype=np.float32)
            frames.append((scenes[k] + np.float32(STREAM_NOISE) * noise, exs[k]))
        streams[f"cam{s}"] = frames
    return streams


def drive_streams(streams, submit, latencies):
    """Each stream from a client thread of its own, its frames submitted back to back in
    order: ``submit(stream id, frame, exemplars)`` -> Future. Returns {stream id:
    [future] x 8}; ``latencies`` collects submit-to-resolve seconds."""
    futs = {sid: [None] * len(frames) for sid, frames in streams.items()}

    def client(sid):
        for t, (frame, ex) in enumerate(streams[sid]):
            t0 = time.perf_counter()
            futs[sid][t] = submit(sid, frame, ex)
            futs[sid][t].add_done_callback(
                lambda f, t0=t0: latencies.append(time.perf_counter() - t0))

    threads = [threading.Thread(target=client, args=(sid,)) for sid in streams]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return futs


def serve_equal(np, a: dict, b: dict) -> bool:
    """Two served results: the same fields, each bit for bit, and the same labels."""
    return set(a) == set(b) and all(
        np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) else a[k] == b[k]
        for k in a)


def check_streams(torch, np, pred, card, _build) -> dict:
    """Phase 5j, streams: the frame-independent baseline (every frame through
    ``ServeEngine.submit``, caches off), then the same frames through
    ``StreamRouter(engine, reuse=True)`` over an engine of the same settings."""
    from tmr_tpu_torch.serve import ServeEngine, StreamRouter

    streams = stream_frames(np, np.random.default_rng(SEED + 11))
    n = sum(len(f) for f in streams.values())
    kw = dict(batch=STREAM_BATCH, max_wait_ms=SERVE_MAX_WAIT_MS, exemplar_cache=0,
              feature_cache=0)
    out = {"streams": STREAMS, "frames": n, "batch": STREAM_BATCH}
    runs = {}
    for name in ("baseline", "router"):
        eng = ServeEngine(pred, **kw)
        router = StreamRouter(eng, reuse=True) if name == "router" else None
        # warm-up outside the count: the fused and the heads programs at batch 1
        frame, ex = streams["cam0"][0]
        eng.submit(frame, ex).result(timeout=SERVE_WAIT_S)
        feats = pred._get_backbone_fn()(np.stack([frame]))
        eng.submit(frame, ex, features=feats).result(timeout=SERVE_WAIT_S)
        heads = []
        run_heads = eng._run_heads

        def counting(staged, *a, run_heads=run_heads, heads=heads):
            before = dict(_build.LAUNCHES)
            res = run_heads(staged, *a)
            heads.append({k: _build.LAUNCHES[k] - before[k] for k in before})
            return res

        eng._run_heads = counting
        submit = ((lambda sid, f, e, r=router: r.submit_stream(sid, f, e)) if router
                  else (lambda sid, f, e, g=eng: g.submit(f, e)))
        torch.cuda.synchronize()
        _build.reset_launches()
        lat = []
        t0 = time.perf_counter()
        futs = drive_streams(streams, submit, lat)
        results = {sid: [f.result(timeout=SERVE_WAIT_S) for f in fs]
                   for sid, fs in futs.items()}
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        counters = router.counters() if router else {}
        eng.close(timeout=SERVE_DRAIN_S)
        runs[name] = dict(results=results, wall=wall, lat=quantiles_ms(lat),
                          launches=launches, heads=heads, counters=counters)
    base, routed = runs["baseline"], runs["router"]
    full = {(sid, t) for sid in streams for t in (0, STREAM_CUT)}
    bad_full, bad_label, crossed = [], [], []
    for sid, frames in routed["results"].items():
        for t, got in enumerate(frames):
            if (sid, t) in full:
                if "degrade_steps" in got:
                    bad_label.append((sid, t))
                if not serve_equal(np, got, base["results"][sid][t]):
                    bad_full.append((sid, t))
                continue
            if got.get("degrade_steps") != ["temporal_reuse"]:
                bad_label.append((sid, t))
            crossed += [(sid, t, other, u) for run in (base, routed)
                        for other, theirs in run["results"].items() if other != sid
                        for u, r in enumerate(theirs)
                        if all(np.array_equal(got[k], r[k]) for k in
                               ("boxes", "scores", "refs", "valid"))]
    # the parts of a frame, one at a time (median of 5, each ending in a synchronize): the
    # host's signature and digest of a 1024² frame, the fused program at B = 1 from the
    # host array, the encoder alone, and the heads on features already on the card
    from tmr_tpu_torch.serve import block_signature
    from tmr_tpu_torch.serve.caches import array_digest

    def host_ms(fn, reps=5):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[reps // 2]

    frame, ex = streams["cam0"][1]
    cap = pred.pick_capacity(ex, SIZE_5J)
    img1, ex1 = np.stack([frame]), np.stack([ex])
    feats = pred._get_backbone_fn()(img1)
    parts = {"signature": host_ms(lambda: block_signature(frame)),
             "digest": host_ms(lambda: array_digest(frame)),
             "fused": host_ms(lambda: pred(img1, ex1)),
             "encoder": host_ms(lambda: pred._get_backbone_fn()(img1)),
             "heads": host_ms(lambda: pred._get_heads_fn(cap, SIZE_5J)(feats, ex1))}
    print(f"streams, one frame's parts (ms, median of 5): {json.dumps(parts)} [{card}]",
          flush=True)
    c = routed["counters"]
    want_c = {"frames": n, "first_frames": STREAMS, "changed_frames": STREAMS,
              "reused_frames": n - 2 * STREAMS, "local_fills": 2 * STREAMS}
    enc = lambda L: (L["global_attn"], L["window_attn"])  # noqa: E731
    fills = c.get("local_fills", 0) + c.get("remote_fills", 0)
    bound = (4 * (len(full) + fills), 8 * (len(full) + fills))
    heads_ok = all(h["xcorr"] == 1 and h["nms"] == 1 for h in routed["heads"])
    rates = {k: n / runs[k]["wall"] for k in runs}
    print(f"streams: {STREAMS} streams x {STREAM_FRAMES} frames of {SIZE_5J}^2 from "
          f"{STREAMS} client threads, batch bound {STREAM_BATCH}; router counters "
          f"{json.dumps(c)} (expected {json.dumps(want_c)}); full-path frames differing "
          f"from the baseline {len(bad_full)} of {len(full)}; labels wrong {len(bad_label)};"
          f" reused results equal to another stream's {len(crossed)}; encoder launches "
          f"(global, window) router {enc(routed['launches'])} (bound {bound}: "
          f"{len(full)} full-path frames + {fills} fills) beside the baseline's "
          f"{enc(base['launches'])}; {len(routed['heads'])} heads batches, each "
          f"xcorr 1 and nms 1: {heads_ok}", flush=True)
    print(f"streams: frames/s baseline {rates['baseline']:.2f} ({n} in "
          f"{base['wall']:.3f} s), router {rates['router']:.2f} ({routed['wall']:.3f} s), "
          f"x{rates['router'] / rates['baseline']:.3f}; latency p50 / p95 baseline "
          f"{base['lat']['p50']:.1f} / {base['lat']['p95']:.1f} ms, router "
          f"{routed['lat']['p50']:.1f} / {routed['lat']['p95']:.1f} ms; launches "
          f"baseline {json.dumps(base['launches'])}, router "
          f"{json.dumps(routed['launches'])} [{card}]", flush=True)
    if {k: c.get(k, 0) for k in want_c} != want_c:
        fail(f"stream router counters {c}, expected {want_c}")
    if bad_full or bad_label or crossed:
        fail(f"streams: full-path frames differ from the baseline {bad_full}, wrong labels "
             f"{bad_label}, reused results equal to another stream's {crossed[:4]}")
    if not all(a <= b for a, b in zip(enc(routed["launches"]), bound)):
        fail(f"streams: encoder launches {enc(routed['launches'])} over {bound}")
    if not heads_ok or len(routed["heads"]) != n - 2 * STREAMS:
        fail(f"streams: heads batches' (xcorr, nms) "
             f"{[(h['xcorr'], h['nms']) for h in routed['heads']]}, expected "
             f"{n - 2 * STREAMS} of (1, 1)")
    out.update(frames_per_s=rates, latency_ms={k: runs[k]["lat"] for k in runs}, parts_ms=parts,
               counters=c, launches={k: runs[k]["launches"] for k in runs},
               heads_batches=len(routed["heads"]))
    return out


def start_tier_worker(root: Path, address, log: Path):
    """``TIER_WORKER`` in a child process on the card, its output into ``log``."""
    import os

    env = dict(os.environ, PYTHONPATH=str(root))
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", TIER_WORKER, address[0],
                                 str(address[1]), str(SEED)], cwd=str(root), env=env,
                                stdout=f, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def worker_lines(log: Path, tag: str) -> list:
    """The JSON documents of the worker's lines that start with ``tag``."""
    return [json.loads(line[len(tag) + 1:]) for line in log.read_text().splitlines()
            if line.startswith(tag + " {") and line.endswith("}")]


def tier_frames(np, rng, n: int):
    """``n`` distinct single-exemplar requests of ``SIZE_5J``² (phase 4's generator,
    buckets 9, 17 and 33 in turn)."""
    reqs = []
    for i in range(n):
        side = BUCKET_SIDES_PX[(9, 17, 33)[i % 3]] * SIZE_5J // 1024
        imgs, ex = synthetic_batch(np, rng, side, b=1, size=SIZE_5J)
        reqs.append((imgs[0], ex[0], {}))
    return reqs


def check_tier_programs(torch, np, pred, calls, finished, fetched) -> list:
    """Each served result of a run against its program on the captured inputs (the heads
    program on the rows the engine fed it, each remote row the fetched features; the
    fused program on its staged stack) and each local fill's features against the
    encoder on the staged images; returns the mismatches."""
    mism = []
    for (name, key, args), (bucket, reqs, fill, images) in zip(calls, finished):
        with torch.inference_mode():
            again = getattr(type(pred), name)(pred, *key)(*args)
            if any(reqs[i].image_digest not in fetched for i in fill):
                feats = type(pred)._get_backbone_fn(pred)(images)
            for i, r in enumerate(reqs):
                remote = fetched.get(r.image_digest)
                if name == "_get_heads_fn" and remote is not None and not torch.equal(
                        args[0][i:i + 1], torch.as_tensor(remote[1], device=pred.device)):
                    mism.append((bucket, i, "remote row"))
                if fill and i in fill and remote is None and not torch.equal(
                        feats[fill.index(i)], args[0][i]):
                    mism.append((bucket, i, "fill features"))
        for i, r in enumerate(reqs):
            got = r.futures[0].result(timeout=TIER_WAIT_S)
            for f in ("boxes", "scores", "refs", "valid"):
                if not np.array_equal(got[f], again[f][i:i + 1].cpu().numpy()):
                    mism.append((bucket, i, f))
    return mism


def check_feature_tier(torch, np, pred, card, _build, worker, address, log, tier,
                       wait_holder) -> dict:
    """Phase 5j, the feature tier: ``ServeEngine(pred, feature_client=tier.client(
    predictor=pred))`` against the worker process ``worker`` (already started on
    ``tier``): a clean run, then a fault run that kill -9s the worker at its first
    fetch."""
    import os
    import signal

    from tmr_tpu_torch.serve import ServeEngine
    from tmr_tpu_torch.serve.fleet import pack_array, unpack_array

    rng = np.random.default_rng(SEED + 12)
    clean = tier_frames(np, rng, TIER_WAVES * TIER_WAVE)
    faulty = tier_frames(np, rng, TIER_FAULT_WAVES * TIER_WAVE)
    wait_holder()
    stamps = worker_lines(log, "worker")
    if not stamps or tuple(stamps[0]["stamp"]) != tuple(pred.feature_stamp()):
        fail(f"the feature worker's stamp {stamps} is not the script's "
             f"{pred.feature_stamp()}")
    client = tier.client(predictor=pred)
    fetched, fetch_ms, failed_ms = {}, [], []
    fetch, killed = client.fetch, threading.Event()

    def recording(image, digest, size):
        t0 = time.perf_counter()
        feats = fetch(image, digest, size)
        (fetch_ms if feats is not None else failed_ms).append(
            (time.perf_counter() - t0) * 1e3)
        if feats is not None:
            fetched[digest] = (image, feats)
        return feats

    def killing(image, digest, size):
        if not killed.is_set():  # kill -9 the worker at the fault run's first fetch
            killed.set()
            os.kill(worker.pid, signal.SIGKILL)
            worker.wait(timeout=60)
        return recording(image, digest, size)

    client.fetch = recording
    engine = ServeEngine(pred, batch=SERVE_BATCH, max_wait_ms=SERVE_MAX_WAIT_MS,
                         feature_client=client)
    out = {"clean_frames": len(clean), "fault_frames": len(faulty)}
    try:
        # warm-up outside the count: the heads program at each wave's batch shape
        warm = tier_frames(np, rng, TIER_WAVE)
        for f in serve_clients(engine, warm, clients=TIER_WAVE):
            f.result(timeout=TIER_WAIT_S)
        warm_extracts = worker_lines(log, "extract")
        n_extract = len(warm_extracts)
        print(f"feature tier warm-up: {len(warm)} frames, client {json.dumps(client.counters())}, "
              f"engine {json.dumps(engine.overload_counters())}; the worker's extracts ms "
              f"{[round(e['ms'], 2) for e in warm_extracts]}, fetches ms "
              f"{[round(v, 2) for v in fetch_ms]}, failed fetches ms "
              f"{[round(v, 2) for v in failed_ms]}", flush=True)
        if client.counters()["fetched"] != len(warm):
            print(f"feature worker log: {log_tail(log)}", flush=True)
        fetched.clear()
        fetch_ms.clear()

        def run(reqs, tag):
            calls, finished, restore = capture_serving(pred, engine)
            before = dict(engine.overload_counters())
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            futs = []
            for w in range(0, len(reqs), TIER_WAVE):
                wave = serve_clients(engine, reqs[w:w + TIER_WAVE], clients=TIER_WAVE)
                for f in wave:
                    f.result(timeout=TIER_WAIT_S)
                futs += wave
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            restore()
            after = engine.overload_counters()
            moved = {k: after.get(k, 0) - before.get(k, 0) for k in
                     ("feature_tier.remote_frames", "feature_tier.cold_frames",
                      "feature_tier.fallback_frames")}
            mism = check_tier_programs(torch, np, pred, calls, finished, fetched)
            kinds = [b[0][0] for b in finished]
            return dict(wall=wall, launches=launches, moved=moved,
                        mism=mism, batches={k: kinds.count(k) for k in set(kinds)},
                        futs=futs)

        cr = run(clean, "clean")
        cc = client.counters()
        extracts = worker_lines(log, "extract")[n_extract:]
        bad_extract = [e for e in extracts if e["launches"] != {"global_attn": 4,
                                                                 "window_attn": 8}]
        # the fetched features against this process's encoder at batch 1
        feat_diff = []
        with torch.inference_mode():
            for digest, (image, feats) in fetched.items():
                local = pred._get_backbone_fn()(np.stack([image]))
                remote = torch.as_tensor(feats, device=pred.device)
                if not torch.equal(local, remote):
                    feat_diff.append(float((local - remote).abs().max()))
        print(f"feature tier, clean run: {len(clean)} distinct frames in {TIER_WAVES} "
              f"waves of {TIER_WAVE} from {TIER_WAVE} client threads, "
              f"{cr['wall']:.3f} s; engine counters {json.dumps(cr['moved'])}, client "
              f"{json.dumps(cc)}; batches {cr['batches']}; the engine's launches "
              f"{json.dumps(cr['launches'])}; the worker's {len(extracts)} extracts "
              f"launched {sorted({json.dumps(e['launches']) for e in extracts})} "
              f"(ms {[round(e['ms'], 2) for e in extracts]}); results differing from "
              f"their programs {len(cr['mism'])}; fetched features differing from this "
              f"process's encoder at batch 1: {len(feat_diff)} of {len(fetched)}"
              f"{f' (max abs diff {max(feat_diff):.3e})' if feat_diff else ''} [{card}]",
              flush=True)
        if (cr["moved"] != {"feature_tier.remote_frames": len(clean),
                            "feature_tier.cold_frames": 0,
                            "feature_tier.fallback_frames": 0}
                or cc["stamp_mismatches"] or cc["fenced"] or cc["errors"]):
            fail(f"feature tier clean run: counters {cr['moved']}, client {cc}")
        if cr["launches"]["global_attn"] or cr["launches"]["window_attn"]:
            fail(f"feature tier clean run: the engine launched attention kernels "
                 f"{cr['launches']} for remote frames")
        if len(extracts) != len(clean) or bad_extract:
            fail(f"feature tier: {len(extracts)} extracts for {len(clean)} frames, "
                 f"launches other than 4 / 8: {[e['launches'] for e in bad_extract]}")
        if cr["mism"] or feat_diff or len(fetched) != len(clean):
            fail(f"feature tier clean run: results differ from their programs "
                 f"{cr['mism'][:4]}, or the fetched features from the encoder at batch 1 "
                 f"({feat_diff}), {len(fetched)} fetched")

        # one frame at a time: remote (through the engine) against a local fused frame
        single = tier_frames(np, rng, 3)
        remote_ms, local_ms = [], []
        for img, ex, _ in single:
            t0 = time.perf_counter()
            engine.submit(img, ex).result(timeout=TIER_WAIT_S)
            remote_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            pred(np.stack([img]), np.stack([ex]))
            torch.cuda.synchronize()
            local_ms.append((time.perf_counter() - t0) * 1e3)
        img, ex, _ = single[0]
        digest, (_, feats) = next(iter(fetched.items()))
        req_doc = {"op": "extract", "partition": 0, "epoch": 1, "digest": digest,
                   "image": pack_array(img)}
        rep_doc = {"op": "extract", "ok": True, "status": "ok",
                   "features": pack_array(feats), "stamp": list(pred.feature_stamp())}
        wire = len(json.dumps(req_doc)) + len(json.dumps(rep_doc)) + 2
        pack_ms, unpack_ms = {}, {}
        for what, arr in (("image", img), ("features", feats)):
            ts, us = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                doc = pack_array(arr)
                ts.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                unpack_array(doc)
                us.append((time.perf_counter() - t0) * 1e3)
            pack_ms[what], unpack_ms[what] = sorted(ts)[1], sorted(us)[1]
        med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
        print(f"feature tier: ms per remote frame (one at a time through the engine) "
              f"{[round(v, 2) for v in remote_ms]} against a local fused frame "
              f"{[round(v, 2) for v in local_ms]}; a fetch's round trip (median of "
              f"{len(fetch_ms)}) {med(fetch_ms):.2f} ms; the wire {wire / 1e6:.3f} MB a "
              f"frame (request {len(json.dumps(req_doc)) / 1e6:.3f}); pack / unpack ms: "
              f"image {pack_ms['image']:.2f} / {unpack_ms['image']:.2f}, features "
              f"{pack_ms['features']:.2f} / {unpack_ms['features']:.2f} [{card}]",
              flush=True)

        # fault run: the worker is kill -9'd at the first fetch
        client.fetch = killing
        fr = run(faulty, "fault")
        lost = fr["moved"]["feature_tier.cold_frames"] + fr["moved"][
            "feature_tier.fallback_frames"]
        unresolved = [f for f in fr["futs"] if not f.done() or f.exception() is not None]
        print(f"feature tier, fault run: the worker kill -9'd at the first fetch (exit "
              f"{worker.returncode}); {len(faulty)} frames, engine counters "
              f"{json.dumps(fr['moved'])}, client {json.dumps(client.counters())}; "
              f"batches {fr['batches']}; the engine's launches "
              f"{json.dumps(fr['launches'])}; unresolved or failed futures "
              f"{len(unresolved)}; results differing from their programs "
              f"{len(fr['mism'])} ({fr['wall']:.3f} s)", flush=True)
        if (unresolved or lost != len(faulty) or fr["moved"]["feature_tier.remote_frames"]
                or worker.returncode != -signal.SIGKILL):
            fail(f"feature tier fault run: {len(unresolved)} futures unresolved or failed, "
                 f"{lost} of {len(faulty)} counted local, counters {fr['moved']}")
        if fr["launches"]["global_attn"] <= 0 or fr["launches"]["window_attn"] <= 0:
            fail(f"feature tier fault run: the lost frames did not run the encoder here "
                 f"({fr['launches']})")
        if fr["mism"]:
            fail(f"feature tier fault run: results differ from their programs "
                 f"{fr['mism'][:4]}")
        worker_launches = {k: sum(e["launches"].get(k, 0) for e in extracts)
                           for k in ("global_attn", "window_attn")}
        out.update(clean_s=cr["wall"], counters={"clean": cr["moved"],
                                                  "fault": fr["moved"]},
                   client=client.counters(), remote_ms=remote_ms, local_ms=local_ms,
                   fetch_ms=med(fetch_ms), wire_mb=wire / 1e6, pack_ms=pack_ms,
                   unpack_ms=unpack_ms, extract_ms=[e["ms"] for e in extracts],
                   launches={"clean": cr["launches"], "fault": fr["launches"],
                             "worker": worker_launches})
    finally:
        engine.close(timeout=SERVE_DRAIN_S)
        client.close()
    return out


def check_stream_tier_path(torch, np, pred, card, modules, root: Path) -> dict:
    """Phase 5j: stream sessions and the disaggregated feature tier on phase 4's
    predictor. The feature worker's process starts first and boots while the streams
    run. Returns the phase's record, with its launches summed (this process's and the
    worker's) under ``launches``."""
    from tmr_tpu_torch.serve import FeatureTier

    (_build,) = modules
    t0 = time.perf_counter()
    tier = FeatureTier([SIZE_5J])
    address = tier.start()
    with tempfile.TemporaryDirectory() as tmp:
        log = Path(tmp) / "feature_worker.log"
        worker = start_tier_worker(root, address, log)

        def wait_holder():
            deadline = time.perf_counter() + TIER_WAIT_S
            while tier.holder_for(SIZE_5J) is None or not worker_lines(log, "worker"):
                if worker.poll() is not None or time.perf_counter() > deadline:
                    fail(f"the feature worker did not take a lease (exit "
                         f"{worker.poll()}): {log_tail(log)}")
                time.sleep(0.1)
            print(f"feature worker: holding its lease {time.perf_counter() - t0:.1f} s "
                  f"after its start", flush=True)

        try:
            streams = check_streams(torch, np, pred, card, _build)
            tiered = check_feature_tier(torch, np, pred, card, _build, worker, address,
                                        log, tier, wait_holder)
        finally:
            if worker.poll() is None:
                worker.kill()
            worker.wait(timeout=60)
            tier.close()
    launches = {k: sum(run.get(k, 0) for run in (*streams["launches"].values(),
                                                 *tiered["launches"].values()))
                for k in ("global_attn", "window_attn", "xcorr", "nms")}
    return {"streams": streams, "feature_tier": tiered, "launches": launches}


@contextlib.contextmanager
def swapped(module, name: str, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _tar_payloads(path) -> list:
    import tarfile

    with tarfile.open(path) as tar:
        return [tar.extractfile(m).read() for m in tar if m.isfile()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after each path, print a torch.profiler breakdown of "
                         "one batch (device time by kernel, device busy share)")
    args = ap.parse_args(argv)

    root = Path(__file__).resolve().parent
    if not (root / "tmr_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: tmr_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import numpy as np
    import torch.nn.functional as F

    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.inference import Predictor, detections_to_numpy
    from tmr_tpu_torch.ops import (_build, cuda_attn, cuda_int8, cuda_nms, cuda_xcorr,
                                   fused_heads, probe)

    t_marks = [time.perf_counter()]

    def mark(phase: str) -> None:
        """The wall seconds of the phase that just ended, and of the script so far."""
        now = time.perf_counter()
        print(f"phase {phase}: {now - t_marks[-1]:.1f} s (script {now - t_marks[0]:.1f} s)",
              flush=True)
        t_marks.append(now)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build, then the toolchain probe
    build_s = _build.build()
    for name in _build.SIGNATURES:
        _build.lib(name)
    print(f"build: {build_s:.1f} s for {len(_build.SIGNATURES)} sources", flush=True)
    entries = {"add1": run_probe(torch, probe, _build)}
    probe_launches = entries["add1"].pop("launches")
    mark("2")

    # 3. kernels at main-path shapes
    with exact_f32(torch):
        entries.update(check_kernels(torch, F, cuda_attn, cuda_xcorr, cuda_nms, cuda_int8,
                                     preset("TMR_FSCD147").NMS_iou_threshold))
    mark("3")

    # 4. main path
    cfg = preset("TMR_FSCD147")
    pred = Predictor(cfg, device="cuda")
    pred.init_params(SEED)
    rng = np.random.default_rng(SEED)
    # 3 exemplars an image for phase 4d; phase 4 takes the first
    multi_batches = [synthetic_batch(np, rng, BUCKET_SIDES_PX[b], k=3) for b in (9, 17, 33)]
    batches = [(imgs, ex[:, :1].copy()) for imgs, ex in multi_batches]
    multi_batches = [(imgs, pad_exemplar_rows(ex, MULTI_K_REAL))
                     for imgs, ex in multi_batches]
    caps = [pred.pick_capacity(ex, 1024) for _, ex in batches]
    if caps != [9, 17, 33]:
        fail(f"exemplars picked buckets {caps}, expected [9, 17, 33]")
    with call_count(cuda_attn, "bias_projections") as proj_calls:
        times, outs, launches = run_batches(torch, pred, batches, detections_to_numpy,
                                            _build)
    report_batches(np, "main path", caps, times, outs, card)
    print(f"launches over the 3 batches: {json.dumps(launches)}", flush=True)
    # both attention kernels make their own projections: no f32 copy of q and no
    # projection products on the main path
    print(f"bias_projections calls over the warm-up and 3 batches: {len(proj_calls)} "
          f"(expected 0)", flush=True)
    if proj_calls:
        fail(f"bias_projections ran {len(proj_calls)} times on the card, expected 0")
    if launches["window_attn"] != 24:
        fail(f"window_attn launched {launches['window_attn']} times, expected 24")
    missing = [k for k in ("global_attn", "window_attn", "xcorr", "nms") if launches[k] <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    stray = [k for k in ("xcorr_int8", "int8_mm", "int8_conv", "add1", "global_attn_d80",
                         "window_attn_d80", *F32_ZERO) if launches[k]]
    if stray:
        fail(f"int8, probe, head dim 80 or f32 kernels launched on the ViT-B bf16 path: "
             f"{stray}")
    check_main_path_nms(torch, lambda: pred(*batches[0]), cuda_nms)

    imgs, ex = batches[0]
    out = pred.forward(imgs, ex)
    obj = out["objectness"][0].float().cpu()
    reg = out["regressions"][0].float().cpu()
    ref_cfg = preset("TMR_FSCD147", compute_dtype="float32")
    ref = Predictor(ref_cfg, device="cpu")
    ref.model.load_state_dict({k: v.cpu() for k, v in pred.model.state_dict().items()})
    t0 = time.perf_counter()
    ref_obj = ref.forward(imgs[:1], ex[:1])["objectness"][0]
    diff = (obj - ref_obj).abs().max().item()
    scale = ref_obj.abs().max().item()
    print(f"objectness image 0 vs f32 CPU run: max_abs_diff {diff:.4e}, map max "
          f"{scale:.4e}, tol {OBJ_REL_TOL} x max ({time.perf_counter() - t0:.1f} s "
          f"on the CPU)", flush=True)
    if not (torch.isfinite(obj).all() and obj.shape == (128, 128)
            and diff <= OBJ_REL_TOL * scale):
        fail("objectness map disagrees with the f32 CPU reference")
    del ref
    phase4_ref = (ref_obj, diff / scale, sum(times) / len(times))
    mark("4")

    # 4b. the int8-storage path on the same weights
    qlaunches, qpred = check_quant_path(torch, np, pred, batches, caps, obj, reg, card,
                                        (_build, cuda_int8, fused_heads))
    mark("4b")
    # 4d. the multi-exemplar path on the same weights
    check_multi_path(torch, np, pred, qpred, multi_batches, caps,
                     sum(times) / len(times), card, (_build, cuda_nms))
    if args.profile:
        profile_batch(torch, lambda: pred(*batches[2]), "main path")
        profile_batch(torch, lambda: qpred(*batches[2]), "int8 path")
        profile_batch(torch, lambda: pred.predict_multi_batch(
            *multi_batches[2], np.array(MULTI_K_REAL, np.int32)), "multi path",
            "one batch of 4 images x 3 exemplars, bucket 33")
    del qpred
    torch.cuda.empty_cache()
    mark("4d")
    # 4f. compute_dtype="float32" on phase 4's weights: its batches, a multi batch and the
    # CLI with --visualize
    f32_launches, f32 = check_f32_path(torch, np, pred, batches, multi_batches, caps,
                                       phase4_ref, card, (_build, cuda_attn, cuda_nms),
                                       args.profile)
    nobias_launches, f32["nobias"] = check_nobias_blocks(torch, card, (_build,))
    f32.update(check_f32_cli(torch, np, pred, card, (_build,)))
    mark("4f")

    # 5. eval through Trainer.test on the same weights, both size buckets
    eval_rates, launches_1536, (ref_1536, check_1536) = check_eval_path(
        torch, np, pred, card, sum(times) / len(times), (_build,), args.profile)
    mark("5")
    # 5b. training: the attention backward at main-path shapes, then Trainer.fit from the
    # same weights
    backward = check_backward_kernels(torch, cuda_attn, card)
    train = check_train_path(torch, np, pred, card, (_build, cuda_attn, cuda_xcorr),
                             backward, args.profile)
    print(json.dumps({"train": train, "backward": backward}), flush=True)
    mark("5b")
    # 5c. the map phase and extract_feature on phase 4's encoder
    mapped, map_records, map_kit = check_map_path(torch, np, pred, card,
                                                  (_build, cuda_attn), ref_1536)
    check_1536()  # phase 5's 1536 objectness, its CPU run made beside 5c's CLI runs
    print(json.dumps({"map": mapped}), flush=True)
    mark("5c")
    with tempfile.TemporaryDirectory() as export_dir:
        # 5h. the torch.export artifacts on the same weights
        exported = check_export_path(torch, np, pred, batches, multi_batches, map_records,
                                     sum(times) / len(times), card, (_build,),
                                     Path(export_dir))
        print(json.dumps({"export": exported}), flush=True)
        mark("5h")
        # 5g. the elastic map phase on the same weights (the checkpoint 5c writes; the
        # payload's worker takes 5h's encoder artifact)
        elastic = check_elastic_path(torch, np, pred, card, (_build,),
                                     Path(export_dir) / "sam_vit_b_encoder.pt2")
    print(json.dumps({"elastic": elastic}), flush=True)
    mark("5g")
    # 5d. SAM box refinement and the segment-anything surface on phase 4's weights
    refined = check_refine_path(torch, np, pred, batches, multi_batches, card,
                                sum(times) / len(times), eval_rates, (_build, cuda_nms),
                                args.profile)
    print(json.dumps({"refine": refined}), flush=True)
    mark("5d")
    # 5f. the serving engine on phase 4's predictor
    served = check_serve_path(torch, np, pred, batches, multi_batches, card,
                              sum(times) / len(times), (_build,), args.profile)
    print(json.dumps({"serve": served}), flush=True)
    mark("5f")
    # 5j. stream sessions and the feature tier on phase 4's predictor
    streamed = check_stream_tier_path(torch, np, pred, card, (_build,), root)
    print(json.dumps({"streams": streamed}), flush=True)
    mark("5j")
    # 5i. the gallery tier and the demo on phase 4's predictor
    gallery = check_gallery_path(torch, np, pred, card, map_kit, (_build,))
    print(json.dumps({"gallery": gallery}), flush=True)
    mark("5i")
    del pred, map_kit
    torch.cuda.empty_cache()

    # 4c. SAM ViT-H (head dim 80) on the same batches
    hlaunches, hpred, href = check_vit_h_path(torch, np, batches, caps, card,
                                              (_build, cuda_attn, cuda_nms))
    if args.profile:
        profile_batch(torch, lambda: hpred(*batches[2]), "ViT-H path")
    mark("4c")
    # 4f, ViT-H: the same weights at compute_dtype="float32"
    h32_launches, f32["vit_h"] = check_f32_vit_h(torch, np, hpred, batches, caps, href, card,
                                                 (_build, cuda_attn, cuda_nms))
    print(json.dumps({"f32": f32}), flush=True)
    mark("4f ViT-H")
    del hpred
    torch.cuda.empty_cache()

    # 4e and 5e. the JAX main.py default detector (ResNet-50 DC5) and its prototype
    # twin, then its eval and training
    default, dpred, ppred = check_default_path(torch, np, card,
                                               (_build, cuda_nms, cuda_xcorr), args.profile)
    default.update(check_default_train_eval(torch, np, dpred, ppred, card, default["ms"],
                                            (_build, cuda_xcorr)))
    print(json.dumps({"default": default}), flush=True)
    mark("4e, 5e")
    del dpred, ppred
    torch.cuda.empty_cache()

    # 6. the kernels line
    meta = {
        "global_attn": ("tmr_tpu_torch/csrc/attn.cu", "tmr_tpu/ops/pallas_attn.py:59"),
        "global_attn_1536": ("tmr_tpu_torch/csrc/attn.cu", "tmr_tpu/ops/pallas_attn.py:59"),
        "window_attn": ("tmr_tpu_torch/csrc/attn.cu", "tmr_tpu/ops/pallas_attn.py:350"),
        "global_attn_d80": ("tmr_tpu_torch/csrc/attn.cu", "tmr_tpu/ops/pallas_attn.py:59"),
        "window_attn_d80": ("tmr_tpu_torch/csrc/attn.cu", "tmr_tpu/ops/pallas_attn.py:350"),
        "global_attn_f32": ("tmr_tpu_torch/csrc/attn_f32.cu",
                            "tmr_tpu/ops/pallas_attn.py:59"),
        "window_attn_f32": ("tmr_tpu_torch/csrc/attn_f32.cu",
                            "tmr_tpu/ops/pallas_attn.py:350"),
        "global_attn_f32_d80": ("tmr_tpu_torch/csrc/attn_f32.cu",
                                "tmr_tpu/ops/pallas_attn.py:59"),
        "global_attn_nobias_f32": ("tmr_tpu_torch/csrc/attn_f32.cu",
                                   "tmr_tpu/ops/pallas_attn.py:125"),
        "window_attn_f32_d80": ("tmr_tpu_torch/csrc/attn_f32.cu",
                                "tmr_tpu/ops/pallas_attn.py:350"),
        "xcorr": ("tmr_tpu_torch/csrc/xcorr.cu", "tmr_tpu/ops/pallas_xcorr.py:47"),
        "nms": ("tmr_tpu_torch/csrc/nms.cu", "tmr_tpu/ops/pallas_nms.py:32"),
        "xcorr_int8": ("tmr_tpu_torch/csrc/xcorr.cu", "tmr_tpu/ops/xcorr.py:171"),
        "int8_mm": ("tmr_tpu_torch/csrc/int8_mm.cu", "tmr_tpu/ops/pallas_int8.py:50"),
        "int8_conv": ("tmr_tpu_torch/csrc/int8_mm.cu", "tmr_tpu/ops/pallas_int8.py:50"),
        "add1": ("tmr_tpu_torch/csrc/probe.cu", "scripts/gate_probe.py:84"),
    }
    # phase 5j's launches (this process's and its feature worker's) counted in
    launches = {k: v + streamed["launches"].get(k, 0) for k, v in launches.items()}
    path_launches = dict(launches, xcorr_int8=qlaunches["xcorr_int8"],
                         int8_mm=qlaunches["int8_mm"], int8_conv=qlaunches["int8_conv"],
                         add1=probe_launches, global_attn_1536=launches_1536,
                         global_attn_d80=hlaunches["global_attn_d80"],
                         window_attn_d80=hlaunches["window_attn_d80"],
                         global_attn_f32=f32_launches["global_attn_f32"],
                         window_attn_f32=f32_launches["window_attn_f32"],
                         global_attn_f32_d80=h32_launches["global_attn_f32_d80"],
                         global_attn_nobias_f32=nobias_launches["global_attn_f32"],
                         window_attn_f32_d80=h32_launches["window_attn_f32_d80"])
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=path_launches[name], **entries[name])
               for name, (src, rep) in meta.items()]
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        fail(f"kernels of the line launched no time on their paths: {idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
